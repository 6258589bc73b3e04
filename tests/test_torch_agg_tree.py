"""The aggregator tree's pieces: the port against the JAX package, on
the CPU.

* ``plan_tree``, ``plan_fanin_groups`` and ``root_groups`` give the JAX
  package's groups (index, stage, members, level, parent) over fleets of
  one to three stages, fan-in 2 and 3, levels 1 to 3; a stage whose
  population is already one group is not wrapped again (``[4, 2]``'s
  stage 2 at levels 2).  ``AggGroup.as_dict`` round-trips.
* The same seeded Updates (parameters, batch statistics, an integer
  leaf), as each package's own UPDATE frames, through each package's
  ``L1Aggregator`` tree (two level-1 groups of 2, or of 3, members
  under one level-2 group: with three, any member order but the
  canonical one rounds the sums differently), driven inline: every published PartialAggregate (each level 1 partial
  and the level-2 root partial) is bit for bit the JAX package's (sums,
  weight, dtypes, statistic sums and weight, samples, members), raw and
  through the ``partial`` codec (``int8:64``, ``delta:int8:64``; codes,
  scales, the codec fields and the packed member list).
* The codec alone: a NaN tile ships a NaN scale and counts
  ``quant_nonfinite``; a delta partial without its base (or against
  another generation's) raises ``PartialCodecError``, and an interior
  aggregator drops it and counts ``partial_codec_errors``, in both
  packages.
* ``drain_group_queue`` returns the current generation's frames and
  drops and counts a stale one (``agg_stale_drops``).
* The root's fold of the tree's partials on ``HostFoldBackend`` and on
  ``CudaFoldBackend`` (its CPU path, finalize through the kernel
  wrapper's plain version) is bit for bit the flat per-client oracle
  taken in the tree's (stage, group, client) order, and the JAX
  package's root fold: for the chip phase's ``[4, 2]`` tree, for five
  root partials of one stage (fan-in 2, one level) and for three-member
  groups under a three-child level-2 group.
* The server's fallback: a dead aggregator's queue is drained
  direct-to-root, and a member whose frames it had consumed is
  abandoned after the grace period (``agg_fallback_abandons``), the group
  closing into the root fold over the members recovered.
"""

import time

import numpy as np
import pytest
import torch

from split_learning_tpu.runtime import aggregate as jA
from split_learning_tpu.runtime import protocol as jP
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.codec import partial as jpc
from split_learning_tpu.runtime.codec.specs import parse_spec as jspec
from split_learning_tpu.runtime.trace import FaultCounters as JFaults
from split_learning_torch import config as tcfg
from split_learning_torch.runtime import aggregate as tA
from split_learning_torch.runtime import protocol as tP
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.codec import partial as tpc
from split_learning_torch.runtime.codec.specs import parse_spec as tspec
from split_learning_torch.runtime.trace import FaultCounters as TFaults

JAX = {"A": jA, "P": jP, "Bus": JBus, "pc": jpc, "spec": jspec,
       "Faults": JFaults}
TORCH = {"A": tA, "P": tP, "Bus": TBus, "pc": tpc, "spec": tspec,
         "Faults": TFaults}

FLEETS = {"one_stage_5": (5,), "vgg_4x2": (4, 2), "deep_7x3": (7, 3),
          "three_stage_9x4x1": (9, 4, 1), "small_2x1": (2, 1)}


def _active(fleet):
    return [(f"client_{s}_{i}", s) for s, n in enumerate(fleet, 1)
            for i in range(n)]


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("fan_in", [2, 3])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_plans_match_the_jax_package(fleet, fan_in, levels):
    active = _active(FLEETS[fleet])
    j = jA.plan_tree(active, fan_in, levels)
    t = tA.plan_tree(active, fan_in, levels)
    assert [g.as_dict() for g in t] == [g.as_dict() for g in j]
    assert [g.idx for g in tA.root_groups(t)] == \
        [g.idx for g in jA.root_groups(j)]
    assert [g.as_dict() for g in tA.plan_fanin_groups(active, fan_in)] == \
        [g.as_dict() for g in jA.plan_fanin_groups(active, fan_in)]
    assert [g.key for g in t] == [jA.group_key(g.idx) for g in j]


def test_a_stage_of_one_group_is_not_wrapped():
    groups = tA.plan_tree(_active((4, 2)), 2, 2)
    by_idx = {g.idx: g for g in groups}
    assert [(g.idx, g.stage, g.level, g.parent) for g in groups] == [
        (0, 1, 1, 3), (1, 1, 1, 3), (2, 2, 1, None), (3, 1, 2, None)]
    assert by_idx[3].members == ["g00000", "g00001"]
    assert [g.idx for g in tA.root_groups(groups)] == [2, 3]


def test_agg_group_as_dict_round_trips():
    for g in tA.plan_tree(_active((7, 3)), 2, 3):
        d = g.as_dict()
        assert tA.AggGroup.from_dict(d) == g
        assert jA.AggGroup.from_dict(d).as_dict() == d


# -- the aggregators ---------------------------------------------------------

STAGE = 1
MEMBERS = [f"client_1_{i}" for i in range(6)]
GEN = 3


def _trees(seed=0):
    """Seeded per-client shards: two float leaves (one not a whole number
    of 64-value tiles), an integer leaf and batch statistics."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, cid in enumerate(MEMBERS):
        params = {"layer1": {
            "kernel": rng.standard_normal((24, 12)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(12)).astype(np.float32),
            "count": rng.integers(0, 50, (5,)).astype(np.int32)},
            "layer3": {"kernel": rng.standard_normal((7, 9)).astype(
                np.float32)}}
        stats = {"layer2": {
            "mean": rng.standard_normal(12).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 12).astype(np.float32)}}
        out[cid] = (params, stats, 4 + 3 * i)
    return out


def _base(trees):
    """A START shard: the first client's parameters nudged, so the delta
    codec's base sits near the group mean."""
    params = trees[MEMBERS[0]][0]
    return {layer: {k: (v - 0.01).astype(v.dtype) for k, v in leaves.items()}
            for layer, leaves in params.items()}


class _Recorder:
    """Each package's in-process bus, keeping every payload published."""

    def __init__(self, bus):
        self.bus, self.log = bus, []

    def publish(self, queue, payload):
        self.log.append((queue, payload))
        self.bus.publish(queue, payload)

    def get(self, queue, timeout=None):
        return self.bus.get(queue, timeout=timeout)


def _members(fan_in):
    """Two full level-1 groups under one level-2 group."""
    return MEMBERS[:2 * fan_in]


def _drive(pkg, trees, fan_in, codec=None, base=None, faults=None):
    """The tree over :func:`_members` (2 levels) driven inline, level by
    level; every PartialAggregate published, decoded, in order."""
    A, P = pkg["A"], pkg["P"]
    faults = faults or pkg["Faults"]()
    bus = _Recorder(pkg["Bus"]())
    members = _members(fan_in)
    groups = A.plan_tree([(c, STAGE) for c in members], fan_in, 2)
    spec = None if codec is None else pkg["spec"](codec)
    delta = spec is not None and spec.kind == "delta"
    for cid in members:
        params, stats, n = trees[cid]
        g = next(g for g in groups if g.level == 1 and cid in g.members)
        for part in P.encode_parts(P.Update(
                client_id=cid, stage=STAGE, cluster=0, params=params,
                batch_stats=stats, num_samples=n, round_idx=GEN), 4096):
            bus.publish(A.aggregate_queue(0, g.idx), part)
    for lv in sorted({g.level for g in groups}):
        for g in groups:
            if g.level != lv:
                continue
            w = A.L1Aggregator(
                bus, cluster=0, group=g, members=g.members, gen=GEN,
                deadline=time.monotonic() + 30, faults=faults,
                chunk_bytes=2048,
                out_queue=(P.RPC_QUEUE if g.parent is None
                           else A.aggregate_queue(0, g.parent)),
                codec=spec, base=base if delta else None,
                base_gen=GEN if delta else None)
            while not w.complete:
                raw = bus.get(w.queue, timeout=1.0)
                assert raw is not None, f"group {g.idx} starved"
                w.feed_raw(raw)
            w.publish()
    asm, out = P.FrameAssembler(), []
    for queue, raw in bus.log:
        msg = asm.feed(raw)
        if isinstance(msg, P.PartialAggregate):
            out.append((queue, msg))
    return out, faults


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaf_bytes(leaf):
    """A payload leaf as comparable bytes: a float32/int array, or a
    quantized leaf's codes, scales and tiling."""
    if hasattr(leaf, "q"):
        return (np.asarray(leaf.q).tobytes(), np.asarray(leaf.scale,
                                                          np.float32)
                .tobytes(), leaf.bits, leaf.tile, tuple(leaf.shape))
    a = np.asarray(leaf)
    return (str(a.dtype), a.shape, a.tobytes())


def _payload(msg):
    fields = {k: getattr(msg, k) for k in (
        "aggregator_id", "cluster", "group", "stage", "round_idx", "weight",
        "dtypes", "stat_weight", "stat_dtypes", "n_samples", "members",
        "level", "codec", "codec_base", "members_z")}
    for key in ("sums", "stat_sums"):
        fields[key] = [(p, _leaf_bytes(v))
                       for p, v in _walk(getattr(msg, key) or {})]
    return fields


@pytest.mark.parametrize("codec", [None, "int8:64", "delta:int8:64"])
@pytest.mark.parametrize("fan_in", [2, 3])
def test_aggregators_publish_the_jax_packages_partials(fan_in, codec):
    """At fan-in 3 a member order other than the canonical one would
    change the sums' float roundings (fan-in 2's a + b cannot)."""
    trees = _trees()
    base = _base(trees)
    members = _members(fan_in)
    jout, _ = _drive(JAX, trees, fan_in, codec, base)
    tout, _ = _drive(TORCH, trees, fan_in, codec, base)
    # g0, g1 into g2's queue, then g2 to the root
    assert [q for q, _ in tout] == [q for q, _ in jout] == [
        "aggregate_queue_0_2", "aggregate_queue_0_2", "rpc_queue"]
    for (_, j), (_, t) in zip(jout, tout):
        assert _payload(t) == _payload(j)
    root = tout[-1][1]
    assert root.level == 2 and root.n_samples == sum(
        trees[c][2] for c in members)
    if codec is None:
        assert root.codec is None and root.members_z is None
        assert [m["client_id"] for m in root.members] == members
        assert root.dtypes["layer1"]["count"] == "int32"
    else:
        assert root.codec == codec and root.members is None
        assert [m["client_id"] for m in tP.unpack_members(
            root.members_z)] == members
        assert root.codec_base == (GEN if codec.startswith("delta")
                                   else None)


def _entry(trees):
    sums = {p: sum(np.asarray(trees[c][0][p[0]][p[1]], np.float32)
                   * np.float32(trees[c][2]) for c in MEMBERS[:2])
            for p, _ in _walk(trees[MEMBERS[0]][0])}
    nested: dict = {}
    for (layer, k), v in sums.items():
        nested.setdefault(layer, {})[k] = v
    return {"sums": nested,
            "weight": float(sum(trees[c][2] for c in MEMBERS[:2])),
            "stat_sums": {"layer2": {"mean": np.full(12, 3.0, np.float32)}},
            "stat_weight": 2.0}


@pytest.mark.parametrize("codec", ["int8:64", "delta:int8:64", "int4:32"])
def test_partial_codec_round_trips_as_the_jax_packages(codec):
    trees = _trees(1)
    ent, base = _entry(trees), _base(trees)
    outs = []
    for pkg in (JAX, TORCH):
        enc, cs, cb = pkg["pc"].encode_partial_entry(
            ent, codec, base=base, base_gen=GEN)
        dec = pkg["pc"].decode_partial_entry(enc, cs, codec_base=cb,
                                             base=base, base_gen=GEN)
        outs.append((cs, cb, [(p, _leaf_bytes(v))
                              for p, v in _walk(enc["sums"])],
                     [(p, _leaf_bytes(v)) for p, v in _walk(dec["sums"])],
                     [(p, _leaf_bytes(v))
                      for p, v in _walk(dec["stat_sums"])]))
    assert outs[0] == outs[1]
    assert outs[1][0] == tpc.spec_string(tspec(codec))


def test_a_nan_tile_ships_a_nan_scale_and_is_counted():
    ent = {"sums": {"l": {"w": np.ones(130, np.float32)}}, "weight": 2.0}
    ent["sums"]["l"]["w"][70] = np.nan
    for pkg in (JAX, TORCH):
        faults = pkg["Faults"]()
        enc, _, _ = pkg["pc"].encode_partial_entry(ent, "int8:64",
                                                   faults=faults)
        scale = np.asarray(enc["sums"]["l"]["w"].scale)
        assert np.isnan(scale[1]) and np.isfinite(scale[[0, 2]]).all()
        assert faults.snapshot() == {"quant_nonfinite": 1}
        dec = pkg["pc"].decode_partial_entry(enc, "int8:64")
        w = dec["sums"]["l"]["w"]
        assert np.isnan(w[64:128]).all() and np.isfinite(w[:64]).all()


def test_a_delta_partial_without_its_base_is_refused_and_counted():
    trees = _trees(2)
    base = _base(trees)
    for pkg in (JAX, TORCH):
        pc = pkg["pc"]
        enc, cs, cb = pc.encode_partial_entry(_entry(trees),
                                              "delta:int8:64",
                                              base=base, base_gen=GEN)
        assert cb == GEN
        for held, gen in ((None, None), (base, GEN + 1)):
            with pytest.raises(pc.PartialCodecError):
                pc.decode_partial_entry(enc, cs, codec_base=cb, base=held,
                                        base_gen=gen)
        # an interior aggregator holding no base drops the child partial
        A, P = pkg["A"], pkg["P"]
        faults = pkg["Faults"]()
        parent = A.AggGroup(idx=2, stage=STAGE, members=["g00000"],
                            level=2)
        w = A.L1Aggregator(pkg["Bus"](), cluster=0, group=parent,
                           members=parent.members, gen=GEN,
                           deadline=time.monotonic() + 5, faults=faults)
        w.feed_raw(P.encode(P.PartialAggregate(
            aggregator_id="aggregator_0_0", cluster=0, group=0, stage=STAGE,
            round_idx=GEN, sums=enc["sums"], weight=enc["weight"],
            codec=cs, codec_base=cb)))
        assert faults.snapshot() == {"partial_codec_errors": 1}
        assert not w.complete


def test_drain_group_queue_drops_a_stale_generation():
    rng = np.random.default_rng(5)
    for pkg in (JAX, TORCH):
        A, P = pkg["A"], pkg["P"]
        bus, faults = pkg["Bus"](), pkg["Faults"]()
        q = A.aggregate_queue(0, 4)
        for cid, gen in (("a", GEN - 1), ("a", GEN), ("b", GEN)):
            bus.publish(q, P.encode(P.Update(
                client_id=cid, stage=1, cluster=0,
                params={"l": {"w": rng.standard_normal(3).astype(
                    np.float32)}}, num_samples=4, round_idx=gen)))
        got = A.drain_group_queue(bus, 0, 4, GEN, P.FrameAssembler(),
                                  faults)
        assert [(u.client_id, u.round_idx) for u in got] == [
            ("a", GEN), ("b", GEN)]
        assert faults.snapshot() == {"agg_stale_drops": 1}
        assert A.drain_group_queue(bus, 0, 4, GEN, P.FrameAssembler(),
                                   faults) == []


# -- the root ----------------------------------------------------------------

#: (fleet, fan-in, levels): the VGG phase's tree; five root partials at
#: one level; three-member groups under a three-child level-2 group
ROOT_TREES = {"vgg_4x2": ((4, 2), 2, 2), "flat_7x2": ((7, 2), 2, 1),
              "deep_7x3": ((7, 3), 3, 2)}


def _root_inputs(fleet, fan_in, levels, seed=7):
    """Each package's tree driven inline from the same Updates; the root
    partials each published."""
    rng = np.random.default_rng(seed)
    active = _active(fleet)
    trees = {cid: ({f"layer{s}": {
        "kernel": rng.standard_normal((10, 6)).astype(np.float32),
        "bias": rng.standard_normal(6).astype(np.float32)}},
        {f"layer{s}": {"mean": rng.standard_normal(6).astype(np.float32)}},
        int(rng.integers(3, 20))) for cid, s in active}
    out = {}
    for name, pkg in (("jax", JAX), ("torch", TORCH)):
        A, P = pkg["A"], pkg["P"]
        bus = pkg["Bus"]()
        groups = A.plan_tree(active, fan_in, levels)
        for cid, s in active:
            g = next(g for g in groups if g.level == 1 and cid in g.members)
            params, stats, n = trees[cid]
            bus.publish(A.aggregate_queue(0, g.idx), P.encode(P.Update(
                client_id=cid, stage=s, cluster=0, params=params,
                batch_stats=stats, num_samples=n, round_idx=GEN)))
        for lv in range(1, levels + 1):
            for g in groups:
                if g.level == lv:
                    w = A.L1Aggregator(
                        bus, cluster=0, group=g, members=g.members,
                        gen=GEN, deadline=time.monotonic() + 30,
                        faults=pkg["Faults"](),
                        out_queue=(P.RPC_QUEUE if g.parent is None else
                                   A.aggregate_queue(0, g.parent)))
                    while not w.complete:
                        w.feed_raw(bus.get(w.queue, timeout=1.0))
                    w.publish()
        partials = []
        while (raw := bus.get(P.RPC_QUEUE, timeout=0.0)) is not None:
            partials.append(P.decode(raw))
        out[name] = (groups, partials)
    return active, trees, out


def _oracle(active, trees, groups, stats=False):
    """The flat per-client fold in the tree's order: contributions
    ``nan_to_num(f32(leaf)) * w`` summed left to right within each
    level-1 group, group sums summed left to right up the tree and at the
    root (groups by key within each stage), one divide at the root."""
    by_key = {g.key: g for g in groups}
    which = 1 if stats else 0

    def group_sums(g):
        acc, total = {}, 0.0
        for m in g.members:
            if g.level == 1:
                w = trees[m][2]
                items = [(p, np.nan_to_num(np.asarray(v, np.float32)) * w)
                         for p, v in _walk(trees[m][which])]
                total += w
            else:
                sums, w = group_sums(by_key[m])
                items, total = list(sums.items()), total + w
            for p, c in items:
                acc[p] = acc[p] + c if p in acc else c
        return acc, total

    out = {}
    for s in sorted({g.stage for g in tA.root_groups(groups)}):
        acc, total = {}, 0.0
        for g in sorted((g for g in tA.root_groups(groups) if g.stage == s),
                        key=lambda g: g.key):
            sums, w = group_sums(g)
            for p, v in sums.items():
                acc[p] = acc[p] + v if p in acc else v
            total += w
        for p, a in acc.items():
            out[p] = (a / np.float32(total)).astype(np.float32)
    return out


def _root_fold(A, partials, groups, backend):
    expected: dict = {}
    for g in A.root_groups(groups):
        expected.setdefault(g.stage, []).append(g.key)
    fold = A.StreamingFold(expected, backend=backend)
    for m in reversed(partials):   # arrival order must not matter
        fold.add_partial(m.stage, A.group_key(m.group), m.sums, m.weight,
                         m.dtypes, stat_sums=m.stat_sums,
                         stat_weight=m.stat_weight,
                         stat_dtypes=m.stat_dtypes, n_samples=m.n_samples)
    return fold.finish()


def _np(tree):
    return {p: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in _walk(tree)}


@pytest.mark.parametrize("backend", ["host", "cuda_on_cpu"])
@pytest.mark.parametrize("tree", sorted(ROOT_TREES))
def test_root_fold_of_partials_is_the_flat_oracle(tree, backend):
    active, trees, out = _root_inputs(*ROOT_TREES[tree])
    groups, partials = out["torch"]
    n_roots = len(tA.root_groups(groups))
    assert len(partials) == n_roots == {"vgg_4x2": 2, "flat_7x2": 5,
                                        "deep_7x3": 2}[tree]
    be = (tA.HostFoldBackend() if backend == "host" else tA.CudaFoldBackend(
        device="cpu", kernels=tcfg.from_dict(
            {"kernels": {"stage-update": True}}).kernels))
    res = _root_fold(tA, partials, groups, be)
    jgroups, jpartials = out["jax"]
    jres = _root_fold(jA, jpartials, jgroups, jA.HostFoldBackend())
    assert res.partials == res.folded == n_roots
    assert res.n_samples == jres.n_samples == sum(
        trees[c][2] for c, s in active if s == 1)
    for got, want in ((res.params, _oracle(active, trees, groups)),
                      (res.stats, _oracle(active, trees, groups, True)),
                      (res.params, _np(jres.params)),
                      (res.stats, _np(jres.stats))):
        got = _np(got)
        assert got.keys() == want.keys()
        for p, a in want.items():
            assert got[p].dtype == a.dtype and np.array_equal(got[p], a), p


# -- the server's fallback ---------------------------------------------------

class _NullLog:
    def __getattr__(self, _name):
        return lambda *a, **k: None


class _DeadL1:
    group = tA.AggGroup(idx=0, stage=1, members=["a", "b"])
    cluster = 0
    members = ["a", "b"]
    agg_id = "aggregator_0_0"
    flushed = False

    def is_alive(self):
        return False


def test_fallback_abandons_members_whose_frames_the_aggregator_ate():
    """An aggregator that dies after consuming member b's UPDATE leaves
    nothing to recover for b, which never resends: the grace period
    abandons b (counted) and closes the group into the root fold over a
    alone, instead of stalling the UPDATE barrier a client timeout."""
    from split_learning_torch.runtime.server import ProtocolContext

    rng = np.random.default_rng(17)
    s = type("_Stub", (), {})()
    s.bus, s.faults, s.log = TBus(), TFaults(), _NullLog()
    s._l1, s._l1_fallback = [_DeadL1()], {}
    s._tree_groups = {0: _DeadL1.group}
    s._tree_narrowed = {0: ["a", "b"]}
    s._agg_gone, s._updates = set(), []
    s._cur_gen = 2
    s._partial_bases, s._partial_base_gen = {}, None
    s._fold = tA.StreamingFold({1: [tA.group_key(0)]}, faults=s.faults)
    s._fold_update = lambda u: None
    s.L1_FALLBACK_GRACE_S = 0.05
    for name in ("_poll_l1", "_start_fallback", "_step_fallback",
                 "_children_draining", "_member_clients", "_drain_fallback",
                 "_drain_fallback_update", "_drain_fallback_partial",
                 "_flush_fallback", "_decode_partial", "_book_members"):
        setattr(s, name, getattr(ProtocolContext, name).__get__(s))

    u_a = tP.Update(client_id="a", stage=1, cluster=0,
                    params={"l": {"w": rng.standard_normal(5).astype(
                        np.float32)}}, num_samples=4, round_idx=2)
    s.bus.publish(tA.aggregate_queue(0, 0), tP.encode(u_a))
    s._poll_l1()
    assert {u.client_id for u in s._updates} == {"a"}
    assert s._agg_gone == set() and not s._l1_fallback[0]["flushed"]
    assert s.faults.snapshot() == {"agg_l1_fallbacks": 1}
    time.sleep(0.06)   # the grace, restarted by a's frame, runs out
    s._poll_l1()
    assert s._agg_gone == {"b"}
    assert s.faults.snapshot() == {"agg_l1_fallbacks": 1,
                                   "agg_fallback_abandons": 1}
    assert s._l1_fallback[0]["flushed"]
    assert s._fold.has_key(1, tA.group_key(0))
    res = s._fold.finish()
    assert np.array_equal(res.params["l"]["w"], u_a.params["l"]["w"])


def test_remote_aggregator_nodes_are_refused_naming_their_slice(tmp_path):
    """The thread-mode tree runs; its remote form (aggregator processes
    adopted over the broker, their liveness from heartbeats) is refused
    with the slice it waits for."""
    from split_learning_torch.runtime.server import ProtocolServer

    cfg = tcfg.from_dict({
        "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [4, 2],
        "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
        "aggregation": {"strategy": "fedavg", "fan-in": 2, "levels": 2,
                        "remote": True},
        "checkpoint": {"save": False}, "log-path": str(tmp_path)})
    with pytest.raises(NotImplementedError,
                       match="aggregation.remote.*telemetry plane"):
        ProtocolServer(cfg, TBus(), device="cpu")
