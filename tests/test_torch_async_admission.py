"""The server's UPDATE admission and the streaming fold's staleness
scale: the port against the JAX package, on the CPU.

The same UPDATE sequences go through both packages' ``ProtocolContext.
_admit_update`` (a tiny KWT config, ``max-staleness: 2``,
``staleness-decay: 0.5``) at generation 5: a fresh contribution, lags 1
and 2 (admitted at weights ``0.5`` and ``0.25`` under ``client@vN``),
lag 3 (rejected), a redelivered duplicate, a version-less UPDATE (its
``round_idx`` stands in), and the same sequence in sync mode, where the
generation fence rejects every lag.  Held equal: the fault counters,
the admitted client ids in order, and the folded result bit for bit.

``StreamingFold.add_update(u, scale=, key=)`` on its own: stale extras
folded at finish in sorted key order whatever their arrival order, with
float32 leaves, bit for bit against the JAX package's fold, on the host
backend and on the port's CUDA fold backend run on the CPU; at scale
1.0 the integer weight is kept.
"""

import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import aggregate as jagg
from split_learning_tpu.runtime import protocol as jproto
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.server import ProtocolContext as JCtx
from split_learning_tpu.runtime.trace import FaultCounters as JFaults
from split_learning_torch import config as tcfg
from split_learning_torch.runtime import aggregate as tagg
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.server import ProtocolContext as TCtx
from split_learning_torch.runtime.trace import FaultCounters as TFaults

CFG = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
       "synthetic-size": 16, "compute-dtype": "float32",
       "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
       "topology": {"cut-layers": [2]},
       "aggregation": {"strategy": "fedavg"},
       "learning": {"mode": "async", "max-staleness": 2,
                    "staleness-decay": 0.5},
       "checkpoint": {"save": False}}
COUNTERS = ("agg_stale_admits", "agg_stale_updates", "agg_dup_drops")


def _leaf(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(37).astype(
        np.float32)


def _upd(proto, cid, ver, samples=8, seed=0, round_idx=None,
         versionless=False):
    return proto.Update(
        client_id=cid, stage=1, cluster=0,
        params={"layer1": {"w": _leaf(seed)}}, num_samples=samples,
        ok=True, round_idx=ver if round_idx is None else round_idx,
        version=None if versionless else ver)


#: (client, version, samples, seed, version-less) in arrival order
SEQUENCE = (("c0", 5, 8, 1, False),     # fresh
            ("c1", 4, 12, 2, False),    # lag 1: weight x0.5
            ("c2", 3, 8, 3, False),     # lag 2: weight x0.25
            ("c3", 2, 8, 4, False),     # lag 3: rejected
            ("c1", 4, 12, 2, False),    # redelivered: dup drop
            ("c4", 4, 4, 5, True),      # version-less, round_idx 4
            ("c5", 5, 16, 6, False))    # fresh


def _contexts(tmp_path, mode: str):
    d = dict(CFG, learning=dict(CFG["learning"], mode=mode))
    jc = JCtx(jcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "j")})),
              JBus())
    tc = TCtx(tcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "t")})),
              TBus(), device="cpu")
    jc.faults, tc.faults = JFaults(), TFaults()
    for ctx, agg in ((jc, jagg), (tc, tagg)):
        ctx._cur_gen = 5
        ctx._fold = agg.StreamingFold({1: ["c0", "c5"]}, faults=ctx.faults)
    return jc, tc


@pytest.mark.parametrize("mode", ("async", "sync"))
def test_admission_matches_the_jax_package(tmp_path, mode):
    jc, tc = _contexts(tmp_path, mode)
    for cid, ver, n, seed, vless in SEQUENCE:
        jc._admit_update(_upd(jproto, cid, ver, n, seed, versionless=vless))
        tc._admit_update(_upd(tproto, cid, ver, n, seed, versionless=vless))
    js, ts = jc.faults.snapshot(), tc.faults.snapshot()
    assert {k: js.get(k, 0) for k in COUNTERS} == \
        {k: ts.get(k, 0) for k in COUNTERS}
    want = ({"agg_stale_admits": 3, "agg_stale_updates": 1,
             "agg_dup_drops": 1} if mode == "async" else
            {"agg_stale_admits": 0, "agg_stale_updates": 5,
             "agg_dup_drops": 0})
    assert {k: ts.get(k, 0) for k in COUNTERS} == want
    ids = [u.client_id for u in tc._updates]
    assert ids == [u.client_id for u in jc._updates]
    assert all(u.params is None for u in tc._updates)
    jr, tr = jc._fold.finish(), tc._fold.finish()
    assert jr.n_samples == tr.n_samples
    assert jc._fold._stages[1].total_w == tc._fold._stages[1].total_w
    a = np.asarray(jr.params["layer1"]["w"])
    b = np.asarray(tr.params["layer1"]["w"])
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    if mode == "async":
        # fresh 8 + 16, lag 1: 12 x 0.5 and 4 x 0.5, lag 2: 8 x 0.25
        assert tc._fold._stages[1].total_w == 8 + 16 + 6 + 2 + 2


@pytest.mark.parametrize("backend", ("host", "cuda_on_cpu"))
def test_scaled_fold_matches_bit_for_bit(backend):
    results = {}
    for order in (("a", "b"), ("b", "a")):   # arrival order races
        for name, proto, agg, faults in (("jax", jproto, jagg, JFaults()),
                                         ("port", tproto, tagg, TFaults())):
            be = None
            if name == "port" and backend == "cuda_on_cpu":
                be = tagg.CudaFoldBackend(device="cpu")
            fold = agg.StreamingFold({1: ["c1", "c2"]}, faults=faults,
                                     **({"backend": be} if be else {}))
            fold.add_update(_upd(proto, "c2", 5, samples=7, seed=11))
            stale = {"a": (_upd(proto, "c1", 4, samples=9, seed=12), .5,
                           "c1@v4"),
                     "b": (_upd(proto, "c1", 3, samples=5, seed=13), .25,
                           "c1@v3")}
            for k in order:
                u, scale, key = stale[k]
                fold.add_update(u, scale=scale, key=key)
            fold.add_update(_upd(proto, "c1", 5, samples=3, seed=14))
            res = fold.finish()
            w = res.params["layer1"]["w"]
            results[(name, order)] = (
                np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w),
                fold._stages[1].total_w, res.n_samples)
    ref = results[("jax", ("a", "b"))]
    assert ref[1] == 7 + 3 + 4.5 + 1.25
    for key, (w, tw, n) in results.items():
        assert w.dtype == np.float32 and w.tobytes() == ref[0].tobytes(), \
            key
        assert (tw, n) == ref[1:], key


def test_unit_scale_keeps_the_integer_weight():
    """scale 1.0 folds exactly as an unscaled Update (the sync fold's
    bit identity), in both packages."""
    out = []
    for agg, proto, faults in ((jagg, jproto, JFaults()),
                               (tagg, tproto, TFaults())):
        for scale in (None, 1.0):
            fold = agg.StreamingFold({1: ["c1"]}, faults=faults)
            u = _upd(proto, "c1", 5, samples=7, seed=3)
            if scale is None:
                fold.add_update(u)
            else:
                fold.add_update(u, scale=scale)
            res = fold.finish()
            assert fold._stages[1].total_w == 7
            out.append(np.asarray(res.params["layer1"]["w"]).tobytes())
    assert len(set(out)) == 1


def test_late_ready_syn_carries_the_responsive_overrides(tmp_path):
    """A late READY (async, after the SYN fan-out) gets its SYN from the
    pump with the fan-out's fence overrides, in both packages."""
    syns = []
    for ctx, proto in zip(_contexts(tmp_path, "async"), (jproto, tproto)):
        ctx._syn_live = True
        ctx._syn_round = 3
        ctx._cur_gen = 3
        ctx._syn_overrides = {"c9": (2, ["f1"])}
        ctx.bus.publish(proto.RPC_QUEUE, proto.encode(proto.Ready(
            client_id="c9", round_idx=3)))
        assert ctx._pump_one(0.5)
        syn = proto.decode(ctx.bus.get(proto.reply_queue("c9"),
                                       timeout=0.5))
        syns.append((type(syn).__name__, syn.round_idx,
                     syn.sda_fence_quorum, syn.sda_feeders))
        assert "c9" in ctx._ready
    assert syns[0] == syns[1] == ("Syn", 3, 2, ["f1"])
