"""BASELINE config 2 (``configs/baseline2.yaml``: VGG16/CIFAR10,
``clients: [4, 2]``, auto topology with KMeans into 2 clusters and GMM
selection, Dirichlet α = 0.3) in the port against the JAX package, on
the CPU, at reduced samples.

Reductions, each case: 16 samples a client (2500 in the YAML), batch 4
and control-count 2 (32 and 4), one round (5), 64 synthetic images, two
validation batches of 8; the protocol case 8 samples a client,
control-count 1, and float32 compute and wire (bf16 frames round the
activations the two packages compute in different orders, and the
difference grows through batch-4 BatchNorm: the lockstep cluster's
update error is 0.50 in bf16, 0.0019 in float32).  Everything else is
the YAML's: bf16 compute in process, SGD lr 5e-4 momentum 0.9, FedAvg.  Dropout is swapped for the identity in both
packages' VGG16 (the RNG streams cannot match).

* In process: the plan (clusters by KMeans on the reduced Dirichlet
  counts, the even cut 26, no rejection with equal speeds) equal, the
  sample count equal, and the FedAvg'd parameters and statistics within
  ``tests/test_torch_vgg_round.py``'s bfloat16 tolerances (the two
  clusters' trees merged by the unweighted cross-cluster average):
  validation loss within 1e-2 (measured 7.8e-3, one bf16 ulp of the
  loss), parameters within 2e-3 (measured 2.2e-4), update error within
  0.6 (measured 0.36), statistics within 2e-2 (measured 2.3e-3).  ``python -m
  split_learning_torch.run --config <the reduced YAML> --device cpu``
  prints the same samples.
* As the protocol round: every client registers a profile, one stage-1
  client at a tenth of the others' speed, so selection rejects it and it
  trains nothing; two clusters, each on its own
  ``intermediate_queue_{stage}_{cluster}``.  The plans equal the JAX
  package's ``ProtocolServer``'s and the port's in-process plan for the
  same registrations, and the sample count is equal.  Each cluster's
  FedAvg (``aggregate_cluster``, recorded in both packages) is held:
  cluster 1 has one feeder, so it runs in lockstep — parameters within
  2e-5 (measured 6.5e-6), update error within 1e-2 (measured 1.9e-3),
  statistics within 1e-5 (measured 1.3e-6); cluster 0's shared stage-2
  client takes its two feeders' batches in arrival order, so its SGD
  steps come in thread order in both packages and only its sample
  count and an update error below 0.8 (measured 0.02–0.48 over runs)
  are held.
* Relay, periodic (``t-client: 1, t-global: 2``), SDA (sda-size 2,
  and strict) and FedAsync with 2LS pairing (``in-clusters: 2`` with a
  head per in-cluster) over the protocol send their piece of
  choreography with the first START fan-out; FedAvg, cluster relay, SDA
  at one batch and periodic aggregating every round send the weights
  on the shared data plane.
"""

import threading

import jax
import numpy as np
import pytest
import yaml

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats, tree_to,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.run import main as run_main
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime.bus import InProcTransport
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan
from split_learning_torch.runtime.protocol import FrameAssembler, Start
from split_learning_torch.runtime.server import ProtocolContext, run_inproc
from split_learning_torch.runtime.strategies import make_strategy

NAME = "VGG16_CIFAR10"
DROPOUTS = ("layer46", "layer49")
YAML = "configs/baseline2.yaml"


def _no_dropout(spec_fn, split_mod):
    def specs(**kw):
        return tuple(split_mod.LayerSpec(s.name, fn=split_mod.identity_fn)
                     if s.name in DROPOUTS else s for s in spec_fn(**kw))
    return specs


@pytest.fixture(scope="module", autouse=True)
def no_dropout_registries():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsplit, tsplit):
            mp.setitem(mod._REGISTRY, NAME,
                       _no_dropout(mod._REGISTRY[NAME], mod))
        yield


def _reduced(tmp_path, samples=16, control=2, **over):
    """The YAML as written with the reductions above."""
    with open(YAML) as f:
        d = yaml.safe_load(f)
    d["distribution"] = dict(d["distribution"], **{"num-samples": samples})
    d["learning"] = dict(d["learning"], **{"batch-size": 4,
                                           "control-count": control})
    d.update({"global-rounds": 1, "synthetic-size": 64,
              "val-max-batches": 2, "val-batch-size": 8,
              "log-path": str(tmp_path / "logs"),
              "checkpoint": {"save": False}}, **over)
    return d


@pytest.fixture(scope="module")
def init_vars():
    """flax's initial parameters and statistics moved off their init."""
    model = jsplit.SplitModel(specs=jsplit.model_registry()[NAME]())
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(11)
    stats = {layer: {
        "mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(
            np.float32),
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for layer, s in jax.tree_util.tree_map(
            np.asarray, v["batch_stats"]).items()}
    return params, stats


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _max_diff(jt, tt):
    fj, ft = _leaves(jt), _leaves(tt)
    assert set(fj) == set(ft)
    return max(float(np.abs(ft[k] - a).max()) for k, a in fj.items())


def _update_error(jt, tt, t0):
    fj, ft, f0 = _leaves(jt), _leaves(tt), _leaves(t0)
    num = den = 0.0
    for k, a in fj.items():
        dj = a.astype(np.float64) - f0[k]
        dt = ft[k].astype(np.float64) - f0[k]
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / den) ** 0.5


def _assert_plans_equal(tp, jp):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert (a.cluster_id, a.cuts, a.clients, a.rejected) == \
            (b.cluster_id, b.cuts, b.clients, b.rejected)
        np.testing.assert_array_equal(a.label_counts, b.label_counts)


def test_baseline2_in_process_matches_jax_package(tmp_path, init_vars,
                                                  capsys):
    p0, s0 = init_vars
    d = _reduced(tmp_path)
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    jplans, tplans = jplan(jc, jregs(jc)), tplan(tc, tregs(tc))
    _assert_plans_equal(tplans, jplans)
    assert len(tplans) == 2 and [p.cuts for p in tplans] == [[26], [26]]
    assert sorted(c for p in tplans for c in p.stage1_clients) == [
        f"client_1_{i}" for i in range(4)]
    assert not any(p.rejected for p in tplans)

    jres = jrun(jc, MeshContext(jc), jplans,
                JLogger(tmp_path / "jax", console=False),
                init_params=p0, init_stats=s0)
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplans, TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0),
                init_stats=from_jax_stats(s0))
    (a,), (b,) = jres.history, tres.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 4 * 16
    assert abs(a.val_loss - b.val_loss) < 1e-2, (a, b)
    trained = to_jax_params(tres.params, tctx.full_model)
    assert _max_diff(jres.params, trained) <= 2e-3
    assert _update_error(jres.params, trained, p0) <= 0.6
    assert _max_diff(jres.stats, to_jax_stats(tres.stats)) <= 2e-2

    # the CLI on a YAML with the same reductions
    path = tmp_path / "baseline2_reduced.yaml"
    path.write_text(yaml.safe_dump(d))
    run_main(["--config", str(path), "--device", "cpu"])
    assert "round 0: ok=True samples=64" in capsys.readouterr().out


#: every client's registered profile: one stage-1 client is a straggler
def _profiles(slow="client_1_1"):
    return {f"client_{s}_{i}": {"speed": 100.0 / (10 if
                                                  f"client_{s}_{i}" == slow
                                                  else 1) + i}
            for s, n in ((1, 4), (2, 2)) for i in range(n)}


def _serve_jax(cfg, p0, s0, profiles):
    bus = jbus.InProcTransport()
    server = JServer(cfg, transport=bus, client_timeout=300)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": s0}
    clients = [JClient(cfg, f"client_{s}_{i}", s, transport=bus,
                       profile=profiles[f"client_{s}_{i}"])
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server.serve()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "client thread failed to stop"
    return server, result


def test_baseline2_protocol_round_matches_jax_package(tmp_path, init_vars,
                                                      monkeypatch):
    from split_learning_tpu.runtime import server as jserver_mod
    from split_learning_tpu.runtime import strategies as jstrat
    from split_learning_torch.runtime import server as tserver_mod
    from split_learning_torch.runtime import strategies as tstrat
    p0, s0 = init_vars
    d = _reduced(tmp_path, samples=8, control=1, **{
        "compute-dtype": "float32", "transport": {"wire-dtype": "float32"}})
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    profiles = _profiles()
    seen, folds = {}, {"jax": [], "torch": []}
    for name, mod, plan, strat in (
            ("jax", jserver_mod, jplan, jstrat),
            ("torch", tserver_mod, tplan, tstrat)):
        def spy(cfg, regs, *a, _plan=plan, _name=name, **kw):
            seen[_name] = _plan(cfg, regs, *a, **kw)
            return seen[_name]
        monkeypatch.setattr(mod, "plan_clusters", spy)

        def fold(ups, _agg=strat.aggregate_cluster, _name=name):
            folds[_name].append(_agg(ups))
            return folds[_name][-1]
        monkeypatch.setattr(strat, "aggregate_cluster", fold)
    queues = set()
    orig_publish = InProcTransport.publish

    def publish(bus, queue, payload):
        if queue.startswith("intermediate_queue"):
            queues.add(queue)
        return orig_publish(bus, queue, payload)
    monkeypatch.setattr(InProcTransport, "publish", publish)

    _, jres = _serve_jax(jc, p0, s0, profiles)
    run = run_inproc(tc, device="cpu", client_timeout=300,
                     init_params=from_jax_params(p0),
                     init_stats=from_jax_stats(s0), profiles=profiles)
    tres = run.result

    _assert_plans_equal(seen["torch"], seen["jax"])
    regs = tregs(tc, profiles)
    _assert_plans_equal(seen["torch"], tplan(tc, regs))
    assert [p.rejected for p in seen["torch"]] == [["client_1_1"], []]
    assert queues == {"intermediate_queue_1_0", "intermediate_queue_1_1"}
    straggler = next(c for c in run.clients if c.client_id == "client_1_1")
    assert straggler.runner is None   # never STARTed: trained nothing
    (a,), (b,) = jres.history, tres.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 3 * 8
    model = run.server.ctx.full_model
    bounds = [(0.8, None, None), (1e-2, 2e-5, 1e-5)]   # cluster 0, 1
    for (jp, js, jn), (tp, ts, tn), (upd, ptol, stol) in zip(
            folds["jax"], folds["torch"], bounds):
        assert jn == tn
        tp = to_jax_params(tree_to(tp, "cpu"), model)
        assert _update_error(jp, tp, {k: p0[k] for k in jp}) <= upd
        if ptol is not None:
            assert _max_diff(jp, tp) <= ptol
            assert _max_diff(js, to_jax_stats(tree_to(ts, "cpu"))) <= stol
    assert [n for *_, n in folds["torch"]] == [16, 8]


def _protocol_ctx(tmp_path, **over):
    cfg = tcfg.from_dict(_reduced(tmp_path, **over))
    ctx = ProtocolContext(cfg, InProcTransport(), device="cpu")
    plans = tplan(cfg, tregs(cfg))
    v = ctx.init_variables()
    return cfg, ctx, plans, v["params"], v["batch_stats"]


class _Refused(Exception):
    pass


def _starts(ctx, strategy, plans, params, stats) -> dict:
    """The START fan-out of the strategy's first ``train_cluster`` call,
    stopped at the READY barrier that follows it: {client id: Start}."""
    def barrier(*args, **kw):
        raise _Refused
    ctx._pump_until = barrier
    with pytest.raises(_Refused):
        strategy.run_round(ctx, plans, 0, params, stats)
    starts = {}
    for q in ctx.bus.bytes_out_snapshot():
        asm = FrameAssembler()
        while (raw := ctx.bus.get(q, timeout=0.01)) is not None:
            msg = asm.feed(raw)
            if msg is not None:
                assert isinstance(msg, Start) and q.startswith("reply_")
                starts[q[len("reply_"):]] = msg
    return starts


def _hold_round(strategy):
    strategy._reseed_stages = set()   # after a round that re-seeded


def _relay_subset(starts, plan, cfg):
    assert set(starts) == {plan.stage1_clients[0], *plan.clients[1]}


def _weightless(starts, plan, cfg):
    assert starts and all(m.params is None for m in starts.values())


def _window(starts, plan, cfg):
    sda = min(2, len(plan.stage1_clients))
    for cid, m in starts.items():
        assert m.extra["sda_size"] == sda
        assert m.extra["sda_peers"] == (
            plan.clients[1] if sda > 1 and cid in plan.stage1_clients
            else None)


def _strict(starts, plan, cfg):
    for cid, m in starts.items():
        assert m.extra["sda_strict"] is True and m.extra["sda_size"] == 1
        assert m.extra["sda_feeders"] == (
            None if cid in plan.stage1_clients else plan.stage1_clients)


def _paired(starts, plan, cfg):
    assert {m.extra["pair"] for m in starts.values()} == {0, 1}
    for g, head in enumerate(plan.clients[1]):
        assert starts[head].extra["sda_feeders"] == [
            c for c in plan.stage1_clients if starts[c].extra["pair"] == g]


@pytest.mark.parametrize("agg,topology,clients,prep,want", [
    ({"strategy": "relay"}, None, None, None, _relay_subset),
    ({"strategy": "periodic", "t-client": 1, "t-global": 2}, None, None,
     _hold_round, _weightless),
    ({"strategy": "sda", "sda-size": 2}, None, None, None, _window),
    ({"strategy": "sda", "sda-size": 1, "sda-strict": True}, None, None,
     None, _strict),
    ({"strategy": "fedasync"}, {"in-clusters": 2}, [4, 4], None, _paired),
], ids=["relay", "periodic", "sda", "sda_strict", "fedasync_pairing"])
def test_unported_choreography_raises(tmp_path, agg, topology, clients,
                                      prep, want):
    """The choreography these strategies ask for, once refused over the
    protocol, now reaches the wire: the first START fan-out carries it
    (relay: one stage-1 client and the heads; periodic's hold round: no
    weights; SDA: the window and DCSL's scatter peers; strict SDA: the
    flag and the heads' feeder sets; 2LS: each pair's index)."""
    over = {"aggregation": agg}
    if topology:
        over["topology"] = {"mode": "auto", "num-clusters": 2,
                            "selection": True, **topology}
    if clients:
        over["clients"] = clients
    cfg, ctx, plans, params, stats = _protocol_ctx(tmp_path, **over)
    strategy = make_strategy(cfg)
    if prep is not None:
        prep(strategy)
    want(_starts(ctx, strategy, plans, params, stats), plans[0], cfg)


@pytest.mark.parametrize("agg", [
    {"strategy": "fedavg"}, {"strategy": "cluster_relay"},
    {"strategy": "sda", "sda-size": 1},
    {"strategy": "periodic", "t-client": 1, "t-global": 1}],
    ids=["fedavg", "cluster_relay", "sda_one_batch", "periodic_every_round"])
def test_strategies_needing_no_unported_piece_pass(tmp_path, agg):
    """FedAvg, cluster relay, SDA at sda-size 1 and periodic aggregating
    every round START every client of the first cluster with its weights
    on the shared data plane (a window of one, no pairing, no scatter)."""
    cfg, ctx, plans, params, stats = _protocol_ctx(tmp_path, aggregation=agg)
    starts = _starts(ctx, make_strategy(cfg), plans, params, stats)
    assert set(starts) == {c for ids in plans[0].clients for c in ids}
    for m in starts.values():
        assert m.params is not None and m.extra["sda_size"] == 1
        assert m.extra["pair"] is None and m.extra["sda_peers"] is None
