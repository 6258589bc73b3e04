"""The aggregator tree as the protocol round: the port against the JAX
package, on the CPU.

``clients: [4, 2]`` with ``aggregation.fan-in: 2`` and ``levels: 2``:
``plan_tree`` gives level-1 groups g0 {client_1_0, client_1_1} and g1
{client_1_2, client_1_3} at stage 1 and g2 {client_2_0, client_2_1} at
stage 2, and the level-2 group g3 {g0, g1}; the root folds two partials
(g2's and g3's), g3 its two children's.  Every participant is a thread
of this process over an ``InProcTransport`` (the aggregators too), from
the JAX package's initial weights (``convert.from_jax_params``).

The model is a tiny float32 KWT (``tests/test_torch_choreography_parity
.py``'s: embed 16, 2 heads, MLP 32, dropout off, cut 2, batch 4, SGD at
lr 0.05 with momentum 0.9, ``control-count: 1``, the float32 wire).  So
that both heads step in the same order in both packages, the round is
strict SDA with a window of 4: each feeder's batch ``j`` goes to head
``j mod 2`` (DCSL's scatter; every feeder's rotation starts at head 0),
and a head steps once it holds one batch of each of the four feeders,
in sorted origin order.

Held:

* the fault-free round against the JAX package's: samples equal,
  validation loss and every final parameter within 1e-4 (the float32
  protocol rounds' bound, ``tests/test_torch_protocol.py``; measured
  2.4e-7 and 1.8e-7); and the ``kind=agg`` record's tree fields equal
  (fan-in, levels, 2 partials, 2 folded keys, the round's 32 stage-1
  samples);
* ``aggregator_0_0`` killed through ``L1Aggregator.TEST_KILL`` with the
  ``delta:int8:64`` partial codec: both packages finish the round through
  the direct-to-root fallback (``agg_l1_fallbacks`` counted once each),
  the root still folds 2 partials, and the two packages' validation
  loss and parameters are within 1e-3 (the VGG round's int8 protocol
  bound, ``tests/test_torch_vgg_round.py``; measured 1.3e-4 and 1.5e-4)
  with 99.9 % of the parameters within 1e-4 (measured 99.96 %): the codec
  rounds each group mean to a 1/127 step of its tile's largest training
  delta, and the packages' float32 noise can flip a code;
* in the port alone: the killed round with raw partials is bit for bit
  the fault-free one (the fallback folds the group in the same summation
  shape); and at ``levels: 1`` with the ``int8:64`` partial codec (three
  level-1 groups, all partials at the root) the round over TCP (a broker,
  one transport stack for each participant and for each aggregator
  thread) is bit for bit the same round in one process.
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import aggregate as jagg
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_tpu.runtime.trace import (
    default_fault_counters as jfaults,
)
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.runtime import aggregate as tagg
from split_learning_torch.runtime.bus import Broker
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.client import ProtocolClient as TClient
from split_learning_torch.runtime.server import ProtocolServer as TServer
from split_learning_torch.runtime.trace import (
    default_fault_counters as tfaults,
)

TREE = {
    "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [4, 2],
    "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
    "val-batch-size": 16, "compute-dtype": "float32",
    "model-kwargs": {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32,
                     "dropout_rate": 0.0},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 8},
    "transport": {"wire-dtype": "float32"},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "sgd",
                 "learning-rate": 0.05, "momentum": 0.9},
    "aggregation": {"strategy": "sda", "sda-size": 4, "sda-strict": True,
                    "local-rounds": 1, "fan-in": 2, "levels": 2},
    "checkpoint": {"save": False},
}
CODEC = {"transport": {"wire-dtype": "float32",
                       "codec": {"partial": "delta:int8:64"}}}
LEVEL1_INT8 = {"transport": {"wire-dtype": "float32",
                             "codec": {"partial": "int8:64"}},
               "aggregation": dict(TREE["aggregation"], levels=1)}
KILLED = "aggregator_0_0"
#: the kind=agg fields both packages write for a tree round
TREE_FIELDS = ("fan_in", "levels", "partials", "folded", "n_samples",
               "partial_codec")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(cfg):
    return [(f"client_{s}_{i}", s) for s, n in enumerate(cfg.clients, 1)
            for i in range(n)]


def _serve(server, clients, **kw):
    errors = []

    def run(c):
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    try:
        return server.serve(**kw)
    finally:
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread failed to stop"
        assert not errors, errors


def _dict(tmp, over=None, port=None):
    d = dict(TREE, **(over or {}), **{"log-path": str(tmp)})
    if port is not None:
        d["transport"] = dict(d["transport"], kind="tcp", port=port)
    return d


def _killing(agg_mod, fn):
    """``fn()`` with aggregator g0 dying at its start; the fault counter
    deltas it left."""
    agg_mod.L1Aggregator.TEST_KILL.add(KILLED)
    try:
        return fn()
    finally:
        agg_mod.L1Aggregator.TEST_KILL.discard(KILLED)


def _delta(counters, fn):
    before = counters.snapshot()
    out = fn()
    after = counters.snapshot()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v - before.get(k, 0)}


def run_jax(tmp, p0, over=None):
    jc = jcfg.from_dict(_dict(tmp, over))
    bus = JBus()
    server = JServer(jc, transport=bus, client_timeout=300)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": {}}
    return _serve(server, [JClient(jc, cid, s, transport=bus)
                           for cid, s in _ids(jc)])


def run_torch(tmp, p0, over=None):
    tc = tcfg.from_dict(_dict(tmp, over))
    bus = TBus()
    server = TServer(tc, bus, client_timeout=300, device="cpu")
    res = _serve(server, [TClient(tc, cid, s, bus, device="cpu")
                          for cid, s in _ids(tc)],
                 init_params=from_jax_params(p0))
    return server, res


def run_torch_tcp(tmp, p0, over=None):
    broker = Broker("127.0.0.1", 0)
    try:
        tc = tcfg.from_dict(_dict(tmp, over, port=broker.port))
        server = TServer(tc, client_timeout=300, device="cpu")
        res = _serve(server, [TClient(tc, cid, s, device="cpu")
                              for cid, s in _ids(tc)],
                     init_params=from_jax_params(p0))
        return server, res, broker.stats()
    finally:
        broker.close()


def _agg_records(tmp):
    seen, out = set(), []
    for path in sorted(tmp.rglob("metrics.jsonl")):
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            key = (rec.get("run_id"), rec.get("ts"))
            if rec.get("kind") == "agg" and key not in seen:
                seen.add(key)
                out.append(rec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tree")
    jc = jcfg.from_dict(_dict(tmp / "init"))
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    out = {"tmp": tmp, "p0": p0}
    out["jax"] = run_jax(tmp / "jax", p0)
    out["torch"] = run_torch(tmp / "torch", p0)
    out["jax_killed"] = _delta(jfaults, lambda: _killing(
        jagg, lambda: run_jax(tmp / "jax_killed", p0, CODEC)))
    out["torch_killed"] = _delta(tfaults, lambda: _killing(
        tagg, lambda: run_torch(tmp / "torch_killed", p0, CODEC)))
    out["torch_killed_raw"] = _delta(tfaults, lambda: _killing(
        tagg, lambda: run_torch(tmp / "torch_killed_raw", p0)))
    out["torch_level1"] = run_torch(tmp / "torch_level1", p0, LEVEL1_INT8)
    out["torch_tcp"] = run_torch_tcp(tmp / "torch_tcp", p0, LEVEL1_INT8)
    return out


def _flat_jax(params):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params)))


def _assert_close(jres, server, tres, loss_tol, tol, bulk):
    assert len(jres.history) == len(tres.history) == 1
    a, b = jres.history[0], tres.history[0]
    assert a.ok and b.ok and a.num_samples == b.num_samples == 32
    assert abs(a.val_loss - b.val_loss) < loss_tol, (a, b)
    flat_j = _flat_jax(jres.params)
    flat_t = _flat_jax(to_jax_params(tres.params, server.ctx.full_model))
    assert flat_j.keys() == flat_t.keys()
    close = total = 0
    for path, leaf in flat_j.items():
        np.testing.assert_allclose(flat_t[path], leaf, rtol=0, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(flat_t[path] - leaf) <= 1e-4).sum())
        total += leaf.size
    assert close >= bulk * total, (close, total)


def _assert_equal(a, b):
    assert [(r.ok, r.num_samples, r.val_loss) for r in a.history] == \
        [(r.ok, r.num_samples, r.val_loss) for r in b.history]
    assert a.params.keys() == b.params.keys()
    for layer, sd in a.params.items():
        for k, t in sd.items():
            assert torch.equal(t, b.params[layer][k]), (layer, k)


def test_tree_round_matches_the_jax_package(runs):
    server, tres = runs["torch"]
    _assert_close(runs["jax"], server, tres, 1e-4, 1e-4, 1.0)
    tmp = runs["tmp"]
    (jrec,), (trec,) = _agg_records(tmp / "jax"), _agg_records(tmp / "torch")
    assert {k: jrec[k] for k in TREE_FIELDS} == \
        {k: trec[k] for k in TREE_FIELDS} == {
            "fan_in": 2, "levels": 2, "partials": 2, "folded": 2,
            "n_samples": 32, "partial_codec": None}
    assert trec["root_ingress_bytes"] > 0


def test_a_dead_aggregator_falls_back_in_both_packages(runs):
    jres, jd = runs["jax_killed"]
    (server, tres), td = runs["torch_killed"]
    assert jd.get("agg_l1_fallbacks") == td.get("agg_l1_fallbacks") == 1
    assert not jd.get("partial_codec_errors")
    assert not td.get("partial_codec_errors")
    _assert_close(jres, server, tres, 1e-3, 1e-3, 0.999)
    tmp = runs["tmp"]
    (jrec,), (trec,) = (_agg_records(tmp / "jax_killed"),
                        _agg_records(tmp / "torch_killed"))
    assert {k: jrec[k] for k in TREE_FIELDS} == \
        {k: trec[k] for k in TREE_FIELDS}
    assert trec["partials"] == 2 and trec["partial_codec"] == "delta"
    # the raw-partial kill folds the dead group in the same shape
    (_, raw), raw_d = runs["torch_killed_raw"]
    assert raw_d.get("agg_l1_fallbacks") == 1
    _assert_equal(runs["torch"][1], raw)


def test_tcp_tree_round_equals_the_in_process_round(runs):
    server, res, stats = runs["torch_tcp"]
    _assert_equal(runs["torch_level1"][1], res)
    assert stats["published"] == stats["delivered"] > 0
    assert stats["published_bytes_by_family"].get("aggregate", 0) > 0
    for tag in ("torch_level1", "torch_tcp"):
        (trec,) = _agg_records(runs["tmp"] / tag)
        assert (trec["levels"], trec["partials"], trec["partial_codec"],
                trec["n_samples"]) == (1, 3, "int8", 32), trec
