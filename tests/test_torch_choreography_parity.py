"""The strategies' protocol choreography: the port against the JAX
package, on the CPU.

Each case runs one config through both packages' ``ProtocolServer`` in
the calling thread and one ``ProtocolClient`` thread per client over an
``InProcTransport`` (``tests/test_torch_protocol.py``'s harness), from
the JAX package's initial parameters (carried across by
``convert.from_jax_params``).  Every case shares one width, cut and
batch, so that the JAX package compiles its KWT programs once: a tiny
float32 KWT (embed 16, 2 heads, MLP 32, dropout off: the RNG streams
cannot match), cut 2, batch 4, ``control-count: 1``, SGD at lr 0.05
with momentum 0.9.  Not the variants' AdamW: Adam's step ``m / (sqrt(v)
+ eps)`` on a gradient that is zero but for float32 summation noise (an
attention key bias's) is a step of up to the learning rate in a random
direction, which says nothing about the strategy
(``tests/test_torch_strategies.py``); SGD's momentum buffers still
carry across a hold round as Adam's moments would.

**Where the order is fixed** — one batch of each feeder in flight, so
every client steps its optimizer in the same order in both packages:

* strict SDA, ``[2, 1]``, ``sda-size: 2``, one round: each window is
  one batch of each feeder in sorted origin order; with the int8 codec
  on both cut directions (the JAX package's Pallas codec under the
  interpreter, the port's plain kernels);
* relay, ``[2, 1]``, two rounds: the feeders one after the other;
* FLEX (``periodic``), ``[1, 1]``, ``t-client: 1, t-global: 2``, two
  rounds: round 0 uploads stage 1's weights and holds stage 2's shard
  and moments, round 1 re-seeds stage 1 and keeps stage 2 in its hold.

Held: samples equal a round, validation loss within 1e-4 where a round
validates, and every final parameter within 1e-4 on the float32 wire
(float32 summation order through a few AdamW steps a stage, as in
``tests/test_torch_protocol.py``).  With the int8 codec every parameter
is within 1e-2 and 99 % of them within 1e-4: a code can flip at a .5
boundary where the two packages' activations differ by float32 noise,
which moves one value by a quantization step (1/127 of its tile's
absmax) and so one gradient element, whose effect on the parameters
it feeds stays far below 1e-2 over a round
(``tests/test_torch_protocol.py``'s reasoning and bounds).

**Where thread timing sets the order** — the elastic SDA window (which
feeder's batch arrives first, and when a partial window flushes) and
2LS (``fedasync``, ``[4, 4]``, 2 out-clusters of 2 in-clusters, whose
merge follows the order the in-clusters report; the JAX package's own
2LS protocol round fails after its START fan-out, see
:func:`test_2ls_starts_match_the_jax_packages`) — the wire facts are
held equal: every START, SYN and PAUSE each client receives, field by
field (the weights present or not, the label counts, and the START
extras the port sends: epochs, the SDA window, strictness, fence quorum
and feeder set, the 2LS pair, DCSL's scatter peers, stage count,
refresh and generation), the data-plane queue names, each UPDATE's
sample count and whether it carries weights, and each round's samples.
Parameters are not compared there.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import protocol as jproto
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.client import ProtocolClient as TClient
from split_learning_torch.runtime.server import ProtocolServer as TServer

TINY = {
    "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
    "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
    "val-batch-size": 16, "compute-dtype": "float32",
    "model-kwargs": {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32,
                     "dropout_rate": 0.0},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 16},
    "transport": {"wire-dtype": "float32"},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "sgd",
                 "learning-rate": 0.05, "momentum": 0.9},
    "checkpoint": {"save": False},
}
INT8 = {"transport": {"wire-dtype": "float32",
                      "codec": {"intermediate": "int8", "gradient": "int8"}},
        "kernels": {"quantize": True, "dequantize": True}}
#: the START extras both packages send
EXTRAS = ("epochs", "sda_size", "sda_strict", "sda_fence_quorum",
          "sda_feeders", "pair", "sda_peers", "n_stages", "refresh", "gen")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recording(base, proto):
    """``base`` transport that keeps, per client, every control message
    the server sends it and every UPDATE it sends, as wire facts."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.facts: dict = {}
            self._asm: dict = {}
            self._lock = threading.Lock()

        def publish(self, queue, payload):
            if queue.startswith("reply_") or queue == proto.RPC_QUEUE:
                with self._lock:
                    msg = self._asm.setdefault(
                        queue, proto.FrameAssembler()).feed(payload)
                    fact = msg is not None and _fact(msg)
                    if fact:
                        cid = (msg.client_id if queue == proto.RPC_QUEUE
                               else queue.removeprefix("reply_"))
                        self.facts.setdefault(cid, []).append(fact)
            super().publish(queue, payload)
    return Recording


def _fact(msg):
    kind = type(msg).__name__
    if kind == "Start":
        counts = (None if msg.label_counts is None
                  else [int(c) for c in msg.label_counts])
        return (kind, msg.start_layer, msg.end_layer, msg.cluster,
                msg.params is None, counts, msg.round_idx,
                {k: msg.extra.get(k) for k in EXTRAS})
    if kind == "Syn":
        return (kind, msg.round_idx, msg.sda_fence_quorum, msg.sda_feeders)
    if kind == "Pause":
        return (kind, msg.send_weights)
    if kind == "Update":
        return (kind, msg.stage, msg.num_samples, msg.params is None)
    return None


def _serve(server, clients, **kw):
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    try:
        return server.serve(**kw)
    finally:   # the server STOPs every client, also when it raises
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread failed to stop"


def _ids(cfg):
    return [(f"client_{s}_{i}", s) for s, n in enumerate(cfg.clients, 1)
            for i in range(n)]


#: the JAX package's bus of the last run (a JAX run that raises keeps
#: what it sent)
_LAST: dict = {}


def _configs(tmp_path, over):
    d = dict(TINY, **over)
    return (jcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "jax")})),
            tcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "torch")})))


def run_torch(tmp_path, over, p0=None):
    _, tc = _configs(tmp_path, over)
    tbus = _recording(TBus, tproto)()
    tserver = TServer(tc, tbus, client_timeout=300, device="cpu")
    tres = _serve(tserver, [TClient(tc, cid, s, tbus, device="cpu")
                            for cid, s in _ids(tc)],
                  init_params=None if p0 is None else from_jax_params(p0))
    return tbus, tres, tserver


def run_both(tmp_path, over):
    """``over`` applied to :data:`TINY`, through the JAX package and the
    port from the same weights: ((JAX bus, result), (port bus, result,
    server))."""
    jc, _ = _configs(tmp_path, over)
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    jbus = _recording(JBus, jproto)()
    _LAST["jax"] = jbus
    jserver = JServer(jc, transport=jbus, client_timeout=300)
    jserver.ctx.init_variables = lambda: {"params": p0, "batch_stats": {}}
    jres = _serve(jserver, [JClient(jc, cid, s, transport=jbus)
                            for cid, s in _ids(jc)])
    return (jbus, jres), run_torch(tmp_path, over, p0)


def _data_queues(bus):
    snap = (bus.bytes_out_snapshot() if hasattr(bus, "bytes_out_snapshot")
            else dict(bus.bytes_out))
    return {q for q in snap
            if q.startswith(("intermediate_queue", "gradient_queue"))}


def _assert_same_wire(jbus, tbus):
    assert set(jbus.facts) == set(tbus.facts)
    for cid, facts in jbus.facts.items():
        assert tbus.facts[cid] == facts, cid
    assert _data_queues(jbus) == _data_queues(tbus)


SDA_STRICT = {"aggregation": {"strategy": "sda", "sda-size": 2,
                              "sda-strict": True, "local-rounds": 1}}


@pytest.mark.parametrize("over,rounds,tol,bulk", [
    (dict(SDA_STRICT, **INT8), 1, 1e-2, 0.99),
    ({"aggregation": {"strategy": "relay"}, "global-rounds": 2}, 2, 1e-4,
     1.0),
    ({"clients": [1, 1], "global-rounds": 2,
      "aggregation": {"strategy": "periodic", "t-client": 1,
                      "t-global": 2}}, 2, 1e-4, 1.0),
], ids=["strict_sda_int8", "relay", "flex"])
def test_fixed_order_strategies_match_the_jax_package(tmp_path, over,
                                                      rounds, tol, bulk):
    (jbus, jres), (tbus, tres, tserver) = run_both(tmp_path, over)
    _assert_same_wire(jbus, tbus)
    assert len(jres.history) == len(tres.history) == rounds
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok and a.num_samples == b.num_samples > 0
        assert (a.val_loss is None) == (b.val_loss is None)
        if a.val_loss is not None:
            assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(tres.params, tserver.ctx.full_model)))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    assert len(flat_j) == len(final_t)
    close = total = 0
    for path, leaf in flat_j:
        np.testing.assert_allclose(final_t[path], leaf, rtol=tol, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(final_t[path] - leaf) <= 1e-4).sum())
        total += leaf.size
    assert close >= bulk * total, (close, total)


def test_elastic_sda_sends_the_jax_packages_wire(tmp_path):
    (jbus, jres), (tbus, tres, _) = run_both(tmp_path, {
        "aggregation": {"strategy": "sda", "sda-size": 2,
                        "local-rounds": 1}})
    _assert_same_wire(jbus, tbus)
    assert [(r.ok, r.num_samples) for r in jres.history] == \
        [(r.ok, r.num_samples) for r in tres.history] == [(True, 32)]


def test_2ls_starts_match_the_jax_packages(tmp_path):
    """2LS's pairing rides the START fan-out.  The JAX package's protocol
    round fails after it: ``_train_cluster_once`` rebinds ``groups``, its
    aggregator-tree groups, to 2LS's in-groups
    (``split_learning_tpu/runtime/server.py:1841``), so the aggregator-tree
    branch at ``:2086`` runs on a list and raises ``AttributeError``.
    The port runs the round; its STARTs to the first out-cluster equal
    the JAX package's, field by field."""
    over = {"clients": [4, 4], "aggregation": {"strategy": "fedasync"},
            "topology": {"cut-layers": [2], "num-clusters": 2,
                         "in-clusters": 2},
            "distribution": {"num-samples": 8}}
    with pytest.raises(AttributeError, match="idx"):
        run_both(tmp_path, over)
    jbus = _LAST["jax"]
    tbus, tres, _ = run_torch(tmp_path, over)
    assert [(r.ok, r.num_samples) for r in tres.history] == [(True, 32)]
    assert len(jbus.facts) == 4   # one out-cluster: 2 feeders, 2 heads
    for cid, facts in jbus.facts.items():
        assert {f[0] for f in facts} == {"Start"}
        assert tbus.facts[cid][:len(facts)] == facts, cid
    pairs = {cid: f[0][-1]["pair"] for cid, f in jbus.facts.items()}
    assert sorted(pairs.values()) == [0, 0, 1, 1]
    assert {q for q in _data_queues(tbus) if "intermediate" in q} == {
        f"intermediate_queue_1_{c}_p{p}" for c in (0, 1) for p in (0, 1)}
