"""Async decoupled split learning and the top-k/delta codecs as the
protocol round: the port against the JAX package, on the CPU.

Each round runs through both packages' ``ProtocolServer`` in the calling
thread and one ``ProtocolClient`` thread per client over an
``InProcTransport`` (``tests/test_torch_choreography_parity.py``'s
harness), from the JAX package's initial parameters, at a tiny float32
KWT (embed 16, 2 heads, MLP 32, dropout off), cut 2, batch 4, SGD at lr
0.05 with momentum 0.9, the float32 wire.

* **Async, round 0, ``async-quorum: 0``** at ``clients: [1, 1]``: one
  feeder, so the head consumes its batches in the one order there is and
  the round is deterministic in both packages (the head's PAUSE drain
  set to end at the feeder's last fence, not at an idle grace that a
  slow step can trip).  The feeder's aux head
  (``pooled-linear``) starts from the JAX package's weights (its
  initialization is recorded on the JAX side and carried across by
  ``convert.from_jax_aux``).  Held: no frame on the gradient family in
  either package, the samples, the validation loss within 1e-4 and every
  final parameter within 1e-4 (float32 summation order through the
  round's SGD steps, as ``tests/test_torch_choreography_parity.py``
  holds it).
* **The async quorum past a dead straggler** (the JAX package's
  ``test_async_quorum_cuts_past_dead_straggler`` recipe, in the port
  only): ``[2, 1]``, ``async-quorum: 2``, one feeder dies right before
  its UPDATE would leave.  The version cuts at the live feeder's and the
  head's UPDATEs, well inside the client timeout, with the live feeder's
  samples.
* **Sync with ``gradient: "topk:0.05"`` and ``rpc: "delta:int8"``**,
  ``[2, 1]``, 2 rounds: per queue family and message type, the number of
  frames and their payload bytes (array leaves: float tensors, int8 codes
  and scales, sparse indices and values) equal the JAX package's; the
  UPDATEs after the first START are deltas in both (``delta_folds``).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import client as jclient
from split_learning_tpu.runtime import protocol as jproto
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_aux, from_jax_params, to_jax_params,
)
from split_learning_torch.runtime import client as tclient
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.server import ProtocolServer as TServer
from split_learning_torch.runtime.trace import FaultCounters

TINY = {
    "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [1, 1],
    "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
    "val-batch-size": 16, "compute-dtype": "float32",
    "model-kwargs": {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32,
                     "dropout_rate": 0.0},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 16},
    "transport": {"wire-dtype": "float32"},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "sgd",
                 "learning-rate": 0.05, "momentum": 0.9},
    "aggregation": {"strategy": "fedavg"},
    "checkpoint": {"save": False},
}
ASYNC = {"mode": "async", "max-staleness": 2, "staleness-decay": 0.5,
         "async-quorum": 0}
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(tmp_path, d):
    return (jcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "jax")})),
            tcfg.from_dict(dict(d, **{"log-path": str(tmp_path / "torch")})))


def _ids(cfg):
    return [(f"client_{s}_{i}", s) for s, n in enumerate(cfg.clients, 1)
            for i in range(n)]


def _payload_bytes(o) -> int:
    if isinstance(o, dict):
        return sum(_payload_bytes(v) for v in o.values())
    if isinstance(o, (list, tuple)):
        return sum(_payload_bytes(v) for v in o)
    if type(o).__name__ in ("QuantLeaf", "SparseLeaf"):
        return sum(_payload_bytes(getattr(o, f)) for f in (
            ("q", "scale") if hasattr(o, "q") else ("idx", "val")))
    if isinstance(o, torch.Tensor):
        return o.numel() * o.element_size()
    if isinstance(o, np.ndarray):
        return o.nbytes
    return 0


def _recording(base, proto):
    """``base`` transport counting, per (queue family, message type), the
    frames and their payload bytes of every tensor frame and START."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.frames: dict = {}
            self.samples: dict = {}   # each client's UPDATE samples
            self._asm: dict = {}
            self._lock = threading.Lock()

        def publish(self, queue, payload):
            if callable(payload):
                payload = payload()
            parts = payload if isinstance(payload, list) else [payload]
            for part in parts:
                with self._lock:
                    msg = self._asm.setdefault(
                        queue, proto.FrameAssembler()).feed(part)
                    kind = type(msg).__name__
                    if kind == "Update":
                        self.samples.setdefault(msg.client_id, []).append(
                            msg.num_samples)
                    if kind in ("Activation", "Gradient", "Update",
                                "Start"):
                        family = queue.split("_")[0]
                        n = sum(_payload_bytes(getattr(msg, f, None))
                                for f in ("data", "params",
                                          "batch_stats"))
                        c, b = self.frames.get((family, kind), (0, 0))
                        self.frames[(family, kind)] = (c + 1, b + n)
                super().publish(queue, part)
    return Recording


def _serve(server, clients, **kw):
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    try:
        return server.serve(**kw)
    finally:
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread failed to stop"


def run_both(tmp_path, d, monkeypatch=None):
    jc, tc = _configs(tmp_path, d)
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    heads: list = []
    if monkeypatch is not None:
        # the JAX feeder's aux head initialization, recorded, becomes
        # the port feeder's
        orig = jclient.ShardRunner.init_aux_params

        def record(self, shapes):
            p = orig(self, shapes)
            heads.append(jax.tree_util.tree_map(np.asarray, p))
            return p
        monkeypatch.setattr(jclient.ShardRunner, "init_aux_params", record)
        orig_t = tclient.ShardRunner.init_aux_head

        def carry(self, boundary):
            head = orig_t(self, boundary)
            head.load_state_dict(from_jax_aux(heads[0]))
            return head
        monkeypatch.setattr(tclient.ShardRunner, "init_aux_head", carry)
    jbus = _recording(JBus, jproto)()
    jserver = JServer(jc, transport=jbus, client_timeout=300)
    jserver.ctx.init_variables = lambda: {"params": p0, "batch_stats": {}}
    j0 = jserver.ctx.faults.snapshot()
    jres = _serve(jserver, [jclient.ProtocolClient(jc, cid, s,
                                                   transport=jbus)
                            for cid, s in _ids(jc)])
    jres.faults = _delta(jserver.ctx.faults, j0)
    tbus = _recording(TBus, tproto)()
    tserver = TServer(tc, tbus, client_timeout=300, device="cpu")
    t0 = tserver.ctx.faults.snapshot()
    tres = _serve(tserver, [tclient.ProtocolClient(tc, cid, s, tbus,
                                                   device="cpu")
                            for cid, s in _ids(tc)],
                  init_params=from_jax_params(p0))
    tres.faults = _delta(tserver.ctx.faults, t0)
    return (jbus, jres, p0), (tbus, tres, tserver), heads


def _delta(faults, before: dict) -> dict:
    """The counters a run moved (the registries are process-wide)."""
    return {k: v - before.get(k, 0) for k, v in faults.snapshot().items()
            if v != before.get(k, 0)}


def test_async_round_matches_the_jax_package(tmp_path, monkeypatch):
    # the head's PAUSE drain ends at the feeder's last epoch fence only:
    # its idle grace counts a slow step (a first jit compile, a loaded
    # host) as idle time and could end the drain with batches queued
    for mod in (jclient, tclient):
        monkeypatch.setattr(mod, "ASYNC_DRAIN_IDLE_S", 300.0)
    d = dict(TINY, learning=dict(TINY["learning"], **ASYNC))
    (jbus, jres, p0), (tbus, tres, tserver), heads = run_both(
        tmp_path, d, monkeypatch)
    assert len(heads) == 1   # one feeder, one head shape
    for bus in (jbus, tbus):
        assert not any(q.startswith("gradient_queue")
                       for q in bus.bytes_out_snapshot()), \
            bus.bytes_out_snapshot()
        assert not any(f == "gradient" for f, _ in bus.frames)
    a, b = jres.history[0], tres.history[0]
    assert a.ok and b.ok and a.num_samples == b.num_samples == 16
    # every batch trained at both stages, in both packages
    assert jbus.samples == tbus.samples == {"client_1_0": [16],
                                             "client_2_0": [16]}
    assert abs(a.val_loss - b.val_loss) < TOL, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(tres.params, tserver.ctx.full_model)))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    start = dict(jax.tree_util.tree_leaves_with_path(p0))
    assert len(flat_j) == len(final_t)
    moved = 0.0
    for path, leaf in flat_j:
        np.testing.assert_allclose(final_t[path], leaf, rtol=TOL, atol=TOL,
                                   err_msg=str(path))
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert moved > 1e-3   # the round trained


class _UpdateCrash:
    """A client's transport that dies (as a process would) right before
    this client's UPDATE leaves."""

    def __init__(self, inner):
        self.inner = inner
        self.died = threading.Event()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def publish(self, queue, payload):
        if queue == tproto.RPC_QUEUE and not self.died.is_set():
            if callable(payload):
                payload = payload()
            parts = payload if isinstance(payload, list) else [payload]
            msg = tproto.FrameAssembler().feed(parts[0]) \
                if len(parts) == 1 else None
            if isinstance(msg, tproto.Update) or len(parts) > 1:
                self.died.set()
                from split_learning_torch.runtime.chaos import ChaosCrash
                raise ChaosCrash("straggler died before its UPDATE")
            payload = parts if len(parts) > 1 else parts[0]
        return self.inner.publish(queue, payload)


def test_async_quorum_cuts_past_a_dead_straggler(tmp_path):
    from split_learning_torch.runtime.chaos import ChaosCrash
    d = dict(TINY, clients=[2, 1], **{"distribution": {"num-samples": 8}},
             learning=dict(TINY["learning"], **dict(
                 ASYNC, **{"async-quorum": 2}), optimizer="adamw",
                 **{"learning-rate": 1e-3}))
    cfg = tcfg.from_dict(dict(d, **{"log-path": str(tmp_path)}))
    bus = TBus()
    server = TServer(cfg, bus, client_timeout=60.0, device="cpu")
    server.ctx.faults = FaultCounters()
    crashed = []

    def run(c):
        try:
            c.run()
        except ChaosCrash:
            crashed.append(c.client_id)
    threads = []
    for cid, s in _ids(cfg):
        stack = _UpdateCrash(bus) if cid == "client_1_1" else bus
        c = tclient.ProtocolClient(cfg, cid, s, stack, device="cpu")
        threads.append(threading.Thread(target=run, args=(c,),
                                        daemon=True))
    for t in threads:
        t.start()
    t0 = time.monotonic()
    res = server.serve()
    wall = time.monotonic() - t0
    for t in threads:
        t.join(timeout=30)
    assert crashed == ["client_1_1"]
    assert res.history[0].ok
    # only the live feeder's samples folded; no barrier waited out the
    # 60 s client timeout
    assert res.history[0].num_samples == 8
    assert wall < 45, f"quorum barrier stalled: {wall:.0f}s"
    assert not server.ctx.faults.snapshot().get("timeouts")


def test_sync_topk_delta_round_sends_the_jax_packages_frames(tmp_path):
    d = dict(TINY, clients=[2, 1], **{"global-rounds": 2},
             transport={"wire-dtype": "float32",
                        "codec": {"gradient": "topk:0.05",
                                  "rpc": "delta:int8"}})
    (jbus, jres, _), (tbus, tres, _), _ = run_both(tmp_path, d)
    assert [(r.ok, r.num_samples) for r in jres.history] == \
        [(r.ok, r.num_samples) for r in tres.history] == [(True, 32)] * 2
    assert set(jbus.frames) == set(tbus.frames)
    for key, ref in sorted(jbus.frames.items()):
        assert tbus.frames[key] == ref, key
    assert tbus.frames[("gradient", "Gradient")][0] == 16
    # every UPDATE is a delta in both (the first START already set the
    # base): 3 clients x 2 rounds
    assert jres.faults.get("delta_folds") == \
        tres.faults.get("delta_folds") == 6
    assert not tres.faults.get("delta_full_frames")
