"""The strategies' protocol choreography in the port, on the CPU.

A tiny float32 KWT (embed 16, 2 heads, MLP 32: the JAX package's
``TINY_KWT`` in ``tests/test_protocol_runtime.py``) on synthetic
SpeechCommands, batch 4, through the port's protocol round in one
process: ``ProtocolServer`` in the calling thread, one ``ProtocolClient``
thread per client over an ``InProcTransport`` (``run_inproc``, or built
here where a ghost client or a recording bus takes part).  These are the
JAX package's own protocol tests of the same choreography, which it
marks slow:

* relay STARTs one stage-1 client at a time: 8 STARTs over 2 rounds of
  ``[2, 1]`` (FedAvg would send 6);
* SDA's strict window is a hard distinct-origin barrier whose partial
  windows drain only when the barrier is dead (too few origins with
  batches buffered or epochs unfenced), also across 2 local rounds,
  while the elastic window idle-flushes partials with nothing fenced;
  every sample is consumed;
* strict SDA through a middle stage (``[2, 1, 1]``), through two
  parallel middles (``[2, 2, 1]``: a fence counts at its quorum of 2
  copies) and through four stages (``[2, 2, 2, 1]``);
* (``tests/test_torch_ghost_clients.py``) a feeder or a middle client
  that registers and never answers;
* FLEX's hold rounds move no weights: of 8 STARTs and 8 UPDATEs over 4
  rounds of ``[1, 1]`` (``t-client: 2, t-global: 4``) 3 each carry
  weights; a hold START keeps the loader unless ``distribution.refresh``
  is on or its label counts moved;
* 2LS (``in-clusters: 2``) runs each feeder pair through its own
  ``intermediate_queue_1_{cluster}_p{pair}`` and each head hears only its
  pair's feeders.

The int8 codec runs on the strict three-stage case, through the port's
plain kernels.  Barriers that must not time out get 300 s: the driver
runs the tests in parallel workers, and a tiny round can then take tens
of seconds.
"""

import threading
import time

import numpy as np
import pytest
import torch

from split_learning_torch import config as tcfg
from split_learning_torch.runtime import server as tserver
from split_learning_torch.runtime.bus import InProcTransport
from split_learning_torch.runtime.client import ProtocolClient
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, FrameAssembler, Register, Start, Update, encode,
)
from split_learning_torch.runtime.server import ProtocolServer, run_inproc

TINY_KWT = {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32}
FEEDERS = {"client_1_0", "client_1_1"}
UNEVEN = [[2, 2, 2, 2, 2, 2, 0, 0, 0, 0],   # feeder A: 12 samples
          [1, 1, 1, 1, 0, 0, 0, 0, 0, 0]]   # feeder B: 4 samples


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def proto_cfg(tmp_path, **over):
    d = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
         "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
         "val-batch-size": 16, "compute-dtype": "float32",
         "model-kwargs": TINY_KWT, "log-path": str(tmp_path),
         "learning": {"batch-size": 4, "control-count": 2,
                      "optimizer": "adamw", "learning-rate": 1e-3},
         "distribution": {"num-samples": 24},
         "topology": {"cut-layers": [2]},
         "checkpoint": {"save": False}}
    for k, v in over.items():
        d[k] = dict(d[k], **v) if isinstance(d.get(k), dict) else v
    return tcfg.from_dict(d)


def sda_cfg(tmp_path, clients, cuts, strict=True, local_rounds=1, **over):
    return proto_cfg(tmp_path, clients=clients,
                     topology={"cut-layers": cuts},
                     aggregation={"strategy": "sda", "sda-size": 2,
                                  "sda-strict": strict,
                                  "local-rounds": local_rounds}, **over)


@pytest.fixture
def windows(monkeypatch):
    """Every SDA window as ``(client, root origins, the head's fenced
    epochs by feeder at that step)``, the real step still run."""
    seen: list = []
    step = ProtocolClient._sda_step

    def recording(self, window):
        seen.append((self.client_id, [a.trace[0] for a in window],
                     dict(self._sda_fences)))
        return step(self, window)
    monkeypatch.setattr(ProtocolClient, "_sda_step", recording)
    return seen


class RecordingBus(InProcTransport):
    """Decodes every control message the server sends a client:
    ``messages`` holds ``(client id, message)`` in send order."""

    def __init__(self):
        super().__init__()
        self.messages: list = []
        self._asm: dict = {}
        self._record = threading.Lock()

    def publish(self, queue, payload):
        if queue.startswith("reply_") or queue == RPC_QUEUE:
            with self._record:
                msg = self._asm.setdefault(queue,
                                           FrameAssembler()).feed(payload)
                if msg is not None:
                    self.messages.append((queue.removeprefix("reply_"),
                                          msg))
        super().publish(queue, payload)


def deploy(cfg, bus=None, ghosts=(), ready_timeout=None,
           client_timeout=300.0):
    """The server and one client thread per configured client over
    ``bus``, but that each ``(client id, stage)`` of ``ghosts`` only
    registers (so that planning counts it) and never answers.  Returns
    (the result, the clients by id, the run's wall)."""
    bus = bus or InProcTransport()
    server = ProtocolServer(cfg, bus, client_timeout=client_timeout,
                            ready_timeout=ready_timeout, device="cpu")
    gone = {cid for cid, _ in ghosts}
    clients = {f"client_{s}_{i}": ProtocolClient(
        cfg, f"client_{s}_{i}", s, bus, device="cpu")
        for s, n in enumerate(cfg.clients, start=1) for i in range(n)
        if f"client_{s}_{i}" not in gone}
    threads = [threading.Thread(target=c.run, daemon=True)
               for c in clients.values()]
    for t in threads:
        t.start()
    for cid, stage in ghosts:
        bus.publish(RPC_QUEUE, encode(Register(client_id=cid, stage=stage)))
    t0 = time.monotonic()
    result = server.serve()
    wall = time.monotonic() - t0
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "client thread failed to stop"
    return result, clients, wall


def _dead_barrier(origins, fences, n_epochs):
    """A partial window drains only when fewer than 2 origins could
    still fill a full one."""
    unfenced = {o for o in FEEDERS if fences.get(o, 0) < n_epochs}
    return len(unfenced | set(origins)) < 2


def test_relay_starts_one_feeder_at_a_time(tmp_path):
    bus = RecordingBus()
    cfg = proto_cfg(tmp_path, **{"global-rounds": 2},
                    aggregation={"strategy": "relay"})
    result, _, _ = deploy(cfg, bus)
    assert [(r.ok, r.num_samples) for r in result.history] == \
        [(True, 48), (True, 48)]
    starts = [cid for cid, m in bus.messages if isinstance(m, Start)]
    # one train_cluster a stage-1 client: it and the head, 2 x 2 x 2
    assert starts == ["client_1_0", "client_2_0", "client_1_1",
                      "client_2_0"] * 2


@pytest.mark.parametrize("strict,local_rounds", [
    (True, 1), (True, 2), (False, 1)], ids=["strict", "strict_2_epochs",
                                            "elastic"])
def test_strict_and_elastic_windows(tmp_path, windows, strict,
                                    local_rounds):
    cfg = sda_cfg(tmp_path, [2, 1], [2], strict, local_rounds,
                  distribution={"mode": "fixed", "matrix": UNEVEN})
    result, _, _ = deploy(cfg)
    assert result.history[0].ok
    assert result.history[0].num_samples == 16 * local_rounds
    full = [w for _, w, _ in windows if len(w) == 2]
    assert full and all(set(w) == FEEDERS for w in full)
    partials = [(w, f) for _, w, f in windows if len(w) < 2]
    assert partials, "uneven feeders leave a tail"
    for origins, fences in partials:
        if strict:
            assert _dead_barrier(origins, fences, local_rounds), (
                origins, fences)
        else:
            assert not fences   # idle flushes: no feeder ever fences


@pytest.mark.parametrize("clients,cuts,over", [
    ([2, 1, 1], [2, 4], {"distribution": {"mode": "fixed",
                                          "matrix": UNEVEN},
                         "transport": {"codec": {"intermediate": "int8",
                                                 "gradient": "int8"}},
                         "kernels": {"quantize": True,
                                     "dequantize": True}}),
    ([2, 2, 1], [2, 4], {"distribution": {"num-samples": 16}}),
    ([2, 2, 2, 1], [2, 4, 6], {"distribution": {
        "mode": "fixed", "matrix": [[2, 2, 2, 2, 0, 0, 0, 0, 0, 0],
                                    [1, 1, 1, 1, 0, 0, 0, 0, 0, 0]]}}),
], ids=["three_stages_int8", "two_middles", "four_stages"])
def test_strict_sda_through_middle_stages(tmp_path, windows, clients, cuts,
                                          over):
    local_rounds = 2 if clients == [2, 1, 1] else 1
    cfg = sda_cfg(tmp_path, clients, cuts, local_rounds=local_rounds,
                  **over)
    result, by_id, _ = deploy(cfg)
    rec = result.history[0]
    n = cfg.distribution.num_samples * 2 if cfg.distribution.mode == \
        "iid" else int(np.sum(cfg.distribution.matrix))
    assert rec.ok and rec.num_samples == n * local_rounds
    head = by_id[f"client_{len(clients)}_0"]
    assert head.sda_fence_quorum == max(1, clients[-2])
    full = [w for _, w, _ in windows if len(w) == 2]
    assert full and all(set(w) == FEEDERS for w in full)
    for _, origins, fences in windows:
        # each feeder's fence counted once an epoch, however many copies
        assert set(fences) <= FEEDERS
        assert all(v <= local_rounds for v in fences.values())
        if len(origins) < 2:
            assert _dead_barrier(origins, fences, local_rounds)


def test_flex_hold_rounds_move_no_weights(tmp_path):
    bus = RecordingBus()
    cfg = proto_cfg(tmp_path, clients=[1, 1], **{"global-rounds": 4},
                    aggregation={"strategy": "periodic", "t-client": 2,
                                 "t-global": 4})
    result, by_id, _ = deploy(cfg, bus)
    assert [r.ok and r.num_samples == 24 for r in result.history] == \
        [True] * 4
    assert [r.val_loss is not None for r in result.history] == \
        [False, False, False, True]
    starts = [m.params is not None for _, m in bus.messages
              if isinstance(m, Start)]
    updates = [m.params is not None for _, m in bus.messages
               if isinstance(m, Update)]
    # weights: START round 0 (both stages) and round 2 (stage 1, after
    # the t-client average); UPDATE stage 1 in rounds 1 and 3, stage 2
    # in round 3
    assert starts == [True, True, False, False, True, False, False, False]
    assert updates.count(True) == 3 and len(updates) == 8
    pauses = [(cid, m.send_weights) for cid, m in bus.messages
              if type(m).__name__ == "Pause"]
    assert sorted(pauses) == sorted(
        [("client_1_0", w) for w in (False, True, False, True)]
        + [("client_2_0", w) for w in (False, False, False, True)])


def _hold_client(tmp_path, **dist):
    cfg = proto_cfg(tmp_path, clients=[1, 1], **{"synthetic-size": 400},
                    distribution=dist)
    return ProtocolClient(cfg, "edge", 1, InProcTransport(), device="cpu")


def _start(params, counts, round_idx, refresh=False):
    return Start(start_layer=0, end_layer=2, cluster=0, params=params,
                 learning={}, label_counts=counts, round_idx=round_idx,
                 extra={"refresh": refresh, "gen": round_idx + 1})


@pytest.fixture(scope="module")
def shard():
    from split_learning_torch.models import build_model
    from split_learning_torch.runtime.server import _np_tree
    model = build_model("KWT_SPEECHCOMMANDS", 0, 2, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        **TINY_KWT)
    return _np_tree(model.state_tree())


def test_hold_start_keeps_shard_and_optimizer(tmp_path, shard):
    client = _hold_client(tmp_path)
    counts = np.full(10, 4)
    client._on_start(_start(shard, counts, 0))
    runner, loader = client.runner, client.loader
    opt = runner.optimizer
    client._on_start(_start(None, counts, 1))
    assert client.runner is runner and runner.optimizer is opt
    assert client.loader is loader
    assert client.fence == 2
    # new learning settings: a fresh optimizer over the kept weights
    w = {k: v.clone() for k, v in runner.model.state_dict().items()}
    msg = _start(None, counts, 2)
    msg.learning = {"learning_rate": 5e-4}
    client._on_start(msg)
    assert client.runner is runner and runner.optimizer is not opt
    assert runner.learning.learning_rate == 5e-4
    assert all(torch.equal(w[k], v)
               for k, v in runner.model.state_dict().items())
    # a weight-less START for a layer range it does not hold
    msg = _start(None, counts, 3)
    msg.end_layer = 3
    with pytest.raises(RuntimeError, match="no matching local shard"):
        client._on_start(msg)


def test_refresh_rebuilds_loader_on_weightless_start(tmp_path, shard):
    client = _hold_client(tmp_path, refresh=True)
    counts = np.full(10, 4)
    client._on_start(_start(shard, counts, 0, refresh=True))
    first = client.loader
    a = np.asarray(first.dataset.inputs)
    client._on_start(_start(None, counts, 1, refresh=True))
    assert client.loader is not first
    assert not np.array_equal(np.asarray(client.loader.dataset.inputs), a)


def test_hold_start_with_changed_label_counts_rebuilds_loader(tmp_path,
                                                             shard):
    client = _hold_client(tmp_path)
    client._on_start(_start(shard, np.full(10, 4), 0))
    first = client.loader
    client._on_start(_start(None, np.full(10, 4), 1))
    assert client.loader is first
    moved = np.concatenate([np.full(5, 8), np.zeros(5, int)])
    client._on_start(_start(None, moved, 2))
    assert client.loader is not first
    assert np.asarray(client.loader.dataset.labels).max() < 5


def test_2ls_pairs_feeders_with_their_heads(tmp_path, windows, monkeypatch):
    monkeypatch.setattr(tserver, "InProcTransport", RecordingBus)
    cfg = proto_cfg(tmp_path, clients=[4, 4],
                    aggregation={"strategy": "fedasync"},
                    topology={"num-clusters": 2, "in-clusters": 2})
    run = run_inproc(cfg, device="cpu", client_timeout=300)
    rec = run.result.history[0]
    assert rec.ok and rec.num_samples == 4 * 24
    data = {q for q in run.bus.bytes_out_snapshot()
            if q.startswith("intermediate_queue_")}
    assert data == {f"intermediate_queue_1_{c}_p{p}" for c in (0, 1)
                    for p in (0, 1)}, data
    starts = {cid: m for cid, m in run.bus.messages if isinstance(m, Start)}
    heard: dict = {}
    for head, origins, _ in windows:
        heard.setdefault(head, set()).update(origins)
    assert set(heard) == {f"client_2_{i}" for i in range(4)}
    for head, origins in heard.items():
        pair = (starts[head].cluster, starts[head].extra["pair"])
        assert {(starts[o].cluster, starts[o].extra["pair"])
                for o in origins} == {pair}, (head, origins)
        assert origins == set(starts[head].extra["sda_feeders"])
