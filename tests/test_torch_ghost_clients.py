"""Clients that register and never answer START, in the port's protocol
round on the CPU (``tests/test_torch_choreography.py``'s tiny KWT and
harness), strict SDA at ``sda-size: 2``:

* a stage-1 feeder (``[2, 1, 1]``): dropped at the READY barrier, the
  strict head, told the live feeder set with SYN, completes the round
  with the live feeder's samples, well before the round's 300 s client
  timeout;
* a middle client (``[2, 2, 1]``): SYN drops the head's fence quorum
  from 2 to 1, so the head records each feeder's fence from the one live
  middle.  The feeders' batches scattered to the dead middle's queue
  (DCSL's peers are fixed at START, as in the JAX package) never
  return, so the NOTIFY barrier waits out its 20 s and the PAUSE ends
  the round with the samples that did (each feeder's one batch through
  the live middle).

The READY barrier here first waits, without a deadline, for the live
clients (under the driver's parallel test workers a tiny client's START
can take tens of seconds), and then gives the ghost its 3 s deadline:
what the tests hold is the round after the drop, not the drop's timing.
"""

import time

from split_learning_torch.runtime.server import ProtocolContext
# two_threads and windows are fixtures, used by name
from test_torch_choreography import (  # noqa: F401
    FEEDERS, RecordingBus, Start, deploy, sda_cfg, two_threads, windows,
)

GHOST_WAIT = 3.0


def live_first(monkeypatch, ghost: str) -> None:
    """The READY barrier (the one barrier given a deadline) waits for
    every client but ``ghost`` first, then keeps its own predicate with a
    :data:`GHOST_WAIT` deadline."""
    pump = ProtocolContext._pump_until

    def pump_until(self, pred, what, deadline=None):
        if deadline is None:
            return pump(self, pred, what)
        live = {r.client_id for r in self.registrations} - {ghost}
        assert pump(self, lambda: live <= self._ready, "live READY",
                    time.monotonic() + 300)
        return pump(self, pred, what, time.monotonic() + GHOST_WAIT)
    monkeypatch.setattr(ProtocolContext, "_pump_until", pump_until)


def test_ghost_feeder_is_dropped_at_ready(tmp_path, windows, monkeypatch):
    live_first(monkeypatch, "client_1_1")
    cfg = sda_cfg(tmp_path, [2, 1, 1], [2, 4],
                  distribution={"num-samples": 8})
    bus = RecordingBus()
    result, by_id, wall = deploy(cfg, bus, ghosts=[("client_1_1", 1)])
    rec = result.history[0]
    assert rec.ok and rec.num_samples == 8
    assert wall < 120, wall   # no barrier waited out its 300 s
    syn = {cid: m for cid, m in bus.messages if type(m).__name__ == "Syn"}
    assert "client_1_1" not in syn
    assert syn["client_3_0"].sda_feeders == ["client_1_0"]
    assert by_id["client_3_0"].sda_feeders == ["client_1_0"]
    assert all(w == ["client_1_0"] for _, w, _ in windows)


def test_ghost_middle_lowers_the_heads_quorum(tmp_path, windows,
                                              monkeypatch):
    live_first(monkeypatch, "client_2_1")
    cfg = sda_cfg(tmp_path, [2, 2, 1], [2, 4],
                  distribution={"num-samples": 8})
    bus = RecordingBus()
    result, by_id, _ = deploy(cfg, bus, ghosts=[("client_2_1", 2)],
                              client_timeout=20.0)
    rec = result.history[0]
    assert rec.ok and 0 < rec.num_samples < 16
    start = next(m for cid, m in bus.messages
                 if cid == "client_3_0" and isinstance(m, Start))
    assert start.extra["sda_fence_quorum"] == 2
    head = by_id["client_3_0"]
    assert head.sda_fence_quorum == 1
    assert head._sda_fences == {f: 1 for f in FEEDERS}
    assert all(set(w) == FEEDERS for _, w, _ in windows if len(w) == 2)
