"""The port's TCP broker plane against the JAX package's, on the CPU.

The socket protocol is held equal both ways: a JAX ``TcpTransport``
against the port's ``Broker``, and a port ``TcpTransport`` against the
JAX ``Broker``, move payloads of 0 B, 1 B and several MB (one above the
broker's 256 KiB read chunk, so it arrives in many partial reads) back
byte for byte; a parked GET times out as ``None``; ``purge`` drops
pending frames; the stats frame parses; closing the broker wakes a
blocked getter.  Then the port's ``AsyncTransport``: per-queue order
across thunks and byte payloads, a failing thunk re-raised on the next
call, ``flush``, and a prefetcher that pulls no deeper than its depth.
"""

import json
import threading
import time

import numpy as np
import pytest

from split_learning_tpu.runtime import bus as jbus
from split_learning_torch.runtime import bus as tbus

PAYLOADS = [b"", b"\x00", bytes(range(256)) * 7,
            np.random.default_rng(0).bytes(5 * (1 << 20) + 3)]

PAIRS = {
    "jax_client_port_broker": (tbus.Broker, jbus.TcpTransport),
    "port_client_jax_broker": (jbus.Broker, tbus.TcpTransport),
    "port_client_port_broker": (tbus.Broker, tbus.TcpTransport),
}


@pytest.fixture(params=sorted(PAIRS))
def plane(request):
    broker_cls, transport_cls = PAIRS[request.param]
    broker = broker_cls("127.0.0.1", 0)
    made = []

    def connect():
        t = transport_cls("127.0.0.1", broker.port)
        made.append(t)
        return t
    yield broker, connect
    for t in made:
        t.close()
    broker.close()


def test_payloads_round_trip_byte_equal(plane):
    broker, connect = plane
    pub, sub = connect(), connect()
    for i, p in enumerate(PAYLOADS):
        pub.publish(f"q{i}", p)
    for i, p in enumerate(PAYLOADS):
        got = sub.get(f"q{i}", timeout=10)
        assert got is not None and bytes(got) == p, (i, len(p))
    # FIFO within one queue, the big frame between two small ones
    for p in (PAYLOADS[1], PAYLOADS[3], PAYLOADS[0]):
        pub.publish("fifo", p)
    assert [bytes(sub.get("fifo", timeout=10)) for _ in range(3)] == [
        PAYLOADS[1], PAYLOADS[3], PAYLOADS[0]]


def test_parked_get_is_completed_by_a_publish(plane):
    broker, connect = plane
    pub, sub = connect(), connect()
    out = []
    t = threading.Thread(target=lambda: out.append(sub.get("late", 10)))
    t.start()
    time.sleep(0.2)
    pub.publish("late", b"now")
    t.join(10)
    assert out == [b"now"]


def test_parked_get_times_out_as_none(plane):
    broker, connect = plane
    sub = connect()
    t0 = time.monotonic()
    assert sub.get("empty", timeout=0.3) is None
    assert 0.25 <= time.monotonic() - t0 < 5


def _fence(t):
    """Return once the broker has taken every frame ``t`` sent before:
    a publish is not acknowledged, but one connection's frames are
    handled in order, so a round trip on it orders them before another
    connection's next frame."""
    assert t.get(tbus.BROKER_STATS_QUEUE, timeout=5) is not None


def test_purge_drops_pending_frames(plane):
    broker, connect = plane
    pub, sub = connect(), connect()
    for q in ("a", "b", "c"):
        pub.publish(q, q.encode())
    _fence(pub)
    sub.purge(["a", "b"])
    assert sub.get("a", timeout=0.1) is None
    assert sub.get("b", timeout=0.1) is None
    assert sub.get("c", timeout=5) == b"c"
    pub.publish("d", b"d")
    _fence(pub)
    sub.purge()
    assert sub.get("d", timeout=0.1) is None


def test_stats_frame_parses(plane):
    broker, connect = plane
    pub = connect()
    pub.publish("s", b"12345")
    stats = json.loads(bytes(pub.get(tbus.BROKER_STATS_QUEUE, timeout=5)))
    assert stats["port"] == broker.port
    assert stats["published"] == 1 and stats["depth"] == 1
    assert stats["bytes_in"] > 5
    if isinstance(broker, tbus.Broker):
        assert stats["stored_bytes"] == 5
        assert stats["published_bytes_by_family"] == {"s": 5}
        assert stats["delivered_bytes_by_family"] == {}


def test_queue_family():
    assert [tbus.queue_family(q) for q in (
        "intermediate_queue_1_0", "gradient_queue_2_client_1_0",
        "rpc_queue", "reply_client_1_0", "__broker__.stats")] == [
        "intermediate", "gradient", "rpc", "reply", ""]


def test_closing_the_broker_wakes_a_blocked_getter(plane):
    broker, connect = plane
    sub = connect()
    sub._MAX_OP_RETRIES = 0      # no reconnect attempts after the close
    sub._reconnect_timeout = 0.2
    err = []

    def blocked():
        try:
            sub.get("never", timeout=None)
        except (ConnectionError, OSError) as e:
            err.append(e)
    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.2)
    broker.close()
    t.join(10)
    assert not t.is_alive() and err


# -- AsyncTransport -----------------------------------------------------------


class _Recorder(tbus.InProcTransport):
    """In-process queues that can be told to block publishes."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.gate.set()

    def publish(self, queue, payload):
        self.gate.wait(10)
        super().publish(queue, payload)


def test_async_keeps_per_queue_order_across_thunks_and_bytes():
    inner = _Recorder()
    bus = tbus.AsyncTransport(inner, send_depth=3)
    want = {"x": [], "y": []}
    for i in range(40):
        q = "xy"[i % 2]
        if i % 3 == 0:
            bus.publish(q, lambda i=i: [b"thunk%d-a" % i, b"thunk%d-b" % i])
            want[q] += [b"thunk%d-a" % i, b"thunk%d-b" % i]
        elif i % 3 == 1:
            bus.publish(q, lambda i=i: b"thunk%d" % i)
            want[q].append(b"thunk%d" % i)
        else:
            bus.publish(q, b"bytes%d" % i)
            want[q].append(b"bytes%d" % i)
    assert bus.flush(10)
    for q, frames in want.items():
        assert [inner.get(q, 1) for _ in frames] == frames
    assert 1 <= bus.send_hwm <= 3
    bus.close()


def test_async_reraises_a_failed_thunk():
    bus = tbus.AsyncTransport(tbus.InProcTransport())

    def boom():
        raise ValueError("encode failed")
    bus.publish("q", boom)
    bus.flush(10)
    with pytest.raises(ValueError, match="encode failed"):
        bus.publish("q", b"after")
    with pytest.raises(ValueError, match="encode failed"):
        bus.get("q", 0.01)


def test_async_flush_drains_the_queue():
    inner = _Recorder()
    inner.gate.clear()
    bus = tbus.AsyncTransport(inner, send_depth=8)
    for i in range(5):
        bus.publish("q", b"%d" % i)
    assert not bus.flush(timeout=0.2)   # the inner publish is held
    inner.gate.set()
    assert bus.flush(timeout=10)
    assert [inner.get("q", 1) for _ in range(5)] == [b"%d" % i
                                                    for i in range(5)]
    bus.close()


def test_prefetcher_pulls_no_deeper_than_its_depth():
    inner = tbus.InProcTransport()
    for i in range(6):
        inner.publish("gradient_queue_1_c", b"%d" % i)
        inner.publish("reply_c", b"r%d" % i)
    bus = tbus.AsyncTransport(inner, prefetch_depth=2)
    assert bus.get("gradient_queue_1_c", 5) == b"0"
    time.sleep(0.3)
    # one popped, two buffered ahead: three left in the inner queue
    assert len(inner._queues["gradient_queue_1_c"]) == 3
    # queues that match no pattern pass straight through
    assert len(inner._queues["reply_c"]) == 6
    assert bus.get("reply_c", 1) == b"r0"
    assert [bus.get("gradient_queue_1_c", 5) for _ in range(5)] == [
        b"%d" % i for i in range(1, 6)]
    assert bus.get("gradient_queue_1_c", 0.05) is None
    bus.close()


def test_async_over_tcp_slices_blocking_gets():
    """A blocking get on the one-socket TCP transport must not hold the
    sender's publishes back: with ``slice_gets`` the publish to another
    queue lands while the get is still waiting."""
    broker = tbus.Broker("127.0.0.1", 0)
    try:
        mk = lambda: tbus.TcpTransport("127.0.0.1", broker.port)  # noqa: E731
        bus = tbus.AsyncTransport(mk(), recv_factory=mk, slice_gets=True)
        other = mk()
        got = []
        t = threading.Thread(target=lambda: got.append(bus.get("ctl", 10)))
        t.start()
        time.sleep(0.2)
        bus.publish("out", b"frame")
        assert other.get("out", 5) == b"frame"   # not behind the get
        other.publish("ctl", b"go")
        t.join(10)
        assert got == [b"go"]
        bus.close()
        other.close()
    finally:
        broker.close()
