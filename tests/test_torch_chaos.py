"""The port's fault injection and reliable layer against the JAX
package's, on the CPU.

``ChaosTransport`` of both packages, given the same ``ChaosConfig``,
participant name and frame stream, delivers the same bytes in the same
order with the same counters (seeds 3, 4 and 1234; drop, duplicate,
reorder and corruption; delay as a multiset), and a crash script fires
at the same publish, sends the fatal frame first and stays dead.  The
reliable envelope is the JAX package's byte for byte, and a JAX
``ReliableTransport`` receives the port's frames over a broker (and the
other way round).  Then the JAX package's own transport tests
(``tests/test_chaos.py``: ``TestChaosTransport``,
``TestReliableDelivery``), run on the port.
"""

import threading
import time

import pytest

from split_learning_tpu import config as jconfig
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime import chaos as jchaos
from split_learning_tpu.runtime import trace as jtrace
from split_learning_torch import config as tconfig
from split_learning_torch.runtime import bus as tbus
from split_learning_torch.runtime import chaos as tchaos
from split_learning_torch.runtime import trace as ttrace

DATA_Q = "intermediate_queue_0_0"

#: each package's (module, ChaosConfig, FaultCounters)
PKGS = {"jax": (jbus, jchaos, jconfig.ChaosConfig, jtrace.FaultCounters),
        "port": (tbus, tchaos, tconfig.ChaosConfig, ttrace.FaultCounters)}


def _chaos_cfg(cls, seed=7, **over):
    base = dict(enabled=True, seed=seed, queues=("intermediate_queue*",
                                                 "gradient_queue*"))
    base.update(over)
    return cls(**base)


def _drain(bus, queue, timeout=0.05):
    got = []
    while True:
        m = bus.get(queue, timeout=timeout)
        if m is None:
            return got
        got.append(bytes(m))


def _frames(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 200))) for _ in range(n)]


def _deliver(pkg, cfg_kw, frames, queues=(DATA_Q,), name="client_1_0",
             wait_s=0.0):
    """``frames`` published through ``pkg``'s ChaosTransport, round robin
    over ``queues``; returns what reached each queue and the counters."""
    bus_mod, chaos_mod, cfg_cls, fc_cls = PKGS[pkg]
    bus, fc = bus_mod.InProcTransport(), fc_cls()
    tx = chaos_mod.ChaosTransport(bus, _chaos_cfg(cfg_cls, **cfg_kw),
                                  name=name, faults=fc)
    for i, f in enumerate(frames):
        tx.publish(queues[i % len(queues)], f)
    time.sleep(wait_s)
    got = {q: _drain(bus, q) for q in queues}
    tx.stop(close_inner=False)
    return got, fc.snapshot()


RECIPES = {
    "mixed": dict(drop=0.2, duplicate=0.2, reorder=0.2, corrupt=0.1),
    "drop": dict(drop=0.3),
    "duplicate": dict(duplicate=0.3),
    "reorder": dict(reorder=0.3),
    "corrupt": dict(corrupt=0.3),
    "acceptance": dict(drop=0.10, duplicate=0.10, reorder=0.15,
                       corrupt=0.05),
}


@pytest.mark.parametrize("seed", [3, 4, 1234])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_chaos_stream_equals_the_jax_packages(seed, recipe):
    frames = _frames(60, seed)
    queues = (DATA_Q, "gradient_queue_0_0", "rpc_queue")
    kw = dict(RECIPES[recipe], seed=seed)
    j, jc = _deliver("jax", kw, frames, queues)
    t, tc = _deliver("port", kw, frames, queues)
    assert t == j
    assert tc == jc
    # rpc_queue is outside the recipe's queues: passed through untouched
    assert t["rpc_queue"] == frames[2::3]


@pytest.mark.parametrize("seed", [3, 1234])
def test_delayed_frames_equal_the_jax_packages_as_a_multiset(seed):
    frames = _frames(50, seed)
    kw = dict(seed=seed, drop=0.1, duplicate=0.1, reorder=0.15,
              corrupt=0.05, delay=0.3, delay_s=0.01)
    j, jc = _deliver("jax", kw, frames, wait_s=0.3)
    t, tc = _deliver("port", kw, frames, wait_s=0.3)
    assert tc == jc and tc["delays"] > 0
    assert sorted(t[DATA_Q]) == sorted(j[DATA_Q])


def test_delayed_frame_into_a_closed_bus_counts_late_drops():
    bus, fc = tbus.InProcTransport(), ttrace.FaultCounters()
    tx = tchaos.ChaosTransport(bus, _chaos_cfg(
        tconfig.ChaosConfig, delay=1.0, delay_s=0.05), name="c",
        faults=fc)
    tx.publish(DATA_Q, b"late")
    bus.close()
    time.sleep(0.3)
    assert fc.snapshot()["late_drops"] == 1


@pytest.mark.parametrize("after", [1, 3])
def test_crash_script_fires_at_the_same_publish(after):
    """The crash counts publishes on any queue its pattern matches, sends
    the fatal frame, then raises; every later publish and get raises
    again, in both packages."""
    spec = {"client": "c1", "queue": "intermediate_queue*",
            "after": after}
    seen = {}
    for pkg, (bus_mod, chaos_mod, cfg_cls, fc_cls) in PKGS.items():
        bus, fc = bus_mod.InProcTransport(), fc_cls()
        cfg = _chaos_cfg(cfg_cls, crash=(spec,))
        tx = chaos_mod.ChaosTransport(bus, cfg, name="c1", faults=fc)
        other = chaos_mod.ChaosTransport(bus, cfg, name="c2",
                                         faults=fc_cls())
        for _ in range(5):   # another client never crashes
            other.publish(DATA_Q, b"ok")
        fired = None
        for i in range(6):
            tx.publish("reply_c1", b"ctrl")   # not matched: not counted
            try:
                tx.publish(DATA_Q if i % 2 == 0 else "intermediate_queue_1",
                           b"m%d" % i)
            except chaos_mod.ChaosCrash:
                fired = i
                break
        with pytest.raises(chaos_mod.ChaosCrash):
            tx.publish("reply_c1", b"after")
        with pytest.raises(chaos_mod.ChaosCrash):
            tx.get(DATA_Q, timeout=0.01)
        seen[pkg] = (fired, _drain(bus, DATA_Q),
                     _drain(bus, "intermediate_queue_1"),
                     fc.snapshot())
    assert seen["port"] == seen["jax"]
    fired, q0, q1, snap = seen["port"]
    assert fired == after - 1 and snap == {"crashes": 1}
    assert (b"m%d" % fired) in q0 + q1   # the fatal frame was sent


@pytest.mark.parametrize("kind,seq,name,payload,t_send", [
    (0x03, 0, b"client_1_0#0123abcd", b"", 1.5),
    (0x03, 2 ** 40 + 7, b"server#ffffffff", bytes(range(256)) * 3,
     1760000000.25),
    (0x01, 5, b"s#1", b"legacy", None),
    (0x02, 17, b"intermediate_queue_0_0", b"", None),
])
def test_envelope_bytes_and_fields_equal_the_jax_packages(
        kind, seq, name, payload, t_send):
    jraw = jbus._env_frame(kind, seq, name, payload, t_send=t_send)
    traw = tbus._env_frame(kind, seq, name, payload, t_send=t_send)
    assert traw == jraw
    assert tbus._env_parse(traw) == jbus._env_parse(traw)
    for i in (0, 3, 7, len(traw) // 2, len(traw) - 1):
        bad = traw[:i] + bytes([traw[i] ^ 0xFF]) + traw[i + 1:]
        assert tbus._env_parse(bad) == jbus._env_parse(bad)
    for raw in (b"", b"RB", b"RB1\x00\x00", b"plain frame"):
        assert tbus._env_parse(raw) == jbus._env_parse(raw)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_reliable_streams_cross_packages_over_a_broker(direction):
    """A sender of one package and a receiver of the other, each over
    its own TCP connections to the port's broker, under the port's chaos
    below the sender: the receiver parses the envelopes, its acks reach
    the sender, and the stream arrives exact."""
    broker = tbus.Broker("127.0.0.1", 0)
    fc = ttrace.FaultCounters()
    snd_mod, rcv_mod = (tbus, jbus) if direction == "port_to_jax" \
        else (jbus, tbus)

    def tcp(mod):
        return mod.TcpTransport("127.0.0.1", broker.port)
    chaos = tchaos.ChaosTransport(tcp(snd_mod), _chaos_cfg(
        tconfig.ChaosConfig, seed=5, drop=0.2, duplicate=0.2,
        reorder=0.2, corrupt=0.1), name="s", faults=fc)
    sender = snd_mod.ReliableTransport(chaos, sender="s",
                                       patterns=("intermediate_queue*",),
                                       side=tcp(snd_mod), redeliver_s=0.05)
    recv = rcv_mod.ReliableTransport(tcp(rcv_mod), sender="r",
                                     patterns=("intermediate_queue*",),
                                     side=tcp(rcv_mod), redeliver_s=0.05)
    try:
        msgs = [b"frame-%03d" % i for i in range(40)]
        for m in msgs:
            sender.publish(DATA_Q, m)
        got = [recv.get(DATA_Q, timeout=10.0) for _ in msgs]
        assert [bytes(g) for g in got] == msgs
        deadline = time.monotonic() + 10
        while sender._unacked and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not sender._unacked, "acks did not reach the sender"
        assert fc.snapshot()["drops"] > 0
    finally:
        sender.close()
        recv.close()
        broker.close()


# --------------------------------------------------------------------------
# the JAX package's transport tests (tests/test_chaos.py), on the port
# --------------------------------------------------------------------------

def _pump(sender, msgs, queue=DATA_Q):
    t = threading.Thread(
        target=lambda: [sender.publish(queue, m) for m in msgs],
        daemon=True)
    t.start()
    return t


class TestChaosTransport:
    def _run(self, seed, n=40):
        got, snap = _deliver("port", dict(seed=seed, drop=0.2,
                                          duplicate=0.2, reorder=0.2),
                             [b"m%03d" % i for i in range(n)], name="s")
        return got[DATA_Q], snap

    def test_fault_pattern_reproducible_from_seed(self):
        a, ca = self._run(seed=3)
        b, cb = self._run(seed=3)
        assert a == b
        assert ca == cb
        c, _ = self._run(seed=4)
        assert a != c, "different seed produced the same fault pattern"
        assert ca["drops"] > 0 and ca["duplicates"] > 0
        assert ca["reorders"] > 0

    def test_corruption_flips_exactly_one_byte(self):
        got, _ = _deliver("port", dict(corrupt=0.5),
                          [b"x" * 64 for _ in range(30)], name="s")
        flipped = clean = 0
        for m in got[DATA_Q]:
            diff = sum(a != b for a, b in zip(m, b"x" * 64))
            assert diff in (0, 1) and len(m) == 64
            flipped += diff == 1
            clean += diff == 0
        assert flipped and clean

    def test_scripted_crash_point(self):
        bus = tbus.InProcTransport()
        spec = {"client": "c1", "queue": "intermediate_queue*",
                "after": 3}
        cfg = _chaos_cfg(tconfig.ChaosConfig, crash=(spec,))
        tx = tchaos.ChaosTransport(bus, cfg, name="c1",
                                   faults=ttrace.FaultCounters())
        other = tchaos.ChaosTransport(bus, cfg, name="c2",
                                      faults=ttrace.FaultCounters())
        for _ in range(5):
            other.publish(DATA_Q, b"ok")
        tx.publish(DATA_Q, b"one")
        tx.publish("reply_c1", b"ctrl")
        tx.publish(DATA_Q, b"two")
        with pytest.raises(tchaos.ChaosCrash):
            tx.publish(DATA_Q, b"three")
        assert b"three" in _drain(bus, DATA_Q)


class TestReliableDelivery:
    @pytest.mark.parametrize("seed", [7, 11, 23])
    def test_exact_stream_under_all_fault_classes(self, seed):
        bus = tbus.InProcTransport()
        fc = ttrace.FaultCounters()
        chaos = tchaos.ChaosTransport(bus, _chaos_cfg(
            tconfig.ChaosConfig, seed=seed, drop=0.2, duplicate=0.2,
            reorder=0.2, corrupt=0.1, delay=0.1, delay_s=0.01), name="s",
            faults=fc)
        sender = tbus.ReliableTransport(chaos, sender="s",
                                        patterns=("intermediate_queue*",),
                                        redeliver_s=0.05, faults=fc)
        recv = tbus.ReliableTransport(bus, sender="r",
                                      patterns=("intermediate_queue*",),
                                      redeliver_s=0.05, faults=fc)
        msgs = [b"payload-%03d" % i for i in range(80)]
        t = _pump(sender, msgs)
        got = [recv.get(DATA_Q, timeout=10.0) for _ in msgs]
        t.join()
        assert got == msgs, "stream not exact/in-order under faults"
        assert recv.get(DATA_Q, timeout=0.3) is None, "phantom message"
        snap = fc.snapshot()
        assert snap["drops"] and snap["redeliveries"]
        assert snap["duplicates"] and snap["dedup_hits"]
        assert snap["corruptions"] and snap["corrupt_rejected"]
        sender.stop(close_inner=False)
        recv.stop(close_inner=False)
        chaos.stop(close_inner=False)

    def test_unmatched_queues_pass_through_raw(self):
        bus = tbus.InProcTransport()
        sender = tbus.ReliableTransport(bus, sender="s",
                                        patterns=("intermediate_queue*",))
        recv = tbus.ReliableTransport(bus, sender="r",
                                      patterns=("intermediate_queue*",))
        sender.publish("reply_c1", b"ctrl")
        assert recv.get("reply_c1", timeout=1.0) == b"ctrl"
        assert bus.bytes_out["reply_c1"] == len(b"ctrl"), \
            "control frame grew an envelope"
        sender.stop(close_inner=False)
        recv.stop(close_inner=False)

    def test_bounded_redelivery_gives_up(self):
        bus = tbus.InProcTransport()
        fc = ttrace.FaultCounters()
        sink = tchaos.ChaosTransport(bus, _chaos_cfg(
            tconfig.ChaosConfig, drop=1.0), name="s", faults=fc)
        sender = tbus.ReliableTransport(sink, sender="s",
                                        patterns=("intermediate_queue*",),
                                        redeliver_s=0.02, max_redeliver=3,
                                        faults=fc)
        sender.publish(DATA_Q, b"doomed")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not fc.snapshot().get(
                "gave_up"):
            time.sleep(0.02)
        assert fc.snapshot().get("gave_up") == 1
        assert fc.snapshot().get("redeliveries") == 3
        assert not sender._unacked, "gave-up frame still buffered"
        sender.stop(close_inner=False)

    def test_a_gap_given_up_on_is_skipped_and_counted_lost(self):
        """The receiver holds seq 1 behind a missing seq 0; once the gap
        is older than ``gap_timeout_s`` it hands seq 1 up and counts the
        frame lost."""
        bus = tbus.InProcTransport()
        fc = ttrace.FaultCounters()
        recv = tbus.ReliableTransport(bus, sender="r",
                                      patterns=("intermediate_queue*",),
                                      gap_timeout_s=0.3, faults=fc)
        bus.publish(DATA_Q, tbus._env_frame(tbus._ENV_DATA_TS, 1,
                                            b"s#1", b"second"))
        assert recv.get(DATA_Q, timeout=0.1) is None
        assert recv.get(DATA_Q, timeout=2.0) == b"second"
        snap = fc.snapshot()
        assert snap["lost"] == 1 and snap["resequenced"] == 1
        recv.stop(close_inner=False)


def test_stop_stack_stops_every_layer_and_spares_a_shared_bus():
    cfg = tconfig.from_dict({
        "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [1, 1],
        "transport": {"reliable": True},
        "chaos": {"enabled": True, "seed": 1, "drop": 0.5}})
    bus = tbus.InProcTransport()
    stack = tchaos.make_runtime_transport(cfg, "client_1_0", bus=bus)
    assert isinstance(stack, tbus.AsyncTransport)
    rel = stack.inner
    assert isinstance(rel, tbus.ReliableTransport)
    assert isinstance(rel.inner, tchaos.ChaosTransport)
    assert rel.inner.inner is bus
    tchaos.stop_stack(stack, close_inner=False)
    assert not rel._daemon.is_alive() and not stack._sender.is_alive()
    bus.publish("q", b"still open")
    assert bus.get("q", timeout=1.0) == b"still open"
