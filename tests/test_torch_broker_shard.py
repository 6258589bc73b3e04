"""The port's sharded broker plane on the CPU.

``shard_for`` gives the JAX package's shard for every queue family of
the protocol, indices 0-63, 1-16 shards, and consecutive indices
round-robin.  ``ShardedTcpTransport`` over two port ``Broker``s routes
each queue to its owner, ``purge(None)`` sweeps both and
``collect_broker_stats`` reads both (a dead shard as an error row); a
reliable stream stays exact across a shard closed and bound again on its
port.  ``python -m split_learning_torch.broker --shards 2`` runs as a
process: it reports a killed shard once with its restart command, the
command brings the shard back, and SIGTERM ends the plane
(``--max-frame-gb`` refuses a longer frame).
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from split_learning_tpu.runtime.bus import shard_for as jax_shard_for
from split_learning_torch.runtime import bus as tbus
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, gradient_queue, intermediate_queue, reply_queue,
)
from split_learning_torch.runtime.trace import FaultCounters


def _families(i: int) -> list[str]:
    """One instance of each queue family the protocol names, at index
    ``i``."""
    return [intermediate_queue(1, i), intermediate_queue(i, 0),
            intermediate_queue(1, 0, pair=i),
            f"intermediate_queue_1_0_pclient_2_{i}",
            gradient_queue(1, f"client_1_{i}"),
            gradient_queue(2, f"client_2_{i}"),
            reply_queue(f"client_1_{i}"), reply_queue(f"client_{i}_0"),
            f"aggregate_queue_0_{i}", f"digest_queue_node{i}",
            f"__ack__.client_1_{i}#0a1b2c3d", f"reply_sim_1_{i:05d}",
            RPC_QUEUE, "__broker__.stats"]


@pytest.mark.parametrize("shards", range(1, 17))
def test_shard_for_equals_the_jax_packages(shards):
    for i in range(64):
        for q in _families(i):
            assert tbus.shard_for(q, shards) == jax_shard_for(q, shards), q


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_consecutive_indices_round_robin(shards):
    """Any ``shards`` consecutive instances of a family cover every
    shard, in a fixed stride."""
    for fam in ("intermediate_queue_0_{}", "intermediate_queue_{}_0",
                "aggregate_queue_0_{}", "reply_client_1_{}"):
        for start in (0, 5, 17):
            owners = [tbus.shard_for(fam.format(i), shards)
                      for i in range(start, start + shards)]
            assert sorted(owners) == list(range(shards)), (fam, owners)
            # one fixed stride: 1 for the last digit group, 1000003 ** k
            # mod shards for the group k places before it
            assert len({(b - a) % shards
                        for a, b in zip(owners, owners[1:])}) == 1


def _two_shards():
    for _ in range(10):
        base = tbus.find_port_block(2)
        try:
            b0 = tbus.Broker("127.0.0.1", base, shard_id="shard_0")
        except OSError:
            continue
        try:
            b1 = tbus.Broker("127.0.0.1", base + 1, shard_id="shard_1")
        except OSError:
            b0.close()
            continue
        return b0, b1
    raise OSError("no 2-port block")


def _queue_on(shard: int, fam: str = "intermediate_queue_0_{}") -> str:
    return next(fam.format(i) for i in range(64)
                if tbus.shard_for(fam.format(i), 2) == shard)


def test_sharded_transport_routes_purges_and_reports_both_shards():
    b0, b1 = _two_shards()
    st = tbus.ShardedTcpTransport("127.0.0.1", b0.port, 2)
    try:
        queues = [intermediate_queue(1, i) for i in range(8)]
        for i, q in enumerate(queues):
            st.publish(q, b"v%d" % i)
        stats = tbus.collect_broker_stats("127.0.0.1", b0.port, 2)
        assert [s["shard"] for s in stats] == ["shard_0", "shard_1"]
        for s in stats:
            owned = [q for q in queues
                     if tbus.shard_for(q, 2) == s["shard_index"]]
            assert s["published"] == s["depth"] == len(owned) > 0
        for i, q in enumerate(queues):
            owner = tbus.TcpTransport("127.0.0.1",
                                      b0.port + tbus.shard_for(q, 2))
            other = tbus.TcpTransport("127.0.0.1",
                                      b0.port + 1 - tbus.shard_for(q, 2))
            try:
                assert other.get(q, timeout=0.05) is None
                assert owner.get(q, timeout=2.0) == b"v%d" % i
            finally:
                owner.close()
                other.close()
        for i, q in enumerate(queues):
            st.publish(q, b"again")
        st.purge()   # None: every shard
        stats = tbus.collect_broker_stats("127.0.0.1", b0.port, 2)
        assert [s["depth"] for s in stats] == [0, 0]
        assert all(s["purges"] == 1 for s in stats)
        b1.close()
        stats = tbus.collect_broker_stats("127.0.0.1", b0.port, 2,
                                          timeout=1.0)
        assert "error" not in stats[0] and "error" in stats[1]
        assert stats[1]["port"] == b0.port + 1
    finally:
        st.close()
        b0.close()
        b1.close()


def test_make_transport_builds_the_plane():
    t = tbus.make_transport("tcp", "127.0.0.1", 12345, shards=3)
    assert isinstance(t, tbus.ShardedTcpTransport) and t.shards == 3
    assert t.endpoint(2) == ("127.0.0.1", 12347)
    t.close()


def test_reliable_stream_exact_across_a_shard_restart():
    b0, b1 = _two_shards()
    port0 = b0.port
    fc = FaultCounters()

    def mk():
        return tbus.ShardedTcpTransport("127.0.0.1", port0, 2,
                                        reconnect_timeout=30.0, faults=fc)

    q1 = _queue_on(1)   # the stream rides the shard that is restarted
    sender = tbus.ReliableTransport(mk(), sender="s",
                                    patterns=("intermediate_queue*",),
                                    side=mk(), redeliver_s=0.1, faults=fc)
    recv = tbus.ReliableTransport(mk(), sender="r",
                                  patterns=("intermediate_queue*",),
                                  side=mk(), redeliver_s=0.1, faults=fc)
    try:
        msgs = [b"m%02d" % i for i in range(12)]

        def send():
            for m in msgs:
                sender.publish(q1, m)
                time.sleep(0.05)

        t = threading.Thread(target=send, daemon=True)
        t.start()
        got = []
        for i in range(len(msgs)):
            if i == 4:
                # the owner dies mid-stream with what it held; the
                # envelope layer redelivers into the shard bound again
                b1.close()
                b1 = tbus.Broker("127.0.0.1", port0 + 1,
                                 shard_id="shard_1")
            m = recv.get(q1, timeout=30.0)
            assert m is not None, f"stream stalled at {i}"
            got.append(m)
        t.join()
        assert got == msgs
        snap = fc.snapshot()
        assert snap.get("reconnects", 0) >= 1
        assert snap.get("lost", 0) == 0 and snap.get("gave_up", 0) == 0
    finally:
        sender.close()
        recv.close()
        b0.close()
        b1.close()


def _wait_for(pred, timeout=20.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _serves(port: int) -> bool:
    try:
        tbus.broker_stats("127.0.0.1", port, timeout=0.5)
        return True
    except (OSError, ConnectionError):
        return False


def _supervisor(base: int, tmp_path, name: str):
    err = (tmp_path / f"{name}.err").open("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_torch.broker", "--shards",
         "2", "--port", str(base)], stdout=subprocess.PIPE, stderr=err,
        text=True)
    lines = [proc.stdout.readline() for _ in range(2)]
    assert lines == [f"broker shard {i}/2 on 127.0.0.1:{base + i}\n"
                     for i in range(2)], lines
    _wait_for(lambda: _serves(base) and _serves(base + 1), what="shards")
    return proc, err


def test_shard_supervisor_reports_a_dead_shard_once(tmp_path):
    base = tbus.find_port_block(2)
    proc, err = _supervisor(base, tmp_path, "kill")
    restarted = None
    try:
        pid = tbus.broker_stats("127.0.0.1", base + 1)["pid"]
        os.kill(pid, signal.SIGKILL)
        _wait_for(lambda: "restart:" in (tmp_path / "kill.err").read_text(),
                  what="the dead shard's report")
        time.sleep(1.5)   # three more polls: still one report
        text = (tmp_path / "kill.err").read_text()
        assert text.count("broker shard 1 exited") == 1, text
        assert "broker shard 0" not in text
        assert _serves(base) and not _serves(base + 1)
        cmd = text.split("(restart: ", 1)[1].split(")", 1)[0].split()
        assert cmd[1:] == ["-m", "split_learning_torch.broker", "--host",
                           "127.0.0.1", "--port", str(base + 1),
                           "--shard-id", f"shard_1@127.0.0.1:{base + 1}"]
        restarted = subprocess.Popen(cmd, stdout=subprocess.DEVNULL)
        _wait_for(lambda: _serves(base + 1), what="the restarted shard")
        stats = tbus.collect_broker_stats("127.0.0.1", base, 2)
        assert [s["shard"] for s in stats] == [
            f"shard_{i}@127.0.0.1:{base + i}" for i in range(2)]
        proc.send_signal(signal.SIGTERM)
        # a shard died on its own: remembered as the plane's exit code
        assert proc.wait(timeout=20) == 1
        assert not _serves(base)
    finally:
        for p in (proc, restarted):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        err.close()


def test_shard_supervisor_exits_0_on_sigterm(tmp_path):
    base = tbus.find_port_block(2)
    proc, err = _supervisor(base, tmp_path, "term")
    try:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
        assert not _serves(base) and not _serves(base + 1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


def test_max_frame_gb_refuses_a_longer_frame():
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_torch.broker", "--port",
         "0", "--max-frame-gb", str(64 * 1024 / (1 << 30))],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(line.split("python broker on ")[1].split()[0]
                   .rsplit(":", 1)[1])
        # every wait on the broker process is generous: under a loaded
        # host a subprocess can be off the CPU for seconds, longer than
        # the stats request's 2 s default
        t = tbus.TcpTransport("127.0.0.1", port)
        t.publish("q", b"x" * (64 * 1024))   # at the cap: kept
        assert bytes(t.get("q", timeout=60)) == b"x" * (64 * 1024)
        t.close()
        s = socket.create_connection(("127.0.0.1", port))
        s.sendall(b"P" + struct.pack(">I", 1) + b"q"
                  + struct.pack(">Q", 64 * 1024 + 1))
        s.settimeout(60)
        assert s.recv(1) == b""   # the broker dropped the connection
        s.close()
        stats = tbus.broker_stats("127.0.0.1", port, timeout=60)
        assert stats["oversize_frames"] == 1 and stats["published"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
