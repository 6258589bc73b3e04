"""The port's protocol round under injected faults, on the CPU.

A tiny KWT (float32, strict SDA over ``[2, 1]``, ``control-count: 1``:
lockstep feeders and the sorted distinct-origin window make a fault-free
round bit-identical to itself) runs fault-free, then under the JAX
package's acceptance recipe (seed 1234: drop 0.10, duplicate 0.10,
reorder 0.15, corrupt 0.05, delay 0.10 of 5 ms) and under its
async-stack recipe (seed 4321: drop 0.25, duplicate 0.20, corrupt 0.15),
each participant on its own stack over the shared bus as
``make_runtime_transport`` builds it: every final parameter equal bit
for bit.  A scripted crash of a feeder after its first activation still
completes the round with the survivor's samples, and a TCP broker killed
and bound again after SYN costs both rounds nothing (reliable delivery
on every protocol queue).  The port's fault-free round is held against
the JAX package's in ``tests/test_torch_choreography_parity.py``.
"""

import dataclasses
import pathlib
import threading
import time

import pytest
import torch

from split_learning_torch.config import from_dict
from split_learning_torch.runtime.bus import Broker
from split_learning_torch.runtime.server import run_inproc
from split_learning_torch.runtime.trace import default_fault_counters

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_KWT = {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16}


def _cfg(tmp_path, name, **over):
    base = {
        "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
        "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
        "val-batch-size": 8, "compute-dtype": "float32",
        "model-kwargs": TINY_KWT, "log-path": str(tmp_path / name),
        "learning": {"batch-size": 4, "control-count": 1,
                     "optimizer": "adamw", "learning-rate": 1e-3},
        "distribution": {"num-samples": 8},
        "topology": {"cut-layers": [2]},
        "aggregation": {"strategy": "sda", "sda-size": 2,
                        "sda-strict": True, "local-rounds": 1},
        "checkpoint": {"save": False},
    }
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = {**base[k], **v}
        else:
            base[k] = v
    return from_dict(base)


def _faults_since(before: dict) -> dict:
    now = default_fault_counters.snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_bitwise(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fault_free")
    runs = [run_inproc(_cfg(tmp, f"ff{i}"), device="cpu",
                       client_timeout=300) for i in range(2)]
    for r in runs:
        assert r.stacks == {}   # the shared bus itself, no layers
    _assert_bitwise(runs[0].result.params, runs[1].result.params)
    return runs[0].result


#: chaos block, transport overrides, and the counters each recipe must
#: move at this size (the JAX package's own tests' choice: a tiny round
#: publishes too few frames for a 5 % corruption to be sure to fire)
RECIPES = {
    "acceptance_1234": (dict(seed=1234, drop=0.10, duplicate=0.10,
                             reorder=0.15, corrupt=0.05, delay=0.10,
                             **{"delay-s": 0.005}),
                        {"async-send": False},
                        ("drops", "redeliveries", "duplicates",
                         "dedup_hits")),
    "async_stack_4321": (dict(seed=4321, drop=0.25, duplicate=0.20,
                              corrupt=0.15), {},
                         ("drops", "redeliveries", "duplicates",
                          "dedup_hits", "corruptions", "corrupt_rejected")),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_chaos_round_bit_identical_to_fault_free(fault_free, tmp_path,
                                                 recipe):
    chaos, transport, moved = RECIPES[recipe]
    cfg = _cfg(tmp_path, recipe, chaos={"enabled": True, **chaos},
               transport={"reliable": True, "redeliver-s": 0.1,
                          **transport})
    before = default_fault_counters.snapshot()
    run = run_inproc(cfg, device="cpu", client_timeout=300)
    faults = _faults_since(before)
    from split_learning_torch.runtime.bus import (
        AsyncTransport, ReliableTransport,
    )
    from split_learning_torch.runtime.chaos import ChaosTransport
    assert sorted(run.stacks) == ["client_1_0", "client_1_1",
                                  "client_2_0", "server"]
    for stack in run.stacks.values():
        layer = stack
        if transport.get("async-send", True):
            assert isinstance(layer, AsyncTransport)
            layer = layer.inner
        assert isinstance(layer, ReliableTransport)
        assert isinstance(layer.inner, ChaosTransport)
        assert layer.inner.inner is run.bus
        assert not layer._daemon.is_alive(), "a daemon outlived the run"
    hist, base = run.result.history, fault_free.history
    assert [(r.ok, r.num_samples) for r in hist] == [
        (True, b.num_samples) for b in base]
    _assert_bitwise(run.result.params, fault_free.params)
    for k in moved:
        assert faults.get(k, 0) > 0, (k, faults)
    log = (tmp_path / recipe / "app.log").read_text()
    assert "round faults (cumulative):" in log


def test_scripted_crash_completes_the_round_with_the_survivor(tmp_path):
    crash = {"client": "client_1_1", "queue": "intermediate_queue*",
             "after": 1}
    cfg = _cfg(tmp_path, "crash",
               aggregation={"strategy": "fedavg", "sda-size": 1,
                            "sda-strict": False},
               chaos={"enabled": True, "crash": [crash]})
    before = default_fault_counters.snapshot()
    t0 = time.monotonic()
    # the NOTIFY and UPDATE barriers each wait the timeout out for the
    # dead feeder; it must still cover the survivor's training when the
    # machine is loaded
    run = run_inproc(cfg, device="cpu", client_timeout=12.0)
    assert time.monotonic() - t0 < 120
    assert run.crashed == ["client_1_1"]
    assert [(r.ok, r.num_samples) for r in run.result.history] == [
        (True, 8)]
    faults = _faults_since(before)
    assert faults.get("crashes") == 1 and faults.get("timeouts", 0) >= 1
    dead = run.stacks["client_1_1"]
    assert not dead._sender.is_alive()
    assert "timeout waiting for" in (tmp_path / "crash" / "app.log"
                                     ).read_text()


def test_broker_killed_and_bound_again_after_syn(tmp_path):
    """Participants in threads, each on its own stack from the config
    over TCP (reliable delivery on every protocol queue, ``reply_*``
    among them); the broker dies once the server has sent SYN and is
    bound again on its port: both rounds finish with every sample and
    the participants reconnect."""
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.server import ProtocolServer

    broker = Broker("127.0.0.1", 0)
    port = broker.port
    cfg = _cfg(tmp_path, "tcp", clients=[1, 1], **{"global-rounds": 2},
               aggregation={"strategy": "fedavg", "sda-size": 1,
                            "sda-strict": False},
               transport={"kind": "tcp", "port": port, "reliable": True,
                          "redeliver-s": 0.2, "reliable-queues": [
                              "intermediate_queue*", "gradient_queue*",
                              "rpc_queue", "reply_*"]})
    state = {"broker": broker, "killed": False}
    log = tmp_path / "tcp" / "app.log"

    def killer():
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if log.exists() and "SYN ->" in log.read_text():
                state["broker"].close()
                state["broker"] = Broker("127.0.0.1", port)
                state["killed"] = True
                return
            time.sleep(0.05)

    before = default_fault_counters.snapshot()
    kt = threading.Thread(target=killer, daemon=True)
    kt.start()
    errors = []
    try:
        server = ProtocolServer(cfg, client_timeout=300.0, device="cpu")
        clients = [ProtocolClient(cfg, f"client_{s}_0", s, device="cpu")
                   for s in (1, 2)]

        def run(c):
            try:
                c.run()
            except BaseException as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(c,), daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        result = server.serve()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread failed to stop"
        kt.join(timeout=10)
        assert not errors, errors
        assert state["killed"], "broker kill never triggered"
        assert [(r.ok, r.num_samples) for r in result.history] == [
            (True, 8), (True, 8)]
        assert _faults_since(before).get("reconnects", 0) >= 1
        assert "round faults (cumulative)" in log.read_text()
        for c in clients:
            assert not c.bus.inner._daemon.is_alive()
    finally:
        state["broker"].close()


def test_make_runtime_transport_builds_the_jax_packages_stack(tmp_path):
    """Over TCP with two shards: async over reliable (its own chaos-wrapped
    side connection, no crash scripts) over chaos (its own side
    connection) over the sharded plane; the prefetchers share the stack.
    Without the reliable layer each prefetcher gets its own plane
    connection."""
    from split_learning_torch.runtime import bus as tbus
    from split_learning_torch.runtime.chaos import (
        ChaosTransport, make_runtime_transport,
    )
    crash = {"client": "c", "queue": "rpc_queue", "after": 1}
    base = tbus.find_port_block(2)
    brokers = [Broker("127.0.0.1", base + i) for i in range(2)]
    cfg = _cfg(tmp_path, "stack", transport={
        "kind": "tcp", "port": base, "reliable": True},
        broker={"shards": 2}, chaos={"enabled": True, "seed": 3,
                                     "drop": 0.1, "crash": [crash]})
    stack = make_runtime_transport(cfg, "c")
    try:
        assert isinstance(stack, tbus.AsyncTransport)
        assert stack._recv_factory is None and stack._slice_gets
        rel = stack.inner
        assert isinstance(rel, tbus.ReliableTransport)
        assert rel.patterns == cfg.transport.reliable_queues
        assert isinstance(rel._side, ChaosTransport)
        assert rel._side.cfg.crash == () and rel._side.cfg.drop == 0.1
        assert isinstance(rel._side.inner, tbus.ShardedTcpTransport)
        chaos = rel.inner
        assert isinstance(chaos, ChaosTransport) and chaos._crash
        assert isinstance(chaos.inner, tbus.ShardedTcpTransport)
        assert chaos.inner.shards == 2 and chaos.inner.port == base
        assert isinstance(chaos._side, tbus.ShardedTcpTransport)
        assert chaos._side is not chaos.inner
    finally:
        stack.close()
    plain = make_runtime_transport(dataclasses.replace(
        cfg, transport=dataclasses.replace(cfg.transport, reliable=False),
        chaos=dataclasses.replace(cfg.chaos, enabled=False)), "c")
    try:
        assert isinstance(plain.inner, tbus.ShardedTcpTransport)
        assert plain._recv_factory is not None
    finally:
        plain.close()
        for b in brokers:
            b.close()


def test_a_crashed_client_process_exits_as_the_jax_packages_does(
        tmp_path):
    """A client process whose crash script fires at its first publish
    (REGISTER on ``rpc_queue``) sends that frame, then dies of the
    uncaught ``ChaosCrash``: the port's entry point exits with the JAX
    package's exit code, 1."""
    import os
    import subprocess
    import sys

    import yaml
    broker = Broker("127.0.0.1", 0)
    cfg = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [1, 1],
           "model-kwargs": TINY_KWT, "log-path": str(tmp_path / "logs"),
           "checkpoint": {"save": False},
           "transport": {"kind": "tcp", "port": broker.port},
           "chaos": {"enabled": True, "crash": [
               {"client": "client_1_0", "queue": "rpc_queue",
                "after": 1}]}}
    path = tmp_path / "crash.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--layer_id", "1", "--client_id",
            "client_1_0"]
    try:
        procs = {pkg: subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.client", *args, *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
            for pkg, extra in (("split_learning_tpu", []),
                               ("split_learning_torch",
                                ["--device", "cpu"]))}
        rcs = {}
        for pkg, p in procs.items():
            _, err = p.communicate(timeout=240)
            rcs[pkg] = p.returncode
            assert "ChaosCrash: scripted crash: client_1_0 dies at " \
                   "publish to rpc_queue" in err, err[-2000:]
        assert rcs == {"split_learning_tpu": 1, "split_learning_torch": 1}
        # each sent its fatal frame first: two REGISTERs wait on the
        # broker (each package decodes only its own frames)
        from split_learning_torch.runtime.bus import TcpTransport
        from split_learning_torch.runtime.protocol import Register, decode
        # a generous wait: under a loaded host the broker thread may be
        # off the CPU for seconds before it reads the exited clients'
        # frames
        t = TcpTransport("127.0.0.1", broker.port)
        got = [bytes(t.get("rpc_queue", timeout=60)) for _ in range(2)]
        assert t.get("rpc_queue", timeout=0.1) is None
        t.close()
        mine = []
        for raw in got:
            try:
                mine.append(decode(raw))
            except Exception:  # noqa: BLE001 — the JAX package's frame
                pass
        assert len(mine) == 1 and isinstance(mine[0], Register)
        assert mine[0].client_id == "client_1_0"
    finally:
        broker.close()
