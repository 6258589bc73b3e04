"""The port's deployment entry points as processes, on the CPU.

``python -m split_learning_torch.broker`` on a free port, then
``.server --device cpu`` and one ``.client --device cpu`` per stage of a
tiny ``clients: [1, 1]`` TinyLlama config written to ``tmp_path``: every
process exits 0 within a deadline, and the server's ``metrics.jsonl``
holds one round with samples and a ``kind=phases`` record.  Without
``--device cpu``, on a host with no GPU, ``.server`` and ``.client`` exit
non-zero with ``resolve_device``'s error.  Each process group is killed
in a ``finally``.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1],
    "global-rounds": 1, "synthetic-size": 16, "val-max-batches": 1,
    "val-batch-size": 2, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 32, "hidden_size": 16, "num_heads": 2,
                     "num_kv_heads": 1, "intermediate_size": 32,
                     "n_block": 1, "use_flash": True},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 8},
    "learning": {"batch-size": 2, "control-count": 2, "optimizer": "adamw"},
    "checkpoint": {"save": False},
}


def _spawn(args, log):
    # each process leads its own group: the finally kills each group
    return subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        p.wait(timeout=30)


def _broker_port(path: pathlib.Path, proc, deadline: float) -> int:
    while time.monotonic() < deadline:
        text = path.read_text()
        if "python broker on" in text:
            return int(text.split("python broker on ")[1].split()[0]
                       .rsplit(":", 1)[1])
        assert proc.poll() is None, text
        time.sleep(0.05)
    raise AssertionError("broker did not start")


def test_broker_server_and_clients_run_a_round_as_processes(tmp_path):
    procs, logs = [], {}

    def start(name, args):
        logs[name] = tmp_path / f"{name}.log"
        procs.append(_spawn(args, logs[name].open("w")))
        return procs[-1]

    deadline = time.monotonic() + 150
    try:
        broker = start("broker", ["split_learning_torch.broker",
                                  "--port", "0"])
        port = _broker_port(logs["broker"], broker, deadline)
        cfg = tmp_path / "config.yaml"
        cfg.write_text(json.dumps(dict(
            TINY, **{"log-path": str(tmp_path / "logs"),
                     "transport": {"kind": "tcp", "port": port}})))
        common = ["--config", str(cfg), "--device", "cpu"]
        server = start("server", ["split_learning_torch.server",
                                  *common, "--client_timeout", "120"])
        clients = [start(f"client{s}", ["split_learning_torch.client",
                                        *common, "--layer_id", str(s),
                                        "--client_id", f"client_{s}_0"])
                   for s in (1, 2)]
        for p in [server, *clients]:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        rcs = {n: p.returncode for n, p in zip(
            ["server", "client1", "client2"], [server, *clients])}
        assert rcs == {"server": 0, "client1": 0, "client2": 0}, {
            n: logs[n].read_text()[-2000:] for n in rcs}
        broker.send_signal(signal.SIGTERM)
        assert broker.wait(timeout=30) == 0
    finally:
        _kill(procs)
    out = logs["server"].read_text()
    assert "round 0: ok=True samples=8" in out, out[-2000:]
    records = [json.loads(line) for f in
               (tmp_path / "logs").glob("artifacts/runs/*/metrics.jsonl")
               for line in f.read_text().splitlines()]
    phases = [r for r in records if r.get("kind") == "phases"]
    rounds = [r for r in records if "num_samples" in r
              and r.get("kind") in (None, "round")]
    assert len(phases) == 1 and phases[0]["fanout_s"] >= 0, records
    assert len(rounds) == 1 and rounds[0]["num_samples"] > 0, records


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the failure on a host without a GPU")
@pytest.mark.parametrize("module,extra", [
    ("split_learning_torch.server", []),
    ("split_learning_torch.client", ["--layer_id", "1"]),
])
def test_entry_point_without_gpu_fails(tmp_path, module, extra):
    cfg = tmp_path / "config.yaml"
    # no broker listens on this port: the device check comes first
    cfg.write_text(json.dumps(dict(
        TINY, **{"log-path": str(tmp_path / "logs"),
                 "transport": {"kind": "tcp", "port": 9}})))
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--config", str(cfg), *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        _kill([proc])
    assert proc.returncode != 0
    assert "no CUDA device is available" in out, out[-2000:]
