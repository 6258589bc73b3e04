"""The port stands alone: it imports no JAX, nothing of the JAX package
and not ``ml_dtypes``, and its entry points run on the GPU unless the
caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "split_learning_torch"
BLOCKED = ("jax", "flax", "optax", "split_learning_tpu", "ml_dtypes")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_with_jax_blocked():
    """Every module of the port, and chip_smoke, imports in a process
    where jax, flax, optax, split_learning_tpu and ml_dtypes cannot be
    imported."""
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('isolated ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "isolated ok" in proc.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_names_a_blocked_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in BLOCKED, (path, node.lineno, n)


TINY = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1],
    "synthetic-size": 16, "val-max-batches": 1, "val-batch-size": 2,
    "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 32, "hidden_size": 16, "num_heads": 2,
                     "num_kv_heads": 1, "intermediate_size": 32,
                     "n_block": 1, "use_flash": True},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 8},
    "learning": {"batch-size": 2, "control-count": 2, "optimizer": "adamw"},
    "checkpoint": {"save": False},
}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg(tmp_path):
    from split_learning_torch.config import from_dict
    return from_dict(dict(TINY, **{"log-path": str(tmp_path)}))


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from split_learning_torch.device import resolve_device
    from split_learning_torch.run import main, run_local
    from split_learning_torch.runtime.context import TorchContext
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchContext(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local(cfg)
    yaml_path = tmp_path / "tiny.yaml"
    import yaml
    yaml_path.write_text(yaml.safe_dump(dict(TINY, **{
        "log-path": str(tmp_path)})))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(yaml_path)])


def test_entry_points_run_on_cpu_when_asked(no_gpu, tmp_path, capsys):
    from split_learning_torch.run import main, run_local
    res = run_local(_cfg(tmp_path), device="cpu")
    assert [r.ok for r in res.history] == [True]
    assert res.history[0].num_samples == 8
    import yaml
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(yaml.safe_dump(dict(TINY, **{
        "log-path": str(tmp_path)})))
    main(["--config", str(yaml_path), "--device", "cpu"])
    assert "round 0: ok=True samples=8" in capsys.readouterr().out


def test_protocol_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The protocol server and client default to CUDA and raise without
    it, before they build a transport; without a transport from the
    caller they build the configured stack."""
    from split_learning_torch.runtime.bus import (
        AsyncTransport, InProcTransport,
    )
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.server import ProtocolServer
    cfg, bus = _cfg(tmp_path), InProcTransport()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolServer(cfg, bus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolClient(cfg, "client_1_0", 1, bus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolServer(cfg)
    own = ProtocolClient(cfg, "client_1_0", 1, None, device="cpu")
    assert isinstance(own.bus, AsyncTransport)
    assert isinstance(own.bus.inner, InProcTransport)
    own.bus.close()
    ProtocolClient(cfg, "client_1_0", 1, bus, device="cpu")


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero and prints no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
