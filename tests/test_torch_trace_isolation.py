"""The port's round tracing stands alone: ``runtime/trace.py`` and
``runtime/spans.py`` import nothing of JAX or of the JAX package, and a
traced protocol round (a tiny KWT at ``[2, 1]``, the int8 codec on both
data planes, the sharded FedAvgM fold, the reliable layer under the
async sender) runs, journals and is split by ``tools/sl_trace.py`` in a
process where ``jax``, ``flax``, ``optax``, ``split_learning_tpu`` and
``ml_dtypes`` cannot be imported."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "split_learning_tpu", "ml_dtypes")
TRACING = ("split_learning_torch/runtime/trace.py",
           "split_learning_torch/runtime/spans.py")


@pytest.mark.parametrize("path", TRACING)
def test_tracing_modules_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names   # the scan saw the module's imports
    assert not [n for n in names if n.split(".")[0] in BLOCKED], names


def test_traced_round_runs_with_jax_blocked(tmp_path):
    kwt = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
           "synthetic-size": 48, "val-max-batches": 1, "val-batch-size": 8,
           "compute-dtype": "float32",
           "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
           "topology": {"cut-layers": [2]},
           "distribution": {"num-samples": 8},
           "transport": {"reliable": True,
                         "codec": {"intermediate": "int8",
                                   "gradient": "int8"}},
           "kernels": {"quantize": True, "dequantize": True,
                       "stage-update": True},
           "aggregation": {"strategy": "fedavg", "sharded": True,
                           "server-momentum": 0.9},
           "learning": {"batch-size": 4, "control-count": 1,
                        "optimizer": "sgd", "learning-rate": 1e-3},
           "checkpoint": {"save": False}, "log-path": str(tmp_path)}
    code = "\n".join([
        "import json, pathlib, subprocess, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime.server import run_inproc",
        "from split_learning_torch.runtime.trace import default_histograms",
        f"run = run_inproc(from_dict({kwt!r}), device='cpu',"
        " client_timeout=300)",
        "assert [(r.ok, r.num_samples) for r in run.result.history]"
        " == [(True, 16)], run.result.history",
        f"d = pathlib.Path({str(tmp_path)!r})",
        "parts = sorted(p.name for p in d.glob('spans-*.jsonl'))",
        "assert parts == ['spans-client_1_0.jsonl', 'spans-client_1_1.jsonl',"
        " 'spans-client_2_0.jsonl', 'spans-server.jsonl'], parts",
        "recs = [json.loads(l) for p in d.glob('spans-*.jsonl')"
        " for l in p.read_text().splitlines()]",
        "assert len({r['trace'] for r in recs}) == 1",
        "assert default_histograms.snapshot()['transport_rtt']['count'] > 0",
        "out = subprocess.run([sys.executable, 'tools/sl_trace.py', str(d),"
        " '--json'], capture_output=True, text=True, check=True).stdout",
        "rep = json.loads(out)[0]",
        "assert abs(rep['components_sum_s'] - rep['wall_s']) <= 1e-3, rep",
        "assert rep['frame_edges'] > 0",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('traced round ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "traced round ok" in proc.stdout
