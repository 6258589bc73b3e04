"""Six KWT configs of ``examples/variants/`` as the port's protocol round
on the CPU, as written (their own tiny widths; checkpoints off and logs
in a temporary directory): ``run_inproc(cfg, device="cpu")`` runs each
to its end, every round ok with the samples of its plan's stage-1
clients (each local epoch under SDA), the last round validated with a
finite loss.  The seventh, ``cluster_fsl.yaml``, waits out a client
timeout a round by design and has a file of its own
(``tests/test_torch_cluster_fsl_protocol.py``).  The client timeout is
300 s: no barrier here should wait it out, and under the driver's
parallel test workers a tiny round can take tens of seconds.
"""

import math
import pathlib

import pytest
import torch
import yaml

from split_learning_torch import config as tcfg
from split_learning_torch.runtime.plan import plan_clusters
from split_learning_torch.runtime.server import run_inproc

ROOT = pathlib.Path(__file__).resolve().parents[1]
KWT_VARIANTS = ("2ls", "dcsl", "dcsl_strict", "dcsl_strict_deep", "flex",
                "vanilla_sl")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_variant(tmp_path, name, client_timeout=300.0):
    """``examples/variants/{name}.yaml`` as the protocol round on the CPU;
    checks every round and returns the run."""
    d = yaml.safe_load((ROOT / "examples" / "variants" / f"{name}.yaml")
                       .read_text())
    assert d["model"] == "KWT"
    d.update({"checkpoint": {"save": False}, "log-path": str(tmp_path)})
    cfg = tcfg.from_dict(d)
    run = run_inproc(cfg, device="cpu", client_timeout=client_timeout)
    hist = run.result.history
    plans = plan_clusters(cfg, run.server.ctx.registrations)
    epochs = (cfg.aggregation.local_rounds
              if cfg.aggregation.strategy == "sda" else 1)
    want = sum(len(p.stage1_clients) for p in plans if p.clients[-1]) \
        * cfg.distribution.num_samples * epochs
    assert len(hist) == cfg.global_rounds
    assert [(r.ok, r.num_samples) for r in hist] == \
        [(True, want)] * len(hist)
    assert hist[-1].val_loss is not None and math.isfinite(
        hist[-1].val_loss)
    return run


@pytest.mark.parametrize("name", KWT_VARIANTS)
def test_variant_runs_as_the_protocol_round(tmp_path, name):
    run_variant(tmp_path, name)
