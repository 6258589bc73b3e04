"""``examples/variants/cluster_fsl.yaml`` as the port's protocol round on
the CPU, as written (checkpoints off, logs in a temporary directory).

It splits ``[4, 1]`` into two clusters, and the second has no stage-2
client in either package's plan: its feeders' batches have no consumer,
so each round its NOTIFY barrier waits out the client timeout and the
round counts the first cluster's samples, as the JAX package's protocol
round does.  The server's client timeout is set per cluster here, 300 s
for the first (which must never wait it out, even when the driver's
parallel test workers slow a tiny round to tens of seconds) and 8 s for
the headless one (which always does).  Each round is ok with the first
cluster's samples, the headless cluster's barrier is waited out, and the
last round is validated.
"""

import pytest
import torch

from split_learning_torch.runtime.server import ProtocolContext
from test_torch_variants_protocol import run_variant


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cluster_fsl_runs_as_the_protocol_round(tmp_path, monkeypatch):
    train_cluster = ProtocolContext.train_cluster

    def per_cluster_timeout(self, plan, *args, **kw):
        self.client_timeout = 300.0 if plan.clients[-1] else 8.0
        return train_cluster(self, plan, *args, **kw)
    monkeypatch.setattr(ProtocolContext, "train_cluster",
                        per_cluster_timeout)
    run = run_variant(tmp_path, "cluster_fsl")
    walls = [p["train_s"] for p in run.server.ctx.round_phases]
    # clusters 0 and 1 in each round: the headless one waits it out
    assert len(walls) == 4 and all(w >= 8.0 for w in walls[1::2]), walls
