"""Lockstep multi-column clusters in the port's in-process round against
the JAX package's, on the CPU, at a tiny float32 TinyLlama.

``clients: [2, 1, 1, 1]`` — the TinyLlama protocol layout — trains two
stage-1 columns in lockstep; each of the three later stages has one
logical client, so the two columns form one sync group there and their
gradients for those stages are averaged before every optimizer step.
Both packages run two rounds from the same initial weights.
Tolerances are tests/test_torch_round.py's: samples equal, validation
loss within 1e-4, final parameters within 1e-4 (float32 summation order
through AdamW steps).
"""

import jax
import numpy as np
import pytest

from split_learning_tpu import config as jcfg
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime.context import TorchContext, client_groups
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan

COLUMNS = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [2, 1, 1, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 32, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 64,
                     "n_block": 2},
    "topology": {"cut-layers": [1, 2, 3]},
    "distribution": {"num-samples": 16},
    "aggregation": {"strategy": "fedavg"},
    "learning": {"batch-size": 4, "control-count": 2, "optimizer": "adamw",
                 "learning-rate": 1e-3},
    "checkpoint": {"save": False},
}


def test_columns_with_shared_later_stages_match_jax_package(tmp_path):
    d = dict(COLUMNS, **{"log-path": str(tmp_path)})
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    jctx = MeshContext(jc)
    p0 = jax.tree_util.tree_map(np.asarray, jctx.init_variables()["params"])
    jres = jrun(jc, jctx, jplan(jc, jregs(jc)),
                JLogger(tmp_path / "jax", console=False), init_params=p0)
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplan(tc, tregs(tc)),
                TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0))

    assert len(jres.history) == len(tres.history) == 2
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok
        assert a.num_samples == b.num_samples == 32
        assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = to_jax_params(tres.params, tctx.full_model)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(final_t))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], leaf, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("n_columns,n_logical,groups", [
    (2, 1, [[0, 1]]), (2, 2, [[0], [1]]), (3, 2, [[0, 1], [2]]),
    (4, 3, [[0], [1, 2], [3]]), (3, 5, [[0], [1], [2]]),
])
def test_client_groups_match_jax_package(n_columns, n_logical, groups):
    from split_learning_tpu.runtime.context import client_groups as jgroups
    assert client_groups(n_columns, n_logical) == groups
    assert jgroups(n_columns, n_logical) == groups
