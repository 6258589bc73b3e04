"""The in-process round of the port against the JAX package's, on the CPU.

A tiny float32 TinyLlama config in the shape of examples/llama_flash.yaml
runs two rounds through both packages' ``run_training`` from the same
initial weights (carried across by ``split_learning_torch.convert``).
Tolerances: sample counts equal; validation loss within 1e-4 and
accuracy within 1e-3 (float32 summation order through 8 AdamW steps);
final parameters within 1e-4 (measured ~1e-5; parameters move ~1e-2 in
the run, so the check is two orders finer than the training signal).

The framework-free pieces are held bitwise: loader batches, the FedAvg
fold on integer and NaN leaves, and every YAML in the repository.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.data import make_data_loader as jloader
from split_learning_tpu.ops.fedavg import TreeFold as JTreeFold
from split_learning_tpu.ops.fedavg import fedavg_trees as jfedavg
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.data import make_data_loader as tloader
from split_learning_torch.ops.fedavg import TreeFold as TTreeFold
from split_learning_torch.ops.fedavg import fedavg_trees as tfedavg
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 32, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 64,
                     "n_block": 2, "use_flash": True},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 32},
    "aggregation": {"strategy": "fedavg"},
    "learning": {"batch-size": 4, "control-count": 2, "optimizer": "adamw",
                 "learning-rate": 1e-3},
    "checkpoint": {"save": False},
}


def test_round_matches_jax_package(tmp_path):
    d = dict(TINY, **{"log-path": str(tmp_path)})
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
        assert abs(a.val_accuracy - b.val_accuracy) < 1e-3, (a, b)
    final_t = to_jax_params(tres.params, tctx.full_model)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(final_t))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], leaf, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("train,distribution,seed", [
    (True, [8, 8, 8, 8, 8, 8, 8, 8, 8, 8], 3),
    (True, [0, 5, 0, 7, 0, 0, 0, 0, 0, 1], 11),
    (False, None, 0),
])
def test_loader_batches_are_byte_equal(train, distribution, seed):
    kw = dict(train=train, seed=seed, synthetic_size=64,
              dataset_kwargs={"vocab": 128},
              distribution=(None if distribution is None
                            else np.asarray(distribution)))
    a = jloader("TINYSTORIES", 4, **kw)
    b = tloader("TINYSTORIES", 4, **kw)
    assert len(a) == len(b) and a.samples_per_epoch == b.samples_per_epoch
    for _ in range(2):   # two epochs: the shuffle state advances alike
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            assert xa.tobytes() == xb.tobytes()
            assert ya.tobytes() == yb.tobytes()


def _trees(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        f = rng.standard_normal((5, 7)).astype(np.float32)
        f[rng.random(f.shape) < 0.2] = np.nan
        if i == 1:
            f[0, 0] = np.inf
        out.append({
            "layer1": {"weight": f,
                       "count": rng.integers(-50, 50, (4,)).astype(np.int32)},
            "layer2": {"flag": rng.random(6) < 0.5},
        })
    out[2].pop("layer2")   # key union: absent contributors still dilute
    return out


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _assert_bitwise(jt, tt):
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jt))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tt)))
    assert len(flat_j) == len(flat_t)
    for path, a in flat_j:
        b = flat_t[path]
        assert a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("weights", [None, [3.0, 5.0, 17.0], [1, 128, 7]])
def test_fedavg_trees_bit_identical(weights):
    trees = _trees(0)
    _assert_bitwise(jfedavg(trees, weights),
                    tfedavg([_to_torch(t) for t in trees], weights))


def test_tree_fold_bit_identical():
    trees, weights = _trees(1), [7, 2, 30]
    jf, tf = JTreeFold(), TTreeFold()
    for t, w in zip(trees, weights):
        jf.add(t, w)
        tf.add(_to_torch(t), w)
    _assert_bitwise(jf.finalize(), tf.finalize())
    # and the list fold gives the same bits
    _assert_bitwise(jfedavg(trees, weights), tf.finalize())


def _repo_yamls():
    paths = [ROOT / "config.yaml"]
    paths += sorted((ROOT / "configs").glob("*.yaml"))
    paths += sorted((ROOT / "examples").rglob("*.yaml"))
    return paths


@pytest.mark.parametrize("path", _repo_yamls(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_yaml_parses_to_equal_values(path):
    try:
        j = dataclasses.asdict(jcfg.from_yaml(path))
    except jcfg.ConfigError as e:
        with pytest.raises(tcfg.ConfigError, match=str(e)[:40]):
            tcfg.from_yaml(path)
        return
    assert dataclasses.asdict(tcfg.from_yaml(path)) == j


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save/load through the slot + symlink publish, a torn checkpoint
    reads as absent, and a resumed run starts at the saved round."""
    from split_learning_torch.runtime.checkpoint import (
        checkpoint_path, load_checkpoint, save_checkpoint,
    )
    tree = {"layer1": {"weight": torch.arange(6.0).reshape(2, 3)},
            "layer2": {"count": torch.tensor([1, 2], dtype=torch.int32)}}
    save_checkpoint(tmp_path, "M_D", tree, round_idx=1)
    first = checkpoint_path(tmp_path, "M_D").resolve()
    save_checkpoint(tmp_path, "M_D", tree, round_idx=2)
    assert checkpoint_path(tmp_path, "M_D").resolve() != first  # other slot
    ck = load_checkpoint(tmp_path, "M_D")
    assert ck["round_idx"] == 2 and ck["batch_stats"] == {}
    for layer, sd in tree.items():
        for k, t in sd.items():
            assert torch.equal(ck["params"][layer][k], t)
    (checkpoint_path(tmp_path, "M_D") / "state.pt").write_bytes(b"torn")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert load_checkpoint(tmp_path, "M_D") is None

    d = dict(TINY, **{"log-path": str(tmp_path), "global-rounds": 2,
                      "checkpoint": {"save": True, "load": True,
                                     "directory": str(tmp_path / "ck")}})
    tc = tcfg.from_dict(d)
    ctx = TorchContext(tc, device="cpu")
    one = trun(dataclasses.replace(tc, global_rounds=1), ctx,
               tplan(tc, tregs(tc)), TLogger(tmp_path / "a", console=False))
    assert [r.round_idx for r in one.history] == [0]
    saved = load_checkpoint(tmp_path / "ck", tc.model_key)
    assert saved["round_idx"] == 1
    for layer, sd in one.params.items():
        for k, t in sd.items():
            assert torch.equal(saved["params"][layer][k], t)
    resumed = trun(tc, ctx, tplan(tc, tregs(tc)),
                   TLogger(tmp_path / "b", console=False))
    assert [r.round_idx for r in resumed.history] == [1]
    assert load_checkpoint(tmp_path / "ck", tc.model_key)["round_idx"] == 2


@pytest.mark.parametrize("remat", ["all", "none", "wide"])
def test_pipeline_cuts_and_remat_keep_the_gradients(remat):
    """Three stages with the cut hand-off, under each remat policy, give
    the gradients of the unsplit model on the same microbatches."""
    from split_learning_torch.models import build_model
    from split_learning_torch.parallel.pipeline import PipelineModel
    kw = dict(TINY["model-kwargs"], use_flash=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 128, (2, 3, 24)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 128, (2, 3, 24)).astype(np.int32))

    def grads(model):
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    ref = build_model("TinyLlama_TINYSTORIES", **kw)
    for m in range(2):
        (PipelineModel.loss_from_logits(ref(x[m]), y[m]) / 2).backward()
    split = build_model("TinyLlama_TINYSTORIES", **kw)
    pipe = PipelineModel(split, cuts=[1, 3], example_input=x[0],
                         num_microbatches=2, remat=remat)
    assert pipe.n_stages == 3
    assert pipe.stage_remat == [remat == "all"] * 3
    opt = torch.optim.SGD(split.parameters(), lr=0.0)
    pipe.train_step(opt, x, y)
    g_ref, g_split = grads(ref), grads(split)
    assert g_ref.keys() == g_split.keys()
    for n in g_ref:
        torch.testing.assert_close(g_split[n], g_ref[n], rtol=1e-5,
                                   atol=1e-6)


def test_failed_and_exploded_rounds_keep_the_last_good_weights(
        tmp_path, monkeypatch):
    """A NaN round skips aggregation and the checkpoint; an exploded
    validation loss rolls back to the round's input weights."""
    from split_learning_torch.runtime.validation import ValResult
    d = dict(TINY, **{"log-path": str(tmp_path), "global-rounds": 2})
    tc = tcfg.from_dict(d)
    ctx = TorchContext(tc, device="cpu")
    p0 = ctx.init_variables()["params"]

    real_train = TorchContext.train_cluster
    calls = []

    def nan_first_round(self, plan, params, stats, **kw):
        ups = real_train(self, plan, params, stats, **kw)
        calls.append(kw["round_idx"])
        if kw["round_idx"] == 0:
            for u in ups:
                u.ok = False
        return ups

    monkeypatch.setattr(TorchContext, "train_cluster", nan_first_round)
    monkeypatch.setattr(TorchContext, "validate",
                        lambda self, p, s: ValResult(1e9, 0.0, 1))
    res = trun(tc, ctx, tplan(tc, tregs(tc)),
               TLogger(tmp_path / "log", console=False), init_params=p0)
    assert calls == [0, 1]
    assert [(r.ok, r.val_loss) for r in res.history] == [(False, None),
                                                         (False, 1e9)]
    for layer, sd in p0.items():
        for k, t in sd.items():
            assert torch.equal(res.params[layer][k], t), (layer, k)
