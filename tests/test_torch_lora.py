"""The port's LoRA (``ops/lora.py``, the in-process context's LoRA round)
against the JAX package's, on the CPU, on a tiny BERT (hidden 32, 2
heads, 2 blocks, FFN 64, vocab 128) and KWT at the variants' width.

* The target set equals the JAX package's, name for name and factor
  shape for factor shape (the JAX package's ``a: (in, r)``, ``b: (r,
  out)`` against the port's transposes), on BERT's 15- and 27-layer
  indexings and on KWT: query/key/value/out of every attention, BERT's
  FFN ``intermediate`` and ``output`` (not ``output_norm``) and the
  pooler's ``dense``, KWT's ``mlp_in``/``mlp_out`` — never an
  embedding table, a LayerNorm or the classifier.
* ``lora_merge`` on converted parameters and adapters (with ``b`` drawn
  non-zero, so that every delta counts) equals the JAX package's: in
  float64 within 1e-12 of each leaf's largest value, in float32 within
  1e-6 (measured 0 in both: the same products and sums).  Factoring
  the wrong matrix of the ``out`` projection (its heads on the output
  side) fails the target-set test.
* A round of zero steps returns the base weights bit for bit (``b`` is
  zeros, so the merge adds exactly 0).
* One LoRA pipeline step (float32, AdamW lr 1e-2, cut ``[2]``, two
  microbatches) against the JAX package's merged-apply step with the
  same adapters: the loss within 1e-6 (measured 1.2e-7), every trained
  adapter and the classifier within 1e-5 (measured 8.9e-8; AdamW's
  first step is ``lr * sign``-like, so an absolute bound well under the
  1e-2 step catches any missing or doubled update), frozen leaves bit
  for bit.
* One in-process LoRA round at ``[2, 2]`` (two lockstep columns, float32,
  AdamW) through both packages' ``run_training`` with the JAX package's
  adapters injected: samples equal, validation loss within 1e-4
  (measured 6.6e-7), the FedAvg'd merged parameters within 1e-4
  (measured 1.0e-5) and their change from the start within 1e-2 of its
  norm (measured 2.7e-4); the frozen word embeddings come back as they
  went in.
"""

import importlib
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.ops import lora as jlora
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_lora, from_jax_params, to_jax_lora, to_jax_params,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.models import build_model
from split_learning_torch.ops import lora as tlora
from split_learning_torch.parallel.pipeline import PipelineModel
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime import context as tcontext
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan

jbert = importlib.import_module("split_learning_tpu.models.bert")
tbert = importlib.import_module("split_learning_torch.models.bert")
jkwt = importlib.import_module("split_learning_tpu.models.kwt")
tkwt = importlib.import_module("split_learning_torch.models.kwt")

BERT_KW = {"vocab_size": 128, "hidden_size": 32, "num_heads": 2,
           "intermediate_size": 64, "n_block": 2, "dropout_rate": 0.0,
           "max_position_embeddings": 128}
KWT_KW = {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32,
          "dropout_rate": 0.0}
#: (label, JAX spec fn, port spec fn, kwargs, example input)
MODELS = (
    ("bert", jbert.bert_agnews, tbert.bert_agnews, BERT_KW,
     np.full((2, 16), 7, np.int32)),
    ("bert_fine", jbert.bert_emotion, tbert.bert_emotion,
     {**BERT_KW, "fine_grained": True}, np.full((2, 16), 7, np.int32)),
    ("kwt", jkwt.kwt_speechcommands, tkwt.kwt_speechcommands, KWT_KW,
     np.zeros((2, 40, 98), np.float32)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(fn_j, kw, x):
    jm = jsplit.SplitModel(specs=fn_j(**kw))
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(0), x)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _paths(tree):
    return {tuple(getattr(p, "key", p) for p in path): np.shape(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("model", MODELS, ids=[m[0] for m in MODELS])
def test_target_set_equals_the_jax_packages(model):
    label, fn_j, fn_t, kw, x = model
    params = _init(fn_j, kw, x)
    j = jlora.lora_init(jax.random.key(1), params, rank=4)
    tm = tsplit.SplitModel(fn_t(**kw))
    t = tlora.lora_init(torch.Generator().manual_seed(1),
                        from_jax_params(params), tm, rank=4)
    want, got = _paths(j), _paths(to_jax_lora(t))
    assert got == want
    names = {p[-3] for p in want}
    if label.startswith("bert"):
        assert names == {"query", "key", "value", "out", "intermediate",
                         "output", "dense"}
        # the out projection: heads on the input side, (2*16, r) x (r, 32)
        assert want["layer2", "attention", "out", "kernel", "a"] == (32, 4)
        assert want["layer2", "attention", "query", "kernel", "b"] == (4,
                                                                      32)
    else:
        assert names == {"query", "key", "value", "out", "mlp_in",
                         "mlp_out"}
    assert tlora.lora_param_count(t) == sum(
        int(np.prod(s)) for s in want.values())
    for entries in t.values():
        for entry in entries.values():
            assert not entry["b"].any()
            assert abs(float(entry["a"].std()) * 4 - 1.0) < 0.3


def _random_adapters(params, seed):
    """The JAX package's adapter tree with ``b`` drawn too, so every
    delta is non-zero."""
    tree = jlora.lora_init(jax.random.key(seed), params, rank=4)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape)
                   * 0.1).astype(np.float32), tree)


@pytest.mark.parametrize("model", MODELS[::2], ids=["bert", "kwt"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_merge_matches_the_jax_packages(model, dtype, tol):
    label, fn_j, fn_t, kw, x = model
    params = _init(fn_j, kw, x)
    lora = _random_adapters(params, 3)
    with jax.enable_x64(dtype == "float64"):
        cast = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                      (params, lora))
        want = jax.tree_util.tree_map(np.asarray, jlora.lora_merge(
            *cast, alpha=16.0, rank=4))
    tm = tsplit.SplitModel(fn_t(**kw))
    tdt = getattr(torch, dtype)
    tp = {k: {n: t.to(tdt) for n, t in v.items()}
          for k, v in from_jax_params(params).items()}
    tl = {k: {n: {f: t.to(tdt) for f, t in e.items()}
              for n, e in v.items()} for k, v in from_jax_lora(lora).items()}
    got = to_jax_params(tlora.lora_merge(tp, tl, alpha=16.0, rank=4), tm)
    fw = dict(jax.tree_util.tree_leaves_with_path(want))
    fg = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(fw) == set(fg)
    for path, w in fw.items():
        assert fg[path].dtype == w.dtype, path
        np.testing.assert_allclose(fg[path], w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))


def test_zero_step_round_returns_the_base_bit_for_bit(tmp_path):
    cfg = tcfg.from_dict(_round_cfg(tmp_path, [1, 1]))
    ctx = TorchContext(cfg, device="cpu")
    plan = tplan(cfg, tregs(cfg))[0]
    base = ctx.init_variables()["params"]
    ups = ctx.train_cluster(plan, base, {}, epochs=0)
    merged = {}
    for u in ups:
        merged.update(u.params)
    assert set(merged) == set(base)
    for layer, sd in base.items():
        for k, t in sd.items():
            assert torch.equal(merged[layer][k], t), (layer, k)
    # the adapters were there: the target kernels went through the merge
    assert ctx._lora_init and "layer2" in ctx._lora_init


def test_lora_pipeline_step_matches_the_jax_packages():
    """One AdamW step on the merged model, differentiated in the
    adapters and the classifier only."""
    ids = np.random.default_rng(0).integers(1, 128, (2, 2, 16)).astype(
        np.int32)
    ids[:, 1, 6:] = 0
    y = np.array([[0, 3], [1, 2]], np.int32)
    params = _init(jbert.bert_agnews, BERT_KW, ids[0])
    frozen_j, head_j = jlora.split_frozen(params, ["layer5"])
    lora_j = jlora.lora_init(jax.random.key(4), frozen_j, rank=8)
    jm = jsplit.SplitModel(specs=jbert.bert_agnews(**BERT_KW))

    def loss_fn(t):
        merged = jlora.lora_merge({**frozen_j, **t["head"]}, t["lora"],
                                  alpha=16.0, rank=8)
        tot = 0.0
        for m in range(2):
            logits = jm.apply({"params": merged}, ids[m], train=True)
            tot = tot + optax.softmax_cross_entropy_with_integer_labels(
                logits, y[m]).mean()
        return tot / 2
    t0 = {"lora": lora_j, "head": head_j}
    opt = optax.adamw(1e-2, weight_decay=1e-4)
    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(t0)
    upd, _ = opt.update(g, opt.init(t0), t0)
    t1 = jax.tree_util.tree_map(np.asarray, optax.apply_updates(t0, upd))

    tm = build_model("BERT_AGNEWS", **BERT_KW)
    tm.load_state_tree(from_jax_params(params))
    tm.train()
    adapters = {k: {n: {f: t.requires_grad_() for f, t in e.items()}
                    for n, e in v.items()}
                for k, v in from_jax_lora(lora_j).items()}
    for name, mod in tm.layers.items():
        mod.requires_grad_(name == "layer5")
    pipe = PipelineModel(tm, [2], example_input=torch.from_numpy(ids[0]),
                         num_microbatches=2)
    pipe.lora = (adapters, 16.0, 8)
    trained = tlora.lora_tensors(adapters) + list(
        tm.layers["layer5"].parameters())
    opt_t = torch.optim.AdamW(trained, lr=1e-2, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4)
    base = {k: {n: t.clone() for n, t in v.items()}
            for k, v in tm.state_tree().items()}
    loss_t = pipe.train_step(opt_t, torch.from_numpy(ids),
                             torch.from_numpy(y))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6
    got = to_jax_lora(adapters)
    fw = dict(jax.tree_util.tree_leaves_with_path(t1["lora"]))
    fg = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(fw) == set(fg)
    for path, w in fw.items():
        np.testing.assert_allclose(fg[path], w, rtol=0, atol=1e-5,
                                   err_msg=str(path))
        if path[-1].key == "b":   # every b left zero on the first step
            assert np.abs(w).min() > 0, path
    head = to_jax_params({"layer5": tm.state_tree()["layer5"]}, tm)
    for path, w in jax.tree_util.tree_leaves_with_path(t1["head"]):
        np.testing.assert_allclose(
            dict(jax.tree_util.tree_leaves_with_path(head))[path], w,
            rtol=0, atol=1e-5)
    for layer, sd in tm.state_tree().items():
        if layer != "layer5":
            for k, t in sd.items():
                assert torch.equal(t, base[layer][k]), (layer, k)


def _round_cfg(tmp_path, clients):
    return {
        "model": "BERT", "dataset": "AGNEWS", "clients": clients,
        "global-rounds": 1, "synthetic-size": 32, "val-max-batches": 2,
        "val-batch-size": 4, "compute-dtype": "float32",
        "model-kwargs": BERT_KW, "topology": {"cut-layers": [2]},
        "distribution": {"num-samples": 8},
        "learning": {"batch-size": 4, "control-count": 2,
                     "optimizer": "adamw", "learning-rate": 1e-3,
                     "lora-rank": 8, "lora-alpha": 16},
        "checkpoint": {"save": False}, "log-path": str(tmp_path)}


def test_lora_round_matches_the_jax_packages(tmp_path, monkeypatch):
    d = _round_cfg(tmp_path, [2, 2])
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    jctx = MeshContext(jc)
    p0 = jax.tree_util.tree_map(np.asarray, jctx.init_variables()["params"])
    drawn = []
    real_init = jlora.lora_init

    def spy(*a, **kw):
        drawn.append(real_init(*a, **kw))
        return drawn[-1]
    monkeypatch.setattr(jlora, "lora_init", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = jrun(jc, jctx, jplan(jc, jregs(jc)),
                    JLogger(tmp_path / "jax", console=False),
                    init_params=p0)
    assert len(drawn) == 1
    injected = from_jax_lora(jax.tree_util.tree_map(np.asarray, drawn[0]))
    monkeypatch.setattr(tcontext, "lora_init", lambda *a, **kw: {
        k: {n: {f: t.clone() for f, t in e.items()} for n, e in v.items()}
        for k, v in injected.items()})
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplan(tc, tregs(tc)),
                TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0))
    (a,), (b,) = jres.history, tres.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 16
    assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(tres.params, tctx.full_model)))
    num = den = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jres.params)):
        np.testing.assert_allclose(final_t[path], w, rtol=0, atol=1e-4,
                                   err_msg=str(path))
        start = dict(jax.tree_util.tree_leaves_with_path(p0))[path]
        num += float(((final_t[path] - w) ** 2).sum())
        den += float(((w - start) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-2
    # frozen leaves came back as they went in
    np.testing.assert_array_equal(
        final_t[tuple(jax.tree_util.DictKey(k) for k in (
            "layer1", "word_embeddings", "embedding"))],
        p0["layer1"]["word_embeddings"]["embedding"])
