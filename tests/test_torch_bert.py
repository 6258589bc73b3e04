"""The port's BERT (``BERT_AGNEWS``, and ``BERT_EMOTION`` at the
fine-grained 27-layer indexing) against the JAX package's, on the CPU,
at hidden 32, 2 heads, 2 blocks, FFN 64, vocab 128, sequence 16, with
the same weights carried across by ``split_learning_torch.convert``.
The batch has padded rows: one without padding, one padded after five
tokens, one all padding but its CLS token, and one all padding (every
key masked: flax fills masked logits with ``finfo(dtype).min``, so that
row's attention is uniform, not NaN).  Dropout is off
(``dropout_rate=0.0``): the random streams cannot match across
frameworks.

Tolerances:

* float64 (both packages; ``jax.enable_x64`` around the JAX side): each
  layer's output on the JAX layer's input, the whole model's logits and
  loss within 1e-12, and every gradient within 1e-12 of the largest
  gradient of its layer;
* float32: the logits and loss within 1e-5 (measured 6.0e-7 and 0),
  and every gradient within 1e-4 of the largest gradient of its layer
  (the tolerance of ``tests/test_torch_vit.py``; measured 9.5e-7);
  float64 measured 1.8e-15 and 1.3e-15;
* the converter's round trip is exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu.models import split as jsplit
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.models import split as tsplit

jbert = importlib.import_module("split_learning_tpu.models.bert")
tbert = importlib.import_module("split_learning_torch.models.bert")

KW = {"vocab_size": 128, "hidden_size": 32, "num_heads": 2,
      "intermediate_size": 64, "n_block": 2, "dropout_rate": 0.0}
F64_TOL = 1e-12
F32_TOL = 1e-5
F32_GRAD_TOL = 1e-4
#: (label, JAX spec function, port spec function, kwargs, layers)
MODELS = (("agnews", jbert.bert_agnews, tbert.bert_agnews, KW, 5),
          ("emotion_fine", jbert.bert_emotion, tbert.bert_emotion,
           {**KW, "fine_grained": True}, 7))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=1, n_labels=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, size=(4, 16)).astype(np.int32)
    ids[:, 0] = 101
    ids[1, 5:] = 0          # padded after five tokens
    ids[2, 1:] = 0          # all padding but CLS
    ids[3, :] = 0           # every key masked
    return ids, rng.integers(0, n_labels, 4).astype(np.int32)


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def model(request):
    label, fn_j, fn_t, kw, n = request.param
    ids, _ = _batch()
    jm = jsplit.SplitModel(specs=fn_j(**kw))
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(0), ids)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return label, fn_j, fn_t, kw, n, params


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _torch_model(fn_t, kw, params, dtype):
    m = tsplit.SplitModel(fn_t(dtype=dtype, **kw))
    m.load_state_tree(from_jax_params(params))
    return m.to(dtype)


def _max_of_largest(got, want) -> float:
    """Largest difference of a leaf, over the largest value of its
    layer, across the tree."""
    fg, fw = _leaves(got), _leaves(want)
    assert set(fg) == set(fw)
    scale: dict = {}
    for path, a in fw.items():
        scale[path[0].key] = max(scale.get(path[0].key, 0.0),
                                 float(np.abs(a).max()))
    return max(float(np.abs(fg[p] - a).max()) / max(scale[p[0].key], 1e-30)
               for p, a in fw.items())


def _torch_grads(model):
    return to_jax_params(
        {name: {k: p.grad for k, p in mod.named_parameters()}
         for name, mod in model.layers.items()
         if any(True for _ in mod.parameters())}, model)


def test_specs_follow_the_jax_layer_indices():
    for fn_j, fn_t, kw, n in (
            (jbert.bert_agnews, tbert.bert_agnews, {}, 15),
            (jbert.bert_emotion, tbert.bert_emotion, {}, 15),
            (jbert.bert_emotion, tbert.bert_emotion,
             {"fine_grained": True}, 27),
            (jbert.bert_agnews, tbert.bert_agnews, KW, 5)):
        sj, st = fn_j(**kw), fn_t(**kw)
        assert len(sj) == len(st) == n
        assert [s.name for s in sj] == [s.name for s in st]
    full = tsplit.SplitModel(tbert.bert_agnews(), device="meta")
    emb = full.layers["layer1"]
    assert emb.word_embeddings.weight.shape == (28996, 768)
    assert emb.position_embeddings.weight.shape == (512, 768)
    assert emb.LayerNorm.eps == 1e-12
    block = full.layers["layer2"]
    assert block.attention.query.weight.shape == (768, 12, 64)
    assert block.attention.out.weight.shape == (12, 64, 768)
    assert block.intermediate.weight.shape == (3072, 768)
    assert block.output_norm.eps == 1e-12
    assert full.layers["layer15"].classifier.weight.shape == (4, 768)
    assert sum(p.numel() for p in full.parameters()) == 108313348


def test_forward_matches_layer_by_layer_in_float64(model):
    label, fn_j, fn_t, kw, n, params = model
    ids, _ = _batch()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        specs = fn_j(dtype=jnp.float64, **kw)
        tm = _torch_model(fn_t, kw, params, torch.float64)
        h_j, h_t = ids, torch.from_numpy(ids)
        for i in range(1, n + 1):
            shard = jsplit.SplitModel(specs=specs, start_layer=i - 1,
                                      end_layer=i)
            want = jax.jit(shard.apply)(
                {"params": jsplit.shard_params(p64, specs, i - 1, i)}, h_j)
            with torch.no_grad():
                got = tm.shard(i - 1, i)(h_t, train=False)
            flat_w = jax.tree_util.tree_leaves(want)
            flat_g = got if isinstance(got, tuple) else (got,)
            assert len(flat_w) == len(flat_g) == (2 if i < n - 1 else 1)
            for g, w in zip(flat_g, flat_w):
                w = np.asarray(w)
                assert g.dtype == (torch.bool if w.dtype == bool
                                   else torch.float64), (i, g.dtype)
                assert np.isfinite(g.double().numpy()).all(), i
                np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                           atol=F64_TOL,
                                           err_msg=f"{label} layer{i}")
            h_j = want
            h_t = tuple(torch.from_numpy(np.array(w)) for w in flat_w) \
                if len(flat_w) == 2 else torch.from_numpy(np.array(
                    flat_w[0]))
    # the mask crossed every cut: row 3 masks every key, row 2 all but CLS
    assert not h_t.isnan().any()


def _steps(fn_j, fn_t, kw, params, n_labels):
    """One train forward + backward of the whole model in each package,
    in float32 and float64: ``{(package, dtype): (loss, logits,
    gradients)}``."""
    ids, y = _batch(n_labels=n_labels)
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("float64", jnp.float64, torch.float64)):
        with jax.enable_x64(name == "float64"):
            jm = jsplit.SplitModel(specs=fn_j(dtype=jdt, **kw))
            cast = jax.tree_util.tree_map(lambda a: np.asarray(a, jdt),
                                          params)

            def loss_fn(p):
                logits = jm.apply({"params": p}, ids, train=True)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean(), logits
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(cast)
            out["jax", name] = (float(loss), np.asarray(logits),
                                jax.tree_util.tree_map(np.asarray, grads))
        tm = _torch_model(fn_t, kw, params, tdt)
        logits = tm(torch.from_numpy(ids), train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long())
        loss.backward()
        out["torch", name] = (float(loss.detach()),
                              logits.detach().numpy(), _torch_grads(tm))
    return out


@pytest.fixture(scope="module")
def steps(model):
    label, fn_j, fn_t, kw, n, params = model
    return _steps(fn_j, fn_t, kw, params, 4 if label == "agnews" else 6)


def test_train_step_matches_in_float64(steps):
    loss_j, logits_j, grads_j = steps["jax", "float64"]
    loss_t, logits_t, grads_t = steps["torch", "float64"]
    assert logits_t.dtype == np.float64
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=F64_TOL)
    assert abs(loss_t - loss_j) <= F64_TOL
    assert _max_of_largest(grads_t, grads_j) <= F64_TOL


def test_train_step_matches_in_float32(steps):
    loss_j, logits_j, grads_j = steps["jax", "float32"]
    loss_t, logits_t, grads_t = steps["torch", "float32"]
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=F32_TOL)
    assert abs(loss_t - loss_j) <= F32_TOL
    assert _max_of_largest(grads_t, grads_j) <= F32_GRAD_TOL


def test_all_padding_row_is_uniform_not_nan():
    """Masked logits are ``finfo(dtype).min`` in the compute dtype: a row
    whose keys are all masked attends uniformly, in float32 and bf16."""
    from split_learning_torch.models.transformer import SelfAttention
    for dtype in (torch.float32, torch.bfloat16):
        attn = SelfAttention(8, 2, dtype=dtype,
                             generator=torch.Generator().manual_seed(0))
        x = torch.randn(1, 4, 8)
        mask = torch.zeros(1, 1, 1, 4, dtype=torch.bool)
        with torch.no_grad():
            got = attn(x, mask=mask)
            v = attn.value(x)
            want = attn.out(v.mean(dim=1, keepdim=True).expand_as(v))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2
                                   if dtype == torch.bfloat16 else 1e-6)


def test_converter_round_trip_is_exact(model):
    label, fn_j, fn_t, kw, n, params = model
    tm = _torch_model(fn_t, kw, params, torch.float32)
    tp = from_jax_params(params)
    assert set(tp["layer1"]) == {
        "word_embeddings.weight", "position_embeddings.weight",
        "token_type_embeddings.weight", "LayerNorm.weight",
        "LayerNorm.bias"}
    assert tp["layer2"]["attention.query.weight"].shape == (32, 2, 16)
    assert set(tp[f"layer{n - 1}"]) == {"dense.weight", "dense.bias"}
    assert set(tp[f"layer{n}"]) == {"classifier.weight", "classifier.bias"}
    back = to_jax_params(tm.state_tree(), tm)
    fo, fb = _leaves(params), _leaves(back)
    assert set(fo) == set(fb)
    for path, leaf in fo.items():
        assert fb[path].dtype == leaf.dtype, path
        assert fb[path].tobytes() == leaf.tobytes(), path


@pytest.mark.parametrize("key,cuts,shape,dtype,recomputed", [
    ("BERT_AGNEWS", [4], (2, 128), "int32", [True, True]),
    ("BERT_AGNEWS", [1, 14], (2, 128), "int32", [True, True, False]),
    ("KWT_SPEECHCOMMANDS", [2], (2, 40, 98), "float32", [False, False])])
def test_wide_remat_follows_the_jax_package_at_full_width(
        key, cuts, shape, dtype, recomputed):
    """The ``wide`` policy sums a tuple boundary's leaves, as the JAX
    package's ``_tree_flat_size``: BERT-base's ``(hidden, mask)`` is
    128 * 768 + 128 values a sample, above the 65536 threshold, so its
    stages recompute exactly where the JAX package's do (shapes only:
    the JAX side by ``eval_shape``, the port's on the meta device)."""
    from split_learning_tpu.parallel.pipeline import PipelineModel as JPipe
    from split_learning_torch.models import build_model
    from split_learning_torch.parallel.pipeline import PipelineModel as TPipe
    j = JPipe(key, cuts, jax.ShapeDtypeStruct(shape, jnp.dtype(dtype)),
              num_microbatches=2)
    t = TPipe(build_model(key, device="meta", generator=torch.Generator()),
              cuts, torch.zeros(shape, dtype=getattr(torch, dtype),
                                device="meta"), num_microbatches=2)
    assert t.stage_remat == j.stage_remat == recomputed
