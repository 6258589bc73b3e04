"""The port's ViT_S16_CIFAR10 against the JAX package's, on the CPU, at
the full ViT-S geometry (384 wide, 6 heads, MLP 1536, patch 4 on 32 x 32
images: 65 tokens) cut to ``n_block=2`` through the spec function's
kwargs (8 layers: patch conv, flatten, CLS token, position embedding,
the two pre-LN blocks, CLS LayerNorm, head), batch 2, with the same
weights carried across by ``split_learning_torch.convert``.  Dropout is
pinned off (``dropout_rate=0.0``) in the parity checks: the random
streams cannot match across frameworks.

Tolerances (XLA:CPU and oneDNN sum in different orders):

* the float32 eval forward at the cuts ``[4]`` and ``[5]`` (each shard
  on the JAX shard's input) and the full model's logits within 2e-4, as
  ``tests/test_models_northstar.py`` pins the JAX package's own cuts
  (measured 2.1e-6);
* one float32 train step: the logits and the loss within 1e-4 and every
  parameter gradient within 1e-4 of the largest gradient of its layer,
  as ``tests/test_torch_vgg.py`` pins (measured 8.3e-7, 0 and 6.7e-7);
* the bfloat16 eval logits within 2e-2 of the JAX package's (measured
  7.8e-3 on logits up to 1.2), and no farther from float64 than 1.5
  times the JAX package's bfloat16 logits are (measured 1.26e-2 against
  1.07e-2).  ``tests/test_torch_vgg.py`` pins VGG16's at 2e-3; here
  every LayerNorm, projection, softmax and residual sum of two blocks
  rounds to bf16 (the softmax in bf16, as flax's), and each package's
  bf16 logits are about 1e-2 from float64;
* a converter round trip gives back every leaf bit for bit: the
  attention's 3-D ``DenseGeneral`` kernels, LayerNorm ``scale``, ``cls``
  and ``pos``.

Without the parity pin, the ViT's dropout (rate 0.1, inside each block)
is replayed by a recomputed stage: a pipeline step with every stage
recomputed equals the stored one bit for bit.
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
from split_learning_torch.parallel.pipeline import PipelineModel

jvit = importlib.import_module("split_learning_tpu.models.vit")
tvit = importlib.import_module("split_learning_torch.models.vit")

KW = {"n_block": 2, "dropout_rate": 0.0}
FWD_TOL = 2e-4
TRAIN_TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The suite runs its files side by side in several processes on
    one CPU: this file's torch work keeps to two threads, and puts the
    count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=1, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _jax_model(start=0, end=-1, dtype=jnp.float32):
    return jsplit.SplitModel(specs=jvit.vit_s16_cifar10(dtype=dtype, **KW),
                             start_layer=start, end_layer=end)


def _torch_model(dtype=torch.float32, **kw):
    return tsplit.SplitModel(tvit.vit_s16_cifar10(dtype=dtype,
                                                  **{**KW, **kw}))


@pytest.fixture(scope="module")
def params():
    x, _ = _batch(0)
    model = _jax_model()
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), x)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _shard(tree, start, end):
    return jsplit.shard_params(tree, jvit.vit_s16_cifar10(**KW), start, end)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _load(model, params):
    model.load_state_tree(from_jax_params(params))
    model.zero_grad(set_to_none=True)
    return model


def test_specs_follow_the_jax_layer_indices():
    for fn_j, fn_t, kw, n in (
            (jvit.vit_s16_cifar10, tvit.vit_s16_cifar10, {}, 18),
            (jvit.vit_s16_cifar10, tvit.vit_s16_cifar10, KW, 8),
            (jvit.vit_cifar10, tvit.vit_cifar10, {}, 12),
            (jvit.vit_mnist, tvit.vit_mnist, {}, 12)):
        sj, st = fn_j(**kw), fn_t(**kw)
        assert len(sj) == len(st) == n
        assert [s.name for s in sj] == [s.name for s in st]
        assert [s.make is None for s in sj] == [s.make is None for s in st]
    full = tsplit.SplitModel(tvit.vit_s16_cifar10())
    block = full.layers["layer5"]
    assert block.attention.query.weight.shape == (384, 6, 64)
    assert block.attention.out.weight.shape == (6, 64, 384)
    assert block.mlp_in.weight.shape == (1536, 384)
    assert block.drop.rate == 0.1
    assert full.layers["layer4"].pos.shape == (1, 65, 384)


@pytest.mark.parametrize("cut", [4, 5])
def test_eval_forward_matches_at_each_cut(params, cut):
    x, _ = _batch()
    full = _load(_torch_model(), params)
    h_j = np.asarray(jax.jit(_jax_model(0, cut).apply)(
        {"params": _shard(params, 0, cut)}, x))
    out_j = np.asarray(jax.jit(_jax_model(cut, -1).apply)(
        {"params": _shard(params, cut, -1)}, h_j))
    with torch.no_grad():
        h_t = full.shard(0, cut)(torch.from_numpy(x), train=False)
        out_t = full.shard(cut, -1)(torch.from_numpy(h_j), train=False)
        logits = full(torch.from_numpy(x), train=False)
    assert h_t.shape == (2, 65, 384) and logits.shape == (2, 10)
    for got, want in ((h_t, h_j), (out_t, out_j), (logits, out_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL)


def test_train_step_gradients_match(params):
    x, y = _batch()
    model = _jax_model()

    def loss_fn(p):
        logits = model.apply({"params": p}, x, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    full = _load(_torch_model(), params)
    logits = full(torch.from_numpy(x), train=True)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_j), rtol=0, atol=TRAIN_TOL)
    assert abs(float(loss.detach()) - float(loss_j)) <= TRAIN_TOL
    grads_t = to_jax_params(
        {name: {k: p.grad for k, p in mod.named_parameters()}
         for name, mod in full.layers.items()
         if any(True for _ in mod.parameters())}, full)
    fj, ft = _leaves(grads_j), _leaves(grads_t)
    assert set(fj) == set(ft) and len(fj) == 4 + 2 * 16 + 2 + 2
    scale: dict = {}
    for path, a in fj.items():
        scale[path[0].key] = max(scale.get(path[0].key, 0.0),
                                 float(np.abs(a).max()))
    for path, a in fj.items():
        np.testing.assert_allclose(ft[path], a, rtol=0,
                                   atol=GRAD_TOL * scale[path[0].key],
                                   err_msg=str(path))


def test_bf16_eval_forward_matches(params):
    x, _ = _batch()
    out_j = jax.jit(_jax_model(dtype=jnp.bfloat16).apply)(
        {"params": params}, x)
    model = _load(_torch_model(torch.bfloat16), params)
    ref = _load(_torch_model(torch.float64), params).double()
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
        want64 = ref(torch.from_numpy(x).double(), train=False).numpy()
    assert got.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    got, want = got.double().numpy(), np.asarray(out_j, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
    assert np.abs(got - want64).max() <= 1.5 * np.abs(want - want64).max()


def test_layernorm_and_gelu_follow_flax():
    """flax's LayerNorm epsilon (1e-6, not torch's 1e-5) and its
    float32 output for a bf16 input at the default dtype; flax's gelu
    is the tanh approximation."""
    import flax.linen as nn
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8)) * 1e-3).astype(np.float32)
    ln = nn.LayerNorm()
    want = np.asarray(ln.apply(ln.init(jax.random.key(0), x), x))
    got = tsplit.LayerNorm(8)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.allclose(torch.nn.functional.layer_norm(
        torch.from_numpy(x), (8,)).numpy(), want, rtol=0, atol=1e-3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tsplit.LayerNorm(8)(xb).dtype == torch.float32
    assert tsplit.LayerNorm(8, dtype=torch.bfloat16)(xb).dtype == \
        torch.bfloat16
    g = rng.standard_normal(64).astype(np.float32) * 3
    np.testing.assert_allclose(
        tsplit.gelu_fn(None, torch.from_numpy(g), False).numpy(),
        np.asarray(nn.gelu(g)), rtol=0, atol=1e-6)


def test_converter_round_trip_is_exact(params):
    model = _load(_torch_model(), params)
    tp = from_jax_params(params)
    assert tp["layer5"]["attention.query.weight"].shape == (384, 6, 64)
    assert tp["layer5"]["attention.out.weight"].shape == (6, 64, 384)
    assert tp["layer5"]["attention.query.bias"].shape == (6, 64)
    assert set(tp["layer3"]) == {"cls"} and set(tp["layer4"]) == {"pos"}
    assert set(tp["layer7"]) == {"norm.weight", "norm.bias"}
    back = to_jax_params(model.state_tree(), model)
    fo, fb = _leaves(params), _leaves(back)
    assert set(fo) == set(fb)
    for path, leaf in fo.items():
        assert fb[path].dtype == leaf.dtype, path
        assert fb[path].tobytes() == leaf.tobytes(), path


def test_remat_replays_the_nested_dropout():
    """With the blocks' dropout on (0.1, inside each block), a pipeline
    step cut at ``[5]`` with every stage recomputed equals the stored
    one bit for bit, and differs from a step with other masks."""
    model = _torch_model(dropout_rate=0.1)
    init = {k: {n: t.clone() for n, t in v.items()}
            for k, v in model.state_tree().items()}
    x, y = _batch(4, 4)
    x = torch.from_numpy(x).reshape(2, 2, 32, 32, 3)
    y = torch.from_numpy(y).reshape(2, 2)

    def step(remat, seed):
        model.load_state_tree(init)
        model.seed_dropout(seed)
        model.train()
        pipe = PipelineModel(model, [5], example_input=x[0],
                             num_microbatches=2, remat=remat)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        return float(pipe.train_step(opt, x, y)), {
            k: {n: t.clone() for n, t in v.items()}
            for k, v in model.state_tree().items()}

    none, full, other = step("none", 5), step("all", 5), step("none", 6)
    assert none[0] == full[0] and none[0] != other[0]
    for layer, leaves in none[1].items():
        for k, t in leaves.items():
            assert torch.equal(full[1][layer][k], t), (layer, k)
    assert [k for k, _ in model._dropouts()] == ["layer5.drop",
                                                  "layer6.drop"]


def test_own_initialisation_follows_flax():
    """``cls`` and ``pos`` from a standard normal, as flax's
    ``normal(1.0)``; the attention kernels lecun-normal over their
    flattened fan-in."""
    model = tsplit.SplitModel(tvit.vit_s16_cifar10(),
                              generator=torch.Generator().manual_seed(0))
    pos = model.layers["layer4"].pos
    assert abs(float(pos.std()) - 1.0) < 0.02
    out = model.layers["layer5"].attention.out.weight
    assert abs(float(out.std()) - 384 ** -0.5) < 2e-3
