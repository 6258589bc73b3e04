"""The port's TinyLlama against the JAX package's, in float32, with the
same weights carried across by ``split_learning_torch.convert``.

Tolerances: logits 2e-5 (float32 matmul/softmax summation order, values
of magnitude ~1), parameter and input gradients 5e-4 (the model-level
flash-vs-dense tolerance of tests/test_flash_attention.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from split_learning_tpu.models import build_model as jax_build
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.models import build_model as torch_build

jllama = importlib.import_module("split_learning_tpu.models.llama")
tllama = importlib.import_module("split_learning_torch.models.llama")

KW = dict(vocab_size=64, hidden_size=32, num_heads=4, num_kv_heads=2,
          intermediate_size=64, n_block=2)
NAME = "TinyLlama_TINYSTORIES"
LOGIT_TOL = 2e-5
GRAD_TOL = 5e-4


def _tokens(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (b, s)).astype(np.int32),
            rng.integers(0, 64, (b, s)).astype(np.int32))


def _jax_params(seed=0):
    x, _ = _tokens(0)
    v = jax_build(NAME, **KW).init(jax.random.key(seed), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _torch_grads(model) -> dict:
    return {name: {k: p.grad for k, p in mod.named_parameters()}
            for name, mod in model.layers.items()}


@pytest.mark.parametrize("use_flash", [False, True])
def test_full_model_logits_and_grads_match(use_flash):
    x, y = _tokens(1)
    params = _jax_params()
    jm = jax_build(NAME, use_flash=use_flash, **KW)

    def loss_j(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (loss_jv, logits_j), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(params)

    tm = torch_build(NAME, use_flash=use_flash, **KW)
    tm.load_state_tree(from_jax_params(params))
    logits_t = tm(torch.from_numpy(x))
    loss_t = F.cross_entropy(logits_t.reshape(-1, 64),
                             torch.from_numpy(y).long().reshape(-1))
    loss_t.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert abs(float(loss_t.detach()) - float(loss_jv)) < LOGIT_TOL
    grads_t = to_jax_params(_torch_grads(tm), tm)
    flat_j = jax.tree_util.tree_leaves_with_path(grads_j)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(grads_t))
    for path, gj in flat_j:
        node = grads_t
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(gj), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(path))


@pytest.mark.parametrize("use_flash", [False, True])
def test_shard_at_a_cut_matches(use_flash):
    """The shard after the cut at layer 2 (block 2, final norm, head) on a
    random hidden state: outputs and the boundary gradient handed back
    across the cut."""
    params = _jax_params()
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jm = jax_build(NAME, start_layer=2, end_layer=-1, use_flash=use_flash,
                   **KW)
    shard = {k: v for k, v in params.items()
             if k in ("layer3", "layer4", "layer5")}

    def f(p, hh):
        return (jm.apply({"params": p}, hh) * w).sum()

    out_j = jm.apply({"params": shard}, jnp.asarray(h))
    gp_j, gh_j = jax.grad(f, argnums=(0, 1))(shard, jnp.asarray(h))

    full = torch_build(NAME, use_flash=use_flash, **KW)
    full.load_state_tree(from_jax_params(params))
    tm = full.shard(2, -1)
    assert sorted(tm.layers) == ["layer3", "layer4", "layer5"]
    ht = torch.from_numpy(h).requires_grad_()
    out_t = tm(ht)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    gp_t = to_jax_params(_torch_grads(tm), tm)
    np.testing.assert_allclose(
        gp_t["layer3"]["attention"]["q_proj"]["kernel"],
        np.asarray(gp_j["layer3"]["attention"]["q_proj"]["kernel"]),
        rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(gp_t["layer5"]["kernel"],
                               np.asarray(gp_j["layer5"]["kernel"]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_converter_round_trip_is_exact():
    params = _jax_params(seed=3)
    state = from_jax_params(params)
    tm = torch_build(NAME, **KW)
    back = to_jax_params(state, tm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(flat_b[path], leaf), path
    # and the other way round, through a freshly initialised port model
    tstate = tm.state_tree()
    again = from_jax_params(to_jax_params(tstate, tm))
    for layer, sd in tstate.items():
        for k, t in sd.items():
            assert torch.equal(again[layer][k], t), (layer, k)


def test_shapes_follow_flax_layouts():
    """Dense kernel (in, out) <-> weight (out, in); Embed and RMSNorm
    keep their shapes."""
    params = _jax_params()
    state = from_jax_params(params)
    assert state["layer1"]["weight"].shape == (64, 32)
    assert state["layer2"]["attention.k_proj.weight"].shape == (16, 32)
    assert params["layer2"]["attention"]["k_proj"]["kernel"].shape == \
        (32, 16)
    assert state["layer4"]["weight"].shape == (32,)
    assert state["layer5"]["weight"].shape == (64, 32)


def test_rope_is_interleaved_like_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(8)
    rj = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos)))
    rt = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-6)


def test_init_distributions_follow_flax():
    """lecun-normal truncated Dense, N(0, 1/features) Embed, ones norm:
    the bits differ from flax, the statistics do not."""
    m = torch_build(NAME, vocab_size=512, hidden_size=256, num_heads=4,
                    num_kv_heads=2, intermediate_size=512, n_block=1,
                    generator=torch.Generator().manual_seed(0))
    q = m.layers["layer2"].attention.q_proj.weight.detach()
    assert abs(float(q.std()) - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    assert float(q.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    e = m.layers["layer1"].weight.detach()
    assert abs(float(e.std()) - (1 / 256) ** 0.5) < 0.05 * (1 / 256) ** 0.5
    assert torch.equal(m.layers["layer3"].weight, torch.ones(256))
