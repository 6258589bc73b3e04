"""The port's KWT_SPEECHCOMMANDS against the JAX package's, on the CPU,
at the variants' width (embed 16, 2 heads, MLP 32; ``examples/variants``)
and the full input (40 x 98 MFCCs, 12 blocks, 17 layers), batch 3, with
the same weights carried across by ``split_learning_torch.convert``.
The position embedding's dropout is off (``dropout_rate=0.0``) in the
parity checks: the random streams cannot match across frameworks.

Tolerances:

* float64 (both packages): each layer's output on the JAX layer's input,
  the logits and the loss within 1e-12, and every gradient within 1e-12
  of the largest gradient of its layer (measured 1.3e-15 and 1.5e-15);
* float32: the logits and loss within 1e-5 (measured 1.1e-6 and
  2.4e-7), every gradient within 1e-4 of the largest gradient of its
  layer (measured 1.1e-6), as ``tests/test_torch_vit.py`` pins the
  pre-LN block;
* the converter's round trip is exact (``cls_token``, ``pos_embed``);
* with the dropout on, a pipeline step with every stage recomputed
  equals the stored one bit for bit.
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

jkwt = importlib.import_module("split_learning_tpu.models.kwt")
tkwt = importlib.import_module("split_learning_torch.models.kwt")

KW = {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32, "dropout_rate": 0.0}
F64_TOL = 1e-12
F32_TOL = 1e-5
F32_GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=1, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 40, 98)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


@pytest.fixture(scope="module")
def params():
    x, _ = _batch()
    jm = jsplit.SplitModel(specs=jkwt.kwt_speechcommands(**KW))
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(0), x)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _torch_model(params, dtype, **kw):
    m = tsplit.SplitModel(tkwt.kwt_speechcommands(dtype=dtype,
                                                  **{**KW, **kw}))
    m.load_state_tree(from_jax_params(params))
    return m.to(dtype)


def _max_of_largest(got, want) -> float:
    fg, fw = _leaves(got), _leaves(want)
    assert set(fg) == set(fw)
    scale: dict = {}
    for path, a in fw.items():
        scale[path[0].key] = max(scale.get(path[0].key, 0.0),
                                 float(np.abs(a).max()))
    return max(float(np.abs(fg[p] - a).max()) / max(scale[p[0].key], 1e-30)
               for p, a in fw.items())


def test_specs_follow_the_jax_layer_indices():
    for kw in ({}, KW):
        sj, st = jkwt.kwt_speechcommands(**kw), tkwt.kwt_speechcommands(**kw)
        assert len(sj) == len(st) == 17
        assert [s.name for s in sj] == [s.name for s in st]
    full = tsplit.SplitModel(tkwt.kwt_speechcommands())
    assert full.layers["layer1"].embed.weight.shape == (64, 40)
    assert full.layers["layer2"].cls_token.shape == (1, 1, 64)
    assert full.layers["layer3"].pos_embed.shape == (1, 99, 64)
    assert full.layers["layer3"].drop.rate == 0.1
    block = full.layers["layer4"]
    assert block.attention.query.weight.shape == (64, 1, 64)
    assert block.mlp_in.weight.shape == (256, 64) and block.drop is None
    assert full.layers["layer16"].eps == 1e-6
    # KWT-1: 607 K parameters; truncated_normal(0.02) CLS and positions
    assert sum(p.numel() for p in full.parameters()) == 609610
    pos = full.layers["layer3"].pos_embed
    assert float(pos.abs().max()) <= 0.04 and 0.015 < float(pos.std()) < 0.02


def test_forward_matches_layer_by_layer_in_float64(params):
    x, _ = _batch()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        specs = jkwt.kwt_speechcommands(dtype=jnp.float64, **KW)
        tm = _torch_model(params, torch.float64)
        h = x.astype(np.float64)
        for i in range(1, 18):
            shard = jsplit.SplitModel(specs=specs, start_layer=i - 1,
                                      end_layer=i)
            want = np.asarray(jax.jit(shard.apply)(
                {"params": jsplit.shard_params(p64, specs, i - 1, i)}, h))
            with torch.no_grad():
                got = tm.shard(i - 1, i)(torch.from_numpy(h), train=False)
            assert got.dtype == torch.float64 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=F64_TOL, err_msg=f"layer{i}")
            h = want
    assert h.shape == (3, 10)


@pytest.fixture(scope="module")
def steps(params):
    x, y = _batch()
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("float64", jnp.float64, torch.float64)):
        with jax.enable_x64(name == "float64"):
            jm = jsplit.SplitModel(specs=jkwt.kwt_speechcommands(
                dtype=jdt, **KW))
            cast = jax.tree_util.tree_map(lambda a: np.asarray(a, jdt),
                                          params)

            def loss_fn(p):
                logits = jm.apply({"params": p}, x.astype(jdt), train=True)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean(), logits
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(cast)
            out["jax", name] = (float(loss), np.asarray(logits),
                                jax.tree_util.tree_map(np.asarray, grads))
        tm = _torch_model(params, tdt)
        logits = tm(torch.from_numpy(x).to(tdt), train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long())
        loss.backward()
        grads = to_jax_params(
            {n: {k: p.grad for k, p in mod.named_parameters()}
             for n, mod in tm.layers.items()}, tm)
        out["torch", name] = (float(loss.detach()),
                              logits.detach().numpy(), grads)
    return out


@pytest.mark.parametrize("dtype,tol,grad_tol", [
    ("float64", F64_TOL, F64_TOL), ("float32", F32_TOL, F32_GRAD_TOL)])
def test_train_step_matches(steps, dtype, tol, grad_tol):
    loss_j, logits_j, grads_j = steps["jax", dtype]
    loss_t, logits_t, grads_t = steps["torch", dtype]
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=tol)
    assert abs(loss_t - loss_j) <= tol
    assert len(_leaves(grads_t)) == 2 + 1 + 1 + 12 * 16 + 2 + 2
    assert _max_of_largest(grads_t, grads_j) <= grad_tol


def test_converter_round_trip_is_exact(params):
    tm = _torch_model(params, torch.float32)
    tp = from_jax_params(params)
    assert set(tp["layer2"]) == {"cls_token"}
    assert set(tp["layer3"]) == {"pos_embed"}
    assert set(tp["layer16"]) == {"weight", "bias"}
    back = to_jax_params(tm.state_tree(), tm)
    fo, fb = _leaves(params), _leaves(back)
    assert set(fo) == set(fb)
    for path, leaf in fo.items():
        assert fb[path].tobytes() == leaf.tobytes(), path


def test_remat_replays_the_position_dropout(params):
    """With the position embedding's dropout on (0.1), a pipeline step
    cut at ``[2]`` with every stage recomputed equals the stored one bit
    for bit, and differs from a step with other masks."""
    model = _torch_model(params, torch.float32, dropout_rate=0.1)
    init = {k: {n: t.clone() for n, t in v.items()}
            for k, v in model.state_tree().items()}
    x, y = _batch(4, 4)
    x = torch.from_numpy(x).reshape(2, 2, 40, 98)
    y = torch.from_numpy(y).reshape(2, 2)

    def step(remat, seed):
        model.load_state_tree(init)
        model.seed_dropout(seed)
        model.train()
        pipe = PipelineModel(model, [2], example_input=x[0],
                             num_microbatches=2, remat=remat)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        return float(pipe.train_step(opt, x, y)), {
            k: {n: t.clone() for n, t in v.items()}
            for k, v in model.state_tree().items()}

    none, full, other = step("none", 5), step("all", 5), step("none", 6)
    assert none[0] == full[0] and none[0] != other[0]
    for layer, leaves in none[1].items():
        for k, t in leaves.items():
            assert torch.equal(full[1][layer][k], t), (layer, k)
    assert [k for k, _ in model._dropouts()] == ["layer3.drop"]
