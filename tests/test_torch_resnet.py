"""The port's ResNet50_CIFAR100 against the JAX package's, on the CPU, at
its true widths (23.7 M parameters, 53 BatchNorms: the stem's and 52
nested in the 16 bottleneck layers) on 16 x 16 inputs at batch 2 (the
model is size-agnostic up to its global pool), with the same weights
and statistics carried across by ``split_learning_torch.convert``.

The running statistics start from a random state (means ~N(0, 0.1),
variances in [0.5, 1.5]), so eval mode normalises with statistics the
converter must carry, nested ones included.

Batch-2 BatchNorm training is ill-conditioned in float32: the last
stage normalises 2 x 2 x 2 = 8 values a channel, and the fast variance's
cancellation and 16 residual blocks amplify summation-order noise, so
one float32 step of the JAX package lands up to 0.22 of a layer's
largest gradient away from the same step in float64 (the port's, 0.08).
The train step is therefore held in float64, where the two packages
compute the same function to rounding, and in float32 against that
float64 step.  Tolerances:

* the float32 eval forward at every cut of ``[3, 6]``, ``[4, 12]`` and
  ``[10]``, each shard on the JAX shard's input, and the full model's
  logits: within 2e-4, as ``tests/test_models_northstar.py`` pins the
  JAX package's own cuts (measured 4.8e-6);
* one float64 train step of the full model (both packages in float64):
  logits and loss within 1e-9 (measured 4.7e-13), every parameter
  gradient within 1e-9 of the largest gradient of its layer (measured
  6.7e-13), every new running statistic, nested ones included, within
  1e-12 of its leaf's largest value (measured 3.6e-14) — far inside
  ``tests/test_torch_vgg.py``'s float32 1e-4, 1e-4 and 2e-6;
* the same step in float32: the logits within 5e-4 (measured 3.1e-4;
  the JAX package's own float32 logits are 2.1e-4 from float64), the
  statistics within 1e-4 of their leaf's largest value (measured
  3.1e-5; the JAX package's float32 ones are 2.7e-5 from float64), and
  the gradient tree, in norm, no farther from the float64 step than
  twice the JAX package's float32 gradient tree is, plus 1e-3 (measured
  0.0037 against the JAX package's 0.018);
* the statistics of one pipeline step through the cuts ``[3, 6]`` with
  ``remat`` ``none``, ``wide`` (the width threshold lowered so that
  stages 2 and 3 recompute and stage 1 does not) and ``all``, and of
  stage 2 through the protocol's ``ShardRunner`` (graph-free forward,
  recompute, step): bit for bit those of the full model's float32 step
  above — a recomputed stage keeps its statistics once;
* the bfloat16 eval logits within 3e-2 of the JAX package's (measured
  1.6e-2 on logits up to 3.4), and no farther from float64 than 1.5
  times the JAX package's bfloat16 logits are (measured 0.014 against
  0.017).  ``tests/test_torch_vgg.py`` pins VGG16's at 2e-3; ResNet-50
  rounds 53 convs and 16 residual sums to bf16, and each package's bf16
  logits are 1.4e-2 and 1.7e-2 from float64;
* a converter round trip gives back every leaf bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu.models import split as jsplit
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.parallel.pipeline import PipelineModel
from split_learning_torch.runtime.client import ShardRunner as TRunner

jres = importlib.import_module("split_learning_tpu.models.resnet")
tres = importlib.import_module("split_learning_torch.models.resnet")

NAME = "ResNet50_CIFAR100"
SIDE = 16
FWD_TOL = 2e-4
F64_TOL = 1e-9
F64_STATS_TOL = 1e-12
F32_LOGIT_TOL = 5e-4
F32_STATS_TOL = 1e-4
BF16_TOL = 3e-2


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
    return (rng.standard_normal((b, SIDE, SIDE, 3)).astype(np.float32),
            rng.integers(0, 100, b).astype(np.int32))


def _moved(stats, seed):
    """Every statistic leaf moved off flax's init."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, stats)


@pytest.fixture(scope="module")
def jax_vars():
    x, _ = _batch(0)
    model = jsplit.SplitModel(specs=jres.resnet50_cifar100())
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), x)
    v = jax.tree_util.tree_map(np.asarray, v)
    return v["params"], _moved(v["batch_stats"], 7)


@pytest.fixture(scope="module")
def torch_full():
    return tsplit.SplitModel(tres.resnet50_cifar100())


def _load(model, params, stats):
    model.load_state_tree(from_jax_params(params))
    model.load_stats_tree(from_jax_stats(stats))
    model.zero_grad(set_to_none=True)
    return model


def _shard(tree, start, end):
    return jsplit.shard_params(tree, jres.resnet50_cifar100(), start, end)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _max_of_largest(a_tree, b_tree, per_layer: bool) -> float:
    """The largest difference of two trees' leaves over the largest
    value of its leaf (of its layer, when ``per_layer``)."""
    fa, fb = _leaves(a_tree), _leaves(b_tree)
    assert set(fa) == set(fb)
    scale: dict = {}
    for path, x in fb.items():
        key = path[0].key if per_layer else path
        scale[key] = max(scale.get(key, 0.0), float(np.abs(x).max()))
    return max(float(np.abs(fa[p] - x).max())
               / scale[p[0].key if per_layer else p]
               for p, x in fb.items())


def _norm_err(a_tree, b_tree) -> float:
    fa, fb = _leaves(a_tree), _leaves(b_tree)
    num = sum(float(((fa[p].astype(np.float64) - x) ** 2).sum())
              for p, x in fb.items())
    return (num / sum(float((x.astype(np.float64) ** 2).sum())
                      for x in fb.values())) ** 0.5


def _torch_grads(model) -> dict:
    return to_jax_params(
        {name: {k: p.grad for k, p in mod.named_parameters()}
         for name, mod in model.layers.items()
         if any(True for _ in mod.parameters())}, model)


def test_specs_follow_the_jax_layer_indices():
    for fn_j, fn_t in ((jres.resnet50_cifar100, tres.resnet50_cifar100),
                       (jres.resnet50_cifar10, tres.resnet50_cifar10)):
        sj, st = fn_j(), fn_t()
        assert len(sj) == len(st) == 21
        assert [s.name for s in sj] == [s.name for s in st]
        assert [s.make is None for s in sj] == [s.make is None for s in st]
    assert "ResNet50_CIFAR100" in tsplit.model_registry()


@pytest.mark.parametrize("cuts", [[3, 6], [4, 12], [10]],
                         ids=["3-6", "4-12", "10"])
def test_eval_forward_matches_at_every_cut(jax_vars, torch_full, cuts):
    params, stats = jax_vars
    x, _ = _batch()
    full = _load(torch_full, params, stats)
    bounds = [0] + cuts + [-1]
    h_j = x
    for a, b in zip(bounds[:-1], bounds[1:]):
        m = jsplit.SplitModel(specs=jres.resnet50_cifar100(),
                              start_layer=a, end_layer=b)
        want = np.asarray(jax.jit(m.apply, static_argnames="train")(
            {"params": _shard(params, a, b),
             "batch_stats": _shard(stats, a, b)}, h_j, train=False))
        with torch.no_grad():
            got = full.shard(a, b)(torch.from_numpy(np.array(h_j)),
                                   train=False)
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL,
                                   err_msg=f"shard {a}..{b}")
        h_j = want
    with torch.no_grad():
        logits = full(torch.from_numpy(x), train=False)
    assert logits.shape == (2, 100)
    np.testing.assert_allclose(logits.numpy(), h_j, rtol=0, atol=FWD_TOL)


def _step(fn_specs, dtype):
    """A flax train forward and backward of the full model."""
    model = jsplit.SplitModel(specs=fn_specs(dtype=dtype))

    def loss_fn(p, s, x, y):
        logits, mut = model.apply({"params": p, "batch_stats": s}, x,
                                  train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), (logits, mut["batch_stats"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def steps(jax_vars):
    """One train step of the full model in each package, in float32 and
    in float64: ``{(package, dtype): (loss, logits, gradients, new
    statistics)}`` as numpy trees."""
    params, stats = jax_vars
    x, y = _batch()
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("float64", jnp.float64, torch.float64)):
        with jax.enable_x64(name == "float64"):
            cast = jax.tree_util.tree_map(
                lambda a: np.asarray(a, jdt), (params, stats))
            (loss, (logits, new)), grads = _step(
                jres.resnet50_cifar100, jdt)(*cast, x.astype(jdt), y)
            out["jax", name] = (float(loss), np.asarray(logits),
                                jax.tree_util.tree_map(np.asarray, grads),
                                jax.tree_util.tree_map(np.asarray, new))
        model = _load(tsplit.SplitModel(tres.resnet50_cifar100(dtype=tdt)),
                      params, stats).to(tdt)
        logits = model(torch.from_numpy(x).to(tdt), train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long())
        loss.backward()
        # the forward left the statistics pending: nothing kept yet
        assert torch.equal(model.layers["layer4"].bn1.var.float(),
                           torch.from_numpy(stats["layer4"]["bn1"]["var"]))
        model.commit_stats()
        out["torch", name] = (float(loss.detach()), logits.detach().numpy(),
                              _torch_grads(model),
                              to_jax_stats(model.stats_tree()))
    return out


def test_train_step_matches_in_float64(steps):
    (loss_j, logits_j, grads_j, new_j) = steps["jax", "float64"]
    (loss_t, logits_t, grads_t, new_t) = steps["torch", "float64"]
    assert logits_t.dtype == np.float64
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=F64_TOL)
    assert abs(loss_t - loss_j) <= F64_TOL
    assert len(_leaves(grads_t)) == len(_leaves(grads_j)) == 161
    assert _max_of_largest(grads_t, grads_j, per_layer=True) <= F64_TOL
    assert len(_leaves(new_j)) == 2 * 53
    assert _max_of_largest(new_t, new_j, per_layer=False) <= F64_STATS_TOL


def test_train_step_in_float32_is_as_close_to_float64(steps):
    (_, logits_j, grads_j, new_j) = steps["jax", "float32"]
    (_, logits_t, grads_t, new_t) = steps["torch", "float32"]
    (_, _, grads_64, _) = steps["torch", "float64"]
    np.testing.assert_allclose(logits_t, logits_j, rtol=0,
                               atol=F32_LOGIT_TOL)
    assert _max_of_largest(new_t, new_j, per_layer=False) <= F32_STATS_TOL
    bound = 2 * _norm_err(grads_j, grads_64) + 1e-3
    assert _norm_err(grads_t, grads_64) <= bound


def _clone(tree):
    return {k: {n: t.clone() for n, t in v.items()} for k, v in tree.items()}


def _assert_equal_stats(tree, want):
    flat_w = _leaves(want)
    flat_t = _leaves(to_jax_stats(tree))
    assert set(flat_t) <= set(flat_w) and flat_t
    for path, a in flat_t.items():
        assert a.tobytes() == flat_w[path].tobytes(), path


@pytest.mark.parametrize("remat,recomputed", [
    ("none", [False] * 3), ("wide", [False, True, True]),
    ("all", [True] * 3)])
def test_statistics_kept_once_under_every_remat_policy(
        jax_vars, steps, torch_full, monkeypatch, remat, recomputed):
    params, stats = jax_vars
    model = _load(torch_full, params, stats)
    model.train()
    x, y = _batch()
    x, y = torch.from_numpy(x)[None], torch.from_numpy(y)[None]
    # 16 x 16 inputs: the boundaries are 16384 (cut 3) and 65536 (cut 6)
    # values a sample; lowered, "wide" recomputes stages 2 and 3
    monkeypatch.setattr(PipelineModel, "REMAT_WIDE_THRESHOLD", 16384)
    pipe = PipelineModel(model, [3, 6], example_input=x[0],
                         num_microbatches=1, remat=remat)
    assert pipe.stage_remat == recomputed
    pipe.accumulate(x, y)
    _assert_equal_stats(_clone(model.stats_tree()),
                        steps["torch", "float32"][3])


def test_shard_runner_keeps_nested_statistics_once(jax_vars, steps,
                                                   torch_full):
    """Stage 2 of ``[3, 6]`` through the protocol's ``ShardRunner``: a
    graph-free forward, a second one of the same batch, the recompute
    in the backward, the step — the statistics of one update."""
    params, stats = jax_vars
    x, _ = _batch()
    full = _load(torch_full, params, stats)
    with torch.no_grad():
        h = full.shard(0, 3)(torch.from_numpy(x), train=True)
    runner = TRunner(NAME, 3, 6, {"optimizer": "sgd"}, {}, "cpu")
    runner.load(from_jax_params(_shard(params, 3, 6)),
                from_jax_stats(_shard(stats, 3, 6)))
    out, rng = runner.fwd(h)
    runner.fwd(h)
    assert torch.equal(runner.model.layers["layer5"].bn2.var,
                       torch.from_numpy(stats["layer5"]["bn2"]["var"]))
    runner.bwd(h, torch.ones_like(out), rng)
    runner.apply_update()
    assert set(runner.stats_tree()) == {"layer4", "layer5", "layer6"}
    _assert_equal_stats(runner.stats_tree(), steps["torch", "float32"][3])


def test_bf16_eval_forward_matches(jax_vars):
    params, stats = jax_vars
    x, _ = _batch()
    jm = jsplit.SplitModel(specs=jres.resnet50_cifar100(dtype=jnp.bfloat16))
    out_j = jax.jit(jm.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, x, train=False)
    outs = {}
    for dt in (torch.bfloat16, torch.float64):
        model = _load(tsplit.SplitModel(tres.resnet50_cifar100(dtype=dt)),
                      params, stats)
        with torch.no_grad():
            outs[dt] = model.to(torch.float64 if dt == torch.float64
                                else torch.float32)(
                torch.from_numpy(x).to(dt), train=False)
    assert outs[torch.bfloat16].dtype == torch.bfloat16
    assert out_j.dtype == jnp.bfloat16
    got = outs[torch.bfloat16].double().numpy()
    want = np.asarray(out_j, np.float64)
    ref = outs[torch.float64].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
    assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max()


def test_converter_round_trip_is_exact(jax_vars, torch_full):
    params, stats = jax_vars
    model = _load(torch_full, params, stats)
    tp, ts = from_jax_params(params), from_jax_stats(stats)
    # a bias-free conv, a nested BatchNorm's parameters and statistics
    assert set(tp["layer1"]) == {"weight"}
    assert tp["layer4"]["conv2.weight"].shape == (64, 64, 3, 3)
    assert {"bn1.weight", "bn1.bias", "proj.weight",
            "proj_bn.weight"} <= set(tp["layer4"])
    assert set(ts["layer2"]) == {"mean", "var"}
    assert set(ts["layer5"]) == {f"bn{i}.{k}" for i in (1, 2, 3)
                                 for k in ("mean", "var")}
    back_p = to_jax_params(model.state_tree(), model)
    back_s = to_jax_stats(model.stats_tree())
    for orig, back in ((params, back_p), (stats, back_s)):
        fo, fb = _leaves(orig), _leaves(back)
        assert set(fo) == set(fb)
        for path, leaf in fo.items():
            assert fb[path].dtype == leaf.dtype, path
            assert fb[path].tobytes() == leaf.tobytes(), path


def test_own_initialisation_follows_flax():
    """The port's own draws: lecun-normal convs of the right fan-in, the
    BatchNorms at ones and zeros with flax's initial statistics."""
    model = tsplit.SplitModel(tres.resnet50_cifar100(),
                              generator=torch.Generator().manual_seed(0))
    w = model.layers["layer19"].conv2.weight
    assert w.shape == (512, 512, 3, 3)
    assert abs(float(w.std()) - (1 / (512 * 9)) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / (512 * 9)) ** 0.5 / 0.8796 + 1e-6
    bn = model.layers["layer4"].proj_bn
    assert torch.equal(bn.weight, torch.ones(256))
    assert torch.equal(bn.var, torch.ones(256))
