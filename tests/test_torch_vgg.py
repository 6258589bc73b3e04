"""The port's VGG16_CIFAR10 against the JAX package's, on the CPU, at full
width (33.6 M parameters), batch 4, with the same weights and BatchNorm
statistics carried across by ``split_learning_torch.convert``.

The running statistics start from a random state (means ~N(0, 0.1),
variances in [0.5, 1.5]), so eval mode normalises with statistics that
the converter must carry, not with flax's initial zeros and ones.
Dropout is neutralised in both packages for the train-mode checks (its
random streams cannot match across frameworks): the two Dropout layers
(46 and 49) are swapped for the identity in a copy of each spec list.

Tolerances (float32; XLA:CPU and oneDNN sum in different orders).  Each
shard is held on the JAX shard's own inputs (the JAX cut activation into
stage 2, the JAX cut gradient into stage 1's backward), as the wire
hands them over:

* eval mode: the cut activation (values up to ~5) and the logits within
  1e-5 absolute (measured 2.6e-6);
* train mode: the cut activation (values up to ~5) within 5e-5
  (measured 2.2e-5), the logits (values ~1) and the loss within 1e-4
  (measured 1.5e-5; the last conv block normalises over 4 x 2 x 2 = 16
  values a channel, where the fast variance's cancellation amplifies
  summation-order noise);
* new running statistics after one train forward: ``var`` within rtol
  2e-6 (measured 1.4e-6 at layer 9, the first BatchNorm past the cut:
  flax's fast variance E[x^2] - E[x]^2 amplifies the conv's summation
  noise by mean^2 / var, so 1e-6 is below the float32 noise there).
  The unbiased variance that torch's ``nn.BatchNorm2d`` would keep is
  N/(N-1) times the batch variance; each check also asserts that it
  would land more than three tolerances away at every layer.  ``mean``
  (values ~0.1) within 1e-6 absolute;
* parameter gradients within 1e-4 of the largest gradient of their
  layer (measured 3.2e-5), and the input gradient at the cut within
  1e-6 absolute (measured 6.4e-7);
* bfloat16 eval logits within 2e-3 absolute (measured 4.9e-4; both
  round every conv and dense product to bf16, about 1/256 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu.data import datasets as jdata
from split_learning_tpu.data import make_data_loader as jloader
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.runtime.client import ShardRunner as JRunner
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats,
)
from split_learning_torch.data import datasets as tdata
from split_learning_torch.data import make_data_loader as tloader
from split_learning_torch.models import split as tsplit
from split_learning_torch.parallel.pipeline import PipelineModel
from split_learning_torch.runtime.client import ShardRunner as TRunner

jvgg = importlib.import_module("split_learning_tpu.models.vgg")
tvgg = importlib.import_module("split_learning_torch.models.vgg")

NAME = "VGG16_CIFAR10"
DROPOUTS = ("layer46", "layer49")
CUT = 7
LOGIT_TOL = 1e-5
TRAIN_LOGIT_TOL = 1e-4
CUT_TOL = 5e-5
GRAD_TOL = 1e-4
VAR_RTOL = 2e-6


def no_dropout(specs, split_mod):
    """The spec list with its Dropout layers replaced by the identity."""
    return tuple(split_mod.LayerSpec(s.name, fn=split_mod.identity_fn)
                 if s.name in DROPOUTS else s for s in specs)


def _batch(seed=1, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


@pytest.fixture(scope="module")
def jax_vars():
    """Flax variables from key 0, statistics moved off their init."""
    x, _ = _batch(0)
    model = jsplit.SplitModel(specs=jvgg.vgg16_cifar10())
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), x)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(7)
    stats = {layer: {
        "mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(
            np.float32),
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for layer, s in jax.tree_util.tree_map(
            np.asarray, v["batch_stats"]).items()}
    return params, stats


def _jax_model(start=0, end=-1, dtype=jnp.float32):
    return jsplit.SplitModel(
        specs=no_dropout(jvgg.vgg16_cifar10(dtype=dtype), jsplit),
        start_layer=start, end_layer=end)


@pytest.fixture(scope="module")
def torch_full():
    """The port's float32 model without dropout, built once (its
    parameters and statistics are reloaded by :func:`_load`)."""
    return tsplit.SplitModel(no_dropout(tvgg.vgg16_cifar10(), tsplit))


def _load(model, params, stats):
    model.load_state_tree(from_jax_params(params))
    model.load_stats_tree(from_jax_stats(stats))
    model.zero_grad(set_to_none=True)
    return model


def _shard(tree, start, end):
    specs = jvgg.vgg16_cifar10()
    return jsplit.shard_params(tree, specs, start, end)


def _vars(params, stats, start=0, end=-1):
    return {"params": _shard(params, start, end),
            "batch_stats": _shard(stats, start, end)}


def _assert_stats(new_j, new_t, old, sizes):
    """The new running statistics agree; ``var`` within ``VAR_RTOL``,
    which the unbiased variance (``N/(N-1)`` times the batch variance,
    ``N`` = ``sizes[layer]`` values a channel) misses at every layer."""
    assert set(new_j) == set(new_t) == set(sizes)
    for layer in new_j:
        vj, vt = new_j[layer]["var"], new_t[layer]["var"]
        np.testing.assert_allclose(vt, vj, rtol=VAR_RTOL, atol=0,
                                   err_msg=layer)
        batch = (vj - 0.9 * old[layer]["var"]) / 0.1
        n = sizes[layer]
        unbiased = 0.9 * old[layer]["var"] + 0.1 * batch * n / (n - 1)
        assert np.max(np.abs(unbiased - vj) / vj) > 3 * VAR_RTOL, layer
        np.testing.assert_allclose(new_t[layer]["mean"],
                                   new_j[layer]["mean"], rtol=0, atol=1e-6,
                                   err_msg=layer)


def _bn_sizes(batch, start=0, end=-1):
    """Values a channel of each BatchNorm layer of the shard normalises
    over, for a (batch, 32, 32, 3) model input."""
    out, side = {}, 32
    for i, spec in enumerate(tvgg.vgg16_cifar10(), start=1):
        if spec.fn is tsplit.maxpool2_fn:
            side //= 2
        if spec.fn is tsplit.batchnorm_fn and start < i and (
                end == -1 or i <= end):
            out[spec.name] = batch * side * side
    return out


def _assert_grads(g_j, g_t):
    """Each parameter gradient within ``GRAD_TOL`` of the largest
    gradient of its layer.  A conv bias that feeds a BatchNorm has a zero
    gradient in exact arithmetic (the batch mean is subtracted), so its
    values in either package are rounding noise on that scale."""
    flat_t = dict(jax.tree_util.tree_leaves_with_path(g_t))
    flat_j = jax.tree_util.tree_leaves_with_path(g_j)
    assert len(flat_j) == len(flat_t)
    scale: dict = {}
    for path, gj in flat_j:
        layer = path[0].key
        scale[layer] = max(scale.get(layer, 0.0),
                           float(np.abs(np.asarray(gj)).max()))
    for path, gj in flat_j:
        np.testing.assert_allclose(
            flat_t[path], np.asarray(gj), rtol=0,
            atol=GRAD_TOL * scale[path[0].key], err_msg=str(path))


def _torch_grads(model) -> dict:
    return to_jax_params(
        {name: {k: p.grad for k, p in mod.named_parameters()}
         for name, mod in model.layers.items()
         if any(True for _ in mod.parameters())}, model)


def test_specs_follow_the_jax_layer_indices():
    for fn_j, fn_t, n in ((jvgg.vgg16_cifar10, tvgg.vgg16_cifar10, 52),
                          (jvgg.vgg16_mnist, tvgg.vgg16_mnist, 51),
                          (jvgg.vgg16_cifar100, tvgg.vgg16_cifar100, 52)):
        sj, st = fn_j(), fn_t()
        assert len(sj) == len(st) == n
        assert [s.name for s in sj] == [s.name for s in st]
        assert [s.make is None for s in sj] == [s.make is None for s in st]


def test_eval_forward_and_each_shard_match(jax_vars, torch_full):
    params, stats = jax_vars
    x, _ = _batch()
    # the JAX shards of the cut-7 split; the full model is their chain
    h_j = np.asarray(jax.jit(_jax_model(0, CUT).apply,
                             static_argnames="train")(
        _vars(params, stats, 0, CUT), x, train=False))
    out_j = np.asarray(jax.jit(_jax_model(CUT, -1).apply,
                               static_argnames="train")(
        _vars(params, stats, CUT, -1), h_j, train=False))
    full = _load(torch_full, params, stats)
    with torch.no_grad():
        h_t = full.shard(0, CUT)(torch.from_numpy(x), train=False)
        out_t = full.shard(CUT, -1)(torch.from_numpy(h_j), train=False)
        logits_t = full(torch.from_numpy(x), train=False)
    assert h_t.shape == (4, 16, 16, 64) and h_t.is_contiguous()
    assert logits_t.shape == (4, 10)
    for got, want in ((h_t, h_j), (out_t, out_j), (logits_t, out_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGIT_TOL)


def test_train_forward_stats_and_gradients_match(jax_vars, torch_full):
    params, stats = jax_vars
    x, y = _batch()
    j1, j2 = _jax_model(0, CUT), _jax_model(CUT, -1)
    s1, s2 = _shard(stats, 0, CUT), _shard(stats, CUT, -1)

    @jax.jit
    def head(p1, ct):
        out, m1 = j1.apply({"params": p1, "batch_stats": s1}, x,
                           train=True, mutable=["batch_stats"])
        return jnp.vdot(out, ct), (out, m1)

    @jax.jit
    def tail(p2, h):
        logits, m2 = j2.apply({"params": p2, "batch_stats": s2}, h,
                              train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), (logits, m2)

    p1, p2 = _shard(params, 0, CUT), _shard(params, CUT, -1)
    _, (h, m1) = head(p1, jnp.zeros((4, 16, 16, 64)))
    (loss, (logits_j, m2)), (g2, gh) = jax.jit(jax.value_and_grad(
        tail, argnums=(0, 1), has_aux=True))(p2, h)
    g1, _ = jax.jit(jax.grad(head, has_aux=True))(p1, gh)
    new_j = {**m1["batch_stats"], **m2["batch_stats"]}

    # each shard on the JAX shard's inputs: stage 2 on the JAX cut
    # activation, stage 1's backward from the JAX cut gradient — what
    # the wire hands each stage
    full = _load(torch_full, params, stats)
    ht = full.shard(0, CUT)(torch.from_numpy(x), train=True)
    hl = torch.from_numpy(np.array(h)).requires_grad_(True)
    logits_t = full.shard(CUT, -1)(hl, train=True)
    loss_t = torch.nn.functional.cross_entropy(logits_t,
                                               torch.from_numpy(y).long())
    loss_t.backward()
    ht.backward(torch.from_numpy(np.array(gh)))
    full.commit_stats()

    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(h), rtol=0,
                               atol=CUT_TOL)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=0,
                               atol=TRAIN_LOGIT_TOL)
    np.testing.assert_allclose(float(loss_t), float(loss), rtol=0,
                               atol=TRAIN_LOGIT_TOL)
    _assert_stats(jax.tree_util.tree_map(np.asarray, new_j),
                  to_jax_stats(full.stats_tree()), stats, _bn_sizes(4))
    np.testing.assert_allclose(hl.grad.numpy(), np.asarray(gh), rtol=0,
                               atol=1e-6)
    grads_t = _torch_grads(full)
    assert len(jax.tree_util.tree_leaves(grads_t)) == 58
    _assert_grads({**g1, **g2}, grads_t)


def test_bf16_eval_forward_matches(jax_vars):
    params, stats = jax_vars
    x, _ = _batch()
    out_j = jax.jit(_jax_model(dtype=jnp.bfloat16).apply,
                    static_argnames="train")(_vars(params, stats), x,
                                             train=False)
    model = tsplit.SplitModel(tvgg.vgg16_cifar10(dtype=torch.bfloat16))
    with torch.no_grad():
        out_t = _load(model, params, stats)(torch.from_numpy(x),
                                            train=False)
    assert out_t.dtype == torch.bfloat16 and out_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), rtol=0,
                               atol=2e-3)


def test_shard_runner_updates_statistics_once(jax_vars):
    """One batch through ``ShardRunner.fwd``, ``.bwd`` and
    ``.apply_update`` (the protocol's stage 1: a graph-free forward, a
    recompute, the step) keeps the statistics of one update, as one JAX
    ``bwd`` does; the activation and the parameter gradients match
    too."""
    params, stats = jax_vars
    x, _ = _batch(2)
    ct = np.random.default_rng(3).standard_normal(
        (4, 16, 16, 64)).astype(np.float32)
    jr = JRunner(NAME, 0, CUT, learning={"optimizer": "sgd"})
    p1, s1 = _shard(params, 0, CUT), _shard(stats, 0, CUT)
    rng = jax.random.key(0)
    out_j = jr.fwd({}, {"lora": {}, "head": p1}, s1, x, rng)
    gt, _, new_j = jr.bwd({}, {"lora": {}, "head": p1}, s1, x, ct, rng)

    tr = TRunner(NAME, 0, CUT, {"optimizer": "sgd"}, {}, "cpu")
    tr.load(from_jax_params(p1), from_jax_stats(s1))
    before = to_jax_stats(tr.stats_tree())
    out_t, rng_t = tr.fwd(torch.from_numpy(x))
    # the graph-free forward leaves the statistics as they are
    for layer, leaves in to_jax_stats(tr.stats_tree()).items():
        for k, v in leaves.items():
            assert np.array_equal(v, before[layer][k]), (layer, k)
    tr.bwd(torch.from_numpy(x), torch.from_numpy(ct), rng_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=CUT_TOL)
    _assert_grads(gt["head"], _torch_grads(tr.model))
    tr.apply_update()   # the optimizer step keeps the recompute's stats
    _assert_stats(jax.tree_util.tree_map(np.asarray, new_j),
                  to_jax_stats(tr.stats_tree()), stats,
                  _bn_sizes(4, 0, CUT))


@pytest.fixture(scope="module")
def torch_dropout():
    """The port's float32 model with its dropout layers, built once."""
    return tsplit.SplitModel(tvgg.vgg16_cifar10())


def _pipeline_step(model, params, stats, remat):
    _load(model, params, stats)
    model.seed_dropout(5)
    model.train()
    x, y = _batch(4, b=8)
    x = torch.from_numpy(x).reshape(2, 4, 32, 32, 3)
    y = torch.from_numpy(y).reshape(2, 4)
    pipe = PipelineModel(model, [CUT], example_input=x[0],
                         num_microbatches=2, remat=remat)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = pipe.train_step(opt, x, y)
    return float(loss), _clone(model.state_tree()), _clone(
        model.stats_tree())


def _clone(tree):
    return {k: {n: t.clone() for n, t in v.items()} for k, v in tree.items()}


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_updates_statistics_once_and_replays_dropout(
        jax_vars, torch_full, torch_dropout, dropout):
    """A pipeline step with every stage recomputed (``remat="all"``)
    equals the stored one bit for bit: the recompute neither updates the
    statistics a second time nor draws new dropout masks."""
    params, stats = jax_vars
    model = torch_dropout if dropout else torch_full
    none = _pipeline_step(model, params, stats, "none")
    full = _pipeline_step(model, params, stats, "all")
    assert none[0] == full[0]
    for a, b in ((none[1], full[1]), (none[2], full[2])):
        for layer in a:
            for k in a[layer]:
                assert torch.equal(a[layer][k], b[layer][k]), (layer, k)
    assert not torch.equal(none[2]["layer2"]["var"],
                           torch.from_numpy(stats["layer2"]["var"]))


def test_protocol_recompute_replays_dropout_masks():
    """The protocol's graph-free forward and its recompute draw the same
    dropout masks, so the input gradient is that of the forward sent."""
    torch.manual_seed(0)
    runner = TRunner(NAME, 44, -1, {"optimizer": "sgd"}, {}, "cpu", seed=3)
    runner.load(runner.state_tree())
    x = torch.randn(4, 1, 1, 512)
    out, rng = runner.fwd(x)
    runner.fwd(x)   # a later batch's forward advances the generators
    ct = torch.randn_like(out)
    gx = runner.bwd(x, ct, rng)
    # the same function, differentiated directly
    runner.model.zero_grad()
    runner.model.set_rng_state(rng)
    xr = x.clone().requires_grad_(True)
    again = runner.model(xr, train=True)
    assert torch.equal(again, out)
    again.backward(ct)
    assert torch.equal(gx, xr.grad)


def test_converter_round_trip_is_exact(jax_vars, torch_dropout):
    params, stats = jax_vars
    model = _load(torch_dropout, params, stats)
    tp = from_jax_params(params)
    # Conv HWIO -> OIHW, Dense (in, out) -> (out, in)
    assert tp["layer1"]["weight"].shape == (64, 3, 3, 3)
    assert tp["layer47"]["weight"].shape == (4096, 512)
    assert set(tp["layer2"]) == {"weight", "bias"}
    for tree in (model.state_tree(), model.stats_tree(),
                 {k: dict(m.state_dict()) for k, m in model.layers.items()}):
        for leaves in tree.values():
            assert not any("num_batches_tracked" in k for k in leaves)
    back_p = to_jax_params(model.state_tree(), model)
    back_s = to_jax_stats(model.stats_tree())
    for orig, back in ((params, back_p), (stats, back_s)):
        fo = jax.tree_util.tree_leaves_with_path(orig)
        fb = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(fo) == len(fb)
        for path, leaf in fo:
            assert fb[path].dtype == leaf.dtype, path
            assert fb[path].tobytes() == leaf.tobytes(), path


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_cifar_is_byte_equal(monkeypatch, tmp_path, train):
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))   # no on-disk copy
    for name in ("CIFAR10", "CIFAR100"):
        a = jdata.get_dataset(name, train=train, synthetic_size=48)
        b = tdata.get_dataset(name, train=train, synthetic_size=48)
        assert a.inputs.dtype == b.inputs.dtype == np.float32
        assert a.inputs.tobytes() == b.inputs.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()


def test_cifar_loader_augments_byte_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    kw = dict(train=True, seed=9, synthetic_size=64,
              distribution=np.asarray([4] * 10))
    a, b = jloader("CIFAR10", 8, **kw), tloader("CIFAR10", 8, **kw)
    assert b.augment is not None
    for _ in range(2):
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.tobytes() == xb.tobytes()
            assert ya.tobytes() == yb.tobytes()


def test_cifar_on_disk_batches_load_like_jax(monkeypatch, tmp_path):
    """The python-pickle CIFAR-10 layout under the data directory."""
    import pickle
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    for train in (True, False):
        a = jdata.get_dataset("CIFAR10", train=train)
        b = tdata.get_dataset("CIFAR10", train=train)
        assert b.inputs.shape == ((15 if train else 3), 32, 32, 3)
        assert a.inputs.tobytes() == b.inputs.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()


def test_dropout_mask_scale_and_eval_identity():
    drop = tsplit.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(200_000)
    y = drop(x, train=True)
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - 0.5) < 3 * (0.25 / n) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert drop(x, train=False) is x
    # the train-mode forward of a model with dropout differs from eval,
    # and eval mode is deterministic
    model = tsplit.SplitModel(tvgg.vgg16_cifar10(), 45, -1)
    xb = torch.randn(2, 512)
    with torch.no_grad():
        assert torch.equal(model(xb, train=False), model(xb, train=False))
        assert not torch.equal(model(xb, train=True),
                               model(xb, train=False))


def test_unported_dataset_and_model_raise():
    with pytest.raises(NotImplementedError, match="MNIST"):
        tdata.get_dataset("MNIST")
    specs = tvgg.vgg16_mnist()
    assert specs[0].make().weight.shape == (64, 1, 3, 3)


def test_batchnorm_is_not_torch_batchnorm():
    """The statistics are the biased variance in the flax update, kept
    only on commit; ``nn.BatchNorm2d`` keeps the unbiased one at once."""
    bn = tsplit.BatchNorm(3)
    x = torch.randn(2, 2, 2, 3) * 2 + 1
    bn(x, train=True)
    assert torch.equal(bn.var, torch.ones(3))   # not yet kept
    bn.commit()
    flat = x.reshape(-1, 3)
    biased = flat.var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    ref = torch.nn.BatchNorm2d(3, momentum=0.1)
    ref(x.permute(0, 3, 1, 2))
    assert not np.allclose(ref.running_var.numpy(), bn.var.numpy(),
                           rtol=1e-3)
