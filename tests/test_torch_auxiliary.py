"""The port's auxiliary heads (async decoupled split learning) against the
JAX package's, on the CPU.

The same seeded numpy boundaries go through the JAX package's
``AuxHead`` and the port's, with the JAX head's parameters carried
across by ``split_learning_torch.convert.from_jax_aux``: both head kinds
(``pooled-linear``, ``projection-mlp`` with flax's tanh gelu) on a
VGG16 boundary (cut 7), a KWT boundary (cut 2) and BERT's ``(hidden,
mask)`` boundary, whose bool mask the heads skip.  Then ``aux_step``
(the shard's forward, the head's loss and both gradient trees in one
call) on the VGG16 and KWT stage-1 shards from the same weights,
statistics and batch, dropout off (the random streams cannot match).

Tolerance, float32: the logits, the loss, and every gradient leaf
within 1e-5 of the largest magnitude of its leaf in the JAX package's
result (``|port - jax| <= 1e-5 * max(1, max|jax|)``).

Also: the head's signature reset (a cut whose boundary shape differs
re-shapes the head and its optimizer; the same batch keeps both), and
``num_classes_for`` refusing a token dataset, as the JAX package does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import build_model as jbuild
from split_learning_tpu.ops import auxiliary as jaux
from split_learning_tpu.runtime.client import ShardRunner as JRunner
from split_learning_torch.convert import (
    from_jax_aux, from_jax_params, from_jax_stats, to_jax_aux,
    to_jax_params,
)
from split_learning_torch.ops import auxiliary as taux
from split_learning_torch.runtime.client import ShardRunner as TRunner

TOL = 1e-5
KWT = {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32, "dropout_rate": 0.0}
LEARNING = {"mode": "async", "optimizer": "sgd", "learning_rate": 0.1,
            "batch_size": 4}
KINDS = (("pooled-linear", 0), ("projection-mlp", 16))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(port, ref, what: str) -> None:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(
        port, ref, rtol=0, atol=TOL * max(1.0, float(np.abs(ref).max())),
        err_msg=what)


def _boundaries():
    rng = np.random.default_rng(7)
    mask = rng.random((4, 12)) > 0.3
    return {
        "vgg": rng.standard_normal((4, 16, 16, 128)).astype(np.float32),
        "kwt": rng.standard_normal((4, 99, 16)).astype(np.float32),
        "bert": (rng.standard_normal((4, 12, 32)).astype(np.float32),
                 mask),
    }


def _heads(kind: str, hidden: int, classes: int, boundary):
    """(JAX head, its params, the port's head carrying them)."""
    jhead = jaux.build_aux_head(kind, classes, hidden=hidden)
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        boundary)
    jp = jaux.init_aux_params(jhead, jax.random.key(3), shapes)
    spec = taux.build_aux_head(kind, classes, hidden=hidden)
    assert (spec.num_classes, spec.hidden) == (jhead.num_classes,
                                               jhead.hidden)
    thead = taux.init_aux_params(spec, torch.Generator().manual_seed(0),
                                 _torch(boundary))
    thead.load_state_dict(from_jax_aux(jax.tree_util.tree_map(
        np.asarray, jp)))
    return jhead, jp, thead


def _torch(boundary):
    if isinstance(boundary, tuple):
        return tuple(torch.from_numpy(np.array(b)) for b in boundary)
    return torch.from_numpy(np.array(boundary))


@pytest.mark.parametrize("kind,hidden", KINDS, ids=[k for k, _ in KINDS])
@pytest.mark.parametrize("name", ("vgg", "kwt", "bert"))
def test_head_logits_and_gradients_match(name, kind, hidden):
    boundary = _boundaries()[name]
    labels = np.arange(4, dtype=np.int32) % 4
    jhead, jp, thead = _heads(kind, hidden, 4, boundary)
    # the converter's round trip is exact
    back = to_jax_aux(thead.state_dict())
    for layer, leaves in jax.tree_util.tree_map(np.asarray, jp).items():
        for n, a in leaves.items():
            assert np.array_equal(back[layer][n], a), (layer, n)

    def jloss(p):
        logits = jhead.apply({"params": p}, boundary)
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(4),
                                                     labels]), logits
    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tb = _torch(boundary)
    logits = thead(tb)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long())
    loss.backward()
    _close(logits.detach(), jlogits, "logits")
    _close(loss.detach(), jl, "loss")
    grads = to_jax_aux({k: p.grad for k, p in thead.named_parameters()})
    for layer, leaves in jax.tree_util.tree_map(np.asarray, jg).items():
        for n, g in leaves.items():
            _close(grads[layer][n], g, f"{layer}/{n}")


def _shard_params(model_key, cut, kw, x):
    """The stage-1 shard [0, cut)'s initial weights and statistics
    (numpy, the JAX package's trees)."""
    jm = jbuild(model_key, start_layer=0, end_layer=cut, **kw)
    var = jm.init(jax.random.key(0), x, train=False)
    return (jax.tree_util.tree_map(np.asarray, var["params"]),
            jax.tree_util.tree_map(np.asarray, var.get("batch_stats", {})))


@pytest.mark.parametrize("kind,hidden", KINDS, ids=[k for k, _ in KINDS])
@pytest.mark.parametrize("model_key,cut,kw,shape", [
    ("VGG16_CIFAR10", 7, {}, (4, 32, 32, 3)),
    ("KWT_SPEECHCOMMANDS", 2, KWT, (4, 40, 98)),
], ids=["vgg", "kwt"])
def test_aux_step_matches(model_key, cut, kw, shape, kind, hidden):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 10, shape[0]).astype(np.int32)
    params, stats = _shard_params(model_key, cut, kw, x)
    lrn = dict(LEARNING, aux_head=kind, aux_hidden=hidden or 64)
    jr = JRunner(model_key, 0, cut, lrn, model_kwargs=kw, seed=0)
    f, t = jr.partition_params(params, False)
    bshape = jax.eval_shape(jr.fwd, f, t, stats, x, jax.random.key(0))
    jp = jaux.init_aux_params(jr.aux, jax.random.key(5), bshape)
    loss, out, gt, ga, _ = jr.aux_step(f, t, jp, stats, x, labels,
                                       jax.random.key(0))
    tr = TRunner(model_key, 0, cut, lrn, dict(kw), "cpu")
    tr.load(from_jax_params(params), from_jax_stats(stats))
    tb = tr.boundary(torch.from_numpy(x))
    assert taux.aux_shapes_signature(tb)[0][0] == bshape.shape
    head = tr.init_aux_head(tb)
    head.load_state_dict(from_jax_aux(jax.tree_util.tree_map(np.asarray,
                                                             jp)))
    tloss, tout = tr.aux_step(torch.from_numpy(x),
                              torch.from_numpy(labels), head)
    _close(tloss, loss, "loss")
    _close(tout, out, "boundary output")
    hg = to_jax_aux({k: p.grad for k, p in head.named_parameters()})
    for layer, leaves in jax.tree_util.tree_map(np.asarray, ga).items():
        for n, g in leaves.items():
            _close(hg[layer][n], g, f"head {layer}/{n}")
    sg = to_jax_params({layer: {k: p.grad for k, p in
                                tr.model.layers[layer].named_parameters()}
                        for layer in tr.model.layers}, tr.model)
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, gt["head"]))
    assert flat
    for path, g in flat:
        node = sg
        for k in path:
            node = node[k.key]
        _close(node, g, f"shard {jax.tree_util.keystr(path)}")


def _client(tmp_path):
    from split_learning_torch.config import from_dict
    from split_learning_torch.runtime.bus import InProcTransport
    from split_learning_torch.runtime.client import ProtocolClient
    cfg = from_dict({"model": "KWT", "dataset": "SPEECHCOMMANDS",
                     "clients": [1, 1], "model-kwargs": KWT,
                     "learning": {"mode": "async", "batch-size": 4},
                     "log-path": str(tmp_path),
                     "checkpoint": {"save": False}})
    return ProtocolClient(cfg, "c1", 1, transport=InProcTransport(),
                          device="cpu")


def test_signature_reset(tmp_path):
    """A re-plan that moves the cut changes the boundary's shape: the
    head AND its optimizer state reset.  The same cut and batch keep
    both, and the signature's shapes are the JAX package's."""
    c = _client(tmp_path)
    x = torch.zeros(2, 40, 98)
    c.runner = TRunner("KWT_SPEECHCOMMANDS", 0, 2, LEARNING, KWT, "cpu")
    c._ensure_aux(x)
    head, opt, sig = c.aux_head, c.aux_optimizer, c._aux_sig
    assert head is not None and opt is not None
    c._ensure_aux(x)
    assert c.aux_head is head and c.aux_optimizer is opt
    c.runner = TRunner("KWT_SPEECHCOMMANDS", 0, 16, LEARNING, KWT, "cpu")
    c._ensure_aux(x)
    assert c._aux_sig != sig
    assert c.aux_head is not head and c.aux_optimizer is not opt
    jr = JRunner("KWT_SPEECHCOMMANDS", 0, 16, LEARNING, model_kwargs=KWT)
    xj = jnp.zeros((2, 40, 98), jnp.float32)
    full = jbuild("KWT_SPEECHCOMMANDS", start_layer=0, end_layer=16, **KWT)
    p = full.init(jax.random.key(0), xj, train=False)["params"]
    f, t = jr.partition_params(p, False)
    jsig = jaux.aux_shapes_signature(jax.eval_shape(
        jr.fwd, f, t, {}, xj, jax.random.key(0)))
    assert [s for s, _ in c._aux_sig] == [s for s, _ in jsig]
    c._reset_aux()
    assert c.aux_head is None and c.aux_optimizer is None


def test_num_classes_refuses_a_token_dataset():
    assert taux.num_classes_for("KWT_SPEECHCOMMANDS") == \
        jaux.num_classes_for("KWT_SPEECHCOMMANDS") == 10
    assert taux.num_classes_for("VGG16_CIFAR100") == 100
    for mod in (taux, jaux):
        with pytest.raises(ValueError, match="label space"):
            mod.num_classes_for("TINYLLAMA_TINYSTORIES")
    # async TinyLlama is refused where its runner is built
    with pytest.raises(ValueError, match="label space"):
        TRunner("TinyLlama_TINYSTORIES", 0, 1, LEARNING,
                {"vocab_size": 32, "hidden_size": 16, "num_heads": 2,
                 "num_kv_heads": 1, "intermediate_size": 32,
                 "n_block": 1}, "cpu")
    with pytest.raises(ValueError, match="unknown aux head"):
        taux.build_aux_head("conv-probe", 10)
    with pytest.raises(ValueError, match="no float leaves"):
        taux.init_aux_params(taux.build_aux_head("pooled-linear", 4),
                             torch.Generator(),
                             torch.zeros(2, 3, dtype=torch.int32))
