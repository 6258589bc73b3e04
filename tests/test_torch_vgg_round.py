"""The default round — VGG16_CIFAR10 cut at layer 7, SGD with momentum,
FedAvg, validation — in the port against the JAX package, on the CPU.

Every case runs one round in both packages from the same initial
weights and the same BatchNorm statistics (flax's init, with the
statistics moved off their zeros and ones so that carrying them
matters), and compares the sample count (exactly), the validation loss
and accuracy, and the FedAvg'd parameter and statistics trees:

* in process, ``run_training`` through each package's context, at
  BASELINE config 1's ``[2, 2]`` (two lockstep columns, each
  later-stage column its own client) and ``[2, 1]`` (one shared
  stage-2 client: a sync group of two columns whose stage-2 gradients
  are averaged every step), in float32; and at ``config.yaml``'s
  ``clients: [1, 1]`` in its own bfloat16 compute (a single column
  runs the same column code as each column of ``[2, 2]``);
* as the protocol round in one process at ``[1, 1]``, with the int8
  codec on both cut directions and the CUDA fold backend with its
  stage-update kernels (the port's plain versions on the CPU; the JAX
  package's under the Pallas interpreter), against the JAX package's
  ``ProtocolServer``; the statistics ride the START, the UPDATE, the
  fold and the checkpoint.

Dropout cannot match across frameworks, so each package's registered
``VGG16_CIFAR10`` spec function is swapped, in this test only, for one
whose two Dropout layers are the identity.

Tolerances.  A single SGD step agrees to about a float32 ulp; the
differences then grow through batch-4 BatchNorm training, step by step,
so each case states its own.  A round moves most parameters by far
less than 1e-4 (0.1-0.6% of the values move more), so an absolute
tolerance on the parameters alone would pass a round that skipped its
update.  Each case therefore also holds the round's parameter change
``dp = trained - start`` against the JAX package's:
``||dp_t - dp_j|| / ||dp_j||`` over the whole tree ("update error") and
over the last Dense kernel alone ("head", the one leaf whose gradient
crosses no BatchNorm).  A skipped update scores 1, a doubled one 1.

* float32 in process (2 steps of 8 samples a column): validation loss
  within 1e-5 (measured 2.4e-7), parameters within 2e-5 (measured at
  most 4.6e-6; the round moves them up to ~1e-3), update error within
  2e-3 at ``[2, 2]`` (measured 3.1e-4) and 1e-2 at ``[2, 1]`` (measured
  2.6e-3), head within 1e-4 (measured 1.3e-5), statistics within 1e-5
  (measured 1.3e-6; values ~1);
* bfloat16 in process: every conv and dense product is rounded to bf16
  in both packages, in different orders, and torch's cross entropy
  rounds its float32 log-softmax where optax computes it in bf16; the
  batch-4 BatchNorm backward (a difference of means) amplifies those
  roundings layer by layer.  Validation loss within 1e-2, parameters
  within 2e-3 (measured 4.2e-4, the first conv's kernel, whose gradient
  crosses every BatchNorm) and 99% of them within 1e-4 (measured
  99.97%; 0.32% of the values move by more than 1e-4, so this bulk
  check alone has little power), update error within 0.6 (measured
  0.39, growing from 0.04 at the head to 0.4 at the first conv), head
  within 0.1 (measured 0.038), statistics within 2e-2 (measured
  4.5e-3);
* int8 protocol round (2 steps of 4 samples): a code can flip by one at
  a .5 boundary when the packages' activations differ by float32
  noise, which moves one value by 1/127 of its tile's absmax.
  Validation loss within 1e-4 (measured 1.9e-5); parameters within
  1e-3 (measured 3.0e-4; they move up to 1.4e-3) and 99.9% of them
  within 1e-4 (measured 99.995%); update error within 0.4 (measured
  0.19), head within 0.05 (measured 0.016); statistics within 5e-3
  (measured 1.3e-3) and half of them within 1e-4 (measured 69%).  The frames
  themselves are held as ``tests/test_torch_codec.py`` holds them: the
  port's first activation frame is bitwise ``quantize_np`` of the
  activation it encodes, and the JAX package's frame has the same
  shape and tiling, scales within 1e-5 relative and codes within one.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_tpu.runtime.protocol import FrameAssembler as JFrames
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime import bus as tbus
from split_learning_torch.runtime.checkpoint import load_checkpoint
from split_learning_torch.runtime.codec import quant as tquant
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan
from split_learning_torch.runtime.protocol import FrameAssembler as TFrames
from split_learning_torch.runtime.server import run_inproc

NAME = "VGG16_CIFAR10"
DROPOUTS = ("layer46", "layer49")
# the last Dense kernel: the one leaf whose gradient crosses no BatchNorm
HEAD = "['layer52']['kernel']"

ROUND = {
    "model": "VGG16", "dataset": "CIFAR10", "global-rounds": 1,
    "synthetic-size": 64, "val-max-batches": 2, "val-batch-size": 8,
    "topology": {"cut-layers": [7]}, "distribution": {"num-samples": 16},
    "aggregation": {"strategy": "fedavg"},
    "learning": {"batch-size": 4, "control-count": 2, "optimizer": "sgd",
                 "learning-rate": 5e-4, "momentum": 0.9},
    "checkpoint": {"save": False},
}

PROTOCOL = dict(
    ROUND, clients=[1, 1], **{"compute-dtype": "float32"},
    distribution={"num-samples": 8},
    transport={"wire-dtype": "float32",
               "codec": {"intermediate": "int8", "gradient": "int8"}},
    kernels={"quantize": True, "dequantize": True, "stage-update": True},
    aggregation={"strategy": "fedavg", "sharded": True},
    learning=dict(ROUND["learning"], **{"control-count": 1}))


def _no_dropout(spec_fn, split_mod):
    def specs(**kw):
        return tuple(split_mod.LayerSpec(s.name, fn=split_mod.identity_fn)
                     if s.name in DROPOUTS else s for s in spec_fn(**kw))
    return specs


@pytest.fixture(scope="module", autouse=True)
def no_dropout_registries():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsplit, tsplit):
            mp.setitem(mod._REGISTRY, NAME,
                       _no_dropout(mod._REGISTRY[NAME], mod))
        yield


@pytest.fixture(scope="module")
def init_vars():
    """flax's initial parameters (key 0) and statistics moved off their
    init, as numpy trees."""
    model = jsplit.SplitModel(specs=jsplit.model_registry()[NAME]())
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), x)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(11)
    stats = {layer: {
        "mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(
            np.float32),
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for layer, s in jax.tree_util.tree_map(
            np.asarray, v["batch_stats"]).items()}
    return params, stats


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _assert_trees(jt, tt, tol, bulk_frac):
    """Every leaf within ``tol``, and ``bulk_frac`` of all values within
    1e-4."""
    flat_j, flat_t = _leaves(jt), _leaves(tt)
    assert set(flat_j) == set(flat_t)
    close = total = 0
    for path, a in flat_j.items():
        np.testing.assert_allclose(flat_t[path], a, rtol=0, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(flat_t[path] - a) <= 1e-4).sum())
        total += a.size
    assert close >= bulk_frac * total, (close, total)


def _update_error(jt, tt, t0):
    """``||dp_t - dp_j|| / ||dp_j||`` of the round's parameter change
    (trained minus the START's ``t0``) over the whole tree and for each
    leaf, and the share of values the JAX package's round moved by more
    than 1e-4."""
    flat_j, flat_t, flat_0 = _leaves(jt), _leaves(tt), _leaves(t0)
    num = den = 0.0
    per_leaf, moved, total = {}, 0, 0
    for path, a in flat_j.items():
        dj = a.astype(np.float64) - flat_0[path]
        dt = flat_t[path].astype(np.float64) - flat_0[path]
        e2, n2 = float(((dt - dj) ** 2).sum()), float((dj ** 2).sum())
        num, den = num + e2, den + n2
        per_leaf[jax.tree_util.keystr(path)] = (e2 / max(n2, 1e-300)) ** 0.5
        moved += int((np.abs(dj) > 1e-4).sum())
        total += dj.size
    return (num / den) ** 0.5, per_leaf, moved / total


def _assert_rounds(jres, tres, loss_tol):
    assert len(jres.history) == len(tres.history) == 1
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok
        assert a.num_samples == b.num_samples
        assert abs(a.val_loss - b.val_loss) < loss_tol, (a, b)
        assert abs(a.val_accuracy - b.val_accuracy) <= 1 / 16 + 1e-9, (a, b)


@pytest.mark.parametrize(
    "clients,dtype,loss_tol,param_tol,param_bulk,update_tol,head_tol,"
    "stat_tol", [
        ([2, 2], "float32", 1e-5, 2e-5, 1.0, 2e-3, 1e-4, 1e-5),
        ([2, 1], "float32", 1e-5, 2e-5, 1.0, 1e-2, 1e-4, 1e-5),
        ([1, 1], "bfloat16", 1e-2, 2e-3, 0.99, 0.6, 0.1, 2e-2),
    ], ids=["baseline1_2x2", "grouped_2x1", "config_bf16"])
def test_in_process_round_matches_jax_package(
        tmp_path, init_vars, clients, dtype, loss_tol, param_tol,
        param_bulk, update_tol, head_tol, stat_tol):
    p0, s0 = init_vars
    d = dict(ROUND, clients=clients, **{"compute-dtype": dtype,
                                        "log-path": str(tmp_path)})
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    jctx = MeshContext(jc)
    jres = jrun(jc, jctx, jplan(jc, jregs(jc)),
                JLogger(tmp_path / "jax", console=False),
                init_params=p0, init_stats=s0)
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplan(tc, tregs(tc)),
                TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0),
                init_stats=from_jax_stats(s0))

    _assert_rounds(jres, tres, loss_tol)
    assert tres.history[0].num_samples == 16 * clients[0]
    trained = to_jax_params(tres.params, tctx.full_model)
    _assert_trees(jres.params, trained, param_tol, param_bulk)
    rel, per_leaf, _ = _update_error(jres.params, trained, p0)
    assert rel <= update_tol, rel
    assert per_leaf[HEAD] <= head_tol, per_leaf[HEAD]
    _assert_trees(jres.stats, to_jax_stats(tres.stats), stat_tol, 0.0)
    # every column trained: the stage-1 statistics moved off the START's
    for layer in ("layer2", "layer5"):
        assert not np.array_equal(to_jax_stats(tres.stats)[layer]["var"],
                                  s0[layer]["var"])


class _Tap:
    """Records every frame published to the activation queues."""

    def __init__(self, bus_mod, mp):
        self.frames = []
        orig = bus_mod.InProcTransport.publish

        def publish(bus, queue, payload):
            if queue.startswith("intermediate_queue"):
                self.frames.append(payload)
            return orig(bus, queue, payload)
        mp.setattr(bus_mod.InProcTransport, "publish", publish)


def _serve_jax(cfg, p0, s0):
    bus = jbus.InProcTransport()
    server = JServer(cfg, transport=bus, client_timeout=120)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": s0}
    clients = [JClient(cfg, f"client_{s}_{i}", s, transport=bus)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server.serve()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "client thread failed to stop"
    return result


def test_protocol_round_matches_jax_package(tmp_path, init_vars,
                                            monkeypatch):
    p0, s0 = init_vars
    d = dict(PROTOCOL, **{"log-path": str(tmp_path)})
    jc = jcfg.from_dict(dict(d, checkpoint={"save": False}))
    tc = tcfg.from_dict(dict(d, checkpoint={
        "save": True, "directory": str(tmp_path / "ckpt")}))
    jtap, ttap = _Tap(jbus, monkeypatch), _Tap(tbus, monkeypatch)
    encoded = []
    prepare = tquant.QuantCodec.prepare

    def spy(codec, tree, key=""):
        if key.startswith("intermediate_queue"):
            encoded.append(tree.detach().cpu().numpy().copy())
        return prepare(codec, tree, key)
    monkeypatch.setattr(tquant.QuantCodec, "prepare", spy)

    jres = _serve_jax(jc, p0, s0)
    run = run_inproc(tc, device="cpu", client_timeout=120,
                     init_params=from_jax_params(p0),
                     init_stats=from_jax_stats(s0))
    tres = run.result

    _assert_rounds(jres, tres, 1e-4)
    assert tres.history[0].num_samples == 8
    trained = to_jax_params(tres.params, run.server.ctx.full_model)
    _assert_trees(jres.params, trained, 1e-3, 0.999)
    rel, per_leaf, _ = _update_error(jres.params, trained, p0)
    assert rel <= 0.4 and per_leaf[HEAD] <= 0.05, (rel, per_leaf[HEAD])
    _assert_trees(jres.stats, to_jax_stats(tres.stats), 5e-3, 0.5)
    # the fold's statistics are what the checkpoint holds
    ck = load_checkpoint(tmp_path / "ckpt", NAME)
    assert ck["round_idx"] == 1 and len(ck["batch_stats"]) == 13
    for layer, leaves in tres.stats.items():
        for k, t in leaves.items():
            assert torch.equal(ck["batch_stats"][layer][k], t.cpu())

    # the first activation frame of each package
    assert len(jtap.frames) == len(ttap.frames) == 2
    fj = JFrames().feed(jtap.frames[0]).data
    ft = TFrames().feed(ttap.frames[0]).data
    ref = tquant.quantize_np(encoded[0], ft.tile, ft.bits)
    assert encoded[0].shape == tuple(ft.shape) == (4, 16, 16, 64)
    assert ft.q.tobytes() == ref.q.tobytes()
    assert ft.scale.tobytes() == ref.scale.tobytes()
    assert tuple(fj.shape) == tuple(ft.shape) and fj.tile == ft.tile
    np.testing.assert_allclose(np.asarray(fj.scale), ft.scale, rtol=1e-5)
    assert np.abs(np.asarray(fj.q, np.int32)
                  - np.asarray(ft.q, np.int32)).max() <= 1
