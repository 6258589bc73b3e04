"""BASELINE configs 3 (``configs/baseline3.yaml``: ResNet-50/CIFAR-100,
cuts ``[3, 6]``, ``clients: [2, 2, 2]``, SGD with momentum) and 4
(``configs/baseline4.yaml``: ViT-S/16 on CIFAR-10, ``[2, 1]``, AdamW
with weight decay 0.05) in the port against the JAX package, on the CPU,
at reduced samples.

Reductions: one round (5), batch 4 and control-count 2 (64 and 4), 16
samples a client (2500) drawn from 256 synthetic images, one validation
batch of 8; float32 compute (bf16 in the YAMLs); and ResNet-50 cut in
depth to one bottleneck a stage — the stem, the first bottleneck of
each of the four stages (its widths and strides kept, each with its
projection shortcut), the pool and the head: 9 layers, 17 BatchNorms —
in both packages' registries, in this file only, so that the JAX
package's three-stage round compiles in a fraction of the time.  The
cuts ``[3, 6]`` then put the stem in stage 1, the first three stages'
bottlenecks in stage 2 and the last one with the head in stage 3;
``tests/test_torch_resnet.py`` holds the 21-layer model layer by layer.
The rounds run in float32: one bf16 round of either package's full
ResNet-50 at batch 4 is dominated by rounding (the JAX package's own
bf16 round lands 1.22 times the norm of its float32 round's update away
from it, and the port's bf16 round 1.25 from the JAX package's), so
bf16 parity could not tell a fault from noise.  ViT-S/16 keeps its
geometry (384 wide, 6 heads, MLP 1536) at 2 blocks, cut at ``[5]``
(between the blocks, as the YAML's ``[10]`` is between blocks 6 and 7),
dropout pinned off.  ``python -m split_learning_torch.run`` runs each
YAML in its bf16 on the CPU, with the samples, the batch and (ViT) the
blocks reduced.

Held, for each round: the plan and the sample count exactly; the
validation loss; the FedAvg'd parameters (absolute, and the round's
update ``dp = trained - start`` as ``||dp_t - dp_j|| / ||dp_j||`` over
the tree: an update skipped scores 1); the statistics.  Tolerances:

* config 3 in process (two steps of two microbatches of 4 a column,
  through 17 batch-4 BatchNorms): parameters within 5e-5 (measured
  7.3e-6), update error within 1e-2 (measured 1.6e-3; VGG16's ``[2,
  2]`` round in ``tests/test_torch_vgg_round.py`` is held at 2e-3 with
  3.1e-4 measured, over 13 BatchNorms at batch 4 — here the BatchNorm
  gradients of four residual blocks add their noise), the head kernel's
  update error within 1e-4 (measured 3.0e-6), statistics within 1e-5
  (measured 9.5e-7), validation loss within 1e-5 (measured 1.9e-6);
* config 3 as the protocol round (the int8 codec on both directions of
  both cuts, every kernel flag on, the sharded fold; float32 wire,
  control-count 1, three batches of 4): in lockstep, ``[1, 1, 1]`` (a
  shared later-stage client takes its feeders' batches in arrival
  order, so with two feeders the steps come in thread order in both
  packages, as ``tests/test_torch_baseline2.py`` states for baseline
  2).  A code can flip by one at a .5 boundary when the packages'
  activations differ by float32 noise, moving one value by 1/127 of its
  tile's absmax, and config 3's learning rate (1e-2) is 20 times VGG's,
  so each flip moves the parameters 20 times as far as in
  ``tests/test_torch_vgg_round.py``'s int8 round: parameters within
  5e-3 (measured 1.9e-3; VGG's 1e-3), update error within 0.4
  (measured 0.12; VGG's 0.4), the head kernel's within 0.05 (measured
  7.1e-3), statistics within 5e-3 (measured 2.1e-3), validation loss
  within 2e-3 (measured 6.1e-4; VGG's 1e-4).  ``[2, 2, 2]`` as written
  runs in the port alone: six clients, every sample, a full fold, finite
  trees and every statistic;
* config 4 in process (AdamW, one shared stage-2 client whose
  gradients are averaged over the two columns every step; two steps):
  Adam divides each gradient by its own running magnitude, so a value
  whose gradient is float32 noise takes a step of up to lr in a
  direction set by that noise.  Parameters within 2 lr = 6e-4
  (measured 1.0e-4), 99.9% of them within 1e-6 (measured 99.98%),
  update error within 5e-3 (measured 6.6e-4), validation loss within
  5e-5 (measured 5.5e-6);
* the port's AdamW (``torch.optim.AdamW`` through ``make_optimizer``)
  against ``optax.adamw`` at config 4's learning rate and weight decay
  over six steps: each parameter within one float32 ulp of the largest
  parameter of its leaf per step.  torch decays the parameter
  (``p * (1 - lr * wd)``, rounded) before it adds the Adam step;
  optax adds one combined update: one more rounding at the parameter's
  scale a step, nothing else.  The same six steps without the weight
  decay land more than 30 ulps away.
"""

import dataclasses
import threading

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats, tree_to,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.run import main as run_main
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime.bus import InProcTransport
from split_learning_torch.runtime.context import TorchContext, make_optimizer
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan
from split_learning_torch.runtime.server import run_inproc

VIT_KW = {"n_block": 2, "dropout_rate": 0.0}
RESNET = "ResNet50_CIFAR100"
#: the layers kept: the stem (conv, BatchNorm, ReLU), the first
#: bottleneck of each stage, the pool and the head
KEEP = (1, 2, 3, 4, 7, 11, 17, 20, 21)
#: the int8 protocol round's tolerances (see the module docstring)
PROTO_LOSS_TOL, PROTO_PARAM_TOL, PROTO_STATS_TOL = 2e-3, 5e-3, 5e-3
PROTO_UPDATE_TOL, PROTO_HEAD_TOL = 0.4, 0.05


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The suite runs its files side by side in several processes on
    one CPU: this file's torch work keeps to two threads, and puts the
    count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _one_block_a_stage(spec_fn):
    def specs(**kw):
        full = spec_fn(**kw)
        return tuple(dataclasses.replace(full[i - 1], name=f"layer{j}")
                     for j, i in enumerate(KEEP, start=1))
    return specs


@pytest.fixture(scope="module", autouse=True)
def shallow_resnet():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsplit, tsplit):
            mp.setitem(mod._REGISTRY, RESNET,
                       _one_block_a_stage(mod._REGISTRY[RESNET]))
        yield


def _reduced(tmp_path, yaml_path, samples=16, control=2, **over):
    with open(yaml_path) as f:
        d = yaml.safe_load(f)
    d["distribution"] = dict(d["distribution"], **{"num-samples": samples})
    d["learning"] = dict(d["learning"], **{"batch-size": 4,
                                           "control-count": control})
    d.update({"global-rounds": 1, "synthetic-size": 256,
              "val-max-batches": 1, "val-batch-size": 8,
              "compute-dtype": "float32",
              "log-path": str(tmp_path / "logs"),
              "checkpoint": {"save": False}}, **over)
    return d


def _init(name, shape, **kw):
    """flax's initial variables of ``name`` (key 0) as numpy trees."""
    model = jsplit.SplitModel(specs=jsplit.model_registry()[name](**kw))
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), np.zeros(shape, np.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    return v["params"], v.get("batch_stats", {})


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)))


def _max_diff(jt, tt):
    fj, ft = _leaves(jt), _leaves(tt)
    assert set(fj) == set(ft)
    return max(float(np.abs(ft[k] - a).max()) for k, a in fj.items())


def _bulk(jt, tt, tol):
    """The share of values within ``tol``."""
    fj, ft = _leaves(jt), _leaves(tt)
    close = sum(int((np.abs(ft[k] - a) <= tol).sum()) for k, a in fj.items())
    return close / sum(a.size for a in fj.values())


def _update_error(jt, tt, t0, only=None):
    fj, ft, f0 = _leaves(jt), _leaves(tt), _leaves(t0)
    num = den = 0.0
    for k, a in fj.items():
        if only is not None and jax.tree_util.keystr(k) != only:
            continue
        dj, dt = a - f0[k], ft[k] - f0[k]
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / den) ** 0.5


def _run_both(tmp_path, d, p0, s0):
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    jplans, tplans = jplan(jc, jregs(jc)), tplan(tc, tregs(tc))
    assert [(p.cuts, p.clients) for p in jplans] == \
        [(p.cuts, p.clients) for p in tplans]
    jres = jrun(jc, MeshContext(jc), jplans,
                JLogger(tmp_path / "jax", console=False),
                init_params=p0, init_stats=s0)
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplans, TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0),
                init_stats=from_jax_stats(s0))
    return jres, tres, tctx


def _run_cli(tmp_path, yaml_path, capsys, **over):
    """``python -m split_learning_torch.run --device cpu`` on the YAML
    with 16 samples a client in batches of 8, one round, 1024 synthetic
    images (every CIFAR-100 class present): 2 steps a client."""
    with open(yaml_path) as f:
        d = yaml.safe_load(f)
    d["distribution"]["num-samples"] = 16
    d["learning"].update({"batch-size": 8, "control-count": 1})
    d.update({"global-rounds": 1, "synthetic-size": 1024,
              "val-max-batches": 1, "val-batch-size": 8,
              "log-path": str(tmp_path / "cli"),
              "checkpoint": {"save": False}}, **over)
    path = tmp_path / "reduced.yaml"
    path.write_text(yaml.safe_dump(d))
    run_main(["--config", str(path), "--device", "cpu"])
    assert "round 0: ok=True samples=32" in capsys.readouterr().out


def test_baseline3_in_process_matches_jax_package(tmp_path, capsys):
    p0, s0 = _init(RESNET, (1, 32, 32, 3))
    d = _reduced(tmp_path, "configs/baseline3.yaml")
    jres, tres, tctx = _run_both(tmp_path, d, p0, s0)
    (a,), (b,) = jres.history, tres.history
    # each client's 16 draws find 15 images among the 256 synthetic
    # ones (a class is missing): three batches of 4, one step of 2
    assert a.ok and b.ok and a.num_samples == b.num_samples == 2 * 8
    assert abs(a.val_loss - b.val_loss) <= 1e-5, (a, b)
    trained = to_jax_params(tres.params, tctx.full_model)
    assert _max_diff(jres.params, trained) <= 5e-5
    assert _update_error(jres.params, trained, p0) <= 1e-2
    assert _update_error(jres.params, trained, p0,
                         only="['layer9']['kernel']") <= 1e-4
    stats = to_jax_stats(tres.stats)
    assert len(_leaves(stats)) == 2 * 17
    assert _max_diff(jres.stats, stats) <= 1e-5

    # the CLI on the YAML as written (bf16, [2, 2, 2], cuts [3, 6]) but
    # for the samples and the batch
    _run_cli(tmp_path, "configs/baseline3.yaml", capsys)


def _serve_jax(cfg, p0, s0):
    bus = jbus.InProcTransport()
    server = JServer(cfg, transport=bus, client_timeout=300)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": s0}
    clients = [JClient(cfg, f"client_{s}_{i}", s, transport=bus)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server.serve()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "client thread failed to stop"
    return result


def _protocol_config(tmp_path, clients):
    """Config 3 as the protocol round: the int8 codec on both directions
    of both cuts, every kernel flag on, the sharded fold; float32 wire,
    control-count 1, 16 samples a client (15 found: three batches of
    4)."""
    return _reduced(tmp_path, "configs/baseline3.yaml", control=1,
                    clients=clients,
                    transport={"wire-dtype": "float32",
                               "codec": {"intermediate": "int8",
                                         "gradient": "int8"}},
                    kernels={"quantize": True, "dequantize": True,
                             "stage-update": True},
                    aggregation={"strategy": "fedavg", "sharded": True})


def test_baseline3_protocol_round_matches_jax_package(tmp_path, monkeypatch):
    """Three stages in lockstep (``[1, 1, 1]``: one client a stage, so
    each stage steps its optimizer in a fixed order in both packages)."""
    from split_learning_tpu.runtime import strategies as jstrat
    from split_learning_torch.runtime import strategies as tstrat
    p0, s0 = _init(RESNET, (1, 32, 32, 3))
    d = _protocol_config(tmp_path, [1, 1, 1])
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    folds = {"jax": [], "torch": []}
    for name, strat in (("jax", jstrat), ("torch", tstrat)):
        def fold(ups, _agg=strat.aggregate_cluster, _name=name):
            folds[_name].append(_agg(ups))
            return folds[_name][-1]
        monkeypatch.setattr(strat, "aggregate_cluster", fold)
    queues = set()
    orig_publish = InProcTransport.publish

    def publish(bus, queue, payload):
        if queue.startswith(("intermediate_queue", "gradient_queue")):
            queues.add(queue.rsplit("_", 1)[0])
        return orig_publish(bus, queue, payload)
    monkeypatch.setattr(InProcTransport, "publish", publish)

    jres = _serve_jax(jc, p0, s0)
    run = run_inproc(tc, device="cpu", client_timeout=300,
                     init_params=from_jax_params(p0),
                     init_stats=from_jax_stats(s0))
    (a,), (b,) = jres.history, run.result.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 12
    assert abs(a.val_loss - b.val_loss) <= PROTO_LOSS_TOL, (a, b)
    # activations cross both cuts, gradients come back over both
    assert {"intermediate_queue_1", "intermediate_queue_2"} <= queues
    ((jp, js, jn),), ((tp, ts, tn),) = folds["jax"], folds["torch"]
    assert jn == tn == 12
    model = run.server.ctx.full_model
    tp = to_jax_params(tree_to(tp, "cpu"), model)
    ts = to_jax_stats(tree_to(ts, "cpu"))
    assert len(_leaves(ts)) == 2 * 17
    assert _max_diff(jp, tp) <= PROTO_PARAM_TOL
    assert _update_error(jp, tp, p0) <= PROTO_UPDATE_TOL
    assert _update_error(jp, tp, p0,
                         only="['layer9']['kernel']") <= PROTO_HEAD_TOL
    assert _max_diff(js, ts) <= PROTO_STATS_TOL


def test_baseline3_protocol_round_as_written_runs(tmp_path):
    """``[2, 2, 2]`` as the YAML writes it, in the port alone: six
    clients, two feeders at each cut (a shared later-stage client takes
    its feeders' batches in arrival order, so the steps' order is the
    threads'); every client's samples, a full fold, finite trees and
    every layer's statistics."""
    p0, s0 = _init(RESNET, (1, 32, 32, 3))
    cfg = tcfg.from_dict(_protocol_config(tmp_path, [2, 2, 2]))
    run = run_inproc(cfg, device="cpu", client_timeout=300,
                     init_params=from_jax_params(p0),
                     init_stats=from_jax_stats(s0))
    (rec,) = run.result.history
    assert rec.ok and rec.num_samples == 2 * 12
    assert run.server.ctx.last_fold.folded == 6
    params = to_jax_params(tree_to(run.result.params, "cpu"),
                           run.server.ctx.full_model)
    stats = to_jax_stats(tree_to(run.result.stats, "cpu"))
    assert set(_leaves(params)) == set(_leaves(p0))
    assert set(_leaves(stats)) == set(_leaves(s0))
    assert all(np.isfinite(v).all() for v in _leaves(params).values())
    assert all(np.isfinite(v).all() for v in _leaves(stats).values())
    assert _max_diff(p0, params) > 0   # the round moved them


def test_round_record_carries_the_training_peak(tmp_path):
    """Each round record carries the context's peak memory, read after
    the round's training and before its validation, the peak reset
    before the round; off CUDA the context reports None."""
    d = _reduced(tmp_path, "configs/baseline3.yaml",
                 **{"global-rounds": 2})
    tc = tcfg.from_dict(d)
    calls = []

    class Ctx(TorchContext):
        def reset_peak_memory(self):
            calls.append("reset")

        def peak_memory(self):
            calls.append("read")
            return len(calls)

        def validate(self, params, stats):
            calls.append("validate")
            return super().validate(params, stats)

    ctx = Ctx(tc, device="cpu")
    res = trun(tc, ctx, tplan(tc, tregs(tc)),
               TLogger(tmp_path / "torch", console=False))
    assert calls == ["reset", "read", "validate"] * 2
    assert [r.train_peak_memory_bytes for r in res.history] == [2, 5]
    assert TorchContext.peak_memory(ctx) is None


def test_baseline4_in_process_matches_jax_package(tmp_path, capsys):
    p0, _ = _init("ViT_S16_CIFAR10", (1, 32, 32, 3), **VIT_KW)
    d = _reduced(tmp_path, "configs/baseline4.yaml",
                 topology={"cut-layers": [5]},
                 **{"model-kwargs": dict(VIT_KW)})
    jres, tres, tctx = _run_both(tmp_path, d, p0, {})
    (a,), (b,) = jres.history, tres.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 2 * 16
    assert abs(a.val_loss - b.val_loss) <= 5e-5, (a, b)
    trained = to_jax_params(tres.params, tctx.full_model)
    # two Adam steps move a value by at most about 2 lr
    assert _max_diff(jres.params, trained) <= 2 * 3e-4
    assert _bulk(jres.params, trained, 1e-6) >= 0.999
    assert _update_error(jres.params, trained, p0) <= 5e-3
    assert tres.stats == {}

    # the CLI on the YAML as written (bf16, dropout 0.1, cut [10]) but
    # for the samples, the batch and the blocks (7 of 12)
    _run_cli(tmp_path, "configs/baseline4.yaml", capsys,
             **{"model-kwargs": {"n_block": 7}})


def test_adamw_matches_optax_adamw():
    """Config 4's optimizer: ``make_optimizer`` against ``optax.adamw``
    (lr 3e-4, weight decay 0.05) over six steps of gradients spanning
    six orders of magnitude, on leaves of the ViT's shapes."""
    rng = np.random.default_rng(0)
    shapes = [(384, 6, 64), (1536, 384), (384,), (1, 65, 384)]
    p0 = [rng.standard_normal(s).astype(np.float32) * 0.05 for s in shapes]
    grads = [[(rng.standard_normal(s) * 10 ** rng.uniform(-6, 0)).astype(
        np.float32) for s in shapes] for _ in range(6)]
    with open("configs/baseline4.yaml") as f:
        lrn = tcfg.from_dict(yaml.safe_load(f)).learning
    assert (lrn.optimizer, lrn.learning_rate, lrn.weight_decay) == (
        "adamw", 3e-4, 0.05)
    results = {}
    for wd in (lrn.weight_decay, 0.0):
        opt = optax.adamw(lrn.learning_rate, weight_decay=wd)
        pj = [np.array(p) for p in p0]
        state = opt.init(pj)
        for g in grads:
            upd, state = opt.update(g, state, pj)
            pj = [np.asarray(x) for x in optax.apply_updates(pj, upd)]
        results[wd] = pj
    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = make_optimizer(lrn, pt)
    for g in grads:
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step()
    for p, want, nodecay, init in zip(pt, results[lrn.weight_decay],
                                      results[0.0], p0):
        ulp = float(np.spacing(np.abs(init).max() * 1.01))
        err = float(np.abs(p.detach().numpy() - want).max())
        assert err <= len(grads) * ulp, (err, ulp)
        assert float(np.abs(p.detach().numpy() - nodecay).max()) > \
            30 * ulp
