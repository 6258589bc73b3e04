"""The five round strategies beside FedAvg — SDA, relay, cluster relay,
periodic and FedAsync — in the port's in-process round against the JAX
package's, on the CPU, from the same converted weights on the same plan.

Each case runs ``run_training`` in both packages for 2–4 rounds and
compares the sample count of every round and its ``validate`` flag
(whether the loop validated it) exactly, the validation loss, the final
parameters (and, for VGG16, the BatchNorm statistics) within stated
tolerances, and the run's parameter change ``dp = final - start``
against the JAX package's in norm, ``||dp_t - dp_j|| / ||dp_j||``, so
that a skipped or doubled update cannot pass under the absolute
tolerance.

* TinyLlama (float32, 2 blocks, hidden 32, SGD lr 0.05 momentum 0.9)
  at ``clients:
  [4, 2]`` in two manual clusters (two lockstep columns and one shared
  stage-2 client each): SDA (2 local epochs, lr decay 0.9 a round, one
  sync group at stage 2), relay (one column per call, client subsets),
  cluster relay, periodic (``t-client: 1, t-global: 2``, 4 rounds:
  per-client trees pushed into the columns) and FedAsync (``in-clusters:
  2``, α = 1/(1+rank) and a fixed α = 0.5, per-merge checkpoints).
  SGD, not the model's AdamW: Adam's step ``m / (sqrt(v) + eps)`` on a
  near-zero gradient turns float32 summation-order noise into a step of
  up to the learning rate (one element in 2048 moved 4e-4 apart at lr
  1e-3 in a 2-round FedAsync run), which says nothing about the
  strategy.  Tolerances: validation loss within 1e-5 (measured at most
  4.8e-7), parameters within 1e-5 (measured at most 2.4e-7), update
  error within 1e-4 (measured at most 1.1e-6).  With equal sample
  counts, FedAsync's α = 1/(1+rank) over two in-clusters averages them
  equally, so its result equals cluster relay's whenever the
  out-clusters run in plan order; the fixed α = 0.5 case does not.
* VGG16 (float32, dropout off, SGD lr 5e-4 momentum 0.9, cut 7) at
  ``clients: [2, 1]``, relay and periodic for 2 rounds, so that the
  BatchNorm statistics go through ``_fill`` and the per-client
  persistence.  Periodic holds ``tests/test_torch_vgg_round.py``'s
  float32 tolerances: validation loss within 1e-5 (measured 3.6e-7),
  parameters within 2e-5 (measured 1.1e-6), update error within 1e-2
  (measured 2.5e-3), statistics within 1e-5 (measured 9.5e-7).  Relay
  chains the two clients' steps (four SGD steps one after another, each
  through batch-4 BatchNorm, which amplifies the packages' float32
  differences step by step as that file explains): validation loss
  within 5e-5 (measured 8.6e-6), parameters within 2e-4 (measured
  5.5e-5, the first conv's kernel), update error within 0.1 (measured
  0.036), statistics within 2e-4 (measured 5.8e-5).

FedAsync's merge order and α are held by recording, in both packages,
the order in which the out-clusters train and every per-merge
checkpoint (its round index and its parameters, equal within the
parameter tolerance); a round whose second out-cluster reports a NaN
(its updates flagged not ok, as a NaN loss flags them) is refused in
both, and the checkpoint left on disk is the round-entry state in both.
"""

import jax
import numpy as np
import pytest

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime import checkpoint as jckpt
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime import checkpoint as tckpt
from split_learning_torch.runtime import strategies as tstrat
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan

LLAMA = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [4, 2],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 32, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 64,
                     "n_block": 2},
    "topology": {"cut-layers": [2], "num-clusters": 2},
    "distribution": {"num-samples": 8},
    "learning": {"batch-size": 4, "control-count": 2, "optimizer": "sgd",
                 "learning-rate": 0.05, "momentum": 0.9},
    "checkpoint": {"save": False},
}

VGG = {
    "model": "VGG16", "dataset": "CIFAR10", "clients": [2, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 8, "compute-dtype": "float32",
    "topology": {"cut-layers": [7]}, "distribution": {"num-samples": 8},
    "learning": {"batch-size": 4, "control-count": 2, "optimizer": "sgd",
                 "learning-rate": 5e-4, "momentum": 0.9},
    "checkpoint": {"save": False},
}

#: id -> (base recipe, overrides, rounds); VGG cases also carry their
#: (validation loss, parameter, update error, statistics) tolerances
CASES = {
    "sda": (LLAMA, {"aggregation": {"strategy": "sda", "local-rounds": 2},
                    "learning": dict(LLAMA["learning"], **{
                        "lr-decay": 0.9, "lr-decay-every": 1})}, 2),
    "relay": (LLAMA, {"aggregation": {"strategy": "relay"}}, 2),
    "cluster_relay": (LLAMA, {"aggregation": {"strategy": "cluster_relay"}},
                      2),
    "periodic": (LLAMA, {"aggregation": {"strategy": "periodic",
                                         "t-client": 1, "t-global": 2}}, 4),
    # seed 6 shuffles the out-clusters: cluster 1 first in round 0
    "fedasync": (LLAMA, {"aggregation": {"strategy": "fedasync"},
                         "topology": dict(LLAMA["topology"],
                                          **{"in-clusters": 2}),
                         "seed": 6}, 2),
    "fedasync_alpha": (LLAMA, {"aggregation": {"strategy": "fedasync",
                                               "fedasync-alpha": 0.5},
                               "topology": dict(LLAMA["topology"],
                                                **{"in-clusters": 2}),
                               "seed": 6}, 2),
}
VGG_CASES = {
    "vgg_relay": (VGG, {"aggregation": {"strategy": "relay"}}, 2,
                  (5e-5, 2e-4, 0.1, 2e-4)),
    "vgg_periodic": (VGG, {"aggregation": {"strategy": "periodic",
                                           "t-client": 1, "t-global": 2}},
                     2, (1e-5, 2e-5, 1e-2, 1e-5)),
}
VGG_DROPOUTS = ("layer46", "layer49")


def _no_dropout(spec_fn, split_mod):
    def specs(**kw):
        return tuple(split_mod.LayerSpec(s.name, fn=split_mod.identity_fn)
                     if s.name in VGG_DROPOUTS else s for s in spec_fn(**kw))
    return specs


@pytest.fixture
def vgg_without_dropout(monkeypatch):
    """Dropout cannot match across frameworks: both registries' VGG16
    gets identity layers in its place, in these cases only."""
    for mod in (jsplit, tsplit):
        monkeypatch.setitem(mod._REGISTRY, "VGG16_CIFAR10", _no_dropout(
            mod._REGISTRY["VGG16_CIFAR10"], mod))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree)))


def _assert_close(jt, tt, tol):
    flat_j, flat_t = _leaves(jt), _leaves(tt)
    assert set(flat_j) == set(flat_t)
    for path, a in flat_j.items():
        np.testing.assert_allclose(flat_t[path], a, rtol=0, atol=tol,
                                   err_msg=str(path))


def _update_error(jt, tt, t0) -> float:
    flat_j, flat_t, flat_0 = _leaves(jt), _leaves(tt), _leaves(t0)
    num = den = 0.0
    for path, a in flat_j.items():
        dj = a.astype(np.float64) - flat_0[path]
        dt = flat_t[path].astype(np.float64) - flat_0[path]
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0, "the JAX package's run moved no parameter"
    return (num / den) ** 0.5


def _configs(tmp_path, base, over, rounds, **extra):
    d = dict(base, **over, **extra)
    d["global-rounds"] = rounds
    d["log-path"] = str(tmp_path)
    return jcfg.from_dict(d), tcfg.from_dict(d)


def _init(jc):
    """The JAX package's initial variables, with VGG16's statistics moved
    off their init so that carrying them matters."""
    v = MeshContext(jc).init_variables()
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    rng = np.random.default_rng(11)
    stats = {layer: {
        "mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(
            np.float32),
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for layer, s in stats.items()}
    return params, stats


def _run_both(tmp_path, jc, tc, p0, s0, wrap=None):
    jctx, tctx = MeshContext(jc), TorchContext(tc, device="cpu")
    if wrap is not None:
        wrap(jctx), wrap(tctx)
    jres = jrun(jc, jctx, jplan(jc, jregs(jc)),
                JLogger(tmp_path / "jax", console=False),
                init_params=p0, init_stats=s0 or None)
    tres = trun(tc, tctx, tplan(tc, tregs(tc)),
                TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0),
                init_stats=from_jax_stats(s0) if s0 else None)
    return jres, tres, tctx


def _assert_history(jres, tres, loss_tol):
    assert len(jres.history) == len(tres.history)
    for a, b in zip(jres.history, tres.history):
        assert (a.round_idx, a.ok, a.num_samples) == \
            (b.round_idx, b.ok, b.num_samples), (a, b)
        assert (a.val_loss is None) == (b.val_loss is None), (a, b)
        if a.val_loss is not None:
            assert abs(a.val_loss - b.val_loss) < loss_tol, (a, b)


#: per strategy: each round's expected sample count at [4, 2] with 8
#: samples a client (SDA: two local epochs) and the rounds validated
EXPECTED = {
    "sda": ([64, 64], [True, True]),
    "relay": ([32, 32], [True, True]),
    "cluster_relay": ([32, 32], [True, True]),
    "periodic": ([32] * 4, [False, True, False, True]),
    "fedasync": ([32, 32], [True, True]),
    "fedasync_alpha": ([32, 32], [True, True]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_matches_jax_package(tmp_path, case):
    base, over, rounds = CASES[case]
    jc, tc = _configs(tmp_path, base, over, rounds)
    p0, _ = _init(jc)
    jres, tres, tctx = _run_both(tmp_path, jc, tc, p0, None)
    _assert_history(jres, tres, 1e-5)
    samples, validated = EXPECTED[case]
    assert [r.num_samples for r in tres.history] == samples
    assert [r.val_loss is not None for r in tres.history] == validated
    final = to_jax_params(tres.params, tctx.full_model)
    _assert_close(jres.params, final, 1e-5)
    assert _update_error(jres.params, final, p0) <= 1e-4


@pytest.mark.parametrize("case", sorted(VGG_CASES))
def test_vgg_strategy_carries_statistics(tmp_path, vgg_without_dropout,
                                         case):
    base, over, rounds, (loss_tol, param_tol, update_tol,
                         stat_tol) = VGG_CASES[case]
    jc, tc = _configs(tmp_path, base, over, rounds)
    p0, s0 = _init(jc)
    jres, tres, tctx = _run_both(tmp_path, jc, tc, p0, s0)
    _assert_history(jres, tres, loss_tol)
    assert [r.num_samples for r in tres.history] == [16, 16]
    final = to_jax_params(tres.params, tctx.full_model)
    _assert_close(jres.params, final, param_tol)
    assert _update_error(jres.params, final, p0) <= update_tol
    stats = to_jax_stats(tres.stats)
    _assert_close(jres.stats, stats, stat_tol)
    # both stages' statistics moved off the START's
    for layer in ("layer2", "layer12"):
        assert not np.array_equal(stats[layer]["var"], s0[layer]["var"])


class _Spy:
    """Records the out-cluster order (each train_cluster call's cluster)
    and every per-merge checkpoint the strategy writes; optionally flags
    one call's updates not ok, as a NaN loss flags them."""

    def __init__(self, fail_call=None):
        self.clusters, self.saves, self.calls = [], [], 0
        self.fail_call = fail_call

    def wrap(self, ctx):
        train = ctx.train_cluster

        def train_cluster(plan, *a, **kw):
            self.calls += 1
            self.clusters.append(plan.cluster_id)
            ups = train(plan, *a, **kw)
            if self.calls == self.fail_call:
                for u in ups:
                    u.ok = False
            return ups
        ctx.train_cluster = train_cluster

    def saver(self, save, to_numpy):
        def spy(directory, model_key, params, stats=None, round_idx=0):
            self.saves.append((round_idx, to_numpy(params)))
            return save(directory, model_key, params, stats,
                        round_idx=round_idx)
        return spy


@pytest.mark.parametrize("fail", [False, True], ids=["clean", "nan_round"])
def test_fedasync_merges_and_checkpoints_match(tmp_path, monkeypatch,
                                               fail):
    """Two rounds at ``in-clusters: 2`` with ``checkpoint.per-merge``:
    the out-cluster order, each per-merge checkpoint (round index and
    parameters) and the checkpoint left on disk agree; with the second
    round's second out-cluster failing, both refuse the round and leave
    the round-entry state on disk."""
    base, over, _ = CASES["fedasync"]
    d = dict(base, **over, **{"global-rounds": 2,
                              "log-path": str(tmp_path)})
    ck = {"save": True, "per-merge": True}
    jc = jcfg.from_dict(dict(d, checkpoint=dict(
        ck, directory=str(tmp_path / "jck"))))
    tc = tcfg.from_dict(dict(d, checkpoint=dict(
        ck, directory=str(tmp_path / "tck"))))
    p0, _ = _init(jc)
    jspy, tspy = (_Spy(fail_call=4 if fail else None) for _ in range(2))
    monkeypatch.setattr(jckpt, "save_checkpoint", jspy.saver(
        jckpt.save_checkpoint,
        lambda t: jax.tree_util.tree_map(np.array, t)))
    tctx_holder = {}

    def to_jax(t):
        return to_jax_params({k: {n: x.clone() for n, x in v.items()}
                              for k, v in t.items()},
                             tctx_holder["ctx"].full_model)
    monkeypatch.setattr(tstrat, "save_checkpoint", tspy.saver(
        tstrat.save_checkpoint, to_jax))

    def wrap(ctx):
        spy = jspy if isinstance(ctx, MeshContext) else tspy
        if not isinstance(ctx, MeshContext):
            tctx_holder["ctx"] = ctx
        spy.wrap(ctx)
    jres, tres, tctx = _run_both(tmp_path, jc, tc, p0, None, wrap=wrap)

    _assert_history(jres, tres, 1e-5)
    assert [r.ok for r in tres.history] == [True, not fail]
    assert jspy.clusters == tspy.clusters == [1, 0, 0, 1]
    # one merge per in-cluster: 2 out-clusters x 2 in-clusters a round
    # (the failing round: its first out-cluster's 2, then the restore)
    want = [0, 0, 0, 0, 1, 1, 1, 1] if not fail else [0, 0, 0, 0, 1, 1, 1]
    assert [r for r, _ in tspy.saves] == [r for r, _ in jspy.saves] == want
    for (_, a), (_, b) in zip(jspy.saves, tspy.saves):
        _assert_close(a, b, 1e-5)
    on_disk_t = tckpt.load_checkpoint(tc.checkpoint.directory, tc.model_key)
    on_disk_j = jckpt.load_checkpoint(jc.checkpoint.directory, jc.model_key)
    assert on_disk_t["round_idx"] == on_disk_j["round_idx"] == (
        1 if fail else 2)
    disk_t = to_jax_params(on_disk_t["params"], tctx.full_model)
    _assert_close(on_disk_j["params"], disk_t, 1e-5)
    final = to_jax_params(tres.params, tctx.full_model)
    _assert_close(disk_t, final, 0.0)
    if fail:
        # the restore wrote the round-entry state: round 0's result
        _assert_close(tspy.saves[-1][1], final, 0.0)


def test_periodic_validates_on_global_boundaries_and_checkpoints_alike(
        tmp_path, monkeypatch):
    """Periodic (``t-client: 1, t-global: 2``, 4 rounds) with checkpoints
    on: both loops validate rounds 1 and 3 only, and both write a
    checkpoint after every round whose weights change only at the
    ``t-global`` boundaries (the non-boundary rounds hand back the
    round-entry weights), so the checkpoints of rounds 0 and 2 hold the
    start and round 1's weights."""
    from split_learning_tpu.runtime import loop as jloop
    from split_learning_torch.runtime import loop as tloop
    base, over, rounds = CASES["periodic"]
    d = dict(base, **over, **{"global-rounds": rounds,
                              "log-path": str(tmp_path)})
    jc = jcfg.from_dict(dict(d, checkpoint={
        "save": True, "directory": str(tmp_path / "jck")}))
    tc = tcfg.from_dict(dict(d, checkpoint={
        "save": True, "directory": str(tmp_path / "tck")}))
    p0, _ = _init(jc)
    saved = {"jax": [], "torch": []}
    holder = {}
    for name, mod, to_np in (
            ("jax", jloop, lambda t: jax.tree_util.tree_map(np.array, t)),
            ("torch", tloop, lambda t: to_jax_params(
                {k: {n: x.clone() for n, x in v.items()}
                 for k, v in t.items()}, holder["ctx"].full_model))):
        def spy(directory, model_key, params, stats=None, round_idx=0,
                _save=mod.save_checkpoint, _name=name, _to_np=to_np):
            saved[_name].append((round_idx, _to_np(params)))
            return _save(directory, model_key, params, stats,
                         round_idx=round_idx)
        monkeypatch.setattr(mod, "save_checkpoint", spy)

    def wrap(ctx):
        if not isinstance(ctx, MeshContext):
            holder["ctx"] = ctx
    jres, tres, _ = _run_both(tmp_path, jc, tc, p0, None, wrap=wrap)
    _assert_history(jres, tres, 1e-5)
    assert [r.val_loss is not None for r in tres.history] == \
        [False, True, False, True]
    assert [r for r, _ in saved["torch"]] == [r for r, _ in saved["jax"]] \
        == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(saved["jax"], saved["torch"]):
        _assert_close(a, b, 1e-5)
    ts = [t for _, t in saved["torch"]]
    _assert_close(p0, ts[0], 1e-6)       # round 0 kept the start
    _assert_close(ts[1], ts[2], 0.0)     # round 2 kept round 1's merge
