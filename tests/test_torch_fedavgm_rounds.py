"""Two FedAvgM rounds of the VGG16 protocol round: the port against the
JAX package, on the CPU.

On the card, baseline 1's validation loss jumps after the second
server-momentum round (``aggregation.server-momentum: 0.9``).  FedAvgM
moves the weights by ``v' = m·v + (base − avg)``, ``new = base − v'``:
the first round lands on the plain average, the second extrapolates by
0.9 of the first round's step, while the BatchNorm running statistics
fold as a plain average in both packages.  This test runs that round
twice in each package, from the same weights and statistics, and holds
the two against each other: if the port moved differently, the jump
would be a fault of the port; if they agree, it is the reference's own
behaviour.

The recipe is ``tests/test_torch_vgg_round.py``'s int8 protocol round
(``[1, 1]``, float32 compute, 2 steps of 4 samples a round, the int8
codec on both cut directions, the CUDA fold backend) with
``global-rounds: 2``, ``server-momentum: 0.9`` and dropout swapped for
the identity in each package's registry.  The kernel flags stay off:
the codec and stage-update kernels equal their plain chains bit for bit
(``tests/test_torch_codec.py``, ``tests/test_torch_fold.py``), and the
JAX package's Pallas interpreter would take most of the test's time.

Held, round by round: the sample count exactly and the validation
loss within 1e-4 of the JAX package's in round 1 (measured 1.9e-5) and
2e-4 in round 2 (measured 7.1e-5: the velocity carries round 1's noise
into round 2).  After round 2: every parameter within 2e-3 (measured
6.2e-4, the first conv's kernel) and 99.8 % of them within 1e-4
(measured 99.88 %; the one-round int8 protocol round's bounds are 1e-3
and 99.9 %); every BatchNorm statistic within 2e-2 (measured 9.2e-3, a
running variance of 1.12 in layer 36: batch-4 variances through two
rounds of int8 code flips; one round's bound is 5e-3).  The
extrapolation itself is held bit for bit in the port: with ``base`` the
weights each round starts from and ``avg`` its fold's plain average,
round 2 lands on ``base1 − (0.9·(base0 − avg0) + (base1 − avg1))``,
the JAX package's FedAvgM step with round 1's velocity, and round 1 on
its own average.
"""

import threading

import jax
import numpy as np
import pytest

from split_learning_tpu import config as jcfg
from split_learning_tpu.models import split as jsplit
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_params, from_jax_stats, to_jax_params, to_jax_stats,
)
from split_learning_torch.models import split as tsplit
from split_learning_torch.runtime import aggregate as tagg
from split_learning_torch.runtime.server import run_inproc

NAME = "VGG16_CIFAR10"
DROPOUTS = ("layer46", "layer49")

CFG = {
    "model": "VGG16", "dataset": "CIFAR10", "global-rounds": 2,
    "clients": [1, 1], "compute-dtype": "float32",
    "synthetic-size": 64, "val-max-batches": 2, "val-batch-size": 8,
    "topology": {"cut-layers": [7]}, "distribution": {"num-samples": 8},
    "transport": {"wire-dtype": "float32",
                  "codec": {"intermediate": "int8", "gradient": "int8"}},
    "aggregation": {"strategy": "fedavg", "sharded": True,
                    "server-momentum": 0.9},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "sgd",
                 "learning-rate": 5e-4, "momentum": 0.9},
    "checkpoint": {"save": False},
}


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
    init, as numpy trees (``tests/test_torch_vgg_round.py``'s)."""
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
    flat_j, flat_t = _leaves(jt), _leaves(tt)
    assert set(flat_j) == set(flat_t)
    close = total = 0
    for path, a in flat_j.items():
        np.testing.assert_allclose(flat_t[path], a, rtol=0, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(flat_t[path] - a) <= 1e-4).sum())
        total += a.size
    assert close >= bulk_frac * total, (close, total)


def _means(fold):
    """The plain FedAvg average ``acc / total_w`` of every leaf a
    fold holds, keyed (layer, key), before its finish consumes it."""
    out = {}
    for st in fold._stages.values():
        for path, acc in st.acc.items():
            out[path] = (np.asarray(acc, np.float32)
                         / np.float32(st.total_w))
    return out


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
        t.join(timeout=60)
        assert not t.is_alive(), "client thread failed to stop"
    return result


def test_two_fedavgm_rounds_match_the_jax_package(tmp_path, init_vars,
                                                  monkeypatch):
    p0, s0 = init_vars
    d = dict(CFG, **{"log-path": str(tmp_path)})
    jres = _serve_jax(jcfg.from_dict(d), p0, s0)

    # the port's per-round fold results: the trained parameters after
    # each round and the plain FedAvg average the momentum step used
    finished = []
    finish = tagg.StreamingFold.finish

    def spy(fold, base=None, momentum=0.0, velocity=None, **kw):
        avg = _means(fold)
        out = finish(fold, base=base, momentum=momentum,
                     velocity=velocity, **kw)
        finished.append((base, avg, out.params))
        return out
    monkeypatch.setattr(tagg.StreamingFold, "finish", spy)
    run = run_inproc(tcfg.from_dict(d), device="cpu", client_timeout=300,
                     init_params=from_jax_params(p0),
                     init_stats=from_jax_stats(s0))
    tres = run.result

    assert len(jres.history) == len(tres.history) == 2
    for i, (a, b) in enumerate(zip(jres.history, tres.history)):
        assert a.ok and b.ok and a.num_samples == b.num_samples == 8
        assert abs(a.val_loss - b.val_loss) < (1e-4, 2e-4)[i], (a, b)
        assert abs(a.val_accuracy - b.val_accuracy) <= 1 / 16 + 1e-9, (a, b)
    trained = to_jax_params(tres.params, run.server.ctx.full_model)
    _assert_trees(jres.params, trained, 2e-3, 0.998)
    _assert_trees(jres.stats, to_jax_stats(tres.stats), 2e-2, 0.0)

    # the second round extrapolates: new = avg1 - 0.9 * (base0 - avg0)
    # with base1 = avg0 (round 0 lands on the plain average)
    assert len(finished) == 2
    (b0, avg0, new0), (b1, avg1, new1) = finished
    for layer, leaves in new1.items():
        for k, t in leaves.items():
            base0 = b0[layer][k].cpu().numpy()
            base1 = b1[layer][k].cpu().numpy()
            a0, a1 = avg0[(layer, k)], avg1[(layer, k)]
            np.testing.assert_allclose(np.asarray(new0[layer][k]), a0,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(base1, a0, rtol=0, atol=1e-6)
            want = base1 - (np.float32(0.9) * (base0 - a0) + (base1 - a1))
            np.testing.assert_array_equal(np.asarray(t), want,
                                          err_msg=f"{layer}.{k}")
