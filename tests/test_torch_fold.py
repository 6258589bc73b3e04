"""The port's streaming fold against the JAX package's, on the CPU, bit for
bit.

The same Update stream, made from a seed with numpy — float leaves with
NaN and inf values, an int32 leaf, three stage-1 clients and two stage-2
clients — folds through the JAX package's ``StreamingFold`` with its
``HostFoldBackend`` and through the port's ``StreamingFold`` with (a) its
numpy host backend and (b) its CUDA backend's code path on CPU tensors,
with the stage-update kernel flag on and off (on the CPU both take the
kernels' plain versions; on the card the flag launches the finalize and
momentum kernels, which ``chip_smoke.py`` holds bit for bit against the
same plain versions).  Arrival is shuffled, one Update is delivered
twice, one client is dropped before it arrives, and two rounds carry
the FedAvgM velocity.

Every parameter and every velocity entry is compared as raw bytes at
``server-momentum`` 0, 0.5 and 0.9: the fold's operations are the same
IEEE float32 operations in the same order in all three, so 0.9 is
bitwise too (measured, not assumed: this test is the measurement).
"""

import copy

import numpy as np
import pytest
import torch

from split_learning_tpu.runtime.aggregate import (
    HostFoldBackend as JHost, StreamingFold as JFold,
)
from split_learning_tpu.runtime.protocol import Update as JUpdate
from split_learning_torch.ops.kernels import KernelPlan
from split_learning_torch.runtime.aggregate import (
    CudaFoldBackend, HostFoldBackend, StreamingFold, UpdateBatch,
)
from split_learning_torch.runtime.protocol import Update
from split_learning_torch.runtime.strategies import aggregate_cluster

STAGE_OF = {"a": 1, "b": 1, "c": 1, "x": 2, "y": 2}
EXPECTED = {1: ["a", "b", "c"], 2: ["x", "y"]}


def _tree(rng, stage: int) -> dict:
    if stage == 1:
        w = (rng.standard_normal((5, 7)) * 2).astype(np.float32)
        w[rng.random(w.shape) < 0.1] = np.nan
        w[0, 1] = np.inf
        return {"layer1": {"weight": w,
                           "count": rng.integers(-9, 9, (4,)).astype(
                               np.int32)}}
    return {"layer2": {"weight": rng.standard_normal((3, 6)).astype(
        np.float32)},
        "layer3": {"bias": rng.standard_normal((6,)).astype(np.float32)}}


def _base(rng) -> dict:
    return {"layer1": {"weight": rng.standard_normal((5, 7)).astype(
        np.float32), "count": np.zeros(4, np.int32)},
        "layer2": {"weight": rng.standard_normal((3, 6)).astype(np.float32)},
        "layer3": {"bias": rng.standard_normal((6,)).astype(np.float32)}}


def _stream(seed: int):
    """One round's arrivals: shuffled, 'b' delivered twice, 'c' dropped."""
    rng = np.random.default_rng(seed)
    ups = [(cid, _tree(rng, s), int(rng.integers(1, 40)))
           for cid, s in STAGE_OF.items()]
    order = [ups[i] for i in rng.permutation(len(ups))]
    order.insert(int(rng.integers(0, len(order))), next(
        u for u in ups if u[0] == "b"))
    return [u for u in order if u[0] != "c"]


def _run(make_fold, make_update, base, momentum, velocity, seed):
    fold = make_fold()
    fold.drop(1, "c")
    for cid, tree, n in _stream(seed):
        fold.add_update(make_update(cid, tree, n))
    return fold.finish(base=base if momentum else None, momentum=momentum,
                       velocity=velocity if momentum else None)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(jt: dict, tt: dict) -> None:
    from split_learning_torch.ops.fedavg import walk_items
    flat_j, flat_t = dict(walk_items(jt)), dict(walk_items(tt))
    assert flat_j.keys() == flat_t.keys()
    for path, a in flat_j.items():
        b = _np(flat_t[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


BACKENDS = {
    "host": HostFoldBackend,
    "cuda_path_kernels": lambda: CudaFoldBackend(
        device="cpu", kernels=KernelPlan(stage_update=True)),
    "cuda_path_plain": lambda: CudaFoldBackend(
        device="cpu", kernels=KernelPlan(stage_update=False)),
}


# the inf leaf saturates to float32 max and its weighted contribution
# overflows to inf in every fold alike; numpy warns of the overflow and of
# the inf - inf that follows
@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_streaming_fold_matches_jax_host_fold(backend, momentum):
    base = _base(np.random.default_rng(100))
    jvel, tvel = {}, {}
    for rnd in range(2):   # round 2 reads the velocity round 1 left
        jres = _run(lambda: JFold(EXPECTED, backend=JHost()),
                    lambda c, t, n: JUpdate(c, STAGE_OF[c], 0,
                                            copy.deepcopy(t), n),
                    base, momentum, jvel, seed=rnd)
        tres = _run(lambda: StreamingFold(EXPECTED,
                                          backend=BACKENDS[backend]()),
                    lambda c, t, n: Update(c, STAGE_OF[c], 0,
                                           copy.deepcopy(t), n),
                    base, momentum, tvel, seed=rnd)
        _assert_bitwise(jres.params, tres.params)
        assert tres.n_samples == jres.n_samples
        assert (tres.folded, tres.window_hwm) == (jres.folded,
                                                   jres.window_hwm)
        assert {p: _np(v).tobytes() for p, v in tvel.items()} == {
            p: np.asarray(v).tobytes() for p, v in jvel.items()}
        base = jres.params   # next round starts from the folded params
    if momentum:
        assert set(tvel) == {("layer1", "weight"), ("layer2", "weight"),
                             ("layer3", "bias")}


def test_duplicates_are_counted_and_the_batch_carries_the_fold():
    from split_learning_torch.runtime.trace import FaultCounters
    faults = FaultCounters()
    fold = StreamingFold(EXPECTED, backend=HostFoldBackend(),
                         faults=faults)
    fold.drop(1, "c")
    ups = []
    for cid, tree, n in _stream(7):
        u = Update(cid, STAGE_OF[cid], 0, tree, n)
        fold.add_update(u)
        ups.append(Update(cid, STAGE_OF[cid], 0, None, n))
    assert faults.snapshot() == {"agg_dup_drops": 1}
    res = fold.finish()
    assert fold.finish() is res   # idempotent
    batch = UpdateBatch(ups)
    batch.fold = res
    params, stats, n = aggregate_cluster(batch)
    assert params is res.params and n == res.n_samples
    # stage-1 samples of a and b (c was dropped, b's duplicate ignored)
    first: dict = {}
    for cid, _, samples in _stream(7):
        first.setdefault(cid, samples)
    assert n == first["a"] + first["b"]
