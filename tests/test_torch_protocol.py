"""The port's in-process protocol round against the JAX package's, on the
CPU.

A tiny float32 TinyLlama (the shape of tests/test_torch_round.py's TINY)
with ``clients: [1, 1, 1]`` — three stages, so the middle stage's relay
runs — goes through both packages' ``ProtocolServer`` in the calling
thread and one ``ProtocolClient`` thread per client over a shared
``InProcTransport``, for two rounds, from the same initial weights
(carried across by ``convert.from_jax_params``).  The sharded fold runs
with ``server-momentum: 0.9`` and the stage-update kernels on (the JAX
package's under the Pallas interpreter, the port's plain versions), so
round 2's momentum step reads round 1's velocity.

``control-count: 1`` keeps each stage-1 client in lockstep (one batch in
flight), so the order in which every stage steps its optimizer is fixed
in both packages; with more in flight it depends on thread timing.

Tolerances:

* float32 wire: samples equal; validation loss within 1e-4; final
  parameters within 1e-4 (slice 1's round tolerances: float32
  summation order through 8 AdamW steps a stage a round).
* int8 codec on both cut directions: samples equal; validation loss
  within 1e-4; every parameter within 1e-2, and at least 99% of them
  within 1e-4.  A code can flip by one at a .5 boundary when the two
  packages' activations differ by float32 noise; that moves one value by
  a quantization step (1/127 of its tile's absmax) and can turn the sign
  of one AdamW step (at most lr = 1e-3) of the parameters it feeds,
  which the 0.9 server momentum carries into round 2.  Measured on this
  config: loss 2.5e-6 and 1.6e-5 apart in rounds 1 and 2; 106 of 26784
  parameters (0.4%) more than 1e-4 apart, 18 more than 1e-3, the
  largest 4.5e-3 (the parameters moved up to 2.3e-2 from their
  initial values).  A systematic fault (a wrong scale, a lost nibble)
  moves most parameters, which the 99% bulk check catches.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.runtime.server import run_inproc

TINY_PROTOCOL = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 32, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 64,
                     "n_block": 2, "use_flash": True},
    "topology": {"cut-layers": [2, 3]}, "distribution": {"num-samples": 32},
    "aggregation": {"strategy": "fedavg", "sharded": True,
                    "server-momentum": 0.9},
    "kernels": {"stage-update": True},
    "transport": {"wire-dtype": "float32"},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "adamw",
                 "learning-rate": 1e-3},
    "checkpoint": {"save": False},
}

INT8 = {"transport": {"wire-dtype": "float32",
                      "codec": {"intermediate": "int8", "gradient": "int8"}},
        "kernels": {"quantize": True, "dequantize": True,
                    "stage-update": True}}


def _serve(server, clients, **kw):
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server.serve(**kw)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "client thread failed to stop"
    return result


def run_jax(cfg, p0):
    bus = JBus()
    server = JServer(cfg, transport=bus, client_timeout=120)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": {}}
    clients = [JClient(cfg, f"client_{s}_{i}", s, transport=bus)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    return _serve(server, clients)


def run_torch(cfg, init_params=None):
    run = run_inproc(cfg, device="cpu", client_timeout=120,
                     init_params=init_params)
    return run.server, run.clients, run.result


def _configs(tmp_path, over):
    d = dict(TINY_PROTOCOL, **over, **{"log-path": str(tmp_path)})
    return jcfg.from_dict(d), tcfg.from_dict(d)


@pytest.mark.parametrize("variant,over,tol,bulk", [
    ("fp32_wire", {}, 1e-4, 1.0),
    ("int8_codec", INT8, 1e-2, 0.99),
])
def test_protocol_round_matches_jax_package(tmp_path, variant, over, tol,
                                            bulk):
    from split_learning_tpu.runtime.context import MeshContext
    jc, tc = _configs(tmp_path / variant, over)
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    jres = run_jax(jc, p0)
    server, _, tres = run_torch(tc, init_params=from_jax_params(p0))

    assert len(jres.history) == len(tres.history) == 2
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok
        assert a.num_samples == b.num_samples == 32
        assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = to_jax_params(tres.params, server.ctx.full_model)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(final_t))
    assert len(flat_j) == len(flat_t)
    close = total = 0
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], leaf, rtol=tol, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(flat_t[path] - leaf) <= 1e-4).sum())
        total += leaf.size
    assert close >= bulk * total, (close, total)


def test_two_edge_clients_are_folded(tmp_path):
    """Port only: two stage-1 clients feed one stage-2 client; both edge
    shards reach the fold (3 contributions, 64 samples a round), the
    velocity of every stage is carried on, and the kernels' plain
    versions ran (no CUDA launch on the CPU)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    d = dict(TINY_PROTOCOL, **INT8, **{"log-path": str(tmp_path)})
    d.update({"clients": [2, 1], "topology": {"cut-layers": [2]}})
    tc = tcfg.from_dict(d)
    kq.reset_launches()
    ku.reset_launches()
    server, clients, res = run_torch(tc)
    assert [(r.ok, r.num_samples) for r in res.history] == [(True, 64)] * 2
    fold = server.ctx.last_fold
    assert fold.folded == 3 and fold.n_samples == 64
    vel = server.ctx._agg_velocity[0]
    assert set(vel) == {(layer, k) for layer, sd in res.params.items()
                        for k in sd}
    for c in clients[:2]:
        assert c.raw_bytes_out   # the edge clients' activations, int8
    assert all(n == 0 for n in (*kq.LAUNCHES.values(),
                                *ku.LAUNCHES.values()))
    for sd in res.params.values():
        for t in sd.values():
            assert torch.isfinite(t).all()
