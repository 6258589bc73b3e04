"""The bf16 cross entropy of the port against the JAX package's, on the
CPU.

Two losses meet bf16 logits:

* the in-process pipeline's ``loss_from_logits`` (port
  ``parallel/pipeline.py``; JAX ``parallel/pipeline.py``
  ``PipelineModel.loss_from_logits``), which reduces the logits in their
  own dtype: optax's per-token cross entropy, then ``.mean()``;
* the protocol's last-stage client (port ``runtime/client.py``
  ``ShardRunner.last_step``; JAX ``runtime/client.py`` ``last_step``),
  which casts the logits to float32 first.

Logits of shape (512, 32000) and (2, 8, 64), σ = 3, from a numpy seed.
Tolerances, as measured on this CPU:

* pipeline loss: equal.  ``F.cross_entropy``'s own mean reduction of
  bf16 was one bf16 ulp (0.0625) off optax on the large shape (14.625
  against 14.6875; float32 gives 14.6939), which the port no longer
  uses;
* pipeline logit gradients: within one bf16 ulp of the largest gradient
  (2^-8 of max |g|; measured exactly that on both shapes);
* client loss: within 1e-6 relative;
* client logit gradients: within 2^-10 of max |g| (measured 2^-11 of
  it: the float32 gradients round to bf16 on a tie the other way).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu.parallel.pipeline import PipelineModel as JPipe
from split_learning_torch.parallel.pipeline import PipelineModel as TPipe
from split_learning_torch.runtime.client import ShardRunner

SHAPES = [(512, 32000), (2, 8, 64)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    return xj, xt, labels


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pipeline_bf16_loss_matches_optax(shape):
    xj, xt, labels = _inputs(shape)
    stub = types.SimpleNamespace(loss_name="softmax_cross_entropy")
    lj, gj = jax.value_and_grad(
        lambda a: JPipe.loss_from_logits(stub, a, jnp.asarray(labels)))(xj)
    xt.requires_grad_(True)
    lt = TPipe.loss_from_logits(xt, torch.from_numpy(labels))
    lt.backward()
    assert lt.dtype == torch.bfloat16 and lj.dtype == jnp.bfloat16
    assert float(lt) == float(lj), (float(lt), float(lj))
    gj = _f32(gj)
    assert np.abs(_f32(xt.grad) - gj).max() <= 2.0 ** -8 * np.abs(gj).max()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_last_stage_client_loss_matches_jax_client(shape):
    """The port's ``ShardRunner.last_step`` on an identity model (so its
    input gradient is the logits' gradient) against the JAX client's
    last-stage loss, ``optax...(out.astype(float32), labels).mean()``."""
    xj, xt, labels = _inputs(shape, seed=1)
    lj, gj = jax.value_and_grad(
        lambda a: optax.softmax_cross_entropy_with_integer_labels(
            a.astype(jnp.float32), jnp.asarray(labels)).mean())(xj)
    runner = ShardRunner.__new__(ShardRunner)
    runner.model = lambda x, train: x
    lt, gt = runner.last_step(xt, torch.from_numpy(labels))
    assert lt.dtype == torch.float32 and gt.dtype == torch.bfloat16
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    gj = _f32(gj)
    assert np.abs(_f32(gt) - gj).max() <= 2.0 ** -10 * np.abs(gj).max()
