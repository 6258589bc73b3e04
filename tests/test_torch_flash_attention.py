"""The port's flash attention (plain versions on the CPU) against the JAX
package's Pallas kernels run through the Pallas interpreter.

Tolerances are those of tests/test_flash_attention.py, float32 inputs:
2e-5 for the forward (o and lse), 5e-4 for gradients.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports a function of the same name
jfa = importlib.import_module("split_learning_tpu.ops.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _bshd(seed, b=2, s=32, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _bhsd(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,block", [(64, 16), (48, 16)])
def test_forward_and_lse_match_pallas_kernel(causal, s, block):
    """o and lse of the port's forward against JAX ``_flash_fwd_bhsd``
    (the Pallas kernel, interpreted); S=48 takes pick_block's divisor."""
    q, k, v, _ = (_bhsd(t) for t in _bshd(0, s=s))
    bq = jfa._pick_block(s, block)
    o_j, lse_j = jfa._flash_fwd_bhsd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, True, bq, bq)
    o_t, lse_t = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [32, 48])
def test_gradients_match_jax_flash(causal, s):
    """Gradients through ``_Flash`` (its backward runs the plain dK/dV and
    dQ versions on the CPU) against ``jax.grad`` of the JAX package's
    ``flash_attention`` with its Pallas backward kernels."""
    q, k, v, w = _bshd(1, s=s)

    def loss_j(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=16,
                                  block_k=16, interpret=True)
        return (out * w).sum() + (out ** 2).sum()

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal)
    ((out * torch.from_numpy(w)).sum() + (out ** 2).sum()).backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_versions_match_pallas_kernels(causal):
    """The plain dK/dV and dQ versions, fed the residuals and cotangent
    of the JAX rule, against the JAX backward rule itself."""
    q, k, v, do = (_bhsd(t) for t in _bshd(2, s=32))
    res = jfa._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, True, 16, 16)[1]
    dq_j, dk_j, dv_j = jfa._flash_bwd_rule(causal, True, 16, 16, res,
                                           jnp.asarray(do))
    o = torch.from_numpy(np.array(res[3]))
    lse = torch.from_numpy(np.array(res[4]))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    delta = (dot * o).sum(-1)
    dk, dv = tfa.flash_bwd_dkv(qt, kt, vt, dot, lse, delta, causal)
    dq = tfa.flash_bwd_dq(qt, kt, vt, dot, lse, delta, causal)
    for a, b in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tfa.reset_launches()
    q, k, v, _ = (torch.from_numpy(_bhsd(t)) for t in _bshd(3))
    o, lse = tfa.flash_fwd(q, k, v, True)
    o_ref, lse_ref = tfa.flash_fwd_reference(q, k, v, True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}


def test_tensors_off_cpu_and_cuda_raise():
    """No silent fallback: a device with no kernel raises, and so do
    inputs that span devices."""
    q = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="span devices"):
        tfa.flash_fwd(torch.zeros(2, 8, 8), q, q, True)


def test_bf16_forward_close_to_float32():
    """bf16 inputs: the plain version computes in float32 and rounds the
    output once to bf16 (relative error <= 2^-8 of |o| <= 4)."""
    q, k, v, _ = (torch.from_numpy(_bhsd(t)) for t in _bshd(4, s=48))
    o32, lse32 = tfa.flash_fwd(q, k, v, True)
    o16, lse16 = tfa.flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    # inputs were rounded to bf16 too: allow a few bf16 ulps
    assert float((o16.float() - o32).abs().max()) < 4 * 2 ** -8 * 4
    assert float((lse16 - lse32).abs().max()) < 0.1
