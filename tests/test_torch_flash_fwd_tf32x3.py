"""The split-TF32 design of the float32 and D = 8 flash forward
(``flash_fwd_x3_kernel`` in ``csrc/flash_attention.cu``, the
``flash_fwd_simt`` route), its arithmetic emulated in float32 PyTorch on
the CPU and held against the JAX package's forward (``_flash_fwd_bhsd``,
its Pallas kernel run through the interpreter).

The emulation does what the kernel does: Q scaled in float32 and split
into a TF32 head and a TF32 remainder (``cvt.rna``), 64-row Q tiles, K
and V in 32-row steps zero-filled past a ragged S, each product of a k8
step taken as lo*hi + hi*lo + hi*hi (small terms first; a bf16 operand's
lo is 0) into float32 sums, the online softmax in log2 units with m
starting at the finite NEG_INF and the accumulator rescaled once a step,
P split as an A operand of P V, ``o = acc * (1 / l_safe)`` and ``lse =
m ln 2 + log(l_safe)``.  Tolerances: the JAX package's float32 forward
tolerance, 2e-5 of max(1, max|ref|), and chip_smoke.py's bf16 ones
(2^-7 of it for o, 1e-4 for lse) at bf16 D = 8.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_torch.ops import flash_attention as tfa

jfa = importlib.import_module("split_learning_tpu.ops.flash_attention")

FWD_TOL = 2e-5
BF16_O_TOL = 2.0 ** -7
BF16_LSE_TOL = 1e-4
Q_TILE, K_STEP = 64, 32
LOG2E = np.float32(np.log2(np.e))
LN2 = np.float32(np.log(2.0))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does:
    nearest, ties away from zero, on the 13 mantissa bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo + O(2^-22 |x|), both TF32; x - hi is exact."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two dims, k8 steps in order, each adding
    lo(a) hi(b), hi(a) lo(b), then hi(a) hi(b) to the float32 sum."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + a_lo[..., ks] @ b_hi[..., ks, :]
        acc = acc + a_hi[..., ks] @ b_lo[..., ks, :]
        acc = acc + a_hi[..., ks] @ b_hi[..., ks, :]
    return acc


def x3_forward(q, k, v, causal):
    """o and lse of the kernel's design over (BH, S, D) float32 tensors
    (bf16 values for the bf16 route)."""
    bh, s, d = q.shape
    n_q = -(-s // Q_TILE)
    n_k = -(-s // K_STEP)
    rows = n_q * Q_TILE

    def pad(x):
        return torch.cat([x, torch.zeros(bh, rows - s, d)], dim=1)

    q, k, v = pad(q) * np.float32(1.0 / np.sqrt(d)), pad(k), pad(v)
    o, lse = torch.zeros(bh, rows, d), torch.zeros(bh, rows)
    for qb in range(n_q):
        q0 = qb * Q_TILE
        qt = q[:, q0:q0 + Q_TILE]
        qpos = q0 + torch.arange(Q_TILE)[:, None]
        m = torch.full((bh, Q_TILE), np.float32(tfa.NEG_INF))
        l = torch.zeros(bh, Q_TILE)
        acc = torch.zeros(bh, Q_TILE, d)
        n_it = min(n_k, (q0 + Q_TILE) // K_STEP) if causal else n_k
        for it in range(n_it):
            k0 = it * K_STEP
            kt, vt = k[:, k0:k0 + K_STEP], v[:, k0:k0 + K_STEP]
            kpos = k0 + torch.arange(K_STEP)[None, :]
            x = mm_x3(qt, kt.transpose(1, 2))
            seen = (qpos < s) & (kpos < s)
            if causal:
                seen = seen & (kpos <= qpos)
            x = torch.where(seen, x, torch.full_like(x, float("-inf")))
            m_new = torch.maximum(m, x.amax(-1) * LOG2E)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x * LOG2E - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + mm_x3(p, vt)
            m = m_new
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        o[:, q0:q0 + Q_TILE] = acc * (1.0 / l_safe)[..., None]
        lse[:, q0:q0 + Q_TILE] = m * LN2 + torch.log(l_safe)
    return o[:, :s], lse[:, :s]


def _jax_forward(q, k, v, causal):
    block = jfa._pick_block(q.shape[1], 64)
    o, lse = jfa._flash_fwd_bhsd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, True, block, block)
    return np.asarray(o), np.asarray(lse)


def _assert_within(got, want, tol):
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{err} > {bound}"


@pytest.mark.parametrize("s", [48, 80])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 64])
def test_split_tf32_forward_matches_jax_float32_kernel(d, causal, s):
    """The design's o and lse against the JAX package's float32 forward
    (Precision.HIGHEST) at a ragged S: less than one 64-row Q tile, or
    one and a quarter, and 32-key steps past S."""
    rng = np.random.default_rng(10 * d + s + causal)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32)
               for _ in range(3))
    o_j, lse_j = _jax_forward(q, k, v, causal)
    o_t, lse_t = x3_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal)
    _assert_within(o_t.numpy(), o_j, FWD_TOL)
    _assert_within(lse_t.numpy(), lse_j, FWD_TOL)


@pytest.mark.parametrize("s", [48, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_forward_on_bf16_d8(causal, s):
    """bf16 at D = 8 takes the same kernel: K and V are exact in TF32
    (two products for S and two for P V), Q is not once scaled, and o is
    rounded to bf16 once.  Held against the JAX forward on the same bf16
    values at the bf16 tolerances."""
    rng = np.random.default_rng(s + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 8)).astype(
        np.float32)).bfloat16().float() for _ in range(3))
    for x in (k, v):
        hi, lo = split(x)
        assert torch.equal(hi, x) and not lo.any()
    assert split(q * np.float32(1 / np.sqrt(8)))[1].any()
    o_j, lse_j = _jax_forward(q.numpy(), k.numpy(), v.numpy(), causal)
    o_t, lse_t = x3_forward(q, k, v, causal)
    _assert_within(o_t.bfloat16().float().numpy(), o_j, BF16_O_TOL)
    _assert_within(lse_t.numpy(), lse_j, BF16_LSE_TOL)


def test_a_fully_masked_step_changes_nothing():
    """A row whose keys in a step are all masked keeps m at the finite
    NEG_INF start or its running value, gets p = 0 and corr = 1: the
    step leaves it as it was, and no NaN appears."""
    m = torch.tensor([np.float32(tfa.NEG_INF), 3.0])
    x = torch.full((2, K_STEP), float("-inf"))
    m_new = torch.maximum(m, x.amax(-1) * LOG2E)
    assert torch.equal(m_new, m)
    assert torch.equal(torch.exp2(m - m_new), torch.ones(2))
    assert not torch.exp2(x * LOG2E - m_new[:, None]).any()


@pytest.mark.parametrize("at", range(3))
def test_float32_forward_refuses_unaligned_inputs(monkeypatch, at):
    """The forward's 16-byte copies need 16-byte aligned (BH, S, D)
    tensors: an unaligned q, k or v on the ``flash_fwd_simt`` route
    raises before the library is reached, and nothing is counted."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_library", no_library)
    tfa.reset_launches()
    ok = torch.zeros(2, 16, 8)
    shifted = torch.zeros(2 * 16 * 8 + 1)[1:].view(2, 16, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert tfa._fwd_route(ok.dtype, 8) == "flash_fwd_simt"
    args = [ok] * 3
    args[at] = shifted
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(*args, True)
    assert not any(tfa.LAUNCHES.values())
