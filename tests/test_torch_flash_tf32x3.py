"""The split-TF32 design of the float32 and D = 8 flash backward
(``flash_bwd_dkv_x3_kernel`` and ``flash_bwd_dq_x3_kernel`` in
``csrc/flash_attention.cu``), its arithmetic emulated in float32 PyTorch
on the CPU and held against the JAX package's float32 backward rule
(its Pallas kernels run through the interpreter).

The emulation does what the kernels do: TF32 rounding as ``cvt.rna``
does it, each float32 operand split into a TF32 head and a TF32
remainder, each product of a k8 step taken as lo*hi + hi*lo + hi*hi
(small terms first) into float32 sums, 64-row tiles zero-filled past a
ragged S, the dK/dV loop over Q tiles from the causal start and the dQ
loop up to the diagonal, p in log2 units.  Tolerance: the JAX package's
float32 gradient tolerance, 5e-4 of max(1, max|ref|), as chip_smoke.py
holds the kernels on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("split_learning_tpu.ops.flash_attention")

GRAD_TOL = 5e-4
TILE = 64
LOG2E = float(np.log2(np.e))


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
    """a @ b over the last two dims as the kernels take it: k8 steps in
    order, each adding lo(a) hi(b), hi(a) lo(b), then hi(a) hi(b) to the
    float32 sum (each TF32 product is exact in float32)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + a_lo[..., ks] @ b_hi[..., ks, :]
        acc = acc + a_hi[..., ks] @ b_lo[..., ks, :]
        acc = acc + a_hi[..., ks] @ b_hi[..., ks, :]
    return acc


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows past S, as the kernels' zero-filled copies give them."""
    pad = torch.zeros(x.shape[0], rows - x.shape[1], *x.shape[2:])
    return torch.cat([x, pad], dim=1)


def _visible(q0, k0, s, causal):
    qpos = q0 + torch.arange(TILE)[:, None]
    kpos = k0 + torch.arange(TILE)[None, :]
    ok = (qpos < s) & (kpos < s)
    return ok & (kpos <= qpos) if causal else ok


def x3_backward(q, k, v, do, lse, delta, causal):
    """dq, dk, dv of the split-TF32 kernels' design, over (BH, S, D)
    float32 tensors."""
    bh, s, d = q.shape
    n = -(-s // TILE)
    q, k, v, do = (_pad(t, n * TILE) for t in (q, k, v, do))
    lse, delta = _pad(lse, n * TILE), _pad(delta, n * TILE)
    scale = 1.0 / np.sqrt(d)
    scale_log2 = np.float32(scale * LOG2E)

    def tile(x, b):
        return x[:, b * TILE:(b + 1) * TILE]

    def probs_and_ds(qb, kb):
        """p and ds of one (Q tile, K tile) pair, (BH, 64 queries, 64
        keys), as the kernels rebuild them."""
        st = mm_x3(tile(q, qb), tile(k, kb).transpose(1, 2))
        dp = mm_x3(tile(do, qb), tile(v, kb).transpose(1, 2))
        lse_t, delta_t = tile(lse, qb)[..., None], tile(delta, qb)[..., None]
        p = torch.exp2(st * scale_log2 - lse_t * np.float32(LOG2E))
        p = torch.where(_visible(qb * TILE, kb * TILE, s, causal), p,
                        torch.zeros_like(p))
        return p, p * (dp - delta_t) * np.float32(scale)

    dk, dv, dq = (torch.zeros(bh, n * TILE, d) for _ in range(3))
    for kb in range(n):   # dK/dV: one block per K tile
        acc_k, acc_v = torch.zeros(bh, TILE, d), torch.zeros(bh, TILE, d)
        for qb in range(kb if causal else 0, n):
            p, ds = probs_and_ds(qb, kb)
            acc_v = acc_v + mm_x3(p.transpose(1, 2), tile(do, qb))
            acc_k = acc_k + mm_x3(ds.transpose(1, 2), tile(q, qb))
        dk[:, kb * TILE:(kb + 1) * TILE] = acc_k
        dv[:, kb * TILE:(kb + 1) * TILE] = acc_v
    for qb in range(n):   # dQ: one block per Q tile
        acc_q = torch.zeros(bh, TILE, d)
        for kb in range(qb + 1 if causal else n):
            _, ds = probs_and_ds(qb, kb)
            acc_q = acc_q + mm_x3(ds, tile(k, kb))
        dq[:, qb * TILE:(qb + 1) * TILE] = acc_q
    return dq[:, :s], dk[:, :s], dv[:, :s]


@pytest.mark.parametrize("s", [48, 80])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_split_tf32_backward_matches_jax_float32_rule(d, causal, s):
    """The design's dq, dk and dv against the JAX package's float32
    backward (Precision.HIGHEST), fed the same residuals, at a ragged S
    (one and a half 64-row tiles, or less than one)."""
    rng = np.random.default_rng(100 * d + s + causal)
    q, k, v, do = (rng.standard_normal((2, s, d)).astype(np.float32)
                   for _ in range(4))
    block = jfa._pick_block(s, 64)
    res = jfa._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, True, block, block)[1]
    grads_j = jfa._flash_bwd_rule(causal, True, block, block, res,
                                  jnp.asarray(do))
    o = torch.from_numpy(np.array(res[3]))
    lse = torch.from_numpy(np.array(res[4]))
    dot = torch.from_numpy(do)
    delta = (dot * o).sum(-1)
    grads_t = x3_backward(*(torch.from_numpy(x) for x in (q, k, v)), dot,
                          lse, delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        b = np.asarray(b)
        tol = GRAD_TOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a.numpy() - b).max())
        assert err <= tol, f"{name}: {err} > {tol}"


def test_split_tf32_is_near_float32_and_one_tf32_product_is_not():
    """Three TF32 products keep a float32 product's accuracy (the
    emulated scores within 1e-5 of a float64 product); one product of
    the TF32 heads loses about three decimal digits."""
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)) for _ in range(2))
    exact = a.double() @ b.double()
    err_x3 = float((mm_x3(a, b).double() - exact).abs().max())
    err_x1 = float((tf32_rna(a) @ tf32_rna(b) - exact).abs().max())
    assert err_x3 < 1e-5 < 1e-3 < err_x1


def test_bf16_inputs_split_exactly_and_take_one_product():
    """bf16 values (the D = 8 route's bf16 inputs) are exact in TF32: the
    split's lo is 0, each product of two such values is exact in float32,
    and one product per k8 step gives S = Q K^T and dP = dO V^T bit for
    bit as the three do."""
    rng = np.random.default_rng(8)
    q, k = (torch.from_numpy(rng.standard_normal((2, 48, 8)).astype(
        np.float32)).bfloat16().float() for _ in range(2))
    for x in (q, k):
        hi, lo = split(x)
        assert torch.equal(hi, x) and not lo.any()
    assert torch.equal((q[..., :, None] * k[..., None, :]).double(),
                       q.double()[..., :, None] * k.double()[..., None, :])
    kt = k.transpose(1, 2)
    assert torch.equal(mm_x3(q, kt), q @ kt)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_rounding_is_nearest_ties_away_from_zero(sign):
    """cvt.rna on the 13 dropped bits: below half rounds down, half and
    above round away from zero, for both signs; the largest finite float
    rounds past the largest TF32 value to infinity; TF32 values stay."""
    one = 1.0
    ulp = 2.0 ** -10   # TF32's spacing at 1
    cases = [(one + 0.5 * ulp, one + ulp),            # a tie: away
             (one + 0.5 * ulp - 2.0 ** -23, one),      # just below: down
             (one + 1.5 * ulp, one + 2 * ulp),         # a tie: away
             (one + ulp, one + ulp),                   # already TF32
             (float(np.finfo(np.float32).max), float("inf"))]
    x = torch.tensor([sign * c for c, _ in cases], dtype=torch.float32)
    want = torch.tensor([sign * w for _, w in cases], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    exact = x[[0, 2, 3]]   # remainders that TF32 holds exactly
    hi, lo = split(exact)
    assert torch.equal(hi + lo, exact)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_float32_route_refuses_unaligned_inputs(monkeypatch, kernel):
    """The split-TF32 pair's 16-byte copies need 16-byte aligned (BH, S,
    D) tensors: an unaligned q, k, v or dO raises before the library is
    reached, and nothing is counted."""
    from split_learning_torch.ops import flash_attention as tfa

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfa, "_library", no_library)
    tfa.reset_launches()
    launch = {"dkv": tfa._launch_dkv, "dq": tfa._launch_dq}[kernel]
    ok = torch.zeros(2, 16, 8)
    rows = torch.zeros(2, 16)
    shifted = torch.zeros(2 * 16 * 8 + 1)[1:].view(2, 16, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for at in range(4):
        args = [ok] * 4
        args[at] = shifted
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch("simt", *args, rows, rows, True)
    assert not any(tfa.LAUNCHES.values())
