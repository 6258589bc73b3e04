"""The port's flash attention (plain versions on the CPU) against the JAX
package's Pallas kernels run through the Pallas interpreter.

Tolerances are those of tests/test_flash_attention.py, float32 inputs:
2e-5 for the forward (o and lse), 5e-4 for gradients.  The bf16
tensor-core forward's and backward's numerics are rehearsed here in
float32 PyTorch (``_tc_forward_emulation``, ``_tc_backward_emulation``)
at chip_smoke.py's bf16 tolerances: 2^-7 of max(1, max|ref|) for o, dq,
dk and dv, 1e-4 of it for lse.
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
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_fwd_simt": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv_simt": 0, "flash_bwd_dq_simt": 0}


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


# --------------------------------------------------------------------------
# the bf16 tensor-core forward: its numerics rehearsed, its route, its checks
# --------------------------------------------------------------------------

TC_TILE = 64
BF16_O_TOL = 2.0 ** -7
BF16_LSE_TOL = 1e-4


def _tc_forward_emulation(q, k, v, causal):
    """The design of ``flash_fwd_tc_kernel`` in float32 PyTorch, over
    (BH, S, D) float32 tensors holding bf16 values: 64-row Q and K tiles,
    exact products summed in float32, the online softmax in log2 units
    (the max taken on the raw scores, then scaled by scale*log2(e);
    p = 2^(s*scale*log2(e) - m)) with m starting at the finite NEG_INF, l
    summed from the float32 p, p rounded to bf16 before P V, o = acc /
    l_safe rounded to bf16, and lse converted back to natural log."""
    bh, s, d = q.shape
    scale_log2 = (1.0 / np.sqrt(d)) * np.log2(np.e)
    o = torch.zeros(bh, s, d)
    lse = torch.zeros(bh, s)
    n_tiles = -(-s // TC_TILE)
    for qb in range(n_tiles):
        q0 = qb * TC_TILE
        qt = q[:, q0:q0 + TC_TILE]
        rows = q0 + torch.arange(qt.shape[1])
        m = torch.full((bh, qt.shape[1]), tfa.NEG_INF)
        l = torch.zeros(bh, qt.shape[1])
        acc = torch.zeros(bh, qt.shape[1], d)
        for kb in range(min(n_tiles, qb + 1) if causal else n_tiles):
            k0 = kb * TC_TILE
            kt, vt = k[:, k0:k0 + TC_TILE], v[:, k0:k0 + TC_TILE]
            x = torch.matmul(qt, kt.transpose(1, 2))
            cols = k0 + torch.arange(kt.shape[1])
            if causal:
                x = x.masked_fill(cols[None, :] > rows[:, None],
                                  float("-inf"))
            m_new = torch.maximum(m, x.amax(-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x * scale_log2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.bfloat16().float(), vt)
            m = m_new
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        o[:, q0:q0 + TC_TILE] = (acc / l_safe[..., None]).bfloat16().float()
        lse[:, q0:q0 + TC_TILE] = torch.where(
            l > 0, m * np.log(2.0) + torch.log(l_safe),
            torch.full_like(l, tfa.NEG_INF))
    return o, lse


def _bf16_values(seed, bh, s, d):
    """Three (BH, S, D) float32 arrays holding bf16-representable values."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).bfloat16().float().numpy() for _ in range(3)]


@pytest.mark.parametrize("s,causal", [(256, True), (48, True), (100, False)])
def test_tensor_core_forward_numerics_match_pallas_kernel(s, causal):
    """The tensor-core design's numerics (bf16 P, log2-unit softmax,
    64-row tiles over a ragged S) against the JAX Pallas forward run
    through the interpreter on the same bf16 values, at D = 64."""
    q, k, v = _bf16_values(10 + s, 2, s, 64)
    block = jfa._pick_block(s, 64)
    o_j, lse_j = jfa._flash_fwd_bhsd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, True, block,
                                     block)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_t, lse_t = _tc_forward_emulation(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
    o_tol = BF16_O_TOL * max(1.0, float(np.abs(o_j).max()))
    lse_tol = BF16_LSE_TOL * max(1.0, float(np.abs(lse_j).max()))
    assert float(np.abs(o_t.numpy() - o_j).max()) <= o_tol
    assert float(np.abs(lse_t.numpy() - lse_j).max()) <= lse_tol


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_route(dtype, d):
    """bf16 at D >= 16 takes the tensor-core forward; float32 (full
    float32 products) and D = 8 (narrower than the k16 step) take the
    CUDA-core one.  Every route has its own launch count."""
    want = ("flash_fwd" if dtype == torch.bfloat16 and d >= 16
            else "flash_fwd_simt")
    assert tfa._fwd_route(dtype, d) == want
    assert want in tfa.LAUNCHES


def _fault_inputs(fault, dtype=torch.bfloat16):
    """(q, k, v, do, lse, delta) of ``dtype`` with one thing a kernel does
    not take (none for ``fault=None``)."""
    bh, s, d = 2, 16, 16
    q, k, v, do = (torch.zeros(bh, s, d, dtype=dtype) for _ in range(4))
    lse, delta = torch.zeros(bh, s), torch.zeros(bh, s)
    if fault == "dtype":
        q = q.half()
    elif fault == "head dim":
        q = torch.zeros(bh, s, 24, dtype=dtype)
    elif fault == "non-contiguous":
        k = torch.zeros(bh, d, s, dtype=dtype).transpose(1, 2)
    elif fault == "mixed devices":
        v = torch.zeros(bh, s, d, dtype=dtype, device="meta")
    return q, k, v, do, lse, delta


# each kernel through its public wrapper, with inputs of a dtype its route
# takes (bf16 for the tensor-core kernels, float32 for the CUDA-core ones)
_WRAPPERS = {
    "flash_fwd": (lambda q, k, v, do, lse, delta: tfa.flash_fwd(q, k, v, True),
                  torch.bfloat16),
    "flash_fwd_simt": (
        lambda q, k, v, do, lse, delta: tfa.flash_fwd(q, k, v, True),
        torch.float32),
    "flash_bwd_dkv": (lambda *a: tfa.flash_bwd_dkv(*a, True), torch.bfloat16),
    "flash_bwd_dq": (lambda *a: tfa.flash_bwd_dq(*a, True), torch.bfloat16),
    "flash_bwd_dkv_simt": (lambda *a: tfa.flash_bwd_dkv(*a, True),
                           torch.float32),
    "flash_bwd_dq_simt": (lambda *a: tfa.flash_bwd_dq(*a, True),
                          torch.float32),
}
# the C entry point each kernel's launch goes through
_ENTRY = {"flash_fwd": "slt_flash_fwd_tc", "flash_fwd_simt": "slt_flash_fwd",
          "flash_bwd_dkv": "slt_flash_bwd_dkv_tc",
          "flash_bwd_dq": "slt_flash_bwd_dq_tc",
          "flash_bwd_dkv_simt": "slt_flash_bwd_dkv_simt",
          "flash_bwd_dq_simt": "slt_flash_bwd_dq_simt"}


@pytest.mark.parametrize("fault", ["dtype", "head dim", "non-contiguous",
                                   "mixed devices"])
@pytest.mark.parametrize("wrapper", sorted(_WRAPPERS))
def test_wrappers_raise_before_any_launch(monkeypatch, wrapper, fault):
    """Inputs a kernel does not take raise before the library is loaded:
    ``_on_cpu`` is made to answer "on the card" (except for mixed
    devices, which it refuses itself), and no launch is counted."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    if fault != "mixed devices":
        monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_library", no_library)
    tfa.reset_launches()
    fn, dtype = _WRAPPERS[wrapper]
    with pytest.raises((TypeError, ValueError)):
        fn(*_fault_inputs(fault, dtype))
    assert not any(tfa.LAUNCHES.values())


def test_tensor_core_forward_refuses_what_it_cannot_take(monkeypatch):
    """The tensor-core route raises, without launching, on float32, on
    D = 8 and on inputs that are not 16-byte aligned."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfa, "_library", no_library)
    tfa.reset_launches()
    bf = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    for q in (bf.float(), torch.zeros(2, 16, 8, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="bfloat16 with D"):
            tfa._launch_fwd("flash_fwd", q, q, q, True)
    shifted = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16)[1:].view(
        2, 16, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._launch_fwd("flash_fwd", shifted, bf, bf, True)
    assert not any(tfa.LAUNCHES.values())


class _FailingLibrary:
    """A kernel library whose every entry point reports a CUDA error
    (700, an illegal address) and records that it was called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 700
        return entry


@pytest.mark.parametrize("wrapper", sorted(_WRAPPERS))
def test_failed_launch_raises_and_never_falls_back(monkeypatch, wrapper):
    """A launch that fails raises at once: the wrapper reaches its route's
    one entry point, tries no other route and no plain version, and
    counts no launch."""
    lib = _FailingLibrary()
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_library", lambda: lib)
    monkeypatch.setattr(tfa, "_stream", lambda t: None)
    tfa.reset_launches()
    fn, dtype = _WRAPPERS[wrapper]
    with pytest.raises(RuntimeError, match=f"{wrapper} kernel launch failed"):
        fn(*_fault_inputs(None, dtype))
    assert lib.calls == [_ENTRY[wrapper]]
    assert not any(tfa.LAUNCHES.values())


# --------------------------------------------------------------------------
# the bf16 tensor-core backward: its numerics rehearsed, its route, its
# checks
# --------------------------------------------------------------------------

BF16_GRAD_TOL = 2.0 ** -7


def _tc_backward_emulation(q, k, v, do, lse, delta, causal):
    """The design of ``flash_bwd_dkv_tc_kernel`` and
    ``flash_bwd_dq_tc_kernel`` in float32 PyTorch, over (BH, S, D) float32
    tensors holding bf16 values: 64-row tiles over a ragged S, exact
    products summed in float32, p = 2^(s*scale*log2(e) - lse*log2(e))
    masked to 0, ds = p (dp - delta) * scale from the float32 p, and p
    and ds rounded to bf16 before their products; dK/dV walks the Q tiles
    from the diagonal in the transposed form (S^T = K Q^T), dQ the K tiles
    up to it; dq, dk and dv rounded to bf16.  Returns ``(dq, dk, dv)``."""
    bh, s, d = q.shape
    scale = 1.0 / np.sqrt(d)
    log2e = np.log2(np.e)
    n_tiles = -(-s // TC_TILE)

    def tile(x, i):
        return x[:, i * TC_TILE:(i + 1) * TC_TILE]

    def pos(i, x):
        return i * TC_TILE + torch.arange(x.shape[1])

    def bf16(x):
        return x.bfloat16().float()

    dq, dk, dv = torch.zeros(bh, s, d), torch.zeros(bh, s, d), \
        torch.zeros(bh, s, d)
    for kb in range(n_tiles):
        kt, vt = tile(k, kb), tile(v, kb)
        keys = pos(kb, kt)
        dka, dva = torch.zeros_like(kt), torch.zeros_like(vt)
        for qb in range(kb if causal else 0, n_tiles):
            qt, ot = tile(q, qb), tile(do, qb)
            queries = pos(qb, qt)
            st = torch.matmul(kt, qt.transpose(1, 2))    # keys x queries
            pt = torch.exp2(st * (scale * log2e)
                            - tile(lse, qb)[:, None, :] * log2e)
            if causal:
                pt = pt.masked_fill(keys[:, None] > queries[None, :], 0.0)
            dva = dva + torch.matmul(bf16(pt), ot)
            dpt = torch.matmul(vt, ot.transpose(1, 2))
            dst = pt * (dpt - tile(delta, qb)[:, None, :]) * scale
            dka = dka + torch.matmul(bf16(dst), qt)
        dk[:, kb * TC_TILE:(kb + 1) * TC_TILE] = bf16(dka)
        dv[:, kb * TC_TILE:(kb + 1) * TC_TILE] = bf16(dva)
    for qb in range(n_tiles):
        qt, ot = tile(q, qb), tile(do, qb)
        queries = pos(qb, qt)
        dqa = torch.zeros_like(qt)
        for kb in range(min(n_tiles, qb + 1) if causal else n_tiles):
            kt, vt = tile(k, kb), tile(v, kb)
            keys = pos(kb, kt)
            x = torch.matmul(qt, kt.transpose(1, 2))     # queries x keys
            p = torch.exp2(x * (scale * log2e)
                           - tile(lse, qb)[..., None] * log2e)
            if causal:
                p = p.masked_fill(keys[None, :] > queries[:, None], 0.0)
            dp = torch.matmul(ot, vt.transpose(1, 2))
            ds = p * (dp - tile(delta, qb)[..., None]) * scale
            dqa = dqa + torch.matmul(bf16(ds), kt)
        dq[:, qb * TC_TILE:(qb + 1) * TC_TILE] = bf16(dqa)
    return dq, dk, dv


@pytest.mark.parametrize("s,causal", [(256, True), (48, True), (100, False)])
def test_tensor_core_backward_numerics_match_pallas_kernels(s, causal):
    """The tensor-core backward's numerics (bf16 P and dS, log2-unit
    exponentials, 64-row tiles over a ragged S, the transposed dK/dV)
    against the JAX backward rule with its Pallas dK/dV and dQ kernels run
    through the interpreter on the same bf16 values, at D = 64."""
    q, k, v = _bf16_values(20 + s, 2, s, 64)
    do = _bf16_values(30 + s, 2, s, 64)[0]
    block = jfa._pick_block(s, 64)
    res = jfa._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, True, block, block)[1]
    grads_j = jfa._flash_bwd_rule(causal, True, block, block, res,
                                  jnp.asarray(do))
    lse = torch.from_numpy(np.array(res[4]))
    delta = (torch.from_numpy(do) * torch.from_numpy(np.array(res[3]))).sum(-1)
    grads_t = _tc_backward_emulation(
        *(torch.from_numpy(x) for x in (q, k, v, do)), lse, delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        b = np.asarray(b)
        tol = BF16_GRAD_TOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a.numpy() - b).max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route(dtype, d):
    """bf16 at D >= 16 takes the tensor-core pair; float32 and D = 8 take
    the CUDA-core pair.  Every kernel of each pair has its own count."""
    want = "tc" if dtype == torch.bfloat16 and d >= 16 else "simt"
    assert tfa._bwd_route(dtype, d) == want
    suffix = "" if want == "tc" else "_simt"
    assert {f"flash_bwd_dkv{suffix}", f"flash_bwd_dq{suffix}"} <= set(
        tfa.LAUNCHES)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_tensor_core_backward_refuses_what_it_cannot_take(monkeypatch,
                                                          kernel):
    """The tensor-core backward raises, without launching, on float32, on
    D = 8 and when any of q, k, v and dO is not 16-byte aligned."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    launch = {"dkv": tfa._launch_dkv, "dq": tfa._launch_dq}[kernel]
    monkeypatch.setattr(tfa, "_library", no_library)
    tfa.reset_launches()
    bf = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    rows = torch.zeros(2, 16)
    for q in (bf.float(), torch.zeros(2, 16, 8, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="bfloat16 with D"):
            launch("tc", q, q, q, q, rows, rows, True)
    shifted = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16)[1:].view(
        2, 16, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for at in range(4):
        args = [bf] * 4
        args[at] = shifted
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch("tc", *args, rows, rows, True)
    assert not any(tfa.LAUNCHES.values())
