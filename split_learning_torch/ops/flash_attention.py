"""Fused blockwise (flash) attention: hand-written CUDA kernels + their
plain PyTorch versions.

Port of the JAX package's ``ops/flash_attention.py``.  The three Pallas
TPU kernels become six CUDA C++ kernels for Hopper
(``csrc/flash_attention.cu``), two for each: one for bf16 at D >= 16 and
one for float32 and for bf16 at D = 8:

* the forward — online-softmax over ``(BH, S, D)``; emits ``o`` and the
  per-row logsumexp ``lse`` of the scaled scores.  Two hand-written
  kernels compute it, and :func:`_fwd_route` picks one from the dtype and
  head dim: ``flash_fwd`` (bf16 on the tensor cores, ``mma.sync``) and
  ``flash_fwd_simt`` (for float32 and for bf16 at D = 8);
* the backward — dK and dV (one block per K tile) and dQ (one block per
  Q tile).  :func:`_bwd_route` picks the pair the same way: ``"tc"``
  launches ``flash_bwd_dkv`` and ``flash_bwd_dq`` (bf16 on the tensor
  cores), ``"simt"`` launches ``flash_bwd_dkv_simt`` and
  ``flash_bwd_dq_simt``.

The name ``simt`` is historical: it is the float32 and D = 8 route, and
its three kernels (forward, dK/dV and dQ) run on the tensor cores too, in
split TF32 (each float32 operand as two TF32 terms, three products for
one, near float32 accuracy).  Every kernel takes 16-byte aligned
``(BH, S, D)`` tensors and refuses others before any launch.

``delta = rowsum(dO * O)`` stays a PyTorch pre-pass, as it was an XLA
pre-pass outside Pallas.  :class:`_Flash` is the ``custom_vjp``: its
forward launches the forward kernel and saves ``(q, k, v, o, lse)``, its
backward launches the two backward kernels.

Each wrapper takes its kernel's plain PyTorch version
(``flash_*_reference``) only because the tensors it was given lie on the
CPU; for CUDA tensors it launches the kernel or raises.  Each kernel
launch adds one to its entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES = {"flash_fwd": 0, "flash_fwd_simt": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv_simt": 0,
            "flash_bwd_dq_simt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128)
# head dims of the bf16 tensor-core kernels (mma.sync's k16 step needs 16)
_TC_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


# --------------------------------------------------------------------------
# plain versions (dense PyTorch, float32 compute)
# --------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """Masked scaled scores (BH, S, S) in float32."""
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    if causal:
        n = q.shape[1]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_fwd_reference(q, k, v, causal: bool):
    """Dense version of the forward kernel: ``(o, lse)``."""
    s = _scores(q, k, causal, _scale(q.shape[-1]))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool):
    scale = _scale(q.shape[-1])
    # the backward kernels scale the product, not q: (q . k) * scale
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        n = q.shape[1]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool):
    """Dense version of the dK/dV kernel: ``(dk, dv)``."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool):
    """Dense version of the dQ kernel."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _library():
    from split_learning_torch.ops.kernels.build import load
    lib = load("flash_attention")
    if not getattr(lib, "_slt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.slt_flash_fwd.argtypes = [i, p, p, p, p, p, i, i, i, f, i, p]
        lib.slt_flash_fwd_tc.argtypes = [p, p, p, p, p, i, i, i, f, i, p]
        lib.slt_flash_bwd_dkv_simt.argtypes = [i, p, p, p, p, p, p, p, p,
                                               i, i, i, f, i, p]
        lib.slt_flash_bwd_dq_simt.argtypes = [i, p, p, p, p, p, p, p,
                                              i, i, i, f, i, p]
        lib.slt_flash_bwd_dkv_tc.argtypes = [p, p, p, p, p, p, p, p,
                                             i, i, i, f, i, p]
        lib.slt_flash_bwd_dq_tc.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, f, i, p]
        for fn in (lib.slt_flash_fwd, lib.slt_flash_fwd_tc,
                   lib.slt_flash_bwd_dkv_simt, lib.slt_flash_bwd_dq_simt,
                   lib.slt_flash_bwd_dkv_tc, lib.slt_flash_bwd_dq_tc):
            fn.restype = ctypes.c_int
        lib._slt_typed = True
    return lib


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU, False when every tensor is
    on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"flash attention inputs span devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"flash attention has no kernel for {dev}")
    return False


def _check(q, k, v, *more):
    if q.dim() != 3:
        raise ValueError(f"expected (BH, S, D) tensors, got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {_HEAD_DIMS}")
    for t in (k, v, *more):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"shape/dtype mismatch: {tuple(t.shape)} "
                             f"{t.dtype} vs {tuple(q.shape)} {q.dtype}")
    for t in (q, k, v, *more):
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous "
                             "tensors")


def _check_rows(q, *rows):
    for r in rows:
        if (r.shape != q.shape[:2] or r.dtype != torch.float32
                or not r.is_contiguous()):
            raise ValueError(f"expected contiguous float32 {tuple(q.shape[:2])}"
                             f" rows, got {tuple(r.shape)} {r.dtype}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_aligned(name: str, *tensors):
    """Refuse, before any launch, (BH, S, D) tensors that a kernel's
    16-byte ``cp.async`` copies cannot take: not 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {name} needs 16-byte aligned inputs")


def _check_tc(name: str, *tensors):
    """Refuse, before any launch, what the tensor-core kernels cannot
    take: they are bf16 only, D in 16..128, and their 16-byte
    ``cp.async`` copies need 16-byte aligned (BH, S, D) tensors."""
    q = tensors[0]
    if q.dtype != torch.bfloat16 or q.shape[-1] not in _TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core {name} takes bfloat16 with D in "
                         f"{_TC_HEAD_DIMS}, got {q.dtype} D={q.shape[-1]}")
    _check_aligned(f"tensor-core {name}", *tensors)


def _fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel for inputs of ``dtype`` and head dim ``d``:
    ``"flash_fwd"`` (bf16 products on the tensor cores) for bf16 at D in
    16..128, ``"flash_fwd_simt"`` otherwise: the float32 and D = 8
    route.  Its kernel runs split-TF32 products on the tensor cores
    (``mma.sync`` m16n8k8, whose k8 step fits D = 8), which keep float32
    inputs near float32 accuracy (Precision.HIGHEST) and agree with the
    backward pair of the same route; the name is what it was when the
    kernel ran on the CUDA cores."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        return "flash_fwd"
    return "flash_fwd_simt"


def _launch_fwd(route: str, q, k, v, causal: bool):
    """Launch the forward kernel ``route`` on checked CUDA inputs."""
    bh, s, d = q.shape
    if route == "flash_fwd":
        _check_tc("forward", q, k, v)
    else:
        _check_aligned("float32 forward", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    lib = _library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, _scale(d), int(causal), _stream(q))
    if route == "flash_fwd":
        err = lib.slt_flash_fwd_tc(*ptrs)
    else:
        err = lib.slt_flash_fwd(_DTYPE_CODE[q.dtype], *ptrs)
    _raise_on(err, route)
    LAUNCHES[route] += 1
    return o, lse


def flash_fwd(q, k, v, causal: bool):
    """Forward kernel over (BH, S, D): ``(o, lse)``."""
    if _on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, causal)
    _check(q, k, v)
    return _launch_fwd(_fwd_route(q.dtype, q.shape[-1]), q, k, v, causal)


def _bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward pair for inputs of ``dtype`` and head dim ``d``:
    ``"tc"`` (``flash_bwd_dkv`` and ``flash_bwd_dq``, bf16 products on
    the tensor cores) for bf16 at D in 16..128, ``"simt"``
    (``flash_bwd_dkv_simt`` and ``flash_bwd_dq_simt``) otherwise: the
    float32 and D = 8 route.  Its pair runs split-TF32 products on the
    tensor cores (``mma.sync`` m16n8k8, whose k8 step fits D = 8), which
    keep float32 inputs near float32 accuracy (Precision.HIGHEST); the
    name is what it was when the pair ran on the CUDA cores.  Both pairs
    need 16-byte aligned (BH, S, D) tensors."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _launch_dkv(route: str, q, k, v, do, lse, delta, causal: bool):
    """Launch the dK/dV kernel of ``route`` on checked CUDA inputs."""
    bh, s, d = q.shape
    if route == "tc":
        _check_tc("backward", q, k, v, do)
    else:
        _check_aligned("float32 backward", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s, d, _scale(d), int(causal), _stream(q))
    if route == "tc":
        name, err = "flash_bwd_dkv", lib.slt_flash_bwd_dkv_tc(*args)
    else:
        name = "flash_bwd_dkv_simt"
        err = lib.slt_flash_bwd_dkv_simt(_DTYPE_CODE[q.dtype], *args)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return dk, dv


def _launch_dq(route: str, q, k, v, do, lse, delta, causal: bool):
    """Launch the dQ kernel of ``route`` on checked CUDA inputs."""
    bh, s, d = q.shape
    if route == "tc":
        _check_tc("backward", q, k, v, do)
    else:
        _check_aligned("float32 backward", q, k, v, do)
    dq = torch.empty_like(q)
    lib = _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
            _scale(d), int(causal), _stream(q))
    if route == "tc":
        name, err = "flash_bwd_dq", lib.slt_flash_bwd_dq_tc(*args)
    else:
        name = "flash_bwd_dq_simt"
        err = lib.slt_flash_bwd_dq_simt(_DTYPE_CODE[q.dtype], *args)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """dK/dV kernel over (BH, S, D): ``(dk, dv)``."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    _check(q, k, v, do)
    _check_rows(q, lse, delta)
    return _launch_dkv(_bwd_route(q.dtype, q.shape[-1]), q, k, v, do, lse,
                       delta, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """dQ kernel over (BH, S, D)."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    _check(q, k, v, do)
    _check_rows(q, lse, delta)
    return _launch_dq(_bwd_route(q.dtype, q.shape[-1]), q, k, v, do, lse,
                      delta, causal)


class _Flash(torch.autograd.Function):
    """The ``custom_vjp`` around the kernels, over (BH, S, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O): a cheap elementwise pre-pass
        delta = (do.float() * o.float()).sum(dim=-1)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Fused attention over (B, S, H, D) tensors (the JAX layout)."""
    b, s, h, d = q.shape

    def to_bhsd(t):
        return t.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out = _Flash.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v), causal)
    return out.reshape(b, h, s, d).transpose(1, 2)
