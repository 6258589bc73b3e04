"""Fused round-boundary stage update: hand-written CUDA kernels
(``csrc/update.cu``) and their plain PyTorch versions.

Port of the JAX package's ``ops/kernels/update.py``:

* :func:`finalize_leaf` — FedAvg divide (+ round for integer leaves) +
  wire-dtype cast, one pass;
* :func:`momentum_leaf` — the FedAvgM step
  ``v' = m*v + (base - acc/tw); p' = (base - v').astype(dtype)``,
  emitting the new parameters and the carried float32 velocity in one
  pass.

The op order is the oracle's (``runtime/aggregate.py``'s host twin), so
the CUDA fold backend and the host fold stay bit-identical.  The plain
versions divide by a 0-dim tensor on the leaf's device, never by a
Python float: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which is not the oracle's division.

Each wrapper takes the plain version only because the tensors it was
given lie on the CPU; for CUDA tensors it launches the kernel or
raises.  Each launch adds one to its entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES = {"finalize": 0, "momentum": 0}

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int32: 3, torch.int64: 4, torch.int8: 5, torch.uint8: 6,
             torch.int16: 7, torch.bool: 8}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_ok(leaf) -> bool:
    """Kernel-eligible: at least 1-D and non-empty (0-d and empty leaves
    keep the plain chain — as in the JAX package)."""
    return getattr(leaf, "ndim", 0) >= 1 and leaf.numel() > 0


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def finalize_reference(acc: torch.Tensor, tw: float, dtype: torch.dtype,
                       rnd: bool = False) -> torch.Tensor:
    a32 = acc / _scalar(tw, acc)
    if rnd:
        a32 = torch.round(a32)
    return a32.to(dtype)


def momentum_reference(acc: torch.Tensor, base: torch.Tensor,
                       vel: torch.Tensor, tw: float, m: float,
                       dtype: torch.dtype):
    a32 = acc / _scalar(tw, acc)
    nv = _scalar(m, acc) * vel + (base - a32)
    return (base - nv).to(dtype), nv


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _library():
    from split_learning_torch.ops.kernels.build import load
    lib = load("update")
    if not getattr(lib, "_slt_typed", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.slt_finalize.argtypes = [p, ll, f, i, i, p, p]
        lib.slt_momentum.argtypes = [p, p, p, ll, f, f, i, p, p, p]
        lib.slt_finalize.restype = ctypes.c_int
        lib.slt_momentum.restype = ctypes.c_int
        lib._slt_typed = True
    return lib


def _on_cpu(*tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"stage-update inputs span devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the stage update has no kernel for {dev}")
    return False


def _check_f32(*tensors) -> None:
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"expected float32 {tuple(shape)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the stage-update kernels need contiguous "
                             "leaves")
    if not tensors[0].numel():
        raise ValueError("the stage-update kernels need a non-empty leaf")


def _out_code(dtype: torch.dtype) -> int:
    if dtype not in _OUT_CODE:
        raise TypeError(f"the stage-update kernels cannot write {dtype}")
    return _OUT_CODE[dtype]


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def finalize_leaf(acc: torch.Tensor, tw: float, dtype: torch.dtype, *,
                  rnd: bool = False) -> torch.Tensor:
    """``(acc / tw)`` (+ round for integer wire dtypes) cast to
    ``dtype``, one pass."""
    if _on_cpu(acc):
        return finalize_reference(acc, tw, dtype, rnd)
    _check_f32(acc)
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    err = _library().slt_finalize(acc.data_ptr(), acc.numel(), float(tw),
                                  int(rnd), _out_code(dtype),
                                  out.data_ptr(), _stream(acc))
    _raise_on(err, "finalize")
    LAUNCHES["finalize"] += 1
    return out


def momentum_leaf(acc: torch.Tensor, base: torch.Tensor, vel: torch.Tensor,
                  tw: float, m: float, dtype: torch.dtype):
    """FedAvgM finish for one leaf: ``(params.astype(dtype), new
    velocity float32)`` in one pass, oracle op order."""
    if _on_cpu(acc, base, vel):
        return momentum_reference(acc, base, vel, tw, m, dtype)
    _check_f32(acc, base, vel)
    p = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    nv = torch.empty_like(acc)
    err = _library().slt_momentum(
        acc.data_ptr(), base.data_ptr(), vel.data_ptr(), acc.numel(),
        float(tw), float(m), _out_code(dtype), p.data_ptr(), nv.data_ptr(),
        _stream(acc))
    _raise_on(err, "momentum")
    LAUNCHES["momentum"] += 1
    return p, nv
