"""Chip smoke test of the PyTorch/CUDA port (``split_learning_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and sets both TF32 switches explicitly (off);
2. build — compiles every kernel source of ``split_learning_torch/csrc``
   (flash attention, the wire quantizer, the stage update) with ``nvcc``,
   one compiler process per source, all started together;
3. kernels — holds each kernel against its plain PyTorch version at the
   main paths' shapes and times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (a yardstick
   only: the port never calls it).  Flash attention within stated
   tolerances (bf16 at the slice's shapes, float32 causal and not, odd
   sequence lengths, every head dim); the quantizer (int8 and int4, NaN,
   inf and all-zero tiles, an odd tile), the dequantizer, finalize
   (float32, bf16, int32 with rounding) and momentum bit for bit.  A tiny
   TinyLlama's logits and gradients through the flash kernels are held
   against its dense-attention path, and a tiny protocol round with every
   kernel flag on against the same round through the plain chains;
4. slice — one training round of full-width TinyLlama-1.1B
   (``configs/baseline5.yaml``: 4 stages, AdamW, bf16, batch 8,
   control-count 4, with ``use_flash: true``, 128 samples = 4 steps)
   through ``split_learning_torch.run.run_local`` on CUDA, with the
   kernels' launch counts zeroed just before and read just after;
5. profile — the same round once more, warm, with its device kernels
   traced by ``torch.profiler`` (not counted): round wall, the device's
   busy and idle share, and the kernels that take the most device time;
6. protocol — the protocol round at the same width: ``ProtocolServer``
   in this thread and one ``ProtocolClient`` thread per client over a
   shared ``InProcTransport``, ``clients: [2, 1, 1, 1]``, an int8 codec
   on both cut directions, the sharded (CUDA) fold with
   ``server-momentum: 0.9`` for 2 rounds, every kernel flag on — then one
   more round with ``server-momentum: 0``, because with momentum every
   TinyLlama leaf takes the momentum kernel and only a plain FedAvg
   round finalizes.  Counts zeroed before and read after;
7. summary — a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, when
there is no CUDA device or when the port's package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

# H100 SXM data-sheet peaks (dense): device memory and compute rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the slice's flash-attention shapes: (B*H, S, D) = (8*32, 256, 64), bf16
SLICE_SHAPE = (8 * 32, 256, 64)
# one activation / gradient frame at a cut: (batch, sequence, hidden)
FRAME_SHAPE = (8, 256, 2048)
# the largest parameter leaf (embedding and LM head): (vocab, hidden)
LEAF_SHAPE = (32000, 2048)
SOURCES = ("flash_attention", "quant", "update")
# where the protocol phases run (a CPU rehearsal of the script sets "cpu")
DEVICE = "cuda"
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("split_learning_torch/csrc/flash_attention.cu",
                  "split_learning_tpu/ops/flash_attention.py:62"),
    "flash_bwd_dkv": ("split_learning_torch/csrc/flash_attention.cu",
                      "split_learning_tpu/ops/flash_attention.py:134"),
    "flash_bwd_dq": ("split_learning_torch/csrc/flash_attention.cu",
                     "split_learning_tpu/ops/flash_attention.py:173"),
    "quantize": ("split_learning_torch/csrc/quant.cu",
                 "split_learning_tpu/ops/kernels/quant.py:37"),
    "dequantize": ("split_learning_torch/csrc/quant.cu",
                   "split_learning_tpu/ops/kernels/quant.py:92"),
    "finalize": ("split_learning_torch/csrc/update.cu",
                 "split_learning_tpu/ops/kernels/update.py:53"),
    "momentum": ("split_learning_torch/csrc/update.cu",
                 "split_learning_tpu/ops/kernels/update.py:81"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} tf32 off")


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    import split_learning_torch
    from split_learning_torch.ops.kernels import build
    check(pathlib.Path(split_learning_torch.__file__).resolve().is_relative_to(
        HERE), f"split_learning_torch imported from outside {HERE}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name in SOURCES:
        build.load(name)
    secs = time.perf_counter() - t0
    for name, lib_path in paths.items():
        print(f"build: {lib_path.name} (nvcc {build.BUILD_SECONDS[name]:.2f}"
              " s)")
        log = lib_path.with_name(lib_path.name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print("  ptxas:",
                          line.split("ptxas info    :")[-1].strip())
    print(f"build: all sources in {secs:.2f} s")


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

_FLUSH = None


def _time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median time of ``fn()`` in ms from CUDA events, the 50 MB L2
    flushed before each launch (the caller's inputs start cold).

    Every rep is enqueued before any is read: the 512 MB flush keeps the
    card busy for ~0.2 ms, so the host has enqueued ``fn()``'s launch by
    the time the card reaches the start event, and a short kernel's
    time does not include the host's call overhead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _max_err(out, ref) -> tuple[float, float]:
    out, ref = out.float(), ref.float()
    return (float((out - ref).abs().max()), float(ref.abs().max()))


def _tolerance(dtype, kind: str, ref_max: float) -> float:
    """Allowed max |kernel - plain| against the float32 plain version.

    bf16 outputs: the kernel rounds each output to bf16 once (relative
    error <= 2^-8) and sums in another order than the plain version;
    allow 2^-7 of the largest |value| (lse is float32 in both: 1e-4 of
    it, for the summation order of up to S exponentials).
    float32: the JAX package's own flash-vs-dense tolerances (2e-5 for
    o/lse, 5e-4 for gradients), relative to max(1, largest |value|)."""
    scale = max(1.0, ref_max)
    if dtype == torch.bfloat16:
        return (1e-4 if kind == "lse" else 2.0 ** -7) * scale
    return (2e-5 if kind in ("o", "lse") else 5e-4) * scale


def _bytes_and_flops(name: str, shape, dtype, causal: bool):
    """Least bytes moved (each input read once, each output written
    once) and the multiply-adds these inputs need (causal: only the
    visible (q, k) pairs)."""
    bh, s, d = shape
    el = torch.tensor([], dtype=dtype).element_size()
    mat, row = bh * s * d * el, bh * s * 4
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    if name == "flash_fwd":       # q,k,v -> o, lse; QK^T and PV
        return 4 * mat + row, 4 * d * pairs
    if name == "flash_bwd_dkv":   # q,k,v,dO,lse,delta -> dk,dv; 4 products
        return 6 * mat + 2 * row, 8 * d * pairs
    return 5 * mat + 2 * row, 6 * d * pairs   # dq: 3 products


def phase_kernels() -> dict:
    from split_learning_torch.ops import flash_attention as fa

    cases = [("slice bf16 causal", SLICE_SHAPE, torch.bfloat16, True),
             ("f32 causal", (16, 256, 64), torch.float32, True),
             ("f32 non-causal", (16, 256, 64), torch.float32, False),
             ("bf16 odd S=48 causal", (16, 48, 64), torch.bfloat16, True),
             ("f32 odd S=48 non-causal", (16, 48, 64), torch.float32,
              False)]
    # every other head dim the kernels are built for, at a ragged S
    for d in (8, 16, 32, 128):
        cases += [(f"bf16 D={d} S=100 causal", (8, 100, d), torch.bfloat16,
                   True),
                  (f"f32 D={d} S=80 non-causal", (8, 80, d), torch.float32,
                   False)]
    results = {}
    for ci, (label, shape, dtype, causal) in enumerate(cases):
        q, k, v, do = _inputs(shape, dtype, seed=ci)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        lse_in = lse_ref.contiguous()
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(
            q.float(), k.float(), v.float(), do.float(), lse_in, delta,
            causal)
        dq_ref = fa.flash_bwd_dq_reference(
            q.float(), k.float(), v.float(), do.float(), lse_in, delta,
            causal)
        o_ref32, _ = fa.flash_fwd_reference(q.float(), k.float(),
                                            v.float(), causal)

        o, lse = fa.flash_fwd(q, k, v, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_in, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_in, delta, causal)
        torch.cuda.synchronize()
        errs = {"flash_fwd": [("o", o, o_ref32), ("lse", lse, lse_ref)],
                "flash_bwd_dkv": [("dk", dk, dk_ref), ("dv", dv, dv_ref)],
                "flash_bwd_dq": [("dq", dq, dq_ref)]}
        for name, outs in errs.items():
            worst = 0.0
            for kind, out, ref in outs:
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name} {label}: non-finite {kind}")
                err, ref_max = _max_err(out, ref)
                tol = _tolerance(dtype, kind, ref_max)
                print(f"  {name:14s} {label:24s} {kind:3s} max_abs_err "
                      f"{err:.3e} (max|ref| {ref_max:.3g}, tol {tol:.3e})")
                check(err <= tol, f"{name} {label}: {kind} max_abs_err "
                      f"{err} > tol {tol}")
                worst = max(worst, err)
            if ci == 0:
                results[name] = {"max_abs_err": worst}

        if ci != 0:
            continue
        # times at the slice's shapes
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_reference(q, k, v, causal)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dq_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
        }
        b, h = 8, 32
        q4, k4, v4 = (t.view(b, h, shape[1], shape[2]) for t in (q, k, v))
        library = {"flash_fwd": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)}
        for name, (kern, plain) in runs.items():
            nbytes, flops = _bytes_and_flops(name, shape, dtype, causal)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            r = results[name]
            r["ms"] = _time_ms(kern)
            r["plain_ms"] = _time_ms(plain)
            r["library_ms"] = (_time_ms(library[name]) if name in library
                               else None)
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            r["bytes"], r["flops"] = nbytes, flops
            print(f"  {name:14s} kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        # the library's backward (dq, dk, dv together) as a yardstick
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in
                      (q4, k4, v4))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        do4 = do.view_as(out)
        sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True))
        print(f"  sdpa backward (dq, dk, dv in one call): {sdpa_bwd:.4f} ms")
    return results


def phase_model_check() -> None:
    """A tiny TinyLlama in float32 on the card: logits and parameter
    gradients through the flash kernels against the dense path, at the
    JAX package's model-level tolerance (5e-4)."""
    from split_learning_torch.models import build_model
    kw = dict(vocab_size=64, hidden_size=128, num_heads=4, num_kv_heads=2,
              intermediate_size=256, n_block=2)
    x = torch.randint(0, 64, (2, 48), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    y = torch.roll(x, -1, dims=1)
    outs = []
    for flash in (True, False):
        m = build_model("TinyLlama_TINYSTORIES", device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1),
                        use_flash=flash, **kw)
        logits = m(x)
        F.cross_entropy(logits.reshape(-1, 64), y.reshape(-1)).backward()
        outs.append((logits.detach(),
                     {n: p.grad.detach() for n, p in m.named_parameters()}))
    (l1, g1), (l2, g2) = outs
    err = float((l1 - l2).abs().max())
    gerr = max(float((g1[n] - g2[n]).abs().max()) for n in g1)
    print(f"  tiny TinyLlama f32 flash vs dense: logits max_abs_err "
          f"{err:.3e}, grads max_abs_err {gerr:.3e} (tol 5e-4)")
    check(err <= 5e-4 and gerr <= 5e-4, "tiny model flash vs dense")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes (NaN payloads compare as bits)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _bitwise(name: str, label: str, out, ref) -> None:
    same = (out.dtype == ref.dtype and out.shape == ref.shape
            and torch.equal(_bits(out), _bits(ref)))
    print(f"  {name:10s} {label:36s} bitwise {'equal' if same else 'DIFFER'}")
    check(same, f"{name} {label}: kernel differs from its plain version")


def _time_triple(name: str, kern, plain, library, nbytes: int,
                 ops: int) -> dict:
    """Kernel, plain and library times plus the bound (bytes over the
    memory rate or float32 operations over the CUDA-core rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    r = {"ms": _time_ms(kern), "plain_ms": _time_ms(plain),
         "library_ms": _time_ms(library) if library is not None else None,
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes": nbytes, "ops": ops, "max_abs_err": 0.0}
    print(f"  {name:10s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
          f" ms  library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop)")
    return r


def phase_wire_kernels() -> dict:
    """The quantizer, dequantizer and stage-update kernels against their
    plain versions, bit for bit, then timed at the main path's shapes:
    one bf16 activation frame (8 x 256 x 2048, tile 256) and the largest
    parameter leaf (32000 x 2048 float32)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    g = torch.Generator(device="cuda").manual_seed(23)
    frame = (torch.randn(FRAME_SHAPE, generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    flat = frame.view(-1)
    flat[256 * 5:256 * 6] = 0               # an all-zero tile
    flat[256 * 9 + 17] = float("nan")       # a NaN tile
    flat[256 * 12 + 3] = float("inf")       # an inf tile
    odd = torch.randn(1001, generator=g, device="cuda") * 2
    odd[40] = float("-inf")
    cases = [("slice frame bf16 int8 tile 256", frame, 256, 8),
             ("slice frame bf16 int4 tile 256", frame, 256, 4),
             ("ragged f32 int8 tile 7 n=1001", odd, 7, 8),
             ("ragged f32 int4 tile 7 n=1001", odd, 7, 4)]
    for label, x, tile, bits in cases:
        q, s = kq.quantize_tiles(x, tile=tile, bits=bits)
        qr, sr = kq.quantize_reference(x, tile, bits)
        torch.cuda.synchronize()
        _bitwise("quantize", label + " codes", q, qr)
        _bitwise("quantize", label + " scales", s, sr)
        d = kq.dequantize_tiles(q, s, tile=tile, bits=bits)
        dr = kq.dequantize_reference(q, s, tile, bits)
        torch.cuda.synchronize()
        _bitwise("dequantize", label, d, dr)
        # the round trip is within half a quantization step per tile
        n = x.numel()
        xf = torch.nn.functional.pad(x.reshape(-1).float(),
                                     (0, s.numel() * tile - n))
        err = (d - xf).reshape(-1, tile).abs().amax(dim=1)
        ok = torch.isfinite(s)
        check(bool((err[ok] <= s[ok] / 2 * 1.0001).all()),
              f"dequantize {label}: round trip beyond half a step")
        check(bool((~ok).sum() == (~torch.isfinite(
            xf.reshape(-1, tile))).any(dim=1).sum()),
              f"quantize {label}: NaN scales do not mark the bad tiles")

    acc = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 50
    small = torch.randn(4096, 64, generator=g, device="cuda") * 50
    tw = 64.0   # the slice's fold weight: two edge clients x 32 samples
    for label, a, dt, rnd in (("leaf f32", acc, torch.float32, False),
                              ("leaf bf16", acc, torch.bfloat16, False),
                              ("int32 with rounding", small, torch.int32,
                               True),
                              ("odd 0.5 ties int32", torch.arange(
                                  -40, 40, device="cuda").float() * 32.0,
                               torch.int32, True)):
        _bitwise("finalize", label, ku.finalize_leaf(a, tw, dt, rnd=rnd),
                 ku.finalize_reference(a, tw, dt, rnd))
    base = torch.randn(LEAF_SHAPE, generator=g, device="cuda")
    vel = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 0.01
    p, nv = ku.momentum_leaf(acc, base, vel, tw, 0.9, torch.float32)
    pr, nvr = ku.momentum_reference(acc, base, vel, tw, 0.9, torch.float32)
    _bitwise("momentum", "leaf params", p, pr)
    _bitwise("momentum", "leaf velocity", nv, nvr)
    p, nv = ku.momentum_leaf(small, small * 0.5, small * 0.1, 3.0, 0.5,
                             torch.bfloat16)
    pr, nvr = ku.momentum_reference(small, small * 0.5, small * 0.1, 3.0,
                                    0.5, torch.bfloat16)
    _bitwise("momentum", "bf16 params", p, pr)
    _bitwise("momentum", "bf16 velocity", nv, nvr)

    # times at the main path's shapes
    n = frame.numel()
    q, s = kq.quantize_tiles(frame, tile=256, bits=8)
    t_count = s.numel()
    tw_t = torch.tensor(tw, dtype=torch.float32, device="cuda")
    leaf_n = acc.numel()
    return {
        # bf16 in, int8 codes + float32 scales out; abs, max, divide,
        # round and clip a value
        "quantize": _time_triple(
            "quantize", lambda: kq.quantize_tiles(frame, tile=256, bits=8),
            lambda: kq.quantize_reference(frame, 256, 8), None,
            2 * n + n + 4 * t_count, 5 * n),
        # int8 codes + scales in, float32 out; one multiply a value.
        # library: one broadcast multiply of the codes by their scales
        "dequantize": _time_triple(
            "dequantize", lambda: kq.dequantize_tiles(q, s, tile=256,
                                                       bits=8),
            lambda: kq.dequantize_reference(q, s, 256, 8),
            lambda: torch.mul(q.view(t_count, 256), s[:, None]),
            n + 4 * t_count + 4 * n, n),
        # float32 in and out; one divide.  library: torch.div
        "finalize": _time_triple(
            "finalize", lambda: ku.finalize_leaf(acc, tw, torch.float32),
            lambda: ku.finalize_reference(acc, tw, torch.float32),
            lambda: torch.div(acc, tw_t), 8 * leaf_n, leaf_n),
        # acc, base, velocity in; params, velocity out; five operations.
        # No single PyTorch call computes both outputs
        "momentum": _time_triple(
            "momentum", lambda: ku.momentum_leaf(acc, base, vel, tw, 0.9,
                                                 torch.float32),
            lambda: ku.momentum_reference(acc, base, vel, tw, 0.9,
                                          torch.float32), None,
            20 * leaf_n, 5 * leaf_n),
    }


# --------------------------------------------------------------------------
# 4. the slice: one round of full-width TinyLlama-1.1B
# --------------------------------------------------------------------------

def slice_config(workdir: pathlib.Path):
    """``configs/baseline5.yaml`` with use_flash, 128 samples (4 steps),
    2 validation batches of 8, and checkpoints and logs in ``workdir``."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / "configs" / "baseline5.yaml")
    mk = dict(cfg.model_kwargs or {})
    mk["use_flash"] = True
    cfg = dataclasses.replace(
        cfg, model_kwargs=mk, val_max_batches=2, val_batch_size=8,
        distribution=dataclasses.replace(cfg.distribution, num_samples=128),
        checkpoint=dataclasses.replace(cfg.checkpoint,
                                       directory=str(workdir / "ckpt")),
        log_path=str(workdir / "logs")).validate()
    return cfg


def phase_slice(cfg) -> dict:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.run import run_local
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    mk = cfg.model_kwargs
    lrn = cfg.learning
    print(f"  config: {cfg.model_key} {dict(mk)} clients={list(cfg.clients)} "
          f"cuts={list(cfg.topology.cut_layers)} batch={lrn.batch_size} "
          f"control-count={lrn.control_count} {lrn.optimizer} "
          f"{cfg.compute_dtype} samples={cfg.distribution.num_samples}")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    result = run_local(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)

    check(len(result.history) == 1, f"expected 1 round, got "
          f"{len(result.history)}")
    rec = result.history[0]
    check(rec.ok, f"round not ok: {rec}")
    check(math.isfinite(rec.val_loss) and math.isfinite(rec.val_accuracy),
          f"non-finite validation: {rec}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    steps = max(1, (cfg.distribution.num_samples // lrn.batch_size)
                // lrn.control_count)
    check(rec.num_samples == steps * lrn.control_count * lrn.batch_size,
          f"samples {rec.num_samples}")
    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == 1, "checkpoint missing")
    n_block = mk.get("n_block", 22)
    for layer in ("layer1", f"layer{n_block + 3}"):
        for key, t in ck["params"][layer].items():
            check(torch.equal(t, result.params[layer][key].cpu()),
                  f"checkpoint {layer}.{key} differs from the result")
    # launches per training step: the round also runs the forward kernel
    # once per block for the pipeline's one-sample width probe and once
    # per block per validation batch
    per_step = {
        "flash_fwd": (launches["flash_fwd"]
                      - n_block * (1 + cfg.val_max_batches)) / steps,
        "flash_bwd_dkv": launches["flash_bwd_dkv"] / steps,
        "flash_bwd_dq": launches["flash_bwd_dq"] / steps}
    seq = 256
    tokens = rec.num_samples * seq
    out = {"round_wall_s": rec.wall_s, "run_local_wall_s": wall,
           "train_tokens": tokens, "train_tokens_per_s": tokens / rec.wall_s,
           "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps, "launches": launches,
           "launches_per_step": per_step}
    print(f"  round wall {rec.wall_s:.3f} s (run_local {wall:.3f} s), "
          f"{tokens} training tokens, {out['train_tokens_per_s']:.1f} "
          f"tokens/s, val_loss {rec.val_loss:.4f} val_acc "
          f"{rec.val_accuracy:.4f}, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
          f"launches {launches} over {steps} steps, per training step "
          f"{per_step} (expected {n_block * lrn.control_count} for each "
          f"backward kernel and twice that for the forward under remat)")
    return out


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


def phase_profile(cfg) -> dict:
    """Where the time goes: the slice's round once more, warm (after the
    counted main-path run, whose launches it does not touch), with the
    device's kernels traced by ``torch.profiler`` (device activity only:
    tracing every host op of a round costs minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from split_learning_torch.run import run_local
    cfg = dataclasses.replace(
        cfg, checkpoint=dataclasses.replace(cfg.checkpoint, save=False))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_local(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_s = sum(_device_us(e) for e in kernels) / 1e6
    walls = [r.wall_s for r in res.history]
    print(f"  profiled run: round walls {[round(w, 3) for w in walls]} s, "
          f"run {wall:.3f} s, device busy {busy_s:.3f} s = "
          f"{busy_s / wall:.1%} of the run (idle {1 - busy_s / wall:.1%})")
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    for e in top:
        print(f"    {_device_us(e) / 1e3:10.1f} ms {e.count:8d}x  "
              f"{e.key[:90]}")
    return {"round_walls_s": walls, "run_wall_s": wall,
            "device_busy_s": busy_s, "idle_share": 1 - busy_s / wall,
            "top_kernels": [{"name": e.key[:120], "count": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in top]}


# --------------------------------------------------------------------------
# 6. the protocol round: server + client threads over the in-process bus
# --------------------------------------------------------------------------

def run_protocol(cfg, timeout: float = 600.0):
    """The protocol deployment through the port's entry point
    (``run_inproc``: the server in this thread, one client thread per
    client over a shared ``InProcTransport``) on the card."""
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import run_inproc
    try:
        # the server's protocol log goes to its run directory only
        run = run_inproc(cfg, device=DEVICE, client_timeout=timeout,
                         logger=Logger.for_run(cfg, "server",
                                               console=False))
    except Exception as e:
        raise SmokeFailure(f"protocol round failed: {e!r} "
                           f"(cause: {e.__cause__!r})") from e
    return run.server, run.clients, run.bus, run.result


TINY_PROTOCOL = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 64, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 128,
                     "n_block": 2, "use_flash": True},
    "topology": {"cut-layers": [2, 3]}, "distribution": {"num-samples": 32},
    "aggregation": {"strategy": "fedavg", "sharded": True,
                    "server-momentum": 0.9},
    "transport": {"codec": {"intermediate": "int8", "gradient": "int8"}},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "adamw",
                 "learning-rate": 1e-3},
    "checkpoint": {"save": False},
}


def phase_protocol_check(workdir: pathlib.Path) -> None:
    """A tiny float32 protocol round (3 stages, int8 codec, CUDA fold
    with momentum) on the card twice: every kernel flag on, then every
    flag off (the plain chains on the card).  With one batch in flight
    each stage steps in a fixed order, and each kernel equals its plain
    version bit for bit, so the two runs' validation losses and final
    parameters must agree to float32 noise (1e-5: cuBLAS may pick other
    GEMM algorithms between the runs)."""
    from split_learning_torch.config import from_dict

    runs = []
    for flags in (True, False):
        d = dict(TINY_PROTOCOL, **{"log-path": str(workdir / f"tiny{flags}"),
                                   "kernels": {"quantize": flags,
                                               "dequantize": flags,
                                               "stage-update": flags}})
        _, _, _, res = run_protocol(from_dict(d), timeout=120)
        check([r.ok for r in res.history] == [True, True],
              f"tiny protocol round not ok: {res.history}")
        runs.append(res)
    on, off = runs
    loss_err = max(abs(a.val_loss - b.val_loss)
                   for a, b in zip(on.history, off.history))
    param_err = max(float((on.params[layer][k] - t).abs().max())
                    for layer, sd in off.params.items()
                    for k, t in sd.items())
    print(f"  tiny protocol round, kernels on vs plain chains: val_loss "
          f"{[round(r.val_loss, 6) for r in on.history]} vs "
          f"{[round(r.val_loss, 6) for r in off.history]}, max |loss "
          f"diff| {loss_err:.3e}, max |param diff| {param_err:.3e} "
          "(tol 1e-5)")
    check(loss_err <= 1e-5 and param_err <= 1e-5,
          "tiny protocol round: kernels disagree with the plain chains")


def protocol_config(workdir: pathlib.Path, momentum: float, rounds: int):
    """``configs/baseline5.yaml`` as the protocol slice runs it:
    use_flash, ``clients: [2, 1, 1, 1]``, an int8 codec on both cut
    directions, every kernel flag on, the sharded fold with
    ``server-momentum`` = ``momentum``; 32 samples (4 steps of 8) per
    edge client per round, 2 validation batches of 8."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / "configs" / "baseline5.yaml")
    mk = dict(cfg.model_kwargs or {})
    mk["use_flash"] = True
    return dataclasses.replace(
        cfg, model_kwargs=mk, clients=(2, 1, 1, 1), global_rounds=rounds,
        val_max_batches=2, val_batch_size=8,
        distribution=dataclasses.replace(cfg.distribution, num_samples=32),
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, strategy="fedavg", sharded=True,
            server_momentum=momentum),
        checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=str(workdir / "ckpt_protocol")),
        log_path=str(workdir / "logs_protocol")).validate()


def _family(queue: str) -> str:
    for fam in ("intermediate", "gradient"):
        if queue.startswith(fam + "_queue"):
            return fam
    return "reply" if queue.startswith("reply_") else "rpc"


def phase_protocol(workdir: pathlib.Path) -> dict:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    def reset():
        for mod in (fa, kq, ku):
            mod.reset_launches()

    def read():
        return {**fa.LAUNCHES, **kq.LAUNCHES, **ku.LAUNCHES}

    cfg = protocol_config(workdir, momentum=0.9, rounds=2)
    mk, lrn = cfg.model_kwargs, cfg.learning
    print(f"  config: {cfg.model_key} {dict(mk)} clients={list(cfg.clients)}"
          f" cuts={list(cfg.topology.cut_layers)} batch={lrn.batch_size} "
          f"control-count={lrn.control_count} {lrn.optimizer} "
          f"{cfg.compute_dtype} samples/edge client={cfg.distribution.num_samples}"
          f" codec={cfg.transport.codec} momentum "
          f"{cfg.aggregation.server_momentum} rounds {cfg.global_rounds}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    server, clients, bus, res = run_protocol(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()

    n_edge = cfg.clients[0]
    want = n_edge * cfg.distribution.num_samples
    check(len(res.history) == 2, f"expected 2 rounds, got {res.history}")
    for rec in res.history:
        check(rec.ok, f"protocol round not ok: {rec}")
        check(math.isfinite(rec.val_loss), f"non-finite validation: {rec}")
        check(rec.num_samples == want,
              f"round {rec.round_idx}: {rec.num_samples} samples, "
              f"expected {want}")
    fold = server.ctx.last_fold
    check(fold.folded == sum(cfg.clients), f"folded {fold.folded}")
    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == 2, "checkpoint missing")
    for layer, sd in res.params.items():
        for key, t in sd.items():
            check(torch.equal(ck["params"][layer][key], t.cpu()),
                  f"checkpoint {layer}.{key} differs from the result")
    peak = torch.cuda.max_memory_allocated()

    # data-plane bytes per queue family, and the codec's dense bf16
    # equivalent (the compression ratio's denominator)
    actual: dict = {}
    for q, nb in bus.bytes_out_snapshot().items():
        actual[_family(q)] = actual.get(_family(q), 0) + nb
    raw: dict = {}
    for c in clients:
        for q, nb in c.raw_bytes_out.items():
            raw[_family(q)] = raw.get(_family(q), 0) + nb
    wire = {fam: {"bytes": actual.get(fam, 0), "raw_bytes": raw.get(fam),
                  "ratio": (raw[fam] / actual[fam]
                            if raw.get(fam) and actual.get(fam) else None)}
            for fam in ("intermediate", "gradient", "rpc", "reply")}

    phases = server.ctx.round_phases

    # the plain-FedAvg round: only it runs the finalize kernel.  Its
    # device kernels are traced (CUDA activity only), for the device's
    # busy and idle share over a protocol round
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg0 = protocol_config(workdir / "m0", momentum=0.0, rounds=1)
    torch.cuda.synchronize()
    reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        server0, _, _, res0 = run_protocol(cfg0)
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t1
    launches0 = read()
    busy_s = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6
    check([r.ok for r in res0.history] == [True]
          and math.isfinite(res0.history[0].val_loss),
          f"plain FedAvg protocol round failed: {res0.history}")
    total = {k: launches[k] + launches0[k] for k in launches}
    for name, n in total.items():
        check(n > 0, f"kernel {name} was not launched on the protocol path")

    seq = 256
    rounds = [{"round": r.round_idx, "wall_s": r.wall_s,
               "samples": r.num_samples, "val_loss": r.val_loss,
               "train_tokens_per_s": r.num_samples * seq / r.wall_s}
              for r in res.history]
    out = {"rounds": rounds, "run_wall_s": wall,
           "max_memory_allocated_bytes": peak, "wire": wire,
           "launches": launches, "launches_per_round": {
               k: v / len(res.history) for k, v in launches.items()},
           "phases": phases,
           "plain_fedavg_round": {"wall_s": res0.history[0].wall_s,
                                  "run_wall_s": wall0,
                                  "val_loss": res0.history[0].val_loss,
                                  "phases": server0.ctx.round_phases,
                                  "device_busy_s": busy_s,
                                  "idle_share_of_run": 1 - busy_s / wall0,
                                  "launches": launches0},
           "launches_total": total, "fold_update_s": fold.update_s,
           "fold_s": fold.fold_s}
    for r, ph in zip(rounds, phases):
        print(f"  round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_tokens_per_s']:.1f} "
              f"training tokens/s, val_loss {r['val_loss']:.4f}; phases "
              + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()))
    print(f"  protocol run {wall:.3f} s, peak memory {peak / 2**30:.2f} "
          f"GiB, last fold {fold.fold_s:.3f} s (update {fold.update_s:.3f}"
          f" s), launches {launches}")
    for fam, w in wire.items():
        print(f"  wire over {len(rounds)} rounds: {fam:12s} "
              f"{w['bytes']:>14d} B"
              + (f" (dense bf16 {w['raw_bytes']} B, ratio "
                 f"{w['ratio']:.3f})" if w["ratio"] else ""))
    print(f"  plain FedAvg round: wall {res0.history[0].wall_s:.3f} s, "
          f"run {wall0:.3f} s, val_loss {res0.history[0].val_loss:.4f}, "
          f"phases {server0.ctx.round_phases}, device busy {busy_s:.3f} "
          f"s = {busy_s / wall0:.1%} of the run (idle "
          f"{1 - busy_s / wall0:.1%}), launches {launches0}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    print("[build]")
    phase_build()
    print("[kernels]")
    kernels = phase_kernels()
    kernels.update(phase_wire_kernels())
    phase_model_check()
    with tempfile.TemporaryDirectory(prefix="slt_smoke_") as tmp:
        workdir = pathlib.Path(tmp)
        phase_protocol_check(workdir)
        print("[slice]")
        cfg = slice_config(workdir)
        sl = phase_slice(cfg)
        print("[profile]")
        prof = phase_profile(cfg)
        print("[protocol]")
        proto = phase_protocol(workdir)
    entries = []
    for name, r in kernels.items():
        source, replaces = KERNELS[name]
        by_path = {"protocol": proto["launches_total"][name]}
        if name in sl["launches"]:
            by_path["slice"] = sl["launches"][name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # the launches of this slice's main path, the protocol round
            "launches": proto["launches_total"][name],
            "launches_by_path": by_path,
            "launches_per_protocol_round":
                proto["launches_per_round"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"slice": sl, "profile": prof, "protocol": proto}))
    print(json.dumps({"kernels": entries}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
