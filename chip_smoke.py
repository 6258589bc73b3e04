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
   tolerances (bf16 at the slice's shapes and at D = 128, float32 causal
   and not, odd sequence lengths, every head dim), each forward and
   backward case checked to take the kernels its route names (bf16
   D >= 16: the tensor-core kernels; float32 and D = 8: the CUDA-core
   ones); the CUDA-core forward and backward pair also at the slice's
   shapes, timed beside the tensor-core kernels and SDPA (the backward
   against SDPA's backward with its backend pinned, by profiler device
   time beside that of delta + dK/dV + dQ); the quantizer on both of its
   routes (bf16, fp16 and float32 frames at tile 256 with NaN, inf and
   all-zero tiles, int8 and int4; tiles 1024 (vec), 2048, 64 and 7
   (generic); ragged leaves; a view 2 bytes off 16-byte alignment;
   rounding-ties and zero-scale tiles down each route), each case
   checked by the launch counters to take the route it names, the
   dequantizer, finalize (float32, bf16, fp16, int32 with rounding and
   ties, ragged n % 4 = 1, 2, 3, a view 4 bytes off 16-byte alignment)
   and momentum bit for bit, among them the VGG round's own shapes (the
   (32, 16, 16, 64) bf16 and float32 frames at tile 256, int8 and int4;
   the (4096, 4096) and (64,) float32 leaves); the codec and
   stage-update kernels then timed, beside their plain versions, library
   calls and bounds, at the VGG round's shapes (the bf16 int8 frame, the
   float32 int8 frame beside it, the (4096, 4096) leaf) and at the
   TinyLlama shapes of earlier slices (an (8, 256, 2048) frame, bf16
   int8, bf16 int4 and float32 int8; the (32000, 2048) leaf), by events
   and by profiler device time.  A tiny
   TinyLlama's logits and gradients through the flash kernels are held
   against its dense-attention path, and a tiny protocol round with every
   kernel flag on against the same round through the plain chains;
4. slice — one training round of full-width TinyLlama-1.1B
   (``configs/baseline5.yaml``: 4 stages, AdamW, bf16, batch 8,
   control-count 4, with ``use_flash: true``, 128 samples = 4 steps)
   through ``split_learning_torch.run.run_local`` on CUDA, with the
   kernels' launch counts zeroed just before and read just after (the
   bf16 forward takes the tensor-core kernel, 176 launches a step, each
   tensor-core backward kernel 88 a step, and the CUDA-core kernels are
   launched 0 times);
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
   round finalizes.  Counts zeroed before and read after (each
   tensor-core backward kernel 176 launches a round, the vec quantizer
   and the dequantizer 48, the CUDA-core kernels and the generic
   quantizer 0);
7. protocol_tcp — the same 2 rounds in the deployment shape: one
   ``python -m split_learning_torch.broker`` and one process each for the
   server and the five clients, all on the card, over TCP with the async
   sender and receive prefetch.  The samples and each kernel's launches
   across the processes must equal the in-process 2-round run's; reports
   the phase walls beside the in-process ones, the broker's bytes by
   queue family, each process's peak memory and the card's by
   ``nvidia-smi``;
8. vgg_step_check — one float32 VGG16/CIFAR10 train step (dropout off)
   on the CPU and on the card from the same weights, statistics and
   batch: loss, every new BatchNorm statistic and two gradients within
   stated tolerances;
9. vgg_slice — the default round in process (``run_local``) on
   ``config.yaml`` (1 round, ``[1, 1]``) and on
   ``configs/baseline1.yaml`` (5 rounds, ``[2, 2]``: two lockstep
   columns) as written, bf16, with every launch counter 0 (every
   ``kernels:`` flag is off); samples, validation, the checkpoint's
   parameters and statistics checked; then ``config.yaml``'s round once
   more, warm and traced (vgg_profile);
10. vgg_protocol — baseline 1 as the protocol round in one process with
   the int8 codec on both cut directions, every kernel flag on and the
   sharded fold: one round at ``server-momentum: 0.9``, one at 0.  The
   quantizer, dequantizer, momentum and finalize kernels must launch, the
   quantizer on bf16 activation frames and float32 gradient frames, once
   per frame, and every one of their launches is held bit for bit
   against the kernel's plain version on the same inputs;
11. vgg_tcp — ``config.yaml`` as processes over TCP (broker, server, two
   clients), one round, with the samples of the same round in one
   process;
12. summary — a ``{"kernels": [...]}`` line (each kernel's launches on
   its main path: the VGG protocol round for the codec and stage-update
   kernels, the TinyLlama protocol round for the flash kernels; every
   path's in ``launches_by_path``; the times and bounds at that path's
   shapes), then the last line ``{"ok": true,
   "device": {...}}``.

``python3 chip_smoke.py --participant MODULE ARG...`` is phase 7's
participant runner: it runs ``MODULE.main(ARG...)`` and prints that
process's launch counts and peak memory.

It imports nothing of JAX.  It exits non-zero, printing no result, when
there is no CUDA device or when the port's package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import signal
import tempfile
import threading
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
# the CUDA-core flash kernels: the float32 and D = 8 route
SIMT_KERNELS = ("flash_fwd_simt", "flash_bwd_dkv_simt", "flash_bwd_dq_simt")
# the kernels that the bf16 main paths must never launch: the CUDA-core
# flash kernels and the generic quantizer (the wire's tile 256 on an
# aligned frame takes the vec quantizer)
OFF_PATH_KERNELS = SIMT_KERNELS + ("quantize_generic",)
# one activation / gradient frame at a cut: (batch, sequence, hidden)
FRAME_SHAPE = (8, 256, 2048)
# the codec frames timed beside the bf16 int8 one of the kernel rows,
# each one FRAME_SHAPE frame at tile 256: (label, dtype, bits)
CODEC_FRAMES = (("bf16 int4", torch.bfloat16, 4),
                ("f32 int8", torch.float32, 8))
# the largest parameter leaf (embedding and LM head): (vocab, hidden)
LEAF_SHAPE = (32000, 2048)
# the VGG round's shapes, where the codec and stage-update kernels run on
# their main path: the cut-7 activation / gradient frame at batch 32
# (bf16 activations, float32 gradients, tile 256), the largest parameter
# leaf (layer 50's Dense) and the smallest statistics leaf
VGG_FRAME_SHAPE = (32, 16, 16, 64)
VGG_LEAF_SHAPE = (4096, 4096)
VGG_STATS_SHAPE = (64,)
# the VGG frames timed beside the bf16 int8 one of the kernel rows
VGG_CODEC_FRAMES = (("f32 int8", torch.float32, 8),)
SOURCES = ("flash_attention", "quant", "update")
# where the protocol phases run (a CPU rehearsal of the script sets "cpu")
DEVICE = "cuda"
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("split_learning_torch/csrc/flash_attention.cu",
                  "split_learning_tpu/ops/flash_attention.py:62"),
    "flash_fwd_simt": ("split_learning_torch/csrc/flash_attention.cu",
                       "split_learning_tpu/ops/flash_attention.py:62"),
    "flash_bwd_dkv": ("split_learning_torch/csrc/flash_attention.cu",
                      "split_learning_tpu/ops/flash_attention.py:134"),
    "flash_bwd_dq": ("split_learning_torch/csrc/flash_attention.cu",
                     "split_learning_tpu/ops/flash_attention.py:173"),
    "flash_bwd_dkv_simt": ("split_learning_torch/csrc/flash_attention.cu",
                           "split_learning_tpu/ops/flash_attention.py:134"),
    "flash_bwd_dq_simt": ("split_learning_torch/csrc/flash_attention.cu",
                          "split_learning_tpu/ops/flash_attention.py:173"),
    "quantize": ("split_learning_torch/csrc/quant.cu",
                 "split_learning_tpu/ops/kernels/quant.py:37"),
    "quantize_generic": ("split_learning_torch/csrc/quant.cu",
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

def _print_ptxas(text: str) -> None:
    """Each kernel's registers, spills and shared memory from nvcc's
    ``-Xptxas -v`` report, under the kernel's demangled name."""
    try:
        text = subprocess.run(["c++filt"], input=text, capture_output=True,
                              text=True, timeout=60).stdout or text
    except (OSError, subprocess.SubprocessError):
        pass
    func, spills = "?", ""
    for line in text.splitlines():
        body = line.split("ptxas info    :")[-1].strip()
        if "Compiling entry function" in body:
            func = _kernel_name(body.split("'")[1] if "'" in body else body)
        elif "spill" in body:
            spills = body
        elif "Used" in body:
            print(f"  ptxas: {func}: {body}; {spills}")


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
            _print_ptxas(log.read_text())
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
    if name.startswith("flash_fwd"):   # q,k,v -> o, lse; QK^T and PV
        return 4 * mat + row, 4 * d * pairs
    if name.startswith("flash_bwd_dkv"):   # q,k,v,dO,lse,delta -> dk,dv
        return 6 * mat + 2 * row, 8 * d * pairs
    return 5 * mat + 2 * row, 6 * d * pairs   # dq: 3 products


def phase_kernels() -> dict:
    from split_learning_torch.ops import flash_attention as fa

    cases = [("slice bf16 causal", SLICE_SHAPE, torch.bfloat16, True),
             ("bf16 D=128 S=256 causal", (16, 256, 128), torch.bfloat16,
              True),
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

        route = fa._fwd_route(dtype, shape[-1])
        sfx = "" if fa._bwd_route(dtype, shape[-1]) == "tc" else "_simt"
        dkv_name, dq_name = f"flash_bwd_dkv{sfx}", f"flash_bwd_dq{sfx}"

        def launched(call, want, what):
            before = dict(fa.LAUNCHES)
            out = call()
            took = {n for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]}
            check(took == {want}, f"{what} {label}: launched {took}, its "
                  f"route is {want}")
            return out

        o, lse = launched(lambda: fa.flash_fwd(q, k, v, causal), route,
                          "flash_fwd")
        dk, dv = launched(lambda: fa.flash_bwd_dkv(q, k, v, do, lse_in,
                                                   delta, causal),
                          dkv_name, "flash_bwd_dkv")
        dq = launched(lambda: fa.flash_bwd_dq(q, k, v, do, lse_in, delta,
                                              causal), dq_name,
                      "flash_bwd_dq")
        errs = {route: [("o", o, o_ref32), ("lse", lse, lse_ref)],
                dkv_name: [("dk", dk, dk_ref), ("dv", dv, dv_ref)],
                dq_name: [("dq", dq, dq_ref)]}
        if ci == 0:
            # the CUDA-core kernels at the slice's shapes too: they are
            # the float32 route, and the yardsticks of the tensor-core ones
            o_s, lse_s = fa._launch_fwd("flash_fwd_simt", q, k, v, causal)
            errs["flash_fwd_simt"] = [("o", o_s, o_ref32),
                                      ("lse", lse_s, lse_ref)]
            dk_s, dv_s = fa._launch_dkv("simt", q, k, v, do, lse_in, delta,
                                        causal)
            errs["flash_bwd_dkv_simt"] = [("dk", dk_s, dk_ref),
                                          ("dv", dv_s, dv_ref)]
            errs["flash_bwd_dq_simt"] = [("dq", fa._launch_dq(
                "simt", q, k, v, do, lse_in, delta, causal), dq_ref)]
        torch.cuda.synchronize()
        for name, outs in errs.items():
            worst = 0.0
            for kind, out, ref in outs:
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name} {label}: non-finite {kind}")
                err, ref_max = _max_err(out, ref)
                tol = _tolerance(dtype, kind, ref_max)
                print(f"  {name:18s} {label:24s} {kind:3s} max_abs_err "
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
            "flash_fwd_simt": (
                lambda: fa._launch_fwd("flash_fwd_simt", q, k, v, causal),
                lambda: fa.flash_fwd_reference(q, k, v, causal)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dq_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dkv_simt": (
                lambda: fa._launch_dkv("simt", q, k, v, do, lse_in, delta,
                                       causal),
                lambda: fa.flash_bwd_dkv_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dq_simt": (
                lambda: fa._launch_dq("simt", q, k, v, do, lse_in, delta,
                                      causal),
                lambda: fa.flash_bwd_dq_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
        }
        b, h = 8, 32
        q4, k4, v4 = (t.view(b, h, shape[1], shape[2]) for t in (q, k, v))
        sdpa = (lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True))
        library = {"flash_fwd": sdpa, "flash_fwd_simt": sdpa}
        bwd_ms = _backward_yardstick(q, k, v, do, o, lse_in, causal,
                                     (q4, k4, v4))
        for name, (kern, plain) in runs.items():
            nbytes, flops = _bytes_and_flops(name, shape, dtype, causal)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            r = results[name]
            r["ms"] = _time_ms(kern)
            r["device_ms"] = _device_ms(kern)[0]
            r["plain_ms"] = _time_ms(plain)
            # the backward's library call computes dq, dk and dv together
            # (timed by device time only)
            r["library_ms"] = (_time_ms(library[name]) if name in library
                               else bwd_ms)
            r["library_device_ms"] = (_device_ms(library[name])[0]
                                      if name in library else bwd_ms)
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            r["bytes"], r["flops"] = nbytes, flops
            print(f"  {name:18s} kernel {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f})  plain "
                  f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return results


def _device_ms(fn, reps: int = 20) -> tuple[float, dict]:
    """Device time of one ``fn()`` in ms from ``torch.profiler`` (CUPTI),
    each of ``reps`` runs after the L2 flush of :func:`_time_ms` (whose
    own fill kernel is left out), and the time of each kernel it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _time_ms(fn, reps=1, warmup=3)   # warm, and the flush buffer made
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _FLUSH.zero_()
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or _device_us(e) <= 0
                or "FillFunctor<unsigned char>" in e.key):
            continue
        name = _kernel_name(e.key)
        per[name] = per.get(name, 0.0) + _device_us(e) / 1e3 / reps
    return sum(per.values()), per


def _sdpa_backward(q4, k4, v4, do4):
    """SDPA's backward (dq, dk and dv together) as one autograd call on
    one recorded node, its backend pinned: the first of cuDNN, flash and
    memory-efficient attention that takes these inputs.  Returns the
    call and the backend's name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q4, k4, v4))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                            retain_graph=True),
                backend.name)
    raise SmokeFailure("no SDPA backend takes the slice's shapes")


def _backward_yardstick(q, k, v, do, o, lse, causal, qkv4) -> float:
    """The library's backward at the slice's shapes against the port's:
    profiler device time of SDPA's backward (pinned backend) beside that
    of the port's backward as ``_Flash.backward`` runs it on the bf16
    route — the ``delta`` pre-pass, then dK/dV and dQ.  Returns the
    library's device time in ms."""
    from split_learning_torch.ops import flash_attention as fa
    lib_call, backend = _sdpa_backward(*qkv4, do.view_as(qkv4[0]))
    lib_ms, lib_split = _device_ms(lib_call)
    print(f"  sdpa backward ({backend}; dq, dk, dv in one call): device "
          f"{lib_ms:.4f} ms, events {_time_ms(lib_call):.4f} ms; kernels "
          + ", ".join(f"{n[:60]} {t:.4f}" for n, t in lib_split.items()))

    def port_backward():
        delta = (do.float() * o.float()).sum(dim=-1)
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    ms, split = _device_ms(port_backward)
    print(f"  port backward (delta + dK/dV + dQ): device {ms:.4f} ms = "
          f"{ms / lib_ms:.2f}x the library's; kernels "
          + ", ".join(f"{n[:60]} {t:.4f}" for n, t in split.items()))
    return lib_ms


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
    phase_loss_check()


def phase_loss_check(devices=("cpu", "cuda")) -> None:
    """The pipeline's bf16 cross entropy on the card against the same
    function on the CPU (which tests/test_torch_bf16_loss.py holds equal
    to optax's): bf16 logits (512, 32000), sigma 3, from a numpy seed.
    The loss must be equal and the logits' gradients within one bf16 ulp
    of the largest gradient."""
    import numpy as np
    from split_learning_torch.parallel.pipeline import PipelineModel
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((512, 32000)) * 3).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 32000, 512))
    out = []
    for dev in devices:
        xd = x.clone().to(dev).requires_grad_(True)
        loss = PipelineModel.loss_from_logits(xd, y.to(dev))
        loss.backward()
        out.append((float(loss.detach()), xd.grad.float().cpu()))
    (cpu, cpu_g), (card, card_g) = out
    f32 = float(F.cross_entropy(x.float(), y))
    gerr = float((cpu_g - card_g).abs().max())
    gmax = float(cpu_g.abs().max())
    print(f"  bf16 loss (512, 32000): card {card} cpu {cpu} float32 "
          f"{f32:.6f}; grads max_abs_err {gerr:.3e} (tol "
          f"{2 ** -8 * gmax:.3e})")
    check(card == cpu and gerr <= 2 ** -8 * gmax,
          "bf16 loss on the card differs from the CPU's")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes (NaN payloads compare as bits)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _bitwise(name: str, label: str, out, ref) -> None:
    same = (out.dtype == ref.dtype and out.shape == ref.shape
            and torch.equal(_bits(out), _bits(ref)))
    print(f"  {name:10s} {label:36s} bitwise {'equal' if same else 'DIFFER'}")
    check(same, f"{name} {label}: kernel differs from its plain version")


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of memory traffic and ``ops``
    float32 operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_triple(name: str, kern, plain, library, nbytes: int,
                 ops: int) -> dict:
    """Kernel, plain and library times plus the bound (bytes over the
    memory rate or float32 operations over the CUDA-core rate).  The
    kernel and the library call are timed twice: by CUDA events
    (``ms``, ``library_ms``) and by profiler device time
    (``device_ms``, ``library_device_ms``), which leaves out the
    events' own ≈ 4–6 µs — as long as a codec kernel's bound."""
    bound, by = _bound(nbytes, ops)
    r = {"ms": _time_ms(kern), "device_ms": _device_ms(kern)[0],
         "plain_ms": _time_ms(plain),
         "library_ms": _time_ms(library) if library is not None else None,
         "library_device_ms": (_device_ms(library)[0]
                               if library is not None else None),
         "bound_ms": bound, "bound_by": by,
         "bytes": nbytes, "ops": ops, "max_abs_err": 0.0}
    lib = ("none" if library is None else f"{r['library_ms']:.4f} ms "
           f"(device {r['library_device_ms']:.4f})")
    print(f"  {name:16s} kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f})  plain {r['plain_ms']:.4f} ms  library "
          f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop)")
    return r


def _codec_frames(g, shape, frames) -> dict:
    """Events and profiler device time of the quantizer (both routes:
    the generic kernel is the vec kernel's predecessor) and the
    dequantizer on each ``(label, dtype, bits)`` of ``frames`` at
    ``shape``, and of ``torch.mul`` (the dequantizer's library
    yardstick) on the int8 codes, each beside its bound."""
    from split_learning_torch.ops.kernels import quant as kq
    out = {}
    for label, dtype, bits in frames:
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
        n, t_count = x.numel(), x.numel() // 256
        q, s = kq.quantize_tiles(x, tile=256, bits=bits)
        codes_b = q.numel()
        quant_b = x.element_size() * n + codes_b + 4 * t_count
        calls = {f"quantize {route}": (
            lambda route=route: kq._launch_quantize(route, x, 256, bits),
            quant_b, 5 * n) for route in kq.QUANT_ROUTES}
        calls["dequantize"] = (
            lambda: kq.dequantize_tiles(q, s, tile=256, bits=bits),
            codes_b + 4 * t_count + 4 * n, n)
        if bits == 8:
            calls["torch.mul"] = (
                lambda: torch.mul(q.view(t_count, 256), s[:, None]),
                codes_b + 4 * t_count + 4 * n, n)
        rows = {}
        for name, (fn, nbytes, ops) in calls.items():
            bound, by = _bound(nbytes, ops)
            rows[name] = {"ms": _time_ms(fn), "device_ms": _device_ms(fn)[0],
                          "bound_ms": bound, "bound_by": by}
            r = rows[name]
            share = r["bound_ms"] / r["device_ms"]
            print(f"  codec frame {label:9s} {name:20s} device "
                  f"{r['device_ms']:.4f} ms ({share:.0%} of the bound "
                  f"{r['bound_ms']:.4f}), events {r['ms']:.4f}")
        out[label] = rows
    return out


def _launched(kq, call, route: str, label: str):
    """``call()``, checked by the launch counters to launch the
    quantizer kernel of ``route`` and no other kernel."""
    before = dict(kq.LAUNCHES)
    out = call()
    took = {k for k in kq.LAUNCHES if kq.LAUNCHES[k] != before[k]}
    check(took == {kq.QUANT_ROUTES[route]},
          f"quantize {label}: launched {took}, expected route {route}")
    return out


def _wire_times(frame, acc, base, vel, tw: float) -> dict:
    """The kernel rows of the codec and stage-update kernels: each timed
    beside its plain version, its library call and its bound, on one
    activation ``frame`` at tile 256 (int8, both quantizer routes) and
    one float32 parameter leaf ``acc`` (with ``base`` and ``vel`` for
    momentum)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    n, esize = frame.numel(), frame.element_size()
    q, s = kq.quantize_tiles(frame, tile=256, bits=8)
    t_count = s.numel()
    tw_t = torch.tensor(tw, dtype=torch.float32, device="cuda")
    leaf_n = acc.numel()
    return {
        # float in, int8 codes + float32 scales out; abs, max, divide,
        # round and clip a value.  Both routes on the same frame
        "quantize": _time_triple(
            "quantize", lambda: kq.quantize_tiles(frame, tile=256, bits=8),
            lambda: kq.quantize_reference(frame, 256, 8), None,
            esize * n + n + 4 * t_count, 5 * n),
        "quantize_generic": _time_triple(
            "quantize_generic",
            lambda: kq._launch_quantize("generic", frame, 256, 8),
            lambda: kq.quantize_reference(frame, 256, 8), None,
            esize * n + n + 4 * t_count, 5 * n),
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


def phase_wire_kernels() -> dict:
    """The quantizer (each case on the route it names), dequantizer and
    stage-update kernels against their plain versions, bit for bit —
    among the cases the VGG round's own shapes, its main path — then
    timed (:func:`_wire_times`) at those shapes: the bf16 cut-7 frame
    (32 x 16 x 16 x 64, tile 256; the float32 gradient frame beside it)
    and layer 50's float32 (4096 x 4096) leaf.  The TinyLlama shapes
    timed by earlier slices (an 8 x 256 x 2048 bf16 frame and the
    32000 x 2048 leaf, with the :data:`CODEC_FRAMES`) stand beside
    them in each row's ``tinyllama_shapes``."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    g = torch.Generator(device="cuda").manual_seed(23)

    def wire_frame(dtype):
        x = (torch.randn(FRAME_SHAPE, generator=g, device="cuda") * 3).to(
            dtype)
        flat = x.view(-1)
        flat[256 * 5:256 * 6] = 0               # an all-zero tile
        flat[256 * 9 + 17] = float("nan")       # a NaN tile
        flat[256 * 12 + 3] = float("inf")       # an inf tile
        return x

    frame = wire_frame(torch.bfloat16)
    frame16, frame32 = wire_frame(torch.float16), wire_frame(torch.float32)
    odd = torch.randn(1001, generator=g, device="cuda") * 2
    odd[40] = float("-inf")
    # a ragged leaf whose last tile (and, in bf16, last 16-byte chunk)
    # is partial
    ragged = (torch.randn(256 * 37 + 77, generator=g, device="cuda")
              * 3).to(torch.bfloat16)
    # 2 bytes off 16-byte alignment: the generic route
    shifted = frame.view(-1)[1:1 + 256 * 64]
    vgg16 = (torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda")
             * 3).to(torch.bfloat16)
    vgg32 = torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda") * 1e-3
    cases = []
    for bits in (8, 4):
        cases += [
            (f"VGG frame bf16 int{bits} tile 256", vgg16, 256, bits, "vec"),
            (f"VGG frame f32 int{bits} tile 256", vgg32, 256, bits, "vec"),
            (f"slice frame bf16 int{bits} tile 256", frame, 256, bits, "vec"),
            (f"frame fp16 int{bits} tile 256", frame16, 256, bits, "vec"),
            (f"frame f32 int{bits} tile 256", frame32, 256, bits, "vec"),
            (f"bf16 int{bits} tile 1024", frame, 1024, bits, "vec"),
            (f"f32 int{bits} tile 1024", frame32, 1024, bits, "vec"),
            (f"bf16 int{bits} tile 2048", frame, 2048, bits, "generic"),
            (f"bf16 int{bits} tile 64", frame, 64, bits, "generic"),
            (f"ragged bf16 int{bits} tile 256 n=9549", ragged, 256, bits,
             "vec"),
            (f"ragged f32 int{bits} tile 256 n=1001", odd, 256, bits,
             "vec"),
            (f"ragged f32 int{bits} tile 7 n=1001", odd, 7, bits,
             "generic"),
            (f"view +2 B bf16 int{bits} tile 256", shifted, 256, bits,
             "generic")]
    for label, x, tile, bits, route in cases:
        q, s = _launched(kq, lambda: kq.quantize_tiles(x, tile=tile,
                                                       bits=bits),
                         route, label)
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
    # Edge tiles, bitwise against the plain version on both routes:
    # amax = qmax, so scale 1, holding values half-way between two codes
    # (round half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0); and a float32
    # tile whose amax / 127 underflows to a zero scale (its values
    # decode to zeros, so it has no round trip to check).
    for bits in (8, 4):
        qmax = 127.0 if bits == 8 else 7.0
        ties = torch.tensor([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5],
                            device="cuda").repeat(32)
        ties[7] = qmax
        tiny = torch.zeros(256, device="cuda")
        tiny[:4] = torch.tensor([3e-45, -3e-45, 1.4e-45, -0.0])
        edges = [(f"ties bf16 int{bits}", ties.to(torch.bfloat16)),
                 (f"ties f32 int{bits}", ties),
                 (f"zero scale f32 int{bits}", tiny)]
        for label, x in edges:
            for route in kq.QUANT_ROUTES:
                q, s = _launched(kq, lambda: kq._launch_quantize(
                    route, x, 256, bits), route, label)
                qr, sr = kq.quantize_reference(x, 256, bits)
                torch.cuda.synchronize()
                _bitwise("quantize", f"{label} {route} codes", q, qr)
                _bitwise("quantize", f"{label} {route} scales", s, sr)
                _bitwise("dequantize", f"{label} {route}",
                         kq.dequantize_tiles(q, s, tile=256, bits=bits),
                         kq.dequantize_reference(q, s, 256, bits))

    acc = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 50
    small = torch.randn(4096, 64, generator=g, device="cuda") * 50
    tw = 64.0   # the slice's fold weight: two edge clients x 32 samples
    ties = torch.arange(-40, 40, device="cuda").float() * 32.0
    # a contiguous view 4 bytes off 16-byte alignment: the scalar
    # prologue, then float4 loads with element stores
    shifted = acc.view(-1)[1:]
    finalize_cases = [("leaf f32", acc, torch.float32, False),
                      ("leaf bf16", acc, torch.bfloat16, False),
                      ("leaf fp16", acc, torch.float16, False),
                      ("int32 with rounding", small, torch.int32, True),
                      ("odd 0.5 ties int32", ties, torch.int32, True),
                      ("view +4 B f32", shifted, torch.float32, False),
                      ("view +4 B bf16", shifted, torch.bfloat16, False)]
    for r in (1, 2, 3):   # ragged leaves: the scalar epilogue
        ragged = small.view(-1)[:4096 + r]
        finalize_cases += [(f"ragged n%4={r} f32", ragged, torch.float32,
                            False),
                           (f"ragged n%4={r} bf16", ragged, torch.bfloat16,
                            False),
                           (f"ragged n%4={r} int32 rnd", ragged,
                            torch.int32, True)]
    # the VGG round's leaves: layer 50's Dense kernel and a statistics
    # leaf, folded over its four clients' weights
    vgg_acc = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda") * 50
    vgg_stat = torch.rand(VGG_STATS_SHAPE, generator=g, device="cuda") * 9
    vgg_tw = 4 * 2496.0
    finalize_cases += [("VGG leaf 4096x4096 f32", vgg_acc, torch.float32,
                        False),
                       ("VGG statistics (64,) f32", vgg_stat, torch.float32,
                        False)]
    for label, a, dt, rnd in finalize_cases:
        _bitwise("finalize", label, ku.finalize_leaf(a, tw, dt, rnd=rnd),
                 ku.finalize_reference(a, tw, dt, rnd))
    base = torch.randn(LEAF_SHAPE, generator=g, device="cuda")
    vel = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 0.01
    vgg_base = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda")
    vgg_vel = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda") * 0.01
    momentum_cases = [
        ("leaf", acc, base, vel, tw),
        ("VGG leaf 4096x4096", vgg_acc, vgg_base, vgg_vel, vgg_tw),
        ("VGG statistics (64,)", vgg_stat, vgg_stat * 0.5,
         vgg_stat * 0.01, vgg_tw)]
    for label, a, b, v, w in momentum_cases:
        p, nv = ku.momentum_leaf(a, b, v, w, 0.9, torch.float32)
        pr, nvr = ku.momentum_reference(a, b, v, w, 0.9, torch.float32)
        _bitwise("momentum", f"{label} params", p, pr)
        _bitwise("momentum", f"{label} velocity", nv, nvr)
    p, nv = ku.momentum_leaf(small, small * 0.5, small * 0.1, 3.0, 0.5,
                             torch.bfloat16)
    pr, nvr = ku.momentum_reference(small, small * 0.5, small * 0.1, 3.0,
                                    0.5, torch.bfloat16)
    _bitwise("momentum", "bf16 params", p, pr)
    _bitwise("momentum", "bf16 velocity", nv, nvr)

    # times at the VGG round's shapes, then at the TinyLlama shapes
    print("  times at the VGG round's shapes (frame bf16 "
          f"{VGG_FRAME_SHAPE} tile 256, leaf f32 {VGG_LEAF_SHAPE}):")
    vgg_frame = (torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda")
                 * 3).to(torch.bfloat16)
    out = _wire_times(vgg_frame, vgg_acc, vgg_base, vgg_vel, vgg_tw)
    vgg_frames = _codec_frames(g, VGG_FRAME_SHAPE, VGG_CODEC_FRAMES)
    print("  times at the TinyLlama shapes (frame bf16 "
          f"{FRAME_SHAPE} tile 256, leaf f32 {LEAF_SHAPE}):")
    tiny = _wire_times(frame, acc, base, vel, tw)
    tiny["quantize"]["frames"] = _codec_frames(g, FRAME_SHAPE, CODEC_FRAMES)
    for name, r in out.items():
        r["shapes"] = ("frame bf16 (32, 16, 16, 64) tile 256"
                       if name.startswith(("quantize", "dequantize"))
                       else "leaf f32 (4096, 4096)")
        r["tinyllama_shapes"] = tiny[name]
    out["quantize"]["frames"] = vgg_frames
    return out


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
    # the bf16 kernels are the tensor-core ones; the CUDA-core kernels
    # are the float32 route and must not run here
    for name, n in launches.items():
        if name in SIMT_KERNELS:
            check(n == 0, f"the CUDA-core {name} ran {n} times on the bf16 "
                  "main path")
        else:
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
    # forward twice per block per microbatch under the wide remat policy
    check(per_step["flash_fwd"] == 2 * n_block * lrn.control_count,
          f"tensor-core forward launches per step {per_step['flash_fwd']}, "
          f"expected {2 * n_block * lrn.control_count}")
    # the backward once per block per microbatch
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        check(per_step[name] == n_block * lrn.control_count,
              f"tensor-core {name} launches per step {per_step[name]}, "
              f"expected {n_block * lrn.control_count}")
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


def _kernel_name(key: str) -> str:
    """``void (anonymous namespace)::k<T, 64>(args)`` -> ``k<T, 64>``."""
    key = key.replace("(anonymous namespace)::", "")
    return key.removeprefix("void ").split("(")[0]


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
    flash = [e for e in kernels if "flash_" in e.key]
    for e in flash:
        print(f"    flash: {_device_us(e) / 1e3:.1f} ms {e.count}x  "
              f"{_kernel_name(e.key)}")
    return {"round_walls_s": walls, "run_wall_s": wall,
            "device_busy_s": busy_s, "idle_share": 1 - busy_s / wall,
            "top_kernels": [{"name": e.key[:120], "count": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in top],
            "flash_kernels": [{"name": _kernel_name(e.key),
                               "count": e.count,
                               "device_ms": _device_us(e) / 1e3}
                              for e in flash]}


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


def run_protocol_tcp_threads(cfg, timeout: float = 600.0):
    """The protocol deployment with every frame over TCP, participants
    in threads of this process: a :class:`Broker` on a free port, and the
    server and each client building their transport stack from the
    config (``make_runtime_transport``: TCP, receive prefetch, the async
    sender)."""
    import threading as th
    from split_learning_torch.runtime.bus import Broker
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import ProtocolServer
    broker = Broker("127.0.0.1", 0)
    errors = []
    try:
        cfg = dataclasses.replace(cfg, transport=dataclasses.replace(
            cfg.transport, kind="tcp", port=broker.port))
        server = ProtocolServer(cfg, device=DEVICE, client_timeout=timeout,
                                logger=Logger.for_run(cfg, "server"))
        clients = [ProtocolClient(cfg, f"client_{s}_{i}", s, device=DEVICE)
                   for s, n in enumerate(cfg.clients, start=1)
                   for i in range(n)]

        def run(c):
            try:
                c.run()
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        threads = [th.Thread(target=run, args=(c,), daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        res = server.serve()
        for t in threads:
            t.join(timeout=120)
    except Exception as e:
        raise SmokeFailure(f"TCP protocol round failed: {e!r}") from e
    finally:
        broker.close()
    check(not errors and not any(t.is_alive() for t in threads),
          f"TCP protocol client failed: {errors}")
    return res


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


def phase_protocol_check(workdir: pathlib.Path) -> dict:
    """A tiny float32 protocol round (3 stages, int8 codec, CUDA fold
    with momentum) on the card twice: every kernel flag on, then every
    flag off (the plain chains on the card).  With one batch in flight
    each stage steps in a fixed order, and each kernel equals its plain
    version bit for bit, so the two runs' validation losses and final
    parameters must agree to float32 noise (1e-5: cuBLAS may pick other
    GEMM algorithms between the runs).  Then the kernels-on round once
    more with every frame over TCP (participants in threads, the async
    sender), held to the in-process one the same way.  Its float32 forward and backward
    take the CUDA-core kernels: returns their launches, and the codec
    kernels' (either quantizer route may run here), in the first run."""
    from split_learning_torch.config import from_dict
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq

    runs = []
    for flags in (True, False):
        d = dict(TINY_PROTOCOL, **{"log-path": str(workdir / f"tiny{flags}"),
                                   "kernels": {"quantize": flags,
                                               "dequantize": flags,
                                               "stage-update": flags}})
        fa.reset_launches()
        kq.reset_launches()
        _, _, _, res = run_protocol(from_dict(d), timeout=120)
        if flags:
            codec = dict(kq.LAUNCHES)
            simt = {n: fa.LAUNCHES[n] for n in SIMT_KERNELS}
            check(all(simt.values()) and not any(
                fa.LAUNCHES[n] for n in fa.LAUNCHES if n not in simt),
                  f"tiny float32 round: flash launches {fa.LAUNCHES}, "
                  "expected the CUDA-core kernels only")
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
    # the same kernels-on round with every frame over TCP: the codec,
    # fetch and encode of each activation and gradient run on the async
    # sender thread, on the training thread's stream
    d = dict(TINY_PROTOCOL, **{"log-path": str(workdir / "tiny_tcp"),
                               "kernels": {"quantize": True,
                                           "dequantize": True,
                                           "stage-update": True}})
    tcp = run_protocol_tcp_threads(from_dict(d), timeout=120)
    tcp_loss = max(abs(a.val_loss - b.val_loss)
                   for a, b in zip(on.history, tcp.history))
    tcp_param = max(float((on.params[layer][k] - t).abs().max())
                    for layer, sd in tcp.params.items()
                    for k, t in sd.items())
    print(f"  tiny protocol round over TCP (async sender) vs in process: "
          f"samples {[r.num_samples for r in tcp.history]}, max |loss "
          f"diff| {tcp_loss:.3e}, max |param diff| {tcp_param:.3e} "
          "(tol 1e-5)")
    check([r.num_samples for r in tcp.history]
          == [r.num_samples for r in on.history]
          and tcp_loss <= 1e-5 and tcp_param <= 1e-5,
          "tiny protocol round over TCP differs from the in-process one")
    print(f"  tiny float32 round: CUDA-core kernels launched {simt}, "
          f"codec kernels {codec}")
    return {**simt, **codec}


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


def phase_protocol(workdir: pathlib.Path) -> dict:
    from split_learning_torch.runtime.bus import queue_family
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    reset, read = _reset_launches, _launch_counts

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
        actual[queue_family(q)] = actual.get(queue_family(q), 0) + nb
    raw: dict = {}
    for c in clients:
        for q, nb in c.raw_bytes_out.items():
            raw[queue_family(q)] = raw.get(queue_family(q), 0) + nb
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
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the bf16 protocol path")
        else:
            check(n > 0, f"kernel {name} was not launched on the protocol "
                  "path")
    # the backward once per block per training batch of the round; the
    # vec quantizer and the dequantizer once per training batch per cut
    # per direction
    batches = n_edge * cfg.distribution.num_samples // lrn.batch_size
    per_round = mk.get("n_block", 22) * batches
    frames = batches * len(cfg.topology.cut_layers) * 2
    for name, want in (("flash_bwd_dkv", per_round),
                       ("flash_bwd_dq", per_round), ("quantize", frames),
                       ("dequantize", frames)):
        got = (launches[name] / len(res.history), launches0[name])
        check(got == (want, want), f"{name} launches per protocol round "
              f"{got}, expected {want}")

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


# --------------------------------------------------------------------------
# 7. protocol_tcp: the deployment shape, one process per participant
# --------------------------------------------------------------------------

#: the prefix of the one JSON line each participant runner prints
PARTICIPANT_TAG = "chip_smoke participant: "


def _launch_counts() -> dict:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    return {**fa.LAUNCHES, **kq.LAUNCHES, **ku.LAUNCHES}


def participant_main(argv: list) -> int:
    """``chip_smoke.py --participant MODULE ARG...``: run one protocol
    participant, ``MODULE.main(ARG...)``, in this process, then print one
    line, :data:`PARTICIPANT_TAG` and a JSON object: the process's kernel
    launch counts (sender thread included) and its peak device memory."""
    import importlib
    module, args = argv[0], argv[1:]
    t0 = time.perf_counter()
    role = importlib.import_module(module).main(args)
    wall = time.perf_counter() - t0
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    # the role's async sender: seconds waited for room, in thunks (codec,
    # fetch, encode) and on the socket
    bus = getattr(role, "bus", None) or getattr(
        getattr(role, "ctx", None), "bus", None)
    print(PARTICIPANT_TAG + json.dumps({
        "module": module, "argv": args, "wall_s": wall,
        "sender": {k: getattr(bus, k) for k in (
            "send_hwm", "publish_wait_s", "thunk_s", "send_s")
            if hasattr(bus, k)},
        "launches": _launch_counts(),
        "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated() if cuda else 0,
        "max_memory_reserved_bytes":
            torch.cuda.max_memory_reserved() if cuda else 0}), flush=True)
    return 0


class _SmiPoll:
    """The card's used memory by ``nvidia-smi``, polled every second in
    a thread while a phase runs; :attr:`peak_mib` is the largest
    reading."""

    def __init__(self):
        self.peak_mib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.split()
                self.peak_mib = max([self.peak_mib, *map(int, out[:1])])
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
            self._stop.wait(1.0)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=60)
        return self.peak_mib


def _read_port(log: pathlib.Path, proc, deadline: float) -> int:
    while time.monotonic() < deadline:
        text = log.read_text()
        if "python broker on" in text:
            return int(text.split("python broker on ")[1].split()[0]
                       .rsplit(":", 1)[1])
        check(proc.poll() is None, f"broker exited: {text[-2000:]}")
        time.sleep(0.1)
    raise SmokeFailure("broker did not start")


def _metrics(log_path: pathlib.Path) -> list:
    """Every metrics record the participants wrote under ``log_path``."""
    return [json.loads(line)
            for f in sorted(log_path.glob("artifacts/runs/*/metrics.jsonl"))
            for line in f.read_text().splitlines() if line.strip()]


def _run_tcp(d: pathlib.Path, make_cfg, timeout: float) -> tuple:
    """One protocol deployment as processes, all on ``cuda:0``: one
    ``python -m split_learning_torch.broker`` and, through
    :func:`participant_main`, one ``split_learning_torch.server`` and one
    ``split_learning_torch.client`` per configured client, over TCP
    (async sender and receive prefetch, as ``make_runtime_transport``
    builds them).  ``make_cfg(d)`` gives the configuration, whose
    transport is pointed at the broker here.  All run in one process
    group, killed on any failure.  Returns (the configuration, the wall,
    the broker's stats frame, each participant's report, the card's peak
    used memory by ``nvidia-smi``)."""
    from split_learning_torch.config import to_dict
    from split_learning_torch.runtime.bus import (
        BROKER_STATS_QUEUE, TcpTransport,
    )

    d.mkdir(parents=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()   # this process's cache from earlier phases
    procs: dict = {}
    group = None

    def spawn(name: str, args: list):
        nonlocal group
        log = d / f"{name}.log"
        procs[name] = (subprocess.Popen(
            [sys.executable, *args], cwd=HERE, stdout=log.open("w"),
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONUNBUFFERED": "1"},
            process_group=0 if group is None else group), log)
        if group is None:
            group = procs[name][0].pid
        return procs[name][0]

    deadline = time.monotonic() + timeout
    smi = _SmiPoll()
    t0 = time.perf_counter()
    try:
        broker = spawn("broker", ["-m", "split_learning_torch.broker",
                                  "--port", "0"])
        port = _read_port(procs["broker"][1], broker, deadline)
        cfg = make_cfg(d)
        cfg = dataclasses.replace(cfg, transport=dataclasses.replace(
            cfg.transport, kind="tcp", port=port))
        cfg_path = d / "config.json"   # JSON is YAML
        cfg_path.write_text(json.dumps(to_dict(cfg)))
        common = ["--config", str(cfg_path), "--device", DEVICE]
        me = [str(HERE / "chip_smoke.py"), "--participant"]
        spawn("server", [*me, "split_learning_torch.server", *common,
                         "--client_timeout", str(timeout)])
        for s, n in enumerate(cfg.clients, start=1):
            for i in range(n):
                cid = f"client_{s}_{i}"
                spawn(cid, [*me, "split_learning_torch.client", *common,
                            "--layer_id", str(s), "--client_id", cid])
        for name, (p, log) in procs.items():
            if name == "broker":
                continue
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{name} missed the {timeout:.0f} s "
                                   "deadline") from None
            check(rc == 0, f"{name} exited {rc}: "
                  f"{log.read_text()[-3000:]}")
        wall = time.perf_counter() - t0
        probe = TcpTransport("127.0.0.1", port)
        stats = json.loads(bytes(probe.get(BROKER_STATS_QUEUE, 30)))
        probe.close()
        broker.terminate()
        check(broker.wait(timeout=30) == 0, "broker did not exit cleanly")
    finally:
        card_peak_mib = smi.stop()
        if group is not None:
            try:
                os.killpg(group, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p, _ in procs.values():
            p.wait(timeout=30)

    reports = {}
    for name, (_, log) in procs.items():
        if name == "broker":
            continue
        lines = [ln for ln in log.read_text().splitlines()
                 if ln.startswith(PARTICIPANT_TAG)]
        check(len(lines) == 1, f"{name} printed no report")
        reports[name] = json.loads(lines[0][len(PARTICIPANT_TAG):])
    return cfg, wall, stats, reports, card_peak_mib


def phase_protocol_tcp(workdir: pathlib.Path, inproc: dict,
                       timeout: float = 900.0) -> dict:
    """The protocol round in its deployment shape (:func:`_run_tcp`):
    the broker, the server and one process per client of ``clients: [2,
    1, 1, 1]``, at the in-process ``protocol`` phase's configuration (2
    rounds of FedAvgM 0.9).  ``inproc`` is that phase's result: the
    samples and the kernel launches must equal its 2-round run's."""
    cfg, wall, stats, reports, card_peak_mib = _run_tcp(
        workdir / "tcp",
        lambda d: protocol_config(d, momentum=0.9, rounds=2), timeout)
    launches = {k: sum(r["launches"].get(k, 0) for r in reports.values())
                for k in reports["server"]["launches"]}

    records = _metrics(pathlib.Path(cfg.log_path))
    phases = [r for r in records if r.get("kind") == "phases"]
    aggs = [r for r in records if r.get("kind") == "agg"]
    rounds = sorted((r for r in records if r.get("kind") == "round"),
                    key=lambda r: r["round_idx"])
    n_rounds = cfg.global_rounds
    check(len(rounds) == len(phases) == len(aggs) == n_rounds,
          f"expected {n_rounds} rounds, phases and folds: {len(rounds)}, "
          f"{len(phases)}, {len(aggs)}")
    want = [r["samples"] for r in inproc["rounds"]]
    for rec, agg, n in zip(rounds, aggs, want):
        check(rec["ok"] and math.isfinite(rec["val_loss"]),
              f"TCP round not ok: {rec}")
        check(rec["num_samples"] == n, f"TCP round {rec['round_idx']}: "
              f"{rec['num_samples']} samples, in-process {n}")
        check(agg["folded"] == sum(cfg.clients),
              f"TCP round folded {agg['folded']} of {sum(cfg.clients)}")
    for name, n in launches.items():
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the TCP path")
    for name in ("quantize", "dequantize", "momentum", "flash_fwd",
                 "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches[name] > 0, f"kernel {name} was not launched on "
              "the TCP path")
        check(launches[name] == inproc["launches"][name],
              f"{name}: {launches[name]} launches over TCP, "
              f"{inproc['launches'][name]} in process")

    out = {
        "run_wall_s": wall, "rounds": [
            {"round": r["round_idx"], "wall_s": r["wall_s"],
             "samples": r["num_samples"], "val_loss": r["val_loss"]}
            for r in rounds],
        "phases": [{k: v for k, v in p.items() if k.endswith("_s")}
                   for p in phases],
        "inproc_phases": inproc["phases"],
        "launches": launches,
        "launches_per_round": {k: v / n_rounds for k, v in launches.items()},
        "broker": {k: stats[k] for k in (
            "bytes_in", "bytes_out", "published", "delivered", "depth_hwm",
            "stored_bytes_hwm", "get_timeouts", "backpressure_pauses",
            "published_bytes_by_family", "delivered_bytes_by_family")},
        "processes": {n: {k: r[k] for k in (
            "wall_s", "max_memory_allocated_bytes",
            "max_memory_reserved_bytes", "sender")}
            for n, r in reports.items()},
        # the server's send queue: cumulative at each round's end
        "server_sender": [{k: w[k] for k in w if k.startswith(
            "cumulative_")} for w in records if w.get("kind") == "wire"],
        "card_memory_used_peak_mib": card_peak_mib,
    }
    for r, p, q in zip(out["rounds"], out["phases"], inproc["phases"]):
        print(f"  TCP round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, val_loss {r['val_loss']:.4f}; "
              "phases " + ", ".join(
                  f"{k} {v:.3f} (in process {q.get(k, float('nan')):.3f})"
                  for k, v in p.items()))
    print(f"  TCP run {wall:.3f} s; broker in {stats['bytes_in']} B, out "
          f"{stats['bytes_out']} B, published by family "
          f"{stats['published_bytes_by_family']}, queue high-water "
          f"{stats['stored_bytes_hwm']} B, backpressure pauses "
          f"{stats['backpressure_pauses']}")
    for n, r in out["processes"].items():
        print(f"  {n}: peak allocated "
              f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
              f"reserved {r['max_memory_reserved_bytes'] / 2**30:.2f} GiB, "
              f"wall {r['wall_s']:.1f} s, sender {r['sender']}")
    print(f"  server send queue at each round's end: {out['server_sender']}")
    print(f"  card memory used, peak by nvidia-smi: {card_peak_mib} MiB; "
          f"launches {launches}")
    return out


# --------------------------------------------------------------------------
# 8-11. the default round: VGG16/CIFAR10 with BatchNorm statistics
# --------------------------------------------------------------------------

def vgg_config(workdir: pathlib.Path, path: str):
    """The YAML at ``path`` as written, with its checkpoints and logs in
    ``workdir``."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / path)
    return dataclasses.replace(
        cfg, checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=str(workdir / "ckpt")),
        log_path=str(workdir / "logs")).validate()


def _reset_launches() -> None:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    for mod in (fa, kq, ku):
        mod.reset_launches()


def _expected_samples(cfg, protocol: bool) -> int:
    """A round's samples: every stage-1 client's loader batches in the
    protocol round, whole M-batch steps in process."""
    lrn = cfg.learning
    batches = cfg.distribution.num_samples // lrn.batch_size
    if not protocol:
        steps = max(1, batches // lrn.control_count)
        batches = min(steps * lrn.control_count, batches)
    return cfg.clients[0] * batches * lrn.batch_size


def _check_stats_checkpoint(cfg, result, rounds: int) -> None:
    """The checkpoint holds the run's last parameters and its 13 layers
    of BatchNorm statistics."""
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == rounds,
          f"checkpoint missing or at the wrong round: "
          f"{ck and ck['round_idx']}")
    check(len(result.stats) == 13 and len(ck["batch_stats"]) == 13,
          f"statistics of {len(result.stats)} layers, checkpoint "
          f"{len(ck['batch_stats'])}")
    for tree, ck_tree in ((result.params, ck["params"]),
                          (result.stats, ck["batch_stats"])):
        for layer, leaves in tree.items():
            for key, t in leaves.items():
                check(torch.equal(ck_tree[layer][key], t.cpu()),
                      f"checkpoint {layer}.{key} differs from the result")
                check(bool(torch.isfinite(t).all()),
                      f"non-finite {layer}.{key}")


def phase_vgg_step_check() -> dict:
    """One float32 VGG16_CIFAR10 train step (cut 7, 4 microbatches of 32)
    on the CPU and on the card from the same weights, statistics and
    batch, with dropout off (rate 0, as in every parity recipe).  TF32 is
    off, so the card's convs and GEMMs are IEEE float32 (cuDNN, cuBLAS),
    as oneDNN's are on the CPU; the two sum in different orders.
    Tolerances: the loss within 1e-5 relative; each new running
    statistic within 1e-4 of its leaf's largest value; the first conv's
    and the first dense layer's gradients, in norm, no farther from the
    same step in float64 on the CPU than twice the CPU's own float32
    step is, plus 1e-3.  A gradient is compared in norm, and against
    that yardstick, because a pre-activation within float32 noise of
    zero flips its ReLU mask, which moves a few entries by their whole
    value: how far that carries depends on the weights and the batch."""
    import numpy as np

    from split_learning_torch.data import make_data_loader
    from split_learning_torch.models import build_model
    from split_learning_torch.models.split import Dropout
    from split_learning_torch.parallel.pipeline import PipelineModel

    loader = make_data_loader("CIFAR10", 32, train=True, seed=3,
                              synthetic_size=256)
    batches = list(loader)[:4]
    x = torch.from_numpy(np.stack([b[0] for b in batches]))
    y = torch.from_numpy(np.stack([b[1] for b in batches]).astype(np.int32))
    ref = build_model("VGG16_CIFAR10",
                      generator=torch.Generator().manual_seed(0))
    params, stats = ref.state_tree(), ref.stats_tree()
    out = {}
    for key, dev, dtype in (("cpu", "cpu", torch.float32),
                            (DEVICE, DEVICE, torch.float32),
                            ("float64", "cpu", torch.float64)):
        model = build_model("VGG16_CIFAR10", device=dev, dtype=dtype)
        model.load_state_tree(params)
        model.load_stats_tree(stats)
        for mod in model.layers.values():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        model.train()
        pipe = PipelineModel(model, [7], example_input=x[0].to(dev),
                             num_microbatches=4)
        loss = pipe.accumulate(x.to(dev), y.to(dev))
        out[key] = {
            "loss": float(loss),
            "stats": {k: {n: t.cpu() for n, t in v.items()}
                      for k, v in model.stats_tree().items()},
            "grads": {name: model.layers[name].weight.grad.cpu()
                      for name in ("layer1", "layer47")}}
    cpu, card = out["cpu"], out[DEVICE]
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    stat_err = max(float((card["stats"][k][n] - cpu["stats"][k][n]).abs()
                         .max() / cpu["stats"][k][n].abs().max())
                   for k in cpu["stats"] for n in ("mean", "var"))
    grad_err = {name: {"norm": float((card["grads"][name] - g).norm()
                                     / g.norm()),
                       "max_of_largest": float(
                           (card["grads"][name] - g).abs().max()
                           / g.abs().max())}
                for name, g in cpu["grads"].items()}
    f64 = out["float64"]["grads"]
    res = {"loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "loss_float64": out["float64"]["loss"],
           "loss_rel_err": loss_err, "stats_err_of_largest": stat_err,
           "grad_err": grad_err,
           "grad_norm_err_vs_float64": {
               side: {name: float((out[side]["grads"][name] - g).norm()
                                  / g.norm()) for name, g in f64.items()}
               for side in ("cpu", DEVICE)}}
    print(f"  one float32 VGG16 step, CPU vs card: {res}")
    check(loss_err <= 1e-5, f"card loss differs from the CPU's by "
          f"{loss_err:.3g} relative")
    check(stat_err <= 1e-4, f"card statistics differ from the CPU's by "
          f"{stat_err:.3g} of a leaf's largest value")
    errs = res["grad_norm_err_vs_float64"]
    for name, err in errs[DEVICE].items():
        bound = 2 * errs["cpu"][name] + 1e-3
        check(err <= bound, f"card {name} gradient differs from the "
              f"float64 step's by {err:.3g} in norm (bound {bound:.3g})")
    return res


#: the kernels on the VGG protocol path (every flag on): the codec on
#: both cut directions and the stage update of the sharded fold
VGG_PATH_KERNELS = ("quantize", "quantize_generic", "dequantize",
                    "finalize", "momentum")
#: the in-process VGG runs: (label, YAML)
VGG_SLICES = (("config", "config.yaml"),
              ("baseline1", "configs/baseline1.yaml"))


def phase_vgg_slice(workdir: pathlib.Path) -> dict:
    """``run_local`` on ``config.yaml`` (1 round, ``clients: [1, 1]``)
    and on ``configs/baseline1.yaml`` (5 rounds, ``[2, 2]``: two lockstep
    columns), each as written: VGG16/CIFAR10 in bfloat16 compute, cut at
    layer 7, SGD with momentum, FedAvg, validation on the 2000 synthetic
    test images, a checkpoint.  Every ``kernels:`` flag is off, so no
    kernel of the port may launch (the KernelPlan gate)."""
    from split_learning_torch.run import run_local

    out = {}
    for label, path in VGG_SLICES:
        cfg = vgg_config(workdir / f"vgg_{label}", path)
        lrn = cfg.learning
        print(f"  {label}: {cfg.model_key} clients={list(cfg.clients)} "
              f"cuts={list(cfg.topology.cut_layers)} batch="
              f"{lrn.batch_size} control-count={lrn.control_count} "
              f"{lrn.optimizer} lr {lrn.learning_rate} {cfg.compute_dtype} "
              f"samples/client={cfg.distribution.num_samples} rounds "
              f"{cfg.global_rounds} remat {lrn.remat}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        result = run_local(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        check(not any(launches.values()), f"{label}: kernels launched with "
              f"every kernels flag off: {launches}")
        check(len(result.history) == cfg.global_rounds,
              f"{label}: {len(result.history)} rounds")
        want = _expected_samples(cfg, protocol=False)
        rounds = []
        for rec in result.history:
            check(rec.ok and math.isfinite(rec.val_loss)
                  and math.isfinite(rec.val_accuracy),
                  f"{label}: round not ok: {rec}")
            check(rec.num_samples == want, f"{label} round "
                  f"{rec.round_idx}: {rec.num_samples} samples, expected "
                  f"{want}")
            rounds.append({"round": rec.round_idx, "wall_s": rec.wall_s,
                           "samples": rec.num_samples,
                           "train_samples_per_s": rec.num_samples
                           / rec.wall_s, "val_loss": rec.val_loss,
                           "val_accuracy": rec.val_accuracy})
        _check_stats_checkpoint(cfg, result, cfg.global_rounds)
        peak = torch.cuda.max_memory_allocated()
        out[label] = {"run_local_wall_s": wall, "rounds": rounds,
                      "max_memory_allocated_bytes": peak,
                      "launches": launches}
        for r in rounds:
            print(f"  {label} round {r['round']}: wall {r['wall_s']:.3f} s, "
                  f"{r['samples']} samples, {r['train_samples_per_s']:.1f} "
                  f"training samples/s, val_loss {r['val_loss']:.4f} "
                  f"val_acc {r['val_accuracy']:.4f}")
        print(f"  {label}: run_local {wall:.3f} s, peak memory "
              f"{peak / 2**30:.2f} GiB, launches {launches}")
    return out


def vgg_protocol_config(workdir: pathlib.Path, momentum: float):
    """``configs/baseline1.yaml`` as the protocol slice runs it: one
    round, an int8 codec on both cut directions, every kernel flag on,
    the sharded (CUDA) fold with ``server-momentum`` = ``momentum``."""
    cfg = vgg_config(workdir, "configs/baseline1.yaml")
    return dataclasses.replace(
        cfg, global_rounds=1,
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, sharded=True,
            server_momentum=momentum)).validate()


def _hold_on_path(kq, ku, held: dict, seen: dict) -> dict:
    """Wrap the codec and stage-update wrappers so that every launch the
    path makes is held, bit for bit, against the kernel's plain version
    on the same inputs (no kernel launched for it).  ``held`` gathers,
    per kernel, the launches held by input shape and dtype, the
    mismatches and the seconds the holding took; ``seen`` the
    quantizer's input dtypes.  Returns the originals to restore."""
    originals = {(kq, "quantize_tiles"): kq.quantize_tiles,
                 (kq, "dequantize_tiles"): kq.dequantize_tiles,
                 (ku, "finalize_leaf"): ku.finalize_leaf,
                 (ku, "momentum_leaf"): ku.momentum_leaf}
    lock = threading.Lock()

    def hold(name, x, out, ref_fn):
        t0 = time.perf_counter()
        outs = out if isinstance(out, tuple) else (out,)
        ref = ref_fn()
        refs = ref if isinstance(ref, tuple) else (ref,)
        same = all(o.dtype == r.dtype and o.shape == r.shape
                   and torch.equal(_bits(o), _bits(r))
                   for o, r in zip(outs, refs))
        key = f"{tuple(x.shape)} {x.dtype}".replace("torch.", "")
        with lock:
            h = held.setdefault(name, {"launches": 0, "by_input": {},
                                       "mismatches": [], "s": 0.0})
            h["launches"] += 1
            h["by_input"][key] = h["by_input"].get(key, 0) + 1
            if not same:
                h["mismatches"].append(key)
            h["s"] += time.perf_counter() - t0

    def quantize_tiles(x, *, tile, bits):
        with lock:
            seen[str(x.dtype)] = seen.get(str(x.dtype), 0) + 1
        out = originals[kq, "quantize_tiles"](x, tile=tile, bits=bits)
        hold("quantize", x, out,
             lambda: kq.quantize_reference(x, tile, bits))
        return out

    def dequantize_tiles(q, scale, *, tile, bits):
        out = originals[kq, "dequantize_tiles"](q, scale, tile=tile,
                                                bits=bits)
        hold("dequantize", q, out,
             lambda: kq.dequantize_reference(q, scale, tile, bits))
        return out

    def finalize_leaf(acc, tw, dtype, *, rnd=False):
        out = originals[ku, "finalize_leaf"](acc, tw, dtype, rnd=rnd)
        hold("finalize", acc, out,
             lambda: ku.finalize_reference(acc, tw, dtype, rnd))
        return out

    def momentum_leaf(acc, base, vel, tw, m, dtype):
        out = originals[ku, "momentum_leaf"](acc, base, vel, tw, m, dtype)
        hold("momentum", acc, out, lambda: ku.momentum_reference(
            acc, base, vel, tw, m, dtype))
        return out

    kq.quantize_tiles, kq.dequantize_tiles = quantize_tiles, dequantize_tiles
    ku.finalize_leaf, ku.momentum_leaf = finalize_leaf, momentum_leaf
    return originals


def phase_vgg_protocol(workdir: pathlib.Path) -> dict:
    """BASELINE config 1 as the protocol round in one process
    (``run_inproc``): one round with ``server-momentum: 0.9`` (the
    momentum kernel on the parameters, finalize on the statistics), then
    one at 0 (finalize on every leaf), counts zeroed before each and
    read after.  The activations cross the cut in bfloat16, the
    gradients in float32 (the last stage's input is the dequantized
    float32 frame), so the vec quantizer runs on both dtypes; the dtypes
    it was handed are tallied here.  Every launch of the codec and
    stage-update kernels on this path is held bit for bit against the
    plain version on its own inputs (:func:`_hold_on_path`): the round
    walls include that holding, whose seconds are reported beside
    them."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.bus import queue_family

    seen: dict = {}
    held_by_run: dict = {}
    runs = {}
    for m in (0.9, 0.0):
        held = held_by_run.setdefault(m, {})
        originals = _hold_on_path(kq, ku, held, seen)
        try:
            cfg = vgg_protocol_config(workdir / f"vgg_protocol_{m}", m)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            server, clients, bus, res = run_protocol(cfg)
            torch.cuda.synchronize()
            runs[m] = (cfg, server, clients, bus, res,
                       time.perf_counter() - t0, _launch_counts(),
                       torch.cuda.max_memory_allocated())
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
    out = {"runs": {}, "quantized_dtypes": seen}
    total: dict = {}
    for m, (cfg, server, clients, bus, res, wall, launches, peak) in \
            runs.items():
        rec = res.history[0]
        want = _expected_samples(cfg, protocol=True)
        check(len(res.history) == 1 and rec.ok
              and math.isfinite(rec.val_loss),
              f"VGG protocol round (momentum {m}) failed: {res.history}")
        check(rec.num_samples == want, f"VGG protocol round: "
              f"{rec.num_samples} samples, expected {want}")
        check(server.ctx.last_fold.folded == sum(cfg.clients),
              f"folded {server.ctx.last_fold.folded}")
        _check_stats_checkpoint(cfg, res, 1)
        fam: dict = {}
        for q, nb in bus.bytes_out_snapshot().items():
            fam[queue_family(q)] = fam.get(queue_family(q), 0) + nb
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        out["runs"][str(m)] = {
            "round_wall_s": rec.wall_s, "run_wall_s": wall,
            "samples": rec.num_samples,
            "train_samples_per_s": rec.num_samples / rec.wall_s,
            "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
            "phases": server.ctx.round_phases, "bytes_by_family": fam,
            "fold_update_s": server.ctx.last_fold.update_s,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "held": held_by_run[m]}
        for name in ("quantize", "dequantize", "finalize", "momentum"):
            h = held_by_run[m].get(name, {"launches": 0, "by_input": {},
                                          "mismatches": [], "s": 0.0})
            counted = launches[name] + (launches["quantize_generic"]
                                        if name == "quantize" else 0)
            print(f"  momentum {m}: {name:10s} {h['launches']} launches "
                  f"held against the plain version ({h['s']:.3f} s), "
                  f"{len(h['mismatches'])} differ; by input "
                  f"{h['by_input']}")
            check(not h["mismatches"], f"{name} differs from its plain "
                  f"version on the VGG protocol path at {h['mismatches']}")
            check(h["launches"] == counted, f"{name}: {h['launches']} "
                  f"launches held, {counted} counted")
        print(f"  momentum {m}: round wall {rec.wall_s:.3f} s (run "
              f"{wall:.3f} s), {rec.num_samples} samples, "
              f"{rec.num_samples / rec.wall_s:.1f} training samples/s, "
              f"val_loss {rec.val_loss:.4f} val_acc {rec.val_accuracy:.4f};"
              f" phases " + ", ".join(
                  f"{k} {v:.3f}" for k, v in server.ctx.round_phases[0]
                  .items()) + f"; bytes by queue family {fam}; peak "
              f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    for name, n in total.items():
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the VGG protocol path")
    for name in ("quantize", "dequantize", "momentum", "finalize"):
        check(total[name] > 0, f"kernel {name} was not launched on the VGG "
              "protocol path")
    check(runs[0.9][6]["momentum"] > 0 and runs[0.0][6]["finalize"] > 0,
          "the momentum round or the plain FedAvg round missed its kernel")
    check(seen.get("torch.float32", 0) > 0
          and seen.get("torch.bfloat16", 0) > 0,
          f"the quantizer was not handed both frame dtypes: {seen}")
    # one activation and one gradient frame per training batch
    batches = 2 * sum(r["samples"] for r in out["runs"].values()) // 32
    for name in ("quantize", "dequantize"):
        check(total[name] == batches, f"{name} launched {total[name]} "
              f"times, expected {batches}")
    out["launches_total"] = total
    print(f"  quantizer input dtypes {seen}; launches over both rounds "
          f"{total}")
    return out


def phase_vgg_tcp(workdir: pathlib.Path, timeout: float = 600.0) -> dict:
    """``config.yaml`` with ``transport.kind: tcp`` in its deployment
    shape (:func:`_run_tcp`: broker, server and two clients as
    processes), one round, against the same configuration run as the
    protocol round in one process: the samples must be equal, and no
    kernel runs in either (every flag off)."""
    cfg_in = vgg_config(workdir / "vgg_inproc", "config.yaml")
    _reset_launches()
    t0 = time.perf_counter()
    _, _, _, res = run_protocol(cfg_in)
    torch.cuda.synchronize()
    wall_in = time.perf_counter() - t0
    check(not any(_launch_counts().values()), "kernels launched in the "
          "in-process config.yaml protocol round")
    rec_in = res.history[0]
    check(rec_in.ok and rec_in.num_samples
          == _expected_samples(cfg_in, protocol=True),
          f"in-process config.yaml protocol round: {rec_in}")
    _check_stats_checkpoint(cfg_in, res, 1)

    cfg, wall, stats, reports, card_peak_mib = _run_tcp(
        workdir / "vgg_tcp",
        lambda d: vgg_config(d, "config.yaml"), timeout)
    launches = {k: sum(r["launches"].get(k, 0) for r in reports.values())
                for k in reports["server"]["launches"]}
    check(not any(launches.values()), f"kernels launched on the VGG TCP "
          f"path: {launches}")
    records = _metrics(pathlib.Path(cfg.log_path))
    rounds = [r for r in records if r.get("kind") == "round"]
    phases = [r for r in records if r.get("kind") == "phases"]
    check(len(rounds) == 1 and rounds[0]["ok"]
          and math.isfinite(rounds[0]["val_loss"]),
          f"VGG TCP round failed: {rounds}")
    check(rounds[0]["num_samples"] == rec_in.num_samples,
          f"VGG TCP round: {rounds[0]['num_samples']} samples, in process "
          f"{rec_in.num_samples}")
    out = {"run_wall_s": wall, "round_wall_s": rounds[0]["wall_s"],
           "samples": rounds[0]["num_samples"],
           "train_samples_per_s": rounds[0]["num_samples"]
           / rounds[0]["wall_s"],
           "val_loss": rounds[0]["val_loss"],
           "val_accuracy": rounds[0]["val_accuracy"],
           "phases": [{k: v for k, v in p.items() if k.endswith("_s")}
                      for p in phases],
           "inproc": {"round_wall_s": rec_in.wall_s, "run_wall_s": wall_in,
                      "train_samples_per_s": rec_in.num_samples
                      / rec_in.wall_s, "val_loss": rec_in.val_loss},
           "launches": launches,
           "broker_published_bytes_by_family":
               stats["published_bytes_by_family"],
           "processes": {n: {k: r[k] for k in (
               "wall_s", "max_memory_allocated_bytes")}
               for n, r in reports.items()},
           "card_memory_used_peak_mib": card_peak_mib}
    print(f"  config.yaml over TCP: round wall {out['round_wall_s']:.3f} s "
          f"(in process {rec_in.wall_s:.3f} s), {out['samples']} samples, "
          f"{out['train_samples_per_s']:.1f} training samples/s (in "
          f"process {out['inproc']['train_samples_per_s']:.1f}), "
          f"val_loss {out['val_loss']:.4f} (in process "
          f"{rec_in.val_loss:.4f}); phases {out['phases']}; broker bytes "
          f"by family {out['broker_published_bytes_by_family']}; card "
          f"memory peak {card_peak_mib} MiB")
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
        tiny = phase_protocol_check(workdir)
        print("[slice]")
        cfg = slice_config(workdir)
        sl = phase_slice(cfg)
        print("[profile]")
        prof = phase_profile(cfg)
        print("[protocol]")
        proto = phase_protocol(workdir)
        print("[protocol_tcp]")
        tcp = phase_protocol_tcp(workdir, proto)
        print("[vgg_step_check]")
        vgg_step = phase_vgg_step_check()
        print("[vgg_slice]")
        vgg_sl = phase_vgg_slice(workdir)
        print("[vgg_profile]")
        vgg_prof = phase_profile(vgg_config(workdir / "vgg_profile",
                                            "config.yaml"))
        print("[vgg_protocol]")
        vgg_proto = phase_vgg_protocol(workdir)
        print("[vgg_tcp]")
        vgg_tcp = phase_vgg_tcp(workdir)
    entries = []
    for name, r in kernels.items():
        source, replaces = KERNELS[name]
        by_path = {"protocol": proto["launches_total"][name],
                   "protocol_tcp": tcp["launches"][name]}
        if name in sl["launches"]:
            by_path["slice"] = sl["launches"][name]
        if name in tiny:   # the float32 flash route, either quantizer
            by_path["tiny_float32_protocol_check"] = tiny[name]
        for label, run in vgg_sl.items():
            by_path[f"vgg_slice_{label}"] = run["launches"][name]
        by_path["vgg_protocol"] = vgg_proto["launches_total"][name]
        by_path["vgg_tcp"] = vgg_tcp["launches"][name]
        # each kernel's main path: the VGG protocol round for the codec
        # and stage-update kernels, the TinyLlama protocol round for the
        # flash kernels
        # (VGG has no attention).  The times and bounds of a codec or
        # stage-update row are taken at the VGG round's shapes (``shapes``;
        # the TinyLlama shapes' in ``tinyllama_shapes``), and each of its
        # launches on that path was held against its plain version
        if name in VGG_PATH_KERNELS:
            main_path = "vgg_protocol"
            per_round = {f"server-momentum {m}": run["launches"][name]
                         for m, run in vgg_proto["runs"].items()}
            held = sum(run["held"].get(name, {}).get("launches", 0)
                       for run in vgg_proto["runs"].values())
        else:
            main_path = "protocol"
            per_round = proto["launches_per_round"][name]
            held = None
        extra = {k: r[k] for k in ("shapes", "tinyllama_shapes", "frames")
                 if k in r}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[main_path], "launches_path": main_path,
            "launches_by_path": by_path,
            "launches_per_round": per_round,
            **({} if held is None else {"launches_held_bitwise": held}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # profiler device times beside the events' ms
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"], **extra})
    print(json.dumps({"slice": sl, "profile": prof, "protocol": proto,
                      "protocol_tcp": tcp, "vgg_step_check": vgg_step,
                      "vgg_slice": vgg_sl, "vgg_profile": vgg_prof,
                      "vgg_protocol": vgg_proto,
                      "vgg_tcp": vgg_tcp}))
    print(json.dumps({"kernels": entries}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--participant"]:
            sys.exit(participant_main(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
