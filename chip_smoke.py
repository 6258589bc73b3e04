"""Chip smoke test of the PyTorch/CUDA port (``split_learning_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and sets both TF32 switches explicitly (off);
2. build — compiles the flash-attention kernels from
   ``split_learning_torch/csrc`` with ``nvcc`` (first use);
3. kernels — holds each kernel against its plain PyTorch version at the
   slice's shapes (bf16, causal), in float32 (causal and not) and at an
   odd sequence length, and times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it); a tiny TinyLlama's logits and gradients through the
   kernels are held against its dense-attention path;
4. slice — one training round of full-width TinyLlama-1.1B
   (``configs/baseline5.yaml``: 4 stages, AdamW, bf16, batch 8,
   control-count 4, with ``use_flash: true``, 128 samples = 4 steps)
   through ``split_learning_torch.run.run_local`` on CUDA, with the
   kernels' launch counts zeroed just before and read just after;
5. profile — the same round once more, warm, with its device kernels
   traced by ``torch.profiler`` (not counted): round wall, the device's
   busy and idle share, and the kernels that take the most device time;
6. summary — a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, when
there is no CUDA device or when the port's package is not beside it.
"""

from __future__ import annotations

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
SOURCE = "split_learning_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "split_learning_tpu/ops/flash_attention.py:62",
    "flash_bwd_dkv": "split_learning_tpu/ops/flash_attention.py:134",
    "flash_bwd_dq": "split_learning_tpu/ops/flash_attention.py:173",
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
    lib_path = build.build("flash_attention")
    build.load("flash_attention")
    secs = time.perf_counter() - t0
    print(f"build: {lib_path.name} in {secs:.2f} s "
          f"(nvcc {build.BUILD_SECONDS['flash_attention']:.2f} s)")
    log = lib_path.with_name(lib_path.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

_FLUSH = None


def _time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median time of ``fn()`` in ms from CUDA events, the 50 MB L2
    flushed before each launch (the caller's inputs start cold)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    print("[build]")
    phase_build()
    print("[kernels]")
    kernels = phase_kernels()
    phase_model_check()
    print("[slice]")
    with tempfile.TemporaryDirectory(prefix="slt_smoke_") as tmp:
        cfg = slice_config(pathlib.Path(tmp))
        sl = phase_slice(cfg)
        print("[profile]")
        prof = phase_profile(cfg)
    steps = sl["steps"]
    entries = []
    for name, r in kernels.items():
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": sl["launches"][name],
            "launches_per_step": sl["launches_per_step"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"slice": sl, "profile": prof}))
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
