"""Time the port's float32-route flash forward (``slt_flash_fwd``) and
its dequantizer (``slt_dequantize``, and ``slt_dequantize_generic``
where the source has it) against other builds of the same entry points,
on the card, in turns, by profiler device time.

Each build is this checkout's ``csrc/flash_attention.cu`` and
``csrc/quant.cu`` with a few named text edits (see :data:`VARIANTS`),
or another checkout's sources given with ``--alt
NAME=DIR`` (for example an unpacked parent commit); all are compiled in
parallel with the build's own ``nvcc`` flags into ``build/fwd_dequant_ab/``
and loaded with ``ctypes``.  Each build's forward is held against the
plain version at ``chip_smoke._tolerance`` and each dequantizer bit for
bit against ``dequantize_reference``; then every build is timed in the
order given and again in reverse with ``chip_smoke._device_ms`` (the L2
flushed before each run):

* the forward at the slice's float32 shapes (256, 256, 64) causal, with
  SDPA's float32 forward beside it;
* the dequantizer on int8 codes at tile 256 of the VGG (32, 16, 16, 64),
  BERT (32, 128, 768) and TinyLlama (8, 256, 2048) frames, and int4 on
  the TinyLlama frame, with ``torch.mul`` of the codes by their scales
  (int8) and the write floor (``fill_`` of the float32 output) beside it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/torch_fwd_dequant_ab.py [--alt NAME=DIR ...] [variant ...]

The last line of its output is one JSON object with the times.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from split_learning_torch.ops import flash_attention as fa  # noqa: E402
from split_learning_torch.ops.kernels import build  # noqa: E402
from split_learning_torch.ops.kernels import quant as kq  # noqa: E402

#: name -> (what it changes, [(source, old, new) text edits])
VARIANTS = {
    "base": ("the kernels as they are", []),
    "fwd_3_blocks": (
        "the forward bounded to 3 blocks an SM at D <= 64",
        [("flash_attention",
          "__global__ void __launch_bounds__(kTcThreads)\n"
          "flash_fwd_x3_kernel(",
          "__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 1)\n"
          "flash_fwd_x3_kernel(")]),
    "fwd_smem_q": (
        "the forward keeps Q's fragments in shared memory at every D",
        [("flash_attention", "constexpr int kFwdRegQ = 64;",
          "constexpr int kFwdRegQ = 0;")]),
    "deq_1": ("the vec dequantizer with one chunk a lane in flight",
              [("quant", "constexpr int kDeqInFlight = 2;",
                "constexpr int kDeqInFlight = 1;")]),
    "deq_4": ("the vec dequantizer with four chunks a lane in flight",
              [("quant", "constexpr int kDeqInFlight = 2;",
                "constexpr int kDeqInFlight = 4;")]),
}
FWD_SHAPE = (8 * 32, 256, 64)
FRAMES = (("VGG int8", (32, 16, 16, 64), 8),
          ("BERT int8", (32, 128, 768), 8),
          ("TinyLlama int8", (8, 256, 2048), 8),
          ("TinyLlama int4", (8, 256, 2048), 4))
# blocks an SM of the float D = 64 forward as the runtime computes them
_OCCUPANCY = """
extern "C" int slt_fwd_occupancy() {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_fwd_x3_kernel<float, 64>, kTcThreads,
      fwd_x3_smem<float, 64>());
  return n;
}
"""


def _sources(name: str, alts: dict) -> dict:
    if name in alts:
        csrc = alts[name] / "split_learning_torch" / "csrc"
        return {src: (csrc / f"{src}.cu").read_text()
                for src in ("flash_attention", "quant")}
    texts = {src: (build.CSRC / f"{src}.cu").read_text()
             for src in ("flash_attention", "quant")}
    for src, old, new in VARIANTS[name][1]:
        if texts[src].count(old) != 1:
            raise SystemExit(f"{name}: edit not found once: {old!r}")
        texts[src] = texts[src].replace(old, new)
    texts["flash_attention"] += _OCCUPANCY
    return texts


def _compile(name: str, src: str, text: str):
    out_dir = build.BUILD_DIR.parent / "fwd_dequant_ab" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"{src}.cu", out_dir / f"lib{src}.so"
    cu.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name} {src}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    if src == "flash_attention":
        dll.slt_flash_fwd.argtypes = [i, p, p, p, p, p, i, i, i, f, i, p]
        dll.slt_flash_fwd.restype = ctypes.c_int
    else:
        for fn in ("slt_dequantize", "slt_dequantize_generic"):
            if hasattr(dll, fn):
                getattr(dll, fn).argtypes = [p, p, ll, i, i, p, p]
                getattr(dll, fn).restype = ctypes.c_int
    # registers and spills of every forward instantiation
    report, func, spills = [], "", ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "flash_fwd" in func and "tc" not in func:
            report.append(f"{func}: {line.split(':', 1)[1].strip()}; "
                          f"{spills}")
    return dll, report


def _fwd(dll, q, k, v, causal: bool):
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), device=q.device)
    err = dll.slt_flash_fwd(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), bh, s, d,
                            fa._scale(d), int(causal), fa._stream(q))
    if err:
        raise SystemExit(f"forward launch failed: CUDA error {err}")
    return o, lse


def _dequant(fn, q, s, bits: int):
    out = torch.empty(s.numel() * 256, device="cuda")
    err = fn(q.data_ptr(), s.data_ptr(), s.numel(), 256, bits,
             out.data_ptr(), kq._stream(q))
    if err:
        raise SystemExit(f"dequantize launch failed: CUDA error {err}")
    return out


def main(argv) -> int:
    alts = {}
    while argv[:1] == ["--alt"]:
        name, _, path = argv[1].partition("=")
        alts[name] = pathlib.Path(path).resolve()
        argv = argv[2:]
    names = argv or ["base", *alts]
    chip_smoke.phase_device()
    jobs = [(nm, src, text) for nm in names
            for src, text in _sources(nm, alts).items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(lambda j: _compile(*j), jobs))
    built = {}
    for (nm, src, _), (dll, report) in zip(jobs, done):
        built.setdefault(nm, {})[src] = dll
        if report:
            built[nm]["ptxas"] = report
    results = {nm: {"what": (f"the sources in {alts[nm]}" if nm in alts
                             else VARIANTS[nm][0]),
                    "ptxas": built[nm].get("ptxas", []),
                    "fwd_blocks_an_sm": (
                        built[nm]["flash_attention"].slt_fwd_occupancy()
                        if hasattr(built[nm]["flash_attention"],
                                   "slt_fwd_occupancy") else None),
                    "fwd_device_ms": [], "dequant": {}} for nm in names}

    # the forward: held, then timed in turns
    q, k, v = (t.float() for t in chip_smoke._inputs(FWD_SHAPE,
                                                     torch.float32, 0)[:3])
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True)
    for nm in names:
        o, lse = _fwd(built[nm]["flash_attention"], q, k, v, True)
        torch.cuda.synchronize()
        errs = {}
        for kind, out, ref in (("o", o, o_ref), ("lse", lse, lse_ref)):
            err, ref_max = chip_smoke._max_err(out, ref)
            tol = chip_smoke._tolerance(torch.float32, kind, ref_max)
            if not err <= tol:
                raise SystemExit(f"{nm}: forward {kind} max_abs_err {err} "
                                 f"> tol {tol}")
            errs[kind] = err
        results[nm]["fwd_max_abs_err"] = errs
    b, h = 8, 32
    q4, k4, v4 = (t.view(b, h, *FWD_SHAPE[1:]) for t in (q, k, v))
    sdpa = [chip_smoke._device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))[0]]
    for nm in list(names) + list(reversed(names)):
        dll = built[nm]["flash_attention"]
        results[nm]["fwd_device_ms"].append(chip_smoke._device_ms(
            lambda dll=dll: _fwd(dll, q, k, v, True))[0])
    sdpa.append(chip_smoke._device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))[0])

    # the dequantizer: held bit for bit, then timed in turns
    g = torch.Generator(device="cuda").manual_seed(23)
    yard = {}
    for label, shape, bits in FRAMES:
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(
            torch.bfloat16)
        qc, sc = kq.quantize_reference(x, 256, bits)
        ref = kq.dequantize_reference(qc, sc, 256, bits)
        out32 = torch.empty_like(ref)
        calls = {}
        for nm in names:
            lib = built[nm]["quant"]
            for fn in ("slt_dequantize", "slt_dequantize_generic"):
                if hasattr(lib, fn):
                    calls[f"{nm} {fn}"] = (
                        lambda f=getattr(lib, fn): _dequant(f, qc, sc, bits))
        for key, call in calls.items():
            out = call()
            torch.cuda.synchronize()
            if not torch.equal(chip_smoke._bits(out), chip_smoke._bits(ref)):
                raise SystemExit(f"{key} {label}: differs from the plain "
                                 "version")
        times = {key: [] for key in calls}
        keys = list(calls)
        for key in keys + keys[::-1]:
            times[key].append(chip_smoke._device_ms(calls[key])[0])
        for nm in names:
            results[nm]["dequant"][label] = {
                key.split(" ", 1)[1]: t for key, t in times.items()
                if key.split(" ", 1)[0] == nm}
        nbytes = qc.numel() + 4 * sc.numel() + 4 * ref.numel()
        yard[label] = {
            "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "fill_floor_device_ms": chip_smoke._device_ms(
                lambda: out32.fill_(0))[0],
            "torch_mul_device_ms": (chip_smoke._device_ms(
                lambda: torch.mul(qc.view(-1, 256), sc[:, None]))[0]
                if bits == 8 else None)}

    for nm, r in results.items():
        print(f"  {nm:14s} forward device ms "
              + " ".join(f"{t:.4f}" for t in r["fwd_device_ms"])
              + f"  max_abs_err {r['fwd_max_abs_err']}  blocks an SM "
              f"{r['fwd_blocks_an_sm']}")
        for line in r["ptxas"]:
            print(f"    ptxas {line}")
        for label, per in r["dequant"].items():
            print(f"  {nm:14s} {label:15s} "
                  + "  ".join(f"{fn} " + " ".join(f"{t:.4f}" for t in ts)
                              for fn, ts in per.items()))
    print(f"  sdpa float32 forward device ms "
          + " ".join(f"{t:.4f}" for t in sdpa))
    for label, y in yard.items():
        print(f"  {label:15s} bound {y['bound_ms']:.5f} ms  fill floor "
              f"{y['fill_floor_device_ms']:.4f}  torch.mul "
              f"{y['torch_mul_device_ms']}")
    print(json.dumps({"fwd_shape": FWD_SHAPE, "sdpa_fwd_device_ms": sdpa,
                      "dequant_yardsticks": yard, "builds": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
