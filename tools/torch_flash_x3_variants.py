"""Time variants of the port's split-TF32 flash backward pair
(``flash_bwd_dkv_x3_kernel`` and ``flash_bwd_dq_x3_kernel`` in
``csrc/flash_attention.cu``) on the card, side by side, by profiler
device time.

Each variant is the kernel source with a few named text edits, or
another source given with ``--alt NAME=DIR`` (DIR's
``split_learning_torch/csrc/flash_attention.cu`` unedited, for example
an unpacked parent commit); all are compiled in parallel with the
build's own ``nvcc`` flags into ``build/flash_variants/`` and loaded with
``ctypes``.  Every variant's dK, dV and dQ are held against the plain
versions at ``chip_smoke._tolerance`` — a variant marked "timing only"
changes the arithmetic on purpose, to measure what that part costs, and
is expected to fail it — then each pair is timed at the slice's float32
shapes (256, 256, 64) causal, in the order given and again in reverse,
with ``chip_smoke._device_ms`` (the L2 flushed before each run).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/torch_flash_x3_variants.py [--alt NAME=DIR ...] \
        [variant ...]

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

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from split_learning_torch.ops import flash_attention as fa  # noqa: E402
from split_learning_torch.ops.kernels import build  # noqa: E402

_ATTR_DKV = """      flash_bwd_dkv_x3_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
"""
_ATTR_DQ = _ATTR_DKV.replace("dkv", "dq")
_CARVEOUT = """  err = cudaFuncSetAttribute(flash_bwd_{k}_x3_kernel<T, D>,
      cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
"""
# blocks an SM of the float D = 64 pair as the runtime computes them
_OCCUPANCY = """
extern "C" int slt_x3_occupancy(int dq) {
  int n = -1;
  if (dq)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_bwd_dq_x3_kernel<float, 64>, kTcThreads,
        x3_smem<float, 64>(false));
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_bwd_dkv_x3_kernel<float, 64>, kTcThreads,
        x3_smem<float, 64>(true));
  return n;
}
"""

#: name -> (what it changes, timing only?, [(old, new) text edits]);
#: ``--alt NAME=DIR`` adds NAME, DIR's source unedited
VARIANTS = {
    "base": ("the kernels as they are", False, []),
    "no_split_pass": (
        "the streamed tiles are not split (the planes keep stale values: "
        "what the split pass costs)", True,
        [("    split_streamed<T, D>(tQ, raw);   // Q, then dO\n", ""),
         ("    split_streamed<T, D>(tK, raw);   // K, then V\n", "")]),
    "no_kept_split": (
        "the kept tiles are not split (what the prologue's split costs)",
        True,
        [("  split_kept<T, D>(tK, tQ);   // K, then V\n", ""),
         ("  split_kept<T, D>(tQ, tK);   // Q, then dO\n", "")]),
    "small_acc": (
        "the small terms of S^T, dP^T, S and dP in accumulators of their "
        "own, added at the end (twice the independent mma chains)", False,
        [("  const int g = lane >> 2, t = lane & 3;\n#pragma unroll\n"
          "  for (int kk = 0; kk < D / 8; ++kk) {\n"
          "    const uint32_t ka",
          "  const int g = lane >> 2, t = lane & 3;\n"
          "  float sm[kSub / 8][4] = {};\n#pragma unroll\n"
          "  for (int kk = 0; kk < D / 8; ++kk) {\n"
          "    const uint32_t ka"),
         ("      mma_x3<kExact, kExact>(acc[j], ah, al, bh, bl);\n"
          "    }\n  }\n}",
          "      if (!kExact) {\n"
          "        mma_tf32(sm[j], al, bh[0], bh[1]);\n"
          "        mma_tf32(sm[j], ah, bl[0], bl[1]);\n      }\n"
          "      mma_tf32(acc[j], ah, bh[0], bh[1]);\n    }\n  }\n"
          "#pragma unroll\n  for (int j = 0; j < kSub / 8; ++j)\n"
          "#pragma unroll\n"
          "    for (int e = 0; e < 4; ++e) acc[j][e] += sm[j][e];\n}")]),
    "carveout": (
        "the shared-memory carveout asked to be the largest (a hint)",
        False,
        [(_ATTR_DKV, _ATTR_DKV + _CARVEOUT.format(k="dkv")),
         (_ATTR_DQ, _ATTR_DQ + _CARVEOUT.format(k="dq"))]),
}

SHAPE = (8 * 32, 256, 64)


def _source(name: str, alts: dict) -> str:
    if name in alts:
        return (alts[name] / "split_learning_torch" / "csrc" /
                "flash_attention.cu").read_text()
    text = (build.CSRC / "flash_attention.cu").read_text()
    edits = VARIANTS[name][2]
    for old, new in edits:
        # an edit listed n times must match n times
        if text.count(old) != edits.count((old, new)):
            raise SystemExit(f"{name}: edit not found "
                             f"{edits.count((old, new))} times: {old!r}")
    for old, new in dict(edits).items():
        text = text.replace(old, new)
    return text + _OCCUPANCY


def _compile(name: str, text: str) -> tuple[ctypes.CDLL, str]:
    out_dir = build.BUILD_DIR.parent / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.slt_flash_bwd_dkv_simt.argtypes = [i, p, p, p, p, p, p, p, p,
                                           i, i, i, f, i, p]
    dll.slt_flash_bwd_dq_simt.argtypes = [i, p, p, p, p, p, p, p,
                                          i, i, i, f, i, p]
    dll.slt_flash_bwd_dkv_simt.restype = ctypes.c_int
    dll.slt_flash_bwd_dq_simt.restype = ctypes.c_int
    dll.slt_x3_occupancy = getattr(dll, "slt_x3_occupancy", None)
    # registers and spills of the float D = 64 pair, from -Xptxas -v
    report, func, spills = [], "", ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "flash_bwd_d" in func and "IfLi64" in func:
            report.append(f"{'dkv' if 'dkv' in func else 'dq'}: "
                          f"{line.split(':', 1)[1].strip()}; {spills}")
    return dll, "; ".join(report)


def _pair(dll, q, k, v, do, lse, delta, causal: bool):
    bh, s, d = q.shape
    dk, dv, dq = (torch.empty_like(t) for t in (k, v, q))
    stream = fa._stream(q)
    err = dll.slt_flash_bwd_dkv_simt(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, s, d, fa._scale(d), int(causal), stream)
    err = err or dll.slt_flash_bwd_dq_simt(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        fa._scale(d), int(causal), stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return dk, dv, dq


def main(argv) -> int:
    alts = {}
    while argv[:1] == ["--alt"]:
        name, _, path = argv[1].partition("=")
        alts[name] = pathlib.Path(path).resolve()
        argv = argv[2:]
    names = argv or list(VARIANTS)
    chip_smoke.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda nm: _compile(nm, _source(nm, alts)), names)))
    q, k, v, do = (t.float() for t in chip_smoke._inputs(SHAPE,
                                                         torch.float32, 0))
    o, lse = fa.flash_fwd_reference(q, k, v, True)
    lse = lse.contiguous()
    delta = (do * o).sum(-1)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
    results = {}
    for nm in names:
        dll, ptxas = built[nm]
        outs = _pair(dll, q, k, v, do, lse, delta, True)
        torch.cuda.synchronize()
        occ = ([dll.slt_x3_occupancy(0), dll.slt_x3_occupancy(1)]
               if dll.slt_x3_occupancy else None)
        errs = {}
        for kind, out, ref in zip(("dk", "dv", "dq"), outs,
                                  (ref_dk, ref_dv, ref_dq)):
            err, ref_max = chip_smoke._max_err(out, ref)
            errs[kind] = (err, chip_smoke._tolerance(torch.float32, kind,
                                                     ref_max))
        ok = all(e <= tol for e, tol in errs.values())
        what, timing_only = ((f"the source in {alts[nm]}", False)
                             if nm in alts else VARIANTS[nm][:2])
        if not ok and not timing_only:
            raise SystemExit(f"{nm}: differs from the plain versions: "
                             f"{errs}")
        results[nm] = {"what": what, "timing_only": timing_only,
                       "within_tol": ok,
                       "max_abs_err": {k: e for k, (e, _) in errs.items()},
                       "ptxas": ptxas, "blocks_an_sm": occ,
                       "dkv_ms": [], "dq_ms": []}
    for nm in list(names) + list(reversed(names)):
        _, split = chip_smoke._device_ms(
            lambda nm=nm: _pair(built[nm][0], q, k, v, do, lse, delta,
                                True))
        for key, part in (("dkv_ms", "flash_bwd_dkv"),
                          ("dq_ms", "flash_bwd_dq")):
            results[nm][key].append(sum(t for n, t in split.items()
                                        if part in n))
    for nm, r in results.items():
        print(f"  {nm:18s} dK/dV device ms "
              + " ".join(f"{t:.4f}" for t in r["dkv_ms"]) + "  dQ "
              + " ".join(f"{t:.4f}" for t in r["dq_ms"])
              + f"  within tol {r['within_tol']}  blocks an SM "
              f"{r['blocks_an_sm']}  {r['ptxas']}")
    print(json.dumps({"shape": SHAPE, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
