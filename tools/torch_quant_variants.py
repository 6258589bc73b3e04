"""Time variants of the port's vec quantizer (``csrc/quant.cu``) on the
card, side by side, by profiler device time.

Each variant is the kernel source with a few named text edits; all are
compiled in parallel with the build's own ``nvcc`` flags into
``build/quant_variants/`` and loaded with ``ctypes``.  Every variant is
held bit for bit against the plain version (``quantize_reference``) on
each frame — a variant marked "timing only" changes the arithmetic on
purpose, to measure what that arithmetic costs, and is expected to
differ — then each is timed on one activation frame (8 x 256 x 2048,
tile 256) per dtype, in the order given and again in reverse, with
``chip_smoke._device_ms`` (the L2 flushed before each run).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/torch_quant_variants.py [variant ...]

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
from split_learning_torch.ops.kernels import build  # noqa: E402
from split_learning_torch.ops.kernels import quant as kq  # noqa: E402

_PREFETCH = """    if (t_next < t_count)   // the next tile's loads go out first
      load_tile<T, C, IDX>(x, t_next * kTile, n, lane, nxt);
"""
_ADVANCE = """    t = t_next;
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[k][j] = nxt[k][j];
"""

#: name -> (what it changes, timing only?, [(old, new) text edits])
VARIANTS = {
    "base": ("the kernel as it is", False, []),
    "multiply": (
        "the per-value division replaced by a multiply (codes wrong: "
        "what the IEEE division costs)", True,
        [("__float2int_rn(__fdiv_rn(v, scale))",
          "__float2int_rn(__fmul_rn(v, scale))")]),
    "no_prefetch": (
        "no next-tile loads before the current tile's reduction", False,
        [(_PREFETCH, ""),
         (_ADVANCE, "    t = t_next;\n"
          "    load_tile<T, C, IDX>(x, t * kTile, n, lane, cur);\n")]),
    "threads_128": ("blocks of 128 threads", False,
                    [("constexpr int kVecThreads = 256;",
                      "constexpr int kVecThreads = 128;")]),
    "threads_512": ("blocks of 512 threads", False,
                    [("constexpr int kVecThreads = 256;",
                      "constexpr int kVecThreads = 512;")]),
    "one_tile_a_warp": (
        "a grid of one warp per tile in place of the persistent grid",
        False, [("  const long long grid = need < fit ? need : fit;",
                 "  const long long grid = need;")]),
}

FRAMES = (("bf16 int8", torch.bfloat16, 8), ("f32 int8", torch.float32, 8))


def _source(edits) -> str:
    text = (build.CSRC / "quant.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit not found exactly once: {old!r}")
        text = text.replace(old, new)
    return text


def _compile(name: str, text: str) -> ctypes.CDLL:
    out_dir = build.BUILD_DIR.parent / "quant_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.slt_quantize.argtypes = [i, p, ll, i, ll, i, p, p, p]
    dll.slt_quantize.restype = ctypes.c_int
    return dll


def _quantize(dll, x, bits: int):
    n, t_count = x.numel(), kq.padded_tiles(x.numel(), 256, bits)
    codes = torch.empty(t_count * 256 // (2 if bits == 4 else 1),
                        dtype=torch.int8 if bits == 8 else torch.uint8,
                        device="cuda")
    scales = torch.empty(t_count, dtype=torch.float32, device="cuda")
    err = dll.slt_quantize(kq._DTYPE_CODE[x.dtype], x.data_ptr(), n, 256,
                           t_count, bits, codes.data_ptr(),
                           scales.data_ptr(), kq._stream(x))
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return codes, scales


def main(names) -> int:
    chip_smoke.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        dlls = dict(zip(names, pool.map(
            lambda nm: _compile(nm, _source(VARIANTS[nm][2])), names)))
    g = torch.Generator(device="cuda").manual_seed(23)
    results = {nm: {"what": VARIANTS[nm][0],
                    "timing_only": VARIANTS[nm][1], "frames": {}}
               for nm in names}
    for label, dtype, bits in FRAMES:
        x = (torch.randn(chip_smoke.FRAME_SHAPE, generator=g,
                         device="cuda") * 3).to(dtype)
        qr, sr = kq.quantize_reference(x, 256, bits)
        for nm in names:
            q, s = _quantize(dlls[nm], x, bits)
            torch.cuda.synchronize()
            same = torch.equal(q, qr) and torch.equal(s, sr)
            results[nm]["frames"][label] = {"bitwise": same,
                                            "device_ms": []}
            if not same and not VARIANTS[nm][1]:
                raise SystemExit(f"{nm} {label}: differs from the plain "
                                 "version")
        for nm in list(names) + list(reversed(names)):
            ms, _ = chip_smoke._device_ms(
                lambda nm=nm: _quantize(dlls[nm], x, bits))
            results[nm]["frames"][label]["device_ms"].append(ms)
    for nm in names:
        for label, r in results[nm]["frames"].items():
            print(f"  {nm:16s} {label:9s} device ms "
                  + " ".join(f"{t:.4f}" for t in r["device_ms"])
                  + f"  bitwise {r['bitwise']}")
    print(json.dumps({"variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
