"""Check and time the port's generic quantizer and dequantizer
(``slt_quantize_generic`` / ``slt_dequantize_generic`` in
``csrc/quant.cu``) against other builds of the same entry points, on the
card, in turns, by profiler device time.

Each build is this checkout's ``csrc/quant.cu`` with a few named text
edits (see :data:`VARIANTS`), or another checkout's source given with
``--alt NAME=DIR`` (for example an unpacked parent commit); all are
compiled in parallel with the build's own ``nvcc`` flags into
``build/quant_generic_ab/`` and loaded with ``ctypes``.  Every build is
first held bit for bit against the plain versions
(``quantize_reference``, ``dequantize_reference``) on :data:`CHECKS`:
each dtype and code width at odd, small, wide and unaligned tiles, with
an all-zero, a NaN and an inf tile, and codes 0, 1 and 3 bytes off
16-byte alignment.  Then every build is timed in the order given and
again in reverse with ``chip_smoke._device_ms`` (the L2 flushed before
each run) on VGG's (32, 16, 16, 64) frame:

* the quantizer at the wire-slow codec's int8 tile 64 on the bf16
  activation and the float32 gradient frame, at int4 tile 64 on the bf16
  frame, and at tile 256 (the vec route's tile, forced onto this route);
* the dequantizer at int8 tile 100 and int4 tile 48 (tiles the vec
  kernel does not take), and at int8 tile 256 (forced);

and the same at BERT's (32, 128, 768) frame (tile 64 and 256, and the
dequantizer at tile 100), each beside its bytes bound (bytes / 3.35
TB/s) and a fill of the same
output bytes (codes for the quantizer, float32 for the dequantizer: a
floor of a launch and a write, not a library call).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/torch_quant_generic_ab.py [--alt NAME=DIR ...] [variant ...]

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

#: name -> (what it changes, [(old, new) text edits of quant.cu])
VARIANTS = {
    "base": ("the kernels as they are", []),
    "span_target_8k": (
        "spans of at most 8 KB unless a tile is wider",
        [("constexpr int kSpanTargetBytes = 4096;",
          "constexpr int kSpanTargetBytes = 8192;")]),
    "span_target_32k": (
        "spans of up to 32 KB (the widest a block stages)",
        [("constexpr int kSpanTargetBytes = 4096;",
          "constexpr int kSpanTargetBytes = 32768;")]),
    "span_blocks_8": (
        "spans sized for 8 blocks an SM",
        [("constexpr int kSpanBlocksPerSM = 4;",
          "constexpr int kSpanBlocksPerSM = 8;")]),
    "deq_threads_128": (
        "the dequantizer in blocks of 128 threads",
        [("constexpr int kDeqGenThreads = 256;",
          "constexpr int kDeqGenThreads = 128;")]),
}
FRAME = chip_smoke.VGG_FRAME_SHAPE
BERT = chip_smoke.BERT_FRAME_SHAPE
#: (label, frame shape, dtype, tile, bits) of the timed quantizer shapes
QUANT_TIMES = (("bf16 int8 tile 64", FRAME, torch.bfloat16, 64, 8),
               ("f32 int8 tile 64", FRAME, torch.float32, 64, 8),
               ("bf16 int4 tile 64", FRAME, torch.bfloat16, 64, 4),
               ("bf16 int8 tile 256", FRAME, torch.bfloat16, 256, 8),
               ("BERT bf16 int8 tile 64", BERT, torch.bfloat16, 64, 8),
               ("BERT bf16 int8 tile 256", BERT, torch.bfloat16, 256, 8))
#: (label, frame shape, tile, bits) of the timed dequantizer shapes
#: (codes of a bf16 frame)
DEQUANT_TIMES = (("int8 tile 100", FRAME, 100, 8),
                 ("int4 tile 48", FRAME, 48, 4),
                 ("int8 tile 256", FRAME, 256, 8),
                 ("BERT int8 tile 100", BERT, 100, 8))
#: the widest tile a generic quantizer block stages (bf16 values)
SPAN_VALUES_BF16 = 16384
#: (dtype, tile) of the checked shapes, each at int8 and int4 and at
#: element offsets 0 and 1 of the frame
CHECKS = [(dt, tile) for dt in (torch.bfloat16, torch.float16,
                                torch.float32)
          for tile in (1, 3, 7, 48, 64, 100, 128, 768, 2048)] + [
    (torch.bfloat16, SPAN_VALUES_BF16), (torch.bfloat16,
                                         SPAN_VALUES_BF16 + 1),
    (torch.float32, SPAN_VALUES_BF16 // 2 + 1)]


def _source(name: str, alts: dict) -> str:
    if name in alts:
        return (alts[name] / "split_learning_torch" / "csrc"
                / "quant.cu").read_text()
    text = (build.CSRC / "quant.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: edit not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _compile(name: str, text: str):
    out_dir = build.BUILD_DIR.parent / "quant_generic_ab" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "quant.cu", out_dir / "libquant.so"
    cu.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.slt_quantize_generic.argtypes = [i, p, ll, i, ll, i, p, p, p]
    dll.slt_quantize_generic.restype = ctypes.c_int
    dll.slt_dequantize_generic.argtypes = [p, p, ll, i, i, p, p]
    dll.slt_dequantize_generic.restype = ctypes.c_int
    report, func = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "generic" in func:
            report.append(f"{func}: {line.split(':', 1)[1].strip()}")
    return dll, report


def _quantize(dll, x, tile: int, bits: int):
    n = x.numel()
    t_count = kq.padded_tiles(n, tile, bits)
    codes = torch.empty(t_count * tile // (2 if bits == 4 else 1),
                        dtype=torch.int8 if bits == 8 else torch.uint8,
                        device="cuda")
    scales = torch.empty(t_count, dtype=torch.float32, device="cuda")
    err = dll.slt_quantize_generic(kq._DTYPE_CODE[x.dtype], x.data_ptr(), n,
                                   tile, t_count, bits, codes.data_ptr(),
                                   scales.data_ptr(), kq._stream(x))
    if err:
        raise SystemExit(f"quantize launch failed: CUDA error {err}")
    return codes, scales


def _dequantize(dll, q, s, tile: int, bits: int):
    out = torch.empty(s.numel() * tile, device="cuda")
    err = dll.slt_dequantize_generic(q.data_ptr(), s.data_ptr(), s.numel(),
                                     tile, bits, out.data_ptr(),
                                     kq._stream(q))
    if err:
        raise SystemExit(f"dequantize launch failed: CUDA error {err}")
    return out


def _shifted(q: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``q`` starting ``offset`` bytes past a 16-byte boundary."""
    buf = torch.empty(q.numel() + 16, dtype=q.dtype, device="cuda")
    out = buf[offset:offset + q.numel()]
    out.copy_(q)
    return out


def _frame(g, dtype, bad: bool, shape=FRAME):
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    if bad:
        flat = x.view(-1)
        flat[640:1280] = 0                  # all-zero tiles
        flat[5000] = float("nan")           # a NaN tile
        flat[9001] = float("inf")           # an inf tile
    return x


def check(name: str, dll, g) -> int:
    """Every case of :data:`CHECKS` bit for bit; returns the count."""
    held = 0
    frames = {dt: _frame(g, dt, True) for dt in (torch.bfloat16,
                                                 torch.float16,
                                                 torch.float32)}
    for dt, tile in CHECKS:
        for bits in (8, 4):
            for off in (0, 1):
                x = frames[dt].view(-1)[off:]
                q, s = _quantize(dll, x, tile, bits)
                qr, sr = kq.quantize_reference(x, tile, bits)
                torch.cuda.synchronize()
                label = f"{name} {dt} tile {tile} int{bits} +{off}"
                if not (torch.equal(q, qr) and torch.equal(
                        chip_smoke._bits(s), chip_smoke._bits(sr))):
                    raise SystemExit(f"{label}: quantizer differs")
                dr = kq.dequantize_reference(qr, sr, tile, bits)
                for cb in (0, 1, 3):
                    d = _dequantize(dll, _shifted(qr, cb), sr, tile, bits)
                    torch.cuda.synchronize()
                    if not torch.equal(chip_smoke._bits(d),
                                       chip_smoke._bits(dr)):
                        raise SystemExit(f"{label} codes +{cb} B: "
                                         "dequantizer differs")
                held += 4
    return held


def main(argv) -> int:
    alts = {}
    while argv[:1] == ["--alt"]:
        name, _, path = argv[1].partition("=")
        alts[name] = pathlib.Path(path).resolve()
        argv = argv[2:]
    names = argv or ["base", *alts]
    chip_smoke.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda nm: _compile(nm, _source(nm, alts)), names)))
    g = torch.Generator(device="cuda").manual_seed(23)
    results = {nm: {"what": (f"the source in {alts[nm]}" if nm in alts
                             else VARIANTS[nm][0]),
                    "ptxas": built[nm][1], "quantize": {},
                    "dequantize": {}} for nm in names}
    for nm in names:
        results[nm]["held_bitwise"] = check(nm, built[nm][0], g)
        print(f"  {nm}: {results[nm]['held_bitwise']} cases bit for bit",
              flush=True)
    yard = {}
    order = list(names) + list(reversed(names))
    for label, shape, dt, tile, bits in QUANT_TIMES:
        x = _frame(g, dt, False, shape)
        codes, _ = _quantize(built[names[0]][0], x, tile, bits)
        t_count = kq.padded_tiles(x.numel(), tile, bits)
        nbytes = x.numel() * x.element_size() + codes.numel() + 4 * t_count
        fill = codes.view(torch.int8)
        yard[f"quantize {label}"] = {
            "bytes": nbytes,
            "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "fill_floor_device_ms": chip_smoke._device_ms(
                lambda: fill.fill_(0))[0]}
        for nm in order:
            results[nm]["quantize"].setdefault(label, []).append(
                chip_smoke._device_ms(lambda nm=nm: _quantize(
                    built[nm][0], x, tile, bits))[0])
    for label, shape, tile, bits in DEQUANT_TIMES:
        x = _frame(g, torch.bfloat16, False, shape)
        q, s = kq.quantize_reference(x, tile, bits)
        out = torch.empty(s.numel() * tile, device="cuda")
        nbytes = q.numel() + 4 * s.numel() + 4 * out.numel()
        yard[f"dequantize {label}"] = {
            "bytes": nbytes,
            "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "fill_floor_device_ms": chip_smoke._device_ms(
                lambda: out.fill_(0))[0]}
        for nm in order:
            results[nm]["dequantize"].setdefault(label, []).append(
                chip_smoke._device_ms(lambda nm=nm: _dequantize(
                    built[nm][0], q, s, tile, bits))[0])
    for nm, r in results.items():
        for line in r["ptxas"]:
            print(f"  {nm} ptxas {line}")
        for kind in ("quantize", "dequantize"):
            for label, ts in r[kind].items():
                print(f"  {nm:18s} {kind:10s} {label:20s} device ms "
                      + " ".join(f"{t:.4f}" for t in ts))
    for label, y in yard.items():
        print(f"  {label:30s} {y['bytes']} B, bound {y['bound_ms']:.5f} ms,"
              f" fill floor {y['fill_floor_device_ms']:.4f} ms")
    print(json.dumps({"frame": FRAME, "yardsticks": yard,
                      "builds": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
