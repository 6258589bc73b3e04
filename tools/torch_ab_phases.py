"""Run a few of ``chip_smoke.py``'s phases from one checkout of the port
and write their walls as JSON, so that two commits can be compared on
the same card within one call.

The phases: ``kwt_slice`` (KWT-1 in process, three rounds), the
``dcsl_strict`` and ``vanilla_sl`` variants as the protocol round at
KWT-1's width, and ``protocol`` (TinyLlama-1.1B's protocol round, two
FedAvgM rounds and one plain round).  Each is checked as the script
checks it; a phase that fails ends the run with a non-zero exit.

Usage, on a machine with one CUDA card, with a second checkout of the
parent commit unpacked under ``build/parent`` (``git archive``)::

    python3 tools/torch_ab_phases.py CHECKOUT LABEL OUT_DIR

It imports ``chip_smoke`` from ``CHECKOUT``, prints one line ``AB LABEL
{...}`` with each phase's round walls and writes ``OUT_DIR/ab_LABEL.json``
(``OUT_DIR`` relative to the directory it is started from).
Alternate the two checkouts (parent, change, change, parent) in one
call, and point ``TMPDIR`` at a memory file system (``/dev/shm``): the
TinyLlama round writes a 4.4 GB checkpoint a round.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys
import tempfile
import time


def main(argv: list) -> int:
    side, label = pathlib.Path(argv[0]).resolve(), argv[1]
    out_dir = pathlib.Path(argv[2]).resolve()
    os.chdir(side)
    sys.path.insert(0, str(side))
    import chip_smoke as c

    c.phase_device()
    c.phase_build()
    work = pathlib.Path(tempfile.mkdtemp())
    out: dict = {"checkout": str(side)}
    try:
        t = time.perf_counter()
        kwt = c.phase_kwt_slice(work)
        out["kwt"] = {"rounds": [r["wall_s"] for r in kwt["rounds"]],
                      "phase_s": time.perf_counter() - t}
        for name in ("dcsl_strict", "vanilla_sl"):
            cfg = c.variant_protocol_config(work / f"vp_{name}", name)
            r = c._run_variant(name, cfg, c._inproc_variant)
            out[name] = {"rounds": [x["wall_s"] for x in r["rounds"]],
                         "run_wall_s": r["run_wall_s"]}
        t = time.perf_counter()
        p = c.phase_protocol(work)
        out["protocol"] = {"rounds": [r["wall_s"] for r in p["rounds"]],
                           "phases": p["phases"],
                           "plain": p["plain_fedavg_round"]["wall_s"],
                           "phase_s": time.perf_counter() - t}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"ab_{label}.json").write_text(json.dumps(out))
    print("AB", label, json.dumps({k: v["rounds"] for k, v in out.items()
                                   if isinstance(v, dict)}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as e:  # noqa: BLE001 — reported, exit non-zero
        print(f"torch_ab_phases FAILED: {e!r}", file=sys.stderr)
        sys.exit(1)
