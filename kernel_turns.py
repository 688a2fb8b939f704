#!/usr/bin/env python3
"""Two versions of the port's kernels timed in turns on one CUDA card.

    python3 kernel_turns.py OLD_ROOT NEW_ROOT [--cases ssd,argmax] [--out FILE]

OLD_ROOT and NEW_ROOT are checkouts of the repository (for example unpacked
with ``git archive`` into directories under ``build/``, which git ignores).
Four processes run one after another, in turns: old, new, new, old. Each
puts its root and the root's ``src/`` first on ``sys.path``, imports that
root's ``chip_smoke`` and calls its case functions, so each version builds
its own kernels, checks them against its own plain versions and times them
through its own wrappers. Every process times with NEW_ROOT's
``chip_smoke.Timer``, so only the kernels differ. Each case's JSON line is
printed with ``"root"`` (old or new) and ``"turn"`` (1-4) added, and also
written to ``--out`` when given. The card's name and power limit are
printed first. Exits non-zero if a process fails.

Cases: ``ssd``, ``flash`` and ``int8`` run the root's ``ssd_cases``,
``flash_cases`` and ``int8_cases``, ``argmax`` its ``argmax_case``: every
shape each root's own ``chip_smoke.py`` times, the main path's among them,
so this script knows no shape and no case function's arguments but the
timer. Compare the two roots by the ``shape`` of each line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

CASES = {"ssd": "ssd_cases", "argmax": "argmax_case", "flash": "flash_cases",
         "int8": "int8_cases"}


def worker(root: pathlib.Path, timer_root: pathlib.Path, cases):
    """One turn: ``root``'s cases, timed by ``timer_root``'s Timer."""
    import torch
    spec = importlib.util.spec_from_file_location(
        "timer_smoke", timer_root / "chip_smoke.py")
    timer_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer_smoke)          # puts timer_root/src first
    sys.path[:] = [p for p in sys.path if pathlib.Path(p) != timer_root / "src"]
    sys.path.insert(0, str(root))
    import chip_smoke as cs                       # puts root/src first
    assert pathlib.Path(cs.__file__).resolve().parent == root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = timer_smoke.Timer()
    for case in cases:
        getattr(cs, CASES[case])(timer)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path, nargs="?")
    ap.add_argument("new", type=pathlib.Path, nargs="?")
    ap.add_argument("--cases", default="ssd,argmax")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--timer-root", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = [c for c in args.cases.split(",") if c]
    if any(c not in CASES for c in cases):
        ap.error(f"cases are {tuple(CASES)}")
    if args.worker:
        worker(args.worker.resolve(), args.timer_root.resolve(), cases)
        return 0
    if args.old is None or args.new is None:
        ap.error("OLD_ROOT and NEW_ROOT are required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    out = open(args.out, "w") if args.out else None
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    for turn, which in enumerate(("old", "new", "new", "old"), 1):
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
             str(roots[which]), "--timer-root", str(roots["new"]),
             "--cases", ",".join(cases)],
            capture_output=True, text=True, cwd=roots[which])
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                line = json.dumps({"root": which, "turn": turn, **json.loads(line)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
