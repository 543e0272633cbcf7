"""Compare one profiled train step of two trees on one card:

    python3 scripts/ab_train.py --parent <tree> [--seq 4096] [--batch 4]
        [--arch qwen3-0.6b] [--out <dir>]

``<tree>`` is the root of another checkout of this repository (for example
the parent commit unpacked with ``git archive`` into ``build/parent``).
The turns parent, this, this, parent each run this tree's
``repro_torch/launch/profile_decode.py --train`` in a fresh process with
that tree's package first on the path (one full-width train step under the
training driver's deterministic settings, after a warm-up step), so both
are measured by one method on one card.  Prints the card's name and power
limit, then one JSON line per turn (wall ms of the step, device ms, busy
share, the kernels of most device time); ``--out`` also keeps each turn's
operator tables there.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    trees = {"parent": Path(args.parent).resolve() / "src",
             "this": ROOT / "src"}
    for turn, which in enumerate(("parent", "this", "this", "parent")):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "src/repro_torch/launch/"
                                 "profile_decode.py"),
             "--arch", args.arch, "--train", str(args.seq), "--batch",
             str(args.batch)], capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(trees[which])}, timeout=900)
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / f"train_{turn}_{which}.txt").write_text(
                proc.stdout + proc.stderr)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        summ = json.loads(proc.stdout.splitlines()[-1])
        print(json.dumps({"turn": turn, "tree": which, **{
            k: summ[k] for k in ("step_ms", "device_ms_per_step",
                                 "device_busy_share", "top_kernels",
                                 "device")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
