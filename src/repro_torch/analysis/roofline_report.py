"""Render the roofline table from results/dryrun_torch/*.json (port of
``repro.analysis.roofline_report``).

Usage:  PYTHONPATH=src python -m repro_torch.analysis.roofline_report \\
            [--mesh 16x16] [--dir DIR] [--tag TAG]
Emits a markdown table on stdout.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(results_dir: str, mesh: str, tag: str = "") -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        base = os.path.basename(path)[:-5]
        has_tag = base.endswith(tag) if tag else not any(
            base.endswith(t) for t in ("_opt", "_full"))
        if r.get("mesh") == mesh and has_tag:
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9))
    return recs


def fmt_row(r: dict) -> str:
    if r.get("status") == "skipped":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | — | — | "
                f"{r.get('reason', '')[:60]} |")
    if r.get("status") != "ok":
        return f"| {r['arch']} | {r['shape']} | FAILED: {r.get('error','')[:60]} |"
    ro = r["roofline"]
    mem = r["memory"]["peak_per_device"] / 2**30
    return ("| {arch} | {shape} | {tc:.2e} | {tm:.2e} | {tcl:.2e} | {mem:.1f} "
            "| **{bn}** | {uf:.2f} | {rf:.3f} | {note} |").format(
        arch=r["arch"], shape=r["shape"],
        tc=ro["t_compute"], tm=ro["t_memory"], tcl=ro["t_collective"],
        mem=mem, bn=ro["bottleneck"],
        uf=ro["useful_flops_fraction"], rf=ro["roofline_fraction"],
        note=r.get("note", "")[:40])


HEADER = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
          "GiB/dev | bottleneck | useful-FLOP frac | roofline frac | note |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    recs = load(args.dir, args.mesh, args.tag)
    print(f"### Roofline — mesh {args.mesh}"
          + (f" (tag={args.tag})" if args.tag else "") + "\n")
    print(HEADER)
    for r in recs:
        print(fmt_row(r))
    ok = [r for r in recs if r.get("status") == "ok"]
    if ok:
        worst = sorted(ok, key=lambda r: r["roofline"]["roofline_fraction"])[:5]
        print("\nworst roofline fractions:",
              ", ".join(f"{r['arch']}:{r['shape']}"
                        f"={r['roofline']['roofline_fraction']:.3f}"
                        for r in worst))


if __name__ == "__main__":
    main()
