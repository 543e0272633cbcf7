"""Compare one CUDA kernel of two trees on one card, with ``chip_smoke.py``'s
own check and timers:

    python3 scripts/ab_kernel.py --parent <tree> \
        --kernel expert|chunk|paged_attn|finalize

``<tree>`` is the root of another checkout of this repository (for example
the parent commit unpacked with ``git archive`` into ``build/parent``).
Both trees' kernel modules are loaded into one process; each of the turns
parent, this, this, parent (bf16, then float32) runs ``chip_smoke``'s check
of the named kernel on one of them -- against this tree's plain version,
with the same timers (``ms``, ``card_ms``, ``host_ms``) and the same
profiler trace of one call -- so the two kernels are compared on one card
with one method.  Prints the card's name and power limit, then one JSON
line per turn.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"expert": "mita_expert_attn", "chunk": "mita_chunk_prefill",
           "paged_attn": "mita_paged_attn",
           "finalize": "mita_paged_finalize"}


def _purge() -> dict:
    """Take every ``repro_torch`` module out of ``sys.modules``."""
    return {k: sys.modules.pop(k) for k in list(sys.modules)
            if k.split(".")[0] == "repro_torch"}


def load_kernel_module(src: Path, name: str):
    """``repro_torch.kernels.<name>`` of the package under ``src``, apart
    from this tree's: imported with ``src`` first on the path, then taken
    out of ``sys.modules`` again, so it keeps its own globals (its sources
    and build directory included) while this tree's package stays the one
    that ``import repro_torch`` finds."""
    saved = _purge()
    sys.path.insert(0, str(src))
    try:
        return importlib.import_module(f"repro_torch.kernels.{name}")
    finally:
        sys.path.remove(str(src))
        _purge()
        sys.modules.update(saved)


def run_check(cs, kernel: str, dtype, mod) -> list:
    """chip_smoke's check of ``kernel`` on ``mod``: [(case, record)]."""
    if kernel == "expert":
        return [("forward", cs.check_expert(dtype, mod))]
    if kernel == "chunk":
        return [("serve", cs.check_chunk(dtype, mod))]
    if kernel == "finalize":
        # a parent kernel that a check of this tree rejects is still timed
        return [(case[0], cs.check_finalize(dtype, case, mod, strict=False))
                for case in cs.finalize_cases(dtype)]
    return [(what, cs.check_paged_attn(dtype, what, *case, mod=mod))
            for what, *case in cs.paged_attn_cases(dtype)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--kernel", required=True, choices=sorted(MODULES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernel: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (TF32 off)
    this = importlib.import_module(f"repro_torch.kernels."
                                   f"{MODULES[args.kernel]}")
    parent = load_kernel_module(args.parent.resolve() / "src",
                                MODULES[args.kernel])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for dtype in (torch.bfloat16, torch.float32):
        for tree, mod in (("parent", parent), ("this", this), ("this", this),
                          ("parent", parent)):
            for case, rec in run_check(cs, args.kernel, dtype, mod):
                print(json.dumps({
                    "kernel": args.kernel, "case": case, "tree": tree,
                    "dtype": str(dtype), "source": mod.__file__, **rec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
