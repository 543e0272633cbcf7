"""Check and time the paged-decode kernel (B.1) of whichever
``repro_torch`` is on the path, with ``chip_smoke.py``'s own B.1 check
(the serving shape and S = 32, M = 32; bf16 and float32 pools):

    PYTHONPATH=<tree>/src python3 scripts/time_paged_decode.py

Run it on two trees in one call to compare two versions of the kernel on
one card with the same timers.  Prints the card's name and power limit,
then one JSON line per (shape, dtype).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_paged_decode: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.kernels import mita_paged_attn as mpa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for dtype in (torch.bfloat16, torch.float32):
        for what, *case in cs.paged_attn_cases(dtype):
            r = cs.check_paged_attn(dtype, what, *case)
            print(json.dumps({"case": what, "dtype": str(dtype),
                              "source": mpa.__file__, **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
