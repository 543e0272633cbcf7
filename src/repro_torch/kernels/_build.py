"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/repro_torch/``
at the repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source rebuilds and an
unchanged one is reused.  The sources
compile in parallel, one ``nvcc`` each.  ``ptxas -v``'s report (registers,
shared memory, spills) is kept beside each library (`ptxas_report`).

Nothing here runs at import time: the CPU tests import every module, and
the CPU path never builds.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_reports: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of repro_torch cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):    # shared device code
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for stem, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                [nvcc, *FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_SECONDS[stem] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {stem}.cu:\n{log}")
                continue
            out.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it first if
    needed."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            _libs[stem] = ctypes.CDLL(str(paths[stem]))
            report = paths[stem].with_suffix(".ptxas.txt")
            _reports[stem] = report.read_text() if report.exists() else ""
        return _libs[stem]


def ptxas_report(stem: str) -> str:
    """``nvcc -Xptxas -v`` output of the build of ``csrc/<stem>.cu``."""
    load(stem)
    return _reports[stem]


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
