"""The port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch`` or ``chip_smoke.py``, and its entry points run on the
card unless the caller asks for the CPU."""

import ast
import inspect
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda():
    from repro_torch import device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    assert device.DEFAULT_DEVICE == "cuda"
    assert inspect.signature(tfm.lm_init).parameters["device"].default \
        == "cuda"
    assert inspect.signature(tfm.init_paged_states).parameters[
        "device"].default == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            device.resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--smoke"])


def test_recurrent_entry_points_default_to_cuda():
    """The recurrent families' constructors and the serving CLI for them
    run on the card unless asked for the CPU."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import mamba2, rglru
    from repro_torch.models import transformer as tfm
    for fn in (registry.arch_params, mamba2.mamba_init,
               mamba2.mamba_slot_states, rglru.rg_init, rglru.rg_slot_states,
               tfm.init_slot_attn_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        for arch in ("mamba2-370m", "recurrentgemma-9b"):
            with pytest.raises(RuntimeError, match="cuda"):
                serve.main(["--arch", arch, "--smoke"])


def test_distribution_entry_points_default_to_cuda():
    """The meshes and the training CLI's mesh path run on the card over
    ``nccl`` unless asked for the CPU (``gloo``); a mesh whose size is not
    the world's raises before any group starts; importing the modules
    starts none."""
    import torch.distributed as dist
    from repro_torch.launch import mesh, train
    from repro_torch.models import rglru
    assert mesh.BACKEND == {"cuda": "nccl", "cpu": "gloo"}
    for fn in (mesh.make_host_mesh, mesh.make_production_mesh,
               mesh.init_process_group):
        assert inspect.signature(fn).parameters["device_type"].default \
            is None                   # None: device.DEFAULT_DEVICE, cuda
    assert inspect.signature(rglru.rg_init_decode_states).parameters[
        "device"].default == "cuda"
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        mesh.make_host_mesh(2, 1, device_type="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.make_host_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--smoke", "--data-parallel", "1",
                        "--model-parallel", "1"])
        assert not dist.is_initialized()
