"""The dense configurations tinyllama-1.1b, stablelm-1.6b and qwen3-32b on
the port, and the supervised serving CLI.

  * Each port config equals the JAX config field by field, at full size
    and at the smoke size (the JAX fields the port does not carry hold
    their defaults, so nothing is lost), ``remat`` included.
  * At the smoke size (float32, the JAX init's weights through
    `repro_torch.convert`), the port's chunked engine gives the JAX
    chunked engine's greedy tokens, prompts of 2 and 3 windows crossing a
    window boundary while they decode.  qwen3-32b is held to the reference
    at this size only: its float32 weights (32.76 B parameters) do not fit
    one card.
  * ``repro_torch.launch.serve --engine continuous --prefill-chunk 16
    --chaos-seed 0`` (supervised, faults injected) prints the tokens of
    ``--engine static`` for qwen3-0.6b, mamba2-370m and recurrentgemma-9b,
    and ``--chaos-seed`` with the static engine is refused as in the
    reference.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_params as jarch_params
from repro.configs.registry import get_arch as jget_arch
from repro.models.modules import AttnConfig as JAttnConfig
from repro.models.modules import ModelConfig as JModelConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.serve import EngineConfig, Request, ServingEngine

DENSE = ("tinyllama-1.1b", "stablelm-1.6b", "qwen3-32b")
GEN = 20


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dtype_name(x) -> str:
    return str(x).replace("torch.", "").split(".")[-1].strip("'>")


def _assert_fields_equal(port, ref, jcls, what):
    """Every field of the port's dataclass equals the reference's field of
    that name (dtypes by name); the reference's other fields hold their
    defaults."""
    port_names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if f.name not in port_names:
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            assert want == default, f"{what}.{f.name} is not ported"
            continue
        got = getattr(port, f.name)
        if f.name == "attn":
            _assert_fields_equal(got, want, JAttnConfig, f"{what}.attn")
        elif f.name.endswith("dtype"):
            assert _dtype_name(got) == _dtype_name(want), f"{what}.{f.name}"
        else:
            assert got == want, f"{what}.{f.name}: {got!r} != {want!r}"
    assert port_names <= {f.name for f in dataclasses.fields(jcls)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_config_equals_reference(name, smoke):
    ja, ta = jget_arch(name, smoke=smoke), tget_arch(name, smoke=smoke)
    assert (ta.arch_id, ta.family, ta.notes) == (ja.arch_id, ja.family,
                                                 ja.notes)
    _assert_fields_equal(ta.model, ja.model, JModelConfig, name)


def test_dense_head_shapes():
    """What these configs bring to the kernels: head dim 64 at group sizes
    8 and 1 (the earlier configs ran at d 128, G 2)."""
    shapes = {n: (tget_arch(n).model.dh, tget_arch(n).model.group)
              for n in DENSE}
    assert shapes == {"tinyllama-1.1b": (64, 8), "stablelm-1.6b": (64, 1),
                      "qwen3-32b": (128, 8)}


@pytest.mark.parametrize("name", DENSE)
def test_chunked_engine_matches_jax_engine(name):
    ja, ta = jget_arch(name, smoke=True), tget_arch(name, smoke=True)
    jp = jarch_params(ja, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    w = ta.model.attn.window
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, ta.model.vocab, n).astype(np.int32)
               for n in (2 * w, 3 * w, 2 * w, 3 * w)]
    kw = dict(n_slots=2, pages_per_slot=-(-(3 * w + GEN) // w), n_pages=16,
              prefill_chunk=w)
    want = JServingEngine(jp, ja.model, JEngineConfig(**kw)).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=GEN)
         for i, p in enumerate(prompts)])
    eng = ServingEngine(tp, ta.model, EngineConfig(**kw), device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=GEN)
                   for i, p in enumerate(prompts)])
    assert [f.reason for f in got] == ["complete"] * len(prompts)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w_.tokens),
                                      err_msg=f"{name} rid {g.rid}")
    assert eng.stats()["chunks"] > len(prompts)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_supervised_chaos_cli_equals_static(name):
    from repro_torch.launch.serve import main
    args = ["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "32", "--gen", "6"]
    st = main(args + ["--engine", "static"])
    sup = main(args + ["--engine", "continuous", "--prefill-chunk", "16",
                       "--chaos-seed", "0"])
    assert sup["injected"] > 0
    assert sup["reasons"] == ["complete"] * sup["requests"]
    for rid, toks in sup["tokens"].items():
        np.testing.assert_array_equal(toks, st["tokens"][rid % 2],
                                      err_msg=f"{name} rid {rid}")
    assert sup["stats"]["retries"] > 0


def test_chaos_seed_requires_continuous_engine():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--smoke", "--device", "cpu", "--engine", "static",
              "--chaos-seed", "0"])
