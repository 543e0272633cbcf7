"""The ViT training data and recipe on the port against the JAX reference
(CPU).

* ``prng.normal`` against ``jax.random.normal``, exactly: on keys and
  shapes drawn with numpy, and over every one of the 2**23 values its
  uniform draw can take (the whole domain of its ``erf_inv``).
* ``prng.randint`` against ``jax.random.randint``, exactly: negative
  ``minval``, spans that are not powers of two, the full int32 range, an
  empty range and one past the int32 maximum.
* ``synthetic_vision_batch``: patches and labels bit-equal, 3 keys x 2
  shapes.
* ``benchmarks/tables.py``'s ``_train_vit`` recipe (tiny ViT: 2 layers, d
  64, N 128, m = k = 16, b 32, 10 classes, AdamW lr 2e-3, warmup 5, weight
  decay 0.01; float32), five steps, backends ``mita`` and ``full``: the
  port's ``vit_loss`` + `train_step` against ``jax.value_and_grad(
  vit_loss)`` + ``adamw_update`` from the same weights, each loss within
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro  # noqa: F401  (turns partitionable threefry on)
from repro.models import modules as jnn
from repro.models import vit as jvit
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import train_step
from repro_torch.models import modules as tnn
from repro_torch.models import vit as tvit
from repro_torch.optim import OptConfig, adamw_init


LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (33, 5)),
                                        (2 ** 31 + 5, (4, 3, 9)),
                                        (123456789, (1000,))])
def test_normal_matches_jax(seed, shape):
    ref = jax.random.normal(jax.random.PRNGKey(seed), shape)
    got = prng.normal(prng.PRNGKey(seed), shape)
    np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()))


def test_normal_whole_domain():
    """Every float32 the uniform draw can give: (m / 2**23) * (hi - lo) +
    lo, m < 2**23, one rounding (XLA's fused multiply-add), clamped at lo;
    the reference's ``sqrt(2) * erf_inv`` of each against the port's."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    m = np.arange(2 ** 23, dtype=np.float64) / 2 ** 23
    u = np.maximum((m * np.float64(np.float32(1) - lo) + np.float64(lo))
                   .astype(np.float32), lo)
    ref = jax.jit(lambda x: np.float32(np.sqrt(2)) * lax.erf_inv(x))(u)
    got = prng._erf_inv_xla(torch.from_numpy(u)) \
        * prng._f32c(float(np.sqrt(2)))
    bad = _bits(ref) != _bits(got.numpy())
    assert not bad.any(), (int(bad.sum()), u[bad][:5])


@pytest.mark.parametrize("lo,hi,shape", [
    (0, 10, (100,)), (-7, 13, (5, 9)), (-1000, -3, (64,)),
    (0, 1000003, (300,)), (-2 ** 31, 2 ** 31 - 1, (50,)),
    (5, 5, (4,)), (3, -4, (4,)), (0, 2 ** 31, (40,))])
def test_randint_matches_jax(lo, hi, shape):
    for seed in (0, 9, 2 ** 32 - 1):
        if hi > 2 ** 31 - 1:
            # jnp.asarray of a Python int past int32 overflows; the
            # reference's clipped path is reached through an int64 array
            with jax.enable_x64(True):
                ref = jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         jnp.int64(lo), jnp.int64(hi),
                                         dtype=jnp.int32)
        else:
            ref = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
        got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("seed", [0, 1000, 2 ** 31 + 17])
@pytest.mark.parametrize("shape", [(4, 16, 12, 10, 3, 1.2),
                                   (3, 196, 48, 10, 6, 1.0)])
def test_synthetic_vision_batch_matches_jax(seed, shape):
    b, n, d, c, n_signal, noise = shape
    ref = jvit.synthetic_vision_batch(jax.random.PRNGKey(seed), b, n, d, c,
                                      n_signal=n_signal, noise=noise)
    got = tvit.synthetic_vision_batch(prng.PRNGKey(seed), b, n, d, c,
                                      n_signal=n_signal, noise=noise)
    assert got["patches"].shape == (b, n, d)
    np.testing.assert_array_equal(_bits(ref["patches"]),
                                  _bits(got["patches"].numpy()))
    np.testing.assert_array_equal(np.asarray(ref["label"]),
                                  got["label"].numpy())


# the recipe of benchmarks/tables.py _train_vit, cut to five steps
N, BATCH, PATCH, CLASSES, STEPS = 128, 32, 48, 10, 5


def _recipe_cfgs(backend):
    """``tiny_vit_cfg(backend, 128, m=16, k=16)`` in both packages."""
    def build(nn_mod):
        return nn_mod.ModelConfig(
            n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=11,
            attn=nn_mod.AttnConfig(backend=backend, window=N // 16, k=16,
                                   s=1, causal=False, block_q=32,
                                   landmark="pool1d"))
    return build(jnn), build(tnn)


@pytest.mark.parametrize("backend", ["mita", "full"])
def test_train_vit_recipe_matches_jax(backend):
    jc, tc = _recipe_cfgs(backend)
    opt = dict(lr=2e-3, warmup_steps=5, total_steps=60, weight_decay=0.01)
    jopt, topt = JOptConfig(**opt), OptConfig(**opt)
    jp = jvit.vit_init(jax.random.PRNGKey(0), jc, PATCH, CLASSES)
    tp = params_from_jax(jax.device_get(jp))
    jo, to = jadamw_init(jp), adamw_init(tp)

    @jax.jit
    def jstep(p, o, batch):
        loss, g = jax.value_and_grad(jvit.vit_loss)(p, batch, jc)
        p, o, _ = jadamw_update(g, o, p, jopt)
        return p, o, loss

    def tloss(p, b):
        return tvit.vit_loss(p, b, tc)

    errs = []
    for i in range(STEPS):
        jb = jvit.synthetic_vision_batch(jax.random.PRNGKey(1000 + i), BATCH,
                                         N, PATCH, CLASSES, n_signal=3,
                                         noise=1.2)
        tb = tvit.synthetic_vision_batch(prng.PRNGKey(1000 + i), BATCH, N,
                                         PATCH, CLASSES, n_signal=3,
                                         noise=1.2)
        np.testing.assert_array_equal(_bits(jb["patches"]),
                                      _bits(tb["patches"].numpy()))
        jp, jo, jl = jstep(jp, jo, jb)
        tp, to, m = train_step(tp, to, tb, tloss, topt)
        errs.append(abs(float(jl) - float(m["loss"])))
    assert max(errs) <= LOSS_TOL, errs
