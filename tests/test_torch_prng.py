"""The port's threefry replica (`repro_torch.prng`) and its three samplers
against ``jax.random`` (partitionable threefry, as the reference runs it).

Integer results are exact: threefry words, keys, ``fold_in`` and random
bits of 8, 16 and 32 bits, on keys and counters drawn with numpy (words
above 2**31 included).  ``uniform`` is exact in float32 (XLA's fused
multiply-add is reproduced) and bfloat16.  ``gumbel`` is exact in
bfloat16; in float32 each of its two logs may differ from XLA's by an ulp,
so it is held to ``|a - b| <= 2**-22 * (1 + |b|)`` (two float32 ulps of
``1 + |g|``).

Tokens: bfloat16 sums are exact, so bfloat16 tokens must be equal
everywhere.  Float32 tokens must be equal wherever the port's top-2 gap of
the sampled values exceeds ``2**-20 * (1 + |max|)`` (the gumbel bound with
margin); at least 90% of the draws must pass that gap rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

import repro  # noqa: F401  (turns partitionable threefry on)
from repro.launch.serve import static_generate as jstatic_generate
from repro.models import transformer as jtfm
from repro.serve.backends import sample_host as jsample_host
from repro_torch import prng
from repro_torch.convert import array_to_torch, params_from_jax
from repro_torch.launch.serve import static_generate as tstatic_generate
from repro_torch.models import transformer as ttfm
from repro_torch.serve.backends import sample_host as tsample_host

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DT_IDS = ["float32", "bfloat16"]
F32_GAP = 2.0 ** -20


def _keys(n, seed):
    """n random keys [n, 2] as uint32 numpy (high bits set on purpose)."""
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _gap_ok(z: torch.Tensor) -> np.ndarray:
    """Rows whose top-2 gap clears the float32 gumbel bound."""
    top2 = torch.topk(z.double(), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    return gap > F32_GAP * (1 + np.abs(top2[..., 0].numpy()))


# ------------------------------------------------------------ integers --

def test_threefry_words_exact():
    rng = np.random.default_rng(1)
    for key in _keys(16, 0):
        x = rng.integers(0, 2 ** 32, 2 * 37, dtype=np.uint64).astype(
            np.uint32)
        want = np.asarray(jprng.threefry_2x32(
            (jnp.uint32(key[0]), jnp.uint32(key[1])), jnp.asarray(x)))
        y0, y1 = prng.threefry2x32(_t(key[0]), _t(key[1]), _t(x[:37]),
                                   _t(x[37:]))
        np.testing.assert_array_equal(
            np.concatenate([y0.numpy(), y1.numpy()]), want.astype(np.int64))


def test_prng_key_and_fold_in_exact():
    for seed in (0, 1, 1000, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                      np.asarray(jax.random.PRNGKey(seed)))
    data = [0, 1, 7, 2 ** 31 - 1, -1, -123456]
    for key in _keys(8, 2):
        for d in data:
            want = jax.random.fold_in(jnp.asarray(key), np.int32(d))
            got = prng.fold_in(_t(key), d)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{key} {d}")


def test_fold_in_batched_matches_vmap():
    """The per-slot derivation of the samplers: keys [S, 2] from one key
    and [S] data, as ``jax.vmap(fold_in)``."""
    rid = np.random.default_rng(3).integers(0, 2 ** 31, 9).astype(np.int32)
    idx = np.arange(9, dtype=np.int32) * 17
    key = jax.random.PRNGKey(0)
    want = jax.vmap(lambda r, i: jax.random.fold_in(
        jax.random.fold_in(key, r), i))(jnp.asarray(rid), jnp.asarray(idx))
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(0), torch.from_numpy(rid)),
                       torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 4), (4, 4099)],
                         ids=str)
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_random_bits_exact(bits, shape):
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[bits]
    for key in _keys(4, bits + len(shape)):
        want = np.asarray(jax.random.bits(jnp.asarray(key), shape, dt))
        got = prng.random_bits(_t(key), bits, shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# -------------------------------------------------------------- floats --

@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_uniform_exact(jdt, tdt):
    for key in _keys(3, 5):
        for lo, hi in ((0.0, 1.0), (-3.0, 5.5), (1e-3, 7.0)):
            want = jax.random.uniform(jnp.asarray(key), (4, 4099), jdt, lo,
                                      hi)
            got = prng.uniform(_t(key), (4, 4099), tdt, lo, hi)
            assert got.dtype == tdt
            np.testing.assert_array_equal(
                _np(got), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_gumbel_within_stated_ulp(jdt, tdt):
    for key in _keys(3, 6):
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), (4, 4099),
                                            jdt)).astype(np.float32)
        got = _np(prng.gumbel(_t(key), (4, 4099), tdt))
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -22,
                                       atol=2.0 ** -22)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_categorical_matches_jax(jdt, tdt):
    """One key over the whole [B, V] logits (counters over B*V)."""
    rng = np.random.default_rng(7)
    lg = jnp.asarray(rng.standard_normal((3, 4099)) * 3, jdt)
    tl = array_to_torch(np.asarray(lg))
    for key in _keys(8, 8):
        want = np.asarray(jax.random.categorical(jnp.asarray(key), lg))
        got = prng.categorical(_t(key), tl).numpy()
        ok = (np.ones(3, bool) if tdt == torch.bfloat16 else _gap_ok(
            prng.gumbel(_t(key), (3, 4099), tdt) + tl))
        np.testing.assert_array_equal(got[ok], want[ok])


# -------------------------------------------------------------- tokens --

@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_sample_tokens_tempered_matches_jax(jdt, tdt):
    """The fused sampler: per-slot keys fold_in(fold_in(key, rid), index),
    the division by the float32 temperature promotes bfloat16 logits to
    float32, the gumbel draw is in the logits' dtype."""
    rng = np.random.default_rng(11)
    s, v = 6, 4099
    temp = np.asarray([0.0, 0.8, 1.0, 0.3, 1e-7, 2.0], np.float32)
    jfn = jax.jit(jtfm.sample_tokens)
    n_ok = n_all = 0
    for trial in range(6):
        lg = jnp.asarray(rng.standard_normal((s, v)) * 3, jdt)
        tl = array_to_torch(np.asarray(lg))
        rid = rng.integers(0, 2 ** 31, s).astype(np.int32)
        idx = rng.integers(0, 500, s).astype(np.int32)
        want = np.asarray(jfn(lg, jnp.asarray(rid), jnp.asarray(idx),
                              jnp.asarray(temp), jax.random.PRNGKey(trial)))
        got = ttfm.sample_tokens(tl, rid, idx, temp,
                                 prng.PRNGKey(trial)).numpy()
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(trial),
                                         torch.from_numpy(rid)),
                            torch.from_numpy(idx))
        z = (prng.gumbel(keys, (v,), tdt)
             + tl / torch.from_numpy(np.maximum(temp, 1e-6))[:, None])
        ok = (np.ones(s, bool) if tdt == torch.bfloat16
              else _gap_ok(z) | (temp <= 0))
        np.testing.assert_array_equal(got[ok], want[ok])
        n_ok, n_all = n_ok + ok.sum(), n_all + s
    assert n_ok >= 0.9 * n_all


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_sample_host_matches_jax(jdt, tdt):
    """The host rule: the Python-float divisor is weakly typed, so
    bfloat16 logits are divided in bfloat16 and the draw is bfloat16."""
    rng = np.random.default_rng(12)
    v = 4099
    key = jax.random.PRNGKey(0)
    n_ok = 0
    for trial in range(40):
        row = np.asarray(jnp.asarray(rng.standard_normal(v) * 3, jdt))
        rid, idx = int(rng.integers(0, 2 ** 31)), int(rng.integers(0, 500))
        temp = float(rng.choice([0.0, 0.5, 0.8, 1.3]))
        want = jsample_host(row, rid, idx, temp, key)
        got = tsample_host(array_to_torch(row), rid, idx, temp,
                           prng.PRNGKey(0))
        ok = tdt == torch.bfloat16 or temp <= 0
        if not ok:
            k = prng.fold_in(prng.fold_in(prng.PRNGKey(0), rid), idx)
            lg = torch.tensor(row) / temp
            ok = bool(_gap_ok(prng.gumbel(k, (v,), tdt) + lg))
        if ok:
            assert got == want, (trial, rid, idx, temp)
            n_ok += 1
    assert n_ok >= 36


@pytest.fixture(scope="module")
def smoke():
    from repro.configs.registry import get_arch as jget_arch
    from repro_torch.configs.registry import get_arch as tget_arch
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


def test_static_generate_tempered_matches_jax(smoke):
    """``static_generate``'s own rule: token i of every row from ONE
    categorical over [B, V] keyed by fold_in(PRNGKey(1000), i), on the
    smoke model (float32).  Every token's gap clears the gap rule."""
    jc, tc, jp, tp = smoke
    prompts = np.random.default_rng(13).integers(0, jc.vocab, (3, 32)) \
        .astype(np.int32)
    want, _ = jstatic_generate(jp, jc, jnp.asarray(prompts), 12,
                               temperature=0.8)
    with torch.inference_mode():
        got, tm = tstatic_generate(tp, tc, torch.from_numpy(prompts), 12,
                                   temperature=0.8, record_gaps=True)
    assert (tm["top2_gap"] > 1e-4).all()
    np.testing.assert_array_equal(got, np.asarray(want))
