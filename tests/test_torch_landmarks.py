"""The port's landmark extractors (`core.landmarks`) and the MiTA ablations
against the JAX reference (CPU): ``pool2d``, ``random_select`` (its
indices exact against ``jax.random.permutation``), ``learnable``,
``prng.split`` / ``prng.permutation``, and bidirectional MiTA with a
``pool2d`` or ``random`` landmark config and the ``route_only`` /
``compress_only`` ablations, through ``mita_attention`` and every ``impl``
of ``mita_attention_sparse``.

The same numpy inputs go through both packages.  Tolerances: the
extractors 1e-6 (a mean in another order); the attention outputs 3e-5
(the sparse forwards' tolerance in `tests/test_torch_sparse.py`);
indices and permutations exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding  # noqa: F401  (threefry partitionable)
from repro.core import landmarks as jlm
from repro.core import mita as jmita
from repro.core import mita_sparse as jsparse
from repro_torch import prng
from repro_torch.core import landmarks as tlm
from repro_torch.core import mita as tmita
from repro_torch.core import mita_sparse as tsparse

LM_TOL = dict(atol=1e-6, rtol=1e-6)
ATTN_TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, lead, n, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(lead + (n, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("grid,m_hw", [((8, 8), (4, 4)), ((14, 14), (7, 7)),
                                       ((6, 10), (3, 5))])
def test_pool2d(grid, m_hw):
    q = _qkv(0, (2, 3), grid[0] * grid[1], 16)[0]
    got = tlm.pool2d(torch.from_numpy(q), grid, m_hw)
    want = jlm.pool2d(jnp.asarray(q), grid, m_hw)
    assert tuple(got.shape) == (2, 3, m_hw[0] * m_hw[1], 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        tlm.pool2d(torch.from_numpy(q), grid, (grid[0] + 1, m_hw[1]))


@pytest.mark.parametrize("n", [64, 196, 1500])
def test_random_select_indices_exact(n):
    """`prng.permutation` is ``jax.random.permutation`` element for element
    (one sort round at these sizes; no two sort keys collide), and
    `random_select` takes the same rows."""
    for seed in (0, 7):
        got = prng.permutation(prng.PRNGKey(seed), n).numpy()
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        np.testing.assert_array_equal(got, want)
        sub = prng.split(prng.PRNGKey(seed))[1]
        bits = prng.random_bits(sub, 32, (n,)).numpy()
        assert len(np.unique(bits)) == n
    m = max(1, n // 16)
    q = _qkv(1, (2,), n, 8)[0]
    got = tlm.random_select(torch.from_numpy(q), m)
    want = jlm.random_select(jnp.asarray(q), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_select_positions_cached_for_training():
    """`random_select` draws its positions once per (seed, N, m, device):
    a call under inference mode leaves them usable by a later call whose
    backward pass saves them, and the gradient lands on the picked rows
    only."""
    n, m = 96, 6
    q = torch.from_numpy(_qkv(3, (2,), n, 8)[0])
    with torch.inference_mode():
        first = tlm.random_select(q, m)
    qg = q.clone().requires_grad_()
    out = tlm.random_select(qg, m)
    assert torch.equal(out.detach(), first)
    out.sum().backward()
    picked = qg.grad[0].abs().sum(-1) > 0
    idx = np.sort(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(0), n))[:m])
    np.testing.assert_array_equal(np.flatnonzero(picked.numpy()), idx)


def test_split_and_two_round_permutation():
    """``jax.random.split`` exact, and a size that takes two sort rounds
    (n > ~1625)."""
    for seed in (0, 3, 2 ** 31 + 5):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 3))
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), 3).numpy(), want)
    n = 2000
    np.testing.assert_array_equal(
        prng.permutation(prng.PRNGKey(0), n).numpy(),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n)))


def test_learnable():
    p = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    got = tlm.learnable(torch.from_numpy(p), (2, 3))
    want = jlm.learnable(jnp.asarray(p), (2, 3))
    assert tuple(got.shape) == (2, 3, 5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(tlm.EXTRACTORS) == set(jlm.EXTRACTORS)


def _cfgs(**kw):
    return jmita.MiTAConfig(**kw), tmita.MiTAConfig(**kw)


POOL2D = dict(m=16, k=12, landmark="pool2d", grid_hw=(8, 8), m_hw=(4, 4))
CASES = {
    "pool2d": POOL2D,
    "pool2d_s2": dict(POOL2D, s=2),
    "random": dict(m=8, k=12, landmark="random"),
    "pool1d": dict(m=8, k=12),
    "route_only": dict(m=8, k=12, route_only=True),
    "compress_only": dict(m=8, k=12, compress_only=True),
    "pool2d_route_only": dict(POOL2D, route_only=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mita_attention_bidirectional(case):
    """The oracle, bidirectional, for each landmark extractor and
    ablation."""
    jc, tc = _cfgs(**CASES[case])
    q, k, v = _qkv(3, (2, 2), 64, 16)
    got = tmita.mita_attention(*(torch.from_numpy(x) for x in (q, k, v)), tc)
    want = jmita.mita_attention(*(jnp.asarray(x) for x in (q, k, v)), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("impl", ["sorted", "pallas", "capacity"])
@pytest.mark.parametrize("case", ["pool2d", "pool2d_s2", "random",
                                  "route_only", "compress_only"])
def test_mita_attention_sparse_bidirectional(case, impl):
    """The production forward, bidirectional, span = m on the sorted path
    (exact); ``pallas`` runs the plain expert kernel here and the Pallas
    kernel in interpret mode on the JAX side."""
    jc, tc = _cfgs(**CASES[case])
    q, k, v = _qkv(4, (2, 2), 64, 16)
    kw = dict(impl=impl, block_q=16, expert_span=jc.m, capacity_factor=4.0)
    got = tsparse.mita_attention_sparse(
        *(torch.from_numpy(x) for x in (q, k, v)), tc, **kw)
    want = jsparse.mita_attention_sparse(
        *(jnp.asarray(x) for x in (q, k, v)), jc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    oracle = tmita.mita_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  tc)
    if impl != "capacity":
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **ATTN_TOL)


def test_extract_landmarks_errors():
    q = torch.zeros(1, 64, 8)
    with pytest.raises(ValueError, match="grid_hw"):
        tmita.extract_landmarks(q, tmita.MiTAConfig(m=16, k=4,
                                                    landmark="pool2d"))
    with pytest.raises(ValueError, match="unknown"):
        tmita.extract_landmarks(q, tmita.MiTAConfig(m=16, k=4,
                                                    landmark="learned"))
