"""The split plan of the paged-finalize kernel (CPU).

``csrc/mita_paged_finalize.cu`` scores each page of a due slot's visible
context in its own block (a split) and keeps the split's float32 softmax
partials (m, l, o); a merge block per (slot, KV head) takes the exact
first-index top-K of the whole score row and merges the partials in split
order.  `finalize_emulated`
below is that algorithm in plain PyTorch, block by block.  It is held to
the JAX XLA oracle (``mita_paged_finalize`` with external finalize) and to
`paged_finalize_plain`: floats within 1e-6 in float32, expert rows and
validity exact, slots not due untouched.  The plan depends on the shapes
only, so a slot's result does not depend on the batch it is in.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mita_decode as jdec
from repro_torch.convert import paged_state_from_jax, to_numpy
from repro_torch.device import NEG_INF
from repro_torch.kernels import mita_paged_finalize as mpf

TOL = dict(atol=1e-6, rtol=1e-6)
W = 8
FIELDS = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def finalize_emulated(q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool,
                      v_pool, page_table, t_new, due, *, window: int,
                      k_width: int) -> None:
    """The kernel's two stages in plain PyTorch, in place (float32)."""
    w = window
    n_slots, hkv, m_slot, d = lm_q.shape
    ctx = m_slot * w
    for s in range(n_slots):
        if not due[s]:
            continue
        tn = int(t_new[s])
        ordinal, nvis = tn // w - 1, min(max(tn, 0), ctx)
        if not 0 <= ordinal < m_slot:
            q_sum[s] = 0.0
            continue
        for h in range(hkv):
            q = q_sum[s, h] / w
            # split stage: page j scores its visible positions and keeps
            # (m, l, o)
            scores, parts = torch.empty(nvis), []
            for j in range(-(-nvis // w)):
                c0 = j * w
                n = min(w, nvis - c0)
                rows = int(page_table[s, j]) * w + torch.arange(n)
                x = (k_pool[rows, h] @ q) / math.sqrt(d)
                scores[c0:c0 + n] = x
                p = torch.exp(x - x.max())
                parts.append((x.max(), p.sum(), p @ v_pool[rows, h]))
            # merge stage: top-K of the row, masked lanes in index order
            kvis = min(k_width, nvis)
            order = torch.sort(scores, descending=True, stable=True)[1][
                :kvis]
            loc = torch.cat([order, nvis + torch.arange(k_width - kvis)])
            valid = torch.arange(k_width) < kvis
            valid[:kvis] &= scores[order] > NEG_INF / 2
            m = max(pm for pm, _, _ in parts)
            den = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
            num = sum(torch.exp(pm - m) * po for pm, _, po in parts)
            lm_q[s, h, ordinal] = q
            lm_v[s, h, ordinal] = num / den
            expert_idx[s, h, ordinal] = (
                page_table[s, loc // w].long() * w + loc % w).int()
            expert_valid[s, h, ordinal] = valid
        q_sum[s] = 0.0


def _state(seed, s_n=4, m_slot=4, hkv=2, d=16, k=8, int_keys=False):
    rng = np.random.default_rng(seed)
    n_pages = s_n * m_slot + 2
    table = rng.permutation(n_pages)[: s_n * m_slot].reshape(s_n, m_slot)
    rows = n_pages * W + 1
    k_pool = rng.standard_normal((rows, hkv, d)).astype(np.float32)
    q_sum = rng.standard_normal((s_n, hkv, d)).astype(np.float32)
    if int_keys:     # three distinct key rows, integer landmark queries
        k_pool = rng.integers(-3, 4, (3, hkv, d))[
            rng.integers(0, 3, rows)].astype(np.float32)
        q_sum = (rng.integers(-3, 4, (s_n, hkv, d)) * W).astype(np.float32)
    st = jdec.PagedMiTAState(
        k_pool=k_pool,
        v_pool=rng.standard_normal((rows, hkv, d)).astype(np.float32),
        lm_q=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        lm_v=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        expert_idx=(table[:, None, :, None] * W + rng.integers(
            0, W, size=(s_n, hkv, m_slot, k))).astype(np.int32),
        expert_valid=rng.random((s_n, hkv, m_slot, k)) > 0.3,
        q_sum=q_sum,
        pre_lm_q=np.zeros((s_n, hkv, m_slot, d), np.float32),
        pre_q_sum=np.zeros((s_n, hkv, d), np.float32))
    return st, table.astype(np.int32)


def _run(fn, st, table, td, dd, k):
    s = paged_state_from_jax(st)
    fn(s.q_sum, s.lm_q, s.lm_v, s.expert_idx, s.expert_valid, s.k_pool,
       s.v_pool, torch.from_numpy(table), torch.from_numpy(td),
       torch.from_numpy(dd), window=W, k_width=k)
    return s


@pytest.mark.parametrize("t_new,due,k,int_keys", [
    ((8, 16, 0, 29), (True, True, False, False), 8, False),
    ((32, 8, 24, 5), (True, True, True, False), 8, False),
    ((0, 40, 16, 5), (True, True, False, True), 8, False),   # no commit
    ((16, 24, 32, 8), (True, True, True, True), 24, False),  # K > nvis
    ((32, 24, 16, 8), (True, True, True, True), 8, True),    # exact ties
])
def test_split_emulation_vs_xla_oracle(t_new, due, k, int_keys):
    st, table = _state(31, k=k, int_keys=int_keys)
    td, dd = np.asarray(t_new, np.int32), np.asarray(due)
    ref = jdec.mita_paged_finalize(
        jax.tree.map(jnp.asarray, st), jnp.asarray(table), jnp.asarray(td),
        jnp.asarray(dd), jdec.DecodeConfig(window=W, k=k, finalize_impl="xla",
                                           external_finalize=True))
    got = _run(finalize_emulated, st, table, td, dd, k)
    plain = _run(mpf.paged_finalize_plain, st, table, td, dd, k)
    for f in FIELDS:
        a = to_numpy(getattr(got, f))
        for b in (np.asarray(getattr(ref, f)), to_numpy(getattr(plain, f))):
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(a, b, err_msg=f, **TOL)
        np.testing.assert_array_equal(a[~dd], np.asarray(getattr(st, f))[~dd],
                                      err_msg=f"{f} non-due passthrough")


def test_split_emulation_is_batch_invariant():
    """A slot finalized alone gives the bits it gets among the others."""
    st, table = _state(33, s_n=6)
    td = np.asarray([32, 16, 24, 8, 32, 16], np.int32)
    dd = np.ones(6, bool)
    full = _run(finalize_emulated, st, table, td, dd, 8)
    for i in (0, 3, 5):
        one = jdec.PagedMiTAState(*(
            x if name in ("k_pool", "v_pool") else x[i:i + 1]
            for name, x in zip(jdec.PagedMiTAState._fields, st)))
        alone = _run(finalize_emulated, one, table[i:i + 1], td[i:i + 1],
                     dd[i:i + 1], 8)
        for f in FIELDS:
            assert torch.equal(getattr(alone, f)[0], getattr(full, f)[i]), f
