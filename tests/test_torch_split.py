"""The split plan of the paged-decode kernel (CPU).

``csrc/mita_paged_attn.cu`` spreads the keys of each (slot, KV head) over
the blocks that `kernels.mita_paged_attn.split_plan` names, each writing a
float32 partial (o, m, l) per query head, and merges the partials in split
order with the guarded ``_merge`` of the Pallas body.  `split_emulated`
below is that algorithm in plain PyTorch, block by block; it is held to
`paged_attention_plain` and to the JAX XLA oracle
(``mita_paged_decode_step``, external finalize) within 1e-6 in float32,
with the pools bit-exact.  The plan depends on the shapes only, so a
slot's output does not depend on the batch it is in.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mita_decode as jdec
from repro_torch.device import NEG_INF
from repro_torch.kernels import mita_paged_attn as mpa

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _partial(q, keys, vals, ok):
    """`_partial` of one block for one query head: q [d], keys / vals
    [n, d], ok [n] -> (o [d], m, l); masked lanes never contribute."""
    s = keys @ q / math.sqrt(q.shape[-1])
    s = torch.where(ok, s, torch.tensor(NEG_INF))
    m = s.max() if s.numel() else torch.tensor(NEG_INF)
    safe = 0.0 if m == NEG_INF else m
    p = torch.where(ok, torch.exp(s - safe), 0.0)
    return p @ vals, m, p.sum()


def _merge(a, b):
    """The guarded online-softmax merge of two partials (o, m, l)."""
    (o_a, m_a, l_a), (o_b, m_b, l_b) = a, b
    m_n = torch.maximum(m_a, m_b)
    safe = 0.0 if m_n == NEG_INF else m_n
    sa = 0.0 if m_a == NEG_INF else torch.exp(m_a - safe)
    sb = 0.0 if m_b == NEG_INF else torch.exp(m_b - safe)
    return o_a * sa + o_b * sb, m_n, l_a * sa + l_b * sb


def split_emulated(q, k_new, v_new, lm_q, lm_v, expert_idx, expert_valid,
                   k_pool, v_pool, page_table, t, active, m_cnt, *,
                   window: int, n_route: int, fuse_append: bool):
    """The kernel's two launches in plain PyTorch (float32): one partial
    per (slot, KV head, split, query head), then the merge in split order.
    Updates the pools in place like the kernel; returns out [S, Hkv, G,
    d]."""
    n_slots, hkv, g, d = q.shape
    m_slot, k_w = expert_idx.shape[-2:]
    w = window
    plan = mpa.split_plan(k_w, w, n_route, g)
    spe = -(-k_w // plan.rows)
    scratch = k_pool.shape[0] - 1
    zero = torch.zeros(d)
    empty = (zero, torch.tensor(NEG_INF), torch.tensor(0.0))
    out = torch.zeros(q.shape)
    for s in range(n_slots):
        ts, act, mc = int(t[s]), bool(active[s]), int(m_cnt[s])
        page0 = int(page_table[s, min(max(ts // w, 0), m_slot - 1)]) * w
        tpos = ts % w
        row_new = page0 + tpos if act else scratch
        for h in range(hkv):
            if fuse_append:                          # split 0's append
                k_pool[row_new, h] = k_new[s, h]
                v_pool[row_new, h] = v_new[s, h]
            kn, vn = k_new[s, h].float(), v_new[s, h].float()
            qs = q[s, h].float()
            lmq, lmv = lm_q[s, h].float(), lm_v[s, h].float()
            lm_ok = torch.arange(m_slot) < mc
            acc = [empty] * g
            for sp in range(plan.n_split):
                parts = [empty] * g
                if not act:
                    pass
                elif sp == 0:                                    # shared
                    parts = [_partial(qs[gi], lmq, lmv, lm_ok)
                             for gi in range(g)]
                elif sp <= plan.n_local:                         # local
                    j = (sp - 1) * plan.rows + torch.arange(plan.rows)
                    j = j[j < w]
                    if j.numel() and int(j[0]) <= tpos:
                        keys = k_pool[page0 + j, h].float()
                        vals = v_pool[page0 + j, h].float()
                        keys[j == tpos], vals[j == tpos] = kn, vn
                        parts = [_partial(qs[gi], keys, vals, j <= tpos)
                                 for gi in range(g)]
                else:                                            # routed
                    i = sp - 1 - plan.n_local
                    rnd, j0 = i // spe, (i % spe) * plan.rows
                    r = qs @ lmq.T / math.sqrt(d)                # [G, M]
                    r = torch.where(lm_ok[None, :], r, NEG_INF)
                    parts = []
                    for gi in range(g):
                        rg = r[gi].clone()
                        for _ in range(rnd + 1):
                            e = int(torch.argmax(rg))            # first max
                            best = rg[e].clone()
                            rg[e] = NEG_INF
                        rows = expert_idx[s, h, e, j0:j0 + plan.rows].long()
                        ok = (expert_valid[s, h, e, j0:j0 + plan.rows]
                              & bool(best > NEG_INF / 2))
                        keys = k_pool[rows, h].float()
                        vals = v_pool[rows, h].float()
                        if fuse_append and act:
                            keys[rows == row_new] = kn
                            vals[rows == row_new] = vn
                        parts.append(_partial(qs[gi], keys, vals, ok))
                acc = [_merge(a, b) for a, b in zip(acc, parts)]
            for gi, (o, _, l) in enumerate(acc):
                if act and l != 0:
                    out[s, h, gi] = o / l
    return out


def _state(seed, s_n=4, m_slot=4, hkv=2, d=16, g=2, w=64, k=64):
    """Random paged state (numpy, float32) over a shuffled table."""
    rng = np.random.default_rng(seed)
    n_pages = s_n * m_slot + 2
    table = rng.permutation(n_pages)[: s_n * m_slot].reshape(s_n, m_slot)
    rows = n_pages * w + 1
    st = jdec.PagedMiTAState(
        k_pool=rng.standard_normal((rows, hkv, d)).astype(np.float32),
        v_pool=rng.standard_normal((rows, hkv, d)).astype(np.float32),
        lm_q=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        lm_v=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        expert_idx=(table[:, None, :, None] * w + rng.integers(
            0, w, size=(s_n, hkv, m_slot, k))).astype(np.int32),
        expert_valid=rng.random((s_n, hkv, m_slot, k)) > 0.3,
        q_sum=np.zeros((s_n, hkv, d), np.float32),
        pre_lm_q=np.zeros((s_n, hkv, m_slot, d), np.float32),
        pre_q_sum=np.zeros((s_n, hkv, d), np.float32))
    q = rng.standard_normal((s_n, hkv, g, d)).astype(np.float32)
    kn = rng.standard_normal((s_n, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((s_n, hkv, d)).astype(np.float32)
    return st, table.astype(np.int32), q, kn, vn


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("w", [64, 8])
@pytest.mark.parametrize("n_route,fuse", [(1, True), (2, True), (1, False),
                                          (2, False)])
def test_split_emulation_vs_plain_and_xla(n_route, fuse, w):
    """Slot 0 has no visible landmark (t < w), slot 1 routes to experts
    whose rows are all invalid for KV head 0, slot 2 is inactive, slot 3
    sits on the last position of its page.  With w = 64 the plan has two
    local slices and two slices per expert; with w = 8 one of each."""
    st, table, q, kn, vn = _state(3, w=w, k=w)
    st.expert_valid[1, 0] = False
    t = np.asarray([w // 2 - 3, 2 * w + 5, 0, 4 * w - 1], np.int32)
    active = np.asarray([True, True, False, True])
    m_cnt = t // w
    if not fuse:    # the caller appends first, as the inline mode does
        rows = np.where(active, table[np.arange(4), t // w] * w + t % w,
                        st.k_pool.shape[0] - 1)
        st.k_pool[rows], st.v_pool[rows] = kn, vn
    pools = {}
    outs = {}
    for name, fn in (("emulated", split_emulated),
                     ("plain", mpa.paged_attention_plain)):
        kp, vp = _t(st.k_pool), _t(st.v_pool)
        outs[name] = fn(_t(q), _t(kn), _t(vn), _t(st.lm_q), _t(st.lm_v),
                        _t(st.expert_idx), _t(st.expert_valid), kp, vp,
                        _t(table), _t(t), _t(active), _t(m_cnt), window=w,
                        n_route=n_route, fuse_append=fuse)
        pools[name] = (kp, vp)
    cfg = jdec.DecodeConfig(window=w, k=w, s=n_route, paged_impl="xla",
                            external_finalize=True)
    j_out, j_st = jdec.mita_paged_decode_step(
        jax.tree.map(jnp.asarray, st), jnp.asarray(q), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(table), jnp.asarray(t),
        jnp.asarray(active), cfg)
    emu = outs["emulated"].numpy()
    np.testing.assert_allclose(emu, outs["plain"].numpy(), **TOL)
    np.testing.assert_allclose(emu, np.asarray(j_out), **TOL)
    assert np.all(emu[2] == 0)
    for a, b, jp in zip(pools["emulated"], pools["plain"],
                        (j_st.k_pool, j_st.v_pool)):
        assert torch.equal(a[:-1], b[:-1])
        np.testing.assert_array_equal(a[:-1].numpy(), np.asarray(jp)[:-1])


def test_split_plan_independent_of_batch():
    """The plan is a function of the shapes (K, w, n_route, G) only: the
    same for a batch of 1, 4 and 32 slots, and slot 0's output is bit for
    bit the same in each batch.  At the serving shapes of qwen3-0.6b
    (K = w = 128, G = 2) it puts 288 blocks in flight at S = 4."""
    ref = None
    outs = []
    for s_n in (1, 4, 32):
        st, table, q, kn, vn = _state(5, s_n=32)
        sl = slice(0, s_n)
        t = np.full(s_n, 2 * 64 + 9, np.int32)
        args = (_t(q[sl]), _t(kn[sl]), _t(vn[sl]), _t(st.lm_q[sl]),
                _t(st.lm_v[sl]), _t(st.expert_idx[sl]),
                _t(st.expert_valid[sl]), _t(st.k_pool), _t(st.v_pool),
                _t(table[sl]), _t(t), _t(np.ones(s_n, bool)),
                _t(t // 64))
        k_w = args[5].shape[-1]
        plan = mpa.split_plan(k_w, 64, 1, args[0].shape[2])
        ref = ref or plan
        assert plan == ref
        outs.append(split_emulated(*args, window=64, n_route=1,
                                   fuse_append=True)[0])
    assert all(torch.equal(o, outs[0]) for o in outs)
    serving = mpa.split_plan(128, 128, 1, 2)
    assert (serving.rows, serving.n_local, serving.n_routed) == (32, 4, 4)
    assert 4 * 8 * serving.n_split == 288 >= 132
