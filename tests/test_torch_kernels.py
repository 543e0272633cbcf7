"""The port's two kernel modules against the JAX reference (CPU).  The
CUDA kernels themselves are checked on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Each plain PyTorch version is held to both JAX forms of its function: the
Pallas kernel run in interpret mode and the XLA oracle.  Cases follow
``tests/test_kernel_oracle.py``: shuffled page tables, ragged per-slot
``t``, inactive slots, scratch-row appends, non-due passthrough and
external finalize on/off.  Float outputs agree to atol = rtol = 1e-5
(float32); pools outside the scratch row, expert rows and validity are
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mita_decode as jdec
from repro.kernels import mita_paged_attn as jmpa
from repro.kernels import mita_paged_finalize as jmpf
from repro_torch.convert import paged_state_from_jax, to_numpy
from repro_torch.core import mita_decode as tdec
from repro_torch.kernels import mita_paged_attn as tmpa
from repro_torch.kernels import mita_paged_finalize as tmpf
from repro_torch.kernels import ops

TOL = dict(atol=1e-5, rtol=1e-5)
W, K = 8, 8
FIN_FIELDS = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_state(st_t, st_j, fields):
    """Integers exact, floats to TOL; pools without the scratch row."""
    for f in fields:
        a, b = to_numpy(getattr(st_t, f)), np.asarray(getattr(st_j, f))
        if f in ("k_pool", "v_pool"):
            a, b = a[:-1], b[:-1]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


# ------------------------------------------------------------ paged decode --

def _random_state(seed, s_n=4, m_slot=4, hkv=2, d=16, g=2):
    """Random paged state over a shuffled table: pools, landmarks, expert
    rows (global rows into each slot's own pages), validity and q_sum."""
    rng = np.random.default_rng(seed)
    n_pages = s_n * m_slot + 2
    table = rng.permutation(n_pages)[: s_n * m_slot].reshape(s_n, m_slot)
    rows = n_pages * W + 1
    own = (table[:, None, :, None] * W
           + rng.integers(0, W, size=(s_n, hkv, m_slot, K)))
    st = jdec.PagedMiTAState(
        k_pool=rng.standard_normal((rows, hkv, d)).astype(np.float32),
        v_pool=rng.standard_normal((rows, hkv, d)).astype(np.float32),
        lm_q=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        lm_v=rng.standard_normal((s_n, hkv, m_slot, d)).astype(np.float32),
        expert_idx=own.astype(np.int32),
        expert_valid=rng.random((s_n, hkv, m_slot, K)) > 0.3,
        q_sum=rng.standard_normal((s_n, hkv, d)).astype(np.float32),
        pre_lm_q=np.zeros((s_n, hkv, m_slot, d), np.float32),
        pre_q_sum=np.zeros((s_n, hkv, d), np.float32))
    q = rng.standard_normal((s_n, hkv, g, d)).astype(np.float32)
    kn = rng.standard_normal((s_n, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((s_n, hkv, d)).astype(np.float32)
    return st, table.astype(np.int32), q, kn, vn


@pytest.mark.parametrize("n_route,fuse", [(1, True), (2, True), (1, False)])
def test_paged_attention_plain_vs_pallas(n_route, fuse):
    """One call of the plain version against the Pallas kernel in
    interpret mode: ragged t (first, middle and last page positions), an
    inactive slot, a slot with no finalised landmark, random validity."""
    st, table, q, kn, vn = _random_state(11)
    t = np.asarray([5, 17, 0, 31], np.int32)
    active = np.asarray([True, True, False, True])
    m_cnt = t // W
    if not fuse:    # the caller appends first, as the inline mode does
        rows = np.where(active, table[np.arange(4), t // W] * W + t % W,
                        st.k_pool.shape[0] - 1)
        st.k_pool[rows], st.v_pool[rows] = kn, vn
    j_out, j_kp, j_vp = jmpa.mita_paged_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(st.lm_q), jnp.asarray(st.lm_v),
        jnp.asarray(st.expert_idx), jnp.asarray(st.expert_valid),
        jnp.asarray(st.k_pool), jnp.asarray(st.v_pool), jnp.asarray(table),
        jnp.asarray(t), jnp.asarray(active), jnp.asarray(m_cnt), window=W,
        n_route=n_route, fuse_append=fuse, interpret=True)
    kp, vp = _t(st.k_pool.copy()), _t(st.v_pool.copy())
    out = tmpa.paged_attention_plain(
        _t(q), _t(kn), _t(vn), _t(st.lm_q), _t(st.lm_v),
        _t(st.expert_idx), _t(st.expert_valid), kp, vp, _t(table), _t(t),
        _t(active), _t(m_cnt), window=W, n_route=n_route, fuse_append=fuse)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_array_equal(kp.numpy()[:-1], np.asarray(j_kp)[:-1])
    np.testing.assert_array_equal(vp.numpy()[:-1], np.asarray(j_vp)[:-1])


def _pair(s_route=1, external=True):
    return jdec.DecodeConfig(window=W, k=K, s=s_route, paged_impl="xla",
                             external_finalize=external)


@pytest.mark.parametrize("s_route,external", [(1, True), (2, True),
                                              (1, False)])
def test_paged_decode_drive_vs_xla(s_route, external):
    """The port's `mita_paged_decode_step` (+ `mita_paged_finalize` when
    due) stepped beside the JAX XLA oracle: shuffled pages, slots joining
    at different steps, inactive slots.  Outputs, pools (scratch row
    excluded) and landmark/expert state agree every step."""
    cfg_j = _pair(s_route, external)
    cfg_t = tdec.DecodeConfig(window=W, k=K, s=s_route,
                              external_finalize=external)
    b, hkv, g, d, n_steps, offs = 3, 2, 2, 16, 24, [0, 5, 11]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, hkv, g, n_steps, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n_steps, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n_steps, d)).astype(np.float32)
    m = (n_steps + W - 1) // W
    n_pages = b * m + 2
    table = rng.permutation(n_pages)[: b * m].reshape(b, m).astype(np.int32)
    st_j = jdec.init_paged_state(hkv, d, n_pages, b, m, cfg_j, jnp.float32)
    st_t = paged_state_from_jax(jax.device_get(st_j))
    step_j = jax.jit(lambda s, *a: jdec.mita_paged_decode_step(s, *a, cfg_j))
    fin_j = jax.jit(lambda s, *a: jdec.mita_paged_finalize(s, *a, cfg_j))
    t = np.zeros(b, np.int32)
    m_done = np.zeros(b, np.int32)
    pt_j, pt_t = jnp.asarray(table), _t(table)
    for i in range(n_steps):
        act = np.array([offs[s] <= i for s in range(b)])
        if external:
            due = act & (t % W == 0) & (t // W > m_done)
            if due.any():
                st_j = fin_j(st_j, pt_j, jnp.asarray(t), jnp.asarray(due))
                st_t = tdec.mita_paged_finalize(st_t, pt_t, _t(t), _t(due),
                                                cfg_t)
                m_done = np.where(due, t // W, m_done)
        idx = [(i - offs[s]) % n_steps for s in range(b)]
        qi = np.stack([q[s, :, :, idx[s]] for s in range(b)])
        ki = np.stack([k[s, :, idx[s]] for s in range(b)])
        vi = np.stack([v[s, :, idx[s]] for s in range(b)])
        o_j, st_j = step_j(st_j, jnp.asarray(qi), jnp.asarray(ki),
                           jnp.asarray(vi), pt_j, jnp.asarray(t),
                           jnp.asarray(act))
        o_t, st_t = tdec.mita_paged_decode_step(
            st_t, _t(qi), _t(ki), _t(vi), pt_t, _t(t), _t(act), cfg_t)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                                   err_msg=f"step {i}", **TOL)
        _assert_state(st_t, st_j, FIN_FIELDS + ("k_pool", "v_pool"))
        t = t + act


def test_paged_scratch_row_append_and_shared_prefix_isolation():
    """An inactive slot's append lands in the scratch row only; two slots
    whose tables alias the same prefix pages write only their own append
    rows (the prefix pages stay untouched)."""
    hkv, g, d = 2, 1, 16
    cfg = tdec.DecodeConfig(window=W, k=K, external_finalize=True)
    rng = np.random.default_rng(7)
    n_pages = 5
    table = np.asarray([[0, 1, 2], [0, 1, 3]], np.int32)
    st = tdec.init_paged_state(hkv, d, n_pages, 2, 3, cfg, torch.float32)
    pool = _t(rng.standard_normal((n_pages * W + 1, hkv, d)).astype(
        np.float32))
    st.k_pool.copy_(pool)
    st.v_pool.copy_(pool + 1.0)
    qi = _t(rng.standard_normal((2, hkv, g, d)).astype(np.float32))
    ki = _t(rng.standard_normal((2, hkv, d)).astype(np.float32))
    vi = _t(rng.standard_normal((2, hkv, d)).astype(np.float32))
    t = _t(np.asarray([2 * W + 1, 2 * W + 3], np.int32))
    act = _t(np.asarray([True, False]))
    before = st.k_pool.clone()
    out, st = tdec.mita_paged_decode_step(st, qi, ki, vi, _t(table), t, act,
                                          cfg)
    row0 = int(table[0, 2]) * W + 1
    scratch = st.k_pool.shape[0] - 1
    assert torch.equal(st.k_pool[row0], ki[0])
    assert torch.equal(st.v_pool[row0], vi[0])
    assert torch.equal(st.k_pool[scratch], ki[1])
    mask = torch.ones(st.k_pool.shape[0], dtype=torch.bool)
    mask[[row0, scratch]] = False
    assert torch.equal(st.k_pool[mask], before[mask])
    assert torch.all(out[1] == 0)


def test_gather_pages_owned_redirects_to_scratch():
    hkv, d, w = 2, 4, 4
    pool = torch.arange(9 * hkv * d, dtype=torch.float32).reshape(9, hkv, d)
    out = ops.gather_pages(pool, _t(np.asarray([[0, 1], [1, 0]], np.int32)),
                           w, owned=_t(np.asarray([1, 2], np.int32)))
    ref = pool.numpy()
    np.testing.assert_array_equal(out.numpy()[0, :w], ref[0:w])
    np.testing.assert_array_equal(out.numpy()[0, w:],
                                  np.broadcast_to(ref[8], (w, hkv, d)))
    np.testing.assert_array_equal(out.numpy()[1],
                                  np.concatenate([ref[4:8], ref[0:4]]))


# ---------------------------------------------------------- paged finalize --

@pytest.mark.parametrize("t_new,due", [
    ((8, 16, 0, 29), (True, True, False, False)),
    ((32, 8, 24, 5), (True, True, True, False)),
    ((0, 40, 16, 5), (True, True, False, True)),
])
def test_finalize_plain_vs_xla_and_pallas(t_new, due):
    """Plain finalize against `_paged_finalize` (XLA) and the Pallas
    kernel in interpret mode: shuffled table, ragged t_new (first, middle
    and last ordinals), non-due and t = 0 slots, and due slots whose
    ordinal t_new // w - 1 lies outside [0, M) (t_new 0, 5 and 40 of a
    32-position context), which commit nothing but still zero their
    q_sum.  Non-due rows pass through bit-exactly; the pools are never
    written."""
    st, table, _, _, _ = _random_state(9)
    td, dd = np.asarray(t_new, np.int32), np.asarray(due)
    cfg_j = jdec.DecodeConfig(window=W, k=K, finalize_impl="xla",
                              external_finalize=True)
    st_jx = jdec.mita_paged_finalize(
        jax.tree.map(jnp.asarray, st), jnp.asarray(table), jnp.asarray(td),
        jnp.asarray(dd), cfg_j)
    pk = jmpf.mita_paged_finalize_fused(
        jnp.asarray(st.q_sum), jnp.asarray(st.lm_q), jnp.asarray(st.lm_v),
        jnp.asarray(st.expert_idx), jnp.asarray(st.expert_valid),
        jnp.asarray(st.k_pool), jnp.asarray(st.v_pool), jnp.asarray(table),
        jnp.asarray(td), jnp.asarray(dd), window=W, k_width=K,
        interpret=True)
    st_jk = st_jx._replace(lm_q=pk[0], lm_v=pk[1], expert_idx=pk[2],
                           expert_valid=pk[3].astype(bool), q_sum=pk[4])
    st_t = paged_state_from_jax(st)
    tdec.mita_paged_finalize(st_t, _t(table), _t(td), _t(dd),
                             tdec.DecodeConfig(window=W, k=K,
                                               external_finalize=True))
    for ref in (st_jx, st_jk):
        _assert_state(st_t, ref, FIN_FIELDS)
    for f in FIN_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(st_t, f))[~dd],
                                      np.asarray(getattr(st, f))[~dd],
                                      err_msg=f"{f} non-due passthrough")
    np.testing.assert_array_equal(st_t.k_pool.numpy(), st.k_pool)
    np.testing.assert_array_equal(st_t.v_pool.numpy(), st.v_pool)


def test_finalize_plain_round_dtype():
    """``round_dtype`` (ROADMAP C.8): the default rounds the landmark query
    to the pool dtype, so on float32 pools it equals ``round_dtype=
    torch.float32`` bit for bit (the state `test_finalize_plain_vs_xla_and
    _pallas` holds exact); ``round_dtype=torch.bfloat16`` on float32 copies
    stores exactly ``(q_sum / w).to(torch.bfloat16)`` as ``lm_q`` and ranks
    the context by that rounded query (first-index ties, inputs without
    near-ties), as the bfloat16 kernel does."""
    st, table, _, _, _ = _random_state(9)
    td = np.asarray([8, 16, 24, 29], np.int32)
    dd = np.asarray([True, True, True, False])
    q_sum0 = torch.from_numpy(st.q_sum.copy())
    runs = {}
    for name, rdt in (("default", None), ("f32", torch.float32),
                      ("bf16", torch.bfloat16)):
        s_t = paged_state_from_jax(st)
        tmpf.paged_finalize_plain(
            s_t.q_sum, s_t.lm_q, s_t.lm_v, s_t.expert_idx, s_t.expert_valid,
            s_t.k_pool, s_t.v_pool, _t(table), _t(td), _t(dd), window=W,
            k_width=K, round_dtype=rdt)
        runs[name] = s_t
    for f in FIN_FIELDS:
        assert torch.equal(getattr(runs["default"], f),
                           getattr(runs["f32"], f)), f

    got = runs["bf16"]
    q_lm = (q_sum0 / W).to(torch.bfloat16).float()          # [S, H, d]
    pool_k = torch.from_numpy(st.k_pool)
    d = pool_k.shape[-1]
    for s in np.nonzero(dd)[0]:
        i = td[s] // W - 1
        assert torch.equal(got.lm_q[s, :, i], q_lm[s])
        ctx_rows = (table[s][:, None] * W + np.arange(W)).reshape(-1)
        n_vis = td[s]
        for h in range(q_lm.shape[1]):
            sc = (pool_k[ctx_rows[:n_vis], h] @ q_lm[s, h]).numpy() \
                / np.sqrt(d)
            gaps = np.diff(np.sort(sc))
            assert gaps.size == 0 or gaps.min() > 1e-5   # no near-ties
            full = np.full(len(ctx_rows), -np.inf)
            full[:n_vis] = sc
            order = np.argsort(-full, kind="stable")[:K]
            np.testing.assert_array_equal(got.expert_idx[s, h, i].numpy(),
                                          ctx_rows[order])
            np.testing.assert_array_equal(got.expert_valid[s, h, i].numpy(),
                                          order < n_vis)


def test_dispatch_routes_by_device():
    """CPU tensors take the plain versions (no kernel launch is counted);
    tensors on a device with neither path raise; mixed devices raise."""
    st, table, q, kn, vn = _random_state(2)
    st_t = paged_state_from_jax(st)
    t = _t(np.asarray([3, 9, 0, 20], np.int32))
    act = _t(np.asarray([True, True, False, True]))
    ops.reset_launch_counts()
    ops.paged_decode_attend(_t(q), _t(kn), _t(vn), st_t.lm_q, st_t.lm_v,
                            st_t.expert_idx, st_t.expert_valid, st_t.k_pool,
                            st_t.v_pool, _t(table), t, act, t // W,
                            window=W, n_route=1, fuse_append=True)
    ops.paged_finalize(st_t.q_sum, st_t.lm_q, st_t.lm_v, st_t.expert_idx,
                       st_t.expert_valid, st_t.k_pool, st_t.v_pool,
                       _t(table), t, act, window=W, k_width=K)
    assert ops.launch_counts() == {"mita_paged_attention": 0,
                                   "mita_paged_finalize_fused": 0,
                                   "mita_chunk_prefill_fused": 0,
                                   "mita_expert_attention": 0,
                                   "flash_attention": 0}
    with pytest.raises(ValueError, match="mixed devices"):
        ops.paged_finalize(st_t.q_sum.to("meta"), st_t.lm_q, st_t.lm_v,
                           st_t.expert_idx, st_t.expert_valid, st_t.k_pool,
                           st_t.v_pool, _t(table), t, act, window=W,
                           k_width=K)
    meta = [x.to("meta") for x in (st_t.q_sum, st_t.lm_q, st_t.lm_v,
                                   st_t.expert_idx, st_t.expert_valid,
                                   st_t.k_pool, st_t.v_pool, _t(table), t,
                                   act)]
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.paged_finalize(*meta, window=W, k_width=K)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never compute on the CPU: they raise before
    building or launching anything."""
    st, table, q, kn, vn = _random_state(4)
    st_t = paged_state_from_jax(st)
    t = _t(np.asarray([3, 9, 0, 20], np.int32))
    act = _t(np.asarray([True, True, False, True]))
    with pytest.raises(ValueError, match="CUDA"):
        tmpa.mita_paged_attention(
            _t(q), _t(kn), _t(vn), st_t.lm_q, st_t.lm_v, st_t.expert_idx,
            st_t.expert_valid, st_t.k_pool, st_t.v_pool, _t(table), t, act,
            t // W, window=W)
    with pytest.raises(ValueError, match="CUDA"):
        tmpf.mita_paged_finalize_fused(
            st_t.q_sum, st_t.lm_q, st_t.lm_v, st_t.expert_idx,
            st_t.expert_valid, st_t.k_pool, st_t.v_pool, _t(table), t, act,
            window=W, k_width=K)
