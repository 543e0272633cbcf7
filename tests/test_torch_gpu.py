"""The port's CUDA kernels against their plain PyTorch versions on the card
(marker ``gpu``).  This file imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips (decided in a fixture).
Tolerances: 1e-5 (float32 pools) and 2e-2 (bfloat16 pools), absolute and
relative.  With bfloat16 pools the plain version runs on float32 copies of
the same bfloat16 values: the kernel computes in float32, and the plain
version's bfloat16 products would round scores enough to flip routing and
top-k decisions (the chunk-prefill and finalize checks also have the plain
version round its landmark queries to bfloat16, as the kernel does).
Pools outside the scratch row are exact, and so are the finalize's expert
rows and validity in both dtypes.  Training (no kernel on its path): one
float32 train step card vs CPU (loss 1e-5, every gradient leaf 1e-4 of
its max), and three deterministic steps twice on the card, bit for bit.
Distribution: a 1 x 1 mesh over a one-rank ``nccl`` group, its sharded
train step against `train_step` on the card, and ``compressed_grad_mean``
over ``nccl``, both bit for bit.  The dry run: its FLOPs of a smoke train
cell traced on fake ``cuda`` tensors equal a real card step's.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mita_decode as mdec
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import mita_chunk_prefill as mcp
from repro_torch.kernels import mita_expert_attn as mea
from repro_torch.kernels import mita_paged_attn as mpa
from repro_torch.kernels import mita_paged_finalize as mpf
from repro_torch.kernels import ops

W, K = 8, 8
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FIN_FIELDS = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(seed, dtype, dev, s_n=4, m_slot=4, hkv=2, d=16, g=2, w=W, k=K):
    rng = np.random.default_rng(seed)
    n_pages = s_n * m_slot + 2
    table = rng.permutation(n_pages)[: s_n * m_slot].reshape(s_n, m_slot)
    cfg = mdec.DecodeConfig(window=w, k=k, external_finalize=True)
    st = mdec.init_paged_state(hkv, d, n_pages, s_n, m_slot, cfg, dtype, dev)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    for x in (st.k_pool, st.v_pool, st.lm_q, st.lm_v, st.q_sum):
        x.copy_(rnd(*x.shape))
    st.expert_idx.copy_(torch.from_numpy(
        table[:, None, :, None] * w
        + rng.integers(0, w, size=(s_n, hkv, m_slot, k))))
    st.expert_valid.copy_(torch.from_numpy(
        rng.random((s_n, hkv, m_slot, k)) > 0.3))
    pt = torch.from_numpy(table.astype(np.int32)).to(dev)
    q, kn, vn = (rnd(s_n, hkv, g, d).to(dtype), rnd(s_n, hkv, d).to(dtype),
                 rnd(s_n, hkv, d).to(dtype))
    return st, pt, q, kn, vn


def _clone(st, dtype=None):
    """Copy of a state; ``dtype`` recasts the floating fields (the plain
    reference of a bfloat16 run computes on float32 copies)."""
    return type(st)(*(x.to(dtype, copy=True)
                      if dtype is not None and x.is_floating_point()
                      else x.clone() for x in st))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_route,fuse", [(1, True), (2, True), (1, False)])
def test_paged_attention_kernel_vs_plain(cuda_device, dtype, n_route, fuse):
    st, pt, q, kn, vn = _state(11, dtype, cuda_device)
    t = torch.tensor([5, 17, 0, 31], dtype=torch.int32, device=cuda_device)
    act = torch.tensor([True, True, False, True], device=cuda_device)
    if not fuse:    # the caller appends first, as the inline mode does
        rows = torch.where(act, pt[torch.arange(4), t // W].long() * W
                           + t % W, st.k_pool.shape[0] - 1)
        st.k_pool[rows], st.v_pool[rows] = kn, vn
    a, b = _clone(st, torch.float32), _clone(st)
    args = lambda s, x: (x(q), x(kn), x(vn), s.lm_q,  # noqa: E731
                         s.lm_v, s.expert_idx, s.expert_valid, s.k_pool,
                         s.v_pool, pt, t, act, t // W)
    ref = mpa.paged_attention_plain(*args(a, lambda x: x.float()), window=W,
                                    n_route=n_route, fuse_append=fuse)
    ops.reset_launch_counts()
    out = ops.paged_decode_attend(*args(b, lambda x: x), window=W,
                                  n_route=n_route, fuse_append=fuse)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_paged_attention"] == 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(a.k_pool[:-1], b.k_pool[:-1].float())
    assert torch.equal(a.v_pool[:-1], b.v_pool[:-1].float())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_route,fuse", [(1, True), (2, False)])
def test_paged_attention_kernel_long_context(cuda_device, dtype, n_route,
                                             fuse):
    """S = 32 slots of M = 32 pages (4096 tokens of context at w = 128),
    where S * Hkv alone fills the card: ragged t, inactive slots, slots
    without a visible landmark; the split kernel matches the plain
    version, pools exact."""
    w = 128
    st, pt, q, kn, vn = _state(12, dtype, cuda_device, s_n=32, m_slot=32,
                               hkv=2, d=128, w=w, k=w)
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.integers(0, 32 * w, 32).astype(np.int32)).to(
        cuda_device)
    t[:3] = torch.tensor([0, 5, w - 1], dtype=torch.int32)
    act = torch.from_numpy(rng.random(32) > 0.15).to(cuda_device)
    if not fuse:
        rows = torch.where(act, pt[torch.arange(32), t // w].long() * w
                           + t % w, st.k_pool.shape[0] - 1)
        st.k_pool[rows], st.v_pool[rows] = kn, vn
    a, b = _clone(st, torch.float32), _clone(st)
    args = lambda s, x: (x(q), x(kn), x(vn), s.lm_q,  # noqa: E731
                         s.lm_v, s.expert_idx, s.expert_valid, s.k_pool,
                         s.v_pool, pt, t, act, t // w)
    ref = mpa.paged_attention_plain(*args(a, lambda x: x.float()), window=w,
                                    n_route=n_route, fuse_append=fuse)
    ops.reset_launch_counts()
    out = ops.paged_decode_attend(*args(b, lambda x: x), window=w,
                                  n_route=n_route, fuse_append=fuse)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_paged_attention"] == 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.all(out[~act] == 0)
    assert torch.equal(a.k_pool[:-1], b.k_pool[:-1].float())
    assert torch.equal(a.v_pool[:-1], b.v_pool[:-1].float())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_new,due", [
    ((8, 16, 0, 29), (True, True, False, False)),
    ((32, 8, 24, 5), (True, True, True, False)),
])
def test_finalize_kernel_vs_plain(cuda_device, dtype, t_new, due):
    st, pt, _, _, _ = _state(9, dtype, cuda_device)
    td = torch.tensor(t_new, dtype=torch.int32, device=cuda_device)
    dd = torch.tensor(due, device=cuda_device)
    a, b = _clone(st, torch.float32), _clone(st)
    fargs = lambda s: (s.q_sum, s.lm_q, s.lm_v, s.expert_idx,  # noqa: E731
                       s.expert_valid, s.k_pool, s.v_pool, pt, td, dd)
    mpf.paged_finalize_plain(*fargs(a), window=W, k_width=K,
                             round_dtype=dtype)
    ops.reset_launch_counts()
    ops.paged_finalize(*fargs(b), window=W, k_width=K)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_paged_finalize_fused"] == 1
    tol = TOL[dtype]
    for f in ("lm_q", "lm_v", "q_sum"):
        torch.testing.assert_close(getattr(b, f).float(),
                                   getattr(a, f).float(), atol=tol, rtol=tol)
    assert torch.equal(b.expert_idx, a.expert_idx)
    assert torch.equal(b.expert_valid, a.expert_valid)
    nd = ~dd
    for f in FIN_FIELDS:
        assert torch.equal(getattr(b, f)[nd], getattr(st, f)[nd]), f


@pytest.mark.gpu
def test_finalize_kernel_workspace_path(cuda_device):
    """A context whose score row exceeds the shared memory a block can use
    runs through the workspace path and still matches the plain version."""
    dtype = torch.float32
    st, pt, _, _, _ = _state(5, dtype, cuda_device, s_n=2, m_slot=4, d=16)
    w_big = 16384                    # ctx = 4 * 16384 floats = 256 KiB
    n_pages = pt.max().item() + 1
    rows = n_pages * w_big + 1
    g = torch.Generator(device=cuda_device).manual_seed(0)
    kp = torch.randn((rows, 2, 16), generator=g, device=cuda_device)
    vp = torch.randn((rows, 2, 16), generator=g, device=cuda_device)
    st = st._replace(k_pool=kp, v_pool=vp)
    td = torch.tensor([2 * w_big, 3 * w_big], dtype=torch.int32,
                      device=cuda_device)
    dd = torch.tensor([True, True], device=cuda_device)
    a, b = _clone(st), _clone(st)
    for fn, s in ((mpf.paged_finalize_plain, a),
                  (mpf.mita_paged_finalize_fused, b)):
        fn(s.q_sum, s.lm_q, s.lm_v, s.expert_idx, s.expert_valid, s.k_pool,
           s.v_pool, pt, td, dd, window=w_big, k_width=K)
    torch.cuda.synchronize()
    torch.testing.assert_close(b.lm_v, a.lm_v, atol=1e-5, rtol=1e-5)
    assert torch.equal(b.expert_idx, a.expert_idx)


def _finalize_both(st, pt, td, dd, dtype, w, k):
    """The plain version on float32 copies (landmark query rounded as the
    kernel rounds it) and the kernel on a copy: (plain, kernel) states."""
    a, b = _clone(st, torch.float32), _clone(st)
    fargs = lambda s: (s.q_sum, s.lm_q, s.lm_v, s.expert_idx,  # noqa: E731
                       s.expert_valid, s.k_pool, s.v_pool, pt, td, dd)
    mpf.paged_finalize_plain(*fargs(a), window=w, k_width=k,
                             round_dtype=dtype)
    mpf.mita_paged_finalize_fused(*fargs(b), window=w, k_width=k)
    torch.cuda.synchronize()
    return a, b


def _assert_finalize(st, a, b, dd, dtype, near_ties=False):
    """Floats within TOL, expert rows and validity exact, slots not due
    bit-identical.  ``near_ties``: another summation order may swap two
    positions whose scores lie within float32 rounding of each other, so
    an expert row may differ where the gap of its two picks' scores
    (float64, from the plain version's landmark query) is at most
    2 (d + 1) 2^-24 sum|k q| / sqrt(d), twice the most a float32 dot
    product in any order, then the divide, can err by; nowhere else."""
    tol = TOL[dtype]
    for f in ("lm_q", "lm_v", "q_sum"):
        torch.testing.assert_close(getattr(b, f).float(),
                                   getattr(a, f).float(), atol=tol, rtol=tol)
    if near_ties:
        s_, h_, m_, r_ = (b.expert_idx != a.expert_idx).nonzero().T
        q = a.lm_q[s_, h_, m_].double()
        terms = [a.k_pool[x[s_, h_, m_, r_].long(), h_].double() * q
                 for x in (a.expert_idx, b.expert_idx)]
        d = q.shape[-1]
        gap = (terms[0].sum(-1) - terms[1].sum(-1)).abs() / d ** 0.5
        mag = torch.maximum(*(t.abs().sum(-1) for t in terms)) / d ** 0.5
        assert torch.all(gap <= 2 * (d + 1) * 2.0 ** -24 * mag), gap.max()
    else:
        assert torch.equal(b.expert_idx, a.expert_idx)
    assert torch.equal(b.expert_valid, a.expert_valid)
    for f in FIN_FIELDS:
        assert torch.equal(getattr(b, f)[~dd], getattr(st, f)[~dd]), f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128])
def test_finalize_kernel_exact_ties_across_splits(cuda_device, dtype, d):
    """Integer keys from three distinct rows per head and integer landmark
    queries: every score is exact and each tie group spans several splits
    (pages).  The picks are the first-index top-K, as the plain version's,
    at the scalar (d = 16) and the vectorised (d = 128) instance."""
    w, k = 16, 16
    st, pt, _, _, _ = _state(13, dtype, cuda_device, m_slot=6, d=d, w=w,
                             k=k)
    rng = np.random.default_rng(14)
    base = torch.from_numpy(rng.integers(-3, 4, (3, 2, d)).astype(
        np.float32)).to(cuda_device)
    pick = torch.from_numpy(rng.integers(0, 3, st.k_pool.shape[0])).to(
        cuda_device)
    st.k_pool.copy_(base[pick])
    st.q_sum.copy_(torch.from_numpy(rng.integers(
        -3, 4, st.q_sum.shape).astype(np.float32) * w))
    td = torch.tensor([96, 64, 48, 32], dtype=torch.int32, device=cuda_device)
    dd = torch.ones(4, dtype=torch.bool, device=cuda_device)
    a, b = _finalize_both(st, pt, td, dd, dtype, w, k)
    _assert_finalize(st, a, b, dd, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", [True, False])
def test_finalize_kernel_long_context(cuda_device, dtype, grid):
    """4096 positions of context (several passes of the sort buffer) at
    the serving head dim: ragged t_new, slots not due, a due slot with
    fewer than K visible positions and a full one.  ``grid``: keys and
    landmark queries lie on a grid of 1/4, so every score is exact in any
    summation order and the picks must equal the plain version's; else
    they are real-valued and a pick may differ at a near tie only."""
    w, k, m_slot, s_n = 128, 128, 32, 6
    st, pt, _, _, _ = _state(15, dtype, cuda_device, s_n=s_n, m_slot=m_slot,
                             d=128, w=w, k=k)
    if grid:
        st.k_pool.copy_((st.k_pool.float() * 4).round() / 4)
        st.q_sum.copy_((st.q_sum * 4).round() * w / 4)
    else:
        st.q_sum.mul_(w)             # landmark queries of unit scale
    td = torch.tensor([100, 4096, 3000, 1100, 2048, 777], dtype=torch.int32,
                      device=cuda_device)
    dd = torch.tensor([True, True, True, False, True, False],
                      device=cuda_device)
    a, b = _finalize_both(st, pt, td, dd, dtype, w, k)
    _assert_finalize(st, a, b, dd, dtype, near_ties=not grid)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_new,k", [
    ((0, 5, 40, 16), 8),      # nvis = 0, ordinal < 0, ordinal >= M, one
    ((16, 24, 32, 8), 24),    # K > nvis: masked lanes in index order
])
def test_finalize_kernel_edge_contexts(cuda_device, dtype, t_new, k):
    """Due slots that commit nothing (no visible position, or an ordinal
    outside [0, M)) only zero their q_sum, as the plain version and the
    JAX reference do; with K above the visible context the masked lanes
    follow the picks in index order, invalid."""
    st, pt, _, _, _ = _state(17, dtype, cuda_device, k=k)
    td = torch.tensor(t_new, dtype=torch.int32, device=cuda_device)
    dd = torch.ones(4, dtype=torch.bool, device=cuda_device)
    a, b = _finalize_both(st, pt, td, dd, dtype, W, k)
    _assert_finalize(st, a, b, dd, dtype)
    assert torch.all(b.q_sum == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [600, 2100])
def test_finalize_kernel_large_k(cuda_device, k):
    """K above the default sort buffer: a larger buffer in shared memory
    (K = 600) or in global memory (K = 2100)."""
    dtype, w = torch.float32, 1024
    st, pt, _, _, _ = _state(19, dtype, cuda_device, s_n=2, m_slot=4, w=w,
                             k=k)
    td = torch.tensor([4096, 3 * w], dtype=torch.int32, device=cuda_device)
    dd = torch.ones(2, dtype=torch.bool, device=cuda_device)
    a, b = _finalize_both(st, pt, td, dd, dtype, w, k)
    _assert_finalize(st, a, b, dd, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finalize_kernel_batch_invariance(cuda_device, dtype):
    """A slot's five outputs are bit-identical whether it is finalized
    alone or among 31 other due slots: the split plan depends on the
    shapes only."""
    w = k = 128
    s_n, m_slot = 32, 6
    st, pt, _, _, _ = _state(21, dtype, cuda_device, s_n=s_n, m_slot=m_slot,
                             d=128, w=w, k=k)
    rng = np.random.default_rng(22)
    td = torch.from_numpy(rng.integers(1, m_slot + 1, s_n).astype(
        np.int32) * w).to(cuda_device)
    dd = torch.ones(s_n, dtype=torch.bool, device=cuda_device)
    full = _clone(st)
    mpf.mita_paged_finalize_fused(
        full.q_sum, full.lm_q, full.lm_v, full.expert_idx, full.expert_valid,
        full.k_pool, full.v_pool, pt, td, dd, window=w, k_width=k)
    state = ("q_sum", "lm_q", "lm_v", "expert_idx", "expert_valid")
    for i in (0, 13, 31):
        sl = slice(i, i + 1)
        alone = [getattr(st, f)[sl].clone() for f in state]
        mpf.mita_paged_finalize_fused(
            *alone, st.k_pool, st.v_pool, pt[sl], td[sl], dd[sl],
            window=w, k_width=k)
        torch.cuda.synchronize()
        for f, x in zip(state, alone):
            assert torch.equal(x, getattr(full, f)[sl]), (i, f)


# rows of the chunk-prefill check: (t0, n_valid, n_train, active) -- a
# fresh chunk, a resumed chunk, the last chunk of a non-aligned prompt
# (n_train 20: m = 2, w' = 10), a recompute row (n_train < t0 + n_valid)
# and an inactive row
CHUNK_ROWS = [(0, 16, 32, True), (16, 16, 32, True), (16, 4, 20, True),
              (16, 16, 20, True), (0, 0, 1, False)]


def _chunk_inputs(dtype, dev, nc=16, m_slot=4, hkv=2, g=2, d=32, seed=3,
                  rows=CHUNK_ROWS, w=W, k=K, int_values=False):
    """Random row state over a shuffled page table.  ``int_values``: small
    integer queries, keys and values, the keys from three distinct rows
    per head, so scores tie exactly and are exact in any order."""
    rng = np.random.default_rng(seed)
    p_rows = len(rows)
    n_pages = p_rows * m_slot + 3
    table = rng.permutation(n_pages)[: p_rows * m_slot].reshape(
        p_rows, m_slot)

    def rnd(*shape, dt=dtype):
        x = rng.standard_normal(shape).astype(np.float32)
        if int_values:
            x = np.clip(np.round(x), -4, 4)
        return torch.from_numpy(x).to(dev, dt)

    st = [rnd(p_rows, hkv, m_slot, d), rnd(p_rows, hkv, m_slot, d),
          torch.from_numpy(table[:, None, :, None] * w + rng.integers(
              0, w, size=(p_rows, hkv, m_slot, k))).to(dev, torch.int32),
          torch.from_numpy(rng.random((p_rows, hkv, m_slot, k)) > 0.3).to(
              dev),
          rnd(p_rows, hkv, d, dt=torch.float32) * w,
          rnd(p_rows, hkv, m_slot, d), rnd(p_rows, hkv, d, dt=torch.float32)]
    pools = [rnd(n_pages * w + 1, hkv, d), rnd(n_pages * w + 1, hkv, d)]
    qkv = [rnd(p_rows, hkv, g, nc, d), rnd(p_rows, hkv, nc, d),
           rnd(p_rows, hkv, nc, d)]
    if int_values:      # three distinct key rows per head
        # the two landmark systems agree, as the engine keeps them
        st[5] = st[0].clone()
        base = rnd(3, hkv, d)
        pools[0] = base[torch.from_numpy(
            rng.integers(0, 3, n_pages * w + 1))].contiguous()
        qkv[1] = base[torch.from_numpy(rng.integers(
            0, 3, (p_rows, nc)))].transpose(1, 2).contiguous()
    t0, nv, ntr, act = zip(*rows)
    sched = (torch.from_numpy(table.astype(np.int32)).to(dev),
             *(torch.tensor(x, dtype=torch.int32, device=dev)
               for x in (t0, nv, ntr)), torch.tensor(act, device=dev))
    return tuple(qkv), st, tuple(pools), sched


def _chunk_vs_plain(dtype, inputs, rows, kw, state=None):
    """The kernel (through `ops`) against the plain version on float32
    copies; ``state`` replaces the kernel's state input (a control).
    Returns (kernel outputs, plain outputs, plain pools, kernel pools)."""
    (q, k, v), st, pools, sched = inputs
    ka, va = (x.float() for x in pools)
    ref = mcp.chunk_prefill_plain(
        q.float(), k.float(), v.float(),
        *[x.float() if x.is_floating_point() else x for x in st], ka, va,
        *sched, **kw, round_dtype=dtype)
    kb, vb = (x.clone() for x in pools)
    ops.reset_launch_counts()
    got = ops.batched_chunk_prefill(q, k, v, *(state or st), kb, vb, *sched,
                                    **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_chunk_prefill_fused"] == 1
    return got, ref, (ka, va), (kb, vb)


def _assert_chunk_matches(dtype, inputs, rows, got, ref, pools_ref,
                          pools_got):
    st = inputs[1]
    tol = TOL[dtype]
    for r, (_, nv, _, act) in enumerate(rows):
        if act:
            torch.testing.assert_close(got[0][r, :, :, :nv].float(),
                                       ref[0][r, :, :, :nv].float(),
                                       atol=tol, rtol=tol)
        else:
            assert torch.all(got[0][r] == 0)
    for a, b in zip(pools_ref, pools_got):
        assert torch.equal(a[:-1], b[:-1].float())
    for i, name in enumerate(("lm_q", "lm_v", "expert_idx", "expert_valid",
                              "q_sum", "pre_lm_q", "pre_q_sum")):
        a, b = ref[1 + i], got[1 + i]
        if name.startswith("expert"):
            assert torch.equal(a.int(), b.int()), name
        else:
            torch.testing.assert_close(b.float(), a.float(), atol=tol,
                                       rtol=tol, msg=name)
        for r, (_, _, _, act) in enumerate(rows):
            if not act:
                assert torch.equal(b[r].to(st[i].dtype), st[i][r]), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_route,external", [(1, True), (2, True),
                                              (1, False)])
def test_chunk_prefill_kernel_vs_plain(cuda_device, dtype, n_route,
                                       external):
    inputs = _chunk_inputs(dtype, cuda_device)
    kw = dict(window=W, k_width=K, n_route=n_route,
              external_finalize=external)
    got, ref, pools_ref, pools_got = _chunk_vs_plain(dtype, inputs,
                                                     CHUNK_ROWS, kw)
    _assert_chunk_matches(dtype, inputs, CHUNK_ROWS, got, ref, pools_ref,
                          pools_got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n_route,external,g", [(128, 1, True, 2),
                                                  (64, 2, True, 2),
                                                  (128, 1, False, 2),
                                                  (128, 2, True, 1),
                                                  (64, 1, True, 4)])
def test_chunk_prefill_head_dims_of_the_tensor_core_path(cuda_device, dtype,
                                                         d, n_route,
                                                         external, g):
    """Head dims 64 and 128, where bf16 runs the attend step on the tensor
    cores (float32 on the CUDA cores), and group sizes 1, 2 and 4 (64 / G
    positions per block), against the plain version."""
    inputs = _chunk_inputs(dtype, cuda_device, d=d, g=g,
                           seed=d + n_route + g)
    kw = dict(window=W, k_width=K, n_route=n_route,
              external_finalize=external)
    got, ref, pools_ref, pools_got = _chunk_vs_plain(dtype, inputs,
                                                     CHUNK_ROWS, kw)
    _assert_chunk_matches(dtype, inputs, CHUNK_ROWS, got, ref, pools_ref,
                          pools_got)
    assert mcp.chunk_path(dtype, d) == (
        mcp.TENSOR_CORES if dtype == torch.bfloat16 else mcp.CUDA_CORES)


# chunk-size invariance: (tokens, n_train) per row -- whole-window
# prompts, a prompt followed by generated tokens (the recompute shape) and
# a prompt of less than one chunk
INVARIANCE_ROWS = [(512, 512), (512, 384), (384, 384), (100, 100)]


def _chunked_prefill(dtype, dev, nc, w=16, hkv=2, g=2, d=128, seed=21):
    """Prefill INVARIANCE_ROWS from an empty state in chunks of ``nc``.
    Returns (outputs at every position, final state, pools)."""
    rng = np.random.default_rng(seed)
    p_rows, n_tok = len(INVARIANCE_ROWS), max(n for n, _ in INVARIANCE_ROWS)
    m_slot = n_tok // w
    n_pages = p_rows * m_slot + 2
    table = torch.from_numpy(rng.permutation(n_pages)[: p_rows * m_slot]
                             .reshape(p_rows, m_slot).astype(np.int32)).to(
                                 dev)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v = (rnd(p_rows, hkv, g, n_tok, d), rnd(p_rows, hkv, n_tok, d),
               rnd(p_rows, hkv, n_tok, d))
    pools = [torch.zeros((n_pages * w + 1, hkv, d), dtype=dtype, device=dev)
             for _ in range(2)]

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    st = [z(p_rows, hkv, m_slot, d), z(p_rows, hkv, m_slot, d),
          z(p_rows, hkv, m_slot, w, dt=torch.int32),
          z(p_rows, hkv, m_slot, w, dt=torch.bool),
          z(p_rows, hkv, d, dt=torch.float32), z(p_rows, hkv, m_slot, d),
          z(p_rows, hkv, d, dt=torch.float32)]
    outs = torch.zeros_like(q)
    ntr = torch.tensor([t for _, t in INVARIANCE_ROWS], dtype=torch.int32,
                       device=dev)
    for t0 in range(0, n_tok, nc):
        nv = torch.tensor([min(max(n - t0, 0), nc)
                           for n, _ in INVARIANCE_ROWS], dtype=torch.int32,
                          device=dev)
        out, *st = ops.batched_chunk_prefill(
            q[:, :, :, t0:t0 + nc], k[:, :, t0:t0 + nc], v[:, :, t0:t0 + nc],
            *st, *pools, table, torch.full_like(nv, t0), nv, ntr, nv > 0,
            window=w, k_width=w, n_route=1, external_finalize=True)
        outs[:, :, :, t0:t0 + nc] = out
    torch.cuda.synchronize()
    return outs, st, pools


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_prefill_chunk_size_invariance(cuda_device, dtype):
    """Chunks of 128 and of 256 give every position's output, the final
    state and the pools bit for bit: a position's bits depend only on its
    own inputs, not on nc, t0 or the other positions of its tile."""
    a = _chunked_prefill(dtype, cuda_device, 128)
    b = _chunked_prefill(dtype, cuda_device, 256)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_prefill_ties_pick_the_first_index(cuda_device, dtype):
    """Exact ties (integer queries and keys, three distinct key rows per
    head) at contexts of 1024 and 2048 positions, beyond one pass of the
    kernel's sort buffer (1024 - K new keys), so the slices' top-K lists
    are merged: the expert rows equal the plain version's first-index
    top-K."""
    rows = [(1792, 256, 2048, True), (768, 256, 1024, True)]
    w = k = 128
    inputs = _chunk_inputs(dtype, cuda_device, nc=256, m_slot=16, d=64,
                           rows=rows, w=w, k=k, int_values=True)
    kw = dict(window=w, k_width=k, n_route=1, external_finalize=True)
    got, ref, pools_ref, pools_got = _chunk_vs_plain(dtype, inputs, rows, kw)
    _assert_chunk_matches(dtype, inputs, rows, got, ref, pools_ref,
                          pools_got)
    # the sort buffer's slices were merged: contexts past 1024 - K
    assert max(t0 + nv for t0, nv, _, _ in rows) > mcp.SORT_N - k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_tolerance_detects_a_dropped_tile(cuda_device, dtype):
    """The control of the chunk check: the kernel run with keys 64..127 of
    one routed expert made invalid (landmark 0 of row 0, in the state that
    its generated positions route to) lies outside the tolerance of the
    plain version on the full state, while the whole run lies inside it."""
    rows = [(256, 256, 300, True), (0, 256, 320, True)]
    w = k = 128
    inputs = _chunk_inputs(dtype, cuda_device, nc=256, m_slot=6, d=128,
                           rows=rows, w=w, k=k)
    kw = dict(window=w, k_width=k, n_route=1, external_finalize=True)
    got, ref, pools_ref, pools_got = _chunk_vs_plain(dtype, inputs, rows, kw)
    _assert_chunk_matches(dtype, inputs, rows, got, ref, pools_ref,
                          pools_got)
    st = list(inputs[1])
    st[3] = st[3].clone()
    st[3][0, :, 0, 64:128] = False
    dropped, ref, _, _ = _chunk_vs_plain(dtype, inputs, rows, kw, state=st)
    tol = TOL[dtype]
    a, b = dropped[0][0].float(), ref[0][0].float()
    assert (a - b).abs().max().item() > tol
    assert not torch.allclose(a, b, atol=tol, rtol=tol)


# ------------------------------------------------ routed-expert attention --

def _expert_inputs(dtype, dev, ns, kw, shuffle=False, b=1, hkv=2, g=2, d=32,
                   m=6, seed=7):
    """Sorted sub-queries of a GQA group with a broadcast-1 KV lead; the
    last 70 rows are inactive (id m), so the last tile of 64 is all
    inactive."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    a = np.sort(rng.integers(0, m, (b, hkv, g, ns)), -1)
    a[..., ns - 70:] = m
    if shuffle:
        a = rng.permuted(a, axis=-1)
    valid = rng.random((b, hkv, 1, m, kw)) < 0.85
    return (rnd(b, hkv, g, ns, d),
            torch.from_numpy(a.astype(np.int32)).to(dev),
            rnd(b, hkv, 1, m, kw, d), rnd(b, hkv, 1, m, kw, d),
            torch.from_numpy(valid).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns,kw,shuffle", [(256, 128, False),
                                           (203, 40, False),
                                           (256, 64, True)])
def test_expert_kernel_vs_plain(cuda_device, dtype, ns, kw, shuffle):
    """Ragged NS, a key width that is not a tile multiple, the broadcast KV
    lead, an all-inactive tile and (shuffled) an unsorted assignment: the
    kernel matches its plain version, inactive rows exactly empty."""
    args = _expert_inputs(dtype, cuda_device, ns, kw, shuffle)
    ref = mea.expert_attention_plain(*args)
    ops.reset_launch_counts()
    got = ops.routed_expert_partial(*args, block_q=32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_expert_attention"] == 1
    tol = TOL[dtype]
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for x, y in zip(got, ref):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
    inactive = args[1] >= 6
    assert torch.all(got[0][inactive] == 0)
    assert torch.all(got[2][inactive] == 0)
    assert torch.all(got[1][inactive] == torch.finfo(torch.float32).min)


def _normalised(o, m, l):
    """(o / l, m) on the active rows and l: the comparison of the JAX
    kernel tests (o is rounded to the input dtype before l divides it)."""
    act = l > 0
    return ((o.float() / l.clamp(min=1e-30)[..., None])[act], m[act], l)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ns,kw", [(128, 512, 128), (128, 203, 200),
                                     (64, 256, 40)])
def test_expert_kernel_head_dims_of_the_tensor_core_path(cuda_device, dtype,
                                                         d, ns, kw):
    """Head dims 64 and 128, where bf16 runs on the tensor cores (P rounded
    to bf16 before the value product, as the plain version does on
    request), with ragged NS, a key width of two tiles and of a part of
    one: within the tolerance, inactive rows exactly empty."""
    args = _expert_inputs(dtype, cuda_device, ns, kw, d=d, m=8, seed=d + kw)
    tc = mea.expert_path(dtype, d) == mea.TENSOR_CORES
    assert tc == (dtype == torch.bfloat16)
    ref = mea.expert_attention_plain(*args, round_p=tc)
    ops.reset_launch_counts()
    got = ops.routed_expert_partial(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_expert_attention"] == 1
    tol = TOL[dtype]
    for x, y in zip(_normalised(*got), _normalised(*ref)):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
    inactive = args[1] >= 8
    assert torch.all(got[0][inactive] == 0)
    assert torch.all(got[2][inactive] == 0)
    assert torch.all(got[1][inactive] == torch.finfo(torch.float32).min)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_rows_are_bit_invariant(cuda_device, dtype):
    """A row's (o, m, l) bits depend only on its own query, expert and
    keys: a shuffled assignment, a shift of the rows against the tiles,
    and new neighbours (the other rows' queries and experts redrawn) give
    the sorted run's bits after un-permuting."""
    q, a, ke, ve, valid = _expert_inputs(dtype, cuda_device, 512, 128,
                                         d=128, m=8, seed=3)
    base = mea.mita_expert_attention(q, a, ke, ve, valid)
    rng = np.random.default_rng(0)
    ns = q.shape[-2]
    for perm in (rng.permutation(ns), np.roll(np.arange(ns), 17)):
        p = torch.from_numpy(perm).to(cuda_device)
        inv = torch.argsort(p)
        got = mea.mita_expert_attention(q[..., p, :], a[..., p], ke, ve,
                                        valid)
        assert torch.equal(got[0][..., inv, :], base[0])
        assert torch.equal(got[1][..., inv], base[1])
        assert torch.equal(got[2][..., inv], base[2])
    keep = torch.arange(ns, device=cuda_device) % 2 == 0
    q2 = torch.where(keep[:, None], q, torch.randn_like(q.float()).to(dtype))
    a2 = torch.where(keep, a, torch.randint_like(a, 0, 9))
    a2, order = torch.sort(a2, dim=-1, stable=True)
    q2 = torch.gather(q2, -2, order[..., None].expand_as(q2))
    inv = torch.argsort(order, dim=-1)
    got = mea.mita_expert_attention(q2, a2, ke, ve, valid)
    for x, y in zip(got, base):
        x = torch.gather(x, x.dim() - 1 - (x.dim() == 5),
                         inv[..., None].expand_as(x) if x.dim() == 5
                         else inv)
        assert torch.equal(x[..., keep, :] if x.dim() == 5 else x[..., keep],
                           y[..., keep, :] if y.dim() == 5 else y[..., keep])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_tolerance_detects_a_dropped_tile(cuda_device, dtype):
    """The control of the expert check: the kernel run with keys 64..127
    of one expert made invalid lies outside the tolerance of the plain
    version on the rows that use that expert, while the whole run lies
    inside it."""
    q, a, ke, ve, valid = _expert_inputs(dtype, cuda_device, 512, 128,
                                         d=128, m=8, seed=5)
    tc = mea.expert_path(dtype, 128) == mea.TENSOR_CORES
    ref = _normalised(*mea.expert_attention_plain(q, a, ke, ve, valid,
                                                  round_p=tc))
    tol = TOL[dtype]
    for x, y in zip(_normalised(*mea.mita_expert_attention(q, a, ke, ve,
                                                           valid)), ref):
        torch.testing.assert_close(x, y, atol=tol, rtol=tol)
    dropped = valid.clone()
    dropped[..., 2, 64:128] = False
    o, m, l = mea.mita_expert_attention(q, a, ke, ve, dropped)
    ro, rm, rl = mea.expert_attention_plain(q, a, ke, ve, valid, round_p=tc)
    use = a == 2
    x = o.float()[use] / l[use][:, None]
    y = ro.float()[use] / rl[use][:, None]
    assert (x - y).abs().max().item() > tol
    assert not torch.allclose(x, y, atol=tol, rtol=tol)


def _bidir_expert_inputs(dtype, dev, b, h, ns, m, kw, d=64, seed=9):
    """Bidirectional routing as the ViT and whisper's encoder give it:
    every sub-query active (no inactive tail), about NS / m a expert,
    sorted; lead [B, H, 1] over a KV lead of the same shape (G = 1, no
    broadcast); every expert row valid (a top-k over N >= K keys)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    a = np.sort(rng.integers(0, m, (b, h, 1, ns)), -1).astype(np.int32)
    return (rnd(b, h, 1, ns, d), torch.from_numpy(a).to(dev),
            rnd(b, h, 1, m, kw, d), rnd(b, h, 1, m, kw, d),
            torch.ones((b, h, 1, m, kw), dtype=torch.bool, device=dev))


# (B, H, NS, m, K): the ViT-B/16 at 224^2 (K 49: no multiple of 16, under
# one 128-key tile) and at 512^2 (m 64, NS 1024), whisper-tiny's encoder
# (K 64, NS 1500)
BIDIR_SHAPES = [(2, 12, 196, 49, 49), (2, 12, 1024, 64, 49),
                (2, 6, 1500, 25, 64)]
BIDIR_IDS = ["vit_k49_ns196", "vit512_k49_ns1024", "whisper_k64_ns1500"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,ns,m,kw", BIDIR_SHAPES, ids=BIDIR_IDS)
def test_expert_kernel_bidirectional(cuda_device, dtype, b, h, ns, m, kw):
    """B.4 on bidirectional assignments at the vision shapes: within the
    tolerance of its plain version (bf16 at d 64 on the tensor cores, P
    rounded as the kernel rounds it), every row active and finite; with
    the next expert's values made 1e4 times larger, the rows of every
    other expert keep their bits (the key rows past K in a tile add
    nothing)."""
    args = _bidir_expert_inputs(dtype, cuda_device, b, h, ns, m, kw)
    tc = mea.expert_path(dtype, 64) == mea.TENSOR_CORES
    assert tc == (dtype == torch.bfloat16)
    ref = mea.expert_attention_plain(*args, round_p=tc)
    ops.reset_launch_counts()
    got = ops.routed_expert_partial(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_expert_attention"] == 1
    assert torch.all(got[2] > 0) and torch.isfinite(got[0].float()).all()
    tol = TOL[dtype]
    for x, y in zip(_normalised(*got), _normalised(*ref)):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
    q, a, ke, ve, valid = args
    loud = ve.clone()
    loud[..., 3, :, :] *= 1e4
    got2 = mea.mita_expert_attention(q, a, ke, loud, valid)
    other = a != 3
    assert torch.equal(got2[0][other], got[0][other])
    assert torch.equal(got2[2][other], got[2][other])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,ns,m,kw", BIDIR_SHAPES, ids=BIDIR_IDS)
def test_expert_tolerance_detects_dropped_keys_bidirectional(
        cuda_device, dtype, b, h, ns, m, kw):
    """The control at the vision shapes: keys 32..48 of expert 1 made
    invalid lie outside the tolerance of the plain version on the rows
    that use expert 1."""
    q, a, ke, ve, valid = _bidir_expert_inputs(dtype, cuda_device, b, h, ns,
                                               m, kw)
    tc = mea.expert_path(dtype, 64) == mea.TENSOR_CORES
    ro, _, rl = mea.expert_attention_plain(q, a, ke, ve, valid, round_p=tc)
    dropped = valid.clone()
    dropped[..., 1, 32:49] = False
    o, _, l = mea.mita_expert_attention(q, a, ke, ve, dropped)
    use = a == 1
    assert int(use.sum()) > 0
    x = o.float()[use] / l[use][:, None]
    y = ro.float()[use] / rl[use][:, None]
    tol = TOL[dtype]
    assert (x - y).abs().max().item() > tol
    assert not torch.allclose(x, y, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_expert_kernel_is_forward_only(cuda_device):
    q, a, ke, ve, valid = _expert_inputs(torch.float32, cuda_device, 128, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        mea.mita_expert_attention(q.requires_grad_(), a, ke, ve, valid)


def _hybrid_expert_inputs(dtype, dev, ns=1024, seed=11):
    """recurrentgemma-9b's routed branch: lead [1, 1, 16] over one KV head
    (a broadcast KV lead [1, 1, 1]), head dim 256, K = 128, m = ns // 128
    experts; causal routing (the first window's rows inactive), sorted."""
    rng = np.random.default_rng(seed)
    m = ns // 128
    vis = (np.arange(ns) + 1) // 128
    draw = rng.random((1, 1, 16, ns))
    a = np.where(vis > 0, (draw * vis).astype(np.int64), m)
    a = np.sort(a, -1).astype(np.int32)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    valid = rng.random((1, 1, 1, m, 128)) > 0.05
    return (rnd(1, 1, 16, ns, 256), torch.from_numpy(a).to(dev),
            rnd(1, 1, 1, m, 128, 256), rnd(1, 1, 1, m, 128, 256),
            torch.from_numpy(valid).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_head_dim_256(cuda_device, dtype):
    """Head dim 256 (recurrentgemma-9b), on the CUDA cores in both dtypes:
    within 1e-5 (float32) and 2e-2 (bf16, against the plain version with
    P rounded to bf16) of the plain version; one launch; inactive rows
    exactly empty."""
    args = _hybrid_expert_inputs(dtype, cuda_device)
    assert mea.expert_path(dtype, 256) == mea.CUDA_CORES
    ref = mea.expert_attention_plain(*args,
                                     round_p=dtype == torch.bfloat16)
    ops.reset_launch_counts()
    got = ops.routed_expert_partial(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_expert_attention"] == 1
    tol = TOL[dtype]
    for x, y in zip(_normalised(*got), _normalised(*ref)):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
    inactive = args[1] >= 8
    assert torch.all(got[0][inactive] == 0)
    assert torch.all(got[2][inactive] == 0)
    assert torch.all(got[1][inactive] == torch.finfo(torch.float32).min)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_head_dim_256_control_and_bit_invariance(cuda_device,
                                                               dtype):
    """At head dim 256: keys 64..127 of expert 1 dropped put the rows that
    use it outside the tolerance; shuffled rows give the sorted run's
    (o, m, l) bits after un-permuting."""
    q, a, ke, ve, valid = _hybrid_expert_inputs(dtype, cuda_device, seed=12)
    tol = TOL[dtype]
    ro, _, rl = mea.expert_attention_plain(q, a, ke, ve, valid,
                                           round_p=dtype == torch.bfloat16)
    dropped = valid.clone()
    dropped[..., 1, 64:128] = False
    o, _, l = mea.mita_expert_attention(q, a, ke, ve, dropped)
    use = a == 1
    x = o.float()[use] / l[use][:, None]
    y = ro.float()[use] / rl[use][:, None]
    assert (x - y).abs().max().item() > tol
    assert not torch.allclose(x, y, atol=tol, rtol=tol)
    base = mea.mita_expert_attention(q, a, ke, ve, valid)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        q.shape[-2])).to(cuda_device)
    inv = torch.argsort(perm)
    got = mea.mita_expert_attention(q[..., perm, :], a[..., perm], ke, ve,
                                    valid)
    assert torch.equal(got[0][..., inv, :], base[0])
    assert torch.equal(got[1][..., inv], base[1])
    assert torch.equal(got[2][..., inv], base[2])


# ------------------------------------------------- recurrent models on card --

def _to(tree, dev):
    from repro_torch.core import slotted
    return slotted.tree_map(lambda a: a.to(dev, copy=True), tree)


def _assert_near(a, b, tol=1e-4):
    from repro_torch.core import slotted
    for x, y in zip(slotted.tree_leaves(a), slotted.tree_leaves(b)):
        x = x.cpu()
        if x.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x.float(), y.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_step_and_chunk_on_the_card_vs_cpu(cuda_device, arch):
    """One chunk prefill (rows of 32, 20 and 0 valid tokens; the hybrid's
    attention caches close two windows) and one decode step of the smoke
    config, float32, on the card against the same functions on CPU
    copies, within 1e-4 (matrix products reduce in another order)."""
    from repro_torch.configs.registry import arch_params, get_arch
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import rglru as rg
    cfg = get_arch(arch, smoke=True).model
    params = arch_params(get_arch(arch, smoke=True),
                         torch.Generator().manual_seed(0), device="cpu")
    if arch == "mamba2-370m":
        states = m2.mamba_slot_states(cfg, 3, device="cpu")
        chunk, step = m2.mamba_prefill_chunk, m2.mamba_decode_step
    else:
        states = rg.rg_slot_states(cfg, 3, 64, device="cpu")
        chunk, step = rg.rg_prefill_chunk, rg.rg_slot_decode_step
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 32)).astype(
        np.int32))
    t0 = torch.zeros(3, dtype=torch.int32)
    nv = torch.tensor([32, 20, 0], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, 3).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda_device):
        p, st = _map_params(params, dev), _to(states, dev)
        lg, st = chunk(p, st, toks.to(dev), t0.to(dev), nv.to(dev), cfg)
        lg2, st = step(p, st, tok.to(dev), nv.to(dev), cfg)
        out[dev] = (lg, lg2, st)
    for a, b in zip(out[cuda_device], out["cpu"]):
        _assert_near(a, b)


def _map_params(tree, dev):
    if isinstance(tree, dict):
        return {k: _map_params(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------- flash attention --

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nk,d,causal", [(256, 256, 128, True),
                                           (256, 256, 64, False),
                                           (96, 96, 32, True),
                                           (128, 320, 32, True),
                                           (160, 96, 16, False)])
def test_flash_kernel_vs_plain(cuda_device, dtype, n, nk, d, causal):
    """Causal and full, ragged kernel tiles (96, 160), cross lengths."""
    g = torch.Generator(device=cuda_device).manual_seed(n + nk + d)
    q, k, v = (torch.randn((2, 3, x, d), generator=g, device=cuda_device)
               .to(dtype) for x in (n, nk, nk))
    ref = fa.flash_attention_plain(q, k, v, causal=causal, block_q=32,
                                   block_k=32)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    tol = TOL[dtype]
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="divide block size"):
        ops.flash_attention(q, k, v, causal=causal, block_q=n - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nk,d,causal", [(200, 200, 128, True),
                                           (200, 333, 64, True),
                                           (333, 200, 128, True),
                                           (333, 200, 64, False),
                                           (130, 70, 128, False),
                                           (1, 65, 128, True),
                                           (64, 1000, 128, False)])
def test_flash_kernel_tile_edges(cuda_device, dtype, n, nk, d, causal):
    """The tensor-core path (bf16, d 64 and 128) at lengths that are no
    multiple of its 128-row query tile or 64-key tile, cross lengths both
    ways; float32 takes the CUDA-core path at the same shapes."""
    g = torch.Generator(device=cuda_device).manual_seed(n * 7 + nk + d)
    q, k, v = (torch.randn((2, 3, x, d), generator=g, device=cuda_device)
               .to(dtype) for x in (n, nk, nk))
    ref = fa.flash_attention_plain(q, k, v, causal=causal, block_q=1,
                                   block_k=1)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, block_q=1, block_k=1)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert fa.flash_path(dtype, d) == (
        fa.TENSOR_CORES if dtype == torch.bfloat16 else fa.CUDA_CORES)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tolerance_detects_a_dropped_tile(cuda_device, dtype):
    """The control of the flash check: the kernel run with one key tile
    dropped lies outside the tolerance of the plain version, while the
    whole run lies inside it.  Dropped: the first tile (rows and keys from
    64 on, causal, so row i sees keys 64..i), and a middle tile (keys
    256..383 for the rows from 384 on: rows 256.. of a causal call over
    the kept keys)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn((1, 2, 512, 128), generator=g,
                           device=cuda_device).to(dtype) for _ in range(3))
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    got = ops.flash_attention(q, k, v, causal=True)
    first = ops.flash_attention(*(x[:, :, 64:].contiguous()
                                  for x in (q, k, v)), causal=True,
                                block_q=64, block_k=64)
    middle = ops.flash_attention(
        *(torch.cat([x[:, :, :256], x[:, :, 384:]], 2) for x in (q, k, v)),
        causal=True)[:, :, 256:]
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    for dropped, want in ((first, ref[:, :, 64:]), (middle, ref[:, :, 384:])):
        err = (dropped.float() - want.float()).abs().max().item()
        assert err > tol
        assert not torch.allclose(dropped.float(), want.float(), atol=tol,
                                  rtol=tol)


# ---------------------------------------------- sampler and speculation ---

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_on_the_card_vs_cpu(cuda_device, dtype):
    """Threefry words and the per-slot keys are exact on the card; gumbel
    within 4 float32 / 1 bfloat16 ulp of 1 + |g|; tempered tokens equal
    wherever the CPU's top-2 gap clears 2**-19 relative."""
    from repro_torch import prng
    from repro_torch.models.transformer import sample_tokens
    rng = np.random.default_rng(3)
    s, v = 4, 151936
    rid = rng.integers(0, 2 ** 31, s).astype(np.int32)
    idx = rng.integers(0, 4096, s).astype(np.int32)
    temp = np.asarray([0.8, 0.0, 1.3, 0.5], np.float32)
    key = prng.PRNGKey(7)
    keys = {dev: prng.fold_in(prng.fold_in(
        key.to(dev), torch.as_tensor(rid, device=dev)),
        torch.as_tensor(idx, device=dev)) for dev in ("cpu", cuda_device)}
    assert torch.equal(keys[cuda_device].cpu(), keys["cpu"])
    assert torch.equal(prng.random_bits(keys[cuda_device], 32, (v,)).cpu(),
                       prng.random_bits(keys["cpu"], 32, (v,)))
    g = {dev: prng.gumbel(k, (v,), dtype).float().cpu()
         for dev, k in keys.items()}
    tol = 2.0 ** -21 if dtype == torch.float32 else 2.0 ** -7
    assert ((g[cuda_device] - g["cpu"]).abs()
            / (1 + g["cpu"].abs())).max() <= tol
    lg = torch.from_numpy(rng.standard_normal((s, v)).astype(np.float32)
                          * 3).to(dtype)
    got = sample_tokens(lg.to(cuda_device), rid, idx, temp, key).cpu()
    want = sample_tokens(lg, rid, idx, temp, key)
    z = g["cpu"] + lg.float() / torch.from_numpy(np.maximum(temp, 1e-6))[
        :, None]
    top2 = torch.topk(z.double(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2.0 ** -19 * (1 + top2[:, 0].abs())
    assert torch.equal(got[clear], want[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("finalize", ["external", "inline"])
def test_speculative_streams_equal_plain_decode_on_the_card(
        cuda_device, finalize, temperature):
    """spec_k = 3 streams equal spec_k = 0 streams through the card's
    kernels (smoke widths, float32, chunked prefill, fused sampling)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    cfg = get_arch("qwen3-0.6b", smoke=True).model
    w = cfg.attn.window
    params = tfm.lm_init(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg, cuda_device)
    specs = [(w, 5), (2 * w, 9), (2 * w, 4), (w, 20)]
    out = {}
    for k in (0, 3):
        eng = ServingEngine(params, cfg, EngineConfig(
            n_slots=3, pages_per_slot=4, n_pages=24, prefill_chunk=w,
            sample_device="fused", finalize=finalize, spec_k=k),
            device=cuda_device)
        rng = np.random.default_rng(5)
        done = eng.run([Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new_tokens=g,
            temperature=temperature) for i, (n, g) in enumerate(specs)])
        out[k] = {f.rid: f.tokens.tolist() for f in done}
    assert out[3] == out[0]
    assert eng.stats()["spec_drafted"] > 0


# the dense configs with head dim 64: tinyllama-1.1b (Hkv 4, G 8) and
# stablelm-1.6b (Hkv 32, G 1)
D64_HEADS = [(4, 8), (32, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g", D64_HEADS)
def test_paged_kernels_at_head_dim_64(cuda_device, dtype, hkv, g):
    """B.1 and B.2 at the dense configs' head shapes (d 64, G 8 / G 1,
    w = K = 128, M = 6): ragged t, an inactive slot and a non-due slot
    against the plain versions, pools and expert rows exact."""
    _paged_kernels_at(cuda_device, dtype, hkv, g, 64)


def _paged_kernels_at(cuda_device, dtype, hkv, g, d):
    w = 128
    st, pt, q, kn, vn = _state(21 + g, dtype, cuda_device, s_n=4, m_slot=6,
                               hkv=hkv, d=d, g=g, w=w, k=w)
    t = torch.tensor([130, 300, 0, 767], dtype=torch.int32,
                     device=cuda_device)
    act = torch.tensor([True, True, False, True], device=cuda_device)
    a, b = _clone(st, torch.float32), _clone(st)
    args = lambda s, x: (x(q), x(kn), x(vn), s.lm_q,  # noqa: E731
                         s.lm_v, s.expert_idx, s.expert_valid, s.k_pool,
                         s.v_pool, pt, t, act, t // w)
    ref = mpa.paged_attention_plain(*args(a, lambda x: x.float()), window=w,
                                    n_route=1, fuse_append=True)
    ops.reset_launch_counts()
    out = ops.paged_decode_attend(*args(b, lambda x: x), window=w,
                                  n_route=1, fuse_append=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mita_paged_attention"] == 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(a.k_pool[:-1], b.k_pool[:-1].float())
    assert torch.equal(a.v_pool[:-1], b.v_pool[:-1].float())

    td = torch.tensor([256, 640, 300, 768], dtype=torch.int32,
                      device=cuda_device)
    dd = torch.tensor([True, True, False, True], device=cuda_device)
    a, b = _finalize_both(st, pt, td, dd, dtype, w, w)
    _assert_finalize(st, a, b, dd, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g", D64_HEADS)
def test_chunk_prefill_kernel_at_head_dim_64(cuda_device, dtype, hkv, g):
    """B.3 at the dense configs' head shapes (d 64, G 8 / G 1) against
    the plain version: outputs, pools, both landmark systems and the
    expert rows."""
    _chunk_kernel_at(cuda_device, dtype, hkv, g, 64)


def _chunk_kernel_at(cuda_device, dtype, hkv, g, d):
    inputs = _chunk_inputs(dtype, cuda_device, hkv=hkv, g=g, d=d,
                           seed=30 + g)
    kw = dict(window=W, k_width=K, n_route=1, external_finalize=True)
    got, ref, pools_ref, pools_got = _chunk_vs_plain(dtype, inputs,
                                                     CHUNK_ROWS, kw)
    _assert_chunk_matches(dtype, inputs, CHUNK_ROWS, got, ref, pools_ref,
                          pools_got)


# the MoE configs at head dim 128: deepseek-moe-16b (Hkv 16, G 1) and
# dbrx-132b (Hkv 8, G 6, the first group size that is not a power of two)
MOE_HEADS = [(16, 1), (8, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g", MOE_HEADS)
def test_paged_kernels_at_moe_head_shapes(cuda_device, dtype, hkv, g):
    """B.1 and B.2 at the MoE configs' head shapes (d 128, G 1 / G 6),
    as at head dim 64."""
    _paged_kernels_at(cuda_device, dtype, hkv, g, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g", MOE_HEADS)
def test_chunk_prefill_kernel_at_moe_head_shapes(cuda_device, dtype, hkv,
                                                 g):
    """B.3 at the MoE configs' head shapes (d 128, G 1 / G 6) against the
    plain version, as at head dim 64."""
    _chunk_kernel_at(cuda_device, dtype, hkv, g, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_on_the_card_vs_cpu(cuda_device, cf):
    """`moe_apply` of the smoke deepseek-moe-16b layer (8 experts top-2,
    one shared) on the card against the CPU, float32: the gate picks,
    queue slots and outputs agree; at capacity factor 1.25 tokens drop."""
    import dataclasses
    import math
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b", smoke=True).model,
                              moe_capacity_factor=cf)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((1, 1, cfg.d_model))
                          + 0.5 * rng.standard_normal((4, 64, cfg.d_model)))
                         .astype(np.float32))
    pc = _map_params(p, cuda_device)
    out_h, aux_h = moe.moe_apply(p, x, cfg)
    out_c, aux_c = moe.moe_apply(pc, x.to(cuda_device), cfg)
    g = math.gcd(x.shape[0] * x.shape[1], moe.MOE_GROUPS)
    rh = moe.route(p, x.reshape(g, -1, cfg.d_model), cfg)
    rc = moe.route(pc, x.to(cuda_device).reshape(g, -1, cfg.d_model), cfg)
    assert torch.equal(rh.gate_idx, rc.gate_idx.cpu())
    assert torch.equal(rh.slot, rc.slot.cpu())
    assert bool((rh.slot >= rh.cap).any()) == (cf == 1.25)
    torch.testing.assert_close(out_c.cpu(), out_h, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux_c.cpu(), aux_h, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_supervised_chaos_serve_on_the_card_vs_cpu(cuda_device):
    """A supervised chaos serve (qwen3-0.6b smoke size, float32, chunk 16,
    the serving CLI's chaos configuration at seed 0) gives the same tokens
    on the card as on the CPU with the same weights, and its injector
    fired on both."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import (ChaosBackend, ChaosConfig, EngineConfig,
                                   Request, ServingEngine, Supervisor)
    from repro_torch.serve.backends.mita import MiTABackend
    cfg = get_arch("qwen3-0.6b", smoke=True).model
    w = cfg.attn.window
    params = tfm.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=16,
                        prefill_chunk=w)
    chaos = ChaosConfig(seed=0, p_fault=0.2, transient_len=2,
                        p_slot_fault=0.3, alloc_spike_every=8,
                        alloc_spike_pages=2,
                        ops=("decode_step", "prefill_chunks", "prefill_chunk",
                             "prefill_group", "draft_steps"))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (2 * w, w, 2 * w, w)]
    out = {}
    for dev in ("cpu", cuda_device):
        p = _map_params(params, dev)
        cb = ChaosBackend(MiTABackend(p, cfg, ecfg, device=dev), chaos)
        sup = Supervisor(ServingEngine(p, cfg, ecfg, backend=cb))
        done = sup.run([Request(rid=i, prompt=x, max_new_tokens=12)
                        for i, x in enumerate(prompts)])
        assert cb.n_injected > 0
        assert [f.reason for f in done] == ["complete"] * len(prompts)
        out[dev] = {f.rid: f.tokens.tolist() for f in done}
    assert out[cuda_device] == out["cpu"]


# ---------------------------------------------------------------- training

def _train_setup(arch_id):
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig
    arch = get_arch(arch_id, smoke=True)
    fns = family_fns(arch)
    params = fns["init"](torch.Generator().manual_seed(0), "cpu")
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=64, global_batch=4)
    batches = [train_batch(arch, dcfg, i) for i in range(3)]
    return params, batches, fns["loss"], OptConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=10)


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "mamba2-370m"])
def test_train_step_card_vs_cpu(cuda_device, arch_id):
    """One float32 train step from the same parameters and batch: the loss
    within 1e-5, every gradient leaf (read from the first moment after one
    step, (1 - b1) x the clipped gradient) within 1e-4 of its max, no
    port kernel launched."""
    from repro_torch.launch.steps import train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    params, batches, loss_fn, opt = _train_setup(arch_id)
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        # a copy: the step updates its parameters in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        _, st, m = train_step(p, adamw_init(p), batches[0], loss_fn, opt)
        out[str(dev)] = (float(m["loss"]),
                         [x.cpu() for x in tree_leaves(st.mu)])
    assert sum(ops.launch_counts().values()) == 0
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5
    for a, b in zip(g_card, g_cpu):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_train_steps_are_deterministic_on_card(cuda_device):
    """Two runs of three train steps under the training driver's
    deterministic settings: parameters and both moments bit for bit."""
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import deterministic
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    params, batches, loss_fn, opt = _train_setup("qwen3-0.6b")
    runs = []
    with deterministic(cuda_device):
        for _ in range(2):
            p = tree_map(lambda t: t.to(cuda_device), params)
            st = adamw_init(p)
            for b in batches:
                p, st, _ = train_step(p, st, b, loss_fn, opt)
            runs.append([x.cpu() for t in (p, st.mu, st.nu)
                         for x in tree_leaves(t)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_one_rank_nccl_mesh_on_card(cuda_device):
    """The training CLI's mesh path on one card: a 1 x 1 mesh over a
    one-rank ``nccl`` group.  Two sharded train steps (parameters and
    moments as DTensors) equal `train_step` on plain tensors bit for bit;
    ``compressed_grad_mean`` over ``nccl`` returns, on one rank, the
    gradient quantized once, ``dequantize(quantize(g))``, and the residual
    ``g - q s`` rounded once (the reference's fused form), bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, train_step
    from repro_torch.launch.train import deterministic
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map
    from repro_torch.optim.compression import (compressed_grad_mean,
                                               dequantize_int8, quantize_int8)
    params, batches, loss_fn, opt = _train_setup("qwen3-0.6b")
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        cell = build_cell(get_arch("qwen3-0.6b", smoke=True),
                          ShapeSpec("t", "train", 64, 4), mesh, opt_cfg=opt)
        psh, osh, _ = cell.in_shardings

        def place(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None)

        with deterministic(cuda_device):
            p = tree_map(lambda t: t.to(cuda_device), params)
            st = adamw_init(p)
            # both steps update in place, and a one-rank placement may
            # share the storage of what it placed: the cell gets copies
            dp = tree_map(lambda t, pl: place(t.clone(), pl), p, psh)
            dst = AdamWState(
                mu=tree_map(lambda t, pl: place(t.clone(), pl), st.mu,
                            osh.mu),
                nu=tree_map(lambda t, pl: place(t.clone(), pl), st.nu,
                            osh.nu),
                step=place(st.step.clone(), osh.step))
            for b in batches[:2]:
                p, st, m = train_step(p, st, b, loss_fn, opt)
                dp, dst, dm = cell.fn(dp, dst, b)
                assert torch.equal(m["loss"], dm["loss"])
        for a, b in zip(tree_leaves(p), tree_leaves(dp)):
            assert torch.equal(a, b.full_tensor())

        g = {}
        map_with_path(lambda path, x: g.setdefault(path, x), st.mu)
        red, err = compressed_grad_mean(g)
        for k, x in g.items():
            q, s = quantize_int8(x)
            assert torch.equal(red[k], dequantize_int8(q, s))
            assert torch.equal(err[k], (x.double() - q.double() * s.double())
                               .float())
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_dryrun_flops_equal_a_card_step(cuda_device):
    """The dry run on the card (fake ``cuda`` tensors over a fake one-rank
    group): the smoke qwen3-0.6b train cell's FLOPs at 1 x 1 equal
    ``FlopCounterMode`` over one real `train_step` on the card at the same
    batch shape, and the trace launches no port kernel."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_map
    params, batches, loss_fn, opt = _train_setup("qwen3-0.6b")
    p = tree_map(lambda t: t.to(cuda_device), params)
    with FlopCounterMode(display=False) as fc:
        train_step(p, adamw_init(p), batches[0], loss_fn, opt)
    assert not dist.is_initialized()
    ops.reset_launch_counts()
    dr.join_fake_group(1)
    try:
        mesh = make_host_mesh(1, 1)
        assert dr.trace_device() == mesh.device_type == "cuda"
        counts = dr._measure(get_arch("qwen3-0.6b", smoke=True),
                             ShapeSpec("t", "train", 64, 4), mesh)
    finally:
        dist.destroy_process_group()
    assert counts.flops == fc.get_total_flops() > 0
    assert sum(ops.launch_counts().values()) == 0
