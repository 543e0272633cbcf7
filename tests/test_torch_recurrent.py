"""The port's recurrent models and the hybrid's per-slot attention caches
against the JAX reference, at the smoke sizes of mamba2-370m (2 layers,
d_model 128: 4 SSD heads of 64, state 128) and recurrentgemma-9b (6 layers
= 2 super-blocks, d_model 128, 4 heads over 1 KV head, head dim 32,
w = k = 16), float32, weights from the JAX init carried over by
`repro_torch.convert`, inputs from numpy seeds.

Tolerances (absolute and relative): 1e-4 on logits and states of whole
forwards and of chunks (the port's chunk-parallel SSD runs its inter-chunk
recurrence as a loop and the RG-LRU forward as a doubling scan, where the
reference runs ``associative_scan``: the same sums in another order, and
float32 matrix products reduce in another order on each side); 1e-5 on one
decode step.  The port's chunk prefill is held to the reference's
token-sequential ``*_prefill_chunk_seq`` (ROADMAP C.1: the reference's own
chunk-parallel path is not bit-identical to it).  Within the port, the
slot-position MiTA decode step gives every slot the bits of the B = 1 call
on its own cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import mita_decode as jdec
from repro.models import mamba2 as jm2
from repro.models import rglru as jrg
from repro.models import transformer as jtfm
from repro_torch.configs.registry import arch_params, get_arch as tget_arch
from repro_torch.convert import (decode_state_from_jax, full_state_from_jax,
                                 mamba_state_from_jax, params_from_jax,
                                 rg_state_from_jax, to_numpy)
from repro_torch.core import mita_decode as tdec
from repro_torch.core import slotted
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttfm

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
CAP = 64                                  # slot capacity: 4 windows of 16


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return jget_arch(arch, smoke=True).model, tget_arch(arch,
                                                         smoke=True).model


@pytest.fixture(scope="module")
def mamba():
    jc, tc = _cfgs("mamba2-370m")
    jp = jm2.mamba_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def hybrid():
    jc, tc = _cfgs("recurrentgemma-9b")
    jp = jrg.rg_init(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


def _tokens(shape, seed, vocab=251):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **tol)


def _assert_state(st_t, st_j, tol=TOL):
    """Every leaf: integer and bool leaves exact, floats within ``tol``."""
    for a, b in zip(slotted.tree_leaves(st_t),
                    jax.tree_util.tree_leaves(jax.device_get(st_j))):
        a, b = to_numpy(a), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_init_layout_matches_the_reference(arch, mamba, hybrid):
    """`arch_params` builds every leaf of the reference's tree with its
    shape and dtype (mamba2's w_in unpadded, [d, 2 d_in + 2 S + H]; the
    hybrid's stacked super-blocks)."""
    jc, tc, jp, _ = mamba if arch == "mamba2-370m" else hybrid
    own = arch_params(tget_arch(arch, smoke=True), torch.Generator()
                      .manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jp)):
        node = own
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).endswith(str(leaf.dtype))


def test_mamba_forward_and_loss(mamba):
    jc, tc, jp, tp = mamba
    toks = _tokens((2, 128), 0)
    jl, _ = jm2.mamba_forward(jp, jnp.asarray(toks), jc)
    tl, _ = tm2.mamba_forward(tp, torch.as_tensor(toks), tc)
    _close(tl, jl)
    batch = {"tokens": toks, "labels": _tokens((2, 128), 1)}
    _close(float(tm2.mamba_loss(tp, batch, tc)),
           float(jm2.mamba_loss(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc)))


def test_ssd_chunked_matches_the_reference():
    """The SSD kernel of the forward alone, several chunks (the chunk-state
    recurrence runs as a loop in the port)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256, 4, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 256, 4)))).astype(
        np.float32)
    a_log = rng.standard_normal(4).astype(np.float32) * 0.3
    b, c = (rng.standard_normal((2, 256, 16)).astype(np.float32)
            for _ in range(2))
    jy = jm2.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a_log, b, c)),
                         chunk=64)
    ty = tm2.ssd_chunked(*(torch.as_tensor(v) for v in (x, dt, a_log, b, c)),
                         chunk=64)
    _close(ty, jy)


def test_mamba_decode_step_and_commit_mask(mamba):
    """Three decode steps from random states; the third with one slot out
    of ``commit``, whose state must keep its bits."""
    jc, tc, jp, tp = mamba
    rng = np.random.default_rng(5)
    js = jm2.mamba_slot_states(jc, 3)
    js = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.5), js)
    ts = mamba_state_from_jax(jax.device_get(js))
    for i in range(3):
        tok = _tokens((3,), 10 + i)
        jl, js_new = jm2.mamba_decode_step(jp, js, jnp.asarray(tok),
                                           jnp.zeros(3, jnp.int32), jc)
        commit = np.array([True, i < 2, True])
        js = jax.tree.map(
            lambda n, o: jnp.where(commit.reshape((1, 3) + (1,) * (
                n.ndim - 2)), n, o), js_new, js)
        before = to_numpy(ts)
        tl, ts = tm2.mamba_decode_step(tp, ts, torch.as_tensor(tok),
                                       torch.zeros(3), tc,
                                       commit=torch.as_tensor(commit))
        _close(tl, jl, STEP_TOL)
        _assert_state(ts, js, STEP_TOL)
    after = to_numpy(ts)
    np.testing.assert_array_equal(after.h[:, 1], before.h[:, 1])
    np.testing.assert_array_equal(after.conv[:, 1], before.conv[:, 1])


def _chunks(nc=16):
    """Two chunks for three rows: (tokens, t0, n_valid) each; row 2 is
    idle in the first chunk."""
    nv1 = np.array([16, 9, 0], np.int32)
    nv2 = np.array([7, 16, 12], np.int32)
    return [(_tokens((3, nc), 20), np.zeros(3, np.int32), nv1),
            (_tokens((3, nc), 21), nv1, nv2)]


@pytest.mark.parametrize("seq", [False, True])
def test_mamba_prefill_chunk_vs_reference_seq(mamba, seq):
    """The port's chunk-parallel prefill (and its `_seq` form) against the
    reference's token-sequential `mamba_prefill_chunk_seq`, two chunks;
    an idle row (n_valid 0) keeps its state bit for bit."""
    jc, tc, jp, tp = mamba
    js = jm2.mamba_slot_states(jc, 3)
    ts = mamba_state_from_jax(jax.device_get(js))
    fn = tm2.mamba_prefill_chunk_seq if seq else tm2.mamba_prefill_chunk
    for i, (toks, t0, nv) in enumerate(_chunks()):
        jl, js = jm2.mamba_prefill_chunk_seq(
            jp, js, jnp.asarray(toks), jnp.asarray(t0), jnp.asarray(nv), jc)
        before = to_numpy(ts)
        tl, ts = fn(tp, ts, torch.as_tensor(toks), torch.as_tensor(t0),
                    torch.as_tensor(nv), tc)
        live = nv > 0
        _close(to_numpy(tl)[live], np.asarray(jl)[live])
        _assert_state(ts, js)
        if i == 0:
            np.testing.assert_array_equal(to_numpy(ts).h[:, 2],
                                          before.h[:, 2])


def test_rglru_forward_and_loss(hybrid):
    jc, tc, jp, tp = hybrid
    toks = _tokens((2, 64), 2)
    jl, _ = jrg.rg_forward(jp, jnp.asarray(toks), jc)
    tl, _ = trg.rg_forward(tp, torch.as_tensor(toks), tc)
    _close(tl, jl)
    batch = {"tokens": toks, "labels": _tokens((2, 64), 3)}
    _close(float(trg.rg_loss(tp, batch, tc)),
           float(jrg.rg_loss(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, jc)))


def test_rglru_doubling_scan_matches_a_sequential_scan():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((2, 37, 5)).astype(np.float32))
    h, ref = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    torch.testing.assert_close(trg._doubling_scan(a, b),
                               torch.stack(ref, 1), atol=1e-5, rtol=1e-5)


def test_rglru_slot_decode_step(hybrid):
    """Decode steps at per-slot positions (slots 13, 14 and 30 tokens in:
    windows close at 15 and 31 during the steps), from states built by the
    reference's own prefill."""
    jc, tc, jp, tp = hybrid
    js = jrg.rg_slot_states(jc, 3, CAP)
    t0 = np.array([0, 0, 0], np.int32)
    nv = np.array([13, 14, 30], np.int32)
    _, js = jrg.rg_prefill_chunk_seq(jp, js, jnp.asarray(_tokens((3, 32), 7)),
                                     jnp.asarray(t0), jnp.asarray(nv), jc)
    ts = rg_state_from_jax(jax.device_get(js))
    pos = nv.copy()
    for i in range(3):
        tok = _tokens((3,), 30 + i)
        jl, js = jrg.rg_slot_decode_step(jp, js, jnp.asarray(tok),
                                         jnp.asarray(pos), jc)
        tl, ts = trg.rg_slot_decode_step(tp, ts, torch.as_tensor(tok),
                                         torch.as_tensor(pos), tc)
        _close(tl, jl, TOL)
        _assert_state(ts, js)
        pos = pos + 1


@pytest.mark.parametrize("seq", [False, True])
def test_rglru_prefill_chunk_vs_reference_seq(hybrid, seq):
    """The port's chunk prefill (bulk RG-LRU layers, per-token attention
    step) and its `_seq` form against the reference's `rg_prefill_chunk_seq`
    over two chunks that close windows; attention caches, expert rows and
    per-slot ``t`` included."""
    jc, tc, jp, tp = hybrid
    js = jrg.rg_slot_states(jc, 3, CAP)
    ts = rg_state_from_jax(jax.device_get(js))
    fn = trg.rg_prefill_chunk_seq if seq else trg.rg_prefill_chunk
    for toks, t0, nv in _chunks():
        jl, js = jrg.rg_prefill_chunk_seq(
            jp, js, jnp.asarray(toks), jnp.asarray(t0), jnp.asarray(nv), jc)
        tl, ts = fn(tp, ts, torch.as_tensor(toks), torch.as_tensor(t0),
                    torch.as_tensor(nv), tc)
        _close(to_numpy(tl)[nv > 0], np.asarray(jl)[nv > 0])
        _assert_state(ts, js)


# ------------------------------------------------ attention caches per slot --

def _mita_slot_state(seed, s_n=4, hkv=1, d=32, cap=CAP, w=16, k=16):
    """A random slot-form MiTA cache (leaves [S, 1, ...]) whose slots sit at
    t = 15 (closes a window), 20, 31 (closes one) and 63 (the capacity's
    last row): random keys, landmarks, expert rows and query sums."""
    rng = np.random.default_rng(seed)
    cfg = tdec.DecodeConfig(window=w, k=k, s=1)
    st = tdec.init_decode_state(s_n, hkv, d, cap, cfg, dtype=torch.float32)
    st = type(st)(*(x[:, None].clone() for x in st[:-1]),
                  torch.tensor([15, 20, 31, 63][:s_n], dtype=torch.int32))
    for x in (st.k_cache, st.v_cache, st.lm_q, st.lm_v, st.q_sum):
        x.copy_(torch.as_tensor(rng.standard_normal(x.shape).astype(
            np.float32)))
    st.expert_idx.copy_(torch.as_tensor(
        rng.integers(0, 16, st.expert_idx.shape).astype(np.int32)))
    st.expert_valid.copy_(torch.as_tensor(rng.random(
        st.expert_valid.shape) > 0.2))
    return st, cfg


def _slot(st, i):
    """Slot i of a slot-form cache as a B == 1 cache with a scalar t."""
    return type(st)(*(x[i].clone() for x in st[:-1]), st.t[i].clone())


@pytest.mark.parametrize("g", [1, 4])
def test_slot_decode_gives_each_slot_the_bits_of_the_b1_call(g):
    """`mita_decode_step_slots` against `mita_decode_step` on each slot's
    own B == 1 cache: output, caches, landmarks, expert rows, query sums
    and t equal bit for bit, in the windows that close (inline finalize)
    and those that do not; a slot outside ``commit`` keeps its bits."""
    st, cfg = _mita_slot_state(0)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((4, 1, g, 32)).astype(np.float32))
    kn, vn = (torch.as_tensor(rng.standard_normal((4, 1, 32)).astype(
        np.float32)) for _ in range(2))
    singles = [_slot(st, i) for i in range(4)]
    frozen = _slot(st, 3)
    commit = torch.tensor([True, True, True, False])
    out, st = tdec.mita_decode_step_slots(st, q, kn, vn, cfg, commit)
    for i in range(3):
        o1, s1 = tdec.mita_decode_step(singles[i], q[i:i + 1], kn[i:i + 1],
                                       vn[i:i + 1], cfg)
        assert torch.equal(out[i:i + 1], o1)
        for a, b in zip(_slot(st, i), s1):
            assert torch.equal(a, b)
    for a, b in zip(_slot(st, 3), frozen):
        assert torch.equal(a, b)


def test_slot_decode_matches_the_reference_vmap():
    """The slot-position step against the reference's vmapped B == 1
    `mita_decode_step` (what `attention_decode_slots` runs)."""
    st, cfg = _mita_slot_state(2)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 1, 4, 32)).astype(np.float32)
    kn, vn = (rng.standard_normal((4, 1, 32)).astype(np.float32)
              for _ in range(2))
    jcfg = jdec.DecodeConfig(window=16, k=16, s=1)
    jst = jdec.MiTADecodeState(*(jnp.asarray(to_numpy(x)) for x in st))
    step = lambda s, qs, ks, vs: jdec.mita_decode_step(  # noqa: E731
        s, qs[None], ks[None], vs[None], jcfg)
    jo, jst = jax.vmap(step)(jst, jnp.asarray(q), jnp.asarray(kn),
                             jnp.asarray(vn))
    out, st = tdec.mita_decode_step_slots(st, torch.as_tensor(q),
                                          torch.as_tensor(kn),
                                          torch.as_tensor(vn), cfg)
    _close(out, np.asarray(jo)[:, 0], STEP_TOL)
    _assert_state(st, jst, STEP_TOL)


def test_full_decode_step_and_slot_form():
    """The full-attention baseline's cache: `full_prefill_state` then two
    `full_decode_step`s against the reference, and the slot form against
    the reference's vmap of the B == 1 step."""
    rng = np.random.default_rng(6)
    k, v = (rng.standard_normal((2, 1, 1, 10, 32)).astype(np.float32)
            for _ in range(2))
    js = jdec.full_prefill_state(jnp.asarray(k), jnp.asarray(v), 16)
    ts = tdec.full_prefill_state(torch.as_tensor(k), torch.as_tensor(v), 16)
    for i in range(2):
        q = rng.standard_normal((2, 1, 2, 32)).astype(np.float32)
        kn, vn = (rng.standard_normal((2, 1, 32)).astype(np.float32)
                  for _ in range(2))
        jo, js = jdec.full_decode_step(js, jnp.asarray(q), jnp.asarray(kn),
                                       jnp.asarray(vn))
        to, ts = tdec.full_decode_step(ts, torch.as_tensor(q),
                                       torch.as_tensor(kn),
                                       torch.as_tensor(vn))
        _close(to, jo, STEP_TOL)
        _assert_state(ts, js, STEP_TOL)
    slot = jax.tree.map(lambda a: a[:, None] if a.ndim else a, js)
    slot = slot._replace(t=jnp.asarray([12, 3], jnp.int32))
    q = rng.standard_normal((2, 1, 2, 32)).astype(np.float32)
    kn, vn = (rng.standard_normal((2, 1, 32)).astype(np.float32)
              for _ in range(2))
    jo, jsl = jax.vmap(lambda s, a, b, c: jdec.full_decode_step(
        s, a[None], b[None], c[None]))(slot, jnp.asarray(q), jnp.asarray(kn),
                                       jnp.asarray(vn))
    tsl = full_state_from_jax(jax.device_get(slot))
    to, tsl = tdec.full_decode_step_slots(tsl, torch.as_tensor(q),
                                          torch.as_tensor(kn),
                                          torch.as_tensor(vn))
    _close(to, np.asarray(jo)[:, 0], STEP_TOL)
    _assert_state(tsl, jsl, STEP_TOL)


def test_init_slot_attn_state_layout():
    """Slot-form caches of the MiTA and the full-attention backends: the
    reference's leaf shapes and dtypes ([S, 1, ...], t [S])."""
    jc, tc = _cfgs("recurrentgemma-9b")
    for backend in ("mita", "local"):
        jcb = dataclasses.replace(jc, attn=dataclasses.replace(
            jc.attn, backend=backend, local_window=32))
        tcb = dataclasses.replace(tc, attn=dataclasses.replace(
            tc.attn, backend=backend, local_window=32))
        js = jtfm.init_slot_attn_state(jcb, 3, CAP)
        ts = ttfm.init_slot_attn_state(tcb, 3, CAP, device="cpu")
        for a, b in zip(slotted.tree_leaves(ts),
                        jax.tree_util.tree_leaves(js)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).endswith(str(b.dtype))


def test_decode_state_converter_round_trip():
    """`decode_state_from_jax` on a slot-form reference cache."""
    jc, _ = _cfgs("recurrentgemma-9b")
    js = jtfm.init_slot_attn_state(jc, 2, CAP)
    ts = decode_state_from_jax(jax.device_get(js))
    _assert_state(ts, js, STEP_TOL)
