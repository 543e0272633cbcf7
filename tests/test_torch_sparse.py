"""The port's full-sequence MiTA forward against the JAX reference (CPU):
the plain routed-expert kernel (B.4) and the plain flash kernel (B.5)
against the Pallas kernels in interpret mode and their ``ref.py`` oracles,
``mita_attention_sparse`` for every ``impl``, ``aux_load_balance``, the
attention backends and layouts of ``attention_apply``, and the slice as a
whole: the smoke qwen3-0.6b with ``impl="pallas"`` at prompt 128 (m = 8 >
expert_span 4).

The same numpy inputs go through both packages.  Tolerances: the kernel
sweeps use the JAX tests' own (float32 3e-5 on normalised o and on m,
bfloat16 3e-2; flash 2e-5 / 2e-2); every sparse forward 3e-5; the LM's
logits and loss 1e-5 (float32, two layers); greedy tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import mita as jmita
from repro.core import mita_sparse as jsparse
from repro.kernels import ops as jops
from repro.kernels.flash_attn import flash_attention as jflash
from repro.kernels.mita_expert_attn import mita_expert_attention as jexpert
from repro.kernels.ref import flash_attention_ref, mita_expert_attention_ref
from repro.launch.serve import static_generate as jstatic_generate
from repro.models import modules as jnn
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import mita as tmita
from repro_torch.core import mita_sparse as tsparse
from repro_torch.kernels import mita_expert_attn as tmea
from repro_torch.kernels import ops
from repro_torch.launch.serve import static_generate as tstatic_generate
from repro_torch.models import modules as tnn
from repro_torch.models import transformer as ttfm

SPARSE_TOL = dict(atol=3e-5, rtol=3e-5)
LM_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(x, dtype="float32"):
    """The same values as a JAX array and a torch tensor."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.ascontiguousarray(x)).to(td)


# ------------------------------------------------ B.4 routed-expert kernel --

def _expert_inputs(seed, b, h, ns, d, m, kw):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, ns, d)).astype(np.float32)
    assign = np.sort(rng.integers(0, m + 1, (b, h, ns)), -1).astype(np.int32)
    ke = rng.standard_normal((b, h, m, kw, d)).astype(np.float32)
    ve = rng.standard_normal((b, h, m, kw, d)).astype(np.float32)
    valid = rng.random((b, h, m, kw)) < 0.9
    return q, assign, ke, ve, valid


def _assert_partials(o, ms, l, oref, msref, lref, atol):
    """The JAX kernel test's comparison: the same active rows, normalised
    o and m on active rows."""
    o, ms, l, oref, msref, lref = map(_np, (o, ms, l, oref, msref, lref))
    act = l > 0
    np.testing.assert_array_equal(act, lref > 0)
    on = o / np.maximum(l[..., None], 1e-30)
    orn = oref / np.maximum(lref[..., None], 1e-30)
    np.testing.assert_allclose(on * act[..., None], orn * act[..., None],
                               atol=atol, rtol=atol)
    np.testing.assert_allclose(ms * act, msref * act, atol=atol, rtol=atol)


@pytest.mark.parametrize("b,h,ns,d,m,kw,bq", [
    (2, 2, 128, 32, 8, 16, 32),
    (1, 3, 256, 64, 16, 32, 64),
    (1, 1, 64, 16, 4, 8, 64),
    (1, 1, 128, 128, 2, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_plain_vs_pallas_and_ref(b, h, ns, d, m, kw, bq, dtype):
    """The plain B.4 against the Pallas kernel (interpret mode) and the
    oracle, on the sweep of tests/test_kernels.py."""
    q, assign, ke, ve, valid = _expert_inputs(ns * m, b, h, ns, d, m, kw)
    (jq, tq), (jke, tke), (jve, tve) = (_both(x, dtype) for x in (q, ke, ve))
    got = tmea.expert_attention_plain(tq, torch.from_numpy(assign), tke, tve,
                                      torch.from_numpy(valid), block_q=bq)
    assert got[0].dtype == tq.dtype and got[1].dtype == torch.float32
    kern = jexpert(jq, jnp.asarray(assign), jke, jve, jnp.asarray(valid),
                   block_q=bq, interpret=True)
    ref = mita_expert_attention_ref(
        jq.astype(jnp.float32), jnp.asarray(assign), jke.astype(jnp.float32),
        jve.astype(jnp.float32), jnp.asarray(valid))
    atol = 3e-5 if dtype == "float32" else 3e-2
    _assert_partials(*got, *kern, atol)
    _assert_partials(*got, *ref, atol)
    inactive = assign >= m
    assert np.all(_np(got[0])[inactive] == 0.0)
    assert np.all(_np(got[2])[inactive] == 0.0)
    assert np.all(_np(got[1])[inactive] == np.finfo(np.float32).min)


@pytest.mark.parametrize("ns", [64, 61])
def test_routed_expert_partial_broadcast_leads(ns):
    """`ops.routed_expert_partial` on the CPU takes the plain version (no
    launch counted) with a GQA broadcast-1 KV lead, ragged NS included,
    and matches the JAX wrapper, which materialises the G copies."""
    b, hkv, g, d, m, kw = 1, 2, 3, 16, 4, 8
    rng = np.random.default_rng(ns)
    q = rng.standard_normal((b, hkv, g, ns, d)).astype(np.float32)
    a = np.sort(rng.integers(0, m, (b, hkv, g, ns)), -1).astype(np.int32)
    ke = rng.standard_normal((b, hkv, 1, m, kw, d)).astype(np.float32)
    ve = rng.standard_normal((b, hkv, 1, m, kw, d)).astype(np.float32)
    valid = np.ones((b, hkv, 1, m, kw), bool)
    ref = jops.routed_expert_partial(*map(jnp.asarray, (q, a, ke, ve, valid)),
                                     block_q=32)
    ops.reset_launch_counts()
    got = ops.routed_expert_partial(*map(torch.from_numpy,
                                         (q, a, ke, ve, valid)), block_q=32)
    assert ops.launch_counts()["mita_expert_attention"] == 0
    for x, y in zip(got, ref):
        assert tuple(x.shape) == y.shape
    _assert_partials(*got, *ref, 3e-5)


@pytest.mark.parametrize("b,h,ns,d,m,kw", [
    (2, 2, 128, 32, 8, 16),
    (1, 1, 128, 128, 2, 64),
])
def test_expert_plain_bf16_weights_vs_ref(b, h, ns, d, m, kw):
    """``round_p=True`` (the tensor-core kernel's rounding: the softmax
    weights rounded to bf16 before the value product) against the oracle
    with bf16 values, which multiplies bf16 weights too: within the bf16
    tolerance, and not the same bits as the float32 weights."""
    q, assign, ke, ve, valid = _expert_inputs(ns + d, b, h, ns, d, m, kw)
    (jq, tq), (jke, tke), (jve, tve) = (_both(x, "bfloat16")
                                        for x in (q, ke, ve))
    args = (tq, torch.from_numpy(assign), tke, tve, torch.from_numpy(valid))
    got = tmea.expert_attention_plain(*args, round_p=True)
    ref = mita_expert_attention_ref(
        jq.astype(jnp.float32), jnp.asarray(assign), jke.astype(jnp.float32),
        jve, jnp.asarray(valid))
    _assert_partials(*got, *ref, 3e-2)
    assert not torch.equal(got[0], tmea.expert_attention_plain(*args)[0])


@pytest.mark.parametrize("lead,kv_lead", [
    ((1, 8, 2), (1, 8, 1)),      # qwen3-0.6b: one expert bank per KV head
    ((2, 4, 3), (2, 4, 1)),
    ((2, 4, 3), (1, 4, 1)),      # the batch broadcast too
    ((1, 8, 2), (8, 1)),         # a shorter KV lead
    ((3, 5), (1,)),              # one bank for every row
    ((16,), (16,)),
    ((1, 2, 3, 4, 5), (1, 2, 3, 4, 5)),
])
def test_kv_lead_strides_match_the_expand_map(lead, kv_lead):
    """The kernel's KV lead row of each query lead row, from the host's
    (dims, strides), is the old index map arange(kv_lead).expand(lead)."""
    dims, strides = tmea.kv_lead_strides(lead, kv_lead)
    n_kv = int(np.prod(kv_lead))
    want = torch.arange(n_kv).reshape(kv_lead).expand(lead).reshape(-1)
    got = []
    for i in range(int(np.prod(lead))):     # as the kernel walks the digits
        row, rest = 0, i
        for n, st in zip(reversed(dims), reversed(strides)):
            row += (rest % n) * st
            rest //= n
        got.append(row)
    assert got == want.tolist()
    assert len(dims) == len(strides) == 4


def test_kv_lead_strides_refuse_five_dims():
    with pytest.raises(ValueError, match="at most 4"):
        tmea.kv_lead_strides((2, 3, 4, 5, 6), (2, 1, 4, 1, 6))


def test_expert_path_is_forward_only():
    """The expert kernel has no backward in either package: the routed
    dispatch refuses inputs that require grad, and accepts them without
    grad mode."""
    q, assign, ke, ve, valid = _expert_inputs(3, 1, 2, 64, 16, 4, 8)
    tq = torch.from_numpy(q).requires_grad_()
    args = (tq, torch.from_numpy(assign), torch.from_numpy(ke),
            torch.from_numpy(ve), torch.from_numpy(valid))
    with pytest.raises(RuntimeError, match="forward only"):
        ops.routed_expert_partial(*args)
    with torch.no_grad():
        o, _, _ = ops.routed_expert_partial(*args)
    assert torch.isfinite(o).all()


# ------------------------------------------------- mita_attention_sparse --

def _sparse_pair(cfg_kw, q, k, v, q_lm=None, **call):
    jo = jsparse.mita_attention_sparse(
        *map(jnp.asarray, (q, k, v)), jmita.MiTAConfig(**cfg_kw),
        q_landmarks=None if q_lm is None else jnp.asarray(q_lm), **call)
    to = tsparse.mita_attention_sparse(
        *map(torch.from_numpy, (q, k, v)), tmita.MiTAConfig(**cfg_kw),
        q_landmarks=None if q_lm is None else torch.from_numpy(q_lm), **call)
    return _np(to), _np(jo)


def _qkv(seed, lead=(1, 2), n=128, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(lead + (n, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("impl", ["sorted", "capacity", "pallas"])
@pytest.mark.parametrize("causal,s", [(False, 1), (False, 2), (True, 1),
                                      (True, 2)])
def test_sparse_impls_vs_jax(impl, causal, s):
    q, k, v = _qkv(11)
    to, jo = _sparse_pair(dict(m=8, k=16, s=s, causal=causal), q, k, v,
                          impl=impl, block_q=32, expert_span=8,
                          capacity_factor=8.0)
    np.testing.assert_allclose(to, jo, **SPARSE_TOL)


@pytest.mark.parametrize("s", [1, 2])
def test_sparse_capacity_drops_vs_jax(s):
    """capacity_factor 1.0: overflowing sub-queries drop their routed
    branch, in the same queue order as the reference."""
    q, k, v = _qkv(12)
    to, jo = _sparse_pair(dict(m=8, k=16, s=s, causal=True), q, k, v,
                          impl="capacity", capacity_factor=1.0)
    np.testing.assert_allclose(to, jo, **SPARSE_TOL)


@pytest.mark.parametrize("impl", ["sorted", "capacity", "pallas"])
def test_sparse_gqa_group_landmarks(impl):
    rng = np.random.default_rng(13)
    b, hkv, g, n, d = 2, 2, 3, 64, 8
    q = rng.standard_normal((b, hkv, g, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, 1, n, d)).astype(np.float32)
            for _ in range(2))
    to, jo = _sparse_pair(dict(m=8, k=8, causal=True), q, k, v,
                          q_lm=q.mean(axis=2, keepdims=True), impl=impl,
                          block_q=32, expert_span=8, capacity_factor=8.0)
    np.testing.assert_allclose(to, jo, **SPARSE_TOL)


def _uneven():
    """Nearly every query routes to one expert (a sorted block then holds
    a single expert: the degenerate walk)."""
    rng = np.random.default_rng(14)
    b, h, n, d = 1, 2, 128, 16
    base = rng.standard_normal(d).astype(np.float32)
    q = base + 0.05 * rng.standard_normal((b, h, n, d)).astype(np.float32)
    q[..., :16, :] *= 5.0
    k = base + 0.05 * rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["k_past_window_end_s1",
                                  "k_past_window_end_s2", "route_per_group",
                                  "uneven_load", "ragged_ns"])
def test_pallas_oracle_cases(case):
    """The cases of tests/test_kernel_oracle.py for impl='pallas', against
    the same JAX call (and, for the skewed case, the skew is checked)."""
    q_lm = None
    if case.startswith("k_past_window_end"):
        q, k, v = _qkv(15)
        cfg = dict(m=8, k=32, s=int(case[-1]), causal=True)    # w 16 < k
    elif case == "route_per_group":
        rng = np.random.default_rng(16)
        q = rng.standard_normal((2, 2, 4, 128, 16)).astype(np.float32)
        k, v = (rng.standard_normal((2, 2, 1, 128, 16)).astype(np.float32)
                for _ in range(2))
        q_lm = q.mean(axis=2, keepdims=True)
        cfg = dict(m=8, k=16, causal=True, route_per_group=True)
    elif case == "uneven_load":
        q, k, v = _uneven()
        cfg = dict(m=8, k=16, s=1, causal=False)
    else:
        q, k, v = _qkv(17, n=120)        # N*s = 120, not a block multiple
        cfg = dict(m=8, k=16, s=1, causal=False)
    to, jo = _sparse_pair(cfg, q, k, v, q_lm=q_lm, impl="pallas", block_q=32)
    np.testing.assert_allclose(to, jo, **SPARSE_TOL)
    if case == "uneven_load":
        tq = torch.from_numpy(q)
        mcfg = tmita.MiTAConfig(**cfg)
        r = tmita.routing_logits(tq, tmita.extract_landmarks(tq, mcfg), mcfg)
        counts = np.bincount(tmita.argmax_first(r).numpy().ravel())
        assert counts.max() > 0.9 * r[..., 0].numel()
    if case == "ragged_ns":
        with pytest.raises(ValueError, match="block_q"):
            tsparse.mita_attention_sparse(
                *map(torch.from_numpy, (q, k, v)), tmita.MiTAConfig(**cfg),
                impl="sorted", block_q=32)


def test_pallas_all_invalid_early_rows():
    """Queries before the first window end have no routable expert: their
    routed partial is empty (l == 0, o == 0), as in the reference."""
    q, k, v = _qkv(18, n=64)
    cfg_kw = dict(m=8, k=16, s=1, causal=True)          # window 8 < k
    parts = []
    for mita, sparse, conv in ((jmita, jsparse, jnp.asarray),
                               (tmita, tsparse, torch.from_numpy)):
        cfg = mita.MiTAConfig(**cfg_kw)
        tq, tk, tv = map(conv, (q, k, v))
        q_lm = mita.extract_landmarks(tq, cfg)
        s_kv = mita.landmark_scores(tk, q_lm, cfg)
        r = mita.routing_logits(tq, q_lm, cfg)
        k_e, v_e, valid = mita.gather_topk(tk, tv, s_kv, cfg)
        parts.append(sparse._routed_sorted(tq, k_e, v_e, valid, r, cfg,
                                           block_q=32, expert_span=0))
    jp, tp = parts
    l = _np(tp.l)
    assert np.all(l[..., :7] == 0.0) and np.all(_np(tp.o)[..., :7, :] == 0)
    _assert_partials(tp.o, tp.m, tp.l, jp.o, jp.m, jp.l, 3e-5)


def test_pallas_block_q_invariance_and_env_default(monkeypatch):
    """The kernel path does not depend on block_q, and block_q = 0 in
    AttnConfig defers to REPRO_BLOCK_Q."""
    q, k, v = map(torch.from_numpy, _qkv(19))
    cfg = tmita.MiTAConfig(m=8, k=16, s=1, causal=True)
    ref = tsparse.mita_attention_sparse(q, k, v, cfg, impl="pallas",
                                        block_q=128)
    monkeypatch.setenv("REPRO_BLOCK_Q", "32")
    assert ops.default_block_q() == 32
    out = tsparse.mita_attention_sparse(q, k, v, cfg, impl="pallas",
                                        block_q=ops.default_block_q())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert (tnn.AttnConfig(block_q=0).block_q or ops.default_block_q()) == 32


def test_aux_load_balance_vs_jax():
    rng = np.random.default_rng(20)
    r = rng.standard_normal((2, 3, 64, 8)).astype(np.float32)
    r[0, 0, :5, 3:] = np.finfo(np.float32).min       # masked landmarks
    r[1, 2, :2] = np.finfo(np.float32).min            # a fully masked row
    jc, tc = jmita.MiTAConfig(m=8, k=8), tmita.MiTAConfig(m=8, k=8)
    jv = jsparse.aux_load_balance(jnp.asarray(r), jc)
    tv = tsparse.aux_load_balance(torch.from_numpy(r), tc)
    np.testing.assert_allclose(_np(tv), _np(jv), **LM_TOL)


def test_sparse_rejects_unknown_impl():
    q, k, v = map(torch.from_numpy, _qkv(21, n=64))
    with pytest.raises(ValueError, match="impl"):
        tsparse.mita_attention_sparse(q, k, v, tmita.MiTAConfig(m=4, k=8),
                                      impl="dense")


# ------------------------------------------------------ B.5 flash kernel --

@pytest.mark.parametrize("b,h,n,d", [(2, 3, 256, 64), (1, 2, 128, 128),
                                     (1, 1, 512, 32), (2, 1, 64, 16)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas_and_ref(b, h, n, d, causal, dtype):
    rng = np.random.default_rng(n * d + causal)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal((b, h, n, d)).astype(np.float32), dtype)
        for _ in range(3))
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                              block_k=64)
    assert got.dtype == tq.dtype
    kern = jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                  interpret=True)
    ref = flash_attention_ref(*(x.astype(jnp.float32) for x in (jq, jk, jv)),
                              causal=causal)
    atol = 2e-5 if dtype == "float32" else 2e-2
    for want in (kern, ref):
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_cross_lengths(causal):
    """N != Nk: full attention against the oracle; causal (row i sees keys
    0..i) against the Pallas kernel, the only reference for that case."""
    rng = np.random.default_rng(22)
    q = rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 256, 32)).astype(np.float32)
            for _ in range(2))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, block_q=64, block_k=64)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64,
                  block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    if not causal:
        ref = flash_attention_ref(*map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)


def test_flash_block_contract_raises():
    """Both packages refuse lengths that do not divide the block."""
    q = torch.zeros((1, 1, 96, 16))
    k = torch.zeros((1, 1, 128, 16))
    for qq, kk in ((q, k), (k, q)):
        with pytest.raises(ValueError, match="divide block size"):
            ops.flash_attention(qq, kk, kk, block_q=64, block_k=64)
        with pytest.raises(ValueError, match="divide block size"):
            jflash(jnp.asarray(qq.numpy()), jnp.asarray(kk.numpy()),
                   jnp.asarray(kk.numpy()), block_q=64, block_k=64,
                   interpret=True)


# ------------------------------------------- attention_apply and the LM --

def _cfgs(**attn):
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    return (dataclasses.replace(jc, attn=dataclasses.replace(jc.attn, **attn)),
            dataclasses.replace(tc, attn=dataclasses.replace(tc.attn, **attn)))


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs()
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    return jp, params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("attn", [
    dict(impl="pallas"), dict(impl="capacity", capacity_factor=2.0),
    dict(gqa_layout="repeat", impl="pallas"), dict(backend="agent"),
    dict(backend="mita_route", impl="pallas"), dict(block_q=0),
], ids=["pallas", "capacity", "repeat", "agent", "mita_route", "block_q0"])
def test_attention_apply_vs_jax(weights, attn):
    """One layer's attention for the backends, layouts and impls that this
    slice adds, on the same normalised input."""
    jp, tp = weights
    jc, tc = _cfgs(**attn)
    x = np.random.default_rng(23).standard_normal((2, 64, jc.d_model)) \
        .astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["attn"]
    lp_t = ttfm.layer_params(tp["blocks"], 0)["attn"]
    jo = jnn.attention_apply(lp_j, jnp.asarray(x), jc)
    to = tnn.attention_apply(lp_t, torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(to), _np(jo), **SPARSE_TOL)


def test_cross_entropy_vs_jax():
    rng = np.random.default_rng(24)
    logits = rng.standard_normal((2, 16, 251)).astype(np.float32) * 3
    labels = rng.integers(0, 251, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    for m in (None, mask):
        jv = jnn.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        tv = tnn.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(_np(tv), _np(jv), **LM_TOL)


def _prompts(b, n, vocab=251, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def test_slice_pallas_forward_and_loss(weights):
    """The slice: lm_forward logits and lm_loss of the smoke qwen3-0.6b with
    impl='pallas' at N = 128 (m = 8 > expert_span 4, where the sorted span
    path may drop routed branches), against JAX."""
    jp, tp = weights
    jc, tc = _cfgs(impl="pallas")
    toks = _prompts(2, 128)
    labels = _prompts(2, 128, seed=1)
    jl, _ = jtfm.lm_forward(jp, jnp.asarray(toks), jc)
    ops.reset_launch_counts()
    tl = ttfm.lm_forward(tp, torch.from_numpy(toks), tc)
    assert ops.launch_counts()["mita_expert_attention"] == 0     # CPU: plain
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
    batch = {"tokens": toks, "labels": labels}
    jv = jtfm.lm_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tv = ttfm.lm_loss(tp, batch, tc)
    np.testing.assert_allclose(_np(tv), _np(jv), **LM_TOL)


def test_slice_pallas_static_generate(weights):
    """static_generate with impl='pallas' (its prefill runs the expert
    path): greedy tokens equal JAX's with the same params."""
    jp, tp = weights
    jc, tc = _cfgs(impl="pallas")
    prompts = _prompts(2, 128, seed=2)
    jt, _ = jstatic_generate(jp, jc, jnp.asarray(prompts), 12)
    tt, _ = tstatic_generate(tp, tc, torch.from_numpy(prompts), 12)
    np.testing.assert_array_equal(tt, np.asarray(jt))
