"""The port's whisper (`models.whisper`) and the ``whisper-tiny`` config
against the JAX reference (CPU), with the JAX init's weights carried over
by `repro_torch.convert`.

Size: the smoke ``whisper-tiny`` (2 encoder and 2 decoder layers, d 128,
4 heads of 32, vocab 251, t_enc 64, dec_len 32, window 16, encoder window
16, float32); the aliasing check at 4 decoder layers.  The same numpy
audio and tokens go through both packages.  Tolerances: the encoder
output, the teacher-forced logits and the loss 1e-5; every decode step's
logits 3e-4 (`tests/test_decode.py`'s tolerance for decode against the
forward), greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import whisper as jw
from repro_torch.configs.registry import arch_params
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax, to_numpy, \
    whisper_state_from_jax
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttfm
from repro_torch.models import whisper as tw
from repro_torch.serve import EngineConfig, backends

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=3e-4, rtol=3e-4)
START = 7            # the smoke vocab's stand-in for <|startoftranscript|>


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arches(**attn):
    ja, ta = (get("whisper-tiny", smoke=True)
              for get in (jget_arch, tget_arch))
    if attn:
        ja, ta = (dataclasses.replace(a, model=dataclasses.replace(
            a.model, attn=dataclasses.replace(a.model.attn, **attn)))
            for a in (ja, ta))
    return ja, ta


@pytest.fixture(scope="module")
def weights():
    ja, _ = _arches()
    jp = jw.whisper_init(jax.random.PRNGKey(0), ja.model, ja.t_enc)
    return jp, params_from_jax(jax.device_get(jp))


def _audio(b=2, seed=1):
    ja, _ = _arches()
    return np.random.default_rng(seed).standard_normal(
        (b, ja.t_enc, ja.model.d_model)).astype(np.float32)


def _fields_equal(port, ref, what):
    """Every field of the port's dataclass equals the reference's (dtypes
    by name); the reference's other fields hold their defaults."""
    names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if f.name not in names:
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            assert want == default, f"{what}.{f.name} is not ported"
        elif f.name == "attn":
            _fields_equal(getattr(port, f.name), want, f"{what}.attn")
        elif f.name.endswith("dtype"):
            assert str(getattr(port, f.name)).split(".")[-1] \
                == jnp.dtype(want).name, f"{what}.{f.name}"
        else:
            assert getattr(port, f.name) == want, f"{what}.{f.name}"


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(smoke):
    ja, ta = (get("whisper-tiny", smoke=smoke)
              for get in (jget_arch, tget_arch))
    for f in ("arch_id", "family", "n_img_tokens", "t_enc", "dec_len",
              "notes"):
        assert getattr(ta, f) == getattr(ja, f), f
    _fields_equal(ta.model, ja.model, "whisper-tiny")
    if not smoke:
        m = ta.model
        assert (m.n_layers, m.d_model, m.n_heads, m.n_kv, m.d_ff, m.vocab,
                ta.t_enc, ta.dec_len) == (4, 384, 6, 6, 1536, 51865, 1500,
                                          448)
        assert ta.t_enc // m.attn.enc_window == 25


def test_encdec_has_no_serving_backend():
    """As in the reference: no registry parameter constructor and no
    serving backend for the encdec family."""
    _, ta = _arches()
    with pytest.raises(ValueError, match="family"):
        arch_params(ta, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="family"):
        backends.for_arch(ta, {}, EngineConfig())


def test_init_layout(weights):
    jp, tp = weights
    _, ta = _arches()
    own = tw.whisper_init(torch.Generator().manual_seed(0), ta.model,
                          ta.t_enc, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jp)):
        node_o, node_t = own, tp
        for p in path:
            node_o, node_t = node_o[p.key], node_t[p.key]
        assert tuple(node_o.shape) == leaf.shape == tuple(node_t.shape)
        assert node_o.dtype == node_t.dtype


@pytest.mark.parametrize("attn", [dict(), dict(impl="pallas"),
                                  dict(backend="full")],
                         ids=["sorted", "pallas", "full"])
def test_encode_decode_train_and_loss(weights, attn):
    jp, tp = weights
    ja, ta = _arches(**attn)
    audio = _audio()
    ops.reset_launch_counts()
    te = tw.whisper_encode(tp, torch.from_numpy(audio), ta.model)
    assert ops.launch_counts()["mita_expert_attention"] == 0   # CPU: plain
    je = jw.whisper_encode(jp, jnp.asarray(audio), ja.model)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, ja.model.vocab, (2, ja.dec_len)).astype(np.int32)
    tl = tw.whisper_decode_train(tp, te, torch.from_numpy(toks), ta.model)
    jl = jw.whisper_decode_train(jp, je, jnp.asarray(toks), ja.model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    batch = {"audio_embeds": audio, "tokens": toks,
             "labels": np.roll(toks, -1, axis=1),
             "loss_mask": (rng.random(toks.shape) > 0.2).astype(np.float32)}
    tv = tw.whisper_loss(tp, batch, ta.model).item()
    jv = float(jw.whisper_loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, ja.model))
    np.testing.assert_allclose(tv, jv, **TOL)


def test_encoder_window_is_enc_window():
    """The encoder attends with window ``enc_window`` (m = t_enc / 16 = 4
    at the smoke size), the decoder with ``window``."""
    _, ta = _arches()
    enc = tw.encoder_cfg(ta.model)
    assert enc.attn.window == ta.model.attn.enc_window == 16
    assert enc.attn.mita_cfg(ta.t_enc, bidir=True).m == 4
    assert tw.encoder_cfg(dataclasses.replace(
        ta.model, attn=dataclasses.replace(ta.model.attn, enc_window=0))) \
        .attn.window == ta.model.attn.window


@pytest.mark.parametrize("backend", ["mita", "full"])
def test_decode_stream_matches_jax(weights, backend):
    """`whisper_init_serve` + `whisper_decode_step` greedily over dec_len
    positions (window closes at 16 and 32) against the JAX stream: logits
    every step within 3e-4, tokens equal, and the converted JAX state
    equal to the port's at the end."""
    jp, tp = weights
    ja, ta = _arches(backend=backend)
    audio = _audio()
    cap = ja.dec_len
    jst = jw.whisper_init_serve(jp, jnp.asarray(audio), ja.model, cap)
    tst = tw.whisper_init_serve(tp, torch.from_numpy(audio), ta.model, cap)
    np.testing.assert_allclose(tst.xk.numpy(), np.asarray(jst.xk), **TOL)
    jstep = jax.jit(lambda st, tok, pos: jw.whisper_decode_step(
        jp, st, tok, pos, ja.model))
    jt = jnp.full((2,), START, jnp.int32)
    tt = torch.full((2,), START, dtype=torch.int32)
    for pos in range(ja.dec_len):
        jl, jst = jstep(jst, jt, jnp.asarray(pos))
        tl, tst = tw.whisper_decode_step(tp, tst, tt, pos, ta.model)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    conv = whisper_state_from_jax(jax.device_get(jst))
    assert type(conv.self_state) is type(tst.self_state)
    for f, a in to_numpy(tst.self_state)._asdict().items():
        b = np.asarray(getattr(jst.self_state, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **STEP_TOL)


def test_decode_states_do_not_alias():
    """Each of the 4 decoder layers owns its cache: no two layers' caches
    share memory, one step leaves them different, and a write into one
    leaves the others as they were (the reference stacks a broadcast
    value; the port's steps write in place)."""
    ja, ta = _arches()
    ja, ta = (dataclasses.replace(a, model=dataclasses.replace(
        a.model, n_layers=4)) for a in (ja, ta))
    jp = jw.whisper_init(jax.random.PRNGKey(3), ja.model, ja.t_enc)
    tp = params_from_jax(jax.device_get(jp))
    audio = _audio(seed=4)
    st = tw.whisper_init_serve(tp, torch.from_numpy(audio), ta.model, 32)
    layers = [ttfm.layer_state(st.self_state, i) for i in range(4)]
    for f in ("k_cache", "v_cache", "q_sum", "lm_q"):
        spans = []
        for lyr in layers:
            x = getattr(lyr, f)
            lo = x.data_ptr()
            spans.append((lo, lo + x.numel() * x.element_size()))
        for i in range(4):
            for j in range(i + 1, 4):
                assert spans[i][1] <= spans[j][0] or spans[j][1] <= \
                    spans[i][0], f"{f}: layers {i} and {j} overlap"
    tok = torch.full((2,), START, dtype=torch.int32)
    _, st = tw.whisper_decode_step(tp, st, tok, 0, ta.model)
    k0 = [ttfm.layer_state(st.self_state, i).k_cache[:, :, 0].clone()
          for i in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(k0[i], k0[j])
    ttfm.layer_state(st.self_state, 0).k_cache.add_(1.0)
    for i in range(1, 4):
        assert torch.equal(
            ttfm.layer_state(st.self_state, i).k_cache[:, :, 0], k0[i])
    assert st.self_state.t.tolist() == [1, 1, 1, 1]
    jst = jw.whisper_init_serve(jp, jnp.asarray(audio), ja.model, 32)
    _, jst = jw.whisper_decode_step(jp, jst, jnp.full((2,), START, jnp.int32),
                                    jnp.asarray(0), ja.model)
    for i in range(1, 4):
        np.testing.assert_allclose(
            k0[i].numpy(), np.asarray(jst.self_state.k_cache[i][:, :, 0]),
            **TOL)
