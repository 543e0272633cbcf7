"""The port's training machinery on its own (CPU): AdamW and its schedule,
checkpoints, restart-from-checkpoint, the data pipeline, remat and the
training CLI.  The reference's own cases (`tests/test_substrates.py`,
`tests/test_system.py`'s train driver) run on the port, plus what the
port promises beyond them: an async save that a later in-place write
cannot tear, a resumed run bit-identical to an uninterrupted one, remat
that leaves every gradient bit as it was.

Sizes: smoke configs (float32, 2 layers, d 128, vocab 251), batch 4 x 64.
Exact where the text says bit for bit; AdamW against its numpy formula
1e-6 relative.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hypothesis_compat import given, settings, st

from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.registry import get_arch
from repro_torch.data import DataConfig, SyntheticLMStream, synthetic_batch
from repro_torch.distributed import run_with_restarts
from repro_torch.launch import train as tr
from repro_torch.launch.steps import family_fns, train_step
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)
from repro_torch.optim.adamw import tree_leaves, tree_map

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _smoke(arch_id, **model):
    arch = get_arch(arch_id, smoke=True)
    if model:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, **model))
    fns = family_fns(arch)
    params = fns["init"](torch.Generator().manual_seed(0), "cpu")
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=64, global_batch=4)
    return arch, fns, params, dcfg


def _bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------- optimizer

def test_adamw_matches_numpy_reference():
    cfg = OptConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                    clip_norm=1e9, warmup_steps=0, total_steps=10,
                    min_lr_ratio=1.0)
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    new_p, state, _ = adamw_update(g, adamw_init(p), p, cfg)

    w, gr = p["w"].numpy(), g["w"].numpy()
    mu = 0.1 * gr
    nu = 0.01 * gr * gr
    mhat = mu / (1 - 0.9)
    nhat = nu / (1 - 0.99)
    ref = w - 1e-2 * (mhat / (np.sqrt(nhat) + 1e-8) + 0.1 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-6)
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    assert state.mu["w"].dtype == torch.float32


def test_adamw_update_leaves_its_inputs_alone():
    p = {"a": {"w": torch.ones(3)}, "b": torch.full((2,), 2.0)}
    g = tree_map(lambda t: t * 0.5, p)
    state = adamw_init(p)
    keep_p, keep_g = tree_map(torch.clone, p), tree_map(torch.clone, g)
    adamw_update(g, state, p, OptConfig())
    assert _bits_equal(keep_p, p) and _bits_equal(keep_g, g)
    assert int(state.step) == 0 and not state.mu["b"].any()


def test_cosine_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_ratio=0.1)
    s = [float(cosine_schedule(torch.tensor(t), cfg))
         for t in [0, 5, 10, 60, 110]]
    assert s[0] == 0.0 and abs(s[1] - 0.5) < 1e-6 and abs(s[2] - 1.0) < 1e-6
    assert s[2] > s[3] > s[4] >= 0.1 - 1e-6
    assert cosine_schedule(torch.tensor(5, dtype=torch.int32),
                           cfg).dtype == torch.float32


@settings(max_examples=15, deadline=None)
@given(st.floats(0.1, 10.0), st.integers(0, 2**31 - 1))
def test_clip_by_global_norm_property(max_norm, seed):
    g = {"a": torch.randn(7, generator=torch.Generator().manual_seed(seed))
         * 5}
    clipped, gn = clip_by_global_norm(g, max_norm)
    cn = float(torch.linalg.norm(clipped["a"]))
    assert cn <= max_norm * (1 + 1e-5) or cn <= float(gn) + 1e-5


# --------------------------------------------------------------------- data

def test_data_deterministic_and_elastic_invariant():
    """Same (seed, step) -> same global batch, regardless of host count."""
    cfg1 = DataConfig(vocab=101, seq_len=32, global_batch=8, host_count=1)
    full = synthetic_batch(cfg1, step=5)["tokens"]
    parts = [synthetic_batch(DataConfig(vocab=101, seq_len=32,
                                        global_batch=8, host_index=hi,
                                        host_count=4), step=5)["tokens"]
             for hi in range(4)]
    np.testing.assert_array_equal(full, np.concatenate(parts, axis=0))
    assert not np.array_equal(full, synthetic_batch(cfg1, step=6)["tokens"])


def test_data_labels_are_shifted_tokens():
    b = synthetic_batch(DataConfig(vocab=101, seq_len=32, global_batch=2), 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_stream_prefetch_and_resume():
    cfg = DataConfig(vocab=101, seq_len=16, global_batch=2)
    s = SyntheticLMStream(cfg, start_step=3)
    try:
        for want in (3, 4):
            step, batch = next(s)
            assert step == want
            np.testing.assert_array_equal(
                batch["tokens"], synthetic_batch(cfg, want)["tokens"])
    finally:
        s.close()
    assert not s._thread.is_alive()


# --------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16) / 3},
            "t": (torch.zeros((2,)), torch.tensor(3))}
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert list(restored) == list(tree) and isinstance(restored["t"], tuple)
    flat = lambda t: [t["a"], t["nested"]["b"], *t["t"]]  # noqa: E731
    for x, y in zip(flat(tree), flat(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with np.load(tmp_path / "step_7" / "arrays.npz") as data:
        assert sorted(data.files) == ["a", "nested/b", "t/0", "t/1"]
        assert data["nested/b"].dtype == np.float32     # bf16 widened


def test_checkpoint_keys_follow_the_reference(tmp_path):
    """A (params, AdamWState) tree: dict keys, sequence indices and the
    NamedTuple's field names, joined by "/"."""
    p = {"emb": {"tok": torch.ones(2, 3)}, "ln_f": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 1, (p, adamw_init(p)))
    with np.load(tmp_path / "step_1" / "arrays.npz") as data:
        assert sorted(data.files) == sorted(
            ["0/emb/tok", "0/ln_f", "1/mu/emb/tok", "1/mu/ln_f",
             "1/nu/emb/tok", "1/nu/ln_f", "1/step"])
        assert data["1/step"].dtype == np.int32 and data["1/step"].shape == ()


def test_checkpoint_manager_prunes_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((3,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones((3,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {"w": torch.ones((4,))})


def test_async_save_does_not_tear(tmp_path):
    """`save` copies the tree before it returns: an in-place update right
    after it (as an in-place optimizer step would make) does not reach
    the file."""
    tree = {"w": torch.arange(1 << 20, dtype=torch.float32),
            "b": torch.ones(8, dtype=torch.bfloat16)}
    want = tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    tree["w"].mul_(-1.0)
    tree["b"].add_(1.0)
    mgr.wait()
    _, got = mgr.restore(tree_map(torch.zeros_like, tree))
    assert _bits_equal(got, want)


# ---------------------------------------------------------- fault tolerance

def test_run_with_restarts_recovers(tmp_path):
    """A step that fails once is replayed identically after restore."""
    mgr = CheckpointManager(str(tmp_path))
    failures = {"armed": True}

    def step_fn(step, state):
        if step == 7 and failures["armed"]:
            failures["armed"] = False
            raise RuntimeError("simulated preemption")
        return {"acc": state["acc"] + step}

    out = run_with_restarts(step_fn, {"acc": torch.tensor(0)}, mgr,
                            n_steps=10, ckpt_every=2)
    assert int(out["acc"]) == sum(range(10))


def test_run_with_restarts_gives_up(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def bad_step(step, state):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError, match="hard failure"):
        run_with_restarts(bad_step, {}, mgr, n_steps=3, max_restarts=2)


def test_run_with_restarts_replays_a_train_step_bit_for_bit(tmp_path):
    """Real smoke train steps that fail once at step 3 (after the step-2
    checkpoint) end with parameters and moments bit-identical to an
    uninterrupted run."""
    arch, fns, params, dcfg = _smoke("qwen3-0.6b")
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    failures = {"armed": False}

    def step_fn(step, state):
        if step == 3 and failures["armed"]:
            failures["armed"] = False
            raise RuntimeError("simulated preemption")
        p, o, _ = train_step(*state, tr.train_batch(arch, dcfg, step),
                             fns["loss"], opt)
        return p, o

    outs = []
    with tr.deterministic(CPU):
        for i, armed in enumerate((False, True)):
            failures["armed"] = armed
            # each run its own copy: a train step updates in place
            outs.append(run_with_restarts(
                step_fn, (tree_map(torch.clone, params), adamw_init(params)),
                CheckpointManager(str(tmp_path / str(i))), n_steps=5,
                ckpt_every=2))
    assert not failures["armed"]
    (pa, oa), (pb, ob) = outs
    assert _bits_equal(pa, pb) and _bits_equal(oa.mu, ob.mu) \
        and _bits_equal(oa.nu, ob.nu) and int(oa.step) == int(ob.step) == 5


def test_run_with_restarts_replays_a_failure_before_the_first_checkpoint(
        tmp_path):
    """A step that fails at step 1, before the first checkpoint (step 2)
    and after its in-place update has written the parameters and moments
    that the run started from: the replay starts from step 0's state, and
    the run ends bit-identical to an uninterrupted one."""
    arch, fns, params, dcfg = _smoke("qwen3-0.6b")
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    failures = {"armed": False}

    def step_fn(step, state):
        p, o, _ = train_step(*state, tr.train_batch(arch, dcfg, step),
                             fns["loss"], opt)
        if step == 1 and failures["armed"]:
            failures["armed"] = False
            raise RuntimeError("simulated failure after the update")
        return p, o

    outs = []
    with tr.deterministic(CPU):
        for i, armed in enumerate((False, True)):
            failures["armed"] = armed
            outs.append(run_with_restarts(
                step_fn, (tree_map(torch.clone, params), adamw_init(params)),
                CheckpointManager(str(tmp_path / str(i))), n_steps=4,
                ckpt_every=2))
    assert not failures["armed"]
    (pa, oa), (pb, ob) = outs
    assert _bits_equal(pa, pb) and _bits_equal(oa.mu, ob.mu) \
        and _bits_equal(oa.nu, ob.nu) and int(oa.step) == int(ob.step) == 4


# --------------------------------------------------------- remat, impl ----

@pytest.mark.parametrize("broadcast", [False, True])
def test_take_rows_is_gather_with_a_row_wise_backward(broadcast):
    """`core.mita.take_rows` returns ``torch.gather``'s bits, and its
    row-wise backward gives gather's gradient (float64: to the last
    rounding) -- repeated rows and a broadcast (expanded) input
    included."""
    from repro_torch.core.mita import take_rows
    gen = torch.Generator().manual_seed(0)
    base = torch.randn((2, 1 if broadcast else 3, 9, 5), generator=gen,
                       dtype=torch.float64)
    idx = torch.randint(0, 9, (2, 3, 12), generator=gen)
    idx[..., :4] = 2                                   # repeated rows
    grads = []
    for fn in (take_rows, lambda x, i: torch.gather(
            x, -2, i[..., None].expand(i.shape + (x.shape[-1],)))):
        b = base.clone().requires_grad_()
        out = fn(b.expand(2, 3, 9, 5), idx)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
        grads.append((out.detach(), torch.autograd.grad((out * w).sum(),
                                                        b)[0]))
    (o1, g1), (o2, g2) = grads
    assert torch.equal(o1, o2)
    torch.testing.assert_close(g1, g2, atol=1e-12, rtol=1e-12)
    with pytest.raises(ValueError, match="lead"):
        take_rows(base.expand(2, 3, 9, 5), idx[:1])

@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "deepseek-moe-16b",
                                     "mamba2-370m", "recurrentgemma-9b"])
def test_remat_changes_no_gradient_bit(arch_id):
    """Each layer recomputed in the backward (``remat=True``, the
    production setting) gives the gradients of the stored forward bit for
    bit: the same top-k and routing decisions, the same sums (under the
    training driver's deterministic settings, as training runs)."""
    grads = []
    for remat in (False, True):
        arch, fns, params, dcfg = _smoke(arch_id, remat=remat)
        p = tree_map(lambda t: t.requires_grad_(), params)
        with tr.deterministic(CPU):
            loss = fns["loss"](p, tr.train_batch(arch, dcfg, 0))
            grads.append(torch.autograd.grad(loss, tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_only_while_autograd_records(monkeypatch):
    """Scoring and serving (no grad) never enter the checkpoint wrapper."""
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    arch, fns, params, dcfg = _smoke("qwen3-0.6b", remat=True)
    batch = tr.train_batch(arch, dcfg, 0)
    with torch.no_grad():
        fns["loss"](params, batch)
    fns["loss"](params, batch)           # grad mode, nothing requires grad
    assert not calls
    fns["loss"](tree_map(lambda t: t.requires_grad_(), params), batch)
    assert len(calls) == arch.model.n_layers


def test_training_with_the_expert_kernel_raises():
    """``impl="pallas"`` has no backward, here as in the reference."""
    arch, fns, params, dcfg = _smoke("qwen3-0.6b")
    cfg = arch.model
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, impl="pallas")))
    with pytest.raises(RuntimeError, match="forward only"):
        train_step(params, adamw_init(params), tr.train_batch(arch, dcfg, 0),
                   family_fns(arch)["loss"], OptConfig())


# ---------------------------------------------------------------- the CLI

def _cli(arch, ckpt, *extra):
    return tr.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "8", "--batch", "4", "--seq", "64", "--ckpt-dir", ckpt,
                    "--ckpt-every", "2", *extra])


def test_train_driver_end_to_end(tmp_path, capsys):
    rc = tr.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                  "--steps", "6", "--batch", "4", "--seq", "64",
                  "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"])
    assert rc == 0
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 6
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     5 loss" in out
    assert not torch.are_deterministic_algorithms_enabled()


def test_train_resume_after_failure(tmp_path):
    """Fail at step 5, resume: the final checkpoint equals an uninterrupted
    run's array for array, bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        _cli("tinyllama-1.1b", ckpt, "--simulate-failure", "5")
    assert CheckpointManager(ckpt).latest_step() == 4
    assert _cli("tinyllama-1.1b", ckpt, "--resume") == 0
    assert _cli("tinyllama-1.1b", str(tmp_path / "ref")) == 0
    with np.load(tmp_path / "ckpt" / "step_8" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_8" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k


def test_train_cli_alone_runs_a_one_rank_mesh(capsys):
    """With no mesh flags and no ``torchrun`` environment the CLI runs its
    one path, the reference's 1 x 1 mesh, over a one-rank ``gloo`` group
    of its own, and takes the group down whether it returns or raises."""
    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "32"]
    assert "WORLD_SIZE" not in os.environ and not dist.is_initialized()
    assert tr.main(args) == 0
    summ = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("summary ")]
    assert json.loads(summ[0][len("summary "):])["mesh"] == {"data": 1,
                                                           "model": 1}
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.main(args + ["--simulate-failure", "1"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "internvl2-76b",
                                     "mamba2-370m", "recurrentgemma-9b",
                                     "whisper-tiny"])
def test_train_driver_every_family(arch_id, capsys):
    assert tr.main(["--arch", arch_id, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "64"]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "summary" in out


def test_train_batches_follow_the_reference():
    """vlm: zero image embeddings; encdec: default_rng(step) frames and the
    first dec_len tokens."""
    for arch_id in ("internvl2-76b", "whisper-tiny"):
        arch, _, _, dcfg = _smoke(arch_id)
        b = tr.train_batch(arch, dcfg, 3)
        host = synthetic_batch(dcfg, 3)
        d = arch.model.d_model
        if arch.family == "vlm":
            assert b["image_embeds"].shape == (4, arch.n_img_tokens, d)
            assert not b["image_embeds"].any()
            np.testing.assert_array_equal(b["tokens"], host["tokens"])
        else:
            np.testing.assert_array_equal(
                b["audio_embeds"], np.random.default_rng(3).standard_normal(
                    (4, arch.t_enc, d)).astype(np.float32))
            np.testing.assert_array_equal(
                b["labels"], host["labels"][:, :arch.dec_len])


def test_train_entry_point_defaults_to_cuda():
    assert "--device" in inspect.getsource(tr.main)
    arch = get_arch("qwen3-0.6b", smoke=True)
    init = family_fns(arch)["init"]
    assert inspect.signature(init).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tr.main(["--smoke", "--steps", "1"])


def test_family_fns_serving_entries():
    """``family_fns`` gives the reference's serving entries in batch form:
    a dense prefill then decode steps, mamba2 and hybrid decodes from
    empty states; no prefill for the two recurrent families (a forward)
    and no states for whisper (they need the encoder's output)."""
    arch, fns, params, dcfg = _smoke("qwen3-0.6b")
    toks = torch.as_tensor(synthetic_batch(dcfg, 0)["tokens"][:2, :32])
    with torch.no_grad():
        logits, states = fns["prefill"](params, {"tokens": toks}, 48)
        for pos in (32, 33):
            logits, states = fns["decode"](params, states,
                                           logits.argmax(-1), pos)
    assert logits.shape == (2, arch.model.vocab)
    assert torch.isfinite(logits).all()
    for arch_id in ("mamba2-370m", "recurrentgemma-9b"):
        arch, fns, params, dcfg = _smoke(arch_id)
        with torch.no_grad():
            logits, _ = fns["decode"](params,
                                      fns["init_states"](2, 32, "cpu"),
                                      torch.zeros(2, dtype=torch.long), 0)
        assert logits.shape == (2, arch.model.vocab)
        assert torch.isfinite(logits).all()
    for arch_id, none in (("recurrentgemma-9b", ("prefill",)),
                          ("whisper-tiny", ("prefill", "init_states"))):
        fns = family_fns(get_arch(arch_id, smoke=True))
        assert all(fns[k] is None for k in none)


def test_production_configs_remat_and_smoke_does_not():
    assert get_arch("qwen3-0.6b").model.remat
    assert not get_arch("qwen3-0.6b", smoke=True).model.remat
