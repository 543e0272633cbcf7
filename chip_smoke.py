"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: card name and power limit, torch / CUDA versions, the
     kernels' build (seconds, and each kernel's registers / shared memory /
     spills from ``ptxas -v``);
  2. kernel vs plain: both CUDA kernels against their plain PyTorch
     versions at the serving shapes of qwen3-0.6b (S=4, Hkv=8, G=2, d=128,
     w=K=128, M=6), float32 and bfloat16 pools, shuffled page table, ragged
     t, an inactive and a non-due slot; timed with CUDA events;
  3. parity serve: qwen3-0.6b at full width and depth in float32 (TF32
     off), random weights from a seed, 8 requests (batch 4, prompt 512,
     gen 160) through the continuous engine, every greedy token held to
     the static path's (a divergence is accepted only where the static
     path's two best logits lie within 1e-3);
  4. production serve: the same trace at the production dtypes (bf16
     compute) through ``repro_torch.launch.serve.main``, with the kernel
     launch counters set to 0 just before and read just after;
  5. summary: one JSON line of per-kernel results, then the final line
     ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or the
repository's ``src/`` is missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
PEAK_OPS = {torch.float32: 67e12,   # FP32 outside the tensor cores
            torch.bfloat16: 989e12}  # BF16 dense
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
S, HKV, G, D, W, K, M = 4, 8, 2, 128, 128, 128, 6
PARITY_GAP = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one ``fn()`` with a cold L2: a 64 MiB write
    before each timed call evicts the 50 MB L2, as the decode step does
    (each layer's state is reached after the other layers' weights)."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(iters):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


# ------------------------------------------------------------ phase 1 ------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(per source {_build.BUILD_SECONDS})")
    for stem in ("mita_paged_attn", "mita_paged_finalize"):
        for line in _build.ptxas_report(stem).splitlines():
            if any(k in line for k in ("Used", "spill", "Compiling entry")):
                print(f"ptxas[{stem}] {line.strip()}")
    return smi


# ------------------------------------------------------------ phase 2 ------

def make_state(dtype, seed=0):
    """Random paged state at the serving shapes over a shuffled table."""
    from repro_torch.core import mita_decode as mdec
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    n_pages = 2 * S * M
    perm = torch.randperm(n_pages, generator=g, device=dev)
    table = perm[: S * M].reshape(S, M).to(torch.int32)
    cfg = mdec.DecodeConfig(window=W, k=K, external_finalize=True)
    st = mdec.init_paged_state(HKV, D, n_pages, S, M, cfg, dtype, dev)
    for x in (st.k_pool, st.v_pool, st.lm_q, st.lm_v):
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    st.q_sum.copy_(torch.randn(st.q_sum.shape, generator=g, device=dev)
                   * W)
    # expert rows point into the slot's own page of that ordinal
    off = torch.randint(0, W, (S, HKV, M, K), generator=g, device=dev)
    st.expert_idx.copy_(table.long()[:, None, :, None] * W + off)
    st.expert_valid.copy_(torch.rand((S, HKV, M, K), generator=g,
                                     device=dev) > 0.2)
    st.expert_valid[..., 0] = True
    q = torch.randn((S, HKV, G, D), generator=g, device=dev).to(dtype)
    kn = torch.randn((S, HKV, D), generator=g, device=dev).to(dtype)
    vn = torch.randn((S, HKV, D), generator=g, device=dev).to(dtype)
    return st, table, q, kn, vn


def clone_state(st, dtype=None):
    """Copy of a state; ``dtype`` recasts its floating fields."""
    return type(st)(*(x.to(dtype, copy=True)
                      if dtype is not None and x.is_floating_point()
                      else x.clone() for x in st))


def attn_bound(st, q, t, active, m_cnt, dtype):
    """Least bytes and operations of one paged-decode call on this data:
    each input element the function needs read once, each output written
    once; masked local positions and invalid expert rows are not needed."""
    from repro_torch.core.mita import argmax_first
    from repro_torch.device import NEG_INF
    es = torch.tensor([], dtype=dtype).element_size()
    r = torch.einsum("shgd,shmd->shgm", q.float(), st.lm_q.float())
    lm_ok = torch.arange(M, device="cuda")[None, None, None, :] \
        < m_cnt.long()[:, None, None, None]
    r = torch.where(lm_ok, r, NEG_INF)
    e = argmax_first(r)                                   # [S, Hkv, G]
    ok = r.amax(-1) > NEG_INF / 2
    vsel = torch.gather(st.expert_valid, 2,
                        e[..., None].expand(S, HKV, G, K))
    n_exp = (vsel.sum(-1) * ok).cpu().numpy()              # [S, Hkv, G]
    tt, act, mc = (x.cpu().numpy() for x in (t, active, m_cnt))
    nbytes = S * HKV * (G * D * es + 2 * D * es)           # out + append
    ops = 0
    for s in range(S):
        if not act[s]:
            continue
        loc = tt[s] % W                                    # rows before t
        for h in range(HKV):
            nbytes += (G * D + 2 * D) * es                 # q, k_new, v_new
            nbytes += 2 * mc[s] * D * es + 2 * loc * D * es
            nbytes += sum(int(ok[s, h, gi]) * K * 5 + int(n_exp[s, h, gi])
                          * 2 * D * es for gi in range(G))
            ops += sum(4 * D * (mc[s] + loc + 1 + int(n_exp[s, h, gi]))
                       for gi in range(G))
    nbytes += S * (M * 4 + 9)                               # table, t, flags
    return nbytes, ops


def finalize_bound(t_new, due, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = S * 9
    ops = 0
    for tn, dv in zip(t_new.cpu().numpy(), due.cpu().numpy()):
        if not dv:
            continue
        nbytes += HKV * (2 * tn * D * es + 2 * D * 4 + M * 4
                         + 2 * D * es + K * 5)
        ops += HKV * (4 * tn * D + K * tn)
    return nbytes, ops


def bound_ms(nbytes, ops, dtype):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels():
    from repro_torch.kernels import mita_paged_attn as mpa
    from repro_torch.kernels import mita_paged_finalize as mpf
    dev = "cuda"
    t = torch.tensor([130, 300, 0, 767], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    m_cnt = t // W
    t_new = torch.tensor([256, 640, 300, 768], dtype=torch.int32, device=dev)
    due = torch.tensor([True, True, False, True], device=dev)
    res = {"attn": {}, "fin": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        # --- paged decode attention
        st, table, q, kn, vn = make_state(dtype, seed=1)
        # the plain reference runs on float32 copies of the same values
        a, b = clone_state(st, torch.float32), clone_state(st)
        ref = mpa.paged_attention_plain(
            q.float(), kn.float(), vn.float(), a.lm_q, a.lm_v, a.expert_idx,
            a.expert_valid, a.k_pool, a.v_pool, table, t, active, m_cnt,
            window=W, n_route=1, fuse_append=True)
        out = mpa.mita_paged_attention(
            q, kn, vn, b.lm_q, b.lm_v, b.expert_idx, b.expert_valid,
            b.k_pool, b.v_pool, table, t, active, m_cnt, window=W,
            n_route=1, fuse_append=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            fail(f"mita_paged_attention {dtype} max_abs_err {err}")
        for pool in ("k_pool", "v_pool"):
            if not torch.equal(getattr(a, pool)[:-1],
                               getattr(b, pool)[:-1].float()):
                fail(f"mita_paged_attention {dtype} {pool} rows differ")
        kern = lambda: mpa.mita_paged_attention(  # noqa: E731
            q, kn, vn, b.lm_q, b.lm_v, b.expert_idx, b.expert_valid,
            b.k_pool, b.v_pool, table, t, active, m_cnt, window=W,
            n_route=1, fuse_append=True)
        a = clone_state(st)
        plain = lambda: mpa.paged_attention_plain(  # noqa: E731
            q, kn, vn, a.lm_q, a.lm_v, a.expert_idx, a.expert_valid,
            a.k_pool, a.v_pool, table, t, active, m_cnt, window=W,
            n_route=1, fuse_append=True)
        ms, pms = cuda_ms(kern), cuda_ms(plain)
        bms, by = bound_ms(*attn_bound(st, q, t, active, m_cnt, dtype),
                           dtype)
        res["attn"][dtype] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, tol=tol)
        print(f"mita_paged_attention {dtype}: max_abs_err {err:.3e} "
              f"(tol {tol}), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.5f} ms ({by})")

        # --- paged finalize
        st, table, _, _, _ = make_state(dtype, seed=2)
        a, b = clone_state(st, torch.float32), clone_state(st)
        mpf.paged_finalize_plain(a.q_sum, a.lm_q, a.lm_v, a.expert_idx,
                                 a.expert_valid, a.k_pool, a.v_pool, table,
                                 t_new, due, window=W, k_width=K)
        mpf.mita_paged_finalize_fused(b.q_sum, b.lm_q, b.lm_v, b.expert_idx,
                                      b.expert_valid, b.k_pool, b.v_pool,
                                      table, t_new, due, window=W, k_width=K)
        torch.cuda.synchronize()
        err = max((getattr(b, f).float() - getattr(a, f).float()).abs()
                  .max().item() for f in ("lm_q", "lm_v", "q_sum"))
        for f in ("lm_q", "lm_v", "q_sum"):
            if not torch.allclose(getattr(b, f).float(),
                                  getattr(a, f).float(), atol=tol, rtol=tol):
                fail(f"mita_paged_finalize_fused {dtype} {f} "
                     f"max_abs_err {err}")
        idx_mismatch = int((b.expert_idx != a.expert_idx).sum())
        val_mismatch = int((b.expert_valid != a.expert_valid).sum())
        if dtype == torch.float32 and (idx_mismatch or val_mismatch):
            fail(f"finalize integer outputs differ: {idx_mismatch} rows, "
                 f"{val_mismatch} validity flags")
        nd = ~due
        for f in ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum"):
            if not torch.equal(getattr(b, f)[nd], getattr(st, f)[nd]):
                fail(f"finalize changed non-due slot field {f}")
        c = clone_state(st)
        kern = lambda: mpf.mita_paged_finalize_fused(  # noqa: E731
            c.q_sum, c.lm_q, c.lm_v, c.expert_idx, c.expert_valid, c.k_pool,
            c.v_pool, table, t_new, due, window=W, k_width=K)
        plain = lambda: mpf.paged_finalize_plain(  # noqa: E731
            c.q_sum, c.lm_q, c.lm_v, c.expert_idx, c.expert_valid, c.k_pool,
            c.v_pool, table, t_new, due, window=W, k_width=K)
        ms, pms = cuda_ms(kern), cuda_ms(plain)
        bms, by = bound_ms(*finalize_bound(t_new, due, dtype), dtype)
        res["fin"][dtype] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound_ms=bms, bound_by=by, tol=tol,
                                 idx_mismatch=idx_mismatch)
        print(f"mita_paged_finalize_fused {dtype}: max_abs_err {err:.3e} "
              f"(tol {tol}), expert-row mismatches {idx_mismatch}/"
              f"{3 * HKV * K}, kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.5f} ms ({by})")
    return res


# ------------------------------------------------------------ phase 3 ------

def phase_parity():
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.serve import static_generate
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model,
                              compute_dtype=torch.float32)
    batch, n, gen, n_req = 4, 512, 160, 8
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    prompts = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=n,
                                         global_batch=n_req), 0)["tokens"]
    pages = -(-(n + gen) // W)
    ecfg = EngineConfig(n_slots=batch, pages_per_slot=pages,
                        n_pages=2 * batch * pages)
    eng = ServingEngine(params, cfg, ecfg, device="cuda")
    t0 = time.perf_counter()
    done = eng.run([Request(rid=i, prompt=prompts[i], max_new_tokens=gen)
                    for i in range(n_req)])
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    if [f.reason for f in done] != ["complete"] * n_req:
        fail(f"parity serve reasons {[f.reason for f in done]}")
    scfg = eng.backend.cfg            # the engine's finalize mode
    worst, diverged = math.inf, 0
    for g0 in range(0, n_req, batch):
        ref, tm = static_generate(
            params, scfg, torch.as_tensor(prompts[g0:g0 + batch],
                                          device="cuda"),
            gen, capacity=pages * W, record_gaps=True)
        for row in range(batch):
            ours = done[g0 + row].tokens
            diff = np.nonzero(ours != ref[row])[0]
            if diff.size == 0:
                continue
            i = int(diff[0])
            gap = float(tm["top2_gap"][i, row])
            print(f"parity: request {g0 + row} diverges at token {i}, "
                  f"static top-two gap {gap:.3e}")
            if gap >= PARITY_GAP:
                fail(f"request {g0 + row} diverges at token {i} where the "
                     f"static top-two gap {gap} >= {PARITY_GAP}")
            diverged += 1
            worst = min(worst, gap)
    print(f"parity serve (float32, {cfg.n_layers} layers): {n_req} "
          f"requests x {gen} tokens in {t_eng:.2f} s, {diverged} near-tie "
          f"divergences, tokens otherwise identical to static_generate")
    del params, eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4 ------

def phase_production(card: str):
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main

    n_layers = get_arch("qwen3-0.6b").model.n_layers
    vocab = get_arch("qwen3-0.6b").model.vocab
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    summary = main(["--engine", "continuous", "--batch", "4",
                    "--prompt-len", "512", "--gen", "160", "--requests",
                    "8", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if summary["finished"] != 8 or set(summary["reasons"]) != {"complete"}:
        fail(f"production serve finished {summary['reasons']}")
    for rid, toks in summary["tokens"].items():
        if len(toks) != 160 or toks.min() < 0 or toks.max() >= vocab:
            fail(f"production serve request {rid} tokens malformed")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if launches["mita_paged_attention"] != n_layers * summary["steps"]:
        fail(f"decode launches {launches['mita_paged_attention']} != "
             f"{n_layers} layers x {summary['steps']} steps")
    print(f"production serve ({card}): {summary['tok_s']:.1f} tok/s, "
          f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{summary['ttft_p99_s'] * 1e3:.1f} ms, {summary['steps']} "
          f"steps, max_memory_allocated {peak / 2**30:.2f} GiB, "
          f"launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; nothing to check",
              file=sys.stderr)
        return 2
    src = HERE / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  (TF32 off, default device)

    card = phase_env()
    kern = phase_kernels()
    phase_parity()
    launches = phase_production(card)

    bf = torch.bfloat16
    rows = []
    for key, name, src_file, replaces in (
            ("attn", "mita_paged_attention",
             "src/repro_torch/csrc/mita_paged_attn.cu",
             "src/repro/kernels/mita_paged_attn.py:217"),
            ("fin", "mita_paged_finalize_fused",
             "src/repro_torch/csrc/mita_paged_finalize.cu",
             "src/repro/kernels/mita_paged_finalize.py:119")):
        r, r32 = kern[key][bf], kern[key][torch.float32]
        rows.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "dtype": "bfloat16", "tol": r["tol"],
            "f32": {k: r32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "tol")}})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
