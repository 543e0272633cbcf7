"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: card name and power limit, torch / CUDA versions, the
     kernels' build (seconds, and each kernel's registers / shared memory /
     spills from ``ptxas -v``);
  2. kernel vs plain, at the serving shapes of qwen3-0.6b (S=P=4, Hkv=8,
     G=2, d=128, w=K=128, M=6), float32 and bfloat16 pools, shuffled page
     tables, timed with CUDA events (``ms``; ``card_ms`` with each timed
     call queued behind a spin kernel, so that it leaves out the host's
     launch cost), each kernel's launches per call, their names and grids
     read from a profiler trace of one call:
       * paged decode (ragged t, an inactive slot; pools exact; at least
         one block per SM), also at S = 32, M = 32 (4096 tokens of
         context), and paged finalize (a non-due slot; expert rows and
         validity exact in both dtypes: the bf16 check rounds the plain
         version's landmark query as the kernel does), also at S = 32,
         M = 32 (ragged t_new, a due slot with fewer than K positions) and
         on exact ties across splits (first index, 0 mismatches), its two
         launches (split, merge) from the trace, and a control with one
         split's partials dropped between them that must fail the check;
       * chunk prefill (nc=256): a fresh, a resumed, a non-aligned
         (n_train 320) and an inactive row, then two recompute rows
         (n_train < t0 + n_valid) and a fresh non-aligned row; outputs,
         pools, both landmark systems, both query sums and the expert rows
         (exact in float32);
     * the full-sequence kernels at qwen3-0.6b's forward shape (B = 1,
       N = 4096): routed-expert attention (lead [1, 8, 2] over a broadcast
       KV lead [1, 8, 1], m = 32; a causal-skewed sorted assignment with an
       all-inactive tile, and a ragged NS = 4059) and flash attention
       ([1, 16, 4096, 128] causal and full, and a cross length Nk = 4096
       for N = 1024), against their plain versions; flash also against
       ``scaled_dot_product_attention`` as the library yardstick, with
       the path that the trace shows (bf16: tensor cores) and two
       controls that must fail the check (the kernel with its first key
       tile dropped, and with keys 2048..2175 dropped for the rows after
       them);
     * the routed-expert kernel at recurrentgemma-9b's forward shape
       (lead [1, 1, 16] over one KV head, head dim 256, m = 32 at N =
       4096; the CUDA-core wide instance in both dtypes): within 1e-5 /
       2e-2 of its plain version, shuffled rows bit for bit, a control
       with keys 64..127 of an expert dropped that must fail, timed;
     * B.1-B.3 at the head-dim-64 decode shapes of tinyllama-1.1b (S 4,
       Hkv 4, G 8) and stablelm-1.6b (Hkv 32, G 1), w = K = 128, M = 6,
       both dtypes: the serving cases above against the plain versions
       (expert rows and validity at 0 mismatches), timed with launches
       and bound (PR 21);
     * the sampler (`repro_torch.prng`, `models.transformer.
       sample_tokens`) at [S, 151936] against the same calls on the CPU:
       threefry words and per-slot keys exact, gumbel within 4 float32 /
       1 bfloat16 ulp of 1 + |g|, tempered tokens equal away from
       near-ties; one fused tempered sample timed (CUDA events) with its
       CUDA launches from a trace;
  3. parity (float32, TF32 off, random weights from a seed; the serves
     of the earlier slices at 4 layers, the rest at 28):
     8 requests (batch 4, prompt 512, gen 160) through the monolithic and
     the chunked (prefill chunk 256) engine, and 4 requests of the
     non-aligned prompt length 96 through the chunked engine, every greedy
     token held to the static path's (a divergence is accepted only where
     the static path's two best logits lie within 1e-3); a preemption
     round trip (the victim's tokens equal its unpreempted run) and a
     prefix-cache run (hits >= 1, tokens equal to the cold engine);
     the full-sequence forward with ``impl="pallas"`` (the expert kernel)
     against ``impl="sorted"`` at expert_span = m at N = 4096: every
     layer's attention on the same input, the logits' greedy tokens and
     ``lm_loss``; ``static_generate`` with ``impl="pallas"`` against the
     chunked engine at prompt 1024 (m = 8 > span 4); speculative decoding
     (chunked 256, fused sampling, prompts 96 and 512, 48 new tokens):
     tempered (0.8) spec_k = 3 streams equal spec_k = 0's, host-sampled
     tempered streams equal the fused ones, greedy spec_k = 3 equals
     ``static_generate`` except at recorded near-ties; then
     mamba2-370m (4 layers) and recurrentgemma-9b (1 super-block) at
     full width: the monolithic, batched-chunked and per-job-chunked
     (128) engines held to the backend's ``static_reference`` except at
     near-ties, a preemption round trip token-exact, spec_k = 3 (self)
     equal to spec_k = 0 at temperatures 0 and 0.8; the qwen3-0.6b
     per-job serve (4 layers) against the batched serve and
     ``static_generate`` (first-token logits within 1e-4 of
     ``lm_prefill``'s unless a landmark top-K near-tie is proven pick by
     pick); the hybrid's full-sequence forward (2
     super-blocks, N = 4096), impl="pallas" against "sorted" at span = m
     layer by layer within 1e-5, expert launches = attention layers x
     forwards; supervision (PR 21, float32): `benchmarks/chaos_bench.py`'s
     four phases on qwen3-0.6b (4 layers), mamba2-370m (4 layers) and
     recurrentgemma-9b (1 super-block) at full width -- a fault-free
     oracle, seed 11 chaos under the `Supervisor` (faults on >= 20% of
     step attempts, streams equal, zero leaks, B.1-B.3 launched), a
     persistent fault that walks the ladder to level 3, a kill after 6
     steps with a journal restore -- plus MiTA spec_k 3 with faults at
     verify_step and mamba2 self drafts with faults at draft_steps (equal
     to spec_k 0), and a torn MiTA decode dispatch (quarantined, never
     retried, streams equal); tinyllama-1.1b and stablelm-1.6b at 4
     layers, 4 requests of 544 + 112 tokens chunked (256) through the
     supervised engine, held to `static_generate` except at near-ties
     (decode = layers x steps, finalize > 0, chunk = layers x dispatches);
  4. production serves (every continuous serve of the CLI runs under the
     `Supervisor`): the same trace at the production dtypes (bf16
     compute) through ``repro_torch.launch.serve.main``, monolithic and
     then chunked (``--prefill-chunk 256``, the slice's main path), the
     kernel launch counters set to 0 just before each and read just after
     (chunk launches = 28 layers x prefill dispatches); then the
     full-sequence path at bf16: ``lm_forward`` tokens/s at B = 1,
     N = 4096 for ``impl="pallas"`` and ``impl="sorted"``, and one
     monolithic serve with ``--attn-impl pallas`` (expert launches = 28
     layers x full-sequence forwards); then the slice's main path: a bf16
     chunked, fused, tempered (0.8) serve at ``--spec-k 3`` and its
     ``--spec-k 0`` twin in turns (tok/s, the speculation counters, equal
     streams; decode launches = 28 layers x decode steps, every verify
     position counted); then the bf16 qwen3-0.6b per-job serve
     (decode = 28 x steps, finalize > 0, chunk 0), mamba2-370m (48
     layers) and recurrentgemma-9b (13 super-blocks) served through
     ``launch.serve.main`` at full width and depth (8 requests, prompt
     256 + 64, 4 slots, chunk 128: tok/s, TTFT, peak memory, launches),
     and the hybrid's bf16 ``rg_forward`` with impl="pallas" at N = 4096
     (expert launches = 13 x forwards); the chunked qwen3-0.6b serve
     again with ``--chaos-seed 0`` (requests never recomputed equal to
     the plain supervised serve, the recomputed ones' first parting token
     recorded: bf16 recompute parts as in the reference, ROADMAP C.13;
     retries, quarantines, stragglers, tok/s and
     TTFT of both),
     and bf16 chunked serves of tinyllama-1.1b and stablelm-1.6b at full
     width and depth (8 requests, 512 + 64, 4 slots: tok/s, TTFT, peak
     memory, the serving kernels' launches);
  the vision families (run inside phases 2, 3 and 4): B.4 on the
     bidirectional routing of a real layer at the ViT-B/16's shape (lead
     [4, 12, 1], m = K = 49, NS 196) and whisper-tiny's encoder's (lead
     [4, 6, 1], m 25, K 64, NS 1500), both dtypes against the plain
     version with a dropped-keys control; the float32 ViT-B/16 (12
     layers, B 4, N 196) pallas against sorted at span = m layer by layer
     and in the logits' argmax, a pool2d ((14, 14) -> (7, 7)) attention
     call and a random-landmark forward held to the same calls on the
     CPU; whisper-tiny at full width and depth in float32: the encoder
     layer by layer, 448 greedy decode steps from token 50258 held to
     ``whisper_decode_train`` on the emitted stream (logits within 1e-4);
     bf16 ViT images/s at B 64 x N 196 and B 8 x N 1024, whisper-tiny's
     encode ms and decode tok/s, peak memory, B.4 launches = 12 x ViT
     forwards and 4 x whisper encodes;
  then the MoE family, run last: B.1-B.3 at the d-128 decode
     shapes of deepseek-moe-16b (Hkv 16, G 1), dbrx-132b (Hkv 8, G 6)
     and internvl2-76b (Hkv 8, G 8) in both dtypes as at d 64, and B.4 at
     deepseek-moe-16b's forward lead [1, 16, 1]; deepseek-moe-16b in
     float32 at 4 layers, full width: the chunked supervised serve held
     to `static_generate` (capacity factor raised so nothing drops),
     `moe_apply` on the card against the CPU on the serve's chunk inputs
     at the real factor 1.25 (picks, slots, kept assignments exact away
     from router near-ties; outputs within 1e-5), the forward's routed
     partials layer by layer; then in bf16 at full width and depth (28
     layers, 62.9 GiB of float32 weights) through
     ``launch.serve.main``: 8 requests, 512 + 160, 4 slots, chunk 256
     (tok/s, TTFT, peak memory < 80 GB, decode = 28 x steps, chunk = 28 x
     dispatches, finalize > 0) and a ``lm_forward(impl="pallas")`` at
     N = 4096 (tok/s, expert launches = 28 x forwards);
  then training (``phase_training``, no port kernel on its path), run
     last: ``python -m repro_torch.launch.train --data-parallel 1
     --model-parallel 1`` as a subprocess (its cuBLAS workspace setting
     must come before CUDA starts; a 1 x 1 mesh over a one-rank ``nccl``
     group, DTensor parameters and moments) at
     qwen3-0.6b's full width and depth in the production dtypes (f32
     params, bf16 compute, remat), B 4 x 4096, 6 steps, a checkpoint
     every 3 (step ms, tokens/s, peak memory; every loss finite, the last
     below the first); the same at 4 layers, 6 uninterrupted steps
     against a run that fails at step 4 and resumes (final checkpoints
     equal bit for bit: params, mu, nu, step); one float32 train step of
     each family's smoke config card vs CPU (loss within 1e-5, every
     gradient leaf within 1e-4 of its max) and qwen3-0.6b's microbatch 2
     vs 1; the five kernels' launch counters 0 over the phase;
  then vision training (``phase_vision_training``, no port kernel on its
     path): ViT-B/16 (12 layers, d 768, m = k = 49) in f32 params / bf16
     compute on ``synthetic_vision_batch`` B 64 x 224^2 drawn on the
     card, 12 AdamW steps (step ms, images/s, peak memory, losses
     finite), and ``benchmarks/tables.py``'s ``_train_vit`` recipe (tiny
     ViT, 60 steps, float32, deterministic algorithms) on the card and
     the CPU from the same
     parameters (first 10 losses within 1e-4, both eval accuracies);
  then distribution (``phase_distributed``, one rank: NCCL runs no two
     ranks on one device): the training phase's full-width CLI run (the
     1 x 1 mesh path) against ``train_step`` on plain tensors in this
     process (3 steps from the same seed and batches, losses within 1e-5
     relative, step ms and peak memory beside it), the CLI at 4 layers
     under ``torch.distributed.run`` against its lone start, and
     ``compressed_grad_mean`` over ``nccl`` on a full-size qwen3-0.6b
     gradient tree (bit for bit one quantization and its residual);
  then the dry run (``phase_dryrun``, no port kernel on its path): the
     fake process group imports; the dry-run CLI in three subprocesses at
     once (qwen3-0.6b ``train_4k`` on 16 x 16 and 2 x 16 x 16 fake ranks,
     deepseek-moe-16b ``decode_32k`` on 16 x 16; traced on fake ``cuda``
     tensors; each record ``ok``); and a 1 x 1 calibration on the card:
     the dry run of qwen3-0.6b at B 4 x 4096 against ``FlopCounterMode``
     over one real ``train_step`` (FLOPs equal) and the training phase's
     peak memory (within 10%) and step ms (MFU printed beside the card's
     name and power limit);
  then tensor parallel (``phase_tensor_parallel``, no port kernel on its
     path): qwen3-0.6b ``train_4k`` and ``prefill_32k`` traced on 16 x
     16 fake ``cuda`` ranks with the dense cells split over "model"
     (per-rank FLOPs, peak, collectives by kind and the time terms beside
     the gather-once numbers; ``train_4k`` at most 0.25 of the FLOPs and
     half the peak); one train step and one prefill of qwen3-0.6b at full
     width and depth (float32 compute) on a 1 x 2 ``gloo`` group of two
     processes on the card against the 1 x 1 path here, with full
     attention under every tolerance and with MiTA up to the first layer
     whose top-K picks part, those picks proven near ties;
  then expert parallel (``phase_expert_parallel``, no port kernel on its
     path): deepseek-moe-16b ``train_4k`` / ``prefill_32k`` and
     internvl2-76b ``train_4k`` traced on 16 x 16 fake ``cuda`` ranks
     (started before the dry-run phase, traced on the host beside it and
     the tensor-parallel phase) with the moe family expert-parallel and
     the vlm's LM split over "model" (deepseek ``train_4k`` at most 0.25 of the
     gather-once FLOPs and under 80 GiB and half the gather-once peak,
     internvl2 at most 0.25 of its FLOPs, no collective from the
     gather-once path; internvl2 at 8 of its 80 layers); one train step
     and one prefill of deepseek-moe-16b at full width, 4 layers (float32
     compute, full attention) on a 1 x 2 ``gloo`` group of two processes
     on the card, 32 experts each, against the 1 x 1 path here, under
     every tolerance or up to the first layer whose router pick sets
     part, those proven near ties (a token whose first pick alone
     differs, a near tie too, moves the router's gradient by what the
     load-balance loss predicts for it, which the check adds);
  then the hybrid split (``phase_hybrid_split``, no port kernel on its
     path): recurrentgemma-9b ``train_4k`` / ``prefill_32k`` traced on
     16 x 16 fake ``cuda`` ranks (started before the expert-parallel
     phase, traced beside it) with RG-LRU channels split over "model"
     (both at most 0.25 of the gather-once FLOPs, ``train_4k`` under 80
     GiB, no collective from the gather-once path); one train step and
     one prefill of recurrentgemma-9b at full width, one super-block
     (float32 compute, MiTA) on a 1 x 2 ``gloo`` group against the 1 x 1
     path, under every tolerance or up to the first attention layer
     whose MiTA picks part, those proven near ties;
  5. summary: one JSON line of per-kernel results (launches from each
     kernel's main path: the spec_k = 3 serve for the serving kernels,
     with the plain chunked serve's beside them, the bf16 full-sequence
     path for the expert kernel, 0 for flash attention, which no model
     path calls; B.1-B.3 also carry their launches on the supervised and
     dense paths and their head-dim-64 rows, and the MoE paths' launches
     and d-128 shape rows; B.4 its ``vit`` and ``whisper_encoder``
     sub-rows; plus the sampler's, the spec serve's, the chaos gates', the
     new serves', the vision phases' and the training phase's numbers),
     then
     the final line
     ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or the
repository's ``src/`` is missing.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time
import types
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
PARITY_LAYERS = 4     # depth of the earlier slices' f32 serves (from 28)
LAYER_TOL = 1e-5      # float32 routed partials, expert kernel vs span = m
LOSS_TOL = 1e-3       # float32 lm_loss (nats), pallas vs sorted span = m
PREFILL_LOGIT_TOL = 1e-4  # float32 first-token logits, engine vs lm_prefill


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5, setup=None) -> float:
    """Mean device time of one ``fn()`` with a cold L2: a 64 MiB write
    before each timed call evicts the 50 MB L2, as the decode step does
    (each layer's state is reached after the other layers' weights).
    ``setup()``, where given, runs before each call, outside the timed
    span (it restores inputs that a call consumes)."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    setup = setup or (lambda: None)
    for _ in range(warmup):
        setup()
        fn()
    marks = []
    for _ in range(iters):
        setup()
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


_SPIN_CYCLES_PER_S: list = []


def _spin_cycles_per_s() -> float:
    """Clock rate of ``torch.cuda._sleep``'s spin kernel, measured once."""
    if not _SPIN_CYCLES_PER_S:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_S.append(1e7 / (start.elapsed_time(end) / 1e3))
    return _SPIN_CYCLES_PER_S[0]


def card_ms(fn, iters: int = 50, warmup: int = 5, setup=None) -> float:
    """As `cuda_ms`, but each timed call is queued behind a spin kernel
    that outlasts the host's time to issue it, so the events time the
    card's work alone.  `cuda_ms` also counts the host's launch cost
    where the host issues a call more slowly than the card runs it; the
    ``card_ms`` field of the kernels line is this number, ``ms`` is
    `cuda_ms`'s."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    setup = setup or (lambda: None)
    for _ in range(warmup):
        setup()
        fn()
    setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(_spin_cycles_per_s() * (2 * host_s + 50e-6))
    marks = []
    for _ in range(iters):
        setup()
        scrub.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def _trace_twice(fn):
    """One profiler session: warm-up calls and small kernels, then twice a
    marker kernel (``torch.cuda._sleep``'s ``spin_kernel``) and the call.
    Returns the [(kernel name, blocks in its grid)] of the two calls, or
    None where a marker is missing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    warm = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        for _ in range(32):
            warm.add_(1)
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
        torch.cuda.synchronize()
    path = HERE / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    marks = [i for i, e in enumerate(kernels) if "spin_kernel" in e["name"]]
    if len(marks) < 2:
        return None
    calls = (kernels[marks[-2] + 1:marks[-1]], kernels[marks[-1] + 1:])
    return [[(e["name"], int(np.prod(e["args"]["grid"]))) for e in c]
            for c in calls]


def traced_kernels(fn) -> list:
    """The CUDA kernels that one ``fn()`` launches, read from a profiler
    trace: [(kernel name, blocks in its grid)].  A session can miss kernel
    records (on the card this was written for: the first ones of a session
    after the first in a process, and now and then others), so a session
    traces the call twice, each time after a marker kernel, and counts
    only when both markers are there and both calls show the same kernels;
    otherwise the trace is taken again, up to 4 times."""
    for _ in range(4):
        calls = _trace_twice(fn)
        if calls is not None and calls[0] == calls[1] and calls[0]:
            return calls[0]
    fail("four profiler traces of a call disagree or miss their markers")


def host_ms(fn, iters: int = 20) -> float:
    """Mean host time to issue one ``fn()`` (the card idle before it)."""
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def record_text(rec: dict) -> str:
    return (f"card {rec['card_ms']:.4f} ms, host {rec['host_ms']:.4f} ms; "
            f"traced launches {rec['cuda_kernels']} of {rec['grid_blocks']} "
            "blocks")


def kernel_record(kern, iters: int = 50, setup=None) -> dict:
    """`card_ms` and `host_ms` of ``kern``, and what one call launches,
    from its trace."""
    launched = traced_kernels(kern)
    return dict(card_ms=card_ms(kern, iters=iters, setup=setup),
                host_ms=host_ms(kern),
                cuda_launches_per_call=len(launched),
                cuda_kernels=[re.search(r"(\w+)[<(]", n).group(1)
                              for n, _ in launched],
                grid_blocks=[b for _, b in launched])


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
    for stem in ("mita_paged_attn", "mita_paged_finalize",
                 "mita_chunk_prefill", "mita_expert_attn", "flash_attn"):
        for line in _build.ptxas_report(stem).splitlines():
            if any(k in line for k in ("Used", "spill", "Compiling entry")):
                print(f"ptxas[{stem}] {line.strip()}")
    return smi


# ------------------------------------------------------------ phase 2 ------

def make_state(dtype, seed=0, S=S, M=M):
    """Random paged state at the serving shapes (``S`` slots of ``M``
    pages) over a shuffled table."""
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
    S, M = st.lm_q.shape[0], st.lm_q.shape[2]
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


def finalize_bound(st, t_new, due, dtype):
    """Least bytes and operations of one finalize call on this data: a due
    slot that commits reads its visible K and V rows once and writes its
    landmark, expert rows and q_sum; one that commits nothing only zeroes
    its q_sum."""
    S, _, M, _ = st.lm_q.shape
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = S * 9
    ops = 0
    for tn, dv in zip(t_new.cpu().numpy(), due.cpu().numpy()):
        if not dv:
            continue
        if not 0 <= tn // W - 1 < M:
            nbytes += HKV * D * 4
            continue
        nvis = min(int(tn), M * W)
        nbytes += HKV * (2 * nvis * D * es + 2 * D * 4 + M * 4
                         + 2 * D * es + K * 5)
        ops += HKV * (4 * nvis * D + K * nvis)
    return nbytes, ops


def bound_ms(nbytes, ops, dtype):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


LONG_S, LONG_M = 32, 32      # B.1's long-context check: 4096 tokens


def paged_attn_cases(dtype):
    """B.1's two checks: the serving shape (ragged t, an inactive slot),
    then S = 32 slots of M = 32 pages (4096 tokens of context), where
    S * Hkv alone fills the card.  Yields (what, state, t, active)."""
    dev = "cuda"
    t = torch.tensor([130, 300, 0, 767], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    yield "serving", make_state(dtype, seed=1), t, active
    state = make_state(dtype, seed=3, S=LONG_S, M=LONG_M)
    g = torch.Generator(device=dev).manual_seed(4)
    t = torch.randint(0, LONG_M * W, (LONG_S,), generator=g,
                      device=dev).to(torch.int32)
    active = torch.rand(LONG_S, generator=g, device=dev) > 0.1
    yield f"long context S={LONG_S} M={LONG_M}", state, t, active


def check_paged_attn(dtype, what, state, t, active, mod=None):
    """The paged-decode kernel of ``mod`` (default: this tree's) against
    this tree's plain version (outputs within TOL, pools exact), then
    timed beside it; its launches and grids read from a trace."""
    from repro_torch.kernels import mita_paged_attn as plain
    mpa = mod or plain
    st, table, q, kn, vn = state
    m_cnt = t // W
    tol = TOL[dtype]
    # the plain reference runs on float32 copies of the same values
    a, b = clone_state(st, torch.float32), clone_state(st)
    ref = plain.paged_attention_plain(
        q.float(), kn.float(), vn.float(), a.lm_q, a.lm_v, a.expert_idx,
        a.expert_valid, a.k_pool, a.v_pool, table, t, active, m_cnt,
        window=W, n_route=1, fuse_append=True)
    out = mpa.mita_paged_attention(
        q, kn, vn, b.lm_q, b.lm_v, b.expert_idx, b.expert_valid, b.k_pool,
        b.v_pool, table, t, active, m_cnt, window=W, n_route=1,
        fuse_append=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
        fail(f"mita_paged_attention {what} {dtype} max_abs_err {err}")
    for pool in ("k_pool", "v_pool"):
        if not torch.equal(getattr(a, pool)[:-1],
                           getattr(b, pool)[:-1].float()):
            fail(f"mita_paged_attention {what} {dtype} {pool} rows differ")
    kern = lambda: mpa.mita_paged_attention(  # noqa: E731
        q, kn, vn, b.lm_q, b.lm_v, b.expert_idx, b.expert_valid, b.k_pool,
        b.v_pool, table, t, active, m_cnt, window=W, n_route=1,
        fuse_append=True)
    a = clone_state(st)
    pl = lambda: plain.paged_attention_plain(  # noqa: E731
        q, kn, vn, a.lm_q, a.lm_v, a.expert_idx, a.expert_valid, a.k_pool,
        a.v_pool, table, t, active, m_cnt, window=W, n_route=1,
        fuse_append=True)
    ms, pms = cuda_ms(kern), cuda_ms(pl)
    rec = kernel_record(kern)
    bms, by = bound_ms(*attn_bound(st, q, t, active, m_cnt, dtype), dtype)
    print(f"mita_paged_attention {what} {dtype}: max_abs_err {err:.3e} "
          f"(tol {tol}), kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{bms:.5f} ms ({by}); {record_text(rec)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, tol=tol, **rec)


def finalize_cases(dtype):
    """B.2's checks.  Yields (what, state, t_new, due, near_ties): the
    serving shape (one slot not due); S = 32 slots of M = 32 pages (4096
    tokens of context: several sort slices), ragged t_new, some slots not
    due, a due slot whose context holds fewer than K positions (it commits
    nothing and zeroes its q_sum) and a full one, twice: with real-valued
    keys, where another summation order can swap two positions whose scores
    differ by float32 rounding (``near_ties``: such rows pass, see
    `pick_gaps`), and with its keys and landmark queries moved to a grid of
    1/4, so every score is exact in float32 in any order and the picks must
    equal the plain version's bit for bit; exact ties, with integer keys
    from three distinct rows per head and integer landmark queries, so
    every tie group spans splits."""
    dev = "cuda"
    t_new = torch.tensor([256, 640, 300, 768], dtype=torch.int32, device=dev)
    due = torch.tensor([True, True, False, True], device=dev)
    yield "serving", make_state(dtype, seed=2), t_new, due, False
    state = make_state(dtype, seed=5, S=LONG_S, M=LONG_M)
    g = torch.Generator(device=dev).manual_seed(6)
    t_new = torch.randint(0, LONG_M * W + 1, (LONG_S,), generator=g,
                          device=dev).to(torch.int32)
    due = torch.rand(LONG_S, generator=g, device=dev) > 0.25
    t_new[:2] = torch.tensor([K - 28, LONG_M * W], dtype=torch.int32)
    due[:2] = True
    what = f"long context S={LONG_S} M={LONG_M}"
    yield f"{what} real-valued", state, t_new, due, True
    st = clone_state(state[0])
    st.k_pool.copy_((st.k_pool.float() * 4).round() / 4)
    st.q_sum.copy_((st.q_sum * 4 / W).round() * W / 4)
    yield what, (st, *state[1:]), t_new, due, False
    st, table, q, kn, vn = make_state(dtype, seed=7)
    base = torch.randint(-3, 4, (3, HKV, D), generator=g, device=dev)
    pick = torch.randint(0, 3, (st.k_pool.shape[0],), generator=g,
                         device=dev)
    st.k_pool.copy_(base[pick])
    st.q_sum.copy_(torch.randint(-3, 4, st.q_sum.shape, generator=g,
                                 device=dev) * W)
    t_new = torch.tensor([768, 640, 512, 384], dtype=torch.int32, device=dev)
    due = torch.ones(S, dtype=torch.bool, device=dev)
    yield "exact ties", (st, table, q, kn, vn), t_new, due, False


FIN_FIELDS = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum")


def pick_gaps(a, b):
    """For each expert row where the kernel's pick (state ``b``) differs
    from the plain version's (``a``): the gap between the two picks'
    scores, in float64 from the plain version's landmark query, and the
    most that float32 rounding can make of such a gap.  A float32 dot
    product of D terms in any summation order, then the divide by
    sqrt(D), errs by at most (D + 1) u sum|k q| / sqrt(D) (u = 2^-24); two
    implementations that rank a pair differently can each err so on each
    of its two scores, hence twice that, on the larger sum of the two."""
    s_, h_, m_, r_ = (b.expert_idx != a.expert_idx).nonzero().T
    q = a.lm_q[s_, h_, m_].double()

    def terms(x):
        rows = x[s_, h_, m_, r_].long()
        return a.k_pool[rows, h_].double() * q

    ta, tb = terms(a.expert_idx), terms(b.expert_idx)
    gap = (ta.sum(-1) - tb.sum(-1)).abs() / D ** 0.5
    mag = torch.maximum(ta.abs().sum(-1), tb.abs().sum(-1)) / D ** 0.5
    return gap, 2 * (D + 1) * 2.0 ** -24 * mag


def finalize_vs_plain(mod, dtype, state, t_new, due, near_ties=False):
    """One call of ``mod``'s finalize kernel on a copy of the state against
    this tree's plain version on float32 copies, the landmark query
    rounded as the kernel rounds it.  Returns (max_abs_err of lm_q, lm_v
    and q_sum, expert-row mismatches, validity mismatches, the largest
    score gap of a differing pair over its rounding bound (0 where none
    differs), the first failure or None): floats within TOL, validity
    exact, slots not due bit-identical, and expert rows exact -- with
    ``near_ties``, a row may differ where its two picks' scores lie within
    float32 rounding of each other (`pick_gaps`), and no other."""
    from repro_torch.kernels import mita_paged_finalize as plain
    st, table, _, _, _ = state
    tol = TOL[dtype]
    a, b = clone_state(st, torch.float32), clone_state(st)
    plain.paged_finalize_plain(a.q_sum, a.lm_q, a.lm_v, a.expert_idx,
                               a.expert_valid, a.k_pool, a.v_pool, table,
                               t_new, due, window=W, k_width=K,
                               round_dtype=dtype)
    mod.mita_paged_finalize_fused(b.q_sum, b.lm_q, b.lm_v, b.expert_idx,
                                  b.expert_valid, b.k_pool, b.v_pool, table,
                                  t_new, due, window=W, k_width=K)
    torch.cuda.synchronize()
    errs = {f: (getattr(b, f).float() - getattr(a, f).float()).abs().max()
            .item() for f in ("lm_q", "lm_v", "q_sum")}
    idx = int((b.expert_idx != a.expert_idx).sum())
    val = int((b.expert_valid != a.expert_valid).sum())
    bad = [f"{f} max_abs_err {e}" for f, e in errs.items()
           if not torch.allclose(getattr(b, f).float(), getattr(a, f).float(),
                                 atol=tol, rtol=tol)]
    gap = ratio = 0.0
    if idx:
        gaps, bounds = pick_gaps(a, b)
        gap, ratio = gaps.max().item(), (gaps / bounds).max().item()
    if val or (idx and not (near_ties and ratio <= 1.0)):
        bad.append(f"integer outputs differ: {idx} rows, {val} validity "
                   f"flags (largest score gap of a differing pair {gap:.3e}, "
                   f"{ratio:.3g} x its float32 rounding bound)")
    nd = ~due
    bad += [f"non-due slot field {f} changed" for f in FIN_FIELDS
            if not torch.equal(getattr(b, f)[nd], getattr(st, f)[nd])]
    return max(errs.values()), idx, val, ratio, "; ".join(bad) or None


def check_finalize(dtype, case, mod=None, strict=True):
    """The finalize kernel of ``mod`` (default: this tree's) against this
    tree's plain version on one of `finalize_cases`, then timed beside it;
    its launches and grids read from a trace.  ``strict=False`` records a
    failed check under ``check_failed`` instead of failing (the A/B tool
    times a parent kernel that a new check may reject).

    A call zeroes the due slots' q_sum, and a repeated call on that state
    scores an all-zero landmark query: every score ties, the radix select's
    worst case.  ``ms`` and ``card_ms`` give each timed call its q_sum
    back; ``card_ms_reused`` times repeated calls on one state without
    it, the timing that the kernels line's finalize row had before the
    timers took a ``setup``."""
    from repro_torch.kernels import mita_paged_finalize as plain
    mod = mod or plain
    what, state, t_new, due, near_ties = case
    tol = TOL[dtype]
    err, idx, val, ratio, bad = finalize_vs_plain(mod, dtype, state, t_new,
                                                  due, near_ties)
    if bad and strict:
        fail(f"mita_paged_finalize_fused {what} {dtype}: {bad}")
    st, table = state[0], state[1]
    c = clone_state(st)
    kern = lambda: mod.mita_paged_finalize_fused(  # noqa: E731
        c.q_sum, c.lm_q, c.lm_v, c.expert_idx, c.expert_valid, c.k_pool,
        c.v_pool, table, t_new, due, window=W, k_width=K)
    pl = lambda: plain.paged_finalize_plain(  # noqa: E731
        c.q_sum, c.lm_q, c.lm_v, c.expert_idx, c.expert_valid, c.k_pool,
        c.v_pool, table, t_new, due, window=W, k_width=K)
    setup = lambda: c.q_sum.copy_(st.q_sum)  # noqa: E731
    ms, pms = cuda_ms(kern, setup=setup), cuda_ms(pl, iters=10, setup=setup)
    rec = kernel_record(kern, setup=setup)
    reused = card_ms(kern)
    bms, by = bound_ms(*finalize_bound(st, t_new, due, dtype), dtype)
    n_rows = int(due.sum()) * HKV * K
    ties = (f" (near ties: largest gap {ratio:.3g} x its rounding bound)"
            if near_ties and idx else "")
    print(f"mita_paged_finalize_fused {what} {dtype}: max_abs_err "
          f"{err:.3e} (tol {tol}), expert-row mismatches {idx}/{n_rows}"
          f"{ties}, validity mismatches {val}"
          f"{'; CHECK FAILED: ' + bad if bad else ''}, kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {bms:.5f} ms ({by}); "
          f"{record_text(rec)}; card {reused:.4f} ms on a reused state")
    out = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
               bound_by=by, tol=tol, idx_mismatch=idx, valid_mismatch=val,
               gap_over_bound=ratio, card_ms_reused=reused, **rec)
    if bad:
        out["check_failed"] = bad
    return out


def finalize_control(dtype):
    """The control of the finalize check: the kernel's two stages run with
    one split's partials (slot 1, every head, the third of its five
    splits) dropped between them lie outside the tolerance of the plain
    version in ``lm_v``."""
    from repro_torch.kernels import mita_paged_finalize as mpf
    _, (st, table, *_), t_new, due, _ = next(finalize_cases(dtype))
    a, b = clone_state(st, torch.float32), clone_state(st)
    mpf.paged_finalize_plain(a.q_sum, a.lm_q, a.lm_v, a.expert_idx,
                             a.expert_valid, a.k_pool, a.v_pool, table,
                             t_new, due, window=W, k_width=K,
                             round_dtype=dtype)
    call = mpf.prepare(b.q_sum, b.lm_q, b.lm_v, b.expert_idx,
                       b.expert_valid, b.k_pool, b.v_pool, table, t_new, due,
                       window=W, k_width=K)
    mpf.launch_stage(call, mpf.SPLIT)
    parts = mpf.workspace_views(call)
    parts["l"][1, :, 2] = 0.0
    parts["o"][1, :, 2] = 0.0
    mpf.launch_stage(call, mpf.MERGE)
    torch.cuda.synchronize()
    got, want = b.lm_v.float(), a.lm_v.float()
    err = (got - want).abs().max().item()
    tol = TOL[dtype]
    if err <= tol or torch.allclose(got, want, atol=tol, rtol=tol):
        fail(f"finalize {dtype}: the control with one split's partials "
             f"dropped passes the lm_v check (max_abs_err {err})")
    print(f"mita_paged_finalize_fused {dtype}: control with split 2 of "
          f"slot 1 dropped: lm_v max_abs_err {err:.3e}, fails the check "
          f"(tol {tol}), as it must")
    return err


def phase_kernels():
    res = {"attn": {}, "fin": {}}
    for dtype in (torch.float32, torch.bfloat16):
        # --- paged decode attention at the serving and the long-context
        # shape; the serving shape must spread over at least one block
        # per SM
        (what, *case), long_case = paged_attn_cases(dtype)
        r = res["attn"][dtype] = check_paged_attn(dtype, what, *case)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        if r["grid_blocks"][0] < n_sm:
            fail(f"mita_paged_attention: {r['grid_blocks'][0]} blocks for "
                 f"{n_sm} SMs at the serving shape")
        r["long_context"] = check_paged_attn(dtype, *long_case)

        # --- paged finalize: the serving shape, the long context real-
        # valued and on a grid, exact ties; two launches a call (split,
        # merge); the control
        serving, long_real, long_case, ties = finalize_cases(dtype)
        r = res["fin"][dtype] = check_finalize(dtype, serving)
        want = ["finalize_split_kernel", "finalize_merge_kernel"]
        if r["cuda_kernels"] != want:
            fail(f"finalize {dtype}: the trace shows {r['cuda_kernels']}, "
                 f"expected {want}")
        real = check_finalize(dtype, long_real)
        r["long_context_real_valued"] = {
            k: real[k] for k in ("max_abs_err", "idx_mismatch",
                                 "gap_over_bound", "card_ms")}
        r["long_context"] = check_finalize(dtype, long_case)
        r["ties_idx_mismatch"] = check_finalize(dtype, ties)["idx_mismatch"]
        r["control_max_abs_err"] = finalize_control(dtype)
    return res


# ----------------------------------------------------- phase 2 (sampler) ---

SAMPLE_V = 151936           # qwen3-0.6b's vocabulary
GUMBEL_TOL = {torch.float32: 2.0 ** -21,    # 4 float32 ulps of 1 + |g|
              torch.bfloat16: 2.0 ** -7}    # 1 bfloat16 ulp of 1 + |g|
SAMPLE_GAP = 2.0 ** -19


def phase_sampler():
    """The threefry replica and the fused tempered sampler on the card
    against the same calls on CPU copies: threefry words and the per-slot
    keys exact, gumbel within GUMBEL_TOL in both dtypes, tokens equal
    wherever the CPU's top-2 gap of gumbel + logits / T clears SAMPLE_GAP
    relative.  Then the time of one fused tempered sample over
    [S, SAMPLE_V] bf16 logits (CUDA events) and its CUDA launches (trace).
    Returns the record."""
    from repro_torch import prng
    from repro_torch.models.transformer import sample_tokens

    rng = np.random.default_rng(9)
    rid = rng.integers(0, 2 ** 31, S).astype(np.int32)
    idx = rng.integers(0, 4096, S).astype(np.int32)
    temp = np.full(S, 0.8, np.float32)
    rec = {"gumbel_err_f32": 0.0, "gumbel_err_bf16": 0.0,
           "near_tie_rows_f32": 0, "near_tie_rows_bf16": 0}
    for seed in (0, 1):
        key = prng.PRNGKey(seed)
        keys = {dev: prng.fold_in(prng.fold_in(
            key.to(dev), torch.as_tensor(rid, device=dev)),
            torch.as_tensor(idx, device=dev)) for dev in ("cpu", "cuda")}
        if not torch.equal(keys["cuda"].cpu(), keys["cpu"]):
            fail("fold_in keys differ between the card and the CPU")
        words = {dev: prng.random_bits(k, 32, (SAMPLE_V,))
                 for dev, k in keys.items()}
        if not torch.equal(words["cuda"].cpu(), words["cpu"]):
            n = int((words["cuda"].cpu() != words["cpu"]).sum())
            fail(f"threefry words differ at {n} of {S * SAMPLE_V}")
        for dtype in (torch.float32, torch.bfloat16):
            g = {dev: prng.gumbel(k, (SAMPLE_V,), dtype).float().cpu()
                 for dev, k in keys.items()}
            err = ((g["cuda"] - g["cpu"]).abs()
                   / (1 + g["cpu"].abs())).max().item()
            if err > GUMBEL_TOL[dtype]:
                fail(f"gumbel {dtype}: card vs CPU {err:.3e} relative to "
                     f"1 + |g| > {GUMBEL_TOL[dtype]:.3e}")
            lg = torch.randn(S, SAMPLE_V, generator=torch.Generator()
                             .manual_seed(seed)).mul_(3).to(dtype)
            tok = {dev: sample_tokens(lg.to(dev), rid, idx, temp, key).cpu()
                   for dev in ("cpu", "cuda")}
            z = g["cpu"] + lg.float() / 0.8
            top2 = torch.topk(z.double(), 2, dim=-1).values
            clear = ((top2[:, 0] - top2[:, 1])
                     > SAMPLE_GAP * (1 + top2[:, 0].abs())).numpy()
            bad = (tok["cuda"] != tok["cpu"]).numpy() & clear
            if bad.any():
                fail(f"sample_tokens {dtype}: card and CPU tokens differ "
                     f"in rows {np.nonzero(bad)[0]} away from near-ties")
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            rec[f"gumbel_err_{name}"] = max(rec[f"gumbel_err_{name}"], err)
            rec[f"near_tie_rows_{name}"] += int((~clear).sum())

    lg = torch.randn(S, SAMPLE_V, device="cuda").mul_(3).bfloat16()
    key = prng.PRNGKey(0)

    def sample():
        return sample_tokens(lg, rid, idx, temp, key)

    rec["cuda_launches_per_call"] = len(traced_kernels(sample))
    rec["card_ms"] = card_ms(sample, iters=20)
    rec["host_ms"] = host_ms(sample)
    rec["ms"] = cuda_ms(sample, iters=20)
    greedy = np.zeros(S, np.float32)
    rec["greedy_ms"] = cuda_ms(
        lambda: sample_tokens(lg, rid, idx, greedy, key), iters=20)
    print(f"sampler: threefry words and keys equal on the card and the CPU "
          f"over [{S}, {SAMPLE_V}] (2 keys); gumbel card vs CPU "
          f"{rec['gumbel_err_f32']:.3e} (f32) / {rec['gumbel_err_bf16']:.3e} "
          f"(bf16) relative to 1 + |g|; tokens equal away from near-ties "
          f"({rec['near_tie_rows_f32']} / {rec['near_tie_rows_bf16']} "
          f"near-tie rows); one fused tempered sample over [{S}, "
          f"{SAMPLE_V}] bf16: {rec['ms']:.4f} ms (card {rec['card_ms']:.4f} "
          f"ms, host {rec['host_ms']:.4f} ms, "
          f"{rec['cuda_launches_per_call']} CUDA launches); greedy "
          f"{rec['greedy_ms']:.4f} ms")
    return rec


# ------------------------------------------------------- phase 2 (chunk) ---

NC = 256                            # prefill chunk of the serving cell
# rows of the two chunk calls: (t0, n_valid, n_train, active)
CHUNK_SETS = {
    # a fresh chunk, a resumed chunk, the last chunk of a non-aligned
    # prompt (n_train 320: m = 2, w' = 160) and an inactive row
    "serve": [(0, 256, 512, True), (256, 256, 512, True),
              (256, 64, 320, True), (256, 256, 512, False)],
    # preemption recompute (prompt 300 + generated, and prompt 384 +
    # generated), a fresh non-aligned chunk and an inactive row
    "recompute": [(256, 256, 300, True), (256, 256, 384, True),
                  (0, 256, 320, True), (0, 0, 1, False)],
}
CHUNK_KW = dict(window=W, k_width=K, n_route=1, external_finalize=True)
CHUNK_FIELDS = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum",
                "pre_lm_q", "pre_q_sum")


def chunk_inputs(dtype, rows, seed, M=M, int_values=False):
    """Random compact row state over a shuffled page table, at the serving
    shapes of qwen3-0.6b (P=4, Hkv=8, G=2, nc=256, d=128, M=6, K=128).
    ``int_values``: queries, keys and values are small integers and the
    keys take only three distinct rows, so scores tie exactly and are
    exact in any summation order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    p_rows = len(rows)
    n_pages = 2 * p_rows * M
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : p_rows * M].reshape(p_rows, M).to(torch.int32)

    def rnd(*shape, scale=1.0, dt=dtype):
        x = torch.randn(shape, generator=g, device=dev) * scale
        return (x.round().clamp(-4, 4) if int_values else x).to(dt)

    st = dict(
        lm_q=rnd(p_rows, HKV, M, D), lm_v=rnd(p_rows, HKV, M, D),
        expert_idx=(table.long()[:, None, :, None] * W + torch.randint(
            0, W, (p_rows, HKV, M, K), generator=g, device=dev)).to(
                torch.int32),
        expert_valid=torch.rand((p_rows, HKV, M, K), generator=g,
                                device=dev) > 0.2,
        q_sum=rnd(p_rows, HKV, D, scale=W, dt=torch.float32),
        pre_lm_q=rnd(p_rows, HKV, M, D),
        pre_q_sum=rnd(p_rows, HKV, D, scale=W, dt=torch.float32))
    rows_total = n_pages * W + 1
    pools = [rnd(rows_total, HKV, D), rnd(rows_total, HKV, D)]
    q = rnd(p_rows, HKV, G, NC, D)
    k = rnd(p_rows, HKV, NC, D)
    v = rnd(p_rows, HKV, NC, D)
    if int_values:      # three distinct key rows per head
        # the two landmark systems agree, as the engine keeps them
        st["pre_lm_q"] = st["lm_q"].clone()
        base = rnd(3, HKV, D)
        pick = torch.randint(0, 3, (rows_total,), generator=g, device=dev)
        pools[0] = base[pick].contiguous()
        k = base[torch.randint(0, 3, (p_rows, NC), generator=g,
                               device=dev)].transpose(1, 2).contiguous()
    t0, nv, ntr, act = (torch.tensor(c, device=dev) for c in zip(*rows))
    sched = (table, t0.to(torch.int32), nv.to(torch.int32),
             ntr.to(torch.int32), act.to(torch.bool))
    return q, k, v, st, tuple(pools), sched


def chunk_bound(rows, dtype):
    """Least bytes and operations of one chunk call on these rows: each
    input the function needs read once (the chunk, the context rows before
    t0, the rows' state), each output written once (appended rows, the
    output, the state); operations of the landmarks the chunk builds and
    of every valid position's shared, routed and local branches."""
    es = torch.tensor([], dtype=dtype).element_size()
    state = 2 * HKV * (3 * M * D * es + M * K * 5 + 2 * D * 4)
    nbytes = 0
    ops = 0
    for t0, nv, ntr, act in rows:
        if not act:
            continue
        new_end = t0 + nv
        m_tr = ntr // W
        m_a = max(m_tr, 1)
        w_a = max(ntr // m_a, 1)
        nbytes += HKV * (G * nv * D * es * 2       # q in, out
                         + 2 * nv * D * es * 2     # k, v in; pool rows out
                         + 2 * t0 * D * es) + state
        for li in range(M):
            ends_b = (li + 1) * w_a if li < m_tr else (li + 1) * W
            if t0 < ends_b <= new_end:              # B commit
                ops += HKV * 4 * ends_b * D
            ends_a = (li + 1) * w_a
            if li < m_a and ends_a <= min(new_end, ntr):   # A products
                ops += HKV * 4 * ends_a * D
        for pos in range(t0, new_end):
            tr = pos < ntr
            if tr:
                n_lm = sum(1 for li in range(m_a) if (li + 1) * w_a <= pos + 1)
                start = (pos // w_a) * w_a
            else:
                n_lm = sum(1 for li in range(M) if (li + 1) * W <= pos)
                start = (pos // W) * W
            keys = n_lm + (K if n_lm else 0) + (pos - start + 1)
            ops += HKV * G * 4 * D * keys
    return nbytes, ops


def chunk_vs_plain(mod, dtype, rows, inputs, what, state=None,
                   near_ties=False):
    """One call of ``mod``'s chunk kernel against this tree's plain version
    on float32 copies (landmark queries rounded as the kernel rounds
    them): outputs within TOL, pools exact, expert rows and validity
    exact, inactive rows untouched.  ``state`` replaces the kernel's state
    input.  ``near_ties`` (real-valued keys): an expert row may differ
    where its two picks' scores lie within float32 rounding of each other
    (`pick_gaps`), and no other; the largest such gap over its bound is
    returned under ``"gap_over_bound"``.  Returns (errors, mismatches per
    integer field, the kernel's outputs, the plain version's)."""
    from repro_torch.kernels import mita_chunk_prefill as plain
    q, k, v, st, pools, sched = inputs
    tol = TOL[dtype]
    f32 = {n: (x.float() if x.is_floating_point() else x.clone())
           for n, x in st.items()}
    ka, va = (x.float() for x in pools)
    ref = plain.chunk_prefill_plain(
        q.float(), k.float(), v.float(), *f32.values(), ka, va, *sched,
        **CHUNK_KW, round_dtype=dtype)
    kb, vb = (x.clone() for x in pools)
    got = mod.mita_chunk_prefill_fused(
        q, k, v, *(state or st).values(), kb, vb, *sched, **CHUNK_KW)
    torch.cuda.synchronize()
    act = sched[4].cpu().numpy()
    errs, mism = [], {}
    for r, (t0, nv, ntr, a) in enumerate(rows):
        if not a:
            if got[0][r].abs().max().item() != 0:
                fail(f"chunk kernel {what}: inactive row output")
            continue
        a, b = ref[0][r, :, :, :nv].float(), got[0][r, :, :, :nv]
        errs.append((b.float() - a).abs().max().item())
        if not torch.allclose(b.float(), a, atol=tol, rtol=tol):
            fail(f"chunk kernel {what} {dtype} row {r} output "
                 f"max_abs_err {errs[-1]}")
    for pool_a, pool_b, pn in ((ka, kb, "k_pool"), (va, vb, "v_pool")):
        if not torch.equal(pool_a[:-1], pool_b[:-1].float()):
            fail(f"chunk kernel {what} {dtype} {pn} rows differ")
    for i, f in enumerate(CHUNK_FIELDS):
        a, b = ref[1 + i], got[1 + i]
        if f in ("expert_idx", "expert_valid"):
            # exact in both dtypes: the plain version rounds the landmark
            # queries as the kernel does
            mism[f] = int((a.int() != b.int()).sum())
            ratio = 0.0
            if mism[f] and near_ties and f == "expert_idx":
                gaps, bounds = pick_gaps(
                    types.SimpleNamespace(expert_idx=a, lm_q=ref[1],
                                          k_pool=ka),
                    types.SimpleNamespace(expert_idx=b))
                ratio = (gaps / bounds).max().item()
                mism["gap_over_bound"] = max(mism.get("gap_over_bound", 0.0),
                                             ratio)
                print(f"chunk kernel {what} {dtype}: {mism[f]} expert rows "
                      f"differ at score gaps {gaps.tolist()}, at most "
                      f"{ratio:.4g} x their float32 rounding bound")
            if mism[f] and not (near_ties and f == "expert_idx"
                                and ratio <= 1.0):
                fail(f"chunk kernel {what} {dtype} {f}: {mism[f]} of "
                     f"{a.numel()} differ")
        else:
            errs.append((a.float() - b.float()).abs().max().item())
            if not torch.allclose(b.float(), a.float(), atol=tol, rtol=tol):
                fail(f"chunk kernel {what} {dtype} {f} max_abs_err "
                     f"{errs[-1]}")
        for r in np.nonzero(~act)[0]:
            if not torch.equal(b[r].to(st[f].dtype), st[f][r]):
                fail(f"chunk kernel {what}: inactive row {f} changed")
    return errs, mism, got, ref


def check_chunk(dtype, mod=None, near_ties=False):
    """The chunk-prefill kernel of ``mod`` (default: this tree's) against
    this tree's `chunk_prefill_plain` on both row sets; timed on the
    "serve" set, its launches and names read from a trace.  ``near_ties``
    as in `chunk_vs_plain`."""
    from repro_torch.kernels import mita_chunk_prefill as plain
    mod = mod or plain
    errs, mism = [], {"expert_idx": 0, "expert_valid": 0}
    ratio = 0.0
    for si, (name, rows) in enumerate(CHUNK_SETS.items()):
        inputs = chunk_inputs(dtype, rows, 10 + si)
        e, m, _, _ = chunk_vs_plain(mod, dtype, rows, inputs, name,
                                    near_ties=near_ties)
        errs += e
        ratio = max(ratio, m.get("gap_over_bound", 0.0))
        for f in mism:
            mism[f] += m[f]
        if name == "serve":
            q, k, v, st, pools, sched = inputs
            kb, vb = (x.clone() for x in pools)
            kern = lambda: mod.mita_chunk_prefill_fused(  # noqa: E731
                q, k, v, *st.values(), kb, vb, *sched, **CHUNK_KW)
            pl = lambda: plain.chunk_prefill_plain(  # noqa: E731
                q, k, v, *st.values(), kb, vb, *sched, **CHUNK_KW)
            ms, pms = cuda_ms(kern, iters=20), cuda_ms(pl, iters=5)
            rec = kernel_record(kern, iters=20)
            bms, by = bound_ms(*chunk_bound(rows, dtype), dtype)
    err = max(errs)
    tol = TOL[dtype]
    print(f"mita_chunk_prefill_fused {dtype}: max_abs_err {err:.3e} "
          f"(tol {tol}), expert-row mismatches {mism['expert_idx']}, "
          f"validity mismatches {mism['expert_valid']}, kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {bms:.5f} ms ({by}); "
          f"{record_text(rec)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, tol=tol, idx_mismatch=mism["expert_idx"],
                valid_mismatch=mism["expert_valid"], gap_over_bound=ratio,
                **rec)


# chunk-size invariance: (tokens, n_train) per row -- prompts of 4 and 3
# windows, a prompt of 3 windows followed by a generated window (the
# recompute shape) and a prompt shorter than one window
INVARIANCE_ROWS = [(512, 512), (512, 384), (384, 384), (96, 96)]


def chunked_prefill(dtype, nc, seed=40):
    """Prefill INVARIANCE_ROWS from an empty state in chunks of ``nc``
    through the chunk kernel.  Returns (per-position outputs, final state,
    pools)."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    p_rows, n_tok = len(INVARIANCE_ROWS), max(n for n, _ in
                                              INVARIANCE_ROWS)
    m_slot = n_tok // W
    n_pages = p_rows * m_slot + 2
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : p_rows * m_slot].reshape(p_rows, m_slot).to(torch.int32)
    q = torch.randn((p_rows, HKV, G, n_tok, D), generator=g,
                    device=dev).to(dtype)
    k, v = (torch.randn((p_rows, HKV, n_tok, D), generator=g,
                        device=dev).to(dtype) for _ in range(2))
    pools = [torch.zeros((n_pages * W + 1, HKV, D), dtype=dtype, device=dev)
             for _ in range(2)]
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=dev)  # noqa
    st = [z(p_rows, HKV, m_slot, D), z(p_rows, HKV, m_slot, D),
          z(p_rows, HKV, m_slot, K, dt=torch.int32),
          z(p_rows, HKV, m_slot, K, dt=torch.bool),
          z(p_rows, HKV, D, dt=torch.float32), z(p_rows, HKV, m_slot, D),
          z(p_rows, HKV, D, dt=torch.float32)]
    outs = torch.zeros_like(q)
    ntr = torch.tensor([t for _, t in INVARIANCE_ROWS], dtype=torch.int32,
                       device=dev)
    for t0 in range(0, n_tok, nc):
        nv = torch.tensor([min(max(n - t0, 0), nc) for n, _ in
                           INVARIANCE_ROWS], dtype=torch.int32, device=dev)
        t0s = torch.full((p_rows,), t0, dtype=torch.int32, device=dev)
        out, *st = mcp.mita_chunk_prefill_fused(
            q[:, :, :, t0:t0 + nc], k[:, :, t0:t0 + nc], v[:, :, t0:t0 + nc],
            *st, *pools, table, t0s, nv, ntr, nv > 0, **CHUNK_KW)
        outs[:, :, :, t0:t0 + nc] = out
    torch.cuda.synchronize()
    return outs, st, pools


def chunk_invariance(dtype):
    """Chunks of 128 and of 256 give every position's output, the final
    state and the pools bit for bit (a position's bits depend only on its
    own inputs)."""
    a, b = chunked_prefill(dtype, 128), chunked_prefill(dtype, 256)
    for what, x, y in [("outputs", a[0], b[0])] \
            + list(zip(CHUNK_FIELDS, a[1], b[1])) \
            + [("k_pool", a[2][0], b[2][0]), ("v_pool", a[2][1], b[2][1])]:
        if not torch.equal(x, y):
            n = int((x != y).sum())
            fail(f"chunk kernel {dtype}: chunks of 128 and 256 give "
                 f"different {what} ({n} elements)")
    print(f"mita_chunk_prefill_fused {dtype}: chunks of 128 and 256 give "
          f"bit-identical outputs at every position, state and pools "
          f"(rows {INVARIANCE_ROWS})")


TIE_M = 16                  # 2048 tokens of context: past the sort buffer
TIE_ROWS = [(1792, 256, 2048, True), (768, 256, 1024, True)]


def chunk_ties(dtype):
    """Exact ties: integer queries and keys, three distinct key rows per
    head, landmarks over contexts of 896-2048 positions (beyond one sort
    pass of 896 new keys, so the slices' top-K lists are merged).  The
    kernel's expert rows must equal the plain version's first-index
    top-K."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    inputs = chunk_inputs(dtype, TIE_ROWS, 50, M=TIE_M, int_values=True)
    _, mism, got, ref = chunk_vs_plain(mcp, dtype, TIE_ROWS, inputs,
                                       "ties")
    lanes = int(got[4].sum())
    print(f"mita_chunk_prefill_fused {dtype}: exact ties over contexts "
          f"of up to {TIE_M * W} positions (slice merge): expert rows "
          f"{mism['expert_idx']} and validity {mism['expert_valid']} "
          f"mismatches against the first-index top-K ({lanes} valid "
          f"lanes)")


def chunk_control(dtype):
    """The control of the chunk check: the kernel run with the second
    64-key tile of one routed expert (landmark 0 of row 0, every head, in
    the state the recompute rows route to) made invalid lies outside the
    tolerance of the plain version on the full state."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    rows = CHUNK_SETS["recompute"]
    inputs = chunk_inputs(dtype, rows, 11)
    st = dict(inputs[3])
    st["expert_valid"] = st["expert_valid"].clone()
    st["expert_valid"][0, :, 0, 64:128] = False
    q, k, v, full, pools, sched = inputs
    ref = mcp.chunk_prefill_plain(
        q.float(), k.float(), v.float(),
        *[x.float() if x.is_floating_point() else x for x in full.values()],
        *(x.float() for x in pools), *sched, **CHUNK_KW, round_dtype=dtype)
    got = mcp.mita_chunk_prefill_fused(q, k, v, *st.values(),
                                       *(x.clone() for x in pools), *sched,
                                       **CHUNK_KW)
    torch.cuda.synchronize()
    nv = rows[0][1]
    a, b = ref[0][0, :, :, :nv].float(), got[0][0, :, :, :nv].float()
    err = (a - b).abs().max().item()
    tol = TOL[dtype]
    if err <= tol or torch.allclose(b, a, atol=tol, rtol=tol):
        fail(f"chunk kernel {dtype}: the control with a routed expert's "
             f"second key tile dropped passes the check (max_abs_err "
             f"{err})")
    print(f"mita_chunk_prefill_fused {dtype}: control with keys 64..127 "
          f"of a routed expert dropped: max_abs_err {err:.3e}, fails the "
          f"check (tol {tol}), as it must")
    return err


def phase_chunk_kernel():
    """The chunk-prefill kernel against `chunk_prefill_plain` on both row
    sets, float32 and bfloat16 pools, with the path the trace shows (at
    most three launches, all the kernel's own); chunk-size invariance,
    exact ties and the dropped-tile control."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = res[dtype] = check_chunk(dtype)
        attend = {mcp.TENSOR_CORES: "attend_mma_kernel",
                  mcp.CUDA_CORES: "attend_core_kernel"}[
                      mcp.chunk_path(dtype, D)]
        want = ["append_kernel", "landmark_kernel", attend]
        if r["cuda_kernels"] != want:
            fail(f"chunk kernel {dtype}: the trace shows "
                 f"{r['cuda_kernels']}, expected {want}")
        if dtype == torch.bfloat16 and attend != "attend_mma_kernel":
            fail("chunk kernel bf16: not on the tensor cores")
        r["path"] = mcp.chunk_path(dtype, D)
        chunk_invariance(dtype)
        chunk_ties(dtype)
        r["control_max_abs_err"] = chunk_control(dtype)
    return res


# ---------------------------------------------- phase 2 (full sequence) ---

FWD_N = 4096                        # the forward cell: B = 1, N = 4096
FWD_M = FWD_N // W                  # 32 landmarks / experts


def expert_inputs(dtype, ns, seed, hkv=HKV, g_n=G, d=D):
    """Sub-queries of one forward layer of qwen3-0.6b (lead [1, 8, 2], KV
    lead [1, 8, 1], M = 32, K = d = 128; recurrentgemma-9b's: ``hkv`` 1,
    ``g_n`` 16, ``d`` 256), sorted by expert.  Causal
    routing: position p can route to experts 0 .. (p+1)//W - 1, drawn
    uniformly (early experts take more queries); the first window's
    positions have none (inactive id M), so the sorted tail holds whole
    inactive tiles."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    lead = (1, hkv, g_n)
    vis = (torch.arange(ns, device=dev) + 1) // W            # experts seen
    draw = torch.rand(lead + (ns,), generator=g, device=dev)
    a = torch.where(vis > 0, (draw * vis).long(), FWD_M)
    a = torch.sort(a, dim=-1).values.to(torch.int32)
    q = torch.randn(lead + (ns, d), generator=g, device=dev).to(dtype)
    ke, ve = (torch.randn((1, hkv, 1, FWD_M, K, d), generator=g,
                          device=dev).to(dtype) for _ in range(2))
    valid = torch.rand((1, hkv, 1, FWD_M, K), generator=g, device=dev) > 0.05
    return q, a, ke, ve, valid


def expert_bound(args, dtype):
    """Bytes: q in, o out, assign, each expert tile and validity once per
    KV head, m and l out.  Operations: each active row's score and value
    products over the valid keys of its own expert."""
    q, a, ke, _, valid = args
    d, m = q.shape[-1], ke.shape[-3]
    es = torch.tensor([], dtype=dtype).element_size()
    rows = q.numel() // d
    nbytes = 2 * q.numel() * es + rows * (4 + 8) \
        + 2 * ke.numel() * es + valid.numel()
    n_valid = valid.sum(-1).expand(q.shape[:-2] + (m,))     # [lead..., M]
    keys = torch.where(a < m, torch.gather(n_valid, -1,
                                           a.long().clamp(max=m - 1)), 0)
    return nbytes, 4 * d * int(keys.sum())


def flash_bound(n, nk, causal, dtype, bh=16):
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = bh * (2 * n + 2 * nk) * D * es
    pairs = sum(min(i + 1, nk) for i in range(n)) if causal else n * nk
    return nbytes, 4 * D * bh * pairs


def expert_partials(out):
    """(o / l, m) on the active rows, and l: the JAX kernel tests'
    comparison (o is rounded to the input dtype, and one bf16 ulp of an
    un-normalised o can exceed the tolerance)."""
    o, m, l = (x.float() for x in out)
    act = l > 0
    return (o / l.clamp(min=1e-30)[..., None])[act], m[act], l


def check_expert(dtype, mod=None, shape=None):
    """The routed-expert kernel of ``mod`` (default: this tree's) against
    this tree's plain version at the forward shape (and a ragged NS), P
    rounded to bf16 in the plain version where this tree's kernel rounds
    it; inactive rows exactly empty; timed, its launches and names read
    from a trace.  ``shape``: (Hkv, G, d) of another model's forward
    (default qwen3-0.6b's)."""
    from repro_torch.kernels import mita_expert_attn as plain
    mod = mod or plain
    hkv, g_n, d = shape or (HKV, G, D)
    tol = TOL[dtype]
    errs = []
    round_p = plain.expert_path(dtype, d) == plain.TENSOR_CORES
    for ns, seed in ((FWD_N, 20), (FWD_N - 37, 21)):     # then ragged
        args = expert_inputs(dtype, ns, seed, hkv, g_n, d)
        ref = plain.expert_attention_plain(*args, round_p=round_p)
        got = mod.mita_expert_attention(*args)
        torch.cuda.synchronize()
        if not torch.equal(got[2] > 0, ref[2] > 0):
            fail(f"mita_expert_attention {dtype} NS {ns}: active rows "
                 "differ")
        for name, x, y in zip(("o / l", "m", "l"), expert_partials(got),
                              expert_partials(ref)):
            errs.append((x - y).abs().max().item())
            if not torch.allclose(x, y, atol=tol, rtol=tol):
                fail(f"mita_expert_attention {dtype} NS {ns} {name} "
                     f"max_abs_err {errs[-1]}")
        inactive = args[1] >= FWD_M
        if int(inactive.sum(-1).min()) < 64:
            fail("expert inputs: a lead row without an inactive tile")
        if got[0][inactive].abs().max() != 0 \
                or got[2][inactive].abs().max() != 0 \
                or (got[1][inactive] != torch.finfo(torch.float32).min
                    ).any():
            fail(f"mita_expert_attention {dtype}: inactive rows are not "
                 "empty")
        if ns == FWD_N:
            kern = lambda: mod.mita_expert_attention(*args)  # noqa: E731
            pl = lambda: plain.expert_attention_plain(*args)  # noqa: E731
            ms, pms = cuda_ms(kern, iters=20), cuda_ms(pl, iters=5)
            rec = kernel_record(kern, iters=20)
            bms, by = bound_ms(*expert_bound(args, dtype), dtype)
    err = max(errs)
    print(f"mita_expert_attention {dtype} lead [1, {hkv}, {g_n}] d {d}: "
          f"max_abs_err {err:.3e} (tol "
          f"{tol}), kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{bms:.5f} ms ({by}); {record_text(rec)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, tol=tol, library_ms=None, **rec)


def expert_invariance(dtype):
    """A row's (o, m, l) bits depend only on its own query, expert and
    keys: the forward-shape rows shuffled, and shifted by 17 against the
    64-row tiles, give the sorted run's bits after un-permuting."""
    from repro_torch.kernels import mita_expert_attn as mea
    q, a, ke, ve, valid = expert_inputs(dtype, FWD_N, 20)
    base = mea.mita_expert_attention(q, a, ke, ve, valid)
    g = torch.Generator(device="cuda").manual_seed(22)
    shifted = (torch.arange(FWD_N, device="cuda") + 17) % FWD_N
    for what, perm in (("shuffled", torch.randperm(FWD_N, generator=g,
                                                   device="cuda")),
                       ("shifted", shifted)):
        inv = torch.argsort(perm)
        got = mea.mita_expert_attention(q[..., perm, :], a[..., perm], ke,
                                        ve, valid)
        for name, x, y in (("o", got[0][..., inv, :], base[0]),
                           ("m", got[1][..., inv], base[1]),
                           ("l", got[2][..., inv], base[2])):
            if not torch.equal(x, y):
                fail(f"mita_expert_attention {dtype}: {what} rows give "
                     f"other {name} bits ({int((x != y).sum())} elements)")
    print(f"mita_expert_attention {dtype}: shuffled and shifted rows give "
          f"the sorted run's (o, m, l) bit for bit")


def expert_control(dtype):
    """The control of the expert check: the kernel run with keys 64..127
    of expert 1 made invalid lies outside the tolerance of the plain
    version on the rows that use expert 1."""
    from repro_torch.kernels import mita_expert_attn as mea
    q, a, ke, ve, valid = expert_inputs(dtype, FWD_N, 20)
    round_p = mea.expert_path(dtype, D) == mea.TENSOR_CORES
    ro, _, rl = mea.expert_attention_plain(q, a, ke, ve, valid,
                                           round_p=round_p)
    dropped = valid.clone()
    dropped[..., 1, 64:128] = False
    o, _, l = mea.mita_expert_attention(q, a, ke, ve, dropped)
    use = a == 1
    x = o.float()[use] / l[use][:, None]
    y = ro.float()[use] / rl[use][:, None]
    err = (x - y).abs().max().item()
    tol = TOL[dtype]
    if err <= tol or torch.allclose(x, y, atol=tol, rtol=tol):
        fail(f"mita_expert_attention {dtype}: the control with keys 64..127 "
             f"of an expert dropped passes the check (max_abs_err {err})")
    print(f"mita_expert_attention {dtype}: control with keys 64..127 of "
          f"expert 1 dropped ({int(use.sum())} rows): max_abs_err "
          f"{err:.3e}, fails the check (tol {tol}), as it must")
    return err


RG_HKV, RG_G, RG_D = 1, 16, 256     # recurrentgemma-9b: MQA, head dim 256


def phase_expert_wide():
    """The routed-expert kernel at recurrentgemma-9b's forward shape (lead
    [1, 1, 16] over one KV head, d = 256, K = 128, m = 32 at N = 4096;
    the CUDA-core wide instance in both dtypes) against its plain version
    (bf16: P rounded to bf16 in the plain version, tolerance 2e-2; f32:
    1e-5); inactive rows exactly empty; shuffled rows bit for bit; a
    control with keys 64..127 of expert 1 dropped that must fail; timed
    (CUDA events, cold L2), its launches read from a trace."""
    from repro_torch.kernels import mita_expert_attn as mea
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        args = expert_inputs(dtype, FWD_N, 40, hkv=RG_HKV, g_n=RG_G, d=RG_D)
        q, a, ke, ve, valid = args
        rp = dtype == torch.bfloat16
        if mea.expert_path(dtype, RG_D) != mea.CUDA_CORES:
            fail(f"expert_path {dtype} d {RG_D}: "
                 f"{mea.expert_path(dtype, RG_D)}")
        ref = mea.expert_attention_plain(*args, round_p=rp)
        got = mea.mita_expert_attention(*args)
        torch.cuda.synchronize()
        if not torch.equal(got[2] > 0, ref[2] > 0):
            fail(f"expert d {RG_D} {dtype}: active rows differ")
        errs = []
        for name, x, y in zip(("o / l", "m", "l"), expert_partials(got),
                              expert_partials(ref)):
            errs.append((x - y).abs().max().item())
            if not torch.allclose(x, y, atol=tol, rtol=tol):
                fail(f"expert d {RG_D} {dtype} {name} max_abs_err {errs[-1]}")
        inactive = a >= FWD_M
        if got[0][inactive].abs().max() != 0 \
                or got[2][inactive].abs().max() != 0:
            fail(f"expert d {RG_D} {dtype}: inactive rows are not empty")
        g = torch.Generator(device="cuda").manual_seed(41)
        perm = torch.randperm(FWD_N, generator=g, device="cuda")
        inv = torch.argsort(perm)
        sh = mea.mita_expert_attention(q[..., perm, :], a[..., perm], ke, ve,
                                       valid)
        for name, x, y in (("o", sh[0][..., inv, :], got[0]),
                           ("m", sh[1][..., inv], got[1]),
                           ("l", sh[2][..., inv], got[2])):
            if not torch.equal(x, y):
                fail(f"expert d {RG_D} {dtype}: shuffled rows give other "
                     f"{name} bits")
        dropped = valid.clone()
        dropped[..., 1, 64:128] = False
        o, _, l = mea.mita_expert_attention(q, a, ke, ve, dropped)
        use = a == 1
        x = o.float()[use] / l[use][:, None]
        y = ref[0].float()[use] / ref[2][use][:, None]
        ctrl = (x - y).abs().max().item()
        if ctrl <= tol or torch.allclose(x, y, atol=tol, rtol=tol):
            fail(f"expert d {RG_D} {dtype}: the dropped-keys control passes "
                 f"the check (max_abs_err {ctrl})")
        del ref, sh, o, l, x, y
        kern = lambda: mea.mita_expert_attention(*args)  # noqa: E731
        pl = lambda: mea.expert_attention_plain(*args)  # noqa: E731
        ms, pms = cuda_ms(kern, iters=20), cuda_ms(pl, iters=3)
        rec = kernel_record(kern, iters=20)
        if rec["cuda_kernels"] != ["expert_attn_kernel"]:
            fail(f"expert d {RG_D} {dtype}: traced {rec['cuda_kernels']}")
        bms, by = bound_ms(*expert_bound(args, dtype), dtype)
        res[dtype] = dict(max_abs_err=max(errs), ms=ms, plain_ms=pms,
                          bound_ms=bms, bound_by=by, tol=tol,
                          control_max_abs_err=ctrl, path=mea.CUDA_CORES,
                          shape=f"lead [1, {RG_HKV}, {RG_G}], d {RG_D}, "
                                f"N {FWD_N}, m {FWD_M}", **rec)
        print(f"mita_expert_attention d {RG_D} {dtype} (lead [1, 1, 16], "
              f"N {FWD_N}): max_abs_err {max(errs):.3e} (tol {tol}), kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.5f} ms ({by}); "
              f"{record_text(rec)}; shuffled rows bit for bit; control "
              f"(keys 64..127 of expert 1 dropped) {ctrl:.3e} fails the "
              f"check, as it must")
        del args, got
        torch.cuda.empty_cache()
    return res


def phase_fullseq_kernels():
    """The routed-expert and flash kernels against their plain versions at
    the forward shapes; timed with CUDA events (cold L2)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import mita_expert_attn as mea
    res = {"expert": {}, "flash": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        r = res["expert"][dtype] = check_expert(dtype)
        # one CUDA launch a call, on the path expert_path names (bf16: the
        # tensor cores)
        path = mea.expert_path(dtype, D)
        want = {mea.TENSOR_CORES: ["expert_mma_kernel"],
                mea.CUDA_CORES: ["expert_attn_kernel"]}[path]
        if r["cuda_kernels"] != want or (dtype == torch.bfloat16
                                         and path != mea.TENSOR_CORES):
            fail(f"mita_expert_attention {dtype}: the trace shows "
                 f"{r['cuda_kernels']}, expected {want}")
        r["path"] = path
        expert_invariance(dtype)
        r["control_max_abs_err"] = expert_control(dtype)

        g = torch.Generator(device="cuda").manual_seed(30)
        q, k, v = (torch.randn((1, 16, FWD_N, D), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        qx = q[:, :, : FWD_N // 4].contiguous()          # cross: N = 1024
        row = {}
        for what, qq, causal in (("causal", q, True), ("full", q, False),
                                 ("cross causal", qx, True)):
            ref = fa.flash_attention_plain(qq, k, v, causal=causal)
            got = fa.flash_attention(qq, k, v, causal=causal)
            torch.cuda.synchronize()
            e = (got.float() - ref.float()).abs().max().item()
            if not torch.allclose(got.float(), ref.float(), atol=tol,
                                  rtol=tol):
                fail(f"flash_attention {dtype} {what} max_abs_err {e}")
            if what == "cross causal":
                row["cross_max_abs_err"] = e
                continue
            if what == "causal":
                ref_causal = ref
            kern = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=causal)
            plain = lambda: fa.flash_attention_plain(  # noqa: E731
                q, k, v, causal=causal)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal)
            bms, by = bound_ms(*flash_bound(FWD_N, FWD_N, causal, dtype),
                               dtype)
            row[what] = dict(max_abs_err=e, ms=cuda_ms(kern, iters=10),
                             plain_ms=cuda_ms(plain, iters=5),
                             library_ms=cuda_ms(lib, iters=10), bound_ms=bms,
                             bound_by=by, tol=tol,
                             **kernel_record(kern, iters=10))
            r = row[what]
            print(f"flash_attention {dtype} {what} [1, 16, {FWD_N}, {D}]: "
                  f"max_abs_err {e:.3e} (tol {tol}), kernel {r['ms']:.4f} "
                  f"ms, plain {r['plain_ms']:.4f} ms, sdpa "
                  f"{r['library_ms']:.4f} ms, bound {bms:.5f} ms ({by}); "
                  f"{record_text(r)}")
        print(f"flash_attention {dtype} cross length (N {FWD_N // 4}, Nk "
              f"{FWD_N}, causal): max_abs_err {row['cross_max_abs_err']:.3e}")
        # the path that ran, read from the traced kernel names
        names = set(row["causal"]["cuda_kernels"]
                    + row["full"]["cuda_kernels"])
        path = {frozenset({"flash_tma_kernel"}): fa.TENSOR_CORES,
                frozenset({"flash_kernel"}): fa.CUDA_CORES}.get(
                    frozenset(names))
        if path is None or path != fa.flash_path(dtype, D) or (
                dtype == torch.bfloat16 and path != fa.TENSOR_CORES):
            fail(f"flash_attention {dtype}: launched {sorted(names)}, "
                 f"expected the {fa.flash_path(dtype, D)} kernel")
        # the controls: the kernel with one key tile dropped must fail the
        # check.  The first tile: rows and keys from 64 on, so row i sees
        # keys 64..i.  A middle tile: keys lo..hi-1 dropped for the rows
        # from hi on, which are rows lo.. of a causal call over the kept
        # keys (its rows before lo are q's own and not compared).
        lo, hi = FWD_N // 2, FWD_N // 2 + 128

        def keep(x):
            return torch.cat([x[:, :, :lo], x[:, :, hi:]], 2)

        controls = {
            "first": (fa.flash_attention(*(x[:, :, 64:].contiguous()
                                           for x in (q, k, v)), causal=True,
                                         block_q=64, block_k=64),
                      ref_causal[:, :, 64:]),
            "middle": (fa.flash_attention(*(keep(x) for x in (q, k, v)),
                                          causal=True)[:, :, lo:],
                       ref_causal[:, :, hi:])}
        torch.cuda.synchronize()
        ctrl = {}
        for where, (got, want) in controls.items():
            got, want = got.float(), want.float()
            ctrl[where] = (got - want).abs().max().item()
            if ctrl[where] <= tol or torch.allclose(got, want, atol=tol,
                                                    rtol=tol):
                fail(f"flash_attention {dtype}: the control with the "
                     f"{where} key tile dropped passes the check "
                     f"(max_abs_err {ctrl[where]})")
        print(f"flash_attention {dtype}: path {path} (traced); controls with "
              f"the first key tile dropped: max_abs_err {ctrl['first']:.3e}, "
              f"with keys {lo}..{hi - 1} dropped (rows {hi}..): "
              f"{ctrl['middle']:.3e}; both fail the check (tol {tol}), as "
              f"they must")
        res["flash"][dtype] = dict(row["causal"], full=row["full"],
                                   cross_max_abs_err=row["cross_max_abs_err"],
                                   control_max_abs_err=ctrl, path=path)
        del ref_causal, controls
    return res


# ------------------------------------------------------------ phase 3 ------

def check_vs_static(params, scfg, done, prompts, gen, capacity, batch,
                    what):
    """Hold every request's greedy tokens to `static_generate` on the same
    prompts, ``batch`` at a time; a divergence is accepted only where the
    static path's two best logits lie within PARITY_GAP.  Returns the
    number of near-tie divergences."""
    from repro_torch.launch.serve import static_generate
    diverged = 0
    for g0 in range(0, len(prompts), batch):
        ref, tm = static_generate(
            params, scfg, torch.as_tensor(np.stack(prompts[g0:g0 + batch]),
                                          device="cuda"),
            gen, capacity=capacity, record_gaps=True)
        for row in range(ref.shape[0]):
            diff = np.nonzero(done[g0 + row].tokens != ref[row])[0]
            if diff.size == 0:
                continue
            i = int(diff[0])
            gap = float(tm["top2_gap"][i, row])
            print(f"parity ({what}): request {g0 + row} diverges at token "
                  f"{i}, static top-two gap {gap:.3e}")
            if gap >= PARITY_GAP:
                fail(f"{what}: request {g0 + row} diverges at token {i} "
                     f"where the static top-two gap {gap} >= {PARITY_GAP}")
            diverged += 1
    return diverged


def phase_parity():
    """float32 (TF32 off), PARITY_LAYERS layers (full width): the
    monolithic and the chunked engine against the static path, a
    preemption round trip and a prefix-cache run against their plain
    runs."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model,
                              compute_dtype=torch.float32,
                              n_layers=PARITY_LAYERS)
    batch, n, gen, n_req = 4, 512, 160, 8
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    prompts = list(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=n, global_batch=n_req), 0)["tokens"])
    pages = -(-(n + gen) // W)

    def serve(reqs, **kw):
        ecfg = EngineConfig(n_slots=batch, pages_per_slot=pages,
                            n_pages=2 * batch * pages, **kw)
        eng = ServingEngine(params, cfg, ecfg, device="cuda")
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        if [f.reason for f in done] != ["complete"] * len(reqs):
            fail(f"parity serve {kw} reasons {[f.reason for f in done]}")
        return eng, done, time.perf_counter() - t0

    # monolithic and chunked prefill, prompt 512
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=gen)
            for i in range(n_req)]
    for kw in ({}, {"prefill_chunk": 256}):
        eng, done, dt = serve(reqs, **kw)
        what = "chunked 256" if kw else "monolithic"
        div = check_vs_static(params, eng.backend.cfg, done, prompts, gen,
                              pages * W, batch, what)
        print(f"parity serve (float32, {cfg.n_layers} layers, {what}): "
              f"{n_req} requests x {gen} tokens in {dt:.2f} s, {div} "
              f"near-tie divergences, tokens otherwise identical to "
              f"static_generate; stats chunks={eng.stats()['chunks']} "
              f"prefill_dispatches={eng.stats()['prefill_dispatches']}")

    # a non-aligned prompt length the static path serves (96: m = 1, w' =
    # 96 < K) through the chunk program
    short = [p[:96] for p in prompts[:batch]]
    eng, done, dt = serve([Request(rid=i, prompt=p, max_new_tokens=gen)
                           for i, p in enumerate(short)], prefill_chunk=256)
    div = check_vs_static(params, eng.backend.cfg, done, short, gen,
                          pages * W, batch, "chunked, prompt 96")
    print(f"parity serve (float32, chunked, prompt 96): {batch} requests x "
          f"{gen} tokens in {dt:.2f} s, {div} near-tie divergences")

    # preemption: a low-priority request evicted mid-decode by two
    # high-priority arrivals, rebuilt by recompute-from-prompt
    pcfg = EngineConfig(n_slots=2, pages_per_slot=pages, n_pages=pages + 2,
                        prefill_chunk=256)
    victim = prompts[0]
    ref = ServingEngine(params, cfg, pcfg, device="cuda").run(
        [Request(rid=0, prompt=victim, max_new_tokens=gen)])[0].tokens
    eng = ServingEngine(params, cfg, pcfg, device="cuda")
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=gen))
    for _ in range(8):
        eng.step()
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=prompts[i][:256], max_new_tokens=32,
                           priority=5))
    while eng.step():
        pass
    got = next(f for f in eng.finished if f.rid == 0)
    if eng.stats()["preemptions"] < 1 or got.preemptions < 1:
        fail("preemption run: no preemption happened")
    if not np.array_equal(got.tokens, ref):
        i = int(np.nonzero(got.tokens != ref)[0][0])
        fail(f"preemption run: the victim's tokens differ from its "
             f"unpreempted run at token {i}")
    print(f"preemption run (float32): preemptions "
          f"{eng.stats()['preemptions']}, the victim's {gen} tokens equal "
          f"its unpreempted run")

    # prefix cache: B shares A's first 256 tokens and arrives after A's
    # prefill; the cached engine must emit the cold engine's tokens
    b_prompt = np.concatenate([prompts[0][:256], prompts[1][256:]])
    outs = []
    for cached in (False, True):
        eng = ServingEngine(params, cfg, EngineConfig(
            n_slots=2, pages_per_slot=pages, n_pages=4 * pages,
            prefill_chunk=256, prefix_cache=cached), device="cuda")
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=32))
        while eng.prefilling or not eng.active.any():
            eng.step()
        eng.submit(Request(rid=1, prompt=b_prompt, max_new_tokens=32))
        while eng.step():
            pass
        outs.append({f.rid: f.tokens for f in eng.finished})
    st = eng.stats()
    if st["prefix_cache_hits"] < 1:
        fail(f"prefix-cache run: no hit ({st})")
    for rid in (0, 1):
        if not np.array_equal(outs[0][rid], outs[1][rid]):
            fail(f"prefix-cache run: request {rid} tokens differ from the "
                 "cold engine")
    print(f"prefix-cache run (float32): hits {st['prefix_cache_hits']}, "
          f"tokens reused {st['prefix_tokens_reused']}, tokens equal to the "
          f"cold engine")
    del params, eng
    torch.cuda.empty_cache()


def routing(q, k, v, mcfg, q_lm_src=None):
    """One attention call's routing as `core.mita` computes it, landmarks
    pooled from ``q_lm_src`` (default q): (q_lm, s_kv, r, k_e, v_e,
    valid)."""
    from repro_torch.core import mita as mref
    q_lm = mref.extract_landmarks(q if q_lm_src is None else q_lm_src, mcfg)
    s_kv = mref.landmark_scores(k, q_lm, mcfg)
    r = mref.routing_logits(q, q_lm, mcfg)
    return (q_lm, s_kv, r) + tuple(mref.gather_topk(k, v, s_kv, mcfg))


def routed_branch_err(q, k, v, mcfg, block_q: int, what: str,
                      q_lm_src=None):
    """One attention layer's routed branch on one routing: the expert
    kernel (span 0) against the span path over all m experts, compared as
    normalised partials on the active rows; fails past LAYER_TOL.
    ``q_lm_src``: the queries the landmarks pool (default q).  Returns
    (largest error, the active rows)."""
    from repro_torch.core import mita_sparse as msp
    _, _, r, k_e, v_e, valid = routing(q, k, v, mcfg, q_lm_src)
    p_k, p_s = (msp._routed_sorted(q, k_e, v_e, valid, r, mcfg, block_q,
                                   span) for span in (0, mcfg.m))
    act = p_s.l > 0
    if not torch.equal(act, p_k.l > 0):
        fail(f"{what}: routed branch active rows differ")
    worst = 0.0
    for name, a, b in (
            ("o / l", p_k.o / p_k.l.clamp(min=1e-30)[..., None],
             p_s.o / p_s.l.clamp(min=1e-30)[..., None]),
            ("m", p_k.m, p_s.m)):
        a, b = a[act], b[act]
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b, atol=LAYER_TOL, rtol=LAYER_TOL):
            fail(f"{what}: routed {name}, expert kernel vs span path, "
                 f"max_abs_err {err} > {LAYER_TOL}")
    return worst, act


def routed_layer_err(params, base, toks) -> float:
    """Every layer's routed branch of a float32 forward over ``toks`` on
    one routing (`routed_branch_err`; inputs: the span run).  Returns the
    largest error."""
    import dataclasses
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as tfm
    n = toks.shape[1]
    cfg_s = dataclasses.replace(base, attn=dataclasses.replace(
        base.attn, impl="sorted", expert_span=n // W))
    with torch.inference_mode():
        x = nn.embed(params["emb"], toks, base)
        pos = torch.arange(n, device="cuda")
        mcfg = base.attn.mita_cfg(n)
        layer_err = 0.0
        for i in range(base.n_layers):
            lp = tfm.layer_params(params["blocks"], i)
            q, k, v = nn._qkv(lp["attn"], nn.rms_norm(x, lp["ln1"]), base,
                              pos)
            err, _ = routed_branch_err(q, k, v, mcfg, base.attn.block_q,
                                       f"layer {i}",
                                       q.mean(dim=2, keepdim=True))
            layer_err = max(layer_err, err)
            x, _ = tfm.block_apply(lp, x, cfg_s, pos)
    return layer_err


def phase_fullseq_parity():
    """float32 (TF32 off), 28 layers: the full-sequence forward with the
    expert kernel (impl="pallas") against the span path with the whole
    expert range in its span (impl="sorted", expert_span = m), which the
    reference holds to the same oracle; then static_generate with
    impl="pallas" against the chunked engine at prompt 1024.

    Layer by layer, on one routing, the two routed branches agree to
    LAYER_TOL.  End to end they cannot agree to a fixed tolerance: with
    random weights, routing and top-k decisions near ties amplify any
    float-order difference (the span path on inputs perturbed by 1e-7
    relative moves the logits as far), so the logits are held to the
    oracle (`core.mita.mita_attention`, backend "mita_ref"): by the median
    over positions of the largest logit difference, the pallas logits must
    lie within twice the larger of the span path's distance to it and
    that float sensitivity; lm_loss must agree to LOSS_TOL."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    base = dataclasses.replace(get_arch("qwen3-0.6b").model,
                               compute_dtype=torch.float32)

    def with_attn(**kw):
        return dataclasses.replace(base, attn=dataclasses.replace(
            base.attn, **kw))

    cfg_p = with_attn(impl="pallas")
    cfg_s = with_attn(impl="sorted", expert_span=FWD_M)
    cfg_ref = with_attn(backend="mita_ref")
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0),
                         base, "cuda")
    batch = synthetic_batch(DataConfig(vocab=base.vocab, seq_len=FWD_N,
                                       global_batch=1), 0)
    toks = torch.as_tensor(batch["tokens"], device="cuda")
    with torch.inference_mode():
        layer_err = routed_layer_err(params, base, toks)
        logits = {what: tfm.lm_forward(params, toks, c)[0]
                  for what, c in (("pallas", cfg_p), ("sorted", cfg_s),
                                  ("oracle", cfg_ref))}
        # the model's own float sensitivity: the span path on the input
        # embeddings times (1 + 1e-7 noise)
        g = torch.Generator(device="cuda").manual_seed(5)
        x = nn.embed(params["emb"], toks, base)
        x = x * (1 + 1e-7 * torch.randn(x.shape, generator=g, device="cuda"))
        logits["sorted, input x (1 + 1e-7 noise)"] = nn.unembed(
            params["emb"], tfm.lm_backbone(params, x, cfg_s)[0], base)[0]
        loss = {what: tfm.lm_loss(params, batch, c).item()
                for what, c in (("pallas", cfg_p), ("sorted", cfg_s))}
    if logits["pallas"].shape != (FWD_N, base.vocab) \
            or not torch.isfinite(logits["pallas"]).all():
        fail(f"pallas logits malformed: {tuple(logits['pallas'].shape)}")

    def median_err(a, b):
        """Median over positions of the largest logit difference."""
        err = (logits[a] - logits[b]).abs().max(-1).values
        greedy = int((logits[a].argmax(-1) != logits[b].argmax(-1)).sum())
        print(f"  logits {a} vs {b}: median {err.median().item():.4e}, max "
              f"{err.max().item():.4e}, greedy tokens differ at {greedy} of "
              f"{FWD_N} positions")
        return err.median().item()

    print(f"full-sequence forward (float32, {base.n_layers} layers, N "
          f"{FWD_N}): per-layer routed partials, expert kernel vs span "
          f"{FWD_M} on one routing: max_abs_err {layer_err:.3e} (tol "
          f"{LAYER_TOL}); lm_loss pallas {loss['pallas']:.7f} sorted "
          f"{loss['sorted']:.7f} (tol {LOSS_TOL})")
    median_err("pallas", "sorted")
    floor = median_err("sorted", "sorted, input x (1 + 1e-7 noise)")
    to_ref = {impl: median_err(impl, "oracle")
              for impl in ("pallas", "sorted")}
    if abs(loss["pallas"] - loss["sorted"]) > LOSS_TOL \
            or not np.isfinite(loss["pallas"]):
        fail(f"lm_loss {loss}")
    if to_ref["pallas"] > 2 * max(to_ref["sorted"], floor):
        fail(f"the pallas logits lie farther from the oracle ({to_ref}) "
             f"than twice the span path's distance or its float "
             f"sensitivity ({floor})")
    del logits, x

    # static_generate with the expert kernel against the chunked engine,
    # prompt 1024: m = 8 > the span 4 of the default sorted path
    n, gen, n_req = 1024, 32, 4
    prompts = list(synthetic_batch(DataConfig(
        vocab=base.vocab, seq_len=n, global_batch=n_req), 1)["tokens"])
    pages = -(-(n + gen) // W)
    eng = ServingEngine(params, base, EngineConfig(
        n_slots=n_req, pages_per_slot=pages, n_pages=2 * n_req * pages,
        prefill_chunk=256), device="cuda")
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)])
    if [f.reason for f in done] != ["complete"] * n_req:
        fail(f"chunked serve, prompt {n}: {[f.reason for f in done]}")
    scfg = dataclasses.replace(eng.backend.cfg, attn=dataclasses.replace(
        eng.backend.cfg.attn, impl="pallas"))
    div = check_vs_static(params, scfg, done, prompts, gen, pages * W, n_req,
                          f"static pallas vs chunked, prompt {n}")
    print(f"parity (float32, prompt {n}): static_generate with impl=pallas "
          f"vs the chunked engine (chunk 256), {n_req} requests x {gen} "
          f"tokens, {div} near-tie divergences")
    del params, eng
    torch.cuda.empty_cache()


def phase_spec_parity():
    """float32 (TF32 off), PARITY_LAYERS layers: the speculative path.
    4 requests (two
    of prompt 96, whose first window closes at 128 while they decode, two
    of prompt 512 with four finalised landmarks to draft from), 48 new
    tokens, batch 4, chunked prefill 256, fused sampling:
      * at temperature 0.8, spec_k = 3 streams equal spec_k = 0's;
      * the host sampler at temperature 0.8 emits the fused sampler's
        tokens (gumbel drawn on the CPU from the float32 logits);
      * greedy spec_k = 3 equals `static_generate` except at recorded
        near-ties (top-two logit gap < PARITY_GAP)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model,
                              compute_dtype=torch.float32,
                              n_layers=PARITY_LAYERS)
    batch, gen = 4, 48
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    long = list(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=512, global_batch=2), 2)["tokens"])
    prompts = [p[:96] for p in long] + long
    pages = -(-(512 + gen) // W)

    def serve(temperature, **kw):
        ecfg = EngineConfig(n_slots=batch, pages_per_slot=pages,
                            n_pages=2 * batch * pages, prefill_chunk=256,
                            **kw)
        eng = ServingEngine(params, cfg, ecfg, device="cuda")
        t0 = time.perf_counter()
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen,
                                temperature=temperature)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        if [f.reason for f in done] != ["complete"] * len(prompts):
            fail(f"spec parity serve {kw} reasons "
                 f"{[f.reason for f in done]}")
        return eng, done, time.perf_counter() - t0

    def spec_text(eng):
        st = eng.stats()
        return (f"drafted {st['spec_drafted']} accepted "
                f"{st['spec_accepted']} rollbacks {st['spec_rollbacks']}")

    runs = {}
    for what, temp, kw in (
            ("tempered fused spec_k=0", 0.8, dict(sample_device="fused")),
            ("tempered fused spec_k=3", 0.8,
             dict(sample_device="fused", spec_k=3)),
            ("tempered host", 0.8, dict(sample_device="host")),
            ("greedy fused spec_k=3", 0.0,
             dict(sample_device="fused", spec_k=3))):
        runs[what] = serve(temp, **kw)
        eng, _, dt = runs[what]
        print(f"spec parity serve (float32, {cfg.n_layers} layers, {what}): "
              f"{len(prompts)} requests x {gen} tokens in {dt:.2f} s, "
              f"{eng.steps} steps, {spec_text(eng)}")
    base = {f.rid: f.tokens for f in runs["tempered fused spec_k=0"][1]}
    for what in ("tempered fused spec_k=3", "tempered host"):
        for f in runs[what][1]:
            if not np.array_equal(f.tokens, base[f.rid]):
                i = int(np.nonzero(f.tokens != base[f.rid])[0][0])
                fail(f"{what}: request {f.rid} differs from the fused "
                     f"spec_k=0 serve at token {i}")
    eng, done, _ = runs["greedy fused spec_k=3"]
    div = 0
    for lo, hi in ((0, 2), (2, 4)):
        div += check_vs_static(params, eng.backend.cfg, done[lo:hi],
                               prompts[lo:hi], gen, pages * W, 2,
                               f"greedy spec_k=3, prompt {len(prompts[lo])}")
    print(f"spec parity (float32): tempered spec_k=3 and host-sampled "
          f"streams equal the fused spec_k=0 streams; greedy spec_k=3 "
          f"equals static_generate with {div} near-tie divergences")
    del params, eng, runs
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4 ------

def production_serve(card: str, extra: list, what: str,
                     arch: str = "qwen3-0.6b"):
    """The bf16 trace through `repro_torch.launch.serve.main`, launch
    counters set to 0 just before and read just after; the summary gains
    ``max_memory_allocated`` (bytes)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main

    n_layers = get_arch(arch).model.n_layers
    vocab = get_arch(arch).model.vocab
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    summary = main(["--arch", arch, "--engine", "continuous", "--batch",
                    "4", "--prompt-len", "512", "--gen", "160", "--requests",
                    "8", "--device", "cuda", *extra])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summary["max_memory_allocated"] = peak
    if summary["finished"] != 8 or set(summary["reasons"]) != {"complete"}:
        fail(f"{what} serve finished {summary['reasons']}")
    for rid, toks in summary["tokens"].items():
        if len(toks) != 160 or toks.min() < 0 or toks.max() >= vocab:
            fail(f"{what} serve request {rid} tokens malformed")
    if launches["mita_paged_attention"] != n_layers * summary["steps"]:
        fail(f"decode launches {launches['mita_paged_attention']} != "
             f"{n_layers} layers x {summary['steps']} steps")
    if launches["mita_paged_finalize_fused"] <= 0:
        fail(f"{what} serve never launched the finalize kernel")
    st = summary["stats"]
    print(f"{what} serve ({card}): {summary['tok_s']:.1f} tok/s, "
          f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{summary['ttft_p99_s'] * 1e3:.1f} ms, {summary['steps']} "
          f"steps, {st['prefill_dispatches']} prefill "
          f"dispatches, max_memory_allocated {peak / 2**30:.2f} GiB, "
          f"supervisor retries {st['retries']} quarantined "
          f"{st['quarantined']} stragglers {st['stragglers']}, "
          f"launches {launches}")
    return summary, launches


def phase_production(card: str):
    """Monolithic, then chunked (prefill chunk 256): the chunked serve is
    the slice's main path, whose launch counts the summary reports.
    Returns them and the chunked serve's summary (both serves run under
    the supervisor, as every continuous serve of the CLI does)."""
    from repro_torch.configs.registry import get_arch
    n_layers = get_arch("qwen3-0.6b").model.n_layers
    _, mono = production_serve(card, [], "production monolithic")
    if mono["mita_chunk_prefill_fused"] != 0:
        fail(f"the monolithic serve launched the chunk kernel: {mono}")
    summary, launches = production_serve(
        card, ["--prefill-chunk", "256"], "production chunked")
    disp = summary["stats"]["prefill_dispatches"]
    if not 0 < launches["mita_chunk_prefill_fused"] == n_layers * disp:
        fail(f"chunk launches {launches['mita_chunk_prefill_fused']} != "
             f"{n_layers} layers x {disp} prefill dispatches (> 0)")
    return launches, summary


def phase_spec_production(card: str):
    """This slice's path at the production dtypes (bf16 compute) through
    `repro_torch.launch.serve.main`: a chunked (256), fused, tempered
    (0.8) serve at spec_k = 3 and its spec_k = 0 twin, in turns (0, 3,
    3, 0), prompt 600 (the window closes at 640 while decoding), 64 new
    tokens, 4 requests, batch 4.  Launch counters set to 0 just before
    each and read just after: paged-decode launches = 28 layers x decode
    steps (every verify position is one), finalize and chunk launches
    > 0.  Streams of the two must be equal.  Returns the first spec_k = 3
    serve's (summary, launches) and the tok/s of both."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as tfm

    n_layers = get_arch("qwen3-0.6b").model.n_layers
    runs = {0: [], 3: []}
    for k in (0, 3, 3, 0):
        ops.reset_launch_counts()
        with _Counted(tfm, "lm_paged_decode_step") as steps, \
                _Counted(tfm, "lm_landmark_draft") as drafts:
            summary = serve_main([
                "--engine", "continuous", "--batch", "4", "--prompt-len",
                "600", "--gen", "64", "--requests", "4", "--device", "cuda",
                "--prefill-chunk", "256", "--sample-device", "fused",
                "--temperature", "0.8", "--spec-k", str(k)])
            torch.cuda.synchronize()
        launches = ops.launch_counts()
        if summary["finished"] != 4 or set(summary["reasons"]) != \
                {"complete"}:
            fail(f"spec_k={k} serve finished {summary['reasons']}")
        if launches["mita_paged_attention"] != n_layers * steps.calls:
            fail(f"spec_k={k}: decode launches "
                 f"{launches['mita_paged_attention']} != {n_layers} layers "
                 f"x {steps.calls} decode steps")
        if launches["mita_paged_finalize_fused"] <= 0 \
                or launches["mita_chunk_prefill_fused"] <= 0:
            fail(f"spec_k={k} serve never launched the finalize or the "
                 f"chunk kernel: {launches}")
        st = summary["stats"]
        if k and (st["spec_drafted"] <= 0 or drafts.calls <= 0):
            fail(f"spec_k=3 serve drafted nothing: {st}")
        runs[k].append((summary, launches, steps.calls, drafts.calls))
        print(f"spec serve ({card}), bf16, spec_k={k}: "
              f"{summary['tok_s']:.1f} tok/s, {summary['steps']} engine "
              f"steps, {steps.calls} decode steps ({drafts.calls} draft "
              f"calls), drafted {st['spec_drafted']} accepted "
              f"{st['spec_accepted']} rollbacks {st['spec_rollbacks']}, "
              f"launches {launches}")
    for (a, *_), (b, *_) in zip(runs[0], runs[3]):
        for rid, toks in a["tokens"].items():
            if not np.array_equal(toks, b["tokens"][rid]):
                fail(f"bf16 spec_k=3 request {rid} differs from spec_k=0")
    tps = {k: [r[0]["tok_s"] for r in v] for k, v in runs.items()}
    print(f"spec serve ({card}), bf16: spec_k=3 streams equal spec_k=0; "
          f"tok/s spec_k=0 {tps[0]}, spec_k=3 {tps[3]}")
    summary, launches = runs[3][0][:2]
    return summary, launches, tps


class _Counted:
    """Counts calls of a module function while active (the forwards a
    serve runs), without changing what it does."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.fn(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_fullseq_production(card: str):
    """The slice's main path at the production dtypes (bf16 compute):
    lm_forward at B = 1, N = 4096 with impl="pallas" and impl="sorted" in
    turns (tokens/s), then one monolithic serve with --attn-impl pallas
    through `repro_torch.launch.serve.main`.  The launch counters are set
    to 0 just before and read just after; expert launches must equal 28
    layers x full-sequence forwards."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as tfm

    cfg = get_arch("qwen3-0.6b").model
    cfgs = {impl: dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, impl=impl)) for impl in ("pallas", "sorted")}
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    toks = torch.as_tensor(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=FWD_N, global_batch=1), 0)["tokens"],
        device="cuda")
    times = {"pallas": [], "sorted": []}
    forwards = 0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.inference_mode():
        for impl in ("pallas", "sorted"):                  # warm-up
            tfm.lm_forward(params, toks, cfgs[impl])
            forwards += impl == "pallas"
        for impl in ("pallas", "sorted", "sorted", "pallas") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = tfm.lm_forward(params, toks, cfgs[impl])
            torch.cuda.synchronize()
            times[impl].append(time.perf_counter() - t0)
            forwards += impl == "pallas"
            if not torch.isfinite(logits).all():
                fail(f"bf16 lm_forward impl={impl}: non-finite logits")
    del logits, params
    torch.cuda.empty_cache()
    tps = {k: FWD_N / (sum(v) / len(v)) for k, v in times.items()}
    print(f"bf16 lm_forward ({card}), B = 1, N = {FWD_N}: impl=pallas "
          f"{tps['pallas']:.1f} tok/s, impl=sorted (span 4) "
          f"{tps['sorted']:.1f} tok/s (mean of 4 turns each; seconds "
          f"{times}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with _Counted(tfm, "lm_prefill") as prefills:
        summary = serve_main(["--engine", "continuous", "--batch", "4",
                              "--prompt-len", "1024", "--gen", "32",
                              "--requests", "8", "--device", "cuda",
                              "--attn-impl", "pallas"])
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_layers = cfg.n_layers
    if summary["finished"] != 8 or set(summary["reasons"]) != {"complete"}:
        fail(f"pallas serve finished {summary['reasons']}")
    for rid, tk in summary["tokens"].items():
        if len(tk) != 32 or tk.min() < 0 or tk.max() >= cfg.vocab:
            fail(f"pallas serve request {rid} tokens malformed")
    n_fwd = forwards + prefills.calls
    if not 0 < launches["mita_expert_attention"] == n_layers * n_fwd:
        fail(f"expert launches {launches['mita_expert_attention']} != "
             f"{n_layers} layers x {n_fwd} full-sequence forwards (> 0)")
    if launches["flash_attention"] != 0:
        fail("a model path launched the flash kernel")
    print(f"pallas monolithic serve ({card}): prompt 1024 + 32, 8 requests, "
          f"batch 4: {summary['tok_s']:.1f} tok/s, TTFT p50 "
          f"{summary['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{summary['ttft_p99_s'] * 1e3:.1f} ms, {prefills.calls} prefill "
          f"forwards; expert launches {launches['mita_expert_attention']} = "
          f"{n_layers} x ({forwards} lm_forward + {prefills.calls} "
          f"lm_prefill); launches {launches}")
    return launches, tps


# ------------------------------- phase 3 / 4 (recurrent, per-job) --------

REC_PARITY_LAYERS = {"mamba2-370m": 4, "recurrentgemma-9b": 3}
REC_CHUNK = 128


def _near_tie_check(tokens, ref, gaps, what):
    """Hold ``tokens`` [B, n] to ``ref`` [B, n]: a divergence is accepted
    only where the reference's two best logits lie within PARITY_GAP
    (``gaps`` [n, B]).  Returns (near-tie divergences, {row: message} of
    the divergences that are not near-ties); every divergence is
    printed."""
    div, bad = 0, {}
    for row in range(ref.shape[0]):
        diff = np.nonzero(np.asarray(tokens[row]) != ref[row])[0]
        if diff.size == 0:
            continue
        i = int(diff[0])
        gap = float(gaps[i, row])
        print(f"parity ({what}): request {row} diverges at token {i}, "
              f"reference top-two gap {gap:.3e}")
        if gap >= PARITY_GAP:
            bad[row] = (f"{what}: request {row} diverges at token {i} where "
                        f"the reference's top-two gap {gap} >= {PARITY_GAP}")
        else:
            div += 1
    return div, bad


def phase_recurrent_parity():
    """float32 (TF32 off), full width, depth cut (mamba2-370m 8 of 48
    layers, recurrentgemma-9b 2 of 13 super-blocks): 4 requests, prompt
    256 + 32, through the monolithic, the batched-chunked (128) and the
    per-job-chunked (128) engine, each request's greedy tokens held to the
    backend's `static_reference` (a time-major loop of the decode step)
    except at near-ties; a preemption round trip token-exact; spec_k = 3
    in the self mode equal to spec_k = 0 at temperatures 0 and 0.8."""
    import dataclasses
    from repro_torch.configs.registry import arch_params, get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.serve import (EngineConfig, Request, ServingEngine,
                                   backends)
    n, gen, n_req = 256, 32, 4
    pages = -(-(n + gen) // W)
    for arch_id, layers in REC_PARITY_LAYERS.items():
        arch = get_arch(arch_id)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, compute_dtype=torch.float32, n_layers=layers))
        cfg = arch.model
        params = arch_params(arch, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        prompts = synthetic_batch(DataConfig(
            vocab=cfg.vocab, seq_len=n, global_batch=n_req), 0)["tokens"]

        def engine(**kw):
            ecfg = EngineConfig(**{**dict(n_slots=n_req, pages_per_slot=pages,
                                          n_pages=2 * n_req * pages), **kw})
            return ServingEngine(params, cfg, ecfg, backend=backends.for_arch(
                arch, params, ecfg, device="cuda"))

        def run(eng, temperature=0.0):
            done = eng.run([Request(rid=i, prompt=prompts[i],
                                    max_new_tokens=gen,
                                    temperature=temperature)
                            for i in range(n_req)])
            torch.cuda.synchronize()
            if [f.reason for f in done] != ["complete"] * n_req:
                fail(f"{arch_id}: reasons {[f.reason for f in done]}")
            return [f.tokens for f in done]

        t0 = time.perf_counter()
        ref, gaps = engine().backend.static_reference(prompts, gen,
                                                      record_gaps=True)
        t_ref = time.perf_counter() - t0
        for what, kw in (("monolithic", {}),
                         ("chunked 128", dict(prefill_chunk=REC_CHUNK)),
                         ("per-job 128", dict(prefill_chunk=REC_CHUNK,
                                              prefill_mode="per-job"))):
            t0 = time.perf_counter()
            eng = engine(**kw)
            toks = run(eng)
            div, bad = _near_tie_check(toks, ref, gaps, f"{arch_id} {what}")
            if bad:
                fail("; ".join(bad.values()))
            st = eng.stats()
            print(f"recurrent parity ({arch_id}, float32, {layers} layers, "
                  f"{what}): {n_req} requests x {gen} tokens in "
                  f"{time.perf_counter() - t0:.2f} s, {div} near-tie "
                  f"divergences, tokens otherwise equal to static_reference "
                  f"({t_ref:.2f} s); chunks {st['chunks']} in "
                  f"{st['prefill_dispatches']} dispatches")

        # preemption: the victim evicted mid-decode by two high-priority
        # arrivals and rebuilt by chunk prefill over prompt + emitted tokens
        kw = dict(n_slots=2, n_pages=pages + 2, prefill_chunk=REC_CHUNK)
        want = engine(**kw).run([Request(rid=0, prompt=prompts[0],
                                         max_new_tokens=gen)])[0].tokens
        eng = engine(**kw)
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=gen))
        for _ in range(6):
            eng.step()
        for i in (1, 2):
            eng.submit(Request(rid=i, prompt=prompts[i][:REC_CHUNK],
                               max_new_tokens=gen, priority=5))
        while eng.step():
            pass
        got = next(f for f in eng.finished if f.rid == 0)
        if got.preemptions < 1:
            fail(f"{arch_id} preemption run: no preemption happened")
        if not np.array_equal(got.tokens, want):
            fail(f"{arch_id} preemption run: the victim's tokens differ "
                 "from its unpreempted run")
        print(f"recurrent preemption run ({arch_id}, float32): preemptions "
              f"{eng.stats()['preemptions']}, the victim's {gen} tokens "
              f"equal its unpreempted run")

        # speculation: self-drafting through the decode step
        for temp in (0.0, 0.8):
            base = run(engine(prefill_chunk=REC_CHUNK,
                              sample_device="fused"), temp)
            eng = engine(prefill_chunk=REC_CHUNK, sample_device="fused",
                         spec_k=3, spec_mode="self")
            spec = run(eng, temp)
            st = eng.stats()
            if any(not np.array_equal(a, b) for a, b in zip(base, spec)):
                fail(f"{arch_id} spec_k=3 (self) at T {temp} differs from "
                     "spec_k=0")
            if st["spec_drafted"] <= 0 \
                    or st["spec_accepted"] != st["spec_drafted"]:
                fail(f"{arch_id} self drafts: {st}")
            print(f"recurrent spec ({arch_id}, float32, T {temp}): spec_k=3 "
                  f"self streams equal spec_k=0; drafted "
                  f"{st['spec_drafted']} accepted {st['spec_accepted']}")
        del params, eng
        torch.cuda.empty_cache()


def _prefill_top_k_near_tie(params, cfg, prompt, mode, pages):
    """Where ``mode``'s chunked prefill of ``prompt`` (per-job:
    `lm_prefill_chunk`; batched: `lm_prefill_chunks`, the chunk kernel;
    chunks of 256 on an identity page table) first takes other landmark
    top-K picks than `lm_prefill`'s decode cache.  Every layer before that
    one must agree (landmark queries and values within PREFILL_LOGIT_TOL);
    every differing pick of it must be a near-tie: the two candidates'
    scores (float64, from `lm_prefill`'s keys and landmark query) apart
    by no more than float32 rounding can make of them (`pick_gaps`' bound)
    plus what the two sides' own key and query differences make of them.
    After that layer the two computations legitimately part.  Returns
    (layer, differing picks, largest gap over its bound), or None where
    no pick differs; fails otherwise."""
    from repro_torch.models import transformer as tfm
    n = len(prompt)
    m = n // W
    i32 = dict(dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        toks = torch.as_tensor(prompt, **i32)
        _, ref = tfm.lm_prefill(params, toks[None], cfg, pages * W)
        st = tfm.init_paged_states(cfg, 1, pages, pages, device="cuda")
        pt = torch.arange(pages, **i32)
        for t0 in range(0, n, 256):
            nv = min(256, n - t0)
            chunk = torch.zeros(256, **i32)
            chunk[:nv] = toks[t0:t0 + nv]
            if mode == "per-job":
                tfm.lm_prefill_chunk(params, st, chunk, 0, pt, t0, nv, n,
                                     cfg)
            else:
                one = (lambda x: torch.tensor([x], **i32))  # noqa: E731
                tfm.lm_prefill_chunks(params, st, chunk[None],
                                      torch.ones(1, dtype=torch.bool,
                                                 device="cuda"),
                                      pt[None], one(0), one(t0), one(nv),
                                      one(n), cfg)
    for layer in range(cfg.n_layers):
        a = ref.expert_idx[layer, 0, :, :m].long()
        b = st.expert_idx[layer, 0, :, :m].long()
        q_a = ref.lm_q[layer, 0, :, :m].double()
        q_b = st.lm_q[layer, 0, :, :m].double()
        diff = (a != b).nonzero()
        if diff.shape[0] == 0:
            for name, x, y in (("lm_q", q_a, q_b),
                               ("lm_v", ref.lm_v[layer, 0, :, :m],
                                st.lm_v[layer, 0, :, :m])):
                err = (x.double() - y.double()).abs().max().item()
                if err > PREFILL_LOGIT_TOL:
                    fail(f"{mode} prefill layer {layer}: {name} differs from "
                         f"lm_prefill's by {err} with equal top-K picks")
            continue
        h, i, r = diff.T
        k_ref = ref.k_cache[layer, 0].double()               # [Hkv, C, d]
        ka, kb = k_ref[h, a[h, i, r]], k_ref[h, b[h, i, r]]
        dka = (st.k_pool[layer][a[h, i, r], h].double() - ka).abs()
        dkb = (st.k_pool[layer][b[h, i, r], h].double() - kb).abs()
        q, dq = q_a[h, i], (q_b[h, i] - q_a[h, i]).abs()
        d = q.shape[-1]
        gap = ((ka - kb) * q).sum(-1).abs() / d ** 0.5
        mag = torch.maximum((ka * q).abs().sum(-1), (kb * q).abs().sum(-1))
        bound = (2 * (d + 1) * 2.0 ** -24 * mag
                 + ((dka + dkb) * q.abs()).sum(-1)
                 + ((ka.abs() + kb.abs()) * dq).sum(-1)) / d ** 0.5
        worst = (gap / bound).max().item()
        if worst > 1.0:
            fail(f"{mode} prefill layer {layer}: {diff.shape[0]} top-K picks "
                 f"differ from lm_prefill's, the widest score gap "
                 f"{gap.max().item():.3e} is {worst:.2f}x its rounding bound")
        return layer, diff.shape[0], worst
    return None


class _ChunkRows:
    """While active, records every batched chunk-prefill call
    (`core.mita_decode.mita_batched_chunk_prefill`) of a serve as the
    engine makes it, at its batch shape: the rows' slots and resume
    points, their queries and attention outputs, and their landmark
    queries after the call.  A dispatch calls it once per layer, in
    order."""

    def __init__(self, n_layers: int):
        self.n_layers, self.calls = n_layers, []

    def __enter__(self):
        from repro_torch.core import mita_decode as mdec
        self.mdec, self.fn = mdec, mdec.mita_batched_chunk_prefill

        def record(st, q, k, v, page_table, slots, t0, n_valid, *rest):
            out, st = self.fn(st, q, k, v, page_table, slots, t0, n_valid,
                              *rest)
            ids = slots.long()
            self.calls.append((ids.tolist(), t0.tolist(), n_valid.tolist(),
                               q.clone(), out.clone(),
                               st.pre_lm_q[ids].float()))
            return out, st

        mdec.mita_batched_chunk_prefill = record
        return self

    def __exit__(self, *exc):
        self.mdec.mita_batched_chunk_prefill = self.fn

    def rows(self, slot: int, layer: int):
        """(q [Hkv, G, n, d], out [Hkv, G, n, d], landmark queries [Hkv,
        M, d] after the last chunk) of ``slot``'s prefill at ``layer``,
        its chunks in order."""
        qs, outs, lm = [], [], None
        for c, (ids, t0, nv, q, out, lms) in enumerate(self.calls):
            if c % self.n_layers != layer or slot not in ids:
                continue
            r = ids.index(slot)
            if nv[r] == 0:
                continue
            qs.append((t0[r], q[r, :, :, :nv[r]], out[r, :, :, :nv[r]]))
            lm = lms[r]
        qs.sort(key=lambda x: x[0])
        return (torch.cat([x[1] for x in qs], 2),
                torch.cat([x[2] for x in qs], 2), lm)


def _prefill_route_near_tie(ref_layers, rid, chunk_rows, slot):
    """Where the engine's chunked prefill of request ``rid`` (recorded by
    `_ChunkRows` at the serve's batch shape) first parts from
    `lm_prefill`'s (``ref_layers``: per layer the batch's queries, group
    landmark inputs, attention outputs and MiTA config).  Every layer
    before must agree row by row within PREFILL_LOGIT_TOL; every parting
    (head, query, position) row of that layer must be a routing near-tie:
    its two best landmarks' routing logits (float64, from `lm_prefill`'s
    query and landmark queries) apart by no more than float32 rounding can
    make of them (`pick_gaps`' bound) plus what the two sides' own query
    and landmark-query differences make of them.  Returns (layer, parting
    rows, widest gap over its bound), or None where no row parts; fails
    otherwise."""
    from repro_torch.core import mita as mref
    for layer, (q, q_lm_in, o, mcfg) in enumerate(ref_layers):
        q_c, o_c, lm_c = chunk_rows.rows(slot, layer)
        part = (o_c.float() - o[rid].float()).abs().amax(-1)
        bad = (part > PREFILL_LOGIT_TOL).nonzero()
        if bad.shape[0] == 0:
            continue
        h, g, n = bad.T
        lm_r = mref.extract_landmarks(q_lm_in[rid], mcfg)[:, 0].double()
        r = mref.routing_logits(q[rid], lm_r[:, None].float(), mcfg)
        top2 = torch.topk(r[h, g, n].double(), 2, dim=-1).indices
        qr = q[rid][h, g, n].double()                        # [R, d]
        dq = (q_c[h, g, n].double() - qr).abs()
        la, lb = (lm_r[h, top2[:, j]] for j in (0, 1))       # [R, d]
        dla, dlb = ((lm_c[h, top2[:, j]].double() - x).abs()
                    for j, x in ((0, la), (1, lb)))
        d = qr.shape[-1]
        gap = ((la - lb) * qr).sum(-1) / d ** 0.5
        mag = torch.maximum((la * qr).abs().sum(-1), (lb * qr).abs().sum(-1))
        bound = (2 * (d + 1) * 2.0 ** -24 * mag
                 + (dq * (la.abs() + lb.abs())).sum(-1)
                 + (qr.abs() * (dla + dlb)).sum(-1)) / d ** 0.5
        worst = (gap.abs() / bound).max().item()
        if worst > 1.0:
            fail(f"request {rid}: the chunked prefill parts from "
                 f"lm_prefill's at layer {layer} on {bad.shape[0]} rows, "
                 f"the widest routing gap {gap.abs().max().item():.3e} is "
                 f"{worst:.2f}x its rounding bound")
        return layer, bad.shape[0], worst
    return None


def _prefill_near_ties(params, scfg, prompts, first, mode, pages,
                       chunk_rows=None, slots=None):
    """Hold each request's first-token logits (``first``: {rid: [V]}, the
    prefill's output) to `lm_prefill`'s within PREFILL_LOGIT_TOL, unless
    ``mode``'s prefill of that prompt took a landmark top-K near-tie
    the other way (`_prefill_top_k_near_tie`, which fails where a
    differing pick is no near-tie) or, given the serve's recorded chunk
    rows (``chunk_rows``, ``slots``: {rid: slot}), a routing near-tie
    (`_prefill_route_near_tie`).  Returns ({rid: (layer, picks or rows,
    widest gap over its bound)} of the near-tie requests, the largest
    error of the others)."""
    from repro_torch.models import modules as mods
    from repro_torch.models import transformer as tfm
    ref_layers, sparse = [], mods.mita_attention_sparse

    def record(q, k, v, mcfg, **kw):
        o = sparse(q, k, v, mcfg, **kw)
        ref_layers.append((q, kw.get("q_landmarks"), o, mcfg))
        return o

    if chunk_rows is not None:
        mods.mita_attention_sparse = record
    try:
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), device="cuda")
            pre, _ = tfm.lm_prefill(params, toks, scfg, pages * W)
            pre = pre.float().cpu()
    finally:
        mods.mita_attention_sparse = sparse
    near_tie, worst = {}, 0.0
    for i in range(len(prompts)):
        err = (first[i] - pre[i]).abs().max().item()
        if err <= PREFILL_LOGIT_TOL:
            worst = max(worst, err)
            continue
        res = _prefill_top_k_near_tie(params, scfg, prompts[i], mode, pages)
        if res is None and chunk_rows is not None:
            res = _prefill_route_near_tie(ref_layers, i, chunk_rows,
                                          slots[i])
            if res is not None:
                near_tie[i] = res
                print(f"{mode} request {i}: first-token logits {err:.3e} "
                      f"from lm_prefill's: the prefill first parts at layer "
                      f"{res[0]} on {res[1]} rows, each a routing near-tie "
                      f"(widest gap {res[2]:.3f} of its float32 rounding "
                      f"bound)")
                continue
        if res is None:
            fail(f"{mode} request {i}: first-token logits differ from "
                 f"lm_prefill's by {err} with every top-K pick equal")
        near_tie[i] = res
        print(f"{mode} request {i}: first-token logits {err:.3e} from "
              f"lm_prefill's: the prefill's landmark top-K first parts "
              f"at layer {res[0]} on {res[1]} picks, each a near-tie "
              f"(widest gap {res[2]:.3f} of its float32 rounding bound)")
    return near_tie, worst


def _keep_first_logits(eng) -> dict:
    """Record each request's first-token logits as ``eng`` samples them;
    returns the {rid: logits} dict it fills."""
    sample, first = eng._sample, {}

    def keep_first(logits, req, index):
        if index == 0:
            first[req.rid] = torch.as_tensor(logits).float()
        return sample(logits, req, index)

    eng._sample = keep_first
    return first


def phase_per_job_parity():
    """float32, qwen3-0.6b at PARITY_LAYERS layers, full width: the
    per-job chunked engine (chunk 256: `mita_chunk_prefill`, plain
    PyTorch as the reference's op is plain XLA) and the batched one
    against `static_generate` and against each other.  The first token's
    logits (the prefill's output) of each request must lie within
    PREFILL_LOGIT_TOL of `lm_prefill`'s, unless the prefill's landmark
    top-K takes a near-tie the other way (`_prefill_top_k_near_tie`); a
    token divergence is accepted at a token near-tie (PARITY_GAP) or in a
    request whose prefill took such a top-K near-tie, and nowhere else.
    Decode launches counted, chunk-kernel launches 0 in per-job mode."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import static_generate
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model,
                              compute_dtype=torch.float32,
                              n_layers=PARITY_LAYERS)
    batch, n, gen, n_req = 4, 512, 64, 4
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    prompts = list(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=n, global_batch=n_req), 3)["tokens"])
    pages = -(-(n + gen) // W)
    out, first = {}, {}
    for mode in ("batched", "per-job"):
        eng = ServingEngine(params, cfg, EngineConfig(
            n_slots=batch, pages_per_slot=pages, n_pages=2 * batch * pages,
            prefill_chunk=256, prefill_mode=mode), device="cuda")
        first[mode] = _keep_first_logits(eng)
        ops.reset_launch_counts()
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out[mode] = np.stack([f.tokens for f in done])
        st = eng.stats()
        print(f"{mode} serve (float32, {cfg.n_layers} layers): chunks "
              f"{st['chunks']} in {st['prefill_dispatches']} dispatches, "
              f"launches {launches}")
    if launches["mita_chunk_prefill_fused"] != 0 \
            or launches["mita_paged_attention"] <= 0:
        fail(f"per-job serve launches {launches}")
    scfg = eng.backend.cfg
    with torch.inference_mode():
        toks = torch.as_tensor(np.stack(prompts), device="cuda")
        ref, tm = static_generate(params, scfg, toks, gen,
                                  capacity=pages * W, record_gaps=True)
    near_tie, errs = {}, {}
    for mode in first:
        ties, errs[mode] = _prefill_near_ties(params, scfg, prompts,
                                              first[mode], mode, pages)
        near_tie.update({(mode, i): res for i, res in ties.items()})
    print(f"first-token logits vs lm_prefill (float32, requests without a "
          f"top-K near-tie): {errs} (tol {PREFILL_LOGIT_TOL})")
    div, bad = {}, []
    for what, a, b in (("batched vs static_generate", "batched", None),
                       ("per-job vs static_generate", "per-job", None),
                       ("per-job vs batched", "per-job", "batched")):
        div[what], rows = _near_tie_check(
            out[a], ref if b is None else out[b], tm["top2_gap"], what)
        for row, msg in rows.items():
            if (a, row) in near_tie or (b, row) in near_tie:
                div[what] += 1
            else:
                bad.append(msg)
    print(f"per-job parity (float32, qwen3-0.6b, {cfg.n_layers} layers, "
          f"prompt {n} + {gen}): divergences at near-ties (token or "
          f"top-K) {div}; top-K near-ties {near_tie}")
    if bad:
        fail("; ".join(bad))
    del params, eng
    torch.cuda.empty_cache()


def _hybrid_cfg(dtype, n_layers=None, **attn):
    import dataclasses
    from repro_torch.configs.registry import get_arch
    arch = get_arch("recurrentgemma-9b")
    cfg = dataclasses.replace(arch.model, compute_dtype=dtype,
                              n_layers=n_layers or arch.model.n_layers)
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                            **attn))
    return dataclasses.replace(arch, model=cfg)


def phase_hybrid_forward_parity():
    """float32, recurrentgemma-9b at full width, 2 super-blocks, N = 4096:
    every attention layer's routed branch on one routing, the expert
    kernel (d = 256) against the span path over all m experts, within
    LAYER_TOL; `rg_forward` with impl="pallas" and "sorted" (span = m):
    finite logits and rg_loss within LOSS_TOL; expert launches = attention
    layers x forwards."""
    import dataclasses
    from repro_torch.configs.registry import arch_params
    from repro_torch.core import mita as mref
    from repro_torch.core import mita_sparse as msp
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import modules as nn
    from repro_torch.models import rglru as rg
    from repro_torch.models import transformer as tfm

    arch_p = _hybrid_cfg(torch.float32, 6, impl="pallas")
    arch_s = _hybrid_cfg(torch.float32, 6, impl="sorted",
                         expert_span=FWD_M)
    cfg = arch_s.model
    params = arch_params(arch_s, torch.Generator(device="cuda")
                         .manual_seed(0), "cuda")
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=FWD_N,
                                       global_batch=1), 0)
    toks = torch.as_tensor(batch["tokens"], device="cuda")
    n_super = rg.n_super(cfg)
    with torch.inference_mode():
        x = nn.embed(params["emb"], toks, cfg)
        pos = torch.arange(FWD_N, device="cuda")
        mcfg = cfg.attn.mita_cfg(FWD_N)
        layer_err = 0.0
        for i in range(n_super):
            sp = tfm.layer_params(params["supers"], i)
            x = rg.rglru_block_apply(sp["rec1"], x, cfg)
            x = rg._ffn1(sp, x, cfg)
            x = rg.rglru_block_apply(sp["rec2"], x, cfg)
            lp = sp["attn_blk"]
            q, k, v = nn._qkv(lp["attn"], nn.rms_norm(x, lp["ln1"]), cfg,
                              pos)
            q_lm = mref.extract_landmarks(q.mean(dim=2, keepdim=True), mcfg)
            s_kv = mref.landmark_scores(k, q_lm, mcfg)
            r = mref.routing_logits(q, q_lm, mcfg)
            k_e, v_e, valid = mref.gather_topk(k, v, s_kv, mcfg)
            p_k, p_s = (msp._routed_sorted(q, k_e, v_e, valid, r, mcfg,
                                           cfg.attn.block_q, span)
                        for span in (0, FWD_M))
            act = p_s.l > 0
            if not torch.equal(act, p_k.l > 0):
                fail(f"hybrid layer {i}: routed branch active rows differ")
            for name, a, b in (
                    ("o / l", p_k.o / p_k.l.clamp(min=1e-30)[..., None],
                     p_s.o / p_s.l.clamp(min=1e-30)[..., None]),
                    ("m", p_k.m, p_s.m)):
                a, b = a[act], b[act]
                err = (a - b).abs().max().item()
                layer_err = max(layer_err, err)
                if not torch.allclose(a, b, atol=LAYER_TOL, rtol=LAYER_TOL):
                    fail(f"hybrid attention layer {i}: routed {name}, expert "
                         f"kernel vs span path, max_abs_err {err}")
            x, _ = tfm.block_apply(lp, x, cfg, pos)
        del x, q, k, v, k_e, v_e, p_k, p_s
        ops.reset_launch_counts()
        logits, _ = rg.rg_forward(params, toks, arch_p.model)
        forwards = 1
        if logits.shape != (1, FWD_N, cfg.vocab) \
                or not torch.isfinite(logits).all():
            fail(f"hybrid pallas logits malformed {tuple(logits.shape)}")
        del logits
        loss = {"pallas": rg.rg_loss(params, batch, arch_p.model).item()}
        forwards += 1
        launches = ops.launch_counts()
        loss["sorted"] = rg.rg_loss(params, batch, cfg).item()
    if launches["mita_expert_attention"] != n_super * forwards:
        fail(f"hybrid expert launches {launches['mita_expert_attention']} "
             f"!= {n_super} attention layers x {forwards} forwards")
    if abs(loss["pallas"] - loss["sorted"]) > LOSS_TOL \
            or not np.isfinite(loss["pallas"]):
        fail(f"hybrid rg_loss {loss}")
    print(f"hybrid forward (float32, recurrentgemma-9b, {n_super} "
          f"super-blocks, d {RG_D}, N {FWD_N}): per-layer routed partials, "
          f"expert kernel vs span {FWD_M}: max_abs_err {layer_err:.3e} (tol "
          f"{LAYER_TOL}); rg_loss pallas {loss['pallas']:.7f} sorted "
          f"{loss['sorted']:.7f} (tol {LOSS_TOL}); expert launches "
          f"{launches['mita_expert_attention']} = {n_super} x {forwards}")
    del params
    torch.cuda.empty_cache()
    return layer_err


REC_SERVE = ["--engine", "continuous", "--batch", "4", "--prompt-len", "256",
             "--gen", "64", "--requests", "8", "--device", "cuda",
             "--prefill-chunk", str(REC_CHUNK)]


def phase_recurrent_production(card: str):
    """bf16 serves through `repro_torch.launch.serve.main`: mamba2-370m and
    recurrentgemma-9b at full width and depth, 8 requests, prompt 256 + 64,
    4 slots, chunked 128; tok/s, TTFT, peak memory; the launch counters
    set to 0 just before each and read just after (the recurrent serving
    path reaches no Pallas kernel in the reference, so none here).  Then
    the hybrid's bf16 full-sequence forward at N = 4096 with
    impl="pallas": expert launches = 13 attention layers x forwards."""
    from repro_torch.configs.registry import arch_params
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import rglru as rg
    res = {}
    for arch_id in ("mamba2-370m", "recurrentgemma-9b"):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = serve_main(["--arch", arch_id, *REC_SERVE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if summary["finished"] != 8 or set(summary["reasons"]) != \
                {"complete"}:
            fail(f"{arch_id} serve finished {summary['reasons']}")
        for rid, tk in summary["tokens"].items():
            if len(tk) != 64 or tk.min() < 0:
                fail(f"{arch_id} serve request {rid} tokens malformed")
        res[arch_id] = dict(tok_s=summary["tok_s"],
                            ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
                            ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
                            steps=summary["steps"],
                            prefill_dispatches=summary["stats"][
                                "prefill_dispatches"],
                            max_memory_allocated_gib=peak / 2**30,
                            launches=launches)
        print(f"{arch_id} bf16 serve ({card}): {summary['tok_s']:.1f} tok/s, "
              f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{summary['ttft_p99_s'] * 1e3:.1f} ms, {summary['steps']} "
              f"steps, {summary['stats']['prefill_dispatches']} prefill "
              f"dispatches, max_memory_allocated {peak / 2**30:.2f} GiB, "
              f"{wall:.1f} s with set-up; launches {launches}")
    arch = _hybrid_cfg(torch.bfloat16, impl="pallas")
    params = arch_params(arch, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    toks = torch.as_tensor(synthetic_batch(DataConfig(
        vocab=arch.model.vocab, seq_len=FWD_N, global_batch=1), 0)["tokens"],
        device="cuda")
    n_super = rg.n_super(arch.model)
    ops.reset_launch_counts()
    times = []
    with torch.inference_mode():
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = rg.rg_forward(params, toks, arch.model)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not torch.isfinite(logits).all():
                fail("bf16 rg_forward: non-finite logits")
            del logits
    launches = ops.launch_counts()
    if launches["mita_expert_attention"] != n_super * 3:
        fail(f"bf16 hybrid forward: expert launches "
             f"{launches['mita_expert_attention']} != {n_super} x 3")
    res["hybrid_forward"] = dict(
        tok_s=FWD_N / (sum(times[1:]) / 2), seconds=times,
        launches=launches)
    print(f"recurrentgemma-9b bf16 rg_forward ({card}), impl=pallas, B = 1, "
          f"N = {FWD_N}, {n_super} super-blocks: "
          f"{res['hybrid_forward']['tok_s']:.1f} tok/s (mean of the 2 "
          f"after a warm-up; seconds {times}); expert launches "
          f"{launches['mita_expert_attention']} = {n_super} x 3")
    del params
    torch.cuda.empty_cache()
    return res


def phase_per_job_production(card: str):
    """The bf16 qwen3-0.6b serve in per-job chunked mode (chunk 256),
    decode launches = 28 x steps, finalize > 0, chunk kernel 0."""
    summary, launches = production_serve(
        card, ["--prefill-chunk", "256", "--prefill-mode", "per-job"],
        "production per-job")
    if launches["mita_chunk_prefill_fused"] != 0:
        fail(f"the per-job serve launched the chunk kernel: {launches}")
    return launches


# ------------------------------------------- phase 2 (dense head dim 64) ---

# (Hkv, G) of the dense configs with head dim 64, at their decode shapes
D64_SHAPES = {"tinyllama-1.1b": (4, 8), "stablelm-1.6b": (32, 1)}


@contextlib.contextmanager
def head_shape(hkv: int, g: int, d: int):
    """Run phase 2's helpers at another head shape: they read the module's
    HKV, G and D when they are called."""
    global HKV, G, D
    prev = HKV, G, D
    HKV, G, D = hkv, g, d
    try:
        yield
    finally:
        HKV, G, D = prev


def phase_kernels_d64():
    """B.1-B.3 at the decode shapes of tinyllama-1.1b (S 4, Hkv 4, G 8) and
    stablelm-1.6b (Hkv 32, G 1), head dim 64, w = K = 128, M = 6, float32
    and bfloat16: each against its plain version on the serving case of
    `paged_attn_cases` / `finalize_cases` and both `CHUNK_SETS`, timed (ms,
    card ms, host ms), its launches per call from a trace and its bound as
    for qwen3-0.6b's shape.  The finalize's expert rows and validity at 0
    mismatches.  The chunk kernel's validity at 0 mismatches, and its
    expert rows at 0 on integer inputs (every score exact in any order);
    on the real-valued inputs a row may differ only where its two picks'
    scores lie within float32 rounding (`pick_gaps`): stablelm's 32 heads
    meet such near ties in float32."""
    return serving_kernels_at(D64_SHAPES, 64)


def serving_kernels_at(shapes: dict, d: int) -> dict:
    """B.1-B.3 at each {arch: (Hkv, G)} of ``shapes`` and head dim ``d``,
    both dtypes, as `phase_kernels_d64` sets out."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    res = {}
    for arch_id, (hkv, g) in shapes.items():
        res[arch_id] = {}
        with head_shape(hkv, g, d):
            for dtype in (torch.float32, torch.bfloat16):
                label = f"d{d} {arch_id} (Hkv={hkv}, G={g})"
                print(f"--- {label} {dtype}")
                _, *case = next(paged_attn_cases(dtype))
                attn = check_paged_attn(dtype, f"{label} serving", *case)
                _, *case = next(finalize_cases(dtype))
                fin = check_finalize(dtype, (f"{label} serving", *case))
                chunk = check_chunk(dtype, near_ties=True)
                for si, (name, rows) in enumerate(CHUNK_SETS.items()):
                    chunk_vs_plain(mcp, dtype, rows, chunk_inputs(
                        dtype, rows, 20 + si, int_values=True),
                        f"{label} {name} integer inputs")
                print(f"mita_chunk_prefill_fused {label} {dtype}: integer "
                      "inputs, expert rows and validity 0 mismatches")
                res[arch_id][dtype] = {"attn": attn, "fin": fin,
                                       "chunk": chunk}
    return res


# --------------------------------------------------- phase 3 (supervision) --

# chaos_bench's cells: full width, depth cut as in the earlier f32 phases
CHAOS_CELLS = {"qwen3-0.6b": PARITY_LAYERS, "mamba2-370m": 4,
               "recurrentgemma-9b": 3}
CHAOS_HI = 13                # new tokens per request: 2 .. 12
CHAOS = dict(seed=11, p_fault=0.35, transient_len=2, p_slot_fault=0.3,
             alloc_spike_every=6, alloc_spike_pages=2, alloc_spike_len=3,
             ops=("decode_step", "prefill_chunks"))
SERVING_KERNELS = ("mita_paged_attention", "mita_paged_finalize_fused",
                   "mita_chunk_prefill_fused")


def chaos_trace(cfg, n_req: int = 8, seed: int = 3):
    """`benchmarks/chaos_bench.py`'s trace (prompts of one or two windows,
    2-12 new tokens), then two requests whose prompts end 4 tokens short
    of a window (w - 4 and 2w - 4, 12 new tokens): at full width (w =
    128) the bench's requests close no window while decoding, and these
    two make the finalize run under chaos."""
    from repro_torch.serve import Request
    w = cfg.attn.window
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(
        rng.choice([w, 2 * w]))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, CHAOS_HI)))
        for i in range(n_req)]
    return reqs + [Request(rid=n_req + i, prompt=rng.integers(
        0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=CHAOS_HI - 1)
        for i, n in enumerate((w - 4, 2 * w - 4))]


def _completed(finished) -> dict:
    return {f.rid: f.tokens for f in finished if f.reason == "complete"}


def _same_streams(got: dict, ref: dict) -> bool:
    return set(got) == set(ref) and all(np.array_equal(got[r], ref[r])
                                        for r in ref)


def _leaks(eng) -> int:
    return eng.alloc.in_use + len(eng.alloc.refs)


class _RaiseOnce:
    """Stands in for a layer function: once armed, its second call (after
    the dispatch's first layer ran) raises, then it passes through."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.armed, self.calls, self.fired = False, 0, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def __call__(self, *args, **kwargs):
        if self.armed:
            self.calls += 1
            if self.calls == 2:
                self.armed = False
                self.fired += 1
                raise RuntimeError("layer fault mid-dispatch")
        return self.fn(*args, **kwargs)


def phase_chaos_parity():
    """float32 (TF32 off): `benchmarks/chaos_bench.py`'s four phases on the
    card, re-implemented here (the bench imports JAX).  Cells: qwen3-0.6b
    (PARITY_LAYERS layers), mamba2-370m (4 layers), recurrentgemma-9b (1
    super-block), full width; its trace (`chaos_trace`: 8 requests,
    prompts of w or 2w, 2-12 new tokens, and two that cross a window
    close while decoding) on 4 slots, prefill chunk w.
      1. a fault-free engine: the oracle;
      2. the supervised engine under seed 11 chaos (transient and
         slot-bound faults on 35% of dispatches, allocator spikes of 2
         pages every 6 calls held 3): faults on >= 20% of step attempts,
         every stream equal to the oracle, zero pages and references left;
         the MiTA cell's B.1-B.3 launches > 0 (counted over this run);
      3. one persistent decode fault that clears only at level 3: the
         ladder walks to xla_forced, streams equal;
      4. a kill after 6 steps, the journal saved and loaded, a restore on
         a fresh supervised engine (chaos seed 23): streams equal.
    Then speculation under chaos (MiTA spec_k 3 with faults at
    verify_step; mamba2 self drafts with faults at draft_steps), equal to
    spec_k 0, and a torn MiTA decode dispatch (its second layer raises
    after the first ran its kernels): quarantined, streams equal."""
    import dataclasses
    from repro_torch.configs.registry import arch_params, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import (ChaosBackend, ChaosConfig, EngineConfig,
                                   Request, ServingEngine, Supervisor,
                                   SupervisorConfig, backends)
    snap_path = HERE / "build" / "chip_smoke_chaos_journal.json"
    snap_path.parent.mkdir(exist_ok=True)
    out = {}
    for arch_id, layers in CHAOS_CELLS.items():
        arch = get_arch(arch_id)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, compute_dtype=torch.float32, n_layers=layers))
        cfg = arch.model
        params = arch_params(arch, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        w = cfg.attn.window
        reqs = chaos_trace(cfg)
        pages = -(-(2 * w + CHAOS_HI) // w)
        ecfg = EngineConfig(n_slots=4, pages_per_slot=pages,
                            n_pages=4 * pages + 4, prefill_chunk=w)

        def engine(chaos=None, e=ecfg):
            b = backends.for_arch(arch, params, e, device="cuda")
            return ServingEngine(params, cfg, e, backend=(
                b if chaos is None else ChaosBackend(b, chaos)))

        def copies():
            return [Request(rid=r.rid, prompt=r.prompt.copy(),
                            max_new_tokens=r.max_new_tokens) for r in reqs]

        t0 = time.perf_counter()
        # 1. the fault-free oracle
        ref_eng = engine()
        ref = _completed(ref_eng.run(copies()))
        if len(ref) != len(reqs) or _leaks(ref_eng):
            fail(f"{arch_id} chaos oracle: {len(ref)} completed, "
                 f"{_leaks(ref_eng)} pages or references left")

        # 2. seeded chaos under the supervisor
        eng = engine(ChaosConfig(**CHAOS))
        cb = eng.backend
        sup = Supervisor(eng, SupervisorConfig(max_retries=2))
        ops.reset_launch_counts()
        done = sup.run(copies())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        st = sup.stats()
        frac = cb.n_injected / max(st["steps"] + cb.n_injected, 1)
        if frac < 0.2:
            fail(f"{arch_id} chaos: faults on {frac:.3f} of step attempts "
                 "(< 0.2)")
        if not _same_streams(_completed(done), ref):
            fail(f"{arch_id} chaos: supervised streams differ from the "
                 "fault-free run")
        if _leaks(eng):
            fail(f"{arch_id} chaos: {_leaks(eng)} pages or references left")
        if arch.family == "dense" and min(
                launches[k] for k in SERVING_KERNELS) <= 0:
            fail(f"{arch_id} chaos: a serving kernel never launched "
                 f"({launches})")
        sup.close()

        # 3. a persistent fault walks the whole ladder
        leng = engine(ChaosConfig(seed=0, persistent_clears_at=3))
        lsup = Supervisor(leng, SupervisorConfig(max_retries=1))
        leng.backend.inject("decode_step", kind="persistent")
        ldone = lsup.run(copies())
        lsup.close()
        if leng.degradation_level != 3 or lsup.degradations != [
                "spec_off", "prefix_cache_off", "xla_forced"]:
            fail(f"{arch_id} ladder: level {leng.degradation_level}, rungs "
                 f"{lsup.degradations}")
        if not _same_streams(_completed(ldone), ref) or _leaks(leng):
            fail(f"{arch_id} ladder: streams differ or pages leak")

        # 4. kill after 6 steps, journal, restore on a fresh engine
        reng = engine(ChaosConfig(**CHAOS))
        rsup = Supervisor(reng, SupervisorConfig(max_retries=2))
        for r in copies():
            rsup.submit(r)
        for _ in range(6):
            if not rsup.step():
                break
        rsup.save_snapshot(str(snap_path))
        rsup.close()
        snap = Supervisor.load_snapshot(str(snap_path))
        snap_path.unlink()
        in_flight = sum(1 for r in snap["requests"] if r["tokens"])
        reng2 = engine(ChaosConfig(seed=23, p_fault=0.2, transient_len=1,
                                   ops=("decode_step",)))
        rsup2 = Supervisor(reng2, SupervisorConfig(max_retries=2))
        rsup2.restore(snap)
        while rsup2.step():
            pass
        rsup2.close()
        if not _same_streams(_completed(reng2.finished), ref) \
                or _leaks(reng2):
            fail(f"{arch_id} kill/restore: streams differ or pages leak")
        del reng, reng2, leng
        row = dict(fault_fraction=frac, injected=cb.n_injected,
                   faults_started=cb.n_faults_started, spikes=cb.n_spikes,
                   retries=st["retries"], quarantined=st["quarantined"],
                   stragglers=st["stragglers"],
                   preemptions=st["preemptions"],
                   ladder_rungs=list(lsup.degradations),
                   restored_mid_decode=in_flight,
                   launches={k: launches[k] for k in SERVING_KERNELS},
                   gates=dict(parity=True, zero_leak=True,
                              fault_fraction=True, ladder_walked=True,
                              restore_parity=True))

        # speculation under chaos: MiTA faults at verify_step (its drafter
        # is stateless), recurrent self drafts at draft_steps
        spec_op = {"dense": "verify_step", "ssm": "draft_steps"}.get(
            arch.family)
        if spec_op is not None:
            fused = dataclasses.replace(ecfg, sample_device="fused",
                                        n_pages=4 * pages + 8)
            base = _completed(engine(e=fused).run(copies()))
            spec = dataclasses.replace(fused, spec_k=3, spec_mode=(
                "self" if arch.family == "ssm" else "auto"))
            seng = engine(ChaosConfig(seed=2, p_fault=0.3, transient_len=2,
                                      ops=(spec_op,)), e=spec)
            ssup = Supervisor(seng, SupervisorConfig(max_retries=3))
            sdone = ssup.run(copies())
            ssup.close()
            sst = ssup.stats()
            if not _same_streams(_completed(sdone), base) or _leaks(seng):
                fail(f"{arch_id} spec_k=3 under chaos at {spec_op}: streams "
                     "differ from spec_k=0 or pages leak")
            if seng.backend.n_injected <= 0 or sst["spec_drafted"] <= 0:
                fail(f"{arch_id} spec chaos: injected "
                     f"{seng.backend.n_injected}, drafted "
                     f"{sst['spec_drafted']}")
            row["spec_chaos"] = dict(op=spec_op,
                                     injected=seng.backend.n_injected,
                                     retries=sst["retries"],
                                     spec_drafted=sst["spec_drafted"],
                                     spec_accepted=sst["spec_accepted"])

        # a torn decode dispatch: quarantined, never retried
        if arch.family == "dense":
            teng = engine()
            tsup = Supervisor(teng, SupervisorConfig(max_retries=3))
            with _RaiseOnce(tfm, "block_decode_paged") as fault:
                for r in copies():
                    tsup.submit(r)
                while True:
                    if not fault.fired and not fault.armed \
                            and teng.active.sum() >= 2:
                        fault.armed, fault.calls = True, 0
                    if not tsup.step():
                        break
            tst = tsup.stats()
            if fault.fired != 1 or tst["quarantined"] <= 0 \
                    or tst["retries"] != 0 \
                    or "TornDispatch" not in (tsup.last_fault or ""):
                fail(f"torn dispatch: fired {fault.fired}, stats "
                     f"retries {tst['retries']} quarantined "
                     f"{tst['quarantined']}, last fault {tsup.last_fault}")
            if not _same_streams(_completed(teng.finished), ref) \
                    or _leaks(teng):
                fail("torn dispatch: supervised streams differ from the "
                     "fault-free run or pages leak")
            row["torn_dispatch"] = dict(quarantined=tst["quarantined"],
                                        retries=tst["retries"])
        row["seconds"] = time.perf_counter() - t0
        out[arch_id] = row
        print(f"chaos parity ({arch_id}, float32, {layers} layers): faults "
              f"on {frac:.3f} of step attempts ({cb.n_injected} injected, "
              f"{cb.n_faults_started} faults, {cb.n_spikes} spikes), "
              f"retries {st['retries']} quarantined {st['quarantined']} "
              f"stragglers {st['stragglers']}, streams equal to the "
              f"fault-free run; ladder {lsup.degradations} equal; kill "
              f"after 6 steps ({in_flight} requests mid-decode) and restore "
              f"equal; zero leaks; {row.get('spec_chaos')}; "
              f"{row.get('torn_dispatch')}; launches {row['launches']}; "
              f"{row['seconds']:.1f} s")
        del params, eng, ref_eng
        torch.cuda.empty_cache()
    return out


DENSE_CELLS = ("tinyllama-1.1b", "stablelm-1.6b")
DENSE_LAYERS = 4


def phase_dense_parity():
    """float32 (TF32 off): tinyllama-1.1b and stablelm-1.6b at full width
    and DENSE_LAYERS layers, 4 requests of 512 + 160 tokens (the window
    closes at 640 while decoding; the static path's sorted routed branch
    serves whole 128-row query blocks only, so the prompt is
    window-aligned), chunked (256) through the supervised engine, held to
    `static_generate` by PERF.md section 2's rule, as the per-job check:
    first-token logits within PREFILL_LOGIT_TOL of `lm_prefill`'s unless
    the prefill took a landmark top-K near-tie (proven pick by pick) or a
    routing near-tie (proven row by row on the serve's own chunk rows,
    where the batch shape of its products can flip one),
    and a token divergence only at a token near-tie (PARITY_GAP) or in a
    request with such a prefill near-tie; launches counted over the serve:
    paged decode = layers x steps, finalize > 0, chunk = layers x prefill
    dispatches."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    out = {}
    for arch_id in DENSE_CELLS:
        cfg = dataclasses.replace(get_arch(arch_id).model,
                                  compute_dtype=torch.float32,
                                  n_layers=DENSE_LAYERS)
        params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
        out[arch_id] = chunked_parity(arch_id, cfg, params)
        del params
        torch.cuda.empty_cache()
    return out


def chunked_parity(arch_id: str, cfg, params) -> dict:
    """`phase_dense_parity`'s check of one configuration (float32,
    ``cfg.n_layers`` layers, ``params`` on the card): 4 requests of
    512 + 160 chunked (256) through the supervised engine, held to
    `static_generate`; its launch gates."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import static_generate
    from repro_torch.serve import (EngineConfig, Request, ServingEngine,
                                   Supervisor)
    n, gen, batch = 512, 160, 4
    n_layers = cfg.n_layers
    prompts = list(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=n, global_batch=batch), 0)["tokens"])
    w = cfg.attn.window
    pages = -(-(n + gen) // w)
    eng = ServingEngine(params, cfg, EngineConfig(
        n_slots=batch, pages_per_slot=pages, n_pages=2 * batch * pages,
        prefill_chunk=256), device="cuda")
    first = _keep_first_logits(eng)
    sup = Supervisor(eng)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with _ChunkRows(n_layers) as chunk_rows:
        done = sup.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                        for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    slots = {int(eng.slot_rid[s]): s for s in range(batch)}
    dt = time.perf_counter() - t0
    if [f.reason for f in done] != ["complete"] * batch:
        fail(f"{arch_id} parity reasons {[f.reason for f in done]}")
    scfg = eng.backend.cfg
    near_tie, first_err = _prefill_near_ties(
        params, scfg, prompts, first, "batched", pages, chunk_rows, slots)
    with torch.inference_mode():
        ref, tm = static_generate(
            params, scfg, torch.as_tensor(np.stack(prompts), device="cuda"),
            gen, capacity=pages * w, record_gaps=True)
    div, bad = _near_tie_check(np.stack([f.tokens for f in done]), ref,
                               tm["top2_gap"], f"{arch_id} chunked 256")
    if set(bad) - set(near_tie):
        fail("; ".join(m for r, m in bad.items() if r not in near_tie))
    div += len(bad)
    st = sup.stats()
    want = {"mita_paged_attention": n_layers * st["steps"],
            "mita_chunk_prefill_fused": n_layers * st["prefill_dispatches"]}
    for k, v in want.items():
        if launches[k] != v or v <= 0:
            fail(f"{arch_id} parity: {k} launches {launches[k]} != {v} "
                 "(> 0)")
    if launches["mita_paged_finalize_fused"] <= 0:
        fail(f"{arch_id} parity never launched the finalize")
    m = cfg
    out = dict(near_tie_divergences=div, launches={
        k: launches[k] for k in SERVING_KERNELS}, steps=st["steps"],
        prefill_dispatches=st["prefill_dispatches"],
        first_token_logit_err=first_err,
        top_k_near_ties={i: list(r) for i, r in near_tie.items()})
    print(f"chunked parity ({arch_id}, float32, {n_layers} layers, "
          f"d {m.dh}, Hkv {m.n_kv}, G {m.group}, chunked 256, "
          f"supervised): {batch} requests {n} + {gen} in {dt:.2f} s, "
          f"{div} divergences at near-ties (token or top-K: "
          f"{near_tie}), tokens otherwise identical to "
          f"static_generate; first-token logits of the others within "
          f"{first_err:.3e} of lm_prefill's; {st['steps']} steps, "
          f"{st['prefill_dispatches']} prefill dispatches; launches "
          f"{out['launches']}")
    del eng
    return out


# ----------------------------------------------- phase 4 (supervised path) --

def phase_supervised_production(card: str, plain: dict):
    """The bf16 chunked serve of `phase_production` (now supervised:
    ``plain``) again with ``--chaos-seed 0``: the supervision counters and
    both runs' tok/s and TTFT.  Every request the chaos run never
    recomputed (no preemption or quarantine) must equal the plain serve
    token for token.  A recomputed one is rebuilt by chunk prefill over
    its prompt and emitted tokens, where the uninterrupted run had decoded
    them: in bf16 the two paths round differently and a later token may
    part, as in the reference (ROADMAP C.13; float32 recompute is held to
    the fault-free stream exactly in `phase_chaos_parity`), so for those
    the first parting token is recorded."""
    from repro_torch.configs.registry import get_arch
    n_layers = get_arch("qwen3-0.6b").model.n_layers
    summary, launches = production_serve(
        card, ["--prefill-chunk", "256", "--chaos-seed", "0"],
        "production chunked --chaos-seed 0")
    if summary["injected"] <= 0:
        fail("the --chaos-seed 0 serve injected no fault")
    disp = summary["stats"]["prefill_dispatches"]
    if launches["mita_chunk_prefill_fused"] != n_layers * disp:
        fail(f"chaos serve: chunk launches "
             f"{launches['mita_chunk_prefill_fused']} != {n_layers} x "
             f"{disp} dispatches")
    parted = {}
    for rid, toks in plain["tokens"].items():
        diff = np.nonzero(toks != summary["tokens"][rid])[0]
        recomputed = summary["preemptions"][rid]
        if diff.size and not recomputed:
            fail(f"chaos serve request {rid}, never recomputed, differs "
                 f"from the plain supervised serve at token {diff[0]}")
        if recomputed:
            parted[rid] = dict(recomputed=recomputed, first_parting_token=(
                int(diff[0]) if diff.size else None))
    keys = ("retries", "quarantined", "stragglers", "degradation_level",
            "preemptions")
    runs = {}
    for what, s in (("plain", plain), ("chaos", summary)):
        runs[what] = dict(tok_s=s["tok_s"], ttft_p50_ms=s["ttft_p50_s"] * 1e3,
                          ttft_p99_ms=s["ttft_p99_s"] * 1e3,
                          injected=s["injected"],
                          **{k: s["stats"][k] for k in keys})
        print(f"supervised serve ({card}), bf16, {what}: {runs[what]}")
    runs["recomputed_requests"] = parted
    same = len(plain["tokens"]) - len(parted)
    print(f"supervised serve: the {same} requests never recomputed equal "
          f"the plain serve's; recomputed (count, first parting token): "
          f"{parted}")
    return runs, launches


def phase_dense_production(card: str):
    """bf16 chunked (256) serves of tinyllama-1.1b and stablelm-1.6b at
    full width and depth through `repro_torch.launch.serve.main`: 8
    requests, prompt 512 + 64, 4 slots; tok/s, TTFT, peak memory and the
    serving kernels' launches (decode = layers x steps, chunk = layers x
    prefill dispatches; no window closes while decoding at 576 tokens, so
    the finalize's count is printed, not gated)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    res = {}
    for arch_id in DENSE_CELLS:
        m = get_arch(arch_id).model
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        summary = serve_main(["--arch", arch_id, "--engine", "continuous",
                              "--batch", "4", "--prompt-len", "512", "--gen",
                              "64", "--requests", "8", "--device", "cuda",
                              "--prefill-chunk", "256"])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if summary["finished"] != 8 or set(summary["reasons"]) != \
                {"complete"}:
            fail(f"{arch_id} serve finished {summary['reasons']}")
        for rid, tk in summary["tokens"].items():
            if len(tk) != 64 or tk.min() < 0 or tk.max() >= m.vocab:
                fail(f"{arch_id} serve request {rid} tokens malformed")
        st = summary["stats"]
        if launches["mita_paged_attention"] != m.n_layers * st["steps"] \
                or launches["mita_chunk_prefill_fused"] \
                != m.n_layers * st["prefill_dispatches"]:
            fail(f"{arch_id} serve launches {launches} != {m.n_layers} "
                 f"layers x {st['steps']} steps / "
                 f"{st['prefill_dispatches']} dispatches")
        res[arch_id] = dict(tok_s=summary["tok_s"],
                            ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
                            ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
                            steps=st["steps"],
                            prefill_dispatches=st["prefill_dispatches"],
                            max_memory_allocated_gib=peak / 2**30,
                            launches={k: launches[k]
                                      for k in SERVING_KERNELS})
        print(f"{arch_id} bf16 serve ({card}): {summary['tok_s']:.1f} tok/s, "
              f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{summary['ttft_p99_s'] * 1e3:.1f} ms, {st['steps']} steps, "
              f"{st['prefill_dispatches']} prefill dispatches, "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
              f"{res[arch_id]['launches']}")
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- the MoE family --

# (Hkv, G) at head dim 128 of the configs of the MoE slice
MOE_SHAPES = {"deepseek-moe-16b": (16, 1), "dbrx-132b": (8, 6),
              "internvl2-76b": (8, 8)}
MOE_ARCH = "deepseek-moe-16b"      # the one that fits the card
MOE_LAYERS = 4                     # depth of its float32 parity
MOE_OUT_TOL = 1e-5                 # float32 moe_apply, card vs CPU


def phase_kernels_moe():
    """B.1-B.3 at the decode shapes of deepseek-moe-16b (S 4, Hkv 16, G 1),
    dbrx-132b (Hkv 8, G 6: the first group size that is not a power of
    two) and internvl2-76b (Hkv 8, G 8), head dim 128, w = K = 128, M = 6,
    both dtypes, as `phase_kernels_d64` checks and times them; and B.4 at
    deepseek-moe-16b's forward lead [1, 16, 1] (m 32, N 4096)."""
    res = serving_kernels_at(MOE_SHAPES, D)
    hkv, g = MOE_SHAPES[MOE_ARCH]
    res["expert"] = {dt: check_expert(dt, shape=(hkv, g, D))
                     for dt in (torch.float32, torch.bfloat16)}
    return res


class _MoEInputs:
    """While active, records the inputs of the first ``n`` `moe_apply`
    calls of more than one token a row (chunk prefills) as the model
    makes them."""

    def __init__(self, n: int):
        self.n, self.calls = n, []

    def __enter__(self):
        from repro_torch.models import transformer as tfm
        self.tfm, self.fn = tfm, tfm.moe_apply

        def record(p, x, cfg, tp=None):
            if x.shape[1] > 1 and len(self.calls) < self.n:
                self.calls.append(x.clone())
            return self.fn(p, x, cfg, tp)

        tfm.moe_apply = record
        return self

    def __exit__(self, *exc):
        self.tfm.moe_apply = self.fn


def moe_card_vs_cpu(p, x, cfg) -> dict:
    """`moe_apply` on the card against the same call on the CPU (float32,
    the layer's parameters copied): the gate picks, queue slots and kept
    assignments exact and the outputs within MOE_OUT_TOL, except in a
    capacity group holding a token whose picks differ; each such token
    must be a router near-tie, the two experts' float64 logits apart by no
    more than float32 rounding can make of them (``(d + 1) 2^-24`` times
    the sum of |x_i r_ij|, for each of the two).  Returns the counts."""
    import math
    from repro_torch.models import moe
    b, n, d = x.shape
    g = math.gcd(b * n, moe.MOE_GROUPS)
    pc = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
              else v.cpu()) for k, v in p.items()}
    with torch.inference_mode():
        out_c, aux_c = moe.moe_apply(p, x, cfg)
        out_h, aux_h = moe.moe_apply(pc, x.cpu(), cfg)
        rc = moe.route(p, x.reshape(g, -1, d), cfg)
        rh = moe.route(pc, x.cpu().reshape(g, -1, d), cfg)
    idx_c, idx_h = rc.gate_idx.cpu(), rh.gate_idx
    cap = rh.cap
    differ = (idx_c != idx_h).any(-1)                           # [G, Tg]
    worst = 0.0
    for gi, ti in differ.nonzero().tolist():
        xt = x.reshape(g, -1, d)[gi, ti].cpu().double()
        r = pc["router"].double()
        logit = xt @ r
        mag = (xt[:, None].abs() * r.abs()).sum(0)
        j = int((idx_c[gi, ti] != idx_h[gi, ti]).nonzero()[0])
        ea, eb = int(idx_h[gi, ti, j]), int(idx_c[gi, ti, j])
        gap = abs(float(logit[ea] - logit[eb]))
        bound = (d + 1) * 2.0 ** -24 * float(mag[ea] + mag[eb])
        worst = max(worst, gap / bound)
        if gap > bound:
            fail(f"moe_apply card vs CPU: group {gi} token {ti} picks "
                 f"expert {eb} for {ea}, logit gap {gap:.3e} > its float32 "
                 f"rounding bound {bound:.3e}")
    ok = ~differ.any(-1)                                        # [G]
    for name, a, c in (("slot", rh.slot, rc.slot.cpu()),
                       ("keep", rh.slot < cap, rc.slot.cpu() < cap)):
        if not torch.equal(a[ok], c[ok]):
            fail(f"moe_apply card vs CPU: {name} differs away from a "
                 "router near-tie")
    oc = out_c.reshape(g, -1, d)[ok.to(x.device)].cpu()
    oh = out_h.reshape(g, -1, d)[ok]
    err = (oc - oh).abs().max().item()
    if not torch.allclose(oc, oh, atol=MOE_OUT_TOL, rtol=MOE_OUT_TOL):
        fail(f"moe_apply card vs CPU: max_abs_err {err} > {MOE_OUT_TOL}")
    return dict(max_abs_err=err, aux_err=abs(aux_c.item() - aux_h.item()),
                near_tie_tokens=int(differ.sum()),
                groups_compared=int(ok.sum()), groups=g,
                dropped=int((rh.slot >= cap).sum()),
                near_tie_gap_over_bound=worst)


def phase_moe_parity():
    """float32 (TF32 off), deepseek-moe-16b at MOE_LAYERS layers and full
    width (64 experts top-6, 2 shared):
      * `chunked_parity`: 4 requests of 512 + 160 chunked (256) through
        the supervised engine, held to `static_generate` except at proven
        near-ties, its launch gates.  This run raises
        ``moe_capacity_factor`` to ceil(n_experts / moe_top_k) = 11, so
        that every capacity group keeps all its tokens: with drops, which
        tokens drop depends on how a call groups the tokens, and the
        engine's chunks group them otherwise than the static prefill, in
        the reference too (the engine is held to the JAX engine with
        drops in `tests/test_torch_moe.py`);
      * with the real factor 1.25, on the serve's recorded chunk inputs
        (the first dispatch, every layer): `moe_card_vs_cpu`;
      * `lm_forward` with impl="pallas" against "sorted" at span = m
        (N 4096) layer by layer within LAYER_TOL (`routed_layer_err`),
        expert launches = layers x forwards."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    m = get_arch(MOE_ARCH).model
    real = dataclasses.replace(m, compute_dtype=torch.float32,
                               n_layers=MOE_LAYERS)
    cfg = dataclasses.replace(
        real, moe_capacity_factor=float(-(-m.n_experts // m.moe_top_k)))
    params = tfm.lm_init(torch.Generator(device="cuda").manual_seed(0),
                         cfg, "cuda")
    with _MoEInputs(MOE_LAYERS) as rec:
        out = chunked_parity(MOE_ARCH, cfg, params)
    moe_res = []
    for i, x in enumerate(rec.calls):
        lp = tfm.layer_params(params["blocks"], i)["moe"]
        moe_res.append(moe_card_vs_cpu(lp, x, real))
        print(f"moe_apply card vs CPU ({MOE_ARCH}, float32, factor "
              f"{real.moe_capacity_factor}, layer {i}, {tuple(x.shape)}): "
              f"{moe_res[-1]}")
    if len(moe_res) != MOE_LAYERS or not any(r["dropped"] for r in moe_res):
        fail(f"moe_apply card vs CPU: {len(moe_res)} recorded calls, "
             "or no assignment dropped at factor 1.25")
    out["moe_card_vs_cpu"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in moe_res),
        near_tie_tokens=sum(r["near_tie_tokens"] for r in moe_res),
        dropped=sum(r["dropped"] for r in moe_res))
    del rec
    toks = torch.as_tensor(synthetic_batch(DataConfig(
        vocab=m.vocab, seq_len=FWD_N, global_batch=1), 0)["tokens"],
        device="cuda")
    layer_err = routed_layer_err(params, real, toks)
    cfg_p = dataclasses.replace(real, attn=dataclasses.replace(
        real.attn, impl="pallas"))
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits = tfm.lm_forward(params, toks, cfg_p)
    torch.cuda.synchronize()
    n_exp = ops.launch_counts()["mita_expert_attention"]
    if n_exp != MOE_LAYERS or not torch.isfinite(logits).all():
        fail(f"{MOE_ARCH} pallas forward: expert launches {n_exp} != "
             f"{MOE_LAYERS}, or logits not finite")
    out["forward_layer_max_abs_err"] = layer_err
    print(f"{MOE_ARCH} forward (float32, {MOE_LAYERS} layers, N {FWD_N}): "
          f"routed partials, expert kernel vs span {FWD_N // W}, max_abs_err "
          f"{layer_err:.3e} (tol {LAYER_TOL}); expert launches {n_exp}")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_production(card: str):
    """bf16, deepseek-moe-16b at full width and depth (28 layers, 62.9 GiB
    of float32 weights) through `repro_torch.launch.serve.main`: 8
    requests of 512 + 160, 4 slots, chunk 256 (windows close at 640, so
    the finalize runs): tok/s, TTFT, `max_memory_allocated`; decode
    launches = layers x steps, chunk launches = layers x dispatches,
    finalize > 0.  Then a bf16 `lm_forward(impl="pallas")` at B 1, N
    4096: tok/s, expert launches = layers x forwards."""
    import dataclasses
    from repro_torch.configs.registry import arch_params, get_arch
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    arch = get_arch(MOE_ARCH)
    m = arch.model
    summary, launches = production_serve(
        card, ["--prefill-chunk", "256"], f"{MOE_ARCH} chunked",
        arch=MOE_ARCH)
    st = summary["stats"]
    if launches["mita_chunk_prefill_fused"] \
            != m.n_layers * st["prefill_dispatches"]:
        fail(f"{MOE_ARCH} serve: chunk launches "
             f"{launches['mita_chunk_prefill_fused']} != {m.n_layers} x "
             f"{st['prefill_dispatches']} dispatches")
    peak = summary["max_memory_allocated"]
    if peak >= 80e9:
        fail(f"{MOE_ARCH} serve: max_memory_allocated {peak} >= 80 GB")
    res = dict(tok_s=summary["tok_s"],
               ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
               ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
               steps=summary["steps"],
               prefill_dispatches=st["prefill_dispatches"],
               max_memory_allocated_gib=peak / 2**30,
               launches={k: launches[k] for k in SERVING_KERNELS})
    del summary
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(m, attn=dataclasses.replace(m.attn,
                                                          impl="pallas"))
    params = arch_params(arch, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    toks = torch.as_tensor(synthetic_batch(DataConfig(
        vocab=m.vocab, seq_len=FWD_N, global_batch=1), 0)["tokens"],
        device="cuda")
    with torch.inference_mode():
        tfm.lm_forward(params, toks, cfg)                 # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0, forwards = time.perf_counter(), 2
        for _ in range(forwards):
            logits = tfm.lm_forward(params, toks, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    n_exp = ops.launch_counts()["mita_expert_attention"]
    if n_exp != m.n_layers * forwards or not torch.isfinite(logits).all():
        fail(f"{MOE_ARCH} bf16 pallas forward: expert launches {n_exp} != "
             f"{m.n_layers} x {forwards}, or logits not finite")
    res["forward"] = dict(tok_s=forwards * FWD_N / dt,
                          ms=dt / forwards * 1e3, launches=n_exp)
    print(f"{MOE_ARCH} bf16 serve ({card}): {res['tok_s']:.1f} tok/s, TTFT "
          f"p50 {res['ttft_p50_ms']:.1f} ms p99 {res['ttft_p99_ms']:.1f} "
          f"ms, {res['steps']} steps, {res['prefill_dispatches']} prefill "
          f"dispatches, max_memory_allocated "
          f"{res['max_memory_allocated_gib']:.2f} GiB; launches "
          f"{res['launches']}; forward (impl=pallas, N {FWD_N}): "
          f"{res['forward']['tok_s']:.1f} tok/s, "
          f"{res['forward']['ms']:.1f} ms, expert launches {n_exp}")
    del params, logits
    torch.cuda.empty_cache()
    return res


# ------------------------------------- the vision families (ViT, whisper) --

VIT_PATCH, VIT_CLASSES = 768, 1000   # 16 x 16 x 3 patches; ImageNet classes
VIT_WINDOW = {196: 4, 1024: 16}      # 224^2: m = k = 49; 512^2: m 64, k 49
VIT_K = 49                           # Tab. 4's expert width
VISION_B = 4                         # batch of the float32 checks
VISION_SERVE_B = {"vit": 64, "vit_512": 8, "whisper_encoder": 4}
WHISPER_START = 50258                # <|startoftranscript|>
LOGIT_TOL = 1e-4          # float32 logits of two paths that decide alike
CARD_CPU_TOL = 1e-4       # float32 attention rows, card vs CPU, one call


def vit_cfg(n: int, dtype=torch.float32, **attn):
    """ViT-B/16 (`benchmarks/tables.py`'s vit_b widths: 12 layers, d 768,
    12 heads of 64, d_ff 3072) built as `benchmarks/common.py`'s
    ``tiny_vit_cfg`` builds its config: bidirectional MiTA, n_kv =
    n_heads, s = 1, pool1d landmarks, block_q 32; N patches, window
    `VIT_WINDOW[N]`, k 49.  float32 parameters, ``dtype`` compute."""
    from repro_torch.models.modules import AttnConfig, ModelConfig
    a = dict(backend="mita", window=VIT_WINDOW[n], k=VIT_K, s=1,
             causal=False, block_q=32, landmark="pool1d")
    a.update(attn)
    return ModelConfig(name=f"vit-b16-{n}", n_layers=12, d_model=768,
                       n_heads=12, n_kv=12, d_ff=3072, vocab=VIT_CLASSES,
                       attn=AttnConfig(**a), param_dtype=torch.float32,
                       compute_dtype=dtype)


def whisper_cfg(dtype=torch.float32, **attn):
    """whisper-tiny at its registry config (full width and depth)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    m = get_arch("whisper-tiny").model
    return dataclasses.replace(m, compute_dtype=dtype,
                               attn=dataclasses.replace(m.attn, **attn))


def with_attn(cfg, **attn):
    import dataclasses
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             **attn))


def attn_block_q(cfg, n: int) -> int:
    """The sorted path's query block as `modules.attention_apply` sizes
    it (bidirectional)."""
    mcfg = cfg.attn.mita_cfg(n, bidir=True)
    return min(cfg.attn.block_q, cfg.attn.window * mcfg.s, n * mcfg.s)


def numpy_input(shape, seed: int) -> torch.Tensor:
    """Standard normal numpy draws on the card (the CPU tests' inputs are
    made the same way)."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to("cuda")


def vision_layer_qkv(which: str, params, x, cfg, i: int):
    """Layer ``i``'s (q, k, v) of the ViT ("vit") or whisper's encoder
    ("whisper") on the block input x."""
    from repro_torch.models import modules as nn
    from repro_torch.models import transformer as tfm
    lp = tfm.layer_params(params["blocks" if which == "vit" else "enc"], i)
    pos = torch.arange(x.shape[1], device=x.device)
    return nn._qkv(lp["attn"], nn.rms_norm(x, lp["ln1"]), cfg, pos)


def vision_layer_step(which: str, params, x, cfg, i: int):
    """Layer ``i`` of the ViT or whisper's encoder on x, through the
    model's own block."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as wh
    pos = torch.arange(x.shape[1], device=x.device)
    if which == "vit":
        return tfm.block_apply(tfm.layer_params(params["blocks"], i), x, cfg,
                               pos, bidir=True)[0]
    return wh.enc_block_apply(tfm.layer_params(params["enc"], i), x, cfg,
                              pos)


def vision_layers_err(which: str, params, x, cfg) -> float:
    """Every layer's routed branch, expert kernel vs span = m on one
    routing (`routed_branch_err`, float32); every sub-query must be active
    (bidirectional).  The layers run the span path.  Returns the largest
    error."""
    n = x.shape[1]
    mcfg = cfg.attn.mita_cfg(n, bidir=True)
    cfg_s = with_attn(cfg, impl="sorted", expert_span=mcfg.m)
    bq = attn_block_q(cfg, n)
    worst = 0.0
    for i in range(cfg.n_layers):
        q, k, v = vision_layer_qkv(which, params, x, cfg, i)
        err, act = routed_branch_err(q, k, v, mcfg, bq,
                                     f"{which} layer {i}")
        if not bool(act.all()):
            fail(f"{which} layer {i}: {int((~act).sum())} inactive rows in "
                 "a bidirectional layer")
        worst = max(worst, err)
        x = vision_layer_step(which, params, x, cfg_s, i)
    return worst


def vision_models():
    """float32 parameters from seed 0 and layer-0 block inputs from numpy
    draws at the production batches (`VISION_SERVE_B`): the ViT-B/16 at
    224^2 ("vit") and at 512^2 ("vit_512", the same parameters), and
    whisper-tiny's encoder ("whisper_encoder").  {name: (model, params,
    cfg, x)}."""
    from repro_torch.models import whisper as wh
    from repro_torch.models.vit import vit_embed, vit_init
    out = {}
    with torch.inference_mode():
        p = vit_init(torch.Generator(device="cuda").manual_seed(0),
                     vit_cfg(196), VIT_PATCH, VIT_CLASSES, "cuda")
        for name, n, seed in (("vit", 196, 1), ("vit_512", 1024, 5)):
            cfg = vit_cfg(n)
            out[name] = ("vit", p, cfg, vit_embed(p, numpy_input(
                (VISION_SERVE_B[name], n, VIT_PATCH), seed), cfg))
        cfg = whisper_cfg()
        p = wh.whisper_init(torch.Generator(device="cuda").manual_seed(0),
                            cfg, 1500, "cuda")
        out["whisper_encoder"] = ("whisper", p, wh.encoder_cfg(cfg),
                                  wh.enc_embed(p, numpy_input(
                                      (VISION_SERVE_B["whisper_encoder"],
                                       1500, cfg.d_model), 2), cfg))
    return out


def phase_kernels_vision():
    """B.4 at the shapes the vision paths give it, on bidirectional
    assignments from a real routing (layer 0, float32 weights, numpy
    inputs, at the production batches): the ViT-B/16 at 224^2, B 64
    (lead [64, 12, 1], m 49, K 49, NS 196) and at 512^2, B 8 (lead [8,
    12, 1], m 64, K 49, NS 1024); whisper-tiny's encoder on [4, 1500, 384]
    audio (lead [4, 6, 1], m 25, K 64, NS 1500).  Both dtypes (bf16: the
    same routing, inputs rounded), against the plain version (1e-5 /
    2e-2, P rounded where the tensor-core kernel rounds it); every row
    active and finite; timed (CUDA events, cold L2), launches and grid
    from a trace, the bound; the control with keys 32..48 of expert 1
    dropped must fail."""
    from repro_torch.core import mita_sparse as msp
    from repro_torch.kernels import mita_expert_attn as mea
    res = {}
    for name, (which, params, cfg, x) in vision_models().items():
        n = x.shape[1]
        mcfg = cfg.attn.mita_cfg(n, bidir=True)
        with torch.inference_mode():
            q, k, v = vision_layer_qkv(which, params, x, cfg, 0)
            _, _, r, ke32, ve32, valid = routing(q, k, v, mcfg)
            q32, a, _ = msp.sort_subqueries(q, r, mcfg)
        del params, x, q, k, v, r
        shape = (f"lead [{VISION_SERVE_B[name]}, {cfg.n_heads}, 1], m "
                 f"{mcfg.m}, K {mcfg.k}, NS {n}, d {cfg.dh}")
        if not bool((a < mcfg.m).all()) or not bool(valid.all()):
            fail(f"{name}: a bidirectional routing with inactive rows or "
                 "invalid expert keys")
        res[name] = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[dtype]
            args = (q32.to(dtype), a, ke32.to(dtype), ve32.to(dtype), valid)
            path = mea.expert_path(dtype, cfg.dh)
            rp = path == mea.TENSOR_CORES
            ref = mea.expert_attention_plain(*args, round_p=rp)
            got = mea.mita_expert_attention(*args)
            torch.cuda.synchronize()
            if not bool((got[2] > 0).all()) \
                    or not bool(torch.isfinite(got[0].float()).all()):
                fail(f"B.4 {name} {dtype}: an empty or non-finite row")
            errs = []
            for part, xx, yy in zip(("o / l", "m", "l"),
                                    expert_partials(got),
                                    expert_partials(ref)):
                errs.append((xx - yy).abs().max().item())
                if not torch.allclose(xx, yy, atol=tol, rtol=tol):
                    fail(f"B.4 {name} {dtype} {part} max_abs_err "
                         f"{errs[-1]}")
            dropped = valid.clone()
            dropped[..., 1, 32:49] = False
            o, _, l = mea.mita_expert_attention(*args[:4], dropped)
            use = a == 1
            xx = o.float()[use] / l[use][:, None]
            yy = ref[0].float()[use] / ref[2][use][:, None]
            ctrl = (xx - yy).abs().max().item()
            if ctrl <= tol or torch.allclose(xx, yy, atol=tol, rtol=tol):
                fail(f"B.4 {name} {dtype}: the control with keys 32..48 of "
                     f"expert 1 dropped passes the check ({ctrl})")
            del ref, got, o, l, xx, yy
            kern = lambda: mea.mita_expert_attention(*args)  # noqa: E731
            pl = lambda: mea.expert_attention_plain(*args)  # noqa: E731
            ms, pms = cuda_ms(kern, iters=20), cuda_ms(pl, iters=5)
            rec = kernel_record(kern, iters=20)
            want = ("expert_mma_kernel" if rp else "expert_attn_kernel")
            if rec["cuda_kernels"] != [want]:
                fail(f"B.4 {name} {dtype}: traced {rec['cuda_kernels']}")
            bms, by = bound_ms(*expert_bound(args, dtype), dtype)
            res[name][dtype] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, tol=tol,
                control_max_abs_err=ctrl, path=path, shape=shape, **rec)
            print(f"mita_expert_attention {name} {dtype} ({shape}, "
                  f"bidirectional): max_abs_err {max(errs):.3e} (tol {tol}),"
                  f" kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bms:.5f} ms ({by}); {record_text(rec)}; control (keys "
                  f"32..48 of expert 1 dropped, {int(use.sum())} rows) "
                  f"{ctrl:.3e} fails the check, as it must")
            del args
            torch.cuda.empty_cache()
        del q32, a, ke32, ve32, valid
        torch.cuda.empty_cache()
    return res


def _gap_bound(u_a, w1_a, w2_a, u_b, w1_b, w2_b):
    """Two sides rank the scores u.w1 / sqrt(d) and u.w2 / sqrt(d) (each a
    float32 dot product) in opposite orders.  float64 rows [R, d] of each
    side's u, w1, w2.  Returns the exact gap of side a's two scores and the
    most it can be for the two sides to part: twice float32's rounding of
    a dot product in any summation order on the larger score (`pick_gaps`'
    bound), plus what the two sides' input differences make of the gap."""
    d = u_a.shape[-1]
    dw = w1_a - w2_a
    mag = torch.stack([(u * w).abs().sum(-1) for u, w in (
        (u_a, w1_a), (u_a, w2_a), (u_b, w1_b), (u_b, w2_b))]).amax(0)
    bound = 2 * (d + 1) * 2.0 ** -24 * mag \
        + ((u_a - u_b).abs() * dw.abs()).sum(-1) \
        + (u_b.abs() * ((w1_a - w1_b).abs()
                        + (w2_a - w2_b).abs())).sum(-1)
    return (u_a * dw).sum(-1).abs() / d ** 0.5, bound / d ** 0.5


def parted_decisions(side_a, side_b, mcfg, what: str):
    """Where two computations of one bidirectional attention call's
    routing part (each side (q, k, v), on any device): rows routed to
    another expert (first-index argmax of the routing logits), and experts
    whose top-k key sets differ.  Each parted decision must be a near tie
    (`_gap_bound`, in float64 on the CPU): a row's two experts by their
    routing logits, every pair of keys that one side picks and the other
    leaves by their landmark scores; fails otherwise.  Returns (rows [L, N]
    that a parted decision moved, {route_rows, key_sets, widest gap over
    its bound})."""
    from repro_torch.core import mita as mref
    sides = []
    for q, k, v in (side_a, side_b):
        lead, n = q.shape[:-2], q.shape[-2]
        q_lm, s_kv, r = routing(q, k, v, mcfg)[:3]
        top = torch.sort(mref.topk_indices(s_kv, mcfg)[0].long(),
                         dim=-1).values

        def flat(t, dt=torch.float64):
            t = t.expand(lead + t.shape[-2:])
            return t.reshape((-1,) + t.shape[-2:]).cpu().to(dt)
        sides.append((flat(q), flat(k), flat(q_lm), flat(top, torch.long),
                      mref.argmax_first(r).reshape(-1, n).cpu()))
    (qa, ka, la, ta, ea), (qb, kb, lb, tb, eb) = sides
    moved = ea != eb
    li, ni = moved.nonzero().T
    ra, rb = ea[li, ni], eb[li, ni]
    gaps = [_gap_bound(qa[li, ni], la[li, ra], la[li, rb], qb[li, ni],
                       lb[li, ra], lb[li, rb])]
    pairs = []
    for l, j in (ta != tb).any(-1).nonzero().tolist():
        a_set, b_set = set(ta[l, j].tolist()), set(tb[l, j].tolist())
        pairs += [(l, j, x, y) for x in a_set - b_set for y in b_set - a_set]
        moved[l] |= (ea[l] == j) | (eb[l] == j)
    if pairs:
        l, j, x, y = torch.tensor(pairs).T
        gaps.append(_gap_bound(la[l, j], ka[l, x], ka[l, y], lb[l, j],
                               kb[l, x], kb[l, y]))
    gap = torch.cat([g for g, _ in gaps])
    bound = torch.cat([b for _, b in gaps])
    ratio = (gap / bound.clamp(min=1e-300)).max().item() \
        if gap.numel() else 0.0
    if bool((gap > bound).any()):
        fail(f"{what}: a routing or top-k decision parts away from a near "
             f"tie (widest gap {ratio:.2f}x its bound)")
    return moved, dict(route_rows=int(li.numel()),
                       key_sets=len({p[:2] for p in pairs}),
                       gap_over_bound=ratio)


def card_vs_cpu_rows(q, k, v, mcfg, out_card, out_cpu, what) -> dict:
    """One attention call on the card against the same call on the CPU
    (same inputs): rows within CARD_CPU_TOL, except rows that a decision
    the two devices took apart moved, each such decision a near tie
    (`parted_decisions`)."""
    moved, parted = parted_decisions((q, k, v), (q.cpu(), k.cpu(), v.cpu()),
                                     mcfg, what)
    diff = (out_card.float().cpu() - out_cpu.float()).abs()
    tol = CARD_CPU_TOL * (1 + out_cpu.float().abs())
    bad = (diff > tol).any(-1).reshape(moved.shape)
    err = diff.reshape(moved.shape + (-1,))[~moved].max().item()
    if bool((bad & ~moved).any()):
        fail(f"{what}: card vs CPU max_abs_err {err} > {CARD_CPU_TOL} on "
             "rows of equal decisions")
    return dict(max_abs_err=err, near_tie_rows=int(moved.sum()), **parted)


def first_parting(which: str, sides, what: str):
    """Two forwards of the ViT ("vit") or whisper's encoder ("whisper"),
    each side (params, block input, cfg) on any device, run layer by layer
    through the model's own block.  At each layer the two sides' routing
    decisions are compared (`parted_decisions`, which fails where one
    parts away from a near tie).  Returns the first layer at which any
    decision parts, with what parted there, or None where none does."""
    xs = [x for _, x, _ in sides]
    cfg = sides[0][2]
    mcfg = cfg.attn.mita_cfg(xs[0].shape[1], bidir=True)
    for i in range(cfg.n_layers):
        qkv = [vision_layer_qkv(which, p, x, c, i)
               for (p, _, c), x in zip(sides, xs)]
        _, parted = parted_decisions(*qkv, mcfg, f"{what}, layer {i}")
        if parted["route_rows"] or parted["key_sets"]:
            return dict(layer=i, **parted)
        xs = [vision_layer_step(which, p, x, c, i)
              for (p, _, c), x in zip(sides, xs)]
    return None


def tree_to_cpu(tree):
    if isinstance(tree, dict):
        return {key: tree_to_cpu(val) for key, val in tree.items()}
    return tree.cpu()


def argmax_gate(a, b, what: str) -> int:
    """Greedy argmax of logits a equals b's except where b's two best
    logits lie within PARITY_GAP.  Returns the number of such rows."""
    ta, tb = a.argmax(-1), b.argmax(-1)
    top2 = torch.topk(b.float(), 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < PARITY_GAP
    if bool(((ta != tb) & ~near).any()):
        fail(f"{what}: greedy argmax differs away from a near tie")
    return int(((ta != tb) & near).sum())


def logits_gate(la, lb, parting, what: str) -> float:
    """Two float32 forwards' logits: within LOGIT_TOL where no routing or
    top-k decision parted between them (`first_parting` gave None); past
    a near-tie parting, argmax equal except at near ties (`argmax_gate`).
    Returns the largest difference."""
    err = (la - lb).abs().max().item()
    if parting is None and err > LOGIT_TOL:
        fail(f"{what}: no decision parts, yet the logits differ by {err} > "
             f"{LOGIT_TOL}")
    argmax_gate(la, lb, what)
    return err


def phase_vit_parity():
    """float32 (TF32 off), the ViT-B/16, 12 layers, random weights from
    seed 0 and numpy patches: every layer's routed branch, expert kernel
    (impl="pallas") vs the sorted path at span = m, on one routing within
    LAYER_TOL (every sub-query active), at 224^2 (B 4, N 196) and 512^2
    (B 4, N 1024); at 224^2, the logits of `vit_forward` pallas vs sorted
    span = m and of a random-landmark `vit_forward` on the card vs the
    CPU, each pair also walked layer by layer to the first routing or
    top-k decision that parts (`first_parting`: a near tie, or the logits
    within LOGIT_TOL where none parts; `logits_gate`);
    `mita_attention_sparse(impl="pallas")` on layer 0's q/k/v with a
    pool2d config ((14, 14) -> (7, 7)), card vs CPU (`card_vs_cpu_rows`);
    B.4 launches = 12 x pallas forwards + the pool2d call."""
    from repro_torch.core import mita_sparse as msp
    from repro_torch.core.mita import MiTAConfig
    from repro_torch.kernels import ops
    from repro_torch.models.vit import vit_embed, vit_forward, vit_init
    n = 196
    cfg = vit_cfg(n)
    mcfg = cfg.attn.mita_cfg(n, bidir=True)
    cfg_p = with_attn(cfg, impl="pallas")
    cfg_s = with_attn(cfg, expert_span=mcfg.m)
    cfg_r = with_attn(cfg_p, landmark="random")
    params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      VIT_PATCH, VIT_CLASSES, "cuda")
    patches = numpy_input((VISION_B, n, VIT_PATCH), 1)
    res = {}
    with torch.inference_mode():
        x = vit_embed(params, patches, cfg)
        res["layer_max_abs_err"] = vision_layers_err("vit", params, x, cfg)
        c512 = vit_cfg(1024)
        res["layer_max_abs_err_512"] = vision_layers_err(
            "vit", params, vit_embed(params, numpy_input(
                (VISION_B, 1024, VIT_PATCH), 5), c512), c512)
        # the main path: pallas, pool2d and random-landmark calls
        ops.reset_launch_counts()
        lp = vit_forward(params, patches, cfg_p)
        q, k, v = vision_layer_qkv("vit", params, x, cfg, 0)
        m2d = MiTAConfig(m=49, k=VIT_K, s=1, causal=False,
                         landmark="pool2d", grid_hw=(14, 14), m_hw=(7, 7))
        o2 = msp.mita_attention_sparse(q, k, v, m2d, impl="pallas",
                                       block_q=4)
        lr = vit_forward(params, patches, cfg_r)
        forwards = 2
        launches = ops.launch_counts()["mita_expert_attention"]
        if lp.shape != (VISION_B, VIT_CLASSES) \
                or not bool(torch.isfinite(lp).all()):
            fail(f"vit logits malformed {tuple(lp.shape)}")
        # pallas vs sorted at span = m
        ls = vit_forward(params, patches, cfg_s)
        res["parting_pallas_vs_sorted"] = first_parting(
            "vit", ((params, x, cfg_p), (params, x, cfg_s)),
            "vit pallas vs sorted")
        res["logits_pallas_vs_sorted"] = logits_gate(
            lp, ls, res["parting_pallas_vs_sorted"], "vit pallas vs sorted")
        # pool2d on layer 0's q/k/v, the card against the CPU
        o2_cpu = msp.mita_attention_sparse(q.cpu(), k.cpu(), v.cpu(), m2d,
                                           impl="pallas", block_q=4)
        res["pool2d_card_vs_cpu"] = card_vs_cpu_rows(
            q, k, v, m2d, o2, o2_cpu, "vit pool2d layer 0")
        # random landmarks through vit_forward, the card against the CPU
        cpu = tree_to_cpu(params)
        lr_cpu = vit_forward(cpu, patches.cpu(), cfg_r)
        res["parting_random_card_vs_cpu"] = first_parting(
            "vit", ((params, x, cfg_r),
                    (cpu, vit_embed(cpu, patches.cpu(), cfg_r), cfg_r)),
            "vit random landmarks, card vs CPU")
        res["random_logits_card_vs_cpu"] = logits_gate(
            lr.cpu(), lr_cpu, res["parting_random_card_vs_cpu"],
            "vit random landmarks, card vs CPU")
    if launches != cfg.n_layers * forwards + 1:
        fail(f"vit: expert launches {launches} != {cfg.n_layers} x "
             f"{forwards} pallas forwards + 1 pool2d call")
    res["launches"] = launches
    print(f"vit parity (float32, {cfg.n_layers} layers, B {VISION_B}): "
          f"per-layer routed partials, expert kernel vs span = m: N 196 "
          f"(m {mcfg.m}, k {mcfg.k}) max_abs_err "
          f"{res['layer_max_abs_err']:.3e}, N 1024 (m 64, k {VIT_K}) "
          f"{res['layer_max_abs_err_512']:.3e} (tol {LAYER_TOL}); logits "
          f"pallas vs sorted max {res['logits_pallas_vs_sorted']:.3e}, first "
          f"parting decision {res['parting_pallas_vs_sorted']}; pool2d "
          f"(14, 14) -> (7, 7) card vs CPU {res['pool2d_card_vs_cpu']}; "
          f"random landmarks card vs CPU logits max "
          f"{res['random_logits_card_vs_cpu']:.3e}, first parting decision "
          f"{res['parting_random_card_vs_cpu']}; expert launches "
          f"{launches} = {cfg.n_layers} x {forwards} + 1")
    del params, cpu
    return res


def phase_whisper_parity():
    """float32 (TF32 off), whisper-tiny at full width and depth (4 + 4
    layers, d 384), random weights from seed 0, numpy audio [4, 1500,
    384]: the encoder's routed branch layer by layer, expert kernel vs
    span = m, within LAYER_TOL; 448 greedy decode steps from token 50258
    through `whisper_init_serve` / `whisper_decode_step` (impl="pallas";
    window closes at t = 64 .. 448), every step's logits within
    LOGIT_TOL of `whisper_decode_train` on the emitted stream, the
    greedy tokens equal to that path's argmax except at near ties
    (1e-3)."""
    from repro_torch.core.mita import argmax_first
    from repro_torch.models import whisper as wh
    cfg = whisper_cfg(impl="pallas")
    params = wh.whisper_init(torch.Generator(device="cuda").manual_seed(0),
                             cfg, 1500, "cuda")
    audio = numpy_input((VISION_B, 1500, cfg.d_model), 2)
    steps = 448
    res = {}
    with torch.inference_mode():
        ecfg = wh.encoder_cfg(cfg)
        res["encoder_layer_max_abs_err"] = vision_layers_err(
            "whisper", params, wh.enc_embed(params, audio, cfg), ecfg)
        st = wh.whisper_init_serve(params, audio, cfg, steps)
        tok = torch.full((VISION_B,), WHISPER_START, dtype=torch.int32,
                         device="cuda")
        fed, step_logits = [tok], []
        for pos in range(steps):
            lg, st = wh.whisper_decode_step(params, st, tok, pos, cfg)
            step_logits.append(lg)
            tok = argmax_first(lg).to(torch.int32)
            fed.append(tok)
        step_logits = torch.stack(step_logits, dim=1)        # [B, 448, V]
        enc = wh.whisper_encode(params, audio, cfg)
        tf = wh.whisper_decode_train(params, enc,
                                     torch.stack(fed[:steps], dim=1), cfg)
        err = (step_logits - tf).abs()
        per_step = err.amax(dim=(0, 2))
        res["decode_logits_max_abs_err"] = per_step.max().item()
        if not bool(torch.isfinite(step_logits).all()) \
                or per_step.max().item() > LOGIT_TOL:
            worst = int(per_step.argmax())
            fail(f"whisper decode vs teacher forcing: max_abs_err "
                 f"{per_step.max().item()} at step {worst} > "
                 f"{LOGIT_TOL}")
        res["near_tie_tokens"] = argmax_gate(step_logits, tf,
                                             "whisper greedy decode")
    print(f"whisper parity (float32, {cfg.n_layers} + {cfg.n_layers} "
          f"layers, d {cfg.d_model}, B {VISION_B}): "
          f"encoder routed partials, expert kernel vs span 25: max_abs_err "
          f"{res['encoder_layer_max_abs_err']:.3e} (tol {LAYER_TOL}); "
          f"{steps} decode steps vs whisper_decode_train: logits max_abs_err "
          f"{res['decode_logits_max_abs_err']:.3e} (tol {LOGIT_TOL}), "
          f"{res['near_tie_tokens']} near-tie token differences")
    del params, st, step_logits, tf
    return res


def profiled(fn, n: int = 1) -> dict:
    """``n`` calls of ``fn`` under `torch.profiler` (CPU + CUDA): wall and
    device ms a call, the device-busy share of the wall time (the
    profiler's own host cost included), the five kernels of most device
    time and the expert kernel's share (`launch.profile_decode`'s
    counting)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_decode import _kernel_us, _top_kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = _kernel_us(avgs)
    port = _top_kernels(avgs, dev_us, port=True)
    return dict(wall_ms=wall * 1e3 / n, device_ms=dev_us / 1e3 / n,
                busy_share=dev_us / 1e3 / (wall * 1e3),
                expert_share=sum(v["share"] for k, v in port.items()
                                 if "expert" in k),
                top_kernels={k: round(v["share"], 4) for k, v in
                             _top_kernels(avgs, dev_us, n=5).items()})


def phase_vision_production(card: str):
    """bf16 compute (f32 parameters), impl="pallas": the ViT-B/16's
    images/s at B 64 x N 196 and B 8 x N 1024 (mean of 3 forwards after
    one warm-up), peak memory, B.4 launches = 12 x forwards; whisper-tiny's
    encode ms on [4, 1500, 384] (mean of 3 after one warm-up), greedy
    decode tok/s over 448 steps from `whisper_init_serve` (4 streams),
    peak memory, B.4 launches = 4 x encodes.  The launch counters are set
    to 0 just before each part and read just after."""
    from repro_torch.core.mita import argmax_first
    from repro_torch.kernels import ops
    from repro_torch.models import whisper as wh
    from repro_torch.models.vit import vit_forward, vit_init
    res = {}
    params = vit_init(torch.Generator(device="cuda").manual_seed(0),
                      vit_cfg(196, torch.bfloat16), VIT_PATCH, VIT_CLASSES,
                      "cuda")
    for n, b in ((196, 64), (1024, 8)):
        cfg = vit_cfg(n, torch.bfloat16, impl="pallas")
        patches = numpy_input((b, n, VIT_PATCH), 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times = []
        with torch.inference_mode():
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = vit_forward(params, patches, cfg)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        launches = ops.launch_counts()["mita_expert_attention"]
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"bf16 vit N {n}: non-finite logits")
        if launches != cfg.n_layers * 4:
            fail(f"bf16 vit N {n}: expert launches {launches} != "
                 f"{cfg.n_layers} x 4")
        s = sum(times[1:]) / 3
        key = f"vit_b{b}_n{n}"
        res[key] = dict(images_s=b / s, ms=s * 1e3, launches=launches,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        with torch.inference_mode():
            res[key]["profile"] = profiled(
                lambda: vit_forward(params, patches, cfg))
        print(f"bf16 vit ({card}) B {b} x N {n} (m {n // VIT_WINDOW[n]}, k "
              f"{VIT_K}): {res[key]['images_s']:.1f} images/s, "
              f"{res[key]['ms']:.2f} ms a forward, peak "
              f"{res[key]['peak_gib']:.2f} GiB, expert launches {launches} "
              f"= {cfg.n_layers} x 4 forwards; one forward profiled: "
              f"{res[key]['profile']}")
        del patches, logits
    del params
    torch.cuda.empty_cache()

    cfg = whisper_cfg(torch.bfloat16, impl="pallas")
    params = wh.whisper_init(torch.Generator(device="cuda").manual_seed(0),
                             cfg, 1500, "cuda")
    audio = numpy_input((VISION_B, 1500, cfg.d_model), 4)
    steps = 448
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wh.whisper_encode(params, audio, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        st = wh.whisper_init_serve(params, audio, cfg, steps)
        tok = torch.full((VISION_B,), WHISPER_START, dtype=torch.int32,
                         device="cuda")
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(steps):
            lg, st = wh.whisper_decode_step(params, st, tok, pos, cfg)
            tok = argmax_first(lg).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    launches = ops.launch_counts()["mita_expert_attention"]
    with torch.inference_mode():
        enc_prof = profiled(lambda: wh.whisper_encode(params, audio, cfg))
        st = wh.whisper_init_serve(params, audio, cfg, steps)

        def decode8():
            t = torch.full((VISION_B,), WHISPER_START, dtype=torch.int32,
                           device="cuda")
            nonlocal st
            for pos in range(8):
                lg, st = wh.whisper_decode_step(params, st, t, pos, cfg)
                t = argmax_first(lg).to(torch.int32)

        dec_prof = profiled(decode8)
    toks = torch.stack(out, 1)
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        fail("bf16 whisper decode: tokens out of the vocabulary")
    if launches != cfg.n_layers * 5:
        fail(f"bf16 whisper: expert launches {launches} != {cfg.n_layers} "
             "layers x 5 encodes")
    res["whisper"] = dict(
        encode_ms=sum(times[1:]) / 3 * 1e3,
        decode_tok_s=VISION_B * steps / dec_s,
        decode_ms_per_step=dec_s / steps * 1e3, launches=launches,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        encode_profile=enc_prof, decode_profile_8_steps=dec_prof)
    w = res["whisper"]
    print(f"bf16 whisper-tiny ({card}): encode [4, 1500, 384] "
          f"{w['encode_ms']:.2f} ms, greedy decode {steps} steps x 4 "
          f"streams {w['decode_tok_s']:.1f} tok/s "
          f"({w['decode_ms_per_step']:.2f} ms a step), peak "
          f"{w['peak_gib']:.2f} GiB, expert launches {launches} = "
          f"{cfg.n_layers} x 5 encodes; one encode profiled: {enc_prof}; "
          f"8 decode steps profiled: {dec_prof}")
    del params, st
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- training --

TRAIN_ARCH = "qwen3-0.6b"
TRAIN_FAMILIES = ("qwen3-0.6b", "deepseek-moe-16b", "internvl2-76b",
                  "mamba2-370m", "recurrentgemma-9b", "whisper-tiny")
TRAIN_FULL = ["--arch", TRAIN_ARCH, "--batch", "4", "--seq", "4096",
              "--data-parallel", "1", "--model-parallel", "1"]
TRAIN_STEPS = 6
RESUME_LAYERS = 4          # the restart check's depth (from 28)
TRAIN_LOSS_TOL = 1e-5      # float32 loss, card vs CPU (nats)
TRAIN_GRAD_TOL = 1e-4      # every gradient leaf, relative to its max |g|
TRAIN_CKPT = HERE / "build" / "chip_smoke_train"


def train_cli(args: list, what: str, expect_failure: str = "",
              launcher: tuple = ()) -> dict:
    """``python -m repro_torch.launch.train`` in a subprocess, so that its
    cuBLAS workspace setting comes before CUDA starts in that process:
    its ``summary`` line, or (``expect_failure``) its error message.
    ``launcher``: a module that starts it (``torch.distributed.run`` and
    its flags)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE / "src")] + [x for x in (env.get("PYTHONPATH"),) if x])
    start = ["-m", *launcher] if launcher else []
    proc = subprocess.run(
        [sys.executable, *start, "-m", "repro_torch.launch.train", *args],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    if expect_failure:
        if proc.returncode == 0 or expect_failure not in proc.stderr:
            fail(f"{what}: expected a failure with {expect_failure!r}, got "
                 f"rc {proc.returncode}: {proc.stderr[-2000:]}")
        return {}
    if proc.returncode != 0:
        fail(f"{what}: rc {proc.returncode}: {proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("step "):
            print(f"  [{what}] {line}")
    summ = [x for x in lines if x.startswith("summary ")]
    if not summ:
        fail(f"{what}: no summary line in {proc.stdout[-2000:]}")
    return json.loads(summ[-1][len("summary "):])


def _npz_equal(a: Path, b: Path) -> tuple[int, list]:
    """(arrays compared, keys whose bits differ) of two checkpoints."""
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            fail(f"checkpoint keys differ: "
                 f"{sorted(set(x.files) ^ set(y.files))}")
        bad = []
        for k in x.files:
            u, v = x[k], y[k]              # each access reads the file
            if u.dtype != v.dtype or u.shape != v.shape \
                    or not np.array_equal(u.reshape(-1).view(np.uint8),
                                          v.reshape(-1).view(np.uint8)):
                bad.append(k)
        return len(x.files), bad


def train_card_vs_cpu(arch_id: str, microbatch: int = 1) -> dict:
    """One float32 `train_step` of ``arch_id``'s smoke config from the same
    parameters (drawn on the CPU) and batch on the card and on the CPU:
    loss within TRAIN_LOSS_TOL, every gradient leaf (the first moment
    after one step, (1 - b1) x the clipped gradient) within
    TRAIN_GRAD_TOL of its max.  With ``microbatch`` 2 the card's two-slice
    step is held to its one-slice step instead."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns, train_step
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    arch = get_arch(arch_id, smoke=True)
    fns = family_fns(arch)
    p0 = fns["init"](torch.Generator().manual_seed(0), "cpu")
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab, seq_len=64,
                                         global_batch=4), 0)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    runs = {}
    for key, dev, mb in (("ref", "cpu" if microbatch == 1 else "cuda", 1),
                         ("card", "cuda", microbatch)):
        # a copy: the step updates its parameters in place
        p = tree_map(lambda t: t.to(dev, copy=True), p0)
        _, st, m = train_step(p, adamw_init(p), batch, fns["loss"], opt,
                              microbatch=mb)
        runs[key] = (float(m["loss"]), [x.cpu() for x in tree_leaves(st.mu)])
    (l_ref, g_ref), (l_card, g_card) = runs["ref"], runs["card"]
    loss_err = abs(l_card - l_ref)
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(g_card, g_ref))
    what = f"{arch_id} train_step " + ("card vs CPU" if microbatch == 1
                                       else f"microbatch {microbatch} vs 1")
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and all(float(b.abs().max()) > 0 for b in g_ref)):
        fail(f"{what}: loss err {loss_err:.3e}, gradient err {grad_err:.3e} "
             f"of the leaf max (or a leaf without a gradient)")
    return dict(loss=l_card, loss_err=loss_err, grad_err_rel=grad_err)


def phase_training(card: str) -> dict:
    """Training on the card (no port kernel on this path: the routed branch
    trains with ``impl="sorted"``, plain PyTorch as the reference's is
    plain XLA).  The training CLI (a 1 x 1 mesh over a one-rank ``nccl``
    group) at qwen3-0.6b's full width and depth in the production dtypes (f32 params, bf16 compute, remat), B 4 x 4096,
    6 steps, a checkpoint every 3: step ms, tokens/s, peak memory, every
    loss finite and the last below the first.  The same at 4 layers: 6
    uninterrupted steps against a run that fails at step 4 and resumes,
    final checkpoints equal bit for bit (params, mu, nu, step).  One
    float32 train step of each family's smoke config, card vs CPU, and
    qwen3-0.6b's microbatch 2 vs 1 on the card.  The five kernels' launch
    counters read 0 over the phase (the CLI's own counts, and this
    process's)."""
    import shutil
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    res = {}
    try:
        ck = TRAIN_CKPT / "full"
        t0 = time.perf_counter()
        full = train_cli(TRAIN_FULL + [
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ck),
            "--ckpt-every", "3", "--log-every", "1"], "full width")
        wall = time.perf_counter() - t0
        losses = full["loss"]
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
                and losses[-1] < losses[0]):
            fail(f"{TRAIN_ARCH} full-width training: losses {losses}")
        steady = full["dt"][1:]
        res["full"] = dict(
            n_layers=full["n_layers"], mesh=full["mesh"], batch=4, seq=4096,
            losses=losses, lr=full["lr"], grad_norm=full["grad_norm"],
            step_s=full["dt"], step_ms_steady=1e3 * float(np.mean(steady)),
            tokens_per_s=full["tokens_per_step"] / float(np.mean(steady)),
            peak_memory_gib=full["peak_memory_bytes"] / 2**30,
            process_s=wall, seconds=full["seconds"],
            launches=full["kernel_launches"])
        if full["peak_memory_bytes"] >= 80e9:
            fail(f"{TRAIN_ARCH} training: peak {full['peak_memory_bytes']}")
        shutil.rmtree(ck)

        small = TRAIN_FULL + ["--steps", str(TRAIN_STEPS), "--ckpt-every",
                              "2", "--n-layers", str(RESUME_LAYERS)]
        t0 = time.perf_counter()
        a = train_cli(small + ["--ckpt-dir", str(TRAIN_CKPT / "a")],
                      "uninterrupted")
        train_cli(small + ["--ckpt-dir", str(TRAIN_CKPT / "b"),
                           "--simulate-failure", "4"], "failing",
                  expect_failure="simulated node failure")
        b = train_cli(small + ["--ckpt-dir", str(TRAIN_CKPT / "b"),
                               "--resume"], "resumed")
        n, bad = _npz_equal(TRAIN_CKPT / "a" / f"step_{TRAIN_STEPS}"
                            / "arrays.npz",
                            TRAIN_CKPT / "b" / f"step_{TRAIN_STEPS}"
                            / "arrays.npz")
        if bad or b["start"] != 4 or b["loss"] != a["loss"][4:]:
            fail(f"resume at {RESUME_LAYERS} layers: {len(bad)} of {n} "
                 f"arrays differ ({bad[:5]}), start {b['start']}, losses "
                 f"{b['loss']} vs {a['loss'][4:]}")
        res["resume"] = dict(n_layers=RESUME_LAYERS, losses=a["loss"],
                             arrays_equal=n,
                             arrays_differ=len(bad), resumed_at=b["start"],
                             seconds=time.perf_counter() - t0,
                             process_seconds=[a["seconds"], b["seconds"]],
                             launches=[a["kernel_launches"],
                                       b["kernel_launches"]])
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)

    res["card_vs_cpu"] = {a_id: train_card_vs_cpu(a_id)
                          for a_id in TRAIN_FAMILIES}
    res["microbatch_2_vs_1"] = train_card_vs_cpu(TRAIN_ARCH, microbatch=2)
    here = ops.launch_counts()
    launched = [here, res["full"]["launches"], *res["resume"]["launches"]]
    if any(sum(c.values()) for c in launched):
        fail(f"training launched a port kernel: {launched}")
    res["launches"] = here
    f = res["full"]
    errs = {k: (v["loss_err"], v["grad_err_rel"])
            for k, v in res["card_vs_cpu"].items()}
    print(f"training ({card}): {TRAIN_ARCH} {f['n_layers']} layers, B 4 x "
          f"4096, {f['step_ms_steady']:.1f} ms a step after the first "
          f"({f['tokens_per_s']:.1f} tokens/s), first {f['step_s'][0]:.2f} "
          f"s, peak {f['peak_memory_gib']:.2f} GiB, losses {f['losses']}, "
          f"grad norm {f['grad_norm']}, lr {f['lr']}, seconds "
          f"{f['seconds']}; resume at {RESUME_LAYERS} layers: "
          f"{res['resume']['arrays_equal']} arrays bit-equal; card vs CPU "
          f"(loss err, gradient err / leaf max) {errs}; microbatch 2 vs 1 "
          f"{res['microbatch_2_vs_1']['grad_err_rel']:.3e}; launches {here}")
    return res


# --------------------------------------------------- vision training (A.13) --

VIT_TRAIN_B, VIT_TRAIN_STEPS = 64, 12   # ViT-B/16 at 224^2, the recipe's 10
VIT_TRAIN_CLASSES = 10                 # classes and optimizer
RECIPE_N, RECIPE_B, RECIPE_PATCH, RECIPE_STEPS = 128, 32, 48, 60
RECIPE_LOSS_TOL = 1e-4     # float32 loss, card vs CPU, first 10 steps


def vision_batch(seed: int, b: int, n: int, patch: int, device) -> dict:
    """`benchmarks/tables.py`'s ``_train_vit`` batch: ``synthetic_vision_
    batch(PRNGKey(seed), b, n, patch, 10, n_signal=3, noise=1.2)`` drawn
    on ``device``."""
    from repro_torch import prng
    from repro_torch.models.vit import synthetic_vision_batch
    return synthetic_vision_batch(prng.PRNGKey(seed, device), b, n, patch,
                                  VIT_TRAIN_CLASSES, n_signal=3, noise=1.2)


def recipe_cfg():
    """``tiny_vit_cfg("mita", 128, m=16, k=16)``: 2 layers, d 64, 4 heads,
    window 8, k 16, bidirectional, float32."""
    from repro_torch.models.modules import AttnConfig, ModelConfig
    return ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                       vocab=11, attn=AttnConfig(
                           backend="mita", window=RECIPE_N // 16, k=16, s=1,
                           causal=False, block_q=32, landmark="pool1d"))


def recipe_run(params0, device) -> dict:
    """``_train_vit``'s 60 steps on ``device`` from ``params0``: the
    losses, the eval accuracy on ``PRNGKey(9)``'s 256 images, the first
    batch (to compare the draws across devices).  Under deterministic
    algorithms, as the training entry point runs (`launch.train.
    deterministic`): without them the backward's float atomics make two
    runs on the card differ, and where that moves a near tie of MiTA's
    routing the first 10 losses part past ``RECIPE_LOSS_TOL`` (by
    1.4e-03 on an H100)."""
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import deterministic
    from repro_torch.models.vit import vit_accuracy, vit_loss
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import tree_map
    cfg = recipe_cfg()
    opt = OptConfig(lr=2e-3, warmup_steps=5, total_steps=RECIPE_STEPS,
                    weight_decay=0.01)
    p = tree_map(lambda t: t.to(device, copy=True), params0)  # in place
    st = adamw_init(p)
    losses = []
    first = None
    with deterministic(torch.device(device)):
        for i in range(RECIPE_STEPS):
            batch = vision_batch(1000 + i, RECIPE_B, RECIPE_N, RECIPE_PATCH,
                                 device)
            if first is None:
                first = {k: v.cpu() for k, v in batch.items()}
            p, st, m = train_step(p, st, batch,
                                  lambda q, b: vit_loss(q, b, cfg), opt)
            losses.append(float(m["loss"]))
    acc = float(vit_accuracy(p, vision_batch(9, 256, RECIPE_N, RECIPE_PATCH,
                                             device), cfg))
    return dict(losses=losses, eval_acc=acc, first_batch=first)


def phase_vision_training(card: str) -> dict:
    """ViT training on the card (A.13's vision half; no port kernel on its
    path: the routed branch trains with ``impl="sorted"``, and B.4 has no
    backward).  ViT-B/16 (`vit_cfg` at N 196: 12 layers, d 768, m = k =
    49) with float32 parameters and bf16 compute, B 64 x 224^2 images of
    16 x 16 x 3 patches, 10 classes, AdamW lr 2e-3, warmup 5, weight
    decay 0.01, 12 steps on ``synthetic_vision_batch(PRNGKey(1000 + i),
    ...)`` drawn on the card: step ms after the first, images/s, peak
    memory, every loss finite.  Then ``_train_vit``'s recipe (tiny ViT, N
    128, B 32, 60 steps, float32, deterministic algorithms: `recipe_run`)
    on the card and on the CPU from the same parameters: the first 10
    losses within 1e-4, both eval
    accuracies recorded.  The five kernels' launch counters read 0."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import train_step
    from repro_torch.models.vit import vit_init, vit_loss
    from repro_torch.optim import OptConfig, adamw_init
    ops.reset_launch_counts()
    cfg = vit_cfg(196, torch.bfloat16)
    params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      VIT_PATCH, VIT_TRAIN_CLASSES, "cuda")
    st = adamw_init(params)
    opt = OptConfig(lr=2e-3, warmup_steps=5, total_steps=VIT_TRAIN_STEPS,
                    weight_decay=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(VIT_TRAIN_STEPS):
        batch = vision_batch(1000 + i, VIT_TRAIN_B, 196, VIT_PATCH, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, m = train_step(params, st, batch,
                                   lambda p, b: vit_loss(p, b, cfg), opt)
        losses.append(float(m["loss"]))       # synchronises
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(losses).all():
        fail(f"ViT-B/16 training: losses {losses}")
    steady = float(np.mean(step_s[1:]))
    res = {"vit_b16": dict(batch=VIT_TRAIN_B, n=196, steps=VIT_TRAIN_STEPS,
                           losses=losses, step_s=step_s,
                           step_ms_steady=steady * 1e3,
                           images_per_s=VIT_TRAIN_B / steady,
                           peak_memory_gib=peak)}
    del params, st, batch
    torch.cuda.empty_cache()

    p0 = vit_init(torch.Generator().manual_seed(0), recipe_cfg(),
                  RECIPE_PATCH, VIT_TRAIN_CLASSES, "cpu")
    card_run = recipe_run(p0, "cuda")
    cpu_run = recipe_run(p0, "cpu")
    errs = [abs(a - b) for a, b in zip(card_run["losses"][:10],
                                       cpu_run["losses"][:10])]
    same_batch = all(torch.equal(card_run["first_batch"][k],
                                 cpu_run["first_batch"][k])
                     for k in ("patches", "label"))
    if max(errs) > RECIPE_LOSS_TOL:
        fail(f"ViT recipe card vs CPU: first 10 losses differ by {errs}")
    res["recipe"] = dict(
        losses_card=card_run["losses"], losses_cpu=cpu_run["losses"],
        loss_err_first_10=max(errs), eval_acc_card=card_run["eval_acc"],
        eval_acc_cpu=cpu_run["eval_acc"], batch_bit_equal=same_batch)
    launches = ops.launch_counts()
    if sum(launches.values()):
        fail(f"vision training launched a port kernel: {launches}")
    res["launches"] = launches
    v, r = res["vit_b16"], res["recipe"]
    print(f"vision training ({card}): ViT-B/16 bf16 B {VIT_TRAIN_B} x 196 "
          f"patches, {v['step_ms_steady']:.1f} ms a step after the first "
          f"({v['images_per_s']:.1f} images/s), first {step_s[0]:.2f} s, "
          f"peak {peak:.2f} GiB, losses {losses}; recipe (tiny ViT, 60 "
          f"steps) card vs CPU: first 10 losses within {max(errs):.3e}, "
          f"eval accuracy card {r['eval_acc_card']:.4f} / CPU "
          f"{r['eval_acc_cpu']:.4f}, first batch bit-equal {same_batch}; "
          f"launches {launches}")
    return res


# ------------------------------------------------------ distribution (A.14) --

MESH_LOSS_TOL = 1e-5       # relative, the mesh path against the plain path
DIST_STEPS = 3


def _losses_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def plain_train(arch, steps: int, total_steps: int) -> dict:
    """``train_step`` on plain tensors in this process: the training CLI's
    first ``steps`` steps of a ``total_steps``-step run (its seed, its
    schedule, its batches, deterministic algorithms), without a mesh.
    The losses, each step's seconds and the peak memory it added."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns, train_step
    from repro_torch.launch.train import deterministic, schedule, train_batch
    from repro_torch.optim import adamw_init
    fns = family_fns(arch)
    opt = schedule(total_steps, 3e-4)                  # the CLI's --lr
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=4096, global_batch=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    with deterministic(torch.device("cuda")):
        params = fns["init"](torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
        st = adamw_init(params)
        for step in range(steps):
            batch = train_batch(arch, dcfg, step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, st, m = train_step(params, st, batch, fns["loss"], opt)
            losses.append(float(m["loss"]))       # synchronises
            step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    del params, st
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=step_s, peak_memory_bytes=peak)


def phase_distributed(card: str, training: dict) -> dict:
    """The distribution path on one card (a world of one rank: NCCL runs
    no two ranks on one device, so multi-rank runs are the CPU tests').
    `phase_training`'s full-width CLI run went through ``--data-parallel
    1 --model-parallel 1``: a 1 x 1 mesh over a one-rank ``nccl`` group,
    parameters and moments as DTensors, the train cell's sharded step.
    Its first 3 losses are held to `train_step` on plain tensors in this
    process (`plain_train`, same seed, schedule and batches) within 1e-5
    relative, step ms (steps 1 to 2, before the CLI run's first checkpoint
    write) and peak memory beside each other.  The CLI at 4
    layers started by ``torch.distributed.run --nproc-per-node 1``
    against the training phase's lone start at that depth.
    ``compressed_grad_mean`` over ``nccl`` on a qwen3-0.6b gradient tree
    (one backward of B 1 x 512 at full width and depth): on one rank the
    result is ``dequantize(quantize(g))`` and the residual ``g - q s``
    rounded once, bit for bit, every leaf; timed.  The five kernels'
    launch counters read 0."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import family_fns
    from repro_torch.launch.train import train_batch
    from repro_torch.optim.compression import (compressed_grad_mean,
                                               dequantize_int8, quantize_int8)
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.grads import value_and_grads
    ops.reset_launch_counts()
    res = {}
    arch = get_arch(TRAIN_ARCH)
    meshed = training["full"]
    plain = plain_train(arch, DIST_STEPS, TRAIN_STEPS)
    rel = _losses_rel(meshed["losses"][:DIST_STEPS], plain["losses"])
    if meshed["mesh"] != {"data": 1, "model": 1} or rel > MESH_LOSS_TOL:
        fail(f"mesh path: mesh {meshed['mesh']}, losses "
             f"{meshed['losses'][:DIST_STEPS]} vs the plain path's "
             f"{plain['losses']} ({rel:.3e})")
    res["full"] = dict(
        n_layers=meshed["n_layers"], losses=meshed["losses"][:DIST_STEPS],
        plain_losses=plain["losses"], loss_rel=rel,
        bit_equal=meshed["losses"][:DIST_STEPS] == plain["losses"],
        # steps 1 to 2 of both: the CLI run writes its first checkpoint
        # after step 2, and the write overlaps the steps after it
        step_ms_steady=1e3 * float(np.mean(
            meshed["step_s"][1:DIST_STEPS])),
        plain_step_s=plain["step_s"],
        plain_step_ms_steady=1e3 * float(np.mean(plain["step_s"][1:])),
        peak_memory_gib=meshed["peak_memory_gib"],
        plain_peak_memory_gib=plain["peak_memory_bytes"] / 2 ** 30)

    small = TRAIN_FULL + ["--steps", str(TRAIN_STEPS), "--n-layers",
                          str(RESUME_LAYERS), "--log-every", "1"]
    run = train_cli(small, "torchrun 1 rank", launcher=(
        "torch.distributed.run", "--standalone", "--nproc-per-node", "1"))
    lone = training["resume"]["losses"]
    rel4 = _losses_rel(run["loss"], lone)
    if run["mesh"] != {"data": 1, "model": 1} or rel4 > MESH_LOSS_TOL:
        fail(f"torchrun start: mesh {run['mesh']}, losses {run['loss']} vs "
             f"{lone}")
    res["torchrun"] = dict(n_layers=RESUME_LAYERS, losses=run["loss"],
                           lone_losses=lone, loss_rel=rel4,
                           bit_equal=run["loss"] == lone,
                           launches=run["kernel_launches"])

    fns = family_fns(arch)
    params = fns["init"](torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab, seq_len=512,
                                         global_batch=1), 0)
    _, grads = value_and_grads(fns["loss"], params, batch)
    del params
    make_host_mesh(1, 1)
    try:
        if dist.get_backend() != "nccl":
            fail(f"one-rank mesh on the card: backend {dist.get_backend()}")
        red, err = compressed_grad_mean(grads)       # warm-up and checked
        n_bad = 0
        for g, r, e in zip(tree_leaves(grads), tree_leaves(red),
                           tree_leaves(err)):
            q, s = quantize_int8(g)
            n_bad += not torch.equal(r, dequantize_int8(q, s))
            n_bad += not torch.equal(
                e, (g.double() - q.double() * s.double()).float())
        if n_bad:
            fail(f"compressed_grad_mean over nccl: {n_bad} leaves differ")
        del red, err
        ms = cuda_ms(lambda: compressed_grad_mean(grads), iters=3, warmup=1)
    finally:
        dist.destroy_process_group()
    n_el = sum(g.numel() for g in tree_leaves(grads))
    res["compressed"] = dict(leaves=len(tree_leaves(grads)), elements=n_el,
                             ms=ms, leaves_differ=0,
                             wire_bytes_per_rank_ideal=2 * n_el)
    del grads
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    launched = [launches, res["torchrun"]["launches"]]
    if any(sum(c.values()) for c in launched):
        fail(f"the distribution phase launched a port kernel: {launched}")
    res["launches"] = launches
    f = res["full"]
    print(f"distribution ({card}): mesh 1 x 1 over nccl, {TRAIN_ARCH} "
          f"{f['n_layers']} layers, B 4 x 4096: {f['step_ms_steady']:.1f} ms "
          f"a step, steps 1-2 (plain train_step "
          f"{f['plain_step_ms_steady']:.1f}), peak {f['peak_memory_gib']:.2f}"
          f" GiB (plain "
          f"{f['plain_peak_memory_gib']:.2f}), losses {f['losses']} vs plain "
          f"{f['plain_losses']} (rel {f['loss_rel']:.3e}, bit-equal "
          f"{f['bit_equal']}); torchrun 1 rank at {RESUME_LAYERS} layers: "
          f"losses rel {rel4:.3e} to the lone start (bit-equal "
          f"{res['torchrun']['bit_equal']})"
          f"; compressed_grad_mean over nccl on {n_el} gradient elements "
          f"({res['compressed']['leaves']} leaves): {ms:.2f} ms, bit-equal "
          f"to one quantization; launches {launches}")
    return res


# ------------------------------------------------------------- dry run --

DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False),
                ("qwen3-0.6b", "train_4k", True),
                ("deepseek-moe-16b", "decode_32k", False))
DRYRUN_OUT = HERE / "build" / "chip_smoke_dryrun"
DRYRUN_PEAK_TOL = 0.10     # predicted peak vs max_memory_allocated


def dryrun_clis() -> list:
    """The dry-run CLI on each of ``DRYRUN_CELLS``, one subprocess a cell,
    all started together; returns the Popen handles and record paths."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE / "src")] + [x for x in (env.get("PYTHONPATH"),) if x])
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for arch_id, shape, multi_pod in DRYRUN_CELLS:
        name = f"{arch_id}_{shape}_{'2x16x16' if multi_pod else '16x16'}"
        args = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch_id, "--shape", shape, "--force",
                "--out", str(DRYRUN_OUT)] + (["--multi-pod"] if multi_pod
                                              else [])
        with open(DRYRUN_OUT / f"{name}.log", "w") as log:
            proc = subprocess.Popen(args, cwd=HERE, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        runs.append((proc, DRYRUN_OUT / f"{name}.json"))
    return runs


def phase_dryrun(card: str, training: dict) -> dict:
    """The dry run (`launch.dryrun`, no port kernel on its path).
    a. The fake process group that it traces on must import.
    b. Its CLI in three subprocesses at once: qwen3-0.6b ``train_4k`` on
       16 x 16 and 2 x 16 x 16 fake ranks and deepseek-moe-16b
       ``decode_32k`` on 16 x 16, traced on fake ``cuda`` tensors: each
       record ``ok`` (status, bottleneck, the three time terms, peak per
       rank, useful FLOP fraction, trace seconds printed).
    c. A 1 x 1 calibration on the card: the dry run of qwen3-0.6b at
       `phase_training`'s shape (B 4 x 4096, production dtypes, remat)
       against ``FlopCounterMode`` over one real `train_step` here (FLOPs
       equal), against the training CLI's ``max_memory_allocated`` (peak
       within ``DRYRUN_PEAK_TOL``; this process's step's peak beside it)
       and its steady step ms (MFU = ``model_flops_for`` / 989.4e12 /
       step seconds).  The five kernels' launch counters read 0."""
    import shutil
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import family_fns, train_step
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig, adamw_init
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        fail(f"dry run: the fake process group does not import: {e}")
    del FakeStore
    ops.reset_launch_counts()
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    res = {"cells": {}}
    runs = dryrun_clis()
    try:
        arch = get_arch(TRAIN_ARCH)
        shape = ShapeSpec("train_b4", "train", 4096, 4)
        t0 = time.perf_counter()
        dr.join_fake_group(1)
        try:
            mesh = make_host_mesh(1, 1)
            if mesh.device_type != "cuda":
                fail(f"dry run: traced on {mesh.device_type}, not cuda")
            counts = dr._measure(arch, shape, mesh)
        finally:
            dist.destroy_process_group()
        trace_s = time.perf_counter() - t0
        model_flops = rl.model_flops_for(arch, shape)
        roof = rl.from_counts(f"{TRAIN_ARCH}:train_b4", "1x1", 1, counts,
                              model_flops=model_flops)

        fns = family_fns(arch)
        params = fns["init"](torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
        batch = train_batch(arch, DataConfig(vocab=arch.model.vocab,
                                             seq_len=4096, global_batch=4),
                            0)
        opt = adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            out = train_step(params, opt, batch, fns["loss"], OptConfig())
        torch.cuda.synchronize()
        here_peak = torch.cuda.max_memory_allocated()
        del out, params, opt
        torch.cuda.empty_cache()
    finally:
        for proc, _ in runs:
            try:
                proc.wait(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    for (proc, path), (arch_id, shape_name, mp) in zip(runs, DRYRUN_CELLS):
        key = f"{arch_id}:{shape_name}:{'2x16x16' if mp else '16x16'}"
        if proc.returncode != 0 or not path.exists():
            log = path.with_suffix(".log").read_text()
            fail(f"dry run {key}: rc {proc.returncode} {log[-2000:]}")
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok":
            fail(f"dry run {key}: {rec.get('status')} "
                 f"{rec.get('error', '')[:500]}")
        r = rec["roofline"]
        res["cells"][key] = dict(
            status=rec["status"], bottleneck=r["bottleneck"],
            t_compute=r["t_compute"], t_memory=r["t_memory"],
            t_collective=r["t_collective"],
            flops_per_rank=r["flops_per_chip"],
            bytes_per_rank=r["bytes_per_chip"],
            coll_bytes_per_rank=r["coll_bytes_per_chip"],
            peak_gib_per_rank=rec["memory"]["peak_per_device"] / 2**30,
            useful_flops_fraction=r["useful_flops_fraction"],
            trace_s=rec["trace_s"])
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)

    measured = fc.get_total_flops()
    full = training["full"]
    card_peak = full["peak_memory_gib"] * 2**30
    step_s = full["step_ms_steady"] / 1e3
    peak_err = abs(counts.peak_bytes - card_peak) / card_peak
    res["calibration"] = dict(
        shape="B 4 x 4096", predicted_flops=counts.flops,
        measured_flops=measured, predicted_peak_gib=counts.peak_bytes / 2**30,
        card_peak_gib=full["peak_memory_gib"],
        this_step_peak_gib=here_peak / 2**30, peak_rel_err=peak_err,
        bytes=counts.bytes, t_compute=roof.t_compute,
        t_memory=roof.t_memory, t_bound=roof.t_bound,
        bottleneck=roof.bottleneck, model_flops=model_flops,
        step_ms=full["step_ms_steady"],
        mfu=model_flops / rl.PEAK_FLOPS / step_s,
        hfu=counts.flops / rl.PEAK_FLOPS / step_s,
        trace_s=trace_s, card=card)
    launches = ops.launch_counts()
    res["launches"] = launches
    if sum(launches.values()):
        fail(f"the dry run launched a port kernel: {launches}")
    if counts.flops != measured:
        fail(f"dry run 1 x 1: {counts.flops:.6e} FLOPs predicted, "
             f"{measured:.6e} counted over a card step")
    if peak_err > DRYRUN_PEAK_TOL:
        fail(f"dry run 1 x 1: peak {counts.peak_bytes / 2**30:.2f} GiB "
             f"predicted, {full['peak_memory_gib']:.2f} GiB on the card")
    for key, c in res["cells"].items():
        print(f"  [dryrun] {key}: {c['status']} bottleneck {c['bottleneck']}"
              f", t_compute {c['t_compute']:.4e} s, t_memory "
              f"{c['t_memory']:.4e} s, t_collective {c['t_collective']:.4e}"
              f" s, peak {c['peak_gib_per_rank']:.2f} GiB a rank, useful "
              f"FLOP fraction {c['useful_flops_fraction']:.4f}, trace "
              f"{c['trace_s']} s")
    c = res["calibration"]
    print(f"dry run ({card}): 1 x 1 {TRAIN_ARCH} B 4 x 4096: FLOPs "
          f"predicted {c['predicted_flops']:.6e} / measured "
          f"{c['measured_flops']:.6e}; peak predicted "
          f"{c['predicted_peak_gib']:.2f} GiB / card "
          f"{c['card_peak_gib']:.2f} GiB ({100 * peak_err:.2f}%; this "
          f"process's step {c['this_step_peak_gib']:.2f} GiB); t_compute "
          f"{c['t_compute']:.4f} s, t_memory {c['t_memory']:.4f} s, t_bound "
          f"{c['t_bound']:.4f} s ({c['bottleneck']}); step "
          f"{c['step_ms']:.1f} ms, MFU {100 * c['mfu']:.2f}% (counted "
          f"FLOPs {100 * c['hfu']:.2f}%); trace "
          f"{trace_s:.1f} s; launches {launches}")
    return res


# ------------------------------------------------------ tensor parallel --

TP_CELLS = ("train_4k", "prefill_32k")
# qwen3-0.6b a rank of 16 x 16 on the gather-once cells, the same
# counter's numbers (PERF.md): train_4k as the dry run first counted it,
# prefill_32k from scripts/dryrun_cell_detail.py on that code
TP_GATHER_ONCE = {
    "train_4k": dict(flops_per_rank=3.218992e14, peak_gib=192.52,
                     t_compute=0.32535, t_memory=3.7383,
                     t_collective=0.13411),
    "prefill_32k": dict(flops_per_rank=9.043545e13, peak_gib=119.48,
                        t_compute=0.091404, t_memory=1.5602,
                        t_collective=0.044699)}
TP_FLOPS_GATE = 0.25       # train_4k FLOPs a rank, of the gather-once count
TP_PEAK_GATE = 0.5         # train_4k predicted peak, of the gather-once
TP_BATCH, TP_SEQ = 2, 4096
TP_LOSS_TOL = 1e-6         # relative, the 1 x 2 step against the 1 x 1
# every gradient leaf, relative to its max: the training phase's tolerance
# for float32 gradients whose sums the card orders another way
# (TRAIN_GRAD_TOL).  The CPU tests hold the smoke size to 1e-5; at 28
# layers and B 2 x 4096 the full-attention step measured 1.623e-05 on an
# H100 (PERF.md)
TP_GRAD_TOL = TRAIN_GRAD_TOL
TP_FLOAT_TOL = 1e-5        # prefill float leaves, relative to their max
TP_OUT = HERE / "build" / "chip_smoke_tp"
TP_BACKENDS = ("full", "mita")
# cells traced at a cut depth: internvl2-76b train_4k at 8 of its 80
# layers (its trace took 74.5 s at full depth; its FLOPs gate is a ratio
# to the gather-once count at the same depth, which depth does not move)
DETAIL_DEPTH = {("internvl2-76b", "train_4k"): 8}


def tp_arch(backend: str = "mita"):
    """qwen3-0.6b at full width and depth, float32 compute (remat on):
    the row-parallel sums then differ from one product's only by float32
    rounding, which the CPU tests' tolerances bound.  ``backend``
    ``full`` is the same model with full attention, which takes no
    discrete decision (the port's ``--backend full``)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    arch = get_arch(TRAIN_ARCH, backend=backend)
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, compute_dtype=torch.float32))


def tp_detail_clis(cells=None, out_dir=None) -> list:
    """`scripts/dryrun_cell_detail.py` on each (arch, shape) of ``cells``
    (``TP_CELLS`` of ``TRAIN_ARCH`` by default; 16 x 16 fake ranks, fake
    ``cuda``; at the depth ``DETAIL_DEPTH`` gives, else the config's),
    one subprocess a cell, all started together, output under
    ``out_dir`` (``TP_OUT``); returns the Popen handles and output
    paths."""
    import os
    cells = cells or [(TRAIN_ARCH, shape) for shape in TP_CELLS]
    out_dir = out_dir or TP_OUT
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE / "src")] + [x for x in (env.get("PYTHONPATH"),) if x])
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for arch, shape in cells:
        out = out_dir / f"detail_{arch}_{shape}.json"
        with open(out, "w") as f, open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, str(HERE / "scripts" /
                                     "dryrun_cell_detail.py"),
                 "--arch", arch, "--shape", shape]
                + (["--layers", str(DETAIL_DEPTH[(arch, shape)])]
                   if (arch, shape) in DETAIL_DEPTH else []),
                cwd=HERE, env=env, stdout=f, stderr=log)
        runs.append((proc, out))
    return runs


def wait_detail(runs, cells, what: str) -> dict:
    """The records of `tp_detail_clis`' subprocesses, by cell; a run that
    failed fails the phase."""
    out = {}
    for (proc, path), cell in zip(runs, cells):
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            log = path.with_suffix(".log").read_text()
            fail(f"{what} dry run {cell}: rc {proc.returncode} "
                 f"{log[-2000:]}")
        out[cell] = json.loads(path.read_text().strip().splitlines()[-1])
    return out


def _tp_local(tree):
    from repro_torch.launch.steps import zip_map
    return zip_map(lambda t: t.to_local().cpu() if hasattr(t, "to_local")
                   else t.cpu(), tree)


def split_case(name: str):
    """(arch, batch, sequence length) of a 1 x 2 comparison: a backend of
    ``TP_BACKENDS`` (qwen3-0.6b, `tp_arch`), ``"moe"`` (deepseek-moe-16b,
    `ep_arch`) or ``"hybrid"`` (recurrentgemma-9b, `hy_arch`)."""
    if name == "moe":
        return ep_arch(), EP_BATCH, EP_SEQ
    if name == "hybrid":
        return hy_arch(), HY_BATCH, HY_SEQ
    return tp_arch(name), TP_BATCH, TP_SEQ


def _moe_of(params):
    """The stacked MoE leaves of a parameter tree (None without them)."""
    return params.get("blocks", {}).get("moe")


class _MiTAPicks:
    """While active, records the first ``n`` MiTA forward attentions'
    landmark top-K: the keys, the landmark queries (the group axis of
    one squeezed) and the picks (`core.mita.topk_indices`), on the host:
    the layers of a full-sequence forward (a hybrid's prefill has no
    decode state to read them from), in call order."""

    def __init__(self, n: int):
        self.n, self.k, self.lm_q, self.idx = n, [], [], []

    def __enter__(self):
        from repro_torch.core import mita
        self.mita, self.scores, self.topk = (mita, mita.landmark_scores,
                                             mita.topk_indices)

        def scores(k, q_lm, cfg):
            if len(self.k) < self.n:
                self.k.append(k.detach().squeeze(2).cpu())
                self.lm_q.append(q_lm.detach().squeeze(2).cpu())
            return self.scores(k, q_lm, cfg)

        def topk(s_kv, cfg):
            out = self.topk(s_kv, cfg)
            if len(self.idx) < self.n:
                self.idx.append(out[0].squeeze(2).cpu())
            return out

        mita.landmark_scores, mita.topk_indices = scores, topk
        return self

    def __exit__(self, *exc):
        self.mita.landmark_scores = self.scores
        self.mita.topk_indices = self.topk

    def states(self):
        """The picks as a decode state's fields (``k_cache``, ``lm_q``,
        ``expert_idx``), layers stacked first, for `tp_layers`."""
        if not self.idx:
            return None
        return types.SimpleNamespace(
            k_cache=torch.stack(self.k), lm_q=torch.stack(self.lm_q),
            expert_idx=torch.stack(self.idx))


class _Routes:
    """While active, records the input (float32, on the host) and the
    picks of the first ``n`` calls of `models.moe.route`: one a layer of a
    forward (the recomputation of remat comes after them); none in a
    model without experts."""

    def __init__(self, n: int):
        self.n, self.inputs, self.picks = n, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.fn = moe, moe.route

        def record(params, tokens, cfg):
            r = self.fn(params, tokens, cfg)
            if len(self.picks) < self.n:
                self.inputs.append(tokens.detach().float().cpu())
                self.picks.append(r.gate_idx.cpu())
            return r

        moe.route = record
        return self

    def __exit__(self, *exc):
        self.moe.route = self.fn


def _split_rank(proc: int, names: tuple, ports: list, out_dir: str,
                go) -> None:
    """Process ``proc`` of the 1 x 2 groups of ``names`` (`split_case`),
    all on this card at once: rank ``proc % 2`` of case ``names[proc //
    2]``'s group, which waits for ``go`` (the card free of the 1 x 1
    references) and then runs the train cell's first step and the prefill
    cell on this rank's shards, recording the router's inputs and picks
    (`_Routes`); local results to ``<out_dir>/<name><r>.pt``.  The groups
    are ``gloo`` on cuda tensors, which gloo cannot all-gather: the one
    all-gather on these paths (the hybrid's KV-group rule and RG-LRU
    gates, `tensor_parallel._GatherLast`) sends its shards by an
    all-to-all there."""
    import torch.distributed as dist
    sys.path.insert(0, str(HERE / "src"))
    import repro_torch  # noqa: F401  (TF32 off)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, family_fns
    from repro_torch.launch.train import train_batch
    from repro_torch.models.rglru import n_super
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import AdamWState, tree_map
    name, rank = names[proc // 2], proc % 2
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{ports[proc // 2]}",
        rank=rank, world_size=2)
    try:
        ops.reset_launch_counts()
        mesh = make_host_mesh(1, 2, device_type="cuda")
        arch, batch, seq = split_case(name)
        fns = family_fns(arch)
        n = arch.model.n_layers
        res = {}

        def placed(tree, shardings):
            return tree_map(lambda t, pl: distribute_tensor(
                t, mesh, pl, src_data_rank=None), tree, shardings)

        def weights():
            return fns["init"](torch.Generator(device="cuda").manual_seed(0),
                               "cuda")

        cell = build_cell(arch, ShapeSpec("split", "train", seq, batch),
                          mesh, opt_cfg=OptConfig())
        psh, osh, _ = cell.in_shardings
        go.wait()
        p = placed(weights(), psh)

        def zeros(pls):
            # `adamw_init`'s zeros, one whole leaf at a time, then this
            # rank's shard
            return tree_map(lambda t, pl: distribute_tensor(
                torch.zeros(t.shape, dtype=torch.float32, device="cuda"),
                mesh, pl, src_data_rank=None), p, pls)

        o = AdamWState(mu=zeros(osh.mu), nu=zeros(osh.nu), step=placed(
            torch.zeros((), dtype=torch.int32, device="cuda"), osh.step))
        torch.cuda.empty_cache()
        dcfg = DataConfig(vocab=arch.model.vocab, seq_len=seq,
                          global_batch=batch)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picks_n = n_super(arch.model) if name == "hybrid" else 0
        with _Routes(n) as routes, _MiTAPicks(picks_n) as picks:
            p, o, met = cell.fn(p, o, train_batch(arch, dcfg, 0))
            loss = float(met["loss"])               # synchronises
        moe = _moe_of(p)
        res.update(loss=loss, step_s=time.perf_counter() - t0,
                   train_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   params=_tp_local(p), mu=_tp_local(o.mu),
                   train_routes=(routes.inputs, routes.picks),
                   train_picks=picks.states(),
                   experts_local=None if moe is None
                   else moe["wi"].to_local().shape[1])
        del p, o, met, moe
        torch.cuda.empty_cache()

        pcell = build_cell(arch, ShapeSpec("split", "prefill", seq, batch),
                           mesh)
        ppsh, bsh = pcell.in_shardings
        pp = placed(weights(), ppsh)
        tokens = torch.as_tensor(train_batch(arch, dcfg, 0)["tokens"],
                                 device="cuda")
        pb = placed({"tokens": tokens}, bsh)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), _Routes(n) as routes, \
                _MiTAPicks(picks_n) as picks:
            out = pcell.fn(pp, pb)
            torch.cuda.synchronize()
        # (last logits, decode states), or a hybrid's last logits alone
        logits, states = out if isinstance(out, tuple) else (out, None)
        res.update(prefill_s=time.perf_counter() - t0,
                   prefill_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   logits=_tp_local(logits),
                   states=None if states is None else _tp_local(states),
                   prefill_routes=(routes.inputs, routes.picks),
                   prefill_picks=picks.states(),
                   launches=ops.launch_counts())
        # the legacy format: no zip archive (and its checksums) over the
        # rank's ~10 GB
        torch.save(res, f"{out_dir}/{name}{rank}.pt",
                   _use_new_zipfile_serialization=False)
    finally:
        dist.destroy_process_group()


def split_reference(name: str) -> dict:
    """The 1 x 1 path of case ``name`` (`split_case`) in this process on
    the ranks' inputs: `train_step` (step 0's batch) and the plain
    prefill, results on the card, with the step's seconds and peak, the
    router's inputs and picks and its weights before the step."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns, train_step
    from repro_torch.launch.train import train_batch
    from repro_torch.models.rglru import n_super, rg_forward
    from repro_torch.optim import OptConfig, adamw_init
    arch, batch_size, seq = split_case(name)
    fns = family_fns(arch)
    n = arch.model.n_layers
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=seq,
                      global_batch=batch_size)

    def weights():
        return fns["init"](torch.Generator(device="cuda").manual_seed(0),
                           "cuda")

    params = weights()
    moe = _moe_of(params)
    router = None if moe is None else moe["router"].cpu()
    opt = adamw_init(params)
    batch = train_batch(arch, dcfg, 0)
    picks_n = n_super(arch.model) if name == "hybrid" else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Routes(n) as routes, _MiTAPicks(picks_n) as picks:
        # the step updates params and opt in place and returns them
        params, opt, met = train_step(params, opt, batch, fns["loss"],
                                      OptConfig())
        loss = float(met["loss"])
    res = dict(loss=loss, step_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               grad_norm=float(met["grad_norm"]),
               train_routes=(routes.inputs, routes.picks), router=router,
               train_picks=picks.states(), batch=batch_size)
    # the results stay on the card (the comparison reads them there)
    res.update(params=params, mu=opt.mu)
    del params, opt, met, moe
    torch.cuda.empty_cache()
    params = weights()
    tokens = torch.as_tensor(batch["tokens"], device="cuda")
    with torch.no_grad(), _Routes(n) as routes, \
            _MiTAPicks(picks_n) as picks:
        if fns["prefill"] is None:       # the hybrid: a forward's last
            logits, states = rg_forward(params, tokens, arch.model)[0][
                :, -1], None
        else:
            logits, states = fns["prefill"](params, {"tokens": tokens}, seq)
    res.update(logits=logits, states=states, opt_lr=OptConfig().lr,
               prefill_routes=(routes.inputs, routes.picks),
               prefill_picks=picks.states())
    del params, logits, states
    torch.cuda.empty_cache()
    return res


def _tp_compare(ref: dict, ranks: list) -> dict:
    """The ranks' local results against the 1 x 1 path's, each held to
    its own part of the reference (the parameters' and states' placements
    on a 1 x 2 mesh): float leaves by their largest error, relative to
    the reference leaf's largest magnitude and absolute; integer and
    boolean leaves by their unequal elements.  MiTA's top-K picks layer
    by layer (`tp_layers`) where the states hold them, and the router's
    (`ep_layers`) where a router ran.  Where the train step's router
    picks do not part but some tokens' first picks differ, the stacked
    router's first moment is held to the reference's plus the change
    that `_aux_router_shift` predicts for them (its error without it is
    reported beside)."""
    import inspect
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import zip_map
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptConfig
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 2))
    shardings = {
        "params": shd.tree_shardings(shd.param_specs(ref["params"], mesh),
                                     mesh)}
    shardings["mu"] = shardings["params"]
    if ref["states"] is not None:
        shardings["states"] = shd.tree_shardings(
            shd.state_specs(ref["states"], mesh, ref["batch"]), mesh)

    def errors(key, shift=None):
        rel, ab, bad, where, raw = 0.0, 0.0, {}, "", {}
        shift = shift or {}
        paths, leaves = [], []
        shd.map_with_path(lambda path, _: paths.append(path), ref[key])
        zip_map(lambda a, pl, *gs: leaves.append((a, pl, gs)), ref[key],
                shardings[key], *(got[key] for got in ranks))
        for i, (whole, pl, gs) in enumerate(leaves):
            whole = whole.cuda()
            top = whole.double().abs().max().item() \
                if whole.dtype.is_floating_point else None
            for r, g in enumerate(gs):
                def part(t):
                    return (t.chunk(2, dim=pl[1].dim)[r]
                            if isinstance(pl[1], Shard) else t)
                want = part(whole)
                g = g.cuda()
                if top is not None:
                    d = g.double() - want.double()
                    if paths[i] in shift:
                        raw[paths[i]] = max(raw.get(paths[i], 0.0),
                                            d.abs().max().item() / top)
                        d = d - part(shift[paths[i]])
                    d = d.abs().max().item()
                    ab = max(ab, d)
                    if d / max(top, 1e-30) > rel:
                        rel, where = d / max(top, 1e-30), paths[i]
                else:
                    bad[i] = bad.get(i, 0) + int((g != want).sum())
        return rel, ab, bad, where, raw

    train_layers, shift, aux_shift = None, {}, {}
    if ref["router"] is not None:
        train_layers = ep_layers(ref["router"], ref["train_routes"],
                                 ranks[0]["train_routes"], top1=True)
        if train_layers["first_parting"] is None and train_layers["swaps"]:
            opt = OptConfig()
            router = ref["router"]
            scale = (1 - opt.b1) * min(1.0, opt.clip_norm
                                       / max(ref["grad_norm"], 1e-9))
            weight = inspect.signature(tfm.lm_loss).parameters[
                "aux_weight"].default / router.shape[0]
            moved = torch.zeros(router.shape, dtype=torch.float64,
                                device="cuda")
            for layer, sw in train_layers["swaps"].items():
                moved[layer] = _aux_router_shift(
                    router[layer], ref["train_routes"][0][layer], sw, scale,
                    weight, "cuda")
            shift["blocks/moe/router"] = moved
            aux_shift["shift_rel"] = (moved.abs().max() / ref["mu"][
                "blocks"]["moe"]["router"].double().abs().max()).item()
    grad_rel, _, _, grad_leaf, raw = errors("mu", shift)
    aux_shift.update({f"{k} without it": v for k, v in raw.items()})
    _, param_abs, _, _, _ = errors("params")
    states_rel, bad, fields, whole, layers = 0.0, {}, (), None, None
    if ref["states"] is not None:
        states_rel, _, bad, _, _ = errors("states")
        fields = ref["states"]._fields
        whole = zip_map(lambda a, pl, b: torch.cat([a, b], dim=pl[1].dim)
                        .cuda() if isinstance(pl[1], Shard) else a.cuda(),
                        ranks[0]["states"], shardings["states"],
                        ranks[1]["states"])
    if "expert_idx" in fields:
        layers = tp_layers(zip_map(torch.Tensor.cuda, ref["states"]), whole)
    res = dict(layers=layers, grad_worst_leaf=grad_leaf,
        loss_rel=max(abs(g["loss"] - ref["loss"]) / abs(ref["loss"])
                     for g in ranks),
        grad_rel=grad_rel, param_abs=param_abs,
        param_bound=2 * ref["opt_lr"],
        logits_rel=max(((g["logits"].cuda().double()
                         - ref["logits"].cuda().double()).abs().max()
                        / ref["logits"].double().abs().max()).item()
                       for g in ranks),
        states_float_rel=states_rel,
        states_int_mismatches={fields[i]: n for i, n in bad.items()})
    if ref["router"] is not None:
        res.update(
            train_layers=train_layers, aux_shift=aux_shift,
            prefill_layers=ep_layers(ref["router"], ref["prefill_routes"],
                                     ranks[0]["prefill_routes"],
                                     ref["states"], whole))
    if ref["train_picks"] is not None:
        # MiTA's picks recorded in the forwards (the hybrid), each rank's
        res.update({f"{what}_layers": [
            tp_layers(ref[f"{what}_picks"], g[f"{what}_picks"],
                      ("k_cache", "lm_q")) for g in ranks]
            for what in ("train", "prefill")})
    return res


def _near_ties(a, b, score, unit: str) -> dict:
    """Where the two sides' pick sets ``a`` and ``b`` (indices ``[...,
    k]``) differ: for every pick x that one side took and y that the
    other took instead, the float64 gap of their scores (the reference
    side's) over what float32 rounding of the four scores and the two
    sides' own score differences allow.  ``score(side, at, idx)`` gives
    side 0's (the reference's) or side 1's float64 scores of the picks
    ``idx`` at position ``at`` and their float32 rounding bounds.
    Returns the positions (``unit``) and pairs seen and the largest gap /
    bound: at most 1 proves every differing pick a near tie."""
    a, b = a.long(), b.long()
    differ = (a.sort(-1).values != b.sort(-1).values).any(-1).nonzero()
    worst, pairs = 0.0, 0
    for at in differ.tolist():
        sa, sb = set(a[tuple(at)].tolist()), set(b[tuple(at)].tolist())
        xs, ys = sorted(sa - sb), sorted(sb - sa)
        (rx, ex), (ry, ey) = score(0, at, xs), score(0, at, ys)
        (tx, fx), (ty, fy) = score(1, at, xs), score(1, at, ys)
        gap = (rx[:, None] - ry[None, :]).abs()
        bound = (ex[:, None] + ey[None, :] + fx[:, None] + fy[None, :]
                 + (tx - rx).abs()[:, None] + (ty - ry).abs()[None, :])
        worst = max(worst, (gap / bound).max().item())
        pairs += gap.numel()
    return {unit: len(differ), "pairs": pairs, "worst_gap_over_bound": worst}


def _tp_near_tie(ref, got, layer: int) -> dict:
    """Layer ``layer``'s landmark top-K picks where the two sides' pick
    sets differ, held to `_near_ties`: a pick's score is key . landmark
    query, its float32 rounding ``(d + 1) 2^-24`` times the sum of
    |k_i q_i|."""
    eps = (ref.k_cache.shape[-1] + 1) * 2.0 ** -24

    def score(side, at, idx):
        st = (ref, got)[side]
        bb, h, j = at
        k = st.k_cache[layer, bb, h, idx].double()
        q = st.lm_q[layer, bb, h, j].double()
        return (k * q).sum(-1), eps * (k * q).abs().sum(-1)

    return _near_ties(ref.expert_idx[layer], got.expert_idx[layer], score,
                      "landmarks")


def tp_layers(ref, got, fields=("k_cache", "v_cache", "lm_q", "lm_v",
                                  "q_sum")) -> dict:
    """The two prefills' MiTA states layer by layer: landmarks whose top-K
    pick sets differ, landmarks whose picks differ in order only (a near
    tie between two picks, harmless: an expert is a set), and each float
    leaf's (of ``fields``) largest error relative to its largest magnitude
    at that layer.  At the first layer whose pick sets differ (where the
    two runs part: every later layer sees other inputs), `_tp_near_tie`'s
    proof."""
    rows, first = [], None
    for layer in range(ref.k_cache.shape[0]):
        a, b = ref.expert_idx[layer], got.expert_idx[layer]
        same_set = (a.sort(-1).values == b.sort(-1).values).all(-1)
        row = {"sets_differ": int((~same_set).sum()),
               "order_only": int(((a != b).any(-1) & same_set).sum())}
        for f in fields:
            x = getattr(ref, f)[layer].double()
            y = getattr(got, f)[layer].double()
            row[f] = ((x - y).abs().max()
                      / x.abs().max().clamp_min(1e-30)).item()
        rows.append(row)
        if row["sets_differ"] and first is None:
            first = layer
    return dict(rows=rows, first_parting=first,
                proof=None if first is None else _tp_near_tie(ref, got,
                                                              first))


def split_spawn(names: tuple, out_root) -> dict:
    """The two rank processes of each case of ``names`` (`split_case`,
    `_split_rank`), spawned now: they start up (imports, process group,
    cells) and wait for `split_two_ranks` to give them the card.  `main`
    spawns every split phase's ranks this way before the tensor-parallel
    phase, so that their start-up is off those phases' paths."""
    import shutil
    import socket
    import torch.multiprocessing as mp
    out = out_root / "ranks"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ports = []
    for _ in names:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            ports.append(s.getsockname()[1])
    go = mp.get_context("spawn").Event()
    ctx = mp.start_processes(_split_rank, args=(names, ports, str(out), go),
                             nprocs=2 * len(names), join=False,
                             start_method="spawn")
    return dict(names=names, ctx=ctx, go=go, out=out)


def split_stop(spawned: dict) -> None:
    """Ends `split_spawn`'s processes (a phase before theirs failed)."""
    for p in spawned["ctx"].processes:
        p.kill()
        p.join()


def split_two_ranks(spawned: dict) -> dict:
    """Every case that `split_spawn` ``spawned`` ranks for on two ranks at
    once (two processes a case on the card, one group each) against its
    1 x 1 reference here: the ranks start up while this process runs the
    references, one after the other, keeping their results on the card;
    the ranks take the card when they are done (``go``).  Then each
    case's comparison (`_tp_compare`) and its ranks' times and peaks, by
    name."""
    import shutil
    names = spawned["names"]
    ranks_ctx, go, out = spawned["ctx"], spawned["go"], spawned["out"]
    try:
        t0 = time.perf_counter()
        refs = {name: split_reference(name) for name in names}
        refs_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
    except BaseException:
        split_stop(spawned)
        raise
    go.set()
    t0 = time.perf_counter()
    while not ranks_ctx.join():
        pass
    ranks_s = time.perf_counter() - t0
    res = {}
    for name, ref in refs.items():
        t0 = time.perf_counter()
        ranks = [torch.load(out / f"{name}{r}.pt", weights_only=False)
                 for r in range(2)]
        two = _tp_compare(ref, ranks)
        two.update(refs_s=refs_s, compare_s=time.perf_counter() - t0)
        two.update(
            ref_step_ms=1e3 * ref["step_s"], ref_peak_gib=ref["peak_gib"],
            step_ms=[1e3 * g["step_s"] for g in ranks],
            train_peak_gib=[g["train_peak_gib"] for g in ranks],
            prefill_ms=[1e3 * g["prefill_s"] for g in ranks],
            prefill_peak_gib=[g["prefill_peak_gib"] for g in ranks],
            experts_local=[g["experts_local"] for g in ranks],
            launches=[g["launches"] for g in ranks], ranks_s=ranks_s,
            loss=ref["loss"], rank_losses=[g["loss"] for g in ranks])
        res[name] = two
        del ranks
    del refs
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return res


def tp_gate(backend: str, two: dict) -> None:
    """Step b's gates.  ``full``: every stated tolerance.  ``mita``: the
    prefill's layers before the first whose top-K pick sets differ hold
    the float tolerance, and that layer's differing picks are near ties
    (`_tp_near_tie`: gap within its bound); where no layer parts, every
    stated tolerance.  After a parting the two runs legitimately differ
    (each later layer sees other inputs), so the whole step's and the
    logits' errors are recorded, not gated."""
    tol = {k: two[k] for k in ("loss_rel", "grad_rel", "param_abs",
                               "logits_rel", "states_float_rel",
                               "states_int_mismatches")}
    whole = (two["loss_rel"] <= TP_LOSS_TOL and two["grad_rel"] <= TP_GRAD_TOL
             and two["param_abs"] <= two["param_bound"]
             and two["logits_rel"] <= TP_FLOAT_TOL
             and two["states_float_rel"] <= TP_FLOAT_TOL
             and not any(two["states_int_mismatches"].values()))
    layers = two["layers"]
    if backend == "full" or layers["first_parting"] is None:
        if not whole:
            fail(f"tensor-parallel 1 x 2 ({backend}) against the 1 x 1 "
                 f"path: {tol}")
        return
    first = layers["first_parting"]
    for i, row in enumerate(layers["rows"][:first]):
        worst = max(row[f] for f in ("k_cache", "v_cache", "lm_q", "lm_v",
                                     "q_sum"))
        if worst > TP_FLOAT_TOL:
            fail(f"tensor-parallel 1 x 2 ({backend}): prefill layer {i}, "
                 f"before the first parting ({first}), float error "
                 f"{worst:.3e}: {row}")
    if layers["proof"]["worst_gap_over_bound"] > 1.0:
        fail(f"tensor-parallel 1 x 2 ({backend}): layer {first}'s differing "
             f"top-K picks are not near ties: {layers['proof']}")


def phase_tensor_parallel(card: str, runs: list, spawned: dict) -> dict:
    """Tensor-parallel compute on the "model" axis for the dense family's
    train and prefill cells (`distributed.tensor_parallel`; no port
    kernel on its path).
    a. The dry run of qwen3-0.6b ``train_4k`` and ``prefill_32k`` on 16 x
       16 fake ``cuda`` ranks (`scripts/dryrun_cell_detail.py`, one
       subprocess a cell: ``runs``, which `main` starts before the dry-run
       phase, so that the host traces them beside that phase's card
       work): per-rank FLOPs, peak,
       collectives by kind and bytes, the three time terms, beside the
       gather-once numbers (``TP_GATHER_ONCE``).  Gates: ``train_4k``'s
       FLOPs a rank at most ``TP_FLOPS_GATE`` and its peak at most
       ``TP_PEAK_GATE`` of the gather-once ones.
    b. qwen3-0.6b at full width and depth (float32 compute, remat), B 2
       x 4096, on a 1 x 2 group: two processes over ``gloo`` (NCCL runs
       no two ranks on one device; ``spawned`` by `main` after the
       dry-run phase), both backends' pairs at once on this card.  One
       train
       step and one prefill held to the 1 x 1 path in this process
       (`split_reference`): loss within ``TP_LOSS_TOL``, every gradient leaf
       (AdamW's first moment) within ``TP_GRAD_TOL`` of its max,
       parameters within 2 lr of it, the prefill's logits and float state
       leaves within ``TP_FLOAT_TOL`` of their max, integer state leaves
       exact.  Twice (``TP_BACKENDS``): with full attention, which takes
       no discrete decision, under every tolerance; with MiTA, whose
       top-K and routing decisions part at near ties at this depth, up to
       the first layer where the prefills' pick sets part and that
       layer's picks proven near ties (`tp_gate`).  Step ms (the first
       step, as the 1 x 1 step's) and peak per rank printed.  ``gloo``
       cannot all-gather cuda tensors (a segfault, PyTorch 2.11): this
       path needs none (at M = 2 the KV-group rule gathers nothing, with
       8 KV heads), and the ranks gather nothing to compare.
    c. The five kernels' launch counters read 0, here and in the ranks."""
    import shutil
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res = {"cells": {}}
    try:
        res["two_ranks"] = split_two_ranks(spawned)
    finally:
        details = wait_detail(runs, TP_CELLS, "tensor-parallel")
    for shape, d in details.items():
        d["gather_once"] = TP_GATHER_ONCE[shape]
        res["cells"][shape] = d
        kinds = ", ".join(f"{k} {v['issues']} x (payload "
                          f"{v['payload_bytes']:.4e} B, ring "
                          f"{v['ring_bytes']:.4e} B, groups {v['groups']})"
                          for k, v in d["by_kind"].items())
        g = d["gather_once"]
        print(f"  [tensor-parallel] {TRAIN_ARCH} {shape} 16 x 16 a rank: "
              f"FLOPs {d['flops_per_rank']:.6e} (gather-once "
              f"{g['flops_per_rank']:.6e}), peak {d['peak_gib']:.2f} GiB "
              f"({g['peak_gib']}), t_compute {d['t_compute']:.5g} s "
              f"({g['t_compute']}), t_memory {d['t_memory']:.5g} s "
              f"({g['t_memory']}), t_collective {d['t_collective']:.5g} s "
              f"({g['t_collective']}), {d['bottleneck']}-bound; "
              f"collectives: {kinds}")
    shutil.rmtree(TP_OUT, ignore_errors=True)
    for backend, two in res["two_ranks"].items():
        layers = two["layers"]
        parted = "" if layers is None else (
            f"; prefill pick sets first part at layer "
            f"{layers['first_parting']} ({layers['proof']}); the layers "
            f"before it (order-only swaps, largest float error): " + ", ".join(
                f"{i} ({r['order_only']}, {max(r[f] for f in ('k_cache', 'v_cache', 'lm_q', 'lm_v', 'q_sum')):.2e})"
                for i, r in enumerate(
                    layers["rows"][:layers["first_parting"]])))
        print(f"  [tensor-parallel] 1 x 2 over gloo, {TRAIN_ARCH} "
              f"{tp_arch(backend).model.n_layers} layers, {backend}, B "
              f"{TP_BATCH} x {TP_SEQ} f32: loss {two['rank_losses']} vs "
              f"1 x 1 {two['loss']} (rel {two['loss_rel']:.3e}), gradients "
              f"rel {two['grad_rel']:.3e} ({two['grad_worst_leaf']}), "
              f"parameters {two['param_abs']:.3e}"
              f" (bound {two['param_bound']:.1e}); prefill logits rel "
              f"{two['logits_rel']:.3e}, float states rel "
              f"{two['states_float_rel']:.3e}, integer states unequal "
              f"{two['states_int_mismatches']}{parted}; step ms per rank "
              f"{two['step_ms']} (1 x 1 {two['ref_step_ms']:.1f}), peak GiB "
              f"{two['train_peak_gib']} (1 x 1 {two['ref_peak_gib']:.2f}); "
              f"prefill ms {two['prefill_ms']}, peak GiB "
              f"{two['prefill_peak_gib']}")
    train = res["cells"]["train_4k"]
    once = TP_GATHER_ONCE["train_4k"]
    if train["flops_per_rank"] > TP_FLOPS_GATE * once["flops_per_rank"]:
        fail(f"tensor-parallel train_4k: {train['flops_per_rank']:.6e} "
             f"FLOPs a rank, over {TP_FLOPS_GATE} x {once['flops_per_rank']}")
    if train["peak_gib"] > TP_PEAK_GATE * once["peak_gib"]:
        fail(f"tensor-parallel train_4k: peak {train['peak_gib']:.2f} GiB "
             f"a rank, over {TP_PEAK_GATE} x {once['peak_gib']}")
    for backend, two in res["two_ranks"].items():
        tp_gate(backend, two)
    launches = ops.launch_counts()
    res["launches"] = launches
    ranks = [c for two in res["two_ranks"].values() for c in two["launches"]]
    if sum(launches.values()) or any(sum(c.values()) for c in ranks):
        fail(f"the tensor-parallel phase launched a port kernel: "
             f"{launches}, ranks {ranks}")
    print(f"tensor parallel ({card}): train_4k 16 x 16 "
          f"{train['flops_per_rank'] / once['flops_per_rank']:.4f} of the "
          f"gather-once FLOPs, peak {train['peak_gib']:.2f} GiB; 1 x 2 "
          f"steps held to 1 x 1; launches {launches}")
    return res


# ------------------------------------------------------ expert parallel --

# the cells traced on 16 x 16 fake ranks, and their gather-once numbers a
# rank (scripts/dryrun_cell_detail.py on the tree before the moe and vlm
# splits; internvl2-76b at its traced depth, DETAIL_DEPTH; PERF.md)
EP_CELLS = (("deepseek-moe-16b", "train_4k"),
            ("deepseek-moe-16b", "prefill_32k"), ("internvl2-76b", "train_4k"))
EP_GATHER_ONCE = {
    ("deepseek-moe-16b", "train_4k"): dict(
        flops_per_rank=1.579629e15, peak_gib=208.34, t_compute=1.5966,
        t_memory=7.6940, t_collective=3.7976),
    ("deepseek-moe-16b", "prefill_32k"): dict(
        flops_per_rank=4.310545e14, peak_gib=103.51, t_compute=0.43567,
        t_memory=2.2133, t_collective=1.2657),
    ("internvl2-76b", "train_4k"): dict(
        flops_per_rank=3.802111e15, peak_gib=211.16, t_compute=3.8428,
        t_memory=4.5042, t_collective=2.0130)}
EP_PEAK_LIMIT_GIB = 80.0     # deepseek train_4k must fit a card a rank
EP_BATCH, EP_SEQ = 2, 2048
# depth of the 1 x 2 step: the 1 x 1 step holds the float32 weights (11.1
# GB at 4 layers), the two moments and one gradient copy, AdamW updating
# in place (ROADMAP C.21)
EP_LAYERS = MOE_LAYERS
EP_OUT = HERE / "build" / "chip_smoke_ep"


def ep_arch():
    """deepseek-moe-16b at full width (d 2048, 64 routed experts top-6, 2
    shared, vocabulary 102400) and ``EP_LAYERS`` layers, float32 compute
    (remat on), full attention: the router's picks are then the only
    discrete decisions (the dense phase covers MiTA under the split)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    arch = get_arch(MOE_ARCH, backend="full")
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, compute_dtype=torch.float32, n_layers=EP_LAYERS))


def _router_near_ties(router, ref_in, got_in, ref_picks, got_picks) -> dict:
    """One layer's router decisions where the two sides' pick sets
    differ, held to `_near_ties`: a pick's score is its logit (token .
    router column; the softmax keeps their order), its float32 rounding
    ``(d + 1) 2^-24`` times the sum of |x_i r_ij|."""
    eps = (router.shape[0] + 1) * 2.0 ** -24
    r = router.double()

    def score(side, at, idx):
        t = (ref_in, got_in)[side][tuple(at)].double()
        return t @ r[:, idx], eps * (t[:, None].abs()
                                      * r[:, idx].abs()).sum(0)

    return _near_ties(ref_picks, got_picks, score, "tokens")


def ep_layers(router, ref_routes, got_routes, ref_states=None,
              got_states=None, top1: bool = False) -> dict:
    """Two runs' router decisions layer by layer: tokens whose pick sets
    differ, tokens whose picks differ in order only (of them, those whose
    first pick differs), the routing inputs' largest error relative to
    their largest magnitude and, for a prefill, each K / V cache's; at
    the first layer whose pick sets differ (where the runs part),
    `_router_near_ties`' proof.  With ``top1`` (a train step), also each
    earlier layer's tokens whose first pick differs: an order harmless
    to the layer's output, but the load-balance loss counts first picks
    (`models.moe`), so it moves the router's gradient.  For each such
    layer, the `_router_near_ties` proof of those first picks and the
    swaps (the tokens' positions, the reference's first picks and the
    other side's, as lists), from which `_aux_router_shift` predicts that
    gradient's change."""
    rows, first = [], None
    (ri, rp), (gi, gp) = ref_routes, got_routes
    for layer, (x, y, a, b) in enumerate(zip(ri, gi, rp, gp)):
        same = (a.sort(-1).values == b.sort(-1).values).all(-1)
        row = {"sets_differ": int((~same).sum()),
               "order_only": int(((a != b).any(-1) & same).sum()),
               "top1_differ": int((a[..., 0] != b[..., 0]).sum()),
               "route_in": ((x.double() - y.double()).abs().max()
                            / x.double().abs().max().clamp_min(1e-30))
               .item()}
        if ref_states is not None:
            for f in ("k_cache", "v_cache"):
                u = getattr(ref_states, f)[layer].double()
                v = getattr(got_states, f)[layer].double()
                row[f] = ((u - v).abs().max()
                          / u.abs().max().clamp_min(1e-30)).item()
        rows.append(row)
        if row["sets_differ"] and first is None:
            first = layer
    proof = None
    if first is not None:
        proof = _router_near_ties(router[first], ri[first], gi[first],
                                  rp[first], gp[first])
    swaps, top1_proofs = {}, {}
    for layer in range(len(rows) if first is None else first):
        if not (top1 and rows[layer]["top1_differ"]):
            continue
        a, b = rp[layer][..., 0], gp[layer][..., 0]
        swaps[layer] = {"tokens": (a != b).nonzero().tolist(),
                        "ref": a[a != b].tolist(), "got": b[a != b].tolist()}
        top1_proofs[layer] = _router_near_ties(
            router[layer], ri[layer], gi[layer], rp[layer][..., :1],
            gp[layer][..., :1])
    return dict(rows=rows, first_parting=first, proof=proof, swaps=swaps,
                top1_proofs=top1_proofs)


def _aux_router_shift(router, inputs, swaps, scale: float, weight: float,
                      device) -> torch.Tensor:
    """The change in one layer's router gradient that its swapped first
    picks make, float64 on ``device``.  The load-balance loss is ``e *
    sum_j frac_j * imp_j`` (`models.moe`), ``frac_j`` the share of the
    layer's ``t`` tokens whose first pick is expert j (no gradient) and
    ``imp_j`` the mean over them of softmax(x W)_j, whose derivative by
    W is J_j = X^T [s_j (onehot_j - S)] / t.  A token whose first pick is
    j on the reference's side and k on the other moves ``frac_j`` by -1 /
    t and ``frac_k`` by +1 / t, so the other side's gradient is the
    reference's plus ``weight * e / t * (J_k - J_j)``.  ``router`` [d, e]
    and ``inputs`` [..., d] are the reference's (before the step),
    ``swaps`` `ep_layers`' for the layer, ``weight`` the loss's factor of
    the layer's aux loss times ``scale``, the factor from the gradient to
    what is compared (the clip scale and the first moment's 1 - b1).  The
    swap also moves what flows back through the routing input into the
    earlier layers, each token by 1 / t of a term of the sum above: at
    full size far below the tolerance, which every other leaf keeps."""
    x = inputs.reshape(-1, inputs.shape[-1]).to(device, torch.float64)
    w = router.to(device, torch.float64)
    t, e = x.shape[0], w.shape[1]
    s = torch.softmax(x @ w, dim=-1)
    eye = torch.eye(e, dtype=torch.float64, device=device)

    def jac(j: int) -> torch.Tensor:
        return x.T @ (s[:, j:j + 1] * (eye[j] - s)) / t

    shift = torch.zeros_like(w)
    for j, k in zip(swaps["ref"], swaps["got"]):
        shift += jac(k) - jac(j)
    return shift * (scale * weight * e / t)


def ep_gate(two: dict) -> None:
    """Step b's gates.  Each rank holds 32 of the 64 experts.  The train
    step: where its router pick sets do not part from the 1 x 1 step's,
    the dense phase's tolerances (loss ``TP_LOSS_TOL``, gradients
    ``TP_GRAD_TOL`` of a leaf's max, parameters 2 lr) and every layer's
    routing input within ``TP_FLOAT_TOL``.  Where some tokens' first
    picks differ (an order the layer's output does not see, but the
    load-balance loss counts), those picks must be near ties and the
    router's gradient is held to the reference's plus the change they
    predict (`_tp_compare`, `_aux_router_shift`), every other leaf as it
    is.  Where the pick sets part, the routing inputs up to that layer
    within ``TP_FLOAT_TOL`` and the layer's differing picks near ties
    (`_router_near_ties`), the step's errors recorded, not gated (every
    later layer sees other inputs).  The prefill the same way, with its
    logits and float states within ``TP_FLOAT_TOL``, integer states
    exact, and before the first parting each layer's K / V caches within
    ``TP_FLOAT_TOL``."""
    e = ep_arch().model.n_experts
    if two["experts_local"] != [e // 2, e // 2]:
        fail(f"expert-parallel 1 x 2: experts a rank {two['experts_local']}")
    for what, layers, whole in (
            ("train", two["train_layers"],
             two["loss_rel"] <= TP_LOSS_TOL and two["grad_rel"] <= TP_GRAD_TOL
             and two["param_abs"] <= two["param_bound"]),
            ("prefill", two["prefill_layers"],
             two["logits_rel"] <= TP_FLOAT_TOL
             and two["states_float_rel"] <= TP_FLOAT_TOL
             and not any(two["states_int_mismatches"].values()))):
        first = layers["first_parting"]
        rows = layers["rows"]
        upto = rows if first is None else rows[:first + 1]
        for i, row in enumerate(upto):
            caches = [row[f] for f in ("k_cache", "v_cache") if f in row
                      and (first is None or i < first)]
            worst = max([row["route_in"]] + caches)
            if worst > TP_FLOAT_TOL:
                fail(f"expert-parallel 1 x 2 {what}: layer {i} (first "
                     f"parting {first}) float error {worst:.3e}: {row}")
        for i, proof in layers["top1_proofs"].items():
            if proof["worst_gap_over_bound"] > 1.0:
                fail(f"expert-parallel 1 x 2 {what}: layer {i}'s differing "
                     f"first picks are not near ties: {proof}")
        if first is None:
            if not whole:
                fail(f"expert-parallel 1 x 2 {what} against the 1 x 1 path: "
                     + str({k: two.get(k) for k in (
                         "loss_rel", "grad_rel", "grad_worst_leaf",
                         "aux_shift", "param_abs", "logits_rel",
                         "states_float_rel", "states_int_mismatches")}))
        elif layers["proof"]["worst_gap_over_bound"] > 1.0:
            fail(f"expert-parallel 1 x 2 {what}: layer {first}'s differing "
                 f"router picks are not near ties: {layers['proof']}")


def phase_expert_parallel(card: str, runs: list, spawned: dict) -> dict:
    """Expert parallelism for the moe family and the split of the vlm's
    LM on the "model" axis (`distributed.tensor_parallel`, `models.moe`;
    no port kernel on its path).
    a. The dry run of deepseek-moe-16b ``train_4k`` and ``prefill_32k``
       and internvl2-76b ``train_4k`` on 16 x 16 fake ``cuda`` ranks
       (`scripts/dryrun_cell_detail.py`, one subprocess a cell: ``runs``,
       which `main` starts before the dry-run phase; the host traces them
       while the card runs other work):
       per-rank FLOPs, peak, collectives by kind and the
       three time terms beside the gather-once numbers
       (``EP_GATHER_ONCE``).
       Gates: deepseek ``train_4k``'s FLOPs a rank at most
       ``TP_FLOPS_GATE`` of gather-once and its peak under
       ``EP_PEAK_LIMIT_GIB`` and at most ``TP_PEAK_GATE`` of gather-once;
       internvl2's ``train_4k`` (at ``DETAIL_DEPTH``'s 8 of 80 layers,
       beside the gather-once count at that depth) FLOPs at most
       ``TP_FLOPS_GATE``; no collective of the three sourced from
       `launch.steps._full`.
    b. deepseek-moe-16b at full width, ``EP_LAYERS`` layers (`ep_arch`:
       float32 compute, full attention), B ``EP_BATCH`` x ``EP_SEQ``, on
       a 1 x 2 ``gloo`` group of two processes on this card (each rank
       32 experts; ``spawned`` by `main` before the dense phase), after
       the dense phase's processes have exited: one
       train step and one prefill held to the 1 x 1 path here (the dense
       phase's `split_two_ranks` and `_tp_compare`; `ep_gate`: the dense
       phase's tolerances, or up to the first layer where the router's
       picks part, those proven near ties).  Step ms and peak a rank
       printed beside the 1 x 1 numbers.
    c. The five kernels' launch counters read 0, here and in the
       ranks."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    ops.reset_launch_counts()
    try:
        two = split_two_ranks(spawned)["moe"]
    finally:
        cells = wait_detail(runs, EP_CELLS, "expert-parallel")
    shutil.rmtree(EP_OUT, ignore_errors=True)
    for cell, d in cells.items():
        g = EP_GATHER_ONCE[cell]
        d["gather_once"] = g
        kinds = ", ".join(f"{k} {v['issues']} x (payload "
                          f"{v['payload_bytes']:.4e} B, ring "
                          f"{v['ring_bytes']:.4e} B, groups {v['groups']})"
                          for k, v in d["by_kind"].items())
        print(f"  [expert-parallel] {cell[0]} {cell[1]} 16 x 16 a rank: "
              f"FLOPs {d['flops_per_rank']:.6e} (gather-once "
              f"{g['flops_per_rank']:.6e}), peak {d['peak_gib']:.2f} GiB "
              f"({g['peak_gib']}), t_compute {d['t_compute']:.5g} s "
              f"({g['t_compute']}), t_memory {d['t_memory']:.5g} s "
              f"({g['t_memory']}), t_collective {d['t_collective']:.5g} s "
              f"({g['t_collective']}), {d['bottleneck']}-bound; "
              f"collectives: {kinds}; traced in {d['trace_s']:.1f} s")
        full = [k for k in d["by_source"]
                if dr.from_gather_once(k.partition(" ")[2])]
        if full:
            fail(f"expert-parallel {cell}: collectives from the gather-once "
                 f"path: {full}")
    ds = cells[("deepseek-moe-16b", "train_4k")]
    once = EP_GATHER_ONCE[("deepseek-moe-16b", "train_4k")]
    if ds["flops_per_rank"] > TP_FLOPS_GATE * once["flops_per_rank"]:
        fail(f"expert-parallel deepseek train_4k: {ds['flops_per_rank']:.6e} "
             f"FLOPs a rank, over {TP_FLOPS_GATE} x {once['flops_per_rank']}")
    if ds["peak_gib"] >= EP_PEAK_LIMIT_GIB \
            or ds["peak_gib"] > TP_PEAK_GATE * once["peak_gib"]:
        fail(f"expert-parallel deepseek train_4k: peak {ds['peak_gib']:.2f} "
             f"GiB a rank, over {EP_PEAK_LIMIT_GIB} or {TP_PEAK_GATE} x "
             f"{once['peak_gib']}")
    iv = cells[("internvl2-76b", "train_4k")]
    once_iv = EP_GATHER_ONCE[("internvl2-76b", "train_4k")]
    if iv["flops_per_rank"] > TP_FLOPS_GATE * once_iv["flops_per_rank"]:
        fail(f"split internvl2-76b train_4k: {iv['flops_per_rank']:.6e} "
             f"FLOPs a rank, over {TP_FLOPS_GATE} x "
             f"{once_iv['flops_per_rank']}")
    layer_note = {}
    for what in ("train", "prefill"):
        lay = two[f"{what}_layers"]
        layer_note[what] = (
            "no pick parts" if lay["first_parting"] is None else
            f"picks first part at layer {lay['first_parting']} "
            f"({lay['proof']})") + (
            f"; first picks differ at layers {lay['top1_proofs']}"
            if lay["top1_proofs"] else "") + "; per layer " + ", ".join(
            f"{i}: sets {r['sets_differ']}, order {r['order_only']} (first "
            f"pick {r['top1_differ']}), input {r['route_in']:.2e}"
            for i, r in enumerate(lay["rows"]))
    print(f"  [expert-parallel] 1 x 2 over gloo on {card}, {MOE_ARCH} "
          f"{EP_LAYERS} layers, full width, full attention, B {EP_BATCH} x "
          f"{EP_SEQ} f32, {two['experts_local']} experts a rank: loss "
          f"{two['rank_losses']} vs 1 x 1 {two['loss']} (rel "
          f"{two['loss_rel']:.3e}), gradients rel {two['grad_rel']:.3e} "
          f"({two['grad_worst_leaf']}; the router's predicted change for "
          f"differing first picks {two['aux_shift']}), parameters "
          f"{two['param_abs']:.3e} "
          f"(bound {two['param_bound']:.1e}); prefill logits rel "
          f"{two['logits_rel']:.3e}, float states rel "
          f"{two['states_float_rel']:.3e}, integer states unequal "
          f"{two['states_int_mismatches']}; router: train "
          f"{layer_note['train']}; prefill {layer_note['prefill']}; step ms "
          f"per rank {two['step_ms']} (1 x 1 {two['ref_step_ms']:.1f}), "
          f"peak GiB {two['train_peak_gib']} (1 x 1 "
          f"{two['ref_peak_gib']:.2f}); prefill ms {two['prefill_ms']}, "
          f"peak GiB {two['prefill_peak_gib']}; references "
          f"{two['refs_s']:.1f} s, ranks {two['ranks_s']:.1f} s, compared "
          f"in {two['compare_s']:.1f} s")
    ep_gate(two)
    launches = ops.launch_counts()
    if sum(launches.values()) or any(sum(c.values())
                                     for c in two["launches"]):
        fail(f"the expert-parallel phase launched a port kernel: {launches}, "
             f"ranks {two['launches']}")
    print(f"expert parallel ({card}): deepseek-moe-16b train_4k 16 x 16 "
          f"{ds['flops_per_rank'] / once['flops_per_rank']:.4f} of the "
          f"gather-once FLOPs, peak {ds['peak_gib']:.2f} GiB; internvl2-76b "
          f"{iv['flops_per_rank'] / once_iv['flops_per_rank']:.4f}; 1 x 2 "
          f"step and prefill held to 1 x 1; launches {launches}")
    return {"cells": {f"{a}:{sh}": d for (a, sh), d in cells.items()},
            "two_ranks": two, "launches": launches}


# ------------------------------------------------ hybrid split (RG-LRU) --

HY_ARCH = "recurrentgemma-9b"
HY_CELLS = ((HY_ARCH, "train_4k"), (HY_ARCH, "prefill_32k"))
# recurrentgemma-9b a rank of 16 x 16 on the gather-once cells
# (scripts/dryrun_cell_detail.py on the tree before the hybrid split;
# PERF.md)
HY_GATHER_ONCE = {
    (HY_ARCH, "train_4k"): dict(
        flops_per_rank=3.808957e15, peak_gib=361.80, t_compute=3.8498,
        t_memory=11.7213, t_collective=1.9504),
    (HY_ARCH, "prefill_32k"): dict(
        flops_per_rank=1.011362e15, peak_gib=68.01, t_compute=1.0222,
        t_memory=3.0157, t_collective=0.6501)}
HY_PEAK_LIMIT_GIB = 80.0     # train_4k must fit a card a rank
HY_BATCH, HY_SEQ = 2, 2048
HY_LAYERS = 3                # one super-block: RG-LRU, RG-LRU, attention
HY_OUT = HERE / "build" / "chip_smoke_hy"


def hy_arch():
    """recurrentgemma-9b at full width (d 4096, 16 heads of 256, MQA,
    d_ff 12288, vocabulary 256000, which splits on 2 ranks) and
    ``HY_LAYERS`` layers, float32 compute (remat on), its MiTA backend
    (``impl="sorted"``)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    arch = get_arch(HY_ARCH)
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, compute_dtype=torch.float32, n_layers=HY_LAYERS))


def hy_gate(two: dict) -> None:
    """Step b's gates, for each of the train step and the prefill: where
    no attention layer's MiTA pick sets part from the 1 x 1 path's (on
    either rank), the dense phase's tolerances (loss ``TP_LOSS_TOL``,
    gradients ``TP_GRAD_TOL`` of a leaf's max, parameters 2 lr; the
    last logits ``TP_FLOAT_TOL``); where they part, the keys and
    landmark queries of every attention layer up to that one within
    ``TP_FLOAT_TOL`` and its differing picks near ties (`_tp_near_tie`),
    the step's errors recorded, not gated (every later layer sees other
    inputs)."""
    for what, whole in (
            ("train", two["loss_rel"] <= TP_LOSS_TOL
             and two["grad_rel"] <= TP_GRAD_TOL
             and two["param_abs"] <= two["param_bound"]),
            ("prefill", two["logits_rel"] <= TP_FLOAT_TOL)):
        parted = False
        for r, layers in enumerate(two[f"{what}_layers"]):
            first = layers["first_parting"]
            rows = layers["rows"] if first is None \
                else layers["rows"][:first + 1]
            for i, row in enumerate(rows):
                worst = max(row["k_cache"], row["lm_q"])
                if worst > TP_FLOAT_TOL:
                    fail(f"hybrid 1 x 2 {what}, rank {r}: attention layer "
                         f"{i} (first parting {first}) float error "
                         f"{worst:.3e}: {row}")
            if first is not None:
                parted = True
                if layers["proof"]["worst_gap_over_bound"] > 1.0:
                    fail(f"hybrid 1 x 2 {what}, rank {r}: attention layer "
                         f"{first}'s differing top-K picks are not near "
                         f"ties: {layers['proof']}")
        if not parted and not whole:
            fail(f"hybrid 1 x 2 {what} against the 1 x 1 path: " + str(
                {k: two[k] for k in ("loss_rel", "grad_rel", "param_abs",
                                     "logits_rel")}))


def phase_hybrid_split(card: str, runs: list, spawned: dict) -> dict:
    """The hybrid family's train and prefill cells split over the "model"
    axis (`distributed.tensor_parallel`, `models.rglru`; no port kernel
    on its path).
    a. The dry run of recurrentgemma-9b ``train_4k`` (full depth: the
       peak gate needs it) and ``prefill_32k`` on 16 x 16 fake ``cuda``
       ranks (`scripts/dryrun_cell_detail.py`, one subprocess a cell:
       ``runs``, which `main` starts before the expert-parallel phase; the
       host traces them beside that phase's card work and step b):
       per-rank FLOPs, peak, collectives by kind and the three time
       terms beside the gather-once numbers (``HY_GATHER_ONCE``).
       Gates: ``train_4k``'s FLOPs a rank at most ``TP_FLOPS_GATE`` of
       gather-once and its peak under ``HY_PEAK_LIMIT_GIB``;
       ``prefill_32k``'s FLOPs at most ``TP_FLOPS_GATE``; no collective
       sourced from `launch.steps._full`.
    b. recurrentgemma-9b at full width, one super-block (`hy_arch`:
       float32 compute, MiTA ``impl="sorted"``), B ``HY_BATCH`` x
       ``HY_SEQ``, on a 1 x 2 ``gloo`` group of two processes on this card
       (``spawned`` by `main` before the dense phase; each rank half the recurrent width, the FFNs' columns and the
       vocabulary; MQA, so both ranks compute the whole query by the
       KV-group rule), one train step and one prefill held to the 1 x 1
       path here (the split phases' `split_two_ranks` and `_tp_compare`;
       `hy_gate`: the dense phase's tolerances, or up to the first
       attention layer whose MiTA picks part, those proven near ties).
       Step ms and peak a rank printed beside the 1 x 1 numbers.
    c. The five kernels' launch counters read 0, here and in the
       ranks."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    ops.reset_launch_counts()
    try:
        two = split_two_ranks(spawned)["hybrid"]
    finally:
        cells = wait_detail(runs, HY_CELLS, "hybrid split")
    shutil.rmtree(HY_OUT, ignore_errors=True)
    for cell, d in cells.items():
        g = HY_GATHER_ONCE[cell]
        d["gather_once"] = g
        kinds = ", ".join(f"{k} {v['issues']} x (payload "
                          f"{v['payload_bytes']:.4e} B, ring "
                          f"{v['ring_bytes']:.4e} B, groups {v['groups']})"
                          for k, v in d["by_kind"].items())
        print(f"  [hybrid split] {cell[0]} {cell[1]} 16 x 16 a rank: FLOPs "
              f"{d['flops_per_rank']:.6e} (gather-once "
              f"{g['flops_per_rank']:.6e}, "
              f"{d['flops_per_rank'] / g['flops_per_rank']:.4f}), peak "
              f"{d['peak_gib']:.2f} GiB ({g['peak_gib']}), t_compute "
              f"{d['t_compute']:.5g} s ({g['t_compute']}), t_memory "
              f"{d['t_memory']:.5g} s ({g['t_memory']}), t_collective "
              f"{d['t_collective']:.5g} s ({g['t_collective']}), "
              f"{d['bottleneck']}-bound; collectives: {kinds}; by source "
              f"{d['by_source']}; traced in {d['trace_s']:.1f} s")
        full = [k for k in d["by_source"]
                if dr.from_gather_once(k.partition(" ")[2])]
        if full:
            fail(f"hybrid split {cell}: collectives from the gather-once "
                 f"path: {full}")
        if d["flops_per_rank"] > TP_FLOPS_GATE * g["flops_per_rank"]:
            fail(f"hybrid split {cell}: {d['flops_per_rank']:.6e} FLOPs a "
                 f"rank, over {TP_FLOPS_GATE} x {g['flops_per_rank']}")
    train = cells[(HY_ARCH, "train_4k")]
    if train["peak_gib"] >= HY_PEAK_LIMIT_GIB:
        fail(f"hybrid split train_4k: peak {train['peak_gib']:.2f} GiB a "
             f"rank, over {HY_PEAK_LIMIT_GIB}")
    note = {}
    for what in ("train", "prefill"):
        note[what] = "; ".join(
            f"rank {r}: " + ("no pick parts" if lay["first_parting"] is None
                             else f"picks first part at attention layer "
                             f"{lay['first_parting']} ({lay['proof']})")
            + ", per layer " + ", ".join(
                f"{i}: sets {x['sets_differ']}, order {x['order_only']}, "
                f"k {x['k_cache']:.2e}, lm_q {x['lm_q']:.2e}"
                for i, x in enumerate(lay["rows"]))
            for r, lay in enumerate(two[f"{what}_layers"]))
    print(f"  [hybrid split] 1 x 2 over gloo on {card}, {HY_ARCH} "
          f"{HY_LAYERS} layers, full width, MiTA sorted, B {HY_BATCH} x "
          f"{HY_SEQ} f32: loss {two['rank_losses']} vs 1 x 1 {two['loss']} "
          f"(rel {two['loss_rel']:.3e}), gradients rel "
          f"{two['grad_rel']:.3e} ({two['grad_worst_leaf']}), parameters "
          f"{two['param_abs']:.3e} (bound {two['param_bound']:.1e}); "
          f"prefill logits rel {two['logits_rel']:.3e}; MiTA picks: train "
          f"{note['train']}; prefill {note['prefill']}; step ms per rank "
          f"{two['step_ms']} (1 x 1 {two['ref_step_ms']:.1f}), peak GiB "
          f"{two['train_peak_gib']} (1 x 1 {two['ref_peak_gib']:.2f}); "
          f"prefill ms {two['prefill_ms']}, peak GiB "
          f"{two['prefill_peak_gib']}; references {two['refs_s']:.1f} s, "
          f"ranks {two['ranks_s']:.1f} s, compared in "
          f"{two['compare_s']:.1f} s")
    hy_gate(two)
    launches = ops.launch_counts()
    if sum(launches.values()) or any(sum(c.values())
                                     for c in two["launches"]):
        fail(f"the hybrid split phase launched a port kernel: {launches}, "
             f"ranks {two['launches']}")
    frac = {sh: cells[(HY_ARCH, sh)]["flops_per_rank"]
            / HY_GATHER_ONCE[(HY_ARCH, sh)]["flops_per_rank"]
            for sh in ("train_4k", "prefill_32k")}
    print(f"hybrid split ({card}): {HY_ARCH} train_4k 16 x 16 "
          f"{frac['train_4k']:.4f} of the gather-once FLOPs, peak "
          f"{train['peak_gib']:.2f} GiB; prefill_32k "
          f"{frac['prefill_32k']:.4f}; 1 x 2 step and prefill held to 1 x "
          f"1; launches {launches}")
    return {"cells": {f"{a}:{sh}": d for (a, sh), d in cells.items()},
            "two_ranks": {k: v for k, v in two.items()
                          if k not in ("train_layers", "prefill_layers")},
            "picks": {w: two[f"{w}_layers"] for w in ("train", "prefill")},
            "launches": launches}


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

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        # a phase's engines can hold its weights in reference cycles
        # (hooks bound to the engine): free them before the next phase
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("env", phase_env)
    kern = timed("kernels", phase_kernels)
    kern["chunk"] = timed("chunk_kernel", phase_chunk_kernel)
    kern.update(timed("fullseq_kernels", phase_fullseq_kernels))
    wide = timed("expert_d256", phase_expert_wide)
    d64 = timed("kernels_d64", phase_kernels_d64)
    vision_kern = timed("kernels_vision", phase_kernels_vision)
    sampler = timed("sampler", phase_sampler)
    timed("parity", phase_parity)
    timed("fullseq_parity", phase_fullseq_parity)
    timed("spec_parity", phase_spec_parity)
    timed("recurrent_parity", phase_recurrent_parity)
    timed("per_job_parity", phase_per_job_parity)
    hybrid_layer_err = timed("hybrid_forward_parity",
                             phase_hybrid_forward_parity)
    chaos = timed("chaos_parity", phase_chaos_parity)
    dense = timed("dense_parity", phase_dense_parity)
    vit_parity = timed("vit_parity", phase_vit_parity)
    whisper_parity = timed("whisper_parity", phase_whisper_parity)
    chunked_launches, chunked_summary = timed("production", phase_production,
                                              card)
    fs_launches, _ = timed("fullseq_production", phase_fullseq_production,
                           card)
    spec_summary, launches, spec_tps = timed(
        "spec_production", phase_spec_production, card)
    per_job_launches = timed("per_job_production", phase_per_job_production,
                             card)
    rec = timed("recurrent_production", phase_recurrent_production, card)
    supervised, chaos_launches = timed(
        "supervised_production", phase_supervised_production, card,
        chunked_summary)
    dense_serves = timed("dense_production", phase_dense_production, card)
    vision = timed("vision_production", phase_vision_production, card)
    moe_kern = timed("kernels_moe", phase_kernels_moe)
    moe_parity = timed("moe_parity", phase_moe_parity)
    moe_serve = timed("moe_production", phase_moe_production, card)
    training = timed("training", phase_training, card)
    vision_training = timed("vision_training", phase_vision_training, card)
    distributed = timed("distributed", phase_distributed, card, training)
    # the split phases' work off their own paths: the tensor- and
    # expert-parallel dry runs traced beside the dry-run phase, every
    # split phase's ranks started up (and waiting) from the end of the
    # dry-run phase, the hybrid's dry runs traced beside the
    # expert-parallel phase; all stopped if a phase fails
    tracers = {"tp": tp_detail_clis(), "ep": tp_detail_clis(EP_CELLS,
                                                             EP_OUT)}
    spawned = {}
    try:
        dryrun = timed("dryrun", phase_dryrun, card, training)
        spawned = {"tp": split_spawn(TP_BACKENDS, TP_OUT),
                   "ep": split_spawn(("moe",), EP_OUT),
                   "hy": split_spawn(("hybrid",), HY_OUT)}
        tensor_parallel = timed("tensor_parallel", phase_tensor_parallel,
                                card, tracers["tp"], spawned["tp"])
        tracers["hy"] = tp_detail_clis(HY_CELLS, HY_OUT)
        expert_parallel = timed("expert_parallel", phase_expert_parallel,
                                card, tracers["ep"], spawned["ep"])
        hybrid_split = timed("hybrid_split", phase_hybrid_split, card,
                             tracers["hy"], spawned["hy"])
    except BaseException:
        for proc, _ in sum(tracers.values(), []):
            proc.kill()
            proc.wait()
        for s in spawned.values():
            split_stop(s)
        raise
    launches = dict(launches)
    launches["mita_expert_attention"] = fs_launches["mita_expert_attention"]
    launches["flash_attention"] = fs_launches["flash_attention"]
    print(f"phase seconds {seconds}, total "
          f"{time.perf_counter() - t_start:.1f} s")

    bf = torch.bfloat16
    # card time, host issue time and what one call launches (from its
    # trace), per kernel
    traced = ("card_ms", "host_ms", "cuda_launches_per_call",
              "cuda_kernels", "grid_blocks")
    rows = []
    for key, name, src_file, replaces in (
            ("attn", "mita_paged_attention",
             "src/repro_torch/csrc/mita_paged_attn.cu",
             "src/repro/kernels/mita_paged_attn.py:217"),
            ("fin", "mita_paged_finalize_fused",
             "src/repro_torch/csrc/mita_paged_finalize.cu",
             "src/repro/kernels/mita_paged_finalize.py:119"),
            ("chunk", "mita_chunk_prefill_fused",
             "src/repro_torch/csrc/mita_chunk_prefill.cu",
             "src/repro/kernels/mita_chunk_prefill.py:428"),
            ("expert", "mita_expert_attention",
             "src/repro_torch/csrc/mita_expert_attn.cu",
             "src/repro/kernels/mita_expert_attn.py:80"),
            ("flash", "flash_attention",
             "src/repro_torch/csrc/flash_attn.cu",
             "src/repro/kernels/flash_attn.py:79")):
        r, r32 = kern[key][bf], kern[key][torch.float32]
        row = {
            "name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[name],
            "launches_chunked_serve": chunked_launches[name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "dtype": "bfloat16",
            "tol": r["tol"], **{k: r[k] for k in traced},
            "f32": {k: r32.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "tol",
                                            "library_ms") + traced}}
        if key in ("attn", "fin"):
            row["long_context"] = {k: r["long_context"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
                + traced}
            row["long_context"]["shape"] = f"S={LONG_S}, M={LONG_M}"
            row["f32"]["long_context"] = {k: r32["long_context"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms") + traced}
        if key == "fin":
            for k in ("ties_idx_mismatch", "control_max_abs_err",
                      "long_context_real_valued", "card_ms_reused"):
                row[k], row["f32"][k] = r[k], r32[k]
        if key in ("chunk", "expert"):
            for k in ("path", "control_max_abs_err"):
                row[k], row["f32"][k] = r[k], r32[k]
        if key in ("attn", "fin"):
            row["launches_per_job_serve"] = per_job_launches[name]
        if key in ("attn", "fin", "chunk"):
            # the supervised paths: f32 chaos (qwen3-0.6b, 4 layers), the
            # bf16 --chaos-seed 0 serve, and the head-dim-64 configs
            row["launches_chaos_parity_f32"] = chaos["qwen3-0.6b"][
                "launches"][name]
            row["launches_supervised_chaos_serve"] = chaos_launches[name]
            row["launches_dense_parity_f32"] = {
                a: dense[a]["launches"][name] for a in DENSE_CELLS}
            row["launches_dense_serve"] = {
                a: dense_serves[a]["launches"][name] for a in DENSE_CELLS}
            keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "tol", "idx_mismatch", "valid_mismatch") + traced
            row["d64"] = {
                f"{a} Hkv={D64_SHAPES[a][0]} G={D64_SHAPES[a][1]}": {
                    "bf16": {k: d64[a][bf][key].get(k) for k in keep},
                    "f32": {k: d64[a][torch.float32][key].get(k)
                            for k in keep}}
                for a in D64_SHAPES}
            # the MoE slice: deepseek-moe-16b's paths, the three new
            # head shapes at d 128
            row["launches_moe_parity_f32"] = moe_parity["launches"][name]
            row["launches_moe_serve"] = moe_serve["launches"][name]
            row["d128_moe"] = {
                f"{a} Hkv={MOE_SHAPES[a][0]} G={MOE_SHAPES[a][1]}": {
                    "bf16": {k: moe_kern[a][bf][key].get(k) for k in keep},
                    "f32": {k: moe_kern[a][torch.float32][key].get(k)
                            for k in keep}}
                for a in MOE_SHAPES}
        if key == "expert":
            # recurrentgemma-9b's head dim: the wide CUDA-core instance
            keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "tol", "control_max_abs_err", "path", "shape") + traced
            row["d256"] = {k: wide[bf][k] for k in keep}
            row["d256"]["f32"] = {k: wide[torch.float32][k] for k in keep}
            row["d256"]["launches_hybrid_forward_bf16"] = rec[
                "hybrid_forward"]["launches"][name]
            row["d256"]["hybrid_layer_max_abs_err_f32"] = hybrid_layer_err
            keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "tol") + traced
            hkv, g = MOE_SHAPES[MOE_ARCH]
            row["moe_forward"] = {
                "shape": f"lead [1, {hkv}, {g}], m {FWD_M}, N {FWD_N}",
                "bf16": {k: moe_kern["expert"][bf][k] for k in keep},
                "f32": {k: moe_kern["expert"][torch.float32][k]
                        for k in keep},
                "launches_moe_forward_bf16": moe_serve["forward"][
                    "launches"],
                "layer_max_abs_err_f32": moe_parity[
                    "forward_layer_max_abs_err"]}
            # the vision slice: bidirectional routing, K 49 / 64
            keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "tol", "control_max_abs_err", "path",
                    "shape") + traced
            for which, launched, layer_err in (
                    ("vit", {"launches_vit_b64_n196_bf16": vision[
                        "vit_b64_n196"]["launches"],
                        "launches_vit_parity_f32": vit_parity["launches"]},
                     vit_parity["layer_max_abs_err"]),
                    ("vit_512", {"launches_vit_b8_n1024_bf16": vision[
                        "vit_b8_n1024"]["launches"]},
                     vit_parity["layer_max_abs_err_512"]),
                    ("whisper_encoder", {
                        "launches_encode_and_decode_bf16":
                            vision["whisper"]["launches"]},
                     whisper_parity["encoder_layer_max_abs_err"])):
                vk = vision_kern[which]
                row[which] = {
                    "launches": sum(v for k, v in launched.items()
                                    if k.endswith("_bf16")),
                    **launched, **{k: vk[bf][k] for k in keep},
                    "f32": {k: vk[torch.float32][k] for k in keep},
                    "layer_max_abs_err_f32": layer_err}
        if key == "flash":
            row["shape"] = f"[1, 16, {FWD_N}, {D}] causal"
            row["full"] = r["full"]
            row["f32"]["full"] = r32["full"]
            row["path"], row["f32"]["path"] = r["path"], r32["path"]
            row["control_max_abs_err"] = r["control_max_abs_err"]
            row["f32"]["control_max_abs_err"] = r32["control_max_abs_err"]
        rows.append(row)
    st = spec_summary["stats"]
    print(json.dumps({"kernels": rows, "sampler": {
        k: sampler[k] for k in ("ms", "greedy_ms", "card_ms", "host_ms",
                                "cuda_launches_per_call", "gumbel_err_f32",
                                "gumbel_err_bf16")}, "spec_serve": {
        "tok_s_spec_k3": spec_tps[3], "tok_s_spec_k0": spec_tps[0],
        **{k: st[k] for k in ("spec_drafted", "spec_accepted",
                              "spec_rollbacks")}},
        "recurrent_serves": rec, "chaos": chaos, "dense_parity": dense,
        "supervised_serve": supervised, "dense_serves": dense_serves,
        "moe_parity": moe_parity, "moe_serve": moe_serve,
        "vit_parity": vit_parity, "whisper_parity": whisper_parity,
        "vision_serve": vision, "training": training,
        "vision_training": vision_training, "distributed": distributed,
        "dryrun": dryrun, "tensor_parallel": tensor_parallel,
        "expert_parallel": expert_parallel, "hybrid_split": hybrid_split}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
