"""Serving entry point: static batch or the continuous-batching engine
(port of ``repro.launch.serve``).

  * ``--engine static``     — prefill a fixed batch of equal-length prompts
    and decode it for ``--gen`` steps (`static_generate`, also the oracle
    the engine's greedy tokens are held to);
  * ``--engine continuous`` — `repro_torch.serve.ServingEngine` over the
    architecture's backend (`serve.backends.for_arch`): the paged MiTA
    backend for the dense, moe and vlm families (qwen3-0.6b,
    deepseek-moe-16b, ...), whose decode step runs the paged-decode and
    paged-finalize CUDA kernels on the card; with ``--prefill-chunk N``
    prompts are admitted by chunked prefill (batched: the chunk-prefill
    CUDA kernel; ``--prefill-mode per-job``: one job's chunk a step), with
    priority preemption and optionally the prefix cache.  mamba2-370m and
    recurrentgemma-9b serve through the recurrent backends on the same
    engine (``--engine static`` then runs the backend's reference).
    Every continuous serve runs under the `serve.Supervisor` (retries,
    quarantine, the degradation ladder, straggler counting); with
    ``--chaos-seed S`` the backend is wrapped in the seeded fault injector
    (`serve.ChaosBackend`), whose faults the supervisor must absorb
    without changing a token (a quarantined request is recomputed from
    its prompt: exact in float32; in bfloat16 it may part, as in the
    reference, ROADMAP C.13).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 512 --gen 160 --engine continuous \\
      [--prefill-chunk 256 [--prefill-mode per-job] [--prefix-cache]] \\
      [--attn-impl pallas] [--temperature 0.8] \\
      [--sample-device fused [--spec-k 3]] \\
      [--chaos-seed 0 [--chaos-rate 0.2]] [--deadline-ms MS] [--max-retries 3]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --engine continuous --prefill-chunk 128 [--prefill-mode per-job]
  (``--arch recurrentgemma-9b`` likewise; add ``--smoke --device cpu``
  for the reduced config on the CPU)

``--temperature T`` samples with the port's threefry (`repro_torch.prng`);
``--spec-k K --sample-device fused`` turns on lossless speculative decoding
(landmark-branch drafts, verified by the exact decode step).

Weights are random, drawn from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.registry import arch_params, get_arch
from repro_torch.core import mita_decode as mdec
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.modules import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def static_generate(params, cfg: ModelConfig, prompts: torch.Tensor,
                    gen: int, temperature: float = 0.0,
                    capacity: Optional[int] = None,
                    sample_key: Optional[torch.Tensor] = None,
                    record_gaps: bool = False):
    """Fixed-batch prefill + decode.  prompts: [B, N] on the model's
    device.  Returns (tokens [B, gen] int32 numpy, timings dict).  With
    ``cfg.attn.external_finalize`` the landmark finalize runs at window
    boundaries (skipping windows the prefill already finalised).

    Greedy takes the first-index argmax.  ``temperature`` > 0 draws token
    ``i`` of every row with ONE ``categorical`` over the whole [B, V]
    logits divided by the temperature (in the logits' dtype), keyed by
    ``fold_in(sample_key, i)`` (default key ``PRNGKey(1000)``): the
    reference's static rule, not the engine's per-request one.
    ``record_gaps`` adds ``top2_gap`` [gen, B]: the gap between the two
    largest values the token was picked from (logits, or logits plus
    gumbel noise when tempered) — a near-tie marks where float reduction
    order may flip a token."""
    b, n = prompts.shape
    w = cfg.attn.window
    capacity = mdec.window_aligned(capacity or n + gen, w)
    dev = prompts.device
    if sample_key is None:
        sample_key = prng.PRNGKey(1000)
    gaps = []

    def sample(lg, i):
        if temperature > 0:
            key = prng.fold_in(sample_key.cpu(), i).to(dev)
            lg = lg / torch.tensor(temperature, dtype=lg.dtype, device=dev)
            lg = prng.gumbel(key, tuple(lg.shape), lg.dtype) + lg
        if record_gaps:
            top2 = torch.topk(lg.float(), 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        return prng.argmax_first(lg)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, states = tfm.lm_prefill(params, prompts, cfg, capacity)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = sample(logits, 0)
        out = [tok]
        m_done = n // w
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = n + i
            if cfg.attn.external_finalize and pos % w == 0 \
                    and pos // w > m_done:
                states = tfm.lm_finalize_states(states, cfg)
                m_done = pos // w
            logits, states = tfm.lm_decode_step(params, states, tok, pos,
                                                cfg)
            tok = sample(logits, i + 1)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
    tm = {"prefill_s": t_prefill, "decode_s": t_decode}
    if record_gaps:
        tm["top2_gap"] = np.stack(gaps)
    return toks, tm


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print a report; returns the run's summary
    (throughput, TTFT percentiles, engine stats, generated tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous: total requests (default 2x batch)")
    ap.add_argument("--sample-device", choices=("host", "fused"),
                    default="host",
                    help="continuous: sample on the host from [S, V] logits "
                         "or on the device (downloads [S] int32 tokens)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous: chunked-prefill length in tokens "
                         "(multiple of the window; 0 = monolithic prefill)")
    ap.add_argument("--priority", type=int, default=0,
                    help="continuous: priority class for the generated "
                         "requests (higher wins admission/preemption)")
    ap.add_argument("--reserve-pages", type=int, default=0,
                    help="continuous: pages reserved for decode appends")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous+chunked: radix cache of committed "
                         "window-aligned prompt prefixes — repeated "
                         "prompts attach cached pages by reference and "
                         "skip straight to the first unshared chunk")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="continuous: lossless speculative decoding — "
                         "draft up to K tokens per slot per round and "
                         "verify them with the exact decode step "
                         "(requires --sample-device fused; 0 = off)")
    ap.add_argument("--prefill-mode", choices=("batched", "per-job"),
                    default="batched",
                    help="continuous+chunked: one dispatch advances every "
                         "prefilling job (batched) or the best-keyed job "
                         "only (per-job, the reference's legacy baseline)")
    ap.add_argument("--spec-mode", default="auto",
                    choices=("auto", "landmark", "self", "stress"),
                    help="drafting strategy: the MiTA backend drafts "
                         "against the compressed landmark branch "
                         "(landmark), the recurrent ones through their "
                         "decode step (self) or with synthetic drafts "
                         "(stress)")
    ap.add_argument("--attn-impl", choices=("sorted", "capacity", "pallas"),
                    default=None,
                    help="routed branch of the monolithic prefill "
                         "(AttnConfig.impl; default: the config's, sorted): "
                         "pallas runs the expert CUDA kernel")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="continuous: wrap the backend in the seeded "
                         "fault injector (serve.ChaosBackend) — transient "
                         "faults, slot faults, and allocator spikes on "
                         "this seed's schedule, absorbed by the Supervisor")
    ap.add_argument("--chaos-rate", type=float, default=0.2,
                    help="chaos: per-dispatch new-fault probability")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="continuous: per-request deadline; requests "
                         "still unfinished when it expires are cancelled "
                         "with finish reason 'deadline_expired'")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="supervisor: step retries before a fault "
                         "escalates to quarantine / degradation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.prefix_cache and not args.prefill_chunk:
        ap.error("--prefix-cache requires --prefill-chunk > 0")
    if args.spec_k and args.sample_device != "fused":
        ap.error("--spec-k requires --sample-device fused (verification "
                 "samples inside the fused step)")
    if args.chaos_seed is not None and args.engine != "continuous":
        ap.error("--chaos-seed requires --engine continuous (the fault "
                 "injector wraps the DecodeBackend)")

    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=args.smoke)
    if arch.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise SystemExit(f"serve drives decoder LMs (dense, moe, vlm, ssm, "
                         f"hybrid); {arch.arch_id} is {arch.family}")
    if args.attn_impl:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, attn=dataclasses.replace(arch.model.attn,
                                                 impl=args.attn_impl)))
    cfg = arch.model
    w = cfg.attn.window
    from repro_torch.serve import (EngineConfig, Request, ServingEngine,
                                   backends)

    gen = torch.Generator(device=device).manual_seed(0)
    params = arch_params(arch, gen, device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                      global_batch=max(args.batch, args.requests or 1))
    prompts = synthetic_batch(dcfg, 0)["tokens"]
    pages = mdec.window_aligned(args.prompt_len + args.gen, w) // w
    ecfg = EngineConfig(n_slots=args.batch, pages_per_slot=pages,
                        n_pages=2 * args.batch * pages,
                        prefill_chunk=args.prefill_chunk,
                        reserve_pages=args.reserve_pages,
                        sample_device=args.sample_device,
                        prefill_mode=args.prefill_mode,
                        prefix_cache=args.prefix_cache,
                        spec_k=args.spec_k, spec_mode=args.spec_mode)
    summary = {"engine": args.engine, "arch": arch.arch_id,
               "device": str(device)}

    if args.engine == "static" and arch.family in ("ssm", "hybrid"):
        backend = backends.for_arch(arch, params, ecfg, device=device)
        _sync(device)
        t0 = time.perf_counter()
        toks = backend.static_reference(prompts[: args.batch], args.gen,
                                        temperature=args.temperature)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"static ({backend.name}): {args.batch}x{args.prompt_len}"
              f"+{args.gen} in {dt:.3f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s)")
        summary.update(tok_s=args.batch * args.gen / dt, tokens=toks)
    elif args.engine == "static":
        toks, tm = static_generate(
            params, cfg, torch.as_tensor(prompts[: args.batch],
                                         device=device), args.gen,
            temperature=args.temperature)
        tps = args.batch * (args.gen - 1) / max(tm["decode_s"], 1e-9)
        print(f"prefill: {args.batch}x{args.prompt_len} in "
              f"{tm['prefill_s']:.3f}s")
        print(f"decode:  {args.gen - 1} steps, {tm['decode_s']:.3f}s "
              f"({tps:.1f} tok/s, batch={args.batch})")
        summary.update(tok_s=tps, tokens=toks)
    else:
        from repro_torch.serve import (ChaosBackend, ChaosConfig,
                                       Supervisor, SupervisorConfig)
        n_req = args.requests or 2 * args.batch
        backend = backends.for_arch(arch, params, ecfg, device=device)
        if args.chaos_seed is not None:
            # faults are gated at ops whose injection fires before any
            # state mutation, so supervised retries stay bit-exact on
            # every backend (recurrent self-drafters included)
            backend = ChaosBackend(backend, ChaosConfig(
                seed=args.chaos_seed, p_fault=args.chaos_rate,
                transient_len=2, p_slot_fault=0.3,
                alloc_spike_every=8, alloc_spike_pages=2,
                ops=("decode_step", "prefill_chunks", "prefill_chunk",
                     "prefill_group", "draft_steps")))
        eng = ServingEngine(params, cfg, ecfg, backend=backend)
        sup = Supervisor(eng, SupervisorConfig(max_retries=args.max_retries))
        reqs = [Request(rid=i, prompt=prompts[i % len(prompts)],
                        max_new_tokens=args.gen,
                        temperature=args.temperature,
                        priority=args.priority,
                        deadline_ms=args.deadline_ms)
                for i in range(n_req)]
        _sync(device)
        start = time.perf_counter()
        done = sup.run(reqs)
        _sync(device)
        dt = time.perf_counter() - start
        sup.close()
        total = sum(len(f.tokens) for f in done)
        ttft = np.asarray([f.first_token - start - f.arrival for f in done
                           if f.reason == "complete"])
        st = sup.stats()
        p50, p99 = (np.percentile(ttft, [50, 99]) if ttft.size
                    else (float("nan"), float("nan")))
        print(f"continuous[{st['backend']}]: {n_req} requests "
              f"({args.prompt_len}+{args.gen}) in {dt:.3f}s — "
              f"{total / dt:.1f} tok/s, ttft p50 {p50 * 1e3:.1f} ms "
              f"p99 {p99 * 1e3:.1f} ms, {eng.steps} fused steps, "
              f"batch={args.batch}, chunks={st['chunks']} in "
              f"{st['prefill_dispatches']} dispatches, "
              f"preemptions={st['preemptions']}, "
              f"pages_hw={st['pages_high_water']}, "
              f"prefix_hits={st['prefix_cache_hits']}, "
              f"spec_accepted={st['spec_accepted']}/"
              f"{st['spec_drafted']}, "
              f"rejected={st['rejected']}, "
              f"deadline_expired={st['deadline_expired']}, "
              f"stragglers={st['stragglers']}, "
              f"retries={st['retries']}, "
              f"quarantined={st['quarantined']}, "
              f"degradation_level={st['degradation_level']}")
        summary.update(
            requests=n_req, finished=len(done), tokens_out=total,
            seconds=dt, tok_s=total / dt, ttft_p50_s=float(p50),
            ttft_p99_s=float(p99), steps=eng.steps, stats=st,
            reasons=[f.reason for f in done],
            tokens={f.rid: f.tokens for f in done},
            preemptions={f.rid: f.preemptions for f in done},
            injected=getattr(backend, "n_injected", 0))
        # deadline kills leave shorter streams: show completed ones first
        toks = ([f.tokens for f in done if f.reason == "complete"]
                or [f.tokens for f in done])
    if toks is not None and len(toks):
        print("sample generations (token ids):")
        for b in range(min(2, len(toks))):
            print(f"  [{b}] {toks[b][:16].tolist()}")
    return summary


if __name__ == "__main__":
    main()
