"""Where a decode step, a chunked-prefill dispatch or a full-sequence
forward of the port spends its time.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--arch qwen3-0.6b|deepseek-moe-16b|mamba2-370m|recurrentgemma-9b]
        [--compute-dtype bfloat16|float32] [--steps 20] [--window-close]
        [--prefill-chunk 256] [--forward 4096 [--attn-impl ...]]
        [--train 4096 [--batch 4]]

Fills the engine's slots with one admission group (``--arch``, default
qwen3-0.6b, served by its backend: `serve.backends.for_arch`; random
weights from seed 0), warms up, then records ``--steps`` decode steps
under ``torch.profiler`` (CPU + CUDA).  With ``--window-close`` the
recorded steps are instead the ``--steps`` decode steps around the first
window close after the prompt (prompt 512: the step at position 640, which
finalizes a landmark in every layer); each step is recorded as its own
range, and the summary adds the due step's device time, its busy share
and the finalize kernels' share of it beside the other steps' mean.
With ``--prefill-chunk N`` it
records instead the chunked-prefill dispatches that admit one group of
``--batch`` prompts (after a warm-up group), and reports per dispatch.
With ``--forward N`` it records one full-sequence forward (``lm_forward``,
``mamba_forward`` or ``rg_forward``) of a batch of one sequence of N
tokens after a warm-up forward, with the routed branch of
``--attn-impl`` (pallas: the expert kernel).  With ``--train N`` it
records one training step (`launch.steps.train_step`: forward, the remat
forward, backward and AdamW) of ``--batch`` sequences of N tokens after
a warm-up step, under the training driver's deterministic settings
(`launch.train.deterministic`; routed branch ``impl="sorted"``).
Prints the wall time per step, the share of that time the card was busy
(sum of kernel times / wall time), and the operators with the largest
CUDA and CPU self times; the last line is a JSON summary, with the device
kernels of most self time and every kernel of the port's own CUDA
sources (time per launch, launches, share of the device time).  Needs a CUDA
device unless ``--device cpu``, which profiles the plain versions and
reports no device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs.registry import arch_params, get_arch
from repro_torch.core import mita_decode as mdec
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve import EngineConfig, Request, ServingEngine, backends


TOP = 25      # operators listed per table


def _self_device_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _kernel_us(avgs) -> float:
    """Device time of the window: the device-side (kernel) rows only, as
    the profiler's own table total counts it; the CPU operator rows repeat
    the time of the kernels they launch."""
    from torch.autograd import DeviceType
    return sum(_self_device_us(e) for e in avgs
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def _top_kernels(avgs, dev_us: float, n: int = 8, port: bool = False
                 ) -> dict:
    """The ``n`` device kernels with the most self time (``port``: every
    kernel of the port's own CUDA sources, in their anonymous namespaces
    and outside ATen's): microseconds per launch, launches, and share of
    the window's device time."""
    from torch.autograd import DeviceType
    rows = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=_self_device_us, reverse=True)
    if port:
        rows = [e for e in rows if e.key.startswith(
            "void (anonymous namespace)::") and "at::" not in e.key]
    else:
        rows = rows[:n]
    return {e.key[:80]: {"us_per_launch": _self_device_us(e) / e.count,
                         "launches": e.count,
                         "share": _self_device_us(e) / dev_us}
            for e in rows if dev_us > 0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--window-close", action="store_true",
                    help="profile the decode steps around the first window "
                         "close after the prompt (the finalizing step)")
    ap.add_argument("--forward", type=int, default=0,
                    help="profile one lm_forward of this many tokens")
    ap.add_argument("--attn-impl", default="pallas",
                    choices=("pallas", "sorted", "capacity"),
                    help="--forward: the routed branch's implementation")
    ap.add_argument("--train", type=int, default=0,
                    help="profile one train step of --batch sequences of "
                         "this many tokens")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(arch.model,
                              compute_dtype=getattr(torch, args.compute_dtype))
    if args.forward:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, impl=args.attn_impl))
    arch = dataclasses.replace(arch, model=cfg)
    if args.train:
        return _profile(args, device, _train_runner(args, arch, device),
                        f"train step of {args.batch} x {args.train} tokens",
                        {"arch": arch.arch_id, "train": args.train,
                         "batch": args.batch})
    if args.forward:
        return _profile(args, device, _forward_runner(args, arch, device),
                        f"forward of {args.forward} tokens",
                        {"forward": args.forward,
                         "attn_impl": args.attn_impl})
    w = cfg.attn.window
    # the first window close after the prompt: the decode step that starts
    # at this position finalizes the window before it
    close = (args.prompt_len // w + 1) * w if args.window_close else 0
    first = close - args.steps // 2         # first recorded step's position
    gen = args.steps + 8 + max(first - args.prompt_len, 0)
    params = arch_params(arch, torch.Generator(device=device).manual_seed(0),
                         device)
    prompts = synthetic_batch(DataConfig(vocab=cfg.vocab,
                                         seq_len=args.prompt_len,
                                         global_batch=args.batch), 0)["tokens"]
    pages = mdec.window_aligned(args.prompt_len + gen, w) // w
    ecfg = EngineConfig(n_slots=args.batch, pages_per_slot=pages,
                        n_pages=2 * args.batch * pages,
                        prefill_chunk=args.prefill_chunk)
    eng = ServingEngine(params, cfg, ecfg,
                        backend=backends.for_arch(arch, params, ecfg,
                                                  device=device))
    chunked = args.prefill_chunk > 0
    if chunked:                        # a warm-up group, then a fresh one
        eng.run([Request(rid=100 + i, prompt=prompts[i], max_new_tokens=1)
                 for i in range(args.batch)])
    for i in range(args.batch):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=gen))
    for _ in range(0 if chunked else 4):   # admission + warm-up decode
        eng.step()
    while close and int(eng.t.max()) < first:
        eng.step()

    def run():
        if chunked:                    # prefill dispatches only, no decode
            before = eng.prefill_dispatches
            while eng.waiting or eng.prefilling:
                eng._admit(time.perf_counter())
                eng._advance_prefill(time.perf_counter())
            return eng.prefill_dispatches - before
        for _ in range(args.steps):
            if close:       # one range per step, named by its position
                with torch.profiler.record_function(
                        f"decode_step_t{int(eng.t.max())}"):
                    eng.step()
            else:
                eng.step()
        return args.steps

    what = "prefill dispatch" if chunked else "decode step"
    return _profile(args, device, run, what,
                    {"arch": arch.arch_id, "batch": args.batch,
                     "prefill_chunk": args.prefill_chunk},
                    close_step=f"decode_step_t{close}" if close else None)


def _forward_runner(args, arch, device):
    """A warm-up full-sequence forward of the architecture's family now;
    returns the function that runs the profiled one (returning its count,
    1)."""
    from repro_torch.models.mamba2 import mamba_forward
    from repro_torch.models.rglru import rg_forward
    cfg = arch.model
    params = arch_params(arch, torch.Generator(device=device).manual_seed(0),
                         device)
    toks = torch.as_tensor(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=args.forward, global_batch=1), 0)["tokens"],
        device=device)
    fwd = {"dense": tfm.lm_forward, "moe": tfm.lm_forward,
           "ssm": mamba_forward, "hybrid": rg_forward}[arch.family]

    def run():
        with torch.inference_mode():
            fwd(params, toks, cfg)
        return 1

    run()
    return run


def _step_breakdown(prof, due_step: str) -> dict:
    """Device time of each ``decode_step_t*`` range of the window (kernels
    that start inside the range's host span: each step ends by copying
    its tokens to the host, so its kernels have ended by then), from the
    profiler's trace.  Returns the due step's device and wall ms, its busy
    share and the finalize kernels' share of its device time, and the
    other steps' mean device ms."""
    import tempfile
    from pathlib import Path
    build = Path(__file__).resolve().parents[3] / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("decode_step_t")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dev, fin = {}, {}
    for e in steps:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        inside = [k for k in kernels if lo <= k["ts"] < hi]
        dev[e["name"]] = sum(k["dur"] for k in inside) / 1e3
        fin[e["name"]] = sum(k["dur"] for k in inside
                             if "finalize" in k["name"]) / 1e3
    due = next(e for e in steps if e["name"] == due_step)
    others = [v for k, v in dev.items() if k != due_step]
    return {"due_step": due_step,
            "due_step_device_ms": dev[due_step],
            "due_step_wall_ms": due["dur"] / 1e3,
            "due_step_busy_share": dev[due_step] / (due["dur"] / 1e3),
            "due_step_finalize_ms": fin[due_step],
            "due_step_finalize_share": fin[due_step] / dev[due_step],
            "other_steps_device_ms_mean": sum(others) / len(others),
            "device_ms_by_step": dev}


def _train_runner(args, arch, device):
    """A warm-up train step now; returns the function that runs the
    profiled one (returning its count, 1)."""
    from repro_torch.launch.steps import family_fns, train_step
    from repro_torch.launch.train import deterministic, train_batch
    from repro_torch.optim import OptConfig, adamw_init
    fns = family_fns(arch)
    with deterministic(device):
        params = fns["init"](torch.Generator(device=device).manual_seed(0),
                             device)
    state = [params, adamw_init(params)]
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab,
                                         seq_len=args.train,
                                         global_batch=args.batch), 0)

    def run():
        with deterministic(device):
            state[0], state[1], m = train_step(*state, batch, fns["loss"],
                                               OptConfig())
            float(m["loss"])
        return 1

    run()
    return run


def _profile(args, device, run, what: str, extra: dict,
             close_step: str | None = None) -> dict:
    """Record ``run()`` under the profiler; print and return the summary
    (``close_step``: the name of the recorded window-closing step, whose
    breakdown the summary adds)."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = _kernel_us(avgs)
    step_ms = wall / n * 1e3
    busy = dev_us / 1e3 / (wall * 1e3) if cuda else float("nan")
    print(f"{args.compute_dtype}: {step_ms:.3f} ms per {what} "
          f"({n} in the window), device busy {busy:.3f} of the window")
    if cuda:
        print(avgs.table(sort_by="self_cuda_time_total", row_limit=TOP))
    print(avgs.table(sort_by="self_cpu_time_total", row_limit=TOP))
    summary = {"compute_dtype": args.compute_dtype, **extra, "per": what,
               "count": n, "step_ms": step_ms, "device_busy_share": busy,
               "device_ms_per_step": dev_us / 1e3 / n,
               "top_kernels": _top_kernels(avgs, dev_us) if cuda else {},
               "port_kernels": (_top_kernels(avgs, dev_us, port=True)
                                if cuda else {}),
               "device": (torch.cuda.get_device_name(0) if cuda else "cpu")}
    if close_step and cuda:
        summary["window_close"] = _step_breakdown(prof, close_step)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
