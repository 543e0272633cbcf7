"""The port's dry run (`launch.dryrun`) and the cells it traces (CPU).

Every fake-group test joins a ``fake`` process group in this process and
leaves it at teardown (`fake_group`); the ``gloo`` checks run in spawned
ranks (`_torch_cell_checks`).

* The reference's ``test_dryrun_cell_on_test_mesh`` asserts, on a smoke
  qwen3-0.6b train cell on a fake 2 x 4 mesh: temp memory >= 0, FLOPs
  and both time terms > 0.  Its collectives (the dense train cell is
  tensor-parallel over "model", `distributed.tensor_parallel`):
  all-reduces over "model" (4 ranks) and "data" (2), and, by the KV-group
  rule (4 ranks > 2 KV heads), all-gathers of a group's wq / wk / wv
  columns over the 2 ranks that share it and reduce-scatters of their
  gradients.
* Per-rank FLOPs on D x M, exactly, no tolerance: at M = 1 the 1 x 1
  count at batch B / D; at M = 2 and 4 the 1 x 1 count at batch B / D of
  the model with the rank's local config (heads, KV heads, FFN width and
  vocabulary divided by M, ROADMAP C.16), plus at M = 4 the replicated
  group work: each rank projects its KV group's 2 query heads, not its 1
  (forward and both backward products of x @ wq's extra columns).
* The 1 x 1 count equals ``FlopCounterMode`` over plain `train_step` on
  real CPU tensors (same batch shape).
* FLOPs and collective bytes at depths 2, 3, 4 and 5 are exactly linear
  (the reference's two-depth fit is exact for them); bytes are exactly
  quadratic (the backward of each layer's view of a stacked parameter),
  which the fit under-counts: ``calibrated_roofline`` traces the full
  depth once.
* The counters are exact on a two-operator function (bytes, argument,
  output and peak bytes), and the peak equals ``MemTracker``'s on a
  remat train cell.
* Fault 1: the prefill and decode cells of six families on a 2 x 2
  ``gloo`` group, bit-equal to the plain functions on the gathered inputs
  (the whole batch and each data rank's share); outputs placed as the
  cell's ``out_shardings``.  Three cases are held to a tolerance
  instead: the prefills of qwen3-0.6b, deepseek-moe-16b and
  internvl2-76b, which compute tensor- (and expert-) parallel over
  "model" (the dense, moe and vlm families), so their row-parallel sums
  add in another order:
  float leaves within 1e-5 of each leaf's max (float32), integer leaves
  exact (`_torch_cell_checks._close`).
* Fault 2: the MoE train cell traces on a fake mesh (its aux loss has a
  static shape).
* ``run_cell``: records with the reference's keys (``trace_s`` for
  ``lower_s`` / ``compile_s``), a skipped whisper-tiny ``long_500k``, and
  a cell that reaches a port kernel (``impl=pallas``) failing with no
  launch.
"""

import dataclasses
import os
import sys

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_arch
from repro_torch.data import DataConfig
from repro_torch.device import cpu_log_ready
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, family_fns, train_step
from repro_torch.launch.train import train_batch
from repro_torch.optim import OptConfig, adamw_init

sys.path.insert(0, os.path.dirname(__file__))
import _torch_cell_checks as cells  # noqa: E402
import _torch_dist_checks as chk  # noqa: E402

SEQ = 64
REF_KEYS = {"arch", "shape", "mesh", "backend", "state_policy",
            "attn_overrides", "microbatch", "status", "memory", "roofline"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_per_device"}


@pytest.fixture
def fake_group():
    """``fake_group(D, M)``: a fake D x M mesh on the trace device; the
    group is left at teardown."""
    def make(d, m):
        cpu_log_ready()       # a process's first CPU step runs it once
        dr.join_fake_group(d * m)
        return make_host_mesh(d, m, device_type=dr.trace_device())
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke_qwen3(**model):
    arch = get_arch("qwen3-0.6b", smoke=True)
    model = {"d_model": 128, "n_heads": 4, "n_kv": 2, "head_dim": 32,
             "d_ff": 256, "vocab": 256, **model}
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **model))


def test_dryrun_cell_on_test_mesh(fake_group):
    mesh = fake_group(2, 4)
    arch = _smoke_qwen3()
    shape = ShapeSpec("t", "train", SEQ, 8)
    counts = dr._measure(arch, shape, mesh)
    assert counts.temp_bytes >= 0
    roof = rl.from_counts("qwen3-0.6b:t", "2x4", 8, counts, model_flops=1e9)
    assert roof.flops_per_chip > 0
    assert roof.t_compute > 0 and roof.t_memory > 0
    kinds = {(c["kind"], c["group"]) for c in counts.collectives}
    assert kinds == {("all-gather", 2), ("all-reduce", 2),
                     ("all-reduce", 4), ("reduce-scatter", 2)}, kinds
    assert all(c["op_name"].startswith("repro_torch/")
               for c in counts.collectives)
    assert roof.coll_bytes_per_chip > 0
    cal = dr.calibrated_roofline(arch, shape, mesh, "2x4", 1e9)
    assert cal.to_dict() == roof.to_dict()


def _one_rank_count(**model) -> float:
    """The 1 x 1 FLOPs of the smoke train cell at batch 4."""
    cpu_log_ready()
    dr.join_fake_group(1)
    try:
        mesh = make_host_mesh(1, 1, device_type=dr.trace_device())
        return dr._measure(_smoke_qwen3(**model),
                           ShapeSpec("t", "train", SEQ, 4), mesh).flops
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_rank_flops():
    """The 1 x 1 count of the smoke train cell at batch 4."""
    return _one_rank_count()


def _split_share_flops(m: int) -> float:
    """What one rank of a "model" axis of ``m`` ranks computes at batch 4:
    the local config's 1 x 1 count, plus the query columns of its KV
    group's other heads where ``m`` exceeds the 2 KV heads."""
    cfg = _smoke_qwen3().model
    count = _one_rank_count(n_heads=cfg.n_heads // m,
                            n_kv=max(cfg.n_kv // m, 1),
                            d_ff=cfg.d_ff // m, vocab=cfg.vocab // m)
    if m > cfg.n_kv:
        extra = cfg.group - cfg.n_heads // m       # heads projected twice
        # x [4 x SEQ, d] @ wq's extra columns: forward, dx and dw
        count += cfg.n_layers * 3 * 2 * 4 * SEQ * cfg.d_model \
            * extra * cfg.dh
    return count


@pytest.mark.parametrize("model", [1, 2, 4])
def test_per_rank_flops_equal_data_share(fake_group, one_rank_flops, model):
    """At M = 1 a rank computes the 1 x 1 count at its data share; at M
    = 2 and 4 its tensor-parallel share of it, exactly
    (`_split_share_flops`)."""
    want = one_rank_flops if model == 1 else _split_share_flops(model)
    mesh = fake_group(2, model)
    got = dr._measure(_smoke_qwen3(), ShapeSpec("t", "train", SEQ, 8),
                      mesh).flops
    assert got == want > 0
    if model > 1:
        assert got < one_rank_flops


def test_one_rank_flops_equal_plain_train_step(one_rank_flops):
    arch = _smoke_qwen3()
    fns = family_fns(arch)
    params = fns["init"](torch.Generator().manual_seed(0), "cpu")
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab,
                                         seq_len=SEQ, global_batch=4), 0)
    with FlopCounterMode(display=False) as fc:
        train_step(params, adamw_init(params), batch, fns["loss"],
                   OptConfig())
    assert one_rank_flops == fc.get_total_flops() > 0


def test_counts_in_depth(fake_group):
    """FLOPs and collective bytes are exactly linear in depth, so the
    reference's two-depth fit (2 and 4) gives the counts at 3 and 5
    exactly.  Bytes are exactly quadratic: each layer's view of a stacked
    parameter (``layer_params``) has a backward that writes a zero tensor
    of the whole stack and adds it to the stack's gradient.  The fit
    misses that, so the dry run traces the full depth."""
    mesh = fake_group(2, 2)
    shape = ShapeSpec("t", "train", SEQ, 4)
    got = {}
    for n in (2, 3, 4, 5):
        c = dr._measure(_smoke_qwen3(n_layers=n), shape, mesh)
        got[n] = (c.flops, sum(rl.collective_bytes(c.collectives).values()),
                  c.bytes)
    for i in range(2):
        f2, f3, f4, f5 = (got[n][i] for n in (2, 3, 4, 5))
        slope = max(0.0, (f4 - f2) / (4 - 2))   # the reference's fit
        assert f2 + slope * (3 - 2) == f3 and f2 + slope * (5 - 2) == f5
        assert f4 > f2 > 0
    b2, b3, b4, b5 = (got[n][2] for n in (2, 3, 4, 5))
    assert b4 - 2 * b3 + b2 == b5 - 2 * b4 + b3 > 0
    assert b2 + (b4 - b2) / 2 * (5 - 2) < b5


def test_counters_exact_on_two_ops():
    n = 1000                                   # 4000 bytes: 8 blocks

    def fn(x, y):
        return (x * y).sum()

    counts = dr.trace(fn, lambda fm: (torch.empty(n), torch.empty(n)))
    # mul reads 2n floats and writes n; sum reads n and writes one
    assert counts.bytes == 4 * (3 * n + n + 1)
    assert counts.flops == 0
    assert counts.argument_bytes == 2 * 4096
    assert counts.output_bytes == 512
    # x, y and x * y live while the sum writes its output
    assert counts.peak_bytes == 3 * 4096 + 512
    assert counts.temp_bytes == 4096 and counts.alias_bytes == 0


def test_peak_equals_memtracker_on_a_remat_cell(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    mesh = fake_group(1, 1)
    arch = _smoke_qwen3(remat=True, compute_dtype=torch.bfloat16)
    cell = build_cell(arch, ShapeSpec("t", "train", SEQ, 4), mesh)
    counts = dr.trace(cell.fn, lambda fm: dr._fake_args(cell, mesh, fm))
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        args = dr._fake_args(cell, mesh, fm)
        mt = MemTracker()
        mt.track_external(*[t for t in tree_leaves(args)
                            if isinstance(t, torch.Tensor)])
        with mt:
            cell.fn(*args)
    peak = mt.get_tracker_snapshot("peak")[torch.device(mesh.device_type)]
    assert abs(counts.peak_bytes - peak["Total"]) <= 512 * 64


@pytest.fixture(scope="module")
def cell_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    chk.spawn(cells.world_cells, 4, str(out))
    return torch.load(out / "cells.pt", weights_only=False)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch_id", cells.ARCHS)
def test_cells_on_gloo_2x2_equal_plain(cell_world, arch_id, kind):
    for rank, res in enumerate(cell_world):
        assert res[arch_id][kind] == {"out_placed": True,
                                      "whole_batch": True,
                                      "per_share": True}, rank


def test_moe_train_cell_traces_on_fake_mesh(fake_group):
    mesh = fake_group(2, 2)
    arch = get_arch("deepseek-moe-16b", smoke=True)
    counts = dr._measure(arch, ShapeSpec("t", "train", SEQ, 4), mesh)
    assert counts.flops > 0 and counts.peak_bytes > 0


def test_run_cell_records(tmp_path):
    try:
        ok = dr.run_cell("whisper-tiny", "decode_32k", False, str(tmp_path))
        skipped = dr.run_cell("whisper-tiny", "long_500k", False,
                              str(tmp_path))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert ok["status"] == "ok", ok.get("error")
    assert REF_KEYS | {"trace_s", "note"} == set(ok)
    assert set(ok["memory"]) == MEM_KEYS
    m = ok["memory"]
    assert m["peak_per_device"] == m["argument_bytes"] \
        + m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
    assert ok["roofline"]["n_devices"] == 256
    assert ok["roofline"]["model_flops"] == rl.model_flops_for(
        get_arch("whisper-tiny"), SHAPES["decode_32k"])
    assert skipped["status"] == "skipped" and "whisper" in skipped["reason"]
    # resumable: the file is read back, not traced again
    again = dr.run_cell("whisper-tiny", "decode_32k", False, str(tmp_path))
    assert again == ok and not dist.is_initialized()


def test_kernel_cell_fails_without_launch(tmp_path):
    ops.reset_launch_counts()
    try:
        rec = dr.run_cell("whisper-tiny", "prefill_32k", False,
                          str(tmp_path), attn_overrides={"impl": "pallas"})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "failed"
    assert "kernel reached on fake tensors" in rec["error"]
    assert sum(ops.launch_counts().values()) == 0


def test_cli_one_cell(tmp_path, capsys):
    rc = dr.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                  "--both-meshes", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and out.count("skipped") == 2 and "failures: 0" in out
    assert not dist.is_initialized()
