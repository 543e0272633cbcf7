"""The port's roofline arithmetic, registry list and report against the JAX
reference (CPU, pure functions; no trace).

* ``ARCHS`` equals the reference's list; ``get_arch(..., backend=)``
  overrides the attention backend as the reference's does.
* ``model_flops_for`` / ``active_params`` equal the reference's exactly
  for all ten architectures x the four shapes.
* ``Roofline.to_dict()`` equals the reference's ``Roofline`` built from
  the same numbers and the H100 constants; the constants are the H100's.
* ``collective_bytes`` on records equals the reference's HLO parser on
  the hand-written HLO lines the records stand for: every kind, group
  sizes 2, 4 and 16 (both ``replica_groups`` syntaxes), an async
  ``-start`` / ``-done`` pair counted once, and a group of one skipped;
  ``top_collectives`` costs and orders them as the reference does.
* ``roofline_report``: ``load`` order and ``fmt_row`` strings equal the
  reference's on the same record files (ok, skipped, failed, tagged).
"""

import dataclasses
import json

import pytest

from repro.analysis import roofline as jrl
from repro.analysis import roofline_report as jrep
from repro.configs import registry as jreg
from repro_torch.analysis import roofline as trl
from repro_torch.analysis import roofline_report as trep
from repro_torch.configs import registry as treg


def test_archs_list_equals_reference():
    assert treg.ARCHS == jreg.ARCHS
    assert list(treg.SHAPES) == list(jreg.SHAPES)


@pytest.mark.parametrize("arch_id", jreg.ARCHS)
def test_backend_override_equals_reference(arch_id):
    for backend in (None, "full", "mita_route"):
        t = treg.get_arch(arch_id, backend=backend)
        j = jreg.get_arch(arch_id, backend=backend)
        assert t.model.attn.backend == j.model.attn.backend
        assert t.arch_id == j.arch_id and t.family == j.family
    t = treg.get_arch(arch_id, smoke=True, backend="full")
    assert t.model.attn.backend == "full" and t.model.d_model == 128


@pytest.mark.parametrize("arch_id", jreg.ARCHS)
def test_model_flops_equal_reference(arch_id):
    t, j = treg.get_arch(arch_id), jreg.get_arch(arch_id)
    assert trl.active_params(t) == jrl.active_params(j)
    if t.family == "encdec":
        assert trl._encdec_params(t) == jrl._encdec_params(j)
    for name in jreg.SHAPES:
        assert trl.model_flops_for(t, treg.SHAPES[name]) \
            == jrl.model_flops_for(j, jreg.SHAPES[name]), name


def test_qwen3_model_flops_value():
    """6 x 595,984,384 active parameters x 16,384 tokens (B 4 x 4096)."""
    arch = treg.get_arch("qwen3-0.6b")
    assert trl.active_params(arch) == 595_984_384
    shape = treg.ShapeSpec("t", "train", 4096, 4)
    assert trl.model_flops_for(arch, shape) == 6.0 * 595_984_384 * 16_384


def test_h100_constants():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW, trl.NVLINK_BW) == (
        989.4e12, 3.35e12, 50e9, 450e9)
    r = trl.Roofline("n", "m", 1, 1.0, 1.0, 1.0, {})
    assert (r.peak_flops, r.hbm_bw, r.ici_bw) == (989.4e12, 3.35e12, 50e9)


@pytest.mark.parametrize("flops,nbytes,coll,model_flops,n", [
    (3.219e14, 1.26e13, 1.4e9, 3.75e15, 256),      # compute-bound
    (1e9, 5e13, 0.0, 1e12, 512),                   # memory-bound
    (1e9, 1e9, 7e10, 0.0, 16),                     # collective, no model
    (0.0, 0.0, 0.0, 0.0, 1),                       # all zero
])
def test_roofline_to_dict_equals_reference(flops, nbytes, coll, model_flops,
                                           n):
    breakdown = {"all-reduce": coll * 0.75, "all-gather": coll * 0.25}
    t = trl.Roofline("a:s", "16x16", n, flops, nbytes, coll, breakdown,
                     model_flops=model_flops)
    j = jrl.Roofline("a:s", "16x16", n, flops, nbytes, coll, breakdown,
                     model_flops=model_flops, peak_flops=trl.PEAK_FLOPS,
                     hbm_bw=trl.HBM_BW, ici_bw=trl.LINK_BW)
    assert t.to_dict() == j.to_dict()
    assert t.t_bound == j.t_bound
    assert dataclasses.asdict(t).keys() == dataclasses.asdict(j).keys()


# (HLO line, the record the port's trace makes for it); None: no record
HLO_RECORDS = [
    ("%ar.1 = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %p), "
     "channel_id=1, replica_groups=[16,16]<=[256], to_apply=%add",
     {"kind": "all-reduce", "bytes": 1024 * 256 * 4, "group": 16}),
    ("%ag.2 = bf16[64,4096]{1,0} all-gather(bf16[16,4096]{1,0} %x), "
     "channel_id=2, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}",
     {"kind": "all-gather", "bytes": 64 * 4096 * 2, "group": 4}),
    ("%rs.3 = f32[8,512]{1,0} reduce-scatter(f32[16,512]{1,0} %g), "
     "channel_id=3, replica_groups={{0,1},{2,3}}, dimensions={0}, "
     "to_apply=%add",
     {"kind": "reduce-scatter", "bytes": 8 * 512 * 4, "group": 2}),
    ("%a2a.4 = s32[128,32]{1,0} all-to-all(s32[128,32]{1,0} %i), "
     "channel_id=4, replica_groups=[64,4]<=[256], dimensions={0}",
     {"kind": "all-to-all", "bytes": 128 * 32 * 4, "group": 4}),
    ("%cp.5 = bf16[2,1024]{1,0} collective-permute(bf16[2,1024]{1,0} %h), "
     "channel_id=5, source_target_pairs={{0,1},{1,0}}",
     {"kind": "collective-permute", "bytes": 2 * 1024 * 2, "group": 2}),
    ("%ars.6 = f32[4096]{0} all-reduce-start(f32[4096]{0} %n), "
     "channel_id=6, replica_groups=[1,256]<=[256], to_apply=%add",
     {"kind": "all-reduce", "bytes": 4096 * 4, "group": 256}),
    ("%ard.6 = f32[4096]{0} all-reduce-done(f32[4096]{0} %ars.6)", None),
    ("%ag.7 = f32[16,16]{1,0} all-gather(f32[16,16]{1,0} %q), "
     "replica_groups={{0},{1}}, dimensions={0}",
     {"kind": "all-gather", "bytes": 16 * 16 * 4, "group": 1}),
    ("%ar.8 = bf16[2,8,128]{2,1,0} all-reduce(bf16[2,8,128]{2,1,0} %z), "
     "channel_id=8, replica_groups=[128,2]<=[256], to_apply=%add",
     {"kind": "all-reduce", "bytes": 2 * 8 * 128 * 2, "group": 2}),
]


def _records():
    return [dict(r, shape=[1], op_name=f"src:{i}")
            for i, (_, r) in enumerate(HLO_RECORDS) if r is not None]


def test_collective_bytes_equal_reference_hlo_parser():
    hlo = "\n".join(line for line, _ in HLO_RECORDS)
    assert trl.collective_bytes(_records()) == jrl.collective_bytes(hlo)
    assert set(trl.collective_bytes(_records())) == set(trl.KINDS)


@pytest.mark.parametrize("i", [i for i, (_, r) in enumerate(HLO_RECORDS)
                               if r is not None])
def test_collective_bytes_each_line(i):
    line, rec = HLO_RECORDS[i]
    assert trl.collective_bytes([rec]) == jrl.collective_bytes(line)


def test_top_collectives_equal_reference():
    hlo = "\n".join(line for line, _ in HLO_RECORDS)
    t = trl.top_collectives(_records(), n=5)
    j = jrl.top_collectives(hlo, n=5)
    assert [(c["kind"], c["bytes"], c["groups"]) for c in t] == \
        [(c["kind"], c["bytes"], c["groups"]) for c in j]
    assert all(c["op_name"].startswith("src:") for c in t)


def _report_records():
    ok = {"status": "ok", "memory": {"peak_per_device": 3 * 2**30},
          "roofline": {"t_compute": 0.25, "t_memory": 0.5,
                       "t_collective": 0.125, "bottleneck": "memory",
                       "useful_flops_fraction": 0.046,
                       "roofline_fraction": 0.0231}}
    recs = {
        "qwen3-0.6b_train_4k_16x16": dict(ok, arch="qwen3-0.6b",
                                          shape="train_4k", mesh="16x16"),
        "qwen3-0.6b_decode_32k_16x16": dict(
            ok, arch="qwen3-0.6b", shape="decode_32k", mesh="16x16",
            note="a note that is longer than forty characters, cut"),
        "qwen3-0.6b_long_500k_16x16": dict(
            ok, arch="qwen3-0.6b", shape="long_500k", mesh="16x16",
            roofline=dict(ok["roofline"], roofline_fraction=0.001)),
        "whisper-tiny_long_500k_16x16": {
            "arch": "whisper-tiny", "shape": "long_500k", "mesh": "16x16",
            "status": "skipped", "reason": "whisper decoder max context"},
        "dbrx-132b_prefill_32k_16x16": {
            "arch": "dbrx-132b", "shape": "prefill_32k", "mesh": "16x16",
            "status": "failed", "error": "NotImplementedError: a port "
                                         "kernel reached on fake tensors"},
        "mamba2-370m_train_4k_2x16x16": dict(
            ok, arch="mamba2-370m", shape="train_4k", mesh="2x16x16"),
        "mamba2-370m_train_4k_16x16_opt": dict(
            ok, arch="mamba2-370m", shape="train_4k", mesh="16x16"),
        "mamba2-370m_prefill_32k_16x16_x": dict(
            ok, arch="mamba2-370m", shape="prefill_32k", mesh="16x16"),
    }
    return recs


def test_report_load_and_rows_equal_reference(tmp_path):
    for name, rec in _report_records().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    for mesh, tag in (("16x16", ""), ("2x16x16", ""), ("16x16", "_opt"),
                      ("16x16", "_x")):
        t = trep.load(str(tmp_path), mesh, tag)
        j = jrep.load(str(tmp_path), mesh, tag)
        assert t == j and t
        assert [trep.fmt_row(r) for r in t] == [jrep.fmt_row(r) for r in j]
    assert trep.HEADER == jrep.HEADER and trep.SHAPE_ORDER == jrep.SHAPE_ORDER


def test_report_main_prints_the_table(tmp_path, capsys):
    for name, rec in _report_records().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    trep.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert trep.HEADER in out and "skipped" in out and "FAILED" in out
    assert "worst roofline fractions: qwen3-0.6b:long_500k=0.001" in out
