"""Roofline terms of one dry-run cell (port of ``repro.analysis.roofline``).

Three terms per (arch x shape x mesh), all in seconds a step:

  compute    = FLOPs_per_rank / PEAK_FLOPS
  memory     = bytes_per_rank / HBM_BW
  collective = collective_bytes_per_rank / LINK_BW

The counts come from `launch.dryrun`, which runs the cell once on fake
tensors: matmul FLOPs with the 2·M·N·K convention (``FlopCounterMode``),
the bytes every non-view operator reads and writes, and one record per
collective the step issues: its kind (the reference's HLO names),
payload bytes (the bytes of the collective's result, as an HLO line
gives its shape), group size and the port's source frame.  Each
collective is costed with ring-algorithm byte counts over its group size
n, the reference's rules unchanged:

  all-reduce      2·(n-1)/n · payload     (reduce-scatter + all-gather phases)
  all-gather        (n-1)/n · full_result
  reduce-scatter    (n-1)/n · full_input
  all-to-all        (n-1)/n · payload
  collective-permute          payload

The constants are one NVIDIA H100 SXM5 80 GB (HBM3), the card the port
runs on.  The 16 x 16 production mesh is 32 nodes of 8 cards, so every
axis of it crosses nodes: the link term takes the per-GPU InfiniBand
rate, one 400 Gb/s ConnectX-7 port a GPU.  NVLink 4 inside a node is
faster (``NVLINK_BW``); one rate for every collective keeps the
reference's single link term, and a collective that stays inside a node
is costed at the slower rate.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column: BF16 Tensor Core
# 1,979 TFLOP/s with sparsity, 989.4 TFLOP/s dense.
PEAK_FLOPS = 989.4e12
# Same datasheet, H100 SXM: GPU memory bandwidth 3.35 TB/s (80 GB HBM3).
HBM_BW = 3.35e12
# NVIDIA DGX H100 datasheet: 8 x ConnectX-7, 400 Gb/s NDR InfiniBand a
# port, one port a GPU for the compute fabric: 50 GB/s a direction.
LINK_BW = 50e9
# H100 SXM datasheet: NVLink 4, 900 GB/s a GPU in both directions, 450
# GB/s a direction (inside one 8-GPU node; recorded, not used).
NVLINK_BW = 450e9

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes one rank sends for one collective: ``payload`` is the bytes
    of its result, ``n`` its group size (0 for a group of one)."""
    if n <= 1:
        return 0.0
    eff = (n - 1) / n
    if kind == "all-reduce":
        return 2 * eff * payload
    if kind == "all-gather":
        return eff * payload            # result is the full buffer
    if kind == "reduce-scatter":
        return eff * payload * n        # result is 1/n of the input
    if kind == "all-to-all":
        return eff * payload
    return float(payload)               # collective-permute


def collective_bytes(records: list[dict]) -> dict[str, float]:
    """Per-rank collective traffic (bytes) by kind, ring-costed; each
    record has ``kind``, ``bytes`` (payload) and ``group``."""
    out: dict[str, float] = defaultdict(float)
    for r in records:
        if r["group"] <= 1:
            continue
        out[r["kind"]] += ring_bytes(r["kind"], r["bytes"], r["group"])
    return dict(out)


def top_collectives(records: list[dict], n: int = 15) -> list[dict]:
    """The n costliest collectives with their byte cost, shape and the
    port's source frame (``op_name``): maps collectives back to the
    model code.  Each record is one issue of the collective."""
    out = []
    for r in records:
        if r["group"] <= 1:
            continue
        out.append({"kind": r["kind"],
                    "bytes": ring_bytes(r["kind"], r["bytes"], r["group"]),
                    "shape": str(r.get("shape", ""))[:60],
                    "groups": r["group"],
                    "op_name": r.get("op_name", "")[:160]})
    out.sort(key=lambda d: -d["bytes"])
    return out[:n]


@dataclasses.dataclass
class Roofline:
    name: str
    mesh: str
    n_devices: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict[str, float]
    model_flops: float = 0.0           # 6·N_active·D analytic, whole step
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (no overlap assumption: max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs over all ranks: catches remat and compute
        that every rank repeats."""
        total = self.flops_per_chip * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        (useful flop time) / (roofline step time)."""
        t_useful = self.model_flops / self.n_devices / self.peak_flops
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "name": self.name, "mesh": self.mesh, "n_devices": self.n_devices,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(name: str, mesh_name: str, n_devices: int, counts,
                model_flops: float = 0.0) -> Roofline:
    """The roofline of one traced cell: ``counts`` has ``flops``,
    ``bytes`` and ``collectives`` (records as `collective_bytes` takes
    them), per rank."""
    coll = collective_bytes(counts.collectives)
    return Roofline(
        name=name, mesh=mesh_name, n_devices=n_devices,
        flops_per_chip=float(counts.flops),
        bytes_per_chip=float(counts.bytes),
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=model_flops,
    )


# --------------------------------------------------- analytic MODEL_FLOPS ---

def model_flops_for(arch, shape) -> float:
    """6·N_params_active·D_tokens for train; 2·N_active·tokens for inference.

    enc-dec counts encoder and decoder stacks against their own token
    streams (t_enc frames vs dec_len tokens) separately."""
    if arch.family == "encdec":
        enc, dec, emb = _encdec_params(arch)
        if shape.kind == "train":
            return 6.0 * shape.batch * (enc * arch.t_enc
                                        + (dec + emb) * arch.dec_len)
        if shape.kind == "prefill":
            return 2.0 * shape.batch * enc * arch.t_enc
        return 2.0 * shape.batch * (dec + emb)
    n_active = active_params(arch)
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq
    return 2.0 * n_active * shape.batch        # decode: one token per seq


def _encdec_params(arch):
    cfg = arch.model
    d, dh = cfg.d_model, cfg.dh
    attn = d * dh * (cfg.n_heads * 2 + cfg.n_kv * 2)
    ffn = 2 * d * cfg.d_ff
    enc = cfg.n_layers * (attn + ffn)
    dec = cfg.n_layers * (2 * attn + ffn)  # self + cross
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return enc, dec, emb


def active_params(arch) -> float:
    """Parameters touched per token (MoE counts shared + top-k experts)."""
    cfg = arch.model
    d, dh = cfg.d_model, cfg.dh
    attn = d * dh * (cfg.n_heads * 2 + cfg.n_kv * 2)
    if cfg.n_experts:
        ffn = 3 * d * cfg.d_ff * (cfg.moe_top_k + cfg.n_shared_experts)
        ffn += d * cfg.n_experts  # router
    else:
        ffn = 3 * d * cfg.d_ff
    if arch.family == "ssm":
        d_in, s = 2 * d, 128
        per_layer = d * (2 * d_in + 2 * s + d_in // 64) + d_in * d
    elif arch.family == "hybrid":
        # super-block = 2 RG-LRU (5 Dr·Dr maps each) + 1 FFN + 1 attn block
        rec = 5 * d * d
        per_layer = (2 * rec + attn + 2 * (3 * d * cfg.d_ff)) / 3.0
    elif arch.family == "encdec":
        enc, dec, emb = _encdec_params(arch)
        return enc + dec + emb
    else:
        per_layer = attn + ffn
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return cfg.n_layers * per_layer + emb
