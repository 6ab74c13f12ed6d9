"""Roofline terms of one card, the port of the reference's
``roofline.py`` (its ``HW`` and ``RooflineReport``).

Three terms per (arch x shape x mesh):

    compute    = flops_per_device / peak_flops
    memory     = hbm_bytes_per_device / hbm_bw
    collective = wire_bytes_per_device / ici_bw

The reference prices them with a TPU v5e; the port's entry is
``H100``: an NVIDIA H100 SXM5 80 GB at its 700 W limit, from NVIDIA's
H100 data sheet.  A card set to a lower power limit runs slower under
load, so a measurement priced against this entry names the card and the
limit it ran at (``nvidia-smi --query-gpu=name,power.limit``).

The reference reads its three terms from a compiled executable's HLO
text and ``memory_analysis()``.  The port has neither: ``analyze`` takes
an ``hlocount.HloCost``, the counted operation stream of one shard's
program (``hlocount.analyze``), and the per-shard state bytes the caller
computes from the sharding specs in place of ``memory_analysis()``'s
argument bytes.  ``parse_collectives`` is the list of that cost's
collective records (kind, group size, result bytes), and
``collective_wire_bytes`` applies the reference's per-kind ring model
to them (``hlocount.wire_bytes``; the reference's own ``CollectiveOp``
charges a reduce-scatter (g-1)/g of its result, the shard, where its
``hlocount`` charges g-1 shards, a ring's; the port charges the
latter everywhere).  ``memory_analysis()``'s temp bytes are not mapped
on ``meta``;
on the card a step's peak comes from ``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["HW", "H100", "CollectiveOp", "parse_collectives",
           "collective_wire_bytes", "RooflineReport", "analyze"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float  # per card, in the arithmetic the kernels use
    hbm_bw: float  # bytes/s per card
    ici_bw: float  # bytes/s per card between cards


# NVIDIA H100 SXM5 80 GB, 700 W (NVIDIA H100 Tensor Core GPU data sheet).
# peak_flops is the non-tensor FP32 peak, 67 TFLOP/s: the port's kernels
# do their ACS arithmetic in f32 on the CUDA cores, with no tensor-core
# math and no TF32.  hbm_bw is the HBM3 bandwidth, 3.35 TB/s.  ici_bw is
# the data sheet's NVLink figure, 900 GB/s per card (18 links, both
# directions together), where the reference's v5e entry gives a link's.
H100 = HW(name="h100-sxm5-80gb-700w", peak_flops=67e12, hbm_bw=3.35e12,
          ici_bw=900e9)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple
    group_size: int
    result_bytes: int

    @property
    def wire_bytes(self) -> float:
        from repro_torch.hlocount import wire_bytes

        return wire_bytes(self.kind, self.group_size, self.result_bytes)


def parse_collectives(cost) -> List[CollectiveOp]:
    """The collectives of an ``hlocount.HloCost`` (or a list of
    ``collective_log`` records) as ``CollectiveOp``s."""
    records = cost.collectives if hasattr(cost, "collectives") else cost
    return [CollectiveOp(kind=r["kind"], dtype=r["dtype"], shape=tuple(r["shape"]),
                         group_size=r["group_size"], result_bytes=r["result_bytes"])
            for r in records]


def collective_wire_bytes(cost) -> float:
    return sum(op.wire_bytes for op in parse_collectives(cost))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    n_chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float  # 6*N*D (or 6*N_active*D) global
    hw: HW = H100
    collective_counts: Optional[Dict[str, int]] = None
    memory_stats: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device flops x chips)."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline lower-bound step time."""
        denom = self.step_time_lb * self.n_chips * self.hw.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "cell": self.cell,
            "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
            "collective_counts": self.collective_counts,
            "memory_stats": self.memory_stats,
        }


def analyze(arch: str, cell: str, mesh_name: str, n_chips: int, cost,
            model_flops: float, hw: HW = H100,
            memory_stats: Optional[dict] = None) -> RooflineReport:
    """Build a report from an ``hlocount.HloCost`` of one shard's program.
    ``memory_stats`` (the caller's) carries the per-shard state bytes as
    ``argument_bytes``; ``temp_bytes`` is None where not measured."""
    return RooflineReport(
        arch=arch,
        cell=cell,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=float(cost.flops),
        hbm_bytes_per_device=float(cost.bytes),
        wire_bytes_per_device=float(collective_wire_bytes(cost)),
        model_flops=model_flops,
        hw=hw,
        collective_counts={k: int(v) for k, v in cost.coll_counts.items()},
        memory_stats=memory_stats,
    )
