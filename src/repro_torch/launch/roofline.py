"""Roofline terms of a dry-run cell, priced for H100 meshes (port of
``repro/launch/roofline.py``, whose constants are a TPU v5e's).

Per-card rates, NVIDIA's published figures for the H100 SXM5 (data sheets,
not measurements):

  * 989 TFLOP/s in bf16 and fp16 (dense tensor cores; H100 data sheet);
  * 67 TFLOP/s in fp32 outside the tensor cores (H100 data sheet), the rate
    of the port's fp32 products, which run with TF32 off;
  * 3.35 TB/s of HBM3 (H100 data sheet), 80 GB of it;
  * 450 GB/s each way over NVLink to the other cards of a host of 8 (900
    GB/s total a card, fourth-generation NVLink; DGX H100 user guide);
  * 50 GB/s a card between hosts: one 400 Gb/s ConnectX-7 port a GPU, as
    on a DGX H100 (DGX H100 user guide).

The terms, as the JAX package forms them, from per-rank counts scaled by
``chips`` (the stored numbers are global; each term divides back):

  compute term    = sum over operand dtypes of FLOPs / (chips * peak[dtype])
  memory term     = bytes / (chips * hbm_bw)
  collective term = NVLink bytes / (chips * nvlink_bw)
                    + inter-host bytes / (chips * inter_host_bw)

For an all-bf16 program with every collective inside a host this is JAX's
formula at H100 rates.  A collective is priced between hosts when its group
spans more than one host of ``ranks_per_host`` consecutive ranks.

:func:`collective_bytes` keeps JAX's convention, operand (shard) bytes by
kind, converted from each call's result bytes (an all-gather's result
divided by the group, a reduce-scatter's multiplied by it); it reads the
calls the traced program made, not HLO text.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100", "COLLECTIVES", "collective_bytes", "RooflineTerms", "spans_hosts"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card rates (see the module docstring for their sources)."""

    peak_flops: tuple = (("bfloat16", 989e12), ("float16", 989e12), ("float32", 67e12))
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    nvlink_bw: float = 450e9
    inter_host_bw: float = 50e9
    ranks_per_host: int = 8

    def peak(self, dtype: str) -> float:
        """The peak FLOP/s of products in ``dtype`` (a torch dtype's name
        without ``torch.``); another dtype raises."""
        table = dict(self.peak_flops)
        if dtype not in table:
            raise KeyError(f"no H100 peak rate for {dtype} products (have {sorted(table)})")
        return table[dtype]


H100 = HW()

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def spans_hosts(ranks) -> bool:
    """Whether a group of global ``ranks`` spans more than one host of
    ``H100.ranks_per_host`` consecutive ranks."""
    return len({r // H100.ranks_per_host for r in ranks}) > 1


def collective_bytes(calls) -> dict[str, int]:
    """Operand (shard) bytes per collective kind, JAX's convention, from
    ``(kind, result_bytes, group_size)`` per call: an all-gather's result is
    the operand times the group, a reduce-scatter's the operand over it,
    every other kind's the operand."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, result, g in calls:
        if kind == "all-gather":
            result //= max(g, 1)
        elif kind == "reduce-scatter":
            result *= g
        out[kind] += result
    return out


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three terms of one cell.  ``flops``, ``hbm_bytes`` and
    ``coll_bytes`` are global (per rank times ``chips``); ``flops_by_dtype``
    splits ``flops`` by operand dtype (empty: all bf16), and
    ``coll_bytes_inter`` is the part of ``coll_bytes`` moved by groups that
    span hosts."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    flops_by_dtype: tuple = ()
    coll_bytes_inter: float = 0.0

    @property
    def compute_s(self) -> float:
        parts = self.flops_by_dtype or (("bfloat16", self.flops),)
        return sum(f / (self.chips * H100.peak(dt)) for dt, f in parts)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * H100.hbm_bw)

    @property
    def collective_s(self) -> float:
        intra = self.coll_bytes - self.coll_bytes_inter
        return (intra / (self.chips * H100.nvlink_bw)
                + self.coll_bytes_inter / (self.chips * H100.inter_host_bw))

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "coll_bytes_inter_host": self.coll_bytes_inter,
        }
