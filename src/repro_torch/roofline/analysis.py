"""Roofline terms of one step at H100 rates, the port of the JAX package's
``roofline/analysis.py``.

Three terms per (arch × shape × mesh), all in seconds:

    compute    = Σ_dtype FLOPs_dtype / peak_dtype
    memory     = HBM bytes / 3.35 TB/s
    collective = NVLink link bytes / 450 GB/s + InfiniBand link bytes
                 / 50 GB/s

FLOPs, bytes and link bytes are those of the *per-device* program, as
:class:`~repro_torch.roofline.counter.StepCounter` counts them on one
eager step (the reference reads them from the compiled SPMD program),
so the per-card denominators apply directly.  :data:`HW` holds the H100
SXM data sheet's figures: 989 TFLOP/s dense bf16 and fp16 on the tensor
cores, 67 TFLOP/s f32 (the port keeps TF32 off, so f32 products run on
the f32 pipe), 3.35 TB/s of HBM3 and 80 GB of it; NVLink 4 at 900 GB/s a
card, 450 GB/s a direction, among the 8 cards of a node, and InfiniBand
NDR at 400 Gb/s = 50 GB/s a card between nodes.  The ring's per-device
link bytes leave a card in one direction, so they go at the rate of one
direction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from .counter import COLLECTIVES, StepCounter, wire_bytes

__all__ = ["HW", "CollectiveStats", "collective_stats", "roofline_terms",
           "analyze_step"]

HW = {
    "flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 67e12},
    "hbm": 3.35e12,             # HBM3 bytes/s a card
    "hbm_capacity": 80e9,       # bytes a card
    "nvlink": 450e9,            # bytes/s a card, one direction, in a node
    "ib": 50e9,                 # bytes/s a card between nodes (NDR)
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    tensor_bytes: Dict[str, float]   # summed op tensor sizes
    link_bytes: float                # per-device bytes over the wire
    details: List[Tuple[str, float, int]]  # (op, bytes, group)

    def total_count(self) -> int:
        return sum(self.counts.values())


def collective_stats(details) -> CollectiveStats:
    """The reference's :class:`CollectiveStats` of a list of ``(kind,
    bytes, group size[, link class])`` collectives (a counter's
    ``details``)."""
    counts = {k: 0 for k in COLLECTIVES}
    tbytes = {k: 0.0 for k in COLLECTIVES}
    link = 0.0
    out = []
    for kind, size, g, *_ in details:
        counts[kind] += 1
        tbytes[kind] += size
        link += wire_bytes(kind, size, g)
        out.append((kind, size, g))
    return CollectiveStats(counts=counts, tensor_bytes=tbytes,
                           link_bytes=link, details=out)


def _compute_s(flops: Union[float, Mapping[str, float]]) -> float:
    if not isinstance(flops, Mapping):
        flops = {"bfloat16": flops}
    rates = HW["flops"]
    return sum(f / rates.get(d, rates["float32"]) for d, f in flops.items())


def roofline_terms(flops, hbm_bytes: float, link_bytes, chips: int,
                   model_flops: Optional[float] = None,
                   links_per_chip: int = 1) -> Dict[str, float]:
    """All terms in seconds.  ``flops`` is a number (bf16 FLOPs) or FLOPs
    by dtype name; ``link_bytes`` a number (NVLink bytes) or link bytes
    by class (``"nvlink"``, ``"ib"``).  FLOPs and bytes are per-device
    program numbers, so the per-card rates apply directly."""
    if not isinstance(link_bytes, Mapping):
        link_bytes = {"nvlink": link_bytes}
    compute = _compute_s(flops)
    memory = hbm_bytes / HW["hbm"]
    collective = sum(b / (HW[cls] * links_per_chip)
                     for cls, b in link_bytes.items())
    total = sum(flops.values()) if isinstance(flops, Mapping) else flops
    out = {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "bound": max(
            (("compute", compute), ("memory", memory),
             ("collective", collective)),
            key=lambda kv: kv[1])[0],
    }
    if model_flops:
        # model_flops is global; per-chip share:
        out["model_flops_per_chip"] = model_flops / chips
        out["useful_flops_frac"] = (model_flops / chips) / max(total, 1.0)
    return out


def analyze_step(counter: StepCounter, *, chips: int,
                 model_flops: Optional[float] = None,
                 argument_bytes: Optional[int] = None) -> Dict:
    """Full record of one counted step (the reference's
    ``analyze_compiled``): FLOPs by dtype, HBM bytes, collectives by kind
    and link class, memory (``argument_bytes``: the step's inputs held by
    one device; ``temp_bytes``: the peak of what the step allocates and
    holds; ``peak_bytes`` their sum, against the card's capacity) and the
    three terms."""
    stats = collective_stats(counter.details)
    link = {"nvlink": 0.0, "ib": 0.0}
    for kind, size, g, cls in counter.details:
        link[cls] += wire_bytes(kind, size, g)
    temp = counter.peak_bytes
    memory = {
        "argument_bytes": argument_bytes,
        "temp_bytes": temp,
        "peak_bytes": None if argument_bytes is None
        else argument_bytes + temp,
        "capacity_bytes": HW["hbm_capacity"],
    }
    flops = dict(counter.flops_by_dtype)
    terms = roofline_terms(flops, counter.bytes, link, chips, model_flops)
    return {
        "flops_per_chip": counter.flops,
        "flops_by_dtype": flops,
        "hbm_bytes_per_chip": counter.bytes,
        "collective_link_bytes": sum(link.values()),
        "collective_link_bytes_by_class": link,
        "collective_counts": stats.counts,
        "collective_tensor_bytes": stats.tensor_bytes,
        "memory": memory,
        **terms,
    }
