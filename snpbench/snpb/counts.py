"""The yardstick's arithmetic: published peaks and the bytes the work
needs, counted from the system's own sizes and the traffic's caps, never
from a kernel's arguments or layout.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; the
host link is PCIe Gen5 x16, 128 GB/s both ways, so 64 GB/s one way.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
HOST_LINK_BYTES_PER_S = 64e9

# A rule is six 32-bit fields (neuron, consume, produce, base, period,
# covering), a synapse two, a configuration entry one; a visited entry
# is a 64-bit key.
RULE_BYTES = 24
SYNAPSE_BYTES = 8
ENTRY_BYTES = 4
KEY_BYTES = 8


def system_bytes(sizes: dict) -> int:
    """The system read once: its rules and synapses at their own sizes."""
    return sizes["num_rules"] * RULE_BYTES \
        + sizes["num_synapses"] * SYNAPSE_BYTES


def step_bytes(sizes: dict, F: int, T: int) -> int:
    """The least bytes of one level's step: ``F`` frontier rows read once,
    the system read once, and the ``F·T`` candidates (rows, a validity
    byte and a 32-bit emission each) written once."""
    m = sizes["num_neurons"]
    return F * m * ENTRY_BYTES + system_bytes(sizes) \
        + F * T * (m * ENTRY_BYTES + 1 + 4)


def explore_io_bytes(sizes: dict, F: int, rows: int, levels: int) -> int:
    """The least device bytes of one explore that archived ``rows``
    configurations in ``levels`` levels: its inputs and outputs only, no
    intermediate.  Every archived row but the last level's (at most
    ``F``) is read once as a frontier row, written once as a frontier row
    and once into the archive, and its key written once into the visited
    set; each level reads the system once."""
    m = sizes["num_neurons"]
    row = m * ENTRY_BYTES
    return row * (max(0, rows - F) + 2 * rows) + rows * KEY_BYTES \
        + levels * system_bytes(sizes)


def archive_bytes(sizes: dict, rows: int) -> int:
    """The archive delivered to the host."""
    return rows * sizes["num_neurons"] * ENTRY_BYTES


def explore_least_s(sizes: dict, F: int, rows: int, levels: int) -> float:
    """The least time of one explore: the larger of its device bytes at
    HBM bandwidth and its archive over the host link."""
    return max(explore_io_bytes(sizes, F, rows, levels) / HBM_BYTES_PER_S,
               archive_bytes(sizes, rows) / HOST_LINK_BYTES_PER_S)
