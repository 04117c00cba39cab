"""The port's SNP engine: its public names so far.

* :class:`SNPSystem`, :class:`Rule`, :func:`paper_pi` — the specification
  (copies of the reference's, :mod:`.system`, :mod:`.generators`);
* :func:`compile_system` — the dense ``M_Π`` encoding (:mod:`.matrix`);
* :mod:`.semantics` — applicability, branch decode, ``C' = C + S·M``;
* :mod:`.backend` — the ``"ref"`` and ``"cuda"`` step backends;
* :func:`explore`, :func:`successor_set`, :func:`emission_gaps`,
  :func:`run_traces`, :func:`run_trace` — the entry points
  (:mod:`.engine`), which run on the card unless ``device`` names another.
"""

from .backend import CudaBackend, RefBackend, StepBackend, get_backend
from .convert import compiled_from_arrays, system_from_spec
from .engine import (ExploreResult, TraceOut, emission_gaps, explore,
                     resolve_dedup, run_trace, run_traces, successor_set)
from .hashtable import (HashTable, first_occurrence, insert_if_absent,
                        insert_unique, lookup, make_table, table_slots)
from .matrix import CompiledSNP, compile_system, is_compiled
from .semantics import (applicability, branch_info, next_configs,
                        spiking_vectors)
from .system import Rule, SNPSystem, paper_pi

__all__ = [
    "SNPSystem", "Rule", "paper_pi",
    "CompiledSNP", "compile_system", "is_compiled",
    "system_from_spec", "compiled_from_arrays",
    "HashTable", "make_table", "table_slots", "lookup", "first_occurrence",
    "insert_unique", "insert_if_absent",
    "applicability", "branch_info", "next_configs", "spiking_vectors",
    "StepBackend", "RefBackend", "CudaBackend",
    "get_backend",
    "explore", "resolve_dedup", "ExploreResult", "TraceOut", "successor_set",
    "emission_gaps", "run_trace", "run_traces",
]
