"""The port's SNP engine: its public names so far.

* :class:`SNPSystem`, :class:`Rule`, :func:`paper_pi`, :func:`with_delays`
  — the specification (copies of the reference's, :mod:`.system`,
  :mod:`.generators`);
* :func:`compile_system`, :func:`compile_system_sparse` — the dense
  ``M_Π`` and the ELL/hybrid encodings (:mod:`.matrix`), chosen by a
  :class:`SystemPlan` (:mod:`.plan`), which also lowers a neuron-axis
  partition (:func:`compile_sharded`);
* :mod:`.semantics` — applicability, branch decode, ``C' = C + S·M``, the
  same step on the sparse encoding, and the delayed tier's steps on both
  (``SystemPlan(semantics="delays")``);
* :mod:`.backend` — the ``"ref"``, ``"cuda"``, ``"sparse"`` and
  ``"sparse_cuda"`` step backends (:func:`available_backends`), and
  :func:`register_backend` for others (any object with ``name`` and
  ``expand`` resolves, :func:`supported_under`, :func:`compile_with_plan`
  and :func:`lower_with_backend` cover the hooks it lacks); the kernel
  backends carry a :class:`KernelConfig` block shape
  (:func:`resolve_kernel`);
* :mod:`.autotune` — the query planner and block autotuner the entry
  points ask when the caller leaves the backend open
  (``SystemPlan.for_system(mode="auto"|"measure")``);
* :mod:`.prng` — JAX's threefry2x32 keys, for random traces;
* :func:`explore`, :func:`successor_set`, :func:`emission_gaps`,
  :func:`run_traces`, :func:`run_trace` — the entry points
  (:mod:`.engine`), which run on the card unless ``device`` names another;
  :func:`explore` checkpoints and resumes its :class:`ExploreState`; on
  the card its level loop is one CUDA graph with no host read
  (:mod:`.graph_loop`);
* :func:`explore_distributed`, :func:`run_traces_distributed` — the
  multi-device entry points (:mod:`.distributed`): the dense-row
  hash-partitioned and the neuron-sharded BFS, and traces with the batch
  split over a mesh of devices;
* :mod:`.failover` — the degrade chain an entry point walks when a backend
  it chose itself fails (:func:`resolve_entry_info`'s ``planned`` flag);
  on the card only between the kernel backends.
"""

from .backend import (CudaBackend, RefBackend, SparseBackend,
                      SparseCudaBackend, StepBackend, available_backends,
                      compile_with_plan, get_backend, lower_with_backend,
                      register_backend, resolve_entry, resolve_entry_info,
                      resolve_kernel, supported_under, supports_sharded)
from .convert import (compiled_from_arrays, sharded_from_arrays,
                      system_from_spec)
from .generators import with_delays
from .engine import (ExploreResult, ExploreState, TraceOut, emission_gaps,
                     explore, resolve_dedup, run_trace, run_traces,
                     successor_set)
from .distributed import explore_distributed, run_traces_distributed
from .failover import (DEGRADE_ORDER, KERNEL_BACKENDS, DegradeEvent,
                       add_degrade_listener, degrade_candidates,
                       is_backend_failure, record_degradation,
                       remove_degrade_listener, run_with_failover)
from .hashtable import (HashTable, first_occurrence, insert_if_absent,
                        insert_unique, insert_unique_, lookup, make_table,
                        table_slots)
from .matrix import (CompiledSNP, CompiledSparseSNP, compile_system,
                     compile_system_sparse, is_compiled, is_delayed)
from .plan import (DenseShardArrays, KernelConfig, ShardArrays,
                   ShardedCompiled, SystemPlan, auto_hub_threshold,
                   compile_sharded, is_sharded, lower_shard_dense,
                   partition_neurons, partition_stats)
from . import autotune
from .semantics import (applicability, branch_info, delayed_branch_info,
                        delayed_next_configs, delayed_packed_actions,
                        delayed_weight_matrix, next_configs,
                        packed_rule_table, sparse_branch_info,
                        sparse_delayed_branch_info,
                        sparse_delayed_next_configs, sparse_next_configs,
                        spiking_vectors, split_state)
from .system import Rule, SNPSystem, paper_pi

__all__ = [
    "SNPSystem", "Rule", "paper_pi", "with_delays",
    "CompiledSNP", "CompiledSparseSNP", "compile_system",
    "compile_system_sparse", "is_compiled", "is_delayed",
    "SystemPlan", "KernelConfig", "autotune", "auto_hub_threshold",
    "ShardArrays", "DenseShardArrays",
    "ShardedCompiled", "compile_sharded", "is_sharded", "lower_shard_dense",
    "partition_neurons", "partition_stats",
    "system_from_spec", "compiled_from_arrays", "sharded_from_arrays",
    "HashTable", "make_table", "table_slots", "lookup", "first_occurrence",
    "insert_unique", "insert_unique_", "insert_if_absent",
    "applicability", "branch_info", "next_configs", "spiking_vectors",
    "sparse_branch_info", "packed_rule_table", "sparse_next_configs",
    "split_state", "delayed_branch_info", "sparse_delayed_branch_info",
    "delayed_weight_matrix", "delayed_packed_actions",
    "delayed_next_configs", "sparse_delayed_next_configs",
    "StepBackend", "RefBackend", "CudaBackend", "SparseBackend",
    "SparseCudaBackend", "available_backends", "get_backend",
    "resolve_kernel", "resolve_entry", "supports_sharded",
    "resolve_entry_info", "lower_with_backend", "register_backend",
    "supported_under", "compile_with_plan",
    "DEGRADE_ORDER", "KERNEL_BACKENDS", "DegradeEvent",
    "degrade_candidates", "is_backend_failure",
    "run_with_failover", "record_degradation", "add_degrade_listener",
    "remove_degrade_listener",
    "explore", "resolve_dedup", "ExploreResult", "ExploreState", "TraceOut",
    "successor_set", "emission_gaps", "run_trace", "run_traces",
    "explore_distributed", "run_traces_distributed",
]
