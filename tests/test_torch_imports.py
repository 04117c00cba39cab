"""The port stands alone: no file under ``src/repro_torch/`` imports JAX or
the reference package ``repro``, none imports ``triton`` at module level,
and importing the port loads neither JAX nor ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"
FILES = sorted((SRC / "repro_torch").rglob("*.py"))


def _imports(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def _top(name):
    return name.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(SRC).as_posix() for p in FILES}
    for want in ("repro_torch/core/engine.py",
                 "repro_torch/core/plan.py",
                 "repro_torch/core/prng.py",
                 "repro_torch/core/distributed.py",
                 "repro_torch/core/hashing.py",
                 "repro_torch/sharding/specs.py",
                 "repro_torch/kernels/snp_step/ops.py",
                 "repro_torch/kernels/snp_step/sparse_ops.py",
                 "repro_torch/kernels/snp_step/sparse_ref.py",
                 "repro_torch/configs/base.py",
                 "repro_torch/configs/smollm_360m.py",
                 "repro_torch/configs/smoke.py",
                 "repro_torch/data/pipeline.py",
                 "repro_torch/kernels/flash_attn/ops.py",
                 "repro_torch/kernels/flash_attn/ref.py",
                 "repro_torch/models/layers.py",
                 "repro_torch/models/transformer.py",
                 "repro_torch/models/model.py",
                 "repro_torch/models/convert.py",
                 "repro_torch/models/moe.py",
                 "repro_torch/models/mamba.py",
                 "repro_torch/models/rwkv.py",
                 "repro_torch/serve/serve_step.py",
                 "repro_torch/serve/snp_service.py",
                 "repro_torch/runtime/faults.py",
                 "repro_torch/checkpoint/checkpoint.py",
                 "repro_torch/core/failover.py",
                 "repro_torch/core/autotune.py",
                 "repro_torch/launch/serve.py",
                 "repro_torch/kernels/flash_attn/chunked.py",
                 "repro_torch/train/optimizer.py",
                 "repro_torch/train/compression.py",
                 "repro_torch/train/train_step.py",
                 "repro_torch/runtime/fault_tolerance.py",
                 "repro_torch/runtime/straggler.py",
                 "repro_torch/launch/train.py",
                 "repro_torch/launch/specs.py",
                 "repro_torch/launch/dryrun.py",
                 "repro_torch/roofline/analysis.py",
                 "repro_torch/roofline/counter.py",
                 "repro_torch/roofline/attribution.py",
                 "repro_torch/roofline/report.py",
                 "repro_torch/kernels/real.py"):
        assert want in names
    kernels = SRC / "repro_torch/kernels"
    for want in ("snp_step/csrc/snp_step_dense.cu",
                 "snp_step/csrc/snp_step_sparse.cu",
                 "flash_attn/csrc/flash_attn_fwd.cu"):
        assert (kernels / want).is_file()


def test_port_exports_the_distributed_entry_points():
    """The multi-device names: the entry points in ``repro_torch.core``,
    the plans in ``repro_torch.sharding``, the runner in
    ``repro_torch.serve``."""
    import repro_torch.core as core
    import repro_torch.serve as serve
    import repro_torch.sharding as sharding
    from repro_torch.core import distributed
    for name in ("explore_distributed", "run_traces_distributed"):
        assert name in core.__all__ and name in distributed.__all__
        assert getattr(core, name) is getattr(distributed, name)
    assert set(sharding.__all__) >= {"neuron_axis", "trace_mesh"}
    assert "make_trace_runner" in serve.__all__


def test_port_exports_the_training_names():
    """The reference's training names under the same packages."""
    import repro_torch.models as models
    import repro_torch.runtime as runtime
    import repro_torch.train as train
    from repro_torch.kernels import flash_attn
    for name in ("AdamWConfig", "adamw_init", "adamw_update",
                 "make_schedule", "TrainState", "init_train_state",
                 "make_train_step"):
        assert name in train.__all__ and hasattr(train, name)
    for name in ("FailureInjector", "Supervisor", "SupervisorConfig",
                 "StragglerConfig", "StragglerDetector",
                 "rebalance_shares"):
        assert name in runtime.__all__ and hasattr(runtime, name)
    assert "loss_fn" in models.__all__
    assert "chunked_attention" in flash_attn.__all__


def test_port_exports_the_roofline_names():
    """The reference's roofline and dry-run names (``analyze_step`` in
    ``analyze_compiled``'s place, the counter in the HLO analyzer's)."""
    import repro_torch.launch.dryrun as dryrun
    import repro_torch.launch.specs as specs
    import repro_torch.roofline as roofline
    for name in ("HW", "CollectiveStats", "roofline_terms", "analyze_step",
                 "StepCounter"):
        assert name in roofline.__all__ and hasattr(roofline, name)
    for name in ("input_specs", "decode_input_specs", "abstract_params",
                 "abstract_train_state", "abstract_cache"):
        assert name in specs.__all__ and hasattr(specs, name)
    for name in ("TRAIN_KNOBS", "run_cell", "run_snp_cell", "main"):
        assert name in dryrun.__all__ and hasattr(dryrun, name)


# The reference's subpackages, and the public names of theirs the port
# has no counterpart for: Pallas kernels and backends (CUDA sources and
# backends take their places) and the HLO analyzer's (the step counter
# takes its place).
PACKAGES = sorted(p.parent.relative_to(SRC).as_posix().replace("/", ".")
                  for p in (SRC / "repro").rglob("__init__.py"))
NOT_PORTED = {"PallasBackend", "SparsePallasBackend", "snp_step_pallas",
              "snp_step_sparse_pallas", "flash_attention_pallas",
              "analyze_compiled", "parse_collectives"}


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_every_reference_name(package):
    """Each name in a reference subpackage's ``__all__`` is in the port's
    subpackage of the same path, and bound there."""
    import importlib

    ref = importlib.import_module(package)
    port = importlib.import_module("repro_torch" + package[len("repro"):])
    want = set(getattr(ref, "__all__", ())) - NOT_PORTED
    have = set(getattr(port, "__all__", ()))
    assert want <= have, sorted(want - have)
    for name in want:
        assert hasattr(port, name), name


def test_launch_exports_make_production_mesh():
    from repro_torch.launch import make_production_mesh
    from repro_torch.launch.mesh import make_production_mesh as defined
    assert make_production_mesh is defined


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(SRC)
                         .as_posix())
def test_no_jax_repro_or_module_level_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        for name in _imports(node):
            assert _top(name) not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"
    for node in tree.body:
        for name in _imports(node):
            assert _top(name) != "triton", \
                f"{path.name} imports triton at module level"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.snp_step.ops, chip_smoke\n"
        "import repro_torch.kernels.snp_step.sparse_ops\n"
        "import repro_torch.core.plan, repro_torch.core.prng\n"
        "import repro_torch.core.distributed, repro_torch.sharding.specs\n"
        "from repro_torch.core import (explore_distributed,\n"
        "                              run_traces_distributed)\n"
        "from repro_torch.sharding import neuron_axis, trace_mesh\n"
        "from repro_torch.serve import make_trace_runner\n"
        "import repro_torch.configs, repro_torch.data, repro_torch.models\n"
        "import repro_torch.models.moe, repro_torch.models.mamba\n"
        "import repro_torch.models.rwkv\n"
        "import repro_torch.kernels.flash_attn.ops, repro_torch.serve\n"
        "import repro_torch.launch.serve, repro_torch.runtime\n"
        "import repro_torch.checkpoint, repro_torch.core.failover\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "import repro_torch.kernels.flash_attn.chunked\n"
        "from repro_torch.models import loss_fn, train_state_from_jax\n"
        "from repro_torch.runtime import (Supervisor, SupervisorConfig,\n"
        "    FailureInjector, StragglerDetector, rebalance_shares)\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "import repro_torch.roofline, repro_torch.roofline.report\n"
        "import repro_torch.roofline.attribution, repro_torch.kernels.real\n"
        "repro_torch.configs.get_config('smollm-360m')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n")
    root = SRC.parent
    env = {**os.environ, "PYTHONPATH": f"{SRC}:{root}"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
