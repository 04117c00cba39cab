"""Runtime of the port: the failure-domain primitives of SNP serving and
exploration (:mod:`.faults`), the training supervisor
(:mod:`.fault_tolerance`), the straggler policy (:mod:`.straggler`) and
elastic re-meshing (:mod:`.elastic`)."""

from .elastic import build_mesh, choose_mesh_shape, join_group, world_size
from .fault_tolerance import FailureInjector, Supervisor, SupervisorConfig
from .faults import (AdmissionRejected, DeadlineExceeded, FaultInjector,
                     FaultPolicy, InjectedFault, PoisonError, run_supervised)
from .straggler import StragglerConfig, StragglerDetector, rebalance_shares

__all__ = ["FailureInjector", "Supervisor", "SupervisorConfig",
           "FaultPolicy", "FaultInjector", "InjectedFault", "PoisonError",
           "DeadlineExceeded", "AdmissionRejected", "run_supervised",
           "StragglerConfig", "StragglerDetector", "rebalance_shares",
           "build_mesh", "choose_mesh_shape", "join_group", "world_size"]
