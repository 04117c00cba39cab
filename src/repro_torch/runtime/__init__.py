"""Runtime of the port: the failure-domain primitives of SNP serving and
exploration (:mod:`.faults`), the training supervisor
(:mod:`.fault_tolerance`) and the straggler policy (:mod:`.straggler`)."""

from .fault_tolerance import FailureInjector, Supervisor, SupervisorConfig
from .faults import (AdmissionRejected, DeadlineExceeded, FaultInjector,
                     FaultPolicy, InjectedFault, PoisonError, run_supervised)
from .straggler import StragglerConfig, StragglerDetector, rebalance_shares

__all__ = ["FailureInjector", "Supervisor", "SupervisorConfig",
           "FaultPolicy", "FaultInjector", "InjectedFault", "PoisonError",
           "DeadlineExceeded", "AdmissionRejected", "run_supervised",
           "StragglerConfig", "StragglerDetector", "rebalance_shares"]
