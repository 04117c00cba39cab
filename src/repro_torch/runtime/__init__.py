"""Runtime of the port: the failure-domain primitives of SNP serving and
exploration (:mod:`.faults`)."""

from .faults import (AdmissionRejected, DeadlineExceeded, FaultInjector,
                     FaultPolicy, InjectedFault, PoisonError, run_supervised)

__all__ = ["FaultPolicy", "FaultInjector", "InjectedFault", "PoisonError",
           "DeadlineExceeded", "AdmissionRejected", "run_supervised"]
