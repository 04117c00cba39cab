"""Serving (the port of the JAX package's ``repro.serve``): LM
prefill/decode steps and the SNP trace runner (:mod:`.serve_step`), and
the batched SNP trace service with its failure domains
(:mod:`.snp_service`)."""

from .serve_step import (make_decode_step, make_prefill_step,
                         make_trace_runner, sample_token)
from .snp_service import SNPTraceService, TraceRequest, TraceResult

__all__ = ["make_prefill_step", "make_decode_step", "sample_token",
           "make_trace_runner", "SNPTraceService", "TraceRequest",
           "TraceResult"]
