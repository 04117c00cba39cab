"""Serving (the port of the JAX package's ``repro.serve``): LM
prefill/decode steps and the SNP trace runner, :mod:`.serve_step`.  The
batched SNP trace service is not ported yet (ROADMAP item 6)."""

from .serve_step import (make_decode_step, make_prefill_step,
                         make_trace_runner, sample_token)

__all__ = ["make_prefill_step", "make_decode_step", "sample_token",
           "make_trace_runner"]
