"""Serve-path warm sets of the port (``trace`` only in this slice; serve-plan
artifacts come with the slice that ports the disk tier)."""
from .trace import TracedOp, chunk_lengths, op_label, trace_warm_set

__all__ = ["TracedOp", "chunk_lengths", "op_label", "trace_warm_set"]
