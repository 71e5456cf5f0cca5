"""Utilities: per-op counts and host spans."""

from csgn_tpu_torch.utils.metrics import OpMetrics, op_metrics

__all__ = ["OpMetrics", "op_metrics"]
