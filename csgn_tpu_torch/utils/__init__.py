"""Utilities: per-op metrics and profiler ranges."""

from csgn_tpu_torch.utils.metrics import OpMetrics, op_metrics, trace

__all__ = ["OpMetrics", "op_metrics", "trace"]
