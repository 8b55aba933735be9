"""Auxiliary subsystems: config, profiling, metrics, checkpoint, checks.

The reference has none of these (SURVEY.md §5: no timers, no logging, no
serialization, no sanitizers anywhere in the repo); this package supplies the
production surface a deployment needs around the tracing kernels.
"""

from .config import HareConfig
from .profiling import timed, trace_profile
from .metrics import MetricsLogger, trace_metrics
from .checkpoint import restore_state, save_state, latest_step
from .checks import determinism_check, enable_debug_checks
from .runtime import require_gpu, setup_compile_cache

__all__ = [
    "HareConfig",
    "MetricsLogger",
    "determinism_check",
    "enable_debug_checks",
    "latest_step",
    "require_gpu",
    "restore_state",
    "save_state",
    "setup_compile_cache",
    "timed",
    "trace_metrics",
    "trace_profile",
]
