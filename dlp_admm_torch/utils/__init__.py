"""Auxiliary subsystems (port of ``dlp_admm_tpu.utils``): metrics, the
native trace stream, checkpointing, plotting."""
from .checkpoint import load_carry, save_carry  # noqa: F401
from .metrics import RunMetrics, trace  # noqa: F401
from .plotting import plot_iteration_history, plot_trajectories  # noqa: F401
from .tracelog import TraceLog, native_available, read_tracelog  # noqa: F401
