"""Receding-horizon driver (port of ``dlp_admm_tpu.mpc``)."""
from .driver import RunResult, run_obca  # noqa: F401
