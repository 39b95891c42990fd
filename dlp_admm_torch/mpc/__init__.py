"""Receding-horizon driver (port of ``dlp_admm_tpu.mpc``)."""
from .driver import RunResult, run_obca, run_pi_admm  # noqa: F401
