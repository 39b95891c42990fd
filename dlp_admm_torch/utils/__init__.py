"""Run metrics (port of ``dlp_admm_tpu.utils``)."""
