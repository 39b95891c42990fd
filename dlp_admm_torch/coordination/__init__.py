"""Dual-update strategies (port of ``dlp_admm_tpu.coordination``)."""
