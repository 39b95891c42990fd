"""Dual-update strategies and ADMM residuals (port of
``dlp_admm_tpu.coordination``)."""
