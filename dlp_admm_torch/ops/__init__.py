"""Geometry, dynamics and pair indexing (port of ``dlp_admm_tpu.ops``)."""
