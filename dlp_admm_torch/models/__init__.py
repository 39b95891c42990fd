"""Planners (port of ``dlp_admm_tpu.models``); so far the consensus-OBCA
flagship, :class:`.obca.ConsensusObcaPlanner`, and the pairwise PI-ADMM
engine, :class:`.pi_admm.PiAdmmEngine`."""
