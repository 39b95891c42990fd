"""Planners (port of ``dlp_admm_tpu.models``); so far the consensus-OBCA
flagship, :class:`.obca.ConsensusObcaPlanner`."""
