"""Planners (port of ``dlp_admm_tpu.models``); so far the OBCA planners,
:class:`.obca.CentralizedObcaPlanner` and the consensus-OBCA flagship
:class:`.obca.ConsensusObcaPlanner`, and the PI-ADMM engine in its classic
and pairwise layouts, :class:`.pi_admm.PiAdmmEngine`."""
