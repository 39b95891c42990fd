"""The batched drivers (port of ``dlp_admm_tpu.parallel``); so far the
scenario-batched consensus-OBCA step on one device,
:mod:`.consensus_spmd`."""
