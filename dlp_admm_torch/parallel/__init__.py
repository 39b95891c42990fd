"""The batched and sharded drivers (port of ``dlp_admm_tpu.parallel``): the
scenario-batched consensus-OBCA step (:mod:`.consensus_spmd`), the
``(scenario, vehicle)`` mesh over ``torch.distributed`` ranks
(:mod:`.mesh`) and the multi-process entry point (:mod:`.multihost`)."""
from .consensus_spmd import (  # noqa: F401
    make_consensus_spmd_step,
    run_scenario_batch,
)
from .mesh import (  # noqa: F401
    planner_mesh,
    replicated,
    scenario_sharding,
    shard_scenarios,
    sharded_batch_step,
)
