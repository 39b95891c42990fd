"""Planners (port of ``dlp_admm_tpu.models``): the OBCA planners
(:class:`.obca.CentralizedObcaPlanner`, the consensus-OBCA flagship
:class:`.obca.ConsensusObcaPlanner`, and the fixed-dual family of
:mod:`.bilevel`), the PI-ADMM engine in its classic and pairwise layouts
(:class:`.pi_admm.PiAdmmEngine`) and the ALADIN coordinator
(:mod:`.aladin`)."""
from .aladin import (  # noqa: F401
    AladinEngine,
    AladinProblem,
    AladinState,
    AladinUnicyclePlanner,
)
from .bilevel import (  # noqa: F401
    BilevelObcaPlanner,
    FixedDualState,
    TighteningObcaPlanner,
    TighteningSlackObcaPlanner,
    solve_collision_duals,
)
from .obca import (  # noqa: F401
    BarState,
    CentralizedObcaPlanner,
    ConsensusObcaPlanner,
)
from .pi_admm import PiAdmmEngine, StepRecord  # noqa: F401
