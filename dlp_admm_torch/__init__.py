"""dlp_admm_torch: the PyTorch/CUDA port of ``dlp_admm_tpu``.

The JAX package ``dlp_admm_tpu`` is the reference; this package mirrors its
module names (``config``, ``scenarios``, ``ops``, ``coordination``,
``solvers``, ``models``, ``utils``, ``mpc``, ``parallel``) and imports
``torch``, never ``jax``. It carries every planner of the JAX package: the
consensus-OBCA flagship (``models.obca.ConsensusObcaPlanner``,
``mpc.run_obca(Formulation.CONSENSUS)``) in float64 and float32 with the
planner modes of its staged and dense interior-point solvers
(``solvers.ip_staged``, ``solvers.ip``), its scenario-batched driver on one
device (``parallel.consensus_spmd.run_scenario_batch``) and with the vehicle
axis over ``torch.distributed`` ranks (``parallel.mesh``,
``parallel.multihost``), the centralized
joint OBCA planner (``models.obca.CentralizedObcaPlanner``), the bilevel
and tightening planners (``models.bilevel``), the PI-ADMM engine in its
classic and pairwise layouts (``models.pi_admm``, ``mpc.run_pi_admm``) and
the ALADIN coordinator (``models.aladin``,
``run_pi_admm(layout="aladin")``), with the JAX package's utilities
(``utils``: checkpoint/resume of every planner's carry, the native trace
stream, the profiler context, plots). The block-tridiagonal KKT solve of
the staged solver is hand-written CUDA (``csrc/block_thomas_warp.cu``,
``csrc/block_thomas_wide.cu``, ``csrc/block_thomas_cluster.cu``,
``csrc/block_thomas_big.cu``). Its entry
points run on the CUDA card unless the caller names another device.

Importing the package turns TF32 off for float32 matmuls and convolutions,
the counterpart of ``dlp_admm_tpu/__init__.py`` forcing full-float32 matmul
precision: reduced-precision products corrupt the solvers' near-singular KKT
systems.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import config, scenarios  # noqa: F401,E402
from .config import (  # noqa: F401,E402
    DualStrategy,
    DualUpdateConfig,
    Formulation,
    ObcaConfig,
    PiAdmmConfig,
    SolverConfig,
    VehicleConfig,
    WindupMode,
)

__version__ = "0.1.0"
