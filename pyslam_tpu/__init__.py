"""pyslam_tpu — a JAX nonlinear least-squares SLAM framework for accelerators.

Built from scratch with the capabilities of ``utiasSTARS/pyslam`` (+ its
``liegroups`` dependency), re-designed device-first per SURVEY.md:

  * ``lie``       — SE2/SE3/SO2/SO3 functional cores + object wrappers (L0)
  * ``utils``     — invsqrt / stackmul / bilinear_interpolate (L1)
  * ``sensors``   — StereoCamera / RGBDCamera with analytic Jacobians (L2)
  * ``losses``    — robust M-estimators for IRLS (L3)
  * ``residuals`` — residual library with analytic Jacobians (L4a)
  * ``problem``   — Options / Problem Ceres-style solver API (L4b)
  * ``graph``     — struct-of-arrays factor batches (the device-side core)
  * ``solver``    — GN/LM under jit, block-sparse assembly, Schur, PCG
  * ``dist``      — multi-device/multi-host sharding (mesh, partitioner)
  * ``pipelines`` — dense stereo / RGB-D visual odometry frontends (L5)
  * ``eval``      — TrajectoryMetrics / visualizers (L6)
  * ``io``        — g2o / BAL readers, synthetic dataset generators
"""

__version__ = "0.1.0"

import jax as _jax

# On the H100, XLA may run float32 matrix products in TF32 on the tensor
# cores, which keeps about three decimal digits (~1e-3 relative error) in
# pose composition and normal-equation products — fatal for a nonlinear
# least-squares solver (SURVEY.md §7 hard part #1).  "highest" keeps float32
# products in float32; chip_smoke.py's precision phase checks that it takes
# effect on the card.  Kernels that can tolerate less request it explicitly.
# Override after import with
# jax.config.update("jax_default_matmul_precision", ...) if desired.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import eval, graph, imu, io, lie, losses, pipelines, residuals, sensors, solver, utils  # noqa: F401
from .lie import SE2, SE3, SO2, SO3, Sim3  # noqa: F401
from .problem import Options, Problem  # noqa: F401
from .residuals import (  # noqa: F401
    BearingRangeResidual,
    LandmarkXYResidual,
    PoseResidual,
    PoseToPoseResidual,
    PoseToPoseSwitchableResidual,
    QuadraticResidual,
    ReprojectionMotionOnlyBatchResidual,
    ReprojectionResidual,
)
from .losses import (  # noqa: F401
    CauchyLoss,
    HuberLoss,
    L1Loss,
    L2Loss,
    TDistributionLoss,
    TukeyLoss,
)
from .sensors import RGBDCamera, StereoCamera  # noqa: F401
from .eval import TrajectoryMetrics, TrajectoryVisualizer  # noqa: F401
from . import observability  # noqa: F401
