"""Builders: dataset containers -> FactorGraph.

These produce the struct-of-arrays graphs the solver consumes, from the
synthetic generators (io/synth.py), the g2o/BAL readers (io/g2o.py, io/bal.py)
or user arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..losses import L2Loss
from ..sensors import StereoCamera
from .core import FactorBatch, FactorGraph, VariableBlock


def pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=jnp.float32,
    init: str = "odometry",
) -> FactorGraph:
    """Build a pose-graph FactorGraph from PoseGraphData (2D or 3D).

    ``anchor_first`` freezes pose 0 (gauge fixing — the reference's
    set_parameters_constant pattern).  ``init`` selects 'odometry'
    (integrated measurements, the standard benchmark init), 'gt',
    'spanning_tree' (BFS measurement integration — for datasets with no
    vertex estimates), or 'chordal' (two-stage linear relaxation,
    graph/initialize.py — closest to the optimum's basin; costs two linear
    solves).
    """
    loss = loss if loss is not None else L2Loss()
    if data.dim == 3 and data.sqrt_info.shape[-1] == 7:
        # Sim(3) graphs (7-dof edges, e.g. EDGE_SIM3:QUAT files) route to
        # the similarity builder; 'chordal'/'spanning_tree' inits are
        # SE-only constructions — raise rather than silently downgrade
        if init in ("chordal", "spanning_tree"):
            raise ValueError(
                f"init={init!r} is not implemented for Sim(3) graphs; use "
                "'odometry' (default) or 'gt'"
            )
        return sim3_pose_graph(
            data, loss=loss, anchor_first=anchor_first, dtype=dtype, init=init
        )
    kind = "se2" if data.dim == 2 else "se3"
    n_poses = data.T_init.shape[0]
    if init == "chordal":
        from .initialize import chordal_init

        T0 = chordal_init(data.edges_i, data.edges_j, data.T_meas, n_poses)
    elif init == "spanning_tree":
        from .initialize import spanning_tree_init

        T0 = spanning_tree_init(data.edges_i, data.edges_j, data.T_meas, n_poses)
    elif init == "gt":
        T0 = data.T_gt
    else:
        T0 = data.T_init
    n = T0.shape[0]
    const = np.zeros(n, bool)
    if anchor_first:
        const[0] = True
    blocks = {"poses": VariableBlock.create(kind, jnp.asarray(T0, dtype), const)}
    batch = FactorBatch.create(
        kind=f"between_{kind}",
        slots=("poses", "poses"),
        indices=(data.edges_i, data.edges_j),
        data={
            "T_obs": jnp.asarray(data.T_meas, dtype),
            "sqrt_info": jnp.asarray(data.sqrt_info, dtype),
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])


def switchable_pose_graph(
    data,
    loss=None,
    anchor_first: bool = True,
    dtype=jnp.float32,
    init: str = "odometry",
    xi=5.0,
    loop_mask=None,
    s_init=None,
) -> FactorGraph:
    """Pose graph with SWITCHABLE loop closures (Suenderhauf & Protzel
    ICRA 2012): odometry edges stay plain between factors; each loop edge
    gets a scalar switch variable (block "switches", init 1.0) through the
    ``between_*_switch`` kernel, whose xi-weighted prior row lets wrong
    loop closures turn themselves off during optimization.  Beyond-
    reference; the weight-based alternative is solver/gnc.solve_gnc.

    ``xi`` sets the switch prior stiffness: too small and correct loops
    switch off before the drifted odometry init corrects (measured: xi=2
    kills inliers on a 60-pose loop, xi=5 separates cleanly — inliers
    >0.94, outliers <0.01; tests/test_switchable.py); too large and
    outliers stay half-on.

    ``xi`` and ``s_init`` may be per-loop-edge arrays — e.g. straight from
    ``io.g2o.read_g2o_switchable`` (Vertigo dataset files):
    ``build.switchable_pose_graph(data, **sw)``.

    ``loop_mask``: boolean (E,) marking which edges are loop closures;
    defaults to non-consecutive edges (|i - j| != 1).  Read the converged
    switch values from ``solved.blocks["switches"].values[:, 0]`` — near 0
    means the edge was rejected.  Solve with ``solver.solve`` (dense path;
    2-block graphs with 3-slot factors are outside the Schur routes)."""
    loss = loss if loss is not None else L2Loss()
    kind = "se2" if data.dim == 2 else "se3"
    T0 = data.T_gt if init == "gt" else data.T_init
    n = T0.shape[0]
    const = np.zeros(n, bool)
    if anchor_first:
        const[0] = True
    ei = np.asarray(data.edges_i)
    ej = np.asarray(data.edges_j)
    if loop_mask is None:
        loop_mask = np.abs(ei - ej) != 1
    loop_mask = np.asarray(loop_mask, bool)
    odo = ~loop_mask
    n_loops = int(loop_mask.sum())
    if s_init is None or n_loops == 0:
        # n_loops == 0: the (padded) placeholder switch slot ignores any
        # (0,)-shaped s_init from read_g2o_switchable on a loop-free file
        s0 = np.ones((max(n_loops, 1), 1))
    else:
        s0 = np.broadcast_to(
            np.asarray(s_init, np.float64).reshape(-1, 1), (n_loops, 1)
        )
    blocks = {
        "poses": VariableBlock.create(kind, jnp.asarray(T0, dtype), const),
        "switches": VariableBlock.create("euclidean", jnp.asarray(s0, dtype)),
    }
    batches = [
        FactorBatch.create(
            kind=f"between_{kind}",
            slots=("poses", "poses"),
            indices=(ei[odo], ej[odo]),
            data={
                "T_obs": jnp.asarray(np.asarray(data.T_meas)[odo], dtype),
                "sqrt_info": jnp.asarray(np.asarray(data.sqrt_info)[odo], dtype),
            },
            loss=loss,
        ),
        FactorBatch.create(
            kind=f"between_{kind}_switch",
            slots=("poses", "poses", "switches"),
            indices=(
                ei[loop_mask],
                ej[loop_mask],
                np.arange(n_loops, dtype=np.int32),
            ),
            data={
                "T_obs": jnp.asarray(np.asarray(data.T_meas)[loop_mask], dtype),
                "sqrt_info": jnp.asarray(
                    np.asarray(data.sqrt_info)[loop_mask], dtype
                ),
                "xi": jnp.asarray(
                    np.broadcast_to(np.asarray(xi, np.float64), (n_loops,)),
                    dtype,
                ),
            },
            loss=loss,
        ),
    ]
    return FactorGraph(blocks, batches)


def sim3_pose_graph(
    data, loss=None, anchor_first: bool = True, dtype=jnp.float32, init: str = "odometry"
) -> FactorGraph:
    """Build a Sim(3) pose-graph FactorGraph (scale-drift-aware monocular
    loop closure — beyond-reference; see lie/sim3.py and synth.sim3_loop).

    ``data`` is PoseGraphData whose (N, 4, 4) matrices are Sim(3)
    ``[[s*R, t], [0, 1]]`` and whose sqrt_info is (E, 7, 7)."""
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_gt if init == "gt" else data.T_init
    n = T0.shape[0]
    const = np.zeros(n, bool)
    if anchor_first:
        const[0] = True
    blocks = {"poses": VariableBlock.create("sim3", jnp.asarray(T0, dtype), const)}
    batch = FactorBatch.create(
        kind="between_sim3",
        slots=("poses", "poses"),
        indices=(data.edges_i, data.edges_j),
        data={
            "T_obs": jnp.asarray(data.T_meas, dtype),
            "sqrt_info": jnp.asarray(data.sqrt_info, dtype),
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])


def landmark_slam_2d(
    data, loss=None, anchor_first: bool = True, dtype=jnp.float32, init: str = "noisy"
) -> FactorGraph:
    """Build a 2D landmark-SLAM FactorGraph from synth.LandmarkSLAM2DData
    (or io.g2o landmark files): SE(2) poses + 2-dof euclidean landmarks,
    odometry between factors + bearing-range / relative-position landmark
    observations.  solve_auto routes this shape through the dof-generic
    Schur paths (solver/schur.py)."""
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_init if init == "noisy" else data.T_gt
    l0 = data.lm_init if init == "noisy" else data.lm_gt
    n = T0.shape[0]
    const = np.zeros(n, bool)
    if anchor_first:
        const[0] = True
    blocks = {
        "poses": VariableBlock.create("se2", jnp.asarray(T0, dtype), const),
        "landmarks": VariableBlock.create("euclidean", jnp.asarray(l0, dtype)),
    }
    kind = "bearing_range_se2" if data.obs_type == "bearing_range" else "landmark_xy_se2"
    batches = [
        FactorBatch.create(
            kind=kind,
            slots=("poses", "landmarks"),
            indices=(data.obs_pose, data.obs_lm),
            data={
                "obs": jnp.asarray(data.obs, dtype),
                "sqrt_info": jnp.asarray(data.obs_sqrt_info, dtype),
            },
            loss=loss,
        )
    ]
    if len(data.edges_i):
        batches.append(
            FactorBatch.create(
                kind="between_se2",
                slots=("poses", "poses"),
                indices=(data.edges_i, data.edges_j),
                data={
                    "T_obs": jnp.asarray(data.T_meas, dtype),
                    "sqrt_info": jnp.asarray(data.sqrt_info, dtype),
                },
                loss=loss,
            )
        )
    return FactorGraph(blocks, batches)


def ba_graph(data, loss=None, dtype=jnp.float32, init: str = "noisy") -> FactorGraph:
    """Build a bundle-adjustment FactorGraph from BAData: SE(3) camera poses
    + Euclidean landmarks + stereo reprojection factors."""
    loss = loss if loss is not None else L2Loss()
    T0 = data.T_init if init == "noisy" else data.T_gt
    p0 = data.pts_init if init == "noisy" else data.pts_gt
    n_cams = T0.shape[0]
    const = np.zeros(n_cams, bool)
    const[0] = True  # gauge anchor
    cam = StereoCamera(**{k: v for k, v in data.camera.items()})
    # unbatched (3,3): broadcasts in the kernels; no (M,3,3) copy
    sqrt_info = jnp.eye(3, dtype=dtype)
    blocks = {
        "poses": VariableBlock.create("se3", jnp.asarray(T0, dtype), const),
        "landmarks": VariableBlock.create("euclidean", jnp.asarray(p0, dtype)),
    }
    batch = FactorBatch.create(
        kind="reprojection",
        slots=("poses", "landmarks"),
        indices=(data.cam_idx, data.pt_idx),
        data={
            "obs": jnp.asarray(data.obs, dtype),
            "sqrt_info": sqrt_info,
            "camera": cam,
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])


def bal_graph(
    data,
    loss=None,
    pixel_std=1.0,
    anchor_first=True,
    dtype=jnp.float32,
    optimize_intrinsics: bool = False,
) -> FactorGraph:
    """Build a monocular BA FactorGraph from io.bal.BALData (Snavely camera
    model — BASELINE.json configs #4/#5).

    ``optimize_intrinsics=False`` (default) holds [f, k1, k2] fixed at the
    file values (the benchmark configs).  ``True`` builds the REAL BAL
    problem: 9-dof cameras with intrinsics optimized jointly, as one
    bal_cam9 product-manifold block so every Schur path applies
    (graph/core.py _retract_bal_cam9)."""
    loss = loss if loss is not None else L2Loss()
    n_cams = data.T.shape[0]
    const = np.zeros(n_cams, bool)
    if anchor_first:
        const[0] = True
    m = len(data.cam_idx)
    sqrt_info = jnp.eye(2, dtype=dtype) / pixel_std
    blocks = {
        "landmarks": VariableBlock.create("euclidean", jnp.asarray(data.pts, dtype)),
    }
    if optimize_intrinsics:
        packed = np.concatenate(
            [data.T.reshape(n_cams, 16), np.asarray(data.intrinsics)], axis=1
        )
        # gauge fixing must pin only the POSE dofs of camera 0: a const
        # mask would freeze the whole 9-dof block and pin the anchor
        # camera's intrinsics at their initial values — so the anchor is a
        # stiff pose-only prior instead (prior_balcam_pose)
        blocks["poses"] = VariableBlock.create("bal_cam9", jnp.asarray(packed, dtype))
        batches = [
            FactorBatch.create(
                kind="reprojection_bal9",
                slots=("poses", "landmarks"),
                indices=(data.cam_idx, data.pt_idx),
                data={"obs": jnp.asarray(data.obs, dtype), "sqrt_info": sqrt_info},
                loss=loss,
            )
        ]
        if anchor_first:
            batches.append(
                FactorBatch.create(
                    kind="prior_balcam_pose",
                    slots=("poses",),
                    indices=(np.zeros(1, np.int32),),
                    data={
                        "T_obs": jnp.asarray(data.T[:1], dtype),
                        "sqrt_info": jnp.asarray(np.eye(6)[None] * 1e6, dtype),
                    },
                    loss=L2Loss(),
                )
            )
        return FactorGraph(blocks, batches)
    intr = jnp.asarray(data.intrinsics, dtype)[data.cam_idx]
    blocks["poses"] = VariableBlock.create("se3", jnp.asarray(data.T, dtype), const)
    batch = FactorBatch.create(
        kind="reprojection_bal",
        slots=("poses", "landmarks"),
        indices=(data.cam_idx, data.pt_idx),
        data={
            "obs": jnp.asarray(data.obs, dtype),
            "sqrt_info": sqrt_info,
            "f": intr[:, 0],
            "k1": intr[:, 1],
            "k2": intr[:, 2],
        },
        loss=loss,
    )
    return FactorGraph(blocks, [batch])
