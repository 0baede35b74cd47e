"""Configuration dataclasses.

Port of dynfu_tpu/engine/params.py: the same fields with the same defaults,
so that a JAX engine's configuration converts field by field
(utils/convert.py). The reasons behind each default and each capacity preset
are documented at the source. Some fields serve paths not ported yet (the
rigid ICP settings, fusion_camera_tracking); they are carried for that
conversion, and the engine raises where one would be needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from dynfu_tpu_torch.core.camera import Intr


def _deg2rad(a: float) -> float:
    return a * 0.017453293


@dataclasses.dataclass(frozen=True)
class KinFuParams:
    cols: int = 640
    rows: int = 480
    intr: Intr = Intr(525.0, 525.0, 640 / 2 - 0.5, 480 / 2 - 0.5)

    volume_dims: Tuple[int, int, int] = (512, 512, 512)
    volume_size: Tuple[float, float, float] = (3.0, 3.0, 3.0)  # meters
    volume_pose_t: Tuple[float, float, float] = (-1.5, -1.5, 0.5)

    bilateral_sigma_depth: float = 0.04  # meters
    bilateral_sigma_spatial: float = 4.5  # pixels
    bilateral_kernel_size: int = 7  # pixels

    icp_truncate_depth_dist: float = 0.0  # meters, disabled
    icp_dist_thres: float = 0.1  # meters
    icp_angle_thres: float = _deg2rad(30.0)
    icp_iter_num: Tuple[int, ...] = (10, 5, 4, 0)
    icp_assoc: str = "stencil"
    icp_stencil_radii: Tuple[int, ...] = (2, 3, 4, 6)

    tsdf_min_camera_movement: float = 0.0  # meters, disabled
    tsdf_trunc_dist: float = 0.04  # meters
    tsdf_max_weight: int = 64  # frames

    raycast_step_factor: float = 0.75  # in voxel sizes
    gradient_delta_factor: float = 0.5  # in voxel sizes

    light_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    raycast_mode: str = "auto"
    fused_frame: bool = True

    @staticmethod
    def default_params() -> "KinFuParams":
        return KinFuParams()

    def with_volume_dims(self, d: int) -> "KinFuParams":
        return dataclasses.replace(self, volume_dims=(d, d, d))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Non-rigid GN schedule (dyn_fusion.cpp:183-189)."""

    num_iter: int = 24
    nonlinear_iter: int = 16
    linear_iter: int = 256
    early_out: bool = True
    lm_lambda_init: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DynFuParams:
    kinfu: KinFuParams = dataclasses.field(
        default_factory=lambda: KinFuParams().with_volume_dims(128))

    tukey_offset: float = 4.652
    lambda_reg: float = 200.0
    psi_data: float = 0.01
    psi_reg: float = 1e-4
    L: int = 4
    beta: float = 4.0
    epsilon: float = 0.1

    knn: int = 8
    node_sample_step: int = 128
    new_node_dg_w_factor: float = 2.0
    init_node_dg_w_factor: float = 3.0
    node_voxel_leaf: float = 0.05

    solver: SolverParams = dataclasses.field(default_factory=SolverParams)

    # static capacities: every buffer is paid for in each op that reads it;
    # the overflow counters (FrameStats) are the undersizing signal
    max_nodes: int = 1024
    max_vertices: int = 1 << 16
    max_triangles: int = 2 << 20
    max_mc_voxels: int = 1 << 14
    mc_col_budget: int = 0
    max_new_nodes: int = 256
    corr_escalate: int = 16384
    corr_window_blocks: int = 1
    corr_rescue: int = 4096
    corr_unique_edges: bool = False
    fg_aabb: tuple | None = None
    max_fg_verts: int = 0
    max_edge_verts: int = 0
    edge_col_budget: int = 0

    fusion_corr_dist: float = 0.10
    fusion_max_active: int = 1 << 19
    fusion_col_budget: int = 0
    fusion_dilate: int = 2
    fusion_min_cos: float = 0.25
    solver_rotations: bool = False
    se3_relinearize: int = 3
    se3_similarity_reg: bool = False
    fusion_warmup_frames: int = 0
    se3_trans_prior: float = 0.0
    se3_rot_prior: float = 0.03
    fusion_camera_tracking: bool = False
    fusion_min_update_vox: float = 0.1

    @staticmethod
    def default_params() -> "DynFuParams":
        return DynFuParams()

    @staticmethod
    def caps_for_volume(volume_dims: int, fusion: bool = False) -> dict:
        """Capacity preset for a cubic volume resolution (the presets and
        their measured rationale: dynfu_tpu/engine/params.py)."""
        if volume_dims >= 384:
            step = 512 if (fusion and volume_dims >= 448) else 256
            caps = dict(max_vertices=1 << 18,
                        max_mc_voxels=(1 << 16) if fusion else 49152,
                        max_nodes=1024, max_new_nodes=512,
                        node_sample_step=step)
            if not fusion:
                caps["corr_unique_edges"] = True
                caps["max_edge_verts"] = 49152
                caps["corr_escalate"] = 8192
                caps["corr_rescue"] = 2048
            caps["edge_col_budget"] = 8
            if fusion:
                caps["max_nodes"] = 640
                caps["max_new_nodes"] = 256
                caps["fusion_max_active"] = 1 << 19
                caps["fusion_col_budget"] = 128
                caps["corr_unique_edges"] = True
                caps["max_edge_verts"] = 1 << 16
                caps["se3_rot_prior"] = 0.3
                caps["se3_relinearize"] = 1
            return caps
        if volume_dims >= 192:
            return dict(max_vertices=1 << 16, max_mc_voxels=1 << 14,
                        max_nodes=512, max_new_nodes=256,
                        corr_escalate=8192, corr_rescue=2048)
        return dict(max_vertices=1 << 15, max_mc_voxels=1 << 13,
                    max_nodes=256, max_new_nodes=128,
                    corr_escalate=4096, corr_rescue=1024)


def w_reg(lambda_reg: float, D: int, knn: int) -> float:
    """Per-term regularisation weight sqrt(lambda / (D * KNN))."""
    return math.sqrt(lambda_reg / (D * knn))
