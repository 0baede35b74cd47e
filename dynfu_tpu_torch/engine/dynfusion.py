"""DynamicFusion orchestrator: the non-rigid frame loop, parity and fusion
modes.

Port of the parity and fusion modes of dynfu_tpu/engine/dynfusion.py (the
reference's DynFusion::operator(), dyn_fusion.cpp:48-144). Parity mode:

  frame 0: dists, bilateral -> integrate -> marching cubes -> canonical
    (triangle soup; normals are a placeholder copy of the vertices, the
    reference's workaround) -> every 128th soup vertex becomes a node ->
    one host dedup of the canonical soup.
  frame k: pose stays identity -> dists -> clear + integrate -> marching
    cubes (or, with corr_unique_edges, the unique isosurface edge vertices;
    the soup is then extracted on demand by mesh()) -> warp the canonical
    with the current field -> 1-NN correspondence (live vertex -> warped
    canonical vertex), fetching the solve's data graph with it -> GN solve
    -> node insertion.

Fusion mode (the persistent canonical volume of Newcombe et al. 3.3, which
the reference's clear + re-integrate stands in for):

  frame 0: integrate -> marching cubes soup (corner convention) -> every
    node_sample_step-th soup vertex becomes a node -> the canonical becomes
    the unique edge vertices with TSDF-gradient normals.
  frame k: [with fusion_camera_tracking: frame-to-frame rigid ICP of the
    live depth, deforming regions masked out, for the camera pose] -> warp
    the canonical (DLB with solver_rotations, else DQB) -> projective
    association against the live point/normal maps -> SE(3) (or
    translation) solve -> warped integration into the canonical volume ->
    re-extraction of the unique edge vertices -> node insertion.

The frame runs eagerly on the engine's device; the hot stages are the
hand-written kernels (mesh/mc_cuda, ops/warp_cuda, ops/knn_cuda,
ops/corr_cuda, solver/gram_cuda, and ops/stencil_cuda in the camera
tracking's ICP).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynfu_tpu_torch.core import dualquat as dq
from dynfu_tpu_torch.core import se3
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.engine.params import DynFuParams
from dynfu_tpu_torch.mesh import edges
from dynfu_tpu_torch.mesh.mc import marching_cubes
from dynfu_tpu_torch.ops import imgproc, knn
from dynfu_tpu_torch.rigid import icp
from dynfu_tpu_torch.solver import gn
from dynfu_tpu_torch.solver import se3 as se3_solver
from dynfu_tpu_torch.volume import fusion as vfusion
from dynfu_tpu_torch.volume import tsdf as tv
from dynfu_tpu_torch.warp import field as wfield


class Frame(NamedTuple):
    """Fixed-capacity masked vertex/normal buffers (dynfu::Frame)."""

    idx: int
    vertices: torch.Tensor  # (N, 3)
    normals: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,)


class FrameStats(NamedTuple):
    """mc_dropped: occupied marching-cubes cells not meshed (capacity);
    corr_dropped: live vertices whose correspondence no tier could certify.
    Both are 0 on a healthy run."""

    solve: gn.SolveStats
    mc_dropped: torch.Tensor  # () int32
    corr_dropped: torch.Tensor  # () int32


def _sample_nodes(verts, vert_mask, capacity: int, step: int, dg_w: float):
    """Every `step`-th soup vertex becomes a node with identity DQ
    (dyn_fusion.cpp:151-158); valid nodes are compacted to the front by a
    stable sort."""
    dev = verts.device
    idx = torch.arange(0, verts.shape[0], step, device=dev)
    pos, mask = verts[idx], vert_mask[idx]
    k = idx.shape[0]
    if k >= capacity:
        pos, mask = pos[:capacity], mask[:capacity]
    else:
        pos = torch.cat([pos, pos.new_zeros((capacity - k, 3))])
        mask = torch.cat([mask, mask.new_zeros(capacity - k)])
    count = mask.sum(dtype=torch.int32)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    pos, mask = pos[order], mask[order]
    dqs = dq.dq_identity(device=dev).repeat(capacity, 1)
    w = torch.where(mask, dg_w, 1.0).to(torch.float32)
    return wfield.WarpField(pos.contiguous(), dqs, w, mask, count)


def _correspondence(warped_verts, warped_mask, live_verts, live_mask,
                    rescue: int, escalate: int, window_blocks: int, payload):
    """findCorrespondingFrame (dyn_fusion.cpp:212-242), parity mode: the
    nearest warped canonical vertex of every live vertex, and its payload
    row. Returns (corr_v, corr_mask, fetched payload columns)."""
    out, exact = knn.nn1_gather_xwindow(
        live_verts, warped_verts, None, warped_mask, live_mask,
        rescue=rescue, escalate=escalate, window_blocks=window_blocks,
        values_fn=payload)
    return out[:, :3], live_mask & exact, out[:, 3:]


def _graph_payload(wf: wfield.WarpField, dp: DynFuParams):
    """values_fn for the correspondence fetch: per sorted warped canonical
    point [position(3) | knn idx(k) | Gaussian weights(k) | re-warped
    position(3)] — the solve's data graph, computed once at the unique
    canonical and fetched to live indexing. The re-warp is the reference
    quirk of re-running DQB on already-warped input (opt_solver.cpp:204-231).
    """
    def payload(pts_sorted, valid):
        g_idx, _, g_pos, g_dq, g_w, g_valid = wfield.neighbor_features(
            wf, pts_sorted, dp.knn)
        g_dw = wfield.transformation_weights(g_pos, g_w,
                                             pts_sorted[:, None, :])
        g_dw = torch.where(g_valid, g_dw, 0.0)
        g_blend = wfield._dqb_from_features(pts_sorted, g_pos, g_dq, g_w,
                                            g_valid)
        wv2 = dq.dq_transform_point(g_blend, pts_sorted)
        return torch.cat([pts_sorted, g_idx.to(torch.float32), g_dw, wv2],
                         dim=1)

    return payload


def _nonrigid_frame(vol, wf, canonical_v, canonical_m, depth_mm, pose, *,
                    dp: DynFuParams, intr, config, canonical_mult=None):
    """Frame k >= 1 of the parity pipeline (dyn_fusion.cpp:100-144)."""
    dists = imgproc.compute_dists(depth_mm, intr)
    vol = tv.integrate(vol, dists, pose, intr, config, fresh=True)
    if dp.corr_unique_edges:
        # the unique vertex set feeds correspondence and solve; the
        # triangle soup is left to DynFusion.mesh() (source :234-249)
        live_v, n_verts, mc_dropped = edges.isosurface_edge_vertices(
            vol, config, max_edges=dp.max_edge_verts or dp.max_vertices // 2,
            convention="center",
            col_budget=dp.edge_col_budget or dp.mc_col_budget)
    else:
        live_v, n_verts, mc_dropped = marching_cubes(
            vol, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices, col_budget=dp.mc_col_budget)
    live_m = torch.arange(live_v.shape[0], device=live_v.device) < n_verts

    # warp canonical -> live with the pre-solve field (dyn_fusion.cpp:203);
    # normals are the placeholder vertex copy
    wv, wn = wfield.warp_points_normals(wf, canonical_v, canonical_v)

    corr_v, corr_m, fetched = _correspondence(
        wv, canonical_m, live_v, live_m, rescue=dp.corr_rescue,
        escalate=dp.corr_escalate, window_blocks=dp.corr_window_blocks,
        payload=_graph_payload(wf, dp))

    k = dp.knn
    graph_w = (fetched[:, :k], fetched[:, k:2 * k],
               fetched[:, 2 * k:2 * k + 3])
    wf, solve_stats = gn.solve(
        wf, corr_v, live_v, vert_mask=corr_m & live_m, graph_w=graph_w,
        tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
        lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
        linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
        nonlinear_iter=dp.solver.nonlinear_iter,
        num_iter=dp.solver.num_iter, early_out=dp.solver.early_out)

    # node insertion from the warped canonical frame (dyn_fusion.cpp:142)
    wf = wfield.update_warpfield(wf, wv, canonical_m, dp.epsilon,
                                 dp.node_voxel_leaf, dp.max_new_nodes,
                                 vert_weights=canonical_mult)
    corr_dropped = torch.sum(live_m & ~corr_m, dtype=torch.int32)
    stats = FrameStats(solve_stats, mc_dropped, corr_dropped)
    return vol, wf, wv, wn, (live_v, n_verts), stats


class FusionFrameStats(NamedTuple):
    """FrameStats of the fusion frame, plus the band-compaction counters."""

    solve: NamedTuple  # se3.Se3Stats or gn.SolveStats
    mc_dropped: torch.Tensor  # () int32
    corr_dropped: torch.Tensor  # () int32
    band: vfusion.FusionStats


def _apply_rows(pose, p):
    """(R, t) applied to (N, 3) points."""
    R, t = pose
    return (p[:, 0:1] * R[None, :, 0] + p[:, 1:2] * R[None, :, 1]
            + p[:, 2:3] * R[None, :, 2] + t)


def _mask_deforming_depth(depth_mm, cv, wv, m, pose, vol_r, vol_t, *,
                          intr, thresh: float, dilate: int):
    """Zero the depth pixels that the known-deforming canonical covers, so
    that the frame-to-frame rigid ICP tracks the camera on static structure
    only (source: dynfusion.py:371-402). Canonical vertices whose warp moved
    them more than `thresh` project into a mask, dilated by `dilate` pixels
    (a (2 dilate + 1)^2 max filter)."""
    H, W = depth_mm.shape
    dev = depth_mm.device
    disp = torch.sum((wv - cv) ** 2, -1)
    deforming = m & (disp > thresh * thresh)
    cam = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in pose)
    vc = _apply_rows(se3.compose(se3.inverse(cam), (vol_r, vol_t)), wv)
    z = torch.clamp_min(vc[:, 2], 1e-6)
    u = intr.fx * vc[:, 0] / z + intr.cx
    v = intr.fy * vc[:, 1] / z + intr.cy
    in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vc[:, 2] > 0)
    flat = icp.pixel(v, H).long() * W + icp.pixel(u, W)
    img = torch.zeros(H * W, dtype=torch.float32, device=dev).scatter_reduce_(
        0, flat, (deforming & in_img).to(torch.float32), "amax")
    # max filter with "SAME" zero padding: the values are >= 0 and every
    # window holds its own pixel, so max_pool2d's -inf padding is the same
    img = F.max_pool2d(img.reshape(1, 1, H, W), 2 * dilate + 1, stride=1,
                       padding=dilate)[0, 0]
    return torch.where(img > 0, 0, depth_mm)


def _stage(name: str):
    """A named range of the fusion frame for torch.profiler (what
    utils/fusion_profile.py reads); near free when no profiler
    runs."""
    return torch.profiler.record_function(f"fusion/{name}")


def _fusion_frame(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
                  pose, *, dp: DynFuParams, intr, config,
                  solve_enabled: bool = True):
    """Frame k of the persistent-canonical pipeline (source:
    dynfusion.py:421-590): warp canonical -> projective correspondence
    against the live depth -> solve -> warped integration -> re-extraction
    of the canonical surface -> node insertion."""
    with _stage("inputs"):
        H, W = depth_mm.shape
        dev = depth_mm.device
        dists = imgproc.compute_dists(depth_mm, intr)
        live_pts, live_ns = imgproc.compute_points_normals(depth_mm, intr)
        blend = "dlb" if dp.solver_rotations else "dqb"

    with _stage("warp"):
        # warp canonical -> live with the pre-solve field
        if dp.solver_rotations:
            wv, wn = wfield.warp_points_normals_dlb(wf, canonical_v,
                                                    canonical_n)
        else:
            wv, wn = wfield.warp_points_normals(wf, canonical_v, canonical_n)

    with _stage("associate"):
        # projective association (proj_icp.cu:42-99): the live vertex and
        # normal at the pixel each warped vertex projects to
        cam = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                    for a in pose)
        cam_from_vol = se3.compose(se3.inverse(cam),
                                   (vol.pose_r, vol.pose_t))
        vc = _apply_rows(cam_from_vol, wv)
        u = intr.fx * vc[:, 0] / vc[:, 2] + intr.cx
        v = intr.fy * vc[:, 1] / vc[:, 2] + intr.cy
        in_img = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (vc[:, 2] > 0)
        ui, vi = icp.pixel(u, W), icp.pixel(v, H)
        lp_cam = live_pts[vi, ui]  # NaN at invalid pixels
        ln_cam = live_ns[vi, ui]
        lp_vol = _apply_rows(se3.inverse(cam_from_vol), lp_cam)
        Rcv = cam_from_vol[0]  # normals go cam -> vol by R^T
        ln_vol = (ln_cam[:, 0:1] * Rcv[None, 0]
                  + ln_cam[:, 1:2] * Rcv[None, 1]
                  + ln_cam[:, 2:3] * Rcv[None, 2])
        dist2 = torch.sum((lp_vol - wv) ** 2, -1)
        # target = the footpoint on the live tangent plane (point-to-plane)
        n_dot = torch.sum(ln_vol * (lp_vol - wv), -1)
        foot = wv + n_dot[:, None] * ln_vol
        # facing gate: DLB's wn is a rotated normal; a translations-only
        # field has identity blended rotation, so there the canonical normal
        # is it
        facing_n = wn if dp.solver_rotations else canonical_n
        facing = torch.sum(ln_vol * facing_n, -1) > 0.0
        corr_m = (canonical_m & in_img & torch.isfinite(lp_cam[:, 0])
                  & torch.isfinite(ln_cam[:, 0]) & facing
                  & (dist2 < dp.fusion_corr_dist ** 2))
        lp_vol = torch.where(corr_m[:, None], foot, 0.0)

    with _stage("solve"):
        min_update = dp.fusion_min_update_vox * min(config.voxel_size)
        if not solve_enabled:
            # warm-up frames integrate without warping
            z = torch.zeros((), device=dev)
            zi = torch.zeros((), dtype=torch.int32, device=dev)
            stats_cls = (se3_solver.Se3Stats if dp.solver_rotations
                         else gn.SolveStats)
            solve_stats = stats_cls(z, z, zi, z)
        elif dp.solver_rotations:
            wf, solve_stats = se3_solver.solve(
                wf, wv, lp_vol, vert_mask=corr_m, tukey_offset=dp.tukey_offset,
                psi_data=dp.psi_data, lambda_reg=dp.lambda_reg,
                psi_reg=dp.psi_reg, linear_iter=dp.solver.linear_iter,
                knn_k=dp.knn, relinearize=dp.se3_relinearize, incremental=True,
                rot_prior=dp.se3_rot_prior, trans_prior=dp.se3_trans_prior,
                similarity_reg=dp.se3_similarity_reg, min_update=min_update,
                # trust region tied to the association gate (solver/se3.py)
                max_update=dp.fusion_corr_dist)
        else:
            data_idx, _, n_pos, _, n_w, n_valid = wfield.neighbor_features(
                wf, wv, dp.knn)
            wf, solve_stats = gn.solve(
                wf, wv, lp_vol, vert_mask=corr_m,
                graph=(data_idx, n_pos, n_w, n_valid, wv),
                tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
                lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
                linear_iter=dp.solver.linear_iter, knn_k=dp.knn,
                nonlinear_iter=dp.solver.nonlinear_iter,
                num_iter=dp.solver.num_iter, early_out=dp.solver.early_out,
                min_update=min_update, max_update=dp.fusion_corr_dist)

    with _stage("integrate"):
        # fuse the live observations into the canonical volume through the
        # UPDATED field
        vol, band_stats = vfusion.integrate_warped(
            vol, wf, dists, pose, intr, config, normals=live_ns,
            min_cos=dp.fusion_min_cos, max_active=dp.fusion_max_active,
            dilate=dp.fusion_dilate, knn_k=dp.knn, blend=blend)

    with _stage("extract"):
        # re-extract the canonical surface with gradient normals, then insert
        # nodes where it is unsupported (warp_field.cpp:63-95)
        mesh_verts, n_verts, mc_dropped, new_n = \
            edges.isosurface_edge_vertices(
                vol, config,
                max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                convention="corner",
                col_budget=dp.edge_col_budget or dp.mc_col_budget,
                with_normals=True)
        new_m = torch.arange(mesh_verts.shape[0], device=dev) < n_verts
    with _stage("insert"):
        if dp.solver_rotations:
            wv2, wn2 = wfield.warp_points_normals_dlb(wf, mesh_verts, new_n)
        else:
            wv2, wn2 = wfield.warp_points_normals(wf, mesh_verts, new_n)
        # candidates outside the volume (+ a truncation margin) were dragged
        # there by a rogue warp
        X, Y, Z = config.dims
        vsx, vsy, vsz = config.voxel_size
        m = 2.0 * config.trunc_dist
        wf = wfield.update_warpfield(
            wf, wv2, new_m, dp.epsilon, dp.node_voxel_leaf, dp.max_new_nodes,
            blend=blend,
            aabb=((-m, -m, -m), (X * vsx + m, Y * vsy + m, Z * vsz + m)))
    corr_dropped = torch.sum(canonical_m & ~corr_m, dtype=torch.int32)
    stats = FusionFrameStats(solve_stats, mc_dropped, corr_dropped,
                             band_stats)
    return vol, wf, mesh_verts, new_n, new_m, wv2, wn2, stats


class DynFusion(KinFu):
    """Non-rigid fusion engine. Call with (H, W) integer mm depth images
    (numpy or tensor).

    mode="parity" reproduces the reference's loop and quirks;
    mode="fusion" keeps a persistent canonical volume with warped
    integration (see _fusion_frame), with frame-to-frame camera tracking
    when fusion_camera_tracking is set. "fixed" (the reference's loop with
    rigid ICP and real normals) and foreground tracking (fg_aabb) are not
    ported yet and raise."""

    def __init__(self, params: Optional[DynFuParams] = None, device="cuda",
                 mode: str = "parity"):
        if mode not in ("parity", "fixed", "fusion"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "fixed":
            raise NotImplementedError(
                "mode='fixed' needs tsdf.extract_normals and the fixed "
                "frame (ROADMAP.md item E)")
        self.dynfu_params = params or DynFuParams.default_params()
        dp = self.dynfu_params
        if (dp.fg_aabb is not None and dp.max_fg_verts > 0
                and mode != "fusion"):
            raise NotImplementedError(
                "fg_aabb / max_fg_verts (foreground tracking) is not ported "
                "yet (ROADMAP.md item 11)")
        if mode == "fusion" and not dp.corr_unique_edges:
            raise NotImplementedError(
                "fusion mode without corr_unique_edges needs "
                "tsdf.extract_normals (ROADMAP.md item E)")
        self.mode = mode
        super().__init__(dp.kinfu, device)
        self.warpfield: Optional[wfield.WarpField] = None
        self.canonical: Optional[Frame] = None
        self.canonical_warped: Optional[Frame] = None
        # canonical dedup state: the frame-0 soup holds each mesh vertex
        # ~6x; the per-frame passes run on the unique set
        self.soup_inverse = None  # (max_vertices,) int32 -> unique slot
        self.soup_mask = None  # (max_vertices,) bool
        self.canonical_mult = None  # (Ucap,) f32 soup multiplicity
        self.mesh_vertices = None  # last triangle soup (buffer, count)
        self.live: Optional[Frame] = None  # parity: the frame's live set
        self.last_frame_stats = None  # FrameStats or FusionFrameStats
        self.last_solve_stats = None
        self.prev_live_pyr = None  # fusion_camera_tracking reference pyramid

    def _marching_cubes(self):
        dp = self.dynfu_params
        return marching_cubes(
            self.vol, self.tsdf_config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices,
            # fusion mode needs vertices consistent with the TSDF samples;
            # parity keeps the reference's half-voxel-shifted meshes
            convention="corner" if self.mode == "fusion" else "center",
            col_budget=dp.mc_col_budget)

    def _mc_frame(self, idx: int) -> Frame:
        verts, n_verts, _ = self._marching_cubes()
        self.mesh_vertices = (verts, n_verts)
        mask = torch.arange(verts.shape[0], device=verts.device) < n_verts
        return Frame(idx, verts, verts, mask)  # placeholder normals

    def _dedup_canonical(self, frame: Frame) -> Frame:
        """One host dedup of the frame-0 soup (numpy np.unique, so the
        canonical order is the source's); the unique capacity is a power
        of two >= 1024."""
        v = frame.vertices.cpu().numpy()
        n = frame.normals.cpu().numpy()
        m = frame.mask.cpu().numpy()
        valid_idx = np.nonzero(m)[0]
        uniq, first_idx, inv = np.unique(
            v[valid_idx], axis=0, return_index=True, return_inverse=True)
        inv = inv.reshape(-1)
        U = max(int(uniq.shape[0]), 1)
        ucap = 1 << max(10, (U - 1).bit_length())
        mult = np.bincount(inv, minlength=U).astype(np.float32)
        uv = np.zeros((ucap, 3), np.float32)
        uv[:U] = uniq
        un = np.zeros((ucap, 3), np.float32)
        un[:U] = n[valid_idx][first_idx]
        um = np.zeros(ucap, bool)
        um[:U] = True
        umult = np.zeros(ucap, np.float32)
        umult[:U] = mult
        inv_full = np.full(v.shape[0], ucap, np.int32)
        inv_full[valid_idx] = inv.astype(np.int32)
        dev = self.device
        self.soup_inverse = torch.as_tensor(inv_full, device=dev)
        self.soup_mask = frame.mask
        self.canonical_mult = torch.as_tensor(umult, device=dev)
        return Frame(frame.idx, torch.as_tensor(uv, device=dev),
                     torch.as_tensor(un, device=dev),
                     torch.as_tensor(um, device=dev))

    def _fusion_track_pose(self, depth_mm: torch.Tensor) -> None:
        """Frame-to-frame rigid camera tracking for fusion mode (source:
        dynfusion.py:757-811): the ICP of KinFu (stencil, gather rescue) of
        the current depth pyramid against the previous frame's, with the
        known-deforming region masked out of the depth. A degenerate solve
        keeps the previous pose: the canonical volume is persistent, so
        there is no reset."""
        p = self.params
        depth_icp = depth_mm
        c, cw = self.canonical, self.canonical_warped
        if (c is not None and cw is not None
                and c.vertices.shape == cw.vertices.shape):
            depth_icp = _mask_deforming_depth(
                depth_mm, c.vertices, cw.vertices, cw.mask, self.poses[-1],
                self.vol.pose_r, self.vol.pose_t, intr=p.intr,
                thresh=float(min(self.tsdf_config.voxel_size)), dilate=8)
        _, curr_pyr = self._preprocess(depth_icp)
        if self.prev_live_pyr is None:
            self.prev_live_pyr = curr_pyr
            self.poses.append(self.poses[-1])
            return
        packed = self._track(curr_pyr, self.prev_live_pyr)
        if packed[12] != 0.0:
            self._push_pose(packed)
        else:
            self.poses.append(self.poses[-1])
        self.prev_live_pyr = curr_pyr

    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion; `image` is accepted and unused, as in the
        reference. Returns False for the bootstrap frame."""
        del image
        dp = self.dynfu_params
        p = self.params
        depth_mm = self._depth(depth_mm)

        if self.frame_counter == 0:
            if self.mode == "fusion" and dp.fusion_camera_tracking:
                # the pyramid is the next frame's ICP reference
                dists, self.prev_live_pyr = self._preprocess(depth_mm)
            else:
                dists = imgproc.compute_dists(depth_mm, p.intr)
                filtered = imgproc.bilateral_filter(
                    depth_mm, p.bilateral_kernel_size,
                    p.bilateral_sigma_spatial, p.bilateral_sigma_depth)
                if p.icp_truncate_depth_dist > 0:
                    filtered = imgproc.truncate_depth(
                        filtered, p.icp_truncate_depth_dist)
                # the parity loop runs no ICP (dyn_fusion.cpp:53-65)
                del filtered
            self.vol = tv.integrate(self.vol, dists, self.poses[-1], p.intr,
                                    self.tsdf_config)
            frame = self._mc_frame(0)
            # node sampling strides the SOUP (dyn_fusion.cpp:151), before
            # the dedup
            self.warpfield = _sample_nodes(
                frame.vertices, frame.mask, dp.max_nodes, dp.node_sample_step,
                dp.init_node_dg_w_factor * dp.epsilon)
            if self.mode == "fusion":
                # the canonical at unique-vertex granularity from frame 0,
                # so every fusion frame has one shape
                ev, ne, _, en = edges.isosurface_edge_vertices(
                    self.vol, self.tsdf_config,
                    max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                    convention="corner",
                    col_budget=dp.edge_col_budget or dp.mc_col_budget,
                    with_normals=True)
                frame = Frame(0, ev, en,
                              torch.arange(ev.shape[0], device=ev.device) < ne)
            else:
                frame = self._dedup_canonical(frame)
            self.canonical = frame
            self.canonical_warped = frame
            self.frame_counter += 1
            return False

        c = self.canonical
        if self.mode == "fusion":
            if dp.fusion_camera_tracking:
                with _stage("track"):
                    self._fusion_track_pose(depth_mm)
            else:
                self.poses.append(self.poses[-1])
            (self.vol, self.warpfield, new_v, new_n, new_m, wv2, wn2,
             self.last_frame_stats) = _fusion_frame(
                self.vol, self.warpfield, c.vertices, c.normals, c.mask,
                depth_mm, self.poses[-1], dp=dp, intr=p.intr,
                config=self.tsdf_config,
                solve_enabled=self.frame_counter > dp.fusion_warmup_frames)
            self.canonical = Frame(self.frame_counter, new_v, new_n, new_m)
            self.canonical_warped = Frame(self.frame_counter, wv2, wn2, new_m)
            self.mesh_vertices = None  # the soup on demand (mesh())
            self.last_solve_stats = self.last_frame_stats.solve
            self.frame_counter += 1
            return True
        self.poses.append(self.poses[-1])  # identity (dyn_fusion.cpp:102)
        (self.vol, self.warpfield, wv, wn, (live_v, n_live),
         self.last_frame_stats) = _nonrigid_frame(
            self.vol, self.warpfield, c.vertices, c.mask, depth_mm,
            self.poses[-1], dp=dp, intr=p.intr, config=self.tsdf_config,
            canonical_mult=self.canonical_mult)
        self.canonical_warped = Frame(c.idx, wv, wn, c.mask)
        live_m = torch.arange(live_v.shape[0], device=live_v.device) < n_live
        self.live = Frame(self.frame_counter, live_v, live_v, live_m)
        # the unique edge vertices leave the soup to mesh()
        self.mesh_vertices = (None if dp.corr_unique_edges
                              else (live_v, n_live))
        self.last_solve_stats = self.last_frame_stats.solve
        self.frame_counter += 1
        return True

    def mesh(self):
        """The last extracted triangle soup (vertex buffer, count); in
        fusion mode and with corr_unique_edges marching cubes runs on demand
        on the retained volume."""
        if self.mesh_vertices is None:
            v, n, _ = self._marching_cubes()
            self.mesh_vertices = (v, n)
        return self.mesh_vertices

    def warped_cloud(self, unique: bool = False):
        """Current warped canonical vertices and mask: at unique-vertex
        granularity, or expanded back to the frame-0 soup order (fusion
        mode's canonical is the unique set already)."""
        f = self.canonical_warped
        if unique or self.soup_inverse is None:
            return f.vertices, f.mask
        idx = torch.clamp_max(self.soup_inverse, f.vertices.shape[0] - 1)
        v = torch.where(self.soup_mask[:, None], f.vertices[idx.long()], 0.0)
        return v, self.soup_mask
