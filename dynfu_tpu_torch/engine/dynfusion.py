"""DynamicFusion orchestrator: the non-rigid frame loop in parity, fixed and
fusion modes.

Port of dynfu_tpu/engine/dynfusion.py (the reference's DynFusion::operator(),
dyn_fusion.cpp:48-144). Parity mode:

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

Fixed mode is that loop with what the reference scaffolded and never wired:
the camera pose by the gather ICP of the depth pyramid against the model's
raycast pyramid (refreshed after every frame), TSDF-gradient normals
(tsdf.extract_normals) for the canonical and the live soup, the warped
normals fetched with the correspondence, and the solve's own data graph
(or, with solver_rotations, DLB warps and the SE(3) solve).

Foreground tracking (parity and fixed mode, fg_aabb with max_fg_verts):
frame 0 samples nodes from the box only and keeps the box's first
max_fg_verts canonical vertices as the tracked canonical; every frame
compacts the live set to the box, in scan order, and counts the box's
overflow into corr_dropped. The full canonical is kept for mesh() and is
warped on demand by warped_cloud().

Fusion mode (the persistent canonical volume of Newcombe et al. 3.3, which
the reference's clear + re-integrate stands in for):

  frame 0: integrate -> marching cubes soup (corner convention) -> every
    node_sample_step-th soup vertex becomes a node -> the canonical becomes
    the unique edge vertices with TSDF-gradient normals (without
    corr_unique_edges: the soup, with extract_normals).
  frame k: [with fusion_camera_tracking: frame-to-frame rigid ICP of the
    live depth, deforming regions masked out, for the camera pose] -> warp
    the canonical (DLB with solver_rotations, else DQB) -> projective
    association against the live point/normal maps -> SE(3) (or
    translation) solve -> warped integration into the canonical volume ->
    re-extraction of the canonical surface -> node insertion.

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
from dynfu_tpu_torch.ops import compaction, imgproc, knn
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
    corr_dropped: live vertices whose correspondence no tier could certify,
    plus, with foreground tracking, the box's vertices beyond max_fg_verts.
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


def _correspondence(warped_verts, warped_normals, warped_mask, live_verts,
                    live_mask, parity: bool, rescue: int, escalate: int,
                    window_blocks: int, payload=None):
    """findCorrespondingFrame (dyn_fusion.cpp:212-242): the nearest warped
    canonical vertex of every live vertex, its normal, and its payload row.
    Parity mode's normals are the placeholder vertex copy, so only positions
    and the payload (`values_fn`, computed after the sort) are fetched; fixed
    mode fetches the warped vertices and normals as a (N, 6) values payload.
    Returns (corr_v, corr_n, corr_mask, fetched payload columns)."""
    vals = None if parity else torch.cat([warped_verts, warped_normals], 1)
    out, exact = knn.nn1_gather_xwindow(
        live_verts, warped_verts, vals, warped_mask, live_mask,
        rescue=rescue, escalate=escalate, window_blocks=window_blocks,
        values_fn=payload)
    n = 0 if parity else 3  # where the normals start
    return (out[:, :3], out[:, n:n + 3], live_mask & exact,
            out[:, n + 3:])


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


def _in_box(v, aabb):
    """Vertices inside the half-open box aabb = (lo3, hi3)."""
    lo, hi = aabb
    return ((v[:, 0] >= lo[0]) & (v[:, 0] < hi[0])
            & (v[:, 1] >= lo[1]) & (v[:, 1] < hi[1])
            & (v[:, 2] >= lo[2]) & (v[:, 2] < hi[2]))


class ShardKernels(NamedTuple):
    """The stages a sharded parity frame runs otherwise (source:
    dynfu_tpu/engine/dynfusion.py:178-196; dist/engine_spmd.py builds
    them). The rank holds planes x0.. of the volume and its block's live
    vertices; the nodes and the canonical are replicated.

    * x0: the block's first plane (integrate);
    * halo_fn(vol) -> (slab, (h0, h1)): the block with its neighbours'
      boundary planes (the edge extraction and marching cubes);
    * prefix(counts) -> (before, total): the capacities over all blocks
      (ops/compaction.py), and the drop counts summed over ranks;
    * warp_fn(wf, canonical_v, canonical_n) -> (wv, wn) of the whole
      canonical, each rank warping a row range;
    * gram_fn: gn.solve's data_normal_fn, reduced over ranks in rank order.

    The correspondence needs none: knn.nn1_gather_xwindow on the block's
    live set against the replicated warped canonical, its graph payload
    computed per rank, is the sharded correspondence (dist/shard_corr.py).
    """

    x0: int
    halo_fn: object
    prefix: object
    warp_fn: object
    gram_fn: object


def _nonrigid_frame(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
                    pose, *, dp: DynFuParams, intr, config, parity: bool,
                    canonical_mult=None,
                    kernels: Optional[ShardKernels] = None):
    """Frame k >= 1 of the parity and fixed pipelines
    (dyn_fusion.cpp:100-144). Parity keeps the reference's quirks (placeholder
    normals, the data graph fetched with the correspondence); fixed mode has
    TSDF-gradient normals, fetches the warped normals with the
    correspondence, and solves with its own graph (or per-node SE(3) with
    solver_rotations). The per-voxel integrate serves any pose.

    With fg_aabb (foreground tracking) the live set is compacted to the box,
    in scan order, before correspondence and solve; live vertices in the box
    beyond max_fg_verts count into corr_dropped.

    With `kernels` (parity mode, dist/engine_spmd.py) the volume is the
    rank's x-block, the live set its block's vertices (in rank order the
    single card's), wv and wn the whole canonical's, and the counts global.

    Returns (vol, wf, wv, wn, (live_v, live_n, live_m), (mesh_verts,
    n_verts), stats)."""
    dists = imgproc.compute_dists(depth_mm, intr)
    x0 = 0 if kernels is None else kernels.x0
    vol = tv.integrate(vol, dists, pose, intr, config, fresh=True, x0=x0)
    slab, block = vol, {}
    if kernels is not None:
        slab, halo = kernels.halo_fn(vol)
        block = dict(x0=x0, halo=halo, prefix=kernels.prefix)
    if dp.corr_unique_edges and parity:
        # the unique vertex set feeds correspondence and solve; the
        # triangle soup is left to DynFusion.mesh() (source :234-249)
        live_v, n_verts, mc_dropped = edges.isosurface_edge_vertices(
            slab, config,
            max_edges=dp.max_edge_verts or dp.max_vertices // 2,
            convention="center",
            col_budget=dp.edge_col_budget or dp.mc_col_budget, **block)
    else:
        live_v, n_verts, mc_dropped = marching_cubes(
            slab, config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices, col_budget=dp.mc_col_budget, **block)
    del slab
    mesh = (live_v, n_verts)
    live_m = torch.arange(live_v.shape[0], device=live_v.device) < n_verts
    live_n = (live_v if parity
              else tv.extract_normals(vol, live_v, config, frame="volume"))

    fg_dropped = 0
    if dp.fg_aabb is not None and dp.max_fg_verts > 0:
        # the tracked live set: the box's vertices in scan order (the
        # correspondence window relies on it)
        inb = live_m & _in_box(live_v, dp.fg_aabb)
        n = live_v.shape[0]
        fidx = compaction.rank_select(inb, dp.max_fg_verts, n,
                                      prefix=block.get("prefix"))
        fok = fidx < n
        fsafe = torch.clamp_max(fidx, n - 1)
        live_v = torch.where(fok[:, None], live_v[fsafe], 0.0)
        live_n = (live_v if parity
                  else torch.where(fok[:, None], live_n[fsafe], 0.0))
        live_m = fok
        # the box's vertices beyond the capacity (this block's share)
        fg_dropped = inb.sum(dtype=torch.int32) - fok.sum(dtype=torch.int32)

    # warp canonical -> live with the pre-solve field (dyn_fusion.cpp:203)
    rotations = dp.solver_rotations and not parity
    if rotations:
        wv, wn = wfield.warp_points_normals_dlb(wf, canonical_v, canonical_n)
    elif kernels is not None:
        wv, wn = kernels.warp_fn(wf, canonical_v, canonical_n)
    else:
        wv, wn = wfield.warp_points_normals(wf, canonical_v, canonical_n)

    corr_v, _, corr_m, fetched = _correspondence(
        wv, wn, canonical_m, live_v, live_m, parity, rescue=dp.corr_rescue,
        escalate=dp.corr_escalate, window_blocks=dp.corr_window_blocks,
        payload=_graph_payload(wf, dp) if parity else None)

    solver = dict(tukey_offset=dp.tukey_offset, psi_data=dp.psi_data,
                  lambda_reg=dp.lambda_reg, psi_reg=dp.psi_reg,
                  linear_iter=dp.solver.linear_iter, knn_k=dp.knn)
    if rotations:
        # corr_v is already warped: the incremental convention
        wf, solve_stats = se3_solver.solve(
            wf, corr_v, live_v, vert_mask=corr_m & live_m,
            relinearize=dp.se3_relinearize, incremental=True,
            rot_prior=dp.se3_rot_prior, trans_prior=dp.se3_trans_prior,
            similarity_reg=dp.se3_similarity_reg, **solver)
    else:
        k = dp.knn
        graph_w = ((fetched[:, :k], fetched[:, k:2 * k],
                    fetched[:, 2 * k:2 * k + 3]) if parity else None)
        wf, solve_stats = gn.solve(
            wf, corr_v, live_v, vert_mask=corr_m & live_m, graph_w=graph_w,
            nonlinear_iter=dp.solver.nonlinear_iter,
            num_iter=dp.solver.num_iter, early_out=dp.solver.early_out,
            data_normal_fn=(gn.data_normal if kernels is None
                            else kernels.gram_fn), **solver)

    # node insertion from the warped canonical frame (dyn_fusion.cpp:142)
    wf = wfield.update_warpfield(wf, wv, canonical_m, dp.epsilon,
                                 dp.node_voxel_leaf, dp.max_new_nodes,
                                 blend="dlb" if rotations else "dqb",
                                 vert_weights=canonical_mult)
    corr_dropped = torch.sum(live_m & ~corr_m, dtype=torch.int32) + fg_dropped
    if kernels is not None:
        mc_dropped, corr_dropped = (
            torch.tensor(t, dtype=torch.int32, device=live_v.device)
            for t in kernels.prefix([mc_dropped, corr_dropped])[1])
    stats = FrameStats(solve_stats, mc_dropped, corr_dropped)
    return vol, wf, wv, wn, (live_v, live_n, live_m), mesh, stats


class FusionShardKernels(NamedTuple):
    """The stages a sharded fusion frame runs otherwise
    (dist/engine_spmd.sharded_fusion_frame builds them). The rank holds
    planes x0.. of the volume; the canonical buffer and the nodes are
    replicated, and the per-vertex stages (the pre-solve warp, the
    projective association, the solve's data rows, the insertion warp) run
    on the rank's row range of a buffer.

    * x0: the block's first plane;
    * halo_fn(vol, width) -> (slab, (h0, h1)): the block with `width` of its
      neighbours' planes on each side (the band dilation, the
      re-extraction and its normals);
    * prefix(counts) -> (before, total): the capacities over all blocks
      (ops/compaction.py), and the counts summed over ranks;
    * rows(n) -> (lo, hi): the rank's row range of an n-row buffer;
    * gather_rows(t, n=None) -> every rank's rows of t in rank order (each
      rank holding rows(n), or any number of rows);
    * data_normal_fn: gn.solve's data term, reduced over ranks in rank
      order (translations);
    * data_term: se3.solve's, reduced likewise (solver_rotations).
    """

    x0: int
    halo_fn: object
    prefix: object
    rows: object
    gather_rows: object
    data_normal_fn: object
    data_term: object


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
                  solve_enabled: bool = True,
                  kernels: Optional[FusionShardKernels] = None):
    """Frame k of the persistent-canonical pipeline (source:
    dynfusion.py:421-590): warp canonical -> projective correspondence
    against the live depth -> solve -> warped integration -> re-extraction
    of the canonical surface -> node insertion.

    With `kernels` (dist/engine_spmd.sharded_fusion_frame) the volume is the
    rank's x-block and the per-vertex stages run on its row ranges; the
    re-extracted canonical (each block's vertices in scan order) is
    gathered in rank order into the single card's buffer, padding included,
    and the insertion warp gathered likewise, so the outputs but the volume
    are replicated, and the counts global."""
    with _stage("inputs"):
        H, W = depth_mm.shape
        dev = depth_mm.device
        dists = imgproc.compute_dists(depth_mm, intr)
        live_pts, live_ns = imgproc.compute_points_normals(depth_mm, intr)
        blend = "dlb" if dp.solver_rotations else "dqb"
        sharded = kernels is not None
        # the block's stages (the whole volume's on one card)
        x0, halo_fn, prefix = 0, None, None
        data_term, data_normal_fn = se3_solver.DataTerm(), gn.data_normal
        if sharded:  # the rank's rows of the canonical
            x0, halo_fn, prefix = kernels.x0, kernels.halo_fn, kernels.prefix
            data_term = kernels.data_term
            data_normal_fn = kernels.data_normal_fn
            lo, hi = kernels.rows(canonical_v.shape[0])
            canonical_v, canonical_n, canonical_m = (
                t[lo:hi].contiguous()
                for t in (canonical_v, canonical_n, canonical_m))

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
                max_update=dp.fusion_corr_dist, data_term=data_term)
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
                min_update=min_update, max_update=dp.fusion_corr_dist,
                data_normal_fn=data_normal_fn)

    with _stage("integrate"):
        # fuse the live observations into the canonical volume through the
        # UPDATED field
        vol, band_stats = vfusion.integrate_warped(
            vol, wf, dists, pose, intr, config, normals=live_ns,
            min_cos=dp.fusion_min_cos, max_active=dp.fusion_max_active,
            dilate=dp.fusion_dilate, knn_k=dp.knn, blend=blend, x0=x0,
            halo_fn=halo_fn, prefix=prefix)

    with _stage("extract"):
        # re-extract the canonical surface with gradient normals, then insert
        # nodes where it is unsupported (warp_field.cpp:63-95): the unique
        # edge vertices (normals from the lattice gradients), or the
        # marching-cubes soup with extract_normals; on a block, from its
        # slab with 2 halo planes (the normals' reach)
        slab, halo = (vol, (0, 0)) if not sharded else halo_fn(vol, 2)
        block = dict(x0=x0, halo=halo, prefix=prefix)
        if dp.corr_unique_edges:
            mesh_verts, n_verts, mc_dropped, new_n = \
                edges.isosurface_edge_vertices(
                    slab, config,
                    max_edges=dp.max_edge_verts or dp.max_vertices // 2,
                    convention="corner",
                    col_budget=dp.edge_col_budget or dp.mc_col_budget,
                    with_normals=True, **block)
        else:
            mesh_verts, n_verts, mc_dropped = marching_cubes(
                slab, config, max_voxels=dp.max_mc_voxels,
                max_verts=dp.max_vertices, convention="corner",
                col_budget=dp.mc_col_budget, **block)
            new_n = tv.extract_normals(slab, mesh_verts, config,
                                       frame="volume", x0=x0, halo=halo)
        del slab
        if sharded:
            # the blocks' vertices in rank order: the single card's buffer
            cap = mesh_verts.shape[0]
            n = int(n_verts)
            both = kernels.gather_rows(torch.cat([mesh_verts[:n],
                                                  new_n[:n]], 1))
            n_verts = torch.tensor(both.shape[0], dtype=torch.int32,
                                   device=dev)
            mesh_verts = torch.zeros((cap, 3), device=dev)
            new_n = torch.full((cap, 3), torch.nan, device=dev)
            mesh_verts[:both.shape[0]] = both[:, :3]
            new_n[:both.shape[0]] = both[:, 3:]
        new_m = torch.arange(mesh_verts.shape[0], device=dev) < n_verts
    with _stage("insert"):
        rv, rn = mesh_verts, new_n
        if sharded:
            lo2, hi2 = kernels.rows(mesh_verts.shape[0])
            rv, rn = mesh_verts[lo2:hi2].contiguous(), new_n[lo2:hi2]
        if dp.solver_rotations:
            wv2, wn2 = wfield.warp_points_normals_dlb(wf, rv, rn)
        else:
            wv2, wn2 = wfield.warp_points_normals(wf, rv, rn)
        if sharded:
            both = kernels.gather_rows(torch.cat([wv2, wn2], 1),
                                       mesh_verts.shape[0])
            wv2, wn2 = both[:, :3], both[:, 3:]
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
    if sharded:  # the counts over all ranks
        (mc_dropped, corr_dropped, *band) = (
            torch.tensor(t, dtype=torch.int32, device=dev)
            for t in prefix([mc_dropped, corr_dropped, *band_stats])[1])
        band_stats = vfusion.FusionStats(*band)
    stats = FusionFrameStats(solve_stats, mc_dropped, corr_dropped,
                             band_stats)
    return vol, wf, mesh_verts, new_n, new_m, n_verts, wv2, wn2, stats


class DynFusion(KinFu):
    """Non-rigid fusion engine. Call with (H, W) integer mm depth images
    (numpy or tensor).

    mode="parity" reproduces the reference's loop and quirks; mode="fixed"
    is that loop with the fixes the reference scaffolded and never wired
    (the camera pose by rigid ICP against the raycast model, TSDF-gradient
    normals); mode="fusion" keeps a persistent canonical volume with warped
    integration (see _fusion_frame), with frame-to-frame camera tracking
    when fusion_camera_tracking is set. In parity and fixed mode, fg_aabb
    with max_fg_verts > 0 tracks only the foreground box (see
    _fg_compact)."""

    def __init__(self, params: Optional[DynFuParams] = None, device="cuda",
                 mode: str = "parity"):
        if mode not in ("parity", "fixed", "fusion"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.dynfu_params = params or DynFuParams.default_params()
        dp = self.dynfu_params
        super().__init__(dp.kinfu, device)
        self.warpfield: Optional[wfield.WarpField] = None
        self.canonical: Optional[Frame] = None
        self.canonical_warped: Optional[Frame] = None
        # foreground tracking: the canonical compacted to the box and its
        # soup multiplicities (the full canonical stays in self.canonical)
        self._fg_canonical: Optional[Frame] = None
        self._fg_mult = None
        # canonical dedup state: the frame-0 soup holds each mesh vertex
        # ~6x; the per-frame passes run on the unique set
        self.soup_inverse = None  # (max_vertices,) int32 -> unique slot
        self.soup_mask = None  # (max_vertices,) bool
        self.canonical_mult = None  # (Ucap,) f32 soup multiplicity
        self.mesh_vertices = None  # last triangle soup (buffer, count)
        self.live: Optional[Frame] = None  # the frame's live set
        self.last_frame_stats = None  # FrameStats or FusionFrameStats
        self.last_solve_stats = None
        self.prev_live_pyr = None  # fusion_camera_tracking reference pyramid

    def _marching_cubes(self):
        dp = self.dynfu_params
        return marching_cubes(
            self.vol, self.tsdf_config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices,
            # fusion mode needs vertices consistent with the TSDF samples;
            # parity and fixed keep the reference's half-voxel-shifted meshes
            convention="corner" if self.mode == "fusion" else "center",
            col_budget=dp.mc_col_budget)

    def _mc_frame(self, idx: int) -> Frame:
        """Marching cubes -> the triangle-soup Frame; its normals are the
        placeholder vertex copy in parity mode (dyn_fusion.cpp:80-88), the
        TSDF gradient otherwise."""
        verts, n_verts, _ = self._marching_cubes()
        self.mesh_vertices = (verts, n_verts)
        mask = torch.arange(verts.shape[0], device=verts.device) < n_verts
        normals = (verts if self.mode == "parity" else tv.extract_normals(
            self.vol, verts, self.tsdf_config, frame="volume"))
        return Frame(idx, verts, normals, mask)

    def _fg_enabled(self) -> bool:
        dp = self.dynfu_params
        return (dp.fg_aabb is not None and dp.max_fg_verts > 0
                and self.mode != "fusion")

    def _fg_compact(self, frame: Frame):
        """One host compaction of the deduplicated canonical to the
        foreground box (DynFuParams.fg_aabb): the first max_fg_verts box
        vertices in index order become the tracked canonical, with their
        soup multiplicities. An overflow is printed, and the rest are not
        tracked. The full canonical stays in self.canonical for meshes and
        exports; its background warps to ~identity on demand (its node
        weights vanish)."""
        v = frame.vertices.cpu().numpy()
        idx = np.nonzero(frame.mask.cpu().numpy()
                         & _in_box(v, self.dynfu_params.fg_aabb))[0]
        cap = self.dynfu_params.max_fg_verts
        if len(idx) > cap:
            print(f"fg canonical overflow: {len(idx)} > {cap} "
                  f"(tracking the first {cap})")
            idx = idx[:cap]

        def padded(a, dtype):
            out = np.zeros((cap,) + a.shape[1:], dtype)
            out[:len(idx)] = a[idx]
            return torch.as_tensor(out, device=self.device)

        fm = padded(np.ones(v.shape[0], bool), bool)
        return (Frame(frame.idx, padded(v, np.float32),
                      padded(frame.normals.cpu().numpy(), np.float32), fm),
                padded(self.canonical_mult.cpu().numpy(), np.float32))

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

    def _fixed_track_pose(self, depth_mm: torch.Tensor) -> None:
        """Fixed mode's camera pose (source: dynfusion.py:921-946): the
        gather ICP of the current depth pyramid against the raycast pyramid
        of the model (self.prev_pyr, refreshed after every frame); identity
        increment before the first refresh or when the ICP is degenerate."""
        packed = None
        if self.prev_pyr is not None:
            _, curr_pyr = self._preprocess(depth_mm)
            packed = self._track_gather(curr_pyr, self.prev_pyr)
        if packed is not None and packed[12] != 0.0:
            self._push_pose(packed)
        else:
            self.poses.append(self.poses[-1])

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
                # frame 0 runs no ICP (dyn_fusion.cpp:53-65)
                del filtered
            self.vol = tv.integrate(self.vol, dists, self.poses[-1], p.intr,
                                    self.tsdf_config)
            frame = self._mc_frame(0)
            # node sampling strides the SOUP (dyn_fusion.cpp:151), before
            # the dedup; with foreground tracking, the box's vertices only
            node_mask = frame.mask
            if self._fg_enabled():
                node_mask = node_mask & _in_box(frame.vertices, dp.fg_aabb)
            self.warpfield = _sample_nodes(
                frame.vertices, node_mask, dp.max_nodes, dp.node_sample_step,
                dp.init_node_dg_w_factor * dp.epsilon)
            if self.mode != "fusion":
                frame = self._dedup_canonical(frame)
                if self._fg_enabled():
                    self._fg_canonical, self._fg_mult = \
                        self._fg_compact(frame)
            elif dp.corr_unique_edges:
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
            self.canonical = frame
            self.canonical_warped = frame
            self.frame_counter += 1
            return False

        if self.mode == "fusion":
            c = self.canonical
            if dp.fusion_camera_tracking:
                with _stage("track"):
                    self._fusion_track_pose(depth_mm)
            else:
                self.poses.append(self.poses[-1])
            (self.vol, self.warpfield, new_v, new_n, new_m, n_verts, wv2,
             wn2, self.last_frame_stats) = _fusion_frame(
                self.vol, self.warpfield, c.vertices, c.normals, c.mask,
                depth_mm, self.poses[-1], dp=dp, intr=p.intr,
                config=self.tsdf_config,
                solve_enabled=self.frame_counter > dp.fusion_warmup_frames)
            self.canonical = Frame(self.frame_counter, new_v, new_n, new_m)
            self.canonical_warped = Frame(self.frame_counter, wv2, wn2, new_m)
            self.live = self.canonical_warped
            # the unique edge vertices leave the soup to mesh()
            self.mesh_vertices = (None if dp.corr_unique_edges
                                  else (new_v, n_verts))
            self.last_solve_stats = self.last_frame_stats.solve
            self.frame_counter += 1
            return True

        parity = self.mode == "parity"
        if parity:
            self.poses.append(self.poses[-1])  # identity (dyn_fusion.cpp:102)
        else:
            self._fixed_track_pose(depth_mm)
        if self._fg_enabled():
            c, cmult = self._fg_canonical, self._fg_mult
        else:
            c, cmult = self.canonical, self.canonical_mult
        (self.vol, self.warpfield, wv, wn, live, mesh,
         self.last_frame_stats) = _nonrigid_frame(
            self.vol, self.warpfield, c.vertices, c.normals, c.mask,
            depth_mm, self.poses[-1], dp=dp, intr=p.intr,
            config=self.tsdf_config, parity=parity, canonical_mult=cmult)
        self.canonical_warped = Frame(c.idx, wv, wn, c.mask)
        self.live = Frame(self.frame_counter, *live)
        # the unique edge vertices leave the soup to mesh()
        self.mesh_vertices = (None if dp.corr_unique_edges and parity
                              else mesh)
        self.last_solve_stats = self.last_frame_stats.solve
        if not parity:
            # the next frame's ICP reference: the model raycast from the new
            # pose (KinFu::operator()'s raycast stage)
            pts, nrm = tv.raycast(self.vol, self.poses[-1], p.intr,
                                  (p.rows, p.cols), self.tsdf_config)
            self.prev_pyr = icp.build_pyramids(pts, nrm, self.levels)
        self.frame_counter += 1
        return True

    def mesh(self):
        """The last extracted triangle soup (vertex buffer, count); with
        unique edge vertices (parity and fusion mode) marching cubes runs
        on demand on the retained volume."""
        if self.mesh_vertices is None:
            v, n, _ = self._marching_cubes()
            self.mesh_vertices = (v, n)
        return self.mesh_vertices

    def _full_canonical_warped(self) -> Frame:
        """canonical_warped over the full canonical: with foreground
        tracking the frame warps only the box, so the full canonical is
        warped here, on demand (DQB; its background sees ~zero node weight
        and stays put)."""
        if not self._fg_enabled():
            return self.canonical_warped
        c = self.canonical
        wv, wn = wfield.warp_points_normals(self.warpfield, c.vertices,
                                            c.normals)
        return Frame(c.idx, wv, wn, c.mask)

    def _expand_to_soup(self, frame: Frame) -> Frame:
        """A unique-granularity frame in the frame-0 soup's order (fusion
        mode's canonical is the unique set already)."""
        if self.soup_inverse is None:
            return frame
        idx = torch.clamp_max(self.soup_inverse,
                              frame.vertices.shape[0] - 1).long()
        m = self.soup_mask[:, None]
        return Frame(frame.idx, torch.where(m, frame.vertices[idx], 0.0),
                     torch.where(m, frame.normals[idx], 0.0), self.soup_mask)

    def get_canonical_warped_to_live(self) -> Frame:
        """The full canonical warped to the live frame, in soup order."""
        return self._expand_to_soup(self._full_canonical_warped())

    def warped_cloud(self, unique: bool = False):
        """Current warped canonical vertices and mask over the full
        canonical: at unique-vertex granularity, or expanded back to the
        frame-0 soup order."""
        f = self._full_canonical_warped()
        if not unique:
            f = self._expand_to_soup(f)
        return f.vertices, f.mask

    def render(self, flag: int = 0) -> torch.Tensor:
        """Offline render of the current volume from the current camera
        pose (replaces the reference's OpenCV Viz window): the per-ray
        raycast (the source raycasts through its TPU formulations), shaded
        as KinFu.render shades; prev_pyr (fixed mode's ICP reference) is
        not touched."""
        p = self.params
        pts, nrm = tv.raycast(self.vol, self.poses[-1], p.intr,
                              (p.rows, p.cols), self.tsdf_config)
        return self._render(pts, nrm, flag)
