"""DynamicFusion orchestrator: the non-rigid frame loop, parity mode.

Port of the parity mode of dynfu_tpu/engine/dynfusion.py (the reference's
DynFusion::operator(), dyn_fusion.cpp:48-144):

  frame 0: dists, bilateral -> integrate -> marching cubes -> canonical
    (triangle soup; normals are a placeholder copy of the vertices, the
    reference's workaround) -> every 128th soup vertex becomes a node ->
    one host dedup of the canonical soup.
  frame k: pose stays identity -> dists -> clear + integrate -> marching
    cubes -> warp the canonical with the current field -> 1-NN
    correspondence (live vertex -> warped canonical vertex), fetching the
    solve's data graph with it -> GN solve -> node insertion.

The frame runs eagerly on the engine's device; the hot stages are the
hand-written kernels (mesh/mc_cuda, ops/warp_cuda, ops/knn_cuda,
ops/corr_cuda, solver/gram_cuda).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dynfu_tpu_torch.core import dualquat as dq
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.engine.params import DynFuParams
from dynfu_tpu_torch.mesh.mc import marching_cubes
from dynfu_tpu_torch.ops import imgproc, knn
from dynfu_tpu_torch.solver import gn
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
    live_v, n_verts, mc_dropped = marching_cubes(
        vol, config, max_voxels=dp.max_mc_voxels, max_verts=dp.max_vertices)
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
    return vol, wf, wv, wn, stats


class DynFusion(KinFu):
    """Non-rigid fusion engine, parity mode. Call with (H, W) integer mm
    depth images (numpy or tensor)."""

    def __init__(self, params: Optional[DynFuParams] = None, device="cuda"):
        self.dynfu_params = params or DynFuParams.default_params()
        super().__init__(self.dynfu_params.kinfu, device)
        self.warpfield: Optional[wfield.WarpField] = None
        self.canonical: Optional[Frame] = None
        self.canonical_warped: Optional[Frame] = None
        # canonical dedup state: the frame-0 soup holds each mesh vertex
        # ~6x; the per-frame passes run on the unique set
        self.soup_inverse = None  # (max_vertices,) int32 -> unique slot
        self.soup_mask = None  # (max_vertices,) bool
        self.canonical_mult = None  # (Ucap,) f32 soup multiplicity
        self.last_frame_stats: Optional[FrameStats] = None
        self.last_solve_stats: Optional[gn.SolveStats] = None

    def _mc_frame(self, idx: int) -> Frame:
        dp = self.dynfu_params
        verts, n_verts, _ = marching_cubes(
            self.vol, self.tsdf_config, max_voxels=dp.max_mc_voxels,
            max_verts=dp.max_vertices)
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

    def _depth(self, depth_mm) -> torch.Tensor:
        if isinstance(depth_mm, torch.Tensor):
            return depth_mm.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(depth_mm).astype(np.int32),
                               device=self.device)

    def __call__(self, depth_mm, image=None) -> bool:
        """Frame ingestion; `image` is accepted and unused, as in the
        reference. Returns False for the bootstrap frame."""
        del image
        dp = self.dynfu_params
        p = self.params
        depth_mm = self._depth(depth_mm)

        if self.frame_counter == 0:
            dists = imgproc.compute_dists(depth_mm, p.intr)
            filtered = imgproc.bilateral_filter(
                depth_mm, p.bilateral_kernel_size, p.bilateral_sigma_spatial,
                p.bilateral_sigma_depth)
            if p.icp_truncate_depth_dist > 0:
                filtered = imgproc.truncate_depth(filtered,
                                                  p.icp_truncate_depth_dist)
            del filtered  # the parity loop runs no ICP (dyn_fusion.cpp:53-65)
            self.vol = tv.integrate(self.vol, dists, self.poses[-1], p.intr,
                                    self.tsdf_config)
            frame = self._mc_frame(0)
            # node sampling strides the SOUP (dyn_fusion.cpp:151), before
            # the dedup
            self.warpfield = _sample_nodes(
                frame.vertices, frame.mask, dp.max_nodes, dp.node_sample_step,
                dp.init_node_dg_w_factor * dp.epsilon)
            frame = self._dedup_canonical(frame)
            self.canonical = frame
            self.canonical_warped = frame
            self.frame_counter += 1
            return False

        self.poses.append(self.poses[-1])  # identity (dyn_fusion.cpp:102)
        c = self.canonical
        (self.vol, self.warpfield, wv, wn,
         self.last_frame_stats) = _nonrigid_frame(
            self.vol, self.warpfield, c.vertices, c.mask, depth_mm,
            self.poses[-1], dp=dp, intr=p.intr, config=self.tsdf_config,
            canonical_mult=self.canonical_mult)
        self.canonical_warped = Frame(c.idx, wv, wn, c.mask)
        self.last_solve_stats = self.last_frame_stats.solve
        self.frame_counter += 1
        return True

    def warped_cloud(self, unique: bool = False):
        """Current warped canonical vertices and mask: at unique-vertex
        granularity, or expanded back to the frame-0 soup order."""
        f = self.canonical_warped
        if unique or self.soup_inverse is None:
            return f.vertices, f.mask
        idx = torch.clamp_max(self.soup_inverse, f.vertices.shape[0] - 1)
        v = torch.where(self.soup_mask[:, None], f.vertices[idx.long()], 0.0)
        return v, self.soup_mask
