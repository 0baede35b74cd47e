"""The sharded engine driver: frame-0 bootstrap, then sharded frames.

Port of dynfu_tpu/dist/driver.py:36-158, parity and fusion mode. Every rank
builds a `ShardedDynFusion` and calls it with the same depth frames:

* frame 0 bootstraps through the plain `DynFusion` on every rank (marching
  cubes, node sampling, the host dedup of the canonical or fusion mode's
  edge extraction: the same on every rank), then the volume is sharded
  along x (`reshard`);
* frames k >= 1 run `sharded_engine_frame` (parity: the volume stays
  blocked, the warped canonical row-sharded and the live set per block) or
  `sharded_fusion_frame` (fusion: the volume blocked, the re-extracted
  canonical and its warp replicated; the warm-up step without a solve for
  the first fusion_warmup_frames frames, as the engine switches), on the
  rank's device, with no host round trip of the state;
* the outputs and checkpoints read the engine's attributes as the plain
  engine's do: `warped_cloud()`, `live_cloud()`, `mesh()`, `render()` and
  `gathered()` are collective (every rank calls them together) and put the
  pieces back together (render returns the image on rank 0 only).

`utils.checkpoint` saves a driver from its gathered state on rank 0 and
loads one on every rank, then shards it again (`reshard`), as the source's
driver re-places a restored state.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from dynfu_tpu_torch.dist import engine_spmd, spmd
from dynfu_tpu_torch.dist.runtime import is_primary
from dynfu_tpu_torch.engine.dynfusion import DynFusion, Frame
from dynfu_tpu_torch.engine.params import DynFuParams
from dynfu_tpu_torch.mesh.mc import marching_cubes


class ShardedDynFusion:
    """DynFusion over the ranks of a mesh, with the engine's call surface:
    `__call__(depth_mm) -> bool`, `warped_cloud()`, `canonical`,
    `last_frame_stats`, `poses`, `mesh()`, `render()`, `frame_counter`."""

    def __init__(self, params: Optional[DynFuParams] = None,
                 mode: str = "parity", n_devices: int = 0,
                 mesh: Optional[spmd.Mesh] = None, device="cuda"):
        if mode not in ("parity", "fusion"):
            raise NotImplementedError(
                "the sharded driver supports parity and fusion mode; fixed "
                "mode's rigid-ICP pyramid chaining is single-device")
        if mode == "fusion" and params is not None \
                and params.fusion_camera_tracking:
            raise NotImplementedError(
                "fusion_camera_tracking on the sharded driver: the source's "
                "sharded driver drops the camera pose; the port raises "
                "(ROADMAP.md section 1, item 2)")
        self.mode = mode
        self.spmd = mesh if mesh is not None else spmd.make_mesh(
            n_devices or None, device)
        self.engine = DynFusion(params, device=self.spmd.device, mode=mode)
        self._step = self._step_warmup = None
        self._warped = None  # the warped canonical's rows (wv, wn)
        self._soup = None  # the block's marching-cubes soup (verts, n)

    # -- engine surface ----------------------------------------------------
    @property
    def frame_counter(self):
        return self.engine.frame_counter

    @property
    def poses(self):
        return self.engine.poses

    @property
    def canonical(self):
        return self.engine.canonical

    @property
    def last_frame_stats(self):
        return self.engine.last_frame_stats

    @property
    def device(self):
        return self.spmd.device

    def _tracked(self):
        """(canonical, soup multiplicities) the frames warp and solve: the
        foreground box's with foreground tracking."""
        e = self.engine
        if e._fg_enabled():
            return e._fg_canonical, e._fg_mult
        return e.canonical, e.canonical_mult

    def reshard(self) -> None:
        """Shard the engine's whole state (after frame 0, or a restored
        checkpoint): the volume's x-block on this rank, the rest
        replicated."""
        e = self.engine
        e.vol = spmd.shard_volume(e.vol, self.spmd)
        self._warped = self._soup = None
        if self._step is not None:
            return
        args = (self.spmd, e.dynfu_params, e.params.intr, e.tsdf_config)
        if self.mode == "parity":
            self._step = engine_spmd.sharded_engine_frame(*args)
            return
        self._step = engine_spmd.sharded_fusion_frame(*args)
        if e.dynfu_params.fusion_warmup_frames > 0:
            self._step_warmup = engine_spmd.sharded_fusion_frame(
                *args, solve_enabled=False)

    def __call__(self, depth_mm, image=None) -> bool:
        del image
        e = self.engine
        if e.frame_counter == 0:
            ok = e(depth_mm)  # the plain bootstrap, on every rank
            self.reshard()
            return ok
        depth = e._depth(depth_mm)
        e.poses.append(e.poses[-1])  # identity (dyn_fusion.cpp:102)
        if self.mode == "fusion":
            self._fusion(depth)
            return True
        c, mult = self._tracked()
        (e.vol, e.warpfield, wv, wn, live_v, live_n, live_m, mesh_verts,
         n_verts, e.last_frame_stats) = self._step(
            e.vol, e.warpfield, c.vertices, c.normals, c.mask, depth,
            e.poses[-1], mult)
        self._warped = (wv, wn)
        e.live = Frame(e.frame_counter, live_v, live_n, live_m)
        self._soup = (None if e.dynfu_params.corr_unique_edges
                      else (mesh_verts, n_verts))
        e.mesh_vertices = None
        e.last_solve_stats = e.last_frame_stats.solve
        e.frame_counter += 1
        return True

    def _fusion(self, depth) -> None:
        """Fusion frame k >= 1: the warm-up step (no solve) for the first
        fusion_warmup_frames frames, as DynFusion switches."""
        e = self.engine
        c = e.canonical
        step = self._step
        if (self._step_warmup is not None
                and e.frame_counter <= e.dynfu_params.fusion_warmup_frames):
            step = self._step_warmup
        (e.vol, e.warpfield, new_v, new_n, new_m, n_verts, wv2, wn2,
         e.last_frame_stats) = step(e.vol, e.warpfield, c.vertices,
                                    c.normals, c.mask, depth, e.poses[-1])
        e.canonical = Frame(e.frame_counter, new_v, new_n, new_m)
        e.canonical_warped = Frame(e.frame_counter, wv2, wn2, new_m)
        e.live = e.canonical_warped
        # the unique edge vertices leave the soup to mesh()
        e.mesh_vertices = (None if e.dynfu_params.corr_unique_edges
                           else (new_v, n_verts))
        e.last_solve_stats = e.last_frame_stats.solve
        self._soup = None
        e.frame_counter += 1

    # -- collective outputs --------------------------------------------------
    def _canonical_warped(self) -> Frame:
        """The whole warped (tracked) canonical, from every rank's rows."""
        c = self._tracked()[0]
        if self._warped is None:  # bootstrap or restored: replicated
            return self.engine.canonical_warped
        n = c.vertices.shape[0]
        both = spmd.all_gather_rows(torch.cat(self._warped, 1), self.spmd, n)
        return Frame(c.idx, both[:, :3], both[:, 3:], c.mask)

    @contextlib.contextmanager
    def gathered(self, volume: bool = True):
        """The engine with its whole state installed in place of this
        rank's pieces (the gathered volume and warped canonical); restored
        after."""
        e = self.engine
        saved = (e.vol, e.canonical_warped)
        e.canonical_warped = self._canonical_warped()
        if volume:
            e.vol = spmd.gather_volume(e.vol, self.spmd,
                                       e.tsdf_config.dims[0])
        try:
            yield e
        finally:
            e.vol, e.canonical_warped = saved

    def warped_cloud(self, unique: bool = False):
        """The engine's warped_cloud over every rank's rows."""
        with self.gathered(volume=False) as e:
            return e.warped_cloud(unique)

    def live_cloud(self):
        """(vertices, mask) of the last frame's live set over every block,
        in the single card's buffer: rank 0's vertices first."""
        live = self.engine.live
        if self.mode == "fusion":  # the warped canonical, replicated
            return live.vertices, live.mask
        cap = live.vertices.shape[0]
        v = spmd.all_gather_rows(live.vertices[live.mask], self.spmd)
        out = live.vertices.new_zeros((cap, 3))
        out[:v.shape[0]] = v
        return out, torch.arange(cap, device=out.device) < v.shape[0]

    def mesh(self):
        """The triangle soup (vertex buffer, count) of the last frame over
        every block; with unique edges (or after a restore) marching cubes
        runs on demand on the blocks."""
        e = self.engine
        dp = e.dynfu_params
        if self._soup is None and e.mesh_vertices is not None:
            # the bootstrap's, or fusion mode's canonical soup: replicated
            return e.mesh_vertices
        if self._soup is None:
            X = e.tsdf_config.dims[0]
            slab, halo = spmd.halo_slab(e.vol, self.spmd, X)
            v, n, _ = marching_cubes(
                slab, e.tsdf_config, max_voxels=dp.max_mc_voxels,
                max_verts=dp.max_vertices, col_budget=dp.mc_col_budget,
                convention="corner" if self.mode == "fusion" else "center",
                x0=self.spmd.block(X)[0], halo=halo,
                prefix=lambda counts: spmd.prefix(counts, self.spmd))
            self._soup = (v, n)
        v, n = self._soup
        rows = spmd.all_gather_rows(v[:int(n)], self.spmd)
        out = v.new_zeros(v.shape)
        out[:rows.shape[0]] = rows
        return out, torch.tensor(rows.shape[0], dtype=torch.int32,
                                 device=v.device)

    def render(self, flag: int = 0):
        """The engine's render of the gathered volume, on rank 0 (None on
        the other ranks)."""
        with self.gathered() as e:
            return e.render(flag) if is_primary() else None
