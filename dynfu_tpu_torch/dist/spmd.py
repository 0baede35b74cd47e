"""The rank's view of the layout, the collectives the layout needs, the
raycast over the blocks and the per-frame fusion step.

Port of dynfu_tpu/dist/spmd.py (make_mesh, shard_volume,
sharded_fusion_step). There the mesh is a jax.sharding.Mesh and XLA places
the collectives; here `Mesh` is one rank's view (rank, world, device,
backend) and each collective is written out, in rank order:

* the volume is block-partitioned along x: rank r holds planes
  block(X) = [r X / world, (r + 1) X / world) (`shard_volume`);
  `halo_slab` adds `width` of the neighbours' boundary planes on each side
  (one all_gather; 1 for marching cubes and the parity edges, 2 for the
  band dilation and the gradient normals of fusion mode),
  `gather_volume` rebuilds the whole volume (rank 0 uses it for meshes,
  renders and checkpoints);
* vertex buffers split into `world` contiguous row ranges (`block` of
  the row count), put back together by `all_gather_rows`;
* `prefix` (one all_gather of a few counts) gives a block its offset in
  scan order and the totals, for capacities that hold over all blocks
  and for the counts summed over ranks.

`sharded_raycast` sweeps every ray on every rank over the block's own
samples and combines the ranks' records by select, never by a float sum;
`sharded_fusion_step` is the source's step (integrate, separable raycast,
warp, GN solve over the raycast's rows, warp) on it.

A mesh without a process group (one rank) needs no collective: each is the
identity there. A process group of one rank (world 1 over NCCL, say) runs
them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from dynfu_tpu_torch.dist.runtime import rank_device
from dynfu_tpu_torch.volume import sweep_cuda
from dynfu_tpu_torch.volume import tsdf as tv


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh of `world` ranks along the volume's
    x axis."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str]  # None: one rank, no process group

    def block(self, n: int, rank: Optional[int] = None):
        """[lo, hi) of `rank`'s (default: this rank's) share of n planes or
        rows."""
        r = self.rank if rank is None else rank
        return r * n // self.world, (r + 1) * n // self.world

    def halo(self, X: int, width: int = 1):
        """Planes held below and above this rank's block in `halo_slab`."""
        lo, hi = self.block(X)
        return width * int(lo > 0), width * int(hi < X)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The calling rank's mesh: the process group's ranks (one rank
    without a process group). n_devices, if given, must equal the world."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    if n_devices and n_devices != world:
        raise ValueError(f"{n_devices} devices asked for, {world} rank(s) in "
                         "the process group (dist.runtime.init_distributed "
                         "or spawn starts them)")
    return Mesh(rank, world, rank_device(device), backend)


# --- collectives ----------------------------------------------------------


def all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's `t` (the same shape on every rank), in rank order."""
    if mesh.backend is None:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t)
    return out


def prefix(counts, mesh: Mesh):
    """Per count (ints or 0-d tensors of this rank): (sum over the ranks
    before this one, sum over all ranks), as Python ints."""
    local = torch.as_tensor([int(c) for c in counts], dtype=torch.int64,
                            device=mesh.device)
    every = torch.stack(all_gather(local, mesh)).cpu()  # (world, k)
    return (every[:mesh.rank].sum(0).tolist(), every.sum(0).tolist())


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    n: Optional[int] = None) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order. The ranks hold
    `mesh.block(n)` rows each (n given), or any numbers of rows (one more
    gather for the counts)."""
    if mesh.backend is None:
        return t
    if n is None:
        sizes = torch.cat(all_gather(torch.tensor(
            [t.shape[0]], device=mesh.device), mesh)).tolist()
    else:
        sizes = [hi - lo for lo, hi in (mesh.block(n, r)
                                        for r in range(mesh.world))]
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
    parts = all_gather(t, mesh)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


# --- the volume -----------------------------------------------------------


def shard_volume(vol: tv.TsdfVolume, mesh: Mesh) -> tv.TsdfVolume:
    """The rank's x-block of a whole volume (the pose replicated)."""
    lo, hi = mesh.block(vol.tsdf.shape[0])
    return vol._replace(tsdf=vol.tsdf[lo:hi].clone(),
                        weight=vol.weight[lo:hi].clone())


def _planes(tsdf: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(n, Y, Z, 3) uint8: each plane's float16 tsdf bytes and weight."""
    return torch.cat([tsdf.contiguous().view(torch.uint8).reshape(
        tsdf.shape + (2,)), weight[..., None]], -1)


def _unplanes(b: torch.Tensor):
    tsdf = b[..., :2].contiguous().view(torch.float16)[..., 0]
    return tsdf, b[..., 2].contiguous()


def halo_slab(vol: tv.TsdfVolume, mesh: Mesh, X: int, width: int = 1):
    """The block with the lower neighbour's last `width` planes below it and
    the upper neighbour's first `width` planes above it, where they exist:
    (slab volume, (h0, h1)). One all_gather of every block's boundary
    planes; every block must hold at least `width` planes."""
    h0, h1 = mesh.halo(X, width)
    if mesh.backend is None:
        return vol, (h0, h1)
    if min(hi - lo for lo, hi in (mesh.block(X, r)
                                  for r in range(mesh.world))) < width:
        raise ValueError(f"a halo of {width} planes needs blocks of at "
                         f"least {width} planes: {X} planes on "
                         f"{mesh.world} ranks")
    ends = list(range(width)) + list(range(-width, 0))
    every = all_gather(_planes(vol.tsdf[ends], vol.weight[ends]), mesh)
    below = [_unplanes(every[mesh.rank - 1][width:])] if h0 else []
    above = [_unplanes(every[mesh.rank + 1][:width])] if h1 else []
    tsdf, weight = (torch.cat([p[i] for p in below] + [block]
                              + [p[i] for p in above])
                    for i, block in enumerate((vol.tsdf, vol.weight)))
    return vol._replace(tsdf=tsdf, weight=weight), (h0, h1)


def gather_volume(vol: tv.TsdfVolume, mesh: Mesh, X: int) -> tv.TsdfVolume:
    """The whole volume from the blocks (on every rank)."""
    if mesh.backend is None:
        return vol
    tsdf, weight = _unplanes(all_gather_rows(_planes(vol.tsdf, vol.weight),
                                             mesh, X))
    return vol._replace(tsdf=tsdf, weight=weight)


# --- the raycast over the blocks ------------------------------------------


def sharded_raycast(vol: tv.TsdfVolume, mesh: Mesh, X: int, camera_pose,
                    intr, shape, config: tv.TsdfConfig):
    """tv.raycast_separable of the whole volume, from the rank's x-block
    `vol` (the pose replicated): (points, normals, n_straddle) on every
    rank, the points and normals the single card's bit for bit; n_straddle
    (a 0-d tensor) counts the hits whose crossing pair of samples lies in
    two blocks.

    A sample belongs to the block holding its lower x plane; the block's
    slab stack with a 1-plane halo above also holds the upper one. A ray's
    x is monotonic in z, so its samples in a block form one run: every rank
    sweeps every ray over its own samples (sweep_cuda.slab_sweep in block
    mode: per ray the run's first event and its first and last samples, 16
    int32), one all_gather of the records gives every rank each ray's
    first event over all blocks, a pair across a face judged from the two
    blocks' samples (sweep_cuda.sweep_resolve, with the single card's
    device functions). Nothing gathers the volume."""
    if mesh.backend is None:
        pts, nrm = tv.raycast_separable(vol, camera_pose, intr, shape, config)
        return pts, nrm, torch.zeros((), dtype=torch.int64,
                                     device=pts.device)
    slab, (h0, _) = halo_slab(vol, mesh, X, width=1)
    lo, hi = mesh.block(X)
    geo, rays = tv.separable_rays(vol, camera_pose, intr, shape)
    spec = tv.sweep_spec("separable", shape, config)
    rec = sweep_cuda.slab_sweep(sweep_cuda.slab_stack(slab.tsdf, spec.m),
                                geo, rays, spec, (lo - h0, lo, hi))
    pts, nrm, straddle = sweep_cuda.sweep_resolve(
        torch.stack(all_gather(rec, mesh)), geo, rays, spec)
    return pts, nrm, straddle.sum()


# --- the fusion step ------------------------------------------------------


def sharded_fusion_step(mesh: Mesh, config: tv.TsdfConfig, intr, shape,
                        solver_kwargs: Optional[dict] = None):
    """The per-frame fusion step over `mesh` (dynfu_tpu/dist/spmd.py:61-120),
    in the fixed pipeline's shape: its vertex set is the raycast's point
    map, whose rows are sharded over the ranks for the GN solve.

    Returns step(vol, depth_mm, wf, camera_pose) -> (vol', wf', warped_pts,
    stats), the source's four outputs: the volume the rank's x-block (from
    `shard_volume`), warped_pts the rank's rows mesh.block(H * W) of the
    warped point map (NaN where the raycast missed), the node state and the
    SolveStats replicated. Each rank clears and integrates its block (the
    source's separable integrate, per voxel), raycasts the
    whole image over the blocks with the source's separable sweep
    (`sharded_raycast`),
    warps its rows (DQB), and solves for node translations with the warped
    rows as the solve's canonical and the raycast rows as its live points
    (the source's order): the k-NN per row, the data Gram and c0 as float64
    partials reduced in rank order (dist/shard_gram.py), the rest
    replicated; then warps its rows again. Every rank calls step together.
    With one rank (no process group) the step is the single card's
    composition of these stages; the answer on any number of ranks is its
    answer, bit for bit, but for float64 rounding ties in the Gram.

    The source also bilateral-filters the depth and never reads the result
    (XLA drops it); the port does not compute it. `step.last_raycast` holds
    the last call's (points, normals, n_straddle) of the whole image."""
    # imported here: shard_gram imports this module
    from dynfu_tpu_torch.dist import shard_gram
    from dynfu_tpu_torch.ops import imgproc
    from dynfu_tpu_torch.solver import gn
    from dynfu_tpu_torch.warp import field as wfield

    H, W = shape
    X = config.dims[0]
    x0 = mesh.block(X)[0]
    lo, hi = mesh.block(H * W)
    solver_kwargs = dict(solver_kwargs or {})
    data_normal_fn = shard_gram.data_normal_fn(mesh)

    def step(vol, depth_mm, wf, camera_pose):
        depth_mm = torch.as_tensor(depth_mm, dtype=torch.int32,
                                   device=vol.tsdf.device)
        dists = imgproc.compute_dists(depth_mm, intr)
        vol = tv.integrate(vol, dists, camera_pose, intr, config, fresh=True,
                           x0=x0, separable=True)
        pts, nrm, n_straddle = sharded_raycast(vol, mesh, X, camera_pose,
                                               intr, shape, config)
        step.last_raycast = (pts, nrm, n_straddle)
        verts = pts.reshape(-1, 3)[lo:hi]
        vmask = ~torch.isnan(verts[:, 0])
        verts = torch.nan_to_num(verts)
        normals = torch.nan_to_num(nrm.reshape(-1, 3)[lo:hi])
        warped, _ = wfield.warp_points_normals(wf, verts, normals)
        wf2, stats = gn.solve(wf, warped, verts, vert_mask=vmask,
                              data_normal_fn=data_normal_fn, **solver_kwargs)
        warped2, _ = wfield.warp_points_normals(wf2, verts, normals)
        warped2 = torch.where(vmask[:, None], warped2, torch.nan)
        return vol, wf2, warped2, stats

    step.last_raycast = None
    return step
