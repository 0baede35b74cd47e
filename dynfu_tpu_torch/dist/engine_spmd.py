"""The parity and fusion engine frames over the ranks of a mesh.

Port of dynfu_tpu/dist/engine_spmd.py (sharded_engine_frame,
sharded_fusion_frame, place_engine_state, sharding_overhead). The layout is
the source's, each collective written out (dist/spmd.py):

* the TSDF volume is block-partitioned along x; integrate is per voxel on
  the block; the edge extraction (or, without unique edges, marching
  cubes) reads the neighbours' boundary planes and applies its capacities
  over all blocks, so each block's live vertices are, in rank order, the
  single card's;
* the canonical (static after frame 0) is replicated and its warp split
  into row ranges (dist/shard_warp.py); the warped canonical is kept
  row-sharded;
* the correspondence runs per rank on its block's live set against the
  replicated warped canonical, the graph payload computed per rank;
* the GN data Gram and c0 are each rank's float64 partials, reduced in
  rank order (dist/shard_gram.py); the PCG and node insertion run
  replicated, on identical inputs, so the node state stays identical.

There is one path and it runs the port's kernels on every rank (the source
also has a GSPMD trace without its kernels). The non-strict frame
(`strict_parity=False`, the fixed pipeline's) runs the same way, with the
pose given: each block's marching-cubes soup, its gradient normals from 3
halo planes, the GN data Gram or the SE(3) solve's monomial Grams as
float64 partials in rank order. The sharded driver refuses fixed mode, as
the source's does (its ICP tracks against a raycast of the whole volume).

Fusion mode (`sharded_fusion_frame`, the persistent canonical volume) keeps
the volume blocked the same way, with a halo of 2 planes for the band's
dilation and the gradient normals; its canonical is re-extracted every
frame, so it is replicated: each block's vertices and normals, gathered in
rank order (the scan order), are the single card's buffer, padding
included. The pre-solve warp, the projective association, the solve's data
rows and the insertion warp run on each rank's row range of it; the
solve's sums (the monomial Grams and data costs of the SE(3) solve, or the
data Gram) are float64 partials reduced in rank order, and node insertion
runs replicated on the gathered insertion warp.
"""

from __future__ import annotations

import time

import torch

from dynfu_tpu_torch.dist import runtime, shard_gram, shard_warp, spmd
from dynfu_tpu_torch.engine import dynfusion as dyn
from dynfu_tpu_torch.engine.params import DynFuParams
from dynfu_tpu_torch.utils.timers import sync
from dynfu_tpu_torch.volume import tsdf as tv


def shard_kernels(mesh: spmd.Mesh, config: tv.TsdfConfig) -> dyn.ShardKernels:
    """The rank's sharded stages of the parity and fixed frames."""
    X = config.dims[0]
    return dyn.ShardKernels(
        x0=mesh.block(X)[0],
        halo_fn=lambda vol, width=1: spmd.halo_slab(vol, mesh, X, width),
        prefix=lambda counts: spmd.prefix(counts, mesh),
        warp_fn=lambda wf, cv, cn: shard_warp.warp_points_normals_sharded(
            mesh, wf, cv, cn),
        gram_fn=shard_gram.data_normal_fn(mesh),
        data_term=shard_gram.monomial_grams_fn(mesh))


def fusion_shard_kernels(mesh: spmd.Mesh,
                         config: tv.TsdfConfig) -> dyn.FusionShardKernels:
    """The rank's sharded stages of the fusion frame."""
    X = config.dims[0]
    return dyn.FusionShardKernels(
        x0=mesh.block(X)[0],
        halo_fn=lambda vol, width: spmd.halo_slab(vol, mesh, X, width),
        prefix=lambda counts: spmd.prefix(counts, mesh),
        rows=mesh.block,
        gather_rows=lambda t, n=None: spmd.all_gather_rows(t, mesh, n),
        data_normal_fn=shard_gram.data_normal_fn(mesh),
        data_term=shard_gram.monomial_grams_fn(mesh))


def sharded_fusion_frame(mesh: spmd.Mesh, dp: DynFuParams, intr,
                         config: tv.TsdfConfig, solve_enabled: bool = True):
    """The engine's persistent-canonical `_fusion_frame` over `mesh`.

    Returns step(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
    pose) -> (vol, wf, mesh_verts, new_n, new_m, n_verts, wv2, wn2, stats),
    the source's nine outputs: the volume the rank's x-block, the rest
    replicated (the re-extracted canonical and its insertion warp in the
    single card's buffer, the node state, the stats with the counts summed
    over ranks). `solve_enabled=False` is the warm-up step (integrate
    without a solve, DynFuParams.fusion_warmup_frames). The inputs come from
    `place_engine_state`; every rank calls step together."""
    if dp.fusion_camera_tracking:
        raise NotImplementedError(
            "fusion_camera_tracking on the sharded engine: the source's "
            "sharded driver drops the camera pose; the port raises "
            "(ROADMAP.md section 1, item 2)")
    kern = fusion_shard_kernels(mesh, config)

    def step(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
             pose):
        return dyn._fusion_frame(
            vol, wf, canonical_v, canonical_n, canonical_m, depth_mm, pose,
            dp=dp, intr=intr, config=config, solve_enabled=solve_enabled,
            kernels=kern)

    return step


def sharded_engine_frame(mesh: spmd.Mesh, dp: DynFuParams, intr,
                         config: tv.TsdfConfig, strict_parity: bool = True,
                         integrate_mode: str = "separable",
                         with_mult: bool = False):
    """The engine's `_nonrigid_frame` over `mesh`: the parity frame, or with
    strict_parity=False the non-strict one (the fixed pipeline's frame:
    gradient normals on each block's marching-cubes soup, the warped
    vertices and normals fetched with the correspondence, the GN solve on
    its own graph, or DLB and the SE(3) solve with dp.solver_rotations; the
    pose comes in, as the source's, which tracks none). integrate_mode is
    the integrate for that pose (KinFu._integrate_mode: "separable",
    "rotated" or "gather"), per x-block. Fusion mode's frame is
    sharded_fusion_frame. with_mult is the source's switch for the step's
    trailing canonical_mult, which the step takes either way.

    Returns step(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm,
    pose, canonical_mult=None) -> (vol, wf, wv, wn, live_v, live_n, live_m,
    mesh_verts, n_verts, stats), the source's outputs: the volume the
    rank's x-block, the warped canonical (wv, wn) its rows mesh.block(N), the
    live set and the marching-cubes soup (mesh_verts, n_verts; the live set
    itself with unique edges) its block's, the node state and the stats
    (drop counts summed over ranks) replicated. The inputs come from
    `place_engine_state`; every rank calls step together."""
    del with_mult
    kern = shard_kernels(mesh, config)

    def step(vol, wf, canonical_v, canonical_n, canonical_m, depth_mm, pose,
             canonical_mult=None):
        (vol, wf, wv, wn, (live_v, live_n, live_m), (mesh_verts, n_verts),
         stats) = dyn._nonrigid_frame(
            vol, wf, canonical_v, canonical_n, canonical_m, depth_mm, pose,
            dp=dp, intr=intr, config=config, parity=strict_parity,
            canonical_mult=canonical_mult, kernels=kern,
            integrate_mode=integrate_mode)
        lo, hi = mesh.block(wv.shape[0])
        return (vol, wf, wv[lo:hi], wn[lo:hi], live_v, live_n, live_m,
                mesh_verts, n_verts, stats)

    return step


def place_engine_state(mesh: spmd.Mesh, vol, wf, canonical_v, canonical_n,
                       canonical_m, depth_mm, pose):
    """The state on the rank's device in the layout `sharded_engine_frame`
    expects: the volume's x-block, the rest replicated."""
    dev = mesh.device
    vol = spmd.shard_volume(tv.TsdfVolume(*(t.to(dev) for t in vol)), mesh)
    wf = type(wf)(*(t.to(dev) for t in wf))
    depth = torch.as_tensor(depth_mm, dtype=torch.int32, device=dev)
    return (vol, wf, canonical_v.to(dev), canonical_n.to(dev),
            canonical_m.to(dev), depth, pose)


def _overhead_scene(device):
    """The source's measurement scene: a 64^3 volume, 120x160 frames of a
    sphere 1.5 m away, frame 0 bootstrapped; (engine, next depth)."""
    from dynfu_tpu_torch.core.camera import Intr
    from dynfu_tpu_torch.engine.params import KinFuParams
    from dynfu_tpu_torch.io.datasets import sphere_depth

    rows, cols = 120, 160
    intr = Intr(131.25, 131.25, cols / 2 - 0.5, rows / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(rows=rows, cols=cols, intr=intr,
                          volume_dims=(64,) * 3),
        max_vertices=1 << 13, max_mc_voxels=1 << 11,
        max_nodes=128, max_new_nodes=64)
    engine = dyn.DynFusion(params, device=device)
    engine(sphere_depth((0.0, 0.0, 1.5), 0.5, rows, cols,
                        intr.fx, intr.fy, intr.cx, intr.cy))
    d1 = sphere_depth((0.01, 0.0, 1.5), 0.5, rows, cols,
                      intr.fx, intr.fy, intr.cx, intr.cy)
    return engine, d1


def _frame_ms(device: str, iters: int) -> float:
    """ms per sharded frame on this rank's mesh, the same frame repeated
    from the same state (every rank runs it)."""
    mesh = spmd.make_mesh(device=device)
    engine, d1 = _overhead_scene(mesh.device)
    c = engine.canonical
    step = sharded_engine_frame(mesh, engine.dynfu_params, engine.params.intr,
                                engine.tsdf_config)
    args = place_engine_state(mesh, engine.vol, engine.warpfield, c.vertices,
                              c.normals, c.mask, d1, engine.poses[-1])
    mult = engine.canonical_mult
    sync(step(*args, mult)[1].dqs)  # warm: kernel loads, allocator
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args, mult)
    sync(out[1].dqs)
    return (time.perf_counter() - t0) / iters * 1e3


def sharding_overhead(n_devices: int = 2, iters: int = 5,
                      device="cuda") -> dict:
    """ms per sharded engine frame at 1 rank (this process, no process
    group) and at n_devices local ranks (spawned; this process is rank 0),
    and their ratio, as the source measures it (engine_spmd.py:242-291).
    With ranks sharing a card this measures the collectives and the other
    processes, not scaling."""
    ms1 = _frame_ms(device, iters)
    msn = runtime.spawn(_frame_ms, n_devices, device, iters, device=device,
                        inline=True)
    cards = torch.cuda.device_count()
    return {"ms_1rank": ms1, f"ms_{n_devices}rank": msn,
            "overhead_x": msn / ms1,
            "backend": runtime.choose_backend(device, n_devices),
            "cards": cards}
