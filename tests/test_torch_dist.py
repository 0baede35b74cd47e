"""The sharded parity and fusion engines (dynfu_tpu_torch/dist) on the CPU,
over two gloo ranks, against the JAX package's dist/ on a 2-device sub-mesh
of conftest's virtual devices and against the port's single-card engine.

One `runtime.spawn` starts two ranks that run every sharded job
(dist/worker.py) and write their outputs to .npz files; the ranks never
import jax. Meanwhile JAX runs here (frames 0, the sharded fusion frames)
and in processes of its own (test_torch_fusion.JaxRefs: the kernels'
functions, the parity frame, the step's references). Then:

* the three sharded kernels' functions: the warp (JAX's kernel in
  interpret mode; the port's 2-rank result bitwise its 1-rank one), the
  tiered 1-NN (JAX's XLA path; the fetched point indices and the exactness
  flags equal) and the Gram (JAX interpret, within 1e-5 of the largest
  entry; the port's 2-rank result bitwise its 1-rank one);
* one sharded engine frame from JAX's frame-0 state, against JAX's
  sharded_engine_frame with the per-voxel integrate (the port's); the
  non-strict frame (strict_parity=False: the GN solve, and DLB with the
  SE(3) solve and the rotated integrate) on two ranks bitwise one rank's;
* the 2-rank ShardedDynFusion over 4 frames against the single-card
  DynFusion, bitwise, for marching cubes and unique edges, and with a
  capacity that overflows inside rank 1's block;
* runtime.init_distributed / is_primary / the backend choice, and
  run_dataset(devices=2) writing the exports of devices=1;
* fusion mode: the monomial Grams' float64 partial mode on two ranks
  (bitwise one rank's; JAX's kernel in interpret mode within 1e-5), one
  sharded fusion frame from JAX's frame-0 state against JAX's
  sharded_fusion_frame (SE(3) and translations), the 2-rank fusion driver
  over 4 frames bitwise the single card's (marching cubes with
  translations, unique edges with SE(3), a band capacity cut inside rank
  1's block after a warm-up frame), resumed from its checkpoint, and
  run_dataset(mode="fusion", devices=2) writing devices=1's exports;
* spmd.sharded_fusion_step on two ranks against one rank (bitwise, with
  hits across the block face on a slanted plane), against its body
  composed from JAX functions (the source step's separable integrate and
  raycast), and against JAX's own sharded_fusion_step.
"""

import contextlib
import dataclasses
import filecmp
import functools
import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.dist import engine_spmd as jengine_spmd
from dynfu_tpu.dist.shard_corr import nn1_xwindow_sharded as jnn1_sharded
from dynfu_tpu.dist.shard_gram import data_normal_sharded as jgram_sharded
from dynfu_tpu.dist.shard_warp import \
    warp_points_normals_sharded as jwarp_sharded
from dynfu_tpu.dist.spmd import make_mesh as jmake_mesh
from dynfu_tpu.dist.spmd import shard_volume as jshard_volume
from dynfu_tpu.dist.spmd import sharded_fusion_step as jsharded_fusion_step
from dynfu_tpu.engine.dynfusion import DynFusion as JDynFusion
from dynfu_tpu.engine.params import DynFuParams as JDynFuParams
from dynfu_tpu.engine.params import KinFuParams as JKinFuParams
from dynfu_tpu.io.datasets import sphere_depth
from dynfu_tpu.ops import imgproc as jimgproc
from dynfu_tpu.ops import knn_pallas
from dynfu_tpu.solver import gn as jgn
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.dist import runtime, shard_gram, spmd, worker
from dynfu_tpu_torch.engine import dynfusion as tdyn
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.io.app import dataset_params, run_dataset
from dynfu_tpu_torch.ops import compaction, imgproc, warp_cuda
from dynfu_tpu_torch.utils import convert
from dynfu_tpu_torch.volume import tsdf as tv

from test_torch_fusion import JaxRefs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ROWS, COLS = 120, 160
INTR = JIntr(131.25, 131.25, COLS / 2 - 0.5, ROWS / 2 - 0.5)
# the parameters of tests/test_dist.py's engine-frame tests
JPARAMS = JDynFuParams(
    kinfu=JKinFuParams(rows=ROWS, cols=COLS, intr=INTR,
                       volume_dims=(64, 64, 64)),
    max_vertices=1 << 13, max_mc_voxels=1 << 11, max_nodes=128,
    max_new_nodes=64)
PARAMS = convert.params(JPARAMS)
FRAMES = [sphere_depth((0.004 * i, 0.0, 1.5), 0.5, ROWS, COLS, INTR.fx,
                       INTR.fy, INTR.cx, INTR.cy) for i in range(4)]
# the drives: marching cubes, unique edges, and a capacity that overflows
# inside rank 1's block (the sphere straddles the block boundary x = 1.5 m;
# each block holds about half of its ~240 edge vertices and ~140 cells)
VARIANTS = {
    "mc": PARAMS,
    "edges": dataclasses.replace(PARAMS, corr_unique_edges=True,
                                 max_edge_verts=1 << 12),
    "edges_cap": dataclasses.replace(PARAMS, corr_unique_edges=True,
                                     max_edge_verts=200),
    "mc_cap": dataclasses.replace(PARAMS, max_mc_voxels=100),
}

# fusion mode: tests/test_dist.py's fusion-frame parameters and its next
# frame; the SE(3) frame with one relinearisation, as the 512^3 fusion
# preset has it (DynFuParams.caps_for_volume)
JFPARAMS = dataclasses.replace(JPARAMS, fusion_max_active=1 << 15)
JFPARAMS_SE3 = dataclasses.replace(JFPARAMS, solver_rotations=True,
                                   se3_relinearize=1)
FPARAMS = convert.params(JFPARAMS)
F_D1 = np.asarray(sphere_depth((0.008, 0.0, 1.5), 0.5, ROWS, COLS, INTR.fx,
                               INTR.fy, INTR.cx, INTR.cy), np.int32)
# the fusion drives: marching cubes with translations, unique edges with
# SE(3), and a band capacity cut inside rank 1's block (the band straddles
# the block boundary; rank 0's block holds about half of its ~3570 voxels)
# after a warm-up frame
BAND_CAP = 3000
FUSION_VARIANTS = {
    "mc_t": FPARAMS,
    "edges_se3": dataclasses.replace(FPARAMS, corr_unique_edges=True,
                                     max_edge_verts=1 << 12,
                                     solver_rotations=True),
    "band_cap": dataclasses.replace(FPARAMS, fusion_max_active=BAND_CAP,
                                    fusion_warmup_frames=1),
}
RESUME_AFTER = 1  # the resumed drive: edges_se3 saved after frame 1
# the non-strict engine frame (strict_parity=False) from the parity
# frame-0 state: the GN solve with the separable integrate, and DLB with
# the SE(3) solve with the rotated (homography) integrate
FIXED_FRAMES = {
    "fixed": (PARAMS, "separable"),
    "fixed_se3": (dataclasses.replace(PARAMS, solver_rotations=True),
                  "rotated"),
}
# the app in fusion mode: its 64^3 parameters with the capacities cut to
# the scene (the 640x480 umbrella frames' band holds ~20k voxels; the
# defaults' 2^19 band slots and 1024 nodes take minutes on the CPU)
APP_FUSION = dataclasses.replace(
    dataset_params((480, 640), 64), fusion_max_active=1 << 15,
    max_nodes=128, max_new_nodes=64, max_vertices=1 << 14)

# sharded_fusion_step: tests/test_dist.py's step scene (32^3 over 1 m,
# 24x32 pixels, the 3x3x2 node grid, planes at 0.62 then 0.605 m, the
# identity warp field), and a plane slanted in x (z = a / (1 - 0.8 xl) in
# the camera frame, a = 0.62 then 0.605 m) in a volume shifted four voxels
# left, whose surface crosses the block face (plane 16) where some rays'
# crossing pair of slab samples lies in two blocks (24 of ~670 hits a
# frame; with one voxel's shift, none); its nodes the grid moved by
# seeded offsets of up to 2 cm (no ties in the k-NN) with seeded small
# motions (the solve's residuals nonzero). Both solve with test_dist's 64
# CG iterations and the default regularisation (test_dist's lambda_reg = 0
# leaves the slanted scene's far nodes free, and its CG then diverges; on
# the planes the identity field's residuals are 0 under either)
S_SHAPE = (24, 32)
S_JINTR = JIntr(30.0, 30.0, 15.5, 11.5)
S_INTR = Intr(30.0, 30.0, 15.5, 11.5)
S_GEOM = dict(dims=(32, 32, 32), size=(1.0, 1.0, 1.0), trunc_dist=0.08,
              raycast_step_factor=0.3)
S_JCFG = jtv.TsdfConfig(z_chunk=8, **S_GEOM)
S_CFG = tv.TsdfConfig(**S_GEOM)


def _slant_depth(a, b=0.8):
    xl = (np.arange(S_SHAPE[1]) - S_JINTR.cx) / S_JINTR.fx
    z = a / (1.0 - b * xl)
    return np.broadcast_to((z * 1000).astype(np.int32), S_SHAPE).copy()


STEP_SCENES = ("planes", "slant")


@functools.lru_cache(maxsize=None)
def _step_scenes():
    """Per scene of STEP_SCENES: the depth frames, the volume's pose and the
    warp field (numpy tuples of the WarpField's fields); the camera is the
    identity. Built on first use (JAX makes the fields), not on import:
    every worker of the test gate imports this module."""
    nodes = np.stack(np.meshgrid(*[np.linspace(-0.3, 0.3, 3)] * 2,
                                 [0.6, 0.8], indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
    rng = np.random.RandomState(11)
    moved = jfield.init_warpfield(
        nodes + rng.uniform(-0.02, 0.02, nodes.shape).astype(np.float32),
        dqs=jdq.dq_from_rodrigues(
            jnp.asarray(rng.randn(18, 3).astype(np.float32) * 0.004),
            jnp.asarray(rng.randn(18, 3).astype(np.float32) * 0.004)),
        weights=1.0)
    eye = np.eye(3, dtype=np.float32)
    return {
        "planes": ([np.full(S_SHAPE, int(z * 1000), np.int32)
                    for z in (0.62, 0.605)],
                   (eye, np.array([-0.5, -0.5, 0.3], np.float32)),
                   tuple(np.array(a) for a in jfield.init_warpfield(
                       nodes, weights=1.0))),
        "slant": ([_slant_depth(a) for a in (0.62, 0.605)],
                  (eye, np.array([-0.625, -0.5, 0.3], np.float32)),
                  tuple(np.array(a) for a in moved))}


S_CAM = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
S_SOLVER = dict(linear_iter=64)


def _ops_inputs():
    """Seeded inputs: the warp (tests/test_dist.py's field, Q = 512), the
    1-NN (its point cloud, the fetched payload each point's index) and the
    Gram (N = 256, D = 64)."""
    rng = np.random.RandomState(5)
    nodes = (rng.rand(12, 3).astype(np.float32) - 0.5) * 0.6
    wf = jfield.init_warpfield(nodes, weights=np.full(12, 0.3, np.float32),
                               capacity=16)
    rod = jnp.asarray(rng.randn(16, 3).astype(np.float32) * 0.04)
    t = jnp.asarray(rng.randn(16, 3).astype(np.float32) * 0.01)
    wf = wf._replace(dqs=jnp.where(wf.mask[:, None],
                                   jdq.dq_from_rodrigues(rod, t), wf.dqs))
    pts = (rng.rand(512, 3).astype(np.float32) - 0.5) * 0.6
    nrm = rng.randn(512, 3).astype(np.float32)
    warp = (pts, nrm, tuple(np.array(a) for a in wf))

    rng = np.random.RandomState(4)
    P, Q = 2048, 4096
    x = np.sort(rng.rand(P).astype(np.float32))
    points = np.stack([x, rng.rand(P).astype(np.float32),
                       rng.rand(P).astype(np.float32)], 1)
    pmask = np.ones(P, bool)
    pmask[::11] = False
    queries = (points[rng.randint(0, P, Q)]
               + 0.002 * rng.randn(Q, 3).astype(np.float32))
    qmask = rng.rand(Q) < 0.95
    index = np.arange(P, dtype=np.float32)[:, None]
    corr = (queries, points, pmask, qmask,
            dict(values=index, escalate=2048, rescue=2048))

    rng = np.random.RandomState(7)
    N, K, D = 256, 8, 64
    gram = (rng.randint(0, D, (N, K)).astype(np.int32),
            rng.rand(N, K).astype(np.float32),
            rng.rand(N).astype(np.float32),
            rng.randn(N, 3).astype(np.float32), D)
    # the monomial Grams: the Gram's rows with y (N = 256, D = 64)
    mono = gram[:3] + ((rng.randn(N, 3) * 0.3).astype(np.float32),
                       (rng.randn(N, 3) * 0.01).astype(np.float32), D)
    return warp, corr, gram, mono


def _jax_state(e):
    """The JAX engine's state as numpy, utils/convert's keywords (fusion
    mode has no soup dedup state)."""
    st = dict(
        vol=tuple(np.array(a) for a in e.vol),
        wf=tuple(np.array(a) for a in e.warpfield),
        canonical=(e.canonical.idx, np.array(e.canonical.vertices),
                   np.array(e.canonical.normals),
                   np.array(e.canonical.mask)),
        frame_counter=e.frame_counter,
        poses=[(np.array(R), np.array(t)) for R, t in e.poses])
    if e.soup_inverse is not None:
        st.update(soup_inverse=np.array(e.soup_inverse),
                  soup_mask=np.array(e.soup_mask),
                  canonical_mult=np.array(e.canonical_mult))
    return st


@contextlib.contextmanager
def _jax_knn_through_pallas():
    """JAX's k-NN feature fetch through its kernel in interpret mode, as in
    tests/test_torch_fusion.py: the kernel, like the port, forms squared
    distances from coordinate differences; the CPU's XLA path orders near
    ties otherwise, and a swapped neighbour moves JAX's solved DQs by more
    than the 1e-5 held below. JAX's traces are dropped on entry and exit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_pallas, "available", lambda: True)
        mp.setattr(knn_pallas, "knn_gather_tpu", functools.partial(
            knn_pallas.knn_gather_tpu, interpret=True))
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


class _Background:
    """fn(*args) in a thread; join() re-raises its exception. With
    `state`, fn gets a queue as its last argument (self.state)."""

    def __init__(self, fn, *args, state: bool = False, **kw):
        self.err = None
        if state:
            self.state = queue.Queue()
            args = args + (self.state,)
        self.thread = threading.Thread(target=self._run, args=(fn, args, kw))
        self.thread.start()

    def _run(self, fn, args, kw):
        try:
            fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised in join
            self.err = e

    def join(self):
        self.thread.join()
        if self.err is not None:
            raise self.err


UMBRELLA = str(REPO / "data" / "umbrella")
# dist.runtime imported alone: no engine module, and no port module imports
# jax
LAZY = ("import sys, dynfu_tpu_torch.dist.runtime; "
        "assert 'dynfu_tpu_torch.engine.dynfusion' not in sys.modules; "
        "import dynfu_tpu_torch.dist as d; d.ShardedDynFusion; "
        "assert 'jax' not in sys.modules")


def _app(out_dir, devices, **kw):
    return run_dataset(UMBRELLA, out_dir=str(out_dir), max_frames=3,
                       volume_dims=64, devices=devices, device="cpu",
                       checkpoint_every=2, **kw)


def _apps(one, out, resumed, fusion1, fusion2):
    """devices=1 over the three frames (this process in no process group),
    then devices=2 (this process joins the app's group as its rank 0),
    then devices=2 resumed from its checkpoint (after frame 1) over frame
    2; then fusion mode on devices=1 and 2."""
    assert _app(one, 1) == 0
    assert _app(out, 2) == 0
    assert _app(resumed, 2, resume=str(out / "checkpoint.npz")) == 0
    assert _app(fusion1, 1, mode="fusion", params=APP_FUSION) == 0
    assert _app(fusion2, 2, mode="fusion", params=APP_FUSION) == 0


def _band0(vol, dilate: int) -> int:
    """The dilated fusion band's voxels in rank 0's block of planes (the
    lower half of the volume's x planes)."""
    band = (vol.weight > 0) & (vol.tsdf < 1.0)
    band = compaction.dilate_xy(compaction.dilate_z(band, dilate), dilate)
    return int(band[:band.shape[0] // 2].sum())


def _jax_fusion_frames(mesh, jfeng, jax_out, state):
    """jfeng's frame 0, then JAX's sharded_fusion_frame from it over F_D1,
    translations and SE(3) (their k-NN through XLA's formulation), into
    jax_out["fusion_t"] and ["fusion_se3"]. Puts the frame-0 state into the
    queue `state`, or None on an error."""
    try:
        jfeng(FRAMES[0])
    except BaseException:
        state.put(None)
        raise
    state.put(_jax_state(jfeng))
    c = jfeng.canonical
    placed = jengine_spmd.place_engine_state(
        mesh, jfeng.vol, jfeng.warpfield, c.vertices, c.normals, c.mask,
        jnp.asarray(F_D1), jfeng.poses[-1])
    for k, jp in (("t", JFPARAMS), ("se3", JFPARAMS_SE3)):
        jax_out[f"fusion_{k}"] = jax.tree_util.tree_map(
            np.asarray, jengine_spmd.sharded_fusion_frame(
                mesh, jp, INTR, jfeng.tsdf_config)(*placed))


def _jax_steps():
    """JAX's sharded_fusion_step on a 2-device sub-mesh over each step
    scene: {scene: per frame (warped rows, SolveStats); the last volume;
    the final DQs}."""
    mesh = jmake_mesh(2)
    step = jsharded_fusion_step(mesh, S_JCFG, S_JINTR, S_SHAPE,
                                solver_kwargs=S_SOLVER)
    out = {}
    for k, (frames, vol_pose, wf) in _step_scenes().items():
        vol = jshard_volume(jtv.create(S_JCFG, vol_pose), mesh)
        wf = jfield.WarpField(*(jnp.asarray(a) for a in wf))
        cam = tuple(jnp.asarray(a) for a in S_CAM)
        frames_out = []
        for d in frames:
            vol, wf, warped, stats = step(vol, jnp.asarray(d), wf, cam)
            frames_out.append((np.asarray(warped),
                               tuple(float(x) for x in stats)))
        out[k] = dict(frames=frames_out, tsdf=np.asarray(vol.tsdf),
                      weight=np.asarray(vol.weight), dqs=np.asarray(wf.dqs))
    return out


def _jax_step_refs():
    """The JAX references of sharded_fusion_step: _jax_steps, then
    _jax_step_composed over each step scene with JAX's k-NN through its
    kernel in interpret mode: (steps, {scene: composed outputs})."""
    steps = _jax_steps()
    with _jax_knn_through_pallas():
        return steps, {k: _jax_step_composed(*scene)
                       for k, scene in _step_scenes().items()}


def _jax_step_composed(frames, vol_pose, wf):
    """The step's body composed from JAX functions, the formulations of the
    source's step (its separable integrate and raycast, the DQB warp,
    gn.solve) on one device: per frame (points, normals, warped rows,
    SolveStats), and the final DQs."""
    vol = jtv.create(S_JCFG, vol_pose)
    wf = jfield.WarpField(*(jnp.asarray(a) for a in wf))
    outs = []
    for d in frames:
        dists = jimgproc.compute_dists(jnp.asarray(d), S_JINTR)
        vol = jtv.integrate_separable(jtv.clear(vol), dists, S_CAM, S_JINTR,
                                      S_JCFG)
        pts, nrm = jtv.raycast_separable(vol, S_CAM, S_JINTR, S_SHAPE,
                                         S_JCFG)
        verts, normals = pts.reshape(-1, 3), nrm.reshape(-1, 3)
        vmask = ~jnp.isnan(verts[:, 0])
        verts, normals = jnp.nan_to_num(verts), jnp.nan_to_num(normals)
        warped, _ = jfield.warp_points_normals(wf, verts, normals)
        wf, stats = jgn.solve(wf, warped, verts, vert_mask=vmask,
                              **S_SOLVER)
        warped2, _ = jfield.warp_points_normals(wf, verts, normals)
        warped2 = jnp.where(vmask[:, None], warped2, jnp.nan)
        outs.append((np.asarray(pts), np.asarray(nrm), np.asarray(warped2),
                     tuple(float(x) for x in stats)))
    return dict(frames=outs, dqs=np.asarray(wf.dqs))


def _single_fusion(prm):
    """The single-card fusion engine over FRAMES: per frame k >= 1 the
    canonical, the warped cloud, the stats and the band voxels in rank 0's
    block before the frame; the final node state."""
    eng = DynFusion(prm, device="cpu", mode="fusion")
    rec = {}
    for i, d in enumerate(FRAMES):
        band0 = _band0(eng.vol, prm.fusion_dilate) if i else None
        eng(d)
        if i:
            rec[i] = (eng.canonical, eng.warped_cloud(),
                      eng.last_frame_stats, band0)
    return rec, eng.warpfield


def _jax_ops():
    """JAX's sharded kernels' functions on the 2-device sub-mesh over
    _ops_inputs(): the warp (its kernel in interpret mode), the tiered 1-NN,
    the data Gram, and the monomial Grams' kernel (interpret mode)."""
    mesh = jmake_mesh(2)
    warp, corr, gram, mono = _ops_inputs()
    pts, nrm, wf = warp
    jwf = jfield.WarpField(*(jnp.asarray(a) for a in wf))
    out = {"warp": [np.asarray(a) for a in jwarp_sharded(
        mesh, jwf, jnp.asarray(pts), jnp.asarray(nrm), blend="dqb",
        tq=128)]}
    q, p, pm, qm, kw = corr
    vals, exact = jnn1_sharded(
        mesh, jnp.asarray(q), jnp.asarray(p), jnp.asarray(pm),
        jnp.asarray(qm), escalate=kw["escalate"], rescue=kw["rescue"])
    out["corr"] = np.asarray(vals), np.asarray(exact)
    out["gram"] = [np.asarray(a) for a in jgram_sharded(
        mesh, *(jnp.asarray(a) for a in gram[:4]), gram[4])]
    out["mono"] = [np.asarray(a) for a in gram_pallas.monomial_grams_tpu(
        *(jnp.asarray(a) for a in mono[:5]), mono[5], tq=256,
        interpret=True)]
    return out


def _jax_parity_frame():
    """JAX's frame 0 over FRAMES[0], then its sharded_engine_frame on the
    2-device sub-mesh over FRAMES[1] with the per-voxel integrate, its
    k-NN through its kernel in interpret mode."""
    mesh = jmake_mesh(2)
    jeng = JDynFusion(JPARAMS)
    jeng(FRAMES[0])
    c = jeng.canonical
    with _jax_knn_through_pallas():
        step = jengine_spmd.sharded_engine_frame(
            mesh, jeng.dynfu_params, INTR, jeng.tsdf_config,
            strict_parity=True, integrate_mode="gather", with_mult=True)
        placed = jengine_spmd.place_engine_state(
            mesh, jeng.vol, jeng.warpfield, c.vertices, c.normals, c.mask,
            jnp.asarray(np.asarray(FRAMES[1], np.int32)), jeng.poses[-1])
        return jax.tree_util.tree_map(
            np.asarray, step(*placed, jeng.canonical_mult))


def _unsharded_frame(*, params, state, depth, strict_parity,
                     integrate_mode):
    """worker.frame's outputs from the single card's `_nonrigid_frame` (no
    mesh, no ShardKernels) on the same state and depth."""
    e = convert.load_engine_state(DynFusion(params, device="cpu"), **state)
    c = e.canonical
    (vol, wf, wv, wn, (live_v, live_n, live_m), (soup, n),
     stats) = tdyn._nonrigid_frame(
        e.vol, e.warpfield, c.vertices, c.normals, c.mask,
        torch.as_tensor(depth, dtype=torch.int32), e.poses[-1],
        dp=e.dynfu_params, intr=e.params.intr, config=e.tsdf_config,
        parity=strict_parity, canonical_mult=e.canonical_mult, kernels=None,
        integrate_mode=integrate_mode)
    n = int(n)
    return dict(tsdf=vol.tsdf.numpy(), weight=vol.weight.numpy(),
                wv=wv.numpy(), wn=wn.numpy(), soup=soup[:n].numpy(),
                n_verts=n, live=live_v[live_m].numpy(),
                live_n=live_n[live_m].numpy(), pos=wf.pos.numpy(),
                dqs=wf.dqs.numpy(), w=wf.w.numpy(), mask=wf.mask.numpy(),
                count=int(wf.count), mc_dropped=int(stats.mc_dropped),
                corr_dropped=int(stats.corr_dropped))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the app's spawned rank, like the job ranks, on one intra-op thread
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    """Every sharded job on two gloo ranks, beside each JAX program once and
    the port's single-card references. Alongside: run_dataset on three
    umbrella frames at 64^3, checkpointing after frame 1, once on one rank
    in parity and in fusion mode (first: this process then joins the app's
    process group, as its rank 0, in a thread), on two, resumed on two, and
    in fusion mode on two; and the import check in a fresh interpreter."""
    out = tmp_path_factory.mktemp("ranks")
    ckpt = tmp_path_factory.mktemp("ckpt") / "fusion.npz"
    app = {n: tmp_path_factory.mktemp(f"app_{n}")
           for n in (1, 2, "resumed", "fusion1", "fusion2")}
    lazy = subprocess.Popen([sys.executable, "-c", LAZY], cwd=REPO)
    # JAX's sharded kernels' functions, its parity frame and the references
    # of sharded_fusion_step, each in a process of its own
    refs = JaxRefs({"ops": _jax_ops, "frame": _jax_parity_frame,
                    "step": _jax_step_refs})
    for name in refs.fns:
        refs.start(name)
    apps = _Background(_apps, app[1], app[2], app["resumed"], app["fusion1"],
                       app["fusion2"])
    warp, corr, gram, mono = _ops_inputs()
    # JAX on a 2-device sub-mesh: frames 0, parity and fusion (the ranks'
    # states), then the sharded fusion frames in a thread (XLA compiles
    # without the GIL)
    mesh = jmake_mesh(2)
    jax_out = {}
    jfeng = JDynFusion(JFPARAMS, mode="fusion")
    jfusion = _Background(_jax_fusion_frames, mesh, jfeng, jax_out,
                          state=True)
    jeng = JDynFusion(JPARAMS)
    jeng(FRAMES[0])
    state = _jax_state(jeng)
    fstate = jfusion.state.get()
    if fstate is None:
        jfusion.join()  # raises the thread's error
    d1 = np.asarray(FRAMES[1], np.int32)
    jobs = [("ops", dict(warp=warp, corr=corr, gram=gram, mono=mono)),
            ("frame", dict(params=PARAMS, state=state, depth=d1))]
    jobs += [(f"frame/{k}", dict(params=p, state=state, depth=d1,
                                 strict_parity=False, integrate_mode=m))
             for k, (p, m) in FIXED_FRAMES.items()]
    jobs += [(f"drive/{k}", dict(params=p, frames=FRAMES))
             for k, p in VARIANTS.items()]
    jobs += [(f"fusion_frame/{k}", dict(params=convert.params(p),
                                        state=fstate, depth=F_D1))
             for k, p in (("t", JFPARAMS), ("se3", JFPARAMS_SE3))]
    jobs += [(f"fusion_drive/{k}", dict(params=p, frames=FRAMES))
             for k, p in FUSION_VARIANTS.items()]
    jobs += [("fusion_drive/resumed", dict(
        params=FUSION_VARIANTS["edges_se3"], frames=FRAMES,
        resume_after=RESUME_AFTER, ckpt=str(ckpt)))]
    jobs += [(f"step/{k}", dict(
        config=S_CFG, intr=S_INTR, shape=S_SHAPE,
        vol=tuple(a.numpy() for a in tv.create(S_CFG, vol_pose, "cpu")),
        wf=wf, frames=frames, camera_pose=S_CAM, solver_kwargs=S_SOLVER))
        for k, (frames, vol_pose, wf) in _step_scenes().items()]
    ranks = _Background(runtime.spawn, worker.run_jobs, 2, jobs, str(out),
                        "cpu", device="cpu")

    # the port on one rank (no process group; not make_mesh, which would
    # see the app's group): the Grams, the warp, the drives
    mesh1 = spmd.Mesh(0, 1, torch.device("cpu"), None)
    pts, nrm, wf = warp
    one = {"gram": shard_gram.data_normal_sharded(
        mesh1, *(torch.as_tensor(a) for a in gram[:4]), gram[4])}
    one["warp"] = warp_cuda.warp_fused(
        *(torch.as_tensor(np.array(a)) for a in (pts, nrm, *wf[:4])))[:2]
    one["mono"] = shard_gram.monomial_grams_sharded(
        mesh1, *(torch.as_tensor(a) for a in mono[:5]), mono[5])
    single = {}
    for k, prm in VARIANTS.items():
        eng = DynFusion(prm, device="cpu")
        rec = {}
        for i, d in enumerate(FRAMES):
            eng(d)
            if i:
                rec[i] = (eng.warped_cloud(), eng.live, eng.mesh(),
                          eng.last_frame_stats)
        single[k] = (rec, eng.warpfield)
    fusion = {k: _single_fusion(p) for k, p in FUSION_VARIANTS.items()}
    one["step"] = {name.split("/")[1]: worker.step(mesh1, **kw)
                   for name, kw in jobs if name.startswith("step/")}
    one["frame"] = {name.split("/")[1]: worker.frame(mesh1, **kw)
                    for name, kw in jobs if name.startswith("frame/")}
    one["unsharded"] = {name.split("/")[1]: _unsharded_frame(**kw)
                        for name, kw in jobs if name.startswith("frame/")}

    jfusion.join()
    ranks.join()
    apps.join()
    jax_out.update(refs["ops"], frame=refs["frame"])
    steps, composed = refs["step"]
    for k in STEP_SCENES:
        jax_out[f"step_{k}"] = steps[k]
        jax_out[f"composed_{k}"] = composed[k]
    refs.close()
    rank_out = {}
    for f in out.iterdir():
        name, r = f.stem.rsplit("_r", 1)
        rank_out[(name, int(r))] = dict(np.load(f))
    return dict(jax=jax_out, one=one, single=single, fusion=fusion,
                ranks=rank_out, corr=corr, app=app, lazy=lazy.wait())


# --- the sharded kernels' functions ----------------------------------------


def test_warp_sharded(runs):
    """Each rank's outputs bitwise the single card's warp_fused; within
    1e-6 m of JAX's shard_map warp (its kernel in interpret mode: the two
    formulas of the DQ transform round differently, up to 5e-7 here)."""
    for r in (0, 1):
        got = runs["ranks"][("ops", r)]
        for name, want, jwant in zip(("warp_points", "warp_normals"),
                                     runs["one"]["warp"],
                                     runs["jax"]["warp"]):
            np.testing.assert_array_equal(got[name], want.numpy())
            np.testing.assert_allclose(got[name], jwant, rtol=0, atol=1e-6)


def test_nn1_sharded(runs):
    """The exactness flags equal JAX's on every rank (the tiers certify
    every query on both sides), and the nearest point is JAX's: the point
    at the port's fetched index is the point JAX fetched (to the roundoff of
    its un-centring)."""
    jvals, jexact = runs["jax"]["corr"]
    _, points, pmask, qmask, _ = runs["corr"]
    for r in (0, 1):
        got = runs["ranks"][("ops", r)]
        np.testing.assert_array_equal(got["corr_exact"], jexact)
        np.testing.assert_array_equal(got["corr_exact"], qmask)
        idx = got["corr_vals"][qmask, 0].astype(np.int64)
        assert pmask[idx].all()
        np.testing.assert_allclose(points[idx], jvals[qmask], rtol=0,
                                   atol=1e-6)


def test_gram_sharded(runs):
    """A and b within 1e-5 of the largest entry of JAX's shard_map Gram
    (interpret mode, bfloat16 passes); every rank's bitwise the port's
    1-rank result (float64 partials added in rank order, one rounding)."""
    jA, jb = runs["jax"]["gram"]
    A1, b1 = runs["one"]["gram"]
    for r in (0, 1):
        got = runs["ranks"][("ops", r)]
        np.testing.assert_allclose(got["gram_A"], jA, rtol=0,
                                   atol=1e-5 * np.abs(jA).max())
        np.testing.assert_allclose(got["gram_b"], jb, rtol=0,
                                   atol=1e-5 * np.abs(jb).max())
        np.testing.assert_array_equal(got["gram_A"], A1.numpy())
        np.testing.assert_array_equal(got["gram_b"], b1.numpy())


# --- the sharded engine frame against JAX's --------------------------------


def test_sharded_frame_matches_jax(runs):
    """One frame from JAX's frame-0 state, against JAX's
    sharded_engine_frame (integrate_mode="gather", the per-voxel integrate
    the port follows; its k-NN through its kernel): the soup within 1e-6 m
    and its count, the volume bitwise, the node mask and the drop counts
    exact, the DQs within 1e-5 (tests/test_dist.py's tolerances)."""
    j = runs["jax"]["frame"]
    got = runs["ranks"][("frame", 0)]
    n = int(j[8])
    assert int(got["n_verts"]) == n > 0
    np.testing.assert_allclose(got["soup"], np.asarray(j[7])[:n], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["tsdf"], np.asarray(j[0].tsdf))
    np.testing.assert_array_equal(got["weight"], np.asarray(j[0].weight))
    np.testing.assert_array_equal(got["mask"], np.asarray(j[1].mask))
    assert int(got["count"]) == int(j[1].count)
    np.testing.assert_allclose(got["dqs"], np.asarray(j[1].dqs), rtol=0,
                               atol=1e-5)
    assert int(got["mc_dropped"]) == int(j[9].mc_dropped) == 0
    assert int(got["corr_dropped"]) == int(j[9].corr_dropped)
    for key in ("dqs", "tsdf", "soup", "wv"):  # every rank the same
        np.testing.assert_array_equal(runs["ranks"][("frame", 1)][key],
                                      got[key])


@pytest.mark.parametrize("kind", list(FIXED_FRAMES))
def test_sharded_nonstrict_frame_equals_one_rank(runs, kind):
    """sharded_engine_frame(strict_parity=False) on two ranks against one,
    and the one rank against the single card's unsharded non-strict
    `_nonrigid_frame` (which tests/test_torch_modes.py holds against JAX):
    the volume, the warped canonical and its normals, the soup, the live
    set and its gradient normals (on each block from 3 halo planes), the
    node state and the drop counts, all bitwise, on both ranks."""
    want = runs["one"]["frame"][kind]
    card = runs["one"]["unsharded"][kind]
    assert sorted(card) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(w), card[key], err_msg=key)
    for r in (0, 1):
        got = runs["ranks"][(f"frame_{kind}", r)]
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)
    assert int(want["n_verts"]) > 500 and int(want["count"]) > 0
    assert np.isfinite(want["live_n"]).all(1).mean() > 0.9
    assert np.abs(want["dqs"][:, 4:]).max() > 0  # the solve moved nodes


# --- the driver against the single-card engine -----------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_driver_equals_single_card(runs, variant):
    """ShardedDynFusion on two ranks over four frames against DynFusion:
    per frame the warped cloud and its mask, the live set index for index
    and its mask, the soup and its count, the drop counts; the final node
    state (DQs included) and its count; all bitwise, on both ranks. With a
    capacity, the cut falls inside rank 1's block: rank 1 keeps some of its
    vertices and the rest drop, as on one card."""
    rec, wf = runs["single"][variant]
    for r in (0, 1):
        got = runs["ranks"][(f"drive_{variant}", r)]
        for i, ((wv, wm), live, (sv, sn), fs) in rec.items():
            np.testing.assert_array_equal(got[f"warped{i}"], wv.numpy())
            np.testing.assert_array_equal(got[f"warped_mask{i}"], wm.numpy())
            np.testing.assert_array_equal(got[f"live{i}"],
                                          live.vertices.numpy())
            np.testing.assert_array_equal(got[f"live_mask{i}"],
                                          live.mask.numpy())
            np.testing.assert_array_equal(got[f"soup{i}"], sv.numpy())
            assert int(got[f"soup_n{i}"]) == int(sn)
            assert int(got[f"mc_dropped{i}"]) == int(fs.mc_dropped)
            assert int(got[f"corr_dropped{i}"]) == int(fs.corr_dropped)
        for k in ("pos", "dqs", "w", "mask"):
            np.testing.assert_array_equal(got[k], getattr(wf, k).numpy())
        assert int(got["count"]) == int(wf.count)
    if variant.endswith("_cap"):
        for i, (_, _, _, fs) in rec.items():
            kept1 = int(runs["ranks"][(f"drive_{variant}", 1)][f"n_local{i}"])
            assert int(fs.mc_dropped) > 0 and kept1 > 0
    else:
        assert all(int(fs.mc_dropped) == 0 for *_, fs in rec.values())


# --- runtime ---------------------------------------------------------------


def test_init_noop_without_coordinator(monkeypatch):
    for k in ("DYNFU_COORDINATOR", "DYNFU_NUM_PROCESSES", "MASTER_ADDR",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert runtime.init_distributed(device="cpu") is False


def test_init_noop_for_single_process(monkeypatch):
    monkeypatch.setenv("DYNFU_COORDINATOR", "host0:9876")
    monkeypatch.setenv("DYNFU_NUM_PROCESSES", "1")
    assert runtime.init_distributed(device="cpu") is False


@pytest.mark.parametrize("env,want", [
    (dict(DYNFU_COORDINATOR="host0:9876", DYNFU_NUM_PROCESSES="4",
          DYNFU_PROCESS_ID="2"), ("tcp://host0:9876", 4, 2)),
    (dict(MASTER_ADDR="host1", MASTER_PORT="29501", WORLD_SIZE="3",
          RANK="1"), ("tcp://host1:29501", 3, 1)),
])
def test_env_vars_feed_init(monkeypatch, env, want):
    """DYNFU_* (the source's variables) or torchrun's reach
    init_process_group (intercepted: no rendezvous), with gloo on the
    CPU."""
    import torch.distributed as dist

    calls = {}

    def fake_init(backend, **kw):
        calls.update(backend=backend, **kw)

    for k in ("DYNFU_COORDINATOR", "DYNFU_NUM_PROCESSES", "DYNFU_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    assert runtime.init_distributed(device="cpu") is True
    assert (calls["init_method"], calls["world_size"], calls["rank"]) == want
    assert calls["backend"] == "gloo"


def test_already_initialised_is_idempotent(monkeypatch):
    import torch.distributed as dist

    def raise_already(*a, **kw):
        raise RuntimeError("trying to initialize the default process group "
                           "twice: already initialized")

    monkeypatch.setattr(dist, "init_process_group", raise_already)
    assert runtime.init_distributed("host0:9876", 4, 0, device="cpu") is True


def test_other_errors_propagate(monkeypatch):
    import torch.distributed as dist

    def raise_other(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", raise_other)
    with pytest.raises(RuntimeError, match="unreachable"):
        runtime.init_distributed("host0:9876", 4, 1, device="cpu")


def test_is_primary_and_backend_choice(monkeypatch):
    """One process is primary; gloo on the CPU; NCCL with a card per rank,
    gloo when ranks share one, and an explicit NCCL that cannot be served
    raises."""
    assert runtime.is_primary() is True
    assert runtime.choose_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runtime.choose_backend("cuda", 1) == "nccl"
    assert runtime.choose_backend("cuda", 2) == "gloo"
    with pytest.raises(ValueError, match="card per rank"):
        runtime.choose_backend("cuda", 2, "nccl")


def test_run_dataset_joins_a_launchers_ranks(monkeypatch, tmp_path):
    """Under torchrun's variables run_dataset(devices=2) joins the
    launcher's process group (intercepted: no rendezvous) and starts no
    local rank; the intercepted group has no ranks, so the mesh then finds
    one rank where two were asked for."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(kw))

    def no_spawn(*a, **kw):
        raise AssertionError("local ranks spawned under a launcher")

    monkeypatch.setattr(runtime, "spawn", no_spawn)
    for k in ("DYNFU_COORDINATOR", "DYNFU_NUM_PROCESSES", "DYNFU_PROCESS_ID",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="29511",
                     WORLD_SIZE="2", RANK="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="2 devices asked for"):
        run_dataset(UMBRELLA, out_dir=str(tmp_path), max_frames=1,
                    volume_dims=64, devices=2, device="cpu")
    assert (calls["world_size"], calls["rank"]) == (2, 1)


def test_dist_imports_lazily(runs):
    """dist.runtime imports without the engine (dist/__init__ exports
    lazily); importing the driver imports no jax (a fresh interpreter)."""
    assert runs["lazy"] == 0


def test_driver_refuses_other_modes():
    """Parity and fusion mode are accepted (a one-rank mesh here); fixed
    mode, fusion with camera tracking and the rigid app raise."""
    from dynfu_tpu_torch.dist.driver import ShardedDynFusion

    for mode in ("parity", "fusion"):
        assert ShardedDynFusion(PARAMS, mode=mode, device="cpu").mode == mode
    with pytest.raises(NotImplementedError):
        ShardedDynFusion(PARAMS, mode="fixed", device="cpu")
    tracking = dataclasses.replace(PARAMS, fusion_camera_tracking=True)
    with pytest.raises(NotImplementedError, match="camera"):
        ShardedDynFusion(tracking, mode="fusion", device="cpu")
    with pytest.raises(NotImplementedError, match="camera"):
        run_dataset(UMBRELLA, mode="fusion", params=tracking, devices=2,
                    device="cpu")
    with pytest.raises(ValueError, match="rigid"):
        run_dataset(UMBRELLA, rigid=True, devices=2, device="cpu")


# --- fusion mode ------------------------------------------------------------


def test_monomial_grams_sharded(runs):
    """The monomial Grams' float64 partials on two ranks, added in rank
    order and rounded once: bitwise the port's one-rank result on every
    rank, and within 1e-5 of the largest entry of JAX's monomial_grams_tpu
    (interpret mode, 3-pass bfloat16)."""
    for r in (0, 1):
        got = runs["ranks"][("ops", r)]
        for name, want, jwant in zip(("mono_B", "mono_Bu", "mono_Bw"),
                                     runs["one"]["mono"],
                                     runs["jax"]["mono"]):
            assert want.dtype == torch.float32
            np.testing.assert_array_equal(got[name], want.numpy())
            np.testing.assert_allclose(got[name], jwant, rtol=0,
                                       atol=1e-5 * np.abs(jwant).max())


@pytest.mark.parametrize("kind", ["t", "se3"])
def test_sharded_fusion_frame_matches_jax(runs, kind):
    """One fusion frame from JAX's frame-0 state (marching cubes), against
    JAX's sharded_fusion_frame on the 2-device sub-mesh, translations and
    SE(3) (tests/test_dist.py's fusion-frame tests and their tolerances;
    JAX's k-NN through XLA's formulation, whose near ties do not arise
    here): the canonical's vertex count and the captured band exact, the
    DQs within 1e-5, the TSDF within 1e-3; the node mask and count exact;
    every rank the same."""
    j = runs["jax"][f"fusion_{kind}"]
    got = runs["ranks"][(f"fusion_frame_{kind}", 0)]
    assert int(got["n_verts"]) == int(j[5]) > 0
    assert int(got["n_captured"]) == int(j[8].band.n_captured) > 0
    assert int(got["n_band"]) == int(j[8].band.n_band)
    np.testing.assert_allclose(got["dqs"], np.asarray(j[1].dqs), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["tsdf"].astype(np.float32),
                               np.asarray(j[0].tsdf, np.float32), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got["mask"], np.asarray(j[1].mask))
    assert int(got["count"]) == int(j[1].count)
    for key in ("dqs", "tsdf", "verts", "wv2"):  # every rank the same
        np.testing.assert_array_equal(
            runs["ranks"][(f"fusion_frame_{kind}", 1)][key], got[key])


def _check_fusion_drive(got, rec, wf, frames):
    for i in frames:
        c, (wv, wm), fs, _ = rec[i]
        np.testing.assert_array_equal(got[f"canonical{i}"],
                                      c.vertices.numpy())
        np.testing.assert_array_equal(got[f"normals{i}"], c.normals.numpy())
        np.testing.assert_array_equal(got[f"mask{i}"], c.mask.numpy())
        np.testing.assert_array_equal(got[f"warped{i}"], wv.numpy())
        np.testing.assert_array_equal(got[f"warped_mask{i}"], wm.numpy())
        for k, v in fs.band._asdict().items():
            assert int(got[f"{k}{i}"]) == int(v), (i, k)
        assert int(got[f"mc_dropped{i}"]) == int(fs.mc_dropped)
        assert int(got[f"corr_dropped{i}"]) == int(fs.corr_dropped)
    for k in ("pos", "dqs", "w", "mask"):
        np.testing.assert_array_equal(got[k], getattr(wf, k).numpy())
    assert int(got["count"]) == int(wf.count)


@pytest.mark.parametrize("variant", list(FUSION_VARIANTS))
def test_fusion_driver_equals_single_card(runs, variant):
    """ShardedDynFusion(mode="fusion") on two ranks over four frames against
    DynFusion(mode="fusion"), bitwise on both ranks: per frame the
    re-extracted canonical (vertices, normals with their NaNs, mask), the
    warped cloud and its mask, the band counters (n_band, n_captured,
    n_updated) and the drop counts; the final node state. With the band
    capacity the cut falls inside rank 1's block (rank 0's block holds
    fewer band voxels than the capacity, both blocks more), after a
    warm-up frame."""
    rec, wf = runs["fusion"][variant]
    for r in (0, 1):
        _check_fusion_drive(runs["ranks"][(f"fusion_drive_{variant}", r)],
                            rec, wf, rec)
    bands = [(rec[i][3], int(rec[i][2].band.n_captured),
              int(rec[i][2].band.n_band)) for i in rec]
    if variant == "band_cap":
        assert all(b0 < cap == BAND_CAP < n for b0, cap, n in bands)
    else:
        assert all(cap == n for _, cap, n in bands)
        assert all(int(fs.mc_dropped) == 0 for _, _, fs, _ in rec.values())


def test_fusion_checkpoint_resumed(runs):
    """The 2-rank fusion driver (unique edges, SE(3)) saved after frame 1
    (rank 0's gathered state) and restored by a new driver on both ranks:
    the later frames and the final node state bitwise the uninterrupted
    single card's."""
    rec, wf = runs["fusion"]["edges_se3"]
    later = [i for i in rec if i > RESUME_AFTER]
    for r in (0, 1):
        _check_fusion_drive(runs["ranks"][("fusion_drive_resumed", r)], rec,
                            wf, later)


def test_run_dataset_fusion_two_devices(runs):
    """run_dataset(mode="fusion", devices=2) on three umbrella frames at
    64^3 writes the bytes devices=1 writes (clouds, meshes) and the same
    checkpoint arrays."""
    a, b = runs["app"]["fusion1"], runs["app"]["fusion2"]
    names = sorted(n for n in os.listdir(a) if n != "checkpoint.npz")
    assert sorted(n for n in os.listdir(b) if n != "checkpoint.npz") == names
    assert sum(n.endswith(".pcd") for n in names) == 3
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n
    with np.load(a / "checkpoint.npz") as za, \
            np.load(b / "checkpoint.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# --- the entry point ---------------------------------------------------------


# --- sharded_fusion_step ----------------------------------------------------


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("scene", STEP_SCENES)
def test_sharded_fusion_step_ranks_equal_one_rank(runs, scene):
    """sharded_fusion_step on two ranks, two frames, against the step on one
    rank (the single card's composition): per frame the whole raycast
    (points and normals, NaNs included), each rank's warped rows and the
    SolveStats bitwise; the last volume and the final node state bitwise;
    every rank has valid rows and the cost does not grow. On the slanted
    scene the crossing pair of some hits lies in two blocks (the count
    the same on both ranks); on the planes none does."""
    one = runs["one"]["step"][scene]
    n = S_SHAPE[0] * S_SHAPE[1]
    straddles = []
    for r in (0, 1):
        got = runs["ranks"][(f"step_{scene}", r)]
        lo, hi = r * n // 2, (r + 1) * n // 2
        for k in range(2):
            for f in ("points", "normals"):
                np.testing.assert_array_equal(_bits(got[f"{f}{k}"]),
                                              _bits(one[f"{f}{k}"]))
            np.testing.assert_array_equal(_bits(got[f"warped{k}"]),
                                          _bits(one[f"warped{k}"][lo:hi]))
            for f in ("initial_cost", "final_cost", "cg_iters",
                      "mean_huber"):
                assert float(got[f"{f}{k}"]) == float(one[f"{f}{k}"])
            assert int(got[f"rows{k}"]) > 0
            assert float(got[f"final_cost{k}"]) <= float(
                got[f"initial_cost{k}"])
        straddles.append([int(got[f"straddle{k}"]) for k in range(2)])
        for f in ("tsdf", "weight", "pos", "dqs", "w", "mask", "count"):
            np.testing.assert_array_equal(got[f], one[f])
    assert straddles[0] == straddles[1]
    assert all(c > 0 for c in straddles[0]) == (scene == "slant")
    assert scene == "slant" or straddles[0] == [0, 0]


def _near_zero(scene, k, tol=1e-6):
    """(H * W,) bool: the pixels of frame k of a step scene where a valid
    sample of the separable sweep lies within tol of zero (the port's plain
    sweep over its volume of that frame): a crossing there may round to
    either side."""
    frames, vol_pose, _ = _step_scenes()[scene]
    dists = imgproc.compute_dists(torch.as_tensor(frames[k]), S_INTR)
    vol = tv.integrate(tv.create(S_CFG, tuple(map(torch.as_tensor,
                                                  vol_pose)), "cpu"),
                       dists, S_CAM, S_INTR, S_CFG)
    geo, rays = tv.separable_rays(vol, S_CAM, S_INTR, S_SHAPE)
    spec = tv.sweep_spec("separable", S_SHAPE, S_CFG)
    sample = tv._sampler(geo, rays, spec, 0, S_CFG.dims[0])
    slabs = tv._padded(tv.slab_stack(vol.tsdf, spec.m), spec.s_pad)
    near = torch.zeros(S_SHAPE, dtype=torch.bool)
    for g in range(spec.s_pad):
        f, _, _, valid, _ = sample(g, slabs[g])
        near |= valid & (f.abs() <= tol)
    return near.reshape(-1).numpy()


@pytest.mark.parametrize("scene", STEP_SCENES)
def test_sharded_fusion_step_matches_jax_composition(runs, scene):
    """The port's one-rank step against the same body composed from JAX
    functions, the source step's formulations (its separable integrate and
    raycast, the DQB warp, gn.solve; its k-NN through its kernel in
    interpret mode): the hit mask equal; points and warped rows within
    1e-6 m (measured 3.3e-7), normals within 1e-4 (1.5e-5), the DQs within
    1e-5 (4.9e-9), the costs within 1e-5 relative, the CG iterations
    equal."""
    one = runs["one"]["step"][scene]
    want = runs["jax"][f"composed_{scene}"]
    for k, (pts, nrm, warped, stats) in enumerate(want["frames"]):
        hit = ~np.isnan(pts[..., 0])
        np.testing.assert_array_equal(~np.isnan(one[f"points{k}"][..., 0]),
                                      hit)
        assert hit.sum() > 600
        np.testing.assert_allclose(one[f"points{k}"][hit], pts[hit], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(one[f"normals{k}"][hit], nrm[hit],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(one[f"warped{k}"], warped, rtol=0,
                                   atol=1e-6)
        for f, v in zip(("initial_cost", "final_cost"), stats):
            np.testing.assert_allclose(float(one[f"{f}{k}"]), v, rtol=1e-5,
                                       atol=1e-12)
        assert float(one[f"cg_iters{k}"]) == stats[2]
    np.testing.assert_allclose(one["dqs"], want["dqs"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("scene", STEP_SCENES)
def test_sharded_fusion_step_matches_jax_step(runs, scene):
    """The port's 2-rank step against the source's own sharded_fusion_step
    on the 2-device sub-mesh (its separable integrate and raycast, its k-NN
    through XLA): the volume bitwise (the separable integrate computes the
    per-voxel update with these poses); the hit masks equal but at pixels
    where a sample of the sweep lies within 1e-6 of zero (_near_zero;
    counted, 0 here); the warped rows within 1e-4 m (measured 3.0e-7:
    float32 sums of the solve in another order)."""
    want = runs["jax"][f"step_{scene}"]
    got = [runs["ranks"][(f"step_{scene}", r)] for r in (0, 1)]
    np.testing.assert_array_equal(got[0]["tsdf"], want["tsdf"])
    np.testing.assert_array_equal(got[0]["weight"], want["weight"])
    for k, (jw, _) in enumerate(want["frames"]):
        w = np.concatenate([g[f"warped{k}"] for g in got])
        jhit, hit = ~np.isnan(jw[:, 0]), ~np.isnan(w[:, 0])
        differ = jhit != hit
        assert not (differ & ~_near_zero(scene, k)).any()
        assert differ.sum() == 0  # the count of near-zero exceptions
        both = jhit & hit
        assert both.sum() > 600
        np.testing.assert_allclose(w[both], jw[both], rtol=0, atol=1e-4)


def test_run_dataset_two_devices(runs):
    """run_dataset(devices=2) on three umbrella frames at 64^3 writes the
    bytes devices=1 writes (clouds, meshes) and the same checkpoint arrays
    (the gathered state, saved by rank 0); resumed on two ranks from that
    checkpoint, frame 2's exports are again devices=1's."""
    a, b, c = (runs["app"][k] for k in (1, 2, "resumed"))
    names = sorted(n for n in os.listdir(a) if n != "checkpoint.npz")
    assert sorted(n for n in os.listdir(b) if n != "checkpoint.npz") == names
    assert sum(n.endswith(".pcd") for n in names) == 3
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n
    with np.load(a / "checkpoint.npz") as za, \
            np.load(b / "checkpoint.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    resumed = sorted(os.listdir(c))
    assert resumed == sorted(n for n in names if n.startswith("2_")
                             or n.endswith("live2.pcd"))
    for n in resumed:
        assert filecmp.cmp(a / n, c / n, shallow=False), n


# --- on the card (marked cuda: skipped without one) --------------------------


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(5001, 100), (0, 17), (49152, 1024)])
def test_partial_gram_kernel_equals_model(dev, N, D):
    """The data Gram kernel's float64 partial mode: the bits of the plain
    fixed-order model's partial, and rounded once, the float32 mode's."""
    from dynfu_tpu_torch.solver import gram_cuda

    rng = np.random.default_rng(3)
    idx = rng.integers(-1, D + 1, (N, 8)).astype(np.int32)
    w = rng.random((N, 8), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[::3] = 0.0
    delta = rng.normal(size=(N, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (idx, w, s2, delta)]
    A64, b64 = gram_cuda.data_normal(*args, D, partial=True)
    A, b = gram_cuda.data_normal(*args, D)
    mA, mb = gram_cuda.gram_fixed_order(
        *(a.cpu() for a in args), D, gram_cuda.gram_warps(N, D, False),
        partial=True)
    assert A64.dtype == torch.float64
    assert torch.equal(A64.cpu(), mA) and torch.equal(b64.cpu(), mb)
    assert torch.equal(A64.float(), A) and torch.equal(b64.float(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(5001, 100), (0, 17), (20000, 640)])
def test_partial_monomial_kernel_equals_model(dev, N, D):
    """The monomial Grams' float64 partial mode: the same bits over three
    launches, the bits of the plain fixed-order model's partial, and
    rounded once, the float32 mode's."""
    from dynfu_tpu_torch.solver import gram_cuda

    rng = np.random.default_rng(4)
    idx = rng.integers(-1, D + 1, (N, 8)).astype(np.int32)
    w = rng.random((N, 8), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[::3] = 0.0
    y = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    delta = rng.normal(0, 0.01, (N, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (idx, w, s2, y, delta)]
    outs = [gram_cuda.monomial_grams(*args, D, partial=True)
            for _ in range(3)]
    f32 = gram_cuda.monomial_grams(*args, D)
    model = gram_cuda.gram_fixed_order(
        *(args[i].cpu() for i in (0, 1, 2, 4)), D,
        gram_cuda.gram_warps(N, D, True), y=args[3].cpu(), partial=True)
    assert outs[0][0].dtype == torch.float64
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(outs[0], model))
    assert all(torch.equal(a.float(), b) for a, b in zip(outs[0], f32))


@pytest.mark.cuda
def test_fusion_driver_on_card_equals_single_card(dev, tmp_path):
    """Two ranks sharing the card (gloo), fusion mode with unique edges and
    SE(3) over four frames: the canonical, the warped cloud and the node
    state bitwise the single card's."""
    prm = FUSION_VARIANTS["edges_se3"]
    runtime.spawn(worker.run_jobs, 2, [("fusion_drive/x", dict(
        params=prm, frames=FRAMES))], str(tmp_path), "cuda")
    got = dict(np.load(tmp_path / "fusion_drive_x_r0.npz"))
    eng = DynFusion(prm, device=dev, mode="fusion")
    for i, d in enumerate(FRAMES):
        eng(d)
        if i:
            np.testing.assert_array_equal(
                got[f"canonical{i}"], eng.canonical.vertices.cpu().numpy())
            np.testing.assert_array_equal(
                got[f"warped{i}"], eng.warped_cloud()[0].cpu().numpy())
    np.testing.assert_array_equal(got["dqs"], eng.warpfield.dqs.cpu().numpy())


@pytest.mark.cuda
def test_driver_on_card_equals_single_card(dev, tmp_path):
    """Two ranks sharing the card (gloo) over four frames, marching cubes
    and unique edges with a capacity cut in rank 1's block: the warped
    clouds, live sets and node state bitwise the single card's."""
    variants = {k: VARIANTS[k] for k in ("mc", "edges_cap")}
    jobs = [(f"drive/{k}", dict(params=p, frames=FRAMES))
            for k, p in variants.items()]
    runtime.spawn(worker.run_jobs, 2, jobs, str(tmp_path), "cuda")
    for k, prm in variants.items():
        got = dict(np.load(tmp_path / f"drive_{k}_r0.npz"))
        eng = DynFusion(prm, device=dev)
        for i, d in enumerate(FRAMES):
            eng(d)
            if i:
                wv, wm = eng.warped_cloud()
                np.testing.assert_array_equal(got[f"warped{i}"],
                                              wv.cpu().numpy())
                np.testing.assert_array_equal(got[f"live{i}"],
                                              eng.live.vertices.cpu().numpy())
        np.testing.assert_array_equal(got["dqs"],
                                      eng.warpfield.dqs.cpu().numpy())
