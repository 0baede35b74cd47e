"""PyTorch port vs JAX reference: the rigid KinFu slice on the CPU — the
stencil fetch, the image pyramids, the three ICP variants, the per-ray
raycast, the KinFu engine and its reset, the foreground switch that the
port refuses, and one camera-tracking step of fusion mode. Every test that
runs an engine or an ICP uses the tests/test_icp.py camera (120x160,
f = 160) and the default ICP settings, so that the JAX programs compile
once per file. Pallas kernels run in interpret mode, as the JAX package's
own tests run them.

The parity DynFusion frame loop on the tests/test_pipeline.py fixture
(96x128 depth, 64^3 volume, a sphere of r = 0.22 m moving 5 mm per frame),
frame 0 and two tracked frames. Stepwise: after each JAX frame its state
is loaded into the port (utils/convert.py) and the port's next frame is
held against JAX's. Free running: the port runs all three frames on its
own.

The tests marked `cuda` hold the stencil CUDA kernel against its plain
version at edge-case shapes; they skip without a card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import se3 as jse3
from dynfu_tpu.engine.dynfusion import DynFusion as JaxDynFusion
from dynfu_tpu.engine.dynfusion import Frame as JFrame
from dynfu_tpu.engine.dynfusion import _mask_deforming_depth as j_mask
from dynfu_tpu.engine.kinfu import KinFu as JaxKinFu
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.ops import stencil_pallas
from dynfu_tpu.rigid import icp as jicp
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.volume.tsdf import TsdfVolume as JVolume
from dynfu_tpu.warp.field import WarpField as JWarpField
from dynfu_tpu_torch.core import se3
from dynfu_tpu_torch.engine.dynfusion import DynFusion, Frame
from dynfu_tpu_torch.engine.dynfusion import _mask_deforming_depth as t_mask
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.ops import imgproc, stencil_cuda
from dynfu_tpu_torch.rigid import icp
from dynfu_tpu_torch.utils import convert
from dynfu_tpu_torch.volume import tsdf as tv
from dynfu_tpu_torch.warp import field as tfield

from test_icp import H, W, apply_inv_transform, heightfield_depth, make_frame
from test_icp import INTR as JINTR
from test_pipeline import (CENTER, RADIUS, SCENE, small_dynfu_params,
                           small_kinfu_params, sphere_depth)


# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

TINTR = convert.params(JINTR)
KP = small_kinfu_params(cols=W, rows=H, intr=JINTR, fused_frame=False,
                        raycast_mode="exact")
ICP_KW = dict(iters=KP.icp_iter_num, dist_thres=KP.icp_dist_thres,
              angle_thres=KP.icp_angle_thres)
STEP = np.asarray([0.004, -0.002, 0.003])  # camera motion per frame, m


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _scene(cam_t):
    """int32 mm depth of the three-sphere scene from a camera at cam_t."""
    ds = [sphere_depth(c, r, cam_t=cam_t, h=H, w=W, intr=JINTR)
          for c, r in SCENE]
    big = np.iinfo(np.int32).max
    out = np.stack([np.where(d == 0, big, d) for d in ds]).min(0)
    return np.where(out == big, 0, out).astype(np.int32)


def _equal_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


# --- se3, the stencil fetch and the pyramids -------------------------------


@pytest.mark.parametrize("rv", [(0.0, 0.0, 0.0), (0.008, -0.012, 0.015),
                                (1.2, -0.4, 2.0)])
def test_rodrigues_and_rvec_match_jax(rv):
    """from_rodrigues within 1e-6 (float32 sin/cos of another library), the
    zero vector exactly the identity; rvec inverts it as the source's."""
    t = np.asarray([0.1, -0.2, 0.3], np.float32)
    Rj, tj = jse3.from_rodrigues(jnp.asarray(rv, jnp.float32), jnp.asarray(t))
    Rt, tt = se3.from_rodrigues(_t(rv, torch.float32), _t(t))
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt, tj)
    if not any(rv):
        np.testing.assert_array_equal(Rt, np.eye(3))
    np.testing.assert_allclose(se3.rvec((Rt, tt)), jse3.rvec((Rj, tj)),
                               rtol=0, atol=1e-5)



def _stencil_inputs(rng, Hs, Ws, C, reach):
    img = rng.standard_normal((Hs, Ws, C)).astype(np.float32)
    img[rng.random((Hs, Ws)) < 0.1] = np.nan
    ys, xs = np.mgrid[0:Hs, 0:Ws]
    vi = np.clip(ys + rng.integers(-reach, reach + 1, ys.shape), 0, Hs - 1)
    ui = np.clip(xs + rng.integers(-reach, reach + 1, xs.shape), 0, Ws - 1)
    return img, vi.astype(np.int32), ui.astype(np.int32)


@pytest.mark.parametrize("radius", [2, 4])
def test_fetch_stencil_plain_matches_jax(radius):
    """Equal to the source's roll-and-select (icp._fetch_stencil) and to
    its Pallas kernel in interpret mode, NaN positions included; flows up to
    radius + 2 so that some fall outside the window."""
    rng = np.random.default_rng(radius)
    img, vi, ui = _stencil_inputs(rng, 24, 32, 6, radius + 2)
    got = stencil_cuda.fetch_stencil(_t(img), _t(vi), _t(ui), radius)
    args = (jnp.asarray(img), jnp.asarray(vi), jnp.asarray(ui), radius)
    _equal_nan(got, jicp._fetch_stencil(*args))
    _equal_nan(got, stencil_pallas.fetch_stencil_tpu(*args, interpret=True))


def test_pyramid_functions_match_jax():
    """depth_pyramid_down, resize_points_normals and resize_depth_normals
    equal the source's, NaN positions included, on depth with holes and the
    source's point and normal maps."""
    rng = np.random.default_rng(0)
    d = heightfield_depth()
    d[rng.random(d.shape) < 0.05] = 0
    d[:7, :9] += 400  # a depth step inside some 5x5 windows
    got = imgproc.depth_pyramid_down(_t(d), 0.04)
    np.testing.assert_array_equal(got, jimg.depth_pyramid_down(
        jnp.asarray(d), 0.04))
    p, n = jimg.compute_points_normals(jnp.asarray(d), JINTR)
    for g, w in zip(imgproc.resize_points_normals(_t(p), _t(n)),
                    jimg.resize_points_normals(p, n)):
        _equal_nan(g, w)
    gd, gn = imgproc.resize_depth_normals(_t(d), _t(n))
    wd, wn = jimg.resize_depth_normals(jnp.asarray(d), n)
    np.testing.assert_array_equal(gd, wd)
    _equal_nan(gn, wn)


# --- ICP on the tests/test_icp.py height field -----------------------------


def _depth_pyramid(depth, levels=4):
    """[(depth_mm, normals)] per level, as the USE_DEPTH build makes it."""
    pyr, d = [], jnp.asarray(depth)
    for lvl in range(levels):
        pyr.append((d, jimg.compute_points_normals(d, JINTR.level(lvl))[1]))
        d = jimg.depth_pyramid_down(d)
    return pyr


def _icp_case(fixture):
    """(curr, prev) JAX pyramids: the height field seen from a camera moved
    by a small rotation and translation, or the fronto-parallel plane moved
    1 cm along z (3 of 6 DOF constrained: the degenerate system)."""
    if fixture == "motion":
        R, _ = jse3.from_rodrigues(jnp.asarray([0.008, -0.012, 0.015]),
                                   jnp.zeros(3))
        R, t, depth = np.asarray(R), np.asarray([0.008, -0.006, 0.01]), \
            heightfield_depth()
    else:
        R, t, depth = np.eye(3), np.asarray([0.0, 0.0, 0.01]), \
            np.full((H, W), 1500, np.int32)
    p, n = make_frame(depth)
    p2, n2 = apply_inv_transform(p, n, R, t)
    return (jicp.build_pyramids(p2, n2, 4), jicp.build_pyramids(p, n, 4),
            depth)


@pytest.mark.parametrize("fixture", ["motion", "plane"])
@pytest.mark.parametrize("variant", ["gather", "stencil", "depth"])
def test_estimate_transform_matches_jax(variant, fixture):
    """The same ok flag, and R, t within 1e-4 of the source's (3e-4 for the
    depth variant): the schedule sums 19,200 rows per iteration in another
    order, and at level 0 a correspondence at a gate flips between
    iterations — the source's own jitted and op-by-op runs of this fixture
    differ by 4e-5 (1.9e-4 on the millimetre-quantised depth, whose fixed
    point is looser). The port is 2.5e-5 to 4.9e-5 from each of the two on
    the gather and stencil variants, as far as they are from each other,
    so no tighter bound holds against either; on the depth variant it is
    6.3e-6 from the op-by-op run, which takes ~17 s cold on the CPU (~2 s
    jitted)."""
    tol = 3e-4 if variant == "depth" else 1e-4
    curr, prev, depth = _icp_case(fixture)
    if variant == "depth":
        shift = 0 if fixture == "plane" else 10
        curr, prev = _depth_pyramid(depth - shift), _depth_pyramid(depth)
    jfn, tfn = {"gather": (jicp.estimate_transform, icp.estimate_transform),
                "stencil": (jicp.estimate_transform_stencil,
                            icp.estimate_transform_stencil),
                "depth": (jicp.estimate_transform_depth,
                          icp.estimate_transform_depth)}[variant]
    (Rj, tj), okj = jfn(curr, prev, JINTR, **ICP_KW)
    tcurr, tprev = ([(_t(a), _t(b)) for a, b in pyr] for pyr in (curr, prev))
    (Rt, tt), okt = tfn(tcurr, tprev, TINTR, **ICP_KW)
    assert bool(okj) == bool(okt)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=tol)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=tol)


# --- raycast ---------------------------------------------------------------


def test_raycast_matches_raycast_march():
    """The per-ray march against the source's raycast_march at 64^3 under a
    rotated, translated camera: hit masks agree on >= 99.5 % of pixels
    (all 9,062 hits here); where both hit, every point within 1e-4 m
    (7e-6 here) and >= 99.5 % of the normals within 1e-3, all within 2e-3:
    a normal is a normalised difference of trilinear samples, which
    amplifies float32 roundoff where the gradient is small (one normal of
    9,062 differs by 1.03e-3 here)."""
    cfg = jtv.TsdfConfig(dims=KP.volume_dims, size=KP.volume_size,
                         trunc_dist=KP.tsdf_trunc_dist,
                         raycast_step_factor=KP.raycast_step_factor,
                         gradient_delta_factor=KP.gradient_delta_factor)
    vol = jtv.create(cfg, (jnp.eye(3), jnp.asarray(KP.volume_pose_t)))
    vol = jtv.integrate(vol, jimg.compute_dists(
        jnp.asarray(_scene(np.zeros(3))), JINTR), jse3.identity(), JINTR,
        cfg)
    R, _ = jse3.from_rodrigues(jnp.asarray([0.03, -0.05, 0.02]),
                               jnp.zeros(3))
    pose = (R, jnp.asarray([0.01, -0.02, 0.015]))
    jp, jn = (np.asarray(a) for a in jtv.raycast_march(vol, pose, JINTR,
                                                       (H, W), cfg))
    tcfg = tv.TsdfConfig(cfg.dims, cfg.size, cfg.trunc_dist, cfg.max_weight,
                         cfg.raycast_step_factor, cfg.gradient_delta_factor)
    tp, tn = (a.numpy() for a in tv.raycast(
        convert.volume(*vol, device="cpu"), tuple(np.array(a) for a in pose),
        TINTR, (H, W), tcfg))
    hj, ht = ~np.isnan(jp[..., 0]), ~np.isnan(tp[..., 0])
    assert hj.sum() > 5000 and (hj == ht).mean() >= 0.995
    both = hj & ht
    dp = np.abs(jp[both] - tp[both]).max(-1)
    dn = np.abs(jn[both] - tn[both]).max(-1)
    assert dp.max() <= 1e-4
    assert (dn <= 1e-3).mean() >= 0.995 and dn.max() <= 2e-3


# --- the KinFu engine ------------------------------------------------------


FRAMES = [_scene(STEP * i) for i in range(4)]


def _kinfu_state(e):
    return dict(vol=tuple(np.array(a) for a in e.vol),
                poses=[(np.array(R), np.array(t)) for R, t in e.poses],
                prev_pyr=None if e.prev_pyr is None else
                [(np.array(p), np.array(n)) for p, n in e.prev_pyr],
                frame_counter=e.frame_counter)


@pytest.fixture(scope="module")
def jax_kinfu():
    """One run of the source's KinFu on FRAMES, the per-stage path with the
    exact formulations: (state before frame i, pose after frame i)."""
    eng = JaxKinFu(KP)
    states, poses = [], []
    for d in FRAMES:
        states.append(_kinfu_state(eng))
        eng(d)
        poses.append(tuple(np.array(a) for a in eng.get_camera_pose()))
    return states, poses


def _port_kinfu():
    return KinFu(convert.params(KP), device="cpu")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kinfu_frame_from_jax_state(jax_kinfu, k):
    """Frame k from the source's state after frame k - 1 (its volume, pose
    history and raycast pyramid): the same pose within 1e-4 (the ICP
    tolerance above), the same frame count, no reset."""
    states, poses = jax_kinfu
    port = convert.load_kinfu_state(_port_kinfu(), **states[k])
    assert port(FRAMES[k]) is (k >= 2)
    assert port.frame_counter == k + 1 and port.resets == 0
    np.testing.assert_allclose(port.poses[-1][0], poses[k][0], atol=1e-4)
    np.testing.assert_allclose(port.poses[-1][1], poses[k][1], atol=1e-4)


def test_kinfu_free_running_four_frames(jax_kinfu):
    """The port alone over the four frames: final pose within 5 mm and
    0.005 of the source's, and within 5 mm of the true camera. The source
    raycasts a rotated pose with its slab sweep, the port with the per-ray
    march; the two reference pyramids differ by up to a march step at
    silhouettes, which moves the next frames' ICP by millimetres at this
    64^3, 120x160 size."""
    _, poses = jax_kinfu
    port = _port_kinfu()
    for d in FRAMES:
        port(d)
    assert port.resets == 0 and len(port.poses) == len(FRAMES)
    R, t = port.get_camera_pose()
    np.testing.assert_allclose(R, poses[-1][0], atol=5e-3)
    np.testing.assert_allclose(t, poses[-1][1], atol=5e-3)
    np.testing.assert_allclose(t, STEP * 3, atol=5e-3)
    # the reference's accessors: the clamp, the volume, the world-frame mesh
    assert port.get_camera_pose(99) is port.poses[-1]
    assert port.get_camera_pose(0) is port.poses[0]
    assert port.tsdf() is port.vol
    verts, n = port.get_mesh(max_voxels=1 << 13, max_verts=3 * 8192)
    assert n > 300 and verts.shape == (n, 3)
    dist = torch.stack([(verts - torch.tensor(c)).norm(dim=-1) - r
                        for c, r in SCENE]).abs().min(0).values
    assert float(dist.median()) < 0.01


def test_kinfu_reset_is_immediate(jax_kinfu):
    """A frame without depth makes both ICP tiers degenerate. The port, as
    the reference (kinfu.cpp:189-191) and the source's per-stage path,
    resets on that frame and bootstraps on the next; the source's fused
    frame resets one frame late and drops the next frame
    (tests/test_pipeline.py pins that lag). Both engines here then track a
    static pair to the same pose."""
    jax_eng = JaxKinFu(KP)
    port = _port_kinfu()
    empty = np.zeros((H, W), np.int32)
    seq = [FRAMES[0], FRAMES[0], empty, FRAMES[0], FRAMES[1]]
    trace = {"jax": [], "port": []}
    for d in seq:
        for name, eng in (("jax", jax_eng), ("port", port)):
            trace[name].append((eng(d), eng.frame_counter, len(eng.poses)))
    assert trace["port"] == trace["jax"]
    assert trace["port"][2] == (False, 0, 1)  # reset on the failing frame
    assert port.resets == 1
    np.testing.assert_allclose(port.poses[-1][1], jax_eng.poses[-1][1],
                               atol=1e-4)


# --- DynFusion: what the port refuses, and the camera tracking ------------


def test_fg_aabb_raises():
    """Foreground tracking is not ported: parity mode refuses fg_aabb."""
    params = convert.params(dataclasses.replace(
        small_dynfu_params(), fg_aabb=((0.0, 0.0, 0.0), (1.0, 1.0, 0.6)),
        max_fg_verts=1 << 13))
    with pytest.raises(NotImplementedError, match="item 11"):
        DynFusion(params, device="cpu")


def test_fusion_track_pose_matches_jax():
    """One camera-tracking step of fusion mode (_fusion_track_pose) from
    the same state: the deforming-region mask equal, the pose within 1e-4
    (the ICP tolerance above). The canonical is 4096 points of the big
    sphere; a third of them warped 2 cm away, which masks them."""
    dp = dataclasses.replace(
        small_dynfu_params(), kinfu=KP, solver_rotations=True,
        corr_unique_edges=True, fusion_camera_tracking=True)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((4096, 3))
    cv = (np.asarray(SCENE[0][0]) - np.asarray(KP.volume_pose_t)
          + SCENE[0][1] * u / np.linalg.norm(u, axis=1, keepdims=True))
    cv = cv.astype(np.float32)
    wv = cv + np.where(np.arange(4096)[:, None] % 3 == 0, 0.02,
                       0.0).astype(np.float32)
    m = np.arange(4096) < 4000
    d0, d1 = FRAMES[0], FRAMES[1]

    jax_eng = JaxDynFusion(dp, mode="fusion")
    port = DynFusion(convert.params(dp), device="cpu", mode="fusion")
    jax_eng.canonical = JFrame(0, jnp.asarray(cv), jnp.asarray(cv),
                               jnp.asarray(m))
    jax_eng.canonical_warped = JFrame(0, jnp.asarray(wv), jnp.asarray(wv),
                                      jnp.asarray(m))
    port.canonical = Frame(0, _t(cv), _t(cv), _t(m))
    port.canonical_warped = Frame(0, _t(wv), _t(wv), _t(m))
    _, jpyr = jax_eng._preprocess(jnp.asarray(d0))
    jax_eng.prev_live_pyr = jpyr
    port.prev_live_pyr = convert.pyramid(
        [(np.array(p), np.array(n)) for p, n in jpyr], "cpu")

    vol = jax_eng.vol
    kw = dict(intr=JINTR, thresh=float(min(jax_eng.tsdf_config.voxel_size)),
              dilate=8)
    want = j_mask(jnp.asarray(d1), jnp.asarray(cv), jnp.asarray(wv),
                  jnp.asarray(m), jax_eng.poses[-1], vol.pose_r, vol.pose_t,
                  **kw)
    got = t_mask(_t(d1), _t(cv), _t(wv), _t(m), port.poses[-1],
                 port.vol.pose_r, port.vol.pose_t, **kw)
    np.testing.assert_array_equal(got, want)
    assert (np.asarray(want) == 0).sum() > (d1 == 0).sum() + 500

    jax_eng._fusion_track_pose(d1)
    port._fusion_track_pose(_t(d1))
    assert len(port.poses) == len(jax_eng.poses) == 2
    for a, b in zip(port.poses[-1], jax_eng.poses[-1]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


# --- the kernel against its plain version, on the card --------------------


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd", "radius6", "all_nan",
                                  "out_of_window"])
def test_fetch_stencil_kernel_equals_plain(dev, case):
    """Exactly equal, NaN positions included: odd sizes and channel counts
    (37x53, C = 5), the widest radius (6), an all-NaN image, and indices
    whose flow is outside the window everywhere."""
    rng = np.random.default_rng(7)
    Hs, Ws, C, radius, reach = 37, 53, 5, 2, 4
    if case == "radius6":
        Hs, Ws, C, radius, reach = 15, 20, 6, 6, 9
    img, vi, ui = _stencil_inputs(rng, Hs, Ws, C, reach)
    if case == "all_nan":
        img[:] = np.nan
    if case == "out_of_window":
        ys, xs = np.mgrid[0:Hs, 0:Ws]
        vi = np.where(ys < Hs // 2, Hs - 1, 0).astype(np.int32)
        ui = np.where(xs < Ws // 2, Ws - 1, 0).astype(np.int32)
    args = [torch.as_tensor(a, device=dev) for a in (img, vi, ui)]
    got = stencil_cuda.fetch_stencil(*args, radius)
    want = stencil_cuda.fetch_stencil_plain(*args, radius)
    torch.cuda.synchronize()
    _equal_nan(got.cpu(), want.cpu())
    if case == "out_of_window":
        assert torch.isnan(got).all()


# --- the parity DynFusion frame loop ---------------------------------------
SLICE_FRAMES = [sphere_depth((CENTER[0] + 0.005 * i, CENTER[1], CENTER[2]),
                       RADIUS) for i in range(3)]



def _state(e):
    """The JAX engine's state as numpy arrays, for utils/convert."""
    return dict(
        vol=tuple(np.array(a) for a in e.vol),
        wf=tuple(np.array(a) for a in e.warpfield),
        canonical=(e.canonical.idx, np.array(e.canonical.vertices),
                   np.array(e.canonical.normals), np.array(e.canonical.mask)),
        soup_inverse=np.array(e.soup_inverse),
        soup_mask=np.array(e.soup_mask),
        canonical_mult=np.array(e.canonical_mult),
        frame_counter=e.frame_counter,
        poses=[(np.array(R), np.array(t)) for R, t in e.poses])


def _outputs(e, to_np):
    """Per-frame observables: the warped cloud (pre-solve warp), the
    canonical through the frame's final field (warped by the port's warp
    for both engines, so the solved fields are compared in meters), the
    node count and positions, the drop counters."""
    v, m = e.warped_cloud(unique=True)
    wf = convert.warpfield(*(to_np(a) for a in e.warpfield), device="cpu")
    c = torch.as_tensor(to_np(e.canonical.vertices))
    post, _ = tfield.warp_points_normals(wf, c, c)
    fs = e.last_frame_stats
    return dict(
        warped=to_np(v), mask=to_np(m), post=post.numpy(),
        count=int(e.warpfield.count), node_pos=to_np(e.warpfield.pos),
        mc_dropped=None if fs is None else int(fs.mc_dropped),
        corr_dropped=None if fs is None else int(fs.corr_dropped))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX run: (state before frame i, outputs after frame i)."""
    eng = JaxDynFusion(small_dynfu_params())
    states, outs = [], []
    for d in SLICE_FRAMES:
        states.append(_state(eng) if eng.frame_counter else None)
        eng(d)
        outs.append(_outputs(eng, np.array))
        # frame 0 leaves a weakly typed dg_w array, and a later frame a
        # strongly typed one: the same values, but a second compile of the
        # whole frame program (~8 s here). Pin the type once.
        wf = eng.warpfield
        eng.warpfield = wf._replace(w=jnp.asarray(np.array(wf.w)))
    return states, outs


def _port_outputs(e):
    return _outputs(e, lambda t: t.cpu().numpy())


def _port(jax_params=None):
    return DynFusion(convert.params(jax_params or small_dynfu_params()),
                     device="cpu")


def test_frame0_matches(jax_run):
    """Bootstrap: the same canonical (dedup order included) and nodes."""
    _, outs = jax_run
    port = _port()
    assert port(SLICE_FRAMES[0]) is False
    got, want = _port_outputs(port), outs[0]
    assert got["count"] == want["count"] > 3
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["warped"], want["warped"])
    np.testing.assert_array_equal(got["node_pos"], want["node_pos"])


@pytest.mark.parametrize("k", [1, 2])
def test_tracked_frame_from_jax_state(jax_run, k):
    """Frame k from JAX's state after frame k-1: the same drop counters
    and node count; the warped cloud, and the canonical through the
    solved and grown field, within 1e-4 m (float32 roundoff through the
    solve; the selections are equal)."""
    states, outs = jax_run
    port = convert.load_engine_state(_port(), **states[k])
    assert port(SLICE_FRAMES[k]) is True
    got, want = _port_outputs(port), outs[k]
    assert got["mc_dropped"] == want["mc_dropped"] == 0
    assert got["corr_dropped"] == want["corr_dropped"] == 0
    assert got["count"] == want["count"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    np.testing.assert_allclose(got["warped"][m], want["warped"][m], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["post"][m], want["post"][m], rtol=0,
                               atol=1e-4)


def test_free_running_three_frames(jax_run):
    """The port alone over all three frames: the same node count, and the
    final warped canonical within 1e-3 m of JAX's (roundoff compounds
    through two solves and their Tukey cutoffs)."""
    _, outs = jax_run
    port = _port()
    for d in SLICE_FRAMES:
        port(d)
    got, want = _port_outputs(port), outs[-1]
    assert got["count"] == want["count"]
    assert got["corr_dropped"] == want["corr_dropped"] == 0
    m = want["mask"]
    np.testing.assert_array_equal(got["mask"], m)
    assert torch.isfinite(torch.as_tensor(got["post"][m])).all()
    np.testing.assert_allclose(got["post"][m], want["post"][m], rtol=0,
                               atol=1e-3)


def _load_jax(e, st):
    """Install a _state() snapshot into the JAX engine `e`."""
    e.vol = JVolume(*(jnp.asarray(a) for a in st["vol"]))
    e.warpfield = JWarpField(*(jnp.asarray(a) for a in st["wf"]))
    idx, v, n, m = st["canonical"]
    e.canonical = JFrame(idx, jnp.asarray(v), jnp.asarray(n), jnp.asarray(m))
    e.canonical_warped = e.canonical
    for k in ("soup_inverse", "soup_mask", "canonical_mult"):
        setattr(e, k, jnp.asarray(st[k]))
    e.frame_counter = st["frame_counter"]
    e.poses = list(st["poses"])
    return e


def test_unique_edge_frame_from_jax_state(jax_run):
    """Frame 1 with corr_unique_edges (the >= 384^3 preset's live set: the
    unique isosurface edge vertices instead of the marching-cubes soup) from
    JAX's state after frame 0: the live set equal index for index, the same
    counters and node count, the soup left to mesh() on demand, the warped
    cloud within 1e-4 m as in the test above."""
    states, _ = jax_run
    params = dataclasses.replace(small_dynfu_params(), corr_unique_edges=True,
                                 max_edge_verts=1 << 13, edge_col_budget=8)
    jax_eng = _load_jax(JaxDynFusion(params), states[1])
    jax_eng(SLICE_FRAMES[1])
    port = convert.load_engine_state(_port(params), **states[1])
    assert port(SLICE_FRAMES[1]) is True
    np.testing.assert_array_equal(port.live.vertices,
                                  np.asarray(jax_eng.live.vertices))
    np.testing.assert_array_equal(port.live.mask,
                                  np.asarray(jax_eng.live.mask))
    assert int(port.live.mask.sum()) > 500
    got, want = _port_outputs(port), _outputs(jax_eng, np.array)
    for k in ("mc_dropped", "corr_dropped", "count"):
        assert got[k] == want[k]
    assert port.mesh_vertices is None and jax_eng.mesh_vertices is None
    m = want["mask"]
    np.testing.assert_allclose(got["warped"][m], want["warped"][m], rtol=0,
                               atol=1e-4)
    verts, n = port.mesh()
    assert int(n) > 0 and torch.isfinite(verts[:int(n)]).all()
