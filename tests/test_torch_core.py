"""PyTorch port vs JAX reference on the CPU, seeded numpy inputs handed to
both packages: dual quaternions, depth preprocessing and the port's import
boundary (no jax); TSDF integration, marching cubes and the triangle-pack
kernel's plain version; dense compaction (ops/compaction.py), marching
cubes' column-budget branch, the unique edge-vertex extraction
(mesh/edges.py) and the depth point/normal maps; the GN data-term Gram and
the warp solve on the reference's Opt fixtures (tests/test_solver_parity.py).
Where the port's kernel wrappers get CPU tensors they run their plain
versions.

The JAX side packs z-columns into 32-bit words; its masks are unpacked to
bool here so both sides see the same cells. Capacities are set small so
that every overflow rule (per-column budget, active columns, active words,
output size) fires. A plain model of the Gram kernels' fixed summation
order (the data Gram's and the monomial Grams') is held against the plain
versions and against a sequential Python sum.

The tests marked `cuda` hold the pack kernel and the data Gram kernel
against their plain versions, and the data Gram against itself over three
launches and against the fixed-order model (they skip without a card)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.core import se3 as jse3
from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.mesh import edges as jedges
from dynfu_tpu.mesh import mc as jmc
from dynfu_tpu.mesh import mc_pallas
from dynfu_tpu.ops import compaction as jcomp
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.solver import gn as jgn
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.volume import fusion as jfusion
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core import dualquat as tdq
from dynfu_tpu_torch.core import se3 as tse3
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.mesh import edges as tedges
from dynfu_tpu_torch.mesh import mc as tmc
from dynfu_tpu_torch.mesh import mc_cuda
from dynfu_tpu_torch.ops import compaction as tcomp
from dynfu_tpu_torch.ops import imgproc as timg
from dynfu_tpu_torch.solver import gn as tgn
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.volume import fusion as tfusion
from dynfu_tpu_torch.volume import sweep_cuda
from dynfu_tpu_torch.volume import tsdf as ttv
from dynfu_tpu_torch.warp import field as tfield

from test_torch_fusion import module_refs
from test_solver_parity import (ALL_NODES, DG_W, GROUP1, LAMBDA, MAX_ERROR,
                                PSI_DATA, PSI_REG, SRC5, SRC5B, TGT5, TGT5B,
                                TGT5C, TUKEY_OFFSET)


# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

H, W = 96, 128
INTR = (140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
VOL_T = np.asarray([-0.5, -0.5, 0.25], np.float32)
IDENT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


# --- dual quaternions, preprocessing, the import boundary ----------------
REPO = Path(__file__).resolve().parent.parent

# the reference suite's own tolerance (test/quaternion_test.cpp)
DQ_TOL = 1e-4


def _rand_dq(rng, n):
    # rotations below ~110 deg: tan(theta / 2) in dq_rodrigues stays far
    # from its pole, where f32 acos error would be amplified without bound
    rot = np.concatenate([np.ones((n, 1)), rng.normal(0, 0.5, (n, 3))], 1)
    rot = (rot / np.linalg.norm(rot, axis=1, keepdims=True)).astype(np.float32)
    t = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return np.array(jdq.dq_from_quat_translation(rot, t))


def _dq_cases(rng):
    n = 64
    a, b = _rand_dq(rng, n), _rand_dq(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    q4 = rng.normal(size=(n, 4)).astype(np.float32)
    t3 = rng.normal(size=(n, 3)).astype(np.float32)
    r3 = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    ang = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    return {
        "quat_mul": (q4, q4[::-1].copy()),
        "quat_normalize_cayley": (q4,),
        "dq_mul": (a, b),
        "dq_conj": (a,),
        "dq_scale": (a, s),
        "dq_normalize": (a * 1.5,),
        "dq_normalize_joint": (a * 1.5,),
        "dq_transform_point": (a, v),
        "dq_transform_normal": (a, v),
        "dq_rotate_vector": (a, v),
        "dq_translation": (a,),
        "dq_from_quat_translation": (q4, t3),
        "dq_from_translation": (t3,),
        "dq_from_rodrigues": (r3, t3),
        "dq_from_euler": (ang[0], ang[1], ang[2], 0.1, -0.2, 0.3),
        "dq_euler_angles": (a,),
        "dq_rodrigues": (a,),
    }


@pytest.mark.parametrize("name", sorted(_dq_cases(np.random.default_rng(0))))
def test_dualquat_matches_jax(name):
    args = _dq_cases(np.random.default_rng(0))[name]
    want = np.asarray(getattr(jdq, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(tdq, name)(
        *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args]).numpy()
    np.testing.assert_allclose(got, want, atol=DQ_TOL, rtol=0)


def _depth_image(rng, H=48, W=64):
    d = rng.integers(400, 3000, (H, W)).astype(np.int32)
    d[rng.random((H, W)) < 0.1] = 0  # holes
    return d


def test_compute_dists_exact_f16():
    """Exact, including the float16 narrowing (the reference packs half)."""
    rng = np.random.default_rng(1)
    d = _depth_image(rng)
    intr = (140.0, 141.0, 31.5, 23.5)
    want = np.asarray(jimg.compute_dists(jnp.asarray(d), JIntr(*intr)))
    got = timg.compute_dists(torch.as_tensor(d), TIntr(*intr)).numpy()
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize,sig_s,sig_d,max_off", [
    (7, 4.5, 0.04, 0),  # the engine's parameters: exact
    (5, 2.0, 0.1, 2),
])
def test_bilateral_filter(ksize, sig_s, sig_d, max_off):
    """The rounded weighted mean, with the exclusive window bound. XLA's
    and PyTorch's float32 exp differ by one ulp on ~10% of arguments, so a
    mean within roundoff of a .5 boundary can round the other way: at most
    `max_off` pixels may differ, by 1 mm (the engine's parameters: none)."""
    rng = np.random.default_rng(2)
    d = _depth_image(rng)
    want = np.asarray(jimg.bilateral_filter(jnp.asarray(d), ksize, sig_s,
                                            sig_d))
    got = timg.bilateral_filter(torch.as_tensor(d), ksize, sig_s,
                                sig_d).numpy()
    off = got != want
    assert np.count_nonzero(off) <= max_off
    assert np.abs(got.astype(np.int64) - want).max() <= (1 if max_off else 0)


def test_truncate_depth_exact():
    d = _depth_image(np.random.default_rng(3))
    want = np.asarray(jimg.truncate_depth(jnp.asarray(d), 1.5))
    got = timg.truncate_depth(torch.as_tensor(d), 1.5).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_never_imports_jax():
    """`import dynfu_tpu_torch` and every submodule leave jax (and the JAX
    package) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dynfu_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynfu_tpu_torch.__path__,"
        " 'dynfu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or"
        " n.startswith(('jax.', 'jaxlib', 'dynfu_tpu.')) or n == 'dynfu_tpu')\n"
        "n = sum(1 for n in sys.modules if n.startswith('dynfu_tpu_torch.'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 20 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_wrappers_reject_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    any other non-CUDA device raises instead of falling back."""
    from dynfu_tpu_torch.mesh import mc_cuda

    meta = torch.empty((4, 5, 9), device="meta")
    with pytest.raises(ValueError):
        mc_cuda.pack_triangles(meta, meta[:, 0, 0].int(), meta[:, 0, 0].int(),
                               8)


# --- TSDF integration, marching cubes, the triangle pack ----------------
def _config(dims):
    kw = dict(dims=(dims,) * 3, size=(1.0, 1.0, 1.0), trunc_dist=0.03)
    return jtv.TsdfConfig(**kw), ttv.TsdfConfig(**kw)


def _depth(dx=0.0, radius=0.22):
    return sphere_depth((dx, 0.0, 0.75), radius, H, W, *INTR)


def _dists(depth):
    return np.asarray(jimg.compute_dists(jnp.asarray(depth), JIntr(*INTR)))


def _jvol(cfg):
    return jtv.create(cfg, (jnp.eye(3), jnp.asarray(VOL_T)))


def _tvol(cfg):
    return ttv.create(cfg, (torch.eye(3), torch.as_tensor(VOL_T)),
                      device="cpu")


def _assert_vol_equal(jv, tv):
    np.testing.assert_array_equal(tv.tsdf.numpy(), np.asarray(jv.tsdf))
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))


def _np(out):
    """A result (tensor, array, number or a tuple of them) as numpy."""
    if isinstance(out, (tuple, list)):
        return tuple(_np(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


def _small_case(name, refs):
    """(JAX's result, the port's) of one small public function on seeded
    inputs (raycast_depth's JAX result from the module's `refs`)."""
    rng = np.random.default_rng(3)
    jintr, tintr = JIntr(*INTR), TIntr(*INTR)
    pts = (rng.normal(size=(50, 3)) * 0.2 + [0, 0, 1]).astype(np.float32)
    R = _rot(17.0)
    t = rng.normal(size=3).astype(np.float32)
    pose = (R, t)
    if name == "intr_project":
        return jintr.project(jnp.asarray(pts)), tintr.project(
            torch.as_tensor(pts))
    if name == "intr_reproject":
        u, v, z = (rng.uniform(0, 100, 50).astype(np.float32),
                   rng.uniform(0, 80, 50).astype(np.float32),
                   rng.uniform(0.4, 3.0, 50).astype(np.float32))
        return (jintr.reproject(*(jnp.asarray(a) for a in (u, v, z))),
                tintr.reproject(*(torch.as_tensor(a) for a in (u, v, z))))
    if name in ("se3_apply", "se3_rotate"):
        fn = name.split("_")[1]
        return (getattr(jse3, fn)(jse3.make(R, t), jnp.asarray(pts)),
                getattr(tse3, fn)(tse3.make(R, t), torch.as_tensor(pts)))
    if name == "se3_make":
        return jse3.make(R, t), tse3.make(R, t)
    if name in ("dq_add", "dq_sub"):
        a, b = (rng.normal(size=(20, 8)).astype(np.float32)
                for _ in range(2))
        return (getattr(jdq, name)(jnp.asarray(a), jnp.asarray(b)),
                getattr(tdq, name)(torch.as_tensor(a), torch.as_tensor(b)))
    if name == "compute_normals_and_mask_depth":
        d = _depth_image(rng)
        return (jimg.compute_normals_and_mask_depth(jnp.asarray(d), jintr),
                timg.compute_normals_and_mask_depth(torch.as_tensor(d),
                                                    tintr))
    jcfg, tcfg = _config(64)
    if name == "set_pose":
        jv, tv = (mod.set_pose(vol, pose) for mod, vol in
                  ((jtv, _jvol(jcfg)), (ttv, _tvol(tcfg))))
        return (jv.pose_r, jv.pose_t), (tv.pose_r, tv.pose_t)
    if name == "apply_affine":
        jv = jtv.apply_affine(_jvol(jcfg), (jnp.asarray(R), jnp.asarray(t)))
        tv = ttv.apply_affine(_tvol(tcfg), pose)
        return (jv.pose_r, jv.pose_t), (tv.pose_r, tv.pose_t)
    if name == "band_budget":
        return ([jfusion.band_budget(c, d) for c in (jcfg, _config(512)[0])
                 for d in (0, 1, 3)],
                [tfusion.band_budget(c, d) for c in (tcfg, _config(512)[1])
                 for d in (0, 1, 3)])
    assert name == "raycast_depth"
    # both convert their `raycast`, the slab sweep
    jcfg, tcfg, jv, tv = _swept_volume()
    return (refs["views"]["raycast_depth"],
            ttv.raycast_depth(tv, IDENT, tintr, (H, W), tcfg))


SMALL = ["intr_project", "intr_reproject", "se3_make", "se3_apply",
         "se3_rotate", "dq_add", "dq_sub", "compute_normals_and_mask_depth",
         "set_pose", "apply_affine", "band_budget", "raycast_depth"]


NORMALS_TOL = {"compute_normals_and_mask_depth": 1e-5}


def _rot(angle_deg):
    a = np.deg2rad(angle_deg)
    return np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]], np.float32)


@pytest.mark.parametrize("rot_deg", [0.0, 3.0])
def test_integrate_matches_tv_integrate(rot_deg):
    """Two accumulating frames against tv.integrate (per-voxel gather path),
    at an identity and at a rotated camera: f16 tsdf and u8 weight exact."""
    jcfg, tcfg = _config(64)
    pose = (_rot(rot_deg), np.asarray([0.01, 0.0, 0.0], np.float32))
    jv, tv = _jvol(jcfg), _tvol(tcfg)
    for dx in (0.0, 0.01):
        dists = _dists(_depth(dx))
        jv = jtv.integrate(jv, jnp.asarray(dists), pose, JIntr(*INTR), jcfg)
        tv = ttv.integrate(tv, torch.as_tensor(dists), pose, TIntr(*INTR),
                           tcfg)
    assert int(np.count_nonzero(np.asarray(jv.weight) == 2)) > 1000
    _assert_vol_equal(jv, tv)


def test_integrate_fresh_matches_separable():
    """fresh=True against the frame's integrate_separable(fresh=True): the
    previous volume is ignored, exactly."""
    jcfg, tcfg = _config(64)
    d0, d1 = _dists(_depth(0.0)), _dists(_depth(0.02))
    jv = jtv.integrate_separable(_jvol(jcfg), jnp.asarray(d0), IDENT,
                                 JIntr(*INTR), jcfg)
    jv = jtv.integrate_separable(jv, jnp.asarray(d1), IDENT, JIntr(*INTR),
                                 jcfg, fresh=True)
    tv = ttv.integrate(_tvol(tcfg), torch.as_tensor(d0), IDENT, TIntr(*INTR),
                       tcfg)
    tv = ttv.integrate(tv, torch.as_tensor(d1), IDENT, TIntr(*INTR), tcfg,
                       fresh=True)
    _assert_vol_equal(jv, tv)


# --- the slab sweeps, the homography formulations, the dispatch ----------
_R3 = np.asarray(jse3.from_rodrigues(jnp.asarray([0.03, -0.05, 0.02]),
                                     jnp.zeros(3))[0])
POSES = {"identity": IDENT,
         "rotated": (_R3, np.asarray([0.01, -0.02, 0.015], np.float32)),
         "translated": (np.eye(3, dtype=np.float32),
                        np.asarray([0.01, -0.02, 0.015], np.float32))}


def _swept_volume(dx=0.0):
    """The sphere integrated at the identity into a 64^3 volume (the port's
    integrate, the source's bits), as (jcfg, tcfg, JAX volume, port
    volume)."""
    jcfg, tcfg = _config(64)
    tv = ttv.integrate(_tvol(tcfg), torch.as_tensor(_dists(_depth(dx))),
                       IDENT, TIntr(*INTR), tcfg)
    jv = jtv.TsdfVolume(jnp.asarray(tv.tsdf.numpy()),
                        jnp.asarray(tv.weight.numpy()), jnp.eye(3),
                        jnp.asarray(VOL_T))
    return jcfg, tcfg, jv, tv


def _hold_sweep_normals(got, want):
    """A sweep's normals: NaN at the same pixels; within 2e-4 at all but
    0.1 % of the hits. A normal is the bilinear's gradient, which jumps
    where a sample crosses a cell edge: where a sample lies on an edge
    (py = 21.0 exactly, say), the source's compiled program, which fuses
    multiply-adds, puts it in the other cell, and the normal turns (by up
    to 0.85; 4 of 6,251 hits in test_sweep_matches_jax[raycast-identity],
    the others within 1.6e-4)."""
    got, want = np.asarray(got), np.asarray(want)
    hit = ~np.isnan(want[..., 0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    dn = np.abs(got[hit] - want[hit]).max(-1)
    assert (dn > 2e-4).mean() <= 1e-3, np.sort(dn)[-10:]


def _hold_sweep(got, want, min_hits=3000):
    """A raycast against the source's: the same hit mask (no sample of
    these scenes lies within roundoff of zero), points within 1e-5 m (the
    sample positions round otherwise under fused multiply-adds; 1.9e-6
    measured) and normals as _hold_sweep_normals holds them."""
    (gp, gn), (wp, wn) = _np(got), _np(want)
    hit = ~np.isnan(wp[..., 0])
    assert hit.sum() > min_hits
    np.testing.assert_array_equal(~np.isnan(gp[..., 0]), hit)
    np.testing.assert_allclose(gp[hit], wp[hit], rtol=0, atol=1e-5)
    _hold_sweep_normals(gn, wn)


SWEEP_CASES = [("raycast", "identity"), ("raycast", "rotated"),
               ("raycast_separable", "identity"),
               ("raycast_separable", "translated")]


def _summary_numpy(slabs):
    """The sign summary brick by brick, one bit a brick (bit i of byte j is
    x brick 8 j + i): set where every value a sample with its lower corner
    in the brick reads (the brick, its +1 row and its +1 plane) is >= 0,
    NaN and negative values not."""
    S, Y, nx = slabs.shape
    bg, by, bx = ttv.BRICK
    L, nyb, nxb = -(-S // bg), -(-(Y - 1) // by), -(-(nx - 1) // bx)
    out = np.zeros((L, nyb, -(-nxb // 8) * 8), np.uint8)
    for l in range(L):
        for j in range(nyb):
            for i in range(nxb):
                b = slabs[l * bg:(l + 1) * bg, j * by:(j + 1) * by + 1,
                          i * bx:(i + 1) * bx + 1]
                out[l, j, i] = bool((b >= 0).all())
    return np.packbits(out, axis=-1, bitorder="little")


@pytest.mark.parametrize("volume", ["seeded", "sphere"])
def test_slab_stack_matches_jax(volume):
    """sweep_cuda.slab_stack's plain version (the kernel's CPU version):
    the slabs bitwise JAX's own stack (jnp.transpose(tsdf[:, :, ::m], (2,
    1, 0)), the source sweep's), the summary equal to a numpy one brick by
    brick; the whole volume and an x-block with its halo. "seeded": a
    40x48x37 volume of +1 and unseen 0 (with -0.0) at m = 3, scattered
    single negative voxels and a NaN; "sphere": the sphere integrated into
    64^3 at the general sweep's m."""
    if volume == "seeded":
        rng = np.random.default_rng(5)
        t = np.where(rng.random((40, 48, 37)) < 0.6, 1.0, 0.0)
        t[rng.random(t.shape) < 0.05] = -0.0
        neg = rng.integers(0, t.shape, (30, 3))
        t[neg[:, 0], neg[:, 1], neg[:, 2] // 3 * 3] = -0.25
        t[7, 9, 12] = np.nan
        tsdf, m = t.astype(np.float16), 3
    else:
        _, tcfg, jv, _ = _swept_volume()
        tsdf = np.asarray(jv.tsdf)
        m = ttv.sweep_spec("general", (H, W), tcfg).m
    for lo, hi in ((0, tsdf.shape[0]), (15, tsdf.shape[0])):
        part = tsdf[lo:hi]
        slabs, summary = sweep_cuda.slab_stack(torch.as_tensor(part), m)
        want = np.asarray(jnp.transpose(jnp.asarray(part)[:, :, ::m],
                                        (2, 1, 0)))
        np.testing.assert_array_equal(slabs.numpy().view(np.int16),
                                      want.view(np.int16))
        np.testing.assert_array_equal(summary.numpy(), _summary_numpy(want))
        marked = ttv.marked_bricks(summary, part.shape[0])
        assert 0 < marked.sum() < marked.numel()


def test_slab_sweep_refuses_another_stacks_summary():
    """The sweep's kernel skips by the summary, so its plain version holds
    each caller to passing the summary of the stack it sweeps: the 64^3
    sphere's stack with its own summary sweeps; with every brick marked,
    or with the summary of the same volume one plane further in x, it
    raises."""
    _, tcfg, _, tv = _swept_volume()
    spec = ttv.sweep_spec("separable", (H, W), tcfg)
    geo, rays = ttv.separable_rays(tv, POSES["translated"], TIntr(*INTR),
                                   (H, W))
    stack = sweep_cuda.slab_stack(tv.tsdf, spec.m)
    pts, _ = sweep_cuda.slab_sweep(stack, geo, rays, spec)
    assert (~torch.isnan(pts[..., 0])).sum() > 100
    moved = sweep_cuda.slab_stack(torch.roll(tv.tsdf, 1, 0), spec.m)
    for summary in (torch.full_like(stack.summary, 255), moved.summary):
        assert not torch.equal(summary, stack.summary)
        with pytest.raises(ValueError, match="not the stack's"):
            sweep_cuda.slab_sweep(stack._replace(summary=summary), geo,
                                  rays, spec)


ROTATED_CASES = [(0.05, 1.15), (0.35, 1.6)]


def _rotated_pose(tilt):
    axis = np.asarray([0.6, -0.8, 0.3]) / np.linalg.norm([0.6, -0.8, 0.3])
    R, _ = jse3.from_rodrigues(jnp.asarray(axis * tilt, jnp.float32),
                               jnp.zeros(3))
    return (np.asarray(R), np.asarray([0.01, -0.02, 0.015], np.float32))


def test_warp_image_nearest_exact():
    """_warp_image_nearest (and _homography_pixels under it) equal to the
    source's, index for index, on seeded images through rotation
    homographies between two cameras, a small and a large tilt."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 4000, (H, W)).astype(np.float32)
    src = (150.0, 150.0, W / 2 + 1.5, H / 2 - 2.5)
    for rv in ([0.01, -0.02, 0.005], [0.1, 0.15, -0.12]):
        R = np.asarray(jse3.from_rodrigues(jnp.asarray(rv, jnp.float32),
                                           jnp.zeros(3))[0])
        jH = jtv._rotation_homography(jnp.asarray(R), JIntr(*INTR),
                                      JIntr(*src))
        tH = ttv._rotation_homography(torch.as_tensor(R), TIntr(*INTR),
                                      TIntr(*src))
        np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-6)
        want = np.asarray(jtv._warp_image_nearest(jnp.asarray(img), jH,
                                                  (H, W)))
        got = ttv._warp_image_nearest(torch.as_tensor(img),
                                      torch.as_tensor(np.asarray(jH)),
                                      (H, W)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want == 0).mean() < 0.5


@pytest.mark.parametrize("tilt", [0.05, 0.4])
def test_integrate_rotated_matches_jax(tilt):
    """integrate_rotated over two accumulating frames, the second fresh,
    against the source's at two tilts: f16 tsdf and u8 weight exact (the
    warped dists image exactly, then the per-voxel integrate, which is the
    source's separable integrate bit for bit)."""
    jcfg, tcfg = _config(64)
    axis = np.asarray([0.3, 0.9, -0.2]) / np.linalg.norm([0.3, 0.9, -0.2])
    R = np.asarray(jse3.from_rodrigues(jnp.asarray(axis * tilt, jnp.float32),
                                       jnp.zeros(3))[0])
    pose = (R, np.asarray([0.01, 0.0, -0.01], np.float32))
    jv, tv = _jvol(jcfg), _tvol(tcfg)
    for i, dx in enumerate((0.0, 0.01, 0.02)):
        dists = _dists(_depth(dx))
        jv = jtv.integrate_rotated(jv, jnp.asarray(dists), pose,
                                   JIntr(*INTR), jcfg, fresh=i == 2)
        tv = ttv.integrate_rotated(tv, torch.as_tensor(dists), pose,
                                   TIntr(*INTR), tcfg, fresh=i == 2)
        if i == 1:
            assert int(np.count_nonzero(np.asarray(jv.weight) == 2)) > 1000
        _assert_vol_equal(jv, tv)


def _dispatch_choices(jax_eng, port):
    """(integrate, raycast) formulation names each engine's dispatch picks
    for its last pose: the formulation functions replaced by recorders."""
    names = {}

    def rec(kind, name):
        def fn(*a, **kw):
            if kw.get("separable"):  # the port's separable formulation
                name_ = "separable"
            else:
                name_ = name
            names.setdefault(kind, []).append((name_, kw.get("fov_margin")))
            return None
        return fn
    saved = []
    for mod, table in ((jtv, {"integrate_separable": "separable",
                              "integrate": "gather",
                              "integrate_rotated": "rotated"}),
                       (ttv, {"integrate": "gather",
                              "integrate_rotated": "rotated"})):
        for attr, name in table.items():
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, rec("integrate", name))
        for attr in ("raycast", "raycast_separable", "raycast_rotated",
                     "raycast_march"):
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, rec("raycast", attr))
    try:
        for eng in (jax_eng, port):
            pose = eng.poses[-1]
            eng._integrate(None, pose, fresh=True)
            eng._raycast(pose)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return names


@pytest.mark.parametrize("mode", ["auto", "exact"])
def test_dispatch_matches_jax(mode):
    """KinFu's dispatch against the source's over a grid of camera poses
    (tilts from 0 to 1.4 rad about three axes, with a translation):
    _rotation_angle and _raycast_margin equal (both in float64 on the
    host), _aligned equal, and the same integrate and raycast formulation
    (at the same virtual-image margin) in raycast_mode `mode`."""
    from dynfu_tpu.engine.kinfu import KinFu as JaxKinFu
    from dynfu_tpu.engine.params import KinFuParams as JKinFuParams
    from dynfu_tpu_torch.engine.kinfu import KinFu
    from dynfu_tpu_torch.utils import convert

    jp = JKinFuParams(rows=H, cols=W, intr=JIntr(*INTR),
                      volume_dims=(32,) * 3, raycast_mode=mode,
                      fused_frame=False)
    jax_eng, port = JaxKinFu(jp), KinFu(convert.params(jp), device="cpu")
    seen = set()
    for axis in ([1.0, 0.0, 0.0], [0.2, 1.0, 0.1], [0.3, -0.4, 0.85]):
        axis = np.asarray(axis) / np.linalg.norm(axis)
        for tilt in (0.0, 3e-7, 1e-4, 0.02, 0.1, 0.3, 0.55, 0.62, 0.9, 1.05,
                     1.15, 1.4):
            R = np.asarray(jse3.from_rodrigues(
                jnp.asarray(axis * tilt, jnp.float32), jnp.zeros(3))[0])
            pose = (R, np.asarray([0.01, -0.02, 0.03], np.float32))
            for e in (jax_eng, port):
                e.poses = [pose]
            assert port._rotation_angle(pose) == jax_eng._rotation_angle(
                pose)
            assert port._raycast_margin(pose) == jax_eng._raycast_margin(
                pose)
            assert port._aligned(pose) == jax_eng._aligned(pose)
            got = _dispatch_choices(jax_eng, port)
            assert got["integrate"][0] == got["integrate"][1]
            assert got["raycast"][0] == got["raycast"][1]
            seen.add(got["raycast"][1][0])
    want = {"raycast_separable", "raycast", "raycast_march"}
    assert seen == (want | {"raycast_rotated"} if mode == "auto" else want)
    bad = dataclasses.replace(convert.params(jp), raycast_mode="fast")
    with pytest.raises(ValueError):
        KinFu(bad, device="cpu")


MC_DIMS = [
    64,  # 63^3 cells < 2^18: the source's dense compaction branch
    80,  # 79^3 cells > 2^18: its bit-packed branch, the one 128^3 takes
]


MC_CAPS = dict(max_voxels=1 << 14, max_verts=3 * 8192)


def _mc_volume(dims):
    """The sphere at the identity in a dims^3 volume (the port's integrate,
    the source's bits): (jcfg, tcfg, JAX volume, port volume)."""
    jcfg, tcfg = _config(dims)
    radius = 0.22 * dims / 64
    dists = _dists(sphere_depth((0.0, 0.0, 0.75), radius, H, W, *INTR))
    tv = ttv.integrate(_tvol(tcfg), torch.as_tensor(dists), IDENT,
                       TIntr(*INTR), tcfg)
    jv = jtv.TsdfVolume(jnp.asarray(tv.tsdf.numpy()),
                        jnp.asarray(tv.weight.numpy()), jnp.eye(3),
                        jnp.asarray(VOL_T))
    return jcfg, tcfg, jv, tv


def _pack_inputs(seed, M, spill):
    rng = np.random.RandomState(seed)
    if spill:
        k = np.full(M, 5, np.int32)
    else:
        k = rng.randint(0, 6, M).astype(np.int32)
        k[rng.rand(M) < 0.3] = 0
    offs = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int32)
    tris = rng.rand(M, 5, 9).astype(np.float32)
    tris[np.arange(5)[None, :] >= k[:, None]] = 0.0
    max_tris = 100 if spill else int(k.sum()) + 7
    return tris, offs, k, max_tris


@pytest.mark.parametrize("spill", [False, True])
def test_pack_plain_matches_pallas_interpret(spill):
    """The pack kernel's plain version against pack_triangles_tpu in
    interpret mode (tests/test_mc.py's two cases): rows below the total
    count exact (the Pallas side is f32-exact through its bf16 split),
    rows at or past it zero."""
    tris, offs, k, max_tris = _pack_inputs(5 if not spill else 6, 512, spill)
    want = np.array(mc_pallas.pack_triangles_tpu(
        jnp.asarray(tris), jnp.asarray(offs), jnp.asarray(k), max_tris,
        chunk=256, interpret=True))
    total = min(int(k.sum()), max_tris)
    want[total:] = 0.0  # mc.py zeroes these before use
    got = mc_cuda.pack_triangles(torch.as_tensor(tris), torch.as_tensor(offs),
                                 torch.as_tensor(k), max_tris).numpy()
    np.testing.assert_array_equal(got, want)




@pytest.mark.cuda
@pytest.mark.parametrize("M,max_tris", [(1, 4), (1000, 100), (777, 5000),
                                        (8192, 10922), (65536, 87381)])
def test_pack_kernel_equals_plain(dev, M, max_tris):
    """Exact, with capacity spill and zeroed tails; the last two at the
    128^3 and 512^3 paths' launch shapes (one warp per 32 output rows)."""
    rng = np.random.default_rng(M)
    k = rng.integers(0, 6, M).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int32)
    tris = rng.random((M, 5, 9), dtype=np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (tris, offs, k)]
    got = mc_cuda.pack_triangles(*args, max_tris)
    want = mc_cuda.pack_triangles_plain(*args, max_tris)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --- compaction, the column budget, edge vertices ------------------------
# the source's compaction functions, jitted as their callers run them (one
# program each instead of op-by-op dispatch)
_j_columns = jax.jit(jcomp.extract_columns, static_argnames=(
    "per_column", "max_cols", "max_out", "row_stride", "fill", "packed_cols"))
_j_bits = jax.jit(jcomp.extract_bits, static_argnames=(
    "max_out", "row_stride", "fill", "max_words"))


@jax.jit
def _j_dilate2(vol):
    return jcomp.dilate_xy(jcomp.dilate_z(jcomp.pack_columns(vol), 2,
                                          vol.shape[-1]), 2)


def _unpack(words, Z):
    """(..., nw) uint32 -> (..., Z) bool, bit z of word w = cell 32w + z."""
    w = np.asarray(words)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (-1,))[..., :Z].astype(bool)


def _columns(seed, ncols=300, Z=70):
    """Column masks with a few dense (wall-like) columns and empty ones."""
    rng = np.random.default_rng(seed)
    occ = rng.random((ncols, Z)) < 0.08
    occ[rng.random(ncols) < 0.3] = False
    occ[rng.choice(ncols, 12, replace=False)] = True
    return occ


@pytest.mark.parametrize("K,max_cols,max_out", [
    (3, 50, 10000),  # the per-column budget and the active columns
    (8, 1000, 400),  # the output size
])
def test_extract_columns_matches_jax(K, max_cols, max_out):
    """Flat indices, order, n_total and n_captured equal under each
    overflow rule (the source's rank-select formulation, which its marching
    cubes and edge extraction use)."""
    occ = _columns(1)
    Z = occ.shape[1]
    words = jcomp.pack_columns(jnp.asarray(occ))
    got = tcomp.extract_columns(torch.as_tensor(occ), per_column=K,
                                max_cols=max_cols, max_out=max_out,
                                row_stride=Z, fill=-1)
    want = _j_columns(words, per_column=K, max_cols=max_cols,
                      max_out=max_out, row_stride=Z, fill=-1,
                      packed_cols=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert int(got[2]) < int(got[1])


@pytest.mark.parametrize("max_out,max_words", [(10000, 100), (300, 10000)])
def test_extract_bits_matches_jax(max_out, max_words):
    """Budget-free capture with the word cap and the output cap."""
    occ = _columns(2)
    Z = occ.shape[1]
    got = tcomp.extract_bits(torch.as_tensor(occ), max_out=max_out,
                             row_stride=Z, fill=-1, max_words=max_words)
    want = _j_bits(jcomp.pack_columns(jnp.asarray(occ)), max_out=max_out,
                   row_stride=Z, fill=-1, max_words=max_words)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert int(got[2]) < int(got[1])


def test_rank_select_and_dilation_match_jax():
    """rank_select with its fill; dilate_z then dilate_xy by 2 (the fusion
    band's neighbourhood), including voxels at the volume's edges."""
    rng = np.random.default_rng(3)
    m = rng.random(3000) < 0.01
    want = jax.jit(jcomp.rank_select, static_argnums=(1, 2))(
        jnp.asarray(m), 20, 3000)
    np.testing.assert_array_equal(
        tcomp.rank_select(torch.as_tensor(m), 20, 3000).numpy(),
        np.asarray(want))
    vol = rng.random((20, 18, 70)) < 0.004
    vol[0, 0, 0] = vol[-1, -1, -1] = vol[5, 17, 33] = True
    jw = _j_dilate2(jnp.asarray(vol))
    got = tcomp.dilate_xy(tcomp.dilate_z(torch.as_tensor(vol), 2), 2)
    np.testing.assert_array_equal(got.numpy(), _unpack(jw, 70))


def _wall_volume(dims):
    """A sphere and a z-parallel wall (plane x = const): every column next
    to the wall holds ~Z occupied cells, so small column budgets overflow.
    Weights zero in a corner block, so the weight rule is exercised."""
    ijk = np.stack(np.meshgrid(*(np.arange(dims),) * 3, indexing="ij"), -1)
    p = ijk.astype(np.float32) / dims
    sphere = np.linalg.norm(p - 0.5, axis=-1) - 0.3
    wall = p[..., 0] - 0.8
    f = np.clip(np.minimum(sphere, -wall) / 0.05, -1, 1)
    w = np.ones(f.shape, np.uint8)
    w[:8, :8, :8] = 0
    cfg = dict(dims=(dims,) * 3, size=(1.0, 1.0, 1.0), trunc_dist=0.03)
    return (f.astype(np.float16), w, jtv.TsdfConfig(**cfg),
            ttv.TsdfConfig(**cfg))


def _vols(f, w):
    jv = jtv.TsdfVolume(jnp.asarray(f), jnp.asarray(w), jnp.eye(3),
                        jnp.asarray(VOL_T))
    tv = ttv.TsdfVolume(torch.as_tensor(f), torch.as_tensor(w), torch.eye(3),
                        torch.as_tensor(VOL_T))
    return jv, tv


COL_BUDGET_CASES = [
    ("center", 6, 1 << 15),  # the per-column budget overflows
    ("corner", 0, 4096),  # max_voxels overflows
]


def _col_budget_caps(convention, col_budget, max_voxels):
    return dict(max_voxels=max_voxels, max_verts=3 * 16384,
                convention=convention, col_budget=col_budget)


def _sphere_volume(dims=64):
    cfg = dict(dims=(dims,) * 3, size=(1.0, 1.0, 1.0), trunc_dist=0.03)
    tcfg = ttv.TsdfConfig(**cfg)
    depth = sphere_depth((0.0, 0.0, 0.75), 0.22, H, W, *INTR)
    dists = np.array(jimg.compute_dists(jnp.asarray(depth), JIntr(*INTR)))
    tv = ttv.create(tcfg, (torch.eye(3), torch.as_tensor(VOL_T)),
                    device="cpu")
    tv = ttv.integrate(tv, torch.as_tensor(dists), IDENT, TIntr(*INTR), tcfg)
    f, w = tv.tsdf.numpy(), tv.weight.numpy()
    return f, w, jtv.TsdfConfig(**cfg), tcfg


EDGE_CASES = [
    ("corner", 8, 1 << 13),  # the fusion preset's per-column budget
    ("center", 0, 1 << 13),  # the budget-free (extract_bits) path
    ("corner", 1, 1 << 13),  # per-column budget overflow
    ("corner", 0, 400),  # output overflow
]


def test_compute_points_normals_matches_jax():
    """Points within 1e-6 m, normals within 1e-5, NaN at the same pixels
    (invalid depth, the last row and column)."""
    depth = sphere_depth((0.05, 0.0, 0.75), 0.22, H, W, *INTR)
    jp, jn = jimg.compute_points_normals(jnp.asarray(depth), JIntr(*INTR))
    tp, tn = timg.compute_points_normals(torch.as_tensor(depth),
                                         TIntr(*INTR))
    jp, jn = np.asarray(jp), np.asarray(jn)
    assert np.isfinite(jn).all(-1).sum() > 3000
    np.testing.assert_array_equal(np.isnan(tp.numpy()), np.isnan(jp))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=1e-5)


# --- the GN Gram and solve -----------------------------------------------



def test_gram_plain_matches_jax():
    """A and b within 1e-5 of max |A| (resp. max |b|) of
    gn._dense_data_normal (float32 on the CPU) and of data_normal_tpu in
    interpret mode (3-pass bfloat16, ~2^-17 relative per product)."""
    rng = np.random.RandomState(42)
    N, K, D = 1000, 8, 192
    idx = rng.randint(0, D, (N, K)).astype(np.int32)
    w = rng.rand(N, K).astype(np.float32)
    w[rng.rand(N, K) < 0.2] = 0.0
    s2 = rng.rand(N).astype(np.float32)
    delta = rng.randn(N, 3).astype(np.float32) * 0.01
    A, b = gram_cuda.data_normal(*(torch.as_tensor(a) for a in
                                   (idx, w, s2, delta)), D)
    args = [jnp.asarray(a) for a in (idx, w, s2, delta)]
    for A_ref, b_ref in (jgn._dense_data_normal(None, *args, D),
                         gram_pallas.data_normal_tpu(*args, D, tq=256,
                                                     interpret=True)):
        A_ref, b_ref = np.asarray(A_ref), np.asarray(b_ref)
        np.testing.assert_allclose(A.numpy(), A_ref, rtol=0,
                                   atol=1e-5 * np.abs(A_ref).max())
        np.testing.assert_allclose(b.numpy(), b_ref, rtol=0,
                                   atol=1e-5 * np.abs(b_ref).max())


def test_build_graphs_matches_jax():
    """Data and reg graphs index for index, masked node slots included
    (knn_brute keeps the source's distance form and tie rule)."""
    jwf = jfield.init_warpfield(ALL_NODES, weights=DG_W, capacity=20)
    twf = tfield.init_warpfield(ALL_NODES, weights=DG_W, capacity=20,
                               device="cpu")
    verts = np.asarray(SRC5 + TGT5B, np.float32)
    jd, jr = jgn.build_graphs(jwf, jnp.asarray(verts))
    td, tr = tgn.build_graphs(twf, torch.as_tensor(verts))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _gram_inputs(seed, N, K, D, repeated=True):
    """Rows with out-of-range and (if `repeated`) repeated indices, zero
    weights and zero s2 (skipped rows); repeated="coherent": runs of 64 rows
    drawing their K nodes from a window of 2K, so that a node has few
    neighbours (one 32-column pass of the Gram kernels), with a run of rows
    of random nodes (nodes with more than 32 neighbours)."""
    rng = np.random.default_rng(seed)
    if repeated == "coherent":
        base = rng.integers(0, D - 2 * K, -(-N // 64)).repeat(64)[:N]
        idx = base[:, None] + np.argsort(rng.random((N, 2 * K)),
                                         axis=1)[:, :K]
        idx[N // 2:N // 2 + 300] = rng.integers(0, D, (min(300, N), K))[
            :len(idx[N // 2:N // 2 + 300])]
        idx[rng.random((N, K)) < 0.03] = D
    elif repeated:
        idx = rng.integers(-1, D + 1, (N, K))
    else:
        idx = np.argsort(rng.random((N, D)), axis=1)[:, :K]
    w = rng.random((N, K), dtype=np.float32)
    w[rng.random((N, K)) < 0.1] = 0.0
    s2 = rng.random(N, dtype=np.float32)
    s2[::3] = 0.0
    delta = rng.normal(size=(N, 3)).astype(np.float32)
    return idx.astype(np.int32), w, s2, delta


def _sequential_gram(idx, w, s2, delta, D, warps, y=None):
    """The kernels' order in plain Python (csrc/gram_gather.cuh): a row's
    live slots holding one node merged (float64 weights summed in slot
    order); node i's rows cut into `warps` shares by its chunks of 32 rows
    (those holding it, by rank); each share summed in float64 row by row;
    the shares summed in order and rounded once. y given: the monomial
    Grams, else the data Gram."""
    mono = y is not None
    N, K = idx.shape
    C, R = (10, 6) if mono else (1, 3)
    rows = []
    for n in range(N):
        rs = np.sqrt(np.maximum(s2[n], np.float32(0))) if mono else s2[n]
        v = {}
        for r in range(K):
            ws = rs * w[n, r] if mono else w[n, r]
            if 0 <= idx[n, r] < D and (ws != 0 if mono else
                                       s2[n] != 0 and w[n, r] != 0):
                j = int(idx[n, r])
                v[j] = v[j] + float(ws) if j in v else float(ws)
        rows.append((v, float(rs)))

    def terms(n, i):  # row n's terms of node i: {j: [C values]}, [R values]
        v, rs = rows[n]
        vi = v[i]
        if mono:
            yx, yy, yz = (float(c) for c in y[n])
            dx, dy, dz = (float(c) for c in delta[n])
            mono_n = [1.0, yx, yy, yz, yx * yx, yx * yy, yx * yz, yy * yy,
                      yy * yz, yz * yz]
            u = vi * rs
            rhs = [u * d for d in (dx, dy, dz, yy * dz - yz * dy,
                                   yz * dx - yx * dz, yx * dy - yy * dx)]
            return {j: [(vi * vj) * mm for mm in mono_n]
                    for j, vj in v.items()}, rhs
        u = float(s2[n]) * vi
        return ({j: [float(s2[n]) * (vi * vj)] for j, vj in v.items()},
                [u * float(delta[n, c]) for c in range(3)])

    G = np.zeros((C, D, D), np.float32)
    rhs = np.zeros((D, R), np.float32)
    for i in range(D):
        held = [n for n in range(N) if i in rows[n][0]]
        chunks = sorted({n // 32 for n in held})
        acc = np.zeros((warps, C, D))
        racc = np.zeros((warps, R))
        for k, ch in enumerate(chunks):
            g = max(g for g in range(warps) if len(chunks) * g // warps <= k)
            for n in (n for n in held if n // 32 == ch):  # row by row
                t, r = terms(n, i)
                for j, vals in t.items():
                    for m in range(C):
                        acc[g, m, j] += vals[m]
                for c in range(R):
                    racc[g, c] += r[c]
        tot, rtot = acc[0], racc[0]
        for g in range(1, warps):
            tot, rtot = tot + acc[g], rtot + racc[g]
        G[:, i], rhs[i] = tot, rtot
    if mono:
        return G, rhs[:, :3], rhs[:, 3:]
    return G[0], rhs


def _fixed_order_cases(kind, N, K, D, seed):
    """Rows with out-of-range and repeated indices (a node in two slots of
    a row), zero weights, s2 = 0 rows, and nodes with more than 32
    neighbours (more than one pass of the kernel's 32-column tile); for the
    monomial Grams also y and negative s2."""
    idx, w, s2, delta = _gram_inputs(seed, N, K, D)
    if kind == "data":
        return (idx, w, s2, delta), None
    rng = np.random.default_rng(seed + 100)
    s2[1::7] = -s2[1::7]
    y = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    return (idx, w, s2, delta), y


@pytest.mark.parametrize("kind,warps", [("data", 1), ("data", 3),
                                        ("data", 4), ("mono", 1),
                                        ("mono", 4)])
def test_gram_fixed_order_model(kind, warps):
    """The plain model of the kernels' fixed summation order: within 1e-5
    of max |.| of the plain version (index_add_), the same bits on a
    second call, and equal to the order written out in plain Python."""
    D = 48
    args, y = _fixed_order_cases(kind, 400, 8, D, warps)
    targs = [torch.as_tensor(a) for a in args]
    ty = None if y is None else torch.as_tensor(y)
    got = gram_cuda.gram_fixed_order(*targs, D, warps, y=ty)
    if y is None:
        want = gram_cuda.data_normal_plain(*targs, D)
        seq = _sequential_gram(*args, D, warps)
    else:
        want = gram_cuda.monomial_grams_plain(targs[0], targs[1], targs[2],
                                              ty, targs[3], D)
        seq = _sequential_gram(*args, D, warps, y=y)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0,
                                   atol=1e-5 * float(x.abs().max()))
    again = gram_cuda.gram_fixed_order(*targs, D, warps, y=ty)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, x in zip(got, seq):
        np.testing.assert_array_equal(g.numpy(), x)


SOLVE_KW = dict(tukey_offset=TUKEY_OFFSET, psi_data=PSI_DATA,
                lambda_reg=LAMBDA, psi_reg=PSI_REG, linear_iter=256,
                nonlinear_iter=16, num_iter=24, early_out=True)

# name -> (nodes, [(solve source, solve target, check source, check
# target)]): the reference fixture's scenarios, each step one solve
_G2 = [[12, 12, 12], [11, 11, 11], [10, 10, 10], [10.5, 10.5, 10.5],
       [11.5, 11.5, 11.5]]
_G2T = [[11.99] * 3, [10.99] * 3, [9.99] * 3, [10.51] * 3, [11.49] * 3]
SCENARIOS = {
    "single_vertex_one_group": (GROUP1, [([[0, 0.04, 0]], [[0.01, 0.03, 0]],
                                          None, None)]),
    "two_vertices_one_static": (ALL_NODES, [
        ([[0, 0.05, 1], [2, 2, 2]], [[0.01, 0.04, 1.01], [2, 2, 2]],
         None, None)]),
    "multiple_vertices_one_group": (GROUP1, [(SRC5, TGT5, None, None)]),
    "one_group_vertices_two_groups_nodes": (ALL_NODES,
                                            [(SRC5, TGT5, None, None)]),
    "two_groups_vertices_two_groups_nodes": (ALL_NODES, [
        (SRC5 + _G2, TGT5 + _G2T, None, None)]),
    "warp_twice_sequential": (GROUP1, [(SRC5B, TGT5B, None, None),
                                       ("warped", TGT5C, SRC5B, TGT5C)]),
    "warp_and_reverse": (GROUP1, [(SRC5B, TGT5B, None, None),
                                  (TGT5B, SRC5B, SRC5B, SRC5B)]),
}


# every scenario is solved at one padded shape — 10 vertex rows (the extra
# rows masked out by vert_mask, so their Tukey weight is 0) and 18 node
# slots (the extra slots masked) — so the JAX solve compiles once. Masked
# rows and slots add exact zeros to the normal equations (the padding
# invariance tests/test_solver_parity.py asserts).
N_PAD, D_PAD = 10, 18


def _pad(v):
    v = np.asarray(v, np.float32)
    return np.concatenate([v, np.zeros((N_PAD - len(v), 3), np.float32)])


def _t_warp(wf, v):
    v = torch.as_tensor(np.asarray(v, np.float32))
    return tdq.dq_transform_point(tfield.calc_dqb(wf, v), v).numpy()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solve_matches_reference_fixture(name):
    """Each solve: the port's warp lands every check vertex on its target
    within the reference's 1e-3, and its SolveStats count the same CG
    iterations as the JAX solve on the same inputs, with the same costs."""
    nodes, steps = SCENARIOS[name]
    jwf = jfield.init_warpfield(nodes, weights=DG_W, capacity=D_PAD)
    twf = tfield.init_warpfield(nodes, weights=DG_W, capacity=D_PAD,
                                device="cpu")
    first_src = None
    for src, tgt, chk_src, chk_tgt in steps:
        if isinstance(src, str):  # re-warp the first source (sequential)
            src = _t_warp(twf, first_src)
        first_src = first_src if first_src is not None else src
        n = len(src)
        src = np.asarray(src, np.float32)
        tgt = np.asarray(tgt, np.float32)
        mask = np.arange(N_PAD) < n
        jwf, jst = jgn.solve(jwf, _pad(src), _pad(tgt),
                             vert_mask=jnp.asarray(mask), **SOLVE_KW)
        twf, tst = tgn.solve(twf, _pad(src), _pad(tgt),
                             vert_mask=torch.as_tensor(mask), **SOLVE_KW)
        assert int(tst.cg_iters) == int(jst.cg_iters)
        # costs: float32 sums whose Tukey weights (1 - (e/psi)^2)^2 amplify
        # the residuals' roundoff near the cutoff — 1e-4 relative; a
        # converged final cost is the cancellation c0 - 2 t.b + t.A t of
        # terms of size c0 — 1e-4 of the initial cost
        c0 = float(jst.initial_cost)
        np.testing.assert_allclose(float(tst.initial_cost), c0, rtol=1e-4)
        np.testing.assert_allclose(float(tst.final_cost),
                                   float(jst.final_cost), rtol=0,
                                   atol=1e-4 * c0)
        np.testing.assert_allclose(
            _t_warp(twf, chk_src if chk_src is not None else src),
            np.asarray(chk_tgt if chk_tgt is not None else tgt, np.float32),
            atol=MAX_ERROR)


def test_solve_with_graph_and_update_gates_matches_jax():
    """The fusion frame's translation solve: the neighbour pass handed in as
    graph=, then the min_update soft threshold and the max_update trust
    region. One node pulled 3 cm (beyond max_update: rejected), the rest
    ~2-6 mm (shrunk by min_update): node translations within 1e-5 m of
    JAX's (float32 roundoff of a converged CG), the same cg_iters."""
    rng = np.random.default_rng(8)
    D, N = 12, 300
    nodes = rng.uniform(-0.2, 0.2, (D, 3)).astype(np.float32)
    verts = rng.uniform(-0.2, 0.2, (N, 3)).astype(np.float32)
    live = verts + rng.normal(0, 0.002, (N, 3)).astype(np.float32) + 0.004
    near0 = np.linalg.norm(verts - nodes[0], axis=1) < 0.08
    live[near0] += np.float32(0.03)
    jwf = jfield.init_warpfield(nodes, weights=0.15, capacity=16)
    twf = tfield.init_warpfield(nodes, weights=0.15, capacity=16,
                                device="cpu")
    idx, _, n_pos, _, n_w, n_valid = jfield.neighbor_features(
        jwf, jnp.asarray(verts), 8)
    kw = dict(SOLVE_KW, psi_data=1.0, min_update=0.002, max_update=0.02)
    jout, jst = jgn.solve(jwf, jnp.asarray(verts), jnp.asarray(live),
                          graph=(idx, n_pos, n_w, n_valid, jnp.asarray(verts)),
                          **kw)
    tg = tuple(torch.as_tensor(np.array(a)) for a in (idx, n_pos, n_w,
                                                       n_valid))
    tout, tst = tgn.solve(twf, torch.as_tensor(verts), torch.as_tensor(live),
                          graph=tg + (torch.as_tensor(verts),), **kw)
    assert int(tst.cg_iters) == int(jst.cg_iters)
    jdq = np.asarray(jout.dqs)
    np.testing.assert_allclose(tout.dqs.numpy(), jdq, rtol=0, atol=1e-5)
    t = 2 * jdq[:D, 5:8]  # pure translations: dual = (0, t / 2)
    moved = np.linalg.norm(t, axis=1)
    assert (moved == 0).any() and (moved > 0).any()


# --- the integrate's bit planes, the names of the source's public surface --


@pytest.mark.parametrize("Z", [64, 45, 33, 1])
def test_pack_columns_and_pair_and_z_match_jax(Z):
    """uint32 words bitwise the source's, padding bits zero (Z not a
    multiple of 32 too), and unpack_columns their inverse."""
    bits = np.random.default_rng(Z).random((6, 5, Z)) < 0.4
    jw = jcomp.pack_columns(jnp.asarray(bits))
    tw = tcomp.pack_columns(torch.as_tensor(bits))
    assert tw.dtype == torch.uint32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tcomp.pair_and_z(tw).numpy(),
                                  np.asarray(jcomp.pair_and_z(jw)))
    np.testing.assert_array_equal(tcomp.unpack_columns(tw, Z).numpy(), bits)


def _jax_bitplanes():
    """The source's integrate_separable over two accumulating frames, the
    second emitting its planes: (tsdf, weight, (ins_w, val_w))."""
    jcfg, _ = _config(64)
    d0, d1 = _dists(_depth(0.0)), _dists(_depth(0.02))
    jv = jtv.integrate_separable(_jvol(jcfg), jnp.asarray(d0), IDENT,
                                 JIntr(*INTR), jcfg)
    jv, planes = jtv.integrate_separable(jv, jnp.asarray(d1), IDENT,
                                         JIntr(*INTR), jcfg,
                                         emit_bitplanes=True)
    return np.asarray(jv.tsdf), np.asarray(jv.weight), _np(planes)


def test_integrate_separable_bitplanes_match_jax(jax_refs):
    """integrate_separable over two accumulating frames, the second
    emitting the planes: the volume and both planes bitwise the source's
    (its planes packed in the z-chunk loop)."""
    _, tcfg = _config(64)
    d0, d1 = _dists(_depth(0.0)), _dists(_depth(0.02))
    jtsdf, jweight, jplanes = jax_refs["meshes"]["bitplanes"]
    tv = ttv.integrate_separable(_tvol(tcfg), torch.as_tensor(d0), IDENT,
                                 TIntr(*INTR), tcfg)
    tv, tplanes = ttv.integrate_separable(tv, torch.as_tensor(d1), IDENT,
                                          TIntr(*INTR), tcfg,
                                          emit_bitplanes=True)
    np.testing.assert_array_equal(tv.tsdf.numpy(), jtsdf)
    np.testing.assert_array_equal(tv.weight.numpy(), jweight)
    for t, j in zip(tplanes, jplanes):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int((tplanes[0].numpy() != 0).sum()) > 100


@pytest.mark.parametrize("kw", [
    dict(), dict(col_budget=8), dict(convention="corner", with_normals=True)])
def test_edge_vertices_from_bitplanes_equal_without(kw):
    """The planes of integrate_rotated(emit_bitplanes=True) are those of its
    volume, and the edge extraction given them returns the vertices, count,
    drops (and normals) of the one that reads the volume, bitwise."""
    _, tcfg = _config(64)
    pose = (_rot(3.0), np.asarray([0.01, 0.0, 0.0], np.float32))
    tv, planes = ttv.integrate_rotated(
        _tvol(tcfg), torch.as_tensor(_dists(_depth())), pose, TIntr(*INTR),
        tcfg, emit_bitplanes=True)
    np.testing.assert_array_equal(planes[0].numpy(),
                                  tcomp.pack_columns(tv.tsdf < 0).numpy())
    np.testing.assert_array_equal(planes[1].numpy(),
                                  tcomp.pack_columns(tv.weight != 0).numpy())
    want = tedges.isosurface_edge_vertices(tv, tcfg, max_edges=8192, **kw)
    got = tedges.isosurface_edge_vertices(tv, tcfg, max_edges=8192,
                                          bitplanes=planes, **kw)
    assert int(want[1]) > 500
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _dqb_inputs():
    rng = np.random.default_rng(41)
    D, Q = 64, 300
    pos = rng.uniform(0, 1, (D, 3)).astype(np.float32)
    dqs = _rand_dq(rng, D)
    w = np.full(D, 0.3, np.float32)
    mask = rng.random(D) > 0.2
    pts = rng.uniform(0, 1, (Q, 3)).astype(np.float32)
    nidx = rng.integers(0, D, (Q, 8)).astype(np.int32)
    return (pos, dqs, w, mask), pts, nidx


def _jax_dqb():
    """The source's calc_dqb with the neighbours given and without."""
    wf, pts, nidx = _dqb_inputs()
    jwf = jfield.WarpField(*(jnp.asarray(a) for a in wf),
                           jnp.int32(len(wf[0])))
    return (np.asarray(jfield.calc_dqb(jwf, jnp.asarray(pts),
                                       jnp.asarray(nidx))),
            np.asarray(jfield.calc_dqb(jwf, jnp.asarray(pts))))


def test_calc_dqb_neighbor_idx_matches_jax(jax_refs):
    """calc_dqb with given neighbours (unsorted, masked nodes among them)
    within 1e-5 of the source's, and without (the k-NN's)."""
    wf, pts, nidx = _dqb_inputs()
    twf = tfield.WarpField(*(torch.as_tensor(a) for a in wf),
                           torch.tensor(len(wf[0]), dtype=torch.int32))
    given, knn = jax_refs["meshes"]["dqb"]
    got = tfield.calc_dqb(twf, torch.as_tensor(pts),
                          torch.as_tensor(nidx).long())
    np.testing.assert_allclose(got.numpy(), given, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tfield.calc_dqb(twf, torch.as_tensor(pts)).numpy(), knn, rtol=0,
        atol=1e-5)


class _Stop(Exception):
    pass


def _capture_params(monkeypatch, module, seen):
    def engine(params, *a, **kw):
        seen.append(params)
        raise _Stop
    monkeypatch.setattr(module, "DynFusion", engine)


def test_run_benchmark_overrides_reach_params(monkeypatch):
    """run_benchmark's max_nodes, max_vertices and overrides build the
    source's parameters (the solver's keys into params.solver): the engine
    stubbed on both sides, the port's equal to the source's converted."""
    from dynfu_tpu.utils import benchmarks as jbench
    from dynfu_tpu_torch.utils import benchmarks as tbench
    from dynfu_tpu_torch.utils import convert

    kw = dict(max_nodes=96, max_vertices=1 << 14, overrides=dict(
        num_iter=3, early_out=False, lambda_reg=50.0, corr_rescue=17))
    seen = []
    for module, bench in ((jbench, jbench.run_benchmark),
                          (tbench, tbench.run_benchmark)):
        _capture_params(monkeypatch, module, seen)
        with pytest.raises(_Stop):
            bench(64, 4, 1, 48, 64, **kw)
    jp, tp = seen
    assert tp == convert.params(jp)
    assert (tp.max_nodes, tp.max_vertices, tp.lambda_reg, tp.corr_rescue,
            tp.solver.num_iter, tp.solver.early_out) == (
        96, 1 << 14, 50.0, 17, 3, False)


def test_run_benchmark_checks_counters_when_asked(monkeypatch):
    """A run whose last frame drops: check_counters (the default) raises,
    check_counters=False returns the drops (the engine stubbed)."""
    from dynfu_tpu_torch.engine.dynfusion import FrameStats
    from dynfu_tpu_torch.utils import benchmarks as tbench

    class Engine:
        device = torch.device("cpu")
        last_frame_stats = FrameStats(None, torch.tensor(0), torch.tensor(5))

        def __init__(self, params, *a, **kw):
            pass

        def __call__(self, depth):
            pass

        def warped_cloud(self, unique=True):
            return torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool)

    monkeypatch.setattr(tbench, "DynFusion", Engine)
    args = (64, 1, 0, 12, 16)
    with pytest.raises(RuntimeError, match="5 correspondences"):
        tbench.run_benchmark(*args, repeats=3, device="cpu")
    out = tbench.run_benchmark(*args, check_counters=False, repeats=3,
                               device="cpu")
    assert (out["corr_dropped"], out["mc_dropped_cells"]) == (5, 0)


def _jax_exports(module):
    """The names a source __init__ imports (its re-exports)."""
    import ast
    import importlib

    tree = ast.parse(Path(importlib.import_module(module).__file__)
                     .read_text())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names
            if node.module not in ("__future__",)]


@pytest.mark.parametrize("sub", ["", ".core", ".engine", ".mesh", ".rigid",
                                 ".volume", ".dist"])
def test_package_exports_match_jax(sub):
    """Every name the source's package __init__s export (the lazy engines
    and dist's lazy names included) is exported by the port's counterpart,
    the same function or class by name."""
    import importlib

    jm = importlib.import_module("dynfu_tpu" + sub)
    tm = importlib.import_module("dynfu_tpu_torch" + sub)
    names = (list(jm.__all__) if sub == ".dist" else _jax_exports(jm.__name__))
    if sub == "":
        names += ["DynFusion", "KinFu"]
    assert names
    for n in names:
        want, got = getattr(jm, n), getattr(tm, n)
        name = getattr(want, "__name__", n).replace("dynfu_tpu.",
                                                      "dynfu_tpu_torch.")
        assert getattr(got, "__name__", n) == name, n
        if isinstance(want, (int, float)):
            assert got == want, n


def test_public_arguments_match_jax():
    """DynFusion(strict_parity=) picks the mode as the source's does,
    DynFuParams.w_reg raises, integrate_warped takes col_budget,
    sharding_overhead n_devices and make_mesh n_devices;
    sharded_engine_frame takes the source's arguments but its TPU switches
    (kernel_path, interpret) and nothing else."""
    import inspect

    from dynfu_tpu.dist import engine_spmd as jengine_spmd
    from dynfu_tpu.engine.params import DynFuParams as JDynFuParams
    from dynfu_tpu_torch.dist import engine_spmd, spmd
    from dynfu_tpu_torch.engine.dynfusion import DynFusion
    from dynfu_tpu_torch.engine.params import DynFuParams

    small = DynFuParams(kinfu=DynFuParams().kinfu.with_volume_dims(32))
    for kw, mode in ((dict(), "parity"), (dict(strict_parity=False), "fixed"),
                     (dict(strict_parity=False, mode="fusion"), "fusion"),
                     (dict(mode="parity", strict_parity=False), "parity")):
        e = DynFusion(small, device="cpu", **kw)
        assert (e.mode, e.strict_parity) == (mode, mode == "parity"), kw
    for p in (JDynFuParams(), DynFuParams()):
        with pytest.raises(AttributeError, match="active node count"):
            p.w_reg
    assert "col_budget" in inspect.signature(
        tfusion.integrate_warped).parameters
    assert list(inspect.signature(engine_spmd.sharding_overhead)
                .parameters)[0] == "n_devices"
    assert spmd.make_mesh(n_devices=1, device="cpu").world == 1
    jargs = list(inspect.signature(jengine_spmd.sharded_engine_frame)
                 .parameters)
    assert list(inspect.signature(engine_spmd.sharded_engine_frame)
                .parameters) == jargs[:jargs.index("kernel_path")]


# --- the tests whose JAX side runs in the module's reference processes
# (jax_refs, below), late in the file: the processes are done by then ----


@pytest.mark.parametrize("name", SMALL)
def test_small_functions_match_jax(name, jax_refs):
    """The reference's small public functions and the port's on the same
    seeded inputs: integers (band_budget, raycast_depth's millimetres, the
    masked depth) index for index, NaNs at the same places, floats within
    1e-6 (the same float32 operations), normals within the bounds of their
    own tests: 1e-5 from the depth map (test_compute_points_normals_
    matches_jax), the slab sweep's from raycast_depth
    (test_sweep_matches_jax: _hold_sweep_normals)."""
    want, got = (_np(o) for o in _small_case(name, jax_refs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        elif name == "raycast_depth":
            _hold_sweep_normals(g, w)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            tol = NORMALS_TOL.get(name, 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    if name == "raycast_depth":
        assert (want[0] > 0).sum() > 1000


@pytest.mark.parametrize("fn,pose", SWEEP_CASES)
def test_sweep_matches_jax(fn, pose, jax_refs):
    """The plain slab sweep (the kernel's CPU version) against the source's
    raycast (any pose towards +z) and raycast_separable (an axis-aligned
    camera) at 64^3, 96x128: _hold_sweep. The source's separable bilinear
    is two matmuls, float32 on the CPU; the port sums the same two
    products per row and column in their order."""
    _, tcfg, _, tv = _swept_volume()
    want = jax_refs["views"][("sweep", fn, pose)]
    got = getattr(ttv, fn)(tv, POSES[pose], TIntr(*INTR), (H, W), tcfg)
    _hold_sweep(got, want)


@pytest.mark.parametrize("tilt,margin", ROTATED_CASES)
def test_raycast_rotated_matches_jax(tilt, margin, jax_refs):
    """raycast_rotated (the separable sweep on the virtual image, the
    validity-weighted bilinear back-map with its silhouette guard, the
    rotation into the camera frame) against the source's at two tilts under
    0.6 rad and two virtual-image margins: _hold_sweep."""
    _, tcfg, _, tv = _swept_volume()
    want = jax_refs["views"][("rotated", tilt, margin)]
    got = ttv.raycast_rotated(tv, _rotated_pose(tilt), TIntr(*INTR), (H, W),
                              tcfg, fov_margin=margin)
    _hold_sweep(got, want, min_hits=2000)


@pytest.mark.parametrize("dims", MC_DIMS)
def test_marching_cubes_matches_jax(dims, jax_refs):
    """Same vertex count, the same vertices index for index (coordinates
    to 1e-6 m), the same drop count (0)."""
    jcfg, tcfg, jv, tv = _mc_volume(dims)
    jverts, jn, jdrop = jax_refs["meshes"][("mc", dims)]
    tverts, tn, tdrop = tmc.marching_cubes(tv, tcfg, **MC_CAPS)
    n = int(jn)
    assert n > 3000 and int(tn) == n
    assert int(tdrop) == int(jdrop) == 0
    np.testing.assert_allclose(tverts.numpy()[:n], np.asarray(jverts)[:n],
                               rtol=0, atol=1e-6)
    assert not tverts[n:].any()


@pytest.mark.parametrize("convention,col_budget,max_voxels",
                         COL_BUDGET_CASES)
def test_marching_cubes_column_budget_matches_jax(convention, col_budget,
                                                  max_voxels, jax_refs):
    """66^3 (65^3 > 2^18 cells: the source's column-budget branch) with
    the wall overflowing the per-column budget, or max_voxels: the same
    vertices index for index, vertex count and n_dropped > 0."""
    f, w, jcfg, tcfg = _wall_volume(66)
    jv, tv = _vols(f, w)
    caps = _col_budget_caps(convention, col_budget, max_voxels)
    meshes = jax_refs["meshes"]
    jverts, jn, jdrop = meshes[("col_budget", convention, col_budget,
                                max_voxels)]
    tverts, tn, tdrop = tmc.marching_cubes(tv, tcfg, **caps)
    n = int(jn)
    assert n > 3000 and int(tn) == n
    assert int(tdrop) == int(jdrop) > 0
    np.testing.assert_allclose(tverts.numpy(), np.asarray(jverts), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("convention,col_budget,max_edges", EDGE_CASES)
def test_edge_vertices_with_normals_match_jax(convention, col_budget,
                                              max_edges, jax_refs):
    """The same edges in the same order and the same counters; vertices
    within 1e-6 m (float32 ulp at 1 m); normals within 1e-5 (the port
    normalises with its own sqrt, ~1 ulp apart) and NaN at the same rows."""
    f, w, jcfg, tcfg = _sphere_volume()
    jv, tv = _vols(f, w)
    kw = dict(max_edges=max_edges, convention=convention,
              col_budget=col_budget, with_normals=True)
    meshes = jax_refs["meshes"]
    jverts, jn, jdrop, jnorm = meshes[("edges", convention, col_budget,
                                       max_edges)]
    tverts, tn, tdrop, tnorm = tedges.isosurface_edge_vertices(tv, tcfg, **kw)
    n = int(jn)
    assert n >= 400 and int(tn) == n and int(tdrop) == int(jdrop)
    if max_edges == 400 or col_budget == 1:
        assert int(jdrop) > 0
    np.testing.assert_allclose(tverts.numpy(), np.asarray(jverts), rtol=0,
                               atol=1e-6)
    jnorm = np.asarray(jnorm)
    np.testing.assert_array_equal(np.isnan(tnorm.numpy()), np.isnan(jnorm))
    np.testing.assert_allclose(tnorm.numpy(), jnorm, rtol=0, atol=1e-5)


def _jax_views():
    """The JAX side of the raycasts' tests (raycast_depth, the slab sweeps,
    raycast_rotated), as numpy, in the order the tests ask for them."""
    jcfg, _, jv, _ = _swept_volume()
    out = {"raycast_depth": _np(jtv.raycast_depth(
        jv, IDENT, JIntr(*INTR), (H, W), jcfg))}
    for fn, pose in SWEEP_CASES:
        out[("sweep", fn, pose)] = _np(getattr(jtv, fn)(
            jv, POSES[pose], JIntr(*INTR), (H, W), jcfg))
    for tilt, margin in ROTATED_CASES:
        out[("rotated", tilt, margin)] = _np(jtv.raycast_rotated(
            jv, _rotated_pose(tilt), JIntr(*INTR), (H, W), jcfg,
            fov_margin=margin))
    return out


def _jax_meshes():
    """The JAX side of the extraction tests (marching cubes, its column
    budgets, the edge vertices), the bit planes' and calc_dqb's, as numpy."""
    out = {}
    for dims in MC_DIMS:
        jcfg, _, jv, _ = _mc_volume(dims)
        out[("mc", dims)] = _np(jmc.marching_cubes(jv, jcfg, **MC_CAPS))
    f, w, jcfg, _ = _wall_volume(66)
    jv, _ = _vols(f, w)
    for case in COL_BUDGET_CASES:
        out[("col_budget",) + case] = _np(jmc.marching_cubes(
            jv, jcfg, **_col_budget_caps(*case)))
    f, w, jcfg, _ = _sphere_volume()
    jv, _ = _vols(f, w)
    for convention, col_budget, max_edges in EDGE_CASES:
        out[("edges", convention, col_budget, max_edges)] = _np(
            jedges.isosurface_edge_vertices(
                jv, jcfg, max_edges=max_edges, convention=convention,
                col_budget=col_budget, with_normals=True))
    out["bitplanes"] = _jax_bitplanes()
    out["dqb"] = _jax_dqb()
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_refs(request):
    """The JAX side of the module's slowest tests, in two processes of
    their own (test_torch_fusion.module_refs), started with its first test:
    their compiles overlap each other and the module's other tests."""
    refs = module_refs(request, {"views": _jax_views,
                                 "meshes": _jax_meshes})
    yield refs
    refs.close()


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thin", [False, True])
@pytest.mark.parametrize("mode", ["general", "separable"])
def test_sweep_kernel_equals_plain(dev, mode, thin):
    """The slab sweep kernel against its plain version on the card at odd
    shapes (61x83 rays; a 48x40x56 volume at m = 2, so that the slabs are
    padded) under a tilted pose (general) or a translated one
    (separable), with `thin` 60 seeded single voxels of -0.25 on sampled
    planes (features the brick summary must stop the skip for): the same
    hit masks and NaN positions, points within 1e-6 m, normals within
    1e-5; the records of three x-blocks (each with its 1-plane halo)
    exactly the plain version's, and their resolve the whole sweep's, bit
    for bit."""
    shape = (61, 83)
    cfg = ttv.TsdfConfig(dims=(48, 40, 56), size=(1.2, 1.0, 1.4),
                         trunc_dist=0.06)
    intr = TIntr(70.0, 70.0, 41.5, 30.0)
    d = sphere_depth((0.05, -0.03, 0.8), 0.25, *shape, 70.0, 70.0, 41.5,
                     30.0)
    vol = ttv.create(cfg, (torch.eye(3), torch.as_tensor([-0.6, -0.5, 0.2])),
                     device="cpu")
    vol = ttv.integrate(vol, timg.compute_dists(torch.as_tensor(
        d.astype(np.int32)), intr), IDENT, intr, cfg)
    if thin:
        idx = np.random.default_rng(0).integers(0, (48, 40, 28), (60, 3))
        vol.tsdf[idx[:, 0], idx[:, 1], idx[:, 2] * 2] = -0.25
    vol = ttv.TsdfVolume(*(t.to(dev) for t in vol))
    if mode == "general":
        R, t, rays = ttv.camera_rays(vol, (_rot(9.0), np.asarray(
            [0.01, -0.02, 0.03], np.float32)), shape, intr)
        geo, rays = torch.cat([t, R.reshape(-1)]), rays.contiguous()
    else:
        geo, rays = ttv.separable_rays(vol, POSES["translated"], intr,
                                        shape)
    spec = ttv.sweep_spec(mode, shape, cfg)
    assert spec.m == 2 and spec.s_pad > (56 - 1) // 2 + 1
    stack = sweep_cuda.slab_stack(vol.tsdf, spec.m)
    marked = ttv.marked_bricks(stack.summary, stack.slabs.shape[2])
    assert 0 < int(marked.sum()) < marked.numel()
    got = sweep_cuda.slab_sweep(stack, geo, rays, spec)
    want = sweep_cuda.slab_sweep_plain(stack, geo, rays, spec)
    hit = ~torch.isnan(want[0][..., 0])
    assert hit.sum() > 1000
    for g, w, tol in zip(got, want, (1e-6, 1e-5)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert float((g[hit] - w[hit]).abs().max()) <= tol
    records = []
    for lo, hi in ((0, 16), (16, 31), (31, 48)):
        h0, h1 = int(lo > 0), int(hi < 48)
        args = (sweep_cuda.slab_stack(vol.tsdf[lo - h0:hi + h1], spec.m),
                geo, rays, spec, (lo - h0, lo, hi))
        records.append(sweep_cuda.slab_sweep(*args))
        assert torch.equal(records[-1], sweep_cuda.slab_sweep_plain(*args))
    p, n, straddle = sweep_cuda.sweep_resolve(torch.stack(records), geo,
                                              rays, spec)
    for a, b in ((p, got[0]), (n, got[1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(straddle.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dims,m", [((48, 40, 56), 2), ((70, 33, 129), 5),
                                    ((130, 72, 64), 1)])
def test_slab_stack_kernel_equals_plain(dev, dims, m):
    """The stack kernel against its plain version on the card: the slabs
    bitwise, the summary equal, on seeded volumes of +1, 0 and -0.0 with
    scattered negative voxels and a NaN, at odd shapes (partial x tiles,
    brick rows and slab passes) and on an x-block from plane 17."""
    rng = np.random.default_rng(11)
    t = np.where(rng.random(dims) < 0.7, 1.0, 0.0)
    t[rng.random(dims) < 0.02] = -0.0
    neg = rng.integers(0, dims, (50, 3))
    t[neg[:, 0], neg[:, 1], neg[:, 2] // m * m] = -0.5
    t[3, 4, 0] = np.nan
    tsdf = torch.as_tensor(t.astype(np.float16), device=dev)
    for part in (tsdf, tsdf[17:]):
        got = sweep_cuda.slab_stack(part, m)
        want = sweep_cuda.slab_stack_plain(part, m)
        assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
        assert torch.equal(got[1], want[1])
        marked = ttv.marked_bricks(want[1], part.shape[0])
        assert 0 < int(marked.sum()) < marked.numel()


@pytest.mark.cuda
def test_gram_kernel_equals_plain(dev):
    """Within 1e-5 of max |A| and max |b| (both sum in float64, in other
    orders), with out-of-range indices skipped and repeated indices in a
    row."""
    rng = np.random.default_rng(7)
    N, K, D = 5001, 8, 100
    idx = rng.integers(-1, D + 1, (N, K)).astype(np.int32)
    w = rng.random((N, K), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[::3] = 0.0
    delta = rng.normal(size=(N, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (idx, w, s2, delta)]
    A, b = gram_cuda.data_normal(*args, D)
    A0, b0 = gram_cuda.data_normal_plain(*args, D)
    torch.cuda.synchronize()
    torch.testing.assert_close(A, A0, rtol=0, atol=1e-5 * float(A0.abs().max()))
    torch.testing.assert_close(b, b0, rtol=0, atol=1e-5 * float(b0.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D,repeated", [(5001, 8, 100, True),
                                            (0, 8, 17, False),
                                            (3000, 3, 64, True),
                                            (49152, 8, 1024, False),
                                            (4000, 8, 3000, False),
                                            (6000, 8, 400, True),
                                            (32768, 8, 256, "coherent"),
                                            (49152, 8, 1024, "coherent")])
def test_gram_kernel_fixed_order(dev, N, K, D, repeated):
    """The same bits over three launches, and the bits of the plain
    fixed-order model (on the CPU) at the kernel's warps per block; empty
    rows of A (nodes without an entry) are zeros. Random rows give nodes
    more neighbours than one 32-column pass (several passes over the same
    rows); coherent rows mostly fewer."""
    args = [torch.as_tensor(a, device=dev)
            for a in _gram_inputs(D + K, N, K, D, repeated)]
    outs = [gram_cuda.data_normal(*args, D) for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
    warps = gram_cuda.gram_warps(N, D, False)
    assert 1 <= warps <= 16
    A, b = gram_cuda.gram_fixed_order(*(a.cpu() for a in args), D, warps)
    assert torch.equal(outs[0][0].cpu(), A) and torch.equal(outs[0][1].cpu(), b)
