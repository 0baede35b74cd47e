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

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.mesh import edges as jedges
from dynfu_tpu.mesh import mc as jmc
from dynfu_tpu.mesh import mc_pallas
from dynfu_tpu.ops import compaction as jcomp
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.solver import gn as jgn
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core import dualquat as tdq
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.mesh import edges as tedges
from dynfu_tpu_torch.mesh import mc as tmc
from dynfu_tpu_torch.mesh import mc_cuda
from dynfu_tpu_torch.ops import compaction as tcomp
from dynfu_tpu_torch.ops import imgproc as timg
from dynfu_tpu_torch.solver import gn as tgn
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.volume import tsdf as ttv
from dynfu_tpu_torch.warp import field as tfield

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


@pytest.mark.parametrize("dims", [
    64,  # 63^3 cells < 2^18: the source's dense compaction branch
    80,  # 79^3 cells > 2^18: its bit-packed branch, the one 128^3 takes
])
def test_marching_cubes_matches_jax(dims):
    """Same vertex count, the same vertices index for index (coordinates
    to 1e-6 m), the same drop count (0)."""
    jcfg, tcfg = _config(dims)
    radius = 0.22 * dims / 64
    dists = _dists(sphere_depth((0.0, 0.0, 0.75), radius, H, W, *INTR))
    tv = ttv.integrate(_tvol(tcfg), torch.as_tensor(dists), IDENT,
                       TIntr(*INTR), tcfg)
    jv = jtv.TsdfVolume(jnp.asarray(tv.tsdf.numpy()),
                        jnp.asarray(tv.weight.numpy()), jnp.eye(3),
                        jnp.asarray(VOL_T))
    caps = dict(max_voxels=1 << 14, max_verts=3 * 8192)
    jverts, jn, jdrop = jmc.marching_cubes(jv, jcfg, **caps)
    tverts, tn, tdrop = tmc.marching_cubes(tv, tcfg, **caps)
    n = int(jn)
    assert n > 3000 and int(tn) == n
    assert int(tdrop) == int(jdrop) == 0
    np.testing.assert_allclose(tverts.numpy()[:n], np.asarray(jverts)[:n],
                               rtol=0, atol=1e-6)
    assert not tverts[n:].any()


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


@pytest.mark.parametrize("convention,col_budget,max_voxels", [
    ("center", 6, 1 << 15),  # the per-column budget overflows
    ("corner", 0, 4096),  # max_voxels overflows
])
def test_marching_cubes_column_budget_matches_jax(convention, col_budget,
                                                  max_voxels):
    """66^3 (65^3 > 2^18 cells: the source's column-budget branch) with
    the wall overflowing the per-column budget, or max_voxels: the same
    vertices index for index, vertex count and n_dropped > 0."""
    f, w, jcfg, tcfg = _wall_volume(66)
    jv, tv = _vols(f, w)
    caps = dict(max_voxels=max_voxels, max_verts=3 * 16384,
                convention=convention, col_budget=col_budget)
    jverts, jn, jdrop = jmc.marching_cubes(jv, jcfg, **caps)
    tverts, tn, tdrop = tmc.marching_cubes(tv, tcfg, **caps)
    n = int(jn)
    assert n > 3000 and int(tn) == n
    assert int(tdrop) == int(jdrop) > 0
    np.testing.assert_allclose(tverts.numpy(), np.asarray(jverts), rtol=0,
                               atol=1e-6)


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


@pytest.mark.parametrize("convention,col_budget,max_edges", [
    ("corner", 8, 1 << 13),  # the fusion preset's per-column budget
    ("center", 0, 1 << 13),  # the budget-free (extract_bits) path
    ("corner", 1, 1 << 13),  # per-column budget overflow
    ("corner", 0, 400),  # output overflow
])
def test_edge_vertices_with_normals_match_jax(convention, col_budget,
                                              max_edges):
    """The same edges in the same order and the same counters; vertices
    within 1e-6 m (float32 ulp at 1 m); normals within 1e-5 (the port
    normalises with its own sqrt, ~1 ulp apart) and NaN at the same rows."""
    f, w, jcfg, tcfg = _sphere_volume()
    jv, tv = _vols(f, w)
    kw = dict(max_edges=max_edges, convention=convention,
              col_budget=col_budget, with_normals=True)
    jverts, jn, jdrop, jnorm = jedges.isosurface_edge_vertices(jv, jcfg, **kw)
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


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


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
