"""PyTorch port vs JAX reference: TSDF integration, marching cubes and the
triangle-pack kernel's plain version, on seeded inputs on the CPU. The
test marked `cuda` holds the pack kernel against its plain version (it
skips without a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.mesh import mc as jmc
from dynfu_tpu.mesh import mc_pallas
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.mesh import mc as tmc
from dynfu_tpu_torch.mesh import mc_cuda
from dynfu_tpu_torch.volume import tsdf as ttv

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

H, W = 96, 128
INTR = (140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
VOL_T = np.asarray([-0.5, -0.5, 0.25], np.float32)
IDENT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


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


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,max_tris", [(1, 4), (1000, 100), (777, 5000)])
def test_pack_kernel_equals_plain(dev, M, max_tris):
    """Exact, with capacity spill and zeroed tails."""
    rng = np.random.default_rng(M)
    k = rng.integers(0, 6, M).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int32)
    tris = rng.random((M, 5, 9), dtype=np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (tris, offs, k)]
    got = mc_cuda.pack_triangles(*args, max_tris)
    want = mc_cuda.pack_triangles_plain(*args, max_tris)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
