"""PyTorch port vs JAX reference: dense compaction (ops/compaction.py),
marching cubes' column-budget branch, the unique edge-vertex extraction
(mesh/edges.py) and the depth point/normal maps. Seeded numpy inputs, CPU.

The JAX side packs z-columns into 32-bit words; its masks are unpacked to
bool here so both sides see the same cells. Capacities are set small so
that every overflow rule (per-column budget, active columns, active words,
output size) fires."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.mesh import edges as jedges
from dynfu_tpu.mesh import mc as jmc
from dynfu_tpu.ops import compaction as jcomp
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.io.datasets import sphere_depth
from dynfu_tpu_torch.mesh import edges as tedges
from dynfu_tpu_torch.mesh import mc as tmc
from dynfu_tpu_torch.ops import compaction as tcomp
from dynfu_tpu_torch.ops import imgproc as timg
from dynfu_tpu_torch.volume import tsdf as ttv

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

H, W = 96, 128
INTR = (140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
VOL_T = np.asarray([-0.5, -0.5, 0.25], np.float32)
IDENT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


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
