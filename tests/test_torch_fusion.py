"""PyTorch port vs JAX reference on the CPU, seeded numpy inputs; Pallas
kernels run in interpret mode, as the JAX package's own tests run them.

k-NN with feature fetch, the windowed 1-NN correspondence and its tiers,
the fused DQB warp, the unsupported mask and node insertion. The candidate
rule of the fused warp and the k-NN (a plain model of their pruned
selection) is held against the brute-force selection, and the 1-NN's
sub-tile pruning (a plain model of the kernel's sweep) against the plain
sweep.

The SE(3) fusion slice: the DLB blend and warp, the monomial Grams, the
SE(3) solve, warped integration, and fusion-mode frames of the engine on
the tests/test_pipeline.py fixture (96x128 depth, 64^3 volume, a sphere of
r = 0.22 m moving 4 mm per frame), with and without camera tracking.

The tests marked `cuda` hold the k-NN, warp and 1-NN CUDA kernels against
their plain versions at edge-case shapes (odd sizes, fewer valid nodes
than k, all-inf and NaN rows, ragged sub-tiles, an empty window, equal
distances, scattered queries, spatially sorted queries that the kernels
prune for, D = 8192), the DLB warp and monomial-Gram kernels likewise (for
the Grams: rows that share one node set, nodes with more neighbours than
one 32-column pass, padding, s2 = 0 rows, K < 8, D = 1024, each launch
shape's warps per block), and the Grams against themselves and their
fixed-order model bit for bit; they skip without a card."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.engine.dynfusion import DynFusion as JaxDynFusion
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.ops import knn as jknn
from dynfu_tpu.ops import knn_pallas, warp_pallas
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.solver import se3 as jse3
from dynfu_tpu.volume import fusion as jfusion
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.ops import corr_cuda, knn_cuda, segsum, warp_cuda
from dynfu_tpu_torch.ops import knn as tknn
from dynfu_tpu_torch.solver import gn as tgn
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.solver import se3 as tse3
from dynfu_tpu_torch.utils import convert
from dynfu_tpu_torch.volume import fusion as tfusion
from dynfu_tpu_torch.warp import field as tfield

from test_pipeline import (CENTER, RADIUS, SCENE, scene_depth,
                           small_dynfu_params, sphere_depth)

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)


# --- k-NN, 1-NN, the DQB warp, node insertion ------------------------------
BIG = 3e38


def _t(a):
    return torch.as_tensor(np.array(a))


def _nodes(rng, D, n_masked, rot=0.2, trans=0.02, dg_w=0.3):
    pos = rng.uniform(0, 1, (D, 3)).astype(np.float32)
    axis = rng.normal(0, rot / 2, (D, 3)).astype(np.float32)
    t = rng.normal(0, trans, (D, 3)).astype(np.float32)
    dqs = np.array(jdq.dq_from_rodrigues(jnp.asarray(axis), jnp.asarray(t)))
    w = np.full(D, dg_w, np.float32)
    mask = np.ones(D, bool)
    mask[rng.choice(D, n_masked, replace=False)] = False
    return pos, dqs, w, mask


def test_knn_gather_plain_matches_jax(k=8):
    """idx equal; sqd and fetched features within 1e-6 (the XLA path's
    |q|^2 - 2q.p + |p|^2 form rounds differently from the direct
    difference; the fetch itself is exact)."""
    rng = np.random.default_rng(10)
    pos, dqs, w, mask = _nodes(rng, 64, 10)
    table = rng.normal(size=(64, 13)).astype(np.float32)
    q = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    got = knn_cuda.knn_gather(_t(q), _t(pos), k, _t(table), _t(mask))
    for want in (
            jknn.knn_gather(jnp.asarray(q), jnp.asarray(pos), k,
                            jnp.asarray(table), jnp.asarray(mask)),
            knn_pallas.knn_gather_tpu(jnp.asarray(q), jnp.asarray(pos), k,
                                      jnp.asarray(table), jnp.asarray(mask),
                                      tq=256, interpret=True)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)


def _grid(rng, shape, lo, hi, step=2.0 ** -10):
    """Values on a 2^-10 grid: at most 16 significant bits, which the
    Pallas kernel's hi/lo bfloat16 fetch (~16-bit relative) returns
    exactly — so its outputs can be compared for equality."""
    return (np.round(rng.uniform(lo, hi, shape) / step) * step).astype(
        np.float32)


def test_window_sweep_plain_matches_pallas_interpret(F=22):
    """The 1-NN sweep's plain version, behind the port's window placement,
    against knn._window_pass_pallas(interpret=True) with the engine's
    22-column payload: fetched rows and certificates equal."""
    rng = np.random.default_rng(11)
    P, Q, W = 3000, 4096, 1024
    pts = _grid(rng, (P, 3), -1, 1)
    pts[rng.random(P) < 0.05] = BIG  # masked points
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    qs = _grid(rng, (Q, 3), -1, 1)
    qs = qs[np.argsort(qs[:, 0] + rng.normal(0, 0.01, Q), kind="stable")]
    qs[rng.random(Q) < 0.05] = BIG  # masked queries
    vals = _grid(rng, (P, F), 0, 4, 2.0 ** -8)
    jv, je = jknn._window_pass_pallas(
        jnp.asarray(qs), jnp.asarray(pts), Q, P, W, tq=2048, interpret=True,
        vals=jnp.asarray(vals))
    tv, te = tknn._window_pass(_t(qs), _t(pts), W, _t(vals), tq=2048)
    assert 0 < int(te.sum()) < Q
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_nn1_gather_xwindow_tiers_match_jax():
    """With escalate and rescue the tiers certify every query on both
    sides (the base windows differ: the JAX CPU path places 4096-point
    blocks per 4096 queries, the port the kernel path's 4096-point window
    per 2048-query tile, at 128-point granularity), and then the fetched
    rows are the true 1-NN's: equal."""
    rng = np.random.default_rng(12)
    P = 12288
    u = rng.normal(size=(P, 3))
    pts = (0.3 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(
        np.float32)
    pmask = rng.random(P) > 0.05
    qs = pts + rng.normal(0, 0.003, pts.shape).astype(np.float32)
    qs[:100] += np.float32(0.08)  # moving-edge queries: NN far outside
    qs = qs[np.argsort(qs[:, 0], kind="stable")]
    qmask = rng.random(P) > 0.02
    vals = rng.normal(size=(P, 5)).astype(np.float32)
    kw = dict(block=4096, window_blocks=1, escalate=1024, rescue=4096)
    jv, je = jknn.nn1_gather_xwindow(
        jnp.asarray(qs), jnp.asarray(pts), jnp.asarray(vals),
        jnp.asarray(pmask), jnp.asarray(qmask), **kw)
    tv, te = tknn.nn1_gather_xwindow(_t(qs), _t(pts), _t(vals), _t(pmask),
                                     _t(qmask), **kw)
    # the base pass alone leaves failures, so the tiers are exercised
    _, base = tknn.nn1_gather_xwindow(_t(qs), _t(pts), _t(vals), _t(pmask),
                                      _t(qmask), block=4096, window_blocks=1)
    assert int((~base & _t(qmask)).sum()) > 0
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), qmask)
    np.testing.assert_array_equal(tv.numpy()[qmask], np.asarray(jv)[qmask])




def test_warp_plain_matches_jax():
    """Warped points and "normals" within 1e-5 m of warp_points_normals
    (XLA) and of warp_fused_tpu(interpret=True, blend="dqb"), whose blended
    DQ and unsupported ratio agree too (f32 roundoff of the two formulas
    of the DQ transform, through an 8-term product)."""
    rng = np.random.default_rng(13)
    pos, dqs, w, mask = _nodes(rng, 64, 8)
    q = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    n = rng.normal(size=(700, 3)).astype(np.float32)
    got = warp_cuda.warp_fused(_t(q), _t(n), _t(pos), _t(dqs), _t(w),
                               _t(mask))
    jwp, jwn = jfield.warp_points_normals(_jwf(pos, dqs, w, mask),
                                          jnp.asarray(q), jnp.asarray(n))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jwp), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jwn), atol=1e-5)
    want = warp_pallas.warp_fused_tpu(
        jnp.asarray(q), jnp.asarray(n), jnp.asarray(pos), jnp.asarray(dqs),
        jnp.asarray(w), jnp.asarray(mask), blend="dqb", tq=256,
        interpret=True)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)


def _sphere_canonical(rng, n=3000):
    u = rng.normal(size=(n, 3))
    v = (0.5 + 0.3 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(
        np.float32)
    m = rng.random(n) > 0.1
    return v, m


def test_unsupported_mask_and_update_warpfield_match_jax():
    """Sparse nodes on a sphere leave unsupported regions: the unsupported
    mask is equal, and node insertion gives the same node count, the same
    new node positions (1e-6 m) and their DQB seeds (1e-5)."""
    rng = np.random.default_rng(14)
    verts, vmask = _sphere_canonical(rng)
    D, n0 = 256, 12
    pos = np.zeros((D, 3), np.float32)
    pos[:n0] = verts[::250][:n0]
    _, dqs, _, _ = _nodes(rng, D, 0, rot=0.1, trans=0.01)
    w = np.full(D, 0.1, np.float32)
    mask = np.arange(D) < n0
    mult = rng.integers(1, 7, verts.shape[0]).astype(np.float32)
    jwf, twf = _jwf(pos, dqs, w, mask), _twf(pos, dqs, w, mask)

    ju = np.asarray(jfield.unsupported_mask(jwf, jnp.asarray(verts),
                                            jnp.asarray(vmask)))
    tu = tfield.unsupported_mask(twf, _t(verts), _t(vmask)).numpy()
    assert 100 < ju.sum() < vmask.sum()
    np.testing.assert_array_equal(tu, ju)

    jnew = jfield.update_warpfield(jwf, jnp.asarray(verts), jnp.asarray(vmask),
                                   0.05, 0.05, 64,
                                   vert_weights=jnp.asarray(mult))
    tnew = tfield.update_warpfield(twf, _t(verts), _t(vmask), 0.05, 0.05, 64,
                                   vert_weights=_t(mult))
    n = int(jnew.count)
    assert n > n0 and int(tnew.count) == n
    np.testing.assert_array_equal(tnew.mask.numpy(), np.asarray(jnew.mask))
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnew.dqs.numpy(), np.asarray(jnew.dqs),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tnew.w.numpy(), np.asarray(jnew.w))


# --- the fused warp's candidate rule ---------------------------------------


@functools.lru_cache(maxsize=1)
def _band(res=96):
    """A sphere's front band voxels in z-fastest order, as the fused band
    comes out of the compaction: spatially coherent."""
    g = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) / res
    r = np.linalg.norm(g - 0.5, axis=1)
    return g[(np.abs(r - 0.35) < 1.5 / res) & (g[:, 2] < 0.5)].astype(
        np.float32)


def _band_queries(n):
    g = _band()
    return g[len(g) // 3:len(g) // 3 + n].copy()


PRUNE_CASES = ["sorted", "random", "duplicates", "few_valid", "nonfinite",
               "padded"]


def _prune_inputs(case, D, k, Q=1024):
    """(queries, node_pos, node_mask): nodes on the sphere the queries lie
    on, a tenth masked, and the case's twist."""
    rng = np.random.default_rng(D + k)
    u = rng.normal(size=(D, 3))
    pos = (0.5 + 0.35 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(
        np.float32)
    mask = rng.random(D) > 0.1
    q = _band_queries(Q)
    if case == "random":
        q = q[rng.permutation(Q)]
    elif case == "duplicates":  # on lattices: equal positions, exact ties
        pos = (np.round(pos * 8) / 8).astype(np.float32)
        q = (np.round(q * 16) / 16).astype(np.float32)
    elif case == "few_valid":  # k - 1 valid nodes: masked slots are picked
        mask[:] = False
        mask[rng.choice(D, k - 1, replace=False)] = True
    elif case == "nonfinite":
        q[::7] = np.nan
        q[3::11, 1] = np.inf
        q[5::13, 2] = -np.inf
        q[96:160] = np.nan  # whole warps without a finite query
    elif case == "padded":  # the fused band pads with voxel (0, 0, 0)
        q[-300:] = 0.0
    return q, pos, mask


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("D", [37, 1024])
@pytest.mark.parametrize("case", PRUNE_CASES)
def test_pruned_selection_equals_brute_force(case, D, k):
    """The plain model of the warp kernel's candidate rule (blocks of 32
    and 256 queries) selects exactly what select_k's brute force does,
    index for index and distance for distance, +inf rows included; on
    sorted queries it prunes most slots."""
    q, pos, mask = (_t(a) for a in _prune_inputs(case, D, k))
    want = knn_cuda.select_k(q, pos, mask, k)
    for threads in (32, 256):
        got = warp_cuda.pruned_select(q, pos, mask, k, threads)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    if case == "sorted" and D == 1024:
        cand, has_box = warp_cuda.group_candidates(q, pos, mask, k, 256)
        assert float(cand.sum(1)[has_box].double().mean()) < D / 4


@pytest.mark.parametrize("case", ["sorted", "few_valid", "nonfinite"])
def test_knn_pruned_selection_equals_select_k(case):
    """The k-NN kernel's block sizes below 256 (it halves them at small Q):
    the pruned selection equals select_k, fewer valid nodes than k and
    non-finite queries included."""
    q, pos, mask = (_t(a) for a in _prune_inputs(case, 1024, 8, Q=512))
    want = knn_cuda.select_k(q, pos, mask, 8)
    for threads in (64, 128):
        got = warp_cuda.pruned_select(q, pos, mask, 8, threads)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


NN1_CASES = ["sorted", "ties", "big", "empty_window", "scattered", "ragged"]


def _nn1_inputs(case, dev="cpu", F=5):
    """The 1-NN sweep's arguments through the port's window placement:
    queries near points on a sphere, both x-sorted, and the case's twist —
    lattice points and queries (equal distances at different indices),
    BIG-masked points and queries, a first window of BIG points only,
    shuffled queries in a wide window (the escalate pass), a window that
    is not a multiple of the sub-tile."""
    rng = np.random.default_rng(len(case))
    P, Q = 3000, 4096
    u = rng.normal(size=(P, 3))
    pts = 0.5 * u / np.linalg.norm(u, axis=1, keepdims=True)
    qs = pts[rng.integers(0, P, Q)] + rng.normal(0, 0.01, (Q, 3))
    W = {"scattered": 2048, "ragged": 1000}.get(case, 1024)
    if case == "ties":
        pts = np.round(pts * 8) / 8
        qs = np.round(qs * 16) / 16
    pts = pts.astype(np.float32)
    qs = qs.astype(np.float32)
    if case in ("big", "empty_window"):
        pts[rng.random(P) < 0.2] = BIG
        qs[rng.random(Q) < 0.1] = BIG
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    qs = qs[np.argsort(qs[:, 0], kind="stable")]
    if case == "empty_window":
        pts[:W] = BIG
    if case == "scattered":
        qs = qs[rng.permutation(Q)]
    qsP, psP, lo_el, pre, suf, W = tknn.window_placement(
        torch.as_tensor(qs, device=dev), torch.as_tensor(pts, device=dev), W)
    if case == "empty_window":
        lo_el[0] = 0
    pay = torch.as_tensor(rng.normal(size=(psP.shape[0], F)),
                          dtype=torch.float32, device=dev)
    return qsP, psP, lo_el, pre, suf, 2048, W, pay


@pytest.mark.parametrize("case", NN1_CASES)
def test_nn1_pruned_sweep_equals_plain(case):
    """The plain model of the 1-NN kernel's sub-tile pruning, with one warp
    per query group and with the visits shared by 2 and 4 warps, fetches
    the same rows and certificates as the plain sweep; on sorted queries a
    group scans few of the window's sub-tiles."""
    args = _nn1_inputs(case)
    want = corr_cuda.nn1_window_sweep_plain(*args)
    for split in (1, 2, 4):
        vals, exact, scanned, has = corr_cuda.pruned_sweep(*args,
                                                           split=split)
        assert torch.equal(exact, want[1])
        assert torch.equal(vals, want[0])
        if case == "sorted":
            assert float(scanned[has].sum(1).double().mean()) < 4 + split
    assert 0 < int(want[1].sum()) < want[1].numel()




def _masked_nodes(rng, D, n_valid, dev):
    pos = torch.as_tensor(rng.uniform(0, 1, (D, 3)), dtype=torch.float32,
                          device=dev)
    mask = torch.zeros(D, dtype=torch.bool, device=dev)
    mask[torch.as_tensor(rng.choice(D, n_valid, replace=False),
                         device=dev)] = True
    return pos, mask


def _edge_queries(rng, Q, dev):
    q = rng.uniform(-0.2, 1.2, (Q, 3)).astype(np.float32)
    q[:3] = 3e38  # BIG queries: every distance is inf
    q[3] = np.nan  # NaN ranks as inf
    return torch.as_tensor(q, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,D,n_valid", [(1, 37, 30), (3, 129, 129),
                                         (8, 37, 5), (8, 1000, 900)])
def test_knn_gather_kernel_equals_plain(dev, k, D, n_valid):
    """Selections, distances and features bit for bit, including fewer
    valid nodes than k and all-inf rows."""
    rng = np.random.default_rng(D + k)
    pos, mask = _masked_nodes(rng, D, n_valid, dev)
    table = torch.as_tensor(rng.normal(size=(D, 13)), dtype=torch.float32,
                            device=dev)
    q = _edge_queries(rng, 333, dev)
    got = knn_cuda.knn_gather(q, pos, k, table, mask)
    want = knn_cuda.knn_gather_plain(q, pos, k, table, mask)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [100, 1024, 70000])
@pytest.mark.parametrize("case,D,k", [(c, 1024, 8) for c in PRUNE_CASES]
                         + [("few_valid", 37, 8), ("nonfinite", 37, 1),
                            ("sorted", 8192, 8)])
def test_knn_gather_pruned_kernel_equals_plain(dev, case, D, k, Q):
    """The pruned selection at the block the kernel picks (fewer threads at
    small Q and at D = 8192): indices, distances and features bit for
    bit."""
    q, pos, mask = _prune_inputs(case, D, k, Q=min(Q, 1024))
    q = np.resize(q, (Q, 3))  # repeated queries: several blocks per shape
    rng = np.random.default_rng(D + k)
    table = rng.normal(size=(D, 13)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (q, pos)]
    tab, m = torch.as_tensor(table, device=dev), torch.as_tensor(mask,
                                                                 device=dev)
    threads = knn_cuda.launch_info(Q, D)["threads"]
    if Q <= 1024:  # fewer than two blocks per SM at 64 threads
        assert threads == 32
    elif D <= 1024:
        assert threads == 256
    got = knn_cuda.knn_gather(*args, k, tab, m)
    want = knn_cuda.knn_gather_plain(*args, k, tab, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D,n_valid", [(37, 5), (256, 200)])
def test_warp_kernel_equals_plain(dev, D, n_valid):
    """Warped points, normals, blended DQ and ratio within 1e-6."""
    rng = np.random.default_rng(D)
    pos, mask = _masked_nodes(rng, D, n_valid, dev)
    t = rng.normal(0, 0.02, (D, 3))
    dqs = np.zeros((D, 8))
    dqs[:, 0] = 1.0
    dqs[:, 5:] = 0.5 * t
    dqs = torch.as_tensor(dqs, dtype=torch.float32, device=dev)
    w = torch.full((D,), 0.3, device=dev)
    q = torch.as_tensor(rng.uniform(0, 1, (517, 3)), dtype=torch.float32,
                        device=dev)
    n = torch.as_tensor(rng.normal(size=(517, 3)), dtype=torch.float32,
                        device=dev)
    got = warp_cuda.warp_fused(q, n, pos, dqs, w, mask)
    want = warp_cuda.warp_fused_plain(q, n, pos, dqs, w, mask)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("W,F", [(384, 1), (1024, 22)])
def test_window_sweep_kernel_equals_plain(dev, W, F):
    """Rows and certificates bit for bit, with a ragged last sub-tile,
    masked points, BIG queries and a window holding no valid point."""
    rng = np.random.default_rng(W)
    P, Q = 3000, 4096
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    pts[rng.random(P) < 0.05] = 3e38
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    pts[:W] = 3e38  # the lowest window holds no valid point
    qs = rng.uniform(-1, 1, (Q, 3)).astype(np.float32)
    qs = qs[np.argsort(qs[:, 0], kind="stable")]
    qs[rng.random(Q) < 0.05] = 3e38
    qsP, psP, lo_el, pre, suf, W = tknn.window_placement(
        torch.as_tensor(qs, device=dev), torch.as_tensor(pts, device=dev), W)
    lo_el[0] = 0  # force the empty window onto the first tile
    pay = torch.as_tensor(rng.normal(size=(psP.shape[0], F)),
                          dtype=torch.float32, device=dev)
    got = corr_cuda.nn1_window_sweep(qsP, psP, lo_el, pre, suf, 2048, W, pay)
    want = corr_cuda.nn1_window_sweep_plain(qsP, psP, lo_el, pre, suf, 2048,
                                            W, pay)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", NN1_CASES)
def test_window_sweep_pruned_kernel_equals_plain(dev, case):
    """Rows and certificates bit for bit on the pruning model's adversarial
    inputs (4096 queries: 4 warps share each group's visits)."""
    args = _nn1_inputs(case, dev, F=22)
    launch = corr_cuda.launch_info(args[0].shape[0])
    assert launch["sub"] == corr_cuda.SUB and launch["split"] == 4
    got = corr_cuda.nn1_window_sweep(*args)
    want = corr_cuda.nn1_window_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("blend", ["dqb", "dlb"])
@pytest.mark.parametrize("case,D,k", [(c, 1024, 8) for c in PRUNE_CASES]
                         + [("duplicates", 37, 8), ("few_valid", 37, 8),
                            ("nonfinite", 37, 1), ("sorted", 7233, 8),
                            ("sorted", 8192, 8)])
def test_warp_pruned_kernel_equals_plain(dev, blend, case, D, k):
    """The pruned selection at the block size the kernel picks (256
    threads; fewer at D = 7233 and 8192, where the lists and the static
    shared memory would not fit): ratio bitwise (the selection), the other
    outputs within 1e-6 (DQB) or 1e-5 (DLB), NaN where the plain version
    has NaN."""
    q, pos, mask = _prune_inputs(case, D, k)
    rng = np.random.default_rng(D)
    t = rng.normal(0, 0.02, (D, 3))
    dqs = np.zeros((D, 8))
    dqs[:, 0] = 1.0
    dqs[:, 1:4] = rng.normal(0, 0.05, (D, 3))
    dqs[:, :4] /= np.linalg.norm(dqs[:, :4], axis=1, keepdims=True)
    dqs[:, 5:] = 0.5 * t
    dqs[rng.random(D) < 0.33] *= -1.0
    w = rng.uniform(0.02, 0.1, D)
    n = rng.normal(size=q.shape)
    args = [torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (q, torch.float32), (n, torch.float32), (pos, torch.float32),
        (dqs, torch.float32), (w, torch.float32), (mask, torch.bool))]
    want = warp_cuda.warp_fused_plain(*args, k, blend)
    tol = 1e-6 if blend == "dqb" else 1e-5
    threads = warp_cuda.launch_threads(D)
    assert threads == 256 if D <= 1024 else 32 <= threads < 256
    got = warp_cuda.warp_fused(*args, k, blend)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    for g, x in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, x, rtol=0, atol=tol, equal_nan=True)


# --- the SE(3) fusion slice -----------------------------------------------
H, W = 96, 128
INTR = (140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
VOL_T = np.asarray([-0.5, -0.5, 0.25], np.float32)
IDENT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
FRAMES = [sphere_depth((CENTER[0] + 0.004 * i, CENTER[1], CENTER[2]),
                       RADIUS) for i in range(3)]


def _fusion_params(rotations=True):
    """The fixture's 64^3 scene in fusion mode with unique edges (the
    512^3 preset's fusion switches, capacities at the fixture's scale:
    ~115 nodes, ~8k band voxels, ~2.3k edge vertices); the SE(3) solve, or
    the translations-only one with rotations=False."""
    return dataclasses.replace(
        small_dynfu_params(), solver_rotations=rotations,
        corr_unique_edges=True,
        max_edge_verts=1 << 13, edge_col_budget=8, max_nodes=128,
        fusion_max_active=1 << 14, se3_relinearize=2)


# the source's reg assembly, jitted as its solve runs it
_j_assemble_reg = jax.jit(jse3._assemble_reg,
                          static_argnames=("D", "psi_reg", "similarity"))


def _jwf(pos, dqs, w, mask):
    return jfield.WarpField(jnp.asarray(pos), jnp.asarray(dqs),
                            jnp.asarray(w), jnp.asarray(mask),
                            jnp.asarray(int(mask.sum()), jnp.int32))


def _twf(pos, dqs, w, mask):
    return tfield.WarpField(_t(pos), _t(dqs), _t(w), _t(mask),
                            torch.tensor(int(mask.sum()), dtype=torch.int32))


def _flip_some(rng, dqs):
    """q and -q are the same transform: flip a third of the nodes so the
    DLB's sign alignment matters."""
    dqs = dqs.copy()
    dqs[rng.random(len(dqs)) < 0.33] *= -1.0
    return dqs


# --- DLB ------------------------------------------------------------------


def test_dlb_from_features_and_warp_match_jax():
    """_dlb_from_features on the same prefetched rows within 1e-6, and
    warp_points_normals_dlb (the port's plain warp) against JAX's XLA path
    within 1e-5 (two formulations of the same blend: weights normalised
    before vs after the sum, float32 roundoff)."""
    rng = np.random.default_rng(20)
    pos, dqs, w, mask = _nodes(rng, 64, 8)
    dqs = _flip_some(rng, dqs)
    q = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    n = rng.normal(size=(600, 3)).astype(np.float32)
    _, _, n_pos, n_dq, n_w, n_valid = jfield.neighbor_features(
        _jwf(pos, dqs, w, mask), jnp.asarray(q))
    want = jfield._dlb_from_features(jnp.asarray(q), n_pos, n_dq, n_w,
                                     n_valid)
    got = tfield._dlb_from_features(_t(q), _t(n_pos), _t(n_dq), _t(n_w),
                                    _t(n_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    jwp, jwn = jfield.warp_points_normals_dlb(_jwf(pos, dqs, w, mask),
                                              jnp.asarray(q), jnp.asarray(n))
    twp, twn = tfield.warp_points_normals_dlb(_twf(pos, dqs, w, mask),
                                              _t(q), _t(n))
    np.testing.assert_allclose(twp.numpy(), np.asarray(jwp), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(twn.numpy(), np.asarray(jwn), rtol=0,
                               atol=1e-5)


def test_warp_plain_dlb_matches_pallas_interpret():
    """warp_fused_plain(blend="dlb") against warp_fused_tpu(blend="dlb",
    interpret=True): points, normals, blended DQ and ratio within 1e-5
    (the kernel's one-hot fetch and its rotate-plus-translate transform vs
    dq_transform_point: float32 roundoff), including queries without
    support (the identity) and fewer valid nodes than k."""
    rng = np.random.default_rng(21)
    pos, dqs, w, mask = _nodes(rng, 40, 34, dg_w=0.2)  # 6 valid < k = 8
    dqs = _flip_some(rng, dqs)
    q = rng.uniform(-0.5, 1.5, (300, 3)).astype(np.float32)
    q[:20] = 50.0  # far from every node: no support
    n = rng.normal(size=(300, 3)).astype(np.float32)
    got = warp_cuda.warp_fused_plain(_t(q), _t(n), _t(pos), _t(dqs), _t(w),
                                     _t(mask), 8, "dlb")
    want = warp_pallas.warp_fused_tpu(
        jnp.asarray(q), jnp.asarray(n), jnp.asarray(pos), jnp.asarray(dqs),
        jnp.asarray(w), jnp.asarray(mask), blend="dlb", tq=256,
        interpret=True)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(got[2][:20].numpy(),
                                  np.tile([1, 0, 0, 0, 0, 0, 0, 0], (20, 1)))


# --- monomial Grams and the SE(3) solve -------------------------------------


def _gram_inputs(seed, N=700, K=8, D=96):
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((N, D)), axis=1)[:, :K].astype(np.int32)
    idx[rng.random((N, K)) < 0.05] = D  # padding slots
    w = rng.random((N, K), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[rng.random(N) < 0.3] = 0.0
    y = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    delta = rng.normal(0, 0.01, (N, 3)).astype(np.float32)
    return idx, w, s2, y, delta, D


def test_monomial_grams_plain_matches_jax():
    """B, Bu and Bw within 1e-5 of their max |.| against se3._monomial_grams
    (float32 dense strips on the CPU) and monomial_grams_tpu in interpret
    mode (3-pass bfloat16), with s2 = 0 rows and padded indices."""
    idx, w, s2, y, delta, D = _gram_inputs(22)
    got = gram_cuda.monomial_grams(*(_t(a) for a in (idx, w, s2, y, delta)),
                                   D)
    args = [jnp.asarray(a) for a in (idx, w, s2, y, delta)]
    for want in (jse3._monomial_grams(*args, D),
                 gram_pallas.monomial_grams_tpu(*args, D, tq=256,
                                                interpret=True)):
        for g, x in zip(got, want):
            x = np.asarray(x)
            np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                       atol=1e-5 * np.abs(x).max())


def _patch_scene(seed, n_nodes=12, n_verts=400, extent=0.5, cap=16):
    """A plane-ish patch with nodes over it (tests/test_solver_se3.py)."""
    rng = np.random.RandomState(seed)
    nodes = (rng.rand(n_nodes, 3).astype(np.float32) - 0.5) * extent
    verts = (rng.rand(n_verts, 3).astype(np.float32) - 0.5) * extent
    pos = np.zeros((cap, 3), np.float32)
    pos[:n_nodes] = nodes
    dqs = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0, 0], np.float32), (cap, 1))
    w = np.full(cap, 0.35, np.float32)
    mask = np.arange(cap) < n_nodes
    return (pos, dqs, w, mask), verts


def test_pcg_matches_jax():
    """The port's PCG (gn.pcg, as the SE(3) solve calls it) against the
    source's se3._pcg on a well-conditioned SPD system (rz falls ~100x per
    step, so float32 roundoff cannot move the step at which it crosses the
    tolerance): the same iteration count — not a multiple of the source's
    8-step trips — and x within 1e-5."""
    rng = np.random.default_rng(23)
    n = 96
    M = rng.normal(size=(n, n)).astype(np.float32) * 0.02
    A = (M @ M.T + np.diag(rng.uniform(1.0, 2.0, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    x0 = np.zeros(n, np.float32)
    jx, ji = jse3._pcg(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x0), 256,
                       1e-12)
    tx, ti = tgn.pcg(_t(A), _t(b), _t(x0), 256, 1e-12, matvec=torch.mv)
    assert int(ti) == int(ji) and int(ji) % 8 != 0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    # PCG capped by linear_iter, in 8-step trips (a cap of 20 runs 24
    # steps); where the tolerance ends it instead, float32 roundoff through
    # 30-odd CG steps moves the crossing by a step or two
    dict(relinearize=2, linear_iter=20, similarity_reg=True),
    dict(relinearize=3, linear_iter=16, incremental=True, rot_prior=0.3,
         psi_reg=1e-4, min_update=0.0005, max_update=0.05, trans_prior=0.1),
])
def test_se3_solve_matches_jax(kw):
    """A rotated, translated patch: the solved fields warp the vertices to
    within 1e-3 m of JAX's (the solver fixtures' tolerance; float32
    roundoff through assembly and PCG), node DQs within 1e-3, the same
    cg_iters, costs and mean rotation within 1 %, and a large cost
    reduction on both sides."""
    field, verts = _patch_scene(31)
    ang = 0.1
    c, s = np.cos(ang), np.sin(ang)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    live = (verts @ R.T + np.asarray([0.01, -0.005, 0.003], np.float32)
            ).astype(np.float32)
    vmask = np.ones(len(verts), bool)
    vmask[::17] = False
    common = dict(lambda_reg=20.0, **kw)
    jwf, jst = jse3.solve(_jwf(*field), jnp.asarray(verts), jnp.asarray(live),
                          jnp.asarray(vmask), **common)
    twf, tst = tse3.solve(_twf(*field), _t(verts), _t(live), _t(vmask),
                          **common)
    assert int(tst.cg_iters) == int(jst.cg_iters) > 0
    np.testing.assert_allclose(twf.dqs.numpy(), np.asarray(jwf.dqs), rtol=0,
                               atol=1e-3)
    jv, _ = jfield.warp_points_normals_dlb(jwf, jnp.asarray(verts),
                                           jnp.asarray(verts))
    tv, _ = tfield.warp_points_normals_dlb(twf, _t(verts), _t(verts))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-3)
    for a, b in ((tst.initial_cost, jst.initial_cost),
                 (tst.final_cost, jst.final_cost),
                 (tst.mean_rot_deg, jst.mean_rot_deg)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2, atol=1e-6)
    assert float(tst.final_cost) < 0.2 * float(tst.initial_cost)


def test_similarity_reg_long_path_at_capacity():
    """A path graph of D = 640 nodes (the 512^3 fusion capacity) whose node
    indices run in random order along the path: ONE component, so the
    similarity assembly must subtract exactly one rank-one scale downdate,
    A_p - A_s = (J^T d)(J^T d)^T / d^T d. For a field carrying a uniform
    expansion sigma, J^T d = -b_p / sigma (b_p the plain assembly's rhs), so
    the exact downdate is known in closed form; it is applied to random
    vectors. The port's labels iterate to convergence (231 rounds here) and
    meet it within float32 roundoff (1e-2 of its largest entry: A's ~1e-7
    relative error summed over 3840 terms); the source's fixed 10 pointer-
    jumping rounds stop at 26 pseudo-components and miss it by more than
    its own size."""
    rng = np.random.default_rng(40)
    D, sigma = 640, 0.05
    order = rng.permutation(D)
    pos = np.zeros((D, 3), np.float32)
    pos[order, 0] = (np.arange(D, dtype=np.float32) - D / 2) * 0.002
    pos[order, 1] = 0.01 * np.sin(np.arange(D) * 0.3)
    dqs = np.zeros((D, 8), np.float32)
    dqs[:, 0] = 1.0
    dqs[:, 5:8] = 0.5 * sigma * pos  # Trans(sigma p): a uniform expansion
    field = (pos, dqs, np.full(D, 0.05, np.float32), np.ones(D, bool))
    reg_idx = np.zeros((D, 2), np.int64)
    reg_idx[order, 0] = order
    reg_idx[order[:-1], 1] = order[1:]
    reg_idx[order[-1], 1] = order[-1]
    em = np.ones((D, 2), np.float32)

    assert (tse3._component_labels(_t(reg_idx), _t(em) > 0, D) == 0).all()
    args_t = (_twf(*field), _t(reg_idx), _t(em), 1.0, D)
    A_p, b_p, _ = tse3._assemble_reg(*args_t)
    A_s, _, _ = tse3._assemble_reg(*args_t, similarity=True)
    A_sj, _, _ = _j_assemble_reg(
        _jwf(*field), jnp.asarray(reg_idx.astype(np.int32)), jnp.asarray(em),
        1.0, D, similarity=True)
    # the downdates applied to random vectors, against the exact one
    n = D * 6
    V = torch.as_tensor(rng.normal(size=(n, 4)))
    d = (pos[reg_idx[:, 1]] - pos).astype(np.float64)
    b = b_p.double().reshape(n, 1)
    exact = b @ (b.T @ V) / (sigma ** 2 * float(np.sum(d * d)))
    A_p = A_p.double().reshape(n, n)
    got = (A_p - A_s.double().reshape(n, n)) @ V
    src = (A_p - torch.as_tensor(np.array(A_sj)).double().reshape(n, n)) @ V
    scale = float(exact.abs().max())
    assert float((got - exact).abs().max()) <= 1e-2 * scale
    assert float((src - exact).abs().max()) > scale


# --- warped integration -----------------------------------------------------


def _integrate_inputs():
    cfg = dict(dims=(64,) * 3, size=(1.0, 1.0, 1.0), trunc_dist=0.03)
    jcfg, tcfg = jtv.TsdfConfig(**cfg), tfusion.TsdfConfig(**cfg)
    d0 = np.array(jimg.compute_dists(jnp.asarray(FRAMES[0]), JIntr(*INTR)))
    vol = jtv.integrate(jtv.create(jcfg, (jnp.eye(3), jnp.asarray(VOL_T))),
                        jnp.asarray(d0), IDENT, JIntr(*INTR), jcfg)
    depth = sphere_depth((CENTER[0] + 0.01, CENTER[1], CENTER[2]), RADIUS)
    dists = np.array(jimg.compute_dists(jnp.asarray(depth), JIntr(*INTR)))
    _, normals = jimg.compute_points_normals(jnp.asarray(depth),
                                             JIntr(*INTR))
    rng = np.random.default_rng(50)
    d = rng.normal(size=(80, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    npos = (np.asarray(CENTER) + RADIUS * d - VOL_T).astype(np.float32)
    axis = rng.normal(0, 0.05, (80, 3)).astype(np.float32)
    t = np.tile(np.asarray([0.01, 0, 0], np.float32), (80, 1))
    from dynfu_tpu.core import dualquat as jdq
    dqs = np.array(jdq.dq_from_rodrigues(jnp.asarray(axis), jnp.asarray(t)))
    dqs[::3] *= -1.0
    field = (npos, dqs, np.full(80, 0.12, np.float32), np.ones(80, bool))
    return jcfg, tcfg, vol, dists, np.array(normals), field


@pytest.mark.parametrize("blend,max_active", [("dlb", 1 << 16),
                                              ("dqb", 4096)])
def test_integrate_warped_matches_jax(blend, max_active):
    """One warped integration of a shifted sphere through a rotating
    field: FusionStats equal (n_captured < n_band when the band overflows
    max_active); weights and tsdf equal except boundary flips — a voxel
    whose support ratio sits within float32 roundoff of 1 (the kernel's
    sqrt(d)/dg_w vs the XLA path's d/dg_w^2) or whose float16 rounding
    flips under a one-ulp difference of the warped position: at most
    0.5 % of the updated voxels, and tsdf within 2e-3 where both updated."""
    jcfg, tcfg, vol, dists, normals, field = _integrate_inputs()
    kw = dict(normals=None, min_cos=0.25, max_active=max_active, dilate=2,
              knn_k=8, blend=blend)
    jv, js = jfusion.integrate_warped(
        vol, _jwf(*field), jnp.asarray(dists), IDENT, JIntr(*INTR), jcfg,
        **{**kw, "normals": jnp.asarray(normals)})
    tvol = convert.volume(*(np.array(a) for a in vol), device="cpu")
    tv, ts = tfusion.integrate_warped(
        tvol, _twf(*field), _t(dists), IDENT, TIntr(*INTR), tcfg,
        **{**kw, "normals": _t(normals)})
    assert int(ts.n_band) == int(js.n_band)
    assert int(ts.n_captured) == int(js.n_captured)
    if max_active == 4096:
        assert int(js.n_captured) < int(js.n_band)
    n_upd = int(js.n_updated)
    assert n_upd > 1000 and abs(int(ts.n_updated) - n_upd) <= 0.005 * n_upd
    jw, tw = np.asarray(jv.weight), tv.weight.numpy()
    jt, tt = np.asarray(jv.tsdf, np.float32), tv.tsdf.numpy().astype(
        np.float32)
    differ = (jw != tw) | (jt != tt)
    assert differ.sum() <= 0.005 * n_upd, differ.sum()
    both = (jw == tw) & (jw > np.asarray(vol.weight))
    assert np.abs(jt - tt)[both].max() <= 2e-3


# --- the engine in fusion mode -----------------------------------------------


def _state(e):
    """The JAX fusion engine's state as numpy arrays, for utils/convert."""
    c = e.canonical
    return dict(
        vol=tuple(np.array(a) for a in e.vol),
        wf=tuple(np.array(a) for a in e.warpfield),
        canonical=(c.idx, np.array(c.vertices), np.array(c.normals),
                   np.array(c.mask)),
        frame_counter=e.frame_counter,
        poses=[(np.array(R), np.array(t)) for R, t in e.poses])


def _outputs(e, to_np):
    """After a frame: the warped canonical, the canonical, the nodes and
    the counters."""
    v, m = e.warped_cloud()
    fs = e.last_frame_stats
    return dict(
        warped=to_np(v), mask=to_np(m),
        canonical=to_np(e.canonical.vertices),
        count=int(e.warpfield.count), node_pos=to_np(e.warpfield.pos),
        stats=None if fs is None else (
            int(fs.mc_dropped), int(fs.corr_dropped), int(fs.band.n_band),
            int(fs.band.n_captured)))


_ENGINE_STATE = ("vol", "warpfield", "canonical", "canonical_warped",
                 "frame_counter")


# a near-tie of the k-NN, from frame 1 of the moving-camera run: two nodes
# one float32 ulp apart in y, four queries near them
TIE_NODES = np.array([[0.203125, 0.3472539484500885, 0.5625],
                      [0.203125, 0.3472539782524109, 0.5625]], np.float32)
TIE_QUERIES = np.array(
    [[0.18682269752025604, 0.34973764419555664, 0.5771478414535522],
     [0.1867915540933609, 0.34425854682922363, 0.5723371505737305],
     [0.20298929512500763, 0.36425670981407166, 0.5779308080673218],
     [0.2029689997434616, 0.35946905612945557, 0.5722742676734924]],
    np.float32)


@contextlib.contextmanager
def _jax_knn_through_pallas():
    """JAX's k-NN feature fetch (warp/field.neighbor_features) through its
    TPU kernel, knn_gather_tpu, in interpret mode, not the CPU's XLA path:
    the kernel, like the port's, forms each squared distance from the
    coordinate differences, while the XLA path's |q|^2 - 2 q.p + |p|^2
    orders near-ties otherwise (test_knn_near_tie_follows_tpu_kernel). JAX's
    traces are dropped on entry and on exit, so that no program traced
    with the other path is reused, here or by a later test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_pallas, "available", lambda: True)
        mp.setattr(knn_pallas, "knn_gather_tpu", functools.partial(
            knn_pallas.knn_gather_tpu, interpret=True))
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def test_knn_near_tie_follows_tpu_kernel():
    """On two nodes one ulp apart, the port's k-NN picks what JAX's TPU
    kernel (interpret mode) picks, at its distances to float32 roundoff;
    JAX's XLA path (the expanded form) picks the other node for three of
    the four queries."""
    table = np.arange(2, dtype=np.float32)[:, None]
    mask = np.ones(2, bool)
    assert np.nextafter(TIE_NODES[0, 1], np.float32(1)) == TIE_NODES[1, 1]
    pi, pd, _ = knn_cuda.knn_gather(*(torch.as_tensor(a) for a in (
        TIE_QUERIES, TIE_NODES)), 1, torch.as_tensor(table),
        torch.as_tensor(mask))
    jargs = [jnp.asarray(a) for a in (TIE_QUERIES, TIE_NODES)]
    ti, td, _ = knn_pallas.knn_gather_tpu(*jargs, 1, jnp.asarray(table),
                                          jnp.asarray(mask), interpret=True)
    xi, _, _ = jknn.knn_gather(*jargs, 1, jnp.asarray(table),
                               jnp.asarray(mask))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ti))
    np.testing.assert_allclose(pd.numpy(), np.asarray(td), rtol=1e-6, atol=0)
    assert (np.asarray(xi) != pi.numpy()).sum() == 3


@pytest.fixture(scope="module")
def jax_run():
    """One JAX fusion run, its k-NN through the TPU kernel
    (_jax_knn_through_pallas): (state before frame i, outputs after frame
    i, the engine's own state after frame 0)."""
    with _jax_knn_through_pallas():
        eng = JaxDynFusion(_fusion_params(), mode="fusion")
        states, outs = [], []
        for d in FRAMES:
            states.append(_state(eng) if eng.frame_counter else None)
            eng(d)
            outs.append(_outputs(eng, np.array))
            wf = eng.warpfield  # pin dg_w's type (one compile of the frame)
            eng.warpfield = wf._replace(w=jnp.asarray(np.array(wf.w)))
            if len(outs) == 1:
                after0 = {a: getattr(eng, a) for a in _ENGINE_STATE}
                after0["poses"] = list(eng.poses)
    return states, outs, after0


@pytest.fixture(scope="module")
def jax_translations_frame1(jax_run):
    """Outputs of frame 1 of the JAX engine with the translations-only
    solve (gn.solve on the node graph with the update gates, DQB warps),
    from the SE(3) run's state after frame 0 (frame 0 does not depend on
    the solver); its k-NN through the TPU kernel."""
    with _jax_knn_through_pallas():
        eng = JaxDynFusion(_fusion_params(rotations=False), mode="fusion")
        for a, v in jax_run[2].items():
            setattr(eng, a, list(v) if a == "poses" else v)
        eng(FRAMES[1])
        return _outputs(eng, np.array)


def _port(rotations=True):
    return DynFusion(convert.params(_fusion_params(rotations)), device="cpu",
                     mode="fusion")


def _port_outputs(e):
    return _outputs(e, lambda t: t.cpu().numpy())


def _compare(got, want, atol):
    """Counters, node count and the canonical edge set equal; canonical,
    warped canonical and node positions within atol."""
    assert got["count"] == want["count"]
    assert got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    assert m.sum() > 500
    n = want["count"]
    for key, sel in (("canonical", m), ("warped", m), ("node_pos", slice(n))):
        diff = np.abs(got[key][sel] - want[key][sel])
        assert diff.max() <= atol, (key, diff.max())


def test_fusion_frame0_matches(jax_run):
    """Bootstrap: the same nodes (sampled from the corner-convention soup)
    and the same unique-edge canonical, index for index."""
    _, outs, _ = jax_run
    port = _port()
    assert port(FRAMES[0]) is False
    _compare(_port_outputs(port), outs[0], 1e-6)


@pytest.mark.parametrize("k,rotations", [
    pytest.param(1, True, id="1-0.0"),
    pytest.param(2, True, id="2-0.0"),
    pytest.param(1, False, id="translations-1"),
])
def test_fusion_frame_from_jax_state(request, jax_run, k, rotations):
    """Frame k from JAX's state after frame k-1: the same counters, node
    count and canonical edge set; canonical, warped canonical and node
    positions within 1e-4 m (float32 roundoff through the solve; the
    selections are equal). JAX's k-NN runs its TPU kernel: with the XLA
    path's distances, frame 2's near-ties order otherwise and up to 5 % of
    the coordinates differed by up to 5e-4 m. With rotations=False, frame 1
    takes the translations-only branch of the fusion frame
    (run_fusion_benchmark's default)."""
    states, outs, _ = jax_run
    want = outs[k] if rotations else request.getfixturevalue(
        "jax_translations_frame1")
    port = convert.load_engine_state(_port(rotations), **states[k])
    assert port(FRAMES[k]) is True
    _compare(_port_outputs(port), want, 1e-4)


def test_fusion_free_running_three_frames(jax_run):
    """The port alone over all three frames: the same node count and
    counters, the final warped canonical within 1e-3 m of JAX's."""
    _, outs, _ = jax_run
    port = _port()
    for d in FRAMES:
        port(d)
    _compare(_port_outputs(port), outs[-1], 1e-3)


# the moving camera (ROADMAP F2): the fixture's sphere moving 4 mm per frame
# in x, two static anchors for the tracking, the camera moving 4 mm per frame
# in y
MOVINGCAM_FRAMES = [scene_depth(
    cam_t=(0.0, 0.004 * i, 0.0),
    spheres=[((CENTER[0] + 0.004 * i, CENTER[1], CENTER[2]), RADIUS)]
    + SCENE[1:]) for i in range(3)]


def _movingcam_params():
    return dataclasses.replace(_fusion_params(), fusion_camera_tracking=True)


@pytest.fixture(scope="module")
def jax_movingcam_run():
    """One JAX fusion run with camera tracking over MOVINGCAM_FRAMES, its
    k-NN through the TPU kernel (_jax_knn_through_pallas): (state before
    frame i, with the tracking's reference pyramid and the warped
    canonical; outputs and tracked pose after frame i)."""
    with _jax_knn_through_pallas():
        return _jax_movingcam_frames()


def _jax_movingcam_frames():
    eng = JaxDynFusion(_movingcam_params(), mode="fusion")
    states, outs = [], []
    for d in MOVINGCAM_FRAMES:
        st = None
        if eng.frame_counter:
            st = _state(eng)
            cw = eng.canonical_warped
            st["canonical_warped"] = (cw.idx, np.array(cw.vertices),
                                      np.array(cw.normals), np.array(cw.mask))
            st["prev_live_pyr"] = [(np.array(a), np.array(b))
                                   for a, b in eng.prev_live_pyr]
        states.append(st)
        eng(d)
        outs.append((_outputs(eng, np.array),
                     tuple(np.array(a) for a in eng.poses[-1])))
    return states, outs


@pytest.mark.parametrize("k", [0, 1, 2])
def test_movingcam_frame_from_jax_state(jax_movingcam_run, k):
    """Fusion mode with camera tracking, frame k from JAX's state after
    frame k-1 (its reference pyramid and warped canonical included; frame 0
    from a new engine): the tracked pose within 1e-4 (the ICP tolerance of
    tests/test_torch_rigid.py), the counters (n_band and corr_dropped
    among them), node count and canonical edge set equal, the positions
    within 1e-4 m through _compare. JAX's k-NN runs its TPU kernel: with
    the XLA path's distances, frame 1's nodes 3 and 5 (one ulp apart, the
    tie of test_knn_near_tie_follows_tpu_kernel) swap in 35 rows of the
    data term's 8-NN and 5 of node insertion's 1-NN, and two weakly
    observed nodes then move by up to 1e-3 m."""
    states, outs = jax_movingcam_run
    want, pose = outs[k]
    port = DynFusion(convert.params(_movingcam_params()), device="cpu",
                     mode="fusion")
    if k:
        port = convert.load_engine_state(port, **states[k])
    assert port(MOVINGCAM_FRAMES[k]) is (k > 0)
    for a, b in zip(port.poses[-1], pose):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-4)
    _compare(_port_outputs(port), want, 1e-4)


# --- kernels against their plain versions, on the card --------------------


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q,D,n_masked", [(1000, 64, 60),  # 4 valid < k
                                          (777, 300, 20),
                                          (129, 8, 0)])
def test_warp_dlb_kernel_equals_plain(dev, Q, D, n_masked):
    """Exact selections (equal ratio) and <= 1e-5 on the blended outputs;
    Q not a multiple of the 128-thread block, fewer valid nodes than k,
    rows without support (the identity)."""
    rng = np.random.default_rng(Q + D)
    pos, dqs, w, mask = _nodes(rng, D, n_masked, dg_w=0.15)
    dqs = _flip_some(rng, dqs)
    q = rng.uniform(-0.2, 1.2, (Q, 3)).astype(np.float32)
    q[:7] = 40.0
    n = rng.normal(size=(Q, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (q, n, pos, dqs, w, mask)]
    got = warp_cuda.warp_fused(*args, 8, "dlb")
    want = warp_cuda.warp_fused_plain(*args, 8, "dlb")
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3])
    for g, x in zip(got, want):
        assert float((g - x).abs().max()) <= 1e-5
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], device=dev)
    assert torch.equal(got[2][:7], ident.expand(7, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D", [(5000, 8, 640), (999, 3, 50),
                                   (1, 8, 16)])
def test_monomial_grams_kernel_equals_plain(dev, N, K, D):
    """<= 1e-5 of max |.| (both sum in float64, in other orders), with
    s2 = 0 rows, padded indices and K < 8."""
    args = [torch.as_tensor(a, device=dev)
            for a in _gram_inputs(N + K, N, K, D)[:5]]
    got = gram_cuda.monomial_grams(*args, D)
    want = gram_cuda.monomial_grams_plain(*args, D)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        scale = max(float(x.abs().max()), 1e-30)
        assert float((g - x).abs().max()) <= 1e-5 * scale


def _tiled_gram_inputs(kind, N, K, D):
    """Rows as the SE(3) solve sees them, in surface order: "shared" gives
    every row one node set (the most contention); "coherent" each run of
    256 rows K of a window of 2K nodes somewhere in [0, D), with a run of
    rows of random nodes (tiles with more distinct nodes than the
    shared-memory slots); padded slots, s2 = 0 rows."""
    rng = np.random.default_rng(N + K + D)
    if kind == "shared":
        idx = np.tile(rng.choice(D, K, replace=False), (N, 1))
    else:
        base = rng.integers(0, D - 2 * K, -(-N // 256)).repeat(256)[:N]
        idx = base[:, None] + np.argsort(rng.random((N, 2 * K)),
                                         axis=1)[:, :K]
        idx[N // 2:N // 2 + 1200] = np.argsort(
            rng.random((1200, D)), axis=1)[:, :K]
    idx = idx.astype(np.int32)
    idx[rng.random((N, K)) < 0.05] = D
    idx[rng.random((N, K)) < 0.02] = -1
    w = rng.random((N, K), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[rng.random(N) < 0.3] = 0.0
    y = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    delta = rng.normal(0, 0.01, (N, 3)).astype(np.float32)
    return idx, w, s2, y, delta


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K,D", [("shared", 5000, 8, 640),
                                        ("coherent", 6000, 8, 1024),
                                        ("coherent", 4000, 3, 1024),
                                        ("coherent", 3000, 8, 200),
                                        ("coherent", 3000, 8, 400)])
def test_monomial_grams_tiles_equal_plain(dev, kind, N, K, D):
    """<= 1e-5 of max |.| of the plain version, the same bits over three
    launches and the bits of the fixed-order model at the kernel's warps
    per block; the coherent rows with K = 8 give nodes more neighbours than
    one 32-column pass, the shared node set fewer."""
    args = [torch.as_tensor(a, device=dev)
            for a in _tiled_gram_inputs(kind, N, K, D)]
    want = gram_cuda.monomial_grams_plain(*args, D)
    work = gram_cuda.gather_work(args[0], args[1], args[2], D, True)
    most = int(work["neighbours"].max())
    if kind == "shared":
        assert most <= 32  # one pass
    elif K == 8:
        assert most > 32  # several passes
    outs = [gram_cuda.monomial_grams(*args, D) for _ in range(3)]
    torch.cuda.synchronize()
    for g, x in zip(outs[0], want):
        scale = max(float(x.abs().max()), 1e-30)
        assert float((g - x).abs().max()) <= 1e-5 * scale
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    idx, w, s2, y, delta = (a.cpu() for a in args)
    model = gram_cuda.gram_fixed_order(idx, w, s2, delta, D,
                                       gram_cuda.gram_warps(N, D, True), y=y)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(outs[0], model))


@pytest.mark.cuda
def test_index_add_ordered_on_card(dev):
    """segsum.index_add, the fixed-order sums of the SE(3) reg equations and
    of node insertion, on the card: the same bits over three calls, with
    many terms per row, and within float32 roundoff of the CPU's
    index-order sums (the card adds in the order of its index sort)."""
    rng = np.random.default_rng(5)
    index = torch.as_tensor(rng.integers(0, 50, 20000))
    values = torch.as_tensor(rng.normal(size=(20000, 6)).astype(np.float32))
    base = torch.as_tensor(rng.normal(size=(50, 6)).astype(np.float32))
    outs = [segsum.index_add(base.to(dev), index.to(dev), values.to(dev))
            for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = segsum.index_add(base, index, values)
    torch.testing.assert_close(outs[0].cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
