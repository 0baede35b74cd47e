"""PyTorch port vs JAX reference: k-NN with feature fetch, the windowed
1-NN correspondence and its tiers, the fused DQB warp, the unsupported
mask and node insertion. Seeded numpy inputs, CPU; Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The candidate rule
of the fused warp and the k-NN (a plain model of their pruned selection) is
held against the brute-force selection, and the 1-NN's sub-tile pruning
(a plain model of the kernel's sweep) against the plain sweep.

The tests marked `cuda` hold the k-NN, warp and 1-NN CUDA kernels against
their plain versions at edge-case shapes (odd sizes, fewer valid nodes
than k, all-inf and NaN rows, ragged sub-tiles, an empty window, equal
distances, scattered queries, spatially sorted queries that the kernels
prune for, D = 8192); they skip without a card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core import dualquat as jdq
from dynfu_tpu.ops import knn as jknn
from dynfu_tpu.ops import knn_pallas, warp_pallas
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.ops import knn as tknn
from dynfu_tpu_torch.ops import corr_cuda, knn_cuda, warp_cuda
from dynfu_tpu_torch.warp import field as tfield

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

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


def _jwf(pos, dqs, w, mask):
    return jfield.WarpField(jnp.asarray(pos), jnp.asarray(dqs), jnp.asarray(w),
                            jnp.asarray(mask), jnp.int32(mask.sum()))


def _twf(pos, dqs, w, mask):
    return tfield.WarpField(_t(pos), _t(dqs), _t(w), _t(mask),
                            torch.tensor(int(mask.sum()), dtype=torch.int32))


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


@pytest.fixture
def dev():
    """The CUDA device; tests that take it are marked `cuda` and skip
    without a card (run them on the GPU with `-m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on the GPU machine")
    return torch.device("cuda")


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
