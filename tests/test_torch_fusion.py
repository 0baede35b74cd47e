"""PyTorch port vs JAX reference: the SE(3) fusion slice on the CPU — the
DLB blend and warp, the monomial Grams, the SE(3) solve, warped
integration, and fusion-mode frames of the engine on the
tests/test_pipeline.py fixture (96x128 depth, 64^3 volume, a sphere of
r = 0.22 m moving 4 mm per frame). Pallas kernels run in interpret mode, as
the JAX package's own tests run them.

The tests marked `cuda` hold the DLB warp and monomial-Gram CUDA kernels
against their plain versions at edge-case shapes (for the Grams: tiles of
rows that share one node set, tiles with more distinct nodes than the
shared-memory slots, padding, s2 = 0 rows, K < 8, D = 1024); they skip
without a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.core.camera import Intr as JIntr
from dynfu_tpu.engine.dynfusion import DynFusion as JaxDynFusion
from dynfu_tpu.ops import imgproc as jimg
from dynfu_tpu.ops import warp_pallas
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.solver import se3 as jse3
from dynfu_tpu.volume import fusion as jfusion
from dynfu_tpu.volume import tsdf as jtv
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core.camera import Intr as TIntr
from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.ops import warp_cuda
from dynfu_tpu_torch.solver import gn as tgn
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.solver import se3 as tse3
from dynfu_tpu_torch.utils import convert
from dynfu_tpu_torch.volume import fusion as tfusion
from dynfu_tpu_torch.warp import field as tfield

from test_pipeline import CENTER, RADIUS, small_dynfu_params, sphere_depth
from test_torch_knn_warp import _nodes, _t

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)

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


def test_mono_segments():
    """How the monomial-Gram kernel cuts its tiles: distinct in-range
    indices of slots with sqrt(max(s2, 0)) w != 0; a segment with more than
    u is halved down to min_rows, and the next starts at the length the
    last ended with; a new tile starts at full length."""
    idx = torch.tensor([[0, 1], [0, 1], [2, 3], [4, 5], [6, 9], [6, 7]],
                       dtype=torch.int32)
    w = torch.ones((6, 2))
    w[2, 1] = 0.0
    s2 = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, -1.0])
    got = gram_cuda.mono_segments(idx, w, s2, 8, 4, 2, 1)
    assert got == [(0, 2, 2), (2, 1, 1), (3, 1, 2), (4, 2, 1)]
    # u = 1: row 3 alone has two nodes and takes the global route
    got = gram_cuda.mono_segments(idx, w, s2, 8, 4, 1, 1)
    assert got == [(0, 1, 2), (1, 1, 2), (2, 1, 1), (3, 1, 2), (4, 2, 1)]


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


@pytest.fixture(scope="module")
def jax_run():
    """One JAX fusion run: (state before frame i, outputs after frame i,
    the engine's own state after frame 0)."""
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
    from the SE(3) run's state after frame 0: frame 0 does not depend on
    the solver."""
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


def _close(got, want, atol, flips, flip_atol):
    """Within atol, except a fraction `flips` of the entries within
    flip_atol."""
    diff = np.abs(got - want)
    assert diff.max() <= flip_atol, diff.max()
    assert (diff > atol).mean() <= flips, (diff > atol).mean()


def _compare(got, want, atol, flips=0.0, flip_atol=0.0):
    """Counters, node count and the canonical edge set equal; canonical,
    warped canonical and node positions within atol, but for a fraction
    `flips` of the coordinates within flip_atol."""
    assert got["count"] == want["count"]
    assert got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    assert m.sum() > 500
    n = want["count"]
    for key, sel in (("canonical", m), ("warped", m), ("node_pos", slice(n))):
        _close(got[key][sel], want[key][sel], atol, flips,
               max(atol, flip_atol))


def test_fusion_frame0_matches(jax_run):
    """Bootstrap: the same nodes (sampled from the corner-convention soup)
    and the same unique-edge canonical, index for index."""
    _, outs, _ = jax_run
    port = _port()
    assert port(FRAMES[0]) is False
    _compare(_port_outputs(port), outs[0], 1e-6)


@pytest.mark.parametrize("k,flips,rotations", [
    pytest.param(1, 0.0, True, id="1-0.0"),
    pytest.param(2, 0.05, True, id="2-0.05"),
    pytest.param(1, 0.0, False, id="translations-1"),
])
def test_fusion_frame_from_jax_state(request, jax_run, k, flips, rotations):
    """Frame k from JAX's state after frame k-1: the same counters, node
    count and canonical edge set; canonical, warped canonical and node
    positions within 1e-4 m (float32 roundoff through the solve; the
    selections are equal). Frame 2's solve runs PCGs that end on their
    tolerance (21 steps in both) on a weakly observed rotation field, whose
    float32 roundoff moves weak nodes' warps by up to 0.2 mm (measured):
    there up to 5 % of the coordinates may differ by up to 5e-4 m. With
    rotations=False, frame 1 takes the translations-only branch of the
    fusion frame (run_fusion_benchmark's default)."""
    states, outs, _ = jax_run
    want = outs[k] if rotations else request.getfixturevalue(
        "jax_translations_frame1")
    port = convert.load_engine_state(_port(rotations), **states[k])
    assert port(FRAMES[k]) is True
    _compare(_port_outputs(port), want, 1e-4, flips, 5e-4)


def test_fusion_free_running_three_frames(jax_run):
    """The port alone over all three frames: the same node count and
    counters, the final warped canonical within 1e-3 m of JAX's."""
    _, outs, _ = jax_run
    port = _port()
    for d in FRAMES:
        port(d)
    _compare(_port_outputs(port), outs[-1], 1e-3)


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
    """<= 1e-5 of max |.| (float32 atomics in a varying order), with s2 = 0
    rows, padded indices and K < 8."""
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
                                        ("coherent", 4000, 3, 1024)])
def test_monomial_grams_tiles_equal_plain(dev, kind, N, K, D):
    """<= 1e-5 of max |.| at the kernel's tiling; the coherent rows take
    both routes (shared-memory segments, halved ones among them, and
    global-atomic ones), the shared node set only the first."""
    args = [torch.as_tensor(a, device=dev)
            for a in _tiled_gram_inputs(kind, N, K, D)]
    want = gram_cuda.monomial_grams_plain(*args, D)
    rows, u, min_rows = gram_cuda.mono_tiling()
    segs = gram_cuda.mono_segments(args[0], args[1], args[2], D, rows, u,
                                   min_rows)
    n_global = sum(n > u for _, _, n in segs)
    if kind == "shared":
        assert n_global == 0
    else:
        assert 0 < n_global < len(segs)
        # halved segments in shared memory (short, and not the last)
        assert any(n <= u and nr < rows and r0 + nr < N
                   for r0, nr, n in segs)
    got = gram_cuda.monomial_grams(*args, D)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        scale = max(float(x.abs().max()), 1e-30)
        assert float((g - x).abs().max()) <= 1e-5 * scale
