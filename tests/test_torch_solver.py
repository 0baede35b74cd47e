"""PyTorch port vs JAX reference: the GN data-term Gram and the warp solve
on the reference's Opt fixtures (tests/test_solver_parity.py), on the CPU.
A plain model of the Gram kernel's fixed summation order is held against
the plain version and against a sequential Python sum. The tests marked
`cuda` hold the Gram kernel against its plain version, against itself over
three launches and against the fixed-order model (they skip without a
card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynfu_tpu.solver import gn as jgn
from dynfu_tpu.solver import gram_pallas
from dynfu_tpu.warp import field as jfield
from dynfu_tpu_torch.core import dualquat as tdq
from dynfu_tpu_torch.solver import gn as tgn
from dynfu_tpu_torch.solver import gram_cuda
from dynfu_tpu_torch.warp import field as tfield

# the fixtures of tests/test_solver_parity.py (opt_optimisation_test.cpp)
from test_solver_parity import (ALL_NODES, DG_W, GROUP1, LAMBDA, MAX_ERROR,
                                PSI_DATA, PSI_REG, SRC5, SRC5B, TGT5, TGT5B,
                                TGT5C, TUKEY_OFFSET)

# small tensors: one intra-op thread avoids contending with XLA's thread
# pool (the test gate runs two files at a time)
torch.set_num_threads(1)


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
    weights and zero s2 (skipped rows)."""
    rng = np.random.default_rng(seed)
    if repeated:
        idx = rng.integers(-1, D + 1, (N, K))
    else:
        idx = np.argsort(rng.random((N, D)), axis=1)[:, :K]
    w = rng.random((N, K), dtype=np.float32)
    w[rng.random((N, K)) < 0.1] = 0.0
    s2 = rng.random(N, dtype=np.float32)
    s2[::3] = 0.0
    delta = rng.normal(size=(N, 3)).astype(np.float32)
    return idx.astype(np.int32), w, s2, delta


def _sequential_gram(idx, w, s2, delta, D, warps):
    """The kernel's order in plain Python: each node's entries in (row,
    slot) order, cut into `warps` equal shares, each summed in float64
    entry by entry (a row's slots holding one node summed first, in slot
    order); the shares summed in order and rounded once."""
    N, K = idx.shape
    acc = np.zeros((warps, D, D + 3))
    bucket = [[] for _ in range(D)]
    for n in range(N):
        for r in range(K):
            if 0 <= idx[n, r] < D and s2[n] != 0 and w[n, r] != 0:
                bucket[idx[n, r]].append((n, r))
    for i, entries in enumerate(bucket):
        for o, (n, r) in enumerate(entries):
            g = max(g for g in range(warps) if len(entries) * g // warps <= o)
            ws = float(s2[n]) * float(w[n, r])
            for j in dict.fromkeys(idx[n]):  # distinct nodes, in slot order
                if 0 <= j < D:
                    acc[g, i, j] += sum(ws * float(w[n, s]) for s in range(K)
                                        if idx[n, s] == j)
            for c in range(3):
                acc[g, i, D + c] += ws * float(delta[n, c])
    tot = acc[0]
    for g in range(1, warps):
        tot = tot + acc[g]
    tot = tot.astype(np.float32)
    return tot[:, :D], tot[:, D:]


@pytest.mark.parametrize("warps", [1, 3, 4])
def test_gram_fixed_order_model(warps):
    """The plain model of the kernel's fixed summation order: within 1e-5
    of max |A| (resp. max |b|) of data_normal_plain, the same bits on a
    second call, and equal to the order written out in plain Python."""
    args = [torch.as_tensor(a) for a in _gram_inputs(warps, 400, 8, 30)]
    A, b = gram_cuda.data_normal_fixed_order(*args, 30, warps)
    A0, b0 = gram_cuda.data_normal_plain(*args, 30)
    torch.testing.assert_close(A, A0, rtol=0, atol=1e-5 * float(A0.abs().max()))
    torch.testing.assert_close(b, b0, rtol=0, atol=1e-5 * float(b0.abs().max()))
    A1, b1 = gram_cuda.data_normal_fixed_order(*args, 30, warps)
    assert torch.equal(A, A1) and torch.equal(b, b1)
    As, bs = _sequential_gram(*(a.numpy() for a in args), 30, warps)
    np.testing.assert_array_equal(A.numpy(), As)
    np.testing.assert_array_equal(b.numpy(), bs)


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
    """Within 1e-5 of max |A| and max |b| (the kernel sums in float64, the
    plain version in float32), with out-of-range indices skipped and
    repeated indices in a row."""
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
                                            (4000, 8, 3000, False)])
def test_gram_kernel_fixed_order(dev, N, K, D, repeated):
    """The same bits over three launches, and the bits of the plain
    fixed-order model (on the CPU) at the kernel's warps per block; empty
    rows of A (nodes without an entry) are zeros."""
    args = [torch.as_tensor(a, device=dev)
            for a in _gram_inputs(D + K, N, K, D, repeated)]
    outs = [gram_cuda.data_normal(*args, D) for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
    warps = gram_cuda.data_normal_warps(D)
    assert 1 <= warps <= 4
    A, b = gram_cuda.data_normal_fixed_order(*(a.cpu() for a in args), D,
                                             warps)
    assert torch.equal(outs[0][0].cpu(), A) and torch.equal(outs[0][1].cpu(), b)
