#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from dynfu_tpu_torch/csrc (one nvcc
   per source, all started together);
3. kernel phase: runs each kernel and its plain PyTorch version on the
   card on the same inputs, at the shapes of the path that runs it — the
   128^3 parity slice's pack, k-NN, windowed 1-NN, DQB warp and Gram
   kernels, and the 512^3 SE(3) fusion slice's DLB warp (Q = 524288 band
   points, D = 640 nodes of a real frame 0, rotated) and monomial Grams
   (N = 65536, K = 8, D = 640) — checks that they agree (selections
   exactly, floats within the stated tolerance) and times each: CUDA
   events over back-to-back calls (ms), the profiler's device time per call
   (device_ms), the plain version (plain_ms) and, where one PyTorch call
   computes the same function, that call (library_ms); bound_ms is the
   least time the card could take (the larger of the bytes over 3.35 TB/s
   and the operations over 67 TFLOP/s of float32), from this run's inputs;
4. small-input checks: three frames of a 64^3 scene in parity mode and in
   SE(3) fusion mode on the card, each against the same engine on the CPU;
5. parity slice: run_benchmark(128, repeats=3), with every launch counter
   zeroed just before it; requires zero drops, the accuracy bounds, its
   five kernels launched and no plain version run on a CUDA tensor;
6. fusion slice: run_fusion_benchmark(512, rotations=True), counters zeroed
   just before it; requires no dropped edges, the whole band captured, the
   accuracy bounds, the DLB warp, k-NN, monomial-Gram and pack kernels
   launched and no plain version run on a CUDA tensor.

Prints each phase's seconds, the kernels' JSON line, the card's line, then
as its last line the device JSON. Any failed check raises, and the script
exits non-zero without that line. It needs CUDA: without a card it exits 1
before doing anything.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
    sys.exit(1)

# the port itself, from the checkout this script sits in: outside a checkout
# the import fails, and a copy installed elsewhere is refused
from dynfu_tpu_torch import kernels  # noqa: E402

if kernels.CSRC.parents[1] != Path(__file__).resolve().parent:
    print(f"chip_smoke: dynfu_tpu_torch comes from {kernels.CSRC.parents[1]}, "
          "not from this script's checkout", file=sys.stderr)
    sys.exit(1)

from dynfu_tpu_torch.core import dualquat as dq  # noqa: E402
from dynfu_tpu_torch.engine.dynfusion import DynFusion  # noqa: E402
from dynfu_tpu_torch.mesh import mc_cuda  # noqa: E402
from dynfu_tpu_torch.ops import (compaction, corr_cuda, knn,  # noqa: E402
                                 knn_cuda, warp_cuda)
from dynfu_tpu_torch.solver import gram_cuda  # noqa: E402
from dynfu_tpu_torch.utils.benchmarks import (  # noqa: E402
    bench_frame, bench_params, fusion_params, run_benchmark,
    run_fusion_benchmark)
from dynfu_tpu_torch.warp import field as wfield  # noqa: E402

DEV = torch.device("cuda")

# accuracy bounds, ~10% above the JAX reference's recorded figures
# (BENCH_r05.json, artifacts_r5_final.jsonl); accuracy does not depend on
# the chip. Parity 128^3: 10.084 / 15.139 mm; SE(3) fusion 512^3: warped
# 0.462, half-motion 0.384, canonical 1.447 mm.
MAX_ERR_MM = 11.0
MAX_ERR_3X_MM = 16.5
MAX_WARPED_MM = 0.51
MAX_WARPED_HALF_MM = 0.43
MAX_CANONICAL_MM = 1.60
JAX_FUSION = {"corr_dropped": 882, "n_band": 395036}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# row -> (wrapper, launch-counter key, plain, source, replaced TPU kernel)
KERNELS = {
    "pack_triangles": (mc_cuda.pack_triangles, None,
                       mc_cuda.pack_triangles_plain,
                       "dynfu_tpu_torch/csrc/pack_triangles.cu",
                       "dynfu_tpu/mesh/mc_pallas.py:69"),
    "knn_gather": (knn_cuda.knn_gather, None, knn_cuda.knn_gather_plain,
                   "dynfu_tpu_torch/csrc/knn.cu",
                   "dynfu_tpu/ops/knn_pallas.py:73"),
    "nn1_window_sweep": (corr_cuda.nn1_window_sweep, None,
                         corr_cuda.nn1_window_sweep_plain,
                         "dynfu_tpu_torch/csrc/corr.cu",
                         "dynfu_tpu/ops/corr_pallas.py:135"),
    "warp_fused": (warp_cuda.warp_fused, "dqb", warp_cuda.warp_fused_plain,
                   "dynfu_tpu_torch/csrc/warp.cu",
                   "dynfu_tpu/ops/warp_pallas.py:171"),
    "warp_fused_dlb": (warp_cuda.warp_fused, "dlb",
                       warp_cuda.warp_fused_plain,
                       "dynfu_tpu_torch/csrc/warp.cu",
                       "dynfu_tpu/ops/warp_pallas.py:171"),
    "data_normal": (gram_cuda.data_normal, None, gram_cuda.data_normal_plain,
                    "dynfu_tpu_torch/csrc/gram.cu",
                    "dynfu_tpu/solver/gram_pallas.py:85"),
    "monomial_grams": (gram_cuda.monomial_grams, None,
                       gram_cuda.monomial_grams_plain,
                       "dynfu_tpu_torch/csrc/mono_gram.cu",
                       "dynfu_tpu/solver/gram_pallas.py:184"),
}
PARITY_PATH = ("pack_triangles", "knn_gather", "nn1_window_sweep",
               "warp_fused", "data_normal")
FUSION_PATH = ("pack_triangles", "knn_gather", "warp_fused_dlb",
               "monomial_grams")


def launches(name: str) -> int:
    wrapper, key = KERNELS[name][:2]
    return wrapper.launches if key is None else wrapper.launches[key]


def reset_counters() -> None:
    for wrapper, key, plain, _, _ in KERNELS.values():
        if key is None:
            wrapper.launches = 0
        else:
            wrapper.launches[key] = 0
        plain.cuda_calls = 0


def plain_calls() -> dict:
    return {n: KERNELS[n][2].cuda_calls for n in KERNELS}


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Device time per call of every kernel fn() launches (memsets
    included), from torch.profiler; None if the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else None


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, "bytes" or "operations")."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- inputs ---------------------------------------------------------------


def perturbed(wf, rng, rot=0.02, trans=0.01):
    """The field with every active node rotated and moved a little (so the
    blends differ from the identity) and a third of the node DQs negated
    (the same transforms; the DLB's sign alignment must undo it)."""
    D = wf.capacity
    r = torch.as_tensor(rng.normal(0, rot, (D, 3)), dtype=torch.float32,
                        device=DEV)
    t = torch.as_tensor(rng.normal(0, trans, (D, 3)), dtype=torch.float32,
                        device=DEV)
    dqs = dq.dq_mul(dq.dq_from_rodrigues(r, t), wf.dqs)
    sign = torch.as_tensor(np.where(rng.random(D) < 0.33, -1.0, 1.0),
                           dtype=torch.float32, device=DEV)
    dqs = torch.where(wf.mask[:, None], dqs * sign[:, None], wf.dqs)
    return wf._replace(dqs=dqs.contiguous())


def parity_state():
    """Frame 0 of the 128^3 parity slice: its unique canonical vertices and
    its nodes (moved) are the k-NN and DQB warp kernels' real inputs."""
    eng = DynFusion(bench_params(128), device=DEV)
    eng(bench_frame(0))
    rng = np.random.default_rng(1)
    wf = eng.warpfield
    t = torch.as_tensor(rng.normal(0, 0.01, (wf.capacity, 3)),
                        dtype=torch.float32, device=DEV)
    wf = wfield.compose_translations(wf, torch.where(wf.mask[:, None], t, 0.0))
    return eng.canonical.vertices.contiguous(), wf


def fusion_state(Q=1 << 19):
    """Frame 0 of the 512^3 SE(3) fusion slice: the dilated band of its
    volume (the warped integration's queries, padded to Q = 2^19 with
    seeded points near the surface), its unique canonical vertices and its
    640-slot field, rotated."""
    eng = DynFusion(fusion_params(512, rotations=True), device=DEV,
                    mode="fusion")
    eng(bench_frame(0))
    cfg = eng.tsdf_config
    X, Y, Z = cfg.dims
    band = (eng.vol.weight > 0) & (eng.vol.tsdf < 1.0)
    band = compaction.dilate_xy(compaction.dilate_z(band, 2), 2)
    flat, n_band, _ = compaction.extract_bits(
        band.reshape(X * Y, Z), max_out=Q, row_stride=Z, fill=X * Y * Z,
        max_words=X * Y * (Z // 32))
    flat = flat[flat < X * Y * Z]
    vx = torch.div(flat, Y * Z, rounding_mode="floor")
    vy = torch.div(flat - vx * Y * Z, Z, rounding_mode="floor")
    vz = flat - vx * Y * Z - vy * Z
    vs = torch.as_tensor(cfg.voxel_size, dtype=torch.float32, device=DEV)
    pts = torch.stack([vx, vy, vz], -1).to(torch.float32) * vs
    rng = np.random.default_rng(2)
    c = eng.canonical
    verts = c.vertices[c.mask]
    if pts.shape[0] < Q:
        pick = torch.as_tensor(rng.integers(0, verts.shape[0],
                                            Q - pts.shape[0]), device=DEV)
        noise = torch.as_tensor(rng.normal(0, 0.02, (Q - pts.shape[0], 3)),
                                dtype=torch.float32, device=DEV)
        pts = torch.cat([pts, verts[pick] + noise])
    normals = torch.as_tensor(rng.normal(size=(Q, 3)), dtype=torch.float32,
                              device=DEV)
    normals = normals / torch.linalg.vector_norm(normals, dim=-1,
                                                 keepdim=True)
    print(f"fusion frame 0: band {int(n_band)} voxels, "
          f"{verts.shape[0]} canonical vertices, "
          f"{int(eng.warpfield.count)} nodes", flush=True)
    return (pts.contiguous(), normals.contiguous(), c.vertices, c.mask,
            perturbed(eng.warpfield, rng))


def gram_work(idx, s2, D, per_pair, per_slot):
    """Operations the Gram kernels do on these inputs: rows with s2 = 0 and
    padded slots add nothing."""
    ok = (idx >= 0) & (idx < D) & (s2[:, None] > 0)
    n = ok.sum(1).double()
    return float((n * n).sum()) * per_pair + float(n.sum()) * per_slot


def kernel_cases(verts, wf, fstate):
    """name -> (args, compare(kernel_out, plain_out) -> max_abs_err,
    tolerance text, (bytes, flops), library call or None)."""
    rng = np.random.default_rng(0)
    cases = {}

    # pack: 8192 cells (max_mc_voxels) into 10922 rows (max_vertices // 3)
    M, max_tris = 8192, (1 << 15) // 3
    k = rng.choice(6, M, p=[0.3, 0.3, 0.2, 0.1, 0.05, 0.05]).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int32)
    tris = rng.random((M, 5, 9), dtype=np.float32)
    tris[np.arange(5)[None, :] >= k[:, None]] = 0.0
    pa = (torch.as_tensor(tris, device=DEV), torch.as_tensor(offs, device=DEV),
          torch.as_tensor(k, device=DEV), max_tris)
    rows = torch.as_tensor(np.arange(5)[None, :] < k[:, None],
                           device=DEV).reshape(-1)
    flat_tris = pa[0].reshape(M * 5, 9)

    def cmp_exact(a, b):
        err = max_abs(a, b)
        require(err == 0.0, "pack_triangles differs from its plain version")
        return err
    cases["pack_triangles"] = (
        pa, cmp_exact, "exact", (M * 45 * 4 + 2 * M * 4 + max_tris * 36, 0),
        # the same rows compacted in order by one boolean index
        lambda: flat_tris[rows])

    # k-NN: the 128^3 canonical's unique vertices against its 256 nodes
    table = wfield.node_table(wf)
    ka = (verts, wf.pos, 8, table, wf.mask)
    Q, D, F = verts.shape[0], wf.capacity, table.shape[1]
    n_act = int(wf.mask.sum())

    def cmp_knn(a, b):
        require(torch.equal(a[0], b[0]), "knn_gather selections differ")
        err = max(max_abs(a[1], b[1]), max_abs(a[2], b[2]))
        require(err == 0.0, "knn_gather distances or features differ")
        return err
    cases["knn_gather"] = (
        ka, cmp_knn, "selections and values exact",
        (Q * 12 + D * (12 + 1 + F * 4) + Q * 8 * (8 + F * 4), Q * n_act * 8),
        None)

    # windowed 1-NN: Q = P = 32768 points on a 0.5 m sphere, F = 22
    P = 32768
    u = rng.normal(size=(P, 3))
    pts = 0.5 * u / np.linalg.norm(u, axis=1, keepdims=True)
    pts = pts[np.argsort(pts[:, 0], kind="stable")].astype(np.float32)
    qs = (pts + rng.normal(0, 0.002, pts.shape)).astype(np.float32)
    payload = torch.as_tensor(rng.random((P, 22), dtype=np.float32),
                              device=DEV)
    qsP, psP, lo_el, pre, suf, W = knn.window_placement(
        torch.as_tensor(qs, device=DEV), torch.as_tensor(pts, device=DEV),
        4096)
    payP = torch.cat([payload, payload.new_zeros((psP.shape[0] - P, 22))])
    ca = (qsP, psP, lo_el, pre, suf, 2048, W, payP)
    valid = (psP[:, 0] < corr_cuda.BIG_X).to(torch.int64)
    scanned = sum(int(valid[lo:lo + W].sum()) for lo in lo_el.tolist())

    def cmp_corr(a, b):
        require(torch.equal(a[1], b[1]),
                "nn1_window_sweep certificates differ")
        err = max_abs(a[0], b[0])
        require(err == 0.0, "nn1_window_sweep fetched rows differ")
        return err
    Qp, Pp = qsP.shape[0], psP.shape[0]
    cases["nn1_window_sweep"] = (
        ca, cmp_corr, "selections and rows exact",
        (Qp * 12 + Pp * (12 + 88) + lo_el.numel() * 12 + Qp * (88 + 1),
         scanned * 2048 * 8), None)

    def warp_bound(Q, wf, k=8):
        # the whole node table is read once; distances are needed only to
        # the active nodes (masked slots sit at FAR and are never picked
        # while k nodes are valid)
        n = int(wf.mask.sum())
        return (Q * 24 + wf.capacity * 49 + Q * 60, Q * (8 * n + 40 * k + 60))

    # DQB warp: the 128^3 canonical through its moved field
    wa = (verts, verts, wf.pos, wf.dqs, wf.w, wf.mask, 8, "dqb")

    def cmp_warp(a, b):
        err = max(max_abs(x, y) for x, y in zip(a, b))
        require(err <= 1e-6, f"warp_fused differs by {err} (> 1e-6)")
        return err
    cases["warp_fused"] = (wa, cmp_warp, "<= 1e-6 absolute",
                           warp_bound(verts.shape[0], wf), None)

    # DLB warp: the 512^3 fusion band (Q = 2^19) through 640 rotated nodes
    bpts, bnrm, fverts, fmask, fwf = fstate
    da = (bpts, bnrm, fwf.pos, fwf.dqs, fwf.w, fwf.mask, 8, "dlb")

    def cmp_dlb(a, b):
        require(torch.equal(a[3], b[3]), "warp_fused dlb ratios differ "
                "(selections)")
        err = max(max_abs(x, y) for x, y in zip(a, b))
        require(err <= 1e-5, f"warp_fused dlb differs by {err} (> 1e-5)")
        return err
    cases["warp_fused_dlb"] = (da, cmp_dlb,
                               "ratio exact (selections), <= 1e-5 absolute",
                               warp_bound(bpts.shape[0], fwf), None)

    # Gram: N = 32768 rows (max_vertices), K = 8, D = 256
    N, K, D = 1 << 15, 8, 256
    idx = np.argsort(rng.random((N, D)), axis=1)[:, :K]  # distinct per row
    w = rng.random((N, K), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[rng.random(N) < 0.3] = 0.0
    delta = (rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    ga = (torch.as_tensor(idx.astype(np.int32), device=DEV),
          torch.as_tensor(w, device=DEV), torch.as_tensor(s2, device=DEV),
          torch.as_tensor(delta, device=DEV), D)
    Wd = torch.zeros((N, D), device=DEV)
    Wd.scatter_(1, ga[0].long(), ga[1])
    sWT = (ga[2][:, None] * Wd).T.contiguous()

    def cmp_gram(a, b):
        ea = max_abs(a[0], b[0]) / float(b[0].abs().max())
        eb = max_abs(a[1], b[1]) / float(b[1].abs().max())
        # float32 atomics sum in a varying order: relative tolerance
        require(max(ea, eb) <= 1e-5, f"data_normal relative error {ea}, {eb}")
        return max_abs(a[0], b[0])
    cases["data_normal"] = (
        ga, cmp_gram, "<= 1e-5 relative to max |A|, |b|",
        (N * K * 8 + N * 16 + D * D * 4 + D * 12,
         gram_work(ga[0], ga[2], D, 2, 7)),
        # the dense route: A = (s2 W)^T W, one float32 matmul
        lambda: torch.matmul(sWT, Wd))

    # monomial Grams: N = 65536 rows of the 512^3 canonical (invalid rows
    # carry s2 = 0), their 8 nearest of the 640 nodes with normalised
    # Gaussian weights, K = 8, D = 640
    D = fwf.capacity
    midx, _, n_pos, _, n_w, n_valid = wfield.neighbor_features(fwf, fverts)
    mw = torch.where(n_valid, wfield.transformation_weights(
        n_pos, n_w, fverts[:, None, :]), 0.0)
    mw = (mw / torch.clamp_min(mw.sum(-1, keepdim=True), 1e-12)).contiguous()
    N = fverts.shape[0]
    ms2 = rng.random(N, dtype=np.float32)
    ms2[rng.random(N) < 0.3] = 0.0
    ms2 = torch.where(fmask, torch.as_tensor(ms2, device=DEV), 0.0)
    y = (fverts - fverts[fmask].mean(0)).contiguous()
    mdelta = torch.as_tensor(rng.normal(0, 0.002, (N, 3)),
                             dtype=torch.float32, device=DEV)
    ma = (midx, mw, ms2.contiguous(), y, mdelta, D)
    Ws = torch.zeros((N, D), device=DEV)
    Ws.scatter_add_(1, midx.long(), torch.sqrt(ms2)[:, None] * mw)
    monos = gram_cuda.monomials(y)  # (10, N)
    MsT = (Ws[None] * monos[:, :, None]).transpose(1, 2).contiguous()

    def cmp_mono(a, b):
        errs = [max_abs(x, z) / max(float(z.abs().max()), 1e-30)
                for x, z in zip(a, b)]
        # float32 atomics sum in a varying order: relative tolerance
        require(max(errs) <= 1e-5, f"monomial_grams relative errors {errs}")
        return max(max_abs(x, z) for x, z in zip(a, b))
    cases["monomial_grams"] = (
        ma, cmp_mono, "<= 1e-5 relative to max |B|, |Bu|, |Bw|",
        (N * K * 8 + N * 28 + 10 * D * D * 4 + D * 24,
         gram_work(midx, ms2, D, 22, 19)),
        # the dense route: ten monomial-scaled strips against the strip,
        # one batched float32 matmul (~537 GFLOP)
        lambda: torch.matmul(MsT, Ws))
    return cases


def kernel_phase():
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for float32 matmuls")
    verts, wf = parity_state()
    fstate = fusion_state()
    rows = {}
    for name, (args, compare, tol, work, library) in kernel_cases(
            verts, wf, fstate).items():
        kern, plain = KERNELS[name][0], KERNELS[name][2]
        out_k = kern(*args)
        torch.cuda.synchronize()
        out_p = plain(*args)
        torch.cuda.synchronize()
        err = compare(out_k, out_p)
        del out_k, out_p
        ms = cuda_ms(lambda: kern(*args))
        dev_ms = device_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
        lib_ms = None if library is None else cuda_ms(library, iters=5)
        b_ms, b_by = bound_ms(*work)
        print(f"kernel {name}: max_abs_err {err} ({tol}); {ms:.4f} ms "
              f"(events), {dev_ms} ms (device), plain {plain_ms:.4f} ms, "
              f"library {lib_ms} ms, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
        rows[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        torch.cuda.empty_cache()
    return rows


# --- small inputs: card against CPU ----------------------------------------


def _small_params(**kw):
    import dataclasses

    from dynfu_tpu_torch.core.camera import Intr
    from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams

    H, W = 96, 128
    intr = Intr(140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(cols=W, rows=H, intr=intr, volume_dims=(64,) * 3,
                          volume_size=(1.0,) * 3,
                          volume_pose_t=(-0.5, -0.5, 0.25),
                          tsdf_trunc_dist=0.03),
        max_nodes=512, max_vertices=3 * 4096, max_mc_voxels=1 << 13,
        max_new_nodes=256, node_sample_step=32)
    return dataclasses.replace(params, **kw), intr


def _small_frames(intr, step):
    from dynfu_tpu_torch.io.datasets import sphere_depth

    return [sphere_depth((step * i, 0.0, 0.75), 0.22, 96, 128, 140.0, 140.0,
                         intr.cx, intr.cy) for i in range(3)]


def small_input_check():
    """Three frames of a 64^3 sphere scene in parity mode on the card and
    on the CPU."""
    params, intr = _small_params()
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DynFusion(params, device=dev)
        for d in _small_frames(intr, 0.005):
            eng(d)
        v, m = eng.warped_cloud(unique=True)
        out[dev] = (v.cpu(), m.cpu(), int(eng.warpfield.count))
    (vg, mg, ng), (vc, mc, nc) = out["cuda"], out["cpu"]
    require(torch.isfinite(vg[mg]).all(), "non-finite warped vertices")
    require(torch.equal(mg, mc) and ng == nc, "card and CPU node sets differ")
    err = float((vg - vc)[mg].abs().max())
    # f32 roundoff of the Gram atomics and of the card's exp/sqrt through
    # three solves: well under a tenth of a millimetre
    require(err <= 1e-4, f"card vs CPU warped cloud differs by {err} m")
    print(f"small-input check (parity): card vs CPU max |dv| {err:.3g} m, "
          f"{ng} nodes", flush=True)


def small_fusion_check():
    """Three frames of a 64^3 sphere scene in SE(3) fusion mode with unique
    edges, on the card and on the CPU. The canonical is re-extracted from
    the integrated volume every frame, so a voxel at a support or cosine
    boundary (the card's float32 exp and sqrt differ from the CPU's by an
    ulp) can add or drop an edge vertex: the check matches each card vertex
    to its nearest CPU vertex."""
    params, intr = _small_params(
        solver_rotations=True, corr_unique_edges=True, max_edge_verts=1 << 13,
        edge_col_budget=8, max_nodes=128, fusion_max_active=1 << 14,
        se3_relinearize=2)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DynFusion(params, device=dev, mode="fusion")
        for d in _small_frames(intr, 0.004):
            eng(d)
        v, m = eng.warped_cloud()
        fs = eng.last_frame_stats
        out[dev] = (v[m].cpu(), int(eng.warpfield.count), int(fs.mc_dropped),
                    int(fs.band.n_band), int(fs.band.n_captured))
    (vg, ng, dg, bg, cg), (vc, nc, dc, bc, cc) = out["cuda"], out["cpu"]
    require(torch.isfinite(vg).all(), "non-finite warped vertices")
    require(ng == nc and dg == dc == 0 and cg == bg and cc == bc,
            f"card and CPU differ: nodes {ng}/{nc}, drops {dg}/{dc}, "
            f"band {cg}/{bg} vs {cc}/{bc}")
    require(abs(vg.shape[0] - vc.shape[0]) <= 0.01 * vc.shape[0],
            f"canonical sizes differ: {vg.shape[0]} vs {vc.shape[0]}")
    nn = torch.cdist(vg.double(), vc.double()).min(1).values
    frac = float((nn <= 1e-4).double().mean())
    # float32 roundoff through three solves and integrations: 99 % of the
    # vertices within a tenth of a millimetre of the CPU's
    require(frac >= 0.99, f"only {frac:.4f} of card vertices within 0.1 mm")
    print(f"small-input check (fusion): {vg.shape[0]} / {vc.shape[0]} "
          f"canonical vertices, {frac:.4f} within 0.1 mm of the CPU's "
          f"(median {float(nn.median()):.3g} m), {ng} nodes", flush=True)


# --- the main paths --------------------------------------------------------


def parity_phase():
    reset_counters()
    res = run_benchmark(volume_dims=128, repeats=3, device=DEV)
    got = {n: launches(n) for n in KERNELS}
    plain = plain_calls()
    print("slice:", json.dumps(res), flush=True)
    print("slice launches:", json.dumps(got), flush=True)
    require(res["mc_dropped_cells"] == 0, "mc_dropped_cells != 0")
    require(res["corr_dropped"] == 0, "corr_dropped != 0")
    require(res["median_vertex_err_mm"] <= MAX_ERR_MM,
            f"median_vertex_err_mm {res['median_vertex_err_mm']} > "
            f"{MAX_ERR_MM}")
    require(res["err_after_3x_motion_mm"] <= MAX_ERR_3X_MM,
            f"err_after_3x_motion_mm {res['err_after_3x_motion_mm']} > "
            f"{MAX_ERR_3X_MM}")
    require(all(got[n] > 0 for n in PARITY_PATH),
            f"a kernel never launched on the parity path: {got}")
    require(not any(plain.values()),
            f"a plain version ran on a CUDA tensor: {plain}")
    return got


def fusion_phase():
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    res = run_fusion_benchmark(volume_dims=512, rotations=True, device=DEV)
    got = {n: launches(n) for n in KERNELS}
    plain = plain_calls()
    print("fusion:", json.dumps(res), flush=True)
    print("fusion launches:", json.dumps(got), flush=True)
    print(f"fusion: frame_ms {res['frame_ms']}, corr_dropped "
          f"{res['corr_dropped']} (JAX reference {JAX_FUSION['corr_dropped']}"
          f"), n_band {res['n_band']} (JAX reference {JAX_FUSION['n_band']}),"
          f" max_memory_allocated {torch.cuda.max_memory_allocated()} B",
          flush=True)
    require(res["mc_dropped"] == 0, "fusion: edges dropped")
    require(res["n_captured"] == res["n_band"], "fusion: band overflow")
    for key, bound in (("warped_err_mm", MAX_WARPED_MM),
                       ("warped_err_half_motion_mm", MAX_WARPED_HALF_MM),
                       ("canonical_err_mm", MAX_CANONICAL_MM)):
        require(res[key] <= bound, f"fusion: {key} {res[key]} > {bound}")
    require(all(got[n] > 0 for n in FUSION_PATH),
            f"a kernel never launched on the fusion path: {got}")
    require(not any(plain.values()),
            f"a plain version ran on a CUDA tensor: {plain}")
    return got


def main() -> int:
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    phases = [("kernel build", lambda: kernels.build()),
              ("kernel phase", kernel_phase),
              ("small-input check (parity)", small_input_check),
              ("small-input check (fusion)", small_fusion_check),
              ("parity slice", parity_phase),
              ("fusion slice", fusion_phase)]
    out = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    rows, par, fus = (out["kernel phase"], out["parity slice"],
                      out["fusion slice"])
    table = {"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][3],
         "replaces": KERNELS[n][4], "launches": par[n] + fus[n],
         "launches_parity": par[n], "launches_fusion": fus[n], **rows[n]}
        for n in KERNELS]}
    print(json.dumps(table))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
