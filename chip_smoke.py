#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from dynfu_tpu_torch/csrc (one nvcc
   per source, all started together);
3. kernel phase: runs each kernel and its plain PyTorch version on the
   card on the same inputs, at the shapes of the path that runs it — the
   128^3 parity slice's pack, k-NN, windowed 1-NN, DQB warp and Gram
   kernels, the 512^3 SE(3) fusion slice's DLB warp (Q = 524288 band
   points, D = 640 nodes of a real frame 0, rotated) and monomial Grams
   (N = 65536, K = 8, D = 640), and the 512^3 rigid slice's stencil fetch
   (frame 1's pyramid against frame 0's raycast, the first ICP iteration's
   indices, at levels 0, 1 and 2: 480x640 with R = 2, 240x320 with R = 3,
   120x160 with R = 4) — checks that they agree (selections and the
   stencil exactly, NaN positions included; floats within the stated
   tolerance) and times each: CUDA events over back-to-back calls (ms), the
   profiler's device time per call (device_ms), the plain version
   (plain_ms) and, where one PyTorch call computes the same function, that
   call (library_ms); bound_ms is the least time the card could take (the
   larger of the bytes over 3.35 TB/s and the operations over 67 TFLOP/s
   of float32), from this run's inputs;
4. small-input checks: three frames of a 64^3 scene in parity mode, in
   SE(3) fusion mode and through rigid KinFu (120x160) on the card, each
   against the same engine on the CPU;
5. the main paths, each with every launch counter zeroed just before it and
   read just after, each requiring its kernels launched and no plain
   version run on a CUDA tensor; after each, every kernel the path launched
   is held against its plain version, with the tolerances above, at the
   path's own largest call (its arguments captured during the run; these
   checks are listed under "at_paths" in each kernel's row):
   - parity 128^3: run_benchmark(128, repeats=3); zero drops, the accuracy
     bounds;
   - SE(3) fusion 512^3: run_fusion_benchmark(512, rotations=True); no
     dropped edges, the whole band captured, the accuracy bounds;
   - rigid 512^3: run_rigid_benchmark(512); 12 ICPs x 19 stencil launches,
     no reset, the ATE bound;
   - parity 512^3: run_benchmark(512, repeats=3) (unique edge vertices);
     zero drops, the accuracy bounds;
   - moving-camera SE(3) fusion 512^3: run_fusion_benchmark(512,
     rotations=True, camera_motion=0.002); 14 ICPs x 19 stencil launches,
     the whole band captured, the accuracy bounds;
   - the same with similarity_reg=True (the SE(3) solve marginalises a
     global scale), under the same checks.

Prints each phase's seconds, the kernels' JSON line, the card's line, then
as its last line the device JSON. Any failed check raises, and the script
exits non-zero without that line. It needs CUDA: without a card it exits 1
before doing anything.
"""

import inspect
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
from dynfu_tpu_torch.core.camera import Intr  # noqa: E402
from dynfu_tpu_torch.engine.dynfusion import DynFusion  # noqa: E402
from dynfu_tpu_torch.engine.kinfu import KinFu  # noqa: E402
from dynfu_tpu_torch.engine.params import KinFuParams  # noqa: E402
from dynfu_tpu_torch.mesh import mc_cuda  # noqa: E402
from dynfu_tpu_torch.ops import (compaction, corr_cuda, knn,  # noqa: E402
                                 knn_cuda, stencil_cuda, warp_cuda)
from dynfu_tpu_torch.rigid import icp  # noqa: E402
from dynfu_tpu_torch.solver import gram_cuda  # noqa: E402
from dynfu_tpu_torch.utils.benchmarks import (  # noqa: E402
    bench_frame, bench_params, fusion_params, rigid_frame, rigid_params,
    run_benchmark, run_fusion_benchmark, run_rigid_benchmark, spheres_depth)
from dynfu_tpu_torch.volume import tsdf as tv  # noqa: E402
from dynfu_tpu_torch.warp import field as wfield  # noqa: E402

DEV = torch.device("cuda")

# accuracy bounds, ~10% above the JAX reference's recorded figures
# (BENCH_r05.json, artifacts_r5_final.jsonl); accuracy does not depend on
# the chip. Parity 128^3: 10.084 / 15.139 mm; SE(3) fusion 512^3: warped
# 0.462, half-motion 0.384, canonical 1.447 mm; rigid 512^3 (row
# rigid_512_stencil): ATE 4.73 mm; parity 512^3: 2.166 / 6.332 mm;
# moving-camera SE(3) fusion 512^3 (row fusion_512_se3_movingcam): warped
# 6.519, half-motion 10.761, canonical 1.489 mm.
MAX_ERR_MM = 11.0
MAX_ERR_3X_MM = 16.5
MAX_WARPED_MM = 0.51
MAX_WARPED_HALF_MM = 0.43
MAX_CANONICAL_MM = 1.60
JAX_FUSION = {"corr_dropped": 882, "n_band": 395036}
MAX_ATE_MM = 5.2
MAX_ERR512_MM = 2.40
MAX_ERR512_3X_MM = 7.0
MAX_MC_WARPED_MM = 7.2
MAX_MC_WARPED_HALF_MM = 11.9
MAX_MC_CANONICAL_MM = 1.64
JAX_MOVINGCAM = {"corr_dropped": 5956, "n_band": 904051}
# row fusion_512_se3_movingcam_simreg: 6.521 / 10.76 / 1.49 mm, under the
# moving camera's bounds
JAX_SIMREG = {"corr_dropped": 5939, "n_band": 904015}
# stencil fetches per ICP: one per iteration of the default schedule
STENCIL_PER_ICP = sum(KinFuParams().icp_iter_num)

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
    "fetch_stencil": (stencil_cuda.fetch_stencil, None,
                      stencil_cuda.fetch_stencil_plain,
                      "dynfu_tpu_torch/csrc/stencil.cu",
                      "dynfu_tpu/ops/stencil_pallas.py:52"),
}
# the one PyTorch call timed as library_ms, where there is one (it computes
# the same function; the stencil's is the fetch without the window mask)
LIBRARY = {
    "pack_triangles": "boolean-index compaction of the triangle rows",
    "data_normal": "torch.matmul of the dense (s2 W)^T and W",
    "monomial_grams": "batched torch.matmul of the monomial-scaled strips",
    "fetch_stencil": "img[vi, ui]: the same fetch without the window mask",
}
# main path -> the kernels it must launch
PATHS = {
    "parity128": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                  "warp_fused", "data_normal"),
    "fusion": ("pack_triangles", "knn_gather", "warp_fused_dlb",
               "monomial_grams"),
    "rigid": ("fetch_stencil",),
    "parity512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                  "warp_fused", "data_normal"),
    "movingcam": ("pack_triangles", "knn_gather", "warp_fused_dlb",
                  "monomial_grams", "fetch_stencil"),
    "movingcam_simreg": ("pack_triangles", "knn_gather", "warp_fused_dlb",
                         "monomial_grams", "fetch_stencil"),
}


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


def rigid_state():
    """The stencil kernel's inputs on the 512^3 rigid slice: frame 0
    integrated by the engine, its raycast pyramid at pose 0 (the reference),
    frame 1's depth pyramid (the current frame) and, per level, the
    association's clipped indices at the identity pose of the first ICP
    iteration. Returns [(level, (img, vi, ui, radius))] for levels 0-2."""
    eng = KinFu(rigid_params(512), device=DEV)
    eng(rigid_frame(0))
    p = eng.params
    pts, nrm = tv.raycast(eng.vol, eng.poses[-1], p.intr, (p.rows, p.cols),
                          eng.tsdf_config)
    prev = icp.build_pyramids(pts, nrm, eng.levels)
    _, curr = eng._preprocess(eng._depth(rigid_frame(1)))
    out = []
    for level in (0, 1, 2):
        vcurr = curr[level][0]
        H, W = vcurr.shape[:2]
        vi, ui, _, _, _ = icp._project(vcurr, p.intr.level(level), H, W)
        img = torch.cat(prev[level], -1).contiguous()
        out.append((level, (img, vi, ui, p.icp_stencil_radii[level])))
    return out


def cmp_exact(name):
    def cmp(a, b):
        err = max_abs(a, b)
        require(err == 0.0, f"{name} differs from its plain version")
        return err
    return cmp


def pack_case(args):
    """The cells' triangles, offsets and counts in, the stream out; the
    library call compacts the same rows in order by one boolean index."""
    tris, _, n_tris, max_tris = args
    M = tris.shape[0]
    rows = (torch.arange(5, device=DEV)[None, :]
            < n_tris[:, None]).reshape(-1)
    flat = tris.reshape(M * 5, 9)
    return (args, cmp_exact("pack_triangles"), "exact",
            (M * 45 * 4 + 2 * M * 4 + max_tris * 36, 0), lambda: flat[rows])


def knn_case(args):
    """Distances are needed only to the active nodes."""
    q, pts, k, table, mask = args
    Q, D, F = q.shape[0], pts.shape[0], table.shape[1]
    n_act = int(mask.sum())

    def cmp_knn(a, b):
        require(torch.equal(a[0], b[0]), "knn_gather selections differ")
        err = max(max_abs(a[1], b[1]), max_abs(a[2], b[2]))
        require(err == 0.0, "knn_gather distances or features differ")
        return err
    return (args, cmp_knn, "selections and values exact",
            (Q * 12 + D * (12 + 1 + F * 4) + Q * k * (8 + F * 4),
             Q * n_act * 8), None)


def corr_case(args):
    """Each query tile scans the valid points of its window."""
    qs, ps, lo_el, _, _, tq, W, payload = args
    Qp, Pp, F = qs.shape[0], ps.shape[0], payload.shape[1]
    valid = (ps[:, 0] < corr_cuda.BIG_X).to(torch.int64)
    cs = torch.cat([valid.new_zeros(1), valid.cumsum(0)])
    lo = lo_el.long()
    scanned = int((cs[torch.clamp(lo + W, max=Pp)] - cs[lo]).sum())

    def cmp_corr(a, b):
        require(torch.equal(a[1], b[1]),
                "nn1_window_sweep certificates differ")
        err = max_abs(a[0], b[0])
        require(err == 0.0, "nn1_window_sweep fetched rows differ")
        return err
    return (args, cmp_corr, "selections and rows exact",
            (Qp * 12 + Pp * (12 + 4 * F) + lo_el.numel() * 12
             + Qp * (4 * F + 1), scanned * tq * 8), None)


def warp_case(args):
    """The whole node table is read once; distances are needed only to the
    active nodes (masked slots sit at FAR and are never picked while k nodes
    are valid)."""
    q, _, pos, _, _, mask, k, blend = args
    Q, n = q.shape[0], int(mask.sum())
    work = (Q * 24 + pos.shape[0] * 49 + Q * 60, Q * (8 * n + 40 * k + 60))

    def cmp_dqb(a, b):
        err = max(max_abs(x, y) for x, y in zip(a, b))
        require(err <= 1e-6, f"warp_fused differs by {err} (> 1e-6)")
        return err

    def cmp_dlb(a, b):
        require(torch.equal(a[3], b[3]), "warp_fused dlb ratios differ "
                "(selections)")
        err = max(max_abs(x, y) for x, y in zip(a, b))
        require(err <= 1e-5, f"warp_fused dlb differs by {err} (> 1e-5)")
        return err
    if blend == "dlb":
        return (args, cmp_dlb, "ratio exact (selections), <= 1e-5 absolute",
                work, None)
    return args, cmp_dqb, "<= 1e-6 absolute", work, None


def dense_strip(idx, w, D):
    """(N, D) float32: row r holds w[r, j] at column idx[r, j]; indices
    outside [0, D) are padding."""
    ok = (idx >= 0) & (idx < D)
    out = torch.zeros((idx.shape[0], D), device=DEV)
    out.scatter_add_(1, torch.where(ok, idx, 0).long(),
                     torch.where(ok, w, 0.0))
    return out


def gram_work(idx, s2, D, per_pair, per_slot):
    """Operations the Gram kernels do on these inputs: rows with s2 = 0 and
    padded slots add nothing."""
    ok = (idx >= 0) & (idx < D) & (s2[:, None] > 0)
    n = ok.sum(1).double()
    return float((n * n).sum()) * per_pair + float(n.sum()) * per_slot


def gram_case(args):
    """The library call is the dense route: A = (s2 W)^T W, one float32
    matmul."""
    idx, w, s2, _, D = args
    N, K = idx.shape
    Wd = dense_strip(idx, w, D)
    sWT = (s2[:, None] * Wd).T.contiguous()

    def cmp_gram(a, b):
        ea = max_abs(a[0], b[0]) / max(float(b[0].abs().max()), 1e-30)
        eb = max_abs(a[1], b[1]) / max(float(b[1].abs().max()), 1e-30)
        # float32 atomics sum in a varying order: relative tolerance
        require(max(ea, eb) <= 1e-5, f"data_normal relative error {ea}, {eb}")
        return max_abs(a[0], b[0])
    return (args, cmp_gram, "<= 1e-5 relative to max |A|, |b|",
            (N * K * 8 + N * 16 + D * D * 4 + D * 12,
             gram_work(idx, s2, D, 2, 7)),
            lambda: torch.matmul(sWT, Wd))


def mono_case(args):
    """The library call is the dense route: the ten monomial-scaled strips
    against the strip, one batched float32 matmul."""
    idx, w, s2, y, _, D = args
    N, K = idx.shape
    Ws = dense_strip(idx, torch.sqrt(torch.clamp_min(s2, 0.0))[:, None] * w,
                     D)
    monos = gram_cuda.monomials(y)  # (10, N)
    MsT = (Ws[None] * monos[:, :, None]).transpose(1, 2).contiguous()

    def cmp_mono(a, b):
        errs = [max_abs(x, z) / max(float(z.abs().max()), 1e-30)
                for x, z in zip(a, b)]
        # float32 atomics sum in a varying order: relative tolerance
        require(max(errs) <= 1e-5, f"monomial_grams relative errors {errs}")
        return max(max_abs(x, z) for x, z in zip(a, b))
    return (args, cmp_mono, "<= 1e-5 relative to max |B|, |Bu|, |Bw|",
            (N * K * 8 + N * 28 + 10 * D * D * 4 + D * 24,
             gram_work(idx, s2, D, 22, 19)),
            lambda: torch.matmul(MsT, Ws))


def stencil_case(args):
    """The indices in, the gathered rows in and the output out (no
    arithmetic); the library call is the same fetch without the window
    mask, img[vi, ui]."""
    img, vi, ui, _ = args
    H, W, C = img.shape
    vil, uil = vi.long(), ui.long()

    def cmp_stencil(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        require(torch.equal(na, nb), "fetch_stencil NaN positions differ")
        err = max_abs(a[~na], b[~nb])
        require(err == 0.0, "fetch_stencil values differ")
        return err
    return (args, cmp_stencil, "exact, NaN positions included",
            (H * W * (8 + 2 * 4 * C), 0), lambda: img[vil, uil])


# row -> its case: (args, compare(kernel_out, plain_out) -> max_abs_err,
# tolerance text, (bytes, flops), library call or None)
CASES = {"pack_triangles": pack_case, "knn_gather": knn_case,
         "nn1_window_sweep": corr_case, "warp_fused": warp_case,
         "warp_fused_dlb": warp_case, "data_normal": gram_case,
         "monomial_grams": mono_case, "fetch_stencil": stencil_case}


def kernel_cases(verts, wf, fstate):
    """name -> case, at the shapes of the 128^3 parity and the 512^3 SE(3)
    fusion slices."""
    rng = np.random.default_rng(0)
    cases = {}

    # pack: 8192 cells (max_mc_voxels) into 10922 rows (max_vertices // 3)
    M, max_tris = 8192, (1 << 15) // 3
    k = rng.choice(6, M, p=[0.3, 0.3, 0.2, 0.1, 0.05, 0.05]).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int32)
    tris = rng.random((M, 5, 9), dtype=np.float32)
    tris[np.arange(5)[None, :] >= k[:, None]] = 0.0
    cases["pack_triangles"] = pack_case(
        (torch.as_tensor(tris, device=DEV), torch.as_tensor(offs, device=DEV),
         torch.as_tensor(k, device=DEV), max_tris))

    # k-NN: the 128^3 canonical's unique vertices against its 256 nodes
    cases["knn_gather"] = knn_case(
        (verts, wf.pos, 8, wfield.node_table(wf), wf.mask))

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
    cases["nn1_window_sweep"] = corr_case(
        (qsP, psP, lo_el, pre, suf, 2048, W, payP))

    # DQB warp: the 128^3 canonical through its moved field
    cases["warp_fused"] = warp_case(
        (verts, verts, wf.pos, wf.dqs, wf.w, wf.mask, 8, "dqb"))

    # DLB warp: the 512^3 fusion band (Q = 2^19) through 640 rotated nodes
    bpts, bnrm, fverts, fmask, fwf = fstate
    cases["warp_fused_dlb"] = warp_case(
        (bpts, bnrm, fwf.pos, fwf.dqs, fwf.w, fwf.mask, 8, "dlb"))

    # Gram: N = 32768 rows (max_vertices), K = 8, D = 256
    N, K, D = 1 << 15, 8, 256
    idx = np.argsort(rng.random((N, D)), axis=1)[:, :K]  # distinct per row
    w = rng.random((N, K), dtype=np.float32)
    s2 = rng.random(N, dtype=np.float32)
    s2[rng.random(N) < 0.3] = 0.0
    delta = (rng.normal(0, 0.01, (N, 3))).astype(np.float32)
    cases["data_normal"] = gram_case(
        (torch.as_tensor(idx.astype(np.int32), device=DEV),
         torch.as_tensor(w, device=DEV), torch.as_tensor(s2, device=DEV),
         torch.as_tensor(delta, device=DEV), D))

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
    cases["monomial_grams"] = mono_case(
        (midx, mw, ms2.contiguous(), y, mdelta, D))
    return cases


def measure(name, args, compare, tol, work, library) -> dict:
    """Compare the kernel with its plain version on `args` and time both
    (and the library call, if any)."""
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
          f"library {lib_ms} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def kernel_phase():
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for float32 matmuls")
    verts, wf = parity_state()
    fstate = fusion_state()
    rows = {name: measure(name, *case) for name, case in kernel_cases(
        verts, wf, fstate).items()}
    torch.cuda.empty_cache()
    # the stencil row is level 0; levels 1 and 2 ride along under "levels"
    levels = []
    for level, args in rigid_state():
        H, W = args[1].shape
        print(f"stencil level {level}: {H}x{W}, R = {args[3]}", flush=True)
        row = measure("fetch_stencil", *stencil_case(args))
        row.update(level=level, shape=[H, W], radius=args[3])
        levels.append(row)
    rows["fetch_stencil"] = dict(levels[0], levels=levels[1:])
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


def small_rigid_check():
    """Three frames of a 64^3 three-sphere scene at 120x160 through rigid
    KinFu (stencil ICP, per-voxel integrate, ray march) on the card and on
    the CPU; the camera moves (4, -2, 3) mm per frame."""
    import dataclasses

    intr = Intr(160.0, 160.0, 79.5, 59.5)
    params = dataclasses.replace(
        KinFuParams(), cols=160, rows=120, intr=intr, volume_dims=(64,) * 3,
        volume_size=(1.0,) * 3, volume_pose_t=(-0.5, -0.5, 0.25),
        tsdf_trunc_dist=0.03)
    scene = [((0.0, 0.0, 0.75), 0.22), ((0.28, 0.18, 0.85), 0.10),
             ((-0.25, -0.22, 0.9), 0.12)]
    frames = [spheres_depth(scene, np.asarray((0.004, -0.002, 0.003)) * i,
                            120, 160, f=160.0) for i in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = KinFu(params, device=dev)
        for d in frames:
            eng(d)
        require(eng.resets == 0 and len(eng.poses) == 3,
                f"rigid small input: reset on {dev}")
        out[dev] = eng.poses
    dt = max(float(np.abs(a[1] - b[1]).max())
             for a, b in zip(out["cuda"], out["cpu"]))
    dR = max(float(np.abs(a[0] - b[0]).max())
             for a, b in zip(out["cuda"], out["cpu"]))
    # float32 sums in another order on the card: a correspondence at a gate
    # or a window edge can flip, which moves the pose by ~1e-5
    require(dt <= 1e-3 and dR <= 1e-3,
            f"card vs CPU rigid poses differ: |dt| {dt}, |dR| {dR}")
    print(f"small-input check (rigid): card vs CPU max |dt| {dt:.3g} m, "
          f"max |dR| {dR:.3g}, final t {out['cuda'][-1][1].tolist()}",
          flush=True)


# --- the main paths --------------------------------------------------------


class Capture:
    """Around a main path: each wrapper's module attribute (the name every
    caller goes through) is replaced by a Shim that keeps, per kernel row,
    the arguments of the path's largest call (by the first argument's
    element count, the last of equal ones) and calls the wrapper. The
    arguments are kept by reference: the wrappers only read their
    inputs."""

    def __init__(self):
        self.calls = {}
        self.saved = []

    def __enter__(self):
        for wrapper in {v[0] for v in KERNELS.values()}:
            mod = sys.modules[wrapper.__module__]
            self.saved.append((mod, wrapper.__name__, wrapper))
            setattr(mod, wrapper.__name__, Shim(self.calls, wrapper))
        return self

    def __exit__(self, *exc):
        for mod, attr, wrapper in self.saved:
            setattr(mod, attr, wrapper)
        self.saved = []


class Shim:
    """A wrapper that records its calls. A wrapper counts its launches on
    its own module-level name, which is this Shim while it is installed:
    `launches` reads and writes the wrapper's counter."""

    def __init__(self, calls, wrapper):
        self.calls, self.wrapper = calls, wrapper
        self.sig = inspect.signature(wrapper)
        self.row = next(n for n, v in KERNELS.items() if v[0] is wrapper)

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, value):
        self.wrapper.launches = value

    def __call__(self, *a, **kw):
        bound = self.sig.bind(*a, **kw)
        bound.apply_defaults()
        args = bound.args
        name = ("warp_fused_dlb" if self.row == "warp_fused"
                and args[7] == "dlb" else self.row)
        size = args[0].numel()
        if size >= self.calls.get(name, (-1,))[0]:
            self.calls[name] = (size, args)
        return self.wrapper(*a, **kw)


# row -> [kernel against plain at each main path's largest call]
AT_PATHS = {n: [] for n in KERNELS}


def run_path(path: str, fn):
    """Run one main path with every counter zeroed just before it; require
    its kernels launched and no plain version run on a CUDA tensor. Then
    hold every kernel the path launched against its plain version at the
    path's own largest call (these launches come after the counts are
    read). Returns (result, launches per kernel)."""
    with Capture() as cap:
        reset_counters()
        res = fn()
        got = {n: launches(n) for n in KERNELS}
        plain = plain_calls()
    print(f"{path}:", json.dumps(res), flush=True)
    print(f"{path} launches:", json.dumps(got), flush=True)
    require(all(got[n] > 0 for n in PATHS[path]),
            f"a kernel never launched on the {path} path: {got}")
    require(not any(plain.values()),
            f"a plain version ran on a CUDA tensor on the {path} path: "
            f"{plain}")
    require(set(cap.calls) == {n for n in KERNELS if got[n]},
            f"{path}: captured {sorted(cap.calls)}, launched {got}")
    for name in sorted(cap.calls):
        args = cap.calls.pop(name)[1]
        shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
        print(f"{path}: {name} at its largest call, input shapes {shapes}",
              flush=True)
        row = measure(name, *CASES[name](args))
        AT_PATHS[name].append(dict(row, path=path, shapes=shapes))
        del args
    torch.cuda.empty_cache()
    return res, got


def parity_checks(res, max_err, max_err_3x):
    require(res["mc_dropped_cells"] == 0, "mc_dropped_cells != 0")
    require(res["corr_dropped"] == 0, "corr_dropped != 0")
    require(res["median_vertex_err_mm"] <= max_err,
            f"median_vertex_err_mm {res['median_vertex_err_mm']} > "
            f"{max_err}")
    require(res["err_after_3x_motion_mm"] <= max_err_3x,
            f"err_after_3x_motion_mm {res['err_after_3x_motion_mm']} > "
            f"{max_err_3x}")


def fusion_checks(res, bounds, jax_ref):
    print(f"fusion: frame_ms {res['frame_ms']}, corr_dropped "
          f"{res['corr_dropped']} (JAX reference {jax_ref['corr_dropped']}"
          f"), n_band {res['n_band']} (JAX reference {jax_ref['n_band']}),"
          f" max_memory_allocated {torch.cuda.max_memory_allocated()} B",
          flush=True)
    require(res["mc_dropped"] == 0, "fusion: edges dropped")
    require(res["n_captured"] == res["n_band"], "fusion: band overflow")
    for key, bound in zip(("warped_err_mm", "warped_err_half_motion_mm",
                           "canonical_err_mm"), bounds):
        require(res[key] <= bound, f"fusion: {key} {res[key]} > {bound}")


def parity_phase():
    res, got = run_path("parity128", lambda: run_benchmark(
        volume_dims=128, repeats=3, device=DEV))
    parity_checks(res, MAX_ERR_MM, MAX_ERR_3X_MM)
    return got


def fusion_phase():
    torch.cuda.reset_peak_memory_stats()
    res, got = run_path("fusion", lambda: run_fusion_benchmark(
        volume_dims=512, rotations=True, device=DEV))
    fusion_checks(res, (MAX_WARPED_MM, MAX_WARPED_HALF_MM, MAX_CANONICAL_MM),
                  JAX_FUSION)
    return got


def rigid_phase():
    frames, warmup = 10, 3
    res, got = run_path("rigid", lambda: run_rigid_benchmark(
        512, frames=frames, warmup=warmup, device=DEV))
    want = (frames + warmup - 1) * STENCIL_PER_ICP
    require(got["fetch_stencil"] == want,
            f"rigid: {got['fetch_stencil']} stencil launches, not {want}")
    require(res["resets"] == 0, f"rigid: {res['resets']} resets")
    require(res["ate_mm"] <= MAX_ATE_MM,
            f"rigid: ate_mm {res['ate_mm']} > {MAX_ATE_MM}")
    return got


def parity512_phase():
    res, got = run_path("parity512", lambda: run_benchmark(
        volume_dims=512, repeats=3, device=DEV))
    parity_checks(res, MAX_ERR512_MM, MAX_ERR512_3X_MM)
    return got


def movingcam_phase(path="movingcam", similarity_reg=False,
                    jax_ref=JAX_MOVINGCAM):
    frames, warmup = 12, 3
    torch.cuda.reset_peak_memory_stats()
    res, got = run_path(path, lambda: run_fusion_benchmark(
        volume_dims=512, frames=frames, warmup=warmup, rotations=True,
        camera_motion=0.002, similarity_reg=similarity_reg, device=DEV))
    want = (frames + warmup - 1) * STENCIL_PER_ICP
    require(got["fetch_stencil"] == want,
            f"{path}: {got['fetch_stencil']} stencil launches, not {want}")
    fusion_checks(res, (MAX_MC_WARPED_MM, MAX_MC_WARPED_HALF_MM,
                        MAX_MC_CANONICAL_MM), jax_ref)
    return got


def simreg_phase():
    return movingcam_phase("movingcam_simreg", True, JAX_SIMREG)


def main() -> int:
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    phases = [("kernel build", lambda: kernels.build()),
              ("kernel phase", kernel_phase),
              ("small-input check (parity)", small_input_check),
              ("small-input check (fusion)", small_fusion_check),
              ("small-input check (rigid)", small_rigid_check),
              ("parity128", parity_phase),
              ("fusion", fusion_phase),
              ("rigid", rigid_phase),
              ("parity512", parity512_phase),
              ("movingcam", movingcam_phase),
              ("movingcam_simreg", simreg_phase)]
    out = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    rows = out["kernel phase"]
    table = {"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][3],
         "replaces": KERNELS[n][4],
         "launches": sum(out[path][n] for path in PATHS),
         **{f"launches_{path}": out[path][n] for path in PATHS},
         "library_call": LIBRARY.get(n), **rows[n],
         "at_paths": AT_PATHS[n]}
        for n in KERNELS]}
    print(json.dumps(table))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
