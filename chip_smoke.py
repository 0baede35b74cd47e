#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from dynfu_tpu_torch/csrc;
3. kernel phase: runs each of the five kernels and its plain PyTorch
   version on the card, on the same seeded inputs at the 128^3 slice's
   shapes, checks that they agree (selections exactly, floats within the
   stated tolerance) and times both with CUDA events;
4. small-input check: the engine on the card against the same engine on
   the CPU (plain versions), three frames of a 64^3 scene;
5. slice phase: the parity DynFusion benchmark at 640x480 and 128^3
   (run_benchmark, repeats=3), with every kernel's launch counter zeroed
   just before it; requires zero drops, the accuracy bounds, every kernel
   launched and no plain version run on a CUDA tensor.

Prints the kernels' JSON line, then as its last line the device JSON.
Any failed check raises, and the script exits non-zero without that line.
It needs CUDA: without a card it exits 1 before doing anything.
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

from dynfu_tpu_torch.engine.dynfusion import DynFusion  # noqa: E402
from dynfu_tpu_torch.mesh import mc_cuda  # noqa: E402
from dynfu_tpu_torch.ops import corr_cuda, knn, knn_cuda, warp_cuda  # noqa: E402
from dynfu_tpu_torch.solver import gram_cuda  # noqa: E402
from dynfu_tpu_torch.utils.benchmarks import (  # noqa: E402
    bench_frame, bench_params, run_benchmark)
from dynfu_tpu_torch.warp import field as wfield  # noqa: E402

DEV = torch.device("cuda")

# accuracy bounds for the slice: ~10% above the JAX reference's recorded
# 128^3 figures (BENCH_r05.json: 10.084 mm, 15.139 mm); accuracy does not
# depend on the chip
MAX_ERR_MM = 11.0
MAX_ERR_3X_MM = 16.5

# (wrapper, plain, source, replaced TPU kernel)
KERNELS = {
    "pack_triangles": (mc_cuda.pack_triangles, mc_cuda.pack_triangles_plain,
                       "dynfu_tpu_torch/csrc/pack_triangles.cu",
                       "dynfu_tpu/mesh/mc_pallas.py:69"),
    "knn_gather": (knn_cuda.knn_gather, knn_cuda.knn_gather_plain,
                   "dynfu_tpu_torch/csrc/knn.cu",
                   "dynfu_tpu/ops/knn_pallas.py:73"),
    "nn1_window_sweep": (corr_cuda.nn1_window_sweep,
                         corr_cuda.nn1_window_sweep_plain,
                         "dynfu_tpu_torch/csrc/corr.cu",
                         "dynfu_tpu/ops/corr_pallas.py:135"),
    "warp_fused": (warp_cuda.warp_fused, warp_cuda.warp_fused_plain,
                   "dynfu_tpu_torch/csrc/warp.cu",
                   "dynfu_tpu/ops/warp_pallas.py:171"),
    "data_normal": (gram_cuda.data_normal, gram_cuda.data_normal_plain,
                    "dynfu_tpu_torch/csrc/gram.cu",
                    "dynfu_tpu/solver/gram_pallas.py:85"),
}


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
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


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def probe_state():
    """Frame 0 of the slice on the card: its unique canonical vertices and
    its warp-field nodes are the k-NN and warp kernels' real inputs."""
    eng = DynFusion(bench_params(128), device=DEV)
    eng(bench_frame(0))
    wf = eng.warpfield
    rng = np.random.default_rng(1)
    t = torch.as_tensor(rng.normal(0, 0.01, (wf.capacity, 3)), dtype=torch.float32,
                        device=DEV)
    wf = wfield.compose_translations(wf, torch.where(wf.mask[:, None], t, 0.0))
    return eng.canonical.vertices.contiguous(), wf


def kernel_cases(verts, wf):
    """name -> (kernel call, plain call, compare(kernel_out, plain_out) ->
    max_abs_err, tolerance text)."""
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

    def cmp_exact(a, b):
        err = max_abs(a, b)
        require(err == 0.0, "pack_triangles differs from its plain version")
        return err
    cases["pack_triangles"] = (pa, cmp_exact, "exact")

    # k-NN: the canonical's unique vertices against the 256 nodes, F = 13
    ka = (verts, wf.pos, 8, wfield.node_table(wf), wf.mask)

    def cmp_knn(a, b):
        require(torch.equal(a[0], b[0]), "knn_gather selections differ")
        err = max(max_abs(a[1], b[1]), max_abs(a[2], b[2]))
        require(err == 0.0, "knn_gather distances or features differ")
        return err
    cases["knn_gather"] = (ka, cmp_knn, "selections and values exact")

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

    def cmp_corr(a, b):
        require(torch.equal(a[1], b[1]), "nn1_window_sweep certificates differ")
        err = max_abs(a[0], b[0])
        require(err == 0.0, "nn1_window_sweep fetched rows differ")
        return err
    cases["nn1_window_sweep"] = (ca, cmp_corr, "selections and rows exact")

    # fused warp: the canonical vertices through the perturbed field
    wa = (verts, verts, wf.pos, wf.dqs, wf.w, wf.mask, 8)

    def cmp_warp(a, b):
        err = max(max_abs(x, y) for x, y in zip(a, b))
        require(err <= 1e-6, f"warp_fused differs by {err} (> 1e-6)")
        return err
    cases["warp_fused"] = (wa, cmp_warp, "<= 1e-6 absolute")

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

    def cmp_gram(a, b):
        ea = max_abs(a[0], b[0]) / float(b[0].abs().max())
        eb = max_abs(a[1], b[1]) / float(b[1].abs().max())
        # float32 atomics sum in a varying order: relative tolerance
        require(max(ea, eb) <= 1e-5, f"data_normal relative error {ea}, {eb}")
        return max_abs(a[0], b[0])
    cases["data_normal"] = (ga, cmp_gram, "<= 1e-5 relative to max |A|, |b|")
    return cases


def kernel_phase():
    verts, wf = probe_state()
    rows = {}
    for name, (args, compare, tol) in kernel_cases(verts, wf).items():
        kern, plain = KERNELS[name][:2]
        out_k = kern(*args)
        torch.cuda.synchronize()
        out_p = plain(*args)
        torch.cuda.synchronize()
        err = compare(out_k, out_p)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        print(f"kernel {name}: max_abs_err {err} ({tol}); {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        rows[name] = (err, ms, plain_ms)
    return rows


def small_input_check():
    """Three frames of a 64^3 sphere scene on the card and on the CPU."""
    from dynfu_tpu_torch.core.camera import Intr
    from dynfu_tpu_torch.engine.params import DynFuParams, KinFuParams
    from dynfu_tpu_torch.io.datasets import sphere_depth

    H, W = 96, 128
    intr = Intr(140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
    params = DynFuParams(
        kinfu=KinFuParams(cols=W, rows=H, intr=intr, volume_dims=(64,) * 3,
                          volume_size=(1.0,) * 3,
                          volume_pose_t=(-0.5, -0.5, 0.25),
                          tsdf_trunc_dist=0.03),
        max_nodes=512, max_vertices=3 * 4096, max_mc_voxels=1 << 13,
        max_new_nodes=256, node_sample_step=32)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DynFusion(params, device=dev)
        for i in range(3):
            eng(sphere_depth((0.005 * i, 0.0, 0.75), 0.22, H, W, 140.0,
                             140.0, intr.cx, intr.cy))
        v, m = eng.warped_cloud(unique=True)
        out[dev] = (v.cpu(), m.cpu(), int(eng.warpfield.count))
    (vg, mg, ng), (vc, mc, nc) = out["cuda"], out["cpu"]
    require(torch.isfinite(vg[mg]).all(), "non-finite warped vertices")
    require(torch.equal(mg, mc) and ng == nc, "card and CPU node sets differ")
    err = float((vg - vc)[mg].abs().max())
    # f32 roundoff of the Gram atomics and of the card's exp/sqrt through
    # three solves: well under a tenth of a millimetre
    require(err <= 1e-4, f"card vs CPU warped cloud differs by {err} m")
    print(f"small-input check: card vs CPU max |dv| {err:.3g} m, "
          f"{ng} nodes", flush=True)


def slice_phase():
    for wrapper, plain, _, _ in KERNELS.values():
        wrapper.launches = 0
        plain.cuda_calls = 0
    res = run_benchmark(volume_dims=128, repeats=3, device=DEV)
    launches = {n: k[0].launches for n, k in KERNELS.items()}
    plain_calls = {n: k[1].cuda_calls for n, k in KERNELS.items()}
    print("slice:", json.dumps(res), flush=True)
    print("slice launches:", json.dumps(launches), flush=True)
    require(res["mc_dropped_cells"] == 0, "mc_dropped_cells != 0")
    require(res["corr_dropped"] == 0, "corr_dropped != 0")
    require(res["median_vertex_err_mm"] <= MAX_ERR_MM,
            f"median_vertex_err_mm {res['median_vertex_err_mm']} > "
            f"{MAX_ERR_MM}")
    require(res["err_after_3x_motion_mm"] <= MAX_ERR_3X_MM,
            f"err_after_3x_motion_mm {res['err_after_3x_motion_mm']} > "
            f"{MAX_ERR_3X_MM}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel never launched on the main path: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on a CUDA tensor: {plain_calls}")
    return launches


def main() -> int:
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({kernels.library_path().name})", flush=True)
    rows = kernel_phase()
    small_input_check()
    launches = slice_phase()
    table = {"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][2],
         "replaces": KERNELS[n][3], "launches": launches[n],
         "max_abs_err": rows[n][0], "ms": rows[n][1], "plain_ms": rows[n][2]}
        for n in KERNELS]}
    print(json.dumps(table))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
