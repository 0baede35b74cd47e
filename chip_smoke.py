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
   120x160 with R = 4), the slab stack and its sign summary
   (csrc/slab_stack.cu; no TPU kernel: the source's strided slice and
   transpose, XLA's copy) of that volume and of an x-block (the slabs
   bitwise, the summary equal; its library call the .contiguous() copy),
   and the slab sweep (csrc/sweep.cu; no TPU kernel: it replaces the
   source's XLA sweep loop) on the 512^3 rigid slice's frame-0 volume: the
   general sweep at 640x480 under a tilted pose (307,200 rays x 103
   slabs), the separable sweep on the rotated raycast's 744x560 virtual
   image (margin 1.15) and at the sharded step's 640x480, whole and as two
   x-blocks (split at plane 192), and the resolve of the two blocks'
   records, then the same (but 744x560) on two volumes built to break the
   sweep's skip (single negative voxels scattered in bricks the summary
   marks; a box whose faces lie on brick edges) (hit masks equal, points
   within 1e-6 m, normals within 1e-5, the rows bitwise the plain
   version's counted; records exact; the resolve bitwise the whole sweep,
   with hits across the face on the frame-0 volume); each sweep case also
   reports its kernel's own work counters (samples per ray, and the
   warp's largest, beside a one-slab-at-a-time walk's; brick layers
   checked, bricks and samples skipped, empty spans), and the stack and
   sweep are timed together (raycast_device) — checks that they agree
   (selections and the stencil exactly, NaN positions included; floats
   within the stated tolerance)
   and times each: CUDA events over back-to-back calls (ms), the host's
   time per call without waiting for the card (host_ms), the
   profiler's device time per call (device_ms), for the Grams, the pack,
   the stack and the sweep the time per call replayed from a CUDA graph
   (graph_ms: no host time in it), the plain version (plain_ms) and, where
   one PyTorch call computes the same function, that call (library_ms; the
   stack's also from a graph, library_graph_ms); bound_ms is the least
   time the card could take (the
   larger of the bytes over 3.35 TB/s and the operations over 67 TFLOP/s
   of float32), from this run's inputs. The two warp rows and the k-NN also
   report the candidates per warp and the 1-NN the sub-tiles each warp
   scanned, from the plain models of the kernels' rules at the launch shape
   the kernel's own code picks (with the blocks and waves of the k-NN and
   the 1-NN); the two Grams report their rows, chunks and neighbours per
   node. Each Gram must give the same bits over three launches and the bits
   of its plain fixed-order model (gram_cuda.gram_fixed_order);
4. small-input checks: three frames of a 64^3 scene in parity mode, in
   SE(3) fusion mode, through rigid KinFu (120x160), in fixed mode (three
   spheres, the gather ICP) and in parity mode with foreground tracking
   (fg_aabb, the box overflowing 256 tracked vertices) on the card, each
   against the same engine on the CPU;
5. the main paths, each with every launch counter zeroed just before it and
   read just after, each requiring its kernels launched and no plain
   version run on a CUDA tensor; after each, every kernel the path launched
   is held against its plain version, with the tolerances above, at the
   path's own largest call (its arguments captured during the run; for
   the 1-NN, the main and the escalate pass; these checks, the Grams' bits
   repeated and equal to their model among them, with the candidate,
   sub-tile and per-node counts, are listed under "at_paths" in each
   kernel's row):
   - parity 128^3: run_benchmark(128, repeats=3); zero drops, the accuracy
     bounds;
   - SE(3) fusion 512^3: run_fusion_benchmark(512, rotations=True); no
     dropped edges, the whole band captured, the accuracy bounds;
   - rigid 512^3: run_rigid_benchmark(512) (KinFuParams' raycast_mode
     "auto": the source's formulations, the tilted poses through the
     homography integrate and the rotated sweep); 12 ICPs x 19 stencil
     launches, no reset, the ATE bound; then rigid_exact512, the same scene
     with raycast_mode "exact" (the per-voxel integrate and the general
     sweep), 3 + 5 frames, under the same checks; then, uncounted,
     utils/rigid_profile's profile of the rigid frame (the raycast stage's
     host and kernel ms per frame) and the kernels inside one raycast by
     name with calls and device ms (as KinFu._raycast runs it, and the
     general sweep);
   - parity 512^3: run_benchmark(512, repeats=3) (unique edge vertices);
     zero drops, the accuracy bounds;
   - moving-camera SE(3) fusion 512^3: run_fusion_benchmark(512,
     rotations=True, camera_motion=0.002); 14 ICPs x 19 stencil launches,
     the whole band captured, the accuracy bounds;
   - the same with similarity_reg=True (the SE(3) solve marginalises a
     global scale), under the same checks;
   - translations-only fusion 512^3: run_fusion_benchmark(512); no dropped
     edges, the whole band captured, the accuracy bounds;
   - the umbrella 512^3: run_umbrella_benchmark(512), parity mode with
     foreground tracking (2^19 edge vertices, 2^15 tracked); zero drops,
     the visible-surface error bounds, a least coverage; before it, frame
     0 alone prints the cells its marching cubes drops, the kept
     canonical's x extent and its vertices in the foreground box;
   - fixed mode 128^3: DynFusion(bench_params(128), mode="fixed") (the
     gather ICP against the raycast model, real normals, its own solve
     graph) on the moving-camera scene, 3 + 12 frames; zero drops, bounds
     1.10 x the JAX package's figures for the same frames, loop and metric,
     its fixed mode as shipped (scripts/jax_fixed_reference.py);
   - the dataset app 512^3 (cli512): io.cli.main(["run", "data/umbrella",
     "--volume-dims", "512", "--export-viz", "--out", A]) in this process,
     A a temporary directory; 16 .pcd, .vtk, .ply and render PNGs each;
     then "--frames 8 --checkpoint-every 8" into B and "--resume
     B/checkpoint.npz" into C, whose frames 8-15 .pcd, .ply and .vtk must
     be byte-equal to A's; then DynFusion at the same parameters over the 16
     frames uninterrupted against one restored by load_checkpoint after
     frame 7 (torch.equal on the volume, the warp field and the warped
     cloud); prints the frame times, DepthLoader.native and each frame's
     mc_dropped and corr_dropped. The CLI's default parameters apply no
     caps_for_volume preset, so the row drops cells: no accuracy bound;
   - the rigid dataset app 512^3 (cli_rigid512): "run --rigid
     data/umbrella --volume-dims 512"; 16 pose rows in trajectory.txt,
     rigid_mesh.ply, 19 stencil launches per ICP the engine ran;
   - the sharded parity engine 512^3 (dist_parity512): run_benchmark(512,
     repeats=3) on dist.driver.ShardedDynFusion over 2 ranks
     (dist.runtime.spawn; this process is rank 0, whose launches are
     counted; gloo when the ranks share the card, NCCL with a card each);
     zero drops, the parity 512^3 accuracy bounds, the figures beside the
     single-rank parity512 row's; every rank launched the path's kernels
     (their counts gathered after the run); then, uncounted, the same
     frames sharded against the single card frame by frame: the warped
     cloud, its mask and the drop counts bitwise, the data Gram's entries
     that differ (float64 rounding ties; 0 expected) counted; a world-1
     NCCL run of the driver over 6 frames bitwise the single card's; with
     2 or more cards the benchmark again over NCCL, one rank per card;
     dist.engine_spmd.sharding_overhead(2) (ms per frame at 1 and 2 ranks);
     `run data/umbrella --devices 2 --volume-dims 128 --frames 4
     --export-viz --checkpoint-every 2`: its exports byte-equal to
     --devices 1's, the checkpoints' arrays equal; 2 frames on 2 ranks
     resumed on 2 ranks over frames 2-3: those exports byte-equal too.
     The data Gram's largest call here is the float64 partial mode, held
     bit for bit against its fixed-order model's partial;
   - the sharded fusion engine 512^3 (dist_fusion512):
     run_fusion_benchmark(512, rotations=True) on ShardedDynFusion(mode=
     "fusion") over 2 ranks (rank 0 counted, the others' counts gathered;
     every rank must launch the path's kernels); the SE(3) fusion 512^3
     bounds, the whole band captured, no dropped edge, the figures beside
     the single-rank fusion row's; then, uncounted, the same 15 frames
     sharded against the single card frame by frame (the canonical with
     its normals, the warped cloud and the counters bitwise, the final
     DQs; the monomial Grams' entries that differ between the rank-order
     reduction and the single card counted: a frame that differs needs a
     tie), and likewise a translations-only 128^3 run over 8 frames
     (marching cubes, the pack, extract_normals on a block, the data
     Gram's partial mode). The monomial Grams' largest call here is their
     float64 partial mode, held bit for bit against its fixed-order
     model's partial; the kernel phase holds that mode on its own inputs
     too (3 launches bitwise, the model's bits, rounded once the float32
     mode's bits: the "partial" entry of the monomial_grams row).
   - the sharded fusion step 512^3 (dist_step512): spmd.sharded_fusion_step
     at bench_params(512) and 640x480 over frames 1-8 of the moving
     sphere, from the single-card parity engine's frame 0: its nodes moved
     into the camera frame of the step's raycast, each DQ a seeded motion,
     solver_kwargs the DynFuParams' GN fields; first on one rank in this
     process (uncounted; the data Gram's reductions recorded), then on 2
     ranks (rank 0 counted, every rank's launches gathered; DQB warp, k-NN
     and data Gram must launch on each). Frame by frame the whole raycast
     (points and normals, NaNs included), the warped rows of every rank,
     the node state and the SolveStats must be the single rank's bits, no
     data Gram entry may differ, no solve may raise the cost, every rank
     must hold valid rows; the hits whose crossing pair straddles the
     block face are counted (the face, plane 256, meets the sphere at the
     image's centre column, whose rays run parallel to it: the kernel
     phase's off-centre split holds that case); frame_ms on 1 and 2 ranks
     is printed. The step raycasts with the source's separable sweep: on 2
     ranks each sweeps its block's samples (the kernel's block mode) and a
     second launch resolves the gathered records. The step's warp, k-NN,
     partial data Gram, block sweep and resolve are held against their
     plain versions at its largest calls (153,600 rows a rank).
   - the umbrella's full scene 512^3 (umbrella_full512):
     run_umbrella_benchmark(512, foreground=False); corr_dropped printed
     beside the JAX package's 9034 on a TPU, no bound (its correspondence
     searches the 65,536-vertex canonical: the tile placement, as the
     source's dispatch picks);
   - the non-strict sharded frame 128^3 (dist_nonstrict):
     dist.engine_spmd.sharded_engine_frame(strict_parity=False) from fixed
     mode's frame 0 over frames 1-4 with the pose held, the GN solve with
     the separable integrate and DLB with the SE(3) solve and the rotated
     integrate, unsharded and on 1 rank (uncounted) and on 2 ranks (rank 0
     counted): every frame bitwise the single rank's, and the single
     rank's bitwise the unsharded frame's (the volume, the warped
     canonical and its normals, the live set and its normals, the node
     state, the drops and the solve's stats);
   - the correspondence beyond the source's kernel envelope
     (xwindow_block): knn.nn1_gather_xwindow at P = Q = 2^19 sphere points
     with the 22-column payload and the 512^3 parity preset's tiers, and
     again with blocks of 1000 queries (padded to 1024-query tiles): the
     block placement through the 1-NN kernel, and, uncounted, the rows it
     certifies equal to the tile placement's where both certify.
   Every path prints the formulations its engines ran
   (kinfu.FORMULATIONS) and its correspondences' placements (only
   xwindow_block may take the block placement); across rigid,
   rigid_exact512, cli512 and cli_rigid512 the separable, rotated and
   general sweeps and the rotated integrate must each have run at 512^3;
6. the rest of the source's public surface: the 1-NN kernel at the block
   placement (corr_block: P = Q = 2^19 sorted sphere points, one block of
   4096 a window and a tile, F = 3 and 33; rows and certificates equal to
   the plain version's; timed; kept in the nn1 row's "block_placement"),
   the k-NN functions of ops/knn at 262,144 queries (knn_variants:
   knn_blocked and nn1_blocked against 1024 nodes, nn1_gather_sorted and
   nn1_gather over 262,144 points with a 22-column payload; each decided
   selection equal to a float64 brute force on a 4096-query sample, the
   distances within 1e-6 of |q|^2 + |p|^2; ms), and the parity 512^3
   frame's edge stage from the integrate's bit planes (bitplanes512: the
   vertices, count and drops bitwise the stage that reads the volume;
   both stages' and both integrates' ms).

Prints each phase's seconds, the kernels' JSON line, the card's line, then
as its last line the device JSON. Any failed check raises, and the script
exits non-zero without that line. It needs CUDA: without a card it exits 1
before doing anything.
"""

import dataclasses
import inspect
import json
import subprocess
import sys
import tempfile
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
from dynfu_tpu_torch.core import se3  # noqa: E402
from dynfu_tpu_torch.dist import (engine_spmd, runtime,  # noqa: E402
                                  shard_gram, spmd)
from dynfu_tpu_torch.dist.driver import ShardedDynFusion  # noqa: E402
from dynfu_tpu_torch.dist.engine_spmd import sharding_overhead  # noqa: E402
from dynfu_tpu_torch.core.camera import Intr  # noqa: E402
from dynfu_tpu_torch.engine import dynfusion as dyn  # noqa: E402
from dynfu_tpu_torch.engine import kinfu as kinfu_mod  # noqa: E402
from dynfu_tpu_torch.engine.dynfusion import DynFusion  # noqa: E402
from dynfu_tpu_torch.engine.kinfu import KinFu  # noqa: E402
from dynfu_tpu_torch.engine.params import KinFuParams  # noqa: E402
from dynfu_tpu_torch.mesh import edges, mc_cuda  # noqa: E402
from dynfu_tpu_torch.ops import imgproc  # noqa: E402
from dynfu_tpu_torch.ops import (compaction, corr_cuda, knn,  # noqa: E402
                                 knn_cuda, stencil_cuda, warp_cuda)
from dynfu_tpu_torch.rigid import icp  # noqa: E402
from dynfu_tpu_torch.solver import gram_cuda  # noqa: E402
from dynfu_tpu_torch.utils.benchmarks import (  # noqa: E402
    RIGID_STEP, bench_frame, bench_params, breathing_err_mm, fusion_params,
    movingcam_frame, rigid_frame, rigid_params, run_benchmark,
    run_fusion_benchmark, run_rigid_benchmark, run_umbrella_benchmark,
    spheres_depth, umbrella_params)
from dynfu_tpu_torch.volume import sweep_cuda  # noqa: E402
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
# translations-only fusion 512^3 (row fusion_512): warped 4.293, half-motion
# 3.998, canonical 3.918 mm
MAX_T_WARPED_MM = 4.72
MAX_T_WARPED_HALF_MM = 4.40
MAX_T_CANONICAL_MM = 4.31
JAX_FUSION_T = {"corr_dropped": 3326, "n_band": 423732}
# the umbrella in parity mode with foreground tracking (row umbrella_512):
# visible-surface error median 5.273, p90 11.133 mm over 21,862 pixels, no
# drops; the coverage bound is 0.9 x JAX's, so that a thin cloud fails
MAX_UMB_MEDIAN_MM = 5.80
MAX_UMB_P90_MM = 12.25
MIN_UMB_COVERAGE_PX = 19676
# fixed mode at 128^3 (run_benchmark(128)'s parameters) on the moving-camera
# scene (the breathing sphere, four anchors, the camera moving 2 mm a frame
# along y), against the JAX package's figures on the CPU for the same
# frames, loop and metric, its fixed mode as shipped
# (scripts/jax_fixed_reference.py): warped 22.468, half-motion 12.257,
# canonical 9.791 mm, the camera 14.360 mm off the truth at frame 14, no
# drop in any frame. The bounds are 1.10 x those, with no drop.
FIXED_WARMUP, FIXED_FRAMES, FIXED_CAMERA = 3, 12, 0.002
FIXED_BOUNDS = {"warped_err_mm": 24.71, "warped_err_half_motion_mm": 13.48,
                "canonical_err_mm": 10.77, "camera_err_mm": 15.80}
# rigid KinFu with raycast_mode="exact" (rigid_exact512): warm-up and timed
# frames
EXACT_WARMUP, EXACT_FRAMES = 3, 5
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
    # not a TPU kernel: the source's XLA sweep loop (tsdf.py:629,
    # _slab_sweep), given a hand kernel for the port's rigid raycast
    "slab_sweep": (sweep_cuda.slab_sweep, None, sweep_cuda.slab_sweep_plain,
                   "dynfu_tpu_torch/csrc/sweep.cu",
                   "none (XLA loop): dynfu_tpu/volume/tsdf.py:629"),
    # the sharded sweep's second launch, reported inside the slab_sweep row
    "sweep_resolve": (sweep_cuda.sweep_resolve, None,
                      sweep_cuda.sweep_resolve_plain,
                      "dynfu_tpu_torch/csrc/sweep.cu",
                      "none (XLA loop): dynfu_tpu/volume/tsdf.py:629"),
    # not a TPU kernel: the sweep's input, the volume's sampled planes as
    # rows in x (the source's strided slice and transpose, XLA's copy), and
    # the sign summary the sweep skips by
    "slab_stack": (sweep_cuda.slab_stack, None, sweep_cuda.slab_stack_plain,
                   "dynfu_tpu_torch/csrc/slab_stack.cu",
                   "none (XLA copy): jnp.transpose(vol.tsdf[:, :, ::m], "
                   "(2, 1, 0)), dynfu_tpu/volume/tsdf.py:768 and :850"),
}
# the rows of the kernels line (sweep_resolve is folded into slab_sweep's)
TABLE = [n for n in KERNELS if n != "sweep_resolve"]
# the one PyTorch call timed as library_ms, where there is one (it computes
# the same function). The stencil has none: no single call applies the
# window, and img[vi, ui] (the fetch without it) is another function.
LIBRARY = {
    "pack_triangles": "boolean-index compaction of the triangle rows",
    "data_normal": "torch.matmul of the dense (s2 W)^T and W",
    "monomial_grams": "batched torch.matmul of the monomial-scaled strips",
    "slab_stack": "tensor.contiguous() of the strided, transposed view (the "
                  "stack alone, no summary)",
}
# main path -> the kernels it must launch
PATHS = {
    "parity128": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                  "warp_fused", "data_normal"),
    "fusion": ("pack_triangles", "knn_gather", "warp_fused_dlb",
               "monomial_grams"),
    "rigid": ("fetch_stencil", "slab_stack", "slab_sweep"),
    "rigid_exact512": ("fetch_stencil", "slab_stack", "slab_sweep"),
    "parity512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                  "warp_fused", "data_normal"),
    "movingcam": ("pack_triangles", "knn_gather", "warp_fused_dlb",
                  "monomial_grams", "fetch_stencil"),
    "movingcam_simreg": ("pack_triangles", "knn_gather", "warp_fused_dlb",
                         "monomial_grams", "fetch_stencil"),
    "fusion_t512": ("pack_triangles", "knn_gather", "warp_fused",
                    "data_normal"),
    "umbrella512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                    "warp_fused", "data_normal"),
    "fixed128": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                 "warp_fused", "data_normal", "slab_stack", "slab_sweep"),
    "cli512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
               "warp_fused", "data_normal", "slab_stack", "slab_sweep"),
    "cli_rigid512": ("fetch_stencil", "pack_triangles", "slab_stack",
                     "slab_sweep"),
    "dist_parity512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                       "warp_fused", "data_normal"),
    "dist_fusion512": ("pack_triangles", "knn_gather", "warp_fused_dlb",
                       "monomial_grams"),
    "dist_step512": ("knn_gather", "warp_fused", "data_normal",
                     "slab_stack", "slab_sweep", "sweep_resolve"),
    "umbrella_full512": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                         "warp_fused", "data_normal"),
    "xwindow_block": ("nn1_window_sweep",),
    "dist_nonstrict": ("pack_triangles", "knn_gather", "nn1_window_sweep",
                       "warp_fused", "warp_fused_dlb", "data_normal",
                       "monomial_grams"),
}
# the paths whose correspondence takes the block placement (beyond the
# source's kernel envelope, knn.tile_placement); every other path must take
# the tile placement only
BLOCK_PATHS = ("xwindow_block",)
# the 512^3 paths whose engines' formulations are counted
# (kinfu.FORMULATIONS): together they must run the source's separable,
# rotated and general sweeps and its rotated integrate
FORMULATION_PATHS = ("rigid", "rigid_exact512", "cli512", "cli_rigid512")
FORMULATIONS = {}  # path -> {formulation: calls}
PLACEMENTS = {}  # path -> {correspondence placement: calls}


class Placements:
    """Around a main path: counts the correspondence's placements, "tile"
    or "block", as knn.nn1_gather_xwindow picks them (knn.tile_placement,
    which it calls by its module-level name, is wrapped)."""

    def __enter__(self):
        self.counts = {}
        self.saved = knn.tile_placement

        def record(P: int, F: int) -> bool:
            tile = self.saved(P, F)
            key = "tile" if tile else "block"
            self.counts[key] = self.counts.get(key, 0) + 1
            return tile
        knn.tile_placement = record
        return self

    def __exit__(self, *exc):
        knn.tile_placement = self.saved


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


def host_ms(fn, iters: int = 20) -> float:
    """Host time per call of fn() over `iters` back-to-back calls, not
    waiting for the card: where it is above the device time, the event
    time measures it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def device_ms(fn, iters: int = 20, tries: int = 6):
    """(device time per call of every kernel fn() launches, memsets
    included, {kernel name: its share}), from torch.profiler. The profiler
    sometimes drops events: a window counts only if it recorded each kernel
    a whole multiple of `iters` times; (None, {}) if none of `tries`
    windows did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if evs and all(e.count % iters == 0 for e in evs):
            per = {e.key[:80]: e.self_device_time_total / 1e3 / iters
                   for e in evs}
            return sum(per.values()), per
    return None, {}


# rows also timed by replaying a CUDA graph of their launches (graph_ms);
# the stack's library call too (library_graph_ms)
GRAPH_TIMED = ("data_normal", "monomial_grams", "pack_triangles",
               "slab_stack", "slab_sweep")


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Time per call of fn() replayed from a CUDA graph of `iters` calls,
    by CUDA events: the device time with no host time per call in it (the
    profiler drops events late in a run)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (reps * iters)


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


def rigid_state(eng):
    """The stencil kernel's inputs on the 512^3 rigid slice: frame 0
    integrated by the engine `eng`, its raycast pyramid at pose 0 (the
    reference; the engine's dispatch: the separable sweep), frame 1's depth
    pyramid (the current frame) and, per level, the association's clipped
    indices at the identity pose of the first ICP iteration. Returns
    [(level, (img, vi, ui, radius))] for levels 0-2."""
    p = eng.params
    pts, nrm = eng._raycast(eng.poses[-1])
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
    """The bound's bytes are this run's: the rows that land in the stream
    (each cell's first n_tris rows, those below max_tris) read once, the
    offsets and counts read once and the stream written once; the library
    call compacts the same rows in order by one boolean index."""
    tris, offs, n_tris, max_tris = args
    M = tris.shape[0]
    rows = (torch.arange(5, device=DEV)[None, :]
            < n_tris[:, None]).reshape(-1)
    live = torch.clamp(torch.minimum(n_tris.long(), max_tris - offs.long()),
                       min=0)
    flat = tris.reshape(M * 5, 9)
    return (args, cmp_exact("pack_triangles"), "exact",
            (int(live.sum()) * 36 + 2 * M * 4 + max_tris * 36, 0),
            lambda: flat[rows])


def knn_case(args):
    """The bound is its bytes: the queries, the nodes and the table read
    once, the indices, distances and features written once. A selection
    that prunes the slots can beat a count of distances to every active
    node, so none is charged (that figure is kept as
    bound_ms_brute_force)."""
    q, pts, k, table, mask = args
    Q, D, F = q.shape[0], pts.shape[0], table.shape[1]

    def cmp_knn(a, b):
        require(torch.equal(a[0], b[0]), "knn_gather selections differ")
        err = max(max_abs(a[1], b[1]), max_abs(a[2], b[2]))
        require(err == 0.0, "knn_gather distances or features differ")
        return err
    return (args, cmp_knn, "selections and values exact",
            (Q * 12 + D * (12 + 1 + F * 4) + Q * k * (8 + F * 4), 0), None)


def knn_brute_force_ms(args) -> float:
    """The bound of a selection over every active node (Q x active
    distances), kept beside the byte bound."""
    q, pts, k, table, mask = args
    Q, D, F = q.shape[0], pts.shape[0], table.shape[1]
    return bound_ms(Q * 12 + D * (12 + 1 + F * 4) + Q * k * (8 + F * 4),
                    Q * int(mask.sum()) * 8)[0]


def corr_case(args):
    """The bound is the least any exact implementation needs: its bytes,
    the queries, the windows' points (each read once) and the winners'
    payload rows read once, the rows and flags written once. A sweep that
    skips sub-tiles can beat a count of distances to every valid point of
    the window, so none is charged (that figure is kept as
    bound_ms_brute_force)."""
    qs, ps, lo_el, _, _, tq, W, payload = args
    Qp, Pp, F = qs.shape[0], ps.shape[0], payload.shape[1]
    lo = lo_el.long()
    cover = torch.zeros(Pp + 1, dtype=torch.int64, device=DEV)
    cover.index_add_(0, lo, torch.ones_like(lo))
    cover.index_add_(0, torch.clamp(lo + W, max=Pp), -torch.ones_like(lo))
    n_win = int((cover.cumsum(0)[:Pp] > 0).sum())

    def cmp_corr(a, b):
        require(torch.equal(a[1], b[1]),
                "nn1_window_sweep certificates differ")
        err = max_abs(a[0], b[0])
        require(err == 0.0, "nn1_window_sweep fetched rows differ")
        return err
    return (args, cmp_corr, "selections and rows exact",
            (Qp * 12 + n_win * 12 + lo_el.numel() * 12 + Qp * 4 * F
             + Qp * (4 * F + 1), 0), None)


def corr_brute_force_ms(args) -> float:
    """The bound of a sweep over every valid point of each window (the
    operations of Q x W distances), kept beside the byte bound."""
    qs, ps, lo_el, _, _, tq, W, payload = args
    Qp, Pp, F = qs.shape[0], ps.shape[0], payload.shape[1]
    valid = (ps[:, 0] < corr_cuda.BIG_X).to(torch.int64)
    cs = torch.cat([valid.new_zeros(1), valid.cumsum(0)])
    lo = lo_el.long()
    scanned = int((cs[torch.clamp(lo + W, max=Pp)] - cs[lo]).sum())
    return bound_ms(Qp * 12 + Pp * (12 + 4 * F) + lo_el.numel() * 12
                    + Qp * (4 * F + 1), scanned * tq * 8)[0]


def warp_brute_force_ms(args) -> float:
    """The bound of a brute-force selection, kept beside the byte bound for
    comparison: every query's distance to every active node, plus the
    blend."""
    q, _, pos, _, _, mask, k, _ = args
    Q, n = q.shape[0], int(mask.sum())
    return bound_ms(Q * 24 + pos.shape[0] * 49 + Q * 60,
                    Q * (8 * n + 40 * k + 60))[0]


def warp_case(args):
    """The bound is the least any exact implementation needs: its bytes,
    the queries and normals and the node table read once and the 15 floats
    per query written once. A selection that prunes the slots can beat a
    count of distances to every active node, so none is charged (the
    brute-force figure is kept as bound_ms_brute_force)."""
    q, _, pos, _, _, mask, k, blend = args
    Q = q.shape[0]
    work = (Q * 24 + pos.shape[0] * 49 + Q * 60, 0)

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
    matmul. With the partial mode (args[5]) the outputs are float64."""
    idx, w, s2, _, D = args[:5]
    out_bytes = 8 if len(args) > 5 and args[5] else 4
    N, K = idx.shape
    Wd = dense_strip(idx, w, D)
    sWT = (s2[:, None] * Wd).T.contiguous()

    def cmp_gram(a, b):
        ea = max_abs(a[0], b[0]) / max(float(b[0].abs().max()), 1e-30)
        eb = max_abs(a[1], b[1]) / max(float(b[1].abs().max()), 1e-30)
        # the kernel and the plain version both sum in float64, in other
        # orders (the bits are held against the kernel's fixed-order model
        # beside): relative tolerance
        require(max(ea, eb) <= 1e-5, f"data_normal relative error {ea}, {eb}")
        return max_abs(a[0], b[0])
    return (args, cmp_gram, "<= 1e-5 relative to max |A|, |b|",
            (N * K * 8 + N * 16 + (D * D + D * 3) * out_bytes,
             gram_work(idx, s2, D, 2, 7)),
            lambda: torch.matmul(sWT, Wd))


def mono_case(args):
    """The library call is the dense route: the ten monomial-scaled strips
    against the strip, one batched float32 matmul. With the partial mode
    (args[6]) the outputs are float64."""
    idx, w, s2, y, _, D = args[:6]
    out_bytes = 8 if len(args) > 6 and args[6] else 4
    N, K = idx.shape
    Ws = dense_strip(idx, torch.sqrt(torch.clamp_min(s2, 0.0))[:, None] * w,
                     D)
    monos = gram_cuda.monomials(y)  # (10, N)
    MsT = (Ws[None] * monos[:, :, None]).transpose(1, 2).contiguous()

    def cmp_mono(a, b):
        errs = [max_abs(x, z) / max(float(z.abs().max()), 1e-30)
                for x, z in zip(a, b)]
        # the kernel and the plain version both sum in float64, in other
        # orders (the bits are held against the kernel's fixed-order model
        # beside): relative tolerance
        require(max(errs) <= 1e-5, f"monomial_grams relative errors {errs}")
        return max(max_abs(x, z) for x, z in zip(a, b))
    return (args, cmp_mono, "<= 1e-5 relative to max |B|, |Bu|, |Bw|",
            (N * K * 8 + N * 28 + (10 * D * D + D * 6) * out_bytes,
             gram_work(idx, s2, D, 22, 19)),
            lambda: torch.matmul(MsT, Ws))


def stencil_case(args):
    """The indices in, the gathered rows in and the output out (no
    arithmetic); no library call applies the window."""
    img, vi, ui, _ = args
    H, W, C = img.shape

    def cmp_stencil(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        require(torch.equal(na, nb), "fetch_stencil NaN positions differ")
        err = max_abs(a[~na], b[~nb])
        require(err == 0.0, "fetch_stencil values differ")
        return err
    return (args, cmp_stencil, "exact, NaN positions included",
            (H * W * (8 + 2 * 4 * C), 0), None)


# what a compare function found beside its max_abs_err (bitwise rows of a
# sweep), merged into the row by `measure`
CMP_EXTRA = {}
# a sweep's tolerance against its plain version: the hit masks equal,
# points within 1e-6 m, normals within 1e-5
SWEEP_TOL = "hit masks equal, points 1e-6 m, normals 1e-5"


def cmp_sweep(name):
    """A sweep's (points, normals[, straddle]) against the plain version's:
    SWEEP_TOL, the straddle flags equal; records the count of hit rows
    whose point and normal are bitwise the plain version's."""
    def cmp(a, b):
        (pk, nk), (pp, np_) = a[:2], b[:2]
        hit = ~torch.isnan(pk[..., 0])
        require(torch.equal(hit, ~torch.isnan(pp[..., 0])),
                f"{name}: hit masks differ")
        require(torch.equal(torch.isnan(pk), torch.isnan(pp))
                and torch.equal(torch.isnan(nk), torch.isnan(np_)),
                f"{name}: NaN positions differ")
        ep, en = max_abs(pk[hit], pp[hit]), max_abs(nk[hit], np_[hit])
        require(ep <= 1e-6 and en <= 1e-5,
                f"{name}: points {ep} m, normals {en} from the plain version")
        if len(a) > 2:
            require(torch.equal(a[2], b[2]), f"{name}: straddle flags differ")
        same = ((pk == pp).all(-1) & (nk == np_).all(-1))[hit]
        CMP_EXTRA[name] = dict(hit_rows=int(hit.sum()),
                               bitwise_rows=int(same.sum()),
                               max_abs_err_points=ep, max_abs_err_normals=en)
        print(f"{name}: {int(same.sum())} of {int(hit.sum())} hit rows "
              f"bitwise the plain version's", flush=True)
        return max(ep, en)
    return cmp


def sample_corners(g, geo, rays, spec, x_off: int, nx: int):
    """(row y0, stack plane xl) of the lower corner of each ray's sample of
    slab g (int64 (H, W), a slab a ray), by the plain sampler's
    operations (tsdf._sampler)."""
    X, Y = spec.dims
    vsx, vsy, vsz = (torch.tensor(v, dtype=torch.float32, device=DEV)
                     for v in spec.voxel)
    o = geo[:3]
    z = (g * spec.m).float() * vsz
    H, W = spec.shape
    if spec.mode == "general":
        dz = rays[..., 2]
        srel = (z - o[2]) / torch.where(dz > 1e-6, dz, 1.0)
        px = (o[0] + rays[..., 0] * srel) / vsx
        py = (o[1] + rays[..., 1] * srel) / vsy
    else:
        dzo = z - o[2]
        px = (o[0] + rays[:W][None, :] * dzo) / vsx
        py = (o[1] + rays[W:][:, None] * dzo) / vsy
    x0 = tv._clip_index(torch.floor(px), X - 2)
    y0 = tv._clip_index(torch.floor(py), Y - 2)
    return y0.long(), (x0.long() - x_off).clamp(0, nx - 2)


def decisive_sector_bytes(stack, geo, rays, spec, block) -> int:
    """The bytes of the stack's 32-byte sectors that the samples deciding
    each ray's outcome read, the least a sweep that is given the summary
    must read: for every ray with an event (a +/- crossing, the hit, or a
    -/+ one that ends the ray; from the plain version's record), the four
    corners of its pair of samples, and in block mode the block's first
    and last samples, which its record holds. A ray whose slabs the
    summary marks reads no slab; samples beyond the stack read +1."""
    slabs = stack.slabs
    S, Y, nx = slabs.shape
    x_off, lo, hi = block or (0, 0, spec.dims[0])
    rec = tv.sweep_plain(slabs, geo, rays, spec, (x_off, lo, hi)).long()
    ev_g, first_g, last_g = rec[0], rec[6], rec[11]
    event = ev_g <= spec.s_pad
    picks = [(ev_g - 1, event), (ev_g, event)]
    if block:
        picks += [(first_g, rec[10] != 0), (last_g, rec[15] != 0)]
    sectors = []
    for g, use in picks:
        use = use & (g >= 0) & (g < S)
        y0, xl = sample_corners(g.clamp(0, S - 1), geo, rays, spec, x_off,
                                nx)
        for dy in (0, 1):
            half = ((g * Y + y0 + dy) * nx + xl)[use]
            sectors += [half // 16, (half + 1) // 16]
    n = int(torch.unique(torch.cat(sectors)).numel()) if sectors else 0
    del rec, sectors
    return 32 * n


def sweep_case(args):
    """The bound is its bytes: the sign summary, the rays and the pose read
    once, the points and normals (or a block's 16-word records) written
    once, and the sectors of the stack that decide the rays' outcomes
    (`decisive_sector_bytes`): given the summary, no sweep reads fewer. No
    PyTorch call sweeps slabs for a first crossing."""
    stack, geo, rays, spec, block = args
    H, W = spec.shape
    out = H * W * (16 * 4 if block else 24)
    nbytes = (decisive_sector_bytes(*args) + stack.summary.numel()
              + (geo.numel() + rays.numel()) * 4 + out)
    if block:
        return (args, cmp_exact("slab_sweep records"), "records exact",
                (nbytes, 0), None)
    return (args, cmp_sweep("slab_sweep"), SWEEP_TOL, (nbytes, 0), None)


def resolve_reads(every, s_pad: int) -> int:
    """The record words the resolve must read: per ray and block its first
    event's slab and its first and last samples' slabs (3); the winning
    event's flag and values (5) where a block of the ray has one; and for
    every pair of blocks that meet on a ray (one's last slab + 1 the
    other's first), the two samples that judge it (2 x 4)."""
    world, _, H, W = every.shape
    first_g, last_g = every[:, 6], every[:, 11]
    has_event = every[:, 0].amin(0) < s_pad + 1
    meet = ((last_g[:, None] >= 0)
            & (first_g[None, :] == last_g[:, None] + 1))
    return (3 * world * H * W + 5 * int(has_event.sum())
            + 8 * int(meet.sum()))


def resolve_case(args):
    """The record words the resolve must read (`resolve_reads`), the pose
    and rays read once, the points, normals and straddle flags written
    once; no PyTorch call."""
    every, geo, rays, spec = args
    H, W = spec.shape
    nbytes = (resolve_reads(every, spec.s_pad) * 4
              + (geo.numel() + rays.numel()) * 4
              + H * W * 25)
    return (args, cmp_sweep("sweep_resolve"),
            SWEEP_TOL + ", straddle flags equal", (nbytes, 0), None)


def stack_sector_bytes(shape, m: int) -> int:
    """The bytes of the 32-byte sectors of an (nx, Y, Z) float16 volume that
    hold a sampled plane (z = 0, m, 2m, ...): what any stack must read."""
    nx, Y, Z = shape
    S = (Z - 1) // m + 1
    starts = (np.arange(nx * Y, dtype=np.int64) * Z) % 16  # row start, halves
    per_start = {int(r): len(np.unique((r + np.arange(S) * m) // 16))
                 for r in np.unique(starts)}
    return 32 * sum(per_start[int(r)] for r in starts)


def stack_case(args):
    """The slabs bitwise and the summary equal to the plain version's. The
    bound is its bytes: the volume's sectors holding sampled planes read
    once, the stack and the summary written once. The library call is the
    stack's copy alone (tsdf.slab_stack, no summary)."""
    tsdf, m = args
    S = (tsdf.shape[2] - 1) // m + 1
    nbytes = (stack_sector_bytes(tsdf.shape, m)
              + S * tsdf.shape[1] * tsdf.shape[0] * 2
              + int(np.prod(tv.summary_shape(S, tsdf.shape[1],
                                             tsdf.shape[0]))))

    def cmp_stack(a, b):
        require(torch.equal(a[0].view(torch.int16), b[0].view(torch.int16)),
                "slab_stack: the slabs differ from the plain version's")
        require(torch.equal(a[1], b[1]),
                "slab_stack: the summary differs from the plain version's")
        marked = tv.marked_bricks(a[1], tsdf.shape[0])
        CMP_EXTRA["slab_stack"] = dict(bricks=marked.numel(),
                                       bricks_marked=int(marked.sum()))
        print(f"slab_stack: slabs bitwise, summary equal; "
              f"{int(marked.sum())} of {marked.numel()} bricks marked",
              flush=True)
        return 0.0
    return (args, cmp_stack, "slabs bitwise, summary equal", (nbytes, 0),
            lambda: tv.slab_stack(tsdf, m))


# row -> its case: (args, compare(kernel_out, plain_out) -> max_abs_err,
# tolerance text, (bytes, flops), library call or None)
CASES = {"pack_triangles": pack_case, "knn_gather": knn_case,
         "nn1_window_sweep": corr_case, "warp_fused": warp_case,
         "warp_fused_dlb": warp_case, "data_normal": gram_case,
         "monomial_grams": mono_case, "fetch_stencil": stencil_case,
         "slab_sweep": sweep_case, "sweep_resolve": resolve_case,
         "slab_stack": stack_case}


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


def mono_partial_row(case) -> dict:
    """The monomial Grams' float64 partial mode (the sharded SE(3) solve's)
    on the kernel phase's inputs: held against its plain version, its bits
    repeated over three launches and equal to its fixed-order model's
    partial (measure), and rounded once, the float32 mode's bits."""
    args = case[0] + (True,)
    row = measure("monomial_grams", *mono_case(args))
    f64 = gram_cuda.monomial_grams(*args)
    f32 = gram_cuda.monomial_grams(*case[0])
    torch.cuda.synchronize()
    same = all(torch.equal(a.float(), b) for a, b in zip(f64, f32))
    print(f"kernel monomial_grams partial: rounded once, the float32 mode's "
          f"bits: {same}", flush=True)
    require(same and f64[0].dtype == torch.float64,
            "monomial_grams: the partial mode rounded differs from the "
            "float32 mode")
    return dict(row, rounds_to_float32_mode=same)


# --- the redesigned kernels' data-dependent work -------------------------


def quantiles(x: torch.Tensor):
    """mean, p95 and max of x; None where x is empty (no warp had work)."""
    if not x.numel():
        return None
    x = x.double()
    return dict(mean=float(x.mean()), p95=float(torch.quantile(x, 0.95)),
                max=float(x.max()))


def waves(blocks: int, per_sm: int) -> float:
    """Blocks over the card's resident capacity (SMs x blocks per SM)."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    return blocks / (sms * per_sm)


def work_stats(name, args) -> dict:
    """The data-dependent work of a redesigned kernel on these inputs, from
    the plain models of its rules, and its launch shape as the kernel's own
    code picks it: the candidates per warp (warps with a finite query) of
    the warps and the k-NN; the 1-NN's sub-tiles scanned per warp (warps
    with a live query); the Grams' rows, marked chunks and neighbours per
    node holding a row (passes of 32 neighbours), and warps per block."""
    if name in ("warp_fused", "warp_fused_dlb", "knn_gather"):
        if name == "knn_gather":
            q, pos, k, _, mask = args
            launch = knn_cuda.launch_info(q.shape[0], pos.shape[0])
            launch["waves"] = waves(launch["blocks"], launch["blocks_per_sm"])
        else:
            q, _, pos, _, _, mask, k, _ = args
            launch = dict(threads=warp_cuda.launch_threads(pos.shape[0]))
        cand, has_box = warp_cuda.group_candidates(q, pos, mask, k,
                                                   launch["threads"])
        st = dict(slots=pos.shape[0], active=int(mask.sum()),
                  candidates=quantiles(cand.sum(1)[has_box]), **launch)
        del cand
    elif name == "nn1_window_sweep":
        qs, ps, lo_el, pre, suf, tq, W, pay = args
        launch = corr_cuda.launch_info(qs.shape[0])
        require(launch["sub"] == corr_cuda.SUB,
                f"nn1: the kernel's sub-tile is {launch['sub']} points, the "
                f"model's {corr_cuda.SUB}")
        vals, exact, scanned, has = corr_cuda.pruned_sweep(
            *args, split=launch["split"])
        got = corr_cuda.nn1_window_sweep(*args)
        st = dict(window=W, window_subtiles=-(-W // corr_cuda.SUB),
                  subtiles=quantiles(scanned[has].reshape(-1)),
                  subtiles_per_group=quantiles(scanned[has].sum(1)),
                  model_matches=bool(torch.equal(got[0], vals)
                                     and torch.equal(got[1], exact)),
                  waves=waves(launch["blocks"], launch["blocks_per_sm"]),
                  **launch)
        del vals, exact, got
    elif name in ("data_normal", "monomial_grams"):
        mono = name == "monomial_grams"
        idx, w, s2, D = args[0], args[1], args[2], args[5 if mono else 4]
        work = gram_cuda.gather_work(idx, w, s2, D, mono)
        held = work["rows"] > 0
        st = dict(nodes_held=int(held.sum()),
                  warps=gram_cuda.gram_warps(idx.shape[0], D, mono),
                  **{k: quantiles(v[held]) for k, v in work.items()})
    elif name == "slab_sweep":
        st = sweep_work_stats(args)
    else:
        return {}
    print(f"kernel {name} work: {json.dumps(st)}", flush=True)
    return st


# rows whose kernel must give the same bits on every launch, and the bits
# of its plain fixed-order model
REPEAT_REQUIRED = ("data_normal", "monomial_grams")


def warp_max_mean(x: torch.Tensor) -> float:
    """The mean over warps (32 consecutive rays) of the warp's largest x."""
    n = x.numel()
    y = torch.zeros(-(-n // 32) * 32, dtype=x.dtype, device=x.device)
    y[:n] = x
    return float(y.reshape(-1, 32).amax(1).double().mean())


def sweep_work_stats(args) -> dict:
    """What the sweep kernel's rays did on `args`, as its own counters
    report it (sweep_cuda.sweep_work): samples computed per ray (mean, and
    the warp's largest, mean over warps), brick layers checked, bricks and
    samples skipped per ray, rays with an empty span of slabs; beside them
    the samples a walk of one slab at a time takes on the same rays (up to
    the first event; a block's: its own samples)."""
    w = sweep_cuda.sweep_work(*args).reshape(len(sweep_cuda.WORK_FIELDS), -1)
    f = dict(zip(sweep_cuda.WORK_FIELDS, w))

    def mean(x):
        return float(x.double().mean())
    st = dict(rays=w.shape[1], samples_per_ray=mean(f["samples"]),
              samples_warp_max=warp_max_mean(f["samples"]),
              layers_checked_per_ray=mean(f["layers_checked"]),
              bricks_skipped_per_ray=mean(f["bricks_skipped"]),
              samples_skipped_per_ray=mean(f["samples_skipped"]),
              empty_rays=int(f["empty"].sum()),
              single_slab_samples_per_ray=mean(f["single_slab_samples"]),
              single_slab_samples_warp_max=warp_max_mean(
                  f["single_slab_samples"]))
    del w, f
    return st


def repeats_bitwise(name, args, n: int = 3) -> bool:
    """Whether n launches of the kernel on `args` give the same bits."""
    kern = KERNELS[name][0]
    outs = [kern(*args) for _ in range(n)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))


def gram_model_check(name, args) -> bool:
    """Whether a Gram kernel gives the bits of its plain fixed-order model
    (gram_cuda.gram_fixed_order, on the CPU: index_add_ adds there in index
    order) at the kernel's warps per block."""
    got = KERNELS[name][0](*args)
    if name == "data_normal":
        idx, w, s2, delta, D = args[:5]
        partial = len(args) > 5 and args[5]
        y = None
    else:
        idx, w, s2, y, delta, D = args[:6]
        partial = len(args) > 6 and args[6]
        y = y.cpu()
    want = gram_cuda.gram_fixed_order(
        idx.cpu(), w.cpu(), s2.cpu(), delta.cpu(), D,
        gram_cuda.gram_warps(idx.shape[0], D, y is not None), y=y,
        partial=partial)
    return all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


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
    extra = CMP_EXTRA.pop(name, {})
    if name in REPEAT_REQUIRED:
        same = repeats_bitwise(name, args)
        model = gram_model_check(name, args)
        print(f"kernel {name}: 3 launches bitwise equal: {same}; equal to "
              f"its fixed-order model: {model}", flush=True)
        require(same, f"{name}: 3 launches on the same inputs differ")
        require(model, f"{name}: differs from its fixed-order model")
        extra.update(bitwise_repeat=same, matches_fixed_order_model=model)
    ms = cuda_ms(lambda: kern(*args))
    h_ms = host_ms(lambda: kern(*args))
    dev_ms, dev_kernels = device_ms(lambda: kern(*args))
    g_ms = graph_ms(lambda: kern(*args)) if name in GRAPH_TIMED else None
    plain_ms = cuda_ms(lambda: plain(*args), iters=3, warmup=1)
    lib_ms = None if library is None else cuda_ms(library, iters=5)
    lib_g_ms = graph_ms(library) if name == "slab_stack" else None
    extra.update(work_stats(name, args))
    if name in ("warp_fused", "warp_fused_dlb"):
        extra["bound_ms_brute_force"] = warp_brute_force_ms(args)
    elif name == "nn1_window_sweep":
        extra["bound_ms_brute_force"] = corr_brute_force_ms(args)
    elif name == "knn_gather":
        extra["bound_ms_brute_force"] = knn_brute_force_ms(args)
    b_ms, b_by = bound_ms(*work)
    print(f"kernel {name}: max_abs_err {err} ({tol}); {ms:.4f} ms "
          f"(events), {h_ms:.4f} ms (host), {dev_ms} ms (device), "
          f"{g_ms} ms (graph), plain "
          f"{plain_ms:.4f} ms, "
          f"library {lib_ms} ms (graph {lib_g_ms}), bound {b_ms:.5f} ms "
          f"({b_by})", flush=True)
    if len(dev_kernels) > 1:
        print(f"kernel {name} device ms by kernel: {json.dumps(dev_kernels)}",
              flush=True)
    return dict(max_abs_err=err, ms=ms, host_ms=h_ms, device_ms=dev_ms,
                device_kernels_ms=dev_kernels, graph_ms=g_ms,
                plain_ms=plain_ms,
                library_ms=lib_ms, library_graph_ms=lib_g_ms, bound_ms=b_ms,
                bound_by=b_by, **extra)


def sweep_cases(eng, tsdf=None, tag="", rotated=True):
    """The sweep kernel's inputs at the main paths' largest shapes, on the
    512^3 rigid slice's frame-0 volume (the engine `eng`; `tsdf` in its
    place if given, its labels prefixed by `tag`), each stack and summary
    from sweep_cuda.slab_stack: the general sweep (`raycast`) at 640x480
    under a tilted pose (307,200 rays x 103 slabs); if `rotated`, the
    separable sweep on raycast_rotated's virtual image at margin 1.15
    (744x560) under the same pose; the sharded step's separable sweep at
    640x480, whole and as two x-blocks with their 1-plane halo, split at
    plane 192 (x = -0.375 m): a face that meets the surface off the image's
    centre column, where rays cross it between two slabs (at the centre
    column rays run parallel to the face). Returns ([(label, case)], the
    index of the whole 640x480 separable case, the resolve's case over the
    two blocks' records)."""
    p, cfg = eng.params, eng.tsdf_config
    vol = eng.vol if tsdf is None else eng.vol._replace(tsdf=tsdf)
    shape = (p.rows, p.cols)
    R, _ = se3.from_rodrigues(torch.tensor([0.02, -0.03, 0.01]),
                              torch.zeros(3))
    pose = (R.to(DEV), torch.tensor([0.01, -0.005, 0.02], device=DEV))
    Rc, t, dirs = tv.camera_rays(vol, pose, shape, p.intr)
    spec = tv.sweep_spec("general", shape, cfg)
    out = [(f"{tag}general {shape[1]}x{shape[0]}", sweep_case((
        sweep_cuda.slab_stack(vol.tsdf, spec.m),
        torch.cat([t, Rc.reshape(-1)]), dirs.contiguous(), spec, None)))]
    if rotated:
        Hv, Wv = (int(n * 1.15) // 8 * 8 + 8 for n in shape)
        vintr = Intr(p.intr.fx, p.intr.fy, Wv / 2 - 0.5, Hv / 2 - 0.5)
        geo, rays = tv.separable_rays(vol, tv._vol2cam_rotation_split(
            vol, pose)[1], vintr, (Hv, Wv))
        spec = tv.sweep_spec("separable", (Hv, Wv), cfg)
        out.append((f"{tag}separable {Wv}x{Hv}", sweep_case((
            sweep_cuda.slab_stack(vol.tsdf, spec.m), geo, rays, spec,
            None))))
    geo, rays = tv.separable_rays(vol, eng.poses[-1], p.intr, shape)
    spec = tv.sweep_spec("separable", shape, cfg)
    label = f"{tag}separable {shape[1]}x{shape[0]}"
    whole = len(out)
    out.append((label, sweep_case((sweep_cuda.slab_stack(vol.tsdf, spec.m),
                                   geo, rays, spec, None))))
    X, records = cfg.dims[0], []
    for lo, hi in ((0, X * 3 // 8), (X * 3 // 8, X)):
        h0, h1 = int(lo > 0), int(hi < X)
        args = (sweep_cuda.slab_stack(vol.tsdf[lo - h0:hi + h1], spec.m),
                geo, rays, spec, (lo - h0, lo, hi))
        out.append((f"{label}, block [{lo}, {hi})", sweep_case(args)))
        records.append(sweep_cuda.slab_sweep(*args))
    return out, whole, resolve_case((torch.stack(records), geo, rays, spec))


def broken_volumes(eng) -> dict:
    """Two volumes that try to break the sweep's skip, made from the rigid
    frame-0 volume (seeded): "thin", 20,000 single voxels of -0.5 on
    sampled planes, each inside a brick the summary marks (one voxel a
    brick; a sample next to it reads a thin negative feature); "edges", a
    box of -0.5 (48 x 48 voxels across) behind a shell of +1, in front of
    the spheres, whose faces lie on brick edges: its front face between
    the last slab of a brick layer and the first of the next, its x and y
    faces on planes 8 i (a brick's +1 plane)."""
    cfg = eng.tsdf_config
    m = tv.sweep_spec("general", (eng.params.rows, eng.params.cols), cfg).m
    bg, by, bx = tv.BRICK
    tsdf = eng.vol.tsdf
    X, Y, Z = tsdf.shape
    marked = tv.marked_bricks(sweep_cuda.slab_stack(tsdf, m).summary,
                              X).nonzero().cpu().numpy()
    rng = np.random.default_rng(13)
    pick = marked[rng.choice(len(marked), min(20000, len(marked) // 2),
                             replace=False)]
    S = (Z - 1) // m + 1
    g = np.minimum(pick[:, 0] * bg + rng.integers(0, bg, len(pick)), S - 1)
    y = np.minimum(pick[:, 1] * by + rng.integers(0, by, len(pick)), Y - 1)
    x = np.minimum(pick[:, 2] * bx + rng.integers(0, bx, len(pick)), X - 1)
    thin = tsdf.clone()
    thin[torch.as_tensor(x, device=DEV), torch.as_tensor(y, device=DEV),
         torch.as_tensor(g * m, device=DEV)] = -0.5
    # the box: around the voxel the centre pixel's ray hits, its front face
    # 8 slabs before the nearest hit of the separable sweep
    geo, rays = tv.separable_rays(eng.vol, eng.poses[-1], eng.params.intr,
                                  (eng.params.rows, eng.params.cols))
    spec = tv.sweep_spec("separable", (eng.params.rows, eng.params.cols), cfg)
    pts, _ = sweep_cuda.slab_sweep(sweep_cuda.slab_stack(tsdf, spec.m), geo,
                                   rays, spec)
    vz = torch.tensor(cfg.voxel_size, device=DEV)
    hit = pts[~torch.isnan(pts[..., 0])] + geo[:3]
    near = int((hit[:, 2].min() / vz[2]).item()) // spec.m
    gf = max(2, (near - 8) // bg * bg)
    c = (hit.mean(0) / vz).long().tolist()
    x0, x1 = (max(2, c[0] // bx - 3) * bx, min(X // bx - 2, c[0] // bx + 3)
              * bx)
    y0, y1 = (max(2, c[1] // by - 3) * by, min(Y // by - 2, c[1] // by + 3)
              * by)
    edges = tsdf.clone()
    edges[x0 - 2 * bx:x1 + 2 * bx, y0 - 2 * by:y1 + 2 * by,
          (gf - 3) * spec.m:] = 1.0
    edges[x0:x1, y0:y1, (gf - 1) * spec.m + 1:] = -0.5
    print(f"broken volumes: thin {len(pick)} voxels; edges box x [{x0}, "
          f"{x1}), y [{y0}, {y1}), front face between slabs {gf - 1} and "
          f"{gf} (layer edge)", flush=True)
    return {"thin": thin, "edges": edges}


def stack_cases(eng):
    """The stack kernel's inputs: the 512^3 rigid volume whole (rigid's
    and the app's call) and the sharded step's upper x-block with its
    1-plane halo."""
    cfg = eng.tsdf_config
    m = tv.sweep_spec("general", (eng.params.rows, eng.params.cols), cfg).m
    X = cfg.dims[0]
    lo = X * 3 // 8
    return [(f"{X}^3 whole", stack_case((eng.vol.tsdf, m))),
            (f"x-block [{lo - 1}, {X})", stack_case((eng.vol.tsdf[lo - 1:],
                                                     m)))]


def raycast_device_ms(tsdf, case) -> dict:
    """One raycast's device work as a whole, by torch.profiler: the stack
    of `tsdf` with its summary and the sweep of `case` launched together,
    the figure that shows the stack folded in or out."""
    _, geo, rays, spec, block = case[0]

    def both():
        return sweep_cuda.slab_sweep(sweep_cuda.slab_stack(tsdf, spec.m),
                                     geo, rays, spec, block)
    ms, per = device_ms(both)
    print(f"raycast (stack + sweep) {ms} ms device: {json.dumps(per)}",
          flush=True)
    return dict(device_ms=ms, device_kernels_ms=per)


def kernel_phase():
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for float32 matmuls")
    verts, wf = parity_state()
    fstate = fusion_state()
    cases = kernel_cases(verts, wf, fstate)
    rows = {name: measure(name, *case) for name, case in cases.items()}
    rows["monomial_grams"]["partial"] = mono_partial_row(
        cases["monomial_grams"])
    del cases
    torch.cuda.empty_cache()
    # the stencil row is level 0; levels 1 and 2 ride along under "levels"
    eng = KinFu(rigid_params(512), device=DEV)
    eng(rigid_frame(0))
    levels = []
    for level, args in rigid_state(eng):
        H, W = args[1].shape
        print(f"stencil level {level}: {H}x{W}, R = {args[3]}", flush=True)
        row = measure("fetch_stencil", *stencil_case(args))
        row.update(level=level, shape=[H, W], radius=args[3])
        levels.append(row)
    rows["fetch_stencil"] = dict(levels[0], levels=levels[1:])
    rows.update(sweep_phase(eng))
    del eng
    torch.cuda.empty_cache()
    return rows


def sweep_phase(eng) -> dict:
    """The stack, sweep and resolve rows on the 512^3 rigid frame-0 volume
    of `eng`. The stack row is the whole volume, its x-block under
    "cases"; the sweep row is the general sweep, the separable ones and the
    broken volumes' cases (`broken_volumes`) under "cases", the combined
    stack + sweep device time under "raycast_device"; the resolve of each
    volume's two blocks is the whole sweep, bit for bit (on the frame-0
    volume with hits whose crossing pair lies across the face)."""
    rows = {}
    stacks = [dict(measure("slab_stack", *case), case=label)
              for label, case in stack_cases(eng)]
    rows["slab_stack"] = dict(stacks[0], cases=stacks[1:])
    sweeps, resolves = [], []
    for tag, tsdf in [("", None)] + list(broken_volumes(eng).items()):
        tag = f"{tag} " if tag else ""
        cases, whole, resolve = sweep_cases(eng, tsdf, tag, rotated=not tag)
        for label, case in cases:
            print(f"slab_sweep {label}", flush=True)
            sweeps.append(dict(measure("slab_sweep", *case), case=label))
        if not tag:
            rows["raycast_device"] = {
                label: raycast_device_ms(eng.vol.tsdf, cases[i][1])
                for label, i in (("general", 0), ("separable", whole))}
        row = dict(measure("sweep_resolve", *resolve),
                   case=f"{tag}two blocks of 640x480")
        pts, nrm, straddle = sweep_cuda.sweep_resolve(*resolve[0])
        full = sweep_cuda.slab_sweep(*cases[whole][1][0])
        same = (torch.equal(pts.view(torch.int32), full[0].view(torch.int32))
                and torch.equal(nrm.view(torch.int32),
                                full[1].view(torch.int32)))
        n_straddle = int(straddle.sum())
        print(f"sweep_resolve {tag.strip()}: two blocks bitwise the whole sweep: "
              f"{same}; hits across the face {n_straddle}", flush=True)
        require(same and (n_straddle > 0 or tag),
                f"sweep_resolve {tag.strip()}: the blocks' resolve differs from the "
                f"whole sweep, or no hit crossed the face")
        row.update(bitwise_whole_sweep=same, hits_across_face=n_straddle)
        resolves.append(row)
        del cases, resolve, pts, nrm, full, tsdf
        torch.cuda.empty_cache()
    rows["slab_sweep"] = dict(sweeps[0], cases=sweeps[1:],
                              raycast_device=rows.pop("raycast_device"))
    rows["sweep_resolve"] = dict(resolves[0], cases=resolves[1:])
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
    # the card's float64-summed Gram against the CPU's float32 one, and the
    # card's exp/sqrt, through three solves: well under a tenth of a
    # millimetre
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
    KinFu (stencil ICP; the integrate and raycast of the source's dispatch,
    raycast_mode "auto") on the card and on the CPU; the camera moves (4,
    -2, 3) mm per frame."""
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


def _small_scene_frames(intr, step):
    """The 64^3 sphere moving `step` per frame beside two static spheres
    (the static camera's ICP has three spheres to hold on to)."""
    scene = [((0.28, 0.18, 0.85), 0.10), ((-0.25, -0.22, 0.9), 0.12)]
    return [spheres_depth([((step * i, 0.0, 0.75), 0.22)] + scene,
                          np.zeros(3), 96, 128, f=intr.fx)
            for i in range(3)]


def small_fixed_check():
    """Three frames of fixed mode (the gather ICP against the raycast model,
    TSDF-gradient normals) on the 64^3 three-sphere scene, on the card and
    on the CPU."""
    params, intr = _small_params()
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DynFusion(params, device=dev, mode="fixed")
        for d in _small_scene_frames(intr, 0.005):
            eng(d)
        c = eng.canonical
        v, m = eng.warped_cloud(unique=True)
        post, _ = wfield.warp_points_normals(eng.warpfield, c.vertices,
                                             c.vertices)
        fs = eng.last_frame_stats
        out[dev] = (v.cpu(), post.cpu(), m.cpu(), int(eng.warpfield.count),
                    eng.poses, (int(fs.mc_dropped), int(fs.corr_dropped)))
    (vg, qg, mg, ng, pg, dg), (vc, qc, mc, nc, pc, dc) = (out["cuda"],
                                                          out["cpu"])
    require(torch.isfinite(qg[mg]).all(), "non-finite warped vertices")
    require(torch.equal(mg, mc) and ng == nc,
            f"fixed: card and CPU node sets differ: {ng}/{nc}")
    dpose = max(float(np.abs(a - b).max())
                for x, y in zip(pg, pc) for a, b in zip(x, y))
    err = float((vg - vc)[mg].abs().max())
    post = (qg - qc)[mg].abs()
    # frame 2's ICP pose: float32 sums in another order move it by ~1e-5
    require(dpose <= 1e-4, f"fixed: card vs CPU poses differ by {dpose}")
    # frames 0 and 1 (identity pose) as in the parity check
    require(err <= 1e-4, f"fixed: card vs CPU warped cloud differs by "
            f"{err} m")
    # frame 2's solve: the pose difference can move a voxel behind a
    # silhouette onto the neighbouring pixel, so its live soup may differ
    # there; the solved field stays within a millimetre, most of it far
    # closer
    require(float(post.max()) <= 1e-3 and float(post.median()) <= 1e-5,
            f"fixed: card vs CPU solved field differs by "
            f"{float(post.max())} m (median {float(post.median())})")
    print(f"small-input check (fixed): card vs CPU max |dpose| {dpose:.3g},"
          f" max |dv| {err:.3g} m, solved max |dv| {float(post.max()):.3g} "
          f"m, {ng} nodes, drops {dg} / {dc}, final t {pg[-1][1].tolist()}",
          flush=True)


def small_fg_check():
    """Three frames of parity mode with foreground tracking (the right half
    of the 64^3 sphere; the box overflows the 256 tracked vertices) on the
    card and on the CPU: the same live set, drops (the box's overflow
    included) and nodes; the full canonical's warped cloud within 1e-4 m."""
    params, intr = _small_params(
        fg_aabb=((0.5, 0.25, 0.25), (0.75, 0.75, 0.75)), max_fg_verts=256)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = DynFusion(params, device=dev)
        for d in _small_frames(intr, 0.005):
            eng(d)
        v, m = eng.warped_cloud()
        out[dev] = (v.cpu(), m.cpu(), int(eng.warpfield.count),
                    eng.live.vertices.cpu(),
                    int(eng.last_frame_stats.corr_dropped))
    (vg, mg, ng, lg, cg), (vc, mc, nc, lc, cc) = out["cuda"], out["cpu"]
    require(torch.isfinite(vg[mg]).all(), "non-finite warped vertices")
    require(torch.equal(mg, mc) and ng == nc and cg == cc > 0,
            f"fg: card and CPU differ: nodes {ng}/{nc}, corr_dropped "
            f"{cg}/{cc}")
    require(torch.equal(lg, lc), "fg: card and CPU live sets differ")
    err = float((vg - vc)[mg].abs().max())
    require(err <= 1e-4, f"fg: card vs CPU warped cloud differs by {err} m")
    print(f"small-input check (fg): card vs CPU max |dv| {err:.3g} m, "
          f"{ng} nodes, corr_dropped {cg}", flush=True)


# --- the main paths --------------------------------------------------------


class Capture:
    """Around a main path: each wrapper's module attribute (the name every
    caller goes through) is replaced by a Shim that keeps, per kernel row,
    the arguments of the path's largest call (by the first argument's
    element count, the last of equal ones; for the 1-NN, per window width,
    so that the escalate pass is kept beside the main pass) and calls the
    wrapper. The arguments are kept by reference: the wrappers only read
    their inputs."""

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


def arg_tensors(args) -> list:
    """The tensors among a wrapper's arguments, a SlabStack's two in its
    place."""
    out = []
    for a in args:
        if isinstance(a, sweep_cuda.SlabStack):
            out += list(a)
        elif torch.is_tensor(a):
            out.append(a)
    return out


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
        key = (name, args[6] if name == "nn1_window_sweep" else None)
        if name == "slab_sweep":  # one largest call per mode
            key = (name, args[3].mode + (" block" if args[4] else ""))
        size = arg_tensors(args[:1])[0].numel()
        if size >= self.calls.get(key, (-1,))[0]:
            self.calls[key] = (size, args)
        return self.wrapper(*a, **kw)


# row -> [kernel against plain at each main path's largest call]
AT_PATHS = {n: [] for n in KERNELS}


def run_path(path: str, fn):
    """Run one main path with every counter zeroed just before it; require
    its kernels launched and no plain version run on a CUDA tensor. Then
    hold every kernel the path launched against its plain version at the
    path's own largest call (these launches come after the counts are
    read). Returns (result, launches per kernel)."""
    with Capture() as cap, Placements() as placed:
        reset_counters()
        kinfu_mod.FORMULATIONS.clear()
        res = fn()
        got = {n: launches(n) for n in KERNELS}
        plain = plain_calls()
        FORMULATIONS[path] = dict(kinfu_mod.FORMULATIONS)
        PLACEMENTS[path] = placed.counts
    print(f"{path}:", json.dumps(res), flush=True)
    print(f"{path} launches:", json.dumps(got), flush=True)
    print(f"{path} formulations (engine calls):",
          json.dumps(FORMULATIONS[path]), flush=True)
    print(f"{path} correspondence placements (calls; the source's envelope "
          f"{knn.TILE_MAX_POINTS} points, {knn.TILE_MAX_COLUMNS} columns):",
          json.dumps(PLACEMENTS[path]), flush=True)
    require(path in BLOCK_PATHS or not PLACEMENTS[path].get("block"),
            f"{path}: a correspondence beyond the tile placement's envelope")
    require(all(got[n] > 0 for n in PATHS[path]),
            f"a kernel never launched on the {path} path: {got}")
    require(not any(plain.values()),
            f"a plain version ran on a CUDA tensor on the {path} path: "
            f"{plain}")
    require({n for n, _ in cap.calls} == {n for n in KERNELS if got[n]},
            f"{path}: captured {sorted(cap.calls)}, launched {got}")
    for key in sorted(cap.calls, key=str):
        name = key[0]
        args = cap.calls.pop(key)[1]
        shapes = [list(a.shape) for a in arg_tensors(args)]
        print(f"{path}: {name} at its largest call, input shapes {shapes}",
              flush=True)
        row = measure(name, *CASES[name](args))
        AT_PATHS[name].append(dict(row, path=path, shapes=shapes,
                                   variant=key[1]))
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
    RESULTS["fusion"] = res
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


def rigid_exact_run() -> dict:
    """Rigid KinFu at 512^3 (run_rigid_benchmark's scene and parameters)
    with raycast_mode="exact": every tilted pose integrates per voxel and
    raycasts through the general slab sweep. EXACT_WARMUP frames, then
    EXACT_FRAMES timed; the ATE at the last frame."""
    eng = KinFu(dataclasses.replace(rigid_params(512), raycast_mode="exact"),
                device=DEV)
    frames = [rigid_frame(i) for i in range(EXACT_WARMUP + EXACT_FRAMES)]
    for d in frames[:EXACT_WARMUP]:
        eng(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in frames[EXACT_WARMUP:]:
        eng(d)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / EXACT_FRAMES
    t = np.asarray(eng.get_camera_pose()[1])
    want = np.asarray(RIGID_STEP) * (len(frames) - 1)
    return {"frame_ms": dt * 1e3,
            "ate_mm": float(np.linalg.norm(t - want)) * 1e3,
            "resets": eng.resets}


def rigid_exact512_phase():
    res, got = run_path("rigid_exact512", rigid_exact_run)
    want = (EXACT_WARMUP + EXACT_FRAMES - 1) * STENCIL_PER_ICP
    require(got["fetch_stencil"] == want,
            f"rigid_exact512: {got['fetch_stencil']} stencil launches, not "
            f"{want}")
    require(res["resets"] == 0, f"rigid_exact512: {res['resets']} resets")
    require(res["ate_mm"] <= MAX_ATE_MM,
            f"rigid_exact512: ate_mm {res['ate_mm']} > {MAX_ATE_MM}")
    return got


def kernel_list(fn, iters: int = 10, tries: int = 6) -> dict:
    """The kernels one call of fn() launches, from torch.profiler (the
    host's activity recorded too, as utils' profile_engine records it):
    {"kernels": [{name, calls, device_ms}] per call, the most device time
    first, memsets and copies included; "whole": whether each kernel was
    recorded a whole multiple of `iters` times}. The first of `tries`
    windows where that holds, else the last window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
        rows = [dict(name=e.key[:120], calls=e.count / iters,
                     device_ms=e.self_device_time_total / 1e3 / iters)
                for e in evs]
        whole = bool(evs) and all(e.count % iters == 0 for e in evs)
        if whole:
            break
    return dict(kernels=sorted(rows, key=lambda r: -r["device_ms"]),
                whole=whole)


def raycast_kernels(eng) -> dict:
    """The kernels inside one raycast of the rigid engine `eng` at its last
    pose, by name with calls and device ms: as KinFu._raycast runs it (the
    dispatch's formulation and margin), and the general sweep
    (`tv.raycast`) of the same volume and pose; beside them tsdf.slab_stack's
    copy alone, the stack the sweep read before csrc/slab_stack.cu."""
    p, pose = eng.params, eng.poses[-1]
    shape = (p.rows, p.cols)
    before = dict(kinfu_mod.FORMULATIONS)
    eng._raycast(pose)
    out = {"formulation": next(k for k, v in kinfu_mod.FORMULATIONS.items()
                               if k.startswith("raycast:")
                               and v != before.get(k, 0)),
           "margin": eng._raycast_margin(pose)}
    for name, fn in (("dispatch", lambda: eng._raycast(pose)),
                     ("general", lambda: tv.raycast(
                         eng.vol, pose, p.intr, shape, eng.tsdf_config))):
        got = kernel_list(fn)
        rows = got["kernels"]
        total = sum(r["device_ms"] for r in rows)
        out[name] = dict(kernel_ms=total, launches=sum(r["calls"]
                                                       for r in rows),
                         whole=got["whole"], kernels=rows)
        print(f"raycast kernels ({name}): {total:.4f} ms device in "
              f"{out[name]['launches']} launches (counts whole: "
              f"{got['whole']})", flush=True)
        for r in rows:
            print(f"  {r['device_ms']:.4f} ms  x{r['calls']}  {r['name']}",
                  flush=True)
    m = tv.sweep_spec("general", shape, eng.tsdf_config).m
    out["stack_copy"] = kernel_list(lambda: tv.slab_stack(eng.vol.tsdf, m))
    print(f"raycast kernels: tsdf.slab_stack's copy alone "
          f"{json.dumps(out['stack_copy'])}", flush=True)
    return out


def rigid_profile_phase():
    """utils/rigid_profile's profile of the 512^3 rigid frame (4 frames
    timed, 4 profiled, after 3 warm-up frames; uncounted): the raycast
    stage's host and kernel ms per frame beside the per-ray march's
    (216.385 / 17.810 on the H100, ROADMAP H1), and the frame's wall,
    kernel ms and idle share; then the kernels inside one raycast by name
    (`raycast_kernels`)."""
    from dynfu_tpu_torch.utils.fusion_profile import profile_engine
    from dynfu_tpu_torch.utils.rigid_profile import STAGES

    eng = KinFu(rigid_params(512), device=DEV)
    frames = [rigid_frame(i) for i in range(3 + 2 * 4)]
    out = profile_engine(eng, frames, 3, 4, "rigid/", STAGES)
    print("rigid_profile:", json.dumps({k: out[k] for k in (
        "card", "wall_ms_median", "kernel_ms_per_frame",
        "kernels_per_frame", "idle_share", "stages")}), flush=True)
    rc = out["stages"]["raycast"]
    print(f"rigid_profile: raycast {rc['host_ms']:.3f} ms host / "
          f"{rc['kernel_ms']:.3f} ms kernels per frame (the per-ray "
          f"march: 216.385 / 17.810, ROADMAP H1)", flush=True)
    print("rigid_profile raycast kernels:", json.dumps(raycast_kernels(eng)),
          flush=True)
    del eng
    torch.cuda.empty_cache()


def formulations_check():
    """Across the 512^3 paths of FORMULATION_PATHS, the source's separable,
    rotated and general sweeps and its rotated integrate each ran."""
    total = {}
    for path in FORMULATION_PATHS:
        for k, v in FORMULATIONS[path].items():
            total[k] = total.get(k, 0) + v
    print(f"formulations at 512^3 ({', '.join(FORMULATION_PATHS)}): "
          f"{json.dumps(total)}", flush=True)
    need = ("raycast:separable", "raycast:rotated", "raycast:sweep",
            "integrate:rotated")
    require(all(total.get(k, 0) > 0 for k in need),
            f"a formulation never ran at 512^3: {total}")


# main path -> its result, for the rows that compare with it
RESULTS = {}


def parity512_phase():
    res, got = run_path("parity512", lambda: run_benchmark(
        volume_dims=512, repeats=3, device=DEV))
    parity_checks(res, MAX_ERR512_MM, MAX_ERR512_3X_MM)
    RESULTS["parity512"] = res
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


def fusion_t512_phase():
    torch.cuda.reset_peak_memory_stats()
    res, got = run_path("fusion_t512", lambda: run_fusion_benchmark(
        volume_dims=512, device=DEV))
    fusion_checks(res, (MAX_T_WARPED_MM, MAX_T_WARPED_HALF_MM,
                        MAX_T_CANONICAL_MM), JAX_FUSION_T)
    return got


def umbrella_frame0():
    """Frame 0 of the umbrella row alone: the occupied cells its marching
    cubes drops at the preset's max_mc_voxels, the x extent of the
    canonical it keeps and its vertices in the foreground box, against
    frame 0's whole surface (no cell cap): why the row tracks nothing."""
    from dynfu_tpu_torch.io import kinect_sim
    from dynfu_tpu_torch.mesh.mc import marching_cubes

    dp = umbrella_params(512)
    eng = DynFusion(dp, device=DEV)
    eng(kinect_sim.umbrella_frame(0, frames=16))
    lo, hi = (torch.tensor(b, device=DEV) for b in dp.fg_aabb)

    def in_box(v):
        return int(((v >= lo) & (v < hi)).all(1).sum())

    c = eng.canonical
    kept = c.vertices[c.mask]
    _, _, dropped = marching_cubes(
        eng.vol, eng.tsdf_config, max_voxels=dp.max_mc_voxels,
        max_verts=dp.max_vertices, col_budget=dp.mc_col_budget)
    full, n_full, dropped_full = marching_cubes(
        eng.vol, eng.tsdf_config, max_voxels=1 << 21, max_verts=1 << 23,
        col_budget=511)
    full = full[:int(n_full)]
    out = {"max_mc_voxels": dp.max_mc_voxels,
           "cells_dropped": int(dropped),
           "canonical_vertices": int(kept.shape[0]),
           "canonical_x_m": [float(kept[:, 0].min()),
                             float(kept[:, 0].max())],
           "canonical_in_box": in_box(kept),
           "uncapped_cells_dropped": int(dropped_full),
           "uncapped_soup_vertices": int(n_full),
           "uncapped_x_m": [float(full[:, 0].min()), float(full[:, 0].max())],
           "uncapped_soup_in_box": in_box(full), "box": dp.fg_aabb}
    print("umbrella512 frame 0:", json.dumps(out), flush=True)
    del eng, full
    torch.cuda.empty_cache()


def umbrella_phase():
    umbrella_frame0()
    torch.cuda.reset_peak_memory_stats()
    res, got = run_path("umbrella512", lambda: run_umbrella_benchmark(
        512, device=DEV))
    print(f"umbrella512: frame_ms {res['frame_ms']}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    require(res["mc_dropped"] == 0, "umbrella: mc_dropped != 0")
    require(res["corr_dropped"] == 0, "umbrella: corr_dropped != 0")
    for key, bound in (("median_visible_err_mm", MAX_UMB_MEDIAN_MM),
                       ("p90_visible_err_mm", MAX_UMB_P90_MM)):
        require(res[key] <= bound, f"umbrella: {key} {res[key]} > {bound}")
    require(res["coverage_px"] >= MIN_UMB_COVERAGE_PX,
            f"umbrella: coverage_px {res['coverage_px']} < "
            f"{MIN_UMB_COVERAGE_PX}")
    return got


def fixed_run():
    """Fixed mode at 128^3 (run_benchmark(128)'s parameters) on the
    moving-camera scene: 3 warmup frames, then 12 timed, the breathing
    sphere's error half-way and at the end, the canonical's, the camera's
    distance from the truth; the loop of scripts/jax_fixed_reference.py,
    which runs the JAX package's fixed mode."""
    eng = DynFusion(bench_params(128), device=DEV, mode="fixed")
    half = FIXED_WARMUP + FIXED_FRAMES // 2 - 1
    last = FIXED_WARMUP + FIXED_FRAMES - 1
    frames = [movingcam_frame(i, FIXED_CAMERA) for i in range(last + 1)]

    def err(i):
        wv, wm = eng.warped_cloud(unique=True)
        return breathing_err_mm(wv[wm].cpu().numpy(), i)

    for i in range(FIXED_WARMUP):
        eng(frames[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FIXED_WARMUP, last + 1):
        eng(frames[i])
        if i == half:
            err_half = err(i)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / FIXED_FRAMES
    c, fs = eng.canonical, eng.last_frame_stats
    t = np.asarray(eng.poses[-1][1])
    return {"frame_ms": dt * 1e3, "warped_err_mm": err(last),
            "warped_err_half_motion_mm": err_half,
            "canonical_err_mm": breathing_err_mm(
                c.vertices[c.mask].cpu().numpy(), 0),
            "camera_err_mm": float(np.linalg.norm(
                t - (0.0, FIXED_CAMERA * last, 0.0))) * 1e3,
            "camera_t_m": t.tolist(), "mc_dropped": int(fs.mc_dropped),
            "corr_dropped": int(fs.corr_dropped)}


def fixed_phase():
    res, got = run_path("fixed128", fixed_run)
    print(f"fixed128: frame_ms {res['frame_ms']}", flush=True)
    require(res["mc_dropped"] == 0, "fixed128: mc_dropped != 0")
    require(res["corr_dropped"] == 0, "fixed128: corr_dropped != 0")
    for key, bound in FIXED_BOUNDS.items():
        require(res[key] <= bound, f"fixed128: {key} {res[key]} > {bound}")
    return got


UMBRELLA_DIR = Path(__file__).resolve().parent / "data" / "umbrella"
CLI_FRAMES, CLI_SPLIT = 16, 8


def cli_run(out: Path, *args, dims: int = 512) -> None:
    """`dynfu-torch run` over data/umbrella at dims^3, in this process (so
    that the launch counters can be read), into `out` (never the default
    <dataset>/out, which lies inside the checkout)."""
    from dynfu_tpu_torch.io import cli

    argv = ["run", str(UMBRELLA_DIR), "--volume-dims", str(dims), *args,
            "--out", str(out)]
    require(cli.main(argv) == 0, f"dynfu-torch {' '.join(argv)} failed")


def cli_inprocess(tmp: Path) -> dict:
    """DynFusion at the CLI's 512^3 parameters over the 16 frames without
    interruption, against one restored by load_checkpoint from the
    save_checkpoint after frame CLI_SPLIT - 1: the same bits in the volume,
    the warp field and the warped cloud. Returns the uninterrupted run's
    frame times (engine call and warped cloud, synchronized) and each
    frame's drop counters."""
    from dynfu_tpu_torch.io import app, meshio
    from dynfu_tpu_torch.io.native_loader import DepthLoader
    from dynfu_tpu_torch.utils.checkpoint import load_checkpoint, \
        save_checkpoint

    depths, _ = meshio.list_dataset(str(UMBRELLA_DIR))
    with DepthLoader(depths) as loader:
        native = loader.native
        frames = [loader[i] for i in range(len(loader))]
    require(len(frames) == CLI_FRAMES, f"{len(frames)} umbrella frames")
    params = app.dataset_params(frames[0].shape, 512)
    eng = DynFusion(params, device=DEV)
    ckpt = tmp / "inprocess.npz"
    ms, drops = [], []
    for i, d in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng(d)
        eng.warped_cloud()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        fs = eng.last_frame_stats
        drops.append(None if fs is None else
                     [int(fs.mc_dropped), int(fs.corr_dropped)])
        if i == CLI_SPLIT - 1:
            save_checkpoint(eng, str(ckpt))
    res = DynFusion(params, device=DEV)
    load_checkpoint(res, str(ckpt))
    require(res.frame_counter == CLI_SPLIT, "restored frame counter")
    for d in frames[CLI_SPLIT:]:
        res(d)
    pairs = [("vol.tsdf", eng.vol.tsdf, res.vol.tsdf),
             ("vol.weight", eng.vol.weight, res.vol.weight)]
    pairs += [(f"warpfield.{k}", v, getattr(res.warpfield, k))
              for k, v in eng.warpfield._asdict().items()]
    pairs += [(f"warped_cloud[{j}]", a, b) for j, (a, b) in
              enumerate(zip(eng.warped_cloud(), res.warped_cloud()))]
    for name, a, b in pairs:
        require(torch.equal(a, b), f"cli512: resumed {name} differs")
    return {"loader_native": native, "frame_ms": ms,
            "mc_dropped_corr_dropped": drops,
            "nodes": int(eng.warpfield.count),
            "bitwise_equal": [name for name, _, _ in pairs]}


def cli512_phase():
    """`dynfu-torch run data/umbrella --volume-dims 512 --export-viz` (the
    main path), then a run of CLI_SPLIT frames that checkpoints and its
    resumption over the rest, whose exports must be byte-equal to the whole
    run's, then the in-process resume against the uninterrupted engine.
    The CLI's default parameters apply no caps_for_volume preset at 512^3
    (2^14 cells, 2^16 vertices), so this row drops cells, as the JAX app
    does: no accuracy bound."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        a, b, c = tmp / "a", tmp / "b", tmp / "c"
        t0 = time.perf_counter()
        _, got = run_path("cli512", lambda: cli_run(a, "--export-viz"))
        wall = time.perf_counter() - t0
        counts = {pat: len(list(a.glob(pat))) for pat in
                  ("pcl_canonical_to_live*.pcd", "*_tsdf_mesh.vtk",
                   "*_tsdf_mesh.ply", "render*.png")}
        print(f"cli512: artifacts {json.dumps(counts)}, {wall:.1f} s with "
              "the kernel checks", flush=True)
        require(all(n == CLI_FRAMES for n in counts.values()),
                f"cli512: artifacts {counts}")
        cli_run(b, "--frames", str(CLI_SPLIT), "--checkpoint-every",
                str(CLI_SPLIT))
        cli_run(c, "--resume", str(b / "checkpoint.npz"))
        for i in range(CLI_SPLIT, CLI_FRAMES):
            for name in (f"pcl_canonical_to_live{i}.pcd",
                         f"{i}_tsdf_mesh.ply", f"{i}_tsdf_mesh.vtk"):
                require((c / name).read_bytes() == (a / name).read_bytes(),
                        f"cli512: resumed {name} differs")
        require(not (c / "pcl_canonical_to_live0.pcd").exists(),
                "cli512: the resumed run wrote frame 0")
        out = cli_inprocess(tmp)
    ms = out["frame_ms"]
    print(f"cli512: frame_ms {json.dumps(ms)} (median of frames 1-15 "
          f"{float(np.median(ms[1:]))}), DepthLoader.native "
          f"{out['loader_native']}, per frame [mc_dropped, corr_dropped] "
          f"{json.dumps(out['mc_dropped_corr_dropped'])}, nodes "
          f"{out['nodes']}, resumed bit-equal: {out['bitwise_equal']}",
          flush=True)
    return got


def cli_rigid512_phase():
    """`dynfu-torch run --rigid data/umbrella --volume-dims 512`: 16 pose
    rows, the mesh, and 19 stencil launches per ICP the engine ran (the
    ICPs counted at rigid/icp.estimate_transform_stencil)."""

    stencil_icp = icp.estimate_transform_stencil
    icps = []

    def counted(*a, **kw):
        icps.append(1)
        return stencil_icp(*a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "d"
        icp.estimate_transform_stencil = counted
        try:
            t0 = time.perf_counter()
            _, got = run_path("cli_rigid512", lambda: cli_run(d, "--rigid"))
            wall = time.perf_counter() - t0
        finally:
            icp.estimate_transform_stencil = stencil_icp
        traj = np.loadtxt(d / "trajectory.txt")
        mesh = (d / "rigid_mesh.ply").read_text().splitlines()[:4]
    print(f"cli_rigid512: {len(icps)} ICPs, {got['fetch_stencil']} stencil "
          f"launches, trajectory {list(traj.shape)}, final t "
          f"{traj[-1, 9:].tolist()}, mesh header {mesh}, {wall:.1f} s with "
          "the kernel checks", flush=True)
    require(traj.shape == (CLI_FRAMES, 12),
            f"cli_rigid512: trajectory shape {traj.shape}")
    require(mesh[0] == "ply" and int(mesh[2].split()[-1]) > 0,
            "cli_rigid512: rigid_mesh.ply has no vertices")
    want = len(icps) * STENCIL_PER_ICP
    require(len(icps) > 0 and got["fetch_stencil"] == want,
            f"cli_rigid512: {got['fetch_stencil']} stencil launches, not "
            f"{want}")
    return got


# --- the sharded parity engine (dist/) -------------------------------------

DIST_RANKS = 2
DIST_FRAMES = 3 + 3 * 12 + 3  # run_benchmark(512, repeats=3)'s frames
NCCL1_FRAMES = 6


def _dist_bench_rank(volume_dims: int, repeats: int) -> dict:
    """On every rank: run_benchmark on the sharded engine, then every rank's
    launch counts of that run (gathered after it)."""
    mesh = spmd.make_mesh()
    res = run_benchmark(volume_dims, repeats=repeats, mesh=mesh)
    local = torch.tensor([launches(n) for n in KERNELS], device=mesh.device)
    res["rank_launches"] = [dict(zip(KERNELS, c.tolist()))
                            for c in spmd.all_gather(local, mesh)]
    return res


def _frames(engine, n: int):
    """engine over the benchmark's first n frames: per frame the unique
    warped cloud and its mask (on the host) and the drop counts; the final
    node state."""
    out = []
    for i in range(n):
        engine(bench_frame(i))
        v, m = engine.warped_cloud(unique=True)
        fs = engine.last_frame_stats
        out.append((v.cpu(), m.cpu(), None if fs is None else
                    (int(fs.mc_dropped), int(fs.corr_dropped))))
    wf = (engine.engine if hasattr(engine, "engine") else engine).warpfield
    return out, wf.dqs.cpu(), int(wf.count)


def _dist_frames_rank(volume_dims: int, n: int):
    """On every rank: ShardedDynFusion over the first n frames (rank 0's
    return value is used)."""
    mesh = spmd.make_mesh()
    return _frames(ShardedDynFusion(bench_params(volume_dims), mesh=mesh),
                   n) + (mesh.backend, mesh.world)


class GramTies:
    """Around the single card's frames, records each Gram of the wrapper
    `name` (data_normal: A, b; monomial_grams: B, Bu, Bw); around rank 0's
    sharded frames, counts the entries of each reduced Gram (float64
    partials added in rank order, rounded once) that differ from the
    single card's of the same solve (the reductions of a cost alone are not
    Grams and are skipped)."""

    def __init__(self, name: str = "data_normal"):
        self.name = name
        self.ref, self.diff, self.saved = [], [], []

    def record(self):
        ties = self

        class Rec(Shim):  # the wrapper's counter stays the wrapper's
            def __init__(self, wrapper):
                self.wrapper = wrapper

            def __call__(self, *a, **kw):
                out = self.wrapper(*a, **kw)
                ties.ref.append(torch.cat([t.reshape(-1) for t in out]))
                return out
        wrapper = getattr(gram_cuda, self.name)
        self.saved.append((gram_cuda, self.name, wrapper))
        setattr(gram_cuda, self.name, Rec(wrapper))
        return self

    def count(self):
        reduce = shard_gram.reduce_rank_order

        def cnt(t, mesh):
            flat = reduce(t, mesh)
            if flat.numel() > 1:
                ref = self.ref[len(self.diff)]
                self.diff.append(int((flat[:ref.numel()] != ref).sum()))
            return flat
        self.saved.append((shard_gram, "reduce_rank_order", reduce))
        shard_gram.reduce_rank_order = cnt
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []


def _same_frames(a, b) -> list:
    """Per frame: the clouds, masks and drop counts bitwise equal."""
    return [torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
            and x[2] == y[2] for x, y in zip(a, b)]


def dist_parity512_phase():
    """The sharded parity engine at 512^3 (see the module's docstring)."""
    ties = GramTies()
    with ties.record():
        ref, ref_dqs, ref_count = _frames(
            DynFusion(bench_params(512), device=DEV), DIST_FRAMES)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res, got = run_path("dist_parity512", lambda: runtime.spawn(
        _dist_bench_rank, DIST_RANKS, 512, 3, inline=True))
    print(f"dist_parity512: {time.perf_counter() - t0:.1f} s with the kernel "
          "checks", flush=True)
    parity_checks(res, MAX_ERR512_MM, MAX_ERR512_3X_MM)
    single = RESULTS["parity512"]
    keys = ("median_vertex_err_mm", "err_after_3x_motion_mm")
    print(f"dist_parity512: {res['ranks']} ranks over {res['backend']} on "
          f"{torch.cuda.device_count()} card(s); accuracy "
          f"{[res[k] for k in keys]} against the single rank's "
          f"{[single[k] for k in keys]} (same bits: "
          f"{all(res[k] == single[k] for k in keys)}); frame_ms "
          f"{res['frame_ms']} (single rank {single['frame_ms']}), latency_ms "
          f"{res['latency_ms']} ({single['latency_ms']})", flush=True)
    for r, counts in enumerate(res["rank_launches"]):
        require(all(counts[n] > 0 for n in PATHS["dist_parity512"]),
                f"dist_parity512: rank {r} launched {counts}")

    with ties.count():
        shard, dqs, count, backend, world = runtime.spawn(
            _dist_frames_rank, DIST_RANKS, 512, DIST_FRAMES, inline=True)
    same = _same_frames(shard, ref)
    print(f"dist_parity512 frame by frame ({world} ranks, {backend}): "
          f"warped cloud, mask and drops bitwise the single card's in "
          f"{sum(same)} of {len(same)} frames; final DQs bitwise "
          f"{torch.equal(dqs, ref_dqs)}, nodes {count} ({ref_count}); data "
          f"Gram entries differing per frame {ties.diff} (total "
          f"{sum(ties.diff)} over {len(ties.diff)} solves)", flush=True)
    require(len(same) == DIST_FRAMES and all(
        x[2] in (None, (0, 0)) for x in shard),
        "dist_parity512: a frame dropped cells or correspondences")
    require(len(ties.diff) == len(ties.ref),
            f"dist_parity512: {len(ties.diff)} sharded solves, "
            f"{len(ties.ref)} single-card")

    nccl = runtime.spawn(_dist_frames_rank, 1, 512, NCCL1_FRAMES,
                         backend="nccl", inline=True)
    same1 = _same_frames(nccl[0], ref[:NCCL1_FRAMES])
    print(f"dist_parity512 world-1 {nccl[3]}: {sum(same1)} of "
          f"{NCCL1_FRAMES} frames bitwise the single card's", flush=True)
    require(nccl[3] == "nccl" and all(same1),
            "dist_parity512: the world-1 NCCL driver differs from the single "
            "card")

    if torch.cuda.device_count() >= DIST_RANKS:
        nres = runtime.spawn(_dist_bench_rank, DIST_RANKS, 512, 3,
                             backend="nccl", inline=True)
        parity_checks(nres, MAX_ERR512_MM, MAX_ERR512_3X_MM)
        print(f"dist_parity512 over nccl, one rank per card: "
              f"{json.dumps(nres)}", flush=True)
    else:
        print("dist_parity512: 1 card, so no NCCL run across cards",
              flush=True)
    over = sharding_overhead(DIST_RANKS)
    print(f"dist_parity512 sharding_overhead({DIST_RANKS}): "
          f"{json.dumps(over)} ({torch.cuda.device_count()} card(s); ranks "
          "sharing a card measure the collectives and the second process, "
          "not scaling)", flush=True)
    cli_devices_check()
    return got


# --- the sharded fusion engine (dist/, fusion mode) -------------------------

FUSION_FRAMES = 3 + 12  # run_fusion_benchmark(512)'s warm-up and frames
T128_FRAMES = 8  # the translations-only 128^3 frame-by-frame run


def _dist_fusion_rank(volume_dims: int, rotations: bool) -> dict:
    """On every rank: run_fusion_benchmark on the sharded engine, then every
    rank's launch counts of that run (gathered after it)."""
    mesh = spmd.make_mesh()
    res = run_fusion_benchmark(volume_dims, rotations=rotations, mesh=mesh)
    local = torch.tensor([launches(n) for n in KERNELS], device=mesh.device)
    res["rank_launches"] = [dict(zip(KERNELS, c.tolist()))
                            for c in spmd.all_gather(local, mesh)]
    return res


def _fusion_frames(engine, n: int):
    """engine (fusion mode) over the moving sphere's first n frames: per
    frame the canonical (vertices, normals, mask) and the warped cloud and
    its mask on the host, and the counters (mc_dropped, corr_dropped,
    n_band, n_captured, n_updated); the final node state."""
    out = []
    for i in range(n):
        engine(bench_frame(i))
        c = engine.canonical
        wv, wm = engine.warped_cloud()
        fs = engine.last_frame_stats
        out.append(((c.vertices.cpu(), c.normals.cpu(), c.mask.cpu(),
                     wv.cpu(), wm.cpu()), None if fs is None else
                    (int(fs.mc_dropped), int(fs.corr_dropped),
                     *(int(v) for v in fs.band))))
    wf = (engine.engine if hasattr(engine, "engine") else engine).warpfield
    return out, wf.dqs.cpu(), int(wf.count)


def _dist_fusion_frames_rank(volume_dims: int, rotations: bool, n: int):
    """On every rank: the fusion-mode ShardedDynFusion over the first n
    frames (rank 0's return value is used)."""
    mesh = spmd.make_mesh()
    return _fusion_frames(ShardedDynFusion(
        fusion_params(volume_dims, rotations=rotations), mode="fusion",
        mesh=mesh), n) + (mesh.backend, mesh.world)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits (NaNs compare by their bits too)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fusion_same(a, b) -> list:
    """Per frame: the canonical, the warped cloud and the counters bitwise
    equal."""
    return [all(torch.equal(_bits(x), _bits(y)) for x, y in zip(p[0], q[0]))
            and p[1] == q[1] for p, q in zip(a, b)]


def fusion_by_frame(volume_dims: int, rotations: bool, n: int, tag: str):
    """The sharded fusion engine over n frames against the single card's,
    frame by frame (uncounted): the canonical, the warped cloud and the
    counters bitwise, the final DQs; the Grams' entries that differ between
    the sharded reduction and the single card's (float64 rounding ties)
    counted. Any frame that differs needs a tie to explain it."""
    ties = GramTies("monomial_grams" if rotations else "data_normal")
    with ties.record():
        ref, ref_dqs, ref_count = _fusion_frames(DynFusion(
            fusion_params(volume_dims, rotations=rotations), device=DEV,
            mode="fusion"), n)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with ties.count():
        shard, dqs, count, backend, world = runtime.spawn(
            _dist_fusion_frames_rank, DIST_RANKS, volume_dims, rotations, n,
            inline=True)
    same = _fusion_same(shard, ref)
    print(f"{tag} frame by frame ({world} ranks, {backend}, "
          f"{time.perf_counter() - t0:.1f} s): canonical, warped cloud and "
          f"counters bitwise the single card's in {sum(same)} of "
          f"{len(same)} frames (differing: "
          f"{[i for i, x in enumerate(same) if not x]}); final DQs bitwise "
          f"{torch.equal(dqs, ref_dqs)}, nodes {count} ({ref_count}); "
          f"{ties.name} entries differing per solve {ties.diff} (total "
          f"{sum(ties.diff)} over {len(ties.diff)} solves); counters per "
          f"frame {[x[1] for x in shard]}", flush=True)
    require(len(ties.diff) == len(ties.ref),
            f"{tag}: {len(ties.diff)} sharded solves, {len(ties.ref)} "
            "single-card")
    require(all(same) and torch.equal(dqs, ref_dqs) or sum(ties.diff) > 0,
            f"{tag}: frames differ from the single card's with no Gram tie")
    require(all(x[1] is None or (x[1][0] == 0 and x[1][2] == x[1][3])
                for x in shard),
            f"{tag}: a frame dropped edges or band voxels")
    return dict(frames_bitwise=sum(same), frames=len(same),
                gram_entries_differing=ties.diff)


def dist_fusion512_phase():
    """The sharded fusion engine: run_fusion_benchmark(512, rotations=True)
    on 2 ranks (rank 0 counted), its bounds and every rank's launches;
    then, uncounted, the same frames against the single card frame by
    frame, and the translations-only 128^3 run (marching cubes, the pack,
    extract_normals on a block, the data Gram's partial mode) likewise."""
    t0 = time.perf_counter()
    res, got = run_path("dist_fusion512", lambda: runtime.spawn(
        _dist_fusion_rank, DIST_RANKS, 512, True, inline=True))
    print(f"dist_fusion512: {time.perf_counter() - t0:.1f} s with the kernel "
          "checks", flush=True)
    fusion_checks(res, (MAX_WARPED_MM, MAX_WARPED_HALF_MM, MAX_CANONICAL_MM),
                  JAX_FUSION)
    single = RESULTS["fusion"]
    keys = ("warped_err_mm", "warped_err_half_motion_mm", "canonical_err_mm",
            "corr_dropped", "n_band")
    print(f"dist_fusion512: {res['ranks']} ranks over {res['backend']} on "
          f"{torch.cuda.device_count()} card(s); "
          f"{[res[k] for k in keys]} against the single rank's "
          f"{[single[k] for k in keys]} (same: "
          f"{all(res[k] == single[k] for k in keys)}); frame_ms "
          f"{res['frame_ms']} (single rank {single['frame_ms']})",
          flush=True)
    for r, counts in enumerate(res["rank_launches"]):
        require(all(counts[n] > 0 for n in PATHS["dist_fusion512"]),
                f"dist_fusion512: rank {r} launched {counts}")
    t1 = time.perf_counter()
    by512 = fusion_by_frame(512, True, FUSION_FRAMES, "dist_fusion512")
    by128 = fusion_by_frame(128, False, T128_FRAMES, "dist_fusion_t128")
    print(f"dist_fusion512: frame-by-frame checks "
          f"{time.perf_counter() - t1:.1f} s; 512^3 SE(3) "
          f"{json.dumps(by512)}; 128^3 translations "
          f"{json.dumps(by128)}", flush=True)
    return got


# --- the sharded fusion step (dist/spmd.sharded_fusion_step) ----------------

STEP_FRAMES = 8  # frames 1-8 of the moving sphere through the step
STEP_MOTION = 0.004  # the seeded node motions' scale (rad, m)


def _step_state():
    """bench_params(512) at 640x480: the single-card parity DynFusion's
    frame 0 on the moving sphere and its warp field, its nodes moved from
    the volume frame into the camera frame (the step's raycast points are
    in the camera frame; the camera is at the identity), each node's DQ a
    seeded small motion (frame 0's DQs are the identity, under which the
    step's solve sees no residual: it solves for the warp's own
    displacement). Returns the step's arguments (config, intrinsics, shape,
    solver_kwargs from the DynFuParams' GN fields, as the parity frame
    passes them) and its state (warp field, volume pose, camera pose) on
    the host."""
    p = bench_params(512)
    eng = DynFusion(p, device=DEV)
    eng(bench_frame(0))
    wf = eng.warpfield
    gen = torch.Generator().manual_seed(5)
    D = wf.pos.shape[0]
    moved = dq.dq_from_rodrigues(
        torch.randn(D, 3, generator=gen) * STEP_MOTION,
        torch.randn(D, 3, generator=gen) * STEP_MOTION)
    mask = wf.mask.cpu()[:, None]
    dqs = torch.where(mask, moved, wf.dqs.cpu())
    pos = wf.pos.cpu() @ eng.vol.pose_r.cpu().T + eng.vol.pose_t.cpu()
    pos = torch.where(mask, pos, wf.pos.cpu())
    solver = dict(tukey_offset=p.tukey_offset, psi_data=p.psi_data,
                  lambda_reg=p.lambda_reg, psi_reg=p.psi_reg,
                  linear_iter=p.solver.linear_iter, knn_k=p.knn,
                  nonlinear_iter=p.solver.nonlinear_iter,
                  num_iter=p.solver.num_iter, early_out=p.solver.early_out)
    out = dict(config=eng.tsdf_config, intr=p.kinfu.intr,
               shape=(p.kinfu.rows, p.kinfu.cols), solver_kwargs=solver,
               wf=tuple(t.cpu() for t in wf._replace(pos=pos, dqs=dqs)),
               vol_pose=(eng.vol.pose_r.cpu(), eng.vol.pose_t.cpu()),
               cam=tuple(torch.as_tensor(t).cpu() for t in eng.poses[-1]))
    del eng
    torch.cuda.empty_cache()
    return out


def _step_frames(mesh, st) -> dict:
    """sharded_fusion_step over frames 1..STEP_FRAMES on `mesh`: per frame
    its ms (synced), and on rank 0 every rank's raycast (points, normals),
    the warped rows of all ranks in rank order, every rank's DQs,
    SolveStats, straddling hits and valid rows, on the host (gathered
    after the timed step); every rank's launches after the run."""
    H, W = st["shape"]
    step = spmd.sharded_fusion_step(mesh, st["config"], st["intr"],
                                    st["shape"], st["solver_kwargs"])
    dev = mesh.device
    vol = spmd.shard_volume(tv.create(st["config"], st["vol_pose"],
                                      device=dev), mesh)
    wf = wfield.WarpField(*(t.to(dev) for t in st["wf"]))
    cam = tuple(t.to(dev) for t in st["cam"])
    out = {"ms": [], "frames": []}
    for i in range(1, STEP_FRAMES + 1):
        depth = torch.as_tensor(bench_frame(i).astype(np.int32), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol, wf, warped, stats = step(vol, depth, wf, cam)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        pts, nrm, n_straddle = step.last_raycast
        every = [spmd.all_gather(t, mesh) for t in (
            pts, nrm, wf.dqs,
            torch.stack([x.to(torch.float64) for x in stats]),
            torch.stack([n_straddle, (~torch.isnan(warped[:, 0])).sum()]))]
        rows = spmd.all_gather_rows(warped, mesh, H * W)
        if mesh.rank == 0:
            out["frames"].append(dict(
                points=[t.cpu() for t in every[0]],
                normals=[t.cpu() for t in every[1]],
                dqs=[t.cpu() for t in every[2]],
                stats=[t.tolist() for t in every[3]],
                straddle=[int(t[0]) for t in every[4]],
                rows=[int(t[1]) for t in every[4]], warped=rows.cpu()))
    local = torch.tensor([launches(n) for n in KERNELS], device=dev)
    out["rank_launches"] = [dict(zip(KERNELS, c.tolist()))
                            for c in spmd.all_gather(local, mesh)]
    return out


def _dist_step_rank(st) -> dict:
    return _step_frames(spmd.make_mesh(), st)


class Reductions:
    """Around the single rank's steps, records every flat reduction of
    shard_gram.reduce_rank_order with more than one entry (the data Gram
    with b and c0); around rank 0's sharded steps, counts each one's entries
    that differ from the single rank's of the same solve (float64 rounding
    ties)."""

    def __init__(self):
        self.ref, self.diff, self.saved = [], [], None

    def _patch(self, fn):
        self.saved = shard_gram.reduce_rank_order
        shard_gram.reduce_rank_order = fn
        return self

    def record(self):
        reduce = shard_gram.reduce_rank_order

        def rec(t, mesh):
            flat = reduce(t, mesh)
            if flat.numel() > 1:
                self.ref.append(flat.clone())
            return flat
        return self._patch(rec)

    def count(self):
        reduce = shard_gram.reduce_rank_order

        def cnt(t, mesh):
            flat = reduce(t, mesh)
            if flat.numel() > 1:
                ref = self.ref[len(self.diff)]
                self.diff.append(int((flat.view(torch.int32)
                                      != ref.view(torch.int32)).sum()))
            return flat
        return self._patch(cnt)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shard_gram.reduce_rank_order = self.saved


def dist_step512_phase():
    """spmd.sharded_fusion_step at 512^3 and 640x480 (see the module's
    docstring): the single rank's steps first (uncounted), then 2 ranks
    (rank 0 counted, every rank's launches gathered), held against them
    frame by frame."""
    t0 = time.perf_counter()
    st = _step_state()
    red = Reductions()
    with red.record():
        one = _step_frames(spmd.Mesh(0, 1, DEV, None), st)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    sharded = {}

    def run():  # the frames stay here; run_path prints the rest
        out = runtime.spawn(_dist_step_rank, DIST_RANKS, st, inline=True)
        sharded["frames"] = out.pop("frames")
        return out
    with red.count():
        res, got = run_path("dist_step512", run)
    t2 = time.perf_counter()
    world = len(res["rank_launches"])
    checks = {"raycast": [], "warped rows": [], "node state": [],
              "stats": []}
    for f1, f2 in zip(one["frames"], sharded["frames"]):
        ref_p, ref_n = (_bits(f1[k][0]) for k in ("points", "normals"))
        checks["raycast"].append(all(
            torch.equal(_bits(a), ref_p) and torch.equal(_bits(b), ref_n)
            for a, b in zip(f2["points"], f2["normals"])))
        checks["warped rows"].append(torch.equal(_bits(f2["warped"]),
                                                 _bits(f1["warped"])))
        checks["node state"].append(all(torch.equal(d, f1["dqs"][0])
                                        for d in f2["dqs"]))
        checks["stats"].append(all(x == f1["stats"][0]
                                   for x in f2["stats"]))
    bitwise = [all(c) for c in zip(*checks.values())]
    costs = [f["stats"][0][:2] for f in sharded["frames"]]
    straddle = [f["straddle"][0] for f in sharded["frames"]]
    rows = [f["rows"] for f in sharded["frames"]]
    print(f"dist_step512: sharded_fusion_step, bench_params(512) at 640x480,"
          f" frames 1-{STEP_FRAMES} of the moving sphere from the parity "
          f"engine's frame-0 warp field with seeded motions, on 1 rank and "
          f"on {world} ranks over {runtime.choose_backend('cuda', world)} "
          f"on {torch.cuda.device_count()} card(s): frames bitwise the "
          f"single rank's {sum(bitwise)} of {STEP_FRAMES} ("
          + ", ".join(f"{k} {sum(v)}" for k, v in checks.items())
          + f"); data Gram entries differing per solve {red.diff} (total "
          f"{sum(red.diff)} over {len(red.diff)}); (initial, final) cost "
          f"per frame {costs}; valid rows per rank {rows}; hits whose "
          f"crossing pair straddles the block face {straddle}", flush=True)
    print(f"dist_step512: frame_ms 1 rank {one['ms']} (median "
          f"{float(np.median(one['ms'])):.2f}), {world} ranks {res['ms']} "
          f"(median {float(np.median(res['ms'])):.2f}); seconds: setup and "
          f"1 rank {t1 - t0:.1f}, {world} ranks with the kernel checks "
          f"{t2 - t1:.1f}", flush=True)
    require(len(red.diff) == len(red.ref) == STEP_FRAMES,
            f"dist_step512: {len(red.diff)} sharded Gram reductions, "
            f"{len(red.ref)} single-rank")
    require(all(bitwise),
            "dist_step512: a frame differs from the single rank's")
    require(sum(red.diff) == 0, "dist_step512: Gram entries differ")
    require(all(c1 <= c0 for c0, c1 in costs),
            "dist_step512: the cost grew in a solve")
    require(all(min(r) > 0 for r in rows),
            "dist_step512: a rank had no valid rows")
    for r, counts in enumerate(res["rank_launches"]):
        require(all(counts[n] > 0 for n in PATHS["dist_step512"]),
                f"dist_step512: rank {r} launched {counts}")
    return got


# --- the rest of the source's public surface ---------------------------------

CORR_BLOCK = 4096  # nn1_gather_xwindow's block (the engine's)
CORR_WB = 1  # DynFuParams.corr_window_blocks
CORR_BLOCK_P = 1 << 19  # beyond the source's envelope of 270,336 points


def _corr_block_scene(rng, P: int = CORR_BLOCK_P):
    """P points on a 0.5 m sphere and queries 2 mm off them."""
    u = rng.normal(size=(P, 3))
    pts = (0.5 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(
        np.float32)
    qs = (pts + rng.normal(0, 0.002, pts.shape)).astype(np.float32)
    return pts, qs


def corr_block_phase() -> list:
    """The 1-NN kernel at the block placement (knn.block_placement, the
    source's XLA path beyond its kernel's envelope): P = Q = 524,288 points
    on a 0.5 m sphere, sorted along x, the queries 2 mm off, one window of
    DynFuParams.corr_window_blocks block(s) of 4096 points per block of
    4096 queries, fetching the points (F = 3) and a 33-column payload; the
    kernel against its plain version (rows and certificates equal), timed
    beside row 3's tile placement."""
    pts, qs = _corr_block_scene(np.random.default_rng(1))
    pts, qs = (a[np.argsort(a[:, 0], kind="stable")] for a in (pts, qs))
    P = pts.shape[0]
    qsP, psP, lo, pre, suf = knn.block_placement(
        torch.as_tensor(qs, device=DEV), torch.as_tensor(pts, device=DEV),
        CORR_WB, CORR_BLOCK, False)
    lo_el = (lo * CORR_BLOCK).to(torch.int32)
    W = CORR_WB * CORR_BLOCK
    rows = []
    for F in (3, 33):
        pay = psP if F == 3 else torch.cat([
            torch.rand((P, F), device=DEV),
            torch.zeros((psP.shape[0] - P, F), device=DEV)])
        args = (qsP, psP, lo_el, pre, suf, CORR_BLOCK, W, pay.contiguous())
        exact = corr_cuda.nn1_window_sweep(*args)[1]
        print(f"corr_block: P = Q = {P}, F = {F}, tile {CORR_BLOCK} queries, "
              f"window {W} points, certified {int(exact.sum())} of {P}",
              flush=True)
        row = measure("nn1_window_sweep", *corr_case(args))
        rows.append(dict(row, F=F, tq=CORR_BLOCK, window=W,
                         certified=int(exact.sum())))
    return rows


# a query block that is no multiple of the 1-NN kernel's 256-query tiles
ODD_BLOCK = 1000


def xwindow_block_phase():
    """knn.nn1_gather_xwindow beyond the source's envelope: P = Q = 524,288
    (the points shuffled, the queries in x-major order by 512^3 voxel
    planes over 3 m, as an extraction emits them), the 22-column payload,
    the 512^3 parity preset's tiers (escalate 8192, rescue 2048, one-block
    windows), and again with blocks of ODD_BLOCK queries, which the sweep
    pads to its 256-query tiles. The block placement must run, through the
    kernel (no plain version on the card, for either block); then,
    uncounted, the same call at the tile placement (the envelope raised):
    every query certified by both fetches the same row (the true 1-NN, the
    same tie rule). The certified counts are printed, not bounded (a
    synthetic full sphere; the tiers' capacities are the preset's)."""
    rng = np.random.default_rng(4)
    pts, qs = _corr_block_scene(rng)
    qs = qs[np.lexsort((rng.random(qs.shape[0]),
                        np.floor(qs[:, 0] / (3.0 / 512))))]
    pts = pts[rng.permutation(pts.shape[0])]
    P = pts.shape[0]
    p_t, q_t = (torch.as_tensor(a, device=DEV) for a in (pts, qs))
    vals = torch.rand((P, 22), device=DEV)
    dp = bench_params(512)
    kw = dict(rescue=dp.corr_rescue, escalate=dp.corr_escalate,
              window_blocks=dp.corr_window_blocks)

    def run():
        out, exact = knn.nn1_gather_xwindow(q_t, p_t, vals, **kw)
        odd = knn.nn1_gather_xwindow(q_t, p_t, vals, **dict(
            kw, block=ODD_BLOCK))
        torch.cuda.synchronize()
        run.got = (out, exact), odd
        return {"P": P, "Q": P, "F": 22, "certified": int(exact.sum()),
                f"certified_block{ODD_BLOCK}": int(odd[1].sum())}
    res, got = run_path("xwindow_block", run)
    (out_b, ex_b), (out_o, ex_o) = run.got
    saved = knn.TILE_MAX_POINTS
    knn.TILE_MAX_POINTS = P
    try:
        out_t, ex_t = knn.nn1_gather_xwindow(q_t, p_t, vals, **kw)
    finally:
        knn.TILE_MAX_POINTS = saved
    both = ex_b & ex_t
    same = bool(torch.equal(out_b[both], out_t[both]))
    both_o = ex_o & ex_t
    same_o = bool(torch.equal(out_o[both_o], out_t[both_o]))
    print(f"xwindow_block: blocks of {ODD_BLOCK} queries (tiles of "
          f"{-(-ODD_BLOCK // 256) * 256}): certified {int(ex_o.sum())}; rows "
          f"of the {int(both_o.sum())} certified with the tile placement "
          f"equal: {same_o}", flush=True)
    print(f"xwindow_block: certified {int(ex_b.sum())} of {P} at the block "
          f"placement, {int(ex_t.sum())} at the tile placement; rows of the "
          f"{int(both.sum())} certified by both equal: {same}; placements "
          f"{PLACEMENTS['xwindow_block']}", flush=True)
    require(PLACEMENTS["xwindow_block"] == {"block": 2},
            f"xwindow_block: placements {PLACEMENTS['xwindow_block']}")
    require(same and int(both.sum()) > 0, "xwindow_block: a certified row "
            "differs from the tile placement's")
    require(same_o and int(both_o.sum()) > 0, f"xwindow_block: blocks of "
            f"{ODD_BLOCK}: a certified row differs from the tile placement's")
    return got


# the umbrella's full scene (foreground=False): JAX's corr_dropped on a TPU
# (RESULTS.md:194) and the card's on the tile placement before the block
# placement existed. Its correspondence searches the 65,536-vertex warped
# canonical (the 518,602 live vertices are the queries), inside the
# source's envelope: the source ran its kernel there
JAX_UMBRELLA_FULL_DROPPED = 9034
CARD_UMBRELLA_FULL_DROPPED = 9810


def umbrella_full512_phase():
    """run_umbrella_benchmark(512, foreground=False): the whole scene is
    tracked. corr_dropped is printed beside JAX's on a TPU, unbounded
    (another chip's float32 roundoff through 11 frames), with the
    correspondence's placement (the tile placement, as the source's
    dispatch picks for its points)."""
    res, got = run_path("umbrella_full512", lambda: run_umbrella_benchmark(
        512, foreground=False, device=DEV))
    placed = PLACEMENTS["umbrella_full512"]
    print(f"umbrella_full512: corr_dropped {res['corr_dropped']} (the JAX "
          f"package on a TPU: {JAX_UMBRELLA_FULL_DROPPED}; the card before "
          f"the block placement existed: {CARD_UMBRELLA_FULL_DROPPED}), "
          f"mc_dropped {res['mc_dropped']}, "
          f"median / p90 visible error {res['median_visible_err_mm']} / "
          f"{res['p90_visible_err_mm']} mm over {res['coverage_px']} px, "
          f"tracked vertices {res['tracked_vertices']}, live vertices "
          f"{res['live_vertices']}, nodes {res['nodes']}, frame_ms "
          f"{res['frame_ms']}; correspondence placements {placed}, 1-NN "
          f"kernel launches {got['nn1_window_sweep']}", flush=True)
    require(np.isfinite(res["median_visible_err_mm"]),
            "umbrella_full512: no visible error")
    return got


KNN_Q = 1 << 18  # the parity 512^3 live set's size
KNN_SAMPLE = 4096


def _f64_nearest(q, p, mask=None, k: int = 2, chunk: int = 256):
    """Float64 brute force on the card: (d (S, k+1), idx (S, k+1)) the k+1
    smallest squared distances of each query and their points."""
    q64, p64 = q.double(), p.double()
    ds, js = [], []
    for i in range(0, q64.shape[0], chunk):
        d = ((q64[i:i + chunk, None, :] - p64[None]) ** 2).sum(-1)
        if mask is not None:
            d = torch.where(mask[None], d, torch.inf)
        v, j = torch.topk(d, k + 1, dim=1, largest=False)
        ds.append(v)
        js.append(j)
    return torch.cat(ds), torch.cat(js)


def _roundoff(q, p_sel, center=None):
    """The float32 distance forms' bound: 1e-6 of |q|^2 + |p|^2, in the
    coordinates the function computes in (centred on `center`)."""
    c = 0.0 if center is None else center.double()
    return 1e-6 * (((q.double() - c) ** 2).sum(-1)
                   + ((p_sel.double() - c) ** 2).sum(-1))


def knn_variants_phase() -> dict:
    """ops/knn's k-NN functions on the card at the engine's sizes: k = 8 of
    1024 nodes for 262,144 queries (knn_blocked, nn1_blocked), and the 1-NN
    fetches over 262,144 surface points with the 22-column payload
    (nn1_gather_sorted, nn1_gather). Each is checked on a 4096-query
    sample against a float64 brute force on the card: its selections are
    the exact ones wherever the exact order is decided by more than the
    float32 forms' roundoff (1e-6 of |q|^2 + |p|^2, in the coordinates the
    function computes in: the 1-NN fetches centre on the cloud), and every
    distance it returns lies within that bound of the exact distance of its
    pick, which lies within it of the exact minimum. ms by CUDA events."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(KNN_Q, 3))
    surf = (0.5 * u / np.linalg.norm(u, axis=1, keepdims=True)
            + np.asarray([1.5, 1.5, 1.0])).astype(np.float32)
    pts = torch.as_tensor(surf, device=DEV)
    qs = pts[torch.randperm(KNN_Q, device=DEV)] + 0.003 * torch.randn(
        (KNN_Q, 3), device=DEV)
    nodes = pts[torch.randperm(KNN_Q, device=DEV)[:1024]].contiguous()
    nmask = torch.rand(1024, device=DEV) > 0.05
    pmask = torch.rand(KNN_Q, device=DEV) > 0.02
    payload = torch.rand((KNN_Q, 22), device=DEV)
    sample = torch.randperm(KNN_Q, device=DEV)[:KNN_SAMPLE]
    qsam = qs[sample]
    out = {}

    def check(name, picks, dists, ref_p, ref_mask, k, center=None):
        d64, j64 = _f64_nearest(qsam, ref_p, ref_mask, k)
        tol = _roundoff(qsam[:, None, :].expand(-1, k, -1), ref_p[picks],
                        center)
        d_pick = ((qsam[:, None, :].double()
                   - ref_p[picks].double()) ** 2).sum(-1)
        decided = (d64[:, 1:] - d64[:, :-1]) > 2 * _roundoff(
            qsam[:, None, :].expand(-1, k, -1), ref_p[j64[:, :-1]], center)
        decided = torch.cumprod(decided.to(torch.int8), 1).bool()
        same = (picks == j64[:, :k]) | ~decided
        near = (d_pick - d64[:, :k]).abs() <= 2 * tol
        err = None
        if dists is not None:
            err = float(((dists.double() - d_pick).abs() / tol).max())
            require(err <= 1.0, f"knn_variants {name}: a distance beyond "
                    "the roundoff bound")
        require(bool(same.all()) and bool(near.all()),
                f"knn_variants {name}: a selection differs from the float64 "
                f"brute force ({int((~same).sum())} decided picks, "
                f"{int((~near).sum())} beyond the bound)")
        return dict(decided_picks=int(decided.sum()),
                    picks=int(decided.numel()),
                    max_dist_err_over_bound=err)

    for name, fn, k in (
            ("knn_blocked", lambda: knn.knn_blocked(qs, nodes, 8, nmask), 8),
            ("nn1_blocked", lambda: knn.nn1_blocked(qs, nodes, nmask), 1)):
        idx, sqd = fn()
        idx, sqd = idx.reshape(KNN_Q, k), sqd.reshape(KNN_Q, k)
        row = check(name, idx[sample], sqd[sample], nodes, nmask, k)
        out[name] = dict(row, ms=cuda_ms(fn, iters=5, warmup=1), Q=KNN_Q,
                         D=1024, k=k)
    center = pts.mean(0)  # the 1-NN fetches' centring
    idx, vals = knn.nn1_gather(qs, pts, payload, pmask)
    row = check("nn1_gather", idx[sample, None], None, pts, pmask, 1, center)
    require(torch.equal(vals, payload[idx]), "nn1_gather: rows not fetched")
    out["nn1_gather"] = dict(row, ms=cuda_ms(
        lambda: knn.nn1_gather(qs, pts, payload, pmask), iters=3, warmup=1),
        Q=KNN_Q, P=KNN_Q, F=22)
    vals, exact = knn.nn1_gather_sorted(qs, pts, payload, pmask)
    d64, j64 = _f64_nearest(qsam, pts, pmask, 1)
    ok = exact[sample] & ((d64[:, 1] - d64[:, 0])
                          > 2 * _roundoff(qsam, pts[j64[:, 0]], center))
    require(bool((vals[sample][ok] == payload[j64[ok, 0]]).all()),
            "nn1_gather_sorted: a certified row is not the nearest's")
    out["nn1_gather_sorted"] = dict(
        certified=int(exact.sum()), decided_sample=int(ok.sum()),
        ms=cuda_ms(lambda: knn.nn1_gather_sorted(qs, pts, payload, pmask),
                   iters=3, warmup=1), Q=KNN_Q, P=KNN_Q, F=22)
    print("knn_variants:", json.dumps(out), flush=True)
    require(out["nn1_gather_sorted"]["certified"] > KNN_Q // 2,
            "nn1_gather_sorted certified less than half of its queries")
    require(all(r.get("decided_picks", r.get("decided_sample", 0))
                > KNN_SAMPLE // 2 for r in out.values()),
            "knn_variants: fewer than half the sample's picks decided")
    return out


def bitplanes512_phase() -> dict:
    """The parity 512^3 frame's integrate and edge stage, the edges read
    from the volume and from the planes integrate_separable emits: the
    vertices, count and drops bitwise; each stage's ms by CUDA events."""
    dp = bench_params(512)
    eng = DynFusion(dp, device=DEV)
    eng(bench_frame(0))
    intr, cfg, pose = eng.params.intr, eng.tsdf_config, eng.poses[-1]
    dists = imgproc.compute_dists(torch.as_tensor(
        bench_frame(1).astype(np.int32), device=DEV), intr)
    vol, planes = tv.integrate_separable(eng.vol, dists, pose, intr, cfg,
                                         fresh=True, emit_bitplanes=True)
    kw = dict(max_edges=dp.max_edge_verts or dp.max_vertices // 2,
              convention="center",
              col_budget=dp.edge_col_budget or dp.mc_col_budget)
    want = edges.isosurface_edge_vertices(vol, cfg, **kw)
    got = edges.isosurface_edge_vertices(vol, cfg, bitplanes=planes, **kw)
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    out = {
        "n_edges": int(want[1]), "dropped": int(want[2]), "bitwise": same,
        "integrate_ms": cuda_ms(lambda: tv.integrate_separable(
            vol, dists, pose, intr, cfg, fresh=True), iters=5, warmup=1),
        "integrate_emit_ms": cuda_ms(lambda: tv.integrate_separable(
            vol, dists, pose, intr, cfg, fresh=True, emit_bitplanes=True),
            iters=5, warmup=1),
        "edges_volume_ms": cuda_ms(lambda: edges.isosurface_edge_vertices(
            vol, cfg, **kw), iters=5, warmup=1),
        "edges_planes_ms": cuda_ms(lambda: edges.isosurface_edge_vertices(
            vol, cfg, bitplanes=planes, **kw), iters=5, warmup=1)}
    print("bitplanes512:", json.dumps(out), flush=True)
    require(same, "bitplanes512: the edges from the planes differ")
    require(out["n_edges"] > 0, "bitplanes512: no edge vertices")
    del eng, vol, planes
    torch.cuda.empty_cache()
    return out


NONSTRICT_FRAMES = 4
# the non-strict sharded frame's variants: (DynFuParams changes, integrate)
NONSTRICT = {"gn": ({}, "separable"),
             "se3": (dict(solver_rotations=True), "rotated")}


def _nonstrict_state() -> dict:
    """Fixed mode's frame 0 at bench_params(128) on the moving sphere, on
    the host: the volume, warp field, canonical, multiplicities and pose
    the non-strict frames start from."""
    eng = DynFusion(bench_params(128), device=DEV, mode="fixed")
    eng(bench_frame(0))
    c = eng.canonical
    st = dict(vol=tuple(t.cpu() for t in eng.vol),
              wf=tuple(t.cpu() for t in eng.warpfield),
              canonical=tuple(t.cpu() for t in (c.vertices, c.normals,
                                                 c.mask)),
              mult=(None if eng.canonical_mult is None
                    else eng.canonical_mult.cpu()),
              pose=tuple(torch.as_tensor(t).cpu() for t in eng.poses[-1]),
              intr=eng.params.intr, cfg=eng.tsdf_config)
    del eng
    return st


def _nonstrict_frames(st, variant: str, mesh=None,
                      unsharded: bool = False) -> dict:
    """sharded_engine_frame(strict_parity=False) over frames
    1..NONSTRICT_FRAMES on `mesh` (the process group's when None), the pose
    held: per frame, on rank 0, the whole volume, the warped canonical and
    its normals, the live set and its normals, the DQs, the node count, the
    drops and the solve's stats on the host; every rank's launches. With
    `unsharded` (a 1-rank mesh) the single card's own non-strict
    `_nonrigid_frame` runs in its place, with no ShardKernels."""
    mesh = spmd.make_mesh() if mesh is None else mesh
    extra, mode = NONSTRICT[variant]
    dp = dataclasses.replace(bench_params(128), **extra)
    dev = mesh.device
    if unsharded:
        def step(vol, wf, cv, cn, cm, depth, pose, mult):
            (vol, wf, wv, wn, (lv, ln, lm), (mv, nv),
             stats) = dyn._nonrigid_frame(
                vol, wf, cv, cn, cm, depth, pose, dp=dp, intr=st["intr"],
                config=st["cfg"], parity=False, canonical_mult=mult,
                kernels=None, integrate_mode=mode)
            return vol, wf, wv, wn, lv, ln, lm, mv, nv, stats
    else:
        step = engine_spmd.sharded_engine_frame(
            mesh, dp, st["intr"], st["cfg"], strict_parity=False,
            integrate_mode=mode, with_mult=True)
    cv, cn, cm = st["canonical"]
    vol, wf, cv, cn, cm, _, pose = engine_spmd.place_engine_state(
        mesh, tv.TsdfVolume(*st["vol"]), wfield.WarpField(*st["wf"]), cv, cn,
        cm, bench_frame(0), tuple(t.to(dev) for t in st["pose"]))
    mult = None if st["mult"] is None else st["mult"].to(dev)
    N, X = cv.shape[0], st["cfg"].dims[0]
    out = {"frames": [], "ms": []}
    for i in range(1, NONSTRICT_FRAMES + 1):
        depth = torch.as_tensor(bench_frame(i).astype(np.int32), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (vol, wf, wv, wn, live_v, live_n, live_m, _, _, stats) = step(
            vol, wf, cv, cn, cm, depth, pose, mult)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        full = spmd.gather_volume(vol, mesh, X)
        rec = dict(tsdf=full.tsdf, weight=full.weight,
                   wv=spmd.all_gather_rows(wv, mesh, N),
                   wn=spmd.all_gather_rows(wn, mesh, N),
                   live=spmd.all_gather_rows(live_v[live_m], mesh),
                   live_n=spmd.all_gather_rows(live_n[live_m], mesh),
                   dqs=wf.dqs, count=wf.count, mc=stats.mc_dropped,
                   corr=stats.corr_dropped,
                   solve=torch.stack([torch.as_tensor(
                       x, dtype=torch.float64, device=dev).reshape(())
                       for x in stats.solve]))
        if mesh.rank == 0:
            out["frames"].append({k: v.cpu() for k, v in rec.items()})
    local = torch.tensor([launches(n) for n in KERNELS], device=dev)
    out["rank_launches"] = [dict(zip(KERNELS, c.tolist()))
                            for c in spmd.all_gather(local, mesh)]
    return out


def dist_nonstrict_phase():
    """The non-strict sharded engine frame (strict_parity=False) at
    bench_params(128), from fixed mode's frame 0 over frames 1-4 of the
    moving sphere with the pose held, in both variants (the GN solve with
    the separable integrate; DLB and the SE(3) solve with the rotated
    integrate): the single card's unsharded non-strict frame and 1 rank in
    this process (uncounted), then 2 ranks (rank 0 counted); every frame
    of 1 rank bitwise the unsharded frame's, and of 2 ranks the 1 rank's."""
    st = _nonstrict_state()
    card = {v: _nonstrict_frames(st, v, spmd.Mesh(0, 1, DEV, None),
                                 unsharded=True) for v in NONSTRICT}
    one = {v: _nonstrict_frames(st, v, spmd.Mesh(0, 1, DEV, None))
           for v in NONSTRICT}
    torch.cuda.empty_cache()
    sharded = {}

    def run():
        for v in NONSTRICT:
            sharded[v] = runtime.spawn(_nonstrict_frames, DIST_RANKS, st, v,
                                       inline=True)
        return {v: dict(ms_1rank=one[v]["ms"], ms_2rank=sharded[v]["ms"])
                for v in NONSTRICT}
    res, got = run_path("dist_nonstrict", run)
    summary = {}
    for v in NONSTRICT:
        same = [all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)
                for a, b in zip(one[v]["frames"], sharded[v]["frames"])]
        as_card = [all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)
                   for a, b in zip(card[v]["frames"], one[v]["frames"])]
        require(len(as_card) == NONSTRICT_FRAMES and all(as_card),
                f"dist_nonstrict {v}: a 1-rank frame differs from the "
                f"unsharded frame's ({as_card})")
        last = one[v]["frames"][-1]
        summary[v] = dict(bitwise=sum(same), unsharded_bitwise=sum(as_card),
                          frames=len(same),
                          live=int(last["live"].shape[0]),
                          corr_dropped=int(last["corr"]),
                          nodes=int(last["count"]))
        require(len(same) == NONSTRICT_FRAMES and all(same),
                f"dist_nonstrict {v}: a frame differs from the single "
                f"rank's ({same})")
        for r, counts in enumerate(sharded[v]["rank_launches"]):
            require(counts["knn_gather"] > 0 and counts["data_normal" if v
                                                        == "gn" else
                                                        "monomial_grams"] > 0,
                    f"dist_nonstrict {v}: rank {r} launched {counts}")
    print(f"dist_nonstrict: sharded_engine_frame(strict_parity=False), "
          f"bench_params(128), frames 1-{NONSTRICT_FRAMES} unsharded, on 1 "
          f"rank and on {DIST_RANKS} ranks: {json.dumps(summary)}",
          flush=True)
    return got


def cli_devices_check():
    """`dynfu-torch run --devices 2` (spawned ranks, this process rank 0)
    on the umbrella's first 4 frames at 128^3 with renders and checkpoints
    every 2 frames: every export byte-equal to --devices 1's and the last
    checkpoints' arrays equal; then 2 frames on 2 ranks resumed on 2 ranks
    over frames 2-3: those exports byte-equal to --devices 1's too."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = ["--export-viz", "--checkpoint-every", "2"]
        t0 = time.perf_counter()
        cli_run(tmp / "one", "--frames", "4", *common, dims=128)
        t1 = time.perf_counter()
        cli_run(tmp / "two", "--frames", "4", "--devices", "2", *common,
                dims=128)
        t2 = time.perf_counter()
        cli_run(tmp / "half", "--frames", "2", "--devices", "2", *common,
                dims=128)
        cli_run(tmp / "resumed", "--frames", "4", "--devices", "2", *common,
                "--resume", str(tmp / "half" / "checkpoint.npz"), dims=128)

        def exports(d):
            return sorted(f.name for f in (tmp / d).iterdir()
                          if f.name != "checkpoint.npz")
        names, resumed = exports("one"), exports("resumed")
        require(exports("two") == names,
                "cli --devices 2: other files than --devices 1")
        require(resumed == [n for n in names if n.startswith("2_") or
                            n.startswith("3_") or n[-5] in "23"],
                f"cli --devices 2 resumed: wrote {resumed}")
        for d, ns in (("two", names), ("resumed", resumed)):
            for name in ns:
                require((tmp / d / name).read_bytes()
                        == (tmp / "one" / name).read_bytes(),
                        f"cli --devices 2 ({d}): {name} differs")
        with np.load(tmp / "one" / "checkpoint.npz") as a, \
                np.load(tmp / "two" / "checkpoint.npz") as b:
            require(sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files),
                "cli --devices 2: the checkpoint differs")
    print(f"cli --devices 2 (128^3, 4 umbrella frames, renders, checkpoints):"
          f" {len(names)} exports byte-equal to --devices 1's, the last "
          f"checkpoint's arrays equal; resumed from frame 2 on 2 ranks, "
          f"{len(resumed)} exports byte-equal; {t1 - t0:.1f} s on one rank, "
          f"{t2 - t1:.1f} s on two (with the spawn)", flush=True)


def main() -> int:
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    phases = [("kernel build", lambda: kernels.build()),
              ("kernel phase", kernel_phase),
              ("small-input check (parity)", small_input_check),
              ("small-input check (fusion)", small_fusion_check),
              ("small-input check (rigid)", small_rigid_check),
              ("small-input check (fixed)", small_fixed_check),
              ("small-input check (fg)", small_fg_check),
              ("parity128", parity_phase),
              ("fusion", fusion_phase),
              ("rigid", rigid_phase),
              ("rigid_exact512", rigid_exact512_phase),
              ("rigid_profile", rigid_profile_phase),
              ("parity512", parity512_phase),
              ("movingcam", movingcam_phase),
              ("movingcam_simreg", simreg_phase),
              ("fusion_t512", fusion_t512_phase),
              ("umbrella512", umbrella_phase),
              ("umbrella_full512", umbrella_full512_phase),
              ("fixed128", fixed_phase),
              ("cli512", cli512_phase),
              ("cli_rigid512", cli_rigid512_phase),
              ("dist_parity512", dist_parity512_phase),
              ("dist_fusion512", dist_fusion512_phase),
              ("dist_step512", dist_step512_phase),
              ("dist_nonstrict", dist_nonstrict_phase),
              ("corr_block", corr_block_phase),
              ("xwindow_block", xwindow_block_phase),
              ("knn_variants", knn_variants_phase),
              ("bitplanes512", bitplanes512_phase),
              ("formulations", formulations_check)]
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
    rows = {r["name"]: r for r in table["kernels"]}
    rows["slab_sweep"]["resolve"] = rows.pop("sweep_resolve")
    rows["nn1_window_sweep"]["block_placement"] = out["corr_block"]
    table["kernels"] = [rows[n] for n in TABLE]
    print(json.dumps(table))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
