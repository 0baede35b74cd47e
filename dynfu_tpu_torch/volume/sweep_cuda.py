"""The slab sweep raycast: CUDA kernel wrappers and plain versions.

Replaces no Pallas kernel: the source's `raycast` and `raycast_separable`
(dynfu_tpu/volume/tsdf.py:629-911) run their sweep as an XLA loop of ~20
operations per slab over all rays. The port's rigid raycast was its largest
host cost (ROADMAP H1), and a plain PyTorch sweep would launch ~20 kernels
for each of 103 slabs at 512^3, so the sweep is one kernel: one thread per
ray finds its first event, keeps the state machine's carry in registers
and writes the hit's point and normal in the camera frame; it samples only
the slabs where the ray can be valid and skips those whose bricks the sign
summary marks (no value negative). Kernel sources: csrc/slab_stack.cu (the stack and
its summary in one pass over the volume) and csrc/sweep.cu. The plain
versions are volume/tsdf.py's (`slab_stack`, `brick_summary`,
`sweep_plain`, `resolve_plain`), in the kernels' operation order; the
plain sweep walks every slab (the skip is the kernel's and changes no
bit).

`slab_sweep` takes the stack and its summary as one `SlabStack`, as
`slab_stack` returns them: the kernel trusts the summary, so a summary
must never meet another stack (the plain version checks that it is the
stack's). It has two outputs: the camera-frame points and normals, or,
for one x-block of a sharded volume, the block's per-ray record
(tsdf.SWEEP_FIELDS), which `sweep_resolve` turns into the points and
normals once every block's record is gathered (dist/spmd.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynfu_tpu_torch import kernels

_MODES = {"general": 0, "separable": 1}
_N_FIELDS = 16
# what each ray of a sweep did (`sweep_work`), in the kernel's order
WORK_FIELDS = ("samples", "layers_checked", "bricks_skipped",
               "samples_skipped", "empty", "single_slab_samples")


class SlabStack(NamedTuple):
    """The slab stack (S, Y, nx) f16 and its sign summary uint8 of
    tsdf.summary_shape (tsdf.brick_summary of the slabs), made together by
    `slab_stack`."""
    slabs: torch.Tensor
    summary: torch.Tensor


def slab_stack_plain(tsdf, m):
    """`slab_stack` in plain PyTorch (volume/tsdf.py's)."""
    from dynfu_tpu_torch.volume import tsdf as tv  # tsdf imports this module

    kernels.count_plain(slab_stack_plain, tsdf)
    slabs = tv.slab_stack(tsdf, m)
    return SlabStack(slabs, tv.brick_summary(slabs))


slab_stack_plain.cuda_calls = 0


def slab_stack(tsdf: torch.Tensor, m: int) -> SlabStack:
    """tsdf (nx, Y, Z) f16 (a volume's, or an x-block's planes) -> a
    SlabStack: slabs (S, Y, nx) f16, the planes z = 0, m, 2m, ... with x
    fastest, S = (Z - 1) // m + 1; summary uint8 of tsdf.summary_shape,
    tsdf.brick_summary of the slabs: one bit a brick."""
    if not kernels.on_cuda(tsdf, "slab_stack"):
        return slab_stack_plain(tsdf, m)
    from dynfu_tpu_torch.volume import tsdf as tv

    nx, Y, Z = tsdf.shape
    dev = tsdf.device
    kernels.require(tsdf, "tsdf", torch.float16, (nx, Y, Z), dev)
    if nx < 2 or Y < 2 or m < 1:
        raise ValueError(f"slab_stack: tsdf {tuple(tsdf.shape)}, m {m}")
    S = (Z - 1) // m + 1
    slabs = torch.empty((S, Y, nx), dtype=torch.float16, device=dev)
    summary = torch.empty(tv.summary_shape(S, Y, nx), dtype=torch.uint8,
                          device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_slab_stack(
        tsdf.data_ptr(), nx, Y, Z, m, S, *tv.BRICK, *summary.shape[1:],
        slabs.data_ptr(), summary.data_ptr(), kernels.stream(tsdf)),
        "slab_stack")
    slab_stack.launches += 1
    return SlabStack(slabs, summary)


slab_stack.launches = 0


def slab_sweep_plain(stack: SlabStack, geo, rays, spec, block=None):
    """`slab_sweep` in plain PyTorch (volume/tsdf.py's sweep, which walks
    every slab and skips nothing). Raises unless the summary is the
    stack's, the one the kernel's skip relies on."""
    from dynfu_tpu_torch.volume import tsdf  # tsdf imports this module

    slabs, summary = stack
    kernels.count_plain(slab_sweep_plain, slabs)
    if not torch.equal(summary, tsdf.brick_summary(slabs)):
        raise ValueError("slab_sweep: the summary is not the stack's "
                         "(sweep_cuda.slab_stack makes the two together)")
    return tsdf.sweep_plain(slabs, geo, rays, spec, block)


slab_sweep_plain.cuda_calls = 0


def sweep_resolve_plain(every, geo, rays, spec):
    """`sweep_resolve` in plain PyTorch."""
    from dynfu_tpu_torch.volume import tsdf

    kernels.count_plain(sweep_resolve_plain, every)
    return tsdf.resolve_plain(every, geo, rays, spec)


sweep_resolve_plain.cuda_calls = 0


def _require_rays(geo, rays, spec, dev):
    H, W = spec.shape
    kernels.require(geo, "geo", torch.float32, (12,), dev)
    if spec.mode == "general":
        kernels.require(rays, "rays", torch.float32, (H, W, 3), dev)
    else:
        kernels.require(rays, "rays", torch.float32, (W + H,), dev)


def _scalars(spec):
    X, Y = spec.dims
    return (spec.shape[0], spec.shape[1], spec.m, spec.s_pad, X, Y,
            *spec.voxel, spec.slab_dz)


def _launch_sweep(stack, geo, rays, spec, block, work):
    """Check the arguments, launch the sweep kernel; returns (points,
    normals) or the block's record, and fills `work` if given."""
    from dynfu_tpu_torch.volume import tsdf as tv

    slabs, summary = stack
    S, Y, nx = slabs.shape
    H, W = spec.shape
    dev = slabs.device
    kernels.require(slabs, "slabs", torch.float16, (S, Y, nx), dev)
    kernels.require(summary, "summary", torch.uint8,
                    tv.summary_shape(S, Y, nx), dev)
    _require_rays(geo, rays, spec, dev)
    x_off, lo, hi = block or (0, 0, spec.dims[0])
    if (Y != spec.dims[1] or nx < 2 or S > spec.s_pad
            or not x_off <= lo < hi <= x_off + nx - 1 + (hi == spec.dims[0])):
        raise ValueError(f"slab_sweep: slabs {tuple(slabs.shape)}, block "
                         f"{block}, spec {spec}")
    if block is None:
        points = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
        normals = torch.empty_like(points)
        record = torch.empty(0, dtype=torch.int32, device=dev)
    else:
        points = normals = torch.empty(0, dtype=torch.float32, device=dev)
        record = torch.empty((_N_FIELDS, H, W), dtype=torch.int32,
                             device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_slab_sweep(
        slabs.data_ptr(), S, nx, summary.data_ptr(), *tv.BRICK,
        geo.data_ptr(), rays.data_ptr(), _MODES[spec.mode], *_scalars(spec),
        x_off, lo, hi, int(block is not None), counter.data_ptr(),
        points.data_ptr(), normals.data_ptr(), record.data_ptr(),
        0 if work is None else work.data_ptr(), kernels.stream(slabs)),
        "slab_sweep")
    slab_sweep.launches += 1
    return (points, normals) if block is None else record


def slab_sweep(stack: SlabStack, geo: torch.Tensor, rays: torch.Tensor,
               spec, block=None):
    """stack a SlabStack (`slab_stack`; the planes x_off.. of the volume
    with a block), geo (12,) f32 (the camera's position in the volume, then
    the camera -> volume rotation, row-major), rays (H, W, 3) unit
    directions ("general") or (W + H,) = (qx, qy) ("separable"), spec a
    tsdf.SweepSpec; block None or (x_off, lo, hi). Returns (points,
    normals) (H, W, 3) f32, or the block's record (16, H, W) int32."""
    if not kernels.on_cuda(stack.slabs, "slab_sweep"):
        return slab_sweep_plain(stack, geo, rays, spec, block)
    return _launch_sweep(stack, geo, rays, spec, block, None)


slab_sweep.launches = 0


def sweep_work(stack: SlabStack, geo, rays, spec, block=None):
    """What each ray of `slab_sweep` on these inputs did, as its kernel
    counts it (one launch, counted as slab_sweep's): int32 (6, H, W) in
    WORK_FIELDS' order — the samples it computed (corner loads), the
    brick layers it checked against the summary, the bricks its skips
    passed, the samples skipped, whether its span of slabs was empty, and
    the samples a walk of one slab at a time up to the first event takes (a
    block's: its own samples). CUDA tensors only."""
    if stack.slabs.device.type != "cuda":
        raise ValueError("sweep_work: the kernel's counts need the card")
    H, W = spec.shape
    work = torch.empty((len(WORK_FIELDS), H, W), dtype=torch.int32,
                       device=stack.slabs.device)
    _launch_sweep(stack, geo, rays, spec, block, work)
    return work


def sweep_resolve(every: torch.Tensor, geo: torch.Tensor, rays: torch.Tensor,
                  spec):
    """every (world, 16, H, W) int32, every block's record in rank order;
    geo, rays and spec as the blocks' `slab_sweep`. Returns (points,
    normals, straddle): the whole sweep's points and normals, and where a
    hit's pair of samples lies in two blocks (H, W) bool."""
    if not kernels.on_cuda(every, "sweep_resolve"):
        return sweep_resolve_plain(every, geo, rays, spec)
    H, W = spec.shape
    dev = every.device
    world = every.shape[0]
    kernels.require(every, "every", torch.int32, (world, _N_FIELDS, H, W),
                    dev)
    _require_rays(geo, rays, spec, dev)
    points = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    normals = torch.empty_like(points)
    straddle = torch.empty((H, W), dtype=torch.bool, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_sweep_resolve(
        every.data_ptr(), world, geo.data_ptr(), rays.data_ptr(),
        _MODES[spec.mode], *_scalars(spec), points.data_ptr(),
        normals.data_ptr(), straddle.data_ptr(), kernels.stream(every)),
        "sweep_resolve")
    sweep_resolve.launches += 1
    return points, normals, straddle


sweep_resolve.launches = 0
