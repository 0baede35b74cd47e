"""The slab sweep raycast: CUDA kernel wrappers and plain versions.

Replaces no Pallas kernel: the source's `raycast` and `raycast_separable`
(dynfu_tpu/volume/tsdf.py:629-911) run their sweep as an XLA loop of ~20
operations per slab over all rays. The port's rigid raycast was its largest
host cost (ROADMAP H1), and a plain PyTorch sweep would launch ~20 kernels
for each of 103 slabs at 512^3, so the sweep is one kernel: one thread per
ray walks every slab, keeps the state machine's carry in registers and
writes the hit's point and normal in the camera frame. Kernel source:
csrc/sweep.cu. The plain versions are volume/tsdf.py's (`sweep_plain`,
`resolve_plain`), in the kernel's operation order.

`slab_sweep` has two outputs: the camera-frame points and normals, or, for
one x-block of a sharded volume, the block's per-ray record
(tsdf.SWEEP_FIELDS), which `sweep_resolve` turns into the points and
normals once every block's record is gathered (dist/spmd.py).
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch import kernels

_MODES = {"general": 0, "separable": 1}
_N_FIELDS = 16


def slab_sweep_plain(slabs, geo, rays, spec, block=None):
    """`slab_sweep` in plain PyTorch (volume/tsdf.py's sweep)."""
    from dynfu_tpu_torch.volume import tsdf  # tsdf imports this module

    kernels.count_plain(slab_sweep_plain, slabs)
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


def slab_sweep(slabs: torch.Tensor, geo: torch.Tensor, rays: torch.Tensor,
               spec, block=None):
    """slabs (S, Y, nx) f16 (tsdf.slab_stack; the planes x_off.. of the
    volume with a block), geo (12,) f32 (the camera's position in the
    volume, then the camera -> volume rotation, row-major), rays (H, W, 3)
    unit directions ("general") or (W + H,) = (qx, qy) ("separable"), spec
    a tsdf.SweepSpec; block None or (x_off, lo, hi). Returns (points,
    normals) (H, W, 3) f32, or the block's record (16, H, W) int32."""
    if not kernels.on_cuda(slabs, "slab_sweep"):
        return slab_sweep_plain(slabs, geo, rays, spec, block)
    S, Y, nx = slabs.shape
    H, W = spec.shape
    dev = slabs.device
    kernels.require(slabs, "slabs", torch.float16, (S, Y, nx), dev)
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
    lib = kernels.load()
    kernels.check(lib.dynfu_slab_sweep(
        slabs.data_ptr(), S, nx, geo.data_ptr(), rays.data_ptr(),
        _MODES[spec.mode], *_scalars(spec), x_off, lo, hi,
        int(block is not None), points.data_ptr(), normals.data_ptr(),
        record.data_ptr(), kernels.stream(slabs)), "slab_sweep")
    slab_sweep.launches += 1
    return (points, normals) if block is None else record


slab_sweep.launches = 0


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
