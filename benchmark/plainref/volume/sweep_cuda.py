"""The slab sweep raycast, the plain versions.

The port runs its sweep as CUDA kernels (csrc/slab_stack.cu: the slab
stack and its brick sign summary in one pass; csrc/sweep.cu: one thread a
ray, skipping the bricks the summary marks empty). Here every call takes
the plain versions, volume/tsdf.py's (`slab_stack`, `brick_summary`,
`sweep_plain`), in the kernels' operation order; the plain sweep walks
every slab (the skip is the kernel's and changes no bit).

`slab_sweep` takes the stack and its summary as one `SlabStack`, as
`slab_stack` returns them, and checks that the summary is the stack's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SlabStack(NamedTuple):
    """The slab stack (S, Y, nx) f16 and its sign summary uint8 of
    tsdf.summary_shape (tsdf.brick_summary of the slabs), made together by
    `slab_stack`."""
    slabs: torch.Tensor
    summary: torch.Tensor


def slab_stack(tsdf: torch.Tensor, m: int) -> SlabStack:
    """tsdf (nx, Y, Z) f16 (a volume's, or an x-block's planes) -> a
    SlabStack: slabs (S, Y, nx) f16, the planes z = 0, m, 2m, ... with x
    fastest, S = (Z - 1) // m + 1; summary uint8 of tsdf.summary_shape,
    tsdf.brick_summary of the slabs: one bit a brick."""
    from plainref.volume import tsdf as tv  # tsdf imports this module

    slabs = tv.slab_stack(tsdf, m)
    return SlabStack(slabs, tv.brick_summary(slabs))


def slab_sweep(stack: SlabStack, geo: torch.Tensor, rays: torch.Tensor,
               spec, block=None):
    """stack a SlabStack (`slab_stack`; the planes x_off.. of the volume
    with a block), geo (12,) f32 (the camera's position in the volume, then
    the camera -> volume rotation, row-major), rays (H, W, 3) unit
    directions ("general") or (W + H,) = (qx, qy) ("separable"), spec a
    tsdf.SweepSpec; block None or (x_off, lo, hi). Returns (points,
    normals) (H, W, 3) f32, or the block's record (16, H, W) int32. Raises
    unless the summary is the stack's."""
    from plainref.volume import tsdf  # tsdf imports this module

    slabs, summary = stack
    if not torch.equal(summary, tsdf.brick_summary(slabs)):
        raise ValueError("slab_sweep: the summary is not the stack's "
                         "(sweep_cuda.slab_stack makes the two together)")
    return tsdf.sweep_plain(slabs, geo, rays, spec, block)
