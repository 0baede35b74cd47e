"""Marching-cubes triangle pack: CUDA kernel wrapper and plain version.

Replaces the Pallas chunk-pack kernel pack_triangles_tpu
(dynfu_tpu/mesh/mc_pallas.py:69). Kernel source: csrc/pack_triangles.cu.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch import kernels


def pack_triangles_plain(tris: torch.Tensor, t_offsets: torch.Tensor,
                         n_tris: torch.Tensor, max_tris: int) -> torch.Tensor:
    """Row j < n_tris[c] of cell c goes to row t_offsets[c] + j of the
    (max_tris, 9) stream; rows past max_tris drop, and rows at or past the
    total count are zero (mc.py:289-297 of the source)."""
    kernels.count_plain(pack_triangles_plain, tris)
    M = tris.shape[0]
    slot = torch.arange(5, device=tris.device)[None, :]
    tgt = t_offsets.to(torch.int64)[:, None] + slot
    tgt = torch.where((slot < n_tris[:, None]) & (tgt < max_tris), tgt,
                      max_tris)
    out = torch.zeros((max_tris + 1, 9), dtype=torch.float32,
                      device=tris.device)
    out[tgt.reshape(-1)] = tris.reshape(M * 5, 9)  # duplicates only at the
    return out[:max_tris]                          # discarded row max_tris


pack_triangles_plain.cuda_calls = 0


def pack_triangles(tris: torch.Tensor, t_offsets: torch.Tensor,
                   n_tris: torch.Tensor, max_tris: int) -> torch.Tensor:
    """tris (M, 5, 9) f32, t_offsets (M,) i32 exclusive cumsum of n_tris,
    n_tris (M,) i32 in 0..5 -> (max_tris, 9) f32 triangle stream."""
    if not kernels.on_cuda(tris, "pack_triangles"):
        return pack_triangles_plain(tris, t_offsets, n_tris, max_tris)
    M = tris.shape[0]
    dev = tris.device
    kernels.require(tris, "tris", torch.float32, (M, 5, 9), dev)
    kernels.require(t_offsets, "t_offsets", torch.int32, (M,), dev)
    kernels.require(n_tris, "n_tris", torch.int32, (M,), dev)
    if M < 1 or max_tris < 1:
        raise ValueError("pack_triangles: empty input or output")
    out = torch.empty((max_tris, 9), dtype=torch.float32, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_pack_triangles(
        tris.data_ptr(), t_offsets.data_ptr(), n_tris.data_ptr(), M,
        max_tris, out.data_ptr(), kernels.stream(tris)), "pack_triangles")
    pack_triangles.launches += 1
    return out


pack_triangles.launches = 0
