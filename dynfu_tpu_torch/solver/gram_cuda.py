"""GN data-term Gram assembly: CUDA wrapper and plain version.

Replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85). Kernel
source: csrc/gram.cu. Both sum in IEEE float32 (the TPU kernel's 3-pass
bf16 split is a TPU device, not carried over); the kernel's atomics sum in
a varying order, so the two agree to float32 roundoff, not bit for bit.
"""

from __future__ import annotations

import torch

from dynfu_tpu_torch import kernels


def data_normal_plain(data_idx, data_w, s2, delta, D: int):
    kernels.count_plain(data_normal_plain, data_idx)
    N, K = data_idx.shape
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    ws = torch.where(ok, s2[:, None] * data_w, 0.0)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    terms = torch.where(pair_ok, ws[:, :, None] * data_w[:, None, :], 0.0)
    A = torch.zeros(D * D, dtype=torch.float32, device=data_w.device)
    A.index_add_(0, flat, terms.reshape(-1))
    b = torch.zeros((D, 3), dtype=torch.float32, device=data_w.device)
    b.index_add_(0, idx.reshape(-1),
                 (ws[:, :, None] * delta[:, None, :]).reshape(-1, 3))
    return A.reshape(D, D), b


data_normal_plain.cuda_calls = 0


def data_normal(data_idx: torch.Tensor, data_w: torch.Tensor,
                s2: torch.Tensor, delta: torch.Tensor, D: int):
    """data_idx (N, K) int32, data_w (N, K) f32 (invalid slots 0), s2 (N,)
    f32, delta (N, 3) f32 -> (A (D, D), b (D, 3)) f32."""
    if not kernels.on_cuda(data_idx, "data_normal"):
        return data_normal_plain(data_idx, data_w, s2, delta, D)
    N, K = data_idx.shape
    dev = data_idx.device
    kernels.require(data_idx, "data_idx", torch.int32, (N, K), dev)
    kernels.require(data_w, "data_w", torch.float32, (N, K), dev)
    kernels.require(s2, "s2", torch.float32, (N,), dev)
    kernels.require(delta, "delta", torch.float32, (N, 3), dev)
    A = torch.empty((D, D), dtype=torch.float32, device=dev)
    b = torch.empty((D, 3), dtype=torch.float32, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_data_normal(
        data_idx.data_ptr(), data_w.data_ptr(), s2.data_ptr(),
        delta.data_ptr(), N, K, D, A.data_ptr(), b.data_ptr(),
        kernels.stream(data_idx)), "data_normal")
    data_normal.launches += 1
    return A, b


data_normal.launches = 0
