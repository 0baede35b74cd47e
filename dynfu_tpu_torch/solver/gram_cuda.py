"""Data-term Gram assembly: CUDA wrappers and plain versions.

`data_normal` replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85;
kernel csrc/gram.cu), the translation solve's A and b. `monomial_grams`
replaces monomial_grams_tpu (gram_pallas.py:184; kernel csrc/mono_gram.cu),
the SE(3) solve's ten monomial Grams and two rhs. The TPU kernels' 3-pass
bf16 split is a TPU device, not carried over.

The data Gram kernel sums every entry in one fixed order, in float64, and
rounds once to float32, so it gives the same bits on every launch;
`data_normal_fixed_order` is a plain model of that order, for the tests
(on no main path). `data_normal_plain` sums in float32 in index_add_'s
order, so the two agree to float32 roundoff. The monomial-Gram kernel's
atomics sum in a varying order: it agrees with its plain version to float32
roundoff, not bit for bit. It accumulates segments of rows in shared
memory; `mono_segments` is a plain model of how it cuts them (for the tests
and chip_smoke.py, on no main path).
"""

from __future__ import annotations

import ctypes

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


def data_normal_fixed_order(data_idx, data_w, s2, delta, D: int,
                            warps: int = 4):
    """The data Gram summed as the kernel sums it: each entry (row n, slot
    r) with idx in [0, D) and s2[n], w[n, r] nonzero goes to node idx's
    bucket, in ascending (n, r); the bucket is cut into `warps` equal
    contiguous shares; each share adds, entry by entry in float64, s2 w_r
    w_r' for each node r' of the row (the sum over the row's slots holding
    it, in slot order) and s2 w_r delta; the shares are summed in order and
    rounded once to float32. On the CPU index_add_ adds in index order."""
    N, K = data_idx.shape
    dev = data_w.device
    f64 = torch.float64
    idx = data_idx.to(torch.int64).reshape(-1)
    w = data_w.reshape(-1)
    row = torch.arange(N * K, device=dev) // K
    live = (idx >= 0) & (idx < D) & (s2[row] != 0) & (w != 0)
    keys = torch.where(live, idx, D)
    perm = torch.sort(keys, stable=True).indices[:int(live.sum())]
    node = keys[perm]
    counts = torch.bincount(node, minlength=D)
    start = torch.cumsum(counts, 0) - counts
    off = torch.arange(perm.numel(), device=dev) - start[node]
    length = counts[node]
    share = sum((off >= length * g // warps).to(torch.int64)
                for g in range(1, warps))
    n = row[perm]
    ws = s2[n].to(f64) * w[perm].to(f64)  # (E,)
    cols = data_idx[n].to(torch.int64)  # (E, K)
    ok = (cols >= 0) & (cols < D)
    # per entry, the first slot holding a node adds the sum of that node's
    # slots, in slot order
    same = ok[:, :, None] & ok[:, None, :] & (cols[:, :, None]
                                              == cols[:, None, :])
    first = ok & ~torch.tril(same, diagonal=-1).any(2)
    p = ws[:, None] * data_w[n].to(f64)
    val_a = torch.zeros_like(p)
    for s in range(K):
        val_a = val_a + torch.where(same[:, :, s], p[:, s:s + 1], 0.0)
    val_a = torch.where(first, val_a, 0.0)
    R = D + 3
    base = (share * D + node) * R  # (E,)
    tgt_a = base[:, None] + torch.where(ok, cols, 0)
    tgt_b = base[:, None] + D + torch.arange(3, device=dev)
    val_b = ws[:, None] * delta[n].to(f64)
    acc = torch.zeros(warps * D * R, dtype=f64, device=dev)
    # entries in bucket order, each entry's slots in order, then its rhs
    acc.index_add_(0, torch.cat([tgt_a, tgt_b], 1).reshape(-1),
                   torch.cat([val_a, val_b], 1).reshape(-1))
    acc = acc.reshape(warps, D, R)
    tot = acc[0]
    for g in range(1, warps):
        tot = tot + acc[g]
    tot = tot.to(torch.float32)
    return tot[:, :D].contiguous(), tot[:, D:].contiguous()


def data_normal_warps(D: int) -> int:
    """The warps per block the data Gram kernel launches with for D nodes
    (the shares of each node's bucket); on the card only."""
    out = ctypes.c_int(0)
    kernels.check(kernels.load().dynfu_data_normal_warps(D, ctypes.byref(out)),
                  "data_normal_warps")
    return out.value


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
    lib = kernels.load()
    scratch = torch.empty((lib.dynfu_data_normal_scratch(N, K, D),),
                          dtype=torch.int32, device=dev)
    A = torch.empty((D, D), dtype=torch.float32, device=dev)
    b = torch.empty((D, 3), dtype=torch.float32, device=dev)
    kernels.check(lib.dynfu_data_normal(
        data_idx.data_ptr(), data_w.data_ptr(), s2.data_ptr(),
        delta.data_ptr(), N, K, D, scratch.data_ptr(), A.data_ptr(),
        b.data_ptr(), kernels.stream(data_idx)), "data_normal")
    data_normal.launches += 1
    return A, b


data_normal.launches = 0


def monomials(y):
    """(10, N): [1, yx, yy, yz, yx^2, yx yy, yx yz, yy^2, yy yz, yz^2]."""
    yx, yy, yz = y.unbind(-1)
    return torch.stack([torch.ones_like(yx), yx, yy, yz, yx * yx, yx * yy,
                        yx * yz, yy * yy, yy * yz, yz * yz])  # (10, N)


def mono_segments(data_idx, data_w, s2, D: int, rows: int, u: int,
                  min_rows: int):
    """[(first row, rows, distinct nodes)] in the order the kernel's blocks
    take them: each tile of `rows` rows is cut into segments, a segment
    with more than u distinct live nodes (indices in [0, D) of slots with
    sqrt(max(s2, 0)) w != 0) halved while it is longer than min_rows, the
    next one starting at the length the last ended with. A segment left
    with more than u takes the global-atomic route."""
    N = data_idx.shape[0]
    rs = torch.sqrt(torch.clamp_min(s2, 0.0))
    live = ((data_idx >= 0) & (data_idx < D)
            & (rs[:, None] * data_w != 0.0)).cpu().numpy()
    idx = data_idx.cpu().numpy()
    out = []
    for t0 in range(0, N, rows):
        end, r0, length = min(N, t0 + rows), t0, rows
        while r0 < end:
            nr = min(length, end - r0)
            n = len(set(idx[r0:r0 + nr][live[r0:r0 + nr]].tolist()))
            if n > u and nr > min_rows:
                length = (nr + 1) // 2
                continue
            out.append((r0, nr, n))
            r0 += nr
    return out


def mono_tiling() -> tuple[int, int, int]:
    """The monomial-Gram kernel's tiling, as compiled into it: (rows per
    tile, local slots u, shortest halved segment); on the card only."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.load().dynfu_monomial_grams_tiling(out),
                  "monomial_grams_tiling")
    return tuple(out)


def monomial_grams_plain(data_idx, data_w, s2, y, delta, D: int):
    kernels.count_plain(monomial_grams_plain, data_idx)
    N, K = data_idx.shape
    dev = data_w.device
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    rs = torch.sqrt(torch.clamp_min(s2, 0.0))
    ws = torch.where(ok, rs[:, None] * data_w, 0.0)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair = ws[:, :, None] * ws[:, None, :]  # (N, K, K), zero off the rows
    terms = pair[None] * monomials(y)[:, :, None, None]  # (10, N, K, K)
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    flat = (torch.arange(10, device=dev)[:, None] * (D * D)
            + flat[None, :]).reshape(-1)
    B = torch.zeros(10 * D * D, dtype=torch.float32, device=dev)
    B.index_add_(0, flat, terms.reshape(-1))
    dx, dy, dz = delta.unbind(-1)
    yx, yy, yz = y.unbind(-1)
    cross = torch.stack([yy * dz - yz * dy, yz * dx - yx * dz,
                         yx * dy - yy * dx], -1)
    rhs = []
    for v in (delta, cross):
        acc = torch.zeros((D, 3), dtype=torch.float32, device=dev)
        acc.index_add_(0, idx.reshape(-1),
                       (ws[:, :, None] * (rs[:, None] * v)[:, None, :]
                        ).reshape(-1, 3))
        rhs.append(acc)
    return B.reshape(10, D, D), rhs[0], rhs[1]


monomial_grams_plain.cuda_calls = 0


def monomial_grams(data_idx: torch.Tensor, data_w: torch.Tensor,
                   s2: torch.Tensor, y: torch.Tensor, delta: torch.Tensor,
                   D: int):
    """data_idx (N, K) int32 (indices outside [0, D) are padding), data_w
    (N, K) f32, s2 (N,) f32 >= 0, y (N, 3) f32, delta (N, 3) f32 -> (B (10,
    D, D), Bu (D, 3), Bw (D, 3)) f32: B[m] = (sqrt(s2) W)^T diag(mono_m(y))
    (sqrt(s2) W) over `monomials`, Bu = W^T (s2 delta), Bw = W^T (s2 (y x
    delta))."""
    if not kernels.on_cuda(data_idx, "monomial_grams"):
        return monomial_grams_plain(data_idx, data_w, s2, y, delta, D)
    N, K = data_idx.shape
    dev = data_idx.device
    kernels.require(data_idx, "data_idx", torch.int32, (N, K), dev)
    kernels.require(data_w, "data_w", torch.float32, (N, K), dev)
    kernels.require(s2, "s2", torch.float32, (N,), dev)
    kernels.require(y, "y", torch.float32, (N, 3), dev)
    kernels.require(delta, "delta", torch.float32, (N, 3), dev)
    B = torch.empty((10, D, D), dtype=torch.float32, device=dev)
    Bu = torch.empty((D, 3), dtype=torch.float32, device=dev)
    Bw = torch.empty((D, 3), dtype=torch.float32, device=dev)
    lib = kernels.load()
    kernels.check(lib.dynfu_monomial_grams(
        data_idx.data_ptr(), data_w.data_ptr(), s2.data_ptr(), y.data_ptr(),
        delta.data_ptr(), N, K, D, B.data_ptr(), Bu.data_ptr(),
        Bw.data_ptr(), kernels.stream(data_idx)), "monomial_grams")
    monomial_grams.launches += 1
    return B, Bu, Bw


monomial_grams.launches = 0
