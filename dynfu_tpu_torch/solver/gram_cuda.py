"""Data-term Gram assembly: CUDA wrappers and plain versions.

`data_normal` replaces data_normal_tpu (dynfu_tpu/solver/gram_pallas.py:85;
kernel csrc/gram.cu), the translation solve's A and b. `monomial_grams`
replaces monomial_grams_tpu (gram_pallas.py:184; kernel csrc/mono_gram.cu),
the SE(3) solve's ten monomial Grams and two rhs. The TPU kernels' 3-pass
bf16 split is a TPU device, not carried over.

Both kernels sum every entry in one fixed order (csrc/gram_gather.cuh), in
float64, and round once to float32, so they give the same bits on every
launch; `gram_fixed_order` is a plain model of that order, for the tests
and chip_smoke.py (on no main path). Both plain versions sum in float64
too, in index_add_'s order. Kernel and plain version agree to float32
roundoff.

`data_normal(..., partial=True)` and `monomial_grams(..., partial=True)`
return the float64 sums before the rounding: the partial Grams of a row
range, which the sharded solves (dist/shard_gram.py) add over ranks in rank
order and round once.
"""

from __future__ import annotations

import ctypes

import torch

from dynfu_tpu_torch import kernels


def data_normal_plain(data_idx, data_w, s2, delta, D: int,
                      partial: bool = False):
    """The terms and their sums in float64, rounded once to float32 unless
    `partial`."""
    kernels.count_plain(data_normal_plain, data_idx)
    f64 = torch.float64
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    w = data_w.to(f64)
    ws = torch.where(ok, s2.to(f64)[:, None] * w, 0.0)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    terms = torch.where(pair_ok, ws[:, :, None] * w[:, None, :], 0.0)
    A = torch.zeros(D * D, dtype=f64, device=data_w.device)
    A.index_add_(0, flat, terms.reshape(-1))
    b = torch.zeros((D, 3), dtype=f64, device=data_w.device)
    b.index_add_(0, idx.reshape(-1),
                 (ws[:, :, None] * delta.to(f64)[:, None, :]).reshape(-1, 3))
    A = A.reshape(D, D)
    return (A, b) if partial else (A.to(torch.float32), b.to(torch.float32))


data_normal_plain.cuda_calls = 0


CHUNK = 32  # rows per chunk of a node's mask (csrc/gram_gather.cuh)


def _sqrt_f32(s2):
    """sqrt(max(s2, 0)) correctly rounded to float32, as the kernels' sqrtf
    gives it (torch's float32 sqrt on the CPU can be an ulp off)."""
    return torch.sqrt(torch.clamp_min(s2, 0.0).to(torch.float64)).to(
        torch.float32)


def _row_weights(data_idx, data_w, s2, D: int, mono: bool):
    """Per slot: live (in [0, D), nonzero weight), first (the row's first
    live slot of its node) and v, float64: the sum of the weights of the
    row's live slots holding that node, in slot order (from the first)."""
    K = data_idx.shape[1]
    idx = data_idx.to(torch.int64)
    if mono:
        ws = _sqrt_f32(s2)[:, None] * data_w
        live = (idx >= 0) & (idx < D) & (ws != 0)
    else:
        ws = data_w
        live = (idx >= 0) & (idx < D) & (s2[:, None] != 0) & (data_w != 0)
    wt = ws.to(torch.float64)
    same = live[:, :, None] & live[:, None, :] & (idx[:, :, None]
                                                  == idx[:, None, :])
    first = live & ~torch.tril(same, diagonal=-1).any(2)
    slot = torch.arange(K, device=idx.device)
    v = wt
    for r2 in range(K):
        later = same[:, :, r2] & (slot < r2)[None, :]
        v = torch.where(later, v + wt[:, r2:r2 + 1], v)
    return idx, live, first, v


def _shares(idx, first, D: int, warps: int):
    """(N, K) share of each first slot: its node's marked chunks (those
    holding a row of it), cut by rank into `warps` equal contiguous
    shares."""
    N = idx.shape[0]
    dev = idx.device
    n_chunks = max(1, -(-N // CHUNK))
    rows = torch.arange(N, device=dev)[:, None].expand_as(idx)
    key = torch.where(first, idx * n_chunks + rows // CHUNK, -1)
    sel = key.reshape(-1) >= 0
    uniq, inv = torch.unique(key.reshape(-1)[sel], return_inverse=True)
    node = uniq // n_chunks
    n_ch = torch.bincount(node, minlength=D)
    start = torch.cumsum(n_ch, 0) - n_ch
    rank = torch.arange(uniq.numel(), device=dev) - start[node]
    share = sum(((n_ch[node] * g // warps) <= rank).to(torch.int64)
                for g in range(1, warps))
    out = torch.zeros(idx.numel(), dtype=torch.int64, device=dev)
    out[sel] = share[inv] if warps > 1 else 0
    return out.reshape(idx.shape)


def gram_fixed_order(data_idx, data_w, s2, delta, D: int, warps: int,
                     y=None, partial: bool = False):
    """A Gram summed as csrc/gram_gather.cuh sums it: the data Gram (y is
    None) -> (A (D, D), b (D, 3)), or the monomial Grams -> (B (10, D, D),
    Bu (D, 3), Bw (D, 3)). Each row's live slots holding one node are merged
    (their weights summed in float64 in slot order: v); entry (i, j) adds,
    over the rows holding i and j, s2 (v_i v_j) (data) or (v_i v_j) mono_m
    (monomials, float64 products of float32 y); the right-hand sides add
    (s2 v_i) delta, resp. (v_i rs) (delta, y x delta). Node i's marked
    chunks of 32 rows (those holding it) are cut by rank into `warps`
    shares; each share sums from +0.0 in row order; the shares are summed
    in order and rounded once to float32 (with `partial`: left in
    float64). On the CPU index_add_ adds in index order."""
    mono = y is not None
    N, K = data_idx.shape
    dev = data_w.device
    f64 = torch.float64
    idx, live, first, v = _row_weights(data_idx, data_w, s2, D, mono)
    share = _shares(idx, first, D, warps)
    node = torch.where(first, idx, 0)
    pair = first[:, :, None] & first[:, None, :]
    p = v[:, :, None] * v[:, None, :]  # (N, K, K): row n, slot of i, of j
    s2d = s2.to(f64)
    R = 6 if mono else 3
    if mono:
        yd = y.to(f64)
        yx, yy, yz = yd.unbind(-1)
        mo = torch.stack([torch.ones_like(yx), yx, yy, yz, yx * yx, yx * yy,
                          yx * yz, yy * yy, yy * yz, yz * yz])  # (10, N)
        d = delta.to(f64)
        dx, dy, dz = d.unbind(-1)
        dc = torch.stack([dx, dy, dz, yy * dz - yz * dy, yz * dx - yx * dz,
                          yx * dy - yy * dx], -1)  # (N, 6)
        u = v * _sqrt_f32(s2).to(f64)[:, None]
        terms = [(p * mo[m][:, None, None])[pair] for m in range(10)]
    else:
        dc = delta.to(f64)
        u = s2d[:, None] * v
        terms = [(s2d[:, None, None] * p)[pair]]
    rhs_terms = (u[:, :, None] * dc[:, None, :])[first]  # (E, R)
    # sum targets: per (share, i, j) and (share, i)
    key_g = ((share * D + node)[:, :, None] * D + node[:, None, :])[pair]
    key_gr = (share * D + node)[first]

    def total(acc):  # (warps, ...) -> shares summed in order, rounded once
        tot = acc[0]
        for g in range(1, warps):
            tot = tot + acc[g]
        return tot if partial else tot.to(torch.float32)

    def summed(keys, vals, width):
        """vals (E, ...) into (warps * width, ...) at keys, in index
        order."""
        acc = torch.zeros((warps * width,) + vals.shape[1:], dtype=f64,
                          device=dev)
        acc.index_add_(0, keys, vals)
        return acc

    G = [total(summed(key_g, t, D * D).reshape(warps, D, D)) for t in terms]
    rhs = total(summed(key_gr, rhs_terms, D).reshape(warps, D, R))
    if mono:
        return torch.stack(G), rhs[:, :3].contiguous(), rhs[:, 3:].contiguous()
    return G[0], rhs


def gather_work(data_idx, data_w, s2, D: int, mono: bool) -> dict:
    """Per node (D,): the rows holding it, its marked chunks of 32 rows and
    its neighbours (the nodes sharing a row with it; the kernel takes them
    in passes of 32) under the kernels' liveness rule (for chip_smoke.py's
    work counts)."""
    idx, _, first, _ = _row_weights(data_idx, data_w, s2, D, mono)
    N = idx.shape[0]
    node = torch.where(first, idx, D)
    rows = torch.bincount(node.reshape(-1), minlength=D + 1)[:D]
    chunk = torch.arange(N, device=idx.device)[:, None] // CHUNK
    key = torch.unique(torch.where(first, node * (N // CHUNK + 1) + chunk,
                                   -1))
    key = key[key >= 0]
    chunks = torch.bincount(key // (N // CHUNK + 1), minlength=D)[:D]
    pair = first[:, :, None] & first[:, None, :]
    pk = torch.unique((node[:, :, None] * D + node[:, None, :])[pair])
    neighbours = torch.bincount(pk // D, minlength=D)[:D]
    return dict(rows=rows, chunks=chunks, neighbours=neighbours)


def gram_warps(N: int, D: int, mono: bool) -> int:
    """The warps per block (the shares of each node's rows) the Gram
    kernels launch with for N rows and D nodes; on the card only."""
    out = ctypes.c_int(0)
    kernels.check(kernels.load().dynfu_gram_warps(N, D, int(mono),
                                                  ctypes.byref(out)),
                  "gram_warps")
    return out.value


def _scratch(lib, N: int, D: int, dev):
    """The chunk masks the Gram kernels mark (zeroed in the C call)."""
    return torch.empty((max(1, lib.dynfu_gram_scratch(N, D)),),
                       dtype=torch.int32, device=dev)


def data_normal(data_idx: torch.Tensor, data_w: torch.Tensor,
                s2: torch.Tensor, delta: torch.Tensor, D: int,
                partial: bool = False):
    """data_idx (N, K) int32, data_w (N, K) f32 (invalid slots 0), s2 (N,)
    f32, delta (N, 3) f32 -> (A (D, D), b (D, 3)) f32, or with `partial`
    the float64 sums before their rounding."""
    if not kernels.on_cuda(data_idx, "data_normal"):
        return data_normal_plain(data_idx, data_w, s2, delta, D, partial)
    N, K = data_idx.shape
    dev = data_idx.device
    kernels.require(data_idx, "data_idx", torch.int32, (N, K), dev)
    kernels.require(data_w, "data_w", torch.float32, (N, K), dev)
    kernels.require(s2, "s2", torch.float32, (N,), dev)
    kernels.require(delta, "delta", torch.float32, (N, 3), dev)
    lib = kernels.load()
    scratch = _scratch(lib, N, D, dev)
    dtype = torch.float64 if partial else torch.float32
    A = torch.empty((D, D), dtype=dtype, device=dev)
    b = torch.empty((D, 3), dtype=dtype, device=dev)
    entry = lib.dynfu_data_normal_f64 if partial else lib.dynfu_data_normal
    kernels.check(entry(
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


def monomial_grams_plain(data_idx, data_w, s2, y, delta, D: int,
                         partial: bool = False):
    """The terms (float64 from the float32 weights rs * w) and their sums in
    float64, rounded once to float32 unless `partial`."""
    kernels.count_plain(monomial_grams_plain, data_idx)
    dev = data_w.device
    f64 = torch.float64
    idx = data_idx.to(torch.int64)
    ok = (idx >= 0) & (idx < D)
    rs = torch.sqrt(torch.clamp_min(s2, 0.0))
    ws = torch.where(ok, rs[:, None] * data_w, 0.0).to(f64)  # (N, K)
    idx = torch.where(ok, idx, 0)
    pair = ws[:, :, None] * ws[:, None, :]  # (N, K, K), zero off the rows
    terms = pair[None] * monomials(y.to(f64))[:, :, None, None]
    flat = (idx[:, :, None] * D + idx[:, None, :]).reshape(-1)
    flat = (torch.arange(10, device=dev)[:, None] * (D * D)
            + flat[None, :]).reshape(-1)
    B = torch.zeros(10 * D * D, dtype=f64, device=dev)
    B.index_add_(0, flat, terms.reshape(-1))
    d = delta.to(f64)
    dx, dy, dz = d.unbind(-1)
    yx, yy, yz = y.to(f64).unbind(-1)
    cross = torch.stack([yy * dz - yz * dy, yz * dx - yx * dz,
                         yx * dy - yy * dx], -1)
    rhs = []
    for v in (d, cross):
        acc = torch.zeros((D, 3), dtype=f64, device=dev)
        acc.index_add_(0, idx.reshape(-1),
                       (ws[:, :, None] * (rs.to(f64)[:, None] * v)[:, None, :]
                        ).reshape(-1, 3))
        rhs.append(acc)
    out = (B.reshape(10, D, D), rhs[0], rhs[1])
    return out if partial else tuple(t.to(torch.float32) for t in out)


monomial_grams_plain.cuda_calls = 0


def monomial_grams(data_idx: torch.Tensor, data_w: torch.Tensor,
                   s2: torch.Tensor, y: torch.Tensor, delta: torch.Tensor,
                   D: int, partial: bool = False):
    """data_idx (N, K) int32 (indices outside [0, D) are padding), data_w
    (N, K) f32, s2 (N,) f32 >= 0, y (N, 3) f32, delta (N, 3) f32 -> (B (10,
    D, D), Bu (D, 3), Bw (D, 3)) f32: B[m] = (sqrt(s2) W)^T diag(mono_m(y))
    (sqrt(s2) W) over `monomials`, Bu = W^T (s2 delta), Bw = W^T (s2 (y x
    delta)); with `partial` the float64 sums before their rounding."""
    if not kernels.on_cuda(data_idx, "monomial_grams"):
        return monomial_grams_plain(data_idx, data_w, s2, y, delta, D,
                                    partial)
    N, K = data_idx.shape
    dev = data_idx.device
    kernels.require(data_idx, "data_idx", torch.int32, (N, K), dev)
    kernels.require(data_w, "data_w", torch.float32, (N, K), dev)
    kernels.require(s2, "s2", torch.float32, (N,), dev)
    kernels.require(y, "y", torch.float32, (N, 3), dev)
    kernels.require(delta, "delta", torch.float32, (N, 3), dev)
    dtype = torch.float64 if partial else torch.float32
    B = torch.empty((10, D, D), dtype=dtype, device=dev)
    Bu = torch.empty((D, 3), dtype=dtype, device=dev)
    Bw = torch.empty((D, 3), dtype=dtype, device=dev)
    lib = kernels.load()
    scratch = _scratch(lib, N, D, dev)
    entry = (lib.dynfu_monomial_grams_f64 if partial
             else lib.dynfu_monomial_grams)
    kernels.check(entry(
        data_idx.data_ptr(), data_w.data_ptr(), s2.data_ptr(), y.data_ptr(),
        delta.data_ptr(), N, K, D, scratch.data_ptr(), B.data_ptr(),
        Bu.data_ptr(), Bw.data_ptr(), kernels.stream(data_idx)),
        "monomial_grams")
    monomial_grams.launches += 1
    return B, Bu, Bw


monomial_grams.launches = 0
