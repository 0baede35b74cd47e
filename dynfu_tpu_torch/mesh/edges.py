"""Unique isosurface vertices by zero-crossing edge extraction.

Port of dynfu_tpu/mesh/edges.py. Marching cubes emits a triangle soup in
which each mesh vertex appears ~5x; correspondence, solve and node insertion
need only the vertex set. A unique vertex is a cell-grid edge whose two
endpoint samples are weighted and of opposite sign, incident to at least one
occupied cell (marching cubes' occupancy rule), interpolated as marching
cubes does, so the set equals the unique soup positions bit for bit.

Edges are enumerated in column order c = (i * Y + j) * 3 + axis, z fastest
(x-major scan order, nearly x-sorted like the soup). The source builds the
masks in bit-packed words; here they are dense bool volumes and the
compaction is ops/compaction.py with the source's capacity rules, so the
captured edges, their order and `n_dropped` equal the source's. (The
source's `bitplanes=` input, packed planes emitted by its integrate, is a
TPU device and is not ported.)

On an x-block of a sharded volume (dist/), `vol` holds the block's planes
x0 .. x0 + n - 1 plus `halo` = (h0, h1) neighbouring planes below and above
(the -1 plane: the occupancy of cell x0 - 1 marks the block's first
y- and z-edges; the +1 plane: the block's last x-edges and cells), and
`prefix` applies the capacities over all blocks (ops/compaction.py): the
block returns, in scan order, exactly the vertices of its planes that the
whole volume's extraction keeps, and its own n_dropped. The normals'
central differences read one plane below and two above the block (the
upper endpoint of its last x-edges and that plane's neighbour), so with
normals the halo must hold 2 planes above; their NaN rule is read in global
coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from dynfu_tpu_torch.ops import compaction
from dynfu_tpu_torch.volume.tsdf import TsdfConfig, TsdfVolume


def _or_prev(m: torch.Tensor, axis: int) -> torch.Tensor:
    """(.., n, ..) -> (.., n + 1, ..) with out[i] = m[i] | m[i - 1] (zero
    beyond the ends): cell occupancy -> incidence of the edge lattice."""
    pad = list(m.shape)
    pad[axis] = 1
    z = m.new_zeros(pad)
    return torch.cat([m, z], axis) | torch.cat([z, m], axis)


def _or_z_prev(m: torch.Tensor) -> torch.Tensor:
    """Along z, same length: out[k] = m[k] | m[k - 1]."""
    out = m.clone()
    out[..., 1:] |= m[..., :-1]
    return out


def isosurface_edge_vertices(vol: TsdfVolume, config: TsdfConfig,
                             max_edges: int = 1 << 16,
                             convention: str = "center",
                             col_budget: int = 0,
                             with_normals: bool = False, x0: int = 0,
                             halo=(0, 0), prefix=None):
    """Extract the unique isosurface vertex set.

    Returns (verts (max_edges, 3) float32 volume-frame meters, the first
    n_edges rows valid; n_edges () int32; n_dropped () int32 sign-changing
    edges not captured because a capacity overflowed), and with
    with_normals=True also (max_edges, 3) TSDF-gradient normals: the two
    endpoints' lattice central differences lerped by the interpolation
    fraction, NaN outside [2, dims - 2)^3 (extract_normals' rule)."""
    if convention not in ("center", "corner"):
        raise ValueError(f"unknown convention {convention!r}")
    h0, h1 = halo
    if with_normals and 0 < h1 < 2:
        raise ValueError("edge normals on an x-block need a halo of 2 planes "
                         "above it (dist/spmd.halo_slab(width=2))")
    Xg, Y, Z = config.dims
    X = vol.tsdf.shape[0]  # the planes held: the whole volume, or a block
    nb = X - h0 - h1  # and its halo
    dev = vol.tsdf.device
    Fh, Wt = vol.tsdf, vol.weight
    ins, val = Fh < 0, Wt != 0  # (X, Y, Z)

    # cell occupancy as marching cubes (X-1, Y-1, Z-1), then padded to Z
    pz_val = val[:, :, :-1] & val[:, :, 1:]
    pz_in = ins[:, :, :-1] & ins[:, :, 1:]
    pz_out = ~ins[:, :, :-1] & ~ins[:, :, 1:]

    def cell4(p):
        return p[:-1, :-1] & p[1:, :-1] & p[:-1, 1:] & p[1:, 1:]

    occ = cell4(pz_val) & ~cell4(pz_in) & ~cell4(pz_out)
    del pz_val, pz_in, pz_out
    occ = torch.cat([occ, occ.new_zeros((X - 1, Y - 1, 1))], 2)

    # x-edges (i < X-1, j, k), incident to cells (i, j-{0,1}, k-{0,1})
    sx = (ins[:-1] ^ ins[1:]) & val[:-1] & val[1:]
    used_x = sx & _or_z_prev(_or_prev(occ, 1))
    del sx
    # y-edges (i, j < Y-1, k)
    sy = (ins[:, :-1] ^ ins[:, 1:]) & val[:, :-1] & val[:, 1:]
    used_y = sy & _or_z_prev(_or_prev(occ, 0))
    del sy
    # z-edges (i, j, k < Z-1)
    sz = torch.zeros_like(ins)
    sz[:, :, :-1] = (ins[:, :, :-1] ^ ins[:, :, 1:]) & val[:, :, :-1] \
        & val[:, :, 1:]
    used_z = sz & _or_prev(_or_prev(occ, 0), 1)
    del sz, occ, ins, val

    allm = torch.zeros((X, Y, 3, Z), dtype=torch.bool, device=dev)
    allm[:-1, :, 0] = used_x
    allm[:, :-1, 1] = used_y
    allm[:, :, 2] = used_z
    del used_x, used_y, used_z
    allm = allm[h0:h0 + nb].reshape(nb * Y * 3, Z)  # the block's own edges

    fill = nb * Y * 3 * Z
    K = min(col_budget, Z)
    if 0 < K <= 32:
        flat_idx, n_total, n_captured = compaction.extract_columns(
            allm, per_column=K,
            max_cols=min(Xg * Y * 3, max(max_edges, 1 << 15)),
            max_out=max_edges, row_stride=Z, fill=fill, prefix=prefix)
    else:
        nw = (Z + 31) // 32
        flat_idx, n_total, n_captured = compaction.extract_bits(
            allm, max_out=max_edges, row_stride=Z, fill=fill,
            max_words=min(Xg * Y * 3 * nw, max(max_edges, 1 << 15)),
            prefix=prefix)
    del allm

    ok = flat_idx < fill
    safe = torch.where(ok, flat_idx, 0)
    c = torch.div(safe, Z, rounding_mode="floor")
    z = safe - c * Z
    i = torch.div(c, Y * 3, rounding_mode="floor") + h0  # plane held
    r = c - (i - h0) * (Y * 3)
    j = torch.div(r, 3, rounding_mode="floor")
    a = r - j * 3

    dxa, dya, dza = (a == 0).long(), (a == 1).long(), (a == 2).long()
    i1 = torch.clamp_max(i + dxa, X - 1)
    j1 = torch.clamp_max(j + dya, Y - 1)
    z1 = torch.clamp_max(z + dza, Z - 1)
    f0 = Fh[i, j, z].to(torch.float32)
    f1 = Fh[i1, j1, z1].to(torch.float32)

    vs = torch.as_tensor(np.asarray(config.voxel_size, np.float32), device=dev)
    shift = 0.5 if convention == "center" else 0.0
    p0 = (torch.stack([i + (x0 - h0), j, z], -1).to(torch.float32)
          + shift) * vs
    axis_dir = torch.stack([dxa, dya, dza], -1).to(torch.float32) * vs
    t = (0.0 - f0) / (f1 - f0 + 1e-15)  # vertex_interp, mc.cu:197-204
    verts = torch.where(ok[:, None], p0 + t[:, None] * axis_dir, 0.0)

    n_dropped = n_total - n_captured
    if not with_normals:
        return verts, n_captured, n_dropped

    def lattice_grad(ii, jj, zz):
        # differences taken in float16, as the source does
        gx = (Fh[torch.clamp_max(ii + 1, X - 1), jj, zz]
              - Fh[torch.clamp_min(ii - 1, 0), jj, zz]).to(torch.float32)
        gy = (Fh[ii, torch.clamp_max(jj + 1, Y - 1), zz]
              - Fh[ii, torch.clamp_min(jj - 1, 0), zz]).to(torch.float32)
        gz = (Fh[ii, jj, torch.clamp_max(zz + 1, Z - 1)]
              - Fh[ii, jj, torch.clamp_min(zz - 1, 0)]).to(torch.float32)
        return torch.stack([gx, gy, gz], -1)

    vs_inv = 1.0 / vs
    g = (lattice_grad(i, j, z) * (1.0 - t)[:, None]
         + lattice_grad(i1, j1, z1) * t[:, None]) * vs_inv
    norms = g / torch.clamp_min(torch.linalg.vector_norm(g, dim=-1,
                                                         keepdim=True), 1e-30)
    gi = torch.round(verts * vs_inv).to(torch.int64)
    inside = ((gi[:, 0] > 1) & (gi[:, 0] < Xg - 2)
              & (gi[:, 1] > 1) & (gi[:, 1] < Y - 2)
              & (gi[:, 2] > 1) & (gi[:, 2] < Z - 2))
    norms = torch.where((ok & inside)[:, None], norms, torch.nan)
    return verts, n_captured, n_dropped, norms
