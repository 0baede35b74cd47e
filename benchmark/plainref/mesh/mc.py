"""Marching cubes on the TSDF volume.

Port of dynfu_tpu/mesh/mc.py (the reference's two-pass GPU marching cubes,
marching_cubes.cu). Semantics kept:

* a cell participates only if all 8 corner weights are nonzero and its
  corners are not all on one side of the isosurface (inside = tsdf < 0);
* cells are visited in x-major order with z fastest — the correspondence's
  x-window depends on this emission order;
* `convention="center"` puts corner i at (i + 0.5) voxels (the reference's
  getNodeCoo, half a voxel off its integrator's corner samples: the parity
  quirk); `convention="corner"` at i voxels, consistent with the integrator
  (fusion mode needs it);
* vertices are interpolated by t = (0 - f0) / (f1 - f0 + 1e-15);
* output is a flat vertex stream, 3 per triangle, in volume-frame meters,
  in a fixed-capacity buffer with a count.

Compaction follows the source's two branches exactly, so that the captured
cells, their order and `n_dropped` match it under overflow too: below 2^18
cells, the first `max_voxels` occupied cells; from 2^18 cells on, the
column-budget rule of ops/compaction.extract_columns (the first K cells of
each (x, y) column, at most max(max_voxels // 4, 2^15) active columns, at
most `max_voxels` cells). `n_dropped` counts occupied cells not meshed. The
triangle rows are packed into the stream by the CUDA kernel in
mesh/mc_cuda.py.

On an x-block of a sharded volume (dist/), `vol` holds the block's planes
from x0 and `halo` = (h0, h1) neighbouring planes (the cells need the +1
plane; the planes below and any beyond the +1 plane are not read), and
`prefix` applies the capacities over
all blocks (ops/compaction.py): the block meshes exactly the cells of its
own that the whole volume's marching cubes meshes, and its soup is the
whole soup's rows from the blocks before it on, cut at `max_verts` as the
whole soup is.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref.mesh import mc_cuda, tables
from plainref.ops import compaction
from plainref.volume.tsdf import TsdfConfig, TsdfVolume


# default vertex-buffer capacity / 3 (dynfu_tpu/mesh/mc.py:46)
MAX_TRIANGLES = 2_000_000


def marching_cubes(vol: TsdfVolume, config: TsdfConfig,
                   max_voxels: int = 1 << 17, max_verts: int = 3 * 600_000,
                   convention: str = "center", col_budget: int = 0,
                   x0: int = 0, halo=(0, 0), prefix=None):
    """Extract the zero isosurface as a triangle soup.

    Returns (vertices (max_verts, 3) float32 volume-frame meters,
             n_verts () int32, n_dropped () int32 occupied cells not meshed).
    """
    if convention not in ("center", "corner"):
        raise ValueError(f"unknown convention {convention!r}")
    Xg, Y, Z = config.dims
    dev = vol.tsdf.device
    h0, h1 = halo
    end = vol.tsdf.shape[0] - max(h1 - 1, 0)
    F, Wt = vol.tsdf[h0:end], vol.weight[h0:end]
    X = F.shape[0]  # the planes from x0 on: the block's and its +1 plane
    offs = tables.CORNER_OFFSETS

    # pass 1: occupancy over the (X-1, Y-1, Z-1) cell grid
    n_cells = (X - 1) * (Y - 1) * (Z - 1)
    all_w = all_in = all_out = None
    for i in range(8):
        dx, dy, dz = (int(v) for v in offs[i])
        fi = F[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
        wi = Wt[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
        ok, inside = wi != 0, fi < 0
        if i == 0:
            all_w, all_in, all_out = ok, inside, ~inside
        else:
            all_w = all_w & ok
            all_in = all_in & inside
            all_out = all_out & ~inside
    occ = all_w & ~all_in & ~all_out
    if (Xg - 1) * (Y - 1) * (Z - 1) < (1 << 18):
        n_occ = torch.sum(occ, dtype=torch.int32)
        vox_idx = compaction.rank_select(occ.reshape(-1), max_voxels, n_cells,
                                         prefix=prefix)
    else:
        # the source's column-budget branch: ~2 trunc / voxel cells per
        # surface crossing, two crossings plus margin (mc.py:164-166)
        K = col_budget or min(64, 4 + 4 * max(1, int(np.ceil(
            config.trunc_dist / config.voxel_size[2]))))
        K = min(K, Z - 1)
        ncols = (X - 1) * (Y - 1)
        vox_idx, n_occ, _ = compaction.extract_columns(
            occ.reshape(ncols, Z - 1), per_column=K,
            max_cols=min((Xg - 1) * (Y - 1), max(max_voxels // 4, 1 << 15)),
            max_out=max_voxels, row_stride=Z - 1, fill=n_cells,
            prefix=prefix)
    vox_valid = vox_idx < n_cells
    n_dropped = n_occ - torch.sum(vox_valid, dtype=torch.int32)

    # pass 2: triangles per occupied cell (flat id -> x, y, z; z fastest)
    cy, cz = Y - 1, Z - 1
    vx = vox_idx // (cy * cz)
    rem = vox_idx - vx * (cy * cz)
    vy = rem // cz
    vz = rem - vy * cz
    vx, vy, vz = (torch.where(vox_valid, c, 0) for c in (vx, vy, vz))

    fvals = torch.stack(
        [F[vx + int(o[0]), vy + int(o[1]), vz + int(o[2])] for o in offs],
        dim=-1).to(torch.float32)  # (M, 8)
    cubeidx = torch.zeros_like(vx)
    for i in range(8):
        cubeidx = cubeidx + (fvals[:, i] < 0.0).to(torch.int64) * (1 << i)
    cubeidx = torch.where(vox_valid, cubeidx, 0)

    tri_tab = torch.as_tensor(tables.TRI_TABLE, device=dev)
    nv_tab = torch.as_tensor(tables.NUM_VERTS_TABLE, device=dev)
    occ_nverts = torch.where(vox_valid, nv_tab[cubeidx], 0).to(torch.int32)
    v_offsets = torch.cumsum(occ_nverts, 0, dtype=torch.int32) - occ_nverts

    vs = torch.as_tensor(np.asarray(config.voxel_size, np.float32),
                         device=dev)
    base = torch.stack([vx + x0, vy, vz], dim=-1).to(torch.float32)
    offs_t = torch.as_tensor(offs, dtype=torch.float32, device=dev)
    shift = 0.5 if convention == "center" else 0.0
    corner_pos = (base[:, None, :] + offs_t[None] + shift) * vs  # (M, 8, 3)

    ec = torch.as_tensor(tables.EDGE_CORNERS, dtype=torch.int64, device=dev)
    p0, p1 = corner_pos[:, ec[:, 0]], corner_pos[:, ec[:, 1]]
    f0, f1 = fvals[:, ec[:, 0]], fvals[:, ec[:, 1]]
    t = (0.0 - f0) / (f1 - f0 + 1e-15)
    vertlist = p0 + t[..., None] * (p1 - p0)  # (M, 12, 3)

    rows = tri_tab[cubeidx][:, :15].to(torch.int64)  # (M, 15), -1 padded
    verts = torch.gather(vertlist, 1,
                         torch.clamp_min(rows, 0)[..., None].expand(-1, -1, 3))
    verts = torch.where((rows >= 0)[..., None], verts, 0.0)

    max_tris = max_verts // 3
    total = v_offsets[-1] + occ_nverts[-1]
    if prefix is not None:  # the triangles of the blocks before this one
        max_tris = max(0, max_tris - prefix([total])[0][0] // 3)
    tris = verts.reshape(-1, 5, 9).contiguous()
    if max_tris:
        stream = mc_cuda.pack_triangles(
            tris, torch.div(v_offsets, 3, rounding_mode="floor"),
            torch.div(occ_nverts, 3, rounding_mode="floor"),
            max_tris).reshape(max_tris * 3, 3)
    else:  # the blocks before this one filled the soup
        stream = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    if max_tris * 3 < max_verts:
        stream = torch.nn.functional.pad(stream,
                                         (0, 0, 0, max_verts - max_tris * 3))
    total = torch.clamp_max(total, max_tris * 3)
    return stream, total.to(torch.int32), n_dropped


def mesh_to_world(vertices: torch.Tensor, vol: TsdfVolume) -> torch.Tensor:
    """Volume-frame triangle vertices -> world frame by the volume pose (the
    rigid pipeline's convertToMesh, kinfu.cpp:237-259)."""
    return vertices @ vol.pose_r.T + vol.pose_t
