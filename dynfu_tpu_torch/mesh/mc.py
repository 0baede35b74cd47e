"""Marching cubes on the TSDF volume.

Port of dynfu_tpu/mesh/mc.py (the reference's two-pass GPU marching cubes,
marching_cubes.cu). Semantics kept:

* a cell participates only if all 8 corner weights are nonzero and its
  corners are not all on one side of the isosurface (inside = tsdf < 0);
* cells are visited in x-major order with z fastest — the correspondence's
  x-window depends on this emission order;
* vertices sit on cell edges between voxel CENTRES (+0.5 voxel, the
  reference's getNodeCoo — half a voxel off its integrator's corner
  samples, a parity quirk), interpolated by t = (0 - f0) / (f1 - f0 + 1e-15);
* output is a flat vertex stream, 3 per triangle, in volume-frame meters,
  in a fixed-capacity buffer with a count.

Compaction is one dense `torch.nonzero` over the cell field, capped at
`max_voxels`; `n_dropped` counts occupied cells beyond the cap. (The source
compacts 128^3 and larger volumes through bit-packed columns with a
per-column budget; its order equals the dense scan whenever nothing
overflows, and its n_dropped also counts per-column budget overflows, which
this port does not have.) The triangle rows are packed into the stream by
the CUDA kernel in mesh/mc_cuda.py.
"""

from __future__ import annotations

import numpy as np
import torch

from dynfu_tpu_torch.mesh import mc_cuda, tables
from dynfu_tpu_torch.volume.tsdf import TsdfConfig, TsdfVolume


def marching_cubes(vol: TsdfVolume, config: TsdfConfig,
                   max_voxels: int = 1 << 17, max_verts: int = 3 * 600_000):
    """Extract the zero isosurface as a triangle soup.

    Returns (vertices (max_verts, 3) float32 volume-frame meters,
             n_verts () int32, n_dropped () int32 occupied cells not meshed).
    """
    X, Y, Z = config.dims
    dev = vol.tsdf.device
    F, Wt = vol.tsdf, vol.weight
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
    occ = (all_w & ~all_in & ~all_out).reshape(-1)
    occ_idx = torch.nonzero(occ).reshape(-1)[:max_voxels].to(torch.int64)
    n_occ = torch.sum(occ, dtype=torch.int32)
    vox_idx = torch.full((max_voxels,), n_cells, dtype=torch.int64,
                         device=dev)
    vox_idx[:occ_idx.shape[0]] = occ_idx
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
    base = torch.stack([vx, vy, vz], dim=-1).to(torch.float32)  # (M, 3)
    offs_t = torch.as_tensor(offs, dtype=torch.float32, device=dev)
    corner_pos = (base[:, None, :] + offs_t[None] + 0.5) * vs  # (M, 8, 3)

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
    tris = verts.reshape(-1, 5, 9).contiguous()
    out = mc_cuda.pack_triangles(tris, torch.div(v_offsets, 3,
                                                 rounding_mode="floor"),
                                 torch.div(occ_nverts, 3,
                                           rounding_mode="floor"),
                                 max_tris)
    stream = out.reshape(max_tris * 3, 3)
    if max_tris * 3 < max_verts:
        stream = torch.nn.functional.pad(stream,
                                         (0, 0, 0, max_verts - max_tris * 3))
    total = torch.clamp_max(v_offsets[-1] + occ_nverts[-1], max_tris * 3)
    return stream, total.to(torch.int32), n_dropped
