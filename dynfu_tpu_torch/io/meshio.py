"""Dataset loading and point-cloud/mesh export.

Port of dynfu_tpu/io/meshio.py. The exporters are the source's numpy code
(save_ply writes through save_ply_indexed), so their bytes are the
source's:
* save_pcd: ASCII PCD v0.7, pcl::io::savePCDFileASCII's layout (demo.cpp:21-31);
* save_vtk / save_ply: the triangle soup (3 consecutive vertices per
  triangle) indexed by _soup_to_indexed, with the reference's winding
  (0, 2, 1 — convertToMesh, kinfu.cpp:250-257);
* save_ply_indexed: an already-indexed mesh.

The source decodes and encodes PNGs with PIL; this port has its own codec
(numpy, zlib and struct): it reads non-interlaced 8- and 16-bit greyscale,
RGB and RGBA PNGs with any of the five row filters, and 16-bit binary PGM,
and writes filter-0 PNGs. Colour images read as 8-bit RGB (a 16-bit
channel keeps its high byte, as PIL's decode does).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) -> (h, stride) uint8. None,
    Sub and Up are vector operations (Sub: a cumulative sum mod 256 per byte
    lane); Average and Paeth depend on the byte before and run per byte."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {int(ftype)}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8/uint16 greyscale or (H, W, 3) uint8 RGB."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth "
                         f"{depth} (8/16-bit grey, RGB or RGBA only)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = px.view(">u2").astype(np.uint16) if depth == 16 else px
    px = px.reshape(h, w, ch)
    if ch == 1:
        return px[..., 0]
    rgb = px[..., :3]
    return (rgb >> 8).astype(np.uint8) if depth == 16 else rgb


def _decode_pgm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) -> (H, W) uint8 or big-endian-decoded uint16."""
    fields, pos = [], 2
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    pos += 1  # the single whitespace byte before the raster
    dtype = ">u2" if maxval > 255 else np.uint8
    n = w * h * (2 if maxval > 255 else 1)
    return (np.frombuffer(data[pos:pos + n], dtype).astype(
        np.uint16 if maxval > 255 else np.uint8).reshape(h, w))


def read_image(path: str) -> np.ndarray:
    """A PNG or binary PGM file -> its pixel array (see decode_png)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P5":
        return _decode_pgm(data)
    return decode_png(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint8/uint16 greyscale, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    -> PNG bytes, every row with filter 0."""
    img = np.asarray(img)
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    if img.dtype == np.uint16 and ctype == 0:
        depth, px = 16, img.astype(">u2")
    elif img.dtype == np.uint8:
        depth, px = 8, img
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(px).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG (or PGM) in millimeters -> (H, W) int32."""
    arr = read_image(path)
    if arr.ndim == 3:  # some tools save depth replicated across channels
        arr = arr[..., 0]
    return arr.astype(np.int32)


def load_color_png(path: str) -> np.ndarray:
    """8-bit color PNG -> (H, W, 3) uint8 (the reference's cv::imread of
    the color/ directory, demo.cpp:46-55; the pipeline's math never reads
    it — the frame API carries it for parity). A greyscale file is
    replicated to three channels, 16-bit values clipped at 255 (PIL's
    convert("RGB"))."""
    arr = read_image(path)
    if arr.ndim == 2:
        arr = np.repeat(np.minimum(arr, 255).astype(np.uint8)[..., None], 3,
                        axis=-1)
    return arr


def list_dataset(root: str) -> Tuple[List[str], List[str]]:
    """Sorted depth/ and color/ file lists (DynFuApp::loadFiles,
    demo.cpp:39-55). color/ may be absent (depth-only pipeline)."""
    depth_dir = os.path.join(root, "depth")
    if not os.path.isdir(depth_dir):
        raise FileNotFoundError(
            f"dataset dir {root!r} must contain a depth/ subdirectory"
        )
    depths = sorted(
        os.path.join(depth_dir, f)
        for f in os.listdir(depth_dir)
        if f.lower().endswith((".png", ".pgm"))
    )
    color_dir = os.path.join(root, "color")
    colors = (
        sorted(
            os.path.join(color_dir, f)
            for f in os.listdir(color_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if os.path.isdir(color_dir)
        else []
    )
    return depths, colors


def save_pcd(path: str, points: np.ndarray) -> None:
    """ASCII PCD v0.7 (x y z), matching pcl::io::savePCDFileASCII output."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, points, fmt="%.9g")


def _soup_to_indexed(tri_soup: np.ndarray):
    """Triangle soup (3N, 3) -> (unique vertices, faces) with the reference
    winding 0,2,1 (convertToMesh, kinfu.cpp:250-257)."""
    tri_soup = np.asarray(tri_soup, np.float32)
    n_tris = len(tri_soup) // 3
    soup = tri_soup[: 3 * n_tris]
    q = np.round(soup.astype(np.float64) / 1e-7).astype(np.int64)
    uniq, inv = np.unique(q, axis=0, return_inverse=True)
    verts = uniq.astype(np.float64) * 1e-7
    faces = inv.reshape(-1, 3)[:, [0, 2, 1]]
    return verts.astype(np.float32), faces.astype(np.int64)


def save_vtk(path: str, tri_soup: np.ndarray) -> None:
    """Legacy ASCII VTK PolyData, like pcl::io::saveVTKFile."""
    verts, faces = _soup_to_indexed(tri_soup)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nvtk output\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {len(verts)} float\n")
        np.savetxt(f, verts, fmt="%.9g")
        f.write(f"POLYGONS {len(faces)} {len(faces) * 4}\n")
        np.savetxt(
            f,
            np.concatenate([np.full((len(faces), 1), 3), faces], axis=1),
            fmt="%d",
        )


def save_ply(path: str, tri_soup: np.ndarray) -> None:
    """Binary-less ASCII PLY triangle mesh."""
    verts, faces = _soup_to_indexed(tri_soup)
    save_ply_indexed(path, verts, faces)


def save_ply_indexed(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY from an already-indexed (verts, faces) mesh."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        np.savetxt(f, np.asarray(verts, np.float32), fmt="%.9g")
        np.savetxt(
            f,
            np.concatenate(
                [np.full((len(faces), 1), 3), np.asarray(faces)], axis=1
            ),
            fmt="%d",
        )


def save_depth_png(path: str, depth_mm: np.ndarray) -> None:
    """16-bit depth PNG writer (for the synthetic dataset generator)."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(depth_mm).astype(np.uint16)))


def save_image_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))
