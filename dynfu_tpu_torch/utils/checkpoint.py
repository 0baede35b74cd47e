"""Checkpoint / resume of the DynFusion engine's state.

Port of dynfu_tpu/utils/checkpoint.py, with its format: one compressed .npz
(written to a temporary file and renamed, so a reader never sees half a
checkpoint) holding the float16 tsdf, the uint8 weights, the volume pose,
the host float32 camera poses, the warp field, both canonical frames, the
soup dedup state, and a `meta` JSON (frame counter, which parts exist, the
frames' indices). A checkpoint written by either package loads in the
other. The reference has no checkpointing (SURVEY §5).

Only the source's keys are saved. Derived state is rebuilt on load: fixed
mode's ICP reference (the raycast pyramid of the restored volume from the
last pose, as the engine builds it after every frame but frame 0; the
source rebuilds it after frame 0 too) and foreground
tracking's canonical (the compaction of the restored canonical to the box).
Fusion mode's tracking pyramid (prev_live_pyr) is not in the format; a
fusion engine with camera tracking restarts it on its next frame.

A sharded engine (dist/driver.ShardedDynFusion, parity or fusion mode)
saves its gathered state from rank 0 (every rank takes part in the gather;
fusion mode's canonical and warped canonical are replicated already, so
only its volume is gathered) and loads on every rank, then shards the
restored state again; the file is the same format.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from dynfu_tpu_torch.engine.dynfusion import DynFusion


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(engine: "DynFusion", path: str) -> None:
    """Serialize engine state to `path` (.npz, atomically); a sharded
    engine's on every rank (collective), written by rank 0."""
    from dynfu_tpu_torch.dist.driver import ShardedDynFusion
    from dynfu_tpu_torch.dist.runtime import is_primary

    if isinstance(engine, ShardedDynFusion):
        with engine.gathered() as full:
            if is_primary():
                save_checkpoint(full, path)
        return
    arrays = {
        "tsdf": _np(engine.vol.tsdf),
        "weight": _np(engine.vol.weight),
        "pose_r": _np(engine.vol.pose_r),
        "pose_t": _np(engine.vol.pose_t),
        "poses_r": np.stack([np.asarray(r) for r, _ in engine.poses]),
        "poses_t": np.stack([np.asarray(t) for _, t in engine.poses]),
    }
    meta = {"frame_counter": engine.frame_counter, "has_warpfield": False}
    if engine.warpfield is not None:
        wf = engine.warpfield
        arrays.update(wf_pos=_np(wf.pos), wf_dqs=_np(wf.dqs), wf_w=_np(wf.w),
                      wf_mask=_np(wf.mask), wf_count=_np(wf.count))
        meta["has_warpfield"] = True
    for name, frame in (("canonical", engine.canonical),
                        ("canonical_warped", engine.canonical_warped)):
        if frame is not None:
            arrays[f"{name}_v"] = _np(frame.vertices)
            arrays[f"{name}_n"] = _np(frame.normals)
            arrays[f"{name}_m"] = _np(frame.mask)
            meta[f"{name}_idx"] = int(frame.idx)
    if engine.soup_inverse is not None:
        arrays["soup_inverse"] = _np(engine.soup_inverse)
        arrays["soup_mask"] = _np(engine.soup_mask)
        arrays["canonical_mult"] = _np(engine.canonical_mult)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)

    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # the suffix must end in .npz, or numpy appends one and the rename misses
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(engine: "DynFusion", path: str) -> "DynFusion":
    """Restore engine state from `path` in place, on the engine's device
    (a sharded engine: on every rank, then sharded again); returns the
    engine."""
    from dynfu_tpu_torch.dist.driver import ShardedDynFusion
    from dynfu_tpu_torch.engine.dynfusion import Frame
    from dynfu_tpu_torch.rigid import icp
    from dynfu_tpu_torch.volume import tsdf as tv
    from dynfu_tpu_torch.warp.field import WarpField

    if isinstance(engine, ShardedDynFusion):
        load_checkpoint(engine.engine, path)
        engine.reshard()
        return engine
    dev = engine.device
    with np.load(path) as z:
        arr = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arr["meta"]).decode())

    def t(key, dtype):
        return torch.as_tensor(arr[key], dtype=dtype, device=dev)

    f32 = torch.float32
    engine.vol = engine.vol._replace(
        tsdf=t("tsdf", torch.float16), weight=t("weight", torch.uint8),
        pose_r=t("pose_r", f32), pose_t=t("pose_t", f32))
    # poses stay host float32 pairs, as the engine keeps them
    engine.poses = [(np.asarray(r, np.float32), np.asarray(q, np.float32))
                    for r, q in zip(arr["poses_r"], arr["poses_t"])]
    engine.frame_counter = int(meta["frame_counter"])
    if meta["has_warpfield"]:
        engine.warpfield = WarpField(
            pos=t("wf_pos", f32), dqs=t("wf_dqs", f32), w=t("wf_w", f32),
            mask=t("wf_mask", torch.bool), count=t("wf_count", torch.int32))
    for name in ("canonical", "canonical_warped"):
        if f"{name}_v" in arr:
            setattr(engine, name, Frame(
                idx=int(meta[f"{name}_idx"]), vertices=t(f"{name}_v", f32),
                normals=t(f"{name}_n", f32),
                mask=t(f"{name}_m", torch.bool)))
    if "soup_inverse" in arr:
        engine.soup_inverse = t("soup_inverse", torch.int32)
        engine.soup_mask = t("soup_mask", torch.bool)
        engine.canonical_mult = t("canonical_mult", f32)
    else:
        engine.soup_inverse = engine.soup_mask = engine.canonical_mult = None
    engine.mesh_vertices = None

    if engine.frame_counter > 0 and engine._fg_enabled():
        engine._fg_canonical, engine._fg_mult = engine._fg_compact(
            engine.canonical)
    # fixed mode refreshes its reference after every frame but frame 0
    if engine.mode == "fixed" and engine.frame_counter > 1:
        p = engine.params
        pts, nrm = tv.raycast(engine.vol, engine.poses[-1], p.intr,
                              (p.rows, p.cols), engine.tsdf_config)
        engine.prev_pyr = icp.build_pyramids(pts, nrm, engine.levels)
    return engine
