"""Load state from the JAX package into this port.

The JAX engine's state arrives as plain numpy arrays and frozen dataclasses
(this module imports neither jax nor dynfu_tpu): the dataclasses convert
field by field by name, and the arrays become tensors on the port's device.
The rigid, parity, fixed and fusion tests use it to start the port's frame
k+1 from the JAX engine's state after frame k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynfu_tpu_torch.core.camera import Intr
from dynfu_tpu_torch.engine.dynfusion import DynFusion, Frame
from dynfu_tpu_torch.engine.kinfu import KinFu
from dynfu_tpu_torch.engine.params import (DynFuParams, KinFuParams,
                                           SolverParams)
from dynfu_tpu_torch.volume.tsdf import TsdfVolume
from dynfu_tpu_torch.warp.field import WarpField

_PORT_CLASSES = {"Intr": Intr, "KinFuParams": KinFuParams,
                 "SolverParams": SolverParams, "DynFuParams": DynFuParams}


def params(src):
    """A port dataclass from the same-named dataclass of the JAX package
    (nested dataclasses convert recursively; unknown fields raise)."""
    cls = _PORT_CLASSES[type(src).__name__]
    kw = {}
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        kw[f.name] = params(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)


def volume(tsdf, weight, pose_r, pose_t, device) -> TsdfVolume:
    return TsdfVolume(_t(tsdf, device, torch.float16),
                      _t(weight, device, torch.uint8),
                      _t(pose_r, device, torch.float32),
                      _t(pose_t, device, torch.float32))


def warpfield(pos, dqs, w, mask, count, device) -> WarpField:
    return WarpField(_t(pos, device, torch.float32),
                     _t(dqs, device, torch.float32),
                     _t(w, device, torch.float32),
                     _t(mask, device, torch.bool),
                     _t(np.int32(count), device, torch.int32))


def frame(idx, vertices, normals, mask, device) -> Frame:
    return Frame(int(idx), _t(vertices, device, torch.float32),
                 _t(normals, device, torch.float32),
                 _t(mask, device, torch.bool))


def pyramid(levels, device):
    """[(points, normals)] per level -> tensors."""
    return [(_t(p, device, torch.float32), _t(n, device, torch.float32))
            for p, n in levels]


def _poses(poses):
    return [(np.asarray(R, np.float32), np.asarray(t, np.float32))
            for R, t in poses]


def load_kinfu_state(engine: KinFu, *, vol, poses, prev_pyr,
                     frame_counter: int) -> KinFu:
    """Install a JAX KinFu's state after a frame into `engine`: vol =
    (tsdf, weight, pose_r, pose_t), poses a list of (R, t), prev_pyr the
    reference pyramid [(points, normals)] (None before frame 0)."""
    dev = engine.device
    engine.vol = volume(*vol, device=dev)
    engine.poses = _poses(poses)
    engine.prev_pyr = None if prev_pyr is None else pyramid(prev_pyr, dev)
    engine.frame_counter = int(frame_counter)
    return engine


def load_engine_state(engine: DynFusion, *, vol, wf, canonical,
                      frame_counter: int, poses, soup_inverse=None,
                      soup_mask=None, canonical_mult=None,
                      canonical_warped=None, prev_live_pyr=None,
                      fg_canonical=None, fg_mult=None,
                      prev_pyr=None) -> DynFusion:
    """Install the JAX engine's state after a frame into `engine`.

    vol = (tsdf, weight, pose_r, pose_t), wf = (pos, dqs, w, mask, count),
    canonical, canonical_warped and fg_canonical = (idx, vertices, normals,
    mask) (the warped one defaults to the canonical); poses a list of (R,
    t). The soup dedup state (soup_inverse, soup_mask, canonical_mult)
    exists in parity and fixed mode only; a fusion-mode canonical is the
    unique edge vertex set itself. fg_canonical and fg_mult are foreground
    tracking's canonical and soup multiplicities. prev_live_pyr is fusion
    camera tracking's reference pyramid, prev_pyr fixed mode's ICP
    reference (the raycast pyramid), each [(points, normals)]."""
    dev = engine.device
    engine.vol = volume(*vol, device=dev)
    engine.warpfield = warpfield(*wf, device=dev)
    engine.canonical = frame(*canonical, device=dev)
    engine.canonical_warped = (engine.canonical if canonical_warped is None
                               else frame(*canonical_warped, device=dev))
    if soup_inverse is not None:
        engine.soup_inverse = _t(soup_inverse, dev, torch.int32)
        engine.soup_mask = _t(soup_mask, dev, torch.bool)
        engine.canonical_mult = _t(canonical_mult, dev, torch.float32)
    if fg_canonical is not None:
        engine._fg_canonical = frame(*fg_canonical, device=dev)
        engine._fg_mult = _t(fg_mult, dev, torch.float32)
    if prev_live_pyr is not None:
        engine.prev_live_pyr = pyramid(prev_live_pyr, dev)
    if prev_pyr is not None:
        engine.prev_pyr = pyramid(prev_pyr, dev)
    engine.frame_counter = int(frame_counter)
    engine.poses = _poses(poses)
    return engine
