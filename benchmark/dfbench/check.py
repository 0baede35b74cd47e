"""What decides `correct`: the program's outputs against the plain reference.

The reference (plainref, a frozen copy of the port's engines with every
kernel replaced by its plain PyTorch version) is given the frames the
program was given. It runs

* the start: frames 0 .. start_frame from scratch, in its own state, and
  is compared with the program after the same frames (and, for the
  non-rigid engine, the canonical surface of frame 0);
* each checked frame of the window from the state the program held before
  it (the warp field; for KinFu the previous pose, from which it works out
  again the previous frame's volume, raycast and pyramid), and is compared
  with the program's outputs of that frame.

`numbers` turns two sets of outputs into the compared numbers; `judge`
holds them against the configuration's limits. The control
(`control_hooks`) is the reference computed in bfloat16: every float
result of the frame's stages rounded to bfloat16 where it is produced.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch

from dfbench import engines

# sample of surface vertices whose nearest counterpart is looked up
SURFACE_SAMPLE = 4096


def _max_abs(a, b) -> float:
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def _nearest_gap(a: np.ndarray, b: np.ndarray, rng, device) -> float:
    """The largest distance from a sample of a's points to b's nearest
    (m); inf when one side is empty and the other not."""
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else math.inf
    idx = rng.choice(len(a), min(SURFACE_SAMPLE, len(a)), replace=False)
    q = torch.as_tensor(a[idx], dtype=torch.float64, device=device)
    p = torch.as_tensor(b, dtype=torch.float64, device=device)
    best = torch.full((len(q),), math.inf, dtype=torch.float64, device=device)
    for j in range(0, len(p), 1 << 16):
        d = torch.cdist(q, p[j:j + (1 << 16)])
        best = torch.minimum(best, d.min(1).values)
    return float(best.max())


def _tsdf_gap(p, r) -> float:
    """TSDF of the compared voxels (its units), a weight that differs read
    as its difference in frames."""
    return max(_max_abs(p["tsdf"], r["tsdf"]),
               _max_abs(p["weight"], r["weight"]))


def dynfusion_numbers(p: dict, r: dict, rng, device) -> dict:
    """The non-rigid frame's numbers (each a gap, 0 when equal)."""
    ok = p["corr_ok"] & r["corr_ok"] if p["corr_ok"].shape == \
        r["corr_ok"].shape else None
    q = max(len(p["corr_ok"]), 1)
    out = {
        "dists_gap_m": _max_abs(p["dists"], r["dists"]),
        "tsdf_gap": _tsdf_gap(p, r),
        "surface_gap_m": max(_nearest_gap(p["live"], r["live"], rng, device),
                             _nearest_gap(r["live"], p["live"], rng, device)),
        "warped_gap_m": _max_abs(p["warped"], r["warped"]),
        "corr_gap_m": (math.inf if ok is None
                       else _max_abs(p["corr"][ok], r["corr"][ok])),
        "corr_count_gap": (math.inf if ok is None else
                           abs(int(p["corr_ok"].sum()) - int(r["corr_ok"].sum()))
                           / q),
        # the whole node table: a node missing or extra (insertion) reads
        # inf
        "node_pos_gap_m": _max_abs(p["node_pos"], r["node_pos"]),
        "node_dq_gap": _max_abs(p["node_dqs"], r["node_dqs"]),
    }
    return out


def kinfu_numbers(p: dict, r: dict, rng, device) -> dict:
    """The rigid frame's numbers (each a gap, 0 when equal)."""
    del rng, device
    vp = np.isfinite(p["points"]).all(-1) if p["points"].shape == \
        r["points"].shape else None
    if vp is None:
        ray = dict(raycast_gap_m=math.inf, raycast_mask_gap=math.inf,
                   normal_gap=math.inf)
    else:
        vr = np.isfinite(r["points"]).all(-1)
        both = vp & vr
        ray = dict(
            raycast_gap_m=_max_abs(p["points"][both], r["points"][both]),
            raycast_mask_gap=float((vp != vr).sum()) / vp.size,
            normal_gap=_max_abs(p["normals"][both], r["normals"][both]))
    return {
        "dists_gap_m": _max_abs(p["dists"], r["dists"]),
        "tsdf_gap": _tsdf_gap(p, r),
        "pose_gap_m": float(np.linalg.norm(p["t"] - r["t"])),
        "pose_rot_gap": _max_abs(p["R"], r["R"]),
        **ray,
    }


NUMBERS = {"dynfusion": dynfusion_numbers, "kinfu": kinfu_numbers}


def merge(into: dict, more: dict) -> dict:
    """The worst of each number."""
    for k, v in more.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


def judge(nums: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number within its limit;
    a number without a limit, or one that is NaN, fails."""
    rows, ok = [], True
    for name in sorted(nums):
        v, lim = nums[name], limits.get(name)
        good = lim is not None and v == v and v <= lim
        ok &= good
        rows.append((name, v, lim))
    return ok, rows


# --- the control: the reference in bfloat16 ---------------------------------
def _round(x):
    """Every float tensor in x rounded to bfloat16, in its own dtype."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float32, torch.float16, torch.float64):
            return x.to(torch.bfloat16).to(x.dtype)
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_round(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_round(v) for v in x)
    return x


# the stages whose results the control rounds, by engine kind
CONTROL_STAGES = {
    "dynfusion": [("ops.imgproc", "compute_dists"),
                  ("volume.tsdf", "integrate"),
                  ("mesh.edges", "isosurface_edge_vertices"),
                  ("mesh.mc", "marching_cubes"),
                  ("warp.field", "warp_points_normals"),
                  ("ops.knn", "nn1_gather_xwindow"),
                  ("solver.gn", "solve"),
                  ("warp.field", "update_warpfield")],
    "kinfu": [("ops.imgproc", "compute_dists"),
              ("ops.imgproc", "bilateral_filter"),
              ("ops.imgproc", "compute_points_normals"),
              ("volume.tsdf", "integrate"),
              ("volume.tsdf", "raycast_rotated"),
              ("volume.tsdf", "raycast_separable"),
              ("volume.tsdf", "raycast"),
              ("rigid.icp", "estimate_transform_stencil"),
              ("rigid.icp", "estimate_transform"),
              ("rigid.icp", "build_pyramids")],
}


@contextlib.contextmanager
def control_hooks(kind: str):
    """Inside: the reference's stages round their float results to
    bfloat16 (the nearest precision below the configuration's float32)."""
    undo = []
    try:
        for mod, attr in CONTROL_STAGES[kind]:
            m = importlib.import_module(f"plainref.{mod}")
            fn = getattr(m, attr)

            def rounded(*a, _fn=fn, **kw):
                return _round(_fn(*a, **kw))
            setattr(m, attr, rounded)
            undo.append((m, attr, fn))
        yield
    finally:
        for m, attr, fn in reversed(undo):
            setattr(m, attr, fn)


# --- running the reference --------------------------------------------------
class Reference:
    """The plain reference engine of one configuration and mix."""

    def __init__(self, config: dict, mix: dict, device, voxel_offset: int):
        self.config, self.mix, self.device = config, mix, device
        self.offset = voxel_offset
        self.adapter = engines.ADAPTERS[config["engine"]]
        self.probe = engines.Probe("plainref", self.adapter.probes)
        self.probe.armed = True
        self.eng = None

    def close(self):
        self.probe.remove()
        self.eng = None

    def start(self, frames) -> tuple:
        """Frames 0 .. start_frame from scratch, on a new engine: (start
        outputs after frame 0, outputs after start_frame)."""
        a = self.adapter
        self.eng = None
        self.eng = engines.build("plainref", self.config, self.mix,
                                 self.device)
        self.eng(frames.depth(0))
        first = a.start_outputs(self.eng)
        for k in range(1, a.start_frame + 1):
            self.eng(frames.depth(k))
        return first, a.outputs(self.eng, self.probe, self.offset)

    def frame(self, frames, k: int, state: dict) -> dict:
        """Frame k from the program's state before it (after `start`)."""
        a = self.adapter
        a.set_state(self.eng, state, self.device, frames.depth(k - 1))
        self.eng(frames.depth(k))
        return a.outputs(self.eng, self.probe, self.offset)


def _reference(config, mix, frames, voxel_offset, samples, device):
    """The reference's start and its outputs of the sampled frames."""
    ref = Reference(config, mix, device, voxel_offset)
    try:
        start = ref.start(frames)
        return start, [ref.frame(frames, k, st) for k, st, _ in samples]
    finally:
        ref.close()


def compare(config, mix, frames, voxel_offset, start, samples, device, rng,
            control: bool = False) -> dict:
    """The compared numbers: the program's start and sampled outputs
    (`start` = (start outputs, outputs after start_frame); `samples` =
    [(k, state before, outputs)]) against the reference's; with `control`
    the reference's bfloat16 twin stands in for the program."""
    kind = config["engine"]
    fn = NUMBERS[kind]
    (r_first, r_start), refs = _reference(config, mix, frames, voxel_offset,
                                          samples, device)
    if control:
        with control_hooks(kind):
            start, outs = _reference(config, mix, frames, voxel_offset,
                                     samples, device)
        samples = [(k, st, o) for (k, st, _), o in zip(samples, outs)]
    nums = {}
    if kind == "dynfusion":
        nums["canonical_gap_m"] = _max_abs(start[0]["canonical"],
                                           r_first["canonical"])
    merge(nums, fn(start[1], r_start, rng, device))
    for (_, _, out), r in zip(samples, refs):
        merge(nums, fn(out, r, rng, device))
    return nums
