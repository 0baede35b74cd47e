"""Engines from configuration files, and what is read from them per frame.

A configuration (benchmark/configs/<name>.json) states the engine
("dynfusion" with its mode, or "kinfu"), the camera, the KinFuParams and
DynFuParams fields it sets, and the frames of set-up. `build` makes the
engine from one package: the program (dynfu_tpu_torch) or the plain
reference (plainref), which share their module layout. A mix may add the
capacities its scene needs (its "params").

Each engine kind has an adapter that knows its frame's output (what the
closed loop waits for), the state the next frame starts from, and what is
compared after a checked frame: `Probe` records, on the frames it is
armed for, the results of the calls its engine makes by module attribute.
"""

from __future__ import annotations

import functools
import importlib

import numpy as np
import torch

# every VOXEL_STRIDE-th voxel of the volume is compared, from an offset
# drawn from the seed
VOXEL_STRIDE = 31


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def params_for(pkg: str, config: dict, mix: dict):
    """The engine's parameters from the configuration and the mix."""
    pm = importlib.import_module(f"{pkg}.engine.params")
    cam = importlib.import_module(f"{pkg}.core.camera")
    c = config["camera"]
    intr = cam.Intr(c["fx"], c["fy"], c["cols"] / 2 - 0.5,
                    c["rows"] / 2 - 0.5)
    kp = pm.KinFuParams(rows=c["rows"], cols=c["cols"], intr=intr,
                        **{k: _tuples(v) for k, v in config["kinfu"].items()})
    if config["engine"] == "kinfu":
        return kp
    dyn = {k: _tuples(v) for k, v in config["dynfu"].items()}
    dyn.update({k: _tuples(v) for k, v in mix.get("params", {}).items()})
    if "solver" in dyn:
        dyn["solver"] = pm.SolverParams(**dict(dyn["solver"]))
    return pm.DynFuParams(kinfu=kp, **dyn)


def build(pkg: str, config: dict, mix: dict, device):
    """The configuration's engine from package `pkg`."""
    params = params_for(pkg, config, mix)
    if config["engine"] == "kinfu":
        mod = importlib.import_module(f"{pkg}.engine.kinfu")
        return mod.KinFu(params, device=device)
    mod = importlib.import_module(f"{pkg}.engine.dynfusion")
    return mod.DynFusion(params, device=device, mode=config["mode"])


class Probe:
    """Records the results of `module:attr` calls while armed. Installed on
    the program for the frames that are checked, and on the reference."""

    def __init__(self, pkg: str, targets: dict):
        self.calls = {}
        self.armed = False
        self._undo = []
        for name, (mod, attr) in targets.items():
            m = importlib.import_module(f"{pkg}.{mod}")
            orig = getattr(m, attr)
            setattr(m, attr, self._wrap(name, orig))
            self._undo.append((m, attr, orig))

    def _wrap(self, name, fn):
        @functools.wraps(fn)  # keeps the wrapper's counters (`launches`)
        def probe(*args, **kw):
            out = fn(*args, **kw)
            if self.armed:
                self.calls[name] = (args, kw, out)
            return out
        return probe

    def remove(self):
        for m, attr, orig in reversed(self._undo):
            setattr(m, attr, orig)
        self._undo = []


def host(t):
    return t.detach().cpu().numpy()


def _voxels(vol, offset: int):
    """Every VOXEL_STRIDE-th voxel (tsdf as float32, weight) from offset."""
    ts = vol.tsdf.reshape(-1)[offset::VOXEL_STRIDE]
    ws = vol.weight.reshape(-1)[offset::VOXEL_STRIDE]
    return host(ts.float()), host(ws.float())


class DynFusionAdapter:
    """The non-rigid engines (parity and fixed mode)."""

    kind = "dynfusion"
    probes = {"dists": ("ops.imgproc", "compute_dists"),
              "corr": ("ops.knn", "nn1_gather_xwindow")}
    start_frame = 1  # the start check: frames 0..1 from scratch

    @staticmethod
    def output(eng):
        """The frame's output: the warped surface (warped_cloud)."""
        return eng.warped_cloud()[0]

    @staticmethod
    def failed(eng, before) -> bool:
        return False

    @staticmethod
    def solve_stats(eng):
        """The frame's GN solve, on the card (printed after the window, not
        judged): the last PCG's iterations, the cost before and after."""
        st = eng.last_solve_stats
        return torch.stack([st.cg_iters.float(), st.initial_cost.float(),
                            st.final_cost.float()])

    @staticmethod
    def state(eng):
        """The state the next frame starts from: the warp field (the
        volume is cleared and integrated anew every frame)."""
        return {"wf": [host(t) for t in eng.warpfield], "k": eng.frame_counter}

    @staticmethod
    def start_outputs(eng) -> dict:
        c = eng.canonical
        n = int(c.mask.sum())
        return {"canonical": host(c.vertices[:n])}

    @staticmethod
    def outputs(eng, probe: Probe, offset: int) -> dict:
        args, _, (vals, exact) = probe.calls["corr"]
        live_m = args[4]
        wf = eng.warpfield
        cnt = int(wf.count)
        live = eng.live
        n_live = int(live.mask.sum())
        cw = eng.canonical_warped
        tsdf, weight = _voxels(eng.vol, offset)
        return {
            "dists": host(probe.calls["dists"][2]),
            "tsdf": tsdf, "weight": weight,
            "live": host(live.vertices[:n_live]),
            "warped": host(cw.vertices[cw.mask]),
            "corr": host(vals[:, :3]), "corr_ok": host(exact & live_m),
            "node_pos": host(wf.pos[:cnt]), "node_dqs": host(wf.dqs[:cnt]),
        }

    @staticmethod
    def set_state(ref, state, device, prev_depth):
        """The reference engine starts the frame from the program's warp
        field; its canonical is its own (from its frame 0)."""
        del prev_depth
        wfield = importlib.import_module("plainref.warp.field")
        ref.warpfield = wfield.WarpField(
            *[torch.as_tensor(a, device=device) for a in state["wf"]])
        ref.frame_counter = state["k"]


class KinFuAdapter:
    """Rigid KinFu."""

    kind = "kinfu"
    probes = {"dists": ("ops.imgproc", "compute_dists")}
    start_frame = 2  # frames 0..2 from scratch: two ICPs

    @staticmethod
    def output(eng):
        """The frame's output: the camera pose (host), with the frame's
        integrate and raycast finished (the next frame's reference)."""
        return eng.poses[-1]

    @staticmethod
    def failed(eng, before) -> bool:
        return eng.resets != before

    @staticmethod
    def solve_stats(eng):
        return None

    @staticmethod
    def state(eng):
        """The previous frame's pose: with its depth it gives the
        reference the pyramid the frame tracks against (the volume is
        cleared and integrated anew every frame)."""
        R, t = eng.poses[-1]
        return {"R": np.array(R), "t": np.array(t), "k": eng.frame_counter}

    @staticmethod
    def start_outputs(eng) -> dict:
        return {}

    @staticmethod
    def outputs(eng, probe: Probe, offset: int) -> dict:
        R, t = eng.poses[-1]
        pts, nrm = eng.prev_pyr[0]
        tsdf, weight = _voxels(eng.vol, offset)
        return {"dists": host(probe.calls["dists"][2]),
                "tsdf": tsdf, "weight": weight,
                "R": np.array(R, np.float64), "t": np.array(t, np.float64),
                "points": host(pts), "normals": host(nrm)}

    @staticmethod
    def set_state(ref, state, device, prev_depth):
        """The reference engine's pyramid from the previous depth at the
        program's previous pose, worked out again (KinFu.__call__'s
        integrate, raycast and pyramid)."""
        icp = importlib.import_module("plainref.rigid.icp")
        pose = (state["R"], state["t"])
        ref.poses = [pose]
        dists, _ = ref._preprocess(ref._depth(prev_depth))
        ref.vol = ref._integrate(dists, pose, fresh=True)
        pts, nrm = ref._raycast(pose)
        ref.prev_pyr = icp.build_pyramids(pts, nrm, ref.levels)
        ref.frame_counter = state["k"]


ADAPTERS = {"dynfusion": DynFusionAdapter, "kinfu": KinFuAdapter}

