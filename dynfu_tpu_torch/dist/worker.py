"""Sharded runs driven through files, for callers in another process.

`run_jobs(jobs, out_dir)` runs on every rank (start it with
runtime.spawn(run_jobs, n, jobs, out_dir, device=...)); each job is a
(name, kwargs) pair and writes what it computed to
<out_dir>/<name>_r<rank>.npz, on every rank. The tests drive the port this
way beside the JAX package, which the ranks never import.

Jobs:
* "ops": the sharded kernels' functions on given inputs: the warp
  (warp_points_normals_sharded), the 1-NN (nn1_xwindow_sharded), the Gram
  (data_normal_sharded), the monomial Grams (monomial_grams_sharded);
* "frame": one sharded_engine_frame from a given engine state (parity,
  or the non-strict frame with strict_parity=False);
* "drive": a ShardedDynFusion over given depth frames;
* "fusion_frame": one sharded_fusion_frame from a given fusion engine
  state;
* "fusion_drive": a fusion-mode ShardedDynFusion over given depth frames,
  optionally saved to a checkpoint after a frame and resumed from it by a
  new driver;
* "step": spmd.sharded_fusion_step over given depth frames from a given
  volume and warp field.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dynfu_tpu_torch.dist import (engine_spmd, shard_corr, shard_gram,
                                  shard_warp, spmd)
from dynfu_tpu_torch.dist.driver import ShardedDynFusion
from dynfu_tpu_torch.warp.field import WarpField


def _np(t):
    return t.detach().cpu().numpy()


def _t(a, dev):
    return torch.as_tensor(np.array(a), device=dev)


def ops(mesh, *, warp=None, corr=None, gram=None, mono=None):
    """warp = (points, normals, (pos, dqs, w, mask, count)); corr =
    (queries, points, point_mask, query_mask, kwargs (values, tiers)); gram
    = (data_idx, data_w, s2, delta, D); mono = (data_idx, data_w, s2, y,
    delta, D)."""
    dev, out = mesh.device, {}
    if warp is not None:
        pts, nrm, wf = warp
        wf = WarpField(*(_t(a, dev) for a in wf))
        wp, wn = shard_warp.warp_points_normals_sharded(
            mesh, wf, _t(pts, dev), _t(nrm, dev))
        out.update(warp_points=_np(wp), warp_normals=_np(wn))
    if corr is not None:
        *arrays, kw = corr
        kw = {k: _t(v, dev) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        vals, exact = shard_corr.nn1_xwindow_sharded(
            mesh, *(_t(a, dev) for a in arrays), **kw)
        out.update(corr_vals=_np(vals), corr_exact=_np(exact))
    if gram is not None:
        *arrays, D = gram
        A, b = shard_gram.data_normal_sharded(
            mesh, *(_t(a, dev) for a in arrays), D)
        out.update(gram_A=_np(A), gram_b=_np(b))
    if mono is not None:
        *arrays, D = mono
        B, Bu, Bw = shard_gram.monomial_grams_sharded(
            mesh, *(_t(a, dev) for a in arrays), D)
        out.update(mono_B=_np(B), mono_Bu=_np(Bu), mono_Bw=_np(Bw))
    return out


def frame(mesh, *, params, state, depth, strict_parity=True,
          integrate_mode="separable"):
    """One sharded engine frame from a JAX engine's state after frame 0
    (utils/convert.load_engine_state's keywords); the outputs gathered."""
    from dynfu_tpu_torch.engine.dynfusion import DynFusion
    from dynfu_tpu_torch.utils import convert

    e = convert.load_engine_state(DynFusion(params, device=mesh.device),
                                  **state)
    c = e.canonical
    step = engine_spmd.sharded_engine_frame(
        mesh, e.dynfu_params, e.params.intr, e.tsdf_config,
        strict_parity=strict_parity, integrate_mode=integrate_mode)
    args = engine_spmd.place_engine_state(mesh, e.vol, e.warpfield,
                                          c.vertices, c.normals, c.mask,
                                          depth, e.poses[-1])
    (vol, wf, wv, wn, live_v, live_n, live_m, soup, n, stats) = step(
        *args, e.canonical_mult)
    full = spmd.gather_volume(vol, mesh, e.tsdf_config.dims[0])
    rows = spmd.all_gather_rows(soup[:int(n)], mesh)
    N = c.vertices.shape[0]
    return dict(tsdf=_np(full.tsdf), weight=_np(full.weight),
                wv=_np(spmd.all_gather_rows(wv, mesh, N)),
                wn=_np(spmd.all_gather_rows(wn, mesh, N)),
                soup=_np(rows), n_verts=rows.shape[0],
                live=_np(spmd.all_gather_rows(live_v[live_m], mesh)),
                live_n=_np(spmd.all_gather_rows(live_n[live_m], mesh)),
                **_wf_stats(wf, stats))


def _wf_stats(wf, stats):
    return dict(pos=_np(wf.pos), dqs=_np(wf.dqs), w=_np(wf.w),
                mask=_np(wf.mask), count=int(wf.count),
                mc_dropped=int(stats.mc_dropped),
                corr_dropped=int(stats.corr_dropped))


def drive(mesh, *, params, frames):
    """ShardedDynFusion over `frames`: per frame k >= 1 the warped cloud
    (soup order) and its mask, the live set and its mask, this rank's live
    count, the soup and its count, the counters; the final node state."""
    drv = ShardedDynFusion(params, mesh=mesh)
    out = {}
    for k, d in enumerate(frames):
        drv(d)
        if k == 0:
            continue
        wv, wm = drv.warped_cloud()
        lv, lm = drv.live_cloud()
        sv, sn = drv.mesh()
        fs = drv.last_frame_stats
        out.update({f"warped{k}": _np(wv), f"warped_mask{k}": _np(wm),
                    f"live{k}": _np(lv), f"live_mask{k}": _np(lm),
                    f"n_local{k}": int(drv.engine.live.mask.sum()),
                    f"soup{k}": _np(sv), f"soup_n{k}": int(sn),
                    f"mc_dropped{k}": int(fs.mc_dropped),
                    f"corr_dropped{k}": int(fs.corr_dropped)})
    out.update(_wf_stats(drv.engine.warpfield, drv.last_frame_stats))
    return out


def fusion_frame(mesh, *, params, state, depth):
    """One sharded fusion frame from a JAX fusion engine's state after
    frame 0; the outputs (replicated but the volume, which is gathered)."""
    from dynfu_tpu_torch.engine.dynfusion import DynFusion
    from dynfu_tpu_torch.utils import convert

    e = convert.load_engine_state(
        DynFusion(params, device=mesh.device, mode="fusion"), **state)
    c = e.canonical
    step = engine_spmd.sharded_fusion_frame(mesh, e.dynfu_params,
                                            e.params.intr, e.tsdf_config)
    args = engine_spmd.place_engine_state(mesh, e.vol, e.warpfield,
                                          c.vertices, c.normals, c.mask,
                                          depth, e.poses[-1])
    vol, wf, v, n, m, n_verts, wv2, _, stats = step(*args)
    full = spmd.gather_volume(vol, mesh, e.tsdf_config.dims[0])
    return dict(tsdf=_np(full.tsdf), weight=_np(full.weight), verts=_np(v),
                normals=_np(n), vmask=_np(m), n_verts=int(n_verts),
                wv2=_np(wv2), **_band(stats), **_wf_stats(wf, stats))


def _band(stats):
    return {k: int(v) for k, v in stats.band._asdict().items()}


def fusion_drive(mesh, *, params, frames, resume_after=None, ckpt=None):
    """A fusion-mode ShardedDynFusion over `frames`: per frame k >= 1 the
    canonical (vertices, normals, mask), the warped cloud and its mask, the
    band counters and the drop counts; the final node state. With
    `resume_after` = k, the engine is saved to `ckpt` after frame k and a
    new ShardedDynFusion, restored from it, runs the rest."""
    from dynfu_tpu_torch.utils.checkpoint import load_checkpoint, \
        save_checkpoint

    drv = ShardedDynFusion(params, mode="fusion", mesh=mesh)
    out = {}
    for k, d in enumerate(frames):
        drv(d)
        if k == resume_after:
            save_checkpoint(drv, ckpt)
            if mesh.backend is not None:  # rank 0 has written it
                dist.barrier()
            drv = load_checkpoint(
                ShardedDynFusion(params, mode="fusion", mesh=mesh), ckpt)
        if k == 0 or k == resume_after:  # the restored driver: no stats
            continue
        c = drv.canonical
        wv, wm = drv.warped_cloud()
        fs = drv.last_frame_stats
        out.update({f"canonical{k}": _np(c.vertices),
                    f"normals{k}": _np(c.normals), f"mask{k}": _np(c.mask),
                    f"warped{k}": _np(wv), f"warped_mask{k}": _np(wm),
                    f"mc_dropped{k}": int(fs.mc_dropped),
                    f"corr_dropped{k}": int(fs.corr_dropped),
                    **{f"{n}{k}": v for n, v in _band(fs).items()}})
    out.update(_wf_stats(drv.engine.warpfield, drv.last_frame_stats))
    return out


def step(mesh, *, config, intr, shape, vol, wf, frames, camera_pose,
         solver_kwargs=None):
    """spmd.sharded_fusion_step over `frames` (depth in mm), from the whole
    volume `vol` and the warp field `wf` (numpy tuples of their fields):
    per frame k the whole raycast (points{k}, normals{k}), the count of
    hits across a block face (straddle{k}), this rank's warped rows
    (warped{k}), its valid rows (rows{k}) and the SolveStats; the last
    frame's whole volume and the final node state."""
    from dynfu_tpu_torch.volume import tsdf as tv

    dev = mesh.device
    fn = spmd.sharded_fusion_step(mesh, config, intr, shape, solver_kwargs)
    v = spmd.shard_volume(tv.TsdfVolume(*(_t(a, dev) for a in vol)), mesh)
    w = WarpField(*(_t(a, dev) for a in wf))
    pose = tuple(_t(a, dev) for a in camera_pose)
    out = {}
    for k, d in enumerate(frames):
        v, w, warped, stats = fn(v, _t(d, dev), w, pose)
        pts, nrm, n_straddle = fn.last_raycast
        out.update({f"points{k}": _np(pts), f"normals{k}": _np(nrm),
                    f"straddle{k}": int(n_straddle), f"warped{k}": _np(warped),
                    f"rows{k}": int((~torch.isnan(warped[:, 0])).sum()),
                    **{f"{n}{k}": float(x) for n, x in
                       stats._asdict().items()}})
    full = spmd.gather_volume(v, mesh, config.dims[0])
    out.update(tsdf=_np(full.tsdf), weight=_np(full.weight), pos=_np(w.pos),
               dqs=_np(w.dqs), w=_np(w.w), mask=_np(w.mask),
               count=int(w.count))
    return out


JOBS = {"ops": ops, "frame": frame, "drive": drive,
        "fusion_frame": fusion_frame, "fusion_drive": fusion_drive,
        "step": step}


def run_jobs(jobs, out_dir: str, device="cuda") -> None:
    """Run (name, kwargs) jobs on this rank; write each one's outputs to
    <out_dir>/<name>_r<rank>.npz. The jobs' name is `name` up to a "/"
    (so that a job can run twice: "drive/caps")."""
    torch.set_num_threads(1)
    mesh = spmd.make_mesh(device=device)
    for name, kw in jobs:
        out = JOBS[name.split("/")[0]](mesh, **kw)
        np.savez(os.path.join(out_dir, f"{name.replace('/', '_')}_r"
                              f"{mesh.rank}.npz"), **out)
