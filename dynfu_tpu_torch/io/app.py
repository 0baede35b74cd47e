"""The dataset application — the `dynfu-torch run` loop.

Port of dynfu_tpu/io/app.py, the analog of DynFuApp (src/apps/demo.cpp):
loads sorted depth PNGs (with the colour frames, which the engines accept
and ignore, as the reference's math does), drives the DynFusion engine
frame by frame under the fps sampler, and writes per-frame artifacts into
<dataset>/out (or `out_dir`):
  * pcl_canonical_to_live<i>.pcd — warped canonical cloud (demo.cpp:21-31)
  * <i>_tsdf_mesh.vtk / .ply     — live TSDF mesh (demo.cpp:33-37)
  * render<i>.png                — offline Phong render with export_viz
    (replaces the reference's interactive OpenCV Viz window, demo.cpp:179-185)
  * checkpoint.npz               — every `checkpoint_every` frames; `resume`
    continues from one.
The engine runs on `device` ("cuda" by default; the CPU only when asked
for).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from dynfu_tpu_torch.engine.dynfusion import DynFusion
from dynfu_tpu_torch.engine.params import DynFuParams
from dynfu_tpu_torch.io import meshio
from dynfu_tpu_torch.io.native_loader import DepthLoader
from dynfu_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dynfu_tpu_torch.utils.timers import SampledScopeTime, sync


def _frames(dataset: str, max_frames: int):
    depths, colors = meshio.list_dataset(dataset)
    if max_frames:
        depths, colors = depths[:max_frames], colors[:max_frames]
    return depths, colors


def dataset_params(shape, volume_dims: int) -> DynFuParams:
    """run_dataset's default parameters for (rows, cols) depth frames: the
    defaults with the frame size and a cubic volume. Like the source's app,
    it applies no DynFuParams.caps_for_volume preset."""
    params = DynFuParams.default_params()
    kf = dataclasses.replace(params.kinfu, rows=shape[0], cols=shape[1],
                             volume_dims=(volume_dims,) * 3)
    return dataclasses.replace(params, kinfu=kf)


def run_dataset(
    dataset: str,
    out_dir: Optional[str] = None,
    max_frames: int = 0,
    volume_dims: int = 128,
    export_viz: bool = False,
    params: Optional[DynFuParams] = None,
    save_every: int = 1,
    checkpoint_every: int = 0,
    resume: Optional[str] = None,
    rigid: bool = False,
    mode: Optional[str] = None,
    devices: int = 0,
    fg_aabb=None,
    max_fg_verts: int = 0,
    device="cuda",
) -> int:
    if devices and devices > 1:
        raise NotImplementedError(
            "devices > 1: the port runs on one card; the sharded engine is "
            "ROADMAP §1 item 2 (multi-GPU)")
    if rigid:
        return run_dataset_rigid(dataset, out_dir=out_dir,
                                 max_frames=max_frames,
                                 volume_dims=volume_dims,
                                 export_viz=export_viz,
                                 save_every=save_every, device=device)
    depths, colors = _frames(dataset, max_frames)
    if not depths:
        print(f"no depth frames found under {dataset}/depth")
        return 1

    out_dir = out_dir or os.path.join(dataset, "out")
    os.makedirs(out_dir, exist_ok=True)

    if params is None:
        params = dataset_params(meshio.load_depth_png(depths[0]).shape,
                                volume_dims)
    if fg_aabb is not None:
        params = dataclasses.replace(params, fg_aabb=fg_aabb,
                                     max_fg_verts=max_fg_verts)

    engine = DynFusion(params, device=device, mode=mode or "parity")
    start = 0
    if resume:
        load_checkpoint(engine, resume)
        start = engine.frame_counter
        print(f"resumed from {resume} at frame {start}")
    sampler = SampledScopeTime()
    # native threaded decode, from the first frame to run: the prefetch
    # ring fills in order, so the source's loader over every frame, asked
    # first for frame `start` >= its queue depth, waits until its timeout
    with DepthLoader(depths[start:]) as loader:
        for i in range(start, len(depths)):
            depth = loader[i - start]
            image = (meshio.load_color_png(colors[i])
                     if i < len(colors) else None)
            with sampler:
                has_surface = engine(depth, image)
                wv, wm = engine.warped_cloud()
                sync(wv)
            print(f"frame {i}: {'ok' if has_surface else 'bootstrap'}")

            if i % save_every == 0:
                cloud = wv[wm].cpu().numpy()
                meshio.save_pcd(
                    os.path.join(out_dir, f"pcl_canonical_to_live{i}.pcd"),
                    cloud)
                verts, n = engine.mesh()
                soup = verts[:int(n)].cpu().numpy()
                meshio.save_vtk(os.path.join(out_dir, f"{i}_tsdf_mesh.vtk"),
                                soup)
                meshio.save_ply(os.path.join(out_dir, f"{i}_tsdf_mesh.ply"),
                                soup)
                if export_viz:
                    meshio.save_image_png(
                        os.path.join(out_dir, f"render{i}.png"),
                        engine.render(0).cpu().numpy())
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                save_checkpoint(engine,
                                os.path.join(out_dir, "checkpoint.npz"))
    return 0


def run_dataset_rigid(
    dataset: str,
    out_dir: Optional[str] = None,
    max_frames: int = 0,
    volume_dims: int = 512,
    export_viz: bool = False,
    save_every: int = 5,
    device="cuda",
) -> int:
    """Rigid KinectFusion over a dataset (the kfusion workload): tracks the
    camera, fuses the volume, exports the mesh and the trajectory (one row
    per frame: R row-major (9), t (3))."""
    from dynfu_tpu_torch.engine.kinfu import KinFu
    from dynfu_tpu_torch.engine.params import KinFuParams

    depths, _ = _frames(dataset, max_frames)
    if not depths:
        print(f"no depth frames found under {dataset}/depth")
        return 1
    out_dir = out_dir or os.path.join(dataset, "out")
    os.makedirs(out_dir, exist_ok=True)

    h, w = meshio.load_depth_png(depths[0]).shape
    params = dataclasses.replace(KinFuParams.default_params(), rows=h,
                                 cols=w, volume_dims=(volume_dims,) * 3)
    engine = KinFu(params, device=device)
    sampler = SampledScopeTime()
    poses = []
    with DepthLoader(depths) as loader:
        for i in range(len(loader)):
            with sampler:
                ok = engine(loader[i])
                sync(engine.vol.tsdf)
            R, t = engine.get_camera_pose()
            poses.append(np.concatenate([np.asarray(R).ravel(),
                                         np.asarray(t)]))
            print(f"frame {i}: {'tracked' if ok else 'bootstrap'}")
            if (export_viz and engine.prev_pyr is not None
                    and i % save_every == 0):
                meshio.save_image_png(
                    os.path.join(out_dir, f"rigid_render{i}.png"),
                    engine.render(0).cpu().numpy())
    np.savetxt(os.path.join(out_dir, "trajectory.txt"), np.stack(poses))
    # the port's get_mesh returns the world-frame soup; the source's indexes it
    soup, _ = engine.get_mesh()
    verts, faces = meshio._soup_to_indexed(soup.cpu().numpy())
    meshio.save_ply_indexed(os.path.join(out_dir, "rigid_mesh.ply"), verts,
                            faces)
    print(f"saved trajectory + mesh to {out_dir}")
    return 0

