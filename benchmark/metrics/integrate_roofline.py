"""kernels: the TSDF integrate's share of its roofline, over every call of
volume/tsdf.integrate and integrate_rotated in the profiled frames (one
span a call, whatever the integrate launches inside it).

Bytes: the depth image read once (float32) and the volume written once
(float16 tsdf, uint8 weight), plus the volume read once where the call
averages into it (fresh=False). Operations: 20 float32 operations a voxel
(the camera-space point, its projection, |vc|, the sdf and its
truncation); the bytes bound it by far."""

from dfbench.peaks import roofline_pct

SPANS = {"integrate": ["dynfu_tpu_torch.volume.tsdf:integrate",
                       "dynfu_tpu_torch.volume.tsdf:integrate_rotated"]}
OPS_PER_VOXEL = 20


def cost(args, kw):
    vol, dists = args[0], args[1]
    fresh = kw.get("fresh", args[5] if len(args) > 5 else False)
    voxels = vol.tsdf.numel()
    nbytes = dists.numel() * 4 + voxels * 3 * (1 if fresh else 2)
    return nbytes, voxels * OPS_PER_VOXEL


def read(run):
    return roofline_pct(run, "integrate", cost)
