"""stages: host wall time a frame inside the rigid frame's ICP
(KinFu._track: the stencil ICP and its gather rescue), from the
benchmark's span around the method."""

SPANS = {"icp": ["dynfu_tpu_torch.engine.kinfu:KinFu._track"]}


def read(run):
    return run.span_host_ms("icp")
