"""stages: host wall time a frame inside the rigid frame's raycast
(KinFu._raycast: the formulation the dispatch picks), from the
benchmark's span around the method."""

SPANS = {"raycast": ["dynfu_tpu_torch.engine.kinfu:KinFu._raycast"]}


def read(run):
    return run.span_host_ms("raycast")
