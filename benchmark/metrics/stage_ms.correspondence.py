"""stages: host wall time a frame inside the 1-NN correspondence
(ops/knn.nn1_gather_xwindow, as engine/dynfusion._correspondence calls
it), from the benchmark's span around the module attribute."""

SPANS = {"correspondence": ["dynfu_tpu_torch.ops.knn:nn1_gather_xwindow"]}


def read(run):
    return run.span_host_ms("correspondence")
