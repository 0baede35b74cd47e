"""stages: host wall time a frame inside the GN solve (solver/gn.solve, as
engine/dynfusion._nonrigid_frame calls it), from the benchmark's span
around the module attribute."""

SPANS = {"solve": ["dynfu_tpu_torch.solver.gn:solve"]}


def read(run):
    return run.span_host_ms("solve")
