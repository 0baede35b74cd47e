"""engine frame loop: device kernels per frame, counted in the profiled
frames' trace."""


def read(run):
    return run.launches / run.frames if run.frames else None
