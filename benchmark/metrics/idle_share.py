"""device: the share of the profiled frames' wall time in which the card
ran no operation (kernel, copy or fill), from the union of the device
operations' intervals in the torch.profiler trace: overlapping operations
count once."""


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
