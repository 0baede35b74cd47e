"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time a call's work can take on it."""

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_F32 = 67e12  # float32 outside the tensor cores, operations/s


def bound_s(nbytes: float, flops: float) -> float:
    """The larger of bytes / peak bandwidth and float32 operations / peak
    rate (s)."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)


def roofline_pct(run, group: str, cost) -> float | None:
    """Bound time over device time, in %, summed over the group's calls in
    the profiled frames; cost(args, kwargs) -> (bytes, operations). None
    where the group had no call or no device time."""
    calls = run.span_args(group)
    dev = run.span_device_s(group)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(bound_s(*cost(a, kw)) for a, kw in calls) / dev
