"""Share of the profiled solve's wall in which no operation (kernel,
copy, set) ran on the device: 100 minus the union of the device's
intervals over the wall."""

UNIT = "%"


def read(trace):
    p = trace.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s) if p.window_s > 0 else None
