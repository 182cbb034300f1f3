"""Device microseconds per execution of the step's Pade exponential
(ops/expm.py ``expm_pade``; kernels whose name holds ``expm_pade``) in
the profiled solve."""

UNIT = "us"


def read(trace):
    n = secs = 0
    for name, (count, s) in trace.profile.device_ops.items():
        if "expm_pade" in name:
            n, secs = n + count, secs + s
    return 1e6 * secs / n if n else None
