"""Device milliseconds of the profiled solve's copies between host and
card (operations whose name begins with ``Memcpy``: the box's final
gather of its probabilities and mask to the host among them)."""

UNIT = "ms"


def read(trace):
    secs = [s for name, (_, s) in trace.profile.device_ops.items()
            if name.startswith("Memcpy")]
    return 1e3 * sum(secs) if secs else None
