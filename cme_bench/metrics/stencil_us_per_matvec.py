"""Device microseconds per execution of the stencil SpMV kernel
(ops/stencil_cuda.py ``box_stencil`` and ``direct_stencil``: kernels
whose name holds ``sep_stencil_kernel``, CUDA-graph replays included) in
the profiled solve."""

UNIT = "us"


def read(trace):
    n = secs = 0
    for name, (count, s) in trace.profile.device_ops.items():
        if "sep_stencil_kernel" in name:
            n, secs = n + count, secs + s
    return 1e6 * secs / n if n else None
