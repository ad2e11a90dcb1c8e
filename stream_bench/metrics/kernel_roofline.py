"""kernel_roofline (%), layer kernels: the least time of the kernel work
the window's jobs need at the H100's peaks (``stream_bench/roofline.py``,
B1-B5 from the jobs' shapes) over the time every kernel took in the trace,
whatever its name or number of launches; copies are not counted."""

from stream_bench import roofline


def read(run):
    if run.device_trace is None:
        return None
    bound, secs = roofline.share(run.launches, len(run.jobs),
                                 run.device_trace)
    return 100.0 * bound / secs if secs > 0 else None
