"""nsa_host_s (s), layer NSA: a job's seconds in the program's span
``nsa.host_tables`` (``ops.stream_sample_inputs``: B1's tables built on the
host), from ``repro_torch.tracing``'s records after the window. A record is
job k's when it starts inside the k-th ``bench.entry`` range of the device
trace, which is on the records' clock; mean over the window's jobs.
Nothing where the program keeps no such records."""

NAME = "nsa.host_tables"


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    entries = sorted((a, b) for n, a, b in getattr(
        run.device_trace, "ranges", ()) if n == "bench.entry")
    recs = [r for r in tracing.records() if r.name == NAME]
    if not entries or not recs:
        return None
    per = [0.0] * len(entries)
    for r in recs:
        at = r.start_ns * 1e-3
        for k, (a, b) in enumerate(entries):
            if a <= at < b:
                per[k] += r.seconds
                break
    return sum(per) / len(per)
