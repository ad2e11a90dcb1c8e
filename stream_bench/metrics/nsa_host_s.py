"""nsa_host_s (s), layer NSA: a job's seconds in the program's span
``nsa.host_tables`` (``ops.stream_sample_inputs``: B1's tables built on the
host, by the monolithic sweep and by ``ChunkedNSA`` once before its
chunks), from ``repro_torch.tracing``'s records after the window
(:func:`stream_bench.trace.program_seconds`); mean over the window's jobs.
Nothing where the program keeps no such records."""

from stream_bench import trace


def read(run):
    per = trace.program_seconds(run.device_trace, "nsa.host_tables")
    return sum(per) / len(per) if per else None
