"""chunk_dispatch_s (s), layer NSA: a job's seconds in the program's span
``chunk.dispatch`` (``ChunkedSweepRunner``: chunk k's B1, B2 and B6 and
its copies to pinned host memory queued on the device, waiting for
nothing), from ``repro_torch.tracing``'s records after the window
(:func:`stream_bench.trace.program_seconds`); mean over the window's jobs.
Nothing where no job ran the chunked runner."""

from stream_bench import trace


def read(run):
    per = trace.program_seconds(run.device_trace, "chunk.dispatch")
    return sum(per) / len(per) if per else None
