"""chunk_event_wait_s (s), layer device: a job's seconds in the program's
span ``chunk.event_wait`` (``ChunkedSweepRunner``: a host leg waiting on
its chunk's copy event, that is on the device's B1, B2, B6 and copies of
that chunk), from ``repro_torch.tracing``'s records after the window
(:func:`stream_bench.trace.program_seconds`); mean over the window's jobs.
Nothing where no job ran the chunked runner."""

from stream_bench import trace


def read(run):
    per = trace.program_seconds(run.device_trace, "chunk.event_wait")
    return sum(per) / len(per) if per else None
