"""chunk_host_leg_s (s), layer materialize and store: a job's seconds in
the program's span ``chunk.host_leg`` (``ChunkedSweepRunner``: chunk k's
host side while chunk k+1 is on the device: the wait for its staged
copies, the payload's gather, the chunk files' writes, the hand-off to
the replay's feed, which blocks while the feed is full), from
``repro_torch.tracing``'s records after the window
(:func:`stream_bench.trace.program_seconds`); mean over the window's jobs.
Nothing where no job ran the chunked runner."""

from stream_bench import trace


def read(run):
    per = trace.program_seconds(run.device_trace, "chunk.host_leg")
    return sum(per) / len(per) if per else None
