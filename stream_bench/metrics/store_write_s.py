"""store_write_s (s), layer materialize and store: a job's seconds in the
program's span ``store.write`` (``StreamStore``'s ``np.savez`` of a sim's
columns, or of one chunk's, and its rename into place; where the job runs
POSD itself, the original's write as well), from
``repro_torch.tracing``'s records after the window
(:func:`stream_bench.trace.program_seconds`); mean over the window's jobs.
Nothing where the program keeps no such records."""

from stream_bench import trace


def read(run):
    per = trace.program_seconds(run.device_trace, "store.write")
    return sum(per) / len(per) if per else None
