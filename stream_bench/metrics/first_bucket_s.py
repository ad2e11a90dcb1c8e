"""first_bucket_s (s): mean over the window's jobs of the time from the
call into the entry to the consumer's first bucket, on the host clock."""


def read(run):
    waits = [j.t_first - j.t_call for j in run.jobs if j.t_first is not None]
    return sum(waits) / len(waits) if waits else None
