"""job_s (s): the window's length over the jobs it completed, on the host
clock; stalls, store set-up and deletes included."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs else None
