"""posd_s (s), layer POSD: a job's seconds in the harness's span
``bench.posd`` (the program's ``preprocess`` of each raw stream: the time
column found and parsed, the zone unified, the order checked), where the
traffic runs POSD inside the job; mean over the window's jobs. The
original's write after it is the program's span ``store.write``, read by
``store_write_s``."""


def read(run):
    per = run.span_seconds("bench.posd")
    return sum(per) / len(per) if per else None
