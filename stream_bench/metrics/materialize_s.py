"""materialize_s (s), layer materialize and store: a job's seconds in
``DeviceSweepResult.materialize`` (the kept indices copied to the host,
the payload gathered, the sims written by ``StreamStore.put_many``), from
its synchronising span; mean over the window's jobs."""


def read(run):
    per = run.span_seconds("engine.materialize")
    return sum(per) / len(per) if per else None
