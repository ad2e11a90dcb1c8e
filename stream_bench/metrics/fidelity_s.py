"""fidelity_s (s), layer fidelity: a job's seconds in
``DeviceSweepResult.fidelity`` (B4, B5 and the trend ops), from its
synchronising span; mean over the window's jobs."""


def read(run):
    per = run.span_seconds("engine.fidelity")
    return sum(per) / len(per) if per else None
