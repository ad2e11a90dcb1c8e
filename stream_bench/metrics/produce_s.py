"""produce_s (s), layer replay: ``SimulationReport.produce_s``, the
program's host clock around the replay into the consumer; one value a
call into the entry, summed over a job's calls, mean over the window's
jobs."""


def read(run):
    per = [j.per_call("produce_s") for j in run.jobs if j.calls]
    return sum(per) / len(per) if per else None
