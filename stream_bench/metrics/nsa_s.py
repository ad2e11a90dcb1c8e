"""nsa_s (s), layer NSA: ``SimulationReport.nsa_s``, the program's host
clock around B1, B2 and B3, which ends in the moments' copy to the host;
one value a call into the entry (a sweep reports its shared total), summed
over a job's calls, mean over the window's jobs."""


def read(run):
    per = [j.per_call("nsa_s") for j in run.jobs if j.calls]
    return sum(per) / len(per) if per else None
