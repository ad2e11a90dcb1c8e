"""report_s (s), layer report: a job's seconds in the program's ``report.*``
spans (``report.stats``: the statistics, B3 over the originals and the
trend correlations; ``report.build``: each ``SimulationReport``), the union
of their intervals on the thread of the job's entry call, from
``repro_torch.tracing``'s records after the window. A record is job k's
when it starts inside the k-th ``bench.entry`` range of the device trace,
which is on the records' clock; mean over the window's jobs. Nothing where
the program keeps no such records."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    entries = sorted((a, b) for n, a, b in getattr(
        run.device_trace, "ranges", ()) if n == "bench.entry")
    recs = [r for r in tracing.records()
            if r.name == "call" or r.name.startswith("report.")]
    if not entries or not any(r.name != "call" for r in recs):
        return None
    jobs = [[] for _ in entries]
    for r in recs:
        at = r.start_ns * 1e-3
        for k, (a, b) in enumerate(entries):
            if a <= at < b:
                jobs[k].append(r)
                break
    per = []
    for recs in jobs:
        threads = {r.thread for r in recs if r.name == "call"}
        spans = sorted((r.start_ns, r.end_ns) for r in recs
                       if r.name != "call" and r.thread in threads)
        total, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        per.append(total * 1e-9)
    return sum(per) / len(per)
