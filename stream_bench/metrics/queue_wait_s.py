"""queue_wait_s (s), layer replay: the seconds the replay's producer waited
for room in the consumers' queues (``StreamQueue``'s ``put_wait_s``, which
each report's ``consumer_metrics`` carries), summed over a job's reports;
mean over the window's jobs. Near ``produce_s`` the consumer sets the
replay's pace, near 0 the producer does. Nothing where the program does
not count it."""


def read(run):
    per = []
    for j in run.jobs:
        waits = [r.consumer_metrics.get("put_wait_s") for r in j.reports]
        if waits and all(w is not None for w in waits):
            per.append(float(sum(waits)))
    return sum(per) / len(per) if per else None
