"""feed_wait_s (s), layer replay: the seconds the chunked replay's
producer waited for the runner's next chunk (``ChunkFeed``'s
``feed_get_wait_s``, which each chunked report's ``consumer_metrics``
carries), summed over a job's reports; mean over the window's jobs. Near
the job's replay time the runner's host legs set the replay's pace, near
0 the replay does. Nothing where the program does not count it, or no
job ran the chunked runner."""


def read(run):
    per = []
    for j in run.jobs:
        waits = [r.consumer_metrics.get("feed_get_wait_s")
                 for r in j.reports]
        if waits and all(w is not None for w in waits):
            per.append(float(sum(waits)))
    return sum(per) / len(per) if per else None
