"""feed_block_s (s), layer materialize and store: the seconds the chunked
runner's host legs were blocked on a full replay feed (``ChunkFeed``'s
``feed_put_wait_s``, which each chunked report's ``consumer_metrics``
carries), summed over a job's reports; mean over the window's jobs. Above
0 the replay sets the runner's pace. Nothing where the program does not
count it, or no job ran the chunked runner."""


def read(run):
    per = []
    for j in run.jobs:
        waits = [r.consumer_metrics.get("feed_put_wait_s")
                 for r in j.reports]
        if waits and all(w is not None for w in waits):
            per.append(float(sum(waits)))
    return sum(per) / len(per) if per else None
