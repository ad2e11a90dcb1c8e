"""original_load_s (s), layer store: a job's seconds in
``Controller._prepare_all`` (the originals read back from the store),
from its synchronising span; mean over the window's jobs."""


def read(run):
    per = run.span_seconds("store.load_originals")
    return sum(per) / len(per) if per else None
