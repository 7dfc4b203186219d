"""The main thread's waits on the card a traced batch: the port's
``syncs`` counter at every site but the writer thread's, while the
profiler recorded, over the batches it recorded."""

from pbench import spans


def read(run):
    rec = spans.traced(run)
    if rec is None:
        return None
    c = rec.traced
    return sum(n for site, n in c["syncs"].items()
               if site not in spans.WRITER_SITES) / c["batches"]
