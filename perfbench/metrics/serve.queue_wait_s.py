"""``serve.queue_wait_s``: the mean of the scheduler's ``queue_wait`` hop
(submit to the dispatch that claims the request) over the window's
served fits."""


def read(ctx):
    waits = [f.hops["queue_wait"] for f in ctx.record.fits
             if f.hops and "queue_wait" in f.hops]
    return sum(waits) / len(waits) if waits else None
