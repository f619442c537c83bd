"""``serve.rows_per_dispatch``: the live rows a dispatch in the window,
from the scheduler's counters (rows less padded rows, over dispatches)."""


def read(ctx):
    c = ctx.record.counters
    if not c.get("dispatches"):
        return None
    return (c["rows_total"] - c["rows_padded"]) / c["dispatches"]
