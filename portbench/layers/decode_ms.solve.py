"""solver.core's decode after the one read-back: decode_ms, a request's
mean."""


def read(run):
    return run.mean_counter("solve", lambda r: r["counters"]["decode_ms"])
