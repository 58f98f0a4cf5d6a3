"""models.encode on the host: a Solve's encode_ms, a request's mean."""


def read(run):
    return run.mean_counter("solve", lambda r: r["counters"]["encode_ms"])
