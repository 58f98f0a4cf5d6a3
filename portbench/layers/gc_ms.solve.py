"""The interpreter's garbage collector inside a Solve (gc.callbacks around
each collection that starts during the call): ms a request's mean. The
host runtime's share of the wall that no layer's own counter holds."""


def read(run):
    return run.mean_counter("solve", lambda r: r["gc_s"] * 1000)
