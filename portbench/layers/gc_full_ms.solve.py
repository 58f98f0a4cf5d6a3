"""The interpreter's full (generation-2) collections inside a Solve: the
solver's gc_full_ms, ms a request's mean. Silent where the program does
not count it."""


def read(run):
    if any("gc_full_ms" not in r["counters"] for r in run.answered()):
        return None
    return run.mean_counter("solve", lambda r: r["counters"]["gc_full_ms"])
