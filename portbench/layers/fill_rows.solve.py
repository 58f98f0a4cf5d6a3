"""ops.open_claim's claim rows: the claims open when each pack step's fill
ran, summed over a Solve's steps (the solver's `fill_rows`, counted on the
host from the decoded buffer), a request's mean. Silent where the program
does not count it."""


def read(run):
    if any("fill_rows" not in r["counters"] for r in run.answered()):
        return None
    return run.mean_counter("solve", lambda r: r["counters"]["fill_rows"])
