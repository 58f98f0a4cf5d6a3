"""ops.open_claim's placements: pods a Solve put onto a claim that an
earlier pack step opened (the solver's `fill_pods`, counted on the host
from the decoded buffer), a request's mean. Silent where the program does
not count it."""


def read(run):
    if any("fill_pods" not in r["counters"] for r in run.answered()):
        return None
    return run.mean_counter("solve", lambda r: r["counters"]["fill_pods"])
