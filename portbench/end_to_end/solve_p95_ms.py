"""95th percentile of the caller's wall of every Solve the window issued."""

from portbench.stats import percentile


def read(run):
    if run.kind != "solve" or not run.requests:
        return None
    return percentile([r["wall_s"] * 1000 for r in run.requests], 95)
