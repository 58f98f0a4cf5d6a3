"""Pods decided (placed or declared unschedulable) over the window's
seconds: the time the caller waited on the service."""


def read(run):
    if run.kind != "solve" or not run.requests:
        return None
    return sum(r["pods"] for r in run.answered()) / run.window_s
