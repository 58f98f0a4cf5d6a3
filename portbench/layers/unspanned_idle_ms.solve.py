"""The device's idle time inside a Solve's window that no leaf span of its
record covers (the host's unnamed time: the service's core around the
solve, and the gaps between phases), ms a request's mean."""

from portbench.spans import unspanned_idle_ms


def read(run):
    return unspanned_idle_ms(run)
