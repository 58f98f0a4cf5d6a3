"""models.encode's per-group loop of a Solve (the group cache, the
feasibility folds, the existing-node fit): its solver.encode.fold span, ms
a request's mean."""

from portbench.spans import span_ms


def read(run):
    return span_ms(run, "solver.encode.fold")
