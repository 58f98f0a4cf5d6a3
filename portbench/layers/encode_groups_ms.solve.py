"""models.encode's grouping of a Solve's pods (prepare_groups: a group key
a pod, canonical requirements, the zone split, the FFD order): its
solver.encode.groups span, ms a request's mean."""

from portbench.spans import span_ms


def read(run):
    return span_ms(run, "solver.encode.groups")
