"""ops.packer's packs served by the replay of a CUDA graph: the solver's
`graph_replays` summed over the window's answered Solves, over their packs
(`rounds`, one a round), %. Silent where the program does not count it."""


def read(run):
    rs = run.answered() if run.kind == "solve" else []
    if not rs or any("graph_replays" not in r["counters"] for r in rs):
        return None
    packs = sum(r["counters"]["rounds"] for r in rs)
    return 100.0 * sum(r["counters"]["graph_replays"] for r in rs) / packs
