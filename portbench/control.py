"""The control of the check that decides `correct`: the reference with one
guarantee of the configuration broken (a node's offering admitted from the
raw catalog: capacity for allocatable, any architecture), put in the
program's place over a cell's window of requests and judged as the program
is. It has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --requests N

prints, for each seed, the control's wrong answers among the first N
requests of the cell's window. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from .generator import Traffic, load_json
from .reference.answer import Reference
from .run import cell_spec


def control_wrong(config: dict, traffic: dict, seed: int,
                  requests: int) -> int:
    gen = Traffic(config, traffic, seed)
    ref = Reference(config)
    wrong = 0
    for i in range(requests):
        rec = gen.request(i)
        if ref.answer(rec, control=True) != ref.answer(rec):
            wrong += 1
    return wrong


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, required=True)
    args = p.parse_args(argv)
    _cell, config, traffic = cell_spec(load_json("BENCHMARK.json"),
                                       args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        n = control_wrong(config, traffic, seed, args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "requests": args.requests,
                          "control_wrong_answers": n, "limit": 0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
