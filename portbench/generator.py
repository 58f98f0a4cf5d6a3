"""The one traffic generator: a configuration file and a traffic file in,
seeded request records out.

A record is plain data that both the program's adapter (drive.py) and the
reference read. Request `i` of seed `s` is the same wherever it is made, so
the window's requests are made one at a time and made again, after the
window, for the reference.

A traffic file (portbench/traffic/<mix>.json) holds

* "request": "solve", the one kind of request the harness sends: a batch of
  pending pods of the configuration's deployments;
* "pods": the batch sizes, {"fixed": N} (every batch N pods) or
  {"sizes": [n1, n2, ...]} (any law, as its K sizes);
* "block": K, the number of shapes; "pool_seed": the seed of their splits;
* optionally "require_rung": the rung a request must be served on, or it
  counts as failed.

The K shapes (a size and its split over the mix, a multinomial draw over
the deployments' shares) are the same for every seed, drawn from the file's
`pool_seed`; each block of K requests takes every shape once, in the seed's
order, so every seed offers the same work and the warm-up can run every
shape the window will send. A request's pod order and names are the
seed's.

A configuration's "mix" lists its deployments, each an entry with

* "name", and "share": its part of a batch's pods;
* "cpu" and "memory": a pod's requests, as Kubernetes quantities ("100m",
  "64Mi"); memory may be null;
* "zone": a zone pin (a nodeSelector on the zone label), or null;
* "zone_spread": a zone topology spread (maxSkew 1, DoNotSchedule) over the
  deployment's own pods, or false;
* optionally "labels": the pod template's metadata.labels, such as
  {"app": "frontend"}.

The program groups a batch's pods on their template (requests, zone pin,
spread, labels), where the reference takes each entry as a Deployment of
its own; `check_mix` refuses a mix on which the two would differ.
"""

from __future__ import annotations

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def cpu_millis(q: str) -> int:
    return int(q[:-1]) if q.endswith("m") else int(float(q) * 1000)


def mem_mib(q: "str | None") -> int:
    """A memory request in MiB, rounded up; none is 0."""
    if not q:
        return 0
    for suffix, scale in (("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
        if q.endswith(suffix):
            return -(-int(q[:-2]) * scale // 2**20)
    return -(-int(q) // 2**20)


def check_mix(config: dict) -> None:
    """Refuse a mix that the program and the reference would group apart.

    Entries with one pod template (cpu, memory, zone, zone_spread, labels)
    are one pod group in the program and separate Deployments in the
    reference. That decides alike unless the entries carry a zone spread
    (the program water-fills their union over the zones, the reference each
    entry on its own), or another entry requests the same cpu and memory
    under another template (first-fit-decreasing's name order would then
    put it between them in the reference alone). Labels that differ, as a
    Deployment's `app: <name>` does, keep entries apart in both."""
    templates: "dict[tuple, list[str]]" = {}
    for d in config["mix"]:
        labels = d.get("labels", {})
        if not isinstance(labels, dict) or not all(
                isinstance(v, str) for kv in labels.items() for v in kv):
            raise ValueError(f"mix entry {d['name']!r}: labels must map "
                             f"strings to strings, not {labels!r}")
        key = (cpu_millis(d["cpu"]), mem_mib(d["memory"]), d["zone"],
               bool(d["zone_spread"]), tuple(sorted(labels.items())))
        templates.setdefault(key, []).append(d["name"])
    for key, names in templates.items():
        if len(names) < 2:
            continue
        if key[3]:
            raise ValueError(
                f"mix entries {', '.join(names)} share one pod template and "
                "a zone spread: the program would spread their union as one "
                "pod group, the reference each on its own; give each entry "
                "its own labels")
        others = [n for k, ns in templates.items()
                  if k != key and k[:2] == key[:2] for n in ns]
        if others:
            raise ValueError(
                f"mix entries {', '.join(names)} share one pod template, and "
                f"{', '.join(others)} request the same cpu and memory under "
                "another: the reference's name order would interleave them "
                "where the program packs the template as one pod group; give "
                "each entry its own labels")


class Traffic:
    def __init__(self, config: dict, traffic: dict, seed: int):
        check_mix(config)
        if traffic["request"] != "solve":
            raise ValueError(f"unknown request kind {traffic['request']!r}")
        self.config = config
        self.seed = int(seed)
        self.kind = traffic["request"]
        pods, k = traffic["pods"], int(traffic["block"])
        sizes = ([int(pods["fixed"])] * k if "fixed" in pods
                 else [int(n) for n in pods["sizes"]])
        if len(sizes) != k:
            raise ValueError(f"{len(sizes)} sizes for a block of {k}")
        shares = np.array([d["share"] for d in config["mix"]], float)
        shares /= shares.sum()
        # the shapes every seed sends: [K, deployments] pod counts
        self.pool = np.array([
            np.random.default_rng([int(traffic["pool_seed"]), j])
            .multinomial(n, shares) for j, n in enumerate(sizes)])

    def _rng(self, *words) -> np.random.Generator:
        return np.random.default_rng([self.seed % 2**63, *words])

    def shape(self, i: int) -> int:
        """The pool entry request `i` of the window sends."""
        k = len(self.pool)
        return int(self._rng(1, i // k).permutation(k)[i % k])

    def request(self, i: int, stream: int = 0) -> dict:
        """Request `i` of stream 0 (the window) or 1 (the warm-up, whose
        request `i` sends pool entry `i`, cyclically)."""
        rng = self._rng(stream, 2, i)
        counts = self.pool[i % len(self.pool) if stream else self.shape(i)]
        n = int(counts.sum())
        order = rng.permutation(np.repeat(np.arange(len(counts)), counts))
        tokens = rng.choice(2**40, size=n, replace=False)
        return {"kind": "solve", "index": i, "counts": counts,
                "order": order, "tokens": tokens}

    def warmup(self) -> "list[dict]":
        """The set-up's requests: every shape this traffic sends, once (two
        requests where the traffic has one shape)."""
        return [self.request(j, stream=1)
                for j in range(max(len(self.pool), 2))]


def pod_name(deployment: str, token) -> str:
    return f"{deployment}-{int(token):010x}"


def first_names(config: dict, record: dict) -> "list[str | None]":
    """The name of each deployment's first pod in the request's order."""
    order, tokens = record["order"], record["tokens"]
    out = []
    for d, dep in enumerate(config["mix"]):
        hit = np.flatnonzero(order == d)
        out.append(pod_name(dep["name"], tokens[hit[0]]) if hit.size else None)
    return out
