"""Launch options of the frozen catalog, derived from its JSON alone.

One option per (instance type, zone, capacity type). Allocatable is the
type's capacity less the kubelet's reservation and the VM's memory
overhead, on three resource axes: cpu (millicores), memory (MiB) and pods.
A pod's memory request rounds up to MiB, capacity and overhead each round
down, as the Karpenter instance-type model does (instancetype.go capacity
math: 7.5% VM memory overhead, kube-reserved memory 11 MiB a pod + 255 MiB,
a regressive kube-reserved CPU curve, a 100 MiB eviction threshold).
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np

MIB = 2**20
VM_MEMORY_OVERHEAD = 0.075
EVICTION_MIB = 100
RES = ("cpu", "memory", "pods")


def kube_reserved_cpu(cores: int) -> int:
    """Millicores reserved: 6% of the first core, 1% of the second, 0.5% of
    the next two and 0.25% of the rest."""
    millis, remaining = 0, cores * 1000
    for width, frac in ((1000, 0.06), (1000, 0.01), (2000, 0.005)):
        take = min(remaining, width)
        millis += int(take * frac)
        remaining -= take
    return millis + int(remaining * 0.0025)


def allocatable(entry: dict) -> "tuple[int, int, int]":
    cores, mem_mib, pods = entry["vcpu"], entry["memory_mib"], entry["pods"]
    ovh_mem = (int(mem_mib * MIB * VM_MEMORY_OVERHEAD)
               + (11 * pods + 255) * MIB + EVICTION_MIB * MIB)
    return (max(0, cores * 1000 - kube_reserved_cpu(cores)),
            max(0, mem_mib - ovh_mem // MIB), pods)


@dataclasses.dataclass
class Options:
    """Column arrays over every option, in catalog order."""

    type_name: np.ndarray      # [O] str
    zone: np.ndarray           # [O] str
    capacity_type: np.ndarray  # [O] str
    arch: np.ndarray           # [O] str
    category: np.ndarray       # [O] str, the family's leading letters
    generation: np.ndarray     # [O] int64
    price: np.ndarray          # [O] float64
    alloc: np.ndarray          # [O, 3] int64
    rank: np.ndarray           # [O] int64, 0 = the first launch choice

    @property
    def zones(self) -> "list[str]":
        return sorted(set(self.zone.tolist()))

    def subset(self, keep: np.ndarray) -> "Options":
        """The options where `keep` holds; ranks keep their order."""
        return Options(*(getattr(self, f.name)[keep]
                         for f in dataclasses.fields(self)))

    def key(self, i: int) -> tuple:
        return (str(self.type_name[i]), str(self.zone[i]),
                str(self.capacity_type[i]))


def load_catalog(path: str) -> "list[dict]":
    with open(path) as f:
        return json.load(f)["types"]


def category(family: str) -> str:
    """An instance family's category: its leading letters (c5n is c)."""
    return re.match(r"[a-z]*", family).group(0)


def build_options(types: "list[dict]", zones, spot_discount: float,
                  raw: bool = False) -> Options:
    """Every (type, zone, on-demand | spot) offering; spot at the on-demand
    price less `spot_discount`, rounded to 4 places. `raw` takes the
    capacity for the allocatable (the control's broken admission)."""
    rows = []
    for e in types:
        alloc = ((e["vcpu"] * 1000, e["memory_mib"], e["pods"]) if raw
                 else allocatable(e))
        od = e["od_price_usd"]
        for z in zones:
            for ct, price in (("on-demand", od),
                              ("spot", round(od * (1 - spot_discount), 4))):
                rows.append((e["name"], z, ct, e["arch"],
                             category(e["family"]), e["generation"], price,
                             alloc))
    name, zone, ct, arch, cat, gen, price, alloc = zip(*rows)
    # launch order: price, spot before on-demand, type name, zone
    order = sorted(range(len(rows)), key=lambda i: (
        price[i], ct[i] != "spot", name[i], zone[i]))
    rank = np.empty(len(rows), np.int64)
    rank[order] = np.arange(len(rows))
    return Options(np.array(name, dtype=object), np.array(zone, dtype=object),
                   np.array(ct, dtype=object), np.array(arch, dtype=object),
                   np.array(cat, dtype=object), np.array(gen, dtype=np.int64),
                   np.array(price, dtype=np.float64),
                   np.array(alloc, dtype=np.int64), rank)
