"""First-fit-decreasing provisioning over pod groups, in NumPy.

Semantics (Karpenter's designs/bin-packing.md and instance.go selection):

* identical pods form a group; a group with a zone topology spread
  (maxSkew 1, DoNotSchedule) splits into one pinned subgroup a zone, its
  pods water-filled over the zones (the lowest-populated zone first, ties
  to the name-ordered first), counting the group's pods already resident;
* groups go in order of cpu, then memory, both descending, then the name of
  the group's first pod; the subgroups of one group keep zone order;
* each pod goes to the first existing node that fits it, else to the first
  open node (in opening order) that still has an option fitting the pod
  with what it holds, else opens a node for the highest-weight provisioner
  that admits it; an open node keeps the options that fit all its pods;
* a node launches its cheapest option (price, spot first, type, zone).

Identical pods take the same path, so a group is placed in bulk: a node
takes as many of the group's pods as its best option fits, and that is the
pod-by-pod result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .catalog import Options

BIG = np.int64(1) << 40


@dataclasses.dataclass
class Group:
    name: str                 # the group's first pod's name
    vec: np.ndarray           # [3] cpu millis, memory MiB, pods
    zone: Optional[str]       # a zone pin, or None
    count: int
    origin: str               # the pre-split group (existing-node residents)


@dataclasses.dataclass
class Provisioner:
    name: str
    capacity_types: "tuple[str, ...]"
    arch: "tuple[str, ...]" = ("amd64",)
    weight: int = 0
    categories: "Optional[tuple[str, ...]]" = None   # None: any
    generation_gt: "Optional[int]" = None            # None: any


@dataclasses.dataclass
class ExistingNode:
    name: str
    zone: str
    alloc: np.ndarray         # [3]
    used: np.ndarray          # [3]
    resident: "dict[str, int]" = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Claim:
    provisioner: Provisioner
    mask: np.ndarray          # [O] bool, the options still open
    used: np.ndarray          # [3]
    pods: int = 0


@dataclasses.dataclass
class Result:
    decisions: "list[tuple[str, str, str, int]]"   # sorted
    on_existing: "dict[str, int]"
    unschedulable: int
    claims: "list[Claim]"


def water_fill(resident: "dict[str, int]", zones: "list[str]",
               count: int) -> "dict[str, int]":
    """Each pod to the zone with the fewest of the group, ties to the
    name-ordered first."""
    # the highest level every zone can be filled to, then one pod each to
    # the name-ordered zones at or below it
    level = min(resident[z] for z in zones)
    while sum(max(0, level + 1 - resident[z]) for z in zones) <= count:
        level += 1 + max(0, (count - sum(max(0, level + 1 - resident[z])
                                         for z in zones)) // len(zones))
    while sum(max(0, level - resident[z]) for z in zones) > count:
        level -= 1
    shares = {z: max(0, level - resident[z]) for z in zones}
    left = count - sum(shares.values())
    for z in sorted(z for z in zones if resident[z] <= level)[:left]:
        shares[z] += 1
    return shares


def prepare_groups(specs: "Sequence[dict]", zones: "list[str]",
                   existing: "Sequence[ExistingNode]" = ()) -> "list[Group]":
    """specs: one dict a distinct pod shape, in first-occurrence order, with
    name, cpu (millis), memory (MiB), zone (a pin or None), spread (bool),
    count. -> the groups in FFD order."""
    groups = []
    for s in specs:
        if s["count"] <= 0:
            continue
        vec = np.array([s["cpu"], s["memory"], 1], np.int64)
        allowed = [z for z in zones if s["zone"] in (None, z)]
        if s["spread"] and allowed:
            resident = {z: sum(e.resident.get(s["name"], 0) for e in existing
                               if e.zone == z) for z in allowed}
            for z, n in water_fill(resident, allowed, s["count"]).items():
                if n:
                    groups.append(Group(s["name"], vec, z, n, s["name"]))
        else:
            groups.append(Group(s["name"], vec, s["zone"], s["count"],
                                s["name"]))
    # stable: the subgroups of one group keep their zone order
    groups.sort(key=lambda g: (-int(g.vec[0]), -int(g.vec[1]), g.name))
    return groups


def _fits(free: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """How many pods of `vec` fit in `free` ([..., 3]), elementwise."""
    per = np.where(vec > 0, free // np.maximum(vec, 1), BIG)
    k = per.min(axis=-1)
    return np.where((free >= 0).all(axis=-1), k, -1)


def feasible(options: Options, prov: Provisioner, group: Group) -> np.ndarray:
    """Options that admit one pod of the group on a fresh node of `prov`."""
    memo = options.__dict__.setdefault("_masks", {})
    key = (prov.capacity_types, prov.arch, prov.categories,
           prov.generation_gt)
    mask = memo.get(key)
    if mask is None:
        mask = memo[key] = np.array(
            [c in prov.capacity_types and a in prov.arch
             and (prov.categories is None or k in prov.categories)
             and (prov.generation_gt is None or g > prov.generation_gt)
             for c, a, k, g in zip(options.capacity_type.tolist(),
                                   options.arch.tolist(),
                                   options.category.tolist(),
                                   options.generation.tolist())],
            dtype=bool)
    if group.zone is not None:
        mask = mask & np.array([z == group.zone
                                for z in options.zone.tolist()], dtype=bool)
    return mask & (_fits(options.alloc, group.vec) >= 1)


def schedule(options: Options, provisioners: "Sequence[Provisioner]",
             groups: "Sequence[Group]",
             existing: "Sequence[ExistingNode]" = ()) -> Result:
    provs = sorted(provisioners, key=lambda p: (-p.weight, p.name))
    claims: "list[Claim]" = []
    on_existing: "dict[str, int]" = {}
    used_ex: "dict[str, np.ndarray]" = {}   # the existing nodes placed on
    unschedulable = 0
    for g in groups:
        left = g.count
        for e in existing:
            if not left:
                break
            if g.zone is not None and e.zone != g.zone:
                continue
            used = used_ex.get(e.name, e.used)
            k = min(left, int(_fits(e.alloc - used, g.vec)))
            if k > 0:
                used_ex[e.name] = used + k * g.vec
                on_existing[e.name] = on_existing.get(e.name, 0) + k
                left -= k
        if not left:
            continue
        feas = {p.name: feasible(options, p, g) for p in provs}
        for c in claims:
            if not left:
                break
            shared = c.mask & feas[c.provisioner.name]
            if not shared.any():
                continue
            k_opt = np.where(shared, _fits(options.alloc - c.used, g.vec), -1)
            k = min(left, int(k_opt.max()))
            if k <= 0:
                continue
            c.mask = shared & (k_opt >= k)
            c.used = c.used + k * g.vec
            c.pods += k
            left -= k
        while left:
            prov = next((p for p in provs if feas[p.name].any()), None)
            if prov is None:
                unschedulable += left
                break
            k_opt = np.where(feas[prov.name], _fits(options.alloc, g.vec), -1)
            k = min(left, int(k_opt.max()))
            claims.append(Claim(prov, feas[prov.name] & (k_opt >= k),
                                k * g.vec, k))
            left -= k
    decisions = [options.key(decided_option(options, c)) + (c.pods,)
                 for c in claims]
    return Result(sorted(decisions), on_existing, unschedulable, claims)


def decided_option(options: Options, claim: Claim) -> int:
    idx = np.flatnonzero(claim.mask)
    return int(idx[np.argmin(options.rank[idx])])
