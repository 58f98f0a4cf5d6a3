"""Pod scheduling model.

Copy of karpenter_tpu/models/pod.py for the PyTorch port, which imports
nothing of the JAX package; tests/test_torch_solver.py holds the two copies
to the same answers.

Parity target: the pod-side inputs the reference's scheduler consumes —
resource requests, node selectors / required node affinity, tolerations,
topology spread constraints, priority, `controller.kubernetes.io/pod-deletion-cost`
and `karpenter.sh/do-not-evict` (designs/consolidation.md "Pods that Prevent
Consolidation"; website concepts). Owner references matter for consolidation
eligibility and daemonset exclusion.

TPU-first note: pods are deduplicated into scheduling GROUPS (identical
requests + constraints) before hitting the device — the kernel scans groups,
not pods, which turns a 10k-pod solve into an O(#deployments) scan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..apis import wellknown as wk
from ..utils.quantity import cpu_millis, mem_bytes, count as count_qty
from .requirements import Requirement, Requirements, OP_IN

ANNOTATION_DO_NOT_EVICT = "karpenter.sh/do-not-evict"
ANNOTATION_POD_DELETION_COST = "controller.kubernetes.io/pod-deletion-cost"

# group-key interning (see PodSpec.group_token). Tokens come from a monotonic
# counter and are never reused; clearing the table (pathological spec churn)
# bumps an EPOCH, and stamped tokens from older epochs are re-interned on next
# read (group_pods regroups such pods on content). Invariant: at any instant,
# token equality <=> group-key equality across all live specs — so group_pods
# stays a pure function of the pod list (the solver wire protocol depends on
# client and server deriving identical group partitions from identical pods).
import itertools as _itertools
import threading as _threading

_group_key_tokens: "dict[object, int]" = {}
_group_key_counter = _itertools.count()
_group_key_epoch = 0
_group_key_lock = _threading.Lock()
_GROUP_KEY_TABLE_MAX = 1 << 20
# per-thread running totals of group_pods' work (see group_counts)
_group_counts = _threading.local()


def _intern_group_key(key) -> "tuple[int, int]":
    global _group_key_epoch
    with _group_key_lock:
        t = _group_key_tokens.get(key)
        if t is None:
            if len(_group_key_tokens) >= _GROUP_KEY_TABLE_MAX:
                _group_key_tokens.clear()
                _group_key_epoch += 1
            t = _group_key_tokens[key] = next(_group_key_counter)
        return t, _group_key_epoch


@dataclasses.dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclasses.dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


def tolerates_all(tolerations: "tuple[Toleration, ...]", taints: "tuple[Taint, ...]") -> bool:
    """Pod schedulable w.r.t. taints: every NoSchedule/NoExecute taint tolerated."""
    for t in taints:
        if t.effect == "PreferNoSchedule":
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


@dataclasses.dataclass(frozen=True)
class PodAffinityTerm:
    """One required pod-(anti-)affinity term: a label selector over PODS plus
    the topology key whose domains are constrained.

    Reference analogue: core scheduling's inter-pod affinity handling
    (exercised by test/suites/integration/scheduling_test.go). Selector is
    matchLabels-conjunctive (matchExpressions with op In are folded into the
    same form by the manifest loader); the scheduler resolves terms against
    resident and co-pending pods in a host pre-pass
    (oracle/scheduler.py resolve_pod_affinity)."""

    match_labels: "tuple[tuple[str, str], ...]" = ()
    topology_key: str = wk.LABEL_HOSTNAME

    def matches(self, labels: "tuple[tuple[str, str], ...]") -> bool:
        d = dict(labels)
        return all(d.get(k) == v for k, v in self.match_labels)


@dataclasses.dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    # label selector is approximated as "pods of my own group" (self-selecting
    # deployments are the overwhelmingly common case; reference E2E
    # spread-zone.yaml/spread-hostname.yaml do exactly this).


@dataclasses.dataclass(frozen=True)
class PodSpec:
    name: str
    namespace: str = "default"
    labels: "tuple[tuple[str, str], ...]" = ()  # pod labels (PDB/service selectors)
    requests: "tuple[tuple[str, int], ...]" = ()  # canonical units (cpu millis, mem bytes, counts)
    requirements: Requirements = dataclasses.field(default_factory=Requirements)
    # soft preferences (preferredDuringScheduling): an ORDERED tuple of
    # requirement terms, highest weight first. The scheduler relaxes them
    # iteratively — it tries all terms, then drops the lowest-weight term,
    # and so on down to none — taking the largest satisfiable prefix
    # (the reference core's progressive preference relaxation,
    # pkg/controllers/provisioning/scheduling preferences; exercised by
    # examples/workloads/prefer-arm.yaml). Existing-node placement ignores
    # them (first-fit order is not rescored).
    preferences: "tuple[Requirements, ...]" = ()
    tolerations: "tuple[Toleration, ...]" = ()
    topology: "tuple[TopologySpreadConstraint, ...]" = ()
    anti_affinity_hostname: bool = False  # self anti-affinity on kubernetes.io/hostname
    anti_affinity_zone: bool = False
    # required pod-(anti-)affinity with label selectors (self-selecting
    # anti-affinity uses the booleans above; these carry cross-group terms)
    pod_affinity: "tuple[PodAffinityTerm, ...]" = ()
    pod_anti_affinity: "tuple[PodAffinityTerm, ...]" = ()
    priority: int = 0
    deletion_cost: int = 0
    owner_kind: str = "ReplicaSet"  # "" => bare pod; "DaemonSet" excluded from provisioning
    do_not_evict: bool = False
    node_name: str = ""  # bound node (for cluster-state pods)
    # set by the zone-split pre-pass: the PRE-SPLIT group key, so resident
    # pods (stored with their original spec) are still counted against the
    # split subgroup's per-node caps. NOT part of group_key (it's provenance,
    # not scheduling identity).
    spread_origin: "object" = None

    def origin_key(self):
        """Identity for counting RESIDENT pods of this logical group: the
        pre-split key when this spec is a zone-split subgroup."""
        return self.spread_origin if self.spread_origin is not None \
            else self.group_key()

    def resource_vector(self) -> "list[int]":
        return wk.resource_vector(dict(self.requests))

    def is_daemon(self) -> bool:
        return self.owner_kind == "DaemonSet"

    def group_key(self):
        """Pods with equal group keys are interchangeable for scheduling.
        Memoized per instance (frozen dataclass) in the pod's one stamp
        attribute, `_group` = (token, epoch, key), which group_pods shares
        among a group's pods; a key memoized here alone carries epoch -1,
        which no table epoch equals."""
        s = getattr(self, "_group", None)
        if s is not None:
            return s[2]
        k = (
            self.requests,
            self.requirements.canonical(),  # freezes: later in-place mutation raises
            tuple(t.canonical() for t in self.preferences),
            self.tolerations,
            self.topology,
            self.anti_affinity_hostname,
            self.anti_affinity_zone,
            self.pod_affinity,
            self.pod_anti_affinity,
            # labels separate otherwise-identical deployments: topology spread
            # is approximated as "pods of my own group", so merging across
            # selectors would balance the union instead of each deployment
            self.labels,
        )
        object.__setattr__(self, "_group", (None, -1, k))
        return k

    def group_token(self) -> int:
        """Small interned token equivalent to group_key() for dict/set use.

        The group-key tuple nests requirements/tolerations/topology and
        Python re-hashes it on EVERY dict operation — at 50k pods that
        hashing alone dominates host encode (bench config 4). The token is
        interned once per distinct key and stamped on the instance, so
        steady-state grouping costs one attribute read + int-dict op per
        pod. Token equality is equivalent to key equality — stamps from a
        cleared table epoch are re-interned (see _intern_group_key)."""
        s = getattr(self, "_group", None)
        if s is not None and s[1] == _group_key_epoch:
            return s[0]
        k = self.group_key()
        t, epoch = _intern_group_key(k)
        object.__setattr__(self, "_group", (t, epoch, k))
        return t


def make_pod(
    name: str,
    cpu: "str | int" = "0",
    memory: "str | int" = "0",
    pods: int = 1,
    node_selector: "Optional[dict[str, str]]" = None,
    requirements: "Optional[Requirements]" = None,
    extended: "Optional[dict[str, int]]" = None,
    **kwargs,
) -> PodSpec:
    """Convenience constructor used by tests/fixtures (reference analogue:
    coretest pod factories, pkg/test/)."""
    reqs: dict[str, int] = {}
    if cpu:
        reqs[wk.RESOURCE_CPU] = cpu_millis(cpu)
    if memory:
        reqs[wk.RESOURCE_MEMORY] = mem_bytes(memory)
    reqs[wk.RESOURCE_PODS] = pods
    for k, v in (extended or {}).items():
        reqs[k] = count_qty(v)
    r = Requirements()
    if node_selector:
        r = r.union(Requirements.from_node_selector(node_selector))
    if requirements:
        r = r.union(requirements)
    return PodSpec(
        name=name,
        requests=tuple(sorted(reqs.items())),
        requirements=r,
        **kwargs,
    )


@dataclasses.dataclass
class PodGroup:
    """A deduplicated batch of identical pods."""

    spec: PodSpec
    count: int
    pod_names: "list[str]"

    @property
    def vector(self) -> "list[int]":
        return self.spec.resource_vector()


def group_counts() -> "tuple[int, int, int]":
    """This thread's running totals of group_pods' work: pods grouped on
    their content key, pods grouped on their stamp, and keys merged into a
    group an earlier key began. A caller reads them before and after the
    calls it attributes."""
    return getattr(_group_counts, "totals", (0, 0, 0))


def group_pods(pods: "list[PodSpec]") -> "list[PodGroup]":
    # A pod stamped in the table's current epoch (see PodSpec.group_token)
    # is grouped on its token: one attribute read and an int-dict op. Any
    # other pod is grouped on a flat content key built inline: group_key()'s
    # fields as they are, the requirements as their per-key entries in
    # insertion order. No canonical form, intern, lock or memo per pod.
    # The content key is finer than group_key(): requirements added in
    # another key order, or In sets that fold bounds, canonicalise equal.
    # So once per distinct content key its first pod's group_key() is
    # interned, keys with equal tokens merge (names back in input order),
    # and the key's pods share one (token, epoch, key) stamp, their
    # requirements frozen as group_key() freezes them (hashing the content
    # key froze the preferences), so the next pass over them reads stamps.
    # The stamp is a pod's one attribute beyond its fields: on CPython 3.12
    # a second did not fit the instance's inline attribute slots, and every
    # pod then allocated a dict (stamping cost 4x).
    # Token equality == key equality only WITHIN one table epoch: if the
    # intern table clears mid-pass (2^20 distinct keys, or a concurrent
    # thread's clear), a token already used here could split from an
    # equal-key pod interned after the clear. Snapshot the epoch around the
    # pass and redo it on the (rare) mismatch so the result is always a
    # single-epoch partition — a pure function of the pod list.
    # Bounded retries: under epoch churn faster than a pass (many threads
    # interning disjoint key floods), fall back to grouping by the raw key
    # tuples — slower, but correct without any epoch assumption.
    stamp_attr = object.__setattr__
    for _ in range(3):
        epoch_before = _group_key_epoch
        members: "dict[object, list[PodSpec]]" = {}
        get = members.get
        for p in pods:
            c = getattr(p, "_group", None)
            if c is not None and c[1] == epoch_before:
                k = c[0]
            else:
                r = p.requirements._by_key
                k = (p.requests, tuple(r.values()) if r else (),
                     p.preferences, p.tolerations, p.topology,
                     p.anti_affinity_hostname, p.anti_affinity_zone,
                     p.pod_affinity, p.pod_anti_affinity, p.labels)
            lst = get(k)
            if lst is None:
                members[k] = [p]
            else:
                lst.append(p)
        # each key's token, and the keys (in first-seen order) of each token
        keys_of: "dict[int, list[list[PodSpec]]]" = {}
        stamped = 0
        for k, lst in members.items():
            if k.__class__ is int:
                tok = k
                stamped += len(lst)
            else:
                key = lst[0].group_key()
                tok, epoch = _intern_group_key(key)
                stamp = (tok, epoch, key)
                for p in lst:
                    stamp_attr(p, "_group", stamp)
                    p.requirements._frozen = True
            ks = keys_of.get(tok)
            if ks is None:
                keys_of[tok] = [lst]
            else:
                ks.append(lst)
        if _group_key_epoch != epoch_before:
            continue
        joined = {t: [] for t, ks in keys_of.items() if len(ks) > 1}
        if joined:
            # every pod now carries its group's stamp
            for p in pods:
                ns = joined.get(p._group[0])
                if ns is not None:
                    ns.append(p.name)
        out = []
        for t, ks in keys_of.items():
            ns = joined[t] if len(ks) > 1 else [p.name for p in ks[0]]
            out.append(PodGroup(spec=ks[0][0], count=len(ns), pod_names=ns))
        _count(len(pods) - stamped, stamped, len(members) - len(keys_of))
        return out
    bykey: "dict[object, PodGroup]" = {}
    for p in pods:
        g = bykey.get(p.group_key())
        if g is None:
            bykey[p.group_key()] = PodGroup(spec=p, count=1, pod_names=[p.name])
        else:
            g.count += 1
            g.pod_names.append(p.name)
    _count(len(pods), 0, 0)
    return list(bykey.values())


def _count(keyed: int, stamped: int, merged: int) -> None:
    k, s, m = group_counts()
    _group_counts.totals = (k + keyed, s + stamped, m + merged)
