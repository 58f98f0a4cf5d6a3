"""Host-side encoding: scheduling problem -> dense device arrays.

Copy of karpenter_tpu/models/encode.py for the PyTorch port, which imports
nothing of the JAX package; tests/test_torch_solver.py and
tests/test_torch_consolidation.py hold the two copies to the same answers.

This is the TPU-first redesign of the reference's per-object hot loop
(upstream designs/bin-packing.md:28-43 + pkg/cloudprovider/
cloudprovider.go:302-321 resolveInstanceTypes): every label/taint constraint is
folded ON HOST into boolean feasibility masks over a static (instanceType x
zone x capacityType) option grid, so the device kernel sees only dense int32
capacity math. Pods are deduplicated into groups (identical spec => identical
mask), so mask folding cost is O(#deployments), not O(#pods).

The folding reuses the oracle's exact matching code (feasible_options), which
guarantees the kernel and the scalar fallback agree on WHICH options are
feasible by construction; the kernel is differential-tested on the packing
arithmetic only.

Catalog-side arrays are versioned by Catalog.seqnum (the reference's
instance-type cache seqnum trick, instancetypes.go:62-68) so they can stay
device-resident across solves; only the group arrays ship per solve.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from ..apis import wellknown as wk
from ..apis.provisioner import Provisioner
from ..models.instancetype import Catalog
from ..models.pod import PodGroup, PodSpec
from ..models.requirements import IncompatibleError, Requirements
from ..models.pod import tolerates_all
from .cluster import ExistingColumns
from ..oracle.scheduler import (
    ExistingNode, Option, feasible_options, prepare_groups, _group_cap_per_node,
    kubelet_is_default, kubelet_overhead_vector, kubelet_pods_cap,
)

INT_BIG = np.int32(2**30)


@dataclasses.dataclass
class KeyCol:
    codes: np.ndarray             # i32 [T*S]; -1 = absent (value interned per key)
    vocab: "dict[str, int]"       # value -> code
    num: np.ndarray               # float64 [T*S]; nan = absent/non-numeric


@dataclasses.dataclass
class GridCols:
    """Per-key integer-coded label columns over the flat option axis, for
    vectorized requirement folding (the numpy fast path of feasible_options;
    checked equal to the scalar path in tests/test_encode.py)."""

    cols: "dict[str, KeyCol]"
    flat_valid: np.ndarray  # bool [T*S]


def build_cols(grid: "OptionGrid") -> GridCols:
    n = len(grid.options)
    raw: "dict[str, list]" = {}
    flat_valid = np.zeros(n, dtype=bool)
    labels_per_opt: "list[Optional[dict]]" = []
    for i, o in enumerate(grid.options):
        if o is None:
            labels_per_opt.append(None)
            continue
        flat_valid[i] = True
        d = dict(o.itype.labels)
        d[wk.LABEL_ZONE] = o.zone
        d[wk.LABEL_CAPACITY_TYPE] = o.capacity_type
        labels_per_opt.append(d)
        for k in d:
            raw.setdefault(k, None)
    cols: "dict[str, KeyCol]" = {}
    for k in raw:
        codes = np.full(n, -1, dtype=np.int32)
        num = np.full(n, np.nan)
        vocab: "dict[str, int]" = {}
        for i, d in enumerate(labels_per_opt):
            if d is None or k not in d:
                continue
            v = d[k]
            code = vocab.get(v)
            if code is None:
                code = vocab[v] = len(vocab)
            codes[i] = code
            try:
                num[i] = int(v)
            except ValueError:
                pass
        cols[k] = KeyCol(codes, vocab, num)
    return GridCols(cols, flat_valid)


def fold_option_mask(reqs: Requirements, cols: GridCols, prov: Provisioner) -> np.ndarray:
    """Requirements -> bool mask over flat options, under provisioner `prov`'s
    label overlay. Vectorized equivalent of
    `reqs.matches_labels(option_labels(opt, prov))` per option."""
    n = cols.flat_valid.shape[0]
    mask = cols.flat_valid.copy()
    overlay = {wk.LABEL_PROVISIONER: prov.name}
    for k, v in prov.labels:
        overlay.setdefault(k, v)
    for req in reqs:
        kc = cols.cols.get(req.key)
        if kc is None:
            # key not on any option: provisioner overlay or absent everywhere
            value = overlay.get(req.key)
            ok = req.has(value) if value is not None else req.allows_absent()
            if not ok:
                return np.zeros(n, dtype=bool)
            continue
        codes, num = kc.codes, kc.num
        present = codes >= 0
        fill_value = overlay.get(req.key)
        if fill_value is not None:
            # provisioner label fills options that lack the key
            # (option_labels setdefault semantics): absent slots behave as
            # carrying fill_value, membership + bounds included.
            absent_ok = req.has(fill_value)
        else:
            absent_ok = req.allows_absent()
        if req.forbid_key:
            ok = np.where(present, False, absent_ok)
        else:
            value_codes = [kc.vocab[v] for v in req.values if v in kc.vocab]
            hits = np.isin(codes, value_codes) if value_codes else np.zeros(n, bool)
            ok_present = ~hits if req.complement else hits
            if req.gt is not None or req.lt is not None:
                with np.errstate(invalid="ignore"):
                    if req.gt is not None:
                        ok_present &= num > req.gt
                    if req.lt is not None:
                        ok_present &= num < req.lt
            ok = np.where(present, ok_present, absent_ok)
        mask &= ok
    return mask


@dataclasses.dataclass
class OptionGrid:
    """Static (T x S) option lattice; S enumerates (zone, capacityType) pairs.

    Flat option index = t * S + s, giving a stable bijection with the
    oracle's Option list built from the same iteration order.
    """

    catalog: Catalog
    zones: "list[str]"
    capacity_types: "list[str]"
    options: "list[Optional[Option]]"  # length T*S, None where no offering DEFINED
    valid: np.ndarray  # bool [T, S] — offering defined AND currently available
    price: np.ndarray  # f32 [T, S]
    tiebreak: np.ndarray  # i32 [T, S], rank in (price, spot-first, name, zone) order
    alloc_t: np.ndarray  # i32 [T, R]
    seqnum: int
    cols: "Optional[GridCols]" = None  # lazily built label columns
    layout_key: int = 0  # availability-independent content fingerprint

    def get_cols(self) -> "GridCols":
        if self.cols is None:
            self.cols = build_cols(self)
        return self.cols

    def active_zones(self) -> "list[str]":
        """Zones with at least one AVAILABLE option — the zone-spread
        universe, which must match the oracle's (it builds options from
        available offerings only; build_options, oracle/scheduler.py)."""
        C = len(self.capacity_types)
        v = self.valid.reshape(self.T, len(self.zones), C)
        act = v.any(axis=(0, 2))
        return [z for zi, z in enumerate(self.zones) if act[zi]]

    @property
    def T(self):
        return len(self.catalog.types)

    @property
    def S(self):
        return len(self.zones) * len(self.capacity_types)

    def flat_options(self) -> "list[Option]":
        return [o for o in self.options if o is not None]


def grid_layout_key(catalog: Catalog) -> int:
    """Fingerprint of everything a grid depends on EXCEPT offering
    availability: type names/labels/allocatables and the defined offering
    lattice with prices. ICE marks (and expiries) flip only availability,
    so two catalogs with equal layout keys share every static grid array —
    the spot-storm fast path (an ICE seqnum bump then costs a [T,S] mask
    refresh instead of a full grid + group-encode rebuild)."""
    return hash(tuple(
        (t.name, tuple(sorted(t.labels_dict().items())),
         tuple(int(a) for a in t.allocatable_vector()),
         tuple(sorted((o.zone, o.capacity_type, float(o.price))
                      for o in t.offerings)))
        for t in catalog.types))


def build_grid(catalog: Catalog,
               reuse: "Optional[OptionGrid]" = None) -> OptionGrid:
    """Build the option lattice over every DEFINED offering; `valid` carries
    current availability separately. The zone-spread universe the oracle
    must agree on comes from active_zones() (available only), not from the
    static `zones` axis. When `reuse` has the same layout_key, its static
    arrays (options, price, tiebreak, alloc_t, label cols) are shared and
    only `valid` is recomputed."""
    key = grid_layout_key(catalog)
    if reuse is not None and reuse.layout_key == key:
        S = reuse.S
        valid = np.zeros_like(reuse.valid)
        zi_of = {z: i for i, z in enumerate(reuse.zones)}
        ci_of = {c: i for i, c in enumerate(reuse.capacity_types)}
        for ti, t in enumerate(catalog.types):
            for o in t.offerings:
                if o.available:
                    si = zi_of[o.zone] * len(reuse.capacity_types) \
                        + ci_of[o.capacity_type]
                    valid[ti, si] = True
        return OptionGrid(catalog, reuse.zones, reuse.capacity_types,
                          reuse.options, valid, reuse.price, reuse.tiebreak,
                          reuse.alloc_t, catalog.seqnum, cols=reuse.cols,
                          layout_key=key)
    zones = sorted({o.zone for t in catalog.types for o in t.offerings})
    cts = list(wk.CAPACITY_TYPES)  # on-demand, spot
    T, S = len(catalog.types), len(zones) * len(cts)
    options: "list[Optional[Option]]" = [None] * (T * S)
    valid = np.zeros((T, S), dtype=bool)
    price = np.full((T, S), np.inf, dtype=np.float32)
    alloc_t = np.zeros((T, wk.NUM_RESOURCES), dtype=np.int32)
    for ti, t in enumerate(catalog.types):
        alloc_t[ti] = np.minimum(t.allocatable_vector(), INT_BIG)
        defined = {(o.zone, o.capacity_type): o for o in t.offerings}
        for zi, z in enumerate(zones):
            for ci, ct in enumerate(cts):
                o = defined.get((z, ct))
                if o is None:
                    continue
                si = zi * len(cts) + ci
                flat = ti * S + si
                options[flat] = Option(flat, t, z, ct, o.price, tuple(int(a) for a in alloc_t[ti]))
                valid[ti, si] = o.available
                price[ti, si] = o.price
    # tiebreak rank: identical key to Option.sort_key (oracle decision
    # order). Ranking over the DEFINED universe preserves the relative
    # order of the available subset the oracle ranks; the kernel compares
    # ranks only within availability-masked feasible sets.
    tiebreak = np.full((T, S), INT_BIG, dtype=np.int32)
    ranked = sorted((o for o in options if o is not None), key=Option.sort_key)
    for rank, o in enumerate(ranked):
        tiebreak[o.index // S, o.index % S] = rank
    return OptionGrid(catalog, zones, cts, options, valid, price, tiebreak,
                      alloc_t, catalog.seqnum, layout_key=key)


def kubelet_arrays(
    provs: "list[Provisioner]", catalog: Catalog
) -> "tuple[Optional[np.ndarray], Optional[np.ndarray]]":
    """(prov_overhead [Pv, R], prov_pods_cap [Pv, T]) — None, None when every
    provisioner runs kubelet defaults (keeps the compiled kernel unchanged
    for the common case; the reference hashes kubelet config into its
    instance-type cache key the same way, instancetypes.go:104-111)."""
    if all(kubelet_is_default(p.kubelet) for p in provs):
        return None, None
    Pv, T, R = len(provs), len(catalog.types), wk.NUM_RESOURCES
    ovh = np.zeros((max(Pv, 1), R), dtype=np.int32)
    cap = np.full((max(Pv, 1), max(T, 1)), INT_BIG, dtype=np.int32)
    cores = [max(1, dict(t.capacity).get(wk.RESOURCE_CPU, 1000) // 1000)
             for t in catalog.types]
    for pi, p in enumerate(provs):
        ovh[pi] = np.minimum(kubelet_overhead_vector(p.kubelet), INT_BIG)
        for ti, t in enumerate(catalog.types):
            c = kubelet_pods_cap(p.kubelet, t, cores=cores[ti])
            if c is not None:
                cap[pi, ti] = min(c, int(INT_BIG))
    return ovh, cap


@dataclasses.dataclass
class EncodedProblem:
    """Everything the packer kernel consumes, as numpy (device-put by caller)."""

    # catalog side (device-resident across solves, keyed by grid.seqnum)
    alloc_t: np.ndarray    # i32 [T, R]
    valid: np.ndarray      # bool [T, S]
    tiebreak: np.ndarray   # i32 [T, S]
    # per-solve group side
    group_vec: np.ndarray     # i32 [G, R]
    group_count: np.ndarray   # i32 [G]
    group_cap: np.ndarray     # i32 [G]  (INT_BIG when uncapped)
    group_feas: np.ndarray    # bool [G, Pv, T, S]
    group_newprov: np.ndarray  # i32 [G]  (-1: no provisioner admits)
    overhead: np.ndarray      # i32 [R] daemonset overhead on fresh nodes
    # existing nodes
    ex_alloc: np.ndarray   # i32 [Ne, R]
    ex_used: np.ndarray    # i32 [Ne, R]
    ex_feas: np.ndarray    # bool [G, Ne]
    n_slots: int           # N: max new node claims (static)
    # bookkeeping for decode
    groups: "list[PodGroup]"
    provisioners: "list[Provisioner]"
    grid: OptionGrid
    # per-provisioner kubelet effects (None when all defaults)
    prov_overhead: "Optional[np.ndarray]" = None  # i32 [Pv, R]
    prov_pods_cap: "Optional[np.ndarray]" = None  # i32 [Pv, T]
    # remaining per-(group, existing-node) cap; None when no group is capped
    ex_cap: "Optional[np.ndarray]" = None  # i32 [G, Ne]
    # origin-representative row per group (first row sharing origin_key):
    # zone-split subgroups of one deployment share one per-node cap budget
    group_origin: "Optional[np.ndarray]" = None  # i32 [G]


def encode_problem(
    catalog: Catalog,
    provisioners: Sequence[Provisioner],
    pods: "list[PodSpec]",
    existing: Sequence[ExistingNode] = (),
    daemon_overhead: Optional[Sequence[int]] = None,
    n_slots: Optional[int] = None,
    grid: Optional[OptionGrid] = None,
    group_cache: "Optional[dict]" = None,
    option_mask: Optional[np.ndarray] = None,
    marks: "Optional[list]" = None,
) -> EncodedProblem:
    """`group_cache` (owned by a solver instance whose provisioner set is
    fixed) memoizes encode_group results across solves keyed by (group key,
    grid seqnum, daemon overhead): steady-state controllers re-solve the
    same deployments against an unchanged grid, and the mask folding is the
    dominant per-group cost (the reference memoizes the analogous
    instance-type construction, instancetypes.go:104-120).

    `option_mask` (bool [T, S], the spot plane's diversity-floor dimension)
    ANDs into availability for NEW-node admission only — existing-node
    feasibility is untouched, matching the oracle's barred-option filter.
    The final cache level is bypassed while a mask is active (masks change
    within a solve loop); the static folds are still reused.

    `marks`, where given, gets the solver's span boundaries appended:
    perf_counter_ns() before and after prepare_groups, after the per-group
    fold and after the bounds, then the groups the cache missed."""
    if grid is None or grid.seqnum != catalog.seqnum:
        grid = build_grid(catalog, reuse=grid)
    provs = sorted(provisioners, key=lambda p: (-p.weight, p.name))
    overhead = list(daemon_overhead or [0] * wk.NUM_RESOURCES)
    # zone-spread universe = zones with AVAILABLE options (parity with the
    # oracle's available-offering universe; the grid's static zone axis
    # spans all DEFINED offerings)
    if marks is not None:
        marks.append(time.perf_counter_ns())
    groups = prepare_groups(pods, grid.active_zones(), existing)
    if marks is not None:
        marks.append(time.perf_counter_ns())
    G, Pv, T, S = len(groups), len(provs), grid.T, grid.S
    R = wk.NUM_RESOURCES

    group_vec = np.zeros((max(G, 1), R), dtype=np.int32)
    group_count = np.zeros((max(G, 1),), dtype=np.int32)
    group_cap = np.full((max(G, 1),), INT_BIG, dtype=np.int32)
    group_feas = np.zeros((max(G, 1), max(Pv, 1), T, S), dtype=bool)
    group_newprov = np.full((max(G, 1),), -1, dtype=np.int32)
    ex_alloc = np.zeros((max(len(existing), 1), R), dtype=np.int32)
    ex_used = np.zeros((max(len(existing), 1), R), dtype=np.int32)
    ex_feas = np.zeros((max(G, 1), max(len(existing), 1)), dtype=bool)

    # HOT:BEGIN(existing-encode) — per-node work here must be vectorized
    ex_cols = existing if isinstance(existing, ExistingColumns) else None
    if ex_cols is not None:
        ne = len(ex_cols)
        ex_alloc[:ne] = np.minimum(ex_cols.alloc_rows, INT_BIG)
        ex_used[:ne] = np.minimum(ex_cols.used_rows, INT_BIG)
    else:
        # hot-loop-ok: legacy dataclass-view compatibility path (round-2
        # carry lists, oracle callers); the columnar branch above is the
        # production path
        for ei, e in enumerate(existing):
            ex_alloc[ei] = np.minimum(e.allocatable, INT_BIG)
            ex_used[ei] = np.minimum(e.used, INT_BIG)

    prov_overhead, prov_pods_cap = kubelet_arrays(provs, catalog)

    # Subgroups sharing an origin (ScheduleAnyway zone splits differ only in
    # soft preferences) consume ONE per-node cap budget — the kernel's carried
    # ex_placed/claim_placed counters are keyed by this representative row,
    # mirroring the oracle's origin-keyed group_counts.
    group_origin = np.arange(max(G, 1), dtype=np.int32)
    first_by_origin: "dict[object, int]" = {}
    for gi, g in enumerate(groups):
        group_origin[gi] = first_by_origin.setdefault(g.spec.origin_key(), gi)

    cols = grid.get_cols()
    if group_cache is not None:
        # two-level invalidation: the STATIC level (requirement folds over
        # the defined universe) survives ICE seqnum churn and clears only
        # on layout changes; the FINAL level (availability folded in) is
        # per-seqnum. A spot storm then costs cheap mask ANDs per group,
        # not a re-fold (the reference's analogous split is the seqnum-
        # keyed ICE cache atop the long-lived instance-type cache,
        # instancetypes.go:104-120 + unavailableofferings.go:31-80).
        if group_cache.get("layout") != grid.layout_key:
            group_cache.clear()
            group_cache["layout"] = grid.layout_key
            group_cache["static"] = {}
        if group_cache.get("seqnum") != grid.seqnum:
            group_cache["seqnum"] = grid.seqnum
            group_cache["entries"] = {}
    ovh_key = tuple(overhead)
    avail = grid.valid if option_mask is None else (grid.valid & option_mask)
    misses = 0
    for gi, g in enumerate(groups):
        entry = None
        ck = None
        if group_cache is not None:
            ck = (g.spec.group_key(), ovh_key)
            if option_mask is None:
                entry = group_cache["entries"].get(ck)
        if entry is None:
            misses += 1
            static = group_cache["static"].get(ck) if ck is not None else None
            if static is None:
                static = encode_group_static(
                    g, provs, grid, cols, overhead,
                    prov_overhead=prov_overhead, prov_pods_cap=prov_pods_cap)
                if ck is not None:
                    statics = group_cache["static"]
                    if len(statics) > 2048:  # bound churny-workload growth
                        statics.clear()
                    statics[ck] = static
            entry = combine_group(static, avail)
            if ck is not None and option_mask is None:
                entries = group_cache["entries"]
                if len(entries) > 2048:
                    entries.clear()
                entries[ck] = entry
        vec, cap, feas, newprov = entry
        group_vec[gi] = vec
        group_count[gi] = g.count
        group_cap[gi] = cap
        group_feas[gi] = feas
        group_newprov[gi] = newprov
        if ex_cols is not None:
            ex_feas[gi, :len(ex_cols)] = existing_fit_vector(ex_cols, g.spec)
        else:
            # hot-loop-ok: legacy dataclass-view compatibility path
            for ei, e in enumerate(existing):
                ex_feas[gi, ei] = _ex_label_fit(e, g.spec)
    if marks is not None:
        marks.append(time.perf_counter_ns())

    # Per-existing-node REMAINING group caps: hostname spread/anti-affinity
    # counts pods already RESIDENT on the node (the oracle does the same via
    # ExistingNode.group_counts seeding). When present, this array REPLACES
    # the scalar group_cap on the existing-node path, so capped groups get
    # their cap here even on resident-free nodes.
    ex_cap = None
    if existing and any(int(c) < int(INT_BIG) for c in group_cap[:max(G, 1)]):
        ex_cap = np.full((max(G, 1), max(len(existing), 1)), INT_BIG,
                         dtype=np.int32)
        for gi, g in enumerate(groups):
            cap = int(group_cap[gi])
            if cap >= int(INT_BIG):
                continue
            # residents carry their PRE-SPLIT spec: count via origin key;
            # group_counts carries IN-RUN placements from an earlier solve
            # round (the two-round co-pending affinity solve) — the oracle's
            # cap check is resident_counts[okey] + group_counts[okey]
            okey = g.spec.origin_key()
            if ex_cols is not None:
                remaining = cap - ex_cols.resident_count_vector(okey)
                # in-run placements (group_counts) only exist on views some
                # earlier consumer materialized; a fresh snapshot has none
                for ei, view in ex_cols._views.items():  # hot-loop-ok: sparse
                    remaining[ei] -= view.group_counts.get(okey, 0)
                ex_cap[gi, :len(ex_cols)] = np.maximum(0, remaining)
            else:
                # hot-loop-ok: legacy dataclass-view compatibility path
                for ei, e in enumerate(existing):
                    ex_cap[gi, ei] = max(0, cap
                                         - e.resident_counts.get(okey, 0)
                                         - e.group_counts.get(okey, 0))
    # HOT:END(existing-encode)

    if n_slots is None:
        # Tight upper bound on claim slots: group g opens at most
        # ceil(count_g / kstar_g) fresh nodes, kstar_g = max pods-per-fresh-node
        # over its admitting provisioner's feasible types (kernel step 3 math).
        bound = 0
        alloc64 = grid.alloc_t.astype(np.int64)
        ovh = np.asarray(overhead, dtype=np.int64)
        pods_i = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
        for gi, g in enumerate(groups):
            pi = int(group_newprov[gi])
            if pi < 0:
                continue
            vec = group_vec[gi].astype(np.int64)
            ovh_p = ovh if prov_overhead is None \
                else ovh + prov_overhead[pi].astype(np.int64)
            q0 = np.where(vec[None, :] > 0,
                          (alloc64 - ovh_p[None, :]) // np.maximum(vec[None, :], 1),
                          INT_BIG)
            q0 = np.where(alloc64 - ovh_p[None, :] < 0, -1, q0).min(axis=1)
            if prov_pods_cap is not None and vec[pods_i] > 0:
                q0 = np.minimum(q0, np.maximum(
                    (prov_pods_cap[pi].astype(np.int64) - ovh_p[pods_i])
                    // vec[pods_i], -1))
            feas_t = group_feas[gi, pi].any(axis=1)
            kstar = int(min(max(q0[feas_t].max(initial=0), 0), group_cap[gi]))
            if kstar > 0:
                bound += -(-int(group_count[gi]) // kstar)
        n_slots = max(8, bound)
    if marks is not None:
        marks += (time.perf_counter_ns(), misses)

    return EncodedProblem(
        alloc_t=grid.alloc_t, valid=grid.valid, tiebreak=grid.tiebreak,
        group_vec=group_vec, group_count=group_count, group_cap=group_cap,
        group_feas=group_feas, group_newprov=group_newprov,
        overhead=np.asarray(overhead, dtype=np.int32),
        ex_alloc=ex_alloc, ex_used=ex_used, ex_feas=ex_feas,
        n_slots=n_slots,
        groups=groups, provisioners=list(provs), grid=grid,
        prov_overhead=prov_overhead, prov_pods_cap=prov_pods_cap,
        ex_cap=ex_cap, group_origin=group_origin,
    )


@dataclasses.dataclass
class GroupStatic:
    """Availability-independent encode of one pod group: valid as long as
    the grid LAYOUT (types/labels/allocs/defined offerings) is unchanged,
    i.e. across ICE seqnum bumps. combine_group folds current availability
    in — together they are bit-identical to the one-shot encode_group."""

    vec: np.ndarray  # i32 [R]
    cap: int
    n_provs: int
    # (pi, base mask [T,S] pre-availability, pref masks in k-descending
    # relaxation order, each pre-availability)
    per_prov: "list[tuple[int, np.ndarray, list[np.ndarray]]]"


def encode_group_static(
    group: PodGroup,
    provs: "list[Provisioner]",
    grid: OptionGrid,
    cols: GridCols,
    overhead: Sequence[int],
    prov_overhead: Optional[np.ndarray] = None,
    prov_pods_cap: Optional[np.ndarray] = None,
) -> GroupStatic:
    """The fold half of the admission rule (tolerations ∧ requirements ∧
    fresh-node capacity) over the DEFINED option universe — everything
    except current offering availability."""
    T, S = grid.T, grid.S
    vec = np.minimum(group.vector, INT_BIG).astype(np.int32)
    cap = _group_cap_per_node(group.spec)
    cap = INT_BIG if cap is None else cap
    per_prov: "list[tuple[int, np.ndarray, list[np.ndarray]]]" = []
    ovh = np.asarray(overhead, dtype=np.int64)
    alloc64 = grid.alloc_t.astype(np.int64)
    vec64 = vec.astype(np.int64)
    fits_default = np.all(alloc64 - ovh[None, :] - vec64[None, :] >= 0, axis=1)
    pods_i = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
    for pi, prov in enumerate(provs):
        if not tolerates_all(group.spec.tolerations, prov.taints):
            continue
        try:
            reqs = prov.scheduling_requirements().union(group.spec.requirements)
        except IncompatibleError:
            continue
        if prov_overhead is None:
            fits_t = fits_default
        else:
            # kubelet-adjusted fresh-node fit: extra reserved overhead plus
            # the pods cap must still admit one pod (oracle feasible_options)
            ovh_p = ovh + prov_overhead[pi].astype(np.int64)
            fits_t = np.all(alloc64 - ovh_p[None, :] - vec64[None, :] >= 0, axis=1)
            if prov_pods_cap is not None:
                fits_t &= (prov_pods_cap[pi].astype(np.int64)
                           - ovh_p[pods_i] - vec64[pods_i] >= 0)
        base = fold_option_mask(reqs, cols, prov).reshape(T, S) & fits_t[:, None]
        prefs: "list[np.ndarray]" = []
        if base.any() and group.spec.preferences:
            # empty base can only stay empty under availability ANDs, so
            # prefix folds would never be consulted — skip them (the old
            # one-shot encode gated the relaxation the same way)
            # iterative preference relaxation — mirrors the oracle's
            # feasible_options exactly (PodSpec.preferences docstring):
            # largest satisfiable prefix of weight-ordered terms wins;
            # satisfiability depends on availability, so the prefix masks
            # are stored and the CHOICE happens in combine_group
            for k in range(len(group.spec.preferences), 0, -1):
                try:
                    pref_reqs = reqs
                    for term in group.spec.preferences[:k]:
                        pref_reqs = pref_reqs.union(term)
                except IncompatibleError:
                    continue
                prefs.append(fold_option_mask(pref_reqs, cols, prov)
                             .reshape(T, S) & fits_t[:, None])
        per_prov.append((pi, base, prefs))
    return GroupStatic(vec, cap, len(provs), per_prov)


def combine_group(
    static: GroupStatic, avail: np.ndarray,
) -> "tuple[np.ndarray, int, np.ndarray, int]":
    """Fold current availability (grid.valid, optionally ∧ an extra option
    mask) into a static group encode -> (vec, cap, feas [Pv,T,S], newprov)."""
    T, S = avail.shape
    feas = np.zeros((static.n_provs, T, S), dtype=bool)
    newprov = -1
    for pi, base, prefs in static.per_prov:
        mask = base & avail
        if mask.any() and prefs:
            for pm in prefs:  # k-descending; largest satisfiable prefix wins
                m2 = pm & avail
                if m2.any():
                    mask = m2
                    break
        if mask.any():
            feas[pi] = mask
            if newprov < 0:
                newprov = pi
    return static.vec, static.cap, feas, newprov


def diagnose_unschedulable(
    pod: PodSpec,
    provisioners: "Sequence[Provisioner]",
    catalog: Catalog,
    daemon_overhead: Optional[Sequence[int]] = None,
    grid: Optional[OptionGrid] = None,
    kubelet: "Optional[tuple]" = None,
    option_mask: Optional[np.ndarray] = None,
) -> str:
    """WHY a pod cannot schedule, as a human-readable clause for the
    FailedScheduling event — the reference's scheduler errors name the
    failing constraint ("incompatible with provisioner …", "no instance
    type satisfied resources …") rather than a generic message. Walks the
    admission rule's stages in order and reports the first one no
    provisioner survives."""
    if grid is None or grid.seqnum != catalog.seqnum:
        grid = build_grid(catalog, reuse=grid)
    provs = list(provisioners)  # flags are ORed: order is irrelevant
    cols = grid.get_cols()
    overhead = list(daemon_overhead or [0] * wk.NUM_RESOURCES)
    group = PodGroup(spec=pod, count=1, pod_names=[pod.name])
    vec64 = np.minimum(group.vector, INT_BIG).astype(np.int64)
    ovh = np.asarray(overhead, dtype=np.int64)
    alloc64 = grid.alloc_t.astype(np.int64)
    # kubelet arrays are O(Pv*T) Python to build: callers diagnosing many
    # groups per cycle pass them in once (indexed by position in `provs`)
    prov_overhead, prov_pods_cap = (
        kubelet if kubelet is not None else kubelet_arrays(provs, catalog))
    any_tol = any_req = any_fit = any_avail = any_divers = False
    eff_valid = grid.valid if option_mask is None \
        else (grid.valid & option_mask)
    for pi, prov in enumerate(provs):
        if not tolerates_all(pod.tolerations, prov.taints):
            continue
        any_tol = True
        try:
            reqs = prov.scheduling_requirements().union(pod.requirements)
        except IncompatibleError:
            continue
        req_mask = fold_option_mask(reqs, cols, prov).reshape(grid.T, grid.S)
        if not req_mask.any():
            continue
        any_req = True
        ovh_p = ovh if prov_overhead is None \
            else ovh + prov_overhead[pi].astype(np.int64)
        fits_t = np.all(alloc64 - ovh_p[None, :] - vec64[None, :] >= 0, axis=1)
        if prov_pods_cap is not None:
            pods_i = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
            fits_t &= (prov_pods_cap[pi].astype(np.int64)
                       - ovh_p[pods_i] - vec64[pods_i] >= 0)
        m = req_mask & fits_t[:, None]
        if not m.any():
            continue
        any_fit = True
        if (m & grid.valid).any():
            any_avail = True
            if (m & eff_valid).any():
                any_divers = True
    if not any_tol:
        return "pod does not tolerate the taints of any provisioner"
    if not any_req:
        return ("pod requirements are incompatible with every "
                "provisioner and instance type")
    if not any_fit:
        return "resource requests do not fit any compatible instance type"
    if not any_avail:
        return ("every compatible offering is currently unavailable "
                "(insufficient capacity)")
    if not any_divers:
        return ("every remaining compatible offering is barred by the spot "
                "diversity floor this cycle")
    # option-level admission passes; the failure is cross-pod (affinity /
    # topology caps / provisioner limits interplay) this cycle
    return ("compatible capacity exists but scheduling constraints "
            "(affinity/topology/limits) were unsatisfiable this cycle")


def encode_group(
    group: PodGroup,
    provs: "list[Provisioner]",
    grid: OptionGrid,
    cols: GridCols,
    overhead: Sequence[int],
    extra_mask: Optional[np.ndarray] = None,
    prov_overhead: Optional[np.ndarray] = None,
    prov_pods_cap: Optional[np.ndarray] = None,
) -> "tuple[np.ndarray, int, np.ndarray, int]":
    """One pod group -> (vec [R], cap, feas [Pv,T,S], newprov).

    The single source of the admission rule (tolerations ∧ requirements ∧
    fresh-node capacity ∧ availability ∧ optional extra option mask) shared
    by provisioning (encode_problem) and consolidation (ops/consolidate.py)
    — the two must stay bit-identical for kernel/oracle parity."""
    static = encode_group_static(group, provs, grid, cols, overhead,
                                 prov_overhead=prov_overhead,
                                 prov_pods_cap=prov_pods_cap)
    avail = grid.valid if extra_mask is None else (grid.valid & extra_mask)
    return combine_group(static, avail)


def _ex_label_fit(e: ExistingNode, spec: PodSpec) -> bool:
    """Label/taint feasibility of an existing node, capacity excluded (the
    kernel handles capacity)."""
    from ..models.pod import tolerates_all

    return (tolerates_all(spec.tolerations, e.taints)
            and spec.requirements.matches_labels(e.effective_labels()))


def fold_node_mask(reqs: Requirements, lookup, n: int) -> np.ndarray:
    """Requirements -> bool mask over node rows. Vectorized equivalent of
    `reqs.matches_labels(labels_of_row)` per row (the node-axis twin of
    fold_option_mask — no provisioner overlay; whether hostname defaults to
    the node name is the caller's choice of `lookup`).

    `lookup(key)` returns (codes [i32 n], num [f64 n], vocab) with -1/nan for
    rows lacking the key, or None when no row anywhere carries the key.
    Checked against matches_labels property-test-style in
    tests/test_columnar_state.py."""
    mask = np.ones(n, dtype=bool)
    for req in reqs:
        col = lookup(req.key)
        if col is None:
            if not req.allows_absent():
                return np.zeros(n, dtype=bool)
            continue
        codes, num, vocab = col
        present = codes >= 0
        if req.forbid_key:
            mask &= ~present
            continue
        value_codes = [vocab[v] for v in req.values if v in vocab]
        hits = np.isin(codes, value_codes) if value_codes \
            else np.zeros(n, dtype=bool)
        ok_present = ~hits if req.complement else hits
        if req.gt is not None or req.lt is not None:
            with np.errstate(invalid="ignore"):
                if req.gt is not None:
                    ok_present &= num > req.gt
                if req.lt is not None:
                    ok_present &= num < req.lt
        mask &= np.where(present, ok_present, req.allows_absent())
    return mask


def existing_fit_vector(ex: "ExistingColumns", spec: PodSpec) -> np.ndarray:
    """Columnar `_ex_label_fit`: one [Ne] bool vector per group spec, folded
    over the snapshot's label-code columns (hostname defaulted to node name,
    effective_labels() semantics) and the interned taint-set codes — each
    distinct taint set is checked against the tolerations once, not per node.
    Memoized per (snapshot, spec)."""
    cached = ex._fit_cache.get(id(spec))
    if cached is not None and cached[0] is spec:
        return cached[1]
    n = len(ex)
    mask = fold_node_mask(spec.requirements, ex.label_lookup, n)
    codes = ex.taint_codes
    for code in np.unique(codes):
        taints = ex.taint_set_of(int(code))
        if taints and not tolerates_all(spec.tolerations, taints):
            mask = mask & (codes != code)
    ex._fit_cache[id(spec)] = (spec, mask)
    return mask
