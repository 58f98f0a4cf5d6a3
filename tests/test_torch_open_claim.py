"""Step 2 of the pack step (the open-claim fill) in the port vs the JAX package.

* Lockstep: the port's `packer._step` (whose step 2 is
  `ops.open_claim.open_claim_fill`, the plain version on CPU tensors) and the
  JAX package's `karpenter_tpu.ops.packer._step` start from one state and
  step through the same groups; after every step every PackState field and
  every row output must be equal. The inputs are the captured PackInputs of
  test_packer_parity fixtures (with the res_sel compression pack_impl
  applies) and synthetic edge states made from a numpy seed. The JAX side
  runs its quotient both as plain XLA and, where values stay below 2**24,
  as the Pallas kernel in interpret mode.
* The plain version against the step-2 code the packer ran before the
  redesign, and the wrapper's in-place CPU path against the plain version.
* The two identities the CUDA kernel (csrc/open_claim.cu) relies on: the
  division-free shrink (q >= m from the new used row) and the
  multiply-shift floor division.
* The wrapper's argument checks.

Every comparison is exact (tolerance 0): everything is int32 or bool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_packer_parity as tpp
from karpenter_tpu.ops import packer as jp
from karpenter_tpu.solver import core as jcore
from karpenter_tpu_torch.apis import wellknown as wk
from karpenter_tpu_torch.device import LAUNCHES
from karpenter_tpu_torch.ops import open_claim as oc
from karpenter_tpu_torch.ops import packer as tp
from karpenter_tpu_torch.ops import quotient as tq

INT_BIG = 2**30
PODS_I = wk.RESOURCE_INDEX[wk.RESOURCE_PODS]
R_FULL = wk.NUM_RESOURCES


# -- lockstep ------------------------------------------------------------------

def host_fields(inputs) -> dict:
    return {k: None if v is None else np.asarray(v)
            for k, v in inputs._asdict().items()}


def jax_compressed(fields: dict) -> dict:
    """The JAX _step's view of the inputs: pack_impl gathers the active
    resource columns of alloc_t before its loop."""
    if fields["res_sel"] is None:
        return fields
    alloc = np.where(fields["res_mask"][None, :],
                     fields["alloc_t"][:, fields["res_sel"]], 0)
    return dict(fields, alloc_t=alloc.astype(np.int32))


def initial_state(fields: dict, n_slots: int) -> dict:
    G, R = fields["group_vec"].shape
    T, S = fields["tiebreak"].shape
    Ne = fields["ex_alloc"].shape[0]
    return {
        "used": np.zeros((n_slots, R), np.int32),
        "optmask": np.zeros((n_slots, T, S), bool),
        "nprov": np.full((n_slots,), -1, np.int32),
        "active": np.zeros((n_slots,), bool),
        "n_open": np.int32(0),
        "ex_used": np.asarray(fields["ex_used"], np.int32),
        "ex_placed": np.zeros((G, Ne), np.int32),
        "claim_placed": np.zeros((G, n_slots), np.int32),
    }


def lockstep(fields: dict, n_slots: int, state: dict, use_pallas: bool,
             steps: int) -> int:
    """Step both packages from `state` for `steps` groups, comparing after
    each step. Returns the number of open-claim pods placed (so a case can
    show that step 2 did work)."""
    step = jax.jit(jp._step, static_argnames=("use_pallas",))
    jin = jp.PackInputs(**{k: None if v is None else jnp.asarray(v)
                           for k, v in jax_compressed(fields).items()})
    tin = tp.pack_inputs_from_numpy(fields, "cpu")
    loop = tp._make_loop(tin, n_slots)
    js = jp.PackState(**{k: jnp.asarray(v) for k, v in state.items()})
    ts = tp.PackState(**{k: torch.from_numpy(np.array(v, copy=True))
                         for k, v in state.items()})
    placed_open = 0
    for g in range(steps):
        used_before = np.array(ts.used.numpy(), copy=True)
        js, jrows = step(jin, js, g, use_pallas=use_pallas)
        ts, trows = tp._step(tin, loop, ts, g)
        for name in tp.PackState._fields:
            want = np.asarray(getattr(js, name))
            got = getattr(ts, name).numpy()
            assert got.dtype == want.dtype, (g, name, got.dtype, want.dtype)
            bad = np.argwhere(got != want)
            assert bad.size == 0, (
                f"step {g}: {name} differs at {bad[0].tolist()}: port "
                f"{got[tuple(bad[0])]} jax {want[tuple(bad[0])]}")
        for i, (j, t) in enumerate(zip(jrows, trows)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"step {g} row output {i}")
        grew = (ts.used.numpy() != used_before).any(axis=1)
        placed_open += int(grew[:int(state["n_open"])].sum())
    return placed_open


LOCKSTEP_FIXTURES = [
    "test_parity_mixed_sizes",                       # Pv 1
    "test_parity_taints_and_gpu",                    # Pv 2
    "test_parity_kubelet_max_pods",                  # pods cap
    "test_parity_kubelet_mixed_provisioners",        # Pv 2 + pods cap
    "test_parity_existing_nodes",                    # step 1 feeds rem
    "test_parity_soft_zone_split_shares_per_node_cap",  # shared origin rows
    "test_parity_zone_split_keeps_resident_hostname_caps",
    "test_parity_unschedulable",
]


def captured_rounds(fixture: str, monkeypatch) -> list:
    """Every round's host PackInputs and dims of a parity fixture's
    TPUSolver solve (the oracle side of the fixture still runs)."""
    rounds = []
    real_build = jcore.build_pack_inputs

    def build(enc, *args):
        inputs, dims, use_pallas = real_build(enc, *args)
        rounds.append((host_fields(inputs), dims))
        return inputs, dims, use_pallas

    def solve(catalog, provisioners, pods, existing=None,
              daemon_overhead=None):
        existing = [tpp.ExistingNode(
            name=e.name, labels=dict(e.labels), allocatable=list(e.allocatable),
            used=list(e.used), taints=e.taints, resident=e.resident)
            for e in existing or []]
        return jcore.TPUSolver(catalog, provisioners).solve(
            list(pods), existing=existing, daemon_overhead=daemon_overhead)

    monkeypatch.setattr(jcore, "build_pack_inputs", build)
    monkeypatch.setattr(tpp, "assert_parity", solve)
    getattr(tpp, fixture)()
    assert rounds
    return rounds


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("fixture", LOCKSTEP_FIXTURES)
def test_step_lockstep_on_fixture_inputs(fixture, use_pallas, monkeypatch):
    for fields, dims in captured_rounds(fixture, monkeypatch):
        if use_pallas:
            assert jp.pallas_value_safe(fields["alloc_t"], fields["group_vec"])
        n_slots = dims[1]
        lockstep(fields, n_slots, initial_state(fields, n_slots), use_pallas,
                 tp.n_eff_of(fields["group_count"]))


def synthetic(seed: int, Pv: int, pods_cap: bool, big: bool,
              G=6, N=16, T=37, S=3, Ne=3):
    """Full-width (R = 11) inputs and a mid-solve state with the hazards of
    step 2: inactive rows with stale masks, an active row with no feasible
    option, a row landing exactly on (and one below) a multiple of the
    demand, shared origin rows, a zero-count group and one whose count is
    above any fill. With `big`, capacities and usage run from 2**24 up to
    INT_BIG."""
    rng = np.random.default_rng(seed)
    R = R_FULL
    lo, hi = (2**24, INT_BIG) if big else (0, 2**20)
    alloc = rng.integers(lo, hi + 1, size=(T, R))
    alloc[0] = INT_BIG if big else hi
    vec = rng.integers(1, 2**10, size=(G, R))
    vec[rng.random((G, R)) < 0.4] = 0
    vec[:, PODS_I] = 1
    if big:
        vec[1] = rng.integers(2**20, 2**24, size=R)
    count = rng.integers(1, 300, size=G)
    count[2] = 0
    count[3] = 10**6                                  # rem above the fill
    fields = {
        "alloc_t": alloc,
        "tiebreak": np.where(rng.random((T, S)) < 0.9,
                             rng.permutation(T * S).reshape(T, S), INT_BIG),
        "group_vec": vec,
        "group_count": count,
        "group_cap": np.where(rng.random(G) < 0.5, INT_BIG,
                              rng.integers(1, 40, size=G)),
        "group_feas": rng.random((G, Pv, T, S)) < 0.6,
        "group_newprov": rng.integers(-1, Pv, size=G),
        "overhead": rng.integers(0, 2**8, size=R),
        "ex_alloc": rng.integers(lo, hi + 1, size=(Ne, R)),
        "ex_used": rng.integers(0, 2**8, size=(Ne, R)),
        "ex_feas": rng.random((G, Ne)) < 0.5,
        "prov_overhead": rng.integers(0, 2**6, size=(Pv, R)) if Pv > 1
        else None,
        "prov_pods_cap": (rng.integers(0, 120, size=(Pv, T)) if pods_cap
                          else None),
        "ex_cap": None,
        "group_origin": np.array([0, 0, 2, 3, 3, 5][:G]),
        "res_sel": None,
        "res_mask": None,
    }
    fields = {k: None if v is None else
              np.asarray(v, bool if v.dtype == bool else np.int32)
              for k, v in fields.items()}
    state = initial_state(fields, N)
    n_open = N - 4
    state["n_open"] = np.int32(n_open)
    state["active"][:n_open] = rng.random(n_open) < 0.8
    state["nprov"][:n_open] = rng.integers(0, Pv, size=n_open)
    state["optmask"] = rng.random((N, T, S)) < 0.5   # stale where inactive
    state["optmask"][1] = False                      # no feasible option
    state["active"][1] = True
    used = rng.integers(0, alloc.min(axis=0) // 2 + 1, size=(N, R))
    v0 = np.maximum(vec[0], 1)
    used[2] = alloc[5] - (alloc[5] // v0) * v0       # exact multiples
    used[3] = np.minimum(used[2] + 1, alloc[5])      # one below
    state["active"][2:4] = True
    state["optmask"][2:4, 5] = True
    state["used"] = used.astype(np.int32)
    state["claim_placed"] = rng.integers(0, 3, size=(G, N)).astype(np.int32)
    state["ex_placed"] = rng.integers(0, 3, size=(G, Ne)).astype(np.int32)
    return fields, N, state


SYNTHETIC = [(seed, Pv, pods_cap, big, pallas)
             for seed, (Pv, pods_cap) in enumerate(
                 [(1, False), (1, True), (3, False), (3, True)])
             for big, pallas in ((False, False), (False, True),
                                 (True, False))]


@pytest.mark.parametrize("seed,Pv,pods_cap,big,use_pallas", SYNTHETIC)
def test_step_lockstep_on_synthetic_edge_states(seed, Pv, pods_cap, big,
                                                use_pallas):
    fields, n_slots, state = synthetic(seed, Pv, pods_cap, big)
    if use_pallas:
        assert jp.pallas_value_safe(fields["alloc_t"], fields["group_vec"],
                                    state["used"])
    steps = fields["group_vec"].shape[0]
    placed = lockstep(fields, n_slots, state, use_pallas, steps)
    assert placed > 0  # step 2 placed pods on open claims


# -- the plain version and the wrapper's CPU path ---------------------------------

def pre_refactor_step2(alloc_tm, vec, cap, gf, og, claim_placed, prov_pods_cap,
                       pods_i, used, optmask, nprov, active, rem):
    """Step 2 of the port's _step as it was before the redesign (K1 for the
    quotient, then tensor code), verbatim but for its argument names."""
    nprov0 = torch.clamp(nprov, min=0)
    feas_n = gf[0][None] if gf.shape[0] == 1 \
        else gf.index_select(0, nprov0)
    nodefeas = optmask & feas_n & active[:, None, None]
    q_nt = tq.quotient_nt(alloc_tm, used, vec)
    if prov_pods_cap is not None:
        cap_nt = prov_pods_cap.index_select(0, nprov0)
        q_extra = tq._pods_cap_quotient(
            cap_nt - used[:, pods_i][:, None], vec[pods_i])
        q_nt = torch.minimum(q_nt, q_extra)
    feas_t = nodefeas.any(dim=-1)
    qmax = torch.where(feas_t, q_nt, -1).amax(dim=-1)
    cap_n = cap - claim_placed.index_select(0, og)[0]
    fill_n = torch.clamp(torch.minimum(qmax, cap_n), 0, INT_BIG)
    m_n = oc._waterfall(rem, fill_n)
    new_used = used + m_n[:, None] * vec[None, :]
    shrunk = nodefeas & (q_nt >= m_n[:, None])[:, :, None]
    placed = m_n > 0
    optmask = torch.where(placed[:, None, None], shrunk, optmask)
    used = torch.where(placed[:, None], new_used, used)
    rem = rem - m_n.sum(dtype=torch.int32)
    return m_n, optmask, used, rem


def step2_args(seed: int, Pv: int, pods_cap: bool, big: bool, rem: int):
    """open_claim_fill's arguments (CPU tensors) for group 0 of a
    synthetic case."""
    fields, _, state = synthetic(seed, Pv, pods_cap, big)
    t = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
         {**fields, **state}.items() if v is not None}
    alloc_tm = tq.type_major(t["alloc_t"])
    return (alloc_tm, t["group_vec"][0], t["group_cap"][0], t["group_feas"][0],
            torch.zeros(1, dtype=torch.int64), t["claim_placed"],
            t.get("prov_pods_cap"), PODS_I, t["used"], t["optmask"],
            t["nprov"], t["active"], torch.tensor(rem, dtype=torch.int32))


STEP2_CASES = [(seed, Pv, pods_cap, big, rem)
               for seed, (Pv, pods_cap, big) in enumerate(
                   [(1, False, False), (1, True, True), (3, True, False),
                    (3, False, True)])
               for rem in (0, 7, 10**6)]


@pytest.mark.parametrize("seed,Pv,pods_cap,big,rem", STEP2_CASES)
def test_plain_version_is_the_pre_refactor_step2(seed, Pv, pods_cap, big,
                                                 rem):
    args = step2_args(seed, Pv, pods_cap, big, rem)
    want = pre_refactor_step2(*args)
    got = oc.open_claim_fill_reference(*args)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if rem == 0:
        assert not want[0].any()
    # the wrapper's CPU path: the same values, used and optmask in place
    used, optmask = args[8], args[9]
    LAUNCHES.reset()
    m, rem_out = oc.open_claim_fill(*args)
    assert torch.equal(m, want[0]) and torch.equal(rem_out, want[3])
    assert torch.equal(optmask, want[1]) and torch.equal(used, want[2])
    assert LAUNCHES.get(oc.KERNEL) == 0
    assert oc._fns is None  # the CUDA library was never built or loaded


# -- the identities the CUDA kernel relies on ------------------------------------

def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 with wraparound."""
    return ((x + 2**31) % 2**32) - 2**31


def fits_after(alloc_t, new_used, m, vec, pods_cap_nt, pods_i):
    """The apply launch's shrink test in plain torch: recover the old used
    row from the new one (wrapping), then compare availability with m * vec
    in 64 bits; no division. -> bool [N, T], for rows with 1 <= m <= INT_BIG."""
    a = alloc_t.long()
    v = vec.long()
    mm = m.long()[:, None]
    old = _wrap(new_used.long() - _wrap(mm * v[None, :]))          # [N, R]
    avail = _wrap(a[None, :, :] - old[:, None, :])                   # [N, T, R]
    ok = (avail >= mm[:, :, None] * v[None, None, :]) | (v <= 0)
    fit = ok.all(dim=-1)
    if pods_cap_nt is not None and int(v[pods_i]) > 0:
        ca = _wrap(pods_cap_nt.long() - old[:, pods_i][:, None])
        fit &= ca >= mm * v[pods_i]
    return fit


@pytest.mark.parametrize("seed", range(6))
def test_division_free_shrink_is_q_ge_m(seed):
    rng = np.random.default_rng(seed)
    N, T, R = 64, 40, 5
    if seed % 2:   # the whole int32 domain, so every subtraction may wrap
        alloc = rng.integers(-2**31, 2**31, size=(T, R))
        used = rng.integers(-2**31, 2**31, size=(N, R))
    else:          # the packer's domain, 0 .. INT_BIG
        alloc = rng.integers(2**29, INT_BIG + 1, size=(T, R))
        used = rng.integers(0, 2**29, size=(N, R))
        used[:, 0] = rng.integers(0, 100, size=N)   # the pods column
    vec = rng.integers(1, 2**(4 + 5 * (seed % 5)), size=R)
    vec[rng.random(R) < 0.3] = 0
    vec[0] = 1                                      # one pod per pod
    m = rng.integers(1, 64, size=N)
    m[:8] = INT_BIG
    m[8:16] = rng.integers(1, INT_BIG + 1, size=8)
    # boundary rows: availability exactly m * vec, and one below
    for i, n in enumerate(range(16, 24)):
        used[n] = alloc[i % T] - m[n] * vec + (i % 2)
    pods_cap = rng.integers(0, 200, size=(N, T))
    alloc_t, used_t, vec_t = (torch.from_numpy(x.astype(np.int32))
                              for x in (alloc, used, vec))
    m_t = torch.from_numpy(m.astype(np.int32))
    q = tq.quotient_nt_reference(alloc_t, used_t, vec_t)
    ppc = torch.from_numpy(pods_cap.astype(np.int32))
    q = torch.minimum(q, tq._pods_cap_quotient(ppc - used_t[:, 0][:, None],
                                               vec_t[0]))
    new_used = _wrap(used_t.long() + _wrap(m_t.long()[:, None]
                                           * vec_t.long()[None, :]))
    got = fits_after(alloc_t, new_used, m_t, vec_t, ppc, 0)
    want = q >= m_t[:, None]
    assert torch.equal(got, want)
    assert want.any() and (~want).any()


def magic(d: int) -> "tuple[int, int]":
    """Multiplier and shift of csrc/open_claim.cu's magic(): l = ceil(log2 d),
    M = ceil(2**(31 + l) / d)."""
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), 31 + l


def fdiv(x: np.ndarray, d: int) -> np.ndarray:
    """The kernel's fdiv(): (x * M) >> shift in 64-bit unsigned arithmetic."""
    M, s = magic(d)
    assert 0 < M < 2**32
    return ((x.astype(np.uint64) * np.uint64(M)) >> np.uint64(s)).astype(np.int64)


DIVISORS = sorted({1, 2, 3, 7, 5461, 1023, INT_BIG, 2**31 - 1}
                  | {2**k + e for k in range(1, 31) for e in (-1, 0, 1)
                     if 1 <= 2**k + e <= INT_BIG}
                  | set(np.random.default_rng(24).integers(1, 2**24, 40)
                        .tolist()))


def test_multiply_shift_division_is_exact():
    rng = np.random.default_rng(7)
    for d in DIVISORS:
        xs = [rng.integers(0, 2**31, size=200), np.array([0, 2**31 - 1])]
        for anchor in (0, 2**24, INT_BIG, 2**31 - 1):
            k = anchor // d
            for kk in (k - 1, k, k + 1):
                xs.append(kk * d + np.array([-1, 0, 1]))
        x = np.concatenate(xs).astype(np.int64)
        x = x[(x >= 0) & (x < 2**31)]
        np.testing.assert_array_equal(fdiv(x, d), x // d, err_msg=f"d={d}")


# -- the wrapper's checks ----------------------------------------------------------

@pytest.mark.parametrize("bad", ["dtype", "shape", "width", "row_major_alloc",
                                 "pods_column", "noncontig_optmask",
                                 "og_dtype", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = list(step2_args(0, 1, True, False, 5))
    if bad == "dtype":
        args[8] = args[8].long()                      # used
    elif bad == "shape":
        args[11] = args[11][:-1]                      # active
    elif bad == "width":
        R = tq.MAX_WIDTH + 1
        args[0] = tq.type_major(torch.zeros((args[9].shape[1], R),
                                            dtype=torch.int32))
        args[1] = torch.ones(R, dtype=torch.int32)
        args[8] = torch.zeros((args[8].shape[0], R), dtype=torch.int32)
    elif bad == "row_major_alloc":
        args[0] = args[0].contiguous()
    elif bad == "pods_column":
        args[7] = R_FULL
    elif bad == "noncontig_optmask":
        args[9] = args[9].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "og_dtype":
        args[4] = args[4].int()
    else:  # a device with no kernel must raise, never fall back
        args = [x.to("meta") if isinstance(x, torch.Tensor) else x
                for x in args]
    with pytest.raises((TypeError, ValueError)):
        oc.open_claim_fill(*args)
