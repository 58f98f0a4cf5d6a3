"""CLI entry point.

Copy of karpenter_tpu/__main__.py for the PyTorch port, which imports
nothing of the JAX package, edited; tests/test_torch_copies.py holds it to
the original's names and bounds the edit. `controller`, `solver-serve`,
`fleet-replica` and `chaos` take --device (cuda, the default, or cpu):
without a card and without --device cpu, boot raises. solver-serve,
controller --solver and fleet-replica need grpcio; without it solver-serve
and controller --solver exit 2 with a message naming it. solver-serve has
one readback (`--readback get`, the .cpu() of the flat buffer); `callback`
exits 2. solver-serve --distributed joins a torch.distributed process
group, one process per rank as torchrun launches them
(`torchrun --nproc-per-node=N python -m karpenter_tpu_torch solver-serve
--distributed`): rank 0 serves and drives the mesh, the other ranks follow
it. chaos writes its artifact under port_results/chaos by default
(git-ignored) and records nothing into a perf ledger.

Parity target: upstream cmd/controller/main.go:33-65 (operator boot)
plus the new solver sidecar from SURVEY.md §7.1.

  python -m karpenter_tpu_torch solver-serve --port 50151 [--device cpu]
      Host the solver gRPC service (the solver half) on the CUDA card.

  python -m karpenter_tpu_torch controller --simulate [--solver ADDR] [--device cpu]
      Run the full controller plane against the simulated cloud backend
      (SURVEY.md §2.3: "GCP/TPU provisioning APIs or simulated backend"),
      the in-process solver on the CUDA card (or on the CPU with
      --device cpu).

  python -m karpenter_tpu_torch version
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from . import __version__ as VERSION


def _wait_for_signal() -> None:
    """Block until SIGTERM/SIGINT. Explicit handlers: the environment's
    sitecustomize can leave default SIGINT delivery unreliable, and
    orchestrators terminate with SIGTERM."""
    import threading

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    while not stop.is_set():
        # poll rather than a bare wait(): signal handlers only run between
        # interpreter bytecodes, and Event.wait() without timeout parks in C
        stop.wait(0.2)


def _needs_grpcio(what: str) -> "int | None":
    """2, with the message on stderr, when grpcio cannot be imported."""
    from .solver.wire import require_grpcio

    try:
        require_grpcio(what)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    return None


def cmd_solver_serve(args) -> int:
    if args.readback == "callback":
        print("solver-serve --readback callback: karpenter_tpu_torch has no "
              "callback transport (its one readback is the .cpu() of the "
              "flat result buffer); use --readback get", file=sys.stderr)
        return 2
    rc = _needs_grpcio("solver-serve")
    if rc is not None:
        return rc
    ctx = None
    if args.distributed:
        # one process per rank, as torchrun launches them: rank 0 serves
        # gRPC and drives the mesh, the other ranks follow it
        from .parallel.multihost import (initialize_distributed,
                                         make_hybrid_mesh, mesh_description,
                                         shutdown_distributed)
        from .parallel.sharded import shared_context

        multi = initialize_distributed(args.coordinator, args.num_processes,
                                       args.process_id, device=args.device)
        print(f"distributed: {mesh_description(make_hybrid_mesh())}"
              if multi else "distributed requested but single-process",
              flush=True)
        if multi:
            ctx = shared_context(args.device)
            if not ctx.driving:
                ctx.follow()
                shutdown_distributed()
                return 0
    from .solver.service import SolverService, serve

    service = SolverService(trace_dir=args.trace_dir or None,
                            trace_every=args.trace_every, device=args.device)
    server, port, _service = serve(f"{args.host}:{args.port}",
                                   max_workers=args.workers, service=service)
    print(f"solver service listening on {args.host}:{port} "
          f"(device={service.device})", flush=True)
    try:
        _wait_for_signal()
    finally:
        server.stop(grace=1.0)
        if ctx is not None:
            ctx.close()
            shutdown_distributed()
    return 0


def cmd_fleet_replica(args) -> int:
    from .fleet.replica import run_replica_main

    return run_replica_main(args)


def cmd_controller(args) -> int:
    from .apis.nodetemplate import NodeTemplate
    from .apis.provisioner import Provisioner
    from .apis.settings import Settings
    from .fake.cloud import FakeCloud
    from .operator import Operator
    from .providers.instancetypes import generate_fleet_catalog

    if not args.simulate and not args.kubeconfig:
        print("need --simulate (in-process store) or --kubeconfig SERVER "
              "(real coordination plane; the cloud backend stays simulated — "
              "real TPU-fleet API wiring is environment-specific)",
              file=sys.stderr)
        return 2
    if args.solver:
        rc = _needs_grpcio("controller --solver")
        if rc is not None:
            return rc

    kube = None
    if args.kubeconfig:
        from .coordination.httpkube import HttpKubeStore

        kube = HttpKubeStore.from_kubeconfig(args.kubeconfig)
        kube.start()
        print(f"coordination plane: {kube.server} "
              f"({sum(len(kube.list(k)) for k in kube.KINDS)} objects synced)",
              flush=True)

    catalog = generate_fleet_catalog()
    settings = Settings(cluster_name=args.cluster_name,
                        cluster_endpoint="https://simulated")
    solver_factory = None
    if args.solver:
        from .solver.client import RemoteSolver

        # late-binding hub reference: the factory only runs during
        # reconcile cycles, after the Operator (and its ResilienceHub)
        # exists — so the remote solver edge shares the solver breaker
        # and retry budget with every other borrower
        _op_cell: "list" = []

        def solver_factory(cat, provs):
            if not _op_cell:
                # must not happen in the current boot order (the cell is
                # filled right after Operator construction); if a future
                # refactor constructs solvers eagerly, losing the breaker/
                # budget protection silently would be far worse than a log
                logging.getLogger("karpenter.cli").warning(
                    "solver factory ran before the Operator was "
                    "constructed: remote solver edge has NO resilience "
                    "hub (no breaker, no retry budget)")
            return RemoteSolver(
                cat, provs, target=args.solver,
                resilience=_op_cell[0].resilience if _op_cell else None)
    cloud = FakeCloud(catalog)
    if args.state and os.path.exists(args.state):
        cloud.load_state(args.state)
        print(f"loaded simulated account from {args.state} "
              f"({len(cloud.instances)} instances)", flush=True)
    # reference templates discover infra by cluster tag; tag the simulated
    # subnets/SGs so `karpenter.sh/discovery: <cluster>` selectors resolve
    for s in cloud.subnets:
        s.tags.setdefault("karpenter.sh/discovery", args.cluster_name)
    for g in cloud.security_groups:
        g.tags.setdefault("karpenter.sh/discovery", args.cluster_name)
    # each listener disables independently with -1; the plane exists if ANY
    # port is enabled
    serve_http = any(p >= 0 for p in (args.metrics_port, args.health_port,
                                      args.webhook_port))
    op = Operator(cloud, settings, catalog, kube=kube,
                  solver_factory=solver_factory,
                  solver_target=args.solver,
                  leader_elect=bool(args.leader_elect),
                  serve_http=serve_http,
                  metrics_port=args.metrics_port,
                  health_port=args.health_port,
                  webhook_port=args.webhook_port,
                  webhook_tls=(args.webhook_tls_cert, args.webhook_tls_key),
                  device=args.device)
    if args.solver:
        _op_cell.append(op)
    if args.apply:
        # reference-compatible manifests (Provisioner / AWSNodeTemplate /
        # Deployment / Pod / PDB YAML) drive the plane as-is
        from .apis.yaml_compat import load_files

        loaded = load_files(*args.apply, env={"CLUSTER_NAME": args.cluster_name})
        for t in loaded.templates:
            op.kube.create("nodetemplates", t.name, t)
        for p in loaded.provisioners:
            op.kube.create("provisioners", p.name, p)
        for pdb in loaded.pdbs:
            op.kube.create("pdbs", pdb.name, pdb)  # flows to cluster via watch
        for pod in loaded.pods:
            op.kube.create("pods", pod.name, pod)
        print(f"applied {len(loaded.templates)} templates, "
              f"{len(loaded.provisioners)} provisioners, "
              f"{len(loaded.pods)} pods, {len(loaded.pdbs)} pdbs", flush=True)
    elif not args.kubeconfig:
        # simulate-only default seeding; against a real coordination plane
        # the cluster's own objects are authoritative
        # (kube.create runs the admission webhooks: defaulting + validation)
        op.kube.create("nodetemplates", "default", NodeTemplate(
            name="default",
            subnet_selector={"id": "subnet-zone-1a,subnet-zone-1b,subnet-zone-1c"},
            security_group_selector={"id": "sg-default"}))
        op.kube.create("provisioners", "default",
                       Provisioner(name="default", provider_ref="default"))
    op.start()
    print(f"controller running (cluster={args.cluster_name}, "
          f"solver={'grpc:' + args.solver if args.solver else 'in-process'}, "
          f"device={op.device}); Ctrl-C to stop", flush=True)
    try:
        _wait_for_signal()
    finally:
        op.stop()
        if args.state:
            cloud.save_state(args.state)
            print(f"saved simulated account to {args.state}", flush=True)
    return 0


def cmd_cleanup(args) -> int:
    """Sweep leaked capacity: cloud instances with no coordination-plane
    owner and stale hash-named launch templates. The operational analogue of
    the reference's test-account cleanup tooling (reference test/ 'cleanup'
    + sweeper scripts) pointed at the framework's own GC logic — one
    explicit pass, printed, exit 0 (reconcile-once semantics; the running
    controller does this continuously)."""
    from .apis.settings import Settings
    from .cloudprovider import CloudProvider
    from .controllers.garbagecollection import GarbageCollectionController
    from .fake.cloud import FakeCloud
    from .fake.kube import KubeStore
    from .providers.instancetypes import generate_fleet_catalog

    if not args.state:
        # the cloud backend in this build is process-local (simulated); a
        # cleanup pointed at a real apiserver would compare its machines
        # against an EMPTY fresh cloud and retire healthy capacity. The
        # running controller's own GC loop is the live-cluster sweeper;
        # this command sweeps a PERSISTED simulated account (--state FILE,
        # the file `controller --simulate --state FILE` maintains).
        print("cleanup needs --state FILE (the persisted simulated account "
              "written by `controller --simulate --state FILE`); for a live "
              "cluster the controller's GC loop is the sweeper",
              file=sys.stderr)
        return 2
    if not os.path.exists(args.state):
        # a typo'd path must not silently sweep (and then persist) a fresh
        # empty account — the account file is the contract
        print(f"state file not found: {args.state}", file=sys.stderr)
        return 2
    kube = KubeStore()

    catalog = generate_fleet_catalog()
    settings = Settings(cluster_name=args.cluster_name,
                        cluster_endpoint="https://simulated")
    cloud = FakeCloud(catalog)
    cloud.load_state(args.state)
    n_before = len([i for i in cloud.instances.values()
                    if i.state == "running"])
    provider = CloudProvider(cloud, settings, catalog)
    gc = GarbageCollectionController(kube, provider)
    # force-expire the grace windows when asked: a cleanup sweep of a dead
    # test account wants everything, not just old leaks
    if args.all:
        gc.grace_seconds = 0
    reaped = gc.reconcile_once()
    stale_lts = provider.launch_templates.delete_all() \
        if args.launch_templates else 0
    cloud.save_state(args.state)
    print(f"account {args.state}: {n_before} running instance(s); "
          f"reaped {len(reaped)} leaked, {stale_lts} launch template(s)")
    for r in reaped:
        print(f"  {r}")
    return 0


def _tail_delta(lines: "list[str]", last_printed: "str | None"
                ) -> "tuple[list[str], str | None]":
    """New lines since `last_printed` in a SLIDING log window.

    The cursor is the last printed line's content, matched from the end:
    an index cursor goes permanently silent once the window fills (every
    poll returns exactly N lines), and if the marker rotated out entirely
    the whole window is new."""
    start = 0
    if last_printed is not None:
        for i in range(len(lines) - 1, -1, -1):
            if lines[i] == last_printed:
                start = i + 1
                break
    new = lines[start:]
    return new, (lines[-1] if lines else last_printed)


def cmd_logs(args) -> int:
    """Fetch recent controller logs from a live controller's /logz endpoint
    (utils/logring ring buffer) — the hermetic analogue of the reference's
    log-fetch tool (test/cmd/logs/main.go: controller logs for a test run
    without shelling into the pod). --follow polls for new lines."""
    import time as _time
    import urllib.request

    base = args.endpoint.rstrip("/")
    last_printed = None  # content cursor: /logz serves a SLIDING window,
    # so an index into it would go silent once the window fills
    while True:
        try:
            with urllib.request.urlopen(f"{base}/logz?n={args.lines}",
                                        timeout=10) as r:
                lines = [ln for ln in r.read().decode().splitlines() if ln]
        except OSError as e:
            if not args.follow:
                print(f"cannot reach {base}/logz: {e}", file=sys.stderr)
                return 1
            # tail -f survives controller restarts: retry, don't abort
            print(f"# retrying ({e})", file=sys.stderr)
            _time.sleep(args.interval)
            continue
        if not args.follow:
            for ln in lines:
                print(ln)
            return 0
        new, last_printed = _tail_delta(lines, last_printed)
        for ln in new:
            print(ln, flush=True)
        _time.sleep(args.interval)


def _fetch_json(url: str):
    import json as _json
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return _json.loads(r.read().decode())


def cmd_statusz(args) -> int:
    """Pretty-print a live controller's /debug/statusz snapshot (the
    introspection plane's one-consistent-view; metrics listener)."""
    import json as _json

    base = args.endpoint.rstrip("/")
    try:
        snap = _fetch_json(f"{base}/debug/statusz")
    except OSError as e:
        print(f"cannot reach {base}/debug/statusz: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(snap, indent=2, sort_keys=True, default=str))
    return 0


def cmd_diagnose(args) -> int:
    """Fetch a diagnostics bundle from a live controller (/debug/bundle:
    statusz ring + logs + traces + events + metrics text) and write it to
    --out, or stdout when no path is given. The offline counterpart is the
    bundle the flight recorder auto-writes on reconcile exceptions,
    watchdog deadman firings, and chaos invariant breaches."""
    import json as _json

    base = args.endpoint.rstrip("/")
    try:
        bundle = _fetch_json(f"{base}/debug/bundle")
    except OSError as e:
        print(f"cannot reach {base}/debug/bundle: {e}", file=sys.stderr)
        return 1
    text = _json.dumps(bundle, indent=2, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        ring = bundle.get("statusz_ring") or []
        trig = bundle.get("trigger") or {}
        print(f"bundle written to {args.out} "
              f"(trigger={trig.get('reason', '?')}, "
              f"snapshots={len(ring)})")
    else:
        print(text)
    return 0


def cmd_events(args) -> int:
    """Fetch the recent event ring from a live controller's /eventz
    endpoint (health listener) — `kubectl get events` shaped triage,
    mirroring the `logs` + /logz pair."""
    import json as _json

    base = args.endpoint.rstrip("/")
    try:
        payload = _fetch_json(f"{base}/eventz?n={args.count}")
    except OSError as e:
        print(f"cannot reach {base}/eventz: {e}", file=sys.stderr)
        return 1
    events = payload.get("events", [])
    if args.json:
        print(_json.dumps(events, indent=2, default=str))
        return 0
    for e in events:
        print(f"{e.get('ts', 0):.3f} {e.get('kind', ''):<7} "
              f"{e.get('reason', ''):<24} {e.get('object', ''):<32} "
              f"{e.get('message', '')}")
    if not events:
        print("no events recorded")
    return 0


def cmd_explain(args) -> int:
    """Answer WHY for a pod from a live controller's decision-provenance
    ring (/debug/decisions, the explain plane): the DecisionRecord that
    assigned the pod, or its per-dimension unschedulability attribution
    with the ranked reason summary. With no pod, prints the decision
    index (or one full record with --id)."""
    import json as _json
    from urllib.error import HTTPError

    base = args.endpoint.rstrip("/")
    if args.pod:
        url = f"{base}/debug/decisions?pod={args.pod}"
    elif args.id:
        url = f"{base}/debug/decisions?id={args.id}"
    else:
        url = f"{base}/debug/decisions?limit={args.limit}"
    try:
        payload = _fetch_json(url)
    except HTTPError as e:
        try:
            body = e.read().decode().strip()
        except Exception:  # noqa: BLE001 — CLI boundary
            body = ""
        print(body or f"{url}: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"cannot reach {url}: {e}", file=sys.stderr)
        return 1
    if args.json or not args.pod:
        print(_json.dumps(payload, indent=2, sort_keys=True, default=str))
        return 0
    # human verdict for ONE pod: its assignment, or the ranked attribution
    rid = payload.get("id", "?")
    for a in payload.get("assignments", ()):
        if args.pod in (a.get("pods") or ()):
            print(f"pod {args.pod}: ASSIGNED by decision {rid} -> "
                  f"{a.get('itype')}/{a.get('zone')}/"
                  f"{a.get('capacity_type')} "
                  f"(provisioner {a.get('provisioner')}, "
                  f"${a.get('price', 0)}/h)")
            return 0
    for u in payload.get("unassigned", ()):
        if u.get("pod") == args.pod:
            print(f"pod {args.pod}: UNSCHEDULABLE (decision {rid})")
            print(f"  reason:  {u.get('reason')}")
            print(f"  summary: {u.get('summary')}")
            print(f"  ranked:  {', '.join(u.get('ranked') or ())}")
            nearest = u.get("nearest")
            if nearest:
                print(f"  nearest fit: short by {nearest.get('display')}")
            if not u.get("parity", True):
                print("  WARNING: attribution disagrees with the scalar "
                      "oracle (reason parity audit failed)")
            return 0
    print(f"pod {args.pod}: mentioned by decision {rid} "
          f"(kind {payload.get('kind')})")
    return 0


def cmd_sync(args) -> int:
    """Make a coordination plane match a manifest fixture set (apply +
    optional prune) — the hermetic analogue of the reference's GitOps
    test-cluster sync (test/cmd/sync-cluster; the synced path is
    test/infrastructure/clusters/test-infra)."""
    from .apis.yaml_compat import load_files
    from .coordination.sync import sync_manifests

    paths = []
    for p in args.manifests:
        if os.path.isdir(p):
            # recursive: fixture trees nest by kind (provisioners/,
            # workloads/ — pruning against a partial load would DELETE the
            # nested objects as "absent")
            for root, _dirs, files in sorted(os.walk(p)):
                paths.extend(sorted(
                    os.path.join(root, f) for f in files
                    if f.endswith((".yaml", ".yml"))))
        else:
            paths.append(p)
    if not paths:
        print("no manifests found", file=sys.stderr)
        return 2
    loaded = load_files(*paths, env={"CLUSTER_NAME": args.cluster_name})
    from .coordination.httpkube import HttpKubeStore

    kube = HttpKubeStore.from_kubeconfig(args.kubeconfig)
    kube.start()
    try:
        counts = sync_manifests(kube, loaded, prune=args.prune)
    finally:
        kube.stop()
    print(f"synced {len(paths)} file(s): {counts['created']} created, "
          f"{counts['updated']} updated, {counts['pruned']} pruned, "
          f"{counts['unchanged']} unchanged")
    return 0


def cmd_apiserver(args) -> int:
    """Boot the mini apiserver standalone and write a kubeconfig for it:
    the offline substrate of the getting-started walkthrough (the real
    alternative is envtest via hack/fetch_envtest.sh). Serves until ^C."""
    import time as _time

    from .fake.apiserver import serve

    srv, port, _state = serve(port=args.port)
    kubeconfig = {
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "mini",
                      "cluster": {"server": f"http://127.0.0.1:{port}"}}],
        "users": [{"name": "mini", "user": {}}],
        "contexts": [{"name": "mini",
                      "context": {"cluster": "mini", "user": "mini"}}],
        "current-context": "mini",
    }
    import json as _json

    with open(args.write_kubeconfig, "w") as f:
        _json.dump(kubeconfig, f, indent=1)  # kubeconfigs are YAML, but
        # JSON is a YAML subset — every loader (ours + kubectl) accepts it
    print(f"mini apiserver listening on 127.0.0.1:{port}")
    print(f"kubeconfig written to {args.write_kubeconfig}")
    print("next: python -m karpenter_tpu_torch controller --simulate "
          f"--kubeconfig {args.write_kubeconfig} --apply examples/quickstart.yaml")
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


def cmd_get(args) -> int:
    """kubectl-get analogue over the coordination plane: list a kind with
    the columns an operator checks first (the walkthrough's 'watch the
    nodes appear' step, no kubectl needed)."""
    from .coordination.httpkube import HttpKubeStore

    kube = HttpKubeStore.from_kubeconfig(args.kubeconfig)
    try:
        # one-shot LIST seed (reads come from the informer cache); no
        # watch threads needed for a point-in-time get
        kube._relist(args.kind)
        objs = kube.list(args.kind)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not objs:
        print(f"no {args.kind} found")
        return 0
    try:
        for o in objs:
            name = getattr(o, "name", None) or getattr(
                o, "metadata", {}).get("name", "?")
            cols = [str(name)]
            labels = dict(getattr(o, "labels", ()) or {})
            if args.kind == "nodes":
                from .apis import wellknown as wk

                cols += [labels.get(wk.LABEL_INSTANCE_TYPE, ""),
                         labels.get(wk.LABEL_ZONE, ""),
                         labels.get(wk.LABEL_CAPACITY_TYPE, "")]
            elif args.kind == "pods":
                cols.append(getattr(o, "node_name", "") or "<pending>")
            print("  ".join(c for c in cols if c != ""))
    except BrokenPipeError:  # | head closed stdout mid-listing
        pass
    return 0


def cmd_chaos(args) -> int:
    """Seeded chaos sweep: drive faulted scenarios to convergence, check
    the cross-layer invariants, and write a replay artifact."""
    from .chaos import ChaosRunner

    runner = ChaosRunner(seed=args.seed, scenarios=args.scenarios,
                         intensity=args.intensity,
                         out_dir=args.out_dir or None,
                         burst=args.burst, crash=args.crash,
                         storm=args.storm, partition=args.partition,
                         spot_storm=args.spot_storm,
                         spot_storm_nodes=args.spot_nodes,
                         spot_storm_reclaims=args.spot_reclaims,
                         device=args.device)
    artifact = runner.run()
    for s in artifact["scenarios"]:
        verdict = "PASS" if s["passed"] else "FAIL"
        if args.partition:
            if s["drill"] == "partition":
                t = s["totals"]
                print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                      f"{s['drill']} remap={s['remap_fraction']} "
                      f"(~{s['remap_expected']}) served={t['served']} "
                      f"shed={t['shed_quarantine']} "
                      f"cold_remaps={t['cold_remaps']} "
                      f"epoch={s['membership_epoch']}")
            else:
                print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                      f"{s['drill']} epoch={s['epoch']}")
        elif args.spot_storm:
            if s["drill"] == "spot-storm":
                print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                      f"{s['drill']} nodes={s['fleet']['nodes']} "
                      f"reclaims={s['storm']['reclaims_delivered']} "
                      f"restore={s['storm']['restore_cycles']}"
                      f"/{s['storm']['restore_bound']} "
                      f"rebalances={len(s['rebalance']['ledger'])}")
            elif s["drill"] == "spot-wrong-forecast":
                print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                      f"{s['drill']} reclaims={s['reclaims_delivered']} "
                      f"restore={s['restore_cycles']} "
                      f"post_clear_launches={s['post_clear_launches']}")
            else:
                print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                      f"{s['drill']} decisions_identical="
                      f"{s['decisions_identical']}")
        elif args.storm:
            t = s["totals"]
            print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                  f"tenants={s['tenants']} submitted={t['submitted']} "
                  f"served={t['served']} "
                  f"shed={t['shed_admission']}+{t['shed_queue']} "
                  f"mega_solves={s['mega_solves']} "
                  f"drain={s['drain_ticks']}")
        elif args.crash:
            print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                  f"{s['drill']} crash_cycle={s.get('crash_cycle', '-')} "
                  f"replayed={len(s['replay'])} nodes={s['final_nodes']} "
                  f"settle={s['settle_cycles']}")
        else:
            print(f"seed={s['seed']} scenario={s['scenario']} {verdict} "
                  f"kinds={len(s['fired_kinds'])} "
                  f"layers={','.join(s['layers'])} "
                  f"nodes={s['final_nodes']} settle={s['settle_cycles']}")
        for v in s["violations"]:
            print(f"  VIOLATION [{v['invariant']}] {v['message']}")
    if artifact.get("artifact_path"):
        print(f"artifact: {artifact['artifact_path']}")
    for bundle in artifact.get("bundles", []):
        print(f"diagnostics bundle: {bundle} "
              f"(inspect: python -m karpenter_tpu_torch diagnose, or read "
              f"the "
              f"JSON directly)")
    if not artifact["passed"]:
        print(f"REPRODUCE: python -m karpenter_tpu_torch chaos "
              f"--seed {args.seed} --device {args.device} "
              f"--scenarios {args.scenarios}"
              f"{' --burst' if args.burst else ''}"
              f"{' --crash' if args.crash else ''}"
              f"{' --storm' if args.storm else ''}"
              f"{' --partition' if args.partition else ''}"
              f"{' --spot-storm' if args.spot_storm else ''}")
        return 1
    if args.spot_storm:
        key = artifact["key_numbers"]
        print(f"chaos: spot storm passed — {key['fleet_nodes']} nodes, "
              f"{key['storm_reclaims']} simultaneous reclaim(s), capacity "
              f"restored in {key['restore_cycles']} cycle(s) (bound "
              f"{artifact['restore_bound_cycles']}), "
              f"{key['proactive_rebalances']} proactive rebalance(s), "
              f"cost ${key['hourly_cost_before']}/h -> "
              f"${key['hourly_cost_after']}/h "
              f"({artifact['duration_s']}s)")
        return 0
    if args.partition:
        key = artifact["key_numbers"]
        print(f"chaos: partition drill passed — remap fraction "
              f"{key['remap_fraction']} (expected ~"
              f"{key['remap_expected']}), recovery to green in "
              f"{key['recovery_to_green_cycles']} cycle(s), "
              f"{key['warm_state_losses']} warm-state loss(es), "
              f"{key['poisons_quarantined']} poison(s) quarantined "
              f"({artifact['duration_s']}s)")
    elif args.storm:
        print(f"chaos: tenant storm passed — {artifact['scenario_count']} "
              f"scenario(s), {artifact['tenants']} tenants each, fairness "
              f"bound held ({artifact['duration_s']}s)")
    elif args.crash:
        print(f"chaos: crash drill passed — {artifact['scenario_count']} "
              f"scenario(s) across {len(artifact['crashpoints'])} "
              f"crashpoint(s) + leader failover "
              f"({artifact['duration_s']}s)")
    else:
        print(f"chaos: {artifact['scenario_count']} scenario(s) passed, "
              f"{len(artifact['fault_kinds'])} fault kinds across "
              f"{len(artifact['layers'])} layers "
              f"({artifact['duration_s']}s)")
    return 0



def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    parser = argparse.ArgumentParser(prog="karpenter_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_serve = sub.add_parser("solver-serve", help="host the solver gRPC service")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=50151)
    p_serve.add_argument("--workers", type=int, default=4)
    p_serve.add_argument("--distributed", action="store_true",
                         help="join a torch.distributed mesh (launch one "
                              "process per rank with torchrun)")
    p_serve.add_argument("--coordinator", default=None,
                         help="coordinator address host:port or an init "
                              "method URL (defaults from torchrun's env)")
    p_serve.add_argument("--num-processes", type=int, default=None)
    p_serve.add_argument("--process-id", type=int, default=None)
    p_serve.add_argument("--trace-dir", default="",
                         help="capture a profiler trace of every "
                              "--trace-every'th solve into this directory")
    p_serve.add_argument("--trace-every", type=int, default=100)
    p_serve.add_argument(
        "--readback", choices=("get", "callback"),
        default=os.environ.get("KARPENTER_TPU_READBACK", "get"),
        help="device->host readback transport: the port has one, the "
             "literal read (get); callback exits 2")
    p_serve.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                         help="where the solves run: the CUDA card "
                              "(default; boot raises without one) or the "
                              "CPU")
    p_serve.set_defaults(fn=cmd_solver_serve)

    p_replica = sub.add_parser(
        "fleet-replica",
        help="host ONE fleet solver replica (gRPC + debug listeners on "
             "ephemeral ports, announced via a rendezvous directory) — "
             "the subprocess half of the real-replica fleet drill")
    p_replica.add_argument("--name", required=True,
                           help="replica name (rendezvous + fleetz row)")
    p_replica.add_argument("--rendezvous", required=True,
                           help="directory to publish <name>.json with "
                                "the resolved addresses into")
    p_replica.add_argument("--grpc-port", type=int, default=0,
                           help="solve wire port (0 = ephemeral)")
    p_replica.add_argument("--debug-port", type=int, default=0,
                           help="metrics/debug listener port (0 = "
                                "ephemeral; the ACTUAL port is published "
                                "through the rendezvous record)")
    p_replica.add_argument("--max-wave", type=int, default=16)
    p_replica.add_argument("--tick-interval", type=float, default=0.01)
    p_replica.add_argument("--starvation-bound", type=int, default=4,
                           help="fairness contract the frontend declares "
                                "(and the drill audits) in ticks; size "
                                "for the offered closed-loop depth")
    p_replica.add_argument("--device", choices=("cuda", "cpu"),
                           default="cuda",
                           help="where the replica's solves run: the CUDA "
                                "card (default; boot raises without one) "
                                "or the CPU")
    p_replica.set_defaults(fn=cmd_fleet_replica)

    p_ctrl = sub.add_parser("controller", help="run the controller plane")
    p_ctrl.add_argument("--simulate", action="store_true",
                        help="use the simulated cloud backend")
    p_ctrl.add_argument("--solver", default="",
                        help="gRPC solver sidecar address (host:port)")
    p_ctrl.add_argument("--cluster-name", default="simulated")
    p_ctrl.add_argument("--state", default="",
                        help="persist the simulated account (instances, "
                             "launch templates) to this JSON file: loaded at "
                             "boot, saved on shutdown — lets `cleanup "
                             "--state` sweep the same account")
    p_ctrl.add_argument("--apply", action="append", default=[],
                        metavar="FILE",
                        help="manifest file(s) to apply at boot "
                             "(reference-compatible Karpenter YAML)")
    p_ctrl.add_argument("--kubeconfig", default="",
                        help="run against a real apiserver (kubeconfig path); "
                             "see karpenter_tpu_torch/fake/apiserver.py for the "
                             "in-repo mini apiserver")
    p_ctrl.add_argument("--leader-elect", action="store_true",
                        help="lease-based leader election (HA replicas)")
    p_ctrl.add_argument("--metrics-port", type=int, default=8080,
                        help="prometheus metrics port (-1 disables serving)")
    p_ctrl.add_argument("--health-port", type=int, default=8081,
                        help="healthz/livez/readyz port (-1 disables)")
    p_ctrl.add_argument("--webhook-port", type=int, default=8443,
                        help="AdmissionReview validating-webhook port "
                             "(-1 disables)")
    p_ctrl.add_argument("--webhook-tls-cert", default="",
                        help="TLS cert for the webhook listener (apiserver "
                             "dials webhooks over TLS; cert-manager mounts it)")
    p_ctrl.add_argument("--webhook-tls-key", default="")
    p_ctrl.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the solve and the consolidation sweep "
                             "run: the CUDA card (default; boot raises "
                             "without one) or the CPU")
    p_ctrl.set_defaults(fn=cmd_controller)

    p_clean = sub.add_parser(
        "cleanup", help="one-shot sweep of leaked instances/launch templates "
                        "in a persisted simulated account")
    p_clean.add_argument("--state", default="",
                         help="account state file (see controller --state)")
    p_clean.add_argument("--cluster-name", default="simulated")
    p_clean.add_argument("--all", action="store_true",
                         help="ignore grace windows (dead-account sweep)")
    p_clean.add_argument("--launch-templates", action="store_true",
                         help="also delete all cluster-owned launch templates")
    p_clean.set_defaults(fn=cmd_cleanup)

    p_logs = sub.add_parser(
        "logs", help="fetch recent logs from a live controller (/logz)")
    p_logs.add_argument("--endpoint", default="http://127.0.0.1:8081",
                        help="controller health listener base URL")
    p_logs.add_argument("-n", "--lines", type=int, default=500)
    p_logs.add_argument("-f", "--follow", action="store_true",
                        help="poll for new lines")
    p_logs.add_argument("--interval", type=float, default=2.0)
    p_logs.set_defaults(fn=cmd_logs)

    p_statusz = sub.add_parser(
        "statusz", help="pretty-print a live controller's /debug/statusz "
                        "snapshot (introspection plane)")
    p_statusz.add_argument("--endpoint", default="http://127.0.0.1:8080",
                           help="controller metrics listener base URL")
    p_statusz.set_defaults(fn=cmd_statusz)

    p_diag = sub.add_parser(
        "diagnose", help="fetch a diagnostics bundle from a live controller "
                         "(/debug/bundle) — statusz ring + logs + traces + "
                         "events + metrics")
    p_diag.add_argument("--endpoint", default="http://127.0.0.1:8080",
                        help="controller metrics listener base URL")
    p_diag.add_argument("-o", "--out", default="",
                        help="write the bundle to this file (default: stdout)")
    p_diag.set_defaults(fn=cmd_diagnose)

    p_events = sub.add_parser(
        "events", help="fetch recent events from a live controller (/eventz)")
    p_events.add_argument("--endpoint", default="http://127.0.0.1:8081",
                          help="controller health listener base URL")
    p_events.add_argument("-n", "--count", type=int, default=100)
    p_events.add_argument("--json", action="store_true",
                          help="raw JSON instead of columns")
    p_events.set_defaults(fn=cmd_events)

    p_explain = sub.add_parser(
        "explain", help="answer WHY for a pod from a live controller's "
                        "decision-provenance ring (/debug/decisions)")
    p_explain.add_argument("pod", nargs="?", default="",
                           help="pod name to resolve (omit to list the "
                                "decision index)")
    p_explain.add_argument("--id", default="",
                           help="fetch one decision record by id instead")
    p_explain.add_argument("--endpoint", default="http://127.0.0.1:8080",
                           help="controller metrics listener base URL")
    p_explain.add_argument("--limit", type=int, default=20,
                           help="index size when listing")
    p_explain.add_argument("--json", action="store_true",
                           help="raw JSON instead of the human verdict")
    p_explain.set_defaults(fn=cmd_explain)

    p_sync = sub.add_parser(
        "sync", help="apply (and optionally prune to) a manifest fixture "
                     "set against a coordination plane")
    p_sync.add_argument("manifests", nargs="+",
                        help="YAML files or directories")
    p_sync.add_argument("--kubeconfig", required=True,
                        help="target apiserver kubeconfig")
    p_sync.add_argument("--cluster-name", default="simulated")
    p_sync.add_argument("--prune", action="store_true",
                        help="delete managed-kind objects absent from the "
                             "fixture (pods are never pruned)")
    p_sync.set_defaults(fn=cmd_sync)

    p_api = sub.add_parser(
        "apiserver", help="boot the offline mini apiserver + kubeconfig "
                          "(getting-started walkthrough substrate)")
    p_api.add_argument("--port", type=int, default=8001)
    p_api.add_argument("--write-kubeconfig", default="/tmp/karpenter-tpu-kubeconfig")
    p_api.set_defaults(fn=cmd_apiserver)

    p_get = sub.add_parser("get", help="list objects from the coordination "
                                       "plane (kubectl-get analogue)")
    p_get.add_argument("kind", help="nodes, pods, machines, provisioners, ...")
    p_get.add_argument("--kubeconfig", required=True)
    p_get.set_defaults(fn=cmd_get)

    p_chaos = sub.add_parser(
        "chaos", help="seeded deterministic fault-injection sweep with "
                      "cross-layer invariant checks (docs/designs/chaos.md)")
    p_chaos.add_argument("--seed", type=int, default=0,
                         help="plan seed; the same seed replays the identical "
                              "fault sequence and verdict")
    p_chaos.add_argument("--scenarios", type=int, default=1,
                         help="scenarios derived from the seed (0..K-1)")
    p_chaos.add_argument("--intensity", type=float, default=1.0,
                         help="fault-count multiplier per site")
    p_chaos.add_argument("--out-dir", default="port_results/chaos",
                         help="replay-artifact directory ('' disables)")
    p_chaos.add_argument("--burst", action="store_true",
                         help="run the fixed resilience-plane burst schedule "
                              "(dense cloud-5xx + solver crashes) instead of "
                              "the sampled plan")
    p_chaos.add_argument("--crash", action="store_true",
                         help="run the crash-restart recovery drill: one "
                              "scenario per named crashpoint plus a fenced "
                              "leader-failover scenario "
                              "(docs/designs/recovery.md)")
    p_chaos.add_argument("--storm", action="store_true",
                         help="run the multi-tenant fleet storm drill: a hot "
                              "tenant bursting against light tenants through "
                              "the fleet frontend, asserting the "
                              "fairness-never-starves invariant "
                              "(docs/designs/fleet.md)")
    p_chaos.add_argument("--partition", action="store_true",
                         help="run the fleet membership/failover drill: "
                              "replica kill, blackhole partition, gray "
                              "slow-replica, poison request and rejoin, "
                              "auditing remap blast radius, "
                              "completes-or-sheds, quarantine cascade "
                              "bounds and epoch monotonicity")
    p_chaos.add_argument("--spot-storm", action="store_true",
                         help="spot reclaim-storm drill: 10k-node fleet, "
                              "2000 simultaneous reclaims in one tick, "
                              "forecaster-was-wrong adversarial schedule, "
                              "and the strict-noop decision-parity window")
    p_chaos.add_argument("--spot-nodes", type=int, default=None,
                         help="override the spot-storm fleet size "
                              "(default 10000)")
    p_chaos.add_argument("--spot-reclaims", type=int, default=None,
                         help="override the simultaneous reclaim count "
                              "(default 2000)")
    p_chaos.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                         help="where the drills' operators solve and sweep: "
                              "the CUDA card (default; raises without one) "
                              "or the CPU")
    p_chaos.set_defaults(fn=cmd_chaos)

    p_ver = sub.add_parser("version")
    p_ver.set_defaults(fn=lambda a: print(VERSION) or 0)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
