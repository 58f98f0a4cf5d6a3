"""Operator HTTP serving plane: metrics, health, admission webhook.

Copy of karpenter_tpu/serving.py for the PyTorch port, which imports nothing
of the JAX package, edited; tests/test_torch_copies.py holds it to the
original's names and bounds the edit.

Parity target: the reference serves Prometheus metrics on :8080, health
probes on :8081 and webhooks on :8443 (charts/karpenter/values.yaml:134-142,
probed by the deployment's liveness/readiness checks); the knative webhook
half answers AdmissionReview requests (pkg/webhooks/webhooks.go:33-63).

Three tiny stdlib servers (one per port so the chart's port wiring maps
1:1). The webhook endpoint implements the VALIDATING half of
admission.k8s.io/v1 AdmissionReview: objects parse through the same serde
the coordination plane uses, then run the in-process Webhooks pipeline —
deny returns allowed=false with the message; requests without a readable
body FAIL CLOSED. The apiserver always dials webhooks over TLS, so the
webhook listener wraps its socket when a cert/key pair is provided
(cert-manager mounts them in the deployment; plaintext only suits the mini
apiserver / local drives). Defaulting stays at the store boundary
(HttpKubeStore/KubeStore apply it before writes); mutating webhooks would
additionally need JSONPatch plumbing.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

log = logging.getLogger("karpenter.serving")

# /debug/traces ?limit= ceiling: the TRACER ring holds ~200 traces, so a
# larger ask only serializes the same data with more zeros
MAX_TRACE_LIMIT = 200

# /debug/profilez ?n= ceiling: distinct folded stacks worth serializing —
# beyond this the tail is single-sample noise
MAX_PROFILE_STACKS = 500

# /debug/criticalz ?n= ceiling: the critical ledger's ring default — a
# larger ask only re-serializes the same tail
MAX_CRITICAL_ROWS = 256

# /debug/decisions ?limit= and /debug/bundle ?decisions= ceiling: the
# explain ring defaults to 256 resident records — a larger ask only
# re-serializes the same tail
MAX_DECISIONS = 256

# /eventz ?n= ceiling: the recorder's post-dedupe ring bound
MAX_EVENTS = 1000


def clamped_int_param(qs: dict, key: str, default: int,
                      ceiling: int) -> "Optional[int]":
    """Shared /debug listing-param discipline (/debug/traces ?limit=,
    /debug/profilez ?n=): a non-integer returns None — the caller answers
    400, because a silent default would make a bad dashboard query look
    like a tiny ring — and a well-formed value clamps into [1, ceiling]."""
    try:
        value = int(qs.get(key, [str(default)])[0])
    except ValueError:
        return None
    return min(max(value, 1), ceiling)

# AdmissionReview resource plural -> store kind
_PLURALS = {
    "provisioners": "provisioners",
    "nodetemplates": "nodetemplates",
    "awsnodetemplates": "nodetemplates",  # backwards-compat manifests
}


class ServingPlane:
    """Owns the three listeners; start() returns the bound ports.

    Port 0 requests an ephemeral bind (N replica subprocesses on one host
    never collide); the ACTUAL bound ports are returned by start() and
    kept on `self.bound` so replica registration can hand the resolved
    address to the rendezvous handshake (fleet/replica.py)."""

    def __init__(self, operator, metrics_port: int = 8080,
                 health_port: int = 8081, webhook_port: int = 8443,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        self.operator = operator
        self.ports = {"metrics": metrics_port, "health": health_port,
                      "webhook": webhook_port}
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.bound: "dict[str, int]" = {}
        self._servers: "list[ThreadingHTTPServer]" = []

    def start(self) -> "dict[str, int]":
        bound = {}
        for name, handler in (("metrics", self._metrics_handler()),
                              ("health", self._health_handler()),
                              ("webhook", self._webhook_handler())):
            port = self.ports[name]
            if port < 0:  # negative disables the listener
                continue
            srv = ThreadingHTTPServer(("0.0.0.0", port), handler)
            if name == "webhook" and self.tls_cert and self.tls_key:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(self.tls_cert, self.tls_key)
                srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
            threading.Thread(target=srv.serve_forever, daemon=True,
                             name=f"serve-{name}").start()
            self._servers.append(srv)
            bound[name] = srv.server_address[1]
        self.bound = dict(bound)
        return bound

    def stop(self) -> None:
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()  # release the listening socket now, not at GC
        self._servers.clear()

    # -- handlers --------------------------------------------------------------

    def _metrics_handler(self):
        op = self.operator

        class Metrics(_Base):
            def do_GET(self):
                if self.path.rstrip("/") in ("", "/metrics"):
                    return self._text(200, op.metrics_text(),
                                      content_type="text/plain; version=0.0.4")
                if self.path.startswith("/debug/statusz"):
                    # one consistent operator snapshot (introspect/statusz) —
                    # `python -m karpenter_tpu_torch statusz` pretty-prints this
                    from .introspect import snapshot

                    return self._text(
                        200, json.dumps(snapshot(op), default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/bundle"):
                    # live diagnostics bundle (no disk write) — the
                    # `diagnose` CLI's fetch side; ?decisions=N bounds the
                    # explain-ring tail carried along (clamped like
                    # /debug/traces ?limit=)
                    from urllib.parse import parse_qs, urlsplit

                    from .introspect.flightrecorder import BUNDLE_DECISIONS

                    fr = getattr(op, "flightrecorder", None)
                    if fr is None:
                        return self._text(404, "flight recorder not wired")
                    qs = parse_qs(urlsplit(self.path).query)
                    decisions = clamped_int_param(
                        qs, "decisions", BUNDLE_DECISIONS, MAX_DECISIONS)
                    if decisions is None:
                        return self._text(400,
                                          "decisions must be an integer")
                    return self._text(
                        200, json.dumps(
                            fr.bundle("manual", "GET /debug/bundle",
                                      decisions=decisions),
                            default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/fleetz"):
                    # cross-replica joined snapshot (introspect/fleetview):
                    # per-replica health/epoch/residency/tenants + the
                    # router's tenant pinning, one schema-versioned doc
                    fv = getattr(op, "fleetview", None)
                    if fv is None:
                        return self._text(404, "fleet view not wired")
                    return self._text(
                        200, json.dumps(fv.fleetz(), default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/traces"):
                    # recent traces as JSON; ?id=<trace_id> exports ONE trace
                    # in Chrome trace_event format (load in Perfetto /
                    # chrome://tracing) — federated across replicas when a
                    # fleet view is wired; ?id=&format=spans returns the raw
                    # span dicts (the fetch side of federation); ?index=1
                    # lists ids only (root, duration, tenant/replica
                    # annotations); ?limit=N bounds the listing
                    from urllib.parse import parse_qs, urlsplit

                    from .tracing import TRACER

                    qs = parse_qs(urlsplit(self.path).query)
                    trace_id = qs.get("id", [None])[0]
                    fv = getattr(op, "fleetview", None)
                    if trace_id:
                        if qs.get("format", [""])[0] == "spans":
                            spans = TRACER.trace(trace_id)
                            if not spans:
                                return self._text(404, "unknown trace id")
                            # the serving process's REAL pid rides along so
                            # a federating client (fleetview) lanes this
                            # replica's spans under its actual OS process
                            return self._text(
                                200, json.dumps(
                                    {"trace_id": trace_id,
                                     "pid": os.getpid(), "spans": spans},
                                    default=str),
                                content_type="application/json")
                        # chrome-trace exports carry the continuous
                        # profiler's samples as a `profiling` process lane
                        # (no-op while the profiling plane is disabled)
                        from .profiling import merge_chrome
                        if fv is not None:
                            doc = fv.federated_trace(trace_id)
                            if doc is None:
                                return self._text(404, "unknown trace id")
                            return self._text(
                                200, json.dumps(merge_chrome(doc),
                                                default=str),
                                content_type="application/json")
                        if not TRACER.trace(trace_id):
                            return self._text(404, "unknown trace id")
                        return self._text(
                            200, json.dumps(
                                merge_chrome(TRACER.chrome_trace(trace_id)),
                                default=str),
                            content_type="application/json")
                    limit = clamped_int_param(qs, "limit", 20,
                                              MAX_TRACE_LIMIT)
                    if limit is None:
                        return self._text(400, "limit must be an integer")
                    if qs.get("index", [""])[0]:
                        index = (fv.trace_index(limit) if fv is not None
                                 else TRACER.trace_index(limit))
                        return self._text(
                            200, json.dumps({"traces": index}, default=str),
                            content_type="application/json")
                    return self._text(
                        200, json.dumps({"traces": TRACER.traces(limit)},
                                        default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/profilez"):
                    # continuous-profiler read surface: ?format=json is the
                    # pprof-style aggregation (stacks + device ladder + gap
                    # ledger), ?format=folded is flamegraph-ready folded
                    # stacks; ?n= bounds the stack listing (clamped like
                    # /debug/traces ?limit=)
                    from urllib.parse import parse_qs, urlsplit

                    from . import profiling

                    qs = parse_qs(urlsplit(self.path).query)
                    n = clamped_int_param(qs, "n", 100, MAX_PROFILE_STACKS)
                    if n is None:
                        return self._text(400, "n must be an integer")
                    fmt = qs.get("format", ["json"])[0]
                    if fmt not in ("json", "folded"):
                        return self._text(
                            400, f"unknown format: {fmt} (json|folded)")
                    # reading the endpoint is the always-on profiler's lazy
                    # ignition (no-op while the plane is disabled)
                    profiling.PROFILER.ensure_started()
                    if fmt == "folded":
                        return self._text(200, profiling.folded_text(n) + "\n")
                    return self._text(
                        200, json.dumps(profiling.profilez(n), default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/criticalz"):
                    # critical-path read surface: per-solve
                    # interval analyses — chain length, overlap ratio,
                    # on/off-critical phase split, wait breakdown, plus
                    # the measured-roofline rung table; ?n= bounds the
                    # row listing (clamped like /debug/profilez ?n=)
                    from urllib.parse import parse_qs, urlsplit

                    from .profiling import critical

                    qs = parse_qs(urlsplit(self.path).query)
                    n = clamped_int_param(qs, "n", 50, MAX_CRITICAL_ROWS)
                    if n is None:
                        return self._text(400, "n must be an integer")
                    return self._text(
                        200, json.dumps(critical.criticalz(n), default=str),
                        content_type="application/json")
                if self.path.startswith("/debug/decisions"):
                    # decision-provenance ring (the explain plane): index
                    # of recent DecisionRecords; ?id= returns one record in
                    # full, ?pod= resolves the newest record mentioning the
                    # pod (the `explain <pod>` CLI's fetch side); ?kind=
                    # filters the index, ?limit= bounds it (clamped like
                    # /debug/traces ?limit=)
                    from urllib.parse import parse_qs, urlsplit

                    from . import explain

                    qs = parse_qs(urlsplit(self.path).query)
                    rid = qs.get("id", [None])[0]
                    if rid:
                        rec = explain.DECISIONS.get(rid)
                        if rec is None:
                            return self._text(404, "unknown decision id")
                        return self._text(
                            200, json.dumps(rec, default=str),
                            content_type="application/json")
                    pod = qs.get("pod", [None])[0]
                    if pod:
                        rec = explain.DECISIONS.find_pod(pod)
                        if rec is None:
                            return self._text(
                                404,
                                f"no decision record mentions pod {pod}")
                        return self._text(
                            200, json.dumps(rec, default=str),
                            content_type="application/json")
                    limit = clamped_int_param(qs, "limit", 50,
                                              MAX_DECISIONS)
                    if limit is None:
                        return self._text(400, "limit must be an integer")
                    kind = qs.get("kind", [None])[0]
                    index = [
                        {"id": r.get("id"), "kind": r.get("kind"),
                         "ts": r.get("ts"), "trace_id": r.get("trace_id")}
                        for r in explain.DECISIONS.records(limit,
                                                           kind=kind)]
                    return self._text(
                        200, json.dumps(
                            {"enabled": explain.enabled(),
                             "schema": explain.SCHEMA_VERSION,
                             "decisions": index}, default=str),
                        content_type="application/json")
                return self._text(404, "not found")

        return Metrics

    def _health_handler(self):
        op = self.operator

        class Health(_Base):
            def do_GET(self):
                if self.path.startswith("/logz"):
                    # recent controller logs (utils/logring) — the `logs`
                    # CLI's kubectl-logs-shaped triage endpoint; ?level=
                    # filters by minimum severity, ?format=json returns the
                    # structured records (JSON lines, bundle-shaped)
                    from urllib.parse import parse_qs, urlsplit

                    from .utils import logring

                    qs = parse_qs(urlsplit(self.path).query)
                    try:
                        n = int(qs.get("n", ["500"])[0])
                    except ValueError:
                        n = 500
                    level = qs.get("level", [None])[0]
                    if level is not None:
                        try:
                            logring._levelno(level)
                        except ValueError:
                            return self._text(
                                400, f"unknown log level: {level}")
                    if qs.get("format", [""])[0] == "json":
                        lines = [json.dumps(r, default=str) for r in
                                 logring.dump_records(n, level)]
                    else:
                        lines = logring.dump(n, level)
                    return self._text(200, "\n".join(lines) + "\n")
                if self.path.startswith("/eventz"):
                    # recent recorded events (post-dedupe ring) — the
                    # `events` CLI endpoint, mirroring /logz + `logs`
                    from urllib.parse import parse_qs, urlsplit

                    qs = parse_qs(urlsplit(self.path).query)
                    n = clamped_int_param(qs, "n", 100, MAX_EVENTS)
                    if n is None:
                        return self._text(400, "n must be an integer")
                    events = [
                        {"ts": ts, "kind": e.kind, "reason": e.reason,
                         "object": e.object_ref, "message": e.message}
                        for ts, e in op.recorder.recent(n)]
                    return self._text(
                        200, json.dumps({"events": events}, default=str),
                        content_type="application/json")
                if self.path.startswith("/healthz"):
                    ok, detail = op.healthz(), "ok"
                elif self.path.startswith("/readyz"):
                    # watchdog-aggregated: a stalled reconcile loop makes
                    # the replica unready, and the body names it
                    readyz = getattr(op, "readyz", None)
                    if readyz is None:
                        ok, detail = op.healthz(), "ok"
                    else:
                        ok, detail = readyz()
                elif self.path.startswith("/livez"):
                    ok, detail = op.livez(), "ok"
                else:
                    return self._text(404, "not found")
                return self._text(200 if ok else 503,
                                  detail if ok else
                                  (detail if detail != "ok" else "unhealthy"))

        return Health

    def _webhook_handler(self):
        op = self.operator

        class Webhook(_Base):
            def do_POST(self):
                mutate = self.path.startswith("/mutate")
                if not mutate and not self.path.startswith("/validate"):
                    return self._text(404, "not found")
                length = self.headers.get("Content-Length")
                try:
                    # fail CLOSED on an unreadable body (absent/zero
                    # Content-Length, e.g. a proxy stripping it): an
                    # unverifiable object must not be admitted
                    if length is None or int(length) <= 0:
                        raise ValueError("missing or empty request body")
                    review = json.loads(self.rfile.read(int(length)))
                    resp = _admit_review(op, review, mutate=mutate)
                except Exception as e:  # malformed review: explicit denial
                    resp = _review_response("", False, f"bad request: {e}")
                body = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Webhook


class _Base(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _text(self, code: int, body: str,
              content_type: str = "text/plain") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _review_response(uid: str, allowed: bool, message: str = "") -> dict:
    resp = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": {"uid": uid, "allowed": allowed}}
    if message:
        resp["response"]["status"] = {"message": message, "code": 403}
    return resp


def _admit_review(operator, review: dict, mutate: bool = False) -> dict:
    """AdmissionReview request -> response via the Webhooks pipeline.

    /validate runs defaulting+validation and answers allowed/denied only;
    /mutate additionally returns the defaulted object as a whole-document
    JSONPatch (RFC 6902 `replace` at path "") so the knative-style
    defaulting half works through a real apiserver too."""
    import base64
    import copy

    from .coordination import serde
    from .webhooks import AdmissionError

    req = review.get("request") or {}
    uid = req.get("uid", "")
    plural = ((req.get("resource") or {}).get("resource") or "").lower()
    kind = _PLURALS.get(plural)
    if kind is None:
        return _review_response(uid, True)  # not a guarded kind: admit
    doc = req.get("object") or {}
    try:
        obj = serde.from_manifest(kind, doc)
        admitted = operator.webhooks.admit(kind, obj,
                                           req.get("operation", "CREATE"))
    except AdmissionError as e:
        return _review_response(uid, False, str(e))
    except Exception as e:  # unparseable object
        return _review_response(uid, False, f"invalid {kind} manifest: {e}")
    resp = _review_response(uid, True)
    if mutate:
        name = serde.manifest_name(doc) or getattr(admitted, "name", "")
        defaulted = serde.to_manifest(kind, name, admitted)
        # preserve the caller's metadata (labels/annotations/namespace the
        # serde round trip doesn't carry)
        merged_meta = copy.deepcopy(doc.get("metadata") or {})
        merged_meta.update(defaulted.get("metadata") or {})
        defaulted["metadata"] = merged_meta
        patch = [{"op": "replace", "path": "", "value": defaulted}]
        resp["response"]["patchType"] = "JSONPatch"
        resp["response"]["patch"] = base64.b64encode(
            json.dumps(patch).encode()).decode()
    return resp
