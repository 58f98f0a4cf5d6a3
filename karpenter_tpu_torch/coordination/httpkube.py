"""HttpKubeStore: the CoordinationPlane over the Kubernetes REST API.

Copy of karpenter_tpu/coordination/httpkube.py for the PyTorch port, which
imports nothing of the JAX package, edited; tests/test_torch_copies.py holds
it to the original's names and bounds the edit. Three lines are reworded.

The controller half finally runs against a REAL coordination plane
(the reference boots against a live apiserver,
upstream cmd/controller/main.go:33-65): stdlib-HTTP CRUD + chunked
``?watch=true`` streams — no kubernetes client dependency.

Design: an informer-style client. An inner in-process KubeStore acts as the
local cache; LIST seeds it, one watch thread per kind keeps it current, and
every typed read (pending_pods, provisioners, ...) is served from the cache
exactly like client-go informers serve controllers. Writes go HTTP-first,
then apply to the cache synchronously (read-your-writes); the later watch
echo deduplicates by resourceVersion.

Admission runs client-side before writes (the framework's webhook pipeline
sits at this boundary in-process; a production deployment would register the
same pipeline as real admission webhooks — deploy/karpenter-tpu/).
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from ..fake.kube import Conflict, Fenced, KubeStore
from ..metrics import NAMESPACE, REGISTRY
from . import serde

log = logging.getLogger("karpenter.httpkube")

# kind -> (path prefix, plural, namespaced)
_API = {
    "pods": ("/api/v1", "pods", True),
    "nodes": ("/api/v1", "nodes", False),
    "configmaps": ("/api/v1", "configmaps", True),
    "pdbs": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "leases": ("/apis/coordination.k8s.io/v1", "leases", True),
    "provisioners": ("/apis/karpenter.sh/v1alpha5", "provisioners", False),
    "machines": ("/apis/karpenter.sh/v1alpha5", "machines", False),
    "nodetemplates": ("/apis/karpenter.k8s.tpu/v1alpha1", "nodetemplates", False),
    "events": ("/api/v1", "events", True),
    "intents": ("/apis/karpenter.sh/v1alpha5", "intents", False),
}


class ApiError(RuntimeError):
    def __init__(self, code: int, message: str,
                 retry_after: "Optional[float]" = None):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        # server-directed backoff (429 Retry-After header, seconds); the
        # client has already honored it through the retry policy's clamped
        # sleep by the time this propagates — the attribute lets callers
        # see what was asked
        self.retry_after = retry_after


def _retry_after_seconds(raw: "Optional[str]") -> "Optional[float]":
    """Parse a Retry-After header's delta-seconds form (the HTTP-date
    form is ignored — an apiserver throttle always sends seconds)."""
    if raw is None:
        return None
    try:
        seconds = float(raw.strip())
    except (ValueError, AttributeError):
        return None
    return seconds if seconds >= 0 else None


def load_kubeconfig(path: str) -> "tuple[str, Optional[str], object]":
    """(server, bearer token, ssl_context_or_None) from a kubeconfig.

    Supports the standard auth shapes: bearer token, cluster CA via
    certificate-authority(-data), client certs via
    client-certificate(-data)/client-key(-data), and
    insecure-skip-tls-verify."""
    import base64
    import os
    import tempfile

    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    ctx_name = cfg.get("current-context") or cfg["contexts"][0]["name"]
    ctx = next(c["context"] for c in cfg["contexts"] if c["name"] == ctx_name)
    cluster = next(c["cluster"] for c in cfg["clusters"]
                   if c["name"] == ctx["cluster"])
    user = next((u["user"] for u in cfg.get("users", [])
                 if u["name"] == ctx.get("user")), {})
    server = cluster["server"]
    ssl_ctx = None
    if server.startswith("https"):
        if cluster.get("insecure-skip-tls-verify"):
            ssl_ctx = ssl._create_unverified_context()
        else:
            ssl_ctx = ssl.create_default_context()
            ca_data = cluster.get("certificate-authority-data")
            if ca_data:
                ssl_ctx.load_verify_locations(
                    cadata=base64.b64decode(ca_data).decode())
            elif cluster.get("certificate-authority"):
                ssl_ctx.load_verify_locations(cluster["certificate-authority"])
        cert_data = user.get("client-certificate-data")
        key_data = user.get("client-key-data")
        if cert_data and key_data:
            # ssl wants file paths; decode the inline pair to a temp bundle,
            # and unlink it as soon as the context has loaded it — private
            # key material must not outlive this call on disk
            bundle = tempfile.NamedTemporaryFile(
                mode="w", suffix=".pem", delete=False)
            try:
                bundle.write(base64.b64decode(cert_data).decode())
                bundle.write("\n")
                bundle.write(base64.b64decode(key_data).decode())
                bundle.close()
                ssl_ctx.load_cert_chain(bundle.name)
            finally:
                os.unlink(bundle.name)
        elif user.get("client-certificate") and user.get("client-key"):
            ssl_ctx.load_cert_chain(user["client-certificate"],
                                    user["client-key"])
    return server, user.get("token"), ssl_ctx


class HttpKubeStore:
    """CoordinationPlane over HTTP. Call start() to seed + watch."""

    KINDS = KubeStore.KINDS
    namespace = "default"

    # A pooled socket idle longer than this is dropped before reuse rather
    # than risk racing the server's own keep-alive reaper: the server may
    # close an idle connection at any moment, and a write that lands in
    # that window dies response-phase — the ambiguous "did it apply?"
    # failure mode. Under the default apiserver/LB idle timeouts (60-300s)
    # a 30s client horizon means we always blink first.
    KEEPALIVE_IDLE_SECONDS = 30.0

    # watch-ingest attribution: decode/apply wall time flushes as one
    # synthesized span pair per this many events (per-event spans would
    # flood the trace ring during a 10k-pod ingest)
    INGEST_SPAN_BATCH = 256

    def __init__(self, server: str, token: Optional[str] = None,
                 verify_tls: bool = True, timeout: float = 10.0,
                 ssl_context=None, registry=None, clock=None,
                 keepalive_idle_seconds: Optional[float] = None):
        self.server = server.rstrip("/")
        self.token = token
        self.timeout = timeout
        self._clock = clock  # injectable (FakeClock in tests); None = time.monotonic
        self.keepalive_idle_seconds = (
            self.KEEPALIVE_IDLE_SECONDS if keepalive_idle_seconds is None
            else keepalive_idle_seconds)
        self._ssl = ssl_context
        if self._ssl is None and server.startswith("https") and not verify_tls:
            self._ssl = ssl._create_unverified_context()
        self._cache = KubeStore()  # informer cache + watcher fan-out
        # wire-client observability (designs/metrics.md): request outcomes
        # at the HTTP boundary and watch reconnects — the dashboards' first
        # question when a controller goes quiet is "is the watch alive".
        # Injectable registry like every controller (tests isolate counts).
        reg = registry if registry is not None else REGISTRY
        self.requests_total = reg.counter(
            f"{NAMESPACE}_coordination_requests_total",
            "Coordination-plane HTTP requests.", ("method", "outcome"))
        self.watch_restarts = reg.counter(
            f"{NAMESPACE}_coordination_watch_restarts_total",
            "Watch streams re-established (any cause incl. clean "
            "server-side timeouts).", ("kind",))
        self._admission = None
        # fencing high-water mark as advertised by the server on every
        # response (X-Fencing-Epoch); 0 until the first round trip
        self._fence_epoch = 0
        self._docs: "dict[tuple[str, str], dict]" = {}  # last manifest seen
        self._rv: "dict[tuple[str, str], int]" = {}     # last rv applied
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: "list[threading.Thread]" = []
        # keep-alive connection pool for full-body requests (_request_json):
        # one reusable connection per thread. A fresh TCP (+TLS) handshake
        # per write capped the wire drain at ~10 ops/s in the deployed-
        # topology benchmark (benchmarks/wire_bench.py); keep-alive is what
        # a real client library does. Watch streams stay on urllib — they
        # hold a connection open indefinitely and never return it usable.
        split = urllib.parse.urlsplit(self.server)
        self._netloc = split.netloc
        self._https = split.scheme == "https"
        self._pool_local = threading.local()
        # resilience.RetryPolicy for the kube-apiserver edge (operator wires
        # it): the transparent reconnect retry below spends from its budget
        # and every unreachable outcome feeds its breaker
        self._policy = None

    def set_resilience(self, policy) -> None:
        self._policy = policy

    @classmethod
    def from_kubeconfig(cls, path: str, **kw) -> "HttpKubeStore":
        server, token, ssl_ctx = load_kubeconfig(path)
        return cls(server, token=token, ssl_context=ssl_ctx, **kw)

    # -- HTTP plumbing ---------------------------------------------------------

    def _url(self, kind: str, name: Optional[str] = None,
             sub: Optional[str] = None, query: str = "") -> str:
        prefix, plural, namespaced = _API[kind]
        path = prefix
        if namespaced:
            path += f"/namespaces/{self.namespace}"
        path += f"/{plural}"
        if name:
            path += f"/{name}"
        if sub:
            path += f"/{sub}"
        if query:
            path += f"?{query}"
        return self.server + path

    def _request(self, method: str, url: str, body: "Optional[dict]" = None,
                 timeout: "Optional[float]" = None,
                 content_type: str = "application/json"):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            resp = urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self._ssl)
        except urllib.error.HTTPError as e:
            msg = e.read().decode(errors="replace")[:300]
            if e.code == 409:
                self.requests_total.inc(method=method, outcome="conflict")
                raise Conflict(msg)
            if e.code == 429:
                # throttled is its own outcome (not lumped with 5xx): the
                # server is ALIVE and pacing us — honor its Retry-After
                # through the policy's clamped, FakeClock-injectable sleep
                self.requests_total.inc(method=method, outcome="throttled")
                ra = _retry_after_seconds(e.headers.get("Retry-After"))
                if ra is not None and self._policy is not None:
                    self._policy.sleep_retry_after(ra)
                raise ApiError(e.code, msg, retry_after=ra)
            self.requests_total.inc(method=method, outcome=f"http_{e.code}")
            raise ApiError(e.code, msg)
        except urllib.error.URLError as e:
            self.requests_total.inc(method=method, outcome="unreachable")
            raise ApiError(0, f"apiserver unreachable: {e.reason}")
        self.requests_total.inc(method=method, outcome="ok")
        return resp

    def _conn_now(self) -> float:
        return self._clock.now() if self._clock is not None \
            else time.monotonic()

    def _pooled_conn(self) -> "tuple[http.client.HTTPConnection, bool]":
        """(connection, fresh): fresh=True means it was just connected —
        nothing has ever been sent on it. Raises OSError family on
        connect failure (caller maps to ApiError(0)). A connection idle
        past keepalive_idle_seconds is proactively dropped and redialed
        (see KEEPALIVE_IDLE_SECONDS)."""
        c = getattr(self._pool_local, "conn", None)
        if c is not None:
            idle = self._conn_now() - getattr(
                self._pool_local, "last_used", self._conn_now())
            if self.keepalive_idle_seconds >= 0 \
                    and idle > self.keepalive_idle_seconds:
                self._drop_pooled_conn()
                c = None
        if c is not None:
            self._pool_local.last_used = self._conn_now()
            return c, False
        if self._https:
            c = http.client.HTTPSConnection(
                self._netloc, timeout=self.timeout, context=self._ssl)
        else:
            c = http.client.HTTPConnection(
                self._netloc, timeout=self.timeout)
        c.connect()
        # TCP_NODELAY: http.client writes headers and body as separate
        # small segments; with Nagle on, the second segment waits out
        # the peer's delayed ACK (~40ms) — at controller write rates
        # that stall IS the wire benchmark's whole budget
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._pool_local.conn = c
        self._pool_local.last_used = self._conn_now()
        return c, True

    def _drop_pooled_conn(self) -> None:
        c = getattr(self._pool_local, "conn", None)
        if c is not None:
            self._pool_local.conn = None
            try:
                c.close()
            except OSError:
                pass

    def _request_json(self, method, url, body=None,
                      content_type: str = "application/json",
                      epoch: "Optional[int]" = None):
        """Full-body request over the per-thread keep-alive connection.
        The response is always consumed completely, so the socket stays
        reusable; a stale pooled socket (server closed it between calls)
        gets ONE transparent reconnect. `epoch` rides as X-Fencing-Epoch:
        the server refuses the write (409 Fenced) when it is older than
        the fencing high-water mark."""
        data = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": content_type}
        if epoch is not None:
            headers["X-Fencing-Epoch"] = str(epoch)
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        split = urllib.parse.urlsplit(url)
        path = split.path + (f"?{split.query}" if split.query else "")
        pol = self._policy
        if pol is not None and pol.breaker is not None \
                and not pol.breaker.allow():
            # apiserver known-down: fail fast instead of burning a connect
            # timeout per call (the breaker's half-open probe lets ONE call
            # through per recovery window)
            pol.retries_total.inc(dep=pol.dep, outcome="breaker_open")
            self.requests_total.inc(method=method, outcome="breaker_open")
            raise ApiError(0, "apiserver circuit breaker open")

        def _note_failure():
            if pol is not None:
                pol.note_failure()

        def _retry_ok():
            # the transparent reconnect retry also spends a budget token —
            # a flapping apiserver can't be retried into a storm
            return pol is None or pol.try_retry()

        for attempt in (0, 1):
            try:
                conn, fresh = self._pooled_conn()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                # connect-phase failure: nothing was sent, retrying any
                # method is safe; exhausted -> the documented contract
                _note_failure()
                if attempt == 0 and _retry_ok():
                    continue
                self.requests_total.inc(method=method, outcome="unreachable")
                raise ApiError(0, f"apiserver unreachable: {e}")
            try:
                conn.request(method, path, body=data, headers=headers)
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                # SEND-phase failure: the request never left intact. GETs
                # always retry; writes retry only for the stale-keep-alive
                # case (a REUSED socket the server closed between calls —
                # the send died cleanly, nothing was applied). A timeout
                # here still means nothing was delivered, but stay
                # conservative and exclude it for writes.
                self._drop_pooled_conn()
                _note_failure()
                retriable = (method == "GET"
                             or (not fresh and not isinstance(e, TimeoutError)))
                if attempt == 0 and retriable and _retry_ok():
                    continue
                self.requests_total.inc(method=method, outcome="unreachable")
                raise ApiError(0, f"apiserver unreachable: {e}")
            try:
                resp = conn.getresponse()
                payload = resp.read()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                # RESPONSE-phase failure: the request WAS delivered and may
                # have been applied — re-sending a write would double-apply
                # (a CAS would see its own rv bump as a spurious Conflict,
                # a create would 409 AlreadyExists against itself). Only
                # idempotent GETs retry past this point — with ONE carve-out:
                # RemoteDisconnected on a REUSED socket. getresponse raises it
                # only when ZERO response bytes arrived, and a server that
                # processed a request sends at least a status line before
                # closing; an immediate FIN on a pooled connection is the
                # stale-keep-alive race (server expired the idle socket as our
                # request was in flight — it never read it), so one replay of
                # a write is safe.
                self._drop_pooled_conn()
                _note_failure()
                retriable = (method == "GET"
                             or (not fresh
                                 and isinstance(e, http.client.RemoteDisconnected)))
                if attempt == 0 and retriable and _retry_ok():
                    continue
                self.requests_total.inc(method=method, outcome="unreachable")
                raise ApiError(0, f"apiserver unreachable: {e}")
            if resp.will_close:
                self._drop_pooled_conn()
            # ANY response means the apiserver is alive: 4xx/409 are
            # business outcomes, not dependency failures — the breaker and
            # budget only ever see transport-level unreachability
            if pol is not None:
                pol.note_success()
            fe = resp.getheader("X-Fencing-Epoch")
            if fe is not None:
                try:
                    self._fence_epoch = max(self._fence_epoch, int(fe))
                except ValueError:
                    pass
            if resp.status == 409:
                self.requests_total.inc(method=method, outcome="conflict")
                text = payload.decode(errors="replace")[:300]
                if '"Fenced"' in text:
                    raise Fenced(text)
                raise Conflict(text)
            if resp.status == 429:
                # see _request: throttled is a pacing signal from a LIVE
                # server, classified apart from 5xx and honored via the
                # policy's clamped Retry-After sleep
                self.requests_total.inc(method=method, outcome="throttled")
                ra = _retry_after_seconds(resp.getheader("Retry-After"))
                if ra is not None and pol is not None:
                    pol.sleep_retry_after(ra)
                raise ApiError(resp.status,
                               payload.decode(errors="replace")[:300],
                               retry_after=ra)
            if resp.status >= 400:
                self.requests_total.inc(method=method,
                                        outcome=f"http_{resp.status}")
                raise ApiError(resp.status,
                               payload.decode(errors="replace")[:300])
            self.requests_total.inc(method=method, outcome="ok")
            return json.loads(payload or b"{}")

    # -- informer lifecycle ----------------------------------------------------

    # kinds the informer LISTs + watches. "events" is deliberately excluded:
    # a busy cluster's event firehose (kubelet, scheduler, every component)
    # would flood the cache and fire every watcher with objects no
    # controller reads — our own writes still land in the cache via the
    # read-your-writes apply, and listings of foreign events go direct.
    WATCHED_KINDS = tuple(k for k in KubeStore.KINDS if k != "events")

    def start(self) -> None:
        """Seed the cache with LIST, then keep it current with one watch
        stream per kind (reconnect-with-relist on drop)."""
        for kind in self.WATCHED_KINDS:
            self._relist(kind)
        for kind in self.WATCHED_KINDS:
            t = threading.Thread(target=self._watch_loop, args=(kind,),
                                 name=f"watch-{kind}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # watch threads are daemons blocked on reads; they die with the
        # process or on the next bookmark tick

    def _relist(self, kind: str) -> None:
        doc = self._request_json("GET", self._url(kind))
        # an object written after the LIST's snapshot (a create racing the
        # relist) is newer than the snapshot, not stale: evicting it would
        # drop it from the cache until its echo re-adds it, last in order
        list_rv = int((doc.get("metadata") or {}).get("resourceVersion") or 0)
        fresh = {}
        for item in doc.get("items", []):
            name = serde.manifest_name(item)
            if name:
                fresh[name] = item
        with self._lock:
            stale = {n for n in (o for o in self._cache._objects[kind])
                     if n not in fresh and not (
                         list_rv and self._rv.get((kind, n), 0) > list_rv)}
            for name, item in fresh.items():
                self._apply_manifest(kind, "MODIFIED", item, notify=True)
            for name in stale:
                obj = self._cache.delete(kind, name)
                self._rv.pop((kind, name), None)
                self._docs.pop((kind, name), None)

    def _watch_loop(self, kind: str) -> None:
        attached_before = False
        while not self._stop.is_set():
            if attached_before:
                # ANY re-entry is a restart — kube-apiserver ends long
                # watches with a clean close, which must count too
                self.watch_restarts.inc(kind=kind)
            attached_before = True
            # Watch-ingest attribution (docs/designs/slo.md): per-event
            # spans would flood the trace ring at 10k-pod ingest rates, so
            # decode (json.loads) and apply (cache + watcher fan-out) wall
            # time accumulate and flush as ONE synthesized span per batch —
            # the deployed topology's dominant cycle cost becomes a
            # first-class phase instead of dark time.
            from ..tracing import TRACER

            decode_s = apply_s = 0.0
            batched = 0

            def flush_ingest():
                nonlocal decode_s, apply_s, batched
                if not batched:
                    return
                TRACER.record_span("ingest.decode", decode_s,
                                   kind=kind, events=batched)
                TRACER.record_span("ingest.apply", apply_s,
                                   kind=kind, events=batched)
                decode_s = apply_s = 0.0
                batched = 0

            try:
                resp = self._request("GET", self._url(kind, query="watch=true"),
                                     timeout=86400)
                with resp:
                    # close the start()-to-attach gap: an object deleted
                    # before this stream attached produced no DELETED event
                    # and is absent from the attach replay — only a relist
                    # AFTER the stream opened evicts it from the cache
                    self._relist(kind)
                    for line in resp:
                        if self._stop.is_set():
                            flush_ingest()
                            return
                        if not line.strip():
                            continue
                        t0 = time.perf_counter()
                        event = json.loads(line)
                        t1 = time.perf_counter()
                        decode_s += t1 - t0
                        if event.get("type") == "BOOKMARK":
                            continue
                        self._apply_manifest(
                            kind, event["type"], event.get("object") or {},
                            notify=True)
                        apply_s += time.perf_counter() - t1
                        batched += 1
                        if batched >= self.INGEST_SPAN_BATCH:
                            flush_ingest()
                flush_ingest()  # clean server-side close: drain the batch
            except (ApiError, Conflict, OSError, ValueError) as e:
                flush_ingest()  # the partial batch's time is still real
                if self._stop.is_set():
                    return
                log.warning("watch %s dropped (%s); relisting", kind, e)
                self._stop.wait(0.5)
                try:
                    self._relist(kind)
                except Exception as e2:
                    log.warning("relist %s failed: %s", kind, e2)
                    self._stop.wait(1.0)

    def _apply_manifest(self, kind: str, type_: str, doc: dict,
                        notify: bool) -> None:
        name = serde.manifest_name(doc)
        if not name:
            return
        key = (kind, name)
        with self._lock:
            if type_ == "DELETED":
                self._rv.pop(key, None)
                self._docs.pop(key, None)
                self._cache.delete(kind, name)  # notifies cache watchers
                return
            rv = int((doc.get("metadata") or {}).get("resourceVersion") or 0)
            if rv and self._rv.get(key, -1) >= rv:
                return  # stale echo of a write already applied
            self._rv[key] = rv
            self._docs[key] = doc
            obj = serde.from_manifest(kind, doc)
            if obj is None:
                # foreign object of a controller-owned kind: visible on the
                # server, not interpretable here — leave it out of the cache
                log.debug("skipping foreign %s/%s (no embedded model)",
                          kind, name)
                return
            if self._cache.get(kind, name) is None:
                self._cache.create(kind, name, obj)
            else:
                self._cache.update(kind, name, obj)

    # -- CoordinationPlane: CRUD ----------------------------------------------

    def _admit(self, kind: str, obj, op: str):
        if self._admission is not None:
            return self._admission(kind, obj, op)
        return obj

    def fence_epoch(self) -> int:
        """Highest fencing epoch the server has advertised to this client.
        Lags the authoritative server-side mark by at most one request —
        callers minting epochs (LeaderElector) also consult the lease
        object itself, which the same watch keeps current."""
        return self._fence_epoch

    def get(self, kind: str, name: str):
        return self._cache.get(kind, name)

    def list(self, kind: str) -> list:
        if kind not in self.WATCHED_KINDS:
            # unwatched kinds (events) never enter the informer cache, so a
            # cache read would always be empty — and Operator's event prune
            # would never see orphaned evt-* objects from crashed replicas.
            # Serve these with a direct LIST instead.
            doc = self._request_json("GET", self._url(kind))
            out = []
            for item in doc.get("items", []):
                obj = serde.from_manifest(kind, item)
                if obj is not None:
                    out.append(obj)
            return out
        return self._cache.list(kind)

    def create(self, kind: str, name: str, obj,
               epoch: "Optional[int]" = None) -> None:
        obj = self._admit(kind, obj, "CREATE")
        doc = serde.to_manifest(kind, name, obj)
        created = self._request_json("POST", self._url(kind), doc,
                                     epoch=epoch)
        self._apply_manifest(kind, "ADDED", created, notify=True)

    def update(self, kind: str, name: str, obj,
               epoch: "Optional[int]" = None) -> None:
        obj = self._admit(kind, obj, "UPDATE")
        doc = serde.to_manifest(kind, name, obj)
        updated = self._request_json("PUT", self._url(kind, name), doc,
                                     epoch=epoch)
        self._apply_manifest(kind, "MODIFIED", updated, notify=True)

    def delete(self, kind: str, name: str, epoch: "Optional[int]" = None):
        obj = self._cache.get(kind, name)
        try:
            self._request_json("DELETE", self._url(kind, name), epoch=epoch)
        except ApiError as e:
            if e.code != 404:
                raise
        self._apply_manifest(kind, "DELETED",
                             {"metadata": {"name": name}}, notify=True)
        return obj

    def compare_and_swap(self, kind: str, name: str, expect, obj,
                         epoch: "Optional[int]" = None) -> None:
        obj = self._admit(kind, obj, "UPDATE")
        with self._lock:
            cur = self._cache.get(kind, name)
            if cur is not expect:
                raise Conflict(f"{kind}/{name} changed since read")
            doc_rv = (self._docs.get((kind, name), {}).get("metadata") or {}
                      ).get("resourceVersion")
        doc = serde.to_manifest(kind, name, obj)
        if doc_rv is not None:
            doc["metadata"]["resourceVersion"] = doc_rv  # server-side CAS
        updated = self._request_json("PUT", self._url(kind, name), doc,
                                     epoch=epoch)
        self._apply_manifest(kind, "MODIFIED", updated, notify=True)

    def delete_if(self, kind: str, name: str, expect,
                  epoch: "Optional[int]" = None) -> bool:
        """Atomic over the wire: the DELETE carries a resourceVersion
        precondition, so a successor's write between our check and the
        delete loses nothing (a lease released late must never clobber the
        new holder's lease)."""
        with self._lock:
            if self._cache.get(kind, name) is not expect:
                return False
            rv = (self._docs.get((kind, name), {}).get("metadata") or {}
                  ).get("resourceVersion")
        try:
            self._request_json(
                "DELETE", self._url(kind, name),
                None if rv is None else
                {"preconditions": {"resourceVersion": rv}}, epoch=epoch)
        except Conflict:
            return False
        except ApiError as e:
            if e.code != 404:
                raise
        self._apply_manifest(kind, "DELETED",
                             {"metadata": {"name": name}}, notify=True)
        return True

    # -- watch + admission -----------------------------------------------------

    def watch(self, fn: Callable[[str, str, object], None]) -> None:
        self._cache.watch(fn)

    def unwatch(self, fn) -> None:
        self._cache.unwatch(fn)

    def set_admission(self, fn) -> None:
        self._admission = fn

    # -- typed reads (served from the informer cache) --------------------------

    def pods(self):
        return self._cache.pods()

    def pending_pods(self):
        return self._cache.pending_pods()

    def daemon_pods(self):
        return self._cache.daemon_pods()

    def nodes(self):
        return self._cache.nodes()

    def machines(self):
        return self._cache.machines()

    def provisioners(self):
        return self._cache.provisioners()

    def nodetemplates(self):
        return self._cache.nodetemplates()

    def pdbs(self):
        return self._cache.pdbs()

    # -- subresources ----------------------------------------------------------

    def cordon_node(self, name: str) -> None:
        """Server-side cordon: a merge-PATCH (RFC 7386) of ONLY
        spec.unschedulable, so the kubelet-owned Node object is never
        replaced wholesale — the real kube-scheduler must stop targeting
        a draining node. NB merge-patch replaces list fields wholesale;
        never extend this to taints without strategic-merge."""
        self._patch_unschedulable(name, True)

    def uncordon_node(self, name: str) -> None:
        """Roll back a cordon (consolidation revalidation failure): the
        node stays in service, so spec.unschedulable must clear or the
        real scheduler would shun healthy capacity forever."""
        self._patch_unschedulable(name, None)  # merge-patch null deletes

    def _patch_unschedulable(self, name: str, value) -> None:
        doc = self._request_json(
            "PATCH", self._url("nodes", name),
            {"spec": {"unschedulable": value}},
            content_type="application/merge-patch+json")
        # same read-your-writes path as every other write: record rv + doc
        # and refresh the cache object (fires cache watchers); the watch
        # echo then dedupes by resourceVersion
        self._apply_manifest("nodes", "MODIFIED", doc, notify=True)

    def bind_pod(self, pod_name: str, node_name: str,
                 epoch: "Optional[int]" = None) -> None:
        self._request_json(
            "POST", self._url("pods", pod_name, sub="binding"),
            {"apiVersion": "v1", "kind": "Binding",
             "metadata": {"name": pod_name},
             "target": {"apiVersion": "v1", "kind": "Node",
                        "name": node_name}}, epoch=epoch)
        # read-your-writes without waiting for the watch echo
        with self._lock:
            pod = self._cache.get("pods", pod_name)
            if pod is not None and not pod.node_name:
                import dataclasses

                self._cache.update("pods", pod_name,
                                   dataclasses.replace(pod, node_name=node_name))
