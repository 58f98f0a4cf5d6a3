"""The JAX package's coordination-plane tests, run against the port on the
CPU.

Each file's source is loaded by `tests.test_torch_operator.retarget`
(karpenter_tpu imports pointed at karpenter_tpu_torch, every `Operator(`
built with device="cpu") and its tests collected here under their own
names; no assertion is dropped or changed. test_httpkube drives the port's
HttpKubeStore against the port's mini apiserver (CRUD, watch, leases and
fencing, the serde of every stored kind, an Operator over HTTP).
test_foreign_apiserver needs envtest's kube-apiserver and etcd binaries
and skips without them, as it does in the JAX package: its module-level
skip mark is carried onto its case.

And one case of the port's own: a relist whose LIST snapshot predates a
create keeps the created object in the cache, in its place.
"""

from __future__ import annotations

from tests.test_torch_operator import collect, retarget

SOURCES = [
    # (file, tag)
    ("test_httpkube", "httpkube"),
    ("test_foreign_apiserver", "foreign"),
]

COLLECTED: "dict[str, list]" = {}
for _file, _tag in SOURCES:
    _mod = retarget(_file, f"{__name__}_{_file[5:]}")
    COLLECTED[_file] = collect(_mod, _tag, {}, globals())


def test_relist_keeps_an_object_written_after_its_list():
    """The informer's relist (at each watch attach) LISTs, then evicts
    every cached object the LIST lacks. A create that lands between the
    LIST and the eviction is newer than the snapshot: the port keeps it,
    where it was in the cache's order, instead of dropping it until its
    watch echo re-adds it at the end (the JAX package's store, copied as
    it was, evicts it; a 10k-pod served pass then solved its pods in
    another order)."""
    from karpenter_tpu_torch.coordination.httpkube import HttpKubeStore
    from karpenter_tpu_torch.fake.apiserver import serve
    from karpenter_tpu_torch.models.pod import make_pod

    srv, port, _ = serve()
    try:
        store = HttpKubeStore(f"http://127.0.0.1:{port}")
        for name in ("a", "b"):
            store.create("pods", name, make_pod(name, cpu="1", memory="1Gi"))
        real = store._request_json
        lists = []

        def list_then_create(method, url, *args, **kwargs):
            doc = real(method, url, *args, **kwargs)
            if method == "GET" and not lists:
                lists.append(doc)
                store.create("pods", "c", make_pod("c", cpu="1",
                                                   memory="1Gi"))
            return doc

        store._request_json = list_then_create
        store._relist("pods")
        assert [i["metadata"]["name"] for i in lists[0]["items"]] == ["a", "b"]
        assert [p.name for p in store.pods()] == ["a", "b", "c"]
    finally:
        srv.shutdown()
        srv.server_close()
