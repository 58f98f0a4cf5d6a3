"""The program under test, driven from request records: the port's catalog,
provisioners and pods built from the benchmark's files, and the solver
service's Sync and Solve.

This is the only benchmark module that imports karpenter_tpu_torch, and it
takes from it the system under test and its counters alone.
"""

from __future__ import annotations

import json
import os
import re

from .generator import ROOT, pod_name


def build_catalog(config: dict):
    """The port's Catalog, by its own loader, from the frozen catalog JSON
    that the reference reads too."""
    from karpenter_tpu_torch.providers import instancetypes

    with open(os.path.join(ROOT, config["catalog"]["file"])) as f:
        data = json.load(f)
    loader = instancetypes._fleet_data
    instancetypes._fleet_data = lambda: data
    try:
        return instancetypes.generate_fleet_catalog(
            zones=tuple(config["catalog"]["zones"]),
            spot_discount=config["catalog"]["spot_discount"])
    finally:
        instancetypes._fleet_data = loader


def families(config: dict, categories) -> "list[str]":
    """The catalog's instance families whose category (the leading letters
    of the family's name, c5n is c) is one of `categories`."""
    with open(os.path.join(ROOT, config["catalog"]["file"])) as f:
        types = json.load(f)["types"]
    return sorted({t["family"] for t in types
                   if re.match(r"[a-z]*", t["family"]).group(0)
                   in categories})


def build_provisioners(config: dict) -> list:
    """The configuration's provisioners: capacity types, arch and os, and
    where given, instance categories (as the families they name) and a
    floor on the instance generation."""
    from karpenter_tpu_torch.apis import wellknown as wk
    from karpenter_tpu_torch.apis.provisioner import Provisioner
    from karpenter_tpu_torch.models.requirements import (OP_GT, OP_IN,
                                                         Requirements)

    out = []
    for spec in config["provisioners"]:
        reqs = [(wk.LABEL_CAPACITY_TYPE, OP_IN, list(spec["capacity_types"])),
                (wk.LABEL_ARCH, OP_IN, list(spec["arch"])),
                (wk.LABEL_OS, OP_IN, list(spec["os"]))]
        if spec.get("instance_category"):
            reqs.append((wk.LABEL_INSTANCE_FAMILY, OP_IN,
                         families(config, spec["instance_category"])))
        if spec.get("instance_generation_gt") is not None:
            reqs.append((wk.LABEL_INSTANCE_GENERATION, OP_GT,
                         [str(spec["instance_generation_gt"])]))
        p = Provisioner(name=spec["name"],
                        consolidation_enabled=spec["consolidation"],
                        requirements=Requirements.of(*reqs))
        p.set_defaults()
        out.append(p)
    return out


class PodFactory:
    """Pods of the configuration's mix, built by the port's constructor:
    one template a deployment, each pod a fresh PodSpec with its own name,
    its own copy of the template's requirements and the template's labels
    (a mix entry's optional "labels", its pod template's metadata.labels)."""

    def __init__(self, config: dict):
        from karpenter_tpu_torch.apis import wellknown as wk
        from karpenter_tpu_torch.models.pod import (TopologySpreadConstraint,
                                                    make_pod)

        spread = (TopologySpreadConstraint(max_skew=1,
                                           topology_key=wk.LABEL_ZONE),)
        self.names = [d["name"] for d in config["mix"]]
        self.templates = [
            make_pod(d["name"], cpu=d["cpu"], memory=d["memory"] or "0",
                     node_selector={wk.LABEL_ZONE: d["zone"]}
                     if d["zone"] else None,
                     topology=spread if d["zone_spread"] else (),
                     labels=tuple(sorted(d.get("labels", {}).items())))
            for d in config["mix"]]

    def pods(self, record: dict) -> list:
        from karpenter_tpu_torch.models.pod import PodSpec

        out = []
        names, tpls = self.names, self.templates
        for d, tok in zip(record["order"].tolist(), record["tokens"].tolist()):
            t = tpls[d]
            out.append(PodSpec(name=pod_name(names[d], tok),
                               labels=t.labels,
                               requests=t.requests,
                               requirements=t.requirements.copy(),
                               topology=t.topology))
        return out


class System:
    """One SolverService with the configuration synced, as a controller's
    sidecar holds it."""

    def __init__(self, config: dict, device=None):
        from karpenter_tpu_torch.solver import wire
        from karpenter_tpu_torch.solver.service import SolverService

        self.config = config
        self.catalog = build_catalog(config)
        self.provisioners = build_provisioners(config)
        self.service = SolverService(device=device)
        self.key = (wire.catalog_key(self.catalog),
                    wire.provisioners_key(self.provisioners))
        self.service.sync(self.key, self.catalog, self.provisioners)
        self.pods = PodFactory(config)
        # the resident solver, whose counters each Solve renews
        self.solver = self.service.checkout(self.key)[0]
        self.service.checkin(self.key)

    @property
    def device_type(self) -> str:
        return self.service.device.type

    def inputs(self, record: dict):
        """The request's pods (built outside the timed call)."""
        return self.pods.pods(record)

    def call(self, record: dict, inputs) -> dict:
        """One Solve through the service, timed on the host around the call
        alone. -> t0/t1 (perf_counter s), t0_ns/t1_ns (the profiler's
        clock), answer (the key the reference is compared on) and counters
        (the program's phase times for the per-layer readers, and the rung
        that served it)."""
        import time

        t0_ns, t0 = time.time_ns(), time.perf_counter()
        res, info = self.service.solve(self.key, inputs)
        t1, t1_ns = time.perf_counter(), time.time_ns()
        counters = dict(self.solver.last_solve_info)
        counters["routing"] = info["routing"]
        answer = (res.decisions(), res.unschedulable_count())
        return {"t0": t0, "t1": t1, "t0_ns": t0_ns, "t1_ns": t1_ns,
                "answer": answer, "counters": counters}
