"""The reference's answer to one request record, in the form the runner
compares with the program's: a Solve's sorted decisions (type, zone,
capacity type, pods) and unschedulable count.

`control` answers with one guarantee of the configuration broken, the
change a later optimisation might be tempted by: a node's offering is
admitted from the raw catalog, its capacity taken for its allocatable and
the provisioner's architecture unchecked. The control's answers have to
fail the comparison.
"""

from __future__ import annotations

import os

from ..generator import ROOT, cpu_millis, first_names, mem_mib
from . import scheduler
from .catalog import build_options, load_catalog


class Reference:
    def __init__(self, config: dict):
        self.config = config
        cat = config["catalog"]
        self.types = load_catalog(os.path.join(ROOT, cat["file"]))
        self.options = build_options(self.types, cat["zones"],
                                     cat["spot_discount"])
        self.raw_options = build_options(self.types, cat["zones"],
                                         cat["spot_discount"], raw=True)
        self.provisioners = [self._provisioner(p) for p in
                             config["provisioners"]]
        every_arch = tuple(sorted({t["arch"] for t in self.types}))
        self.control_provisioners = [
            self._provisioner(p, arch=every_arch)
            for p in config["provisioners"]]

    @staticmethod
    def _provisioner(p: dict, arch=None) -> scheduler.Provisioner:
        cats = p.get("instance_category")
        return scheduler.Provisioner(
            p["name"], tuple(p["capacity_types"]),
            tuple(arch or p["arch"]), p.get("weight", 0),
            tuple(cats) if cats else None, p.get("instance_generation_gt"))

    def answer(self, record: dict, control: bool = False):
        mix = self.config["mix"]
        specs = [dict(name=name, cpu=cpu_millis(d["cpu"]),
                      memory=mem_mib(d["memory"]), zone=d["zone"],
                      spread=d["zone_spread"], count=int(c))
                 for d, c, name in zip(mix, record["counts"],
                                       first_names(self.config, record))
                 if c > 0]
        options = self.raw_options if control else self.options
        groups = scheduler.prepare_groups(specs, options.zones)
        res = scheduler.schedule(
            options,
            self.control_provisioners if control else self.provisioners,
            groups)
        return res.decisions, res.unschedulable
