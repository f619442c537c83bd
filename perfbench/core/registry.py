"""Everything a cell is made of, found by name under the checkout.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and traffic mixes, and the metrics.  Each piece is a file
of its own under ``perfbench/``, so that a new cell, configuration,
traffic mix or per-layer metric is a new file and never an edit:

- ``configs/<config>.json``: the model's sizes (the ``file`` of the
  configuration's entry), with a ``model`` key naming the kind;
- ``traffic/<traffic>.json``: the traffic mix's parameters, with a
  ``driver`` key naming the timed loop that reads them;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
- ``drivers/<driver>.py``: a timed loop (``Driver``);
- ``programs/<model>.py``: how the port's model is built from the
  configuration and the seed (``build``);
- ``reference/<model>.py``: the plain reference (``Reference``);
- ``costs/<model>.py``: the operation and byte counts (``Costs``);
- ``metrics/<metric>.py``: one reader a per-layer metric (``read``);
- ``rehearsal/<model>.py``: the model's rehearsal on the CPU, for the
  tests: ``SIZES`` (configuration keys set anew, small enough for the
  CPU) and ``half()`` (the fault that leaves out half of the catalog);
- ``rehearsal/<driver>.py``: the driver's rehearsal: ``CUT`` (traffic
  keys set anew, so that a rehearsal takes a few seconds on the CPU).
  Models and drivers share this folder, so no model takes a driver's
  name.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "perfbench")
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._modules: dict = {}

    # -- the cells and their files ----------------------------------------
    def cell(self, name: str) -> Cell:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"],
                            int(w["chips"]))
        known = ", ".join(w["name"] for w in self.spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return self._json(os.path.join(self.dir, "limits", f"{cell}.json"))

    @staticmethod
    def _json(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py``, loaded once."""
        key = (kind, name)
        mod = self._modules.get(key)
        if mod is None:
            path = os.path.join(self.dir, kind, f"{name}.py")
            if not os.path.exists(path):
                raise FileNotFoundError(f"no {kind} file {path}")
            mod_name = "perfbench_" + kind + "_" + "".join(
                ch if ch.isalnum() else "_" for ch in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return mod

    # -- which metrics a cell reports -------------------------------------
    def _reports(self, metric: dict, cell: str) -> bool:
        names = metric.get("workloads")
        return names is None or cell in names

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if self._reports(m, cell)]

    def per_layer(self, cell: str) -> list:
        """Without a ``workloads`` key a metric is reported in every cell
        that reports the end-to-end metric it moves."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
