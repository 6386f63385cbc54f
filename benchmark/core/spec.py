"""The benchmark's description, and the files it names, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and the metrics. Every piece lives in a file
of its own, found from its name alone, so that a new configuration, mix or
metric is a new file and a new entry, with no existing file edited:

* ``configs`` entry ``file``: the configuration's sizes, and the name of
  the generator that makes its inputs, ``benchmark/gen/<generator>.py``;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, with the name
  of the call it drives, ``benchmark/calls/<call>.py``;
* ``benchmark/limits/<workload>.json``: the limit of each number that the
  cell's comparison reports;
* ``benchmark/e2e/<metric>.py`` and ``benchmark/metrics/<metric>.py``: one
  reader each, of an end-to-end and of a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json and benchmark/

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, breaks the benchmark's rules."""


def _line(text: Any, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        raise SpecError(f"{what}: {text!r} is not 1 to 200 characters on one line")


def _name(text: Any, what: str) -> None:
    if not isinstance(text, str) or not NAME.fullmatch(text):
        raise SpecError(f"{what}: {text!r} is not a name (a letter, digit or _, then up to 63 of those, . and -)")


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``, and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- lookups by name -----------------------------------------------------
    def cell(self, workload: str) -> Dict[str, Any]:
        for cell in self.data["workloads"]:
            if cell["name"] == workload:
                return cell
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise SpecError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.bench / "limits" / f"{workload}.json").read_text())["limits"]

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py``, loaded from its path (a name may
        hold ``-`` and ``.``), once per process."""
        key = f"_bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name) + f"_{abs(hash(str(self.bench)))}"
        if key in sys.modules:
            return sys.modules[key]
        path = self.bench / kind / f"{name}.py"
        if not path.is_file():
            raise SpecError(f"{kind} {name!r}: no file {path.relative_to(self.root)}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def end_to_end(self, workload: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict[str, Any]]:
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload]) and m["moves"] in reported]

    # -- the rules -----------------------------------------------------------
    def validate(self) -> None:
        """Raise :class:`SpecError` where BENCHMARK.json, or a file that it
        names, breaks the benchmark's rules of names, units and keys."""
        d = self.data
        keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
        if set(d) != keys:
            raise SpecError(f"BENCHMARK.json keys {sorted(d)} are not {sorted(keys)}")
        if not (isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51):
            raise SpecError("run_seconds is not a whole number from 1 to 51")
        for word in d["command"]:
            _line(word, "command")
        for path in d["paths"]:
            if not re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) or path.startswith("/") or ".." in path.split("/"):
                raise SpecError(f"path {path!r}")
        seen = set()
        for cfg in d["configs"]:
            if set(cfg) != {"name", "source", "file", "reduced", "why"}:
                raise SpecError(f"configuration keys {sorted(cfg)}")
            _name(cfg["name"], "configuration")
            _line(cfg["source"], "source")
            _line(cfg["why"], "why")
            for key in cfg["reduced"]:
                _name(key, "reduced")
            if not any(cfg["file"].startswith(p.rstrip("/") + "/") for p in d["paths"]):
                raise SpecError(f"{cfg['file']} is not under paths")
            self.config(cfg["name"])
        names = {c["name"] for c in d["configs"]}
        pairs = set()
        for cell in d["workloads"]:
            if set(cell) != {"name", "config", "traffic", "chips", "why"}:
                raise SpecError(f"workload keys {sorted(cell)}")
            for key in ("name", "config", "traffic"):
                _name(cell[key], f"workload {key}")
            _line(cell["why"], "why")
            if cell["config"] not in names or cell["chips"] not in (1, 4):
                raise SpecError(f"workload {cell['name']}: configuration or chips")
            if (cell["config"], cell["traffic"]) in pairs:
                raise SpecError(f"workload {cell['name']}: its configuration and traffic appear twice")
            pairs.add((cell["config"], cell["traffic"]))
            self.module("calls", self.traffic(cell["traffic"])["call"])
            self.limits(cell["name"])
        cells = {c["name"] for c in d["workloads"]}
        for group, sources in (("end_to_end", E2E_SOURCES), ("per_layer", SOURCES)):
            for m in d[group]:
                allowed = {"name", "unit", "better", "source", "workloads"}
                allowed |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
                if not set(m) - {"workloads"} <= allowed or not (allowed - {"workloads"}) <= set(m):
                    raise SpecError(f"{group} {m.get('name')}: keys {sorted(m)}")
                _name(m["name"], group)
                if not UNIT.fullmatch(m["unit"]) or m["better"] not in ("lower", "higher") or m["source"] not in sources:
                    raise SpecError(f"{group} {m['name']}: unit, better or source")
                if not set(m.get("workloads", [])) <= cells:
                    raise SpecError(f"{group} {m['name']}: unknown workloads")
                if group == "per_layer":
                    _line(m["layer"], "layer")
                self.module("e2e" if group == "end_to_end" else "metrics", m["name"])
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for m in d[group]:
                if m["name"] in seen:
                    raise SpecError(f"the name {m['name']} is used twice")
                seen.add(m["name"])
