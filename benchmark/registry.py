"""Finding a cell's pieces by name.

`BENCHMARK.json` names each cell's configuration and traffic mix and each
metric. Under the benchmark's folder:

- a configuration is the file its entry names;
- a traffic mix is `traffic/<name>.json`, and the loop that drives it
  `loops/<its "loop">.py` (a `serve` function);
- the plain reference of a configuration is `reference/<its scoring
  "kind">.py` (a `Reference` class);
- how a configuration's index is set up is `setups/<its "setup"
  "name">.py` (a `build` function and an `alive` function), single.py
  where the configuration has no `setup`;
- a per-layer metric's reader is `metrics/<name>.py` (a `read` function).

So a later change adds a deployment, a scoring kind, a mix, a loop, a
set-up or a metric by adding files and entries, never by editing one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SINGLE = {"name": "single"}


def setup_of(cfg: dict) -> dict:
    """A configuration's `setup`: its name and parameters."""
    return cfg.get("setup", SINGLE)


class Registry:
    def __init__(self, bench_json=None, base=None, root=None):
        self.root = Path(root) if root else ROOT
        self.base = Path(base) if base else HERE
        path = Path(bench_json) if bench_json else self.root / "BENCHMARK.json"
        with open(path) as f:
            self.spec = json.load(f)

    @staticmethod
    def _named(entries, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.spec["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.spec["configs"], name, "config")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.base / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, workload: str) -> list:
        """The `end_to_end` or `per_layer` entries that a workload
        reports: those whose workloads key lists it, and those without the
        key: every end-to-end one, and the per-layer ones whose `moves`
        the workload reports."""
        def listed(m):
            return workload in m.get("workloads", [workload])

        if kind == "end_to_end":
            return [m for m in self.spec[kind] if listed(m)]
        e2e = {m["name"] for m in self.metrics("end_to_end", workload)}
        return [m for m in self.spec[kind]
                if listed(m) and ("workloads" in m or m["moves"] in e2e)]

    def _module(self, sub: str, name: str):
        """<sub>/<name>.py under the benchmark's folder, loaded as a member
        of the benchmark's <sub> package, so that its relative imports
        resolve there."""
        path = self.base / sub / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {sub} module named {name!r} ({path})")
        package = f"{__package__}.{sub}"
        importlib.import_module(package)
        safe = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"{package}.{safe}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, name: str):
        """The read(run) function of metrics/<name>.py."""
        return self._module("metrics", name).read

    def loop(self, name: str):
        """The serve(...) function of loops/<name>.py."""
        return self._module("loops", name).serve

    def reference(self, kind: str):
        """The Reference class of reference/<kind>.py."""
        return self._module("reference", kind).Reference

    def setup(self, name: str):
        """The build(eng, texts, cfg, seed) function of setups/<name>.py:
        it builds the index through the program's public API and returns
        the live documents' mask, or None where every drawn document is
        live."""
        return self._module("setups", name).build

    def alive(self, name: str):
        """The alive(cfg, n_docs, seed) function of setups/<name>.py: the
        mask its build returns, drawn without an engine (the control)."""
        return self._module("setups", name).alive
