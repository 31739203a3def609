"""The benchmark's description, found by name.

``BENCHMARK.json`` at the root of a checkout lists the cells, configurations
and metrics. Everything particular to one of them lives in a file of its
own, found by its name:

  * a configuration: ``portbench/configs/<config>.json`` (the file
    ``BENCHMARK.json`` names), in the keys its family reads; its
    ``"family"`` names the model family, ``"llama"`` where it names none;
  * a model family: ``portbench/families/<family>.py``, which gives

      - ``dims(cfg)``: the shapes the harness and the family's readers
        use, with at least ``vocab`` (the traffic draws its ids below it);
      - ``make_weights(dims, seed, device)``: every weight, made from the
        seed on the device, as one dict of tensors;
      - ``Reference(weights, cfg, precision="fp32"|"fp8")``, whose
        ``.logits(seqs, first_rows)`` gives float32 logits: the plain
        reference that decides ``correct``, and (``"fp8"``) its control;
        plain ``torch`` in a file that imports nothing of the port;
      - ``program(weights, cfg_path, context, device, fused)``: the port's
        ``LoadedModel`` over those weights, for the entries to serve;

    a family's work counts live beside its own per-layer readers
    (``portbench/yardstick.py`` holds the Llama block's);
  * a traffic mix: ``portbench/mixes/<traffic>.json``, read by the one
    generator (``portbench/traffic.py``); it names its entry, the program's
    object it drives: ``portbench/entries/<entry>.py``, whose ``ENTRY`` is
    the class;
  * a cell's correctness limits: ``portbench/limits/<cell>.json``;
  * a per-layer metric: ``portbench/metrics/<metric>.py``, whose ``read(rec)``
    takes the metric from a run's record and returns ``None`` when it finds
    nothing to read.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; no file here changes. A configuration of another
architecture enters as added files too: its configuration file naming its
``family``, ``portbench/families/<family>.py``, a mix that names an
existing entry (or a new entry file), ``portbench/limits/<cell>.json``,
the family's per-layer readers under ``portbench/metrics/``, and the
cell's entries in ``BENCHMARK.json``, the one file that changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None


@dataclass(frozen=True)
class Family:
    """A model family's four parts (``portbench/families/<name>.py``)."""

    name: str
    dims: Callable
    weights: Callable             # the family's ``make_weights``
    Reference: type
    program: Callable


FAMILY_PARTS = ("dims", "make_weights", "Reference", "program")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    config_path: Path
    family: Family
    mix: Dict
    limits: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.bench_dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    @property
    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def _metrics(self, key: str) -> List[Metric]:
        return [Metric(name=m["name"], unit=m["unit"], workloads=m.get("workloads"),
                       moves=m.get("moves"))
                for m in self.spec[key]]

    def cell(self, name: str) -> Cell:
        try:
            w = next(w for w in self.spec["workloads"] if w["name"] == name)
        except StopIteration:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{self.cell_names}") from None
        c = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        config_path = self.root / c["file"]
        e2e = [m for m in self._metrics("end_to_end")
               if m.workloads is None or name in m.workloads]
        layer = []
        for m in self._metrics("per_layer"):
            if m.workloads is None:
                raise ValueError(f"per-layer metric {m.name!r} lists no workloads: the "
                                 "harness reads a metric in the cells it lists")
            if name in m.workloads:
                layer.append(m)
        limits_path = self.bench_dir / "limits" / f"{name}.json"
        config = json.loads(config_path.read_text())
        return Cell(name=name, chips=w["chips"], config=config, config_path=config_path,
                    family=self.family(config.get("family", "llama")),
                    mix=json.loads((self.bench_dir / "mixes" / f"{w['traffic']}.json")
                                   .read_text()),
                    limits=json.loads(limits_path.read_text()),
                    end_to_end=e2e, per_layer=layer)

    def _load(self, kind: str, name: str):
        path = self.bench_dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench.{kind}." + name.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable:
        """The ``read(rec)`` of ``portbench/metrics/<metric>.py``."""
        return self._load("metrics", metric).read

    def entry(self, name: str) -> Callable:
        """The ``ENTRY`` class of ``portbench/entries/<name>.py``."""
        return self._load("entries", name).ENTRY

    def family(self, name: str) -> Family:
        """The model family of ``portbench/families/<name>.py``."""
        path = self.bench_dir / "families" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no model family {name!r}: {path} does not exist")
        module = self._load("families", name)
        missing = [p for p in FAMILY_PARTS if not hasattr(module, p)]
        if missing:
            raise AttributeError(f"the model family {name!r} ({path}) lacks {missing}")
        return Family(name, module.dims, module.make_weights, module.Reference,
                      module.program)
