"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under the benchmark's folder (its first ``paths``
entry) one file per configuration (``configs/<config>.json``, named by
its ``file``), per traffic mix (``traffic/<mix>.json``, parameters), per
kind of traffic (``traffic/<kind>.py``, the generator that a mix's
``kind`` names: its class ``Traffic``), per cell's limits
(``limits/<workload>.json``) and per per-layer metric
(``metrics/<metric>.py``, a reader with ``read(ctx)``). A later change
adds a configuration, a mix, a kind, a cell or a metric as new files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    kind: Optional[type] = None
    readers: Dict = field(default_factory=dict)


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _covers(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(path: Path, prefix: str):
    """The module of one file found by name: a metric's reader
    (``read(ctx)`` and, optionally, ``ops``, the CPU ops whose recorded
    shapes it reads) or a kind of traffic (``Traffic``)."""
    mod_name = f"portbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not path.exists():
        raise FileNotFoundError(f"portbench: no {prefix} module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(base: Path, kind: str) -> type:
    """The generator class of the traffic kind ``kind``:
    ``traffic/<kind>.py``'s ``Traffic``."""
    return load_module(Path(base) / "traffic" / f"{kind}.py",
                       "traffic").Traffic


def load_cell(root: Path, workload: str, traffic: Optional[Dict] = None,
              config: Optional[Dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``. ``traffic`` and
    ``config`` replace entries of the mix and the configuration (the CPU
    rehearsals' small sizes and float32)."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    base = root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"portbench: no workload {workload!r} in "
                       f"{root / 'BENCHMARK.json'}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    cfg = _load_json(root / cfg_entry["file"])
    cfg.update(config or {})
    mix = _load_json(base / "traffic" / f"{w['traffic']}.json")
    mix.update(traffic or {})
    limits = _load_json(base / "limits" / f"{workload}.json")
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    # a per-layer metric without ``workloads`` goes with every cell that
    # reports the end-to-end metric it moves
    per_layer = [m for m in bench["per_layer"]
                 if _covers(m, workload) and _covers(end_to_end[m["moves"]],
                                                     workload)]
    cell = Cell(name=workload, chips=int(w["chips"]), config=cfg,
                traffic=mix, limits=limits,
                end_to_end=[m for m in end_to_end.values()
                            if _covers(m, workload)],
                per_layer=per_layer, kind=load_kind(base, mix["kind"]))
    cell.readers = {m["name"]: load_module(base / "metrics"
                                           / f"{m['name']}.py", "metric")
                    for m in per_layer}
    return cell
