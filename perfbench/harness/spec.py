"""What one cell is: its entry in ``BENCHMARK.json`` and the data files
that the harness finds by name.

- ``perfbench/configs/<config>.json``: the configuration (its HF
  ``config.json`` keys as run, ``source``, ``reduced``, ``assumed``);
- ``perfbench/traffic/<traffic>.json``: the traffic mix (lengths,
  sharing, arrivals), read by the one generator in ``traffic.py``;
- ``perfbench/cells/<cell>.json``: what belongs to the pair (the
  engine's batch and context, the offered rate or the client count, the
  ramp, the correctness limit), since one mix runs on several
  configurations at different knees;
- ``perfbench/metrics/<metric>.py``: one reader per metric, found by
  the metric's whole name, else by its name up to the first dot
  (``decode_step_ms.chat`` -> ``decode_step_ms.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Optional[List[str]]
    reader: Any                      # the module; ``read(ctx)``

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]           # the configuration file
    traffic: Dict[str, Any]          # the traffic file
    settings: Dict[str, Any]         # the cell's own file
    metrics: List[Metric]            # every metric this cell reports

    @property
    def hf(self) -> Dict[str, Any]:
        return self.config['config']

    def metrics_for(self, trace: bool) -> List[Metric]:
        return [m for m in self.metrics if m.end_to_end != trace]


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of metric ``name``."""
    for stem in (name, name.split('.')[0]):
        path = os.path.join(bench_dir, 'metrics', stem + '.py')
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f'perfbench_metric_{stem.replace(".", "_")}', path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if not callable(getattr(mod, 'read', None)):
                raise ValueError(f'{path} defines no read(ctx)')
            return mod
    raise FileNotFoundError(f'no reader for metric {name!r} under '
                            f'{os.path.join(bench_dir, "metrics")}')


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(os.path.join(root, 'BENCHMARK.json'))
    bench_dir = os.path.join(root, 'perfbench')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                       f'{sorted(cells)}')
    w = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    cfg_entry = configs[w['config']]
    config = _load_json(os.path.join(root, cfg_entry['file']))
    traffic = _load_json(os.path.join(bench_dir, 'traffic',
                                      w['traffic'] + '.json'))
    settings = _load_json(os.path.join(bench_dir, 'cells', name + '.json'))
    metrics = []
    for kind, e2e in (('end_to_end', True), ('per_layer', False)):
        for m in bench[kind]:
            metric = Metric(m['name'], m['unit'], m['better'], m['source'],
                            e2e, m.get('workloads'), None)
            if metric.applies(name):
                metric.reader = load_reader(m['name'], bench_dir)
                metrics.append(metric)
    return Cell(name, int(w['chips']), w['config'], w['traffic'], config,
                traffic, settings, metrics)
