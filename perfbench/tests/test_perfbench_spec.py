"""BENCHMARK.json against the contract's shape, and the harness
finding a cell, a mix and a metric that were added as files only."""
import json
import os
import re

import pytest

from perfbench.harness import spec
from perfbench.harness.spec import BENCH_DIR, ROOT
from perfbench.tests import rig

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_shape_of_benchmark_json():
    b = _bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['perfbench'] and 1 <= b['run_seconds'] <= 51
    assert 2 + 14 * 24 <= 43200
    names = set()
    for c in b['configs']:
        assert NAME.match(c['name']) and c['file'].startswith('perfbench/')
        assert all(NAME.match(k) for k in c['reduced'])
        names.add(c['name'])
    for w in b['workloads']:
        assert NAME.match(w['name']) and w['config'] in names
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
    e2e = {m['name'] for m in b['end_to_end']}
    assert 'setup_s' in e2e
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in b['per_layer']:
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def test_every_cell_loads_with_a_reader_per_metric():
    b = _bench()
    for w in b['workloads']:
        cell = spec.load_cell(w['name'])
        e2e = [m.name for m in cell.metrics_for(False)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert cell.metrics_for(True)
        for m in cell.metrics:
            assert m.reader.SOURCE == m.source, m.name


def test_per_layer_metric_moves_what_each_of_its_cells_reports():
    b = _bench()
    reports = {w['name']: {m['name'] for m in b['end_to_end']
                           if 'workloads' not in m
                           or w['name'] in m['workloads']}
               for w in b['workloads']}
    for m in b['per_layer']:
        for cell in m.get('workloads', reports):
            assert m['moves'] in reports[cell], (m['name'], cell)


def test_reader_found_by_whole_name_then_stem(tmp_path):
    assert spec.load_reader('decode_step_ms.chat').__name__.endswith(
        'decode_step_ms')
    with pytest.raises(FileNotFoundError):
        spec.load_reader('no_such_metric')


def test_cell_mix_and_metric_added_as_files_only(tmp_path):
    root = rig.make_root(str(tmp_path))
    pb = os.path.join(root, 'perfbench')
    mix = dict(rig.MIX, output={'dist': 'uniform', 'min': 2, 'max': 3})
    with open(os.path.join(pb, 'traffic', 'tiny2.json'), 'w') as f:
        json.dump(mix, f)
    with open(os.path.join(pb, 'cells', 'tiny-qwen.tiny2.json'), 'w') as f:
        json.dump(rig.CELL, f)
    with open(os.path.join(pb, 'metrics', 'requests_seen.py'), 'w') as f:
        f.write("SOURCE = 'host_clock'\n\n\ndef read(run):\n"
                "    return float(len(run.window))\n")
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        b = json.load(f)
    b['workloads'].append({'name': 'tiny-qwen.tiny2', 'config': 'tiny-qwen',
                           'traffic': 'tiny2', 'chips': 1, 'why': 'test'})
    b['end_to_end'].append({'name': 'requests_seen', 'unit': 'requests',
                            'better': 'higher', 'bound': 0.01,
                            'source': 'host_clock',
                            'workloads': ['tiny-qwen.tiny2']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(b, f)
    cell = spec.load_cell('tiny-qwen.tiny2', root=root)
    assert cell.traffic['output']['max'] == 3
    assert 'requests_seen' in [m.name for m in cell.metrics_for(False)]
    other = spec.load_cell('tiny-qwen.chat', root=root)
    assert 'requests_seen' not in [m.name for m in other.metrics]
