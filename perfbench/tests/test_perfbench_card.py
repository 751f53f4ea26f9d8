"""On the card: each cell's control at the cell's own size.

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py

For three seeds a cell runs once, briefly, at its own load, and the
same sampled requests are read by the program (must be correct) and by
the fp8 control (must read above the limit). Skips without a card.
"""
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness.spec import ROOT

pytestmark = pytest.mark.cuda

CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]
SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_where_the_program_passes(card, cell, seed):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'perfbench', 'run.py'),
         '--workload', cell, '--seed', str(seed), '--seconds', '10',
         '--trace', '0', '--control', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    gap = out['compared']['logit_gap']
    assert out['correct'], gap
    assert out['run']['check']['control_gap'] > gap['limit']
