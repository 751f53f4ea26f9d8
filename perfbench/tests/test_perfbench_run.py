"""Whole runs of the harness on the CPU (the look for a card skipped):
a sound run comes out correct; the fp8 control and every fault a
serving cell can have come out not correct. The card's own runs of the
control are ``test_perfbench_card.py``."""
import json

import pytest

from perfbench import run
from perfbench.tests import rig

SEED = 2 ** 32 + 11


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return rig.make_root(str(tmp_path_factory.mktemp('bench')))


def _run(capsys, root, cell, fault=None, *extra):
    argv = ['--workload', cell, '--seed', str(SEED), '--seconds', '3',
            '--trace', '0', *extra]
    assert run.main(argv, device='cpu', root=root, fault=fault) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', ['tiny-qwen.chat', 'tiny-mixtral.chat'])
def test_sound_run_is_correct_and_the_control_is_not(capsys, root, cell):
    out = _run(capsys, root, cell, None, '--control', '1')
    assert out['correct'] and out['failed'] == 0 and out['attempted'] > 0
    assert list(out)[-1] == 'compared'
    assert set(out['metrics']) >= {'setup_s', 'output_tok_s', 'ttft_p90_ms'}
    check = out['run']['check']
    assert check['control_gap'] > out['compared']['logit_gap']['limit']


@pytest.mark.parametrize('cell', ['tiny-qwen.chat', 'tiny-mixtral.chat'])
@pytest.mark.parametrize('fault', ['altered_token', 'stale_pool'])
def test_planted_fault_is_not_correct(capsys, root, fault, cell):
    out = _run(capsys, root, cell, f'perfbench.tests.faults:{fault}')
    assert not out['correct']
    gap = out['compared']['logit_gap']
    assert gap['value'] > gap['limit']


def test_no_card_no_result(capsys, root, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = ['--workload', 'tiny-qwen.chat', '--seed', '1', '--seconds', '1']
    assert run.main(argv, root=root) != 0
    assert capsys.readouterr().out.strip() == ''
