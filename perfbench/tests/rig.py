"""A checkout of tiny cells for the harness's CPU tests.

``make_root(tmp)`` writes a ``BENCHMARK.json`` and ``perfbench/`` data
files (configurations at a tiny width, a short chat-like mix, cells of
a few slots) under ``tmp``, with the real metric readers copied in, so
``run.main(..., device='cpu', root=tmp)`` drives the whole harness
against the port on the CPU in seconds.
"""
from __future__ import annotations

import json
import os
import shutil

from perfbench.harness.spec import BENCH_DIR

TINY_QWEN = {
    'architectures': ['Qwen2ForCausalLM'], 'model_type': 'qwen2',
    'hidden_size': 64, 'intermediate_size': 128, 'num_hidden_layers': 2,
    'num_attention_heads': 4, 'num_key_value_heads': 2,
    'rms_norm_eps': 1e-6, 'rope_theta': 1000000.0, 'vocab_size': 256,
    'tie_word_embeddings': False, 'max_position_embeddings': 512}
TINY_MIXTRAL = {
    'architectures': ['MixtralForCausalLM'], 'model_type': 'mixtral',
    'hidden_size': 64, 'intermediate_size': 96, 'num_hidden_layers': 2,
    'num_attention_heads': 4, 'num_key_value_heads': 2,
    'num_local_experts': 4, 'num_experts_per_tok': 2,
    'rms_norm_eps': 1e-5, 'rope_theta': 1000000.0, 'vocab_size': 256,
    'tie_word_embeddings': False, 'max_position_embeddings': 512}

MIX = {'why': 'tiny chat',
       'prompt': {'shared': {'lengths': [32, 48], 'zipf_s': 1.0},
                  'unique': {'dist': 'lognormal', 'median': 12,
                             'sigma': 0.8, 'min': 4, 'max': 40}},
       'output': {'dist': 'uniform', 'min': 8, 'max': 48},
       'arrivals': 'poisson'}

CELL = {'engine': {'max_batch': 4, 'max_seq': 160},
        'arrivals': {'rate_per_s': 3.0}, 'ramp_s': 1.0, 'cap_s': 60,
        'slice_s': 1.0,
        'check': {'logit_gap': 0.05, 'tie_margin': None, 'min_tokens': 40,
                  'max_requests': 6}}


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str, extra_cells=()) -> str:
    """A checkout under ``tmp`` holding the cells ``tiny-qwen.chat`` and
    ``tiny-mixtral.chat`` (and ``extra_cells``: (name, config, traffic,
    settings) tuples whose files the caller writes)."""
    pb = os.path.join(tmp, 'perfbench')
    shutil.copytree(os.path.join(BENCH_DIR, 'metrics'),
                    os.path.join(pb, 'metrics'))
    configs = []
    for name, hf, port in (('tiny-qwen', TINY_QWEN, {}),
                           ('tiny-mixtral', TINY_MIXTRAL,
                            {'moe_capacity_factor': 2.0})):
        _write(os.path.join(pb, 'configs', name + '.json'),
               {'name': name, 'source': 'test', 'config': hf,
                'reduced': {}, 'assumed': {}, 'port_config': port})
        configs.append({'name': name, 'source': 'test',
                        'file': f'perfbench/configs/{name}.json',
                        'reduced': [], 'why': 'test'})
    _write(os.path.join(pb, 'traffic', 'chat.json'), MIX)
    cells = [('tiny-qwen.chat', 'tiny-qwen', 'chat'),
             ('tiny-mixtral.chat', 'tiny-mixtral', 'chat')]
    for name, _, _ in cells:
        settings = dict(CELL)
        if 'mixtral' in name:
            settings['check'] = dict(CELL['check'], tie_margin=0.01)
        _write(os.path.join(pb, 'cells', name + '.json'), settings)
    workloads = [{'name': n, 'config': c, 'traffic': t, 'chips': 1,
                  'why': 'test'} for n, c, t in list(cells)
                 + [tuple(e[:3]) for e in extra_cells]]
    with open(os.path.join(os.path.dirname(BENCH_DIR),
                           'BENCHMARK.json')) as f:
        bench = json.load(f)
    for kind in ('end_to_end', 'per_layer'):
        for m in bench[kind]:
            m.pop('workloads', None)
    bench.update(configs=configs, workloads=workloads)
    _write(os.path.join(tmp, 'BENCHMARK.json'), bench)
    return tmp
