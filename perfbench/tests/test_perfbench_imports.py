"""No benchmark module imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: the port's package name begins with the JAX package's."""
import os

from perfbench.harness import imports
from perfbench.harness.spec import BENCH_DIR


def _sources(sub=''):
    root = os.path.join(BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    yield path, imports.imported_names(fh.read())


def test_no_jax_anywhere():
    seen = 0
    for path, names in _sources():
        seen += 1
        bad = set(names) & set(imports.FORBIDDEN)
        assert not bad, f'{path} imports {sorted(bad)}'
    assert seen > 20


def test_reference_imports_nothing_of_the_program():
    for path, names in _sources('reference'):
        assert imports.PROGRAM not in names, path
        assert set(names) <= {'__future__', 'dataclasses', 'hashlib',
                              'itertools',
                              'typing', 'torch', 'perfbench'}, (path, names)


def test_names_compare_whole():
    assert imports.top_level('skypilot_tpu_torch.serve.server') == \
        'skypilot_tpu_torch'
    assert imports.forbidden_loaded(['skypilot_tpu_torch.models']) == []
    assert imports.forbidden_loaded(['skypilot_tpu.models', 'jax.numpy',
                                     'jaxlib', 'flaxen']) == \
        ['jax', 'jaxlib', 'skypilot_tpu']
    assert imports.imported_names(
        'import skypilot_tpu_torch.ops\nfrom jax import numpy\n'
        'import importlib\nimportlib.import_module("flax.linen")') == \
        ['flax', 'importlib', 'jax', 'skypilot_tpu_torch']
