"""The JAX package and JAX itself stay out of every benchmark process.

Module names are compared by their top-level name, whole: the port's
package (``skypilot_tpu_torch``) begins with the JAX package's name
(``skypilot_tpu``) and is not it.
"""
from __future__ import annotations

import ast
import sys
from typing import Iterable, List

# Never loaded by a benchmark process.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'skypilot_tpu')
# Never imported by the plain reference.
PROGRAM = 'skypilot_tpu_torch'


def top_level(name: str) -> str:
    return name.split('.', 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = {top_level(m) for m in (sys.modules if modules is None
                                     else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def imported_names(source: str) -> List[str]:
    """Top-level names of the modules a Python source imports
    (absolute imports; a relative import names no top level)."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top_level(node.module))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.add(top_level(node.args[0].value))
    return sorted(out)
