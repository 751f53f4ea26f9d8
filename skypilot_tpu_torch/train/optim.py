"""The trainer's optimizer: the port of ``make_optimizer``
(``skypilot_tpu/train/trainer.py``), which is ``optax.chain(
clip_by_global_norm, adamw(warmup_cosine_decay_schedule, ...))``,
written op by op on tensors as optax 0.2.6 computes it.

``torch.optim.AdamW`` is not that optimizer: it keeps both moments in
the params' dtype and orders its arithmetic differently. Here:

- **Clipping**: ``g if norm < max_norm else g / norm * max_norm`` (the
  select form), with ``norm`` the raw global norm; each leaf's square
  sum is taken in the leaf's dtype, as ``optax.global_norm`` does.
- **Learning rate**: warmup from 0 to the peak over the (clamped) warmup
  steps, then cosine decay to a tenth of the peak, evaluated at the
  count BEFORE the increment (step 0 under warmup has lr 0), in fp32.
- **Adam**: ``mu`` in ``mu_dtype``, ``nu`` in each param's dtype, bias
  correction by ``count + 1``, ``eps`` 1e-8, ``eps_root`` 0.
- **Decay and update**: decoupled weight decay ``u + wd * p`` on every
  leaf, then ``-lr * u``, then ``(p + u)`` cast back to p's dtype.

Each scalar enters an op in the dtype of the tensor it meets (JAX's
weakly typed Python scalars), so a bf16 leaf rounds where optax's does.
Updates are written IN PLACE into the params and the moments (the
reference's step donates its state the same way).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

Tree = Dict[str, Any]
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class AdamWState(NamedTuple):
    count: int          # optimizer steps taken (optax's int32 count)
    mu: Tree            # first moments, mu_dtype
    nu: Tree            # second moments, each param's dtype


def tree_leaves(tree: Tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: (tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _w(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type meets ``like``: rounded to
    ``like``'s dtype first."""
    return torch.tensor(x, dtype=like.dtype)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(sum of squares), each leaf's sum in its own dtype and the
    leaves added in ``jax.tree.leaves`` order (``optax.global_norm``)."""
    return torch.sqrt(sum((x * x).sum() for x in tree_leaves(tree)))


def warmup_cosine_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], np.float32]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, total,
    end_value=peak / 10)`` with the reference's clamp of the warmup
    below the step budget, in fp32."""
    f32 = np.float32
    warmup = min(warmup_steps, max(total_steps - 1, 0))
    peak, end = learning_rate, learning_rate * 0.1
    alpha = 0.0 if peak == 0.0 else end / peak
    decay_steps = total_steps - warmup
    if decay_steps <= 0:
        raise ValueError('the cosine decay needs total_steps > warmup '
                         f'steps, got {total_steps} <= {warmup}')

    def lr(count: int) -> np.float32:
        if count < warmup:                       # linear 0 -> peak
            frac = f32(1) - f32(count) / f32(warmup)
            return f32(0.0 - peak) * frac + f32(peak)
        c = min(f32(count - warmup), f32(decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(decay_steps)))
        return f32(peak) * (f32(1 - alpha) * cosine + f32(alpha))

    return lr


class AdamW:
    """clip_by_global_norm(clip) then AdamW(schedule) (see the module
    docstring); ``update`` also returns the raw global norm."""

    def __init__(self, *, learning_rate: float, warmup_steps: int,
                 total_steps: int, weight_decay: float, b1: float,
                 b2: float, grad_clip_norm: float, mu_dtype: str,
                 eps: float = 1e-8):
        if mu_dtype not in _DTYPES:
            raise ValueError(f'mu_dtype {mu_dtype!r}: use one of '
                             f'{sorted(_DTYPES)}')
        self.lr = warmup_cosine_schedule(learning_rate, warmup_steps,
                                         total_steps)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip = grad_clip_norm
        self.mu_dtype = _DTYPES[mu_dtype]

    def init(self, params: Tree) -> AdamWState:
        return AdamWState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                        params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree,
               norm: Optional[torch.Tensor] = None):
        """One step: params, mu and nu updated in place. Returns (the new
        state, the global norm of ``grads`` before clipping). ``norm``
        is that global norm when the caller computed it (a training
        mesh's, over every rank's shards); by default it is ``grads``'s
        own."""
        f32 = np.float32
        b1, b2 = self.b1, self.b2
        if norm is None:
            norm = global_norm(grads)
        keep = norm < self.clip
        count = state.count + 1
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        step_size = float(f32(-1) * self.lr(state.count))

        def leaf(g, p, mu, nu):
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * _w(self.clip, g))
            mu_new = _w(1 - b1, g) * g + _w(b1, mu) * mu
            nu_new = _w(1 - b2, g) * (g * g) + _w(b2, nu) * nu
            mu_hat = mu_new / _w(bc1, mu_new)
            nu_hat = nu_new / _w(bc2, nu_new)
            u = mu_hat / (torch.sqrt(nu_hat) + _w(self.eps, nu_hat))
            u = u + _w(self.weight_decay, p) * p
            u = _w(step_size, u) * u
            p.copy_(p + u)
            mu.copy_(mu_new)
            nu.copy_(nu_new)

        tree_map(leaf, grads, params, state.mu, state.nu)
        return state._replace(count=count), norm
