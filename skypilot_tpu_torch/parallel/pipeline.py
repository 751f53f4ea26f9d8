"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis
(port of ``skypilot_tpu/parallel/pipeline.py``).

The layer stack's leading axis is split over ``pp`` (rule ``'layers':
'pp'``), so each stage holds L/P contiguous layers; microbatched
activations flow stage to stage, and the tp/fsdp/sp collectives of each
stage stay inside its body.

- :func:`pipeline_layers`: M microbatches drain through P stages in
  M + P - 1 ticks. A stage whose tick carries no microbatch (a bubble)
  skips its body when ``skip_bubbles`` is on, which it is by default
  unless the stage body holds tp or sp collectives: as in the reference,
  such a stage computes every tick, and under pp x fsdp the stage's
  param all-gather is taken out of the skip and issued every tick, so
  every rank issues the same collectives in the same order. With
  ``with_aux`` the stage returns ``(y, aux)`` and the result's aux is
  the mean over the live (stage, microbatch) pairs (MoE's balancing
  loss).
- :func:`pipeline_decode_layers`: the cached forward chained through the
  stages in one wave (no microbatches): each stage runs its own layers
  against its own cache rows; every stage runs every hop and keeps only
  its live one, as the reference does. The serving engines have no pp
  (``MeshSpec.for_serving``), so nothing in the port calls it yet; the
  tests chain llama's layers through it.

Two runners, as ``ops/ring_attention.py`` has: ``mesh=None`` is this
rank of the active training mesh (``mesh.training()``: the stage's own
layers; a hop is one batch of point-to-point sends over the pp group,
and the result is all-reduced over pp so every stage holds it), and an
int or a ``MeshSpec`` is the lock-step runner, every stage in this
process over the whole layer stack (the op-level tests; the trainer
never selects it). :data:`stage_calls` counts the stage bodies run (the
reference times its bubble skip; a count does not flake).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from skypilot_tpu_torch.parallel import mesh as mesh_lib

# Stage bodies run, in this process (every stage under the lock-step
# runner; this rank's stage on a mesh).
stage_calls: Dict[str, int] = {'run': 0}


def reset_stage_calls() -> None:
    stage_calls['run'] = 0


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _stage_slice(tree: Any, pp: int, stage: int) -> Any:
    """Stage ``stage``'s contiguous layers of a stacked tree."""
    def cut(t):
        per = t.shape[0] // pp
        return t[stage * per:(stage + 1) * per]
    return _map(cut, tree)


class _Stages:
    """The stages this process computes, and how activations cross."""

    def __init__(self, mesh):
        if mesh is None:
            sc = mesh_lib.training()
            if sc is None:
                raise RuntimeError('pipeline outside a training mesh scope')
            self.sizes = dict(sc.mesh.shape)
            self.pp = self.sizes['pp']
            self.stages = [sc.mesh.axis_index('pp')]
            self.lockstep = False
        else:
            self.sizes = ({a: 1 for a in mesh_lib.MESH_AXES}
                          if isinstance(mesh, int)
                          else mesh_lib.mesh_axis_sizes(mesh))
            if isinstance(mesh, int):
                self.sizes['pp'] = mesh
            self.pp = self.sizes['pp']
            self.stages = list(range(self.pp))
            self.lockstep = True

    def forward_hop(self, ys: Dict[int, torch.Tensor]
                    ) -> Dict[int, torch.Tensor]:
        """Each stage's ``y`` to the next stage (the last's to stage 0)."""
        if self.lockstep:
            return {(r + 1) % self.pp: y for r, y in ys.items()}
        perm = {i: (i + 1) % self.pp for i in range(self.pp)}
        (me,) = self.stages
        (got,) = mesh_lib.exchange([ys[me]], [perm], axis='pp')
        return {me: got}

    def from_stage(self, values: Dict[int, Optional[torch.Tensor]],
                   src: int, like: torch.Tensor,
                   tail: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Stage ``src``'s value, held by every stage (differentiable: the
        gradient reaches ``src`` once). On a mesh another stage adds zero
        times its ``tail`` (its last activation), so its loss reaches
        every hop of its chain and the backward's sends run on every
        stage."""
        if self.lockstep:
            return values[src]
        (me,) = self.stages
        v = values[me] if me == src else torch.zeros_like(like) + (
            tail[me] * 0).sum()
        return mesh_lib.reduce_sum(v, 'pp')

    def total(self, values: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The sum over every stage of its value."""
        if self.lockstep:
            return sum(values.values())
        (me,) = self.stages
        return mesh_lib.reduce_sum(values[me], 'pp')


def pipeline_layers(layer_params: Any, x: torch.Tensor,
                    stage_fn: Callable, mesh=None, *,
                    num_microbatches: Optional[int] = None,
                    with_aux: bool = False,
                    skip_bubbles: Optional[bool] = None,
                    gather: Optional[Callable] = None) -> Any:
    """Apply the layer stack to ``x`` ([batch, ...]) through the GPipe
    schedule. ``stage_fn(stage_params, x_mb)`` applies one stage's layers
    to one microbatch (``(y, aux)`` with ``with_aux``, and then the
    result is ``(y, mean aux over the live stage-ticks)``).
    ``layer_params`` is the whole stack under the lock-step runner, this
    stage's layers on a mesh. ``gather(stage_params)`` (an fsdp mesh's
    param all-gather) is issued every tick, bubbles included, when the
    skip is on under fsdp; ``stage_fn(params, x_mb, gathered=True)`` then
    gets the gathered params."""
    drv = _Stages(mesh)
    P = drv.pp
    if P == 1:
        return stage_fn(layer_params, x)
    batch = x.shape[0]
    M = num_microbatches or P
    if batch % M:
        raise ValueError(f'batch {batch} not divisible into {M} '
                         'microbatches')
    safe = drv.sizes['tp'] == 1 and drv.sizes['sp'] == 1
    if skip_bubbles is None:
        skip_bubbles = safe
    elif skip_bubbles and not safe:
        raise ValueError(
            'skip_bubbles=True is unsafe with tp/sp > 1: the stage body '
            'contains tp/sp collectives that would diverge across the '
            'skipped and computed ticks and deadlock the ranks')
    hoist = skip_bubbles and drv.sizes['fsdp'] > 1 and gather is not None
    mbs = x.chunk(M)
    params = ({r: _stage_slice(layer_params, P, r) for r in drv.stages}
              if drv.lockstep else {drv.stages[0]: layer_params})
    recv = {r: torch.zeros_like(mbs[0]) for r in drv.stages}
    outputs: Dict[int, list] = {r: [None] * M for r in drv.stages}
    aux_acc = {r: torch.zeros((), dtype=torch.float32, device=x.device)
               for r in drv.stages}
    for t in range(M + P - 1):
        ys = {}
        for r in drv.stages:
            mb = t - r
            active = 0 <= mb < M
            x_in = mbs[min(t, M - 1)] if r == 0 else recv[r]
            if not drv.lockstep:
                # On a mesh every stage uses both inputs, the one it does
                # not take times zero: each hop's backward send, and the
                # embedding's gradient sum over pp, then run on every
                # stage.
                other = recv[r] if r == 0 else mbs[min(t, M - 1)]
                x_in = x_in + other * 0
            if hoist:
                # The stage's params gathered every tick, bubbles too.
                p, kw = gather(params[r]), {'gathered': True}
            else:
                p, kw = params[r], {}
            if active or not skip_bubbles:
                stage_calls['run'] += 1
                out = stage_fn(p, x_in, **kw)
                y, aux = out if with_aux else (out, None)
                if not active:
                    y = x_in          # a computed bubble passes x on
                elif aux is not None:
                    aux_acc[r] = aux_acc[r] + aux.float()
            else:
                y = x_in
            if active and r == P - 1:
                outputs[r][mb] = y
            ys[r] = y
        if t < M + P - 2:
            recv = drv.forward_hop(ys)
    out = drv.from_stage(
        {r: (torch.cat(outputs[r]) if r == P - 1 else None)
         for r in drv.stages}, P - 1, x, ys)
    if with_aux:
        return out, drv.total(aux_acc) / (P * M)
    return out


def pipeline_decode_layers(layer_params: Any, caches: Any,
                           x: torch.Tensor, stage_fn: Callable, mesh=None,
                           *, extras: Any = ()) -> Any:
    """The cached forward in one wave through the stages:
    ``stage_fn(stage_params, stage_caches, x, extras) -> (y, new_kv)``
    runs one stage's layers against its own cache rows (``caches``:
    stacked like ``layer_params``); the activation chains through the P
    stages. Returns ``(y, new_kv)``: ``y`` on every stage, ``new_kv``
    the stacked new rows (the whole stack under the lock-step runner,
    this stage's on a mesh). Every stage runs its body every hop and
    keeps only its live hop's result, as the reference does."""
    drv = _Stages(mesh)
    P = drv.pp
    if P == 1:
        return stage_fn(layer_params, caches, x, extras)
    if drv.lockstep:
        params = {r: _stage_slice(layer_params, P, r) for r in drv.stages}
        cache = {r: _stage_slice(caches, P, r) for r in drv.stages}
    else:
        params = {drv.stages[0]: layer_params}
        cache = {drv.stages[0]: caches}
    act = {r: x for r in drv.stages}
    kv: Dict[int, Any] = {}
    for hop in range(P):
        ys = {}
        for r in drv.stages:
            y, new_kv = stage_fn(params[r], cache[r], act[r], extras)
            stage_calls['run'] += 1
            if r == hop:
                kv[r] = new_kv
            else:
                y = act[r]
            ys[r] = y
        act = drv.forward_hop(ys)
    # After P hops the last stage's output is back at stage 0.
    y = drv.from_stage(act, 0, x, act)
    if drv.lockstep:
        new_kv = tuple(torch.cat([kv[r][i] for r in drv.stages])
                       for i in range(len(kv[0])))
        return y, new_kv
    return y, kv[drv.stages[0]]
