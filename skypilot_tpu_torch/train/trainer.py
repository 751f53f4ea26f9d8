"""The trainer (port of ``skypilot_tpu/train/trainer.py``): on one
device, or on a training mesh.

One train step: the causal-LM loss (fp32 logits, masked cross-entropy)
through ``llama.forward`` with the configured attention (K4 forward and
K5a/K5b backward on CUDA under ``attn_impl='auto'``) and remat policy,
``torch.autograd.grad`` for the gradients, then the optimizer of
``train/optim.py`` (global-norm clipping and AdamW with fp32 or bf16
first moments), updating params and moments in place. Tied embeddings
(Gemma) have no ``unembed`` leaf: ``embed`` takes its gradient from the
gather and the unembedding both.

A LoRA config (``lora_rank > 0``) trains only the adapter subtree
(``lora.split_lora``): only those leaves require grad, so the frozen
base gets neither a weight gradient nor the memory for one; the
optimizer's moments are adapter-sized and its weight decay is
``lora_weight_decay``; the base stays unchanged bit for bit.
``save_adapter``/``load_adapter`` write and read the adapters alone
with the reference's ``.lora.json`` sidecar. For serving, the trained
tree goes through ``multilora.save_adapter`` to the bank's ``.npz``.

**On a mesh** (``mesh_spec=`` or ``mesh=``, ``parallel/mesh.py``): the
reference's single-controller API over one process per rank. The
trainer in the calling process is rank 0; ``mesh_spec=`` starts the
other ranks (``mesh.make_mesh``), and every trainer call that touches
state (``init``, ``state_from_params``, ``init_from_pretrained``,
``step``, the checkpoints, ``full_params``) is sent to the followers
first, so every rank runs it on its own shard. A state crosses the
control channel as a reference to each rank's own copy; a batch
crosses it whole (int32 tokens) and each rank takes its rows over the
data axes ``('slice', 'dp', 'fsdp')`` and its sequence block over
``sp``. Each rank holds its shard of the params and of the optimizer
moments by the logical axes and the divisibility-aware ``spec_for``;
the step (``mesh.training()`` scope):

- **fsdp**: each layer's shards are all-gathered before use (again in
  the backward under remat), their gradients reduce-scattered;
- **dp and slice** (and **sp**): gradients all-reduced, each leaf over
  the data axes its gather did not already sum;
- **tp**: heads, kv heads, mlp and vocab split, with the
  column/row-parallel Function pair (``mesh.tp_copy`` /
  ``mesh.reduce_partial``) whose collectives mirror each other;
- **the loss**: the vocab-parallel cross-entropy (a max all-reduce, a
  sum-exp all-reduce and the target logit from its owning shard; the
  accuracy's argmax across shards breaks ties as ``argmax`` does) over
  the global ``mask.sum()``; MoE's aux loss is the whole batch's, each
  rank adding its share;
- **the norm**: ``grad_norm`` and the clip use the global norm, each
  shard's squares summed once (a replicated leaf by one rank);
- **sp**: the sequence split; attention per ``attn_impl`` (ring,
  Ulysses, or the gathered-kv plain path; ``ops/attention.py``).

``init(seed)`` under a mesh gives the meshless ``init(seed)``'s params,
each rank holding its cut. Checkpoints keep the single-device format:
rank 0 writes the gathered state and a restore cuts each rank's shard,
so a mesh checkpoint resumes meshless and the reverse.

- **pp**: the layer stack split into pp stages of equal contiguous
  blocks, run as the GPipe schedule (``parallel/pipeline.py``, pp
  microbatches; each rank's rows are its block of every global
  microbatch, so MoE routes each microbatch as the reference does); the
  embedding's gradient, which only stage 0 takes, is summed over pp.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import llama, lora, weights
from skypilot_tpu_torch.models.configs import ModelConfig, check_supported
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train.optim import (AdamW, AdamWState, tree_leaves,
                                            tree_map)
from skypilot_tpu_torch.utils.device import (DeviceLike, host_scalars,
                                             resolve_device)

CHECKPOINT_FILE = 'state.pt'
ADAPTER_FILE = 'adapter.pt'


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip_norm: float = 1.0
    attn_impl: str = 'auto'
    moe_aux_weight: float = 0.01
    # Adam first-moment dtype; the second moment stays in each param's
    # dtype, as optax keeps it.
    mu_dtype: str = 'float32'
    # The adapters' weight decay under LoRA (the frozen base takes no
    # update at all, so ``weight_decay`` never touches it).
    lora_weight_decay: float = 0.0


def make_optimizer(tc: TrainConfig,
                   weight_decay: Optional[float] = None) -> AdamW:
    """The trainer's optimizer; ``weight_decay`` overrides
    ``tc.weight_decay`` (the LoRA trainer passes
    ``tc.lora_weight_decay``)."""
    return AdamW(learning_rate=tc.learning_rate,
                 warmup_steps=tc.warmup_steps, total_steps=tc.total_steps,
                 weight_decay=(tc.weight_decay if weight_decay is None
                               else weight_decay),
                 b1=tc.b1, b2=tc.b2, grad_clip_norm=tc.grad_clip_norm,
                 mu_dtype=tc.mu_dtype)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            attn_impl: str = 'auto', moe_aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss plus ``moe_aux_weight`` times the MoE
    load-balancing aux (its mean over layers; 0 for a dense model),
    logged as ``moe_aux_loss``.

    batch: inputs [b, s], targets [b, s], mask [b, s] (optional).

    Inside a training mesh's step the batch is this rank's block, the
    loss is this rank's share of the global loss (the shares sum to it)
    and the metrics are the global ones (:func:`_mesh_loss`)."""
    logits, aux = llama.forward(params, batch['inputs'], cfg,
                                attn_impl=attn_impl, return_aux=True)
    sc = mesh_lib.training()
    if sc is not None:
        return _mesh_loss(logits, aux, batch, moe_aux_weight, sc)
    tgt = batch['targets'].long()
    with torch.no_grad():
        hits = torch.argmax(logits, -1) == tgt
    logp = F.log_softmax(logits.float(), dim=-1)
    del logits
    token_ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch.get('mask')
    if mask is None:
        mask = torch.ones_like(tgt, dtype=torch.float32)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(token_ll * mask).sum() / denom
    loss = ce + moe_aux_weight * aux
    metrics = {
        'loss': ce.detach(),
        'moe_aux_loss': aux.detach(),
        'tokens': mask.sum(),
        'accuracy': (hits * mask).sum() / denom,
    }
    return loss, metrics


# The axes whose ranks hold different tokens: the batch's rows and the
# sequence's blocks.
_TOKEN_AXES = mesh_lib.DATA_AXES + ('sp',)


def _vocab_parallel_ce(logits: torch.Tensor, tgt: torch.Tensor, sc):
    """(per-token cross-entropy [b, s], hits [b, s]) from this rank's
    vocab shard of the fp32 logits: a max all-reduce, a sum-exp
    all-reduce and the target's logit from the shard that owns it, all
    over tp (the logits of the whole vocabulary never exist). The hits'
    argmax is global, the first index among equal maxima as ``argmax``
    takes it. Without a vocab split over tp, the plain log-softmax."""
    if not sc.plan.get('vocab'):
        with torch.no_grad():
            hits = torch.argmax(logits, -1) == tgt
        logp = F.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, tgt[..., None])[..., 0], hits
    mesh = sc.mesh
    vl = logits.shape[-1]
    start = mesh.axis_index('tp') * vl
    with torch.no_grad():
        m = mesh_lib.all_reduce(logits.amax(-1), 'tp', op='max')
        local_max, local_arg = logits.max(-1)
        cand = torch.where(local_max == m, local_arg + start,
                           torch.full_like(local_arg,
                                           vl * mesh.axis_size('tp')))
        hits = mesh_lib.all_reduce(cand, 'tp', op='min') == tgt
    z = logits - m[..., None]
    sumexp = mesh_lib.reduce_sum(torch.exp(z).sum(-1), 'tp')
    local = tgt - start
    inside = (local >= 0) & (local < vl)
    zt = torch.gather(z, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    zt = mesh_lib.reduce_sum(torch.where(inside, zt, torch.zeros_like(zt)),
                             'tp')
    return torch.log(sumexp) - zt, hits


def _mesh_loss(logits, aux, batch, moe_aux_weight: float, sc):
    """This rank's share of the causal-LM loss: the cross-entropy of its
    tokens over the GLOBAL ``mask.sum()``, plus its share of the MoE aux
    loss (the whole batch's on every rank, so each adds 1 / the ranks
    that share it). Metrics are global: the loss and the accuracy are
    summed over the token axes."""
    tgt = batch['targets'].long()
    mask = batch.get('mask')
    if mask is None:
        mask = torch.ones_like(tgt, dtype=torch.float32)
    mask = mask.float()
    ce_tok, hits = _vocab_parallel_ce(logits, tgt, sc)
    with torch.no_grad():
        tokens = mesh_lib.all_reduce(mask.sum().reshape(1), _TOKEN_AXES)[0]
    denom = torch.clamp(tokens, min=1.0)
    ce = (ce_tok * mask).sum() / denom
    loss = ce + moe_aux_weight * aux / sc.mesh.axis_size(_TOKEN_AXES)
    with torch.no_grad():
        global_ce = mesh_lib.all_reduce(ce.detach().reshape(1).clone(),
                                        _TOKEN_AXES)[0]
        correct = mesh_lib.all_reduce((hits * mask).sum().reshape(1),
                                      _TOKEN_AXES)[0]
    metrics = {
        'loss': global_ce,
        'moe_aux_loss': aux.detach(),
        'tokens': tokens,
        'accuracy': correct / denom,
    }
    return loss, metrics


def value_and_grad(params, batch, cfg: ModelConfig, attn_impl: str = 'auto',
                   moe_aux_weight: float = 0.01):
    """(loss, metrics, grads): the gradients of :func:`loss_fn` with
    respect to the trainable leaves, in their tree and dtypes: every
    param leaf, or under ``cfg.lora_enabled`` the adapter subtree only
    (``lora.split_lora``), the base then entering the loss untracked."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    if cfg.lora_enabled:
        trainable = lora.split_lora(params)
        tracked = lora.with_lora(params, tree_map(track, trainable))
    else:
        trainable = params
        tracked = tree_map(track, params)
    loss, metrics = loss_fn(tracked, batch, cfg, attn_impl, moe_aux_weight)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), metrics, tree_map(lambda _: next(grads),
                                            trainable)


class _StateRef(NamedTuple):
    """A :class:`TrainState` on the control channel: the number under
    which every rank keeps its own copy, and rank 0's scalars."""
    sid: int
    step: int
    count: int


def _mirrored(method):
    """Decorate a trainer method under a mesh: rank 0 sends the call
    (a state as a :class:`_StateRef`, tensors to the CPU) to the
    followers first; every rank runs it inside the training scope on its
    own state; a state it returns is registered under the same number on
    every rank. Meshless, the method runs as it is."""
    name = method.__name__

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        mesh = self.mesh
        if mesh is None:
            return method(self, *args, **kwargs)

        def msg():
            return ('call', self._mesh_eid, name, self._refs(args),
                    self._refs(kwargs))
        with mesh.op(msg, self._plan):
            out = method(self, *self._resolve(args),
                         **self._resolve(kwargs))
            return self._register(out)
    return wrapper


class Trainer:
    """Owns the model config, the optimizer and the train step, on one
    device (``device=``, default CUDA; raises without one unless the
    caller asks for the CPU) or on a training mesh: ``mesh_spec=`` (a
    ``MeshSpec``; the trainer starts the mesh on ``device``'s type and
    shuts it down in :meth:`close`) or ``mesh=`` (a mesh from
    ``parallel.mesh.make_mesh``, which the caller shuts down). ``rules``
    override the logical axis rules (``mesh.DEFAULT_RULES``)."""

    def __init__(self, cfg: ModelConfig,
                 mesh_spec=None,
                 train_config: Optional[TrainConfig] = None,
                 mesh=None,
                 rules: Optional[mesh_lib.LogicalRules] = None, *,
                 device: DeviceLike = 'cuda'):
        self.cfg = check_supported(cfg)
        self.tc = train_config or TrainConfig()
        self.rules = rules
        self._lora = cfg.lora_enabled
        self.optimizer = make_optimizer(
            self.tc, weight_decay=(self.tc.lora_weight_decay
                                   if self._lora else None))
        self._owns_mesh = self._closed = False
        if mesh is None and mesh_spec is not None:
            if not isinstance(mesh_spec, mesh_lib.MeshSpec):
                raise TypeError(f'mesh_spec must be a MeshSpec, got '
                                f'{type(mesh_spec).__name__}')
            _check_spec(self.cfg, mesh_spec)
            mesh = mesh_lib.make_mesh(mesh_spec, device=device)
            self._owns_mesh = True
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            return
        if not isinstance(mesh, mesh_lib.ServingMesh):
            raise TypeError(f'mesh must come from parallel.mesh.make_mesh, '
                            f'got {type(mesh).__name__}')
        _check_spec(self.cfg, mesh.spec)
        self.device = mesh.device
        self._states: Dict[int, TrainState] = {}
        self._sids: Dict[int, int] = {}
        self._next_sid = 0
        axes = llama.param_logical_axes(self.cfg)
        shapes = llama.init_params(self.cfg, 0, device='meta')
        # The step's scope: the tp split (``tp_plan``), marked a training
        # step, with each leaf's fsdp gather.
        plan = dict(mesh_lib.tp_plan(self.cfg, mesh), train=True,
                    gather=mesh_lib.gather_plan(axes, shapes, mesh, rules))
        if plan['kv_groups'] is not None:
            plan['kv_index'] = torch.tensor(plan['kv_groups'][0],
                                            dtype=torch.long,
                                            device=self.device)
        self._axes, self._meta = axes, shapes
        self._shard_axes = mesh_lib.shard_axes(axes, shapes, mesh, rules)
        self._gathered = _gathered_axes(plan['gather'])
        self._plan = plan
        wire = {'train_config': self.tc, 'rules': rules}

        def msg():
            return ('new',) + (type(self).__module__,
                               type(self).__qualname__) + ((cfg,), wire)
        with mesh.op(msg, plan):
            self._mesh_eid = mesh.new_engine_id(self)

    # ---------------- the mesh plumbing ----------------
    def close(self) -> None:
        """Drop this trainer from its mesh's followers, and shut down a
        mesh this trainer started (``mesh_spec=``). Idempotent."""
        mesh = self.mesh
        if mesh is None or mesh.closed or self._closed:
            return
        self._closed = True
        if self._owns_mesh:
            mesh.shutdown()
        else:
            mesh.close_engine(self._mesh_eid)

    def _refs(self, obj):
        if isinstance(obj, TrainState):
            if id(obj.params) not in self._sids:
                raise ValueError(
                    'this state is not the mesh trainer\'s live one: a '
                    'later init, restore_checkpoint or load_adapter '
                    'replaced it (a mesh trainer keeps one live state)')
            return _StateRef(self._sids[id(obj.params)], obj.step,
                             obj.opt_state.count)
        if isinstance(obj, dict):
            return {k: self._refs(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)) and not hasattr(obj, '_fields'):
            return type(obj)(self._refs(v) for v in obj)
        return obj

    def _resolve(self, obj):
        if isinstance(obj, _StateRef):
            st = self._states[obj.sid]
            return TrainState(step=obj.step, params=st.params,
                              opt_state=st.opt_state._replace(
                                  count=obj.count))
        if isinstance(obj, dict):
            return {k: self._resolve(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)) and not hasattr(obj, '_fields'):
            return type(obj)(self._resolve(v) for v in obj)
        return obj

    def _register(self, out):
        """Keep a returned state as the live one, under the same number
        on every rank (each registers in the same call order). A mesh
        trainer keeps one live state, as the reference's step donates
        its input: a new one (``init``, ``restore_checkpoint``,
        ``load_adapter``) releases the one before, so its params and
        moments are freed on every rank."""
        state = out[0] if isinstance(out, tuple) and out and isinstance(
            out[0], TrainState) else out
        if isinstance(state, TrainState):
            key = id(state.params)
            if key not in self._sids:
                self._sids = {key: self._next_sid}
                self._states.clear()
                self._next_sid += 1
            self._states[self._sids[key]] = state
        return out

    def _local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows (over the data axes) and sequence block (over
        sp) of the global batch, on this rank's device."""
        mesh = self.mesh
        inputs = batch['inputs']
        B, S = inputs.shape[:2]
        n, sp = mesh.axis_size(mesh_lib.DATA_AXES), mesh.axis_size('sp')
        if B % n:
            raise ValueError(f'batch {B} not divisible by the data axes '
                             f'(slice x dp x fsdp = {n})')
        if S % sp:
            raise ValueError(f'sequence {S} not divisible by sp={sp}')
        i, j = mesh.axis_index(mesh_lib.DATA_AXES), mesh.axis_index('sp')
        cols = slice(j * (S // sp), (j + 1) * (S // sp))
        # Under pp the rows are taken per microbatch (M = pp): this
        # rank's block of each global microbatch, so its m-th local
        # microbatch is its share of the reference's m-th (the whole
        # batch's MoE routing and aux per microbatch, R6).
        M = mesh.axis_size('pp')
        if B % (M * n):
            raise ValueError(f'batch {B} not divisible into {M} '
                             f'microbatches over the data axes ({n})')
        per = B // (M * n)
        rows = torch.cat([torch.arange(m * (B // M) + i * per,
                                       m * (B // M) + (i + 1) * per)
                          for m in range(M)])
        return {k: torch.as_tensor(v)[rows][:, cols]
                for k, v in batch.items()}

    def _cut(self, tree, axes):
        return mesh_lib.shard_params(tree, axes, self.mesh,
                                     rules=self.rules)

    def _cutter(self):
        """The loaders' per-leaf cutter (None meshless): every axis but
        the layer stack's, which :meth:`_stage` cuts after (a loader draws
        or reads a stack layer by layer)."""
        if self.mesh is None:
            return None
        return mesh_lib.leaf_cutter(self._axes, self.mesh,
                                    rules=dict(self.rules or {},
                                               layers=None))

    def _stage(self, params):
        """A loaded tree's layer stacks cut to this pp stage's layers
        (the tree itself meshless or without pp)."""
        if self.mesh is None or self.mesh.axis_size('pp') == 1:
            return params
        only_layers = {k: None for k in mesh_lib.DEFAULT_RULES
                       if k != 'layers'}
        only_layers['layers'] = (self.rules or {}).get(
            'layers', mesh_lib.DEFAULT_RULES['layers'])
        return mesh_lib.shard_params(params, self._axes, self.mesh,
                                     rules=only_layers)

    def _sync_grads(self, grads, trainable_axes_gathered):
        """Sum each leaf's gradient over the token axes its fsdp gather
        did not already reduce-scatter over (one all-reduce per group of
        axes and dtype)."""
        buckets: Dict[Any, list] = {}

        def walk(path, g, gathered):
            for k in sorted(g):
                if isinstance(g[k], dict):
                    walk(path + (k,), g[k], (gathered or {}).get(k))
                else:
                    done = (gathered or {}).get(k) or ()
                    axes = tuple(a for a in _TOKEN_AXES if a not in done)
                    buckets.setdefault((axes, g[k].dtype), []).append(g[k])
        walk((), grads, trainable_axes_gathered)
        for (axes, _), leaves in buckets.items():
            flat = torch.cat([t.reshape(-1) for t in leaves])
            mesh_lib.all_reduce(flat, axes)
            off = 0
            for t in leaves:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def _global_norm(self, grads, shard_axes) -> torch.Tensor:
        """The global norm over every rank's shards: each leaf's square
        sum counted by one rank of those that hold the same shard, summed
        in ``jax.tree.leaves`` order as ``optax.global_norm`` does, then
        over the world."""
        coords = self.mesh.coords
        parts = []

        def walk(g, sa):
            for k in sorted(g):
                if isinstance(g[k], dict):
                    walk(g[k], sa[k])
                    continue
                owner = all(coords[a] == 0 for a in mesh_lib.MESH_AXES
                            if a not in sa[k])
                parts.append((g[k] * g[k]).sum() if owner else
                             torch.zeros((), dtype=g[k].dtype,
                                         device=g[k].device))
        walk(grads, shard_axes)
        total = sum(parts).float().reshape(1)
        return torch.sqrt(mesh_lib.all_reduce(total,
                                              mesh_lib.MESH_AXES)[0])

    def _trainable_axes(self, tree):
        return tree['layers']['lora'] if self._lora else tree

    # ---------------- init / step ----------------
    @_mirrored
    def init(self, seed: int = 0) -> TrainState:
        """Random params (``llama.init_params`` from ``seed``) and a
        fresh optimizer state; under a mesh each rank draws the same
        values and keeps its cut."""
        return self._fresh(self._stage(llama.init_params(
            self.cfg, seed, device=self.device, cut=self._cutter())))

    def _trainable(self, params):
        return lora.split_lora(params) if self._lora else params

    @_mirrored
    def state_from_params(self, params) -> TrainState:
        """Step 0 with the given params (on this trainer's device) and a
        fresh optimizer state over the trainable leaves. Under a mesh
        ``params`` is the whole tree (sent to every rank; each keeps its
        cut)."""
        if self.mesh is not None:
            params = _to_device(self._cut(params, self._axes), self.device)
        return self._fresh(params)

    def _fresh(self, params) -> TrainState:
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(
                              self._trainable(params)))

    @_mirrored
    def init_from_pretrained(self, path: str) -> TrainState:
        """Start training from an HF checkpoint directory (fine-tuning):
        params from the checkpoint in this trainer's config (layout and
        dtype), a fresh optimizer state. Under LoRA the checkpoint
        carries no adapters: fresh ones are drawn (seed 0), whose delta
        is zero. Under a mesh each rank reads its own shard."""
        cut = self._cutter()
        params = self._stage(weights.load_hf_params(
            path, self.cfg, device=self.device, cut=cut))
        if self._lora and 'lora' not in params['layers']:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            adapters = lora.init_lora_layers(self.cfg, gen,
                                             device=self.device)
            if cut is not None:
                adapters = self._cut({'layers': {'lora': adapters}},
                                     self._axes)['layers']['lora']
            params = lora.with_lora(params, adapters)
        return self._fresh(params)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                  else v).to(self.device)
               for k, v in batch.items()}
        if 'mask' not in out:
            out['mask'] = torch.ones_like(out['targets'],
                                          dtype=torch.float32)
        return out

    def step(self, state: TrainState, batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step. The state's params and moments are updated
        in place (the input state is consumed, as the reference's jitted
        step donates it). Metrics are 0-d tensors on the device;
        ``grad_norm`` is the global norm before clipping. Under LoRA only
        the adapters are updated. Under a mesh the global batch goes to
        every rank as int32 tokens (and a float mask) and the metrics are
        the global ones."""
        if self.mesh is None:
            return self._step(state, batch)
        wire = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v.detach().cpu())
                for k, v in batch.items()}
        wire = {k: (v.to(torch.int32) if k != 'mask' else v.float())
                for k, v in wire.items()}
        return self._mesh_step(state, wire)

    def _step(self, state, batch):
        _, metrics, grads = value_and_grad(
            state.params, self._batch(batch), self.cfg, self.tc.attn_impl,
            self.tc.moe_aux_weight)
        opt_state, metrics['grad_norm'] = self.optimizer.update(
            grads, state.opt_state, self._trainable(state.params))
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    @_mirrored
    def _mesh_step(self, state, batch):
        batch = self._batch(self._local_batch(batch))
        _, metrics, grads = value_and_grad(
            state.params, batch, self.cfg, self.tc.attn_impl,
            self.tc.moe_aux_weight)
        self._sync_grads(grads, self._trainable_axes(self._gathered))
        norm = self._global_norm(grads,
                                 self._trainable_axes(self._shard_axes))
        opt_state, metrics['grad_norm'] = self.optimizer.update(
            grads, state.opt_state, self._trainable(state.params),
            norm=norm)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def fit(self, state: TrainState, data_iter, num_steps: int,
            callbacks=None) -> TrainState:
        """Drive ``num_steps`` steps with callback instrumentation
        (``skypilot_tpu_torch.callbacks``); each step's metrics are read
        back to the host before ``on_step_end``, so a callback's timer
        measures the step's device work, not its enqueue. Under a mesh
        the loop and the callbacks run on rank 0; each step is sent to
        the followers."""
        from skypilot_tpu_torch.callbacks.base import (BaseCallback,
                                                       CallbackList)
        if isinstance(callbacks, CallbackList):
            cbs = callbacks
        elif isinstance(callbacks, BaseCallback):
            cbs = CallbackList([callbacks])
        else:
            cbs = CallbackList(callbacks)
        for _ in range(num_steps):
            batch = next(data_iter)
            step_no = state.step
            cbs.on_step_begin(step_no)
            state, metrics = self.step(state, batch)
            cbs.on_step_end(step_no, host_scalars(metrics))
        cbs.on_train_end()
        return state

    # ---------------- gathering a mesh state ----------------
    def _gather_tree(self, tree, axes, shapes):
        """The whole of a sharded tree (``shapes``: the whole tree's
        shapes; every rank takes part and every rank gets it)."""
        sizes, mesh = self.mesh.shape, self.mesh

        def walk(t, ax, sh):
            if isinstance(t, dict):
                return {k: walk(v, ax[k], sh[k]) for k, v in t.items()}
            spec = mesh_lib.spec_for(ax, self.rules, shape=tuple(sh.shape),
                                     mesh=sizes)
            for dim, part in enumerate(spec):
                names = () if part is None else (
                    (part,) if isinstance(part, str) else tuple(part))
                if math.prod(sizes[a] for a in names) > 1:
                    t = mesh_lib._comm_all_gather(mesh, t, names, dim)
            return t
        with torch.no_grad():
            return walk(tree, axes, shapes)

    @_mirrored
    def full_params(self, state: TrainState):
        """The whole params tree (gathered from every rank's shard under
        a mesh; the state's own tree meshless)."""
        if self.mesh is None:
            return state.params
        return self._gather_tree(state.params, self._axes, self._meta)

    # ---------------- checkpointing ----------------
    @_mirrored
    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """``{step, params, opt_state}`` with ``torch.save`` into the
        directory ``path`` (written to a temporary file, then renamed):
        restoring it and stepping on gives bit-identical params. A LoRA
        state saves the frozen base, the adapters and their moments.
        Under a mesh rank 0 writes the gathered state, in the same
        format."""
        opt = state.opt_state
        params, mu, nu = state.params, opt.mu, opt.nu
        if self.mesh is not None:
            tax = self._trainable_axes(self._axes)
            tsh = self._trainable_axes(self._meta)
            params = self._gather_tree(params, self._axes, self._meta)
            mu = self._gather_tree(mu, tax, tsh)
            nu = self._gather_tree(nu, tax, tsh)
            if not self.mesh.is_leader:
                return
        _save_atomic(path, CHECKPOINT_FILE, {
            'step': state.step, 'params': params,
            'opt_state': {'count': opt.count, 'mu': mu, 'nu': nu}})

    @_mirrored
    def restore_checkpoint(self, path: str) -> TrainState:
        """The state saved at ``path``, on this trainer's device; under a
        mesh each rank reads the file and keeps its cut."""
        on = 'cpu' if self.mesh is not None else self.device
        blob = torch.load(os.path.join(path, CHECKPOINT_FILE),
                          map_location=on, weights_only=True)
        opt = blob['opt_state']
        params, mu, nu = blob['params'], opt['mu'], opt['nu']
        if self.mesh is not None:
            tax = self._trainable_axes(self._axes)
            params = _to_device(self._cut(params, self._axes), self.device)
            mu = _to_device(self._cut(mu, tax), self.device)
            nu = _to_device(self._cut(nu, tax), self.device)
        return TrainState(step=int(blob['step']), params=params,
                          opt_state=AdamWState(count=int(opt['count']),
                                               mu=mu, nu=nu))

    # ---------------- LoRA adapter checkpoints ----------------
    def _adapter_meta(self) -> Dict[str, Any]:
        return {'lora_rank': self.cfg.lora_rank,
                'lora_alpha': self.cfg.lora_alpha,
                'lora_targets': list(self.cfg.lora_targets)}

    @staticmethod
    def _adapter_meta_path(path: str) -> str:
        return path.rstrip('/') + '.lora.json'

    @_mirrored
    def save_adapter(self, path: str, state: TrainState) -> None:
        """Adapter-only checkpoint: the LoRA subtree with ``torch.save``
        into the directory ``path`` (``adapter.pt``, through a temporary
        file), megabytes instead of the base's gigabytes; beside it the
        sidecar ``path + '.lora.json'`` records rank, alpha and targets,
        written as the reference writes it, so a load can refuse an
        adapter that a wrong alpha would silently mis-scale. Under a
        mesh rank 0 writes the gathered adapters."""
        if not self._lora:
            raise ValueError('save_adapter requires a LoRA config '
                             '(cfg.lora_rank > 0)')
        adapter = lora.split_lora(state.params)
        if self.mesh is not None:
            adapter = self._gather_tree(adapter,
                                        self._axes['layers']['lora'],
                                        self._meta['layers']['lora'])
            if not self.mesh.is_leader:
                return
        _save_atomic(path, ADAPTER_FILE, adapter)
        with open(self._adapter_meta_path(path), 'w',
                  encoding='utf-8') as f:
            json.dump(self._adapter_meta(), f)

    @_mirrored
    def load_adapter(self, path: str, state: TrainState) -> TrainState:
        """Swap a saved adapter into ``state`` (the base unchanged, on
        this trainer's device); the optimizer moments are NOT restored:
        ``restore_checkpoint`` resumes training exactly. Under a mesh
        each rank keeps its cut."""
        if not self._lora:
            raise ValueError('load_adapter requires a LoRA config '
                             '(cfg.lora_rank > 0)')
        meta_path = self._adapter_meta_path(path)
        if os.path.exists(meta_path):
            with open(meta_path, encoding='utf-8') as f:
                meta = json.load(f)
            mine = self._adapter_meta()
            if meta != mine:
                raise ValueError(
                    f'adapter at {path} was trained with {meta}, but '
                    f'this trainer is configured with {mine}; a '
                    f'mismatched alpha/rank would silently mis-scale '
                    f'the fold')
        adapter = torch.load(os.path.join(path, ADAPTER_FILE),
                             map_location=('cpu' if self.mesh is not None
                                           else self.device),
                             weights_only=True)
        if self.mesh is not None:
            adapter = _to_device(self._cut(
                {'layers': {'lora': adapter}}, self._axes)['layers']['lora'],
                self.device)
        return state._replace(params=lora.with_lora(state.params, adapter))


def _check_spec(cfg: ModelConfig, spec) -> None:
    """A pp mesh's stages take equal contiguous layer blocks."""
    if cfg.n_layers % spec.pp:
        raise ValueError(f'{cfg.n_layers} layers do not split into '
                         f'pp={spec.pp} pipeline stages')


def _gathered_axes(gather):
    """{leaf: the axes its fsdp gather reduce-scatters over} from a
    ``mesh.gather_plan`` tree."""
    if isinstance(gather, dict):
        return {k: _gathered_axes(v) for k, v in gather.items()}
    return None if gather is None else gather[1]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def _save_atomic(path: str, name: str, blob) -> None:
    """``torch.save(blob)`` as ``path/name``, through a temporary file
    renamed into place."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + '.tmp')
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, name))

