"""Single-device trainer (port of ``skypilot_tpu/train/trainer.py``).

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

Not ported here: a mesh (``mesh``/``mesh_spec``: FSDP/TP/SP sharding
over several devices) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import llama, lora, weights
from skypilot_tpu_torch.models.configs import ModelConfig, check_supported
from skypilot_tpu_torch.train.optim import AdamW, AdamWState, tree_map
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

    batch: inputs [b, s], targets [b, s], mask [b, s] (optional)."""
    logits, aux = llama.forward(params, batch['inputs'], cfg,
                                attn_impl=attn_impl, return_aux=True)
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


class Trainer:
    """Owns the model config, the optimizer and the train step on one
    device (``device=``, default CUDA; raises without one unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig,
                 mesh_spec=None,
                 train_config: Optional[TrainConfig] = None,
                 mesh=None, *,
                 device: DeviceLike = 'cuda'):
        if mesh_spec is not None or mesh is not None:
            raise NotImplementedError(
                'the port trains on one device; meshes (FSDP/TP/SP) are '
                'not ported (ROADMAP §1 item 8)')
        self.cfg = check_supported(cfg)
        self.tc = train_config or TrainConfig()
        self.device = resolve_device(device)
        self._lora = cfg.lora_enabled
        self.optimizer = make_optimizer(
            self.tc, weight_decay=(self.tc.lora_weight_decay
                                   if self._lora else None))

    # ---------------- init / step ----------------
    def init(self, seed: int = 0) -> TrainState:
        """Random params (``llama.init_params`` from ``seed``) and a
        fresh optimizer state."""
        return self.state_from_params(
            llama.init_params(self.cfg, seed, device=self.device))

    def _trainable(self, params):
        return lora.split_lora(params) if self._lora else params

    def state_from_params(self, params) -> TrainState:
        """Step 0 with the given params (on this trainer's device) and a
        fresh optimizer state over the trainable leaves."""
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(
                              self._trainable(params)))

    def init_from_pretrained(self, path: str) -> TrainState:
        """Start training from an HF checkpoint directory (fine-tuning):
        params from the checkpoint in this trainer's config (layout and
        dtype), a fresh optimizer state. Under LoRA the checkpoint
        carries no adapters: fresh ones are drawn (seed 0), whose delta
        is zero."""
        params = weights.load_hf_params(path, self.cfg, device=self.device)
        if self._lora and 'lora' not in params['layers']:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = lora.with_lora(params, lora.init_lora_layers(
                self.cfg, gen, device=self.device))
        return self.state_from_params(params)

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
        the adapters are updated."""
        _, metrics, grads = value_and_grad(
            state.params, self._batch(batch), self.cfg, self.tc.attn_impl,
            self.tc.moe_aux_weight)
        opt_state, metrics['grad_norm'] = self.optimizer.update(
            grads, state.opt_state, self._trainable(state.params))
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def fit(self, state: TrainState, data_iter, num_steps: int,
            callbacks=None) -> TrainState:
        """Drive ``num_steps`` steps with callback instrumentation
        (``skypilot_tpu_torch.callbacks``); each step's metrics are read
        back to the host before ``on_step_end``, so a callback's timer
        measures the step's device work, not its enqueue."""
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

    # ---------------- checkpointing ----------------
    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """``{step, params, opt_state}`` with ``torch.save`` into the
        directory ``path`` (written to a temporary file, then renamed):
        restoring it and stepping on gives bit-identical params. A LoRA
        state saves the frozen base, the adapters and their moments."""
        opt = state.opt_state
        _save_atomic(path, CHECKPOINT_FILE, {
            'step': state.step, 'params': state.params,
            'opt_state': {'count': opt.count, 'mu': opt.mu, 'nu': opt.nu}})

    def restore_checkpoint(self, path: str) -> TrainState:
        """The state saved at ``path``, on this trainer's device."""
        blob = torch.load(os.path.join(path, CHECKPOINT_FILE),
                          map_location=self.device, weights_only=True)
        opt = blob['opt_state']
        return TrainState(step=int(blob['step']), params=blob['params'],
                          opt_state=AdamWState(count=int(opt['count']),
                                               mu=opt['mu'], nu=opt['nu']))

    # ---------------- LoRA adapter checkpoints ----------------
    def _adapter_meta(self) -> Dict[str, Any]:
        return {'lora_rank': self.cfg.lora_rank,
                'lora_alpha': self.cfg.lora_alpha,
                'lora_targets': list(self.cfg.lora_targets)}

    @staticmethod
    def _adapter_meta_path(path: str) -> str:
        return path.rstrip('/') + '.lora.json'

    def save_adapter(self, path: str, state: TrainState) -> None:
        """Adapter-only checkpoint: the LoRA subtree with ``torch.save``
        into the directory ``path`` (``adapter.pt``, through a temporary
        file), megabytes instead of the base's gigabytes; beside it the
        sidecar ``path + '.lora.json'`` records rank, alpha and targets,
        written as the reference writes it, so a load can refuse an
        adapter that a wrong alpha would silently mis-scale."""
        if not self._lora:
            raise ValueError('save_adapter requires a LoRA config '
                             '(cfg.lora_rank > 0)')
        _save_atomic(path, ADAPTER_FILE, lora.split_lora(state.params))
        with open(self._adapter_meta_path(path), 'w',
                  encoding='utf-8') as f:
            json.dump(self._adapter_meta(), f)

    def load_adapter(self, path: str, state: TrainState) -> TrainState:
        """Swap a saved adapter into ``state`` (the base unchanged, on
        this trainer's device); the optimizer moments are NOT restored:
        ``restore_checkpoint`` resumes training exactly."""
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
                             map_location=self.device, weights_only=True)
        return state._replace(params=lora.with_lora(state.params, adapter))


def _save_atomic(path: str, name: str, blob) -> None:
    """``torch.save(blob)`` as ``path/name``, through a temporary file
    renamed into place."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + '.tmp')
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, name))

