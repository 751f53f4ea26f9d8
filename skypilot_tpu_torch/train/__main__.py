"""``python -m skypilot_tpu_torch.train`` — train a model on a text
corpus on one device (port of ``python -m skypilot_tpu.train``).

Tokenizes and packs a corpus, builds the trainer and runs with automatic
checkpoint-resume: step-addressed checkpoints ``<ckpt-dir>/step_N`` and
a ``LATEST`` pointer flipped after each save, so a relaunch with the
same ``--ckpt-dir`` resumes exactly where training stopped. Prints one
JSON line (``step``, ``loss``, ``accuracy``, ``tok_s``, and for an MoE
model such as ``--model mixtral-8x7b`` or ``tiny-moe`` the
load-balancing ``moe_aux_loss``) per log interval.

Example (on the card; ``--device cpu`` runs the same on the CPU):

    python -m skypilot_tpu_torch.train --model llama3-1b --data corpus/ \\
        --batch 8 --seq 2048 --steps 5000 --ckpt-dir /ckpt/llama \\
        --save-every 500

``--from-pretrained DIR`` fine-tunes ``--model`` from the weights of an
HF checkpoint directory of that model (a checkpoint in ``--ckpt-dir``
still wins). ``--lora-rank N`` > 0 trains rank-N adapters on
``--lora-targets`` with the base frozen, and ``--adapter-out P`` saves
the final adapters alone (``Trainer.save_adapter``):

    python -m skypilot_tpu_torch.train --model llama3-8b \\
        --from-pretrained /ckpt/llama3-8b --data corpus/ --lora-rank 16 \\
        --lora-alpha 32 --adapter-out /ckpt/adapter

``--tp N`` and ``--sp N`` train on a mesh (``Trainer(mesh_spec=
mesh.spec_from_env(tp=, sp=))``, as the reference builds it): the
visible CUDA devices (on the CPU, ``tp * sp`` gloo ranks, one process
each), everything not tp or sp going to fsdp, and ``SKYTPU_NUM_SLICES``
honoured. A launched multi-node job (``SKYTPU_COORDINATOR_ADDRESS``,
``SKYTPU_NUM_NODES`` > 1, ``SKYTPU_NODE_RANK``; one process a node, on
its ``LOCAL_RANK`` card) meets over ``tcp://`` (``mesh.launched_mesh``):
node 0 runs the training loop and reads the data, every other node runs
the follower loop (``parallel/follower.py``). ``--batch`` must divide by
the mesh's data axes (slice x dp x fsdp), ``--seq`` by ``--sp``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog='python -m skypilot_tpu_torch.train')
    parser.add_argument('--model', default='tiny',
                        help='preset config name (models/configs.py)')
    parser.add_argument('--data', required=True,
                        help='corpus: local text file, directory or glob')
    parser.add_argument('--tokenizer', default=None,
                        help='HF tokenizer dir (default: byte tokenizer)')
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--seq', type=int, default=512)
    parser.add_argument('--steps', type=int, default=100,
                        help='total optimizer steps (training stops at '
                             'this step, including restored progress)')
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--warmup-steps', type=int, default=100)
    parser.add_argument('--ckpt-dir', default=None,
                        help='checkpoint dir; auto-resumes from LATEST')
    parser.add_argument('--save-every', type=int, default=500)
    parser.add_argument('--from-pretrained', default=None,
                        help='HF checkpoint dir of --model to fine-tune '
                             'from')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='> 0 enables LoRA fine-tuning: the base is '
                             'frozen, only low-rank adapters train '
                             '(models/lora.py)')
    parser.add_argument('--lora-alpha', type=float, default=16.0)
    parser.add_argument('--lora-targets', default='wq,wk,wv,wo',
                        help='comma-separated projections to adapt')
    parser.add_argument('--adapter-out', default=None,
                        help='where to save the final adapter-only '
                             'checkpoint (LoRA runs)')
    parser.add_argument('--tp', type=int, default=None)
    parser.add_argument('--sp', type=int, default=1)
    parser.add_argument('--attn-impl', default='auto')
    parser.add_argument('--mu-dtype', default='float32')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.parallel import follower
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = configs.get_config(args.model)
    if args.lora_rank > 0:
        cfg = dataclasses.replace(
            cfg, lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
            lora_targets=tuple(
                t.strip() for t in args.lora_targets.split(',') if t))
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup_steps,
                     total_steps=args.steps, attn_impl=args.attn_impl,
                     mu_dtype=args.mu_dtype)
    nodes = int(os.environ.get('SKYTPU_NUM_NODES', '1') or 1)
    launched = nodes > 1 and bool(os.environ.get(
        'SKYTPU_COORDINATOR_ADDRESS'))
    spec = None
    if args.tp or args.sp > 1 or launched:
        on_cpu = args.device == 'cpu'
        spec = mesh_lib.spec_from_env(
            tp=args.tp, sp=args.sp,
            num_devices=(nodes if launched else
                         (args.tp or 1) * args.sp if on_cpu else None))
    if launched:
        mesh = mesh_lib.launched_mesh(spec, device=args.device)
        if not mesh.is_leader:
            follower.serve(mesh)
            return
        trainer = Trainer(cfg, mesh=mesh, train_config=tc)
    else:
        trainer = Trainer(cfg, mesh_spec=spec, train_config=tc,
                          device=args.device)
    try:
        _train(args, cfg, trainer)
    finally:
        trainer.close()
        if launched:
            trainer.mesh.shutdown()


def _train(args, cfg, trainer) -> None:
    """Restore or initialize, then run the steps, logging and saving."""
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    from skypilot_tpu_torch.utils.device import host_scalars
    data_axis = mesh_lib.data_axis_size(trainer.mesh)
    if args.batch % data_axis:
        raise SystemExit(
            f'--batch {args.batch} must be divisible by the mesh data-'
            f'parallel degree {data_axis} (slice*dp*fsdp); pick a '
            f'multiple or reduce the mesh with --tp/--sp')

    # ---- state: restore > fine-tune > fresh ----
    start_step = 0
    latest = _latest_checkpoint(args.ckpt_dir)
    if latest is not None:
        state = trainer.restore_checkpoint(latest)
        start_step = state.step
        print(f'[train] resumed from {latest} at step {start_step}',
              flush=True)
    elif args.from_pretrained:
        state = trainer.init_from_pretrained(args.from_pretrained)
        print(f'[train] initialized from {args.from_pretrained}',
              flush=True)
    else:
        state = trainer.init(0)

    # ---- data: deterministic resume = start at the restored step ----
    stream = TokenStream(args.data, load_tokenizer(
        args.tokenizer, model_vocab_size=cfg.vocab_size))
    it = packed_batches(stream, batch=args.batch, seq=args.seq,
                        start_step=start_step)

    t0 = time.time()
    last_logged = start_step
    for step in range(start_step, args.steps):
        state, metrics = trainer.step(state, next(it))
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = host_scalars(metrics)
            dt = time.time() - t0
            window = step + 1 - last_logged
            line = {
                'step': step + 1,
                'loss': round(m['loss'], 4),
                'accuracy': round(m['accuracy'], 4),
                'tok_s': round(args.batch * args.seq * window
                               / max(dt, 1e-9), 1),
            }
            if cfg.is_moe:
                line['moe_aux_loss'] = round(m['moe_aux_loss'], 6)
            print(json.dumps(line), flush=True)
            t0 = time.time()
            last_logged = step + 1
        if (args.ckpt_dir and args.save_every
                and (step + 1) % args.save_every == 0
                and step + 1 < args.steps):
            _save(trainer, state, args.ckpt_dir)
    if args.ckpt_dir:
        _save(trainer, state, args.ckpt_dir)
    if args.lora_rank > 0 and args.adapter_out:
        trainer.save_adapter(os.path.abspath(args.adapter_out), state)
        print(f'[train] adapter saved: {args.adapter_out}', flush=True)
    print(f'[train] done at step {state.step}', flush=True)


def _save(trainer, state, ckpt_dir: str) -> None:
    """Write a step-addressed checkpoint, then flip the LATEST pointer:
    a reader never sees a pointer to a half-written checkpoint."""
    path = os.path.abspath(os.path.join(ckpt_dir, f'step_{state.step}'))
    trainer.save_checkpoint(path, state)
    tmp = os.path.join(ckpt_dir, 'LATEST.tmp')
    with open(tmp, 'w', encoding='utf-8') as f:
        f.write(f'step_{state.step}')
    os.replace(tmp, os.path.join(ckpt_dir, 'LATEST'))
    print(f'[train] checkpoint saved: {path}', flush=True)


def _latest_checkpoint(ckpt_dir):
    if not ckpt_dir:
        return None
    pointer = os.path.join(ckpt_dir, 'LATEST')
    if not os.path.exists(pointer):
        return None
    with open(pointer, encoding='utf-8') as f:
        name = f.read().strip()
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    return path if os.path.isdir(path) else None


if __name__ == '__main__':
    main()
