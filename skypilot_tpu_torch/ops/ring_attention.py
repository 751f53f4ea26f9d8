"""Ring attention: exact attention over a sequence split across the
``sp`` mesh axis (port of ``skypilot_tpu/ops/ring_attention.py``).

Each sp rank holds one contiguous block of the sequence; the KV blocks
rotate around the ring while an online softmax (m, l, acc) merges each
block pair's result, so the whole score matrix never exists. After sp
steps every rank has attended to the whole sequence once.

- **Contiguous layout** (``_ring_body``): causal masking by global
  block; blocks strictly in the future are skipped, so rank r computes
  r + 1 block pairs.
- **Zigzag layout** (``_zigzag_body``, the default for causal): each
  block is split in two halves, re-dealt so rank r holds halves r and
  2 sp - 1 - r; every rank then computes 2 half-block pairs a step.
- **The block body** (``block_impl='flash'``): each block pair runs K4
  (``flash_attention.flash_attention_fwd``, which returns the output and
  the logsumexp) and merges by lse. Its backward runs K5a and K5b with
  the lse cotangent folded into delta (``delta' = rowsum(out * do) -
  dlse``, since ``ds = p (dp - delta + dlse)``), where the reference
  re-derives the block through its einsum version. ``'auto'`` takes K4
  for every block pair the kernel supports on CUDA (d 64/128/256, group
  <= 8: ``attention``'s rule; the reference's multiple-of-128 rule is a
  TPU lane-tile limit) and the einsum body elsewhere; ``'einsum'`` is
  the plain merge.

Each ring step's work (which block pair, the K4 call, the merge) is
written apart from the communication, over a list of the ranks this
process computes. Two communicators drive it:

- :class:`MeshComm`: one rank of a training mesh; a rotation is one
  batch of point-to-point sends over the sp group
  (``mesh.exchange``, whose backward rotates the other way).
- :class:`LockstepComm`: every sp rank in one process on one device; a
  rotation is a reassignment of which rank holds which block, so
  forward and backward form one autograd graph whose gradients equal
  the distributed run's. The op-level entry points
  (:func:`ring_attention` with an ``sp`` count or a ``MeshSpec``) run
  on it: the CPU parity tests, and ``chip_smoke.py``'s one-card
  ``seq_parallel`` phase. The trainer never selects it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Communicators
# ---------------------------------------------------------------------------
class LockstepComm:
    """All ``size`` sp ranks in this process: ``ranks`` is every rank,
    and an exchange reassigns the blocks."""

    lockstep = True

    def __init__(self, size: int):
        self.size = int(size)
        self.ranks = list(range(self.size))

    def exchange(self, bundles: Sequence[List[tuple]],
                 perms: Sequence[dict]) -> List[List[tuple]]:
        """``bundles[i][j]``: the tuple of tensors rank ``ranks[j]``
        sends by ``perms[i]`` ({src: dst}); returns what each rank
        receives, in the same layout."""
        out = []
        for bundle, perm in zip(bundles, perms):
            got = [None] * self.size
            for src, dst in perm.items():
                got[dst] = bundle[src]
            out.append(got)
        return out

    def all_to_all(self, bundle: List[tuple], split_dim: int,
                   concat_dim: int) -> List[tuple]:
        """Each rank's tensors cut along ``split_dim`` into ``size``
        blocks, block j to rank j, received blocks concatenated along
        ``concat_dim`` in rank order."""
        n = self.size
        blocks = [[x.chunk(n, dim=split_dim) for x in t] for t in bundle]
        return [tuple(torch.cat([blocks[i][k][j] for i in range(n)],
                                dim=concat_dim)
                      for k in range(len(bundle[0])))
                for j in range(n)]


class MeshComm:
    """This process's rank of the active training mesh's sp group."""
    lockstep = False

    def __init__(self):
        sc = mesh_lib.training()
        if sc is None:
            raise RuntimeError('MeshComm outside a training mesh scope')
        self.size = sc.mesh.axis_size('sp')
        self.ranks = [sc.mesh.axis_index('sp')]

    def exchange(self, bundles, perms):
        flat, shapes = [], []
        for bundle, perm in zip(bundles, perms):
            for x in bundle[0]:
                flat.append(x)
                shapes.append(perm)
        got = iter(mesh_lib.exchange(flat, shapes))
        return [[tuple(next(got) for _ in bundle[0])] for bundle in bundles]

    def all_to_all(self, bundle, split_dim, concat_dim):
        return [mesh_lib.all_to_all(bundle[0], split_dim, concat_dim)]


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------
class _FlashBlock(torch.autograd.Function):
    """One block pair through K4, returning (out, lse); the backward runs
    K5a and K5b with the lse cotangent folded into delta (the plain
    versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention.flash_attention_fwd(
            q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_attention.attention_delta(out, do)
        if dlse is not None:
            delta = (delta - dlse.float()).contiguous()
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq = dk = dv = None
        if need_k or need_v:
            dk, dv = flash_attention.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal=ctx.causal, scale=ctx.scale)
        if need_q:
            dq = flash_attention.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def _block_logits(q, k, scale, causal):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = (q.float() * scale).reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum('bqhgd,bkhd->bhgqk', qg, k.float())
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        logits = torch.where(mask[None, None, None], logits, _NEG_INF)
    return logits


def _merge_block(state, q, k_blk, v_blk, *, scale, causal, use_flash):
    """Merge one (q, k_blk) pair into the running softmax ``state`` =
    (m, l, acc): m, l [b, hkv, g, s, 1]; acc [b, s, hkv, g, d]. The
    running max is a stabilizer the result does not depend on, so it
    carries no gradient."""
    m, l, acc = state
    b, s, h, d = q.shape
    hkv = m.shape[1]
    group = h // hkv
    if use_flash:
        o_n, lse = _FlashBlock.apply(q, k_blk, v_blk, causal, scale)
        lse = lse.reshape(b, hkv, group, s)[..., None]
        o_n = o_n.reshape(b, s, hkv, group, d).float()
        m_new = torch.maximum(m, lse.detach())
        corr = torch.exp(m - m_new)
        w = torch.exp(lse - m_new)
        l_new = l * corr + w
        acc_new = (acc * corr.permute(0, 3, 1, 2, 4)
                   + o_n * w.permute(0, 3, 1, 2, 4))
        return m_new, l_new, acc_new
    logits = _block_logits(q, k_blk, scale, causal)
    m_new = torch.maximum(m, logits.detach().amax(-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    acc_new = acc * corr.permute(0, 3, 1, 2, 4) + torch.einsum(
        'bhgqk,bkhd->bqhgd', p, v_blk.float())
    return m_new, l_new, acc_new


def _init_state(q, hkv):
    b, s, h, d = q.shape
    group = h // hkv
    dev = q.device
    return (torch.full((b, hkv, group, s, 1), _NEG_INF, dtype=torch.float32,
                       device=dev),
            torch.zeros((b, hkv, group, s, 1), dtype=torch.float32,
                        device=dev),
            torch.zeros((b, s, hkv, group, d), dtype=torch.float32,
                        device=dev))


def _finish(state, q):
    _, l, acc = state
    b, s, h, d = q.shape
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
def _rotation(sp: int) -> dict:
    return {i: (i + 1) % sp for i in range(sp)}


def _ring_body(comm, q, k, v, *, causal: bool, scale: float,
               use_flash: bool):
    """Contiguous layout. ``q``/``k``/``v``: lists over ``comm.ranks``
    of the local blocks ([b, s, h, d], [b, s, hkv, d])."""
    sp = comm.size
    kw = dict(scale=scale, use_flash=use_flash)
    states = [_init_state(qi, ki.shape[2]) for qi, ki in zip(q, k)]
    # Step 0: the diagonal block (own k/v).
    states = [_merge_block(st, qi, ki, vi, causal=causal, **kw)
              for st, qi, ki, vi in zip(states, q, k, v)]
    kv = [(ki, vi) for ki, vi in zip(k, v)]
    for t in range(1, sp):
        kv = comm.exchange([kv], [_rotation(sp)])[0]
        for i, r in enumerate(comm.ranks):
            # After t rotations rank r holds the block of rank r - t:
            # past when it is below r, future (skipped) otherwise.
            src = (r - t) % sp
            if causal and src > r:
                if not comm.lockstep:
                    # A skipped block is still used, times zero, so the
                    # backward's sends run on every rank of the ring.
                    m, l, acc = states[i]
                    states[i] = (m, l + (kv[i][0].float().sum()
                                         + kv[i][1].float().sum()) * 0,
                                 acc)
                continue
            states[i] = _merge_block(states[i], q[i], kv[i][0], kv[i][1],
                                     causal=False, **kw)
    return [_finish(st, qi) for st, qi in zip(states, q)]


def _zigzag_perms(sp: int):
    """The two maps that deal contiguous half-blocks into the zigzag
    layout (rank r's contiguous halves 2r and 2r + 1; zigzag wants
    halves r and 2 sp - 1 - r), and their inverses."""
    t0 = {r: (2 * r if 2 * r < sp else 2 * sp - 1 - 2 * r)
          for r in range(sp)}
    t1 = {r: (2 * r + 1 if 2 * r + 1 < sp else 2 * sp - 2 - 2 * r)
          for r in range(sp)}
    inv0 = {dst: src for src, dst in t0.items()}
    inv1 = {dst: src for src, dst in t1.items()}
    return t0, t1, inv0, inv1


def _zigzag_deal(comm, bundle):
    """Per rank a tuple of [b, s, ...] contiguous blocks -> (lo, hi)
    zigzag halves per rank: lo = global half ``rank``, hi = ``2 sp - 1 -
    rank``."""
    sp = comm.size
    t0, t1, _, _ = _zigzag_perms(sp)
    firsts = [tuple(x[:, :x.shape[1] // 2] for x in t) for t in bundle]
    seconds = [tuple(x[:, x.shape[1] // 2:] for x in t) for t in bundle]
    r0, r1 = comm.exchange([firsts, seconds], [t0, t1])
    lo = [a if r % 2 == 0 else b for r, a, b in zip(comm.ranks, r0, r1)]
    hi = [b if r % 2 == 0 else a for r, a, b in zip(comm.ranks, r0, r1)]
    return lo, hi


def _zigzag_undeal(comm, lo, hi):
    """The inverse of :func:`_zigzag_deal` for one tensor per rank."""
    sp = comm.size
    _, _, inv0, inv1 = _zigzag_perms(sp)
    via0 = [(a if r % 2 == 0 else b,) for r, a, b in zip(comm.ranks, lo, hi)]
    via1 = [(b if r % 2 == 0 else a,) for r, a, b in zip(comm.ranks, lo, hi)]
    b0, b1 = comm.exchange([via0, via1], [inv0, inv1])
    return [torch.cat([x[0], y[0]], dim=1) for x, y in zip(b0, b1)]


def _zigzag_body(comm, q, k, v, *, scale: float, use_flash: bool):
    """Balanced causal ring: every rank computes 3 half-block pairs on
    the diagonal tick and 2 on every later step."""
    sp = comm.size
    lo, hi = _zigzag_deal(comm, [(qi, ki, vi) for qi, ki, vi in zip(q, k, v)])
    kw = dict(scale=scale, use_flash=use_flash)
    st_lo = [_init_state(a[0], a[1].shape[2]) for a in lo]
    st_hi = [_init_state(a[0], a[1].shape[2]) for a in hi]
    for i in range(len(comm.ranks)):
        (q_lo, k_lo, v_lo), (q_hi, k_hi, v_hi) = lo[i], hi[i]
        st_lo[i] = _merge_block(st_lo[i], q_lo, k_lo, v_lo, causal=True, **kw)
        st_hi[i] = _merge_block(st_hi[i], q_hi, k_lo, v_lo, causal=False,
                                **kw)
        st_hi[i] = _merge_block(st_hi[i], q_hi, k_hi, v_hi, causal=True, **kw)
    kv = [(a[1], a[2], b[1], b[2]) for a, b in zip(lo, hi)]
    for t in range(1, sp):
        kv = comm.exchange([kv], [_rotation(sp)])[0]
        for i, r in enumerate(comm.ranks):
            q_lo, q_hi = lo[i][0], hi[i][0]
            kl, vl, kh, vh = kv[i]
            if (r - t) % sp < r:
                # The source's lo half is past both our halves; its hi
                # half is future for both.
                st_lo[i] = _merge_block(st_lo[i], q_lo, kl, vl,
                                        causal=False, **kw)
                st_hi[i] = _merge_block(st_hi[i], q_hi, kl, vl,
                                        causal=False, **kw)
            else:
                # Its lo half is future for q_lo, past for q_hi; its hi
                # half is past for q_hi only.
                st_hi[i] = _merge_block(st_hi[i], q_hi, kl, vl,
                                        causal=False, **kw)
                st_hi[i] = _merge_block(st_hi[i], q_hi, kh, vh,
                                        causal=False, **kw)
    out_lo = [_finish(st, a[0]) for st, a in zip(st_lo, lo)]
    out_hi = [_finish(st, a[0]) for st, a in zip(st_hi, hi)]
    return _zigzag_undeal(comm, out_lo, out_hi)


def ring_schedule_cost(sp: int, rank: int, layout: str) -> float:
    """Static per-rank compute cost in full-block-pair units (an s x s
    block = 1.0; a half pair 0.25; a half diagonal 0.125): the
    reference's balance measure."""
    if layout == 'contiguous':
        return 0.5 + rank
    del rank
    return 0.5 + (sp - 1) * 0.5


def ring_block_calls(sp: int, rank: int, layout: str,
                     causal: bool = True) -> int:
    """Block pairs rank ``rank`` computes (K4 launches under the flash
    body): the diagonal and the past blocks (contiguous; every block
    when not causal), or 3 on the diagonal tick and 2 a later step
    (zigzag)."""
    if layout == 'contiguous':
        return 1 + (rank if causal else sp - 1)
    return 3 + 2 * (sp - 1)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _expand_kv(q, k, v, modulus: int):
    """GQA kv in per-q-head form when the kv heads do not divide
    ``modulus`` (the local kv heads would not pair with the local q
    heads positionally)."""
    if k.shape[2] % modulus == 0:
        return k, v
    rep = q.shape[2] // k.shape[2]
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def seq_parallel_call(q, k, v, mesh, body, *, kv_head_modulus: int = 1):
    """The shared scaffolding of the sequence-parallel ops: the
    divisibility check, GQA kv expansion when the kv heads do not divide
    ``kv_head_modulus`` (1 for the ring; sp for Ulysses, whose heads are
    split over sp), and the split into blocks.

    ``mesh`` is an sp count or a ``MeshSpec`` (every rank in this
    process, :class:`LockstepComm`: q/k/v are the whole sequence) or
    None (this rank of the active training mesh, :class:`MeshComm`:
    q/k/v are this rank's block). ``body(comm, qs, ks, vs)`` maps lists
    of blocks to a list of outputs."""
    if mesh is None:
        comm = MeshComm()
        k, v = _expand_kv(q, k, v, kv_head_modulus)
        return body(comm, [q], [k], [v])[0]
    sp = mesh if isinstance(mesh, int) else mesh_lib.mesh_axis_sizes(
        mesh)['sp']
    if q.shape[1] % sp:
        raise ValueError(
            f'sequence-parallel attention needs seq ({q.shape[1]}) '
            f'divisible by sp={sp}')
    k, v = _expand_kv(q, k, v, kv_head_modulus)
    comm = LockstepComm(sp)
    outs = body(comm, list(q.chunk(sp, dim=1)), list(k.chunk(sp, dim=1)),
                list(v.chunk(sp, dim=1)))
    return torch.cat(outs, dim=1)


def _use_flash(block_impl: str, q, k) -> bool:
    if block_impl == 'flash':
        return True
    if block_impl == 'einsum':
        return False
    if block_impl != 'auto':
        raise ValueError(f'unknown block_impl {block_impl!r}')
    from skypilot_tpu_torch.ops.attention import _flash_takes
    return _flash_takes(q, k)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, causal: bool = True,
                   scale: Optional[float] = None, layout: str = 'auto',
                   block_impl: str = 'auto') -> torch.Tensor:
    """Exact attention with the sequence split over sp (see
    :func:`seq_parallel_call` for ``mesh``). ``layout='zigzag'`` (auto
    for causal with even local halves) balances the causal work;
    ``block_impl='flash'`` (auto on CUDA where K4 takes the shape) runs
    each block pair through K4. Differentiable."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sp = (mesh_lib.training().mesh.axis_size('sp') if mesh is None else
          mesh if isinstance(mesh, int) else
          mesh_lib.mesh_axis_sizes(mesh)['sp'])
    s_local = q.shape[1] if mesh is None else q.shape[1] // sp
    if sp == 1:
        from skypilot_tpu_torch.ops.attention import reference_attention
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if layout == 'auto':
        layout = ('zigzag' if causal and s_local % 2 == 0 else
                  'contiguous')
    if layout not in ('zigzag', 'contiguous'):
        raise ValueError(f'unknown ring layout {layout!r}')
    use_flash = _use_flash(block_impl, q, k)

    def body(comm, qs, ks, vs):
        if layout == 'zigzag' and causal:
            return _zigzag_body(comm, qs, ks, vs, scale=scale,
                                use_flash=use_flash)
        return _ring_body(comm, qs, ks, vs, causal=causal, scale=scale,
                          use_flash=use_flash)
    return seq_parallel_call(q, k, v, mesh, body)
