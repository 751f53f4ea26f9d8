"""The plain reference: a Qwen2 or Mixtral decoder forward in fp32.

Plain ``torch`` operations only, with no cache, kernels or batching
across sequences: each sequence attends causally over itself, and the
logits of chosen positions come out in fp32. TF32 is switched off while
it runs, so every fp32 product is an fp32 product.

The equations, as the published models define them:

- RMSNorm: ``x * rsqrt(mean(x^2) + eps) * g``;
- attention: ``q = x Wq (+ bq)``, ``k = x Wk (+ bk)``, ``v = x Wv (+
  bv)`` (the biases are Qwen2's), rotary embedding on the two halves of
  each head (``theta ** (-2i / d)``), query head ``j`` reading kv head
  ``j // (h / hkv)``, softmax of ``q k / sqrt(d)`` over positions up to
  its own, ``o Wo``;
- dense feed-forward (Qwen2): ``(silu(x Wg) * x Wu) Wd``;
- experts (Mixtral): fp32 router logits ``x Wr``, the two largest
  (the lower expert index first on equal values), their softmax as
  weights, ``sum_e w_e (silu(x Wg_e) * x Wu_e) Wd_e``. No capacity, so
  no token is dropped.

Layer by layer: one layer's weights are widened to fp32 at a time, and
every sequence's rows go through that layer before the next, so the
fp32 model never exists whole (Mixtral's 16 layers would be 94 GB).

Routing near-ties (Mixtral, ``tie_margin``): where a token's k-th and
(k+1)-th router logits lie within ``tie_margin`` in some layer, a bf16
program may route it through the other expert there. For every checked
position the reference then also computes the variants that a bf16 run
could have taken: the (k+1)-th expert in place of the k-th at one of the
token's near-tie layers, or at two of them, the token's own later layers
recomputed over the unchanged keys and values of the positions before
it. A served token is judged against the variant that suits it best
(``check.py``).

``mode='fp8'`` is the control: the model as an fp8 serving path of a
bf16 program would compute it. Every product of activations and
weights (the projections, the router, the experts, the unembedding)
takes both operands rounded to float8 e4m3 first, the weights with a
scale per output column and the activations with one per row; the
residual stream and the queries, keys and values are carried in bf16,
as the program carries them. Sums and softmaxes stay fp32.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.reference.sizes import Sizes

_Q_BLOCK = 1024        # query rows per attention block
_ROW_BLOCK = 8192      # token rows per feed-forward block
_VAR_BLOCK = 256       # variant rows per attention block
_FP8_MAX = 448.0       # largest finite float8 e4m3 value


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the scale makes each slice's largest magnitude 448), back
    in fp32."""
    scale = x.abs().amax(dim, keepdim=True).clamp(min=1e-12) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Mm:
    """Products ``x @ w`` with ``w`` [in, out] in fp32 or, for the
    control, both operands rounded to fp8 first."""

    def __init__(self, mode: str):
        if mode not in ('fp32', 'fp8'):
            raise ValueError(f'unknown mode {mode!r}')
        self.fp8 = mode == 'fp8'

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, -1) if self.fp8 else x) @ w

    def carry(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the program keeps between operations: bf16 in the
        control, untouched in fp32."""
        return x.bfloat16().float() if self.fp8 else x


@dataclasses.dataclass
class Variants:
    """Routing variants of the checked positions (see the module
    docstring): ``logits`` [n, V] fp32, ``position`` [n] the index of
    each variant's position among all checked positions (in the order
    of ``logits_at``'s output), ``margin`` [n] the largest router margin
    among the layers where it takes the other expert."""
    logits: torch.Tensor
    position: torch.Tensor
    margin: torch.Tensor


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float
             ) -> torch.Tensor:
    """x [n, heads, d] at positions ``pos`` [n]."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (pos.to(torch.float64)[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, d] at positions 0..S-1."""
    return _rope_at(x, torch.arange(x.shape[0], device=x.device), theta)


def _attention(q, k, v, n_kv: int) -> torch.Tensor:
    """Causal softmax attention of one sequence: q [S, h, d], k and v
    [S, hkv, d] -> [S, h * d]."""
    S, h, d = q.shape
    group = h // n_kv
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)    # [h, S, d]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty(S, h, d, dtype=torch.float32, device=q.device)
    for a in range(0, S, _Q_BLOCK):
        b = min(S, a + _Q_BLOCK)
        qb = q[a:b].transpose(0, 1)                            # [h, n, d]
        s = (qb @ k[:, :b].transpose(1, 2)) * d ** -0.5        # [h, n, b]
        pos = torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(b, device=q.device)[None, :] > pos,
                          float('-inf'))
        out[a:b] = (torch.softmax(s, -1) @ v[:, :b]).transpose(0, 1)
    return out.reshape(S, h * d)


def _attention_rows(q, k_own, v_own, k_seq, v_seq, pos, n_kv: int
                    ) -> torch.Tensor:
    """Single rows of one sequence: query ``q`` [n, h, d] at positions
    ``pos`` [n] over the sequence's keys and values before it (``k_seq``,
    ``v_seq`` [S, hkv, d]) and its own (``k_own``, ``v_own`` [n, hkv,
    d]) -> [n, h * d]."""
    n, h, d = q.shape
    group = h // n_kv
    ks = k_seq.repeat_interleave(group, dim=1).transpose(0, 1)  # [h, S, d]
    vs = v_seq.repeat_interleave(group, dim=1).transpose(0, 1)
    ko = k_own.repeat_interleave(group, dim=1)                   # [n, h, d]
    vo = v_own.repeat_interleave(group, dim=1)
    s = torch.einsum('nhd,hsd->nhs', q, ks) * d ** -0.5
    s = s.masked_fill(torch.arange(ks.shape[1], device=q.device)[None, None]
                      >= pos[:, None, None], float('-inf'))
    own = (q * ko).sum(-1, keepdim=True) * d ** -0.5             # [n, h, 1]
    p = torch.softmax(torch.cat([s, own], -1), -1)
    out = torch.einsum('nhs,hsd->nhd', p[..., :-1], vs) + p[..., -1:] * vo
    return out.reshape(n, h * d)


def _dense_ffn(x, lw, mm: _Mm) -> torch.Tensor:
    wg, wu, wd = (mm.weight(lw[n]) for n in ('w_gate', 'w_up', 'w_down'))
    out = torch.empty_like(x)
    for a in range(0, x.shape[0], _ROW_BLOCK):
        xb = x[a:a + _ROW_BLOCK]
        out[a:a + _ROW_BLOCK] = mm(torch.nn.functional.silu(mm(xb, wg))
                                   * mm(xb, wu), wd)
    return out


def _moe_ffn(x, lw, s: Sizes, mm: _Mm,
             flip: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, each row's margin between its k-th and (k+1)-th router
    logit). Rows where ``flip`` [T] bool is set take the (k+1)-th
    expert in place of the k-th."""
    k = s.experts_per_token
    logits = mm(x, mm.weight(lw['router']))                  # [T, E]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = vals[:, k - 1] - vals[:, k]
    if flip is not None:
        vals, idx = vals[:, :k + 1].clone(), idx[:, :k + 1].clone()
        vals[flip, k - 1], idx[flip, k - 1] = vals[flip, k], idx[flip, k]
    w = torch.softmax(vals[:, :k], dim=-1)
    out = torch.zeros_like(x)
    for e in range(s.n_experts):
        rows, slot = (idx[:, :k] == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (mm.weight(lw[n][e])
                      for n in ('moe_gate', 'moe_up', 'moe_down'))
        for a in range(0, rows.numel(), _ROW_BLOCK):
            r, sl = rows[a:a + _ROW_BLOCK], slot[a:a + _ROW_BLOCK]
            xb = x[r]
            y = mm(torch.nn.functional.silu(mm(xb, wg)) * mm(xb, wu), wd)
            out.index_add_(0, r, y * w[r, sl][:, None])
    return out, margin


def logits_at(params: Dict, s: Sizes, seqs: Sequence[Sequence[int]],
              starts: Sequence[int], mode: str = 'fp32',
              tie_margin: Optional[float] = None,
              flips: Optional[Dict[int, torch.Tensor]] = None
              ) -> Tuple[List[torch.Tensor], Optional[Variants]]:
    """For each token sequence, the fp32 next-token logits [n, V] at
    its positions ``starts[i]`` to the end, and (Mixtral with
    ``tie_margin``, fp32 only) the routing variants of those positions.
    ``params`` is the seeded tree (``weights.make_params``) on the
    device the reference runs on. ``flips`` (for tests) maps a layer to
    a bool mask over every token of the concatenated sequences that
    takes the (k+1)-th expert there."""
    if tie_margin is not None and mode != 'fp32':
        raise ValueError('routing variants are computed in fp32 only')
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(params, s, seqs, starts, _Mm(mode),
                              tie_margin if s.is_moe else None, flips or {})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _qkv(x, lw, s: Sizes, mm: _Mm, pos: torch.Tensor, w):
    """Queries, keys and values of rows ``x`` at positions ``pos``, with
    the layer's widened projections ``w`` = (wq, wk, wv)."""
    hd, H, KV = s.head_dim, s.n_heads, s.n_kv_heads
    q, k, v = mm(x, w[0]), mm(x, w[1]), mm(x, w[2])
    if s.qkv_bias:
        q = q + lw['bq'].reshape(-1)
        k = k + lw['bk'].reshape(-1)
        v = v + lw['bv'].reshape(-1)
    n = x.shape[0]
    q = mm.carry(_rope_at(q.reshape(n, H, hd), pos, s.rope_theta))
    k = mm.carry(_rope_at(k.reshape(n, KV, hd), pos, s.rope_theta))
    return q, k, mm.carry(v.reshape(n, KV, hd))


def _layer_weights(params, li: int, s: Sizes, mm: _Mm):
    lw = {name: t[li] for name, t in params['layers'].items()}
    d, hd, H, KV = s.dim, s.head_dim, s.n_heads, s.n_kv_heads
    w = (mm.weight(lw['wq'].reshape(d, H * hd)),
         mm.weight(lw['wk'].reshape(d, KV * hd)),
         mm.weight(lw['wv'].reshape(d, KV * hd)))
    return lw, w, mm.weight(lw['wo'].reshape(H * hd, d))


def _logits_at(params, s: Sizes, seqs, starts, mm: _Mm,
               tie_margin: Optional[float], flips):
    dev = params['embed'].device
    lens = [len(t) for t in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    tokens = torch.tensor([t for seq in seqs for t in seq], device=dev)
    want = torch.cat([torch.arange(offs[i] + starts[i], offs[i + 1],
                                   device=dev) for i in range(len(seqs))])
    h = params['embed'][tokens].float()                       # [T, d]
    keep = tie_margin is not None
    # What the variants need: every layer's keys and values, and the
    # checked rows' residual before the FFN and router margins.
    kv_store, mid_store, margins = [], [], []
    for li in range(s.n_layers):
        lw, w, wo = _layer_weights(params, li, s, mm)
        x = _rms(h, lw['attn_norm'].float(), s.norm_eps)
        attn = torch.empty_like(h)
        ks, vs = [], []
        for i in range(len(seqs)):
            xs = x[offs[i]:offs[i + 1]]
            q, k, v = _qkv(xs, lw, s, mm,
                           torch.arange(xs.shape[0], device=dev), w)
            attn[offs[i]:offs[i + 1]] = _attention(q, k, v, s.n_kv_heads)
            ks.append(k)
            vs.append(v)
        if keep:
            kv_store.append((torch.cat(ks), torch.cat(vs)))
        del ks, vs
        for a in range(0, h.shape[0], _ROW_BLOCK):
            h[a:a + _ROW_BLOCK] = mm.carry(h[a:a + _ROW_BLOCK]
                                           + mm(attn[a:a + _ROW_BLOCK], wo))
        del attn, w, wo
        if keep:
            mid_store.append(h[want].clone())
        x = _rms(h, lw['ffn_norm'].float(), s.norm_eps)
        if s.is_moe:
            y, m = _moe_ffn(x, lw, s, mm, flips.get(li))
            if keep:
                margins.append(m[want])
        else:
            y = _dense_ffn(x, lw, mm)
        h = mm.carry(h + y)
        del x, y
    x = _rms(h[want], params['final_norm'].float(), s.norm_eps)
    unembed = (params['embed'].t() if s.tie_embeddings
               else params['unembed'])
    logits = mm(x, mm.weight(unembed))
    counts = [lens[i] - starts[i] for i in range(len(seqs))]
    out = list(torch.split(logits, counts))
    if not keep:
        return out, None
    seq_of = torch.cat([torch.full((c,), i, device=dev)
                        for i, c in enumerate(counts)])
    pos = want - torch.tensor(offs[:-1], device=dev)[seq_of]
    variants = _variants(params, s, mm, torch.stack(margins), tie_margin,
                         kv_store, mid_store, seq_of, pos, offs, unembed)
    return out, variants


def _variants(params, s: Sizes, mm: _Mm, margins, tie_margin, kv_store,
              mid_store, seq_of, pos, offs, unembed) -> Variants:
    """The routing variants (module docstring) of the checked rows:
    ``margins`` [L, W], the per-layer residual before the FFN
    ``mid_store`` [L][W, d] and keys and values ``kv_store``."""
    dev = margins.device
    L, W = margins.shape
    near = (margins < tie_margin).t().cpu()                     # [W, L]
    rows, flip_sets = [], []
    for w in range(W):
        layers = near[w].nonzero().flatten().tolist()
        for r in (1, 2):
            for combo in itertools.combinations(layers, r):
                rows.append(w)
                flip_sets.append(combo)
    n = len(rows)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        return Variants(torch.zeros(0, s.vocab, device=dev), empty,
                        torch.zeros(0, device=dev))
    row = torch.tensor(rows, device=dev)
    flip = torch.zeros(n, L, dtype=torch.bool)
    for v, combo in enumerate(flip_sets):
        flip[v, list(combo)] = True
    flip = flip.to(dev)
    first = torch.tensor([min(c) for c in flip_sets], device=dev)
    margin = margins.t()[row].masked_fill(~flip, float('-inf')).amax(1)
    h = torch.zeros(n, s.dim, device=dev)
    vpos, vseq = pos[row], seq_of[row]
    for li in range(int(first.min()), L):
        lw, w, wo = _layer_weights(params, li, s, mm)
        later = (first < li).nonzero().flatten()
        if later.numel():
            x = _rms(h[later], lw['attn_norm'].float(), s.norm_eps)
            q, k, v = _qkv(x, lw, s, mm, vpos[later], w)
            attn = torch.empty_like(x)
            k_all, v_all = kv_store[li]
            for i in vseq[later].unique().tolist():
                sel = (vseq[later] == i).nonzero().flatten()
                k_seq, v_seq = k_all[offs[i]:offs[i + 1]], \
                    v_all[offs[i]:offs[i + 1]]
                for a in range(0, sel.numel(), _VAR_BLOCK):
                    b = sel[a:a + _VAR_BLOCK]
                    attn[b] = _attention_rows(q[b], k[b], v[b], k_seq, v_seq,
                                              vpos[later][b], s.n_kv_heads)
            h[later] = h[later] + mm(attn, wo)
            del attn
        start = (first == li).nonzero().flatten()
        h[start] = mid_store[li][row[start]]
        live = (first <= li).nonzero().flatten()
        x = _rms(h[live], lw['ffn_norm'].float(), s.norm_eps)
        y, _ = _moe_ffn(x, lw, s, mm, flip[live, li])
        h[live] = h[live] + y
        del w, wo, x, y
    x = _rms(h, params['final_norm'].float(), s.norm_eps)
    return Variants(mm(x, mm.weight(unembed)), row, margin)
