"""Seeded weights in the port's parameter layout, drawn on the device.

Both sides of the comparison get these tensors: the server under test
as its ``params=`` and the plain reference, which draws them again from
the same seed on the same device after the server has exited. Each
stacked leaf is drawn one layer slice at a time (one ``normal_`` call of
up to 470 M values), each slice from a generator of its own seeded by
``(seed, leaf, layer)``, so a slice never depends on the order of the
draws and the reference could draw one layer alone.

Layout (the port's ``models/llama.py``): ``embed [V, d]``, ``unembed
[d, V]``, ``final_norm [d]`` fp32, and under ``layers`` stacks on a
leading ``[L]`` axis: ``attn_norm``/``ffn_norm [L, d]`` fp32, ``wq [L,
d, h, hd]``, ``wk``/``wv [L, d, hkv, hd]``, ``wo [L, h, hd, d]``, the
dense ``w_gate``/``w_up [L, d, f]`` and ``w_down [L, f, d]`` or the
experts' ``router [L, d, E]``, ``moe_gate``/``moe_up [L, E, d, f]`` and
``moe_down [L, E, f, d]``, and for Qwen2 fp32 biases ``bq [L, h, hd]``,
``bk``/``bv [L, hkv, hd]``.

Matrices are ``N(0, 1) * fan_in ** -0.5`` in bf16; norm gains are
``1 + 0.1 N(0, 1)`` and biases ``0.5 N(0, 1)``, in fp32, so that
neither path is the identity.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

from perfbench.reference.sizes import Sizes

DTYPE = torch.bfloat16
BIAS_STD = 0.5
NORM_STD = 0.1


def _seed(seed: int, leaf: str, layer: int) -> int:
    h = hashlib.sha256(f'{int(seed)}/{leaf}/{layer}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') & ((1 << 63) - 1)


def _gen(device, seed: int, leaf: str, layer: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, leaf, layer))
    return g


def leaf_shapes(s: Sizes) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Each stacked matrix leaf: (per-layer shape, fan-in)."""
    d, h, kv, hd, f = s.dim, s.n_heads, s.n_kv_heads, s.head_dim, s.ffn
    out = {'wq': ((d, h, hd), d), 'wk': ((d, kv, hd), d),
           'wv': ((d, kv, hd), d), 'wo': ((h, hd, d), h * hd)}
    if s.is_moe:
        E = s.n_experts
        out.update(router=((d, E), d), moe_gate=((E, d, f), d),
                   moe_up=((E, d, f), d), moe_down=((E, f, d), f))
    else:
        out.update(w_gate=((d, f), d), w_up=((d, f), d),
                   w_down=((f, d), f))
    return out


def _fill(w: torch.Tensor, fan_in: int, gen) -> torch.Tensor:
    """``w`` drawn in place: N(0, 1) * fan_in ** -0.5 in its dtype."""
    return w.normal_(0.0, 1.0, generator=gen).mul_(fan_in ** -0.5)


def _matrix(shape, fan_in, gen, device) -> torch.Tensor:
    return _fill(torch.empty(shape, dtype=DTYPE, device=device), fan_in,
                 gen)


def _vector(shape, mean, std, gen, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(mean, std, generator=gen)


def make_params(s: Sizes, seed: int, device) -> Dict:
    """The whole tree on ``device`` (bf16 matrices, fp32 norms and
    biases)."""
    device = torch.device(device)
    L = s.n_layers
    p: Dict = {'embed': _matrix((s.vocab, s.dim), s.dim,
                                _gen(device, seed, 'embed', 0), device)}
    if not s.tie_embeddings:
        p['unembed'] = _matrix((s.dim, s.vocab), s.dim,
                               _gen(device, seed, 'unembed', 0), device)
    p['final_norm'] = _vector((s.dim,), 1.0, NORM_STD,
                              _gen(device, seed, 'final_norm', 0), device)
    layers = {
        'attn_norm': _vector((L, s.dim), 1.0, NORM_STD,
                             _gen(device, seed, 'attn_norm', 0), device),
        'ffn_norm': _vector((L, s.dim), 1.0, NORM_STD,
                            _gen(device, seed, 'ffn_norm', 0), device),
    }
    for name, (shape, fan_in) in leaf_shapes(s).items():
        out = torch.empty((L,) + shape, dtype=DTYPE, device=device)
        for li in range(L):
            _fill(out[li], fan_in, _gen(device, seed, name, li))
        layers[name] = out
    if s.qkv_bias:
        for name, heads in (('bq', s.n_heads), ('bk', s.n_kv_heads),
                            ('bv', s.n_kv_heads)):
            layers[name] = _vector((L, heads, s.head_dim), 0.0, BIAS_STD,
                                   _gen(device, seed, name, 0), device)
    p['layers'] = layers
    return p
