"""The benchmark's own yardstick: the card's peaks, and the bytes and
operations a configuration's work needs, from its shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity),
which assume the card's full 700 W power limit; every reading that
divides by one is printed beside the card's name and power limit.

Counts are what the inputs need, not what the program does: a
parameter is read once per step, a KV row once per decode step that
attends to it, a prompt token's unembedding is not needed (only the
last prompt token's is), a Mixtral token passes through its two
experts only.
"""
from __future__ import annotations

from perfbench.reference.sizes import Sizes

PEAK_BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
CARD_MEMORY_BYTES = 80e9
BF16, FP32 = 2, 4


def _attn_matrices(s: Sizes) -> int:
    q, kv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    return s.dim * q * 2 + s.dim * kv * 2          # wq, wo, wk, wv


def _ffn_matrices(s: Sizes, experts: int) -> int:
    return 3 * s.dim * s.ffn * experts


def _vectors(s: Sizes) -> int:
    """fp32 leaves: norms (and Qwen2's biases)."""
    n = 2 * s.dim * s.n_layers + s.dim
    if s.qkv_bias:
        n += (s.n_heads + 2 * s.n_kv_heads) * s.head_dim * s.n_layers
    return n


def _embedding_matrices(s: Sizes) -> int:
    return s.vocab * s.dim * (1 if s.tie_embeddings else 2)


def _layer_matrices(s: Sizes, experts: int) -> int:
    router = s.dim * s.n_experts if s.is_moe else 0
    return _attn_matrices(s) + _ffn_matrices(s, experts) + router


def param_count(s: Sizes) -> int:
    experts = s.n_experts if s.is_moe else 1
    return (_embedding_matrices(s) + s.n_layers * _layer_matrices(s, experts)
            + _vectors(s))


def param_bytes(s: Sizes) -> int:
    """The weights as served: bf16 matrices, fp32 norms and biases."""
    vec = _vectors(s)
    return (param_count(s) - vec) * BF16 + vec * FP32


def kv_bytes_per_token(s: Sizes) -> int:
    """Keys and values of one token over every layer, in bf16."""
    return 2 * s.n_layers * s.n_kv_heads * s.head_dim * BF16


def token_matmul_flops(s: Sizes, unembed: bool = True) -> float:
    """2 x the weights one token multiplies through (its experts only;
    the embedding is a lookup), with or without the unembedding."""
    experts = s.experts_per_token if s.is_moe else 1
    n = s.n_layers * _layer_matrices(s, experts)
    if unembed:
        n += s.vocab * s.dim
    return 2.0 * n


def attention_flops(s: Sizes, keys: int) -> float:
    """Scores and the weighted sum of one query over ``keys`` keys, in
    every layer."""
    return 4.0 * s.n_layers * s.n_heads * s.head_dim * keys


def attention_flops_span(s: Sizes, first: int, n: int) -> float:
    """Causal attention of the ``n`` queries at positions ``first`` ..
    ``first + n - 1`` (query ``p`` attends ``p + 1`` keys)."""
    keys = n * (first + 1) + n * (n - 1) // 2
    return 4.0 * s.n_layers * s.n_heads * s.head_dim * keys
