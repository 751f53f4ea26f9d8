"""A configuration's shapes, read from its HF ``config.json`` keys.

Only the keys the plain reference needs: the Qwen2 and Mixtral families
(``model_type`` ``qwen2`` or ``mixtral``), both Llama-style decoders
with RMSNorm, rotary embeddings on the split halves of each head,
grouped-query attention and SwiGLU feed-forward layers. Qwen2 adds
biases on the q, k and v projections; Mixtral replaces the dense
feed-forward layer with routed experts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Sizes:
    model_type: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    rope_theta: float
    norm_eps: float
    qkv_bias: bool
    tie_embeddings: bool
    n_experts: Optional[int] = None
    experts_per_token: int = 2

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> 'Sizes':
        kind = hf['model_type']
        if kind not in ('qwen2', 'mixtral'):
            raise ValueError(f'no plain reference for model_type {kind!r}')
        dim, heads = hf['hidden_size'], hf['num_attention_heads']
        return cls(
            model_type=kind, vocab=hf['vocab_size'], dim=dim,
            n_layers=hf['num_hidden_layers'], n_heads=heads,
            n_kv_heads=hf.get('num_key_value_heads', heads),
            head_dim=hf.get('head_dim') or dim // heads,
            ffn=hf['intermediate_size'],
            rope_theta=float(hf.get('rope_theta', 10000.0)),
            norm_eps=float(hf.get('rms_norm_eps', 1e-6)),
            qkv_bias=kind == 'qwen2',
            tie_embeddings=bool(hf.get('tie_word_embeddings', False)),
            n_experts=hf.get('num_local_experts') if kind == 'mixtral'
            else None,
            experts_per_token=hf.get('num_experts_per_tok', 2))
