"""Model configurations (own copy of ``skypilot_tpu/models/configs.py``
with ``dtype`` as a ``torch.dtype``).

The port runs the Llama (SwiGLU, RMSNorm ``x * w``, untied embeddings),
Gemma (GeGLU, RMSNorm ``x * (1 + w)``, tied and ``sqrt(dim)``-scaled
embeddings), Qwen2 (biases on the q/k/v projections) and Mixtral
(routed SwiGLU experts, ``models/moe.py``) families. A configuration
with LoRA adapters (``lora_rank > 0``) trains only its adapters
(``train/trainer.py``) and is served with them folded into the base
weights (``models/lora.py``: ``maybe_merge``). Per-request adapters are
the engines' multi-LoRA bank (``models/multilora.py``,
``inference/adapters.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder-only transformer configuration (Llama-family)."""
    name: str
    vocab_size: int
    dim: int                    # model/embedding width
    n_layers: int
    n_heads: int
    n_kv_heads: int             # < n_heads => grouped-query attention
    ffn_dim: int                # SwiGLU hidden width
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE fields (None => dense FFN)
    n_experts: Optional[int] = None
    n_experts_per_token: int = 2
    # Expert buffer size = tokens * k / E * this factor (GShard capacity;
    # tokens routed past a full expert are dropped to the residual path).
    moe_capacity_factor: float = 1.25
    # Remat policy for training: 'none' | 'block' | 'attn' | 'dots'
    # (models/remat.py).
    remat: str = 'block'
    tie_embeddings: bool = False
    activation: str = 'silu'            # 'silu' | 'gelu'
    norm_plus_one: bool = False
    scale_embeddings: bool = False
    head_dim_override: Optional[int] = None
    qkv_bias: bool = False
    # LoRA (the reference's fields): rank > 0 means the param tree
    # carries adapter leaves under ``params['layers']['lora']``: the
    # only trainable leaves, folded into the base weights at serving
    # load (``W += alpha / rank * A @ B``).
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ('wq', 'wk', 'wv', 'wo')

    @property
    def lora_enabled(self) -> bool:
        return self.lora_rank > 0

    @property
    def lora_scale(self) -> float:
        return self.lora_alpha / max(self.lora_rank, 1)

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        q_dim = self.n_heads * self.head_dim
        kv_dim = self.n_kv_heads * self.head_dim
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d   # wq, wk, wv, wo
        ffn = 3 * d * f
        if self.is_moe:
            ffn *= self.n_experts
            ffn += d * self.n_experts           # router
        per_layer = attn + ffn + 2 * d          # + 2 norms
        embeds = v * d if self.tie_embeddings else v * d * 2
        return embeds + self.n_layers * per_layer + d

    @property
    def active_params(self) -> int:
        """Parameters a token passes through: :attr:`num_params` with
        only ``n_experts_per_token`` of the experts counted."""
        n = self.num_params
        if self.is_moe:
            dense_ffn = 3 * self.dim * self.ffn_dim * self.n_layers
            n = (n - dense_ffn * self.n_experts
                 + dense_ffn * self.n_experts_per_token)
        return n

    def flops_per_token(self, training: bool = False) -> float:
        """~2*N matmul FLOPs per token fwd (6*N with backward), N the
        active parameters (only active experts count)."""
        return (6.0 if training else 2.0) * self.active_params


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise for an unknown activation (``ValueError``) or a dtype the
    port does not run (``NotImplementedError``); returns ``cfg``
    unchanged otherwise."""
    if cfg.activation not in ('silu', 'gelu'):
        raise ValueError(f'unknown activation {cfg.activation!r}')
    if cfg.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f'dtype {cfg.dtype} is not supported; '
                                  'use torch.bfloat16 or torch.float32')
    return cfg


# --- Presets ---------------------------------------------------------------
LLAMA3_8B = ModelConfig(name='llama3-8b', vocab_size=128256, dim=4096,
                        n_layers=32, n_heads=32, n_kv_heads=8,
                        ffn_dim=14336)

LLAMA3_70B = ModelConfig(name='llama3-70b', vocab_size=128256, dim=8192,
                         n_layers=80, n_heads=64, n_kv_heads=8,
                         ffn_dim=28672)

LLAMA2_7B = ModelConfig(name='llama2-7b', vocab_size=32000, dim=4096,
                        n_layers=32, n_heads=32, n_kv_heads=32,
                        ffn_dim=11008, rope_theta=10000.0,
                        max_seq_len=4096)

# ~1.5B-param config: the trainer's single-card model (full-parameter
# AdamW state fits one 80 GB card).
LLAMA3_1B = ModelConfig(name='llama3-1b', vocab_size=128256, dim=2048,
                        n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192)

MIXTRAL_8X7B = ModelConfig(name='mixtral-8x7b', vocab_size=32000, dim=4096,
                           n_layers=32, n_heads=32, n_kv_heads=8,
                           ffn_dim=14336, rope_theta=1000000.0, n_experts=8,
                           n_experts_per_token=2)

# Tiny configs for CPU tests.
TINY = ModelConfig(name='tiny', vocab_size=256, dim=64, n_layers=2,
                   n_heads=4, n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                   remat='none')

TINY_MOE = ModelConfig(name='tiny-moe', vocab_size=256, dim=64, n_layers=2,
                       n_heads=4, n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                       n_experts=4, n_experts_per_token=2, remat='none')

GEMMA_2B = ModelConfig(name='gemma-2b', vocab_size=256128, dim=2048,
                       n_layers=18, n_heads=8, n_kv_heads=1, ffn_dim=16384,
                       rope_theta=10000.0, tie_embeddings=True,
                       activation='gelu', norm_plus_one=True,
                       scale_embeddings=True)

# As the reference has it: no head_dim_override, so head_dim is
# 3072 / 16 = 192 (the published model's 256 comes through
# ``head_dim_override`` when a config.json says so).
GEMMA_7B = ModelConfig(name='gemma-7b', vocab_size=256128, dim=3072,
                       n_layers=28, n_heads=16, n_kv_heads=16, ffn_dim=24576,
                       rope_theta=10000.0, tie_embeddings=True,
                       activation='gelu', norm_plus_one=True,
                       scale_embeddings=True)

TINY_GEMMA = ModelConfig(name='tiny-gemma', vocab_size=256, dim=64,
                         n_layers=2, n_heads=4, n_kv_heads=1, ffn_dim=128,
                         max_seq_len=128, remat='none', tie_embeddings=True,
                         activation='gelu', norm_plus_one=True,
                         scale_embeddings=True)

QWEN2_7B = ModelConfig(name='qwen2-7b', vocab_size=152064, dim=3584,
                       n_layers=28, n_heads=28, n_kv_heads=4, ffn_dim=18944,
                       rope_theta=1000000.0, qkv_bias=True,
                       max_seq_len=32768)

TINY_QWEN = ModelConfig(name='tiny-qwen', vocab_size=256, dim=64,
                        n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                        max_seq_len=128, remat='none', qkv_bias=True)

PRESETS = {c.name: c for c in [
    LLAMA3_8B, LLAMA3_70B, LLAMA2_7B, LLAMA3_1B, MIXTRAL_8X7B, GEMMA_2B,
    GEMMA_7B, QWEN2_7B, TINY, TINY_MOE, TINY_GEMMA, TINY_QWEN]}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise ValueError(f'Unknown model {name!r}. Known: {sorted(PRESETS)}')
    return PRESETS[name]
