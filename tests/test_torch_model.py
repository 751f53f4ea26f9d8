"""The port's model layer held against ``skypilot_tpu.models.llama`` on
the CPU: the same weights (the JAX tree converted with
``params_from_numpy``) and the same numpy inputs through both forwards,
fp32, logits within 1e-4 absolute (matmuls and transcendental functions
round differently in the two frameworks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import configs as tconfigs
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models.convert import params_from_numpy

jax.config.update('jax_platforms', 'cpu')

JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)


@pytest.fixture(scope='module')
def weights():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.device_get(jp), TCFG, device='cpu')
    return jp, tp


def test_forward_logits_match_jax(weights):
    jp, tp = weights
    tokens = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(
        np.int32)
    want, _ = jllama.forward(jp, jnp.asarray(tokens), JCFG)
    got = tllama.forward(tp, torch.from_numpy(tokens), TCFG)
    assert got.dtype == torch.float32 and got.shape == (2, 11, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_bf16_tree_converts_bit_exact():
    jcfg, tcfg = jconfigs.TINY, tconfigs.TINY          # bf16 weights
    jp = jax.device_get(jllama.init_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_numpy(jp, tcfg, device='cpu')
    assert tp['layers']['wq'].dtype == torch.bfloat16
    assert tp['final_norm'].dtype == torch.float32
    np.testing.assert_array_equal(
        tp['layers']['w_up'].float().numpy(),
        np.asarray(jp['layers']['w_up']).astype(np.float32))


def test_blocks_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tllama.rope(torch.from_numpy(x), torch.from_numpy(pos),
                    10000.0).numpy(),
        np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=1e-4, rtol=0)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(h), torch.from_numpy(w),
                        1e-5).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(h), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=0)


def test_filtered_logits_and_masks_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 32)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    topks = np.array([0, 5, 0, 3], np.int32)
    topps = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    want = jllama.filtered_logits(jnp.asarray(logits), jnp.asarray(temps),
                                  jnp.asarray(topks), jnp.asarray(topps))
    got = tllama.filtered_logits(*(torch.from_numpy(a) for a in
                                   (logits, temps, topks, topps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    logits[1, 3] = np.nan
    toks = np.array([1, 2, 3, 4], np.int32)
    np.testing.assert_array_equal(
        tllama.mask_nonfinite_tokens(torch.from_numpy(logits),
                                     torch.from_numpy(toks)).numpy(),
        np.asarray(jllama.mask_nonfinite_tokens(jnp.asarray(logits),
                                                jnp.asarray(toks))))
    mask = rng.random((4, 32)) > 0.5
    np.testing.assert_array_equal(
        tllama.apply_vocab_mask(torch.from_numpy(logits),
                                torch.from_numpy(mask)).numpy(),
        np.asarray(jllama.apply_vocab_mask(jnp.asarray(logits),
                                           jnp.asarray(mask))))


def test_init_params_layout_and_scale():
    p = tllama.init_params(TCFG, 0, device='cpu')
    j = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0),
                                                  JCFG))
    assert set(p['layers']) == set(j['layers'])
    for k, v in j['layers'].items():
        assert tuple(p['layers'][k].shape) == tuple(v.shape), k
    std = p['layers']['w_down'].std().item()
    assert abs(std - TCFG.ffn_dim ** -0.5) < 0.1 * TCFG.ffn_dim ** -0.5
    again = tllama.init_params(TCFG, 0, device='cpu')
    assert torch.equal(p['embed'], again['embed'])      # seeded


def test_configs_match_and_unsupported_knobs_raise():
    """Every preset of the reference, the MoE ones included, is in the
    port with the same numbers, ``flops_per_token`` (active experts
    only) included; LoRA configs, the family and MoE knobs pass, an
    unknown activation raises."""
    names = sorted(jconfigs.PRESETS)
    assert sorted(tconfigs.PRESETS) == names and len(names) == 12
    fields = ('vocab_size', 'dim', 'n_layers', 'n_heads', 'n_kv_heads',
              'ffn_dim', 'max_seq_len', 'rope_theta', 'norm_eps', 'remat',
              'tie_embeddings', 'activation', 'norm_plus_one',
              'scale_embeddings', 'head_dim_override', 'qkv_bias',
              'lora_rank', 'num_params', 'head_dim', 'n_experts',
              'n_experts_per_token', 'moe_capacity_factor', 'is_moe')
    for name in names:
        tc, jc = tconfigs.get_config(name), jconfigs.get_config(name)
        for field in fields:
            assert getattr(tc, field) == getattr(jc, field), (name, field)
        assert tc.flops_per_token(True) == jc.flops_per_token(True)
        assert tc.flops_per_token(False) == jc.flops_per_token(False)
        assert tconfigs.check_supported(tc) is tc
    assert tconfigs.GEMMA_7B.head_dim == 192      # as the reference has it
    moe = dataclasses.replace(tconfigs.TINY, n_experts=4)
    assert tconfigs.check_supported(moe) is moe
    lora_cfg = dataclasses.replace(tconfigs.TINY, lora_rank=4)
    assert tconfigs.check_supported(lora_cfg) is lora_cfg
    with pytest.raises(ValueError):
        tconfigs.check_supported(dataclasses.replace(tconfigs.TINY,
                                                     activation='relu'))
