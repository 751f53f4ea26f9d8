"""The port's flash-attention forward (K4, K3) and the attention
dispatch held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
flash kernels run in Pallas interpret mode (``flash_attention(...,
interpret=True)``; ``_fwd(..., interpret=True)`` for the logsumexp), as
the JAX package's own tests run them; the port's wrappers take their
plain versions for CPU tensors. Everything is fp32; tolerance 1e-5
absolute on the output and on the logsumexp (the two sides sum in
different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jattn
from skypilot_tpu.ops import flash_attention as jfa
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.ops import flash_attention as tfa

jax.config.update('jax_platforms', 'cpu')

ATOL = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.array(x))


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


GEOS = [(4, 4), (4, 2)]          # (hq, hkv): MHA and GQA


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('hq,hkv', GEOS)
@pytest.mark.parametrize('b,s,d', [(2, 64, 64), (1, 128, 128)])
def test_flash_fwd_matches_jax_kernel(causal, hq, hkv, b, s, d):
    q, k, v = _arrays(s + d + hkv, (b, s, hq, d), (b, s, hkv, d),
                      (b, s, hkv, d))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               interpret=True)
    _, want_lse = jfa._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale=d ** -0.5,
                           causal=causal, block_q=512, block_k=512,
                           interpret=True)
    before = dict(tfa.launch_counts)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    assert tfa.launch_counts == before            # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
        out.numpy(), rtol=0, atol=0)


# K3 adds group 4 (hq 8 / hkv 2), d 256, and 40 cache rows: a split
# that is no multiple of the Hopper kernel's kv tile (the reference
# takes it: its kv block is then the whole 104 rows).
@pytest.mark.parametrize('hq,hkv', GEOS + [(8, 2)])
@pytest.mark.parametrize('s,split,d', [(64, 64, 64), (128, 64, 128),
                                       (64, 64, 256), (64, 40, 64)])
@pytest.mark.parametrize('which', ['empty_and_mid', 'mid_and_full'])
def test_flash_chunk_matches_jax_kernel(hq, hkv, s, split, d, which):
    b = 2
    q, k, v = _arrays(s + split + hkv, (b, s, hq, d),
                      (b, split + s, hkv, d), (b, split + s, hkv, d))
    mid = split // 2 + 3
    cl = np.array([0, mid] if which == 'empty_and_mid' else [mid, split],
                  np.int32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               cache_len=jnp.asarray(cl), kv_split=split,
                               interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), cache_len=_t(cl),
                              kv_split=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # The two-operand entry the engine uses computes the same.
    two = tfa.flash_chunk_attention(_t(q), _t(k[:, split:]),
                                    _t(v[:, split:]), _t(k[:, :split]),
                                    _t(v[:, :split]), _t(cl))
    np.testing.assert_allclose(two.numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize('kw,kv_rows', [
    (dict(), 64),                                  # hkv does not divide hq
    (dict(cache_len=np.array([1], np.int32)), 128),   # without kv_split
    (dict(kv_split=64), 128),                      # without cache_len
    (dict(cache_len=np.array([1], np.int32), kv_split=64, causal=False),
     128),                                         # chunk mode, not causal
    (dict(cache_len=np.array([1], np.int32), kv_split=32), 128),  # skv
    (dict(causal=True), 128),                      # causal needs sq == skv
])
def test_flash_validation_errors_match_reference(kw, kv_rows):
    hkv = 3 if not kw else 2
    q = np.zeros((1, 64, 4, 64), np.float32)
    kv = np.zeros((1, kv_rows, hkv, 64), np.float32)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                            interpret=True,
                            **{k: (jnp.asarray(x) if isinstance(x, np.ndarray)
                                   else x) for k, x in kw.items()})
    with pytest.raises(ValueError) as terr:
        tfa.flash_attention(_t(q), _t(kv), _t(kv),
                            **{k: (_t(x) if isinstance(x, np.ndarray) else x)
                               for k, x in kw.items()})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('with_offset', [False, True])
def test_reference_attention_offsets_match_jax(with_offset):
    q, k, v = _arrays(3, (2, 4, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    off = np.array([3, 8], np.int32) if with_offset else None
    kv_len = np.array([7, 12], np.int32) if with_offset else None
    want = jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=None if off is None else jnp.asarray(off),
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    got = tattn.reference_attention(
        _t(q), _t(k), _t(v), causal=True,
        q_offset=None if off is None else _t(off),
        kv_len=None if kv_len is None else _t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_cpu_dispatch_resolves_to_the_plain_paths():
    """On the CPU ``auto`` takes the plain paths (as the reference does
    off the TPU) and launches nothing; ``flash`` runs the kernel's plain
    version; the sequence-parallel impls outside a training mesh with sp
    > 1 take the plain path, as the reference's do without an sp mesh
    (on a mesh: ``tests/test_torch_seq_parallel.py``)."""
    q, k, v, ck, cv = _arrays(5, (2, 64, 4, 64), (2, 64, 2, 64),
                              (2, 64, 2, 64), (2, 32, 2, 64), (2, 32, 2, 64))
    q, k, v, ck, cv = map(_t, (q, k, v, ck, cv))
    cl = torch.tensor([0, 20], dtype=torch.int32)
    before = dict(tfa.launch_counts)
    assert torch.equal(tattn.attention(q, k, v),
                       tattn.reference_attention(q, k, v))
    assert torch.equal(tattn.attention(q, k, v, impl='flash'),
                       tfa.flash_attention_reference(q, k, v)[0])
    assert torch.equal(tattn.chunk_attention(q, k, v, ck, cv, cl),
                       tattn.cached_attention(q, k, v, ck, cv, cl))
    flash = tattn.chunk_attention(q, k, v, ck, cv, cl, impl='flash')
    np.testing.assert_allclose(
        flash.numpy(), tattn.cached_attention(q, k, v, ck, cv, cl).numpy(),
        rtol=0, atol=ATOL)
    assert tfa.launch_counts == before
    for impl in ('ring', 'ulysses'):
        assert torch.equal(tattn.attention(q, k, v, impl=impl),
                           tattn.reference_attention(q, k, v))
    with pytest.raises(ValueError, match='unknown attention impl'):
        tattn.attention(q, k, v, impl='nope')
