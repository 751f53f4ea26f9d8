"""The port's flash-attention backward (K5a dK/dV, K5b dQ) and its
autograd plumbing held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The
JAX side is ``jax.grad`` through ``flash_attention(..., interpret=True)``
with ``block_q = block_k = 64`` at sq 128, so its custom VJP runs the
Pallas backward kernels in interpret mode over more than one tile; the
port's side is its plain backward (``flash_attention_bwd_reference``, and
the K5a/K5b wrappers, which take it for CPU tensors). Everything is
fp32: 1e-4 absolute on dq, dk and dv (the two sides sum over the same
terms in different orders and groupings; the reference also sums the
GQA group's per-head dk/dv after its kernels, the port inside).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jfa
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.ops import flash_attention as tfa

jax.config.update('jax_platforms', 'cpu')

ATOL_JAX = 1e-4
ATOL_AUTOGRAD = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.array(x))


GEOS = [(2, 2), (4, 2)]          # (hq, hkv): MHA and GQA


@pytest.mark.parametrize('causal', [True, False])
# GEOS at d 64 (ids as before), then group 4 (hq 8 / hkv 2) and d 256,
# where the Hopper dQ and dK/dV kernels change their tiling.
@pytest.mark.parametrize('hq,hkv,d', [
    pytest.param(hq, hkv, 64, id=f'{hq}-{hkv}') for hq, hkv in GEOS] + [
    pytest.param(8, 2, 64, id='8-2'),
    pytest.param(2, 2, 256, id='2-2-d256'),
    pytest.param(8, 2, 256, id='8-2-d256')])
@pytest.mark.parametrize('b', [1, 2])
def test_plain_backward_matches_jax_grad(causal, hq, hkv, d, b):
    s = 128
    q, k, v, do = _arrays(b * 10 + hq + causal, (b, s, hq, d), (b, s, hkv, d),
                          (b, s, hkv, d), (b, s, hq, d))

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, block_q=64,
                                   block_k=64, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    before = dict(tfa.launch_counts)
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                            causal=causal)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_JAX, err_msg=name)
    # The K5 wrappers take the same plain version for CPU tensors.
    delta = tfa.attention_delta(out, tdo)
    dk, dv = tfa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                         causal=causal)
    dq = tfa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta,
                                    causal=causal)
    for g, w in zip((dq, dk, dv), got):
        assert torch.equal(g, w)
    assert tfa.launch_counts == before            # CPU: no kernel launch


@pytest.mark.parametrize('causal,sq,skv', [(True, 37, 37), (False, 20, 45)])
@pytest.mark.parametrize('hq,hkv,d', [(4, 4, 16), (4, 2, 64), (8, 1, 32)])
def test_flash_autograd_matches_reference_attention(causal, sq, skv, hq, hkv,
                                                    d):
    """attention(impl='flash') carries gradients through the
    ``torch.autograd.Function`` (no detached output): its backward
    matches autograd through the plain ``reference_attention``."""
    q, k, v, do = _arrays(sq + d + hq, (2, sq, hq, d), (2, skv, hkv, d),
                          (2, skv, hkv, d), (2, sq, hq, d))
    grads = {}
    for impl in ('flash', 'xla'):
        tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
        out = tattn.attention(tq, tk, tv, causal=causal, impl=impl)
        assert out.grad_fn is not None
        grads[impl] = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for g, w in zip(grads['flash'], grads['xla']):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=ATOL_AUTOGRAD)


def test_flash_function_saves_forward_and_runs_plain_backward_on_cpu():
    q, k, v = (_t(x).requires_grad_(True) for x in _arrays(
        3, (1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
    want, _ = tfa.flash_attention_reference(q.detach(), k.detach(),
                                            v.detach(), causal=True)
    assert torch.equal(out.detach(), want)
    before = dict(tfa.launch_counts)
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert tfa.launch_counts == before


def test_chunk_path_is_forward_only():
    """The K3 chunk path keeps the reference's contract (no VJP): it
    raises when an input requires grad, through both entry points."""
    q, k, v = (_t(x) for x in _arrays(5, (2, 16, 4, 64), (2, 48, 2, 64),
                                      (2, 48, 2, 64)))
    cl = torch.tensor([0, 20], dtype=torch.int32)
    out = tfa.flash_attention(q, k, v, cache_len=cl, kv_split=32)
    assert out.shape == q.shape and out.grad_fn is None
    with pytest.raises(ValueError, match='forward-only'):
        tfa.flash_attention(q.requires_grad_(True), k, v, cache_len=cl,
                            kv_split=32)
    with pytest.raises(ValueError, match='forward-only'):
        tfa.flash_chunk_attention(q.detach(), k[:, 32:], v[:, 32:],
                                  k[:, :32].requires_grad_(True), v[:, :32],
                                  cl)
