"""K3 and the attention math of the port vs the JAX package.

CPU cases run in float32 against the Pallas kernel in interpret mode,
its jnp oracle and the jnp attention paths; tolerance 1e-5 (the same
f32 softmax, reduced in another order).  The CUDA kernel is held against
its plain version on the card by ``tests/test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as JATT
from repro_torch.kernels.flash_attention import kernel as K3
from repro_torch.models import attention as ATT

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, b, h, kvh, s, d, layout="bhsd"):
    shp = ((b, h, s, d), (b, kvh, s, d)) if layout == "bhsd" else \
        ((b, s, h, d), (b, s, kvh, d))
    return (rng.standard_normal(shp[0]).astype(np.float32),
            rng.standard_normal(shp[1]).astype(np.float32),
            rng.standard_normal(shp[1]).astype(np.float32))


@pytest.mark.parametrize("s,group,causal,window", [
    (31, 1, True, 0), (45, 2, True, 0), (45, 1, True, 8), (31, 2, True, 8),
    (45, 2, False, 0)])
def test_plain_flash_matches_pallas_and_ref(s, group, causal, window):
    rng = np.random.default_rng(s * 10 + group)
    q, k, v = _qkv(rng, 2, 2 * group, 2, s, 32)
    got = K3.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_causal_attention_multi_chunk(window):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 4, 2, 40, 16, layout="bshd")
    pos = np.arange(40)
    want = JATT.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), window, chunk=16)
    got = ATT.chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(pos), window, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # K3's plain version computes the same attention (layout B, H, S, D)
    k3 = K3.flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                              for a in (q, k, v)), window=window)
    np.testing.assert_allclose(k3.transpose(1, 2).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("pos,window", [(0, 0), (23, 0), (20, 8)])
def test_decode_attention(pos, window):
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    ck = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = JATT.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.asarray(pos), window)
    got = ATT.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), pos, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)



@pytest.mark.parametrize("s,group,window", [(45, 2, 0), (31, 1, 8)])
def test_flash_on_strided_views_matches_contiguous_and_pallas(s, group,
                                                              window):
    """K3 on (B, H, S, D) views of (B, S, H, D) tensors, as the model
    hands them over, gives what it gives on contiguous copies, and
    agrees with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, 2, 2 * group, 2, s, 32, layout="bshd")
    views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = K3.flash_attention(*views, window=window)
    assert got.shape == views[0].shape
    assert got.transpose(1, 2).is_contiguous()
    dense = K3.flash_attention(*(a.contiguous() for a in views),
                               window=window)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    jq, jk, jv = (jnp.asarray(np.swapaxes(a, 1, 2)) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=True, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_flash_layout_checks_raise():
    base = torch.randn(1, 2, 16, 64)
    ok = base[..., :32]                       # strided S, unit D: accepted
    K3.flash_attention(ok, ok, ok)
    gappy = base[..., ::2]                    # head_dim stride 2
    with pytest.raises(ValueError, match="unit stride"):
        K3.flash_attention(gappy, ok, ok)
    with pytest.raises(ValueError, match="unit stride"):
        K3.flash_attention(ok, ok, gappy)
    odd = torch.randn(1, 2, 16, 33)[..., :32]  # rows of 132 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        K3.flash_attention(ok, odd, odd)
    with pytest.raises(ValueError, match="mismatched"):
        K3.flash_attention(ok, ok[:, :, :8], ok[:, :, :8])
