"""K1 and the Eq. 14-15 fusion step of the port vs the JAX package.

CPU cases run in float32 against the Pallas kernel in interpret mode and
the jnp fusion paths; tolerance 1e-6 absolute on probabilities <= 1
(f32 softmax in another reduction order) and 1e-5 on the Eq. 14 weight
(a 2V-long f32 dot product).  The CUDA kernel's split-V order of sums
(``fuse_logits_splitv_model``) is held to the same 1e-6 against the
Pallas kernel and the reference's ``fused_probs_masked``, f32 and bf16
logits.  The CUDA kernel is held against its plain version on the card
by ``tests/test_torch_gpu.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as JFUS
from repro.kernels.logit_fusion import ops as JOPS
from repro.kernels.logit_fusion.kernel import fuse_logits as jfuse
from repro_torch import bridge
from repro_torch.core import fusion as FUS
from repro_torch.kernels.logit_fusion import kernel as K1
from repro_torch.kernels.logit_fusion import ops as OPS

P_TOL = dict(rtol=0, atol=1e-6)


def _case(seed, b, v):
    rng = np.random.default_rng(seed)
    sl = (3 * rng.standard_normal((b, v))).astype(np.float32)
    ll = (3 * rng.standard_normal((b, v))).astype(np.float32)
    w = rng.uniform(size=b).astype(np.float32)
    arrived = np.array([True, False, True, True, False][:b])
    return sl, ll, w, arrived


@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_kernel_matches_pallas(with_mask):
    sl, ll, w, arrived = _case(0, 4, 1024)
    a = arrived if with_mask else None
    want = jfuse(jnp.asarray(sl), jnp.asarray(ll), jnp.asarray(w),
                 arrived=None if a is None else jnp.asarray(a),
                 interpret=True)
    got = K1.fuse_logits(torch.from_numpy(sl), torch.from_numpy(ll),
                         torch.from_numpy(w),
                         None if a is None else torch.from_numpy(a))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


@pytest.mark.parametrize("b", [1, 3, 5])
def test_fused_probs_masked_ragged(b):
    sl, ll, w, arrived = _case(b, b, 777)
    want = JOPS.fused_probs_masked(jnp.asarray(sl), jnp.asarray(ll),
                                   jnp.asarray(w), jnp.asarray(arrived),
                                   block_b=4)
    got = OPS.fused_probs_masked(torch.from_numpy(sl), torch.from_numpy(ll),
                                 torch.from_numpy(w),
                                 torch.from_numpy(arrived), block_b=4)
    assert got.shape == (b, 777)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


@pytest.mark.parametrize("b", [1, 3])
def test_fused_distribution_kernel(b):
    vocab = 512
    mlp = jax.device_get(JFUS.init_alignment(jax.random.key(2), vocab))
    sl, ll, _, arrived = _case(10 + b, b, vocab)
    p_j, w_j = JFUS.fused_distribution_kernel(
        mlp, jnp.asarray(sl), jnp.asarray(ll), jnp.asarray(arrived))
    tmlp = bridge.from_numpy(mlp)
    p_t, w_t = FUS.fused_distribution_kernel(
        tmlp, torch.from_numpy(sl), torch.from_numpy(ll),
        torch.from_numpy(arrived))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **P_TOL)
    # the plain Eq. 14-15 step agrees with the kernel-routed one
    p_p, w_p = FUS.fused_distribution(tmlp, torch.from_numpy(sl),
                                      torch.from_numpy(ll),
                                      torch.from_numpy(arrived))
    np.testing.assert_allclose(p_p.numpy(), p_t.numpy(), **P_TOL)
    np.testing.assert_array_equal(w_p.numpy(), w_t.numpy())



@functools.cache
def _splitv_refs(v, dtype):
    """Four rows (two with arrived False) of 3·N(0, 1) logits at width v
    in ``dtype``, with the Pallas kernel's output (interpret mode) and
    the reference's ``fused_probs_masked``, as numpy."""
    sl, ll, w, _ = _case(v, 4, v)
    arrived = np.array([True, False, True, False])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jsl, jll = jnp.asarray(sl).astype(jdt), jnp.asarray(ll).astype(jdt)
    pallas = jfuse(jsl, jll, jnp.asarray(w), arrived=jnp.asarray(arrived),
                   interpret=True)
    ref = JOPS.fused_probs_masked(jsl, jll, jnp.asarray(w),
                                  jnp.asarray(arrived), block_b=4)
    return (np.array(jsl.astype(jnp.float32)),
            np.array(jll.astype(jnp.float32)), w, arrived,
            np.array(pallas), np.array(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [256_000, 1_001])
@pytest.mark.parametrize("chunks", [1, 3, 33, 264])
def test_splitv_model_matches_pallas_and_ref(chunks, v, dtype):
    """The CUDA kernel's split-V order of sums (per-chunk max and sum,
    then the ascending merge) against the Pallas kernel and the
    reference's serving entry point."""
    sl, ll, w, arrived, pallas, ref = _splitv_refs(v, dtype)
    tdt = getattr(torch, dtype)
    got = K1.fuse_logits_splitv_model(
        torch.from_numpy(sl).to(tdt), torch.from_numpy(ll).to(tdt),
        torch.from_numpy(w), torch.from_numpy(arrived), chunks)
    assert got.dtype == torch.float32 and got.shape == (4, v)
    np.testing.assert_allclose(got.numpy(), pallas, **P_TOL)
    np.testing.assert_allclose(got.numpy(), ref, **P_TOL)


@pytest.mark.parametrize("b", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("v", [256_000, 1_001, 1, 9_000_000])
@pytest.mark.parametrize("sms", [132, 114])
def test_splitv_layout_covers_the_row(b, v, sms):
    """Chunks of a multiple of 8 values, at most MAX_CHUNK, that cover V
    with none empty, and two waves of CTAs whenever V allows them (on an
    H100 SXM's 132 SMs and a PCIe card's 114)."""
    chunks, chunk = K1.splitv_layout(b, v, sms)
    assert chunk % 8 == 0 and 0 < chunk <= K1.MAX_CHUNK
    assert (chunks - 1) * chunk < v <= chunks * chunk
    if v >= 2 * sms * K1.CHUNK_ALIGN:
        assert b * chunks >= 2 * sms
