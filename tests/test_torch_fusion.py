"""K1 and the Eq. 14-15 fusion step of the port vs the JAX package.

CPU cases run in float32 against the Pallas kernel in interpret mode and
the jnp fusion paths; tolerance 1e-6 absolute on probabilities <= 1
(f32 softmax in another reduction order) and 1e-5 on the Eq. 14 weight
(a 2V-long f32 dot product).  The CUDA kernel is held against its plain
version on the card by ``tests/test_torch_gpu.py``."""
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

