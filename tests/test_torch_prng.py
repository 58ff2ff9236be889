"""The port's numpy threefry vs ``jax.random`` and the latency model.

Keys, raw bits, uniforms, normals, arrivals and latencies must all be
bit-equal: the port's ``erf_inv`` computes XLA's CPU polynomial with
XLA's own ``log1p`` and ``log`` and the same fused multiply-adds, so no
regime decision of ``token_latency_device`` can differ.  Arrivals and
latencies are compared with the reference's draws under ``jax.jit``,
as every reference engine makes them (``deployment.lat_batched``,
``lat_request``, ``LatencyModel.arrival_ms_at``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving.latency import LatencyModel as JLat
from repro_torch.core import prng
from repro_torch.serving.latency import LatencyModel

SEEDS = [0, 1, 7, 2 ** 31 - 1]
RIDS = np.repeat(np.arange(-3, 61), 48).astype(np.int32)
STEPS = np.tile(np.arange(48), 64).astype(np.int32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@jax.jit
def _jax_draws(seed_key, rids, steps):
    def one(r, s):
        k = jax.random.fold_in(jax.random.fold_in(seed_key, r), s)
        lo = np.nextafter(np.float32(-1), np.float32(0))
        return (jax.random.key_data(k), jax.random.bits(k, (), jnp.uint32),
                jax.random.uniform(k, (), jnp.float32, lo, 1.0),
                jax.random.normal(k))
    return jax.vmap(one)(rids, steps)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_keys_uniforms_exact(seed):
    kd, bits, uni, nrm = jax.device_get(_jax_draws(
        jax.random.key(seed), jnp.asarray(RIDS), jnp.asarray(STEPS)))
    k = prng.fold_in(prng.fold_in(prng.key(seed), RIDS), STEPS)
    np.testing.assert_array_equal(k[0], kd[:, 0])
    np.testing.assert_array_equal(k[1], kd[:, 1])
    np.testing.assert_array_equal(prng.bits32(k), bits)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(prng.uniform(k, lo, 1.0), uni)
    np.testing.assert_array_equal(_bits(prng.normal(k)), _bits(nrm))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("rtt,jitter", [(50.0, 5.0), (130.0, 30.0),
                                        (178.0, 5.0), (300.0, 60.0)])
def test_arrivals_and_regimes(seed, rtt, jitter):
    jl = JLat(rtt_ms=rtt, jitter_ms=jitter, seed=seed)
    tl = LatencyModel(rtt_ms=rtt, jitter_ms=jitter, seed=seed)
    ja = np.asarray(jax.jit(jl.arrival_device)(jnp.asarray(RIDS),
                                               jnp.asarray(STEPS)))
    ta = tl.arrival_device(RIDS, STEPS)
    assert ta.dtype == np.float32
    np.testing.assert_array_equal(_bits(ta), _bits(ja))
    for timeout in (200.0, 100.1):
        jlat, jok = jax.jit(lambda r, s: jl.token_latency_device(
            timeout, r, s))(jnp.asarray(RIDS), jnp.asarray(STEPS))
        tlat, tok = tl.token_latency_device(timeout, RIDS, STEPS)
        np.testing.assert_array_equal(tok, np.asarray(jok))
        np.testing.assert_array_equal(_bits(tlat), _bits(jlat))
        # the three regimes (masked, bounded wait, fallback) agree
        edge = np.float32(jl.edge_compute_ms)
        np.testing.assert_array_equal(ta <= edge, ja <= edge)


def test_host_shim_matches_batched_draw():
    tl = LatencyModel()
    lat, ok = tl.token_latency_device(200.0, RIDS[:64], STEPS[:64])
    for i in range(64):
        ms, used = tl.token_latency_ms(200.0, rid=int(RIDS[i]),
                                       step=int(STEPS[i]))
        assert ms == float(lat[i]) and used == bool(ok[i])


def test_stateful_stream_matches_reference():
    """The rid-less legacy stream is Python's ``random`` in both."""
    jl, tl = JLat(seed=4), LatencyModel(seed=4)
    for _ in range(20):
        assert jl.token_latency_ms(200.0) == tl.token_latency_ms(200.0)
