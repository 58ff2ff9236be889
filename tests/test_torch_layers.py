"""Port layers vs ``repro.models.layers`` on the reduced pair geometry.

Inputs come from a numpy seed and go through both packages in float32.
Tolerance 1e-5: the same float32 arithmetic, summed in another order
(and XLA's vs PyTorch's pow/sin/cos/tanh, within a few ulps)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("name", ["floe-slm-2b", "floe-llm-7b"])
def test_rmsnorm(rng, name):
    cfg = get_config(name).reduced()
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    s = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = L.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_linear(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    want = JL.linear({"w": jnp.asarray(w)}, jnp.asarray(x))
    got = L.linear({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("pos", ["prefill", 37])
def test_rope(rng, pos):
    x = rng.standard_normal((2, 9 if pos == "prefill" else 1, 4, 32)
                            ).astype(np.float32)
    if pos == "prefill":
        jp, tp = jnp.arange(9), torch.arange(9)
    else:
        jp, tp = jnp.asarray(pos), torch.tensor(pos)
    want = JL.rope(jnp.asarray(x), jp, 10_000.0)
    got = L.rope(torch.from_numpy(x), tp, 10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("mlp_type", ["geglu", "swiglu", "gelu"])
def test_mlp(rng, mlp_type):
    cfg = dataclasses.replace(get_config("floe-slm-2b").reduced(),
                              mlp_type=mlp_type)
    gate = 1 if mlp_type == "gelu" else 2
    p = {"in": {"w": rng.standard_normal(
             (cfg.d_model, gate * cfg.d_ff)).astype(np.float32) * 0.1},
         "out": {"w": rng.standard_normal(
             (cfg.d_ff, cfg.d_model)).astype(np.float32) * 0.1}}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    want = JL.mlp(cfg, jp, jnp.asarray(x))
    got = L.mlp(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("name", ["floe-slm-2b", "floe-llm-7b"])
def test_embed_unembed(rng, name):
    cfg = get_config(name).reduced()
    w = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6))
    jp, tp = {"tok": {"w": jnp.asarray(w)}}, {"tok": {"w": torch.from_numpy(w)}}
    x_j = JL.embed(cfg, jp, jnp.asarray(toks))
    x_t = L.embed(cfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(x_t.numpy(), _np(x_j), **TOL)
    h = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want = JL.unembed(cfg, jp, jnp.asarray(h))
    got = L.unembed(cfg, tp, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["floe-slm-2b", "floe-llm-7b"])
def test_embed_scale_rounds_in_bf16(rng, name):
    """At full width in bf16, sqrt(d_model) is rounded to bf16 before the
    multiply (sqrt(3072) = 55.43 -> 55.5): bit-equal to the reference."""
    cfg = get_config(name)
    w = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(w).bfloat16()
    toks = np.array([[0, 3, 15, 7]])
    want = JL.embed(cfg, {"tok": {"w": jw}}, jnp.asarray(toks))
    got = L.embed(cfg, {"tok": {"w": tw}}, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
