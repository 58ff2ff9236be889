"""The parameter bridge maps JAX trees onto the port's exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.models.model import LM
from _threads import one_thread  # noqa: F401


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["floe-slm-2b", "floe-llm-7b",
                                  "falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_exact(name, dtype):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    jparams = jax.device_get(JLM(cfg, remat=False).init(jax.random.key(3)))
    tparams = bridge.from_numpy(jparams)
    back = bridge.to_numpy(tparams)
    # the port's spec tree has exactly the reference's leaves and shapes
    spec = LM(cfg, device="cpu").param_shapes()
    ref = list(_leaves(jparams))
    assert [p for p, _ in _leaves(spec)] == [p for p, _ in ref]
    for (path, a), (_, s) in zip(ref, _leaves(spec)):
        assert tuple(a.shape) == s[0], path
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for (path, a), (_, t), (_, b) in zip(ref, _leaves(tparams),
                                         _leaves(back)):
        assert t.dtype == want, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b,
                                      err_msg=str(path))


def test_alignment_round_trip_is_exact():
    mlp = jax.device_get(JFUS.init_alignment(jax.random.key(2), 64))
    back = bridge.to_numpy(bridge.from_numpy(mlp))
    assert sorted(back) == sorted(mlp)
    for k in mlp:
        np.testing.assert_array_equal(np.asarray(mlp[k]), back[k])
        assert back[k].dtype == np.float32


def test_port_init_follows_the_reference_laws():
    """Seeded on-device init: same shapes, dtypes and scale laws (fan-in
    over every axis but the last; embed std d**-0.5) as the reference."""
    cfg = get_config("floe-slm-2b").reduced()
    p1 = LM(cfg, device="cpu").init(5)
    p2 = LM(cfg, device="cpu").init(5)
    for (path, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))
    emb = p1["embed"]["tok"]["w"]
    assert abs(emb.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    w = p1["layers"]["mlp"]["in"]["w"]
    fan_in = cfg.num_layers * cfg.d_model
    assert abs(w.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert torch.equal(p1["ln_f"]["scale"], torch.ones(cfg.d_model))
