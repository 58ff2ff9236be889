"""The port's dense LM vs ``repro.models.model.LM`` on the reduced pair.

Both run in float32 on the CPU from the same (bridged) parameters: a
prefill, then 16 greedy decode steps, each model following its own
argmax.  Tolerance 1e-4 on logits: a 2-layer model accumulates the
1e-6-level reordering differences of its f32 matmuls and softmaxes;
the greedy tokens must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.models.model import LM

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 48


@pytest.mark.parametrize("name,key", [("floe-slm-2b", 0), ("floe-llm-7b", 1)])
def test_prefill_and_16_greedy_decode_steps(name, key):
    cfg = get_config(name).reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(key))
    lm = LM(cfg, device="cpu")
    params = bridge.from_numpy(jax.device_get(jparams))

    prompt = np.random.default_rng(key).integers(3, 259, (1, 23))
    jlogits, jcache = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, MAX_SEQ))(jparams, jnp.asarray(prompt, jnp.int32))
    logits, cache = lm.prefill(params, torch.from_numpy(prompt), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)
    assert cache["pos"] == int(jcache["pos"]) == 23

    jstep = jax.jit(jlm.decode_step)
    jtoks, ttoks = [], []
    for _ in range(16):
        jt = int(jnp.argmax(jlogits[0, -1]))
        tt = int(torch.argmax(logits[0, -1]))
        jtoks.append(jt)
        ttoks.append(tt)
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray([[jt]], jnp.int32))
        logits, cache = lm.decode_step(params, cache,
                                       torch.tensor([[tt]]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    assert ttoks == jtoks
    assert cache["pos"] == int(jcache["pos"]) == 23 + 16
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-4)
