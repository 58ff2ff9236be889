"""The port's grouped (gemma3) layout vs ``repro.models.model.LM`` on the
reduced floe-slm-gemma3, float32 on the CPU, from the same (bridged)
parameters.

Two depths: ``.reduced()`` (one group of a local and a global layer,
no tail) and ``num_layers=5`` (two groups and a tail of one local
layer), at window 16, with and without ring caches.  Tolerances are
``tests/test_torch_model.py``'s: 1e-4 on logits (f32 matmuls and
softmaxes reduced in another order), 1e-5 on prefill cache leaves,
1e-4 after decode; greedy tokens equal.

* ``_qk_norm`` and the per-layer rope theta and window of
  ``attention_block`` (local layers at theta 10,000 over a window,
  global ones at 1,000,000) against the reference's;
* ``LM.prefill`` logits and every cache leaf at prompts shorter and
  longer than the window (the ring roll), then 24 decode steps past the
  window on the dense cache (ring writes at pos % window), greedy and
  forced;
* ``prefill_packed`` at ragged lengths on both sides of the window:
  each row's last-token logits, its global K/V and its ring slots as
  the reference's ``_pad_cache(lengths=)`` places them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.models import attention as ATT
from repro_torch.models.model import LM, cache_kv
from _threads import one_thread  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 48
KINDS = ("inner", "tail", "global")


def _cfg(layers):
    cfg = get_config("floe-slm-gemma3").reduced()
    return cfg if layers == 2 else dataclasses.replace(cfg,
                                                       num_layers=layers)


@pytest.fixture(scope="module", params=[2, 5], ids=["1group", "2groups+tail"])
def model(request):
    cfg = _cfg(request.param)
    jparams = jax.jit(JLM(cfg, remat=False).init)(jax.random.key(0))
    return cfg, jparams, bridge.from_numpy(jax.device_get(jparams))


def _shapes(tree):
    """{path: shape} of a spec tree: the reference's ``P`` leaves or the
    port's (shape, init, scale) tuples."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    return {"": tuple(tree.shape if hasattr(tree, "shape") else tree[0])}


def test_layout_matches_reference():
    """Parameter tree, LoRA layout and cache shapes of both reduced
    depths and of the full width equal the reference's, and the layers
    run in its group order."""
    full = dataclasses.replace(get_config("floe-slm-gemma3"),
                               dtype="float32")
    for cfg, want in ((_cfg(2), ("grouped", 1, 2, 0)),
                      (_cfg(5), ("grouped", 2, 2, 1)),
                      (full, ("grouped", 4, 6, 2))):
        for ring in (True, False):
            jlm, lm = JLM(cfg, ring_cache=ring), LM(cfg, device="cpu",
                                                    ring_cache=ring)
            assert lm._layout() == jlm._layout() == want
            assert _shapes(jlm.param_specs()) == _shapes(lm.param_shapes())
            assert lm.lora_layout() == jlm.lora_layout()
            jc = jax.eval_shape(lambda: jlm.init_cache(3, 2048))
            assert {k: {n: tuple(jc[k][n].shape) for n in "kv"}
                    for k in KINDS} == lm.kv_shapes(3, 2048)
            assert lm._ring_local_len(2048) == jlm._ring_local_len(2048) \
                == (cfg.sliding_window if ring else 0)
    order = [s.addr for s in LM(_cfg(5), device="cpu").layer_sites()]
    assert order == [("inner", (0, 0)), ("global", (0,)), ("inner", (1, 0)),
                     ("global", (1,)), ("tail", (0,))]


def test_qk_norm_and_per_layer_theta():
    """``_qk_norm`` (x * scale, f32, norm_eps) and a local and a global
    ``attention_block`` prefill (theta 10,000 and window 16, theta
    1,000,000 and causal) against the reference's, at 40 positions."""
    cfg = _cfg(2)
    assert (cfg.rope_theta, cfg.rope_theta_global) == (1e4, 1e6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    scale = {"scale": rng.standard_normal(32).astype(np.float32)}
    np.testing.assert_allclose(
        ATT._qk_norm(bridge.from_numpy(scale), torch.from_numpy(x),
                     cfg.norm_eps).numpy(),
        np.asarray(JATT._qk_norm(jax.tree.map(jnp.asarray, scale),
                                 jnp.asarray(x), cfg.norm_eps)),
        **CACHE_TOL)
    jparams = jax.jit(JLM(cfg, remat=False).init)(jax.random.key(4))
    p = bridge.from_numpy(jax.device_get(jparams))
    h = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40)
    for stack, idx, is_global in (("inner", (0, 0), False),
                                  ("global_layers", (0,), True)):
        jp = jax.tree.map(lambda t: t[idx], jparams[stack])
        tp = bridge.from_numpy(jax.device_get(jp))
        jy, jkv = jax.jit(lambda p, x, g=is_global: JATT.attention_block(
            cfg, p, x, positions=jnp.asarray(pos), is_global=g,
            mode="prefill"))(jp["attn"], jnp.asarray(h))
        y, (k, v) = ATT.attention_block(cfg, tp["attn"], torch.from_numpy(h),
                                        positions=torch.from_numpy(pos),
                                        is_global=is_global)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
        np.testing.assert_allclose(k.numpy(), np.asarray(jkv["k"]),
                                   **CACHE_TOL)
        assert ATT.layer_window(cfg, is_global) == (0 if is_global else 16)


def _leaves_equal(cache, jcache, tol):
    for kind in KINDS:
        for n in "kv":
            np.testing.assert_allclose(cache[kind][n].numpy(),
                                       np.asarray(jcache[kind][n]), **tol)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "full"])
@pytest.mark.parametrize("s_len", [9, 23])
def test_prefill_and_24_decode_steps(model, ring, s_len):
    """Prefill at a prompt shorter (9) or longer (23) than the window of
    16, every cache leaf equal (ring leaves rolled, position p in slot
    p % 16); then 24 decode steps, 12 greedy (tokens equal) and 12 on
    forced random ids (a random-init model repeats its argmax), which
    wrap every ring at least once."""
    cfg, jparams, params = model
    jlm, lm = JLM(cfg, remat=False, ring_cache=ring), \
        LM(cfg, device="cpu", ring_cache=ring)
    rng = np.random.default_rng(s_len)
    prompt = rng.integers(3, 259, (1, s_len))
    jlogits, jcache = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, MAX_SEQ))(jparams, jnp.asarray(prompt, jnp.int32))
    logits, cache = lm.prefill(params, torch.from_numpy(prompt), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _leaves_equal(cache, jcache, CACHE_TOL)
    assert cache["inner"]["k"].shape[-3] == (16 if ring else MAX_SEQ)
    forced = rng.integers(3, 259, 12).tolist()
    jstep = jax.jit(jlm.decode_step)
    for t in range(24):
        jt = int(jnp.argmax(jlogits[0, -1]))
        tt = int(torch.argmax(logits[0, -1]))
        if t < 12:
            assert tt == jt
        else:
            jt = tt = forced[t - 12]
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray([[jt]], jnp.int32))
        logits, cache = lm.decode_step(params, cache, torch.tensor([[tt]]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    assert cache["pos"] == int(jcache["pos"]) == s_len + 24
    _leaves_equal(cache, jcache, LOGIT_TOL)


@pytest.mark.parametrize("lengths", [[3, 20, 17], [5, 30, 11, 16]])
def test_prefill_packed_ragged(model, lengths):
    """Packed ragged prefill (Lpad 32 > window): per-row last-valid-token
    logits; each row's global K/V at [0, len) and its ring slots,
    gathered from the streamed K/V as ``ring_kv_positions(len - 1, 16)``
    places them, against the reference's ``_pad_cache(lengths=)``."""
    cfg, jparams, params = model
    jlm, lm = JLM(cfg, remat=False, ring_cache=True), \
        LM(cfg, device="cpu", ring_cache=True)
    b, w = len(lengths), cfg.sliding_window
    toks = np.zeros((b, 32), np.int64)
    rng = np.random.default_rng(sum(lengths))
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(3, 259, n)
    jlogits, jcache = jax.jit(lambda p, t, n: jlm.prefill_packed(
        p, {"tokens": t}, n, MAX_SEQ))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
    kv = {}

    def write(addr, k, v):
        kv[addr] = (k.numpy().copy(), v.numpy().copy())
    logits = lm.prefill_packed(params, torch.from_numpy(toks), lengths,
                               MAX_SEQ, write)
    assert list(kv) == [s.addr for s in lm.layer_sites()]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(np.asarray(jcache["pos"]), lengths)
    for (kind, idx), (k, v) in kv.items():
        for n, t in (("k", k), ("v", v)):
            ref = np.asarray(jcache[kind][n])[idx]
            for i, m in enumerate(lengths):
                if kind == "global":
                    np.testing.assert_allclose(t[i, :m], ref[i, :m],
                                               **CACHE_TOL)
                    continue
                p = np.asarray(JATT.ring_kv_positions(m - 1, w))
                np.testing.assert_allclose(t[i, p[p >= 0]],
                                           ref[i, p >= 0], **CACHE_TOL)
                np.testing.assert_array_equal(
                    ATT.ring_kv_positions(torch.tensor([m - 1]), w)[0], p)


def test_cache_kv_addresses_views(model):
    """``cache_kv`` returns views: a write through one lands in the
    cache tree."""
    cfg = model[0]
    lm = LM(cfg, device="cpu", ring_cache=True)
    cache = lm.init_cache(2, MAX_SEQ)
    for site in lm.layer_sites():
        cache_kv(cache, site.addr, "v").fill_(1.0)
    assert all(bool((cache[k]["v"] == 1).all()) for k in KINDS)
