"""The port's Mamba-1 path vs the JAX package's, on the reduced
falcon-mamba (2 layers, d 256, d_inner 512, N 8, dt_rank 16, vocab 512),
float32 on the CPU, from the same inputs (numpy seeds) and the same
(bridged) parameters.

* K6's plain version against ``ssm_scan_ref`` and the Pallas
  ``ssm_scan`` in interpret mode, at the reference sweep's shapes, an S
  that is no multiple of 64 and B/C passed as strided column slices of
  one x_proj-like output; and against the model's chunked associative
  scan ``_mamba1_inner``.  Tolerance 1e-5 (rtol and atol): the same f32
  recurrence, exponentials and sums of another implementation.  The
  CUDA kernel's arithmetic (``ssm_scan_lanes_model``: exp2 on A log2 e,
  y summed over lanes of four states) against both at the same shapes
  and tolerance.
* ``causal_conv`` (prompts shorter than k - 1 included) and
  ``mamba1_block`` in prefill and decode, 1e-5.
* The LM: prefill plus 16 greedy decode steps, logits within 1e-4 of
  max|ref| and equal tokens; decode vs the reference's ``train_logits``
  (teacher forcing) within 5e-4, the reference's own bar.
* The chunk rule: prefills of 129 and 202 tokens are refused by both
  packages, 32, 128 and 256 accepted with equal logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ssm_scan.kernel import ssm_scan as jssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro.models import ssm as JSSM
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.ssm_scan import kernel as K6
from repro_torch.models import ssm as SSM
from repro_torch.models.model import LM
from _threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
REL_LOGITS = 1e-4
MAX_SEQ = 512


def scan_inputs(seed, b, s, di, n, strided=False):
    """numpy dt, x, bm, cm, a as the reference sweep draws them (dt a
    scaled softplus, A = -exp(N(0, 0.3^2))); with ``strided`` bm and cm
    are columns of one (b, s, 5 + 2n) array, as x_proj's output."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))) * 0.1
    x = rng.standard_normal((b, s, di))
    a = -np.exp(rng.standard_normal((di, n)) * 0.3)
    if strided:
        xdbc = rng.standard_normal((b, s, 5 + 2 * n)) * 0.5
        bm, cm = xdbc[..., 5:5 + n], xdbc[..., 5 + n:]
    else:
        bm = rng.standard_normal((b, s, n)) * 0.5
        cm = rng.standard_normal((b, s, n)) * 0.5
    f32 = [np.asarray(v, np.float32) for v in (dt, x, bm, cm, a)]
    return f32, (xdbc.astype(np.float32) if strided else None)


@pytest.mark.parametrize("b,s,di,n,chunk,bd", [
    (1, 32, 32, 8, 8, 16),
    (2, 64, 64, 16, 16, 32),
    (1, 128, 256, 16, 64, 128),
    (2, 37, 48, 8, 37, 16),            # S no multiple of 64
])
@pytest.mark.parametrize("strided", [False, True])
def test_scan_plain_matches_ref_and_pallas(b, s, di, n, chunk, bd, strided):
    (dt, x, bm, cm, a), xdbc = scan_inputs(s + n, b, s, di, n, strided)
    jy, jh = ssm_scan_ref(*map(jnp.asarray, (dt, x, bm, cm, a)))
    py, ph = jssm_scan(*map(jnp.asarray, (dt, x, bm, cm, a)), chunk=chunk,
                       block_d=bd, interpret=True)
    tbm, tcm = map(torch.from_numpy, (bm, cm))
    if strided:
        t = torch.from_numpy(xdbc)
        tbm, tcm = t[..., 5:5 + n], t[..., 5 + n:]
        assert not tbm.is_contiguous()
    y, h = K6.ssm_scan(torch.from_numpy(dt), torch.from_numpy(x), tbm, tcm,
                       torch.from_numpy(a))
    assert y.dtype == torch.float32 and h.shape == (b, di, n)
    for ry, rh in ((jy, jh), (py, ph)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


@pytest.mark.parametrize("b,s,di,n,chunk,bd", [
    (1, 32, 32, 8, 8, 16),
    (2, 64, 64, 16, 16, 32),
    (1, 128, 256, 16, 64, 128),
    (2, 37, 48, 8, 37, 16),            # S no multiple of 64
])
@pytest.mark.parametrize("strided", [False, True])
def test_scan_lanes_model_matches_ref_and_pallas(b, s, di, n, chunk, bd,
                                                 strided):
    """The CUDA kernel's arithmetic (exp2 on the prescaled A, y summed
    over lanes of four states) against the reference scan and the
    Pallas kernel."""
    (dt, x, bm, cm, a), xdbc = scan_inputs(s + n, b, s, di, n, strided)
    jy, jh = ssm_scan_ref(*map(jnp.asarray, (dt, x, bm, cm, a)))
    py, ph = jssm_scan(*map(jnp.asarray, (dt, x, bm, cm, a)), chunk=chunk,
                       block_d=bd, interpret=True)
    tbm, tcm = map(torch.from_numpy, (bm, cm))
    if strided:
        t = torch.from_numpy(xdbc)
        tbm, tcm = t[..., 5:5 + n], t[..., 5 + n:]
    y, h = K6.ssm_scan_lanes_model(torch.from_numpy(dt), torch.from_numpy(x),
                                   tbm, tcm, torch.from_numpy(a))
    assert y.dtype == torch.float32 and h.shape == (b, di, n)
    for ry, rh in ((jy, jh), (py, ph)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


def test_scan_plain_matches_model_inner():
    """K6 (plain) against the Mamba-1 model's chunked associative scan,
    as ``test_kernels.py`` holds the Pallas kernel to it."""
    cfg = get_config("falcon-mamba-7b").reduced()
    b, s, di, n = 2, 32, cfg.d_inner, cfg.ssm_state
    (dt, x, bm, cm, _), _ = scan_inputs(5, b, s, di, n)
    a_log = np.random.default_rng(6).standard_normal((di, n)) * 0.3
    a_log = a_log.astype(np.float32)
    y1, h1 = JSSM._mamba1_inner(cfg, {"A_log": jnp.asarray(a_log)},
                                *map(jnp.asarray, (x, dt, bm, cm)),
                                jnp.zeros((b, di, n)), chunk=16)
    y2, h2 = K6.ssm_scan(*map(torch.from_numpy, (dt, x, bm, cm)),
                         -torch.exp(torch.from_numpy(a_log)))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), **TOL)


def test_scan_wrapper_rejects_bad_shapes():
    (dt, x, bm, cm, a), _ = scan_inputs(0, 1, 4, 8, 4)
    t = [torch.from_numpy(v) for v in (dt, x, bm, cm, a)]
    with pytest.raises(ValueError):
        K6.ssm_scan(t[0][:, :3], *t[1:])
    with pytest.raises(ValueError):
        K6.ssm_scan(*t[:4], t[4][:4])
    with pytest.raises(ValueError):
        K6.ssm_scan(t[0][:, :0], t[1][:, :0], t[2][:, :0], t[3][:, :0],
                    t[4])


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("falcon-mamba-7b").reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    return (jlm, jparams, LM(tget_config("falcon-mamba-7b").reduced(),
                             device="cpu"),
            bridge.from_numpy(jax.device_get(jparams)))


@pytest.mark.parametrize("s", [1, 2, 5])
def test_causal_conv_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jst = JSSM.causal_conv(*map(jnp.asarray, (x, w, b)))
    y, st = SSM.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert st.shape == (2, 3, 24)
    # decode form: one new input against a conv state
    jy, jst = JSSM.causal_conv(*map(jnp.asarray, (x[:, :1], w, b, state)))
    y, st = SSM.causal_conv(*map(torch.from_numpy, (x[:, :1], w, b,
                                                    state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def test_mamba1_block_prefill_and_decode(mamba):
    jlm, jparams, lm, params = mamba
    cfg = jlm.cfg
    jp = jax.tree.map(lambda t: t[1], jparams["layers"]["ssm"])
    tp = bridge.from_numpy(jax.device_get(jp))
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model))
    x = x.astype(np.float32)
    jy, jc = JSSM.mamba1_block(cfg, jp, jnp.asarray(x[:, :20]),
                               mode="prefill")
    y, c = SSM.mamba1_block(cfg, tp, torch.from_numpy(x[:, :20]),
                            mode="prefill")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), **TOL)
    for t in range(20, 24):
        jy, jc = JSSM.mamba1_block(cfg, jp, jnp.asarray(x[:, t:t + 1]),
                                   cache=jc, mode="decode")
        y, c = SSM.mamba1_block(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                cache=c, mode="decode")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(c["h"].numpy(), np.asarray(jc["h"]),
                                   **TOL)
    # LoRA on the SSM projections: an ssm_in delta alone, as the
    # reference applies it
    rng = np.random.default_rng(4)
    lora = {"ssm_in": {
        "A": (rng.standard_normal((1, 2, cfg.d_model))
              / np.sqrt(cfg.d_model)).astype(np.float32),
        "B": (0.3 * rng.standard_normal((1, 2 * cfg.d_inner, 2))).astype(
            np.float32)}}
    jy, _ = JSSM.mamba1_block(cfg, jp, jnp.asarray(x), mode="prefill",
                              lora=jax.tree.map(jnp.asarray, lora))
    y, _ = SSM.mamba1_block(cfg, tp, torch.from_numpy(x), mode="prefill",
                            lora=bridge.from_numpy(lora))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def rel(a, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def test_prefill_and_16_greedy_decode_steps(mamba):
    jlm, jparams, lm, params = mamba
    prompt = np.random.default_rng(7).integers(3, 259, (1, 23))
    jlogits, jcache = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, MAX_SEQ))(jparams, jnp.asarray(prompt, jnp.int32))
    logits, cache = lm.prefill(params, torch.from_numpy(prompt), MAX_SEQ)
    assert rel(logits.numpy(), jlogits) <= REL_LOGITS
    assert cache["conv"].shape == jcache["conv"].shape
    assert cache["h"].dtype == torch.float32
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(jcache["h"]),
                               **TOL)
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
        logits, cache = lm.decode_step(params, cache, torch.tensor([[tt]]))
        assert rel(logits.numpy(), jlogits) <= REL_LOGITS
    assert ttoks == jtoks
    assert cache["pos"] == int(jcache["pos"]) == 23 + 16


def test_decode_matches_reference_train_logits(mamba):
    """Teacher forcing, as ``test_models_smoke.py`` checks the
    reference against itself: the port's prefill of 6 tokens and decode
    of the next 6 against the reference's full-sequence logits."""
    jlm, jparams, lm, params = mamba
    toks = np.random.default_rng(3).integers(0, jlm.cfg.vocab_size, (2, 12))
    full, _ = jlm.train_logits(jparams, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full)
    lg, cache = lm.prefill(params, torch.from_numpy(toks[:, :6]), 32)
    errs = [np.abs(lg[:, 0].numpy() - full[:, 5]).max()]
    for t in range(6, 12):
        lg, cache = lm.decode_step(params, cache,
                                   torch.from_numpy(toks[:, t:t + 1]))
        errs.append(np.abs(lg[:, 0].numpy() - full[:, t]).max())
    assert max(errs) < 5e-4, f"decode/train divergence {max(errs)}"


@pytest.mark.parametrize("s,served", [(32, True), (128, True), (256, True),
                                      (129, False), (202, False)])
def test_chunk_rule_matches_reference(mamba, s, served):
    """The reference's chunked scan serves s <= 128 or s % 128 == 0; the
    port refuses the same lengths (ValueError where the reference
    asserts) and serves the others with the reference's logits."""
    jlm, jparams, lm, params = mamba
    toks = np.random.default_rng(s).integers(3, 259, (1, s))
    run_ref = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, MAX_SEQ))
    if not served:
        with pytest.raises(AssertionError):
            run_ref(jparams, jnp.asarray(toks, jnp.int32))
        with pytest.raises(ValueError, match="chunk 128"):
            lm.prefill(params, torch.from_numpy(toks), MAX_SEQ)
        return
    jlogits, _ = run_ref(jparams, jnp.asarray(toks, jnp.int32))
    logits, _ = lm.prefill(params, torch.from_numpy(toks), MAX_SEQ)
    assert rel(logits.numpy(), jlogits) <= REL_LOGITS


def test_config_and_params_match_reference(mamba):
    jlm, jparams, lm, params = mamba
    cfg, tcfg = jlm.cfg, lm.cfg
    for f in ("num_layers", "d_model", "d_inner", "ssm_state", "dt_rank",
              "vocab_size", "attn_free", "tie_embeddings", "dtype"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    full = tget_config("falcon-mamba-7b")
    assert (full.d_inner, full.dt_rank, full.ssm_state) == (8192, 256, 16)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.device_get(jparams))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    mine = jax.tree.map(lambda t: tuple(t.shape), lm.init(0))
    assert mine == shapes
    # 7,272,665,088 parameters at full width

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return int(np.prod(tree[0]))
    assert count(LM(full, device="cpu").param_shapes()) == 7_272_665_088


def test_port_init_follows_the_reference_laws():
    """Seeded on-device init of the Mamba-1 tree: the reference's laws
    (fan-in over every axis but the last, the untied unembedding's over
    d_model; A_log and D ones, the biases zeros)."""
    cfg = tget_config("falcon-mamba-7b").reduced()
    p = LM(cfg, device="cpu").init(5)
    ssm = p["layers"]["ssm"]
    for w, fan_in in ((ssm["in_proj"]["w"], cfg.num_layers * cfg.d_model),
                      (ssm["x_proj"]["w"], cfg.num_layers * cfg.d_inner),
                      (p["embed"]["unembed"]["w"], cfg.d_model)):
        assert abs(w.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    for leaf, fill in ((ssm["A_log"], 1.0), (ssm["D"], 1.0),
                       (ssm["conv_b"], 0.0), (ssm["dt_proj"]["b"], 0.0)):
        assert torch.equal(leaf, torch.full_like(leaf, fill))
    assert not torch.equal(p["layers"]["ssm"]["conv_w"][0],
                           p["layers"]["ssm"]["conv_w"][1])
