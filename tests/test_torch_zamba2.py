"""The port's zamba2 hybrid vs the JAX package's, on the CPU: the reduced
zamba2 (d 256, Mamba-2 d_inner 512 with 32 SSD heads of 16, N 8; the
shared attention block H 4 / KV 2 / head_dim 32, window 16; d_ff 512,
vocab 512) in float32, with ``num_layers`` 2 (one group, no tail) or 5
(two groups and a tail of one) at ``attn_every`` 2, the reference's
parameters bridged, inputs from numpy seeds.

* The layout: the spec tree's paths and shapes, ``lora_layout`` and the
  layer order equal to the reference's; ``init_keyed`` bit for bit with
  a zero-length and with a one-layer tail.
* ``train_logits``, with and without a LoRA bank, within LOSS_TOL 1e-5
  of the largest reference logit; prefill + decode steps within 1e-4
  and against the reference's own ``train_logits`` (teacher forcing,
  the reference's 5e-4 bar, ``tests/test_models_smoke.py:72-90``),
  also with ring caches past the window's wrap (``:108-123``).
* Per-group ``special`` LoRA slices that differ: the shared block's
  weights serve every group, its adapter slice is each group's own.
* ``SoloEngine`` greedy ids equal to the reference's: plain, with
  per-user adapter slots and with a router-gated bank.
* What both packages refuse for the hybrid: suffix prefill, speculative
  rollback, the batched engine; the port's packed prefill takes no
  ``write_kv`` for it.  Its packed prefill and training are held to the
  reference in ``test_torch_train_zamba2.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import lora as JLORA
from repro.core.router import ExpertMeta as JMeta
from repro.core.router import Router as JRouter
from repro.core.router import expert_embedding as jexpert_embedding
from repro.data import tokenizer as JTOK
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import SoloEngine as JSolo
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.data import tokenizer as TOK
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, SoloEngine
from _threads import one_thread  # noqa: F401

ARCH = "zamba2-7b"
LOSS_TOL = 1e-5
REL_LOGITS = 1e-4
PROMPTS = ["math: compute 12 plus 7 =", "translate to french: water ->",
           "explain how rainbows form " * 2]
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9"],
           "lang": ["translate water", "say hello in french"]}


def _cfgs(n_layers, **kw):
    return tuple(dataclasses.replace(get(ARCH).reduced(),
                                     num_layers=n_layers, **kw)
                 for get in (get_config, tget_config))


def _close(got, want, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def models():
    """Two groups and a tail of one, both packages."""
    jcfg, cfg = _cfgs(5)
    jlm = JLM(jcfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    return jlm, jparams, LM(cfg, device="cpu"), \
        bridge.from_numpy(jax.device_get(jparams))


def _adapter(jlm, seed, scale=0.5):
    """A reference adapter with random B (``init_adapter`` zeroes B)."""
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=4))
    rng = np.random.default_rng(seed)
    for stack in ad:
        if stack.startswith("_"):
            continue
        for leaf in ad[stack].values():
            leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                         ).astype(np.float32)
    return ad


def _bank_pair(jlm, seeds):
    ads = [_adapter(jlm, s) for s in seeds]
    jbank = JLORA.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads])
    bank = LORA.stack_adapters([bridge.from_numpy(a) for a in ads])
    return jbank, bank


@pytest.mark.parametrize("n_layers", [2, 5])
def test_layout_equals_reference(n_layers):
    """Spec paths and shapes, LoRA layout, the layer order (each group's
    Mamba-2 layers, then the shared block) and the cache leaves."""
    jcfg, cfg = _cfgs(n_layers)
    jlm, lm = JLM(jcfg, remat=False), LM(cfg, device="cpu")
    spec = list(_paths(lm.param_shapes()))
    ref = list(_paths(jax.eval_shape(lambda: jlm.init(jax.random.key(0)))))
    assert [p for p, _ in spec] == [p for p, _ in ref]
    assert all(s[0] == tuple(a.shape) for (_, s), (_, a) in zip(spec, ref))
    assert lm.lora_layout() == jlm.lora_layout()
    _, n_groups, g, tail = lm._layout()
    assert lm._layout() == jlm._layout()
    sites = lm.layer_sites()
    assert [s.addr for s in sites] == [
        a for gi in range(n_groups)
        for a in [("inner", (gi, j)) for j in range(g - 1)]
        + [("attn", (gi,))]] + [("tail", (t,)) for t in range(tail)]
    assert [s.ssm for s in sites] == [s.stack != "shared_attn"
                                      for s in sites]
    cache = lm.init_cache(2, 32)
    want = jax.eval_shape(lambda: jlm.init_cache(2, 32))
    got = {k: v for k, v in cache.items() if k != "pos"}
    assert [tuple(t.shape) for t in T.leaves(got)] == [
        tuple(t.shape) for k in sorted(want) if k != "pos"
        for t in jax.tree.leaves(want[k])]


@pytest.mark.parametrize("n_layers", [2, 5])
def test_init_keyed_equals_reference_init_bit_for_bit(n_layers):
    """``LM.init_keyed(seed)`` is ``lm.init(jax.random.key(seed))`` leaf
    for leaf, a zero-length tail (2 layers) and a tail of one (5)
    included."""
    jcfg, cfg = _cfgs(n_layers)
    want = jax.device_get(JLM(jcfg, remat=False).init(jax.random.key(3)))
    got = LM(cfg, device="cpu").init_keyed(3)
    g, w = T.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["tail"]["ssm"]["in_proj"]["w"].shape[0] == n_layers % 2


def test_train_logits_match_reference(models):
    jlm, jparams, lm, params = models
    toks = np.random.default_rng(1).integers(0, jlm.cfg.vocab_size, (2, 20))
    jbank, bank = _bank_pair(jlm, (4, 5))
    gates = np.asarray([[0.6, 0.4], [0.0, 1.0]], np.float32)
    for lora in (False, True):
        want, _ = jlm.train_logits(
            jparams, {"tokens": jnp.asarray(toks)},
            lora=JLORA.bank_for_model(jbank) if lora else None,
            gates=jnp.asarray(gates) if lora else None)
        got, aux = lm.train_logits(
            params, {"tokens": torch.from_numpy(toks)},
            lora=LORA.bank_for_model(bank) if lora else None,
            gates=torch.from_numpy(gates) if lora else None)
        _close(got, want, LOSS_TOL)
        assert float(aux) == 0.0


@pytest.mark.parametrize("ring", [False, True])
def test_prefill_decode_match_reference_and_teacher_forcing(ring):
    """Prefill 6 tokens and decode 5 (past the ring's wrap at window 4):
    logits within 1e-4 of the reference's decode and within 5e-4 of the
    reference's ``train_logits``; the caches' states agree."""
    kw = dict(sliding_window=4) if ring else {}
    jcfg, cfg = _cfgs(5, **kw)
    jlm = JLM(jcfg, remat=False, ring_cache=ring)
    jparams = jlm.init(jax.random.key(1))
    lm = LM(cfg, device="cpu", ring_cache=ring)
    params = bridge.from_numpy(jax.device_get(jparams))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 11))
    full, _ = jlm.train_logits(jparams, {"tokens": jnp.asarray(toks)})
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :6])}, 32)
    tl, tc = lm.prefill(params, torch.from_numpy(toks[:, :6]), 32)
    assert tc["attn"]["k"].shape[2] == (4 if ring else 32)
    errs = [float(np.abs(tl.numpy()[:, 0] - np.asarray(full)[:, 5]).max())]
    _close(tl, jl, REL_LOGITS)
    for t in range(6, 11):
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = lm.decode_step(params, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl, REL_LOGITS)
        errs.append(float(np.abs(tl.numpy()[:, 0]
                                 - np.asarray(full)[:, t]).max()))
    assert max(errs) < 5e-4
    for kind in ("inner", "tail"):
        for name in ("conv", "h"):
            _close(tc[kind][name], jc[kind][name], REL_LOGITS)
    _close(tc["attn"]["k"], jc["attn"]["k"], REL_LOGITS)
    assert tc["pos"] == int(jc["pos"]) == 11


def test_special_slices_differ_per_group():
    """Two groups share the attention weights but not their adapter: a
    bank whose ``special`` slices differ by group gives the reference's
    logits, and swapping the two slices changes them."""
    jcfg, cfg = _cfgs(5)
    jlm = JLM(jcfg, remat=False)
    jparams = jlm.init(jax.random.key(4))
    lm = LM(cfg, device="cpu")
    params = bridge.from_numpy(jax.device_get(jparams))
    ad = _adapter(jlm, 7, scale=2.0)
    for stack in ("inner", "tail"):       # the shared block's adapter only
        for leaf in ad[stack].values():
            leaf["B"] = np.zeros_like(leaf["B"])
    jbank = JLORA.bank_for_model(JLORA.stack_adapters(
        [jax.tree.map(jnp.asarray, ad)]))
    bank = LORA.bank_for_model(LORA.stack_adapters([bridge.from_numpy(ad)]))
    sp = bank["special"]["q"]["B"]
    assert not torch.equal(sp[0], sp[1])
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 10))
    ones = np.ones((1,), np.float32)
    want, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16,
                          lora=jbank, gates=jnp.asarray(ones))
    got, _ = lm.prefill(params, torch.from_numpy(toks), 16, lora=bank,
                        gates=torch.from_numpy(ones))
    _close(got, want, REL_LOGITS)
    swapped = T.map_tree(lambda t: t.flip(0) if t.shape[0] == 2 else t,
                         {"special": bank["special"]})
    other, _ = lm.prefill(params, torch.from_numpy(toks), 16,
                          lora=dict(bank, **swapped),
                          gates=torch.from_numpy(ones))
    plain, _ = lm.prefill(params, torch.from_numpy(toks), 16)
    assert not torch.allclose(other, got) and not torch.allclose(plain, got)


@pytest.fixture
def token_ids(monkeypatch):
    """Both packages decode to the id list, so outputs compare ids."""
    def ids(seq):
        return ",".join(str(int(i)) for i in seq)
    monkeypatch.setattr(JTOK, "decode", ids)
    monkeypatch.setattr(TOK, "decode", ids)


def test_solo_engine_matches_reference(models, token_ids):
    """Greedy ids of the plain engine, of three users' adapters over two
    slots (K5 gate rows at prefill, K4 slot ids at decode) and of a
    router-gated bank equal the reference's; adapters move some ids."""
    jlm, jparams, lm, params = models
    plain = {}
    jeng = JSolo(deployment=JDep(jlm, jparams, max_seq=64))
    teng = SoloEngine(deployment=ServingDeployment(lm, params, max_seq=64,
                                                   device="cpu"))
    for p in PROMPTS:
        plain[p] = jeng.generate(p, 4)
        assert teng.generate(p, 4) == plain[p]
    jeng = JSolo(deployment=JDep(jlm, jparams, max_seq=64, adapter_slots=2))
    teng = SoloEngine(deployment=ServingDeployment(
        lm, params, max_seq=64, adapter_slots=2, device="cpu"))
    for i in range(3):
        ad = _adapter(jlm, 10 + i, scale=2.0)
        jeng.adapters.register(f"u{i}", jax.tree.map(jnp.asarray, ad))
        teng.adapters.register(f"u{i}", bridge.from_numpy(ad))
    moved = 0
    for p, aid in zip(PROMPTS, ("u0", "u1", "u2")):
        want = jeng.generate(p, 4, adapter_id=aid)
        assert teng.generate(p, 4, adapter_id=aid) == want
        moved += want != plain[p]
    assert moved and teng.adapter_stats() == jeng.adapter_stats()
    ads = [_adapter(jlm, 20 + j, scale=2.0) for j in range(len(DOMAINS))]
    bank = jax.device_get(JLORA.stack_adapters(
        [jax.tree.map(jnp.asarray, a) for a in ads]))
    jr = JRouter([JMeta(n, jexpert_embedding(s), i)
                  for i, (n, s) in enumerate(sorted(DOMAINS.items()))])
    tr = Router([ExpertMeta(n, expert_embedding(s), i)
                 for i, (n, s) in enumerate(sorted(DOMAINS.items()))])
    jeng = JSolo(deployment=JDep(jlm, jparams, max_seq=64,
                                 expert_bank=jax.tree.map(jnp.asarray, bank)),
                 router=jr)
    teng = SoloEngine(deployment=ServingDeployment(
        lm, params, max_seq=64, expert_bank=bridge.from_numpy(bank),
        device="cpu"), router=tr)
    for p in PROMPTS[:2]:
        assert teng.generate(p, 4) == jeng.generate(p, 4)


def test_hybrid_refusals(models):
    """Suffix prefill, speculative rollback and the batched engine are
    refused by both packages; the port's packed prefill takes no
    ``write_kv`` for the hybrid (no engine streams its state), as for the
    SSM family."""
    from repro.core import fusion as JFUS
    from repro.serving.engine import BatchedHybridEngine as JBatched
    jlm, jparams, lm, params = models
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(NotImplementedError):
        jlm.prefill_suffix(jparams, {"tokens": jnp.asarray(toks)}, [4],
                           None, 0)
    with pytest.raises(NotImplementedError):
        lm.prefill_suffix(params, torch.from_numpy(toks), [4],
                          {"len": 0})
    with pytest.raises(NotImplementedError):
        lm.build_prefix(params, torch.from_numpy(toks))
    with pytest.raises(NotImplementedError):
        jlm.spec_snapshot(jlm.init_cache(1, 16), jnp.zeros((1,), jnp.int32),
                          2, 16)
    cache = lm.init_cache(1, 16)
    with pytest.raises(NotImplementedError):
        lm.spec_snapshot(cache, torch.zeros(1, dtype=torch.int32), 2, 16)
    with pytest.raises(ValueError, match="write_kv"):
        lm.prefill_packed(params, torch.from_numpy(toks), [4], 16,
                          write_kv=lambda *a: None)
    mlp = JFUS.init_alignment(jax.random.key(3), jlm.cfg.vocab_size)
    jdep = JDep(jlm, jparams, jlm, jparams, mlp, max_seq=32)
    tdep = ServingDeployment(lm, params, lm, params,
                             bridge.from_numpy(jax.device_get(mlp)),
                             max_seq=32, device="cpu")
    with pytest.raises(NotImplementedError, match="got hybrid") as want:
        JBatched(deployment=jdep)
    with pytest.raises(NotImplementedError, match="got hybrid") as got:
        BatchedHybridEngine(deployment=tdep)
    assert str(got.value) == str(want.value)
