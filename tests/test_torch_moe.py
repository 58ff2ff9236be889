"""The port's MoE family vs the JAX package's, on the CPU: the reduced
granite-moe (d 256, H 4 / KV 2 / head_dim 32, 4 experts with top-2
routing, expert FFN 128, vocab 512, 2 layers) in float32, the
reference's parameters bridged, inputs from numpy seeds.  Variants:
the reduced config's capacity factor 8.0, which never drops an
assignment; the full config's 1.25, at which a prefill of 40 tokens
drops some (asserted, and the count equal to the reference's);
``first_k_dense=1`` (a dense layer first, its own stack) and
``num_shared_experts=1`` (a shared expert's MLP, with LoRA targets).

* The layout: the spec tree's paths and shapes, ``lora_layout``, the
  layer order and the cache leaves equal to the reference's;
  ``init_keyed`` bit for bit (the router's ``normal`` law, the experts'
  fan-in over (L, E, d)); the bridge's round trip of the MoE leaves.
* ``moe_ffn`` on a layer's parameters: y within LOSS_TOL 1e-5 and the
  aux loss within 1e-6 of the reference's, the dropped count equal.
* ``train_logits`` with and without a LoRA bank (aux included),
  prefill + decode steps (each within REL_LOGITS 1e-4; against the
  reference's ``train_logits`` by teacher forcing within 5e-4 at cf 8.0
  only: at cf 1.25 a prefill drops and a decode never does), packed
  prefill with rows competing for capacity.
* ``SoloEngine`` greedy ids equal to the reference's: plain, with
  per-user adapter slots and with a router-gated bank.
* What both packages refuse: the history API, speculative rollback and
  the batched engine; MLA names its ROADMAP entry.

Tolerances are relative to the largest reference magnitude, as
``test_torch_zamba2.py`` states them (float32 sums in another order).
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
from repro.models import moe as JMOE
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import SoloEngine as JSolo
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.data import tokenizer as TOK
from repro_torch.models import moe as MOE
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, SoloEngine
from _threads import one_thread  # noqa: F401

ARCH = "granite-moe-3b-a800m"
LOSS_TOL = 1e-5
REL_LOGITS = 1e-4
AUX_TOL = 1e-6
PROMPTS = ["math: compute 12 plus 7 =", "translate to french: water ->",
           "explain how rainbows form " * 2]
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9"],
           "lang": ["translate water", "say hello in french"]}
# (capacity_factor, first_k_dense, num_shared_experts)
VARIANTS = [(8.0, 0, 0), (1.25, 0, 0), (8.0, 1, 0), (1.25, 0, 1)]


def _cfgs(cf=8.0, kd=0, shared=0):
    return tuple(dataclasses.replace(get(ARCH).reduced(),
                                     capacity_factor=cf, first_k_dense=kd,
                                     num_shared_experts=shared)
                 for get in (get_config, tget_config))


def _close(got, want, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if not want.size:               # the zero-layer "dense" stack
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


_MODELS = {}


def _models(cf=8.0, kd=0, shared=0):
    """Both packages at one variant, the reference's parameters from key
    0 bridged (built once a variant)."""
    key = (cf, kd, shared)
    if key not in _MODELS:
        jcfg, cfg = _cfgs(*key)
        jlm = JLM(jcfg, remat=False)
        jparams = jlm.init(jax.random.key(0))
        _MODELS[key] = (jlm, jparams, LM(cfg, device="cpu"),
                        bridge.from_numpy(jax.device_get(jparams)))
    return _MODELS[key]


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


def _ref_drops(cfg, jparams_layer, x):
    """The assignments the reference's ``moe_ffn`` drops on x (B, S, d):
    its router's picks over each expert's capacity."""
    t = x.shape[0] * x.shape[1]
    ids, _, _ = JMOE._router(cfg, jparams_layer, x.reshape(t, -1))
    counts = np.bincount(np.asarray(ids).reshape(-1),
                         minlength=cfg.num_experts)
    return int(np.maximum(counts - MOE.capacity(cfg, t), 0).sum())


@pytest.mark.parametrize("cf,kd,shared", VARIANTS)
def test_layout_equals_reference(cf, kd, shared):
    """Spec paths and shapes (the router, w_in (L, E, d, 2f), w_out, the
    shared expert), the LoRA layout (q, k, v, o and the shared expert's
    MLP on the MoE layers, the dense targets on ``dense_layers``), the
    layer order (dense layers first) and the cache leaves (a zero-layer
    "dense" stack without dense layers)."""
    jcfg, cfg = _cfgs(cf, kd, shared)
    jlm, lm = JLM(jcfg, remat=False), LM(cfg, device="cpu")
    spec = list(_paths(lm.param_shapes()))
    ref = list(_paths(jax.eval_shape(lambda: jlm.init(jax.random.key(0)))))
    assert [p for p, _ in spec] == [p for p, _ in ref]
    assert all(s[0] == tuple(a.shape) for (_, s), (_, a) in zip(spec, ref))
    assert lm.lora_layout() == jlm.lora_layout()
    assert sorted(lm.lora_layout()["layers"][1]) == sorted(
        ["q", "k", "v", "o"] + ["mlp_in", "mlp_out"] * bool(shared))
    sites = lm.layer_sites()
    assert [(s.addr, s.stack) for s in sites] == \
        [(("dense", (i,)), "dense_layers") for i in range(kd)] + \
        [(("moe", (i,)), "layers") for i in range(cfg.num_layers - kd)]
    cache = lm.init_cache(2, 32)
    want = jax.eval_shape(lambda: jlm.init_cache(2, 32))
    assert sorted(cache) == sorted(want) == ["dense", "moe", "pos"]
    for kind in ("dense", "moe"):
        for name in ("k", "v"):
            assert tuple(cache[kind][name].shape) == want[kind][name].shape
    assert cache["dense"]["k"].shape[0] == kd


@pytest.mark.parametrize("kd,shared", [(0, 0), (1, 1)])
def test_init_keyed_equals_reference_init_bit_for_bit(kd, shared):
    """``LM.init_keyed(seed)`` is ``lm.init(jax.random.key(seed))`` leaf
    for leaf: the router's ``normal`` law (std 0.02), the experts'
    fan-in over (L, E, d); and the bridge carries the MoE leaves back
    and forth unchanged."""
    jcfg, cfg = _cfgs(8.0, kd, shared)
    want = jax.device_get(JLM(jcfg, remat=False).init(jax.random.key(3)))
    got = LM(cfg, device="cpu").init_keyed(3)
    g, w = T.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    moe = got["layers"]["moe"]
    assert abs(float(moe["router"]["w"].std()) - 0.02) < 2e-3
    back = bridge.to_numpy(bridge.from_numpy(want))
    for a, b in zip(T.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("cf,kd,shared", VARIANTS)
def test_moe_ffn_matches_reference(cf, kd, shared):
    """One MoE layer's FFN on a (2, 20, d) input: y within LOSS_TOL, aux
    within AUX_TOL, the dropped assignments counted as the reference's
    router picks overflow its capacities: none at cf 8.0, some at 1.25;
    the shared expert's LoRA (mlp_in/mlp_out) reaches its MLP."""
    jlm, jparams, lm, params = _models(cf, kd, shared)
    cfg = lm.cfg
    x = np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["moe"])
    tp = T.map_tree(lambda t: t[0], params["layers"]["moe"])
    lora = jlora = gates = None
    if shared:
        jbank, bank = _bank_pair(jlm, (3,))
        jlora = jax.tree.map(lambda t: t[0],
                             JLORA.bank_for_model(jbank)["layers"])
        lora = T.map_tree(lambda t: t[0],
                          LORA.bank_for_model(bank)["layers"])
        gates = np.ones((1,), np.float32)
    wy, waux = JMOE.moe_ffn(jlm.cfg, jp, jnp.asarray(x), jlora,
                            None if gates is None else jnp.asarray(gates))
    with MOE.record_drops() as drops:
        ty, taux = MOE.moe_ffn(cfg, tp, torch.from_numpy(x), lora,
                               None if gates is None
                               else torch.from_numpy(gates))
    _close(ty, wy, LOSS_TOL)
    assert abs(float(taux) - float(waux)) <= AUX_TOL
    want = _ref_drops(jlm.cfg, jp, jnp.asarray(x))
    assert [int(d) for d in drops] == [want]
    assert (want > 0) == (cf == 1.25)
    if shared:
        plain, _ = MOE.moe_ffn(cfg, tp, torch.from_numpy(x))
        assert not torch.allclose(plain, ty)


@pytest.mark.parametrize("cf,kd,shared", VARIANTS)
def test_train_logits_match_reference(cf, kd, shared):
    """Logits within LOSS_TOL and the summed aux loss within AUX_TOL of
    the reference's, with and without a gated two-adapter bank."""
    jlm, jparams, lm, params = _models(cf, kd, shared)
    toks = np.random.default_rng(1).integers(0, jlm.cfg.vocab_size, (2, 20))
    jbank, bank = _bank_pair(jlm, (4, 5))
    gates = np.asarray([[0.6, 0.4], [0.0, 1.0]], np.float32)
    for lora in (False, True):
        want, waux = jlm.train_logits(
            jparams, {"tokens": jnp.asarray(toks)},
            lora=JLORA.bank_for_model(jbank) if lora else None,
            gates=jnp.asarray(gates) if lora else None)
        got, aux = lm.train_logits(
            params, {"tokens": torch.from_numpy(toks)},
            lora=LORA.bank_for_model(bank) if lora else None,
            gates=torch.from_numpy(gates) if lora else None)
        _close(got, want, LOSS_TOL)
        assert float(aux) > 0
        assert abs(float(aux) - float(waux)) <= AUX_TOL


@pytest.mark.parametrize("cf,kd,shared", VARIANTS)
def test_prefill_decode_match_reference(cf, kd, shared):
    """Prefill 20 tokens (drops at cf 1.25) and decode 5: logits within
    REL_LOGITS of the reference's at every step, the caches' K/V within
    1e-5 and "pos" equal; at cf 8.0 also within 5e-4 of the reference's
    ``train_logits`` by teacher forcing (its ``test_models_smoke.py``
    bar; a prefill at cf 1.25 drops where a decode step, T = B, never
    does, so no such identity holds there)."""
    jlm, jparams, lm, params = _models(cf, kd, shared)
    toks = np.random.default_rng(2).integers(0, lm.cfg.vocab_size, (2, 25))
    full, _ = jlm.train_logits(jparams, {"tokens": jnp.asarray(toks)})
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :20])}, 32)
    with MOE.record_drops() as drops:
        tl, tc = lm.prefill(params, torch.from_numpy(toks[:, :20]), 32)
    assert (sum(int(d) for d in drops) > 0) == (cf == 1.25)
    _close(tl, jl, REL_LOGITS)
    errs = [float(np.abs(tl.numpy()[:, 0] - np.asarray(full)[:, 19]).max())]
    for t in range(20, 25):
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        with MOE.record_drops() as drops:
            tl, tc = lm.decode_step(params, tc,
                                    torch.from_numpy(toks[:, t:t + 1]))
        assert not any(int(d) for d in drops)
        _close(tl, jl, REL_LOGITS)
        errs.append(float(np.abs(tl.numpy()[:, 0]
                                 - np.asarray(full)[:, t]).max()))
    if cf == 8.0:
        assert max(errs) < 5e-4
    for kind in ("dense", "moe"):
        for name in ("k", "v"):
            _close(tc[kind][name], jc[kind][name], 1e-5)
    assert tc["pos"] == int(jc["pos"]) == 25


@pytest.mark.parametrize("cf,kd,shared", [(1.25, 0, 0), (8.0, 1, 1)])
def test_prefill_packed_matches_reference(cf, kd, shared):
    """Rows of 32, 20 and 7 tokens right-padded to Lpad 32, with and
    without a gated bank: the padding and the other rows compete for
    each expert's capacity (drops at cf 1.25), as in the reference.  Each
    row's last-valid-token logits within REL_LOGITS, every K/V row within
    1e-5 (zero past Lpad), "pos" the lengths."""
    jlm, jparams, lm, params = _models(cf, kd, shared)
    lengths, lpad, max_seq = [32, 20, 7], 32, 48
    rng = np.random.default_rng(32)
    toks = rng.integers(3, 259, (len(lengths), lpad)).astype(np.int32)
    jbank, bank = _bank_pair(jlm, (2, 3))
    gates = rng.random((len(lengths), 2)).astype(np.float32)
    for lora in (False, True):
        kw = dict(lora=JLORA.bank_for_model(jbank),
                  gates=jnp.asarray(gates)) if lora else {}
        jl, jc = jlm.prefill_packed(jparams, {"tokens": jnp.asarray(toks)},
                                    np.asarray(lengths), max_seq, **kw)
        tkw = dict(lora=LORA.bank_for_model(bank),
                   gates=torch.from_numpy(gates)) if lora else {}
        with MOE.record_drops() as drops:
            logits, cache = lm.prefill_packed(
                params, torch.from_numpy(toks), lengths, max_seq, **tkw)
        assert (sum(int(d) for d in drops) > 0) == (cf == 1.25)
        _close(logits, jl, REL_LOGITS)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for kind in ("dense", "moe"):
            for name in ("k", "v"):
                assert cache[kind][name].shape[2] == max_seq
                _close(cache[kind][name], jc[kind][name], 1e-5)


@pytest.fixture
def token_ids(monkeypatch):
    """Both packages decode to the id list, so outputs compare ids."""
    def ids(seq):
        return ",".join(str(int(i)) for i in seq)
    monkeypatch.setattr(JTOK, "decode", ids)
    monkeypatch.setattr(TOK, "decode", ids)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_solo_engine_matches_reference(cf, token_ids):
    """Greedy ids of the plain engine, of three users' adapters over two
    slots (K5 gate rows at prefill, K4 slot ids at decode) and of a
    router-gated bank equal the reference's; adapters move some ids."""
    jlm, jparams, lm, params = _models(cf)
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


def test_moe_refusals():
    """The history API (the reference's moe stack passes no history to
    its layers in prefill), speculative rollback (both packages) and the
    batched engine (both packages) refuse the family; an MLA config
    names its ROADMAP entry."""
    from repro.core import fusion as JFUS
    from repro.serving.engine import BatchedHybridEngine as JBatched
    jlm, jparams, lm, params = _models()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: lm.build_prefix(params, toks),
                 lambda: lm.prefill_suffix(params, toks, [4], {"len": 0}),
                 lambda: lm.extend_history({"len": 0}, {})):
        with pytest.raises(NotImplementedError, match="moe family"):
            call()
    with pytest.raises(NotImplementedError):
        jlm.spec_snapshot(jlm.init_cache(1, 16), jnp.zeros((1,), jnp.int32),
                          2, 16)
    with pytest.raises(NotImplementedError, match="got moe"):
        lm.spec_snapshot(lm.init_cache(1, 16),
                         torch.zeros(1, dtype=torch.int32), 2, 16)
    mlp = JFUS.init_alignment(jax.random.key(3), jlm.cfg.vocab_size)
    jdep = JDep(jlm, jparams, jlm, jparams, mlp, max_seq=32)
    tdep = ServingDeployment(lm, params, lm, params,
                             bridge.from_numpy(jax.device_get(mlp)),
                             max_seq=32, device="cpu")
    with pytest.raises(NotImplementedError, match="got moe") as want:
        JBatched(deployment=jdep)
    with pytest.raises(NotImplementedError, match="got moe") as got:
        BatchedHybridEngine(deployment=tdep)
    assert str(got.value) == str(want.value)
    mla = dataclasses.replace(tget_config(ARCH).reduced(), use_mla=True)
    with pytest.raises(NotImplementedError, match="item 9's deepseek"):
        LM(mla, device="cpu")
