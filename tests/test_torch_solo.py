"""The port's ``SoloEngine`` (single-model serving over an SLM-only
deployment) vs the JAX package's, float32 on the CPU, from the same
(bridged) parameters: on the reduced floe-slm-2b (dense) and the reduced
falcon-mamba (Mamba-1).

* Greedy outputs equal the reference's token for token (both packages'
  ``decode`` print ids, since the byte tokenizer drops ids past 258),
  prompts within the reference's SSM chunk rule.
* ``last_truncated`` as ``test_growth.py`` checks it.
* Per-user adapters and router gates on the dense SLM (K5 plain), as
  ``test_adapters.py`` checks them: equal outputs, ``adapter_stats()``,
  unknown adapters raise; per-user adapters on the SSM too.
* The construction errors of ``HybridEngine`` and
  ``BatchedHybridEngine`` on SLM-only and SSM deployments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.core import lora as JLORA
from repro.core.router import ExpertMeta as JMeta
from repro.core.router import Router as JRouter
from repro.core.router import expert_embedding as jexpert_embedding
from repro.data import tokenizer as JTOK
from repro.models.model import LM as JLM
from repro.serving.adapters import UnknownAdapter as JUnknown
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.engine import HybridEngine as JEngine
from repro.serving.engine import SoloEngine as JSolo
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.data import tokenizer as TOK
from repro_torch.models.model import LM
from repro_torch.serving.adapters import UnknownAdapter
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import (BatchedHybridEngine, HybridEngine,
                                        SoloEngine)
from _threads import one_thread  # noqa: F401

PROMPTS = ["math: compute 12 plus 7 =", "translate to french: water ->",
           "my doctor said my blood pressure is 140 over 90",
           "explain how rainbows form " * 4]
LONG = "a long prompt " * 20
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9"],
           "lang": ["translate water", "say hello in french"],
           "science": ["explain how rain forms", "why is the sky blue"]}


@pytest.fixture(autouse=True)
def token_ids(monkeypatch):
    """Both packages decode to the id list, so outputs compare ids."""
    def ids(seq):
        return ",".join(str(int(i)) for i in seq)
    monkeypatch.setattr(JTOK, "decode", ids)
    monkeypatch.setattr(TOK, "decode", ids)


def _model(name, key):
    jlm = JLM(get_config(name).reduced(), remat=False)
    jp = jlm.init(jax.random.key(key))
    return jlm, jp, LM(tget_config(name).reduced(), device="cpu"), \
        bridge.from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module", params=["floe-slm-2b", "falcon-mamba-7b"])
def model(request):
    return _model(request.param, 0)


def _solos(model, max_seq, **kw):
    jlm, jp, lm, tp = model
    return (JSolo(deployment=JDep(jlm, jp, max_seq=max_seq, **kw)),
            SoloEngine(deployment=ServingDeployment(lm, tp, max_seq=max_seq,
                                                    device="cpu", **kw)))


def test_solo_outputs_match_reference(model):
    jeng, teng = _solos(model, 160)
    for i, p in enumerate(PROMPTS):
        n = 6 + i
        want = jeng.generate(p, n)
        assert teng.generate(p, n) == want
        assert len(want.split(",")) <= n


def test_solo_last_truncated(model):
    jeng, teng = _solos(model, 48)
    for p in (LONG, "short one"):
        want = jeng.generate(p, 4)
        assert teng.generate(p, 4) == want
        assert teng.last_truncated == jeng.last_truncated == (p == LONG)


def _adapter(jlm, seed):
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=2))
    rng = np.random.default_rng(seed)
    for leaf in ad["layers"].values():
        leaf["B"] = (2.0 * rng.standard_normal(leaf["B"].shape)
                     ).astype(np.float32)
    return ad


def test_solo_adapters_match_reference():
    model = _model("floe-slm-2b", 0)
    jeng, teng = _solos(model, 48, adapter_slots=2)
    ad = _adapter(model[0], 3)
    jeng.adapters.register("u0", jax.tree.map(jnp.asarray, ad))
    teng.adapters.register("u0", bridge.from_numpy(ad))
    out = {}
    for aid in ("u0", None):
        out[aid] = jeng.generate(PROMPTS[0], 6, adapter_id=aid)
        assert teng.generate(PROMPTS[0], 6, adapter_id=aid) == out[aid]
    assert out["u0"] != out[None]            # the adapter is at work
    st = teng.adapter_stats()
    assert st == jeng.adapter_stats()
    assert st["loads"] == 1 and st["pinned"] == 0
    with pytest.raises(JUnknown):
        jeng.generate(PROMPTS[0], 4, adapter_id="ghost")
    with pytest.raises(UnknownAdapter):
        teng.generate(PROMPTS[0], 4, adapter_id="ghost")


def test_solo_router_matches_reference():
    jlm, jp, lm, tp = model = _model("floe-slm-2b", 0)
    bank = jax.device_get(JLORA.stack_adapters(
        [jax.tree.map(jnp.asarray, _adapter(jlm, 10 + j))
         for j in range(len(DOMAINS))]))
    jr = JRouter([JMeta(n, jexpert_embedding(s), i)
                  for i, (n, s) in enumerate(sorted(DOMAINS.items()))])
    tr = Router([ExpertMeta(n, expert_embedding(s), i)
                 for i, (n, s) in enumerate(sorted(DOMAINS.items()))])
    jeng = JSolo(deployment=JDep(jlm, jp, max_seq=96,
                                 expert_bank=jax.tree.map(jnp.asarray, bank)),
                 router=jr)
    teng = SoloEngine(deployment=ServingDeployment(lm, tp, max_seq=96,
                                        expert_bank=bridge.from_numpy(bank),
                                        device="cpu"), router=tr)
    for p in PROMPTS[:3]:
        assert teng.generate(p, 6) == jeng.generate(p, 6)
    with pytest.raises(ValueError, match="nothing gates it"):
        SoloEngine(deployment=teng.dep)


def test_solo_ssm_refuses_lora():
    """An SSM serves per-user adapters on its four SSM projections, as
    the dense SLM does: token for token the reference's
    (``test_torch_train_ssm.py`` also holds the slot kernel's path and a
    router-gated bank)."""
    model = _model("falcon-mamba-7b", 0)
    jeng, teng = _solos(model, 48, adapter_slots=2)
    ad = _adapter(model[0], 3)
    jeng.adapters.register("u0", jax.tree.map(jnp.asarray, ad))
    teng.adapters.register("u0", bridge.from_numpy(ad))
    out = {}
    for aid in ("u0", None):
        out[aid] = jeng.generate(PROMPTS[1], 6, adapter_id=aid)
        assert teng.generate(PROMPTS[1], 6, adapter_id=aid) == out[aid]
    assert out["u0"] != out[None]            # the adapter is at work
    assert teng.adapter_stats() == jeng.adapter_stats()


def test_solo_ssm_prompt_lengths_follow_the_chunk_rule():
    """A 129-token prompt (not cut: max_seq leaves room) is refused by
    both packages; 128 tokens are served alike."""
    jeng, teng = _solos(_model("falcon-mamba-7b", 0), 192)
    for n_bytes in (126, 127):       # + BOS + the trailing space
        p = "z" * n_bytes
        if n_bytes == 126:
            assert teng.generate(p, 4) == jeng.generate(p, 4)
            continue
        with pytest.raises(AssertionError):
            jeng.generate(p, 4)
        with pytest.raises(ValueError, match="chunk 128"):
            teng.generate(p, 4)


def test_engine_construction_errors():
    """HybridEngine and BatchedHybridEngine refuse an SLM-only
    deployment with the reference's error; the batched engine refuses an
    SSM member of a hybrid deployment."""
    dense, ssm = _model("floe-slm-2b", 0), _model("falcon-mamba-7b", 1)
    llm = _model("floe-llm-7b", 2)
    for jlm, jp, lm, tp in (dense, ssm):
        jdep = JDep(jlm, jp, max_seq=48)
        tdep = ServingDeployment(lm, tp, max_seq=48, device="cpu")
        for jcls, tcls in ((JEngine, HybridEngine),
                           (JBatched, BatchedHybridEngine)):
            with pytest.raises(ValueError, match="SoloEngine") as want:
                jcls(deployment=jdep)
            with pytest.raises(ValueError, match="SoloEngine") as got:
                tcls(deployment=tdep)
            assert str(got.value) == str(want.value)
    mlp = JFUS.init_alignment(jax.random.key(3), ssm[0].cfg.vocab_size)
    jdep = JDep(ssm[0], ssm[1], llm[0], llm[1], mlp, max_seq=48)
    tdep = ServingDeployment(ssm[2], ssm[3], llm[2], llm[3],
                             bridge.from_numpy(jax.device_get(mlp)),
                             max_seq=48, device="cpu")
    with pytest.raises(NotImplementedError, match="got ssm") as want:
        JBatched(deployment=jdep)
    with pytest.raises(NotImplementedError, match="got ssm") as got:
        BatchedHybridEngine(deployment=tdep)
    assert str(got.value) == str(want.value)


def test_ssm_entry_points_raise_without_a_card():
    """LM and ServingDeployment default to CUDA for the SSM too, and
    raise without a card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points run on it")
    cfg = tget_config("falcon-mamba-7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    lm = LM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SoloEngine(deployment=ServingDeployment(lm, lm.init(0), max_seq=48))
