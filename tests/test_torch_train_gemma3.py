"""The port's training of the grouped gemma3 SLM vs the JAX package's, on
the CPU.

* ``LM.train_logits`` at S 24 and 40 (past the reduced window of 16),
  with and without a LoRA bank;
* the LoRA loss and every inner / special / tail leaf's gradient against
  ``jax.value_and_grad(lora_loss_fn)``, without and under a rank mask;
* one LoRA and one full-parameter train step;
* K8's windowed plain backward against autograd of K3's windowed plain
  version and against ``jax.vjp`` of ``chunked_causal_attention(window=
  16)``;
* one ``run_simulation`` round, held as ``test_torch_federated.py``
  holds the 2b SLM's, and ``launch/train.py --arch floe-slm-gemma3``
  against the reference launcher.

The reduced floe-slm-gemma3 in float32 with three layers (one group of
a local and a global layer, then a local tail layer, so every stack of
the grouped layout holds a layer), the reference's parameters bridged;
the simulation and the launcher run the launcher's two-layer config.
Tolerances as ``test_torch_train.py`` states them: LOSS_TOL 1e-5 on
logits and losses, GRAD_TOL 2e-4 on gradients, relative to the
largest reference magnitude; K8's plain backward 1e-5.  A step's
update: the full step's within UPDATE_TOL 1e-2 of the reference's in
relative norm a leaf (UPDATE_TOL states why) and each parameter within
2 · lr; a trained adapter (the LoRA step's, the simulation's)
as ``test_torch_federated.py`` holds one: 1e-3 in relative norm a leaf
and every element within the 2 · lr · steps that Adam can move it (one
element of 2,048 read 2.3e-4 off after one step at lr 5e-3, where its
gradient is near zero and its update takes the other sign).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import lora as JLORA
from repro.data import pipeline as JPIPE
from repro.data.tasks import TASKS, make_mixed_dataset
from repro.federated import simulation as JSIM
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.data import pipeline as PIPE
from repro_torch.federated import simulation as SIM
from repro_torch.kernels.flash_attention import kernel as K3
from repro_torch.models.model import LM
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from _threads import one_thread  # noqa: F401

ARCH = "floe-slm-gemma3"
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
# a step's update against the reference's, per leaf in relative norm.
# Adam's first step moves an element by lr · g / (|g| + eps), about lr
# whatever |g|; an element whose gradient lies within GRAD_TOL of the
# leaf's largest from zero can move up to 2 · lr apart, and one such
# element in a leaf of n reads up to 2 / sqrt(n).  Read 3.2e-3 at most
# (a leaf of 4,096 with one element 0.21 lr apart); a step that moves
# nothing reads 1, one the wrong way 2
UPDATE_TOL = 1e-2
SIM_KW = dict(num_clients=4, examples_per_client=32, rounds=1,
              local_steps=5, seq_len=40, batch_size=4, alpha=0.05, seed=3)


def _close(got, want, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if want.size == 0:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _close_tree(got, want, tol):
    g, w = T.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, tol)


def _updates_close(new, old, want, lr):
    """One step's update (new - old) against the reference's (want -
    old): UPDATE_TOL in relative norm a leaf, and every element within
    the 2 · lr that Adam can move it (an element whose gradient is near
    zero may move the other way)."""
    n, o, w = T.leaves(new), T.leaves(old), jax.tree.leaves(want)
    assert len(n) == len(o) == len(w)
    for a, b, c in zip(n, o, w):
        a = a.detach().float().numpy()
        b = b.detach().float().numpy()
        c = np.asarray(c, np.float32)
        up, ref = a - b, c - b
        assert np.linalg.norm(up - ref) <= UPDATE_TOL * max(
            np.linalg.norm(ref), 1e-30)
        np.testing.assert_allclose(a, c, rtol=0, atol=2 * lr)


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=3)
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(), num_layers=3)
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    lm = LM(tcfg, device="cpu")
    assert [len(d) for d, _ in lm.lora_layout().values()] == [2, 1, 1]
    return jlm, jparams, lm, bridge.from_numpy(jax.device_get(jparams))


def _batch(seed, seq, bs=4):
    return JPIPE.make_batch(make_mixed_dataset(list(TASKS), bs, seed), seq)


def _bank_pair(jlm, seed, ranks=None):
    """A reference adapter with random B, as a one-expert bank in both
    packages; with ``ranks`` a rank mask on every leaf."""
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=4))
    rng = np.random.default_rng(seed)
    for st in (v for k, v in ad.items() if not k.startswith("_")):
        for leaf in st.values():
            leaf["B"] = (0.3 * rng.standard_normal(leaf["B"].shape)
                         ).astype(np.float32)
    jbank = JLORA.single_expert_bank(jax.tree.map(jnp.asarray, ad))
    bank = LORA.single_expert_bank(bridge.from_numpy(ad))
    if ranks is not None:
        r_max = jlm.cfg.lora_rank_max
        for stack, (dims, _) in jlm.lora_layout().items():
            m = np.broadcast_to(np.asarray(JLORA.rank_mask(ranks, r_max)),
                                dims + (len(ranks), r_max))
            for tgt in jbank[stack]:
                jbank[stack][tgt]["rank_mask"] = jnp.asarray(m)
                bank[stack][tgt]["rank_mask"] = torch.from_numpy(m.copy())
    return jbank, bank


@pytest.mark.parametrize("seq", [24, 40])
def test_train_logits_match_reference(models, seq):
    jlm, jparams, lm, params = models
    b = _batch(seq, seq)
    jbank, bank = _bank_pair(jlm, 4)
    for lora, gates in ((None, None), ("bank", np.ones(1, np.float32)),
                        ("bank", np.full((4, 1), 0.5, np.float32))):
        want, _ = jlm.train_logits(
            jparams, {"tokens": jnp.asarray(b["tokens"])},
            lora=None if lora is None else JLORA.bank_for_model(jbank),
            gates=None if gates is None else jnp.asarray(gates))
        got, aux = lm.train_logits(
            params, {"tokens": torch.from_numpy(b["tokens"]).long()},
            lora=None if lora is None else LORA.bank_for_model(bank),
            gates=None if gates is None else torch.from_numpy(gates))
        assert got.dtype == torch.float32 and float(aux) == 0.0
        _close(got, want, LOSS_TOL)


@pytest.mark.parametrize("seq", [24, 40])
@pytest.mark.parametrize("ranks", [None, [2]])
def test_lora_loss_and_grads_match_value_and_grad(models, ranks, seq):
    jlm, jparams, lm, params = models
    b = _batch(2 + seq, seq)
    jbank, bank = _bank_pair(jlm, 6, ranks)
    gates = np.ones(1, np.float32)
    body = JLORA.bank_for_model(jbank)
    trainable = {s: {t: {k: v for k, v in ab.items() if k in ("A", "B")}
                     for t, ab in st.items()} for s, st in body.items()}

    def jloss(tr):
        full = {s: {t: {**tr[s][t], **{k: v for k, v in body[s][t].items()
                                        if k == "rank_mask"}}
                    for t in tr[s]} for s in tr}
        return JTS.lora_loss_fn(jlm, jparams, {**full, "_ranks":
                                               jbank["_ranks"]},
                                jax.tree.map(jnp.asarray, b),
                                jnp.asarray(gates))
    wl, wg = jax.value_and_grad(jloss)(trainable)

    tbody = LORA.bank_for_model(bank)
    tr = {s: {t: {k: v for k, v in ab.items() if k in ("A", "B")}
              for t, ab in st.items()} for s, st in tbody.items()}

    def tloss(leaves):
        full = {s: {t: {**leaves[s][t], **{k: v for k, v in ab.items()
                                           if k == "rank_mask"}}
                    for t, ab in st.items()} for s, st in tbody.items()}
        return TS.lora_loss_fn(lm, params, {**full, "_ranks": bank["_ranks"]},
                               PIPE.to_torch(b, "cpu"),
                               torch.from_numpy(gates))
    loss, grads = TS.value_and_grad(tloss, tr)
    _close(loss, wl, LOSS_TOL)
    assert sorted(grads) == ["inner", "special", "tail"]
    _close_tree(grads, wg, GRAD_TOL)
    if ranks is not None:
        # a masked rank's A rows and B columns take no gradient
        for st in grads.values():
            for ab in st.values():
                assert not ab["A"][..., ranks[0]:, :].any()
                assert not ab["B"][..., ranks[0]:].any()


def test_lora_train_step_matches_reference(models):
    jlm, jparams, lm, params = models
    b = _batch(3, 40)
    jbank, bank = _bank_pair(jlm, 8)
    jopt = JOPT.adamw(JOPT.constant_schedule(5e-3))
    opt = OPT.adamw(OPT.constant_schedule(5e-3))
    body = lambda bk: {k: v for k, v in bk.items() if not k.startswith("_")}
    jb, _, wl = JTS.make_lora_train_step(jlm, jopt)(
        jparams, jbank, jopt.init(body(jbank)), jax.tree.map(jnp.asarray, b),
        jnp.ones((1,)), None)
    tb, _, l = TS.make_lora_train_step(lm, opt)(
        params, bank, opt.init(body(bank)), PIPE.to_torch(b, "cpu"),
        torch.ones(1))
    _close(l, wl, LOSS_TOL)
    # Adam moves an element by about lr whatever its gradient's size, so
    # one whose gradient is near zero may move the other way
    _adapters_close(tb, jb, 1)


def test_full_train_step_matches_reference(models):
    """Every parameter's gradient within GRAD_TOL of the reference's (the
    qk-norm scales and every stack's leaves), then one AdamW step: each
    element within the 2 · lr that Adam can move it, the update within
    UPDATE_TOL of the reference's."""
    jlm, jparams, lm, params = models
    b = _batch(4, 40)
    jb = jax.tree.map(jnp.asarray, b)
    wl, wg = jax.value_and_grad(
        lambda p: JTS.full_loss_fn(jlm, p, jb))(jparams)
    loss, grads = TS.value_and_grad(
        lambda p: TS.full_loss_fn(lm, p, PIPE.to_torch(b, "cpu")), params)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    jopt = JOPT.adamw(JOPT.constant_schedule(1e-3))
    opt = OPT.adamw(OPT.constant_schedule(1e-3))
    jp, _, wl = JTS.make_full_train_step(jlm, jopt)(
        jparams, jopt.init(jparams), jb)
    tp, _, l = TS.make_full_train_step(lm, opt)(
        params, opt.init(params), PIPE.to_torch(b, "cpu"))
    _close(l, wl, LOSS_TOL)
    _updates_close(tp, params, jp, 1e-3)


@pytest.mark.parametrize("b,h,kvh,s,window", [(2, 4, 1, 40, 16),
                                              (1, 4, 2, 33, 7),
                                              (1, 2, 1, 12, 16)])
def test_k8_windowed_plain_equals_autograd_and_reference_vjp(b, h, kvh, s,
                                                             window):
    d = 16
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = K3.flash_attention_plain(tq, tk, tv, window=window)
    ag = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    o, lse = K3.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                window=window, return_lse=True)
    got = K3.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 o, torch.from_numpy(do), lse, window=window)
    for g, w in zip(got, ag):
        _close(g, w.numpy(), 1e-5)
    pos = jnp.arange(s)
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda a, c, e: JATT.chunked_causal_attention(
        a, c, e, pos, pos, window), tr(q), tr(k), tr(v))
    for g, w in zip(got, vjp(tr(do))):
        _close(g, np.asarray(w).transpose(0, 2, 1, 3), 1e-5)


def test_windowed_train_attention_differs_from_causal(models):
    """The local layers train within their window: at S 40 the logits
    differ from a model whose layers all attend causally."""
    _, _, lm, params = models
    toks = torch.from_numpy(_batch(9, 40)["tokens"]).long()
    got, _ = lm.train_logits(params, {"tokens": toks})
    wide = LM(dataclasses.replace(lm.cfg, sliding_window=64), device="cpu")
    other, _ = wide.train_logits(params, {"tokens": toks})
    assert torch.equal(got[:, :16], other[:, :16])
    assert not torch.allclose(got[:, 16:], other[:, 16:])


@pytest.fixture(scope="module")
def sims():
    cfg = get_config(ARCH).reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    lm = LM(tget_config(ARCH).reduced(), device="cpu")
    params = bridge.from_numpy(jax.device_get(jparams))
    return (SIM.run_simulation(lm, params, SIM.SimConfig(**SIM_KW)),
            JSIM.run_simulation(jlm, jparams, JSIM.SimConfig(**SIM_KW)))


def _adapters_close(got, want, steps):
    """Each leaf within 1e-3 in relative norm and every element within
    the 2 · lr · steps that Adam can move it (``test_torch_federated.py``
    states why)."""
    body = lambda ad: {k: v for k, v in ad.items() if not k.startswith("_")}
    g, w = T.leaves(body(got)), jax.tree.leaves(body(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert np.linalg.norm(a - b) <= 1e-3 * max(np.linalg.norm(b), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 5e-3 * steps)


def test_simulation_round_matches_reference(sims):
    res, jres = sims
    assert res.dropped_per_round == jres.dropped_per_round
    assert [[(u.cid, u.rank) for u in ups] for ups in res.updates_per_round] \
        == [[(u.cid, u.rank) for u in ups] for ups in jres.updates_per_round]
    for u, ju in zip(res.updates_per_round[0], jres.updates_per_round[0]):
        np.testing.assert_allclose(u.local_loss, ju.local_loss,
                                   rtol=LOSS_TOL)
        _adapters_close(u.adapter, ju.adapter, 5)
    h, jh = res.server.state.history[-1], jres.server.state.history[-1]
    assert (h["clients"], h["clusters"], h["mean_rank"]) == \
        (jh["clients"], jh["clusters"], jh["mean_rank"])
    np.testing.assert_allclose(h["silhouette"], jh["silhouette"], rtol=1e-5)
    np.testing.assert_allclose(h["mean_loss"], jh["mean_loss"],
                               rtol=LOSS_TOL)
    assert res.server.state.expert_tasks == jres.server.state.expert_tasks
    for e, je in zip(res.server.state.experts, jres.server.state.experts):
        assert int(e["_rank"]) == int(je["_rank"])
        _adapters_close(e, je, 5)


def test_published_bank_serves_through_the_model(sims):
    """The published bank and its router gates run through the port's
    gemma3 prefill past the window: finite logits, moved by the
    experts."""
    res, _ = sims
    lm = LM(tget_config(ARCH).reduced(), device="cpu")
    params = lm.init_keyed(0)
    bank = LORA.bank_for_model(res.server.expert_bank())
    gates = torch.from_numpy(res.server.router().gate_weights_batch(
        ["math: compute 3 plus 4 ="]))
    tokens = torch.arange(3, 27)[None]
    plain, _ = lm.prefill(params, tokens, 32)
    routed, _ = lm.prefill(params, tokens, 32, lora=bank, gates=gates)
    assert torch.isfinite(routed).all() and not torch.equal(plain, routed)


def test_train_launcher_matches_reference(capsys):
    """``--arch floe-slm-gemma3 --local --device cpu`` prints the
    reference launcher's history: clients, clusters, ranks and dropped
    equal, the losses and silhouette within LOSS_TOL."""
    from repro_torch.launch import train
    res = train.main(["--local", "--device", "cpu", "--rounds", "1",
                      "--clients", "3", "--arch", ARCH])
    out = capsys.readouterr().out.splitlines()
    cfg = get_config(ARCH).reduced()
    jlm = JLM(cfg, remat=False)
    jres = JSIM.run_simulation(jlm, jlm.init(jax.random.key(0)),
                               JSIM.SimConfig(num_clients=3, rounds=1))
    h, jh = res.server.state.history[0], jres.server.state.history[0]
    assert out[0] == f"round 0: {h}"
    assert out[-1] == (f"experts: {h['clusters']}, dropped: "
                       f"{res.dropped_per_round}")
    assert res.dropped_per_round == jres.dropped_per_round
    for k in ("clients", "clusters", "mean_rank"):
        assert h[k] == jh[k]
    for k in ("mean_loss", "silhouette"):
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_TOL)
