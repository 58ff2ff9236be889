"""The port's MoE training vs the JAX package's, on the CPU: the reduced
granite-moe (d 256, H 4 / KV 2 / head_dim 32, 4 experts with top-2
routing, expert FFN 128, vocab 512, 2 layers) in float32, the
reference's parameters bridged, inputs from numpy seeds, at the reduced
config's capacity factor 8.0 (no drops) and at the full config's 1.25
(a 4 × 40 batch drops assignments).

* Algorithm 1's LUT over the full-width granite-moe-3b-a800m's LoRA
  layout (q, k, v, o on 32 layers) equal to the reference's;
* the LoRA loss (the aux term at 0.01 included) and every leaf's
  gradient against ``jax.value_and_grad``, also with a dense first layer
  and a shared expert (its mlp_in/mlp_out targets);
* a LoRA train step and a full train step (the router's, w_in's and
  w_out's gradients among them: the router's reaches it through the aux
  loss and the renormalised probabilities);
* one ``run_simulation`` round and ``launch/train.py --arch
  granite-moe-3b-a800m`` against the reference's.

Tolerances as ``test_torch_train_zamba2.py`` states them: LOSS_TOL 1e-5
on losses, GRAD_TOL 2e-4 on gradients, relative to the largest
reference magnitude; a step's update within UPDATE_TOL of the
reference's in relative norm a leaf and every element within the 2 · lr
that Adam can move it.
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
from repro.models.model import LM as JLM
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.data import pipeline as PIPE
from repro_torch.federated import simulation as SIM
from repro_torch.models import moe as MOE
from repro_torch.models.model import LM
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from _threads import one_thread  # noqa: F401

ARCH = "granite-moe-3b-a800m"
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
UPDATE_TOL = 1e-2
SIM_KW = dict(num_clients=3, examples_per_client=16, rounds=1,
              local_steps=3, seq_len=40, batch_size=4, alpha=0.05, seed=3)


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
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _close_tree(got, want, tol):
    g, w = T.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, tol)


def _updates_close(new, old, want, lr):
    """One step's update (new - old) against the reference's (want -
    old): UPDATE_TOL in relative norm a leaf, every element within 2 ·
    lr."""
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


_MODELS = {}


def _models(cf=8.0, kd=0, shared=0):
    key = (cf, kd, shared)
    if key not in _MODELS:
        jcfg, cfg = _cfgs(*key)
        jlm = JLM(jcfg, remat=False)
        jparams = jlm.init(jax.random.key(0))
        _MODELS[key] = (jlm, jparams, LM(cfg, device="cpu"),
                        bridge.from_numpy(jax.device_get(jparams)))
    return _MODELS[key]


def _batch(seed, seq, bs=4):
    return JPIPE.make_batch(make_mixed_dataset(list(TASKS), bs, seed), seq)


def _bank_pair(jlm, seeds, scale=0.3):
    """Reference adapters with random B (``init_adapter`` zeroes B),
    stacked in both packages."""
    ads = []
    for seed in seeds:
        ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                               rank=4))
        rng = np.random.default_rng(seed)
        for stack in (k for k in ad if not k.startswith("_")):
            for leaf in ad[stack].values():
                leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                             ).astype(np.float32)
        ads.append(ad)
    jbank = JLORA.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads])
    bank = LORA.stack_adapters([bridge.from_numpy(a) for a in ads])
    return jbank, bank


def _body(bank):
    return {k: v for k, v in bank.items() if not k.startswith("_")}


def test_rank_selection_lut_equals_reference_at_full_width():
    """Algorithm 1's LUT over granite-moe-3b-a800m's LoRA layout (q, k,
    v, o on 32 MoE layers) and its base count (the 40 experts' FFNs):
    equal to the reference's entry for entry, and so every client's
    rank."""
    from repro.core import rank_select as JRS
    from repro_torch.core import rank_select as RS
    got = RS.build_lut(tget_config(ARCH), tokens_per_step=160)
    want = JRS.build_lut(get_config(ARCH), tokens_per_step=160)
    assert got.mem == want.mem and got.lat == want.lat
    assert RS.lora_params(tget_config(ARCH), 16) == \
        JRS.lora_params(get_config(ARCH), 16) == 16 * 32 * (
            2 * (1536 + 1536) + 2 * (1536 + 512))
    for dev in RS.DEVICE_CLASSES:
        for deadline in (0.01, 0.1, 1.0):
            mem = dev.memory_gb * 1e9
            assert RS.select_rank(RS.DEFAULT_RANKS, mem, deadline, got,
                                  dev.name) == \
                JRS.select_rank(JRS.DEFAULT_RANKS, mem, deadline, want,
                                dev.name)


@pytest.mark.parametrize("cf,kd,shared", [(8.0, 0, 0), (1.25, 0, 0),
                                          (1.25, 1, 1)])
def test_lora_loss_and_grads_match_value_and_grad(cf, kd, shared):
    """The loss (aux at 0.01 included) within LOSS_TOL and every LoRA
    leaf's gradient within GRAD_TOL of ``jax.value_and_grad``, at a 4 x
    40 batch (drops at cf 1.25); with a dense first layer and a shared
    expert, the ``dense_layers`` stack and the shared expert's targets
    among the leaves."""
    jlm, jparams, lm, params = _models(cf, kd, shared)
    b = _batch(41, 40)
    jbank, bank = _bank_pair(jlm, (6,))
    gates = np.ones(1, np.float32)
    jbody = JLORA.bank_for_model(jbank)

    def jloss(tr):
        return JTS.lora_loss_fn(jlm, jparams, {**tr, "_ranks":
                                               jbank["_ranks"]},
                                jax.tree.map(jnp.asarray, b),
                                jnp.asarray(gates))
    wl, wg = jax.jit(jax.value_and_grad(jloss))(_body(jbody))
    tbody = LORA.bank_for_model(bank)

    def tloss(tr):
        return TS.lora_loss_fn(lm, params, {**tr, "_ranks": bank["_ranks"]},
                               PIPE.to_torch(b, "cpu"),
                               torch.from_numpy(gates))
    with MOE.record_drops() as drops:
        loss, grads = TS.value_and_grad(tloss, _body(tbody))
    assert (sum(int(d) for d in drops) > 0) == (cf == 1.25)
    assert sorted(grads) == sorted(["layers"] + ["dense_layers"] * bool(kd))
    assert ("mlp_in" in grads["layers"]) == bool(shared)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)


def test_lora_train_step_matches_reference():
    jlm, jparams, lm, params = _models(1.25)
    b = _batch(3, 40)
    jbank, bank = _bank_pair(jlm, (8,))
    jopt = JOPT.adamw(JOPT.constant_schedule(5e-3))
    opt = OPT.adamw(OPT.constant_schedule(5e-3))
    jb, _, wl = JTS.make_lora_train_step(jlm, jopt)(
        jparams, jbank, jopt.init(_body(jbank)),
        jax.tree.map(jnp.asarray, b), jnp.ones((1,)), None)
    tb, _, l = TS.make_lora_train_step(lm, opt)(
        params, bank, opt.init(_body(bank)), PIPE.to_torch(b, "cpu"),
        torch.ones(1))
    _close(l, wl, LOSS_TOL)
    _updates_close(_body(tb), _body(bank), _body(jb), 5e-3)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_full_train_step_matches_reference(cf):
    """Every parameter's gradient within GRAD_TOL (the router's, the
    experts' w_in and w_out among them, all nonzero), the aux loss's
    share of the loss's included; then one AdamW step against the
    reference's."""
    jlm, jparams, lm, params = _models(cf)
    b = _batch(4, 40)
    jb = jax.tree.map(jnp.asarray, b)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p: JTS.full_loss_fn(jlm, p, jb)))(jparams)
    loss, grads = TS.value_and_grad(
        lambda p: TS.full_loss_fn(lm, p, PIPE.to_torch(b, "cpu")), params)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    moe = grads["layers"]["moe"]
    for leaf in (moe["router"]["w"], moe["w_in"]["w"], moe["w_out"]["w"]):
        assert leaf.abs().max() > 0
    # the aux term alone reaches the router
    _, g_aux = TS.value_and_grad(
        lambda p: lm.train_logits(
            p, {"tokens": PIPE.to_torch(b, "cpu")["tokens"]})[1], params)
    assert g_aux["layers"]["moe"]["router"]["w"].abs().max() > 0
    jopt = JOPT.adamw(JOPT.constant_schedule(1e-3))
    opt = OPT.adamw(OPT.constant_schedule(1e-3))
    jp, _, wl = JTS.make_full_train_step(jlm, jopt)(
        jparams, jopt.init(jparams), jb)
    tp, _, l = TS.make_full_train_step(lm, opt)(
        params, opt.init(params), PIPE.to_torch(b, "cpu"))
    _close(l, wl, LOSS_TOL)
    _updates_close(tp, params, jp, 1e-3)


def test_simulation_round_matches_reference():
    jlm, jparams, lm, params = _models(1.25)
    res = SIM.run_simulation(lm, params, SIM.SimConfig(**SIM_KW))
    jres = JSIM.run_simulation(jlm, jparams, JSIM.SimConfig(**SIM_KW))
    assert res.dropped_per_round == jres.dropped_per_round
    assert [[(u.cid, u.rank) for u in ups] for ups in res.updates_per_round] \
        == [[(u.cid, u.rank) for u in ups] for ups in jres.updates_per_round]
    assert res.updates_per_round[0]
    for u, ju in zip(res.updates_per_round[0], jres.updates_per_round[0]):
        np.testing.assert_allclose(u.local_loss, ju.local_loss,
                                   rtol=LOSS_TOL)
    h, jh = res.server.state.history[-1], jres.server.state.history[-1]
    assert (h["clients"], h["clusters"], h["mean_rank"]) == \
        (jh["clients"], jh["clusters"], jh["mean_rank"])
    np.testing.assert_allclose(h["mean_loss"], jh["mean_loss"],
                               rtol=LOSS_TOL)
    assert res.server.state.expert_tasks == jres.server.state.expert_tasks


def test_train_launcher_matches_reference(capsys):
    """``--arch granite-moe-3b-a800m --local --device cpu`` prints the
    reference launcher's history: clients, clusters, ranks and dropped
    equal, the losses and silhouette within LOSS_TOL."""
    from repro_torch.launch import train
    res = train.main(["--local", "--device", "cpu", "--rounds", "1",
                      "--clients", "2", "--arch", ARCH])
    out = capsys.readouterr().out.splitlines()
    jlm = JLM(get_config(ARCH).reduced(), remat=False)
    jres = JSIM.run_simulation(jlm, jlm.init(jax.random.key(0)),
                               JSIM.SimConfig(num_clients=2, rounds=1))
    h, jh = res.server.state.history[0], jres.server.state.history[0]
    assert out[0] == f"round 0: {h}"
    assert out[-1] == (f"experts: {h['clusters']}, dropped: "
                       f"{res.dropped_per_round}")
    assert res.dropped_per_round == jres.dropped_per_round
    for k in ("clients", "clusters", "mean_rank"):
        assert h[k] == jh[k]
    for k in ("mean_loss", "silhouette"):
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_TOL)
