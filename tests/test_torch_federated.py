"""The port's federated fine-tuning vs the JAX package's, on the CPU.

* bit for bit: ``_apply_rank``, the aggregator's numpy steps (E(φ),
  k-means, silhouette, the clustering) on the same adapters;
* ``LocalTrainer.run_round`` (5 steps, with and without DP): the losses
  and the trained adapter within tolerance;
* one round of ``run_simulation`` with ``tests/test_federated.py``'s
  SimConfig (4 clients, 32 examples, seq 40, batch 4, alpha 0.05, seed
  3): the same dropped count, ranks, cluster count and labels, experts
  within tolerance and equal router gates over the published bank;
* ``run_fedavg`` and ``run_local_only`` against the reference's;
* ``python -m repro_torch.launch.train --local --device cpu``.

The reduced floe-slm-2b in float32 from the reference's parameters
(bridged).  Tolerances: LOSS_TOL 1e-5 relative on losses.  A trained
adapter is held per leaf to ADAPTER_TOL = 1e-3 in relative Frobenius
norm, and each element to the 2 · lr · steps that Adam can move it:
Adam moves every element by about lr a step whatever its gradient's
size, so where a gradient element is near zero (it agrees with the
reference's only to about 1e-5 of the largest one) its update can take
the other sign (read: one element in 4,096 off by 0.12 lr after two
steps).  Cluster labels and ranks
must be equal: they come from host numpy on the adapters and from the
LUT."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import aggregator as JAGG
from repro.core import lora as JLORA
from repro.federated import client as JCLIENT
from repro.federated import simulation as JSIM
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.core import aggregator as AGG
from repro_torch.core import lora as LORA
from repro_torch.core import prng
from repro_torch.core import rank_select as RS
from repro_torch.core import tree as T
from repro_torch.federated import client as CLIENT
from repro_torch.federated import simulation as SIM
from repro_torch.models.model import LM
from _threads import one_thread  # noqa: F401

LOSS_TOL = 1e-5
ADAPTER_TOL = 1e-3
SIM_KW = dict(num_clients=4, examples_per_client=32, rounds=1,
              local_steps=5, seq_len=40, batch_size=4, alpha=0.05, seed=3)


def _body(ad):
    return {k: v for k, v in ad.items() if not k.startswith("_")}


def _close_tree(got, want, tol, steps):
    """Each leaf within ``tol`` in relative norm and every element within
    the 2 · lr · steps that ``steps`` Adam steps at lr 5e-3 can move it."""
    g, w = T.leaves(_body(got)), jax.tree.leaves(_body(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 5e-3 * steps)


@pytest.fixture(scope="module")
def models():
    cfg = get_config("floe-slm-2b").reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    return jlm, jparams, LM(cfg, device="cpu"), \
        bridge.from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def sims(models):
    jlm, jparams, lm, params = models
    return (SIM.run_simulation(lm, params, SIM.SimConfig(**SIM_KW)),
            JSIM.run_simulation(jlm, jparams, JSIM.SimConfig(**SIM_KW)))


def _random_adapter(jlm, seed, rank):
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=4))
    rng = np.random.default_rng(seed)
    for leaf in ad["layers"].values():
        leaf["B"] = rng.standard_normal(leaf["B"].shape).astype(np.float32)
    return JCLIENT._apply_rank(jax.tree.map(jnp.asarray, ad), rank)


def test_apply_rank_bit_exact(models):
    jlm, _, lm, _ = models
    for rank in (1, 2, 4):
        want = _random_adapter(jlm, rank, rank)
        got = CLIENT._apply_rank(bridge.from_numpy(jax.device_get(
            _random_adapter(jlm, rank, 4))), rank)
        assert int(got["_rank"]) == int(want["_rank"]) == rank
        for g, w in zip(T.leaves(_body(got)), jax.tree.leaves(_body(want))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_aggregation_steps_equal_the_reference(models):
    jlm, _, _, _ = models
    jads = [_random_adapter(jlm, s, (1, 2, 4, 4, 2)[s]) for s in range(5)]
    ads = [bridge.from_numpy(jax.device_get(a)) for a in jads]
    texts = [["math: compute 3 plus 4 ="], ["sort ascending: 4 2 9 1 ->"],
             None, ["math: compute 10 minus 2 ="], ["logic: true and false ="]]
    embs = np.stack([AGG.encode_module(a, t) for a, t in zip(ads, texts)])
    jembs = np.stack([JAGG.encode_module(a, t) for a, t in zip(jads, texts)])
    np.testing.assert_array_equal(embs, jembs)
    np.testing.assert_array_equal(AGG.encode_modules(ads, texts), jembs)
    assert AGG.similarity(embs[0], embs[3]) == \
        JAGG.similarity(jembs[0], jembs[3])
    for k in (2, 3):
        got, want = AGG.kmeans(embs, k, seed=1), JAGG.kmeans(jembs, k, seed=1)
        np.testing.assert_array_equal(got[0], want[0])
        assert AGG.silhouette_score(embs, got[0]) == \
            JAGG.silhouette_score(jembs, want[0])
    res = AGG.aggregate_clustered(ads, embs, staleness=[0, 1, 2, 0.5, 3])
    jres = JAGG.aggregate_clustered(jads, jembs,
                                    staleness=[0, 1, 2, 0.5, 3])
    np.testing.assert_array_equal(res.labels, jres.labels)
    assert (res.num_clusters, res.silhouette) == \
        (jres.num_clusters, jres.silhouette)
    for e, je in zip(res.experts, jres.experts):
        assert int(e["_rank"]) == int(je["_rank"])
        for g, w in zip(T.leaves(_body(e)), jax.tree.leaves(_body(je))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    late = AGG.async_update_cluster(ads[0], ads[1], 1.5)
    jlate = JAGG.async_update_cluster(jads[0], jads[1], 1.5)
    for g, w in zip(T.leaves(_body(late)), jax.tree.leaves(_body(jlate))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert LORA.count_params(ads[0]) == JLORA.count_params(jads[0])


@pytest.mark.parametrize("dp", [None, (1.0, 0.5)])
def test_run_round_matches_reference(models, dp):
    jlm, jparams, lm, params = models
    clip, noise = dp or (None, 0.0)
    sim = SIM.SimConfig(**SIM_KW)
    fleet, jfleet = SIM.make_fleet(sim), JSIM.make_fleet(
        JSIM.SimConfig(**SIM_KW))
    lut = RS.build_lut(lm.cfg, tokens_per_step=160)
    from repro.core import rank_select as JRS
    jlut = JRS.build_lut(jlm.cfg, tokens_per_step=160)
    trainer = CLIENT.LocalTrainer(lm, 40, 4, 5e-3, 5, clip, noise)
    jtrainer = JCLIENT.LocalTrainer(jlm, 40, 4, 5e-3, 5, clip, noise)
    base = LORA.init_adapter_keyed(lm, prng.key(3), rank=4)
    jbase = JLORA.init_adapter(jlm, jax.random.key(3), rank=4)
    upd = trainer.run_round(fleet[0], params, base, lut, 1e9, 300)
    jupd = jtrainer.run_round(jfleet[0], jparams, jbase, jlut, 1e9, 300)
    assert upd.rank == jupd.rank and upd.task_samples == jupd.task_samples
    assert upd.train_seconds == jupd.train_seconds
    np.testing.assert_allclose(upd.local_loss, jupd.local_loss,
                               rtol=LOSS_TOL)
    _close_tree(upd.adapter, jupd.adapter, ADAPTER_TOL, 5)


def test_simulation_round_matches_reference(sims):
    res, jres = sims
    assert res.dropped_per_round == jres.dropped_per_round
    assert [[u.cid for u in ups] for ups in res.updates_per_round] == \
        [[u.cid for u in ups] for ups in jres.updates_per_round]
    assert [[u.rank for u in ups] for ups in res.updates_per_round] == \
        [[u.rank for u in ups] for ups in jres.updates_per_round]
    for u, ju in zip(res.updates_per_round[0], jres.updates_per_round[0]):
        np.testing.assert_allclose(u.local_loss, ju.local_loss,
                                   rtol=LOSS_TOL)
    h, jh = res.server.state.history[-1], jres.server.state.history[-1]
    assert (h["clients"], h["clusters"], h["mean_rank"]) == \
        (jh["clients"], jh["clusters"], jh["mean_rank"])
    np.testing.assert_allclose(h["silhouette"], jh["silhouette"], rtol=1e-5)
    np.testing.assert_allclose(h["mean_loss"], jh["mean_loss"],
                               rtol=LOSS_TOL)
    assert res.server.state.expert_tasks == jres.server.state.expert_tasks
    for e, je in zip(res.server.state.experts, jres.server.state.experts):
        assert int(e["_rank"]) == int(je["_rank"])
        _close_tree(e, je, ADAPTER_TOL, 5)
    bank, jbank = res.server.expert_bank(), jres.server.expert_bank()
    np.testing.assert_array_equal(bank["_ranks"].numpy(),
                                  np.asarray(jbank["_ranks"]))
    router, jrouter = res.server.router(), jres.server.router()
    assert [m.name for m in router.experts] == \
        [m.name for m in jrouter.experts]
    prompts = ["math: compute 3 plus 4 =", "sort ascending: 9 3 ->",
               "translate to french: cat ->"]
    np.testing.assert_array_equal(router.gate_weights_batch(prompts),
                                  jrouter.gate_weights_batch(prompts))


def test_published_bank_serves_through_the_model(models, sims):
    """The published bank and its router gates run through the port's
    prefill (CPU plain path): finite logits, changed by the experts."""
    _, _, lm, params = models
    res, _ = sims
    bank = LORA.bank_for_model(res.server.expert_bank())
    gates = torch.from_numpy(res.server.router().gate_weights_batch(
        ["math: compute 3 plus 4 ="]))
    tokens = torch.arange(3, 15)[None]
    plain, _ = lm.prefill(params, tokens, 16)
    routed, _ = lm.prefill(params, tokens, 16, lora=bank, gates=gates)
    assert torch.isfinite(routed).all() and not torch.equal(plain, routed)


def test_fedavg_and_local_only_match_reference(models):
    jlm, jparams, lm, params = models
    kw = dict(SIM_KW, num_clients=3, local_steps=2)
    got = SIM.run_fedavg(lm, params, SIM.SimConfig(**kw))
    want = JSIM.run_fedavg(jlm, jparams, JSIM.SimConfig(**kw))
    assert int(got["_rank"]) == int(want["_rank"])
    _close_tree(got, want, ADAPTER_TOL, 2)
    got = SIM.run_local_only(lm, params, SIM.SimConfig(**kw))
    want = JSIM.run_local_only(jlm, jparams, JSIM.SimConfig(**kw))
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is not None:
            _close_tree(g, w, ADAPTER_TOL, 2)


def test_train_launcher_runs_on_cpu(capsys):
    """``--local --device cpu`` prints the reference launcher's history
    (its parameters are the reference's ``lm.init(jax.random.key(0))``):
    clients, clusters, ranks and dropped equal, the loss and silhouette
    within LOSS_TOL."""
    from repro_torch.launch import train
    res = train.main(["--local", "--device", "cpu", "--rounds", "1",
                      "--clients", "3"])
    out = capsys.readouterr().out.splitlines()
    jlm = JLM(get_config("floe-slm-2b").reduced(), remat=False)
    jres = JSIM.run_simulation(jlm, jlm.init(jax.random.key(0)),
                               JSIM.SimConfig(num_clients=3, rounds=1))
    h, jh = res.server.state.history[0], jres.server.state.history[0]
    assert out[0] == f"round 0: {h}"
    assert out[-1] == (f"experts: {h['clusters']}, dropped: "
                       f"{res.dropped_per_round}")
    assert res.server.state.experts
    assert res.dropped_per_round == jres.dropped_per_round
    for k in ("clients", "clusters", "mean_rank"):
        assert h[k] == jh[k]
    for k in ("mean_loss", "silhouette"):
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_TOL)
    with pytest.raises(NotImplementedError, match="item 10"):
        train.main([])
