"""The port's training substrate vs the JAX package's, on the CPU.

* bit for bit: data batches (``data/pipeline.py``), the rank-selection
  LUT and Algorithm 1, ``prng.split`` and the array ``prng.normal``,
  the threefry ``init_adapter_keyed``, the DP noise of ``privatize``,
  and a checkpoint written by one package and restored by the other;
* within tolerance: ``LM.train_logits``, the LoRA loss and its per-leaf
  gradients against ``jax.value_and_grad(lora_loss_fn)`` (also under a
  ``rank_mask``), one ``adamw`` and one ``adafactor`` update on the same
  gradients, a full-parameter step, ``train_alignment``'s losses,
  ``eval_accuracy``; K8's and K9's plain versions against autograd of
  the forward they differentiate and against the reference's VJP.

The reduced floe-slm-2b in float32; inputs from numpy seeds.  Tolerances
(relative to the largest reference magnitude unless stated): 1e-5 on
logits and losses and 2e-4 on gradients — the same f32 arithmetic summed
in another order through a 2-layer model, the gradients through one more
pass of it (read at about 1e-5 and 3e-5 here); 1e-6 on an optimizer
update (elementwise f32 maths on equal inputs, XLA's pow and rsqrt
against torch's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import dp as JDP
from repro.core import fusion as JFUS
from repro.core import lora as JLORA
from repro.core import rank_select as JRS
from repro.data import pipeline as JPIPE
from repro.data.tasks import TASKS, make_mixed_dataset
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro.training import checkpoint as JCKPT
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.core import dp as DP
from repro_torch.core import fusion as FUS
from repro_torch.core import lora as LORA
from repro_torch.core import prng
from repro_torch.core import rank_select as RS
from repro_torch.core import tree as T
from repro_torch.data import pipeline as PIPE
from repro_torch.data import tasks as TASKS_T
from repro_torch.kernels.flash_attention import kernel as K3
from repro_torch.kernels.moe_lora import kernel as KL
from repro_torch.models import layers as L
from repro_torch.models.model import LM
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from _threads import one_thread  # noqa: F401

LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
OPT_TOL = 1e-6
SEQ = 24


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


@pytest.fixture(scope="module")
def models():
    cfg = get_config("floe-slm-2b").reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    return jlm, jparams, LM(cfg, device="cpu"), \
        bridge.from_numpy(jax.device_get(jparams))


def _dataset(n=16, seed=0):
    return make_mixed_dataset(list(TASKS), n, seed)


def _batch(seed, bs=4):
    return JPIPE.make_batch(_dataset(bs, seed), SEQ)


def _trained_adapter(jlm, seed, rank=4, scale=0.3):
    """A reference adapter with random B (init_adapter zeroes B), so A and
    B both carry a gradient."""
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=rank))
    rng = np.random.default_rng(seed)
    for leaf in ad["layers"].values():
        leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                     ).astype(np.float32)
    return ad


@pytest.mark.parametrize("arch", ["floe-slm-2b", "floe-slm-gemma3",
                                  "falcon-mamba-7b"])
def test_init_keyed_equals_reference_init_bit_for_bit(arch):
    """``LM.init_keyed(seed)`` is the reference's ``lm.init(jax.random.
    key(seed))`` leaf for leaf, bit for bit, on the reduced configs."""
    from repro_torch.configs import get_config as tget
    want = jax.device_get(JLM(get_config(arch).reduced(),
                              remat=False).init(jax.random.key(3)))
    got = LM(tget(arch).reduced(), device="cpu").init_keyed(3)
    g, w = T.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_equal_the_reference_bit_for_bit(seed):
    from repro.data import partition as JPART
    from repro.data import tasks as JTASKS
    from repro_torch.data import partition as PART
    fields = lambda exs: [(e.prompt, e.answer, e.task) for e in exs]
    assert fields(TASKS_T.make_dataset("sorting", 8, seed)) == \
        fields(JTASKS.make_dataset("sorting", 8, seed))
    assert fields(TASKS_T.make_mixed_dataset(list(TASKS), 30, seed)) == \
        fields(make_mixed_dataset(list(TASKS), 30, seed))
    for g, w in zip(PART.partition_clients(4, list(TASKS), 16, 0.05, seed),
                    JPART.partition_clients(4, list(TASKS), 16, 0.05, seed)):
        assert fields(g) == fields(w)
    data = TASKS_T.make_mixed_dataset(list(TASKS), 20, seed)
    got = list(zip(range(6), PIPE.batches(data, 4, SEQ, seed=seed)))
    want = list(zip(range(6), JPIPE.batches(data, 4, SEQ, seed=seed)))
    for (_, g), (_, w) in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_eval_accuracy_matches_reference(models):
    jlm, jparams, lm, params = models
    data = _dataset(12, 3)
    for per_token in (False, True):
        want = JPIPE.eval_accuracy(jlm, jparams, data, SEQ,
                                   per_token=per_token)
        got = PIPE.eval_accuracy(lm, params, data, SEQ,
                                 per_token=per_token)
        assert got == want


# ------------------------------------------------------- rank selection
@pytest.mark.parametrize("name,reduced", [("floe-slm-2b", True),
                                          ("floe-slm-2b", False),
                                          ("floe-llm-7b", True)])
def test_lut_and_algorithm1_equal_the_reference(name, reduced):
    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg
    from repro_torch.configs import get_config as tget
    tcfg = tget(name).reduced() if reduced else tget(name)
    assert RS.lora_params(tcfg, 16) == JRS.lora_params(cfg, 16)
    assert RS.model_base_params(tcfg) == JRS.model_base_params(cfg)
    for load in (0.0, 0.37, 0.6):
        lut = RS.build_lut(tcfg, tokens_per_step=160, background_load=load)
        jlut = JRS.build_lut(cfg, tokens_per_step=160, background_load=load)
        assert lut.mem == jlut.mem and lut.lat == jlut.lat
        for dev in RS.DEVICE_CLASSES:
            for avail in (1e9, 4e9, 5.3e9, 8e9, 16e9):
                for deadline in (1e-3, 0.05, 1e9):
                    assert RS.select_rank(RS.DEFAULT_RANKS, avail, deadline,
                                          lut, dev.name) == \
                        JRS.select_rank(JRS.DEFAULT_RANKS, avail, deadline,
                                        jlut, dev.name)


# ----------------------------------------------------------------- prng
@pytest.mark.parametrize("seed", [0, 3, 301, 2 ** 31 - 1])
def test_split_and_array_normal_bit_exact(seed):
    keys = jax.random.key_data(jax.random.split(jax.random.key(seed), 5))
    got = prng.split(prng.key(seed), 5)
    np.testing.assert_array_equal(np.stack(got, -1), np.asarray(keys))
    k1, k2 = jax.random.split(jax.random.key(seed))
    for j, jk in enumerate((k1, k2)):
        tk = prng.key_at(prng.split(prng.key(seed)), j)
        # the last draw takes three of prng's chunks and a part one
        for shape in ((7,), (3, 5, 4), (2, 1, 64, 33), (3 * 1024 + 1, 64)):
            np.testing.assert_array_equal(
                prng.normal(tk, shape),
                np.asarray(jax.random.normal(jk, shape, jnp.float32)))


def test_init_adapter_keyed_bit_exact(models):
    jlm, _, lm, _ = models
    for seed, rank in ((0, 4), (7, 2), (3, 64)):
        want = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                                 rank=rank))
        got = LORA.init_adapter_keyed(lm, prng.key(seed), rank=rank)
        assert int(got["_rank"]) == int(want["_rank"])
        for g, w in zip(T.leaves({k: v for k, v in got.items()
                                  if k != "_rank"}),
                        jax.tree.leaves({k: v for k, v in want.items()
                                         if k != "_rank"})):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adapter_vectors_reuse_the_projection_bit_for_bit():
    """E(φ)'s projection is drawn once a process: adapters of other
    sizes, longer and shorter than the rows drawn so far, still project
    as the reference's fresh draw."""
    rng = np.random.default_rng(1)
    for n in (150_000, 70_000, 1_000, 300_000):
        flat = rng.standard_normal(n).astype(np.float32)
        tree = {"layers": {"q": {"A": flat}}}
        got = LORA.adapter_vectors([{"layers": {"q": {"A": torch.from_numpy(
            flat)}}}], dim=8, seed=5)[0]
        np.testing.assert_array_equal(
            got, np.asarray(JLORA.adapter_vector(tree, dim=8, seed=5)))


def test_projection_saves_and_loads_bit_for_bit(tmp_path):
    """A projection drawn and saved by ``save_projection``, then loaded
    by ``load_projection`` in place of this process's own: its rows and
    the generator's state after them are the fresh draw's, so adapters
    shorter and longer than the saved rows project as the reference's;
    the files are removed."""
    seed, dim, path = 11, 8, str(tmp_path / "proj")
    LORA._PROJECTIONS.pop((seed, dim), None)
    LORA.save_projection(path, seed, dim, 70_000)
    LORA._PROJECTIONS.pop((seed, dim))
    assert LORA.load_projection(path, seed, dim) == 2 * (1 << 16)
    assert not list(tmp_path.iterdir())
    rng = np.random.default_rng(2)
    for n in (1_000, 200_000):
        flat = rng.standard_normal(n).astype(np.float32)
        got = LORA.adapter_vectors([{"layers": {"q": {"A": torch.from_numpy(
            flat)}}}], dim=dim, seed=seed)[0]
        np.testing.assert_array_equal(got, np.asarray(JLORA.adapter_vector(
            {"layers": {"q": {"A": flat}}}, dim=dim, seed=seed)))
    LORA._PROJECTIONS.pop((seed, dim))


# ------------------------------------------------------------------- dp
def _grad_tree(rng, scale):
    return {"layers": {t: {"A": (scale * rng.standard_normal((2, 1, 4, 8))
                                 ).astype(np.float32),
                           "B": (scale * rng.standard_normal((2, 1, 6, 4))
                                 ).astype(np.float32)}
                       for t in ("k", "q", "mlp_in")}}


def test_privatize_noise_bit_exact_and_clip_within_tolerance():
    rng = np.random.default_rng(0)
    zeros = T.map_tree(np.zeros_like, _grad_tree(rng, 1.0))
    for seed, sigma in ((5, 0.5), (301, 1.3)):
        jk = jax.random.key(seed)
        want, wn = JDP.privatize(jax.tree.map(jnp.asarray, zeros), jk,
                                 1.0, sigma)
        got, n = DP.privatize(bridge.from_numpy(zeros), prng.key(seed),
                              1.0, sigma)
        assert float(n) == float(wn) == 0.0
        for g, w in zip(T.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tree = _grad_tree(rng, 0.7)
    want, wn = JDP.privatize(jax.tree.map(jnp.asarray, tree),
                             jax.random.key(9), 1.0, 0.5)
    got, n = DP.privatize(bridge.from_numpy(tree), prng.key(9), 1.0, 0.5)
    assert float(wn) > 1.0 and abs(float(n) - float(wn)) <= 1e-6 * float(wn)
    _close_tree(got, want, 1e-6)
    assert DP.epsilon_estimate(0.5, 10) == JDP.epsilon_estimate(0.5, 10)


# ------------------------------------------------------------ the model
def test_train_logits_match_reference(models):
    jlm, jparams, lm, params = models
    b = _batch(1)
    ad = _trained_adapter(jlm, 4)
    jbank = JLORA.single_expert_bank(jax.tree.map(jnp.asarray, ad))
    bank = LORA.single_expert_bank(bridge.from_numpy(ad))
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


def test_train_logits_refuse_the_grouped_layout():
    """The grouped gemma3 layout trains: its train_logits at S 24, past
    the reduced window of 16, equal the reference's
    (``test_torch_train_gemma3.py`` holds its gradients)."""
    from repro_torch.configs import get_config as tget
    jlm = JLM(get_config("floe-slm-gemma3").reduced(), remat=False)
    jparams = jlm.init(jax.random.key(1))
    lm = LM(tget("floe-slm-gemma3").reduced(), device="cpu")
    tokens = np.asarray(_batch(5)["tokens"])
    want, _ = jlm.train_logits(jparams, {"tokens": jnp.asarray(tokens)})
    got, _ = lm.train_logits(bridge.from_numpy(jax.device_get(jparams)),
                             {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want, LOSS_TOL)


def _bank_pair(jlm, seed, ranks=None):
    ad = _trained_adapter(jlm, seed)
    jbank = JLORA.single_expert_bank(jax.tree.map(jnp.asarray, ad))
    bank = LORA.single_expert_bank(bridge.from_numpy(ad))
    if ranks is not None:
        r_max = jlm.cfg.lora_rank_max
        n = jlm.cfg.num_layers
        jm = jnp.broadcast_to(JLORA.rank_mask(ranks, r_max),
                              (n, len(ranks), r_max))
        tm = LORA.rank_mask(ranks, r_max).expand(n, -1, -1)
        for tgt in jbank["layers"]:
            jbank["layers"][tgt]["rank_mask"] = jm
            bank["layers"][tgt]["rank_mask"] = tm
    return jbank, bank


@pytest.mark.parametrize("ranks", [None, [2]])
def test_lora_loss_and_grads_match_value_and_grad(models, ranks):
    jlm, jparams, lm, params = models
    b = _batch(2)
    jbank, bank = _bank_pair(jlm, 6, ranks)
    gates = np.ones(1, np.float32)

    def jloss(body):
        full = {**body, **{k: v for k, v in jbank.items()
                           if k.startswith("_")}}
        return JTS.lora_loss_fn(jlm, jparams, full,
                                jax.tree.map(jnp.asarray, b),
                                jnp.asarray(gates))
    trainable = {s: {t: {k: v for k, v in ab.items() if k in ("A", "B")}
                     for t, ab in st.items()}
                 for s, st in JLORA.bank_for_model(jbank).items()}
    masks = {s: {t: {k: v for k, v in ab.items() if k == "rank_mask"}
                 for t, ab in st.items()}
             for s, st in JLORA.bank_for_model(jbank).items()}

    def jloss_ab(tr):
        body = {s: {t: {**tr[s][t], **masks[s][t]} for t in tr[s]}
                for s in tr}
        return jloss(body)
    wl, wg = jax.value_and_grad(jloss_ab)(trainable)

    tbody = LORA.bank_for_model(bank)
    leaves = {s: {t: {k: v.detach().requires_grad_(True)
                      for k, v in ab.items() if k in ("A", "B")}
                  for t, ab in st.items()} for s, st in tbody.items()}
    full = {s: {t: {**leaves[s][t], **{k: v for k, v in ab.items()
                                        if k == "rank_mask"}}
                for t, ab in st.items()} for s, st in tbody.items()}
    tb = PIPE.to_torch(b, "cpu")
    loss = TS.lora_loss_fn(lm, params, {**full, "_ranks": bank["_ranks"]},
                           tb, torch.from_numpy(gates))
    grads = torch.autograd.grad(loss, T.leaves(leaves))
    _close(loss, wl, LOSS_TOL)
    for g, w in zip(grads, jax.tree.leaves(wg)):
        _close(g, w, GRAD_TOL)
    if ranks is not None:
        # a masked rank's A rows and B columns take no gradient
        for tgt, ab in leaves["layers"].items():
            ga, gb = torch.autograd.grad(
                TS.lora_loss_fn(lm, params,
                                {**full, "_ranks": bank["_ranks"]}, tb,
                                torch.from_numpy(gates)), [ab["A"], ab["B"]])
            assert not ga[..., ranks[0]:, :].any()
            assert not gb[..., ranks[0]:].any()


def test_lora_train_step_matches_reference(models):
    """One jitted reference step against one eager port step: the same
    loss and an updated bank within tolerance."""
    jlm, jparams, lm, params = models
    b = _batch(3)
    jbank, bank = _bank_pair(jlm, 8)
    jopt = JOPT.adamw(JOPT.constant_schedule(5e-3))
    opt = OPT.adamw(OPT.constant_schedule(5e-3))
    body = lambda bk: {k: v for k, v in bk.items() if not k.startswith("_")}
    jstep = JTS.make_lora_train_step(jlm, jopt)
    step = TS.make_lora_train_step(lm, opt)
    jb, _, wl = jstep(jparams, jbank, jopt.init(body(jbank)),
                      jax.tree.map(jnp.asarray, b), jnp.ones((1,)), None)
    tb, _, l = step(params, bank, opt.init(body(bank)),
                    PIPE.to_torch(b, "cpu"), torch.ones(1))
    _close(l, wl, LOSS_TOL)
    _close_tree(body(tb), body(jb), GRAD_TOL)


def test_full_train_step_matches_reference(models):
    jlm, jparams, lm, params = models
    b = _batch(4)
    jopt = JOPT.adamw(JOPT.constant_schedule(1e-3))
    opt = OPT.adamw(OPT.constant_schedule(1e-3))
    jp, _, wl = JTS.make_full_train_step(jlm, jopt)(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, b))
    tp, _, l = TS.make_full_train_step(lm, opt)(
        params, opt.init(params), PIPE.to_torch(b, "cpu"))
    _close(l, wl, LOSS_TOL)
    _close_tree(tp, jp, GRAD_TOL)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(which):
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((3, 5, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((6,)).astype(np.float32),
                    "d": rng.standard_normal((4, 7)).astype(np.float32)}}
    if which == "adamw":
        jopt = JOPT.adamw(JOPT.constant_schedule(5e-3), weight_decay=0.01)
        opt = OPT.adamw(OPT.constant_schedule(5e-3), weight_decay=0.01)
    else:
        jopt = JOPT.adafactor(JOPT.cosine_schedule(1e-2, 2, 10))
        opt = OPT.adafactor(OPT.cosine_schedule(1e-2, 2, 10))
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.from_numpy(params)
    js, ts = jopt.init(jp), opt.init(tp)
    for i in range(3):
        grads = jax.tree.map(lambda x: (3.0 * rng.standard_normal(x.shape)
                                        ).astype(np.float32), params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = opt.update(bridge.from_numpy(grads), ts, tp)
        _close_tree(tp, jp, OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3


# ----------------------------------------------------------- checkpoint
def test_checkpoint_restores_across_packages(models, tmp_path):
    jlm, _, lm, _ = models
    ad = _trained_adapter(jlm, 12)
    jbank = JLORA.single_expert_bank(jax.tree.map(jnp.asarray, ad))
    bank = LORA.single_expert_bank(bridge.from_numpy(ad))
    state = {"bank": bank, "opt": OPT.adamw(OPT.constant_schedule(1e-3)).init(
        LORA.bank_for_model(bank)), "meta": [1, None, 2.5]}
    jstate = {"bank": jbank, "opt": JOPT.adamw(
        JOPT.constant_schedule(1e-3)).init(JLORA.bank_for_model(jbank)),
        "meta": [1, None, 2.5]}
    CKPT.save(str(tmp_path / "port.npz"), state)
    JCKPT.save(str(tmp_path / "ref.npz"), jstate)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files)
    back = JCKPT.restore(str(tmp_path / "port.npz"), jstate)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    back = CKPT.restore(str(tmp_path / "ref"), state)
    assert back["meta"][1] is None
    for g, w in zip(T.leaves(back["bank"]), T.leaves(state["bank"])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------------------ alignment
def test_train_alignment_losses_match_reference():
    v, b = 24, 6
    rng = np.random.default_rng(2)
    jmlp = jax.device_get(JFUS.init_alignment(jax.random.key(4), v))
    batches = [(rng.standard_normal((b, v)).astype(np.float32),
                rng.standard_normal((b, v)).astype(np.float32),
                rng.integers(0, v, b).astype(np.int32)) for _ in range(3)]
    _, want = JFUS.train_alignment(
        jax.tree.map(jnp.asarray, jmlp),
        [tuple(map(jnp.asarray, x)) for x in batches], lr=0.1, steps=7)
    _, got = FUS.train_alignment(
        bridge.from_numpy(jmlp),
        [tuple(torch.from_numpy(z) for z in x) for x in batches], lr=0.1,
        steps=7)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    assert got[6] < got[3] < got[0]          # the first batch, cycled


# ---------------------------------------------------- K8 / K9 plain math
@pytest.mark.parametrize("b,h,kvh,s", [(2, 4, 2, 13), (1, 8, 1, 40)])
def test_k8_plain_equals_autograd_and_reference_vjp(b, h, kvh, s):
    d = 16
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = K3.flash_attention_plain(tq, tk, tv)
    ag = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    o, lse = K3.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                return_lse=True)
    got = K3.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 o, torch.from_numpy(do), lse)
    for g, w in zip(got, ag):
        _close(g, w.numpy(), 1e-5)
    # the reference's VJP of chunked_causal_attention, (B, S, H, D) layout
    pos = jnp.arange(s)
    tr = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda a, c, e: JATT.chunked_causal_attention(
        a, c, e, pos, pos), tr(q), tr(k), tr(v))
    for g, w in zip(got, vjp(tr(do))):
        _close(g, np.asarray(w).transpose(0, 2, 1, 3), 1e-5)


@pytest.mark.parametrize("t,k,n,e,r,rpg", [(12, 32, 48, 1, 4, 12),
                                           (16, 64, 24, 4, 8, 4)])
def test_k9_plain_equals_autograd(t, k, n, e, r, rpg):
    rng = np.random.default_rng(t + e)
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((e, r, k)).astype(np.float32))
    bb = torch.from_numpy(rng.standard_normal((e, n, r)).astype(np.float32))
    g = torch.from_numpy(rng.random((t // rpg, e)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    xs, as_, bs = (z.clone().requires_grad_(True) for z in (x, a, bb))
    want = torch.autograd.grad(KL.moe_lora_delta_plain(xs, as_, bs, g, rpg),
                               (xs, as_, bs), dy)
    got = KL.moe_lora_delta_bwd(x, a, bb, g, dy, rpg)
    for gg, w in zip(got, want):
        _close(gg, w.numpy(), 1e-5)


def test_lora_delta_rank_mask_matches_reference():
    """A rank_mask leaf zeroes the masked ranks' u on the float-gate path
    and on integer slots (the reference's one-hot fallback)."""
    from repro.models import layers as JL
    rng = np.random.default_rng(21)
    e, r, k, n = 3, 4, 16, 8
    lora = {"A": rng.standard_normal((e, r, k)).astype(np.float32),
            "B": rng.standard_normal((e, n, r)).astype(np.float32),
            "rank_mask": np.asarray(JLORA.rank_mask([1, 4, 2], r))}
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    for gates in (rng.random((2, e)).astype(np.float32),
                  np.asarray([2, -1], np.int32)):
        want = JL.lora_delta(jax.tree.map(jnp.asarray, lora), jnp.asarray(x),
                             jnp.asarray(gates))
        got = L.lora_delta(bridge.from_numpy(lora), torch.from_numpy(x),
                           torch.from_numpy(gates))
        _close(got, want, 1e-5)
    slots = torch.tensor([0, 0], dtype=torch.int32)
    got = L.lora_delta(bridge.from_numpy(lora), torch.from_numpy(x), slots)
    lora["B"][0, :, 1:] = 7.0          # past expert 0's rank 1: unused
    again = L.lora_delta(bridge.from_numpy(lora), torch.from_numpy(x), slots)
    assert torch.equal(got, again)
