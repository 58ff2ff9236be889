"""The port's Mamba-1 training and LoRA serving vs the JAX package's, on
the CPU: the reduced falcon-mamba (2 layers, d 256, d_inner 512, N 8,
dt_rank 16, vocab 512) in float32, the reference's parameters bridged,
inputs from numpy seeds.

* ``lora_layout`` equal to the reference's (ssm_in, ssm_x, ssm_dt and
  ssm_out on the four projections), and Algorithm 1's LUT at full
  width for falcon-mamba-7b and floe-slm-gemma3;
* ``mamba1_block`` with a LoRA bank in prefill (gate rows) and decode
  (gate rows and integer slots, the slot kernel's path);
* ``train_logits`` at S 32 and 256, with and without a bank;
* the LoRA loss and every leaf's gradient against ``jax.value_and_grad``
  at S 128 and 256 (two of the reference's 128-step scan chunks), and
  under a rank mask;
* the full train step's gradients (``A_log``, ``D``, ``conv_w``,
  ``conv_b`` and ``dt_proj.b`` among them) and its update;
* K10's plain backward (``ssm_scan_bwd_plain``, the function the CUDA
  kernel computes) and ``ssm_scan_train`` against ``jax.vjp`` of the
  reference's chunked scan ``_mamba1_inner``, and the chunk states of
  K6's plain version against the scan's own states;
* ``prefill_packed`` on ragged lengths: logits and every row's state
  (the state after the padded width, as the reference's);
* ``SoloEngine`` with adapter slots (K5 gate rows at prefill, K4 slot
  ids at decode) and with a router-gated bank, token for token against
  the reference's;
* one ``run_simulation`` round and ``launch/train.py --arch
  falcon-mamba-7b`` against the reference's.

Tolerances as ``test_torch_train.py`` states them: LOSS_TOL 1e-5 on
logits and losses, GRAD_TOL 2e-4 on gradients, relative to the largest
reference magnitude (the scan adds one f32 recurrence, summed in another
order than the reference's associative scan); 1e-5 on a block's output
and state (``test_torch_ssm.py``'s TOL); K10's plain backward 1e-5;
a step's update within UPDATE_TOL 1e-2 of the reference's in relative
norm a leaf and every element within the 2 · lr that Adam can move it
(UPDATE_TOL states why).
"""
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
from repro.data import pipeline as JPIPE
from repro.data import tokenizer as JTOK
from repro.data.tasks import TASKS, make_mixed_dataset
from repro.federated import simulation as JSIM
from repro.models import ssm as JSSM
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import SoloEngine as JSolo
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.data import pipeline as PIPE
from repro_torch.data import tokenizer as TOK
from repro_torch.federated import simulation as SIM
from repro_torch.kernels.ssm_scan import kernel as K6
from repro_torch.models import ssm as SSM
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import SoloEngine
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from _threads import one_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
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
TOL = dict(rtol=1e-5, atol=1e-5)
SIM_KW = dict(num_clients=4, examples_per_client=32, rounds=1,
              local_steps=5, seq_len=40, batch_size=4, alpha=0.05, seed=3)
PROMPTS = ["math: compute 12 plus 7 =", "translate to french: water ->",
           "explain how rainbows form " * 3]
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9"],
           "lang": ["translate water", "say hello in french"],
           "science": ["explain how rain forms", "why is the sky blue"]}


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
    jlm = JLM(get_config(ARCH).reduced(), remat=False)
    jparams = jlm.init(jax.random.key(0))
    return jlm, jparams, LM(tget_config(ARCH).reduced(), device="cpu"), \
        bridge.from_numpy(jax.device_get(jparams))


def _batch(seed, seq, bs=4):
    return JPIPE.make_batch(make_mixed_dataset(list(TASKS), bs, seed), seq)


def _adapter(jlm, seed, scale=0.3):
    """A reference adapter with random B (``init_adapter`` zeroes B)."""
    ad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(seed),
                                           rank=4))
    rng = np.random.default_rng(seed)
    for leaf in ad["layers"].values():
        leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                     ).astype(np.float32)
    return ad


def _bank_pair(jlm, seeds, ranks=None):
    ads = [_adapter(jlm, s) for s in seeds]
    jbank = JLORA.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads])
    bank = LORA.stack_adapters([bridge.from_numpy(a) for a in ads])
    if ranks is not None:
        m = np.broadcast_to(np.asarray(JLORA.rank_mask(
            ranks, jlm.cfg.lora_rank_max)),
            (jlm.cfg.num_layers, len(ranks), jlm.cfg.lora_rank_max))
        for tgt in jbank["layers"]:
            jbank["layers"][tgt]["rank_mask"] = jnp.asarray(m)
            bank["layers"][tgt]["rank_mask"] = torch.from_numpy(m.copy())
    return jbank, bank


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "floe-slm-gemma3"])
def test_rank_selection_lut_equals_reference_at_full_width(arch):
    """Algorithm 1's LUT over the full-width model's LoRA layout (the
    SSM targets, the grouped stacks): equal to the reference's entry for
    entry, and so every client's rank."""
    from repro.core import rank_select as JRS
    from repro_torch.core import rank_select as RS
    got = RS.build_lut(tget_config(arch), tokens_per_step=160)
    want = JRS.build_lut(get_config(arch), tokens_per_step=160)
    assert got.mem == want.mem and got.lat == want.lat
    assert RS.lora_params(tget_config(arch), 16) == \
        JRS.lora_params(get_config(arch), 16)


def test_lora_layout_equals_reference(models):
    jlm, _, lm, _ = models
    assert lm.lora_layout() == jlm.lora_layout()
    assert sorted(lm.lora_layout()["layers"][1]) == \
        ["ssm_dt", "ssm_in", "ssm_out", "ssm_x"]


def test_mamba1_block_with_lora_prefill_and_decode(models):
    """A two-expert bank on every target: prefill under per-row gate
    rows, then decode steps under the same rows and under integer slots
    (the reference's one-hot fallback, K4 on the card)."""
    jlm, jparams, _, params = models
    cfg = jlm.cfg
    jbank, bank = _bank_pair(jlm, (1, 2))
    jl = jax.tree.map(lambda t: t[0], JLORA.bank_for_model(jbank)["layers"])
    tl = T.map_tree(lambda t: t[0], LORA.bank_for_model(bank)["layers"])
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["ssm"])
    tp = T.map_tree(lambda t: t[0], params["layers"]["ssm"])
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model))
    x = x.astype(np.float32)
    gates = np.asarray([[0.7, 0.3], [0.0, 1.0]], np.float32)
    jy, jc = JSSM.mamba1_block(cfg, jp, jnp.asarray(x[:, :20]),
                               mode="prefill", lora=jl,
                               gates=jnp.asarray(gates))
    y, c = SSM.mamba1_block(cfg, tp, torch.from_numpy(x[:, :20]),
                            mode="prefill", lora=tl,
                            gates=torch.from_numpy(gates))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    plain, _ = SSM.mamba1_block(cfg, tp, torch.from_numpy(x[:, :20]),
                                mode="prefill")
    assert not torch.allclose(plain, y)       # the bank is at work
    for k in ("conv", "h"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), **TOL)
    slots = np.asarray([1, -1], np.int32)
    for g in (gates, slots):
        jcc, cc = jc, {k: v.clone() for k, v in c.items()}
        for t in range(20, 24):
            jy, jcc = JSSM.mamba1_block(cfg, jp, jnp.asarray(x[:, t:t + 1]),
                                        cache=jcc, mode="decode", lora=jl,
                                        gates=jnp.asarray(g))
            y, cc = SSM.mamba1_block(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                     cache=cc, mode="decode", lora=tl,
                                     gates=torch.from_numpy(g))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(cc["h"].numpy(), np.asarray(jcc["h"]),
                                       **TOL)


@pytest.mark.parametrize("seq", [32, 256])
def test_train_logits_match_reference(models, seq):
    jlm, jparams, lm, params = models
    b = _batch(seq, seq)
    jbank, bank = _bank_pair(jlm, (4,))
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


def test_train_logits_keep_the_chunk_rule(models):
    _, _, lm, params = models
    with pytest.raises(ValueError, match="chunk 128"):
        lm.train_logits(params, {"tokens": torch.zeros(1, 129).long()})


@pytest.mark.parametrize("seq,ranks", [(128, None), (256, None),
                                       (128, [2])])
def test_lora_loss_and_grads_match_value_and_grad(models, seq, ranks):
    jlm, jparams, lm, params = models
    b = _batch(seq + 1, seq)
    jbank, bank = _bank_pair(jlm, (6,), ranks)
    gates = np.ones(1, np.float32)
    body = JLORA.bank_for_model(jbank)["layers"]
    trainable = {t: {k: v for k, v in ab.items() if k in ("A", "B")}
                 for t, ab in body.items()}
    masks = {t: {k: v for k, v in ab.items() if k == "rank_mask"}
             for t, ab in body.items()}

    def jloss(tr):
        full = {"layers": {t: {**tr[t], **masks[t]} for t in tr},
                "_ranks": jbank["_ranks"]}
        return JTS.lora_loss_fn(jlm, jparams, full,
                                jax.tree.map(jnp.asarray, b),
                                jnp.asarray(gates))
    wl, wg = jax.value_and_grad(jloss)(trainable)

    tbody = LORA.bank_for_model(bank)["layers"]
    tr = {t: {k: v for k, v in ab.items() if k in ("A", "B")}
          for t, ab in tbody.items()}
    tmasks = {t: {k: v for k, v in ab.items() if k == "rank_mask"}
              for t, ab in tbody.items()}

    def tloss(leaves):
        full = {"layers": {t: {**leaves[t], **tmasks[t]} for t in leaves},
                "_ranks": bank["_ranks"]}
        return TS.lora_loss_fn(lm, params, full, PIPE.to_torch(b, "cpu"),
                               torch.from_numpy(gates))
    loss, grads = TS.value_and_grad(tloss, tr)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    if ranks is not None:
        for ab in grads.values():
            assert not ab["A"][..., ranks[0]:, :].any()
            assert not ab["B"][..., ranks[0]:].any()


def test_lora_train_step_matches_reference(models):
    jlm, jparams, lm, params = models
    b = _batch(3, 40)
    jbank, bank = _bank_pair(jlm, (8,))
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
    _updates_close(body(tb), body(bank), body(jb), 5e-3)


def test_full_train_step_matches_reference(models):
    """Every parameter's gradient within GRAD_TOL (the scan's A_log and
    D, the conv's weight and bias, dt_proj's bias among them), then one
    AdamW step: its update within UPDATE_TOL of the reference's and each
    element within the 2 · lr that Adam can move it."""
    jlm, jparams, lm, params = models
    b = _batch(4, 40)
    jb = jax.tree.map(jnp.asarray, b)
    wl, wg = jax.value_and_grad(
        lambda p: JTS.full_loss_fn(jlm, p, jb))(jparams)
    loss, grads = TS.value_and_grad(
        lambda p: TS.full_loss_fn(lm, p, PIPE.to_torch(b, "cpu")), params)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    ssm = grads["layers"]["ssm"]
    for leaf in (ssm["A_log"], ssm["D"], ssm["conv_w"], ssm["conv_b"],
                 ssm["dt_proj"]["b"]):
        assert leaf.abs().max() > 0
    jopt = JOPT.adamw(JOPT.constant_schedule(1e-3))
    opt = OPT.adamw(OPT.constant_schedule(1e-3))
    jp, _, wl = JTS.make_full_train_step(jlm, jopt)(
        jparams, jopt.init(jparams), jb)
    tp, _, l = TS.make_full_train_step(lm, opt)(
        params, opt.init(params), PIPE.to_torch(b, "cpu"))
    _close(l, wl, LOSS_TOL)
    _updates_close(tp, params, jp, 1e-3)


@pytest.mark.parametrize("b,s,di,n", [(2, 40, 24, 8), (1, 256, 16, 16)])
def test_k10_plain_equals_reference_vjp(models, b, s, di, n):
    """K10's function and ``ssm_scan_train`` against ``jax.vjp`` of the
    reference's chunked scan: d(dt), dx, dB, dC and, through A = -exp(
    A_log), d(A_log) = dA * A.  K6's chunk states are the scan's own
    states at steps 0, 64, ..."""
    cfg = models[0].cfg
    rng = np.random.default_rng(s + n)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, di)))) * 0.1
          ).astype(np.float32)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    bm = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, n))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal((di, n))).astype(np.float32)
    dy = rng.standard_normal((b, s, di)).astype(np.float32)

    def ref(x_, dt_, b_, c_, al):
        y, _ = JSSM._mamba1_inner(cfg, {"A_log": al}, x_, dt_, b_, c_,
                                  jnp.zeros((b, di, n), jnp.float32), 128)
        return y
    _, vjp = jax.vjp(ref, *(jnp.asarray(v) for v in (x, dt, bm, cm, a_log)))
    jdx, jddt, jdb, jdc, jdal = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    t = [torch.from_numpy(v) for v in (dt, x, bm, cm)]
    a = -torch.exp(torch.from_numpy(a_log))
    ddt, dx, dbm, dcm, da = K6.ssm_scan_bwd_plain(*t, a, torch.from_numpy(dy))
    for got, want in ((ddt, jddt), (dx, jdx), (dbm, jdb), (dcm, jdc),
                      (da * a, jdal)):
        _close(got, want, 1e-5)
    leaves = [v.clone().requires_grad_(True) for v in t] + \
        [torch.from_numpy(a_log).requires_grad_(True)]
    y = K6.ssm_scan_train(*leaves[:4], -torch.exp(leaves[4]))
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for got, want in zip(grads, (jddt, jdx, jdb, jdc, jdal)):
        _close(got, want, 1e-5)
    _, _, hc = K6.ssm_scan_plain(*t, a, chunk_states=True)
    assert hc.shape == (b, -(-s // 64), di, n) and not hc[:, 0].any()
    for c in range(1, hc.shape[1]):
        _, h = K6.ssm_scan_plain(*(v[:, :64 * c] for v in t), a)
        assert torch.equal(hc[:, c], h)


@pytest.mark.parametrize("lpad,lengths", [(32, [32, 20, 7]),
                                          (128, [100, 128, 1])])
def test_prefill_packed_matches_reference(models, lpad, lengths):
    """Ragged rows right-padded to Lpad, with and without a gated bank:
    each row's last-valid-token logits, and the state after the padded
    width in every row (the reference's ``_pad_cache`` keeps it), "pos"
    the lengths."""
    jlm, jparams, lm, params = models
    rng = np.random.default_rng(lpad)
    toks = rng.integers(3, 259, (len(lengths), lpad)).astype(np.int32)
    jbank, bank = _bank_pair(jlm, (2, 3))
    gates = rng.random((len(lengths), 2)).astype(np.float32)
    for lora in (False, True):
        kw = dict(lora=JLORA.bank_for_model(jbank),
                  gates=jnp.asarray(gates)) if lora else {}
        jl, jc = jlm.prefill_packed(jparams, {"tokens": jnp.asarray(toks)},
                                    np.asarray(lengths), 160, **kw)
        tkw = dict(lora=LORA.bank_for_model(bank),
                   gates=torch.from_numpy(gates)) if lora else {}
        logits, cache = lm.prefill_packed(params, torch.from_numpy(toks),
                                          lengths, 160, **tkw)
        _close(logits, jl, 1e-4)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for k in ("conv", "h"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                       **TOL)
    with pytest.raises(ValueError, match="write_kv"):
        lm.prefill_packed(params, torch.from_numpy(toks), lengths, 160,
                          write_kv=lambda *a: None)


@pytest.fixture
def token_ids(monkeypatch):
    """Both packages decode to the id list, so outputs compare ids."""
    def ids(seq):
        return ",".join(str(int(i)) for i in seq)
    monkeypatch.setattr(JTOK, "decode", ids)
    monkeypatch.setattr(TOK, "decode", ids)


def test_solo_adapter_slots_match_reference(models, token_ids):
    """Three users' adapters over two slots: every request's tokens equal
    the reference's (K5 gate rows at prefill, K4 on the slot id at
    decode), adapters change the tokens, the cache stats agree."""
    jlm, jparams, lm, params = models
    jeng = JSolo(deployment=JDep(jlm, jparams, max_seq=64, adapter_slots=2))
    teng = SoloEngine(deployment=ServingDeployment(
        lm, params, max_seq=64, adapter_slots=2, device="cpu"))
    for i in range(3):
        ad = _adapter(jlm, 10 + i, scale=2.0)
        jeng.adapters.register(f"u{i}", jax.tree.map(jnp.asarray, ad))
        teng.adapters.register(f"u{i}", bridge.from_numpy(ad))
    out = {}
    for p, aid in zip(PROMPTS * 2, ("u0", "u1", None, "u2", "u0", "u1")):
        want = jeng.generate(p, 8, adapter_id=aid)
        assert teng.generate(p, 8, adapter_id=aid) == want
        out[p, aid] = want
    assert out[PROMPTS[0], "u0"] != out.get((PROMPTS[0], None),
                                            teng.generate(PROMPTS[0], 8))
    assert teng.adapter_stats() == jeng.adapter_stats()


def test_solo_adapter_slots_decode_through_k4(models, monkeypatch):
    """A slot request's prefill takes K5 on its one-hot gate row and each
    decode step K4 on its slot id, four targets a layer; an adapter-free
    request takes neither."""
    from repro_torch.models import layers as LAYERS
    jlm, _, lm, params = models
    calls = {"k4": [], "k5": []}
    k4, k5 = LAYERS.moe_lora_delta_slots, LAYERS.moe_lora_delta

    def slots(x, a, b, s, rows):
        calls["k4"].append(s.tolist())
        return k4(x, a, b, s, rows)

    def gated(x, a, b, g, rows):
        calls["k5"].append(g.tolist())
        return k5(x, a, b, g, rows)

    monkeypatch.setattr(LAYERS, "moe_lora_delta_slots", slots)
    monkeypatch.setattr(LAYERS, "moe_lora_delta", gated)
    eng = SoloEngine(deployment=ServingDeployment(
        lm, params, max_seq=64, adapter_slots=2, device="cpu"))
    eng.adapters.register("u0", bridge.from_numpy(_adapter(jlm, 10)))
    decode, steps = eng.dep.slm_decode, []
    monkeypatch.setattr(eng.dep, "slm_decode",
                        lambda *a: steps.append(1) or decode(*a))
    eng.generate(PROMPTS[0], 4, adapter_id="u0")
    per_pass = 4 * lm.cfg.num_layers
    assert steps and len(calls["k5"]) == per_pass
    assert calls["k5"][0] in ([[1.0, 0.0]], [[0.0, 1.0]])
    slot = calls["k5"][0][0].index(1.0)
    assert calls["k4"] == [[slot]] * (per_pass * len(steps))
    calls["k4"].clear()
    calls["k5"].clear()
    eng.generate(PROMPTS[0], 4)
    assert calls == {"k4": [], "k5": []}


def test_solo_router_bank_matches_reference(models, token_ids):
    jlm, jparams, lm, params = models
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
    plain = SoloEngine(deployment=ServingDeployment(lm, params, max_seq=64,
                                                    device="cpu"))
    moved = 0
    for p in PROMPTS:
        want = jeng.generate(p, 8)
        assert teng.generate(p, 8) == want
        moved += want != plain.generate(p, 8)
    assert moved


@pytest.fixture(scope="module")
def sims(models):
    jlm, jparams, lm, params = models
    return (SIM.run_simulation(lm, params, SIM.SimConfig(**SIM_KW)),
            JSIM.run_simulation(jlm, jparams, JSIM.SimConfig(**SIM_KW)))


def test_simulation_round_matches_reference(sims):
    res, jres = sims
    assert res.dropped_per_round == jres.dropped_per_round
    assert [[(u.cid, u.rank) for u in ups] for ups in res.updates_per_round] \
        == [[(u.cid, u.rank) for u in ups] for ups in jres.updates_per_round]
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
    body = lambda ad: {k: v for k, v in ad.items() if not k.startswith("_")}
    for e, je in zip(res.server.state.experts, jres.server.state.experts):
        assert int(e["_rank"]) == int(je["_rank"])
        for g, w in zip(T.leaves(body(e)), jax.tree.leaves(body(je))):
            w = np.asarray(w)
            assert np.linalg.norm(g.numpy() - w) <= \
                1e-3 * max(np.linalg.norm(w), 1e-30)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2 * 5e-3 * 5)


def test_train_launcher_matches_reference(capsys):
    """``--arch falcon-mamba-7b --local --device cpu`` prints the
    reference launcher's history: clients, clusters, ranks and dropped
    equal, the losses and silhouette within LOSS_TOL."""
    from repro_torch.launch import train
    res = train.main(["--local", "--device", "cpu", "--rounds", "1",
                      "--clients", "3", "--arch", ARCH])
    out = capsys.readouterr().out.splitlines()
    jlm = JLM(get_config(ARCH).reduced(), remat=False)
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
