"""The port's zamba2 training and packed prefill vs the JAX package's, on
the CPU: the reduced zamba2 (d 256, Mamba-2 d_inner 512 with 32 SSD
heads of 16, N 8; the shared attention block H 4 / KV 2 / head_dim 32,
window 16; vocab 512) in float32 at ``num_layers`` 5 (two groups under
the shared block and a tail of one, so the ``special`` LoRA stack has a
slice a group), the reference's parameters bridged, inputs from numpy
seeds.

* Algorithm 1's LUT over the full-width zamba2-7b's LoRA layout
  (inner, tail and special stacks) equal to the reference's;
* the LoRA loss and every leaf's gradient, the ``special`` slices of
  both groups among them, against ``jax.value_and_grad`` at S 32, 256
  and 512 (two of the reference's 256-step chunks);
* a LoRA train step and a full train step (``A_log``, ``D``, the conv's
  weight and bias and ``dt_bias`` among its gradients);
* K12's function: ``ssd_scan_bwd_plain`` and ``ssd_scan_train`` against
  ``jax.vjp`` of the reference's chunk loop, and ``_k12_steps``
  (K12's recurrence, the kernel's formulas) against the same; the chunk
  states' plain version against the states a reference prefill of 64,
  128, 192 and 256 steps leaves;
* ``prefill_packed`` at Lpad 32 on rows of 32, 20 and 7 tokens, with and
  without ring caches (window 16 < Lpad): each row's logits, every
  Mamba-2 layer's state after the padded width, the shared block's K/V
  rows (rings placed per row), "pos";
* one ``run_simulation`` round and ``launch/train.py --arch zamba2-7b``
  against the reference's.

Tolerances as ``test_torch_train_ssm.py`` states them: LOSS_TOL 1e-5 on
logits and losses, GRAD_TOL 2e-4 on gradients, relative to the largest
reference magnitude; packed-prefill logits 1e-4, conv inputs and K/V
1e-5; the scan's gradients and states SCAN_TOL 1e-4
(``test_torch_ssd.py``'s, as SCAN_TOL states); a step's update within
UPDATE_TOL of the reference's in relative norm a leaf and every element
within the 2 · lr that Adam can move it.
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
from repro.models import ssm as JSSM
from repro.models.model import LM as JLM
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.data import pipeline as PIPE
from repro_torch.federated import simulation as SIM
from repro_torch.kernels.ssd_scan import kernel as K11
from repro_torch.models.model import LM
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from _threads import one_thread  # noqa: F401

ARCH = "zamba2-7b"
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
# as test_torch_train_ssm.py's UPDATE_TOL: Adam moves an element whose
# gradient lies near zero by up to 2 · lr either way
UPDATE_TOL = 1e-2
# the scan's gradients and states against the reference's chunk loop:
# test_torch_ssd.py's SCAN_TOL, relative to the largest reference
# magnitude (the same f32 chunk form, its cumulative log-decays and
# 256-product sums taken in another library's order; read 3.1e-5 on da
# at S 256 for K12's plain version, 9.7e-6 for its recurrence)
SCAN_TOL = 1e-4
SIM_KW = dict(num_clients=3, examples_per_client=16, rounds=1,
              local_steps=3, seq_len=40, batch_size=4, alpha=0.05, seed=3)


def _cfgs(n_layers):
    return tuple(dataclasses.replace(get(ARCH).reduced(),
                                     num_layers=n_layers)
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


@pytest.fixture(scope="module")
def models():
    """Two groups and a tail of one, both packages."""
    jcfg, cfg = _cfgs(5)
    jlm = JLM(jcfg, remat=False)
    jparams = jlm.init(jax.random.key(0))
    return jlm, jparams, LM(cfg, device="cpu"), \
        bridge.from_numpy(jax.device_get(jparams))


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
    """Algorithm 1's LUT over zamba2-7b's LoRA layout (68 Mamba-2 layers'
    four targets, the shared block's six a group): equal to the
    reference's entry for entry, and so every client's rank."""
    from repro.core import rank_select as JRS
    from repro_torch.core import rank_select as RS
    got = RS.build_lut(tget_config(ARCH), tokens_per_step=160)
    want = JRS.build_lut(get_config(ARCH), tokens_per_step=160)
    assert got.mem == want.mem and got.lat == want.lat
    assert RS.lora_params(tget_config(ARCH), 16) == \
        JRS.lora_params(get_config(ARCH), 16)


@pytest.mark.parametrize("seq,bs", [(32, 4), (256, 2), (512, 1)])
def test_lora_loss_and_grads_match_value_and_grad(models, seq, bs):
    """Every stack's leaves (inner, tail and both groups' special
    slices) within GRAD_TOL of ``jax.value_and_grad``; the two groups'
    special gradients differ (each group's slice is its own)."""
    jlm, jparams, lm, params = models
    b = _batch(seq + 1, seq, bs)
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
    loss, grads = TS.value_and_grad(tloss, _body(tbody))
    assert sorted(grads) == ["inner", "special", "tail"]
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    for leaf in grads["special"].values():
        assert leaf["B"].shape[0] == 2 and leaf["B"][0].abs().max() > 0
        assert not torch.equal(leaf["B"][0], leaf["B"][1])


def test_lora_train_step_matches_reference(models):
    jlm, jparams, lm, params = models
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


def test_full_train_step_matches_reference(models):
    """Every parameter's gradient within GRAD_TOL (the Mamba-2 layers'
    A_log, D, dt_bias, conv weight and bias, the shared block's
    projections among them), then one AdamW step against the
    reference's."""
    jlm, jparams, lm, params = models
    b = _batch(4, 40)
    jb = jax.tree.map(jnp.asarray, b)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p: JTS.full_loss_fn(jlm, p, jb)))(jparams)
    loss, grads = TS.value_and_grad(
        lambda p: TS.full_loss_fn(lm, p, PIPE.to_torch(b, "cpu")), params)
    _close(loss, wl, LOSS_TOL)
    _close_tree(grads, wg, GRAD_TOL)
    ssm = grads["inner"]["ssm"]
    for leaf in (ssm["A_log"], ssm["D"], ssm["dt_bias"], ssm["conv_w"],
                 ssm["conv_b"], grads["shared_attn"]["attn"]["q"]["w"]):
        assert leaf.abs().max() > 0
    jopt = JOPT.adamw(JOPT.constant_schedule(1e-3))
    opt = OPT.adamw(OPT.constant_schedule(1e-3))
    jp, _, wl = JTS.make_full_train_step(jlm, jopt)(
        jparams, jopt.init(jparams), jb)
    tp, _, l = TS.make_full_train_step(lm, opt)(
        params, opt.init(params), PIPE.to_torch(b, "cpu"))
    _close(l, wl, LOSS_TOL)
    _updates_close(tp, params, jp, 1e-3)


def _scan_inputs(seed, b, s, h, p, n, g):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    bm = rng.standard_normal((b, s, g, n)) * 0.5
    cm = rng.standard_normal((b, s, g, n)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
    a_log = rng.standard_normal(h) * 0.5
    dy = rng.standard_normal((b, s, h, p))
    return [np.asarray(v, np.float32) for v in (x, bm, cm, dt, a_log, dy)]


def _ref_loop(x, bm, cm, dt, a, chunk=256):
    """The reference's prefill scan (``mamba2_block``, ``ssm.py:228-
    240``): ``_ssd_chunk`` over chunks of min(chunk, S); (y, h_final)."""
    b, s, nh, hp = x.shape
    g, n = bm.shape[2:]
    bh = jnp.repeat(bm, nh // g, axis=2)
    ch = jnp.repeat(cm, nh // g, axis=2)
    c = min(chunk, s)
    h = jnp.zeros((b, nh, hp, n), jnp.float32)
    ys = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        y, h = JSSM._ssd_chunk(x[:, sl], bh[:, sl], ch[:, sl],
                               (dt * a)[:, sl], dt[:, sl], h)
        ys.append(y)
    return jnp.concatenate(ys, 1), h


def _k12_steps(x, bm, cm, dt, a, dy):
    """K12's recurrence in plain float32 PyTorch, formula for formula as
    ``csrc/ssd_scan_bwd.cu`` runs it: the forward states h_t = exp(dt_t
    a) h_{t-1} + dt_t x_t ⊗ B_t, then with g_t = dy_t ⊗ C_t +
    exp(dt_{t+1} a) g_{t+1} backwards: dx_t = dt_t Σ_n g_t B_t, d(dt)_t
    = Σ_p x_t Σ_n g_t B_t + a exp(dt_t a) Σ g_t h_{t-1}, dB_t =
    Σ_{h∈group, p} dt_t x_t g_t, dC_t = Σ_{h∈group, p} dy_t h_t and
    da = Σ_{b,t} dt_t exp(dt_t a) Σ g_t h_{t-1}.  Returns float32 (dx,
    dB, dC, d(dt), da)."""
    b, s, nh, hp = x.shape
    g, n = bm.shape[2], bm.shape[3]
    af, dtf, xf, dyf = a.float(), dt.float(), x.float(), dy.float()
    bh = bm.float().repeat_interleave(nh // g, dim=2)
    ch = cm.float().repeat_interleave(nh // g, dim=2)
    dec = torch.exp(dtf * af)                              # (B, S, H)
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device)
    hs = [h]                                               # h_{-1}, h_0..
    for t in range(s):
        h = dec[:, t, :, None, None] * h + (dtf[:, t, :, None] * xf[:, t]
                                            )[..., None] * bh[:, t, :, None]
        hs.append(h)
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dbh, dch = torch.empty_like(bh), torch.empty_like(ch)
    da = torch.zeros_like(af)
    carry = torch.zeros_like(h)
    for t in reversed(range(s)):
        gt = dyf[:, t, :, :, None] * ch[:, t, :, None] + carry
        carry = dec[:, t, :, None, None] * gt
        gb = (gt * bh[:, t, :, None]).sum(-1)              # (B, H, P)
        gh = (gt * hs[t]).sum((-2, -1))                    # (B, H)
        dx[:, t] = dtf[:, t, :, None] * gb
        ddt[:, t] = (xf[:, t] * gb).sum(-1) + af * dec[:, t] * gh
        dbh[:, t] = (gt * (dtf[:, t, :, None] * xf[:, t])[..., None]).sum(2)
        dch[:, t] = (dyf[:, t, :, :, None] * hs[t + 1]).sum(2)
        da += (dtf[:, t] * dec[:, t] * gh).sum(0)
    dbm = dbh.unflatten(2, (g, nh // g)).sum(3)
    dcm = dch.unflatten(2, (g, nh // g)).sum(3)
    return dx, dbm, dcm, ddt, da


@pytest.mark.parametrize("b,s,h,p,n,g", [(2, 40, 4, 16, 8, 1),
                                         (1, 256, 6, 8, 8, 2),
                                         (1, 200, 3, 12, 8, 1)])
def test_k12_function_matches_reference_vjp(b, s, h, p, n, g):
    """dx, dB, dC, d(dt) and, through a = -exp(A_log), d(A_log) = da · a
    against ``jax.vjp`` of the reference's chunk loop: K12's plain
    version, ``ssd_scan_train``'s autograd and ``_k12_steps``
    (the recurrence K12 runs, formula for formula), SCAN_TOL of each
    gradient's max."""
    x, bm, cm, dt, a_log, dy = _scan_inputs(s + h, b, s, h, p, n, g)

    def ref(x_, b_, c_, dt_, al):
        return _ref_loop(x_, b_, c_, dt_, -jnp.exp(al))[0]
    _, vjp = jax.vjp(ref, *(jnp.asarray(v) for v in (x, bm, cm, dt, a_log)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(v) for v in (x, bm, cm, dt)]
    a = -torch.exp(torch.from_numpy(a_log))
    tdy = torch.from_numpy(dy)
    for got in (K11.ssd_scan_bwd_plain(*t, a, tdy),
                K11.ssd_scan_bwd(*t, a, tdy, None),
                _k12_steps(*t, a, tdy)):
        dx, dbm, dcm, ddt, da = got
        for u, w in zip((dx, dbm, dcm, ddt, da * a), want):
            _close(u, w, SCAN_TOL)
    leaves = [v.clone().requires_grad_(True) for v in t] + \
        [torch.from_numpy(a_log).requires_grad_(True)]
    y = K11.ssd_scan_train(*leaves[:4], -torch.exp(leaves[4]))
    for u, w in zip(torch.autograd.grad(y, leaves, tdy), want):
        _close(u, w, SCAN_TOL)
    assert K11.ssd_scan_bwd_plain(*t, a, tdy, need_da=False)[4] is None


def test_chunk_states_match_reference_prefill_states():
    """``ssd_chunk_states_plain`` on 320 steps holds, at chunks 1..4, the
    states a reference prefill of 64, 128, 192 and 256 steps leaves
    (``_ssd_chunk`` over min(256, S)-step chunks) within SCAN_TOL, and
    a zero first state; ``ssd_scan(chunk_states=True)`` on a CPU tensor
    of 256 steps returns its first four."""
    x, bm, cm, dt, a_log, _ = _scan_inputs(5, 2, 320, 4, 16, 8, 1)
    a = -np.exp(a_log)
    t = [torch.from_numpy(v) for v in (x, bm, cm, dt, a)]
    hc = K11.ssd_chunk_states_plain(*t)
    assert hc.shape == (2, 5, 4, 16, 8) and not hc[:, 0].any()
    for k, steps in enumerate((64, 128, 192, 256), start=1):
        _, want = _ref_loop(*(jnp.asarray(v[:, :steps])
                              for v in (x, bm, cm, dt)), jnp.asarray(a))
        _close(hc[:, k], want, SCAN_TOL)
    _, _, got = K11.ssd_scan(*(v[:, :256] for v in t[:4]), t[4],
                             chunk_states=True)
    assert torch.equal(got, hc[:, :4])


@pytest.mark.parametrize("ring", [False, True])
def test_prefill_packed_matches_reference(models, ring):
    """Rows of 32, 20 and 7 tokens right-padded to Lpad 32, with and
    without a gated bank: each row's last-valid-token logits within
    1e-4, every Mamba-2 layer's conv input within 1e-5 and SSD state
    within SCAN_TOL (the state after the padded width, as the
    reference's ``_pad_cache`` keeps it), the shared block's K/V rows
    within 1e-5 — zero-padded past Lpad, or with rings (window 16 <
    Lpad) each row's own ring — and "pos" the lengths; all relative to
    the largest reference magnitude."""
    jlm, jparams, _, params = models
    lm = LM(_cfgs(5)[1], device="cpu", ring_cache=ring)
    jrl = JLM(jlm.cfg, remat=False, ring_cache=ring)
    lengths, lpad, max_seq = [32, 20, 7], 32, 48
    rng = np.random.default_rng(32)
    toks = rng.integers(3, 259, (len(lengths), lpad)).astype(np.int32)
    jbank, bank = _bank_pair(jlm, (2, 3))
    gates = rng.random((len(lengths), 2)).astype(np.float32)
    for lora in (False, True):
        kw = dict(lora=JLORA.bank_for_model(jbank),
                  gates=jnp.asarray(gates)) if lora else {}
        jl, jc = jrl.prefill_packed(jparams, {"tokens": jnp.asarray(toks)},
                                    np.asarray(lengths), max_seq, **kw)
        tkw = dict(lora=LORA.bank_for_model(bank),
                   gates=torch.from_numpy(gates)) if lora else {}
        logits, cache = lm.prefill_packed(params, torch.from_numpy(toks),
                                          lengths, max_seq, **tkw)
        _close(logits, jl, 1e-4)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        assert cache["attn"]["k"].shape[2] == (16 if ring else max_seq)
        for kind, name, tol in (("inner", "conv", 1e-5),
                                ("inner", "h", SCAN_TOL),
                                ("tail", "conv", 1e-5),
                                ("tail", "h", SCAN_TOL),
                                ("attn", "k", 1e-5), ("attn", "v", 1e-5)):
            _close(cache[kind][name], jc[kind][name], tol)


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
    """``--arch zamba2-7b --local --device cpu`` prints the reference
    launcher's history: clients, clusters, ranks and dropped equal, the
    losses and silhouette within LOSS_TOL."""
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
