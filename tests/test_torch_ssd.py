"""The port's Mamba-2 / SSD path vs the JAX package's, on the reduced
zamba2 (d 256, d_inner 512, 32 SSD heads of 16, N 8, one group), float32
on the CPU, from the same inputs (numpy seeds) and the same (bridged)
parameters.

* K11's plain version ``ssd_scan_plain`` against the reference's chunk
  loop over ``_ssd_chunk`` (chunk 256, as ``mamba2_block`` drives it) at
  S 1, 7, 256 and 512, with one and two groups; ``ssd_scan`` on a CPU
  tensor is the plain version, and reads strided column slices.
  Tolerance SCAN_TOL = 1e-4, relative and of the largest reference
  magnitude (``_close``): the same f32 chunk form, whose state update and
  intra-chunk product sum 256 products a chunk in another library's
  order (read up to 3.2e-5 of h_final's max at S 512).
* ``ssd_scan_train``'s gradients against ``jax.vjp`` of the reference's
  chunk loop, 1e-5 of each gradient's max.
* ``mamba2_block`` in prefill, decode and train mode against the
  reference's, without LoRA and with a two-expert bank on ssm_in and
  ssm_out (gate rows; integer slots at decode, the slot kernel's path),
  output and state at 1e-5 (``_close``).
* The 256-token chunk rule: 300 tokens refused by both packages, 512
  accepted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ssm as JSSM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.ssd_scan import kernel as K11
from repro_torch.models import ssm as SSM
from _threads import one_thread  # noqa: F401

ARCH = "zamba2-7b"
TOL = 1e-5
SCAN_TOL = 1e-4


def _close(got, want, tol=TOL):
    """rtol ``tol`` and atol ``tol`` times the largest |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def scan_inputs(seed, b, s, h, p, n, g):
    """numpy x (b, s, h, p), bm/cm (b, s, g, n), dt (b, s, h) a softplus,
    a (h,) = -exp(.), as the block hands them to the scan."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    bm = rng.standard_normal((b, s, g, n)) * 0.5
    cm = rng.standard_normal((b, s, g, n)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
    a = -np.exp(rng.standard_normal(h) * 0.5)
    return [np.asarray(v, np.float32) for v in (x, bm, cm, dt, a)]


def ref_scan(x, bm, cm, dt, a, chunk=256):
    """The reference's SSD loop (``mamba2_block``'s prefill, ``ssm.py:
    228-240``): groups repeated to heads, ``_ssd_chunk`` over chunks of
    min(chunk, S) from a zero state."""
    b, s, nh, hp = x.shape
    g, n = bm.shape[2:]
    bh = jnp.repeat(bm, nh // g, axis=2)
    ch = jnp.repeat(cm, nh // g, axis=2)
    logdec = dt * a
    c = min(chunk, s)
    h = jnp.zeros((b, nh, hp, n), jnp.float32)
    ys = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        y, h = JSSM._ssd_chunk(x[:, sl], bh[:, sl], ch[:, sl], logdec[:, sl],
                               dt[:, sl], h)
        ys.append(y)
    return jnp.concatenate(ys, axis=1), h


@pytest.mark.parametrize("s", [1, 7, 256, 512])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_plain_matches_reference_chunk_loop(s, g):
    args = scan_inputs(s + g, 2, s, 4, 16, 8, g)
    jy, jh = ref_scan(*map(jnp.asarray, args))
    y, h = K11.ssd_scan_plain(*map(torch.from_numpy, args))
    _close(y, jy, SCAN_TOL)
    _close(h, jh, SCAN_TOL)


def test_ssd_scan_on_cpu_is_the_plain_version():
    """``ssd_scan`` on CPU tensors runs the plain version (no launch), on
    x, B and C as strided column slices of one conv-like output; shapes
    that do not fit raise."""
    x, _, _, dt, a = scan_inputs(3, 2, 40, 4, 16, 8, 1)
    conv = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 40, 64 + 16)).astype(np.float32))
    xs = conv[..., :64].unflatten(-1, (4, 16))
    bs = conv[..., 64:72].unflatten(-1, (1, 8))
    cs = conv[..., 72:].unflatten(-1, (1, 8))
    assert not xs.is_contiguous() and not bs.is_contiguous()
    before = K11.ssd_scan.launches
    y, h = K11.ssd_scan(xs, bs, cs, torch.from_numpy(dt),
                        torch.from_numpy(a))
    assert K11.ssd_scan.launches == before
    ry, rh = K11.ssd_scan_plain(xs.contiguous(), bs.contiguous(),
                                cs.contiguous(), torch.from_numpy(dt),
                                torch.from_numpy(a))
    assert torch.equal(y, ry) and torch.equal(h, rh)
    with pytest.raises(ValueError):
        K11.ssd_scan(xs, bs, cs, torch.from_numpy(dt)[:, :, :3],
                     torch.from_numpy(a))
    with pytest.raises(ValueError):           # 3 groups do not divide 4
        K11.ssd_scan(xs, bs.expand(-1, -1, 3, -1), cs.expand(-1, -1, 3, -1),
                     torch.from_numpy(dt), torch.from_numpy(a))


def test_ssd_scan_train_gradients_match_jax_vjp():
    args = scan_inputs(9, 2, 64, 4, 16, 8, 1)
    dy = np.random.default_rng(10).standard_normal(
        args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: ref_scan(*t)[0], *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    y = K11.ssd_scan_train(*ts)
    y.backward(torch.from_numpy(dy))
    for t, w in zip(ts, want):
        _close(t.grad, w)


@pytest.fixture(scope="module")
def block():
    """One Mamba-2 block of the reduced zamba2 at the reference's init
    law, both packages."""
    from repro.models import layers as JL
    cfg = get_config(ARCH).reduced()
    jp = jax.device_get(JL.materialize(JSSM.mamba2_spec(cfg),
                                       jax.random.key(1), jnp.float32))
    # nonzero biases and decays that differ by head
    rng = np.random.default_rng(2)
    h = cfg.ssm_nheads
    jp = dict(jp, dt_bias=(rng.standard_normal(h) * 0.3).astype(np.float32),
              A_log=(rng.standard_normal(h) * 0.5).astype(np.float32),
              conv_b=(rng.standard_normal(jp["conv_b"].shape) * 0.1
                      ).astype(np.float32))
    return cfg, jp, bridge.from_numpy(jp)


def _lora(cfg, seed):
    """A two-expert bank on ssm_in and ssm_out (E, r, d_in) / (E, d_out,
    r), both packages."""
    rng = np.random.default_rng(seed)
    di = cfg.d_inner
    proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    out = {}
    for tgt, (din, dout) in {"ssm_in": (cfg.d_model, proj),
                             "ssm_out": (di, cfg.d_model)}.items():
        out[tgt] = {"A": (rng.standard_normal((2, 4, din)) / din ** 0.5
                          ).astype(np.float32),
                    "B": (rng.standard_normal((2, dout, 4)) * 0.3
                          ).astype(np.float32)}
    return jax.tree.map(jnp.asarray, out), bridge.from_numpy(out)


@pytest.mark.parametrize("with_lora", [False, True])
def test_mamba2_block_prefill_decode_and_train(block, with_lora):
    """Prefill 20 positions, then 3 decode steps under the prefill's gate
    rows and (with a bank) under integer slots; train mode's output; all
    against the reference's ``mamba2_block``."""
    cfg, jp, tp = block
    x = np.random.default_rng(5).standard_normal((2, 23, cfg.d_model))
    x = x.astype(np.float32)
    jl = tl = jg = tg = None
    if with_lora:
        jl, tl = _lora(cfg, 6)
        gates = np.asarray([[0.7, 0.3], [0.0, 1.0]], np.float32)
        jg, tg = jnp.asarray(gates), torch.from_numpy(gates)
    jy, jc = JSSM.mamba2_block(cfg, jp, jnp.asarray(x[:, :20]),
                               mode="prefill", lora=jl, gates=jg)
    y, c = SSM.mamba2_block(cfg, tp, torch.from_numpy(x[:, :20]),
                            mode="prefill", lora=tl, gates=tg)
    _close(y, jy)
    for k in ("conv", "h"):
        _close(c[k], jc[k])
    if with_lora:
        plain, _ = SSM.mamba2_block(cfg, tp, torch.from_numpy(x[:, :20]),
                                    mode="prefill")
        assert not torch.allclose(plain, y)   # the bank is at work
    modes = [(jg, tg)]
    if with_lora:
        slots = np.asarray([1, -1], np.int32)
        modes.append((jnp.asarray(slots), torch.from_numpy(slots)))
    for jgg, tgg in modes:
        jcc, cc = jc, {k: v.clone() for k, v in c.items()}
        for t in range(20, 23):
            jy, jcc = JSSM.mamba2_block(cfg, jp, jnp.asarray(x[:, t:t + 1]),
                                        cache=jcc, mode="decode", lora=jl,
                                        gates=jgg)
            y, cc = SSM.mamba2_block(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                     cache=cc, mode="decode", lora=tl,
                                     gates=tgg)
            _close(y, jy)
            for k in ("conv", "h"):
                _close(cc[k], jcc[k])
    jy, _ = JSSM.mamba2_block(cfg, jp, jnp.asarray(x), mode="train",
                              lora=jl, gates=jg)
    y, state = SSM.mamba2_block(cfg, tp, torch.from_numpy(x), mode="train",
                                lora=tl, gates=tg)
    assert state is None
    _close(y.detach(), jy)


def test_chunk_rule_is_kept(block):
    """300 positions: the reference's scan asserts S % min(256, S) == 0
    and the port raises ValueError; 512 (two chunks) is served by both
    with equal outputs and states."""
    cfg, jp, tp = block
    x = np.random.default_rng(7).standard_normal((1, 512, cfg.d_model))
    x = x.astype(np.float32)
    with pytest.raises(AssertionError):
        JSSM.mamba2_block(cfg, jp, jnp.asarray(x[:, :300]), mode="prefill")
    with pytest.raises(ValueError, match="chunk 256"):
        SSM.mamba2_block(cfg, tp, torch.from_numpy(x[:, :300]),
                         mode="prefill")
    jy, jc = JSSM.mamba2_block(cfg, jp, jnp.asarray(x), mode="prefill")
    y, c = SSM.mamba2_block(cfg, tp, torch.from_numpy(x), mode="prefill")
    _close(y, jy)
    _close(c["h"], jc["h"])
    assert tget_config(ARCH).ssm_nheads == get_config(ARCH).ssm_nheads == 112
