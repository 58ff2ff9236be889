"""The port's merged multi-LoRA path vs the JAX package's, on the CPU.

* K5/K4 plain versions (``kernels/moe_lora/kernel.py``) against
  ``repro.kernels.moe_lora.ref`` and the Pallas kernels in interpret
  mode, as ``tests/test_kernels.py`` runs them: negative slots exactly
  0, repeated slots, (E,) and (B, E) gates, ``rows_per_gate``.
* ``layers.lora_delta`` / ``linear`` / ``mlp`` against
  ``repro.models.layers`` for float and integer gates.
* ``core/lora.py`` against ``repro.core.lora``: ``empty_bank``,
  ``write_slot``, ``slot_gates``, ``stack_adapters``, ``adapter_of``,
  and the bridge carrying adapter trees and banks across exactly.

Inputs come from a numpy seed, float32.  Tolerance 1e-5 relative (and
absolute at the scale of the outputs): the same f32 arithmetic summed
in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import lora as JLORA
from repro.kernels.moe_lora.kernel import moe_lora_delta as pallas_k5
from repro.kernels.moe_lora.kernel import moe_lora_delta_slots as pallas_k4
from repro.kernels.moe_lora.ref import (moe_lora_delta_ref,
                                        moe_lora_delta_slots_ref)
from repro.models import layers as JL
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.core import lora as LORA
from repro_torch.kernels.moe_lora import kernel as K
from repro_torch.models import layers as L
from repro_torch.models.model import LM
from _threads import one_thread  # noqa: F401

RTOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _bank(rng, t, k, e, r, n):
    x = rng.standard_normal((t, k)).astype(np.float32)
    a = (rng.standard_normal((e, r, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((e, n, r)).astype(np.float32)
    return x, a, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("t,k,e,r,n", [(8, 64, 4, 16, 48), (32, 128, 2, 4, 96),
                                       (16, 256, 3, 8, 40)])
def test_k5_plain_matches_reference_and_pallas(t, k, e, r, n):
    rng = np.random.default_rng(t + k)
    x, a, b = _bank(rng, t, k, e, r, n)
    g = rng.random((t, e)).astype(np.float32)
    g[1] = np.eye(e, dtype=np.float32)[e - 1]          # a one-hot row
    g[2] = 0.0                                          # an all-zero row
    got = K.moe_lora_delta(*_t(x, a, b, g))
    assert got.dtype == torch.float32 and got.shape == (t, n)
    _close(got, moe_lora_delta_ref(*map(jnp.asarray, (x, a, b, g))))
    _close(got, pallas_k5(*map(jnp.asarray, (x, a, b, g)), block_t=8,
                          interpret=True))
    assert not got[2].any()


@pytest.mark.parametrize("gate_rows", [1, 4])
def test_k5_rows_per_gate_shares_one_gate_row(gate_rows):
    """(G, E) gates over T = G x S rows: row t takes gate row t // S —
    a prefill's (B, E) request gates over its S positions, or (E,)
    global gates over every row (G = 1)."""
    rng = np.random.default_rng(gate_rows)
    t, s = 24, 24 // gate_rows
    x, a, b = _bank(rng, t, 64, 3, 4, 32)
    g = rng.random((gate_rows, 3)).astype(np.float32)
    got = K.moe_lora_delta(*_t(x, a, b, g), rows_per_gate=s)
    full = np.repeat(g, s, axis=0)
    _close(got, moe_lora_delta_ref(*map(jnp.asarray, (x, a, b, full))))
    with pytest.raises(ValueError):
        K.moe_lora_delta(*_t(x, a, b, g), rows_per_gate=s + 1)


@pytest.mark.parametrize("rows_per_gate", [64, 100])
def test_k5_plain_admission_one_hot_and_zero_gate_rows(rows_per_gate):
    """T >= 64 rows under (G, E) gates, as an admission prefill hands
    them over: a one-hot row (an adapter slot), an all-zero row (no
    adapter) and a soft row with one zero gate.  Against the reference
    and interpret-mode Pallas with each gate row repeated over its rows;
    the all-zero row's outputs are exactly 0, and a zero gate gives the
    result of the bank without that expert."""
    rng = np.random.default_rng(rows_per_gate)
    t = 3 * rows_per_gate
    x, a, b = _bank(rng, t, 64, 4, 4, 40)
    g = np.zeros((3, 4), np.float32)
    g[0, 2] = 1.0
    g[2] = rng.random(4) + 0.1
    g[2, 1] = 0.0
    got = K.moe_lora_delta(*_t(x, a, b, g), rows_per_gate=rows_per_gate)
    full = np.repeat(g, rows_per_gate, axis=0)
    _close(got, moe_lora_delta_ref(*map(jnp.asarray, (x, a, b, full))))
    _close(got, pallas_k5(*map(jnp.asarray, (x, a, b, full)),
                          block_t=rows_per_gate, interpret=True))
    assert not got[rows_per_gate:2 * rows_per_gate].any()
    keep = [0, 2, 3]
    without = K.moe_lora_delta(*_t(x, a[keep], b[keep], g[:, keep]),
                               rows_per_gate=rows_per_gate)
    _close(got[2 * rows_per_gate:], without[2 * rows_per_gate:])


def test_k4_plain_matches_reference_and_pallas():
    """Repeated slots and adapter-free rows; those rows exactly 0."""
    rng = np.random.default_rng(4)
    x, a, b = _bank(rng, 8, 128, 4, 16, 64)
    slots = np.asarray([0, 1, 2, 3, -1, 0, 2, -1], np.int32)
    got = K.moe_lora_delta_slots(*_t(x, a, b, slots))
    assert got.dtype == torch.float32 and got.shape == (8, 64)
    _close(got, moe_lora_delta_slots_ref(*map(jnp.asarray,
                                              (x, a, b, slots))))
    _close(got, pallas_k4(*map(jnp.asarray, (x, a, b, slots)),
                          interpret=True))
    assert torch.equal(got[slots < 0], torch.zeros(2, 64))
    # K5 on the same rows' one-hot gates
    gates = JLORA.slot_gates(slots.tolist(), 4)
    _close(got, K.moe_lora_delta(*_t(x, a, b, gates)))


def test_k4_clamps_slots_past_the_bank_as_pallas():
    rng = np.random.default_rng(5)
    x, a, b = _bank(rng, 4, 64, 2, 4, 16)
    slots = np.asarray([5, 1, -3, 2], np.int32)
    got = K.moe_lora_delta_slots(*_t(x, a, b, slots))
    _close(got, pallas_k4(*map(jnp.asarray, (x, a, b, slots)),
                          interpret=True))


def test_k4_rows_per_slot():
    rng = np.random.default_rng(6)
    x, a, b = _bank(rng, 12, 64, 3, 4, 16)
    slots = np.asarray([2, -1, 0], np.int32)
    got = K.moe_lora_delta_slots(*_t(x, a, b, slots), rows_per_slot=4)
    want = moe_lora_delta_slots_ref(*map(jnp.asarray, (
        x, a, b, np.repeat(slots, 4))))
    _close(got, want)


# ------------------------------------------------------------------ layers
def _lora_leaf(rng, e, r, din, dout):
    return {"A": (rng.standard_normal((e, r, din)) / np.sqrt(din)
                  ).astype(np.float32),
            "B": rng.standard_normal((e, dout, r)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


GATES = {
    "per_request": lambda rng, b, e: rng.random((b, e)).astype(np.float32),
    "global": lambda rng, b, e: rng.random(e).astype(np.float32),
    "none": lambda rng, b, e: None,
    "slots": lambda rng, b, e: np.asarray([1, -1, 0][:b], np.int32),
}


@pytest.mark.parametrize("kind", sorted(GATES))
@pytest.mark.parametrize("s", [1, 5])
def test_linear_and_lora_delta_match_reference(kind, s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((3, s, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    lora = _lora_leaf(rng, 2, 4, 64, 48)
    g = GATES[kind](rng, 3, 2)
    jg = None if g is None else jnp.asarray(g)
    tg = None if g is None else torch.from_numpy(g)
    want = JL.linear({"w": jnp.asarray(w)}, jnp.asarray(x), _j(lora), jg)
    got = L.linear({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                   bridge.from_numpy(lora), tg)
    _close(got, want)
    _close(L.lora_delta(bridge.from_numpy(lora), torch.from_numpy(x), tg),
           JL.lora_delta(_j(lora), jnp.asarray(x), jg))


@pytest.mark.parametrize("kind", ["per_request", "slots"])
def test_mlp_matches_reference(kind):
    cfg = get_config("floe-slm-2b").reduced()
    rng = np.random.default_rng(7)
    d, f = cfg.d_model, cfg.d_ff
    p = {"in": {"w": (rng.standard_normal((d, 2 * f)) / np.sqrt(d)
                      ).astype(np.float32)},
         "out": {"w": (rng.standard_normal((f, d)) / np.sqrt(f)
                       ).astype(np.float32)}}
    lin, lout = _lora_leaf(rng, 2, 4, d, 2 * f), _lora_leaf(rng, 2, 4, f, d)
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    g = GATES[kind](rng, 3, 2)
    want = JL.mlp(cfg, _j(p), jnp.asarray(x), _j(lin), _j(lout),
                  jnp.asarray(g))
    got = L.mlp(cfg, bridge.from_numpy(p), torch.from_numpy(x),
                bridge.from_numpy(lin), bridge.from_numpy(lout),
                torch.from_numpy(g))
    _close(got, want)


def test_rank_mask_leaf_raises():
    """A rank_mask leaf is applied (``test_torch_train.py`` holds it to
    the reference); one that does not fit the bank's (E, r) raises."""
    rng = np.random.default_rng(8)
    lora = bridge.from_numpy(_lora_leaf(rng, 2, 4, 16, 8))
    lora["rank_mask"] = torch.ones(2, 3)
    with pytest.raises(ValueError, match="rank_mask"):
        L.lora_delta(lora, torch.zeros(1, 16), torch.ones(1, 2))
    lora["rank_mask"] = torch.ones(2, 4)
    assert L.lora_delta(lora, torch.zeros(1, 16), torch.ones(1, 2)).shape \
        == (1, 8)


# ---------------------------------------------------------------- core/lora
@pytest.fixture(scope="module")
def models():
    cfg = get_config("floe-slm-2b").reduced()
    return JLM(cfg, remat=False), LM(cfg, device="cpu")


def _adapter(jlm, seed, scale=0.5):
    """A reference adapter with random B (init_adapter zeroes B)."""
    ad = JLORA.init_adapter(jlm, jax.random.key(seed), rank=2)
    rng = np.random.default_rng(seed)
    out = jax.device_get(ad)
    for leaf in out["layers"].values():
        leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                     ).astype(np.float32)
    return out


def _same_tree(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _same_tree(got[key], want[key])
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))


def test_layout_and_init_adapter_law(models):
    jlm, lm = models
    assert lm.lora_layout() == jlm.lora_layout()
    ad = LORA.init_adapter(lm, 3, rank=2)
    jad = jax.device_get(JLORA.init_adapter(jlm, jax.random.key(3), rank=2))
    for tgt, leaf in jad["layers"].items():
        got = ad["layers"][tgt]
        assert got["A"].shape == leaf["A"].shape
        assert got["B"].shape == leaf["B"].shape and not got["B"].any()
        assert not got["A"][:, 2:].any() and got["A"][:, :2].all()
        din = leaf["A"].shape[-1]
        assert abs(got["A"][:, :2].std().item() * np.sqrt(din / 2) - 1) < 0.2
    assert int(ad["_rank"]) == int(jad["_rank"]) == 2


def test_slot_bank_ops_match_reference(models):
    jlm, lm = models
    ads = [_adapter(jlm, s) for s in (11, 12)]
    jbank = JLORA.empty_bank(jlm, 3)
    bank = LORA.empty_bank(lm, 3)
    _same_tree(bridge.to_numpy(bank), jax.device_get(jbank))
    for slot, ad in ((2, ads[0]), (0, ads[1]), (2, ads[1])):
        jbank = JLORA.write_slot(jbank, _j(ad), slot)
        assert LORA.write_slot(bank, bridge.from_numpy(ad), slot) is bank
    _same_tree(bridge.to_numpy(bank), jax.device_get(jbank))
    for j in range(3):
        _same_tree(bridge.to_numpy(LORA.adapter_of(bank, j)),
                   jax.device_get(JLORA.adapter_of(jbank, j)))
    assert set(LORA.bank_for_model(bank)) == {"layers"}
    slots = [1, None, -1, 0, 2, 1]
    np.testing.assert_array_equal(LORA.slot_gates(slots, 3),
                                  JLORA.slot_gates(slots, 3))


def test_stack_adapters_and_bridge_round_trip(models):
    jlm, _ = models
    ads = [_adapter(jlm, s) for s in (21, 22, 23)]
    jbank = jax.device_get(JLORA.stack_adapters([_j(a) for a in ads]))
    bank = LORA.stack_adapters([bridge.from_numpy(a) for a in ads])
    _same_tree(bridge.to_numpy(bank), jbank)
    # the bridge carries banks and adapters across and back exactly
    _same_tree(bridge.to_numpy(bridge.from_numpy(jbank)), jbank)
    _same_tree(bridge.to_numpy(bridge.from_numpy(ads[0])), ads[0])
    assert bridge.from_numpy(jbank)["_ranks"].dtype == torch.int32
