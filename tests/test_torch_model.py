"""The port's dense LM vs ``repro.models.model.LM`` on the reduced pair.

Both run in float32 on the CPU from the same (bridged) parameters: a
prefill, then 16 greedy decode steps, each model following its own
argmax.  Tolerance 1e-4 on logits: a 2-layer model accumulates the
1e-6-level reordering differences of its f32 matmuls and softmaxes;
the greedy tokens must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.models.model import LM
from _threads import one_thread  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 48


@pytest.mark.parametrize("name,key", [("floe-slm-2b", 0), ("floe-llm-7b", 1)])
def test_prefill_and_16_greedy_decode_steps(name, key):
    cfg = get_config(name).reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(key))
    lm = LM(cfg, device="cpu")
    params = bridge.from_numpy(jax.device_get(jparams))

    prompt = np.random.default_rng(key).integers(3, 259, (1, 23))
    jlogits, jcache = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, MAX_SEQ))(jparams, jnp.asarray(prompt, jnp.int32))
    logits, cache = lm.prefill(params, torch.from_numpy(prompt), MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)
    assert cache["pos"] == int(jcache["pos"]) == 23

    jstep = jax.jit(jlm.decode_step)
    jtoks, ttoks = [], []
    for _ in range(16):
        jt = int(jnp.argmax(jlogits[0, -1]))
        tt = int(torch.argmax(logits[0, -1]))
        jtoks.append(jt)
        ttoks.append(tt)
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray([[jt]], jnp.int32))
        logits, cache = lm.decode_step(params, cache,
                                       torch.tensor([[tt]]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    assert ttoks == jtoks
    assert cache["pos"] == int(jcache["pos"]) == 23 + 16
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-4)


PACKED_MAX_SEQ = 96
PS = 16


def _pair_model(name, key):
    cfg = get_config(name).reduced()
    jlm = JLM(cfg, remat=False)
    jparams = jlm.init(jax.random.key(key))
    return jlm, jparams, LM(cfg, device="cpu"), bridge.from_numpy(
        jax.device_get(jparams))


@pytest.mark.parametrize("name,key", [("floe-slm-2b", 0), ("floe-llm-7b", 1)])
def test_prefill_packed_ragged(name, key):
    """Packed ragged prefill at B=3: per-row last-valid-token logits and
    every valid cache row equal the reference's (slice-1 tolerances);
    per-row positions are the lengths."""
    jlm, jparams, lm, params = _pair_model(name, key)
    lengths = np.array([23, 9, 30], np.int32)
    toks = np.zeros((3, 32), np.int64)
    rng = np.random.default_rng(key + 10)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(3, 259, n)
    jlogits, jcache = jax.jit(lambda p, t, n: jlm.prefill_packed(
        p, {"tokens": t}, n, PACKED_MAX_SEQ))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
    logits, cache = _prefill_dense(lm, params, toks, lengths)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    for i, n in enumerate(lengths):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                cache[leaf][:, i, :n], np.asarray(jcache[leaf])[:, i, :n],
                rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jcache["pos"]), lengths)


def _prefill_dense(lm, params, toks, lengths):
    """``prefill_packed`` with a ``write_kv`` hook that collects each
    layer's K/V into dense (L, B, Lpad, KV, hd) numpy arrays."""
    kv = {"k": [], "v": []}

    def write(i, k, v):
        assert i == len(kv["k"])
        kv["k"].append(k.numpy().copy())
        kv["v"].append(v.numpy().copy())
    logits = lm.prefill_packed(params, torch.from_numpy(toks), lengths,
                               PACKED_MAX_SEQ, write)
    return logits, {n: np.stack(a) for n, a in kv.items()}


def _to_pool(dense, tables, n_pool):
    """Scatter a dense (L, B, S, KV, hd) cache into an (L, n_pool, ps,
    KV, hd) pool along the rows' block tables."""
    n_layers, _, s_len = dense.shape[:3]
    pool = np.zeros((n_layers, n_pool, PS) + dense.shape[3:], dense.dtype)
    pages = dense.reshape(n_layers, dense.shape[1], s_len // PS, PS,
                          *dense.shape[3:])
    for b, row in enumerate(tables):
        for j, pid in enumerate(row):
            if pid < n_pool:
                pool[:, pid] = pages[:, b, j]
    return pool


@pytest.mark.parametrize("parked", [3, 0])
@pytest.mark.parametrize("name,key", [("floe-slm-2b", 0), ("floe-llm-7b", 1)])
def test_paged_decode_steps_match_reference(name, key, parked):
    """16 paged decode steps with per-row positions and one parked row
    (pos = FREED_POS, table all NO_PAGE; the last row or the first)
    against the reference's ``decode_step`` on the same pools and
    tables: the live rows' logits every step, greedy tokens, positions
    and the live rows' pool pages."""
    from repro_torch.models.attention import FREED_POS
    jlm, jparams, lm, params = _pair_model(name, key)
    lengths = np.array([23, 9, 30, 1], np.int32)
    rng = np.random.default_rng(key + 20)
    toks = np.zeros((4, 32), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(3, 259, n)
    jlogits, jdense = jax.jit(lambda p, t, n: jlm.prefill_packed(
        p, {"tokens": t}, n, PACKED_MAX_SEQ))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths))
    logits, dense = _prefill_dense(lm, params, toks, lengths)
    pad = lambda a: np.pad(a, [(0, 0), (0, 0), (0, PACKED_MAX_SEQ - 32),
                               (0, 0), (0, 0)])
    nb, n_pool = PACKED_MAX_SEQ // PS, 20
    free = list(np.random.default_rng(1).permutation(n_pool))
    tables = np.full((4, nb), 1 << 20, np.int32)
    live_rows = [i for i in range(4) if i != parked]
    for i in live_rows:
        for j in range(-(-(int(lengths[i]) + 16) // PS)):
            tables[i, j] = free.pop()
    pos = lengths.copy()
    pos[parked] = FREED_POS
    jcache = {"k": jnp.asarray(_to_pool(np.asarray(jdense["k"]), tables,
                                        n_pool)),
              "v": jnp.asarray(_to_pool(np.asarray(jdense["v"]), tables,
                                        n_pool)),
              "pos": jnp.asarray(pos), "block": jnp.asarray(tables)}
    sink = lambda a: np.concatenate([a, np.zeros_like(a[:, :1])], 1)
    cache = {"k": torch.from_numpy(sink(_to_pool(pad(dense["k"]), tables,
                                                 n_pool))),
             "v": torch.from_numpy(sink(_to_pool(pad(dense["v"]), tables,
                                                 n_pool))),
             "pos": torch.from_numpy(pos.copy()),
             "pos_host": pos.astype(np.int64),
             "block": torch.from_numpy(tables)}
    jstep = jax.jit(jlm.decode_step)
    for _ in range(16):
        jt = np.asarray(jnp.argmax(jlogits[:, -1], -1))
        tt = torch.argmax(logits[:, -1], -1).numpy()
        np.testing.assert_array_equal(tt[live_rows], jt[live_rows])
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray(jt[:, None], jnp.int32))
        logits, cache = lm.decode_step(params, cache,
                                       torch.from_numpy(tt[:, None]))
        np.testing.assert_allclose(logits[live_rows].numpy(),
                                   np.asarray(jlogits)[live_rows],
                                   **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(cache["pos_host"], np.asarray(jcache["pos"]))
    assert cache["pos_host"][parked] == FREED_POS
    live = sorted(int(p) for p in tables[live_rows].ravel() if p < n_pool)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf][:, live].numpy(),
                                   np.asarray(jcache[leaf])[:, live],
                                   rtol=1e-4, atol=1e-4)
