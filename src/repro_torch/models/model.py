"""The language model — the port of ``repro/models/model.py`` for the
dense family (the plain layout, [attn, mlp] x L with every layer
global, and the grouped 5:1 sliding/global layout of gemma3) and the
Mamba-1 SSM family ([mamba1] x L, falcon-mamba).

Parameters are the reference's tree (``LM.param_specs``) as nested dicts
of tensors, so ``bridge.py`` maps a JAX tree onto it leaf for leaf:
per-layer leaves stacked on a leading layer axis under ``"layers"``, or,
in the grouped layout, ``"inner"`` (n_groups, g - 1, ...) local layers,
``"global_layers"`` (n_groups, ...) and a ``"tail"`` (tail, ...) of local
layers.  A layer runs in the reference's order (``group_step``): in
each group its g - 1 local layers, then its global layer; after the
groups, the tail.  ``layer_sites`` lists the layers in that order
with the address of their cache leaves (``cache_kv``).

Two cache forms, both written in place by decode (the reference
returns an updated copy, which the port saves):

* dense: {"k", "v": (L, B, max_seq, KV, hd), "pos": int} — every row
  at one depth, the sequential engine.  The grouped layout keeps
  {"inner", "tail", "global": {"k", "v"}} instead, each with its stack
  dims in front; with ``LM(ring_cache=True)`` the local leaves hold
  min(max_seq, window) slots, a ring written at position % window;
* a dense lane of the batched engine (built by the deployment): the
  dense tree with "pos": (B,) int32 per-row depths on the device,
  "pos_host": its host mirror, and on CUDA "ident": the identity tables
  through which K2 reads the rows as pages;
* paged (a lane of the batched engine, built by the deployment): the
  same tree with each leaf's (B, S) replaced by a page pool (P + 1, ps)
  whose last page is the write sink, "block": (B, nb) int32 block
  table, "local": (B, nl) ring-local table when the local leaves are
  rings, "pos": (B,) int32 on the device, "pos_host": its host mirror.
  The host mirror is validated before each dispatch, so no layer syncs
  with the device.

The SSM family keeps one cache form: {"conv": (L, B, k-1, d_inner) in
the model dtype, "h": (L, B, d_inner, N) float32, "pos": int, or (B,)
per-row lengths after a packed prefill}; its prefill scan runs K6
(``models/ssm.py``).

The hybrid family (zamba2, the reference's ``model.py:250-263`` layout):
n_groups = L // attn_every groups, each of attn_every - 1 Mamba-2 layers
(each with an MLP) under ``"inner"`` (n_groups, g - 1, ...) and then ONE
attention block whose weights, ``"shared_attn"`` (no stack dims), every
group shares; after the groups a ``"tail"`` (tail, ...) of Mamba-2
layers, which may be empty.  The shared block is the group's LayerSite
with ``stack`` "shared_attn" and an empty ``idx``: its LoRA is the
group's slice of the ``"special"`` stack (``lora_idx``) and its cache
the group's slice of ``"attn"``, so the weights are shared and the
adapters and caches are not.  The cache: {"inner", "tail": {"conv",
"h"}} with their stack dims in front ("h" (..., B, H, P, N) float32),
"attn": {"k", "v": (n_groups, B, S_a, KV, hd)} with S_a = min(max_seq,
window) when ``ring_cache`` is set (a ring written at pos % window),
max_seq otherwise, and "pos": int.  Its prefill scan runs K11 and its
attention prefill K3 (``attn_type`` "sliding": the block attends within
its window, which is longer than any prompt the port serves).  The
engines serve it through ``SoloEngine``; the batched engine, suffix
prefill and speculative rollback refuse it, as the reference does, and
its packed prefill is a later slice.

Every entry point takes an optional merged-LoRA bank (``lora``, the
``core/lora.py`` tree without metadata: {stack: {target: {"A"
(*dims, E, r, d_in), "B" (*dims, E, d_out, r)}}} over the stacks of
``lora_layout``) and its ``gates``; a layer reads its slice of every
leaf, as the reference's layer scans do.

The prefix history API of the dense family (the reference's
``model.py:952-1100``): ``build_prefix`` prefills a shared preamble once
(B=1) into a HISTORY — the cache tree's leaves over its P positions,
linear even where the cache keeps rings, with "len" = P;
``prefill_suffix`` prefills ragged suffixes of every row at positions
P + i against it; ``extend_history`` appends a chunk's fresh K/V;
``prefix_page_rows`` and ``suffix_page_rows`` give the page content of
the shared pages and of each row's own pages (``suffix_rows`` per
leaf, which the deployment's page writers stream layer by layer).

The speculative rollback of a lane cache (the reference's
``model.py:827-950``): ``spec_snapshot`` copies the k decode-write
targets [pos0, pos0 + k) of every KV leaf before a draft/verify burst,
and ``spec_restore`` puts back every target at or past a row's accepted
count, in place, so a rejected draft suffix leaves the cache as if it
was never decoded.  Both follow the decode write path's slot arithmetic
(a full-length leaf writes slot p, a ring slot p % window, a paged leaf
through the row's block or local table; parked rows never wrote); a
write the reference drops goes to the pool's sink page, or on a dense
lane rewrites the current value of a slot no other write of the call
touches.  Neither copies from the host, so both run inside a CUDA graph.

``train_logits`` is the full-sequence causal forward of training (the
reference's ``model.py:650-665``) for every ported layout: the plain
and grouped dense layouts (gemma3's local layers within their window)
and the Mamba-1 SSM family.  It runs outside ``torch.inference_mode``
(which the serving entry points keep), so gradients reach a LoRA bank
(or the parameters) through K3/K8, K6/K10 and K5/K9 on CUDA and through
the plain versions on the CPU.

The MoE, MLA, audio and vision layouts, the all-sliding dense layout,
qkv biases and untied embeddings of a dense model are later slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core import tree as T
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# cache kinds of the grouped layout that hold local (window) layers
LOCAL_KINDS = ("inner", "tail")


def _leaf(shape, init: str = "fan_in", scale: float = 1.0):
    return (tuple(shape), init, scale)


class LayerSite(NamedTuple):
    """One layer, in the order the stack runs it: ``addr`` addresses its
    cache leaves (``cache_kv``; an SSM's conv and scan state at the same
    index), ``stack``/``lora`` name its parameter and LoRA stacks,
    ``idx`` its index in both (in the LoRA stack ``lora_idx`` instead
    when it is given: the hybrid's shared block, whose parameters have no
    stack dims), ``is_global`` whether it attends globally and ``ssm``
    whether it is a state-space layer."""
    addr: Union[int, Tuple[str, Tuple[int, ...]]]
    stack: str
    lora: str
    idx: Tuple[int, ...]
    is_global: bool
    lora_idx: Optional[Tuple[int, ...]] = None
    ssm: bool = False

    @property
    def lora_at(self) -> Tuple[int, ...]:
        """The layer's index in its LoRA stack."""
        return self.idx if self.lora_idx is None else self.lora_idx


def cache_kv(cache, addr, name: str) -> torch.Tensor:
    """Layer ``addr``'s ``name`` ("k" or "v"; an SSM's "conv" or "h")
    leaf of a dense cache or a paged lane cache, a view: cache[name][i]
    for the plain layout's integer address, cache[kind][name][idx] for a
    grouped layout's (kind, idx)."""
    if isinstance(addr, tuple):
        kind, idx = addr
        return cache[kind][name][idx]
    return cache[name][addr]


def dense_layer(cfg, p, x, *, positions, mode, cache, pages=None,
                ident=None, host_pos=None, lora=None, gates=None,
                is_global=True):
    """Pre-norm attention + MLP.  ``lora`` is this layer's slice of the
    bank ({target: {"A", "B"}}).  Returns (x, fresh (k, v) or None)."""
    h = L.norm(cfg, p["ln1"], x)
    a, kv = ATT.attention_block(cfg, p["attn"], h, positions=positions,
                                cache=cache, mode=mode, pages=pages,
                                ident=ident, host_pos=host_pos, lora=lora,
                                gates=gates, is_global=is_global)
    x = x + a
    h = L.norm(cfg, p["ln2"], x)
    get = (lora or {}).get
    return x + L.mlp(cfg, p["mlp"], h, get("mlp_in"), get("mlp_out"),
                     gates), kv


def ssm_layer(cfg, p, x, *, mode, cache, lora=None, gates=None):
    """Pre-norm Mamba-1 or Mamba-2 block with a residual, then, where the
    layer has one (zamba2's), a pre-norm MLP with a residual (the
    reference's ``model.py:132-142``).  Returns (x, {"conv", "h"}, or
    None in train mode)."""
    h = L.norm(cfg, p["ln"], x)
    block = SSM.mamba1_block if cfg.ssm_version == 1 else SSM.mamba2_block
    y, state = block(cfg, p["ssm"], h, cache=cache, mode=mode, lora=lora,
                     gates=gates)
    x = x + y
    if "mlp" in p:
        get = (lora or {}).get
        h = L.norm(cfg, p["ln2"], x)
        x = x + L.mlp(cfg, p["mlp"], h, get("mlp_in"), get("mlp_out"),
                      gates)
    return x, state


class LM:
    """Model bundle for one ModelConfig on one device: the dense family's
    plain or grouped (gemma3) layout, the Mamba-1 SSM family or the
    zamba2 hybrid.  ``ring_cache``: the grouped layout's local layers
    (the hybrid's shared attention block) keep window-sized ring caches
    (the reference's ``LM(ring_cache=True)``)."""

    def __init__(self, cfg, device=None, ring_cache: bool = False):
        if cfg.family == "ssm":
            if cfg.ssm_version != 1 or cfg.norm_type != "rmsnorm":
                raise NotImplementedError(
                    f"{cfg.name}: only Mamba-1 with RMSNorm is ported "
                    "in the SSM family")
        elif cfg.family == "hybrid":
            if cfg.ssm_version != 2 or not cfg.attn_every \
                    or cfg.attn_type not in ("full", "sliding") \
                    or cfg.qkv_bias or cfg.use_qk_norm \
                    or cfg.norm_type != "rmsnorm":
                raise NotImplementedError(
                    f"{cfg.name}: only the zamba2 hybrid (Mamba-2 groups "
                    "under one shared attention block, RMSNorm) is ported")
        elif cfg.family != "dense" \
                or not (cfg.attn_type == "full" or (
                    cfg.attn_type == "mixed" and cfg.global_every)) \
                or cfg.qkv_bias or not cfg.tie_embeddings \
                or cfg.norm_type != "rmsnorm":
            raise NotImplementedError(
                f"{cfg.name}: only the dense layouts of the Floe pairs "
                "(full attention, or gemma3's grouped sliding/global "
                "layout; tied embeddings, RMSNorm), the Mamba-1 SSM "
                "family and the zamba2 hybrid are ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.ring_cache = ring_cache

    # -------------------------------------------------------------- layout
    def _layout(self) -> Tuple[str, int, int, int]:
        """Stack layout: (kind, n_groups, group_size, tail), as the
        reference's ``_layout`` (the hybrid's case first)."""
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.attn_every:
            g = cfg.attn_every
            n_groups = cfg.num_layers // g
            return ("grouped", n_groups, g, cfg.num_layers - n_groups * g)
        if cfg.attn_type == "mixed" and cfg.global_every:
            g = cfg.global_every
            n_groups = cfg.num_layers // g
            return ("grouped", n_groups, g, cfg.num_layers - n_groups * g)
        return ("plain", cfg.num_layers, 1, 0)

    def layer_sites(self) -> List[LayerSite]:
        """The layers in the order the stack runs them: the plain
        layout's (and an SSM's) 0..L-1, or in each group its g - 1 local
        layers (the hybrid's Mamba-2 layers) then its global layer (the
        hybrid's shared block), and after the groups the tail."""
        kind, n_groups, g, tail = self._layout()
        ssm = self.cfg.family == "ssm"
        if kind == "plain":
            return [LayerSite(i, "layers", "layers", (i,), True, ssm=ssm)
                    for i in range(self.cfg.num_layers)]
        hybrid = self.cfg.family == "hybrid"
        out = []
        for gi in range(n_groups):
            out += [LayerSite(("inner", (gi, j)), "inner", "inner",
                              (gi, j), False, ssm=hybrid)
                    for j in range(g - 1)]
            if hybrid:
                out.append(LayerSite(("attn", (gi,)), "shared_attn",
                                     "special", (), True, lora_idx=(gi,)))
            else:
                out.append(LayerSite(("global", (gi,)), "global_layers",
                                     "special", (gi,), True))
        out += [LayerSite(("tail", (t,)), "tail", "tail", (t,), False,
                          ssm=hybrid) for t in range(tail)]
        return out

    def _ring_local_len(self, max_seq: int) -> int:
        """Window extent of ring/local cache leaves (0 when every leaf
        is full-length): the grouped dense layout's local layers (the
        hybrid's shared-block rings are ``init_cache``'s)."""
        kind, *_ = self._layout()
        if kind == "grouped" and self.cfg.family == "dense" \
                and self.ring_cache:
            w = min(max_seq, self.cfg.sliding_window)
            if w < max_seq:
                return w
        return 0

    # -------------------------------------------------------------- params
    def param_shapes(self) -> Dict[str, Any]:
        """The reference's spec tree for the dense layouts, the Mamba-1
        stack or the zamba2 hybrid (``model.py:285-290``, its Mamba-2
        layers ``ssm_layer_spec`` and ``mamba2_spec``): leaves are
        (shape, init, scale) with init in {embed, fan_in, ones, zeros}."""
        cfg = self.cfg
        n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        embed = {"tok": {"w": _leaf((cfg.vocab_size, d), "embed",
                                    d ** -0.5)}}
        if not cfg.tie_embeddings:
            embed["unembed"] = {"w": _leaf((d, cfg.vocab_size))}
        if cfg.family == "ssm":
            di, ns, dtr, k = (cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                              cfg.ssm_conv)
            return {
                "embed": embed,
                "ln_f": {"scale": _leaf((d,), "ones")},
                "layers": {
                    "ln": {"scale": _leaf((n, d), "ones")},
                    "ssm": {
                        "in_proj": {"w": _leaf((n, d, 2 * di))},
                        "conv_w": _leaf((n, k, di)),
                        "conv_b": _leaf((n, di), "zeros"),
                        "x_proj": {"w": _leaf((n, di, dtr + 2 * ns))},
                        "dt_proj": {"w": _leaf((n, dtr, di)),
                                    "b": _leaf((n, di), "zeros")},
                        "A_log": _leaf((n, di, ns), "ones"),
                        "D": _leaf((n, di), "ones"),
                        "out_proj": {"w": _leaf((n, di, d))},
                    },
                },
            }

        gate = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1

        def layers(lead):
            attn = {"q": {"w": _leaf(lead + (d, h * hd))},
                    "k": {"w": _leaf(lead + (d, kv * hd))},
                    "v": {"w": _leaf(lead + (d, kv * hd))},
                    "o": {"w": _leaf(lead + (h * hd, d))}}
            if cfg.use_qk_norm:
                attn["q_norm"] = {"scale": _leaf(lead + (hd,), "ones")}
                attn["k_norm"] = {"scale": _leaf(lead + (hd,), "ones")}
            return {"ln1": {"scale": _leaf(lead + (d,), "ones")},
                    "attn": attn,
                    "ln2": {"scale": _leaf(lead + (d,), "ones")},
                    "mlp": {"in": {"w": _leaf(lead + (d, gate * f))},
                            "out": {"w": _leaf(lead + (f, d))}}}

        out = {"embed": embed, "ln_f": {"scale": _leaf((d,), "ones")}}
        kind, n_groups, g, tail = self._layout()
        if cfg.family == "hybrid":
            di, ns, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
            nh, ng = cfg.ssm_nheads, cfg.ssm_ngroups
            conv = di + 2 * ng * ns

            def mamba2(lead):
                return {
                    "ln": {"scale": _leaf(lead + (d,), "ones")},
                    "ssm": {
                        "in_proj": {"w": _leaf(lead + (d, di + conv + nh))},
                        "conv_w": _leaf(lead + (k, conv)),
                        "conv_b": _leaf(lead + (conv,), "zeros"),
                        "A_log": _leaf(lead + (nh,), "ones"),
                        "D": _leaf(lead + (nh,), "ones"),
                        "dt_bias": _leaf(lead + (nh,), "zeros"),
                        "norm": {"scale": _leaf(lead + (di,), "ones")},
                        "out_proj": {"w": _leaf(lead + (di, d))},
                    },
                    "ln2": {"scale": _leaf(lead + (d,), "ones")},
                    "mlp": {"in": {"w": _leaf(lead + (d, gate * f))},
                            "out": {"w": _leaf(lead + (f, d))}}}
            out["inner"] = mamba2((n_groups, g - 1))
            out["tail"] = mamba2((tail,))
            out["shared_attn"] = layers(())
            return out
        if kind == "grouped":
            out["inner"] = layers((n_groups, g - 1))
            out["tail"] = layers((tail,))
            out["global_layers"] = layers((n_groups,))
        else:
            out["layers"] = layers((n,))
        return out

    def init(self, seed: int) -> Dict[str, Any]:
        """Random parameters made on the device from a seeded
        ``torch.Generator``, with the reference's initialiser laws
        (fan-in over every axis but the last, as the reference counts
        it for stacked leaves).  The values differ from the JAX
        package's, whose generator is threefry; tests that compare the
        two bring the JAX parameters over with ``bridge.py``.  Stacked
        leaves (3-D, or 4-D in a grouped layout's inner stack) are drawn
        one layer at a time, which bounds the float32 scratch at full
        width."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def make(spec):
            shape, init, scale = spec
            if init in ("ones", "zeros"):
                fill = torch.ones if init == "ones" else torch.zeros
                return fill(shape, dtype=self.dtype, device=self.device)
            std = scale if init == "embed" else \
                scale / math.sqrt(max(1, math.prod(shape[:-1])))
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            slices = out.view(-1, *shape[-2:]) if len(shape) >= 3 \
                else [out]
            for sl in slices:
                sl.copy_(torch.randn(sl.shape, generator=gen,
                                     device=self.device) * std)
            return out

        return T.map_tree(make, self.param_shapes())

    def init_keyed(self, seed: int) -> Dict[str, Any]:
        """The reference's ``lm.init(jax.random.key(seed))`` bit for bit
        (``repro/models/layers.py:54``): the key split into one key a
        leaf in sorted order, each leaf ``jax.random.normal`` times its
        law's std (the embedding's scale, or scale / sqrt(fan-in)),
        ones or zeros, cast to the model's dtype.  The normals are
        threefry's on the host (``core/prng.py``), so this is for the
        reduced configs (the launcher's), not a full-width model."""
        from repro_torch.core import prng
        specs = self.param_shapes()
        leaves = T.leaves(specs)
        keys = prng.split(prng.key(seed), max(1, len(leaves)))

        def make(j, spec):
            shape, init, scale = spec
            if init in ("ones", "zeros"):
                fill = np.ones if init == "ones" else np.zeros
                arr = fill(shape, np.float32)
            else:
                std = scale if init == "embed" else \
                    scale / math.sqrt(max(1, math.prod(shape[:-1])))
                arr = prng.normal(prng.key_at(keys, j), shape) \
                    * np.float32(std)
            return torch.from_numpy(arr).to(self.device, self.dtype)

        return T.unflatten(specs, [make(j, spec)
                                   for j, spec in enumerate(leaves)])

    def lora_layout(self) -> Dict[str, Any]:
        """{stack: (stack dims, {target: (d_in, d_out)})} — the contract
        between ``core/lora.py`` adapter trees and the per-layer LoRA
        slices the entry points take (the reference's ``lora_layout``
        for the dense layouts, whose grouped one's global layers are its
        "special" stack, and for Mamba-1: in_proj, x_proj, dt_proj and
        out_proj as ssm_in, ssm_x, ssm_dt and ssm_out; the hybrid's
        Mamba-2 stacks take ssm_in, ssm_out and their MLP's, and its
        "special" stack one slice a group of the shared block's attention
        and MLP targets, ``model.py:325-343`` and ``:350-353``)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            di, n = cfg.d_inner, cfg.ssm_state
            return {"layers": ((cfg.num_layers,), {
                "ssm_in": (cfg.d_model, 2 * di),
                "ssm_x": (di, cfg.dt_rank + 2 * n),
                "ssm_dt": (cfg.dt_rank, di),
                "ssm_out": (di, cfg.d_model)})}
        d, f = cfg.d_model, cfg.d_ff
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        gate = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
        t = {"q": (d, h * hd), "k": (d, kv * hd), "v": (d, kv * hd),
             "o": (h * hd, d), "mlp_in": (d, gate * f), "mlp_out": (f, d)}
        kind, n_groups, g, tail = self._layout()
        if cfg.family == "hybrid":
            di = cfg.d_inner
            proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state \
                + cfg.ssm_nheads
            st = {"ssm_in": (d, proj), "ssm_out": (di, d),
                  "mlp_in": (d, gate * f), "mlp_out": (f, d)}
            return {"inner": ((n_groups, g - 1), st), "tail": ((tail,), st),
                    "special": ((n_groups,), t)}
        if kind == "grouped":
            return {"inner": ((n_groups, g - 1), t), "tail": ((tail,), t),
                    "special": ((n_groups,), t)}
        return {"layers": ((cfg.num_layers,), t)}

    # --------------------------------------------------------------- cache
    def kv_shapes(self, batch: int, max_seq: int,
                  rings: bool = True) -> Dict[str, Any]:
        """Shapes of a dense family's dense KV cache leaves: {"k", "v":
        (L, B, max_seq, KV, hd)} for the plain layout; {"inner", "tail",
        "global": {"k", "v"}} with stack dims (n_groups, g - 1), (tail,)
        and (n_groups,) in front for the grouped one, whose local leaves
        hold ``_ring_local_len`` slots when it is not 0 (and ``rings``:
        without, every leaf is linear over max_seq positions)."""
        cfg = self.cfg
        kind, n_groups, g, tail = self._layout()
        kv_hd = (cfg.num_kv_heads, cfg.head_dim)
        if kind == "plain":
            shape = (cfg.num_layers, batch, max_seq) + kv_hd
            return {"k": shape, "v": shape}
        local = (rings and self._ring_local_len(max_seq)) or max_seq

        def kv(lead, seq):
            shape = lead + (batch, seq) + kv_hd
            return {"k": shape, "v": shape}
        return {"inner": kv((n_groups, g - 1), local),
                "tail": kv((tail,), local),
                "global": kv((n_groups,), max_seq)}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.family == "hybrid":
            _, n_groups, g, tail = self._layout()
            nh, hp, ns = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
            conv = cfg.d_inner + 2 * cfg.ssm_ngroups * ns

            def ssm_state(lead):
                return {"conv": torch.zeros(
                            lead + (batch, cfg.ssm_conv - 1, conv),
                            dtype=self.dtype, device=self.device),
                        "h": torch.zeros(lead + (batch, nh, hp, ns),
                                         dtype=torch.float32,
                                         device=self.device)}
            # the shared block's caches: window-sized rings with
            # ring_cache on a sliding-window config (``model.py:416-428``)
            seq = min(max_seq, cfg.sliding_window) if (
                self.ring_cache and cfg.attn_type == "sliding") else max_seq
            kv = (n_groups, batch, seq, cfg.num_kv_heads, cfg.head_dim)
            return {"inner": ssm_state((n_groups, g - 1)),
                    "tail": ssm_state((tail,)),
                    "attn": {n: torch.zeros(kv, dtype=self.dtype,
                                            device=self.device)
                             for n in ("k", "v")},
                    "pos": 0}
        if cfg.family == "ssm":
            # the recurrent state does not grow with max_seq
            nl = cfg.num_layers
            return {"conv": torch.zeros(
                        (nl, batch, cfg.ssm_conv - 1, cfg.d_inner),
                        dtype=self.dtype, device=self.device),
                    "h": torch.zeros(
                        (nl, batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=self.device),
                    "pos": 0}
        cache = T.map_tree(lambda shape: torch.zeros(
            shape, dtype=self.dtype, device=self.device),
            self.kv_shapes(batch, max_seq))
        cache["pos"] = 0
        return cache

    # ---------------------------------------------------------- entry points
    @staticmethod
    def _layer(params, site: LayerSite):
        return T.map_tree(lambda t: t[site.idx], params[site.stack])

    @staticmethod
    def _lora_layer(lora, site: LayerSite):
        """The layer's slice of a LoRA bank tree ({stack: {target: {"A",
        "B"}}}), as the reference's layer scans slice it."""
        return None if lora is None else T.map_tree(
            lambda t: t[site.lora_at], lora[site.lora])

    def train_logits(self, params, batch, lora=None, gates=None):
        """Full-sequence causal logits of ``batch["tokens"]`` (B, S):
        (logits (B, S, V) float32, aux loss 0.0), the reference's
        ``_run_stack`` in train mode (``model.py:568-611`` for the
        grouped layout: each layer with its window, theta and qk-norm).
        ``lora``/``gates`` as ``layers.lora_delta`` takes them; each leaf
        of a bank stack is split into its layers once (``unbind`` over
        the flattened stack dims), so the backward stacks the layers'
        gradients into the leaf once.  An SSM sequence keeps the
        128-token chunk rule (``models/ssm.py``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed(cfg, params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        layout = self.lora_layout()
        split = {}
        if lora is not None:
            for stack, (dims, _) in layout.items():
                split[stack] = T.map_tree(
                    lambda t, n=len(dims): t.flatten(0, n - 1).unbind(0),
                    lora[stack])
        for site in self.layer_sites():
            l_i = None
            if lora is not None:
                j = int(np.ravel_multi_index(site.lora_at,
                                             layout[site.lora][0]))
                l_i = T.map_tree(lambda ts: ts[j], split[site.lora])
            p_i = self._layer(params, site)
            if site.ssm:
                x, _ = ssm_layer(cfg, p_i, x, mode="train", cache=None,
                                 lora=l_i, gates=gates)
                continue
            x, _ = dense_layer(cfg, p_i, x, positions=positions,
                               mode="train", cache=None, lora=l_i,
                               gates=gates, is_global=site.is_global)
        x = L.norm(cfg, params["ln_f"], x)
        return L.unembed(cfg, params["embed"], x), \
            torch.zeros((), device=x.device)

    @torch.inference_mode()
    def prefill(self, params, tokens: torch.Tensor, max_seq: int,
                lora=None, gates=None):
        """Process the prompt (B, S) and build a max_seq cache.
        ``lora``/``gates``: a LoRA bank tree and its gates (a (B, E) gate
        row covers every position of its row), as ``layers.lora_delta``
        takes them.  Returns (last-position logits (B, 1, V) float32,
        cache).  A ring leaf shorter than the prompt keeps its last
        ``window`` positions, position p in slot p % window (the
        reference's ``_pad_cache`` roll).  An SSM's cache holds every
        layer's last k-1 conv inputs and final scan state; its prefill
        scan runs K6 (Mamba-1) or K11 (the hybrid's Mamba-2 layers) and
        keeps the reference's 128- or 256-token chunk rule
        (``models/ssm.py``)."""
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        cache = self.init_cache(b, max_seq)
        x = L.embed(cfg, params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device)
        for site in self.layer_sites():
            p_i, l_i = self._layer(params, site), self._lora_layer(lora,
                                                                   site)
            if site.ssm:
                x, state = ssm_layer(cfg, p_i, x, mode="prefill",
                                     cache=None, lora=l_i, gates=gates)
                for name in ("conv", "h"):
                    cache_kv(cache, site.addr, name).copy_(state[name])
                continue
            x, (k, v) = dense_layer(cfg, p_i, x, positions=positions,
                                    mode="prefill", cache=None, lora=l_i,
                                    gates=gates, is_global=site.is_global)
            _place(cache_kv(cache, site.addr, "k"), k)
            _place(cache_kv(cache, site.addr, "v"), v)
        cache["pos"] = s
        x = L.norm(cfg, params["ln_f"], x[:, -1:])
        return L.unembed(cfg, params["embed"], x), cache

    @torch.inference_mode()
    def prefill_packed(self, params, tokens: torch.Tensor, lengths,
                       max_seq: int, write_kv=None, lora=None, gates=None):
        """Packed ragged-batch prefill: B prompts right-padded to one
        shared length, in a single pass.  tokens (B, Lpad); lengths (B,)
        valid token counts (host ints).  Causal masking keeps every
        valid position independent of the padding, so row b's K/V at
        [0, lengths[b]) and its last-token logits match a B=1 prefill of
        the unpadded prompt.

        Each layer's fresh (B, Lpad, KV, hd) K and V go to
        ``write_kv(addr, k, v)`` with the layer's cache address
        (``LayerSite.addr``: the layer index of the plain layout, (kind,
        idx) of the grouped one), in the order the stack runs the
        layers; the deployment streams them into pool pages or lane rows,
        so no dense (L, B, max_seq) transient is built.  ``lora``/
        ``gates`` as in ``prefill``.  Returns the per-row last-valid-token
        logits (B, 1, V) float32.  Without ``write_kv`` it returns
        (logits, cache): a dense max_seq cache with per-row "pos" =
        ``lengths``, each row placed as ``packed_rows`` places it (the
        reference's ``_pad_cache(lengths=)``).

        The SSM and hybrid families return (logits, cache) and take no
        ``write_kv``: a scan runs over the whole padded width, so every
        row's conv and scan state is the state after Lpad positions,
        padding included, with "pos" = ``lengths`` (the reference's
        behaviour, ``model.py:686-718``: its ``_pad_cache`` keeps the
        prefill's state of every row).  The hybrid's shared-block K/V
        rows are placed as the dense family's (``row_writer``: zeros past
        Lpad, or each row's own ring when ``ring_cache`` gives the block
        a ring shorter than Lpad).  Lpad follows the 128-token (Mamba-1)
        or 256-token (Mamba-2) chunk rule."""
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (b,) or (lengths < 1).any() \
                or (lengths > s).any():
            raise ValueError(f"lengths {lengths.tolist()} do not fit "
                             f"(B={b}, Lpad={s})")
        cache = None
        if cfg.family in ("ssm", "hybrid"):
            if write_kv is not None:
                raise ValueError(f"packed prefill of the {cfg.family} "
                                 "family: no engine streams its state (no "
                                 "write_kv)")
            cache = self.init_cache(b, max_seq)
            if cfg.family == "hybrid":
                write_kv = row_writer(cache, range(b), range(b), lengths)
        elif write_kv is None:
            cache = self.init_cache(b, max_seq)
            write_kv = row_writer(cache, range(b), range(b), lengths)
        if cache is not None:
            cache["pos"] = to_device(lengths.astype(np.int32),
                                     tokens.device)
        x = L.embed(cfg, params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device)
        for site in self.layer_sites():
            if site.ssm:
                x, state = ssm_layer(cfg, self._layer(params, site), x,
                                     mode="prefill", cache=None,
                                     lora=self._lora_layer(lora, site),
                                     gates=gates)
                for name in ("conv", "h"):
                    cache_kv(cache, site.addr, name).copy_(state[name])
                continue
            x, (k, v) = dense_layer(cfg, self._layer(params, site), x,
                                    positions=positions, mode="prefill",
                                    cache=None,
                                    lora=self._lora_layer(lora, site),
                                    gates=gates, is_global=site.is_global)
            write_kv(site.addr, k, v)
        # per-row last VALID position (x[:, -1:] would read padding)
        idx = to_device(np.asarray(lengths) - 1, tokens.device)
        last = x[torch.arange(b, device=tokens.device), idx][:, None]
        last = L.norm(cfg, params["ln_f"], last)
        logits = L.unembed(cfg, params["embed"], last)
        return logits if cache is None else (logits, cache)

    # ------------------------------------------------- prefix history
    def _dense_only(self, what: str):
        """The prefix history API is the dense family's: the reference
        refuses the others in ``prefill_suffix`` (``model.py:1015-1017``)."""
        if self.cfg.family != "dense":
            raise NotImplementedError(f"{what} of the {self.cfg.family} "
                                      "family: attention families only")

    def linear_kv(self, batch: int, n: int) -> Dict[str, Any]:
        """An uninitialised K/V tree shaped as the dense cache's, every
        leaf (..., batch, n, KV, hd) linear over n positions (no
        rings)."""
        return T.map_tree(lambda shape: torch.empty(
            shape, dtype=self.dtype, device=self.device),
            self.kv_shapes(batch, n, rings=False))

    def init_history(self, n: int) -> Dict[str, Any]:
        """An empty history of ``n`` positions: ``linear_kv(1, n)`` with
        "len" = n."""
        hist = self.linear_kv(1, n)
        hist["len"] = n
        return hist

    @torch.inference_mode()
    def build_prefix(self, params, tokens: torch.Tensor, write_kv=None,
                     lora=None, gates=None) -> Dict[str, Any]:
        """Prefill a shared preamble ONCE (B=1) into a history: tokens
        (1, P) -> the tree of ``init_history(P)`` holding every layer's
        K/V over positions 0..P-1.  Causality makes these values what a
        full-prompt prefill computes at the same positions, whatever
        follows.  Each layer's (1, P, KV, hd) K/V also go to
        ``write_kv(addr, k, v)`` when given (the one-time write of the
        shared pages)."""
        self._dense_only("build_prefix")
        if tokens.shape[0] != 1:
            raise ValueError("build_prefix takes one row (B=1)")
        s = tokens.shape[1]
        hist = self.init_history(s)
        x = L.embed(self.cfg, params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device)
        for site in self.layer_sites():
            x, (k, v) = dense_layer(self.cfg, self._layer(params, site), x,
                                    positions=positions, mode="prefill",
                                    cache=None,
                                    lora=self._lora_layer(lora, site),
                                    gates=gates, is_global=site.is_global)
            cache_kv(hist, site.addr, "k").copy_(k)
            cache_kv(hist, site.addr, "v").copy_(v)
            if write_kv is not None:
                write_kv(site.addr, k, v)
        return hist

    @torch.inference_mode()
    def prefill_suffix(self, params, tokens: torch.Tensor, lengths,
                       history, write_kv=None, lora=None, gates=None):
        """Packed ragged-batch prefill of prompt SUFFIXES behind one
        history (``build_prefix``/``extend_history`` output) of P =
        history["len"] positions.  tokens (B, s_pad) right-padded;
        lengths (B,) valid counts (host ints).  Queries run at positions
        P + [0, s_pad) against [history; fresh], so row b's last-token
        logits and its suffix K/V are what a full-prompt packed prefill
        gives there.  Each layer's fresh (B, s_pad, KV, hd) K/V go to
        ``write_kv(addr, k, v)``; returns the last-valid-token logits
        (B, 1, V) float32, or without ``write_kv`` (logits, suffix
        cache): the tree of the fresh K/V, leaves (..., B, s_pad, KV,
        hd)."""
        self._dense_only("prefill_suffix")
        cfg = self.cfg
        b, s = tokens.shape
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (b,) or (lengths < 1).any() \
                or (lengths > s).any():
            raise ValueError(f"lengths {lengths.tolist()} do not fit "
                             f"(B={b}, s_pad={s})")
        sfx = None
        if write_kv is None:
            sfx = self.linear_kv(b, s)
            write_kv = _tree_writer(sfx)
        pre = int(history["len"])
        x = L.embed(cfg, params["embed"], tokens)
        positions = pre + torch.arange(s, device=tokens.device)
        for site in self.layer_sites():
            hist = {n: cache_kv(history, site.addr, n) for n in ("k", "v")}
            x, (k, v) = dense_layer(cfg, self._layer(params, site), x,
                                    positions=positions, mode="prefill",
                                    cache=hist,
                                    lora=self._lora_layer(lora, site),
                                    gates=gates, is_global=site.is_global)
            write_kv(site.addr, k, v)
        idx = to_device(lengths - 1, tokens.device)
        last = x[torch.arange(b, device=tokens.device), idx][:, None]
        last = L.norm(cfg, params["ln_f"], last)
        logits = L.unembed(cfg, params["embed"], last)
        return logits if sfx is None else (logits, sfx)

    def extend_history(self, history, suffix_cache) -> Dict[str, Any]:
        """A new history: ``history`` followed by a chunk's fresh K/V
        (``prefill_suffix``'s suffix cache of an EXACT-width B=1 chunk,
        so positions stay contiguous: "len" grows by its width)."""
        width = cache_kv(suffix_cache, self.layer_sites()[0].addr,
                         "k").shape[1]
        hist, write = history_extender(self, history, width)
        for site in self.layer_sites():
            write(site.addr, cache_kv(suffix_cache, site.addr, "k"),
                  cache_kv(suffix_cache, site.addr, "v"))
        return hist

    def _is_ring_leaf(self, addr, max_seq: int) -> bool:
        return bool(self._ring_local_len(max_seq)) \
            and isinstance(addr, tuple) and addr[0] in LOCAL_KINDS

    def _per_kind(self, max_seq: int, fn, *trees) -> Dict[str, Any]:
        """{"k", "v"} (per kind of the grouped layout) of fn(leaves...,
        is_ring) over matching history/cache trees."""
        local_len = self._ring_local_len(max_seq)

        def kind(subs, ring):
            return {n: fn(*(t[n] for t in subs), ring) for n in ("k", "v")}
        if "k" in trees[0]:
            return kind(trees, False)
        return {kn: kind([t[kn] for t in trees],
                         kn in LOCAL_KINDS and bool(local_len))
                for kn in ("inner", "tail", "global")}

    def prefix_page_rows(self, history, share_len: int, page_size: int,
                         max_seq: int) -> Dict[str, Any]:
        """Shared COW page content: the first ``share_len`` (page-
        aligned) positions of each full-length history leaf as (lead...,
        n_shared, ps, KV, hd); ring leaves, never shared, have zero
        pages (the reference's ``prefix_page_rows``)."""
        return self._per_kind(max_seq, lambda h, ring: prefix_pages(
            h, 0 if ring else share_len, page_size), history)

    def suffix_page_rows(self, history, suffix_cache, lengths,
                         share_len: int, page_size: int,
                         max_seq: int) -> Dict[str, Any]:
        """Per-row PRIVATE page content after a suffix prefill (the
        reference's ``suffix_page_rows``): full-length leaves hold the
        positions [share_len, P + s_pad) (the prefix's partial tail,
        then the suffix) as (lead..., B, n, ps, KV, hd); ring leaves
        each row's ring at its own total depth, gathered from [history;
        fresh] slot for slot.  "pos" = P + lengths."""
        local_len = self._ring_local_len(max_seq)
        lengths = np.asarray(lengths, np.int64)
        pre = int(history["len"])

        def leaf(h, sfx, ring):
            lead, (b, s_len), kv_hd = (h.shape[:-4], sfx.shape[-4:-2],
                                       sfx.shape[-2:])
            width = local_len if ring else pre - share_len + s_len
            out = sfx.new_empty(lead + (b, -(-width // page_size),
                                        page_size) + kv_hd)
            for o, a, c in zip(out.view((-1,) + out.shape[-5:]),
                               h.reshape((-1,) + h.shape[-4:]),
                               sfx.reshape((-1,) + sfx.shape[-4:])):
                o.copy_(to_pages(suffix_rows(a, c, lengths, share_len,
                                             local_len if ring else 0),
                                 page_size))
            return out
        out = self._per_kind(max_seq, leaf, history, suffix_cache)
        out["pos"] = pre + lengths
        return out

    # ------------------------------------------- speculative rollback
    def _spec_kinds(self, max_seq: int) -> List[Tuple[str, bool]]:
        """(kind, is_ring) of the cache's KV kinds; kind "" is the plain
        layout's top-level {"k", "v"}.  Dense-family caches only, as the
        reference's (``model.py:843-846``)."""
        if self.cfg.family != "dense":
            raise NotImplementedError(
                "speculative rollback: dense-family caches only "
                f"(got {self.cfg.family})")
        if self._layout()[0] == "plain":
            return [("", False)]
        ring = self._ring_local_len(max_seq) > 0
        return [("inner", ring), ("tail", ring), ("global", False)]

    def _spec_slots(self, cache, leaf: torch.Tensor, pos0: torch.Tensor,
                    k: int, is_ring: bool, max_seq: int):
        """(targets, written) of the k decode writes of one KV leaf per
        row, both (B, k): slot indices into a dense lane leaf's rows, or
        flat slot indices into a paged pool (the sink page's slots where
        the write was dropped); ``written`` marks the writes the decode
        made.  A dense lane's dropped targets are in-range slots that no
        write of the row touches: slot j of a parked row, and pos0 + j -
        k past a full-length leaf's end."""
        j = torch.arange(k, dtype=torch.int64, device=pos0.device)[None, :]
        p0 = pos0.to(torch.int64)[:, None]
        idx = p0 + j
        alive = p0 < ATT.FREED_POS
        if "block" not in cache:
            s_len = leaf.shape[-3]
            if is_ring:
                return torch.where(alive, idx % s_len, j), alive.expand(
                    -1, k)
            written = alive & (idx < s_len)
            return torch.where(written, idx, torch.where(
                alive, idx - k, j)), written
        n_pool, ps = leaf.shape[-4] - 1, leaf.shape[-3]
        if is_ring:
            slot = idx % self._ring_local_len(max_seq)
            tbl = cache["local"]
            ok = alive
        else:
            slot = idx
            tbl = cache["block"]
            ok = alive & (slot < tbl.shape[1] * ps)
        col = torch.clamp(torch.where(alive, slot, 0) // ps,
                          max=tbl.shape[1] - 1)
        page = tbl.gather(1, col).to(torch.int64)
        ok = ok & (page < n_pool)
        return torch.where(ok, page * ps + slot % ps,
                           n_pool * ps + j % ps), ok

    def _spec_leaves(self, cache, max_seq: int):
        """(kind, name, leaf, is_ring) of every non-empty KV leaf."""
        for kind, ring in self._spec_kinds(max_seq):
            sub = cache if kind == "" else cache[kind]
            for name in ("k", "v"):
                if sub[name].numel():
                    yield kind, name, sub[name], ring

    @staticmethod
    def _spec_view(cache, leaf: torch.Tensor) -> torch.Tensor:
        """The leaf with its stack dims flattened: (Lf, B, S, KV, hd)
        dense rows, or (Lf, (P + 1) * ps, KV, hd) pool slots."""
        lf = math.prod(leaf.shape[:-4])
        if "block" in cache:
            return leaf.view(lf, -1, *leaf.shape[-2:])
        return leaf.view(lf, *leaf.shape[-4:])

    def spec_snapshot(self, cache, pos0: torch.Tensor, k: int,
                      max_seq: int, out=None) -> Dict[str, Any]:
        """The k decode-write targets [pos0, pos0 + k) of every KV leaf
        of a lane cache, before a speculative burst: {(kind, name): (Lf,
        B, k, KV, hd)}.  ``out``, a snapshot of the same shapes, is
        filled in place and returned (a CUDA graph's static buffers)."""
        snap = {} if out is None else out
        for kind, name, leaf, ring in self._spec_leaves(cache, max_seq):
            tgt, _ = self._spec_slots(cache, leaf, pos0, k, ring, max_seq)
            flat = self._spec_view(cache, leaf)
            if "block" in cache:
                got = flat[:, tgt]
            else:
                rows = torch.arange(tgt.shape[0], device=tgt.device)
                got = flat[:, rows[:, None], tgt]
            if out is None:
                snap[(kind, name)] = got
            else:
                snap[(kind, name)].copy_(got)
        return snap

    def spec_restore(self, cache, snap, pos0: torch.Tensor,
                     keep: torch.Tensor, max_seq: int):
        """Roll back a speculative write window IN PLACE: target pos0 + j
        of every KV leaf gets its snapshot value back for every j >=
        keep[b] the decode wrote; j < keep[b] (the accepted writes) stay.
        keep[b] = k restores nothing, 0 the whole window.  "pos" is the
        caller's.  Returns the cache."""
        k = next(iter(snap.values())).shape[2]
        j = torch.arange(k, device=keep.device)[None, :]
        roll = j >= keep.to(torch.int64)[:, None]
        for kind, name, leaf, ring in self._spec_leaves(cache, max_seq):
            tgt, written = self._spec_slots(cache, leaf, pos0, k, ring,
                                            max_seq)
            put = roll & written
            flat = self._spec_view(cache, leaf)
            sv = snap[(kind, name)]
            if "block" in cache:
                # dropped and kept targets write into the sink page
                sink = flat.shape[1] - leaf.shape[-3] + j % leaf.shape[-3]
                flat[:, torch.where(put, tgt, sink)] = sv
            else:
                rows = torch.arange(tgt.shape[0],
                                    device=tgt.device)[:, None]
                cur = flat[:, rows, tgt]
                flat[:, rows, tgt] = torch.where(put[None, :, :, None, None],
                                                 sv, cur)
        return cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens: torch.Tensor, lora=None,
                    gates=None):
        """One-token decode.  tokens (B, 1).  Returns (logits (B, 1, V)
        float32, cache) — the same cache dict, updated IN PLACE (new K/V
        written at each row's position, positions advanced by one).

        With an int "pos" every row sits at that depth (dense cache).
        With a (B,) "pos" tensor each row decodes at its own depth: in
        its dense lane rows, or, with a "block" table (paged lane),
        against the page pools, a ring layer through the lane's "local"
        table.  Parked
        rows (pos >= FREED_POS) write nothing and keep their position.
        ``lora``/``gates`` as in ``prefill``; integer (B,) gates are
        per-row adapter slots (K4).  An SSM advances its conv and scan
        state in place by the O(1) recurrence."""
        cfg = self.cfg
        pos = cache["pos"]
        pages = None
        if "block" in cache:
            pages = {n: cache[n] for n in ("block", "local") if n in cache}
        host_pos, ident = cache.get("pos_host"), cache.get("ident")
        x = L.embed(cfg, params["embed"], tokens)
        for site in self.layer_sites():
            p_i, l_i = self._layer(params, site), self._lora_layer(lora,
                                                                   site)
            if site.ssm:
                state = {n: cache_kv(cache, site.addr, n)
                         for n in ("conv", "h")}
                x, new = ssm_layer(cfg, p_i, x, mode="decode", lora=l_i,
                                   gates=gates, cache=state)
                for name in ("conv", "h"):
                    state[name].copy_(new[name])
                continue
            layer_cache = {n: cache_kv(cache, site.addr, n)
                           for n in ("k", "v")}
            x, _ = dense_layer(cfg, p_i, x, positions=pos, mode="decode",
                               cache=layer_cache, pages=pages,
                               ident=ident, host_pos=host_pos, lora=l_i,
                               gates=gates, is_global=site.is_global)
        # parked rows hold position, so "freed" stays an exact marker
        if isinstance(pos, torch.Tensor):
            pos.add_((pos < ATT.FREED_POS).to(pos.dtype))
            if host_pos is not None:
                host_pos += host_pos < ATT.FREED_POS
        else:
            cache["pos"] = pos if pos >= ATT.FREED_POS else pos + 1
        x = L.norm(cfg, params["ln_f"], x)
        return L.unembed(cfg, params["embed"], x), cache


def ring_gather(lengths, n_slots: int, s_len: int, device) -> torch.Tensor:
    """(B, n_slots) prefill positions that the ring slots of rows of
    ``lengths`` (host ints) hold after a packed prefill of width
    ``s_len``: slot j of row b holds ``ring_kv_positions(lengths[b] - 1,
    n_slots)[j]``, clipped into the prompt (the reference's
    ``_pad_cache(lengths=)``, ``model.py:730-742``)."""
    last = to_device(np.asarray(lengths, np.int64) - 1, device)
    return ATT.ring_kv_positions(last, n_slots).clamp(0, s_len - 1)


def packed_rows(t: torch.Tensor, n_slots: int, gather=None) -> torch.Tensor:
    """A packed prefill's fresh (B, Lpad, KV, hd) K or V as the rows of a
    cache leaf of ``n_slots`` slots hold it: zero-padded past Lpad when
    it fits, else a ring gathered at ``gather`` (``ring_gather``) —
    the reference's ``_pad_cache(lengths=)`` placement."""
    b, s_len = t.shape[:2]
    if n_slots >= s_len:
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n_slots - s_len))
    return t[torch.arange(b, device=t.device)[:, None], gather]


def row_writer(full, src, dst, lengths):
    """``write_kv`` callback for ``LM.prefill_packed`` that writes row
    src[i] of each layer's fresh K/V into row dst[i] of every leaf of
    the dense cache or dense lane cache ``full``, IN PLACE, placed by
    ``packed_rows`` from the prefill rows' (B,) host ``lengths``: the
    whole row is replaced, zeros past the padded prompt (the reference's
    ``insert_slm``/``insert_llm``, ``deployment.py:769``, of a
    ``_pad_cache(lengths=)`` row, cast to the leaf's dtype as its
    ``astype``).  The admitted rows' positions are then the caller's to
    set."""
    gather = {}

    def write(addr, k, v):
        if not gather:               # once for every layer
            gather["src"], gather["dst"] = (
                to_device(np.asarray(list(i), np.int64), k.device)
                for i in (src, dst))
        for name, t in (("k", k), ("v", v)):
            leaf = cache_kv(full, addr, name)
            n_slots, s_len = leaf.shape[1], t.shape[1]
            if n_slots < s_len and n_slots not in gather:
                gather[n_slots] = ring_gather(lengths, n_slots, s_len,
                                              t.device)
            leaf[gather["dst"]] = packed_rows(t, n_slots, gather.get(
                n_slots))[gather["src"]].to(leaf.dtype)
    return write


def history_extender(lm, history, width: int):
    """(new history of history["len"] + ``width`` positions, ``write_kv``
    that fills it layer by layer from the old one and a B=1 chunk's
    fresh (1, width, KV, hd) K/V): the streaming ``extend_history``, so
    no stacked copy of the chunk is made."""
    pre = int(history["len"])
    new = lm.init_history(pre + width)

    def write(addr, k, v):
        for name, t in (("k", k), ("v", v)):
            if t.shape[0] != 1 or t.shape[1] != width:
                raise ValueError(f"a history grows by exact-width B=1 "
                                 f"chunks of {width}, got "
                                 f"{tuple(t.shape[:2])}")
            leaf = cache_kv(new, addr, name)
            leaf[:, :pre] = cache_kv(history, addr, name)
            leaf[:, pre:] = t
    return new, write


def prefix_pages(h: torch.Tensor, share_len: int,
                 page_size: int) -> torch.Tensor:
    """A history leaf (lead..., 1, P, KV, hd)'s first ``share_len``
    (page-aligned) positions as (lead..., share_len / ps, ps, KV, hd)
    shared pages."""
    return h[..., 0, :share_len, :, :].reshape(
        h.shape[:-4] + (share_len // page_size, page_size) + h.shape[-2:])


def suffix_rows(h: torch.Tensor, sfx: torch.Tensor, lengths,
                share_len: int, local_len: int = 0) -> torch.Tensor:
    """One layer's per-row content after a suffix prefill, from its
    history leaf h (1, P, KV, hd) and fresh sfx (B, s_pad, KV, hd): a
    full-length leaf (``local_len`` 0) holds positions [share_len, P +
    s_pad) — the prefix's unshared tail, then the suffix — as (B, P -
    share_len + s_pad, KV, hd); a ring leaf of ``local_len`` slots holds
    each row's ring at depth P + lengths[b] - 1, slot j the position
    ``ring_kv_positions`` names, clipped into [history; fresh] (the
    reference's ``suffix_page_rows``, ``model.py:1040-1086``)."""
    b = sfx.shape[0]
    if not local_len:
        return torch.cat([h[:, share_len:].expand(b, -1, -1, -1), sfx],
                         dim=1)
    src = torch.cat([h.expand(b, -1, -1, -1), sfx], dim=1)
    depth = h.shape[1] + np.asarray(lengths, np.int64)
    idx = ring_gather(depth, local_len, src.shape[1], sfx.device)
    return src[torch.arange(b, device=sfx.device)[:, None], idx]


def to_pages(t: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, ceil(S / ps), ps, KV, hd), zero-padding the
    last page (the reference's ``_to_pages``)."""
    b, s_len = t.shape[:2]
    n = -(-s_len // page_size)
    if n * page_size != s_len:
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n * page_size - s_len))
    return t.reshape(b, n, page_size, *t.shape[2:])


def _tree_writer(tree):
    """``write_kv`` that stores each layer's K/V at its address of a
    cache-shaped ``tree`` whose leaves match them."""
    def write(addr, k, v):
        cache_kv(tree, addr, "k").copy_(k)
        cache_kv(tree, addr, "v").copy_(v)
    return write


def _place(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write a prefill's (B, S, KV, hd) K or V into a dense cache leaf
    (B, S_leaf, KV, hd), in place: at slots [0, S) when it fits; into a
    ring shorter than the prompt, its last S_leaf positions rolled so
    position p lands in slot p % S_leaf (the reference's ``_pad_cache``
    placement for one depth)."""
    w, s = dst.shape[1], src.shape[1]
    if w >= s:
        dst[:, :s] = src
    else:
        dst.copy_(torch.roll(src[:, s - w:], (s - w) % w, dims=1))


