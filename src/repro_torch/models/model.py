"""The language model — the port of ``repro/models/model.py`` for the
plain dense layout ([attn, mlp] x L, every layer global) and the
Mamba-1 SSM family ([mamba1] x L, falcon-mamba).

Parameters are the reference's tree (``LM.param_specs``) as nested dicts
of tensors: per-layer leaves stacked on a leading layer axis under
``"layers"``, so ``bridge.py`` maps a JAX tree onto it leaf for leaf.
Two cache forms, both written in place by decode (the reference
returns an updated copy, which the port saves):

* dense: {"k", "v": (L, B, max_seq, KV, hd), "pos": int} — every row
  at one depth, the sequential engine;
* paged (a lane of the batched engine, built by the deployment):
  {"k", "v": page pools (L, P + 1, ps, KV, hd) whose last page is the
  write sink, "block": (B, nb) int32 block table, "pos": (B,) int32 on
  the device, "pos_host": its host mirror}.  The host mirror is
  validated before each dispatch, so no layer syncs with the device.

The SSM family keeps one cache form: {"conv": (L, B, k-1, d_inner) in
the model dtype, "h": (L, B, d_inner, N) float32, "pos": int}; its
prefill scan runs K6 (``models/ssm.py``).

Every entry point takes an optional merged-LoRA bank (``lora``, the
``core/lora.py`` tree without metadata: {"layers": {target: {"A"
(L, E, r, d_in), "B" (L, E, d_out, r)}}}) and its ``gates``; layer i
reads slice [i] of every leaf, as the reference's layer scan does.
LoRA on the SSM projections is a later slice.

The grouped (gemma3), MoE, MLA, hybrid (zamba2), audio and vision
layouts, qk-norm, qkv biases, untied embeddings of a dense model, ring
caches and the prefix/speculative helpers are later slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf(shape, init: str = "fan_in", scale: float = 1.0):
    return (tuple(shape), init, scale)


def dense_layer(cfg, p, x, *, positions, mode, cache, pages=None,
                host_pos=None, lora=None, gates=None):
    """Pre-norm attention + MLP.  ``lora`` is this layer's slice of the
    bank ({target: {"A", "B"}}).  Returns (x, fresh (k, v) or None)."""
    h = L.norm(cfg, p["ln1"], x)
    a, kv = ATT.attention_block(cfg, p["attn"], h, positions=positions,
                                cache=cache, mode=mode, pages=pages,
                                host_pos=host_pos, lora=lora, gates=gates)
    x = x + a
    h = L.norm(cfg, p["ln2"], x)
    get = (lora or {}).get
    return x + L.mlp(cfg, p["mlp"], h, get("mlp_in"), get("mlp_out"),
                     gates), kv


def ssm_layer(cfg, p, x, *, mode, cache, lora=None):
    """Pre-norm Mamba-1 block with a residual.  Returns (x, {"conv",
    "h"})."""
    h = L.norm(cfg, p["ln"], x)
    y, state = SSM.mamba1_block(cfg, p["ssm"], h, cache=cache, mode=mode,
                                lora=lora)
    return x + y, state


class LM:
    """Model bundle for one ModelConfig on one device: the plain dense
    layout or the Mamba-1 SSM family."""

    def __init__(self, cfg, device=None):
        if cfg.family == "ssm":
            if cfg.ssm_version != 1 or cfg.norm_type != "rmsnorm":
                raise NotImplementedError(
                    f"{cfg.name}: only Mamba-1 with RMSNorm is ported "
                    "(Mamba-2 is the zamba2 slice)")
        elif cfg.family != "dense" or cfg.attn_type != "full" \
                or cfg.use_qk_norm or cfg.qkv_bias \
                or not cfg.tie_embeddings or cfg.norm_type != "rmsnorm":
            raise NotImplementedError(
                f"{cfg.name}: only the plain dense layout of the 2b pair "
                "(full attention, tied embeddings, RMSNorm) and the Mamba-1 "
                "SSM family are ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    # -------------------------------------------------------------- params
    def param_shapes(self) -> Dict[str, Any]:
        """The reference's spec tree for the plain dense layout or the
        Mamba-1 stack: leaves are (shape, init, scale) with init in
        {embed, fan_in, ones, zeros}."""
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
        return {
            "embed": embed,
            "ln_f": {"scale": _leaf((d,), "ones")},
            "layers": {
                "ln1": {"scale": _leaf((n, d), "ones")},
                "attn": {"q": {"w": _leaf((n, d, h * hd))},
                         "k": {"w": _leaf((n, d, kv * hd))},
                         "v": {"w": _leaf((n, d, kv * hd))},
                         "o": {"w": _leaf((n, h * hd, d))}},
                "ln2": {"scale": _leaf((n, d), "ones")},
                "mlp": {"in": {"w": _leaf((n, d, gate * f))},
                        "out": {"w": _leaf((n, f, d))}},
            },
        }

    def init(self, seed: int) -> Dict[str, Any]:
        """Random parameters made on the device from a seeded
        ``torch.Generator``, with the reference's initialiser laws
        (fan-in over every axis but the last, as the reference counts
        it for stacked leaves).  The values differ from the JAX
        package's, whose generator is threefry; tests that compare the
        two bring the JAX parameters over with ``bridge.py``.  Stacked
        leaves are drawn one layer at a time, which bounds the float32
        scratch at full width."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def make(spec):
            shape, init, scale = spec
            if init in ("ones", "zeros"):
                fill = torch.ones if init == "ones" else torch.zeros
                return fill(shape, dtype=self.dtype, device=self.device)
            std = scale if init == "embed" else \
                scale / math.sqrt(max(1, math.prod(shape[:-1])))
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            slices = out if len(shape) == 3 else [out]
            for sl in slices:
                sl.copy_(torch.randn(sl.shape, generator=gen,
                                     device=self.device) * std)
            return out

        return _map_specs(self.param_shapes(), make)

    def lora_layout(self) -> Dict[str, Any]:
        """{stack: (stack dims, {target: (d_in, d_out)})} — the contract
        between ``core/lora.py`` adapter trees and the per-layer LoRA
        slices the entry points take (the reference's ``lora_layout``
        for the plain dense layout)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            raise NotImplementedError(
                f"{cfg.name}: LoRA on the SSM projections (ssm_in, ssm_x, "
                "ssm_dt, ssm_out): later slice")
        d, f = cfg.d_model, cfg.d_ff
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        gate = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
        return {"layers": ((cfg.num_layers,), {
            "q": (d, h * hd), "k": (d, kv * hd), "v": (d, kv * hd),
            "o": (h * hd, d), "mlp_in": (d, gate * f), "mlp_out": (f, d)})}

    # --------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        cfg = self.cfg
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
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "pos": 0}

    # ---------------------------------------------------------- entry points
    def _layer(self, params, i):
        return _map_tree(params["layers"], lambda t: t[i])

    @staticmethod
    def _lora_layer(lora, i):
        """Layer i's slice of a LoRA bank tree ({"layers": {target:
        {"A", "B"}}}), as the reference's layer scan slices it."""
        return None if lora is None else _map_tree(lora["layers"],
                                                   lambda t: t[i])

    @torch.inference_mode()
    def prefill(self, params, tokens: torch.Tensor, max_seq: int,
                lora=None, gates=None):
        """Process the prompt (B, S) and build a max_seq cache.
        ``lora``/``gates``: a LoRA bank tree and its gates (a (B, E) gate
        row covers every position of its row), as ``layers.lora_delta``
        takes them.  Returns (last-position logits (B, 1, V) float32,
        cache).  An SSM's cache holds every layer's last k-1 conv inputs
        and final scan state; its prefill scan runs K6 and keeps the
        reference's 128-token chunk rule (``models/ssm.py``)."""
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        cache = self.init_cache(b, max_seq)
        x = L.embed(cfg, params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device)
        for i in range(cfg.num_layers):
            p_i, l_i = self._layer(params, i), self._lora_layer(lora, i)
            if cfg.family == "ssm":
                x, state = ssm_layer(cfg, p_i, x, mode="prefill",
                                     cache=None, lora=l_i)
                cache["conv"][i] = state["conv"]
                cache["h"][i] = state["h"]
                continue
            x, (k, v) = dense_layer(cfg, p_i, x, positions=positions,
                                    mode="prefill", cache=None, lora=l_i,
                                    gates=gates)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        cache["pos"] = s
        x = L.norm(cfg, params["ln_f"], x[:, -1:])
        return L.unembed(cfg, params["embed"], x), cache

    @torch.inference_mode()
    def prefill_packed(self, params, tokens: torch.Tensor, lengths,
                       max_seq: int, write_kv, lora=None, gates=None):
        """Packed ragged-batch prefill: B prompts right-padded to one
        shared length, in a single pass.  tokens (B, Lpad); lengths (B,)
        valid token counts (host ints).  Causal masking keeps every
        valid position independent of the padding, so row b's K/V at
        [0, lengths[b]) and its last-token logits match a B=1 prefill of
        the unpadded prompt.

        Each layer's fresh (B, Lpad, KV, hd) K and V go to
        ``write_kv(layer, k, v)`` (the deployment streams them into pool
        pages), so no dense (L, B, max_seq) cache is built.  ``lora``/
        ``gates`` as in ``prefill``.  Returns the per-row last-valid-token
        logits (B, 1, V) float32."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotImplementedError(f"packed prefill of the {cfg.family} "
                                      "family: later slice")
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (b,) or (lengths < 1).any() \
                or (lengths > s).any():
            raise ValueError(f"lengths {lengths.tolist()} do not fit "
                             f"(B={b}, Lpad={s})")
        x = L.embed(cfg, params["embed"], tokens)
        positions = torch.arange(s, device=tokens.device)
        for i in range(cfg.num_layers):
            x, (k, v) = dense_layer(cfg, self._layer(params, i), x,
                                    positions=positions, mode="prefill",
                                    cache=None,
                                    lora=self._lora_layer(lora, i),
                                    gates=gates)
            write_kv(i, k, v)
        # per-row last VALID position (x[:, -1:] would read padding)
        idx = to_device(np.asarray(lengths) - 1, tokens.device)
        last = x[torch.arange(b, device=tokens.device), idx][:, None]
        last = L.norm(cfg, params["ln_f"], last)
        return L.unembed(cfg, params["embed"], last)

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens: torch.Tensor, lora=None,
                    gates=None):
        """One-token decode.  tokens (B, 1).  Returns (logits (B, 1, V)
        float32, cache) — the same cache dict, updated IN PLACE (new K/V
        written at each row's position, positions advanced by one).

        With an int "pos" every row sits at that depth (dense cache).
        With a (B,) "pos" tensor and a "block" table (paged lane) each
        row decodes at its own depth against the page pools.  Parked
        rows (pos >= FREED_POS) write nothing and keep their position.
        ``lora``/``gates`` as in ``prefill``; integer (B,) gates are
        per-row adapter slots (K4).  An SSM advances its conv and scan
        state in place by the O(1) recurrence."""
        cfg = self.cfg
        pos = cache["pos"]
        pages = {"block": cache["block"]} if "block" in cache else None
        host_pos = cache.get("pos_host")
        x = L.embed(cfg, params["embed"], tokens)
        for i in range(cfg.num_layers):
            p_i, l_i = self._layer(params, i), self._lora_layer(lora, i)
            if cfg.family == "ssm":
                x, state = ssm_layer(
                    cfg, p_i, x, mode="decode", lora=l_i,
                    cache={"conv": cache["conv"][i], "h": cache["h"][i]})
                cache["conv"][i] = state["conv"]
                cache["h"][i] = state["h"]
                continue
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = dense_layer(cfg, p_i, x, positions=pos, mode="decode",
                               cache=layer_cache, pages=pages,
                               host_pos=host_pos, lora=l_i, gates=gates)
        # parked rows hold position, so "freed" stays an exact marker
        if isinstance(pos, torch.Tensor):
            pos.add_((pos < ATT.FREED_POS).to(pos.dtype))
            if host_pos is not None:
                host_pos += host_pos < ATT.FREED_POS
        else:
            cache["pos"] = pos if pos >= ATT.FREED_POS else pos + 1
        x = L.norm(cfg, params["ln_f"], x)
        return L.unembed(cfg, params["embed"], x), cache


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _map_specs(tree, fn):
    """Map a spec tree in the reference's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        return {k: _map_specs(tree[k], fn) for k in sorted(tree)}
    return fn(tree)
