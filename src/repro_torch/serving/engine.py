"""Hybrid LLM-SLM serving engine — the sequential path of
``repro/serving/engine.py`` (``HybridEngine.generate``), its
continuous-batching engine on paged lanes (``BatchedHybridEngine``) and
the single-model ``SoloEngine`` over an SLM-only deployment (dense or
Mamba-1 SSM).

Pipeline per request (paper Fig. 8):
  1. Privacy detector (Alg. 2): sensitive -> SLM-only, never leaves the
     device.
  2. The SLM's merged-LoRA gates: a per-user adapter's one-hot slot row
     (``adapter_id=``), or the parameter-free router's soft weights ω
     over an expert bank (Eq. 8-11), or none.
  3. Prefill of the SLM and, for cloud-eligible prompts, the LLM.
  4. Token loop: both models decode; their logits are fused per
     Eq. 14-15 (K1); if the cloud misses the timeout the fusion weight
     is forced to w = 1 (Sec. IV-D fallback).

The port serves greedy and keyed sampled decoding (``greedy=False``:
row i's token t is drawn from the fused distribution with key
fold_in(fold_in(key(sample_seed), key id), t), the key id being the
request's seed, else its rid, through K7), on a fault-injected link
when the deployment has a ``FaultModel``: a lost reply or an outage
falls back to the SLM like a late one and charges the full timeout, and
a row whose circuit breaker tripped decodes SLM-only at the edge's cost
(``health_stats``); the breaker's state is a host mirror per request
(``_mirror_breaker``), replayed at every collect from the traces of the
device's own recurrence.  ``deadline_ms`` cancels a request at the
first token boundary where its simulated clock has reached it, on
every path.  The batched engine serves paged lanes with lazy or eager
page reservation under pool budgets (rows park when their growth cannot
be met, the youngest are evicted and re-admitted when a lane wedges), or
dense lanes (``paged=False``, the parity oracle), through
the K-token macro step (``macro_k=K``, the default 8: one dispatch and
one host sync per lane per K tokens, a CUDA graph replayed on the card,
``serving/macro.py``) or the per-token step (``macro_k=0``); its LoRA
decode goes through K5 on the lane's (B, E) gate rows, or through K4 on
per-row slot ids with ``use_slot_kernel=True``.  On paged lanes a
request's shared ``prefix=`` is copy-on-write: the lane prefills the
preamble once (B=1) and maps its whole pages into every sharing row,
whose suffix alone is prefilled, through K3's history-offset mode on
the card; a prompt wider than ``chunk_width`` streams through chunked
prefill, up to the deployment's ``max_ctx``.  With ``spec_k=k`` the
cloud lane decodes speculatively: the SLM drafts k tokens, one chained
LLM verify scores them, and the fused choices accept the longest
agreeing prefix; rejected drafts roll back in place
(``serving/spec.py``, one CUDA graph per lane on the card).

Every engine takes a deployment (``deployment=``) or, as the reference's
engines do, the models and deployment-level settings by keyword, from
which it builds one (on ``device=``, CUDA unless the caller asks for the
CPU); giving both raises (``_reject_deployment_args``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core import lora as LORA
from repro_torch.core.privacy import PrivacyDetector
from repro_torch.core.router import Router
from repro_torch.data import tokenizer as TOK
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.models.attention import FREED_POS, check_row_positions
from repro_torch.models.model import row_writer
from repro_torch.serving import latency as LAT
from repro_torch.serving import paging as PAG
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.macro import LaneMacro
from repro_torch.serving.spec import LaneSpec

# admission prompts are right-padded to a multiple of this many tokens,
# as the reference pads them, so K3 sees the reference's prefill shapes
PREFILL_CHUNK = 16

_BANK_NEEDS_GATING = (
    "expert_bank is set but nothing gates it — the bank would be "
    "silently dropped.  Pass router= to serve router-gated experts, or "
    "build the ServingDeployment with adapter_slots= and submit per-user "
    "requests with adapter_id=")


def _admission_gates(eng, items: List[Tuple[str, Optional[int]]],
                     bp: Optional[int] = None) -> Optional[torch.Tensor]:
    """One (n, E) float32 gate-row block per admission group on the
    device: one-hot adapter-slot rows on an adapter-serving engine (slot
    None -> an all-zero row, an exact 0.0 delta) or the router's softmax
    gates, zero-padded to ``bp`` rows for a packed prefill.  ``items``
    is [(prompt, adapter_slot)].  None when the engine serves no LoRA."""
    if eng.adapters is not None:
        rows = LORA.slot_gates([a for _, a in items],
                               eng.adapters.num_slots)
    elif eng.router is not None and eng.bank is not None:
        rows = np.stack([np.asarray(eng.router.gate_weights(p))
                         for p, _ in items])
    else:
        return None
    if bp is not None:
        g = np.zeros((bp, rows.shape[1]), rows.dtype)
        g[:rows.shape[0]] = rows
        rows = g
    return to_device(rows, eng.dep.device)


def _reject_deployment_args(**named):
    """An engine given ``deployment=`` must not also receive
    deployment-level settings, which it would silently ignore.  ``named``
    maps each argument's name to (value, default)."""
    clashing = [k for k, (v, d) in named.items()
                if (v is not d if d is None else v != d)]
    if clashing:
        raise ValueError(
            "deployment-level arguments are ignored when deployment= is "
            f"given — set them on the ServingDeployment instead: "
            f"{sorted(clashing)}")


def _hybrid_deployment(deployment, slm, slm_params, llm, llm_params,
                       alignment_mlp, expert_bank, latency, timeout_ms,
                       max_seq, sample_seed, device, **extra):
    """The engines' keyword form: build the deployment from the models
    and settings, or check that none is given beside ``deployment``.
    ``extra`` maps further deployment arguments to (value, default)."""
    if deployment is None:
        return ServingDeployment(
            slm, slm_params, llm, llm_params, alignment_mlp,
            expert_bank=expert_bank, latency=latency,
            timeout_ms=timeout_ms, max_seq=max_seq,
            sample_seed=sample_seed, device=device,
            **{k: v for k, (v, _) in extra.items()})
    _reject_deployment_args(
        slm=(slm, None), slm_params=(slm_params, None), llm=(llm, None),
        llm_params=(llm_params, None), alignment_mlp=(alignment_mlp, None),
        expert_bank=(expert_bank, None), latency=(latency, None),
        timeout_ms=(timeout_ms, 200.0), max_seq=(max_seq, 96),
        sample_seed=(sample_seed, 0), device=(device, None), **extra)
    return deployment


@dataclass
class GenStats:
    tokens: int = 0
    cloud_tokens: int = 0
    fallback_tokens: int = 0
    private: bool = False
    latency_ms: List[float] = field(default_factory=list)
    fusion_w: List[float] = field(default_factory=list)
    # the prompt was cut to fit the context budget
    truncated: bool = False
    # engine-wide admission sequence number (batched engine): the
    # observable FIFO order
    admit_seq: int = -1
    degraded_tokens: int = 0
    cloud_lost: int = 0
    # cloud DISPATCHES (one per cloud-eligible token on this path)
    cloud_calls: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # cancelled at a token boundary because the simulated clock passed
    # the request's deadline — the text is partial
    cancelled: bool = False
    # running simulated decode clock (sum of latency_ms)
    clock_ms: float = 0.0

    @property
    def mean_latency_ms(self) -> float:
        return float(np.mean(self.latency_ms)) if self.latency_ms else 0.0

    def push_latency(self, lat_ms: float):
        self.latency_ms.append(lat_ms)
        self.clock_ms += lat_ms


class HybridEngine:
    """Floe inference engine pairing an edge SLM with a cloud LLM.

    ``router`` gates the deployment's expert bank (Eq. 8-11); a
    deployment with ``adapter_slots`` gives the engine its own
    ``AdapterCache`` (``engine.adapters``) for per-user adapters.  A bank
    without a router, or a bank with adapter slots, raises.
    ``detector`` replaces the default privacy detector (Alg. 2)."""

    def __init__(self, slm=None, slm_params=None, llm=None, llm_params=None,
                 alignment_mlp=None, expert_bank=None,
                 router: Optional[Router] = None,
                 detector: Optional[PrivacyDetector] = None,
                 latency: Optional[LatencyModel] = None,
                 timeout_ms: float = 200.0, max_seq: int = 96,
                 sample_seed: int = 0,
                 deployment: Optional[ServingDeployment] = None,
                 device=None):
        deployment = _hybrid_deployment(
            deployment, slm, slm_params, llm, llm_params, alignment_mlp,
            expert_bank, latency, timeout_ms, max_seq, sample_seed, device)
        if deployment.llm is None or deployment.mlp is None:
            raise ValueError("HybridEngine needs a hybrid deployment (llm + "
                             "alignment mlp); an SLM-only deployment "
                             "serves SoloEngine")
        self.dep = deployment
        self.slm_params = deployment.slm_params
        self.llm_params = deployment.llm_params
        self.bank = deployment.bank
        self.router = router
        self.detector = detector or PrivacyDetector()
        self.latency = deployment.latency
        self.timeout_ms = deployment.timeout_ms
        self.max_seq = deployment.max_seq
        self.sample_seed = deployment.sample_seed
        # injected cloud-link faults (None: the fault-free path) and the
        # engine-wide degradation counters behind health_stats()
        self.fault = deployment.fault
        self._health = dict(losses=0, outage_steps=0, breaker_trips=0,
                            breaker_recoveries=0, degraded_tokens=0,
                            cancellations=0)
        self.adapters = (deployment.make_adapter_cache()
                         if deployment.adapter_slots else None)
        if self.bank is not None and router is None:
            raise ValueError(_BANK_NEEDS_GATING)
        if self.bank is not None and self.adapters is not None:
            raise ValueError(
                "router-gated expert bank and per-user adapter slots "
                "are mutually exclusive — one lane gates buffer cannot "
                "carry both semantics")
        self._lora = (deployment.lora
                      if router is not None and self.bank is not None
                      else None)

    @property
    def lora(self):
        """The LoRA tree the SLM's entry points take: the adapter cache's
        slot bank, the placed router bank, or None."""
        if self.adapters is not None:
            return LORA.bank_for_model(self.adapters.bank)
        return self._lora

    def adapter_stats(self) -> Dict[str, int]:
        """Residency telemetry of the per-user adapter cache: hits,
        loads, evictions, refusals, resident and pinned slots.  Empty on
        engines without adapter slots."""
        return self.adapters.stats() if self.adapters is not None else {}

    def health_stats(self) -> Dict[str, int]:
        """Fault telemetry: injected losses and outage steps met by
        cloud attempts, breaker trips and recoveries, tokens decoded
        SLM-only under a tripped breaker, and deadline cancellations.
        All zero on a fault-free engine."""
        return dict(self._health)

    def _fault_f32(self) -> Tuple[float, float]:
        """(edge, fallback) latencies in float32, as the device's fault
        path charges them: a degraded token costs the edge decode, a
        failed cloud attempt the whole fallback wait."""
        edge = float(np.float32(self.latency.edge_compute_ms))
        return edge, max(edge, float(np.float32(self.timeout_ms)))

    def _mirror_breaker(self, slot: "_Slot", lost: bool, step: int):
        """Advance a slot's host breaker mirror by one attempted token
        and count its outcome.  The mirror runs ``breaker_step`` on the
        weather the device's recurrence read, so it equals the device's
        state at every boundary.  Returns (degraded, raw_fail)."""
        fault = self.fault
        outage = fault.outage_at(step)
        raw = bool(lost) or outage
        (slot.bfails, slot.bcool, degraded, attempt, _fail, trip,
         recover) = LAT.breaker_step(slot.bfails, slot.bcool, True, raw,
                                     fault.breaker_n, fault.breaker_m)
        h = self._health
        if attempt:
            h["losses"] += int(bool(lost))
            h["outage_steps"] += int(outage)
        h["breaker_trips"] += int(trip)
        h["breaker_recoveries"] += int(recover)
        h["degraded_tokens"] += int(degraded)
        st = slot.stats
        st.degraded_tokens += int(degraded)
        st.cloud_lost += int(attempt and raw)
        return degraded, raw

    def _release_adapter(self, s: "_Slot"):
        """Drop a finished request's adapter pin."""
        if self.adapters is not None and s.aslot is not None:
            self.adapters.release(s.aslot)

    @staticmethod
    def _sample_key(rid: Optional[int]) -> int:
        """A request's sampling key id: its key is fold_in(key(
        sample_seed), id) and token t's fold_in(that key, t), so no two
        requests (or tokens) share a sampling key."""
        return 0 if rid is None else rid

    @torch.inference_mode()
    def generate(self, prompt: str, max_new_tokens: int = 16,
                 greedy: bool = True, rid: Optional[int] = None,
                 sample_key_id: Optional[int] = None,
                 adapter_id: Optional[Any] = None,
                 deadline_ms: Optional[float] = None
                 ) -> Tuple[str, GenStats]:
        """``rid``, when given, keys the latency draws and the sampling
        per (request, token), order-independently, so batched and
        sequential serving see the same weather and samples; without it
        the latency draws come from the latency model's stateful stream.
        ``greedy=False`` draws each token from the fused distribution;
        ``sample_key_id`` (a per-request seed) replaces the rid in the
        sampling key only.  ``adapter_id`` pins a
        registered per-user adapter for the whole request (unknown ids
        raise ``adapters.UnknownAdapter``); otherwise a router-gated
        engine gates its bank with the prompt's ω.  ``deadline_ms``
        bounds the simulated decode clock: token t is emitted iff the
        clock after token t-1 is still under it.  The deployment's fault
        weather applies to rid-keyed requests (the rid-less stream has
        no counter to key it)."""
        dep = self.dep
        stats = GenStats()
        stats.private = self.detector.detect(prompt)
        gates = lora = aslot = None
        if adapter_id is not None:
            if self.adapters is None:
                raise ValueError("adapter_id= needs a deployment built with "
                                 "adapter_slots=")
            aslot = self.adapters.acquire(adapter_id)
            if aslot is None:       # a B=1 engine releases every pin
                raise RuntimeError("no adapter slot free")
            gates = _admission_gates(self, [(prompt, aslot)])
            lora = self.lora
        elif self.router is not None and self.bank is not None:
            gates = _admission_gates(self, [(prompt, None)])
            lora = self.lora
        key_id = self._sample_key(rid if sample_key_id is None
                                  else sample_key_id)

        raw = TOK.encode(prompt + " ")
        cap = self.max_seq - max_new_tokens - 1
        stats.truncated = len(raw) > cap
        toks = dep.tokens(raw[:cap])
        s_logits, s_cache = dep.slm_prefill(self.slm_params, toks, lora,
                                            gates)
        use_cloud = not stats.private
        if use_cloud:
            l_logits, l_cache = dep.llm_prefill(self.llm_params, toks)

        sl = s_logits[:, 0]
        ll = l_logits[:, 0] if use_cloud else None
        lat_row = ok_row = lost_row = None
        if use_cloud and rid is not None:
            lat_row, ok_row = dep.lat_request(rid, np.arange(max_new_tokens))
            if self.fault is not None:
                lost_row, _ = dep.fault_request(rid,
                                                np.arange(max_new_tokens))
        slot = _Slot(rid or 0, max_new_tokens, greedy, stats)
        edge32, fb32 = self._fault_f32()
        out_ids: List[int] = []
        for _ in range(max_new_tokens):
            if deadline_ms is not None and stats.clock_ms >= deadline_ms:
                stats.cancelled = True
                self._health["cancellations"] += 1
                break
            step = len(out_ids)
            if use_cloud:
                if lat_row is not None:
                    lat_ms, arrived = float(lat_row[step]), bool(ok_row[step])
                else:        # rid-less path: stateful host stream
                    lat_ms, arrived = self.latency.token_latency_ms(
                        self.timeout_ms, rid=rid, step=step)
                degraded = False
                if lost_row is not None:
                    degraded, raw = self._mirror_breaker(
                        slot, bool(lost_row[step]), step)
                    if degraded:
                        lat_ms, arrived = edge32, False
                    elif raw:
                        lat_ms, arrived = fb32, False
                p_out, w = dep.fuse(sl, ll, arrived)
                stats.cloud_tokens += int(arrived)
                stats.fallback_tokens += int(not arrived)
                # one round-trip a token; degraded tokens never dispatch
                stats.cloud_calls += int(not degraded)
            else:
                lat_ms = self.latency.edge_compute_ms
                p_out = torch.softmax(sl.float(), dim=-1)
                w = torch.ones(1)
            stats.push_latency(float(lat_ms))
            stats.fusion_w.append(float(w[0]))

            nxt = int(torch.argmax(p_out[0])) if greedy else int(
                dep.sample_batched(p_out, [key_id], [step])[0])
            out_ids.append(nxt)
            stats.tokens += 1
            if nxt == TOK.EOS:
                break
            t = dep.tokens([nxt])
            s_logits, s_cache = dep.slm_decode(self.slm_params, s_cache, t,
                                               lora, gates)
            sl = s_logits[:, 0]
            if use_cloud:
                l_logits, l_cache = dep.llm_decode(self.llm_params, l_cache,
                                                   t)
                ll = l_logits[:, 0]
        if aslot is not None:
            self.adapters.release(aslot)
        return TOK.decode(out_ids), stats


# ===========================================================================
# Batched continuous decode on dense or paged lanes
# ===========================================================================


@dataclass
class _Slot:
    """Host-side bookkeeping for one occupied decode-batch row."""
    rid: int
    max_new: int
    greedy: bool
    stats: GenStats
    out_ids: List[int] = field(default_factory=list)
    key_id: Optional[int] = None     # per-request sampling seed override
    seq: int = -1                    # admission order (FIFO observable)
    # lazy growth: token n writes at position prompt_len + n, eviction
    # and resume included; the prompt ids and text for an eviction's
    # re-prefill; parked = pos at FREED_POS with pending logits kept
    prompt_len: int = 0
    prompt_ids: List[int] = field(default_factory=list)
    full_text: str = ""
    parked: bool = False
    # pinned adapter slot, or None: released at completion, not at
    # eviction (a resumed request keeps it)
    aslot: Optional[int] = None
    # the circuit breaker's host mirror (consecutive injected failures,
    # degraded steps left), equal to the device's state at every
    # boundary; it survives eviction
    bfails: int = 0
    bcool: int = 0
    deadline_ms: Optional[float] = None   # simulated-clock deadline
    # speculative lane: an evicted row re-prefilled to depth p on both
    # models; its LLM goes back to p - 1 before its next burst
    needs_spec_init: bool = False


@dataclass
class _Job:
    """One admission: tokenization (and on paged lanes the page
    reservation) happens at ``add_requests`` time (the admission gate
    needs the page demand), so the job carries them to the lane's
    prefill and insert."""
    slot: int
    prompt: str
    max_new: int
    greedy: bool
    rid: int
    private: bool
    key_id: Optional[int]            # per-request sampling seed, or None
    ids: List[int]                   # token ids (already truncated)
    rows_s: Any                      # RowPages in the lane's SLM pager
    rows_l: Any                      # RowPages in the LLM pager (cloud)
    seq: int = -1                    # dense lanes: set at admission
    truncated: bool = False
    aslot: Optional[int] = None      # pinned adapter slot, or None
    resume: Optional[_Slot] = None   # an evicted request's slot
    entry: Optional[dict] = None     # the lane's COW prefix entry, or None
    deadline_ms: Optional[float] = None


def _tokens(ids: List[int], device) -> torch.Tensor:
    """(1, n) int64 token ids on ``device``, copied from pinned memory
    without waiting for the stream (an admission may overlap a macro
    step in flight)."""
    return to_device(np.asarray([ids], np.int64), device)


def _paged_tables(pager: PAG.LanePager, rows: List[PAG.RowPages]):
    """(block, local) host table rows of an admission group: (n, nb) and,
    when the model has ring leaves, (n, nl); else local is None (the
    reference's ``_paged_tables``, ``engine.py:807-818``)."""
    block = np.stack([pager.table_row(r) for r in rows])
    local = (np.stack([pager.local_row(r) for r in rows]) if pager.nl
             else None)
    return block, local


class _Lane:
    """One decode batch: SLM (+ LLM) dense stacked rows, or page pools
    with block tables, and a free-slot list.  The cloud lane fuses
    SLM+LLM logits per row; the edge lane is SLM-only (private traffic,
    Alg. 2)."""

    def __init__(self, engine: "BatchedHybridEngine", batch: int,
                 use_cloud: bool):
        self.eng = engine
        self.batch = batch
        self.use_cloud = use_cloud
        self.slots: List[Optional[_Slot]] = [None] * batch
        self.s_cache = None          # allocated on first admission
        self.l_cache = None
        self.sl = None               # (B, V) current SLM logits
        self.ll = None               # (B, V) current LLM logits
        # speculative cloud lane: (B,) the last emitted token of each
        # row, the LLM's pending feed (the LLM runs one token behind)
        self.lt = None
        self._spec = use_cloud and bool(engine.spec_k)
        self.gates = None            # (B, E) gate rows, or None
        # host page bookkeeping (paged lanes only)
        self.pager_s = self.pager_l = None
        if engine.paged:
            self.pager_s = engine._make_pager(engine.dep.slm, batch)
            if use_cloud:
                self.pager_l = engine._make_pager(engine.dep.llm, batch)
        # requests evicted under pool pressure, awaiting re-admission,
        # and forced completions surfaced at the next collect
        self._evictq: List[_Slot] = []
        self._pending_done: List[Tuple[int, str, GenStats]] = []
        self._macro: Optional[LaneMacro] = None  # built at first dispatch
        self._spec_chain: Optional[LaneSpec] = None
        # what the collect of the step in flight needs (macro or burst
        # chain, host weather, live rows)
        self._inflight = None
        # COW prefix registry: prefix text -> entry (or None when it is
        # structurally unshareable)
        self._prefixes: Dict[str, Optional[dict]] = {}

    # ----------------------------------------------------------- helpers
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _slot_kernel(self) -> bool:
        """Whether decode LoRA takes per-row slot ids (K4), not the gate
        rows (K5)."""
        eng = self.eng
        return bool(eng.use_slot_kernel and eng.adapters is not None
                    and self.gates is not None)

    def _slot_ids(self) -> np.ndarray:
        """The (B,) int32 per-row adapter slots (-1 = adapter-free)."""
        slots = np.full((self.batch,), -1, np.int32)
        for i, s in enumerate(self.slots):
            if s is not None and s.aslot is not None:
                slots[i] = s.aslot
        return slots

    def _decode_gates(self):
        """The gates of a decode dispatch: the (B, E) gate rows, or, with
        ``use_slot_kernel`` on an adapter-serving engine, the (B,) int32
        per-row adapter slots, which ``layers.lora_delta`` sends through
        K4.  Prefill keeps the gate rows (K5), and so do router-gated
        engines (soft weights)."""
        if not self._slot_kernel():
            return self.gates
        return to_device(self._slot_ids(), self.eng.dep.device)

    def _alloc(self, n_experts: Optional[int]):
        dep = self.eng.dep
        b = self.batch
        if self.eng.adapters is not None:
            # adapter lanes always carry gates: the first admission may
            # be adapter-free, later rows scatter their one-hot rows in
            n_experts = self.eng.adapters.num_slots
        vocab = dep.slm.cfg.vocab_size

        def cache(lm, pager):
            if pager is None:
                return dep.init_lane_cache(lm, b)
            return dep.init_paged_lane_cache(lm, b, *pager.pool_pages())
        self.s_cache = cache(dep.slm, self.pager_s)
        if self.use_cloud:
            self.l_cache = cache(dep.llm, self.pager_l)
            self.ll = torch.zeros((b, vocab), dtype=torch.float32,
                                  device=dep.device)
            self.lt = torch.zeros((b,), dtype=torch.int64,
                                  device=dep.device)
        self.sl = torch.zeros((b, vocab), dtype=torch.float32,
                              device=dep.device)
        if n_experts is not None:
            self.gates = torch.zeros((b, n_experts), dtype=torch.float32,
                                     device=dep.device)

    # --------------------------------------------------------- admission
    def _finish_admit(self, j: _Job):
        """Install the slot of an admitted job: fresh, or the kept slot
        of an evicted request, whose stats and tokens continue (its
        re-prefill of prompt + tokens so far lands on the distribution
        it was parked on)."""
        if j.resume is not None:
            j.resume.parked = False
            # the re-prefill left the LLM at full depth: the burst
            # protocol wants it one behind (``_spec_seed``)
            j.resume.needs_spec_init = self._spec
            self.slots[j.slot] = j.resume
            return
        self.slots[j.slot] = _Slot(
            j.rid, j.max_new, j.greedy,
            GenStats(private=j.private, truncated=j.truncated,
                     admit_seq=j.seq),
            key_id=j.key_id, seq=j.seq, prompt_len=len(j.ids),
            prompt_ids=list(j.ids), full_text=j.prompt, aslot=j.aslot,
            deadline_ms=j.deadline_ms)

    def _pad_group(self, ids: List[List[int]], width_cap: int):
        """Shared right-padding for an admission group: chunk-rounded
        length, power-of-two batch, dummy pad rows of length 1 — the
        reference's padding, so K3 sees its shapes.  Returns (tokens
        (bp, Lpad) int64 on the device, lengths (bp,) host int32)."""
        n = len(ids)
        lens = np.asarray([len(seq) for seq in ids], np.int32)
        lpad = min(-(-int(lens.max()) // PREFILL_CHUNK) * PREFILL_CHUNK,
                   width_cap)
        bp = 1 << (n - 1).bit_length()
        toks = np.zeros((bp, lpad), np.int64)
        for j, seq in enumerate(ids):
            toks[j, :len(seq)] = seq
        lens_p = np.ones((bp,), np.int32)
        lens_p[:n] = lens
        return to_device(toks, self.eng.dep.device), lens_p

    @torch.inference_mode()
    def admit_many(self, jobs: List[_Job]):
        """Admit a burst of requests.  A dense lane numbers them and
        admits them in one packed prefill (``_admit_full``).  A paged
        lane routes them as the reference's ``_admit_paged`` does
        (``engine.py:739-763``): prompts wider than ``chunk_width``
        stream one by one through chunked prefill, the jobs sharing a
        COW prefix entry take one suffix prefill per entry, and the rest
        one packed prefill."""
        if not jobs:
            return
        eng = self.eng
        if not eng.paged:
            for j in jobs:
                j.seq = eng._next_seq()
            self._admit_full(jobs)
            return
        groups: Dict[Any, List[_Job]] = {}
        for j in jobs:
            if len(j.ids) <= eng.chunk_width:
                key = None if j.entry is None else id(j.entry)
                groups.setdefault(key, []).append(j)
        for group in groups.values():
            if group[0].entry is None:
                self._admit_full(group)
            else:
                self._admit_suffix(group, group[0].entry)
        for j in jobs:
            if len(j.ids) > eng.chunk_width:
                self._admit_chunked(j)

    def _admit_full(self, jobs: List[_Job]):
        """ONE packed B>1 prefill per model whose per-layer K/V stream
        straight into the rows' dense lane rows (the reference's dense
        prefill + row insert) or, on paged lanes, into their reserved
        pool pages (the pool contents the reference's dense prefill +
        page-row scatter gives: the rows' block-table rows double as
        their destination pages, and their local-table rows as those of
        their rings)."""
        eng = self.eng
        dep = eng.dep
        n = len(jobs)
        toks, lens = self._pad_group([j.ids for j in jobs], eng.max_seq)
        g = _admission_gates(eng, [(j.prompt, j.aslot) for j in jobs],
                             bp=int(toks.shape[0]))
        if self.s_cache is None:
            self._alloc(None if g is None else g.shape[-1])
        src = list(range(n))
        dst = [j.slot for j in jobs]

        def insert(cache, pager, rows):
            """The prefill's ``write_kv`` and what sets the admitted
            rows' positions (and tables) once it ran."""
            if pager is None:
                return (row_writer(cache, src, dst, lens),
                        lambda: dep.set_row_pos(cache, dst, lens[:n]))
            block, local = _paged_tables(pager, rows)
            return (dep.page_writer(cache, src, block, lens, local,
                                    pager.local_len),
                    lambda: dep.finish_paged_insert(cache, dst, lens[:n],
                                                    block, local))
        write, finish = insert(self.s_cache, self.pager_s,
                               [j.rows_s for j in jobs])
        s_logits = dep.slm_prefill_packed(eng.slm_params, toks, lens, write,
                                          eng.lora, g)
        finish()
        dep.insert_row(self.sl, s_logits[:, 0], src, dst)
        if self.use_cloud:
            write, finish = insert(self.l_cache, self.pager_l,
                                   [j.rows_l for j in jobs])
            l_logits = dep.llm_prefill_packed(eng.llm_params, toks, lens,
                                              write)
            finish()
            dep.insert_row(self.ll, l_logits[:, 0], src, dst)
        if g is not None:
            dep.insert_row(self.gates, g, src, dst)
        for j in jobs:
            self._finish_admit(j)

    # ------------------------------------------- COW prefix and chunks
    @torch.inference_mode()
    def ensure_prefix(self, prefix: str) -> Optional[dict]:
        """The lane's COW registry entry for ``prefix``, built at its
        first use: ONE B=1 prefill of the preamble per (lane, model),
        whose whole pages are written into the pools once; later
        admissions only fork them into their block tables.  None when
        the prefix is structurally unshareable (under one page, or no
        room left for a suffix and decode: cached) or when the pools
        cannot hold its pages now (not cached: retried on a later
        admission) — the reference's ``ensure_prefix``
        (``engine.py:679-737``)."""
        eng = self.eng
        dep = eng.dep
        if prefix in self._prefixes:
            return self._prefixes[prefix]
        ps = dep.page_size
        pre_ids = TOK.encode(prefix)
        share_np = len(pre_ids) // ps        # whole pages only
        if share_np == 0 or len(pre_ids) >= eng.max_seq - 2:
            self._prefixes[prefix] = None
            return None
        share_len = share_np * ps
        if self.s_cache is None:
            self._alloc(None)
        pids_s = self.pager_s.alloc.alloc(share_np)
        if pids_s is None:
            return None
        pids_l = None
        if self.use_cloud:
            pids_l = self.pager_l.alloc.alloc(share_np)
            if pids_l is None:
                self.pager_s.alloc.release(pids_s)
                return None
        toks = _tokens(pre_ids, dep.device)
        # shared preambles are LoRA-free (the COW gate refuses router-
        # gated and adapter requests): no bank, no gates
        hist_s = dep.slm_build_prefix(
            eng.slm_params, toks, dep.prefix_writer(self.s_cache, pids_s,
                                                    share_len))
        hist_l = None
        if self.use_cloud:
            hist_l = dep.llm_build_prefix(
                eng.llm_params, toks, dep.prefix_writer(self.l_cache,
                                                        pids_l, share_len))
        entry = dict(pre_ids=list(pre_ids), pre_len=len(pre_ids),
                     share_np=share_np, share_len=share_len,
                     hist_s=hist_s, hist_l=hist_l,
                     pids_s=pids_s, pids_l=pids_l)
        self._prefixes[prefix] = entry
        return entry

    def _admit_suffix(self, jobs: List[_Job], entry: dict):
        """COW admission against a registered prefix: ONE packed suffix
        prefill over the shared history (the preamble is never
        recomputed), each row's partial prefix tail and suffix streamed
        into its owned pages and its ring gathered at its own depth; the
        shared pages are only block-mapped (the reference's
        ``_admit_paged_suffix``, ``engine.py:860-911``).  The rows are
        LoRA-free; on a lane that carries gate rows their rows are
        zeroed, so no earlier occupant's gates reach them."""
        eng = self.eng
        dep = eng.dep
        n = len(jobs)
        pre, share = entry["pre_len"], entry["share_len"]
        toks, lens = self._pad_group([j.ids[pre:] for j in jobs],
                                     eng.max_seq - pre)
        np_content = PAG.pages_for(pre - share + toks.shape[1],
                                   dep.page_size)
        src = list(range(n))
        dst = [j.slot for j in jobs]

        def insert(cache, pager, rows, hist):
            dpf = np.full((n, np_content), PAG.NO_PAGE, np.int64)
            for i, r in enumerate(rows):
                own = r.owned[:np_content]
                dpf[i, :len(own)] = own
            block, local = _paged_tables(pager, rows)
            return (dep.page_writer(cache, src, dpf, lens, local,
                                    pager.local_len, history=hist,
                                    share_len=share),
                    lambda: dep.finish_paged_insert(
                        cache, dst, pre + lens[:n], block, local))
        write, finish = insert(self.s_cache, self.pager_s,
                               [j.rows_s for j in jobs], entry["hist_s"])
        s_logits = dep.slm_prefill_suffix(eng.slm_params, toks, lens,
                                          entry["hist_s"], write)
        finish()
        dep.insert_row(self.sl, s_logits[:, 0], src, dst)
        if self.use_cloud:
            write, finish = insert(self.l_cache, self.pager_l,
                                   [j.rows_l for j in jobs],
                                   entry["hist_l"])
            l_logits = dep.llm_prefill_suffix(eng.llm_params, toks, lens,
                                              entry["hist_l"], write)
            finish()
            dep.insert_row(self.ll, l_logits[:, 0], src, dst)
        if self.gates is not None:
            g = _admission_gates(eng, [(j.prompt, None) for j in jobs])
            dep.insert_row(self.gates, g, src, dst)
        for j in jobs:
            self._finish_admit(j)

    def _admit_chunked(self, j: _Job):
        """Long-prompt admission: stream the prompt through the dense
        prefill buffer ``chunk_width`` W tokens at a time, each chunk's
        K/V written into the row's reserved pages as it goes (the
        reference's ``_admit_paged_chunked``, ``engine.py:913-1027``).
        Chunk 0 is a B=1 ``build_prefix`` whose whole pages freeze;
        every middle chunk is exactly W tokens (positions stay
        contiguous), prefills against the history so far and extends it,
        and writes no ring; the final ragged chunk also writes the ring,
        the row's position and tables, and its last-token logits seed
        decode.  The adapter or router gates ride every chunk."""
        eng = self.eng
        dep = eng.dep
        ps, width = dep.page_size, eng.chunk_width
        ids = j.ids
        g = _admission_gates(eng, [(j.prompt, j.aslot)])
        if self.s_cache is None:
            self._alloc(None if g is None else g.shape[-1])
        models = [("s", self.s_cache, self.pager_s, j.rows_s)]
        if self.use_cloud:
            models.append(("l", self.l_cache, self.pager_l, j.rows_l))

        def call(which, fn, *args):
            """An SLM entry point with the bank and gates, an LLM one
            without."""
            name = ("slm_" if which == "s" else "llm_") + fn
            extra = (eng.lora, g) if which == "s" else ()
            params = eng.slm_params if which == "s" else eng.llm_params
            return getattr(dep, name)(params, *args, *extra)

        toks0 = _tokens(ids[:width], dep.device)
        hist = {which: call(which, "build_prefix", toks0, dep.prefix_writer(
                    cache, rows.full[:width // ps], width))
                for which, cache, _, rows in models}
        pre = width
        while len(ids) - pre > width:
            toks = _tokens(ids[pre:pre + width], dep.device)
            for which, cache, _, rows in models:
                write = dep.page_writer(
                    cache, [0], [rows.full[pre // ps:(pre + width) // ps]],
                    [width], history=hist[which], share_len=pre)
                _, hist[which] = call(which, "prefill_chunk", toks,
                                      [width], hist[which], write)
            pre += width
        w = len(ids) - pre
        wpad = PAG.pages_for(w, ps) * ps
        toks = _tokens(list(ids[pre:]) + [0] * (wpad - w), dep.device)
        for which, cache, pager, rows in models:
            block, local = _paged_tables(pager, [rows])
            write = dep.page_writer(
                cache, [0], [rows.full[pre // ps:(pre + wpad) // ps]],
                [w], local, pager.local_len, history=hist[which],
                share_len=pre)
            logits = call(which, "prefill_suffix", toks, [w], hist[which],
                          write)
            dep.finish_paged_insert(cache, [j.slot], [len(ids)], block,
                                    local)
            dep.insert_row(self.sl if which == "s" else self.ll,
                           logits[:, 0], [0], [j.slot])
        if g is not None:
            dep.insert_row(self.gates, g, [0], [j.slot])
        self._finish_admit(j)

    # ---------------------------------------------------- deadline cancel
    def _cancel_row(self, i: int, s: _Slot) -> Tuple[int, str, GenStats]:
        """Cancel an occupied row whose simulated clock passed its
        deadline: its partial text surfaces with ``cancelled`` set and
        its adapter pin drops; the caller parks or releases the row."""
        st = s.stats
        st.cancelled = True
        self.eng._health["cancellations"] += 1
        self.eng._release_adapter(s)
        self.slots[i] = None
        return (s.rid, TOK.decode(s.out_ids), st)

    def _cancel_expired(self) -> List[Tuple[int, str, GenStats]]:
        """Boundary sweep: cancel every request past its deadline, the
        occupied rows (pages released, dense rows parked) and the
        evicted requests awaiting re-admission (no pages, only a
        completion owed)."""
        out: List[Tuple[int, str, GenStats]] = []
        keep: List[_Slot] = []
        for s in self._evictq:
            if s.deadline_ms is not None \
                    and s.stats.clock_ms >= s.deadline_ms:
                s.stats.cancelled = True
                self.eng._health["cancellations"] += 1
                self.eng._release_adapter(s)
                out.append((s.rid, TOK.decode(s.out_ids), s.stats))
            else:
                keep.append(s)
        self._evictq = keep
        freed: List[int] = []
        for i, s in enumerate(self.slots):
            if s is not None and s.deadline_ms is not None \
                    and s.stats.clock_ms >= s.deadline_ms:
                out.append(self._cancel_row(i, s))
                freed.append(i)
        if freed:
            self._park_rows(freed)
        return out

    def _faulted(self, rows, lat, ok, lost, steps_of):
        """Host fault weather of one token of ``rows``: each row's
        breaker mirror advances on its loss draw (``lost[i]``) and the
        outage at ``steps_of(i)``, a degraded row is charged the edge
        decode and a failed attempt the fallback wait, in ``lat`` (a
        copy is returned).  Returns (lat, arrived, degraded)."""
        eng = self.eng
        b = self.batch
        lat = np.array(lat, copy=True)
        occ = np.zeros((b,), bool)
        occ[rows] = True
        if eng.fault is None:
            return lat, OPS.cloud_arrival_mask(ok, occ), np.zeros((b,),
                                                                  bool)
        degraded = np.zeros((b,), bool)
        raws = np.zeros((b,), bool)
        edge32, fb32 = eng._fault_f32()
        for i in rows:
            deg, raw = eng._mirror_breaker(self.slots[i], bool(lost[i]),
                                           steps_of(i))
            degraded[i], raws[i] = deg, raw
            if deg:
                lat[i] = edge32
            elif raw:
                lat[i] = fb32
        return lat, OPS.cloud_arrival_mask(ok, occ, raws,
                                           degraded=degraded), degraded

    # ------------------------------------------------------------- decode
    @torch.inference_mode()
    def step(self) -> List[Tuple[int, str, GenStats]]:
        """One fused decode step over every occupied row that is not
        parked (the per-token path, ``macro_k=0``), after cancelling
        expired requests, re-admitting evicted ones and provisioning
        pages.  Returns the requests that finished this step (cancelled
        and forced completions included) as (rid, text, stats)."""
        eng = self.eng
        dep = eng.dep
        done = self._cancel_expired()
        self._readmit_evicted()
        done += self._provision(1)
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.parked]
        if not live:
            return done
        b = self.batch
        rids = np.zeros((b,), np.int32)
        keys = np.zeros((b,), np.int64)
        steps = np.zeros((b,), np.int32)
        for i in live:
            s = self.slots[i]
            rids[i], steps[i] = s.rid, len(s.out_ids)
            keys[i] = s.rid if s.key_id is None else s.key_id
        degraded = np.zeros((b,), bool)
        if self.use_cloud:
            # one vectorised counter-based draw for the whole batch, and
            # the fault draw; the breaker mirrors advance on the host,
            # which holds the breaker's state on this path
            lat, ok = dep.lat_batched(rids, steps)
            lost = (dep.fault_batched(rids, steps)[0]
                    if eng.fault is not None else None)
            lat, arrived, degraded = self._faulted(
                live, lat, ok, lost, lambda i: int(steps[i]))
            probs, w = dep.fuse_batched(self.sl, self.ll, arrived)
        else:
            probs = dep.softmax_batched(self.sl)
            w = torch.ones((b,))
        nxt = dep.argmax_batched(probs).cpu().numpy()
        w_host = w.cpu().numpy()
        drawn = None
        if any(not self.slots[i].greedy for i in live):
            # one keyed draw for the whole batch (K7); keys fold_in(key
            # id, step) are the sequential engine's
            drawn = dep.sample_batched(probs, keys, steps).cpu().numpy()

        freed: List[int] = []
        next_tok = np.zeros((b, 1), np.int64)
        for i in live:
            s = self.slots[i]
            st = s.stats
            if self.use_cloud:
                st.cloud_tokens += int(arrived[i])
                st.fallback_tokens += int(not arrived[i])
                st.cloud_calls += int(not degraded[i])
                st.push_latency(float(lat[i]))
            else:
                st.push_latency(float(eng.latency.edge_compute_ms))
            st.fusion_w.append(float(w_host[i]))
            tok = int(nxt[i]) if s.greedy else int(drawn[i])
            s.out_ids.append(tok)
            st.tokens += 1
            if tok == TOK.EOS or len(s.out_ids) >= s.max_new:
                done.append((s.rid, TOK.decode(s.out_ids), st))
                eng._release_adapter(s)
                self.slots[i] = None        # freed: admit into this row
                freed.append(i)
            else:
                next_tok[i, 0] = tok
        if freed:
            # park even when the lane drains: a later partial admission
            # must not revive stale rows at live positions
            self._park_rows(freed)
        parked = [i for i, s in enumerate(self.slots)
                  if s is not None and s.parked]
        if any(s is not None and not s.parked for s in self.slots):
            # freed and parked rows ride along in the fixed-width batch
            # at FREED_POS: their writes drop, and parked rows get their
            # pending logits back after the decode
            old_sl, old_ll = self.sl, self.ll
            toks = to_device(next_tok, dep.device)
            s_logits, self.s_cache = dep.slm_decode(
                eng.slm_params, self.s_cache, toks, eng.lora,
                self._decode_gates())
            self.sl = s_logits[:, 0]
            if self.use_cloud:
                l_logits, self.l_cache = dep.llm_decode(
                    eng.llm_params, self.l_cache, toks)
                self.ll = l_logits[:, 0]
            if parked:
                dep.insert_row(self.sl, old_sl, parked, parked)
                if self.use_cloud:
                    dep.insert_row(self.ll, old_ll, parked, parked)
        return done

    # -------------------------------------------------------- macro decode
    @torch.inference_mode()
    def macro(self, k: int) -> LaneMacro:
        """The lane's K-token macro step, built (and on CUDA captured)
        at its first use.  Its key, K and the gate form (slot ids or
        gate rows), changes what the graph reads, and is fixed for the
        lane's life: the engine's ``macro_k``, and gates set by the
        first admission, which precedes every dispatch."""
        key = (k, self._slot_kernel())
        if self._macro is None:
            self._macro = LaneMacro(self, k, slot_ids=key[1])
        m = self._macro
        if (m.k, m.slot_ids is not None) != key:
            raise ValueError(f"the lane's macro step was built for (K, "
                             f"slot ids) {(m.k, m.slot_ids is not None)}, "
                             f"not {key}")
        return m

    def _row_inputs(self) -> Dict[str, np.ndarray]:
        """Per-row host inputs of a dispatch: rid, sampling key id,
        steps so far, budget, greedy flag, done (empty and parked rows)
        and the breaker mirrors."""
        b = self.batch
        out = dict(rids=np.zeros((b,), np.int32),
                   keys=np.zeros((b,), np.int64),
                   steps=np.zeros((b,), np.int32),
                   maxn=np.zeros((b,), np.int32),
                   greedy=np.ones((b,), bool), done=np.ones((b,), bool),
                   bfails=np.zeros((b,), np.int32),
                   bcool=np.zeros((b,), np.int32))
        for i, s in enumerate(self.slots):
            if s is None or s.parked:
                continue
            out["rids"][i], out["steps"][i] = s.rid, len(s.out_ids)
            out["maxn"][i], out["greedy"][i] = s.max_new, s.greedy
            out["keys"][i] = s.rid if s.key_id is None else s.key_id
            out["done"][i] = False
            out["bfails"][i], out["bcool"][i] = s.bfails, s.bcool
        return out

    def _check_positions(self, fed: np.ndarray, done: np.ndarray):
        """Guard before a dispatch: the last slot each live row writes
        and keeps (``fed`` writes on from its position) lies in its
        cache, checked once as the per-token decode checks every
        layer."""
        for c in (self.s_cache, self.l_cache):
            if c is not None:
                check_row_positions(
                    np.where(done, FREED_POS, c["pos_host"] + fed - 1),
                    self.eng.max_ctx if self.eng.paged
                    else self.eng.dep.max_seq)

    @torch.inference_mode()
    def macro_dispatch(self, k: int):
        """Decode the next k tokens of every occupied row in one macro
        step, without waiting for it: ``macro_collect`` syncs once and
        replays the traces into the slots.  Between the two the host may
        admit into free rows (the scheduler's admission pipelining);
        rows freed in the macro give their pages back only at collect,
        so no admission takes a page the step still writes.  Expired
        requests are cancelled, evicted ones re-admitted and pages
        provisioned first; rows parked for pages enter the step done,
        keeping their pending logits.  No-op when the lane is idle or a
        macro step is already in flight."""
        if self._inflight is not None:
            return
        self._pending_done.extend(self._cancel_expired())
        self._readmit_evicted()
        self._pending_done.extend(self._provision(k))
        if not any(s is not None and not s.parked for s in self.slots):
            return
        dep = self.eng.dep
        r = self._row_inputs()
        steps, maxn, greedy, done = (r["steps"], r["maxn"], r["greedy"],
                                     r["done"])
        # the sampled graph only when a live row draws (the reference's
        # static ``sample`` flag)
        sample = bool((~greedy & ~done).any())
        # the last selected token is never fed
        self._check_positions(
            np.clip(np.minimum(k, maxn - steps - 1), 1, None), done)
        lat = ok = faults = None
        if self.use_cloud:
            # a row's step advances once per active iteration, so the
            # (k, B) grid is the in-graph weather of every emitted token
            grid = steps[None, :] + np.arange(k, dtype=np.int32)[:, None]
            rids = np.broadcast_to(r["rids"], grid.shape)
            lat, ok = dep.lat_batched(rids, grid)
            if self.eng.fault is not None:
                faults = dep.fault_batched(rids, grid) + (r["bfails"],
                                                          r["bcool"])
        m = self.macro(k)
        m.prepare(sample)
        m.load(ok, steps, maxn, done, self._slot_ids(),
               r["keys"].astype(np.int32), greedy, faults)
        m.run(sample)
        self._inflight = (m, lat, ok, ~done)

    @torch.inference_mode()
    def macro_collect(self) -> List[Tuple[int, str, GenStats]]:
        """The one host sync of the macro step in flight: fetch its
        traces and replay them into the slots' stats, as ``step`` would
        have recorded them token by token: on a faulted lane each
        emitted token advances the row's breaker mirror on its traced
        loss draw, and a row whose deadline passed mid-step is cancelled
        there (the graph knows no deadlines; its row is parked and its
        pages and adapter pin released).  Returns the requests that
        finished, the dispatch's cancellations and forced completions
        first.  Rows admitted while it was in flight were done for the
        whole step (their traces are all inactive) and keep their host
        positions."""
        pending, self._pending_done = self._pending_done, []
        if self._inflight is None:
            return pending
        m, lat, ok, live = self._inflight
        self._inflight = None
        tr = self.eng.dep.fetch_traces(m.traces)
        toks, w, emit = tr[0], tr[1], tr[2].astype(bool)
        fault = m.fault
        arrived, lost = ((tr[3].astype(bool), tr[4].astype(bool))
                         if fault is not None else (ok, None))
        # the tail work of rows that finished early, which the step
        # still runs parked: no early exit, which would be a host sync
        m.parked_rows += int((live[None, :] & ~emit).sum())
        m.idle_iters += int((~emit.any(1)).sum())
        eng = self.eng
        edge32, fb32 = eng._fault_f32()
        out: List[Tuple[int, str, GenStats]] = pending
        freed: List[int] = []
        cancelled: List[int] = []
        for t in range(m.k):
            for i, s in enumerate(self.slots):
                if s is None or not emit[t, i]:
                    continue
                st = s.stats
                if s.deadline_ms is not None \
                        and st.clock_ms >= s.deadline_ms:
                    # token t and the rest of the row's trace are
                    # dropped: the per-token path's rule
                    out.append(self._cancel_row(i, s))
                    cancelled.append(i)
                    continue
                if self.use_cloud:
                    deg, lat_t = False, float(lat[t, i])
                    if fault is not None:
                        deg, raw = eng._mirror_breaker(s, lost[t, i],
                                                       len(s.out_ids))
                        lat_t = edge32 if deg else (fb32 if raw else lat_t)
                    st.cloud_tokens += int(arrived[t, i])
                    st.fallback_tokens += int(not arrived[t, i])
                    st.cloud_calls += int(not deg)
                    st.push_latency(lat_t)
                    st.fusion_w.append(float(w[t, i]))
                else:
                    st.push_latency(float(eng.latency.edge_compute_ms))
                    st.fusion_w.append(1.0)
                tok = int(toks[t, i])
                s.out_ids.append(tok)
                st.tokens += 1
                if tok == TOK.EOS or len(s.out_ids) >= s.max_new:
                    out.append((s.rid, TOK.decode(s.out_ids), st))
                    eng._release_adapter(s)
                    self.slots[i] = None
                    freed.append(i)
        # the host mirror of the rows that decode on: one slot a token
        self._advance_host_pos(live, freed + cancelled, emit.sum(0))
        if freed or cancelled:
            # parked in the step (cancelled rows were live there); now
            # mirror that and return their pages
            self._park_rows(freed + cancelled)
        return out

    def _advance_host_pos(self, live: np.ndarray, gone: List[int],
                          n: np.ndarray):
        """Advance the host position mirrors of the rows live at dispatch
        that still decode by the (B,) ``n`` slots each wrote and kept."""
        on = live.copy()
        on[gone] = False
        for c in (self.s_cache, self.l_cache):
            if c is not None:
                c["pos_host"][on] += n[on]

    def macro_step(self, k: int) -> List[Tuple[int, str, GenStats]]:
        """Dispatch and collect: k tokens of every occupied row with one
        host sync, equal to k calls of ``step``."""
        self.macro_dispatch(k)
        return self.macro_collect()

    # ------------------------------------------------- speculative decode
    def _spec_seed(self):
        """Move freshly admitted and eviction-resumed rows onto the burst
        protocol: the SLM at depth p = prompt_len + emitted with ``sl``
        predicting the next emit, the LLM one behind at p - 1 with the
        last emitted token pending in ``lt``.  A fresh row emits its
        first token here as the per-token path does (the prefill logits
        of both models are the baseline pair of emit 0, under the same
        weather and breaker) and feeds it to the SLM only.  A resumed
        row's re-prefill left both models at p: its LLM goes back to p -
        1 and its last token is pended again; the next verify rewrites
        slot p - 1 with the same (token, position) K/V."""
        eng = self.eng
        dep = eng.dep
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.parked]
        init = [i for i in live if self.slots[i].out_ids
                and self.slots[i].needs_spec_init]
        if init:
            dep.set_row_pos(self.l_cache, init, [
                self.slots[i].prompt_len + len(self.slots[i].out_ids) - 1
                for i in init])
            dep.insert_row(self.lt, to_device(np.asarray(
                [self.slots[i].out_ids[-1] for i in init], np.int64),
                dep.device), list(range(len(init))), init)
            for i in init:
                self.slots[i].needs_spec_init = False
        fresh = [i for i in live if not self.slots[i].out_ids]
        if not fresh:
            return
        b = self.batch
        rids = np.zeros((b,), np.int32)
        keys = np.zeros((b,), np.int64)
        steps = np.zeros((b,), np.int32)
        for i in fresh:
            s = self.slots[i]
            rids[i] = s.rid
            keys[i] = s.rid if s.key_id is None else s.key_id
        lat, ok = dep.lat_batched(rids, steps)
        lost = (dep.fault_batched(rids, steps)[0]
                if eng.fault is not None else None)
        lat, arrived, degraded = self._faulted(fresh, lat, ok, lost,
                                               lambda i: 0)
        probs, w = dep.fuse_batched(self.sl, self.ll, arrived)
        nxt = dep.argmax_batched(probs).cpu().numpy()
        w_host = w.cpu().numpy()
        drawn = None
        if any(not self.slots[i].greedy for i in fresh):
            drawn = dep.sample_batched(probs, keys, steps).cpu().numpy()
        fed: List[int] = []
        gone: List[int] = []
        feed = np.zeros((b, 1), np.int64)
        for i in fresh:
            s = self.slots[i]
            s.needs_spec_init = False
            st = s.stats
            if s.deadline_ms is not None and st.clock_ms >= s.deadline_ms:
                self._pending_done.append(self._cancel_row(i, s))
                gone.append(i)
                continue
            st.cloud_tokens += int(arrived[i])
            st.fallback_tokens += int(not arrived[i])
            st.cloud_calls += int(not degraded[i])
            st.push_latency(float(lat[i]))
            st.fusion_w.append(float(w_host[i]))
            tok = int(nxt[i]) if s.greedy else int(drawn[i])
            s.out_ids.append(tok)
            st.tokens += 1
            if tok == TOK.EOS or len(s.out_ids) >= s.max_new:
                self._pending_done.append((s.rid, TOK.decode(s.out_ids),
                                           st))
                eng._release_adapter(s)
                self.slots[i] = None
                gone.append(i)
            else:
                feed[i, 0] = tok
                fed.append(i)
        if gone:
            self._park_rows(gone)
        if not fed:
            return
        # the seed tokens go to the SLM only: every other live row is
        # parked for this one decode, and only the fed rows take its
        # logits (in place: a burst graph reads the lane's tensors)
        others = [(i, self.slots[i].prompt_len
                   + len(self.slots[i].out_ids))
                  for i in live if self.slots[i] is not None
                  and i not in fed]
        if others:
            dep.set_row_pos(self.s_cache, [i for i, _ in others],
                            [FREED_POS] * len(others))
        s_logits, _ = dep.slm_decode(eng.slm_params, self.s_cache,
                                     to_device(feed, dep.device), eng.lora,
                                     self._decode_gates())
        dep.insert_row(self.sl, s_logits[:, 0], fed, fed)
        dep.insert_row(self.lt, to_device(feed[:, 0], dep.device), fed,
                       fed)
        if others:
            dep.set_row_pos(self.s_cache, *zip(*others))

    @torch.inference_mode()
    def spec_chain(self, n_bursts: int, k: int) -> LaneSpec:
        """The lane's speculative burst chain, built (and on CUDA
        captured) at its first use; like ``macro``, its shape is fixed
        for the lane's life."""
        key = (n_bursts, k, self._slot_kernel())
        if self._spec_chain is None:
            self._spec_chain = LaneSpec(self, n_bursts, k, slot_ids=key[2])
        c = self._spec_chain
        built = (c.n_bursts, c.k, c.slot_ids is not None)
        if built != key:
            raise ValueError(f"the lane's burst chain was built for "
                             f"(bursts, k, slot ids) {built}, not {key}")
        return c

    @torch.inference_mode()
    def spec_dispatch(self, n_bursts: int, k: int):
        """Dispatch ``n_bursts`` chained speculative bursts of k tokens
        without a host sync (``spec_collect`` syncs once): expired
        requests are cancelled, evicted ones re-admitted, pages
        provisioned for every draft write and the seed token (n_bursts
        * k + 1 positions) and fresh rows seeded (``_spec_seed``,
        host-synchronous) first.  No-op when the lane is idle or a step
        is already in flight."""
        if self._inflight is not None:
            return
        dep = self.eng.dep
        self._pending_done.extend(self._cancel_expired())
        self._readmit_evicted()
        self._pending_done.extend(self._provision(n_bursts * k + 1))
        if self.active:
            self._spec_seed()
        if not any(s is not None and not s.parked for s in self.slots):
            return
        r = self._row_inputs()
        steps, maxn, greedy, done = (r["steps"], r["maxn"], r["greedy"],
                                     r["done"])
        sample = bool((~greedy & ~done).any())
        self._check_positions(
            np.clip(np.minimum(n_bursts * k, maxn - steps - 1), 1, None),
            done)
        # the weather of every step a burst can start at
        grid = steps[:, None] + np.arange(n_bursts * k + 1,
                                          dtype=np.int32)[None, :]
        rids = np.broadcast_to(r["rids"][:, None], grid.shape)
        lat, ok = dep.lat_batched(rids, grid)
        lost = outage = None
        if self.eng.fault is not None:
            lost, outage = dep.fault_batched(rids, grid)
        c = self.spec_chain(n_bursts, k)
        c.prepare(sample)
        c.load(ok, lost, outage, steps, maxn, done, self._slot_ids(),
               r["keys"].astype(np.int32), greedy,
               (r["bfails"], r["bcool"]))
        c.run(sample)
        self._inflight = (c, lat, steps, ~done)

    @torch.inference_mode()
    def spec_collect(self) -> List[Tuple[int, str, GenStats]]:
        """The one host sync of the burst chain in flight: fetch every
        burst's traces and replay them into the slots in burst order.  A
        burst's first token is charged its one cloud round-trip, the
        accepted tokens behind it the edge decode; per burst and row one
        breaker transition of the mirror, cloud_calls += 1 unless the
        row ran degraded, spec_drafted += k and spec_accepted += the
        accepted drafts.  Deadlines cancel as in ``macro_collect``."""
        pending, self._pending_done = self._pending_done, []
        if self._inflight is None:
            return pending
        c, lat, steps0, live = self._inflight
        self._inflight = None
        eng = self.eng
        k = c.k
        tr = eng.dep.fetch_traces(c.traces)
        fault = eng.fault
        edge32, fb32 = eng._fault_f32()
        out: List[Tuple[int, str, GenStats]] = pending
        freed: List[int] = []
        cancelled: List[int] = []
        emitted = np.zeros((self.batch,), np.int64)
        for burst in tr:
            sels, w = burst[:k], burst[k:2 * k]
            n_emit = burst[2 * k].astype(np.int64)
            c_sel = burst[2 * k + 1].astype(np.int64)
            arrived = burst[2 * k + 2].astype(bool)
            lost = burst[2 * k + 3].astype(bool)
            emitted += n_emit
            for i, s in enumerate(self.slots):
                if s is None or not n_emit[i]:
                    continue
                st = s.stats
                if s.deadline_ms is not None \
                        and st.clock_ms >= s.deadline_ms:
                    out.append(self._cancel_row(i, s))
                    cancelled.append(i)
                    continue
                lat_b = float(lat[i, len(s.out_ids) - steps0[i]])
                deg = False
                if fault is not None:
                    deg, raw = eng._mirror_breaker(s, lost[i],
                                                   len(s.out_ids))
                    lat_b = edge32 if deg else (fb32 if raw else lat_b)
                st.spec_drafted += k
                st.spec_accepted += int(min(n_emit[i], c_sel[i]))
                st.cloud_calls += int(not deg)
                if deg:
                    # the burst's one degraded breaker step covers all
                    # its tokens: pure SLM drafts at no cloud cost
                    extra = int(n_emit[i]) - 1
                    st.degraded_tokens += extra
                    eng._health["degraded_tokens"] += extra
                for t in range(int(n_emit[i])):
                    if s.deadline_ms is not None \
                            and st.clock_ms >= s.deadline_ms:
                        out.append(self._cancel_row(i, s))
                        cancelled.append(i)
                        break
                    st.cloud_tokens += int(arrived[i])
                    st.fallback_tokens += int(not arrived[i])
                    st.push_latency(lat_b if t == 0 else edge32)
                    st.fusion_w.append(float(w[t, i]))
                    tok = int(sels[t, i])
                    s.out_ids.append(tok)
                    st.tokens += 1
                    if tok == TOK.EOS or len(s.out_ids) >= s.max_new:
                        out.append((s.rid, TOK.decode(s.out_ids), st))
                        eng._release_adapter(s)
                        self.slots[i] = None
                        freed.append(i)
                        break
        self._advance_host_pos(live, freed + cancelled, emitted)
        if freed or cancelled:
            self._park_rows(freed + cancelled)
        return out

    def _park_rows(self, freed: List[int]):
        """Park freed rows at FREED_POS: the fixed-width batch still
        spends their work, but their cache writes drop and their
        positions hold.  A dense row stays resident until an admission
        replaces it whole; a paged row's pages are released."""
        if self.eng.paged:
            self._release_rows(freed)
            return
        self._set_positions([(i, FREED_POS) for i in freed])

    def _release_rows(self, freed: List[int]):
        """Paged parking releases memory for real: pos to FREED_POS AND
        table rows to NO_PAGE on the device, then the pages go back to
        the host free lists for the next admission."""
        dep = self.eng.dep
        dep.free_paged_rows(self.s_cache, freed)
        if self.use_cloud:
            dep.free_paged_rows(self.l_cache, freed)
        for i in freed:
            self.pager_s.release(i)
            if self.pager_l is not None:
                self.pager_l.release(i)

    # ------------------------------------------------------- lazy growth
    def _set_positions(self, updates: List[Tuple[int, int]]):
        """Row positions (park and unpark) of both caches, in place and
        outside any graph: (row, pos) pairs."""
        if not updates:
            return
        idx, val = zip(*updates)
        self.eng.dep.set_row_pos(self.s_cache, idx, val)
        if self.use_cloud:
            if self._spec:
                # an unparked row's LLM goes back one behind (p - 1);
                # parking sentinels pass as they are
                val = [v - 1 if v < FREED_POS else v for v in val]
            self.eng.dep.set_row_pos(self.l_cache, idx, val)

    def _apply_growth(self, which: str, ups: List[Tuple[int, int, int]]):
        """ONE block-table scatter per model per boundary for all rows'
        freshly grown pages."""
        if not ups:
            return
        rows, cols, pids = (list(x) for x in zip(*ups))
        cache = self.s_cache if which == "s" else self.l_cache
        self.eng.dep.grow_block_pages(cache, rows, cols, pids)

    def _grow_row(self, i: int, s: _Slot, k: int, ups_s, ups_l) -> bool:
        """Ensure row ``i`` has pages for its next (up to) ``k`` decode
        writes.  Token n writes at position prompt_len + n and the last
        selected token is never fed, so a row with <= 1 budget left
        writes nothing.  Growth is atomic across both pagers; True means
        the row can decode this boundary."""
        ps = self.eng.dep.page_size
        n = len(s.out_ids)
        rem = s.max_new - n
        if rem <= 1:
            return True
        hi = s.prompt_len + n + min(k, rem - 1) - 1
        need = hi // ps + 1
        g_s = need - len(self.pager_s.rows[i].full)
        g_l = need - len(self.pager_l.rows[i].full) if self.use_cloud else 0
        if g_s <= 0 and g_l <= 0:
            return True
        got_s = self.pager_s.grow(i, g_s) if g_s > 0 else []
        if got_s is None:
            return False
        got_l: List[int] = []
        if g_l > 0:
            got_l = self.pager_l.grow(i, g_l)
            if got_l is None:
                if got_s:
                    self.pager_s.ungrow(i, got_s)
                return False
        for t, pid in enumerate(got_s):
            ups_s.append((i, need - g_s + t, pid))
        for t, pid in enumerate(got_l):
            ups_l.append((i, need - g_l + t, pid))
        self.eng._stat["grown_pages"] += len(got_s) + len(got_l)
        return True

    def _provision(self, k: int) -> List[Tuple[int, str, GenStats]]:
        """Lazy-growth pass at a decode boundary: extend live rows' block
        tables (oldest admission first: deterministic page handout, no
        starvation among waiters) before the next k tokens.  A row whose
        growth cannot be met PARKS (pos to FREED_POS, its writes drop,
        its pending logits are kept) and resumes bit-identically once
        pages free.  If every live row is parked the lane is wedged: the
        youngest rows are EVICTED (pages released, the request
        re-admitted later from prompt + tokens so far) until the oldest
        grows.  The admission gate bounds each row's worst case by the
        pool, so a lone row always completes; one that still cannot
        grow is force-completed with the tokens it has.  Returns the
        forced completions.  Dense lanes and eager reservation
        (``lazy_pages=False``) make this a no-op (the reference's
        ``_provision``, ``engine.py:1317-1376``)."""
        eng = self.eng
        if not eng.paged or not eng.lazy_pages:
            return []
        forced: List[Tuple[int, str, GenStats]] = []
        while True:
            order = sorted((i for i, s in enumerate(self.slots)
                            if s is not None),
                           key=lambda i: self.slots[i].seq)
            if not order:
                return forced
            ups_s: List[Tuple[int, int, int]] = []
            ups_l: List[Tuple[int, int, int]] = []
            pos_ups: List[Tuple[int, int]] = []
            any_active = False
            for i in order:
                s = self.slots[i]
                if self._grow_row(i, s, k, ups_s, ups_l):
                    if s.parked:
                        s.parked = False
                        pos_ups.append((i, s.prompt_len + len(s.out_ids)))
                    any_active = True
                elif not s.parked:
                    s.parked = True
                    pos_ups.append((i, FREED_POS))
                    eng._stat["parks"] += 1
            self._apply_growth("s", ups_s)
            if self.use_cloud:
                self._apply_growth("l", ups_l)
            self._set_positions(pos_ups)
            if any_active:
                return forced
            if len(order) > 1:
                self._evict(order[-1])      # youngest first
                continue
            i = order[0]
            s = self.slots[i]
            forced.append((s.rid, TOK.decode(s.out_ids), s.stats))
            eng._release_adapter(s)
            self.slots[i] = None
            self._release_rows([i])
            eng._stat["forced"] += 1

    def _evict(self, i: int):
        """Release a parked row's pages and queue its request for
        re-admission: prompt + every selected token re-prefill later,
        landing on the distribution it was parked on (the prefill's
        last-position logits are the next selection's)."""
        s = self.slots[i]
        self.slots[i] = None
        self._release_rows([i])
        self._evictq.append(s)
        self.eng._stat["evictions"] += 1
        self.eng.evicted_rids.append(s.rid)

    def _readmit_evicted(self):
        """Re-admit evicted requests, oldest first, into free slots and
        pages, each reserving its lazy demand for prompt + tokens so
        far, capped at its worst case.  The admission gate refuses
        external requests while an eviction is pending, so FIFO order
        survives eviction; a blocked head blocks the rest (the
        reference's ``_readmit_evicted``, ``engine.py:1389-1424``)."""
        if not self._evictq:
            return
        eng = self.eng
        self._evictq.sort(key=lambda s: s.seq)
        free = self.free_slots()
        jobs: List[_Job] = []
        while self._evictq and free:
            s = self._evictq[0]
            ids = list(s.prompt_ids) + list(s.out_ids)
            alloc_len = min(s.prompt_len + s.max_new, eng.max_ctx)
            nf_s, _ = self.pager_s.demand_lazy(len(ids), alloc_len)
            nf_l = (self.pager_l.demand_lazy(len(ids), alloc_len)[0]
                    if self.use_cloud else 0)
            if not self.pager_s.fits_free(nf_s, self.pager_s.nl) or (
                    self.use_cloud
                    and not self.pager_l.fits_free(nf_l, self.pager_l.nl)):
                break
            slot = free.pop(0)
            cap = PAG.pages_for(alloc_len, eng.dep.page_size)
            rows_s = self.pager_s.admit(slot, nf_s, cap_pages=cap)
            rows_l = (self.pager_l.admit(slot, nf_l, cap_pages=cap)
                      if self.use_cloud else None)
            jobs.append(_Job(slot, s.full_text, s.max_new, s.greedy, s.rid,
                             s.stats.private, s.key_id, ids, rows_s,
                             rows_l, seq=s.seq, aslot=s.aslot, resume=s))
            self._evictq.pop(0)
        self.admit_many(jobs)


class BatchedHybridEngine(HybridEngine):
    """Continuous-batching Floe engine on paged (or dense) lanes.

    Two fixed-width decode batches ("lanes"): cloud-eligible requests
    share a hybrid SLM+LLM batch whose per-token fusion runs through K1
    with a per-row Sec. IV-D arrived mask; private requests share an
    SLM-only batch (Alg. 2).  Admissions that arrive in the same step
    share one packed B>1 prefill (prompts padded to a chunk-rounded
    length, per-row lengths masked) whose K/V are scattered into the
    rows' reserved pool pages; decode attention reads the pages through
    K2.  Admission is gated on free slots and free pages: the lazy
    demand (prompt pages + one decode page) is reserved and grown at
    page boundaries; a worst-case demand beyond the total pool is a
    hard reject (``pop_rejected``).  ``pool_pages`` (both models, or the
    SLM's with ``llm_pool_pages``) and ``local_pool_pages`` (ring pages)
    set pools below the default, batch x table width: a row whose
    growth cannot be met parks, and a wedged lane evicts its youngest
    rows and re-admits them later (``growth_stats``).  ``paged=False``
    keeps dense stacked lane caches, the bit-exact parity oracle,
    whose rows K2 reads in place as pages on the card.  A request
    naming a per-user adapter pins it into a slot of the engine's
    ``AdapterCache`` for its lifetime; every slot pinned is a soft
    refusal (FIFO, like pages), an unknown adapter id a hard reject.
    Decode LoRA runs through K5 on
    the lane's gate rows, or through K4 on per-row slot ids with
    ``use_slot_kernel=True``; admission prefill always takes K5.

    ``macro_k=K`` (default 8, the reference's) decodes K tokens a lane
    per dispatch with one host sync (a CUDA graph per lane on the card);
    ``macro_k=0`` is the per-token path.  A request's ``prefix`` is
    COW-shared on paged lanes (``_Lane.ensure_prefix``) when no router
    gates the bank, it names no adapter and its prompt fits
    ``chunk_width``; dense lanes prefill it as part of the prompt.
    ``chunk_width`` (page-aligned, in [page_size, max_seq], default
    max_seq) is the width of the dense prefill buffer: a wider prompt,
    up to the deployment's ``max_ctx``, streams through chunked prefill
    on paged lanes.  A dense lane cuts a prompt to max_seq - max_new - 1
    tokens, a paged one to max_ctx - max_new - 1.  ``spec_k=k`` > 0
    decodes the cloud lane in speculative bursts of k tokens a cloud
    round-trip (``serving/spec.py``): ceil(macro_k / k) bursts a
    dispatch with one host sync, or one a step at ``macro_k=0``; k may
    not exceed a ring window of either model.  A request's
    ``deadline_ms`` bounds its simulated clock (``add_requests``)."""

    def __init__(self, slm=None, slm_params=None, llm=None, llm_params=None,
                 alignment_mlp=None, expert_bank=None,
                 router: Optional[Router] = None,
                 detector: Optional[PrivacyDetector] = None,
                 latency: Optional[LatencyModel] = None,
                 timeout_ms: float = 200.0, max_seq: int = 96,
                 sample_seed: int = 0, batch_size: int = 8,
                 edge_batch_size: Optional[int] = None, block_b: int = 4,
                 macro_k: int = 8, paged: bool = True,
                 pool_pages: Optional[int] = None,
                 local_pool_pages: Optional[int] = None,
                 llm_pool_pages: Optional[int] = None,
                 lazy_pages: bool = True,
                 chunk_width: Optional[int] = None, spec_k: int = 0,
                 use_slot_kernel: bool = False,
                 deployment: Optional[ServingDeployment] = None,
                 device=None):
        deployment = _hybrid_deployment(
            deployment, slm, slm_params, llm, llm_params, alignment_mlp,
            expert_bank, latency, timeout_ms, max_seq, sample_seed, device,
            block_b=(block_b, 4))
        if deployment.llm is None:
            raise ValueError(
                "BatchedHybridEngine needs a hybrid (SLM+LLM) deployment; "
                "this one is SLM-only — serve it with SoloEngine")
        super().__init__(router=router, detector=detector,
                         deployment=deployment)
        for lm in (self.dep.slm, self.dep.llm):
            if lm.cfg.family != "dense":
                raise NotImplementedError(
                    "batched continuous decode supports dense-family "
                    f"models (got {lm.cfg.family})")
        if macro_k < 0:
            raise ValueError(f"macro_k={macro_k} must be >= 0")
        if spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0")
        # a burst's k draft slots must be distinct cache slots for its
        # snapshot and rollback, so k is bounded by every ring window
        for lm in (self.dep.slm, self.dep.llm) if spec_k else ():
            loc = lm._ring_local_len(deployment.max_seq)
            if loc and spec_k > loc:
                raise ValueError(
                    f"spec_k={spec_k} exceeds the {loc}-slot ring window "
                    f"of {lm.cfg.name}: a draft burst would wrap the ring "
                    "and its rollback snapshot would alias slots")
        self.spec_k = spec_k
        ps = deployment.page_size
        self.chunk_width = chunk_width or deployment.max_seq
        if self.chunk_width % ps \
                or not ps <= self.chunk_width <= deployment.max_seq:
            raise ValueError(f"chunk_width={self.chunk_width} must be "
                             f"page-aligned in [{ps}, {deployment.max_seq}]")
        self.slm, self.llm = deployment.slm, deployment.llm
        self.macro_k = macro_k
        self.paged = paged
        self.pool_pages = pool_pages
        self.local_pool_pages = local_pool_pages
        self.llm_pool_pages = llm_pool_pages
        self.lazy_pages = lazy_pages
        self.max_ctx = deployment.max_ctx
        # decode LoRA through K4 on per-row adapter slots instead of K5
        # on one-hot gate rows
        self.use_slot_kernel = use_slot_kernel
        self._seq = 0
        self._stat = dict(grown_pages=0, parks=0, evictions=0, forced=0)
        # the rid of every eviction, in order, beside the counters
        self.evicted_rids: List[int] = []
        self._rejected: List[Tuple[int, str]] = []
        self.cloud_lane = _Lane(self, batch_size, use_cloud=True)
        self.edge_lane = _Lane(self, edge_batch_size or batch_size,
                               use_cloud=False)

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def growth_stats(self) -> Dict[str, int]:
        """Lazy-growth counters: pages grown at boundaries, rows parked
        for pages, evictions and forced completions."""
        return dict(self._stat)

    def _make_pager(self, lm, batch: int) -> PAG.LanePager:
        """Host page bookkeeping for one (lane, model): the default pools
        are the dense equivalent, batch x full table width and batch x
        ring-local table width; ``pool_pages`` (the LLM's
        ``llm_pool_pages`` where given) and ``local_pool_pages`` replace
        them."""
        geo = self.dep.paged_geometry(lm)
        pages = (self.pool_pages if self.pool_pages is not None
                 else batch * geo["nb"])
        if lm is self.dep.llm and self.llm_pool_pages is not None:
            pages = self.llm_pool_pages
        local = (self.local_pool_pages if self.local_pool_pages is not None
                 else batch * geo["nl"])
        pager = PAG.LanePager(batch, self.max_seq, self.dep.page_size,
                              pages, geo["local_len"], local,
                              max_ctx=self.max_ctx)
        pager.geo = geo
        return pager

    # ------------------------------------------------------------- public
    def add_request(self, prompt: str, max_new_tokens: int = 16,
                    greedy: bool = True, rid: int = 0,
                    seed: Optional[int] = None,
                    prefix: Optional[str] = None,
                    adapter_id: Optional[Any] = None,
                    deadline_ms: Optional[float] = None) -> bool:
        """Admit one request; False if it could not be admitted now (lane
        full, free pages short, an eviction pending or every adapter
        slot pinned).  A page
        demand beyond the total pool or an unknown adapter id is a hard
        reject, surfaced through ``pop_rejected``."""
        return self.add_requests([(prompt, max_new_tokens, greedy, rid,
                                   seed, prefix, adapter_id,
                                   deadline_ms)])[0]

    def _adapter_reject_msg(self, aid) -> str:
        if self.adapters is None:
            return (f"adapter_id={aid!r} on an engine without adapter "
                    "slots — build the ServingDeployment with "
                    "adapter_slots=")
        return (f"unknown adapter id {aid!r}: register it on "
                "engine.adapters before submitting requests that name it")

    def _acquire_or_block(self, aid, blocked, private) -> Tuple:
        """The admission-side adapter gate: (ok, slot).  A refused
        acquire BLOCKS the lane for the rest of the burst (FIFO: later
        arrivals must not overtake a request waiting on a slot), as a
        page refusal does."""
        if aid is None:
            return True, None
        aslot = self.adapters.acquire(aid)
        if aslot is None:
            blocked[private] = True
            return False, None
        return True, aslot

    def add_requests(self, reqs: List[Tuple]) -> List[bool]:
        """Admit a burst of (prompt, max_new_tokens, greedy, rid[, seed
        [, prefix[, adapter_id[, deadline_ms]]]]) requests; adapter_id
        pins a registered per-user adapter for the request's lifetime,
        deadline_ms bounds its simulated clock.  Requests landing in the
        same lane share ONE packed B>1 prefill.  Returns per-request
        admitted flags; soft-refused requests are retried later, hard
        rejects land in ``pop_rejected``.  ``prefix`` is a shared
        preamble: the request serves prefix + prompt, with the
        preamble's pages COW-shared where the paged gate allows.

        Admission gate: a free SLOT and, on paged lanes, free PAGES
        per model.  The lazy demand (prompt pages + one decode page,
        capped at the worst case) is reserved here; the hard-reject
        predicate is the worst case against TOTAL pool capacity.  A soft
        refusal blocks the lane for the rest of the burst (FIFO: later
        arrivals never overtake a waiting request), and a lane with an
        eviction pending admits nothing external."""
        flags = [False] * len(reqs)
        jobs: Dict[bool, List[_Job]] = {True: [], False: []}
        free = {True: self.edge_lane.free_slots(),
                False: self.cloud_lane.free_slots()}
        blocked = {True: bool(self.edge_lane._evictq),
                   False: bool(self.cloud_lane._evictq)}
        for i, (prompt, max_new, greedy, rid, *rest) in enumerate(reqs):
            seed = rest[0] if rest else None
            prefix = rest[1] if len(rest) > 1 else None
            aid = rest[2] if len(rest) > 2 else None
            deadline = rest[3] if len(rest) > 3 else None
            full = (prefix or "") + prompt
            private = self.detector.detect(full)
            lane = self.edge_lane if private else self.cloud_lane
            if aid is not None and (self.adapters is None
                                    or not self.adapters.known(aid)):
                self._rejected.append((rid, self._adapter_reject_msg(aid)))
                continue
            raw = TOK.encode(full + " ")
            # a dense row holds max_seq positions, a paged one max_ctx
            cap_ids = (self.max_ctx if self.paged
                       else self.max_seq) - max_new - 1
            ids = raw[:cap_ids]
            truncated = len(raw) > cap_ids
            if not self.paged:
                if blocked[private] or not free[private]:
                    continue
                ok, aslot = self._acquire_or_block(aid, blocked, private)
                if not ok:
                    continue
                jobs[private].append(_Job(
                    free[private].pop(0), full, max_new, greedy, rid,
                    private, seed, ids, None, None, truncated=truncated,
                    aslot=aslot, deadline_ms=deadline))
                flags[i] = True
                continue
            alloc_len = min(len(ids) + max_new, self.max_ctx)
            cap_pages = PAG.pages_for(alloc_len, self.dep.page_size)
            entry = None
            if prefix and self.router is None and aid is None \
                    and len(ids) <= self.chunk_width:
                # COW sharing needs the tokenization to split at the
                # prefix boundary, a suffix to prefill, and a prompt the
                # dense prefill buffer holds (a wider one goes chunked,
                # unshared); router-gated requests would merge their own
                # LoRA into the preamble's K/V, so they never share
                entry = lane.ensure_prefix(prefix)
                if entry is not None and not (
                        len(ids) > entry["pre_len"]
                        and ids[:entry["pre_len"]] == entry["pre_ids"]):
                    entry = None
            share_np = entry["share_np"] if entry else 0
            worst_s = lane.pager_s.demand(alloc_len, share_np)
            worst_l = (lane.pager_l.demand(alloc_len, share_np)
                       if lane.use_cloud else (0, 0))
            if not lane.pager_s.fits_pool(*worst_s):
                self._rejected.append((rid, (
                    f"slm page demand {worst_s[0]} exceeds pool "
                    f"capacity {lane.pager_s.alloc.num_pages} pages")))
                continue
            if lane.use_cloud and not lane.pager_l.fits_pool(*worst_l):
                self._rejected.append((rid, (
                    f"llm page demand {worst_l[0]} exceeds pool "
                    f"capacity {lane.pager_l.alloc.num_pages} pages")))
                continue
            if blocked[private]:
                continue                   # FIFO: no overtaking
            if self.lazy_pages:
                nf_s, nl_s = lane.pager_s.demand_lazy(len(ids), alloc_len,
                                                      share_np)
                nf_l, nl_l = (lane.pager_l.demand_lazy(len(ids), alloc_len,
                                                       share_np)
                              if lane.use_cloud else (0, 0))
            else:
                (nf_s, nl_s), (nf_l, nl_l) = worst_s, worst_l
            if not free[private] \
                    or not lane.pager_s.fits_free(nf_s, nl_s) or (
                        lane.use_cloud
                        and not lane.pager_l.fits_free(nf_l, nl_l)):
                blocked[private] = True    # soft: retry when pages free
                continue
            ok, aslot = self._acquire_or_block(aid, blocked, private)
            if not ok:                     # soft: retry when pins drop
                continue
            slot = free[private].pop(0)
            rows_s = lane.pager_s.admit(
                slot, nf_s, shared=entry["pids_s"] if entry else (),
                cap_pages=cap_pages)
            rows_l = (lane.pager_l.admit(
                slot, nf_l, shared=entry["pids_l"] if entry else (),
                cap_pages=cap_pages) if lane.use_cloud else None)
            jobs[private].append(_Job(
                slot, full, max_new, greedy, rid, private, seed, ids,
                rows_s, rows_l, seq=self._next_seq(), truncated=truncated,
                aslot=aslot, entry=entry, deadline_ms=deadline))
            flags[i] = True
        self.edge_lane.admit_many(jobs[True])
        self.cloud_lane.admit_many(jobs[False])
        return flags

    def pop_rejected(self) -> List[Tuple[int, str]]:
        """Drain the hard-reject log: (rid, reason) for requests whose
        page demand can NEVER fit the pools or whose adapter id is
        unknown."""
        out, self._rejected = self._rejected, []
        return out

    def _lane_models(self, lane: _Lane):
        """(model, its lane cache, its pager) of a lane's models."""
        out = [(self.slm, lane.s_cache, lane.pager_s)]
        if lane.use_cloud:
            out.append((self.llm, lane.l_cache, lane.pager_l))
        return out

    def resident_kv_bytes(self) -> int:
        """Bytes of KV state currently LIVE: allocated pages on paged
        lanes; on dense lanes the allocated lane caches, batch x max_seq
        whatever the occupancy."""
        total = 0
        for lane in (self.cloud_lane, self.edge_lane):
            for lm, cache, pager in self._lane_models(lane):
                if pager is not None:
                    total += pager.live_bytes(pager.geo["page_bytes_full"],
                                              pager.geo["page_bytes_local"])
                elif cache is not None:
                    total += self.dep.lane_kv_bytes(lm, lane.batch)
        return total

    def kv_pool_bytes(self) -> int:
        """Total KV capacity in bytes: every lane's pool pages (the sink
        page each pool carries is not capacity), or its dense lane
        caches; computed from the geometry, so it is meaningful before
        first admission."""
        total = 0
        for lane in (self.cloud_lane, self.edge_lane):
            for lm, _, pager in self._lane_models(lane):
                if pager is None:
                    total += self.dep.lane_kv_bytes(lm, lane.batch)
                    continue
                full, local = pager.pool_pages()
                total += (full * pager.geo["page_bytes_full"]
                          + local * pager.geo["page_bytes_local"])
        return total

    def active_count(self) -> int:
        """Occupied rows, and evicted requests awaiting re-admission:
        they hold no pages, but the lane owes them a completion."""
        return sum(lane.active + len(lane._evictq)
                   for lane in (self.cloud_lane, self.edge_lane))

    def macro_stats(self) -> Dict[str, float]:
        """Over both lanes: macro steps built, the seconds their graph
        captures took on CUDA (the sampled graphs' alone too), graph
        replays (of the sampled graphs too), (iteration, row) pairs that
        rows live at dispatch spent parked after finishing, and
        iterations in which no row of the lane decoded."""
        ms = [lane._macro for lane in (self.cloud_lane, self.edge_lane)
              if lane._macro is not None]
        return dict(macros=len(ms), capture_s=sum(m.capture_s for m in ms),
                    sample_capture_s=sum(m.sample_capture_s for m in ms),
                    replays=sum(m.replays for m in ms),
                    sample_replays=sum(m.sample_replays for m in ms),
                    parked_rows=sum(m.parked_rows for m in ms),
                    idle_iters=sum(m.idle_iters for m in ms))

    def spec_stats(self) -> Dict[str, float]:
        """The cloud lane's speculative burst chain: bursts per dispatch,
        graph replays (of the sampled graph too) and capture seconds on
        CUDA.  Empty without speculation or before the first dispatch."""
        c = self.cloud_lane._spec_chain
        if c is None:
            return {}
        return dict(bursts=c.n_bursts, k=c.k, replays=c.replays,
                    sample_replays=c.sample_replays, capture_s=c.capture_s)

    def dispatch_step(self):
        """Dispatch both lanes' macro steps (the cloud lane's burst chain
        with ``spec_k``) without syncing (a no-op on the per-token path,
        ``macro_k=0``, which is host-synchronous).  Follow with
        admission work to overlap it with the decode in flight, then
        ``collect_step()``."""
        if self.macro_k:
            self.edge_lane.macro_dispatch(self.macro_k)
            if self.spec_k:
                self.cloud_lane.spec_dispatch(
                    -(-self.macro_k // self.spec_k), self.spec_k)
            else:
                self.cloud_lane.macro_dispatch(self.macro_k)

    def collect_step(self) -> List[Tuple[int, str, GenStats]]:
        """Sync and replay the steps in flight (with ``macro_k=0``, run
        one per-token step of the edge lane and one burst of a
        speculative cloud lane, or a per-token step); returns the
        requests that finished."""
        if self.macro_k:
            return (self.edge_lane.macro_collect()
                    + (self.cloud_lane.spec_collect() if self.spec_k
                       else self.cloud_lane.macro_collect()))
        out = self.edge_lane.step()
        if self.spec_k:
            self.cloud_lane.spec_dispatch(1, self.spec_k)
            return out + self.cloud_lane.spec_collect()
        return out + self.cloud_lane.step()

    def step(self) -> List[Tuple[int, str, GenStats]]:
        """Advance both lanes by one macro step (``macro_k`` tokens a
        row, one dispatch and one host sync a lane) or, with
        ``macro_k=0``, by one per-token step."""
        self.dispatch_step()
        return self.collect_step()


# ===========================================================================
# Single-model serving (the SLM-only baseline)
# ===========================================================================


class SoloEngine:
    """Single-model greedy decoding over an SLM-only deployment (the
    paper's SLM-only baseline, and the way an SSM such as falcon-mamba
    is served: no Floe pair shares its vocabulary).  ``router`` gates
    the deployment's expert bank; a deployment with ``adapter_slots``
    gives the engine its own ``AdapterCache``: a request's one-hot gate
    row takes K5 at prefill and its slot id K4 at decode.  Both families
    serve LoRA: the dense one on its attention and MLP projections,
    Mamba-1 on its four SSM projections."""

    def __init__(self, lm=None, params=None, expert_bank=None,
                 router: Optional[Router] = None, max_seq: int = 96,
                 deployment: Optional[ServingDeployment] = None,
                 device=None):
        if deployment is None:
            deployment = ServingDeployment(lm, params,
                                           expert_bank=expert_bank,
                                           max_seq=max_seq, device=device)
        else:
            _reject_deployment_args(lm=(lm, None), params=(params, None),
                                    expert_bank=(expert_bank, None),
                                    max_seq=(max_seq, 96),
                                    device=(device, None))
        self.dep = deployment
        self.lm, self.params = deployment.slm, deployment.slm_params
        self.bank, self.router = deployment.bank, router
        self.max_seq = deployment.max_seq
        self.adapters = (deployment.make_adapter_cache()
                         if deployment.adapter_slots else None)
        if self.bank is not None and router is None:
            raise ValueError(_BANK_NEEDS_GATING)
        if self.bank is not None and self.adapters is not None:
            raise ValueError(
                "router-gated expert bank and per-user adapter slots "
                "are mutually exclusive")
        self._lora = (deployment.lora
                      if router is not None and self.bank is not None
                      else None)
        # whether the LAST generate() call had to cut its prompt
        self.last_truncated = False

    lora = HybridEngine.lora
    adapter_stats = HybridEngine.adapter_stats

    @torch.inference_mode()
    def generate(self, prompt: str, max_new_tokens: int = 16,
                 adapter_id: Optional[Any] = None) -> str:
        """Greedy text of up to ``max_new_tokens`` tokens.  The prompt is
        cut to max_seq - max_new_tokens - 1 tokens (``last_truncated``
        says whether it was).  ``adapter_id`` pins a registered per-user
        adapter for the request; otherwise a router-gated engine gates
        its bank with the prompt's ω."""
        dep = self.dep
        gates = lora = aslot = None
        if adapter_id is not None:
            if self.adapters is None:
                raise ValueError("adapter_id= needs a deployment built with "
                                 "adapter_slots=")
            aslot = self.adapters.acquire(adapter_id)
            if aslot is None:       # a B=1 engine releases every pin
                raise RuntimeError("no adapter slot free")
            gates = _admission_gates(self, [(prompt, aslot)])
            lora = self.lora
        elif self.router is not None and self.bank is not None:
            gates = _admission_gates(self, [(prompt, None)])
            lora = self.lora
        raw = TOK.encode(prompt + " ")
        cap = self.max_seq - max_new_tokens - 1
        self.last_truncated = len(raw) > cap
        logits, cache = dep.slm_prefill(self.params, dep.tokens(raw[:cap]),
                                        lora, gates)
        if aslot is not None:
            gates = to_device(np.asarray([aslot], np.int32), dep.device)
        out: List[int] = []
        for _ in range(max_new_tokens):
            nxt = int(torch.argmax(logits[0, 0]))
            out.append(nxt)
            if nxt == TOK.EOS:
                break
            logits, cache = dep.slm_decode(self.params, cache,
                                           dep.tokens([nxt]), lora, gates)
        if aslot is not None:
            self.adapters.release(aslot)
        return TOK.decode(out)
