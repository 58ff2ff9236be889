"""The K-token macro step of a batched lane — the port of the body of
``ServingDeployment._make_macro`` in ``repro/serving/deployment.py``.

One macro step decodes K tokens for every row of a lane with one host
sync.  Each iteration runs the per-token step on the device: the
Sec. IV-D arrived mask (``cloud_arrival_mask``), the Eq. 14-15 fusion
through K1 (the SLM softmax on the edge lane), the next-token epilogue
(the greedy argmax, or per row the argmax or the keyed draw through K7),
the EOS and ``max_new`` done masks, the parking of rows that just finished
(pos = FREED_POS before the decode, so their caches never see the dummy
token), the SLM decode (K2, and K4/K5 on the lane's gates) and the LLM
decode (K2), the keep mask that holds a finished row's pending logits,
and the (token, w, active) traces of row t of (K, B) buffers.  Rows
that finish mid-macro ride along parked, so a macro step equals K
per-token steps.

On a fault-injected link the cloud lane's graph also carries each row's
circuit breaker: static (B,) ``fails`` and ``cooldown`` buffers, loaded
from the slots' host mirrors and advanced in place at every iteration by
``breaker_transition_device`` on the iteration's injected fault (the
(K, B) loss draws and outage schedule, drawn on the host at steps0 + t
and uploaded with the arrivals: a row's step advances once per active
iteration, so the grid holds every emitted token's weather).  The
arrived mask takes all fault terms, and the traces gain the arrived
mask and the loss draw, from which the host replays its mirrors.  The
fault-free lane's graph has no breaker op.

The reference runs the K iterations as a ``lax.scan`` and donates the
lane's caches to it.  Here every update is in place on the lane's own
tensors (caches, positions, pending logits) and on static buffers
(``steps``, ``done``, the traces), so the addresses never change: on a
CUDA device the K iterations are captured once into a CUDA graph and
replayed at every dispatch; on the CPU they run eagerly.  As in the
reference, whether any row draws is static: a lane holds the greedy
graph, captured with the macro step, and the sampled graph, captured at
the first dispatch with a live sampled row and replayed whenever one is
live; the second graph shares the first's memory pool (the two run on
one stream, never at once, and neither keeps a tensor of the pool alive
between replays).  Nothing inside the step copies from the host: the
weather, the budgets, the sampling key ids and greedy flags and the slot
ids are uploaded from pinned memory before the replay, and the decode
gets a view of each lane cache without its host mirror ``pos_host``,
which the lane rebuilds from the traces at collect.

A kernel wrapper counts a launch when its Python runs, which in a graph
is once, at capture: the counts made while capturing (``launches``,
and K2's ``ring_launches`` and ``window_launches``) are taken back and
added again at every replay, so they stay the number of kernels the
device ran.

A lane cache is a tree: the plain layout's {"k", "v"} pools, or the
grouped (gemma3) layout's {"inner", "tail", "global": {"k", "v"}} pools
with a "local" ring table beside "block"; on a dense lane the same
trees of stacked rows, with K2's identity tables.  The step decodes
through a shallow copy of the top level without "pos_host", so every
leaf and table it reads is the lane's own tensor, updated in place.
Rows parked for pages (or evicted) enter a dispatch done, so they keep
their pending logits and resume at a later boundary; the lane parks and
unparks them in place before ``load``, outside the graph.

``LaneGraph`` holds what the macro step and the speculative burst chain
(``serving/spec.py``) share: the static step inputs, and the greedy and
sampled graphs with their capture and replay-aware launch counts.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch import to_device
from repro_torch.data import tokenizer as TOK
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.kernels.logit_fusion.kernel import fuse_logits
from repro_torch.kernels.logit_fusion.sample import sample_fused
from repro_torch.kernels.moe_lora.kernel import (moe_lora_delta,
                                                 moe_lora_delta_slots)
from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
from repro_torch.models.attention import FREED_POS
from repro_torch.serving.latency import breaker_transition_device

# every (wrapper, counter) a macro step can advance, which replays add to
COUNTED = ((fuse_logits, "launches"), (paged_decode_attention, "launches"),
           (paged_decode_attention, "ring_launches"),
           (paged_decode_attention, "window_launches"),
           (moe_lora_delta, "launches"), (moe_lora_delta_slots, "launches"),
           (sample_fused, "launches"))


class LaneGraph:
    """The static inputs and graphs of one lane's K-step dispatch.

    ``iters`` bodies run per dispatch: ``body(t, sample)`` for t in
    range(iters), in place on the lane's tensors and on static buffers
    (each row's steps so far, budget, done flag, sampling key id and
    greedy flag, the breaker state on a faulted cloud lane, and the K4
    slot ids when the lane decodes through per-row slots).  On CUDA the
    greedy bodies are captured here, at construction, and the sampled
    ones by ``prepare`` at their first use, before ``load``: one body
    runs first on a side stream with every row parked (the warm-up that
    ``torch.cuda.graphs`` asks for, which changes no lane state: parked
    rows write to the sink page and keep their logits), then the bodies
    are captured."""

    def __init__(self, lane, iters: int, slot_ids: bool):
        dep = lane.eng.dep
        b, dev = lane.batch, dep.device
        self.lane, self.iters = lane, iters
        self.fault = dep.fault if lane.use_cloud else None
        self.steps = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.max_new = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.key_ids = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.greedy = torch.ones((b,), dtype=torch.bool, device=dev)
        if self.fault is not None:
            self.fails = torch.zeros((b,), dtype=torch.int32, device=dev)
            self.cooldown = torch.zeros((b,), dtype=torch.int32,
                                        device=dev)
        self.slot_ids = (torch.full((b,), -1, dtype=torch.int32, device=dev)
                         if slot_ids else None)
        self.gates = self.slot_ids if slot_ids else lane.gates
        self.caches = [{n: t for n, t in c.items() if n != "pos_host"}
                       for c in (lane.s_cache, lane.l_cache) if c is not None]
        # sample flag -> its graph, and (wrapper, counter) -> its advance
        # per replay of that graph
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.captured: Dict[bool, Dict] = {}
        self.replays = 0
        self.sample_replays = 0
        self.capture_s = 0.0
        self.sample_capture_s = 0.0
        self.on_cuda = dev.type == "cuda"

    @torch.inference_mode()
    def prepare(self, sample: bool) -> None:
        """Capture the ``sample`` graph on CUDA if the lane has none yet;
        capturing parks every row, so it precedes ``load``."""
        if self.on_cuda and sample not in self.graphs:
            self._capture(sample)

    def _upload(self, pairs) -> None:
        """Copy host arrays into static buffers without blocking the
        host (``to_device``): [(buffer, array)]."""
        for dst, a in pairs:
            dst.copy_(to_device(a, dst.device))

    def _load_rows(self, steps, max_new, done, slots, key_ids, greedy,
                   breaker=None) -> list:
        """The (buffer, array) pairs of the per-row inputs; ``breaker``
        is the (fails, cooldown) host mirrors of a faulted lane."""
        pairs = [(self.steps, steps), (self.max_new, max_new),
                 (self.done, done), (self.key_ids, key_ids),
                 (self.greedy, greedy)]
        if self.fault is not None:
            pairs += [(self.fails, breaker[0]), (self.cooldown, breaker[1])]
        if self.slot_ids is not None:
            pairs.append((self.slot_ids, slots))
        return pairs

    def breaker(self, active, lost, outage, ok):
        """One breaker transition of the rows ``active`` on their
        injected fault, in place on ``fails`` and ``cooldown``; returns
        the arrived mask with every fault term."""
        raw = lost | outage
        fails, cool, degraded, *_ = breaker_transition_device(
            self.fails, self.cooldown, active, raw, self.fault.breaker_n,
            self.fault.breaker_m)
        self.fails.copy_(fails)
        self.cooldown.copy_(cool)
        return OPS.cloud_arrival_mask(ok, active, lost, outage, degraded)

    def body(self, t: int, sample: bool) -> None:
        raise NotImplementedError

    def run(self, sample: bool = False) -> None:
        """Run the ``iters`` bodies: replay the ``sample`` graph on CUDA
        (after ``prepare``), the bodies eagerly on the CPU."""
        if not self.on_cuda:
            for t in range(self.iters):
                self.body(t, sample)
            return
        self.graphs[sample].replay()
        self.replays += 1
        self.sample_replays += sample
        for (fn, counter), n in self.captured[sample].items():
            setattr(fn, counter, getattr(fn, counter) + n)

    def per_replay(self, fn, counter: str = "launches",
                   sample: bool = False) -> int:
        """How far one replay of the ``sample`` graph advances ``fn``'s
        ``counter``."""
        return self.captured.get(sample, {}).get((fn, counter), 0)

    def _capture(self, sample: bool) -> None:
        t0 = time.perf_counter()
        saved = [c["pos"].clone() for c in self.caches]
        for c in self.caches:
            c["pos"].fill_(FREED_POS)
        self.done.fill_(True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(0, sample)
        torch.cuda.current_stream().wait_stream(side)
        before = {key: getattr(*key) for key in COUNTED}
        graph = torch.cuda.CUDAGraph()
        first = self.graphs.get(not sample)
        with torch.cuda.graph(graph, pool=None if first is None
                              else first.pool()):
            for t in range(self.iters):
                self.body(t, sample)
        self.captured[sample] = {key: getattr(*key) - n
                                 for key, n in before.items()
                                 if getattr(*key) != n}
        for (fn, counter), n in before.items():
            setattr(fn, counter, n)
        for c, pos in zip(self.caches, saved):
            c["pos"].copy_(pos)
        self.graphs[sample] = graph
        dt = time.perf_counter() - t0
        self.capture_s += dt
        if sample:
            self.sample_capture_s = dt


class LaneMacro(LaneGraph):
    """The K-step body of one lane and its static buffers.

    ``load`` fills the step's inputs (the (K, B) arrived-in-time weather,
    on a faulted cloud lane the (K, B) loss draws and outages and the
    breaker mirrors, and the per-row inputs of ``LaneGraph``);
    ``run(sample)`` decodes K tokens; ``traces`` then holds (3, K, B)
    float64 rows of the selected token, the fusion weight (cloud lane)
    and the active mask, and on a faulted lane two more: the arrived
    mask and the loss draw."""

    def __init__(self, lane, k: int, slot_ids: bool):
        super().__init__(lane, k, slot_ids)
        b, dev = lane.batch, lane.eng.dep.device
        self.k = k
        self.ok = torch.zeros((k, b), dtype=torch.bool, device=dev)
        if self.fault is not None:
            self.lost = torch.zeros((k, b), dtype=torch.bool, device=dev)
            self.outage = torch.zeros((k, b), dtype=torch.bool, device=dev)
        self.traces = torch.zeros((3 if self.fault is None else 5, k, b),
                                  dtype=torch.float64, device=dev)
        # parked (iteration, row) pairs and idle iterations, from traces
        self.parked_rows = 0
        self.idle_iters = 0
        self.prepare(False)

    def load(self, ok, steps, max_new, done, slots, key_ids, greedy,
             faults=None) -> None:
        """The step's inputs from host arrays; the edge lane (``ok``
        None) reads no weather, a lane without slot ids no ``slots``,
        and ``faults`` is a faulted lane's (lost, outage, fails,
        cooldown)."""
        pairs = self._load_rows(steps, max_new, done, slots, key_ids,
                                greedy, None if faults is None
                                else faults[2:])
        if ok is not None:
            pairs.append((self.ok, ok))
        if self.fault is not None:
            pairs += [(self.lost, faults[0]), (self.outage, faults[1])]
        self._upload(pairs)

    def body(self, t: int, sample: bool) -> None:
        """Iteration t: one token for every active row, in place; with
        ``sample`` the rows not flagged greedy draw theirs."""
        lane = self.lane
        eng, dep = lane.eng, lane.eng.dep
        active = ~self.done
        if lane.use_cloud:
            if self.fault is None:
                arrived = OPS.cloud_arrival_mask(self.ok[t], active)
            else:
                arrived = self.breaker(active, self.lost[t],
                                       self.outage[t], self.ok[t])
                self.traces[3, t] = arrived
                self.traces[4, t] = self.lost[t]
            probs, w = dep.fuse_mask(lane.sl, lane.ll, arrived)
            self.traces[1, t] = w
        else:
            probs = dep.softmax_batched(lane.sl)
        nxt = dep.select_sample(probs, self.greedy, self.key_ids,
                                self.steps, sample)
        done_now = active & ((nxt == TOK.EOS)
                             | (self.steps + 1 >= self.max_new))
        feed = torch.where(active & ~done_now, nxt, 0)[:, None]
        # rows that just finished are parked before this very decode
        for c in self.caches:
            c["pos"].masked_fill_(done_now, FREED_POS)
        # done and just-finished rows keep their pending logits
        keep = (self.done | done_now)[:, None]
        s_logits, _ = dep.slm_decode(eng.slm_params, self.caches[0], feed,
                                     eng.lora, self.gates)
        lane.sl.copy_(torch.where(keep, lane.sl, s_logits[:, 0]))
        if lane.use_cloud:
            l_logits, _ = dep.llm_decode(eng.llm_params, self.caches[1],
                                         feed)
            lane.ll.copy_(torch.where(keep, lane.ll, l_logits[:, 0]))
        self.traces[0, t] = nxt
        self.traces[2, t] = active
        self.steps += active
        self.done |= done_now
