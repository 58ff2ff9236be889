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

# every (wrapper, counter) a macro step can advance, which replays add to
COUNTED = ((fuse_logits, "launches"), (paged_decode_attention, "launches"),
           (paged_decode_attention, "ring_launches"),
           (paged_decode_attention, "window_launches"),
           (moe_lora_delta, "launches"), (moe_lora_delta_slots, "launches"),
           (sample_fused, "launches"))


class LaneMacro:
    """The K-step body of one lane and its static buffers.

    ``load`` fills the step's inputs (the (K, B) arrived-in-time weather,
    each row's steps so far, budget, done flag, sampling key id and
    greedy flag, and the K4 slot ids when the lane decodes through
    per-row slots); ``run(sample)`` decodes K tokens; ``traces`` then
    holds (3, K, B) float64 rows of the selected token, the fusion weight
    (cloud lane) and the active mask.  On CUDA the greedy body is
    captured here, at construction, and the sampled one by ``prepare``
    at its first use, before ``load``: one iteration runs first on a side
    stream with every row parked (the warm-up that ``torch.cuda.graphs``
    asks for, which changes no lane state: parked rows write to the sink
    page and keep their logits), then the K iterations are captured."""

    def __init__(self, lane, k: int, slot_ids: bool):
        dep = lane.eng.dep
        b, dev = lane.batch, dep.device
        self.lane, self.k = lane, k
        self.ok = torch.zeros((k, b), dtype=torch.bool, device=dev)
        self.steps = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.max_new = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.key_ids = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.greedy = torch.ones((b,), dtype=torch.bool, device=dev)
        self.traces = torch.zeros((3, k, b), dtype=torch.float64,
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
        # parked (iteration, row) pairs and idle iterations, from traces
        self.parked_rows = 0
        self.idle_iters = 0
        self.on_cuda = dev.type == "cuda"
        self.prepare(False)

    @torch.inference_mode()
    def prepare(self, sample: bool) -> None:
        """Capture the ``sample`` graph on CUDA if the lane has none yet;
        capturing parks every row, so it precedes ``load``."""
        if self.on_cuda and sample not in self.graphs:
            self._capture(sample)

    def load(self, ok, steps, max_new, done, slots, key_ids,
             greedy) -> None:
        """The step's inputs from host arrays, uploaded without blocking
        the host (``to_device``); the edge lane (``ok`` None) reads no
        weather and a lane without slot ids no ``slots``."""
        pairs = [(self.steps, steps), (self.max_new, max_new),
                 (self.done, done), (self.key_ids, key_ids),
                 (self.greedy, greedy)]
        if ok is not None:
            pairs.append((self.ok, ok))
        if self.slot_ids is not None:
            pairs.append((self.slot_ids, slots))
        for dst, a in pairs:
            dst.copy_(to_device(a, dst.device))

    def body(self, t: int, sample: bool) -> None:
        """Iteration t: one token for every active row, in place; with
        ``sample`` the rows not flagged greedy draw theirs."""
        lane = self.lane
        eng, dep = lane.eng, lane.eng.dep
        active = ~self.done
        if lane.use_cloud:
            arrived = OPS.cloud_arrival_mask(self.ok[t], active)
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

    def run(self, sample: bool = False) -> None:
        """Decode K tokens: replay the ``sample`` graph on CUDA (after
        ``prepare``), the body K times on the CPU."""
        if not self.on_cuda:
            for t in range(self.k):
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
            for t in range(self.k):
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
