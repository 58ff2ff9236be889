#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:
  1. device   the card's name and power limit;
  2. build    every CUDA kernel of the serving and training paths, from
              ``csrc/``, one ``nvcc`` per source, all started together;
  3. kernels  each kernel (K1 fusion, K2 paged decode attention, K3
              prefill flash attention, K4 slot-gather LoRA delta, K5
              gated multi-LoRA delta, K6 Mamba-1 selective scan) against
              its plain PyTorch version on the card at the main paths'
              shapes (K2's ring mode and K3's windowed mode also at the
              gemma3 SLM's H 4, KV 1: window 512 on (8, 32) ring-local
              tables, and (8, 4, 1552, 256) bursts windowed and
              causal; K2's full-length window mode, window 512 over (8,
              128) block tables, rows below, at and past the window and
              all past it), timed with CUDA events beside its bound and a
              library call where one exists (K1, K2, K6, and K4/K5 at
              T = 8, also replayed from a CUDA graph, without the host's
              dispatch; K6 also beside its exponentials' floor);
              K5 on one-hot gate rows must
              equal K4 bit for bit at T = 8; two calls of K1, K2, K4, K5
              and K6 on the same inputs must return the same bits; K3
              also on (B, H, S, D)
              views of (B, S, H, D) tensors, K5 also at the admission
              burst under one-hot gate rows; K4 and K5 at zamba2-7b's
              five LoRA shapes as its serving runs give them (T = 1 at
              decode, a demo prompt's S rows under one soft or one-hot
              gate row at prefill); K7 (keyed sampling, no
              Pallas original) at B = 1 and 8, V = 256,000, near-flat
              and peaked rows under a mixed greedy mask: ids and
              perturbed scores equal to its numpy plain version's bit
              for bit; K8 (attention backward) and K9 (LoRA-delta
              backward), no Pallas originals, against autograd of K3's
              and K5's plain versions: K8 at (4, 40), (8, 48) and (1,
              2048) of the 2b SLM's H 8 / KV 1 / head_dim 256 on the
              model's layout (K3's LSE output against the plain
              log-sum-exp, K3's output unchanged by it), K9 at T = 160
              on the six targets (E = 1), at mlp_in and mlp_out with
              E = 4 soft gates and on falcon-mamba's four targets (E =
              1, K5's forward beside it); K8's windowed mode at the gemma3 SLM's
              H 4 / KV 1, window 512, (1, 2048) and (8, 640), against
              autograd of K3's windowed plain version (library: SDPA's
              backward under the window's boolean mask; bound over the
              visible pairs); K10 (selective-scan backward, no Pallas
              original) at di 8,192, N 16, (B, S) = (4, 40), (2, 256),
              (1, 1536) against its plain backward per gradient (bound:
              bytes or its ex2 floor), K6 with its chunk-state output
              bit-equal to K6 without; two calls return the same bits;
              K11 (the SSD scan, no Pallas original) at zamba2-7b's 112
              heads of 64, N 64, S 1,536 and a demo prompt's, x, B and C
              strided slices of a conv-like output, against the
              reference's chunk loop (``ssd_scan_plain``), and K3 at
              head_dim 112 (H = KV = 32, window 4,096, equal to causal
              bit for bit) at the same S, both also replayed from a CUDA
              graph, two calls bit-equal; K9 at zamba2-7b's five LoRA
              shapes (T = 160, E = 1); K12 (the SSD scan's backward, no
              Pallas original) at zamba2-7b's width, (B, S) = (4, 40),
              (1, 512), (1, 1,536) and (2, 203), against autograd
              through the reference's chunk loop per gradient, from K11's
              chunk states (K11 with them bit-equal to K11 without, the
              states against their plain version); K8 at head_dim 112
              (H = KV = 32, windowed at 4,096 == causal bit for bit) at
              (4, 40) and (1, 1,536), K3's LSE there against the plain
              log-sum-exp; K4, K5 and K9 at granite-moe-3b-a800m's two
              LoRA shapes (q/o, k/v) as at zamba2's; K3 and K8 at
              head_dim 64 (granite's H 24 over KV 8, a GQA group of 3)
              at (1, 1,536), (4, 40) and a demo prompt's S against
              their plain versions (K3's LSE too), timed back to back,
              replayed from a CUDA graph, beside SDPA (autograd through
              it for K8), two calls bit-equal; the profile rows read
              from the profiler's raw records against key_averages' on a
              small window (``check_profile_readers``);
  4. check    the reduced 2b pair in bf16 on the card against the same
              parameters in f32 on the CPU (the port's plain path): the
              sequential prefill/decode and engine, paged decode of a
              ragged batch of three, the batched engine, and LoRA: SLM
              logits under adapter slots and router gates, the batched
              engine with mixed adapters (use_slot_kernel False and
              True) and a router-gated sequential request; the reduced
              gemma3 pair the same way at max_seq 96 with prompts past
              its window of 16 (SLM prefill and decode, the sequential
              engine, paged decode of a ragged batch, the batched engine
              at macro_k 0 and 8, SLM logits under adapter slots); then
              the reduced falcon-mamba the same way (prefill through K6,
              four decode steps), and its SLM logits under a 3-expert
              bank on ssm_in/x/dt/out with adapter-slot rows then slot
              ids (K5, K4) and with router gates (K5), against the same
              run in bf16 on the CPU (bf16 alone parts from f32 by more
              than LOGITS_TOL under the bank; printed);
  5. cli      ``python -m repro_torch.launch.serve --local`` as a user
              runs it on the card (the reduced pair, bf16), sequential,
              ``--batch 4 --macro-k 0``, ``--batch 4`` (the default
              macro step, K = 8) and with ``--adapters 3
              --adapter-slots 2``; then ``--pair gemma3``, sequential
              and ``--batch 4``; then ``--sample --sample-seed 3``,
              sequential and ``--batch 4`` at ``--macro-k`` 8 and 0
              (equal lines);
  5b. serve_ssm  the full-width falcon-mamba-7b (Mamba-1, 64 layers,
              bf16, random weights from a seed) through
              ServingDeployment and SoloEngine: the four demo prompts
              and a 1,536-token one, 16 greedy tokens each, every
              kernel's launch count read around the run (K6 = 64 per
              prefill, no other kernel); the full-width prefill (logits
              and every layer's scan state) through K6 against the plain
              scan; then a torch.profiler
              breakdown of the long request; then, on the same model:
              (a) a LoRA client step (B x S = 4 x 40, rank 16, the
              reference's threefry adapter) through K6/K10 and K5/K9
              against the same step with the plain versions on the
              card (loss and every leaf's gradient within
              FED_SSM_LOSS_RTOL / FED_SSM_GRAD_RTOL, ssm_dt's held to
              an f32 plain step; a step with only K5/K9 plain within
              FED_SSM_SCAN_RTOL of the plain one), step ms, busy share,
              peak memory, K6 and K10 64 and K5 and K9 256 launches),
              (b) a kernel-only step at 1 x 256 (two 128-token chunks),
              (c) SoloEngine with four users' adapters over 4 slots
              (K5 at prefill, K4 at decode) and with a router-gated
              4-expert bank, the demo prompts at SOLO_LORA_TOKENS, K4 /
              K5 at
              4 x 64 a decode / prefill layer pass, ids moved by the
              adapters; the model is freed before the next phase;
  5c. serve_zamba2  the full-width zamba2-7b (Mamba-2 backbone: 13
              groups of 5 Mamba-2 layers each under one shared attention
              block, then 3 Mamba-2 layers; ~16.2 B parameters, bf16,
              random weights from a seed) through SoloEngine: the four
              demo prompts and the 1,536-token one, 16 greedy tokens
              each, K11 = 68 and K3 = 13 launches a prefill and no other
              kernel; one prefill through K11 against the plain scan
              (logits and every layer's final SSD state); a
              teacher-forced decode step against a prefill one token
              longer (LOGITS_TOL, or FORCED_RATIO times the same
              comparison through the plain versions, which is itself
              held to FORCED_CEIL); a profile of the
              long request; serve_ssm (c)'s slots and router runs on
              it; then on the same model: (d) a LoRA client step (4 x
              40, rank 16, the reference's threefry adapter) through
              K11/K12, K3/K8 (windowed) and K5/K9 against the plain step
              on the card (the loss within FED_SSM_LOSS_RTOL; every
              leaf's gradient, which bf16 does not resolve to
              FED_SSM_GRAD_RTOL through 81 layers, held to a float32
              plain step: within FED_SSM_F32_RATIO times the bf16 plain
              step's distance from it, the share of K11/K12 alone
              within ZAMBA2_SCAN_F32_RATIO times that distance and the
              share of K3/K8 and K5/K9 within ZAMBA2_OTHER_F32_RATIO
              times it; K3 and K8 13, K11 and K12 68, K5 and K9 350
              launches), (e) a kernel-only step at 1 x 512 (two
              256-token chunks), (f) one packed prefill of the four
              demo prompts (K11 68, K3 13): every K11 and K3 call
              against its plain version on the same inputs (K11's y
              per (row, head) and state K11_H_RTOL, K3 per row
              K3_ROW_RTOL), each row's logits within
              LOGITS_TOL of its own prefill in float32, and in bf16
              through the kernels within FORCED_RATIO times the bf16
              prefill's distance from float32; the model is freed
              before the next phase;
  5d. serve_granite  the full-width granite-moe-3b-a800m (the MoE
              family: 32 layers, attention H 24 over KV 8 at head_dim
              64, a 40-expert top-8 FFN at capacity factor 1.25; ~3.3 B
              parameters, bf16, random weights from a seed): (a)
              SoloEngine serves the four demo prompts and the
              1,536-token one, 16 greedy tokens each (K3 = 32 a prefill,
              no other kernel; dropped assignments per prefill printed),
              every step replayed with K3 swapped for its plain version
              (logits within GRANITE_LOGITS_TOL, ids equal or a
              near-tie), the long prefill once more with each K3 call
              held on its own inputs and each layer's route flips
              against the plain run printed, a profile of the long
              request; (b) serve_ssm (c)'s slots and router runs
              (adapters at GRANITE_LORA_B_SCALE), replayed with K3, K4
              and K5 swapped, the first request again with every kernel
              call held on its own inputs; (c) a LoRA client step (4 x
              40, rank 16, the aux loss included) through K3/K8 (32)
              and K5/K9 (128): the loss and every leaf held to a float32
              step (FED_SSM_F32_RATIO times the bf16 plain step's
              distance); the model is freed before the pair's phases;
  6. serve    the full-width 2b pair (floe-slm-2b + floe-llm-7b, bf16,
              random weights from a seed) through ServingDeployment and
              Scheduler.from_deployment: the four demo prompts of the
              serving launcher plus a 1,542-token one, 16 greedy tokens
              each, with every kernel's launch count read around the run;
              then a torch.profiler breakdown of one more request;
  7. serve_batched  the same deployment through
              ContinuousBatchScheduler on paged lanes (8 rows, macro_k=0,
              lazy pages): 20 requests, 16 cloud-eligible (the long
              prompt twice) and 4 private, 16 greedy tokens each but 40
              for four cloud requests (one lazily reserved decode page
              covers 15 decode writes, so only longer budgets grow
              pages); every launch count read around the run, K2's held
              to the decode layer-steps; then a torch.profiler breakdown
              of one full boundary step and one tail step (a few short
              rows among parked ones);
  7b. serve_macro  the same 20 requests at macro_k 1 and 8 (the
              default), each engine run once untimed (it captures one
              CUDA graph per lane) and then timed: tokens/s, capture
              seconds, peak memory, replay-aware launch counts (K2 held
              to K x decode layers x replays per lane, K1 to K x cloud
              replays); K = 1 must equal the macro_k=0 run bit for bit
              (ids, cloud/fallback counts, latencies, fusion weights)
              and K = 8 on every request admitted in the same group (the
              groups are printed); then the two profiled boundaries of
              phase 7 on the K = 8 engine: one graph launch per busy
              lane, K2 at K x 46 (cloud) and K x 18 (edge) launches, the
              device's busy share of the untraced wall;
  7c. serve_sampled  the same 20 requests with the odd ones sampled
              (seed 2000 + i) at macro_k 0 and 8, each run once untimed
              first (both graphs of each lane captured there): tokens/s,
              the sampled graphs' capture seconds, peak memory, K7
              launches (K x sampled replays at K = 8), draws that left
              the argmax; K = 8 equal to K = 0 where the groups match;
              greedy paths are held to no K7 launch;
  7d. flat_keys  eight of them at 8 tokens with the fusion stubbed flat
              (a test double), through the sequential engine and the
              batched one at K = 0 and 8: every sampled cloud id must be
              the plain sampler's on the host for its (seed, key id,
              step); the same for four requests on the gemma3 pair at
              the end of phase 10;
  8. serve_adapters  the same traffic with six per-user adapters (random
              B, rank 16) and adapter-free rows mixed over a 4-slot bank
              (evictions, soft refusals), run with use_slot_kernel False
              and True: equal tokens, K4/K5 launches held to 6 x the SLM
              layer passes, adapter stats, tokens changed by adapters;
              then use_slot_kernel=True at macro_k=8 (K4 in the graphs):
              the same tokens as its per-token run;
  9. serve_router  the same traffic with a 4-expert bank gated by the
              Router (Eq. 8-11), then one request through
              HybridEngine.generate; K5 launches held to 6 x the SLM
              layer passes;
  10. serve_gemma3  the full-width gemma3 pair: floe-slm-gemma3 (26
              layers, 22 of them sliding-window rings of 512 slots, bf16,
              random weights from a seed) beside the 2b deployment's
              floe-llm-7b, shared, not copied: serve's traffic through
              the sequential engine (K3 once per prefill layer, windowed
              on the local layers); one full-width admission held
              against the plain path (last-token logits through K3 vs
              its plain version, every ring page against a plain
              gather); serve_batched's 20 requests at macro_k 0 and 8
              (K2 once per decode layer-step, in ring mode on the local
              layers; K = 8 equal to K = 0 where the admission groups
              match); one profiled K = 8 boundary; the 20 requests on
              dense lanes at K = 8, equal to the paged run bit for bit;
              then the SLM built without rings (full-length local leaves,
              K2's full-length window mode on them), eight requests at
              K = 8, token ids equal to the ring engine's;
  11. serve_dense  serve_batched's 20 requests on the 2b pair's dense
              lanes (paged=False: stacked rows, read by K2 in place as
              pages) at macro_k 0 and 8: every response equal to the
              paged run's at the same K bit for bit; tokens/s, peak
              memory, lane bytes;
  12. serve_pool_pressure  serve_batched's prompts at 40 tokens each,
              macro_k 8 and 0, on default pools and on 110-page pools a
              lane model (sized by a replay of the page traffic on the
              CPU):
              parks, evictions and no forced completion in the timed
              run; token ids equal to the default pools'; never-evicted
              requests bit-equal, evicted ones (re-prefilled) with their
              fusion weights within 1e-5;
              tokens/s against the default pools';
  13. serve_prefix  serve_batched's 20 requests behind PREAMBLE (1,001
              tokens) at macro_k 8 and 0: COW-shared (``prefix=``)
              against the preamble written into every prompt on paged
              lanes: ids, counts and latencies equal, fusion weights
              within PREFIX_W_TOL, ``build_prefix`` once per lane model,
              fewer peak live pages and resident KV bytes, the registry
              back at refcount 1, K3's offset mode once per layer of each
              suffix prefill; the same traffic on dense lanes at K 8 (ids
              equal to the unshared run); serve_gemma3_prefix and
              serve_gemma3_chunked (chunk width 512, ids equal to the
              default width) run at the end of phase 10;
  14. serve_long  LONG_REQUESTS (five of ~3,500 tokens) on max_seq 2048 /
              max_ctx 4096 at macro_k 8 and 0 and chunk widths 2,048 and
              512: ids equal, nothing truncated; truncated on max_ctx
              2048; a one-shot max_seq 4096 run gives the same ids;
  15. serve_faults  serve_batched's 20 requests on a lossy link
              (FAULT_WEATHER: loss, outages, circuit breaker) at
              macro_k 8, 1 and 0 (the breaker inside the graphs) and
              through the sequential engine: status, counts, latencies,
              degraded and lost tokens and clock equal request for
              request, ids where the admission groups match (all at
              K = 1), breaker trips, recoveries and degraded tokens
              seen; a deadline run (FAULT_DEADLINE_MS) cancels every row
              alike at K 8 and 0 and leaves no live page; tokens/s beside
              fault-free serve_batched's;
  16. serve_spec  the same requests at spec_k 4 (SLM drafts, one LLM
              verify a burst, rollback) with macro_k 8 and 0, the burst
              chain replayed from one CUDA graph per lane: ids equal to
              the spec_k = 0 runs where the admission groups match,
              cloud calls per token, acceptance, tokens/s, the graph's
              K2 at n_bursts x ((k + 1) x 18 + k x 28) and K1 at n_bursts
              x k; at K 8 on the faulted link (a breaker trip); one
              profiled dispatch; serve_gemma3_spec (spec_k 4, K 8, ring
              launches) at the end of phase 10;
  17. federate  federated fine-tuning of the full-width floe-slm-2b
              (the pair's SLM, bf16): (a) one client step (B x S = 4 x
              40, a rank-16 adapter drawn with the reference's threefry
              tree) through K3/K8 and K5/K9 against the same step with
              the plain versions on the card: loss and every LoRA leaf's
              gradient within FED_LOSS_RTOL / FED_GRAD_RTOL, step ms,
              peak memory, K3 and K8 once and K5 and K9 six times a
              layer; (b) run_simulation on FED_SIM (5 clients, one
              round; E(φ)'s projection drawn by a side process from the
              script's start, ``ProjectionDraw``): history, wall time,
              dropped clients, each training
              client's first-batch loss before and after its steps (it
              must fall); (c) one DP client round (clip 1.0, noise 0.5),
              timed with its host noise draw apart; (d) the published
              expert bank and router serving serve_batched's 20 requests
              through the batched engine at macro_k 8: every request
              served, tokens/s; (e) the full-width floe-slm-gemma3 beside
              the same LLM: client steps at 4 x 40 and 1 x 1,024 (past
              the window of 512) against the plain step on the card (K3
              and K8 once a layer, windowed on its 22 local layers),
              run_simulation on FED_SIM (all five clients train; losses
              fall), and the published bank served by the gemma3 pair's
              batched engine at macro_k 8 on eight requests.
The kernels phase also holds K3's history-offset mode (K3_OFFSET_SHAPES)
and K2 over (8, 256) block tables against their plain versions.
Then it prints the ``federate:`` summary, the ``{"kernels": [...]}``
line (K1-K12, K3's offset, head_dim 112 and head_dim 64 modes and K8's
windowed, head_dim 112 and head_dim 64 modes as entries of their own),
the nvidia-smi line and,
last, ``{"ok": true, "device": {...}}``.  Without a card it exits 2.
"""
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core peak
F32_FLOP_PER_S = 67e12           # outside the tensor cores
# K1: every f32 probability against its own |ref| (the softmax sums are
# reduced in another order).
K1_RTOL = 1e-5
# K3: per query row, max|out - ref| / max|ref|.  Two bf16 roundings of
# the output (one ulp is 2**-7 of a value) plus P rounded to bf16 before
# P V, where the plain version keeps f32.
K3_ROW_RTOL = 2 ** -6
# Reduced pair, bf16 on the card vs f32 on the CPU: logits relative to
# max|ref|, and the Eq. 14 fusion weights absolute.
LOGITS_TOL = 1e-2
FUSION_W_TOL = 1e-4
# K2: per (row, head), max|out - ref| / max|ref| over head_dim: one bf16
# rounding of the output plus f32 sums in another order.  Parked rows
# are excluded: their output is never read.
K2_ROW_RTOL = 2 ** -6
FREED_POS = 1 << 30
NO_PAGE = 1 << 20
K2_POSITIONS = [0, 15, 16, 700, 1541, 2047, FREED_POS, 1541]
# the gemma3 SLM's ring rows: ragged depths before and past its window
GEMMA3_RING_POSITIONS = [0, 100, 511, 512, 513, 1541, FREED_POS, 2047]
# the tail of a batched run: a few short live rows among parked ones
K2_TAIL_POSITIONS = [40, 47, 52, 63] + [FREED_POS] * 4
# the gemma3 SLM built without rings: K2's window over full-length block
# tables, every row past its window (the bound's case)
GEMMA3_PAST_POSITIONS = [600, 777, 1024, 1300, 1541, 1800, 2000, 2047]
# serve_pool_pressure: serve_batched's prompts, every budget at 40 (with
# serve_batched's budgets only four rows grow, so no lane can wedge and
# evict: the 98-page long prompt sets the pool's floor), over pools of
# POOL_PRESSURE_PAGES pages a lane model against the default 8 x 128.
# The size was chosen once by replaying this traffic's page bookkeeping
# on the CPU (the reduced pair at max_seq 2048, 16-slot pages, EOS off):
# at K 8 and K 0, 98 pages reject the long prompt (a demand of 99), 110
# park 8 times and evict rids 4 and 9 with no forced completion, 130
# park 7 times and evict none.  The run on the card asserts parks,
# evictions and no forced completion.
POOL_PRESSURE_BUDGET = 40
POOL_PRESSURE_PAGES = 110
# An evicted row's next token comes from a K3 prefill of prompt + tokens
# so far, where the roomy run decoded it through K2: two bf16 attention
# orders over the same values, card against card.  Each lies within the
# bf16-against-f32 gap of the f32 weights, which the reduced checks read
# at 1.3e-6 at most on the card (gemma3 engines; 6.0e-8 on the 2b pair),
# so the two differ by about twice that; the limit leaves a factor of
# four.  On evicted rows at full width the gap read 0 in every run.
EVICTED_W_TOL = 1e-5
# K4/K5: per row, max|out - ref| / max|ref|: f32 sums of up to 16,384
# products in another order (read 2.7e-6 at most on the card, at the
# admission shape with k 16,384; 8.7e-7 at T = 8); rows without an
# adapter must be exact zeros.
LORA_ROW_RTOL = 1e-5
LORA_E, LORA_R = 4, 16
# K8: per gradient (dq, dk, dv), max|out - ref| / max|ref| against
# autograd of K3's plain version: P and dS rounded to bf16 before the
# products that take them (the plain version keeps f32), plus the bf16
# rounding of each gradient; the LSE against the plain log-sum-exp in
# absolute terms (f32 sums in another order over |scores| of a few
# units).
K8_RTOL = 2 ** -6
K8_LSE_TOL = 1e-4
# K9: dA and dB, max|out - ref| / max|ref|: f32 sums of up to 32,768
# products in another order; dx also rounds to bf16 (one ulp is 2**-8 of
# a value).
K9_RTOL = 1e-5
K9_DX_RTOL = 2 ** -7
# K8's windowed mode at the gemma3 SLM's H 4 / KV 1 / head_dim 256 and
# window 512: one long row and a batch of client-step rows, past the
# window both; limits K8_RTOL and K8_LSE_TOL as in the causal mode
K8W_SHAPES = [(1, 2048), (8, 640)]
GEMMA3_WINDOW = 512
# K10: per gradient, max|out - ref| / max|ref| against its plain version:
# d(dt) and dA are f32 sums in another order (read 2.2e-7 and 1.7e-6 at
# most on an H100); dx, dB and dC round their f32 sums to bf16 once (one
# ulp is 2**-8 of a value; read 1.2e-3 at most)
K10_F32_RTOL = 1e-5
K10_BF16_RTOL = 2 ** -7
K10_SHAPES = [(4, 40), (2, 256), (1, 1536)]
# serve_ssm (a) and (b): client steps of falcon-mamba-7b, B x S, (a)
# against the plain step on the card, (b) two 128-token chunks
SSM_FED_STEP = (4, 40)
# federate (e): the gemma3 SLM's long client step, past its window of 512
FED_GEMMA3_LONG_STEP = (1, 1024)
SSM_FED_LONG_STEP = (1, 256)
# serve_ssm (a): the kernel step against the plain step, both bf16
# through 64 Mamba-1 layers: the loss relative, each LoRA leaf's gradient
# as max|diff| / max|ref|.  An H100 run read 2.6e-5 on the loss and
# 0.69–1.11% on ssm_in, ssm_x and ssm_out, so the limits are the 2b
# step's (over twice the larger).  ssm_dt's gradient is ~1e-6 of the
# others' (max 8.3e-12 and 3.3e-11 at random init) and lies 4.5% (A) and
# 19.6% (B) from the plain step's: bf16 activations an ulp apart, fed
# through 64 layers, are more than that gradient resolves.  The split,
# from a third step with only K5/K9 plain (K6/K10 kept): the LoRA
# kernels move it (the third step lies as far from the kernel step as
# the plain step does, on every leaf), the scan kernels hardly.  So the
# scan's share, that third step against the plain one, is held on
# every leaf to FED_SSM_SCAN_RTOL (read 2.9e-4 at most, on ssm_dt's B;
# ssm_in and ssm_out ~1e-7); the LoRA kernels' at ssm_dt's shapes per
# kernel (K5 and K9 at SSM_LORA_SHAPES, kernels phase); and
# ssm_dt's gradient, printed against the plain step, is held to an f32
# plain step: the kernel step's distance from it within
# FED_SSM_F32_RATIO times the bf16 plain step's (read 1.07 and 1.21:
# 4.0% against 3.7%, 20.0% against 16.6%)
FED_SSM_LOSS_RTOL = 1e-3
FED_SSM_GRAD_RTOL = 2.5e-2
FED_SSM_SCAN_RTOL = 1e-3
FED_SSM_F32_RATIO = 1.5
SSM_BF16_BOUND_LEAVES = ("ssm_dt.A", "ssm_dt.B")
# falcon-mamba-7b's LoRA targets (k, n): ssm_in, ssm_x, ssm_dt, ssm_out
SSM_LORA_SHAPES = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096)]
# federate: a client step's batch and length (B x S = 160 tokens), and
# the simulation: tests/test_federated.py's SimConfig at full width with
# five clients and seed 1, where (replayed on the host: Algorithm 1 on
# the full-width LUT, the fleet's loads, the batches) the two
# jetson-orin-nx clients train at rank 64 and one jetson-orin-nano at
# rank 16, the other orin-nano (load past 0.37) and the jetson-nano drop,
# and every training client's batches carry answer tokens (at seed 3
# client 3's carry none: its loss is 0 and cannot fall)
FED_BATCH, FED_SEQ = 4, 40
FED_SIM = dict(num_clients=5, examples_per_client=32, rounds=1,
               local_steps=5, seq_len=40, batch_size=4, alpha=0.05, seed=1)
# federate (a): the kernel step against the plain step on the card, both
# bf16 through 18 layers: the loss relative, each LoRA leaf's gradient
# as max|diff| / max|ref|.  K3/K8 round P and dS to bf16 where the
# plain attention keeps f32 (2**-8 of a value), and the difference
# travels through 18 bf16 layers of activations both ways: an H100 run
# read 0.40% (o's A) to 1.30% (mlp_in's B), and the limit sits at twice
# the larger.
FED_LOSS_RTOL = 1e-3
FED_GRAD_RTOL = 2.5e-2
# (k, n) of the SLM's LoRA targets: q and o, k and v, mlp_in, mlp_out
LORA_SHAPES = [(2048, 2048), (2048, 256), (2048, 32768), (16384, 2048)]
K4_SLOTS = [0, 1, 2, 3, -1, 0, 2, -1]
# zamba2-7b's LoRA targets (k, n): ssm_in (n = 2 d_inner + 2 N + 112
# heads = 16 x 911), ssm_out, mlp_in, mlp_out, and the shared block's q,
# k, v and o
ZAMBA2_LORA_SHAPES = [(3584, 14576), (7168, 3584), (3584, 28672),
                      (14336, 3584), (3584, 3584)]
# K6: y per (batch, position) row, max|out - ref| / max|ref| over d_inner:
# the kernel and the plain version round their f32 y to bf16 apart (one
# ulp, 2**-8 of a value and at most 2**-7 of a row's max); h_final
# against 1e-5 of its max (f32 recurrences, the plain update rounds once
# more per step).
K6_ROW_RTOL = 2 ** -7
K6_H_RTOL = 1e-5
# serve_ssm: falcon-mamba-7b's d_inner, state size and dt_rank
SSM_DI, SSM_N, SSM_DT_RANK = 8192, 16, 256
# K11 (the SSD scan, no Pallas original): y per (batch, position, head)
# row, max|out - ref| / max|ref| over P.  The kernel runs the f32
# recurrence step by step, the plain version the reference's chunk form
# (exponentials of cumulative log-decay differences over up to 256
# steps); a CPU model of the two in f32 parts by 1.4e-5 a row at S
# 1,536, and an H100 run read 3.8e-5.  h_final against 1e-5 of its max
# (read 2.6e-6)
K11_ROW_RTOL = 1e-4
K11_H_RTOL = 1e-5
# K12 (the SSD scan's backward, no Pallas original): per gradient,
# max|out - ref| / max|ref| against its plain version, autograd through
# the reference's chunk loop.  K12 runs the f32 recurrence step by step
# from K11's chunk states, the plain version the chunk form, as K11's y
# against its plain version (K11_ROW_RTOL): d(dt) and da in f32 at
# K12_F32_RTOL; dx, dB and dC round their f32 sums to bf16 once (one ulp
# is 2**-8 of a value) at K12_BF16_RTOL.  K11's chunk states against
# their plain version at K11_H_RTOL, as h_final.  Shapes: zamba2-7b's
# client step, a step of two reference chunks, the serving prefill's
# length, and a ragged S that is no multiple of 64
K12_F32_RTOL = 1e-4
K12_BF16_RTOL = 2 ** -7
K12_SHAPES = [(4, 40), (1, 512), (1, 1536), (2, 203)]
# K8 at zamba2's head_dim 112 (H = KV = 32, its window of 4,096, longer
# than S: equal to causal bit for bit) at the client step and the long
# prompt, limits K8_RTOL and K8_LSE_TOL
K8D_SHAPES = [(4, 40), (1, 1536)]
# serve_zamba2 (e): a kernel-only client step of two 256-token chunks
ZAMBA2_FED_LONG_STEP = (1, 512)
# serve_zamba2 (d): the client step runs 81 layers (13 shared-block
# passes among 68 Mamba-2 layers, each with an MLP) in bf16.  An H100 run
# read every LoRA leaf's gradient 2.4-6.4% from the bf16 plain step's,
# and the bf16 plain step itself 3.9-8.1% from a float32 plain step's
# (``float32_params``): bf16 does not resolve these gradients to
# FED_SSM_GRAD_RTOL, so every leaf takes the float32 route, the kernel
# step within FED_SSM_F32_RATIO times the bf16 plain step's distance
# from float32 (read 0.76-1.34).  The scan kernels' share (a third step
# with K5/K9 and K3/K8 plain, K11/K12 kept) read 0.7-2.0% against
# FED_SSM_SCAN_RTOL's 1e-3: K11's f32 y and K12's f32 dx, ~1e-6 off the
# chunk form's, round to bf16 apart now and then, and 81 layers amplify
# that as they amplify any bf16 rounding; so the share is held to
# ZAMBA2_SCAN_F32_RATIO times the same distance from float32 (read 0.35
# at most): swapping the scan kernels moves a gradient by well under
# what bf16 arithmetic itself does.
ZAMBA2_SCAN_F32_RATIO = 0.5
# serve_zamba2 (d): the other kernels' share (K3/K8 and K5/K9: the kernel
# step against the third, scan-kernels-only step) on every leaf within
# ZAMBA2_OTHER_F32_RATIO times the same distance from float32.  An H100
# run read 0.41-0.95 (the shared block's leaves, whose gradients pass
# through K3/K8, highest), bit for bit the same in a second run; K5 and
# K9 themselves are held per row at zamba2's shapes in the kernels phase
ZAMBA2_OTHER_F32_RATIO = 1.25
# serve_zamba2 (f): a packed row against its own B = 1 prefill.  In bf16
# the two run their GEMMs over other row counts (4 x 49 against 27-49),
# which round apart in the last place, and 81 layers amplify it (an H100
# run read 2.3-3.0e-2 through the kernels, past LOGITS_TOL); so the rows
# are held to LOGITS_TOL in float32 (the plain versions,
# ``float32_params``), where the comparison resolves, and the bf16 run's
# gap to FORCED_RATIO times its own B = 1 prefill's distance from the
# float32 one.  K11 and K3 at B = 4 on ragged rows are held tightly call
# by call, each against its plain version on the inputs the packed
# prefill gave it.  (The whole packed prefill through the plain versions
# in bf16, the same row counts, read 1.1-1.4e-2 from the kernels' in an
# H100 run: K3 rounds P to bf16 where its plain version keeps f32, and
# 81 layers amplify that past LOGITS_TOL, as they do a row count.)  K11's
# y is held per (row, head), as a share of the head's max over its steps
# and channels, within K11_H_RTOL: per (row, step, head) row, as the
# kernels phase holds it on random inputs, a real activation's row can
# be ~1e-3 of its head's median (an H100 run: 5e-9 against 4.5e-6), and
# there both f32 forms part from a float64 recurrence by up to 3.5e-4
# of the row (K11) and 1.3e-4 (the chunk form), the same at B = 1; per
# head K11 lay 5.4e-7 from float64, the chunk form 1.8e-6
# serve_zamba2: the seed of its random weights.  Its teacher-forced
# decode step (n - 1 tokens prefilled, then one decode step, against a
# prefill of n) is held to LOGITS_TOL, or, past it, to FORCED_RATIO times
# the same comparison made with K11 and K3 swapped for their plain
# versions: decode multiplies a single row through cuBLAS's GEMV kernels
# where prefill runs GEMMs over the prompt, so bf16 outputs round apart
# by an ulp here and there and travel through 81 layers.  An H100 run
# read 1.19e-2 through the kernels; on the CPU, where GEMM and GEMV round
# alike, the reduced zamba2 in bf16 reads 0 for the same comparison and
# parts from f32 by 3.0e-2 (81 layers) in both.  The plain versions'
# comparison (read 1.14e-2) is itself held to FORCED_CEIL, so that a
# fault in the decode path, which both comparisons share, fails
FORCED_RATIO = 1.5
FORCED_CEIL = 2 * LOGITS_TOL
ZAMBA2_SEED = 27
# serve_granite: granite-moe-3b-a800m's attention (H 24 over KV 8 at
# head_dim 64, a GQA group of 3), its LoRA targets (k, n) (q and o, k and
# v) and the seed of its random weights.  K3 and K8 at head_dim 64 run
# in the kernels phase at its long prompt, its client step and a demo
# prompt's S, limits K3_ROW_RTOL, K8_RTOL and K8_LSE_TOL
GRANITE_HEADS, GRANITE_KV, GRANITE_HD = 24, 8, 64
GRANITE_ATTN_SHAPES = [(1, 1536), (4, 40)]
GRANITE_LORA_SHAPES = [(1536, 1536), (1536, 512)]
GRANITE_SEED = 29
# serve_granite (a), (b): every prefill and decode step replayed with the
# kernels (K3; K4 and K5 under adapters) swapped for their plain
# versions on the same bf16 parameters, the same tokens and gates (a
# replay with nothing swapped gives the same bits).  The MoE's top-8
# routing is discontinuous: where two experts' gate values lie within
# bf16's rounding of each other, K3's P rounded to bf16 (its plain
# version keeps f32) can flip a token's route, and a flipped route moves
# that token's output by O(1) of its MoE share (an H100 run: 8-149 of
# the long prompt's 1,536 tokens a layer).  So logits are held per step
# to GRANITE_LOGITS_TOL (max|diff| / max|ref|; an H100 run read 7.3e-3
# plain and 1.0-1.1e-2 under adapters, the limit over twice that), and
# ids are equal, or where they part the plain run's own margin between
# its pick and the kernel run's lies within the two runs' distance at
# that step (a near-tie, not a fault); each kernel call is held on its
# own inputs to its limit (K3_ROW_RTOL, LORA_ROW_RTOL).  The adapters'
# B is drawn at GRANITE_LORA_B_SCALE, not LORA_B_SCALE: at 0.5 (a delta
# ~2.8x its projection's output) the adapted model amplifies any swap,
# K3's alone or K4/K5's alone, to 20-65% of the logits through 32 layers
# of routing, while at 0.05-0.2 the same replay read 1.0-1.1e-2 and
# every request still moved off the adapter-free ids
GRANITE_LOGITS_TOL = 2.5e-2
GRANITE_LORA_B_SCALE = 0.1
# the router's four domains, each a few public samples (Eq. 9)
# serve_adapters: six users and adapter-free rows over the 20 requests
ADAPTER_OF = [None if i % 4 == 3 else f"user{i % 6}" for i in range(20)]
# B ~ N(0, 0.5^2) at rank 16: a projection's delta is ~2.8x its output
# (rms), enough to move a random-weight model off its own greedy tokens
LORA_B_SCALE = 0.5
# serve_ssm (c), serve_zamba2 and serve_granite (b): tokens a request of
# the SLM-only adapter and router runs (16 before the granite phase, cut
# to pay for it), and of serve_granite (b)'s request served again with
# every kernel call held on its own inputs
SOLO_LORA_TOKENS = 8
SOLO_HELD_TOKENS = 4
ROUTER_DOMAINS = [
    ("math", ["compute 2 plus 2", "what is 3 times 9", "sort ascending: 3 1"]),
    ("language", ["translate water to french", "give two synonyms for big",
                  "translate to german: cat"]),
    ("science", ["explain how rain forms", "describe photosynthesis",
                 "why is the sky blue"]),
    ("general", ["what is the capital of spain", "write a short poem",
                 "name a large animal"]),
]
# check_gemma3's batched traffic: two private prompts, the others past
# the reduced window of 16 tokens
DEMO_PROMPTS_GEMMA3 = [
    "math: compute 12 plus 7 = and then 30 minus 4 =",
    "my ssn is 123-45-6789, fill the benefits form",
    "translate to french: the water is cold ->",
    "my doctor said my blood pressure is 140 over 90",
    "explain how rainbows form when sunlight passes through rain",
]
LONG_PROMPT = ("explain how rainbows form when sunlight passes through "
               "falling raindrops and why the colors always appear in the "
               "same order across the sky. ") * 11
# serve_ssm's long prompt: exactly 1,536 tokens (12 x 128, a length the
# reference's chunked Mamba-1 scan serves too)
SSM_LONG_PROMPT = LONG_PROMPT[:1534]
SSM_LONG_TOKENS = 1536
# max_seq of serve_ssm: page-aligned, with room for the long prompt and
# 16 new tokens (cap = max_seq - 16 - 1)
SSM_MAX_SEQ = 1568
# quiet time before and after a profiled block; a side is widened x4
# for the rest of the run each time a window loses its edge there;
# windows taken per block at most (see ``profiled`` and ``retaken``)
PROFILE_MARGINS_S = {"leading": 0.1, "trailing": 0.1}
PROFILE_MARGIN_MAX_S = 6.4
PROFILE_TRIES = 4
# padding before a window's leading marker: spin kernels of ~0.25 ms
# each (50 ms and 200 device records in all) that the window may lose
# in its stead; a spin record shorter than PROFILE_MARKER_MAX_US is a
# marker
PROFILE_PAD = (200, 500_000)
PROFILE_MARKER_MAX_US = 50.0
# serve_sampled: odd requests of serve_batched's traffic draw with seed
# SAMPLED_SEED + i
SAMPLED_SEED = 2000
# serve_batched traffic: (prompt, max_new_tokens); 16 cloud-eligible, the
# long prompt twice, and 4 private (rids 2, 7, 12, 17)
BATCHED_REQUESTS = [
    (LONG_PROMPT, 16), ("what is the capital of france", 16),
    ("my ssn is 123-45-6789, fill the benefits form", 16),
    ("summarize the plot of hamlet in one line", 40),
    ("math: compute 12 plus 7 =", 16), ("translate to french: water ->", 16),
    ("list three colors that mix into brown", 16),
    ("my doctor said my blood pressure is 140 over 90", 16),
    ("write a haiku about the sea at night", 40),
    (LONG_PROMPT, 16), ("sort ascending: 40 12 77 31 ->", 16),
    ("name the largest planet in the solar system", 16),
    ("my credit card number is 4111 1111 1111 1111", 16),
    ("explain photosynthesis to a ten year old", 40),
    ("give two synonyms for quick", 16),
    ("what does a compiler do, in one sentence", 16),
    ("how many legs does a spider have", 16),
    ("call me at 555-123-4567 about my diagnosis", 16),
    ("describe the water cycle step by step", 40),
    ("translate to german: good morning ->", 16),
]
# serve_prefix: one shared system instruction of 1,000 bytes (1,001
# tokens with BOS: 62 shared pages of 16 and a 9-token tail) that the
# privacy detector does not flag
PREAMBLE = ("You are a careful and friendly assistant. Answer each question "
            "in plain words, briefly and politely, and stay on the topic "
            "that was asked. " * 10)[:1000]
# serve_prefix: the COW run against the unshared one, fusion weights,
# card against card in bf16 (as EVICTED_W_TOL).  The shared preamble's
# K/V come from a B=1 prefill, the unshared rows' from a B=8 packed one:
# bf16 GEMMs at another M may round a value in its last place, and the
# suffix attention runs K3's offset mode where the unshared run runs its
# plain mode (other tile sums).  Each such gap lies within the bf16-vs-
# f32 fusion-weight gap the reduced checks read on the card (1.3e-6 at
# most), and the COW rows' gap read 0 in both full runs on the H100.
PREFIX_W_TOL = 1e-5
# serve_long: five prompts of about 3,500 tokens (four cloud-eligible,
# one private) and four short ones of serve_batched, 16 tokens each, on
# max_seq 2048 / max_ctx 4096
LONG_REQUESTS = [((LONG_PROMPT * 3)[:3490 + 7 * i], 16) for i in range(4)] \
    + [("my ssn is 123-45-6789, " + (LONG_PROMPT * 3)[:3470], 16)] \
    + [BATCHED_REQUESTS[i][:1] + (16,) for i in (1, 2, 4, 5)]
# serve_faults: the reference tests' CHAOS weather — a quarter of the
# cloud replies lost (keyed by (rid, step)), the link down 3 steps of
# every 10, a breaker that trips after 2 failures in a row and holds a
# row SLM-only for 3 steps.  On serve_batched's traffic the per-token
# paths see 38 trips and 105 degraded tokens (a host replay of the
# weather, which depends on (rid, step) alone)
FAULT_WEATHER = dict(loss_rate=0.25, outage_period=10, outage_len=3, seed=3,
                     breaker_n=2, breaker_m=3)
# under the 65 ms edge floor a row needs more than 400 simulated ms for
# its 7th token, so every row cancels mid-request
FAULT_DEADLINE_MS = 400.0
# serve_spec: drafted tokens a cloud round-trip
SPEC_K = 4
# tokens/s of each timed batched run, by its tag (``print_batched``)
RATES = {}
# K2 over 256-page block tables (max_ctx 4096): rows deep in the long
# prompts, short ones, a parked one and one at the last slot
K2_LONG_POSITIONS = [3507, 3514, 3521, 3499, 40, 700, FREED_POS, 4095]
# K3's history-offset mode at the shapes of its paths: (label, B, H, KV,
# P, S, window).  COW suffixes behind the 1,001-token preamble (the
# group holding the long prompt pads its suffixes to 1,040, a group of
# short ones to 48) of the LLM (H = KV = 16), the 2b SLM (H = 8, KV = 1)
# and the gemma3 SLM's local (window 512) and global layers (H = 4,
# KV = 1); the final chunk (1,456 at width 2,048) and a middle one (512
# at width 512) of the LLM's and the 2b SLM's chunked prefill; the
# gemma3 SLM's middle chunks at width 512, local and global, and a
# local chunk far past the window.
K3_OFFSET_SHAPES = [
    ("cow_llm", 8, 16, 16, 1001, 1040, 0),
    ("cow_llm_short", 8, 16, 16, 1001, 48, 0),
    ("cow_slm", 8, 8, 1, 1001, 1040, 0),
    ("cow_slm_short", 8, 8, 1, 1001, 48, 0),
    ("chunk_final_llm", 1, 16, 16, 2048, 1456, 0),
    ("chunk_middle_llm", 1, 16, 16, 1536, 512, 0),
    ("chunk_final_slm", 1, 8, 1, 2048, 1456, 0),
    ("chunk_middle_slm", 1, 8, 1, 1536, 512, 0),
    ("cow_gemma3_local", 8, 4, 1, 1001, 1040, 512),
    ("cow_gemma3_local_short", 8, 4, 1, 1001, 48, 512),
    ("cow_gemma3_global", 8, 4, 1, 1001, 1040, 0),
    ("chunk_middle_gemma3_local", 1, 4, 1, 1024, 512, 512),
    ("chunk_middle_gemma3_global", 1, 4, 1, 1024, 512, 0),
    ("chunk_gemma3_local", 1, 4, 1, 3072, 512, 512),
]


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """ms per call of fn replayed from a CUDA graph of ``calls`` calls:
    the kernels' device time and the gaps between their launches,
    without the host's per-call dispatch, which back-to-back calls of a
    microsecond-scale kernel measure instead (``time_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def rel_err(out, ref) -> float:
    """max over elements of |out - ref| / |ref|."""
    return ((out.float() - ref.float()).abs() / ref.float().abs()).max().item()


def row_rel_err(out, ref) -> float:
    """max over rows (the last axis) of max|out - ref| / max|ref|."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


def head_rel_err(out, ref) -> float:
    """max over (batch, head) of max|out - ref| / max|ref| over the
    head's (step, channel) values of a (B, S, H, P) scan output."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().amax((1, 3))
            / ref.abs().amax((1, 3))).max().item()


def share_of_max(out, ref) -> float:
    """max|out - ref| / max|ref|, or max|out - ref| where ref is all
    zeros (a scan's only chunk state is h_0 = 0)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err / scale if scale else err


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_case(torch, g, h, kvh, window, positions, n_pool=1024, hd=256,
               ring=True, ctx=2048):
    """Random bf16 pages and block tables as the allocator builds them: a
    live plain row (or, without ``ring``, a window row) maps the pages
    its position needs (NO_PAGE past that) of a ``ctx``-slot table, a
    ring row a full ring of window / 16 pages, a parked row nothing."""
    dev, ps, b = torch.device("cuda"), 16, len(positions)
    ring = bool(window) and ring
    nb = window // ps if ring else ctx // ps
    q = torch.randn(b, h, hd, device=dev, generator=g).bfloat16()
    pk = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    pv = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    free = torch.randperm(n_pool, device=dev, generator=g).tolist()
    table = torch.full((b, nb), NO_PAGE, dtype=torch.int32)
    for i, p in enumerate(positions):
        if p < FREED_POS:
            n = window // ps if ring else p // ps + 1
            table[i, :n] = torch.tensor([free.pop() for _ in range(n)])
    pos = torch.tensor(positions, dtype=torch.int32)
    return q, pk, pv, table.to(dev), pos.to(dev)


def k2_pages_read(positions, window, ring):
    """(pages, slots) K2 reads for these rows: the live pages of each
    row (a ring's first min(pos + 1, window) slots; a full-length
    window's pages from that of pos - window + 1 to that of pos) and
    the live slots among them."""
    pages = slots = 0
    for p in positions:
        if p >= FREED_POS:
            continue
        if window and ring:
            n = min(p + 1, window)
            pages += -(-n // 16)
        elif window:
            n = min(p + 1, window)
            pages += p // 16 - max(0, p - window + 1) // 16 + 1
        else:
            n = p + 1
            pages += -(-n // 16)
        slots += n
    return pages, slots


def phase_k2(torch):
    """K2 at both full-width geometries of the 2b pair (B=8, hd 256,
    16-slot pages, nb 128, a 1,024-page pool): rows at K2_POSITIONS (one
    parked), plain and window=512 on a ring-local table, then the batched
    run's tail (K2_TAIL_POSITIONS, half the rows parked), plain; then the
    gemma3 SLM's ring mode (H 4, KV 1, window 512 on (8, 32) ring-local
    tables, GEMMA3_RING_POSITIONS); then its full-length window mode,
    the gemma3 SLM built without rings (window 512 over (8, 128) block
    tables: GEMMA3_RING_POSITIONS, rows below, at and past the window
    and one parked, then GEMMA3_PAST_POSITIONS, every row past it)."""
    from repro_torch.kernels.paged_attention import kernel as K2

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    runs = [(m, h, kvh, w, True, K2_POSITIONS)
            for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))
            for w in (0, 512)]
    runs += [(m, h, kvh, 0, True, K2_TAIL_POSITIONS)
             for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))]
    # the gemma3 SLM's local layers: H 4, KV 1, (8, 32) ring-local tables
    runs += [("slm_gemma3", 4, 1, 512, True, GEMMA3_RING_POSITIONS)]
    # ... and without rings: (8, 128) block tables, the window masked
    runs += [("slm_gemma3_full", 4, 1, 512, False, pos)
             for pos in (GEMMA3_RING_POSITIONS, GEMMA3_PAST_POSITIONS)]
    # serve_long's LLM lane: (8, 256) block tables over a 2,048-page pool
    runs += [("llm_ctx4096", 16, 16, 0, True, K2_LONG_POSITIONS)]
    for model, h, kvh, window, ring, positions in runs:
        ctx = 4096 if model == "llm_ctx4096" else 2048
        n_pool = 2048 if ctx == 4096 else 1024
        args = paged_case(torch, g, h, kvh, window, positions, ring=ring,
                          ctx=ctx, n_pool=n_pool)
        kw = dict(window=window, ring=ring)
        before = K2.paged_decode_attention.window_launches
        out = K2.paged_decode_attention(*args, **kw)
        again = K2.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise SystemExit("K2: two calls on the same inputs differ")
        if K2.paged_decode_attention.window_launches - before \
                != 2 * (bool(window) and not ring):
            raise SystemExit("K2: the window-mode count is wrong")
        ref = K2.paged_decode_attention_plain(*args, **kw)
        live = [i for i, p in enumerate(positions) if p < FREED_POS]
        parked = [i for i, p in enumerate(positions) if p >= FREED_POS]
        if out[parked].any():
            raise SystemExit("K2 wrote a non-zero parked row")
        # bytes: the live slots of each row, K and V once, q and the
        # output; ops: 2 * 2 * H * hd per live slot (QK and PV).  The
        # whole pages the kernel reads give ``page_bound_ms`` beside it
        pages, slots = k2_pages_read(positions, window, ring)
        qo = 2 * 8 * h * 256 * 2
        ops = 4 * h * 256 * slots
        bms, by = bound(slots * kvh * 256 * 2 * 2 + qo, ops,
                        BF16_FLOP_PER_S)
        page_bms, _ = bound(pages * 16 * kvh * 256 * 2 * 2 + qo, ops,
                            BF16_FLOP_PER_S)
        cases.append(dict(
            shape=dict(model=model, B=8, H=h, KV=kvh, hd=256, ps=16,
                       nb=args[3].shape[1], pool=n_pool, window=window,
                       ring=ring, pos=positions),
            dtype="bfloat16",
            max_abs_err=(out[live].float() - ref[live].float()
                         ).abs().max().item(),
            max_rel_err=row_rel_err(out[live], ref[live]),
            ms=time_ms(torch, lambda: K2.paged_decode_attention(
                *args, **kw), 100),
            graph_ms=graph_ms(torch, lambda: K2.paged_decode_attention(
                *args, **kw)),
            plain_ms=time_ms(torch, lambda: K2.paged_decode_attention_plain(
                *args, **kw), 10),
            library_ms=None, bound_ms=bms, bound_by=by,
            live_slots=slots, live_pages=pages, page_bound_ms=page_bms))
        print(f"K2 paged_decode_attention: {cases[-1]}")
        del args, out, ref
    bad = [c for c in cases if not c["max_rel_err"] <= K2_ROW_RTOL]
    if bad:
        raise SystemExit(f"K2 disagrees with its plain version: {bad}")
    return cases


def phase_kernels(torch, long_len: int):
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.kernels.time_kernels import k1_inputs
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    k1_cases = []
    for b in (1, 4, 8):
        sl, ll, w, arrived = k1_inputs(torch, g, b)
        out = K1.fuse_logits(sl, ll, w, arrived)
        again = K1.fuse_logits(sl, ll, w, arrived)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise SystemExit("K1: two calls on the same inputs differ")
        ref = K1.fuse_logits_plain(sl, ll, w, arrived)
        nbytes = 3 * b * 256_000 * 4 + b * 8
        bms, by = bound(nbytes, 12 * b * 256_000, F32_FLOP_PER_S)
        k1_cases.append(dict(
            shape=[b, 256_000], dtype="float32",
            max_abs_err=(out - ref).abs().max().item(),
            max_rel_err=rel_err(out, ref),
            ms=time_ms(torch, lambda: K1.fuse_logits(sl, ll, w, arrived), 50),
            graph_ms=graph_ms(torch, lambda: K1.fuse_logits(
                sl, ll, w, arrived)),
            plain_ms=time_ms(torch, lambda: K1.fuse_logits_plain(
                sl, ll, w, arrived), 20),
            library_ms=None, bound_ms=bms, bound_by=by))
        print(f"K1 fuse_logits B={b}: {k1_cases[-1]}")

    k3_cases = []
    # the last case reads (B, H, S, D) views of (B, S, H, D) tensors, as
    # the model's prefill hands them over
    shapes = [(1, 8, 1, s, 0, False) for s in (31, long_len, 2048)] + \
             [(1, 16, 16, s, 0, False) for s in (31, long_len, 2048)] + \
             [(1, 16, 16, 2048, 512, False), (8, 8, 1, 1552, 0, False),
              (8, 16, 16, 1552, 0, False), (8, 16, 16, 1552, 0, True)] + \
             [(8, 4, 1, 1552, w, True) for w in (512, 0)]        # gemma3
    for bsz, h, kvh, s, window, strided in shapes:
        d = 256
        if strided:
            q, k, v = (torch.randn(bsz, s, n, d, device=dev, generator=g)
                       .bfloat16().transpose(1, 2) for n in (h, kvh, kvh))
        else:
            q, k, v = (torch.randn(bsz, n, s, d, device=dev, generator=g)
                       .bfloat16() for n in (h, kvh, kvh))
        out = K3.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        ref = K3.flash_attention_plain(q, k, v, window=window)
        if window:
            mask = K3.attention_mask(s, True, window, dev)

            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=kvh != h)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=kvh != h)
        visible = bsz * sum(min(i + 1, window or s) for i in range(s))
        nbytes = 2 * bsz * (2 * h * s * d + 2 * kvh * s * d)
        bms, by = bound(nbytes, 4 * d * h * visible, BF16_FLOP_PER_S)
        iters = 20 if s > 512 else 200
        k3_cases.append(dict(
            shape=dict(B=bsz, H=h, KVH=kvh, S=s, D=d, window=window,
                       layout="(B, S, H, D) views" if strided
                       else "contiguous"),
            dtype="bfloat16",
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            max_rel_err=row_rel_err(out, ref),
            ms=time_ms(torch, lambda: K3.flash_attention(
                q, k, v, window=window), iters),
            plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                q, k, v, window=window), max(5, iters // 10)),
            library_ms=time_ms(torch, lib, iters),
            library_max_rel_err=row_rel_err(lib(), ref),
            bound_ms=bms, bound_by=by))
        print(f"K3 flash_attention: {k3_cases[-1]}")
        del q, k, v, out, ref
    bad = [c for c in k1_cases if not c["max_rel_err"] <= K1_RTOL] + \
          [c for c in k3_cases if not c["max_rel_err"] <= K3_ROW_RTOL]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return k1_cases, k3_cases


def phase_k3_offset(torch):
    """K3's history-offset mode at K3_OFFSET_SHAPES, bf16, D = 256, on
    (B, H, S, D) views of (B, S, H, D) projections behind a B = 1
    history read in place: per query row against its plain version
    (K3_ROW_RTOL), timed beside the plain version, SDPA with the
    explicit boolean mask over the expanded [history; fresh] (the
    library call, its operands expanded outside the timed call) and the
    bound: bytes (q, the output, the fresh K/V and the history positions
    some query sees — with a window only the last window - 1 — each
    once) over 3.35 TB/s against 4 H D per visible (query, key) pair
    over 989 TFLOP/s."""
    from repro_torch.kernels.flash_attention import kernel as K3
    import torch.nn.functional as F

    dev, d = torch.device("cuda"), 256
    g = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for label, b, h, kvh, p, s, window in K3_OFFSET_SHAPES:
        q, k, v = (torch.randn(b, s, n, d, device=dev, generator=g)
                   .bfloat16().transpose(1, 2) for n in (h, kvh, kvh))
        hk, hv = (torch.randn(1, p, kvh, d, device=dev, generator=g)
                  .bfloat16().transpose(1, 2) for _ in range(2))
        kw = dict(window=window, hist_k=hk, hist_v=hv)
        before = K3.flash_attention.offset_launches
        out = K3.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if K3.flash_attention.offset_launches != before + 1:
            raise SystemExit("K3: the offset-mode count is wrong")
        ref = K3.flash_attention_plain(q, k, v, **kw)
        kk = torch.cat([hk.expand(b, -1, -1, -1), k], dim=2)
        vv = torch.cat([hv.expand(b, -1, -1, -1), v], dim=2)
        mask = K3.attention_mask(s, True, window, dev, hist=p)

        def lib():
            return F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, enable_gqa=kvh != h)
        visible = b * sum(min(p + i + 1, window or p + s)
                          for i in range(s))
        seen = min(p, window - 1) if window else p
        nbytes = 2 * (2 * b * h * s * d + 2 * b * kvh * s * d
                      + 2 * kvh * seen * d)
        bms, by = bound(nbytes, 4 * d * h * visible, BF16_FLOP_PER_S)
        iters = 20 if b * s > 2048 else 100
        cases.append(dict(
            shape=dict(path=label, B=b, H=h, KVH=kvh, P=p, S=s, D=d,
                       window=window, history_batch=1,
                       layout="(B, S, H, D) views"),
            dtype="bfloat16",
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            max_rel_err=row_rel_err(out, ref),
            ms=time_ms(torch, lambda: K3.flash_attention(q, k, v, **kw),
                       iters),
            plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                q, k, v, **kw), max(5, iters // 10)),
            library_ms=time_ms(torch, lib, iters),
            library_max_rel_err=row_rel_err(lib(), ref),
            bound_ms=bms, bound_by=by, visible_pairs=visible,
            history_read=seen))
        print(f"K3 flash_attention (history offset): {cases[-1]}")
        del q, k, v, hk, hv, kk, vv, out, ref
    bad = [c for c in cases if not c["max_rel_err"] <= K3_ROW_RTOL]
    if bad:
        raise SystemExit(f"K3's offset mode disagrees with its plain "
                         f"version: {bad}")
    return cases


def lora_inputs(torch, g, t, k, n):
    """bf16 activations and an f32 bank of E = 4 experts at rank 16, the
    full-width serving shapes."""
    dev = torch.device("cuda")
    x = torch.randn(t, k, device=dev, generator=g).bfloat16()
    a = torch.randn(LORA_E, LORA_R, k, device=dev, generator=g) / k ** 0.5
    b = torch.randn(LORA_E, n, LORA_R, device=dev, generator=g)
    return x, a, b


def lora_case(torch, which, fn, plain, lib, args, live, nbytes, flops,
              iters, shape, graph=False):
    """Run, hold against the plain version (per live row) and time one
    K4/K5 case (``graph``: also replayed from a CUDA graph); rows outside
    ``live`` must be exact zeros."""
    out = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise SystemExit(f"{which}: two calls on the same inputs differ")
    ref = plain(*args)
    kept = set(live)
    dead = [i for i in range(out.shape[0]) if i not in kept]
    if dead and out[dead].any():
        raise SystemExit(f"{which}: a row without an adapter is not 0")
    bms, by = bound(nbytes, flops, F32_FLOP_PER_S)
    case = dict(
        shape=shape, dtype="x bfloat16, bank float32",
        max_abs_err=(out[live] - ref[live]).abs().max().item(),
        max_rel_err=row_rel_err(out[live], ref[live]),
        ms=time_ms(torch, lambda: fn(*args), iters),
        plain_ms=time_ms(torch, lambda: plain(*args), max(3, iters // 10)),
        library_ms=time_ms(torch, lambda: lib(*args), iters),
        bound_ms=bms, bound_by=by)
    if graph:
        case["graph_ms"] = graph_ms(torch, lambda: fn(*args))
    print(f"{which}: {case}")
    return out, case


def lora_lib5(x, a, b, gates, rows_per_gate=1):
    """K5's library time: two einsums."""
    import torch
    u = torch.einsum("tk,erk->ter", x.float(), a)
    return torch.einsum("ter,enr->tn", u * gates.repeat_interleave(
        rows_per_gate, 0)[:, :, None], b)


def lora_lib4(x, a, b, sl):
    """K4's library time: two batched products over the rows' slots."""
    import torch
    idx = sl.long().clamp(min=0)
    u = torch.bmm(a.index_select(0, idx),
                  x.float()[:, :, None])                   # (T, r, 1)
    return torch.bmm(b.index_select(0, idx), u)[:, :, 0]


def phase_lora(torch):
    """K4 and K5 against their plain versions at the serving shapes: the
    four (k, n) projection shapes of the 2b SLM at the decode lane batch
    (T = 8) — K4 on slots with repeats and adapter-free rows, K5 on soft
    gates with a one-hot and an all-zero row, and K5 on the K4 rows'
    one-hot gates, which must equal K4 bit for bit — then K5 at the
    packed admission shape (8 requests x 1,552 positions, one gate row
    per request)."""
    from repro_torch.kernels.moe_lora import kernel as KL

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    slots = torch.tensor(K4_SLOTS, dtype=torch.int32, device=dev)
    hot = torch.zeros(8, LORA_E, device=dev)
    for i, s in enumerate(K4_SLOTS):
        if s >= 0:
            hot[i, s] = 1.0
    soft = torch.rand(8, LORA_E, device=dev, generator=g)
    soft[1] = torch.eye(LORA_E, device=dev)[2]          # one-hot row
    soft[5] = 0.0                                       # all-zero row
    live4 = [i for i, s in enumerate(K4_SLOTS) if s >= 0]
    live5 = [i for i in range(8) if i != 5]

    k4_cases, k5_cases = [], []
    for k, n in LORA_SHAPES:
        x, a, b = lora_inputs(torch, g, 8, k, n)
        used = len({s for s in K4_SLOTS if s >= 0})
        out4, c4 = lora_case(
            torch, f"K4 moe_lora_delta_slots k={k} n={n}",
            KL.moe_lora_delta_slots, KL.moe_lora_delta_slots_plain,
            lora_lib4,
            (x, a, b, slots), live4,
            8 * k * 2 + used * LORA_R * (k + n) * 4 + 8 * 4 + 8 * n * 4,
            2 * len(live4) * LORA_R * (k + n), 200,
            dict(T=8, k=k, n=n, E=LORA_E, r=LORA_R, slots=K4_SLOTS),
            graph=True)
        k4_cases.append(c4)
        hot_out = KL.moe_lora_delta(x, a, b, hot)
        torch.cuda.synchronize()
        if not torch.equal(hot_out, out4):
            raise SystemExit(f"K5 on one-hot gates differs from K4 at "
                             f"k={k} n={n}")
        nbytes5 = (8 * k * 2 + LORA_E * LORA_R * (k + n) * 4
                   + 8 * LORA_E * 4 + 8 * n * 4)
        _, c5 = lora_case(
            torch, f"K5 moe_lora_delta k={k} n={n}", KL.moe_lora_delta,
            KL.moe_lora_delta_plain, lora_lib5, (x, a, b, soft), live5,
            nbytes5,
            2 * 8 * LORA_E * LORA_R * (k + n), 200,
            dict(T=8, k=k, n=n, E=LORA_E, r=LORA_R, gates="soft, one "
                 "one-hot row, one zero row"), graph=True)
        k5_cases.append(c5)
        del x, a, b
    # the admission burst of serve_adapters: 8 requests x 1,552 slots
    t, s = 8 * 1552, 1552
    for k, n in LORA_SHAPES:
        x, a, b = lora_inputs(torch, g, t, k, n)
        gates = torch.rand(8, LORA_E, device=dev, generator=g)
        _, c5 = lora_case(
            torch, f"K5 moe_lora_delta admission k={k} n={n}",
            lambda *z: KL.moe_lora_delta(*z, rows_per_gate=s),
            lambda *z: KL.moe_lora_delta_plain(*z, rows_per_gate=s),
            lambda *z: lora_lib5(*z, rows_per_gate=s),
            (x, a, b, gates),
            list(range(t)),
            t * k * 2 + LORA_E * LORA_R * (k + n) * 4 + 8 * LORA_E * 4
            + t * n * 4, 2 * t * LORA_E * LORA_R * (k + n), 5,
            dict(T=t, rows_per_gate=s, k=k, n=n, E=LORA_E, r=LORA_R))
        k5_cases.append(c5)
        del x, a, b
        torch.cuda.empty_cache()
    # serve_adapters' admission prefill: one-hot gate rows (an adapter
    # slot each, two requests without one); the bound counts one expert
    # per live row
    hot_slots = [0, 3, -1, 1, 2, -1, 0, 3]
    hot_gates = torch.zeros(8, LORA_E, device=dev)
    for i, sl in enumerate(hot_slots):
        if sl >= 0:
            hot_gates[i, sl] = 1.0
    live = [i for i in range(t) if hot_slots[i // s] >= 0]
    used = len({sl for sl in hot_slots if sl >= 0})
    for k, n in LORA_SHAPES:
        x, a, b = lora_inputs(torch, g, t, k, n)
        _, c5 = lora_case(
            torch, f"K5 moe_lora_delta admission one-hot k={k} n={n}",
            lambda *z: KL.moe_lora_delta(*z, rows_per_gate=s),
            lambda *z: KL.moe_lora_delta_plain(*z, rows_per_gate=s),
            lambda *z: lora_lib5(*z, rows_per_gate=s),
            (x, a, b, hot_gates),
            live,
            t * k * 2 + used * LORA_R * (k + n) * 4 + 8 * LORA_E * 4
            + t * n * 4, 2 * len(live) * LORA_R * (k + n), 5,
            dict(T=t, rows_per_gate=s, k=k, n=n, E=LORA_E, r=LORA_R,
                 gates=f"one-hot, slots {hot_slots}"))
        k5_cases.append(c5)
        del x, a, b
        torch.cuda.empty_cache()
    bad = [c for c in k4_cases + k5_cases
           if not c["max_rel_err"] <= LORA_ROW_RTOL]
    if bad:
        raise SystemExit(f"K4/K5 disagree with their plain versions: {bad}")
    return k4_cases, k5_cases


def phase_lora_model(torch, short_len: int, tag: str, shapes, seed: int):
    """K4 and K5 against their plain versions at an SLM-only model's
    LoRA shapes (``shapes``: ZAMBA2_LORA_SHAPES for serve_zamba2,
    GRANITE_LORA_SHAPES for serve_granite; ``tag`` names the model), as
    its slots and router runs give them:
    K4 at decode (T = 1, one user's slot), K5 at decode (T = 1, one soft
    gate row) — and K5 on that slot's one-hot gates, which must equal K4
    bit for bit — then K5 at a demo prompt's prefill (T = S, one gate row
    over its S rows), soft (the router) and one-hot (a user's slot); and
    K9 (``k9_case``) at a client step's T = 160 rows, E = 1, on the
    shapes, K5's forward beside it.  Returns (K4 cases, K5 cases, K9
    cases)."""
    from repro_torch.kernels.moe_lora import kernel as KL

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    slot = torch.tensor([2], dtype=torch.int32, device=dev)
    hot = torch.eye(LORA_E, device=dev)[2:3]
    soft = torch.rand(1, LORA_E, device=dev, generator=g)
    s = short_len
    k4_cases, k5_cases = [], []
    for k, n in shapes:
        one = LORA_R * (k + n) * 4                      # one expert's A, B
        x, a, b = lora_inputs(torch, g, 1, k, n)
        out4, c4 = lora_case(
            torch, f"K4 moe_lora_delta_slots {tag} decode k={k} n={n}",
            KL.moe_lora_delta_slots, KL.moe_lora_delta_slots_plain,
            lora_lib4, (x, a, b, slot),
            [0], k * 2 + one + 4 + n * 4, 2 * LORA_R * (k + n), 200,
            dict(model=tag, T=1, k=k, n=n, E=LORA_E, r=LORA_R, slots=[2]),
            graph=True)
        k4_cases.append(c4)
        hot_out = KL.moe_lora_delta(x, a, b, hot)
        torch.cuda.synchronize()
        if not torch.equal(hot_out, out4):
            raise SystemExit(f"K5 on one-hot gates differs from K4 at "
                             f"{tag}'s k={k} n={n}")
        _, c5 = lora_case(
            torch, f"K5 moe_lora_delta {tag} decode k={k} n={n}",
            KL.moe_lora_delta, KL.moe_lora_delta_plain, lora_lib5,
            (x, a, b, soft), [0],
            k * 2 + LORA_E * one + LORA_E * 4 + n * 4,
            2 * LORA_E * LORA_R * (k + n), 200,
            dict(model=tag, T=1, k=k, n=n, E=LORA_E, r=LORA_R,
                 gates="soft"), graph=True)
        k5_cases.append(c5)
        x = torch.randn(s, k, device=dev, generator=g).bfloat16()
        for gates, used, kind in ((soft, LORA_E, "soft"),
                                  (hot, 1, "one-hot")):
            _, c5 = lora_case(
                torch, f"K5 moe_lora_delta {tag} prefill {kind} k={k} "
                f"n={n}",
                lambda *z: KL.moe_lora_delta(*z, rows_per_gate=s),
                lambda *z: KL.moe_lora_delta_plain(*z, rows_per_gate=s),
                lambda *z: lora_lib5(*z, rows_per_gate=s),
                (x, a, b, gates), list(range(s)),
                s * k * 2 + used * one + LORA_E * 4 + s * n * 4,
                2 * s * used * LORA_R * (k + n), 50,
                dict(model=tag, T=s, rows_per_gate=s, k=k, n=n, E=LORA_E,
                     r=LORA_R, gates=kind))
            k5_cases.append(c5)
        del x, a, b
    k9_cases = [k9_case(torch, g, 160, k, n, 1, 1) for k, n in shapes]
    for c in k9_cases:
        c["shape"]["model"] = tag
    bad = [c for c in k4_cases + k5_cases
           if not c["max_rel_err"] <= LORA_ROW_RTOL] + \
        [c for c in k9_cases if not (c["rel_err_dx_da_db"][0] <= K9_DX_RTOL
                                     and max(c["rel_err_dx_da_db"][1:])
                                     <= K9_RTOL
                                     and c["k5_forward_row_rel_err"]
                                     <= LORA_ROW_RTOL)]
    if bad:
        raise SystemExit(f"K4/K5/K9 disagree with their plain versions at "
                         f"{tag}'s shapes: {bad}")
    return k4_cases, k5_cases, k9_cases


def phase_k6(torch, short_len: int):
    """K6 against its plain version at serve_ssm's shapes: the 1,536-token
    prefill and a short demo prompt's, d_inner 8,192, N 16, B and C
    strided; two calls must return the same bits.  Bound: bytes (dt f32,
    x and y bf16, A, h_final, B and C once) against ~7 f32 operations
    per (t, d, n), the exponential counted as one.  Beside it, the
    exponentials' own floor: S * di * N of them on the special-function
    units, 16 a clock per SM at the card's top SM clock."""
    from repro_torch.kernels.ssm_scan import kernel as K6
    from repro_torch.kernels.time_kernels import ssm_inputs

    g = torch.Generator(device="cuda").manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    cases = []
    for s in (SSM_LONG_TOKENS, short_len):
        args = ssm_inputs(torch, g, s)
        y, h = K6.ssm_scan(*args)
        y2, h2 = K6.ssm_scan(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise SystemExit("K6: two calls on the same inputs differ")
        ry, rh = K6.ssm_scan_plain(*args)
        if not (torch.isfinite(y.float()).all() and torch.isfinite(h).all()):
            raise SystemExit("K6 wrote a non-finite value")
        nbytes = (s * SSM_DI * (4 + 2 + 2) + 2 * SSM_DI * SSM_N * 4
                  + 2 * s * SSM_N * 2)
        bms, by = bound(nbytes, 7 * s * SSM_DI * SSM_N, F32_FLOP_PER_S)
        cases.append(dict(
            shape=dict(B=1, S=s, di=SSM_DI, N=SSM_N,
                       bc="strided slices of (1, S, 288)"),
            dtype="dt/A f32, x/B/C/y bf16, h f32",
            max_abs_err=(y.float() - ry.float()).abs().max().item(),
            max_rel_err=row_rel_err(y, ry),
            h_max_abs_err=(h - rh).abs().max().item(),
            h_rel_err=((h - rh).abs().max() / rh.abs().max()).item(),
            ms=time_ms(torch, lambda: K6.ssm_scan(*args), 50),
            graph_ms=graph_ms(torch, lambda: K6.ssm_scan(*args)),
            plain_ms=time_ms(torch, lambda: K6.ssm_scan_plain(*args),
                             2 if s > 512 else 5),
            library_ms=None, bound_ms=bms, bound_by=by))
        print(f"K6 ssm_scan: {cases[-1]}; exponentials' floor "
              f"{s * SSM_DI * SSM_N / (16 * sms * mhz * 1e6) * 1e3} ms "
              f"({sms} SMs at {mhz} MHz)")
        del args, y, h, y2, h2, ry, rh
    bad = [c for c in cases if not (c["max_rel_err"] <= K6_ROW_RTOL
                                    and c["h_rel_err"] <= K6_H_RTOL)]
    if bad:
        raise SystemExit(f"K6 disagrees with its plain version: {bad}")
    return cases


def phase_k11(torch, short_len: int):
    """K11 against its plain version (the reference's chunk loop) at
    serve_zamba2's shapes: the 1,536-token prefill and a short demo
    prompt's, 112 heads of 64 channels, N 64, one group, x, B and C bf16
    strided column slices of a conv-like (1, S, 7,296) output
    (``time_kernels.ssd_inputs``); two calls must return the same bits.
    Bound: bytes (x, B, C, dt and a read once, y and h_final written)
    against 3 FMAs a state-step in f32."""
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.kernels.time_kernels import (SSD_H, SSD_N, SSD_P,
                                                  ssd_inputs)

    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for s in (SSM_LONG_TOKENS, short_len):
        args = ssd_inputs(torch, g, s)
        y, h = K11.ssd_scan(*args)
        y2, h2 = K11.ssd_scan(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise SystemExit("K11: two calls on the same inputs differ")
        if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
            raise SystemExit("K11 wrote a non-finite value")
        ry, rh = K11.ssd_scan_plain(*args)
        steps = s * SSD_H * SSD_P * SSD_N
        nbytes = (s * SSD_H * SSD_P * (2 + 4) + 2 * s * SSD_N * 2
                  + s * SSD_H * 4 + SSD_H * 4 + SSD_H * SSD_P * SSD_N * 4)
        bms, by = bound(nbytes, 6 * steps, F32_FLOP_PER_S)
        cases.append(dict(
            shape=dict(B=1, S=s, H=SSD_H, P=SSD_P, N=SSD_N, G=1,
                       layout="x, B, C strided slices of (1, S, 7296)"),
            dtype="x/B/C bf16, dt/a/y/h_final f32", state_steps=steps,
            max_abs_err=(y - ry).abs().max().item(),
            max_rel_err=row_rel_err(y, ry),
            h_rel_err=((h - rh).abs().max() / rh.abs().max()).item(),
            ms=time_ms(torch, lambda: K11.ssd_scan(*args), 50),
            graph_ms=graph_ms(torch, lambda: K11.ssd_scan(*args)),
            plain_ms=time_ms(torch, lambda: K11.ssd_scan_plain(*args),
                             5 if s > 512 else 20),
            library_ms=None, bound_ms=bms, bound_by=by))
        print(f"K11 ssd_scan: {cases[-1]}")
        del args, y, h, y2, h2, ry, rh
    bad = [c for c in cases if not (c["max_rel_err"] <= K11_ROW_RTOL
                                    and c["h_rel_err"] <= K11_H_RTOL)]
    if bad:
        raise SystemExit(f"K11 disagrees with its plain version: {bad}")
    return cases


def phase_k3_d112(torch, short_len: int):
    """K3 at zamba2-7b's shared attention block: B = 1, H = KV = 32,
    head_dim 112, its window of 4,096 (longer than the prompt, so the
    causal mask) at the long prompt's and a demo prompt's S, on (B, H,
    S, D) views of (B, S, H, D) tensors, as the block hands them over.
    The windowed call must equal the causal one bit for bit, and a second
    call the first.  Library: SDPA, causal (the same function here)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.time_kernels import (Z_HD, Z_HEADS, Z_WINDOW,
                                                  k3d112_inputs)

    g = torch.Generator(device="cuda").manual_seed(112)
    cases = []
    for s in (SSM_LONG_TOKENS, short_len):
        q, k, v = k3d112_inputs(torch, g, s)
        out = K3.flash_attention(q, k, v, window=Z_WINDOW)
        again = K3.flash_attention(q, k, v, window=Z_WINDOW)
        causal = K3.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(out, causal)):
            raise SystemExit("K3 at head_dim 112: two calls, or the window "
                             "and causal modes, differ")
        ref = K3.flash_attention_plain(q, k, v, window=Z_WINDOW)

        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        visible = s * (s + 1) // 2
        nbytes = 2 * 4 * Z_HEADS * s * Z_HD
        bms, by = bound(nbytes, 4 * Z_HD * Z_HEADS * visible,
                        BF16_FLOP_PER_S)
        iters = 20 if s > 512 else 200
        cases.append(dict(
            shape=dict(B=1, H=Z_HEADS, KVH=Z_HEADS, S=s, D=Z_HD,
                       window=Z_WINDOW, layout="(B, S, H, D) views"),
            dtype="bfloat16",
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            max_rel_err=row_rel_err(out, ref),
            ms=time_ms(torch, lambda: K3.flash_attention(
                q, k, v, window=Z_WINDOW), iters),
            graph_ms=graph_ms(torch, lambda: K3.flash_attention(
                q, k, v, window=Z_WINDOW)),
            plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                q, k, v, window=Z_WINDOW), max(5, iters // 10)),
            library_ms=time_ms(torch, lib, iters),
            library_max_rel_err=row_rel_err(lib(), ref),
            bound_ms=bms, bound_by=by))
        print(f"K3 flash_attention (head_dim 112): {cases[-1]}")
        del q, k, v, out, again, causal, ref
    bad = [c for c in cases if not c["max_rel_err"] <= K3_ROW_RTOL]
    if bad:
        raise SystemExit(f"K3 at head_dim 112 disagrees with its plain "
                         f"version: {bad}")
    return cases


def check_ssm(torch):
    """Reduced falcon-mamba: bf16 on the card (prefill through K6) vs f32
    on the CPU (the plain scan), prefill + 4 decode steps of a SoloEngine
    deployment; then the same under LoRA (``check_ssm_lora``)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.ssm_scan import kernel as K6
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import SoloEngine

    cfg = get_config("falcon-mamba-7b").reduced()          # float32
    base = bridge.to_numpy(LM(cfg, device="cpu").init(3))
    logits, before, deps = {}, K6.ssm_scan.launches, {}
    # bf16 on the CPU too: the share of the card's error that bf16 itself
    # makes through the plain path
    runs = (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "bfloat16"))
    for dev, dtype in runs:
        lm = LM(dataclasses.replace(cfg, dtype=dtype), device=dev)
        dep = ServingDeployment(lm, bridge.from_numpy(
            base, device=dev, dtype=getattr(torch, dtype)), max_seq=96,
            device=dev)
        deps[dev, dtype] = dep
        toks = dep.tokens(TOK.encode("translate to french: water -> "))
        lg, cache = dep.slm_prefill(dep.slm_params, toks)
        steps = [lg]
        for t in (40, 41, 42, 43):
            lg, cache = dep.slm_decode(dep.slm_params, cache,
                                       dep.tokens([t]))
            steps.append(lg)
        logits[dev, dtype] = torch.cat(steps, 1).float().cpu()
        with TokenIds():
            ids = SoloEngine(deployment=dep).generate(
                "math: compute 12 plus 7 =", 8)
            print(f"check ssm {dev} {dtype}: SoloEngine ids {ids}")
    ref = logits["cpu", "float32"]
    rel, rel_cpu = (((logits[k] - ref).abs().max() / ref.abs().max()).item()
                    for k in (("cuda", "bfloat16"), ("cpu", "bfloat16")))
    print(f"check ssm: reduced falcon-mamba prefill+4 decode logits, bf16 "
          f"card vs f32 cpu, max|diff|/max|ref| = {rel:.3e} (bf16 cpu vs "
          f"f32 cpu {rel_cpu:.3e}); K6 launches "
          f"{K6.ssm_scan.launches - before}")
    if not rel <= LOGITS_TOL or K6.ssm_scan.launches - before != 2 * 2:
        raise SystemExit("reduced falcon-mamba check failed")
    check_ssm_lora(torch, deps)


def check_ssm_lora(torch, deps):
    """The reduced falcon-mamba with a 3-expert bank on its four SSM
    projections: SLM prefill + 4 decode steps of a batch of three under
    one-hot adapter-slot rows then slot ids, and under soft router gates,
    bf16 on the card (K5 at prefill, K5 on gate rows or K4 on slot ids
    at decode) against bf16 on the CPU (the plain versions in the same
    dtype) within LOGITS_TOL.  Against f32 on the CPU both bf16 runs
    read bf16's own error, printed beside it: it passes LOGITS_TOL on
    this reduced model under the bank (1.16e-2 for the CPU's bf16 path
    alone, 9.1e-3 without the bank), so f32 cannot isolate the
    kernels here."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.core import lora as LORA
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.moe_lora import kernel as KL

    cpu = deps["cpu", "float32"]
    # B ~ N(0, 0.1^2) at rank 4, as check_lora draws it
    ads = [bridge.to_numpy(a) for a in random_adapters(
        torch, cpu.slm, 3, 0.1, 71, "cpu")]
    bank = bridge.to_numpy(LORA.stack_adapters(
        [bridge.from_numpy(a) for a in ads]))
    router = check_router(3)
    prompts = ["translate to french: water ->", "math: compute 12 plus 7 =",
               "explain how rainbows form when sunlight passes through rain"]
    ids = [TOK.encode(p + " ")[:24] for p in prompts]
    toks = [[t[i % len(t)] for i in range(24)] for t in ids]
    k4, k5 = KL.moe_lora_delta_slots.launches, KL.moe_lora_delta.launches
    worst = 0.0
    for name, g_pre, g_dec in (
            ("adapters", LORA.slot_gates([2, None, 0], 3),
             np.asarray([2, -1, 0], np.int32)),
            ("router", router.gate_weights_batch(prompts), None)):
        logits = {}
        for key, dep in deps.items():
            lm, params, at = dep.slm, dep.slm_params, dep.device
            lora = bridge.from_numpy(LORA.bank_for_model(bank), device=at)
            gp = torch.as_tensor(np.ascontiguousarray(g_pre), device=at)
            gd = gp if g_dec is None else torch.as_tensor(g_dec, device=at)
            lg, cache = lm.prefill(params, torch.as_tensor(toks, device=at),
                                   dep.max_seq, lora, gp)
            steps = [lg]
            for t in (40, 41, 42, 43):
                lg, cache = lm.decode_step(params, cache, torch.full(
                    (3, 1), t, dtype=torch.int64, device=at), lora, gd)
                steps.append(lg)
            logits[key] = torch.cat(steps, 1).float().cpu()

        def rel_to(a, b):
            ref = logits[b]
            return ((logits[a] - ref).abs().max() / ref.abs().max()).item()
        card = ("cuda", "bfloat16")
        rel = rel_to(card, ("cpu", "bfloat16"))
        print(f"check ssm lora {name}: SLM prefill (B=3) + 4 decode steps "
              f"with a 3-expert bank on ssm_in/x/dt/out, bf16 card vs bf16 "
              f"cpu, max|diff|/max|ref| = {rel:.3e}; against f32 cpu: card "
              f"{rel_to(card, ('cpu', 'float32')):.3e}, bf16 cpu "
              f"{rel_to(('cpu', 'bfloat16'), ('cpu', 'float32')):.3e}")
        worst = max(worst, rel)
    # two prefills (8 layer-target passes each, K5) and 8 decode steps:
    # four with slot ids (K4), four with router gates (K5)
    got = (KL.moe_lora_delta_slots.launches - k4,
           KL.moe_lora_delta.launches - k5)
    print(f"check ssm lora: K4, K5 launches {got}")
    if not worst <= LOGITS_TOL or got != (4 * 8, 2 * 8 + 4 * 8):
        raise SystemExit("reduced falcon-mamba LoRA check failed")


def phase_check(torch):
    """Reduced 2b pair: bf16 on the card (K1, K3) vs f32 on the CPU."""
    from repro_torch import bridge
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.data import tokenizer as TOK
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import HybridEngine

    # one set of f32 parameters, made on the CPU and cast for the card
    cfgs = pair_configs("2b")                  # reduced, float32
    base = [bridge.to_numpy(LM(c, device="cpu").init(i))
            for i, c in enumerate(cfgs)]
    mlp = FUS.init_alignment(2, cfgs[0].vocab_size, device="cpu")
    deps = {}
    for dev, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
        slm, llm = (LM(dataclasses.replace(c, dtype=dtype), device=dev)
                    for c in cfgs)
        sp, lp = (bridge.from_numpy(p, device=dev,
                                    dtype=getattr(torch, dtype))
                  for p in base)
        deps[dev] = ServingDeployment(slm, sp, llm, lp, mlp, max_seq=96,
                                      device=dev)
    prompt = "translate to french: water ->"
    worst = 0.0
    for name in ("slm", "llm"):
        logits = {}
        for dev, dep in deps.items():
            lm, params = getattr(dep, name), getattr(dep, f"{name}_params")
            toks = dep.tokens(TOK.encode(prompt + " "))
            lg, cache = lm.prefill(params, toks, dep.max_seq)
            steps = [lg]
            for t in (40, 41, 42, 43):
                lg, cache = lm.decode_step(params, cache, dep.tokens([t]))
                steps.append(lg)
            logits[dev] = torch.cat(steps, 1).float().cpu()
        ref = logits["cpu"]
        rel = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
        print(f"check {name}: prefill+4 decode logits, bf16 card vs f32 "
              f"cpu, max|diff|/max|ref| = {rel:.3e}")
        worst = max(worst, rel)
    runs = {dev: HybridEngine(deployment=dep).generate(prompt, 6, rid=0)[1]
            for dev, dep in deps.items()}
    dw = max(abs(a - b) for a, b in zip(runs["cuda"].fusion_w,
                                        runs["cpu"].fusion_w))
    print(f"check engine: latency_ms equal="
          f"{runs['cuda'].latency_ms == runs['cpu'].latency_ms}, "
          f"max |fusion_w diff| = {dw:.3e}")
    if not (worst <= LOGITS_TOL and dw <= FUSION_W_TOL
            and runs["cuda"].latency_ms == runs["cpu"].latency_ms):
        raise SystemExit("reduced-pair check failed")
    check_paged(torch, deps)
    check_lora(torch, deps)
    check_gemma3(torch)
    check_ssm(torch)


def check_gemma3(torch):
    """Reduced gemma3 pair (window 16, one group of a local and a global
    layer) in bf16 on the card (K3 windowed and causal, K2 in ring mode
    and plain, K1, K4) against the same parameters in f32 on the CPU, at
    max_seq 96 with prompts longer than the window: sequential prefill
    and 8 decode steps of the SLM, the sequential engine, paged decode
    of a ragged batch of three (rings wrapped at admission), the batched
    engine at macro_k 0 and 8, and SLM logits under adapter slots."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs.floe_pair import needs_ring_cache, pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.core import lora as LORA
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import HybridEngine
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    cfgs = pair_configs("gemma3")                  # reduced, float32
    base = [bridge.to_numpy(LM(c, device="cpu").init(10 + i))
            for i, c in enumerate(cfgs)]
    mlp = FUS.init_alignment(12, cfgs[0].vocab_size, device="cpu")
    deps = {}
    for dev, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
        slm, llm = (LM(dataclasses.replace(c, dtype=dtype), device=dev,
                       ring_cache=needs_ring_cache(c)) for c in cfgs)
        sp, lp = (bridge.from_numpy(p, device=dev,
                                    dtype=getattr(torch, dtype))
                  for p in base)
        deps[dev] = ServingDeployment(slm, sp, llm, lp, mlp, max_seq=96,
                                      device=dev)
    prompts = ["explain how rainbows form when sunlight passes through rain",
               "translate to french: water ->", "sort ascending: 40 12 77"]
    assert all(len(TOK.encode(p + " ")) > 16 for p in prompts)
    fails = []

    def rel(logits):
        ref = logits["cpu"]
        return ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()

    k3 = (K3.flash_attention.launches, K3.flash_attention.windowed_launches)
    logits = {}
    for dev, dep in deps.items():
        toks = dep.tokens(TOK.encode(prompts[0] + " "))
        lg, cache = dep.slm.prefill(dep.slm_params, toks, dep.max_seq)
        steps = [lg]
        for t in range(40, 48):
            lg, cache = dep.slm.decode_step(dep.slm_params, cache,
                                            dep.tokens([t]))
            steps.append(lg)
        logits[dev] = torch.cat(steps, 1).float().cpu()
    k3 = (K3.flash_attention.launches - k3[0],
          K3.flash_attention.windowed_launches - k3[1])
    worst = rel(logits)
    print(f"check gemma3 slm: prefill + 8 decode steps (ring wraps), bf16 "
          f"card vs f32 cpu, max|diff|/max|ref| = {worst:.3e}; K3 "
          f"(launches, windowed) {k3}")
    if k3 != (2, 1):
        fails.append(f"K3 launches {k3}, expected (2, 1)")
    runs = {dev: HybridEngine(deployment=dep).generate(
        prompts[0], 20, rid=0)[1] for dev, dep in deps.items()}
    lat_eq = runs["cuda"].latency_ms == runs["cpu"].latency_ms
    dw = max(abs(a - b) for a, b in zip(runs["cuda"].fusion_w,
                                        runs["cpu"].fusion_w))
    k2 = (K2.paged_decode_attention.launches,
          K2.paged_decode_attention.ring_launches)
    for name in ("slm", "llm"):
        got = {dev: paged_logits(torch, dep, getattr(dep, name),
                                 getattr(dep, f"{name}_params"), prompts,
                                 range(40, 60))
               for dev, dep in deps.items()}
        print(f"check gemma3 paged {name}: packed prefill (B=3, ragged) + "
              f"20 paged decode steps, bf16 card vs f32 cpu, "
              f"max|diff|/max|ref| = {rel(got):.3e}")
        worst = max(worst, rel(got))
    k2 = (K2.paged_decode_attention.launches - k2[0],
          K2.paged_decode_attention.ring_launches - k2[1])
    # 20 steps: SLM 1 ring + 1 plain layer, LLM 2 plain layers
    if k2 != (20 * 4, 20):
        fails.append(f"K2 (launches, ring) {k2}, expected (80, 20)")
    for k in (0, 8):
        res = {}
        for dev, dep in deps.items():
            sched = ContinuousBatchScheduler.from_deployment(
                dep, batch_size=4, macro_k=k)
            for p in DEMO_PROMPTS_GEMMA3:
                sched.submit(p, 20)
            res[dev] = sched.run()
        lat_eq &= all(a.stats.latency_ms == b.stats.latency_ms
                      for a, b in zip(res["cuda"], res["cpu"]))
        dw = max([dw] + [abs(x - y) for a, b in zip(res["cuda"], res["cpu"])
                         for x, y in zip(a.stats.fusion_w, b.stats.fusion_w)])
    print(f"check gemma3 engines (sequential, batched macro_k 0 and 8): "
          f"latency_ms equal={lat_eq}, max |fusion_w diff| = {dw:.3e}")
    ads = [bridge.to_numpy(a) for a in random_adapters(
        torch, deps["cpu"].slm, 3, 0.1, 80, "cpu")]
    bank = bridge.to_numpy(LORA.stack_adapters(
        [bridge.from_numpy(a) for a in ads]))
    ids = [TOK.encode(p + " ")[:24] for p in prompts]
    toks = [[t[i % len(t)] for i in range(24)] for t in ids]
    g_pre = LORA.slot_gates([2, None, 0], 3)
    logits = {}
    for dev, dep in deps.items():
        at = dep.device
        lora = bridge.from_numpy(LORA.bank_for_model(bank), device=at)
        lg, cache = dep.slm.prefill(
            dep.slm_params, torch.as_tensor(toks, device=at), dep.max_seq,
            lora, torch.as_tensor(g_pre, device=at))
        steps = [lg]
        for t in (40, 41, 42, 43):
            lg, cache = dep.slm.decode_step(
                dep.slm_params, cache, torch.full((3, 1), t, device=at),
                lora, torch.as_tensor([2, -1, 0], dtype=torch.int32,
                                      device=at))
            steps.append(lg)
        logits[dev] = torch.cat(steps, 1).float().cpu()
    print(f"check gemma3 lora: SLM prefill (B=3, 24 tokens) + 4 decode "
          f"steps under adapter slots (K5 one-hot rows, K4 slot ids), bf16 "
          f"card vs f32 cpu, max|diff|/max|ref| = {rel(logits):.3e}")
    worst = max(worst, rel(logits))
    if not (worst <= LOGITS_TOL and lat_eq and dw <= FUSION_W_TOL) or fails:
        raise SystemExit(f"reduced gemma3 check failed: {fails}")


def random_adapters(torch, lm, n, scale, seed, device):
    """``n`` adapters of full rank for ``lm`` on ``device``: A from
    ``init_adapter``, B ~ N(0, scale^2) from a seeded generator (an
    adapter fresh from ``init_adapter`` has B = 0 and changes nothing)."""
    from repro_torch.core import lora as LORA

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for j in range(n):
        ad = LORA.init_adapter(lm, seed + j, rank=lm.cfg.lora_rank_max,
                               device=device)
        for stack in (v for k, v in ad.items() if not k.startswith("_")):
            for leaf in stack.values():
                leaf["B"].normal_(0.0, scale, generator=gen)
        out.append(ad)
    return out


def check_router(n: int = 4):
    """A Router over the first ``n`` domains (Eq. 9 centroids)."""
    from repro_torch.core.router import ExpertMeta, Router, expert_embedding
    return Router([ExpertMeta(name, expert_embedding(samples), i)
                   for i, (name, samples) in enumerate(ROUTER_DOMAINS[:n])])


def check_lora(torch, deps):
    """The reduced pair with LoRA, bf16 on the card (K4, K5) vs f32 on
    the CPU: SLM prefill + decode of a mixed batch under one-hot gate
    rows then slot ids, and under soft router gates (logits); the
    batched engine serving mixed adapters with use_slot_kernel False and
    True, and one router-gated sequential request (latencies equal,
    fusion weights close)."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.core import lora as LORA
    from repro_torch.data import tokenizer as TOK
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import HybridEngine
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    cpu = deps["cpu"]
    # B ~ N(0, 0.1^2) at rank 4: a delta ~0.3x its projection.  At 2.0
    # (~5.6x) the residual stream grows until bf16 and f32 logits part
    # (1.6e-2 and 1.05 of max|ref| on the port's CPU path alone).
    ads = [bridge.to_numpy(a) for a in random_adapters(
        torch, cpu.slm, 3, 0.1, 70, "cpu")]
    bank = bridge.to_numpy(LORA.stack_adapters(
        [bridge.from_numpy(a) for a in ads]))
    router = check_router(3)
    prompts = ["translate to french: water ->", "math: compute 12 plus 7 =",
               "explain how rainbows form when sunlight passes through rain"]
    ids = [TOK.encode(p + " ")[:24] for p in prompts]
    toks = [[t[i % len(t)] for i in range(24)] for t in ids]
    worst = 0.0
    for name, g_pre, g_dec in (
            ("adapters", LORA.slot_gates([2, None, 0], 3),
             np.asarray([2, -1, 0], np.int32)),
            ("router", router.gate_weights_batch(prompts), None)):
        logits = {}
        for dev, dep in deps.items():
            lm, params, at = dep.slm, dep.slm_params, dep.device
            lora = bridge.from_numpy(LORA.bank_for_model(bank), device=at)
            gp = torch.as_tensor(np.ascontiguousarray(g_pre), device=at)
            gd = gp if g_dec is None else torch.as_tensor(g_dec, device=at)
            lg, cache = lm.prefill(params, torch.as_tensor(toks, device=at),
                                   dep.max_seq, lora, gp)
            steps = [lg]
            for t in (40, 41, 42, 43):
                lg, cache = lm.decode_step(params, cache, torch.full(
                    (3, 1), t, dtype=torch.int64, device=at), lora, gd)
                steps.append(lg)
            logits[dev] = torch.cat(steps, 1).float().cpu()
        ref = logits["cpu"]
        rel = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
        print(f"check lora {name}: SLM prefill (B=3) + 4 decode steps with a "
              f"3-expert bank, bf16 card vs f32 cpu, max|diff|/max|ref| = "
              f"{rel:.3e}")
        worst = max(worst, rel)
    ok, lat_eq, dw = True, True, 0.0
    for flag in (False, True):
        res = {}
        for dev, dep in deps.items():
            ad_dep = ServingDeployment(
                dep.slm, dep.slm_params, dep.llm, dep.llm_params, dep.mlp,
                max_seq=dep.max_seq, adapter_slots=2, device=dep.device)
            sched = ContinuousBatchScheduler.from_deployment(
                ad_dep, batch_size=4, macro_k=0, use_slot_kernel=flag)
            for j, a in enumerate(ads):
                sched.engine.adapters.register(
                    f"user{j}", bridge.from_numpy(a, device=dep.device))
            for i, p in enumerate(prompts + prompts[:2]):
                sched.submit(p, 6, adapter_id=[f"user{i % 3}", None][i % 2])
            res[dev] = (sched.run(), sched.engine.adapter_stats())
        (rc, sc), (rg, sg) = res["cuda"], res["cpu"]
        lat_eq &= all(a.stats.latency_ms == b.stats.latency_ms
                      for a, b in zip(rc, rg))
        dw = max([dw] + [abs(x - y) for a, b in zip(rc, rg)
                         for x, y in zip(a.stats.fusion_w, b.stats.fusion_w)])
        ok &= sc == sg and sc["evictions"] > 0 and sc["pinned"] == 0
        print(f"check adapters batched (use_slot_kernel={flag}): "
              f"adapter_stats {sc} (cpu {sg})")
    runs = {}
    for dev, dep in deps.items():
        r_dep = ServingDeployment(
            dep.slm, dep.slm_params, dep.llm, dep.llm_params, dep.mlp,
            expert_bank=bridge.from_numpy(bank, device=dep.device),
            max_seq=dep.max_seq, device=dep.device)
        runs[dev] = HybridEngine(deployment=r_dep, router=router).generate(
            prompts[0], 6, rid=3)[1]
    lat_eq &= runs["cuda"].latency_ms == runs["cpu"].latency_ms
    dw = max([dw] + [abs(a - b) for a, b in zip(runs["cuda"].fusion_w,
                                                runs["cpu"].fusion_w)])
    print(f"check lora engines: latency_ms equal={lat_eq}, max |fusion_w "
          f"diff| = {dw:.3e}")
    if not (ok and lat_eq and worst <= LOGITS_TOL and dw <= FUSION_W_TOL):
        raise SystemExit("reduced-pair LoRA check failed")


def paged_logits(torch, dep, lm, params, prompts, forced):
    """Packed prefill of ``prompts`` straight into pool pages (every row
    mapped eagerly, rings included), then one paged decode step per
    forced token: (B, 1 + len(forced), V) float32 logits on the host."""
    import numpy as np
    from repro_torch.data import tokenizer as TOK

    ids = [TOK.encode(p + " ") for p in prompts]
    geo = dep.paged_geometry(lm)
    b, nb, nl = len(ids), geo["nb"], geo["nl"]
    cache = dep.init_paged_lane_cache(lm, b, b * nb, b * nl)
    tables = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    local = np.arange(b * nl, dtype=np.int32).reshape(b, nl) if nl else None
    lens = np.array([len(x) for x in ids], np.int32)
    toks = np.zeros((b, -(-int(lens.max()) // 16) * 16), np.int64)
    for i, x in enumerate(ids):
        toks[i, :len(x)] = x
    rows = list(range(b))
    logits = lm.prefill_packed(
        params, torch.as_tensor(toks, device=dep.device), lens, dep.max_seq,
        dep.page_writer(cache, rows, tables, lens, local, geo["local_len"]))
    dep.finish_paged_insert(cache, rows, lens, tables, local)
    steps = [logits]
    for t in forced:
        logits, cache = lm.decode_step(params, cache, torch.full(
            (b, 1), t, dtype=torch.int64, device=dep.device))
        steps.append(logits)
    return torch.cat(steps, 1).float().cpu()


def check_paged(torch, deps):
    """Paged decode (K2 on the card) of a ragged batch of three with
    forced tokens, then the batched engine, bf16 card vs f32 CPU."""
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    prompts = ["translate to french: water ->", "math: compute 12 plus 7 =",
               "explain how rainbows form when sunlight passes through rain"]
    worst = 0.0
    for name in ("slm", "llm"):
        logits = {dev: paged_logits(torch, dep, getattr(dep, name),
                                    getattr(dep, f"{name}_params"), prompts,
                                    range(40, 48))
                  for dev, dep in deps.items()}
        ref = logits["cpu"]
        rel = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
        print(f"check paged {name}: packed prefill (B=3, ragged) + 8 paged "
              f"decode steps, bf16 card vs f32 cpu, max|diff|/max|ref| = "
              f"{rel:.3e}")
        worst = max(worst, rel)
    res = {}
    for dev, dep in deps.items():
        sched = ContinuousBatchScheduler.from_deployment(dep, batch_size=4,
                                                         macro_k=0)
        for p in DEMO_PROMPTS:
            sched.submit(p, 6)
        res[dev] = sched.run()
    lat_eq = all(a.stats.latency_ms == b.stats.latency_ms
                 for a, b in zip(res["cuda"], res["cpu"]))
    dw = max(abs(x - y) for a, b in zip(res["cuda"], res["cpu"])
             for x, y in zip(a.stats.fusion_w, b.stats.fusion_w))
    print(f"check batched engine: latency_ms equal={lat_eq}, max "
          f"|fusion_w diff| = {dw:.3e}")
    if not (worst <= LOGITS_TOL and lat_eq and dw <= FUSION_W_TOL):
        raise SystemExit("reduced-pair paged check failed")


def phase_cli():
    """The serving launcher's ``--local`` run, on its default device,
    sequential and batched, on the 2b and the gemma3 pair, and sampled
    (``--sample --sample-seed 3``) sequentially and batched at
    ``--macro-k`` 8 and 0, whose lines must be equal."""
    from repro_torch.launch import serve
    sampled = {}
    for argv in (["--local"], ["--local", "--batch", "4", "--macro-k", "0"],
                 ["--local", "--batch", "4"],
                 ["--local", "--batch", "4", "--macro-k", "0", "--adapters",
                  "3", "--adapter-slots", "2"],
                 ["--local", "--pair", "gemma3"],
                 ["--local", "--pair", "gemma3", "--batch", "4"],
                 ["--local", "--sample", "--sample-seed", "3"],
                 ["--local", "--sample", "--sample-seed", "3", "--batch",
                  "4"],
                 ["--local", "--sample", "--sample-seed", "3", "--batch",
                  "4", "--macro-k", "0"]):
        res = serve.main(argv)
        if "--sample" in argv and "--batch" in argv:
            sampled[argv[-1]] = res
        for r in res:
            if r.stats.tokens == 0 or (r.stats.private
                                       and r.stats.cloud_tokens):
                raise SystemExit(f"serve {argv}: bad request {r.rid}: "
                                 f"{r.stats}")
        if sum(r.stats.private for r in res) != 2:
            raise SystemExit(f"serve {argv}: the detector missed a private "
                             "prompt")
    if not all(same_response(a, b) for a, b in zip(sampled["4"],
                                                   sampled["0"])):
        raise SystemExit("serve --sample --batch 4: K = 8 differs from "
                         "--macro-k 0")


def all_kernels():
    """Every kernel wrapper of the port, K1-K12."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import sample as K7
    from repro_torch.kernels.moe_lora import kernel as KL
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.kernels.ssm_scan import kernel as K6
    return lora_kernels() + (K6.ssm_scan, K7.sample_fused,
                             K3.flash_attention_bwd, KL.moe_lora_delta_bwd,
                             K6.ssm_scan_bwd, K11.ssd_scan,
                             K11.ssd_scan_bwd)


def phase_serve_ssm(torch):
    """SLM-only serving of the full-width falcon-mamba-7b: SoloEngine over
    an SLM-only ServingDeployment, the four demo prompts and the
    1,536-token one, 16 greedy tokens each.  Every prefill runs K6 once
    per layer; no other kernel of the port is on this path.  Then, on
    the same resident model: (a) a LoRA client step at SSM_FED_STEP
    against the plain step on the card and (b) a kernel-only one at
    SSM_FED_LONG_STEP (``fed_client_step``: K6 and K10 once, K5 and K9
    four times a layer); (c) ``serve_ssm_lora``.  Returns the serving
    launches, a summary and {"a", "b", path: launches} of the rest."""
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.ssm_scan import kernel as K6
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import SoloEngine

    cfg = get_config("falcon-mamba-7b")
    prompts = list(DEMO_PROMPTS) + [SSM_LONG_PROMPT]
    lens = [len(TOK.encode(p + " ")) for p in prompts]
    if lens[-1] != SSM_LONG_TOKENS or max(lens[:-1]) > 128:
        raise SystemExit(f"serve_ssm: prompt lengths {lens}")
    t0 = time.perf_counter()
    lm = LM(cfg)
    dep = ServingDeployment(lm, lm.init(7), max_seq=SSM_MAX_SEQ)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(dep.slm_params))
    print(f"serve_ssm: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, vocab "
          f"{cfg.vocab_size}, {n_params} parameters) initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng = SoloEngine(deployment=dep)
    prefill_ms = []
    calls = counted(dep, ("slm_prefill", "slm_decode"))
    timed = dep.slm_prefill

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = timed(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out
    dep.slm_prefill = prefill
    kernels = all_kernels()
    for fn in kernels:
        fn.launches = 0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds():
        outs = [eng.generate(p, 16) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    uncounted(dep, calls)

    ids = [[int(i) for i in o.split(",") if i] for o in outs]
    for n, (p, got) in enumerate(zip(lens, ids)):
        print(f"[{n}] prompt {p} tokens, prefill {prefill_ms[n]:.2f} ms, "
              f"ids={got}")
    tokens = sum(len(i) for i in ids)
    decode_s = wall - sum(prefill_ms) / 1e3
    print(f"serve_ssm: {tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} "
          f"tokens/s (5 requests, one at a time, prefill included); decode "
          f"{calls['slm_decode']} steps in {decode_s:.3f} s = "
          f"{calls['slm_decode'] / decode_s:.2f} steps/s; prefill of the "
          f"{SSM_LONG_TOKENS}-token prompt {prefill_ms[-1]:.2f} ms; peak "
          f"memory {peak:.2f} GiB; launches {launches}")
    if any(not 0 < len(i) <= 16 for i in ids) or calls["slm_prefill"] != 5:
        raise SystemExit(f"serve_ssm: bad output {ids}")
    if launches["ssm_scan"] != cfg.num_layers * calls["slm_prefill"] or \
            any(n for k, n in launches.items() if k != "ssm_scan"):
        raise SystemExit(f"serve_ssm: K6 must launch once per prefill "
                         f"layer and nothing else: {launches}")
    # the full-width prefill through K6 against the same prefill through
    # the plain scan.  At the reference's init law the projections add
    # little to the residual stream, so greedy ids follow the last token
    # and the logits hardly see the scan; every layer's final scan state
    # (the cache's "h", f32) does.  Limit 1e-2 for both: a layer's bf16
    # output may round apart by an ulp and feed the next layer
    toks = dep.tokens(TOK.encode(DEMO_PROMPTS[0] + " "))
    logits, cache = dep.slm_prefill(dep.slm_params, toks)
    scan, SSM.ssm_scan = SSM.ssm_scan, K6.ssm_scan_plain
    try:
        ref, ref_cache = dep.slm_prefill(dep.slm_params, toks)
    finally:
        SSM.ssm_scan = scan
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    h, rh = cache["h"], ref_cache["h"]
    h_rel = ((h - rh).abs().amax((1, 2, 3))
             / rh.abs().amax((1, 2, 3))).max().item()
    print(f"serve_ssm: full-width prefill of a {toks.shape[1]}-token prompt, "
          f"K6 vs the plain scan: logits max|diff|/max|ref| = {rel:.3e}; "
          f"final scan states, worst layer's max|diff|/max|ref| = "
          f"{h_rel:.3e}")
    if logits.shape != (1, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or not rel <= LOGITS_TOL \
            or not h_rel <= LOGITS_TOL:
        raise SystemExit("serve_ssm: the prefill disagrees with the plain "
                         "scan")
    traced = retaken("trace_solo",
                     lambda: trace_solo(torch, eng, SSM_LONG_PROMPT))
    del eng
    t0 = time.perf_counter()
    adapter = threefry_adapter(torch, lm)
    train = {"a": fed_client_step(torch, lm, dep.slm_params,
                                  "serve_ssm (a)", *SSM_FED_STEP,
                                  (FED_SSM_LOSS_RTOL, FED_SSM_GRAD_RTOL),
                                  scan_rtol=FED_SSM_SCAN_RTOL,
                                  bf16_bound=SSM_BF16_BOUND_LEAVES,
                                  adapter=adapter),
             "b": fed_client_step(torch, lm, dep.slm_params,
                                  "serve_ssm (b)", *SSM_FED_LONG_STEP,
                                  None, adapter=adapter)}
    del adapter
    gc.collect()
    torch.cuda.empty_cache()
    train.update(serve_ssm_lora(torch, dep, ids[:len(DEMO_PROMPTS)]))
    print(f"serve_ssm (a)-(c): {time.perf_counter() - t0:.1f} s")
    return launches, dict(wall_s=wall, tokens=tokens, peak_gib=peak,
                          prefill_long_ms=prefill_ms[-1],
                          decode_steps_per_s=calls["slm_decode"] / decode_s,
                          **traced), train


class StepLog:
    """Within the block, every ``slm_prefill`` and ``slm_decode`` call of
    ``dep`` is logged as (kind, args, logits) for ``replay_plain`` (an
    instance attribute shadowing each entry point, ``counted``'s included,
    which is put back on exit)."""

    NAMES = ("slm_prefill", "slm_decode")

    def __init__(self, dep):
        self.dep, self.calls, self.prev = dep, [], {}

    def __enter__(self):
        for name in self.NAMES:
            self.prev[name] = self.dep.__dict__.get(name)
            fn = getattr(self.dep, name)

            def run(*a, _fn=fn, _kind=name[4:]):
                out = _fn(*a)
                self.calls.append((_kind, a, out[0]))
                return out
            setattr(self.dep, name, run)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.prev.items():
            if fn is None:
                delattr(self.dep, name)
            else:
                setattr(self.dep, name, fn)


@contextlib.contextmanager
def swapped(swaps):
    """``swaps`` ((module, name, fn) triples) in place for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, fn in swaps:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def replay_plain(torch, dep, log, swaps, tag):
    """Replay a ``StepLog`` of SoloEngine requests under ``swaps`` (the
    kernels' plain versions): each request's prefill with its own
    tokens, LoRA and gates, then its decode steps on the replay's own
    cache.  Each step's logits are held to the logged ones within
    GRANITE_LOGITS_TOL (max|diff| / max|ref|), and the kernel run's pick
    (its argmax) must be the plain run's, or lie within the two runs'
    distance at that step of the plain run's pick (a near-tie).
    Returns a summary."""
    dist, equal, ties = [], 0, []
    cache = None
    with swapped(swaps):
        for kind, args, lk in log:
            if kind == "prefill":
                lp, cache = dep.slm_prefill(*args)
            else:
                lp, cache = dep.slm_decode(args[0], cache, *args[2:])
            lk, lp = lk[0, 0].float(), lp[0, 0].float()
            gap = (lk - lp).abs().max().item()
            dist.append(gap / lp.abs().max().item())
            top, pick = int(torch.argmax(lp)), int(torch.argmax(lk))
            if top == pick:
                equal += 1
            else:
                ties.append(((lp[top] - lp[pick]).item(), gap))
    out = dict(steps=len(log), ids_equal=equal, near_ties=ties,
               logits_rel_max=max(dist),
               logits_rel_median=sorted(dist)[len(dist) // 2])
    print(f"{tag} held to its kernels' plain versions (a replay of every "
          f"step on the same inputs): {out}")
    if not out["logits_rel_max"] <= GRANITE_LOGITS_TOL \
            or any(not m <= g for m, g in ties):
        raise SystemExit(f"{tag}: the run disagrees with the same run "
                         f"through the kernels' plain versions: {out}")
    return out


@contextlib.contextmanager
def held_calls(targets):
    """Within the block every call of ``targets`` ((module, name, plain
    version, measure) tuples) runs unchanged, its kernel launching and
    counting, and is held on its own inputs against its plain version:
    yields {name: [measure(out, ref), ...]}."""
    errs = {name: [] for _, name, _, _ in targets}
    wrapped = []
    for mod, name, plain, measure in targets:
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _plain=plain, _m=measure, _name=name, **kw):
            out = _fn(*a, **kw)
            errs[_name].append(_m(out, _plain(*a, **kw)))
            return out
        wrapped.append((mod, name, run))
    with swapped(wrapped):
        yield errs


def serve_ssm_lora(torch, dep, plain_ids, tag="serve_ssm", scans=None,
                   hold=False, b_scale=LORA_B_SCALE):
    """serve_ssm (c): SoloEngine on the full-width falcon-mamba-7b with
    four users' adapters (random B, rank 16) over 4 slots (K5 gate rows
    at prefill, K4 slot ids at decode), then with a router-gated
    4-expert bank (K5 at both): the four demo prompts, SOLO_LORA_TOKENS
    greedy tokens each, one user a prompt.  K4 and
    K5 launch 4 x 64 times (four targets a layer) per decode or prefill
    layer pass as the path says; the adapters move every request off the
    adapter-free ids (``plain_ids``).  serve_zamba2 runs the same on
    zamba2-7b (``tag``; ``scans``: each prefill kernel's launches a
    prefill, K6's 64 by default).  With ``hold`` (serve_granite) each
    run is also replayed with K3, K4 and K5 swapped for their plain
    versions (``replay_plain``), and its first request served once more
    (SOLO_HELD_TOKENS) with every K3, K4 and K5 call held on its own
    inputs (``held_calls``);
    ``b_scale``: the adapters' B std.  Returns {path: launches}."""
    from repro_torch.core import lora as LORA
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.moe_lora import kernel as KL
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import SoloEngine

    lm, params = dep.slm, dep.slm_params
    ads = random_adapters(torch, lm, 4, b_scale, 90, lm.device)
    kernels = ((ATT, "flash_attention", K3.flash_attention_plain),
               (L, "moe_lora_delta", KL.moe_lora_delta_plain),
               (L, "moe_lora_delta_slots", KL.moe_lora_delta_slots_plain))
    per_pass = sum(len(t) * math.prod(d)
                   for d, t in lm.lora_layout().values())
    runs = {}
    scans = scans or {"ssm_scan": lm.cfg.num_layers}
    for path in (f"{tag}_adapters", f"{tag}_router"):
        slots = path == f"{tag}_adapters"
        if slots:
            l_dep = ServingDeployment(lm, params, max_seq=dep.max_seq,
                                      adapter_slots=4, device=dep.device)
            eng = SoloEngine(deployment=l_dep)
            for j, a in enumerate(ads):
                eng.adapters.register(f"user{j}", a)
            aids = [f"user{j}" for j in range(len(DEMO_PROMPTS))]
        else:
            l_dep = ServingDeployment(lm, params, max_seq=dep.max_seq,
                                      expert_bank=LORA.stack_adapters(ads),
                                      device=dep.device)
            eng = SoloEngine(deployment=l_dep, router=check_router(4))
            aids = [None] * len(DEMO_PROMPTS)
        calls = counted(l_dep, ("slm_prefill", "slm_decode"))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with TokenIds(), (StepLog(l_dep) if hold
                          else contextlib.nullcontext()) as log:
            outs = [eng.generate(p, SOLO_LORA_TOKENS, adapter_id=a)
                    for p, a in zip(DEMO_PROMPTS, aids)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in all_kernels()}
        uncounted(l_dep, calls)
        ids = [[int(i) for i in o.split(",") if i] for o in outs]
        moved = sum(a != b[:SOLO_LORA_TOKENS]
                    for a, b in zip(ids, plain_ids))
        tokens = sum(len(i) for i in ids)
        print(f"{path}: {tokens} tokens in {wall:.3f} s = "
              f"{tokens / wall:.2f} tokens/s; {calls}; launches "
              f"{launches}; {moved} of {len(ids)} requests moved off the "
              f"adapter-free ids; ids {ids}")
        want = {"moe_lora_delta_slots":
                per_pass * calls["slm_decode"] if slots else 0,
                "moe_lora_delta": per_pass * (
                    calls["slm_prefill"] + (0 if slots else
                                            calls["slm_decode"])),
                **{k: n * calls["slm_prefill"] for k, n in scans.items()}}
        got = {k: launches[k] for k in want}
        if got != want or moved < len(ids) \
                or any(not 0 < len(i) <= SOLO_LORA_TOKENS for i in ids):
            raise SystemExit(f"{path}: launches {got}, expected {want}; "
                             f"{moved} requests moved; ids {ids}")
        if slots:
            print(f"{path}: adapter stats {eng.adapter_stats()}")
        runs[path] = dict(launches, wall_s=wall, tokens=tokens, moved=moved)
        if hold:
            t0 = time.perf_counter()
            replay_plain(torch, l_dep, log, kernels, path)
            del log
            t1 = time.perf_counter()
            with held_calls([(m, n, f, row_rel_err)
                             for m, n, f in kernels]) as errs:
                eng.generate(DEMO_PROMPTS[0], SOLO_HELD_TOKENS,
                             adapter_id=aids[0])
            worst = {n: (len(e), max(e, default=0.0))
                     for n, e in errs.items()}
            print(f"{path}: its first request again, each kernel call "
                  f"against its plain version on its own inputs, (calls, "
                  f"worst per row): {worst}; replay {t1 - t0:.1f} s, held "
                  f"request {time.perf_counter() - t1:.1f} s")
            if not worst["flash_attention"][1] <= K3_ROW_RTOL or any(
                    not e <= LORA_ROW_RTOL for n, (_, e) in worst.items()
                    if n != "flash_attention"):
                raise SystemExit(f"{path}: a kernel call disagrees with "
                                 f"its plain version: {worst}")
        del eng, l_dep
    return runs


def phase_serve_zamba2(torch):
    """SLM-only serving of the full-width zamba2-7b (13 groups of 5
    Mamba-2 layers under one shared attention block, then 3 Mamba-2
    layers; bf16, random weights from ZAMBA2_SEED): SoloEngine over an
    SLM-only ServingDeployment, the four demo prompts and the 1,536-token
    one, 16 greedy tokens each.  Every prefill runs K11 once per Mamba-2
    layer (68) and K3 once per group (13, the shared block, windowed at
    4,096); decode is plain torch, so no other kernel is on the path.
    Then: one prefill through K11 against the same prefill through the
    plain scan (logits and every layer's final SSD state); a
    teacher-forced decode step against a prefill one token longer; a
    profile of the long request; and ``serve_ssm_lora``'s slots and
    router runs on this model.  Returns the serving launches, a summary
    and {path: launches} of the LoRA runs."""
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import attention as ATT
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import SoloEngine

    cfg = get_config("zamba2-7b")
    prompts = list(DEMO_PROMPTS) + [SSM_LONG_PROMPT]
    lens = [len(TOK.encode(p + " ")) for p in prompts]
    if lens[-1] != SSM_LONG_TOKENS or max(lens[:-1]) > 256:
        raise SystemExit(f"serve_zamba2: prompt lengths {lens}")
    t0 = time.perf_counter()
    lm = LM(cfg)
    dep = ServingDeployment(lm, lm.init(ZAMBA2_SEED), max_seq=SSM_MAX_SEQ)
    torch.cuda.synchronize()
    _, n_groups, g, tail = lm._layout()
    n_ssm = n_groups * (g - 1) + tail
    n_params = sum(t.numel() for t in _leaves(dep.slm_params))
    print(f"serve_zamba2: {cfg.name} ({cfg.num_layers} layers: {n_groups} "
          f"groups of {g - 1} Mamba-2 layers and the shared block, a tail "
          f"of {tail}; d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.ssm_nheads} SSD heads of {cfg.ssm_head_dim}, N "
          f"{cfg.ssm_state}, attention {cfg.num_heads} x {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}, {n_params} parameters) initialised on "
          f"the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng = SoloEngine(deployment=dep)
    prefill_ms = []
    calls = counted(dep, ("slm_prefill", "slm_decode"))
    timed = dep.slm_prefill

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = timed(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out
    dep.slm_prefill = prefill
    gc.collect()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds():
        outs = [eng.generate(p, 16) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
    launches.update(mode_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    uncounted(dep, calls)

    ids = [[int(i) for i in o.split(",") if i] for o in outs]
    for n, (p, got) in enumerate(zip(lens, ids)):
        print(f"[{n}] prompt {p} tokens, prefill {prefill_ms[n]:.2f} ms, "
              f"ids={got}")
    tokens = sum(len(i) for i in ids)
    decode_s = wall - sum(prefill_ms) / 1e3
    print(f"serve_zamba2: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s (5 requests, one at a time, prefill "
          f"included); decode {calls['slm_decode']} steps in "
          f"{decode_s:.3f} s = {calls['slm_decode'] / decode_s:.2f} steps/s; "
          f"prefill of the {SSM_LONG_TOKENS}-token prompt "
          f"{prefill_ms[-1]:.2f} ms; peak memory {peak:.2f} GiB; launches "
          f"{launches}")
    pre = calls["slm_prefill"]
    want = {"ssd_scan": n_ssm * pre, "flash_attention": n_groups * pre,
            "flash_attention_windowed": n_groups * pre}
    if any(not 0 < len(i) <= 16 for i in ids) or pre != 5:
        raise SystemExit(f"serve_zamba2: bad output {ids}")
    if any(launches[k] != n for k, n in want.items()) or any(
            n for k, n in launches.items() if k not in want):
        raise SystemExit(f"serve_zamba2: K11 must launch {n_ssm} and K3 "
                         f"{n_groups} times a prefill and nothing else: "
                         f"{launches}")
    # one full-width prefill through K11 against the same prefill through
    # the plain scan: the logits and every Mamba-2 layer's final SSD state
    # (the cache's "h", f32); 1e-2 for both, a layer's bf16 output may
    # round apart by an ulp and feed the next layer
    toks = dep.tokens(TOK.encode(DEMO_PROMPTS[0] + " "))
    logits, cache = dep.slm_prefill(dep.slm_params, toks)
    scan, SSM.ssd_scan = SSM.ssd_scan, K11.ssd_scan_plain
    try:
        ref, ref_cache = dep.slm_prefill(dep.slm_params, toks)
    finally:
        SSM.ssd_scan = scan

    def states(c):
        return torch.cat([c[k]["h"].flatten(0, -5).flatten(1)
                          for k in ("inner", "tail")])
    h, rh = states(cache), states(ref_cache)
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    h_rel = ((h - rh).abs().amax(1) / rh.abs().amax(1)).max().item()
    # teacher forcing: a prefill of n - 1 tokens and one decode step
    # against a prefill of all n (K3 and K11 against the plain decode),
    # then the same with both prefills through the plain versions
    forced = TOK.encode(DEMO_PROMPTS[1] + " ")

    def teacher_forced():
        full, _ = dep.slm_prefill(dep.slm_params, dep.tokens(forced))
        _, c = dep.slm_prefill(dep.slm_params, dep.tokens(forced[:-1]))
        step, _ = dep.slm_decode(dep.slm_params, c, dep.tokens(forced[-1:]))
        return ((step - full).abs().max() / full.abs().max()).item()
    tf_rel = teacher_forced()
    scan, attn = SSM.ssd_scan, ATT.flash_attention
    SSM.ssd_scan = K11.ssd_scan_plain
    ATT.flash_attention = K3.flash_attention_plain
    try:
        tf_plain = teacher_forced()
    finally:
        SSM.ssd_scan, ATT.flash_attention = scan, attn
    print(f"serve_zamba2: full-width prefill of a {toks.shape[1]}-token "
          f"prompt, K11 vs the plain scan: logits max|diff|/max|ref| = "
          f"{rel:.3e}; final SSD states of {h.shape[0]} layers, worst "
          f"layer's max|diff|/max|ref| = {h_rel:.3e}; teacher-forced decode "
          f"of token {len(forced)} vs a {len(forced)}-token prefill: "
          f"{tf_rel:.3e} (through the plain versions {tf_plain:.3e})")
    if logits.shape != (1, 1, cfg.vocab_size) or h.shape[0] != n_ssm \
            or not torch.isfinite(logits).all() \
            or not rel <= LOGITS_TOL or not h_rel <= LOGITS_TOL \
            or not (tf_rel <= LOGITS_TOL
                    or (tf_rel <= FORCED_RATIO * tf_plain
                        and tf_plain <= FORCED_CEIL)):
        raise SystemExit("serve_zamba2: the prefill disagrees with the "
                         "plain scan, or decode with prefill")
    del cache, ref_cache, h, rh
    traced = retaken("trace_solo", lambda: trace_solo(
        torch, eng, SSM_LONG_PROMPT,
        {"k11": "ssd_scan", "k3": "flash_attention"}))
    del eng
    gc.collect()
    t0 = time.perf_counter()
    lora = serve_ssm_lora(torch, dep, ids[:len(DEMO_PROMPTS)],
                          "serve_zamba2",
                          {"ssd_scan": n_ssm, "flash_attention": n_groups})
    print(f"serve_zamba2 adapters and router: "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    adapter = threefry_adapter(torch, lm)
    leaves = tuple(f"{stack}.{tgt}.{ab}"
                   for stack, (_, tgts) in lm.lora_layout().items()
                   for tgt in tgts for ab in "AB")
    train = {"d": fed_client_step(torch, lm, dep.slm_params,
                                  "serve_zamba2 (d)", *SSM_FED_STEP,
                                  (FED_SSM_LOSS_RTOL, FED_SSM_GRAD_RTOL),
                                  scan_f32_ratio=ZAMBA2_SCAN_F32_RATIO,
                                  other_f32_ratio=ZAMBA2_OTHER_F32_RATIO,
                                  bf16_bound=leaves, adapter=adapter),
             "e": fed_client_step(torch, lm, dep.slm_params,
                                  "serve_zamba2 (e)", *ZAMBA2_FED_LONG_STEP,
                                  None, adapter=adapter)}
    del adapter
    gc.collect()
    torch.cuda.empty_cache()
    train["f"] = serve_zamba2_packed(torch, dep, n_ssm, n_groups)
    print(f"serve_zamba2 (d)-(f): {time.perf_counter() - t0:.1f} s")
    return launches, dict(wall_s=wall, tokens=tokens, peak_gib=peak,
                          params=n_params, prefill_long_ms=prefill_ms[-1],
                          decode_steps_per_s=calls["slm_decode"] / decode_s,
                          logits_rel=rel, h_rel=h_rel, forced_rel=tf_rel,
                          forced_plain_rel=tf_plain,
                          **traced), lora, train


def serve_zamba2_packed(torch, dep, n_ssm, n_groups):
    """serve_zamba2 (f): one packed prefill (``LM.prefill_packed``) of
    the four demo prompts, right-padded to the longest, on the
    full-width zamba2-7b: K11 once a Mamba-2 layer and K3 (windowed)
    once a group for the whole batch, no other kernel, "pos" the rows'
    lengths.  Every K11 and K3 call of that prefill is held, on the
    inputs the path gave it (B = 4 ragged rows), to its plain version:
    K11's y per (row, head) and its final state within K11_H_RTOL, K3
    per row within K3_ROW_RTOL.  Each row's
    last-valid-token logits against its own B = 1 prefill: in float32
    through the plain versions within LOGITS_TOL, and in bf16 through the
    kernels within FORCED_RATIO times the bf16 B = 1 prefill's distance
    from the float32 one (see the constants).  Returns the launches and
    the gaps."""
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import attention as ATT
    from repro_torch.models import ssm as SSM

    lm, params = dep.slm, dep.slm_params
    rows = [TOK.encode(p + " ") for p in DEMO_PROMPTS]
    lengths = [len(r) for r in rows]
    toks = torch.full((len(rows), max(lengths)), TOK.PAD, dtype=torch.int64,
                      device=lm.device)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = torch.tensor(r, device=lm.device)

    def packed_prefill():
        """(packed rows' logits, pos, ms, launches)."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed, cache = lm.prefill_packed(params, toks, lengths, dep.max_seq)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {fn.__name__: fn.launches for fn in all_kernels()}
        launches.update(mode_counts())
        return packed[:, 0], cache["pos"].tolist(), ms, launches

    def own():
        return [lm.prefill(params, toks[i:i + 1, :n], dep.max_seq)[0][0]
                for i, n in enumerate(lengths)]
    with captured(SSM, "ssd_scan") as scans, \
            captured(ATT, "flash_attention") as attns:
        packed, pos, ms, launches = packed_prefill()
    k_own = own()
    scan_rel = [(head_rel_err(y, ry), share_of_max(h, rh))
                for args, kw, (y, h) in scans
                for ry, rh in [K11.ssd_scan_plain(*args, **kw)]]
    attn_rel = [row_rel_err(out, K3.flash_attention_plain(*args, **kw))
                for args, kw, out in attns]
    del scans, attns
    scan, attn = SSM.ssd_scan, ATT.flash_attention
    SSM.ssd_scan, ATT.flash_attention = (K11.ssd_scan_plain,
                                         K3.flash_attention_plain)
    try:
        with float32_params(torch, params):
            f_packed, f_pos, _, _ = packed_prefill()
            f_own = own()
    finally:
        SSM.ssd_scan, ATT.flash_attention = scan, attn
    n = len(rows)
    gap = [share_of_max(packed[i], k_own[i]) for i in range(n)]
    f32_gap = [share_of_max(f_packed[i], f_own[i]) for i in range(n)]
    bf16_err = [share_of_max(k_own[i], f_own[i]) for i in range(n)]
    kernel_rel = dict(k11_y=max(r[0] for r in scan_rel),
                      k11_h=max(r[1] for r in scan_rel),
                      k3=max(attn_rel))
    print(f"serve_zamba2 (f) packed prefill of {n} rows of {lengths} tokens "
          f"(Lpad {max(lengths)}): {ms:.2f} ms; its {len(scan_rel)} K11 and "
          f"{len(attn_rel)} K3 calls against their plain versions on the "
          f"same inputs, worst: {kernel_rel}; each row's logits against "
          f"its own B = 1 prefill, max|diff|/max|ref|: float32 (plain "
          f"versions) {f32_gap}, bf16 (kernels) {gap}, against the bf16 "
          f"B = 1 prefill's distance from float32 {bf16_err}; pos {pos}; "
          f"launches {launches}")
    want = {"ssd_scan": n_ssm, "flash_attention": n_groups,
            "flash_attention_windowed": n_groups}
    if any(launches[k] != c for k, c in want.items()) or any(
            c for k, c in launches.items() if k not in want) \
            or (len(scan_rel), len(attn_rel)) != (n_ssm, n_groups):
        raise SystemExit(f"serve_zamba2 (f): K11 must launch {n_ssm} and "
                         f"K3 {n_groups} times and nothing else: "
                         f"{launches}")
    if packed.shape != (n, lm.cfg.vocab_size) \
            or not torch.isfinite(packed).all() or pos != lengths \
            or f_pos != lengths or not kernel_rel["k11_y"] <= K11_H_RTOL \
            or not kernel_rel["k11_h"] <= K11_H_RTOL \
            or not kernel_rel["k3"] <= K3_ROW_RTOL \
            or not max(f32_gap) <= LOGITS_TOL \
            or not all(g <= FORCED_RATIO * e for g, e in zip(gap, bf16_err)):
        raise SystemExit("serve_zamba2 (f): the packed prefill's kernels "
                         "disagree with their plain versions, or its rows "
                         "with their own prefills")
    return dict(launches, ms=ms, rows=lengths, kernels_rel=kernel_rel,
                logits_rel=gap, f32_logits_rel=f32_gap, bf16_to_f32=bf16_err)


def phase_serve_granite(torch):
    """SLM-only serving and a client step of the full-width
    granite-moe-3b-a800m (the MoE family: 32 layers of GQA attention, H
    24 over KV 8 at head_dim 64, each with a 40-expert top-8 MoE FFN at
    capacity factor 1.25; ~3.4 B parameters, bf16, random weights from
    GRANITE_SEED) on one deployment:
    (a) SoloEngine serves the four demo prompts and the 1,536-token one,
    16 greedy tokens each: K3 32 times a prefill and no other kernel (the
    MoE's dispatch, expert products and combine and every decode step are
    plain torch); each prefill's dropped assignments are counted; every
    step is then replayed with K3 swapped for its plain version
    (``replay_plain``); the long prompt's prefill runs once more through
    K3, each call held on its own inputs (``held_calls``), and through
    the plain version, to count each layer's route flips; a profile of
    the long request.  (b) serve_ssm (c)'s slots and router runs, each
    replayed with K3, K4 and K5 swapped and its first request held call
    by call.  (c) a 4 x 40 LoRA client step (``fed_client_step``, the
    aux loss at 0.01 included) through K3/K8 (32) and K5/K9 (128): the
    loss and every LoRA leaf held to a float32 step.  Returns (serving
    launches, a summary, {path: launches} of (b), (c)'s result)."""
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import attention as ATT
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import SoloEngine

    cfg = get_config("granite-moe-3b-a800m")
    prompts = list(DEMO_PROMPTS) + [SSM_LONG_PROMPT]
    lens = [len(TOK.encode(p + " ")) for p in prompts]
    t0 = time.perf_counter()
    marks = [("init", t0)]

    def lap(part):
        marks.append((part, time.perf_counter()))
    lm = LM(cfg)
    dep = ServingDeployment(lm, lm.init(GRANITE_SEED), max_seq=SSM_MAX_SEQ)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(dep.slm_params))
    print(f"serve_granite: {cfg.name} ({cfg.num_layers} layers; d_model "
          f"{cfg.d_model}, attention {cfg.num_heads} over "
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, {cfg.num_experts} "
          f"experts top-{cfg.experts_per_token} of FFN {cfg.moe_d_ff}, "
          f"capacity factor {cfg.capacity_factor}, vocab {cfg.vocab_size}, "
          f"{n_params} parameters) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"the expert bmms in bf16 with allow_bf16_reduced_precision_"
          f"reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    eng = SoloEngine(deployment=dep)
    prefill_ms, drops = [], []
    calls = counted(dep, ("slm_prefill", "slm_decode"))
    timed = dep.slm_prefill

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with MOE.record_drops() as d:
            out = timed(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        drops.append(int(sum(d)))
        return out
    dep.slm_prefill = prefill
    gc.collect()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lap("setup")
    with TokenIds(), StepLog(dep) as log:
        outs = [eng.generate(p, 16) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
    launches.update(mode_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    uncounted(dep, calls)

    ids = [[int(i) for i in o.split(",") if i] for o in outs]
    k = cfg.experts_per_token * cfg.num_layers
    for n, (p, got) in enumerate(zip(lens, ids)):
        print(f"[{n}] prompt {p} tokens, prefill {prefill_ms[n]:.2f} ms, "
              f"{drops[n]} of {p * k} assignments dropped, ids={got}")
    tokens = sum(len(i) for i in ids)
    decode_s = wall - sum(prefill_ms) / 1e3
    print(f"serve_granite: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s (5 requests, one at a time, prefill "
          f"included); decode {calls['slm_decode']} steps in "
          f"{decode_s:.3f} s = {calls['slm_decode'] / decode_s:.2f} steps/s; "
          f"prefill of the {SSM_LONG_TOKENS}-token prompt "
          f"{prefill_ms[-1]:.2f} ms; peak memory {peak:.2f} GiB; launches "
          f"{launches}")
    pre = calls["slm_prefill"]
    want = {"flash_attention": cfg.num_layers * pre}
    if any(not 0 < len(i) <= 16 for i in ids) or pre != 5 \
            or lens[-1] != SSM_LONG_TOKENS:
        raise SystemExit(f"serve_granite: bad output {ids}")
    if any(launches[k] != n for k, n in want.items()) or any(
            n for k, n in launches.items() if k not in want):
        raise SystemExit(f"serve_granite: K3 must launch {want} times and "
                         f"nothing else: {launches}")
    k3_plain = ((ATT, "flash_attention", K3.flash_attention_plain),)
    lap("serve")
    held = replay_plain(torch, dep, log, k3_plain, "serve_granite (a)")
    del log
    lap("replay")
    # the long prompt once more through K3, each call held on its own
    # inputs, then through its plain version: each layer's route flips
    toks = dep.tokens(TOK.encode(SSM_LONG_PROMPT + " "))
    with held_calls([k3_plain[0] + (row_rel_err,)]) as errs, \
            captured(MOE, "router") as routes:
        logits, _ = dep.slm_prefill(dep.slm_params, toks)
    with swapped(k3_plain), captured(MOE, "router") as p_routes:
        ref, _ = dep.slm_prefill(dep.slm_params, toks)
    flips = [int((a[2][0].sort(-1).values != b[2][0].sort(-1).values)
                 .any(-1).sum()) for a, b in zip(routes, p_routes)]
    del routes, p_routes
    k3_rel = max(errs["flash_attention"])
    rel = share_of_max(logits, ref)
    print(f"serve_granite: the {SSM_LONG_TOKENS}-token prefill's "
          f"{len(errs['flash_attention'])} K3 calls against the plain "
          f"version on their own inputs, worst per row {k3_rel:.3e}; its "
          f"logits against the same prefill through K3's plain version "
          f"{rel:.3e}; tokens (of {SSM_LONG_TOKENS}) whose experts differ, "
          f"layer by layer: {flips}")
    if logits.shape != (1, 1, cfg.vocab_size) \
            or not torch.isfinite(logits).all() \
            or len(errs["flash_attention"]) != cfg.num_layers \
            or not k3_rel <= K3_ROW_RTOL or not rel <= GRANITE_LOGITS_TOL:
        raise SystemExit("serve_granite: K3 disagrees with its plain "
                         "version in the long prefill")
    lap("long_prefill_held")
    traced = retaken("trace_solo", lambda: trace_solo(
        torch, eng, SSM_LONG_PROMPT, {"k3": "flash_attention"}))
    del eng
    gc.collect()
    lap("trace")
    lora = serve_ssm_lora(torch, dep, ids[:len(DEMO_PROMPTS)],
                          "serve_granite",
                          {"flash_attention": cfg.num_layers}, hold=True,
                          b_scale=GRANITE_LORA_B_SCALE)
    gc.collect()
    torch.cuda.empty_cache()
    lap("adapters_router")
    leaves = tuple(f"{tgt}.{ab}" for _, tgts in lm.lora_layout().values()
                   for tgt in tgts for ab in "AB")
    train = fed_client_step(torch, lm, dep.slm_params, "serve_granite (c)",
                            FED_BATCH, FED_SEQ,
                            (FED_LOSS_RTOL, FED_GRAD_RTOL),
                            bf16_bound=leaves,
                            adapter=threefry_adapter(torch, lm),
                            loss_f32=True)
    lap("client_step")
    print("serve_granite: seconds by part "
          f"{ {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])} }")
    return launches, dict(wall_s=wall, tokens=tokens, peak_gib=peak,
                          params=n_params, prefill_long_ms=prefill_ms[-1],
                          prefill_ms=prefill_ms, dropped=drops,
                          decode_steps_per_s=calls["slm_decode"] / decode_s,
                          held=held, route_flips=flips, k3_rel=k3_rel,
                          long_logits_rel=rel, **traced), lora, train


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def trace_solo(torch, eng, prompt, names=None):
    """Device time by kernel and the device's busy share over one
    SoloEngine request (16 tokens), from ``torch.profiler`` (device
    records only, ``profiled(cpu=False)``); ``names``
    maps a tag to a kernel-name substring to count apart (K6 by
    default)."""
    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompt, 16)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = one()
    with profiled(torch, cpu=False) as prof:
        traced_ms = one()
    rows = profile_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    out = dict(trace_busy_ms=busy, trace_wall_ms=wall_ms)
    for tag, sub in (names or {"k6": "ssm_scan"}).items():
        mine = [r for r in rows if sub in r[2]]
        out[f"trace_{tag}_ms"] = sum(r[0] for r in mine)
        out[f"trace_{tag}_launches"] = sum(r[1] for r in mine)
    print(f"trace_solo: one request of 16 tokens on a "
          f"{len(prompt) + 2}-token prompt: {wall_ms:.2f} ms untraced, "
          f"{traced_ms:.2f} ms traced; device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}% of the untraced wall; "
          f"{sum(r[1] for r in rows)} kernel launches; {out}")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")
    return out


def full_pair(torch):
    """The full-width 2b pair on the card, bf16, random weights from
    seeds 0/1/2, max_seq 2048 — one deployment for both serve phases."""
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment

    scfg, lcfg = pair_configs("2b", reduced=False)
    t0 = time.perf_counter()
    slm, llm = LM(scfg), LM(lcfg)
    dep = ServingDeployment(slm, slm.init(0), llm, llm.init(1),
                            FUS.init_alignment(2, scfg.vocab_size),
                            max_seq=2048)
    torch.cuda.synchronize()
    print(f"serve: full-width pair initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return dep


def phase_serve(torch, dep):
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.scheduler import Scheduler, summarize

    slm, llm = dep.slm, dep.llm
    sched = Scheduler.from_deployment(dep)
    prompts = list(DEMO_PROMPTS) + [LONG_PROMPT]
    for p in prompts:
        sched.submit(p, max_new_tokens=16)
    kernels = (K1.fuse_logits, K3.flash_attention)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    launches.update(mode_counts())

    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms  {r.text!r}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    print(f"serve: {tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} "
          f"tokens/s (5 requests, sequential, prefill included); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}; long prompt "
          f"{len(TOK.encode(LONG_PROMPT + ' '))} tokens")

    private = {1, 3}
    for r in res:
        if (r.rid in private) != r.stats.private:
            raise SystemExit(f"privacy detector disagrees on rid {r.rid}")
        if r.stats.private and r.stats.cloud_tokens:
            raise SystemExit(f"private rid {r.rid} used the cloud")
        w = r.stats.fusion_w
        if r.stats.tokens == 0 or not all(0.0 <= x <= 1.0 for x in w) \
                or not all(math.isfinite(x) for x in r.stats.latency_ms):
            raise SystemExit(f"bad output on rid {r.rid}: {r.stats}")
    if min(launches[fn.__name__] for fn in kernels) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    toks = dep.tokens(TOK.encode(DEMO_PROMPTS[0] + " "))
    for lm, params in ((slm, dep.slm_params), (llm, dep.llm_params)):
        logits, _ = lm.prefill(params, toks, 64)
        if logits.shape != (1, 1, 256_000) or \
                not torch.isfinite(logits).all():
            raise SystemExit(f"{lm.cfg.name}: bad prefill logits")
    retaken("trace", lambda: trace(torch, sched.engine))
    return launches


def phase_serve_batched(torch, dep):
    """Continuous batching of the full-width pair on paged lanes."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               summarize)

    sched = ContinuousBatchScheduler.from_deployment(
        dep, batch_size=8, macro_k=0, lazy_pages=True)
    eng = sched.engine
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    # count the lanes' decode dispatches: K2 must launch once per decode
    # layer of every one of them
    calls = {"slm": 0, "llm": 0}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run
    dep.slm_decode = counted("slm", dep.slm_decode)
    dep.llm_decode = counted("llm", dep.llm_decode)
    kernels = (K1.fuse_logits, K2.paged_decode_attention, K3.flash_attention)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds(), AdmissionGroups() as groups:
        res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
    launches.update(mode_counts())
    del dep.slm_decode, dep.llm_decode          # back to the methods

    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms "
              f"wait={r.queue_wait_seconds * 1e3:.0f}ms ids={r.text[:48]}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    RATES["serve_batched (macro_k=0)"] = tokens / wall
    layer_steps = (calls["slm"] * dep.slm.cfg.num_layers
                   + calls["llm"] * dep.llm.cfg.num_layers)
    print(f"serve_batched: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s ({len(res)} requests, batch 8, "
          f"macro_k=0, prefill included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; KV pool "
          f"{eng.kv_pool_bytes()} B; growth {eng.growth_stats()}; "
          f"launches {launches}; decode dispatches {calls} = "
          f"{layer_steps} decode layer-steps")

    private = {i for i, (p, _) in enumerate(BATCHED_REQUESTS)
               if eng.detector.detect(p)}
    if len(private) != 4 or {r.rid for r in res if r.stats.private} \
            != private:
        raise SystemExit(f"privacy split is wrong: {private}")
    for r, (_, n) in zip(res, BATCHED_REQUESTS):
        if r.stats.private and (r.stats.cloud_tokens or r.stats.cloud_calls):
            raise SystemExit(f"private rid {r.rid} used the cloud")
        w = r.stats.fusion_w
        if r.error or r.stats.tokens == 0 or r.stats.tokens > n \
                or not all(0.0 <= x <= 1.0 for x in w) \
                or not all(math.isfinite(x) for x in r.stats.latency_ms):
            raise SystemExit(f"bad output on rid {r.rid}: {r.stats}")
    if eng.growth_stats()["grown_pages"] <= 0:
        raise SystemExit("lazy growth never fired")
    if min(launches[fn.__name__] for fn in kernels) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if launches["sample_fused"] != 0:
        raise SystemExit("greedy traffic launched the sampler (K7)")
    if launches["paged_decode_attention"] != layer_steps:
        raise SystemExit(f"K2 launched {launches['paged_decode_attention']} "
                         f"times for {layer_steps} decode layer-steps")
    if eng.resident_kv_bytes() != 0:
        raise SystemExit("pages leaked after the run")
    retaken("trace_batched", lambda: trace_batched(torch, eng), eng)
    return launches, res, groups.of_rid


class TokenIds:
    """Within the block, a finished request's ``text`` is its greedy
    token ids ("12,7,2"): the byte-level tokenizer drops every id past
    258, which is most of a 256,000-entry vocabulary, so the decoded
    text alone cannot tell two token streams apart."""

    def __enter__(self):
        from repro_torch.data import tokenizer as TOK
        self.tok, self.decode = TOK, TOK.decode
        TOK.decode = lambda ids: ",".join(str(int(i)) for i in ids)

    def __exit__(self, *exc):
        self.tok.decode = self.decode


class AdmissionGroups:
    """Within the block, records each lane admission burst (the rids
    prefilled together); ``of_rid`` maps a rid to its burst.  Two runs
    of the same requests that admit a request in the same burst prefill
    it at the same padded shape."""

    def __enter__(self):
        from repro_torch.serving import engine as E
        self.lane_cls, self.admit = E._Lane, E._Lane.admit_many
        self.of_rid = {}

        def admit_many(lane, jobs):
            for j in jobs:
                self.of_rid[j.rid] = tuple(x.rid for x in jobs)
            return self.admit(lane, jobs)
        E._Lane.admit_many = admit_many
        return self

    def __exit__(self, *exc):
        self.lane_cls.admit_many = self.admit


def lane_layers(lane) -> int:
    """Decode layers one token of ``lane`` runs: the SLM's, and the
    LLM's on the cloud lane."""
    dep = lane.eng.dep
    return dep.slm.cfg.num_layers + (dep.llm.cfg.num_layers
                                     if lane.use_cloud else 0)


def macro_replays(eng):
    """Graph replays so far, per lane (cloud, edge)."""
    return [lane._macro.replays if lane._macro is not None else 0
            for lane in (eng.cloud_lane, eng.edge_lane)]


def same_response(a, b) -> bool:
    """Token ids, counts, latencies and fusion weights bit for bit."""
    return (a.text, a.stats.private, a.stats.tokens, a.stats.cloud_tokens,
            a.stats.fallback_tokens, a.stats.cloud_calls,
            a.stats.latency_ms, a.stats.fusion_w) == (
        b.text, b.stats.private, b.stats.tokens, b.stats.cloud_tokens,
        b.stats.fallback_tokens, b.stats.cloud_calls, b.stats.latency_ms,
        b.stats.fusion_w)


class NoSyncAdmission:
    """Within the block, ``eng.add_requests`` runs under CUDA's sync
    debug mode "error" whenever a macro step is in flight, so an
    admission that would wait for the device raises; ``overlapped``
    counts those admissions."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.overlapped = torch, eng, 0

    def __enter__(self):
        torch, eng, add = self.torch, self.eng, self.eng.add_requests

        def guarded(reqs):
            if all(lane._inflight is None
                   for lane in (eng.cloud_lane, eng.edge_lane)):
                return add(reqs)
            self.overlapped += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return add(reqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        eng.add_requests = guarded
        return self

    def __exit__(self, *exc):
        del self.eng.add_requests


def serve_macro_run(torch, eng, requests, dep, names=(), aids=None,
                    first=None):
    """The requests ((prompt, budget) or (prompt, budget, greedy, seed))
    through ContinuousBatchScheduler on ``eng`` twice: once untimed,
    which captures each lane's CUDA graphs (inside the context manager
    ``first``, when given), then timed with every count set to 0 just
    before (``run_counted``), admissions that overlap a macro step held
    to no host sync (``NoSyncAdmission``).  Returns (responses, wall s,
    launches, calls, peak GiB, graph replays per lane, first run s,
    admission groups)."""
    import contextlib

    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    def sched():
        sc = ContinuousBatchScheduler(eng)
        for req, aid in zip(requests, aids or [None] * len(requests)):
            p, n, greedy, seed = tuple(req) + (True, None)[len(req) - 2:]
            sc.submit(p, max_new_tokens=n, greedy=greedy, seed=seed,
                      adapter_id=aid)
        return sc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds(), first or contextlib.nullcontext():
        sched().run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    before = macro_replays(eng)
    sc = sched()
    with AdmissionGroups() as groups, NoSyncAdmission(torch, eng) as ns:
        res, wall, launches, calls, peak = run_counted(torch, sc, dep, names)
    replays = [b - a for a, b in zip(before, macro_replays(eng))]
    print(f"macro_k={eng.macro_k}: {ns.overlapped} admission calls "
          "overlapped a macro step in flight without a host sync")
    return res, wall, launches, calls, peak, replays, first_s, groups.of_rid


def phase_serve_macro(torch, dep, base, base_groups):
    """serve_batched's 20 requests at macro_k 1 and 8 on the same
    deployment, each on its own engine: the untimed first run captures
    the graphs, the timed one is read.  K = 1 admits in the per-token
    run's groups, so it must equal that run bit for bit; K = 8 must
    equal it on every request admitted in the same group (budgets of 16
    and 40 are multiples of 8, so all of them unless a row ends on EOS).
    K2 launches are held to K x decode layers x replays per lane, K1 to
    K x cloud replays.  Returns ({K: launches}, the K = 8 engine, its
    responses)."""
    out, eng, res, groups = {}, None, {}, {}
    for k in (1, 8):
        # one engine at a time: the last one's lane pools are freed
        # before the next is read
        eng = None
        out[k], eng, res[k], groups[k] = serve_macro_k(torch, dep, k, base,
                                                       base_groups)
    return out, eng, res[8], groups[8]


def serve_macro_k(torch, dep, k, base, base_groups):
    """One engine at macro_k ``k`` (see ``phase_serve_macro``): returns
    (launches, engine, responses, admission groups)."""
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.serving.engine import BatchedHybridEngine

    eng = BatchedHybridEngine(deployment=dep, batch_size=8, macro_k=k,
                              lazy_pages=True)
    res, wall, launches, _, peak, replays, first_s, groups = \
        serve_macro_run(torch, eng, BATCHED_REQUESTS, dep)
    st = eng.macro_stats()
    tag = f"serve_batched (macro_k={k})"
    print_batched(tag, res, wall, launches, {}, peak, macro_k=k)
    print(f"{tag}: first run (graph captures included) {first_s:.3f} s; "
          f"capture {st['capture_s']:.3f} s over {st['macros']} graphs; "
          f"graph replays (cloud, edge) {replays}; parked row-iterations "
          f"{st['parked_rows']}, idle lane iterations {st['idle_iters']} "
          f"over both runs; growth {eng.growth_stats()}")
    check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
    lanes = (eng.cloud_lane, eng.edge_lane)
    graphs = [lane._macro.per_replay(K2.paged_decode_attention)
              for lane in lanes]
    if graphs != [k * lane_layers(lane) for lane in lanes]:
        raise SystemExit(f"{tag}: the lane graphs hold {graphs} K2 "
                         f"launches, expected K x decode layers")
    want_k2 = sum(k * n * lane_layers(lane)
                  for n, lane in zip(replays, lanes))
    if launches["paged_decode_attention"] != want_k2 \
            or launches["fuse_logits"] != k * replays[0] \
            or min(launches[n] for n in ("fuse_logits",
                                         "paged_decode_attention",
                                         "flash_attention")) <= 0:
        raise SystemExit(f"{tag}: launches {launches}, expected K2 "
                         f"{want_k2} and K1 {k * replays[0]}")
    if eng.resident_kv_bytes() != 0:
        raise SystemExit(f"{tag}: pages leaked")
    if launches["sample_fused"] != 0 or st["sample_replays"] != 0:
        raise SystemExit(f"{tag}: greedy traffic reached the sampled graph")
    match = [base_groups[r.rid] == groups[r.rid] for r in res]
    equal = [same_response(a, b) for a, b in zip(base, res)]
    print(f"{tag}: admission groups per-token "
          f"{sorted(set(base_groups.values()))}; macro "
          f"{sorted(set(groups.values()))}; {sum(match)} of {len(res)} "
          f"requests in the same group, {sum(equal)} equal to the "
          f"per-token run bit for bit")
    if k == 1 and not all(match):
        raise SystemExit(f"{tag}: admission groups differ from the "
                         "per-token run's")
    bad = [r.rid for r, m, e in zip(res, match, equal) if m and not e]
    if bad:
        raise SystemExit(f"{tag}: requests {bad} admitted in the same "
                         "group differ from the per-token run")
    return launches, eng, res, groups


def check_k2_launches(tag, eng, launches, replays, calls=None):
    """K2 once per decode layer-step of the run: K x decode layers x
    replays per lane on the macro path, the counted decode dispatches
    x layers on the per-token path."""
    from repro_torch.kernels.paged_attention import kernel as K2
    lanes = (eng.cloud_lane, eng.edge_lane)
    k = eng.macro_k
    if k:
        graphs = [lane._macro.per_replay(K2.paged_decode_attention)
                  for lane in lanes if lane._macro is not None]
        want = sum(k * n * lane_layers(lane)
                   for n, lane in zip(replays, lanes))
    else:
        graphs = []
        want = (calls["slm_decode"] * eng.slm.cfg.num_layers
                + calls["llm_decode"] * eng.llm.cfg.num_layers)
    got = launches["paged_decode_attention"]
    if got != want or want <= 0 or any(
            g != k * lane_layers(lane) for g, lane in zip(graphs, lanes)):
        raise SystemExit(f"{tag}: K2 launched {got} times (graphs "
                         f"{graphs}), expected {want}")
    return want


def serve_run(torch, dep, k, requests, tag, n_private=4, **engine_kw):
    """``requests`` on a fresh batched engine at macro_k ``k`` (8 rows,
    lazy pages; ``engine_kw`` adds to that): ``serve_run_on``."""
    from repro_torch.serving.engine import BatchedHybridEngine

    eng = BatchedHybridEngine(deployment=dep, batch_size=8, macro_k=k,
                              lazy_pages=True, **engine_kw)
    return serve_run_on(torch, eng, dep, requests, tag, n_private=n_private)


def serve_run_on(torch, eng, dep, requests, tag, first=None, n_private=4):
    """``requests`` through ``serve_macro_run`` on ``eng`` (``first``
    around its untimed run), printed and checked as serve_batched is
    (``check_batched_responses``, K2 once per decode layer-step, no K7,
    K1 and K3 launched, no request or page left behind).  Returns
    (responses, tokens/s, launches, peak GiB, admission groups, engine,
    graph replays per lane)."""
    res, wall, launches, calls, peak, replays, first_s, groups = \
        serve_macro_run(torch, eng, requests, dep,
                        ("slm_decode", "llm_decode"), first=first)
    print_batched(tag, res, wall, launches, calls, peak,
                  macro_k=eng.macro_k)
    print(f"{tag}: first run {first_s:.3f} s; graph replays (cloud, "
          f"edge) {replays}; KV pool {eng.kv_pool_bytes()} B; growth "
          f"{eng.growth_stats()} (both runs)")
    check_batched_responses(tag, eng, res, requests, n_private)
    check_k2_launches(tag, eng, launches, replays, calls)
    if launches["sample_fused"] != 0 or min(
            launches[n] for n in ("fuse_logits", "flash_attention")) <= 0:
        raise SystemExit(f"{tag}: launches {launches}")
    left = eng.resident_kv_bytes() - (0 if eng.paged
                                      else eng.kv_pool_bytes())
    if left or eng.active_count():
        raise SystemExit(f"{tag}: pages leaked or a request was lost")
    tokens = sum(r.stats.tokens for r in res)
    return res, tokens / wall, launches, peak, groups, eng, replays


def phase_serve_dense(torch, dep, paged):
    """serve_batched's 20 requests on dense lanes (``paged=False``, the
    stacked rows that K2 reads in place as pages) at macro_k 0 and 8:
    every response equal to the paged engine's at the same K (``paged``
    {K: responses}) bit for bit: ids, counts, latencies and fusion
    weights.  Returns {K: launches}."""
    out = {}
    for k in (0, 8):
        tag = f"serve_dense (macro_k={k})"
        res, rate, launches, peak, _, eng, _ = serve_run(
            torch, dep, k, BATCHED_REQUESTS, tag, paged=False)
        equal = [same_response(a, b) for a, b in zip(paged[k], res)]
        print(f"{tag}: {rate:.2f} tokens/s, peak {peak:.2f} GiB, lane KV "
              f"{eng.kv_pool_bytes()} B (dense); {sum(equal)} of "
              f"{len(res)} responses equal to the paged engine's bit for "
              f"bit")
        if not all(equal):
            raise SystemExit(f"{tag}: requests "
                             f"{[r.rid for r, e in zip(res, equal) if not e]}"
                             " differ from the paged lanes")
        out[k] = launches
        del eng
        gc.collect()
    return out


class PoolWatch:
    """The ``first`` context of a pool-pressure run: it notes the
    engine's growth counters and evictions after the untimed run, so
    that the timed run's can be told apart."""

    def __init__(self, eng):
        self.eng, self.base, self.n_evicted = eng, None, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.base = self.eng.growth_stats()
        self.n_evicted = len(self.eng.evicted_rids)

    def timed_stats(self):
        """Growth counters of the timed run alone."""
        now = self.eng.growth_stats()
        return {key: now[key] - self.base[key] for key in now}

    @property
    def evicted(self):
        """The rids evicted in the timed run."""
        return set(self.eng.evicted_rids[self.n_evicted:])


def phase_serve_pool_pressure(torch, dep):
    """serve_batched's prompts with every budget at POOL_PRESSURE_BUDGET,
    at macro_k 8 and 0, on default pools (8 x 128 pages a lane model)
    and on POOL_PRESSURE_PAGES: rows park for pages and the wedged
    cloud lane evicts and re-admits (parks > 0, evictions > 0, forced
    == 0 in the timed run).  Every response keeps the roomy run's token
    ids; a never-evicted request equals it bit for bit (parked rows keep
    their cache and logits; admissions may land in other groups, and so
    prefill at other padded shapes); an evicted one (re-prefilled
    through K3) keeps its counts and latencies and its fusion weights
    within EVICTED_W_TOL.
    Returns {K: launches} of the pressed runs."""
    from repro_torch.serving.engine import BatchedHybridEngine

    reqs = [(p, POOL_PRESSURE_BUDGET) for p, _ in BATCHED_REQUESTS]
    out = {}
    for k in (8, 0):
        tag = f"serve_pool_pressure (macro_k={k})"
        roomy, r_rate, _, r_peak, r_groups, eng, _ = serve_run(
            torch, dep, k, reqs, f"{tag}, default pools")
        default = eng.cloud_lane.pager_l.alloc.num_pages
        del eng
        gc.collect()
        pressed = BatchedHybridEngine(deployment=dep, batch_size=8,
                                      macro_k=k,
                                      pool_pages=POOL_PRESSURE_PAGES)
        watch = PoolWatch(pressed)
        res, rate, launches, peak, groups, _, _ = serve_run_on(
            torch, pressed, dep, reqs, tag, watch)
        st = watch.timed_stats()
        ids = [a.text == b.text for a, b in zip(roomy, res)]
        exact = [same_response(a, b) for a, b in zip(roomy, res)]
        same_group = [r_groups[r.rid] == groups[r.rid] for r in res]
        w_err = max((abs(x - y) for a, b in zip(roomy, res)
                     if b.rid in watch.evicted
                     for x, y in zip(a.stats.fusion_w, b.stats.fusion_w)),
                    default=0.0)
        print(f"{tag}: pool {POOL_PRESSURE_PAGES} pages a lane model "
              f"against the default {default}; {rate:.2f} tokens/s "
              f"against {r_rate:.2f} on default pools "
              f"({100 * (1 - rate / r_rate):.1f}% slower), peak "
              f"{peak:.2f} GiB against {r_peak:.2f}; growth (timed run) "
              f"{st}; evicted rids {sorted(watch.evicted)}; ids equal "
              f"{sum(ids)} of {len(res)}; bit-equal {sum(exact)} "
              f"({sum(same_group)} in the roomy run's admission group); "
              f"evicted rows' fusion weights within {w_err:.3e} of the "
              f"roomy run's (limit {EVICTED_W_TOL})")
        if st["parks"] <= 0 or st["evictions"] <= 0 or st["forced"] != 0:
            raise SystemExit(f"{tag}: growth {st}, expected parks and "
                             "evictions and no forced completion")
        if not all(ids):
            raise SystemExit(f"{tag}: token ids differ from the roomy run")
        bad = [r.rid for r, e in zip(res, exact)
               if not e and r.rid not in watch.evicted]
        if bad:
            raise SystemExit(f"{tag}: never-evicted requests {bad} differ "
                             "from the roomy run")
        for a, b in zip(roomy, res):
            if b.rid in watch.evicted and (
                    a.stats.latency_ms != b.stats.latency_ms
                    or a.stats.cloud_tokens != b.stats.cloud_tokens
                    or a.stats.tokens != b.stats.tokens):
                raise SystemExit(f"{tag}: evicted rid {b.rid} changed its "
                                 "counts or latencies")
        if w_err > EVICTED_W_TOL:
            raise SystemExit(f"{tag}: evicted rows' fusion weights off by "
                             f"{w_err}")
        out[k] = launches
        del pressed, watch
        gc.collect()
    return out


class PageWatch:
    """Within the block, samples the engine after every admission burst
    and every collect: the peak of live pages over both lanes and models
    and of ``resident_kv_bytes``; and times each admission burst on the
    device stream with CUDA events (no host sync: the events complete
    when the stream reaches them, so a burst queued behind a macro step
    in flight is timed from that step's end)."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.peak_pages = self.peak_bytes = 0
        self.events = []

    def _sample(self):
        eng = self.eng
        pages = sum(p.alloc.live_pages for lane in (eng.cloud_lane,
                                                    eng.edge_lane)
                    for p in (lane.pager_s, lane.pager_l) if p is not None)
        self.peak_pages = max(self.peak_pages, pages)
        self.peak_bytes = max(self.peak_bytes, eng.resident_kv_bytes())

    def __enter__(self):
        torch, eng = self.torch, self.eng
        add, collect = eng.add_requests, eng.collect_step

        def timed_add(reqs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = add(reqs)
            end.record()
            if any(out):
                self.events.append((start, end))
            self._sample()
            return out

        def sampled_collect():
            out = collect()
            self._sample()
            return out
        eng.add_requests, eng.collect_step = timed_add, sampled_collect
        return self

    def __exit__(self, *exc):
        for name in ("add_requests", "collect_step"):
            self.eng.__dict__.pop(name, None)
        # the engine's lane pools are freed with it, not with the watch
        self.eng = None

    def admission_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


PREFIX_CALLS = ("slm_build_prefix", "llm_build_prefix", "slm_prefill_suffix",
                "llm_prefill_suffix", "slm_prefill_chunk", "llm_prefill_chunk",
                "slm_prefill_packed", "llm_prefill_packed", "slm_decode",
                "llm_decode")


def traffic_run(torch, eng, dep, requests, tag, prefix=None, concat=False,
                n_private=4):
    """One run of ``requests`` [(prompt, budget)] through
    ContinuousBatchScheduler on ``eng``, each request behind ``prefix``
    (as ``prefix=``, or with ``concat`` written in front of its prompt),
    every count set to 0 just before it (``run_counted``) and the
    deployment's prefill and decode entry points counted, its pages
    watched (``PageWatch``); printed and checked as serve_batched is
    (``check_batched_responses``, K2 once per decode layer-step, no K7,
    K1 and K3 launched).  One run, graph captures included: its wall
    is not a steady-state rate.  Returns (responses, wall s, launches,
    calls, peak GiB, watch)."""
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    sc = ContinuousBatchScheduler(eng)
    for p, n in requests:
        if concat:
            sc.submit(prefix + p, max_new_tokens=n)
        else:
            sc.submit(p, max_new_tokens=n, prefix=prefix)
    lanes = (eng.cloud_lane, eng.edge_lane)
    before = macro_replays(eng)
    fresh = [lane._macro is None for lane in lanes]
    with PageWatch(torch, eng) as watch, NoSyncAdmission(torch, eng) as ns:
        res, wall, launches, calls, peak = run_counted(torch, sc, dep,
                                                       PREFIX_CALLS)
    replays = [b - a for a, b in zip(before, macro_replays(eng))]
    # a lane graph captured in this run first ran its body once, eagerly
    # with every row parked (``LaneMacro._capture``): K2 once a layer
    warm = sum(lane_layers(lane) for f, lane in zip(fresh, lanes)
               if f and lane._macro is not None)
    print_batched(tag, res, wall, launches, calls, peak,
                  macro_k=eng.macro_k)
    print(f"{tag}: peak live pages {watch.peak_pages}, peak resident KV "
          f"{watch.peak_bytes} B, admission {watch.admission_ms():.3f} ms "
          f"on the device stream over {len(watch.events)} bursts "
          f"({ns.overlapped} admission calls overlapped a macro step in "
          f"flight without a host sync); graph replays (cloud, edge) "
          f"{replays}, K2 launches of the captures' warm-up {warm}; "
          f"growth {eng.growth_stats()}")
    seen = [(prefix + p if prefix else p, n) for p, n in requests]
    check_batched_responses(tag, eng, res, seen, n_private)
    decode_k2 = dict(launches, paged_decode_attention=launches[
        "paged_decode_attention"] - warm)
    check_k2_launches(tag, eng, decode_k2, replays, calls)
    if launches["sample_fused"] != 0 or min(
            launches[n] for n in ("fuse_logits", "flash_attention")) <= 0:
        raise SystemExit(f"{tag}: launches {launches}")
    # K3 in its offset mode once per layer of every suffix and chunk
    # prefill (none on the packed or B=1 prefix prefills)
    want = sum(calls[f"{m}_prefill_{kind}"] * lm.cfg.num_layers
               for m, lm in (("slm", dep.slm), ("llm", dep.llm))
               for kind in ("suffix", "chunk"))
    if launches["flash_attention_offset"] != want:
        raise SystemExit(f"{tag}: K3 offset launches "
                         f"{launches['flash_attention_offset']}, expected "
                         f"{want}")
    if eng.active_count():
        raise SystemExit(f"{tag}: a request was lost")
    return res, wall, launches, calls, peak, watch


def registry_pages_at_one(tag, eng):
    """Every lane's registered prefix pages back at refcount 1 (the
    registry's own reference) once the rows drained, and nothing else
    live."""
    for lane in (eng.cloud_lane, eng.edge_lane):
        for entry in lane._prefixes.values():
            if entry is None:
                continue
            for pager, pids in ((lane.pager_s, entry["pids_s"]),
                                (lane.pager_l, entry["pids_l"])):
                if pager is None:
                    continue
                if any(pager.alloc.refcount(p) != 1 for p in pids) \
                        or pager.alloc.live_pages != len(pids):
                    raise SystemExit(f"{tag}: registry pages not at "
                                     "refcount 1 after the drain")


def compare_prefix_runs(tag, shared, unshared, w_tol=PREFIX_W_TOL):
    """A COW run against the unshared oracle: token ids, tokens, cloud
    and fallback tokens, latencies and the truncation flag equal; fusion
    weights within ``w_tol``.  Returns the largest weight gap."""
    gap = 0.0
    for a, b in zip(unshared, shared):
        if (a.text, a.stats.tokens, a.stats.cloud_tokens,
                a.stats.fallback_tokens, a.stats.latency_ms,
                a.stats.truncated) != (
                b.text, b.stats.tokens, b.stats.cloud_tokens,
                b.stats.fallback_tokens, b.stats.latency_ms,
                b.stats.truncated):
            raise SystemExit(f"{tag}: rid {a.rid} differs from the "
                             f"unshared run: {a.text} / {b.text}")
        gap = max([gap] + [abs(x - y) for x, y in zip(a.stats.fusion_w,
                                                      b.stats.fusion_w)])
    if gap > w_tol:
        raise SystemExit(f"{tag}: fusion weights {gap} off the unshared "
                         f"run's (limit {w_tol})")
    return gap


def phase_serve_prefix(torch, dep):
    """serve_batched's 20 requests behind PREAMBLE on the 2b pair at
    macro_k 8 and 0: COW-shared (``prefix=``) against the unshared
    oracle (the preamble written in front of each prompt) on paged
    lanes, and the ``prefix=`` traffic on dense lanes at K 8.  Returns
    ({path: launches}, the shared K = 8 run's launches)."""
    from repro_torch.serving.engine import BatchedHybridEngine

    out = {}
    for k in (8, 0):
        runs = {}
        for mode in ("shared", "unshared"):
            tag = f"serve_prefix (macro_k={k}, {mode})"
            eng = BatchedHybridEngine(deployment=dep, batch_size=8,
                                      macro_k=k, lazy_pages=True)
            runs[mode] = traffic_run(torch, eng, dep, BATCHED_REQUESTS, tag,
                                     PREAMBLE, concat=mode == "unshared")
            if mode == "shared":
                registry_pages_at_one(tag, eng)
            del eng
            gc.collect()
        s_res, _, s_launch, s_calls, s_peak, s_watch = runs["shared"]
        u_res, _, _, _, u_peak, u_watch = runs["unshared"]
        tag = f"serve_prefix (macro_k={k})"
        gap = compare_prefix_runs(tag, s_res, u_res)
        long_rids = [i for i, (p, _) in enumerate(BATCHED_REQUESTS)
                     if p == LONG_PROMPT]
        cut = [r.stats.truncated for res in (s_res, u_res)
               for r in res if r.rid in long_rids]
        print(f"{tag}: shared against unshared: ids, counts and latencies "
              f"equal on all {len(s_res)}; fusion weights within "
              f"{gap:.3e} (limit {PREFIX_W_TOL}); build_prefix SLM "
              f"{s_calls['slm_build_prefix']}, LLM "
              f"{s_calls['llm_build_prefix']}; peak live pages "
              f"{s_watch.peak_pages} against {u_watch.peak_pages}, peak "
              f"resident KV {s_watch.peak_bytes} B against "
              f"{u_watch.peak_bytes} B; admission "
              f"{s_watch.admission_ms():.3f} ms against "
              f"{u_watch.admission_ms():.3f} ms on the device stream; "
              f"peak memory {s_peak:.2f} GiB against {u_peak:.2f} GiB; "
              f"long prompts truncated {cut}")
        if (s_calls["slm_build_prefix"], s_calls["llm_build_prefix"]) \
                != (2, 1):
            raise SystemExit(f"{tag}: build_prefix ran "
                             f"{s_calls['slm_build_prefix']} (SLM) and "
                             f"{s_calls['llm_build_prefix']} (LLM) times, "
                             "expected once per lane model: 2 and 1")
        if not all(cut) or len(cut) != 4:
            raise SystemExit(f"{tag}: the long prompts were not truncated")
        if not s_watch.peak_pages < u_watch.peak_pages \
                or not s_watch.peak_bytes < u_watch.peak_bytes:
            raise SystemExit(f"{tag}: the shared run holds no fewer pages")
        if s_launch["flash_attention_offset"] <= 0:
            raise SystemExit(f"{tag}: K3's offset mode never launched")
        out[f"serve_prefix_k{k}" if k != 8 else "serve_prefix"] = s_launch
        out[f"serve_prefix_unshared_k{k}"] = runs["unshared"][2]
        if k == 8:
            unshared8 = u_res
    tag = "serve_prefix (macro_k=8, dense lanes)"
    eng = BatchedHybridEngine(deployment=dep, batch_size=8, macro_k=8,
                              paged=False)
    d_res, _, d_launch, d_calls, _, _ = traffic_run(
        torch, eng, dep, BATCHED_REQUESTS, tag, PREAMBLE)
    bad = [a.rid for a, b in zip(unshared8, d_res) if a.text != b.text]
    print(f"{tag}: ids equal to the unshared paged run's on "
          f"{len(d_res) - len(bad)} of {len(d_res)}; build_prefix "
          f"{d_calls['slm_build_prefix'] + d_calls['llm_build_prefix']}")
    if bad or d_calls["slm_build_prefix"] or d_calls["llm_build_prefix"]:
        raise SystemExit(f"{tag}: rids {bad} differ from the unshared "
                         "paged run, or the dense lanes shared")
    out["serve_prefix_dense"] = d_launch
    del eng
    gc.collect()
    return out


def serve_gemma3_prefix(torch, g_dep):
    """serve_prefix's traffic on the gemma3 pair at K 8: COW-shared
    against unshared, ids, counts and latencies equal (each row's ring
    gathered from [history; fresh] at its own depth); K3 windowed in its
    offset mode on the SLM's 22 local layers of every suffix prefill.
    Returns {path: launches}."""
    from repro_torch.serving.engine import BatchedHybridEngine

    runs = {}
    for mode in ("shared", "unshared"):
        tag = f"serve_gemma3_prefix (macro_k=8, {mode})"
        eng = BatchedHybridEngine(deployment=g_dep, batch_size=8, macro_k=8,
                                  lazy_pages=True)
        runs[mode] = traffic_run(torch, eng, g_dep, BATCHED_REQUESTS, tag,
                                 PREAMBLE, concat=mode == "unshared")
        if mode == "shared":
            registry_pages_at_one(tag, eng)
        del eng
        gc.collect()
    s_res, _, launches, calls, _, s_watch = runs["shared"]
    u_res, _, _, _, _, u_watch = runs["unshared"]
    tag = "serve_gemma3_prefix (macro_k=8)"
    gap = compare_prefix_runs(tag, s_res, u_res)
    n_local = gemma3_layers(g_dep.slm)[0]
    print(f"{tag}: ids, counts and latencies equal on all {len(s_res)}; "
          f"fusion weights within {gap:.3e}; peak live pages "
          f"{s_watch.peak_pages} against {u_watch.peak_pages}; K3 offset "
          f"{launches['flash_attention_offset']}, windowed "
          f"{launches['flash_attention_windowed']} ({n_local} local SLM "
          f"layers x {calls['slm_prefill_suffix']} SLM suffix prefills "
          f"in offset mode)")
    if launches["flash_attention_windowed"] < \
            n_local * calls["slm_prefill_suffix"] \
            or calls["slm_prefill_suffix"] <= 0:
        raise SystemExit(f"{tag}: the SLM's local layers skipped K3's "
                         "windowed offset mode")
    return {"serve_gemma3_prefix": launches,
            "serve_gemma3_prefix_unshared": runs["unshared"][2]}


def serve_gemma3_chunked(torch, g_dep, default):
    """serve_batched's traffic on the gemma3 pair at K 8 and chunk_width
    512: ids equal to the default width's run (``default``); each of
    the two 1,542-token prompts streams as chunk 0, two middle chunks of
    512 (no ring write) and a final one of 6 (the ring) per model.
    Returns the launches."""
    from repro_torch.serving.engine import BatchedHybridEngine

    tag = "serve_gemma3_chunked (macro_k=8, chunk_width=512)"
    eng = BatchedHybridEngine(deployment=g_dep, batch_size=8, macro_k=8,
                              lazy_pages=True, chunk_width=512)
    res, _, launches, calls, _, _ = traffic_run(torch, eng, g_dep,
                                                BATCHED_REQUESTS, tag)
    bad = [a.rid for a, b in zip(default, res) if a.text != b.text]
    n_long = sum(p == LONG_PROMPT for p, _ in BATCHED_REQUESTS)
    print(f"{tag}: ids equal to the default width's on "
          f"{len(res) - len(bad)} of {len(res)}; middle chunks (SLM, LLM) "
          f"{calls['slm_prefill_chunk']}, {calls['llm_prefill_chunk']}; "
          f"K3 offset {launches['flash_attention_offset']}")
    if bad:
        raise SystemExit(f"{tag}: rids {bad} differ from the default "
                         "chunk width")
    if (calls["slm_prefill_chunk"], calls["llm_prefill_chunk"]) \
            != (2 * n_long, 2 * n_long):
        raise SystemExit(f"{tag}: middle chunks {calls}")
    del eng
    gc.collect()
    return launches


def fault_deployment(torch, dep):
    """The 2b deployment's models and tensors (shared, not copied) on a
    link with FAULT_WEATHER."""
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.latency import FaultModel

    f_dep = ServingDeployment(dep.slm, dep.slm_params, dep.llm,
                              dep.llm_params, dep.mlp, max_seq=2048,
                              fault=FaultModel(**FAULT_WEATHER))
    if f_dep.llm_params["embed"]["tok"]["w"].data_ptr() \
            != dep.llm_params["embed"]["tok"]["w"].data_ptr():
        raise SystemExit("serve_faults holds a second copy of the LLM")
    return f_dep


def weather(r):
    """A response's status, counts, latencies, clock and fault
    accounting: what the link decides, token ids aside."""
    st = r.stats
    return (r.status.value, st.private, st.tokens, st.cloud_tokens,
            st.fallback_tokens, st.cloud_calls, st.latency_ms,
            st.degraded_tokens, st.cloud_lost, st.clock_ms)


def batched_once(torch, eng, dep, requests, deadline_ms=None):
    """``requests`` once through ContinuousBatchScheduler on ``eng``,
    counted as ``run_counted``: (responses, wall s, launches, peak GiB,
    admission groups, graph replays per lane)."""
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    sc = ContinuousBatchScheduler(eng)
    for p, n in requests:
        sc.submit(p, max_new_tokens=n, deadline_ms=deadline_ms)
    before = macro_replays(eng)
    with AdmissionGroups() as groups:
        res, wall, launches, _, peak = run_counted(torch, sc, dep, ())
    replays = [b - a for a, b in zip(before, macro_replays(eng))]
    return res, wall, launches, peak, groups.of_rid, replays


@contextlib.contextmanager
def health_mark(eng, mark):
    """Around a run: afterwards ``mark`` holds the engine's health
    counters, which a later run's count adds to."""
    yield
    mark.update(eng.health_stats())


def timed_health(eng, mark):
    """The health counters since ``health_mark``."""
    return {k: v - mark.get(k, 0) for k, v in eng.health_stats().items()}


def check_drained(tag, eng):
    if eng.active_count() or eng.resident_kv_bytes():
        raise SystemExit(f"{tag}: a request or a page was left behind")
    for lane in (eng.cloud_lane, eng.edge_lane):
        for pager in (lane.pager_s, lane.pager_l):
            if pager is not None and pager.alloc.live_pages:
                raise SystemExit(f"{tag}: {pager.alloc.live_pages} live "
                                 "pages after the run")
    if eng.adapter_stats().get("pinned"):
        raise SystemExit(f"{tag}: adapter pins left")


def phase_serve_faults(torch, dep):
    """serve_batched's 20 requests on a link with FAULT_WEATHER at
    macro_k 8, 1 and 0 (the breaker inside the K = 8 and K = 1 graphs),
    then through the sequential engine, and a deadline run at K 8 and
    0.  Every run's status, counts, latencies, degraded and lost tokens
    and clock equal the K = 0 run's request for request (the weather is
    a function of (rid, step)); ids equal where the admission groups
    match (all of them at K = 1); breaker trips and degraded tokens
    happen; the deadline cancels every row alike and leaves no live
    page.  Returns {path: launches}."""
    from repro_torch.serving.engine import BatchedHybridEngine
    from repro_torch.serving.scheduler import Scheduler

    t0 = time.perf_counter()
    f_dep = fault_deployment(torch, dep)
    runs = {}
    for k in (8, 1, 0):
        tag = f"serve_faults (macro_k={k})"
        eng = BatchedHybridEngine(deployment=f_dep, batch_size=8,
                                  macro_k=k, lazy_pages=True)
        mark = {}
        if k:
            # an untimed run first captures the graphs
            res, wall, launches, _, peak, replays, _, groups = \
                serve_macro_run(torch, eng, BATCHED_REQUESTS, f_dep,
                                first=health_mark(eng, mark))
        else:
            res, wall, launches, peak, groups, replays = batched_once(
                torch, eng, f_dep, BATCHED_REQUESTS)
        print_batched(tag, res, wall, launches, {}, peak, macro_k=k)
        health = timed_health(eng, mark)
        print(f"{tag}: link health {health}; graph replays (cloud, edge) "
              f"{replays}")
        check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
        check_drained(tag, eng)
        if k:
            graphs = [lane._macro.per_replay(K2_FN())
                      for lane in (eng.cloud_lane, eng.edge_lane)]
            want = sum(k * n * lane_layers(lane) for n, lane in zip(
                replays, (eng.cloud_lane, eng.edge_lane)))
            if launches["paged_decode_attention"] != want or graphs != [
                    k * lane_layers(lane)
                    for lane in (eng.cloud_lane, eng.edge_lane)]:
                raise SystemExit(f"{tag}: K2 {launches} (graphs {graphs}), "
                                 f"expected {want}")
        if min(launches[n] for n in ("fuse_logits", "paged_decode_attention",
                                     "flash_attention")) <= 0 \
                or launches["sample_fused"]:
            raise SystemExit(f"{tag}: launches {launches}")
        runs[k] = (res, groups, launches, health)
        del eng
        gc.collect()
    base, base_groups, _, base_health = runs[0]
    for k in (8, 1):
        res, groups, _, health = runs[k]
        match = [base_groups[r.rid] == groups[r.rid] for r in res]
        bad_w = [r.rid for a, r in zip(base, res) if weather(a) != weather(r)]
        bad_ids = [r.rid for a, r, m in zip(base, res, match)
                   if m and a.text != r.text]
        print(f"serve_faults (macro_k={k}): {sum(match)} of {len(res)} "
              f"requests in the per-token run's admission group; weather "
              f"equal on {len(res) - len(bad_w)}, ids on "
              f"{sum(a.text == r.text for a, r in zip(base, res))}")
        if bad_w or bad_ids or health != base_health \
                or (k == 1 and not all(match)):
            raise SystemExit(f"serve_faults (macro_k={k}): weather differs "
                             f"on {bad_w}, ids on {bad_ids}, health "
                             f"{health} against {base_health}")
    if base_health["breaker_trips"] < 1 or base_health["degraded_tokens"] < 1 \
            or base_health["breaker_recoveries"] < 1:
        raise SystemExit(f"serve_faults: the weather did not bite: "
                         f"{base_health}")
    # the sequential engine on the same requests: the same weather
    sched = Scheduler.from_deployment(f_dep)
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    res, wall, seq_launches, _, peak = run_counted(torch, sched, f_dep, ())
    tokens = sum(r.stats.tokens for r in res)
    bad = [r.rid for a, r in zip(base, res) if weather(a) != weather(r)]
    print(f"serve_faults (sequential): {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s; health "
          f"{sched.engine.health_stats()}; weather equal to the per-token "
          f"batched run on {len(res) - len(bad)} of {len(res)}")
    # K1 once a cloud token (a degraded one fuses with w = 1), no K2
    want_k1 = sum(r.stats.tokens for r in res if not r.stats.private)
    if bad or sched.engine.health_stats() != base_health \
            or seq_launches["fuse_logits"] != want_k1 \
            or seq_launches["paged_decode_attention"]:
        raise SystemExit(f"serve_faults (sequential): weather differs on "
                         f"{bad}, or launches {seq_launches} (K1 "
                         f"{want_k1})")
    # deadlines: every row cancels mid-request, alike at K 8 and 0
    dl = {}
    for k in (8, 0):
        tag = f"serve_faults_deadline (macro_k={k})"
        eng = BatchedHybridEngine(deployment=f_dep, batch_size=8,
                                  macro_k=k, lazy_pages=True)
        res, wall, launches, peak, groups, _ = batched_once(
            torch, eng, f_dep, BATCHED_REQUESTS,
            deadline_ms=FAULT_DEADLINE_MS)
        check_drained(tag, eng)
        cancelled = sum(r.status.value == "cancelled" for r in res)
        print(f"{tag}: {cancelled} of {len(res)} cancelled, tokens "
              f"{[r.stats.tokens for r in res]}, health "
              f"{eng.health_stats()}, {wall:.3f} s")
        if cancelled != len(res) or not all(
                0 < r.stats.tokens < n
                for r, (_, n) in zip(res, BATCHED_REQUESTS)):
            raise SystemExit(f"{tag}: not every row cancelled mid-request")
        dl[k] = res
        del eng
        gc.collect()
    bad = [r.rid for a, r in zip(dl[0], dl[8]) if weather(a) != weather(r)]
    if bad:
        raise SystemExit(f"serve_faults_deadline: K 8 and 0 differ on {bad}")
    print(f"serve_faults: {RATES['serve_faults (macro_k=8)']:.2f} tokens/s "
          f"at K 8 against {RATES['serve_batched (macro_k=8)']:.2f} "
          f"fault-free (serve_batched, this run); "
          f"{RATES['serve_faults (macro_k=0)']:.2f} at K 0 against "
          f"{RATES['serve_batched (macro_k=0)']:.2f}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"serve_faults": runs[8][2], "serve_faults_k1": runs[1][2],
            "serve_faults_k0": runs[0][2],
            "serve_faults_sequential": seq_launches}, f_dep


def K2_FN():
    from repro_torch.kernels.paged_attention import kernel as K2
    return K2.paged_decode_attention


def spec_k2_per_burst(eng, k) -> int:
    """K2 launches of one burst: k drafts and the correction decode of
    the SLM, k verify decodes of the LLM, a launch per decode layer
    each."""
    return (k + 1) * eng.slm.cfg.num_layers + k * eng.llm.cfg.num_layers


def spec_run(torch, dep, k, macro_k, base=None, base_groups=None,
             tag="serve_spec"):
    """serve_batched's 20 requests at spec_k ``k`` and ``macro_k`` on a
    fresh engine (untimed first: it captures the burst chain's graph):
    tokens/s, cloud calls per token, acceptance; the chain's graph holds
    K2 at n_bursts x ((k + 1) x SLM + k x LLM layers) and K1 at
    n_bursts x k; with ``base`` (the spec_k = 0 run at the same
    macro_k) ids and token counts equal where the admission groups
    match.  Returns (launches, engine, responses, the timed run's health
    counters)."""
    from repro_torch.kernels.logit_fusion.kernel import fuse_logits
    from repro_torch.serving.engine import BatchedHybridEngine
    from repro_torch.serving.scheduler import summarize

    tag = f"{tag} (spec_k={k}, macro_k={macro_k})"
    eng = BatchedHybridEngine(deployment=dep, batch_size=8,
                              macro_k=macro_k, spec_k=k, lazy_pages=True)
    mark = {}
    res, wall, launches, _, peak, _, first_s, groups = serve_macro_run(
        torch, eng, BATCHED_REQUESTS, dep, first=health_mark(eng, mark))
    health = timed_health(eng, mark)
    print_batched(tag, res, wall, launches, {}, peak, macro_k=macro_k)
    st = eng.spec_stats()
    summ = summarize(res)
    print(f"{tag}: cloud_calls_per_token {summ['cloud_calls_per_token']:.4f}, "
          f"accept_rate {summ['accept_rate']:.4f}, "
          f"{RATES[tag]:.2f} tokens/s; first run {first_s:.3f} s; chain "
          f"{st}; health {health}")
    check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
    check_drained(tag, eng)
    chain = eng.cloud_lane._spec_chain
    graph = (chain.per_replay(K2_FN()), chain.per_replay(fuse_logits))
    want = (chain.n_bursts * spec_k2_per_burst(eng, k), chain.n_bursts * k)
    if graph != want or launches["sample_fused"]:
        raise SystemExit(f"{tag}: the chain's graph holds (K2, K1) {graph}, "
                         f"expected {want}; launches {launches}")
    drafted = sum(r.stats.spec_drafted for r in res)
    if drafted <= 0 or any(r.stats.cloud_calls + r.stats.degraded_tokens
                           > r.stats.tokens for r in res):
        raise SystemExit(f"{tag}: no drafts, or more cloud calls than "
                         "tokens")
    if base is not None:
        match = [base_groups[r.rid] == groups[r.rid] for r in res]
        equal = [a.text == r.text and a.stats.tokens == r.stats.tokens
                 for a, r in zip(base, res)]
        calls = (sum(r.stats.cloud_calls for r in base),
                 sum(r.stats.cloud_calls for r in res))
        print(f"{tag}: {sum(match)} of {len(res)} requests in the spec_k = "
              f"0 run's admission group, {sum(equal)} with its ids; cloud "
              f"calls {calls[1]} against {calls[0]}")
        bad = [r.rid for r, m, e in zip(res, match, equal) if m and not e]
        if bad or calls[1] > calls[0]:
            raise SystemExit(f"{tag}: requests {bad} admitted in the same "
                             "group differ from the spec_k = 0 run, or it "
                             "made more cloud calls")
    return launches, eng, res, health


def profile_spec_burst(torch, eng):
    """One profiled dispatch of the spec_k engine's cloud lane alone (8
    cloud rows seeded by a first step): one graph launch; K2 at n_bursts
    x ((k + 1) x 18 + k x 28) split kernels, K1 at n_bursts x k (stats
    and write passes), by the replay-aware count and in the profile."""
    from repro_torch.kernels.logit_fusion.kernel import fuse_logits

    cloud = [p for p, _ in BATCHED_REQUESTS if not eng.detector.detect(p)]
    if not all(eng.add_requests([(p, 40, True, 700 + i)
                                 for i, p in enumerate(cloud[1:9])])):
        raise SystemExit("serve_spec: a profiled request was not admitted")
    eng.step()
    chain = eng.cloud_lane._spec_chain
    want_k2 = chain.n_bursts * spec_k2_per_burst(eng, chain.k)
    want_k1 = chain.n_bursts * chain.k
    k2_0, k1_0 = K2_FN().launches, fuse_logits.launches
    with profiled(torch) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counted = (K2_FN().launches - k2_0, fuse_logits.launches - k1_0)
    rows = profile_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    graphs = graph_launches(prof)
    k2 = sum(r[1] for r in rows if "paged_decode_split" in r[2])
    k1 = [sum(r[1] for r in rows if p in r[2])
          for p in ("fuse_stats", "fuse_write")]
    print(f"serve_spec: one profiled dispatch of {chain.n_bursts} bursts of "
          f"{chain.k}: {ms:.2f} ms traced, device busy {busy:.2f} ms; K2 "
          f"{k2} calls profiled, {counted[0]} counted (expected "
          f"{want_k2}); K1 {k1} passes, {counted[1]} counted (expected "
          f"{want_k1}); {graphs} graph launches")
    for t, n, key in rows[:10]:
        print(f"  {t:9.3f} ms  {n:6d} x  {key[:100]}")
    if k2 != want_k2 or counted != (want_k2, want_k1) \
            or k1 != [want_k1, want_k1] or graphs != 1:
        raise SystemExit(f"serve_spec: profiled burst counts are off; "
                         f"{profile_edges(torch, prof)}")
    while eng.active_count():
        eng.step()


def phase_serve_spec(torch, dep, f_dep, base):
    """Speculative decode on the 2b pair: serve_batched's 20 requests at
    spec_k SPEC_K with macro_k 8 and 0, ids held to the spec_k = 0 runs
    (``base``: {K: (responses, admission groups)}) where the admission
    groups match; the same at K 8 on FAULT_WEATHER's link; one profiled
    dispatch.  Returns {path: launches}."""
    t0 = time.perf_counter()
    out = {}
    for mk in (8, 0):
        out[f"serve_spec{'_k0' if not mk else ''}"], eng, _, _ = spec_run(
            torch, dep, SPEC_K, mk, *base[mk])
        if mk == 8:
            retaken("serve_spec", lambda: profile_spec_burst(torch, eng),
                    eng)
        del eng
        gc.collect()
    out["serve_spec_faults"], eng, res, h = spec_run(
        torch, f_dep, SPEC_K, 8, tag="serve_spec_faults")
    print(f"serve_spec_faults: degraded tokens "
          f"{sum(r.stats.degraded_tokens for r in res)}, lost "
          f"{sum(r.stats.cloud_lost for r in res)}, fallback "
          f"{sum(r.stats.fallback_tokens for r in res)}; "
          f"{RATES['serve_spec_faults (spec_k=4, macro_k=8)']:.2f} tokens/s "
          f"against {RATES['serve_faults (macro_k=8)']:.2f} per-token K 8 "
          f"on the same link")
    if h["breaker_trips"] < 1:
        raise SystemExit(f"serve_spec_faults: no breaker trip: {h}")
    del eng
    gc.collect()
    print(f"serve_spec: phase {time.perf_counter() - t0:.1f} s")
    return out


def serve_gemma3_spec(torch, g_dep, res8, groups8):
    """serve_batched's 20 requests on the gemma3 pair at spec_k SPEC_K,
    macro_k 8: ids equal to its K = 8 run where the admission groups
    match; the burst chain's graph holds K2's ring launches at n_bursts
    x (k + 1) x 22 (the SLM's local layers)."""
    t0 = time.perf_counter()
    launches, eng, _, _ = spec_run(torch, g_dep, SPEC_K, 8, res8, groups8,
                                   tag="serve_gemma3_spec")
    chain = eng.cloud_lane._spec_chain
    ring = chain.per_replay(K2_FN(), "ring_launches")
    want = chain.n_bursts * (SPEC_K + 1) * gemma3_layers(g_dep.slm)[0]
    print(f"serve_gemma3_spec: ring launches per replay {ring} (expected "
          f"{want}); phase {time.perf_counter() - t0:.1f} s")
    if ring != want:
        raise SystemExit("serve_gemma3_spec: ring launches are off")
    del eng
    gc.collect()
    return launches


def phase_serve_long(torch, dep):
    """Prompts past max_seq: ``ServingDeployment(max_seq=2048,
    max_ctx=4096)`` over the 2b deployment's parameter tensors (shared,
    not copied), LONG_REQUESTS at macro_k 8 and 0 and chunk widths
    2,048 and 512: ids equal across the runs, nothing truncated, every
    token served; the same prompts on the max_ctx = 2048 deployment are
    truncated and say so; a one-shot run on a max_seq = 4096 deployment
    over the same parameters gives the same ids at K 8.  Returns {path:
    launches}."""
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import BatchedHybridEngine

    def deployment(**kw):
        return ServingDeployment(dep.slm, dep.slm_params, dep.llm,
                                 dep.llm_params, dep.mlp, device=dep.device,
                                 **kw)
    long_dep = deployment(max_seq=2048, max_ctx=4096)
    n_long = 5
    out, ids = {}, {}
    for k, width in ((8, None), (0, None), (8, 512), (0, 512)):
        tag = f"serve_long (macro_k={k}, chunk_width={width or 2048})"
        eng = BatchedHybridEngine(deployment=long_dep, batch_size=8,
                                  macro_k=k, lazy_pages=True,
                                  chunk_width=width)
        res, wall, launches, calls, peak, _ = traffic_run(
            torch, eng, long_dep, LONG_REQUESTS, tag, n_private=2)
        nb = eng.cloud_lane.l_cache["block"].shape[1]
        print(f"{tag}: LLM block tables (8, {nb}); KV pool "
              f"{eng.kv_pool_bytes()} B; middle chunks "
              f"{calls['slm_prefill_chunk']} (SLM), "
              f"{calls['llm_prefill_chunk']} (LLM); K3 offset "
              f"{launches['flash_attention_offset']}")
        if nb != 256 or any(r.stats.truncated for r in res) or any(
                r.stats.tokens != n for r, (_, n) in zip(res,
                                                         LONG_REQUESTS)):
            raise SystemExit(f"{tag}: a prompt was truncated or a budget "
                             "not served, or the tables are not 256 wide")
        ids[tag] = [r.text for r in res]
        out[f"serve_long_k{k}_w{width or 2048}"] = launches
        del eng
        gc.collect()
    first = next(iter(ids.values()))
    if any(v != first for v in ids.values()):
        raise SystemExit(f"serve_long: ids differ across the runs: "
                         f"{[k for k, v in ids.items() if v != first]}")
    eng = BatchedHybridEngine(deployment=dep, batch_size=8, macro_k=8)
    res, *_ = traffic_run(torch, eng, dep, LONG_REQUESTS,
                          "serve_long (max_ctx=2048)", n_private=2)
    cut = [r.stats.truncated for r in res]
    if cut != [True] * n_long + [False] * (len(res) - n_long):
        raise SystemExit(f"serve_long: truncation flags {cut} at max_ctx "
                         "2048")
    del eng, long_dep
    gc.collect()
    torch.cuda.empty_cache()
    tag = "serve_long (one-shot, max_seq=4096)"
    one_dep = deployment(max_seq=4096)
    eng = BatchedHybridEngine(deployment=one_dep, batch_size=8, macro_k=8)
    res, _, out["serve_long_oneshot"], *_ = traffic_run(
        torch, eng, one_dep, LONG_REQUESTS, tag, n_private=2)
    same = [a == r.text for a, r in zip(first, res)]
    print(f"serve_long: ids equal across the four chunked runs; truncated "
          f"at max_ctx 2048: {cut}; {tag}: ids equal to the chunked runs' "
          f"on {sum(same)} of {len(res)}")
    if not all(same):
        raise SystemExit(f"{tag}: ids differ from the chunked runs")
    del eng, one_dep
    gc.collect()
    torch.cuda.empty_cache()
    return out


def counted(dep, names):
    """Count calls of the deployment's entry points ``names`` (instance
    attributes shadowing the methods; ``uncounted`` removes them)."""
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for name in names:
        setattr(dep, name, wrap(name, getattr(dep, name)))
    return calls


def uncounted(dep, calls):
    for name in calls:
        delattr(dep, name)


def lora_kernels():
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.kernels.moe_lora import kernel as KL
    from repro_torch.kernels.paged_attention import kernel as K2
    return (K1.fuse_logits, K2.paged_decode_attention, K3.flash_attention,
            KL.moe_lora_delta_slots, KL.moe_lora_delta)


def reset_counts():
    """Every kernel count of the serving and training paths to 0, the
    per-mode ones (K2 in ring and in full-length window mode, K3 and K8
    windowed, K3 in its history-offset mode) included."""
    from repro_torch.kernels.flash_attention import kernel as K3
    for fn in all_kernels():
        fn.launches = 0
    k2, k3 = lora_kernels()[1:3]
    k2.ring_launches = k2.window_launches = k3.windowed_launches = 0
    k3.offset_launches = 0
    K3.flash_attention_bwd.windowed_launches = 0


def mode_counts():
    """K2's ring-mode and full-length window launches and K3's windowed
    and history-offset launches since ``reset_counts``."""
    k2, k3 = lora_kernels()[1:3]
    return {"paged_decode_attention_ring": k2.ring_launches,
            "paged_decode_attention_window": k2.window_launches,
            "flash_attention_windowed": k3.windowed_launches,
            "flash_attention_offset": k3.offset_launches}


def run_counted(torch, sched, dep, names):
    """One scheduler run with every kernel's count set to 0 just before
    and read just after, and the deployment's ``names`` entry points
    counted: (responses, wall s, launches, calls, peak GiB).  The
    launches hold K2's ring-mode and K3's windowed counts too."""
    kernels = all_kernels()
    calls = counted(dep, names)
    reset_counts()
    # an engine and its lanes refer to each other: free the last phase's
    # lane caches before the peak is read
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds():
        res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    launches.update(mode_counts())
    uncounted(dep, calls)
    return res, wall, launches, calls, \
        torch.cuda.max_memory_allocated() / 2**30


def check_batched_responses(tag, eng, res, requests, n_private=4):
    """Every request served within budget, the privacy split right
    (``n_private`` private requests), no cloud token on a private
    request, sane fusion weights/latencies."""
    private = {i for i, req in enumerate(requests)
               if eng.detector.detect(req[0])}
    if len(private) != n_private \
            or {r.rid for r in res if r.stats.private} != private:
        raise SystemExit(f"{tag}: privacy split is wrong: {private}")
    for r, (_, n, *_) in zip(res, requests):
        if r.stats.private and (r.stats.cloud_tokens or r.stats.cloud_calls):
            raise SystemExit(f"{tag}: private rid {r.rid} used the cloud")
        w = r.stats.fusion_w
        if r.error or r.stats.tokens == 0 or r.stats.tokens > n \
                or not all(0.0 <= x <= 1.0 for x in w) \
                or not all(math.isfinite(x) for x in r.stats.latency_ms):
            raise SystemExit(f"{tag}: bad output on rid {r.rid}: {r.stats}")


def print_batched(tag, res, wall, launches, calls, peak, extra="",
                  macro_k=0):
    from repro_torch.serving.scheduler import summarize
    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms ids={r.text[:48]}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    RATES[tag] = tokens / wall
    print(f"{tag}: {tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} "
          f"tokens/s ({len(res)} requests, batch 8, macro_k={macro_k}, "
          f"prefill included); peak memory {peak:.2f} GiB; launches "
          f"{launches}; "
          f"SLM calls {calls}{extra}")


def phase_serve_adapters(torch, dep, plain_ids):
    """Per-user adapters on the full-width pair: six users with random B
    over a 4-slot bank, the serve_batched traffic with users and
    adapter-free rows mixed, run with use_slot_kernel False (decode LoRA
    through K5 on one-hot gate rows) and True (through K4 on slot ids).
    The two runs must give the same tokens; some request's tokens must
    differ from the adapter-free serve_batched run."""
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    ad_dep = ServingDeployment(dep.slm, dep.slm_params, dep.llm,
                               dep.llm_params, dep.mlp, max_seq=dep.max_seq,
                               adapter_slots=LORA_E, device=dep.device)
    users = random_adapters(torch, dep.slm, 6, LORA_B_SCALE, 300,
                            dep.device)
    n_layers = dep.slm.cfg.num_layers
    runs = {}
    for flag in (False, True):
        sched = ContinuousBatchScheduler.from_deployment(
            ad_dep, batch_size=8, macro_k=0, lazy_pages=True,
            use_slot_kernel=flag)
        eng = sched.engine
        for j, ad in enumerate(users):
            eng.adapters.register(f"user{j}", ad)
        for (p, n), aid in zip(BATCHED_REQUESTS, ADAPTER_OF):
            sched.submit(p, max_new_tokens=n, adapter_id=aid)
        with AdmissionGroups() as groups:
            res, wall, launches, calls, peak = run_counted(
                torch, sched, ad_dep, ("slm_prefill_packed", "slm_decode"))
        st = eng.adapter_stats()
        tag = f"serve_adapters (use_slot_kernel={flag})"
        print_batched(tag, res, wall, launches, calls, peak,
                      f"; adapter_stats {st}")
        check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
        pre = 6 * n_layers * calls["slm_prefill_packed"]
        dec = 6 * n_layers * calls["slm_decode"]
        want = ({"moe_lora_delta_slots": dec, "moe_lora_delta": pre}
                if flag else {"moe_lora_delta_slots": 0,
                              "moe_lora_delta": pre + dec})
        got = {k: launches[k] for k in want}
        if got != want:
            raise SystemExit(f"{tag}: LoRA launches {got}, expected {want} "
                             "(6 targets x SLM layer passes)")
        if min(launches[k] for k in ("fuse_logits", "paged_decode_attention",
                                     "flash_attention")) <= 0:
            raise SystemExit(f"{tag}: a kernel never launched: {launches}")
        if st["evictions"] <= 0 or st["pinned"] != 0:
            raise SystemExit(f"{tag}: adapter cache {st}")
        if eng.resident_kv_bytes() != 0:
            raise SystemExit(f"{tag}: pages leaked")
        runs[flag] = dict(ids=[r.text for r in res], launches=launches,
                          calls=calls, stats=st, wall=wall, peak=peak,
                          groups=groups.of_rid)
        del sched, eng
    if runs[False]["ids"] != runs[True]["ids"]:
        raise SystemExit("serve_adapters: K4 and K5 decode runs gave "
                         "different tokens")
    runs["macro"] = serve_adapters_macro(torch, ad_dep, users, runs[True])
    moved = [a != b for a, b in zip(runs[True]["ids"], plain_ids)]
    with_ad = sum(m for m, aid in zip(moved, ADAPTER_OF) if aid)
    print(f"serve_adapters: tokens equal across the two runs; tokens "
          f"differ from the adapter-free serve_batched run on {with_ad} of "
          f"{sum(a is not None for a in ADAPTER_OF)} requests with an "
          f"adapter and {sum(moved) - with_ad} without")
    if with_ad == 0:
        raise SystemExit("serve_adapters: the adapters changed no token")
    return runs


def serve_adapters_macro(torch, ad_dep, users, per_token, k=8):
    """serve_adapters' traffic at macro_k=8 with use_slot_kernel=True:
    K4 decodes in the graphs, K5 prefills at admission.  Its token ids
    must equal the per-token K4 run's on every request admitted in the
    same group (soft refusals on pinned slots can regroup admissions;
    the groups are printed); K4 launches are held to 6 x K x SLM layers
    x graph replays, K5 to 6 x SLM layers x prefills."""
    from repro_torch.serving.engine import BatchedHybridEngine

    eng = BatchedHybridEngine(deployment=ad_dep, batch_size=8, macro_k=k,
                              lazy_pages=True, use_slot_kernel=True)
    for j, ad in enumerate(users):
        eng.adapters.register(f"user{j}", ad)
    res, wall, launches, calls, peak, replays, first_s, groups = \
        serve_macro_run(torch, eng, BATCHED_REQUESTS, ad_dep,
                        ("slm_prefill_packed",), ADAPTER_OF)
    tag = f"serve_adapters (use_slot_kernel=True, macro_k={k})"
    st = eng.adapter_stats()
    print_batched(tag, res, wall, launches, calls, peak,
                  f"; adapter_stats {st}; graph replays (cloud, edge) "
                  f"{replays}; first run {first_s:.3f} s", macro_k=k)
    check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
    n_layers = ad_dep.slm.cfg.num_layers
    want = {"moe_lora_delta_slots": 6 * n_layers * k * sum(replays),
            "moe_lora_delta": 6 * n_layers * calls["slm_prefill_packed"]}
    got = {n: launches[n] for n in want}
    if got != want:
        raise SystemExit(f"{tag}: LoRA launches {got}, expected {want}")
    if st["pinned"] != 0 or eng.resident_kv_bytes() != 0:
        raise SystemExit(f"{tag}: adapter pins or pages leaked")
    ids = [r.text for r in res]
    match = [per_token["groups"][r.rid] == groups[r.rid] for r in res]
    equal = [a == b for a, b in zip(ids, per_token["ids"])]
    print(f"{tag}: admission groups per-token "
          f"{sorted(set(per_token['groups'].values()))}; macro "
          f"{sorted(set(groups.values()))}; {sum(match)} of {len(res)} "
          f"requests in the same group; tokens equal to the per-token K4 "
          f"run on {sum(equal)} of {len(res)}")
    bad = [r.rid for r, m, e in zip(res, match, equal) if m and not e]
    if bad:
        raise SystemExit(f"{tag}: requests {bad} admitted in the same "
                         "group differ from the per-token K4 run")
    retaken(tag, lambda: profile_lora_boundary(torch, eng, tag), eng)
    return dict(ids=ids, launches=launches, calls=calls, wall=wall,
                peak=peak)


def profile_lora_boundary(torch, eng, tag):
    """One macro boundary of the K4 adapter engine under torch.profiler,
    after a warm-up step: the profiled K4 passes (``lora_down`` and
    ``lora_up``, which K5 shares below 64 rows) must equal the
    replay-aware K4 count, 6 x K x SLM layers x graph replays, and K5
    must not run in decode."""
    from repro_torch.kernels.moe_lora.kernel import (moe_lora_delta,
                                                     moe_lora_delta_slots)

    reqs = [(p, 40, True, 700 + i, None, None, aid) for i, ((p, _), aid)
            in enumerate(zip(BATCHED_REQUESTS, ADAPTER_OF))]
    if not any(eng.add_requests(reqs)):
        raise SystemExit(f"{tag}: no profiled request was admitted")
    eng.step()
    torch.cuda.synchronize()
    r0 = macro_replays(eng)
    n0 = (moe_lora_delta_slots.launches, moe_lora_delta.launches)
    with profiled(torch) as prof:
        eng.step()
        torch.cuda.synchronize()
    replays = [b - a for a, b in zip(r0, macro_replays(eng))]
    counted = (moe_lora_delta_slots.launches - n0[0],
               moe_lora_delta.launches - n0[1])
    rows = profile_rows(torch, prof)
    passes = [sum(r[1] for r in rows if p in r[2])
              for p in ("lora_down", "lora_up")]
    want = 6 * eng.dep.slm.cfg.num_layers * eng.macro_k * sum(replays)
    print(f"{tag}: profiled boundary: graph replays (cloud, edge) "
          f"{replays}; K4 counted {counted[0]}, profiled (down, up) "
          f"{passes}; K5 counted {counted[1]}")
    if sum(replays) == 0 or counted != (want, 0) \
            or passes != [want, want]:
        raise SystemExit(f"{tag}: profiled boundary: K4 counted "
                         f"{counted[0]} and profiled {passes}, K5 "
                         f"{counted[1]}; expected K4 {want} and no K5")
    while eng.active_count():
        eng.step()
    if eng.adapter_stats()["pinned"] != 0 or eng.resident_kv_bytes() != 0:
        raise SystemExit(f"{tag}: adapter pins or pages leaked")


def phase_serve_router(torch, dep, plain_ids):
    """Router-gated experts on the full-width pair: a 4-expert bank with
    random B and a Router over four domains, the serve_batched traffic
    through ContinuousBatchScheduler, then one request through
    HybridEngine.generate; every SLM projection through K5."""
    from repro_torch.core import lora as LORA
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import HybridEngine
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    bank = LORA.stack_adapters(random_adapters(
        torch, dep.slm, LORA_E, LORA_B_SCALE, 400, dep.device))
    r_dep = ServingDeployment(dep.slm, dep.slm_params, dep.llm,
                              dep.llm_params, dep.mlp, expert_bank=bank,
                              max_seq=dep.max_seq, device=dep.device)
    router = check_router(LORA_E)
    n_layers = dep.slm.cfg.num_layers
    sched = ContinuousBatchScheduler.from_deployment(
        r_dep, batch_size=8, macro_k=0, lazy_pages=True, router=router)
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    res, wall, launches, calls, peak = run_counted(
        torch, sched, r_dep, ("slm_prefill_packed", "slm_decode"))
    print_batched("serve_router", res, wall, launches, calls, peak)
    check_batched_responses("serve_router", sched.engine, res,
                            BATCHED_REQUESTS)
    want = 6 * n_layers * (calls["slm_prefill_packed"] + calls["slm_decode"])
    if launches["moe_lora_delta"] != want \
            or launches["moe_lora_delta_slots"] != 0:
        raise SystemExit(f"serve_router: LoRA launches {launches}, K5 "
                         f"expected {want}")
    moved = sum(r.text != b for r, b in zip(res, plain_ids))
    print(f"serve_router: {moved} of {len(res)} requests' tokens differ "
          "from the adapter-free serve_batched run")
    del sched
    eng = HybridEngine(deployment=r_dep, router=router)
    seq_calls = counted(r_dep, ("slm_prefill", "slm_decode"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text, st = eng.generate(DEMO_PROMPTS[2], 16, rid=99)
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    seq_launches = {fn.__name__: fn.launches for fn in lora_kernels()}
    seq_launches.update(mode_counts())
    uncounted(r_dep, seq_calls)
    print(f"serve_router sequential: {st.tokens} tokens in {seq_wall:.3f} "
          f"s, cloud={st.cloud_tokens}/{st.tokens}; launches "
          f"{seq_launches}; SLM calls {seq_calls}; gates "
          f"{router.gate_weights(DEMO_PROMPTS[2]).tolist()}")
    want = 6 * n_layers * (seq_calls["slm_prefill"] + seq_calls["slm_decode"])
    if seq_launches["moe_lora_delta"] != want or st.tokens == 0:
        raise SystemExit(f"serve_router sequential: K5 launched "
                         f"{seq_launches['moe_lora_delta']}, expected {want}")
    return dict(launches=launches, calls=calls, wall=wall, peak=peak,
                seq_launches=seq_launches)


def gemma3_deployment(torch, dep):
    """The full-width gemma3 pair on the card: floe-slm-gemma3 (bf16, ring
    caches on its 22 sliding-window layers, random weights from seed 3)
    beside the 2b deployment's floe-llm-7b and alignment MLP, whose
    tensors it shares (no second 7B is held), max_seq 2048, 16-slot
    pages."""
    from repro_torch.configs import get_config
    from repro_torch.configs.floe_pair import FLOE_PAIRS, needs_ring_cache
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment

    sname, lname = FLOE_PAIRS["gemma3"]
    scfg = get_config(sname)
    if get_config(lname) != dep.llm.cfg:
        raise SystemExit(f"the gemma3 pair's LLM is {lname}")
    t0, before = time.perf_counter(), torch.cuda.memory_allocated()
    slm = LM(scfg, ring_cache=needs_ring_cache(scfg))
    g_dep = ServingDeployment(slm, slm.init(3), dep.llm, dep.llm_params,
                              dep.mlp, max_seq=2048, page_size=16)
    torch.cuda.synchronize()
    shared = g_dep.llm_params["embed"]["tok"]["w"].data_ptr() \
        == dep.llm_params["embed"]["tok"]["w"].data_ptr()
    sites = slm.layer_sites()
    print(f"serve_gemma3: {scfg.name} ({len(sites)} layers, "
          f"{sum(not st.is_global for st in sites)} of them sliding-window "
          f"rings of {slm._ring_local_len(2048)} slots) initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s, "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB; "
          f"LLM shared with the 2b deployment: {shared}")
    if not shared:
        raise SystemExit("serve_gemma3 holds a second copy of the LLM")
    return g_dep


def gemma3_layers(lm):
    """(local, global) attention layers of the SLM's grouped layout."""
    sites = lm.layer_sites()
    n_local = sum(not st.is_global for st in sites)
    return n_local, len(sites) - n_local


def phase_serve_gemma3(torch, dep):
    """The full-width gemma3 pair: serve's traffic through the sequential
    engine, one full-width admission against the plain path, then
    serve_batched's 20 requests through ContinuousBatchScheduler at
    macro_k 0 and 8 (lazy pages, batch 8), and one profiled K = 8
    boundary.  Returns {path: launches} and the K = 8 run's numbers."""
    g_dep = gemma3_deployment(torch, dep)
    seq = serve_gemma3_sequential(torch, g_dep)
    check_gemma3_admission(torch, g_dep)
    k0, res0, groups0 = serve_gemma3_batched(torch, g_dep, 0)
    k8, res8, groups8, eng8 = serve_gemma3_batched(torch, g_dep, 8)
    match = [groups0[r.rid] == groups8[r.rid] for r in res8]
    equal = [same_response(a, b) for a, b in zip(res0, res8)]
    print(f"serve_gemma3_batched: {sum(match)} of {len(res8)} requests "
          f"admitted in the same group at K = 8 as at K = 0, "
          f"{sum(equal)} equal to the K = 0 run bit for bit")
    bad = [r.rid for r, m, e in zip(res8, match, equal) if m and not e]
    if bad:
        raise SystemExit(f"serve_gemma3_batched: requests {bad} admitted in "
                         "the same group differ from the K = 0 run")
    retaken("trace_batched", lambda: trace_batched(torch, eng8), eng8)
    del eng8
    gc.collect()
    dense = serve_gemma3_dense(torch, g_dep, res8)
    nonring = serve_gemma3_nonring(torch, g_dep)
    flat = phase_flat_keys(torch, g_dep, "flat_keys_gemma3", 4, 8)
    prefix = serve_gemma3_prefix(torch, g_dep)
    chunked = serve_gemma3_chunked(torch, g_dep, res8)
    spec = serve_gemma3_spec(torch, g_dep, res8, groups8)
    return {"serve_gemma3": seq, "serve_gemma3_batched": k8,
            "serve_gemma3_batched_k0": k0, "serve_dense_gemma3": dense,
            "serve_gemma3_nonring": nonring, **flat, **prefix,
            "serve_gemma3_chunked": chunked, "serve_gemma3_spec": spec}


def serve_gemma3_dense(torch, g_dep, paged):
    """serve_batched's 20 requests on the gemma3 pair's dense lanes at
    macro_k 8 (window-sized rings per row, read by K2 in its ring mode
    through identity tables): every response equal to the paged K = 8
    run's (``paged``) bit for bit.  Returns the launches."""
    tag = "serve_dense_gemma3 (macro_k=8)"
    res, rate, launches, peak, _, eng, replays = serve_run(
        torch, g_dep, 8, BATCHED_REQUESTS, tag, paged=False)
    equal = [same_response(a, b) for a, b in zip(paged, res)]
    ring = launches["paged_decode_attention_ring"]
    print(f"{tag}: {rate:.2f} tokens/s, peak {peak:.2f} GiB, lane KV "
          f"{eng.kv_pool_bytes()} B (dense); K2 in ring mode {ring}; "
          f"{sum(equal)} of {len(res)} responses equal to the paged "
          f"engine's bit for bit")
    if not all(equal):
        raise SystemExit(f"{tag}: requests "
                         f"{[r.rid for r, e in zip(res, equal) if not e]} "
                         "differ from the paged lanes")
    if ring != 8 * gemma3_layers(g_dep.slm)[0] * sum(replays):
        raise SystemExit(f"{tag}: K2 ring launches {ring}")
    return launches


def serve_gemma3_nonring(torch, g_dep):
    """The gemma3 SLM built without ring caches (the reference's ``LM``
    default: full-length local leaves, paged from the block table),
    the same parameters: eight of serve_batched's requests at macro_k
    8, against the ring engine on the same eight.  K2 takes every local
    layer in its full-length window mode (none in ring mode); the token
    ids must equal the ring run's.  Returns the launches."""
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment

    reqs = BATCHED_REQUESTS[:8]          # two private
    ring_res = serve_run(torch, g_dep, 8, reqs,
                         "serve_gemma3_nonring: ring engine", 2)[0]
    gc.collect()
    flat = LM(g_dep.slm.cfg, ring_cache=False)
    f_dep = ServingDeployment(flat, g_dep.slm_params, g_dep.llm,
                              g_dep.llm_params, g_dep.mlp, max_seq=2048,
                              page_size=16)
    tag = "serve_gemma3_nonring (macro_k=8)"
    res, rate, launches, peak, _, eng, replays = serve_run(
        torch, f_dep, 8, reqs, tag, 2)
    n_local = gemma3_layers(flat)[0]
    window = launches["paged_decode_attention_window"]
    ids = [a.text == b.text for a, b in zip(ring_res, res)]
    print(f"{tag}: {rate:.2f} tokens/s, KV pool {eng.kv_pool_bytes()} B "
          f"(no ring pool); K2 {launches['paged_decode_attention']} "
          f"launches, {window} in full-length window mode, "
          f"{launches['paged_decode_attention_ring']} in ring mode; ids "
          f"equal to the ring engine's on {sum(ids)} of {len(res)}")
    for a, b, same in zip(ring_res, res, ids):
        if not same:
            print(f"  rid {a.rid}: ring {a.text[:80]} / full-length "
                  f"{b.text[:80]}")
    if launches["paged_decode_attention_ring"] != 0 \
            or window != 8 * n_local * sum(replays) or window <= 0:
        raise SystemExit(f"{tag}: K2 launches {launches}, expected "
                         f"{8 * n_local * sum(replays)} in window mode")
    if not all(ids):
        raise SystemExit(f"{tag}: token ids differ from the ring engine's")
    return launches


def serve_gemma3_sequential(torch, g_dep):
    """The four demo prompts and the 1,542-token one, 16 greedy tokens
    each, through Scheduler.from_deployment: K3 once per prefill layer
    (windowed on the SLM's local layers), K1 on every fused token, no
    K2 (the sequential engine decodes against dense caches, rings on
    the local layers)."""
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.scheduler import Scheduler, summarize

    sched = Scheduler.from_deployment(g_dep)
    for p in list(DEMO_PROMPTS) + [LONG_PROMPT]:
        sched.submit(p, max_new_tokens=16)
    calls = counted(g_dep, ("slm_prefill", "llm_prefill"))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds():
        res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
    launches.update(mode_counts())
    uncounted(g_dep, calls)
    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms ids={r.text[:48]}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    print(f"serve_gemma3: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s (5 requests, sequential, prefill "
          f"included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}; prefills {calls}")
    n_local, n_global = gemma3_layers(g_dep.slm)
    want = {"flash_attention": (n_local + n_global) * calls["slm_prefill"]
            + g_dep.llm.cfg.num_layers * calls["llm_prefill"],
            "flash_attention_windowed": n_local * calls["slm_prefill"],
            "paged_decode_attention": 0}
    got = {k: launches[k] for k in want}
    if got != want or launches["fuse_logits"] <= 0:
        raise SystemExit(f"serve_gemma3: launches {got}, expected {want}")
    for r in res:
        if (r.rid in {1, 3}) != r.stats.private or r.stats.tokens == 0 \
                or (r.stats.private and r.stats.cloud_tokens) \
                or not all(0.0 <= x <= 1.0 for x in r.stats.fusion_w):
            raise SystemExit(f"serve_gemma3: bad request {r.rid}: "
                             f"{r.stats}")
    return launches


def serve_gemma3_batched(torch, g_dep, k):
    """serve_batched's 20 requests on the gemma3 pair at macro_k ``k``
    (run untimed, then timed with every count set to 0 just before):
    K2 once per decode layer-step, in ring mode on the SLM's local
    layers; K3 once per prefill layer, windowed on them."""
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.serving.engine import BatchedHybridEngine

    eng = BatchedHybridEngine(deployment=g_dep, batch_size=8, macro_k=k,
                              lazy_pages=True)
    names = ("slm_prefill_packed", "llm_prefill_packed", "slm_decode",
             "llm_decode")
    res, wall, launches, calls, peak, replays, first_s, groups = \
        serve_macro_run(torch, eng, BATCHED_REQUESTS, g_dep, names)
    tag = f"serve_gemma3_batched (macro_k={k})"
    print_batched(tag, res, wall, launches, calls, peak, macro_k=k)
    print(f"{tag}: first run {first_s:.3f} s; graph replays (cloud, edge) "
          f"{replays}; KV pool {eng.kv_pool_bytes()} B; growth "
          f"{eng.growth_stats()}; macro {eng.macro_stats()}")
    check_batched_responses(tag, eng, res, BATCHED_REQUESTS)
    n_local, n_global = gemma3_layers(g_dep.slm)
    n_llm = g_dep.llm.cfg.num_layers
    lanes = (eng.cloud_lane, eng.edge_lane)
    if k:
        k2 = sum(k * n * lane_layers(lane) for n, lane in zip(replays, lanes))
        ring = sum(k * n * n_local for n in replays)
        graphs = [(lane._macro.per_replay(K2.paged_decode_attention),
                   lane._macro.per_replay(K2.paged_decode_attention,
                                          "ring_launches"))
                  for lane in lanes]
        if graphs != [(k * lane_layers(lane), k * n_local)
                      for lane in lanes]:
            raise SystemExit(f"{tag}: lane graphs hold (K2, ring) "
                             f"{graphs}")
    else:
        k2 = (calls["slm_decode"] * (n_local + n_global)
              + calls["llm_decode"] * n_llm)
        ring = calls["slm_decode"] * n_local
    want = {"paged_decode_attention": k2, "paged_decode_attention_ring": ring,
            "flash_attention": (n_local + n_global)
            * calls["slm_prefill_packed"]
            + n_llm * calls["llm_prefill_packed"],
            "flash_attention_windowed": n_local * calls["slm_prefill_packed"]}
    got = {name: launches[name] for name in want}
    print(f"{tag}: K2 {k2} launches, {ring} of them in ring mode (the "
          f"SLM's {n_local} local layers); K3 {want['flash_attention']}, "
          f"{want['flash_attention_windowed']} windowed")
    if got != want or launches["fuse_logits"] <= 0 or ring <= 0 \
            or launches["sample_fused"] != 0:
        raise SystemExit(f"{tag}: launches {got}, expected {want}, and "
                         f"no K7")
    if eng.growth_stats()["grown_pages"] <= 0 \
            or eng.resident_kv_bytes() != 0:
        raise SystemExit(f"{tag}: no lazy growth, or pages leaked")
    if k:
        return launches, res, groups, eng
    return launches, res, groups


def check_gemma3_admission(torch, g_dep):
    """One full-width admission of a ragged burst (the 1,542-token prompt
    among three short ones, padded to 1,552) into a fresh lane cache,
    held against the plain path: the last-token logits through K3
    against the same packed prefill with K3's plain version in its place
    (relative to max|ref|, LOGITS_TOL), and every ring page that
    ``page_writer`` wrote (22 local layers, K and V) against a plain
    gather of the streamed K/V at ``ring_kv_positions(len - 1, 512)``,
    bit for bit."""
    import numpy as np
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import attention as ATT
    from repro_torch.models.model import LOCAL_KINDS, cache_kv

    lm = g_dep.slm
    prompts = [LONG_PROMPT, DEMO_PROMPTS[0], BATCHED_REQUESTS[3][0],
               DEMO_PROMPTS[2]]
    ids = [TOK.encode(p + " ") for p in prompts]
    lens = np.array([len(x) for x in ids], np.int32)
    b, lpad = len(ids), -(-int(lens.max()) // 16) * 16
    toks = np.zeros((b, lpad), np.int64)
    for i, x in enumerate(ids):
        toks[i, :len(x)] = x
    toks = torch.as_tensor(toks, device=g_dep.device)
    geo = g_dep.paged_geometry(lm)
    w, nb, nl = geo["local_len"], geo["nb"], geo["nl"]
    cache = g_dep.init_paged_lane_cache(lm, b, b * nb, b * nl)
    tables = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    local = np.arange(b * nl, dtype=np.int32).reshape(b, nl)
    writer = g_dep.page_writer(cache, list(range(b)), tables, lens, local, w)
    streamed = {}

    def write(addr, k, v):
        if addr[0] in LOCAL_KINDS:
            streamed[addr] = (k, v)
        writer(addr, k, v)
    logits = lm.prefill_packed(g_dep.slm_params, toks, lens, g_dep.max_seq,
                               write)
    real = ATT.flash_attention
    ATT.flash_attention = K3.flash_attention_plain
    try:
        plain = lm.prefill_packed(g_dep.slm_params, toks, lens,
                                  g_dep.max_seq, lambda *a: None)
    finally:
        ATT.flash_attention = real
    rel = ((logits - plain).abs().max() / plain.abs().max()).item()
    pos = ATT.ring_kv_positions(
        torch.as_tensor(lens - 1, device=g_dep.device), w)
    idx = pos.clamp(0, lpad - 1)
    rows = torch.arange(b, device=g_dep.device)[:, None]
    pids = torch.as_tensor(local, device=g_dep.device).long()
    same = 0
    for addr, kv in streamed.items():
        for name, t in zip("kv", kv):
            got = cache_kv(cache, addr, name)[pids.reshape(-1)].reshape(
                b, nl * 16, *t.shape[2:])[:, :w]
            same += torch.equal(got, t[rows, idx])
    print(f"serve_gemma3 admission: B={b} packed prefill at Lpad {lpad} "
          f"(lengths {lens.tolist()}, window {w}): last-token logits "
          f"through K3 vs its plain version, max|diff|/max|ref| = "
          f"{rel:.3e}; ring pages equal to a plain gather bit for bit: "
          f"{same} of {2 * len(streamed)}")
    if not rel <= LOGITS_TOL or same != 2 * len(streamed) \
            or len(streamed) != gemma3_layers(lm)[0] \
            or not torch.isfinite(logits).all():
        raise SystemExit("serve_gemma3: the full-width admission disagrees "
                         "with the plain path")


def max_sm_mhz() -> float:
    """The card's top SM clock (``clocks.max.sm``), MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def k7_inputs(torch, g, b, v=256_000):
    """serve_sampled's draw: rows alternately near-flat (softmax of 0.1
    randn) and peaked (softmax of 8 randn), serve_sampled's key ids
    (2001, 2003, ...), steps within its budgets, a greedy mask mixing
    both kinds of row."""
    dev = torch.device("cuda")
    scale = torch.tensor([0.1, 8.0] * b, device=dev)[:b, None]
    probs = torch.softmax(scale * torch.randn(b, v, device=dev,
                                              generator=g), -1)
    keys = torch.arange(SAMPLED_SEED + 1, SAMPLED_SEED + 1 + 2 * b, 2,
                        dtype=torch.int32, device=dev)
    steps = torch.randint(0, 40, (b,), device=dev, generator=g,
                          dtype=torch.int64).to(torch.int32)
    greedy = torch.tensor([False, False, True] * b, device=dev)[:b]
    return probs, greedy, keys, steps


def k8_case(torch, g, b, h, kvh, s, d=256):
    """K3 forward with its LSE, then K8, against autograd of K3's plain
    version on the same bf16 (B, H, S, D) views of (B, S, H, D) tensors
    (the model's layout); K3's output must not change with the LSE on,
    two K8 calls must return the same bits.  Timed beside K8's plain
    version and autograd through SDPA (enable_gqa)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g)
               .bfloat16().transpose(1, 2) for n in (h, kvh, kvh))
    do = torch.randn(b, s, h, d, device="cuda",
                     generator=g).bfloat16().transpose(1, 2)
    out, lse = K3.flash_attention(q, k, v, return_lse=True)
    plain_out = K3.flash_attention(q, k, v)
    grads = K3.flash_attention_bwd(q, k, v, out, do, lse)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    if not torch.equal(out, plain_out):
        raise SystemExit("K3: the LSE output changed the attention output")
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        raise SystemExit("K8: two calls on the same inputs differ")
    lse_ref = K3.attention_lse_plain(q, k)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr),
                              (qr, kr, vr), do)
    rel = [((x.float() - y.float()).abs().max()
            / y.float().abs().max()).item() for x, y in zip(grads, ref)]
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=kvh != h)

    def lib():
        return torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                   retain_graph=True)
    # five products a visible (query, key) pair and head (S, dP, dV, dQ,
    # dK), 2 d operations each; q, o, dO read and dq written, k, v read
    # and dk, dv written, the LSE read
    pairs = b * h * s * (s + 1) // 2
    nbytes = 2 * (4 * b * h * s * d + 4 * b * kvh * s * d) + 4 * b * h * s
    bms, by = bound(nbytes, 10 * d * pairs, BF16_FLOP_PER_S)
    iters = 20 if s > 512 else 100
    case = dict(
        shape=dict(B=b, H=h, KVH=kvh, S=s, D=d,
                   layout="(B, S, H, D) views"), dtype="bfloat16",
        max_abs_err=max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(grads, ref)),
        max_rel_err=max(rel), rel_err_dq_dk_dv=rel,
        lse_max_abs_err=(lse - lse_ref).abs().max().item(),
        ms=time_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, out, do, lse), iters),
        plain_ms=time_ms(torch, lambda: K3.flash_attention_bwd_plain(
            q, k, v, out, do, lse), max(3, iters // 10)),
        library_ms=time_ms(torch, lib, iters),
        forward_lse_ms=time_ms(torch, lambda: K3.flash_attention(
            q, k, v, return_lse=True), iters),
        forward_ms=time_ms(torch, lambda: K3.flash_attention(q, k, v),
                           iters),
        bound_ms=bms, bound_by=by)
    print(f"K8 flash_attention_bwd: {case}")
    return case


def k9_case(torch, g, t, k, n, e, groups):
    """K9 against autograd of K5's plain version at (T, k, n), E experts,
    r = LORA_R, ``groups`` gate rows of random soft gates (ones when E =
    1, as a client step's (1,) gate), and K5's forward on the same
    inputs against its plain version per row; two calls must return the
    same bits.  Timed beside K9's plain version and autograd through the
    einsums."""
    from repro_torch.kernels.moe_lora import kernel as KL
    r = LORA_R
    x = torch.randn(t, k, device="cuda", generator=g).bfloat16()
    a = torch.randn(e, r, k, device="cuda", generator=g) / math.sqrt(k)
    bm = torch.randn(e, n, r, device="cuda", generator=g) * 0.1
    gates = torch.ones(groups, e, device="cuda") if e == 1 else \
        torch.softmax(torch.randn(groups, e, device="cuda", generator=g), -1)
    dy = torch.randn(t, n, device="cuda", generator=g)
    rpg = t // groups
    got = KL.moe_lora_delta_bwd(x, a, bm, gates, dy, rpg)
    again = KL.moe_lora_delta_bwd(x, a, bm, gates, dy, rpg)
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(got, again)):
        raise SystemExit("K9: two calls on the same inputs differ")
    xs, as_, bs = (z.detach().clone().requires_grad_(True)
                   for z in (x, a, bm))
    lib_out = KL.moe_lora_delta_plain(xs, as_, bs, gates, rpg)
    ref = torch.autograd.grad(lib_out, (xs, as_, bs), dy, retain_graph=True)
    rel = [((u.float() - w.float()).abs().max()
            / w.float().abs().max()).item() for u, w in zip(got, ref)]
    fwd_rel = row_rel_err(KL.moe_lora_delta(x, a, bm, gates, rpg),
                          lib_out.detach())

    def lib():
        return torch.autograd.grad(lib_out, (xs, as_, bs), dy,
                                   retain_graph=True)
    nbytes = 2 * (2 * t * k) + 4 * (2 * e * r * (k + n) + t * n) \
        + 4 * groups * e
    bms, by = bound(nbytes, 2 * t * e * r * (3 * k + 2 * n), F32_FLOP_PER_S)
    iters = 50
    case = dict(
        shape=dict(T=t, k=k, n=n, E=e, r=r, gate_rows=groups),
        dtype="x bf16, bank/dy f32",
        max_abs_err=max((u.float() - w.float()).abs().max().item()
                        for u, w in zip(got, ref)),
        max_rel_err=max(rel), rel_err_dx_da_db=rel,
        k5_forward_row_rel_err=fwd_rel,
        ms=time_ms(torch, lambda: KL.moe_lora_delta_bwd(
            x, a, bm, gates, dy, rpg), iters),
        plain_ms=time_ms(torch, lambda: KL.moe_lora_delta_bwd_plain(
            x, a, bm, gates, dy, rpg), iters // 5),
        library_ms=time_ms(torch, lib, iters // 5),
        bound_ms=bms, bound_by=by)
    print(f"K9 moe_lora_delta_bwd: {case}")
    return case


def phase_train_kernels(torch):
    """K8, K9 and K10 (no Pallas originals: the backward kernels of a
    client step) against the forward kernels' plain versions on the
    card: K8 at the client steps' shapes (B x S = 4 x 40, the chip
    phase, and 8 x 48, SimConfig's default) and at (1, 2048), the 2b
    SLM's H 8 / KV 1 / head_dim 256; K9 at T = 160 on the six (k, n) of
    the SLM's targets with E = 1 (a client step) and at mlp_in and
    mlp_out with E = 4 soft gates over 4 gate rows, and at E = 1 on
    falcon-mamba's four targets (SSM_LORA_SHAPES), K5's forward beside
    it; K8's windowed mode at K8W_SHAPES (``k8w_case``); K10 at
    K10_SHAPES (``k10_case``)."""
    g = torch.Generator(device="cuda").manual_seed(25)
    k8 = [k8_case(torch, g, b, 8, 1, s) for b, s in ((4, 40), (8, 48),
                                                    (1, 2048))]
    shapes = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
              (2048, 32768), (16384, 2048)]
    k9 = [k9_case(torch, g, 160, k, n, 1, 1) for k, n in shapes] + \
        [k9_case(torch, g, 160, k, n, 4, 4) for k, n in shapes[4:]] + \
        [k9_case(torch, g, 160, k, n, 1, 1) for k, n in SSM_LORA_SHAPES]
    t0 = time.perf_counter()
    k8w = [k8w_case(torch, g, b, s) for b, s in K8W_SHAPES]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    k10 = [k10_case(torch, g, b, s, sms, mhz) for b, s in K10_SHAPES]
    print(f"kernels K8 windowed and K10: {time.perf_counter() - t0:.1f} s")
    bad = [c for c in k8 + k8w
           if not (c["max_rel_err"] <= K8_RTOL
                   and c["lse_max_abs_err"] <= K8_LSE_TOL)] + \
        [c for c in k9 if not (c["rel_err_dx_da_db"][0] <= K9_DX_RTOL
                               and max(c["rel_err_dx_da_db"][1:])
                               <= K9_RTOL
                               and c["k5_forward_row_rel_err"]
                               <= LORA_ROW_RTOL)] + \
        [c for c in k10
         if not (max(c["rel_err_ddt_dx_db_dc_da"][i] for i in (0, 4))
                 <= K10_F32_RTOL
                 and max(c["rel_err_ddt_dx_db_dc_da"][1:4])
                 <= K10_BF16_RTOL)]
    if bad:
        raise SystemExit(f"K8/K9/K10 disagree with their plain versions: "
                         f"{bad}")
    return k8, k9, k8w, k10


def k8w_case(torch, g, b, s, h=4, kvh=1, d=256, window=GEMMA3_WINDOW):
    """K3 windowed with its LSE, then K8 windowed, against autograd of
    K3's windowed plain version on bf16 (B, H, S, D) views of (B, S, H,
    D) tensors; K3's output unchanged by the LSE, two K8 calls the same
    bits.  Timed beside K8's plain version and autograd through SDPA
    under the window's boolean mask; the bound counts only the (query,
    key) pairs the window leaves visible."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.time_kernels import k8w_inputs
    q, k, v, do = k8w_inputs(torch, g, b, s, h, kvh, d)
    out, lse = K3.flash_attention(q, k, v, window=window, return_lse=True)
    plain_out = K3.flash_attention(q, k, v, window=window)
    grads = K3.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    torch.cuda.synchronize()
    if not torch.equal(out, plain_out):
        raise SystemExit("K3 windowed: the LSE output changed the output")
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        raise SystemExit("K8 windowed: two calls on the same inputs differ")
    lse_ref = K3.attention_lse_plain(q, k, window=window)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr,
                                                       window=window),
                              (qr, kr, vr), do)
    rel = [((x.float() - y.float()).abs().max()
            / y.float().abs().max()).item() for x, y in zip(grads, ref)]
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    mask = K3.attention_mask(s, True, window, q.device)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             enable_gqa=kvh != h)

    def lib():
        return torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                   retain_graph=True)
    pairs = b * h * sum(min(i + 1, window) for i in range(s))
    nbytes = 2 * (4 * b * h * s * d + 4 * b * kvh * s * d) + 4 * b * h * s
    bms, by = bound(nbytes, 10 * d * pairs, BF16_FLOP_PER_S)
    iters = 20 if s > 1024 else 50
    case = dict(
        shape=dict(B=b, H=h, KVH=kvh, S=s, D=d, window=window,
                   layout="(B, S, H, D) views"), dtype="bfloat16",
        visible_pairs=pairs,
        max_abs_err=max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(grads, ref)),
        max_rel_err=max(rel), rel_err_dq_dk_dv=rel,
        lse_max_abs_err=(lse - lse_ref).abs().max().item(),
        ms=time_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, out, do, lse, window=window), iters),
        plain_ms=time_ms(torch, lambda: K3.flash_attention_bwd_plain(
            q, k, v, out, do, lse, window=window), 3),
        library_ms=time_ms(torch, lib, iters),
        forward_lse_ms=time_ms(torch, lambda: K3.flash_attention(
            q, k, v, window=window, return_lse=True), iters),
        bound_ms=bms, bound_by=by)
    print(f"K8 flash_attention_bwd (windowed): {case}")
    return case


def k10_case(torch, g, b, s, sms, mhz):
    """K10 at falcon-mamba's d_inner 8,192 and N 16 on ``b`` rows of S
    steps (``ssm_inputs``: B and C strided, bf16), from K6's chunk
    states, against its plain version per gradient (K10_F32_RTOL on
    d(dt) and dA, K10_BF16_RTOL on dx, dB, dC); K6 with its chunk-state
    output must equal K6 without it bit for bit, two K10 calls the same
    bits.  Bound: the larger of the bytes (dt, x, dy, the chunk states,
    B, C and A read once, d(dt), dx, dB, dC and dA written once) over
    3.35 TB/s and the exponentials' floor (one a state-step, as K6's:
    a_t = exp(dt A) serves both h_{t-1} -> h_t and a_t g_t; this design
    spends two, recomputing the chunk, which the bound does not count),
    at 16 a clock per SM; no PyTorch call computes it.  Beside it K6's ms with and without its chunk
    states."""
    from repro_torch.kernels.ssm_scan import kernel as K6
    from repro_torch.kernels.time_kernels import ssm_inputs
    dt, x, bm, cm, a = ssm_inputs(torch, g, s, b)
    dy = torch.randn(b, s, SSM_DI, device="cuda", generator=g).bfloat16()
    y0, h0 = K6.ssm_scan(dt, x, bm, cm, a)
    y1, h1, hc = K6.ssm_scan(dt, x, bm, cm, a, chunk_states=True)
    got = K6.ssm_scan_bwd(dt, x, bm, cm, a, dy, hc)
    again = K6.ssm_scan_bwd(dt, x, bm, cm, a, dy, hc)
    torch.cuda.synchronize()
    if not (torch.equal(y0, y1) and torch.equal(h0, h1)):
        raise SystemExit("K6: its chunk-state output changed y or h_final")
    if not all(torch.equal(u, w) for u, w in zip(got, again)):
        raise SystemExit("K10: two calls on the same inputs differ")
    ref = K6.ssm_scan_bwd_plain(dt, x, bm, cm, a, dy)
    rel = [((u.float() - w.float()).abs().max()
            / w.float().abs().max()).item() for u, w in zip(got, ref)]
    steps = b * s * SSM_DI
    nbytes = steps * (4 + 2 + 2 + 4 + 2) \
        + hc.numel() * 4 + 4 * b * s * SSM_N * 2 + 2 * SSM_DI * SSM_N * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ex2_ms = steps * SSM_N / (16 * sms * mhz * 1e6) * 1e3
    case = dict(
        shape=dict(B=b, S=s, di=SSM_DI, N=SSM_N, chunk=K6.CHUNK_STATE,
                   bc="strided slices of (B, S, 288)"),
        dtype="dt/A/d(dt)/dA f32, x/B/C/dy/dx/dB/dC bf16",
        max_abs_err=max((u.float() - w.float()).abs().max().item()
                        for u, w in zip(got, ref)),
        max_rel_err=max(rel), rel_err_ddt_dx_db_dc_da=rel,
        ms=time_ms(torch, lambda: K6.ssm_scan_bwd(dt, x, bm, cm, a, dy, hc),
                   20 if s > 512 else 50),
        plain_ms=time_ms(torch, lambda: K6.ssm_scan_bwd_plain(
            dt, x, bm, cm, a, dy), 2),
        library_ms=None,
        bound_ms=max(bytes_ms, ex2_ms),
        bound_by="operations" if ex2_ms > bytes_ms else "bytes",
        bytes_ms=bytes_ms, ex2_floor_ms=ex2_ms, sms=sms, sm_mhz=mhz,
        k6_ms=time_ms(torch, lambda: K6.ssm_scan(dt, x, bm, cm, a), 50),
        k6_chunk_states_ms=time_ms(torch, lambda: K6.ssm_scan(
            dt, x, bm, cm, a, chunk_states=True), 50))
    print(f"K10 ssm_scan_bwd: {case}")
    return case


def k12_case(torch, g, b, s):
    """K12 at zamba2-7b's width (112 heads of 64, N 64, one group) on
    ``b`` rows of S steps (``ssd_inputs``: x, B and C bf16 strided
    slices of a conv-like output), from K11's chunk states, against its
    plain version per gradient (K12_F32_RTOL on d(dt) and da,
    K12_BF16_RTOL on dx, dB, dC); K11 with its chunk states must equal
    K11 without them bit for bit and hold the states
    ``ssd_chunk_states_plain`` gives (K11_H_RTOL); two K12 calls the same
    bits.  Bound: the larger of the bytes (x, B, C, dt, a, dy and the
    chunk states read once, dx, dB, dC, d(dt) and da written once) over
    3.35 TB/s and ~6.5 FMAs (13 f32 operations) a state-step over 67
    TFLOP/s; its dB/dC part buffer, (H, B, S, 2N) f32, is printed apart
    and not in the bound.  No PyTorch call computes it.  Beside it K11's
    ms with and without its chunk states."""
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.kernels.time_kernels import (SSD_H, SSD_N, SSD_P,
                                                  ssd_inputs)
    x, bm, cm, dt, a = ssd_inputs(torch, g, s, b)
    dy = torch.randn(b, s, SSD_H, SSD_P, device="cuda", generator=g)
    y0, h0 = K11.ssd_scan(x, bm, cm, dt, a)
    y1, h1, hc = K11.ssd_scan(x, bm, cm, dt, a, chunk_states=True)
    got = K11.ssd_scan_bwd(x, bm, cm, dt, a, dy, hc)
    again = K11.ssd_scan_bwd(x, bm, cm, dt, a, dy, hc)
    torch.cuda.synchronize()
    if not (torch.equal(y0, y1) and torch.equal(h0, h1)):
        raise SystemExit("K11: its chunk-state output changed y or h_final")
    if not all(torch.equal(u, w) for u, w in zip(got, again)):
        raise SystemExit("K12: two calls on the same inputs differ")
    hc_ref = K11.ssd_chunk_states_plain(x, bm, cm, dt, a)
    ref = K11.ssd_scan_bwd_plain(x, bm, cm, dt, a, dy)
    rel = [((u.float() - w.float()).abs().max()
            / w.float().abs().max()).item() for u, w in zip(got, ref)]
    steps = b * s * SSD_H * SSD_P * SSD_N
    rows = b * s
    nbytes = (rows * SSD_H * SSD_P * (2 + 4 + 2) + hc.numel() * 4
              + rows * SSD_N * 2 * 2 * 2 + rows * SSD_H * 4 * 2
              + SSD_H * 4 * 2)
    bms, by = bound(nbytes, 13 * steps, F32_FLOP_PER_S)
    small = rows <= 512
    case = dict(
        shape=dict(B=b, S=s, H=SSD_H, P=SSD_P, N=SSD_N, G=1,
                   chunk=K11.CHUNK_STATE,
                   layout="x, B, C strided slices of (B, S, 7296)"),
        dtype="x/B/C/dx/dB/dC bf16, dt/a/dy/d(dt)/da f32",
        state_steps=steps, part_buffer_bytes=SSD_H * rows * 2 * SSD_N * 4,
        max_abs_err=max((u.float() - w.float()).abs().max().item()
                        for u, w in zip(got, ref)),
        max_rel_err=max(rel), rel_err_dx_db_dc_ddt_da=rel,
        chunk_states_rel_err=share_of_max(hc, hc_ref),
        ms=time_ms(torch, lambda: K11.ssd_scan_bwd(
            x, bm, cm, dt, a, dy, hc), 20 if s > 512 else 50),
        graph_ms=graph_ms(torch, lambda: K11.ssd_scan_bwd(
            x, bm, cm, dt, a, dy, hc)) if small else None,
        plain_ms=time_ms(torch, lambda: K11.ssd_scan_bwd_plain(
            x, bm, cm, dt, a, dy), 2 if s > 512 else 5),
        library_ms=None, bound_ms=bms, bound_by=by,
        k11_ms=time_ms(torch, lambda: K11.ssd_scan(x, bm, cm, dt, a), 20),
        k11_chunk_states_ms=time_ms(torch, lambda: K11.ssd_scan(
            x, bm, cm, dt, a, chunk_states=True), 20))
    print(f"K12 ssd_scan_bwd: {case}")
    return case


def k8d_case(torch, g, b, s):
    """K3 with its LSE, then K8, at zamba2-7b's shared block (H = KV =
    32, head_dim 112) on bf16 (B, H, S, D) views of (B, S, H, D) tensors,
    in the windowed mode the block trains in (its window of 4,096, longer
    than S), against autograd of K3's plain version; the windowed K3 (out
    and LSE) and K8 must equal the causal ones bit for bit, K3's output
    is unchanged by the LSE, two K8 calls the same bits.  Timed beside
    K8's plain version and autograd through SDPA (causal: the same
    function here)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.time_kernels import (Z_HD, Z_HEADS, Z_WINDOW,
                                                  k3d112_inputs)
    q, k, v = k3d112_inputs(torch, g, s, b)
    do = torch.randn(b, s, Z_HEADS, Z_HD, device="cuda",
                     generator=g).bfloat16().transpose(1, 2)
    out, lse = K3.flash_attention(q, k, v, window=Z_WINDOW, return_lse=True)
    c_out, c_lse = K3.flash_attention(q, k, v, return_lse=True)
    plain_out = K3.flash_attention(q, k, v, window=Z_WINDOW)
    grads = K3.flash_attention_bwd(q, k, v, out, do, lse, window=Z_WINDOW)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse, window=Z_WINDOW)
    causal = K3.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    if not (torch.equal(out, plain_out) and torch.equal(out, c_out)
            and torch.equal(lse, c_lse)):
        raise SystemExit("K3 at head_dim 112: the LSE output changed the "
                         "output, or the window differs from causal")
    if not all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(grads, again, causal)):
        raise SystemExit("K8 at head_dim 112: two calls, or the window and "
                         "causal modes, differ")
    lse_ref = K3.attention_lse_plain(q, k, window=Z_WINDOW)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(
        qr, kr, vr, window=Z_WINDOW), (qr, kr, vr), do)
    rel = [((x.float() - y.float()).abs().max()
            / y.float().abs().max()).item() for x, y in zip(grads, ref)]
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def lib():
        return torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                   retain_graph=True)
    pairs = b * Z_HEADS * s * (s + 1) // 2
    nbytes = 2 * 8 * b * Z_HEADS * s * Z_HD + 4 * b * Z_HEADS * s
    bms, by = bound(nbytes, 10 * Z_HD * pairs, BF16_FLOP_PER_S)
    iters = 20 if s > 512 else 100
    case = dict(
        shape=dict(B=b, H=Z_HEADS, KVH=Z_HEADS, S=s, D=Z_HD,
                   window=Z_WINDOW, layout="(B, S, H, D) views"),
        dtype="bfloat16", visible_pairs=pairs,
        max_abs_err=max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(grads, ref)),
        max_rel_err=max(rel), rel_err_dq_dk_dv=rel,
        lse_max_abs_err=(lse - lse_ref).abs().max().item(),
        ms=time_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, out, do, lse, window=Z_WINDOW), iters),
        plain_ms=time_ms(torch, lambda: K3.flash_attention_bwd_plain(
            q, k, v, out, do, lse, window=Z_WINDOW), max(3, iters // 10)),
        library_ms=time_ms(torch, lib, iters),
        forward_lse_ms=time_ms(torch, lambda: K3.flash_attention(
            q, k, v, window=Z_WINDOW, return_lse=True), iters),
        forward_ms=time_ms(torch, lambda: K3.flash_attention(
            q, k, v, window=Z_WINDOW), iters),
        bound_ms=bms, bound_by=by)
    print(f"K8 flash_attention_bwd (head_dim 112): {case}")
    return case


def phase_zamba2_train_kernels(torch):
    """K12 at K12_SHAPES (``k12_case``, K11's chunk states beside it) and
    K8 at head_dim 112 at K8D_SHAPES (``k8d_case``), each against its
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(28)
    t0 = time.perf_counter()
    k12 = [k12_case(torch, g, b, s) for b, s in K12_SHAPES]
    k8d = [k8d_case(torch, g, b, s) for b, s in K8D_SHAPES]
    print(f"kernels K12 and K8 at head_dim 112: "
          f"{time.perf_counter() - t0:.1f} s")
    bad = [c for c in k12
           if not (max(c["rel_err_dx_db_dc_ddt_da"][3:]) <= K12_F32_RTOL
                   and max(c["rel_err_dx_db_dc_ddt_da"][:3])
                   <= K12_BF16_RTOL
                   and c["chunk_states_rel_err"] <= K11_H_RTOL)] + \
        [c for c in k8d if not (c["max_rel_err"] <= K8_RTOL
                                and c["lse_max_abs_err"] <= K8_LSE_TOL)]
    if bad:
        raise SystemExit(f"K12 / K8 at head_dim 112 disagree with their "
                         f"plain versions: {bad}")
    return k12, k8d


def granite_attn_case(torch, g, b, s):
    """K3, then K3 with its LSE and K8, at granite-moe's attention (H 24
    over KV 8, a GQA group of 3, head_dim 64) on bf16 (B, H, S, D) views
    of (B, S, H, D) tensors: K3 per row against its plain version and K8
    per gradient against autograd of it, K3's LSE against the plain
    log-sum-exp, its output unchanged by the LSE, two calls of each
    bit-equal.  Each timed back to back and replayed from a CUDA graph,
    beside its plain version and SDPA (``enable_gqa``; autograd through
    it for K8), with its bound.  Returns (K3 case, K8 case)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    h, kvh, d = GRANITE_HEADS, GRANITE_KV, GRANITE_HD
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g)
               .bfloat16().transpose(1, 2) for n in (h, kvh, kvh))
    do = torch.randn(b, s, h, d, device="cuda",
                     generator=g).bfloat16().transpose(1, 2)
    out = K3.flash_attention(q, k, v)
    again = K3.flash_attention(q, k, v)
    l_out, lse = K3.flash_attention(q, k, v, return_lse=True)
    grads = K3.flash_attention_bwd(q, k, v, l_out, do, lse)
    g_again = K3.flash_attention_bwd(q, k, v, l_out, do, lse)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(out, l_out)):
        raise SystemExit("K3 at head_dim 64: two calls differ, or the LSE "
                         "output changed the output")
    if not all(torch.equal(x, y) for x, y in zip(grads, g_again)):
        raise SystemExit("K8 at head_dim 64: two calls differ")
    ref = K3.flash_attention_plain(q, k, v)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    g_ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr),
                                (qr, kr, vr), do)
    rel8 = [((x.float() - y.float()).abs().max()
             / y.float().abs().max()).item() for x, y in zip(grads, g_ref)]

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                              enable_gqa=True)
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qs, ks, vs)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                   retain_graph=True)
    pairs = b * h * s * (s + 1) // 2          # visible (query, key, head)
    q_el, kv_el = b * h * s * d, b * kvh * s * d
    bms3, by3 = bound(2 * (2 * q_el + 2 * kv_el), 4 * d * pairs,
                      BF16_FLOP_PER_S)
    bms8, by8 = bound(2 * (4 * q_el + 4 * kv_el) + 4 * b * h * s,
                      10 * d * pairs, BF16_FLOP_PER_S)
    iters = 20 if s > 512 else 200
    shape = dict(B=b, H=h, KVH=kvh, S=s, D=d, layout="(B, S, H, D) views")
    k3c = dict(
        shape=shape, dtype="bfloat16",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        max_rel_err=row_rel_err(out, ref),
        lse_max_abs_err=(lse - K3.attention_lse_plain(q, k)).abs().max()
        .item(),
        ms=time_ms(torch, lambda: K3.flash_attention(q, k, v), iters),
        graph_ms=graph_ms(torch, lambda: K3.flash_attention(q, k, v)),
        lse_ms=time_ms(torch, lambda: K3.flash_attention(
            q, k, v, return_lse=True), iters),
        plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(q, k, v),
                         max(5, iters // 10)),
        library_ms=time_ms(torch, lambda: sdpa(q, k, v), iters),
        library_max_rel_err=row_rel_err(sdpa(q, k, v), ref),
        bound_ms=bms3, bound_by=by3)
    print(f"K3 flash_attention (head_dim 64): {k3c}")
    k8c = dict(
        shape=shape, dtype="bfloat16", visible_pairs=pairs,
        max_abs_err=max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(grads, g_ref)),
        max_rel_err=max(rel8), rel_err_dq_dk_dv=rel8,
        lse_max_abs_err=k3c["lse_max_abs_err"],
        ms=time_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, l_out, do, lse), iters // 2),
        graph_ms=graph_ms(torch, lambda: K3.flash_attention_bwd(
            q, k, v, l_out, do, lse)),
        plain_ms=time_ms(torch, lambda: K3.flash_attention_bwd_plain(
            q, k, v, l_out, do, lse), max(3, iters // 20)),
        library_ms=time_ms(torch, sdpa_bwd, iters // 2),
        bound_ms=bms8, bound_by=by8)
    print(f"K8 flash_attention_bwd (head_dim 64): {k8c}")
    return k3c, k8c


def phase_granite_kernels(torch, short_len: int):
    """K3 and K8 at granite-moe's head_dim 64 (``granite_attn_case``) at
    GRANITE_ATTN_SHAPES and a demo prompt's S, each against its plain
    version.  Returns (K3 cases, K8 cases)."""
    g = torch.Generator(device="cuda").manual_seed(64)
    t0 = time.perf_counter()
    cases = [granite_attn_case(torch, g, b, s)
             for b, s in GRANITE_ATTN_SHAPES + [(1, short_len)]]
    print(f"kernels K3 and K8 at head_dim 64: "
          f"{time.perf_counter() - t0:.1f} s")
    k3, k8 = [c[0] for c in cases], [c[1] for c in cases]
    bad = [c for c in k3 if not (c["max_rel_err"] <= K3_ROW_RTOL
                                 and c["lse_max_abs_err"] <= K8_LSE_TOL)] + \
        [c for c in k8 if not c["max_rel_err"] <= K8_RTOL]
    if bad:
        raise SystemExit(f"K3 / K8 at head_dim 64 disagree with their "
                         f"plain versions: {bad}")
    return k3, k8


def train_counts():
    """Launch counts of the training kernels: K3 and K5 forward, K8 and
    K9 backward, K6 and K10 (the Mamba-1 scan and its backward), K11 and
    K12 (the SSD scan and its backward), and K3's and K8's windowed
    launches."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.moe_lora import kernel as KL
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.kernels.ssm_scan import kernel as K6
    out = {fn.__name__: fn.launches
           for fn in (K3.flash_attention, KL.moe_lora_delta,
                      K3.flash_attention_bwd, KL.moe_lora_delta_bwd,
                      K6.ssm_scan, K6.ssm_scan_bwd, K11.ssd_scan,
                      K11.ssd_scan_bwd)}
    out["flash_attention_windowed"] = K3.flash_attention.windowed_launches
    out["flash_attention_bwd_windowed"] = \
        K3.flash_attention_bwd.windowed_launches
    return out


def step_counts(lm):
    """``train_counts`` of one client step of ``lm``: K5 and K9 once a
    LoRA target of every layer; K3 and K8 once an attention layer pass
    (windowed where the layer has a window: gemma3's local layers,
    zamba2's shared block), K6 and K10 once a Mamba-1 layer, K11 and K12
    once a Mamba-2 layer."""
    from repro_torch.models.attention import layer_window
    targets = sum(len(t) * math.prod(dims)
                  for dims, t in lm.lora_layout().values())
    sites = lm.layer_sites()
    attn = [st for st in sites if not st.ssm]
    scans = len(sites) - len(attn)
    mamba1 = lm.cfg.family == "ssm"
    windowed = sum(bool(layer_window(lm.cfg, st.is_global)) for st in attn)
    return {"flash_attention": len(attn), "moe_lora_delta": targets,
            "flash_attention_bwd": len(attn), "moe_lora_delta_bwd": targets,
            "ssm_scan": scans * mamba1, "ssm_scan_bwd": scans * mamba1,
            "ssd_scan": scans * (not mamba1),
            "ssd_scan_bwd": scans * (not mamba1),
            "flash_attention_windowed": windowed,
            "flash_attention_bwd_windowed": windowed}


def fed_batch(torch, seed, device, b=FED_BATCH, s=FED_SEQ):
    """A client-step batch of ``b`` mixed-task examples at ``s`` tokens,
    on ``device``."""
    from repro_torch.data import pipeline as PIPE
    from repro_torch.data.tasks import TASKS, make_mixed_dataset
    return PIPE.to_torch(PIPE.make_batch(
        make_mixed_dataset(list(TASKS), b, seed), s), device)


def threefry_adapter(torch, lm):
    """(a rank-16 adapter of ``lm`` drawn with the reference's threefry
    tree from key 0, the host seconds it took)."""
    from repro_torch.core import lora as LORA
    from repro_torch.core import prng
    t0 = time.perf_counter()
    adapter = LORA.init_adapter_keyed(lm, prng.key(0), rank=16)
    torch.cuda.synchronize()
    return adapter, time.perf_counter() - t0


def fed_client_step(torch, lm, params, tag="federate (a)", b=FED_BATCH,
                    s=FED_SEQ, limits=(FED_LOSS_RTOL, FED_GRAD_RTOL),
                    scan_rtol=None, scan_f32_ratio=None,
                    other_f32_ratio=None, bf16_bound=(), adapter=None,
                    profile=True, loss_f32=False):
    """One client step at full width (B x S = ``b`` x ``s``) two ways:
    through the kernels (K3/K8, K6/K10 or K11/K12, and K5/K9), and with
    the plain versions called on the same CUDA tensors
    (``flash_attention_train``, ``ssm_scan_train``, ``ssd_scan_train``
    and ``moe_lora_delta_train`` swapped for K3's, K6's, K11's and K5's
    plain versions: autograd's backward, or for the Mamba-1 scan the
    plain backward).  A rank-16 adapter drawn with the reference's
    threefry tree (its host time is printed), B ~ N(0, 0.02^2) so that
    every A and B leaf takes a gradient (``adapter``: one drawn so
    before, ``threefry_adapter``'s pair).  The launches must be
    ``step_counts``; the loss within ``limits[0]``, every leaf's gradient
    within ``limits[1]`` of its max; the kernel step's ms (gradients and
    one AdamW update), peak memory, and a torch.profiler breakdown of one
    more step with the device's busy share (device records only; unless
    not ``profile``: a profiled window costs its leading margin of
    quiet, up to 6.4 s).
    ``limits`` None: the kernel step alone (a finite loss, the
    launches).  With ``scan_rtol`` a third step swaps the LoRA kernels
    (K5/K9) and the attention kernels (K3/K8) for their plain versions
    and keeps only the scan kernels (K6/K10 or K11/K12): its gradients
    must lie within ``scan_rtol`` of the plain step's (the scan kernels'
    share); the kernel step's distance from it (the other kernels'
    share) is printed.  The ``bf16_bound`` leaves (a gradient bf16
    cannot resolve) are printed against the plain step and held to a
    float32 plain step instead (``float32_params``): the kernel step
    within FED_SSM_F32_RATIO times the bf16 plain step's distance from
    it; with ``scan_f32_ratio`` their scan kernels' share is held to that
    multiple of the same distance in place of ``scan_rtol`` (the third
    step runs when either is given), and with ``other_f32_ratio`` the
    other kernels' share (the kernel step against the third) to that
    multiple of it.  With ``loss_f32`` (and ``bf16_bound``) the loss is
    held to the float32 step's instead of the plain one's: within
    ``limits[0]``, or within FED_SSM_F32_RATIO times the bf16 plain
    step's distance from it."""
    from repro_torch.core import lora as LORA
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.moe_lora import kernel as KL
    from repro_torch.kernels.ssd_scan import kernel as K11
    from repro_torch.kernels.ssm_scan import kernel as K6
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS

    adapter, init_s = adapter or threefry_adapter(torch, lm)
    g = torch.Generator(device=lm.device).manual_seed(250)
    for stack in (v for k, v in adapter.items() if not k.startswith("_")):
        for leaf in stack.values():
            leaf["B"].normal_(0.0, 0.02, generator=g)
    body = LORA.bank_for_model(LORA.single_expert_bank(adapter))
    batch = fed_batch(torch, 25, lm.device, b, s)
    gates = torch.ones(1, device=lm.device)
    opt = OPT.adamw(OPT.constant_schedule(5e-3))

    def step():
        loss, grads = TS.value_and_grad(
            lambda b: TS.lora_loss_fn(lm, params, b, batch, gates), body)
        new, _ = opt.update(grads, opt.init(body), body)
        return loss, grads, new

    step()                                      # warm-up
    reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, _ = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernel_counts = train_counts()
    want = step_counts(lm)
    if kernel_counts != want:
        raise SystemExit(f"{tag}: launches {kernel_counts}, expected {want}")
    out = dict(shape=dict(B=b, S=s), loss=float(loss), step_ms=step_ms,
               peak_gib=peak, launches=kernel_counts, adapter_init_s=init_s,
               adapter_params=LORA.count_params(adapter),
               tokens=int(batch["tokens"].numel()))
    if limits is None:
        print(f"{tag} client step: {out}")
        if not math.isfinite(out["loss"]):
            raise SystemExit(f"{tag}: the loss is not finite")
        return out

    def profiled_step():
        with profiled(torch, cpu=False) as prof:
            step()
        return prof
    rows = profile_rows(torch, retaken(tag, profiled_step)) if profile \
        else []
    busy = sum(r[0] for r in rows)
    if profile:
        print(f"{tag} profiled step: device busy {busy:.2f} ms = "
              f"{100 * busy / step_ms:.1f}% of the untraced {step_ms:.2f} "
              f"ms; {sum(r[1] for r in rows)} kernel launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")
    swapped = (L.moe_lora_delta_train, ATT.flash_attention_train,
               SSM.ssm_scan_train, SSM.ssd_scan_train)
    L.moe_lora_delta_train = KL.moe_lora_delta_plain
    ATT.flash_attention_train = K3.flash_attention_plain
    SSM.ssm_scan_train = K6.ssm_scan_train_plain
    SSM.ssd_scan_train = K11.ssd_scan_train_plain
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_loss, p_grads, _ = step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_counts = train_counts()
        if bf16_bound:
            t0 = time.perf_counter()
            with float32_params(torch, params):
                f_loss, f_grads = TS.value_and_grad(
                    lambda b: TS.lora_loss_fn(lm, params, b, batch, gates),
                    body)
            f32_s = time.perf_counter() - t0
    finally:
        (L.moe_lora_delta_train, ATT.flash_attention_train,
         SSM.ssm_scan_train, SSM.ssd_scan_train) = swapped
    if any(plain_counts.values()):
        raise SystemExit(f"{tag}: the plain step launched {plain_counts}")
    shares = scan_rtol is not None or scan_f32_ratio is not None
    if shares:
        L.moe_lora_delta_train = KL.moe_lora_delta_plain
        ATT.flash_attention_train = K3.flash_attention_plain
        try:
            reset_counts()
            _, l_grads, _ = step()
            lora_counts = train_counts()
        finally:
            L.moe_lora_delta_train, ATT.flash_attention_train = swapped[:2]
        want_l = {k: n if k.startswith(("ssm_scan", "ssd_scan")) else 0
                  for k, n in want.items()}
        if lora_counts != want_l:
            raise SystemExit(f"{tag}: the scan-kernels-only step launched "
                             f"{lora_counts}, expected {want_l}")
    loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
    leaf_rel, other_rel, scan_rel, f32 = {}, {}, {}, {}

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max()).item()
    for (stack, st) in sorted(grads.items()):
        for tgt in sorted(st):
            for ab in ("A", "B"):
                x, y = st[tgt][ab], p_grads[stack][tgt][ab]
                name = f"{tgt}.{ab}" if stack == "layers" \
                    else f"{stack}.{tgt}.{ab}"
                if not y.numel():       # a grouped layout's empty tail
                    continue
                leaf_rel[name] = rel(x, y)
                if shares:
                    lx = l_grads[stack][tgt][ab]
                    other_rel[name], scan_rel[name] = rel(x, lx), rel(lx, y)
                if name in bf16_bound:
                    f = f_grads[stack][tgt][ab]
                    f32[name] = dict(kernel_to_plain=leaf_rel.pop(name),
                                     kernel_to_f32=rel(x, f),
                                     plain_to_f32=rel(y, f),
                                     max_abs=y.abs().max().item())
    out.update(plain_loss=float(p_loss), loss_rel_err=loss_rel,
               grad_rel_err=leaf_rel, plain_step_ms=plain_ms)
    if shares:
        out.update(other_kernels_share=other_rel,
                   scan_kernels_share=scan_rel)
    if f32:
        out.update(bf16_bound_leaves=f32, f32_step_s=f32_s,
                   f32_loss=float(f_loss),
                   loss_to_f32=abs(float(loss) - float(f_loss))
                   / abs(float(f_loss)),
                   plain_loss_to_f32=abs(float(p_loss) - float(f_loss))
                   / abs(float(f_loss)))
    if profile:
        out.update(busy_ms=busy, busy_share=busy / step_ms,
                   top_kernels=[(r[0], r[1], r[2][:60]) for r in rows[:6]])
    print(f"{tag} client step: {out}")
    if sorted(f32) != sorted(bf16_bound):
        raise SystemExit(f"{tag}: no gradient for {bf16_bound}")
    def share_ok(n, r, f32_ratio):
        """A share within its multiple of the bf16 plain step's distance
        from float32 where one is given for a float32-held leaf, else
        within ``scan_rtol``."""
        if f32_ratio is not None and n in f32:
            return r <= f32_ratio * f32[n]["plain_to_f32"]
        return scan_rtol is not None and r <= scan_rtol
    bad = [n for n, r in leaf_rel.items() if not r <= limits[1]] + \
        [f"{n}: scan kernels' share" for n, r in scan_rel.items()
         if not share_ok(n, r, scan_f32_ratio)] + \
        [f"{n}: other kernels' share" for n, r in other_rel.items()
         if other_f32_ratio is not None
         and not share_ok(n, r, other_f32_ratio)] + \
        [f"{n} against f32" for n, r in f32.items()
         if not r["kernel_to_f32"] <= FED_SSM_F32_RATIO * r["plain_to_f32"]]
    loss_ok = loss_rel <= limits[0]
    if loss_f32:
        loss_ok = out["loss_to_f32"] <= max(
            limits[0], FED_SSM_F32_RATIO * out["plain_loss_to_f32"])
    if not loss_ok or bad:
        raise SystemExit(f"{tag}: the kernel step disagrees with the "
                         f"plain step: {bad}")
    return out


@contextlib.contextmanager
def captured(module, name):
    """``module.name`` wrapped for the block: each call's (args, kwargs,
    result) is appended to the yielded list; the call itself is
    unchanged (a kernel still launches and counts)."""
    fn = getattr(module, name)
    calls = []

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def float32_params(torch, params):
    """``params`` (a nested dict of CUDA tensors) in float32, in place,
    for the block; then each leaf in its own dtype again (bf16 -> f32 ->
    bf16 is exact).  Leaves are widened one at a time, largest first,
    each old copy's memory released (``empty_cache``) before the next,
    so the card holds the float32 tree alone and not beside the bf16 one
    (zamba2-7b: 60.4 GiB in float32, 30.2 GiB in bf16, on 80 GB)."""
    slots = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                slots.append((tree, k))
    walk(params)
    slots.sort(key=lambda slot: -slot[0][slot[1]].numel())
    dtypes = [d[k].dtype for d, k in slots]

    def cast(to):
        for (d, k), dtype in zip(slots, to):
            d[k] = d[k].to(dtype)
            torch.cuda.empty_cache()
    cast([torch.float32] * len(slots))
    try:
        yield
    finally:
        cast(dtypes)


class ProjectionDraw:
    """E(φ)'s random projection for federate (b) (1.2 G normals from
    numpy's legacy generator at the 2b SLM's width, ~40 s of one core)
    drawn from the script's start by a spawned process, off the path of
    the phases before federate, through the port's ``save_projection``;
    ``install`` waits for it and hands it to ``load_projection``, so
    federate reads the bits its own draw would give."""

    def __init__(self, seed: int, dim: int, n: int):
        from repro_torch.core import lora as LORA
        self.key = (seed, dim)
        self.path = str(ROOT / "build" / "projection")
        (ROOT / "build").mkdir(exist_ok=True)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=LORA.save_projection, args=(self.path, seed, dim, n),
            daemon=True)
        self.t0 = time.perf_counter()
        self.proc.start()

    def running(self) -> bool:
        return self.proc.is_alive()

    def install(self) -> None:
        from repro_torch.core import lora as LORA
        t0 = time.perf_counter()
        self.proc.join()
        if self.proc.exitcode != 0:
            raise SystemExit(f"the projection draw exited "
                             f"{self.proc.exitcode}")
        rows = LORA.load_projection(self.path, *self.key)
        print(f"projection: {rows} x {self.key[1]} rows drawn in a side "
              f"process from {time.perf_counter() - self.t0:.1f} s "
              f"before; waited {time.perf_counter() - t0:.1f} s for it")


def projection_rows(torch) -> int:
    """Rows of E(φ)'s projection that federate (b) reads: the flat size
    of a rank-max adapter of the full-width 2b SLM (A and B of every
    target)."""
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.models.model import LM
    lm = LM(pair_configs("2b", reduced=False)[0])
    r = lm.cfg.lora_rank_max
    return sum(math.prod(dims) * r * (k + n)
               for dims, tgts in lm.lora_layout().values()
               for k, n in tgts.values())


def client_losses(torch, lm, params, sim, fleet, ups, tag):
    """Each training client's loss on its first batch of the round before
    (the frozen base's: the initial adapter's B is zero) and after its
    steps, which must fall."""
    from repro_torch.core import lora as LORA
    from repro_torch.data import pipeline as PIPE
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.training import train_step as TS

    trainer = LocalTrainer(lm, sim.seq_len, sim.batch_size, sim.lr,
                           sim.local_steps)
    gates = torch.ones(1, device=lm.device)
    clients = []
    with torch.no_grad():
        for u in ups:
            client = fleet[u.cid]
            batch = PIPE.to_torch(next(trainer.batches(
                client, sim.seed * 100)), lm.device)
            before = float(TS.masked_cross_entropy(
                lm.train_logits(params, batch)[0], batch["targets"],
                batch["mask"]))
            after = float(TS.lora_loss_fn(
                lm, params, LORA.single_expert_bank(u.adapter), batch,
                gates))
            clients.append(dict(cid=u.cid, device=client.device.name,
                                load=client.background_load, rank=u.rank,
                                loss_before=before, loss_after=after,
                                last_step_loss=u.local_loss))
    for c in clients:
        print(f"{tag} client {c}")
    if not all(c["loss_after"] < c["loss_before"] for c in clients):
        raise SystemExit(f"{tag}: a client's loss did not fall")
    return clients


def federate_gemma3(torch, dep):
    """federate (e): the full-width floe-slm-gemma3 (built as serve_gemma3
    builds it, beside the 2b deployment's LLM and alignment MLP): a
    client step at 4 x 40 and one at 1 x 1,024, where the window of 512
    bites, each against the plain step on the card (K3 and K8 once a
    layer, windowed on the 22 local layers; K5 and K9 six times a
    layer); ``run_simulation`` on FED_SIM, one round: the history, the
    wall time, the launches (``step_counts`` a local step of a training
    client) and each training client's first-batch loss falling; then
    the published bank and its router serving eight of serve_batched's
    requests through the gemma3 pair's batched engine at macro_k 8 (run
    once to capture the graphs, then counted): every request served, K5
    and no K4.  Returns the simulation's launches, the serving launches
    and a summary."""
    from repro_torch.federated import simulation as SIM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    t_start = time.perf_counter()
    g_dep = gemma3_deployment(torch, dep)
    lm, params = g_dep.slm, g_dep.slm_params
    adapter = threefry_adapter(torch, lm)
    # the long step's profile stands for both (a window costs its quiet)
    steps = {f"{b}x{s}": fed_client_step(torch, lm, params,
                                         f"federate (e) {b} x {s}", b, s,
                                         adapter=adapter,
                                         profile=(b, s) != (FED_BATCH,
                                                            FED_SEQ))
             for b, s in ((FED_BATCH, FED_SEQ), FED_GEMMA3_LONG_STEP)}
    del adapter
    sim = SIM.SimConfig(**FED_SIM)
    fleet = SIM.make_fleet(sim)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = SIM.run_simulation(lm, params, sim, fleet)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    counts = train_counts()
    hist = res.server.state.history[-1]
    ups = res.updates_per_round[0]
    per_step = step_counts(lm)
    want = {k: n * len(ups) * sim.local_steps for k, n in per_step.items()}
    print(f"federate (e) run_simulation: {sim_s:.2f} s; history {hist}; "
          f"dropped {res.dropped_per_round}; launches {counts}")
    if not ups or counts != want:
        raise SystemExit(f"federate (e): {len(ups)} clients trained, "
                         f"launches {counts}, expected {want}")
    clients = client_losses(torch, lm, params, sim, fleet, ups,
                            "federate (e)")
    bank = res.server.expert_bank()
    router = res.server.router()
    r_dep = ServingDeployment(lm, params, dep.llm, dep.llm_params, dep.mlp,
                              expert_bank=bank, max_seq=g_dep.max_seq,
                              page_size=16)
    requests = BATCHED_REQUESTS[:8]
    sched = ContinuousBatchScheduler.from_deployment(
        r_dep, batch_size=8, macro_k=8, lazy_pages=True, router=router)
    for p, n in requests:
        sched.submit(p, max_new_tokens=n)
    with TokenIds():
        sched.run()
    eng = sched.engine
    sched = ContinuousBatchScheduler(eng)
    for p, n in requests:
        sched.submit(p, max_new_tokens=n)
    served, wall, launches, calls, peak = run_counted(
        torch, sched, r_dep, ("slm_prefill_packed", "slm_decode"))
    print_batched("federate (e) published bank on the gemma3 pair", served,
                  wall, launches, calls, peak, macro_k=8)
    check_batched_responses("federate (e)", eng, served, requests,
                            n_private=2)
    if len(served) != len(requests) or launches["moe_lora_delta"] <= 0 \
            or launches["moe_lora_delta_slots"] != 0:
        raise SystemExit(f"federate (e): launches {launches}")
    summary = dict(steps=steps, sim_s=sim_s, history=hist,
                   dropped=res.dropped_per_round, clients=clients,
                   experts=len(res.server.state.experts),
                   serve_tokens_per_s=RATES[
                       "federate (e) published bank on the gemma3 pair"],
                   wall_s=time.perf_counter() - t_start)
    print(f"federate (e): {time.perf_counter() - t_start:.1f} s")
    del eng, sched, r_dep, g_dep
    gc.collect()
    return counts, launches, summary


def phase_federate(torch, dep):
    """Federated fine-tuning of the full-width floe-slm-2b on the card (the
    serving deployment's SLM and parameters): (a) ``fed_client_step``;
    (b) ``run_simulation`` on FED_SIM (5 clients, 32 examples each, one
    round of 5 local steps at seq 40, batch 4): the history, the wall
    time, each training client's loss on its first batch before (the
    initial adapter's B is zero, so the frozen base's) and after its
    steps, which must fall, K8/K9 launched 18 x 5 a training client and
    layer kind; (c) one DP client round (clip 1.0, noise 0.5, one local
    step: 19 M host normals), timed, the draw apart; (d) the published
    expert bank and router serving serve_batched's 20 requests through
    the batched engine at macro_k 8 on the router path (run once to
    capture the graphs, then counted): every request served, K5 and no
    K4 in the decode layers, tokens/s; (e) ``federate_gemma3``.  Returns
    the (b) launch counts, (d)'s, a summary, and (e)'s simulation and
    serving launches."""
    from repro_torch.core import dp as DPM
    from repro_torch.core import rank_select as RS
    from repro_torch.federated import simulation as SIM
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.scheduler import ContinuousBatchScheduler
    from repro_torch.core import lora as LORA

    lm, params = dep.slm, dep.slm_params
    step = fed_client_step(torch, lm, params)

    sim = SIM.SimConfig(**FED_SIM)
    fleet = SIM.make_fleet(sim)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = SIM.run_simulation(lm, params, sim, fleet)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    counts = train_counts()
    hist = res.server.state.history[-1]
    ups = res.updates_per_round[0]
    n_layers = lm.cfg.num_layers
    want = len(ups) * sim.local_steps * n_layers
    print(f"federate (b) run_simulation: {sim_s:.2f} s; history {hist}; "
          f"dropped {res.dropped_per_round}; launches {counts}")
    if len(ups) < 2 or counts["flash_attention_bwd"] != want \
            or counts["moe_lora_delta_bwd"] != 6 * want:
        raise SystemExit(f"federate (b): {len(ups)} clients trained, "
                         f"launches {counts}, K8 expected {want}")
    clients = client_losses(torch, lm, params, sim, fleet, ups,
                            "federate (b)")

    spent = []
    privatize = DPM.privatize

    def timed(*a, **kw):
        t = time.perf_counter()
        out = privatize(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out
    DPM.privatize = timed
    try:
        dp_trainer = LocalTrainer(lm, sim.seq_len, sim.batch_size, sim.lr,
                                  1, dp_clip=1.0, dp_noise=0.5)
        lut = RS.build_lut(lm.cfg, tokens_per_step=sim.seq_len
                           * sim.batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp_up = dp_trainer.run_round(fleet[ups[0].cid], params,
                                     res.server.state.global_adapter, lut,
                                     sim.deadline, round_seed=1)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
    finally:
        DPM.privatize = privatize
    if dp_up is None or not math.isfinite(dp_up.local_loss):
        raise SystemExit("federate (c): the DP round failed")
    dp = dict(round_s=dp_s, privatize_s=sum(spent), steps=len(spent),
              noise_values=LORA.count_params(dp_up.adapter),
              loss=dp_up.local_loss)
    print(f"federate (c) DP round: {dp}")

    bank = res.server.expert_bank()
    router = res.server.router()
    r_dep = ServingDeployment(dep.slm, dep.slm_params, dep.llm,
                              dep.llm_params, dep.mlp, expert_bank=bank,
                              max_seq=dep.max_seq, device=dep.device)
    sched = ContinuousBatchScheduler.from_deployment(
        r_dep, batch_size=8, macro_k=8, lazy_pages=True, router=router)
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TokenIds():
        sched.run()
    first_s = time.perf_counter() - t0
    eng = sched.engine
    sched = ContinuousBatchScheduler(eng)
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    served, wall, launches, calls, peak = run_counted(
        torch, sched, r_dep, ("slm_prefill_packed", "slm_decode"))
    print_batched("federate (d) published bank", served, wall, launches,
                  calls, peak, macro_k=8)
    check_batched_responses("federate (d)", eng, served, BATCHED_REQUESTS)
    if len(served) != len(BATCHED_REQUESTS) \
            or launches["moe_lora_delta"] <= 0 \
            or launches["moe_lora_delta_slots"] != 0:
        raise SystemExit(f"federate (d): launches {launches}")
    summary = dict(step=step, sim_s=sim_s, history=hist,
                   dropped=res.dropped_per_round, clients=clients, dp=dp,
                   experts=len(res.server.state.experts),
                   router=[m.name for m in router.experts],
                   serve_first_s=first_s,
                   serve_tokens_per_s=RATES["federate (d) published bank"])
    del eng, sched, r_dep
    gc.collect()
    g_counts, g_launches, summary["gemma3"] = federate_gemma3(torch, dep)
    return counts, launches, summary, g_counts, g_launches


def phase_k7(torch):
    """K7 against its plain version at serve_sampled's shapes, B = 1 and
    8, V = 256,000, two seeds (one past 2**32): ids and perturbed scores
    must be equal bit for bit, and two calls on the same inputs too.
    Timed back to back and replayed from a CUDA graph; the plain version
    (numpy on the host, the card's probabilities copied over) by the
    host clock.  Bound: the larger of the bytes (probs once, the (B,)
    inputs and ids) over 3.35 TB/s, the integer operations (threefry's
    20 rounds and key injections, the uniform's bit operations: 75 an
    element) over 64 INT32 lanes an SM at the card's top SM clock, and
    the f32 operations (three logs, the add: 66 an element) over 67
    TFLOP/s."""
    from repro_torch.kernels.logit_fusion import sample as K7

    g = torch.Generator(device="cuda").manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    cases = []
    for b in (1, 8):
        v = 256_000
        probs, greedy, keys, steps = k7_inputs(torch, g, b, v)
        err, drawn_off = 0.0, 0
        for seed in (0, 2 ** 32 + 3):
            ids, sc = K7.sample_fused(probs, greedy, keys, steps, seed,
                                      scores=True)
            again = K7.sample_fused(probs, greedy, keys, steps, seed)
            torch.cuda.synchronize()
            ref_ids, ref_sc = K7.sample_fused_plain(probs, greedy, keys,
                                                    steps, seed, scores=True)
            if not (torch.equal(ids, again) and torch.equal(ids, ref_ids)
                    and torch.equal(sc.view(torch.int32),
                                    ref_sc.view(torch.int32))):
                raise SystemExit(f"K7 B={b} seed={seed}: ids {ids.tolist()} "
                                 f"vs plain {ref_ids.tolist()}, scores "
                                 f"differ by {(sc - ref_sc).abs().max()}")
            err = max(err, (sc - ref_sc).abs().max().item())
            drawn_off += int((ids != probs.argmax(-1)).sum())
        t0 = time.perf_counter()
        for _ in range(3):
            K7.sample_fused_plain(probs, greedy, keys, steps, 0)
        plain_ms = (time.perf_counter() - t0) / 3 * 1e3
        t_bytes = (b * v * 4 + b * (4 + 4 + 1 + 8)) / HBM_BYTES_PER_S
        t_int = 75 * b * v / (sms * 64 * mhz * 1e6)
        t_f32 = 66 * b * v / F32_FLOP_PER_S
        bms = max(t_bytes, t_int, t_f32) * 1e3
        cases.append(dict(
            shape=[b, v], dtype="float32", max_abs_err=err,
            ids_equal=True, scores_bit_equal=True,
            ids_off_the_argmax=drawn_off,
            ms=time_ms(torch, lambda: K7.sample_fused(
                probs, greedy, keys, steps, 0), 200),
            graph_ms=graph_ms(torch, lambda: K7.sample_fused(
                probs, greedy, keys, steps, 0)),
            plain_ms=plain_ms, library_ms=None, bound_ms=bms,
            bound_by="bytes" if t_bytes >= max(t_int, t_f32)
            else "operations",
            bound_parts_ms=dict(bytes=t_bytes * 1e3, int32=t_int * 1e3,
                                f32=t_f32 * 1e3)))
        print(f"K7 sample_fused: {cases[-1]} ({sms} SMs at {mhz} MHz)")
    return cases


def sampled_requests(requests):
    """serve_sampled's traffic: (prompt, budget, greedy, seed), odd
    requests sampled with seed SAMPLED_SEED + i, even ones greedy."""
    return [(p, n, i % 2 == 0, None if i % 2 == 0 else SAMPLED_SEED + i)
            for i, (p, n) in enumerate(requests)]


class SampledFirstRun:
    """Context of serve_sampled's untimed first run: it records the lanes'
    sampled-graph replays at its end and, on the per-token path, tallies
    through ``dep.sample_batched`` the draws of sampled rows (key id >=
    SAMPLED_SEED) and how many left the argmax of their distribution."""

    def __init__(self, dep, eng):
        self.dep, self.eng = dep, eng
        self.drawn = self.off = 0
        self.sample_replays = 0

    def __enter__(self):
        import numpy as np
        dep, draw = self.dep, self.dep.sample_batched

        def tally(probs, keys, steps):
            ids = draw(probs, keys, steps)
            mine = np.asarray(keys) >= SAMPLED_SEED
            off = ids.cpu().numpy() != probs.argmax(-1).cpu().numpy()
            self.drawn += int(mine.sum())
            self.off += int((mine & off).sum())
            return ids
        dep.sample_batched = tally
        return self

    def __exit__(self, *exc):
        del self.dep.sample_batched
        self.sample_replays = self.eng.macro_stats()["sample_replays"]


def phase_serve_sampled(torch, dep, greedy_res):
    """serve_batched's 20 requests with the odd ones sampled (seed 2000 +
    i), at macro_k 0 and 8, each engine run untimed first (which
    captures both graphs of each lane at K = 8).  K = 8 must equal K = 0
    on every request admitted in the same group; K7 launches once per
    per-token step with a sampled live row at K = 0 and K times per
    sampled-graph replay at K = 8.  Returns {K: launches}."""
    from repro_torch.serving.engine import BatchedHybridEngine

    reqs = sampled_requests(BATCHED_REQUESTS)
    out, runs = {}, {}
    for k in (0, 8):
        eng = None
        gc.collect()
        eng = BatchedHybridEngine(deployment=dep, batch_size=8, macro_k=k,
                                  lazy_pages=True)
        first = SampledFirstRun(dep, eng)
        res, wall, launches, _, peak, _, first_s, groups = \
            serve_macro_run(torch, eng, reqs, dep, first=first)
        st = eng.macro_stats()
        tag = f"serve_sampled (macro_k={k})"
        print_batched(tag, res, wall, launches, {}, peak, macro_k=k)
        check_batched_responses(tag, eng, res, reqs)
        sampled = [r for r, (_, _, greedy, _) in zip(res, reqs)
                   if not greedy]
        moved = sum(a.text != b.text for a, b in zip(
            sampled, [greedy_res[r.rid] for r in sampled]))
        print(f"{tag}: {sum(r.stats.tokens for r in res)} tokens in "
              f"{wall:.3f} s = {sum(r.stats.tokens for r in res) / wall:.2f}"
              f" tokens/s; first run {first_s:.3f} s; sampled graphs' "
              f"capture {st['sample_capture_s']:.3f} s (all graphs "
              f"{st['capture_s']:.3f} s); sampled-graph replays "
              f"{st['sample_replays']} of {st['replays']}; peak {peak:.2f} "
              f"GiB; K7 launches {launches['sample_fused']}; "
              + (f"first run: {first.off} of {first.drawn} draws of sampled "
                 f"rows left the argmax; " if k == 0 else "")
              + f"{moved} of {len(sampled)} sampled requests differ from "
              f"their greedy tokens in serve_batched")
        if k:
            timed = st["sample_replays"] - first.sample_replays
            if launches["sample_fused"] != k * timed or timed <= 0:
                raise SystemExit(f"{tag}: K7 launched "
                                 f"{launches['sample_fused']} times over "
                                 f"{timed} sampled replays")
        elif launches["sample_fused"] <= 0:
            raise SystemExit(f"{tag}: the sampler never launched")
        if eng.resident_kv_bytes() != 0:
            raise SystemExit(f"{tag}: pages leaked")
        if k:
            retaken("trace_batched",
                    lambda: trace_batched(torch, eng, sampled=True), eng)
        out[k], runs[k] = launches, (res, groups)
    (res0, g0), (res8, g8) = runs[0], runs[8]
    match = [g0[r.rid] == g8[r.rid] for r in res8]
    equal = [same_response(a, b) for a, b in zip(res0, res8)]
    print(f"serve_sampled: {sum(match)} of {len(res8)} requests admitted in "
          f"the same group at K = 8 as at K = 0, {sum(equal)} equal to the "
          f"K = 0 run bit for bit")
    bad = [r.rid for r, m, e in zip(res8, match, equal) if m and not e]
    if bad:
        raise SystemExit(f"serve_sampled: requests {bad} admitted in the "
                         "same group differ from the K = 0 run")
    return out


class FlatFusion:
    """Within the block the deployment's fusion returns the uniform
    distribution over the vocabulary on every path (sequential,
    per-token, macro step): a test double, as the reference's sampling
    tests stub theirs, so that the keyed draws spread and can be held
    against the plain sampler on the host."""

    def __init__(self, torch, dep):
        self.torch, self.dep = torch, dep

    def __enter__(self):
        torch, v = self.torch, self.dep.slm.cfg.vocab_size

        def flat(sl, ll, arrived):
            b = sl.shape[0]
            return (torch.full((b, v), 1.0 / v, device=sl.device),
                    torch.ones((b,), device=sl.device))
        self.dep.fuse_mask = flat
        return self

    def __exit__(self, *exc):
        del self.dep.fuse_mask


def plain_flat_ids(torch, v, keyed_lengths):
    """{key id: the plain sampler's ids at steps 0..n-1} on the uniform
    distribution over v ids, on the host, for {key id: n}."""
    from repro_torch.kernels.logit_fusion import sample as K7
    rows = [(key, t) for key, n in keyed_lengths.items() for t in range(n)]
    ids = []
    for lo in range(0, len(rows), 16):
        part = rows[lo:lo + 16]
        flat = torch.full((len(part), v), 1.0 / v)
        ids += K7.sample_fused_plain(flat, None, [r[0] for r in part],
                                     [r[1] for r in part], 0).tolist()
    out = {}
    for (key, _), tok in zip(rows, ids):
        out.setdefault(key, []).append(tok)
    return out


def phase_flat_keys(torch, dep, tag, n_req, budget):
    """The first ``n_req`` serve_sampled requests at ``budget`` tokens
    under FlatFusion through the sequential engine (Scheduler) and the
    batched engine at K = 0 and K = 8: every token of a sampled cloud
    request must be the plain sampler's id for its (seed, key id,
    step), every greedy cloud token id 0 (the argmax of a flat row); a
    private request (its own SLM distribution) must agree between K = 0
    and K = 8 where admitted in the same group.  Returns {path:
    launches}."""
    from repro_torch.core.privacy import PrivacyDetector
    from repro_torch.serving.engine import BatchedHybridEngine
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               Scheduler)

    reqs = [(p, budget, greedy, seed) for p, _, greedy, seed
            in sampled_requests(BATCHED_REQUESTS[:n_req])]
    det = PrivacyDetector()
    runs, out = {}, {}
    with FlatFusion(torch, dep):
        for path in ("sequential", 0, 8):
            if path == "sequential":
                sched = Scheduler.from_deployment(dep)
            else:
                sched = ContinuousBatchScheduler(BatchedHybridEngine(
                    deployment=dep, batch_size=8, macro_k=path,
                    lazy_pages=True))
            for p, n, greedy, seed in reqs:
                sched.submit(p, max_new_tokens=n, greedy=greedy, seed=seed)
            reset_counts()
            with TokenIds(), AdmissionGroups() as groups:
                res = sched.run()
            torch.cuda.synchronize()
            out[path] = {fn.__name__: fn.launches for fn in all_kernels()}
            runs[path] = (res, groups.of_rid)
    lengths = {seed: budget for p, _, greedy, seed in reqs
               if not greedy and not det.detect(p)}
    want = plain_flat_ids(torch, dep.slm.cfg.vocab_size, lengths)
    checked = dict.fromkeys(runs, 0)
    for path, (res, _) in runs.items():
        for r, (p, _, greedy, seed) in zip(res, reqs):
            ids = [int(x) for x in r.text.split(",") if x]
            if det.detect(p):
                continue
            ok = (ids == [0] * len(ids) if greedy
                  else ids == want[seed][:len(ids)])
            if not ok or not ids or (len(ids) < budget
                                     and ids[-1] != 2):
                raise SystemExit(f"{tag} {path}: rid {r.rid} ids {ids}, "
                                 f"plain {want.get(seed)}")
            checked[path] += 0 if greedy else len(ids)
        if out[path]["sample_fused"] <= 0:
            raise SystemExit(f"{tag} {path}: the sampler never launched")
    (res0, g0), (res8, g8) = runs[0], runs[8]
    bad = [a.rid for a, b in zip(res0, res8)
           if det.detect(reqs[a.rid][0]) and g0[a.rid] == g8[a.rid]
           and a.text != b.text]
    if bad:
        raise SystemExit(f"{tag}: private requests {bad} differ between "
                         "K = 0 and K = 8")
    k7 = {p: o["sample_fused"] for p, o in out.items()}
    print(f"{tag}: sampled cloud tokens equal to the plain sampler's ids "
          f"on the host (sequential engine, batched K = 0, K = 8): "
          f"{checked}; K7 launches {k7}")
    return {f"{tag}_{p if p == 'sequential' else f'k{p}'}": o
            for p, o in out.items()}


class ProfileLost(Exception):
    """A profiled window lost one of the two marker kernels at its
    edges, so its device records cannot be read as complete."""


def retaken(what, fn, eng=None):
    """``fn()``, taken again, after draining ``eng``, while a profiled
    window in it loses an edge (``ProfileLost``), at most PROFILE_TRIES
    times.  A window that keeps both markers is read, and its checks
    hold their exact counts."""
    for _ in range(PROFILE_TRIES):
        try:
            return fn()
        except ProfileLost as lost:
            print(f"{what}: {lost}; taken again at margins "
                  f"{PROFILE_MARGINS_S} s")
            while eng is not None and eng.active_count():
                eng.step()
    raise SystemExit(f"{what}: {PROFILE_TRIES} profiled windows in a row "
                     "lost an edge")


@contextlib.contextmanager
def profiled(torch, cpu: bool = True):
    """torch.profiler over the block, CPU (unless ``cpu`` is False: the
    device's kernels and the runtime's launch calls only, which a window
    of ~100,000 kernels reads in a fraction of the time) and CUDA, between two marker
    kernels (``torch.cuda._sleep``, left out of ``profile_rows``), each
    alone on the card, with PROFILE_MARGINS_S of quiet before and after.
    On the H100 a window has lost the device records of its first
    milliseconds (the sampled K = 8 boundary once held 30 of its 32 K7
    kernels), and windows have lost their leading marker at leading
    margins of 0.1, 0.4 and 1.6 s alike, their kept records starting a
    few milliseconds into the block; so PROFILE_PAD spin kernels open
    the window before the marker, for it to lose instead.  A window
    whose records before the block's first are not spins ending with a
    marker, or whose last record is not a marker, lost that edge: ``ProfileLost`` is raised (with the first
    kept record's offset from the first launch) and that side's margin
    widened x4 for every later window (``retaken`` takes the block
    again), up to PROFILE_MARGIN_MAX_S."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    margins = dict(PROFILE_MARGINS_S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        time.sleep(margins["leading"])
        for _ in range(PROFILE_PAD[0]):
            torch.cuda._sleep(PROFILE_PAD[1])
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(margins["trailing"])
    ev = device_records(prof)
    spin = ["spin_kernel" in name for _, _, name in ev]
    marker = [m and us < PROFILE_MARKER_MAX_US
              for m, (_, us, _) in zip(spin, ev)]
    first = spin.index(False) if False in spin else len(ev)
    if first == len(ev):        # no device record of the block
        edges = (sum(marker) >= 2, bool(marker) and marker[-1])
    else:
        edges = (first > 0 and marker[first - 1], marker[-1])
    lost = [side for side, ok in zip(("leading", "trailing"), edges)
            if not ok]
    if lost:
        for side in lost:
            PROFILE_MARGINS_S[side] = min(PROFILE_MARGIN_MAX_S, max(
                PROFILE_MARGINS_S[side], 4 * margins[side]))
        launches = [e.start_ns() / 1e3 for e in raw_records(prof)
                    if e.device_type() == DeviceType.CPU
                    and e.name().startswith(("cudaLaunchKernel",
                                             "cuLaunchKernel"))]
        seen = (f"; its first device record {ev[0][2][:32]} "
                f"{(ev[0][0] - min(launches)) / 1e3:.3f} ms "
                f"after its first launch" if ev and launches else "")
        raise ProfileLost(f"the profiled window at margins {margins} s "
                          f"kept {sum(marker)} edge markers and "
                          f"{sum(spin) - sum(marker)} of {PROFILE_PAD[0]} "
                          f"padding records and lost its "
                          f"{' and '.join(lost)} edge{seen}")


def raw_records(prof):
    """The profiler's own records of a finished window.  Read them, not
    ``prof.events()`` or ``key_averages()``: those first build a Python
    event tree over every record and link each kernel to its launch,
    seconds for a window of a full-width SLM request, to give the same
    starts, durations and names (``check_profile_readers``)."""
    return prof.profiler.kineto_results.events()


def device_records(prof):
    """(start us, duration us, name) of a profile's device records, in
    time order."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns() / 1e3, e.duration_ns() / 1e3, e.name())
                  for e in raw_records(prof)
                  if e.device_type() == DeviceType.CUDA)


def check_profile_readers(torch):
    """``profile_rows`` (the raw records) against the same rows through
    ``key_averages()`` on one small window (GEMMs, casts, a K3 call):
    the same names and counts, the same times within 1e-9."""
    from torch.autograd import DeviceType
    from repro_torch.kernels.flash_attention import kernel as K3
    x = torch.randn(256, 256, device="cuda")
    q, k, v = (torch.randn(1, 8, 64, 64, device="cuda").bfloat16()
               for _ in range(3))
    with profiled(torch, cpu=False) as prof:
        for _ in range(20):
            (x @ x).bfloat16()
            K3.flash_attention(q, k, v)
    rows = profile_rows(torch, prof)
    ref = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and "spin_kernel" not in e.key), reverse=True)
    got = {name: (ms, n) for ms, n, name in rows}
    want = {name: (ms, n) for ms, n, name in ref}
    if got.keys() != want.keys() or any(
            got[k][1] != want[k][1]
            or abs(got[k][0] - want[k][0]) > 1e-9 * want[k][0]
            for k in want):
        raise SystemExit(f"profile rows from the raw records {rows} differ "
                         f"from key_averages' {ref}")
    print(f"profile readers: {len(rows)} rows, {sum(r[1] for r in rows)} "
          f"kernels, equal through the raw records and key_averages")


def graph_launches(prof) -> int:
    """CUDA graph launches recorded in a profile."""
    return sum("GraphLaunch" in e.name() for e in raw_records(prof))


def profile_edges(torch, prof, n: int = 8) -> str:
    """The first and last ``n`` device kernels of a profile, in time
    order, with their start in microseconds from the first one: what a
    count that misses should be read against."""
    ev = device_records(prof)
    if not ev:
        return "no device records"
    t0 = ev[0][0]
    return f"{len(ev)} device records; " + "; ".join(
        f"{e[0] - t0:.1f} us {e[2][:48]}"
        for e in ev[:n] + [None] + ev[-n:] if e is not None)


def kernel_offsets(prof, name: str):
    """Start times, in microseconds from the profile's first device
    record, of the device records whose name holds ``name``."""
    ev = device_records(prof)
    t0 = ev[0][0] if ev else 0
    return [round(e[0] - t0) for e in ev if name in e[2]]


def profile_rows(torch, prof):
    """Device-kernel rows (ms, count, name) of a profile, largest first:
    an operator's row repeats its kernels' time, so only kernels, and
    not the edge markers (spin kernels, ``profiled``)."""
    rows = {}
    for _, us, name in device_records(prof):
        row = rows.setdefault(name, [0.0, 0])
        row[0] += us
        row[1] += 1
    return sorted(((us / 1e3, n, name) for name, (us, n) in rows.items()
                   if us > 0 and "spin_kernel" not in name), reverse=True)


def trace_batched(torch, eng, sampled=False):
    """Device time by kernel and the device's busy share over two batched
    boundary steps: 8 cloud rows (the long prompt among them) and 4
    private rows decoding one token each (K tokens each on a macro-step
    engine), then the tail of a run — 3 short cloud rows among the parked
    rows of the drained lane.  ``sampled``: the first step only, with
    every other row sampled (seed SAMPLED_SEED + i), so both lanes
    replay their sampled graphs."""
    reqs = [(p, 40) for p, _ in BATCHED_REQUESTS]
    cloud = [r for r in reqs if not eng.detector.detect(r[0])][:8]
    private = [r for r in reqs if eng.detector.detect(r[0])]
    flags = eng.add_requests([
        (p, n, not (sampled and i % 2), 500 + i, SAMPLED_SEED + i)
        for i, (p, n) in enumerate(cloud + private)])
    if not all(flags):
        raise SystemExit("trace: a request was not admitted")
    profile_step(torch, eng, "one boundary step (8 cloud + 4 private rows"
                 + (", every other one sampled)" if sampled else ")"),
                 sampled)
    while eng.active_count():
        eng.step()
    if sampled:
        return
    tail = [(p, 40, True, 600 + i) for i, (p, _) in enumerate(cloud[1:4])]
    if not all(eng.add_requests(tail)):
        raise SystemExit("trace: a tail request was not admitted")
    profile_step(torch, eng, "one tail step (3 short cloud rows, 5 "
                 "parked)")
    while eng.active_count():
        eng.step()


def profile_step(torch, eng, what: str, sampled: bool = False):
    """Warm-up steps (three, or one macro step), then one boundary step
    timed untraced and one under torch.profiler: wall, device busy
    share, K2's and K1's device time and launches, the graph launches
    and the top kernels.  On a macro-step engine every non-idle lane
    must replay its graph once a step, K2 launch K x its decode layers
    a step (in the graph, by the replay-aware count and in the profile)
    and K1 K times a cloud-lane replay (by the replay-aware count, and
    in the profile as K fuse_stats and K fuse_write kernels); K7 (two
    kernels a call) K times a busy lane's replay when ``sampled``, else
    never."""
    from repro_torch.kernels.logit_fusion.kernel import fuse_logits
    from repro_torch.kernels.paged_attention import kernel as K2

    k = eng.macro_k
    for _ in range(1 if k else 3):
        eng.step()
    busy_lanes = [lane for lane in (eng.cloud_lane, eng.edge_lane)
                  if lane.active]

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    r0, n0 = macro_replays(eng), (K2.paged_decode_attention.launches,
                                  fuse_logits.launches)
    wall_ms = one()
    r1 = macro_replays(eng)
    replays = [b - a for a, b in zip(r0, r1)]
    counted_k2 = K2.paged_decode_attention.launches - n0[0]
    counted_k1 = fuse_logits.launches - n0[1]
    with profiled(torch) as prof:
        traced_ms = one()
    traced_replays = [b - a for a, b in zip(r1, macro_replays(eng))]
    rows = profile_rows(torch, prof)
    graphs = graph_launches(prof)
    busy = sum(r[0] for r in rows)
    k2 = [r for r in rows if "paged_decode" in r[2]]
    k1 = [r for r in rows if "fuse_" in r[2]]
    k7 = [r for r in rows if "sample_partial" in r[2]
          or "sample_select" in r[2]]
    # a K2 call is two kernels, its split pass and its combine pass
    k2_launches = sum(r[1] for r in k2 if "paged_decode_split" in r[2])
    # and a K1 call two, its per-chunk stats and its write
    k1_passes = [sum(r[1] for r in k1 if p in r[2])
                 for p in ("fuse_stats", "fuse_write")]
    print(f"trace_batched{f' (macro_k={k})' if k else ''}: {what}: "
          f"{wall_ms:.2f} ms untraced, {traced_ms:.2f} ms traced; device "
          f"busy {busy:.2f} ms = {100 * busy / wall_ms:.1f}% of the "
          f"untraced wall; K2 {sum(r[0] for r in k2):.3f} ms over "
          f"{k2_launches} calls ({sum(r[1] for r in k2)} kernels); K1 "
          f"{sum(r[0] for r in k1):.4f} ms over {sum(r[1] for r in k1)} "
          f"kernels; K7 {sum(r[0] for r in k7):.4f} ms over "
          f"{sum(r[1] for r in k7)} kernels; "
          f"{sum(r[1] for r in rows)} kernel launches; {graphs} graph "
          f"launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")
    if not k:
        return
    want = sum(k * lane_layers(lane) for lane in busy_lanes)
    want_k1 = k * int(eng.cloud_lane in busy_lanes)
    want_k7 = 2 * k * len(busy_lanes) if sampled else 0
    if sum(r[1] for r in k7) != want_k7:
        raise SystemExit(f"trace_batched (macro_k={k}): {what}: K7 "
                         f"kernels {sum(r[1] for r in k7)}, expected "
                         f"{want_k7}, at {kernel_offsets(prof, 'sample_')} "
                         f"us; {profile_edges(torch, prof)}")
    per_lane = [lane._macro.per_replay(K2.paged_decode_attention)
                for lane in busy_lanes]
    one_each = [int(lane in busy_lanes)
                for lane in (eng.cloud_lane, eng.edge_lane)]
    if per_lane != [k * lane_layers(lane) for lane in busy_lanes] \
            or replays != one_each or traced_replays != one_each \
            or graphs != len(busy_lanes) or counted_k2 != want \
            or k2_launches != want or counted_k1 != want_k1 \
            or k1_passes != [want_k1, want_k1]:
        raise SystemExit(f"trace_batched (macro_k={k}): {what}: K2 per "
                         f"lane graph {per_lane}, replays {replays} and "
                         f"{traced_replays} traced, graph launches "
                         f"{graphs}, K2 counted {counted_k2} and profiled "
                         f"{k2_launches}, K1 counted {counted_k1} and "
                         f"profiled (stats, write) {k1_passes}; expected "
                         f"K2 {want}, K1 {want_k1} and one replay per "
                         f"busy lane ({len(busy_lanes)}); "
                         f"{profile_edges(torch, prof)}")


def trace(torch, engine):
    """Device time by kernel and the device's busy share over one
    cloud-eligible request (16 tokens), from ``torch.profiler`` (device
    records only, ``profiled(cpu=False)``)."""
    from repro_torch.launch.serve import DEMO_PROMPTS

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(DEMO_PROMPTS[2], 16, rid=99)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = one()
    with profiled(torch, cpu=False) as prof:
        traced_ms = one()
    rows = profile_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    print(f"trace: one cloud request of 16 tokens: {wall_ms:.2f} ms "
          f"untraced, {traced_ms:.2f} ms traced; device busy {busy:.2f} ms "
          f"= {100 * busy / wall_ms:.1f}% of the untraced wall; "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")


def mode_by_path(paths, key):
    """{path: count} of a per-mode count on the paths that read it:
    every serving path but serve_ssm, which runs no attention."""
    return {path: got[key] for path, got in paths.items() if key in got}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.data import tokenizer as TOK
    from repro_torch.launch.serve import DEMO_PROMPTS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = smi()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t_run = time.perf_counter()

    def clock(phase):
        """The run's clock after ``phase``: where its time goes, and
        whether the projection's side process still runs beside it."""
        note = "; projection draw running" if projection.running() else ""
        print(f"clock: {phase} done at {time.perf_counter() - t_run:.1f} s"
              f"{note}")

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    projection = ProjectionDraw(0, 64, projection_rows(torch))
    for k, r in report.items():
        used = [ln.strip() for ln in r["ptxas"].splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"  {k}: {r['seconds']:.2f} s; {used}")

    long_len = len(TOK.encode(LONG_PROMPT + " "))
    k1_cases, k3_cases = phase_kernels(torch, long_len)
    k3_offset_cases = phase_k3_offset(torch)
    k2_cases = phase_k2(torch)
    k4_cases, k5_cases = phase_lora(torch)
    short_len = len(TOK.encode(DEMO_PROMPTS[0] + " "))
    z4_cases, z5_cases, z9_cases = phase_lora_model(
        torch, short_len, "zamba2", ZAMBA2_LORA_SHAPES, 27)
    g4_cases, g5_cases, g9_cases = phase_lora_model(
        torch, short_len, "granite", GRANITE_LORA_SHAPES, 29)
    k4_cases += z4_cases + g4_cases
    k5_cases += z5_cases + g5_cases
    k6_cases = phase_k6(torch, short_len)
    k11_cases = phase_k11(torch, short_len)
    k3d_cases = phase_k3_d112(torch, short_len)
    k7_cases = phase_k7(torch)
    k8_cases, k9_cases, k8w_cases, k10_cases = phase_train_kernels(torch)
    k9_cases += z9_cases + g9_cases
    k12_cases, k8d_cases = phase_zamba2_train_kernels(torch)
    k3g_cases, k8g_cases = phase_granite_kernels(torch, short_len)
    check_profile_readers(torch)
    clock("kernels")
    phase_check(torch)
    clock("check")
    phase_cli()
    clock("cli")
    ssm_launches, ssm_run, ssm_train = phase_serve_ssm(torch)
    clock("serve_ssm")
    # each model is freed before the next is built
    gc.collect()
    torch.cuda.empty_cache()
    z_launches, z_run, z_lora, z_train = phase_serve_zamba2(torch)
    clock("serve_zamba2")
    gc.collect()
    torch.cuda.empty_cache()
    g_launches, g_run, g_lora, g_train = phase_serve_granite(torch)
    clock("serve_granite")
    gc.collect()
    torch.cuda.empty_cache()
    dep = full_pair(torch)
    seq_launches = phase_serve(torch, dep)
    clock("serve")
    k0_launches, k0_res, k0_groups = phase_serve_batched(torch, dep)
    clock("serve_batched")
    plain_ids = [r.text for r in k0_res]
    macro_launches, eng8, k8_res, k8_groups = phase_serve_macro(
        torch, dep, k0_res, k0_groups)
    # the main path is the engine's default, the K = 8 macro step
    launches = macro_launches[8]
    retaken("trace_batched", lambda: trace_batched(torch, eng8), eng8)
    del eng8
    clock("serve_macro")
    sampled = phase_serve_sampled(torch, dep, k0_res)
    clock("serve_sampled")
    flat = phase_flat_keys(torch, dep, "flat_keys", 8, 8)
    clock("flat_keys")
    ad_runs = phase_serve_adapters(torch, dep, plain_ids)
    clock("serve_adapters")
    router_run = phase_serve_router(torch, dep, plain_ids)
    clock("serve_router")
    gemma3_paths = phase_serve_gemma3(torch, dep)
    clock("serve_gemma3")
    # dense lanes and pool pressure on the 2b pair last, after every
    # profiled boundary
    gc.collect()
    dense = phase_serve_dense(torch, dep, {0: k0_res, 8: k8_res})
    clock("serve_dense")
    pressure = phase_serve_pool_pressure(torch, dep)
    clock("serve_pool_pressure")
    gc.collect()
    prefix = phase_serve_prefix(torch, dep)
    clock("serve_prefix")
    long_paths = phase_serve_long(torch, dep)
    clock("serve_long")
    gc.collect()
    fault_paths, f_dep = phase_serve_faults(torch, dep)
    clock("serve_faults")
    spec_paths = phase_serve_spec(torch, dep, f_dep, {
        0: (k0_res, k0_groups), 8: (k8_res, k8_groups)})
    del f_dep
    clock("serve_spec")
    gc.collect()
    projection.install()
    fed_counts, fed_serve, fed, g_fed_counts, g_fed_serve = \
        phase_federate(torch, dep)
    clock("federate")
    paths = {"serve": seq_launches, "serve_batched": launches,
             "serve_batched_k0": k0_launches,
             "serve_batched_k1": macro_launches[1],
             "serve_adapters_k5": ad_runs[False]["launches"],
             "serve_adapters_k4": ad_runs[True]["launches"],
             "serve_adapters_k4_macro": ad_runs["macro"]["launches"],
             "serve_router": router_run["launches"],
             "serve_router_sequential": router_run["seq_launches"],
             "serve_ssm": ssm_launches, "serve_sampled": sampled[8],
             "serve_sampled_k0": sampled[0], "serve_dense": dense[8],
             "serve_dense_k0": dense[0],
             "serve_pool_pressure": pressure[8],
             "serve_pool_pressure_k0": pressure[0], **flat,
             **gemma3_paths, **prefix, **long_paths, **fault_paths,
             **spec_paths, "federate": fed_counts,
             "federate_serve": fed_serve,
             "serve_ssm_train": ssm_train["a"]["launches"],
             "serve_ssm_train_long": ssm_train["b"]["launches"],
             "serve_ssm_adapters": ssm_train["serve_ssm_adapters"],
             "serve_ssm_router": ssm_train["serve_ssm_router"],
             "serve_zamba2": z_launches, **z_lora,
             "serve_zamba2_train": z_train["d"]["launches"],
             "serve_zamba2_train_long": z_train["e"]["launches"],
             "serve_zamba2_packed": {k: v for k, v in z_train["f"].items()
                                     if isinstance(v, int)},
             "serve_granite": g_launches, **g_lora,
             "serve_granite_train": g_train["launches"],
             "federate_gemma3": g_fed_counts,
             "federate_gemma3_serve": g_fed_serve}
    by_path = {fn.__name__: {path: got.get(fn.__name__, 0)
                             for path, got in paths.items()}
               for fn in all_kernels()}
    lora_paths = ("serve_adapters_k5", "serve_adapters_k4",
                  "serve_adapters_k4_macro", "serve_router")

    # (8, V) f32; H=16, S=2048, B=1; LLM B=8, plain table
    k1, k3, k2 = k1_cases[-1], k3_cases[5], k2_cases[2]
    kernels = [
        dict(name="fuse_logits", route="cuda",
             source="src/repro_torch/kernels/csrc/fuse_logits.cu",
             replaces="src/repro/kernels/logit_fusion/kernel.py:45",
             launches=launches["fuse_logits"],
             launches_by_path=by_path["fuse_logits"],
             max_abs_err=max(c["max_abs_err"] for c in k1_cases),
             max_rel_err=max(c["max_rel_err"] for c in k1_cases),
             rel_tol=K1_RTOL, shape=k1["shape"], ms=k1["ms"],
             graph_ms=k1["graph_ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, cases=k1_cases),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:132",
             launches=launches["paged_decode_attention"],
             launches_by_path=by_path["paged_decode_attention"],
             ring_launches_by_path=mode_by_path(
                 paths, "paged_decode_attention_ring"),
             window_launches_by_path=mode_by_path(
                 paths, "paged_decode_attention_window"),
             max_abs_err=max(c["max_abs_err"] for c in k2_cases),
             max_rel_err=max(c["max_rel_err"] for c in k2_cases),
             rel_tol=K2_ROW_RTOL, shape=k2["shape"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, cases=k2_cases),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:80",
             launches=launches["flash_attention"],
             launches_by_path=by_path["flash_attention"],
             windowed_launches_by_path=mode_by_path(
                 paths, "flash_attention_windowed"),
             offset_launches_by_path=mode_by_path(
                 paths, "flash_attention_offset"),
             max_abs_err=max(c["max_abs_err"] for c in k3_cases),
             max_rel_err=max(c["max_rel_err"] for c in k3_cases),
             rel_tol=K3_ROW_RTOL, shape=k3["shape"], ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             cases=k3_cases),
        # K3's history-offset mode (the same kernel, a second KV source)
        # at the COW suffix of the LLM; launches on serve_prefix at K 8
        dict(name="flash_attention_offset", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:80",
             note="the reference's Pallas kernel takes q_len == kv_len "
                  "only; it computes this case in jnp "
                  "(src/repro/models/attention.py:327-342)",
             launches=prefix["serve_prefix"]["flash_attention_offset"],
             launches_by_path=mode_by_path(paths, "flash_attention_offset"),
             max_abs_err=max(c["max_abs_err"] for c in k3_offset_cases),
             max_rel_err=max(c["max_rel_err"] for c in k3_offset_cases),
             rel_tol=K3_ROW_RTOL, shape=k3_offset_cases[0]["shape"],
             ms=k3_offset_cases[0]["ms"],
             plain_ms=k3_offset_cases[0]["plain_ms"],
             bound_ms=k3_offset_cases[0]["bound_ms"],
             bound_by=k3_offset_cases[0]["bound_by"],
             library_ms=k3_offset_cases[0]["library_ms"],
             cases=k3_offset_cases),
    ]
    # K4 and K5 at mlp_in (k 2048, n 32768, the largest bank share),
    # T = 8; launches summed over the LoRA serving paths
    for fn_name, cases, line in (
            ("moe_lora_delta_slots", k4_cases, 108),
            ("moe_lora_delta", k5_cases, 53)):
        main_case = cases[2]
        kernels.append(dict(
            name=fn_name, route="cuda",
            source="src/repro_torch/kernels/csrc/moe_lora.cu",
            replaces=f"src/repro/kernels/moe_lora/kernel.py:{line}",
            launches=sum(by_path[fn_name][p] for p in lora_paths),
            launches_by_path=by_path[fn_name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            max_rel_err=max(c["max_rel_err"] for c in cases),
            rel_tol=LORA_ROW_RTOL, shape=main_case["shape"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], cases=cases))
    # K6 at the 1,536-token prefill; launches from serve_ssm
    k6 = k6_cases[0]
    kernels.append(dict(
        name="ssm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:64",
        launches=ssm_launches["ssm_scan"],
        launches_by_path=by_path["ssm_scan"],
        max_abs_err=max(c["max_abs_err"] for c in k6_cases),
        max_rel_err=max(c["max_rel_err"] for c in k6_cases),
        rel_tol=K6_ROW_RTOL,
        h_rel_err=max(c["h_rel_err"] for c in k6_cases),
        h_rel_tol=K6_H_RTOL, shape=k6["shape"], ms=k6["ms"],
        graph_ms=k6["graph_ms"],
        plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
        bound_by=k6["bound_by"], library_ms=None, cases=k6_cases,
        serve_ssm=ssm_run,
        chunk_states=[dict(shape=c["shape"], ms=c["k6_ms"],
                           chunk_states_ms=c["k6_chunk_states_ms"])
                      for c in k10_cases]))
    # K7 at B = 8 (the lane); launches on serve_sampled at K = 8
    k7 = k7_cases[-1]
    kernels.append(dict(
        name="sample_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/sample_fused.cu",
        replaces="src/repro/kernels/logit_fusion/ops.py:117",
        note="no pl.pallas_call: the reference samples in jnp "
             "(_categorical_rows)",
        launches=sampled[8]["sample_fused"],
        launches_by_path=by_path["sample_fused"],
        max_abs_err=max(c["max_abs_err"] for c in k7_cases),
        ids_equal=all(c["ids_equal"] for c in k7_cases),
        scores_bit_equal=all(c["scores_bit_equal"] for c in k7_cases),
        shape=k7["shape"], ms=k7["ms"], graph_ms=k7["graph_ms"],
        plain_ms=k7["plain_ms"], bound_ms=k7["bound_ms"],
        bound_by=k7["bound_by"], library_ms=None, cases=k7_cases))
    # K8 and K9 (no Pallas originals): launches on the federate
    # simulation (b); K8 at the chip phase's client step (4 x 40), K9 at
    # its mlp_in (T = 160, k 2,048, n 32,768, E 1)
    for fn_name, source, replaces, cases, main_case, note in (
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/models/attention.py:82", k8_cases, k8_cases[0],
             "no pl.pallas_call: the reference differentiates its jnp "
             "chunked_causal_attention with jax.value_and_grad"),
            ("moe_lora_delta_bwd", "moe_lora_bwd.cu",
             "src/repro/models/layers.py:182", k9_cases, k9_cases[4],
             "no pl.pallas_call: the reference differentiates its einsum "
             "lora_delta (src/repro/models/layers.py:182-196)")):
        kernels.append(dict(
            name=fn_name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, note=note, launches=fed_counts[fn_name],
            launches_by_path=by_path[fn_name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            max_rel_err=max(c["max_rel_err"] for c in cases),
            shape=main_case["shape"], ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], cases=cases))
    # K8's windowed mode (gemma3's local layers) at (1, 2048); launches on
    # the gemma3 simulation, federate (e).  K10 at serve_ssm (a)'s client
    # step (4 x 40); launches there
    k8w, k10 = k8w_cases[0], k10_cases[0]
    kernels.append(dict(
        name="flash_attention_bwd_windowed", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:82",
        note="K8's sliding-window mode; no pl.pallas_call: the reference "
             "differentiates its jnp chunked_causal_attention(window=)",
        launches=g_fed_counts["flash_attention_bwd_windowed"],
        launches_by_path=mode_by_path(paths, "flash_attention_bwd_windowed"),
        max_abs_err=max(c["max_abs_err"] for c in k8w_cases),
        max_rel_err=max(c["max_rel_err"] for c in k8w_cases),
        rel_tol=K8_RTOL, shape=k8w["shape"], ms=k8w["ms"],
        plain_ms=k8w["plain_ms"], bound_ms=k8w["bound_ms"],
        bound_by=k8w["bound_by"], library_ms=k8w["library_ms"],
        cases=k8w_cases))
    kernels.append(dict(
        name="ssm_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        replaces="src/repro/models/ssm.py:81",
        note="no pl.pallas_call: the reference differentiates its jnp "
             "chunked scan _mamba1_inner with jax.value_and_grad",
        launches=ssm_train["a"]["launches"]["ssm_scan_bwd"],
        launches_by_path=by_path["ssm_scan_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in k10_cases),
        max_rel_err=max(c["max_rel_err"] for c in k10_cases),
        rel_tol={"d_dt": K10_F32_RTOL, "dA": K10_F32_RTOL,
                 "dx_dB_dC": K10_BF16_RTOL},
        shape=k10["shape"], ms=k10["ms"], plain_ms=k10["plain_ms"],
        bound_ms=k10["bound_ms"], bound_by=k10["bound_by"],
        library_ms=None, cases=k10_cases))
    # K11 at the 1,536-token prefill, K3 at head_dim 112 there; launches
    # from serve_zamba2
    k11, k3d = k11_cases[0], k3d_cases[0]
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/models/ssm.py:171",
        note="no pl.pallas_call: the reference computes the SSD chunk scan "
             "in jnp (_ssd_chunk, src/repro/models/ssm.py:171-189, driven "
             "at :228-240)",
        launches=z_launches["ssd_scan"],
        launches_by_path=by_path["ssd_scan"],
        max_abs_err=max(c["max_abs_err"] for c in k11_cases),
        max_rel_err=max(c["max_rel_err"] for c in k11_cases),
        rel_tol=K11_ROW_RTOL,
        h_rel_err=max(c["h_rel_err"] for c in k11_cases),
        h_rel_tol=K11_H_RTOL, shape=k11["shape"], ms=k11["ms"],
        graph_ms=k11["graph_ms"], plain_ms=k11["plain_ms"],
        bound_ms=k11["bound_ms"], bound_by=k11["bound_by"],
        library_ms=None, cases=k11_cases, serve_zamba2=z_run,
        chunk_states=[dict(shape=c["shape"], ms=c["k11_ms"],
                           chunk_states_ms=c["k11_chunk_states_ms"],
                           rel_err=c["chunk_states_rel_err"])
                      for c in k12_cases]))
    kernels.append(dict(
        name="flash_attention_d112", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        note="K3 at zamba2-7b's head_dim 112 (its shared attention block, "
             "window 4,096)",
        launches=z_launches["flash_attention"],
        launches_by_path={p: n for p, n in by_path["flash_attention"].items()
                          if p.startswith("serve_zamba2")},
        max_abs_err=max(c["max_abs_err"] for c in k3d_cases),
        max_rel_err=max(c["max_rel_err"] for c in k3d_cases),
        rel_tol=K3_ROW_RTOL, shape=k3d["shape"], ms=k3d["ms"],
        graph_ms=k3d["graph_ms"], plain_ms=k3d["plain_ms"],
        bound_ms=k3d["bound_ms"], bound_by=k3d["bound_by"],
        library_ms=k3d["library_ms"], cases=k3d_cases))
    # K12 at zamba2's client step (4 x 40), K8 at head_dim 112 there;
    # launches on serve_zamba2 (d)
    k12, k8d = k12_cases[0], k8d_cases[0]
    z_step = z_train["d"]["launches"]
    kernels.append(dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/models/ssm.py:171",
        note="no pl.pallas_call: the reference differentiates its jnp SSD "
             "chunk loop (_ssd_chunk, src/repro/models/ssm.py:171-189, "
             "driven at :228-240) with jax.value_and_grad",
        launches=z_step["ssd_scan_bwd"],
        launches_by_path=by_path["ssd_scan_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in k12_cases),
        max_rel_err=max(c["max_rel_err"] for c in k12_cases),
        rel_tol={"d_dt_da": K12_F32_RTOL, "dx_dB_dC": K12_BF16_RTOL},
        shape=k12["shape"], ms=k12["ms"], graph_ms=k12["graph_ms"],
        plain_ms=k12["plain_ms"], bound_ms=k12["bound_ms"],
        bound_by=k12["bound_by"], library_ms=None, cases=k12_cases))
    kernels.append(dict(
        name="flash_attention_bwd_d112", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:82",
        note="K8 at zamba2-7b's head_dim 112 (its shared attention block, "
             "windowed at 4,096); no pl.pallas_call: the reference "
             "differentiates its jnp chunked_causal_attention(window=)",
        launches=z_step["flash_attention_bwd"],
        launches_by_path={p: n for p, n in
                          by_path["flash_attention_bwd"].items()
                          if p.startswith("serve_zamba2")},
        max_abs_err=max(c["max_abs_err"] for c in k8d_cases),
        max_rel_err=max(c["max_rel_err"] for c in k8d_cases),
        rel_tol=K8_RTOL, shape=k8d["shape"], ms=k8d["ms"],
        plain_ms=k8d["plain_ms"], bound_ms=k8d["bound_ms"],
        bound_by=k8d["bound_by"], library_ms=k8d["library_ms"],
        cases=k8d_cases))
    # K3 and K8 at granite-moe's head_dim 64 at the 1,536-token prefill
    # (K3) and the client step (K8); launches on serve_granite (a), (c)
    for name, fn, cases, main_case, launched, note in (
            ("flash_attention_d64", "flash_attention", k3g_cases,
             k3g_cases[0], g_launches["flash_attention"],
             "K3 at granite-moe-3b-a800m's head_dim 64 (H 24 over KV 8)"),
            ("flash_attention_bwd_d64", "flash_attention_bwd", k8g_cases,
             k8g_cases[1], g_train["launches"]["flash_attention_bwd"],
             "K8 at granite-moe-3b-a800m's head_dim 64 (H 24 over KV 8); "
             "no pl.pallas_call: the reference differentiates its jnp "
             "chunked_causal_attention")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{fn}.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:80"
            if fn == "flash_attention" else
            "src/repro/models/attention.py:82",
            note=note, launches=launched,
            launches_by_path={p: n for p, n in by_path[fn].items()
                              if p.startswith("serve_granite")},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            max_rel_err=max(c["max_rel_err"] for c in cases),
            rel_tol=K3_ROW_RTOL if fn == "flash_attention" else K8_RTOL,
            shape=main_case["shape"], ms=main_case["ms"],
            graph_ms=main_case["graph_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], cases=cases,
            **({"serve_granite": g_run} if fn == "flash_attention"
               else {})))
    print(f"federate: {json.dumps(fed)}")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
