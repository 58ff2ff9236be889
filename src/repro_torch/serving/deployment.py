"""ServingDeployment — the single-device, fault-free subset of
``repro/serving/deployment.py``.

One object owns the models, their parameters on the device and the
entry points the engines call: B=1 and packed B>1 prefill and one-token
decode of each model, the Eq. 14-15 fusion step (through K1, one row or
a batch with a per-row arrived mask), the counter-based network weather
of one request or of a batch of rows, and the lane caches of the
batched engine: dense stacked rows (``init_lane_cache``, which an
admission writes in place through ``model.row_writer``) or paged ones — page
pools (a ring/local pool beside the full-length one for the ring leaves
of a grouped SLM), block and ring-local tables, per-row positions and
the admission scatter that streams prefilled K/V into pool pages.  The
SLM's entry points take a merged-LoRA bank and its gates: a router-gated
expert bank (``expert_bank=``, placed once as ``lora``) or the per-user
adapter slot bank (``adapter_slots=``) that an engine's
``AdapterCache`` owns and writes through ``write_adapter_slot``.
The K-token macro step's per-lane state and body live in
``serving/macro.py``, and the speculative burst chain's in
``serving/spec.py``; the deployment gives them ``fuse_mask`` (the fusion
on a device arrived mask), ``select_sample`` (the greedy argmax or the
keyed draw through K7, keyed by ``sample_seed``) and ``fetch_traces``.
A ``fault=`` model makes the cloud link lossy: ``fault_batched`` and
``fault_request`` draw its (lost, outage) weather as ``lat_batched``
and ``lat_request`` draw the arrivals; an all-zero model is the
fault-free path (``fault`` None).
A B=1 prefix prefill (``slm/llm_build_prefix``) builds a HISTORY whose
whole pages a COW prefix writes into the pool once
(``prefix_writer``); ``slm/llm_prefill_suffix`` prefills ragged
suffixes against it and ``slm/llm_prefill_chunk`` one middle chunk of a
chunked prefill, extending the history; ``page_writer`` streams their
K/V into each row's own pages.  ``max_ctx`` > ``max_seq`` widens the
paged context only: block tables and K2's reads cover ``max_ctx``
positions, while the dense prefill buffer (and a dense lane) stays
``max_seq`` wide, and longer prompts stream through chunked prefill.
Meshes are a later slice.

Without an LLM the deployment is SLM-only (``SoloEngine``); its SLM may
be a dense model or a Mamba-1 SSM, whose recurrent state has no pages
(only the batched engine pages, and it refuses a non-dense model, as
in the reference).

The reference's jitted functions return updated copies of a lane cache;
the port's update the cache dict IN PLACE and return it.  Index
arguments (rows, slots, page ids) arrive as host lists or numpy arrays,
and every lane cache keeps a host mirror of its per-row positions
("pos_host"), so no entry point reads the device back.  Host indices and
values reach a CUDA device through pinned memory without blocking
(``to_device``), so admission never waits for a macro step in flight.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core import fusion as FUS
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.models.attention import FREED_POS, identity_tables
from repro_torch.models.model import (LOCAL_KINDS, cache_kv,
                                      history_extender, packed_rows,
                                      prefix_pages, ring_gather,
                                      suffix_rows, to_pages)
from repro_torch.serving import paging as PAG
from repro_torch.serving.adapters import AdapterCache
from repro_torch.serving.latency import FaultModel, LatencyModel


class ServingDeployment:
    """Models, parameters and entry points of one hybrid deployment.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch path.  Parameters (and an expert bank) are moved onto the
    device once, here.  ``adapter_slots`` E > 0 serves per-user adapters
    from E-slot banks of rank ``adapter_rank`` (default the SLM's
    ``lora_rank_max``)."""

    def __init__(self, slm, slm_params, llm=None, llm_params=None,
                 alignment_mlp: Optional[Dict[str, Any]] = None,
                 expert_bank: Optional[Dict[str, Any]] = None,
                 latency: Optional[LatencyModel] = None,
                 timeout_ms: float = 200.0, max_seq: int = 96,
                 block_b: int = 4, page_size: int = 16,
                 max_ctx: Optional[int] = None, adapter_slots: int = 0,
                 adapter_rank: Optional[int] = None,
                 fault: Optional[FaultModel] = None,
                 sample_seed: int = 0, device=None):
        self.device = resolve_device(device)
        # paged lanes gather exactly nb * page_size slots; a page-aligned
        # max_seq makes that extent the dense cache's
        if max_seq % page_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"page_size={page_size}")
        self.max_ctx = max_ctx or max_seq
        if self.max_ctx % page_size or self.max_ctx < max_seq:
            raise ValueError(f"max_ctx={self.max_ctx} must be a multiple "
                             f"of page_size={page_size} and >= "
                             f"max_seq={max_seq}")
        self.page_size = page_size
        for lm in (slm, llm):
            if lm is not None and lm.device != self.device:
                raise ValueError(f"{lm.cfg.name} lives on {lm.device}, the "
                                 f"deployment on {self.device}")
        self.slm, self.llm = slm, llm
        place = lambda t: t.to(self.device)
        self.slm_params = T.map_tree(place, slm_params)
        self.llm_params = (T.map_tree(place, llm_params)
                           if llm_params is not None else None)
        self.mlp = (T.map_tree(place, alignment_mlp)
                    if alignment_mlp is not None else None)
        self.bank = expert_bank
        self.lora = (T.map_tree(place, LORA.bank_for_model(expert_bank))
                     if expert_bank is not None else None)
        self.adapter_slots = adapter_slots
        self.adapter_rank = ((adapter_rank or slm.cfg.lora_rank_max)
                             if adapter_slots else 0)
        self.latency = latency or LatencyModel()
        # an all-zero fault model is the fault-free path: no fault draws
        # and no breaker state
        self.fault = fault
        if fault is not None and fault.loss_rate <= 0.0 \
                and (fault.outage_period <= 0 or fault.outage_len <= 0):
            self.fault = None
        if self.fault is None:
            self.fault_batched = self.fault_request = None
        self.timeout_ms = timeout_ms
        self.max_seq = max_seq
        self.block_b = block_b
        self.sample_seed = sample_seed

    def tokens(self, ids) -> torch.Tensor:
        """(1, S) int64 token tensor on the deployment's device."""
        return torch.tensor([list(ids)], dtype=torch.int64,
                            device=self.device)

    # ------------------------------------------------------ adapter bank
    def init_adapter_bank(self) -> Dict[str, Any]:
        """A fresh all-zero E-slot bank on the device; every
        AdapterCache owns its own."""
        if not self.adapter_slots:
            raise ValueError("deployment built without adapter_slots")
        return LORA.empty_bank(self.slm, self.adapter_slots,
                               self.adapter_rank, device=self.device)

    def make_adapter_cache(self) -> AdapterCache:
        """Host-side refcounted residency manager over a fresh slot
        bank, wired to ``write_adapter_slot``."""
        return AdapterCache(self.adapter_slots, self.init_adapter_bank(),
                            self.write_adapter_slot)

    @staticmethod
    def write_adapter_slot(bank, adapter, slot: int):
        """Write ``adapter`` into slot ``slot`` of ``bank`` IN PLACE (the
        reference's jitted write donates the bank and returns a new
        one); returns the bank."""
        return LORA.write_slot(bank, adapter, slot)

    # ------------------------------------------------------ entry points
    def slm_prefill(self, params, toks, lora=None, gates=None):
        return self.slm.prefill(params, toks, self.max_seq, lora, gates)

    def llm_prefill(self, params, toks):
        return self.llm.prefill(params, toks, self.max_seq)

    def slm_decode(self, params, cache, toks, lora=None, gates=None):
        return self.slm.decode_step(params, cache, toks, lora, gates)

    def llm_decode(self, params, cache, toks):
        return self.llm.decode_step(params, cache, toks)

    def slm_prefill_packed(self, params, toks, lens, write_kv, lora=None,
                           gates=None):
        return self.slm.prefill_packed(params, toks, lens, self.max_seq,
                                       write_kv, lora, gates)

    def llm_prefill_packed(self, params, toks, lens, write_kv):
        return self.llm.prefill_packed(params, toks, lens, self.max_seq,
                                       write_kv)

    def slm_build_prefix(self, params, toks, write_kv=None, lora=None,
                         gates=None):
        return self.slm.build_prefix(params, toks, write_kv, lora, gates)

    def llm_build_prefix(self, params, toks, write_kv=None):
        return self.llm.build_prefix(params, toks, write_kv)

    def slm_prefill_suffix(self, params, toks, lens, hist, write_kv,
                           lora=None, gates=None):
        return self.slm.prefill_suffix(params, toks, lens, hist, write_kv,
                                       lora, gates)

    def llm_prefill_suffix(self, params, toks, lens, hist, write_kv):
        return self.llm.prefill_suffix(params, toks, lens, hist, write_kv)

    def slm_prefill_chunk(self, params, toks, lens, hist, write_kv,
                          lora=None, gates=None):
        return _chunk(self.slm, params, toks, lens, hist, write_kv, lora,
                      gates)

    def llm_prefill_chunk(self, params, toks, lens, hist, write_kv):
        return _chunk(self.llm, params, toks, lens, hist, write_kv)

    @staticmethod
    def insert_row(full: torch.Tensor, rows: torch.Tensor, src, dst):
        """full[dst] = rows[src], in place; returns ``full`` (logit rows,
        and the gate rows of an admission into a lane's (B, E) gates)."""
        full[_index(dst, full.device)] = rows[_index(src, rows.device)]
        return full

    # ------------------------------------------------------ dense lanes
    def init_lane_cache(self, lm, batch: int) -> Dict[str, Any]:
        """A fresh dense lane cache: ``lm``'s dense tree of (..., B,
        max_seq or ring, KV, hd) zeroed leaves with per-row "pos" (B,)
        int32 and its host mirror "pos_host", every row parked (pos =
        FREED_POS) until an admission sets its position, as a paged
        lane's rows start (the reference's rows start at 0; see
        ``init_paged_lane_cache``), and on CUDA "ident": the identity
        tables through which K2 reads the rows as 16-slot pages (the
        reference's ``init_lane_cache``, ``deployment.py:407``)."""
        cache = lm.init_cache(batch, self.max_seq)
        cache.update(pos=torch.full((batch,), FREED_POS, dtype=torch.int32,
                                    device=self.device),
                     pos_host=np.full((batch,), FREED_POS, np.int64))
        if self.device.type == "cuda":
            cache["ident"] = {"block": identity_tables(
                batch, self.max_seq, self.device)}
            local = lm._ring_local_len(self.max_seq)
            if local:
                cache["ident"]["local"] = identity_tables(batch, local,
                                                          self.device)
        return cache

    def lane_kv_bytes(self, lm, batch: int) -> int:
        """Bytes of a dense lane cache's K/V leaves."""
        return sum(int(np.prod(shape)) * lm.dtype.itemsize
                   for shape in T.leaves(lm.kv_shapes(batch, self.max_seq)))

    # ------------------------------------------------------ paged lanes
    def _is_local(self, shape) -> bool:
        """Whether a dense KV leaf shape (..., B, S, KV, hd) is a ring/
        local leaf (shorter than max_seq), paged from the local pool."""
        return shape[-3] != self.max_seq

    def paged_geometry(self, lm) -> Dict[str, int]:
        """Static page geometry of ``lm``'s cache: the block and local
        table widths, the ring extent of the local leaves (0 when every
        leaf is full-length) and the bytes one page id costs across the
        leaves of each pool (pages span every layer, vLLM-style shared
        tables; reference ``deployment.py:877-892``)."""
        cfg, ps = lm.cfg, self.page_size
        # K and V leaves of every layer, per pool
        leaves = {False: 0, True: 0}
        for leaf in T.leaves(lm.kv_shapes(1, self.max_seq)):
            leaves[self._is_local(leaf)] += int(np.prod(leaf[:-4]))
        local_len = lm._ring_local_len(self.max_seq)

        def nbytes(n_leaves):
            return PAG.page_bytes(n_leaves // 2, cfg.num_kv_heads,
                                  cfg.head_dim, ps, lm.dtype.itemsize)
        return dict(nb=PAG.pages_for(self.max_ctx, ps), local_len=local_len,
                    nl=PAG.pages_for(local_len, ps),
                    page_bytes_full=nbytes(leaves[False]),
                    page_bytes_local=nbytes(leaves[True]))

    def init_paged_lane_cache(self, lm, batch: int, pages: int,
                              local_pages: int = 0) -> Dict[str, Any]:
        """A fresh paged lane cache: each KV leaf (..., B, S, KV, hd) of
        ``lm.kv_shapes`` becomes a zeroed pool (..., n + 1, ps, KV, hd)
        of n = ``pages``, or ``local_pages`` for a ring/local leaf — the
        last page is the sink that dropped writes land in — with block
        (and, for ring leaves, local) tables full of NO_PAGE and every
        row parked (pos = FREED_POS) until an admission sets its
        position.  The reference starts rows at 0; a row that is never
        admitted then advances one slot per lane step, which the port's
        guard on live positions would refuse once it passed the table.
        Parked, it writes to the sink, holds its position and K2 skips
        it."""
        dev, ps = self.device, self.page_size
        geo = self.paged_geometry(lm)

        def pool(shape):
            n = local_pages if self._is_local(shape) else pages
            return torch.zeros(shape[:-4] + (n + 1, ps) + shape[-2:],
                               dtype=lm.dtype, device=dev)
        cache = T.map_tree(pool, lm.kv_shapes(1, self.max_seq))
        cache.update(
            pos=torch.full((batch,), FREED_POS, dtype=torch.int32,
                           device=dev),
            pos_host=np.full((batch,), FREED_POS, np.int64),
            block=torch.full((batch, geo["nb"]), PAG.NO_PAGE,
                             dtype=torch.int32, device=dev))
        if geo["nl"]:
            cache["local"] = torch.full((batch, geo["nl"]), PAG.NO_PAGE,
                                        dtype=torch.int32, device=dev)
        return cache

    def set_row_pos(self, cache, idx, val):
        """pos[idx] = val on the device and in the host mirror, on a
        dense or a paged lane cache."""
        idx, val = np.asarray(idx, np.int64), np.asarray(val, np.int64)
        cache["pos"][_index(idx, self.device)] = to_device(
            val.astype(np.int32), self.device)
        cache["pos_host"][idx] = val
        return cache

    def free_paged_rows(self, cache, idx):
        """Park drained rows and unmap their pages: pos to FREED_POS and
        block and local table rows to NO_PAGE, so later decode writes
        drop and the freed page ids can be handed to a new admission."""
        idx = np.asarray(idx, np.int64)
        self.set_row_pos(cache, idx, np.full(idx.shape, FREED_POS))
        for table in ("block", "local"):
            if table in cache:
                cache[table].index_fill_(0, _index(idx, self.device),
                                         PAG.NO_PAGE)
        return cache

    def grow_block_pages(self, cache, rows, cols, pids):
        """Map freshly grown pages: block[rows[i], cols[i]] = pids[i]."""
        cache["block"][_index(rows, self.device),
                       _index(cols, self.device)] = to_device(
            np.asarray(pids, np.int32), self.device)
        return cache

    def page_writer(self, full, src, dpf, lengths=None, dpl=None,
                    local_len: int = 0, history=None, share_len: int = 0):
        """``write_kv`` callback for ``LM.prefill_packed`` (and, with a
        ``history``, ``LM.prefill_suffix``) that streams each layer's
        fresh (B, Lpad, KV, hd) K/V straight into the pool pages of
        ``full`` — the paged admission scatter.  Row src[i] of the
        prefill goes to the (n, cols) destination page ids dpf[i]
        (NO_PAGE columns drop).  A ring leaf (``full`` has a "local"
        table) takes instead each row's ring of ``local_len`` slots at
        its own depth, from the (bp,) prompt ``lengths`` of the prefill's
        rows, into its local pages dpl[i]: slot j holds position
        ``ring_kv_positions(len - 1, local_len)[j]``, clipped into the
        prompt, or, when the padded prompt fits the ring, slot j holds
        position j (zeros past it) — the reference's ``_pad_cache(
        lengths=)`` placement (``model.py:730-780``).  The pool gets what
        the reference's dense packed prefill and page-row scatter give
        it, without a dense (L, B, max_seq) transient.

        Behind a ``history`` of P positions (a suffix or chunk prefill,
        ``lengths`` the suffix lengths) a row's full-length content is
        the positions [share_len, P + Lpad) — the prefix's unshared
        tail, then its suffix — and its ring is gathered from [history;
        fresh] at depth P + length, slot for slot (``suffix_rows``, the
        reference's ``suffix_page_rows``).  ``dpl`` None writes no ring
        (a middle chunk: only the final chunk's window is the row's
        ring)."""
        ps, dev = self.page_size, self.device
        ring = "local" in full
        plans, gather = {}, {}

        def plan(local, n_pool):
            if local not in plans:
                plans[local] = _page_plan(dpl if local else dpf, src,
                                          n_pool)
            return plans[local]

        def write(addr, k, v):
            local = ring and isinstance(addr, tuple) \
                and addr[0] in LOCAL_KINDS
            if local and dpl is None:
                return
            for name, t in (("k", k), ("v", v)):
                pool = cache_kv(full, addr, name)
                if history is not None:
                    t = suffix_rows(cache_kv(history, addr, name), t,
                                    lengths, share_len,
                                    local_len if local else 0)
                elif local:
                    if not gather and local_len < t.shape[1]:
                        gather["slots"] = ring_gather(lengths, local_len,
                                                      t.shape[1], dev)
                    t = packed_rows(t, local_len, gather.get("slots"))
                _write_pages(pool, to_pages(t, ps),
                             plan(local, pool.shape[0] - 1))
        return write

    def prefix_writer(self, full, pids, share_len: int):
        """``write_kv`` callback for ``LM.build_prefix`` that writes the
        first ``share_len`` (page-aligned) positions of each full-length
        leaf's (1, P, KV, hd) K/V into pool pages ``pids`` of ``full``,
        once — the COW prefix-page write (the reference's
        ``_make_insert_prefix``, ``deployment.py:1046-1081``), also the
        freeze of a chunked prefill's first chunk.  Ring leaves are
        never shared and get nothing."""
        ring = "local" in full
        plan = {}

        def write(addr, k, v):
            if ring and isinstance(addr, tuple) and addr[0] in LOCAL_KINDS:
                return
            for name, t in (("k", k), ("v", v)):
                pool = cache_kv(full, addr, name)
                if not plan:
                    plan["p"] = _page_plan([pids], [0], pool.shape[0] - 1)
                _write_pages(pool, prefix_pages(t, share_len,
                                                self.page_size)[None],
                             plan["p"])
        return write

    def finish_paged_insert(self, full, dst, lengths, block_rows,
                            local_rows=None):
        """Row positions (the prompt lengths) and block (and local)
        table rows at ``dst`` of a paged admission whose K/V are in the
        pool."""
        self.set_row_pos(full, dst, lengths)
        for table, rows in (("block", block_rows), ("local", local_rows)):
            if rows is not None:
                full[table][_index(dst, self.device)] = to_device(
                    np.asarray(rows, np.int32), self.device)
        return full

    def fuse(self, sl: torch.Tensor, ll: torch.Tensor, arrived: bool):
        """Eq. 14-15 on (B, V) logits, Eq. 15 through K1; ``arrived``
        applies to every row.  Returns (P_out (B, V), w (B,))."""
        return self.fuse_batched(sl, ll, np.full(sl.shape[0], bool(arrived)))

    def fuse_batched(self, sl: torch.Tensor, ll: torch.Tensor, arrived):
        """Eq. 14-15 on a lane batch (B, V) with a per-row arrived mask
        (host bools), Eq. 15 through K1.  Returns (P_out (B, V), w (B,))."""
        return self.fuse_mask(sl, ll, to_device(np.asarray(arrived, bool),
                                                sl.device))

    def fuse_mask(self, sl: torch.Tensor, ll: torch.Tensor,
                  arrived: torch.Tensor):
        """``fuse_batched`` on an arrived mask that already lies on the
        device, (B,) bool: the macro step's form, which copies nothing
        from the host and so can be captured in a CUDA graph."""
        return FUS.fused_distribution_kernel(self.mlp, sl, ll, arrived,
                                             block_b=self.block_b)

    @staticmethod
    def softmax_batched(sl: torch.Tensor) -> torch.Tensor:
        return torch.softmax(sl.float(), dim=-1)

    @staticmethod
    def argmax_batched(p: torch.Tensor) -> torch.Tensor:
        return torch.argmax(p, dim=-1)

    def sample_batched(self, probs: torch.Tensor, rids, steps):
        """Keyed draws from (B, V) probabilities, row i keyed by host ints
        rids[i] and steps[i] (K7): (B,) int64 ids on the device."""
        return OPS.sample_fused(probs, _int32(rids, probs.device),
                                _int32(steps, probs.device),
                                seed=self.sample_seed)

    def select_sample(self, probs: torch.Tensor, greedy: torch.Tensor,
                      key_ids: torch.Tensor, steps: torch.Tensor,
                      sample: bool):
        """The macro step's epilogue on (B,) device tensors: the greedy
        argmax on ``greedy`` rows, the keyed draw elsewhere (K7), or the
        argmax alone when ``sample`` is False."""
        return OPS.select_sample_fused(probs, greedy, key_ids, steps,
                                       seed=self.sample_seed, sample=sample)

    def lat_batched(self, rids, steps):
        """One vectorised weather draw for a batch of rows: (lat_ms (B,)
        float32, cloud_used (B,) bool) numpy arrays."""
        return self.latency.token_latency_device(self.timeout_ms, rids,
                                                 steps)

    @staticmethod
    def fetch_traces(traces: torch.Tensor) -> np.ndarray:
        """The one host sync of a macro step: its stacked traces, copied
        to the host in one transfer."""
        return traces.cpu().numpy()

    def fault_batched(self, rids, steps):
        """One vectorised fault draw for a batch of rows: (lost (B,),
        outage (B,)) bool numpy arrays.  Without a fault model this
        entry point, and ``fault_request``, are None."""
        return self.fault.faults_device(rids, steps)

    def fault_request(self, rid: int, steps):
        """A whole request's fault weather in one draw: (lost (n,),
        outage (n,)) bool numpy arrays."""
        steps = np.asarray(steps, np.int32)
        return self.fault.faults_device(np.full_like(steps, rid), steps)

    def lat_request(self, rid: int, steps):
        """A whole request's network weather in one vectorised draw:
        (lat_ms (n,) float32, cloud_used (n,) bool) numpy arrays."""
        steps = np.asarray(steps, np.int32)
        return self.latency.token_latency_device(
            self.timeout_ms, np.full_like(steps, rid), steps)


def _chunk(lm, params, toks, lens, hist, write_kv, lora=None, gates=None):
    """One MIDDLE chunk of a chunked prefill: the suffix prefill of an
    exact-width B=1 chunk against the history so far, its K/V streamed
    to ``write_kv`` (the chunk's own pages) and into the extended
    history.  Returns (logits, history for the next chunk) — the
    reference's ``_chunk_out``, ``deployment.py:959-973``."""
    new_hist, extend = history_extender(lm, hist, toks.shape[1])

    def write(addr, k, v):
        write_kv(addr, k, v)
        extend(addr, k, v)
    return lm.prefill_suffix(params, toks, lens, hist, write, lora,
                             gates), new_hist


def _page_plan(dpf, src, n_pool: int):
    """Host plan of an admission scatter: the mapped (row, column, page
    id) entries of the (n, cols) destination-page rows ``dpf`` (NO_PAGE
    entries are dropped), row i taking source row src[i]."""
    dpf = np.asarray(dpf, np.int64)
    jj, cc = np.nonzero(dpf < n_pool)
    return np.asarray(src, np.int64)[jj], cc, dpf[jj, cc]


def _write_pages(pool, pages, plan):
    """pool (P + 1, ps, KV, hd) <- page content ``pages`` (n_src, np, ps,
    KV, hd) at the plan's page ids; mapped columns past the content get
    zeros, as the reference's zero-padded dense rows give them."""
    srow, cc, pid = plan
    have = cc < pages.shape[1]
    dev = pool.device
    if have.any():
        pool[_index(pid[have], dev)] = pages[_index(srow[have], dev),
                                             _index(cc[have], dev)]
    if (~have).any():
        # index_fill_: ``pool[idx] = 0`` would copy the 0 from the host
        # and wait for the device
        pool.index_fill_(0, _index(pid[~have], dev), 0)


def _int32(vals, device) -> torch.Tensor:
    """Host ints as an int32 tensor on ``device``, wrapped modulo 2**32
    as the reference's int32 key and step arrays hold them."""
    return to_device(np.asarray(vals, np.int64).astype(np.int32), device)


def _index(idx, device) -> torch.Tensor:
    """A host index list or array as an int64 tensor on ``device``."""
    return to_device(np.asarray(idx, np.int64), device)
