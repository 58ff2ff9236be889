"""The speculative burst chain of a cloud lane — the port of the body of
``ServingDeployment._make_spec`` in ``repro/serving/deployment.py`` and of
the burst loop of ``_Lane.spec_dispatch`` in ``repro/serving/engine.py``.

One burst decodes up to k tokens of every active row for ONE cloud
round-trip:

* draft: k masked SLM decodes, greedy over the SLM's own logits;
* verify: k chained LLM decodes over [lt, d_0 .. d_{k-2}] — the LLM runs
  one token behind the SLM, with the last emitted token pending in the
  lane's ``lt``, so its k logit rows are the baseline cloud logits of
  emit positions steps + [0, k);
* weather: one arrival and fault draw per burst, keyed at the burst's
  first step, and one breaker transition;
* fuse: the Eq. 14-15 fusion (K1) at each of the k positions and the
  next-token epilogue (argmax, or the keyed draw through K7) keyed at
  steps + i, exactly the per-token path's choices along the accepted
  prefix;
* accept: ``accept_prefix`` keeps the longest prefix the fused choices
  agree with; ``spec_restore`` rolls the rejected draft and verify
  writes back in place; a row whose last token diverged from its draft
  feeds it to the SLM once (the correction decode); positions advance by
  the tokens emitted, finished rows park, and the next-emit logits are
  picked from the draft chain or the correction.

``LaneSpec`` runs ``n_bursts`` such bursts per dispatch (ceil(macro_k /
k), or one at ``macro_k = 0``), chained on the device: the steps, done
flags and breaker state of a burst feed the next.  The weather of a
burst depends on the step it starts at, which earlier bursts decide on
the device, so the host draws every row's arrivals, losses and outages
for steps0 .. steps0 + n_bursts * k (each burst emits at least one
token of an active row) and the burst gathers its column at steps -
steps0: no host copy inside the chain.  Like the macro step
(``LaneGraph``) every update is in place on the lane's tensors and
static buffers (snapshots included), so on CUDA the chain is captured
once into a CUDA graph per lane and replayed; on the CPU it runs
eagerly.  ``traces`` then holds, per burst, (2k + 4, B) float64 rows:
the k selected tokens, the k fusion weights, the tokens emitted, the
agreeing prefix's length, the arrived mask and the loss draw.
"""
from __future__ import annotations

import torch

from repro_torch.data import tokenizer as TOK
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.models.attention import FREED_POS
from repro_torch.serving.macro import LaneGraph


class LaneSpec(LaneGraph):
    """``n_bursts`` chained speculative bursts of k tokens on one cloud
    lane.  ``load`` fills the per-row inputs and the (B, n_bursts * k +
    1) weather tables; ``run(sample)`` runs the chain."""

    def __init__(self, lane, n_bursts: int, k: int, slot_ids: bool):
        super().__init__(lane, n_bursts, slot_ids)
        dep = lane.eng.dep
        b, dev = lane.batch, dep.device
        self.n_bursts, self.k = n_bursts, k
        self.width = n_bursts * k + 1
        self.ok = torch.zeros((b, self.width), dtype=torch.bool, device=dev)
        if self.fault is not None:
            self.lost = torch.zeros_like(self.ok)
            self.outage = torch.zeros_like(self.ok)
        self.steps0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos0 = [torch.zeros((b,), dtype=torch.int32, device=dev)
                     for _ in self.caches]
        # the snapshots' static buffers, shaped by a first snapshot
        self.models = (dep.slm, dep.llm)
        self.snaps = [lm.spec_snapshot(c, c["pos"], k, dep.max_seq)
                      for lm, c in zip(self.models, self.caches)]
        self.traces = torch.zeros((n_bursts, 2 * k + 4, b),
                                  dtype=torch.float64, device=dev)
        self.prepare(False)

    def load(self, ok, lost, outage, steps, max_new, done, slots, key_ids,
             greedy, breaker=None) -> None:
        """The chain's inputs from host arrays: the (B, width) weather
        tables from each row's steps on (``lost`` and ``outage`` only on
        a faulted lane, with ``breaker`` its (fails, cooldown) mirrors),
        and the per-row inputs of ``LaneGraph``."""
        pairs = self._load_rows(steps, max_new, done, slots, key_ids,
                                greedy, breaker)
        pairs += [(self.ok, ok), (self.steps0, steps)]
        if self.fault is not None:
            pairs += [(self.lost, lost), (self.outage, outage)]
        self._upload(pairs)

    def body(self, t: int, sample: bool) -> None:
        """Burst t of the chain, in place."""
        lane = self.lane
        eng, dep = lane.eng, lane.eng.dep
        k, b = self.k, lane.batch
        s_c, l_c = self.caches
        active = ~self.done
        for c, p0 in zip(self.caches, self.pos0):
            p0.copy_(c["pos"])
        for lm, c, p0, snap in zip(self.models, self.caches, self.pos0,
                                   self.snaps):
            lm.spec_snapshot(c, p0, k, dep.max_seq, out=snap)

        # draft: k SLM decodes, greedy over the SLM's own logits;
        # inactive rows sit at FREED_POS and write nothing
        sls, ds = [], []
        cur = lane.sl
        for _ in range(k):
            d = torch.argmax(cur, dim=-1)
            sls.append(cur)
            ds.append(d)
            logits, _ = dep.slm_decode(eng.slm_params, s_c,
                                       torch.where(active, d, 0)[:, None],
                                       eng.lora, self.gates)
            cur = logits[:, 0]
        sl_k = cur

        # verify: k chained LLM decodes over [lt, d_0 .. d_{k-2}]
        lls = []
        for tok in [lane.lt] + ds[:-1]:
            logits, _ = dep.llm_decode(eng.llm_params, l_c,
                                       torch.where(active, tok, 0)[:, None])
            lls.append(logits[:, 0])

        # the burst's weather, keyed at its first step
        col = torch.clamp(self.steps - self.steps0, 0,
                          self.width - 1).long()[:, None]
        ok = self.ok.gather(1, col)[:, 0]
        if self.fault is None:
            arrived = OPS.cloud_arrival_mask(ok, active)
        else:
            lost = self.lost.gather(1, col)[:, 0]
            arrived = self.breaker(active, lost,
                                   self.outage.gather(1, col)[:, 0], ok)
            self.traces[t, 2 * k + 3] = lost
        self.traces[t, 2 * k + 2] = arrived

        # fuse and select each position as the per-token path would
        sels = []
        for i in range(k):
            probs, w = dep.fuse_mask(sls[i], lls[i], arrived)
            sels.append(dep.select_sample(probs, self.greedy, self.key_ids,
                                          self.steps + i, sample))
            self.traces[t, k + i] = w
        sels = torch.stack(sels)
        n_emit, c_sel, done_now, correction = OPS.accept_prefix(
            torch.stack(ds), sels, self.steps, self.max_new, active,
            TOK.EOS)

        # rollback: the SLM keeps the draft writes the baseline would
        # have fed (a finished or corrected row never fed its last
        # token), the LLM, one behind, exactly n_emit feeds
        keep_s = torch.where(active, torch.where(
            done_now | correction, n_emit - 1, k), k)
        keep_l = torch.where(active, n_emit, k)
        for lm, c, p0, snap, keep in zip(self.models, self.caches,
                                         self.pos0, self.snaps,
                                         (keep_s, keep_l)):
            lm.spec_restore(c, snap, p0, keep, dep.max_seq)

        # correction: the diverged token goes to the SLM only (the LLM
        # stays one behind; the token becomes lt)
        pos_s0, pos_l0 = self.pos0
        last_sel = sels.gather(
            0, torch.clamp(n_emit - 1, min=0).long()[None, :])[0]
        s_c["pos"].copy_(torch.where(correction, pos_s0 + n_emit - 1,
                                     FREED_POS))
        corr, _ = dep.slm_decode(eng.slm_params, s_c,
                                 torch.where(correction, last_sel, 0)[:, None],
                                 eng.lora, self.gates)

        # positions: ongoing rows advance n_emit, finished rows park,
        # the others keep theirs
        on = active & ~done_now
        for c, p0 in zip(self.caches, self.pos0):
            c["pos"].copy_(torch.where(on, p0 + n_emit, torch.where(
                done_now, FREED_POS, p0)))

        # next-emit logits: the draft chain's after a full accept, the
        # correction's after a divergence, and a finished row keeps the
        # logits of its last token
        ext = torch.stack(sls + [sl_k])
        idx = torch.where(done_now, torch.clamp(n_emit - 1, min=0), n_emit)
        cand = ext.gather(0, idx.long()[None, :, None].expand(
            1, b, ext.shape[-1]))[0]
        new_sl = torch.where(correction[:, None], corr[:, 0], cand)
        lane.sl.copy_(torch.where(active[:, None], new_sl, lane.sl))
        lane.lt.copy_(torch.where(active, last_sel, lane.lt))
        self.traces[t, :k] = sels
        self.traces[t, 2 * k] = n_emit
        self.traces[t, 2 * k + 1] = c_sel
        self.steps += n_emit
        self.done |= done_now
