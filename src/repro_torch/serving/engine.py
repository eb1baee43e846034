"""Continuous-batching decode engine over program-scheduled collectives.

The counterpart of ``repro.serving.engine`` over the port's in-process
cube. One engine step serves every in-flight request at once and costs
exactly:

  * **one recorded CommProgram** of rooted collectives -- the host->PE
    broadcasts of the step's control state (page table, admit/evict masks,
    prompt buffer, sampling temperatures, rng key) plus the PE->host gather
    of the *previous* step's sampled tokens.  The program is re-recorded
    every step (constants change) but its structure never does, so the
    structural-fingerprint lower cache serves every step after the first
    (``LOWER_STATS["cache_hits"]`` grows by one per step);
  * **one eager step over cube tensors** (the reference's jitted
    ``shard_map`` step): the paged flash-decode cell
    (:class:`repro_torch.serving.pages.PagedServer` around the unchanged
    ``Server.decode_shard``) plus device-side sampling, so no logits ever
    cross to the host. The lane state (tokens, positions, active mask,
    prompt buffer, sampled tokens) lives on the device as cube tensors
    updated in place, so the step can later be captured as one CUDA graph.

Scheduling is continuous batching with slot reuse: requests admit from the
arrival queue into free batch lanes, prefill runs *through the decode cell*
(chunk-1 chunked prefill: each step teacher-forces the next prompt token
while building the paged KV cache), decode samples on-device (greedy or
temperature via a sharded-vocab collective argmax), and completed requests
evict the next step, returning their pages to the pools.

Host bookkeeping is deterministic without token values (completion is
length-based: ``plen + max_new``), which is what lets sampled tokens flow
back with a one-step lag through the next program's gather instead of a
blocking per-step device round-trip.

Admission policies:
  * ``"reserve"`` (default): admit only when every shard can cover the
    request's full eventual page footprint net of pages already promised
    to in-flight requests -- allocation can then never fail mid-decode;
  * ``"lazy"``: admit optimistically as soon as a lane is free and the
    request's first block fits; if a shard's pool later runs dry, the
    youngest other request is **preempted** -- its pages are swapped to
    the host via the rooted gather
    (:func:`repro_torch.serving.pages.extract_slot_pages`), freed, and the
    request re-queued; re-admission scatters the saved pages back
    (:func:`~repro_torch.serving.pages.inject_slot_pages`).

Temperature sampling draws its Gumbel noise from an explicit
``torch.Generator`` on the engine's device seeded from ``(seed, step)``:
the bits differ from ``jax.random``'s, so sampled (not greedy) streams
match the reference in their properties, not token for token.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.program import LOWER_STATS
from repro_torch.models.config import ModelConfig
from repro_torch.models.serving import ServePlan, Server
from repro_torch.models.topology import Topology
from repro_torch.serving.pages import (
    PagedServer, PageTable, extract_slot_pages, init_paged_cache,
    inject_slot_pages, make_page_plan)
from repro_torch.telemetry import drift as _drift
from repro_torch.telemetry import spans as _spans
from repro_torch.telemetry.metrics import MetricsRegistry

_I64MAX = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class Request:
    """One decode request.  ``arrival`` is in engine steps (the bench maps a
    Poisson arrival trace onto it); ``temperature == 0`` samples greedily."""
    rid: int
    prompt: list[int]
    max_new: int
    temperature: float = 0.0
    arrival: int = 0
    # filled by the engine
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    admitted_step: int = -1
    finished_step: int = -1
    preemptions: int = 0

    @property
    def plen(self) -> int:
        return len(self.prompt)

    @property
    def limit(self) -> int:
        """One past the last decoded position (= plen + max_new - 1)."""
        return self.plen + self.max_new - 1


class ServeEngine:
    """Continuous-batching decode server on the serve topology. ``params``
    are cube tensors on ``device`` (CUDA unless ``device="cpu"``);
    ``dtype`` is the compute and KV-cache dtype."""

    def __init__(self, cfg: ModelConfig, topo: Topology, plan: ServePlan,
                 params, *, page_size: int = 4,
                 pages_per_shard: int | None = None,
                 admission: str = "reserve", seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        if plan.batch_axes:
            raise NotImplementedError(
                "ServeEngine runs single-pod serve plans (batch replicated); "
                f"got batch_axes={plan.batch_axes}")
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder serving needs a cross-cache prefill path")
        if admission not in ("reserve", "lazy"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.device = resolve_device(device)
        self.cfg, self.topo, self.plan = cfg, topo, plan
        self.params = params
        self.admission = admission
        self.seed = seed
        self.pplan = make_page_plan(plan, topo, page_size=page_size,
                                    pages_per_shard=pages_per_shard)
        self.B = plan.global_batch
        self.P_max = plan.S_ctx

        self.table = PageTable(self.pplan, self.B)
        self.pcache = init_paged_cache(cfg, topo, plan, self.pplan,
                                       dtype=dtype, device=self.device)
        self.paged = PagedServer(Server(cfg, topo, plan, dtype=dtype),
                                 self.pplan)

        # host mirrors (deterministic: no token values needed)
        self.slot_req: list[Request | None] = [None] * self.B
        self.pos_h = np.zeros(self.B, np.int32)
        self.active_h = np.zeros(self.B, bool)
        self.plen_h = np.zeros(self.B, np.int32)
        self.limit_h = np.zeros(self.B, np.int32)
        self.temp_h = np.zeros(self.B, np.float32)
        self._admit_order = np.zeros(self.B, np.int64)  # admission stamp
        self._stamp = 0
        self._slot_commit = np.zeros((self.B, self.pplan.n_shards), np.int64)
        self._committed = np.zeros(self.pplan.n_shards, np.int64)
        self._evict_next = np.zeros(self.B, bool)

        # device-carried lane state: every PE's copy, updated in place
        lanes = topo.cube.dim_sizes + (self.B,)
        z = dict(dtype=torch.int64, device=self.device)
        self._toks = torch.zeros(lanes, **z)
        self._pos = torch.zeros(lanes, **z)
        self._active = torch.zeros(lanes, dtype=torch.bool,
                                   device=self.device)
        self._prompts = torch.zeros(lanes + (self.P_max,), **z)
        self._sampled = torch.zeros(lanes, **z)
        self._gen = torch.Generator(device=self.device)
        # lanes whose previous-step sample is a generated token:
        # (slot, request, generated-token index)
        self._meta: list[tuple[int, Request, int]] = []

        self.queue: list = []
        self.step_idx = 0
        self.programs_recorded = 0
        self.last_program = None   # most recent per-step CommProgram
        self.finished: list[Request] = []

        # Per-engine metrics registry (always on): the single source run()
        # reads latency/throughput from.
        self.metrics = MetricsRegistry()
        self._lower_hits = 0
        self._lower_lookups = 0

    # ------------------------------------------------------- device step
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_step(self, table, admit, admit_tok, admit_pos,
                     admit_prompts, plen, evict, temps, key) -> None:
        """Merge this step's schedule into the lane state, run the paged
        decode cell and sample on the device. Every argument is the cube
        tensor its broadcast delivered (each PE's copy)."""
        cfg, topo, P_max = self.cfg, self.topo, self.P_max
        toks, pos, active = self._toks, self._pos, self._active
        prompts = self._prompts
        active.copy_((active & ~evict) | admit)
        toks.copy_(torch.where(admit, admit_tok.long(), toks))
        pos.copy_(torch.where(admit, admit_pos.long(), pos))
        prompts.copy_(torch.where(admit[..., None], admit_prompts.long(),
                                  prompts))

        logits, _ = self.paged.decode_shard(self.params, self.pcache, table,
                                            toks, pos)
        # ---- on-device sampling over the vocab-sharded logits
        V_loc = logits.shape[-1]
        me = topo.axis_index(topo.tp, self.device)
        gid = me[..., None] * V_loc + torch.arange(V_loc,
                                                   device=self.device)
        neg = torch.finfo(torch.float32).min
        eff = torch.where(gid[..., None, :] < cfg.vocab_size, logits, neg)
        if self.temp_h.any():
            # Gumbel-max: one draw per (PE, lane, local vocab id) from the
            # step's generator, seeded from the broadcast (seed, step) key
            # (PE 0's copy), mixed to the 32 bits every generator keeps
            pair = key.reshape(-1, 2)[0].tolist()
            self._gen.manual_seed(int(np.random.SeedSequence(
                pair).generate_state(1)[0]))
            u = torch.rand(eff.shape, generator=self._gen,
                           device=self.device)
            g = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(torch.float32).tiny)))
            tmp = temps[..., None]
            warm = eff / tmp.clamp_min(1e-6) + g
            eff = torch.where(tmp > 0.0, warm, eff)
        # collective argmax: max over shards, then the min global id among
        # the (bitwise-equal on the owner) maximizers -- argmax's tie rule
        tpc = topo.comm(topo.tp)
        m_all = tpc.all_reduce(eff.amax(dim=-1), op="max")
        cand = torch.where(eff == m_all[..., None], gid[..., None, :],
                           _I64MAX).amin(dim=-1)
        sampled = tpc.all_reduce(cand, op="min")
        # ---- teacher-force prefill, advance the lanes
        nxt_p = prompts.gather(
            -1, (pos + 1).clamp(0, P_max - 1)[..., None])[..., 0]
        nxt = torch.where(pos + 1 < plen, nxt_p, sampled)
        toks.copy_(torch.where(active, nxt, toks))
        pos.copy_(torch.where(active, pos + 1, pos))
        self._sampled.copy_(sampled)

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid} asks for no tokens")
        if req.limit > self.plan.S_ctx:
            raise ValueError(
                f"request {req.rid} needs {req.limit} positions, over the "
                f"serve plan's S_ctx={self.plan.S_ctx}")
        need = self._need(req)
        if any(n > self.pplan.pages_per_shard for n in need):
            raise ValueError(
                f"request {req.rid} needs {max(need)} pages on one shard "
                f"but the pools hold {self.pplan.pages_per_shard} -- it "
                "could never run even alone")
        self.queue.append(req)
        self.queue.sort(key=lambda r: r.arrival)

    def _need(self, req_or_state) -> list[int]:
        limit = (req_or_state["req"].limit
                 if isinstance(req_or_state, dict) else req_or_state.limit)
        return self.table.blocks_needed(min(limit, self.plan.S_cache))

    def _can_admit(self, entry) -> bool:
        free = np.asarray(self.table.free_per_shard(), np.int64)
        if isinstance(entry, dict):        # resumed: exact saved footprint
            need = np.zeros(self.pplan.n_shards, np.int64)
            for j in np.nonzero(entry["valid"])[0]:
                need[self.pplan.owner(int(j))] += 1
            return bool((free >= need).all())
        if self.admission == "reserve":
            need = np.asarray(self._need(entry), np.int64)
            return bool((free - self._committed >= need).all())
        # lazy: optimistic -- only the request's first block must fit now;
        # a shard running dry later preempts (feasibility of the full
        # footprint against the pool size was checked at submit)
        need = np.asarray(self.table.blocks_needed(1), np.int64)
        return bool((free >= need).all())

    def _admit_into(self, slot: int, entry, admit, admit_tok, admit_pos,
                    admit_prompts) -> None:
        saved = entry if isinstance(entry, dict) else None
        req: Request = saved["req"] if saved else entry
        start = int(saved["pos"]) if saved else 0
        self.metrics.counter("serve.admitted").inc()
        self.slot_req[slot] = req
        self.pos_h[slot] = start
        self.active_h[slot] = True
        self.plen_h[slot] = req.plen
        self.limit_h[slot] = req.limit
        self.temp_h[slot] = req.temperature
        self._stamp += 1
        self._admit_order[slot] = self._stamp
        if req.admitted_step < 0:
            req.admitted_step = self.step_idx
        need = np.asarray(self._need(req), np.int64)
        self._slot_commit[slot] = need
        self._committed += need
        admit[slot] = True
        admit_pos[slot] = start
        if start < req.plen:
            admit_tok[slot] = req.prompt[start]
        else:                               # resumed mid-decode
            admit_tok[slot] = req.out_tokens[start - req.plen]
        admit_prompts[slot, :req.plen] = np.asarray(req.prompt, np.int32)
        if saved:
            # re-allocate exactly the saved blocks, then scatter pages back
            req.preemptions += 1
            for j in np.nonzero(saved["valid"])[0]:
                if not self._ensure(slot, int(j) * self.pplan.page_size):
                    raise RuntimeError(
                        f"re-admitting request {req.rid}: block {j} does "
                        "not fit although admission checked it")
            inject_slot_pages(self.pcache, saved, self.table.table[slot],
                              slot, self.pplan, self.topo, self.plan,
                              self.cfg)

    def _ensure(self, slot: int, cache_pos: int) -> bool:
        j = self.table.block_of(cache_pos)
        fresh = self.table.table[slot, j] < 0
        if not self.table.ensure(slot, cache_pos):
            return False
        if fresh:
            sh = self.pplan.owner(j)
            if self._slot_commit[slot, sh] > 0:
                self._slot_commit[slot, sh] -= 1
                self._committed[sh] -= 1
        return True

    def _release(self, slot: int) -> None:
        self.table.free_slot(slot)
        self._committed -= self._slot_commit[slot]
        self._slot_commit[slot] = 0
        self.slot_req[slot] = None
        self.active_h[slot] = False

    def _preempt_for(self, slot: int, shard: int) -> bool:
        """Swap out the youngest other active request holding pages on
        ``shard``; returns False when no victim exists."""
        cands = [b for b in range(self.B)
                 if b != slot and self.active_h[b] and any(
                     self.table.table[b, j] >= 0
                     for j in range(self.pplan.n_blocks)
                     if self.pplan.owner(j) == shard)]
        if not cands:
            return False
        victim = max(cands, key=lambda b: self._admit_order[b])
        self._drain()                       # bank pending sampled tokens
        req = self.slot_req[victim]
        saved = extract_slot_pages(self.pcache, self.table.table[victim],
                                   victim, self.pplan, self.topo, self.plan,
                                   self.cfg)
        saved["req"] = req
        saved["pos"] = int(self.pos_h[victim])
        self._release(victim)
        self._evict_next[victim] = True     # device lane off next program
        self.queue.insert(0, saved)
        self.metrics.counter("serve.preempted").inc()
        return True

    # ------------------------------------------------------------- stepping
    def _drain(self) -> None:
        """Apply pending generated-token bookkeeping from the device copy
        (used before swaps and at end of run; normally the next step's
        program gather does this without an extra round trip)."""
        if not self._meta:
            return
        vals = self.topo.cube.from_cube(self._sampled, (None,)).cpu()
        self._apply_meta(vals.numpy())

    def _apply_meta(self, sampled: np.ndarray) -> None:
        for slot, req, gi in self._meta:
            tok = int(sampled[slot])
            if gi == len(req.out_tokens):
                req.out_tokens.append(tok)
        self._meta = []

    def step(self) -> None:
        """One engine step: evict / admit / record-and-run the step program
        / run the paged-decode + sampling step on the device."""
        with _spans.maybe_span("serve-step", cat="wall",
                               step=self.step_idx):
            self._step_inner()

    def _step_inner(self) -> None:
        t0 = time.perf_counter()
        B, pplan = self.B, self.pplan
        self._evict_next = np.zeros(B, bool)

        # -- evict lanes that finished last step (their final token arrives
        #    through this step's gather, recorded in _meta)
        for b in range(B):
            if self.active_h[b] and self.pos_h[b] >= self.limit_h[b]:
                req = self.slot_req[b]
                req.finished_step = self.step_idx
                self.finished.append(req)
                self._release(b)
                self._evict_next[b] = True
                self.metrics.counter("serve.evicted").inc()

        # -- admit from the arrival queue into free lanes
        admit = np.zeros(B, bool)
        admit_tok = np.zeros(B, np.int32)
        admit_pos = np.zeros(B, np.int32)
        admit_prompts = np.zeros((B, self.P_max), np.int32)
        while self.queue:
            head = self.queue[0]
            arr = (head["req"].arrival if isinstance(head, dict)
                   else head.arrival)
            if arr > self.step_idx:
                break
            free = [b for b in range(B) if not self.active_h[b]]
            if not free or not self._can_admit(head):
                break
            self.queue.pop(0)
            self._admit_into(free[0], head, admit, admit_tok, admit_pos,
                             admit_prompts)

        # -- allocate this step's write blocks (deterministic on host);
        #    under lazy admission a dry shard triggers preemption
        for b in range(B):
            if not self.active_h[b]:
                continue
            wp = int(self.pos_h[b]) % self.plan.S_cache
            while not self._ensure(b, wp):
                sh = pplan.owner(self.table.block_of(wp))
                if not self._preempt_for(b, sh):
                    raise RuntimeError(
                        f"page pools exhausted on shard {sh} and no "
                        "preemptible request holds pages there")

        free = np.asarray(self.table.free_per_shard(), np.int64)
        total_pages = pplan.n_shards * pplan.pages_per_shard
        self.metrics.gauge("serve.page_occupancy").set(
            1.0 - float(free.sum()) / total_pages if total_pages else 0.0)

        evict = self._evict_next
        key = np.array([self.seed, self.step_idx], np.int64)

        # -- ONE recorded CommProgram per decode step: the rooted host->PE
        #    broadcasts of control state + the PE->host gather of the
        #    previous step's sampled tokens.  Structure is step-invariant,
        #    so lowering is a structural-fingerprint cache hit from step 1.
        kvc = self.topo.comm(self.plan.kv_axes)
        dev = self.device
        prog = self.topo.program(name="serve-step")
        with prog:
            prev = prog.input(self._sampled)
            outs = [kvc.broadcast(self.table.array(), device=dev),
                    kvc.broadcast(admit, device=dev),
                    kvc.broadcast(admit_tok, device=dev),
                    kvc.broadcast(admit_pos, device=dev),
                    kvc.broadcast(admit_prompts, device=dev),
                    kvc.broadcast(self.plen_h.copy(), device=dev),
                    kvc.broadcast(evict, device=dev),
                    kvc.broadcast(self.temp_h.copy(), device=dev),
                    kvc.broadcast(key, device=dev),
                    kvc.gather(prev, spec=(None,))]
            prog.output(*outs)
        hits0, low0 = LOWER_STATS["cache_hits"], LOWER_STATS["lowered"]
        te0 = time.perf_counter()
        with _spans.maybe_span("step-program", cat="wall",
                               step=self.step_idx,
                               program_id=prog.program_id):
            (table_d, admit_d, atok_d, apos_d, aprm_d, plen_d, evict_d,
             temp_d, key_d, prev_host) = prog.execute(self._sampled)
        exec_wall = time.perf_counter() - te0
        self._lower_hits += LOWER_STATS["cache_hits"] - hits0
        self._lower_lookups += (LOWER_STATS["cache_hits"] - hits0
                                + LOWER_STATS["lowered"] - low0)
        if self._lower_lookups:
            self.metrics.gauge("serve.lower_cache_hit_ratio").set(
                self._lower_hits / self._lower_lookups)
        mon = _drift.active_monitor()
        if mon is not None:
            mon.observe_plan(prog._lowered_default().plan, exec_wall)
        self.programs_recorded += 1
        self.last_program = prog
        self._apply_meta(prev_host.numpy())

        # -- the paged-decode + on-device-sampling step
        self._device_step(table_d, admit_d, atok_d, apos_d, aprm_d, plen_d,
                          evict_d, temp_d, key_d)
        self._sync()

        # -- host mirrors advance deterministically; note which lanes just
        #    produced a *generated* (post-prefill) token
        gen_this_step = 0
        for b in range(B):
            if not self.active_h[b]:
                continue
            p = int(self.pos_h[b])
            if p + 1 >= self.plen_h[b]:
                req = self.slot_req[b]
                self._meta.append((b, req, p + 1 - int(self.plen_h[b])))
                gen_this_step += 1
            self.pos_h[b] = p + 1
        self.step_idx += 1
        dt = time.perf_counter() - t0
        self.metrics.counter("serve.steps").inc()
        self.metrics.histogram("serve.step_seconds").observe(dt)
        if gen_this_step:
            self.metrics.counter("serve.generated_tokens").inc(
                gen_this_step)
            tok_hist = self.metrics.histogram("serve.token_seconds")
            for _ in range(gen_this_step):
                tok_hist.observe(dt)

    # ------------------------------------------------------------------ run
    def run(self, requests: list[Request] | None = None, *,
            max_steps: int = 10_000) -> dict[str, Any]:
        """Drive the arrival trace to completion; returns throughput and
        per-token latency metrics plus the finished requests."""
        for r in requests or []:
            self.submit(r)
        t0 = time.perf_counter()
        while self.queue or self.active_h.any():
            if self.step_idx >= max_steps:
                raise RuntimeError(f"no convergence in {max_steps} steps")
            self.step()
        self._drain()
        wall = time.perf_counter() - t0
        n_tok = int(self.metrics.value("serve.generated_tokens"))
        tps = n_tok / wall if wall > 0 else 0.0
        self.metrics.gauge("serve.tokens_per_s").set(tps)
        return {
            "steps": self.step_idx,
            "wall_s": wall,
            "generated_tokens": n_tok,
            "tokens_per_s": tps,
            "p50_token_s": self.metrics.quantile("serve.token_seconds",
                                                 0.50),
            "p99_token_s": self.metrics.quantile("serve.token_seconds",
                                                 0.99),
            "programs_recorded": self.programs_recorded,
            "preemptions": sum(r.preemptions for r in self.finished),
            "finished": list(self.finished),
        }

    def reset_metrics(self) -> None:
        """Zero the registry and run-scoped bookkeeping (warmup boundary
        for benchmarks); in-flight request state is untouched."""
        self.metrics.reset()
        self._lower_hits = 0
        self._lower_lookups = 0
        self.programs_recorded = 0
        self.finished.clear()


def poisson_trace(n_requests: int, *, rate: float, plen_range=(4, 16),
                  max_new_range=(4, 12), temperature: float = 0.0,
                  vocab: int = 256, seed: int = 0) -> list[Request]:
    """A Poisson arrival trace (``rate`` = mean arrivals per engine step)
    with mixed prompt/output lengths; the same NumPy draws as the
    reference's, so both packages serve the same trace from one seed."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.randint(plen_range[0], plen_range[1] + 1))
        reqs.append(Request(
            rid=i,
            prompt=rng.randint(0, vocab, plen).astype(int).tolist(),
            max_new=int(rng.randint(max_new_range[0],
                                    max_new_range[1] + 1)),
            temperature=temperature,
            arrival=int(arrivals[i])))
    return reqs


__all__ = ["Request", "ServeEngine", "poisson_trace"]
