"""Speculative decoding: the prompt-lookup (n-gram) proposer and the
batched verify round, shared by the slot and paged engines (port of
``skypilot_tpu/inference/speculative.py``).

Decode streams every weight once per generated token. Speculation
emits up to ``k + 1`` tokens per slot for one weight stream, with no
draft model:

- **Propose** (host, numpy): match the trailing n-gram of each slot's
  prompt + output against its own earlier history and propose the
  ``k`` tokens that followed the most recent match. The serve loop runs
  it OUTSIDE the engine lock (``prepare_proposals``).
- **Verify** (device): one forward over the ``k + 1`` positions ``[t0,
  d1..dk]`` per slot against the cache gives next-token logits at
  every position. Greedy rows accept the longest draft prefix that
  matches the argmax; sampled rows rejection-sample against the
  filtered distribution, so the committed stream is distributed as
  non-speculative sampling. A request's grammar mask applies to every
  position's logits before acceptance (the engines' verify rounds), so
  a draft outside the grammar is rejected like any other mismatch.
- **Commit** (masked, fixed shapes): all ``k + 1`` KV rows are
  computed; rows past each slot's accepted count never reach the cache
  (the paged pool's trash page; the slot cache's read-modify-write
  window) and the cache length advances by ``n_commit``. Acceptance
  never changes a shape, so the round is one CUDA graph per (k, sample,
  P or kv_bucket).

``decode_steps_per_call = rounds > 1`` fuses ``rounds`` whole
propose -> verify -> commit rounds into one graph, with the proposer on
the device (:func:`ngram_propose_device`) over a right-aligned history
window carried between rounds.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.telemetry import clock
from skypilot_tpu_torch.utils.device import host_sync


# --------------------------------------------------------------------------
# Host-side proposer (numpy only)
# --------------------------------------------------------------------------
def ngram_propose(hist, k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Prompt-lookup proposal: match the trailing ``m``-gram of ``hist``
    (longest ``m`` first, ``max_ngram`` down to ``min_ngram``) against
    its earlier occurrences and return up to ``k`` tokens that followed
    the MOST RECENT match. ``hist`` is the slot's prompt + generated
    tokens, last element = the current (not yet cached) token. Returns
    an int32 array of length 0..k (empty: nothing to propose)."""
    n = len(hist)
    if k <= 0 or n < min_ngram + 1:
        return np.zeros((0,), np.int32)
    arr = np.asarray(hist, np.int64)
    for m in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        pattern = arr[-m:]
        windows = np.lib.stride_tricks.sliding_window_view(arr, m)
        starts = np.nonzero((windows == pattern).all(axis=1))[0]
        # A usable match has a continuation strictly before the
        # trailing n-gram itself.
        starts = starts[starts + m < n]
        if len(starts):
            begin = int(starts[-1]) + m
            return arr[begin:begin + k].astype(np.int32)
    return np.zeros((0,), np.int32)


def ngram_propose_device(hist: torch.Tensor, k: int, max_ngram: int = 3,
                         min_ngram: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ngram_propose` on the device over a RIGHT-ALIGNED history
    window ``hist [b, H]`` int32, left-padded with -1 (no token matches
    the pad), last column = the current token. Fixed shapes, no host
    sync (no ``nonzero``, no ``.item()``): the most recent usable match
    is a ``max`` over masked window indices, so it runs inside a
    captured graph. Matches further back than the window are missed,
    which costs acceptance, never correctness.

    Returns ``(proposals [b, k] int32, n_prop [b] int32)`` with the
    positions past each row's ``n_prop`` zeroed."""
    b, H = hist.shape
    dev = hist.device
    best_begin = torch.zeros((b,), dtype=torch.int64, device=dev)
    best_found = torch.zeros((b,), dtype=torch.bool, device=dev)
    for m in range(min(max_ngram, H - 1), min_ngram - 1, -1):
        gram = hist[:, H - m:]                               # [b, m]
        win = torch.stack([hist[:, j:H - m + 1 + j] for j in range(m)],
                          dim=-1)                            # [b, W, m]
        p_idx = torch.arange(H - m + 1, device=dev)
        # Usable: a full match, its continuation strictly before the
        # trailing gram (p + m < H), clear of the left pad.
        ok = ((win == gram[:, None, :]).all(-1)
              & (p_idx[None, :] + m < H) & (win[:, :, 0] >= 0))
        p_best = p_idx[None, :].expand(b, -1).masked_fill(~ok, -1).amax(1)
        found = p_best >= 0
        best_begin = torch.where(found & ~best_found, p_best + m,
                                 best_begin)
        best_found = best_found | found
    j = torch.arange(k, device=dev)
    idx = torch.clamp(best_begin[:, None] + j[None, :], 0, H - 1)
    prop = torch.gather(hist, 1, idx)
    n_prop = torch.clamp(H - best_begin, max=k).masked_fill(~best_found, 0)
    prop = prop.masked_fill(j[None, :] >= n_prop[:, None], 0)
    return prop.to(torch.int32), n_prop.to(torch.int32)


# --------------------------------------------------------------------------
# Device-side acceptance (both engines' verify rounds)
# --------------------------------------------------------------------------
def verify_tokens(logits: torch.Tensor, proposals: torch.Tensor,
                  n_prop: torch.Tensor,
                  generator: Optional[torch.Generator],
                  temps: Optional[torch.Tensor],
                  topks: Optional[torch.Tensor],
                  topps: Optional[torch.Tensor], *,
                  sample: bool, rows: Optional[slice] = None,
                  n_rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched draft acceptance, on the device with fixed shapes.

    ``logits [b, k+1, vocab]`` fp32: position ``i`` is the next-token
    distribution after token ``i`` of ``[t0, d1..dk]``; ``proposals
    [b, k]`` int32; ``n_prop [b]`` valid drafts per row (the rest always
    reject).

    Greedy rows (``temp <= 0`` or ``sample=False``) accept the longest
    draft prefix that matches the per-position argmax, then take the
    model's own argmax: the stream of vanilla greedy decode.

    Sampled rows: rejection sampling against ``llama.filtered_logits``
    (temperature, top-k, top-p). The proposer is a point mass, so draft
    ``d`` is accepted with probability ``p(d)`` (one uniform per draft
    from ``generator``) and on the first rejection the replacement is
    drawn from the filtered row with ``d`` masked out, by the Gumbel-max
    draw of ``engine.sample_tokens``.

    ``logits`` may be the block ``rows`` of an ``n_rows`` batch (a dp
    rank's verify rows): each uniform is then drawn for the whole batch
    and this block taken, as ``engine.sample_tokens`` does, so every row
    gets the noise it gets without dp.

    Returns ``(commit [b, k+1] int32, n_commit [b] int32)``:
    ``commit[:, :n_commit-1]`` are accepted drafts and
    ``commit[:, n_commit-1]`` the model's own token; 1 <= n_commit <=
    k+1."""
    b, k1, vocab = logits.shape
    k = k1 - 1
    dev = logits.device
    proposals = proposals.long()
    greedy = torch.argmax(logits, -1)                        # [b, k+1]
    valid = torch.arange(k, device=dev)[None, :] < n_prop.long()[:, None]
    match = (proposals == greedy[:, :-1]) & valid
    if sample:
        masked = llama.filtered_logits(logits, temps[:, None],
                                       topks[:, None], topps[:, None])
        probs = torch.softmax(masked, dim=-1)                # [b, k+1, v]
        p_draft = torch.gather(probs[:, :k], 2, proposals[..., None])[..., 0]
        u = _uniform((b, k), generator, dev, rows, n_rows)
        match = torch.where(temps[:, None] > 0, (u < p_draft) & valid, match)
    # Accepted prefix length a: drafts 1..a all passed.
    a = torch.cumprod(match.long(), dim=1).sum(1)            # [b]
    corr = torch.gather(greedy, 1, a[:, None])[:, 0]
    padded = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], 1)
    if sample:
        # The replacement at position a: the rejected draft (when one
        # was rejected, a < n_prop) is masked out of the filtered row,
        # the rejection-sampling residual of a point-mass proposer.
        row = torch.gather(masked, 1, a[:, None, None].expand(b, 1, vocab)
                           )[:, 0]
        rej = torch.gather(padded, 1, a[:, None])[:, 0]
        mask_rej = ((a < n_prop.long())[:, None]
                    & (torch.arange(vocab, device=dev)[None, :]
                       == rej[:, None]))
        row = row.masked_fill(mask_rej, float('-inf'))
        u = _uniform((b, vocab), generator, dev, rows, n_rows)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
        sampled = torch.argmax(row + gumbel, -1)
        corr = torch.where(temps > 0, sampled, corr)
    j = torch.arange(k + 1, device=dev)[None, :]
    commit = torch.where(j < a[:, None], padded, corr[:, None])
    return commit.to(torch.int32), (a + 1).to(torch.int32)


def _uniform(shape, generator, dev, rows: Optional[slice],
             n_rows: int) -> torch.Tensor:
    """Uniforms of ``shape``, or this block ``rows`` of a draw for all
    ``n_rows`` rows."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=dev)
    return torch.rand((n_rows,) + tuple(shape[1:]), generator=generator,
                      device=dev)[rows]


def carry_history(hist: torch.Tensor, commit: torch.Tensor,
                  n_commit: torch.Tensor) -> torch.Tensor:
    """The right-aligned window after a round: the commit row appended
    and the window shifted left by ``n_commit`` (the reference's
    concat-then-gather at index ``H + n_commit``; uncommitted positions
    fall past the window)."""
    H = hist.shape[1]
    combined = torch.cat([hist, commit.to(hist.dtype)], dim=1)
    gidx = (torch.arange(H, device=hist.device)[None, :]
            + n_commit.long()[:, None])
    return torch.gather(combined, 1, gidx)


# --------------------------------------------------------------------------
# Engine scaffolding
# --------------------------------------------------------------------------
class SpeculativeMixin:
    """Propose -> verify -> commit scaffolding shared by the slot and
    paged engines. An engine calls ``_init_spec(speculate_k)`` from its
    constructor, implements ``_spec_verify_call(ready, proposals,
    n_prop)`` and ``_spec_fused_call(ready, rounds)`` (each returns the
    round's packed int32 output on the device, ``[b, k+3]`` or
    ``[rounds, b, k+3]``: the commit row, ``n_commit``, ``n_prop``, and
    updates the cache and the token vector), and routes ``step()``
    through ``_spec_step()`` or, with ``decode_steps_per_call > 1``,
    ``_spec_step_fused()``.

    A round is SYNCHRONOUS: the proposer needs the committed tokens on
    the host before it can propose again, so each round ends with ONE
    sanctioned ``host_sync`` of its packed output (one per ``rounds``
    rounds when fused)."""

    # Longest n-gram the proposer tries to match.
    spec_max_ngram = 3

    # History window the DEVICE proposer sees in fused rounds: the host
    # uploads each slot's trailing H tokens a call. It shapes the graph,
    # so it is a class constant, not a key.
    spec_hist_window = 64

    def _init_spec(self, speculate_k: Optional[int]) -> None:
        self.speculate_k = int(speculate_k or 0)
        if self.speculate_k < 0:
            raise ValueError(
                f'speculate_k must be >= 0, got {self.speculate_k}')
        self._spec_prepared: Optional[Dict[str, Dict[int, Any]]] = None
        self._spec_rounds = 0
        self._spec_slot_steps = 0     # (round, active slot) pairs
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_committed = 0
        # Verify dispatches: single rounds, and fused calls.
        self.spec_verify_calls = 0
        self.spec_fused_calls = 0
        # Host seconds from a round's dispatch to its readback.
        self.spec_round_s = 0.0
        # Under a serving mesh, a running crc32 of every round's packed
        # output as read back (commit rows, accepted counts, proposal
        # counts): equal trails on every rank mean every round committed
        # the same tokens everywhere (``state_by_rank``). 0 meshless.
        self.spec_trail = 0

    # ------------------------------------------------------------ metrics
    def spec_metrics(self) -> Dict[str, Any]:
        """Speculation gauges with a stable schema (every key present,
        zeros when speculation is off)."""
        proposed = self._spec_proposed
        slot_steps = self._spec_slot_steps
        return {
            'speculate_k': self.speculate_k,
            'spec_rounds': self._spec_rounds,
            'spec_proposed': proposed,
            'spec_accepted': self._spec_accepted,
            'spec_committed': self._spec_committed,
            'spec_accept_rate': (self._spec_accepted / proposed
                                 if proposed else 0.0),
            # Mean tokens committed per slot per verify round (1..k+1).
            'spec_tokens_per_step': (self._spec_committed / slot_steps
                                     if slot_steps else 0.0),
        }

    # ----------------------------------------------------------- proposer
    def prepare_proposals(self) -> None:
        """Host-only n-gram matching for the decodable slots. The serve
        loop calls it BEFORE taking the engine lock; the results are
        keyed by (request_id, len(output)) and checked again in
        ``_spec_build_proposals``, which recomputes a stale entry. Only
        the engine-loop thread changes slot outputs, so the reads here
        have one writer.

        Under a serving mesh this runs on rank 0 only, outside any
        mirrored call; the followers' ``_spec_build_proposals`` finds no
        prepared entry and proposes from its own histories, which are
        rank 0's token for token (every rank runs the same mirrored
        calls and commits the same all-gathered outputs), so every rank
        verifies the same proposals without sending them."""
        if not self.speculate_k:
            return
        prep: Dict[str, Dict[int, Any]] = {'key': {}, 'prop': {}}
        off = set(self._prefill_off)
        for slot, req in enumerate(list(self._slots)):
            if (req is None or slot in off or req.hold
                    or req.finish_time is not None):
                continue
            prep['key'][slot] = (req.request_id, len(req.output))
            prep['prop'][slot] = ngram_propose(
                req.prompt + req.output, self.speculate_k,
                max_ngram=self.spec_max_ngram)
        self._spec_prepared = prep

    def _spec_room(self, slot: int) -> int:
        """Extra per-engine cap on the proposal count of ``slot`` (page
        availability); -1: the slot cannot take even one more token
        (the engine preempts it). Default: no extra cap."""
        del slot
        return self.speculate_k

    def _spec_starved(self, slots: List[int]) -> None:
        """Hook for slots whose ``_spec_room`` was negative. Default:
        nothing (the slot engine's capacity is the budget cap)."""
        del slots

    def _spec_build_proposals(self, ready) -> Tuple[np.ndarray,
                                                    np.ndarray, List[int]]:
        """The fixed-shape ``[b, k]`` proposal matrix and per-slot valid
        counts. Each count is capped by the slot's remaining generation
        budget and sequence capacity (n_commit <= n_prop + 1 overshoots
        neither) and by ``_spec_room``. Returns (proposals, n_prop,
        starved slots)."""
        k = self.speculate_k
        b = self.max_batch
        proposals = np.zeros((b, k), np.int32)
        n_prop = np.zeros(b, np.int32)
        starved: List[int] = []
        cached = self._spec_prepared
        self._spec_prepared = None
        for slot, req in enumerate(ready):
            if req is None:
                continue
            room = self._spec_room(slot)
            if room < 0:
                starved.append(slot)
                continue
            out = len(req.output)
            budget = min(req.max_new_tokens - out,
                         self.max_seq - len(req.prompt) - out) - 1
            room = min(room, max(0, budget))
            if room <= 0:
                continue
            if (cached is not None and cached['key'].get(slot)
                    == (req.request_id, out)):
                prop = cached['prop'][slot]
            else:
                prop = ngram_propose(req.prompt + req.output, k,
                                     max_ngram=self.spec_max_ngram)
            m = min(len(prop), room)
            proposals[slot, :m] = prop[:m]
            n_prop[slot] = m
        return proposals, n_prop, starved

    def _spec_run(self, third: int, verify, rounds: int = 0
                  ) -> torch.Tensor:
        """Run a speculative call over the uploaded static buffers
        (``DecodeBuffers``) as one graph: a single round (``rounds`` 0;
        key ``('spec', k, sample, third)``) over the host's proposals, or
        ``rounds`` fused rounds (key ``('spec_fused', k, sample, third,
        rounds)``) with the device proposer, the history window and the
        budgets carried in place in the buffers. ``third`` is the
        paged table width P or the slot engine's kv bucket; ``verify
        (proposals, n_prop, active) -> (commit, n_commit)`` is the
        engine's round, which updates the cache and the token vector.
        The graph keys end with the engine's ``_graph_flags()``.
        Returns the packed output ``[b, k+3]`` (or ``[rounds, b, k+3]``)."""
        buf = self._buf
        k = self.speculate_k
        sample = self._sample
        # Bank present, mask on (the decode graphs' flags).
        flags = self._graph_flags()

        def pack(out, commit, n_commit, n_prop):
            out.copy_(torch.cat([commit, n_commit[:, None],
                                 n_prop[:, None]], 1))

        if not rounds:
            def body():
                commit, n_commit = verify(buf.proposals, buf.n_prop,
                                          buf.active != 0)
                pack(buf.spec_out[0], commit, n_commit, buf.n_prop)

            with self._prof.jit_key('spec_verify', (k, sample, third)):
                self._run_graph(('spec', k, sample, third) + flags, body,
                                sample)
            return buf.spec_out[0]

        def fused():
            active = buf.active != 0
            for r in range(rounds):
                prop, n_prop = ngram_propose_device(
                    buf.hist, k, max_ngram=self.spec_max_ngram)
                # The budget: n_commit <= n_prop + 1 <= rem, round by
                # round (_spec_build_proposals's cap).
                n_prop = torch.minimum(n_prop,
                                       torch.clamp(buf.rem - 1, min=0))
                commit, n_commit = verify(prop, n_prop,
                                          active & (buf.rem >= 1))
                buf.hist.copy_(carry_history(buf.hist, commit, n_commit))
                buf.rem.sub_(n_commit)
                pack(buf.spec_out[r], commit, n_commit, n_prop)

        with self._prof.jit_key('spec_fused', (k, sample, third, rounds)):
            self._run_graph(('spec_fused', k, sample, third, rounds)
                            + flags, fused, sample)
        return buf.spec_out[:rounds]

    def _spec_drain(self) -> List[Tuple[int, int, bool]]:
        """Read back every call in flight (the proposer and the commit
        bookkeeping need complete outputs)."""
        events: List[Tuple[int, int, bool]] = []
        while self._pending:
            events.extend(self._process_one())
        return events

    def _spec_commit(self, slot: int, req, row: np.ndarray,
                     n_prop: int, events, span=None) -> bool:
        """Append one round's committed tokens of ``slot`` (``row``: the
        packed output row, commit then n_commit, then n_prop) to its
        request, with ``n_prop`` proposals counted for it; ``span`` (the
        round's host (t0, t1)) adds a ``spec_round`` span to the
        request's trace. Returns whether the request finished."""
        k1 = self.speculate_k + 1
        m = int(row[k1])
        if m <= 0:
            return False
        if span is not None and req.trace is not None:
            req.trace.add('spec_round', span[0], span[1],
                          proposed=int(row[k1 + 1]), committed=m)
        self._spec_slot_steps += 1
        self._spec_proposed += n_prop
        self._spec_accepted += m - 1
        self._spec_committed += m
        for j in range(m):
            token = int(row[j])
            req.output.append(token)
            self._slot_len[slot] += 1
            finished = self._finish_req(slot, req, token)
            events.append((req.request_id, token, finished))
            if finished:
                return True
        return False

    # ----------------------------------------------------------- the step
    def _spec_step(self) -> List[Tuple[int, int, bool]]:
        """One propose -> verify -> commit round over every decodable
        slot: drain the pipeline, run ONE verify round, read its packed
        output back once and commit. Emits 1..k+1 tokens per active
        slot."""
        with self._prof.phase('readback'):
            events = self._spec_drain()
        ready = self._decode_ready()
        if not any(r is not None for r in ready):
            return events
        with self._prof.phase('spec_verify'):
            proposals, n_prop, starved = self._spec_build_proposals(ready)
            if starved:
                self._spec_starved(starved)
                ready = self._decode_ready()
                if not any(r is not None for r in ready):
                    return events
            t0 = clock.monotonic()
            out = self._spec_verify_call(ready, proposals, n_prop)
            # THE sanctioned readback of a round.
            out_h = host_sync(out)
        if self.mesh is not None:
            self.spec_trail = zlib.crc32(out_h.tobytes(), self.spec_trail)
        t1 = clock.monotonic()
        self.spec_round_s += t1 - t0
        self.spec_verify_calls += 1
        self._spec_rounds += 1
        self._spec_proposed += int(n_prop.sum())
        for slot, req in enumerate(ready):
            if req is None or req.finish_time is not None:
                continue
            self._spec_commit(slot, req, out_h[slot], 0, events, (t0, t1))
        return events

    # ------------------------------------------------- fused rounds
    def _spec_can_fuse(self, slot: int, rounds: int) -> bool:
        """Can ``slot`` absorb ``rounds`` fused rounds of KV growth (up to
        ``rounds * (k + 1)`` rows) with no host step between rounds?
        Default yes (the slot engine's masked window and the ``rem``
        budget bound the writes); the paged engine reserves the pages
        first."""
        del slot, rounds
        return True

    def _spec_hist_state(self, ready) -> Tuple[np.ndarray, np.ndarray]:
        """The device proposer's inputs: the right-aligned history
        window ``[b, H]`` (left-padded with -1) and each slot's
        remaining-token budget ``rem [b]`` (generation budget and
        sequence capacity), so the in-graph cap ``n_prop <= rem - 1``
        is ``_spec_build_proposals``'s budget cap, round by round."""
        H = self.spec_hist_window
        b = self.max_batch
        hist = np.full((b, H), -1, np.int32)
        rem = np.zeros((b,), np.int32)
        for slot, req in enumerate(ready):
            if req is None:
                continue
            toks = (req.prompt + req.output)[-H:]
            hist[slot, H - len(toks):] = toks
            out = len(req.output)
            rem[slot] = max(0, min(req.max_new_tokens - out,
                                   self.max_seq - len(req.prompt) - out))
        return hist, rem

    def _spec_step_fused(self) -> List[Tuple[int, int, bool]]:
        """``decode_steps_per_call`` rounds of propose -> verify ->
        commit in ONE dispatch (one graph), then one sanctioned readback
        of the stacked outputs. Tokens a slot commits after it finished
        in an earlier round (the device cannot see eos or stop) are
        dropped at readback; the ``rem`` budget keeps every write inside
        ``max_new_tokens`` and the sequence capacity. When a slot cannot
        reserve the fused KV growth (``_spec_can_fuse``: paged pool
        pressure) the step runs the single round instead."""
        rounds = self.decode_steps_per_call or 1
        if rounds <= 1:
            return self._spec_step()
        with self._prof.phase('readback'):
            events = self._spec_drain()
        ready = self._decode_ready()
        if not any(r is not None for r in ready):
            return events
        if not all(self._spec_can_fuse(slot, rounds)
                   for slot, r in enumerate(ready) if r is not None):
            events.extend(self._spec_step())
            return events
        t0 = clock.monotonic()
        with self._prof.phase('spec_verify'):
            out = self._spec_fused_call(ready, rounds)
            # THE sanctioned readback: one per ``rounds`` rounds.
            out_h = host_sync(out)
        if self.mesh is not None:
            self.spec_trail = zlib.crc32(out_h.tobytes(), self.spec_trail)
        t1 = clock.monotonic()
        self.spec_round_s += t1 - t0
        self.spec_fused_calls += 1
        self._spec_rounds += rounds
        k2 = self.speculate_k + 2
        for slot, req in enumerate(ready):
            if req is None or req.finish_time is not None:
                continue
            for r in range(rounds):
                if self._spec_commit(slot, req, out_h[r, slot],
                                     int(out_h[r, slot, k2]), events,
                                     (t0, t1)):
                    break
        return events
