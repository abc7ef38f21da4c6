"""Adapter trimming, demultiplexing and read splitting, batched on device.

The pipeline mirrors the reference trimmer's three stages
(ref: trim/trim.go):

1. *Edge pass* — the first/last 150 bases of every read are matched against
   all adapters.  Reference: per-read goroutines doing kmer-set popcounts
   and greedy chains (trim/trim.go:451-513).  Here: one device scan
   computes kmer-hit counts for all (edge, adapter) pairs at once, and
   surviving pairs go through the batched chain DP.
2. *Middle pass* — read interiors are chunked into the seed index and each
   adapter queried against it to find reads that must be split or cropped
   (trim/trim.go:515-591).
3. *Bookkeeping* — trims/ignores/splits are recorded on the SequenceSet and
   applied on re-read; splits become extra sequences.

Decision logic (thresholds, barcode precedence, +-5%% ambiguity, pair
requirements) follows the reference exactly; divergences: the chain DP
finds optimal chains where the reference's greedy walk may return shorter
ones, and consecutive-duplicate seeds are not dropped before chaining.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from ..core.sequence import Sequence
from ..seeds import SeedIndex
from ..ops import match as match_ops
from ..ops.window_engine import WindowChainEngine

EDGE_SIZE = 150          # bases searched for edge adapters (trim.go:453)
LONGEST_ADAPTER = 100    # padding around adapters mid-read (trim.go:153)
MIN_SPLIT_SEQ = 500      # splits must leave this many bases (trim.go:517)
MIN_CHUNK_SEEDS = 4      # chunks with fewer seeds are not indexed
REINDEX_SEEDS = 300_000_000


def _int_div(a: int, b: int) -> int:
    q = abs(a) // b
    return -q if a < 0 else q


class _EdgeResult:
    __slots__ = ("earliest", "latest", "found", "best_match")

    def __init__(self, earliest, latest, found, best_match):
        self.earliest = earliest
        self.latest = latest
        self.found = found
        self.best_match = best_match


class Trimmer:
    def __init__(self, front_adapters: List[Sequence],
                 back_adapters: List[Sequence], k: int = 6,
                 verbosity: int = 1, mesh=None):
        self.k = k
        self.verbosity = verbosity
        self.mesh = mesh  # optional jax Mesh with a "data" axis: window
        # batches shard across it, adapter tables replicate (multi-chip)
        self.original_front = list(front_adapters)
        self.original_back = list(back_adapters)
        self._setup_index()
        self.set_trim_params(85, 5, 50, 1000, False, True, False)
        self.no_count = 0
        self.seen_count = 0

    # ------------------------------------------------------------------
    def _setup_index(self):
        """Build the adapter seed index (ref: trim/trim.go:57-99)."""
        self.index = SeedIndex(self.k)
        self.front_adapters = []
        self.back_adapters = []
        self.front_sets: List[np.ndarray] = []   # distinct seed ids
        self.back_sets: List[np.ndarray] = []
        for s in self.original_front:
            self.front_adapters.append(self.index.new_all_seed_sequence(s))
        for s in self.original_back:
            self.back_adapters.append(self.index.new_all_seed_sequence(s))
        # adapter k-mer seed sets use collapsed kmers (trim.go:67)
        for s in self.original_front:
            self.front_sets.append(
                self.index.get_seeds_from_kmers(s.short_kmers(self.k, True)))
        for s in self.original_back:
            self.back_sets.append(
                self.index.get_seeds_from_kmers(s.short_kmers(self.k, True)))
        self.front_counts = [0] * len(self.original_front)
        self.back_counts = [0] * len(self.original_back)
        # name-based front/back pairing (trim.go:80-98)
        pair_id = 1
        self.pairs_front = [-1] * len(self.original_front)
        self.pairs_back = [-1] * len(self.original_back)
        for i, a in enumerate(self.original_front):
            name = a.get_name()
            for j, b in enumerate(self.original_back):
                if self.pairs_back[j] == -1 and b.get_name() == name:
                    self.pairs_front[i] = pair_id
                    self.pairs_back[j] = pair_id
                    pair_id += 1
                    break
        self._engine_obj = None

    def set_trim_params(self, mid_threshold: int, extra_edge_trim: int,
                        extra_mid_trim: int, chunk_size: int,
                        keep_splits: bool, tag_adapters: bool,
                        require_pairs: bool):
        self.mid_threshold = mid_threshold
        self.extra_edge_trim = extra_edge_trim
        self.extra_mid_trim = extra_mid_trim
        self.chunk_size = chunk_size
        self.keep_splits = keep_splits
        self.tag_adapters = tag_adapters
        self.require_pairs = require_pairs

    def set_verbosity(self, level: int):
        self.verbosity = level

    def _log(self, *args, level=1):
        if self.verbosity >= level:
            print(*args, file=sys.stderr)

    # -- the device engine ----------------------------------------------
    WINDOW = 256  # unified window/edge width in bases (one compile shape)

    def _engine(self) -> WindowChainEngine:
        if self._engine_obj is None:
            # anchor width sized to the real adapter set (bundled ONT
            # adapters have <= 45 seeds) - the chain DP's sequential scan
            # length is 2*nq, so a tight fit cuts the hot loop directly
            longest = max((ad.num_seeds for ad in
                           self.front_adapters + self.back_adapters),
                          default=1)
            nq = min(128, max(16, -(-longest // 16) * 16))
            self._engine_obj = WindowChainEngine(
                self.front_adapters, self.back_adapters,
                self.front_sets, self.back_sets,
                self.index.kmer_map, self.index.seed_map, self.k,
                nq=nq, mesh=self.mesh)
        return self._engine_obj

    # -- edge matching --------------------------------------------------
    def _edge_mins(self, adapter_sets, min_match: int = 3):
        """Gate/chain thresholds: hits >= 3 OR >= ceil(aset/5)
        (ref: trim/trim.go:366)."""
        aset = np.array([max(1, len(st)) for st in adapter_sets])
        gate_min = np.minimum(3, -(-aset // 5))
        chain_min = np.full(len(adapter_sets), min_match, np.int32)
        return gate_min, chain_min

    def _edge_dispatch(self, edges, adapters, adapter_sets,
                       min_match: int = 3):
        """Upload + enqueue the edge match, returning engine futures."""
        front = adapters is self.front_adapters
        eng = self._engine()
        gate_min, chain_min = self._edge_mins(adapter_sets, min_match)
        return eng.match_dispatch(edges, front, gate_min, chain_min,
                                  self.WINDOW - self.k + 1)

    def _match_edges(self, edges: List[Sequence], adapters, adapter_sets,
                     counts, min_match: int = 3,
                     collect_identity_only: bool = False, rows=None):
        """Batched findMatches (ref: trim/trim.go:354-428).  Returns per
        edge an ``_EdgeResult`` plus per-(edge, adapter) identities."""
        n = len(edges)
        if rows is None:
            rows = self._engine().match_collect(
                self._edge_dispatch(edges, adapters, adapter_sets,
                                    min_match))
        per_edge_adapter_ident = {}
        results = [
            _EdgeResult(len(edges[i]) if i < n else EDGE_SIZE, 0, False, 0)
            for i in range(n)]

        # per-edge aggregation following findMatches' in-order walk
        # (hits iterated in adapter order, as the reference does)
        edge_state = {}
        for ei in range(n):
            for ai, summ in sorted(rows[ei]):
                ad = adapters[ai]
                identity = _int_div(int(summ["ident_cov_q"]) * 100,
                                    ad.length)
                per_edge_adapter_ident[(ei, ai)] = identity
                st = edge_state.setdefault(
                    ei, {"earliest": len(edges[ei]), "latest": 0,
                         "found": False, "best_ident": 0, "best_match": 0,
                         "barcoded": False, "ambiguous": False})
                counts[ai] += int(summ["n_chains"])
                is_barcode = ad.get_name().startswith("Barcode")
                if not st["barcoded"] and is_barcode:
                    st["barcoded"] = True
                    st["best_ident"] = identity
                    st["best_match"] = ai
                elif st["barcoded"]:
                    if is_barcode:
                        delta = identity - st["best_ident"]
                        st["ambiguous"] = -5 < delta < 5
                        if identity > st["best_ident"]:
                            st["best_ident"] = identity
                            st["best_match"] = ai
                elif identity > st["best_ident"]:
                    st["best_ident"] = identity
                    st["best_match"] = ai
                start = max(0, int(summ["earliest"]))
                end = min(len(edges[ei]), int(summ["latest"]))
                st["earliest"] = min(st["earliest"], start)
                st["latest"] = max(st["latest"], end)
                st["found"] = True
        for ei, st in edge_state.items():
            if st["ambiguous"]:
                # trim, but pretend no adapter was seen (trim.go:423-426)
                results[ei] = _EdgeResult(st["earliest"], st["latest"],
                                          False, 0)
            else:
                results[ei] = _EdgeResult(st["earliest"], st["latest"],
                                          st["found"], st["best_match"])
        return results, per_edge_adapter_ident

    # -- DetermineAdapters ----------------------------------------------
    def determine_adapters(self, seqs, num_reads: int, threshold: int,
                           batch_size: int = 2048):
        """Keep only adapters with a high-identity full match in the first
        ``num_reads`` reads (ref: trim/trim.go:272-324)."""
        front_enabled = [False] * len(self.front_adapters)
        back_enabled = [False] * len(self.back_adapters)
        batch: List[Sequence] = []

        def process(batch):
            fronts = [s.subsequence(0, EDGE_SIZE) for s in batch]
            backs = [s.subsequence(len(s) - EDGE_SIZE, len(s)) for s in batch]
            self._check_full_match(fronts, self.front_adapters,
                                   self.front_sets, threshold, front_enabled)
            self._check_full_match(backs, self.back_adapters,
                                   self.back_sets, threshold, back_enabled)

        for seq in seqs.get_n_sequences_from(0, num_reads):
            if len(seq) < EDGE_SIZE + 50:
                continue
            batch.append(seq)
            if len(batch) >= batch_size:
                process(batch)
                batch = []
        if batch:
            process(batch)
        kept_f = [a for a, en in zip(self.original_front, front_enabled) if en]
        kept_b = [a for a, en in zip(self.original_back, back_enabled) if en]
        self._log(f"{len(kept_f)} / {len(front_enabled)} front adapters "
                  "identified with high identity matches.")
        for a in kept_f:
            self._log(" -", a.get_name())
        self._log(f"{len(kept_b)} / {len(back_enabled)} back adapters "
                  "identified with high identity matches.")
        for a in kept_b:
            self._log(" -", a.get_name())
        self.original_front = kept_f
        self.original_back = kept_b
        self._setup_index()

    def _check_full_match(self, edges, adapters, adapter_sets, threshold,
                          enabled):
        """Batched isNewFullMatch (ref: trim/trim.go:326-352) — the
        per-adapter max coverage aggregates on device; one [A] fetch."""
        front = adapters is self.front_adapters
        eng = self._engine()
        min_hits_v = np.maximum(
            np.array([len(st) // 2 for st in adapter_sets]), 1)
        gate_min = min_hits_v.copy()
        gate_min[[i for i, en in enumerate(enabled) if en]] = 1 << 20
        covs = eng.enable_covs(edges, front, gate_min, min_hits_v,
                               self.WINDOW - self.k + 1)
        for ai in range(len(covs)):
            if _int_div(int(covs[ai]) * 100,
                        adapters[ai].length) >= threshold:
                enabled[ai] = True

    # -- Trim -------------------------------------------------------------
    def trim(self, seqs, batch_size: int = 2048, max_inflight: int = 2,
             checkpoint: Optional[str] = None, timer=None):
        """Edge pass + middle pass over all reads
        (ref: trim/trim.go:136-257).

        Up to ``max_inflight`` edge batches (front + back dispatches
        each) stay in flight before the oldest is fetched, so device
        compute, transfers and host work pipeline.

        ``checkpoint`` names a JSON snapshot file updated after every
        finished edge batch and after the middle pass; an interrupted run
        restarted with the same path resumes where it stopped (the
        natural resume points SURVEY §5 calls for)."""
        import os
        from collections import deque
        progress = {}
        if checkpoint and os.path.exists(checkpoint):
            progress = seqs.load_state(checkpoint)
            self._log("Resuming from checkpoint:", progress)
        if progress.get("middle_done"):
            return
        start_rid = int(progress.get("next_rid", 0))
        # without a checkpoint the middle pass streams straight off each
        # finished edge batch (trims applied via zero-copy subsequence):
        # the file is read ONCE and middle-window device batches pipeline
        # behind the edge pass.  Checkpointed runs keep the re-reading
        # two-pass flow, whose stage boundaries are the resume points.
        stream = None if checkpoint else self._mid_stream(seqs)
        # middle-window packing/dispatch/collect runs on ONE worker
        # thread: profiled on the main thread it serialized with edge
        # collects and starved the device (mid_add+mid_fin was ~60% of
        # trim wall); the stream's state is touched only by this worker
        # until the drain below
        from concurrent.futures import ThreadPoolExecutor
        stream_ex = ThreadPoolExecutor(max_workers=1) if stream else None
        stream_futs = []

        def feed_stream(batch_seqs):
            subs = []
            for s in batch_seqs:
                rid = s.id
                if seqs.ignore[rid]:
                    continue
                df = seqs.get_front_trim(rid)
                db = seqs.get_back_trim(rid)
                subs.append(s.subsequence(df, len(s) - db))
            stream_futs.append(stream_ex.submit(stream.add_batch, subs))

        if not progress.get("edges_done"):
            self._log("Trimming ends and indexing all sequences against",
                      len(self.front_adapters), "adapters...")
            pending = deque()   # (state, batch reads)
            batch: List[Sequence] = []

            def finish_one():
                state, batch_seqs = pending.popleft()
                self._finish_edge_batch(seqs, state)
                if stream is not None:
                    feed_stream(batch_seqs)
                if checkpoint:
                    seqs.save_state(checkpoint,
                                    {"next_rid": batch_seqs[-1].id + 1})

            n_edge = 0
            for seq in seqs.get_sequences(start=start_rid):
                batch.append(seq)
                n_edge += 1
                if len(batch) >= batch_size:
                    pending.append((self._dispatch_edge_batch(batch),
                                    batch))
                    batch = []
                    if len(pending) > max_inflight:
                        finish_one()
            if batch:
                pending.append((self._dispatch_edge_batch(batch), batch))
            while pending:
                finish_one()
            if timer is not None:
                timer.add_items("trim:edges", n_edge)
            if checkpoint:
                seqs.save_state(checkpoint, {"edges_done": True})

        # middle pass: split reads on interior adapters
        if stream is not None:
            for f in stream_futs:     # drain the feed worker (and
                f.result()            # surface any exception)
            stream_ex.shutdown(wait=True)
            stream.finish()
        else:
            self._middle_pass(seqs)
        if checkpoint:
            seqs.save_state(checkpoint,
                            {"edges_done": True, "middle_done": True})

    def _dispatch_edge_batch(self, batch: List[Sequence]):
        """Upload one edge batch and enqueue both on-device verdicts (no
        fetch; the per-edge adapter walk happens inside the kernel)."""
        usable = [s for s in batch if len(s) >= EDGE_SIZE + 50]
        self.seen_count += len(batch)
        eng = self._engine()
        W = self.WINDOW - self.k + 1
        fronts = [s.subsequence(0, EDGE_SIZE) for s in usable]
        backs = [s.subsequence(len(s) - EDGE_SIZE, len(s)) for s in usable]
        gm_f, cm_f = self._edge_mins(self.front_sets)
        gm_b, cm_b = self._edge_mins(self.back_sets)
        pair = eng.edge_pair_dispatch(fronts, backs, gm_f, cm_f,
                                      gm_b, cm_b, W)
        if pair is not None:
            return usable, pair, None
        ff = eng.edge_verdict_dispatch(fronts, True, gm_f, cm_f, W)
        fb = eng.edge_verdict_dispatch(backs, False, gm_b, cm_b, W)
        return usable, ff, fb

    def _finish_edge_batch(self, seqs, state):
        """Fetch one dispatched edge batch's verdict rows and apply trims
        (ref trimWorker, trim/trim.go:451-513)."""
        usable, ff, fb = state
        eng = self._engine()
        if fb is None:        # paired one-dispatch form
            fv, fc, bv, bc = eng.edge_pair_collect(
                ff, len(self.front_adapters), len(self.back_adapters))
        else:
            fv, fc = eng.edge_verdict_collect(ff,
                                              len(self.front_adapters))
            bv, bc = eng.edge_verdict_collect(fb,
                                              len(self.back_adapters))
        for ai, c in enumerate(fc):
            self.front_counts[ai] += int(c)
        for ai, c in enumerate(bc):
            self.back_counts[ai] += int(c)
        n = len(usable)
        if n == 0:
            return
        # vectorized trimWorker decision rules (ref: trim/trim.go:471-509)
        found_f = fv[:n, 0].astype(bool)
        found_b = bv[:n, 0].astype(bool)
        mi_f = fv[:n, 1]
        mi_b = bv[:n, 1]
        if self.require_pairs:
            pf = np.where(found_f, np.asarray(self.pairs_front)[mi_f], -1)
            pb = np.where(found_b, np.asarray(self.pairs_back)[mi_b], -1)
            bad = pf != pb
            found_f = found_f & ~bad
            found_b = found_b & ~bad
        self.no_count += int(np.sum(~found_f))
        start = fv[:n, 3] + self.extra_edge_trim
        end = EDGE_SIZE - bv[:n, 2] + self.extra_edge_trim
        lens = np.fromiter((len(s) for s in usable), np.int64, n)
        rids = np.fromiter((s.id for s in usable), np.int64, n)
        ign = (start + end + 10) >= lens
        live = ~ign
        set_front = live & (found_f | ((end > start) & (start > 0)))
        set_back = live & (found_b | ((end > start) & (end < lens)))
        for i in np.flatnonzero(ign):
            seqs.set_ignore(int(rids[i]), True)
        for i in np.flatnonzero(set_front):
            seqs.set_front_trim(int(rids[i]), int(start[i]))
        if self.tag_adapters:
            for i in np.flatnonzero(live & found_f):
                rid = int(rids[i])
                seqs.set_name(rid, self.front_adapters[int(mi_f[i])]
                              .get_name() + "_" + seqs.get_name(rid))
        for i in np.flatnonzero(set_back):
            seqs.set_back_trim(int(rids[i]), int(end[i]))

    # -- middle pass -------------------------------------------------------
    def _mid_min_matches(self) -> np.ndarray:
        """Gate/chain threshold per adapter for the middle pass: a chain
        of L anchors covers at most L*k bases, so mid_threshold% identity
        needs L >= ceil(thr*len/(100*k)) shared seeds."""
        return np.array([
            max(3, ad.num_seeds // 5,
                -(-self.mid_threshold * ad.length // (100 * self.k)))
            for ad in self.front_adapters])

    def _mid_stream(self, seqs, window_batch: Optional[int] = None):
        """Streaming middle pass (see ``_MidStream``); feed trimmed reads
        with ``add``, then ``finish``."""
        return _MidStream(self, seqs, window_batch)

    def _middle_pass(self, seqs, window_batch: Optional[int] = None):
        """Search read interiors for read-splitting adapters by
        re-reading the sequence set (the checkpointed two-pass flow;
        ``trim`` without a checkpoint streams the middle pass off the
        edge pass instead, saving the second file read)."""
        stream = self._mid_stream(seqs, window_batch)
        batch: List[Sequence] = []
        for seq in seqs.get_sequences():
            batch.append(seq)
            if len(batch) >= 2048:
                stream.add_batch(batch)
                batch = []
        stream.add_batch(batch)
        stream.finish()

    def _dispatch_windows(self, windows: List[Sequence]):
        """Upload + enqueue one interior-window batch (no fetch).  The
        identity-threshold detection filter runs inside the kernel; only
        compact (window, adapter, start, identity) rows come back."""
        eng = self._engine()
        # a chain of L anchors covers at most L*k bases of the adapter, so
        # reaching mid_threshold% identity needs L >= ceil(thr*len/(100*k))
        # distinct shared seeds; the gate demands it outright
        min_matches = np.array([
            max(3, ad.num_seeds // 5,
                -(-self.mid_threshold * ad.length // (100 * self.k)))
            for ad in self.front_adapters])
        # interior windows rarely contain an adapter: compact the chain
        # DP to gate-passing pairs (auto-fallback on overflow)
        return windows, eng.window_verdict_dispatch(
            windows, min_matches, min_matches, self.mid_threshold,
            self.WINDOW - self.k + 1, pair_budget=16384)

    def _collect_windows(self, state):
        """Fetch one dispatched window batch and map detection rows back
        to read coordinates."""
        windows, futures = state
        rows = self._engine().window_verdict_collect(futures)
        detections = []
        for ei, ai, start, identity in rows:
            w = windows[int(ei)]
            orig_len = len(w) + w.offset + w.inset
            detections.append((w.id, int(ai), w.offset + int(start),
                               int(identity), orig_len))
        return detections

    def _match_windows(self, windows: List[Sequence]):
        """Gate + chain a batch of interior windows against all front
        adapters; returns (read_id, adapter_idx, start_in_original_read,
        identity, original_length) detections with identity >=
        mid_threshold."""
        return self._collect_windows(self._dispatch_windows(windows))

    def _window_detections(self, windows, rows):
        detections = []
        for ei, row in enumerate(rows):
            w = windows[ei]
            orig_len = len(w) + w.offset + w.inset
            for ai, summ in row:
                ad = self.front_adapters[ai]
                for j in range(len(summ["top_valid"])):
                    if not summ["top_valid"][j]:
                        continue
                    identity = _int_div(int(summ["top_cov_q"][j]) * 100,
                                        ad.length)
                    if identity < self.mid_threshold:
                        continue
                    start = int(summ["top_stp"][j]) - int(summ["top_sqp"][j])
                    detections.append((w.id, ai, w.offset + start, identity,
                                       orig_len))
        return detections

    def _record_split(self, seqs, splits, ad, rid, start, orig_len):
        """Split/crop bookkeeping for one adapter match, in original-read
        coordinates (ref: trim/trim.go:530-585)."""
        front_trim = seqs.get_front_trim(rid)
        back_trim = seqs.get_back_trim(rid)
        seq_len = orig_len - back_trim
        if start < MIN_SPLIT_SEQ + front_trim:
            # crop the front off
            new_trim = start + ad.length + self.extra_mid_trim
            if new_trim + MIN_SPLIT_SEQ < seq_len:
                if new_trim > front_trim:
                    seqs.set_front_trim(rid, new_trim)
                    if rid in splits:
                        splits[rid][0] -= new_trim - front_trim
                        splits[rid][1] -= new_trim - front_trim
                if self.tag_adapters:
                    seqs.set_name(rid, ad.get_name() + "_" + seqs.get_name(rid))
            else:
                splits.pop(rid, None)
                seqs.set_ignore(rid, True)
        elif start + MIN_SPLIT_SEQ + ad.length > seq_len:
            new_trim = seq_len - start + self.extra_mid_trim
            if new_trim > back_trim:
                seqs.set_back_trim(rid, new_trim)
        else:
            a_end = start - self.extra_mid_trim - front_trim
            b_start = start + ad.length + self.extra_mid_trim - front_trim
            if rid in splits:
                splits[rid][0] = min(splits[rid][0], a_end)
                splits[rid][1] = max(splits[rid][1], b_start)
            else:
                splits[rid] = [a_end, b_start]

    def _apply_splits(self, seqs, splits):
        """Materialize splits as extra sequences (ref: trim/trim.go:221-257)."""
        if not splits:
            return
        ids = sorted(splits.keys())
        by_id = {}
        for s in seqs.get_sequences_by_id(ids):
            by_id[s.id] = s
        for rid in ids:
            a_end, b_start = splits[rid]
            seq = by_id.get(rid)
            if seq is None:
                continue
            if self.keep_splits:
                if a_end > EDGE_SIZE:
                    seqs.add_sequence(seq.subsequence(0, a_end),
                                      seqs.get_name(rid) + "_(left)")
                if len(seq) - b_start > EDGE_SIZE:
                    seqs.add_sequence(seq.subsequence(b_start, len(seq)),
                                      seqs.get_name(rid) + "_(right)")
            seqs.set_ignore(rid, True)

    # ------------------------------------------------------------------
    def print_stats(self):
        """Adapter incidence summary (ref: trim/trim.go:260-268)."""
        seen = max(1, self.seen_count)
        for i, count in enumerate(self.front_counts):
            self._log("Front adapter:",
                      self.original_front[i].get_name(), "\t",
                      (count * 100) // seen, "%")
        for i, count in enumerate(self.back_counts):
            self._log("Back adapter:",
                      self.original_back[i].get_name(), "\t",
                      (count * 100) // seen, "%")
        self._log((self.no_count * 100) // seen, "% with no adapters found.")


class _MidStream:
    """Streaming middle pass: search read interiors for read-splitting
    adapters.

    The reference chunks interiors into the seed index and retrieves
    candidates per adapter with the soft-union, re-indexing every 300M
    seeds (ref: trim/trim.go:151-257, 515-591).  The device shape is
    uniform 256-base interior windows (any adapter lies fully inside one
    window) gated by the same device scan as the edge pass, then
    batch-chained; the rolling index and re-index rounds disappear.  The
    split/crop decision logic and thresholds are the reference's.

    Windows are cut as 2-bit packed byte rows straight out of each
    read's packed code array (starts aligned to 4 bases) — no per-window
    python objects or copies on the hot path.  Feed (already-trimmed)
    reads one at a time with ``add``; batches dispatch as the fixed
    window buffer fills, so device work pipelines behind the caller's
    own host work (the edge pass, when driven by ``Trimmer.trim``)."""

    def __init__(self, trimmer, seqs, window_batch: Optional[int] = None):
        from collections import deque
        from ..ops.chain import _use_fixed_buckets
        if window_batch is None:
            # big fixed-shape dispatches amortize per-call dispatch cost,
            # but TOO big serializes the whole middle pass at finish(): at 32768 a 4096-read job never
            # filled one batch, so every middle window waited for the
            # edge pass to end (profiled: 0.46 s of 0.83 s total in the
            # tail).  16384 starts computing mid-job while staying small
            # enough that earlier batches compute while the edge pass is
            # still streaming reads; CPU tests keep a small shape
            window_batch = 16384
        self.t = trimmer
        self.seqs = seqs
        self.window_batch = window_batch
        # 512-base middle windows: vs 256 the stride/window redundancy
        # drops 1.3x -> 1.12x and the (window x top-adapter) DP pair
        # count halves at the same detection guarantee (any adapter
        # occurrence still lies fully inside one window); the edge pass
        # keeps its own 256 shape
        self.win = 512
        self.CL4 = self.win // 4
        # stride windows so any occurrence of the LONGEST REAL adapter
        # lies fully inside one window (the reference pads a fixed 100
        # bases, trim.go:153; sizing to the actual set cuts the window
        # count ~25% with the bundled <=50-base adapters)
        pad = min(LONGEST_ADAPTER,
                  max((ad.length for ad in trimmer.front_adapters),
                      default=LONGEST_ADAPTER))
        self.step = ((self.win - pad - trimmer.k) // 4) * 4
        self.lo0 = (EDGE_SIZE // 4) * 4
        self.eng = trimmer._engine()
        self.W = self.win - trimmer.k + 1
        self.min_matches = trimmer._mid_min_matches()
        self.enabled = len(self.min_matches) > 0
        self._fixed = _use_fixed_buckets()

        N_SLOTS = 4
        self.bufs = [(np.zeros((window_batch, self.CL4), np.uint8),
                      np.zeros(window_batch, np.int32))
                     for _ in range(N_SLOTS)]
        self.slot = 0
        self.rows, self.lens = self.bufs[0]
        # per-window metadata as array chunks (rid, abs_start, orig_len)
        self.metas: List[tuple] = []
        self.count = 0
        self.detections: List[tuple] = []
        self.pending = deque()
        self._codes_buf = None

    def _dispatch(self):
        if self.count == 0:
            return
        from ..ops.chain import _bucket
        t = self.t
        nb = self.window_batch if self._fixed else _bucket(self.count)
        if t.mesh is not None:
            D = t.mesh.shape["data"]
            nb = ((nb + D - 1) // D) * D
        nb = min(nb, self.window_batch)
        self.rows[self.count : nb] = 0
        self.lens[self.count : nb] = 0
        up = self.eng.upload_rows(self.rows[:nb], self.lens[:nb],
                                  self.count)
        # budget the chain DP to 1 gate-passing pair per 4 windows (the
        # chain_min gate rejects almost all interior windows; barcode-
        # flank-dense inputs overflow and transparently re-run full-grid)
        futs = self.eng.window_verdict_dispatch_packed(
            [up + (0,)], self.min_matches, self.min_matches,
            t.mid_threshold, self.W, pair_budget=max(4096, nb // 4))
        m = self.metas
        ms = m[0] if len(m) == 1 else tuple(
            np.concatenate([c[i] for c in m]) for i in range(3))
        self.pending.append((ms, futs))
        self.slot = (self.slot + 1) % len(self.bufs)
        self.rows, self.lens = self.bufs[self.slot]
        self.metas = []
        self.count = 0
        if len(self.pending) > 2:
            self._collect()

    def _collect(self):
        ms, futs = self.pending.popleft()
        rid_a, abs_a, len_a = ms
        for ei, ai, start, identity in \
                self.eng.window_verdict_collect(futs):
            e = int(ei)
            self.detections.append((int(rid_a[e]), int(ai),
                                    int(abs_a[e]) + int(start),
                                    int(identity), int(len_a[e])))

    def add(self, seq: Sequence):
        """Queue one (trimmed) read's interior windows."""
        self.add_batch([seq])

    def add_batch(self, seqs_list: List[Sequence]):
        """Queue a batch of (trimmed) reads' interior windows in one
        numpy pass: pack every read's codes 2-bit, cut all window rows
        with a single strided fancy-index, and keep per-window metadata
        as arrays — the per-read version spent ~80 us/read on Python
        allocation and tuple bookkeeping, which dominated the middle
        pass's host side."""
        if not self.enabled or not seqs_list:
            return
        k = self.t.k
        win, CL4, lo0, step = self.win, self.CL4, self.lo0, self.step
        B = len(seqs_list)
        ns_all = np.fromiter((len(s) for s in seqs_list), np.int64, B)
        ok = (ns_all - EDGE_SIZE - lo0) >= (k + 4)
        if not ok.any():
            return
        idxs = np.flatnonzero(ok)
        ns = ns_all[idxs]
        his = ns - EDGE_SIZE
        last = np.maximum(lo0, ((his - win) // 4) * 4)
        base = (last - lo0) // step + 1
        tail = ((last - lo0) % step) != 0
        nw = base + tail
        tot = int(nw.sum())
        cum = np.zeros(len(idxs) + 1, np.int64)
        np.cumsum(nw, out=cum[1:])
        rix = np.repeat(np.arange(len(idxs)), nw)
        j = np.arange(tot) - cum[rix]
        start = np.where(j < base[rix], lo0 + j * step, last[rix])
        wl = (np.minimum(win, his[rix] - start) - k + 1).astype(np.int32)
        # pack all codes in one pass (reused buffer: fresh multi-MB
        # allocations fault pages at pathological cost here)
        R = len(idxs)
        L4 = int(ns.max() + 3) // 4 + CL4
        buf = self._codes_buf
        if buf is None or buf.shape[0] < R or buf.shape[1] < L4 * 4:
            rows_cap = max(R, 2048)
            width_cap = max(L4 * 4, buf.shape[1] if buf is not None else 0)
            buf = self._codes_buf = np.zeros((rows_cap, width_cap),
                                             np.uint8)
        codes2 = buf[:R, : L4 * 4]
        codes2[:] = 0
        for r in range(R):
            s = seqs_list[idxs[r]]
            codes2[r, : ns[r]] = s.codes
        c4 = codes2.reshape(R, -1, 4)
        pr2 = (c4[:, :, 0] << 6) | (c4[:, :, 1] << 4) \
            | (c4[:, :, 2] << 2) | c4[:, :, 3]
        sw = np.lib.stride_tricks.sliding_window_view(pr2, CL4, axis=1)
        block = sw[rix, start // 4]
        offs = np.fromiter((seqs_list[i].offset for i in idxs), np.int64, R)
        rids = np.fromiter((seqs_list[i].id for i in idxs), np.int64, R)
        olens = ns + offs + np.fromiter(
            (seqs_list[i].inset for i in idxs), np.int64, R)
        m_rid = rids[rix]
        m_abs = offs[rix] + start
        m_len = olens[rix]
        pos = 0
        while pos < tot:
            take = min(tot - pos, self.window_batch - self.count)
            self.rows[self.count : self.count + take] = \
                block[pos : pos + take]
            self.lens[self.count : self.count + take] = \
                wl[pos : pos + take]
            self.metas.append((m_rid[pos : pos + take],
                               m_abs[pos : pos + take],
                               m_len[pos : pos + take]))
            self.count += take
            pos += take
            if self.count >= self.window_batch:
                self._dispatch()

    def finish(self):
        """Flush, collect all detections, and apply splits."""
        t = self.t
        splits: dict = {}
        if self.enabled:
            self._dispatch()
            while self.pending:
                self._collect()
        # dedupe repeated detections of one occurrence across overlapping
        # windows: same read+adapter within 30 bases keeps best identity
        best = {}
        for rid, ai, start, identity, orig_len in self.detections:
            key = (rid, ai, start // 30)
            cur = best.get(key)
            if cur is None or identity > cur[3]:
                best[key] = (rid, ai, start, identity, orig_len)
        for rid, ai, start, identity, orig_len in sorted(best.values()):
            t._record_split(self.seqs, splits, t.front_adapters[ai],
                            rid, start, orig_len)
        t._log(len(splits), "sequences require splitting")
        t._apply_splits(self.seqs, splits)


def load_trimmer(front_path: Optional[str], back_path: Optional[str],
                 k: int = 6, verbosity: int = 1, mesh=None) -> Trimmer:
    """Create a Trimmer from adapter fasta files, or the bundled ONT
    adapter set when paths are empty (ref: trim/trim.go:102-116)."""
    from ..io import SequenceSet

    def load(path, bundled):
        if path:
            ss = SequenceSet(path)
            return [Sequence(s.codes, id=i, name=s.name)
                    for i, s in enumerate(ss.get_sequences())]
        return [Sequence.from_string(seq, id=i, name=name)
                for i, (name, seq) in enumerate(bundled)]

    from ..data import FRONT_ADAPTERS, BACK_ADAPTERS
    fronts = load(front_path, FRONT_ADAPTERS)
    backs = load(back_path, BACK_ADAPTERS)
    return Trimmer(fronts, backs, k, verbosity, mesh=mesh)
