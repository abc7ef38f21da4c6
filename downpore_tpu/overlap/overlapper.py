"""All-vs-all overlap detection.

Mirrors the reference overlapper (ref: overlap/overlap.go): queries are
read edges (or centres / whole reads) that contribute seeds to a shared
batch until ``seed_limit`` unique seeds exist; every read is then chopped
into ~chunk-size pieces with overlap/2 step-back and indexed; overlaps are
retrieved with the hit-fraction rule and chained.

Device mapping: candidate retrieval + the distinct-seed popcount gate are
batched int8 matmuls over the whole query set at once; chaining is the
batched anchor DP with the seedAligner gap window
(ref: seeds/alignment.go:411-424), returning full chains via backpointers.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from ..core.sequence import Sequence
from ..seeds import SeedIndex, SeedSequence
from ..seeds.seed_sequence import SeedMatch

QUERY_EDGES = 1
QUERY_CENTRE = 2
QUERY_ALL = 4
WEIGHT_EDGES = 8


class SeedQuery:
    """(ref: overlap/overlap.go:10-16)"""
    __slots__ = ("id", "sequence_id", "query", "at_start", "rc")

    def __init__(self, id: int, sequence_id: int, query: SeedSequence,
                 at_start: bool, rc: bool):
        self.id = id
        self.sequence_id = sequence_id
        self.query = query
        self.at_start = at_start
        self.rc = rc


class Overlapper:
    def __init__(self, index: SeedIndex, chunk_size: int, overlap: int,
                 min_seeds: int, hit_fraction: float, mesh=None,
                 shape_plan: Optional[dict] = None):
        self.index = index
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.min_seeds = min_seeds
        self.hit_fraction = hit_fraction
        self.mesh = mesh  # optional jax Mesh with a "data" axis: query
        # rows and chain pairs shard across it, the index replicates
        # per-JOB compiled-shape plan: rounds drift in max chunk seeds /
        # query count, and every drifted shape is a fresh executable
        # whose compile costs seconds.  The overlap command passes ONE dict
        # for the whole job; pinned dims only ever grow (monotone), so
        # after round 1 every later round reuses the same executables.
        self.shape_plan = shape_plan if shape_plan is not None else {}

    # -- query preparation ---------------------------------------------
    def _query_subsequences(self, seqs: Iterable[Sequence], query_type: int,
                            seed_limit: int, num_seeds: int,
                            kmer_values: np.ndarray) -> List[Sequence]:
        """Pass 1: pick subsequences and grow the seed set
        (ref: overlap/overlap.go:55-155)."""
        weight_sides = bool(query_type & WEIGHT_EDGES)

        def emit(sub, out):
            if weight_sides and len(sub) > 400:
                out.append(sub.subsequence(0, 200))
                out.append(sub.subsequence(len(sub) - 200, len(sub)))
            else:
                out.append(sub)

        cached: List[Sequence] = []
        for s in seqs:
            if self.index.num_seeds >= seed_limit:
                break
            subs: List[Sequence] = []
            if query_type & QUERY_EDGES:
                if len(s) < self.overlap * 2:
                    emit(s, subs)
                    cached.append(s)
                else:
                    s1 = s.subsequence(0, self.overlap)
                    s2 = s.subsequence(len(s) - self.overlap, len(s))
                    emit(s1, subs)
                    emit(s2, subs)
                    cached.append(s1)
                    cached.append(s2)
            elif query_type & QUERY_CENTRE:
                start = max(0, (len(s) - self.overlap) // 2)
                end = min(start + self.overlap, len(s) - 1)
                centre = s.subsequence(start, end)
                emit(centre, subs)
                cached.append(centre)
            else:  # QUERY_ALL
                if len(s) < self.overlap * 2:
                    emit(s, subs)
                    cached.append(s)
                else:
                    slices = len(s) // self.overlap
                    for i in range(slices):
                        start = (i * len(s)) // slices
                        end = ((i + 1) * len(s)) // slices
                        sub = s.subsequence(start, end)
                        emit(sub, subs)
                        cached.append(sub)
            ns = num_seeds // 2 if weight_sides else num_seeds
            for sub in subs:
                self.index.add_seeds(sub, ns, kmer_values)
        return cached

    def prepare_queries_pass1(self, num_seeds: int, seed_limit: int,
                              kmer_values: np.ndarray,
                              seqs: Iterable[Sequence],
                              query_type: int) -> List[Sequence]:
        """Pass 1 of query prep: pick query subsequences and grow the
        round's seed set until ``seed_limit``.  After this the seed
        table is frozen, so pass 2 (query re-extraction) and
        ``add_sequences`` (read chunk indexing) only READ it — drivers
        run those two concurrently (the native extraction releases the
        GIL; measured prep was the overlap round's critical path)."""
        return self._query_subsequences(seqs, query_type, seed_limit,
                                        num_seeds, kmer_values)

    def prepare_queries_pass2(self, cached: List[Sequence]
                              ) -> List[SeedQuery]:
        """Pass 2: re-extract every cached query subsequence with the
        full seed set, plus its RC twin (ref: overlap/overlap.go:182-213)."""
        queries: List[SeedQuery] = []
        k = self.index.k
        for qid, ss in enumerate(
                self.index.new_seed_sequences_batch(cached)):
            queries.append(SeedQuery(qid, ss.id, ss, True, False))
            queries.append(SeedQuery(qid, ss.id,
                                     ss.reverse_complement(k, self.index),
                                     True, True))
        return queries

    def prepare_queries(self, num_seeds: int, seed_limit: int,
                        kmer_values: np.ndarray,
                        seqs: Iterable[Sequence],
                        query_type: int) -> List[SeedQuery]:
        """Two-pass query prep: grow seeds, then re-extract every query
        with the full seed set plus its RC twin
        (ref: overlap/overlap.go:157-214)."""
        return self.prepare_queries_pass2(self.prepare_queries_pass1(
            seqs=seqs, query_type=query_type, seed_limit=seed_limit,
            num_seeds=num_seeds, kmer_values=kmer_values))

    def prepare_round(self, num_seeds: int, seed_limit: int,
                      kmer_values: np.ndarray, query_seqs,
                      query_type: int, all_seqs) -> List[SeedQuery]:
        """Full round prep with the query re-extraction and the read
        chunk indexing overlapped on a worker thread (both only read the
        pass-1-frozen seed table; the heavy extraction is native and
        GIL-releasing).  Equivalent to prepare_queries + add_sequences."""
        cached = self.prepare_queries_pass1(num_seeds, seed_limit,
                                            kmer_values, query_seqs,
                                            query_type)
        if not cached:
            return []
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as tp:
            fq = tp.submit(self.prepare_queries_pass2, cached)
            self.add_sequences(all_seqs)
            return fq.result()

    # -- indexing -------------------------------------------------------
    def add_sequences(self, seqs: Iterable[Sequence]):
        """Chop every read into ~chunk_size / 100-seed chunks with
        overlap/2 step-back and index them
        (ref: overlap/overlap.go:217-318)."""
        for ss in self.index.new_seed_sequences_batch(seqs):
            self._chunk_and_add(ss)
        self.index.index_sequences()

    def _chunk_and_add(self, s: SeedSequence):
        """Port of chunkWorker (ref: overlap/overlap.go:253-318)."""
        k = self.index.k
        num_chunks = s.length // self.chunk_size + 1
        n = s.num_seeds
        if num_chunks == 1 or n < self.min_seeds * 3:
            if n >= self.min_seeds:
                self.index.add_sequence(s)
            return
        pos = s.seed_positions(k)
        prev = 0                     # first seed of current chunk
        total_offset = int(pos[0])   # bases before seed `prev`
        while True:
            if prev >= n - 150:  # add right up to the end
                if prev == 0:
                    self.index.add_sequence(s)
                else:
                    new_first_gap = int(s.gaps[prev]) if prev > 0 else 0
                    length = int(pos[n - 1]) + k - int(pos[prev]) \
                        + int(s.gaps[-1]) + new_first_gap
                    self.index.add_sequence(s.sub_sequence(
                        prev, n - 1, length, total_offset - new_first_gap, 0))
                return
            # count seeds until chunk_size bases or 100 seeds
            count = 0
            length = 0
            while (length < self.chunk_size and count < 100
                   and prev + count < n):
                nxt = prev + count
                step = (int(pos[nxt + 1]) - int(pos[nxt])) if nxt + 1 < n \
                    else int(s.gaps[-1]) + k
                length += step
                count += 1
            if count >= self.min_seeds:
                new_first_gap = int(s.gaps[prev])
                length += new_first_gap
                self.index.add_sequence(s.sub_sequence(
                    prev, prev + count - 1, length,
                    total_offset - new_first_gap,
                    s.length - total_offset - length + new_first_gap))
                total_offset += length - new_first_gap
                prev += count
                if prev >= n:
                    return
                # step back 5 seeds or overlap/2
                stepped = 0
                back = 0
                while back < 5 and stepped < self.overlap // 2 and prev > 0:
                    prev -= 1
                    d = (int(pos[prev + 1]) - int(pos[prev])) if prev + 1 < n \
                        else int(s.gaps[-1]) + k
                    stepped += d
                    total_offset -= d
                    back += 1
            else:
                prev += count
                stepped = 0
                while stepped < self.overlap // 2 and prev > 0:
                    prev -= 1
                    d = (int(pos[prev + 1]) - int(pos[prev])) if prev + 1 < n \
                        else int(s.gaps[-1]) + k
                    stepped += d
                    total_offset -= d

    # -- overlap search -------------------------------------------------
    def find_overlaps(self, queries: List[SeedQuery]) -> List[SeedMatch]:
        """Batched matchWorker (ref: overlap/overlap.go:346-387): ONE
        fused dispatch per query batch — retrieval gathers over the
        resident membership matrix, the distinct-seed popcount gate, the
        seedAligner chain DP and the best-chain backpointer walk all run
        on device (``ops.map_engine._fused_overlap``); the host applies
        only the sequential adaptive min-match rule to the compact
        result rows."""
        futs = self.dispatch_find(queries)
        return self.collect_find(queries, futs)

    def dispatch_find(self, queries: List[SeedQuery]):
        """Async half of ``find_overlaps``: build the device engine and
        enqueue the fused dispatch; the caller may do host work (e.g. the
        next round's query prep) before ``collect_find``."""
        if not queries or self.index.num_sequences == 0:
            return None
        from ..ops.map_engine import MapEngine
        if self.index._seed_counts is None:
            self.index.index_sequences()
        # size the target-seed axis to the round's real chunks: reads
        # shorter than chunk_size index as ONE chunk carrying all their
        # seeds (ref chunkWorker, overlap/overlap.go:255-259), so a fixed
        # cap would silently drop tail anchors of mid-length reads.
        # Snapped to a LADDER {256, 512, 1024, 2048} and pinned monotone
        # in the job's shape plan: a 128 grid still drifted round-to-
        # round (512 -> 384 -> ...) and every drifted width was a fresh
        # multi-second (cold: multi-minute) executable compile.
        plan = self.shape_plan
        max_ts = max((s.num_seeds for s in self.index.sequences),
                     default=1)
        nt = 256
        while nt < max_ts and nt < 4096:
            nt *= 2
        nt = max(nt, plan.get("nt", 0))
        plan["nt"] = nt
        if max_ts > nt:
            import sys
            print(f"overlap: {max_ts}-seed chunks truncated to {nt} "
                  f"target seeds (chunk anchors past that are dropped; "
                  f"lower -chunk_size to avoid)", file=sys.stderr)
        eng = MapEngine(self.index, self.index.k, nq=128, nt=nt,
                        mesh=self.mesh, hit_fraction=self.hit_fraction,
                        h_min=plan.get("h", 0))
        plan["h"] = max(plan.get("h", 0), eng.H)
        base_min = np.array(
            [int(self.hit_fraction * q.query.num_seeds + 0.5)
             for q in queries], np.int32)
        # sub-batch the round's queries against the ONE resident engine:
        # every sub-dispatch enqueues immediately (device executions
        # serialize; fetches of batch i overlap batch i+1's
        # compute), each is a small fixed shape (MB = SUB) reusing one
        # executable, and the collector's host work overlaps in-flight
        # device work — a single whole-round dispatch serialized a
        # multi-second DP + fetch + host build with nothing to hide
        # under.
        SUB = 2048
        subs = []
        for lo in range(0, len(queries), SUB):
            sq = queries[lo : lo + SUB]
            subs.append((lo, eng.dispatch_chains(
                [q.query for q in sq], base_min[lo : lo + SUB],
                shape_plan=plan)))
            if lo == 0 and len(queries) > SUB \
                    and "budget_seen" not in plan:
                # round 0 only: peek the first sub-batch's real pair
                # count before dispatching the rest — the default
                # 16/query budget under-sizes high-coverage datasets
                # and every under-sized sub pays an escalation re-run
                import jax
                fut = subs[0][1][1]
                n = int(jax.device_get(fut[3]))
                if n > plan.get("budget", 0):
                    plan["budget"] = ((n + n // 8 + 4095) // 4096) * 4096
                plan["budget_seen"] = True
        return eng, subs

    def collect_find_arrays(self, queries: List[SeedQuery], futs):
        """Array-direct collect for the native final-check fast path:
        returns ``(qids, rcq, ia, ib, ma_flat, mb_flat, m_off)`` flat
        numpy arrays over the round's KEPT matches in query order — no
        SeedMatch objects, no per-row Python.  The
        adaptive min-match ratchet (ref matchWorker,
        overlap/overlap.go:346-387) vectorizes exactly: a dropped row
        never raises the threshold, so keep_i <=> blen_i >=
        max(1, m0_q, (2 * cummax_prev(blen))//3) per query row-run.

        ``ia`` indexes the query entries (= position in ``queries``);
        ``ib`` is the raw index-chunk id (callers building a combined
        sequence table offset it).  Returns None on the empty round.
        """
        if futs is None:
            return None
        eng, subs = futs
        heads, cqs, cts = [], [], []
        for lo, chain_futs in subs:
            M, head, cq, ct = eng.collect_chains_raw(chain_futs)
            live = (head[:, 0] >= 0) & (head[:, 0] < M) & (head[:, 2] > 0)
            head = head[live].astype(np.int64)
            head[:, 0] += lo                      # global query-entry row
            heads.append(head)
            cqs.append(cq[live])
            cts.append(ct[live])
        head = np.concatenate(heads) if heads else np.zeros((0, 4), np.int64)
        if head.shape[0] == 0:
            return None
        qe = head[:, 0]                           # query-entry index
        blen = head[:, 2]
        # per-entry adaptive ratchet, segment-cummax via the ascending-
        # offset trick (rows are query-major within and across subs)
        m0 = np.array([int(self.hit_fraction * q.query.num_seeds + 0.5)
                       for q in queries], np.int64)
        BIGB = 1 << 20
        lifted = blen + qe * BIGB
        prev = np.empty_like(lifted)
        prev[0] = -1
        np.maximum.accumulate(lifted[:-1], out=prev[1:])
        prev -= qe * BIGB                         # cummax of blen among
        boundary = np.empty(len(qe), bool)        # PRIOR same-entry rows
        boundary[0] = True
        np.not_equal(qe[1:], qe[:-1], out=boundary[1:])
        prev[boundary] = 0
        thresh = np.maximum(np.maximum(1, m0[qe]), (2 * prev) // 3)
        keep = blen >= thresh
        head = head[keep]
        if head.shape[0] == 0:
            return None
        # flatten reversed chains without per-row Python: row r
        # contributes cq[r, blen-1 .. 0]
        cq = np.concatenate(cqs)[keep]
        ct = np.concatenate(cts)[keep]
        bl = head[:, 2]
        m_off = np.zeros(len(bl) + 1, np.int64)
        np.cumsum(bl, out=m_off[1:])
        total = int(m_off[-1])
        rows = np.repeat(np.arange(len(bl)), bl)
        within = np.arange(total) - np.repeat(m_off[:-1], bl)
        pos = np.repeat(bl, bl) - 1 - within
        ma_flat = cq[rows, pos].astype(np.int32)
        mb_flat = ct[rows, pos].astype(np.int32)
        qe = head[:, 0]
        entry_qid = np.array([q.id for q in queries], np.int64)
        entry_rc = np.array([q.rc for q in queries], np.uint8)
        qids = entry_qid[qe]
        rcq = entry_rc[qe]
        ia = qe.astype(np.int32)                  # query-entry table slot
        ib = head[:, 1].astype(np.int32)          # raw chunk id
        return qids, rcq, ia, ib, ma_flat, mb_flat, m_off

    def seq_objects(self, queries: List[SeedQuery]):
        """Sequence table order matching collect_find_arrays' ia/ib:
        query entries first (ia = entry index), then index chunks
        (ib offset by len(queries))."""
        return [q.query for q in queries] + list(self.index.sequences)

    def collect_find(self, queries: List[SeedQuery],
                     futs) -> List[SeedMatch]:
        """Blocking half of ``find_overlaps`` (ref matchWorker collation,
        overlap/overlap.go:346-387).  Collects the round's sub-batches in
        order; the adaptive min-match rule is per query, so the split is
        invisible to results."""
        if futs is None:
            return []
        eng, subs = futs
        results: List[SeedMatch] = []
        for lo, chain_futs in subs:
            per_meta = eng.collect_chains(chain_futs)
            for qi, meta in enumerate(per_meta):
                q = queries[lo + qi]
                min_m = int(self.hit_fraction * q.query.num_seeds + 0.5)
                for ci, dcount, best_len, ma, mb in meta:
                    if best_len < max(1, min_m):
                        continue
                    m = SeedMatch(
                        ma if isinstance(ma, list) else ma.tolist(),
                        mb if isinstance(mb, list) else mb.tolist(),
                        q.query, self.index.sequences[ci],
                        query_id=q.id, rc_query=q.rc)
                    results.append(m)
                    if best_len * 2 > min_m * 3:
                        min_m = (best_len * 2) // 3
        return results
