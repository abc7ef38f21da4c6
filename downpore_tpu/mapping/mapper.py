"""Read-to-reference mapping: seed-chain alignment against an indexed
reference genome.

Mirrors the reference mapper (ref: mapping/mapping.go): the reference
genome gets one best-ranked seed per ``seed_rate`` bases, is chunked in 10
interleaved passes so neighbouring chunks overlap by ``edge_size``
(mapping.go:79-101, wrap chunk for circular genomes), and reads are mapped
by querying 1k-base windows — first both ends, pairing consistent hits
(``is_consistent`` distance-ratio rule, mapping.go:131-160), stepping
inward, and binary-searching for chimeric split points
(mapping.go:207-288).

Device mapping of the hot path: candidate retrieval + popcount gate are two
int8 matmuls over a (hashed) seed-bucket membership matrix; chaining is the
batched anchor DP.  Each driver stage batches the device work across every
active read, so host control flow never issues per-read device calls.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from ..core.sequence import Sequence
from ..seeds import SeedIndex, SeedSequence


class Mapping:
    """One mapped region (ref: mapping/mapping.go:11-20)."""
    __slots__ = ("query", "start", "end", "query_offset", "query_inset",
                 "rc", "ids")

    def __init__(self, query, start, end, query_offset, query_inset, rc, ids):
        self.query = query
        self.start = start
        self.end = end
        self.query_offset = query_offset
        self.query_inset = query_inset
        self.rc = rc
        self.ids = ids

    def __repr__(self):
        return (f"Mapping({self.start}-{self.end} q[{self.query_offset},"
                f"-{self.query_inset}] rc={self.rc} ids={self.ids})")


class Mapper:
    def __init__(self, reference: Sequence, circular: bool, k: int,
                 kmer_values: np.ndarray, seed_rate: int = 40,
                 edge_size: int = 1000, chunk_size: int = 10000,
                 mesh=None):
        self.reference = reference
        self.circular = circular
        self.k = k
        self.edge_size = edge_size
        self.mesh = mesh  # optional jax Mesh with a "data" axis: query
        # batches shard across it, the reference index replicates
        self.index = SeedIndex(k)
        self.index.add_single_seeds(reference, seed_rate, kmer_values)
        # 10 interleaved chunking passes (ref: mapping/mapping.go:79-101)
        n = len(reference)
        for j in range(10):
            step = chunk_size * 10 - edge_size
            i = j * chunk_size
            while i < n - chunk_size // 2:
                end = min(i + chunk_size, n)
                self.index.add_sequence(
                    self.index.new_seed_sequence(reference.subsequence(i, end)))
                i += step
        if circular:
            wrap = reference.subsequence(n - edge_size, n).append(
                reference.subsequence(0, edge_size))
            self.index.add_sequence(self.index.new_seed_sequence(wrap))
        self.index.index_sequences()
        self._build_device_index()

    def _build_device_index(self):
        """Resident fused engine: hashed membership + chunk seed tables
        live on device; each query batch is one dispatch
        (``ops.map_engine``)."""
        from ..ops.map_engine import MapEngine
        # nt sized to the real max chunk seed count (128 grid, floor 320
        # = the typical 10 kb/seed-rate-40 load): a fixed width silently
        # truncated dense chunks' tail anchors AND disqualified the
        # engine's derive/binned paths (which require complete chunk
        # tables) at genome scale.
        max_ts = max((s.num_seeds for s in self.index.sequences),
                     default=1)
        nt = min(2048, max(320, ((max_ts + 127) // 128) * 128))
        # nq scales with seed-table density: a 1 kb window's expected
        # table hits = window_kmers * distinct_seeds / 4^k (~11 for
        # E. coli at k=11, ~100+ for genome-scale references), and a
        # fixed width would truncate the window's tail seeds
        exp_hits = (self.edge_size - self.k + 1) \
            * self.index.num_seeds / (4 ** self.k)
        nq = int(min(192, max(64, -(-2 * exp_hits // 32) * 32)))
        # binned=True arms two-level genome-bin retrieval; the engine
        # engages it only once the chunk count makes the flat gather the
        # bottleneck (>=1024 chunks ~ a >=10 Mb reference)
        self.engine = MapEngine(self.index, self.k, nq=nq, nt=nt,
                                mesh=self.mesh, hit_fraction=0.25,
                                lean=True, binned=True)

    # ------------------------------------------------------------------
    def as_string(self, m: Mapping) -> str:
        """PAF line (ref: mapping/mapping.go:112-122)."""
        rc = "-" if m.rc else "+"
        mapped_len = m.end - m.start
        if self.circular and mapped_len < 0:
            mapped_len = len(self.reference) - m.start + m.end
        q = m.query
        return (f"{q.get_name()}\t{len(q)}\t{m.query_offset}\t"
                f"{len(q) - m.query_inset}\t{rc}\t"
                f"{self.reference.get_name()}\t{len(self.reference)}\t"
                f"{m.start}\t{m.end}\t{m.ids}\t{mapped_len}\t255")

    # -- batched performMapping ----------------------------------------
    def perform_mapping_batch(self, queries: List[Sequence]) -> List[List[Mapping]]:
        """The reference's performMapping (mapping.go:489-611) over a batch
        of query windows: retrieval matmul, popcount gate, chain DP,
        adaptive thresholds, duplicate removal.

        Feature extraction (seeds, run buckets) runs batch-vectorized in
        ``MapEngine.pack_query_windows`` — one numpy pass over all
        windows + RC twins instead of per-query ``new_seed_sequence``
        loops (which were the single largest map cost in round-1
        profiles)."""
        if not queries:
            return []
        # chunked dispatch-ahead pipeline: pack chunk i+1 on host while
        # the device crunches chunk i (pack and compute are each ~half
        # the stage, so the overlap nearly halves wall-clock)
        CHUNK = 4096
        inflight = []
        results: List[List[Mapping]] = [[] for _ in queries]
        for lo in range(0, len(queries), CHUNK):
            sub = queries[lo : lo + CHUNK]
            packed = self.engine.pack_query_windows(sub)
            num_seeds = packed[6]
            base_min = np.maximum(5, num_seeds // 5).astype(np.int32)
            futs = self.engine.dispatch_packed(packed, base_min)
            # fetches stay batched: one device_get per sub-batch train in
            # collect_arrays_many
            inflight.append((lo, sub, num_seeds, futs))
        colls = self.engine.collect_arrays_many([f for *_, f in inflight])
        for (lo, sub, num_seeds, _), coll in zip(inflight, colls):
            self._walk_candidates(sub, num_seeds, coll, results, lo)
        return results

    def _walk_candidates(self, queries, num_seeds, coll, results,
                         base: int):
        """Adaptive-threshold candidate walk for one packed chunk
        (ref: mapping.go:494-589).  ``results[base + qi]`` receives each
        query's mappings.

        All per-(pair, chain) geometry — reference start/end, query
        offset/inset, the 2/3-coverage rule — is precomputed with numpy
        over the whole fetched batch; the remaining Python loop only
        applies the *sequential* adaptive-threshold rules the reference
        defines over the candidate walk order (thresholds ratchet up as
        chains are accepted, affecting later candidates of the same
        query), reading precomputed lists."""
        if coll is None:
            return
        head, packed = coll
        N = head.shape[0]
        if N == 0:
            return
        k = self.k
        K = 4
        from ..ops.chain import unpack_summary
        s = unpack_summary(packed, K, lean=self.engine.lean)
        mi = head[:, 0]
        ci = head[:, 1]
        eng = self.engine
        ch_off = eng.chunk_off[ci]
        ch_inset = eng.chunk_inset[ci]
        ch_len = eng.chunk_len[ci]
        ref_len = len(self.reference)
        nq = len(queries)
        qi_row = mi >> 1
        is_rc = (mi & 1).astype(bool)
        qlen = np.fromiter((len(q) for q in queries), np.int64, nq)[qi_row]
        qoff = np.fromiter((q.offset for q in queries), np.int64, nq)[qi_row]
        qins = np.fromiter((q.inset for q in queries), np.int64, nq)[qi_row]
        # RC rows swap offset/inset (Sequence.reverse_complement semantics)
        moff = np.where(is_rc, qins, qoff)
        mins_ = np.where(is_rc, qoff, qins)
        sqp, stp = s["top_sqp"], s["top_stp"]
        eqp, etp = s["top_eqp"], s["top_etp"]
        start = ch_off[:, None] + stp
        end = ref_len - ch_inset[:, None] - (ch_len[:, None] - etp - k)
        if self.circular:
            start = np.where(start > ref_len, start - ref_len, start)
        qil = qlen[:, None] - eqp - k
        ok23 = (sqp + qil) <= (qlen[:, None] * 2) // 3
        q_offset = np.where(is_rc[:, None], qil + mins_[:, None],
                            sqp + moff[:, None])
        q_inset = np.where(is_rc[:, None], sqp + moff[:, None],
                           qil + mins_[:, None])
        # rows are sorted by mi (query-major compaction order)
        bounds = np.searchsorted(mi, np.arange(2 * nq + 1))

        from .. import native
        acc = native.walk_candidates(
            bounds, num_seeds, nq, np.ascontiguousarray(head[:, 2]),
            s["best"], s["top_valid"], s["top_len"], s["top_cov_t"],
            eqp, etp, sqp, stp, ok23, K)
        if acc is not None:
            self._emit_accepted(queries, acc, start, end, q_offset,
                                q_inset, s["top_cov_t"], results, base)
            return
        self._walk_candidates_py(queries, num_seeds, s, head, bounds,
                                 start, end, q_offset, q_inset, ok23,
                                 eqp, etp, sqp, stp, results, base, K)

    def _emit_accepted(self, queries, acc, start, end, q_offset, q_inset,
                       cov_t, results, base: int):
        """Build Mapping objects from the native walk's accepted
        ``(qi, b, j, rc)`` tuples (emitted in the reference walk order,
        query-major)."""
        acc_qi, acc_b, acc_j, acc_rc = acc
        n = acc_qi.shape[0]
        if n == 0:
            return
        starts = start[acc_b, acc_j].tolist()
        ends = end[acc_b, acc_j].tolist()
        qos = q_offset[acc_b, acc_j].tolist()
        qns = q_inset[acc_b, acc_j].tolist()
        ids = cov_t[acc_b, acc_j].tolist()
        rcs = acc_rc.tolist()
        qis = acc_qi.tolist()
        lo = 0
        while lo < n:
            hi = lo
            qi = qis[lo]
            while hi < n and qis[hi] == qi:
                hi += 1
            query = queries[qi]
            res = [Mapping(query, starts[i], ends[i], qos[i], qns[i],
                           rcs[i], ids[i]) for i in range(lo, hi)]
            results[base + qi] = _dedup_by_position(res)
            lo = hi

    def _walk_candidates_py(self, queries, num_seeds, s, head, bounds,
                            start, end, q_offset, q_inset, ok23,
                            eqp, etp, sqp, stp, results, base: int,
                            K: int):
        """Pure-Python twin of the native walk (fallback + parity
        oracle)."""
        nq = len(queries)
        dc_l = head[:, 2].tolist()
        best_l = s["best"].tolist()
        tv_l = s["top_valid"].tolist()
        tl_l = s["top_len"].tolist()
        ct_l = s["top_cov_t"].tolist()
        eq_l = eqp.tolist()
        et_l = etp.tolist()
        sq_l = sqp.tolist()
        st_l = stp.tolist()
        start_l = start.tolist()
        end_l = end.tolist()
        qo_l = q_offset.tolist()
        qn_l = q_inset.tolist()
        ok_l = ok23.tolist()
        for qi in range(nq):
            lo_f, hi_f = bounds[2 * qi], bounds[2 * qi + 1]
            lo_r, hi_r = bounds[2 * qi + 1], bounds[2 * qi + 2]
            if lo_f == hi_f and lo_r == hi_r:
                continue
            min_matches = max(5, int(num_seeds[2 * qi]) // 5)
            min_rc = max(5, int(num_seeds[2 * qi + 1]) // 5)
            res: List[Mapping] = []
            query = queries[qi]
            for lo, hi, rc in ((lo_f, hi_f, False), (lo_r, hi_r, True)):
                for b in range(lo, hi):
                    cur_min = min_rc if rc else min_matches
                    # popcount gate on distinct shared seeds
                    if dc_l[b] < cur_min or best_l[b] < cur_min:
                        continue
                    # one chain per distinct start, best stat wins
                    # (ref: mapping.go:528-551)
                    tvb, tlb = tv_l[b], tl_l[b]
                    ctb, eqb, etb = ct_l[b], eq_l[b], et_l[b]
                    sqb, stb = sq_l[b], st_l[b]
                    starts = {}
                    for j in range(K):
                        if not tvb[j] or tlb[j] < cur_min:
                            continue
                        key = (sqb[j], stb[j])
                        stat = (tlb[j], ctb[j], eqb[j], etb[j])
                        prev = starts.get(key)
                        if prev is None or stat > prev[0]:
                            starts[key] = (stat, j)
                    okb = ok_l[b]
                    for stat, j in starts.values():
                        if not okb[j]:
                            continue
                        res.append(Mapping(query, start_l[b][j],
                                           end_l[b][j], qo_l[b][j],
                                           qn_l[b][j], rc, ctb[j]))
                        limit = (stat[0] * 4) // 5
                        if not rc and limit > min_matches:
                            min_matches = limit
                        if limit > min_rc:
                            min_rc = limit
            results[base + qi] = _dedup_by_position(res)

    # -- pairing / consistency ------------------------------------------
    def is_consistent(self, left: Mapping, right: Mapping) -> bool:
        """Distance-ratio rule (ref: mapping/mapping.go:131-160)."""
        if left.rc != right.rc:
            return False
        expected = right.query_offset - len(left.query) + left.query_inset
        if not left.rc:
            distance = right.start - left.end
        else:
            distance = left.start - right.end
        if self.circular and distance < -50:
            distance += len(self.reference)
        if distance < 50 and expected < 50 and distance > -50:
            return True
        if distance < 500:
            return expected < (distance * 3) // 2 and expected > (distance * 2) // 3
        if distance > 5000:
            return expected < (distance * 10) // 9 and expected > (distance * 9) // 10
        ratio = (distance - 500) / 4500.0
        ratio = 3.0 / 2.0 + ratio * (10.0 / 9.0 - 3.0 / 2.0)
        return (distance < int(expected * ratio)
                and distance > int(expected / ratio))

    def match_pairs(self, open_a: List[Mapping], open_b: List[Mapping]):
        """Merge consistent end pairs (ref: mapping/mapping.go:174-203)."""
        matched: List[Mapping] = []
        open_a = list(open_a)
        open_b = list(open_b)
        i = len(open_a) - 1
        while i >= 0:
            ra = open_a[i]
            for j in range(len(open_b) - 1, -1, -1):
                rb = open_b[j]
                if self.is_consistent(ra, rb):
                    q_offset = ra.query_offset
                    q_inset = rb.query_inset
                    first, second = (rb, ra) if ra.rc else (ra, rb)
                    matched.append(Mapping(
                        ra.query, first.start, second.end, q_offset,
                        q_inset, ra.rc, ra.ids + rb.ids))
                    open_a[i] = open_a[-1]
                    open_a.pop()
                    open_b[j] = open_b[-1]
                    open_b.pop()
                    break
            i -= 1
        return open_a, open_b, matched

    # -- top-level per-read mapping -------------------------------------
    _SHARD_MIN = 2048   # shard-threading threshold (module-testable)

    def map_batch(self, reads: List[Sequence]) -> List[List[Mapping]]:
        """Map a batch of reads.  Large batches split into two shards
        mapped on concurrent threads: the per-read stage chain
        (ends -> mapNext -> split) is sequential with a device fetch
        per stage, so one shard's host/fetch work hides under the other
        shard's device compute.  Reads are independent, so results are
        identical to the unsharded run."""
        if len(reads) >= self._SHARD_MIN and self.mesh is None:
            from concurrent.futures import ThreadPoolExecutor
            mid = (len(reads) + 1) // 2
            with ThreadPoolExecutor(max_workers=1) as tp:
                fut = tp.submit(self._map_batch_one, reads[mid:])
                out_a = self._map_batch_one(reads[:mid])
                return out_a + fut.result()
        return self._map_batch_one(reads)

    def _map_batch_one(self, reads: List[Sequence]) -> List[List[Mapping]]:
        """Map a batch of reads, batching every device stage across reads
        (ref flow: mapping/mapping.go:430-487)."""
        results: List[Optional[List[Mapping]]] = [None] * len(reads)
        es = self.edge_size

        short_idx = [i for i, r in enumerate(reads) if len(r) <= 2 * es]
        long_idx = [i for i, r in enumerate(reads) if len(r) > 2 * es]
        # short reads: one query each
        short_maps = self.perform_mapping_batch([reads[i] for i in short_idx])
        for i, ms in zip(short_idx, short_maps):
            ms = _remove_dominated(ms, ms, len(reads[i]))
            for m in ms:
                m.query = reads[i]
            results[i] = ms

        # long reads stage 1: both ends
        subqs = []
        for i in long_idx:
            r = reads[i]
            subqs.append(r.subsequence(0, es))
            subqs.append(r.subsequence(len(r) - es, len(r)))
        end_maps = self.perform_mapping_batch(subqs)
        states = {}
        for idx, i in enumerate(long_idx):
            r = reads[i]
            open_a = _remove_dominated(end_maps[2 * idx], end_maps[2 * idx],
                                       len(r))
            open_b = _remove_dominated(end_maps[2 * idx + 1],
                                       end_maps[2 * idx + 1], len(r))
            for m in open_a + open_b:
                m.query = r
            open_a, open_b, matched = self.match_pairs(open_a, open_b)
            if matched:
                results[i] = matched
            elif len(r) < 3 * es:
                results[i] = open_a + open_b
            else:
                states[i] = (open_a, open_b)

        # stage 2: mapNext (two rounds of stepping inward), batched
        self._map_next_stage(reads, states, results)

        # stage 3: chimera split search for remaining reads
        self._split_stage(reads, states, results)
        return [r if r is not None else [] for r in results]

    def _map_next_stage(self, reads, states, results):
        """Batched mapNext (ref: mapping/mapping.go:305-383)."""
        es = self.edge_size
        if not states:
            return
        # round 1 queries
        subqs = []
        metas = []
        for i in list(states.keys()):
            r = reads[i]
            if len(r) < es * 4:
                subqs.append(r.subsequence(es, len(r) - es))
                metas.append((i, "mid"))
            else:
                subqs.append(r.subsequence(es, es * 2))
                metas.append((i, "a1"))
                subqs.append(r.subsequence(len(r) - es * 2, len(r) - es))
                metas.append((i, "b1"))
        maps = self.perform_mapping_batch(subqs)
        new_by_read = {}
        for (i, tag), ms in zip(metas, maps):
            r = reads[i]
            ms = _remove_dominated(ms, ms, len(r))
            for m in ms:
                m.query = r
            new_by_read.setdefault(i, {})[tag] = ms
        need_round2 = []
        for i, tags in new_by_read.items():
            open_a, open_b = states[i]
            r = reads[i]
            if "mid" in tags:
                new_a = tags["mid"]
                open_a2, new_a, extended = self.match_pairs(open_a, new_a)
                if extended:
                    open_a = new_a + extended
                else:
                    open_a = open_a2 + new_a
                new_a, new_b, matched = self.match_pairs(open_a, open_b)
                if matched:
                    results[i] = matched
                    del states[i]
                else:
                    # unmatched leftovers go on to the split stage
                    # (ref: mapping/mapping.go:322-326, 448-467)
                    states[i] = (new_a, new_b)
                continue
            new_a = tags.get("a1", [])
            new_b = tags.get("b1", [])
            open_a, new_a2, extended = self.match_pairs(open_a, new_a)
            open_a = open_a + new_a2
            if extended:
                open_a = open_a + extended
            open_b, new_b2, extended = self.match_pairs(new_b, open_b)
            open_b = open_b + new_b2
            if extended:
                open_b = open_b + extended
            new_a, new_b, matched = self.match_pairs(open_a, open_b)
            if matched:
                results[i] = matched
                del states[i]
            else:
                states[i] = (new_a, new_b)
                need_round2.append(i)
        # round 2: one more step inward
        if not need_round2:
            return
        subqs, metas = [], []
        for i in need_round2:
            r = reads[i]
            if len(r) > es * 5:
                subqs.append(r.subsequence(es * 2, es * 3))
                metas.append((i, "a2"))
            if len(r) > es * 6:
                subqs.append(r.subsequence(len(r) - es * 3, len(r) - es * 2))
                metas.append((i, "b2"))
        maps = self.perform_mapping_batch(subqs)
        new_by_read = {}
        for (i, tag), ms in zip(metas, maps):
            r = reads[i]
            ms = _remove_dominated(ms, ms, len(r))
            for m in ms:
                m.query = r
            new_by_read.setdefault(i, {})[tag] = ms
        for i in need_round2:
            open_a, open_b = states[i]
            r = reads[i]
            tags = new_by_read.get(i, {})
            if len(r) > es * 5:
                next_a = tags.get("a2", [])
                next_a, open_a2, extended = self.match_pairs(open_a, next_a)
                open_a = next_a
                if extended:
                    open_a = open_a + extended
                open_a = open_a + open_a2
            if len(r) > es * 6:
                next_b = tags.get("b2", [])
                next_b, open_b2, extended = self.match_pairs(next_b, open_b)
                open_b = next_b
                if extended:
                    open_b = open_b + extended
                open_b = open_b + open_b2
            if len(r) > es * 5:
                open_a, open_b, matched = self.match_pairs(open_a, open_b)
                if matched:
                    results[i] = matched
                    del states[i]
                    continue
            states[i] = (open_a, open_b)

    def _split_stage(self, reads, states, results):
        """Batched chimeric split-point binary search
        (ref: mapping/mapping.go:207-288, 452-483)."""
        es = self.edge_size
        # per read: stack of (open_a, open_b, left, right) searches
        searches = {}
        for i, (open_a, open_b) in states.items():
            r = reads[i]
            left = es * 2
            right = len(r) - es * 2
            for a in open_a:
                if a.query_inset > left:
                    left = a.query_inset
            left = len(r) - right
            for b in open_b:
                if b.query_offset < right:
                    right = b.query_offset
            searches[i] = [(open_a, open_b, left, right)]
        while True:
            batch = []
            metas = []
            for i, stack in searches.items():
                if not stack:
                    continue
                open_a, open_b, left, right = stack[-1]
                if right - left < es:
                    stack.pop()
                    continue
                start = (right + left - es) // 2
                batch.append(reads[i].subsequence(start, start + es))
                metas.append((i, start))
            if not batch:
                active = any(s for s in searches.values())
                if not active:
                    break
                continue
            maps = self.perform_mapping_batch(batch)
            for (i, start), mid in zip(metas, maps):
                stack = searches[i]
                open_a, open_b, left, right = stack.pop()
                r = reads[i]
                for m in mid:
                    m.query = r
                new_left, new_right = left, right
                after_a = after_b = 0
                for mm in mid:
                    for ma in open_a:
                        if self.is_consistent(ma, mm):
                            ma.query_inset = mm.query_inset
                            ma.ids += mm.ids
                            if ma.rc:
                                ma.start = mm.start
                            else:
                                ma.end = mm.end
                            mid_matched = len(r) - mm.query_inset - mm.query_offset
                            after_a = max(after_a, mid_matched)
                            new_left = max(new_left, len(r) - mm.query_inset)
                            break
                    if after_a < (es * 2) // 3:
                        for mb in open_b:
                            if self.is_consistent(mm, mb):
                                mb.query_offset = mm.query_offset
                                mb.ids += mm.ids
                                if mb.rc:
                                    mb.end = mm.end
                                else:
                                    mb.start = mm.start
                                mid_matched = len(r) - mm.query_inset - mm.query_offset
                                after_b = max(after_b, mid_matched)
                                new_right = min(new_right, mm.query_offset)
                                break
                if after_a > 0 and after_b > 0:
                    if new_left - left > es * 2:
                        stack.append((open_a, [], new_left - es * 2,
                                      new_left - es))
                    if right - new_right > es * 2:
                        stack.append(([], open_b, new_right + es,
                                      new_right + es * 2))
                elif after_a == 0 and after_b == 0:
                    end = start + es
                    if open_a:
                        stack.append((open_a, [], left, start))
                    if open_b:
                        stack.append(([], open_b, end, right))
                else:
                    stack.append((open_a, open_b, new_left, new_right))
        # finalize: drop unpaired ends that reach the far edge
        for i, (open_a, open_b) in states.items():
            r = reads[i]
            size = len(r) - es
            open_a = [a for a in open_a if a.query_inset < size]
            open_b = [b for b in open_b if b.query_offset < size]
            results[i] = open_a + open_b

    def map(self, read: Sequence) -> List[Mapping]:
        return self.map_batch([read])[0]


def _dedup_by_position(results: List[Mapping]) -> List[Mapping]:
    """Sort by start, drop same-strand overlaps keeping the longer
    (ref: mapping/mapping.go:590-608)."""
    if len(results) <= 1:
        return results
    results = sorted(results, key=lambda m: m.start)
    out = []
    for m in results:
        if out and out[-1].rc == m.rc and m.start < out[-1].end:
            if (out[-1].end - out[-1].start) < (m.end - m.start):
                out[-1] = m
        else:
            out.append(m)
    return out


def _remove_dominated(open_list: List[Mapping], extended: List[Mapping],
                      query_len: int) -> List[Mapping]:
    """Drop mappings 90%-contained in a 25%-better mapping
    (ref: mapping/mapping.go:387-428)."""
    if not open_list or not extended:
        return open_list
    open_list = sorted(open_list, key=lambda m: m.query_offset)
    ext = sorted(extended, key=lambda m: m.query_offset)
    keep = []
    j = 0
    for nxt in open_list:
        while j < len(ext) and query_len - ext[j].query_inset < nxt.query_offset:
            j += 1
        if j == len(ext):
            keep.append(nxt)
            continue
        dominated = False
        kk = j
        while (not dominated and kk < len(ext)
               and ext[kk].query_offset < query_len - nxt.query_inset):
            e = ext[kk]
            if e is not nxt and e.ids * 4 > nxt.ids * 5:
                start = max(nxt.query_offset, e.query_offset)
                end = query_len - max(nxt.query_inset, e.query_inset)
                dominated = ((end - start) * 10 >
                             (query_len - nxt.query_offset - nxt.query_inset) * 9)
            kk += 1
        if not dominated:
            keep.append(nxt)
    return keep
