"""The overlap command: batched all-vs-all rounds with PAF output
(ref: commands/overlap.go:22-233)."""
from __future__ import annotations

import sys
import time

from .framework import Command, parse_bool, parse_float, parse_int


class OverlapCommand(Command):
    name = "overlap"

    def __init__(self):
        super().__init__(
            ["overlap_size", "k", "num_seeds", "seed_batch_size",
             "chunk_size", "query_batch_size", "min_hits", "num_workers",
             "input", "seed_values", "himem", "data_parallel",
             "checkpoint", "seed_shards"],
            ["1000", "10", "15", "100000", "10000", "20000", "0.25", "4",
             "", "", "true", "false", "", "1"],
            ["Size of overlap to search for in bases",
             "Number of bases in each seed",
             "Minimum number of seeds to generate for each overlap query",
             "Maximum total unique seeds to use in each query batch "
             "(the reference defaults to 10000 to bound host RAM; the "
             "default here is 100000 — fewer, bigger rounds mean fewer "
             "whole-file re-index passes)",
             "Size to chop long reads into for querying against, in bases",
             "Maximum number of queries per batch (if max seeds not reached)",
             "Minimum proportion of seeds that must match each query",
             "Number of worker threads to spawn",
             "Fasta/fastq input file",
             "File containing values to use during seed selection.",
             "Whether to cache all reads in memory",
             "Shard query batches across all attached devices "
             "(jax.sharding data mesh; the chunk index replicates)",
             "Snapshot file for checkpoint/resume at round boundaries",
             "Shard the chunk seed index over this many devices (with "
             "-data_parallel: a data x seed mesh; retrieval counts merge "
             "with a psum over the seed axis)"])

    def run(self, args):
        from ..io import SequenceSet
        from ..seeds import SeedIndex
        from ..overlap import Overlapper, QUERY_EDGES, build_consensus
        from ..utils import kmer_occurrences
        from ..utils.kmers import score_seed_values

        overlap_size = parse_int(args["overlap_size"])
        num_seeds = parse_int(args["num_seeds"])
        seed_batch_size = parse_int(args["seed_batch_size"])
        query_batch_size = parse_int(args["query_batch_size"])
        chunk_size = parse_int(args["chunk_size"])
        k = parse_int(args["k"])
        hit_fraction = parse_float(args["min_hits"])

        seq_set = SequenceSet(args["input"], min_length=overlap_size,
                              cache=parse_bool(args["himem"]))
        mesh = None
        n_seed = parse_int(args["seed_shards"])
        if parse_bool(args["data_parallel"]) or n_seed > 1:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(n_seed=n_seed)
        print(f"Counting all {k}-mers in the input...", file=sys.stderr)
        # multi-device meshes count on device (sharded bincount + psum,
        # parallel.sharded_kmer_histogram)
        counts = kmer_occurrences(seq_set.get_sequences(), k, mesh=mesh)
        values = score_seed_values(counts, k, args.get("seed_values", ""))
        print("Counting complete. Starting indexing and querying...",
              file=sys.stderr)
        first_sequence = 0
        round_no = 0
        ckpt = args.get("checkpoint") or None
        if ckpt:
            import os
            if os.path.exists(ckpt):
                progress = seq_set.load_state(ckpt)
                first_sequence = int(progress.get("first_sequence", 0))
                round_no = int(progress.get("round", 0))
                print(f"Resuming from round {round_no} "
                      f"(sequence {first_sequence}).", file=sys.stderr)
        shape_plan = {}  # ONE compiled-shape plan for the whole job
        # (nt/nq/mb/budget pinned monotone across rounds) — round-to-
        # round shape drift otherwise recompiles the fused kernel

        def prep_round(first):
            """Host half of a round: fresh index, query prep, chunk
            indexing.  Independent of any earlier round's results, so it
            runs while the previous round's find is in flight."""
            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size,
                                    num_seeds, hit_fraction, mesh=mesh,
                                    shape_plan=shape_plan)
            seqs = seq_set.get_n_sequences_from(first, query_batch_size)
            # query re-extraction and read chunk indexing overlap on a
            # worker thread after pass 1 freezes the seed set (prep is
            # the pipelined round's critical path)
            queries = overlapper.prepare_round(
                num_seeds, seed_batch_size, values, seqs, QUERY_EDGES,
                seq_set.get_sequences())
            if not queries:
                return None
            nxt = max(q.sequence_id for q in queries) + 1
            return index, overlapper, queries, nxt

        prepped = prep_round(first_sequence)
        futs = prepped[1].dispatch_find(prepped[2]) if prepped else None
        # SPECULATIVELY prep the next round on a WORKER THREAD while this
        # round's find is in flight (the native seed walks release the
        # GIL).  The prep depends on the read set's ignore flags, which
        # a round's final check changes (full-coverage ignores, ref
        # commands/overlap.go:205,221-223) — the flag count is
        # snapshotted at submit time and the prep redone sequentially if
        # it moved, so output stays identical to the unpipelined driver
        # (ignores only ever flip to True, so an unchanged count means
        # the speculative prep saw clean state).  The next round's
        # DISPATCH happens only after this round's final checks settle
        # the flags: dispatching speculatively meant the near-certain
        # invalidation re-dispatched every round — the device ran every
        # find TWICE (measured ~2x round wall at GB scale).
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=1)

        def submit_prep(first):
            return (sum(seq_set.ignore), first,
                    ex.submit(prep_round, first))

        next_sub = submit_prep(prepped[3]) if prepped else None
        while prepped is not None:
            index, overlapper, queries, next_first = prepped
            num_query_seqs = max(q.id for q in queries) + 1
            print(f"Using query set with {num_query_seqs} sequences "
                  f"starting from {next_first} against "
                  f"{seq_set.size} sequences.", file=sys.stderr)
            # final checks: the whole round runs in ONE native C++ call
            # when the toolchain is available (seqscan.cpp
            # final_check_round — bit-identical to the Python
            # build_consensus path by parity test; ~6 ms/check of
            # Python was the GB-scale CLI's dominant host cost).  The
            # fast path feeds it straight from the fetched ARRAYS (no
            # SeedMatch objects); Python fallback otherwise (thread
            # pools measured 1.6x SLOWER on this GIL-bound work).
            done = self._final_checks_arrays(overlapper, queries, futs,
                                             index, seq_set,
                                             overlap_size)
            if not done:
                matches = overlapper.collect_find(queries, futs)
                query_results = [[] for _ in range(num_query_seqs)]
                hits = 0
                for m in matches:
                    query_results[m.query_id].append(m)
                    hits += 1
                q_hits = sum(1 for r in query_results if len(r) > 1)
                print(f"Total {hits} hits across {q_hits} overlaps.",
                      file=sys.stderr)
                work = [r for r in query_results if len(r) > 1]
                if not self._final_checks_native(work, index, seq_set,
                                                 overlap_size):
                    for results in work:
                        self._final_check(results, index, seq_set,
                                          overlap_size)
            first_sequence = next_first
            round_no += 1
            if ckpt:
                seq_set.save_state(ckpt,
                                   {"first_sequence": first_sequence,
                                    "round": round_no})
            # resolve the next round's prep, validating against the NOW
            # settled ignore flags, then dispatch it exactly once
            if next_sub is not None:
                snap, sub_first, prep_fut = next_sub
                prepped_next = prep_fut.result()
                if (prepped_next is not None
                        and sum(seq_set.ignore) != snap):
                    # the speculative prep saw stale flags — redo it on
                    # the settled state (output stays identical to the
                    # unpipelined driver)
                    prepped_next = prep_round(sub_first)
            else:
                prepped_next = None
            futs_next = (prepped_next[1].dispatch_find(prepped_next[2])
                         if prepped_next else None)
            next_sub = (submit_prep(prepped_next[3])
                        if prepped_next else None)
            prepped, futs = prepped_next, futs_next
        ex.shutdown(wait=False)

    def _rc_lut(self, index):
        """seed -> RC-seed table, or None if any twin is missing."""
        import numpy as np
        from ..core.sequence import kmer_reverse_complement_vec
        km = index.seed_kmers_of(np.arange(index.num_seeds))
        rc_lut = index.kmer_map[
            kmer_reverse_complement_vec(km, index.k)].astype(np.int32)
        if rc_lut.size and rc_lut.min() < 0:
            return None
        return rc_lut

    def _emit_records(self, recs, seq_set, overlap_size):
        """Apply native final-check records: ignores + PAF lines."""
        for rows in recs:
            if len(rows) <= 1:
                continue
            id0, rc0, off0, len0, seqlen0, _ = rows[0]
            if seqlen0 <= overlap_size * 2:
                seq_set.set_ignore(id0, True)
            for pid in range(1, len(rows)):
                pi, rci, start, length, seq_len, ident = rows[pid]
                rc = "-" if rci != rc0 else "+"
                end = start + length
                covered = max(overlap_size, end - start)
                if seq_len * 9 <= covered * 10:
                    seq_set.set_ignore(pi, True)
                print(f"{seq_set.get_name(id0)}\t{seqlen0}\t{off0}\t"
                      f"{off0 + len0}\t{rc}\t{seq_set.get_name(pi)}\t"
                      f"{seq_len}\t{start}\t{end}\t{ident}\t0\t255")

    def _final_checks_arrays(self, overlapper, queries, futs, index,
                             seq_set, overlap_size):
        """Fetch-to-check fast path: the round's matches go from the
        device fetch straight into the native final check as flat
        arrays — no SeedMatch objects (they were rebuilt into arrays by
        the native marshaling anyway).  Returns False to fall back."""
        import os
        if futs is None or os.environ.get("DOWNPORE_TPU_PY_FINAL") == "1":
            return False
        from .. import native
        if native.load() is None:
            return False
        import numpy as np
        rc_lut = self._rc_lut(index)
        if rc_lut is None:
            return False
        arrs = overlapper.collect_find_arrays(queries, futs)
        if arrs is None:
            print("Total 0 hits across 0 overlaps.", file=sys.stderr)
            return True
        qids, rcq, ia, ib, ma_flat, mb_flat, m_off = arrs
        hits = len(qids)
        # contiguous qid runs (entries of one qid are adjacent)
        starts = np.flatnonzero(
            np.concatenate([[True], qids[1:] != qids[:-1]]))
        run_len = np.diff(np.concatenate([starts, [hits]]))
        q_hits = int((run_len > 1).sum())
        print(f"Total {hits} hits across {q_hits} overlaps.",
              file=sys.stderr)
        keep_run = run_len > 1
        if not keep_run.any():
            return True
        rowmask = np.repeat(keep_run, run_len)
        bl = np.diff(m_off)
        pairmask = np.repeat(rowmask, bl)
        bl2 = bl[rowmask]
        m_off2 = np.zeros(len(bl2) + 1, np.int64)
        np.cumsum(bl2, out=m_off2[1:])
        kept_len = run_len[keep_run]
        chk_off = np.zeros(len(kept_len) + 1, np.int64)
        np.cumsum(kept_len, out=chk_off[1:])
        table, _ = native.marshal_seq_table(
            overlapper.seq_objects(queries))
        recs = native.final_check_round_arrays(
            table, chk_off, ia[rowmask],
            ib[rowmask] + np.int32(len(queries)), rcq[rowmask],
            ma_flat[pairmask], mb_flat[pairmask], m_off2, rc_lut,
            index.k)
        if recs is None:
            return False
        self._emit_records(recs, seq_set, overlap_size)
        return True

    def _final_checks_native(self, work, index, seq_set, overlap_size):
        """Run a round's final checks through the native
        ``final_check_round``; returns False (caller falls back to the
        Python path) when the toolchain or a complete RC seed mapping is
        unavailable."""
        import os
        if not work or os.environ.get("DOWNPORE_TPU_PY_FINAL") == "1":
            return False
        from .. import native
        if native.load() is None:
            return False
        k = index.k
        rc_lut = self._rc_lut(index)
        if rc_lut is None:
            return False          # partial RC twin set: python path
        uniq = []
        seen = set()
        for ms in work:
            for m in ms:
                for s in (m.seq_a, m.seq_b):
                    if id(s) not in seen:
                        seen.add(id(s))
                        uniq.append(s)
        table, ids = native.marshal_seq_table(uniq)
        recs = native.final_check_round(work, table, ids, rc_lut, k)
        if recs is None:
            return False
        self._emit_records(recs, seq_set, overlap_size)
        return True

    def _final_check(self, results, index, seq_set, overlap_size):
        """PAF emission + full-coverage ignore
        (ref: commands/overlap.go:197-233)."""
        lines, ignores = self._final_check_compute(results, index,
                                                   seq_set, overlap_size)
        for sid in ignores:
            seq_set.set_ignore(sid, True)
        for ln in lines:
            print(ln)

    def _final_check_compute(self, results, index, seq_set, overlap_size):
        """Side-effect-free final check: returns (PAF lines, read ids to
        ignore) so a worker pool can run checks concurrently."""
        from ..overlap import build_consensus
        k = index.k
        lines = []
        ignores = []
        contig = build_consensus(index, results)
        if contig is None or len(contig.parts) <= 1:
            return lines, ignores
        if contig.seq_lengths[0] <= overlap_size * 2:
            ignores.append(contig.parts[0])
        query_start = contig.offsets[0]
        query_end = query_start + contig.lengths[0]
        for i, part in enumerate(contig.parts[1:]):
            pid = i + 1
            rc = "+"
            start = contig.offsets[pid]
            end = start + contig.lengths[pid]
            if contig.reverse_complement[0] != contig.reverse_complement[pid]:
                rc = "-"
            covered = max(overlap_size, end - start)
            if contig.seq_lengths[pid] * 9 <= covered * 10:
                ignores.append(part)
            ident, _ = contig.matches[i].bases_covered(k)
            lines.append(
                f"{seq_set.get_name(contig.parts[0])}\t"
                f"{contig.seq_lengths[0]}\t{query_start}\t{query_end}\t"
                f"{rc}\t{seq_set.get_name(part)}\t"
                f"{contig.seq_lengths[pid]}\t{start}\t{end}\t{ident}\t"
                f"0\t255")
        return lines, ignores
