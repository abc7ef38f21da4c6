"""The correct command: two-round overlap + consensus read correction
(ref: commands/correct.go).

The reference pipeline is partially WIP — it runs one outer round then
breaks, and steps 5-7 (pileup consensus output) are unimplemented
(commands/correct.go:202-226).  This port follows the same flow and
additionally emits the base-space consensus sequences of the final round
as fasta on stdout, which is what step 7 was meant to produce.
"""
from __future__ import annotations

import sys

from .framework import Command, parse_bool, parse_float, parse_int


def _remove_duplicates(hits):
    """(ref: commands/correct.go:341-365)"""
    hits.sort(key=lambda m: (m.seq_b.id, m.seq_b.offset))
    i = len(hits) - 2
    while i >= 0:
        m = hits[i]
        prev = hits[i + 1]
        if m.seq_b.id == prev.seq_b.id:
            c1 = (m.seq_b.offset + m.seq_b.length) // 2
            c2 = (prev.seq_b.offset + prev.seq_b.length) // 2
            if ((c1 > prev.seq_b.offset
                 and c1 - prev.seq_b.offset < prev.seq_b.length)
                    or (c2 > m.seq_b.offset
                        and c2 - m.seq_b.offset < m.seq_b.length)):
                del hits[i + 1]
        i -= 1


def _seed_space_consensus(rs, index, seq_ids):
    """(ref: commands/correct.go:234-268)"""
    from ..overlap import build_consensus
    out = []
    for hits in rs:
        contig = None
        if len(hits) >= 3:
            contig = build_consensus(index, hits)
            if contig is not None and len(contig.parts) >= 3:
                for part in contig.parts:
                    seq_ids.add(part)
                original_id = hits[0].seq_a.id
                contig.combined.id = original_id
                original = -1
                for kk, part in enumerate(contig.parts):
                    if part == original_id:
                        original = kk
                        break
                if original == -1:
                    contig.combined.offset = hits[0].seq_a.offset
                    contig.combined.inset = hits[0].seq_a.inset
                else:
                    contig.combined.offset = hits[0].seq_a.offset + \
                        contig.offsets[original]
                    contig.combined.inset = hits[0].seq_a.inset
            else:
                contig = None
        out.append(contig)
    return out


def _perform_queries(queries, overlapper, overlap_size, seq_set,
                     query_sequences):
    """Collate matches as [query sequence][overlap chunk][hits]
    (ref: commands/correct.go:272-311)."""
    overlapper.add_sequences(seq_set.get_sequences())
    query_results = [[] for _ in query_sequences]
    query_indices = {}
    index = 0
    prev_seq = -1
    for q in queries:
        if q.sequence_id != prev_seq:
            prev_seq = q.sequence_id
            index = 0
        query_indices[q.id] = index // 2
        index += 1
    matches = overlapper.find_overlaps(queries)
    for m in matches:
        seq_id = m.seq_a.id
        try:
            seq_index = query_sequences.index(seq_id)
        except ValueError:
            seq_index = 0
        idx = query_indices.get(m.query_id, 0)
        while len(query_results[seq_index]) <= idx:
            query_results[seq_index].append([])
        query_results[seq_index][idx].append(m)
    return query_results


class CorrectCommand(Command):
    name = "correct"

    def __init__(self):
        super().__init__(
            ["overlap_size", "num_seeds", "seed_batch_size", "chunk_size",
             "k", "min_hits", "num_workers", "input", "trim",
             "front_adapters", "back_adapters", "model", "himem",
             "device_consensus", "data_parallel"],
            ["1000", "15", "10000", "10000", "10", "0.25", "4", "", "0",
             "", "", "", "true", "true", "false"],
            ["Size of overlap to search for in bases",
             "Minimum number of seeds to generate for each overlap query",
             "Maximum total unique seeds to use in each query batch",
             "Size to chop long reads into for querying against, in bases",
             "Number of bases in each seed",
             "Minimum proportion of seeds that must match each query",
             "Number of worker threads to spawn",
             "Fasta/fastq input file",
             "Whether to search for and trim adapters: 0=off, 1=on",
             "Fasta/fastq file containing front adapters",
             "Fasta/fastq file containing back adapters",
             "K-mer numeric values to use in alignment",
             "Whether to cache all reads in memory",
             "Run base-space consensus on the device beam engine "
             "(bulk vmapped dispatches; offsets stay approximate; "
             "parity-validated vs the host landmark engine — "
             "false runs the faithful host beam)",
             "Shard query batches across all attached devices "
             "(jax.sharding data mesh; the chunk index replicates)"])

    def run(self, args):
        from ..io import SequenceSet
        from ..seeds import SeedIndex
        from ..overlap import Overlapper, QUERY_ALL
        from ..overlap.pileup import cleanup_overlaps, new_pileup
        from ..consensus import build_consensus as base_consensus
        from ..utils import kmer_occurrences
        from ..utils.kmers import score_seed_values
        from ..align.model import Model

        overlap_size = parse_int(args["overlap_size"])
        num_seeds = parse_int(args["num_seeds"])
        seed_batch_size = parse_int(args["seed_batch_size"])
        chunk_size = parse_int(args["chunk_size"])
        k = parse_int(args["k"])
        hit_fraction = parse_float(args["min_hits"])
        mod = Model(args["model"], False) if args.get("model") else None

        mesh = None
        if parse_bool(args["data_parallel"]):
            from ..parallel.mesh import make_mesh
            mesh = make_mesh()
        seq_set = SequenceSet(args["input"], min_length=overlap_size,
                              cache=parse_bool(args["himem"]))
        if args.get("trim") == "1":
            from ..trim.trimmer import load_trimmer
            trimmer = load_trimmer(args["front_adapters"],
                                   args["back_adapters"], 5)
            trimmer.trim(seq_set)
            trimmer.print_stats()

        counts = kmer_occurrences(seq_set.get_sequences(), k, mesh=mesh)
        values = score_seed_values(counts, k)

        while True:
            ids, lengths = seq_set.get_ids_by_length()
            if not ids or lengths[-1] < 1000:
                break
            # pick the longest sequences to fill the seed budget
            # (ref: correct.go:72-89; the reference then clamps to one)
            last = len(lengths) - 1
            start = last
            approx = (lengths[start] // overlap_size + 1) * num_seeds
            while start >= 0 and approx < seed_batch_size:
                approx += (lengths[start] // overlap_size + 1) * num_seeds
                start -= 1
            if start < last:
                start = last - 1
                ids = ids[start + 1:]
            else:
                ids = ids[last:]
            print("Query ids are", ids, file=sys.stderr)

            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size, 10,
                                    hit_fraction, mesh=mesh)
            queries = overlapper.prepare_queries(
                num_seeds, seed_batch_size, values,
                seq_set.get_sequences_by_id(ids), QUERY_ALL)
            print(f"Produced a query set of {len(queries)} queries using "
                  f"{index.num_seeds} seeds.", file=sys.stderr)
            results = _perform_queries(queries, overlapper, overlap_size,
                                       seq_set, ids)
            seed_consensus = []
            seq_ids = set()
            for rs in results:
                for hits in rs:
                    if hits:
                        _remove_duplicates(hits)
                rs.sort(key=lambda h: h[0].seq_a.offset if h else 1 << 30)
                cleanup_overlaps(rs, overlap_size, k)
                seed_consensus.append(
                    _seed_space_consensus(rs, index, seq_ids))

            all_seq = {}
            if seq_ids:
                for s in seq_set.get_sequences_by_id(sorted(seq_ids)):
                    all_seq[s.id] = s
            print("Preparing base-space consensus of all query results.",
                  file=sys.stderr)
            consensus_seqs = []
            if parse_bool(args["device_consensus"]):
                from ..consensus import build_consensus_bulk
                flat = [c for contigs in seed_consensus for c in contigs
                        if c is not None]
                for _, cons in build_consensus_bulk(flat, all_seq, mod):
                    if cons is not None:
                        consensus_seqs.append(cons)
            else:
                for contigs in seed_consensus:
                    for contig in contigs:
                        if contig is None:
                            continue
                        _, cons = base_consensus(contig, all_seq, mod, False)
                        if cons is not None:
                            consensus_seqs.append(cons)
            print(f"Received {len(consensus_seqs)} consensus results.",
                  file=sys.stderr)

            # round 2: consensus outputs become queries
            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size, 10,
                                    hit_fraction, mesh=mesh)
            next_queries = overlapper.prepare_queries(
                num_seeds, seed_batch_size, values, iter(consensus_seqs),
                QUERY_ALL)
            refined = _perform_queries(next_queries, overlapper,
                                       overlap_size, seq_set, ids)
            seed_consensus = []
            seq_ids = set()
            for rs in refined:
                for hits in rs:
                    if hits:
                        _remove_duplicates(hits)
                rs.sort(key=lambda h: h[0].seq_a.offset if h else 1 << 30)
                cleanup_overlaps(rs, overlap_size, k)
                seed_consensus.append(
                    _seed_space_consensus(rs, index, seq_ids))
            if seed_consensus and any(c is not None
                                      for c in seed_consensus[0]):
                new_pileup(seed_consensus[0])
            # emit the corrected (consensus) sequences — the reference's
            # unimplemented step 7
            for i, cons in enumerate(consensus_seqs):
                name = seq_set.get_name(cons.id) if cons.id >= 0 \
                    else f"consensus_{i}"
                print(f">{name}_corrected\n{cons}")
            break  # the reference breaks after one outer round
