"""Base-space consensus glue: slice contig parts, run the DTW engine,
write refined offsets back (ref: consensus/consensus.go:15-131)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.sequence import Sequence
from ..align import DTWAligner, SimpleMeasure
from ..overlap.combine import SeedContig


def build_consensus(contig: SeedContig, sequences, model=None,
                    full_match: bool = False, engine: str = "host"
                    ) -> Tuple[Optional[SeedContig], Optional[Sequence]]:
    """``sequences`` maps read id -> Sequence (list or dict).  Returns the
    updated contig and the consensus Sequence (carrying the base read's
    id/offsets when one part is the query itself), or (None, None).

    ``engine="host"`` runs the faithful landmark beam (align.dtw);
    ``engine="device"`` runs the fixed-beam device engine (ops.dtw) — faster
    in bulk, no per-sequence positions, so contig offsets are left
    approximate."""
    k = 5
    cost_threshold = 200
    initial_gap_cost = 5
    if model is not None:
        k = model.k
        initial_gap_cost = 2
    seqs, rcs, seq_map, base_seq_index = _prepare_parts(contig, sequences, k)
    if len(seqs) < 3:
        return None, None

    measure = model.clone() if model is not None else SimpleMeasure(k)
    if engine == "device":
        from ..ops.dtw import consensus_kmers
        table = measure.pair_table() if model is None \
            else model.pair_table()
        kmers = consensus_kmers(seqs, table, k,
                                threshold=cost_threshold,
                                gap_cost=initial_gap_cost,
                                simple_k=k if model is None else 0)
        if len(kmers) < 100:
            return None, None
        consensus_len = len(kmers) - k + 1
        for i in range(len(contig.lengths)):
            contig.lengths[i] = consensus_len
            contig.approximate[i] = True
        codes = _kmers_to_codes(kmers, k)
        return contig, Sequence(codes, id=-1)
    measure.set_sequences(seqs, rcs)
    dtw = DTWAligner(16, initial_gap_cost, measure, full_match,
                     cost_threshold, k)
    kmers, costs, positions = dtw.global_alignment()
    if len(kmers) < 100:  # too short; bad sequence match
        return None, None
    start_positions = positions[0]
    end_positions = positions[-1]
    consensus_len = len(kmers) - k + 1

    for i in range(len(contig.lengths)):
        contig.lengths[i] = consensus_len
        contig.approximate[i] = True
    for i, index in enumerate(seq_map):
        contig.approximate[index] = False
        if contig.reverse_complement[index]:
            contig.offsets[index] += len(seqs[i]) - end_positions[i]
        else:
            contig.offsets[index] += start_positions[i]
        contig.lengths[index] = end_positions[i] - start_positions[i] + k - 1

    codes = _kmers_to_codes(kmers, k)
    if base_seq_index == -1:
        consensus = Sequence(codes, id=-1)
    else:
        offset = contig.offsets[base_seq_index]
        inset = contig.seq_lengths[base_seq_index] - offset - consensus_len
        consensus = Sequence(codes, id=contig.parts[base_seq_index],
                             offset=offset, inset=inset)
    return contig, consensus


def _prepare_parts(contig: SeedContig, sequences, k: int):
    """Slice each contig part to its window, RC-normalize, emit k-mer
    streams (the loop shared by both engines; ref:
    consensus/consensus.go:30-63)."""
    seqs: List[np.ndarray] = []
    rcs: List[bool] = []
    seq_map: List[int] = []
    base_seq_index = -1
    for i, rid in enumerate(contig.parts):
        if contig.matches is not None and \
                contig.matches[i].seq_a.id == contig.matches[i].seq_b.id:
            base_seq_index = i
        if contig.approximate[i]:
            continue
        b = sequences[rid]
        start = contig.offsets[i]
        if start < 0:
            if start < -5:
                continue
            start = 0
        end = contig.offsets[i] + contig.lengths[i]
        if end > len(b):
            if end > len(b) + 100 or (contig.reverse_complement[i]
                                      and end > len(b) + 5):
                continue
            end = len(b)
        if start >= end:
            start = end - 1
        sub = b.subsequence(start, end)
        if contig.reverse_complement[i]:
            sub = sub.reverse_complement()
        rcs.append(contig.reverse_complement[i])
        seqs.append(sub.short_kmers(k, False))
        seq_map.append(i)
    return seqs, rcs, seq_map, base_seq_index


def build_consensus_bulk(contigs: List[SeedContig], sequences, model=None
                         ) -> List[Tuple[Optional[SeedContig],
                                         Optional[Sequence]]]:
    """Device-engine consensus over many contigs in few dispatches.

    The per-contig prep/validation matches ``build_consensus``; all valid
    jobs then run through ``ops.dtw.consensus_kmers_bulk`` (shape-bucketed
    vmapped beam search).  Offsets are left approximate, as with
    ``engine="device"``.  Returns (contig, consensus) per input."""
    from ..ops.dtw import consensus_kmers_bulk
    from ..align import SimpleMeasure

    k = 5
    cost_threshold = 200
    initial_gap_cost = 5
    if model is not None:
        k = model.k
        initial_gap_cost = 2
    table = (SimpleMeasure(k).pair_table() if model is None
             else model.pair_table())
    jobs = []
    job_map = []
    out: List[Tuple[Optional[SeedContig], Optional[Sequence]]] = \
        [(None, None)] * len(contigs)
    for ci, contig in enumerate(contigs):
        seqs, _, _, _ = _prepare_parts(contig, sequences, k)
        if len(seqs) < 3:
            continue
        job_map.append(ci)
        jobs.append(seqs)
    if not jobs:
        return out
    all_kmers = consensus_kmers_bulk(jobs, table, k,
                                     threshold=cost_threshold,
                                     gap_cost=initial_gap_cost,
                                     simple_k=k if model is None else 0)
    for ji, ci in enumerate(job_map):
        kmers = all_kmers[ji]
        if len(kmers) < 100:
            continue
        contig = contigs[ci]
        consensus_len = len(kmers) - k + 1
        for i in range(len(contig.lengths)):
            contig.lengths[i] = consensus_len
            contig.approximate[i] = True
        out[ci] = (contig, Sequence(_kmers_to_codes(kmers, k), id=-1))
    return out


def _kmers_to_codes(kmers, k: int) -> np.ndarray:
    """k-mer stream -> base codes (ref: sequence/sequence.go:107-117)."""
    n = len(kmers)
    codes = np.empty(n + k - 1, dtype=np.uint8)
    first = int(kmers[0])
    for i in range(k - 1):
        codes[i] = (first >> (2 * (k - i - 1))) & 3
    for i, v in enumerate(kmers):
        codes[i + k - 1] = int(v) & 3
    return codes
