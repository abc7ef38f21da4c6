"""Seed-space multiple sequence alignment (the reference's multiAligner).

A synchronous sweep over the reduced seed sequences: at each step the
sequences vote on the nearest supported next seed, the winner is emitted
into the consensus with its mean distance, and matching members advance
(ref: seeds/alignment.go:9-268).  Sizes are tiny (tens of sequences, ~100
shared seeds) so this runs on host; the per-step support counting is
vectorized where it pays.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .seed_sequence import SeedSequence, SeedMatch


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // b
    return -q if a < 0 else q


def _gap_range(gap: int, k: int) -> Tuple[int, int]:
    """ref: seeds/alignment.go:411-424 (Go integer division truncates)."""
    min_gap = _trunc_div(gap * 2, 3) - k
    max_gap = _trunc_div(gap * 3, 2) + k + 1
    if min_gap < 0:
        min_gap = -k
        if max_gap < 0:
            max_gap = 0
    elif max_gap < 20:
        max_gap = 20
        min_gap = 0
    return min_gap, max_gap


def consensus(seqs: List[SeedSequence], k: int):
    """Returns (consensus SeedSequence, list of SeedMatch of members onto
    it).  Mirrors multiAligner.Consensus including its support voting and
    stepping rules.

    The sweep itself runs in native C++ when the toolchain is available
    (seqscan.cpp ``msa_consensus`` — bit-identical by parity test; the
    Python loop below is the oracle): the per-overlap Python sweep was
    ~20% of the overlap CLI's wall clock."""
    import os
    if os.environ.get("DOWNPORE_TPU_PY_MSA", "") != "1":
        out = _consensus_native(seqs, k)
        if out is not None:
            return out
    return _consensus_py(seqs, k)


def _consensus_native(seqs: List[SeedSequence], k: int):
    """Native-sweep front half: same reduction as the Python path, the
    while loop in C++, SeedMatch assembly back here."""
    from .. import native
    if native.load() is None:
        return None
    n = len(seqs)
    # seeds appearing in >= 2 members, vectorized (per-member unique,
    # concat, count)
    uniqs = [np.unique(s.seeds) for s in seqs if s.num_seeds]
    if uniqs:
        allu = np.concatenate(uniqs)
        vals, cnts = np.unique(allu, return_counts=True)
        max_seed = int(vals[-1]) if vals.size else 0
        use = np.zeros(max_seed + 2, dtype=bool)
        use[vals[cnts >= 2]] = True
    else:
        use = np.zeros(2, dtype=bool)
    segments: List[Optional[np.ndarray]] = [None] * n
    seed_maps: List[Optional[np.ndarray]] = [None] * n
    for i, s in enumerate(seqs):
        red, sm = s.reduced(use, k, 1, True)
        if red is not None:
            seed_maps[i] = sm
            segments[i] = red.segments()
    res = native.msa_consensus(segments, k)
    if res is None:
        return None
    cons_arr, out_a, out_b = res
    cons = np.empty(cons_arr.shape[0] + 1, np.int32)
    cons[:-1] = cons_arr
    cons[-1] = 0
    seed_cons = SeedSequence.from_segments(cons, k)
    out = []
    for i in range(n):
        if segments[i] is None or len(out_a[i]) < 3:
            continue
        m = SeedMatch(out_a[i].tolist(),
                      seed_maps[i][out_b[i]].tolist(),
                      seed_cons, seqs[i])
        out.append(m)
    return seed_cons, out


def _consensus_py(seqs: List[SeedSequence], k: int):
    """Pure-Python oracle sweep (the original port)."""
    n = len(seqs)
    # seeds appearing in >= 2 sequences
    from collections import Counter
    counter = Counter()
    for s in seqs:
        for seed in set(int(x) for x in s.seeds):
            counter[seed] += 1
    max_seed = max((int(s.seeds.max()) for s in seqs if s.num_seeds), default=0)
    use = np.zeros(max_seed + 2, dtype=bool)
    for seed, c in counter.items():
        if c >= 2:
            use[seed] = True

    segments: List[Optional[np.ndarray]] = [None] * n  # interleaved views
    seed_maps: List[Optional[np.ndarray]] = [None] * n
    red_seqs: List[Optional[SeedSequence]] = [None] * n
    for i, s in enumerate(seqs):
        red, sm = s.reduced(use, k, 1, True)
        if red is not None:
            red_seqs[i] = red
            seed_maps[i] = sm
            segments[i] = red.segments()

    pos = [-1] * n
    offset = [0] * n
    gaps = [50] * n  # leeway at the start
    cons: List[int] = []
    matches: List[Optional[SeedMatch]] = [None] * n
    for i in range(n):
        if segments[i] is not None:
            matches[i] = SeedMatch([], [], None, seqs[i])

    supported = [0] * n
    dist = [0] * n
    finished = False
    while not finished:
        f_count = 0
        near = 100000
        for i, seg in enumerate(segments):
            p = pos[i]
            supported[i] = 0
            if seg is None or p >= (len(seg) - 1) // 2 - 1:
                f_count += 1
                continue
            d = int(seg[p * 2 + 2]) - offset[i]
            dist[i] = d
            if d < near and d > -k:
                next_seed = int(seg[p * 2 + 3])
                min_d, max_d = _gap_range(d + gaps[i], k)
                min_d -= gaps[i]
                max_d -= gaps[i]
                if near > max_d:
                    near = max_d
                supported[i] = 1
                for j, seg2 in enumerate(segments):
                    if seg2 is None or j == i:
                        continue
                    p2 = pos[j] + 1
                    if p2 < len(seg2) // 2:
                        min2, max2 = _gap_range(d + gaps[j], k)
                        min2 = min(min2, min_d)
                        max2 = max(max2, max_d)
                        other_d = int(seg2[p2 * 2]) - offset[j]
                        while other_d < min2 and p2 < len(seg2) // 2:
                            p2 += 1
                            if p2 >= len(seg2) // 2:
                                break
                            other_d += int(seg2[p2 * 2]) + k
                        while other_d < max2 and p2 < len(seg2) // 2:
                            if int(seg2[p2 * 2 + 1]) == next_seed:
                                supported[i] += 1
                                dist[i] += other_d
                                break
                            p2 += 1
                            if p2 >= len(seg2) // 2:
                                break
                            other_d += int(seg2[p2 * 2]) + k
        if f_count >= n:
            break
        # select the minimum-distance supported option
        minseed = -1
        mindist = 0
        minsup = 0
        min_d = max_d = 0
        for i, d in enumerate(dist):
            if supported[i] > 1:
                d = d // supported[i] if d >= 0 else -((-d) // supported[i])
                seed = int(segments[i][pos[i] * 2 + 3])
                if (minseed == -1
                        or (minseed == seed and supported[i] > minsup)
                        or (minseed != seed and mindist > d)):
                    minsup = supported[i]
                    mindist = d
                    minseed = seed
                    min_d, max_d = _gap_range(d + gaps[i], k)
                    min_d -= gaps[i]
                    max_d -= gaps[i]
        if minseed == -1:
            # no supports: step the shortest gap (ref: alignment.go:162-189)
            min_index = -1
            min_dist = 100000
            for i, d in enumerate(dist):
                if supported[i] > 1:
                    d = d // supported[i]
                if (segments[i] is not None and pos[i] < len(segments) // 2
                        and d < min_dist):
                    min_dist = d
                    min_index = i
            if min_index == -1:
                break
            for i, seg in enumerate(segments):
                if seg is not None:
                    gaps[i] += min_dist
                    offset[i] += min_dist
            gaps[min_index] = 0
            offset[min_index] = 0
            pos[min_index] += 1
            continue
        cons.append(mindist)
        cons.append(minseed)
        # build matchings and step past (ref: alignment.go:195-250)
        f_count = 0
        for i, seg in enumerate(segments):
            if seg is None:
                f_count += 1
                continue
            match_dex = pos[i] + 1
            if match_dex < len(seg) // 2:
                min2, max2 = _gap_range(mindist + gaps[i], k)
                min2 = min(min2, min_d)
                max2 = max(max2, max_d)
                other_d = int(seg[match_dex * 2]) - offset[i]
                while other_d < min2 and match_dex < len(seg) // 2:
                    match_dex += 1
                    if match_dex >= len(seg) // 2:
                        break
                    other_d += int(seg[match_dex * 2]) + k
                found = False
                while other_d < max2 and match_dex < len(seg) // 2:
                    if int(seg[match_dex * 2 + 1]) == minseed:
                        pos[i] = match_dex
                        offset[i] = 0
                        gaps[i] = 0
                        matches[i].match_a.append(len(cons) // 2 - 1)
                        matches[i].match_b.append(int(seed_maps[i][match_dex]))
                        found = True
                        break
                    match_dex += 1
                    if match_dex >= len(seg) // 2:
                        break
                    other_d += int(seg[match_dex * 2]) + k
                if not found:
                    gaps[i] += mindist
                    offset[i] += mindist
                    p = pos[i]
                    while (p < len(seg) // 2
                           and offset[i] > int(seg[p * 2 + 2]) + 50):
                        offset[i] -= int(seg[p * 2 + 2]) + k
                        p += 1
                        pos[i] += 1
                    if p >= len(seg) // 2:
                        f_count += 1
            else:
                f_count += 1
        finished = f_count >= n

    cons.append(0)
    seed_cons = SeedSequence.from_segments(cons, k)
    out = []
    for i, m in enumerate(matches):
        if m is not None and len(m.match_a) >= 3:
            m.seq_a = seed_cons
            out.append(m)
    return seed_cons, out
