"""Seed index: k-mer seed tables and the inverted chunk index.

The reference keeps one bitset per seed listing the chunks that contain it
and answers queries with a soft-union popcount cascade
(ref: seeds/seeds.go:11-21, util/bitset.go:308).  Here the inverted index
is a dense seed-membership matrix so that candidate retrieval becomes an
integer matmul on the device (``downpore_tpu.ops.match``); this module holds
the host-side tables (k-mer -> seed id maps, per-chunk seed lists) and the
numpy oracle for ``matches``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.sequence import Sequence, kmer_reverse_complement, rolling_kmers
from .seed_sequence import SeedSequence


class SeedIndex:
    def __init__(self, k: int):
        self.k = k
        size = 4 ** k
        self.kmer_table = np.zeros(size, dtype=bool)      # kmer in seed set?
        self.kmer_map = np.full(size, -1, dtype=np.int32)  # kmer -> seed id
        self.seed_map: List[int] = []                      # seed id -> kmer
        self.sequences: List[SeedSequence] = []            # indexed chunks
        self._membership: Optional[np.ndarray] = None      # [S, C] bool
        self._seed_counts: Optional[np.ndarray] = None     # chunks per seed

    # ------------------------------------------------------------------
    @property
    def num_seeds(self) -> int:
        return len(self.seed_map)

    @property
    def num_sequences(self) -> int:
        return len(self.sequences)

    def seed_kmers_of(self, seeds: np.ndarray) -> np.ndarray:
        """Vectorized seed id -> k-mer lookup (cached numpy view of
        ``seed_map``, rebuilt only when seeds were added)."""
        cached = getattr(self, "_seed_map_arr", None)
        if cached is None or cached.shape[0] != len(self.seed_map):
            cached = np.array(self.seed_map, dtype=np.int64)
            self._seed_map_arr = cached
        return cached[seeds]

    def _add_seed_kmer(self, kmer: int) -> int:
        """Register a k-mer as a seed, returning its seed id."""
        if self.kmer_table[kmer]:
            return int(self.kmer_map[kmer])
        sid = len(self.seed_map)
        self.kmer_table[kmer] = True
        self.kmer_map[kmer] = sid
        self.seed_map.append(kmer)
        return sid

    # -- seed selection ------------------------------------------------
    def new_seed_sequence(self, seq: Sequence) -> SeedSequence:
        """Gapped-seed extraction against the current seed set
        (ref: seeds/seeds.go:33-50)."""
        gaps, kmers = seq.write_segments(self.k, self.kmer_table)
        seeds = self.kmer_map[kmers]
        return SeedSequence(gaps, seeds, id=seq.id, name=seq.get_name(),
                            length=len(seq), offset=seq.offset,
                            inset=seq.inset)

    def new_seed_sequences_batch(self, seqs) -> List[SeedSequence]:
        """``new_seed_sequence`` over many reads with ONE native call per
        ~2048-read block (thread fan-out inside): the per-read
        Python/ctypes round trip dominated overlap round prep.  Exact
        same output as the per-read path (the native kernel is the same
        ``write_segments`` applied per row)."""
        seqs = [s for s in seqs if s is not None]
        from .. import native
        if self.k > 15 or native.load() is None:
            return [self.new_seed_sequence(s) for s in seqs]
        out: List[SeedSequence] = []
        tbl = self.kmer_table.view(np.uint8)
        # block boundaries bound the concat staging buffer by BOTH read
        # count and cumulative bases: gaps+kmers staging costs ~8
        # bytes/base, so 2048 ultralong (100 kb-1 Mb) reads would
        # transiently allocate GBs if capped by count alone
        BLOCK = 2048
        MAX_BASES = 48 << 20
        blocks = []
        cur, cur_bases = [], 0
        for s in seqs:
            cur.append(s)
            cur_bases += len(s)
            if len(cur) >= BLOCK or cur_bases >= MAX_BASES:
                blocks.append(cur)
                cur, cur_bases = [], 0
        if cur:
            blocks.append(cur)
        for blk in blocks:
            lens = np.fromiter((len(s) for s in blk), np.int64,
                               count=len(blk))
            off = np.empty(len(blk), np.int64)
            off[0] = 0
            np.cumsum(lens[:-1], out=off[1:])
            codes = np.empty(int(off[-1] + lens[-1]), np.uint8)
            for s, o, L in zip(blk, off, lens):
                codes[int(o) : int(o) + int(L)] = s.codes
            res = native.write_segments_batch(codes, off, lens, self.k,
                                              tbl)
            if res is None:
                out.extend(self.new_seed_sequence(s) for s in blk)
                continue
            gaps_f, kmers_f, gout, counts = res
            for i, s in enumerate(blk):
                c = int(counts[i])
                o = int(gout[i])
                out.append(SeedSequence(
                    gaps_f[o : o + c + 1].copy(),
                    self.kmer_map[kmers_f[o : o + c]],
                    id=s.id, name=s.get_name(), length=len(s),
                    offset=s.offset, inset=s.inset))
        return out

    def new_all_seed_sequence(self, seq: Sequence) -> SeedSequence:
        """Every k-mer of the sequence becomes a seed (adapters; no RC twins
        are added) (ref: seeds/seeds.go:204-237)."""
        kmers = seq.kmers(self.k)
        seeds = np.empty(kmers.shape[0], dtype=np.int32)
        for i, km in enumerate(kmers):
            seeds[i] = self._add_seed_kmer(int(km))
        gaps = np.full(kmers.shape[0] + 1, 1 - self.k, dtype=np.int32)
        gaps[0] = 0
        gaps[-1] = 0
        return SeedSequence(gaps, seeds, id=seq.id, name=seq.get_name(),
                            length=len(seq), offset=seq.offset,
                            inset=seq.inset)

    def add_seeds(self, seq: Sequence, min_seeds: int,
                  kmer_ranks: np.ndarray):
        """Top-N windowed seed selection over a read: pick the best-ranked
        new k-mer per k-length block (skipping blocks that already contain a
        seed), keep the global top ``min_seeds``, and always add the
        reverse-complement twin (ref: seeds/seeds.go:62-156)."""
        k = self.k
        n = len(seq)
        count = seq.count_kmers(k, self.kmer_table, up_to=min_seeds)
        count = 0  # the reference zeroes the reuse count (seeds.go:74)
        if count >= min_seeds:
            return
        q = seq.quality
        kmers = seq.kmers(k)
        values = kmer_ranks[kmers]
        if q is not None:
            # quality of the base at nextIndex - k/2 in the reference loop,
            # i.e. centre-ish base of the k-mer
            centre = np.arange(kmers.shape[0]) + k - k // 2
            centre = np.clip(centre, 0, len(q) - 1)
            values = values * q[centre].astype(np.float64)
        in_index = self.kmer_table[kmers]

        from .. import native
        nat = native.add_seeds_walk(kmers, values, in_index, n, k,
                                    min_seeds - count)
        if nat is not None:
            for kmer in nat:
                self._add_seed_kmer(int(kmer))
                self._add_seed_kmer(kmer_reverse_complement(int(kmer), k))
            self._membership = None
            self._seed_counts = None
            return

        top_n: List[int] = []
        top_vals: List[float] = []

        def push(kmer: int, value: float):
            # bounded ascending insert, bottom spot shuffled out
            # (ref: seeds/seeds.go:108-119)
            if len(top_n) < min_seeds - count:
                top_n.append(kmer)
                top_vals.append(value)
                # keep sorted ascending
                i = len(top_n) - 1
                while i > 0 and top_vals[i - 1] > top_vals[i]:
                    top_vals[i - 1], top_vals[i] = top_vals[i], top_vals[i - 1]
                    top_n[i - 1], top_n[i] = top_n[i], top_n[i - 1]
                    i -= 1
                return
            if value <= top_vals[0]:
                return
            top_vals[0] = value
            top_n[0] = kmer
            i = 0
            while i + 1 < len(top_vals) and top_vals[i] > top_vals[i + 1]:
                top_vals[i], top_vals[i + 1] = top_vals[i + 1], top_vals[i]
                top_n[i], top_n[i + 1] = top_n[i + 1], top_n[i]
                i += 1

        # walk k-length blocks; a block containing an existing seed resets
        next_index = k  # index of next base to consume; kmer ends at it
        while next_index < n - k:
            reset = False
            best_value = 0.0
            best_seed = -1
            steps = 0
            while next_index < n and steps < k:
                ki = next_index - k + 1  # kmer starting index
                kmer = int(kmers[ki])
                next_index += 1
                steps += 1
                if in_index[ki]:
                    reset = True
                    break
                value = float(values[ki])
                if value > best_value:
                    best_value = value
                    best_seed = kmer
            if not reset and best_seed >= 0:
                push(best_seed, best_value)
            next_index += 2 * k  # step past the seed (ref: seeds.go:123-127)
        for kmer in top_n:
            self._add_seed_kmer(kmer)
            self._add_seed_kmer(kmer_reverse_complement(kmer, k))
        self._membership = None
        self._seed_counts = None

    def add_single_seeds(self, seq: Sequence, seed_rate: int,
                         ranks: np.ndarray):
        """One best-ranked seed per ``seed_rate``-base window that has no
        existing seed (ref: seeds/seeds.go:160-200).  Vectorized over the
        whole reference sequence."""
        k = self.k
        kmers = seq.kmers(k)
        n = len(seq)
        if kmers.size == 0:
            return
        vals = ranks[kmers]
        from .. import native
        nat = native.add_single_seeds_walk(kmers, vals, n, k, seed_rate,
                                           self.kmer_table)
        if nat is not None:
            # the native walk already set kmer_table bits; register ids
            for km in nat:
                km = int(km)
                self.kmer_map[km] = len(self.seed_map)
                self.seed_map.append(km)
        else:
            for i in range(0, n - seed_rate, seed_rate):
                # kmers fully inside [i, i+seed_rate):
                # starts i .. i+seed_rate-k
                lo, hi = i, i + seed_rate - k + 1
                # live lookup so seeds added by earlier windows are seen
                if self.kmer_table[kmers[lo:hi]].any():
                    continue
                j = lo + int(np.argmax(vals[lo:hi]))
                self._add_seed_kmer(int(kmers[j]))
        self._membership = None
        self._seed_counts = None

    def get_seeds_from_kmers(self, kmers: np.ndarray) -> np.ndarray:
        """Distinct seed ids for the k-mers present in the seed set
        (ref: seeds/seeds.go:247)."""
        kmers = np.asarray(kmers, dtype=np.int64)
        hits = kmers[self.kmer_table[kmers]]
        return np.unique(self.kmer_map[hits]).astype(np.int32)

    # -- the inverted index --------------------------------------------
    def add_sequence(self, seq: SeedSequence):
        self.sequences.append(seq)
        self._membership = None
        self._seed_counts = None

    def index_sequences(self):
        """Build per-seed chunk counts (and the dense membership matrix for
        small indexes; large indexes use the hashed device path in
        ``ops.match``) (ref: seeds/seeds.go:292-305)."""
        S = self.num_seeds
        C = len(self.sequences)
        # one concatenated bincount: a per-chunk bincount(minlength=S)
        # allocated and summed a full [S] array per chunk (~3 TB of
        # traffic at 6.5k chunks x 67M seeds on a 64 Mb genome)
        uniq = [np.unique(s.seeds) for s in self.sequences if s.seeds.size]
        if uniq:
            counts = np.bincount(np.concatenate(uniq),
                                 minlength=S).astype(np.int64)
        else:
            counts = np.zeros(S, dtype=np.int64)
        self._seed_counts = counts
        self._membership = None
        if S * max(C, 1) <= 200_000_000:
            mem = np.zeros((S, C), dtype=bool)
            for ci, s in enumerate(self.sequences):
                mem[s.seeds, ci] = True
            self._membership = mem

    @property
    def membership(self) -> np.ndarray:
        if self._seed_counts is None or (self._membership is None
                                         and self.sequences):
            self.index_sequences()
        if self._membership is None:
            raise MemoryError("index too large for a dense membership "
                              "matrix; use the hashed device path "
                              "(ops.match.build_membership)")
        return self._membership

    def seed_count(self, seed: int) -> int:
        """Number of indexed chunks containing the seed."""
        if self._seed_counts is None:
            self.index_sequences()
        return int(self._seed_counts[seed])

    def get_seed_set(self, index: int) -> np.ndarray:
        """Bool whitelist over seed ids for chunk ``index``."""
        wl = np.zeros(self.num_seeds, dtype=bool)
        wl[self.sequences[index].seeds] = True
        return wl

    def remove_sequences(self):
        self.sequences = []
        self._membership = None
        self._seed_counts = None

    def query_seed_multiplicity(self, query: SeedSequence) -> np.ndarray:
        """Per-seed multiplicity vector for a query, counting runs of each
        seed with consecutive duplicates removed and unusable seeds dropped,
        mirroring the seed-set list built by Matches
        (ref: seeds/seeds.go:335-353)."""
        if self._seed_counts is None:
            self.index_sequences()
        v = np.zeros(self.num_seeds, dtype=np.int32)
        max_seqs = len(self.sequences)
        prev = -1
        for s in query.seeds:
            s = int(s)
            if s != prev and self._seed_counts[s] < max_seqs:
                v[s] += 1
                prev = s
        return v

    def matches(self, query: SeedSequence, hit_fraction: float) -> np.ndarray:
        """Chunks sharing at least ``hit_fraction`` of the query's usable
        seeds; numpy oracle for the device matmul path
        (ref: seeds/seeds.go:335, util/bitset.go:308)."""
        v = self.query_seed_multiplicity(query)
        num_sets = int(v.sum())
        if num_sets < 5:
            return np.empty(0, dtype=np.int64)
        min_count = int(hit_fraction * num_sets + 0.5)
        counts = v @ self.membership
        return np.flatnonzero(counts >= min_count)

    def seed_string(self, seed: int) -> str:
        from ..core.sequence import kmer_string
        return kmer_string(self.seed_map[seed], self.k)
