"""Candidate retrieval: seed-hit counting as an integer matmul.

The reference answers "which indexed chunks share >= hitFraction of the
query's seeds" with a per-word bitset soft-union cascade in hand-written
SIMD (ref: util/bitset.go:308-411, util/asm_amd64.s:121-509).  On an
accelerator the natural formulation is dense linear algebra: with the inverted index as a
0/1 membership matrix ``M[num_seeds, num_chunks]`` and a batch of queries
as multiplicity vectors ``V[num_queries, num_seeds]`` (one count per run
of each seed, consecutive duplicates collapsed, exactly the multiset the
reference feeds GetSharedIDs), the shared-seed counts are ``V @ M`` — one
int8 matmul with int32 accumulation, replacing both the
soft-union candidate retrieval and the per-candidate popcount gate
(ref: util/bitset.go:179, overlap/overlap.go:359).

The exact counts make this the reference's *slow-path* (exact) semantics;
its fast path may return supersets for min_count > 16.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def hit_counts_packed(packed: jax.Array, membership: jax.Array) -> jax.Array:
    """``[Q, S//8] uint8 (bit-packed rows) x [S, C] -> [Q, C]`` counts.

    The query matrix ships to the device bit-packed (8x smaller host->device
    transfer) and unpacks on device with shift/mask before the matmul."""
    Q, SB = packed.shape
    bits = jnp.right_shift(packed[:, :, None],
                           jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
    unpacked = bits.reshape(Q, SB * 8).astype(jnp.int8)
    S = membership.shape[0]
    return jax.lax.dot_general(
        unpacked[:, :S], membership,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


@functools.partial(jax.jit, static_argnames=())
def hit_counts(query_multi: jax.Array, membership: jax.Array) -> jax.Array:
    """``[Q, S] x [S, C] -> [Q, C]`` shared-seed counts (int32).

    ``query_multi`` is int8 per-seed run multiplicities; ``membership`` is
    the int8 0/1 seed->chunk matrix.
    """
    return jax.lax.dot_general(
        query_multi, membership,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def candidates_from_counts(counts: np.ndarray, num_sets: np.ndarray,
                           hit_fraction: float, min_sets: int = 5):
    """Threshold hit counts into candidate lists, mirroring
    ``SeedIndex.Matches`` (ref: seeds/seeds.go:348-352).

    ``counts``: [Q, C] int; ``num_sets``: [Q] number of usable query seed
    runs.  Queries with fewer than ``min_sets`` usable seeds get no
    candidates.  Returns a list of np arrays of chunk indices.
    """
    counts = np.asarray(counts)
    num_sets = np.asarray(num_sets)
    min_count = (hit_fraction * num_sets + 0.5).astype(np.int64)
    out = []
    for qi in range(counts.shape[0]):
        if num_sets[qi] < min_sets:
            out.append(np.empty(0, dtype=np.int64))
        else:
            out.append(np.flatnonzero(counts[qi] >= min_count[qi]))
    return out


def choose_hash_size(num_seeds: int, max_h: int = 1 << 17) -> int:
    """Bucket-space size for the hashed membership matmul: identity when the
    seed space is small, else a power-of-two cap.  Hash collisions only ever
    *add* counts, so candidate recall vs the exact computation is preserved
    (the chain DP downstream is the precision filter)."""
    h = 1
    while h < num_seeds:
        h *= 2
    return min(h, max_h)


def hash_ids(ids: np.ndarray, num_seeds: int, H: int) -> np.ndarray:
    """Seed id -> bucket.  Identity when everything fits; Knuth
    multiplicative hashing otherwise."""
    if num_seeds <= H:
        return np.asarray(ids, dtype=np.int64)
    return ((np.asarray(ids, dtype=np.uint64) * np.uint64(2654435761))
            % np.uint64(H)).astype(np.int64)


def build_membership(chunk_seed_lists, num_seeds: int,
                     H: Optional[int] = None) -> np.ndarray:
    """Hashed 0/1 membership matrix ``[H, C]`` int8 from per-chunk seed-id
    lists — the inverted index in matmul form."""
    if H is None:
        H = choose_hash_size(num_seeds)
    C = len(chunk_seed_lists)
    M = np.zeros((H, C), dtype=np.int8)
    for ci, seeds in enumerate(chunk_seed_lists):
        if len(seeds):
            M[hash_ids(np.unique(seeds), num_seeds, H), ci] = 1
    return M


def build_query_rows(queries, num_seeds: int, usable: np.ndarray,
                     H: Optional[int] = None):
    """Hashed query matrices: returns (V_runs [Q, H] int8 with per-run
    multiplicities, V_distinct [Q, H] int8 0/1, num_sets [Q]).

    ``num_sets`` (the usable-run count feeding min_count) is exact even
    when buckets collide."""
    if H is None:
        H = choose_hash_size(num_seeds)
    qs = list(queries)
    V = np.zeros((len(qs), H), dtype=np.int8)
    VD = np.zeros((len(qs), H), dtype=np.int8)
    num_sets = np.zeros(len(qs), dtype=np.int32)
    for i, q in enumerate(qs):
        prev = -1
        n = 0
        distinct = set()
        for s in q.seeds:
            s = int(s)
            if s != prev and usable[s]:
                b = int(hash_ids(np.int64(s), num_seeds, H))
                V[i, b] += 1
                distinct.add(b)
                n += 1
                prev = s
        for b in distinct:
            VD[i, b] = 1
        num_sets[i] = n
    return V, VD, num_sets


def build_query_matrix(queries, num_seeds: int, usable: np.ndarray):
    """Stack per-query seed run multiplicities into ``[Q, S]`` int8.

    ``queries`` is an iterable of SeedSequence; ``usable`` a bool mask over
    seed ids (seeds absent from every chunk or present in all chunks are
    unusable, ref: seeds/seeds.go:343).  Returns (matrix, num_sets).
    """
    qs = list(queries)
    V = np.zeros((len(qs), num_seeds), dtype=np.int8)
    num_sets = np.zeros(len(qs), dtype=np.int32)
    for i, q in enumerate(qs):
        prev = -1
        n = 0
        for s in q.seeds:
            s = int(s)
            # prev only advances on an accepted seed, as in the reference
            if s != prev and usable[s]:
                V[i, s] += 1
                n += 1
                prev = s
        num_sets[i] = n
    return V, num_sets
