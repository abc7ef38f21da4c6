"""Device-resident fused mapping engine.

The reference's performMapping hot loop (ref: mapping/mapping.go:489-611)
does, per query window: soft-union candidate retrieval, a popcount gate,
and greedy chaining against each candidate chunk.  The r01 host path
batched each stage but re-shipped query matrices and ragged per-pair
target lists every stage — several MB and 3+ host<->device round trips
per batch.

Here the whole pipeline is ONE dispatch against resident state:

* ``membership [H, C] int8`` — hashed seed-bucket -> chunk matrix,
* ``t_seeds/t_pos [C, NT]`` — padded per-chunk seed tables,

and per batch the host uploads only compact per-query vectors (seed ids,
positions, run/distinct bucket lists — a few hundred KB).  On device:
retrieval counts and the distinct-seed gate are gathers over
``membership`` rows summed on device; passing (query, chunk) pairs are
compacted to a fixed budget; the anchor chain DP runs on those pairs with
targets gathered from the resident chunk tables; and one packed
``[budget, 40] int32`` array of (query, chunk, dcount, summary) rows is
fetched — bytes per candidate instead of MB per stage.

The adaptive min-match walk stays on host (it is sequential per query and
consumes only these rows), exactly as the reference iterates candidates.
"""
from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from . import match as match_ops
from .chain import make_anchors_topk, dp_from_anchors, dp_forward_lean, \
    summarize_dp, unpack_summary, _bucket, compact_indices

# binned-retrieval engagement threshold and bin width (module-level so
# tests can exercise the binned path at toy scale)
_BINNED_MIN_C = 1024
_BINNED_CB = 128


_async_copy_warned = False


def _async_copy(*arrays):
    """Best-effort copy_to_host_async over device arrays.  A failing
    async-copy path silently degrades to the (slower) blocking fetch, so
    the first failure is reported once — otherwise the perf regression
    is undiagnosable."""
    global _async_copy_warned
    try:
        for a in arrays:
            a.copy_to_host_async()
        return True
    except Exception as e:
        if not _async_copy_warned:
            _async_copy_warned = True
            import warnings
            warnings.warn(
                f"copy_to_host_async unavailable ({type(e).__name__}: {e});"
                " falling back to blocking fetches", RuntimeWarning)
        return False


def _stream_home(fut):
    """Start a fused-map result streaming host-ward at dispatch time.
    With the combined single-tensor output this is ONE bulk async copy
    (+ the n_ok scalar) per batch — it transfers while later batches
    pack/compute, emptying the collect-time fetch."""
    if len(fut) == 2 or (len(fut) == 3 and fut[1].ndim == 0):
        _async_copy(*fut)
    return fut


def _split_result(vals):
    """(head int32 [B,3], packed int16, n_ok int, n_bin int|None) from
    any fused-map result form: combined single tensor, legacy 3-tuple,
    or either with the binned gate's trailing n_bin scalar."""
    if len(vals) == 2:
        comb, n_ok = vals
        return (np.asarray(comb[:, :3], np.int32), comb[:, 3:],
                int(n_ok), None)
    if len(vals) == 3 and np.ndim(vals[1]) == 0:   # binned + combined
        comb, n_ok, n_bin = vals
        return (np.asarray(comb[:, :3], np.int32), comb[:, 3:],
                int(n_ok), int(n_bin))
    if len(vals) == 3:
        head, packed, n_ok = vals
        return head, packed, int(n_ok), None
    head, packed, n_ok, n_bin = vals
    return head, packed, int(n_ok), int(n_bin)


@functools.partial(jax.jit, static_argnames=("B", "Lb"))
def _slice_chains(head, cq, ct, B: int, Lb: int):
    """Kept-rows x real-length view of an overlap dispatch result (rows
    are compacted kept-first on device; see collect_chains)."""
    return head[:B], cq[:B, :Lb], ct[:B, :Lb]


def _count_rows(membership, buckets):
    """Retrieval: hit counts as a gather+sum over the membership matrix.
    ``buckets [M, R]`` (pad -1) -> ``[M, C]`` int32.

    The gathered ``[M, R, C]`` intermediate is bounded to ~256 MB by
    chunking the batch axis through ``lax.map`` — at genome scale
    (chr20: C ~6.5k chunks) the unchunked form would materialize
    multi-GB of HBM per dispatch."""
    C = membership.shape[1]
    M, R = buckets.shape

    def counts(b):
        live = b >= 0
        rows = jnp.take(membership,
                        jnp.clip(b, 0, membership.shape[0] - 1),
                        axis=0)  # [m,R,C]
        rows = jnp.where(live[:, :, None], rows, 0)
        # dtype= makes the reduce accumulate int32 from the int8 rows
        # directly — .astype(int32) first materialized a 4x-bytes copy
        # of the gathered block (C is 100s-1000s at genome scale)
        return jnp.sum(rows, axis=1, dtype=jnp.int32)

    if M * R * C <= (1 << 28):
        return counts(buckets)
    mc = max(1, (1 << 28) // max(1, R * C))
    # floor of 8 keeps the scan length sane without re-inflating the
    # per-step gather beyond ~2x the target at extreme C
    mc = max(8, (mc // 8) * 8)
    MP = ((M + mc - 1) // mc) * mc
    b = buckets if MP == M else jnp.concatenate(
        [buckets, jnp.full((MP - M, R), -1, buckets.dtype)])
    out = jax.lax.map(counts, b.reshape(MP // mc, mc, R))
    return out.reshape(MP, C)[:M]


def _count_rows_pair(membership, rb, db):
    """Run + distinct retrieval counts from ONE membership gather.

    On the device-derived bucket path the distinct buckets ``db`` are the
    run buckets ``rb`` with duplicate slots masked to -1 (same slot
    layout, see ``_derive_buckets``), so a single gather of the rb rows
    serves both sums — halving what is the dominant HBM traffic of a
    genome-scale dispatch (the gathered block is [M, R, C])."""
    C = membership.shape[1]
    M, R = rb.shape

    def counts2(args):
        b, first = args
        live = b >= 0
        rows = jnp.take(membership,
                        jnp.clip(b, 0, membership.shape[0] - 1),
                        axis=0)  # [m,R,C]
        rows = jnp.where(live[:, :, None], rows, 0)
        c = jnp.sum(rows, axis=1, dtype=jnp.int32)
        d = jnp.sum(jnp.where(first[:, :, None], rows, 0), axis=1,
                    dtype=jnp.int32)
        return c, d

    first = db >= 0
    if M * R * C <= (1 << 28):
        return counts2((rb, first))
    mc = max(1, (1 << 28) // max(1, R * C))
    mc = max(8, (mc // 8) * 8)
    MP = ((M + mc - 1) // mc) * mc
    if MP != M:
        rb = jnp.concatenate([rb, jnp.full((MP - M, R), -1, rb.dtype)])
        first = jnp.concatenate(
            [first, jnp.zeros((MP - M, R), bool)])
    c, d = jax.lax.map(counts2, (rb.reshape(MP // mc, mc, R),
                                 first.reshape(MP // mc, mc, R)))
    return c.reshape(MP, C)[:M], d.reshape(MP, C)[:M]


@functools.partial(jax.jit, static_argnames=("H", "hashed"))
def _derive_membership(t_seeds, H: int, hashed: bool):
    """Resident [H, CP] int8 membership built ON DEVICE from the chunk
    seed tables: the same seed-id -> hash-bucket mapping as the host
    ``match.hash_ids`` (identity when the seed space fits, else Knuth
    multiplicative mod a power-of-two H — the uint32 wrap-around product
    equals numpy's 64-bit (id * knuth) % H).  Duplicate seeds within a
    chunk scatter 1 repeatedly — identical to the host's unique() +
    assign.  Valid only when no chunk's seed list was truncated to the
    table width (the caller's guard)."""
    CP, nt = t_seeds.shape
    live = t_seeds >= 0
    if hashed:
        h = ((t_seeds.astype(jnp.uint32) * jnp.uint32(2654435761))
             & jnp.uint32(H - 1)).astype(jnp.int32)
    else:
        h = t_seeds
    rows = jnp.where(live, h, H)           # dead slots -> scratch row
    cols = jnp.broadcast_to(jnp.arange(CP, dtype=jnp.int32)[:, None],
                            (CP, nt))
    mem = jnp.zeros((H + 1, CP), jnp.int8)
    # clip: PROVABLY-bounded scatter indices (dead slots land in the
    # scratch row H, sliced off below)
    mem = mem.at[jnp.clip(rows.reshape(-1), 0, H),
                 jnp.clip(cols.reshape(-1), 0, CP - 1)].set(1)
    return mem[:H]


@functools.partial(jax.jit, static_argnames=("C",))
def _unpack_membership(packed, C: int):
    """[H, ceil(C/8)] uint8 bit-rows -> resident [H, C] int8 0/1."""
    H, CB = packed.shape
    bits = jnp.right_shift(packed[:, :, None],
                           jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
    return bits.reshape(H, CB * 8)[:, :C].astype(jnp.int8)


@jax.jit
def _to_i32(a):
    return a.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("nt",))
def _split_tables(both, nt: int):
    """Split the combined [CP, 2*nt] int16 chunk-table transfer back
    into resident int32 (t_seeds, t_pos)."""
    return both[:, :nt].astype(jnp.int32), both[:, nt:].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("w",))
def _split_query(comb, w: int):
    """Split a combined per-dispatch query transfer at column ``w``."""
    return comb[:, :w], comb[:, w:]


def _derive_buckets(q_seeds, usable, H: int, hashed: bool):
    """On-device twin of the host run/distinct bucket derivation
    (``pack_query_windows``): run-collapse over usable seeds
    (ref Matches semantics, seeds/seeds.go:335-353), hash to buckets,
    mark first occurrences.  Exact whenever every extracted seed of a
    row fits the shipped ``q_seeds`` width (the caller's guard) — slot
    layout differs from the host's compacted arrays, but retrieval only
    sums membership rows per live slot, so layout is irrelevant.

    Shipping seeds only (and deriving buckets here) halves the
    host->device transfer of every map dispatch."""
    M, nq = q_seeds.shape
    UL = usable.shape[0]
    live = q_seeds >= 0
    # every index clipped to a PROVEN bound — see _derive_membership
    us = live & (jnp.take(usable, jnp.clip(q_seeds, 0, UL - 1)) > 0)
    idx = jnp.where(us, jnp.arange(nq, dtype=jnp.int32)[None, :], -1)
    # running max as log-depth shift-maxes: elementwise ops only
    pa = idx
    d = 1
    while d < nq:
        pa = jnp.maximum(pa, jnp.pad(pa, ((0, 0), (d, 0)),
                                     constant_values=-1)[:, :nq])
        d *= 2
    prev = jnp.concatenate(
        [jnp.full((M, 1), -1, pa.dtype), pa[:, :-1]], axis=1)
    pv = jnp.take_along_axis(q_seeds, jnp.clip(prev, 0, nq - 1), axis=1)
    pv = jnp.where(prev >= 0, pv, -2)
    run_start = us & (pv != q_seeds)
    if hashed:
        # H is always a power of two (choose_hash_size), so the uint32
        # wrap-around product reproduces numpy's 64-bit (id * knuth) % H
        b = ((q_seeds.astype(jnp.uint32) * jnp.uint32(2654435761))
             & jnp.uint32(H - 1)).astype(jnp.int32)
    else:
        b = q_seeds
    rb = jnp.where(run_start, b, -1)
    eq = (rb[:, :, None] == rb[:, None, :]) \
        & (rb[:, :, None] >= 0) & (rb[:, None, :] >= 0)
    earlier = jnp.tril(jnp.ones((nq, nq), bool), -1)[None]
    dup = jnp.any(eq & earlier, axis=2)
    db = jnp.where(run_start & ~dup, rb, -1)
    return rb, db


def make_sharded_counts(mesh):
    """Seed-axis-sharded retrieval (SURVEY §2.3's genome-scale answer):
    the membership matrix rows shard over the mesh's ``seed`` axis (each
    device holds H/n_seed hash buckets), every device counts the query
    buckets that fall in its row range, and a psum over ``seed`` merges
    the partial counts (an all-reduce between the cards).  Queries
    replicate over ``seed`` and shard over ``data``."""
    import functools as ft
    from jax.sharding import PartitionSpec as P

    @ft.partial(jax.shard_map, mesh=mesh,
                in_specs=(P("seed", None), P("data", None)),
                out_specs=P("data", None))
    def counts(m_local, buckets):
        H_loc = m_local.shape[0]
        lo = jax.lax.axis_index("seed") * H_loc
        rel = buckets - lo
        live = (buckets >= 0) & (rel >= 0) & (rel < H_loc)
        rows = jnp.take(m_local, jnp.clip(rel, 0, H_loc - 1), axis=0)
        rows = jnp.where(live[:, :, None], rows, 0)
        part = jnp.sum(rows, axis=1, dtype=jnp.int32)
        return jax.lax.psum(part, "seed")

    return jax.jit(counts)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "top_k",
                                              "chunk", "small", "lean"))
def _fused_map(q_seeds, q_pos, q_rb, q_db, min_count, base_min, q_len,
               membership, t_seeds, t_pos,
               k: int, pair_budget: int, top_k: int = 4,
               chunk: int = 1024, small: bool = False,
               lean: bool = False):
    """Retrieval + gate + chain + summary in one dispatch.

    Returns ``(head [budget, 3] int32, summary [budget, W] int16,
    n_ok)``: per selected pair (query idx, chunk idx, distinct
    shared-seed count) plus the packed chain summary; ``n_ok`` is the
    true passing-pair count for overflow detection.
    """
    counts = _count_rows(membership, q_rb)
    dcounts = _count_rows(membership, q_db)
    return _map_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                            base_min, q_len, t_seeds, t_pos, k=k,
                            pair_budget=pair_budget, top_k=top_k,
                            chunk=chunk, small=small, lean=lean)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "top_k",
                                              "chunk", "small", "lean",
                                              "combine"))
def _map_from_counts(counts, dcounts, q_seeds, q_pos, min_count, base_min,
                     q_len, t_seeds, t_pos,
                     k: int, pair_budget: int, top_k: int = 4,
                     chunk: int = 1024, small: bool = False,
                     lean: bool = False, combine: bool = False):
    """Gate + chain + summary from precomputed retrieval counts (the
    entry point for the seed-sharded retrieval path)."""
    M = q_seeds.shape[0]
    C = counts.shape[1]
    ok = (counts >= min_count[:, None]) & (dcounts >= base_min[:, None]) \
        & (min_count[:, None] > 0)

    # compact passing pairs (query-major, chunk-ascending — the order the
    # reference walks candidates) to the fixed budget
    ok_flat = ok.reshape(-1)
    # scatter-free nonzero (see chain.compact_indices)
    sel, n_ok = compact_indices(ok_flat, pair_budget)
    live = sel < M * C
    cl = jnp.clip(sel, 0, M * C - 1)
    mi = jnp.where(live, cl // C, 0)
    ci = jnp.where(live, cl % C, 0)
    dc = dcounts[jnp.clip(mi, 0, M - 1), jnp.clip(ci, 0, C - 1)]
    return _chain_pack_tail(mi, ci, dc, live, n_ok, q_seeds, q_pos,
                            base_min, q_len, t_seeds, t_pos, k=k,
                            pair_budget=pair_budget, top_k=top_k,
                            chunk=chunk, small=small, lean=lean,
                            combine=combine)


def _chain_pack_tail(mi, ci, dc, live, n_ok, q_seeds, q_pos, base_min,
                     q_len, t_seeds, t_pos, *, k: int, pair_budget: int,
                     top_k: int, chunk: int, small: bool, lean: bool,
                     combine: bool):
    """Chain DP + summary packing over compacted (query, chunk) pairs —
    the shared tail of the flat and binned gates."""
    M = q_seeds.shape[0]
    C = t_seeds.shape[0]
    mi_b = jnp.clip(mi, 0, M - 1)
    mm = jnp.where(live, jnp.take(base_min, mi_b), jnp.int32(1 << 20))

    # chain DP on the selected pairs; anchors built in fixed chunks to
    # bound the [chunk, NQ, NT] equality tensor.  All row selections are
    # clipped takes (provably bounded — see _derive_membership).
    def build(args):
        mi_c, ci_c = args
        mi_c = jnp.clip(mi_c, 0, M - 1)
        ci_c = jnp.clip(ci_c, 0, C - 1)
        return make_anchors_topk(jnp.take(q_seeds, mi_c, axis=0),
                                 jnp.take(q_pos, mi_c, axis=0),
                                 jnp.take(t_seeds, ci_c,
                                          axis=0).astype(jnp.int32),
                                 jnp.take(t_pos, ci_c,
                                          axis=0).astype(jnp.int32),
                                 per_seed=2)

    B = pair_budget
    CH = min(chunk, B)
    NCH = (B + CH - 1) // CH
    pad = NCH * CH - B
    mi_p = jnp.concatenate([mi, jnp.zeros(pad, mi.dtype)]) if pad else mi
    ci_p = jnp.concatenate([ci, jnp.zeros(pad, ci.dtype)]) if pad else ci
    anchors = jax.lax.map(build, (mi_p.reshape(NCH, CH),
                                  ci_p.reshape(NCH, CH)))
    anchors = {key: v.reshape(NCH * CH, *v.shape[2:])[:B]
               for key, v in anchors.items()}
    out = dp_from_anchors(anchors, k, small=small)
    packed = summarize_dp(out, mm, jnp.take(q_len, mi_b), k, top_k,
                          lean=lean)
    head = jnp.concatenate([
        jnp.where(live, mi, -1)[:, None], ci[:, None], dc[:, None]], axis=1)
    # summaries fit int16 for <=10 kb chunks (positions/coverage <= 11k;
    # empty-row sentinels clamp) - halves the dominant fetch
    packed16 = jnp.clip(packed, -32768, 32767).astype(jnp.int16)
    if combine:
        # ONE [budget, 3 + W] int16 output (head columns fit int16 when
        # the caller sets combine: M, C < 32768 and dc <= nq): a single
        # tensor lets the dispatcher start ONE copy_to_host_async per
        # batch, so the fetch streams under later packs/kernels instead
        # of serializing at collect time
        head16 = jnp.clip(head, -32768, 32767).astype(jnp.int16)
        return jnp.concatenate([head16, packed16], axis=1), n_ok
    return head, packed16, n_ok


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "top_k",
                                              "chunk", "small", "nq",
                                              "lean", "combine"))
def _fused_map_c(a_c, q_seeds, membership, t_seeds, t_pos,
                 k: int, pair_budget: int, top_k: int = 4,
                 chunk: int = 1024, small: bool = False, nq: int = 64,
                 lean: bool = False, combine: bool = False):
    """``_fused_map`` with the per-query feature arrays concatenated into
    ONE host->device transfer: ``a_c [M, 3*nq + 3]`` carries q_pos | q_rb
    | q_db | (min_count, base_min, q_len), int16 when every field fits
    (hash space <= 32768 and window <= 32767 bases) else int32.  One
    combined transfer replaces six."""
    a = a_c.astype(jnp.int32)
    q_pos = a[:, :nq]
    q_rb = a[:, nq : 2 * nq]
    q_db = a[:, 2 * nq : 3 * nq]
    min_count = a[:, 3 * nq]
    base_min = a[:, 3 * nq + 1]
    q_len = a[:, 3 * nq + 2]
    counts = _count_rows(membership, q_rb)
    dcounts = _count_rows(membership, q_db)
    return _map_from_counts(counts, dcounts, q_seeds.astype(jnp.int32),
                            q_pos, min_count, base_min, q_len,
                            t_seeds, t_pos, k=k, pair_budget=pair_budget,
                            top_k=top_k, chunk=chunk, small=small,
                            lean=lean, combine=combine)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "top_k",
                                              "chunk", "small", "nq",
                                              "hashed", "lean", "combine"))
def _fused_map_d(a_c, q_seeds, usable, membership, t_seeds, t_pos,
                 k: int, pair_budget: int, top_k: int = 4,
                 chunk: int = 1024, small: bool = False, nq: int = 64,
                 hashed: bool = False, lean: bool = False,
                 combine: bool = False):
    """``_fused_map_c`` with the run/distinct bucket arrays DERIVED on
    device from the seed ids (``_derive_buckets``) instead of shipped:
    ``a_c [M, nq + 3]`` carries only q_pos | (min_count, base_min,
    q_len) — the dominant map upload drops by half."""
    a = a_c.astype(jnp.int32)
    q_pos = a[:, :nq]
    min_count = a[:, nq]
    base_min = a[:, nq + 1]
    q_len = a[:, nq + 2]
    qs = q_seeds.astype(jnp.int32)
    q_rb, q_db = _derive_buckets(qs, usable, membership.shape[0], hashed)
    counts, dcounts = _count_rows_pair(membership, q_rb, q_db)
    return _map_from_counts(counts, dcounts, qs, q_pos, min_count,
                            base_min, q_len, t_seeds, t_pos, k=k,
                            pair_budget=pair_budget, top_k=top_k,
                            chunk=chunk, small=small, lean=lean,
                            combine=combine)


@functools.partial(jax.jit, static_argnames=("NB", "CB"))
def _derive_bin_mem(membership, NB: int, CB: int):
    """Resident level-1 bin membership ``[H, NB]``: bin b's row is the OR
    of its CB chunks' membership columns.  Bins are contiguous ranges of
    the (genome-position-permuted) chunk axis, so for any chunk c in bin
    b and any query bucket set, bin counts >= chunk counts — gating bins
    at the chunk thresholds is recall-sound."""
    H = membership.shape[0]
    return (jnp.sum(membership.reshape(H, NB, CB), axis=2) > 0) \
        .astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("H1", "NB", "CB", "hashed1"))
def _derive_bin_mem_direct(t_seeds, H1: int, NB: int, CB: int,
                           hashed1: bool):
    """Level-1 bin membership in its OWN (larger) hash space, scattered
    straight from the resident chunk seed tables.

    The level-2 hash space H is capped for membership-matrix memory
    ([H, C] int8); at genome scale a bin of CB chunks then occupies a
    large fraction of those H buckets and pure collision noise passes
    the bin gate everywhere (measured: 64 Mb / 865k seeds / H=2^17 /
    CB=128 -> ~29% bin occupancy, every query escalating BB).  The bin
    matrix is only [H1, NB], so H1 can afford the full seed space (or a
    2^20 cap) — occupancy drops ~8x and the gate regains selectivity.
    True matches always land in both spaces, so recall is unaffected;
    only H-collision-noise candidates (which the chain DP rejects) can
    differ from the flat gate."""
    CP, nt = t_seeds.shape
    live = t_seeds >= 0
    if hashed1:
        h = ((t_seeds.astype(jnp.uint32) * jnp.uint32(2654435761))
             & jnp.uint32(H1 - 1)).astype(jnp.int32)
    else:
        h = t_seeds
    rows = jnp.where(live, h, H1)
    bins = jnp.broadcast_to(
        (jnp.arange(CP, dtype=jnp.int32) // CB)[:, None], (CP, nt))
    mem = jnp.zeros((H1 + 1, NB), jnp.int8)
    mem = mem.at[jnp.clip(rows.reshape(-1), 0, H1),
                 jnp.clip(bins.reshape(-1), 0, NB - 1)].set(1)
    return mem[:H1]


def _binned_counts_pair(flat, rb, first, topbin, NB: int, CB: int):
    """Level-2 fine counts within each query's selected bins, from ONE
    membership gather: ``flat [H*NB, CB]`` (membership reshaped),
    ``rb [M, R]`` run buckets (pad -1), ``first [M, R]`` first-occurrence
    mask, ``topbin [M, BB]`` selected bin ids.  Returns (counts,
    dcounts) ``[M, BB, CB]`` int32.  The gathered ``[M, R, BB, CB]``
    block is bounded to ~256 MB by chunking the batch axis."""
    M, R = rb.shape
    BB = topbin.shape[1]

    HN = flat.shape[0]

    def counts2(args):
        b, fr, tb = args
        m = b.shape[0]
        live = b >= 0
        idx = jnp.clip(b, 0)[:, :, None] * NB + tb[:, None, :]  # [m,R,BB]
        idx = jnp.clip(idx, 0, HN - 1)      # proven-bounded gather
        rows = jnp.take(flat, idx.reshape(m, R * BB),
                        axis=0).reshape(m, R, BB, CB)
        rows = jnp.where(live[:, :, None, None], rows, 0)
        c = jnp.sum(rows, axis=1, dtype=jnp.int32)
        d = jnp.sum(jnp.where(fr[:, :, None, None], rows, 0), axis=1,
                    dtype=jnp.int32)
        return c, d

    if M * R * BB * CB <= (1 << 28):
        return counts2((rb, first, topbin))
    mc = max(1, (1 << 28) // max(1, R * BB * CB))
    mc = max(8, (mc // 8) * 8)
    MP = ((M + mc - 1) // mc) * mc
    if MP != M:
        rb = jnp.concatenate([rb, jnp.full((MP - M, R), -1, rb.dtype)])
        first = jnp.concatenate([first, jnp.zeros((MP - M, R), bool)])
        topbin = jnp.concatenate(
            [topbin, jnp.zeros((MP - M, BB), topbin.dtype)])
    c, d = jax.lax.map(counts2, (rb.reshape(MP // mc, mc, R),
                                 first.reshape(MP // mc, mc, R),
                                 topbin.reshape(MP // mc, mc, BB)))
    return (c.reshape(MP, BB, CB)[:M], d.reshape(MP, BB, CB)[:M])


def _binned_gate(membership, bin_mem, q_rb, q_db, rb1, db1, min_count,
                 base_min, *, NB: int, CB: int, BB: int, C: int,
                 pair_budget: int, aligned_db: bool):
    """Two-level retrieval gate (the genome-scale answer to the dense
    [H, C] membership walk): level 1 gates genome bins, level 2 counts
    chunks only inside each query's top-``BB`` passing bins.

    Returns ``(mi, ci, dc, live, n_ok, n_bin)`` — compacted passing
    (query, chunk) pairs exactly as the flat gate produces, plus
    ``n_bin`` = the max per-query passing-bin count for BB-escalation
    (when n_bin > BB the selection may have dropped chunks; the caller
    re-dispatches with a doubled BB, so results remain exact).

    ``rb1``/``db1`` are the query buckets in the BIN matrix's hash space
    (H1 — usually wider than the membership's H; identical arrays when
    the spaces coincide).  ``aligned_db`` states that ``q_db``/``db1``
    share the run arrays' slot layout (duplicates masked to -1, the
    `_derive_buckets` form), letting one gather serve both run and
    distinct sums at both levels."""
    M = q_rb.shape[0]
    H = membership.shape[0]
    if aligned_db:
        c1, d1 = _count_rows_pair(bin_mem, rb1, db1)
    else:
        c1 = _count_rows(bin_mem, rb1)
        d1 = _count_rows(bin_mem, db1)
    okb = (c1 >= min_count[:, None]) & (d1 >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    n_bin = jnp.max(jnp.sum(okb, axis=1))
    # top-BB passing bins by run count; top_k indices are distinct so no
    # chunk is counted twice
    key = jnp.where(okb, c1, -1)
    _, topbin = jax.lax.top_k(key, BB)
    topbin = jnp.clip(topbin.astype(jnp.int32), 0, okb.shape[1] - 1)
    sel_live = jnp.take_along_axis(okb, topbin, axis=1)
    flat = membership.reshape(H * NB, CB)
    if aligned_db:
        c2, d2 = _binned_counts_pair(flat, q_rb, q_db >= 0, topbin,
                                     NB, CB)
    else:
        c2, _ = _binned_counts_pair(flat, q_rb,
                                    jnp.zeros_like(q_rb, bool),
                                    topbin, NB, CB)
        d2, _ = _binned_counts_pair(flat, q_db,
                                    jnp.zeros_like(q_db, bool), topbin,
                                    NB, CB)
    ci_all = topbin[:, :, None] * CB \
        + jnp.arange(CB, dtype=jnp.int32)[None, None, :]   # [M, BB, CB]
    okf = (c2 >= min_count[:, None, None]) \
        & (d2 >= base_min[:, None, None]) \
        & (min_count[:, None, None] > 0) \
        & sel_live[:, :, None] & (ci_all < C)
    sel, n_ok = compact_indices(okf.reshape(-1), pair_budget)
    SZ = M * BB * CB
    live = sel < SZ
    cl = jnp.clip(sel, 0, SZ - 1)
    mi = jnp.where(live, cl // (BB * CB), 0)
    rem = cl % (BB * CB)
    s_idx = rem // CB
    w = rem % CB
    mi_b = jnp.clip(mi, 0, M - 1)
    s_b = jnp.clip(s_idx, 0, BB - 1)
    w_b = jnp.clip(w, 0, CB - 1)
    ci = jnp.where(live, topbin[mi_b, s_b] * CB + w, 0)
    dc = d2[mi_b, s_b, w_b]
    return mi, ci, dc, live, n_ok, n_bin


@functools.partial(jax.jit, static_argnames=(
    "k", "pair_budget", "top_k", "chunk", "small", "nq", "hashed",
    "hashed1", "lean", "combine", "NB", "CB", "BB", "C"))
def _fused_map_bd(a_c, q_seeds, usable, membership, bin_mem, t_seeds,
                  t_pos, k: int, pair_budget: int, top_k: int = 4,
                  chunk: int = 1024, small: bool = False, nq: int = 64,
                  hashed: bool = False, hashed1: bool = False,
                  lean: bool = False, combine: bool = False,
                  NB: int = 64, CB: int = 8, BB: int = 8, C: int = 0):
    """``_fused_map_d`` with the two-level binned gate.  Returns the
    usual result tuple plus ``n_bin`` (max passing bins per query) for
    BB-escalation."""
    a = a_c.astype(jnp.int32)
    q_pos = a[:, :nq]
    min_count = a[:, nq]
    base_min = a[:, nq + 1]
    q_len = a[:, nq + 2]
    qs = q_seeds.astype(jnp.int32)
    H1 = bin_mem.shape[0]
    q_rb, q_db = _derive_buckets(qs, usable, membership.shape[0], hashed)
    if H1 == membership.shape[0] and hashed1 == hashed:
        rb1, db1 = q_rb, q_db
    else:
        rb1, db1 = _derive_buckets(qs, usable, H1, hashed1)
    mi, ci, dc, live, n_ok, n_bin = _binned_gate(
        membership, bin_mem, q_rb, q_db, rb1, db1, min_count, base_min,
        NB=NB, CB=CB, BB=BB, C=C, pair_budget=pair_budget,
        aligned_db=True)
    out = _chain_pack_tail(mi, ci, dc, live, n_ok, qs, q_pos, base_min,
                           q_len, t_seeds, t_pos, k=k,
                           pair_budget=pair_budget, top_k=top_k,
                           chunk=chunk, small=small, lean=lean,
                           combine=combine)
    return out + (n_bin,)


@functools.partial(jax.jit, static_argnames=(
    "k", "pair_budget", "top_k", "chunk", "small", "nq", "lean",
    "combine", "NB", "CB", "BB", "C"))
def _fused_map_bc(a_c, q_seeds, membership, bin_mem, t_seeds, t_pos,
                  k: int, pair_budget: int, top_k: int = 4,
                  chunk: int = 1024, small: bool = False, nq: int = 64,
                  lean: bool = False, combine: bool = False,
                  NB: int = 64, CB: int = 8, BB: int = 8, C: int = 0):
    """``_fused_map_c`` (shipped run/distinct buckets — the fallback for
    repeat-heavy batches whose seeds overflow the derive width) with the
    two-level binned gate.  The shipped buckets live in the membership's
    hash space, so this path uses the H-space bin matrix (noisier level-1
    gate than the derive path's H1 matrix, but correct)."""
    a = a_c.astype(jnp.int32)
    q_pos = a[:, :nq]
    q_rb = a[:, nq : 2 * nq]
    q_db = a[:, 2 * nq : 3 * nq]
    min_count = a[:, 3 * nq]
    base_min = a[:, 3 * nq + 1]
    q_len = a[:, 3 * nq + 2]
    mi, ci, dc, live, n_ok, n_bin = _binned_gate(
        membership, bin_mem, q_rb, q_db, q_rb, q_db, min_count,
        base_min, NB=NB, CB=CB, BB=BB, C=C, pair_budget=pair_budget,
        aligned_db=False)
    out = _chain_pack_tail(mi, ci, dc, live, n_ok,
                           q_seeds.astype(jnp.int32), q_pos, base_min,
                           q_len, t_seeds, t_pos, k=k,
                           pair_budget=pair_budget, top_k=top_k,
                           chunk=chunk, small=small, lean=lean,
                           combine=combine)
    return out + (n_bin,)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "variant",
                                              "chunk", "chain_len", "small"))
def _fused_overlap(q_seeds, q_pos, q_rb, q_db, min_count, base_min,
                   membership, t_seeds, t_pos,
                   k: int, pair_budget: int, variant: str = "aligner",
                   chunk: int = 512, chain_len: int = 128,
                   small: bool = False):
    """Retrieval + gate + chain DP + on-device best-chain extraction.

    The overlapper needs the full anchor chain of the best alignment per
    passing (query, chunk) pair (ref matchWorker,
    overlap/overlap.go:346-387; PairwiseAlignments
    seeds/alignment.go:426).  The backpointer walk runs on device as a
    ``chain_len``-step scan, so the fetch is one
    ``[budget, 4 + 2*chain_len] int16`` array instead of the full
    [pairs, anchors] f/bp/qi/tj grids (which at production sizes cost
    tens of MB per batch).

    Row layout: (query idx, chunk idx, best chain length, distinct shared
    seeds, chain query-seed indices end->start, chain target-seed
    indices end->start); -1 pads.  Returns (rows, passing-pair count).
    """
    counts = _count_rows(membership, q_rb)
    dcounts = _count_rows(membership, q_db)
    return _overlap_from_counts(counts, dcounts, q_seeds, q_pos,
                                min_count, base_min, t_seeds, t_pos,
                                k=k, pair_budget=pair_budget,
                                variant=variant, chunk=chunk,
                                chain_len=chain_len, small=small)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "variant",
                                              "chunk", "chain_len", "small",
                                              "nq", "hashed"))
def _fused_overlap_d(a_c, q_seeds, usable, membership, t_seeds, t_pos,
                     k: int, pair_budget: int, variant: str = "aligner",
                     chunk: int = 512, chain_len: int = 128,
                     small: bool = False, nq: int = 64,
                     hashed: bool = False):
    """``_fused_overlap`` with buckets derived on device
    (``_derive_buckets``) and the per-query features combined into ONE
    transfer: ``a_c [M, nq + 2]`` = q_pos | (min_count, base_min)."""
    a = a_c.astype(jnp.int32)
    q_pos = a[:, :nq]
    min_count = a[:, nq]
    base_min = a[:, nq + 1]
    qs = q_seeds.astype(jnp.int32)
    q_rb, q_db = _derive_buckets(qs, usable, membership.shape[0], hashed)
    counts, dcounts = _count_rows_pair(membership, q_rb, q_db)
    return _overlap_from_counts(counts, dcounts, qs, q_pos, min_count,
                                base_min, t_seeds, t_pos, k=k,
                                pair_budget=pair_budget, variant=variant,
                                chunk=chunk, chain_len=chain_len,
                                small=small)


@functools.partial(jax.jit, static_argnames=("k", "pair_budget", "variant",
                                              "chunk", "chain_len", "small"))
def _overlap_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                         base_min, t_seeds, t_pos,
                         k: int, pair_budget: int, variant: str = "aligner",
                         chunk: int = 512, chain_len: int = 128,
                         small: bool = False):
    """Gate + chain + best-chain walk from precomputed retrieval counts
    (the seed-sharded retrieval entry)."""
    M = q_seeds.shape[0]
    C = counts.shape[1]
    ok = (counts >= min_count[:, None]) & (dcounts >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    ok_flat = ok.reshape(-1)
    # scatter-free nonzero (see chain.compact_indices)
    sel, n_ok = compact_indices(ok_flat, pair_budget)
    live = sel < M * C
    cl = jnp.clip(sel, 0, M * C - 1)
    mi = jnp.where(live, cl // C, 0)
    ci = jnp.where(live, cl % C, 0)

    # clipped takes: provably-bounded gathers (see _derive_membership)
    def build(args):
        mi_c, ci_c = args
        mi_c = jnp.clip(mi_c, 0, M - 1)
        ci_c = jnp.clip(ci_c, 0, C - 1)
        return make_anchors_topk(jnp.take(q_seeds, mi_c, axis=0),
                                 jnp.take(q_pos, mi_c, axis=0),
                                 jnp.take(t_seeds, ci_c,
                                          axis=0).astype(jnp.int32),
                                 jnp.take(t_pos, ci_c,
                                          axis=0).astype(jnp.int32),
                                 per_seed=2)

    B = pair_budget
    CH = min(chunk, B)
    NCH = (B + CH - 1) // CH
    pad = NCH * CH - B
    mi_p = jnp.concatenate([mi, jnp.zeros(pad, mi.dtype)]) if pad else mi
    ci_p = jnp.concatenate([ci, jnp.zeros(pad, ci.dtype)]) if pad else ci
    anchors = jax.lax.map(build, (mi_p.reshape(NCH, CH),
                                  ci_p.reshape(NCH, CH)))
    anchors = {key: v.reshape(NCH * CH, *v.shape[2:])[:B]
               for key, v in anchors.items()}
    # forward-only lean DP: the walk below consumes only f/bp/qi/tj
    out = dp_forward_lean(anchors, k, variant, small=small)
    f, bp = out["f"], out["bp"]
    qi_a, tj_a = out["qi"], out["tj"]
    A = f.shape[1]
    best_len = jnp.where(live, jnp.max(f, axis=1), 0)
    best_a = jnp.argmax(f, axis=1)
    iota_a = jnp.arange(A, dtype=jnp.int32)[None, :]

    def walk(a, _):
        # gather-free backpointer step: the per-row anchor reads
        # (qi/tj/bp at the current anchor) go through a one-hot
        # contraction — per-element gathers under this [B]-wide scan
        # lowered to XLA gathers that dominated the whole fused kernel
        on = a >= 0
        oh = iota_a == a[:, None]                       # [B, A]
        pick = lambda arr: jnp.sum(jnp.where(oh, arr, 0), axis=1)
        q = jnp.where(on, pick(qi_a), -1)
        t = jnp.where(on, pick(tj_a), -1)
        nxt = jnp.where(on, pick(bp), -1)
        return nxt, (q, t)

    start = jnp.where(best_len > 0, best_a.astype(jnp.int32), -1)
    _, (cq, ct) = jax.lax.scan(walk, start, None, length=chain_len,
                               unroll=8)
    cq = cq.T.astype(jnp.int8)       # [B, L], end -> start; qi < nq <= 128
    ct = ct.T.astype(jnp.int16)
    head = jnp.stack([jnp.where(live, mi, -1), ci, best_len,
                      dcounts[jnp.clip(mi, 0, M - 1),
                              jnp.clip(ci, 0, C - 1)]], axis=1)
    # device-side pre-filter: drop rows whose best chain is already
    # below the per-query static minimum (the host's first-pass filter;
    # its adaptive raise only drops MORE).  ~40% of gate-passing pairs
    # fail it, and they were the largest slice of the round fetch.
    bm = jnp.take(base_min, jnp.clip(mi, 0, M - 1))
    keep = live & (best_len >= jnp.maximum(1, bm))
    sel2, n_keep = compact_indices(keep, B)
    s2 = jnp.clip(sel2, 0, B - 1)
    dead = sel2 >= B
    head = jnp.where(dead[:, None], -1, jnp.take(head, s2, axis=0))
    cq = jnp.take(cq, s2, axis=0)
    ct = jnp.take(ct, s2, axis=0)
    keep_len = jnp.where(keep, jnp.minimum(best_len, chain_len), 0)
    # max KEPT chain length: lets the collector slice the chains fetch
    # to [kept rows, real length] (the full [budget, 2L] array is tens
    # of MB per round)
    mx = jnp.max(keep_len)
    return head, cq, ct, n_ok, n_keep, mx


class MapEngine:
    """Resident device index + one-dispatch query pipeline for the mapper
    (and, with ``variant='aligner'`` semantics handled by callers, any
    chunk-index consumer)."""

    # hint key -> (rows, length) sliced-chain-fetch sizes observed at the
    # last collect, with growth headroom — engines are rebuilt every
    # overlap round, so the hint lives on the class.  The key includes
    # k / hash size / a chunk-count bucket so a hint can't leak across
    # unrelated indexes sharing a (budget, chain_len) shape (a stale
    # leak is perf-only — wrong-size speculative fetches — but wasted
    # transfer bytes sit on the critical path).  Used to START the sliced
    # fetch at dispatch time (speculative prefetch); a wrong guess just
    # falls back to the two-phase fetch.
    _chain_hint: dict = {}

    def __init__(self, index, k: int, nq: int = 64, nt: int = 320,
                 mesh=None, hit_fraction: float = 0.25,
                 lean: bool = False, binned: bool = False,
                 h_min: int = 0):
        self.index = index
        self.k = k
        # lean: pack only the mapper-walk summary columns (1 + 7K instead
        # of 5 + 8K) — the fetch of these rows dominates map wall-clock
        self.lean = lean
        self.nq = nq
        self.nt = nt
        self.mesh = mesh
        self.hit_fraction = hit_fraction
        S = index.num_seeds
        # h_min: a job's shape plan pins the hash space across rounds —
        # a smaller final round otherwise picks a smaller H and pays a
        # fresh executable compile (membership shape is part of the key)
        self.H = max(match_ops.choose_hash_size(S), h_min)
        self.num_seeds = S
        C = index.num_sequences
        self.C = C
        # chunk axis snapped to a COARSE grid (<=12% padding): the padded
        # shape — not the exact chunk count — is what the compiled
        # executables and the persistent compile cache key on, so
        # same-scale datasets (and reruns of slightly different genomes)
        # reuse compiles instead of paying tens of seconds of XLA per
        # (H, CP, NB) variation
        _grid = 128 if C <= 2048 else (1024 if C <= 16384 else 4096)
        CP = max(128, ((C + _grid - 1) // _grid) * _grid)
        self.seed_sharded = (mesh is not None
                             and "seed" in mesh.axis_names
                             and mesh.shape["seed"] > 1)
        # two-level binned retrieval (genome scale): chunks permuted into
        # genome-position order so bins are contiguous ranges of the
        # engine chunk axis; level 1 gates [H, NB] bin rows, level 2
        # counts only inside each query's top-BB passing bins.  Worth it
        # only once the flat [M, R, C] gather dominates; below the
        # threshold the flat path is already cheap.
        self._binned = (bool(binned) and C >= _BINNED_MIN_C
                        and not self.seed_sharded)
        self._perm = None
        if self._binned:
            self._CB = _BINNED_CB   # int8 lane width: a narrower minor
            # dim would be padded to 128 on device anyway
            self._NB = CP // self._CB   # snapped CP is a CB multiple
            self._BB = min(8, self._NB)
            # genome-position order (stable: equal offsets keep their
            # original relative — and therefore reference walk — order)
            order = np.argsort(
                np.fromiter((s.offset for s in index.sequences),
                            np.int64, C), kind="stable").astype(np.int32)
            self._perm = order            # engine position -> original ci
            pos_of = np.empty(C, np.int32)
            pos_of[order] = np.arange(C, dtype=np.int32)
            self._pos_of = pos_of
        # host membership build is skipped when it will be derived on
        # device from the chunk tables (no chunk truncated to nt)
        derive_mem = (not self.seed_sharded
                      and max((s.num_seeds for s in index.sequences),
                              default=0) <= nt)
        mem = (None if derive_mem
               else np.zeros((self.H, CP), dtype=np.int8))
        t_seeds = np.full((max(1, CP), nt), -1, np.int32)
        t_pos = np.zeros((max(1, CP), nt), np.int32)
        self.chunk_nseeds = np.zeros(max(1, CP), np.int64)
        # chunk geometry for the vectorized candidate walk
        self.chunk_off = np.zeros(max(1, CP), np.int64)
        self.chunk_inset = np.zeros(max(1, CP), np.int64)
        self.chunk_len = np.zeros(max(1, CP), np.int64)
        for ci_, s in enumerate(index.sequences):
            # device tables live in engine (permuted) order; the chunk
            # geometry arrays stay in ORIGINAL order — collectors
            # translate engine ids back before any host use
            p = int(self._pos_of[ci_]) if self._binned else ci_
            if mem is not None and s.seeds.size:
                mem[match_ops.hash_ids(np.unique(s.seeds), S, self.H),
                    p] = 1
            m = min(s.num_seeds, nt)
            t_seeds[p, :m] = s.seeds[:m]
            t_pos[p, :m] = s.seed_positions(k)[:m]
            self.chunk_nseeds[ci_] = s.num_seeds
            self.chunk_off[ci_] = s.offset
            self.chunk_inset[ci_] = s.inset
            self.chunk_len[ci_] = s.length
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            repl = NamedSharding(mesh, P())
            self._data = NamedSharding(mesh, P("data"))
            self._put = lambda a: jax.device_put(a, repl)
            self._put_data = lambda a: jax.device_put(a, self._data)
        else:
            self._put = jax.device_put
            self._put_data = jax.device_put
        # int16 chain-DP carries are safe when every target position fits
        # under 2^14 (default 10 kb chunks do); the query side is checked
        # per dispatch
        self._t_small = int(t_pos.max(initial=0)) < 16000
        # halve the chunk-table transfers when values fit int16 (cast
        # back on device); when BOTH fit, ship them as one combined
        # array — one device_put instead of two
        if S < (1 << 15) and int(t_pos.max(initial=0)) < (1 << 15):
            both = self._put(np.concatenate(
                [t_seeds.astype(np.int16), t_pos.astype(np.int16)],
                axis=1))
            self.t_seeds, self.t_pos = _split_tables(both, nt)
        elif S < (1 << 15):
            self.t_seeds = _to_i32(self._put(t_seeds.astype(np.int16)))
            self.t_pos = self._put(t_pos)
        elif int(t_pos.max(initial=0)) < (1 << 15):
            self.t_seeds = self._put(t_seeds)
            self.t_pos = _to_i32(self._put(t_pos.astype(np.int16)))
        else:
            self.t_seeds = self._put(t_seeds)
            self.t_pos = self._put(t_pos)
        hashed = S > self.H
        if self.seed_sharded:
            # shard the hash-bucket axis across the seed mesh axis: each
            # device holds H/n_seed rows; retrieval psums partial counts
            from jax.sharding import NamedSharding, PartitionSpec as P
            ns = mesh.shape["seed"]
            HP = ((self.H + ns - 1) // ns) * ns
            if HP != self.H:
                mem = np.concatenate(
                    [mem, np.zeros((HP - self.H, mem.shape[1]), mem.dtype)])
            self.membership = jax.device_put(
                mem, NamedSharding(mesh, P("seed", None)))
            self._sharded_counts = make_sharded_counts(mesh)
        elif derive_mem:
            # every chunk's full seed list is resident in t_seeds, so the
            # membership matrix is DERIVED on device (same unique-seed ->
            # hash-bucket scatter the host build does) — dropping what
            # was the dominant upload of every overlap round entirely
            self.membership = _derive_membership(self.t_seeds, self.H,
                                                 hashed)
            self._sharded_counts = None
        else:
            # truncated chunk(s): ship the exact 0/1 matrix BIT-PACKED
            # (8x less transfer) and unpack once on device
            packed = np.packbits(mem, axis=1)
            self.membership = _unpack_membership(
                self._put(packed), mem.shape[1])
            self._sharded_counts = None
        if self._binned:
            if derive_mem:
                # complete chunk tables: scatter the bin matrix straight
                # from t_seeds into a WIDER hash space H1 (the [H1, NB]
                # matrix is tiny, so H1 can afford the full seed space
                # where the [H, C] membership cannot) — keeps the bin
                # gate selective under heavy H-collision pressure
                self.H1 = match_ops.choose_hash_size(S, max_h=1 << 20)
                self._hashed1 = S > self.H1
                self.bin_mem1 = _derive_bin_mem_direct(
                    self.t_seeds, self.H1, self._NB, self._CB,
                    self._hashed1)
                self.bin_mem2 = (
                    self.bin_mem1
                    if self.H1 == self.H and self._hashed1 == hashed
                    else _derive_bin_mem(self.membership, self._NB,
                                         self._CB))
            else:
                # truncated chunk(s): t_seeds is incomplete, so derive
                # bins from the exact membership matrix (H space)
                self.H1 = self.H
                self._hashed1 = hashed
                self.bin_mem1 = self.bin_mem2 = _derive_bin_mem(
                    self.membership, self._NB, self._CB)
        # "usable" per Matches: seeds present in every chunk carry no info
        if index._seed_counts is None:
            index.index_sequences()
        self.usable = np.asarray(index._seed_counts) < max(1, C)
        # resident mask for on-device bucket derivation (_derive_buckets).
        # Padded to a STABLE length (H, or a 4096 grid when hashed): the
        # raw [num_seeds] shape varies by a few entries between overlap
        # rounds, and every fused kernel that closes over it recompiled
        # per round.  Padding
        # ids never occur in q_seeds, so the extra zeros are inert.
        UL = (self.H if S <= self.H
              else ((S + 4095) // 4096) * 4096)
        up = np.zeros(UL, np.int8)
        up[:S] = self.usable
        self.usable_dev = self._put(up)
        self._hashed = self.num_seeds > self.H

    def _hint_key(self, pair_budget: int, chain_len: int):
        """Prefetch-hint key: identifies the index family (k, hash size,
        chunk-count bucket) as well as the dispatch shape, so hints from
        an unrelated dataset with the same budget can't leak in."""
        return (self.k, self.H, (self.C + 1023) // 1024, pair_budget,
                chain_len)

    # -- batch-vectorized window packing --------------------------------
    _NQS = 192  # seed-scan width: run-collapse is exact for windows with
    # up to this many seeds (1-3 kb map windows carry ~25-75 at the
    # default seed rate); beyond it num_sets undercounts, which only
    # LOWERS min_count — recall-safe, the chain DP is the filter

    def _pack_windows_native(self, windows: List, lens_b: np.ndarray):
        """One-pass native packer (native/seqscan.cpp pack_windows):
        same outputs as the numpy pipeline below, ~10x less host time and
        no [2M, W] intermediates.  None when the toolchain is absent."""
        from .. import native
        if native.load() is None or not len(windows):
            return None
        tabs = getattr(self, "_nat_tables", None)
        if tabs is None:
            tabs = (np.ascontiguousarray(self.index.kmer_table, np.uint8),
                    np.ascontiguousarray(self.index.kmer_map, np.int32),
                    np.ascontiguousarray(self.usable, np.uint8))
            self._nat_tables = tabs
        kt, km, us = tabs
        off = np.zeros(len(windows), np.int64)
        np.cumsum(lens_b[:-1], out=off[1:])
        codes = np.empty(int(lens_b.sum()), np.uint8)
        for i, w in enumerate(windows):
            codes[off[i] : off[i] + lens_b[i]] = w.codes
        return native.pack_windows(codes, off, lens_b, self.k, self.nq,
                                   self._NQS, kt, km, us, self.num_seeds,
                                   self.H)

    def pack_query_windows(self, windows: List) -> tuple:
        """Vectorized twin of ``pack_queries`` for plain sequence windows
        (the mapper's case): one numpy pass over the whole batch replaces
        per-window ``new_seed_sequence`` + ``pack_queries`` Python loops
        (~1.2 s/16k queries, the dominant map cost in round-1 profiles).

        Forward and reverse-complement rows interleave ([2i] = fw of
        window i, [2i+1] = rc), matching the (sq, rq) order the mapper's
        candidate walk expects.  Returns the ``pack_queries`` 6-tuple
        (q_seeds, q_pos, q_rb, q_db, num_sets, q_len) plus ``num_seeds``
        (exact per-row extracted-seed counts for the adaptive min-match
        rules, ref: mapping/mapping.go:497-505)."""
        index = self.index
        k = self.k
        nq = self.nq
        M = len(windows)
        lens_b = np.array([len(w) for w in windows], np.int64)

        native_out = self._pack_windows_native(windows, lens_b)
        if native_out is not None:
            q_seeds, q_pos, q_rb, q_db, num_sets, num_seeds = native_out
            q_len = np.repeat(lens_b, 2).astype(np.int32)
            return (q_seeds, q_pos, q_rb, q_db, num_sets, q_len,
                    num_seeds)

        L = max(int(lens_b.max()) if M else k, k)
        W = L - k + 1
        # interleave forward/RC code rows during the fill (RC is the
        # reversed complement slice, complement of a 2-bit code = ^3) so
        # ONE rolling-kmer pass covers both orientations
        codes = np.zeros((2 * M, L), np.uint8)
        for i, w in enumerate(windows):
            n = lens_b[i]
            codes[2 * i, :n] = w.codes
            codes[2 * i + 1, :n] = w.codes[::-1]
            codes[2 * i + 1, :n] ^= 3
        lens_k = np.maximum(0, lens_b - k + 1)
        km2 = np.zeros((2 * M, W), np.int32)
        for j in range(k):
            km2 <<= 2
            km2 |= codes[:, j : j + W]
        cols = np.arange(W)[None, :]
        lens2 = np.repeat(lens_k, 2)
        q_len = np.repeat(lens_b, 2).astype(np.int32)
        valid = cols < lens2[:, None]
        flag = valid & index.kmer_table[km2]
        num_seeds = flag.sum(1).astype(np.int64)

        # compact the first _NQS flagged positions per row (order kept)
        NQS = self._NQS
        dest = np.cumsum(flag, axis=1, dtype=np.int32) - 1
        rows, colsnz = np.nonzero(flag & (dest < NQS))
        d = dest[rows, colsnz]
        pos_c = np.zeros((2 * M, NQS), np.int32)
        km_c = np.zeros((2 * M, NQS), np.int32)
        pos_c[rows, d] = colsnz
        km_c[rows, d] = km2[rows, colsnz]
        live_c = np.arange(NQS)[None, :] < np.minimum(num_seeds,
                                                      NQS)[:, None]
        seeds_c = np.where(live_c, index.kmer_map[km_c], -1)

        q_seeds = seeds_c[:, :nq].astype(np.int32)
        q_pos = np.where(live_c[:, :nq], pos_c[:, :nq], 0).astype(np.int32)

        # run-collapse over usable seeds (SeedIndex.matches semantics,
        # ref: seeds/seeds.go:335-353): drop unusable, collapse adjacent
        # duplicates; num_sets = exact run count
        us = live_c & self.usable[np.clip(seeds_c, 0, None)] & \
            (seeds_c >= 0)
        slot = np.arange(NQS)[None, :]
        idxs = np.where(us, slot, -1)
        pa = np.maximum.accumulate(idxs, axis=1)
        prev = np.empty_like(pa)
        prev[:, 0] = -1
        prev[:, 1:] = pa[:, :-1]
        pv = np.take_along_axis(seeds_c, np.clip(prev, 0, None), 1)
        pv = np.where(prev >= 0, pv, -2)
        run_start = us & (pv != seeds_c)
        num_sets = run_start.sum(1).astype(np.int32)

        rdest = np.cumsum(run_start, axis=1) - 1
        rrows, rcols = np.nonzero(run_start & (rdest < nq))
        rd = rdest[rrows, rcols]
        run_seeds = np.full((2 * M, nq), -1, np.int64)
        run_seeds[rrows, rd] = seeds_c[rrows, rcols]
        rb_live = run_seeds >= 0
        q_rb = np.where(
            rb_live,
            match_ops.hash_ids(np.clip(run_seeds, 0, None),
                               self.num_seeds, self.H), -1).astype(np.int32)
        # distinct buckets: row-sorted unique (order is irrelevant to the
        # retrieval sum; -1 marks dead slots)
        BIG = 1 << 30
        srt = np.sort(np.where(q_rb >= 0, q_rb, BIG), axis=1)
        first = np.empty_like(srt, dtype=bool)
        first[:, 0] = True
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        q_db = np.where(first & (srt < BIG), srt, -1).astype(np.int32)
        return q_seeds, q_pos, q_rb, q_db, num_sets, q_len, num_seeds

    # -- host-side query packing ---------------------------------------
    def pack_queries_vec(self, seed_queries: List) -> tuple:
        """Vectorized ``pack_queries(need_buckets=False)``: one flat
        numpy pass over the concatenated seed/gap arrays replaces the
        per-query Python loop (~30 us/query — ~20 ms per overlap round,
        measured INSIDE the dispatch critical path).  Exact same outputs;
        falls back to the loop for query sets with >512-seed outliers."""
        M = len(seed_queries)
        nq = self.nq
        if M == 0:
            return self.pack_queries(seed_queries, need_buckets=False)
        k = self.k
        lens = np.fromiter((q.num_seeds for q in seed_queries), np.int64,
                           M)
        if int(lens.max(initial=0)) > 512:
            return self.pack_queries(seed_queries, need_buckets=False)
        total = int(lens.sum())
        q_seeds = np.full((M, nq), -1, np.int32)
        q_pos = np.zeros((M, nq), np.int32)
        q_rb = np.full((M, nq), -1, np.int32)
        q_db = np.full((M, nq), -1, np.int32)
        num_sets = np.zeros(M, np.int32)
        q_len = np.fromiter((q.length for q in seed_queries), np.int32, M)
        if total == 0:
            return q_seeds, q_pos, q_rb, q_db, num_sets, q_len
        seeds_flat = np.concatenate(
            [np.asarray(q.seeds, np.int64) for q in seed_queries])
        gaps_flat = np.concatenate(
            [np.asarray(q.gaps[:-1], np.int64) if q.num_seeds
             else np.empty(0, np.int64) for q in seed_queries])
        starts = np.zeros(M + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        seg0 = starts[:-1]
        rix = np.repeat(np.arange(M), lens)
        pos_in_q = np.arange(total) - seg0[rix]
        first = pos_in_q == 0
        # segmented seed_positions: cumsum of (gap, +k from slot 1)
        steps = gaps_flat.copy()
        steps[~first] += k
        cs = np.cumsum(steps)
        base = cs[seg0[rix]] - steps[seg0[rix]]
        pos_flat = cs - base
        keep = pos_in_q < nq
        q_seeds[rix[keep], pos_in_q[keep]] = seeds_flat[keep]
        q_pos[rix[keep], pos_in_q[keep]] = pos_flat[keep]
        # num_sets: usable-run collapse over the FULL seed list
        # (ref Matches semantics, seeds/seeds.go:335-353)
        us = (seeds_flat >= 0) & (self.usable[np.clip(seeds_flat, 0,
                                                      None)])
        acc = np.maximum.accumulate(np.where(us, np.arange(total), -1))
        prev = np.concatenate([[-1], acc[:-1]])
        prev = np.where(prev >= seg0[rix], prev, -1)  # same-query only
        pv = np.where(prev >= 0, seeds_flat[np.clip(prev, 0, None)], -2)
        run_start = us & (pv != seeds_flat)
        num_sets[:] = np.bincount(rix[run_start], minlength=M)
        return q_seeds, q_pos, q_rb, q_db, num_sets, q_len

    def pack_queries(self, seed_queries: List,
                     need_buckets: bool = True) -> tuple:
        """Seed sequences -> fixed-shape device inputs.

        Run-collapse and the usable mask follow ``SeedIndex.matches``
        (ref: seeds/seeds.go:335-353): unusable seeds are dropped, then
        consecutive duplicates collapse; ``num_sets`` is the exact run
        count even when hash buckets collide.  With ``need_buckets``
        False (callers on the on-device derivation path) the hash/unique
        bucket arrays stay -1 — only num_sets is computed."""
        M = len(seed_queries)
        nq = self.nq
        q_seeds = np.full((M, nq), -1, np.int32)
        q_pos = np.zeros((M, nq), np.int32)
        q_rb = np.full((M, nq), -1, np.int32)
        q_db = np.full((M, nq), -1, np.int32)
        num_sets = np.zeros(M, np.int32)
        q_len = np.zeros(M, np.int32)
        for i, sq in enumerate(seed_queries):
            s = sq.seeds
            m = min(s.shape[0], nq)
            q_seeds[i, :m] = s[:m]
            q_pos[i, :m] = sq.seed_positions(self.k)[:m]
            q_len[i] = sq.length
            f = s[self.usable[s]]
            if f.size:
                runs = f[np.concatenate([[True], f[1:] != f[:-1]])]
                num_sets[i] = runs.shape[0]
                if not need_buckets:
                    continue
                rb = match_ops.hash_ids(runs, self.num_seeds, self.H)
                r = min(rb.shape[0], nq)
                q_rb[i, :r] = rb[:r]
                db = np.unique(rb)
                d = min(db.shape[0], nq)
                q_db[i, :d] = db[:d]
        return q_seeds, q_pos, q_rb, q_db, num_sets, q_len

    def query(self, seed_queries: List, base_min: np.ndarray,
              pair_budget: int = 0, top_k: int = 4,
              min_sets: int = 5):
        """Run the fused pipeline; returns per query a list of
        (chunk idx, distinct count, summary dict) in chunk order."""
        futs = self.dispatch(seed_queries, base_min, pair_budget, top_k,
                             min_sets)
        return self.collect(futs)

    def dispatch(self, seed_queries: List, base_min: np.ndarray,
                 pair_budget: int = 0, top_k: int = 4,
                 min_sets: int = 5):
        if len(seed_queries) == 0 or self.C == 0:
            return (0, None, None, None)
        return self.dispatch_packed(self.pack_queries(seed_queries),
                                    base_min, pair_budget, top_k, min_sets)

    def dispatch_packed(self, packed: tuple, base_min: np.ndarray,
                        pair_budget: int = 0, top_k: int = 4,
                        min_sets: int = 5):
        """Enqueue the fused pipeline on a prepacked query-feature tuple
        (``pack_queries`` or the vectorized ``pack_query_windows``)."""
        q_seeds, q_pos, q_rb, q_db, num_sets, q_len = packed[:6]
        M = q_seeds.shape[0]
        if M == 0 or self.C == 0:
            return (0, None, None, None)
        # right-size the seed axis to the batch: 1 kb map windows carry
        # ~11 seeds (max ~28) at the default seed rate, so the engine-cap
        # width (64) doubles the upload and quadruples the chain DP
        # (anchors = nq * per_seed both in scan steps and width) for
        # padding.  Run/distinct bucket counts are <= the seed count, and
        # q_db's live entries sit within the first live(q_rb) slots, so
        # one slice bound covers all four arrays.  Bucketed to halves of
        # the cap to bound compile variants.
        nq_full = self.nq
        max_live = int((q_seeds >= 0).sum(axis=1).max(initial=1))
        nq_eff = nq_full if max_live > nq_full // 2 else nq_full // 2
        if nq_eff < nq_full:
            q_seeds = q_seeds[:, :nq_eff]
            q_pos = q_pos[:, :nq_eff]
            q_rb = q_rb[:, :nq_eff]
            q_db = q_db[:, :nq_eff]
        # min_count per Matches: round(hit_fraction * num_sets); queries
        # with too few usable seeds get no candidates (min_count = 0
        # never passes the > 0 check)
        min_count = (self.hit_fraction * num_sets.astype(np.int64)
                     + 0.5).astype(np.int64)
        min_count[num_sets < min_sets] = 0
        MB = _bucket(M)
        if self.mesh is not None:
            D = self.mesh.shape["data"]
            MB = ((MB + D - 1) // D) * D

        def padm(a, fill):
            if a.shape[0] == MB:
                return a
            shape = (MB - a.shape[0],) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, a.dtype)])

        if not pair_budget:
            # a deterministic function of the BUCKETED batch size, so the
            # number of compiled (batch, budget) combinations stays equal
            # to the number of batch buckets.  Chain DP, summary and the
            # fetch all scale with the budget, so it is sized tight
            # (observed ~0.3 passing pairs/row on mapping loads; this
            # allows 1/row) and collect() escalates 4x on overflow.
            # Small (mapNext/split) batches get a proportionally small
            # budget: 2 pairs/row still leaves escalation rare.
            pair_budget = max(512, 2 * MB) if MB <= 512 else max(4096, MB)
            if self.num_seeds > 2 * self.H:
                # heavy hash-bucket collision pressure (genome-scale
                # seed counts over the capped bucket space) inflates
                # gate passes: observed 1.4 pairs/row at 6.6 ids/bucket
                # where sub-collision loads see ~0.5.  Double the budget
                # so every dispatch doesn't pay the 4x escalation re-run.
                pair_budget *= 2

        small = self._t_small and int(q_pos.max(initial=0)) < 16000

        if self.seed_sharded:
            args = [padm(q_seeds, -1), padm(q_pos, 0), padm(q_rb, -1),
                    padm(q_db, -1), padm(min_count.astype(np.int32), 0),
                    padm(np.asarray(base_min, np.int32), 1 << 20),
                    padm(q_len, 0)]
            args = [self._put_data(a) for a in args]

            def call(budget):
                counts = self._sharded_counts(self.membership, args[2])
                dcounts = self._sharded_counts(self.membership, args[3])
                return _map_from_counts(
                    counts, dcounts, args[0], args[1], args[4], args[5],
                    args[6], self.t_seeds, self.t_pos, k=self.k,
                    pair_budget=budget, top_k=top_k, small=small,
                    lean=self.lean)

            return (M, call(pair_budget), pair_budget, call)

        nq = q_seeds.shape[1]
        qmax = int(q_pos.max(initial=0))
        lmax = int(q_len.max(initial=0))
        Mq = q_pos.shape[0]
        sdt = np.int16 if self.num_seeds < (1 << 15) else np.int32

        # when every extracted seed of every row fits the shipped width,
        # the run/distinct buckets are a pure function of (q_seeds,
        # usable) and are derived ON DEVICE — the upload halves
        # (1 kb map windows carry ~11-28 seeds, so this is the standard
        # path; repeat-heavy batches fall back to shipping buckets)
        num_seeds_arr = packed[6] if len(packed) > 6 else None
        derive = (num_seeds_arr is not None and Mq > 0
                  and int(np.max(num_seeds_arr, initial=0)) <= nq)
        if derive:
            dt = (np.int16 if qmax < (1 << 15) and lmax < (1 << 15)
                  else np.int32)
            a_c = np.empty((MB, nq + 3), dt)
            a_c[:Mq, :nq] = q_pos
            a_c[:Mq, nq] = min_count
            a_c[:Mq, nq + 1] = np.minimum(np.asarray(base_min), 1 << 14)
            a_c[:Mq, nq + 2] = q_len
            a_c[Mq:] = 0
            s_c = padm(q_seeds.astype(sdt), -1)
            if a_c.dtype == s_c.dtype:
                a_dev, s_dev = _split_query(
                    self._put_data(np.concatenate([a_c, s_c], axis=1)),
                    a_c.shape[1])
            else:
                a_dev = self._put_data(a_c)
                s_dev = self._put_data(s_c)

            combine = MB < 32768 and self.C < 32768

            if self._binned:
                def call(budget, BB=self._BB):
                    return _fused_map_bd(
                        a_dev, s_dev, self.usable_dev, self.membership,
                        self.bin_mem1, self.t_seeds, self.t_pos,
                        k=self.k, pair_budget=budget, top_k=top_k,
                        small=small, nq=nq, hashed=self._hashed,
                        hashed1=self._hashed1, lean=self.lean,
                        combine=combine, NB=self._NB, CB=self._CB,
                        BB=BB, C=self.C)
            else:
                def call(budget):
                    return _fused_map_d(a_dev, s_dev, self.usable_dev,
                                        self.membership, self.t_seeds,
                                        self.t_pos, k=self.k,
                                        pair_budget=budget, top_k=top_k,
                                        small=small, nq=nq,
                                        hashed=self._hashed,
                                        lean=self.lean, combine=combine)

            return (M, _stream_home(call(pair_budget)), pair_budget, call)

        # one combined feature transfer (q_pos | q_rb | q_db | scalars)
        # plus the seed-id array: two device_puts instead of seven
        dt = (np.int16 if self.H <= (1 << 15) and qmax < (1 << 15)
              and lmax < (1 << 15) else np.int32)
        a_c = np.empty((MB, 3 * nq + 3), dt)
        a_c[:Mq, :nq] = q_pos
        a_c[:Mq, nq : 2 * nq] = q_rb
        a_c[:Mq, 2 * nq : 3 * nq] = q_db
        a_c[:Mq, 3 * nq] = min_count
        a_c[:Mq, 3 * nq + 1] = np.minimum(np.asarray(base_min), 1 << 14)
        a_c[:Mq, 3 * nq + 2] = q_len
        a_c[Mq:] = 0
        a_c[Mq:, nq : 3 * nq] = -1
        a_dev = self._put_data(a_c)
        s_dev = self._put_data(padm(q_seeds.astype(sdt), -1))

        combine = MB < 32768 and self.C < 32768

        if self._binned:
            def call(budget, BB=self._BB):
                return _fused_map_bc(a_dev, s_dev, self.membership,
                                     self.bin_mem2, self.t_seeds,
                                     self.t_pos, k=self.k,
                                     pair_budget=budget, top_k=top_k,
                                     small=small, nq=nq, lean=self.lean,
                                     combine=combine, NB=self._NB,
                                     CB=self._CB, BB=BB, C=self.C)
        else:
            def call(budget):
                return _fused_map_c(a_dev, s_dev, self.membership,
                                    self.t_seeds, self.t_pos, k=self.k,
                                    pair_budget=budget, top_k=top_k,
                                    small=small, nq=nq, lean=self.lean,
                                    combine=combine)

        return (M, _stream_home(call(pair_budget)), pair_budget, call)

    def query_chains(self, seed_queries: List, base_min: np.ndarray,
                     pair_budget: int = 0, chain_len: int = 128,
                     variant: str = "aligner", min_sets: int = 5,
                     _defer: bool = False, shape_plan: dict = None):
        """Fused retrieval + gate + chain + best-chain extraction.

        Returns per query a list of (chunk idx, distinct count, best
        chain length, query-anchor indices, target-anchor indices) in
        chunk order — the overlapper's per-candidate best alignments.
        Target indices address the chunk's own seed list (truncated at
        ``self.nt`` seeds)."""
        M = len(seed_queries)
        if M == 0 or self.C == 0:
            return []
        # the chain DP's sequential scan runs 2 * nq steps and the walk
        # chain_len steps — size both to the batch's real max seed count
        # (bucketed to limit compile variants) instead of the engine cap
        plan = shape_plan if shape_plan is not None else {}
        max_ns = max((len(q.seeds) for q in seed_queries), default=1)
        # 64-grid (not 32): overlap rounds drift across the 64/96
        # boundary round-to-round, and each width is a fresh executable
        # compile; the job's shape plan pins it
        # monotone across rounds
        nq_eff = min(self.nq,
                     max(32, ((min(max_ns, self.nq) + 63) // 64) * 64))
        nq_eff = min(self.nq, max(nq_eff, plan.get("nq", 0)))
        plan["nq"] = nq_eff
        # when every query's seeds fit the width, buckets are derived on
        # device — skip building them on host entirely
        derive = not self.seed_sharded and max_ns <= nq_eff
        q_seeds, q_pos, q_rb, q_db, num_sets, _ = (
            self.pack_queries_vec(seed_queries) if derive
            else self.pack_queries(seed_queries, need_buckets=True))
        q_seeds = q_seeds[:, :nq_eff]
        q_pos = q_pos[:, :nq_eff]
        chain_len = min(chain_len, nq_eff)
        min_count = (self.hit_fraction * num_sets + 0.5).astype(np.int64)
        min_count[num_sets < min_sets] = 0
        MB = max(_bucket(M), plan.get("mb", 0))
        plan["mb"] = MB
        if self.mesh is not None:
            D = self.mesh.shape["data"]
            MB = ((MB + D - 1) // D) * D

        def padm(a, fill):
            if a.shape[0] == MB:
                return a
            shape = (MB - a.shape[0],) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, a.dtype)])

        if not pair_budget:
            # all-vs-all retrieves ~coverage candidates per query (a 20x
            # dataset sees ~11/query); 16/query avoids the 4x-escalation
            # re-run that doubled round wall-clock at default coverage.
            # Sized to the REAL query count (budget drives the chain-DP
            # cost), bucketed to a 4096 grid for compile-cache reuse,
            # and pinned monotone by the job's shape plan.
            pair_budget = max(4096, ((16 * M + 4095) // 4096) * 4096)
            pair_budget = max(pair_budget, plan.get("budget", 0))
            plan["budget"] = pair_budget

        small = self._t_small and int(q_pos.max(initial=0)) < 16000
        # anchor-build chunk sized so the [CH, nq, nt] equality tensor
        # stays ~256 MB as nt ladders up (static per (nq, nt) pair)
        a_chunk = max(128, min(1024,
                               (1 << 28) // max(1, nq_eff * self.nt)))

        # on-device bucket derivation when every query's full seed list
        # fits the shipped width (same guard as dispatch_packed): drops
        # q_rb/q_db from the upload and folds the rest into ONE transfer
        if derive:
            qmax = int(q_pos.max(initial=0))
            dt = np.int16 if qmax < (1 << 15) else np.int32
            Mq = q_pos.shape[0]
            a_c = np.zeros((MB, nq_eff + 2), dt)
            a_c[:Mq, :nq_eff] = q_pos
            a_c[:Mq, nq_eff] = min_count
            a_c[:Mq, nq_eff + 1] = np.minimum(np.asarray(base_min),
                                              1 << 14)
            a_c[Mq:, nq_eff + 1] = 1 << 14
            sdt = np.int16 if self.num_seeds < (1 << 15) else np.int32
            s_c = padm(q_seeds.astype(sdt), -1)
            if a_c.dtype == s_c.dtype:
                # one combined transfer: each device_put pays a round trip
                a_dev, s_dev = _split_query(
                    self._put_data(np.concatenate([a_c, s_c], axis=1)),
                    a_c.shape[1])
            else:
                a_dev = self._put_data(a_c)
                s_dev = self._put_data(s_c)

            def call(budget):
                return _fused_overlap_d(
                    a_dev, s_dev, self.usable_dev, self.membership,
                    self.t_seeds, self.t_pos, k=self.k,
                    pair_budget=budget, variant=variant, chunk=a_chunk,
                    chain_len=chain_len, small=small, nq=nq_eff,
                    hashed=self._hashed)
        else:
            args = [padm(q_seeds, -1), padm(q_pos, 0), padm(q_rb, -1),
                    padm(q_db, -1), padm(min_count.astype(np.int32), 0),
                    padm(np.asarray(base_min, np.int32), 1 << 20)]
            args = [self._put_data(a) for a in args]

            def call(budget):
                if self.seed_sharded:
                    counts = self._sharded_counts(self.membership,
                                                  args[2])
                    dcounts = self._sharded_counts(self.membership,
                                                   args[3])
                    return _overlap_from_counts(
                        counts, dcounts, args[0], args[1], args[4],
                        args[5], self.t_seeds, self.t_pos, k=self.k,
                        pair_budget=budget, variant=variant, chunk=a_chunk,
                        chain_len=chain_len, small=small)
                return _fused_overlap(*args, self.membership,
                                      self.t_seeds, self.t_pos, k=self.k,
                                      pair_budget=budget, variant=variant,
                                      chunk=a_chunk, chain_len=chain_len,
                                      small=small)

        fut = call(pair_budget)
        # start the (counts, max-length) scalars streaming home NOW: by
        # collect_chains time they are local and the two-phase fetch
        # waits once instead of twice
        _async_copy(fut[3], fut[4], fut[5])
        # speculative sliced prefetch: slice head/chains to the sizes the
        # LAST round needed (plus headroom, recorded by collect_chains)
        # and start them streaming home now — the transfer runs while
        # the host preps the next round, so the collect's dominant fetch
        # is already local.
        # Rounds grow smoothly, so the hint rarely misses; a miss falls
        # back to the exact two-phase fetch below.
        pre = pre_bl = None
        hint = MapEngine._chain_hint.get(
            self._hint_key(pair_budget, chain_len))
        if hint is not None:
            hB = min(fut[0].shape[0], hint[0])
            hL = min(chain_len, hint[1])
            pre = _slice_chains(fut[0], fut[1], fut[2], hB, hL)
            pre_bl = (hB, hL)
            if not _async_copy(*pre):
                pre = pre_bl = None
        futs = (M, fut, pair_budget, call, chain_len, pre, pre_bl, plan)
        return futs if _defer else self.collect_chains(futs)

    def dispatch_chains(self, seed_queries: List, base_min: np.ndarray,
                        pair_budget: int = 0, chain_len: int = 128,
                        variant: str = "aligner", min_sets: int = 5,
                        shape_plan: dict = None):
        """Async half of ``query_chains``: enqueue the fused dispatch and
        return a future tuple for ``collect_chains`` — callers overlap
        host work (e.g. the next round's query prep) with the device."""
        return self.query_chains(seed_queries, base_min, pair_budget,
                                 chain_len, variant, min_sets,
                                 _defer=True, shape_plan=shape_plan)

    def collect_chains_raw(self, futs):
        """Fetch half of ``collect_chains``: returns ``(M, head, cq,
        ct)`` numpy arrays (kept rows compacted first; head columns =
        query row, chunk, best len, distinct count).

        Two-phase fetch: the scalar (count, max chain length) pair
        first, then the head/chain arrays SLICED on device to the
        bucketed live-row count and real max chain length.  Unlike the
        mapper's summary rows (see collect_arrays_many), the chains
        array is wide enough (2 x chain_len int16 ~ 512 B/row) that the
        bytes saved outweigh the extra round trip: a 20x-coverage
        overlap round fetches ~1 MB instead of ~6.5 MB."""
        if isinstance(futs, list):       # empty-input fast path
            return 0, np.zeros((0, 4), np.int32), None, None
        M, fut, pair_budget, call, chain_len = futs[:5]
        pre = futs[5] if len(futs) > 5 else None
        pre_bl = futs[6] if len(futs) > 6 else None
        plan = futs[7] if len(futs) > 7 else None
        hint_key = self._hint_key(pair_budget, chain_len)
        head_d, cq_d, ct_d, n_d, nk_d, mx_d = fut
        n, nk, mx = (int(v) for v in jax.device_get((n_d, nk_d, mx_d)))
        escalated = False
        while n > pair_budget:
            # escalate straight to the observed need (4096 grid) — each
            # intermediate size would be both a wasted dispatch and a
            # fresh executable
            pair_budget = max(pair_budget * 2,
                              ((n + n // 8 + 4095) // 4096) * 4096)
            escalated = True
            head_d, cq_d, ct_d, n_d, nk_d, mx_d = call(pair_budget)
            n, nk, mx = (int(v) for v in
                         jax.device_get((n_d, nk_d, mx_d)))
            pre = None               # prefetched rows came from the
            # overflowed dispatch — its chains are truncated, refetch
        if escalated and plan is not None:
            # teach the job plan the real per-round pair need so later
            # rounds dispatch right-sized the first time
            plan["budget"] = max(plan.get("budget", 0), pair_budget)
        # rows are compacted KEPT-first on device (static-min pre-filter)
        # so the fetch covers nk rows, not the gate count n
        B = min(head_d.shape[0], max(1024, -(-nk // 1024) * 1024))
        Lb = min(chain_len, max(16, -(-mx // 16) * 16))
        # record next round's prefetch sizes with tight headroom (rows
        # +12.5%, length +25%): round-to-round row counts drift ~2% and
        # chain lengths ~15%, and every spare row/lane is wasted
        # transfer bytes on the prefetch (the round critical path).  A miss just
        # falls back to the exact fetch.  After a budget escalation the
        # row count belongs to the ESCALATED dispatch — recording it
        # under the original key would make the next round's prefetch
        # clamp to the full budget and stream the whole arrays, so skip.
        if not escalated:
            MapEngine._chain_hint[hint_key] = (
                min(head_d.shape[0], -(-(nk + nk // 8) // 1024) * 1024),
                min(chain_len, max(16, -(-(mx + mx // 4) // 16) * 16)))
        if pre is not None and pre_bl[0] >= B and pre_bl[1] >= Lb:
            head, cq, ct = jax.device_get(pre)
        else:
            head, cq, ct = jax.device_get(
                _slice_chains(head_d, cq_d, ct_d, B, Lb))
        return M, head, cq, ct

    def collect_chains(self, futs):
        """Blocking half of ``query_chains`` — per-query candidate
        lists built from the raw fetch (see collect_chains_raw for the
        fetch/escalation mechanics)."""
        if isinstance(futs, list):       # empty-input fast path
            return futs
        M, head, cq, ct = self.collect_chains_raw(futs)
        out = [[] for _ in range(M)]
        live = np.flatnonzero((head[:, 0] >= 0) & (head[:, 0] < M)
                              & (head[:, 2] > 0))
        hl = head[live].tolist()
        for i, b in enumerate(live.tolist()):
            mi, ci, blen, dc = hl[i]
            ma = cq[b, blen - 1::-1].tolist()
            mb = ct[b, blen - 1::-1].tolist()
            out[mi].append((ci, dc, blen, ma, mb))
        return out

    def collect_arrays(self, futs):
        """Fetch one dispatch's results as flat numpy arrays: ``(head
        [N, 3] int32 (query row, chunk, distinct count), summary [N, W]
        int32)`` over live pairs only, ordered query-major /
        chunk-ascending (the reference's candidate walk order).  The
        vectorized walk in ``mapping.mapper`` consumes these directly —
        no per-pair dict building on the hot path."""
        return self.collect_arrays_many([futs])[0]

    def collect_arrays_many(self, futs_list):
        """``collect_arrays`` over several in-flight dispatches with ONE
        ``jax.device_get`` for all of them instead of one wait per
        dispatch."""
        fetch = jax.device_get([f[1] for f in futs_list if f[1] is not None])
        out = []
        fi = 0
        for M, fut, pair_budget, call in futs_list:
            if fut is None:
                out.append(None)
                continue
            head, packed, n_ok, n_bin = _split_result(fetch[fi])
            fi += 1
            BB = self._BB if self._binned else 0
            # two escalation axes: pair-budget overflow (n_ok) and, on
            # the binned path, passing-bins-per-query overflow (n_bin) —
            # either means the dispatch may have dropped pairs, so
            # re-dispatch bigger until exact (4x / 2x; compiles cache)
            while n_ok > pair_budget or (n_bin is not None and n_bin > BB):
                if n_bin is not None and n_bin > BB:
                    BB = min(self._NB, BB * 2)
                if n_ok > pair_budget:
                    pair_budget *= 4
                args = (pair_budget, BB) if self._binned else (pair_budget,)
                head, packed, n_ok, n_bin = _split_result(
                    jax.device_get(call(*args)))
            live = head[:, 0] >= 0
            head = head[live]
            packed = packed[live].astype(np.int32)
            if self._perm is not None:
                # translate engine (genome-permuted) chunk ids back to
                # original ids and restore the reference's query-major /
                # chunk-ascending candidate-walk order
                head[:, 1] = self._perm[head[:, 1]]
                order = np.lexsort((head[:, 1], head[:, 0]))
                head = head[order]
                packed = packed[order]
            out.append((head, packed))
        return out

    def collect(self, futs, top_k: int = 4):
        M = futs[0]
        if futs[1] is None:
            return []
        head, packed = self.collect_arrays(futs)
        summaries = unpack_summary(packed, top_k, lean=self.lean)
        out = [[] for _ in range(M)]
        for b in range(head.shape[0]):
            mi = int(head[b, 0])
            if mi < M:
                out[mi].append((int(head[b, 1]), int(head[b, 2]),
                                {key: v[b] for key, v in summaries.items()}))
        return out
