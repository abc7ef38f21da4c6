"""Device beam-search DTW consensus — the bulk-throughput engine.

The host engine (``align.dtw``) reproduces the reference's sequential
landmark beam exactly; this engine re-expresses consensus as a
fixed-width beam search that runs entirely on device and vmaps over many
consensus jobs at once, so the correct pipeline's thousands of pileup
windows run in a few dispatches.

Per step, for every beam state and each of its 4 k-mer extensions, the
32-wide cost band of every member sequence updates with the same
step/stay/skip recurrence as the reference kernel
(ref: sequence/alignment/asm_amd64.s, via ``align.band`` semantics);
extensions with no exact k-mer support anywhere are pruned (the
reference's vote rule, alignment.go:714), quality decays 0.95 on
non-matching members (alignment.go:684), drifting bands recentre
(alignment.go:245), and the beam keeps the B cheapest states.  Landmarks
are replaced by the fixed-width beam itself: with B >= 8 the anchor
states the reference protects via landmarks stay in the beam.  The
consensus is recovered from recorded (k-mer, parent) arrays on the host.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 28)
# dead-lane sentinel: any value > threshold + max distance works (bands
# only ever hold {0..~threshold} or FULL).  0x7FFF rather than the
# reference's uint16 0xFFFF so bands also fit int16 lanes
FULL = 0x7FFF

# Device-engine window schedule: member lanes outside
# [base(t), base(t) + WINW) of padded o-space are dead.  The base
# is a STATIC function of the consensus step — the expected-position
# regularizer (ref: alignment.go:308-331) holds live bands near
# o = t + 25, and the 512-lane window covers o - t in [-294, +161] even
# at the worst 128-alignment phase.  A min-frontier (state-dependent) base
# was tried first and lost parity: one wandering dead member dragged
# the base and silently killed healthy members.  384 lanes was tried
# next and truncated consensus on routine 600-base pileups: its
# worst-phase forward margin (+49) was inside the range deletion-heavy
# members legitimately run ahead of the consensus step.
WINW = 512
# Device-engine expected-position slack: the host engine uses the
# reference's +-16 (alignment.go:308-331) with landmark-updated
# expectations; the device engines have no landmarks, so honest
# systematic drift (members shorter/longer than the consensus)
# accumulates against a STATIC expectation — +-64 tolerates it while
# still pulling runaway dead members back inside the window
REG_SLACK = 64


# member band width in lanes (the reference's 32-wide SSE band)
W = 32
# grid stride of the blocked window matrix (see _window_matrix)
G = 8


def _window_matrix(padded):
    """Blocked sliding windows of ``padded`` [N, P] int32 (P = L + 2W):
    [N, Q, G+W] float32 whose cell q holds padded[n, G*q : G*q + G+W],
    clamped at the end.  Only 1.25x redundant, where a per-lane
    [N, P, W] matrix would hold every lane W times over."""
    P = padded.shape[1]
    Q = (P - W + G - 1) // G
    cell_idx = (G * jnp.arange(Q))[:, None] + jnp.arange(G + W)[None, :]
    return padded[:, jnp.minimum(cell_idx, P - 1)].astype(jnp.float32)


def _fetch_window(windmat, o):
    """km[b, n, w] = windmat[n, o // G, o % G + w] for w < W, from
    [B, N] window starts ``o``; starts outside the matrix read 0.

    A one-hot contraction against the window matrix selects the grid
    cell and three conditional rolls align the live lanes, keeping the
    per-step fetch free of dynamic gathers.  Exact only at HIGHEST
    precision: k-mer values reach 4^k - 1, past the 11 significant bits
    of a TF32 product once k >= 6."""
    Q = windmat.shape[1]
    oq = o // G
    orr = o % G
    oh = jax.nn.one_hot(oq, Q, dtype=jnp.float32)          # [B, N, Q]
    seg_f = jnp.einsum("bnq,nqj->bnj", oh, windmat,
                       precision=jax.lax.Precision.HIGHEST)
    seg = jnp.rint(seg_f).astype(jnp.int32)                # [B, N, G+W]
    # r < G so three conditional rolls suffice, and r + w <= G+W-2 never
    # wraps into live lanes
    for b in (1, 2, 4):
        seg = jnp.where((orr[..., None] & b) != 0,
                        jnp.roll(seg, -b, axis=-1), seg)
    return seg[..., :W]


def _fetch_window_gather(windmat, o):
    """Plain-gather twin of ``_fetch_window``: the reference it is
    tested against."""
    Q = windmat.shape[1]
    oq = o // G
    lane = (o % G)[..., None] + jnp.arange(W)              # [B, N, W]
    rows = jnp.arange(windmat.shape[0])[None, :, None]
    vals = windmat[rows, jnp.clip(oq, 0, Q - 1)[..., None], lane]
    inside = ((oq >= 0) & (oq < Q))[..., None]
    return jnp.where(inside, jnp.rint(vals).astype(jnp.int32), 0)


def _win_params(L: int):
    """(slice width, max base) of the static window for member arrays of
    logical length ``L``: width min(WINW, padded length), base range
    sized so base + width exactly reaches the padded end (lp >= L + 64,
    so the max window always covers the finishing region o <= L + 31)."""
    lp = ((L + 2 * 32 + 127) // 128) * 128
    sw = min(WINW, lp)
    hi = max(0, lp - sw)
    return sw, hi


def _win_base(t, L: int):
    """128-aligned o-space window base at consensus step ``t`` for
    member arrays of logical length ``L``, biased +64 forward of the
    expected band position o = t + 25.  Clip BEFORE the floor division
    so the operand is non-negative (negative int division semantics
    differ between backends)."""
    sw, hi = _win_params(L)
    return (jnp.clip(t + 25 + 64 - sw // 2, 0, hi) // 128) * 128


def _argmin_last(x, axis=-1):
    """Index of the minimum, ties broken toward the HIGHEST index.

    The band frontier must be the furthest-advanced minimal-cost lane:
    on zero-cost plateaus (homopolymer runs, drifted stretches)
    ``jnp.argmin``'s lowest-index tie-break pins the frontier at the
    plateau's start, the advance-requiring vote rule then keeps passing
    forever, and the beam emits unbounded run extensions — the failure
    the parity harness catches on homopolymer/drift cases.

    Implemented as a plain single-output min over the encoded key
    ``x * (2n) + (n-1-lane)`` with the lane decoded from the low bits:
    among equal x the smaller key sits at the HIGHER lane, and the
    value/index pair-reduce XLA emits for argmin over the lane-minor
    axis measured ~4x the cost of this min+mod (240 us -> tens of us per
    step at bench shapes).  Exact while 0 <= x <= FULL (keys < 2^23)."""
    n = x.shape[axis]
    assert axis in (-1, x.ndim - 1)
    lane = jnp.arange(n, dtype=jnp.int32)
    key = x * (2 * n) + (n - 1 - lane)
    return (n - 1) - jnp.min(key, axis=axis) % (2 * n)


def _band_update(poffs, ds, threshold):
    """Vectorized band update over [..., W] (see align.band)."""
    full = jnp.int32(FULL)
    sat = lambda x: jnp.minimum(x, full)
    pad = jnp.full(poffs.shape[:-1] + (1,), full, jnp.int32)
    step = poffs
    stay = jnp.concatenate([poffs[..., 1:], pad], axis=-1)
    pd = sat(poffs + ds)
    skip1 = jnp.concatenate([pad, pd[..., :-1]], axis=-1)
    two = sat(pd[..., :-1] + ds[..., 1:])
    skip2 = jnp.concatenate([pad, pad, two[..., :-1]], axis=-1)
    best = jnp.minimum(jnp.minimum(step, stay), jnp.minimum(skip1, skip2))
    raw = sat(best + ds)
    m = raw.min(axis=-1)
    out = jnp.maximum(raw - m[..., None], 0)
    out = jnp.where(out >= threshold, full, out)
    return out, m


_SIMPLE_WEIGHTS = {
    # (shift, weight) pairs per k — the exact schedule of
    # align.measures.build_simple_table (ref: measures.go:45-104)
    5: ((4, 8), (6, 2), (2, 2), (0, 1), (8, 1)),
    4: ((4, 4), (2, 4), (6, 2), (0, 2)),
    3: ((2, 8), (4, 2), (0, 2)),
    6: ((4, 4), (6, 4), (2, 2), (8, 2), (0, 1), (10, 1)),
    1: ((0, 8),),
}


def _simple_distance(a, b, k: int):
    """Position-weighted XOR mismatch cost computed arithmetically — the
    simpleMeasure table value without the table (ref: measures.go:45-104).
    About 12 integer elementwise ops instead of a [4^k, 4^k] table
    gather per band cell."""
    d = a ^ b
    cost = None
    for sh, w in _SIMPLE_WEIGHTS[k]:
        bit = ((d >> sh) | (d >> (sh + 1))) & 1
        term = bit * w
        cost = term if cost is None else cost + term
    return cost


def _barrel_shift(x, shift, fill):
    """x[..., w] -> x[..., w - shift] along the last (W) axis, vacated
    lanes = fill.  Static rolls + selects (log2(2W) of them) instead of
    a dynamic per-row gather, keeping the step elementwise.

    shift broadcasts over all but the last axis; |shift| may reach W."""
    W = x.shape[-1]
    lane = jnp.arange(W)
    # wrap-around barrel roll right by `shift` (mod 2W to keep sign sane)
    u = jnp.mod(shift, 2 * W)[..., None]                  # [..., 1]
    y = jnp.concatenate([x, jnp.full_like(x, fill)], axis=-1)  # [..., 2W]
    bit = 1
    while bit < 2 * W:
        rolled = jnp.roll(y, bit, axis=-1)
        y = jnp.where((u & bit) != 0, rolled, y)
        bit <<= 1
    y = y[..., :W]
    src = lane - shift[..., None]
    return jnp.where((src < 0) | (src >= W), fill, y)


@functools.partial(jax.jit,
                   static_argnames=("k", "beam", "t_max", "threshold",
                                    "gap_cost", "simple_k",
                                    "return_records"))
def device_consensus(seq_kmers, lens, table, first_kmer, k: int,
                     beam: int = 16, t_max: int = 256,
                     threshold: int = 300, gap_cost: int = 8,
                     simple_k: int = 0, return_records: bool = False):
    """One consensus job on device.

    seq_kmers: [N, L] int32 (pad -1); lens: [N]; table: [4^k, 4^k] uint16
    distance table; first_kmer: starting k-mer.  Returns the traced-back
    consensus chain ([t_max] int32, -1-padded) and its valid length.
    """
    N, L = seq_kmers.shape
    centre = W // 2
    mask = (1 << (2 * k)) - 1
    INIT = 8  # initialOffset (ref: alignment.go:15)

    PAD = W
    P0 = L + W
    padded = jnp.full((N, L + 2 * W), -1, jnp.int32)
    padded = jax.lax.dynamic_update_slice(padded, seq_kmers, (0, PAD))
    windmat = _window_matrix(padded)                       # [N, Q, G+W]

    # initial state: all beams identical, one live
    offsets0 = jnp.full((N, W), gap_cost, jnp.int32)
    offsets0 = offsets0.at[:, :INIT].set(FULL)
    match0 = (seq_kmers[:, 0] == first_kmer)
    offsets0 = offsets0.at[:, INIT].set(jnp.where(match0, 0, gap_cost))
    state = {
        "kmer": jnp.full(beam, first_kmer, jnp.int32),
        "offsets": jnp.broadcast_to(offsets0, (beam, N, W)).astype(jnp.int32),
        "positions": jnp.full((beam, N), INIT, jnp.int32),
        "cost": jnp.where(jnp.arange(beam) == 0, 0, BIG),
        "quality": jnp.ones((beam, N), jnp.float32),
        "finished": jnp.zeros(beam, bool),
    }

    def step(state, t):
        kmer = state["kmer"]
        shifted = (kmer << 2) & mask
        nextk = shifted[:, None] | jnp.arange(4)[None, :]      # [B, 4]
        pos2 = state["positions"] + 1                          # [B, N]
        # window sequence kmers depend only on the beam state, not the
        # branch: fetch ONCE per (state, member)
        o = pos2 - centre + PAD                                # [B, N]
        # static per-step window (see WINW above): lanes outside it are
        # dead
        wb = _win_base(t, L)
        sw, _ = _win_params(L)
        ov = (o >= 0) & (o < P0) & (o - wb >= 0) & (o - wb <= sw - W)
        km_at = _fetch_window(windmat, o)                      # [B, N, W]
        # -1 pads mark both out-of-range lanes and beyond-len positions;
        # an out-of-range one-hot row sums to 0, caught by ~ov
        km_bad = (km_at < 0) | ~ov[..., None]
        km_c = jnp.clip(km_at, 0)
        if simple_k:
            ds = _simple_distance(nextk[:, :, None, None],
                                  km_c[:, None], simple_k)
        else:
            ds = table[nextk[:, :, None, None],
                       km_c[:, None]].astype(jnp.int32)
        # expected-position regularizer (ref: alignment.go:308-331):
        # lanes beyond +-REG_SLACK of the global expected position pay a
        # linear penalty — the restoring force that keeps lost members
        # from wandering out of the static window
        lanepos = (pos2 - centre)[:, :, None] + jnp.arange(W)   # [B, N, W]
        extra = jnp.maximum(
            jnp.abs(lanepos - (INIT + 1 + t)) - REG_SLACK, 0)
        ds = ds + extra[:, None]
        ds = jnp.where(km_bad[:, None], BIG // 64, ds)
        pos = jnp.broadcast_to(pos2[:, None, :], (beam, 4, N))
        poffs = jnp.broadcast_to(state["offsets"][:, None], (beam, 4, N, W))
        out, m = _band_update(poffs, ds, threshold)              # [B,4,N,W], [B,4,N]
        # padded (zero-length) members contribute nothing — lets the
        # bulk path vmap jobs with differing member counts
        live_m = lens[None, None, :] > 0
        seq_cost = jnp.sum(jnp.where(live_m, m, 0), axis=2)      # [B, 4]
        # votes: an exact match (ds==0, live lane) at or ahead of the
        # member's previous best alignment position.  Out-lane j maps to
        # absolute position prev_best+1 when j == argmin(poffs), so
        # j >= argmin means the member genuinely advances — a stale match
        # behind the frontier (the zero-cost stall loop) does not count
        # (the reference's vote likewise demands the kmer at the
        # sequence's current position, alignment.go:714).
        bl = _argmin_last(poffs, axis=3)                         # [B, 4, N]
        ahead = jnp.arange(W)[None, None, None, :] >= bl[..., None]
        exact = jnp.any((ds == 0) & (out < FULL) & ahead, axis=3)  # [B,4,N]
        vote_w = jnp.floor(8.0 * state["quality"] + 0.5)         # [B, N]
        vote_sum = jnp.sum(jnp.where(exact, vote_w[:, None, :], 0.0), axis=2)
        cost = state["cost"][:, None] + seq_cost
        cost = jnp.where(vote_sum > 0, cost, BIG)
        cost = jnp.where(state["finished"][:, None],
                         jnp.where(jnp.arange(4)[None, :] == 0,
                                   state["cost"][:, None], BIG), cost)
        # --- duplicate-state suppression -------------------------------
        # Without this the beam deadlocks: a slot can "regenerate" a
        # neighbour slot's kmer at equal cost (its band re-matching the
        # same exact position), and 16 such regenerations fill the whole
        # beam while the true head extension — one error site more
        # expensive — ranks 17th and is dropped every step.  Kmer-level
        # dedup keeps only the cheapest state per consensus suffix, the
        # invariant the reference gets from indexing states by band
        # position (ref: alignment.go landmark beam).
        eff_k = jnp.where(state["finished"][:, None],
                          state["kmer"][:, None], nextk)       # [B, 4]
        cand_k = eff_k.reshape(-1)
        cand_c = cost.reshape(-1)
        p_fin = jnp.repeat(state["finished"], 4)
        slot_live = ~state["finished"]
        ci = jnp.arange(beam * 4)
        # a candidate may regenerate its own parent's kmer (homopolymer
        # run extension) — only cross-slot duplicates deadlock
        not_parent = (ci[:, None] // 4) != jnp.arange(beam)[None, :]
        dup_beam = jnp.any(
            (cand_k[:, None] == state["kmer"][None, :])
            & (state["cost"][None, :] <= cand_c[:, None])
            & slot_live[None, :] & not_parent, axis=1) & ~p_fin
        better = (cand_c[None, :] < cand_c[:, None]) | \
            ((cand_c[None, :] == cand_c[:, None]) & (ci[None, :] < ci[:, None]))
        dup_cand = jnp.any(
            (cand_k[:, None] == cand_k[None, :]) & better
            & ~p_fin[None, :], axis=1) & ~p_fin
        flat_cost = jnp.where(dup_beam | dup_cand, BIG, cand_c)
        # beam select over B*4 flattened successors
        _, top = jax.lax.top_k(-flat_cost, beam)
        parent = top // 4
        branch = top % 4
        sel = lambda a: a[parent]
        new_kmer = nextk[parent, branch]
        new_off = out[parent, branch]                            # [B, N, W]
        new_pos = pos[parent, branch]
        new_quality = jnp.where(exact[parent, branch],
                                1.0, state["quality"][parent] * 0.95)
        # frozen finished states carry through unchanged
        fin = state["finished"][parent]
        new_kmer = jnp.where(fin, state["kmer"][parent], new_kmer)
        new_off = jnp.where(fin[:, None, None], state["offsets"][parent],
                            new_off)
        new_pos = jnp.where(fin[:, None], state["positions"][parent], new_pos)
        new_quality = jnp.where(fin[:, None], state["quality"][parent],
                                new_quality)
        # drift recentring (ref: alignment.go:245-273)
        bp = _argmin_last(new_off, axis=2)                       # [B, N]
        drift = centre - bp
        do = (jnp.abs(drift) > 4) & ~fin[:, None]
        shift = jnp.where(do, drift, 0)
        new_off = _barrel_shift(new_off, shift, jnp.int32(FULL))
        new_pos = new_pos - shift
        # finished: any live member's best lane reaches its end.  The
        # post-shift argmin is derivable without a second reduce pass
        # (~0.2 s/704-step batch in the profile): the barrel shift moves
        # lanes rigidly and fills vacated lanes with FULL, so the
        # tie-highest minimum lands exactly at bp + shift — centre when
        # recentred, bp otherwise.
        best_lane = jnp.where(do, centre, bp)
        seq_pos = new_pos + best_lane - centre
        new_fin = fin | jnp.any((seq_pos >= lens[None, :] - 1)
                                & (lens[None, :] > 0), axis=1)
        new_state = {
            "kmer": new_kmer, "offsets": new_off, "positions": new_pos,
            "cost": flat_cost[top], "quality": new_quality,
            "finished": new_fin,
        }
        rec = (new_kmer, parent.astype(jnp.int32), new_fin,
               flat_cost[top])
        return new_state, rec

    # scan, not while_loop: early exit at the first finisher was tried
    # two ways and LOST both times — a per-step while_loop copies the
    # record buffers every iteration (2.7x slower), and an outer while
    # over 64-step scan segments saved too few steps to cover its copy
    # overhead (a vmapped batch runs until its slowest job's first
    # finisher, typically ~90% of t_max at bench shapes).
    final, recs = jax.lax.scan(step, state, jnp.arange(t_max))
    if return_records:
        return recs
    chain, n_valid = _device_traceback(*recs)
    return chain, n_valid


def _device_traceback(kmers, parents, fin_at, costs):
    """On-device parent walk: the raw (kmers, parents, fin_at, costs)
    record is ~12 MB per 64-job bucket, the walked chain [t_max] int32.

    Matches the host rule: first step at which any slot finished, cheapest
    finished slot there (lowest index on ties); if none finish, the
    cheapest final slot."""
    T, B = kmers.shape
    any_fin = jnp.any(fin_at, axis=1)
    has = jnp.any(any_fin)
    t_end = jnp.where(has, jnp.argmax(any_fin), T - 1)
    cost_row = costs[t_end]
    masked = jnp.where(has & ~fin_at[t_end], BIG, cost_row)
    b_end = jnp.argmin(masked).astype(jnp.int32)

    def walk(b, t):
        b = jnp.where(t == t_end, b_end, b)
        km = jnp.where(t <= t_end, kmers[t, b], -1)
        b = jnp.where(t <= t_end, parents[t, b], b)
        return b, km

    _, rev = jax.lax.scan(walk, b_end, jnp.arange(T - 1, -1, -1))
    return jnp.flip(rev, 0), t_end + 1


def _pad_job(seq_kmers_list, N: int, L: int):
    seq = np.full((N, L), -1, np.int32)
    lens = np.zeros(N, np.int32)
    for i, s in enumerate(seq_kmers_list):
        seq[i, : len(s)] = s
        lens[i] = len(s)
    # majority first kmer (the reference tries every distinct first kmer;
    # the beam converges from the most common one)
    firsts = [int(s[0]) for s in seq_kmers_list if len(s)]
    first = max(set(firsts), key=firsts.count)
    return seq, lens, first


def _assemble(chain: np.ndarray, n: int, first: int) -> np.ndarray:
    return np.concatenate(([np.int32(first)],
                           np.asarray(chain[:n], np.int32)))


def consensus_kmers(seq_kmers_list: List[np.ndarray], table: np.ndarray,
                    k: int, beam: int = 4, threshold: int = 300,
                    gap_cost: int = 8, simple_k: int = 0) -> np.ndarray:
    """Host wrapper: pad one job, run the device beam + traceback.
    Returns the consensus k-mer array."""
    N = len(seq_kmers_list)
    L = max(len(s) for s in seq_kmers_list)
    seq, lens, first = _pad_job(seq_kmers_list, N, L)
    t_max = int(L * 1.3) + 32
    t_max = ((t_max + 31) // 32) * 32
    chain, n = jax.device_get(device_consensus(
        seq, lens, np.asarray(table, np.uint16), first, k=k, beam=beam,
        t_max=t_max, threshold=threshold, gap_cost=gap_cost,
        simple_k=simple_k))
    return _assemble(chain, int(n), first)


@functools.partial(jax.jit,
                   static_argnames=("k", "beam", "t_max", "threshold",
                                    "gap_cost", "simple_k"))
def _device_consensus_vmapped(seqs, lens, table, firsts, k, beam, t_max,
                              threshold, gap_cost, simple_k):
    vm = jax.vmap(
        device_consensus,
        in_axes=(0, 0, None, 0, None, None, None, None, None, None),
    )

    def call(args):
        s, ln, fs = args
        return vm(s, ln, table, fs, k, beam, t_max, threshold, gap_cost,
                  simple_k)

    # chunk the job axis: every scan step re-reads the whole window
    # matrix (~44 MB of f32 for 256 jobs at pileup shapes), so a bounded
    # chunk keeps each step's working set bounded too
    J = seqs.shape[0]
    JC = 256
    if J <= JC:
        return call((seqs, lens, firsts))
    JP = ((J + JC - 1) // JC) * JC
    if JP != J:
        pad = JP - J
        seqs = jnp.concatenate(
            [seqs, jnp.full((pad,) + seqs.shape[1:], -1, seqs.dtype)])
        lens = jnp.concatenate(
            [lens, jnp.zeros((pad,) + lens.shape[1:], lens.dtype)])
        firsts = jnp.concatenate([firsts, jnp.zeros(pad, firsts.dtype)])
    chains, ns = jax.lax.map(
        call, (seqs.reshape(JP // JC, JC, *seqs.shape[1:]),
               lens.reshape(JP // JC, JC, *lens.shape[1:]),
               firsts.reshape(JP // JC, JC)))
    return (chains.reshape(JP, *chains.shape[2:])[:J],
            ns.reshape(JP)[:J])


def consensus_kmers_bulk(jobs: List[List[np.ndarray]], table: np.ndarray,
                         k: int, beam: int = 4, threshold: int = 300,
                         gap_cost: int = 8,
                         simple_k: int = 0) -> List[np.ndarray]:
    """Many consensus jobs in few device dispatches.

    Default beam 4: with kmer-level duplicate suppression the narrow
    beam measures EQUAL-or-better edit distance to truth vs beam 8/16
    across the adversarial parity families (random/noisy/drift/clean
    pileups) at a quarter of the original device cost — and the faithful
    host engine remains the arbiter of exact output.

    Each bucket runs the vmapped scan (``_device_consensus_vmapped``),
    bit-identical to per-job ``device_consensus``.  Jobs are bucketed
    by padded shape (member count, length to a multiple of 128) so
    distinct buckets reuse one compiled executable each.  Returns
    consensus k-mer arrays in job order (empty array for empty jobs)."""
    table = np.asarray(table, np.uint16)
    buckets = {}
    for ji, job in enumerate(jobs):
        job = [s for s in job if len(s)]
        if not job:
            continue
        N = ((len(job) + 3) // 4) * 4
        L = max(len(s) for s in job)
        L = ((L + 127) // 128) * 128
        buckets.setdefault((N, L), []).append((ji, job))
    results = [np.zeros(0, np.int32)] * len(jobs)
    # dispatch every bucket before fetching any, so host padding of the
    # next bucket overlaps device work on the previous one
    inflight = []
    for (N, L), entries in sorted(buckets.items()):
        nj = len(entries)
        t_max = int(L * 1.3) + 32
        t_max = ((t_max + 31) // 32) * 32
        seqs = np.empty((nj, N, L), np.int32)
        lens = np.empty((nj, N), np.int32)
        firsts = np.empty(nj, np.int32)
        for i, (_, job) in enumerate(entries):
            seqs[i], lens[i], firsts[i] = _pad_job(job, N, L)
        fut = _device_consensus_vmapped(seqs, lens, table, firsts, k,
                                        beam, t_max, threshold,
                                        gap_cost, simple_k)
        inflight.append((entries, firsts, fut))
    fetched = jax.device_get([f for *_, f in inflight])
    for (entries, firsts, _), (chains, ns) in zip(inflight, fetched):
        for i, (ji, _) in enumerate(entries):
            results[ji] = _assemble(chains[i], int(ns[i]), int(firsts[i]))
    return results
