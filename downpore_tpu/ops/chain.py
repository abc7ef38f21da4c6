"""Batched in-order seed chaining as an anchor DP on device.

The reference chains exact seed matches with a greedy left-to-right walk,
one (query, target) pair at a time, under the gap-ratio window
``gap_b in [2/3*gap_a - k, 3/2*gap_a + k]`` (negative query gaps allow
``[-k, 0]``) (ref: seeds/sequence.go:401-576, seeds/alignment.go:411-424).

Here chaining is a dynamic program over *anchors* — (i, j) pairs with
``query_seed[i] == target_seed[j]`` — batched over many pairs at once and
vectorized across anchors as elementwise array ops.  A forward and a
backward pass give, for every anchor, the best chain through it, its
covered bases (the identity measure of seeds/sequence.go:830) and the
propagated chain start/end coordinates; hosts aggregate those into
earliest/latest extents exactly where the reference iterates its chain
list.  The DP finds optimal chains, so chain lengths are >= the
reference's greedy result under the identical window rule.

Shapes: a batch is ``[P, NA]`` anchors (padded with -1) built from
``[P, NQ]`` query seeds and ``[P, NT]`` target seeds (padded with -1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10 ** 9)  # sentinel for masked scores (kept a python int so that
                  # importing this module never initializes a backend)


def make_anchors(qseeds, qpos, tseeds, tpos, max_anchors: int):
    """Enumerate matching (i, j) seed pairs in row-major order.

    All args are ``[P, N]`` int32, padded with seed id -1.  Returns a dict
    of ``[P, max_anchors]`` arrays: ``qi, tj, qp, tp, valid``.  Anchors
    beyond ``max_anchors`` are dropped (callers size generously; the
    overflow count is returned for diagnostics).
    """

    def per_pair(qs, qp, ts, tp):
        eq = (qs[:, None] == ts[None, :]) & (qs[:, None] >= 0) & (ts[None, :] >= 0)
        qi, tj = jnp.nonzero(eq, size=max_anchors, fill_value=-1)
        valid = qi >= 0
        qpos_a = jnp.where(valid, qp[jnp.clip(qi, 0)], 0)
        tpos_a = jnp.where(valid, tp[jnp.clip(tj, 0)], 0)
        overflow = jnp.sum(eq) - jnp.sum(valid)
        return qi.astype(jnp.int32), tj.astype(jnp.int32), \
            qpos_a.astype(jnp.int32), tpos_a.astype(jnp.int32), valid, overflow

    qi, tj, qp, tp, valid, overflow = jax.vmap(per_pair)(qseeds, qpos, tseeds, tpos)
    return {"qi": qi, "tj": tj, "qp": qp, "tp": tp, "valid": valid,
            "overflow": overflow}


def make_anchors_topk(qseeds, qpos, tseeds, tpos, per_seed: int = 2):
    """Anchor enumeration capped at ``per_seed`` occurrences per query
    seed — no sort/cumsum (memory-lean, for big fused batches).

    Returns the same dict as ``make_anchors`` with
    ``max_anchors = NQ * per_seed`` anchors in (i, j) row-major order.  A
    query seed repeated more than ``per_seed`` times in the target
    contributes only its first occurrences; chains through later repeats
    are lost (rare, and the DP has the earlier candidates).
    """
    P, NQ = qseeds.shape
    eq = (qseeds[:, :, None] == tseeds[:, None, :]) \
        & (qseeds[:, :, None] >= 0) & (tseeds[:, None, :] >= 0)
    iota_t = jax.lax.broadcasted_iota(jnp.int32, eq.shape, 2)
    js = []
    cur = eq
    # gather-free: the hit flag is any() (== the value at argmax for
    # bools), and the target position comes through a one-hot reduction
    # instead of a take_along_axis
    for _ in range(per_seed):
        j = jnp.argmax(cur, axis=2)                      # [P, NQ]
        hit = jnp.any(cur, axis=2)
        oh = iota_t == j[:, :, None]
        tp_j = jnp.sum(jnp.where(oh, tpos[:, None, :], 0), axis=2)
        js.append((j, hit, tp_j))
        cur = cur & ~oh
    qi = jnp.broadcast_to(jnp.arange(NQ)[None, :, None],
                          (P, NQ, per_seed))
    tj = jnp.stack([j for j, _, _ in js], axis=2)        # [P, NQ, per_seed]
    valid = jnp.stack([h for _, h, _ in js], axis=2)
    tp_a = jnp.stack([t for _, _, t in js], axis=2)
    A = NQ * per_seed
    qi = qi.reshape(P, A).astype(jnp.int32)
    tj = tj.reshape(P, A).astype(jnp.int32)
    valid = valid.reshape(P, A)
    qi = jnp.where(valid, qi, -1)
    # qi is the broadcast NQ iota, so the query position is a repeat, not
    # a gather
    qp_rep = jnp.repeat(qpos, per_seed, axis=1)          # [P, NQ*per_seed]
    qp = jnp.where(valid, qp_rep, 0).astype(jnp.int32)
    tp = jnp.where(valid, tp_a.reshape(P, A), 0).astype(jnp.int32)
    return {"qi": qi, "tj": tj, "qp": qp, "tp": tp, "valid": valid,
            "overflow": jnp.sum(eq, axis=(1, 2)) - jnp.sum(valid, axis=1)}


def _window_ok(gap_q, gap_t, k, variant: str = "extend"):
    """Gap compatibility windows.

    ``extend``: the Match/extendChain window (ref: seeds/sequence.go:489),
    computed from the query gap and applied to the target gap.
    ``aligner``: the seedAligner window (ref: seeds/alignment.go:411-424),
    computed from the *target* gap and applied to the query gap, with its
    clamps (short gaps widen to [0, 20]).
    Integer divisions truncate toward zero; inputs on the ratio branch are
    >= 0 so floor == trunc."""
    if variant == "extend":
        neg = (gap_t >= -k) & (gap_t <= 0)
        pos = (gap_t >= (gap_q * 2) // 3 - k) & (gap_t <= (gap_q * 3) // 2 + k)
        return jnp.where(gap_q < 0, neg, pos)
    g = gap_t
    min_gap = (g * 2) // 3 - k
    max_gap = (g * 3) // 2 + k + 1
    neg_min = min_gap < 0
    min_gap = jnp.where(neg_min, -k, jnp.where(max_gap < 20, 0, min_gap))
    max_gap = jnp.where(neg_min, jnp.maximum(max_gap, 0),
                        jnp.where(max_gap < 20, 20, max_gap))
    return (gap_q >= min_gap) & (gap_q <= max_gap)


def _chain_scan(qi, tj, qp, tp, valid, k: int, variant: str = "extend",
                small: bool = False):
    """Forward anchor DP for one pair.  Returns per-anchor:
    score (chain length), cov_q/cov_t (bases covered), start_qp/start_tp
    (positions of the chain's first anchor), bp (chosen predecessor anchor
    index, -1 for chain starts).

    With ``small`` the carried state and anchor arrays are int16 — the
    scan is HBM-bound (every step re-reads ~11 [pairs, anchors] arrays),
    so halving the element size nearly halves the DP.  Safe whenever all
    positions are < 16384 (gap ratios stay in int32; the fused trim/map/
    overlap engines bound positions by window/chunk size)."""
    n = qi.shape[0]

    dt = jnp.int16 if small else jnp.int32
    neg = jnp.asarray(-(2 ** 14) if small else NEG, dt)
    if small:
        qi, tj, qp, tp = (a.astype(dt) for a in (qi, tj, qp, tp))
    idx = jnp.arange(n)
    kd = jnp.asarray(k, dt)

    def body(t, state):
        # every dynamic-index access here is phrased gather-free (argmax
        # folded into max, predecessor fields read through a one-hot
        # select, the column write as a masked select), so under vmap the
        # step stays elementwise instead of lowering to gather/scatter
        score, cov_q, cov_t, s_qp, s_tp, bp = state
        gap_q = qp[t] - qp - kd
        gap_t = tp[t] - tp - kd
        # ratio windows in int32 (gap*3 can exceed int16)
        ok = (idx < t) & valid & (qi < qi[t]) & (tj < tj[t]) \
            & _window_ok(gap_q.astype(jnp.int32),
                         gap_t.astype(jnp.int32), k, variant) & (score > 0)
        cand = jnp.where(ok, score, neg)
        best = jnp.argmax(cand)
        best_score = jnp.max(cand)
        has_prev = best_score > 0
        sel = idx == best
        zero = jnp.asarray(0, dt)
        # jnp.sum promotes sub-int32 accumulators; cast back so the carry
        # dtype is stable under fori_loop
        pick = lambda a: jnp.sum(jnp.where(sel, a, zero)).astype(dt)
        new_score = jnp.where(has_prev, best_score + 1, 1).astype(dt)
        new_cov_q = jnp.where(has_prev,
                              pick(cov_q) + kd
                              + jnp.minimum(zero, pick(gap_q)), kd)
        new_cov_t = jnp.where(has_prev,
                              pick(cov_t) + kd
                              + jnp.minimum(zero, pick(gap_t)), kd)
        new_s_qp = jnp.where(has_prev, pick(s_qp), qp[t])
        new_s_tp = jnp.where(has_prev, pick(s_tp), tp[t])
        new_bp = jnp.where(has_prev, best.astype(dt), -1)
        v = valid[t]
        at_t = idx == t
        score = jnp.where(at_t, jnp.where(v, new_score, 0), score)
        cov_q = jnp.where(at_t, jnp.where(v, new_cov_q, 0), cov_q)
        cov_t = jnp.where(at_t, jnp.where(v, new_cov_t, 0), cov_t)
        s_qp = jnp.where(at_t, jnp.where(v, new_s_qp, 0), s_qp)
        s_tp = jnp.where(at_t, jnp.where(v, new_s_tp, 0), s_tp)
        bp = jnp.where(at_t, jnp.where(v, new_bp, -1), bp)
        return score, cov_q, cov_t, s_qp, s_tp, bp

    init = (jnp.zeros(n, dt),) * 5 + (jnp.full(n, -1, dt),)
    out = jax.lax.fori_loop(0, n, body, init, unroll=8)
    if small:
        out = tuple(a.astype(jnp.int32) for a in out)
    return out


def _chain_scan_lean(qi, tj, qp, tp, valid, k: int,
                     variant: str = "extend", small: bool = False):
    """Forward-only anchor DP carrying just (score, bp).

    The overlap path consumes only the forward chain lengths and
    backpointers (the walk reconstructs coordinates), so the full scan's
    4 extra carried arrays (cov_q/cov_t/start_qp/start_tp) and their
    per-step one-hot picks — plus the entire backward pass — are pure
    overhead there.  Identical recurrence => identical f/bp."""
    n = qi.shape[0]
    dt = jnp.int16 if small else jnp.int32
    neg = jnp.asarray(-(2 ** 14) if small else NEG, dt)
    if small:
        qi, tj, qp, tp = (a.astype(dt) for a in (qi, tj, qp, tp))
    idx = jnp.arange(n)
    kd = jnp.asarray(k, dt)

    def body(t, state):
        score, bp = state
        gap_q = qp[t] - qp - kd
        gap_t = tp[t] - tp - kd
        ok = (idx < t) & valid & (qi < qi[t]) & (tj < tj[t]) \
            & _window_ok(gap_q.astype(jnp.int32),
                         gap_t.astype(jnp.int32), k, variant) & (score > 0)
        cand = jnp.where(ok, score, neg)
        best = jnp.argmax(cand)
        best_score = jnp.max(cand)
        has_prev = best_score > 0
        new_score = jnp.where(has_prev, best_score + 1, 1).astype(dt)
        new_bp = jnp.where(has_prev, best.astype(dt), -1)
        v = valid[t]
        at_t = idx == t
        score = jnp.where(at_t, jnp.where(v, new_score, 0), score)
        bp = jnp.where(at_t, jnp.where(v, new_bp, -1), bp)
        return score, bp

    init = (jnp.zeros(n, dt), jnp.full(n, -1, dt))
    # unroll: the per-iteration launch overhead of the sequential loop
    # dominates at production widths (a budget sweep measured the fused
    # overlap kernel ~flat in budget — ~50 ms of fixed per-step cost)
    score, bp = jax.lax.fori_loop(0, n, body, init, unroll=8)
    if small:
        score, bp = score.astype(jnp.int32), bp.astype(jnp.int32)
    return score, bp


def _chain_scan_lean_lvl(qi, tj, qp, tp, valid, k: int,
                         variant: str = "extend", small: bool = False,
                         ps: int = 2):
    """``_chain_scan_lean`` with the scan LEVEL-SYNCHRONOUS over query
    seeds: anchors from ``make_anchors_topk`` are qi-major with ``ps``
    occurrences per query seed, same-level anchors can never chain to
    each other (the recurrence requires qi[p] < qi[t], which also
    subsumes the sequential ``idx < t`` guard), so all ``ps`` anchors of
    a level update together from the pre-level state — A/ps sequential
    steps instead of A at identical results."""
    n = qi.shape[0]
    nq = n // ps
    dt = jnp.int16 if small else jnp.int32
    neg = jnp.asarray(-(2 ** 14) if small else NEG, dt)
    if small:
        qi, tj, qp, tp = (a.astype(dt) for a in (qi, tj, qp, tp))
    idx = jnp.arange(n)
    lvl = idx // ps
    kd = jnp.asarray(k, dt)
    qp2 = qp.reshape(nq, ps)
    tp2 = tp.reshape(nq, ps)
    tj2 = tj.reshape(nq, ps)
    vd2 = valid.reshape(nq, ps)

    def body(j, state):
        score, bp = state
        at_lvl = lvl == j
        news = []
        newb = []
        for occ in range(ps):
            gap_q = qp2[j, occ] - qp - kd
            gap_t = tp2[j, occ] - tp - kd
            ok = (qi.astype(jnp.int32) < j) & valid \
                & (tj < tj2[j, occ]) \
                & _window_ok(gap_q.astype(jnp.int32),
                             gap_t.astype(jnp.int32), k, variant) \
                & (score > 0)
            cand = jnp.where(ok, score, neg)
            best = jnp.argmax(cand)
            best_score = jnp.max(cand)
            has_prev = best_score > 0
            news.append(jnp.where(
                vd2[j, occ],
                jnp.where(has_prev, best_score + 1, 1).astype(dt),
                jnp.asarray(0, dt)))
            newb.append(jnp.where(
                vd2[j, occ],
                jnp.where(has_prev, best.astype(dt), -1),
                jnp.asarray(-1, dt)))
        sc = score
        b = bp
        for occ in range(ps):
            sel = at_lvl & (idx % ps == occ)
            sc = jnp.where(sel, news[occ], sc)
            b = jnp.where(sel, newb[occ], b)
        return sc, b

    init = (jnp.zeros(n, dt), jnp.full(n, -1, dt))
    score, bp = jax.lax.fori_loop(0, nq, body, init, unroll=8)
    if small:
        score, bp = score.astype(jnp.int32), bp.astype(jnp.int32)
    return score, bp


def dp_forward_lean(anchors, k: int, variant: str = "extend",
                    small: bool = False, level_ps: int = 0):
    """Forward-only chain DP (see ``_chain_scan_lean``): returns a dict
    with ``qi, tj, f, bp`` — exactly what the overlap best-chain walk
    consumes, at ~1/4 the device traffic of ``dp_from_anchors``.
    ``level_ps``: anchors are qi-major with that many occurrences per
    query seed (make_anchors_topk layout) — enables the level-
    synchronous scan at half the sequential depth.  Production call
    sites leave it off."""
    qi, tj, qp, tp, valid = (anchors["qi"], anchors["tj"], anchors["qp"],
                             anchors["tp"], anchors["valid"])
    if level_ps:
        fwd = jax.vmap(_chain_scan_lean_lvl,
                       in_axes=(0, 0, 0, 0, 0, None, None, None, None))
        f, bp = fwd(qi, tj, qp, tp, valid, k, variant, small, level_ps)
    else:
        fwd = jax.vmap(_chain_scan_lean,
                       in_axes=(0, 0, 0, 0, 0, None, None, None))
        f, bp = fwd(qi, tj, qp, tp, valid, k, variant, small)
    return {"qi": qi, "tj": tj, "f": f, "bp": bp}


def _chain_scan_lvl(qi, tj, qp, tp, valid, k: int,
                    variant: str = "extend", small: bool = False,
                    ps: int = 2):
    """Level-synchronous twin of ``_chain_scan`` (see
    ``_chain_scan_lean_lvl`` for the equivalence argument): identical
    outputs at A/ps sequential steps."""
    n = qi.shape[0]
    nq = n // ps
    dt = jnp.int16 if small else jnp.int32
    neg = jnp.asarray(-(2 ** 14) if small else NEG, dt)
    if small:
        qi, tj, qp, tp = (a.astype(dt) for a in (qi, tj, qp, tp))
    idx = jnp.arange(n)
    lvl = idx // ps
    kd = jnp.asarray(k, dt)
    zero = jnp.asarray(0, dt)
    qp2 = qp.reshape(nq, ps)
    tp2 = tp.reshape(nq, ps)
    tj2 = tj.reshape(nq, ps)
    vd2 = valid.reshape(nq, ps)

    def body(j, state):
        score, cov_q, cov_t, s_qp, s_tp, bp = state
        at_lvl = lvl == j
        ups = []
        for occ in range(ps):
            gap_q = qp2[j, occ] - qp - kd
            gap_t = tp2[j, occ] - tp - kd
            ok = (qi.astype(jnp.int32) < j) & valid \
                & (tj < tj2[j, occ]) \
                & _window_ok(gap_q.astype(jnp.int32),
                             gap_t.astype(jnp.int32), k, variant) \
                & (score > 0)
            cand = jnp.where(ok, score, neg)
            best = jnp.argmax(cand)
            best_score = jnp.max(cand)
            has_prev = best_score > 0
            sel = idx == best
            pick = lambda a: jnp.sum(jnp.where(sel, a, zero)).astype(dt)
            v = vd2[j, occ]
            ups.append((
                jnp.where(v, jnp.where(has_prev, best_score + 1,
                                       1).astype(dt), zero),
                jnp.where(v, jnp.where(has_prev, pick(cov_q) + kd
                                       + jnp.minimum(zero, pick(gap_q)),
                                       kd), zero),
                jnp.where(v, jnp.where(has_prev, pick(cov_t) + kd
                                       + jnp.minimum(zero, pick(gap_t)),
                                       kd), zero),
                jnp.where(v, jnp.where(has_prev, pick(s_qp),
                                       qp2[j, occ]), zero),
                jnp.where(v, jnp.where(has_prev, pick(s_tp),
                                       tp2[j, occ]), zero),
                jnp.where(v, jnp.where(has_prev, best.astype(dt), -1),
                          jnp.asarray(-1, dt))))
        outs = [score, cov_q, cov_t, s_qp, s_tp, bp]
        for occ in range(ps):
            sel = at_lvl & (idx % ps == occ)
            outs = [jnp.where(sel, u, o) for u, o in zip(ups[occ], outs)]
        return tuple(outs)

    init = (jnp.zeros(n, dt),) * 5 + (jnp.full(n, -1, dt),)
    out = jax.lax.fori_loop(0, nq, body, init, unroll=8)
    if small:
        out = tuple(a.astype(jnp.int32) for a in out)
    return out


def dp_from_anchors(anchors, k: int, variant: str = "extend",
                    small: bool = False, level_ps: int = 0):
    """Forward + backward chain DP over a prepared anchor batch.

    Returns a dict of ``[P, A]`` arrays:
      qi, tj, qp, tp   anchor coordinates (seed indices / base positions)
      f, b             best chain length ending at / starting from anchor
      through          f + b - 1 (length of best chain passing through)
      cov_q, cov_t     covered bases along that through-chain
      start_qp/tp      positions of the through-chain's first anchor
      end_qp/tp        positions of the through-chain's last anchor
      bp               forward-pass predecessor (-1 at chain starts)
    """
    qi, tj, qp, tp, valid = (anchors["qi"], anchors["tj"], anchors["qp"],
                             anchors["tp"], anchors["valid"])

    if level_ps:
        # qi-major / level_ps-minor layout (make_anchors_topk): the
        # level-synchronous scan halves the sequential depth.  The
        # reversed backward arrays keep the level structure (pairs map
        # to pairs under reversal; A is a level_ps multiple).
        fwd = jax.vmap(lambda a, b, c, d, e: _chain_scan_lvl(
            a, b, c, d, e, k, variant, small, level_ps))
    else:
        fwd = jax.vmap(lambda a, b, c, d, e: _chain_scan(
            a, b, c, d, e, k, variant, small))
    f, cov_qf, cov_tf, s_qp, s_tp, bp = fwd(qi, tj, qp, tp, valid)
    # backward pass: reverse anchor order and negate coordinates, turning
    # "best chain starting here" into the same forward recurrence
    rev = lambda x: x[:, ::-1]
    bb, cov_qb, cov_tb, e_qp, e_tp, _ = fwd(rev(-qi), rev(-tj),
                                            rev(-qp), rev(-tp),
                                            rev(valid))
    b, cov_qb, cov_tb = rev(bb), rev(cov_qb), rev(cov_tb)
    e_qp, e_tp = -rev(e_qp), -rev(e_tp)

    through = jnp.where(valid, f + b - 1, 0)
    return {
        "qi": qi, "tj": tj, "qp": qp, "tp": tp, "valid": valid,
        "overflow": anchors["overflow"],
        "f": f, "b": b, "through": through,
        "cov_q": cov_qf + cov_qb - k, "cov_t": cov_tf + cov_tb - k,
        "start_qp": s_qp, "start_tp": s_tp,
        "end_qp": e_qp, "end_tp": e_tp,
        "bp": bp,
    }


@functools.partial(jax.jit, static_argnames=("k", "max_anchors", "variant"))
def chain_batch(qseeds, qpos, tseeds, tpos, k: int, max_anchors: int,
                variant: str = "extend"):
    """make_anchors + dp_from_anchors (see dp_from_anchors docstring)."""
    anchors = make_anchors(qseeds, qpos, tseeds, tpos, max_anchors)
    return dp_from_anchors(anchors, k, variant)


@functools.partial(jax.jit, static_argnames=("k", "max_anchors", "variant",
                                              "top_k"))
def chain_batch_summary(qseeds, qpos, tseeds, tpos, min_match, alen,
                        k: int, max_anchors: int, variant: str = "extend",
                        top_k: int = 4):
    """Chain DP + on-device aggregation.

    Instead of shipping every per-anchor array to the host (16 MB/call),
    this computes the quantities the pipelines actually consume and
    returns ~100 bytes per pair:

      best        length of the best chain
      ident_cov_q max covered query bases over good chains (identity)
      earliest    min over good anchors of (chain-start qp + tp)
      latest      max over good anchors of (end_tp + alen - end_qp - k)
      n_chains    number of distinct good chains (good start anchors)
      top-K good chain starts: their (sqp, stp, eqp, etp, cov_q, cov_t,
      length), ordered by coverage

    ``min_match`` [P] and ``alen`` [P] are per-pair dynamic inputs; "good"
    means a chain within 2/3 of the best and >= min_match long
    (ref: seeds/sequence.go:434-465).
    """
    out = chain_batch(qseeds, qpos, tseeds, tpos, k=k,
                      max_anchors=max_anchors, variant=variant)
    return summarize_dp(out, min_match, alen, k, top_k)


def summarize_scalars(out, min_match, alen, k: int):
    """Per-pair scalar aggregates of a DP output dict: the quantities the
    pipelines' decision rules consume (see chain_batch_summary)."""
    through = out["through"]
    valid = out["valid"]
    big = jnp.int32(1 << 30)
    best = jnp.max(jnp.where(valid, through, 0), axis=1)
    thr = jnp.maximum(min_match[:, None], (best[:, None] * 2) // 3)
    good = valid & (through >= thr) & (through >= min_match[:, None])
    ident_cov_q = jnp.max(jnp.where(good, out["cov_q"], 0), axis=1)
    starts_sum = out["start_qp"] + out["start_tp"]
    earliest = jnp.min(jnp.where(good, starts_sum, big), axis=1)
    ends = out["end_tp"] + (alen[:, None] - out["end_qp"] - k)
    latest = jnp.max(jnp.where(good, ends, -big), axis=1)
    is_start = good & (out["f"] == 1)
    n_chains = jnp.sum(is_start, axis=1)
    return {"best": best, "ident_cov_q": ident_cov_q, "earliest": earliest,
            "latest": latest, "n_chains": n_chains, "good": good,
            "is_start": is_start}


def summarize_dp(out, min_match, alen, k: int, top_k: int = 4,
                 lean: bool = False):
    """On-device aggregation of a DP output dict into the packed summary
    array (see chain_batch_summary).

    ``lean`` packs only the columns the mapper's candidate walk consumes
    (best + top-K valid/sqp/stp/eqp/etp/cov_t/len — 1 + 7K instead of
    5 + 8K): a smaller device->host fetch per row, and the dropped
    aggregates (ident_cov_q, earliest, latest, n_chains, top_cov_q) also
    skip their one-hot reductions on device."""
    s = summarize_scalars(out, min_match, alen, k)
    best = s["best"]
    is_start = s["is_start"]
    key = jnp.where(is_start, out["cov_q"], -1)
    _, idx = jax.lax.top_k(key, top_k)
    # one-hot reduction instead of take_along_axis; A is small so the
    # [P, top_k, A] select is cheap
    oh = (jnp.arange(key.shape[1])[None, None, :]
          == idx[:, :, None])                            # [P, top_k, A]
    take = lambda arr: jnp.sum(jnp.where(oh, arr[:, None, :], 0), axis=2)
    # one packed int32 array -> a single device->host fetch per slice
    if lean:
        return jnp.concatenate([
            best[:, None],
            (take(key) >= 0).astype(jnp.int32),
            take(out["start_qp"]), take(out["start_tp"]),
            take(out["end_qp"]), take(out["end_tp"]),
            take(out["cov_t"]), take(out["through"]),
        ], axis=1)
    packed = jnp.concatenate([
        best[:, None], s["ident_cov_q"][:, None], s["earliest"][:, None],
        s["latest"][:, None], s["n_chains"][:, None],
        (take(key) >= 0).astype(jnp.int32),
        take(out["start_qp"]), take(out["start_tp"]),
        take(out["end_qp"]), take(out["end_tp"]),
        take(out["cov_q"]), take(out["cov_t"]), take(out["through"]),
    ], axis=1)
    return packed


def compact_indices(mask_flat, size: int):
    """First ``size`` indices of the set bits of ``mask_flat``,
    ascending, padded with ``len(mask_flat)`` past the count — the
    semantics of ``jnp.nonzero(size=..., fill_value=len)`` — plus the
    total set-bit count.

    The rank of every set bit is a two-level prefix sum (log-depth
    shift-adds within 512-lane blocks, then across block totals) and
    the indices land via one clipped scatter: only elementwise ops and
    a provably bounded scatter, identical to ``jnp.nonzero``."""
    N = mask_flat.shape[0]
    S = min(512, N)
    G = (N + S - 1) // S
    m = mask_flat.astype(jnp.int32)
    if G * S != N:
        m = jnp.concatenate([m, jnp.zeros(G * S - N, jnp.int32)])
    m2 = m.reshape(G, S)
    # inclusive prefix within each block: log-depth shift-adds
    pre = m2
    d = 1
    while d < S:
        pre = pre + jnp.pad(pre, ((0, 0), (d, 0)))[:, :S]
        d *= 2
    totals = pre[:, -1]                                   # [G]
    # exclusive prefix across block totals, same trick
    bt = totals
    d = 1
    while d < G:
        bt = bt + jnp.pad(bt, (d, 0))[:G]
        d *= 2
    block_off = bt - totals                               # exclusive
    n = bt[-1]
    # global rank of each set position; clipped scatter of its index
    rank = block_off[:, None] + pre - 1                   # [G, S]
    idx = jax.lax.broadcasted_iota(jnp.int32, (G, S), 0) * S \
        + jax.lax.broadcasted_iota(jnp.int32, (G, S), 1)
    dest = jnp.where(m2 > 0, rank, size)                  # dead -> scratch
    sel = jnp.full(size + 1, N, jnp.int32)
    sel = sel.at[jnp.clip(dest.reshape(-1), 0, size)].set(idx.reshape(-1))
    return sel[:size], n


SUMMARY_SCALARS = ["best", "ident_cov_q", "earliest", "latest", "n_chains"]
SUMMARY_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
                "top_cov_q", "top_cov_t", "top_len"]
LEAN_SCALARS = ["best"]
LEAN_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
             "top_cov_t", "top_len"]


def unpack_summary(packed: np.ndarray, top_k: int = 4,
                   lean: bool = False) -> dict:
    """Split the packed summary array back into the named dict."""
    scalars = LEAN_SCALARS if lean else SUMMARY_SCALARS
    tops = LEAN_TOPS if lean else SUMMARY_TOPS
    out = {}
    c = 0
    for name in scalars:
        out[name] = packed[:, c]
        c += 1
    for name in tops:
        out[name] = packed[:, c : c + top_k]
        c += top_k
    out["top_valid"] = out["top_valid"].astype(bool)
    return out


@functools.partial(jax.jit, static_argnames=("k", "max_anchors", "variant",
                                              "top_k"))
def chain_summary_indexed(a_seeds, a_pos, a_len, aidx, mm, ts, tp,
                          k: int, max_anchors: int,
                          variant: str = "extend", top_k: int = 4):
    """``chain_batch_summary`` with the query side resident on device.

    ``a_seeds``/``a_pos`` are per-adapter tables ``[A, nq]`` that live on
    the device across calls; each pair ships only its adapter index, its
    min-match threshold and an int16 target list — an order of magnitude
    less host->device traffic than re-sending padded query arrays every
    call."""
    qs = a_seeds[aidx].astype(jnp.int32)
    qp = a_pos[aidx].astype(jnp.int32)
    alen = a_len[aidx]
    return chain_batch_summary(qs, qp, ts.astype(jnp.int32),
                               tp.astype(jnp.int32), mm, alen, k=k,
                               max_anchors=max_anchors, variant=variant,
                               top_k=top_k)


class DeviceAdapterTables:
    """Device-resident padded adapter seed/position tables plus one
    compiled indexed-summary entry point."""

    def __init__(self, adapters, k: int, nq: int, seed_dtype=np.int16):
        import jax as _jax
        A = len(adapters)
        seeds = np.full((A, nq), -1, seed_dtype)
        pos = np.zeros((A, nq), np.int16)
        alen = np.zeros(A, np.int32)
        for i, ad in enumerate(adapters):
            m = min(ad.num_seeds, nq)
            seeds[i, :m] = ad.seeds[:m]
            pos[i, :m] = ad.seed_positions(k)[:m]
            alen[i] = ad.length
        self.a_seeds = _jax.device_put(seeds)
        self.a_pos = _jax.device_put(pos)
        self.a_len = _jax.device_put(alen)
        self.k = k
        self.nq = nq

    def run(self, aidx_list, mm_list, tseeds_list, tpos_list, nt: int,
            max_anchors: int, variant: str = "extend", top_k: int = 4,
            max_pairs: int = 8192):
        """Sliced indexed summary over (adapter index, target list) pairs.

        All slices are dispatched before any result is fetched, so
        host packing, host->device transfers and device compute pipeline
        instead of paying a full round trip per slice."""
        P = len(aidx_list)
        if P == 0:
            return None

        def pack16(lists, lo, n, PB, width, fill):
            out = np.full((PB, width), fill, np.int16)
            chunk = [np.asarray(lists[lo + i][:width]) for i in range(n)]
            lens = np.fromiter((c.shape[0] for c in chunk), np.int64, n)
            if lens.sum():
                flat = np.concatenate(chunk)
                rows = np.repeat(np.arange(n), lens)
                ends = np.cumsum(lens)
                cols = np.arange(lens.sum()) - np.repeat(ends - lens, lens)
                out[rows, cols] = flat
            return out

        def dispatch(lo, hi):
            n = hi - lo
            PB = _bucket(n) if hi - lo < max_pairs else max_pairs
            aidx = np.zeros(PB, np.int32)
            aidx[:n] = aidx_list[lo:hi]
            mm = np.ones(PB, np.int32)
            mm[:n] = mm_list[lo:hi]
            ts = pack16(tseeds_list, lo, n, PB, nt, -1)
            tp = pack16(tpos_list, lo, n, PB, nt, 0)
            return n, chain_summary_indexed(
                self.a_seeds, self.a_pos, self.a_len, aidx, mm, ts, tp,
                k=self.k, max_anchors=max_anchors,
                variant=variant, top_k=top_k)

        futures = [dispatch(lo, min(lo + max_pairs, P))
                   for lo in range(0, P, max_pairs)]
        parts = [unpack_summary(np.asarray(out)[:n])
                 for n, out in futures]
        if len(parts) == 1:
            return parts[0]
        return {key: np.concatenate([p[key] for p in parts])
                for key in parts[0]}


def run_chain_summary(qseeds_list, qpos_list, tseeds_list, tpos_list,
                      min_match_list, alen_list, k: int, nq: int, nt: int,
                      max_anchors: int, variant: str = "extend",
                      top_k: int = 4, max_pairs: int = 2048, mesh=None):
    """Host wrapper for ``chain_batch_summary`` with the same padding /
    slicing behaviour as ``run_chain_batch``.  With ``mesh``, pair
    batches shard across its ``data`` axis (multi-chip data parallel)."""
    P = len(qseeds_list)
    if P == 0:
        return None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        data_sh = NamedSharding(mesh, PartitionSpec("data"))
        D = mesh.shape["data"]
    else:
        data_sh = D = None

    def pack(lists, lo, n, PB, width, fill):
        out = np.full((PB, width), fill, np.int32)
        chunk = [np.asarray(lists[lo + i][:width]) for i in range(n)]
        lens = np.fromiter((c.shape[0] for c in chunk), np.int64, n)
        if lens.sum() == 0:
            return out
        flat = np.concatenate(chunk)
        rows = np.repeat(np.arange(n), lens)
        ends = np.cumsum(lens)
        cols = np.arange(lens.sum()) - np.repeat(ends - lens, lens)
        out[rows, cols] = flat
        return out

    def one(lo, hi):
        n = hi - lo
        PB = _bucket(n) if hi - lo < max_pairs else max_pairs
        if D is not None:
            PB = ((PB + D - 1) // D) * D
        qs = pack(qseeds_list, lo, n, PB, nq, -1)
        qp = pack(qpos_list, lo, n, PB, nq, 0)
        ts = pack(tseeds_list, lo, n, PB, nt, -1)
        tp = pack(tpos_list, lo, n, PB, nt, 0)
        mm = np.ones(PB, np.int32)
        mm[:n] = min_match_list[lo:hi]
        al = np.zeros(PB, np.int32)
        al[:n] = alen_list[lo:hi]
        if data_sh is not None:
            qs, qp, ts, tp, mm, al = (
                jax.device_put(a, data_sh)
                for a in (qs, qp, ts, tp, mm, al))
        out = chain_batch_summary(qs, qp, ts, tp, mm, al, k=k,
                                  max_anchors=max_anchors, variant=variant,
                                  top_k=top_k)
        return unpack_summary(np.asarray(out)[:n], top_k)

    if P <= max_pairs:
        return one(0, P)
    parts = [one(lo, min(lo + max_pairs, P))
             for lo in range(0, P, max_pairs)]
    return {key: np.concatenate([p[key] for p in parts])
            for key in parts[0]}


def extract_best_chain(out, pair_idx: int):
    """Recover the best chain's (query_seed_idx, target_seed_idx) lists by
    walking forward-pass backpointers from the best-scoring anchor."""
    f = out["f"][pair_idx]
    if int(f.max(initial=0)) == 0:
        return [], []
    a = int(np.argmax(f))
    bp = out["bp"][pair_idx]
    qi = out["qi"][pair_idx]
    tj = out["tj"][pair_idx]
    ma, mb = [], []
    while a >= 0:
        ma.append(int(qi[a]))
        mb.append(int(tj[a]))
        a = int(bp[a])
    return ma[::-1], mb[::-1]


def _use_fixed_buckets() -> bool:
    """On an accelerator every distinct jit shape is a fresh compile of
    seconds, so pair batches pad to a few fixed sizes.  On the CPU small
    power-of-two buckets keep tests fast."""
    return jax.default_backend() != "cpu"


def _bucket(n: int) -> int:
    """Round a batch size up to a bucket so jit caches stay warm."""
    if _use_fixed_buckets():
        # one small bucket besides the 2048 grid: the mapper's mapNext /
        # split stages dispatch tens of queries, and padding those to
        # 2048 rows made every follow-up stage cost as much as a full
        # batch (one extra compile variant buys a ~10x cheaper dispatch)
        if n <= 256:
            return 256
        # middle bucket: overlap rounds dispatch ~700 queries — padding
        # those to 2048 rows tripled the fused kernel's row axis
        if n <= 1024:
            return 1024
        return 2048 if n <= 2048 else ((n + 2047) // 2048) * 2048
    b = 8
    while b < n:
        b *= 2
    return b


def run_chain_batch(qseeds_list, qpos_list, tseeds_list, tpos_list, k: int,
                    nq: int, nt: int, max_anchors: int,
                    variant: str = "extend", max_pairs: int = 2048,
                    keys=None, mesh=None):
    """Host wrapper: pad a list of (query, target) seed/position vectors to
    fixed shapes, run ``chain_batch`` on device, return numpy outputs
    truncated back to the true pair count.

    Queries/targets longer than nq/nt are truncated (callers choose shapes
    to make this rare and can check ``overflow``).  Batches larger than
    ``max_pairs`` are processed in fixed-size slices so jit shape buckets
    stay small and bounded.
    """
    P = len(qseeds_list)
    if P == 0:
        return None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        data_sh = NamedSharding(mesh, PartitionSpec("data"))
        D = mesh.shape["data"]
    else:
        data_sh = D = None

    def pack(lists, lo, n, PB, width, fill):
        """Ragged list-of-arrays -> padded [PB, width] without a per-row
        python loop."""
        out = np.full((PB, width), fill, np.int32)
        chunk = [np.asarray(lists[lo + i][:width]) for i in range(n)]
        lens = np.fromiter((c.shape[0] for c in chunk), np.int64, n)
        if lens.sum() == 0:
            return out
        flat = np.concatenate(chunk)
        rows = np.repeat(np.arange(n), lens)
        ends = np.cumsum(lens)
        cols = np.arange(lens.sum()) - np.repeat(ends - lens, lens)
        out[rows, cols] = flat
        return out

    def one(lo, hi):
        n = hi - lo
        PB = _bucket(n) if hi - lo < max_pairs else max_pairs
        if D is not None:
            PB = ((PB + D - 1) // D) * D
        qs = pack(qseeds_list, lo, n, PB, nq, -1)
        qp = pack(qpos_list, lo, n, PB, nq, 0)
        ts = pack(tseeds_list, lo, n, PB, nt, -1)
        tp = pack(tpos_list, lo, n, PB, nt, 0)
        if data_sh is not None:
            qs, qp, ts, tp = (jax.device_put(a, data_sh)
                              for a in (qs, qp, ts, tp))
        out = chain_batch(qs, qp, ts, tp, k=k, max_anchors=max_anchors,
                          variant=variant)
        if keys is not None:
            out = {key: out[key] for key in keys}
        out = jax.device_get(out)  # one batched transfer
        return {key: v[:n] for key, v in out.items()}

    if P <= max_pairs:
        return one(0, P)
    parts = [one(lo, min(lo + max_pairs, P))
             for lo in range(0, P, max_pairs)]
    return {key: np.concatenate([p[key] for p in parts])
            for key in parts[0]}


def good_chain_stats(out, pair_idx: int, min_match: int):
    """Aggregate one pair's DP arrays the way the reference walks its chain
    list: anchors on chains within 2/3 of the best and >= min_match long
    are 'good' (ref: seeds/sequence.go:434-465).

    Returns (best_len, thr, good_mask) where good_mask selects good
    anchors."""
    through = out["through"][pair_idx]
    valid = out["valid"][pair_idx]
    best = int(through.max(initial=0))
    if best < min_match:
        return best, min_match, np.zeros_like(valid)
    thr = max(min_match, (best * 2) // 3)
    return best, thr, valid & (through >= thr)


# ---------------------------------------------------------------------
# numpy oracle (same DP, scalar loops) for kernel parity tests
# ---------------------------------------------------------------------

def _window_ok_np(gap_q: int, gap_t: int, k: int,
                  variant: str = "extend") -> bool:
    """Scalar twin of ``_window_ok`` (floor division, as ``jnp``)."""
    if variant == "extend":
        if gap_q < 0:
            return -k <= gap_t <= 0
        return (gap_q * 2) // 3 - k <= gap_t <= (gap_q * 3) // 2 + k
    min_gap = (gap_t * 2) // 3 - k
    max_gap = (gap_t * 3) // 2 + k + 1
    if min_gap < 0:
        min_gap, max_gap = -k, max(max_gap, 0)
    elif max_gap < 20:
        min_gap, max_gap = 0, 20
    return min_gap <= gap_q <= max_gap


def chain_pair_np(qseeds, qpos, tseeds, tpos, k: int,
                  variant: str = "extend"):
    """Scalar twin of the forward pass of ``chain_batch`` for one pair.
    Returns (anchors, f, cov_q, cov_t) with anchors as (qi, tj) tuples."""
    anchors = [(i, j) for i in range(len(qseeds)) for j in range(len(tseeds))
               if qseeds[i] >= 0 and qseeds[i] == tseeds[j]]
    n = len(anchors)
    f = [0] * n
    cov_q = [0] * n
    cov_t = [0] * n
    for t in range(n):
        it, jt = anchors[t]
        best, best_score = -1, 0
        for bi in range(t):
            ib, jb = anchors[bi]
            if ib >= it or jb >= jt:
                continue
            gq = qpos[it] - qpos[ib] - k
            gt = tpos[jt] - tpos[jb] - k
            if not _window_ok_np(gq, gt, k, variant):
                continue
            if f[bi] > best_score:
                best_score = f[bi]
                best = bi
        if best >= 0:
            f[t] = best_score + 1
            gq = qpos[it] - qpos[anchors[best][0]] - k
            gt = tpos[jt] - tpos[anchors[best][1]] - k
            cov_q[t] = cov_q[best] + k + min(0, gq)
            cov_t[t] = cov_t[best] + k + min(0, gt)
        else:
            f[t] = 1
            cov_q[t] = k
            cov_t[t] = k
    return anchors, f, cov_q, cov_t
