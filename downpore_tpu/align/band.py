"""The DTW band update — the hottest loop of base-space consensus.

Semantics decoded from the reference's SSE kernel
(ref: sequence/alignment/asm_amd64.s:17-149, scalar context at
sequence/alignment/alignment.go:357-386):

    raw[i]  = min(poffs[i],                    # step (advance 1 base)
                  poffs[i+1],                  # stay (consensus insertion)
                  poffs[i-1] + ds[i-1],        # skip 1 sequence base
                  poffs[i-2] + ds[i-2] + ds[i-1])  # skip 2
              + ds[i]                          # all adds saturating uint16
    m       = min(raw)
    out[i]  = raw[i] - m  (saturating), then values >= threshold -> 0xFFFF
    return m

Out-of-range predecessors count as 0xFFFF.  ``update_offsets_np`` is the
scalar-shape oracle; ``update_bands`` is the batched jnp version operating
on ``[..., W]`` bands at once — one fused elementwise pass updates every
(state x successor x sequence) band of the beam simultaneously.
"""
from __future__ import annotations

import functools

import numpy as np

MAX_COST = 32767        # maxCost in the reference (uint16 max / 2)
BAND_FULL = 0xFFFF      # lanes pruned by the threshold clamp


def _sat_add(a, b):
    return np.minimum(a.astype(np.uint32) + b.astype(np.uint32), 0xFFFF) \
        .astype(np.uint16)


def update_offsets_np(ds: np.ndarray, poffs: np.ndarray,
                      threshold: int):
    """Numpy oracle of updateOffsetsAsm over ``[..., W]`` bands.

    Returns (out, min_cost) where min_cost has shape ``[...]``.
    """
    ds = np.asarray(ds, dtype=np.uint16)
    poffs = np.asarray(poffs, dtype=np.uint16)
    W = poffs.shape[-1]
    full = np.full(poffs.shape[:-1] + (1,), BAND_FULL, np.uint16)

    step = poffs
    stay = np.concatenate([poffs[..., 1:], full], axis=-1)
    skip1 = np.concatenate(
        [full, _sat_add(poffs, ds)[..., :-1]], axis=-1)
    two = _sat_add(_sat_add(poffs, ds)[..., :-1], ds[..., 1:])
    skip2 = np.concatenate([full, full, two[..., :-1]], axis=-1)

    best = np.minimum(np.minimum(step, stay), np.minimum(skip1, skip2))
    raw = _sat_add(best, ds)
    m = raw.min(axis=-1)
    out = (raw.astype(np.int64) - m[..., None]).clip(0).astype(np.uint16)
    out = np.where(out >= threshold, BAND_FULL, out).astype(np.uint16)
    return out, m


def update_bands(ds, poffs, threshold: int):
    """jnp twin of ``update_offsets_np`` (int32 lanes; same semantics with
    saturation at 0xFFFF).  Shapes ``[..., W]``; fully batched."""
    import jax.numpy as jnp

    ds = ds.astype(jnp.int32)
    poffs = poffs.astype(jnp.int32)
    full = jnp.full(poffs.shape[:-1] + (1,), BAND_FULL, jnp.int32)

    sat = lambda x: jnp.minimum(x, BAND_FULL)
    step = poffs
    stay = jnp.concatenate([poffs[..., 1:], full], axis=-1)
    skip1 = jnp.concatenate([full, sat(poffs + ds)[..., :-1]], axis=-1)
    two = sat(sat(poffs + ds)[..., :-1] + ds[..., 1:])
    skip2 = jnp.concatenate([full, full, two[..., :-1]], axis=-1)
    best = jnp.minimum(jnp.minimum(step, stay), jnp.minimum(skip1, skip2))
    raw = sat(best + ds)
    m = raw.min(axis=-1)
    out = jnp.maximum(raw - m[..., None], 0)
    out = jnp.where(out >= threshold, BAND_FULL, out)
    return out, m
