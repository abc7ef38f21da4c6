"""Multi-chip scaling: device meshes and sharded pipeline steps.

The reference's only parallelism is a goroutine worker pool per read
(ref: trim/trim.go:144, mapping/mapping.go:613); there is no multi-process
or multi-node path.  Here scaling is expressed the JAX way: a
``jax.sharding.Mesh`` with a ``data`` axis (reads/queries data-parallel)
and a ``seed`` axis (the seed-bucket dimension of the inverted index),
with XLA collectives merging partial hit counts — the merge points
identified in SURVEY.md §2.3.

* retrieval: ``V [Q, H] @ M [H, C]``; V sharded (data, seed), M sharded
  (seed, None) -> partial counts psum over the seed axis (NVLink, all
  to all, between the cards of one host).
* chaining: pair batches sharded over ``data`` only (embarrassingly
  parallel DP).
* k-mer histograms: per-shard bincount + psum (ref analogue:
  util/sequtil/kmers.go:34 merge-at-end).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.chain import chain_batch


def make_mesh(n_data: int = None, n_seed: int = 1, devices=None) -> Mesh:
    """A (data, seed) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_seed
    if n_data < 1 or n_data * n_seed > n:
        raise ValueError(
            f"mesh needs n_data x n_seed <= devices: have {n} device(s), "
            f"asked for n_data={n_data} x n_seed={n_seed}")
    dev = np.asarray(devices[: n_data * n_seed]).reshape(n_data, n_seed)
    return Mesh(dev, axis_names=("data", "seed"))


def sharded_hit_counts(mesh: Mesh):
    """Compiled fn: V [Q, H] x M [H, C] -> counts [Q, C] with V sharded
    (data, seed) and M sharded (seed, None); the psum over ``seed`` is the
    collective merge of per-bucket partial counts."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data", "seed"), P("seed", None)),
        out_specs=P("data", None))
    def _counts(v, m):
        part = jax.lax.dot_general(
            v, m, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        return jax.lax.psum(part, "seed")

    return jax.jit(_counts)


def sharded_chain(mesh: Mesh, k: int, max_anchors: int):
    """Compiled fn: chain DP over a pair batch sharded on the data axis."""

    def _chain(qs, qp, ts, tp):
        out = chain_batch(qs, qp, ts, tp, k=k, max_anchors=max_anchors)
        return out["through"], out["cov_q"], out["cov_t"], \
            out["start_qp"], out["start_tp"], out["end_qp"], out["end_tp"]

    shard = NamedSharding(mesh, P(("data", "seed"), None))
    def run(qs, qp, ts, tp):
        args = [jax.device_put(x, shard) for x in (qs, qp, ts, tp)]
        return jax.jit(_chain)(*args)

    return run


def sharded_kmer_histogram(mesh: Mesh, k: int):
    """Compiled fn: kmers [B, L] int32 (padded with -1) -> counts [4**k],
    data-parallel bincount + psum (ref: util/sequtil/kmers.go:34-51)."""
    size = 4 ** k

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=P(("data", "seed"), None),
                       out_specs=P())
    def _hist(kmers):
        flat = kmers.reshape(-1)
        weights = (flat >= 0).astype(jnp.int32)
        local = jnp.zeros(size, jnp.int32).at[jnp.clip(flat, 0)].add(weights)
        return jax.lax.psum(local, ("data", "seed"))

    return jax.jit(_hist)


def sharded_pipeline_step(mesh: Mesh, k: int = 6, max_anchors: int = 64):
    """The full sharded query step: retrieval (data x seed sharded matmul,
    psum over seed) followed by chain DP (data parallel).  This is the
    multi-chip execution shape of the trim/map/overlap inner loop."""
    counts_fn = sharded_hit_counts(mesh)

    def step(V, M, qseeds, qpos, tseeds, tpos):
        counts = counts_fn(V, M)
        out = chain_batch(qseeds, qpos, tseeds, tpos, k=k,
                          max_anchors=max_anchors)
        return counts, out["through"]

    data_shard = NamedSharding(mesh, P(("data",), None))

    def run(V, M, qseeds, qpos, tseeds, tpos):
        V = jax.device_put(V, NamedSharding(mesh, P("data", "seed")))
        M = jax.device_put(M, NamedSharding(mesh, P("seed", None)))
        qseeds, qpos, tseeds, tpos = (
            jax.device_put(x, data_shard)
            for x in (qseeds, qpos, tseeds, tpos))
        return jax.jit(step)(V, M, qseeds, qpos, tseeds, tpos)

    return run
