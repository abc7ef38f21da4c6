"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax

from downpore_tpu.parallel import (make_mesh, sharded_hit_counts,
                                   sharded_pipeline_step,
                                   sharded_kmer_histogram)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    return make_mesh(n_data=4, n_seed=2)


def test_sharded_hit_counts_matches_dense(mesh8):
    rng = np.random.default_rng(0)
    Q, H, C = 16, 512, 64
    V = rng.integers(0, 2, (Q, H)).astype(np.int8)
    M = rng.integers(0, 2, (H, C)).astype(np.int8)
    fn = sharded_hit_counts(mesh8)
    got = np.asarray(fn(V, M))
    want = V.astype(np.int32) @ M.astype(np.int32)
    assert np.array_equal(got, want)


def test_sharded_pipeline_step(mesh8):
    import __graft_entry__ as g
    step = sharded_pipeline_step(mesh8, k=6, max_anchors=64)
    V, M, qs, qp, ts, tp = g._example_args(Q=8)
    counts, through = step(V, M, qs, qp, ts, tp)
    assert counts.shape == (8, M.shape[1])
    # matches the unsharded computation
    want = V.astype(np.int32) @ M.astype(np.int32)
    assert np.array_equal(np.asarray(counts), want)


def test_sharded_kmer_histogram(mesh8):
    rng = np.random.default_rng(1)
    k = 4
    kmers = rng.integers(0, 4 ** k, (8, 100)).astype(np.int32)
    kmers[rng.random((8, 100)) < 0.1] = -1  # padding
    fn = sharded_kmer_histogram(mesh8, k)
    got = np.asarray(fn(kmers))
    flat = kmers[kmers >= 0]
    want = np.bincount(flat, minlength=4 ** k).astype(np.int32)
    assert np.array_equal(got, want)


def test_graft_entry_single_chip():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (8, 64)


def test_graft_dryrun_shapes():
    import __graft_entry__ as g
    g.dryrun_multichip(8)
    g.dryrun_multichip(2)


def test_kmer_occurrences_device_path(mesh8):
    """The PRODUCTION kmer_occurrences routes through the sharded
    device histogram when given a multi-device mesh — counts must
    equal the host bincount exactly."""
    import numpy as np
    from downpore_tpu.core import Sequence
    from downpore_tpu.utils import kmer_occurrences

    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [Sequence.from_string(
        bases[rng.integers(0, 4, int(rng.integers(5, 4000)))]
        .tobytes().decode(), id=i) for i in range(40)]
    k = 6
    host = kmer_occurrences(seqs, k)
    dev = kmer_occurrences(seqs, k, mesh=mesh8)
    assert np.array_equal(host, dev)
