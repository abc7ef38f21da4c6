"""CPU tests of the device paths that run on every accelerator: the bulk
beam-consensus engine against its per-job form, the one-hot window fetch
against a plain gather, the jnp band update and chain scan against their
numpy oracles, the pair-batch bucket policy, the compile-cache location,
and the loud failures (no silent host fallback, no smoke pass off the
card)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from downpore_tpu.align import SimpleMeasure, update_offsets_np
from downpore_tpu.align.band import BAND_FULL, update_bands
from downpore_tpu.ops import chain as chain_mod
from downpore_tpu.ops import dtw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 5


def kmers_of(codes: np.ndarray, k: int = K) -> np.ndarray:
    km = np.zeros(len(codes) - k + 1, np.int64)
    for j in range(k):
        km = (km << 2) | codes[j:j + len(km)]
    return km.astype(np.int32)


def mutate(rng, codes, sub=0.05, ins=0.02, dele=0.02):
    out = []
    for c in codes:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if r < dele + ins + sub:
            out.append((int(c) + int(rng.integers(1, 4))) % 4)
        else:
            out.append(int(c))
    return np.array(out, np.uint8)


def make_jobs(rng, n_jobs, core_len, n_members=4, **err):
    jobs = []
    for _ in range(n_jobs):
        core = rng.integers(0, 4, core_len).astype(np.uint8)
        members = [kmers_of(mutate(rng, core, **err))
                   for _ in range(n_members)]
        jobs.append([m for m in members if len(m) > K])
    return jobs


def per_job_consensus(job, table, k=K):
    """One ``device_consensus`` call per job, padded exactly as
    ``consensus_kmers_bulk`` pads its bucket."""
    N = ((len(job) + 3) // 4) * 4
    L = ((max(len(s) for s in job) + 127) // 128) * 128
    t_max = ((int(L * 1.3) + 32 + 31) // 32) * 32
    seq, lens, first = dtw._pad_job(job, N, L)
    chain, n = jax.device_get(dtw.device_consensus(
        seq, lens, np.asarray(table, np.uint16), first, k=k, beam=4,
        t_max=t_max, threshold=300, gap_cost=8, simple_k=k))
    return dtw._assemble(chain, int(n), first)


def _mixed_member_jobs(rng):
    jobs = make_jobs(rng, 4, 50, n_members=8, sub=0.05, ins=0.01,
                     dele=0.01)
    jobs[1] = jobs[1][:5]
    jobs[2] = jobs[2][:6] + jobs[2][:1]
    jobs.append([])                      # empty job -> empty result
    return jobs


JOB_FAMILIES = {
    "substitutions": lambda rng: make_jobs(rng, 4, 60, sub=0.06, ins=0.0,
                                           dele=0.0),
    "indels": lambda rng: make_jobs(rng, 4, 60, sub=0.03, ins=0.03,
                                    dele=0.03),
    # systematic deletions force drift recentring and window re-basing
    "deletion_drift": lambda rng: make_jobs(rng, 4, 70, sub=0.02, ins=0.0,
                                            dele=0.08),
    # ~600-base cores pad L to 640 > WINW, so the window base goes nonzero
    "long_cores": lambda rng: make_jobs(rng, 2, 600, n_members=3,
                                        sub=0.04, ins=0.01, dele=0.01),
    "mixed_member_counts": _mixed_member_jobs,
}


@pytest.mark.parametrize("family", sorted(JOB_FAMILIES))
def test_bulk_consensus_matches_per_job(family):
    rng = np.random.default_rng(sorted(JOB_FAMILIES).index(family) + 10)
    jobs = JOB_FAMILIES[family](rng)
    table = SimpleMeasure(K).pair_table()
    bulk = dtw.consensus_kmers_bulk(jobs, table, K, simple_k=K)
    assert len(bulk) == len(jobs)
    for job, got in zip(jobs, bulk):
        job = [s for s in job if len(s)]
        if not job:
            assert got.size == 0
            continue
        want = per_job_consensus(job, table)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [6, 7])
def test_window_fetch_matches_gather(k):
    """k-mer values up to 4^k - 1 > 2047 must come through the one-hot
    contraction exactly, including starts off either end of the matrix."""
    rng = np.random.default_rng(k)
    N, L, B = 5, 300, 3
    seq = rng.integers(0, 4 ** k, (N, L)).astype(np.int32)
    seq[:, -7:] = -1
    seq[:, :3] = 4 ** k - 1
    padded = np.full((N, L + 2 * dtw.W), -1, np.int32)
    padded[:, dtw.W:dtw.W + L] = seq
    windmat = dtw._window_matrix(jnp.asarray(padded))
    o = rng.integers(-20, L + dtw.W + 20, (B, N)).astype(np.int32)
    got = np.asarray(jax.jit(dtw._fetch_window)(windmat, o))
    want = np.asarray(dtw._fetch_window_gather(windmat, o))
    assert np.array_equal(got, want)
    # and the gather twin reads the padded rows directly
    inside = (o >= 0) & (o // dtw.G < windmat.shape[1])
    b, n = np.nonzero(inside)
    cols = np.minimum(o[b, n][:, None] + np.arange(dtw.W),
                      padded.shape[1] - 1)
    assert np.array_equal(want[b, n], padded[n[:, None], cols])


@pytest.mark.parametrize("threshold", [300, 60])
def test_update_bands_matches_np_with_full_lanes(threshold):
    rng = np.random.default_rng(21 + threshold)
    B, W = 37, 32
    ds = rng.integers(0, 40, (B, W)).astype(np.int32)
    poffs = rng.integers(0, 500, (B, W)).astype(np.int32)
    poffs[rng.random((B, W)) < 0.25] = BAND_FULL
    out, m = update_bands(jnp.asarray(ds), jnp.asarray(poffs), threshold)
    exp_out, exp_m = update_offsets_np(ds.astype(np.uint16),
                                       poffs.astype(np.uint16), threshold)
    assert np.array_equal(np.asarray(m), exp_m.astype(np.int32))
    assert np.array_equal(np.asarray(out), exp_out.astype(np.int32))


@pytest.mark.parametrize("variant", ["extend", "aligner"])
def test_chain_scan_matches_numpy_oracle(variant):
    """The production forward scan against the scalar oracle on random
    seed pairs with repeats, padding anchors included."""
    rng = np.random.default_rng(7 if variant == "extend" else 8)
    k, P, NQ, NT, A = 10, 6, 24, 32, 160
    qs = rng.integers(0, 12, (P, NQ)).astype(np.int32)
    ts = rng.integers(0, 12, (P, NT)).astype(np.int32)
    qs[:, -3:] = -1
    qp = np.cumsum(rng.integers(1, 40, (P, NQ)), axis=1).astype(np.int32)
    tp = np.cumsum(rng.integers(1, 40, (P, NT)), axis=1).astype(np.int32)
    anchors = chain_mod.make_anchors(qs, qp, ts, tp, A)
    fwd = jax.vmap(chain_mod._chain_scan,
                   in_axes=(0, 0, 0, 0, 0, None, None))
    f, cov_q, cov_t, _, _, _ = (np.asarray(a) for a in fwd(
        anchors["qi"], anchors["tj"], anchors["qp"], anchors["tp"],
        anchors["valid"], k, variant))
    for p in range(P):
        anc, f_np, cq_np, ct_np = chain_mod.chain_pair_np(
            qs[p], qp[p], ts[p], tp[p], k, variant)
        n = len(anc)
        assert 0 < n <= A
        assert np.array_equal(f[p, :n], f_np)
        assert np.array_equal(cov_q[p, :n], cq_np)
        assert np.array_equal(cov_t[p, :n], ct_np)
        assert not f[p, n:].any()


@pytest.mark.parametrize("backend,sizes", [
    ("cpu", {5: 8, 100: 128, 700: 1024, 3000: 4096}),
    ("gpu", {5: 256, 100: 256, 700: 1024, 3000: 4096}),
])
def test_pair_batch_buckets(monkeypatch, backend, sizes):
    """Accelerators pad pair batches to a few fixed sizes (a compile per
    shape costs seconds there); the CPU keeps power-of-two buckets."""
    monkeypatch.setattr(chain_mod.jax, "default_backend", lambda: backend)
    assert chain_mod._use_fixed_buckets() == (backend != "cpu")
    assert {n: chain_mod._bucket(n) for n in sizes} == sizes


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from downpore_tpu.cli import main as cli_main
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            # JAX reads the variable itself: the program sets no directory
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            cli_main.enable_compile_cache()
            assert cli_main.compile_cache_dir() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            cli_main.enable_compile_cache()
            want = os.path.join(REPO, ".jax_cache")
            assert cli_main.compile_cache_dir() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_correct_device_consensus_error_propagates(monkeypatch, tmp_path):
    """``correct -device_consensus true`` must fail loudly on a device
    error, never fall back to the host engine."""
    import downpore_tpu.consensus as consensus_pkg
    from downpore_tpu.cli.main import main

    def broken(*args, **kwargs):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(consensus_pkg, "build_consensus_bulk", broken)
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    reads = tmp_path / "reads.fasta"
    with open(reads, "w") as f:
        for i in range(6):
            f.write(f">r{i}\n{genome[i * 600:i * 600 + 2400]}\n")
    with pytest.raises(RuntimeError, match="injected device failure"):
        main(["correct", "-input", str(reads),
              "-device_consensus", "true"])
