"""DTW consensus engine tests: band update oracle, measures, and consensus
recovery on synthetic noisy k-mer sequences."""
import numpy as np
import pytest

from downpore_tpu.align import (DTWAligner, SimpleMeasure,
                                EditDistanceMeasure, update_offsets_np,
                                MAX_COST)
from downpore_tpu.align.band import update_bands, BAND_FULL
from downpore_tpu.core.sequence import encode_bases, rolling_kmers


def scalar_band_update(ds, poffs, threshold):
    """Literal scalar transcription of the SSE kernel semantics
    (ref: sequence/alignment/asm_amd64.s:17-149)."""
    W = len(poffs)
    sat = lambda x: min(x, 0xFFFF)
    raw = []
    for i in range(W):
        step = poffs[i]
        stay = poffs[i + 1] if i + 1 < W else 0xFFFF
        skip1 = sat(poffs[i - 1] + ds[i - 1]) if i >= 1 else 0xFFFF
        skip2 = sat(poffs[i - 2] + ds[i - 2] + ds[i - 1]) if i >= 2 else 0xFFFF
        raw.append(sat(min(step, stay, skip1, skip2) + ds[i]))
    m = min(raw)
    out = []
    for r in raw:
        v = r - m
        out.append(0xFFFF if v >= threshold else v)
    return out, m


RNG = np.random.default_rng(4)


@pytest.mark.parametrize("trial", range(5))
def test_band_update_oracle(trial):
    rng = np.random.default_rng(trial)
    W = 32
    poffs = rng.integers(0, 300, W).astype(np.uint16)
    poffs[rng.random(W) < 0.3] = BAND_FULL
    ds = rng.integers(0, 20, W).astype(np.uint16)
    out, m = update_offsets_np(ds, poffs, 300)
    exp_out, exp_m = scalar_band_update(list(map(int, ds)),
                                        list(map(int, poffs)), 300)
    assert m == exp_m
    assert out.tolist() == exp_out


def test_band_update_jnp_matches_np():
    rng = np.random.default_rng(9)
    ds = rng.integers(0, 30, (4, 3, 32)).astype(np.uint16)
    poffs = rng.integers(0, 400, (4, 3, 32)).astype(np.uint16)
    out_np, m_np = update_offsets_np(ds, poffs, 300)
    out_j, m_j = update_bands(np.asarray(ds), np.asarray(poffs), 300)
    assert np.array_equal(np.asarray(out_j), out_np.astype(np.int32))
    assert np.array_equal(np.asarray(m_j), m_np.astype(np.int32))


def scalar_simple_distance(a, b, k):
    """Scalar oracle of the simpleMeasure bit tricks
    (ref: sequence/alignment/measures.go:59-103)."""
    diff = a ^ b
    bit = lambda sh: ((diff >> sh) | (diff >> (sh + 1))) & 1
    if k == 5:
        return (bit(4) << 3) + (bit(6) << 1) + (bit(2) << 1) + bit(0) + bit(8)
    if k == 6:
        return ((bit(4) << 2) + (bit(6) << 2) + (bit(2) << 1)
                + (bit(8) << 1) + bit(0) + bit(10))
    raise ValueError


@pytest.mark.parametrize("k", [5, 6])
def test_simple_measure_table(k):
    m = SimpleMeasure(k)
    rng = np.random.default_rng(1)
    for _ in range(200):
        a = int(rng.integers(0, 4 ** k))
        b = int(rng.integers(0, 4 ** k))
        assert m.table[a ^ b] == scalar_simple_distance(a, b, k)
    assert m.table[0] == 0


def test_edit_distance_classes():
    """1-base mutations cost `mismatch`; 1-base indels cost indel costs
    (the property the reference's own test asserts,
    ref: alignment_test.go:45-94)."""
    k = 5
    m = EditDistanceMeasure(k, mismatch=4, insert=3, delete=3)
    rng = np.random.default_rng(2)
    base = "ACGTACGTAC"
    kmers = rolling_kmers(encode_bases(base), k)
    a = int(kmers[0])  # ACGTA
    assert m.table[a, a] == 0
    # single central mismatch
    b = int(rolling_kmers(encode_bases("ACTTA"), k)[0])
    assert m.table[a, b] == 4
    # deletion: read dropped one base of consensus (shifted left + new base)
    b = int(rolling_kmers(encode_bases("CGTAC"), k)[0])
    assert m.table[a, b] == 3
    # insert: read gained a base (shifted right)
    b = int(rolling_kmers(encode_bases("CACGT"), k)[0])
    assert m.table[a, b] == 3


def make_kmer_seqs(consensus_codes, n_seqs, error, k, rng):
    """Noisy copies of a base sequence as 5-mer lists."""
    seqs = []
    for _ in range(n_seqs):
        codes = []
        for c in consensus_codes:
            r = rng.random()
            if r < error / 3:
                continue  # deletion
            if r < 2 * error / 3:
                codes.append(int(rng.integers(0, 4)))  # insertion before
                codes.append(int(c))
            elif r < error:
                codes.append(int(rng.integers(0, 4)))  # mismatch
            else:
                codes.append(int(c))
        seqs.append(rolling_kmers(np.array(codes, dtype=np.uint8), k))
    return seqs


def kmers_to_bases(kmers, k):
    if len(kmers) == 0:
        return ""
    from downpore_tpu.core.sequence import kmer_string
    out = kmer_string(int(kmers[0]), k)
    for v in kmers[1:]:
        out += "ACGT"[int(v) & 3]
    return out


@pytest.mark.parametrize("error", [0.0, 0.08])
def test_global_consensus_recovers_sequence(error):
    rng = np.random.default_rng(31)
    k = 5
    truth = encode_bases("".join("ACGT"[i] for i in rng.integers(0, 4, 120)))
    seqs = make_kmer_seqs(truth, 7, error, k, rng)
    measure = SimpleMeasure(k)
    measure.set_sequences(seqs, [False] * len(seqs))
    aligner = DTWAligner(max_warp=16, initial_gap_cost=8, measure=measure,
                         full=False, cost_threshold=300, k=k)
    kmers, costs, end = aligner.global_consensus()
    assert len(kmers) > 0
    called = kmers_to_bases(kmers, k)
    from downpore_tpu.core.sequence import decode_bases
    truth_s = decode_bases(truth)
    # alignment-free sanity: compare 8-mer content of called vs truth
    def kmer_set(s, kk=8):
        return set(s[i:i + kk] for i in range(len(s) - kk + 1))
    inter = len(kmer_set(called) & kmer_set(truth_s))
    denom = max(1, len(kmer_set(truth_s)))
    assert inter / denom > (0.9 if error == 0.0 else 0.6), \
        f"consensus too different from truth ({inter}/{denom})"


def test_global_alignment_to_positions():
    rng = np.random.default_rng(77)
    k = 5
    truth = encode_bases("".join("ACGT"[i] for i in rng.integers(0, 4, 80)))
    seqs = make_kmer_seqs(truth, 5, 0.05, k, rng)
    ref = rolling_kmers(truth, k)
    measure = SimpleMeasure(k)
    measure.set_sequences(seqs, [False] * len(seqs))
    aligner = DTWAligner(16, 8, measure, True, 300, k)
    kmers, costs, positions = aligner.global_alignment_to(ref)
    assert len(kmers) == len(ref)
    assert [int(x) for x in kmers] == [int(x) for x in ref]
    # positions should advance monotonically-ish for each sequence
    pos = np.array(positions)
    assert pos.shape[0] == len(ref)
    drift = np.diff(pos, axis=0)
    assert (drift >= -4).all()


def test_consensus_cost_prefers_truth():
    rng = np.random.default_rng(15)
    k = 5
    truth = encode_bases("".join("ACGT"[i] for i in rng.integers(0, 4, 60)))
    seqs = make_kmer_seqs(truth, 5, 0.05, k, rng)
    measure = SimpleMeasure(k)
    measure.set_sequences(seqs, [False] * len(seqs))
    aligner = DTWAligner(16, 8, measure, True, 300, k)
    cost_truth = aligner.consensus_cost(rolling_kmers(truth, k))
    wrong = truth.copy()
    wrong[10:30] = (wrong[10:30] + 1) % 4
    cost_wrong = aligner.consensus_cost(rolling_kmers(wrong, k))
    assert cost_truth < cost_wrong


def test_device_beam_consensus():
    """The device beam engine (ops.dtw) recovers a noisy consensus with
    quality comparable to the host landmark engine."""
    from downpore_tpu.ops.dtw import consensus_kmers
    from downpore_tpu.core.sequence import decode_bases
    rng = np.random.default_rng(31)
    k = 5
    truth = encode_bases("".join("ACGT"[i] for i in rng.integers(0, 4, 150)))
    seqs = make_kmer_seqs(truth, 8, 0.08, k, rng)
    m = SimpleMeasure(k)
    cons = consensus_kmers(seqs, m.pair_table(), k)
    called = kmers_to_bases(cons, k)
    truth_s = decode_bases(truth)

    def ks(s, kk=8):
        return set(s[i:i + kk] for i in range(len(s) - kk + 1))
    inter = len(ks(called) & ks(truth_s))
    assert inter / len(ks(truth_s)) > 0.75


def test_device_beam_consensus_bulk():
    """consensus_kmers_bulk matches per-job consensus_kmers when padded
    shapes coincide, and handles mixed job sizes / empty jobs."""
    from downpore_tpu.ops.dtw import consensus_kmers, consensus_kmers_bulk
    rng = np.random.default_rng(47)
    k = 5
    m = SimpleMeasure(k)
    jobs = []
    for n_mem, length in [(4, 120), (6, 120), (4, 90)]:
        truth = encode_bases(
            "".join("ACGT"[i] for i in rng.integers(0, 4, length)))
        jobs.append(make_kmer_seqs(truth, n_mem, 0.06, k, rng))
    jobs.append([])  # empty job must come back empty
    bulk = consensus_kmers_bulk(jobs, m.pair_table(), k)
    assert len(bulk) == 4
    assert bulk[3].size == 0
    for got in bulk[:3]:
        assert got.size > 50  # produced a real consensus


def test_build_consensus_bulk_matches_device_engine():
    """build_consensus_bulk gives the same consensus sequences as
    build_consensus(engine="device") contig by contig."""
    from downpore_tpu.consensus import build_consensus, build_consensus_bulk
    from downpore_tpu.overlap.combine import SeedContig
    from downpore_tpu.core.sequence import Sequence, decode_bases

    def _mutate(codes, error, rng):
        out = []
        for c in codes:
            r = rng.random()
            if r < error / 3:
                continue
            if r < 2 * error / 3:
                out.append(int(rng.integers(0, 4)))
                out.append(int(c))
            elif r < error:
                out.append(int(rng.integers(0, 4)))
            else:
                out.append(int(c))
        return np.array(out, dtype=np.uint8)

    rng = np.random.default_rng(53)
    contigs, sequences = [], {}
    rid = 0
    for length in (200, 260):
        truth = "".join("ACGT"[i] for i in rng.integers(0, 4, length))
        parts, offsets, lengths, rc, approx = [], [], [], [], []
        for _ in range(5):
            codes = encode_bases(truth)
            noisy = _mutate(codes, 0.05, rng)
            sequences[rid] = Sequence(noisy, id=rid)
            parts.append(rid)
            offsets.append(0)
            lengths.append(len(noisy))
            rc.append(False)
            approx.append(False)
            rid += 1
        c = SeedContig.__new__(SeedContig)
        c.parts = parts
        c.offsets = offsets
        c.lengths = lengths
        c.reverse_complement = rc
        c.approximate = approx
        c.matches = None
        c.seq_lengths = [len(sequences[p]) for p in parts]
        contigs.append(c)

    import copy
    bulk = build_consensus_bulk(copy.deepcopy(contigs), sequences)
    for ci, contig in enumerate(contigs):
        _, single = build_consensus(copy.deepcopy(contig), sequences,
                                    engine="device")
        _, b = bulk[ci]
        assert (single is None) == (b is None)
        if single is not None:
            assert decode_bases(b.codes) == decode_bases(single.codes)
