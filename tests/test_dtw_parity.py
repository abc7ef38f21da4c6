"""Host-vs-device DTW consensus parity over structured adversarial cases.

The host engine (align.dtw) is the faithful port of the reference's
landmark beam (ref: sequence/alignment/alignment.go:556-1052); the device
engine (ops.dtw) re-expresses it as a fixed-width beam.  These tests bound
their divergence on exactly the case families the landmark machinery
exists for: homopolymer runs, drifting indel offsets, and noisy pileups
where only anchor k-mers are trustworthy — the gate for making the device
engine the default in `correct`.
"""
import numpy as np
import pytest

from downpore_tpu.align import DTWAligner, SimpleMeasure
from downpore_tpu.ops.dtw import consensus_kmers

K = 5
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def codes_of(s: str) -> np.ndarray:
    return np.frombuffer(
        s.encode().translate(bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))),
        np.uint8).copy()


def kmers_of(codes: np.ndarray, k: int = K) -> np.ndarray:
    km = np.zeros(len(codes) - k + 1, np.int64)
    for j in range(k):
        km = (km << 2) | codes[j : j + len(km)]
    return km.astype(np.int32)


def kmers_to_str(kmers: np.ndarray, k: int = K) -> str:
    out = []
    first = int(kmers[0])
    for i in range(k - 1):
        out.append("ACGT"[(first >> (2 * (k - i - 1))) & 3])
    for v in kmers:
        out.append("ACGT"[int(v) & 3])
    return "".join(out)


def edit_distance(a: str, b: str) -> int:
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i + 1
        bs = np.frombuffer(b.encode(), np.uint8)
        sub = prev[:-1] + (bs != ord(ca))
        for j in range(len(b)):
            cur[j + 1] = min(sub[j], prev[j + 1] + 1, cur[j] + 1)
        prev = cur
    return int(prev[-1])


def mutate(rng, codes: np.ndarray, sub=0.04, ins=0.02, dele=0.02,
           homo_bias=0.0) -> np.ndarray:
    """ONT-style errors: substitutions plus indels, with optional extra
    indel mass inside homopolymer runs (the dominant nanopore error)."""
    out = []
    i = 0
    n = len(codes)
    while i < n:
        in_run = 1 <= i < n - 1 and codes[i] == codes[i - 1]
        d, s, a = dele, sub, ins
        if homo_bias and in_run:
            d, a = dele + homo_bias, ins + homo_bias
        r = rng.random()
        if r < d:
            i += 1
            continue
        if r < d + a:
            out.append(rng.integers(0, 4))
        if r < d + a + s:
            out.append((int(codes[i]) + int(rng.integers(1, 4))) % 4)
        else:
            out.append(int(codes[i]))
        i += 1
    return np.array(out, np.uint8)


def run_both(rng, core: np.ndarray, n_members=6, **err):
    members = [kmers_of(mutate(rng, core, **err)) for _ in range(n_members)]
    members = [m for m in members if len(m) > K]
    m = SimpleMeasure(K)
    m.set_sequences(members, [False] * len(members))
    host_k, _, _ = DTWAligner(16, 5, m, False, 200, K).global_consensus()
    dev_k = consensus_kmers(members, SimpleMeasure(K).pair_table(), K)
    truth = kmers_to_str(kmers_of(core))
    host = kmers_to_str(np.asarray(host_k)) if len(host_k) else ""
    dev = kmers_to_str(dev_k) if len(dev_k) else ""
    return truth, host, dev


def check_bounded(truth, host, dev, extra_frac=0.03, abs_slack=6):
    """Device consensus must stay within a bounded distance of truth
    relative to the host engine's own accuracy."""
    assert host and dev, "an engine produced no consensus"
    eh = edit_distance(host, truth)
    ed = edit_distance(dev, truth)
    bound = eh + abs_slack + int(extra_frac * len(truth))
    assert ed <= bound, (
        f"device consensus degraded: host={eh} device={ed} bound={bound}")
    return eh, ed


def test_parity_random_core():
    rng = np.random.default_rng(100)
    core = BASES[rng.integers(0, 4, 400)]
    core = codes_of(core.tobytes().decode())
    truth, host, dev = run_both(rng, core, sub=0.05, ins=0.025, dele=0.025)
    check_bounded(truth, host, dev)


def test_parity_homopolymer_runs():
    """Cores salted with >=6-base homopolymer runs plus homopolymer-biased
    indel errors — the run-length calling path (ref alignment.go:416-464,
    stay suppression 641-675)."""
    rng = np.random.default_rng(101)
    parts = []
    for _ in range(8):
        parts.append(BASES[rng.integers(0, 4, 40)])
        parts.append(np.repeat(BASES[rng.integers(0, 4)],
                               rng.integers(6, 10)))
    core = codes_of(np.concatenate(parts).tobytes().decode())
    truth, host, dev = run_both(rng, core, sub=0.03, ins=0.01, dele=0.01,
                                homo_bias=0.05)
    check_bounded(truth, host, dev, extra_frac=0.05)


def test_parity_drifting_offsets():
    """Systematic deletion drift: members run ~8% short, pushing band
    centres off alignment — the fixDrift recentring path
    (ref alignment.go:245-273)."""
    rng = np.random.default_rng(102)
    core = codes_of(BASES[rng.integers(0, 4, 500)].tobytes().decode())
    truth, host, dev = run_both(rng, core, sub=0.02, ins=0.0, dele=0.08)
    check_bounded(truth, host, dev, extra_frac=0.05)


def test_parity_landmark_pileup():
    """Noisy members (12% error) where only scattered exact anchors
    survive — the landmark-critical regime (ref alignment.go:734-981)."""
    rng = np.random.default_rng(103)
    core = codes_of(BASES[rng.integers(0, 4, 400)].tobytes().decode())
    truth, host, dev = run_both(rng, core, n_members=10,
                                sub=0.06, ins=0.03, dele=0.03)
    check_bounded(truth, host, dev, extra_frac=0.06)


def test_device_engine_accuracy_floor():
    """Absolute floor: on a routine pileup the device consensus must land
    within 3% of truth regardless of what the host engine does."""
    rng = np.random.default_rng(104)
    core = codes_of(BASES[rng.integers(0, 4, 600)].tobytes().decode())
    members = [kmers_of(mutate(rng, core, sub=0.04, ins=0.02, dele=0.02))
               for _ in range(8)]
    dev_k = consensus_kmers(members, SimpleMeasure(K).pair_table(), K)
    truth = kmers_to_str(kmers_of(core))
    dev = kmers_to_str(dev_k)
    ed = edit_distance(dev, truth)
    assert ed <= 0.03 * len(truth), f"device consensus {ed} edits from truth"
