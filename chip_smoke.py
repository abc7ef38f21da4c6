#!/usr/bin/env python3
"""Smoke run of downpore_tpu on one NVIDIA GPU.

Drives trim, map, overlap and correct once each through the CLI entry
point (``downpore_tpu.cli.main.main``, what ``python -m downpore_tpu.cli``
calls), all in this one process, on reads generated from ``--seed`` with
the ONT error model of ``downpore_tpu.sim`` (substitutions, indels,
homopolymer deletions).  Each phase checks its output against the planted
truth and runs a subset once more on the host CPU device, where the output
must be byte-identical.  A last phase checks the device kernels of those
paths against their plain references at the widths the phases used.

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --four-card   # only map and overlap on a 2x2
                                       # (data x seed) mesh over 4 cards,
                                       # against their one-card output

Each phase prints one line with its wall seconds, the number of XLA
compiles and their seconds, and its check.  The last line of stdout is
``{"ok": true, "device": {...}}``; any failed check, or a JAX that finds
no GPU, exits nonzero without it.  Inputs and outputs go to
``.smoke_work/`` beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

# sizes of the one-card run: E. coli scale for map (the reference's
# flagship 4.6 Mb job), >= 15x coverage for overlap, 30x for correct
TRIM_READS, TRIM_SUBSET = 20_000, 500           # 3-10 kb reads
MAP_GENOME, MAP_READS, MAP_SUBSET = 4_600_000, 10_000, 200   # ~8 kb reads
OV_GENOME, OV_READS, OV_SUBSET_SPAN = 2_000_000, 4_000, 150_000
CORRECT_GENOME, CORRECT_COVERAGE = 80_000, 30
FOUR_CARD_MAP_READS, FOUR_CARD_OV_GENOME, FOUR_CARD_OV_READS = \
    2_000, 1_000_000, 2_000

# read error rates handed to sim.ont_read (homopolymer deletions boosted
# 3x on top of del_rate)
READ_ERR = dict(sub_rate=0.03, ins_rate=0.015, del_rate=0.015)
OV_READ_ERR = dict(sub_rate=0.01, ins_rate=0.005, del_rate=0.005)
ADAPTER_ERR = dict(sub_rate=0.02, ins_rate=0.01, del_rate=0.01)
TRIM_END_TOL = 30        # bases between a planted and a trimmed end
PARITY_SLACK = 0.03      # device vs host consensus identity


class SmokeFailure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------
# compile accounting and phase lines

class CompileCounter:
    """Counts XLA compiles (persistent-cache loads included) and their
    seconds through ``jax.monitoring``."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.n = 0
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.n += 1
            self.secs += duration


@contextlib.contextmanager
def phase(name, counter, result):
    """Time a phase; ``result`` is a dict the body fills with 'check'."""
    n0, s0, t0 = counter.n, counter.secs, time.perf_counter()
    yield
    print(f"phase {name}: wall {time.perf_counter() - t0} s, "
          f"compiles {counter.n - n0}, compile {counter.secs - s0} s, "
          f"check ok: {result.get('check', '')}", flush=True)


@contextlib.contextmanager
def on_host_cpu(device):
    """Run on the CPU ``device`` with the persistent compile cache off:
    CPU executables in a shared cache may have been built on a host with
    other CPU features."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        with jax.default_device(device):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        compilation_cache.reset_cache()


def run_cli(argv, out_path, cpu=None):
    """``downpore_tpu.cli.main.main(argv)`` with stdout to ``out_path``
    and stderr beside it; on the host ``cpu`` device when given.  Returns
    stdout bytes."""
    from downpore_tpu.cli.main import main
    err_path = out_path + ".err"
    ctx = on_host_cpu(cpu) if cpu is not None else contextlib.nullcontext()
    try:
        with open(out_path, "w") as out, open(err_path, "w") as err, ctx, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = main(argv)
    except BaseException:
        with open(err_path) as f:
            sys.stderr.write(f.read()[-4000:])
        raise
    require(rc == 0, f"{argv[0]} exited {rc}")
    with open(out_path, "rb") as f:
        return f.read()


def write_fasta(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{s}\n")


def write_fastq(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")


def read_records(data: bytes, fastq: bool):
    """(name, seq) pairs of fasta/fastq text."""
    lines = data.decode().splitlines()
    if fastq:
        return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]
    out = []
    for line in lines:
        if line.startswith(">"):
            out.append([line[1:], ""])
        elif out:
            out[-1][1] += line.strip()
    return [tuple(r) for r in out]


def paf_rows(data: bytes):
    return [line.split("\t") for line in data.decode().splitlines()
            if line.count("\t") >= 11]


# ---------------------------------------------------------------------
# phases

def phase_device(four_card: bool):
    import jax
    devs = jax.devices()
    print(f"jax {jax.__version__}, devices: {devs}", flush=True)
    require(devs[0].platform == "gpu",
            f"JAX found no GPU (platform {devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    want = 4 if four_card else 1
    require(len(devs) >= want, f"need {want} GPU(s), found {len(devs)}")
    from downpore_tpu import native
    require(native.load() is not None,
            "native host library failed to build (numpy fallback)")
    return devs


def phase_trim(rng, cpu, n_reads=TRIM_READS, n_subset=TRIM_SUBSET,
               genome_len=2_000_000):
    from downpore_tpu import sim
    from downpore_tpu.data import BACK_ADAPTERS, FRONT_ADAPTERS
    front, back = FRONT_ADAPTERS[0][1], BACK_ADAPTERS[0][1]
    genome = sim.random_genome(rng, genome_len)
    cores, _ = sim.sample_reads(rng, genome, n_reads, 3000, 10000,
                                **READ_ERR)
    names = [f"read{i}" for i in range(n_reads)]
    reads, spans = [], {}
    for name, core in zip(names, cores):
        f = sim.ont_read(rng, front, **ADAPTER_ERR)
        b = sim.ont_read(rng, back, **ADAPTER_ERR)
        reads.append(f + core + b)
        spans[name] = (len(f), len(f) + len(core))
    path = os.path.join(WORK, "trim_reads.fastq")
    write_fastq(path, names, reads)
    out = run_cli(["trim", "-input", path, "-verbosity", "0"],
                  os.path.join(WORK, "trim_out.fastq"))
    recs = read_records(out, fastq=True)
    by_name = dict(zip(names, reads))
    seen, good = set(), 0
    for name, seq in recs:
        # adapter tags join the read name with '_'
        base = next((t for t in name.split()[0].split("_")
                     if t in by_name), None)
        require(base is not None, f"trim emitted unknown read {name}")
        seen.add(base)
        full = by_name[base]
        s0, e0 = spans[base]
        at = full.find(seq)
        require(at >= 0, f"trimmed {base} is not a slice of its read")
        if abs(at - s0) <= TRIM_END_TOL and \
                abs(at + len(seq) - e0) <= TRIM_END_TOL:
            good += 1
    require(len(seen) == n_reads,
            f"trim emitted {len(seen)} of {n_reads} reads")
    frac = good / n_reads
    require(frac >= 0.99,
            f"only {frac} of trimmed ends within {TRIM_END_TOL} bases")
    sub = os.path.join(WORK, "trim_subset.fastq")
    write_fastq(sub, names[:n_subset], reads[:n_subset])
    argv = ["trim", "-input", sub, "-verbosity", "0"]
    a = run_cli(argv, os.path.join(WORK, "trim_subset_gpu.fastq"))
    b = run_cli(argv, os.path.join(WORK, "trim_subset_cpu.fastq"), cpu)
    require(a == b, "trim subset differs between GPU and CPU")
    return (f"{n_reads} reads, {frac} of ends within {TRIM_END_TOL} b of "
            f"the planted adapters; {n_subset}-read subset byte-identical "
            f"on CPU")


def make_map_inputs(rng, genome_len, n_reads, tag):
    from downpore_tpu import sim
    genome = sim.structured_genome(rng, genome_len)
    reads, truth = sim.sample_reads(rng, genome, n_reads, 7500, 8500,
                                    **READ_ERR)
    names = [f"m{i}" for i in range(n_reads)]
    gpath = os.path.join(WORK, f"{tag}_genome.fasta")
    rpath = os.path.join(WORK, f"{tag}_reads.fasta")
    write_fasta(gpath, ["genome"], [genome])
    write_fasta(rpath, names, reads)
    return gpath, rpath, names, reads, truth


def map_argv(gpath, rpath):
    return ["map", "-input", rpath, "-reference", gpath,
            "-circular", "false"]


def phase_map(rng, cpu, genome_len=MAP_GENOME, n_reads=MAP_READS,
              n_subset=MAP_SUBSET):
    gpath, rpath, names, reads, truth = make_map_inputs(
        rng, genome_len, n_reads, "map")
    out = run_cli(map_argv(gpath, rpath), os.path.join(WORK, "map.paf"))
    hits = {}
    for t in paf_rows(out):
        hits.setdefault(t[0], []).append(
            (int(t[7]), int(t[8]), t[4] == "-"))
    good = 0
    for name, (s, e, rc) in zip(names, truth):
        for ms, me, mrc in hits.get(name, []):
            if mrc == rc and min(e, me) - max(s, ms) > min(e - s,
                                                           me - ms) // 2:
                good += 1
                break
    frac = good / n_reads
    require(frac >= 0.99, f"only {frac} of reads mapped to their locus")
    sub = os.path.join(WORK, "map_subset.fasta")
    write_fasta(sub, names[:n_subset], reads[:n_subset])
    a = run_cli(map_argv(gpath, sub), os.path.join(WORK, "map_sub_gpu.paf"))
    b = run_cli(map_argv(gpath, sub), os.path.join(WORK, "map_sub_cpu.paf"),
                cpu)
    require(a and a == b, "map subset PAF differs between GPU and CPU")
    return (f"{n_reads} reads on {genome_len} b, {frac} at the planted "
            f"locus and strand; {n_subset}-read subset PAF byte-identical "
            f"on CPU")


def make_overlap_inputs(rng, genome_len, n_reads, tag):
    from downpore_tpu import sim
    genome = sim.random_genome(rng, genome_len)
    reads, truth = sim.sample_reads(rng, genome, n_reads, 7000, 9000,
                                    **OV_READ_ERR)
    names = [f"o{i}" for i in range(n_reads)]
    path = os.path.join(WORK, f"{tag}_reads.fasta")
    write_fasta(path, names, reads)
    return path, names, reads, truth


def overlap_recall(out, names, truth, min_overlap=1000):
    """(direct recall, two-hop recall, precision, planted pairs) of the
    PAF against planted overlaps of >= ``min_overlap`` bases.

    Each query edge reports its consensus contig's first read against the
    others, a star rather than every pair, so a planted pair counts under
    two-hop recall when it is reported or both reads are reported against
    a common read.  A reported pair overlapping by < 300 planted bases is
    false."""
    idx = {n: i for i, n in enumerate(names)}
    found = {tuple(sorted((t[0], t[5]))) for t in paf_rows(out)}
    nbr = {}
    for a, b in found:
        nbr.setdefault(a, set()).add(b)
        nbr.setdefault(b, set()).add(a)

    def overlap(a, b):
        return min(truth[a][1], truth[b][1]) - max(truth[a][0], truth[b][0])

    false = sum(1 for a, b in found if overlap(idx[a], idx[b]) < 300)
    order = sorted(range(len(names)), key=lambda i: truth[i][0])
    want = direct = hop2 = 0
    for a_i, a in enumerate(order):
        for b in order[a_i + 1:]:
            if truth[b][0] > truth[a][1] - min_overlap:
                break
            if overlap(a, b) >= min_overlap:
                want += 1
                na, nb = names[a], names[b]
                hit = tuple(sorted((na, nb))) in found
                direct += hit
                hop2 += hit or bool(nbr.get(na, set()) & nbr.get(nb, set()))
    return (direct / max(1, want), hop2 / max(1, want),
            1 - false / max(1, len(found)), want)


def phase_overlap(rng, cpu, genome_len=OV_GENOME, n_reads=OV_READS,
                  subset_span=OV_SUBSET_SPAN):
    path, names, reads, truth = make_overlap_inputs(rng, genome_len,
                                                    n_reads, "overlap")
    out = run_cli(["overlap", "-input", path],
                  os.path.join(WORK, "overlap.paf"))
    direct, recall, precision, n_true = overlap_recall(out, names, truth)
    require(recall >= 0.9 and precision >= 0.95,
            f"overlap two-hop recall {recall}, precision {precision} of "
            f"{n_true} planted pairs")
    keep = [i for i in range(n_reads) if truth[i][1] <= subset_span]
    sub = os.path.join(WORK, "overlap_subset.fasta")
    write_fasta(sub, [names[i] for i in keep], [reads[i] for i in keep])
    a = run_cli(["overlap", "-input", sub],
                os.path.join(WORK, "overlap_sub_gpu.paf"))
    b = run_cli(["overlap", "-input", sub],
                os.path.join(WORK, "overlap_sub_cpu.paf"), cpu)
    require(a and a == b, "overlap subset PAF differs between GPU and CPU")
    cover = n_reads * 8000 / genome_len
    return (f"{n_reads} reads at {cover}x, {n_true} planted overlaps "
            f">= 1 kb: two-hop recall {recall}, direct recall {direct}, "
            f"precision {precision}; {len(keep)}-read subset PAF "
            f"byte-identical on CPU")


def semiglobal_identity(query: str, ref: str) -> float:
    """1 - (edit distance of ``query`` to its best-matching substring of
    ``ref``) / len(query), by a row-vectorized Levenshtein DP."""
    import numpy as np
    q = np.frombuffer(query.encode(), np.uint8)
    r = np.frombuffer(ref.encode(), np.uint8)
    prev = np.zeros(len(r) + 1, np.int32)          # free start in ref
    j = np.arange(len(r) + 1, dtype=np.int32)
    for i in range(1, len(q) + 1):
        diag = prev[:-1] + (r != q[i - 1])
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, diag)
        # horizontal (deletion-from-ref) moves: cur[j] = min_k cur[k] + j-k
        cur = np.minimum.accumulate(cur - j) + j
        prev = cur
    return 1.0 - float(prev.min()) / len(q)


def phase_correct(rng, genome_len=CORRECT_GENOME,
                  coverage=CORRECT_COVERAGE):
    from downpore_tpu import sim
    genome = sim.random_genome(rng, genome_len)
    n_reads = genome_len * coverage // 8000
    reads, _ = sim.sample_reads(rng, genome, n_reads, 7000, 9000,
                                **READ_ERR)
    path = os.path.join(WORK, "correct_reads.fasta")
    write_fasta(path, [f"c{i}" for i in range(n_reads)], reads)
    rc_genome = sim.revcomp(genome)
    result = {}
    for engine in ("true", "false"):
        t0 = time.perf_counter()
        out = run_cli(["correct", "-input", path, "-device_consensus",
                       engine], os.path.join(WORK, f"correct_{engine}.fa"))
        secs = time.perf_counter() - t0
        seqs = [s for _, s in read_records(out, fastq=False)]
        require(seqs, f"correct -device_consensus {engine} emitted nothing")
        ident = [max(semiglobal_identity(s, genome),
                     semiglobal_identity(s, rc_genome)) for s in seqs]
        result[engine] = (sum(ident) / len(ident), len(seqs), secs)
    dev, host = result["true"], result["false"]
    # the device engine is a fixed-beam approximation of the faithful
    # host engine; it is held to the repo's parity bound on the host
    # engine's accuracy (tests/test_dtw_parity.py::check_bounded)
    require(dev[0] >= host[0] - PARITY_SLACK,
            f"device consensus identity {dev[0]} more than {PARITY_SLACK} "
            f"below host {host[0]}")
    return (f"{n_reads} reads at {coverage}x; device engine: "
            f"{dev[1]} consensus, mean identity {dev[0]}, {dev[2]} s; host "
            f"engine: {host[1]} consensus, mean identity {host[0]}, "
            f"{host[2]} s")


# ---------------------------------------------------------------------
# kernels at real widths against plain references

def kmer_ints(codes, k):
    import numpy as np
    km = np.zeros(len(codes) - k + 1, np.int64)
    for j in range(k):
        km = (km << 2) | codes[j:j + len(km)]
    return km.astype(np.int32)


def mismatch_table(k):
    """[4^k, 4^k] uint16 cost: 4 per mismatching base of a k-mer pair."""
    import numpy as np
    n = 4 ** k
    table = np.empty((n, n), np.uint16)
    b = np.arange(n, dtype=np.int32)[None, :]
    for lo in range(0, n, 1024):
        d = np.arange(lo, min(n, lo + 1024), dtype=np.int32)[:, None] ^ b
        cost = np.zeros(d.shape, np.uint16)
        for g in range(k):
            cost += (((d >> (2 * g)) | (d >> (2 * g + 1))) & 1).astype(
                np.uint16) * 4
        table[lo:lo + len(d)] = cost
    return table


def check_hit_counts(rng, C, H=1 << 17, Q=512):
    import jax
    import numpy as np
    from downpore_tpu.ops.match import hit_counts
    M = (rng.random((H, C)) < 0.02).astype(np.int8)
    V = np.where(rng.random((Q, H)) < 0.01,
                 rng.integers(1, 5, (Q, H)), 0).astype(np.int8)
    got = np.asarray(jax.block_until_ready(hit_counts(V, M)))
    want = (V.astype(np.float64) @ M.astype(np.float64)).astype(np.int64)
    require(got.dtype == np.int32 and np.array_equal(got, want),
            "hit_counts differs from numpy V @ M")
    return f"hit_counts [{Q}, {H}] x [{H}, {C}] exact"


def check_count_rows(rng, C, H=1 << 17, M_rows=16384, R=64):
    import jax
    import numpy as np
    from downpore_tpu.ops.map_engine import _count_rows
    mem = (rng.random((H, C)) < 0.02).astype(np.int8)
    buckets = rng.integers(0, H, (M_rows, R)).astype(np.int32)
    buckets[rng.random((M_rows, R)) < 0.3] = -1
    got = np.asarray(jax.jit(_count_rows)(mem, buckets))
    want = np.empty((M_rows, C), np.int64)
    for lo in range(0, M_rows, 1024):
        b = buckets[lo:lo + 1024]
        rows = mem[np.clip(b, 0, H - 1)].astype(np.int32)
        rows[b < 0] = 0
        want[lo:lo + 1024] = rows.sum(axis=1)
    require(np.array_equal(got, want), "_count_rows differs from numpy")
    return f"_count_rows [{M_rows}, {R}] over [{H}, {C}] exact"


def check_chain_batch(rng, P=256, nq=64, nt=320, k=11, max_anchors=256):
    import numpy as np
    from downpore_tpu.ops.chain import chain_batch, chain_pair_np
    qs = np.full((P, nq), -1, np.int32)
    qp = np.zeros((P, nq), np.int32)
    ts = rng.integers(0, 4096, (P, nt)).astype(np.int32)
    tp = np.cumsum(rng.integers(5, 40, (P, nt)), axis=1).astype(np.int32)
    for p in range(P):
        n = int(rng.integers(nq // 2, nq + 1))
        at = int(rng.integers(0, nt - n))
        qs[p, :n] = ts[p, at:at + n]
        jitter = rng.integers(-3, 4, n)
        qp[p, :n] = np.maximum.accumulate(
            np.maximum(tp[p, at:at + n] - tp[p, at] + jitter, 0))
        lost = rng.random(n) < 0.25
        qs[p, :n][lost] = rng.integers(4096, 8192, int(lost.sum()))
    out = chain_batch(qs, qp, ts, tp, k=k, max_anchors=max_anchors)
    got = {x: np.asarray(out[x]) for x in ("f", "b", "cov_q", "cov_t")}
    for p in range(P):
        # forward pass, and the backward pass as the forward pass of the
        # reversed, negated pair (anchors come out in reverse order)
        anc, f, cq, ct = (np.asarray(x) for x in chain_pair_np(
            qs[p], qp[p], ts[p], tp[p], k))
        _, b, cqb, ctb = (np.asarray(x)[::-1] for x in chain_pair_np(
            qs[p, ::-1], -qp[p, ::-1], ts[p, ::-1], -tp[p, ::-1], k))
        n = len(anc)
        require(n <= max_anchors, "chain check overflowed its anchors")
        want = {"f": f, "b": b, "cov_q": cq + cqb - k, "cov_t": ct + ctb - k}
        for x, w in want.items():
            require(np.array_equal(got[x][p, :n], w),
                    f"chain_batch {x} differs from chain_pair_np on pair {p}")
    return f"chain_batch {P} pairs [{nq}] x [{nt}] exact"


def consensus_jobs(rng, n_jobs, n_members, core_len, k):
    import numpy as np
    from downpore_tpu import sim
    jobs = []
    for _ in range(n_jobs):
        core = sim.random_genome(rng, core_len)
        jobs.append([kmer_ints(np.frombuffer(
            sim.ont_read(rng, core, **READ_ERR).encode().translate(
                bytes.maketrans(b"ACGT", b"\0\1\2\3")), np.uint8)
            .astype(np.int64), k) for _ in range(n_members)])
    return jobs


def check_consensus(rng, k, n_jobs=32, n_members=30, core_len=1000,
                    n_single=6):
    """The vmapped engine against per-job ``device_consensus`` (same
    padding) and against itself with the one-hot window fetch replaced
    by a plain gather; all bit-exact."""
    import jax
    import numpy as np
    from downpore_tpu.align import SimpleMeasure
    from downpore_tpu.ops import dtw
    jobs = consensus_jobs(rng, n_jobs, n_members, core_len, k)
    if k in (1, 3, 4, 5, 6):
        table, simple_k = SimpleMeasure(k).pair_table(), k
    else:
        table, simple_k = mismatch_table(k), 0
    t0 = time.perf_counter()
    bulk = dtw.consensus_kmers_bulk(jobs, table, k, simple_k=simple_k)
    first_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk = dtw.consensus_kmers_bulk(jobs, table, k, simple_k=simple_k)
    warm_secs = time.perf_counter() - t0
    for job, got in zip(jobs[:n_single], bulk):
        N = ((len(job) + 3) // 4) * 4
        L = ((max(len(s) for s in job) + 127) // 128) * 128
        t_max = ((int(L * 1.3) + 32 + 31) // 32) * 32
        seq, lens, first = dtw._pad_job(job, N, L)
        chain, n = jax.device_get(dtw.device_consensus(
            seq, lens, np.asarray(table, np.uint16), first, k=k, beam=4,
            t_max=t_max, threshold=300, gap_cost=8, simple_k=simple_k))
        require(np.array_equal(got, dtw._assemble(chain, int(n), first)),
                f"bulk consensus differs from per-job at k={k}")
    onehot = dtw._fetch_window
    try:
        dtw._fetch_window = dtw._fetch_window_gather
        jax.clear_caches()
        gathered = dtw.consensus_kmers_bulk(jobs, table, k,
                                            simple_k=simple_k)
    finally:
        dtw._fetch_window = onehot
        jax.clear_caches()
    require(all(np.array_equal(a, b) for a, b in zip(bulk, gathered)),
            f"one-hot window fetch differs from a gather at k={k}")
    return (f"consensus k={k}: {n_jobs} jobs x {n_members} members x "
            f"~{core_len} b bit-exact vs per-job and vs gather fetch; "
            f"bulk {first_secs} s first call, {warm_secs} s warm")


def phase_kernels(rng, map_step):
    import jax
    lines = []
    C = map_step["C"]
    lines.append(check_hit_counts(rng, C))
    lines.append(check_count_rows(rng, C))
    lines.append(check_chain_batch(rng))
    fn, args, kwargs = map_step["call"]
    mem = fn.lower(*args, **kwargs).compile().memory_analysis()
    print(f"map step {fn.__name__} memory_analysis: {mem}", flush=True)
    lines.append(check_consensus(rng, 5))
    lines.append(check_consensus(rng, 7))
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}", flush=True)
    return "; ".join(lines)


@contextlib.contextmanager
def record_map_step(store):
    """Record the first fused map dispatch (function, args) and the
    chunk count C of the resident membership matrix."""
    from downpore_tpu.ops import map_engine
    names = ["_fused_map_c", "_fused_map_d", "_fused_map_bc",
             "_fused_map_bd", "_map_from_counts"]
    saved = {n: getattr(map_engine, n) for n in names}

    def wrap(fn):
        def call(*args, **kwargs):
            store.setdefault("call", (fn, args, kwargs))
            return fn(*args, **kwargs)
        return call

    orig_init = map_engine.MapEngine.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        store.setdefault("engines", []).append(self)
        store["C"] = self.C

    try:
        for n, fn in saved.items():
            setattr(map_engine, n, wrap(fn))
        map_engine.MapEngine.__init__ = init
        yield store
    finally:
        for n, fn in saved.items():
            setattr(map_engine, n, fn)
        map_engine.MapEngine.__init__ = orig_init


# ---------------------------------------------------------------------
# four cards: map and overlap on a 2x2 (data x seed) mesh

def check_mesh_placement(name, engine, step_args, want):
    """The resident membership matrix and every array of the recorded
    step must sit on all four devices, not on device 0."""
    import jax
    arrays = [("membership", engine.membership)] + [
        (f"step arg {i}", a) for i, a in enumerate(step_args)
        if isinstance(a, jax.Array)]
    for label, a in arrays:
        ids = sorted(d.id for d in a.sharding.device_set)
        print(f"{name} mesh: {label} {a.shape} on devices {ids} "
              f"({getattr(a.sharding, 'spec', a.sharding)})", flush=True)
        require(ids == want, f"{name} {label} is not on all four devices")


def four_card(rng, counter, devices, map_reads=FOUR_CARD_MAP_READS,
              ov_genome=FOUR_CARD_OV_GENOME, ov_reads=FOUR_CARD_OV_READS,
              map_genome=MAP_GENOME):
    want = sorted(d.id for d in devices[:4])
    mesh_flags = ["-data_parallel", "true", "-seed_shards", "2"]
    res = {}
    with phase("four_card_map", counter, res):
        gpath, rpath, *_ = make_map_inputs(rng, map_genome, map_reads,
                                           "map4")
        one = run_cli(map_argv(gpath, rpath),
                      os.path.join(WORK, "map4_one.paf"))
        with record_map_step({}) as rec:
            four = run_cli(map_argv(gpath, rpath) + mesh_flags,
                           os.path.join(WORK, "map4_mesh.paf"))
        check_mesh_placement("map", rec["engines"][-1], rec["call"][1],
                             want)
        require(one and one == four,
                "map PAF on the 2x2 mesh differs from one card")
        res["check"] = (f"{map_reads} reads, {one.count(b'\n')} PAF lines "
                        "byte-identical to one card")
    res = {}
    with phase("four_card_overlap", counter, res):
        path, *_ = make_overlap_inputs(rng, ov_genome, ov_reads, "ov4")
        one = run_cli(["overlap", "-input", path],
                      os.path.join(WORK, "ov4_one.paf"))
        with record_overlap_step({}) as rec:
            four = run_cli(["overlap", "-input", path] + mesh_flags,
                           os.path.join(WORK, "ov4_mesh.paf"))
        check_mesh_placement("overlap", rec["engines"][-1], rec["call"][1],
                             want)
        require(one and one == four,
                "overlap PAF on the 2x2 mesh differs from one card")
        res["check"] = (f"{ov_reads} reads, {one.count(b'\n')} PAF lines "
                        "byte-identical to one card")


@contextlib.contextmanager
def record_overlap_step(store):
    """Record overlap engines and the first seed-sharded overlap chain
    step (function, args)."""
    from downpore_tpu.ops import map_engine
    orig = map_engine._overlap_from_counts
    orig_init = map_engine.MapEngine.__init__

    def call(*args, **kwargs):
        store.setdefault("call", (orig, args, kwargs))
        return orig(*args, **kwargs)

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        store.setdefault("engines", []).append(self)

    try:
        map_engine._overlap_from_counts = call
        map_engine.MapEngine.__init__ = init
        yield store
    finally:
        map_engine._overlap_from_counts = orig
        map_engine.MapEngine.__init__ = orig_init


# ---------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-card", action="store_true",
                    help="run only map and overlap on a 2x2 mesh over "
                         "four cards, against one card")
    args = ap.parse_args(argv)

    # the CPU device is the reference for the subset runs: keep it
    # available when the platform list is pinned
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)
    import numpy as np
    import jax
    from downpore_tpu.cli.main import compile_cache_dir, \
        enable_compile_cache

    enable_compile_cache()
    counter = CompileCounter()
    res = {}
    with phase("device", counter, res):
        devs = phase_device(args.four_card)
        res["check"] = (f"platform {devs[0].platform}, kind "
                        f"{devs[0].device_kind}, count {len(devs)}; native "
                        "host library loaded")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(args.seed)
    if args.four_card:
        four_card(rng, counter, devs)
    else:
        cpu = jax.devices("cpu")[0]
        res = {}
        with phase("trim", counter, res):
            res["check"] = phase_trim(rng, cpu)
        res = {}
        with record_map_step({}) as map_step, \
                phase("map", counter, res):
            res["check"] = phase_map(rng, cpu)
        res = {}
        with phase("overlap", counter, res):
            res["check"] = phase_overlap(rng, cpu)
        res = {}
        with phase("correct", counter, res):
            res["check"] = phase_correct(rng)
        res = {}
        with phase("kernels", counter, res):
            res["check"] = phase_kernels(rng, map_step)
    cache = compile_cache_dir()
    n_cached = sum(len(f) for _, _, f in os.walk(cache))
    print(f"compile cache {cache}: {n_cached} files", flush=True)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
