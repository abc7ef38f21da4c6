"""Benchmark suite: end-to-end throughput of the four pipelines on the
attached device.

Prints one JSON line per metric, trim first, then map, overlap,
consensus and the disk-to-disk tails (``python bench.py [section ...]``):

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N}

Baselines (ours / reference):
* trim   — the reference's worst-case demultiplex anchor of ~1 GB/min of
           fastq on its 16-thread desktop (ref README.md:126), converted
           to reads/s at this read length.
* map    — the reference maps the 1.5 GB E. coli fasta in 6.7 s on the
           same desktop (ref README.md:240) => ~2.24e8 bases/s; ours is
           mapped query bases per second.
* overlap— the reference publishes no absolute overlap time (its table is
           WIP, README.md:277-300); the same 1 GB/min anchor is used as a
           CONSERVATIVE proxy (all-vs-all overlap is strictly more work
           per byte than trimming, so vs_baseline is understated).
* consensus — no published reference number exists for the DTW engine;
           the baseline is DERIVED from the reference's own hot loop: a
           measured native C++ implementation of its updateOffsetsAsm
           band update (same data flow) x2 for hand-SIMD headroom x16
           for the reference desktop's threads, divided by the
           updates-per-consensus-base count of the faithful host oracle
           on the same job shape.  Full derivation in BASELINE.md.

Stage-breakdown stderr lines split the trim and map engines' steady
state into upload / compute / fetch.  A failing section ends the run
with a nonzero exit.  Inputs are generated under ``.bench_work/``.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from downpore_tpu.cli.main import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

N_READS = 8192
READ_LEN = 3000
BATCH = 4096
SEED = 1234

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def best_of(fn, n=2):
    """Run fn() n times; return (best_seconds, spread) where spread is
    (worst-best)/best over the timed runs."""
    times = []
    for _ in range(n):
        t0 = time.time()
        fn()
        times.append(time.time() - t0)
    best = min(times)
    return best, round((max(times) - best) / max(best, 1e-9), 3)


WORK = os.path.join(REPO, ".bench_work")
RUNNING_JSON = os.path.join(WORK, "bench_running.json")


def emit(metric, value, unit, vs, **extra):
    dev = jax.devices()
    row = {"metric": metric, "value": round(value, 1), "unit": unit,
           "vs_baseline": round(vs, 3), "platform": dev[0].platform,
           "device_kind": dev[0].device_kind, "device_count": len(dev)}
    for kk, vv in extra.items():
        row[kk] = round(vv, 3) if isinstance(vv, float) else vv
    print(json.dumps(row))
    sys.stdout.flush()
    # running record: a suite timeout loses the section in flight, not
    # every completed metric
    with open(RUNNING_JSON, "a") as f:
        f.write(json.dumps(row) + "\n")


def note(msg):
    print("# " + msg, file=sys.stderr)
    sys.stderr.flush()


def rand_seq(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def mutate(rng, s, rate=0.08):
    arr = np.frombuffer(s.encode(), dtype=np.uint8).copy()
    m = rng.random(len(arr)) < rate
    arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return arr.tobytes().decode()


def make_reads(path, n_reads, rng):
    from downpore_tpu.data import FRONT_ADAPTERS, BACK_ADAPTERS
    front = FRONT_ADAPTERS[0][1]
    back = BACK_ADAPTERS[0][1]
    with open(path, "w") as f:
        for i in range(n_reads):
            core = rand_seq(rng, READ_LEN)
            read = mutate(rng, front) + core + mutate(rng, back)
            f.write(f"@read{i}\n{read}\n+\n{'I' * len(read)}\n")
    return os.path.getsize(path)


# ---------------------------------------------------------------------
def bench_trim():
    from downpore_tpu.core import Sequence
    from downpore_tpu.io import SequenceSet
    from downpore_tpu.trim import Trimmer
    from downpore_tpu.data import FRONT_ADAPTERS, BACK_ADAPTERS

    rng = np.random.default_rng(SEED)
    path = os.path.join(WORK, "bench_reads.fastq")
    nbytes = make_reads(path, N_READS, rng)

    fronts = [Sequence.from_string(s, id=i, name=n)
              for i, (n, s) in enumerate(FRONT_ADAPTERS)]
    backs = [Sequence.from_string(s, id=i, name=n)
             for i, (n, s) in enumerate(BACK_ADAPTERS)]

    def run_trim(seq_set, trimmer):
        trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
        trimmer.trim(seq_set, batch_size=BATCH)

    # warmup: small set compiles all kernel shapes
    warm_path = os.path.join(WORK, "bench_warm.fastq")
    make_reads(warm_path, BATCH, np.random.default_rng(SEED + 1))
    trimmer = Trimmer(fronts, backs, k=6, verbosity=0)
    trimmer.determine_adapters(SequenceSet(warm_path, min_length=50),
                               BATCH, 90, batch_size=BATCH)
    run_trim(SequenceSet(warm_path, min_length=50), trimmer)

    # measured: best of two fresh runs (fresh sequence set + trimmer each,
    # I/O included — the reference numbers include I/O).

    def one_run():
        seq_set = SequenceSet(path, min_length=50)
        trimmer2 = Trimmer(trimmer.original_front, trimmer.original_back,
                           k=6, verbosity=0)
        run_trim(seq_set, trimmer2)

    elapsed, spread = best_of(one_run)
    reads_s = N_READS / elapsed
    # reference anchor: ~1 GB/min of fastq on the 16T desktop
    ref_bytes_s = 1e9 / 60.0
    bytes_per_read = nbytes / N_READS
    baseline_reads_s = ref_bytes_s / bytes_per_read
    note(f"trim elapsed={elapsed:.1f}s reads={N_READS} "
         f"mean_read={READ_LEN + 50}b")
    busy = _trim_stage_breakdown(trimmer)
    emit("trim_reads_per_s", reads_s, "reads/s", reads_s / baseline_reads_s,
         busy_frac=busy, spread=spread)


def _trim_stage_breakdown(trimmer):
    """Upload / compute / fetch split for one steady-state window batch
    (at the production mid-stream pair budget), the PIPELINED per-batch
    wall (uploads/fetches of neighbouring batches hidden under compute,
    as the real pipeline runs)."""
    from downpore_tpu.core import Sequence
    rng = np.random.default_rng(SEED + 2)
    eng = trimmer._engine()
    W = trimmer.WINDOW - trimmer.k + 1
    NW = 16384
    wins = [Sequence.from_string(rand_seq(rng, 256), id=i)
            for i in range(NW)]
    min_m = np.full(len(trimmer.front_adapters), 6, np.int64)
    budget = max(4096, NW // 4)   # the production _MidStream budget

    def disp():
        return eng.window_verdict_dispatch(wins, min_m, min_m, 85, W,
                                           pair_budget=budget)

    eng.window_verdict_collect(disp())          # warm
    t0 = time.time()
    km_dev, lens_dev, n = eng.upload(wins, W)
    jax.block_until_ready((km_dev, lens_dev))
    t1 = time.time()
    futs = disp()
    for _, fut, _ in futs:
        if fut is not None:
            jax.block_until_ready(fut)
    t2 = time.time()
    eng.window_verdict_collect(futs)
    t3 = time.time()
    up, comp, fetch = t1 - t0, t2 - t1, t3 - t2
    total = max(1e-9, t3 - t0)
    # pipelined: several batches in flight, as the real driver runs
    t4 = time.time()
    fss = [disp() for _ in range(3)]
    for fs in fss:
        eng.window_verdict_collect(fs)
    pipe = (time.time() - t4) / 3
    busy = min(1.0, comp / max(pipe, 1e-9))
    note(f"trim stage breakdown (16k windows): upload={up:.2f}s "
         f"compute={comp:.2f}s fetch={fetch:.2f}s "
         f"fetch_frac={fetch / total:.2f} pipelined={pipe:.2f}s/batch "
         f"busy_frac={busy:.2f}")
    return busy


# ---------------------------------------------------------------------
def _map_case(GEN, k, n_reads, tag, err=0.08):
    """Build a GEN-base synthetic reference, map n_reads ONT-like reads,
    return (bases/s, mapper, reads).  Best of two timed runs after a
    full warmup (the reference numbers are steady-state too)."""
    from downpore_tpu.core import Sequence
    from downpore_tpu.mapping import Mapper
    from downpore_tpu.utils import kmer_occurrences
    from downpore_tpu.utils.kmers import score_seed_values

    rng = np.random.default_rng(SEED + 10)
    genome = rand_seq(rng, GEN)
    ref = Sequence.from_string(genome, id=0, name=f"ref_{tag}")
    values = score_seed_values(kmer_occurrences([ref], k), k)
    t0 = time.time()
    mapper = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
                    chunk_size=10000)
    t_index = time.time() - t0
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, GEN - 10_000))
        L = int(rng.integers(6000, 10_000))  # ONT-scale read lengths
        s = mutate(rng, genome[p : p + L], err)
        if i % 2:
            s = s.encode().translate(comp)[::-1].decode()
        reads.append(Sequence.from_string(s, id=i, name=f"r{i}"))
    total_bases = sum(len(r) for r in reads)
    mapper.map_batch(reads)          # warmup compiles all shape buckets
    results = []

    def one_run():
        results[:] = mapper.map_batch(reads)

    elapsed, spread = best_of(one_run)
    n_mapped = sum(1 for r in results if r)
    bases_s = total_bases / elapsed
    eng = mapper.engine
    note(f"map[{tag}] elapsed={elapsed:.1f}s reads={n_reads} "
         f"mapped={n_mapped} index_build={t_index:.1f}s "
         f"chunks={eng.C} binned={eng._binned}")
    return bases_s, mapper, reads, dict(spread=spread)


def _map_breakdown(mapper, reads):
    """Pack / compute / fetch split for one steady-state 4096-window
    dispatch."""
    eng = mapper.engine
    windows = []
    for r in reads[:2048]:
        windows.append(r.subsequence(0, 1000))
        windows.append(r.subsequence(len(r) - 1000, len(r)))
    t0 = time.time()
    packed = eng.pack_query_windows(windows)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    t1 = time.time()
    futs = eng.dispatch_packed(packed, base_min)
    if futs[1] is not None:
        jax.block_until_ready(futs[1])
    t2 = time.time()
    eng.collect_arrays(futs)
    t3 = time.time()
    pack, comp, fetch = t1 - t0, t2 - t1, t3 - t2
    total = max(1e-9, t3 - t0)
    note(f"map stage breakdown (4096 windows): pack={pack:.2f}s "
         f"compute={comp:.2f}s fetch={fetch:.2f}s "
         f"fetch_frac={fetch / total:.2f} busy_frac={comp / total:.2f}")


def bench_map():
    # headline: E. coli-scale genome (the reference's flagship benchmark
    # maps a 1.5 GB read set against the 4.6 Mb E. coli genome in 6.7 s
    # on its 16-thread desktop, ref README.md:240 => ~224 MB/s of query
    # bases).  Secondary lines keep the 1 Mb toy case and a 64 Mb
    # chr20-scale case (reference: 48.7 s for a 2 GB read set =>
    # ~41 MB/s, README.md:241).
    ref_ecoli = 1.5e9 / 6.7
    ref_chr20 = 2.0e9 / 48.7

    bases_s, mapper, reads, meta = _map_case(4_600_000, 11, 8192, "4.6Mb")
    _map_breakdown(mapper, reads)
    emit("map_bases_per_s", bases_s, "bases/s", bases_s / ref_ecoli,
         scale="4.6Mb genome", **meta)

    bases_1m, _, _, meta = _map_case(1_000_000, 11, 8192, "1Mb")
    emit("map_1mb_bases_per_s", bases_1m, "bases/s", bases_1m / ref_ecoli,
         scale="1Mb genome (secondary)", **meta)

    bases_64m, _, _, meta = _map_case(64_000_000, 13, 2048, "64Mb")
    emit("map_chr20_bases_per_s", bases_64m, "bases/s",
         bases_64m / ref_chr20, scale="64Mb genome (secondary)", **meta)


# ---------------------------------------------------------------------
def bench_overlap():
    from downpore_tpu.core import Sequence
    from downpore_tpu.seeds import SeedIndex
    from downpore_tpu.overlap import Overlapper, QUERY_EDGES
    from downpore_tpu.utils import kmer_occurrences
    from downpore_tpu.utils.kmers import score_seed_values

    rng = np.random.default_rng(SEED + 20)
    GEN = 400_000
    genome = rand_seq(rng, GEN)
    n_reads = 1024
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, GEN - 10_000))
        L = int(rng.integers(6000, 9600))  # ONT-scale read lengths
        reads.append(Sequence.from_string(
            mutate(rng, genome[p : p + L], 0.05), id=i, name=f"ov{i}"))
    total_bases = sum(len(r) for r in reads)
    k = 10
    counts = kmer_occurrences(reads, k)
    values = score_seed_values(counts, k)

    shape_plan = {}

    def prep_round(first):
        """One round's host half (the CLI's prep_round): pass-2 query
        re-extraction runs concurrently with chunk indexing."""
        index = SeedIndex(k)
        ov = Overlapper(index, 10000, 1000, 15, 0.25,
                        shape_plan=shape_plan)
        queries = ov.prepare_round(15, 100000, values,
                                   iter(reads[first:]), QUERY_EDGES,
                                   iter(reads))
        if not queries:
            return None
        nxt = max(q.sequence_id for q in queries) + 1  # read ids = index
        return ov, queries, nxt

    def run_job():
        """The FULL all-vs-all job: seed-budgeted rounds until every
        read has been queried (the reference's round loop,
        commands/overlap.go:115), with the two-deep pipelined driver —
        the next round's host prep runs on a worker thread under the
        in-flight find AND the current round's collect (the native seed
        walks release the GIL), and its dispatch (index upload) overlaps
        the result fetch.  Results collect through
        the production fetch-to-arrays path (the CLI's fast path); the
        object path is the fallback."""
        from concurrent.futures import ThreadPoolExecutor
        matches = 0
        rounds = 0
        ex = ThreadPoolExecutor(max_workers=1)
        prepped = prep_round(0)
        futs = prepped[0].dispatch_find(prepped[1]) if prepped else None
        prep_fut = (ex.submit(prep_round, prepped[2])
                    if prepped and prepped[2] < n_reads else None)
        while prepped is not None:
            ov, queries, nxt = prepped
            prepped_next = prep_fut.result() if prep_fut else None
            futs_next = (prepped_next[0].dispatch_find(prepped_next[1])
                         if prepped_next else None)
            prep_fut = (ex.submit(prep_round, prepped_next[2])
                        if prepped_next and prepped_next[2] < n_reads
                        else None)
            arrs = ov.collect_find_arrays(queries, futs)
            matches += len(arrs[0]) if arrs is not None else 0
            rounds += 1
            prepped, futs = prepped_next, futs_next
        ex.shutdown(wait=False)
        return matches, rounds

    run_job()                        # warmup compiles
    state = {}

    def one_run():
        state["m"], state["r"] = run_job()

    elapsed, spread = best_of(one_run)
    n_matches, n_rounds = state["m"], state["r"]
    bases_s = total_bases / elapsed

    # one round's fused find kernel on its own
    prepped = prep_round(0)
    ov, queries, _ = prepped
    t1 = time.time()
    eng, subs = ov.dispatch_find(queries)
    jax.block_until_ready([f[1] for _, f in subs])
    t_dev = time.time() - t1
    ov.collect_find(queries, (eng, subs))
    budget = sum(f[2] for _, f in subs)
    note(f"overlap round kernel: dev+dispatch={t_dev:.2f}s "
         f"budget={budget}")

    # conservative proxy anchor: the reference's 1 GB/min trim note (it
    # publishes no absolute all-vs-all time; see module docstring)
    ref_bases_s = 1e9 / 60.0
    note(f"overlap elapsed={elapsed:.1f}s reads={n_reads} "
         f"rounds={n_rounds} matches={n_matches}")
    emit("overlap_bases_per_s", bases_s, "bases/s", bases_s / ref_bases_s,
         spread=spread)


# ---------------------------------------------------------------------
def bench_consensus():
    from downpore_tpu.ops.dtw import consensus_kmers_bulk
    from downpore_tpu.align import SimpleMeasure
    from downpore_tpu.align.dtw import DTWAligner

    rng = np.random.default_rng(SEED + 30)
    k = 5
    # 1024 jobs ~ a GB-scale correct round's consensus load; the bulk
    # engine chunks the job axis at 256 (VMEM-resident window matrices)
    # so throughput is flat in job count from 256 up
    n_jobs, n_members, core_len = 1024, 6, 500

    def job_kmers():
        core = BASES[rng.integers(0, 4, core_len + k - 1)]
        members = []
        for _ in range(n_members):
            arr = core.copy()
            m = rng.random(len(arr)) < 0.08
            arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            codes = np.frombuffer(arr.tobytes().translate(
                bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))), np.uint8)
            km = np.zeros(len(codes) - k + 1, np.int64)
            for j in range(k):
                km = (km << 2) | codes[j : j + len(km)]
            members.append(km.astype(np.int32))
        return members

    jobs = [job_kmers() for _ in range(n_jobs)]
    table = SimpleMeasure(k).pair_table()
    # simple_k engages the arithmetic distance (the production path for
    # the default SimpleMeasure; consensus/consensus.py:153-156)
    # warmup with the full job set: a smaller slice pads to a different
    # bucket and the first timed run would compile
    consensus_kmers_bulk(jobs, table, k, simple_k=k)
    outs = []

    def one_run():
        outs[:] = consensus_kmers_bulk(jobs, table, k, simple_k=k)

    elapsed, spread = best_of(one_run)
    total_bases = sum(len(o) + k - 1 for o in outs if len(o))
    bases_s = total_bases / elapsed

    # Baseline derived from the reference's own hot loop (no published
    # consensus throughput exists):
    #   U  = band updates per consensus base, counted by running the
    #        faithful host oracle on this exact job shape;
    #   M  = measured native C++ rate of the identical band update on
    #        this machine (single thread; same data flow as
    #        updateOffsetsAsm, ref sequence/alignment/asm_amd64.s:17-149);
    #   anchor = M x 2 (headroom of hand SIMD over compiled C++)
    #              x 16 (the reference desktop's threads, assumed to
    #                    scale perfectly — generous to the reference)
    #              / U.
    # The full derivation is recorded in BASELINE.md.
    t1 = time.time()
    n_upd = n_base = 0
    for job in jobs[:2]:
        m = SimpleMeasure(k)
        m.set_sequences(job, [False] * len(job))
        al = DTWAligner(16, 5, m, False, 200, k)
        al.global_consensus()
        n_upd += al.n_band_updates
        n_base += core_len + k - 1
    host_dt = time.time() - t1
    host_bases_s = n_base / host_dt
    upd_per_base = n_upd / max(1, n_base)

    from downpore_tpu import native
    W = 32                              # the reference's band width
    nb = 4096
    rng2 = np.random.default_rng(SEED + 31)
    ds = rng2.integers(0, 60, (nb, W)).astype(np.uint16)
    bands = rng2.integers(0, 500, (nb, W)).astype(np.uint16)
    native.band_update_rounds(ds, bands, 200, 50)      # warm
    t1 = time.time()
    reps = 1000
    chk = native.band_update_rounds(ds, bands, 200, reps)
    upd_rate = nb * reps / (time.time() - t1) if chk is not None else 30e6
    baseline = upd_rate * 2 * 16 / upd_per_base
    note(f"consensus elapsed={elapsed:.2f}s jobs={n_jobs} "
         f"members={n_members} host_oracle={host_bases_s:.0f} bases/s; "
         f"anchor: {upd_rate / 1e6:.0f}M native band-updates/s x2 x16T "
         f"/ {upd_per_base:.0f} updates/base = {baseline / 1e6:.2f} "
         f"Mbases/s")
    emit("consensus_bases_per_s", bases_s, "bases/s", bases_s / baseline,
         spread=spread)


# ---------------------------------------------------------------------
def _make_reads_bulk(path, n_reads, read_len=3000):
    """Vectorized ~GB-scale synthetic fastq generator (adapter + core +
    adapter per read, 2% adapter noise).  Reuses an existing file of the
    right size so repeated bench runs skip the generation."""
    from downpore_tpu.data import FRONT_ADAPTERS, BACK_ADAPTERS
    marker = path + ".meta"
    if os.path.exists(path) and os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == f"{n_reads}:{read_len}":
                return os.path.getsize(path)
    rng = np.random.default_rng(SEED + 77)
    f_ad = np.frombuffer(FRONT_ADAPTERS[0][1].encode(), np.uint8)
    b_ad = np.frombuffer(BACK_ADAPTERS[0][1].encode(), np.uint8)
    B = 4096
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, n_reads, B):
            n = min(B, n_reads - lo)
            cores = BASES[rng.integers(0, 4, (n, read_len))]
            fa = np.broadcast_to(f_ad, (n, len(f_ad))).copy()
            ba = np.broadcast_to(b_ad, (n, len(b_ad))).copy()
            for arr in (fa, ba):
                m = rng.random(arr.shape) < 0.02
                arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            qual = "I" * (read_len + len(f_ad) + len(b_ad))
            rows = np.concatenate([fa, cores, ba], axis=1)
            chunks = []
            for i in range(n):
                chunks.append(f"@gr{lo + i}\n")
                chunks.append(rows[i].tobytes().decode())
                chunks.append(f"\n+\n{qual}\n")
            f.write("".join(chunks))
    with open(marker, "w") as f:
        f.write(f"{n_reads}:{read_len}")
    return os.path.getsize(path)


def bench_trim_gb():
    """GB-scale end-to-end trim: the full CLI flow (streamed edge +
    middle passes, then re-read + re-emit of the trimmed fastq) over a
    ~1 GB on-disk file, I/O included — the reference's own methodology
    (its 1 GB/min worst-case demultiplex anchor and 25-31x Porechop
    trim runs are wall-clock over 0.5-2 GB files,
    ref README.md:126,135-142).  Reports MB/s of input fastq and peak
    RSS."""
    import resource
    from downpore_tpu.core import Sequence
    from downpore_tpu.io import SequenceSet
    from downpore_tpu.trim import Trimmer
    from downpore_tpu.data import FRONT_ADAPTERS, BACK_ADAPTERS

    path = os.path.join(WORK, "bench_gb.fastq")
    n_reads = 163_840                 # ~1 GB at 3 kb reads
    t0 = time.time()
    nbytes = _make_reads_bulk(path, n_reads)
    note(f"gb-scale fastq: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")

    fronts = [Sequence.from_string(s, id=i, name=n)
              for i, (n, s) in enumerate(FRONT_ADAPTERS)]
    backs = [Sequence.from_string(s, id=i, name=n)
             for i, (n, s) in enumerate(BACK_ADAPTERS)]
    # warm the batch_size=8192 kernel shapes on a small slice (the
    # steady-state measurement below must not pay first-compiles: a
    # cold run measured 8.3 MB/s vs 23 MB/s warm on a 100 MB slice)
    warm_path = os.path.join(WORK, "bench_gb_warm.fastq")
    _make_reads_bulk(warm_path, 8192)
    wset = SequenceSet(warm_path, min_length=50)
    wtr = Trimmer(fronts, backs, k=6, verbosity=0)
    wtr.set_trim_params(85, 5, 50, 1000, True, True, False)
    wtr.trim(wset, batch_size=8192)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t1 = time.time()
    seq_set = SequenceSet(path, min_length=50)
    trimmer = Trimmer(fronts, backs, k=6, verbosity=0)
    trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
    trimmer.trim(seq_set, batch_size=8192)
    out_path = os.path.join(WORK, "bench_gb_trimmed.fastq")
    with open(out_path, "w", buffering=1 << 22) as out:
        seq_set.write(out)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    mb_s = nbytes / dt / 1e6
    note(f"gb-scale trim: {dt:.1f}s wall (trim+re-emit), peak_rss="
         f"{rss:.1f}GB (suite baseline {rss0 / 1e6:.1f}GB), "
         f"out={os.path.getsize(out_path) / 1e9:.2f}GB")
    os.remove(out_path)
    # anchor: the reference's worst-case 1 GB/min = 16.7 MB/s.
    # peak_rss_gb is the PROCESS high-water mark (the suite's earlier
    # 64 Mb map section dominates it); rss_delta_gb is what this
    # section itself added
    emit("trim_gb_scale_mb_per_s", mb_s, "MB/s", mb_s / 16.7,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6)


def _make_genome_reads(path, genome, n_reads, read_len, err, seed,
                       rc_half=True):
    """Vectorized on-disk fasta of reads sampled from `genome` (bytes
    array) with substitution noise; half reverse-complemented.  Reuses an
    existing file of the right shape."""
    marker = path + ".meta"
    key = f"{len(genome)}:{n_reads}:{read_len}:{err}:{seed}"
    if os.path.exists(path) and os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == key:
                return os.path.getsize(path)
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    B = 2048
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, n_reads, B):
            n = min(B, n_reads - lo)
            starts = rng.integers(0, len(genome) - read_len, n)
            rows = np.stack([genome[s:s + read_len] for s in starts])
            m = rng.random(rows.shape) < err
            rows[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            chunks = []
            for i in range(n):
                s = rows[i].tobytes()
                if rc_half and (lo + i) % 2:
                    s = s.translate(comp)[::-1]
                chunks.append(f">gr{lo + i}\n")
                chunks.append(s.decode())
                chunks.append("\n")
            f.write("".join(chunks))
    with open(marker, "w") as f:
        f.write(key)
    return os.path.getsize(path)


def _run_command(cmd_cls, argv, out_path):
    """Drive a real CLI command with stdout redirected to a file —
    the disk-to-disk methodology of the reference's README numbers."""
    from downpore_tpu.cli.framework import parse_argv
    import contextlib
    cmd = cmd_cls()
    args = parse_argv(cmd, argv)
    with open(out_path, "w", buffering=1 << 22) as out, \
            contextlib.redirect_stdout(out):
        cmd.run(args)


def bench_map_gb():
    """Disk-to-disk map: a ~0.5 GB on-disk fasta of
    8 kb reads streamed through the REAL map command (index build, PAF to
    a file, I/O included) against a 4.6 Mb genome — the reference's own
    methodology (1.5 GB E. coli fasta in 6.7 s end-to-end,
    ref README.md:240)."""
    import resource
    from downpore_tpu.cli.map_command import MapCommand

    rng = np.random.default_rng(SEED + 40)
    GEN = 4_600_000
    genome = BASES[rng.integers(0, 4, GEN)]
    gpath = os.path.join(WORK, "bench_map_gb_ref.fasta")
    with open(gpath, "w") as f:
        f.write(">ref\n" + genome.tobytes().decode() + "\n")
    n_reads = 61_000                       # ~0.5 GB at 8 kb reads
    rpath = os.path.join(WORK, "bench_map_gb_reads.fasta")
    t0 = time.time()
    nbytes = _make_genome_reads(rpath, genome, n_reads, 8000, 0.08,
                                SEED + 41)
    note(f"map_gb fasta: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out_path = os.path.join(WORK, "bench_map_gb.paf")
    t1 = time.time()
    _run_command(MapCommand, ["-input", rpath, "-reference", gpath,
                              "-circular", "false"], out_path)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    n_out = sum(1 for _ in open(out_path))
    mb_s = nbytes / dt / 1e6
    note(f"map_gb: {dt:.1f}s wall (index+map+PAF), {n_out} PAF lines, "
         f"peak_rss={rss:.1f}GB (delta {rss - rss0 / 1e6:.2f}GB)")
    os.remove(out_path)
    # anchor: the reference's flagship 1.5 GB / 6.7 s = 224 MB/s
    emit("map_gb_mb_per_s", mb_s, "MB/s", mb_s / 224.0,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6)


def bench_overlap_gb():
    """Disk-to-disk all-vs-all overlap through the REAL overlap command
    (full seed-budgeted round loop, consensus final check, PAF to a
    file).  All-vs-all is O(rounds x whole-file reindex) by design — the
    input is sized so the full job finishes in bench budget; MB/s is
    whole-job wall over input bytes, same conservative 1 GB/min proxy
    anchor as the in-memory metric."""
    import resource
    from downpore_tpu.cli.overlap_command import OverlapCommand

    rng = np.random.default_rng(SEED + 50)
    GEN = 2_000_000
    genome = BASES[rng.integers(0, 4, GEN)]
    n_reads = 12_000                       # ~0.1 GB at 8 kb reads
    rpath = os.path.join(WORK, "bench_ov_gb_reads.fasta")
    t0 = time.time()
    nbytes = _make_genome_reads(rpath, genome, n_reads, 8000, 0.05,
                                SEED + 51)
    note(f"overlap_gb fasta: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out_path = os.path.join(WORK, "bench_ov_gb.paf")
    t1 = time.time()
    _run_command(OverlapCommand, ["-input", rpath], out_path)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    n_out = sum(1 for _ in open(out_path))
    mb_s = nbytes / dt / 1e6
    note(f"overlap_gb: {dt:.1f}s wall (full job), {n_out} PAF lines, "
         f"peak_rss={rss:.1f}GB (delta {rss - rss0 / 1e6:.2f}GB)")
    os.remove(out_path)
    emit("overlap_gb_mb_per_s", mb_s, "MB/s", mb_s / 16.7,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6)


def main():
    t_setup = time.time()
    note(f"backend={jax.default_backend()}")
    # Headline metrics FIRST (trim, map, overlap, consensus), GB-scale
    # disk-to-disk tails LAST — a timeout then loses a tail section,
    # never the headline evidence.
    sections = [("trim", bench_trim), ("map", bench_map),
                ("overlap", bench_overlap), ("consensus", bench_consensus),
                ("trim_gb", bench_trim_gb), ("map_gb", bench_map_gb),
                ("overlap_gb", bench_overlap_gb)]
    only = set(sys.argv[1:])
    if only:
        known = {n for n, _ in sections}
        unknown = only - known
        if unknown:  # a typo must not silently produce an empty run
            note(f"ERROR: unknown section(s) {sorted(unknown)}; "
                 f"known: {sorted(known)}")
            sys.exit(2)
        sections = [(n, f) for n, f in sections if n in only]
    os.makedirs(WORK, exist_ok=True)
    if os.path.exists(RUNNING_JSON):
        os.remove(RUNNING_JSON)
    for name, fn in sections:
        t0 = time.time()
        fn()
        note(f"{name} section total {time.time() - t0:.1f}s")
    note(f"suite total {time.time() - t_setup:.1f}s")


if __name__ == "__main__":
    main()
