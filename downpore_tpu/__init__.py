
# glibc malloc tuning: in sandboxed environments, returning big buffers
# to the OS makes every fresh multi-hundred-MB numpy allocation re-fault
# its pages at ~90 us/page (measured: a 0.5 GB astype cost 12 s; the
# identical op on recycled pages 0.17 s).  Keeping large allocations on
# the heap and never trimming lets the allocator recycle mapped pages.
# Opt out with DOWNPORE_NO_MALLOPT=1.
import os as _os

if not _os.environ.get("DOWNPORE_NO_MALLOPT"):
    try:
        import ctypes as _ctypes
        _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-4, 0)          # M_MMAP_MAX = 0
        _libc.mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD = never
    except Exception:
        pass
"""downpore_tpu — a JAX long-read sequence-analysis engine.

A from-scratch JAX/XLA framework with the capabilities of the
reference Go toolkit jteutenberg/downpore: adapter trimming and
demultiplexing, seed-chain read mapping, all-vs-all overlap detection and
pileup/consensus correction for nanopore long reads.

Design (see SURVEY.md for the reference analysis):

* Reads are 2-bit encoded into fixed-shape padded batches on the host
  (``downpore_tpu.core``), streamed by ``downpore_tpu.io``.
* The gapped-seed representation and seed index live in
  ``downpore_tpu.seeds``; candidate retrieval is an int8 matmul or a
  gather-sum over a seed-membership matrix on device rather than the reference's bitset soft-union
  (ref: util/bitset.go:308, seeds/seeds.go:335).
* In-order seed chaining is a batched anchor DP on device
  (``downpore_tpu.ops.chain``), replacing the reference's greedy
  per-read chain walk (ref: seeds/sequence.go:401).
* The banded multi-sequence DTW consensus is a vmapped beam scan in XLA
  (``downpore_tpu.ops.dtw``), replacing the hand-written amd64 band
  update (ref: sequence/alignment/asm_amd64.s:17).
* Multi-chip scaling is data-parallel over reads with the seed index
  replicated or sharded by seed bucket on a ``jax.sharding.Mesh``
  (``downpore_tpu.parallel``).
"""

__version__ = "0.1.0"


def _tune_allocator():
    """Keep large numpy buffers in the heap instead of mmap/munmap churn.

    glibc serves multi-MB allocations with fresh mmaps and returns them on
    free; in sandboxed environments first-touch page faults on those can
    cost ~100x normal (observed: a [8k, 990] int32 pipeline spending 26 s
    on faults vs 0.5 s of compute).  Raising the mmap/trim thresholds
    makes freed blocks stay resident so steady-state batch code runs at
    memory speed.  Best-effort: silently skipped off glibc."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


def _prefault_arena():
    """Populate a scratch arena once so batch pipelines never pay
    first-touch faults mid-run.

    User-space first-touch in this class of sandbox costs ~180 ms/MB
    (measured: 45 s for 256 MB), but the kernel populate path is ~500x
    faster — ``mlock`` faults the pages in-kernel in ~0.1 s/256 MB.  With
    the raised trim threshold the pages stay in the heap after free, so
    subsequent large numpy buffers land on resident memory.  Size via
    DOWNPORE_PREFAULT_MB (default 768; 0 disables)."""
    import os
    try:
        mb = int(os.environ.get("DOWNPORE_PREFAULT_MB", "768"))
    except ValueError:
        mb = 768
    if mb <= 0:
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.malloc.restype = ctypes.c_void_p
        n = mb << 20
        p = libc.malloc(n)
        if p:
            if libc.mlock(ctypes.c_void_p(p), n) == 0:
                libc.munlock(ctypes.c_void_p(p), n)
            else:  # mlock refused (rlimit): fall back to touching
                ctypes.memset(p, 0, n)
            libc.free(ctypes.c_void_p(p))
    except Exception:
        pass


_tune_allocator()
_prefault_arena()
