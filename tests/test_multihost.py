"""Multi-host simulation: two jax.distributed CPU processes cooperating on
a sharded hit-count computation (the multi-host story the reference never
had; SURVEY.md §5)."""
import os
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize(coordinator_address="127.0.0.1:12399",
                           num_processes=2, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

devs = jax.devices()
assert len(devs) == 4, f"expected 4 global devices, got {len(devs)}"
mesh = Mesh(np.array(devs).reshape(4, 1), ("data", "seed"))

rng = np.random.default_rng(0)
V = rng.integers(0, 2, (8, 256)).astype(np.int8)
M = rng.integers(0, 2, (256, 32)).astype(np.int8)

# each process provides its shard of the query batch
from jax.experimental import multihost_utils
sharding = NamedSharding(mesh, P("data", None))
gV = multihost_utils.host_local_array_to_global_array(
    V[pid * 4:(pid + 1) * 4], mesh, P("data", None))
gM = multihost_utils.host_local_array_to_global_array(M, mesh, P())

@jax.jit
def counts(v, m):
    return jax.lax.dot_general(v, m, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)

out = jax.jit(counts, out_shardings=NamedSharding(mesh, P("data", None)))(gV, gM)
local = multihost_utils.global_array_to_host_local_array(
    out, mesh, P("data", None))
want = V[pid * 4:(pid + 1) * 4].astype(np.int32) @ M.astype(np.int32)
assert np.array_equal(np.asarray(local), want), "shard mismatch"
print(f"proc {pid} OK")
"""


def _run_two_procs(tmp_path, worker_src, timeout=250):
    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out


def test_two_process_distributed(tmp_path):
    _run_two_procs(tmp_path, WORKER)


# Production pipeline under jax.distributed: a real
# map_batch — fused retrieval + chain DP + candidate walk — runs
# data-parallel across 2 CPU processes (4 global devices) and must emit
# byte-identical PAF strings to the single-process mapper in BOTH
# processes.
MAP_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, REPO_ROOT)
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize(coordinator_address="127.0.0.1:12431",
                           num_processes=2, process_id=pid)
import numpy as np

from downpore_tpu.core import Sequence
from downpore_tpu.mapping import Mapper
from downpore_tpu.utils import kmer_occurrences
from downpore_tpu.utils.kmers import score_seed_values
from downpore_tpu.parallel.mesh import make_mesh

assert len(jax.devices()) == 4

rng = np.random.default_rng(5)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
genome = BASES[rng.integers(0, 4, 30000)].tobytes().decode()
ref = Sequence.from_string(genome, id=0, name="ref")
k = 8
values = score_seed_values(kmer_occurrences([ref], k), k)

reads = []
for i in range(16):
    p = int(rng.integers(0, len(genome) - 2500))
    s = genome[p:p + 2400]
    arr = np.frombuffer(s.encode(), np.uint8).copy()
    m = rng.random(len(arr)) < 0.03
    arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    reads.append(Sequence.from_string(arr.tobytes().decode(), id=i,
                                      name=f"r{i}"))

base_mapper = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
                     chunk_size=10000)
base = [[base_mapper.as_string(m) for m in (maps or [])]
        for maps in base_mapper.map_batch(reads)]

mesh = make_mesh()
mp_mapper = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
                   chunk_size=10000, mesh=mesh)
out = [[mp_mapper.as_string(m) for m in (maps or [])]
       for maps in mp_mapper.map_batch(reads)]

assert out == base, "multi-process output diverged"
assert sum(len(x) for x in out) > 0, "no mappings produced"
print(f"proc {pid} OK")
"""


def test_two_process_map_batch(tmp_path):
    """A real production pipeline (map_batch with -data_parallel mesh)
    across 2 jax.distributed processes, byte-identical to single-process
    (SURVEY §2.3 multi-host row)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _run_two_procs(tmp_path,
                   MAP_WORKER.replace("REPO_ROOT", repr(root)))
