"""The map command (ref: commands/map.go:17-116)."""
from __future__ import annotations

import sys

from .framework import Command, parse_bool, parse_int


class MapCommand(Command):
    name = "map"

    def __init__(self):
        super().__init__(
            ["input", "reference", "circular", "k", "query_size",
             "min_length", "chunk_size", "seed_rate", "num_workers",
             "data_parallel", "seed_shards"],
            ["", "", "true", "11", "1000", "500", "10000", "40", "4",
             "false", "1"],
            ["Fasta/fastq input file",
             "A fasta file containing a reference sequence to align against",
             "Whether the reference genome is circular",
             "Length of seeds in bases",
             "The number of bases to query at a time",
             "The minimum sequence size to generate queries from",
             "The number of bases for reference index chunks",
             "The maximum number of bases between seeds in the reference",
             "The number of worker process to use for mapping",
             "Shard query batches across all attached devices "
             "(jax.sharding data mesh; the reference index replicates)",
             "Shard the seed index over this many devices (with "
             "-data_parallel: a data x seed mesh; retrieval counts merge "
             "with a psum over the seed axis)"])

    def run(self, args):
        from ..io import SequenceSet
        from ..mapping import Mapper
        from ..utils import kmer_occurrences
        from ..utils.kmers import score_seed_values

        k = parse_int(args["k"])
        ref_set = SequenceSet(args["reference"])
        reference = next(iter(ref_set.get_sequences()))
        mesh = None
        n_seed = parse_int(args["seed_shards"])
        if parse_bool(args["data_parallel"]) or n_seed > 1:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(n_seed=n_seed)
        # multi-device meshes count on device (sharded bincount + psum)
        counts = kmer_occurrences(ref_set.get_sequences(), k, mesh=mesh)
        values = score_seed_values(counts, k)
        print("K-mer counting complete. Preparing to start indexing and "
              "querying...", file=sys.stderr)
        mapper = Mapper(reference, parse_bool(args["circular"]), k, values,
                        parse_int(args["seed_rate"]),
                        parse_int(args["query_size"]),
                        parse_int(args["chunk_size"]), mesh=mesh)
        seq_set = SequenceSet(args["input"],
                              min_length=parse_int(args["min_length"]))
        mapped = multiple = unmapped = total = 0
        batch = []
        batch_size = 8192  # big batches keep the device fed (the
        # reference streams per-read through a worker pool; ours amortizes
        # dispatch latency across reads).  map_batch stages globally —
        # all reads' end windows in one pipelined dispatch train, then one
        # step-inward stage, then the chimera stage — so each flush pays
        # a handful of device fetches regardless of size.

        def flush(batch):
            nonlocal mapped, multiple, unmapped, total
            lines = []
            for maps in mapper.map_batch(batch):
                if maps:
                    for m in maps:
                        lines.append(mapper.as_string(m))
                    if len(maps) == 1:
                        mapped += 1
                    else:
                        multiple += 1
                    total += len(maps)
                else:
                    unmapped += 1
            if lines:                      # one buffered write per batch
                lines.append("")
                sys.stdout.write("\n".join(lines))

        # parse-ahead pipeline: the NEXT batch parses/encodes on a worker
        # thread while the current batch maps (the device waits release
        # the GIL), so fasta parsing does not serialize with the device
        from concurrent.futures import ThreadPoolExecutor
        it = seq_set.get_sequences()

        def take_batch():
            b = []
            for seq in it:
                b.append(seq)
                if len(b) >= batch_size:
                    break
            return b

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(take_batch)
            while True:
                batch = fut.result()
                if not batch:
                    break
                fut = ex.submit(take_batch)
                flush(batch)
        print("Uniquely mapped:", mapped, file=sys.stderr)
        print("Multiple mappings:", multiple, file=sys.stderr)
        print("total:", total, file=sys.stderr)
        print("Unmapped:", unmapped, file=sys.stderr)
