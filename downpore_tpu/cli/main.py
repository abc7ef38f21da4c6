"""Entry point: ``python -m downpore_tpu.cli <command> [-flag value ...]``
with the same commands, flags and help output shape as the reference binary
(ref: downpore.go:53-92)."""
from __future__ import annotations

import os
import sys

from .framework import aligned_print, parse_argv


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    root of the checkout.  A fixed path, because the path is part of the
    cache key."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache, so a command's second
    run skips the XLA compiles of the fused kernels.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself, and no other
    directory is set here."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def get_commands():
    from .consensus_command import AlignCommand, ConsensusCommand
    from .correct_command import CorrectCommand
    from .kmers_command import KmersCommand
    from .map_command import MapCommand
    from .overlap_command import OverlapCommand
    from .subseq_command import SubSeqCommand
    from .trim_command import TrimCommand
    from .version_command import VersionCommand
    return [TrimCommand(), MapCommand(), OverlapCommand(), SubSeqCommand(),
            ConsensusCommand(), AlignCommand(), CorrectCommand(),
            KmersCommand(), VersionCommand()]


def main(argv=None):
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    coms = get_commands()
    if not argv:
        print("Available commands:\n help <command> "
              "Describe the command and its arguments")
        for com in coms:
            print(" " + com.name)
        return 0
    if argv[0] == "help":
        if len(argv) > 1:
            for com in coms:
                if com.name == argv[1]:
                    lines = []
                    for arg, default in com.args.items():
                        a = com.alias.get(arg)
                        lines.append(["-" + arg, "-" + a if a else "",
                                      com.desc[arg],
                                      "(default:" + default + ")"])
                    aligned_print(lines)
                    return 0
        print("Usage: downpore help <command>\n"
              "To see a list of available commands just run downpore")
        return 0
    for com in coms:
        if com.name == argv[0]:
            com.run(parse_argv(com, argv[1:]))
            return 0
    print("Available commands:\n help <command> "
          "Describe the command and its arguments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
