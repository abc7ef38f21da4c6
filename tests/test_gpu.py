"""Kernel checks that need an NVIDIA GPU: the device kernels of the main
path against their plain references at the widths of the E. coli-scale
map job.  ``chip_smoke.py`` runs the same checks in its kernel phase;
``pytest -m gpu tests/`` runs them alone on a machine with a GPU.  Off
the GPU every test here skips."""
import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_CHUNKS = 465        # chunk count of the 4.6 Mb map index


@pytest.fixture
def smoke():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_hit_counts_exact(smoke):
    smoke.check_hit_counts(np.random.default_rng(0), MAP_CHUNKS)


def test_count_rows_exact(smoke):
    smoke.check_count_rows(np.random.default_rng(1), MAP_CHUNKS)


def test_chain_batch_exact(smoke):
    smoke.check_chain_batch(np.random.default_rng(2))


@pytest.mark.parametrize("k", [5, 7])
def test_consensus_bit_exact(smoke, k):
    smoke.check_consensus(np.random.default_rng(3 + k), k)
