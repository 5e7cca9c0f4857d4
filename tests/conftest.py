"""Test harness: run everything on a virtual 8-device CPU mesh.

Tests exercise the same code paths on the CPU (XLA host platform, Pallas
kernels in interpret mode) with 8 virtual devices, so the sharded step is
validated without several GPUs.  Tests marked ``gpu`` need a card: they
skip here, and run on a GPU machine with
``PICLES_TEST_GPU=1 python -m pytest tests/ -m gpu`` (``chip_smoke.py``
runs the same checks at production size).
"""

import os
import sys

if not os.environ.get("PICLES_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Silence XLA:CPU AOT-loader feature-mismatch ERROR spam from persistent-
# cache loads (generated and consumed on the same host, so the flagged
# pseudo-feature mismatch — +prefer-no-scatter/gather — is benign).
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

# Persistent compilation cache: the suite builds hundreds of model
# instances whose jitted steps lower to identical HLO; JAX's in-memory
# jit cache cannot hit across fresh closures, but the disk cache can —
# INCLUDING within a single cold run (the first test of a config pays the
# ~5 s XLA compile, every later same-config test pays ~0.7 s).  Keyed by
# HLO hash, so code changes miss cleanly.
from picles_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# two-tier suite: interpret-mode Pallas goldens grew the default wall time
# past 27 min.  Tests marked `slow` are the EXHAUSTIVE
# tier — redundant backend x config parametrizations whose kernel family is
# still covered by a cheaper default-tier sibling.  They are skipped by
# default and run with `--runslow` (or PICLES_SLOW=1), which CI should do
# on a slower cadence.  Nothing marked slow is the only lock for a feature.
# ---------------------------------------------------------------------------


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run the exhaustive `slow` tier (redundant backend "
             "sweeps); equivalent to PICLES_SLOW=1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: exhaustive-tier test (redundant backend/config sweep with a "
        "cheaper default-tier sibling); skipped unless --runslow or "
        "PICLES_SLOW=1")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (compiled Triton kernels); the `gpu` fixture "
        "skips it elsewhere")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import or collection)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with PICLES_TEST_GPU=1 on a GPU "
                    "machine")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("PICLES_SLOW"):
        return
    skip = pytest.mark.skip(
        reason="exhaustive tier: run with --runslow or PICLES_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
