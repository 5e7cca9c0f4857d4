"""Runtime diagnostics and profiling hooks.

The reference sprinkles @info/@show plus BenchmarkTools dev-side timing
(SURVEY §5); here: structured per-step diagnostics (the
mean_of_state/max_energy helpers of TimeSteppers.jl:15-33), a NaN checker
(the reference's commented-out NaNChecker callback, simulation.jl:63-75),
and a JAX-profiler trace context for device performance work."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np


def mean_of_state(ms) -> float:
    """Reference TimeSteppers.jl:15-17."""
    return float(jnp.mean(ms.state[..., 0]))


def max_energy(ms) -> float:
    return float(jnp.max(ms.state[..., 0]))


def max_cgx(ms) -> float:
    return float(jnp.max(ms.state[..., 1]))


def max_cgy(ms) -> float:
    return float(jnp.max(ms.state[..., 2]))


def check_nans(ms, name: str = "state") -> None:
    """Raise if the prognostic state contains NaN (NaNChecker analog)."""
    arr = np.asarray(ms.state)
    if not np.all(np.isfinite(arr)):
        n = int(np.sum(~np.isfinite(arr)))
        raise FloatingPointError(f"{n} non-finite values in {name} at "
                                 f"t={float(ms.time)}")


def step_summary(ms) -> dict:
    """One structured log record per step."""
    m = ms.metrics
    return dict(time=float(ms.time), iteration=int(ms.iteration),
                mean_e=mean_of_state(ms), max_e=max_energy(ms),
                n_active=int(m.n_active), n_failed=int(m.n_failed),
                n_gather=int(m.n_gather), n_reseed=int(m.n_reseed),
                n_off=int(m.n_off), n_relight=int(m.n_relight),
                n_clamped=int(m.n_clamped),
                substeps_max=int(m.substeps_max))


@contextlib.contextmanager
def profile_trace(logdir: str = "picles_trace") -> Iterator[None]:
    """Capture a JAX/XLA profiler trace around a block (open with
    tensorboard or xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock per-step timing with device sync (dev-side @time analog)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        a = np.asarray(self.times)
        if a.size == 0:
            return {}
        return dict(n=a.size, mean_s=float(a.mean()), min_s=float(a.min()),
                    p50_s=float(np.percentile(a, 50)),
                    p95_s=float(np.percentile(a, 95)))
