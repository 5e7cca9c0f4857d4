"""Simulation driver (reference src/Simulations/simulation.jl + run.jl).

``run`` keeps the reference loop semantics — initial store write, one model
step per DT until ``clock.time`` exceeds ``stop_time`` — but the device-side
work is chunked through ``lax.scan`` (``chunk_size`` steps per dispatch) so
the host loop never throttles the device; stores receive stacked blocks.

Unlike the reference, ``pickup`` (checkpoint resume) actually works — see
picles_tpu.simulation.checkpoint.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import jax
import numpy as np

from .store import CashStore, EmptyStore, StateStore


@dataclasses.dataclass
class Simulation:
    """Driver state (reference simulation.jl:12-99).

    ``callbacks``: name -> callable(sim), invoked after every device
    dispatch (chunk) — the reference DECLARES ``diagnostics`` /
    ``callbacks`` OrderedDicts but never runs them (simulation.jl:63-75,
    commented-out NaNChecker); here they are live.  A callback that
    raises stops the run (e.g. ``picles_tpu.utils.diagnostics.check_nans``
    on ``sim.state`` is the working NaNChecker).
    """

    model: object
    dt: float
    stop_time: float
    wall_time_limit: float = float("inf")
    verbose: bool = False
    store: object = dataclasses.field(default_factory=EmptyStore)
    state: object = None
    initialized: bool = False
    run_wall_time: float = 0.0
    running: bool = False
    callbacks: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, model, stop_time: float, verbose: bool = False,
               wall_time_limit: float = float("inf")) -> "Simulation":
        return cls(model=model, dt=model.settings.timestep,
                   stop_time=stop_time, verbose=verbose,
                   wall_time_limit=wall_time_limit)

    # -- initialization ------------------------------------------------

    def initialize(self) -> None:
        """Seed particles (reference initialize_simulation!, run.jl:130-146)."""
        self.state = self.model.init_state()
        self.initialized = True

    def reset(self) -> None:
        """Reference reset_simulation! (run.jl:154-181)."""
        self.initialize()
        self.run_wall_time = 0.0
        # every store kind resets (a kept CashStore would otherwise append
        # the next run's history after the previous one's snapshots)
        self.store.reset()

    def pickup(self, path: str) -> None:
        """Resume from a checkpoint (the reference's run!(pickup=...) is a
        no-op stub, run.jl:32-36; this one works)."""
        from .checkpoint import load_checkpoint

        self.state = load_checkpoint(path)
        self.initialized = True

    def checkpoint(self, path: str) -> str:
        from .checkpoint import save_checkpoint

        return save_checkpoint(path, self.state)

    def n_steps(self) -> int:
        """Steps executed by the reference loop: runs while
        stop_time >= clock.time (run.jl:72-113)."""
        return int(np.floor(self.stop_time / self.dt)) + 1

    # -- stores --------------------------------------------------------

    def init_state_store(self, path: str, name: str = "state",
                         replace: bool = True) -> StateStore:
        """Reference init_state_store! (storing.jl:83-102).

        Layered models (``model.layers > 1``) store
        ``[time, layer, x, y, state]`` (the reference's 4D State,
        WaveGrowthModels2D.jl:112-119).  ``replace=False`` re-attaches an
        existing file in append mode (checkpoint-resume legs): the run
        loop aligns the write cursor to the resumed state's iteration, so
        the resumed history lands on its time-correct rows."""
        g = self.model.grid
        nsteps = self.n_steps()
        coords = dict(
            time=np.arange(0.0, (nsteps + 1) * self.dt, self.dt)[:nsteps + 1])
        layers = getattr(self.model, "layers", 1)
        if layers > 1:
            coords["layer"] = np.arange(layers, dtype=float)
        coords["x"] = (np.asarray(jax.device_get(g.x[:, 0])) if g.x.ndim == 2
                       else np.asarray(jax.device_get(g.x)))
        if g.x.ndim == 2:
            coords["y"] = np.asarray(jax.device_get(g.y[0, :]))
        coords["state"] = ["e", "m_x", "m_y"]
        self.store = StateStore(path, coords, name=name, replace=replace)
        return self.store

    # -- main loop -----------------------------------------------------

    def run(self, store: bool = False, cash_store: bool = False,
            chunk_size: int = 0) -> None:
        """Reference run! (run.jl:36-122).

        With a store attached, states are needed every step: steps run in
        ``lax.scan`` chunks of ``chunk_size`` (default 64) whose stacked
        outputs feed the store in blocks — the stacked scan output is
        ``[chunk, nx, ny, 3]`` on device regardless of horizon (an
        unchunked 6-day 1536^2 endurance run would stack ~24 GB of
        history on the device; the reference writes the store once per step and
        never materializes a history, run.jl:94-112).  Without a store,
        steps run through ``step_n_quiet`` (``fori_loop``, no per-step
        output) so peak device memory stays O(state) for any horizon; a
        finite ``wall_time_limit`` chunks that path too so the limit is
        enforced between device dispatches (the reference checks wall time
        once per step, run.jl:117-121).
        """
        t_wall = _time.time()
        if not self.initialized:
            self.initialize()

        if cash_store:
            self.store = CashStore()

        use_store = store or cash_store
        if use_store:
            if isinstance(self.store, StateStore):
                # time-align the write cursor with the model clock: a
                # resumed state (pickup, or a second run() continuing a
                # wall-time-limited first) at iteration k belongs at row k
                # (t = k * dt), not wherever the cursor happens to be —
                # and a continuing run rewrites row k with the identical
                # boundary state instead of duplicating it one row later
                self.store.iteration = int(self.state.iteration)
            self.store.push(self.state.state)  # initial state write

        remaining = self.n_steps() - int(self.state.iteration)
        if remaining <= 0:
            if self.verbose:
                print("stop_time exceeded, run not executed")
            return

        # a finite wall_time_limit (and any callbacks) need the between-
        # chunk hooks to actually run, so never default to one
        # all-remaining dispatch then (reference checks wall time once per
        # step, run.jl:117-121)
        needs_chunks = self.wall_time_limit != float("inf") or self.callbacks
        if use_store:
            # ALWAYS bounded: each dispatch stacks [chunk, ...] on device,
            # so peak memory is O(chunk * state) for any horizon
            chunk = chunk_size or 64
            done = 0
            # buffered variant (traced trip count into a static-capacity
            # buffer): the final ragged chunk reuses the full chunks'
            # compilation instead of paying a second full-scan compile
            buffered = getattr(self.model, "step_n_buffered", None)
            while done < remaining:
                n = min(chunk, remaining - done)
                if buffered is not None:
                    self.state, states = buffered(self.state, n, chunk)
                    states = states[:n]
                else:
                    self.state, states = self.model.step_n(self.state, n)
                if hasattr(self.store, "push_block"):
                    self.store.push_block(states)
                else:
                    for i in range(n):
                        self.store.push(states[i])
                done += n
                if self.verbose:
                    print(f"t = {float(self.state.time):.0f} s "
                          f"({done}/{remaining} steps)")
                for cb in self.callbacks.values():
                    cb(self)
                if _time.time() - t_wall > self.wall_time_limit:
                    print("wall time limit reached")
                    break
        else:
            # step_n_quiet takes the trip count as a traced scalar: every
            # chunk length reuses one compilation.
            chunk = chunk_size or (64 if needs_chunks else remaining)
            done = 0
            while done < remaining:
                n = min(chunk, remaining - done)
                self.state = self.model.step_n_quiet(self.state, n)
                jax.block_until_ready(self.state.state)
                done += n
                if self.verbose:
                    print(f"t = {float(self.state.time):.0f} s "
                          f"({done}/{remaining} steps)")
                for cb in self.callbacks.values():
                    cb(self)
                if _time.time() - t_wall > self.wall_time_limit:
                    print("wall time limit reached")
                    break

        self.run_wall_time += _time.time() - t_wall
