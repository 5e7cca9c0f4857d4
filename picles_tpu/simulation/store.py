"""Output stores (reference src/Simulations/storing.jl).

``StateStore`` writes the same HDF5 layout as the reference so downstream
tooling ports directly: group ``waves`` with dataset ``data`` of shape
``[time, x, y, state]`` (``[time, x, state]`` in 1D), coordinate datasets,
a ``dims`` attribute, and ``var_names = ["e", "m_x", "m_y"]``
(storing.jl:36-62).  ``CashStore`` keeps states in host memory; ``EmptyStore``
is the no-op default.  Writes happen on the host from ``jax.device_get``
snapshots — the device never blocks on IO.
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax
import numpy as np


class EmptyStore:
    iteration: int = 0

    def push(self, state) -> None:
        pass

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass


class CashStore:
    """In-memory list of state snapshots (reference storing.jl:13-17)."""

    def __init__(self):
        self.store: List[np.ndarray] = []
        self.iteration = 0

    def push(self, state) -> None:
        self.store.append(np.asarray(jax.device_get(state)))
        self.iteration += 1

    def reset(self) -> None:
        self.store.clear()
        self.iteration = 0

    def close(self) -> None:
        pass

    def as_array(self) -> np.ndarray:
        return np.stack(self.store, axis=0)


class StateStore:
    """HDF5-backed state history (reference storing.jl:20-119)."""

    def __init__(self, path: str, coords: dict, name: str = "state",
                 replace: bool = True, var_names=("e", "m_x", "m_y")):
        try:   # imported here: storeless and CashStore runs never need it
            import h5py
        except ImportError:  # pragma: no cover
            raise RuntimeError("h5py is unavailable; use CashStore")
        os.makedirs(path, exist_ok=True)
        fpath = os.path.join(path, name + ".h5")
        if replace and os.path.exists(fpath):
            os.remove(fpath)
        self.path = fpath
        if not replace and os.path.exists(fpath):
            # re-attach an existing history (checkpoint-resume legs): open
            # append-mode and bind the layout; the run loop aligns the
            # write cursor to the resumed state's iteration
            self.file = h5py.File(fpath, "a")
            grp = self.file["waves"]
            self.data = grp["data"]
            self.group = grp
            self.iteration = 0
            self.shape = self.data.shape
            return
        self.file = h5py.File(fpath, "w")
        shape = tuple(len(v) for v in coords.values())
        grp = self.file.create_group("waves")
        self.data = grp.create_dataset("data", shape, dtype="f8")
        grp.attrs["dims"] = [str(k) for k in coords.keys()]
        for k, v in coords.items():
            if k == "state":
                grp[k] = np.array([s.encode() for s in v])
            else:
                grp[k] = np.asarray(v, dtype="f8")
        grp["var_names"] = np.array([s.encode() for s in var_names])
        self.group = grp
        self.iteration = 0
        self.shape = shape

    def push(self, state) -> None:
        arr = np.asarray(jax.device_get(state))
        self.data[self.iteration, ...] = arr
        self.iteration += 1

    def push_block(self, states) -> None:
        """Write a stacked [n, ...] block in one IO call (scan-chunk path)."""
        arr = np.asarray(jax.device_get(states))
        n = arr.shape[0]
        self.data[self.iteration:self.iteration + n, ...] = arr
        self.iteration += n

    def add_forcing(self, forcing: dict, coords: dict) -> None:
        """Reference add_winds_forcing_to_store! (storing.jl:142-180)."""
        grp = (self.file["forcing"] if "forcing" in self.file
               else self.file.create_group("forcing"))
        for name, f in forcing.items():
            if f is None or name in grp:
                continue
            grp[name] = np.asarray(f, dtype="f8")
        if "dims" not in grp.attrs:
            grp.attrs["dims"] = [str(k) for k in coords.keys()]
            for k, v in coords.items():
                if k not in grp:
                    grp[k] = np.asarray(v, dtype="f8")

    def reset(self, value: float = 0.0) -> None:
        self.data[...] = value
        self.iteration = 0

    def close(self) -> None:
        self.file.close()


def convert_store_to_tuple(store, sim=None):
    """Reference convert_store_to_tuple (storing.jl:211-229)."""
    if isinstance(store, CashStore):
        return dict(data=store.as_array())
    if isinstance(store, StateStore):
        out = dict(data=np.asarray(store.data))
        for k in store.group:
            if k not in ("data",):
                out[k] = np.asarray(store.group[k])
        return out
    raise TypeError(type(store))
