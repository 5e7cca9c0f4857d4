"""Checkpoint / resume — implemented for real.

The reference declares ``run!(pickup=...)`` but it is a no-op stub
(src/Simulations/run.jl:32-36).  Here a checkpoint is the full ModelState
pytree (Eulerian state + particle SoA + clock + metrics) written as a
compressed ``.npz`` with the pytree structure recorded alongside, so a
simulation resumes bit-exactly on any backend.

Multi-host runs: the npz backend device_gets the full state on every
process (it requires fully-addressable arrays — fine single-host); for
multi-process runs use ``backend="orbax"``, whose sharding-aware
save/restore handles non-addressable global arrays natively.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import jax
import numpy as np

from ..models.state import (ModelState1D, ModelState2D, Particles1D,
                            Particles2D, StepMetrics)

_FORMAT_VERSION = 2  # v2: Particles2D stores 5 component planes, not z


def save_checkpoint(path: str, ms, backend: str = "npz") -> str:
    """Serialize a ModelState pytree to ``path``.

    ``backend="npz"`` (default): one compressed self-contained file.
    ``backend="orbax"``: an orbax-checkpoint directory — the standard JAX
    large-scale checkpointing stack (async, sharding-aware restore for
    multi-host states).
    """
    if backend == "orbax":
        return _save_orbax(path, ms)
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves, treedef = jax.tree.flatten(ms)
    arrays = {f"leaf_{i}": np.asarray(jax.device_get(x))
              for i, x in enumerate(leaves)}
    kind = type(ms).__name__
    meta = json.dumps(dict(version=_FORMAT_VERSION, kind=kind,
                           n_leaves=len(leaves)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=np.bytes_(meta), **arrays)
    return path


def _template(kind: str):
    if kind == "ModelState2D":
        return ModelState2D(
            state=None,
            particles=Particles2D(lne=None, cgx=None, cgy=None, px=None,
                                  py=None, t=None, dt=None, on=None),
            time=None, iteration=None, metrics=StepMetrics.zeros())
    if kind == "ModelState1D":
        return ModelState1D(
            state=None,
            particles=Particles1D(z=None, t=None, dt=None, on=None),
            time=None, iteration=None, metrics=StepMetrics.zeros())
    raise ValueError(f"unknown checkpoint kind {kind}")


def _save_orbax(path: str, ms) -> str:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, jax.tree.map(np.asarray, ms), force=True)
    with open(os.path.join(path, "picles_meta.json"), "w") as f:
        json.dump(dict(version=_FORMAT_VERSION, kind=type(ms).__name__,
                       backend="orbax"), f)
    return path


def _load_orbax(path: str):
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with open(os.path.join(path, "picles_meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {meta['version']}")
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(path)

    # orbax returns nested containers keyed by field name; rebuild the
    # dataclass tree BY NAME (dict flattening order is alphabetical, not
    # dataclass field order — positional unflatten would shuffle leaves)
    def arr(x):
        return jnp.asarray(x)

    def metrics_of(d):
        if isinstance(d, dict):
            return StepMetrics(**{k: arr(v) for k, v in d.items()})
        return StepMetrics(*[arr(v) for v in d])

    if meta["kind"] == "ModelState2D":
        p = restored["particles"]
        return ModelState2D(
            state=arr(restored["state"]),
            particles=Particles2D(**{k: arr(p[k]) for k in
                                     ("lne", "cgx", "cgy", "px", "py",
                                      "t", "dt", "on")}),
            time=arr(restored["time"]), iteration=arr(restored["iteration"]),
            metrics=metrics_of(restored["metrics"]))
    if meta["kind"] == "ModelState1D":
        p = restored["particles"]
        return ModelState1D(
            state=arr(restored["state"]),
            particles=Particles1D(**{k: arr(p[k]) for k in
                                     ("z", "t", "dt", "on")}),
            time=arr(restored["time"]), iteration=arr(restored["iteration"]),
            metrics=metrics_of(restored["metrics"]))
    raise ValueError(f"unknown checkpoint kind {meta['kind']}")


def load_checkpoint(path: str):
    """Restore a ModelState pytree from ``path`` (npz file or orbax dir)."""
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "picles_meta.json")):
        return _load_orbax(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(bytes(f["__meta__"].item()).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        leaves = [f[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    template = _template(meta["kind"])
    treedef = jax.tree.structure(template,
                                 is_leaf=lambda x: x is None or hasattr(x, "shape"))
    import jax.numpy as jnp
    return jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
