"""Mesh construction helpers (SURVEY.md §7 stage 6).

The baseline mandates row-sharding with a shared-V all-reduce
(BASELINE.json config #5) — a 1-D mesh. For problems that are jointly huge
in BOTH n and m, the 2-D grid layout shards X over a (rows × cols) mesh:
U rides the row axis, V the col axis, and each factor's update psums over
the OTHER axis only — collectives stay k-shaped and axis-local.

The meshes take the first devices of jax.devices() in order, with no
topology search: the target is one host of GPUs joined all to all by
NVLink, where every pair of cards has the same bandwidth and any order
is as good as another. On the CPU test backend the virtual devices
behave identically (SURVEY §4d).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "shards"
ROW_AXIS = "rows"
COL_AXIS = "cols"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} "
                f"available ({[str(d) for d in devices]})")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def make_grid_mesh(rows: int, cols: int, devices=None) -> Mesh:
    """2-D (rows × cols) mesh for the grid layout (layout='grid')."""
    if devices is None:
        devices = jax.devices()
    need = rows * cols
    if need > len(devices):
        raise ValueError(
            f"requested {rows}x{cols}={need} devices but only "
            f"{len(devices)} available")
    return Mesh(np.asarray(devices[:need]).reshape(rows, cols),
                (ROW_AXIS, COL_AXIS))
