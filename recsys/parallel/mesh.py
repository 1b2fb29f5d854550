"""Device mesh + sharding helpers.

The reference is single-process / single-GPU (SURVEY.md §2.12); its implicit
scaling levers become explicit here:

  * ``data`` axis   — batch sharding for all four training loops (DP).
  * ``model`` axis  — row-sharding of embedding tables / the item matrix and
    of the full-catalog score+top-k (`U @ I^T`, reference
    `v1_usertower_train.py:672`).

All helpers work identically on a single device (1x1 mesh), a virtual
multi-device CPU mesh (tests use 8 virtual CPU devices) and several GPUs:
shardings are expressed with ``NamedSharding`` and XLA inserts the
collectives.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from recsys.config import MeshConfig


def build_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    ``num_data=-1`` consumes all devices left over after ``num_model``.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    num_model = cfg.num_model if cfg.num_model > 0 else 1
    if n % num_model != 0:
        raise ValueError(f"{n} devices not divisible by model={num_model}")
    num_data = cfg.num_data if cfg.num_data > 0 else n // num_model
    if num_data * num_model != n:
        devices = devices[: num_data * num_model]
    grid = np.asarray(devices).reshape(num_data, num_model)
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


def data_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis; replicate the rest."""
    spec = P(mesh.axis_names[0], *(None,) * (ndim - 1))
    return NamedSharding(mesh, spec)


def row_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (row) dim over the model axis — embedding tables and
    the materialized item matrix live like this."""
    spec = P(mesh.axis_names[1], *(None,) * (ndim - 1))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """Device-put a pytree of host arrays with leading-dim sharding over the
    data axis (pads are the caller's job — shapes must divide evenly)."""
    def _put(x):
        return jax.device_put(x, data_sharding(mesh, np.ndim(x) if np.ndim(x) else 1))
    return jax.tree_util.tree_map(_put, batch)


def smap(fn, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map`` with varying-manual-axes checking disabled — our
    collective helpers (all_gather-into-replicated, psum-merge) produce
    outputs whose replication XLA can't statically infer."""
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Static-shape helper: pad ``axis`` up to a multiple, returning the
    padded array and the original length (for masking)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, constant_values=fill), n
