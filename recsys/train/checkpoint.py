"""Checkpoint store: full train-state snapshots, best-metric tracking,
id-map sidecars.

The reference has five checkpointing patterns and five ad-hoc id-realignment
loaders (SURVEY.md §5 "Checkpoint / resume"; reference `v1_lightgcl.py:319-335`,
`v1_usertower_train.py:1015-1022`, `v1_evaluate_lightgcl.py:183-234`). Here
there is one store:

  * every checkpoint = the full state pytree (params + optimizer + step +
    config) + a JSON manifest entry.  Two payload backends behind the same
    store API: ``msgpack`` (flax.serialization, single file, default; flax
    is imported only when a payload is written or read) and
    ``orbax`` (orbax.checkpoint PyTree directories — async-capable,
    multi-host-safe; pick via the ``backend`` arg or the
    ``RECSYS_CKPT_BACKEND`` env var);
  * best/last rotation keyed on a caller-chosen metric (e.g. Recall@100);
  * every artifact that carries per-row semantics (item matrix, GNN tables)
    saves an **id-map sidecar** (`ids.json`) so consumers realign by string
    id instead of trusting row order — the reference's biggest recurring bug
    surface, fixed structurally.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Sequence

import jax
import numpy as np


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.json")


def _load_manifest(ckpt_dir: str) -> dict:
    path = _manifest_path(ckpt_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"checkpoints": [], "best": None}


@functools.cache
def _serialization():
    """``flax.serialization`` with :class:`TrainState` registered under the
    field names a flax struct would use, so payloads stay interchangeable."""
    from flax import serialization

    from recsys.train.state import TrainState

    fields = ("step", "params", "opt_state")

    def to_state(state):
        return {f: serialization.to_state_dict(getattr(state, f)) for f in fields}

    def from_state(target, state):
        return target.replace(**{
            f: serialization.from_state_dict(getattr(target, f), state[f], name=f)
            for f in fields})

    serialization.register_serialization_state(TrainState, to_state, from_state)
    return serialization


def default_backend() -> str:
    return os.environ.get("RECSYS_CKPT_BACKEND", "msgpack")


class CheckpointStore:
    def __init__(self, ckpt_dir: str, keep: int = 3, maximize: bool = True,
                 backend: str | None = None):
        self.dir = ckpt_dir
        self.keep = keep
        self.maximize = maximize
        self.backend = backend or default_backend()
        if self.backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint backend {self.backend!r}")
        os.makedirs(ckpt_dir, exist_ok=True)
        self.manifest = _load_manifest(ckpt_dir)

    # -- payload backends -------------------------------------------------
    def _payload_path(self, name: str) -> str:
        suffix = ".msgpack" if self.backend == "msgpack" else ".orbax"
        return os.path.abspath(os.path.join(self.dir, f"{name}{suffix}"))

    def _write_payload(self, path: str, state: Any) -> None:
        serialization = _serialization()
        if self.backend == "msgpack":
            with open(path, "wb") as f:
                f.write(serialization.to_bytes(state))
        else:
            import shutil

            import orbax.checkpoint as ocp

            if os.path.exists(path):
                shutil.rmtree(path)
            with ocp.PyTreeCheckpointer() as ckptr:
                ckptr.save(path, state)

    def _read_payload(self, path: str, target: Any) -> Any:
        serialization = _serialization()
        if self.backend == "msgpack":
            with open(path, "rb") as f:
                return serialization.from_bytes(target, f.read())
        import orbax.checkpoint as ocp

        # restore into target's structure (without it orbax returns plain
        # dicts and lists, which lose the optimizer state's tuple types)
        with ocp.PyTreeCheckpointer() as ckptr:
            return ckptr.restore(os.path.abspath(path),
                                 item=jax.device_get(target))

    def _remove_payload(self, path: str) -> None:
        if os.path.isdir(path):
            import shutil

            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def _copy_payload(self, src: str, dst: str) -> None:
        if os.path.isdir(src):
            import shutil

            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
        else:
            with open(src, "rb") as s, open(dst, "wb") as d:
                d.write(s.read())

    # -- core save/restore ----------------------------------------------
    def save(self, name: str, state: Any, *, step: int, metric: float | None = None,
             extra: dict | None = None) -> str:
        state = jax.device_get(state)
        path = self._payload_path(name)
        self._write_payload(path, state)
        entry = {"name": name, "path": path, "step": int(step),
                 "metric": None if metric is None else float(metric),
                 "extra": extra or {}}
        self.manifest["checkpoints"] = [
            c for c in self.manifest["checkpoints"] if c["name"] != name
        ] + [entry]
        self._maybe_update_best(entry)
        self._rotate()
        self._flush()
        return path

    def restore(self, name: str, target: Any) -> Any:
        """Restore into the structure of ``target`` (a template pytree)."""
        return self._read_payload(self._payload_path(name), target)

    def restore_best(self, target: Any) -> tuple[Any, dict]:
        best = self.manifest.get("best")
        if best is None:
            raise FileNotFoundError(f"no best checkpoint in {self.dir}")
        return self.restore(best["name"], target), best

    def restore_best_params(self, params_template: Any) -> tuple[Any, dict]:
        """Restore ONLY the params subtree of the best checkpoint.

        Post-hoc consumers (rerank pools, serving exports) don't need
        optimizer state, and a full-state template would have to
        reproduce the training run's exact optimizer chain — lr-schedule
        flags change the opt_state tree structure, so restoring a
        recipe-trained checkpoint through a default-recipe template
        fails on namedtuple mismatch (round-5 rerank_hybrid_rcp)."""
        best = self.manifest.get("best")
        if best is None:
            raise FileNotFoundError(f"no best checkpoint in {self.dir}")
        path = self._payload_path("best")
        serialization = _serialization()
        if self.backend == "msgpack":
            with open(path, "rb") as f:
                raw = serialization.msgpack_restore(f.read())
        else:
            import orbax.checkpoint as ocp

            with ocp.PyTreeCheckpointer() as ckptr:
                raw = ckptr.restore(os.path.abspath(path))
        return serialization.from_state_dict(params_template,
                                             raw["params"]), best

    def restore_latest(self, target: Any) -> tuple[Any, dict] | None:
        """Resume support: restore the highest-step checkpoint, or None."""
        cks = self.manifest["checkpoints"]
        if not cks:
            return None
        entry = max(cks, key=lambda c: c["step"])
        return self.restore(entry["name"], target), entry

    # -- best/rotation ---------------------------------------------------
    def _maybe_update_best(self, entry: dict) -> None:
        if entry["metric"] is None:
            return
        best = self.manifest.get("best")
        better = (
            best is None
            or best.get("metric") is None
            or (entry["metric"] > best["metric"]) == self.maximize
        )
        if better:
            # copy the payload so rotation can't evict the best snapshot
            best_path = self._payload_path("best")
            self._copy_payload(entry["path"], best_path)
            self.manifest["best"] = {**entry, "name": "best", "path": best_path}

    def _rotate(self) -> None:
        cks = sorted(self.manifest["checkpoints"], key=lambda c: c["step"])
        while len(cks) > self.keep:
            victim = cks.pop(0)
            self._remove_payload(victim["path"])
        self.manifest["checkpoints"] = cks

    def _flush(self) -> None:
        with open(_manifest_path(self.dir), "w") as f:
            json.dump(self.manifest, f, indent=1)


# -- id-map sidecars ------------------------------------------------------

def save_array_with_ids(path: str, array: np.ndarray, ids: Sequence[str],
                        meta: dict | None = None) -> None:
    """Save an (N, D) array artifact with its row->string-id sidecar.

    ``path`` is the basename; writes ``{path}.npy`` + ``{path}.ids.json``.
    Row 0 is conventionally a zero PAD row and gets the id ``"<pad>"`` when
    len(ids) == N-1 (mirrors the reference's padded matrices,
    `utils/util.py:7-51`).
    """
    array = np.asarray(array)
    ids = list(map(str, ids))
    if len(ids) == array.shape[0] - 1:
        ids = ["<pad>"] + ids
    if len(ids) != array.shape[0]:
        raise ValueError(f"{len(ids)} ids for {array.shape[0]} rows")
    np.save(path + ".npy", array)
    with open(path + ".ids.json", "w") as f:
        json.dump({"ids": ids, "meta": meta or {}}, f)


def load_array_with_ids(path: str) -> tuple[np.ndarray, list[str], dict]:
    array = np.load(path + ".npy")
    with open(path + ".ids.json") as f:
        side = json.load(f)
    return array, side["ids"], side.get("meta", {})


def align_rows(array: np.ndarray, ids: Sequence[str], target_ids: Sequence[str],
               fill: str = "zero", rng: np.random.Generator | None = None,
               scale: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Re-order artifact rows to a consumer's id order (the one canonical
    realignment everyone uses — replaces the reference's five bespoke
    loaders). Missing ids are zero- or random-initialized; returns the
    aligned array and a boolean found-mask."""
    index = {str(i): r for r, i in enumerate(ids)}
    out = np.zeros((len(target_ids), array.shape[1]), dtype=array.dtype)
    found = np.zeros(len(target_ids), dtype=bool)
    if fill == "random":
        rng = rng or np.random.default_rng(0)
        out = rng.normal(0.0, scale, out.shape).astype(array.dtype)
    for r, tid in enumerate(map(str, target_ids)):
        src = index.get(tid)
        if src is not None:
            out[r] = array[src]
            found[r] = True
    return out, found


def snapshot_due(epoch: int, total_epochs: int, every: int,
                 improved: bool) -> bool:
    """Shared snapshot cadence: save on metric improvement, on the ``every``
    cadence, and always at the final epoch (a full-state save copies the
    whole state to the host — see UserTrainConfig.ckpt_every)."""
    return improved or epoch % every == 0 or epoch == total_epochs
