"""Python binding for the native C++ vector index (ctypes), with a pure
numpy fallback when no compiler is available.

The index is the serving-side equivalent of the reference's pgvector HNSW
(`database.py:102-113`): cosine top-k over the materialized item vectors,
with incremental upsert/remove and binary persistence. The big device path
(eval, bulk retrieval) uses eval/recall.topk_scores instead — this exists
for low-latency host-side queries.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libvecindex.so")

_lib = None


def _build_native() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and not _build_native():
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.vecindex_create.restype = ctypes.c_void_p
    lib.vecindex_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vecindex_free.argtypes = [ctypes.c_void_p]
    lib.vecindex_dim.argtypes = [ctypes.c_void_p]
    lib.vecindex_dim.restype = ctypes.c_int
    lib.vecindex_size.argtypes = [ctypes.c_void_p]
    lib.vecindex_size.restype = ctypes.c_int64
    lib.vecindex_add.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.vecindex_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.vecindex_remove.restype = ctypes.c_int
    lib.vecindex_topk.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.vecindex_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vecindex_save.restype = ctypes.c_int
    lib.vecindex_load.argtypes = [ctypes.c_char_p]
    lib.vecindex_load.restype = ctypes.c_void_p
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class VectorIndex:
    """Cosine (or dot) top-k index; native-backed when possible."""

    def __init__(self, dim: int, cosine: bool = True, _handle=None):
        self.dim = dim
        self.cosine = cosine
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = _handle if _handle is not None else \
                self._lib.vecindex_create(dim, int(cosine))
        else:  # numpy fallback
            self._h = None
            self._ids: list[int] = []
            self._rows: dict[int, int] = {}
            self._data = np.zeros((0, dim), np.float32)

    # -- mutation ---------------------------------------------------------
    def add(self, ids: Sequence[int], vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(vecs, np.float32)
        ids_arr = np.ascontiguousarray(ids, np.int64)
        assert vecs.shape == (len(ids_arr), self.dim)
        if self._h is not None:
            self._lib.vecindex_add(
                self._h, ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(ids_arr))
            return
        if self.cosine:
            vecs = vecs / np.clip(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12, None)
        for i, vid in enumerate(ids_arr.tolist()):
            if vid in self._rows:
                self._data[self._rows[vid]] = vecs[i]
            else:
                self._rows[vid] = len(self._ids)
                self._ids.append(vid)
                self._data = np.concatenate([self._data, vecs[i:i + 1]])

    def remove(self, id_: int) -> bool:
        if self._h is not None:
            return bool(self._lib.vecindex_remove(self._h, int(id_)))
        row = self._rows.pop(id_, None)
        if row is None:
            return False
        last = len(self._ids) - 1
        if row != last:
            self._data[row] = self._data[last]
            self._ids[row] = self._ids[last]
            self._rows[self._ids[row]] = row
        self._ids.pop()
        self._data = self._data[:last]
        return True

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.vecindex_size(self._h))
        return len(self._ids)

    def topk(self, queries: np.ndarray, k: int, num_threads: int = 2):
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        m = queries.shape[0]
        if self._h is not None:
            out_ids = np.empty((m, k), np.int64)
            out_scores = np.empty((m, k), np.float32)
            self._lib.vecindex_topk(
                self._h, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                m, k, out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                num_threads)
            return out_ids, out_scores
        if len(self._ids) == 0:
            return (np.full((m, k), -1, np.int64), np.zeros((m, k), np.float32))
        q = queries
        if self.cosine:
            q = q / np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-12, None)
        scores = q @ self._data.T
        kk = min(k, scores.shape[1])
        part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        out_ids = np.full((m, k), -1, np.int64)
        out_scores = np.zeros((m, k), np.float32)
        for r in range(m):
            order = part[r][np.argsort(-scores[r, part[r]])]
            out_ids[r, :kk] = np.asarray(self._ids)[order]
            out_scores[r, :kk] = scores[r, order]
        return out_ids, out_scores

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        if self._h is not None:
            if not self._lib.vecindex_save(self._h, path.encode()):
                raise IOError(f"vecindex save failed: {path}")
            return
        np.savez(path + ".npz", ids=np.asarray(self._ids, np.int64),
                 data=self._data, dim=self.dim, cosine=self.cosine)

    @classmethod
    def load(cls, path: str, dim: int | None = None) -> "VectorIndex":
        lib = _load_lib()
        if lib is not None and os.path.exists(path):
            h = lib.vecindex_load(path.encode())
            if not h:
                raise IOError(f"vecindex load failed: {path}")
            ix = cls(lib.vecindex_dim(ctypes.c_void_p(h)), _handle=h)
            return ix
        z = np.load(path + ".npz")
        ix = cls(int(z["dim"]), bool(z["cosine"]))
        if len(z["ids"]):
            ix.add(z["ids"], z["data"])
        return ix

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            try:
                self._lib.vecindex_free(self._h)
            except Exception:
                pass


# -- HNSW (approximate) ----------------------------------------------------

_HNSW_SO = os.path.join(_NATIVE_DIR, "build", "libhnsw.so")
_hnsw_lib = None


def _load_hnsw():
    global _hnsw_lib
    if _hnsw_lib is not None:
        return _hnsw_lib
    if not os.path.exists(_HNSW_SO) and not _build_native():
        return None
    lib = ctypes.CDLL(_HNSW_SO)
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.restype = ctypes.c_int64
    lib.hnsw_dim.argtypes = [ctypes.c_void_p]
    lib.hnsw_dim.restype = ctypes.c_int
    lib.hnsw_add.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.hnsw_add_parallel.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.hnsw_topk.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                              ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_float)]
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    _hnsw_lib = lib
    return lib


def hnsw_available() -> bool:
    return _load_hnsw() is not None


class HnswIndex:
    """Native approximate cosine index — the pgvector-HNSW equivalent for
    1M+ catalogs (reference config defaults: m=24, ef_construction=200,
    ef_search=100 — `database.py:106-112`)."""

    def __init__(self, dim: int, m: int = 24, ef_construction: int = 200,
                 ef_search: int = 100, seed: int = 42, _handle=None):
        self._lib = _load_hnsw()
        if self._lib is None:
            raise RuntimeError("native hnsw unavailable (no compiler?)")
        self.dim = dim
        self.ef_search = ef_search
        self._h = _handle if _handle is not None else \
            self._lib.hnsw_create(dim, m, ef_construction, seed)

    def add(self, ids: Sequence[int], vecs: np.ndarray,
            num_threads: int | None = None) -> None:
        """Insert/overwrite a batch. Large batches build concurrently
        (pgvector's HNSW build is single-threaded inside Postgres; this is
        the serving-side fix for the ~30 s cold build at 47k items)."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        ids_arr = np.ascontiguousarray(ids, np.int64)
        assert vecs.shape == (len(ids_arr), self.dim)
        if num_threads is None:
            # parallel build pays off on >=4 real cores; on tiny hosts the
            # striped-lock overhead beats the parallelism (measured: 2-vCPU
            # box builds 47k items in 27.7s serial vs 38.2s with 2 threads)
            cpus = os.cpu_count() or 1
            num_threads = min(cpus, 8) if cpus >= 4 and len(ids_arr) >= 4096 else 1
        self._lib.hnsw_add_parallel(
            self._h, ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(ids_arr),
            int(num_threads))

    def __len__(self) -> int:
        return int(self._lib.hnsw_size(self._h))

    def topk(self, queries: np.ndarray, k: int, ef_search: int | None = None):
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        m = queries.shape[0]
        out_ids = np.empty((m, k), np.int64)
        out_scores = np.empty((m, k), np.float32)
        self._lib.hnsw_topk(
            self._h, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m, k, int(ef_search or self.ef_search),
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out_ids, out_scores

    def save(self, path: str) -> None:
        if not self._lib.hnsw_save(self._h, path.encode()):
            raise IOError(f"hnsw save failed: {path}")

    @classmethod
    def load(cls, path: str, ef_search: int = 100) -> "HnswIndex":
        lib = _load_hnsw()
        if lib is None:
            raise RuntimeError("native hnsw unavailable")
        h = lib.hnsw_load(path.encode())
        if not h:
            raise IOError(f"hnsw load failed: {path}")
        return cls(lib.hnsw_dim(ctypes.c_void_p(h)), ef_search=ef_search,
                   _handle=h)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            try:
                self._lib.hnsw_free(self._h)
            except Exception:
                pass


# -- Device-resident indexes (host row store + lazy rebuild) -----------------

class _HostRowStoreIndex:
    """Shared lifecycle for device-resident indexes: the device arrays are
    immutable, so mutations land in a host-side row store and the index
    lazily rebuilds on the first query after a change — the same "vectors
    accumulate, index refreshes" lifecycle the reference drives through
    pgvector's ``is_vectorized`` flags."""

    def __init__(self, dim: int):
        self.dim = dim
        self._ids: list[int] = []
        self._rows: dict[int, int] = {}
        self._data = np.zeros((0, dim), np.float32)
        self._dirty = True

    def add(self, ids: Sequence[int], vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(vecs, np.float32)
        ids_arr = np.ascontiguousarray(ids, np.int64)
        assert vecs.shape == (len(ids_arr), self.dim)
        for i, vid in enumerate(ids_arr.tolist()):
            if vid in self._rows:
                self._data[self._rows[vid]] = vecs[i]
            else:
                self._rows[vid] = len(self._ids)
                self._ids.append(vid)
                self._data = np.concatenate([self._data, vecs[i:i + 1]])
        self._dirty = True

    def remove(self, id_: int) -> bool:
        row = self._rows.pop(id_, None)
        if row is None:
            return False
        last = len(self._ids) - 1
        if row != last:
            self._data[row] = self._data[last]
            self._ids[row] = self._ids[last]
            self._rows[self._ids[row]] = row
        self._ids.pop()
        self._data = self._data[:last]
        self._dirty = True
        return True

    def __len__(self) -> int:
        return len(self._ids)


class IvfIndex(_HostRowStoreIndex):
    """Device-resident IVF index behind the common ``add/topk/save/load``
    interface (`ops/ivf.py` does the math). Rebuild = k-means + bucket
    packing. Suited to 1M+ catalogs where the exact scan stops being free;
    at small N it simply degrades to near-exact."""

    def __init__(self, dim: int, nlist: int | None = None, nprobe: int = 8,
                 kmeans_iters: int = 10):
        super().__init__(dim)
        self.nlist = nlist
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self._index = None          # ops.ivf.IvfIndexArrays

    def _rebuild(self) -> None:
        from recsys.ops.ivf import build_ivf

        mat = np.concatenate([np.zeros((1, self.dim), np.float32), self._data])
        self._index = build_ivf(mat, nlist=self.nlist,
                                iters=self.kmeans_iters)
        self._dirty = False

    def topk(self, queries: np.ndarray, k: int, nprobe: int | None = None):
        import jax.numpy as jnp
        from recsys.ops.ivf import ivf_search

        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        m = queries.shape[0]
        if not self._ids:
            return (np.full((m, k), -1, np.int64), np.zeros((m, k), np.float32))
        if self._dirty:
            self._rebuild()
        vals, idx = ivf_search(self._index, jnp.asarray(queries), k,
                               int(nprobe or self.nprobe))
        idx = np.asarray(idx)
        vals = np.asarray(vals)
        ext = np.concatenate([[-1], np.asarray(self._ids, np.int64)])
        out_ids = ext[idx]                       # PAD slot 0 -> -1
        out_scores = np.where(np.isfinite(vals), vals, 0.0).astype(np.float32)
        return out_ids, out_scores

    def save(self, path: str) -> None:
        np.savez(path + ".npz", ids=np.asarray(self._ids, np.int64),
                 data=self._data, dim=self.dim,
                 nlist=self.nlist or 0, nprobe=self.nprobe)

    @classmethod
    def load(cls, path: str) -> "IvfIndex":
        z = np.load(path + ".npz")
        ix = cls(int(z["dim"]), nlist=int(z["nlist"]) or None,
                 nprobe=int(z["nprobe"]))
        if len(z["ids"]):
            ix.add(z["ids"], z["data"])
        return ix


# -- Int8 exact scan (device-resident, quantized) ----------------------------

class Int8Index(_HostRowStoreIndex):
    """Device-resident exact scan over an int8-quantized catalog behind the
    common ``add/topk/save/load`` interface (`ops/quant.py` does the math).

    Rebuild is just requantization (no clustering), so mutations are cheap.
    Exact ranking over the quantized scores — at serving scale the scan is
    HBM-bandwidth-bound and int8 halves the bytes, making this the fastest
    backend that is still (quantization-)exact; pair with
    ``ops.quant.quantization_recall`` as the offline quality gate.
    """

    def __init__(self, dim: int, cosine: bool = True):
        super().__init__(dim)
        self.cosine = cosine
        self._q = None              # ops.quant.QuantizedItems

    def _rebuild(self) -> None:
        import jax
        import jax.numpy as jnp
        from recsys.ops.quant import quantize_items_int8

        mat = np.concatenate([np.zeros((1, self.dim), np.float32), self._data])
        self._q = jax.tree.map(jnp.asarray,
                               quantize_items_int8(mat, normalize=self.cosine))
        self._dirty = False

    def topk(self, queries: np.ndarray, k: int):
        import jax.numpy as jnp
        from recsys.ops.quant import int8_topk

        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        m = queries.shape[0]
        if not self._ids:
            return (np.full((m, k), -1, np.int64), np.zeros((m, k), np.float32))
        if self._dirty:
            self._rebuild()
        if self.cosine:
            queries = queries / np.clip(
                np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12, None)
        kk = min(k, len(self._ids))
        vals, idx = int8_topk(jnp.asarray(queries), self._q, kk)
        idx, vals = np.asarray(idx), np.asarray(vals)
        if kk < k:  # fixed-width contract: pad with -1 / 0.0
            idx = np.pad(idx, ((0, 0), (0, k - kk)))
            vals = np.pad(vals, ((0, 0), (0, k - kk)), constant_values=-np.inf)
        ext = np.concatenate([[-1], np.asarray(self._ids, np.int64)])
        out_ids = np.where(idx > 0, ext[idx], -1)
        out_scores = np.where(np.isfinite(vals), vals, 0.0).astype(np.float32)
        return out_ids, out_scores

    def save(self, path: str) -> None:
        np.savez(path + ".npz", ids=np.asarray(self._ids, np.int64),
                 data=self._data, dim=self.dim, cosine=self.cosine)

    @classmethod
    def load(cls, path: str) -> "Int8Index":
        z = np.load(path + ".npz")
        ix = cls(int(z["dim"]), cosine=bool(z["cosine"]))
        if len(z["ids"]):
            ix.add(z["ids"], z["data"])
        return ix
