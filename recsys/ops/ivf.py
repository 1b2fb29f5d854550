"""IVF (inverted-file) approximate retrieval on the device.

The reference serves similarity through pgvector's HNSW index
(`database.py:102-113`, `APIController/controller.py:84-94`) — a
pointer-chasing graph walk that is hostile to batched device execution. The
honest equivalent at reference scale (47k items) is an exact dense
matmul + top-k (`eval/recall.topk_scores`); this module covers the scale
where exact scoring stops being free (1M+ items): a **clustered,
fixed-shape** index that keeps everything as dense batched matmuls.

Build (host-orchestrated, device-accelerated):
  * spherical k-means over the L2-normalized catalog (Lloyd iterations as
    jitted chunked argmax + segment-sum updates);
  * items are packed into **equal-capacity buckets** (one per centroid).
    Overflowing items spill to their next-nearest centroid with space
    (`choices` candidates, best-score-first greedy), so the device arrays
    stay rectangular — padding slots hold id 0 (the PAD row convention).

Search (one jitted program, static ``k``/``nprobe``):
  * score queries against centroids, take top-``nprobe`` buckets;
  * ``lax.scan`` over probe slots: gather the probed bucket's ids+vectors,
    score exactly, merge into a running top-k.

Recall is exact over the probed buckets, so quality is a pure
``nprobe/nlist`` knob. Search cost is O(nlist + nprobe * cap) per query
vs O(N) exact — sub-linear while every op stays a dense batched matmul.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12, None)


@functools.partial(jax.jit, static_argnums=(2,))
def _assign_chunk(x: jnp.ndarray, centroids: jnp.ndarray, choices: int):
    """Top-``choices`` centroid ids + scores for a chunk of vectors."""
    s = x @ centroids.T
    vals, idx = jax.lax.top_k(s, choices)
    return vals, idx


def kmeans(x: np.ndarray, nlist: int, iters: int = 10, seed: int = 0,
           chunk: int = 65536) -> np.ndarray:
    """Spherical k-means (cosine) — returns (nlist, D) unit centroids.

    Lloyd iterations with device-side assignment; empty clusters are
    re-seeded from random points so every bucket stays usable.
    """
    rng = np.random.default_rng(seed)
    x = _l2n(np.asarray(x, np.float32))
    n = len(x)
    cent = x[rng.choice(n, size=min(nlist, n), replace=False)]
    if len(cent) < nlist:  # degenerate: fewer points than clusters
        cent = np.concatenate([cent, rng.normal(0, 1, (nlist - len(cent),
                                                       x.shape[1]))])
    cent = _l2n(cent.astype(np.float32))
    for _ in range(max(iters, 1)):
        assign = np.empty(n, np.int64)
        for s in range(0, n, chunk):
            _, idx = _assign_chunk(jnp.asarray(x[s:s + chunk]),
                                   jnp.asarray(cent), 1)
            assign[s:s + chunk] = np.asarray(idx)[:, 0]
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=nlist).astype(np.float32)
        empty = counts == 0
        if empty.any():
            sums[empty] = x[rng.integers(0, n, int(empty.sum()))]
            counts[empty] = 1.0
        cent = _l2n(sums / counts[:, None])
    return cent


@dataclass
class IvfIndexArrays:
    """Device-resident index: rectangular, PAD id 0 in empty slots."""

    centroids: jnp.ndarray    # (nlist, D) unit rows
    bucket_ids: jnp.ndarray   # (nlist, cap) int32 catalog indices, 0 = empty
    bucket_vecs: jnp.ndarray  # (nlist, cap, D) unit rows (0 on padding)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.bucket_ids.shape[1]


def build_ivf(item_matrix: np.ndarray, nlist: int | None = None,
              iters: int = 10, seed: int = 0, choices: int = 8,
              balance: float = 1.5) -> IvfIndexArrays:
    """Cluster catalog rows 1..N of an (N+1, D) matrix (PAD row 0 skipped)
    into equal-capacity buckets.

    ``balance`` bounds the target capacity at ``ceil(N/nlist * balance)``;
    items whose ``choices`` nearest buckets are all full force a capacity
    bump (rare — logged in the returned arrays' shape).
    """
    mat = np.asarray(item_matrix, np.float32)
    x = _l2n(mat[1:])
    n = len(x)
    if n == 0:
        raise ValueError("empty catalog")
    if nlist is None:
        nlist = max(1, int(np.sqrt(n)))
    nlist = min(nlist, n)
    cent = kmeans(x, nlist, iters=iters, seed=seed)
    choices = min(choices, nlist)

    vals = np.empty((n, choices), np.float32)
    idxs = np.empty((n, choices), np.int64)
    chunk = 65536
    for s in range(0, n, chunk):
        v, i = _assign_chunk(jnp.asarray(x[s:s + chunk]), jnp.asarray(cent),
                             choices)
        vals[s:s + chunk], idxs[s:s + chunk] = np.asarray(v), np.asarray(i)

    cap = int(np.ceil(n / nlist * balance))
    buckets: list[list[int]] = [[] for _ in range(nlist)]
    # best-score-first greedy fill over successive choice ranks
    unassigned = np.arange(n)
    for c in range(choices):
        if not len(unassigned):
            break
        order = unassigned[np.argsort(-vals[unassigned, c])]
        still = []
        for it in order:
            b = int(idxs[it, c])
            if len(buckets[b]) < cap:
                buckets[b].append(int(it))
            else:
                still.append(it)
        unassigned = np.array(still, np.int64)
    for it in unassigned:  # every choice full: force into the nearest
        buckets[int(idxs[it, 0])].append(int(it))
    cap = max(cap, max(len(b) for b in buckets))

    bucket_ids = np.zeros((nlist, cap), np.int32)
    bucket_vecs = np.zeros((nlist, cap, x.shape[1]), np.float32)
    for b, lst in enumerate(buckets):
        if lst:
            rows = np.asarray(lst, np.int64)
            bucket_ids[b, :len(lst)] = rows + 1      # catalog indices (1-based)
            bucket_vecs[b, :len(lst)] = x[rows]
    return IvfIndexArrays(jnp.asarray(cent), jnp.asarray(bucket_ids),
                          jnp.asarray(bucket_vecs))


@functools.partial(jax.jit, static_argnums=(2, 3))
def ivf_search(index: IvfIndexArrays, queries: jnp.ndarray,
               k: int, nprobe: int):
    """(B, D) queries -> (vals, idx) (B, k) over the probed buckets.

    Cosine space: bucket vectors are unit rows; queries are normalized
    here so scores match ``topk_scores(..., normalize_items=True)`` up to
    the query's (rank-preserving) norm.
    """
    q = queries.astype(jnp.float32)
    q = q / jnp.clip(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    nprobe = min(nprobe, index.nlist)
    cs = q @ index.centroids.T                              # (B, nlist)
    _, probes = jax.lax.top_k(cs, nprobe)                   # (B, nprobe)

    def body(carry, p):
        vals, idx = carry
        b = probes[:, p]                                    # (B,)
        bids = index.bucket_ids[b]                          # (B, cap)
        bvecs = index.bucket_vecs[b]                        # (B, cap, D)
        s = jnp.einsum("bd,bcd->bc", q, bvecs)
        s = jnp.where(bids == 0, -jnp.inf, s)
        allv = jnp.concatenate([vals, s], axis=1)
        alli = jnp.concatenate([idx, bids.astype(jnp.int32)], axis=1)
        vals, sel = jax.lax.top_k(allv, k)
        idx = jnp.take_along_axis(alli, sel, axis=1)
        return (vals, idx), None

    init = (jnp.full((q.shape[0], k), -jnp.inf, jnp.float32),
            jnp.zeros((q.shape[0], k), jnp.int32))
    (vals, idx), _ = jax.lax.scan(body, init, jnp.arange(nprobe))
    return vals, idx


jax.tree_util.register_pytree_node(
    IvfIndexArrays,
    lambda a: ((a.centroids, a.bucket_ids, a.bucket_vecs), None),
    lambda _, c: IvfIndexArrays(*c),
)
