"""Sparse bipartite graph construction + propagation primitives.

The reference builds a scipy normalized adjacency, converts it to a torch
sparse CUDA tensor and runs `sparse.mm` over ALL nodes every step
(`gnn_model/v1_lightgcl.py:104-139, 163-186`). Here the graph is kept as
fixed-shape COO edge arrays and propagation is gather + ``segment_sum`` —
XLA lowers the segment sum to a scatter-add, and it shards cleanly (edges
are data-parallel). The low-rank SVD of the normalized adjacency is
computed once on host at graph-build time (randomized subspace iteration,
the same algorithm as ``torch.svd_lowrank(q, niter)``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class BipartiteGraph:
    """Symmetric normalized user-item graph in COO form.

    Nodes are stacked [users (Nu) | items (Ni)]. ``src/dst/weight`` contain
    BOTH edge directions, padded to a fixed length with weight-0 self loops
    on node 0 (static shapes for jit).
    """

    num_users: int
    num_items: int
    src: np.ndarray      # (E,) int32
    dst: np.ndarray      # (E,) int32
    weight: np.ndarray   # (E,) float32 — D^-1/2 A D^-1/2 normalization
    svd_u: np.ndarray    # (N, q)
    svd_s: np.ndarray    # (q,)
    svd_v: np.ndarray    # (N, q)

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items


def _randomized_svd(mat_vec, mat_tvec, n_rows: int, n_cols: int, q: int,
                    niter: int, rng: np.random.Generator):
    """Randomized low-rank SVD via subspace iteration (host, one-time)."""
    k = min(q + 4, min(n_rows, n_cols))
    omega = rng.normal(size=(n_cols, k)).astype(np.float64)
    y = mat_vec(omega)
    for _ in range(niter):
        y = mat_vec(mat_tvec(y))
    qmat, _ = np.linalg.qr(y)
    b = mat_tvec(qmat).T          # (k, n_cols)
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    u = qmat @ ub
    return (u[:, :q].astype(np.float32), s[:q].astype(np.float32),
            vt[:q].T.astype(np.float32))


def build_graph(user_idx: np.ndarray, item_idx: np.ndarray, num_users: int,
                num_items: int, svd_rank: int = 5, svd_iters: int = 2,
                pad_multiple: int = 1024, seed: int = 0) -> BipartiteGraph:
    """Deduped (user, item) interactions -> normalized symmetric COO graph +
    low-rank SVD of the normalized adjacency."""
    pairs = np.unique(np.stack([user_idx, item_idx], axis=1), axis=0)
    u, i = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    n = num_users + num_items
    deg = np.zeros(n, np.float64)
    np.add.at(deg, u, 1.0)
    np.add.at(deg, num_users + i, 1.0)
    d_inv_sqrt = 1.0 / np.sqrt(np.clip(deg, 1.0, None))
    w = (d_inv_sqrt[u] * d_inv_sqrt[num_users + i]).astype(np.float32)

    src = np.concatenate([u, num_users + i]).astype(np.int32)
    dst = np.concatenate([num_users + i, u]).astype(np.int32)
    weight = np.concatenate([w, w]).astype(np.float32)
    # pad to a fixed multiple with zero-weight edges (node 0 self loop)
    E = len(src)
    target = ((E + pad_multiple - 1) // pad_multiple) * pad_multiple
    pad = target - E
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    weight = np.concatenate([weight, np.zeros(pad, np.float32)])

    # host-side randomized SVD of the (N, N) normalized adjacency
    import scipy.sparse as sp
    adj = sp.coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([u, num_users + i]), np.concatenate([num_users + i, u]))),
        shape=(n, n)).tocsr()
    rng = np.random.default_rng(seed)
    su, ss, sv = _randomized_svd(lambda x: adj @ x, lambda x: adj.T @ x,
                                 n, n, svd_rank, svd_iters, rng)
    return BipartiteGraph(num_users, num_items, src, dst, weight, su, ss, sv)


# The reference's only published throughput anchor: LightGCL on its H&M
# graph, ~200k users x ~47k items with ~11.3M interactions
# (`gnn_model/v1_lightgcl.py:645`; BASELINE.md).
ANCHOR_USERS = 200_000
ANCHOR_ITEMS = 47_000
ANCHOR_INTERACTIONS = 11_300_000


def random_graph(rng: np.random.Generator, num_users: int = ANCHOR_USERS,
                 num_items: int = ANCHOR_ITEMS,
                 num_interactions: int = ANCHOR_INTERACTIONS, svd_rank: int = 5):
    """Seeded stand-in for an interaction graph at a given scale, for timing
    and smoke runs: uniform users, popularity-skewed items (``u**2.5``),
    both edge directions with D^-1/2 A D^-1/2 weights, and random low-rank
    factors (the SVD view costs the same at fixed rank whatever its values).
    Duplicate pairs are kept, so there are exactly ``2 * num_interactions``
    directed edges. Returns ``(graph, users, items)``."""
    u = rng.integers(0, num_users, num_interactions).astype(np.int64)
    i = (num_items * rng.random(num_interactions) ** 2.5).astype(np.int64)
    n = num_users + num_items
    deg = np.bincount(u, minlength=n).astype(np.float64)
    deg[num_users:] += np.bincount(i, minlength=num_items)
    d_inv = 1.0 / np.sqrt(np.clip(deg, 1.0, None))
    w = (d_inv[u] * d_inv[num_users + i]).astype(np.float32)
    src = np.concatenate([u, num_users + i]).astype(np.int32)
    dst = np.concatenate([num_users + i, u]).astype(np.int32)
    weight = np.concatenate([w, w]).astype(np.float32)
    su = rng.normal(0, 0.01, (n, svd_rank)).astype(np.float32)
    ss = np.abs(rng.normal(1.0, 0.1, svd_rank)).astype(np.float32)
    sv = rng.normal(0, 0.01, (n, svd_rank)).astype(np.float32)
    graph = BipartiteGraph(num_users, num_items, src, dst, weight, su, ss, sv)
    return graph, u, i


def propagate(x: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray,
              weight: jnp.ndarray, num_nodes: int) -> jnp.ndarray:
    """One normalized-adjacency propagation step: out = A_norm @ x,
    expressed as gather + segment_sum."""
    msgs = jnp.take(x, src, axis=0) * weight[:, None]
    return jax.ops.segment_sum(msgs, dst, num_segments=num_nodes)


@functools.partial(jax.jit, static_argnames=("num_segments",))
def _seg_accum(acc, x, src, dst, w, *, num_segments):
    msgs = jnp.take(x, src, axis=0) * w[:, None]
    return acc + jax.ops.segment_sum(msgs, dst, num_segments=num_segments)


def propagate_chunked(x, src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                      num_nodes: int, edge_chunk: int = 4_194_304):
    """Memory-bounded ``A_norm @ x`` over a host-resident edge list.

    The naive :func:`propagate` materializes the full (E, D) message array
    — 27.8 GB at the H&M-shape graph (54.3M symmetric edges, D=64),
    observed as an HBM OOM in the GNN export path. This splits the edge
    list into fixed-size chunks (one compiled executable; the ragged tail
    is padded with weight-0 self-loops on node 0) and accumulates
    per-chunk segment-sums. Sum order differs from the single-shot form
    only at fp32 ulp level."""
    E = len(src)
    if E <= edge_chunk:
        return propagate(x, jnp.asarray(np.asarray(src, np.int32)),
                         jnp.asarray(np.asarray(dst, np.int32)),
                         jnp.asarray(np.asarray(weight, np.float32)),
                         num_nodes)
    acc = jnp.zeros((num_nodes, x.shape[1]), jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    for s0 in range(0, E, edge_chunk):
        e = min(s0 + edge_chunk, E)
        s = np.asarray(src[s0:e], np.int32)
        d = np.asarray(dst[s0:e], np.int32)
        w = np.asarray(weight[s0:e], np.float32)
        if e - s0 < edge_chunk:
            pad = edge_chunk - (e - s0)
            s, d = np.pad(s, (0, pad)), np.pad(d, (0, pad))
            w = np.pad(w, (0, pad))
        acc = _seg_accum(acc, x, jnp.asarray(s), jnp.asarray(d),
                         jnp.asarray(w), num_segments=num_nodes)
    return acc


def svd_propagate(x: jnp.ndarray, svd_u: jnp.ndarray, svd_s: jnp.ndarray,
                  svd_v: jnp.ndarray) -> jnp.ndarray:
    """Global (low-rank) view propagation: \\hat{A} x = U (S * (V^T x))."""
    return svd_u @ (svd_s[:, None] * (svd_v.T @ x))


def make_edge_sharded_propagate(mesh, num_nodes: int, axis: str = "model"):
    """Edge-sharded propagation: shard the edge list over ``axis``, each
    shard segment-sums its slice into a full (num_nodes, D) partial, one
    psum merges (edges are embarrassingly data-parallel — SURVEY §2.12 /
    module docstring). x stays replicated; the psum transpose broadcasts
    cotangents, so gradients flow to x on every shard.

    Returns ``(prop_fn, place_edges)``: ``place_edges(src, dst, weight)``
    pads the edge arrays to the axis size (dst 0 / weight 0 pads are no-ops)
    and device_puts them sharded; ``prop_fn((src, dst, w), x)`` matches the
    ``select_propagation`` contract."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from recsys.parallel.mesh import pad_to_multiple, smap

    n_shards = dict(mesh.shape)[axis]
    edge_sharding = NamedSharding(mesh, P(axis))

    def place_edges(src, dst, weight):
        src, _ = pad_to_multiple(np.asarray(src), n_shards)
        dst, _ = pad_to_multiple(np.asarray(dst), n_shards)
        weight, _ = pad_to_multiple(np.asarray(weight), n_shards, fill=0.0)
        return tuple(jax.device_put(jnp.asarray(a), edge_sharding)
                     for a in (src, dst, weight))

    def _local(src_l, dst_l, w_l, x):
        out = jax.ops.segment_sum(jnp.take(x, src_l, axis=0) * w_l[:, None],
                                  dst_l, num_segments=num_nodes)
        return jax.lax.psum(out, axis)

    def prop_fn(args, x):
        src, dst, w = args
        return smap(_local, mesh,
                    in_specs=(P(axis), P(axis), P(axis), P(None, None)),
                    out_specs=P(None, None))(src, dst, w, x)

    return prop_fn, place_edges
