"""Collective building blocks used inside ``shard_map`` regions.

These are the replacements for reference behaviors that were
single-device matmuls (SURVEY.md §2.12):

  * ``gather_global_negatives`` — the (B,B) in-batch similarity matrices
    (reference `item_tower.py:1076`, `v1_refine_usertower.py:540`) become
    (B_local, B_global) against an all-gathered embedding matrix.
  * ``sharded_topk`` — full-catalog `U @ I^T` + top-k over a row-sharded item
    matrix: per-shard matmul + topk, then a cross-shard merge on globally
    re-indexed candidates.
  * ``rowsharded_lookup`` — embedding lookup into a row-sharded table: every
    shard answers for its own rows, results are summed across the model axis
    (one psum instead of an all-to-all id exchange — ids are replicated
    across the model axis so this is collective-minimal for small/mid tables).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_global_negatives(local_emb: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """All-gather per-device embeddings along ``axis_name`` into one global
    negatives matrix (B_global, D). Gradient flows back through the local
    slice only (jax differentiates all_gather correctly via reduce-scatter)."""
    return jax.lax.all_gather(local_emb, axis_name, axis=0, tiled=True)


def local_index_offset(axis_name: str, local_rows: int) -> jnp.ndarray:
    """Global row offset of this shard's slice of a row-sharded table."""
    return jax.lax.axis_index(axis_name) * local_rows


def sharded_topk(scores_local: jnp.ndarray, k: int, axis_name: str):
    """Top-k over the concatenation of per-shard score slices.

    ``scores_local``: (B, N_local) — this shard's columns of the full (B, N)
    score matrix. Returns (values, global_indices) each (B, k), identical on
    every shard along ``axis_name``.

    Strategy: local top-k, shift local indices to global ids, all-gather the
    (B, k) candidates from each shard, and take the final top-k of the
    (B, shards*k) merged pool — O(N/shards) work per shard plus an O(k)
    merge, the standard distributed-top-k recipe.
    """
    n_local = scores_local.shape[-1]
    k_local = min(k, n_local)
    vals, idx = jax.lax.top_k(scores_local, k_local)
    idx = idx + local_index_offset(axis_name, n_local)
    # (shards, B, k_local) -> (B, shards*k_local)
    all_vals = jax.lax.all_gather(vals, axis_name)
    all_idx = jax.lax.all_gather(idx, axis_name)
    merged_vals = jnp.moveaxis(all_vals, 0, 1).reshape(vals.shape[0], -1)
    merged_idx = jnp.moveaxis(all_idx, 0, 1).reshape(idx.shape[0], -1)
    top_vals, pos = jax.lax.top_k(merged_vals, min(k, merged_vals.shape[-1]))
    top_idx = jnp.take_along_axis(merged_idx, pos, axis=-1)
    return top_vals, top_idx


def sharded_topk_ring_merge(scores_local: jnp.ndarray, k: int, axis_name: str):
    """``sharded_topk`` with the candidate merge FUSED into the ring hops.

    Instead of all-gathering every shard's (B, k) candidates and doing one
    (B, S*k) merge, the candidate sets ride a ``ppermute`` ring and each
    device folds the arriving set into its running (B, k) each hop: per-hop
    traffic and merge cost stay O(k) regardless of shard count, and the
    merge compute overlaps the next hop's transfer (ROADMAP "fuse the
    candidate merge into the hop loop"). Same contract as ``sharded_topk``.

    Each device folds the candidate sets in a DIFFERENT rotation order, so
    the per-hop merge must be order-independent or tied scores at the k
    boundary would keep different candidates on different devices (breaking
    the replicated-output contract). The merge therefore selects under the
    strict total order (value desc, global index asc) via a two-key sort —
    incremental top-k under a strict total order is exact and fold-order-
    independent.
    """
    n_local = scores_local.shape[-1]
    k_local = min(k, n_local)
    vals, idx = jax.lax.top_k(scores_local, k_local)
    idx = idx + local_index_offset(axis_name, n_local)
    num = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % num) for i in range(num)]

    def merge(av, ai, bv, bi):
        mv = jnp.concatenate([av, bv], axis=-1)
        mi = jnp.concatenate([ai, bi], axis=-1)
        neg_v, sorted_i = jax.lax.sort((-mv, mi), dimension=-1, num_keys=2)
        kk = min(k, mv.shape[-1])
        return -neg_v[..., :kk], sorted_i[..., :kk]

    acc_v, acc_i = vals, idx
    cur_v, cur_i = vals, idx
    for _ in range(num - 1):
        cur_v = jax.lax.ppermute(cur_v, axis_name, perm)
        cur_i = jax.lax.ppermute(cur_i, axis_name, perm)
        acc_v, acc_i = merge(acc_v, acc_i, cur_v, cur_i)
    return acc_v, acc_i


def rowsharded_lookup_a2a(table_local: jnp.ndarray, ids_local: jnp.ndarray,
                          axis_name: str) -> jnp.ndarray:
    """All-to-all row-sharded lookup for LARGE tables / sharded id batches.

    Unlike ``rowsharded_lookup`` (replicated ids, psum merge — one
    collective, O(B*D) traffic per shard), this is the classic DLRM-style
    exchange for when the id batch itself is sharded over the axis:
    every shard receives the full id list (all_gather, O(B) ints), answers
    for its own rows, and an all_to_all returns each shard exactly its own
    slice's embeddings — per-shard traffic O(B*D / S) instead of O(B*D).

    ``ids_local``: (B_local,) this shard's slice of the global id batch.
    Returns (B_local, D) embeddings for ``ids_local``.
    """
    S = jax.lax.axis_size(axis_name)
    n_local = table_local.shape[0]
    offset = local_index_offset(axis_name, n_local)
    # (S, B_local): every shard's ids, replicated here
    all_ids = jax.lax.all_gather(ids_local, axis_name)
    local = all_ids - offset
    mine = (local >= 0) & (local < n_local)
    rows = jnp.take(table_local, jnp.clip(local, 0, n_local - 1), axis=0)
    rows = jnp.where(mine[..., None], rows, 0.0)        # (S, B_local, D)
    # all_to_all: slot s of my answer goes to shard s; I receive every
    # shard's answer for MY ids -> sum over contributors
    exchanged = jax.lax.all_to_all(rows, axis_name, split_axis=0, concat_axis=0,
                                   tiled=False)
    return jnp.sum(exchanged, axis=0)


def rowsharded_lookup(table_local: jnp.ndarray, ids: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Gather rows of a row-sharded (V_local, D) table for replicated ``ids``.

    Each shard contributes its own rows (zeros elsewhere) and a psum merges.
    Differentiable: the psum's transpose scatters cotangents back to the
    owning shard.
    """
    n_local = table_local.shape[0]
    offset = local_index_offset(axis_name, n_local)
    local_ids = ids - offset
    mine = (local_ids >= 0) & (local_ids < n_local)
    safe = jnp.clip(local_ids, 0, n_local - 1)
    rows = jnp.take(table_local, safe, axis=0)
    rows = jnp.where(mine[..., None], rows, 0.0)
    return jax.lax.psum(rows, axis_name)
