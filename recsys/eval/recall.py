"""Full-catalog retrieval evaluation: Recall@{20,100,500}.

Redesign of the reference's ``evaluate_model``
(`v1_usertower_train.py:548-711`): normalize the item matrix once, batch
user forwards, score the whole catalog (``U @ I^T``), take top-max(K) on
device, then compute set-intersection recall on host with users absent from
the ground truth dropped from the denominator.

On a mesh with model-parallel shards the scoring runs through
``sharded_topk`` (per-shard matmul + top-k + cross-shard merge), so eval
and serving share one retrieval code path (SURVEY.md §7.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import PartitionSpec as P

from recsys.parallel.collectives import sharded_topk
from recsys.parallel.mesh import smap


def topk_scores(user_vecs: jnp.ndarray, item_matrix: jnp.ndarray, k: int,
                mesh=None, normalize_items: bool = True,
                prior: jnp.ndarray | None = None, method: str = "exact",
                recall_target: float = 0.95):
    """(B, D) x (N+1, D) -> (vals, idx) (B, k); PAD row 0 excluded.

    With a mesh whose model axis > 1, the item matrix is row-sharded and
    top-k is merged across shards; otherwise a single dense matmul+top_k.

    ``prior``: optional per-item additive score (N+1,) — e.g. a scaled
    log-popularity blend (`eval/baselines.blend_sweep` picks the scale) —
    applied before top-k. On a sharded mesh the prior rides the same
    row-sharding as the item matrix, so the blend is free at any scale.

    ``method="approx"`` (dense path only) swaps the exact ``lax.top_k``
    for ``lax.approx_max_k`` at the given ``recall_target`` (XLA lowers it
    to an exact top-k on the GPU and the CPU) — the serving-time knob; eval keeps the exact default so metrics stay
    honest. The sharded path is always exact (the cross-shard merge is
    already cheap relative to the per-shard matmul).
    """
    items = item_matrix.astype(jnp.float32)
    if normalize_items:
        items = items / jnp.clip(jnp.linalg.norm(items, axis=-1, keepdims=True), 1e-12)
    u = user_vecs.astype(jnp.float32)
    if mesh is not None and mesh.shape[mesh.axis_names[1]] > 1:
        model_axis = mesh.axis_names[1]
        pr = jnp.zeros((items.shape[0],), jnp.float32) if prior is None \
            else prior.astype(jnp.float32)

        def _score(uu, it, pp):
            scores = uu @ it.T + pp[None, :]
            offset = jax.lax.axis_index(model_axis) * it.shape[0]
            col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1) + offset
            scores = jnp.where(col == 0, -jnp.inf, scores)  # mask global PAD row
            return sharded_topk(scores, k, model_axis)

        f = smap(_score, mesh,
                 (P(None, None), P(model_axis, None), P(model_axis)),
                 (P(None, None), P(None, None)))
        return f(u, items, pr)
    scores = u @ items.T
    if prior is not None:
        scores = scores + prior.astype(jnp.float32)[None, :]
    scores = scores.at[:, 0].set(-jnp.inf)
    if method == "approx":
        return jax.lax.approx_max_k(scores, k, recall_target=recall_target)
    return jax.lax.top_k(scores, k)


def recall_at_ks(topk_idx: np.ndarray, user_ids: list, targets_idx: dict,
                 ks=(20, 100, 500)) -> dict:
    """targets_idx: user_id -> set of target item indices. Users without
    targets are dropped from the denominator (reference `:679-699`)."""
    ks = sorted(ks)
    sums = {k: 0.0 for k in ks}
    n_eval = 0
    for r, uid in enumerate(user_ids):
        tgt = targets_idx.get(uid)
        if not tgt:
            continue
        n_eval += 1
        row = topk_idx[r]
        for k in ks:
            hits = len(tgt.intersection(row[:k].tolist()))
            sums[k] += hits / len(tgt)
    if n_eval == 0:
        return {f"recall@{k}": 0.0 for k in ks} | {"n_eval": 0}
    return {f"recall@{k}": sums[k] / n_eval for k in ks} | {"n_eval": n_eval}


def recall_per_user(topk_idx: np.ndarray, user_ids, targets_idx: dict,
                    k: int) -> tuple[np.ndarray, list]:
    """Per-user recall@k over users WITH targets (same denominator semantics
    as ``recall_at_ks``). Returns (values, kept_user_ids) — the raw material
    for bootstrap confidence intervals and paired system comparisons."""
    vals, kept = [], []
    for r, uid in enumerate(user_ids):
        tgt = targets_idx.get(uid)
        if not tgt:
            continue
        vals.append(len(tgt.intersection(topk_idx[r, :k].tolist())) / len(tgt))
        kept.append(uid)
    return np.asarray(vals, np.float64), kept


def bootstrap_mean_ci(values: np.ndarray, n_boot: int = 1000, seed: int = 0,
                      level: float = 0.95) -> dict:
    """Percentile bootstrap CI on the mean of per-user values. Chunked so a
    200k-user eval doesn't allocate an (n_boot, n) resample matrix at once."""
    values = np.asarray(values, np.float64)
    n = len(values)
    if n == 0:
        return {"mean": 0.0, "lo": 0.0, "hi": 0.0, "n": 0}
    rng = np.random.default_rng(seed)
    means = np.empty(n_boot, np.float64)
    chunk = max(1, min(n_boot, int(2e7) // max(n, 1)))
    for s0 in range(0, n_boot, chunk):
        b = min(chunk, n_boot - s0)
        idx = rng.integers(0, n, (b, n))
        means[s0:s0 + b] = values[idx].mean(1)
    a = (1.0 - level) / 2.0
    lo, hi = np.quantile(means, [a, 1.0 - a])
    return {"mean": float(values.mean()), "lo": float(lo), "hi": float(hi),
            "n": n}


def paired_delta_ci(a: np.ndarray, b: np.ndarray, n_boot: int = 1000,
                    seed: int = 0, level: float = 0.95) -> dict:
    """Paired bootstrap on mean(a - b) over the SAME users — the honest test
    for "system A beats system B": per-user differencing removes the shared
    user-difficulty variance that independent CIs double-count.
    ``p_improve`` = fraction of bootstrap resamples with a positive delta."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"paired arrays differ: {a.shape} vs {b.shape}")
    d = a - b
    n = len(d)
    if n == 0:
        return {"delta": 0.0, "lo": 0.0, "hi": 0.0, "p_improve": 0.0, "n": 0}
    rng = np.random.default_rng(seed)
    means = np.empty(n_boot, np.float64)
    chunk = max(1, min(n_boot, int(2e7) // max(n, 1)))
    for s0 in range(0, n_boot, chunk):
        bsz = min(chunk, n_boot - s0)
        idx = rng.integers(0, n, (bsz, n))
        means[s0:s0 + bsz] = d[idx].mean(1)
    q = (1.0 - level) / 2.0
    lo, hi = np.quantile(means, [q, 1.0 - q])
    return {"delta": float(d.mean()), "lo": float(lo), "hi": float(hi),
            "p_improve": float((means > 0).mean()), "n": n}


def evaluate_retrieval(forward_fn, batches, item_matrix, targets_idx,
                       ks=(20, 100, 500), mesh=None) -> dict:
    """Generic retrieval eval: ``forward_fn(batch) -> (B, D) user vectors``;
    ``batches`` yields (batch, user_ids)."""
    max_k = max(ks)
    all_idx, all_uids = [], []
    for batch, uids in batches:
        u = forward_fn(batch)
        _, idx = topk_scores(u, item_matrix, max_k, mesh=mesh)
        all_idx.append(np.asarray(idx))
        all_uids.extend(uids)
    if not all_idx:
        return {f"recall@{k}": 0.0 for k in ks} | {"n_eval": 0}
    return recall_at_ks(np.concatenate(all_idx), all_uids, targets_idx, ks)


def target_rows(user_ids, targets_idx: dict) -> np.ndarray:
    """Row indices of users that have validation targets — the shared
    eval-filtering step (recall_at_ks drops target-less users from the
    denominator, so scoring them is pure waste)."""
    return np.array([r for r, u in enumerate(user_ids) if u in targets_idx],
                    np.int64)
