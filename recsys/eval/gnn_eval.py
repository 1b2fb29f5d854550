"""GNN standalone retrieval eval + distillation fidelity (VERDICT r3
item 4).

The reference evaluates its LightGCL artifacts with RAW DOT-PRODUCT
scores over the GNN embedding space — explicitly not cosine, because the
embedding magnitudes carry popularity mass
(`gnn_model/v1_evaluate_lightgcl.py:275-340`) — and distills that
magnitude into angles so cosine-only ANN engines preserve the ranking
(`gnn_model/distill_mag_to_cos_l2.py:6-108`). Round 3 shipped the
distill but never measured either: the GNN arm of the ensemble report
was scored as raw-user x distilled-item cosine (a pairing the distill
never trained) and came out as noise, leaving "signal lives in the
hybrid consumer" vs "distill silently failed" indistinguishable.

This module settles it with four retrieval rows against the real
validation targets plus direct teacher-student ranking fidelity:

  gnn_dot          — teacher users x teacher items, dot (the protocol row)
  gnn_cos          — same vectors, cosine (how much magnitude matters)
  distill_cos      — student users x student items, cosine (the pairing
                     the distill trains — what an ANN engine would serve)
  distill_cos_raw_users — teacher users x student items (the r3 ensemble
                     consumer's pairing, kept as the regression row)

  fidelity@k       — mean |teacher-dot top-k ∩ X top-k| / k on a user
                     sample, for X in {distill_cos, distill_cos_raw_users}
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys.eval.recall import recall_at_ks, topk_scores


def _pad_matrix(items: np.ndarray) -> np.ndarray:
    """GNN artifacts are dense 0-based (no PAD row, export meta records
    it); topk_scores masks row 0 — prepend a zero PAD row and shift."""
    return np.concatenate([np.zeros((1, items.shape[1]), np.float32),
                           np.asarray(items, np.float32)])


def topk_rows(users: np.ndarray, items: np.ndarray, k: int,
              normalize: bool, batch: int = 4096) -> np.ndarray:
    """(U, k) top-k item indices in PADDED indexing (real item i -> i+1).
    Chunked device scoring; one executable for all full-size chunks."""
    k = min(k, len(items))  # tiny catalogs: top_k caps at N real items
    im = jnp.asarray(_pad_matrix(items))
    if normalize:
        u = np.asarray(users, np.float32)
        u = u / np.clip(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12, None)
    else:
        u = np.asarray(users, np.float32)
    fn = jax.jit(lambda uu, it: topk_scores(uu, it, k,
                                            normalize_items=normalize)[1])
    out = []
    for s in range(0, len(u) - batch + 1, batch):
        out.append(fn(u[s:s + batch], im))
    tail = len(out) * batch
    if tail < len(u):
        out.append(fn(u[tail:], im))
    if not out:
        return np.zeros((0, k), np.int64)
    return np.concatenate([np.asarray(o) for o in out]).astype(np.int64)


def standalone_rows(gnn_users: np.ndarray, user_ids: list[str],
                    gnn_items: np.ndarray, item_ids: list[str],
                    targets: dict, ks=(20, 100, 500),
                    distilled_items: np.ndarray | None = None,
                    distilled_users: np.ndarray | None = None) -> dict:
    """Recall rows against ``targets`` ({user_id: [item_id, ...]}), all in
    the GNN artifact's own id space (reference protocol — no stage-2 map
    involved)."""
    item_row = {str(i): r + 1 for r, i in enumerate(item_ids)}  # padded idx
    targets_idx = {}
    for u, its in targets.items():
        s = {item_row[i] for i in map(str, its) if i in item_row}
        if s:
            targets_idx[u] = s
    rows = [r for r, u in enumerate(user_ids) if u in targets_idx]
    uids = [user_ids[r] for r in rows]
    tu = np.asarray(gnn_users, np.float32)[rows]
    max_k = max(ks)
    out = {"n_eval_users": len(rows)}
    out["gnn_dot"] = recall_at_ks(
        topk_rows(tu, gnn_items, max_k, normalize=False), uids, targets_idx, ks)
    out["gnn_cos"] = recall_at_ks(
        topk_rows(tu, gnn_items, max_k, normalize=True), uids, targets_idx, ks)
    if distilled_items is not None:
        # the raw-user x distilled-item pairing only type-checks when the
        # student keeps the teacher's width (distill.out_dim == gnn.emb_dim)
        if distilled_items.shape[1] == gnn_users.shape[1]:
            out["distill_cos_raw_users"] = recall_at_ks(
                topk_rows(tu, distilled_items, max_k, normalize=True),
                uids, targets_idx, ks)
        if distilled_users is not None:
            su = np.asarray(distilled_users, np.float32)[rows]
            out["distill_cos"] = recall_at_ks(
                topk_rows(su, distilled_items, max_k, normalize=True),
                uids, targets_idx, ks)
    return out


def distill_fidelity(gnn_users: np.ndarray, gnn_items: np.ndarray,
                     distilled_items: np.ndarray,
                     distilled_users: np.ndarray | None = None,
                     k: int = 100, sample: int = 4096, seed: int = 0) -> dict:
    """Teacher-student ranking fidelity: the fraction of the teacher's
    dot-product top-k reproduced by the student's cosine top-k, averaged
    over a user sample (the distill's entire purpose — reference
    `distill_mag_to_cos_l2.py:6-108`)."""
    rng = np.random.default_rng(seed)
    n = len(gnn_users)
    k = min(k, len(gnn_items))
    rows = (rng.choice(n, sample, replace=False) if sample < n
            else np.arange(n))
    tu = np.asarray(gnn_users, np.float32)[rows]
    teacher = topk_rows(tu, gnn_items, k, normalize=False)
    out = {"k": k, "sample": int(len(rows))}

    def overlap(student_idx):
        hits = [len(set(t.tolist()) & set(s.tolist())) / k
                for t, s in zip(teacher, student_idx)]
        return float(np.mean(hits))

    if distilled_items.shape[1] == gnn_users.shape[1]:
        out["fidelity_raw_users"] = overlap(
            topk_rows(tu, distilled_items, k, normalize=True))
    if distilled_users is not None:
        su = np.asarray(distilled_users, np.float32)[rows]
        out["fidelity"] = overlap(
            topk_rows(su, distilled_items, k, normalize=True))
    return out
