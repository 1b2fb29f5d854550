"""kNN cluster purity of a materialized item matrix vs generator ground truth.

Usage: python scripts/knn_purity.py <data_root> [k]

Measures how much of the latent micro-style structure (items.latent_cluster,
hidden generator ground truth) stage-1 content vectors recover: for each
item, the fraction of its k nearest neighbors (cosine) sharing its cluster,
plus mean within-cluster vs cross-cluster cosine. The content-expressible
ceiling on the v3 mid world is ~0.30 (feature-weighted kNN oracle,
RESULTS.md attribution section). Prints one JSON line.
"""

import json
import sys

import numpy as np
import pandas as pd

sys.path.insert(0, ".")

from recsys.train.checkpoint import load_array_with_ids  # noqa: E402


def knn_purity(vecs: np.ndarray, labels: np.ndarray, k: int = 10,
               sample: int = 0, seed: int = 0) -> dict:
    """``sample`` > 0 estimates purity from that many random QUERY items
    (neighbors still searched over the full catalog) — the full (N, N)
    similarity matrix is 44 GB / ~3 PFLOP at the 105k-item H&M shape."""
    v = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-8)
    n = len(v)
    if sample and sample < n:
        q_rows = np.random.default_rng(seed).choice(n, sample, replace=False)
    else:
        q_rows = np.arange(n)
    same_frac = []
    for s0 in range(0, len(q_rows), 2048):
        rows = q_rows[s0:s0 + 2048]
        sims = v[rows] @ v.T
        sims[np.arange(len(rows)), rows] = -np.inf   # drop self-match
        nn = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        same_frac.append((labels[nn] == labels[rows, None]).mean(1))
    purity = float(np.concatenate(same_frac).mean())
    # within/cross cosine on a subsample of pairs
    rng = np.random.default_rng(0)
    a = rng.integers(0, n, 20000)
    b = rng.integers(0, n, 20000)
    keep = a != b
    pair_sims = np.sum(v[a[keep]] * v[b[keep]], axis=1)
    same_pair = labels[a[keep]] == labels[b[keep]]
    return {
        "knn_purity": purity,
        "k": k,
        "query_sample": int(len(q_rows)),
        "within_cos": float(pair_sims[same_pair].mean()) if same_pair.any() else None,
        "cross_cos": float(pair_sims[~same_pair].mean()),
        "n_items": int(n),
        "n_clusters": int(len(np.unique(labels))),
    }


def main():
    root = sys.argv[1]
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    sample = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    if len(ids) == len(mat):  # sidecar includes the "<pad>" row-0 id
        ids = ids[1:]
    items = pd.read_parquet(f"{root}/items.parquet")
    lab = items.set_index(items["item_id"].astype(str))["latent_cluster"]
    labels = lab.reindex([str(i) for i in ids]).to_numpy()
    vecs = mat[1:]  # drop PAD row
    assert len(vecs) == len(labels)
    print(json.dumps(knn_purity(vecs, labels, k, sample=sample)))


if __name__ == "__main__":
    main()
