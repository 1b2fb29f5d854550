"""Reranker stack: FM op, DCN/DeepFM models + training, GBDT, AUC,
retrieve-then-rerank."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from recsys.config import Config, RerankerConfig
from recsys.data.ranker_features import (
    build_rank_features, context_vector, import_interactions)
from recsys.ops.fm import fm_interaction, fm_interaction_vector
from recsys.train import reranker as R

CFG = Config(reranker=RerankerConfig(epochs=60, batch_size=256, deep_hidden=(32, 16)))


def test_fm_identity_matches_explicit_pairs():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(4, 6, 8)).astype(np.float32))
    got = np.asarray(fm_interaction(v))
    expected = np.zeros(4)
    vn = np.asarray(v)
    for b in range(4):
        for i in range(6):
            for j in range(i + 1, 6):
                expected[b] += vn[b, i] @ vn[b, j]
    np.testing.assert_allclose(got, expected, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(fm_interaction_vector(v)).sum(-1),
                               expected, rtol=1e-4)


def test_auc_score():
    y = np.array([1, 1, 0, 0])
    assert R.auc_score(y, np.array([0.9, 0.8, 0.2, 0.1])) == 1.0
    assert R.auc_score(y, np.array([0.1, 0.2, 0.8, 0.9])) == 0.0
    assert R.auc_score(y, np.array([0.5, 0.5, 0.5, 0.5])) == 0.5


def test_rank_features_and_context():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(8, 16)).astype(np.float32)
    i = rng.normal(size=(8, 16)).astype(np.float32)
    um = rng.normal(size=(8, 3)).astype(np.float32)
    im = rng.normal(size=(8, 2)).astype(np.float32)
    f = build_rank_features(u, i, um, im)
    assert f.shape == (8, 10)
    np.testing.assert_allclose(f[:, 0], (u * i).sum(-1), rtol=1e-5)
    ctx = context_vector(np.array([0, 12]), np.array([0, 6]), np.array([10.0, 0.0]),
                         np.array([2.0, 0.0]), np.array([1.0, 30.0]), np.array([0, 2]))
    assert ctx.shape == (2, 20)
    assert ctx[0, 2] == 1.0 and ctx[1, 8] == 1.0  # weekday one-hot
    assert ctx[0, 10] == pytest.approx(0.2)       # CTR 2/10


def _synthetic_ranking_problem(n=3000, seed=0):
    """Label depends on two_tower_score + price fit -> learnable."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 16)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    i = rng.normal(size=(n, 16)).astype(np.float32)
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    um = rng.normal(size=(n, 3)).astype(np.float32)
    im = rng.normal(size=(n, 2)).astype(np.float32)
    X = build_rank_features(u, i, um, im)
    logit = 3.0 * X[:, 0] - 1.5 * np.abs(X[:, 9]) + 0.5 * X[:, 7]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return X, y


def test_gbdt_ranker_learns():
    X, y = _synthetic_ranking_problem()
    model = R.GBDTRanker(iterations=100).fit(X[:2400], y[:2400])
    assert model.auc(X[2400:], y[2400:]) > 0.7


def test_dcn_ranker_learns():
    X, y = _synthetic_ranking_problem()
    state, model, predict = R.train_dcn(CFG, X[:2400], y[:2400])
    assert R.auc_score(y[2400:], predict(X[2400:])) > 0.7


def test_deepfm_learns():
    rng = np.random.default_rng(2)
    n = 4000
    ids = rng.integers(0, 20, size=(n, 3)).astype(np.int32)
    # label: field-0/field-1 interaction pattern
    y = ((ids[:, 0] % 4) == (ids[:, 1] % 4)).astype(np.int32)
    state, model, predict = R.train_deepfm(CFG, ids[:3000], None, y[:3000],
                                           (20, 20, 20))
    assert R.auc_score(y[3000:], predict(ids[3000:])) > 0.8


def test_import_interactions_ratio():
    import pandas as pd
    from recsys.data.dataset import IdMap

    tx = pd.DataFrame({"user_id": ["u1", "u2"], "item_id": ["a", "b"]})
    m = IdMap(["a", "b", "c"])
    users, items, labels, groups = import_interactions(
        tx, 3, m, np.random.default_rng(0), neg_per_pos=5)
    assert labels.sum() == 2 and len(labels) == 12
    assert (np.bincount(groups) == 6).all()


def test_import_interactions_candidates_matches_serve_distribution():
    """Candidate-conditioned negatives: every negative must come from the
    tower's own top-k for that user, never from the user's purchases."""
    import pandas as pd
    from recsys.data.dataset import IdMap
    from recsys.data.ranker_features import import_interactions_candidates

    rng = np.random.default_rng(0)
    N, D = 50, 16
    item_matrix = np.concatenate(
        [np.zeros((1, D), np.float32),
         rng.normal(size=(N, D)).astype(np.float32)])
    m = IdMap([f"i{j}" for j in range(N)])
    # u1 aligned with items 0..9, u2 with items 20..29
    user_vecs = {"u1": item_matrix[1:11].mean(0), "u2": item_matrix[20:30].mean(0)}
    tx = pd.DataFrame({"user_id": ["u1", "u1", "u2"],
                       "item_id": ["i0", "i1", "i20"]})
    users, items, labels, groups = import_interactions_candidates(
        tx, user_vecs, item_matrix, m, rng, neg_per_pos=3, top_k=15)
    assert labels.sum() == 3  # one positive per purchase
    assert (np.bincount(groups) == 4).all()
    # negatives ⊂ that user's top-15 candidates, excluding own purchases
    for uid, vec in user_vecs.items():
        scores = vec @ item_matrix[1:].T
        top = set((np.argsort(-scores)[:15] + 1).tolist())
        own = {m.idx(i) for u, i in zip(tx["user_id"], tx["item_id"]) if u == uid}
        negs = items[(users == uid) & (labels == 0)]
        assert set(negs.tolist()) <= top - own
    # a user with no vector contributes nothing
    tx2 = pd.DataFrame({"user_id": ["ghost"], "item_id": ["i0"]})
    out = import_interactions_candidates(tx2, user_vecs, item_matrix, m, rng)
    assert len(out[0]) == 0


def test_rerank_system_end_to_end():
    rng = np.random.default_rng(3)
    N, D = 50, 16
    mat = rng.normal(size=(N + 1, D)).astype(np.float32)
    mat /= np.clip(np.linalg.norm(mat, axis=1, keepdims=True), 1e-9, None)
    mat[0] = 0
    meta = np.abs(rng.normal(size=(N + 1, 2))).astype(np.float32)
    sys = R.ReRankingSystem(mat, meta, scorer=lambda f: f[:, 0],  # score = dot
                            retrieve_k=20, final_k=5)
    ids, proba = sys.recommend(mat[7], np.zeros(3, np.float32))
    assert ids[0] == 7 and len(ids) == 5  # self retrieval survives rerank
    assert (proba[:-1] >= proba[1:]).all()


def test_dcn_pairwise_groupwise_learns():
    """loss='pairwise' trains on the importers' 1:N groups (group ids LIVE,
    not dead weight) and matches/beats pointwise AUC on the same problem."""
    import dataclasses

    X, _ = _synthetic_ranking_problem()
    S = 6  # 1 positive + 5 negatives per group, importer layout
    n = (len(X) // S) * S
    X = X[:n]
    groups = np.repeat(np.arange(n // S, dtype=np.int32), S)
    # the group positive = the feature-wise best row (same signal the
    # pointwise fixture uses), so the ranking is learnable
    logit = (3.0 * X[:, 0] - 1.5 * np.abs(X[:, 9]) + 0.5 * X[:, 7]).reshape(-1, S)
    y = np.zeros((n // S, S), np.int32)
    y[np.arange(n // S), logit.argmax(1)] = 1
    y = y.reshape(-1)
    cfg = dataclasses.replace(
        CFG, reranker=dataclasses.replace(CFG.reranker, loss="pairwise"))
    split = (int(0.8 * n) // S) * S
    state, model, predict = R.train_dcn(cfg, X[:split], y[:split],
                                        groups=groups[:split])
    auc = R.auc_score(y[split:], predict(X[split:]))
    assert auc > 0.65, auc
