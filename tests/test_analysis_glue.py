"""Stratified K-fold, persona clustering, and store-backed training glue."""

import numpy as np
import pytest

import jax

from recsys.config import (
    Config, DataConfig, ItemTowerConfig, MeshConfig, ServeConfig, SimCSEConfig,
    UserTowerConfig, UserTrainConfig, VocabConfig)
from recsys.data.analysis import (
    behavior_features, cluster_personas, stratified_kfold)
from recsys.data.synthetic import generate_dataset
from recsys.parallel.mesh import build_mesh

CFG = Config(data=DataConfig(num_items=150, num_users=60, days=50, seed=21))


@pytest.fixture(scope="module")
def world():
    return generate_dataset(CFG.data)


def test_stratified_kfold(world):
    items, _, _ = world
    folded = stratified_kfold(items, n_splits=5)
    kept = folded[folded["fold"] >= 0]
    assert set(kept["fold"]) == {0, 1, 2, 3, 4}
    # stratification: each retained class appears in most folds
    for cls, g in kept.groupby("product_type_name"):
        assert g["fold"].nunique() >= min(5, len(g))
    # rare classes dropped
    counts = items["product_type_name"].value_counts()
    rare = counts[counts < 5].index
    assert (folded[folded["product_type_name"].isin(rare)]["fold"] == -1).all()


def test_persona_clustering(world):
    items, _, tx = world
    behavior = behavior_features(tx, items)
    assert len(behavior) == tx["user_id"].nunique()
    assert not behavior.isna().any().any()
    clustered, tags = cluster_personas(behavior, n_clusters=4)
    assert clustered["cluster"].nunique() == 4
    assert all(isinstance(t, str) and t for t in tags.values())
    assert "persona_tag" in clustered


def test_store_backed_item_trainer(tmp_path):
    from recsys.serve.store import ServeStore
    from recsys.serve.train_glue import make_item_trainer

    cfg = Config(
        data=DataConfig(seed=0),
        vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=256),
        item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1),
        simcse=SimCSEConfig(batch_size=8, epochs=1, steps_per_epoch_min=1))
    store = ServeStore()
    store.ingest_products([
        {"product_id": f"p{i}", "product_name": f"red shirt {i}",
         "feature_data": {"product_type_name": "shirt",
                          "reinforced_feature": {"CAT": ["shirt"], "COL": ["red"]}}}
        for i in range(24)])
    mesh = build_mesh(MeshConfig(num_data=1, num_model=1), jax.devices()[:1])
    train = make_item_trainer(cfg, store, mesh, str(tmp_path))
    out = train(epochs=1)
    assert out["trained"] == "item-tower" and out["steps"] > 0
    # too few products -> graceful error
    empty = ServeStore()
    assert "error" in make_item_trainer(cfg, empty, mesh, str(tmp_path))()


def test_store_backed_user_trainer(tmp_path):
    from recsys.serve.store import ActionType, ServeStore
    from recsys.serve.train_glue import make_user_trainer

    cfg = Config(
        data=DataConfig(seed=0),
        vocab=VocabConfig(num_hash_buckets=20),
        user_tower=UserTowerConfig(max_len=6, num_layers=1),
        user_train=UserTrainConfig(batch_size=8, epochs=1, positions_per_user=1,
                                   eval_ks=(5,), steps_per_epoch_min=1))
    store = ServeStore()
    store.ingest_products([
        {"product_id": f"p{i}", "product_name": f"item {i}",
         "feature_data": {"product_type_name": "shirt",
                          "reinforced_feature": {"CAT": ["shirt"]}}}
        for i in range(30)])
    # vectorize so session validation passes
    rng = np.random.default_rng(0)
    store.save_vectors([f"p{i}" for i in range(30)],
                       rng.normal(size=(30, 128)).astype(np.float32))
    sessions = []
    for u in range(12):
        for s in range(3):
            sessions.append({
                "user_id": f"u{u}", "started_at": 86400.0 * (s * 4 + u % 3),
                "events": [{"product_id": f"p{rng.integers(30)}",
                            "action_type": int(ActionType.PURCHASE)}
                           for _ in range(2)]})
    r = store.insert_manual_data([{"user_id": f"u{u}"} for u in range(12)], sessions)
    assert r["ok"]
    mesh = build_mesh(MeshConfig(num_data=1, num_model=1), jax.devices()[:1])
    train = make_user_trainer(cfg, store, mesh, str(tmp_path))
    out = train(epochs=1)
    assert out.get("trained") == "user-tower", out
    assert out["epochs"] == 1
