"""User-side vectorize symmetry: process-pending / refresh / recommend.

The reference declares ``user_profiles.user_service_vector`` plus a
not-vectorized partial index (`database.py:152-173`) but never populates or
queries it; these flows give users the same contract products have.
"""

import numpy as np
import pytest

from recsys.config import Config
from recsys.serve.app import (
    build_app_context, history_user_vectorizer, tower_user_vectorizer,
)
from recsys.serve.server import make_server, serve_forever_in_thread
from recsys.serve.store import ActionType


def _ctx_with_world():
    cfg = Config()
    ctx = build_app_context(cfg)
    products = [
        {"product_id": f"p{i}", "product_name": f"item {i}",
         "feature_data": {"reinforced_feature": {
             "CAT": ["sweater" if i % 2 else "jeans"],
             "COL": ["red" if i < 3 else "blue"]}}}
        for i in range(6)
    ]
    ctx.store.ingest_products(products)
    while ctx.process_pending()["processed_count"]:
        pass
    ctx.store.insert_manual_data(
        users=[{"user_id": "u1", "gender": "female", "age_group": "25-34"},
               {"user_id": "u2", "gender": "male", "age_group": "50+"}],
        sessions=[
            {"user_id": "u1", "events": [
                {"product_id": "p1", "action_type": int(ActionType.PURCHASE), "ts": 1000.0},
                {"product_id": "p3", "action_type": int(ActionType.CLICK), "ts": 2000.0}]},
            {"user_id": "u2", "events": [
                {"product_id": "p0", "action_type": int(ActionType.CART), "ts": 1500.0}]},
        ])
    return cfg, ctx


def test_process_pending_users_contract():
    _, ctx = _ctx_with_world()
    assert ctx.store.user_pending_count() == 2
    r1 = ctx.process_pending_users(batch_size=1)
    assert r1 == {"processed_count": 1, "remaining": 1}
    r2 = ctx.process_pending_users()
    assert r2["processed_count"] == 1 and r2["remaining"] == 0
    assert ctx.process_pending_users()["processed_count"] == 0
    v = ctx.store.get_user_vector("u1")
    assert v is not None and v.shape == (128,)
    assert np.linalg.norm(v) == pytest.approx(1.0, abs=1e-4)


def test_new_interactions_invalidate_user_vector():
    _, ctx = _ctx_with_world()
    ctx.refresh_user_vectors()
    assert ctx.store.user_pending_count() == 0
    ctx.store.insert_manual_data(
        users=[], sessions=[{"user_id": "u1", "events": [
            {"product_id": "p5", "action_type": int(ActionType.PURCHASE),
             "ts": 3000.0}]}])
    assert ctx.store.user_pending_count() == 1
    assert ctx.store.pending_users(10)[0]["user_id"] == "u1"


def test_history_vectorizer_weights_actions():
    _, ctx = _ctx_with_world()
    fn = history_user_vectorizer(ctx, half_life_s=1e12)  # no decay
    vecs = fn([{"user_id": "u1"}, {"user_id": "u2"}, {"user_id": "ghost"}])
    # u1: PURCHASE(5)*p1 + CLICK(1)*p3, normalized -> closer to p1 than p3
    p1 = ctx.store.get_vector("p1")
    p3 = ctx.store.get_vector("p3")
    assert float(vecs[0] @ p1) > float(vecs[0] @ p3)
    # empty history -> zero vector, not NaN
    assert np.all(vecs[2] == 0)


def test_recommendations_exclude_seen():
    _, ctx = _ctx_with_world()
    ctx.refresh_user_vectors()
    rec = ctx.recommend_for_user("u1", top_k=4)
    pids = [r["product_id"] for r in rec["results"]]
    assert pids and "p1" not in pids and "p3" not in pids
    rec_all = ctx.recommend_for_user("u1", top_k=6, exclude_seen=False)
    assert "p1" in [r["product_id"] for r in rec_all["results"]]
    assert ctx.recommend_for_user("nobody")["results"] == []


def test_http_user_routes():
    import json
    import urllib.request

    _, ctx = _ctx_with_world()
    server = make_server(ctx, host="127.0.0.1", port=0)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def post(path, payload=None):
            req = urllib.request.Request(
                base + path, data=json.dumps(payload or {}).encode(),
                method="POST")
            return json.loads(urllib.request.urlopen(req).read())

        def get(path):
            return json.loads(urllib.request.urlopen(base + path).read())

        r = post("/ai-api/serving/users/process-pending")
        assert r["processed_count"] == 2
        r = post("/ai-api/serving/bg/inference/refresh-user-vectors")
        assert r["count"] == 2
        rec = get("/api/controller/recommendations/u2?top_k=3")
        assert len(rec["results"]) == 3
        assert all(r["product_id"] != "p0" for r in rec["results"])
    finally:
        server.shutdown()


def test_tower_user_vectorizer_shapes():
    cfg, ctx = _ctx_with_world()
    import jax

    from recsys.train.sasrec import init_stage2_params

    item_ids = ["<pad>"] + [f"p{i}" for i in range(6)]
    L = cfg.user_tower.max_len
    sample = {
        "input_ids": np.zeros((2, L), np.int32),
        "time_buckets": np.zeros((2, L), np.int32),
        "seq_mask": np.zeros((2, L), np.int32),
        "user_buckets": np.zeros((2, cfg.user_tower.static_bucket_fields), np.int32),
        "user_cats": np.zeros((2, cfg.user_tower.static_cat_fields), np.int32),
        "user_cont": np.zeros((2, cfg.user_tower.static_cont_fields), np.float32),
    }
    params, _ = init_stage2_params(cfg, len(item_ids), None,
                                   jax.random.PRNGKey(0), sample)
    fn = tower_user_vectorizer(ctx, cfg, params, item_ids)
    vecs = fn([{"user_id": "u1"}, {"user_id": "ghost"}])
    assert vecs.shape == (2, cfg.user_tower.d_model)
    assert np.linalg.norm(vecs[0]) == pytest.approx(1.0, abs=1e-2)
    assert np.all(np.isfinite(vecs))
