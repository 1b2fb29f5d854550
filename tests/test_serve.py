"""Serving layer: native vector index, sqlite store, app flows, HTTP routes."""

import json
import urllib.request

import numpy as np
import pytest

from recsys.config import Config, ServeConfig
from recsys.serve.ann import VectorIndex, native_available
from recsys.serve.app import AppContext, build_app_context, hash_vectorizer
from recsys.serve.server import make_server, serve_forever_in_thread
from recsys.serve.store import ActionType, ServeStore

CFG = Config(serve=ServeConfig(db_path=":memory:", batch_size=8))


def _products(n, prefix="p"):
    return [{"product_id": f"{prefix}{i}",
             "product_name": f"blue cotton shirt {i}",
             "feature_data": {"reinforced_feature": {"CAT": ["shirt"],
                                                     "COL": ["blue" if i % 2 else "red"]}}}
            for i in range(n)]


def test_vector_index_exact_topk():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(200, 32)).astype(np.float32)
    ix = VectorIndex(32)
    ix.add(np.arange(200) + 1000, vecs)
    ids, scores = ix.topk(vecs[:4], 5, num_threads=2)
    # exact match vs numpy cosine
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    ref = vn[:4] @ vn.T
    for r in range(4):
        expect = np.argsort(-ref[r])[:5] + 1000
        np.testing.assert_array_equal(ids[r], expect)
    assert native_available()  # g++ is baked in; the native path must build


def test_store_ingest_upsert_semantics():
    store = ServeStore()
    r1 = store.ingest_products(_products(3))
    assert r1 == {"created": 3, "updated": 0, "unchanged": 0}
    # vectorize all, then re-ingest: unchanged payload keeps flags
    items = store.pending_products(10)
    store.save_vectors([i.product_id for i in items], np.ones((3, 4), np.float32))
    assert store.pending_count() == 0
    r2 = store.ingest_products(_products(3))
    assert r2["unchanged"] == 3 and store.pending_count() == 0
    # changed payload resets is_vectorized
    changed = _products(3)
    changed[0]["feature_data"]["reinforced_feature"]["COL"] = ["green"]
    r3 = store.ingest_products(changed)
    assert r3["updated"] == 1 and store.pending_count() == 1


def test_store_manual_data_validation():
    store = ServeStore()
    store.ingest_products(_products(2))
    sessions = [{"user_id": "u1", "events": [
        {"product_id": "p0", "action_type": int(ActionType.PURCHASE)}]}]
    r = store.insert_manual_data([{"user_id": "u1"}], sessions)
    assert r["ok"] is False and r["missing_product_vectors"] == ["p0"]
    store.save_vectors(["p0"], np.ones((1, 4), np.float32))
    r2 = store.insert_manual_data([{"user_id": "u1"}], sessions)
    assert r2["ok"] and r2["events"] == 1
    ps = store.purchase_sessions()
    assert len(ps) == 1 and ps[0]["user_id"] == "u1"


def test_app_process_pending_drains():
    ctx = build_app_context(CFG)
    ctx.store.ingest_products(_products(20))
    total, loops = 0, 0
    while loops < 100:  # the DAG loop contract
        r = ctx.process_pending()
        if r["processed_count"] == 0:
            break
        total += r["processed_count"]
        loops += 1
    assert total == 20 and ctx.store.pending_count() == 0
    assert len(ctx.index) == 20
    # idempotent: nothing left
    assert ctx.process_pending()["processed_count"] == 0
    # similarity: same-color shirts cluster under the hash vectorizer
    sim = ctx.similar_items("p0", top_k=5)
    assert sim["results"] and sim["results"][0]["product_id"] != "p0"


def test_app_process_by_ids_and_refresh(tmp_path):
    ctx = build_app_context(CFG)
    ctx.store.ingest_products(_products(6))
    r = ctx.process_by_ids(["p1", "p3", "nope"])
    assert r["processed_count"] == 2 and r["missing"] == ["nope"]
    r2 = ctx.refresh_item_vectors(str(tmp_path / "mat"))
    assert r2["count"] == 6
    from recsys.train.checkpoint import load_array_with_ids
    arr, ids, _ = load_array_with_ids(str(tmp_path / "mat"))
    assert arr.shape == (7, 128) and ids[0] == "<pad>"


@pytest.fixture()
def http_ctx():
    ctx = build_app_context(CFG)
    ctx.train_item_fn = lambda **kw: {"trained": True, "epochs": kw.get("epochs", 1)}
    ctx.train_user_fn = lambda **kw: {"trained": "user"}
    server = make_server(ctx, host="127.0.0.1", port=0)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield ctx, base
    server.shutdown()


def _call(base, method, path, payload=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_contract(http_ctx):
    ctx, base = http_ctx
    code, health = _call(base, "GET", "/")
    assert code == 200 and health["status"] == "ok"
    assert health["platform"] == "cpu" and health["count"] == 8

    code, r = _call(base, "POST", "/api/controller/products/ingest",
                    {"products": _products(10, "q")})
    assert code == 200 and r["created"] == 10

    # loop-until-drained (hourly DAG contract)
    drained = 0
    for _ in range(100):
        code, r = _call(base, "POST", "/ai-api/serving/vectors/process-pending", {})
        assert code == 200
        if r["processed_count"] == 0:
            break
        drained += r["processed_count"]
    assert drained == 10

    code, sim = _call(base, "GET", "/api/controller/similarity/q1?top_k=3")
    assert code == 200 and len(sim["results"]) == 3

    code, r = _call(base, "POST", "/ai-api/serving/vectors/process-by-ids",
                    {"product_ids": ["q2"]})
    assert code == 200 and r["processed_count"] == 1

    code, r = _call(base, "POST", "/ai-api/serving/train/item-tower", {"epochs": 2})
    assert code == 200 and r == {"trained": True, "epochs": 2}
    code, r = _call(base, "POST", "/ai-api/serving/train/start", {})
    assert code == 200 and r["started"]
    code, r = _call(base, "POST", "/ai-api/serving/train/user-tower", {})
    assert code == 200 and r == {"trained": "user"}

    code, r = _call(base, "POST", "/api/v1/debug/insert-manual-data",
                    {"users": [{"user_id": "u9"}],
                     "sessions": [{"user_id": "u9", "events": [
                         {"product_id": "q1", "action_type": 5}]}]})
    assert code == 200 and r["ok"]

    code, r = _call(base, "GET", "/definitely/not/a/route")
    assert code == 404


def test_hnsw_index_recall_on_clustered_embeddings():
    """Native HNSW (reference pgvector config) must recover >95% of exact
    top-50 on clustered embeddings — the realistic regime."""
    from recsys.serve.ann import HnswIndex, hnsw_available

    assert hnsw_available()
    rng = np.random.default_rng(0)
    N, D = 4000, 64
    centers = rng.normal(size=(40, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 40, N)]
            + rng.normal(size=(N, D))).astype(np.float32)
    hx = HnswIndex(D)
    hx.add(np.arange(N), vecs)
    assert len(hx) == N
    ex = VectorIndex(D)
    ex.add(np.arange(N), vecs)
    q = (centers[rng.integers(0, 40, 40)] + rng.normal(size=(40, D))).astype(np.float32)
    h_ids, h_scores = hx.topk(q, 50)
    e_ids, _ = ex.topk(q, 50)
    recall = np.mean([len(set(h_ids[i]) & set(e_ids[i])) / 50 for i in range(40)])
    assert recall > 0.95
    assert (np.diff(h_scores, axis=1) <= 1e-6).all()  # sorted descending
    # upsert keeps size; save/load round trip
    hx.add([5], vecs[6:7])
    assert len(hx) == N
    import tempfile, os
    path = os.path.join(tempfile.mkdtemp(), "h.bin")
    hx.save(path)
    hx2 = HnswIndex.load(path)
    ids2, _ = hx2.topk(q[:3], 5)
    assert (ids2 >= 0).all()


def test_hnsw_parallel_build_matches_serial_quality():
    """Concurrent insert (striped link locks) must keep graph quality: both
    builds recover >95% of exact top-20, and parallel adds stay queryable
    mid-stream (upserts + later batches)."""
    from recsys.serve.ann import HnswIndex

    rng = np.random.default_rng(7)
    N, D = 6000, 64
    centers = rng.normal(size=(60, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 60, N)]
            + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 60, 50)]
         + rng.normal(size=(50, D))).astype(np.float32)
    ex = VectorIndex(D)
    ex.add(np.arange(N), vecs)
    e_ids, _ = ex.topk(q, 20)

    def recall(ix):
        h_ids, _ = ix.topk(q, 20)
        return np.mean([len(set(h_ids[i]) & set(e_ids[i])) / 20
                        for i in range(len(q))])

    serial = HnswIndex(D)
    serial.add(np.arange(N), vecs, num_threads=1)
    parallel = HnswIndex(D)
    parallel.add(np.arange(N // 2), vecs[: N // 2], num_threads=8)
    parallel.add(np.arange(N // 2, N), vecs[N // 2:], num_threads=8)
    assert len(parallel) == N
    r_serial, r_parallel = recall(serial), recall(parallel)
    assert r_serial > 0.95
    assert r_parallel > 0.95
    # upsert after parallel build keeps the graph intact
    parallel.add(np.arange(32), vecs[32:64], num_threads=4)
    assert len(parallel) == N


def test_app_context_hnsw_backend():
    from recsys.config import Config, ServeConfig
    from recsys.serve.ann import HnswIndex

    cfg = Config(serve=ServeConfig(db_path=":memory:", batch_size=8,
                                   ann_backend="hnsw"))
    ctx = build_app_context(cfg)
    assert isinstance(ctx.index, HnswIndex)
    ctx.store.ingest_products(_products(12))
    while ctx.process_pending()["processed_count"]:
        pass
    sim = ctx.similar_items("p0", top_k=5)
    assert len(sim["results"]) == 5


def test_model_backed_vectorizer_consistency():
    """serve-time model vectorizer must agree with the offline
    materialization path for the same params."""
    import jax
    from recsys.config import (
        DataConfig, ItemTowerConfig, MeshConfig, SimCSEConfig, VocabConfig)
    from recsys.data.dataset import tokenize_items
    from recsys.data.synthetic import generate_dataset
    from recsys.data.vocab import StdVocab
    from recsys.parallel.mesh import build_mesh
    from recsys.serve.app import model_vectorizer
    from recsys.serve.store import TrainingItem
    from recsys.train.simcse import build_model, init_params, materialize_item_vectors

    cfg = Config(
        data=DataConfig(num_items=24, num_users=8, days=20, seed=9),
        vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=256),
        item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1))
    items, _, _ = generate_dataset(cfg.data)
    tensors = tokenize_items(items, StdVocab(), cfg.vocab)
    params = init_params(build_model(cfg, StdVocab().size, 6), tensors,
                         jax.random.PRNGKey(0))
    mesh = build_mesh(MeshConfig(num_data=1, num_model=1), jax.devices()[:1])
    import tempfile
    mat = materialize_item_vectors(cfg, params, tensors, mesh,
                                   tempfile.mkdtemp() + "/m", batch_size=24)

    vec_fn = model_vectorizer(cfg, params)
    recs = items.sort_values("item_id").to_dict("records")
    std_fields = ("product_type_name", "graphical_appearance_name",
                  "colour_group_name", "department_name", "section_name",
                  "perceived_colour_value_name")
    training_items = [
        TrainingItem(r["item_id"],
                     {"reinforced_feature": r["reinforced_feature"],
                      **{f: r[f] for f in std_fields}},
                     r["product_name"])
        for r in recs[:6]]
    served = vec_fn(training_items)
    np.testing.assert_allclose(served, mat[1:7], atol=2e-2)


def test_service_table_twin_paths():
    """The product_service_* twin tables run the same flows."""
    store = ServeStore()
    store.ingest_products(_products(4, "s"), table="service")
    assert store.pending_count("service") == 4
    assert store.pending_count("inference") == 0
    items = store.pending_products(10, "service")
    store.save_vectors([i.product_id for i in items],
                       np.ones((4, 8), np.float32), "service")
    assert store.pending_count("service") == 0
    ids, vecs = store.all_vectors("service")
    assert len(ids) == 4 and vecs.shape == (4, 8)


# -- dynamic request batching ------------------------------------------------

def test_dynamic_batcher_coalesces_and_slices():
    """Concurrent submits share one underlying call, and every caller gets
    exactly its own rows back (order within a request preserved)."""
    import threading
    import time

    from recsys.serve.batcher import DynamicBatcher

    calls = []

    def fn(items):
        calls.append(len(items))
        time.sleep(0.01)  # make the device call slow enough to coalesce under
        return np.asarray([[float(i)] * 4 for i in items], np.float32)

    b = DynamicBatcher(fn, max_wait_ms=50.0)
    results = {}
    barrier = threading.Barrier(6)

    def worker(tag, payload):
        barrier.wait()
        results[tag] = b.submit(payload)

    threads = [threading.Thread(target=worker, args=(t, [t * 10 + j for j in range(t + 1)]))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tag, out in results.items():
        expect = np.asarray([[float(tag * 10 + j)] * 4 for j in range(tag + 1)])
        np.testing.assert_allclose(out, expect)
    assert len(calls) < 6, f"no coalescing happened: {calls}"
    stats = b.stats()
    assert stats["requests"] == 6 and stats["coalesce_ratio"] > 1.0


def test_dynamic_batcher_propagates_errors():
    from recsys.serve.batcher import DynamicBatcher

    def bad(items):
        raise ValueError("boom")

    b = DynamicBatcher(bad, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="boom"):
        b.submit([1, 2])
    # the batcher recovers: leadership was released
    ok = DynamicBatcher(lambda xs: np.zeros((len(xs), 2)), max_wait_ms=1.0)
    assert ok.submit([1]).shape == (1, 2)


def test_app_context_wraps_vectorizer_with_batcher():
    ctx = build_app_context(CFG)
    assert hasattr(ctx.vectorize_fn, "stats")  # DynamicBatcher facade
    ctx.store.ingest_products(_products(5))
    out = ctx.process_pending()
    assert out["processed_count"] == 5


def test_season_aware_recommendations():
    """recommend_for_user(season=...): matching items get the bonus and
    re-rank; season='auto' reads the latest session's season (the field the
    reference stores but never consumes, `database.py:185`)."""
    ctx = build_app_context(CFG)
    prods = []
    for i in range(12):
        micro = "deep_winter" if i % 2 else "high_summer"
        prods.append({"product_id": f"s{i}", "product_name": f"wool coat {i}",
                      "feature_data": {"reinforced_feature": {
                          "CAT": ["coat"], "CTX": ["daily", micro]}}})
    ctx.store.ingest_products(prods)
    while ctx.process_pending()["processed_count"]:
        pass
    # seed a user vector + session via the debug route
    r = ctx.store.insert_manual_data(
        [{"user_id": "u1", "gender": "female"}],
        [{"user_id": "u1", "season": "Winter",
          "events": [{"product_id": "s1", "action_type": 5}]}])
    assert r["ok"]
    ctx.refresh_user_vectors()
    base = ctx.recommend_for_user("u1", top_k=6)
    assert base["results"]
    rec = ctx.recommend_for_user("u1", top_k=6, season="Winter")
    assert rec["season"] == "Winter"
    winter = {f"s{i}" for i in range(12) if i % 2}
    flagged = [r for r in rec["results"] if r.get("in_season")]
    assert flagged and all(r["product_id"] in winter for r in flagged)
    # auto: resolves the stored session season (Winter)
    auto = ctx.recommend_for_user("u1", top_k=6, season="auto")
    assert auto["season"] == "Winter"
    assert ctx.store.latest_session_season("u1") == "Winter"
    assert ctx.store.item_seasons(["s0", "s1"]) == {"s0": "Summer", "s1": "Winter"}
