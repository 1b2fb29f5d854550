"""Serving modes: the measured-best recipes (blend / rerank) through the
HTTP path must produce EXACTLY the offline eval pipeline's lists
(VERDICT r3 item 1 — `recommend_for_user` now ships what the campaign
measured, `serve/recommend.py`)."""

import json
import urllib.request

import numpy as np
import pytest

from recsys.config import Config, ServeConfig
from recsys.eval import rerank_eval as R
from recsys.eval.baselines import popularity_ranking
from recsys.serve.app import build_app_context
from recsys.serve.recommend import (RecommendAssets, blend_topk,
                                        rerank_serve_topk,
                                        store_events_arrays)
from recsys.serve.server import make_server, serve_forever_in_thread
from recsys.serve.store import ActionType
from recsys.train.reranker import GBDTRanker

N, D = 60, 16


def _assets(rng, with_ranker=True):
    ids = [f"p{i}" for i in range(N)]
    mat = rng.normal(size=(N + 1, D)).astype(np.float32)
    mat[0] = 0
    mat /= np.clip(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12, None)
    q = rng.dirichlet(np.ones(N))
    logq = np.concatenate([[-20.0], np.log(q)]).astype(np.float32)
    price = np.concatenate([[0.0], rng.uniform(0, 3, N)]).astype(np.float32)
    ranker = None
    if with_ranker:
        X = rng.normal(size=(400, R.NUM_FEATURES)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 4] + rng.normal(size=400) > 0).astype(np.float32)
        ranker = GBDTRanker(iterations=20).fit(X, y)
    return RecommendAssets(ids, mat, logq, price, ranker)


def _ctx_with_user(assets, mode):
    from recsys.config import ItemTowerConfig

    # item_tower.dim drives both the store's vector dim and the user
    # vectorizer's output dim — must match the assets' matrix dim
    cfg = Config(item_tower=ItemTowerConfig(dim=D),
                 serve=ServeConfig(db_path=":memory:", mode=mode))
    ctx = build_app_context(cfg)
    ctx.rec_assets = assets
    products = [{"product_id": p, "product_name": f"item {p}",
                 "feature_data": {"reinforced_feature": {"CAT": ["shirt"]}}}
                for p in assets.item_ids]
    ctx.store.ingest_products(products)
    while ctx.process_pending()["processed_count"]:
        pass
    # user u1: purchases on known days (ts = day * 86400)
    events = [{"product_id": f"p{i}", "action_type": int(ActionType.PURCHASE),
               "ts": day * 86400.0}
              for i, day in [(3, 10), (3, 40), (7, 25), (12, 55), (20, 55)]]
    r = ctx.store.insert_manual_data([{"user_id": "u1"}],
                                     [{"user_id": "u1", "events": events}])
    assert r["ok"]
    assert ctx.refresh_user_vectors()["count"] == 1
    return ctx


def _http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def served():
    """One server, rerank-mode default, shared across the module's tests."""
    rng = np.random.default_rng(7)
    assets = _assets(rng)
    ctx = _ctx_with_user(assets, mode="rerank")
    server = make_server(ctx, port=0)
    serve_forever_in_thread(server)
    yield ctx, assets, server.server_address[1]
    server.shutdown()


def test_rerank_mode_matches_offline_pipeline(served):
    """The HTTP rerank list == the offline `cmd_rerank_eval` recipe's list,
    computed here via the SAME eval/rerank_eval functions the campaign
    eval calls (cosine_topm -> build_pools -> pool_features ->
    rerank_topk) on the store's user vector and events."""
    ctx, assets, port = served
    got = _http_get(port, "/api/controller/recommendations/u1?mode=rerank&top_k=10")
    assert got["mode"] == "rerank"
    served_ids = [r["product_id"] for r in got["results"]]
    assert len(served_ids) == 10

    # offline pipeline, exactly as cmd_rerank_eval.side_of does it
    uv = ctx.store.get_user_vector("u1")[None]
    events = ctx.store.user_histories(["u1"])["u1"]
    iidx, days = store_events_arrays(assets, events)
    urow = np.zeros(len(iidx), np.int64)
    keys, counts, last = R.pair_index(urow, iidx, days, N + 1)
    cos_idx = R.cosine_topm(uv, assets.item_matrix, min(300, N - 1),
                            device=False)
    pop = popularity_ranking(assets.logq, min(100, N - 1))
    pools, flags = R.build_pools(cos_idx, [iidx], pop, 512)
    now_day = int(days.max()) + 1
    feats = R.pool_features(pools, flags, uv, assets.item_matrix, assets.logq,
                            keys, counts, last, now_day, N + 1,
                            assets.price_log,
                            hist_lens=np.array([len(iidx)]),
                            user_last_day=np.array([int(days.max())]))
    topk = R.rerank_topk(assets.ranker, feats, pools, 10)
    expect_ids = [assets.pid_of(int(r)) for r in topk[0] if int(r) != 0]
    assert served_ids == expect_ids

    # seen items are eligible (the recipe's whole point): the user's
    # repurchased p3 must be in the pool with is_seen features set
    p3 = assets.idx_of("p3")
    r3 = np.flatnonzero(pools[0] == p3)
    assert len(r3) == 1 and feats[0, r3[0], 4] == 1.0  # is_seen
    assert feats[0, r3[0], 2] == np.float32(np.log1p(2))  # count=2


def test_blend_mode_matches_documented_formula(served):
    """The HTTP blend list == an independent numpy implementation of the
    measured-best scoring ((1-a)*minmax_u(cos) + a*minmax(logq) + b*seen,
    `eval/baselines.blend_sweep` semantics, best combo a0.1_b1.0)."""
    ctx, assets, port = served
    got = _http_get(port, "/api/controller/recommendations/u1?mode=blend&top_k=15")
    assert got["mode"] == "blend"
    served_ids = [r["product_id"] for r in got["results"]]

    uv = ctx.store.get_user_vector("u1")
    events = ctx.store.user_histories(["u1"])["u1"]
    iidx, _ = store_events_arrays(assets, events)
    im = assets.item_matrix / np.clip(
        np.linalg.norm(assets.item_matrix, axis=1, keepdims=True), 1e-12, None)
    cos = im @ uv
    cos = (cos - cos.min()) / (cos.max() - cos.min())
    lq = assets.logq.astype(np.float64)
    popn = (lq - lq.min()) / (lq.max() - lq.min())
    seen = np.zeros(N + 1)
    seen[iidx] = 1.0
    s = 0.9 * cos + 0.1 * popn + 1.0 * seen
    s[0] = -np.inf
    expect = [assets.pid_of(int(r)) for r in np.argsort(-s)[:15]]
    assert served_ids == expect
    # all 4 seen items outrank everything (beta=1.0 dominates)
    assert set(expect[:4]) == {"p3", "p7", "p12", "p20"}


def test_mode_config_default_and_override(served):
    ctx, assets, port = served
    # server default mode is rerank (ServeConfig.mode)
    got = _http_get(port, "/api/controller/recommendations/u1?top_k=5")
    assert got["mode"] == "rerank"
    # per-request override back to plain cosine (no "mode" key in the
    # legacy-shaped response, seen excluded by default)
    got = _http_get(port, "/api/controller/recommendations/u1?mode=cosine&top_k=5")
    assert "mode" not in got
    assert "p3" not in [r["product_id"] for r in got["results"]]


def test_recipe_modes_fall_back_without_assets():
    rng = np.random.default_rng(1)
    assets = _assets(rng, with_ranker=False)
    ctx = _ctx_with_user(assets, mode="rerank")
    # no ranker asset -> rerank falls back to cosine, flagged
    out = ctx.recommend_for_user("u1", top_k=5)
    assert out["requested_mode"] == "rerank" and out["mode"] == "cosine"
    assert out["fallback"] and len(out["results"]) == 5
    # blend still works without a ranker
    out = ctx.recommend_for_user("u1", top_k=5, mode="blend")
    assert out["mode"] == "blend" and len(out["results"]) == 5
    # no assets at all -> blend falls back too
    ctx.rec_assets = None
    out = ctx.recommend_for_user("u1", top_k=5, mode="blend")
    assert out["mode"] == "cosine" and out["requested_mode"] == "blend"


def test_hybrid_user_vectorizer_builds_correct_batch():
    """Serving glue for the hybrid backend: left padding, time buckets,
    GNN-embedding lookup (zeros for unknown users), bucket padding."""
    from recsys.serve.app import hybrid_user_vectorizer

    rng = np.random.default_rng(2)
    assets = _assets(rng, with_ranker=False)
    ctx = _ctx_with_user(assets, mode="cosine")
    cfg = ctx.cfg
    captured = {}

    def uv_stub(params, batch, gnn_user):
        captured["batch"] = {k: np.asarray(v) for k, v in batch.items()}
        captured["gnn"] = np.asarray(gnn_user)
        return np.ones((batch["input_ids"].shape[0], 8), np.float32)

    gnn_user_of = {"u1": np.full(4, 0.5, np.float32)}
    fn = hybrid_user_vectorizer(ctx, cfg, {}, uv_stub,
                                ["<pad>"] + assets.item_ids, gnn_user_of,
                                gnn_dim=4)
    out = fn([{"user_id": "u1"}, {"user_id": "nobody"}])
    assert out.shape == (2, 8)
    b = captured["batch"]
    L = cfg.user_tower.max_len
    assert b["input_ids"].shape[0] == 8  # power-of-2 compile bucket
    # u1 has 5 events, left-padded: last 5 positions, latest last
    row = b["input_ids"][0]
    assert (row[: L - 5] == 0).all() and (row[L - 5:] > 0).all()
    assert row[L - 1] in (assets.idx_of("p12"), assets.idx_of("p20"))
    assert b["seq_mask"][0, L - 5:].all() and not b["seq_mask"][1].any()
    np.testing.assert_allclose(captured["gnn"][0], 0.5)
    np.testing.assert_allclose(captured["gnn"][1], 0.0)


def test_blend_and_rerank_helpers_shapes():
    rng = np.random.default_rng(3)
    assets = _assets(rng)
    uv = rng.normal(size=(3, D)).astype(np.float32)
    hists = [np.array([1, 2]), np.array([], np.int64), np.array([5])]
    idx = blend_topk(assets, uv, hists, 0.1, 1.0, 8)
    assert idx.shape == (3, 8) and (idx > 0).all()
    # seen items surface first under beta=1.0
    assert set(hists[0]) <= set(idx[0][:2].tolist())
    ev = [(np.array([1, 2]), np.array([10, 20])),
          (np.empty(0, np.int64), np.empty(0, np.int64)),
          (np.array([5]), np.array([30]))]
    top = rerank_serve_topk(assets, uv, ev, now_day=31, k=8, pool_size=32,
                            m_cos=10, m_pop=5)
    assert top.shape == (3, 8)


def test_load_recommend_assets_roundtrip(tmp_path):
    """The cmd_serve asset loader: campaign artifacts -> RecommendAssets
    with correct row alignment, logq from item features, and the ranker."""
    import pandas as pd

    from recsys.config import Config, DataConfig
    from recsys.data.etl import logq_from_item_features
    from recsys.serve.recommend import load_recommend_assets
    from recsys.train.checkpoint import save_array_with_ids

    rng = np.random.default_rng(5)
    root = str(tmp_path)
    ids = [f"it{i:03d}" for i in range(10)]
    mat = rng.normal(size=(11, 4)).astype(np.float32)
    mat[0] = 0
    save_array_with_ids(f"{root}/eval_item_matrix", mat, ids)
    feats = pd.DataFrame({
        "item_id": ids,
        "raw_probability": np.linspace(0.01, 0.2, 10),
        "avg_item_price_log": np.linspace(1.0, 2.0, 10)})
    feats.to_parquet(f"{root}/features_item.parquet")
    X = rng.normal(size=(60, R.NUM_FEATURES)).astype(np.float32)
    GBDTRanker(iterations=5).fit(X, (X[:, 0] > 0).astype(np.float32)).save(
        f"{root}/rerank_gbdt_stage2.pkl")

    cfg = Config(data=DataConfig(root=root))
    a = load_recommend_assets(cfg, "stage2")
    assert a.item_ids == ids and a.item_matrix.shape == (11, 4)
    assert a.ranker is not None and a.vectors == "stage2"
    np.testing.assert_allclose(
        a.logq, logq_from_item_features(feats, ids))
    assert a.price_log[1] == np.float32(1.0) and a.price_log[10] == np.float32(2.0)
    assert a.idx_of("it003") == 4 and a.pid_of(4) == "it003"
    assert a.idx_of("nope") == 0 and a.pid_of(0) is None
    # hybrid variant requires its own matrix artifact
    with pytest.raises(FileNotFoundError):
        load_recommend_assets(cfg, "hybrid")


def test_blend_topk_host_vs_device_equality():
    """VERDICT r4 item 3: the fused device blend kernel must return the
    SAME list as the host numpy scoring (same normalize/minmax/seen/PAD
    semantics; HIGHEST-precision matmul keeps rankings aligned)."""
    rng = np.random.default_rng(7)
    assets = _assets(rng, with_ranker=False)
    uv = rng.normal(size=(4, D)).astype(np.float32)
    hists = [np.array([1, 2, 3]), np.array([], np.int64),
             np.array([5, 5, 9, 11, 2, 7, 30, 31, 32]), np.array([N])]
    for alpha, beta, k in ((0.1, 1.0, 8), (0.0, 0.0, 5), (0.9, 0.3, 16)):
        host = blend_topk(assets, uv, hists, alpha, beta, k, backend="host")
        dev = blend_topk(assets, uv, hists, alpha, beta, k, backend="device")
        np.testing.assert_array_equal(host, dev)


def test_blend_topk_cached_assets_match_fresh():
    """The request-invariant caches (items_norm/pop_norm/pop_ranking) must
    reproduce exactly what round 4 recomputed per request."""
    rng = np.random.default_rng(8)
    assets = _assets(rng, with_ranker=False)
    m = np.array(assets.item_matrix, np.float32)
    m /= np.clip(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12, None)
    np.testing.assert_allclose(assets.items_norm, m)
    lq = np.asarray(assets.logq, np.float64)
    pop = ((lq - lq.min()) / (lq.max() - lq.min())).astype(np.float32)
    np.testing.assert_allclose(assets.pop_norm, pop)
    from recsys.eval.baselines import popularity_ranking

    np.testing.assert_array_equal(assets.pop_ranking(10),
                                  popularity_ranking(assets.logq, 10))
    # second call returns the cached object, not a recompute
    assert assets.items_norm is assets.items_norm


def test_rerank_serve_topk_prenormalized_matches_r4_path():
    """The cached-asset rerank path (prenormalized matrix + cached pop
    ranking) must return the same list as scoring from raw artifacts."""
    rng = np.random.default_rng(9)
    assets = _assets(rng)
    uv = rng.normal(size=(2, D)).astype(np.float32)
    ev = [(np.array([1, 2]), np.array([10, 20])),
          (np.array([5]), np.array([30]))]
    top = rerank_serve_topk(assets, uv, ev, now_day=31, k=8, pool_size=32,
                            m_cos=10, m_pop=5)
    # r4 semantics, recomputed from raw artifacts without the caches
    from recsys.eval.baselines import popularity_ranking

    N1 = assets.item_matrix.shape[0]
    urow = np.concatenate([np.full(len(ii), r, np.int64)
                           for r, (ii, _) in enumerate(ev)])
    iidx = np.concatenate([ii for ii, _ in ev])
    days = np.concatenate([dd for _, dd in ev])
    keys, counts, last = R.pair_index(urow, iidx, days, N1)
    cos_idx = R.cosine_topm(uv, assets.item_matrix, 10, device=False)
    pop = popularity_ranking(assets.logq, 5)
    pools, flags = R.build_pools(cos_idx, [ii for ii, _ in ev], pop, 32)
    up = np.array([assets.price_log[[1, 2]].mean(),
                   assets.price_log[[5]].mean()], np.float32)
    feats = R.pool_features(pools, flags, uv, assets.item_matrix,
                            assets.logq, keys, counts, last, 31, N1,
                            assets.price_log,
                            hist_lens=np.array([2, 1], np.int64),
                            user_last_day=np.array([20, 30], np.int64),
                            user_price=up)
    expect = R.rerank_topk(assets.ranker, feats, pools, 8)
    np.testing.assert_array_equal(top, expect)


def test_pool_features_interaction_stats():
    """cos_raw / ui_max / ui_std / price_diff (round-5 feature set) match
    a direct per-pair computation."""
    rng = np.random.default_rng(11)
    N1, D, U, P = 30, 16, 3, 8
    im = rng.normal(size=(N1, D)).astype(np.float32)
    im[0] = 0
    uv = rng.normal(size=(U, D)).astype(np.float32)
    pools = rng.integers(1, N1, (U, P)).astype(np.int64)
    flags = np.ones((U, P), np.int8)
    logq = rng.normal(size=N1).astype(np.float32)
    price = rng.uniform(0, 3, N1).astype(np.float32)
    keys, counts, last = R.pair_index(
        np.array([0], np.int64), np.array([1], np.int64),
        np.array([5], np.int64), N1)
    up = rng.uniform(0, 3, U).astype(np.float32)
    feats = R.pool_features(pools, flags, uv, im, logq, keys, counts, last,
                            10, N1, price, user_price=up)
    imn = im / np.clip(np.linalg.norm(im, axis=-1, keepdims=True), 1e-12, None)
    uvn = uv / np.clip(np.linalg.norm(uv, axis=-1, keepdims=True), 1e-12, None)
    for u in range(U):
        for j in range(P):
            prod = imn[pools[u, j]] * uvn[u]
            assert abs(feats[u, j, 12] - prod.sum()) < 1e-4       # cos_raw
            assert abs(feats[u, j, 13] - prod.max()) < 1e-5       # ui_max
            assert abs(feats[u, j, 14] - prod.std()) < 1e-4       # ui_std
            assert abs(feats[u, j, 15]
                       - abs(price[pools[u, j]] - up[u])) < 1e-5  # price_diff
