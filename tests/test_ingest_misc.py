"""Streaming ingest, cross features, loggers, profiler hook."""

import json

import numpy as np

from recsys.data.ingest import ingest_transactions
from recsys.data.ranker_features import cross_features
from recsys.train.metrics import SmartLogger, maybe_wandb_writer


def test_streaming_json_ingest(tmp_path):
    path = tmp_path / "tx.jsonl"
    with open(path, "w") as f:
        for i in range(2500):
            f.write(json.dumps({"user_id": f"u{i % 7}", "item_id": f"i{i % 40}",
                                "day": i % 100, "price": 9.5, "channel": 1}) + "\n")
    out = str(tmp_path / "tx.parquet")
    r = ingest_transactions(str(path), out, day_min=10, day_max=59,
                            chunk_rows=300)
    assert r["scanned"] == 2500 and not r["cached"]
    assert r["rows"] == 2500 // 2  # half the days fall in [10, 59]
    import pandas as pd
    df = pd.read_parquet(out)
    assert df["day"].between(10, 59).all()
    assert df["price"].dtype == np.float32 and df["channel"].dtype == np.int8
    # cache hit on rerun
    assert ingest_transactions(str(path), out)["cached"]


def test_csv_ingest(tmp_path):
    path = tmp_path / "tx.csv"
    with open(path, "w") as f:
        f.write("user_id,item_id,day,price,channel\n")
        for i in range(10):
            f.write(f"u{i},i{i},{i},1.0,2\n")
    r = ingest_transactions(str(path), str(tmp_path / "o.parquet"))
    assert r["rows"] == 10


def test_cross_features():
    um = np.array([[10.0, 0, 0], [20.0, 0, 0]], np.float32)
    im = np.array([[0, 15.0], [0, 5.0]], np.float32)
    act = np.array([2.0, 3.0], np.float32)
    vel = np.array([0.5, -0.5], np.float32)
    x = cross_features(um, im, act, vel)
    np.testing.assert_allclose(x[:, 0], [5.0, -15.0])
    np.testing.assert_allclose(x[:, 1], [1.0, -1.5])


def test_loggers(capsys):
    log = SmartLogger(level=1)
    log.log("visible", 1)
    log.log("hidden", 2)
    out = capsys.readouterr().out
    assert "visible" in out and "hidden" not in out
    # wandb absent in the image -> graceful no-op sink
    sink = maybe_wandb_writer("proj", "run")
    sink(1, loss=0.5)


def test_meta_feature_importance_slices():
    from recsys.train.metrics import meta_feature_importance

    # kernel (in=6, out=4): rows 0-1 dominate -> their group gets the share
    k = np.zeros((6, 4), np.float32)
    k[0:2] = 3.0
    k[2:4] = 1.0
    imp = meta_feature_importance(k, {"a": slice(0, 2), "b": slice(2, 4),
                                      "c": slice(4, 6)})
    assert imp["a"] > imp["b"] > imp["c"]
    assert abs(sum(imp.values()) - 1.0) < 1e-5


def test_static_branch_importance_from_params():
    from recsys.config import UserTowerConfig
    from recsys.train.metrics import static_branch_importance

    c = UserTowerConfig(static_bucket_fields=2, static_cat_fields=1,
                        bucket_emb_dim=4, cat_emb_dim=2, cont_proj_dim=3)
    static_in = 2 * 4 + 1 * 2 + 3
    rng = np.random.default_rng(0)
    params = {"static_mlp": {"Dense_0": {
        "kernel": rng.normal(0, 0.1, (static_in, 8)).astype(np.float32)}}}
    imp = static_branch_importance(params, c)
    assert set(imp) == {"bucket0", "bucket1", "cat0", "cont"}
    assert abs(sum(imp.values()) - 1.0) < 1e-5
