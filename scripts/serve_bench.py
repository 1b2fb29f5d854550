"""Serving-mode latency/QPS bench at campaign scale (VERDICT r4 item 3).

Measures all three serving modes end-to-end through the REAL stack —
sqlite store reads -> user vector -> recipe scoring -> id mapping — at
the full catalog size of the given world, twice: direct
``recommend_for_user`` calls (the serving path minus socket framing) and
through actual HTTP against a ``make_server`` instance on localhost.

Modes benched: cosine (ANN index over the full catalog), blend host
(numpy full-catalog scan with cached normalized assets), blend device
(the fused jitted kernel, serve/recommend._blend_kernel_factory), and
rerank when the world carries a trained ranker
(``rerank_gbdt_stage2.pkl`` from rerank-eval).

The store is populated with a user sample carrying REAL history lengths
(features_sequence.parquet) and the full item catalog + vectors, so
store-read and seen-scatter costs are representative.

Usage:
  [JAX_PLATFORMS=cpu] python scripts/serve_bench.py <world_dir> <out_json> \
      [n_users] [n_requests]
"""

import dataclasses
import json
import sys
import threading
import time
import urllib.request

import numpy as np

from recsys.config import Config, DataConfig, ItemTowerConfig, ServeConfig


def _pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def _bench(fn, reqs, warmup=5):
    for r in reqs[:warmup]:
        fn(r)
    lat = []
    t0 = time.perf_counter()
    for r in reqs:
        s = time.perf_counter()
        fn(r)
        lat.append((time.perf_counter() - s) * 1e3)
    wall = time.perf_counter() - t0
    return {"n": len(reqs), "p50_ms": round(_pctl(lat, 50), 3),
            "p99_ms": round(_pctl(lat, 99), 3),
            "mean_ms": round(float(np.mean(lat)), 3),
            "qps": round(len(reqs) / wall, 1)}


def main():
    world = sys.argv[1]
    out_path = sys.argv[2]
    n_users = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    n_req = int(sys.argv[4]) if len(sys.argv) > 4 else 512

    import pandas as pd

    from recsys.serve.app import build_app_context
    from recsys.serve.recommend import load_recommend_assets

    cfg = Config(data=DataConfig(root=world),
                 item_tower=ItemTowerConfig(),
                 serve=ServeConfig(db_path=":memory:", mode="cosine",
                                   blend_backend="host"))
    # Latency depends on matrix SHAPE, not which tower produced it. When
    # the stage-2 eval export is absent (post-wipe world regenerated only
    # through vectorize), alias the stage-1 content matrix so the bench
    # still measures the full serving path — and label the provenance.
    import os
    import shutil

    item_vectors = "stage2_eval"
    if not os.path.exists(f"{world}/eval_item_matrix.npy") \
            and os.path.exists(f"{world}/item_matrix.npy"):
        for ext in (".npy", ".ids.json"):
            shutil.copyfile(f"{world}/item_matrix{ext}",
                            f"{world}/eval_item_matrix{ext}")
        item_vectors = "stage1_content_fallback"
        print("eval_item_matrix absent -> stage-1 content fallback",
              file=sys.stderr)
    assets = load_recommend_assets(cfg)
    print(f"assets: {len(assets.item_ids)} items, vectors={assets.vectors}, "
          f"ranker={'yes' if assets.ranker else 'no'}", file=sys.stderr)

    ctx = build_app_context(cfg)
    ctx.rec_assets = assets

    # full catalog into index + store (vectors injected directly — the
    # encoder path is vectorize's business, not this bench's)
    ids = assets.item_ids
    vecs = assets.items_norm[1:]
    ctx._index_add(ids, np.asarray(vecs, np.float32))
    ctx.store.ingest_products(
        [{"product_id": p, "product_name": p, "feature_data": {}}
         for p in ids])
    ctx.store.save_vectors(ids, np.asarray(vecs, np.float32))

    # user sample with real history lengths
    seqs = pd.read_parquet(f"{world}/features_sequence.parquet")
    # eval_uvecs covers target users only (~16% at shape) — oversample,
    # then cap at n_users below
    seqs = seqs.sample(n=min(n_users * 10, len(seqs)), random_state=0)
    from recsys.train.checkpoint import load_array_with_ids

    user_vectors = "stage2_eval"
    try:
        uv, uv_ids, _ = load_array_with_ids(f"{world}/eval_uvecs")
        uv_of = {str(u): uv[r] for r, u in enumerate(uv_ids)}
    except FileNotFoundError:
        # History-mean fallback (the training-free `history` user
        # backend): same vector dim, same store/scoring costs.
        user_vectors = "history_mean_fallback"
        print("eval_uvecs absent -> history-mean fallback", file=sys.stderr)
        id_row = {str(i): r for r, i in enumerate(assets.item_ids, start=1)}
        uv_of = {}
        for _, row in seqs.iterrows():
            rows = [id_row[str(p)] for p in row["sequence"]
                    if str(p) in id_row]
            if rows:
                v = assets.item_matrix[rows].mean(axis=0)
                n = np.linalg.norm(v)
                uv_of[str(row["user_id"])] = v / n if n > 0 else v
    users, sessions, uids = [], [], []
    rng = np.random.default_rng(0)
    for _, row in seqs.iterrows():
        u = str(row["user_id"])
        if u not in uv_of or len(uids) >= n_users:
            continue
        uids.append(u)
        users.append({"user_id": u})
        ev = [{"product_id": str(p), "action_type": 5,
               "ts": 86400.0 * (300 + j)}
              for j, p in enumerate(row["sequence"])]
        sessions.append({"user_id": u, "events": ev})
    res = ctx.store.insert_manual_data(users, sessions)
    assert res["ok"], res
    ctx.store.save_user_vectors(
        uids, np.asarray([uv_of[u] for u in uids], np.float32))
    print(f"store: {len(uids)} users, "
          f"mean hist {np.mean([len(s['events']) for s in sessions]):.1f}",
          file=sys.stderr)

    req_uids = [uids[i] for i in rng.integers(0, len(uids), n_req)]
    out = {"world": world, "n_items": len(ids), "n_users": len(uids),
           "n_requests": n_req, "item_vectors": item_vectors,
           "user_vectors": user_vectors, "direct": {}, "http": {}}

    modes = [("cosine", "cosine", "host"), ("blend_host", "blend", "host"),
             ("blend_device", "blend", "device")]
    if assets.ranker is not None:
        modes.append(("rerank", "rerank", "host"))
    for name, mode, backend in modes:
        ctx.cfg = dataclasses.replace(
            ctx.cfg, serve=dataclasses.replace(ctx.cfg.serve,
                                               blend_backend=backend))
        out["direct"][name] = _bench(
            lambda u, m=mode: ctx.recommend_for_user(u, top_k=50, mode=m),
            req_uids)
        print(f"direct {name}: {out['direct'][name]}", file=sys.stderr)

    # HTTP end-to-end (same context, real sockets)
    from recsys.serve.server import make_server

    srv = make_server(ctx, "127.0.0.1", 8199)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        for name, mode, backend in modes:
            ctx.cfg = dataclasses.replace(
                ctx.cfg, serve=dataclasses.replace(ctx.cfg.serve,
                                                   blend_backend=backend))

            def hit(u, m=mode):
                with urllib.request.urlopen(
                        "http://127.0.0.1:8199/api/controller/"
                        f"recommendations/{u}?top_k=50&mode={m}") as r:
                    json.loads(r.read())

            out["http"][name] = _bench(hit, req_uids)
            print(f"http {name}: {out['http'][name]}", file=sys.stderr)
    finally:
        srv.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("n_items", "direct", "http")}))


if __name__ == "__main__":
    main()
