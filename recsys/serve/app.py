"""Serving application context: DI singletons + the vectorization flows.

The reference wires global model singletons through FastAPI dependencies
(`utils/dependencies.py:42-94`) and implements the vectorize flows across
`utils/inference_utils.py` and the (dead) batch endpoints of
`APIController/serving_controller.py`. Here it's one ``AppContext`` object:

  * ``vectorize_fn``     — items -> (B, 128) vectors. The real one tokenizes
    + runs the item-tower encoder on the device; a deterministic hash vectorizer is
    the injectable test/fallback backend (mirroring the reference's
    random-init-fallback-as-fake-backend pattern, SURVEY.md §4.4).
  * ``process_pending``  — one idempotent batch of not-yet-vectorized
    products: vectorize, upsert vectors, flip flags, update the ANN index
    (the reference's loop-until-drained contract returns processed_count; a
    caller — the hourly pipeline — loops).
  * ``refresh_item_vectors`` — full-corpus regeneration + artifact save +
    index rebuild (`serving_controller.py:138-180`).
  * ``similar_items``    — cosine top-k via the native index
    (`APIController/controller.py:61-124`).
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from recsys.config import Config
from recsys.serve.ann import VectorIndex
from recsys.serve.store import ServeStore, TrainingItem
from recsys.train.checkpoint import save_array_with_ids


def pid_to_int(pid: str) -> int:
    """Stable 63-bit id for the native index (store keys are strings)."""
    return int(hashlib.md5(pid.encode()).hexdigest()[:15], 16)


def hash_vectorizer(dim: int = 128) -> Callable[[list[TrainingItem]], np.ndarray]:
    """Deterministic non-learned embedding: feature tokens hashed into a
    bag-of-features vector, L2-normalized. Similar feature payloads land
    near each other; good enough for serving-layer tests and cold starts."""

    def fn(items: list[TrainingItem]) -> np.ndarray:
        out = np.zeros((len(items), dim), np.float32)
        for r, it in enumerate(items):
            tokens = [it.product_name or ""]
            def walk(v, prefix=""):
                if isinstance(v, dict):
                    for k, vv in sorted(v.items()):
                        walk(vv, f"{prefix}{k}.")
                elif isinstance(v, (list, tuple)):
                    for vv in v:
                        walk(vv, prefix)
                elif v is not None:
                    tokens.append(f"{prefix}{v}")
            walk(it.feature_data)
            for t in tokens:
                h = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
                out[r, h % dim] += 1.0 if (h >> 16) % 2 else -1.0
            n = np.linalg.norm(out[r])
            if n > 0:
                out[r] /= n
        return out

    return fn


def _bucket(n: int, lo: int = 8) -> int:
    """Round a ragged serving batch up to a power-of-2 bucket so the jitted
    encoder compiles once per bucket instead of once per request size."""
    b = lo
    while b < n:
        b *= 2
    return b


def model_vectorizer(cfg: Config, params) -> Callable[[list[TrainingItem]], np.ndarray]:
    """The real encoder-backed vectorizer: DB rows -> item tensors -> device
    batch inference (the live path of `generate_and_save_item_vectors`).
    Inputs are padded to power-of-2 buckets (ragged request sizes would
    otherwise trigger one XLA compile per distinct size)."""
    import jax
    import pandas as pd

    from recsys.data.dataset import slice_item_batch, tokenize_items
    from recsys.data.vocab import StdVocab
    from recsys.models.item_tower import SimCSEModel
    from recsys.train.simcse import build_model

    vocab = StdVocab()
    model = build_model(cfg, vocab.size, vocab.num_fields)

    @jax.jit
    def encode(p, std, re_ids, re_mask, txt_ids, txt_mask):
        return model.apply({"params": p}, std, re_ids, re_mask, txt_ids,
                           txt_mask, method=SimCSEModel.encode)

    def fn(items: list[TrainingItem]) -> np.ndarray:
        rows = []
        for it in items:
            row = {"item_id": it.product_id, "product_name": it.product_name}
            fd = dict(it.feature_data)
            row["reinforced_feature"] = fd.pop("reinforced_feature", fd.pop(
                "reinforced_feature_value", {}))
            row.update({k: v for k, v in fd.items() if np.isscalar(v) or v is None})
            rows.append(row)
        tensors = tokenize_items(pd.DataFrame(rows), vocab, cfg.vocab)
        b = slice_item_batch(tensors, np.arange(len(rows)))
        n = len(rows)
        pad = _bucket(n) - n
        if pad:
            b = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                 for k, v in b.items()}
        out = np.asarray(encode(params, b["std"], b["re_ids"], b["re_mask"],
                                b["txt_ids"], b["txt_mask"]))[:n]
        # tokenize_items sorts by id; restore the caller's order
        order = {pid: i for i, pid in enumerate(tensors["item_ids"])}
        idx = [order[it.product_id] for it in items]
        return out[idx]

    return fn


def history_user_vectorizer(ctx: "AppContext", half_life_s: float = 7 * 86400.0):
    """Default user-vector backend: action-weighted, recency-decayed mean of
    the user's interacted item vectors, L2-normalized.

    Action weights follow the reference's `ActionType` ordinals
    (CLICK=1, CART=3, PURCHASE=5, `database.py:47-55`); recency decay is an
    exponential half-life relative to the user's LATEST event (not wall
    clock, so a dormant user keeps a meaningful vector instead of an
    underflowed zero).  A model-backed variant (the trained user tower)
    plugs in via ``AppContext.user_vectorize_fn`` — same signature, same
    flows.
    """

    def fn(profiles: list[dict]) -> np.ndarray:
        dim = ctx.cfg.item_tower.dim
        ids = [p["user_id"] for p in profiles]
        hists = ctx.store.user_histories(ids)
        out = np.zeros((len(profiles), dim), np.float32)
        for r, uid in enumerate(ids):
            acc = np.zeros(dim, np.float32)
            events = hists.get(uid, [])
            t_last = max((e["ts"] for e in events), default=0.0)
            for e in events:
                ivec = ctx.store.get_vector(str(e["product_id"]))
                if ivec is None or ivec.shape[0] != dim:
                    continue
                w = float(e["action_type"]) * 0.5 ** ((t_last - e["ts"]) / half_life_s)
                acc += w * ivec
            n = np.linalg.norm(acc)
            out[r] = acc / n if n > 0 else acc
        return out

    return fn


def tower_user_vectorizer(ctx: "AppContext", cfg: Config, params,
                          item_ids: list[str], side: np.ndarray | None = None):
    """Model-backed user vectorizer: store histories -> left-padded id
    sequences -> the trained SASRec user tower's eval forward (last-step
    vector).  The serving twin of the offline eval encoder path — exactly
    `make_stage2_step`'s ``user_vectors`` jit on serve-built batches.

    ``item_ids`` is the stage-2 id map's row order (index 0 = PAD), i.e. the
    ``item_map.ids`` sidecar saved with the checkpoint.  Static user features
    are unavailable at serve time and enter as zeros — the tower's sigmoid
    static gates make that a graceful degradation, not a crash.
    """
    from recsys.data.dataset import TIME_BUCKET_EDGES
    from recsys.models.user_tower import SASRecItemTower, SASRecUserTower
    from recsys.train.sasrec import make_stage2_step

    utc = cfg.user_tower
    N = len(item_ids)
    models = (SASRecUserTower(utc, num_id_embeddings=N),
              SASRecItemTower(N, utc.d_model))
    if side is None:
        side = np.zeros((N, utc.num_side_fields), np.int32)
    _, user_vectors = make_stage2_step(cfg, models, side, np.zeros(N, np.float32))
    L = utc.max_len
    id_of = {str(p): i for i, p in enumerate(item_ids)}

    def fn(profiles: list[dict]) -> np.ndarray:
        ids = [p["user_id"] for p in profiles]
        hists = ctx.store.user_histories(ids)
        B = _bucket(len(profiles))  # pad to a compile bucket
        batch = {
            "input_ids": np.zeros((B, L), np.int32),
            "target_ids": np.zeros((B, L), np.int32),
            "time_buckets": np.zeros((B, L), np.int32),
            "seq_mask": np.zeros((B, L), np.int32),
            "user_buckets": np.zeros((B, utc.static_bucket_fields), np.int32),
            "user_cats": np.zeros((B, utc.static_cat_fields), np.int32),
            "user_cont": np.zeros((B, utc.static_cont_fields), np.float32),
        }
        for r, uid in enumerate(ids):
            events = [e for e in hists.get(uid, [])
                      if str(e["product_id"]) in id_of][-L:]
            if not events:
                continue
            k = len(events)
            # left padding: latest event last (`v1_refine_usertower.py:241-250`)
            batch["input_ids"][r, L - k:] = [id_of[str(e["product_id"])]
                                             for e in events]
            last_ts = events[-1]["ts"]
            days = np.array([(last_ts - e["ts"]) / 86400.0 for e in events])
            batch["time_buckets"][r, L - k:] = np.digitize(
                days, TIME_BUCKET_EDGES[1:])
            batch["seq_mask"][r, L - k:] = 1
        return np.asarray(user_vectors(params, batch))[: len(profiles)]

    return fn


def hybrid_user_vectorizer(ctx: "AppContext", cfg: Config, params, uv_fn,
                           item_ids: list[str],
                           gnn_user_of: dict[str, np.ndarray] | None = None,
                           gnn_dim: int = 64):
    """Hybrid-tower user vectorizer: store histories -> left-padded
    sequences + the user's GNN embedding (artifact lookup; zeros for
    unseen users — the tower's gates degrade that gracefully, exactly the
    reference's zeroed-GNN-signal behavior `mined_inference.py:672-681`).

    The serving twin of `train/hybrid.make_hybrid_step`'s ``user_vectors``
    jit — the backend the measured-best recipe (28.81%@100 with hybrid
    pools) retrieves with. ``item_ids`` is the stage-2 id-map row order
    (index 0 = PAD); ``uv_fn``/``params`` come from `hybrid.restore_hybrid`.
    """
    from recsys.data.dataset import TIME_BUCKET_EDGES

    utc = cfg.user_tower
    L = utc.max_len
    id_of = {str(p): i for i, p in enumerate(item_ids)}
    gnn_user_of = gnn_user_of or {}

    def fn(profiles: list[dict]) -> np.ndarray:
        import jax.numpy as jnp

        ids = [p["user_id"] for p in profiles]
        hists = ctx.store.user_histories(ids)
        B = _bucket(len(profiles))
        batch = {
            "input_ids": np.zeros((B, L), np.int32),
            "target_ids": np.zeros((B, L), np.int32),
            "time_buckets": np.zeros((B, L), np.int32),
            "seq_mask": np.zeros((B, L), np.int32),
            "user_buckets": np.zeros((B, utc.static_bucket_fields), np.int32),
            "user_cats": np.zeros((B, utc.static_cat_fields), np.int32),
            "user_cont": np.zeros((B, utc.static_cont_fields), np.float32),
        }
        gnn_u = np.zeros((B, gnn_dim), np.float32)
        for r, uid in enumerate(ids):
            gv = gnn_user_of.get(str(uid))
            if gv is not None:
                gnn_u[r] = gv
            events = [e for e in hists.get(uid, [])
                      if str(e["product_id"]) in id_of][-L:]
            if not events:
                continue
            k = len(events)
            batch["input_ids"][r, L - k:] = [id_of[str(e["product_id"])]
                                             for e in events]
            last_ts = events[-1]["ts"]
            days = np.array([(last_ts - e["ts"]) / 86400.0 for e in events])
            batch["time_buckets"][r, L - k:] = np.digitize(
                days, TIME_BUCKET_EDGES[1:])
            batch["seq_mask"][r, L - k:] = 1
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        return np.asarray(uv_fn(params, b, jnp.asarray(gnn_u)))[: len(profiles)]

    return fn


@dataclass
class AppContext:
    cfg: Config
    store: ServeStore
    index: VectorIndex
    vectorize_fn: Callable[[list[TrainingItem]], np.ndarray]
    user_vectorize_fn: Callable[[list[dict]], np.ndarray] | None = None
    train_item_fn: Callable[..., dict] | None = None
    train_user_fn: Callable[..., dict] | None = None
    rec_assets: object | None = None  # serve/recommend.RecommendAssets
    int_to_pid: dict[int, str] = field(default_factory=dict)
    _bg_threads: list = field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return self.cfg.serve.batch_size

    def _index_add(self, ids: list[str], vecs: np.ndarray) -> None:
        ints = [pid_to_int(p) for p in ids]
        self.int_to_pid.update(dict(zip(ints, ids)))
        self.index.add(ints, vecs)

    # -- flows ------------------------------------------------------------
    def process_pending(self, batch_size: int | None = None,
                        table: str = "inference") -> dict:
        bs = batch_size or self.batch_size
        items = self.store.pending_products(bs, table)
        if not items:
            return {"processed_count": 0, "remaining": 0}
        vecs = self.vectorize_fn(items)
        ids = [it.product_id for it in items]
        self.store.save_vectors(ids, vecs, table)
        self._index_add(ids, vecs)
        return {"processed_count": len(ids),
                "remaining": self.store.pending_count(table)}

    def process_by_ids(self, product_ids: list[str], table: str = "inference") -> dict:
        items = self.store.products_by_ids(product_ids, table)
        if not items:
            return {"processed_count": 0, "missing": product_ids}
        vecs = self.vectorize_fn(items)
        ids = [it.product_id for it in items]
        self.store.save_vectors(ids, vecs, table)
        self._index_add(ids, vecs)
        found = set(ids)
        return {"processed_count": len(ids),
                "missing": [p for p in product_ids if p not in found]}

    def refresh_item_vectors(self, artifact_path: str | None = None,
                             table: str = "inference") -> dict:
        items = self.store.all_products(table)
        if not items:
            return {"count": 0}
        all_ids, chunks = [], []
        bs = self.batch_size * self.cfg.serve.fast_mode_multiplier
        for s in range(0, len(items), bs):
            chunk = items[s:s + bs]
            chunks.append(self.vectorize_fn(chunk))
            all_ids.extend(it.product_id for it in chunk)
        vecs = np.concatenate(chunks)
        self.store.save_vectors(all_ids, vecs, table)
        self._index_add(all_ids, vecs)
        if artifact_path:
            os.makedirs(os.path.dirname(artifact_path) or ".", exist_ok=True)
            full = np.concatenate([np.zeros((1, vecs.shape[1]), np.float32), vecs])
            save_array_with_ids(artifact_path, full, all_ids,
                                meta={"source": "refresh_item_vectors"})
        return {"count": len(all_ids)}

    # -- user-vector symmetry (reference stores `user_service_vector` but
    # has no populating flow, `database.py:152-173`; these mirror the
    # product vectorize contract exactly) ---------------------------------
    def _user_vectorize(self, profiles: list[dict]) -> np.ndarray:
        fn = self.user_vectorize_fn or history_user_vectorizer(self)
        return fn(profiles)

    def process_pending_users(self, batch_size: int | None = None) -> dict:
        profiles = self.store.pending_users(batch_size or self.batch_size)
        if not profiles:
            return {"processed_count": 0, "remaining": 0}
        vecs = self._user_vectorize(profiles)
        ids = [p["user_id"] for p in profiles]
        self.store.save_user_vectors(ids, vecs)
        return {"processed_count": len(ids),
                "remaining": self.store.user_pending_count()}

    def refresh_user_vectors(self) -> dict:
        profiles = self.store.all_user_profiles()
        if not profiles:
            return {"count": 0}
        vecs = self._user_vectorize(profiles)
        self.store.save_user_vectors([p["user_id"] for p in profiles], vecs)
        return {"count": len(profiles)}

    def recommend_for_user(self, user_id: str, top_k: int | None = None,
                           exclude_seen: bool = True,
                           season: str | None = None,
                           mode: str | None = None) -> dict:
        """Top-k recommendations for a user, in the configured serving
        mode (``serve.mode``; the ``mode`` argument / ``?mode=`` query
        overrides per request):

        * ``cosine`` — ANN top-k over the index, optionally season-aware
          (+serve.season_bonus re-rank on matching enriched micro-season;
          ``season="auto"`` reads the user's latest session season — the
          reference stores ``UserSession.season``, `database.py:185`, but
          never consumes it).
        * ``blend`` / ``rerank`` — the measured-best production recipes
          (serve/recommend.py); these INCLUDE seen items by design (the
          seen-item signal is where the measured lift comes from), so
          ``exclude_seen`` only applies to cosine mode. They need the
          offline campaign's assets (``rec_assets``) and fall back to
          cosine — flagged in the response — when those are absent."""
        mode = mode or self.cfg.serve.mode
        if mode in ("blend", "rerank"):
            out = self._recommend_recipe(user_id, mode, top_k)
            if out is not None:
                return out
            fallback = {"requested_mode": mode, "mode": "cosine",
                        "fallback": "no serving assets loaded"}
        else:
            fallback = {}
        vec = self.store.get_user_vector(user_id)
        if vec is None:
            return {"error": f"no vector for user {user_id}", "results": []}
        if season == "auto":
            season = self.store.latest_session_season(user_id)
        seen = set()
        if exclude_seen:
            hist = self.store.user_histories([user_id]).get(user_id, [])
            seen = {str(e["product_id"]) for e in hist}
        want = top_k or self.cfg.serve.similarity_top_k
        k = want + len(seen) + (want if season else 0)  # season re-rank margin
        ids, scores = self.index.topk(vec[None], k)
        results = []
        for i, s in zip(ids[0].tolist(), scores[0].tolist()):
            pid = self.int_to_pid.get(i)
            if pid is None or pid in seen:
                continue
            results.append({"product_id": pid, "score": round(float(s), 6)})
        if season:
            item_sea = self.store.item_seasons([r["product_id"] for r in results])
            bonus = self.cfg.serve.season_bonus
            for r in results:
                if item_sea.get(r["product_id"]) == season:
                    r["score"] = round(r["score"] + bonus, 6)
                    r["in_season"] = True
            results.sort(key=lambda r: -r["score"])
        out = {"user_id": user_id, "results": results[:want]}
        if season:
            out["season"] = season
        out.update(fallback)
        return out

    def _recommend_recipe(self, user_id: str, mode: str,
                          top_k: int | None) -> dict | None:
        """Blend / rerank serving via the offline pipeline's own scoring
        functions (serve/recommend.py). Returns None when the assets (or
        the rerank ranker) are missing so the caller can fall back."""
        assets = self.rec_assets
        if assets is None or (mode == "rerank" and assets.ranker is None):
            return None
        from recsys.serve import recommend as RC

        vec = self.store.get_user_vector(user_id)
        if vec is None:
            return {"error": f"no vector for user {user_id}", "results": []}
        k = top_k or self.cfg.serve.similarity_top_k
        events = self.store.user_histories([user_id]).get(user_id, [])
        iidx, days = RC.store_events_arrays(assets, events)
        if mode == "blend":
            sc = self.cfg.serve
            idx = RC.blend_topk(assets, vec[None], [iidx],
                                sc.blend_alpha, sc.blend_beta, k,
                                backend=sc.blend_backend)
        else:
            sc = self.cfg.serve
            now_day = int(days.max()) + 1 if len(days) else 0
            idx = RC.rerank_serve_topk(
                assets, vec[None], [(iidx, days)], now_day, k,
                pool_size=sc.rerank_pool, m_cos=sc.rerank_m_cos,
                m_pop=sc.rerank_m_pop)
        results = [{"product_id": assets.pid_of(int(r)), "rank": j + 1}
                   for j, r in enumerate(idx[0]) if int(r) != 0]
        return {"user_id": user_id, "mode": mode,
                "vectors": assets.vectors, "results": results}

    def similar_items(self, item_id: str, top_k: int | None = None) -> dict:
        vec = self.store.get_vector(item_id)
        if vec is None:
            return {"error": f"no vector for {item_id}", "results": []}
        k = (top_k or self.cfg.serve.similarity_top_k) + 1
        ids, scores = self.index.topk(vec[None], k)
        results = []
        for i, s in zip(ids[0].tolist(), scores[0].tolist()):
            pid = self.int_to_pid.get(i)
            if pid is None or pid == item_id:
                continue
            results.append({"product_id": pid, "score": round(float(s), 6)})
        return {"query": item_id, "results": results[: k - 1]}

    def start_background(self, fn, *args) -> str:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._bg_threads.append(t)
        return f"bg-{len(self._bg_threads)}"


def build_app_context(cfg: Config, vectorizer: Callable | None = None) -> AppContext:
    store = ServeStore(cfg.serve.db_path if cfg.serve.db_path == ":memory:"
                       else _ensure_dir(cfg.serve.db_path))
    if cfg.serve.ann_backend == "hnsw":
        from recsys.serve.ann import HnswIndex

        index = HnswIndex(cfg.item_tower.dim, m=cfg.serve.hnsw_m,
                          ef_construction=cfg.serve.hnsw_ef_construction,
                          ef_search=cfg.serve.hnsw_ef_search)
    elif cfg.serve.ann_backend == "ivf":
        from recsys.serve.ann import IvfIndex

        index = IvfIndex(cfg.item_tower.dim,
                            nlist=cfg.serve.ivf_nlist or None,
                            nprobe=cfg.serve.ivf_nprobe)
    elif cfg.serve.ann_backend == "int8":
        from recsys.serve.ann import Int8Index

        index = Int8Index(cfg.item_tower.dim, cosine=True)
    else:
        index = VectorIndex(cfg.item_tower.dim, cosine=True)
    vec_fn = vectorizer or hash_vectorizer(cfg.item_tower.dim)
    if cfg.serve.batch_window_ms > 0:
        from recsys.serve.batcher import DynamicBatcher

        vec_fn = DynamicBatcher(vec_fn, max_batch=cfg.serve.max_dynamic_batch,
                                max_wait_ms=cfg.serve.batch_window_ms)
    ctx = AppContext(cfg, store, index, vec_fn)
    # warm the index from any vectors already in the store
    ids, vecs = store.all_vectors()
    if len(ids):
        ctx._index_add(ids, vecs)
    return ctx


def _ensure_dir(path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path
