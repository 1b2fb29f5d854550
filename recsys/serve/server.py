"""HTTP serving layer (stdlib, dependency-free).

Implements the reference's REST contract — both the live endpoints and the
designed-but-disabled ones SURVEY.md §2.1 lists as required capabilities —
on ``http.server.ThreadingHTTPServer`` (FastAPI is not in the image; the
contract, not the framework, is the capability):

  GET  /                                        health + device report
  POST /api/controller/products/ingest          upsert products (`controller.py:27-57`)
  GET  /api/controller/similarity/{item_id}     cosine top-50 (`controller.py:61-124`)
  POST /api/v1/debug/insert-manual-data         seed users/sessions (`controller.py:190-271`)
  POST /ai-api/serving/train/item-tower         synchronous stage-1 train (`serving_controller.py:53-62`)
  POST /ai-api/serving/train/start              background train (`:403-418`)
  POST /ai-api/serving/train/user-tower         stage-2 train from sessions (`:496-618`)
  POST /ai-api/serving/bg/inference/refresh-item-vectors  (`:138-180`)
  POST /ai-api/serving/vectors/process-pending  one idempotent batch (`:422-454`)
  POST /ai-api/serving/vectors/process-by-ids   on-demand (`:459-482`)

User-side symmetry (the reference declares `user_profiles.user_service_vector`
+ a not-vectorized partial index, `database.py:152-173`, but ships no flow
that populates or queries it — these close that loop with the same
process-pending / refresh / query contract as products):

  POST /ai-api/serving/users/process-pending            one batch of stale users
  POST /ai-api/serving/bg/inference/refresh-user-vectors  full regeneration
  GET  /api/controller/recommendations/{user_id}        top-k for a user vector

The hourly Airflow DAG's loop-until-drained contract is preserved:
``process-pending`` returns ``processed_count`` and the caller loops while
it is > 0 (`airflow/dags/product_pipeline_dag.py:81-83`).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from recsys.serve.app import AppContext


def _routes(ctx: AppContext):
    def health(body, params):
        from recsys.runtime import device_info

        stats = getattr(ctx.vectorize_fn, "stats", None)
        return {"status": "ok", **device_info(),
                "index_size": len(ctx.index),
                "pending": ctx.store.pending_count(),
                "batcher": stats() if callable(stats) else None}

    def ingest(body, params):
        products = body.get("products", body if isinstance(body, list) else [])
        return ctx.store.ingest_products(products)

    def similarity(body, params):
        return ctx.similar_items(params["item_id"],
                                 int(params.get("top_k", 0)) or None)

    def insert_manual(body, params):
        return ctx.store.insert_manual_data(body.get("users", []),
                                            body.get("sessions", []))

    def train_item(body, params):
        if ctx.train_item_fn is None:
            return {"error": "no item trainer configured"}
        return ctx.train_item_fn(**(body or {}))

    def train_start(body, params):
        if ctx.train_item_fn is None:
            return {"error": "no item trainer configured"}
        tag = ctx.start_background(lambda: ctx.train_item_fn(**(body or {})))
        return {"started": True, "task": tag}

    def train_user(body, params):
        if ctx.train_user_fn is None:
            return {"error": "no user trainer configured"}
        return ctx.train_user_fn(**(body or {}))

    def refresh(body, params):
        return ctx.refresh_item_vectors(body.get("artifact_path"))

    def process_pending(body, params):
        return ctx.process_pending(body.get("batch_size"))

    def process_by_ids(body, params):
        return ctx.process_by_ids([str(p) for p in body.get("product_ids", [])])

    def process_pending_users(body, params):
        return ctx.process_pending_users(body.get("batch_size"))

    def refresh_users(body, params):
        return ctx.refresh_user_vectors()

    def recommendations(body, params):
        return ctx.recommend_for_user(
            params["user_id"], int(params.get("top_k", 0)) or None,
            exclude_seen=params.get("exclude_seen", "1") not in ("0", "false"),
            season=params.get("season") or None,
            mode=params.get("mode") or None)

    return [
        ("GET", re.compile(r"^/$"), health),
        ("POST", re.compile(r"^/api/controller/products/ingest$"), ingest),
        ("GET", re.compile(r"^/api/controller/similarity/(?P<item_id>[^/]+)$"),
         similarity),
        ("POST", re.compile(r"^/api/v1/debug/insert-manual-data$"), insert_manual),
        ("POST", re.compile(r"^/ai-api/serving/train/item-tower$"), train_item),
        ("POST", re.compile(r"^/ai-api/serving/train/start$"), train_start),
        ("POST", re.compile(r"^/ai-api/serving/train/user-tower$"), train_user),
        ("POST", re.compile(r"^/ai-api/serving/bg/inference/refresh-item-vectors$"),
         refresh),
        ("POST", re.compile(r"^/ai-api/serving/vectors/process-pending$"),
         process_pending),
        ("POST", re.compile(r"^/ai-api/serving/vectors/process-by-ids$"),
         process_by_ids),
        ("POST", re.compile(r"^/ai-api/serving/users/process-pending$"),
         process_pending_users),
        ("POST", re.compile(r"^/ai-api/serving/bg/inference/refresh-user-vectors$"),
         refresh_users),
        ("GET", re.compile(r"^/api/controller/recommendations/(?P<user_id>[^/]+)$"),
         recommendations),
    ]


def make_server(ctx: AppContext, host: str | None = None,
                port: int | None = None) -> ThreadingHTTPServer:
    routes = _routes(ctx)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _dispatch(self, method):
            from urllib.parse import parse_qsl, urlparse
            parsed = urlparse(self.path)
            params = dict(parse_qsl(parsed.query))
            body = {}
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._reply(400, {"error": "invalid json"})
                    return
            for m, pattern, fn in routes:
                if m != method:
                    continue
                match = pattern.match(parsed.path)
                if match:
                    params.update(match.groupdict())
                    try:
                        self._reply(200, fn(body, params))
                    except Exception as e:  # noqa: BLE001 — route errors -> 500
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
            self._reply(404, {"error": f"no route {method} {parsed.path}"})

        def _reply(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    server = ThreadingHTTPServer(
        (host or ctx.cfg.serve.host, port if port is not None else ctx.cfg.serve.port),
        Handler)
    return server


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
