"""Serving data store (sqlite3) — the L0 data-model layer.

Re-implements the reference's SQLAlchemy/Postgres schema (`database.py`) on
stdlib sqlite3 (no Postgres beside the trainer; vectors live in the native index,
see serve/ann.py, instead of pgvector):

  * ``product_inference_input``  — JSON feature payload + ``is_vectorized``
    flag with a partial index on pending rows (`database.py:58-76`);
  * ``product_inference_vectors`` — 128-d vectors (BLOB) (`:81-114`);
  * serving twins ``product_service_input/vectors`` (`:117-149`);
  * ``user_profiles`` / ``user_sessions`` / ``interaction_events``
    (`:152-226`) with the ``is_purchase_session`` semantics;
  * the ``TrainingItem`` DTO and ``Season`` / ``ActionType`` enums
    (`:40-55`).

The ``is_vectorized`` flag makes vectorization idempotent and resumable —
the vectors-as-checkpoint pattern (SURVEY.md §5).
"""

from __future__ import annotations

import enum
import json
import sqlite3
import threading
import time
from dataclasses import dataclass

import numpy as np


class Season(enum.Enum):
    SPRING_AUTUMN = "Spring/Autumn"
    SUMMER = "Summer"
    WINTER = "Winter"


class ActionType(enum.IntEnum):
    CLICK = 1
    CART = 3
    PURCHASE = 5


@dataclass
class TrainingItem:
    """The canonical train/infer record (reference `database.py:40-44`)."""

    product_id: str
    feature_data: dict
    product_name: str


_SCHEMA = """
CREATE TABLE IF NOT EXISTS product_inference_input (
  product_id TEXT PRIMARY KEY,
  feature_data TEXT NOT NULL,
  product_name TEXT,
  is_vectorized INTEGER NOT NULL DEFAULT 0,
  updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_pending
  ON product_inference_input (is_vectorized) WHERE is_vectorized = 0;
CREATE TABLE IF NOT EXISTS product_inference_vectors (
  product_id TEXT PRIMARY KEY,
  vector BLOB NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS product_service_input (
  product_id TEXT PRIMARY KEY,
  feature_data TEXT NOT NULL,
  product_name TEXT,
  is_vectorized INTEGER NOT NULL DEFAULT 0,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS product_service_vectors (
  product_id TEXT PRIMARY KEY,
  vector BLOB NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS user_profiles (
  user_id TEXT PRIMARY KEY,
  gender TEXT, age_group TEXT, style TEXT,
  user_service_vector BLOB,
  is_vectorized INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS user_sessions (
  session_id INTEGER PRIMARY KEY AUTOINCREMENT,
  user_id TEXT NOT NULL,
  season TEXT,
  started_at REAL NOT NULL,
  cart_context TEXT
);
CREATE TABLE IF NOT EXISTS interaction_events (
  event_id INTEGER PRIMARY KEY AUTOINCREMENT,
  session_id INTEGER NOT NULL,
  product_id TEXT NOT NULL,
  action_type INTEGER NOT NULL,
  ts REAL NOT NULL
);
"""


class ServeStore:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # -- products ---------------------------------------------------------
    def ingest_products(self, products: list[dict], table: str = "inference") -> dict:
        """Upsert product JSON; a changed payload resets ``is_vectorized``
        (reference `/products/ingest`, `APIController/controller.py:27-57`)."""
        tbl = f"product_{table}_input"
        created = updated = unchanged = 0
        with self._lock:
            for p in products:
                pid = str(p["product_id"])
                payload = json.dumps(p.get("feature_data", {}), sort_keys=True)
                name = p.get("product_name", "")
                row = self._conn.execute(
                    f"SELECT feature_data, product_name FROM {tbl} WHERE product_id=?",
                    (pid,)).fetchone()
                if row is None:
                    self._conn.execute(
                        f"INSERT INTO {tbl} VALUES (?,?,?,0,?)",
                        (pid, payload, name, time.time()))
                    created += 1
                elif row["feature_data"] != payload or row["product_name"] != name:
                    self._conn.execute(
                        f"UPDATE {tbl} SET feature_data=?, product_name=?, "
                        "is_vectorized=0, updated_at=? WHERE product_id=?",
                        (payload, name, time.time(), pid))
                    updated += 1
                else:
                    unchanged += 1
            self._conn.commit()
        return {"created": created, "updated": updated, "unchanged": unchanged}

    def pending_products(self, limit: int, table: str = "inference") -> list[TrainingItem]:
        rows = self._conn.execute(
            f"SELECT product_id, feature_data, product_name FROM product_{table}_input "
            "WHERE is_vectorized=0 ORDER BY product_id LIMIT ?", (limit,)).fetchall()
        return [TrainingItem(r["product_id"], json.loads(r["feature_data"]),
                             r["product_name"]) for r in rows]

    def all_products(self, table: str = "inference") -> list[TrainingItem]:
        rows = self._conn.execute(
            f"SELECT product_id, feature_data, product_name FROM product_{table}_input "
            "ORDER BY product_id").fetchall()
        return [TrainingItem(r["product_id"], json.loads(r["feature_data"]),
                             r["product_name"]) for r in rows]

    def products_by_ids(self, ids: list[str], table: str = "inference") -> list[TrainingItem]:
        qs = ",".join("?" * len(ids))
        rows = self._conn.execute(
            f"SELECT product_id, feature_data, product_name FROM product_{table}_input "
            f"WHERE product_id IN ({qs}) ORDER BY product_id", ids).fetchall()
        return [TrainingItem(r["product_id"], json.loads(r["feature_data"]),
                             r["product_name"]) for r in rows]

    def save_vectors(self, ids: list[str], vectors: np.ndarray,
                     table: str = "inference") -> None:
        """Upsert vectors + flip the flag (reference `run_pipeline_and_save`,
        dead `serving_controller.py:326-396`)."""
        with self._lock:
            for pid, vec in zip(ids, vectors):
                self._conn.execute(
                    f"INSERT INTO product_{table}_vectors VALUES (?,?,?) "
                    "ON CONFLICT(product_id) DO UPDATE SET vector=excluded.vector, "
                    "updated_at=excluded.updated_at",
                    (pid, np.asarray(vec, np.float32).tobytes(), time.time()))
                self._conn.execute(
                    f"UPDATE product_{table}_input SET is_vectorized=1 "
                    "WHERE product_id=?", (pid,))
            self._conn.commit()

    def get_vector(self, pid: str, table: str = "inference") -> np.ndarray | None:
        row = self._conn.execute(
            f"SELECT vector FROM product_{table}_vectors WHERE product_id=?",
            (pid,)).fetchone()
        return None if row is None else np.frombuffer(row["vector"], np.float32)

    def all_vectors(self, table: str = "inference"):
        rows = self._conn.execute(
            f"SELECT product_id, vector FROM product_{table}_vectors "
            "ORDER BY product_id").fetchall()
        ids = [r["product_id"] for r in rows]
        if not rows:
            return ids, np.zeros((0, 0), np.float32)
        return ids, np.stack([np.frombuffer(r["vector"], np.float32) for r in rows])

    def pending_count(self, table: str = "inference") -> int:
        return self._conn.execute(
            f"SELECT COUNT(*) c FROM product_{table}_input WHERE is_vectorized=0"
        ).fetchone()["c"]

    # -- users / sessions (debug seeding) ---------------------------------
    def insert_manual_data(self, users: list[dict], sessions: list[dict]) -> dict:
        """Seed users/sessions/events, validating that every referenced
        product has a vector (reference `/api/v1/debug/insert-manual-data`,
        `APIController/controller.py:190-271`). Atomic: all-or-nothing."""
        missing = []
        for s in sessions:
            for e in s.get("events", []):
                if self.get_vector(str(e["product_id"])) is None:
                    missing.append(str(e["product_id"]))
        if missing:
            return {"ok": False, "missing_product_vectors": sorted(set(missing))}
        with self._lock:
            try:
                for u in users:
                    self._conn.execute(
                        "INSERT INTO user_profiles (user_id, gender, age_group, style) "
                        "VALUES (?,?,?,?) ON CONFLICT(user_id) DO UPDATE SET "
                        "gender=excluded.gender, age_group=excluded.age_group, "
                        "style=excluded.style",
                        (str(u["user_id"]), u.get("gender"), u.get("age_group"),
                         u.get("style")))
                n_events = 0
                for s in sessions:
                    cur = self._conn.execute(
                        "INSERT INTO user_sessions (user_id, season, started_at, "
                        "cart_context) VALUES (?,?,?,?)",
                        (str(s["user_id"]), s.get("season", Season.SUMMER.value),
                         s.get("started_at", time.time()), s.get("cart_context", "")))
                    sid = cur.lastrowid
                    for e in s.get("events", []):
                        self._conn.execute(
                            "INSERT INTO interaction_events (session_id, product_id, "
                            "action_type, ts) VALUES (?,?,?,?)",
                            (sid, str(e["product_id"]),
                             int(e.get("action_type", ActionType.CLICK)),
                             e.get("ts", time.time())))
                        n_events += 1
                    # fresh interactions invalidate the user's service vector
                    # (same contract as changed product payloads resetting
                    # `is_vectorized`, reference `controller.py:27-57`)
                    self._conn.execute(
                        "UPDATE user_profiles SET is_vectorized=0 WHERE user_id=?",
                        (str(s["user_id"]),))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise
        return {"ok": True, "users": len(users), "sessions": len(sessions),
                "events": n_events}

    def purchase_sessions(self) -> list[dict]:
        """Sessions containing a PURCHASE event (``is_purchase_session``),
        with their item lists — the user-tower training feed."""
        rows = self._conn.execute(
            "SELECT s.session_id, s.user_id, s.started_at, e.product_id, "
            "e.action_type, e.ts FROM user_sessions s JOIN interaction_events e "
            "ON s.session_id = e.session_id ORDER BY s.session_id, e.ts").fetchall()
        sessions: dict[int, dict] = {}
        for r in rows:
            s = sessions.setdefault(r["session_id"], {
                "session_id": r["session_id"], "user_id": r["user_id"],
                "started_at": r["started_at"], "events": []})
            s["events"].append({"product_id": r["product_id"],
                                "action_type": r["action_type"], "ts": r["ts"]})
        return [s for s in sessions.values()
                if any(e["action_type"] == ActionType.PURCHASE for e in s["events"])]

    # -- user vectors (the reference stores `user_service_vector` but never
    # populates it; these flows give the user side full symmetry with the
    # product vectorize pipeline, `database.py:152-173`) -------------------
    def user_histories(self, user_ids: list[str] | None = None) -> dict[str, list[dict]]:
        """Per-user interaction events (product, action, ts) across all
        sessions, time-ordered — the feed for user vectorization."""
        sql = ("SELECT s.user_id, e.product_id, e.action_type, e.ts "
               "FROM user_sessions s JOIN interaction_events e "
               "ON s.session_id = e.session_id")
        args: tuple = ()
        if user_ids is not None:
            sql += f" WHERE s.user_id IN ({','.join('?' * len(user_ids))})"
            args = tuple(map(str, user_ids))
        sql += " ORDER BY e.ts"
        out: dict[str, list[dict]] = {}
        for r in self._conn.execute(sql, args).fetchall():
            out.setdefault(r["user_id"], []).append(
                {"product_id": r["product_id"],
                 "action_type": r["action_type"], "ts": r["ts"]})
        return out

    def pending_users(self, limit: int) -> list[dict]:
        rows = self._conn.execute(
            "SELECT user_id, gender, age_group, style FROM user_profiles "
            "WHERE is_vectorized=0 ORDER BY user_id LIMIT ?", (limit,)).fetchall()
        return [dict(r) for r in rows]

    def all_user_profiles(self) -> list[dict]:
        rows = self._conn.execute(
            "SELECT user_id, gender, age_group, style FROM user_profiles "
            "ORDER BY user_id").fetchall()
        return [dict(r) for r in rows]

    def save_user_vectors(self, ids: list[str], vectors: np.ndarray) -> None:
        with self._lock:
            for uid, vec in zip(ids, vectors):
                self._conn.execute(
                    "UPDATE user_profiles SET user_service_vector=?, "
                    "is_vectorized=1 WHERE user_id=?",
                    (np.asarray(vec, np.float32).tobytes(), str(uid)))
            self._conn.commit()

    def get_user_vector(self, uid: str) -> np.ndarray | None:
        row = self._conn.execute(
            "SELECT user_service_vector v FROM user_profiles WHERE user_id=?",
            (str(uid),)).fetchone()
        if row is None or row["v"] is None:
            return None
        return np.frombuffer(row["v"], np.float32)

    def user_pending_count(self) -> int:
        return self._conn.execute(
            "SELECT COUNT(*) c FROM user_profiles WHERE is_vectorized=0"
        ).fetchone()["c"]

    def latest_session_season(self, uid: str) -> str | None:
        """Season of the user's most recent session (reference
        ``UserSession.season``, `database.py:185` — stored but never
        consumed there; here it feeds the season-aware recommendation
        re-rank, serve/app.py)."""
        row = self._conn.execute(
            "SELECT season FROM user_sessions WHERE user_id=? "
            "ORDER BY started_at DESC, session_id DESC LIMIT 1",
            (str(uid),)).fetchone()
        return row["season"] if row else None

    def item_seasons(self, ids: list[str], table: str = "inference") -> dict[str, str]:
        """Broad season per product, parsed from the enriched feature JSON's
        CTX micro-season token (data/synthetic.micro_season vocabulary).
        Missing/unenriched products are absent from the result."""
        micro2broad = {
            "high_summer": "Summer", "early_summer": "Summer",
            "summer": "Summer", "warm_spring_autumn": "Spring/Autumn",
            "chilly_spring_autumn": "Spring/Autumn",
            "spring_autumn": "Spring/Autumn",
            "deep_winter": "Winter", "winter": "Winter",
        }
        out: dict[str, str] = {}
        if not ids:
            return out
        q = ",".join("?" * len(ids))
        rows = self._conn.execute(
            f"SELECT product_id, feature_data FROM product_{table}_input "
            f"WHERE product_id IN ({q})", [str(i) for i in ids]).fetchall()
        for r in rows:
            try:
                feat = json.loads(r["feature_data"])
            except (TypeError, ValueError):
                continue
            re_feat = feat.get("reinforced_feature") or feat.get(
                "reinforced_feature_value") or {}
            for tokv in re_feat.get("CTX") or []:
                season = micro2broad.get(str(tokv))
                if season:
                    out[r["product_id"]] = season
                    break
        return out

    def close(self):
        self._conn.close()
