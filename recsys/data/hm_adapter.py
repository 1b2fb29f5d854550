"""Real-dataset adapters: the H&M Kaggle CSV schema -> internal frames.

The reference trains on the H&M articles/customers/transactions dataset but
only ever reads pre-filtered private JSON/CSV dumps from hardcoded Windows
paths (`staticstics/preprosess_agg_parallel.py:21,40`, `staticstics/
data_agg.py:8`).  This module is the missing public front door: it streams
the three raw Kaggle CSVs in bounded chunks and emits the framework's
canonical ``items`` / ``users`` / ``transactions`` frames, so every
downstream stage (ETL, towers, GNN, serving) runs unchanged on real data.

Column mappings (H&M -> internal):

  transactions_train.csv   t_dat -> day (days since the earliest date seen,
                           or a caller-fixed origin), customer_id -> user_id,
                           article_id -> item_id, price (kept raw; H&M price
                           is pre-normalized), sales_channel_id -> channel.
  articles.csv             article_id -> item_id, prod_name -> product_name,
                           the six STD fields pass through by name
                           (`utils/vocab.py:5-418` uses the same H&M columns),
                           plus material/detail/gender/style derived from
                           garment_group_name / detail_desc / index_group_name.
  customers.csv            customer_id -> user_id, age -> age_group band,
                           club_member_status / fashion_news_frequency
                           normalized to the internal value sets, FN -> fn,
                           Active -> active.

RE enrichment on real data: ``enrich_hm_item`` is the deterministic
rule-based equivalent of the reference's description-tokenizer prompt
(`llm_model_sys_instructions/description_tokenizer:7-20`): field-aware token
extraction from ``detail_desc`` + the categorical columns into the nine
``[CAT]..[LOC]`` tags — atomic splitting, stopword removal, dedup.  (The
synthetic world's `enrich_item` instead uses measurement-ratio geometry; real
H&M rows carry no measurements, so description mining is the honest source.)
"""

from __future__ import annotations

import datetime as _dt
import re

import numpy as np
import pandas as pd

from recsys.data.ingest import iter_csv_records
from recsys.data.vocab import RE_FEATURE_KEYS, StdVocab

STD_FIELDS = (
    "product_type_name", "graphical_appearance_name", "colour_group_name",
    "department_name", "section_name", "perceived_colour_value_name",
)

_AGE_BANDS = ((25, "18-24"), (35, "25-34"), (50, "35-49"), (200, "50+"))

_CLUB_MAP = {"active": "active", "pre-create": "pre_create",
             "pre_create": "pre_create", "left club": "left", "left": "left"}
_NEWS_MAP = {"none": "none", "regularly": "regularly", "monthly": "monthly"}

# description-mining keyword lexicons (lowercase match against detail_desc)
_MATERIAL_WORDS = ("cotton", "linen", "wool", "polyester", "viscose", "denim",
                   "leather", "silk", "jersey", "cashmere", "lyocell", "nylon",
                   "satin", "suede", "velvet", "lace", "mesh", "fleece", "down")
_FIT_WORDS = ("slim", "loose", "relaxed", "oversized", "fitted", "regular fit",
              "straight", "skinny", "wide", "flared", "tapered", "cropped",
              "longline", "high waist", "low waist", "a-line", "bodycon")
_DETAIL_WORDS = ("ribbed", "pleated", "button", "zip", "pocket", "hood",
                 "collar", "ruffle", "seam", "drawstring", "elasticated",
                 "embroidered", "printed", "padded", "lined", "frill", "cuffs",
                 "v-neck", "round neck", "turtleneck", "long sleeves",
                 "short sleeves", "sleeveless")
_FNC_WORDS = ("warm", "breathable", "waterproof", "stretch", "lightweight",
              "thermal", "quick-dry", "windproof", "soft")

_LOWER_GROUPS = ("garment lower body", "trousers", "shorts", "skirts")
_FULL_GROUPS = ("garment full body", "dresses", "jumpsuits", "dressed")
_FEET_GROUPS = ("shoes", "socks & tights")
_ACC_GROUPS = ("accessories", "bags", "items")


def _day_from_date(s: str, origin: _dt.date) -> int:
    y, m, d = s.split("-")
    return (_dt.date(int(y), int(m), int(d)) - origin).days


def transactions_from_hm(path: str, *, origin_date: str | None = None,
                         chunk_rows: int = 100_000,
                         date_min: str | None = None,
                         date_max: str | None = None) -> pd.DataFrame:
    """Stream transactions_train.csv -> internal tx frame.

    ``origin_date`` fixes day-0 (ISO date); default = the earliest date in
    the file.  ``date_min``/``date_max`` replicate the reference's 1-year
    window filter (`preprosess_agg_parallel.py:43-45`).
    """
    chunks = []
    for chunk in iter_csv_records(path, chunk_rows):
        if date_min is not None:
            chunk = chunk[chunk["t_dat"] >= date_min]
        if date_max is not None:
            chunk = chunk[chunk["t_dat"] <= date_max]
        if len(chunk):
            chunks.append(chunk)
    if not chunks:
        return pd.DataFrame(columns=["user_id", "item_id", "day", "price", "channel"])
    df = pd.concat(chunks, ignore_index=True)
    origin = _dt.date.fromisoformat(origin_date or str(df["t_dat"].min()))
    out = pd.DataFrame({
        "user_id": df["customer_id"].astype(str),
        "item_id": df["article_id"].astype(str),
        "day": df["t_dat"].map(lambda s: _day_from_date(str(s), origin)).astype(np.int32),
        "price": df["price"].astype(np.float32),
        "channel": df["sales_channel_id"].astype(np.int8),
    })
    return out.sort_values(["day"], kind="stable").reset_index(drop=True)


def _find_words(text: str, lexicon: tuple[str, ...]) -> list[str]:
    return [w.replace(" ", "_").replace("-", "_") for w in lexicon if w in text]


def enrich_hm_item(row: dict) -> dict:
    """Deterministic description-tokenizer over a raw articles.csv row:
    the rule-based stand-in for the reference's LLM field extraction."""
    desc = str(row.get("detail_desc") or "").lower()
    ptype = str(row.get("product_type_name") or "").strip().lower().replace(" ", "_")
    group = str(row.get("product_group_name") or "").strip().lower()
    loc = ("lower_body" if group in _LOWER_GROUPS else
           "full_body" if group in _FULL_GROUPS else
           "feet" if group in _FEET_GROUPS else
           "accessory" if group in _ACC_GROUPS else "upper_body")
    fits = _find_words(desc, _FIT_WORDS) or ["regular_fit"]
    mats = _find_words(desc, _MATERIAL_WORDS)
    dets = _find_words(desc, _DETAIL_WORDS)
    appear = str(row.get("graphical_appearance_name") or "").strip().lower()
    if appear and appear not in ("solid",):
        dets.append(appear.replace(" ", "_"))
    ctx = ("sport" if "sport" in str(row.get("section_name", "")).lower()
           or "active" in desc else
           "party" if appear in ("glitter", "metallic", "sequin", "lace") else
           "daily")
    re_features = {
        "CAT": list(dict.fromkeys([ptype, f"{fits[0]}_{ptype}"])),
        "MAT": mats or ["unknown_material"],
        "DET": list(dict.fromkeys(dets)) or ["plain"],
        "FIT": list(dict.fromkeys(fits)),
        "FNC": _find_words(desc, _FNC_WORDS) or ["breathable"],
        "SPC": [str(row.get("index_name") or "general").strip().lower().replace(" ", "_")],
        "COL": [str(row.get("colour_group_name") or "").strip().lower(),
                str(row.get("perceived_colour_value_name") or "").strip().lower()],
        "CTX": [ctx],
        "LOC": [loc],
    }
    assert set(re_features) == set(RE_FEATURE_KEYS)
    return {"reinforced_feature_value": re_features}


def items_from_hm(path: str, tx: pd.DataFrame | None = None, *,
                  chunk_rows: int = 100_000, enrich: bool = True) -> pd.DataFrame:
    """Stream articles.csv -> internal item master.  If ``tx`` is given,
    price = mean transacted price and release_day = first transaction day
    (articles.csv itself carries neither)."""
    chunks = list(iter_csv_records(path, chunk_rows))
    df = pd.concat(chunks, ignore_index=True)
    index_group = df.get("index_group_name", pd.Series([""] * len(df))).astype(str)
    gender = np.where(index_group.str.lower().str.startswith(("ladies", "divided")),
                      "female",
                      np.where(index_group.str.lower().str.startswith(("men",)),
                               "male", "unisex"))
    out = pd.DataFrame({
        "item_id": df["article_id"].astype(str),
        "product_name": df.get("prod_name", pd.Series([""] * len(df))).astype(str),
    })
    for f in STD_FIELDS:
        out[f] = df.get(f, pd.Series([""] * len(df))).astype(str)
    out["gender"] = gender
    out["style"] = np.where(
        df.get("graphical_appearance_name", pd.Series([""] * len(df)))
        .astype(str).str.lower().isin(("solid", "melange", "stripe")),
        "classic", "trend")
    recs = df.to_dict("records")
    if enrich:
        out["reinforced_feature"] = [
            enrich_hm_item(r)["reinforced_feature_value"] for r in recs]
        out["material"] = [rf["MAT"][0] for rf in out["reinforced_feature"]]
        out["detail"] = [rf["DET"][0] for rf in out["reinforced_feature"]]
    if tx is not None and len(tx):
        price = tx.groupby("item_id")["price"].mean()
        first = tx.groupby("item_id")["day"].min()
        out["price"] = out["item_id"].map(price).fillna(float(tx["price"].median())).astype(np.float32)
        out["release_day"] = out["item_id"].map(first).fillna(0).astype(np.int32)
    else:
        out["price"] = np.float32(0.05)
        out["release_day"] = np.int32(0)
    return out


def users_from_hm(path: str, *, chunk_rows: int = 100_000) -> pd.DataFrame:
    chunks = list(iter_csv_records(path, chunk_rows))
    df = pd.concat(chunks, ignore_index=True)

    def band(a) -> str:
        try:
            a = float(a)
        except (TypeError, ValueError):
            return "25-34"
        if a != a:  # NaN age (parquet/NA inputs) -> default band, not 50+
            return "25-34"
        for hi, name in _AGE_BANDS:
            if a < hi:
                return name
        return "50+"

    def norm(v, mapping, default):
        return mapping.get(str(v).strip().lower(), default)

    return pd.DataFrame({
        "user_id": df["customer_id"].astype(str),
        "age_group": df.get("age", pd.Series([None] * len(df))).map(band),
        "gender": "unknown",
        "style": "unknown",
        "club_member_status": df.get("club_member_status", pd.Series([""] * len(df)))
        .map(lambda v: norm(v, _CLUB_MAP, "active")),
        "fashion_news_frequency": df.get("fashion_news_frequency", pd.Series([""] * len(df)))
        .map(lambda v: norm(v, _NEWS_MAP, "none")),
        "fn": pd.to_numeric(df.get("FN", pd.Series([0] * len(df))),
                            errors="coerce").fillna(0).astype(int),
        "active": pd.to_numeric(df.get("Active", pd.Series([0] * len(df))),
                                errors="coerce").fillna(0).astype(int),
    })


def vocab_from_items(items: pd.DataFrame) -> StdVocab:
    """Fit a closed STD vocab from a real item master (the ``from_json``
    production path's frame-driven twin): per-field sorted unique values."""
    config = {f: sorted(items[f].astype(str).str.strip().str.lower().unique())
              for f in STD_FIELDS if f in items}
    return StdVocab(config)


def load_hm_dataset(hm_dir: str, *, date_min: str | None = None,
                    date_max: str | None = None, chunk_rows: int = 100_000,
                    transactions_csv: str = "transactions_train.csv",
                    articles_csv: str = "articles.csv",
                    customers_csv: str = "customers.csv"):
    """Full real-data ingest: (items, users, tx) internal frames from a
    directory holding the three Kaggle CSVs."""
    import os
    tx = transactions_from_hm(os.path.join(hm_dir, transactions_csv),
                              date_min=date_min, date_max=date_max,
                              chunk_rows=chunk_rows)
    items = items_from_hm(os.path.join(hm_dir, articles_csv), tx,
                          chunk_rows=chunk_rows)
    users = users_from_hm(os.path.join(hm_dir, customers_csv),
                          chunk_rows=chunk_rows)
    # keep only users/items that appear in at least one frame consistently
    return items, users, tx
