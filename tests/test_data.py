"""Data layer tests: vocab, tokenizer, synthetic world, ETL features,
SASRec tensorization. The reference's inline guardrails (SURVEY.md §4.1)
are encoded here as real assertions."""

import dataclasses

import numpy as np
import pytest

from recsys.config import DataConfig, UserTowerConfig, VocabConfig
from recsys.data import etl, tokenizer as tok
from recsys.data.dataset import (
    IdMap,
    build_sasrec_tensors,
    build_side_info,
    tokenize_items,
)
from recsys.data.synthetic import enrich_item, generate_dataset
from recsys.data.vocab import PAD_ID, RE_FEATURE_KEYS, UNK_ID, StdVocab

CFG = DataConfig(num_items=200, num_users=80, days=60, seed=7)


@pytest.fixture(scope="module")
def world():
    return generate_dataset(CFG)


def test_vocab_flatten():
    v = StdVocab()
    assert v.get_id("colour_group_name", "black") >= 2
    assert v.get_id("colour_group_name", "no_such_colour") == UNK_ID
    assert v.get_id("colour_group_name", None) == PAD_ID
    # same string in different fields -> different ids
    v2 = StdVocab({"a": ["x"], "b": ["x"]})
    assert v2.get_id("a", "x") != v2.get_id("b", "x")
    row = v.encode_item({"colour_group_name": "black"})
    assert len(row) == v.num_fields


def test_tokenizer_stateless_and_fixed_shape():
    ids1, m1 = tok.encode("Ribbed Cotton T-Shirt", 8, 1000)
    ids2, m2 = tok.encode("ribbed cotton t-shirt!", 8, 1000)
    np.testing.assert_array_equal(ids1, ids2)  # normalization + stable hash
    assert ids1.shape == (8,) and m1.sum() == 4  # ribbed/cotton/t/shirt
    assert tok.hash_bucket("x", 100, "f1") != tok.hash_bucket("x", 100, "f2")
    assert tok.hash_bucket(None, 100) == 0


def test_fake_llm_geometry_rules():
    base = {"product_type_name": "trousers", "graphical_appearance_name": "solid",
            "colour_group_name": "black", "perceived_colour_value_name": "dark",
            "section_name": "mens_basic", "material": "wool", "detail": "zip",
            "style": "classic", "total_length": 110.0, "chest_width": 50.0,
            "waist_width": 35.0, "hem_width": 70.0, "rise": 30.0}
    re_feat = enrich_item(base)["reinforced_feature_value"]
    assert set(re_feat) == set(RE_FEATURE_KEYS)
    assert "maxi" in re_feat["FIT"][0]            # length tier
    assert re_feat["FIT"][1] == "a_line_flare"    # hem/chest ratio 1.4
    assert re_feat["FIT"][2] == "cinched_waist"   # waist/chest ratio 0.7
    assert "high_rise" in re_feat["FIT"]          # rise > 28 on lower body
    assert re_feat["LOC"] == ["lower_body"]
    assert re_feat["FNC"] == ["warm"]             # wool
    # deterministic
    assert enrich_item(base) == enrich_item(base)


def test_synthetic_world(world):
    items, users, tx = world
    assert len(items) == CFG.num_items and len(users) == CFG.num_users
    assert len(tx) > 1000
    assert etl.deep_inspect_missing_items(tx, items)["missing_tx"] == 0
    # popularity is skewed (zipf): top item >> median item
    counts = tx.groupby("item_id").size().sort_values(ascending=False)
    assert counts.iloc[0] > 5 * counts.median()


def test_time_split_and_targets(world):
    _, _, tx = world
    train, valid, split_day = etl.time_split(tx, valid_days=7)
    assert train["day"].max() < split_day <= valid["day"].min() + 7
    targets = etl.make_validation_target(valid)
    assert len(targets) > 10
    some_user = next(iter(targets))
    assert len(targets[some_user]) == len(set(targets[some_user]))  # deduped


def test_item_features(world):
    items, _, tx = world
    train, _, split_day = etl.time_split(tx)
    feats = etl.make_item_features(train, items, split_day)
    assert len(feats) == len(items)
    assert feats["raw_probability"].sum() == pytest.approx(1.0, abs=1e-6)
    assert feats["velocity_1w"].between(-1.0, 5.0).all()
    assert (feats["days_since_release_log"] >= 0).all()
    logq = etl.logq_from_item_features(feats, sorted(items["item_id"]))
    assert logq.shape == (len(items) + 1,)
    assert logq[0] == -20.0  # PAD row
    assert (logq <= 0).all()


def test_user_features_scaler_shared(world):
    _, users, tx = world
    train, _, split_day = etl.time_split(tx)
    uf, scaler = etl.make_user_features(train, users, split_day)
    assert uf["price_mean_b"].between(0, 10).all()
    # continuous block standardized on train
    assert abs(uf["price_std_s"].mean()) < 0.1
    # reapplying the train scaler must not refit
    uf2, _ = etl.make_user_features(train.head(500), users, split_day, scaler=scaler)
    assert scaler.mean["price_std"] == pytest.approx(float(train.groupby("user_id")["price"].std().fillna(0).reindex(users["user_id"]).fillna(0).mean()), rel=1)


def test_sequences_and_sanity(world):
    _, _, tx = world
    train, valid, _ = etl.time_split(tx)
    seqs = etl.make_sequences(train, max_len=50)
    assert (seqs["seq_len"] <= 50).all()
    # deltas are non-negative and last delta is 0 (relative to last event)
    for rec in seqs.head(20).to_dict("records"):
        assert rec["sequence_deltas"][-1] == 0
        assert all(d >= 0 for d in rec["sequence_deltas"])
    targets = etl.make_validation_target(valid)
    report = etl.final_sanity_check(seqs, targets)
    assert report["pad_inside_sequence"] == 0
    assert report["coverage"] > 0.8  # most target users have history
    dist = etl.check_sequence_distribution(seqs, etl.make_sequences(valid, 50))


def test_tokenize_items_shapes(world):
    items, _, _ = world
    vcfg = VocabConfig(max_field_tokens=16, max_name_tokens=12)
    t = tokenize_items(items, StdVocab(), vcfg)
    n = len(items)
    assert t["std"].shape == (n, 6)
    assert t["re_ids"].shape == (n, 9, 16)
    assert t["txt_ids"].shape == (n, 12)
    # masks consistent; value ids only where mask
    assert ((t["re_mask"] == 1) == (t["re_value"] > 0)).all()
    assert t["item_ids"] == sorted(t["item_ids"])
    # every item has at least CAT tokens
    assert (t["re_mask"][:, 0].sum(axis=-1) > 0).all()


def test_sasrec_causal_shift_invariant(world):
    """The reference's `dataset_peek` integrity check as a real test:
    Input[t+1] == Target[t] on every real position."""
    items, users, tx = world
    train, _, split_day = etl.time_split(tx)
    uf, _ = etl.make_user_features(train, users, split_day)
    seqs = etl.make_sequences(train, max_len=20)
    _, item_map = build_side_info(items, 100)
    cfg = UserTowerConfig(max_len=20)
    t = build_sasrec_tensors(seqs, uf, item_map, cfg)
    inp, tgt, mask = t["input_ids"], t["target_ids"], t["seq_mask"]
    assert len(t["user_ids"]) > 10
    # left padding: all real positions at the end
    first_real = mask.argmax(axis=1)
    for r in range(min(20, len(inp))):
        fr = first_real[r]
        assert (mask[r, :fr] == 0).all() and (mask[r, fr:] == 1).all()
        np.testing.assert_array_equal(inp[r, fr + 1:], tgt[r, fr:-1])
        assert (inp[r, fr:] > 0).all()  # no pad ids inside the sequence
    assert t["user_buckets"].shape[1] == 4
    assert t["user_cats"].shape[1] == 5
    assert t["user_cont"].shape[1] == 4


def test_side_info_alignment(world):
    items, _, _ = world
    side, id_map = build_side_info(items, 100)
    assert side.shape == (len(items) + 1, 4)
    assert (side[0] == 0).all()  # PAD row
    assert (side[1:] > 0).all()
    assert id_map.idx(id_map.ids[0]) == 1
    assert id_map.idx("missing") == 0


def test_native_packer_matches_python(world, monkeypatch):
    """Native C++ tokenization must be bit-identical to the Python path."""
    from recsys.data import native_pack

    items, _, _ = world
    vcfg = VocabConfig(max_field_tokens=16, max_name_tokens=12)
    assert native_pack.native_available()  # g++ is baked into the image
    t_native = tokenize_items(items, StdVocab(), vcfg)
    monkeypatch.setattr(native_pack, "native_available", lambda: False)
    t_python = tokenize_items(items, StdVocab(), vcfg)
    for k in ("std", "re_ids", "re_mask", "re_value", "txt_ids", "txt_mask"):
        np.testing.assert_array_equal(t_native[k], t_python[k], err_msg=k)


def test_aggregate_histories(world, tmp_path):
    _, _, tx = world
    out = etl.aggregate_histories(tx, str(tmp_path / "agg.json"))
    assert len(out["user_histories"]) == tx["user_id"].nunique()
    some = next(iter(out["user_histories"].values()))
    assert some["days"] == sorted(some["days"])
    assert sum(out["article_counts"].values()) == len(tx)
    import json
    assert json.load(open(tmp_path / "agg.json"))["article_counts"]


def test_sequence_distribution_stats(world):
    from recsys.data.analysis import sequence_distribution_stats

    _, _, tx = world
    train, _, _ = etl.time_split(tx)
    seqs = etl.make_sequences(train, max_len=50)
    known = set(train["item_id"])
    stats = sequence_distribution_stats(seqs, known)
    assert stats["len_max"] <= 50
    assert stats["len_mean"] >= 1.0
    assert 0.0 < stats["top10pct_coverage"] <= 1.0
    assert stats["unmapped_items"] == 0
    # p95 >= median (sanity on quantile ordering)
    assert stats["len_p95"] >= stats["len_median"]


def test_latent_clusters_and_oracle(world):
    from recsys.data.synthetic import cluster_oracle_recall
    items, users, tx = world
    cl = items["latent_cluster"].to_numpy()
    assert cl.min() >= 0 and len(np.unique(cl)) >= 8
    # feature coherence: most cluster mates share the majority (gender, style)
    # cell (10% label noise keeps it below 1.0)
    cells = items["gender"] + "/" + items["style"]
    agree = np.mean([
        (cells[cl == c].value_counts().iloc[0] / (cl == c).sum())
        for c in np.unique(cl) if (cl == c).sum() > 0])
    assert agree > 0.6
    # the subscribed-cluster draws create per-user structure: the cluster
    # oracle must beat the popularity ranking by a clear margin
    split = int(tx["day"].max()) - 7 + 1
    o = cluster_oracle_recall(items, tx, split, k=20)
    assert o["oracle_recall"] > o["popularity_recall"] + 0.02
    # and the knob turns it off: a pool_prob=0 world has (near) no gap
    from recsys.config import DataConfig
    from recsys.data.synthetic import generate_dataset
    flat_cfg = DataConfig(num_items=200, num_users=80, days=60, seed=7,
                          user_pool_prob=0.0)
    fi, fu, ftx = generate_dataset(flat_cfg)
    fo = cluster_oracle_recall(fi, ftx, int(ftx["day"].max()) - 7 + 1, k=20)
    assert (o["oracle_recall"] - o["popularity_recall"]) > \
        (fo["oracle_recall"] - fo["popularity_recall"]) + 0.01


def test_micro_season_rules():
    """The prompter's temperature-aware micro-season block
    (`gemini_flash_compatible_with_Gemma-prompter.txt:18-24`)."""
    from recsys.data.synthetic import micro_season

    assert micro_season("Summer", "linen") == "high_summer"
    assert micro_season("Summer", "cotton") == "early_summer"
    assert micro_season("Summer", "denim") == "summer"
    assert micro_season("Spring/Autumn", "silk") == "warm_spring_autumn"
    assert micro_season("Spring/Autumn", "wool") == "chilly_spring_autumn"
    assert micro_season("Spring/Autumn", "jersey") == "spring_autumn"
    assert micro_season("Winter", "leather") == "deep_winter"
    assert micro_season("Winter", "wool") == "deep_winter"
    assert micro_season("Winter", "cotton") == "winter"


def test_seasonal_drift_and_session_season():
    """Season-matched items draw season_boost x likelier; transactions carry
    the session season; boost=1.0 restores the flat distribution."""
    from recsys.data.synthetic import SEASONS, generate_dataset, season_of_day

    cfg = DataConfig(num_items=300, num_users=120, days=364, seed=5)
    items, _, tx = generate_dataset(cfg)
    assert set(items["season"]) <= set(SEASONS)
    assert set(tx["season"]) <= set(SEASONS)
    # the CTX field of every enriched item carries a micro-season token
    assert any(t.endswith(("summer", "winter", "autumn"))
               for t in items.iloc[0]["reinforced_feature"]["CTX"])
    im = items.set_index("item_id")["season"]
    match = (tx["season"] == tx["item_id"].map(im)).mean()
    base_share = items["season"].map(
        {"Summer": .25, "Spring/Autumn": .5, "Winter": .25}).mean()
    assert match > base_share + 0.10
    flat = dataclasses.replace(cfg, season_boost=1.0)
    items2, _, tx2 = generate_dataset(flat)
    match2 = (tx2["season"] == tx2["item_id"].map(
        items2.set_index("item_id")["season"])).mean()
    assert abs(match2 - base_share) < 0.06
    # day->season mapping covers the quarter cycle
    np.testing.assert_array_equal(season_of_day(np.array([0, 100, 200, 300])),
                                  [0, 1, 2, 1])


def test_seasonal_logq():
    from recsys.data.etl import seasonal_logq
    from recsys.data.synthetic import generate_dataset

    cfg = DataConfig(num_items=200, num_users=80, days=364, seed=7)
    items, _, tx = generate_dataset(cfg)
    order = sorted(items["item_id"])
    slq = seasonal_logq(tx, order, "Winter")
    assert slq is not None and slq.shape == (201,)
    # items never bought in winter sit at the pad floor
    winter_counts = tx[tx["season"] == "Winter"].groupby("item_id").size()
    for i, iid in enumerate(order[:50]):
        if winter_counts.get(iid, 0) == 0:
            assert slq[i + 1] == -20.0
        else:
            assert slq[i + 1] > -20.0
    # no season info at all -> None
    assert seasonal_logq(tx.drop(columns=["season", "day"]), order, "Winter") is None
