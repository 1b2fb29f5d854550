"""Real H&M Kaggle CSV schema -> internal frames -> downstream stages.

The adapter is the public front door the reference lacks (it reads private
pre-filtered dumps from hardcoded paths, `staticstics/preprosess_agg_parallel.py:21`).
"""

import os

import numpy as np
import pandas as pd
import pytest

from recsys.data import etl
from recsys.data.hm_adapter import (
    enrich_hm_item, items_from_hm, load_hm_dataset, transactions_from_hm,
    users_from_hm, vocab_from_items,
)

ARTICLES = """article_id,product_code,prod_name,product_type_no,product_type_name,product_group_name,graphical_appearance_no,graphical_appearance_name,colour_group_code,colour_group_name,perceived_colour_value_id,perceived_colour_value_name,perceived_colour_master_id,perceived_colour_master_name,department_no,department_name,index_code,index_name,index_group_no,index_group_name,section_no,section_name,garment_group_no,garment_group_name,detail_desc
108775015,108775,Strap top,253,Vest top,Garment Upper body,1010016,Solid,9,Black,4,Dark,5,Black,1676,Jersey Basic,A,Ladieswear,1,Ladieswear,16,Womens Everyday Basics,1002,Jersey Basic,Jersey top with narrow shoulder straps in soft cotton.
110065001,110065,OP T-shirt (Idro),306,Bra,Underwear,1010016,Solid,9,Black,4,Dark,5,Black,1339,Clean Lingerie,B,Lingeries/Tights,1,Ladieswear,61,Womens Lingerie,1017,"Under-, Nightwear",Soft microfibre bra with padded cups and a racer back.
372860001,372860,7p Basic Shaftless,302,Socks,Socks & Tights,1010016,Solid,9,Black,4,Dark,5,Black,3608,Socks Bin,F,Menswear,3,Menswear,26,Men Underwear,1021,Socks and Tights,Fine-knit socks in a cotton blend with elasticated tops.
456163060,456163,Skinny jeans,272,Trousers,Garment Lower body,1010016,Denim,71,Blue,3,Medium Dusty,2,Blue,1744,Denim Trousers,A,Ladieswear,28,Divided Collection,1025,Trousers Denim,High waist skinny jeans in washed stretch denim with zip and button.
"""

CUSTOMERS = """customer_id,FN,Active,club_member_status,fashion_news_frequency,age,postal_code
u1,1.0,1.0,ACTIVE,Regularly,24,zz
u2,,,PRE-CREATE,NONE,49,zz
u3,1.0,,LEFT CLUB,Monthly,,zz
"""

TRANSACTIONS = """t_dat,customer_id,article_id,price,sales_channel_id
2019-09-23,u1,108775015,0.0254,2
2019-09-25,u1,456163060,0.0500,1
2019-10-01,u2,110065001,0.0203,2
2019-10-07,u2,456163060,0.0490,2
2019-10-08,u3,372860001,0.0080,1
2020-09-20,u1,108775015,0.0254,2
"""


@pytest.fixture()
def hm_dir(tmp_path):
    (tmp_path / "articles.csv").write_text(ARTICLES)
    (tmp_path / "customers.csv").write_text(CUSTOMERS)
    (tmp_path / "transactions_train.csv").write_text(TRANSACTIONS)
    return str(tmp_path)


def test_transactions_mapping(hm_dir):
    tx = transactions_from_hm(os.path.join(hm_dir, "transactions_train.csv"))
    assert list(tx.columns) == ["user_id", "item_id", "day", "price", "channel"]
    assert tx["day"].min() == 0  # origin = earliest date
    assert tx["day"].max() == (pd.Timestamp("2020-09-20") - pd.Timestamp("2019-09-23")).days
    assert tx["channel"].dtype == np.int8
    # window filter replicates the reference's 1-year cut
    tx_w = transactions_from_hm(os.path.join(hm_dir, "transactions_train.csv"),
                                date_min="2019-09-23", date_max="2019-12-31")
    assert len(tx_w) == 5


def test_items_users_mapping(hm_dir):
    tx = transactions_from_hm(os.path.join(hm_dir, "transactions_train.csv"))
    items = items_from_hm(os.path.join(hm_dir, "articles.csv"), tx)
    assert set(items["item_id"]) == {"108775015", "110065001", "372860001", "456163060"}
    jeans = items[items["item_id"] == "456163060"].iloc[0]
    assert jeans["gender"] == "female"  # Divided -> female bucket
    assert jeans["release_day"] == 2
    assert jeans["price"] == pytest.approx(0.0495, abs=1e-4)
    socks = items[items["item_id"] == "372860001"].iloc[0]
    assert socks["gender"] == "male"

    users = users_from_hm(os.path.join(hm_dir, "customers.csv"))
    u = users.set_index("user_id")
    assert u.loc["u1", "age_group"] == "18-24"
    assert u.loc["u2", "age_group"] == "35-49"
    assert u.loc["u3", "age_group"] == "25-34"  # missing age -> default band
    assert u.loc["u3", "club_member_status"] == "left"
    assert u.loc["u2", "fashion_news_frequency"] == "none"
    assert int(u.loc["u2", "fn"]) == 0  # NaN FN -> 0


def test_enrichment_rules():
    row = {"detail_desc": "High waist skinny jeans in washed stretch denim "
                          "with zip and button.",
           "product_type_name": "Trousers", "product_group_name":
           "Garment Lower body", "graphical_appearance_name": "Denim",
           "colour_group_name": "Blue", "perceived_colour_value_name":
           "Medium Dusty", "section_name": "Divided", "index_name": "Ladieswear"}
    rf = enrich_hm_item(row)["reinforced_feature_value"]
    assert rf["LOC"] == ["lower_body"]
    assert "denim" in rf["MAT"]
    assert "skinny" in rf["FIT"] and "high_waist" in rf["FIT"]
    assert "zip" in rf["DET"] and "button" in rf["DET"]
    assert "stretch" in rf["FNC"]
    assert rf["CAT"][0] == "trousers"


def test_full_load_through_etl_and_tokenizer(hm_dir):
    from recsys.config import Config
    from recsys.data.dataset import tokenize_items

    items, users, tx = load_hm_dataset(hm_dir)
    train_tx, valid_tx, split_day = etl.time_split(tx, valid_days=7)
    feats = etl.make_item_features(train_tx, items, split_day)
    assert "raw_probability" in feats and len(feats) == len(items)
    ufeats, _ = etl.make_user_features(train_tx, users, split_day)
    assert {"age_bucket", "club_idx", "news_idx"} <= set(ufeats.columns)

    vocab = vocab_from_items(items)
    # fitted vocab round-trips real values (no UNK for seen tokens)
    assert vocab.get_id("colour_group_name", "Blue") > 1
    tensors = tokenize_items(items, vocab, Config().vocab)
    assert tensors["std"].shape == (len(items), vocab.num_fields)
    assert tensors["re_mask"].sum() > 0


def test_vocab_json_roundtrip(hm_dir, tmp_path):
    from recsys.data.vocab import StdVocab

    items, _, _ = load_hm_dataset(hm_dir)
    vocab = vocab_from_items(items)
    path = str(tmp_path / "v.json")
    vocab.to_json(path)
    v2 = StdVocab.from_json(path)
    assert v2.size == vocab.size
    assert v2.get_id("product_type_name", "Trousers") == \
        vocab.get_id("product_type_name", "Trousers")
