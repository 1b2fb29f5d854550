"""Fixed-shape tensorization: items for SimCSE, sequences for SASRec.

Redesign of the reference's Python DataLoader/collator stack
(SURVEY.md §3.2): ALL tokenization happens once, offline, producing dense
int tensors; the SimCSE two-view corruption becomes pure on-device masking
(see ``ops/augment.py``) instead of per-step dict surgery + 9 tokenizer
calls per item per view (the reference's worst CPU hot loop,
`item_tower.py:465-602`). Per-token *value ids* are stored so value-level
dropout (`_corrupt_data`, reference `item_tower.py:341-394`) can be
reproduced exactly as an array op.

Id convention (everywhere): model item index = 1 + row in the sorted item
master; 0 is PAD. The string-id <-> index map is saved as a sidecar next to
every artifact (see ``train/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd

from recsys.config import UserTowerConfig, VocabConfig
from recsys.data import tokenizer as tok
from recsys.data.vocab import RE_FEATURE_KEYS, StdVocab

# time-delta bucket edges in days (reference `v1_refine_usertower.py:212-214`)
TIME_BUCKET_EDGES = np.array([0, 3, 7, 14, 30, 60, 180, 330, 395])

SIDE_FIELDS = ("product_type_name", "graphical_appearance_name",
               "colour_group_name", "department_name")


@dataclass
class IdMap:
    """String id <-> 1-based model index (0 = PAD)."""

    ids: list[str]

    def __post_init__(self):
        self.to_idx = {str(i): r + 1 for r, i in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    def idx(self, id_: str) -> int:
        return self.to_idx.get(str(id_), 0)

    def idx_array(self, ids) -> np.ndarray:
        return np.array([self.idx(i) for i in ids], dtype=np.int32)


# -- item tensorization (SimCSE / vectorization input) ---------------------

def tokenize_items(items: pd.DataFrame, vocab: StdVocab, cfg: VocabConfig) -> dict:
    """Item master -> dense tensors.

    Returns dict of numpy arrays over N items (sorted by item_id):
      std        (N, F)     STD categorical ids
      re_ids     (N, 9, T)  hashed token ids of RE field values
      re_mask    (N, 9, T)  1 where a real token
      re_value   (N, 9, T)  1-based index of the VALUE each token came from
      txt_ids    (N, Tn)    product-name token ids
      txt_mask   (N, Tn)
      item_ids   list[str]  row order (the id-map source of truth)
    """
    items = items.sort_values("item_id", kind="stable").reset_index(drop=True)
    n = len(items)
    F = vocab.num_fields
    T, Tn = cfg.max_field_tokens, cfg.max_name_tokens
    records = items.to_dict("records")
    std = np.zeros((n, F), dtype=np.int32)
    for r, row in enumerate(records):
        std[r] = vocab.encode_item(row)

    def _re_values(row):
        re_feat = row.get("reinforced_feature")
        if re_feat is None or (hasattr(re_feat, "__len__") and len(re_feat) == 0):
            re_feat = {}
        out = []
        for key in RE_FEATURE_KEYS:
            values = re_feat.get(key)  # may be list OR numpy array (parquet)
            out.append([] if values is None else [str(v) for v in values])
        return out

    from recsys.data import native_pack
    if native_pack.native_available():
        # native C++ batch packer (bit-identical ids, ~14x the Python loop)
        names = [tagged_name(row) for row in records]
        txt_ids, txt_mask = native_pack.encode_batch(names, Tn, cfg.text_vocab_size)
        cells: list[list[str]] = []
        for row in records:
            cells.extend(_re_values(row))
        flat_ids, flat_mask, flat_val = native_pack.encode_fields(
            cells, T, cfg.text_vocab_size)
        re_ids = flat_ids.reshape(n, len(RE_FEATURE_KEYS), T)
        re_mask = flat_mask.reshape(n, len(RE_FEATURE_KEYS), T)
        re_value = flat_val.reshape(n, len(RE_FEATURE_KEYS), T)
    else:  # pure-Python fallback
        re_ids = np.zeros((n, len(RE_FEATURE_KEYS), T), dtype=np.int32)
        re_mask = np.zeros_like(re_ids)
        re_value = np.zeros_like(re_ids)
        txt_ids = np.zeros((n, Tn), dtype=np.int32)
        txt_mask = np.zeros((n, Tn), dtype=np.int32)
        for r, row in enumerate(records):
            for f, values in enumerate(_re_values(row)):
                pos = 0
                for v_i, value in enumerate(values):
                    for w in tok.normalize(value):
                        if pos >= T:
                            break
                        re_ids[r, f, pos] = tok.token_id(w, cfg.text_vocab_size)
                        re_mask[r, f, pos] = 1
                        re_value[r, f, pos] = v_i + 1
                        pos += 1
            txt_ids[r], txt_mask[r] = tok.encode(tagged_name(row), Tn,
                                                 cfg.text_vocab_size)

    return {
        "std": std, "re_ids": re_ids, "re_mask": re_mask, "re_value": re_value,
        "txt_ids": txt_ids, "txt_mask": txt_mask,
        "item_ids": list(items["item_id"].astype(str)),
    }


def tagged_name(row: dict) -> str:
    """Name tagging with category fallback (reference `train_simcse_from_db`
    name logic, `item_tower.py:930-948`): "name (Category: type)", falling
    back to type+appearance, else a fixed unknown marker."""
    name = str(row.get("product_name") or "").strip()
    ptype = str(row.get("product_type_name") or "").strip()
    if name and ptype:
        return f"{name} (Category: {ptype})"
    if name:
        return name
    if ptype:
        return f"{ptype} {row.get('graphical_appearance_name', '')}"
    return "unknown product"


def slice_item_batch(tensors: dict, idx: np.ndarray) -> dict:
    return {k: v[idx] for k, v in tensors.items() if k != "item_ids"}


# -- SASRec tensorization ---------------------------------------------------

def build_side_info(items: pd.DataFrame, num_buckets: int) -> tuple[np.ndarray, IdMap]:
    """(N+1, num_side_fields) hashed metadata ids aligned to model item
    indexing; row 0 = PAD (reference `load_item_metadata_hashed`,
    `v1_usertower_train.py:220-262`)."""
    items = items.sort_values("item_id", kind="stable").reset_index(drop=True)
    id_map = IdMap(list(items["item_id"].astype(str)))
    side = np.zeros((len(items) + 1, len(SIDE_FIELDS)), dtype=np.int32)
    for r, row in enumerate(items.to_dict("records")):
        for f, field in enumerate(SIDE_FIELDS):
            side[r + 1, f] = tok.hash_bucket(row.get(field), num_buckets, salt=field)
    return side, id_map


def build_sasrec_tensors(sequences: pd.DataFrame, user_feats: pd.DataFrame,
                         item_map: IdMap, cfg: UserTowerConfig) -> dict:
    """All-user fixed-shape SASRec training tensors.

    Left-pads so the latest event sits at the last position, and applies
    the causal shift input = seq[:-1], target = seq[1:] (reference
    `SASRecDataset`, `v1_refine_usertower.py:222-306`). Users with < 2
    events are dropped (nothing to predict).
    """
    L = cfg.max_len
    uf = user_feats.set_index("user_id")
    rows = []
    for rec in sequences.to_dict("records"):
        seq = [item_map.idx(i) for i in rec["sequence"]]
        deltas = list(rec["sequence_deltas"])
        keep = [k for k, s in enumerate(seq) if s != 0]  # drop unknown items
        seq = [seq[k] for k in keep]
        deltas = [deltas[k] for k in keep]
        if len(seq) < 2 or rec["user_id"] not in uf.index:
            continue
        rows.append((rec["user_id"], seq[-(L + 1):], deltas[-(L + 1):]))

    n = len(rows)
    inp = np.zeros((n, L), dtype=np.int32)
    tgt = np.zeros((n, L), dtype=np.int32)
    tbk = np.zeros((n, L), dtype=np.int32)
    mask = np.zeros((n, L), dtype=np.int32)  # 1 = real position
    user_ids = []
    for r, (uid, seq, deltas) in enumerate(rows):
        user_ids.append(uid)
        x, y = seq[:-1], seq[1:]
        d = np.digitize(deltas[:-1], TIME_BUCKET_EDGES[1:])
        k = len(x)
        inp[r, L - k:] = x
        tgt[r, L - k:] = y
        tbk[r, L - k:] = d
        mask[r, L - k:] = 1

    sel = uf.loc[user_ids]
    from recsys.data.etl import USER_BUCKET_COLS, USER_CAT_COLS, USER_CONT_COLS
    return {
        "input_ids": inp, "target_ids": tgt, "time_buckets": tbk, "seq_mask": mask,
        "user_buckets": sel[list(USER_BUCKET_COLS)].to_numpy(np.int32),
        "user_cats": sel[list(USER_CAT_COLS)].to_numpy(np.int32),
        "user_cont": sel[list(USER_CONT_COLS)].to_numpy(np.float32),
        "user_ids": user_ids,
    }


def batch_iterator(n: int, batch_size: int, rng: np.random.Generator | None = None,
                   drop_last: bool = True):
    """Shuffled fixed-size index batches (drop_last mirrors the reference's
    contrastive loops, which need full batches for the (B,B) similarity)."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        yield order[s:s + batch_size]
