"""Training-free baseline rows (popularity / repurchase / content-profile)
for a world, independent of stage-2 checkpoints.

Usage: python scripts/hm_baselines.py <data_root> [k,k,k]

The content-profile row is THE content-signal diagnostic for the world
(VERDICT r3 item 2: on the round-3 world it sat BELOW the popularity
floor, 1.75% vs 3.81%@100 — content was inert). Running it decoupled
from `eval` means the row lands even if the long stage-2 run is still in
flight. Prints one JSON line.
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")

from recsys.config import Config, DataConfig  # noqa: E402


def main():
    root = sys.argv[1]
    ks = tuple(int(k) for k in (sys.argv[2].split(",") if len(sys.argv) > 2
                                else (20, 100, 500)))
    import pandas as pd

    from recsys.eval.baselines import baseline_report
    from recsys.eval.recall import target_rows
    from recsys.train.checkpoint import align_rows, load_array_with_ids
    from recsys.train.sasrec import prepare_stage2

    cfg = Config(data=DataConfig(root=root))
    items = pd.read_parquet(f"{root}/items.parquet")
    users = pd.read_parquet(f"{root}/users.parquet")
    tx = pd.read_parquet(f"{root}/transactions.parquet")
    data = prepare_stage2(cfg, items, users, tx)
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    aligned, _ = align_rows(mat[1:], ids[1:], data["item_map"].ids,
                            fill="random")
    content = np.concatenate([np.zeros((1, mat.shape[1]), np.float32),
                              aligned])
    tens = data["tensors"]
    rows = target_rows(tens["user_ids"], data["targets_idx"])
    sub = {"user_ids": [tens["user_ids"][r] for r in rows],
           "input_ids": tens["input_ids"][rows],
           "target_ids": tens["target_ids"][rows]}
    rep = baseline_report(sub, data["logq"], data["targets_idx"], ks=ks,
                          item_matrix=content)
    rep.pop("_per_user", None)
    print(json.dumps({"command": "baselines", "n_target_users": len(rows),
                      **rep}))


if __name__ == "__main__":
    main()
