"""Distill fidelity-vs-scale sweep (VERDICT r4 weak #1 / next-round item 5).

Question: why does teacher->student ranking fidelity collapse from 0.90
(mid scale) to 0.034 (105k items) — student capacity/steps, or an
objective that cannot carry top-of-ranking signal at catalog scale?

Design: the SAME shape teacher (gnn_users/gnn_items exported by
train-gnn on the v4 world) is subsampled to 5k/25k/full catalogs, so
catalog size is the only variable — no GNN retrains, no world changes.
Then at full scale, capacity (wide), steps (steps4x) and teacher-top-k
hard-pair mining (hard, cfg.distill.hard_frac) arms separate
"undertrained/too small" from "uniform-pair MSE never sees the tail".

Mechanism being tested: a uniform 4096-item batch covers ~82% of a 5k
catalog (top-100 ordering is fully represented in the MSE) but ~4% of a
105k one, so the pairs that decide each user's top-100 are ~0.1% of the
loss mass at shape. Reference: `gnn_model/distill_mag_to_cos_l2.py:6-108`
(its MSE objective, same uniform sampling).

Usage: python scripts/distill_scale_sweep.py <world_dir> <out_json>
"""

import dataclasses  # noqa: F401  (kept for ad-hoc arm edits)
import json
import sys
import tempfile

import numpy as np

from recsys.config import Config, DistillConfig
from recsys.eval.gnn_eval import distill_fidelity
from recsys.train.checkpoint import load_array_with_ids
from recsys.train.gnn import distilled_vectors, train_distill


def main():
    wd, out_path = sys.argv[1], sys.argv[2]
    gu, _, _ = load_array_with_ids(f"{wd}/gnn_users")
    gi, _, _ = load_array_with_ids(f"{wd}/gnn_items")
    rng = np.random.default_rng(0)
    full = len(gi)
    # Most-valuable-first so a deadline kill still leaves the verdict:
    # the at-shape default (reproduces the 0.034 collapse), the at-shape
    # hard-mining fix arm, then the scale curve, then the capacity/steps
    # control arms.
    arms = [(full, "default", {}),
            (full, "hard", {"hard_frac": 0.5}),
            (5000, "default", {}),
            (25000, "default", {}),
            (5000, "hard", {"hard_frac": 0.5}),
            (25000, "hard", {"hard_frac": 0.5}),
            (full, "steps4x", {"epochs": 40}),
            (full, "wide", {"hidden_dim": 512})]
    arms = [(n, name, over) for n, name, over in arms if n <= full]

    results = []
    for n, name, over in arms:
        sub = gi if n >= full else gi[np.sort(
            rng.choice(full, n, replace=False))]
        cfg = Config(distill=DistillConfig(**over))
        with tempfile.TemporaryDirectory() as td:
            state, model = train_distill(cfg, gu, sub, td)
        si = distilled_vectors(state, model, sub)
        su = distilled_vectors(state, model, gu)
        fid = distill_fidelity(gu, sub, si, su, k=100, sample=2048)
        row = {"n_items": int(len(sub)), "arm": name,
               "overrides": over, **fid}
        print(json.dumps(row), flush=True)
        results.append(row)
        # Incremental write: a deadline kill still leaves a valid JSON
        # with every completed arm.
        with open(out_path, "w") as f:
            json.dump({"command": "distill_scale_sweep", "rows": results},
                      f, indent=1)


if __name__ == "__main__":
    main()
