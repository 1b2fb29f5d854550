"""CPU path for the H&M-shape eval stage.

Computes the headline numbers without the chip: stage-2 best-checkpoint
retrieval, no-ML baselines, a reduced serving-blend grid, and the paired
bootstrap significance block. Writes artifacts/quality_hm/eval_cpu.json
(same schema as cmd_eval, minus the seasonal blend). ks capped at 100 to
keep host top-k work bounded.

Usage: PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python scripts/hm_eval_cpu.py
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from recsys.config import load_config  # noqa: E402

SETS = {"data": {"root": "artifacts/quality_hm/world", "num_items": 105000,
                 "num_users": 1370000, "days": 365, "repeat_prob": 0.10},
        "user_train": {"eval_ks": [20, 100]}}


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main():
    cfg = load_config(overrides=SETS)
    import pandas as pd
    from recsys.train.checkpoint import (CheckpointStore, align_rows,
                                             load_array_with_ids)
    from recsys.train.sasrec import (collect_user_vectors,
                                         init_stage2_params,
                                         make_stage2_optimizer,
                                         make_stage2_step, prepare_stage2,
                                         _slice)
    from recsys.train.state import TrainState
    from recsys.parallel.mesh import build_mesh
    from recsys.eval.baselines import baseline_report, blend_sweep
    from recsys.eval.recall import (bootstrap_mean_ci, paired_delta_ci,
                                        target_rows)

    root = cfg.data.root
    items = pd.read_parquet(f"{root}/items.parquet")
    users = pd.read_parquet(f"{root}/users.parquet")
    tx = pd.read_parquet(f"{root}/transactions.parquet")
    log("world loaded")
    data = prepare_stage2(cfg, items, users, tx)
    log("stage-2 tensors ready")
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    aligned, _ = align_rows(mat[1:], ids[1:], data["item_map"].ids, fill="random")
    pretrained = np.concatenate([np.zeros((1, mat.shape[1]), np.float32), aligned])
    tens = data["tensors"]
    n = tens["input_ids"].shape[0]
    bs = min(cfg.user_train.batch_size, max(n - n % 8, 8))
    sample = _slice(tens, np.arange(min(bs, n)))
    params, models = init_stage2_params(cfg, len(data["item_map"]) + 1,
                                        pretrained, jax.random.PRNGKey(0), sample)
    store = CheckpointStore(f"{root}/ckpt_user", maximize=True)
    tmpl = TrainState.create(params, make_stage2_optimizer(cfg, params,
                                                           max(n // bs, 1)))
    restored, entry = store.restore_best(tmpl)
    params = restored.params
    log(f"restored best ckpt: {entry.get('metric')}")
    mesh = build_mesh(cfg.mesh)
    _, uv_fn = make_stage2_step(cfg, models, data["side"], data["logq"])

    ks = (20, 100)
    k1 = 100
    rows = target_rows(tens["user_ids"], data["targets_idx"])
    sub = {"user_ids": [tens["user_ids"][r] for r in rows],
           "input_ids": tens["input_ids"][rows],
           "target_ids": tens["target_ids"][rows]}
    metrics = {"command": "eval_cpu", "ks": list(ks)}
    log(f"baselines over {len(rows)} target users...")
    metrics["baselines"] = baseline_report(sub, data["logq"],
                                           data["targets_idx"], ks=ks,
                                           item_matrix=pretrained,
                                           per_user_k=k1)
    base_pu = metrics["baselines"].pop("_per_user")
    log("baselines done; user forwards...")
    uvecs, uids = collect_user_vectors(cfg, params, uv_fn, data, mesh, bs,
                                       rows=rows)
    log("forwards done; blend sweep...")
    hist = np.concatenate([tens["input_ids"][rows],
                           tens["target_ids"][rows][:, -1:]], 1)
    blend = blend_sweep(uvecs, np.asarray(params["item"]["item_matrix"]),
                        data["logq"], hist, uids, data["targets_idx"],
                        ks=ks, alphas=(0.0, 0.3), betas=(0.0, 1.0),
                        device=False, per_user_k=k1)
    blend_pu = blend.pop("_per_user")
    metrics["recall@20"] = blend["table"]["a0.0_b0.0"]["recall@20"]
    metrics["recall@100"] = blend["table"]["a0.0_b0.0"]["recall@100"]
    metrics["n_eval"] = blend["table"]["a0.0_b0.0"]["n_eval"]
    metrics["blend"] = {"best": blend["best"],
                        "best_metrics": blend["best_metrics"],
                        "model_only": blend["table"]["a0.0_b0.0"],
                        "grid": "reduced (alphas 0/0.3, betas 0/1)"}
    log("blend done; significance...")
    if base_pu["uids"] == blend_pu["uids"]:
        rep, pop = base_pu["repurchase"], base_pu["popularity"]
        sig = {"k": k1,
               "model_only": bootstrap_mean_ci(blend_pu["model_only"]),
               "blend_best": bootstrap_mean_ci(blend_pu["best"]),
               "repurchase": bootstrap_mean_ci(rep),
               "model_vs_repurchase": paired_delta_ci(
                   blend_pu["model_only"], rep),
               "model_vs_popularity": paired_delta_ci(
                   blend_pu["model_only"], pop),
               "blend_vs_repurchase": paired_delta_ci(blend_pu["best"], rep)}
        if "content_profile" in base_pu:
            sig["model_vs_content_profile"] = paired_delta_ci(
                blend_pu["model_only"], base_pu["content_profile"])
        metrics["significance"] = sig
    with open("artifacts/quality_hm/eval_cpu.json", "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps({k: metrics[k] for k in
                      ("recall@100", "blend", "significance") if k in metrics})
          [:400])
    log("DONE")


if __name__ == "__main__":
    main()
