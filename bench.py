"""Benchmark vs the reference's published throughput anchor.

Prints one JSON line per anchor: {"metric", "value", "unit", "vs_baseline"}.
The LAST line is the headline anchor (LightGCL vs the reference's only
published throughput number).

Anchor 1 (headline): the only throughput trace the reference publishes is
LightGCL training at 1.50 it/s with batch 8192 on a CUDA GPU — 12 288
examples/s — with full-graph propagation every step over its
~11.3M-interaction H&M graph (`gnn_model/v1_lightgcl.py:645`; BASELINE.md).
This bench reproduces that workload shape on one device: a synthetic
bipartite graph with the same edge count (11.3M interactions -> 22.6M
directed edges, ``ops/graph.random_graph``), dim-64 embeddings, 2-layer
segment-sum propagation + rank-5 SVD global view, BPR + SSL + reg, batch
8192 — and reports training examples/s.

Anchor 2: the full stage-2 SASRec training step at the reference config
(bs 768, L=50, 47k-item catalog, LogQ-corrected sampled softmax + DuoRec).
The reference publishes no stage-2 throughput, so it has no baseline.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

REFERENCE_EXAMPLES_PER_S = 12288.0  # LightGCL, batch 8192 @ 1.50 it/s (CUDA)

BATCH = 8192
MEASURE_STEPS = 30
SASREC_BATCH = 768
SASREC_LEN = 50
SASREC_STEPS = 20


def _sasrec_synthetic(rng, cfg):
    """Reference-shape synthetic stage-2 tensors (compute is value-blind)."""
    from recsys.ops.graph import ANCHOR_ITEMS as N

    B, L = SASREC_BATCH, SASREC_LEN
    utc = cfg.user_tower
    batch = {
        "input_ids": rng.integers(1, N + 1, (B, L)).astype(np.int32),
        "target_ids": rng.integers(1, N + 1, (B, L)).astype(np.int32),
        "time_buckets": rng.integers(0, utc.num_time_buckets, (B, L)).astype(np.int32),
        "seq_mask": np.ones((B, L), np.int32),
        "user_buckets": rng.integers(0, 10, (B, utc.static_bucket_fields)).astype(np.int32),
        "user_cats": rng.integers(0, 2, (B, utc.static_cat_fields)).astype(np.int32),
        "user_cont": rng.normal(0, 1, (B, utc.static_cont_fields)).astype(np.float32),
    }
    side = rng.integers(0, 1000, (N + 1, utc.num_side_fields)).astype(np.int32)
    logq = rng.normal(-8.0, 1.0, N + 1).astype(np.float32)
    return batch, side, logq


def bench_sasrec():
    from recsys.config import Config, DataConfig
    from recsys.ops.graph import ANCHOR_ITEMS
    from recsys.train import sasrec
    from recsys.train.state import TrainState

    rng = np.random.default_rng(0)
    cfg = Config(data=DataConfig())
    batch_np, side, logq = _sasrec_synthetic(rng, cfg)
    params, models = sasrec.init_stage2_params(
        cfg, ANCHOR_ITEMS + 1, None, jax.random.PRNGKey(0), batch_np)
    tx = sasrec.make_stage2_optimizer(cfg, params, steps_per_epoch=1787)
    state = TrainState.create(params, tx)
    step_fn, _ = sasrec.make_stage2_step(cfg, models, side, logq)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    keys = [jax.random.PRNGKey(i) for i in range(SASREC_STEPS + 3)]
    for k in keys[:3]:  # warmup/compile
        state, aux = step_fn(state, batch, k)
    jax.block_until_ready((state, aux))
    t0 = time.perf_counter()
    for k in keys[3:]:
        state, aux = step_fn(state, batch, k)
    jax.block_until_ready((state, aux))
    dt = time.perf_counter() - t0
    eps = SASREC_STEPS * SASREC_BATCH / dt
    step_ms = 1000.0 * dt / SASREC_STEPS
    print(json.dumps({
        "metric": "sasrec_train_examples_per_s",
        "value": round(eps, 1),
        "unit": (f"examples/s (bs {SASREC_BATCH}, L={SASREC_LEN}, 47k "
                 f"catalog; step {step_ms:.1f} ms)"),
        "vs_baseline": None,
    }))


def main():
    import optax

    from recsys.config import GNNConfig
    from recsys.ops.graph import random_graph
    from recsys.train.gnn import make_gnn_step, select_propagation
    from recsys.train.state import TrainState

    rng = np.random.default_rng(0)
    graph, eu, ei = random_graph(rng)

    cfg = GNNConfig()  # dim 64, 2 layers, batch 8192 — the reference config
    prop_fn, prop_args = select_propagation(cfg, graph, graph.num_nodes)
    params = {
        "user_emb": jnp.asarray(rng.normal(0, 0.1, (graph.num_users, cfg.emb_dim)),
                                jnp.float32),
        "item_emb": jnp.asarray(rng.normal(0, 0.1, (graph.num_items, cfg.emb_dim)),
                                jnp.float32),
    }
    state = TrainState.create(params, optax.adam(cfg.lr))
    step_fn = make_gnn_step(prop_fn, graph, cfg, prop_args)

    # pre-generate batches (uniform negatives; rejection sampling is host-side
    # and off the measured path in real training too)
    batches = []
    for s in range(MEASURE_STEPS + 3):
        idx = rng.integers(0, len(eu), BATCH)
        batches.append((jnp.asarray(eu[idx], jnp.int32),
                        jnp.asarray(ei[idx], jnp.int32),
                        jnp.asarray(rng.integers(0, graph.num_items, BATCH),
                                    jnp.int32)))

    for b in batches[:3]:  # warmup/compile
        state, aux = step_fn(state, *b)
    jax.block_until_ready((state, aux))

    t0 = time.perf_counter()
    for b in batches[3:]:
        state, aux = step_fn(state, *b)
    jax.block_until_ready((state, aux))
    dt = time.perf_counter() - t0

    eps = MEASURE_STEPS * BATCH / dt
    print(json.dumps({
        "metric": "lightgcl_train_examples_per_s",
        "value": round(eps, 1),
        "unit": "examples/s (batch 8192, 22.6M-edge full-graph step)",
        "vs_baseline": round(eps / REFERENCE_EXAMPLES_PER_S, 2),
    }))


if __name__ == "__main__":
    import sys

    from recsys.runtime import enable_compile_cache

    enable_compile_cache()
    if "--profile" in sys.argv:
        from recsys.train.metrics import profile_trace

        with profile_trace("artifacts/trace"):
            main()
    else:
        if "--skip-sasrec" not in sys.argv:
            bench_sasrec()
        main()  # headline anchor last
