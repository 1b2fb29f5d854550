"""LightGCL subsystem: graph build + propagation math, training, post-hoc
propagation/export, magnitude->cosine distillation."""

import numpy as np
import pytest

import jax.numpy as jnp

from recsys.config import Config, DataConfig, DistillConfig, GNNConfig
from recsys.ops.graph import build_graph, propagate, svd_propagate
from recsys.train import gnn as G

CFG = Config(
    data=DataConfig(seed=5),
    gnn=GNNConfig(emb_dim=16, num_layers=2, svd_rank=4, batch_size=256, epochs=4,
                  lr=5e-2),
    distill=DistillConfig(hidden_dim=64, out_dim=16, epochs=1500, batch_size=128,
                          lr=3e-3),
)


@pytest.fixture(scope="module")
def tiny_graph():
    rng = np.random.default_rng(0)
    nu, ni = 40, 30
    # two communities: users 0..19 like items 0..14, users 20.. like 15..29
    edges = []
    for u in range(nu):
        block = rng.choice(15, size=6, replace=False) + (0 if u < 20 else 15)
        for i in block:
            edges.append((u, i))
    e = np.array(edges)
    graph = build_graph(e[:, 0], e[:, 1], nu, ni, svd_rank=4, pad_multiple=64)
    return graph, e[:, 0], e[:, 1]


def test_graph_normalization(tiny_graph):
    graph, u, i = tiny_graph
    # padded to multiple of 64, zero-weight pads
    assert len(graph.src) % 64 == 0
    real = graph.weight > 0
    assert real.sum() == 2 * len(np.unique(np.stack([u, i], 1), axis=0))
    # dense check: build dense normalized adjacency and compare
    n = graph.num_nodes
    dense = np.zeros((n, n))
    for s, d, w in zip(graph.src, graph.dst, graph.weight):
        dense[d, s] += w
    rng = np.random.default_rng(1)
    xr = rng.normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(propagate(jnp.asarray(xr), jnp.asarray(graph.src),
                             jnp.asarray(graph.dst), jnp.asarray(graph.weight), n)),
        dense @ xr, rtol=1e-4, atol=1e-5)
    # SVD propagation == U diag(S) V^T x and approximates dense @ x
    approx = np.asarray(svd_propagate(jnp.asarray(xr), jnp.asarray(graph.svd_u),
                                      jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v)))
    expected = graph.svd_u @ np.diag(graph.svd_s) @ graph.svd_v.T @ xr
    np.testing.assert_allclose(approx, expected, rtol=1e-4, atol=1e-5)
    # low-rank reconstruction captures a meaningful share of the energy
    err = np.linalg.norm(approx - dense @ xr) / np.linalg.norm(dense @ xr)
    assert err < 0.9


def test_bpr_sampler_rejects_positives(tiny_graph):
    graph, u, i = tiny_graph
    rng = np.random.default_rng(2)
    pos_keys = set((u * graph.num_items + i).tolist())
    for users, pos, neg in G.sample_bpr_batches(u, i, graph.num_items, 64, rng):
        assert len(users) == 64
        clashes = sum((uu * graph.num_items + nn) in pos_keys
                      for uu, nn in zip(users, neg))
        assert clashes <= 2  # rejection sampling leaves at most stragglers


def test_train_lightgcl_learns(tiny_graph, tmp_path):
    graph, u, i = tiny_graph
    state = G.train_lightgcl(CFG, graph, u, i, str(tmp_path))
    import json
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if r["kind"] == "epoch"]
    assert losses[-1] < losses[0]

    check = G.gnn_propagation_check(state.params, graph)
    assert check["ok"]

    # trained communities: user 0 should score its block's items higher
    fu, fi = G.final_embeddings(state.params, graph)
    scores = fu @ fi.T
    in_block = scores[:20, :15].mean()
    out_block = scores[:20, 15:].mean()
    assert in_block > out_block

    # export + sidecars
    uu, ii = G.export_gnn_artifacts(state.params, graph,
                                    [f"us{k}" for k in range(40)],
                                    [f"it{k}" for k in range(30)],
                                    str(tmp_path / "gnn"))
    from recsys.train.checkpoint import load_array_with_ids
    arr, ids, meta = load_array_with_ids(str(tmp_path / "gnn_items"))
    assert arr.shape == (30, 16) and meta["space"] == "gnn_dot"

    # resume path: one more epoch on top of the stored state
    cfg2 = Config(**{**CFG.__dict__, "gnn": GNNConfig(
        emb_dim=16, num_layers=2, svd_rank=4, batch_size=256, epochs=5, lr=5e-2)})
    state2 = G.train_lightgcl(cfg2, graph, u, i, str(tmp_path), resume=True)
    # fine-tune path: fresh cosine optimizer over restored params
    state3 = G.train_lightgcl(cfg2, graph, u, i, str(tmp_path), fine_tune=True)


def test_distillation_folds_magnitude(tiny_graph, tmp_path):
    """Student cosine*exp(scale) must approximate teacher dot scores, i.e.
    popularity (magnitude) information survives in a cosine-only space."""
    rng = np.random.default_rng(3)
    tu = rng.normal(size=(50, 16)).astype(np.float32)
    ti = rng.normal(size=(40, 16)).astype(np.float32)
    ti[:5] *= 4.0  # popular items: big magnitude
    state, model = G.train_distill(CFG, tu, ti, str(tmp_path))
    si = G.distilled_vectors(state, model, ti)
    np.testing.assert_allclose(np.linalg.norm(si, axis=1), 1.0, rtol=1e-4)
    su = G.distilled_vectors(state, model, tu)
    scale = float(np.asarray(state.params["logit_scale"]))
    pred = (su @ si.T) * np.exp(scale)
    teach = tu @ ti.T
    corr = np.corrcoef(pred.ravel(), teach.ravel())[0, 1]
    assert corr > 0.8


def test_propagate_chunked_matches_naive():
    """Edge-chunked propagation == single-shot (modulo fp32 sum order);
    the export path depends on this at graphs whose (E, D) message array
    exceeds HBM."""
    import jax.numpy as jnp

    from recsys.ops.graph import propagate, propagate_chunked

    rng = np.random.default_rng(0)
    n, e = 200, 5000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    naive = propagate(jnp.asarray(x), jnp.asarray(src.astype(np.int32)),
                      jnp.asarray(dst.astype(np.int32)), jnp.asarray(w), n)
    chunked = propagate_chunked(x, src, dst, w, n, edge_chunk=512)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(naive),
                               rtol=2e-5, atol=2e-5)


def test_distill_hard_mining_path(tmp_path):
    """cfg.distill.hard_frac > 0 mines the item batch from the user
    batch's teacher top-k (the fidelity-collapse fix arm,
    scripts/distill_scale_sweep.py); the trained student must still fold
    magnitude into angles."""
    import dataclasses

    from recsys.config import DistillConfig

    rng = np.random.default_rng(4)
    tu = rng.normal(size=(50, 16)).astype(np.float32)
    ti = rng.normal(size=(40, 16)).astype(np.float32)
    ti[:5] *= 4.0
    cfg = dataclasses.replace(CFG, distill=DistillConfig(
        hidden_dim=64, out_dim=16, epochs=300, batch_size=32,
        steps_per_epoch=1, hard_frac=0.5, hard_k=8))
    state, model = G.train_distill(cfg, tu, ti, str(tmp_path))
    si = G.distilled_vectors(state, model, ti)
    su = G.distilled_vectors(state, model, tu)
    np.testing.assert_allclose(np.linalg.norm(si, axis=1), 1.0, rtol=1e-4)
    scale = float(np.asarray(state.params["logit_scale"]))
    pred = (su @ si.T) * np.exp(scale)
    corr = np.corrcoef(pred.ravel(), (tu @ ti.T).ravel())[0, 1]
    assert corr > 0.6
