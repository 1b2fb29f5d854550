"""Hybrid tower + ensemble evaluators."""

import numpy as np
import pytest

import jax

from recsys.config import (
    Config, DataConfig, MeshConfig, UserTowerConfig, UserTrainConfig, VocabConfig)
from recsys.data.synthetic import generate_dataset
from recsys.eval.ensemble import (
    alpha_sweep, count_mix_ensemble, rrf_ensemble, weighted_score_ensemble)
from recsys.parallel.mesh import build_mesh
from recsys.train import hybrid as H
from recsys.train import sasrec

CFG = Config(
    data=DataConfig(num_items=100, num_users=50, days=50, seed=13),
    vocab=VocabConfig(num_hash_buckets=50),
    user_tower=UserTowerConfig(max_len=10, num_layers=1),
    user_train=UserTrainConfig(batch_size=16, epochs=2, eval_ks=(5, 20),
                               steps_per_epoch_min=1),
)


@pytest.fixture(scope="module")
def stage2_data():
    items, users, tx = generate_dataset(CFG.data)
    return sasrec.prepare_stage2(CFG, items, users, tx)


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshConfig(num_data=4, num_model=1), jax.devices()[:4])


def test_ensemble_primitives():
    a = np.array([[1, 2, 3, 4]])
    b = np.array([[3, 5, 6, 7]])
    # count-mix alpha=0.5 over k=4: first 2 of a, then b dedup -> [1,2,3,5]
    fused = count_mix_ensemble(a, b, 4, 0.5)
    np.testing.assert_array_equal(fused[0], [1, 2, 3, 5])
    # weighted: shared candidate 3 gets both contributions
    sa = np.array([[4.0, 3.0, 2.0, 1.0]])
    sb = np.array([[4.0, 3.0, 2.0, 1.0]])
    w = weighted_score_ensemble(a, sa, b, sb, 4, 0.5)
    assert 3 in w[0][:2]  # appears in both lists -> high fused score
    r = rrf_ensemble(a, b, 4, k_rrf=10)
    assert r[0][0] == 3  # rank-1+rank-1... no: 3 is rank2 in a + rank0 in b
    # top-1 ids of each list tie; shared item 3 accumulates two terms and wins


def _dict_weighted(idx_a, sc_a, idx_b, sc_b, k, alpha):
    """Brute-force per-row dict reference (the reference's own algorithm:
    pool dict keyed by id in insertion order, stable sort by -score)."""
    B = idx_a.shape[0]
    out = np.full((B, k), -1, dtype=idx_a.dtype)
    for r in range(B):
        def norm(s):
            lo, hi = float(s.min()), float(s.max())
            return (s - lo) / (hi - lo) if hi > lo else np.ones_like(s)
        pool: dict = {}
        for i, s in zip(idx_a[r], norm(sc_a[r].astype(np.float64))):
            pool[int(i)] = pool.get(int(i), 0.0) + alpha * s
        for i, s in zip(idx_b[r], norm(sc_b[r].astype(np.float64))):
            pool[int(i)] = pool.get(int(i), 0.0) + (1 - alpha) * s
        ranked = sorted(pool.items(), key=lambda kv: -kv[1])[:k]
        for j, (i, _) in enumerate(ranked):
            out[r, j] = i
    return out


def _dict_rrf(idx_a, idx_b, k, k_rrf):
    B = idx_a.shape[0]
    out = np.full((B, k), -1, dtype=idx_a.dtype)
    for r in range(B):
        pool: dict = {}
        for rank, i in enumerate(idx_a[r]):
            pool[int(i)] = pool.get(int(i), 0.0) + 1.0 / (k_rrf + rank + 1)
        for rank, i in enumerate(idx_b[r]):
            pool[int(i)] = pool.get(int(i), 0.0) + 1.0 / (k_rrf + rank + 1)
        ranked = sorted(pool.items(), key=lambda kv: -kv[1])[:k]
        for j, (i, _) in enumerate(ranked):
            out[r, j] = i
    return out


def test_vectorized_fusers_match_dict_reference():
    """Vectorized fusers == per-row dict algorithm, including tie order.

    Quantized scores force many exact score ties, exercising the
    argpartition-boundary tie handling in _topk_rows."""
    rng = np.random.default_rng(7)
    B, M, k = 40, 30, 12
    idx_a = rng.integers(0, 60, size=(B, M))
    idx_b = rng.integers(0, 60, size=(B, M))
    # integer scores 0..8 min-max to exact binary fractions k/8, and binary
    # alphas: every sum is exact in f64, so tie comparisons are bit-stable
    # across both implementations
    sc_a = np.sort(rng.integers(0, 9, size=(B, M)).astype(np.float64), 1)[:, ::-1]
    sc_b = np.sort(rng.integers(0, 9, size=(B, M)).astype(np.float64), 1)[:, ::-1]
    sc_a[:, 0], sc_b[:, 0] = 8.0, 8.0  # pin range to exactly 8
    sc_a[:, -1], sc_b[:, -1] = 0.0, 0.0
    for alpha in (1.0, 0.5, 0.25, 0.0):
        got = weighted_score_ensemble(idx_a, sc_a, idx_b, sc_b, k, alpha)
        want = _dict_weighted(idx_a, sc_a, idx_b, sc_b, k, alpha)
        np.testing.assert_array_equal(got, want, err_msg=f"alpha={alpha}")
    got = rrf_ensemble(idx_a, idx_b, k, k_rrf=20)
    want = _dict_rrf(idx_a, idx_b, k, 20)
    np.testing.assert_array_equal(got, want)
    # constant-score row: min-max range 0 -> all normalize to 1 (both impls)
    ca = np.ones((2, M))
    got = weighted_score_ensemble(idx_a[:2], ca, idx_b[:2], ca, k, 0.5)
    want = _dict_weighted(idx_a[:2], ca, idx_b[:2], ca, k, 0.5)
    np.testing.assert_array_equal(got, want)


def test_device_fusers_match_host_backend():
    """The jitted device sweep == the host numpy fusers on all three
    methods (distinct scores, so f32-vs-f64 tie handling can't differ),
    including chunk padding (B not a multiple of chunk) and the ragged
    alpha grid."""
    from recsys.eval.ensemble import _alpha_sweep_device

    rng = np.random.default_rng(3)
    B, M, k = 33, 40, 12
    idx_a = rng.integers(0, 120, size=(B, M))
    idx_b = rng.integers(0, 120, size=(B, M))
    # distinct well-separated descending scores: permutation / M
    sc_a = np.sort(rng.permutation(B * M).astype(np.float64).reshape(B, M),
                   1)[:, ::-1]
    sc_b = np.sort(rng.permutation(B * M).astype(np.float64).reshape(B, M),
                   1)[:, ::-1]
    user_ids = [f"u{i}" for i in range(B)]
    targets = {u: {int(idx_a[i, 0]), int(idx_b[i, 3])}
               for i, u in enumerate(user_ids)}
    alphas = (1.0, 0.5, 0.0)
    for method in ("count_mix", "weighted", "rrf"):
        host = alpha_sweep(method, (idx_a, sc_a), (idx_b, sc_b), user_ids,
                           targets, ks=(4, k), alphas=alphas, device=False)
        dev = _alpha_sweep_device(method, (idx_a, sc_a), (idx_b, sc_b),
                                  user_ids, targets, ks=(4, k),
                                  alphas=alphas, k_rrf=200, chunk=16)
        assert host["table"] == dev["table"], method
        assert host["best_alpha"] == dev["best_alpha"], method


def test_alpha_sweep_reports_best():
    rng = np.random.default_rng(0)
    # model A is perfect for half the users, model B for the other half
    user_ids = [f"u{i}" for i in range(10)]
    targets = {u: {i + 1} for i, u in enumerate(user_ids)}
    idx_a = rng.integers(50, 90, size=(10, 8))
    idx_b = rng.integers(50, 90, size=(10, 8))
    for i in range(5):
        idx_a[i, 0] = i + 1
    for i in range(5, 10):
        idx_b[i, 0] = i + 1
    sc = np.tile(np.arange(8, 0, -1, dtype=float), (10, 1))
    rep = alpha_sweep("weighted", (idx_a, sc), (idx_b, sc), user_ids, targets,
                      ks=(2, 4), alphas=(1.0, 0.5, 0.0))
    # only fusion finds both halves
    assert rep["table"][0.5]["recall@4"] > rep["table"][1.0]["recall@4"]
    assert rep["table"][0.5]["recall@4"] > rep["table"][0.0]["recall@4"]
    assert rep["best_alpha"] == 0.5


def test_hybrid_training_and_ensemble(stage2_data, mesh, tmp_path):
    rng = np.random.default_rng(1)
    n_pad = len(stage2_data["item_map"]) + 1
    content = rng.normal(0, 0.1, (n_pad, 128)).astype(np.float32)
    content[0] = 0
    gnn_items_raw = rng.normal(0, 0.1, (80, 16)).astype(np.float32)
    gnn_ids = [f"it{i:06d}" for i in range(80)]  # partial coverage
    gnn_items = H.align_gnn_to_catalog(gnn_items_raw, gnn_ids, stage2_data["item_map"])
    assert gnn_items.shape == (n_pad, 16)
    uids = stage2_data["tensors"]["user_ids"]
    gnn_users_raw = rng.normal(0, 0.1, (len(uids), 16)).astype(np.float32)
    gnn_users = H.align_gnn_users(gnn_users_raw, uids, uids)

    state, history, (model, uv_fn, im_fn) = H.train_hybrid(
        CFG, stage2_data, content, gnn_items, gnn_users, mesh, str(tmp_path))
    assert len(history) == 2
    assert all(np.isfinite(m["recall@20"]) for m in history)

    # ensemble report: hybrid vs a fake gnn retrieval
    t = stage2_data["tensors"]
    n = t["input_ids"].shape[0]
    bs = 16
    uvecs = []
    for s in range(0, n - n % bs, bs):
        idx = np.arange(s, s + bs)
        import jax.numpy as jnp
        batch = {k: jnp.asarray(v[idx]) for k, v in t.items() if k != "user_ids"}
        uvecs.append(np.asarray(uv_fn(state.params, batch, jnp.asarray(gnn_users[idx]))))
    uvecs = np.concatenate(uvecs)
    user_ids = t["user_ids"][: len(uvecs)]
    ia, sa = H.topm_for_model(uvecs, np.asarray(im_fn(state.params)), 20,
                              normalize_items=False)
    ib, sb = ia.copy(), sa.copy()  # degenerate second model, mechanics only
    rep = H.ensemble_report((ia, sa), (ib, sb), user_ids,
                            stage2_data["targets_idx"], ks=(5, 20))
    assert "count_mix" in rep and "rrf" in rep
    assert rep["standalone_a"]["n_eval"] > 0
    # identical models -> fusion equals standalone
    assert rep["rrf"]["best"]["recall@20"] == pytest.approx(
        rep["standalone_a"]["recall@20"], abs=1e-9)
