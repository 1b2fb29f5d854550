"""Eval helpers: generic retrieval evaluator, t-SNE monitor."""

import numpy as np

import jax.numpy as jnp

from recsys.eval.recall import evaluate_retrieval, recall_at_ks


def test_recall_at_ks_denominator_semantics():
    # user u0 has targets {1,2}; u1 absent from ground truth -> dropped
    topk = np.array([[1, 5, 6], [9, 9, 9]])
    out = recall_at_ks(topk, ["u0", "u1"], {"u0": {1, 2}}, ks=(1, 3))
    assert out["n_eval"] == 1
    assert out["recall@1"] == 0.5 and out["recall@3"] == 0.5


def test_evaluate_retrieval_pipeline():
    rng = np.random.default_rng(0)
    N, D = 30, 8
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0

    def forward(batch):
        return jnp.asarray(items[batch])  # users ARE item vectors

    batches = [(np.array([3, 7]), ["u3", "u7"]), (np.array([11]), ["u11"])]
    targets = {"u3": {3}, "u7": {7}, "u11": {11}}
    out = evaluate_retrieval(forward, batches, jnp.asarray(items), targets,
                             ks=(1, 5))
    assert out["n_eval"] == 3 and out["recall@1"] == 1.0


def test_tsne_scatter(tmp_path):
    from recsys.eval.viz import tsne_scatter

    rng = np.random.default_rng(1)
    emb = np.concatenate([rng.normal(0, 1, (40, 16)),
                          rng.normal(6, 1, (40, 16))]).astype(np.float32)
    labels = ["a"] * 40 + ["b"] * 40
    coords = tsne_scatter(emb, str(tmp_path / "tsne.png"), labels=labels,
                          sample=60, perplexity=10)
    assert coords.shape == (60, 2)
    assert (tmp_path / "tsne.png").exists()


def test_baseline_popularity_and_repurchase():
    from recsys.eval.baselines import baseline_report, repurchase_topk

    # logq: item 3 most popular, then 1, then 2; PAD row 0 at -20
    logq = np.array([-20.0, -1.0, -2.0, -0.5])
    tensors = {
        "user_ids": np.array(["a", "b"]),
        # user a bought item 2 twice (repurchase should lead with 2);
        # user b has no history beyond padding + last target
        "input_ids": np.array([[0, 2, 2], [0, 0, 0]]),
        "target_ids": np.array([[2, 2, 1], [0, 0, 3]]),
    }
    targets = {"a": {2}, "b": {3}}
    rep = baseline_report(tensors, logq, targets, ks=(1, 2))
    # popularity top-1 is item 3: hits b, misses a
    assert rep["popularity"]["recall@1"] == 0.5
    # repurchase top-1: a -> its own item 2 (hit); b -> history {3} (hit)
    assert rep["repurchase"]["recall@1"] == 1.0
    assert rep["popularity"]["n_eval"] == 2

    # explicit ranking check: count beats recency, popularity pads the tail
    hist = [np.array([1, 2, 2])]
    idx = repurchase_topk(hist, logq, 3)
    assert idx[0].tolist() == [2, 1, 3]


def test_content_profile_baseline():
    from recsys.eval.baselines import baseline_report, content_profile_topk

    # two orthogonal content clusters; each user's history sits in one
    # cluster and their target is the unseen item of the SAME cluster
    items = np.zeros((5, 4), np.float32)          # PAD + 4 items
    items[1] = [1, 0, 0, 0]; items[2] = [0.9, 0.1, 0, 0]   # cluster A
    items[3] = [0, 0, 1, 0]; items[4] = [0, 0, 0.9, 0.1]   # cluster B
    tensors = {
        "user_ids": np.array(["a", "b"]),
        "input_ids": np.array([[0, 1, 1], [0, 3, 3]]),
        "target_ids": np.array([[1, 1, 1], [3, 3, 3]]),
    }
    targets = {"a": {2}, "b": {4}}
    logq = np.array([-20.0, -1.0, -5.0, -1.0, -5.0])  # popularity: 1 and 3
    rep = baseline_report(tensors, logq, targets, ks=(1, 2),
                          item_matrix=items)
    # popularity@2 recommends {1,3} -> zero recall; content profile ranks
    # the same-cluster unseen item right after the seen one -> recall@2 = 1
    assert rep["popularity"]["recall@2"] == 0.0
    assert rep["content_profile"]["recall@2"] == 1.0
    assert rep["content_profile_recency"]["recall@2"] == 1.0

    # recency weighting: late history dominates the profile
    hist = [np.array([3, 3, 3, 1])]   # mostly cluster B, latest is cluster A
    idx_flat = content_profile_topk(hist, items, 1)
    idx_rec = content_profile_topk(hist, items, 1, half_life=0.5)
    assert idx_flat[0, 0] in (3, 4)   # plain mean stays in cluster B
    assert idx_rec[0, 0] in (1, 2)    # recency-weighted flips to cluster A

    # empty history: zero profile must not crash; PAD never recommended
    idx = content_profile_topk([np.zeros(3, np.int64)], items, 2)
    assert (idx[0] != 0).all()


def test_blend_sweep_recovers_prior_signal():
    from recsys.eval.baselines import blend_sweep

    rng = np.random.default_rng(0)
    B, N, D = 6, 40, 8
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0
    # user vectors point at the WRONG items; popularity prior points at the
    # true targets -> alpha > 0 must win the sweep
    uvecs = np.stack([items[20 + r] for r in range(B)])
    logq = np.full(N + 1, -10.0)
    logq[0] = -20.0
    targets = {f"u{r}": {r + 1} for r in range(B)}
    logq[1:B + 1] = -1.0  # targets are the popular items
    hist = np.zeros((B, 3), np.int64)
    out = blend_sweep(uvecs, items, logq, hist, [f"u{r}" for r in range(B)],
                      targets, ks=(1, 5), alphas=(0.0, 0.9), betas=(0.0,))
    assert out["table"]["a0.9_b0.0"]["recall@5"] > \
        out["table"]["a0.0_b0.0"]["recall@5"]
    # seen bonus: history containing the target dominates everything
    hist[:, 0] = np.arange(1, B + 1)
    out2 = blend_sweep(uvecs, items, logq, hist, [f"u{r}" for r in range(B)],
                       targets, ks=(1, 5), alphas=(0.0,), betas=(1.0,))
    assert out2["table"]["a0.0_b1.0"]["recall@1"] == 1.0


def test_topk_scores_prior():
    from recsys.eval.recall import topk_scores

    items = np.zeros((5, 4), np.float32)
    items[1:] = np.eye(4)
    u = np.zeros((2, 4), np.float32)
    u[:, 0] = 1.0  # cosine favors item 1
    prior = np.array([0.0, 0.0, 10.0, 0.0, 0.0], np.float32)  # prior: item 2
    _, idx = topk_scores(jnp.asarray(u), jnp.asarray(items), 1,
                         prior=jnp.asarray(prior))
    assert idx.tolist() == [[2], [2]]


def test_blend_sweep_device_backend_matches_host():
    """The jitted device sweep must produce the same recall table as the
    chunked host-numpy sweep (same math; only tie order may differ)."""
    from recsys.eval.baselines import blend_sweep

    rng = np.random.default_rng(3)
    B, N, D = 37, 60, 8   # odd B exercises the fixed-shape batch padding
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0
    uvecs = rng.normal(size=(B, D)).astype(np.float32)
    logq = rng.normal(-5, 1, N + 1).astype(np.float32)
    logq[0] = -20.0
    hist = rng.integers(1, N + 1, (B, 4))
    uids = [f"u{r}" for r in range(B)]
    targets = {u: set(rng.integers(1, N + 1, 3).tolist()) for u in uids}
    kw = dict(ks=(5, 20), alphas=(0.0, 0.3, 0.9), betas=(0.0, 1.0))
    host = blend_sweep(uvecs, items, logq, hist, uids, targets,
                       device=False, **kw)
    dev = blend_sweep(uvecs, items, logq, hist, uids, targets,
                      device=True, **kw)
    assert host["best"] == dev["best"]
    for combo, m in host["table"].items():
        for k, v in m.items():
            assert abs(dev["table"][combo][k] - v) < 1e-9, (combo, k)


def test_per_user_recall_and_bootstrap():
    from recsys.eval.recall import (bootstrap_mean_ci, paired_delta_ci,
                                        recall_per_user)

    topk = np.array([[1, 2], [3, 4], [5, 6]], np.int64)
    targets = {"a": {1, 9}, "c": {5, 6}}  # "b" has no targets -> dropped
    vals, kept = recall_per_user(topk, ["a", "b", "c"], targets, k=2)
    assert kept == ["a", "c"]
    assert vals.tolist() == [0.5, 1.0]

    # CI brackets the mean; degenerate (constant) values give a zero-width CI
    ci = bootstrap_mean_ci(np.full(50, 0.25), n_boot=200)
    assert ci["mean"] == ci["lo"] == ci["hi"] == 0.25
    rng = np.random.default_rng(0)
    x = rng.uniform(size=500)
    ci = bootstrap_mean_ci(x, n_boot=500)
    assert ci["lo"] < ci["mean"] < ci["hi"]
    assert ci["n"] == 500

    # paired delta: a clearly better system gets p_improve ~ 1
    a = x + 0.2
    d = paired_delta_ci(a, x, n_boot=500)
    assert abs(d["delta"] - 0.2) < 1e-9
    assert d["p_improve"] == 1.0 and d["lo"] > 0
    # identical systems: delta 0 exactly
    d0 = paired_delta_ci(x, x, n_boot=100)
    assert d0["delta"] == 0.0 and d0["lo"] == 0.0 and d0["hi"] == 0.0
    # empty input doesn't crash
    assert bootstrap_mean_ci(np.zeros(0))["n"] == 0
    assert paired_delta_ci(np.zeros(0), np.zeros(0))["n"] == 0


def test_per_user_blocks_align_across_report_and_blend():
    """baseline_report and blend_sweep (host + device) must emit per-user
    arrays over the same users in the same order, so cmd_eval's paired
    significance tests are valid."""
    from recsys.eval.baselines import baseline_report, blend_sweep
    from recsys.eval.recall import recall_at_ks

    rng = np.random.default_rng(7)
    B, N, D, L = 23, 30, 8, 5
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0
    uvecs = rng.normal(size=(B, D)).astype(np.float32)
    logq = rng.normal(-5, 1, N + 1).astype(np.float32)
    logq[0] = -20.0
    hist = rng.integers(0, N + 1, (B, L))
    uids = [f"u{r}" for r in range(B)]
    targets = {u: set(rng.integers(1, N + 1, 2).tolist())
               for u in uids if rng.uniform() > 0.3}
    tensors = {"user_ids": uids, "input_ids": hist[:, :-1],
               "target_ids": hist[:, -1:]}
    rep = baseline_report(tensors, logq, targets, ks=(5, 20),
                          item_matrix=items, per_user_k=20)
    pu = rep["_per_user"]
    # per-user means must reproduce the aggregate recall exactly
    assert abs(pu["repurchase"].mean() - rep["repurchase"]["recall@20"]) < 1e-12
    assert len(pu["uids"]) == rep["repurchase"]["n_eval"]
    for backend in (False, True):
        bl = blend_sweep(uvecs, items, logq, hist, uids, targets,
                         ks=(5, 20), alphas=(0.0, 0.5), betas=(0.0,),
                         device=backend, per_user_k=20)
        bpu = bl["_per_user"]
        assert bpu["uids"] == pu["uids"]
        assert abs(bpu["model_only"].mean()
                   - bl["table"]["a0.0_b0.0"]["recall@20"]) < 1e-12
        assert abs(bpu["best"].mean()
                   - bl["best_metrics"]["recall@20"]) < 1e-12


def test_content_profile_device_backend_matches_host():
    from recsys.eval.baselines import content_profile_topk

    rng = np.random.default_rng(11)
    N, D = 80, 16
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0
    hists = [rng.integers(0, N + 1, rng.integers(0, 6)) for _ in range(33)]
    host = content_profile_topk(hists, items, 10, device=False)
    dev = content_profile_topk(hists, items, 10, device=True)
    # identical top-k sets where scores are continuous (non-empty history
    # after dropping PAD 0s); empty-profile rows are all-ties and the two
    # backends may pick different arbitrary sets
    checked = 0
    for r, h in enumerate(hists):
        if not (np.asarray(h) > 0).any():
            continue
        checked += 1
        assert set(host[r].tolist()) == set(dev[r].tolist()), r
    assert checked >= 20


def test_topk_scores_jitted_under_model_mesh(mesh8):
    """evaluate_stage2/hybrid_eval now wrap topk_scores in jax.jit with a
    model>1 mesh closed over (smap inside jit) — pin that this compiles and
    matches the eager sharded result."""
    import jax

    rng = np.random.default_rng(0)
    items = rng.normal(size=(64, 8)).astype(np.float32)
    items[0] = 0
    u = rng.normal(size=(16, 8)).astype(np.float32)
    from recsys.eval.recall import topk_scores

    _, eager = topk_scores(jnp.asarray(u), jnp.asarray(items), 5, mesh=mesh8)
    f = jax.jit(lambda uu, it: topk_scores(uu, it, 5, mesh=mesh8)[1])
    jitted = f(u, items)
    assert np.array_equal(np.asarray(eager), np.asarray(jitted))


def test_repurchase_topk_matches_reference_loop():
    """The vectorized popularity fill must be bit-identical to the naive
    per-user scan (count desc, recency desc head; fill skips ranked)."""
    from recsys.eval.baselines import popularity_ranking, repurchase_topk

    rng = np.random.default_rng(17)
    N, max_k = 50, 12
    logq = rng.normal(-5, 1, N + 1)
    logq[0] = -20.0
    hists = [rng.integers(0, N + 1, rng.integers(0, 30)) for _ in range(200)]
    hists.append(np.zeros(5, np.int64))                    # empty history
    hists.append(np.full(40, 7, np.int64))                 # single hot item
    got = repurchase_topk(hists, logq, max_k)

    pop = popularity_ranking(logq, max_k + max(len(h) for h in hists) + 1)
    for r, hist in enumerate(hists):
        hist = np.asarray(hist)
        hist = hist[hist > 0]
        ranked = []
        if len(hist):
            uniq, counts = np.unique(hist, return_counts=True)
            last_pos = {int(it): p for p, it in enumerate(hist)}
            ranked = [int(it) for it in sorted(
                uniq.tolist(),
                key=lambda it: (-counts[np.searchsorted(uniq, it)],
                                -last_pos[int(it)]))][:max_k]
        seen = set(ranked)
        for it in pop:
            if len(ranked) >= max_k:
                break
            if int(it) not in seen:
                ranked.append(int(it))
        want = np.zeros(max_k, np.int64)
        want[:len(ranked)] = ranked
        assert (got[r] == want).all(), r
