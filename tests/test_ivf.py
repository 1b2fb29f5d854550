"""IVF approximate retrieval: build invariants, exactness at full probe,
cluster recall, and the approx top-k method switch."""

import numpy as np
import jax.numpy as jnp

from recsys.ops.ivf import build_ivf, ivf_search, kmeans


def _clustered_catalog(rng, n_clusters=8, per=40, dim=16):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    rows = []
    for c in centers:
        rows.append(c + 0.05 * rng.normal(size=(per, dim)).astype(np.float32))
    mat = np.concatenate([np.zeros((1, dim), np.float32),
                          np.concatenate(rows)])
    return mat, centers


def test_build_partitions_catalog_exactly_once():
    rng = np.random.default_rng(0)
    mat, _ = _clustered_catalog(rng)
    n = mat.shape[0] - 1
    idx = build_ivf(mat, nlist=8, iters=5, seed=0)
    ids = np.asarray(idx.bucket_ids)
    nonzero = ids[ids > 0]
    assert sorted(nonzero.tolist()) == list(range(1, n + 1))
    assert idx.centroids.shape == (8, mat.shape[1])
    # unit bucket vectors on real slots, zeros on padding
    vecs = np.asarray(idx.bucket_vecs)
    norms = np.linalg.norm(vecs, axis=-1)
    assert np.allclose(norms[ids > 0], 1.0, atol=1e-5)
    assert np.allclose(norms[ids == 0], 0.0)


def test_full_probe_matches_exact_topk():
    rng = np.random.default_rng(1)
    mat, _ = _clustered_catalog(rng, n_clusters=4, per=25)
    idx = build_ivf(mat, nlist=4, iters=5, seed=0)
    q = rng.normal(size=(6, mat.shape[1])).astype(np.float32)
    vals, got = ivf_search(idx, jnp.asarray(q), 10, idx.nlist)
    items = mat / np.clip(np.linalg.norm(mat, axis=-1, keepdims=True),
                          1e-12, None)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    scores = qn @ items.T
    scores[:, 0] = -np.inf
    want = np.argsort(-scores, axis=1)[:, :10]
    # identical score multisets (ties may reorder indices)
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(scores, want, 1), atol=1e-5)
    assert (np.asarray(got) > 0).all()


def test_low_probe_high_recall_on_clustered_data():
    rng = np.random.default_rng(2)
    mat, centers = _clustered_catalog(rng, n_clusters=8, per=40)
    idx = build_ivf(mat, nlist=8, iters=10, seed=0)
    # queries near cluster centers: 1 probe should already find the
    # cluster's items
    q = centers + 0.01 * rng.normal(size=centers.shape).astype(np.float32)
    _, got = ivf_search(idx, jnp.asarray(q), 10, 2)
    items = mat / np.clip(np.linalg.norm(mat, axis=-1, keepdims=True),
                          1e-12, None)
    scores = (q / np.linalg.norm(q, axis=-1, keepdims=True)) @ items.T
    scores[:, 0] = -np.inf
    want = np.argsort(-scores, axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10.0
                      for a, b in zip(np.asarray(got), want)])
    assert recall > 0.9


def test_capacity_spill_keeps_rectangular_buckets():
    rng = np.random.default_rng(3)
    # all points in ONE tight cluster: greedy fill must spill across
    # buckets without losing items
    base = rng.normal(size=(1, 12)).astype(np.float32)
    mat = np.concatenate([np.zeros((1, 12), np.float32),
                          base + 0.01 * rng.normal(size=(64, 12)).astype(np.float32)])
    idx = build_ivf(mat, nlist=4, iters=3, seed=0, balance=1.1)
    ids = np.asarray(idx.bucket_ids)
    assert sorted(ids[ids > 0].tolist()) == list(range(1, 65))


def test_kmeans_reseeds_empty_clusters():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(10, 8)).astype(np.float32)
    cent = kmeans(x, nlist=10, iters=3, seed=0)
    assert cent.shape == (10, 8)
    assert np.isfinite(cent).all()


def test_topk_scores_approx_method():
    from recsys.eval.recall import topk_scores

    rng = np.random.default_rng(5)
    items = rng.normal(size=(101, 8)).astype(np.float32)
    items[0] = 0
    u = rng.normal(size=(4, 8)).astype(np.float32)
    ve, ie = topk_scores(jnp.asarray(u), jnp.asarray(items), 5)
    va, ia = topk_scores(jnp.asarray(u), jnp.asarray(items), 5,
                         method="approx", recall_target=0.95)
    assert ia.shape == (4, 5)
    # PAD row never surfaces
    assert (np.asarray(ia) != 0).all()
    # approx at small N recovers essentially the exact set
    overlap = np.mean([len(set(np.asarray(ie)[r]) & set(np.asarray(ia)[r])) / 5
                       for r in range(4)])
    assert overlap >= 0.8


def test_ivf_device_index_serving_interface(tmp_path):
    from recsys.serve.ann import IvfIndex, VectorIndex

    rng = np.random.default_rng(6)
    mat, _ = _clustered_catalog(rng, n_clusters=4, per=30, dim=12)
    vecs = mat[1:]
    ids = (np.arange(len(vecs)) + 1000).astype(np.int64)  # external ids
    ivf = IvfIndex(12, nlist=4, nprobe=4)
    exact = VectorIndex(12, cosine=True)
    ivf.add(ids, vecs)
    exact.add(ids, vecs)
    q = vecs[:5] + 0.01 * rng.normal(size=(5, 12)).astype(np.float32)
    gi, gs = ivf.topk(q, 10)
    ei, _ = exact.topk(q, 10)
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(gi, ei)])
    assert overlap == 1.0            # full probe == exact
    assert (gi != -1).all() and (gs[:, 0] >= gs[:, -1]).all()

    # mutation invalidates and rebuilds; removed id never returned
    assert ivf.remove(int(ids[0]))
    gi2, _ = ivf.topk(q, 10)
    assert int(ids[0]) not in set(gi2.reshape(-1).tolist())

    # persistence round-trip
    ivf.save(str(tmp_path / "ivf"))
    back = IvfIndex.load(str(tmp_path / "ivf"))
    gi3, _ = back.topk(q, 10)
    assert set(gi3[0].tolist()) == set(gi2[0].tolist())

    # empty index contract
    empty = IvfIndex(12)
    i0, s0 = empty.topk(q, 3)
    assert (i0 == -1).all() and (s0 == 0).all()
