"""Mesh/collective substrate tests (run on the 8-device virtual CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from recsys.parallel.collectives import (
    gather_global_negatives,
    rowsharded_lookup,
    sharded_topk,
)
from recsys.parallel.mesh import pad_to_multiple, smap


def test_mesh_shape(mesh8):
    assert mesh8.shape == {"data": 4, "model": 2}


def test_pad_to_multiple():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, n = pad_to_multiple(x, 4, axis=0)
    assert padded.shape == (8, 2) and n == 5
    assert np.all(padded[5:] == 0)


def test_gather_global_negatives(mesh_dp):
    B, D = 16, 8
    x = jnp.arange(B * D, dtype=jnp.float32).reshape(B, D)

    f = smap(
        lambda e: gather_global_negatives(e, "data"),
        mesh_dp, P("data", None), out_specs=P(None, None),
    )
    out = f(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x))


def test_sharded_topk_matches_dense(mesh8):
    B, N, k = 4, 64, 10
    rng = np.random.default_rng(0)
    scores = jnp.asarray(rng.normal(size=(B, N)).astype(np.float32))

    f = smap(
        lambda s: sharded_topk(s, k, "model"),
        mesh8, P(None, "model"), out_specs=(P(None, None), P(None, None)),
    )
    vals, idx = f(scores)
    ref_vals, ref_idx = jax.lax.top_k(scores, k)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(ref_vals), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))


def test_rowsharded_lookup(mesh8):
    V, D = 32, 8
    table = jnp.arange(V * D, dtype=jnp.float32).reshape(V, D)
    ids = jnp.array([0, 5, 17, 31, 2, 16])

    f = smap(
        lambda t, i: rowsharded_lookup(t, i, "model"),
        mesh8, (P("model", None), P(None,)), out_specs=P(None, None),
    )
    out = f(table, ids)
    np.testing.assert_allclose(np.asarray(out), np.asarray(table[ids]))


def test_rowsharded_lookup_grad(mesh8):
    V, D = 16, 4
    table = jnp.ones((V, D), dtype=jnp.float32)
    ids = jnp.array([1, 9, 9, 15])

    def loss(t):
        f = smap(
            lambda tt, ii: rowsharded_lookup(tt, ii, "model"),
            mesh8, (P("model", None), P(None,)), out_specs=P(None, None),
        )
        return jnp.sum(f(t, ids) ** 2)

    g = jax.grad(loss)(table)
    expected = np.zeros((V, D), np.float32)
    for i in [1, 9, 9, 15]:
        expected[i] += 2.0
    np.testing.assert_allclose(np.asarray(g), expected)


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_checkpoint_roundtrip(tmp_path, backend):
    from recsys.train.checkpoint import CheckpointStore

    store = CheckpointStore(str(tmp_path), keep=2, backend=backend)
    state = {"w": jnp.ones((3, 3)), "step": 0}
    store.save("ep1", state, step=1, metric=0.5)
    store.save("ep2", {"w": jnp.full((3, 3), 2.0), "step": 2}, step=2, metric=0.9)
    store.save("ep3", {"w": jnp.full((3, 3), 3.0), "step": 3}, step=3, metric=0.7)
    # rotation keeps 2 latest
    assert len(store.manifest["checkpoints"]) == 2
    # best is ep2 by metric, preserved despite rotation
    restored, entry = store.restore_best({"w": jnp.zeros((3, 3)), "step": 0})
    assert entry["metric"] == pytest.approx(0.9)
    np.testing.assert_allclose(np.asarray(restored["w"]), 2.0)
    latest, e = store.restore_latest({"w": jnp.zeros((3, 3)), "step": 0})
    assert e["step"] == 3


def test_id_sidecar_alignment(tmp_path):
    from recsys.train.checkpoint import (
        align_rows,
        load_array_with_ids,
        save_array_with_ids,
    )

    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    save_array_with_ids(str(tmp_path / "m"), arr, ["a", "b", "c"])
    loaded, ids, _ = load_array_with_ids(str(tmp_path / "m"))
    np.testing.assert_allclose(loaded, arr)
    aligned, found = align_rows(loaded, ids, ["c", "zz", "a"])
    np.testing.assert_allclose(aligned[0], arr[2])
    np.testing.assert_allclose(aligned[2], arr[0])
    assert list(found) == [True, False, True]


def test_metrics_alignment_uniformity():
    from recsys.train.metrics import alignment, uniformity

    e = jnp.eye(4, 8)
    assert float(alignment(e, e)) == pytest.approx(0.0)
    # identical points -> uniformity ~ log(1) = 0 (worst); spread -> negative
    same = jnp.ones((4, 8)) / jnp.sqrt(8.0)
    assert float(uniformity(same)) == pytest.approx(0.0, abs=1e-5)
    assert float(uniformity(e)) < -1.0


def test_rowsharded_lookup_a2a(mesh8):
    from recsys.parallel.collectives import rowsharded_lookup_a2a

    V, D, B = 32, 8, 8  # model axis = 2 shards of 16 rows; ids sharded too
    table = jnp.arange(V * D, dtype=jnp.float32).reshape(V, D)
    ids = jnp.array([0, 5, 17, 31, 2, 16, 9, 30])

    f = smap(
        lambda t, i: rowsharded_lookup_a2a(t, i, "model"),
        mesh8, (P("model", None), P("model",)), out_specs=P("model", None),
    )
    out = f(table, ids)
    np.testing.assert_allclose(np.asarray(out), np.asarray(table[ids]))


# -- ppermute ring merge of per-shard top-k ---------------------------------

def test_sharded_topk_ring_merge_matches_dense(mesh8, mesh_dp):
    from recsys.parallel.collectives import sharded_topk_ring_merge

    B, N, k = 4, 64, 10
    rng = np.random.default_rng(2)
    scores = jnp.asarray(rng.normal(size=(B, N)).astype(np.float32))
    ref_vals, ref_idx = jax.lax.top_k(scores, k)
    for mesh, axis in ((mesh8, "model"), (mesh_dp, "data")):
        f = smap(lambda s: sharded_topk_ring_merge(s, k, axis), mesh,
                 P(None, axis), out_specs=(P(None, None), P(None, None)))
        vals, idx = f(scores)
        np.testing.assert_allclose(np.asarray(vals), np.asarray(ref_vals),
                                   rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))


def test_sharded_topk_ring_merge_tie_determinism(mesh_dp):
    """Tied scores at the k boundary: every device must keep the SAME
    candidate set despite folding the ring in a different rotation order
    (strict total-order merge), or the replicated-output contract breaks."""
    from recsys.parallel.collectives import sharded_topk_ring_merge

    B, N, k = 2, 64, 8
    # heavy ties: only 4 distinct score values across 64 columns
    rng = np.random.default_rng(3)
    scores = jnp.asarray(rng.integers(0, 4, size=(B, N)).astype(np.float32))
    # expose each device's answer instead of assuming replication
    f = smap(lambda s: tuple(v[None] for v in
                             sharded_topk_ring_merge(s, k, "data")),
             mesh_dp, P(None, "data"),
             out_specs=(P("data", None, None), P("data", None, None)))
    vals, idx = f(scores)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for d in range(1, vals.shape[0]):
        np.testing.assert_array_equal(idx[d], idx[0])
        np.testing.assert_array_equal(vals[d], vals[0])
    # and the kept set matches dense top-k with (value desc, idx asc) order
    ref_vals, ref_idx = jax.lax.top_k(scores, k)
    np.testing.assert_array_equal(vals[0], np.asarray(ref_vals))
    np.testing.assert_array_equal(idx[0], np.asarray(ref_idx))


def test_edge_sharded_propagate_matches_dense(mesh8):
    """Edge-sharded propagation (shard edges over `model`, psum merge) ==
    single-device gather+segment_sum, including the weight-0 pad edges
    (E=37 is odd, so padding is exercised)."""
    from recsys.ops.graph import make_edge_sharded_propagate, propagate

    rng = np.random.default_rng(0)
    N, E, D = 20, 37, 8
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    w = rng.normal(size=E).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    prop_fn, place_edges = make_edge_sharded_propagate(mesh8, N, "model")
    out = prop_fn(place_edges(src, dst, w), x)
    ref = propagate(x, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), N)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_edge_sharded_propagate_grad(mesh8):
    """Gradients flow back through the psum to the replicated x."""
    from recsys.ops.graph import make_edge_sharded_propagate, propagate

    rng = np.random.default_rng(1)
    N, E, D = 12, 16, 4
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    w = rng.normal(size=E).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    prop_fn, place_edges = make_edge_sharded_propagate(mesh8, N, "model")
    args = place_edges(src, dst, w)
    g = jax.grad(lambda xx: jnp.sum(prop_fn(args, xx) ** 2))(x)
    g_ref = jax.grad(lambda xx: jnp.sum(propagate(
        xx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), N) ** 2))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-5)
