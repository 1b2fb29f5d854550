"""The plain-JAX ops the trainers call, against float64 numpy references:
the in-batch contrastive losses, graph propagation and sharded top-k."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from recsys.ops import contrastive as C
from recsys.ops.graph import propagate, propagate_chunked, random_graph

NEG = -3.0e4


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def np_infonce(e1, e2, tau):
    sim = e1 @ e2.T / tau
    return 0.5 * (-np.mean(np.diag(_log_softmax(sim)))
                  - np.mean(np.diag(_log_softmax(sim.T))))


def np_logq(u, it, pos, logq, tau, lam, user_ids=None, valid=None):
    b = len(u)
    logits = u @ it.T / tau - lam * logq[pos][None, :]
    eye = np.eye(b, dtype=bool)
    mask = (pos[None, :] == pos[:, None]) & ~eye
    if user_ids is not None:
        mask |= (user_ids[None, :] == user_ids[:, None]) & ~eye
    if valid is not None:
        mask |= (valid[None, :] == 0) & ~eye
    logp = np.diag(_log_softmax(np.where(mask, NEG, logits)))
    if valid is None:
        return -logp.mean()
    return -(logp * valid).sum() / max(valid.sum(), 1.0)


def np_duorec(z1, z2, tgt, tau, lam, valid=None):
    b = len(z1)
    v = np.ones(b) if valid is None else valid.astype(np.float64)
    row_mask = np.outer(v, v) > 0
    sim = np.where(row_mask, z1 @ z2.T / tau, NEG)
    denom = max(v.sum(), 1.0)
    unsup = 0.5 * (-(np.diag(_log_softmax(sim)) * v).sum() / denom
                   - (np.diag(_log_softmax(sim.T)) * v).sum() / denom)
    pos_mask = (tgt[None, :] == tgt[:, None]) & row_mask & ~np.eye(b, dtype=bool)
    cnt = pos_mask.sum(-1)
    sup_row = -np.where(pos_mask, _log_softmax(sim), 0.0).sum(-1) / np.maximum(cnt, 1)
    has = (cnt > 0) & (v > 0)
    sup = np.where(has, sup_row, 0.0).sum() / max(has.sum(), 1)
    return unsup + lam * sup


def _unit(rng, b, d):
    x = rng.normal(size=(b, d))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _logq_inputs(b, with_users, with_valid, seed=0):
    rng = np.random.default_rng(seed)
    u, it = _unit(rng, b, 8), _unit(rng, b, 8)
    pos = rng.integers(1, 6, b)            # few items: same-item masking
    logq = rng.normal(-3.0, 1.0, 7)
    users = rng.integers(0, max(b // 2, 1), b) if with_users else None
    valid = (rng.random(b) > 0.3).astype(np.int32) if with_valid else None
    return u, it, pos, logq, users, valid


def _jax_logq(u, it, pos, logq, users, valid):
    return C.inbatch_logq_loss(
        jnp.asarray(u, jnp.float32), jnp.asarray(it, jnp.float32),
        jnp.asarray(pos), jnp.asarray(logq, jnp.float32), temperature=0.1,
        lambda_logq=0.7,
        user_ids=None if users is None else jnp.asarray(users),
        valid=None if valid is None else jnp.asarray(valid))


@pytest.mark.parametrize("b,with_users,with_valid", [
    (1, False, False), (5, True, False), (7, False, True), (16, True, True),
    (33, True, True)])
def test_logq_loss_matches_numpy(b, with_users, with_valid):
    u, it, pos, logq, users, valid = _logq_inputs(b, with_users, with_valid)
    got = float(_jax_logq(u, it, pos, logq, users, valid))
    ref = np_logq(u, it, pos, logq, 0.1, 0.7, users, valid)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b", [1, 8, 17])
def test_infonce_matches_numpy(b):
    rng = np.random.default_rng(b)
    e1, e2 = _unit(rng, b, 16), _unit(rng, b, 16)
    got = float(C.bidirectional_infonce(jnp.asarray(e1, jnp.float32),
                                        jnp.asarray(e2, jnp.float32), 0.08))
    np.testing.assert_allclose(got, np_infonce(e1, e2, 0.08), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("b,masked", [(8, False), (9, True), (16, True)])
def test_duorec_matches_numpy(b, masked):
    rng = np.random.default_rng(b)
    z1, z2 = _unit(rng, b, 8), _unit(rng, b, 8)
    tgt = rng.integers(0, 4, b)            # shared targets: SupCon positives
    valid = (rng.random(b) > 0.25).astype(np.int32) if masked else None
    got = float(C.duorec_loss(jnp.asarray(z1, jnp.float32),
                              jnp.asarray(z2, jnp.float32), jnp.asarray(tgt),
                              temperature=0.1, lambda_sup=0.3,
                              valid=None if valid is None else jnp.asarray(valid)))
    np.testing.assert_allclose(got, np_duorec(z1, z2, tgt, 0.1, 0.3, valid),
                               rtol=1e-4, atol=1e-5)


def _central_diff(f, x, eps=1e-5):
    g = np.zeros_like(x)
    for idx in np.ndindex(x.shape):
        d = np.zeros_like(x)
        d[idx] = eps
        g[idx] = (f(x + d) - f(x - d)) / (2 * eps)
    return g


@pytest.mark.parametrize("loss", ["logq", "infonce"])
def test_loss_gradient_matches_finite_differences(loss):
    u, it, pos, logq, users, valid = _logq_inputs(6, True, True, seed=3)
    if loss == "logq":
        f64 = lambda q: np_logq(q, it, pos, logq, 0.1, 0.7, users, valid)
        f32 = lambda q: _jax_logq(q, it, pos, logq, users, valid)
    else:
        f64 = lambda q: np_infonce(q, it, 0.08)
        f32 = lambda q: C.bidirectional_infonce(q, jnp.asarray(it, jnp.float32), 0.08)
    got = np.asarray(jax.grad(f32)(jnp.asarray(u, jnp.float32)))
    np.testing.assert_allclose(got, _central_diff(f64, u), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("loss", ["logq", "infonce", "duorec"])
def test_losses_under_jit_match_eager(loss):
    u, it, pos, logq, users, valid = _logq_inputs(12, True, True, seed=4)
    args = [jnp.asarray(u, jnp.float32), jnp.asarray(it, jnp.float32)]
    fns = {
        "logq": lambda a, b: C.inbatch_logq_loss(
            a, b, jnp.asarray(pos), jnp.asarray(logq, jnp.float32),
            user_ids=jnp.asarray(users), valid=jnp.asarray(valid)),
        "infonce": lambda a, b: C.bidirectional_infonce(a, b, 0.08),
        "duorec": lambda a, b: C.duorec_loss(a, b, jnp.asarray(pos),
                                             valid=jnp.asarray(valid)),
    }
    fn = fns[loss]
    np.testing.assert_allclose(float(jax.jit(fn)(*args)), float(fn(*args)),
                               rtol=1e-6, atol=1e-7)


def _random_edges(n, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.random(e).astype(np.float32))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("n,e,d", [(7, 20, 8), (64, 500, 16), (300, 4000, 64)])
def test_propagate_matches_scipy(n, e, d, chunked):
    """A_norm @ x against scipy in float64, with weight-0 pad edges on node
    0 appended (the build_graph padding), which must change nothing."""
    src, dst, w = _random_edges(n, e, seed=n)
    ref = sp.csr_matrix((w.astype(np.float64), (dst, src)), shape=(n, n)) @ \
        np.random.default_rng(1).normal(size=(n, d))
    x = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    pad = 64 - e % 64
    src_p = np.concatenate([src, np.zeros(pad, np.int32)])
    dst_p = np.concatenate([dst, np.zeros(pad, np.int32)])
    w_p = np.concatenate([w, np.zeros(pad, np.float32)])
    if chunked:
        got = propagate_chunked(x, src_p, dst_p, w_p, n, edge_chunk=128)
    else:
        got = propagate(jnp.asarray(x), jnp.asarray(src_p), jnp.asarray(dst_p),
                        jnp.asarray(w_p), n)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [8, 16, 64])
def test_propagation_gradient_is_propagation(d):
    """A_norm is symmetric, so d/dx <c, A x> = A^T c = A c."""
    graph, _, _ = random_graph(np.random.default_rng(d), 30, 20, 200)
    args = [jnp.asarray(a) for a in (graph.src, graph.dst, graph.weight)]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(graph.num_nodes, d)), jnp.float32)
    c = jnp.asarray(rng.normal(size=(graph.num_nodes, d)), jnp.float32)
    g = jax.grad(lambda xx: jnp.sum(c * propagate(xx, *args, graph.num_nodes)))(x)
    np.testing.assert_allclose(np.asarray(g),
                               np.asarray(propagate(c, *args, graph.num_nodes)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_data,num_model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_topk_scores_match_dense(num_data, num_model):
    from recsys.config import MeshConfig
    from recsys.eval.recall import topk_scores
    from recsys.parallel.mesh import build_mesh

    mesh = build_mesh(MeshConfig(num_data=num_data, num_model=num_model))
    rng = np.random.default_rng(num_model)
    users = jnp.asarray(rng.normal(size=(8, 16)), jnp.float32)
    items = jnp.asarray(rng.normal(size=(64, 16)), jnp.float32)
    prior = jnp.asarray(rng.normal(size=64) * 0.1, jnp.float32)
    vs, ids = topk_scores(users, items, 10, mesh=mesh, prior=prior)
    vd, idd = topk_scores(users, items, 10, prior=prior)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(idd))
    np.testing.assert_allclose(np.asarray(vs), np.asarray(vd), rtol=1e-6)
    assert 0 not in np.asarray(ids)   # PAD row never ranks
