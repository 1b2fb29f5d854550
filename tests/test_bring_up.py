"""The main path's plain-JAX model and state, what it may import, the
compile-cache helper, and ``chip_smoke.py`` rehearsed on the CPU."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from recsys.config import GNNConfig
from recsys.models.lightgcl import MagnitudeEncoder, init_lightgcl, lightgcl_forward
from recsys.ops.graph import propagate, random_graph
from recsys.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- functional LightGCL ----------------------------------------------------

@pytest.mark.parametrize("num_users,num_items,dim", [(500, 300, 64), (40, 30, 16)])
def test_init_lightgcl_is_xavier_uniform(num_users, num_items, dim):
    p = init_lightgcl(jax.random.PRNGKey(0), num_users, num_items, dim)
    assert set(p) == {"user_emb", "item_emb"}
    for name, rows in (("user_emb", num_users), ("item_emb", num_items)):
        w = np.asarray(p[name])
        assert w.shape == (rows, dim) and w.dtype == np.float32
        bound = np.sqrt(6.0 / (rows + dim))      # fan_in = rows, fan_out = dim
        assert np.abs(w).max() <= bound
        np.testing.assert_allclose(w.var(), bound ** 2 / 3, rtol=0.15)
    assert not np.allclose(p["user_emb"][:30], p["item_emb"][:30, :])


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_lightgcl_forward_matches_dense_formula(num_layers):
    """local = mean_l A^l x0, global = mean_l (U S V^T)^l x0, split at Nu."""
    graph, _, _ = random_graph(np.random.default_rng(1), 12, 9, 60, svd_rank=3)
    n = graph.num_nodes
    params = init_lightgcl(jax.random.PRNGKey(1), 12, 9, 8)
    args = tuple(jnp.asarray(a) for a in (graph.src, graph.dst, graph.weight))
    prop = lambda a, x: propagate(x, a[0], a[1], a[2], n)
    out = lightgcl_forward(params, prop, args, jnp.asarray(graph.svd_u),
                           jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v),
                           num_layers)
    adj = np.zeros((n, n))
    np.add.at(adj, (graph.dst, graph.src), graph.weight)
    low = graph.svd_u.astype(np.float64) @ np.diag(graph.svd_s) @ graph.svd_v.T
    x0 = np.concatenate([params["user_emb"], params["item_emb"]]).astype(np.float64)
    local = sum(np.linalg.matrix_power(adj, l) @ x0
                for l in range(num_layers + 1)) / (num_layers + 1)
    glob = sum(np.linalg.matrix_power(low, l) @ x0
               for l in range(num_layers + 1)) / (num_layers + 1)
    for got, ref in zip(out, (local[:12], local[12:], glob[:12], glob[12:])):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-6)


def test_magnitude_encoder_matches_formula():
    enc = MagnitudeEncoder(16, 32, 8)
    p = enc.init(jax.random.PRNGKey(2))
    x = np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32)
    out, scale = enc(p, jnp.asarray(x))
    h = x @ np.asarray(p["Dense_0"]["kernel"]) + np.asarray(p["Dense_0"]["bias"])
    h = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    h = h @ np.asarray(p["Dense_1"]["kernel"]) + np.asarray(p["Dense_1"]["bias"])
    np.testing.assert_allclose(np.asarray(out),
                               h / np.linalg.norm(h, axis=-1, keepdims=True),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(scale), np.log(10.0), rtol=1e-6)


@pytest.mark.parametrize("mode", ["auto", "spmm", "bogus"])
def test_unknown_propagation_rejected(mode):
    from recsys.train.gnn import select_propagation

    graph, _, _ = random_graph(np.random.default_rng(0), 5, 4, 10)
    with pytest.raises(ValueError, match="propagation"):
        select_propagation(GNNConfig(propagation=mode), graph, graph.num_nodes)


def test_random_graph_is_symmetric_and_normalized():
    graph, u, i = random_graph(np.random.default_rng(0), 50, 20, 400)
    assert len(graph.src) == 2 * 400 and len(u) == len(i) == 400
    n = graph.num_nodes
    adj = np.zeros((n, n))
    np.add.at(adj, (graph.dst, graph.src), graph.weight)
    np.testing.assert_allclose(adj, adj.T, rtol=1e-6)
    counts = np.zeros(n)
    np.add.at(counts, graph.dst, 1.0)
    w_ref = 1.0 / np.sqrt(np.clip(counts[graph.src], 1, None)
                          * np.clip(counts[graph.dst], 1, None))
    np.testing.assert_allclose(graph.weight, w_ref, rtol=1e-6)


# -- TrainState -------------------------------------------------------------

def test_train_state_is_a_pytree_under_jit():
    params = {"a": jnp.ones((3,)), "b": {"c": jnp.zeros((2, 2))}}
    tx = optax.adam(1e-2)
    state = TrainState.create(params, tx)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    # step + params + adam moments; the transformation is static metadata
    assert len(leaves) == 1 + 2 + 1 + 2 + 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tx is tx
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    new = jax.jit(lambda s, g: s.apply_gradients(g))(state, grads)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = optax.apply_updates(params, updates)
    assert int(new.step) == 1
    np.testing.assert_allclose(np.asarray(new.params["a"]), np.asarray(ref["a"]))
    assert new.replace(step=jnp.asarray(5)).step == 5 and new.tx is tx


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_train_state_checkpoint_roundtrip(tmp_path, backend):
    from recsys.train.checkpoint import CheckpointStore

    tx = optax.adam(1e-2)
    params = {"user_emb": jnp.arange(6.0).reshape(3, 2),
              "item_emb": jnp.ones((2, 2))}
    state = TrainState.create(params, tx)
    state = state.apply_gradients(jax.tree_util.tree_map(jnp.ones_like, params))
    store = CheckpointStore(str(tmp_path), backend=backend)
    store.save("ep001", state, step=1, metric=0.5)
    restored, entry = store.restore_best(TrainState.create(
        jax.tree_util.tree_map(jnp.zeros_like, params), tx))
    assert isinstance(restored, TrainState) and entry["step"] == 1
    assert int(restored.step) == 1
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    only, _ = store.restore_best_params(
        jax.tree_util.tree_map(jnp.zeros_like, params))
    np.testing.assert_array_equal(np.asarray(only["user_emb"]),
                                  np.asarray(state.params["user_emb"]))


# -- what the main path imports ---------------------------------------------

@pytest.mark.parametrize("module", ["recsys.train.gnn", "recsys.eval.recall",
                                   "recsys.runtime"])
def test_main_path_imports_without_flax_or_pandas(module):
    code = ("import sys\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['pandas'] = None\n"
            f"import {module}\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# -- compile cache ------------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch):
    from recsys import runtime

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from recsys import runtime

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


# -- chip_smoke.py ----------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr


def test_chip_smoke_one_device_phases_rehearse(capsys):
    cs = _load_chip_smoke()
    rep = cs.Report("cpu rehearsal")
    graph, params = cs.phase_lightgcl(rep, 0, 400, 250, 4000, 256, 2,
                                      loss_batches=(16,))
    cs.phase_retrieval(rep, graph, params, 32, 40)
    assert rep.failed == []
    out = capsys.readouterr().out
    assert '"step_ms"' in out and '"propagation_pass_ms"' in out
    assert '"top40_recovered_share_highest"' in out


def test_chip_smoke_four_device_path_rehearses():
    cs = _load_chip_smoke()
    rep = cs.Report("cpu rehearsal")
    cs.phase_four(rep, 0, 400, 250, 4000, 256, 32, 40, jax.devices()[:4])
    assert rep.failed == []


@pytest.mark.chip
def test_chip_smoke_phases_on_gpu(gpu):
    """The smoke phases at a tenth of the anchor, on the card."""
    cs = _load_chip_smoke()
    rep = cs.Report(gpu.device_kind)
    graph, params = cs.phase_lightgcl(rep, 0, 20_000, 4_700, 1_130_000, 8192, 3)
    cs.phase_retrieval(rep, graph, params, 1024, 500)
    assert rep.failed == []
