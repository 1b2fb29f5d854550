#!/usr/bin/env python3
"""Smoke run of the system's main path on GPUs, with reference checks.

    python chip_smoke.py            # one GPU: `lightgcl` then `retrieval`
    python chip_smoke.py --four     # four GPUs: the sharded path only

One GPU, in one process:

* ``lightgcl`` — the LightGCL trainer's own step (``train/gnn.py``) at the
  reference's throughput anchor: 200,000 users, 47,000 items, 11.3M
  interactions (22.6M directed edges), dim 64, 2 layers, a rank-5 SVD view,
  batch 8192. The graph and the weights are made from ``--seed``. Prints
  compile seconds, ``memory_analysis()``, step times ended by
  ``block_until_ready`` and peak device bytes; checks that every loss is
  finite, that one propagation pass matches ``scipy.sparse`` in float64,
  and that the step's loss matches the same step under "highest" matmul
  precision. Also times one propagation pass and the in-batch LogQ loss
  (forward + backward) on their own.
* ``retrieval`` — full-catalog top-500 through ``eval/recall.topk_scores``
  over the trained item table for 1,024 users, against a float64 numpy
  top-500 of the same scores; times ``lax.top_k`` beside
  ``lax.approx_max_k``.

``--four`` runs only the mesh path on a (data=1, model=4) mesh: one
propagation pass and two LightGCL steps with the edge list sharded over the
four devices (``segment_sum_sharded``), and the sharded top-500, each
against the same computation on one device.

Every result is one JSON line that carries the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``; any failed check or
error exits non-zero without it. Without a GPU the script stops at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

USERS_EVAL = 1024
TOP_K = 500
STEPS = 5

# Tolerances, each with the reason it has the size it has.
# f32 segment sums add up to ~1.5e5 terms per row (the most popular item) in
# an order that atomics change from run to run: the expected error is about
# sqrt(n) * eps(f32) ~ 2e-5 of the row's absolute sum; 1e-3 leaves room for
# adversarial orders without hiding a wrong edge (which shows as O(1)).
PROP_REL_TOL = 1e-3
# f32 matrix products may run in TF32 (10-bit mantissa, ~5e-4 relative) in
# the SVD view and the SSL logits; averaged into the loss that moves it by
# well under 1e-3 of its value.
LOSS_REL_TOL = 1e-3
# Top-500 of 47,000 dot scores: TF32 rounding can swap near-ties at the
# boundary, a few per user at most; at full precision only f32 rounding is
# left, so at most ~1 in 1,000.
RECALL_TOL_DEFAULT = 0.98
RECALL_TOL_HIGHEST = 0.999
# Sharded vs one-device results differ only in f32 sum order.
SHARD_REL_TOL = 1e-4


class Report:
    """JSON lines on stdout, each beside the card; failed checks counted."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def line(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, "card": self.card, **fields},
                         default=_jsonable), flush=True)

    def check(self, phase: str, name: str, value: float, limit: float,
              ok: bool) -> None:
        if not ok:
            self.failed.append(f"{phase}/{name}")
        self.line(phase, check=name, value=value, limit=limit, ok=bool(ok))


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return str(x)


def card_name() -> str:
    """``name, power.limit`` of each GPU as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _timed(fn, *args, reps: int) -> list[float]:
    """Seconds per call, each call ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def _memory_analysis(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys} if m is not None else {}


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _rel_err(got: np.ndarray, ref: np.ndarray, scale: np.ndarray) -> float:
    """Largest error relative to the absolute sum behind each entry."""
    return float(np.max(np.abs(got - ref) / (scale + 1e-30)))


def _topk_recovery(idx: np.ndarray, ref_idx: np.ndarray) -> float:
    """Mean share of the exact top-k set that ``idx`` recovers."""
    k = ref_idx.shape[1]
    return float(np.mean([len(np.intersect1d(a, b)) / k
                          for a, b in zip(idx, ref_idx)]))


def _exact_topk(scores64: np.ndarray, k: int) -> np.ndarray:
    return np.argpartition(-scores64, k - 1, axis=1)[:, :k]


def propagation_reference(graph, x: np.ndarray):
    """``A_norm @ x`` and ``|A_norm| @ |x|`` in float64 through scipy."""
    import scipy.sparse as sp

    n = graph.num_nodes
    adj = sp.csr_matrix((graph.weight.astype(np.float64),
                         (graph.dst, graph.src)), shape=(n, n))
    x64 = x.astype(np.float64)
    return adj @ x64, abs(adj) @ np.abs(x64)


def build_lightgcl(seed: int, num_users: int, num_items: int,
                   num_interactions: int, cfg):
    from recsys.ops.graph import random_graph

    rng = np.random.default_rng(seed)
    graph, eu, ei = random_graph(rng, num_users, num_items, num_interactions,
                                 cfg.svd_rank)
    return graph, eu, ei, rng


def bpr_batches(eu, ei, num_items: int, batch: int, n: int, rng):
    import jax.numpy as jnp

    from recsys.train.gnn import edge_key_index, sample_bpr_batches

    it = sample_bpr_batches(eu, ei, num_items, batch, rng,
                            edge_key_index(eu, ei, num_items))
    return [tuple(jnp.asarray(a) for a in next(it)) for _ in range(n)]


def phase_lightgcl(rep: Report, seed: int, num_users: int, num_items: int,
                   num_interactions: int, batch: int, steps: int,
                   loss_batches=(768, 8192)):
    """Trainer step at the anchor; returns (graph, trained params)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from recsys.config import GNNConfig
    from recsys.models.lightgcl import init_lightgcl
    from recsys.ops.contrastive import inbatch_logq_loss
    from recsys.train.gnn import make_gnn_step, select_propagation
    from recsys.train.state import TrainState

    cfg = dataclasses.replace(GNNConfig(), batch_size=batch)
    t0 = time.perf_counter()
    graph, eu, ei, rng = build_lightgcl(seed, num_users, num_items,
                                        num_interactions, cfg)
    batches = bpr_batches(eu, ei, num_items, batch, steps + 1, rng)
    prop_fn, prop_args = select_propagation(cfg, graph, graph.num_nodes)
    params = init_lightgcl(jax.random.PRNGKey(seed), num_users, num_items,
                           cfg.emb_dim)
    state0 = TrainState.create(params, optax.adam(cfg.lr))
    step = make_gnn_step(prop_fn, graph, cfg, prop_args)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    compiled = step.jitted.lower(state0, step.graph_args, *batches[0]).compile()
    compile_s = time.perf_counter() - t0
    rep.line("lightgcl", users=num_users, items=num_items,
             directed_edges=int(len(graph.src)), batch=batch, dim=cfg.emb_dim,
             layers=cfg.num_layers, svd_rank=cfg.svd_rank,
             host_setup_s=setup_s, compile_s=compile_s,
             memory_analysis=_memory_analysis(compiled))

    # warm-up step; its loss is the one the precision check compares
    state, aux0 = compiled(state0, step.graph_args, *batches[0])
    jax.block_until_ready((state, aux0))
    with jax.default_matmul_precision("highest"):
        _, aux_hi = step.jitted(state0, step.graph_args, *batches[0])
    for key in ("loss", "bpr", "ssl"):
        got, ref = float(aux0[key]), float(aux_hi[key])
        err = abs(got - ref) / max(abs(ref), 1e-30)
        rep.check("lightgcl", f"{key}_default_vs_highest_precision", err,
                  LOSS_REL_TOL, err <= LOSS_REL_TOL)
    del state0, aux_hi

    times, losses = [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        state, aux = compiled(state, step.graph_args, *b)
        jax.block_until_ready((state, aux))
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
    med = float(np.median(times))
    rep.line("lightgcl", step_ms=[1e3 * t for t in times], step_ms_median=1e3 * med,
             examples_per_s=batch / med, losses=losses,
             peak_bytes_in_use=_peak_bytes(jax.devices()[0]))
    rep.check("lightgcl", "losses_finite", float(np.all(np.isfinite(losses))),
              1.0, bool(np.all(np.isfinite(losses))))

    # one propagation pass: against scipy in float64, and on its own clock
    x = jnp.concatenate([state.params["user_emb"], state.params["item_emb"]])
    prop = jax.jit(prop_fn)
    y = np.asarray(prop(prop_args, x))
    ref, scale = propagation_reference(graph, np.asarray(x))
    err = _rel_err(y, ref, scale)
    rep.check("lightgcl", "propagation_vs_scipy_f64", err, PROP_REL_TOL,
              err <= PROP_REL_TOL)
    pass_s = float(np.median(_timed(prop, prop_args, x, reps=10)))
    e, d = len(graph.src), x.shape[1]
    # bytes the pass must move: src/dst/weight, one gathered row read and
    # one row added into the output per edge
    pass_bytes = e * (3 * 4 + 2 * d * 4)
    grad_s = float(np.median(_timed(
        jax.jit(jax.grad(lambda xx, a: jnp.sum(prop_fn(a, xx)))),
        x, prop_args, reps=10)))
    rep.line("lightgcl", propagation_pass_ms=1e3 * pass_s,
             propagation_pass_bytes=pass_bytes,
             propagation_pass_bytes_per_s=pass_bytes / pass_s,
             propagation_grad_ms=1e3 * grad_s)

    # the in-batch LogQ loss, forward + backward, at stage-2's batch (768)
    # and the GNN/hybrid batch (8192), D=128
    for b_size in loss_batches:
        lrng = np.random.default_rng(seed)
        q = jnp.asarray(lrng.normal(size=(b_size, 128)), jnp.float32)
        k = jnp.asarray(lrng.normal(size=(b_size, 128)), jnp.float32)
        pos = jnp.asarray(lrng.integers(1, num_items + 1, b_size), jnp.int32)
        usr = jnp.asarray(lrng.integers(0, b_size // 2, b_size), jnp.int32)
        logq = jnp.asarray(lrng.normal(-8.0, 1.0, num_items + 1), jnp.float32)
        valid = jnp.ones(b_size, jnp.int32)
        fwd_bwd = jax.jit(jax.value_and_grad(
            lambda qq, kk: inbatch_logq_loss(qq, kk, pos, logq, user_ids=usr,
                                             valid=valid), argnums=(0, 1)))
        t = float(np.median(_timed(fwd_bwd, q, k, reps=20)))
        rep.line("lightgcl", logq_loss_fwd_bwd_ms=1e3 * t, batch=b_size, dim=128)
    return graph, state.params


def phase_retrieval(rep: Report, graph, params, num_eval: int, k: int):
    import jax
    import jax.numpy as jnp

    from recsys.eval.recall import topk_scores
    from recsys.train.gnn import final_embeddings

    t0 = time.perf_counter()
    fu, fi = final_embeddings(params, graph)  # the export/eval propagation
    export_s = time.perf_counter() - t0
    items = np.concatenate([np.zeros((1, fi.shape[1]), np.float32), fi])
    users = fu[:num_eval]
    scores64 = users.astype(np.float64) @ items.astype(np.float64).T
    scores64[:, 0] = -np.inf  # PAD row
    ref_idx = _exact_topk(scores64, k)

    topk = jax.jit(topk_scores, static_argnames=("k", "normalize_items", "method"))
    u_d, i_d = jnp.asarray(users), jnp.asarray(items)
    t0 = time.perf_counter()
    compiled = topk.lower(u_d, i_d, k=k, normalize_items=False).compile()
    rep.line("retrieval", compile_s=time.perf_counter() - t0,
             memory_analysis=_memory_analysis(compiled))
    for precision, tol in (("default", RECALL_TOL_DEFAULT),
                           ("highest", RECALL_TOL_HIGHEST)):
        with jax.default_matmul_precision(precision):
            vals, idx = topk(u_d, i_d, k=k, normalize_items=False)
            vals, idx = np.asarray(vals), np.asarray(idx)
        rec = _topk_recovery(idx, ref_idx)
        rep.check("retrieval", f"top{k}_recovered_share_{precision}", rec, tol,
                  rec >= tol)
        got = np.take_along_axis(scores64, idx, axis=1)
        err = float(np.max(np.abs(vals - got)) / np.max(np.abs(got)))
        rep.check("retrieval", f"top{k}_values_vs_f64_{precision}", err,
                  LOSS_REL_TOL, err <= LOSS_REL_TOL)

    t_exact = _timed(compiled, u_d, i_d, reps=10)
    scores = jax.jit(lambda u, i: u @ i.T)(u_d, i_d)
    t_top = _timed(jax.jit(lambda s: jax.lax.top_k(s, k)), scores, reps=10)
    approx = jax.jit(lambda s: jax.lax.approx_max_k(s, k, recall_target=0.95))
    t_apx = _timed(approx, scores, reps=10)
    _, aidx = approx(scores)
    _, eidx = jax.jit(lambda s: jax.lax.top_k(s, k))(scores)
    rep.line("retrieval", users=num_eval, items=int(items.shape[0]), dim=int(items.shape[1]),
             k=k, export_propagation_s=export_s,
             topk_scores_ms=1e3 * float(np.median(t_exact)),
             lax_top_k_ms=1e3 * float(np.median(t_top)),
             approx_max_k_ms=1e3 * float(np.median(t_apx)),
             approx_max_k_recall_vs_top_k=_topk_recovery(np.asarray(aidx),
                                                         np.asarray(eidx)),
             peak_bytes_in_use=_peak_bytes(jax.devices()[0]))


def phase_four(rep: Report, seed: int, num_users: int, num_items: int,
               num_interactions: int, batch: int, num_eval: int, k: int,
               devices):
    """Edge-sharded LightGCL and sharded top-k on a (1, n) mesh against the
    same computation on one device."""
    import dataclasses
    import gc

    import jax
    import jax.numpy as jnp
    import optax

    from recsys.config import GNNConfig, MeshConfig
    from recsys.eval.recall import topk_scores
    from recsys.models.lightgcl import init_lightgcl
    from recsys.parallel.mesh import build_mesh, pad_to_multiple, replicated
    from recsys.train.gnn import make_gnn_step, select_propagation
    from recsys.train.state import TrainState

    n_dev = len(devices)
    mesh = build_mesh(MeshConfig(num_data=1, num_model=n_dev), devices)
    cfg1 = dataclasses.replace(GNNConfig(), batch_size=batch)
    cfg_s = dataclasses.replace(cfg1, propagation="segment_sum_sharded")
    graph, eu, ei, rng = build_lightgcl(seed, num_users, num_items,
                                        num_interactions, cfg1)
    batches = bpr_batches(eu, ei, num_items, batch, 2, rng)
    params = init_lightgcl(jax.random.PRNGKey(seed), num_users, num_items,
                           cfg1.emb_dim)
    x = np.concatenate([np.asarray(params["user_emb"]),
                        np.asarray(params["item_emb"])])

    def run(cfg, mesh_or_none, place):
        prop_fn, prop_args = select_propagation(cfg, graph, graph.num_nodes,
                                                mesh=mesh_or_none)
        y = np.asarray(jax.jit(prop_fn)(prop_args, place(jnp.asarray(x))))
        step = make_gnn_step(prop_fn, graph, cfg, prop_args)
        state = place(TrainState.create(params, optax.adam(cfg.lr)))
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, aux = step(state, *(place(a) for a in b))
            jax.block_until_ready((state, aux))
            times.append(time.perf_counter() - t0)
            losses.append({key: float(aux[key]) for key in ("loss", "bpr", "ssl")})
        return y, losses, times

    dev0 = devices[0]
    y1, loss1, t1 = run(cfg1, None, lambda a: jax.device_put(a, dev0))
    gc.collect()
    ys, loss_s, ts = run(cfg_s, mesh, lambda a: jax.device_put(a, replicated(mesh)))
    scale = np.abs(y1).max()
    err = float(np.max(np.abs(ys - y1)) / scale)
    rep.check("four", "propagation_sharded_vs_one_device", err, SHARD_REL_TOL,
              err <= SHARD_REL_TOL)
    for s, (l1, ls) in enumerate(zip(loss1, loss_s)):
        for key in ("loss", "bpr", "ssl"):
            e = abs(ls[key] - l1[key]) / max(abs(l1[key]), 1e-30)
            rep.check("four", f"step{s}_{key}_sharded_vs_one_device", e,
                      SHARD_REL_TOL, e <= SHARD_REL_TOL)
    rep.line("four", mesh=dict(mesh.shape), directed_edges=int(len(graph.src)),
             one_device_step_s=t1, sharded_step_s=ts,
             note="first step of each includes its compilation")

    # sharded top-k over the row-sharded item table vs the dense top-k
    items = np.concatenate([np.zeros((1, x.shape[1]), np.float32), x[num_users:]])
    n_real = items.shape[0]
    items, _ = pad_to_multiple(items, n_dev)
    prior = np.zeros(items.shape[0], np.float32)
    prior[n_real:] = -np.inf  # pad rows never rank
    users = jnp.asarray(x[:num_eval])
    vd, idd = topk_scores(jax.device_put(users, dev0),
                          jax.device_put(jnp.asarray(items), dev0), k,
                          prior=jax.device_put(jnp.asarray(prior), dev0))
    vs, ids = topk_scores(users, jnp.asarray(items), k, mesh=mesh,
                          prior=jnp.asarray(prior))
    rec = _topk_recovery(np.asarray(ids), np.asarray(idd))
    rep.check("four", f"top{k}_sharded_vs_dense_recovered_share", rec,
              1.0 - SHARD_REL_TOL, rec >= 1.0 - SHARD_REL_TOL)
    verr = float(np.max(np.abs(np.asarray(vs) - np.asarray(vd))))
    rep.check("four", f"top{k}_sharded_vs_dense_max_value_diff", verr,
              SHARD_REL_TOL, verr <= SHARD_REL_TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device sharded path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              "this script does not run elsewhere", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2

    from recsys.ops.graph import ANCHOR_INTERACTIONS, ANCHOR_ITEMS, ANCHOR_USERS
    from recsys.runtime import device_info, enable_compile_cache

    enable_compile_cache()
    card = card_name()
    print(f"card: {card}", flush=True)
    rep = Report(card)
    anchor = (ANCHOR_USERS, ANCHOR_ITEMS, ANCHOR_INTERACTIONS, 8192)
    if args.four:
        phase_four(rep, args.seed, *anchor, USERS_EVAL, TOP_K, devices[:4])
    else:
        graph, params = phase_lightgcl(rep, args.seed, *anchor, args.steps)
        phase_retrieval(rep, graph, params, USERS_EVAL, TOP_K)
    if rep.failed:
        print(f"chip_smoke: failed checks: {rep.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
