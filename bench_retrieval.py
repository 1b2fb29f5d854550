"""Retrieval-path micro-bench: exact top-k vs approx_max_k vs device IVF.

Measures batched full-catalog retrieval (the serving/eval hot path) at the
reference catalog scale (47k items) and at 1M items where approximate
methods earn their keep. Also reports measured recall vs the exact top-k
for the approximate methods.

Timing: N repetitions chained through a dependency, one final
materialization.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from recsys.eval.recall import topk_scores
from recsys.ops.ivf import build_ivf, ivf_search
from recsys.ops.quant import int8_topk, quantize_items_int8

B = 1024
D = 128
REPS = 20


def _chained(fn, q0, reps=REPS):
    """fn(q) -> (vals, idx); perturb the query by a tiny idx-dependent term
    so each rep depends on the previous one's output (no dead-code elim)."""
    fn(q0)[1].block_until_ready()  # compile
    q = q0
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        vals, idx = fn(q)
        q = q0 + 1e-6 * vals[:, :1]      # chain dependency
        out = idx
    np.asarray(out)
    return (time.perf_counter() - t0) / reps * 1000  # ms


def _recall_vs_exact(idx_a, idx_e):
    a, e = np.asarray(idx_a), np.asarray(idx_e)
    k = e.shape[1]
    return float(np.mean([len(set(a[r]) & set(e[r])) / k
                          for r in range(len(e))]))


def bench_catalog(n_items: int, k: int, nlist: int, nprobe: int, rng):
    items = rng.normal(0, 1, (n_items + 1, D)).astype(np.float32)
    items[0] = 0
    q = jnp.asarray(rng.normal(0, 1, (B, D)).astype(np.float32))
    mat = jnp.asarray(items)

    exact = jax.jit(lambda u: topk_scores(u, mat, k))
    approx = jax.jit(lambda u: topk_scores(u, mat, k, method="approx",
                                           recall_target=0.95))
    t_build0 = time.perf_counter()
    ivf = build_ivf(items, nlist=nlist, iters=10)
    build_s = time.perf_counter() - t_build0
    ivf_fn = jax.jit(lambda u: ivf_search(ivf, u, k, nprobe))

    qi = quantize_items_int8(items)
    qi = jax.tree.map(jnp.asarray, qi)
    int8_fn = jax.jit(lambda u: int8_topk(u, qi, k))
    int8_ax = jax.jit(lambda u: int8_topk(u, qi, k, method="approx",
                                          recall_target=0.95))

    ms_exact = _chained(exact, q)
    ms_approx = _chained(approx, q)
    ms_ivf = _chained(ivf_fn, q)
    ms_int8 = _chained(int8_fn, q)
    ms_int8_ax = _chained(int8_ax, q)

    _, ie = exact(q)
    _, ia = approx(q)
    _, ii = ivf_fn(q)
    _, iq = int8_fn(q)
    _, iqa = int8_ax(q)
    return {
        "n_items": n_items, "k": k, "batch": B,
        "exact_ms": round(ms_exact, 3),
        "approx_ms": round(ms_approx, 3),
        "approx_recall": round(_recall_vs_exact(ia, ie), 4),
        "ivf_ms": round(ms_ivf, 3),
        "ivf_recall": round(_recall_vs_exact(ii, ie), 4),
        "ivf_nlist": nlist, "ivf_nprobe": nprobe,
        "ivf_build_s": round(build_s, 2),
        "int8_ms": round(ms_int8, 3),
        "int8_recall": round(_recall_vs_exact(iq, ie), 4),
        "int8_approx_ms": round(ms_int8_ax, 3),
        "int8_approx_recall": round(_recall_vs_exact(iqa, ie), 4),
    }


def main():
    rng = np.random.default_rng(0)
    for n_items, k, nlist, nprobe in [
        (47_000, 500, 256, 32),
        (47_000, 50, 256, 16),
        (105_000, 500, 512, 32),   # the H&M-shape catalog (VERDICT r2 item 4)
        (1_000_000, 100, 1024, 32),
    ]:
        try:
            print(json.dumps(bench_catalog(n_items, k, nlist, nprobe, rng)),
                  flush=True)
        except Exception as e:  # one config failing must not kill the sweep
            print(json.dumps({"n_items": n_items, "k": k,
                              "error": str(e)[:200]}), flush=True)


if __name__ == "__main__":
    main()
