"""Int8-quantized full-catalog retrieval scoring.

Serving optimization with no reference counterpart (the reference
scores fp32 through pgvector, `APIController/controller.py:84-116`): the
full-catalog scan `U @ I^T` that backs eval and bulk serving
(`eval/recall.topk_scores`) is memory-bandwidth-bound at large catalogs —
the matrix units finish the (B, N) matmul faster than device memory can
stream the (N, D) item matrix. Storing the catalog as int8 halves-to-quarters
the bytes per scan and asks for an int8 x int8 -> int32 product
(`preferred_element_type=int32`).

Scheme: per-CHANNEL symmetric quantization of the (row-normalized) item
matrix, folded exactly into the query:

    score_j = sum_d u_d * (q_jd * s_d) = sum_d (u_d * s_d) * q_jd

so the per-channel scales ride the (tiny) query side at fp32 cost, and the
query itself is then per-ROW quantized (v ~= alpha * vq) to unlock the
int8 x int8 product. Per-row alpha > 0 never reorders a row's scores, so
top-k runs directly on the int32 accumulator.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class QuantizedItems(NamedTuple):
    """int8 catalog + the per-channel dequantization scale."""
    q: jnp.ndarray          # (N+1, D) int8, row 0 = PAD
    col_scale: jnp.ndarray  # (D,) float32; items ~= q * col_scale[None, :]


def quantize_items_int8(item_matrix, normalize: bool = True) -> QuantizedItems:
    """Per-channel symmetric int8 quantization of the item matrix.

    ``normalize`` L2-normalizes rows first (cosine retrieval, the serving
    default — matches ``topk_scores(normalize_items=True)``).
    """
    items = jnp.asarray(item_matrix, jnp.float32)
    if normalize:
        items = items / jnp.clip(
            jnp.linalg.norm(items, axis=-1, keepdims=True), 1e-12)
    amax = jnp.max(jnp.abs(items), axis=0)
    col_scale = jnp.clip(amax / 127.0, 1e-12)
    q = jnp.clip(jnp.round(items / col_scale[None, :]), -127, 127
                 ).astype(jnp.int8)
    return QuantizedItems(q, col_scale.astype(jnp.float32))


def int8_topk(user_vecs, qitems: QuantizedItems, k: int,
              method: str = "exact", recall_target: float = 0.95):
    """(B, D) fp queries x int8 catalog -> (approx fp32 vals, idx) (B, k).

    PAD row 0 is excluded, same contract as ``eval/recall.topk_scores``.
    ``method="approx"`` uses ``lax.approx_max_k`` on the int32 accumulator
    (rescaled per-row, order-preserving) for the fastest serving path.
    """
    u = jnp.asarray(user_vecs, jnp.float32) * qitems.col_scale[None, :]
    alpha = jnp.clip(jnp.max(jnp.abs(u), axis=-1, keepdims=True) / 127.0,
                     1e-12)
    uq = jnp.clip(jnp.round(u / alpha), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        uq, qitems.q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)                     # (B, N+1)
    scores = acc.astype(jnp.float32) * alpha                  # dequantized
    scores = scores.at[:, 0].set(-jnp.inf)                    # PAD row
    if method == "approx":
        return jax.lax.approx_max_k(scores, k, recall_target=recall_target)
    return jax.lax.top_k(scores, k)


def quantization_recall(item_matrix, user_vecs, k: int = 100,
                        normalize: bool = True) -> float:
    """Fraction of the fp32-exact top-k recovered by the int8 path — the
    offline quality gate to run before flipping a serving fleet to int8."""
    from recsys.eval.recall import topk_scores

    _, exact = topk_scores(jnp.asarray(user_vecs), jnp.asarray(item_matrix),
                           k, normalize_items=normalize)
    _, qidx = int8_topk(user_vecs, quantize_items_int8(item_matrix,
                                                       normalize), k)
    exact = np.asarray(exact)
    qidx = np.asarray(qidx)
    hits = sum(len(set(exact[r].tolist()) & set(qidx[r].tolist()))
               for r in range(exact.shape[0]))
    return hits / max(exact.size, 1)
