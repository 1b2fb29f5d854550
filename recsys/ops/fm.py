"""Factorization-machine second-order interaction op.

The BASELINE north star names the FM pairwise-interaction kernel as a
hot op. XLA fuses this form; it uses the O(F*K) identity
``sum_{i<j} <v_i, v_j> = 0.5 * (||sum_f v_f||^2 - sum_f ||v_f||^2)``.
"""

from __future__ import annotations

import jax.numpy as jnp


def fm_interaction(v: jnp.ndarray) -> jnp.ndarray:
    """(B, F, K) field embeddings -> (B,) FM second-order term."""
    v = v.astype(jnp.float32)
    sum_sq = jnp.sum(v, axis=1) ** 2          # (B, K)
    sq_sum = jnp.sum(v**2, axis=1)            # (B, K)
    return 0.5 * jnp.sum(sum_sq - sq_sum, axis=-1)


def fm_interaction_vector(v: jnp.ndarray) -> jnp.ndarray:
    """(B, F, K) -> (B, K): the per-dimension interaction vector (kept
    unsummed so a deep head can consume it, DeepFM-style)."""
    v = v.astype(jnp.float32)
    return 0.5 * (jnp.sum(v, axis=1) ** 2 - jnp.sum(v**2, axis=1))
