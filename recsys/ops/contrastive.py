"""The in-batch contrastive loss family — the framework's core op.

One shared similarity/masking/CE recipe serves every variant the reference
implements separately (SURVEY.md §7.3 names this the hard part):

  * ``bidirectional_infonce``        — SimCSE item tower (`item_tower.py:1069-1082`)
  * ``inbatch_logq_loss``            — sampled softmax + LogQ correction +
    same-item / same-user false-negative masking (`v1_refine_usertower.py:826-861`)
  * ``duorec_loss``                  — dropout-view InfoNCE + supervised SupCon
    over shared-target rows (`v1_refine_usertower.py:576-627`)
  * ``hnm_corrected_loss``           — top-K% hard-negative mining with
    too-similar exclusion (`v1_refine_usertower.py:632-692`)
  * ``mixed_hnm_loss``               — hard + random negatives (`:695-759`)
  * ``full_batch_hard_emphasis_loss``— additive margin on mined hard
    negatives (`:762-822`)
  * ``corrected_logq_with_recovery`` — LogQ with positive recovery, CLIP-style
    learnable scale (`mined_inference.py:751-789`)

All math is fp32 regardless of tower compute dtype; masking uses -3e4, a
bf16/fp16-safe -inf substitute (the reference learned this the hard way,
`mined_inference.py:783`). Everything is a pure global-batch program: under
jit-SPMD with a data-sharded batch, XLA inserts the all-gathers that turn
these into cross-device global-negative losses — no per-device code.

Every trainer calls these forms directly; XLA fuses the masking and the
softmax around the (B, B) similarity matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG = -3.0e4  # bf16-safe "minus infinity"


def l2_normalize(x: jnp.ndarray, axis: int = -1, eps: float = 1e-12) -> jnp.ndarray:
    """fp32 L2 normalization (embeddings leave towers normalized)."""
    x = x.astype(jnp.float32)
    return x / jnp.sqrt(jnp.sum(x * x, axis=axis, keepdims=True) + eps)


def _f32(x):
    return x.astype(jnp.float32)


def _ce_with_diag_labels(logits: jnp.ndarray) -> jnp.ndarray:
    """Mean cross entropy with labels = row index (diagonal positives)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.diagonal(logp))


def bidirectional_infonce(emb1: jnp.ndarray, emb2: jnp.ndarray,
                          temperature: float = 0.08) -> jnp.ndarray:
    """SimCSE: sim = e1 @ e2.T / tau, CE both directions, averaged.
    Inputs are L2-normalized (B, D)."""
    sim = _f32(emb1) @ _f32(emb2).T / temperature
    return 0.5 * (_ce_with_diag_labels(sim) + _ce_with_diag_labels(sim.T))


def inbatch_logq_loss(user_emb: jnp.ndarray, item_emb: jnp.ndarray,
                      pos_item_ids: jnp.ndarray, log_q: jnp.ndarray,
                      *, temperature: float = 0.1, lambda_logq: float = 1.0,
                      user_ids: jnp.ndarray | None = None,
                      valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """In-batch sampled softmax with LogQ popularity correction.

    user_emb (B, D) L2-normalized query rows; item_emb (B, D) their positive
    item embeddings; pos_item_ids (B,) the item indices (for the popularity
    lookup and same-item masking); log_q (N+1,) log popularity.

    Corrections/masks (reference second `inbatch_corrected_logq_loss` def,
    the one actually used, `v1_refine_usertower.py:826-861`):
      * logits[:, j] -= lambda * logQ(item_j)  (Sampled Softmax correction)
      * same-item columns (candidate == my positive, not me) -> NEG
      * same-user columns (flattened timesteps of one user, not me) -> NEG
      * rows with valid == 0 drop out of the mean
    """
    logits = _f32(user_emb) @ _f32(item_emb).T / temperature
    logits = logits - lambda_logq * _f32(log_q)[pos_item_ids][None, :]
    B = logits.shape[0]
    eye = jnp.eye(B, dtype=bool)
    same_item = pos_item_ids[None, :] == pos_item_ids[:, None]
    mask = same_item & ~eye
    if user_ids is not None:
        same_user = user_ids[None, :] == user_ids[:, None]
        mask = mask | (same_user & ~eye)
    if valid is not None:
        # invalid rows would not exist at all in the reference's dynamic
        # flattening — mask them out as candidate columns too
        mask = mask | ((valid[None, :] == 0) & ~eye)
    logits = jnp.where(mask, NEG, logits)
    logp = jnp.diagonal(jax.nn.log_softmax(logits, axis=-1))
    if valid is None:
        return -jnp.mean(logp)
    v = _f32(valid)
    return -jnp.sum(logp * v) / jnp.clip(v.sum(), 1.0, None)


def duorec_loss(z1: jnp.ndarray, z2: jnp.ndarray, target_ids: jnp.ndarray,
                *, temperature: float = 0.1, lambda_sup: float = 0.1,
                valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """DuoRec regularizer: unsupervised InfoNCE between two dropout views +
    supervised SupCon treating same-target rows as extra positives."""
    sim = _f32(z1) @ _f32(z2).T / temperature
    B = sim.shape[0]
    v = jnp.ones(B, jnp.float32) if valid is None else _f32(valid)
    row_mask = (v[:, None] * v[None, :]) > 0
    sim = jnp.where(row_mask, sim, NEG)
    unsup = 0.5 * (
        -jnp.sum(jnp.diagonal(jax.nn.log_softmax(sim, -1)) * v) / jnp.clip(v.sum(), 1.0, None)
        - jnp.sum(jnp.diagonal(jax.nn.log_softmax(sim.T, -1)) * v) / jnp.clip(v.sum(), 1.0, None)
    )
    # SupCon: positives = other rows with the same target item (both views)
    same_target = (target_ids[None, :] == target_ids[:, None]) & row_mask
    pos_mask = same_target & ~jnp.eye(B, dtype=bool)
    logp = jax.nn.log_softmax(sim, axis=-1)
    pos_cnt = pos_mask.sum(-1)
    sup_row = -jnp.sum(jnp.where(pos_mask, logp, 0.0), axis=-1) / jnp.clip(pos_cnt, 1, None)
    has_pos = (pos_cnt > 0) & (v > 0)
    sup = jnp.sum(jnp.where(has_pos, sup_row, 0.0)) / jnp.clip(has_pos.sum(), 1, None)
    return unsup + lambda_sup * sup


def _hard_negative_mask(cos: jnp.ndarray, pos_item_ids: jnp.ndarray,
                        top_k_percent: float, threshold: float):
    """Boolean (B, B) mask of mined hard negatives: highest-cosine
    off-diagonal candidates, excluding same-item columns and anything with
    cosine > threshold ('too similar' = probable false negative)."""
    B = cos.shape[0]
    eye = jnp.eye(B, dtype=bool)
    same_item = pos_item_ids[None, :] == pos_item_ids[:, None]
    eligible = ~eye & ~same_item & (cos <= threshold)
    k = max(int(B * top_k_percent), 1)
    masked_cos = jnp.where(eligible, cos, NEG)
    kth = jnp.sort(masked_cos, axis=-1)[:, -k][:, None]
    hard = eligible & (masked_cos >= kth)
    return hard, k


def hnm_corrected_loss(user_emb: jnp.ndarray, item_emb: jnp.ndarray,
                       pos_item_ids: jnp.ndarray, log_q: jnp.ndarray,
                       *, temperature: float = 0.1, lambda_logq: float = 1.0,
                       top_k_percent: float = 0.01, threshold: float = 0.90):
    """Hard-negative-mined sampled softmax: CE over [positive | top-K% hard
    negatives], both LogQ-corrected. Returns (loss, stats)."""
    u, it = _f32(user_emb), _f32(item_emb)
    cos = u @ it.T
    hard, k = _hard_negative_mask(cos, pos_item_ids, top_k_percent, threshold)
    corr = lambda_logq * _f32(log_q)[pos_item_ids][None, :]
    logits_all = cos / temperature - corr
    pos = jnp.diagonal(logits_all)[:, None]
    hard_logits = jnp.where(hard, logits_all, NEG)
    # keep exactly k hard columns per row in a static shape
    topk_vals, _ = jax.lax.top_k(hard_logits, k)
    logits = jnp.concatenate([pos, topk_vals], axis=-1)
    loss = -jnp.mean(jnp.diagonal(jax.nn.log_softmax(logits, -1)[:, :1]))
    hard_cos = jnp.where(hard, cos, 0.0)
    stats = {
        "hard_k": k,
        "hard_sim_mean": jnp.sum(hard_cos) / jnp.clip(hard.sum(), 1, None),
        "excluded_too_similar": jnp.sum((cos > threshold) & ~jnp.eye(cos.shape[0], dtype=bool)),
    }
    return loss, stats


def mixed_hnm_loss(user_emb: jnp.ndarray, item_emb: jnp.ndarray,
                   pos_item_ids: jnp.ndarray, log_q: jnp.ndarray, key: jax.Array,
                   *, temperature: float = 0.1, lambda_logq: float = 1.0,
                   top_k_percent: float = 0.01, threshold: float = 0.90,
                   num_random: int = 100):
    """Hard + ``num_random`` uniformly-sampled in-batch negatives
    (`v1_refine_usertower.py:695-759`)."""
    u, it = _f32(user_emb), _f32(item_emb)
    B = u.shape[0]
    cos = u @ it.T
    hard, k = _hard_negative_mask(cos, pos_item_ids, top_k_percent, threshold)
    corr = lambda_logq * _f32(log_q)[pos_item_ids][None, :]
    logits_all = cos / temperature - corr
    pos = jnp.diagonal(logits_all)[:, None]
    topk_vals, _ = jax.lax.top_k(jnp.where(hard, logits_all, NEG), k)
    rand_cols = jax.random.randint(key, (B, min(num_random, B)), 0, B)
    rand_logits = jnp.take_along_axis(logits_all, rand_cols, axis=-1)
    self_or_same = jnp.take_along_axis(
        (pos_item_ids[None, :] == pos_item_ids[:, None]) | jnp.eye(B, dtype=bool),
        rand_cols, axis=-1)
    rand_logits = jnp.where(self_or_same, NEG, rand_logits)
    logits = jnp.concatenate([pos, topk_vals, rand_logits], axis=-1)
    loss = -jnp.mean(jnp.diagonal(jax.nn.log_softmax(logits, -1)[:, :1]))
    return loss, {"hard_k": k}


def full_batch_hard_emphasis_loss(user_emb: jnp.ndarray, item_emb: jnp.ndarray,
                                  pos_item_ids: jnp.ndarray, log_q: jnp.ndarray,
                                  *, temperature: float = 0.1,
                                  lambda_logq: float = 1.0,
                                  top_k_percent: float = 0.01,
                                  threshold: float = 0.90,
                                  margin: float = 0.01):
    """Full-batch CE with an additive margin pushing mined hard negatives
    (`logits += mask * margin / tau`) and same-item masking."""
    u, it = _f32(user_emb), _f32(item_emb)
    B = u.shape[0]
    cos = u @ it.T
    hard, _ = _hard_negative_mask(cos, pos_item_ids, top_k_percent, threshold)
    logits = cos / temperature - lambda_logq * _f32(log_q)[pos_item_ids][None, :]
    logits = logits + hard.astype(jnp.float32) * (margin / temperature)
    eye = jnp.eye(B, dtype=bool)
    same_item = (pos_item_ids[None, :] == pos_item_ids[:, None]) & ~eye
    logits = jnp.where(same_item, NEG, logits)
    return _ce_with_diag_labels(logits)


def corrected_logq_with_recovery(user_emb: jnp.ndarray, item_emb: jnp.ndarray,
                                 pos_item_ids: jnp.ndarray, log_q: jnp.ndarray,
                                 logit_scale: jnp.ndarray,
                                 *, lambda_logq: float = 1.0) -> jnp.ndarray:
    """CLIP-style loss: cosine * exp(learnable scale), LogQ-corrected with
    the DIAGONAL restored to its uncorrected score ('positive recovery' —
    the positive's own popularity shouldn't penalize it), same-item columns
    masked bf16-safely (`mined_inference.py:751-789`)."""
    scale = jnp.exp(_f32(logit_scale))
    raw = _f32(user_emb) @ _f32(item_emb).T * scale
    corrected = raw - lambda_logq * _f32(log_q)[pos_item_ids][None, :]
    B = raw.shape[0]
    eye = jnp.eye(B, dtype=bool)
    logits = jnp.where(eye, raw, corrected)
    same_item = (pos_item_ids[None, :] == pos_item_ids[:, None]) & ~eye
    logits = jnp.where(same_item, NEG, logits)
    return _ce_with_diag_labels(logits)
