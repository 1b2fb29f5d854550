"""On-device SimCSE view corruption.

The reference corrupts feature dicts in Python per step and re-tokenizes
both views (`SimCSERecSysDataset._corrupt_data`, `item_tower.py:341-394`) —
its single worst CPU hot loop. Because our item tensors carry per-token
VALUE ids (see ``data/dataset.py``), the same augmentation is pure masking
and runs *inside the jitted train step* on the device:

  * drop individual RE values with prob ``p``          (value-level dropout)
  * drop whole RE fields with prob ``max(p - 0.1, 0)`` (key-level dropout)
  * delete one random word of the product name with prob 0.5

Dropping == zeroing the token mask; downstream masked mean-pools then
ignore those tokens, which is exactly what re-tokenizing the corrupted dict
would have produced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_VALUES = 16  # upper bound on distinct values per RE field


def corrupt_view(batch: dict, key: jax.Array, dropout_prob: float) -> dict:
    """Return a corrupted copy of the item batch (only masks change)."""
    k_val, k_key, k_name_gate, k_name_pos = jax.random.split(key, 4)
    re_mask = batch["re_mask"]          # (B, F, T)
    re_value = batch["re_value"]        # (B, F, T) 1-based value index
    B, F, T = re_mask.shape

    # value-level dropout: one coin per (item, field, value)
    value_drop = jax.random.bernoulli(k_val, dropout_prob, (B, F, MAX_VALUES))
    token_value_dropped = jnp.take_along_axis(
        value_drop, jnp.clip(re_value - 1, 0, MAX_VALUES - 1), axis=-1)
    # key-level dropout: one coin per (item, field)
    key_drop = jax.random.bernoulli(k_key, max(dropout_prob - 0.1, 0.0), (B, F))
    new_re_mask = re_mask * (1 - token_value_dropped.astype(re_mask.dtype))
    new_re_mask = new_re_mask * (1 - key_drop.astype(re_mask.dtype))[..., None]

    # name-word deletion: with prob 0.5 zero one uniformly-chosen real token
    txt_mask = batch["txt_mask"]        # (B, Tn)
    Tn = txt_mask.shape[1]
    gate = jax.random.bernoulli(k_name_gate, 0.5, (B,))
    # choose among real tokens: gumbel-max over mask
    gumbel = jax.random.gumbel(k_name_pos, (B, Tn))
    scores = jnp.where(txt_mask > 0, gumbel, -jnp.inf)
    victim = jnp.argmax(scores, axis=-1)
    one_hot = jax.nn.one_hot(victim, Tn, dtype=txt_mask.dtype)
    new_txt_mask = jnp.where(gate[:, None], txt_mask * (1 - one_hot), txt_mask)
    # an all-masked name would NaN the mean-pool; keep originals in that case
    has_tokens = txt_mask.sum(-1, keepdims=True) > 1
    new_txt_mask = jnp.where(has_tokens, new_txt_mask, txt_mask)

    out = dict(batch)
    out["re_mask"] = new_re_mask
    out["txt_mask"] = new_txt_mask
    return out


def two_views(batch: dict, key: jax.Array, dropout_prob: float) -> tuple[dict, dict]:
    k1, k2 = jax.random.split(key)
    return corrupt_view(batch, k1, dropout_prob), corrupt_view(batch, k2, dropout_prob)


def random_cut(batch: dict, key: jax.Array, prob: float = 0.2) -> dict:
    """Random-cut sequence augmentation (reference `mined_inference.py:153-163`):
    with probability ``prob`` per user, truncate the history at a uniformly
    chosen valid position and re-align so the cut point sits at the last
    slot (the left-padding invariant every consumer relies on).

    Operates on SASRec batches: input_ids/target_ids/time_buckets/seq_mask
    all (B, L). Pure on-device array ops; rows keep >= 1 real position."""
    k_gate, k_pos = jax.random.split(key)
    mask = batch["seq_mask"]
    B, L = mask.shape
    gate = jax.random.bernoulli(k_gate, prob, (B,))
    # uniformly pick a valid cut position per row (gumbel-max over the mask)
    gumbel = jax.random.gumbel(k_pos, (B, L))
    cut = jnp.argmax(jnp.where(mask > 0, gumbel, -jnp.inf), axis=-1)  # (B,)
    cut = jnp.where(gate, cut, L - 1)
    shift = (L - 1) - cut                                    # right-shift amount
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    src_col = cols - shift[:, None]                          # column to read from
    inside = src_col >= 0
    src_safe = jnp.clip(src_col, 0, L - 1)

    out = dict(batch)
    for k in ("input_ids", "target_ids", "time_buckets", "seq_mask"):
        rolled = jnp.take_along_axis(batch[k], src_safe, axis=1)
        out[k] = jnp.where(inside, rolled, 0)
    # positions after the cut are gone by construction (they shifted past L-1)
    return out
