"""Reranker models: DCN-v2 cross network + DeepFM.

Re-implementation of the reference's reranking capability
(`temp_model/ranker_skelet.py`):

  * ``CrossNet`` — explicit feature crossing
    ``x_{l+1} = x_0 * (W x_l + b) + x_l`` (reference `:239-272`, DCN-v2);
  * ``DCNRanker`` — dual-path cross + deep -> sigmoid score (reference
    ``RankingModel`` `:274-357`) with a broadcast ``score_for_user`` helper;
  * ``DeepFM`` — per-field id embeddings, first-order weights, FM
    second-order interactions (ops/fm.py) + deep MLP over the concatenated
    field embeddings (the BASELINE north-star reranker config).

The gradient-boosted alternative (the reference's CatBoost path) lives in
train/reranker.py as ``GBDTRanker``.
"""

from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from recsys.config import RerankerConfig
from recsys.models.layers import MLP
from recsys.ops.fm import fm_interaction_vector


class CrossNet(nn.Module):
    num_layers: int = 3

    @nn.compact
    def __call__(self, x0):
        x0 = x0.astype(jnp.float32)
        x = x0
        d = x0.shape[-1]
        for i in range(self.num_layers):
            w = nn.Dense(d, name=f"cross_{i}")(x)
            x = x0 * w + x
        return x


class DCNRanker(nn.Module):
    cfg: RerankerConfig = RerankerConfig()

    @nn.compact
    def __call__(self, features, deterministic: bool = True):
        """(B, F) dense features -> (B,) click probability logit."""
        cross = CrossNet(self.cfg.cross_layers)(features)
        deep = MLP(list(self.cfg.deep_hidden), dtype=jnp.float32,
                   activate_last=True, dropout=self.cfg.dropout)(
            features.astype(jnp.float32), deterministic)
        h = jnp.concatenate([cross, deep], axis=-1)
        return nn.Dense(1, name="score")(h)[..., 0]

    def score_for_user(self, user_features, item_features, deterministic=True):
        """(F_u,) x (N, F_i) -> (N,) — broadcast one user over candidates
        (reference ``predict_for_user``)."""
        u = jnp.broadcast_to(user_features[None, :],
                             (item_features.shape[0], user_features.shape[0]))
        return self(jnp.concatenate([u, item_features], axis=-1), deterministic)


class DeepFM(nn.Module):
    """Sparse-field DeepFM: ids (B, F) -> logit (B,)."""

    field_sizes: tuple[int, ...]
    cfg: RerankerConfig = RerankerConfig()
    num_dense: int = 0

    @nn.compact
    def __call__(self, ids, dense=None, deterministic: bool = True):
        K = self.cfg.fm_embed_dim
        embs, firsts = [], []
        for f, size in enumerate(self.field_sizes):
            embs.append(nn.Embed(size, K, name=f"fm_embed_{f}")(ids[:, f]))
            firsts.append(nn.Embed(size, 1, name=f"fm_first_{f}")(ids[:, f]))
        v = jnp.stack(embs, axis=1)                       # (B, F, K)
        if dense is not None and self.num_dense:
            dv = nn.Dense(K, name="dense_embed")(dense.astype(jnp.float32))
            v = jnp.concatenate([v, dv[:, None, :]], axis=1)
        first_order = jnp.sum(jnp.concatenate(firsts, axis=-1), axis=-1)
        second = fm_interaction_vector(v)                  # (B, K)
        deep_in = v.reshape(v.shape[0], -1)
        deep = MLP(list(self.cfg.deep_hidden) + [1], dtype=jnp.float32,
                   dropout=self.cfg.dropout)(deep_in, deterministic)[..., 0]
        bias = self.param("bias", nn.initializers.zeros, ())
        return bias + first_order + jnp.sum(second, axis=-1) + deep
