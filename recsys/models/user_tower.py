"""Stage-2 user tower: SASRec-style causal transformer + gated static branch.

Redesign of ``SASRecUserTower`` (reference
`tower_code/v1_refine_usertower.py:312-510`) and ``SASRecItemTower``
(reference `v1_usertower_train.py:266-293`):

  * sequence branch — per-position sum of: projected content item vector
    (from the stage-1 matrix), learnable id embedding, time-bucket
    embedding, and hashed side-info embeddings, each scaled by a sigmoid
    feature gate (``seq_gate``); + learned positional embedding, LayerNorm,
    dropout, then a causal pre-norm transformer with key-padding mask.
    The reference hard-disables side-info gates 2-5 (`:437-438`); here
    that's the ``enable_side_gates`` flag instead of dead code.
  * static branch — bucket embeddings (16-d), low-cardinality categorical
    embeddings (4-d) and a continuous projection, each gated
    (``static_gate``), concatenated -> MLP -> d_model.
  * late fusion — concat(seq, static) -> output projection -> L2 norm.
    Training mode returns per-timestep vectors (B, L, D); eval uses the
    last position (left padding guarantees it is the newest event).

``SASRecItemTower`` holds the (N+1, D) trainable item matrix initialized
from the stage-1 artifact; on a mesh it is row-sharded over the model axis
and looked up via the collective helper (parallel/collectives.py).
Freeze -> unfreeze-at-5%-lr is an optimizer-schedule concern
(train/state.py), not a model concern.
"""

from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from recsys.config import UserTowerConfig
from recsys.models.layers import MLP, TransformerEncoder
from recsys.ops.contrastive import l2_normalize


class SASRecItemTower(nn.Module):
    """Trainable item-embedding matrix, PAD row 0."""

    num_items: int  # N+1 including PAD
    dim: int = 128

    def setup(self):
        self.item_matrix = self.param(
            "item_matrix", nn.initializers.normal(0.02), (self.num_items, self.dim))

    def __call__(self, ids: jnp.ndarray) -> jnp.ndarray:
        return jnp.take(self.item_matrix, ids, axis=0)

    def all_items(self) -> jnp.ndarray:
        return self.item_matrix


class SASRecUserTower(nn.Module):
    cfg: UserTowerConfig = UserTowerConfig()
    num_id_embeddings: int = 1  # N+1; set from data
    enable_side_gates: bool = False  # reference ships with side gates off

    def setup(self):
        c = self.cfg
        D = c.d_model
        dt = jnp.bfloat16
        self.item_proj = nn.Dense(D, dtype=dt, name="item_proj")
        self.id_emb = nn.Embed(self.num_id_embeddings, D, dtype=dt, name="id_embedding")
        self.time_emb = nn.Embed(c.num_time_buckets, D, dtype=dt, name="time_embedding")
        self.side_embs = [
            nn.Embed(1001, D, dtype=dt, name=f"side_embedding_{i}")
            for i in range(c.num_side_fields)
        ]
        # sequence-feature gates: [content, id, time, side0..sideS] — the
        # reference's seq_gate(6) with the side gates hard-zeroed (`:437-438`)
        self.seq_gate = self.param("seq_gate", nn.initializers.zeros,
                                   (3 + c.num_side_fields,))
        self.pos_emb = self.param("pos_embedding", nn.initializers.normal(0.02),
                                  (c.max_len, D))
        self.seq_norm = nn.LayerNorm(dtype=dt)
        self.seq_dropout = nn.Dropout(c.dropout)
        self.encoder = TransformerEncoder(D, c.nhead, c.num_layers,
                                          dropout=c.dropout, dtype=dt)

        self.bucket_embs = [
            nn.Embed(16, c.bucket_emb_dim, dtype=dt, name=f"bucket_embedding_{i}")
            for i in range(c.static_bucket_fields)
        ]
        self.cat_embs = [
            nn.Embed(8, c.cat_emb_dim, dtype=dt, name=f"cat_embedding_{i}")
            for i in range(c.static_cat_fields)
        ]
        self.cont_proj = nn.Dense(c.cont_proj_dim, dtype=dt, name="cont_proj")
        self.static_gate = self.param(
            "static_gate", nn.initializers.zeros,
            (c.static_bucket_fields + c.static_cat_fields + 1,))
        static_in = (c.static_bucket_fields * c.bucket_emb_dim
                     + c.static_cat_fields * c.cat_emb_dim + c.cont_proj_dim)
        self.static_mlp = MLP([static_in, D], dtype=dt, dropout=c.dropout)
        self.output_proj = nn.Dense(D, dtype=dt, name="output_proj")

    def __call__(self, item_vecs, input_ids, time_buckets, side_ids, seq_mask,
                 user_buckets, user_cats, user_cont, *,
                 all_timesteps: bool = True, deterministic: bool = True):
        """item_vecs (B,L,D) content vectors of the input items; side_ids
        (B,L,S); returns (B,L,D) if ``all_timesteps`` else (B,D), L2-normed."""
        c = self.cfg
        dt = jnp.bfloat16
        B, L = input_ids.shape

        gates = nn.sigmoid(self.seq_gate.astype(jnp.float32)).astype(dt)
        x = self.item_proj(item_vecs.astype(dt)) * gates[0]
        x = x + self.id_emb(input_ids) * gates[1]
        x = x + self.time_emb(time_buckets) * gates[2]
        if self.enable_side_gates:
            for i, emb in enumerate(self.side_embs):
                x = x + emb(side_ids[..., i]) * gates[3 + i]
        x = x + self.pos_emb[None, :L].astype(dt)
        x = self.seq_norm(x)
        x = self.seq_dropout(x, deterministic=deterministic)
        seq_out = self.encoder(x, pad_mask=seq_mask, causal=True,
                               deterministic=deterministic)      # (B,L,D)

        sg = nn.sigmoid(self.static_gate.astype(jnp.float32)).astype(dt)
        parts = []
        for i, emb in enumerate(self.bucket_embs):
            parts.append(emb(jnp.clip(user_buckets[:, i], 0, 15)) * sg[i])
        off = c.static_bucket_fields
        for i, emb in enumerate(self.cat_embs):
            parts.append(emb(jnp.clip(user_cats[:, i], 0, 7)) * sg[off + i])
        parts.append(self.cont_proj(user_cont.astype(dt)) * sg[off + c.static_cat_fields])
        static = self.static_mlp(jnp.concatenate(parts, axis=-1), deterministic)  # (B,D)

        if all_timesteps:
            static_b = jnp.broadcast_to(static[:, None, :], seq_out.shape)
            fused = jnp.concatenate([seq_out, static_b], axis=-1)
        else:
            fused = jnp.concatenate([seq_out[:, -1], static], axis=-1)
        out = self.output_proj(fused)
        return l2_normalize(out)
