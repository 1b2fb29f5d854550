"""Hybrid user tower (v2 line): content + GNN fusion with gated adapters.

Redesign of `tower_code/mined_inference.py`'s model stack:

  * ``ResidualAdapter`` — gated residual MLP whose gate bias starts at +2
    (sigmoid ~= 0.88: output begins ~88% passthrough, adaptation leaks in
    slowly; reference `:287-339`);
  * ``ParallelAdapter`` — content(128) (+) gnn(64) -> 128 item
    representation (reference `:582-602`);
  * ``SequenceCentricFusion`` — the sequence signal carries fixed weight
    1.0; GNN-user and metadata signals enter through sigmoid gates
    initialized at -5 (~= 0.007: effectively OFF until training opens them;
    reference `:514-577`);
  * ``HybridUserTower`` — 4-layer causal transformer over adapted item
    vectors, meta MLP, GNN user embedding with train-time bernoulli signal
    dropout (the reference additionally hard-zeroes the GNN path at
    `:672-681`; here that's the ``gnn_signal_scale`` knob), CLIP-style
    learnable ``logit_scale`` consumed by the positive-recovery LogQ loss
    (ops/contrastive.corrected_logq_with_recovery).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from flax import linen as nn

from recsys.config import UserTowerConfig
from recsys.models.layers import MLP, TransformerEncoder
from recsys.ops.contrastive import l2_normalize


class ResidualAdapter(nn.Module):
    dim: int
    gate_bias_init: float = 2.0

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.dim, dtype=jnp.bfloat16)(x.astype(jnp.bfloat16))
        h = nn.gelu(h)
        h = nn.Dense(self.dim, dtype=jnp.bfloat16)(h)
        gate = self.param("gate", nn.initializers.constant(self.gate_bias_init), ())
        g = nn.sigmoid(gate.astype(jnp.float32))
        return (g * x.astype(jnp.float32) + (1.0 - g) * h.astype(jnp.float32))


class ParallelAdapter(nn.Module):
    """content (Dc) + gnn (Dg) -> fused item representation (D)."""

    out_dim: int = 128

    @nn.compact
    def __call__(self, content, gnn):
        dt = jnp.bfloat16
        c = nn.Dense(self.out_dim, dtype=dt, name="content_proj")(content.astype(dt))
        g = nn.Dense(self.out_dim, dtype=dt, name="gnn_proj")(gnn.astype(dt))
        return nn.LayerNorm(dtype=dt)(c + g)


class SequenceCentricFusion(nn.Module):
    """seq * 1.0 + sigmoid(gate_gnn) * gnn + sigmoid(gate_meta) * meta."""

    dim: int = 128
    gate_init: float = -5.0

    @nn.compact
    def __call__(self, seq, gnn_user, meta):
        dt = jnp.bfloat16
        g_gnn = nn.sigmoid(self.param("gate_gnn",
                                      nn.initializers.constant(self.gate_init), ()))
        g_meta = nn.sigmoid(self.param("gate_meta",
                                       nn.initializers.constant(self.gate_init), ()))
        gnn_p = nn.Dense(self.dim, dtype=dt, name="gnn_user_proj")(gnn_user.astype(dt))
        meta_p = nn.Dense(self.dim, dtype=dt, name="meta_proj")(meta.astype(dt))
        fused = (seq.astype(jnp.float32)
                 + g_gnn * gnn_p.astype(jnp.float32)
                 + g_meta * meta_p.astype(jnp.float32))
        return nn.Dense(self.dim, dtype=dt, name="out_proj")(fused.astype(dt))


class HybridUserTower(nn.Module):
    cfg: UserTowerConfig = UserTowerConfig()
    num_id_embeddings: int = 1
    gnn_dim: int = 64
    num_layers: int = 4
    gnn_signal_scale: float = 1.0   # reference ships with this at 0.0 (`:672-681`)
    gnn_dropout: float = 0.3        # bernoulli whole-signal dropout in training

    def setup(self):
        c = self.cfg
        D = c.d_model
        dt = jnp.bfloat16
        self.item_adapter = ParallelAdapter(D)
        self.id_emb = nn.Embed(self.num_id_embeddings, D, dtype=dt, name="id_embedding")
        self.time_emb = nn.Embed(c.num_time_buckets, D, dtype=dt, name="time_embedding")
        self.pos_emb = self.param("pos_embedding", nn.initializers.normal(0.02),
                                  (c.max_len, D))
        self.seq_norm = nn.LayerNorm(dtype=dt)
        self.encoder = TransformerEncoder(D, c.nhead, self.num_layers,
                                          dropout=c.dropout, dtype=dt)
        meta_in = c.static_bucket_fields + c.static_cat_fields + c.static_cont_fields
        self.meta_mlp = MLP([64, D], dtype=dt, dropout=c.dropout)
        self.fusion = SequenceCentricFusion(D)
        self.logit_scale = self.param("logit_scale",
                                      nn.initializers.constant(jnp.log(1 / 0.07)), ())

    def adapt_items(self, content_vecs, gnn_item_vecs):
        """Item-side path, also used to precompute the catalog matrix."""
        return self.item_adapter(content_vecs, gnn_item_vecs)

    def __call__(self, content_vecs, gnn_item_vecs, input_ids, time_buckets,
                 seq_mask, gnn_user, user_buckets, user_cats, user_cont,
                 *, deterministic: bool = True):
        """Last-step user vector (B, D), L2-normalized."""
        c = self.cfg
        dt = jnp.bfloat16
        B, L = input_ids.shape
        items = self.item_adapter(content_vecs, gnn_item_vecs)     # (B,L,D)
        x = items + self.id_emb(input_ids) + self.time_emb(time_buckets)
        x = x + self.pos_emb[None, :L].astype(dt)
        x = self.seq_norm(x)
        seq_out = self.encoder(x, pad_mask=seq_mask, causal=True,
                               deterministic=deterministic)[:, -1]

        gnn_sig = gnn_user.astype(jnp.float32) * self.gnn_signal_scale
        if not deterministic and self.gnn_dropout > 0:
            keep = jax.random.bernoulli(self.make_rng("dropout"),
                                        1.0 - self.gnn_dropout, (B, 1))
            gnn_sig = gnn_sig * keep
        meta = jnp.concatenate([user_buckets.astype(jnp.float32),
                                user_cats.astype(jnp.float32),
                                user_cont.astype(jnp.float32)], axis=-1)
        meta = self.meta_mlp(meta.astype(dt), deterministic)
        fused = self.fusion(seq_out, gnn_sig, meta)
        return l2_normalize(fused)
