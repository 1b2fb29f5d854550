"""Stage-1 item tower: 3-branch hybrid encoder + SimCSE projector.

Redesign of ``HybridItemTower`` (reference `item_tower.py:131-286`):

  branch A (STD):  Embed(std_vocab, D) + learned per-field embedding + LN
  branch B (RE):   token embeddings of the 9 LLM fields, masked mean-pool
                   per field -> (B, 9, D), + field-position params
  branch C (text): full text-encoder forward on the product name -> (B, 1, D)

The three branches are concatenated into a (B, F+9+1, D) token sequence,
fused by a small pre-norm transformer (2 layers, 4 heads — reference
`item_tower.py:169-182`), masked-mean-pooled, passed through the
progressive-expansion ``DeepResidualHead`` and L2-normalized to the final
128-d item vector. The frozen-BERT branch is replaced by the pluggable
trainable ``HashTextEncoder`` (see models/text_encoder.py).

Field identity is injected through learned field embeddings rather than the
reference's natural-language prompt prefixes ("Fabric Material: …",
`item_tower.py:445-464`) — prompts existed to steer a *frozen* encoder; a
trainable one learns the field prior directly.
"""

from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from recsys.config import ItemTowerConfig, VocabConfig
from recsys.models.layers import DeepResidualHead, TransformerEncoder, masked_mean
from recsys.models.text_encoder import HashTextEncoder, PretrainedTextEncoder
from recsys.ops.contrastive import l2_normalize


class HybridItemTower(nn.Module):
    std_vocab_size: int
    num_std_fields: int
    cfg: ItemTowerConfig = ItemTowerConfig()
    vocab_cfg: VocabConfig = VocabConfig()
    num_re_fields: int = 9

    def setup(self):
        D = self.cfg.dim
        dt = jnp.bfloat16
        self.std_emb = nn.Embed(self.std_vocab_size, D, dtype=dt, name="std_embedding")
        self.std_field_emb = self.param(
            "std_field_embedding", nn.initializers.normal(0.02),
            (self.num_std_fields, D))
        self.std_norm = nn.LayerNorm(dtype=dt)
        if self.cfg.text_encoder == "pretrained":
            self.text_encoder = PretrainedTextEncoder(
                vocab_size=self.vocab_cfg.text_vocab_size, dim=self.cfg.text_dim,
                pretrained_dim=self.cfg.pretrained_dim,
                num_layers=self.cfg.text_layers, nhead=self.cfg.text_heads,
                max_len=self.vocab_cfg.max_name_tokens, dtype=dt)
        else:
            self.text_encoder = HashTextEncoder(
                vocab_size=self.vocab_cfg.text_vocab_size, dim=self.cfg.text_dim,
                num_layers=self.cfg.text_layers, nhead=self.cfg.text_heads,
                max_len=self.vocab_cfg.max_name_tokens, dtype=dt)
        self.re_proj = nn.Dense(D, dtype=dt, name="re_projection")
        self.re_field_emb = self.param(
            "re_field_embedding", nn.initializers.normal(0.02),
            (self.num_re_fields, D))
        self.re_norm = nn.LayerNorm(dtype=dt)
        self.txt_proj = nn.Dense(D, dtype=dt, name="text_projection")
        self.fusion = TransformerEncoder(D, self.cfg.fusion_heads,
                                         self.cfg.fusion_layers,
                                         dropout=self.cfg.dropout, dtype=dt)
        self.head = DeepResidualHead(D, tuple(self.cfg.head_hidden), dtype=dt)

    def __call__(self, std, re_ids, re_mask, txt_ids, txt_mask,
                 deterministic: bool = True) -> jnp.ndarray:
        """(B,F) (B,9,T) (B,9,T) (B,Tn) (B,Tn) -> (B, D) L2-normalized."""
        dt = jnp.bfloat16
        # A: STD categorical tokens
        a = self.std_norm(self.std_emb(std) + self.std_field_emb[None].astype(dt))
        a_mask = (std > 0).astype(jnp.int32)                       # PAD fields masked

        # B: RE fields — embedding-only path + per-field masked mean pool
        tok = self.text_encoder.embed_tokens(re_ids)               # (B,9,T,D)
        pooled = masked_mean(tok, re_mask, axis=-2)                # (B,9,D)
        b = self.re_norm(self.re_proj(pooled) + self.re_field_emb[None].astype(dt))
        b_mask = (re_mask.sum(-1) > 0).astype(jnp.int32)           # empty fields masked

        # C: full text encoding of the product name
        c = self.txt_proj(self.text_encoder.encode(txt_ids, txt_mask,
                                                   deterministic))[:, None, :]
        c_mask = jnp.ones((std.shape[0], 1), jnp.int32)

        seq = jnp.concatenate([a, b, c.astype(dt)], axis=1)        # (B, F+9+1, D)
        mask = jnp.concatenate([a_mask, b_mask, c_mask], axis=1)
        fused = self.fusion(seq, pad_mask=mask, deterministic=deterministic)
        pooled = masked_mean(fused, mask)
        out = self.head(pooled, deterministic)
        return l2_normalize(out)


class SimCSEProjector(nn.Module):
    """128 -> 128 -> 128 projection head + L2 norm, used only during
    contrastive training (reference ``OptimizedItemTower``,
    `item_tower.py:289-305`)."""

    dim: int = 128

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.dim, dtype=jnp.bfloat16)(x.astype(jnp.bfloat16))
        h = nn.gelu(h)
        h = nn.Dense(self.dim, dtype=jnp.bfloat16)(h)
        return l2_normalize(h)


class SimCSEModel(nn.Module):
    """encoder ∘ projector (reference ``SimCSEModelWrapper``,
    `item_tower.py:308-322`)."""

    std_vocab_size: int
    num_std_fields: int
    cfg: ItemTowerConfig = ItemTowerConfig()
    vocab_cfg: VocabConfig = VocabConfig()

    def setup(self):
        self.encoder = HybridItemTower(self.std_vocab_size, self.num_std_fields,
                                       self.cfg, self.vocab_cfg)
        self.projector = SimCSEProjector(self.cfg.dim)

    def __call__(self, std, re_ids, re_mask, txt_ids, txt_mask,
                 deterministic: bool = False):
        emb = self.encoder(std, re_ids, re_mask, txt_ids, txt_mask, deterministic)
        return self.projector(emb)

    def encode(self, std, re_ids, re_mask, txt_ids, txt_mask):
        return self.encoder(std, re_ids, re_mask, txt_ids, txt_mask, True)
