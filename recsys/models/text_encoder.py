"""Pluggable text encoder (two implementations behind one interface).

The reference hard-wires frozen ``bert-base-uncased``: word embeddings only
for RE fields and a full BERT forward for product names
(`item_tower.py:148-166`). Per SURVEY.md §7.2 this build makes the text
encoder an interface with two methods (``embed_tokens`` for the RE branch,
``encode`` for the name branch):

  * ``HashTextEncoder`` — the small trainable default (self-contained
    slice: no downloads, no frozen 110M-param passenger);
  * ``PretrainedTextEncoder`` — FROZEN corpus-pretrained token embeddings
    (PPMI-SVD artifact, see ``data/text_pretrain.py``) + a trainable
    projection and contextual transformer on top. This mirrors the
    reference's frozen-embeddings + trainable-adapter split: the table gets
    ``stop_gradient`` in the forward AND a ``set_to_zero`` optimizer group
    (``train/simcse.make_optimizer``), so neither gradients nor weight
    decay ever touch it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from flax import linen as nn

from recsys.models.layers import TransformerEncoder, masked_mean


class HashTextEncoder(nn.Module):
    """Trainable default text encoder over hashed token ids."""

    vocab_size: int = 8192
    dim: int = 128
    num_layers: int = 2
    nhead: int = 4
    max_len: int = 32
    dtype: jnp.dtype = jnp.bfloat16

    def setup(self):
        self.tok_emb = nn.Embed(self.vocab_size, self.dim, dtype=self.dtype,
                                name="token_embedding")
        self.pos_emb = self.param("pos_embedding", nn.initializers.normal(0.02),
                                  (self.max_len, self.dim))
        self.encoder = TransformerEncoder(self.dim, self.nhead, self.num_layers,
                                          dtype=self.dtype)

    def embed_tokens(self, ids: jnp.ndarray) -> jnp.ndarray:
        """Embedding-table-only path — the analogue of the reference's frozen
        BERT *word embeddings* branch for RE fields (`item_tower.py:248-249`),
        except trainable. (..., T) -> (..., T, dim)."""
        return self.tok_emb(ids)

    def encode(self, ids: jnp.ndarray, mask: jnp.ndarray,
               deterministic: bool = True) -> jnp.ndarray:
        """Full contextual encoding + masked mean pool — the analogue of the
        full-BERT-forward [CLS] branch for names (`item_tower.py:270-272`).
        (B, T) -> (B, dim)."""
        x = self.tok_emb(ids) + self.pos_emb[None, : ids.shape[1]].astype(self.dtype)
        x = self.encoder(x, pad_mask=mask, deterministic=deterministic)
        return masked_mean(x, mask)


class PretrainedTextEncoder(nn.Module):
    """Frozen corpus-pretrained token table + trainable projection/encoder.

    The (vocab_size, pretrained_dim) table is a param so it rides the
    normal checkpoint path, but it is frozen twice over: ``stop_gradient``
    here (no backward compute) and a ``set_to_zero`` optimizer group (no
    weight decay drift). The artifact is loaded into the param after init
    (``train/simcse.train_simcse``), the same overwrite pattern as the
    stage-2 pretrained item matrix."""

    vocab_size: int = 8192
    dim: int = 128            # output/contextual width
    pretrained_dim: int = 128  # artifact embedding width
    num_layers: int = 2
    nhead: int = 4
    max_len: int = 32
    dtype: jnp.dtype = jnp.bfloat16

    def setup(self):
        self.pretrained_embedding = self.param(
            "pretrained_embedding", nn.initializers.normal(0.02),
            (self.vocab_size, self.pretrained_dim))
        self.proj = nn.Dense(self.dim, dtype=self.dtype, name="pretrained_proj")
        self.pos_emb = self.param("pos_embedding", nn.initializers.normal(0.02),
                                  (self.max_len, self.dim))
        self.encoder = TransformerEncoder(self.dim, self.nhead, self.num_layers,
                                          dtype=self.dtype)

    def _table(self) -> jnp.ndarray:
        return jax.lax.stop_gradient(self.pretrained_embedding)

    def embed_tokens(self, ids: jnp.ndarray) -> jnp.ndarray:
        """Frozen-table lookup + trainable projection — the analogue of the
        reference's frozen BERT *word embeddings* branch for RE fields
        (`item_tower.py:248-249`). (..., T) -> (..., T, dim)."""
        return self.proj(jnp.take(self._table(), ids, axis=0).astype(self.dtype))

    def encode(self, ids: jnp.ndarray, mask: jnp.ndarray,
               deterministic: bool = True) -> jnp.ndarray:
        """Frozen embeddings -> trainable contextual encoder + masked mean —
        the name branch (`item_tower.py:270-272`). (B, T) -> (B, dim)."""
        x = self.embed_tokens(ids)
        x = x + self.pos_emb[None, : ids.shape[1]].astype(self.dtype)
        x = self.encoder(x, pad_mask=mask, deterministic=deterministic)
        return masked_mean(x, mask)
