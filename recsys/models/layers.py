"""Shared Flax building blocks (bf16 compute / fp32 params).

Re-implementations of the reference's torch modules: SE-gated
residual blocks and the progressive-expansion head (`item_tower.py:41-128`),
and a pre-norm transformer encoder equivalent to
``nn.TransformerEncoderLayer(norm_first=True)`` used by both towers
(`item_tower.py:169-182`, `v1_refine_usertower.py:413-415`). All matmul
dims stay multiples of 128 so XLA tiles them cleanly onto the matrix units.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
from flax import linen as nn

Dtype = jnp.dtype


class MLP(nn.Module):
    features: Sequence[int]
    dtype: Dtype = jnp.bfloat16
    activate_last: bool = False
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        for i, f in enumerate(self.features):
            x = nn.Dense(f, dtype=self.dtype)(x)
            if i < len(self.features) - 1 or self.activate_last:
                x = nn.gelu(x)
                if self.dropout > 0:
                    x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        return x


class SEResidualBlock(nn.Module):
    """LayerNorm -> dim->4dim->dim GELU MLP, gated by a squeeze-excitation
    sigmoid channel-attention path, residual add (`item_tower.py:41-75`)."""

    dim: int
    se_ratio: int = 4
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = nn.Dense(4 * self.dim, dtype=self.dtype)(h)
        h = nn.gelu(h)
        h = nn.Dense(self.dim, dtype=self.dtype)(h)
        # squeeze-excitation channel gate
        s = nn.Dense(self.dim // self.se_ratio, dtype=self.dtype)(h)
        s = nn.gelu(s)
        s = nn.Dense(self.dim, dtype=self.dtype)(s)
        gate = nn.sigmoid(s)
        return x + h * gate


class DeepResidualHead(nn.Module):
    """Progressive expansion dim -> hidden[...] with SE blocks, compression
    back to dim, plus a global input skip (`item_tower.py:77-128`)."""

    dim: int = 128
    hidden: Sequence[int] = (256, 512)
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        skip = nn.Dense(self.dim, dtype=self.dtype, name="input_skip")(x)
        h = x
        for f in self.hidden:
            h = nn.Dense(f, dtype=self.dtype)(h)
            h = nn.gelu(h)
            h = SEResidualBlock(f, dtype=self.dtype)(h, deterministic)
        h = nn.Dense(self.dim, dtype=self.dtype)(h)
        return nn.LayerNorm(dtype=self.dtype)(h + skip)


class TransformerBlock(nn.Module):
    """Pre-norm MHA + MLP block; boolean masks, causal optional."""

    d_model: int
    nhead: int
    mlp_ratio: int = 4
    dropout: float = 0.0
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, pad_mask=None, causal: bool = False,
                 deterministic: bool = True):
        B, L, _ = x.shape
        attn_mask = None
        if pad_mask is not None:
            # (B, 1, 1, L): every query may attend only to real keys
            attn_mask = pad_mask[:, None, None, :].astype(bool)
        if causal:
            tri = jnp.tril(jnp.ones((L, L), dtype=bool))[None, None]
            attn_mask = tri if attn_mask is None else (attn_mask & tri)
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = nn.MultiHeadDotProductAttention(
            num_heads=self.nhead, dtype=self.dtype,
            dropout_rate=self.dropout, deterministic=deterministic,
        )(h, h, mask=attn_mask)
        x = x + h
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = MLP([self.mlp_ratio * self.d_model, self.d_model], dtype=self.dtype,
                dropout=self.dropout)(h, deterministic)
        return x + h


class TransformerEncoder(nn.Module):
    d_model: int
    nhead: int
    num_layers: int
    dropout: float = 0.0
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, pad_mask=None, causal: bool = False,
                 deterministic: bool = True):
        for _ in range(self.num_layers):
            x = TransformerBlock(self.d_model, self.nhead, dropout=self.dropout,
                                 dtype=self.dtype)(
                x, pad_mask=pad_mask, causal=causal, deterministic=deterministic)
        return nn.LayerNorm(dtype=self.dtype)(x)


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis: int = -2) -> jnp.ndarray:
    """Mean over ``axis`` counting only mask==1 positions (safe for empty)."""
    m = mask.astype(x.dtype)[..., None]
    s = jnp.sum(x * m, axis=axis)
    d = jnp.clip(jnp.sum(m, axis=axis), 1e-6, None)
    return s / d
