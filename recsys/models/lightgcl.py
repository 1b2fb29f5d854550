"""LightGCL: SVD-augmented graph contrastive learning + magnitude->cosine
distillation projector, in plain JAX (no module library).

Redesign of `gnn_model/v1_lightgcl.py` and
`gnn_model/distill_mag_to_cos_l2.py`:

  * user/item embeddings (dim 64, xavier init) in one
    ``{"user_emb", "item_emb"}`` params dict;
  * LOCAL view — n-layer COO segment-sum propagation, layer-mean;
  * GLOBAL view — propagation through the rank-q SVD reconstruction,
    layer-mean;
  * BPR pairwise loss on the local view; robust InfoNCE SSL between local
    and global views of the batch's unique users/items (logits clamped to
    +-100, `v1_lightgcl.py:197-213`); L2 regularization on batch embeddings.

``MagnitudeEncoder``: MLP 64 -> 128 -> 64 + L2 norm + learnable CLIP-style
logit scale, distilling the teacher's DOT-product scores (which carry
popularity via embedding magnitude) into pure cosine geometry so
cosine-only ANN engines preserve popularity ranking
(`distill_mag_to_cos_l2.py:6-108`).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from recsys.ops.contrastive import l2_normalize
from recsys.ops.graph import svd_propagate


def init_lightgcl(key: jax.Array, num_users: int, num_items: int,
                  emb_dim: int) -> dict:
    """Xavier-uniform layer-0 tables: ``{"user_emb": (Nu, D), "item_emb":
    (Ni, D)}`` (the names checkpoints and exports key on)."""
    init = jax.nn.initializers.glorot_uniform()
    ku, ki = jax.random.split(key)
    return {"user_emb": init(ku, (num_users, emb_dim), jnp.float32),
            "item_emb": init(ki, (num_items, emb_dim), jnp.float32)}


def lightgcl_forward(params: dict, prop_fn, prop_args, svd_u, svd_s, svd_v,
                     num_layers: int):
    """Full-graph forward -> (local_u, local_i, global_u, global_i).

    ``prop_fn(prop_args, x) -> A_norm @ x`` is the propagation backend
    chosen by ``train/gnn.select_propagation``."""
    num_users = params["user_emb"].shape[0]
    x0 = jnp.concatenate([params["user_emb"],
                          params["item_emb"]]).astype(jnp.float32)
    local_sum, global_sum = x0, x0
    x_loc, x_glb = x0, x0
    for _ in range(num_layers):
        x_loc = prop_fn(prop_args, x_loc)
        x_glb = svd_propagate(x_glb, svd_u, svd_s, svd_v)
        local_sum = local_sum + x_loc
        global_sum = global_sum + x_glb
    denom = num_layers + 1
    local = local_sum / denom
    glob = global_sum / denom
    return (local[:num_users], local[num_users:],
            glob[:num_users], glob[num_users:])


def bpr_loss(local_u, local_i, users, pos, neg) -> jnp.ndarray:
    u = jnp.take(local_u, users, axis=0)
    p = jnp.take(local_i, pos, axis=0)
    ng = jnp.take(local_i, neg, axis=0)
    diff = jnp.sum(u * p, -1) - jnp.sum(u * ng, -1)
    return -jnp.mean(jax.nn.log_sigmoid(diff))


def ssl_loss(local, glob, ids, temperature: float, clamp: float = 100.0) -> jnp.ndarray:
    """InfoNCE aligning local vs global views of the SAME nodes against the
    other batch nodes. Duplicate batch ids are down-weighted to mimic the
    reference's unique-node handling without dynamic shapes."""
    a = l2_normalize(jnp.take(local, ids, axis=0))
    b = l2_normalize(jnp.take(glob, ids, axis=0))
    logits = jnp.clip(a @ b.T / temperature, -clamp, clamp)
    same = ids[None, :] == ids[:, None]
    eye = jnp.eye(ids.shape[0], dtype=bool)
    logits = jnp.where(same & ~eye, -3e4, logits)  # duplicate nodes aren't negatives
    logp = jnp.diagonal(jax.nn.log_softmax(logits, -1))
    # weight 1/multiplicity so each unique node counts once
    mult = jnp.sum(same, axis=-1).astype(jnp.float32)
    return -jnp.sum(logp / mult) / jnp.clip(jnp.sum(1.0 / mult), 1.0, None)


def reg_loss(params, users, pos, neg) -> jnp.ndarray:
    u = jnp.take(params["user_emb"], users, axis=0)
    p = jnp.take(params["item_emb"], pos, axis=0)
    ng = jnp.take(params["item_emb"], neg, axis=0)
    return 0.5 * (jnp.sum(u**2) + jnp.sum(p**2) + jnp.sum(ng**2)) / users.shape[0]


@dataclass(frozen=True)
class MagnitudeEncoder:
    """Student projector folding dot-product magnitude into cosine angles.

    Params keep the layout of a two-layer dense stack:
    ``{"Dense_0": {"kernel", "bias"}, "Dense_1": {...}, "logit_scale"}``."""

    in_dim: int = 64
    hidden: int = 128
    out_dim: int = 64

    def init(self, key: jax.Array) -> dict:
        k0, k1 = jax.random.split(key)
        kinit = jax.nn.initializers.lecun_normal()
        return {
            "Dense_0": {"kernel": kinit(k0, (self.in_dim, self.hidden), jnp.float32),
                        "bias": jnp.zeros((self.hidden,), jnp.float32)},
            "Dense_1": {"kernel": kinit(k1, (self.hidden, self.out_dim), jnp.float32),
                        "bias": jnp.zeros((self.out_dim,), jnp.float32)},
            "logit_scale": jnp.asarray(jnp.log(10.0), jnp.float32),
        }

    def __call__(self, params: dict, x):
        h = x.astype(jnp.float32) @ params["Dense_0"]["kernel"] + params["Dense_0"]["bias"]
        h = jax.nn.gelu(h)
        h = h @ params["Dense_1"]["kernel"] + params["Dense_1"]["bias"]
        return l2_normalize(h), params["logit_scale"]


def distill_loss(student_u, student_i, scale, teacher_u, teacher_i) -> jnp.ndarray:
    """MSE between teacher dot scores and student cos * exp(scale)."""
    t = teacher_u @ teacher_i.T
    s = (student_u @ student_i.T) * jnp.exp(scale)
    return jnp.mean((t - s) ** 2)
