"""Stage-1 SimCSE training of the item tower + item-vector materialization.

Redesign of the reference loop (`train_simcse_from_db`,
`item_tower.py:887-1127`):

  * the whole step — two-view corruption, both tower forwards, bidirectional
    InfoNCE at tau=0.08 — is ONE jitted program; corruption is on-device
    masking (ops/augment.py), so there is no per-step host work at all;
  * bf16 towers / fp32 loss — no GradScaler needed with bf16 (SURVEY.md §7.1);
  * two-lr AdamW groups (text encoder at the low 'BERT' lr) + linear
    warmup/decay;
  * under jit-SPMD with a data-sharded batch the (B,B) similarity is a
    global-batch program: on a mesh the in-batch negatives are
    automatically *global* negatives (SURVEY.md §2.12.3);
  * alignment/uniformity logged every ``metrics_every`` steps;
  * per-epoch encoder checkpoints, best by loss.

Materialization (`materialize_item_vectors`) is the batch-inference path of
`generate_and_save_item_vectors` (`utils/inference_utils.py:74-207`):
deterministic encoder forward over the sorted catalog, saved as an (N+1,D)
matrix (row 0 = PAD) with the id-map sidecar.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recsys.config import Config
from recsys.data.dataset import batch_iterator, slice_item_batch
from recsys.models.item_tower import SimCSEModel
from recsys.ops.augment import two_views
from recsys.ops.contrastive import bidirectional_infonce
from recsys.parallel.mesh import data_sharding, replicated
from recsys.train.checkpoint import CheckpointStore, save_array_with_ids
from recsys.train.metrics import MetricWriter, alignment, uniformity
from recsys.train.state import TrainState, grouped_adamw, warmup_linear_schedule


def build_model(cfg: Config, std_vocab_size: int, num_std_fields: int) -> SimCSEModel:
    return SimCSEModel(std_vocab_size, num_std_fields, cfg.item_tower, cfg.vocab)


def init_params(model: SimCSEModel, tensors: dict, key: jax.Array):
    sample = slice_item_batch(tensors, np.arange(2))
    return jax.jit(model.init)({"params": key, "dropout": key},
                               sample["std"], sample["re_ids"], sample["re_mask"],
                               sample["txt_ids"], sample["txt_mask"])["params"]


def make_optimizer(cfg: Config, params, total_steps: int):
    sc = cfg.simcse
    main = warmup_linear_schedule(sc.lr, total_steps, sc.warmup_frac)
    text = warmup_linear_schedule(sc.text_encoder_lr, total_steps, sc.warmup_frac)
    groups = {
        # the corpus-pretrained token table never moves: stop_gradient in
        # the forward zeroes its grads; set_to_zero here blocks the adamw
        # weight decay that would otherwise still shrink it
        "frozen": optax.set_to_zero(),
        "text": optax.adamw(text, weight_decay=sc.weight_decay),
        "rest": optax.adamw(main, weight_decay=sc.weight_decay),
    }

    def label(p: str) -> str:
        if "pretrained_embedding" in p:
            return "frozen"
        return "text" if "text_encoder" in p else "rest"

    return grouped_adamw(groups, params, label)


def make_train_step(model: SimCSEModel, cfg: Config):
    sc = cfg.simcse
    def loss_fn(params, batch, key):
        kv, kd1, kd2 = jax.random.split(key, 3)
        v1, v2 = two_views(batch, kv, sc.feature_dropout)
        emb1 = model.apply({"params": params}, v1["std"], v1["re_ids"],
                           v1["re_mask"], v1["txt_ids"], v1["txt_mask"],
                           deterministic=False, rngs={"dropout": kd1})
        emb2 = model.apply({"params": params}, v2["std"], v2["re_ids"],
                           v2["re_mask"], v2["txt_ids"], v2["txt_mask"],
                           deterministic=False, rngs={"dropout": kd2})
        loss = bidirectional_infonce(emb1, emb2, sc.temperature)
        return loss, (emb1, emb2)

    @jax.jit
    def step(state: TrainState, batch, key):
        (loss, (e1, e2)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, key)
        new_state = state.apply_gradients(grads)
        aux = {"loss": loss, "align": alignment(e1, e2), "uniform": uniformity(e1)}
        return new_state, aux

    return step


def train_simcse(cfg: Config, tensors: dict, mesh, workdir: str,
                 writer: MetricWriter | None = None,
                 init_ckpt: str | None = None,
                 text_pretrain: np.ndarray | None = None) -> TrainState:
    """Full stage-1 training over pre-tokenized item tensors.

    ``text_pretrain``: optional (V, dp) corpus-pretrained token matrix
    (data/text_pretrain.py artifact) loaded into the frozen
    ``pretrained_embedding`` param after init — the same overwrite pattern
    as the stage-2 pretrained item matrix."""
    sc = cfg.simcse
    n = tensors["std"].shape[0]
    steps_per_epoch = max(n // sc.batch_size, 1)
    # steps floor: small catalogs re-pass (fresh shuffles + fresh corruption
    # views) until the epoch has reference-scale step counts
    passes = max(1, -(-sc.steps_per_epoch_min // steps_per_epoch))
    total_steps = steps_per_epoch * passes * sc.epochs

    from recsys.data.vocab import StdVocab
    model = build_model(cfg, StdVocab().size, tensors["std"].shape[1])
    key = jax.random.PRNGKey(cfg.data.seed)
    params = init_params(model, tensors, key)
    if text_pretrain is not None:
        te = dict(params["encoder"]["text_encoder"])
        if "pretrained_embedding" not in te:
            raise ValueError("text_pretrain given but item_tower.text_encoder "
                             "is not 'pretrained'")
        if tuple(te["pretrained_embedding"].shape) != tuple(text_pretrain.shape):
            raise ValueError(f"pretrain artifact {text_pretrain.shape} != "
                             f"param {te['pretrained_embedding'].shape}")
        te["pretrained_embedding"] = jnp.asarray(text_pretrain, jnp.float32)
        params = {**params, "encoder": {**params["encoder"], "text_encoder": te}}
    store = CheckpointStore(workdir, maximize=False)
    if init_ckpt:
        params = store.restore(init_ckpt, params)
    tx = make_optimizer(cfg, params, total_steps)
    state = TrainState.create(params, tx)
    state = jax.device_put(state, replicated(mesh))
    step_fn = make_train_step(model, cfg)
    writer = writer or MetricWriter(f"{workdir}/metrics.jsonl", "simcse")

    rng = np.random.default_rng(cfg.data.seed)
    gstep, t0, seen = 0, time.time(), 0
    for epoch in range(1, sc.epochs + 1):
        epoch_loss, nb = 0.0, 0
        for _pass in range(passes):
            for idx in batch_iterator(n, sc.batch_size, rng):
                batch = jax.device_put(slice_item_batch(tensors, idx), data_sharding(mesh))
                key, sub = jax.random.split(key)
                state, aux = step_fn(state, batch, sub)
                epoch_loss += float(aux["loss"]); nb += 1; gstep += 1
                seen += sc.batch_size
                if gstep % sc.metrics_every == 0:
                    dt = time.time() - t0
                    writer.write("train", gstep, loss=float(aux["loss"]),
                                 align=float(aux["align"]), uniform=float(aux["uniform"]),
                                 examples_per_s=seen / max(dt, 1e-9))
        mean_loss = epoch_loss / max(nb, 1)
        writer.write("epoch", epoch, loss=mean_loss)
        store.save(f"encoder_ep{epoch:02d}", {"params": jax.device_get(state.params)},
                   step=gstep, metric=mean_loss)
    return state


# -- materialization + retrieval ------------------------------------------

def materialize_item_vectors(cfg: Config, params, tensors: dict, mesh,
                             out_path: str, batch_size: int | None = None) -> np.ndarray:
    """Deterministic encoder forward over the whole catalog ->
    (N+1, D) matrix (row 0 = PAD) + id sidecar at ``out_path``."""
    from recsys.data.vocab import StdVocab
    model = build_model(cfg, StdVocab().size, tensors["std"].shape[1])
    bs = batch_size or cfg.serve.batch_size * cfg.serve.fast_mode_multiplier

    @jax.jit
    def encode(p, batch):
        return model.apply({"params": p}, batch["std"], batch["re_ids"],
                           batch["re_mask"], batch["txt_ids"], batch["txt_mask"],
                           method=SimCSEModel.encode)

    n = tensors["std"].shape[0]
    outs = []
    for s in range(0, n, bs):
        idx = np.arange(s, min(s + bs, n))
        if len(idx) < bs:  # pad the tail to keep one compiled shape
            idx = np.concatenate([idx, np.full(bs - len(idx), n - 1)])
        batch = jax.device_put(slice_item_batch(tensors, idx), data_sharding(mesh))
        outs.append(np.asarray(encode(params, batch)))
    mat = np.concatenate(outs)[:n]
    full = np.concatenate([np.zeros((1, mat.shape[1]), mat.dtype), mat])
    save_array_with_ids(out_path, full, tensors["item_ids"],
                        meta={"dim": int(mat.shape[1]), "pad_row": 0})
    return full


def topk_items(item_matrix: np.ndarray, queries: np.ndarray, k: int = 50):
    """Exact dot-product top-k against the catalog (the serving/eval
    retrieval path; rows are L2-normalized so dot == cosine). Returns
    (scores, indices into the padded matrix). Row 0 (PAD) is excluded."""
    q = jnp.asarray(queries, jnp.float32)
    m = jnp.asarray(item_matrix, jnp.float32)
    scores = q @ m.T
    scores = scores.at[:, 0].set(-jnp.inf)
    vals, idx = jax.lax.top_k(scores, k)
    return np.asarray(vals), np.asarray(idx)
