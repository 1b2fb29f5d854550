"""Stage-2 user-tower training pipeline.

Redesign of ``run_pipeline`` (reference `v1_usertower_train.py:897-1025`)
and its loops (`train_user_tower_all_time` `:717-893`):

  * one jitted step: item-matrix lookups, two dropout-view forwards, the
    LogQ-corrected in-batch sampled softmax over sampled timesteps with
    same-user masking, + DuoRec on the last step;
  * the reference flattens the *dynamic* set of valid timesteps; here we
    sample a STATIC ``positions_per_user`` valid positions per user per step
    (categorical over the padding mask) — same gradient signal, fixed
    shapes (SURVEY.md §7.3 "ragged data");
  * freeze->unfreeze of the item matrix is a gradient gate schedule + a
    5%-scaled lr group (static optimizer tree, resume-safe);
  * per-epoch full-catalog Recall@{20,100,500}; ReduceLROnPlateau on
    Recall@100 via a serialized update-scale; best checkpoint by Recall@100;
    ``resume=True`` restores the latest full train state and continues
    (reference `run_resume_pipeline` `:1028-1152`).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recsys.config import Config
from recsys.data import etl
from recsys.data.dataset import batch_iterator, build_sasrec_tensors, build_side_info
from recsys.eval.recall import recall_at_ks, target_rows, topk_scores
from recsys.models.user_tower import SASRecItemTower, SASRecUserTower
from recsys.ops.contrastive import duorec_loss, inbatch_logq_loss, l2_normalize
from recsys.parallel.mesh import data_sharding, replicated
from recsys.train.checkpoint import CheckpointStore, align_rows, snapshot_due
from recsys.train.metrics import (
    MetricWriter, gate_weights, static_branch_importance)
from recsys.train.state import (
    PlateauScheduler,
    TrainState,
    freeze_gate_schedule,
    label_params,
    set_lr_factor,
    with_lr_factor,
)

BATCH_KEYS = ("input_ids", "target_ids", "time_buckets", "seq_mask",
              "user_buckets", "user_cats", "user_cont")


def _make_a2a_lookup(mesh):
    """DLRM-style row-sharded item-matrix lookup (UserTrainConfig.lookup
    = 'a2a'): the data-local id batch is re-split over the model axis, each
    model shard resolves its slice against its table rows via all_to_all
    (`parallel.collectives.rowsharded_lookup_a2a`), and an all_gather
    reassembles the data-local result. Per-shard exchange traffic is
    O(B·D/S) vs the psum path's O(B·D); wired here so the full stage-2 step
    exercises it under `__graft_entry__.dryrun_multichip`."""
    from jax.sharding import PartitionSpec as P

    from recsys.parallel.collectives import rowsharded_lookup_a2a
    from recsys.parallel.mesh import smap

    data_ax, model_ax = mesh.axis_names
    n_model = dict(mesh.shape)[model_ax]

    def _local(table_local, ids_local):
        flat = ids_local.reshape(-1)
        b = flat.shape[0]
        pad = -b % n_model
        flat = jnp.pad(flat, (0, pad))
        chunk = flat.shape[0] // n_model
        mine = jax.lax.dynamic_slice_in_dim(
            flat, jax.lax.axis_index(model_ax) * chunk, chunk)
        emb_mine = rowsharded_lookup_a2a(table_local, mine, model_ax)
        emb = jax.lax.all_gather(emb_mine, model_ax, axis=0, tiled=True)[:b]
        return emb.reshape(*ids_local.shape, table_local.shape[1])

    def lookup(params, ids):
        out_spec = P(data_ax, *(None,) * ids.ndim)
        return smap(_local, mesh,
                    in_specs=(P(model_ax, None),
                              P(data_ax, *(None,) * (ids.ndim - 1))),
                    out_specs=out_spec)(params["item"]["item_matrix"], ids)

    return lookup


def prepare_stage2(cfg: Config, items, users, tx_df):
    """ETL -> fixed-shape stage-2 training data (the analogue of the
    reference's FeatureProcessor + dataset build, `v1_usertower_train.py:81-184`)."""
    train_tx, valid_tx, split_day = etl.time_split(tx_df, cfg.data.valid_days)
    side, item_map = build_side_info(items, cfg.vocab.num_hash_buckets)
    user_feats, scaler = etl.make_user_features(train_tx, users, split_day)
    seqs = etl.make_sequences(train_tx, cfg.user_tower.max_len)
    tensors = build_sasrec_tensors(seqs, user_feats, item_map, cfg.user_tower)
    item_feats = etl.make_item_features(train_tx, items, split_day)
    logq = etl.logq_from_item_features(item_feats, item_map.ids)
    targets = etl.make_validation_target(valid_tx)
    targets_idx = {u: {item_map.idx(i) for i in its} - {0}
                   for u, its in targets.items()}
    return {
        "tensors": tensors, "side": side, "item_map": item_map, "logq": logq,
        "targets_idx": targets_idx, "user_feats": user_feats, "scaler": scaler,
        "split_day": split_day, "item_feats": item_feats,
    }


def init_stage2_params(cfg: Config, num_items_pad: int, pretrained: np.ndarray | None,
                       key: jax.Array, sample_batch: dict):
    user_model = SASRecUserTower(cfg.user_tower, num_id_embeddings=num_items_pad)
    item_model = SASRecItemTower(num_items_pad, cfg.user_tower.d_model)
    k1, k2 = jax.random.split(key)
    B, L = sample_batch["input_ids"].shape
    dummy_vecs = jnp.zeros((B, L, cfg.user_tower.d_model))
    dummy_side = jnp.zeros((B, L, cfg.user_tower.num_side_fields), jnp.int32)
    # jit the inits: un-jitted flax init executes op-by-op (one dispatch
    # and one compile per op)
    user_params = jax.jit(user_model.init)(
        {"params": k1, "dropout": k1}, dummy_vecs, sample_batch["input_ids"],
        sample_batch["time_buckets"], dummy_side, sample_batch["seq_mask"],
        sample_batch["user_buckets"], sample_batch["user_cats"],
        sample_batch["user_cont"])["params"]
    item_params = jax.jit(item_model.init)(k2, jnp.zeros((2,), jnp.int32))["params"]
    if pretrained is not None:
        item_params = {"item_matrix": jnp.asarray(pretrained, jnp.float32)}
    return {"user": user_params, "item": item_params}, (user_model, item_model)


def make_stage2_optimizer(cfg: Config, params, steps_per_epoch: int):
    ut = cfg.user_train
    freeze_steps = ut.freeze_item_epochs * steps_per_epoch
    groups = {
        "user": optax.adamw(ut.lr, weight_decay=ut.weight_decay),
        "item": optax.chain(
            optax.scale_by_schedule(freeze_gate_schedule(freeze_steps)),
            optax.adamw(ut.lr * ut.unfrozen_item_lr_scale,
                        weight_decay=ut.weight_decay)),
    }
    tx = optax.multi_transform(
        groups, label_params(params, lambda p: "item" if p.startswith("item") else "user"))
    tx = optax.chain(optax.clip_by_global_norm(ut.grad_clip), tx)
    return with_lr_factor(tx)


def make_stage2_step(cfg: Config, models, side: np.ndarray, logq: np.ndarray,
                     mesh=None):
    user_model, item_model = models
    ut, utc = cfg.user_train, cfg.user_tower
    side_c = jnp.asarray(side)
    logq_c = jnp.asarray(logq)
    P_ = ut.positions_per_user

    if ut.lookup == "a2a":
        if mesh is None:
            raise ValueError("lookup='a2a' needs a mesh")
        lookup = _make_a2a_lookup(mesh)
    else:  # "dense": jnp.take under jit-SPMD (XLA picks the collectives)
        def lookup(params, ids):
            return item_model.apply({"params": params["item"]}, ids)

    def forward(params, batch, key, deterministic=False):
        item_vecs = lookup(params, batch["input_ids"])
        side_ids = jnp.take(side_c, batch["input_ids"], axis=0)
        return user_model.apply(
            {"params": params["user"]}, item_vecs, batch["input_ids"],
            batch["time_buckets"], side_ids, batch["seq_mask"],
            batch["user_buckets"], batch["user_cats"], batch["user_cont"],
            all_timesteps=True, deterministic=deterministic,
            rngs={"dropout": key})

    def loss_fn(params, batch, key):
        k1, k2, kp, kc = jax.random.split(key, 4)
        if ut.random_cut_prob > 0:
            # random-cut sequence augmentation on the stage-2 path too
            # (reference applies it on the hybrid v2 line,
            # `mined_inference.py:153-163`; same left-pad invariant here)
            from recsys.ops.augment import random_cut

            batch = random_cut(batch, kc, ut.random_cut_prob)
        u1 = forward(params, batch, k1)                      # (B, L, D)
        u2 = forward(params, batch, k2)
        B, L, D = u1.shape
        # sample P_ valid positions per user (static shape)
        logits = jnp.where(batch["seq_mask"] > 0, 0.0, -1e9)  # (B, L)
        pos = jax.random.categorical(kp, logits[:, None, :], axis=-1,
                                     shape=(B, P_))           # (B, P_)
        rows = jnp.take_along_axis(u1, pos[..., None], axis=1).reshape(B * P_, D)
        tgt_ids = jnp.take_along_axis(batch["target_ids"], pos, axis=1).reshape(-1)
        tgt_emb = lookup(params, tgt_ids)
        if ut.item_target_norm == "l2" or ut.loss_variant in (
                "hnm", "mixed_hnm", "margin"):  # mining assumes cosine
            tgt_emb = l2_normalize(tgt_emb)
        user_row_ids = jnp.repeat(jnp.arange(B), P_)
        if ut.loss_variant == "hnm":
            from recsys.ops.contrastive import hnm_corrected_loss

            main, _stats = hnm_corrected_loss(
                rows, tgt_emb, tgt_ids, logq_c, temperature=ut.temperature,
                lambda_logq=ut.lambda_logq, top_k_percent=ut.top_k_percent,
                threshold=ut.hnm_threshold)
        elif ut.loss_variant == "mixed_hnm":
            from recsys.ops.contrastive import mixed_hnm_loss

            key_hnm = jax.random.fold_in(kp, 1)
            main, _stats = mixed_hnm_loss(
                rows, tgt_emb, tgt_ids, logq_c, key_hnm,
                temperature=ut.temperature, lambda_logq=ut.lambda_logq,
                top_k_percent=ut.top_k_percent, threshold=ut.hnm_threshold,
                num_random=ut.num_random_negs)
        elif ut.loss_variant == "margin":
            from recsys.ops.contrastive import full_batch_hard_emphasis_loss

            main = full_batch_hard_emphasis_loss(
                rows, tgt_emb, tgt_ids, logq_c, temperature=ut.temperature,
                lambda_logq=ut.lambda_logq, top_k_percent=ut.top_k_percent,
                threshold=ut.hnm_threshold, margin=ut.hard_margin)
        else:  # "logq" — the run_pipeline default
            main = inbatch_logq_loss(
                rows, tgt_emb, tgt_ids, logq_c, temperature=ut.temperature,
                lambda_logq=ut.lambda_logq, user_ids=user_row_ids)
        cl = duorec_loss(u1[:, -1], u2[:, -1], batch["target_ids"][:, -1],
                         temperature=ut.temperature, lambda_sup=ut.lambda_sup)
        return main + ut.lambda_cl * cl, {"main": main, "cl": cl}

    @jax.jit
    def step(state: TrainState, batch, key):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, key)
        new_state = state.apply_gradients(grads)
        aux["loss"] = loss
        return new_state, aux

    @jax.jit
    def user_vectors(params, batch):
        item_vecs = lookup(params, batch["input_ids"])
        side_ids = jnp.take(side_c, batch["input_ids"], axis=0)
        return user_model.apply(
            {"params": params["user"]}, item_vecs, batch["input_ids"],
            batch["time_buckets"], side_ids, batch["seq_mask"],
            batch["user_buckets"], batch["user_cats"], batch["user_cont"],
            all_timesteps=False, deterministic=True)

    return step, user_vectors


def _slice(tensors: dict, idx: np.ndarray) -> dict:
    return {k: tensors[k][idx] for k in BATCH_KEYS}


def collect_user_vectors(cfg: Config, state_params, user_vectors_fn, data,
                         mesh, batch_size: int | None = None,
                         rows: np.ndarray | None = None):
    """Forward eval users through the tower -> (uvecs (B,D), user_ids).
    ``rows`` optionally restricts to a subset of tensor rows."""
    tensors = data["tensors"]
    all_rows = (np.arange(tensors["input_ids"].shape[0])
                if rows is None else np.asarray(rows))
    n = len(all_rows)
    bs = batch_size or cfg.user_train.batch_size
    user_ids = tensors["user_ids"]
    uids = [user_ids[r] for r in all_rows]
    vecs, origs = [], []
    for s in range(0, n, bs):
        idx = all_rows[s:min(s + bs, n)]
        origs.append(len(idx))
        if origs[-1] < bs:
            idx = np.concatenate([idx, np.zeros(bs - origs[-1], np.int64)])
        batch = jax.device_put(_slice(tensors, idx), data_sharding(mesh))
        # keep results on device; a per-batch np.asarray would sync the
        # host with the device on every one of 280+ batches
        vecs.append(user_vectors_fn(state_params, batch))
    if not vecs:
        return np.zeros((0, cfg.user_tower.d_model), np.float32), uids
    return np.concatenate([np.asarray(v)[:o] for v, o in zip(vecs, origs)]), uids


def evaluate_stage2(cfg: Config, state_params, user_vectors_fn, data, mesh,
                    batch_size: int | None = None) -> dict:
    # only users WITH validation targets are scored (the reference filters
    # to target-parquet users before scoring, `v1_usertower_train.py:651-658`
    # — on a 200k-user world this is a 6x eval cut with identical metrics,
    # since recall_at_ks drops target-less users from the denominator anyway)
    targets = data["targets_idx"]
    rows = target_rows(data["tensors"]["user_ids"], targets)
    uvecs, uids = collect_user_vectors(cfg, state_params, user_vectors_fn,
                                       data, mesh, batch_size, rows=rows)
    # ONE device upload of the item matrix — re-uploading the (N+1, D)
    # matrix per batch dominated eval wall-clock at reference catalog scale
    item_dev = jnp.asarray(state_params["item"]["item_matrix"])
    max_k = max(cfg.user_train.eval_ks)
    bs = batch_size or cfg.user_train.batch_size
    n = len(uvecs)
    if n == 0:
        return recall_at_ks(np.zeros((0, max_k), np.int64), [], targets,
                            cfg.user_train.eval_ks)
    padded = np.concatenate([uvecs, np.zeros((-n % bs, uvecs.shape[1]),
                                             uvecs.dtype)]) if n % bs else uvecs
    norm = cfg.user_train.eval_score != "dot"
    # ONE jitted executable for the whole loop: an eager topk_scores is
    # ~8 op dispatches per batch, at 218k eval users (284 batches).
    score_fn = jax.jit(lambda u, it: topk_scores(u, it, max_k, mesh=mesh,
                                                 normalize_items=norm)[1])
    all_idx = [score_fn(padded[s:s + bs], item_dev)
               for s in range(0, len(padded), bs)]   # device-side, no syncs
    return recall_at_ks(np.concatenate([np.asarray(i) for i in all_idx])[:n],
                        uids, targets, cfg.user_train.eval_ks)


def train_user_tower(cfg: Config, data: dict, pretrained_matrix: np.ndarray | None,
                     mesh, workdir: str, resume: bool = False,
                     writer: MetricWriter | None = None):
    ut = cfg.user_train
    tensors = data["tensors"]
    n = tensors["input_ids"].shape[0]
    bs = min(ut.batch_size, max(n - n % 8, 8))
    base_steps = max(n // bs, 1)
    passes = max(1, -(-ut.steps_per_epoch_min // base_steps))
    steps_per_epoch = base_steps * passes

    key = jax.random.PRNGKey(cfg.data.seed)
    num_items_pad = len(data["item_map"]) + 1
    sample = _slice(tensors, np.arange(min(bs, n)))
    params, models = init_stage2_params(cfg, num_items_pad, pretrained_matrix,
                                        key, sample)
    tx = make_stage2_optimizer(cfg, params, steps_per_epoch)
    state = TrainState.create(params, tx)
    store = CheckpointStore(workdir, maximize=True)
    start_epoch = 1
    plateau = PlateauScheduler(ut.plateau_factor, ut.plateau_patience)
    if resume:
        restored = store.restore_latest(state)
        if restored is not None:
            state, entry = restored
            start_epoch = entry["extra"].get("epoch", 0) + 1
            if entry["extra"].get("plateau_best") is not None:
                plateau.best = entry["extra"]["plateau_best"]
                plateau.scale = entry["extra"].get("plateau_scale", 1.0)
    state = jax.device_put(state, replicated(mesh))
    step_fn, user_vectors_fn = make_stage2_step(cfg, models, data["side"],
                                                data["logq"], mesh=mesh)
    writer = writer or MetricWriter(f"{workdir}/metrics.jsonl", "sasrec")

    rng = np.random.default_rng(cfg.data.seed + 1)
    gstep = (start_epoch - 1) * steps_per_epoch
    history = []
    for epoch in range(start_epoch, ut.epochs + 1):
        t0, seen = time.time(), 0
        for _pass in range(passes):
            for idx in batch_iterator(n, bs, rng):
                batch = jax.device_put(_slice(tensors, idx), data_sharding(mesh))
                key, sub = jax.random.split(key)
                state, aux = step_fn(state, batch, sub)
                gstep += 1
                seen += bs
                if gstep % min(100, steps_per_epoch) == 0:
                    writer.write("train", gstep, loss=float(aux["loss"]),
                                 main=float(aux["main"]), cl=float(aux["cl"]),
                                 examples_per_s=seen / max(time.time() - t0, 1e-9),
                                 **gate_weights(state.params["user"]))
        metrics = evaluate_stage2(cfg, state.params, user_vectors_fn, data, mesh, bs)
        r100 = metrics.get("recall@100", 0.0)
        writer.write("eval", epoch, **metrics,
                     **{f"imp_{k}": v for k, v in static_branch_importance(
                         state.params["user"], cfg.user_tower).items()})
        history.append(metrics)
        improved = plateau.best is None or r100 > plateau.best
        scale = plateau.update(r100)
        state = state.replace(opt_state=set_lr_factor(state.opt_state, scale))
        if snapshot_due(epoch, ut.epochs, ut.ckpt_every, improved):
            store.save(f"ep{epoch:03d}", state, step=gstep, metric=r100,
                       extra={"epoch": epoch, "plateau_best": plateau.best,
                              "plateau_scale": plateau.scale, **metrics})
    return state, history, (models, user_vectors_fn)
