"""One typed configuration tree for every entry point.

The reference scatters configuration across four styles (.env, module-level
constants, ``PipelineConfig`` dataclass, dict variants — see SURVEY.md §5
"Config / flag system"; reference `tower_code/v1_usertower_train.py:21-60`,
`gnn_model/v1_lightgcl.py:567-616`). Here there is exactly one tree of frozen
dataclasses; every trainer / evaluator / server takes its node of the tree.

Values mirror the reference's live hyperparameters so parity runs are
apples-to-apples (item tower bs 192 / tau 0.08; user tower bs 768 / lr 5e-4;
GNN bs 8192 / dim 64 — reference `utils/dependencies.py:71`,
`item_tower.py:1076`, `v1_usertower_train.py:28-49`, `v1_lightgcl.py:567-616`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh topology. ``data`` shards the batch, ``model`` shards
    embedding-table rows / the item matrix (SURVEY.md §2.12)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 -> use all devices on that axis; model_parallelism=1 means pure DP.
    num_data: int = -1
    num_model: int = 1


@dataclass(frozen=True)
class VocabConfig:
    """Closed categorical vocab + LLM 'RE' field schema (reference
    `utils/vocab.py:421-444`)."""

    # path to a JSON {field: [values...]} file; None -> built-in default
    std_vocab_path: str | None = None
    num_hash_buckets: int = 1000  # md5-bucketed metadata ids (`v1_usertower_train.py:211-218`)
    text_vocab_size: int = 8192   # own stateless hashing text tokenizer
    max_field_tokens: int = 32    # per-RE-field token cap (`item_tower.py:443`)
    max_name_tokens: int = 32


@dataclass(frozen=True)
class ItemTowerConfig:
    """HybridItemTower-equivalent encoder (reference `item_tower.py:131-286`)."""

    dim: int = 128
    text_dim: int = 128            # own trainable text encoder width
    text_layers: int = 2
    text_heads: int = 4
    fusion_layers: int = 2         # 2-layer fusion transformer (`item_tower.py:169-182`)
    fusion_heads: int = 4
    head_hidden: Sequence[int] = (256, 512)  # DeepResidualHead expansion (`item_tower.py:77-128`)
    dropout: float = 0.1
    # text-encoder backend: "hash" = trainable HashTextEncoder (default,
    # self-contained); "pretrained" = frozen corpus-pretrained PPMI-SVD
    # token table + trainable projection/encoder (the reference's frozen
    # BERT-embeddings analogue, `item_tower.py:148-166`) — requires a
    # pretrain-text artifact (pipeline stage `pretrain-text`)
    text_encoder: str = "hash"     # hash | pretrained
    pretrained_dim: int = 128      # width of the pretrained artifact


@dataclass(frozen=True)
class SimCSEConfig:
    """Stage-1 contrastive training (reference `item_tower.py:887-1127`)."""

    batch_size: int = 192
    temperature: float = 0.08
    lr: float = 5e-5
    text_encoder_lr: float = 1e-5  # analogue of the BERT param group (`item_tower.py:1012-1022`)
    weight_decay: float = 0.01
    epochs: int = 5
    # reference-scale step counts on small catalogs: run shuffled re-passes
    # until an epoch has at least this many optimizer steps (the reference
    # "epoch" is ~245 steps at its 47k catalog; inactive at/above that
    # scale). Same pattern as user_train.steps_per_epoch_min.
    steps_per_epoch_min: int = 100
    warmup_frac: float = 0.1
    feature_dropout: float = 0.2   # view-corruption prob (`item_tower.py:341-394`)
    global_negatives: bool = True  # all-gather embeddings across the data axis
    metrics_every: int = 50        # alignment/uniformity cadence (`item_tower.py:1090`)


@dataclass(frozen=True)
class UserTowerConfig:
    """SASRec user tower (reference `v1_refine_usertower.py:312-510`,
    `PipelineConfig` at `v1_usertower_train.py:21-60`)."""

    d_model: int = 128
    max_len: int = 50
    nhead: int = 4
    num_layers: int = 2
    dropout: float = 0.2
    num_time_buckets: int = 10     # 9 edges -> 10 buckets (`v1_refine_usertower.py:212-214`)
    num_side_fields: int = 4       # hashed metadata fields
    static_bucket_fields: int = 4  # quantile-bucketed user features
    static_cat_fields: int = 5     # low-card categorical user features
    static_cont_fields: int = 4    # standardized continuous user features
    bucket_emb_dim: int = 16
    cat_emb_dim: int = 4
    cont_proj_dim: int = 16


@dataclass(frozen=True)
class UserTrainConfig:
    batch_size: int = 768
    lr: float = 5e-4
    weight_decay: float = 1e-4
    epochs: int = 15
    grad_clip: float = 5.0
    temperature: float = 0.1
    lambda_logq: float = 1.0
    lambda_sup: float = 0.1        # DuoRec supervised weight
    lambda_cl: float = 0.2         # DuoRec contrastive weight
    top_k_percent: float = 0.01    # HNM mining fraction
    hnm_threshold: float = 0.90    # "too similar" exclusion
    hard_margin: float = 0.01
    num_random_negs: int = 100
    freeze_item_epochs: int = 1    # unfreeze at epoch 2 (`v1_usertower_train.py:968-982`)
    unfrozen_item_lr_scale: float = 0.05
    eval_ks: Sequence[int] = (20, 100, 500)
    # static-shape replacement for the reference's dynamic all-timestep
    # flattening: sample this many valid positions per user per step
    positions_per_user: int = 4
    # floor on optimizer steps per epoch: small worlds (few user batches)
    # run multiple shuffled passes, resampling positions each pass, so an
    # "epoch" carries a reference-scale training signal. At reference scale
    # (1.37M users / bs 768 ≈ 1787 steps) this floor is inactive; on a
    # 1k-user world the old floor of 1 meant ONE optimizer step per "epoch"
    # — every small-world run was ~50x undertrained (see RESULTS.md).
    steps_per_epoch_min: int = 100
    # the hybrid tower gets its OWN floor (default off): it trains one
    # position per user through near-passthrough adapters (reference gates
    # start at sigmoid(-5)≈0, `mined_inference.py:514-577`) and the steps
    # sweep showed extra passes degrade it monotonically (epoch-1 Recall@100
    # 19.1% → 13.8% by epoch 15 on the 1k-user world vs 35.6% at floor 1).
    hybrid_steps_per_epoch_min: int = 1
    # hybrid training recipe (VERDICT r3 item 6 — make training HELP):
    # separate LR (0 = inherit lr), linear warmup, optional cosine decay,
    # and per-module update scaling (e.g. slow the adapters/encoder that
    # sit on top of already-strong frozen content+GNN inputs while the
    # gates/fusion move at full speed)
    hybrid_lr: float = 0.0
    hybrid_warmup_steps: int = 0
    hybrid_lr_decay: str = "const"      # const | cosine
    hybrid_slow_modules: Sequence[str] = ()   # top-level param groups
    hybrid_slow_scale: float = 1.0
    # train-hybrid's post-train ensemble/blend report costs ~70 min of
    # host fuser time at the H&M shape — recipe-comparison arms that only
    # need the epoch curve + best checkpoint + item matrix turn it off
    hybrid_report: bool = True
    # checkpoint cadence: epochs that neither improve Recall@100 nor land on
    # the cadence (nor are the final epoch) skip the state snapshot (a
    # full-state save copies the whole item matrix and optimizer moments to
    # the host). 1 = reference behavior (every epoch). Resume granularity
    # degrades to the last saved epoch.
    ckpt_every: int = 1
    plateau_factor: float = 0.5    # ReduceLROnPlateau on Recall@100
    plateau_patience: int = 2
    # item-matrix lookup strategy: "dense" = jnp.take under jit-SPMD (XLA
    # inserts collectives for a row-sharded matrix); "a2a" = explicit
    # DLRM-style shard_map exchange over the model axis
    # (parallel.collectives.rowsharded_lookup_a2a) — for tables too large
    # to make the psum path's O(B·D)-per-shard traffic acceptable
    lookup: str = "dense"
    random_cut_prob: float = 0.2   # sequence augmentation (stage-2 + hybrid)
    # item-embedding treatment in the logq loss: "l2" scores cosine both
    # sides; "none" keeps raw item rows (the reference's SASRecItemTower is
    # an unnormalized table, `v1_usertower_train.py:271` — magnitudes then
    # absorb residual popularity). HNM/margin variants mine on cosine and
    # always normalize.
    item_target_norm: str = "l2"
    # retrieval scoring at eval/serving: "cosine" (reference tower eval,
    # `v1_usertower_train.py:566`) or "dot" (reference GNN eval,
    # `v1_evaluate_lightgcl.py:275` — keeps magnitude-encoded popularity)
    eval_score: str = "cosine"
    # main-loss variant (the reference's loss zoo, `v1_refine_usertower.py`):
    # logq (all-time sampled softmax, the run_pipeline default) | hnm |
    # mixed_hnm | margin (full_batch_hard_emphasis)
    loss_variant: str = "logq"


@dataclass(frozen=True)
class GNNConfig:
    """LightGCL (reference `gnn_model/v1_lightgcl.py:567-616`)."""

    emb_dim: int = 64
    num_layers: int = 2
    svd_rank: int = 5
    svd_iters: int = 2
    temperature: float = 0.2
    lambda_ssl: float = 0.01
    lambda_reg: float = 1e-5
    batch_size: int = 8192
    lr: float = 5e-3
    epochs: int = 20
    # reference-scale step counts on small worlds: repeat shuffled edge
    # passes until an epoch has at least this many optimizer steps (the
    # reference runs 1375 steps/epoch at batch 8192 on its 11.3M-edge
    # graph; a 73k-edge test world would otherwise get 9). Inactive at
    # reference scale. Same rationale as UserTrainConfig.steps_per_epoch_min.
    steps_per_epoch_min: int = 100
    logit_clamp: float = 100.0
    # cap on optimizer steps per epoch (0 = none): at the 33M-transaction
    # H&M shape a full epoch is ~4k full-graph steps; the reference's own
    # epoch was 1375 steps at 11.3M edges (`v1_lightgcl.py:645`), so a cap
    # keeps wall-clock bounded with a comparable training signal
    steps_per_epoch_max: int = 0
    # propagation backend: segment_sum (gather + segment_sum over the whole
    # edge list) or segment_sum_sharded (edge list sharded over the mesh's
    # model axis, per-shard partials merged by one psum — multi-device
    # full-graph propagation; requires passing a mesh to select_propagation)
    propagation: str = "segment_sum"  # segment_sum | segment_sum_sharded


@dataclass(frozen=True)
class DistillConfig:
    """Magnitude->cosine distillation (reference
    `gnn_model/distill_mag_to_cos_l2.py`)."""

    hidden_dim: int = 128
    out_dim: int = 64
    lr: float = 1e-3
    epochs: int = 10
    steps_per_epoch: int = 50      # random (user, item) batch pairs per epoch
    batch_size: int = 4096
    # Teacher-top-k hard-pair mining: draw this fraction of each item
    # batch from the union of the user batch's teacher top-``hard_k``
    # items (rest stays uniform). Uniform item sampling covers ~82% of a
    # 5k catalog per 4096-item batch but ~4% of a 105k one, so the MSE
    # carries almost no top-of-ranking signal at shape — the measured
    # fidelity collapse 0.90 -> 0.034 (VERDICT r4 weak #1). 0 = off
    # (round-4 behavior).
    hard_frac: float = 0.0
    hard_k: int = 100


@dataclass(frozen=True)
class RerankerConfig:
    """DCN-v2 / DeepFM reranker (reference `temp_model/ranker_skelet.py`)."""

    cross_layers: int = 3
    deep_hidden: Sequence[int] = (128, 64)
    fm_embed_dim: int = 16
    dropout: float = 0.1
    lr: float = 3e-3
    epochs: int = 30
    batch_size: int = 2048
    neg_per_pos: int = 5           # 1:5 negative sampling (`utils/monitor/log_importer.py`)
    # "bce" = pointwise Logloss (reference CatBoost parity); "pairwise" =
    # group-wise softplus(neg - pos) ranking over the importers' 1:N groups
    loss: str = "bce"
    # negatives: "candidates" samples from the tower's own top-k (train
    # matches the serve-time rerank distribution); "uniform" = reference
    negative_source: str = "candidates"
    candidate_top_k: int = 100


@dataclass(frozen=True)
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    batch_size: int = 192          # reference `utils/dependencies.py:71`
    fast_mode_multiplier: int = 4  # `utils/inference_utils.py:155`
    similarity_top_k: int = 50     # `APIController/controller.py:84-93`
    db_path: str = "artifacts/serve.db"
    # ANN backend: exact C++ scan (honest at <=100k items), native HNSW
    # (reference pgvector config m=24/efc=200/efs=100), device-resident IVF
    # (clustered device search for 1M+ catalogs, ops/ivf.py), or int8
    # (device-resident quantized exact scan, ops/quant.py — a quarter of the
    # device bytes of the fp32 scan at ~0.99 recall)
    ann_backend: str = "exact"     # exact | hnsw | ivf | int8
    hnsw_m: int = 24
    hnsw_ef_construction: int = 200
    hnsw_ef_search: int = 100
    ivf_nlist: int = 0             # 0 = auto (sqrt(N) at build time)
    ivf_nprobe: int = 8
    # coalesce concurrent HTTP vectorize calls into shared device batches
    # (leader/follower, serve/batcher.py); 0 disables
    batch_window_ms: float = 2.0
    max_dynamic_batch: int = 1024
    # cosine-score bonus for candidates whose enriched micro-season matches
    # the request/session season (recommend_for_user season re-rank)
    season_bonus: float = 0.05
    # recommendation recipe served by recommend_for_user (serve/recommend.py;
    # per-request ?mode= overrides): cosine = ANN top-k; blend = the
    # popularity+seen blend; rerank = candidate union -> GBDT (the
    # measured-best system at the H&M shape, artifacts/quality_hm_v4)
    mode: str = "cosine"           # cosine | blend | rerank
    blend_alpha: float = 0.1       # measured-best combo at the H&M shape
    blend_beta: float = 1.0        # (eval.json blend best a0.1_b1.0)
    rerank_pool: int = 512         # candidate-union pool size
    rerank_m_cos: int = 300        # cosine arm of the union
    rerank_m_pop: int = 100        # popularity arm of the union
    # blend-mode scoring backend: host numpy (per-request O(U*N) scan) or
    # the fused device kernel (item matrix + popularity prior resident on
    # device across requests, serve/recommend.blend_topk backend='device');
    # auto = device when an accelerator backend is already up, else host.
    # Host-vs-device list equality proven in tests/test_serve_modes.py.
    blend_backend: str = "auto"    # auto | host | device
    # user-vector backend for model-backed serving: auto = hybrid tower if
    # its checkpoint+GNN artifacts exist, else stage-2 tower, else
    # history-mean; or pin one explicitly
    user_backend: str = "auto"     # auto | history | stage2 | hybrid


@dataclass(frozen=True)
class DataConfig:
    root: str = "artifacts"
    num_items: int = 2000
    num_users: int = 1000
    days: int = 120
    valid_days: int = 7            # ground truth = last-7-day purchases
    max_seq_len: int = 50
    seed: int = 42
    # persona realism knobs (persona_t.md structure): each persona
    # concentrates on a preferred item pool, and shoppers repurchase
    persona_pool_frac: float = 0.15
    persona_pool_boost: float = 8.0
    repeat_prob: float = 0.25
    # latent micro-style cluster structure (per-user learnable signal):
    # items join feature-coherent clusters (auto: ~64 items each), users
    # subscribe to a few, and user_pool_prob of basket slots draw from the
    # user's subscribed clusters
    n_item_clusters: int = 0       # 0 = auto (num_items // 64, min 8)
    user_clusters: int = 3
    user_pool_prob: float = 0.6
    pop_zipf: float = 0.6          # global popularity skew exponent
    # seasonal drift: items whose catalog season matches the current
    # quarter draw season_boost x likelier (reference Season enum
    # `database.py:47-50` + the prompter's micro-season block). 1.0
    # disables seasonality and reproduces the pre-season generator
    # stream bit-exactly.
    season_boost: float = 3.0
    season_cycle_days: int = 364
    # world-v4: append this many cluster-signature style words to each
    # product name (real catalog names carry fit/style vocabulary; 0 = off)
    name_style_words: int = 0


@dataclass(frozen=True)
class Config:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    item_tower: ItemTowerConfig = field(default_factory=ItemTowerConfig)
    simcse: SimCSEConfig = field(default_factory=SimCSEConfig)
    user_tower: UserTowerConfig = field(default_factory=UserTowerConfig)
    user_train: UserTrainConfig = field(default_factory=UserTrainConfig)
    gnn: GNNConfig = field(default_factory=GNNConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    reranker: RerankerConfig = field(default_factory=RerankerConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _replace_tree(node: Any, overrides: Mapping[str, Any]) -> Any:
    updates = {}
    for key, value in overrides.items():
        if not hasattr(node, key):
            raise KeyError(f"unknown config key: {key!r} on {type(node).__name__}")
        current = getattr(node, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _replace_tree(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(node, **updates)


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> Config:
    """Build the config tree, optionally from a JSON file plus overrides."""
    cfg = Config()
    if path is not None and os.path.exists(path):
        with open(path) as f:
            cfg = _replace_tree(cfg, json.load(f))
    if overrides:
        cfg = _replace_tree(cfg, overrides)
    return cfg


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
