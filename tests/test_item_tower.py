"""Item tower E2E slice: model, on-device augmentation, contrastive losses,
mini SimCSE training, vector materialization + self-retrieval."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys.config import Config, DataConfig, ItemTowerConfig, SimCSEConfig, VocabConfig
from recsys.data.dataset import slice_item_batch, tokenize_items
from recsys.data.synthetic import generate_dataset
from recsys.data.vocab import StdVocab
from recsys.ops import contrastive as C
from recsys.ops.augment import corrupt_view, two_views

SMALL_CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1),
    simcse=SimCSEConfig(batch_size=16, epochs=2, metrics_every=2,
                        steps_per_epoch_min=1),
)


@pytest.fixture(scope="module")
def item_tensors():
    items, _, _ = generate_dataset(SMALL_CFG.data)
    return tokenize_items(items, StdVocab(), SMALL_CFG.vocab)


@pytest.fixture(scope="module")
def mesh():
    from recsys.config import MeshConfig
    from recsys.parallel.mesh import build_mesh
    return build_mesh(MeshConfig(num_data=4, num_model=1), jax.devices()[:4])


def test_corrupt_view_only_masks(item_tensors):
    batch = slice_item_batch(item_tensors, np.arange(8))
    key = jax.random.PRNGKey(0)
    out = corrupt_view({k: jnp.asarray(v) for k, v in batch.items()}, key, 0.5)
    np.testing.assert_array_equal(np.asarray(out["re_ids"]), batch["re_ids"])
    # corruption only removes mask bits, never adds
    assert (np.asarray(out["re_mask"]) <= batch["re_mask"]).all()
    assert (np.asarray(out["txt_mask"]) <= batch["txt_mask"]).all()
    # with p=0.5 something must have been dropped
    assert np.asarray(out["re_mask"]).sum() < batch["re_mask"].sum()
    # never leaves a name fully empty if it had >1 token
    multi = batch["txt_mask"].sum(-1) > 1
    assert (np.asarray(out["txt_mask"]).sum(-1)[multi] >= 1).all()
    # two views differ
    v1, v2 = two_views({k: jnp.asarray(v) for k, v in batch.items()}, key, 0.5)
    assert (np.asarray(v1["re_mask"]) != np.asarray(v2["re_mask"])).any()


def test_infonce_prefers_aligned():
    key = jax.random.PRNGKey(0)
    e = jax.random.normal(key, (16, 32))
    e = e / jnp.linalg.norm(e, axis=-1, keepdims=True)
    aligned = float(C.bidirectional_infonce(e, e, 0.08))
    shuffled = float(C.bidirectional_infonce(e, jnp.roll(e, 1, axis=0), 0.08))
    assert aligned < 0.1 < shuffled


def test_logq_loss_masking_and_correction():
    key = jax.random.PRNGKey(1)
    u = jax.random.normal(key, (8, 16))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    items = u  # perfect alignment
    pos_ids = jnp.array([1, 2, 3, 4, 5, 6, 2, 8])  # rows 1 and 6 share item 2
    logq = jnp.full((10,), -3.0)
    logq = logq.at[5].set(-0.5)  # one popular item so correction is non-trivial
    base = C.inbatch_logq_loss(u, items, pos_ids, logq, temperature=0.1)
    # verify against an explicit numpy re-computation of the recipe
    un, itn = np.asarray(u, np.float64), np.asarray(items, np.float64)
    logits = un @ itn.T / 0.1 - np.asarray(logq)[np.asarray(pos_ids)][None, :]
    pid = np.asarray(pos_ids)
    mask = (pid[None, :] == pid[:, None]) & ~np.eye(8, dtype=bool)
    logits[mask] = -3e4
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    expected = -(np.diagonal(logits) - lse).mean()
    assert float(base) == pytest.approx(expected, rel=1e-4)
    # same-user masking: rows of one user don't compete
    uid = jnp.array([0, 0, 0, 0, 1, 1, 1, 1])
    masked = C.inbatch_logq_loss(u, items, pos_ids, logq, user_ids=uid)
    assert np.isfinite(masked)
    # valid weighting drops rows
    v = jnp.array([1, 1, 1, 1, 0, 0, 0, 0])
    assert np.isfinite(C.inbatch_logq_loss(u, items, pos_ids, logq, valid=v))


def test_duorec_and_hnm_losses():
    key = jax.random.PRNGKey(2)
    z1 = jax.random.normal(key, (12, 16))
    z1 = z1 / jnp.linalg.norm(z1, axis=-1, keepdims=True)
    z2 = z1 + 0.01 * jax.random.normal(jax.random.PRNGKey(3), (12, 16))
    z2 = z2 / jnp.linalg.norm(z2, axis=-1, keepdims=True)
    tgt = jnp.array([1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])
    assert np.isfinite(float(C.duorec_loss(z1, z2, tgt)))

    u = jax.random.normal(key, (16, 8))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    pos = jnp.arange(1, 17)
    logq = jnp.full((20,), -2.0)
    loss, stats = C.hnm_corrected_loss(u, u, pos, logq, top_k_percent=0.25)
    assert np.isfinite(float(loss)) and stats["hard_k"] == 4
    loss2, _ = C.mixed_hnm_loss(u, u, pos, logq, jax.random.PRNGKey(4),
                                top_k_percent=0.25, num_random=8)
    assert np.isfinite(float(loss2))
    loss3 = C.full_batch_hard_emphasis_loss(u, u, pos, logq, top_k_percent=0.25)
    assert np.isfinite(float(loss3))
    scale = jnp.log(jnp.array(1 / 0.07))
    loss4 = C.corrected_logq_with_recovery(u, u, pos, logq, scale)
    assert np.isfinite(float(loss4))


def test_positive_recovery_restores_diagonal():
    """With huge popularity on the positive item, plain correction tanks the
    diagonal; recovery restores it, so recovered loss << corrected loss."""
    e = jnp.eye(4, 8)
    pos = jnp.array([1, 2, 3, 4])
    logq_hot = jnp.zeros((6,)).at[1:5].set(5.0)  # absurdly popular positives
    scale = jnp.log(jnp.array(10.0))
    rec = C.corrected_logq_with_recovery(e, e, pos, logq_hot, scale)
    plain = C.inbatch_logq_loss(e, e, pos, logq_hot, temperature=0.1)
    assert float(rec) < float(plain)


def test_simcse_training_learns_and_retrieves(item_tensors, mesh, tmp_path):
    """The minimum E2E slice: train -> loss drops; materialize -> self-
    retrieval puts each item's own vector at rank 1."""
    from recsys.train.simcse import (
        materialize_item_vectors, topk_items, train_simcse)

    state = train_simcse(SMALL_CFG, item_tensors, mesh, str(tmp_path))
    import json
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if r["kind"] == "epoch"]
    assert len(losses) == 2 and losses[-1] < losses[0]

    mat = materialize_item_vectors(SMALL_CFG, state.params, item_tensors, mesh,
                                   str(tmp_path / "item_matrix"), batch_size=32)
    assert mat.shape == (65, 128)
    np.testing.assert_allclose(np.linalg.norm(mat[1:], axis=1), 1.0, rtol=1e-3)
    # self-retrieval: query = item vectors themselves
    _, idx = topk_items(mat, mat[1:9], k=3)
    assert (idx[:, 0] == np.arange(1, 9)).all()
    # sidecar round trip
    from recsys.train.checkpoint import load_array_with_ids
    arr, ids, meta = load_array_with_ids(str(tmp_path / "item_matrix"))
    assert ids[0] == "<pad>" and len(ids) == 65


def test_random_cut_augmentation():
    """Random-cut keeps the left-padding invariant: the chosen position
    becomes the last slot; everything after it is dropped."""
    import jax
    from recsys.ops.augment import random_cut

    B, L = 6, 8
    inp = np.tile(np.arange(1, L + 1, dtype=np.int32), (B, 1))
    mask = np.ones((B, L), np.int32)
    mask[:, :3] = 0  # left padding: first real position = 3 (value 4)
    inp = inp * mask
    batch = {"input_ids": jnp.asarray(inp), "target_ids": jnp.asarray(inp + 100) * mask,
             "time_buckets": jnp.asarray(mask * 2), "seq_mask": jnp.asarray(mask)}
    out = random_cut(batch, jax.random.PRNGKey(3), prob=1.0)
    o_inp = np.asarray(out["input_ids"])
    o_mask = np.asarray(out["seq_mask"])
    for r in range(B):
        assert o_mask[r, -1] == 1                      # last slot always real
        k = int(o_mask[r].sum())
        assert 1 <= k <= 5                             # at most original length
        # left-padded: zeros then ones
        np.testing.assert_array_equal(o_mask[r], [0] * (L - k) + [1] * k)
        # content is a prefix of the original real sequence, shifted right
        np.testing.assert_array_equal(o_inp[r, L - k:], inp[r, 3:3 + k])
    # prob=0 is identity
    same = random_cut(batch, jax.random.PRNGKey(0), prob=0.0)
    np.testing.assert_array_equal(np.asarray(same["input_ids"]), inp)


def test_simcse_steps_floor_multiplies_passes(item_tensors, mesh, tmp_path):
    """steps_per_epoch_min re-passes the shuffled catalog until the epoch
    has at least that many optimizer steps (same contract as stage-2)."""
    import dataclasses
    import json
    from recsys.train.simcse import train_simcse

    cfg = dataclasses.replace(SMALL_CFG, simcse=dataclasses.replace(
        SMALL_CFG.simcse, epochs=1, metrics_every=1, steps_per_epoch_min=9))
    train_simcse(cfg, item_tensors, mesh, str(tmp_path))
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    steps = max(r["step"] for r in recs if r["kind"] == "train")
    # 64 items / bs 16 = 4 steps/pass -> ceil(9/4)=3 passes -> 12 steps
    assert steps == 12


# -- corpus-pretrained text encoder (data/text_pretrain.py) -----------------

def test_pretrain_embeddings_semantics(item_tensors):
    """PPMI-SVD embeddings: PAD row zero, unit rows, and co-occurring tokens
    (same item) closer on average than random token pairs."""
    from recsys.data.text_pretrain import pretrain_embeddings

    V = SMALL_CFG.vocab.text_vocab_size
    emb = pretrain_embeddings(item_tensors, V, dim=32, seed=0)
    assert emb.shape == (V, 32)
    np.testing.assert_array_equal(emb[0], 0.0)
    norms = np.linalg.norm(emb, axis=1)
    nz = norms > 0
    assert nz.sum() > 50
    np.testing.assert_allclose(norms[nz], 1.0, rtol=1e-5)

    # co-occurring pairs (first two name tokens of each item) vs random pairs
    rng = np.random.default_rng(0)
    txt, msk = item_tensors["txt_ids"], item_tensors["txt_mask"]
    rows = np.where(msk[:, 1] > 0)[0]
    a, b = txt[rows, 0], txt[rows, 1]
    keep = (a != b) & nz[a] & nz[b]
    co_sim = np.mean(np.sum(emb[a[keep]] * emb[b[keep]], axis=1))
    nz_ids = np.where(nz)[0]
    ra, rb = rng.choice(nz_ids, 500), rng.choice(nz_ids, 500)
    rnd_sim = np.mean(np.sum(emb[ra] * emb[rb], axis=1))
    assert co_sim > rnd_sim + 0.05


def test_pretrained_encoder_frozen_table(item_tensors, mesh, tmp_path):
    """Full stage-1 training with text_encoder='pretrained': loss finite,
    artifact loaded into the param, and the table BIT-IDENTICAL after
    training (stop_gradient + set_to_zero group)."""
    from recsys.data.text_pretrain import pretrain_embeddings
    from recsys.train.simcse import train_simcse

    cfg = dataclasses.replace(
        SMALL_CFG,
        item_tower=dataclasses.replace(SMALL_CFG.item_tower,
                                       text_encoder="pretrained",
                                       pretrained_dim=32),
        simcse=dataclasses.replace(SMALL_CFG.simcse, epochs=1))
    emb = pretrain_embeddings(item_tensors, cfg.vocab.text_vocab_size,
                              dim=32, seed=0)
    state = train_simcse(cfg, item_tensors, mesh, str(tmp_path),
                         text_pretrain=emb)
    table = np.asarray(state.params["encoder"]["text_encoder"]
                       ["pretrained_embedding"])
    np.testing.assert_array_equal(table, emb)
    # the trainable parts DID move: projection kernel isn't at init
    assert int(state.step) > 0
