"""Int8-quantized retrieval: ranking fidelity vs the fp32 exact path."""

import numpy as np

from recsys.ops.quant import (QuantizedItems, int8_topk,
                                  quantization_recall, quantize_items_int8)


def test_quantize_roundtrip_error_small():
    rng = np.random.default_rng(0)
    items = rng.normal(size=(200, 32)).astype(np.float32)
    items[0] = 0
    qi = quantize_items_int8(items)
    assert qi.q.dtype.name == "int8"
    deq = np.asarray(qi.q, np.float32) * np.asarray(qi.col_scale)[None, :]
    normed = items / np.clip(np.linalg.norm(items, axis=-1, keepdims=True),
                             1e-12, None)
    # per-channel symmetric int8: max abs error bounded by col_scale/2
    err = np.abs(deq - normed)
    assert (err <= np.asarray(qi.col_scale)[None, :] * 0.5 + 1e-7).all()


def test_int8_topk_matches_exact_on_separated_data():
    """With clearly separated scores, int8 recovers the exact top-k
    identically; PAD row 0 never appears."""
    rng = np.random.default_rng(1)
    N, D, B, k = 500, 64, 32, 20
    items = rng.normal(size=(N + 1, D)).astype(np.float32)
    items[0] = 0
    u = rng.normal(size=(B, D)).astype(np.float32)
    rec = quantization_recall(items, u, k=k)
    assert rec >= 0.95, rec
    _, idx = int8_topk(u, quantize_items_int8(items), k)
    assert (np.asarray(idx) != 0).all()


def test_int8_topk_approx_method_runs():
    rng = np.random.default_rng(2)
    items = rng.normal(size=(257, 16)).astype(np.float32)
    items[0] = 0
    u = rng.normal(size=(4, 16)).astype(np.float32)
    qi = quantize_items_int8(items)
    vals, idx = int8_topk(u, qi, 10, method="approx", recall_target=0.9)
    assert idx.shape == (4, 10)
    assert (np.asarray(idx) != 0).all()


def test_identical_vectors_score_maximally():
    """A query equal to a catalog row must rank that row first (cosine=1)."""
    rng = np.random.default_rng(3)
    items = rng.normal(size=(100, 32)).astype(np.float32)
    items[0] = 0
    qi = quantize_items_int8(items)
    u = items[[7, 42]]
    _, idx = int8_topk(u, qi, 1)
    assert np.asarray(idx).ravel().tolist() == [7, 42]


def test_int8_device_index_lifecycle():
    """Int8Index behind the common serving-index contract: add/update/
    remove, id mapping, top-k agreement with the exact VectorIndex path."""
    from recsys.serve.ann import Int8Index

    rng = np.random.default_rng(5)
    D = 32
    ix = Int8Index(D)
    # empty index contract
    ids, scores = ix.topk(rng.normal(size=(2, D)).astype(np.float32), 3)
    assert (ids == -1).all()
    vecs = rng.normal(size=(10, D)).astype(np.float32)
    ix.add(list(range(100, 110)), vecs)
    assert len(ix) == 10
    q = vecs[[3, 7]]
    ids, scores = ix.topk(q, 3)
    assert ids[0, 0] == 103 and ids[1, 0] == 107   # self-match first
    assert scores[0, 0] > 0.98                      # cosine ~ 1
    # update in place: moving vector 103 away dethrones it
    ix.add([103], -vecs[3:4])
    ids, _ = ix.topk(q[:1], 1)
    assert ids[0, 0] != 103
    # remove; k > len pads with -1
    assert ix.remove(107) and not ix.remove(999)
    ids, _ = ix.topk(q, 20)
    assert (ids != 107).all()
    assert (ids[:, len(ix):] == -1).all()
    # save/load round trip
    import tempfile, os
    path = os.path.join(tempfile.mkdtemp(), "ix")
    ix.save(path)
    ix2 = Int8Index.load(path)
    a, _ = ix.topk(q, 5)
    b, _ = ix2.topk(q, 5)
    assert (a == b).all()


def test_int8_backend_selectable_in_app_context():
    from recsys.config import load_config
    from recsys.serve.ann import Int8Index
    from recsys.serve.app import build_app_context

    cfg = load_config(overrides={"serve": {"ann_backend": "int8",
                                           "db_path": ":memory:",
                                           "batch_window_ms": 0.0}})
    ctx = build_app_context(cfg)
    assert isinstance(ctx.index, Int8Index)
