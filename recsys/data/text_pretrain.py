"""Corpus-pretrained token embeddings (PPMI-SVD) for the text encoder.

The reference's item tower leans on frozen ``bert-base-uncased`` semantics:
word embeddings for the RE fields and a full frozen forward on names
(`item_tower.py:148-166, 247-272`). This environment has zero egress, so
"pretrained" here means the classic count-based recipe that underlies
static word vectors (Levy & Goldberg 2014: SVD of the PPMI matrix ==
implicit skip-gram/SGNS): tokenize the ENTIRE catalog corpus offline
(names + all LLM/RE field values, the same stateless CRC32 hash space the
live tokenizer uses), count within-item token co-occurrence, apply positive
PMI, and factorize with the same randomized SVD used for the GNN's global
view (`ops/graph._randomized_svd`). The resulting (V, d) matrix is baked as
an artifact and loaded FROZEN behind the same two-method encoder interface
(`models/text_encoder.PretrainedTextEncoder`), with a trainable projection
on top — the exact frozen-embeddings + trainable-adapter split the
reference uses for its RE branch.

Unsupervised over the catalog only — no interaction labels leak in, so
stage-1 remains purely content-based.
"""

from __future__ import annotations

import numpy as np

from recsys.ops.graph import _randomized_svd


def item_token_bags(tensors: dict) -> "scipy.sparse.csr_matrix":
    """(N_items, V)-shaped binary incidence from the OFFLINE item tensors
    (re_ids/re_mask + txt_ids/txt_mask): one bag per item, deduplicated.
    Uses the already-tokenized tensors so the pretraining corpus is
    bit-identical to what the tower sees at train time."""
    from scipy import sparse

    n = tensors["txt_ids"].shape[0]
    re_ids = tensors["re_ids"].reshape(n, -1)
    re_mask = tensors["re_mask"].reshape(n, -1)
    ids = np.concatenate([re_ids, tensors["txt_ids"]], axis=1)
    mask = np.concatenate([re_mask, tensors["txt_mask"]], axis=1) > 0
    rows = np.repeat(np.arange(n), mask.sum(axis=1))
    cols = ids[mask]
    V = int(ids.max()) + 1
    inc = sparse.csr_matrix(
        (np.ones(len(cols), np.float32), (rows, cols)), shape=(n, V))
    inc.data[:] = 1.0  # dedupe: count each token once per item
    inc.sum_duplicates()
    inc.data[:] = 1.0
    return inc


def ppmi(cooc: "scipy.sparse.csr_matrix", shift: float = 0.0):
    """Positive pointwise mutual information on the nonzeros of a sparse
    co-occurrence matrix: max(0, log(C_ij * total / (r_i * c_j)) - shift)."""
    c = cooc.tocoo()
    row_sum = np.asarray(cooc.sum(axis=1)).ravel()
    col_sum = np.asarray(cooc.sum(axis=0)).ravel()
    total = float(c.data.sum())
    with np.errstate(divide="ignore"):
        pmi = np.log(c.data * total
                     / (row_sum[c.row] * col_sum[c.col] + 1e-12) + 1e-12)
    c.data = np.maximum(pmi - shift, 0.0).astype(np.float32)
    c.eliminate_zeros()
    return c.tocsr()


def pretrain_embeddings(tensors: dict, vocab_size: int, dim: int = 128,
                        seed: int = 0, svd_iters: int = 4) -> np.ndarray:
    """Item tensors -> (vocab_size, dim) float32 embedding matrix.

    Co-occurrence = incidence^T @ incidence over within-item bags (window =
    the whole item, the natural unit for catalog text), diagonal removed,
    PPMI, randomized SVD, U * sqrt(S) scaling (standard for PPMI factors),
    L2-normalized rows. Row 0 (PAD) and never-seen buckets stay zero."""
    from scipy import sparse

    inc = item_token_bags(tensors)
    if inc.shape[1] < vocab_size:  # tokens never hashed into the top buckets
        inc = sparse.csr_matrix(
            (inc.data, inc.indices, inc.indptr), shape=(inc.shape[0], vocab_size))
    cooc = (inc.T @ inc).tocsr()
    cooc.setdiag(0)
    cooc.eliminate_zeros()
    m = ppmi(cooc)
    rng = np.random.default_rng(seed)
    u, s, _ = _randomized_svd(lambda x: m @ x, lambda x: m.T @ x,
                              vocab_size, vocab_size, dim, svd_iters, rng)
    emb = (u * np.sqrt(np.maximum(s, 0.0))[None, :]).astype(np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = np.where(norms > 1e-8, emb / np.maximum(norms, 1e-8), 0.0)
    emb[0] = 0.0  # PAD
    return emb.astype(np.float32)


def save_text_pretrain(path: str, emb: np.ndarray) -> None:
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                        embeddings=emb,
                        meta=np.array([emb.shape[0], emb.shape[1]], np.int64))


def load_text_pretrain(path: str) -> np.ndarray:
    p = path if path.endswith(".npz") else path + ".npz"
    with np.load(p) as z:
        return z["embeddings"].astype(np.float32)
