"""Stateless hashing tokenizer + metadata id hashing.

The reference leans on HuggingFace BERT tokenizers called 9x per item per
view inside the training loop — its single worst CPU hot loop (SURVEY.md
§3.2). This build tokenizes OFFLINE during ETL into fixed-shape int
tensors, and the tokenizer itself is a pure function: normalized words are
hashed into a fixed bucket space (the stateless-hash design the reference
sketched in dead code, `utils/vocab.py:567-581` CRC32 and kept live for
metadata via md5 buckets, `v1_usertower_train.py:211-218`). No fitted state
-> nothing to checkpoint, nothing to race on, identical ids across runs,
processes and hosts.
"""

from __future__ import annotations

import hashlib
import re
import zlib

import numpy as np

PAD_ID = 0
# token ids occupy [1, vocab_size); id 0 is reserved for padding.

_WORD_RE = re.compile(r"[a-z0-9]+")


def normalize(text: str) -> list[str]:
    return _WORD_RE.findall(str(text).lower())


def token_id(word: str, vocab_size: int) -> int:
    """CRC32-bucketed stable id in [1, vocab_size)."""
    return 1 + (zlib.crc32(word.encode("utf-8")) % (vocab_size - 1))


def encode(text: str, max_len: int, vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Text -> (ids, mask), both (max_len,) int32 — fixed shape, left-aligned."""
    words = normalize(text)[:max_len]
    ids = np.zeros(max_len, dtype=np.int32)
    mask = np.zeros(max_len, dtype=np.int32)
    for i, w in enumerate(words):
        ids[i] = token_id(w, vocab_size)
        mask[i] = 1
    return ids, mask


def encode_batch(texts: list[str], max_len: int, vocab_size: int):
    ids = np.zeros((len(texts), max_len), dtype=np.int32)
    mask = np.zeros((len(texts), max_len), dtype=np.int32)
    for r, t in enumerate(texts):
        ids[r], mask[r] = encode(t, max_len, vocab_size)
    return ids, mask


def hash_bucket(value: str, num_buckets: int, salt: str = "") -> int:
    """md5-stable bucket id in [1, num_buckets] for metadata side-info
    (0 = missing). Mirrors the reference's `get_hash_id`
    (`v1_usertower_train.py:211-218`) semantics with a per-field salt so
    fields don't collide into the same bucket space."""
    if value is None or value == "":
        return 0
    h = hashlib.md5((salt + str(value)).encode("utf-8")).hexdigest()
    return 1 + (int(h[:8], 16) % num_buckets)
