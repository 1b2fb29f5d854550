"""Non-learned retrieval baselines: popularity and repurchase.

The reference evaluates only its trained towers (`v1_usertower_train.py:548`),
leaving no floor to judge recall numbers against. These two classic
baselines bound the problem from below and also measure how much of a
dataset's signal is *trivially* predictable:

* ``popularity_topk`` — one global ranking by training-window popularity
  (the same popularity that drives LogQ correction), recommended to every
  user. Any tower must beat this to be learning anything personal.
* ``repurchase_topk`` — each user's own training history ranked by
  (frequency, recency), padded out with global popularity. On retail data
  with strong buy-again behavior this is a famously strong baseline; the
  gap between it and a sequence tower isolates the value of *generalizing*
  beyond re-buys.

Both emit top-k index matrices compatible with ``recall_at_ks`` so the
denominator semantics match the tower evaluation exactly.
"""

from __future__ import annotations

import numpy as np

from recsys.eval.recall import recall_at_ks


def popularity_ranking(logq: np.ndarray, max_k: int) -> np.ndarray:
    """Global item ranking (1-based indices, PAD row 0 excluded) from the
    log-popularity vector (PAD row is -20, `etl.logq_from_item_features`)."""
    order = np.argsort(-np.asarray(logq))
    order = order[order != 0]
    return order[:max_k].astype(np.int64)


def popularity_topk(logq: np.ndarray, num_users: int, max_k: int) -> np.ndarray:
    """(num_users, max_k) — the same popular list for everyone."""
    ranking = popularity_ranking(logq, max_k)
    if len(ranking) < max_k:  # tiny catalogs: pad with PAD row (never a hit)
        ranking = np.pad(ranking, (0, max_k - len(ranking)))
    return np.broadcast_to(ranking, (num_users, max_k)).copy()


def repurchase_topk(histories: list[np.ndarray], logq: np.ndarray,
                    max_k: int) -> np.ndarray:
    """Per-user buy-again ranking.

    ``histories[u]`` holds the user's training item indices in time order
    (0 = padding, ignored). Items are ranked by purchase count, ties broken
    by recency; remaining slots are filled from the global popularity
    ranking (skipping items already listed).
    """
    pop = popularity_ranking(logq, max_k + max(len(h) for h in histories) + 1
                             if histories else max_k)
    n = len(histories)
    out = np.zeros((n, max_k), np.int64)
    # head: per-user (count desc, recency desc) ranking of history items —
    # cheap (histories are <= max_len). The popularity FILL below is the
    # hot part: a per-user scan of the 500-deep pop list was ~30 min of
    # pure Python at 218k users; instead compute seen-membership of the pop
    # list for a whole chunk of users with one broadcast compare.
    heads = []
    hist_pad = np.zeros((n, max(len(h) for h in histories) if n else 1),
                        np.int64)
    for r, hist in enumerate(histories):
        hist = np.asarray(hist)
        hist = hist[hist > 0]
        if len(hist):
            uniq, counts = np.unique(hist, return_counts=True)
            last_pos = {int(it): p for p, it in enumerate(hist)}
            order = sorted(uniq.tolist(),
                           key=lambda it: (-counts[np.searchsorted(uniq, it)],
                                           -last_pos[int(it)]))
            head = order[:max_k]   # fill skips only RANKED items (original
            heads.append(head)     # semantics: seen = set(ranked))
            hist_pad[r, :len(head)] = head
        else:
            heads.append([])
    chunk = 2048
    for s0 in range(0, n, chunk):
        hp = hist_pad[s0:s0 + chunk]                       # (C, H)
        mem = (pop[None, :, None] == hp[:, None, :]).any(-1)   # (C, |pop|)
        for r in range(len(hp)):
            head = heads[s0 + r]
            fill = pop[~mem[r]][: max_k - len(head)]
            row = np.concatenate([np.asarray(head, np.int64), fill])
            out[s0 + r, : len(row)] = row
    return out


def content_profile_topk(histories: list[np.ndarray], item_matrix: np.ndarray,
                         max_k: int, *, half_life: float | None = None,
                         device: bool | None = None) -> np.ndarray:
    """Training-free content retrieval: each user's vector is the mean of
    their history items' stage-1 content vectors (cosine top-k, PAD row 0
    excluded).

    This bounds how much of the dataset's signal lives in the *content
    space alone* — the measurable twin of the reference's content-based
    premise (its item tower exists precisely so user affinity can be read
    off content vectors, `item_tower.py`, `mined_inference.py:194-225`).
    The gap between this and a trained tower isolates what sequence
    modeling adds; the gap to the latent-cluster oracle (synthetic worlds)
    isolates how much cluster signal stage-1 embeddings capture.

    ``half_life`` > 0 weights history positions by recency
    (w = 0.5**(age/half_life), age in positions from the end).
    """
    items = np.asarray(item_matrix, np.float32).copy()
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    n = len(histories)
    # profile build as ONE sparse matmul (a per-user Python loop was ~10 min
    # of the 218k-user H&M eval): rows = users, cols = items, values = the
    # (optionally recency-decayed) normalized weights
    from scipy import sparse

    rows_l, cols_l, vals_l = [], [], []
    for r, hist in enumerate(histories):
        hist = np.asarray(hist)
        hist = hist[hist > 0]
        if not len(hist):
            continue
        if half_life:
            age = np.arange(len(hist) - 1, -1, -1, dtype=np.float32)
            w = 0.5 ** (age / half_life)
            w /= w.sum()
        else:
            w = np.full(len(hist), 1.0 / len(hist), np.float32)
        rows_l.append(np.full(len(hist), r, np.int64))
        cols_l.append(hist.astype(np.int64))
        vals_l.append(w)
    if rows_l:
        m = sparse.csr_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(n, items.shape[0]), dtype=np.float32)
        profiles = np.asarray(m @ items, np.float32)
    else:
        profiles = np.zeros((n, items.shape[1]), np.float32)
    norms = np.linalg.norm(profiles, axis=-1, keepdims=True)
    profiles /= np.clip(norms, 1e-12, None)
    if device is None:
        import jax

        # the scoring matmul is (n, N) — at 218k eval users x 105k items
        # that's ~6 PFLOP-equivalent of host GEMM (~15 min on 2 vCPUs) vs
        # seconds on one chip
        device = (jax.default_backend() != "cpu"
                  and n * items.shape[0] > 2e8)
    if device:
        # mirror the host branch's clamp: lax.top_k(k) needs k <= N+1; tiny
        # catalogs with large eval ks pad the tail with PAD (never a hit)
        k = min(max_k, items.shape[0] - 1)
        idx, _ = _chunked_device_topk(profiles, items, k)
        if k < max_k:
            idx = np.pad(idx, ((0, 0), (0, max_k - k)))
        return idx
    out = np.zeros((n, max_k), np.int64)
    chunk = 2048
    for s0 in range(0, n, chunk):
        scores = profiles[s0:s0 + chunk] @ items.T
        scores[:, 0] = -np.inf
        k = min(max_k, scores.shape[1] - 1)
        idx = np.argpartition(-scores, k, axis=1)[:, :max_k]
        order = np.take_along_axis(scores, idx, 1).argsort(1)[:, ::-1]
        out[s0:s0 + chunk] = np.take_along_axis(idx, order, 1)
    return out


def _chunked_device_topk(user_vecs: np.ndarray, items: np.ndarray,
                         max_k: int, chunk: int = 2048):
    """Jitted chunked (U, N) scoring + top-k with device-side accumulation
    (items already normalized by the caller; one padded executable)."""
    import jax
    import jax.numpy as jnp
    from recsys.eval.recall import topk_scores

    im = jnp.asarray(items)
    fn = jax.jit(lambda u, it: topk_scores(u, it, max_k,
                                           normalize_items=False))
    n = len(user_vecs)
    outs, origs = [], []
    for s0 in range(0, n, chunk):
        u = np.asarray(user_vecs[s0:s0 + chunk], np.float32)
        origs.append(len(u))
        if origs[-1] < chunk:
            u = np.concatenate([u, np.zeros((chunk - origs[-1], u.shape[1]),
                                            np.float32)])
        outs.append(fn(u, im))
    idx = np.concatenate([np.asarray(i)[:o] for (_, i), o in zip(outs, origs)]
                         ) if outs else np.zeros((0, max_k), np.int64)
    vals = np.concatenate([np.asarray(v)[:o] for (v, _), o in zip(outs, origs)]
                          ) if outs else np.zeros((0, max_k), np.float32)
    return idx.astype(np.int64), vals


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _combo_key(alpha, beta) -> str:
    """Blend-table key for an (alpha, beta) combo. Floats are normalized
    (``0`` and ``0.0`` both -> ``a0.0``) so the model-only row keeps its
    canonical ``a0.0_b0.0`` name whatever numeric types the caller swept."""
    return f"a{float(alpha)}_b{float(beta)}"


def blend_sweep(user_vecs: np.ndarray, item_matrix: np.ndarray,
                logq: np.ndarray, histories: np.ndarray, user_ids,
                targets_idx: dict, ks=(20, 100, 500),
                alphas=(0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9),
                betas=(0.0, 0.3, 1.0), device: bool | None = None,
                per_user_k: int | None = None) -> dict:
    """Prior-blended retrieval: fuse the tower's cosine scores with the
    popularity prior and a seen-item (repurchase) bonus, sweeping weights.

    The towers score with cosine (both sides L2-normalized, reference
    `v1_usertower_train.py:566`), so item POPULARITY can only be encoded
    directionally and REPURCHASE affinity not at all — on retail data both
    carry large mass (see `baseline_report`). The blend restores them at
    serving time, reference-ensemble style (min-max normalized weighted
    sum, `mined_inference.py:1115-1144`):

        score = (1-alpha) * minmax_u(cos) + alpha * minmax(logq) + beta * seen

    Two backends behind one contract: host numpy (CHUNKED over users — an
    unchunked score matrix is ~6 GB per array at 31k eval users x 47k
    items) and, when an accelerator is present, a jitted device sweep
    (``_blend_topk_device``) that scans the (alpha, beta) grid over one
    resident (B, N+1) score block per batch — at 470k items x 79k eval
    users the host sweep is ~45 min on 2 vCPUs vs minutes on one chip. At
    production scale the same blend rides ``topk_scores(prior=...)`` on
    the row-sharded device path.
    """
    if device is None:
        import jax

        device = (jax.default_backend() != "cpu"
                  and user_vecs.shape[0] * item_matrix.shape[0] > 2e8)
    if device:
        return _blend_sweep_device(user_vecs, item_matrix, logq, histories,
                                   user_ids, targets_idx, ks, alphas, betas,
                                   per_user_k)
    # np.array (copy): asarray of a device buffer can hand back a
    # read-only view, breaking the in-place normalize
    items = np.array(item_matrix, np.float32)
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    u = np.asarray(user_vecs, np.float32)
    pop = _minmax(np.asarray(logq, np.float64)).astype(np.float32)
    max_k = max(ks)
    combos = [(a, b) for a in alphas for b in betas]
    idx_parts: dict = {c: [] for c in combos}
    chunk = 2048
    for s0 in range(0, len(u), chunk):
        cos = u[s0:s0 + chunk] @ items.T                    # (C, N+1)
        cos = (cos - cos.min(1, keepdims=True)) / \
            np.clip(cos.max(1, keepdims=True) - cos.min(1, keepdims=True),
                    1e-12, None)
        h = histories[s0:s0 + chunk]
        seen = np.zeros_like(cos)
        rows = np.repeat(np.arange(len(h)), h.shape[1])
        seen[rows, h.reshape(-1)] = 1.0
        for alpha, beta in combos:
            s = (1 - alpha) * cos + alpha * pop[None, :] + beta * seen
            s[:, 0] = -np.inf
            idx = np.argpartition(-s, max_k, axis=1)[:, :max_k]
            order = np.take_along_axis(s, idx, 1).argsort(1)[:, ::-1]
            idx_parts[(alpha, beta)].append(np.take_along_axis(idx, order, 1))
    table: dict = {}
    for alpha, beta in combos:
        idx = (np.concatenate(idx_parts[(alpha, beta)])
               if idx_parts[(alpha, beta)]
               else np.zeros((0, max_k), np.int64))
        table[_combo_key(alpha, beta)] = recall_at_ks(idx, user_ids,
                                                  targets_idx, ks)
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best = max(table, key=lambda t: table[t][key])
    out = {"table": table, "best": best, "best_metrics": table[best]}
    if per_user_k is not None:
        name_of = {_combo_key(a, b): (a, b) for a, b in combos}
        full_idx = {nm: np.concatenate(idx_parts[c]) if idx_parts[c]
                    else np.zeros((0, max_k), np.int64)
                    for nm, c in name_of.items()
                    if nm == best or nm == "a0.0_b0.0"}
        out["_per_user"] = _blend_per_user(full_idx, best, user_ids,
                                           targets_idx, per_user_k)
    return out


def _blend_per_user(full_idx: dict, best: str, user_ids, targets_idx,
                    per_user_k: int) -> dict:
    from recsys.eval.recall import recall_per_user

    pu: dict = {"k": per_user_k}
    vals, kept = recall_per_user(full_idx[best], user_ids, targets_idx,
                                 per_user_k)
    pu["best"], pu["uids"] = vals, kept
    if "a0.0_b0.0" in full_idx:
        pu["model_only"], _ = recall_per_user(full_idx["a0.0_b0.0"],
                                              user_ids, targets_idx,
                                              per_user_k)
    return pu


def _blend_sweep_device(user_vecs, item_matrix, logq, histories, user_ids,
                        targets_idx, ks, alphas, betas,
                        per_user_k: int | None = None) -> dict:
    """Device backend for ``blend_sweep`` — identical math: per user batch,
    one resident (B, N+1) cosine block, ``lax.scan`` over the (alpha, beta)
    grid doing mask+blend+exact top-k. Exact ``lax.top_k`` keeps reported
    recalls honest (ties may order differently than the host argpartition;
    scores are continuous so this doesn't move the metrics)."""
    import jax
    import jax.numpy as jnp

    items = np.array(item_matrix, np.float32)
    items /= np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
    pop = _minmax(np.asarray(logq, np.float64)).astype(np.float32)
    max_k = max(ks)
    combos = [(a, b) for a in alphas for b in betas]
    ab = jnp.asarray(np.array(combos, np.float32))           # (M, 2)
    bs = 1024

    @jax.jit
    def batch_topk(u, it, pp, hist):
        cos = u @ it.T                                        # (B, N+1)
        lo = cos.min(1, keepdims=True)
        hi = cos.max(1, keepdims=True)
        cos = (cos - lo) / jnp.clip(hi - lo, 1e-12, None)
        rows = jnp.repeat(jnp.arange(u.shape[0]), hist.shape[1])
        seen = jnp.zeros_like(cos).at[rows, hist.reshape(-1)].max(1.0)

        def one(_, c):
            alpha, beta = c[0], c[1]
            s = (1 - alpha) * cos + alpha * pp[None, :] + beta * seen
            s = s.at[:, 0].set(-jnp.inf)                      # PAD row
            _, idx = jax.lax.top_k(s, max_k)
            return None, idx

        _, idxs = jax.lax.scan(one, None, ab)                 # (M, B, k)
        return idxs

    items_dev = jnp.asarray(items)
    pop_dev = jnp.asarray(pop)
    parts, origs = [], []
    n = len(user_vecs)
    for s0 in range(0, n, bs):
        u = np.asarray(user_vecs[s0:s0 + bs], np.float32)
        h = np.asarray(histories[s0:s0 + bs])
        origs.append(len(u))
        if origs[-1] < bs:  # fixed shapes: one compile for every batch
            u = np.concatenate([u, np.zeros((bs - origs[-1], u.shape[1]),
                                            np.float32)])
            h = np.concatenate([h, np.zeros((bs - origs[-1], h.shape[1]),
                                            h.dtype)])
        # bounded in-flight window: syncing per batch stalls the device
        # queue, but keeping ALL (M, B, k) results
        # on device is ~9 GB at 218k users x 21 combos x k=500 — so let a
        # few batches pipeline, then drain the oldest to host
        parts.append(batch_topk(jnp.asarray(u), items_dev, pop_dev,
                                jnp.asarray(h)))
        drain = len(parts) - 8
        for i in range(drain):
            if not isinstance(parts[i], np.ndarray):
                parts[i] = np.asarray(parts[i])[:, :origs[i]]
    parts = [p if isinstance(p, np.ndarray) else np.asarray(p)[:, :o]
             for p, o in zip(parts, origs)]
    table: dict = {}
    for m, (alpha, beta) in enumerate(combos):
        idx = (np.concatenate([p[m] for p in parts])
               if parts else np.zeros((0, max_k), np.int64))
        table[_combo_key(alpha, beta)] = recall_at_ks(idx, user_ids,
                                                  targets_idx, ks)
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best = max(table, key=lambda t: table[t][key])
    out = {"table": table, "best": best, "best_metrics": table[best]}
    if per_user_k is not None:
        name_of = {_combo_key(a, b): m for m, (a, b) in enumerate(combos)}
        full_idx = {nm: (np.concatenate([p[m] for p in parts]) if parts
                         else np.zeros((0, max_k), np.int64))
                    for nm, m in name_of.items()
                    if nm == best or nm == "a0.0_b0.0"}
        out["_per_user"] = _blend_per_user(full_idx, best, user_ids,
                                           targets_idx, per_user_k)
    return out


def baseline_report(tensors: dict, logq: np.ndarray, targets_idx: dict,
                    ks=(20, 100, 500), item_matrix: np.ndarray | None = None,
                    per_user_k: int | None = None) -> dict:
    """All training-free baselines evaluated with the tower-eval denominator
    semantics.

    ``tensors`` is the stage-2 tensor dict (`build_sasrec_tensors`): the
    user's training history is the left-padded ``input_ids`` row plus the
    final target item (the causal shift drops it from the inputs).
    ``item_matrix`` (the (N+1, D) stage-1 content matrix, PAD row 0) adds
    the content-profile baseline.

    ``per_user_k``: when set, the report gains a ``"_per_user"`` block with
    per-user recall@k arrays (one per baseline, aligned to ``"uids"``) for
    bootstrap CIs / paired significance tests (`recall.paired_delta_ci`).
    """
    from recsys.eval.recall import recall_per_user

    user_ids = list(tensors["user_ids"])
    max_k = max(ks)
    n = len(user_ids)
    full = np.concatenate([tensors["input_ids"],
                           tensors["target_ids"][:, -1:]], axis=1)
    histories = [full[r] for r in range(n)]
    idx = {
        "popularity": popularity_topk(logq, n, max_k),
        "repurchase": repurchase_topk(histories, logq, max_k),
    }
    if item_matrix is not None:
        idx["content_profile"] = content_profile_topk(histories, item_matrix,
                                                      max_k)
        idx["content_profile_recency"] = content_profile_topk(
            histories, item_matrix, max_k, half_life=10.0)
    report = {name: recall_at_ks(m, user_ids, targets_idx, ks)
              for name, m in idx.items()}
    if per_user_k is not None:
        pu: dict = {"k": per_user_k}
        for name, m in idx.items():
            vals, kept = recall_per_user(m, user_ids, targets_idx, per_user_k)
            pu[name] = vals
            pu["uids"] = kept
        report["_per_user"] = pu
    return report
