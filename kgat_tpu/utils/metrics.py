"""Ranking metrics: recall@K, ndcg@K, precision@K, hit@K.

Counterpart of the reference's metrics module (SURVEY.md §2.1 evaluator row,
`jennyzhang0215/DGL-KGAT` metrics — reconstructed). Semantics (SURVEY.md
§3.5): full scoring against all items, train items masked to -inf, top-K,
binary relevance, log2 discount, IDCG from min(K, |test[u]|).

Device-friendly: everything below is jnp over fixed shapes, so the whole
evaluation (scores -> top-K -> metrics) runs jitted on the device; only the final
per-user reductions come back to host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def topk_metrics_multi(
    scores: jax.Array,      # (B, n_items) float, train items already masked
    test_mask: jax.Array,   # (B, n_items) bool/0-1, test positives per user
    ks: tuple,              # strictly the Ks to report, e.g. (20, 40, 100)
) -> dict:
    """Per-user metrics at every K in ``ks`` from ONE top-max(K) ranking.

    The reference evaluates the same ranking at several cutoffs (the
    original KGAT release reports K in {20,40,60,80,100}); ranking once at
    max(K) and reading each smaller K as a prefix is exact and costs one
    `lax.top_k`. Returns ``{"recall@20": (B,), ...}`` plus ``"valid"``.
    """
    ks = tuple(int(k) for k in ks)
    kmax = max(ks)
    test_mask = test_mask.astype(jnp.float32)
    n_test = jnp.sum(test_mask, axis=-1)                      # (B,)
    _, top_idx = jax.lax.top_k(scores, kmax)                  # (B, Kmax)
    hits = jnp.take_along_axis(test_mask, top_idx, axis=-1)   # (B, Kmax) 0/1

    pos = jnp.arange(kmax, dtype=jnp.float32)
    discounts = 1.0 / jnp.log2(pos + 2.0)                     # (Kmax,)
    n_hit_pfx = jnp.cumsum(hits, axis=-1)                     # (B, Kmax)
    dcg_pfx = jnp.cumsum(hits * discounts, axis=-1)           # (B, Kmax)
    # IDCG@k = sum of the first min(n_test, k) discounts.
    cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(discounts)])

    out = {"valid": (n_test > 0).astype(jnp.float32)}
    for k in ks:
        n_hit = n_hit_pfx[:, k - 1]
        out[f"recall@{k}"] = jnp.where(
            n_test > 0, n_hit / jnp.maximum(n_test, 1.0), 0.0)
        out[f"precision@{k}"] = n_hit / k
        out[f"hit@{k}"] = (n_hit > 0).astype(jnp.float32)
        idcg = cum[jnp.minimum(n_test, k).astype(jnp.int32)]
        out[f"ndcg@{k}"] = jnp.where(
            idcg > 0, dcg_pfx[:, k - 1] / jnp.maximum(idcg, 1e-12), 0.0)
    return out


def topk_metrics(
    scores: jax.Array,      # (B, n_items) float, train items already masked
    test_mask: jax.Array,   # (B, n_items) bool/0-1, test positives per user
    k: int,
) -> dict:
    """Per-user recall/ndcg/precision/hit at K for one user block.

    Returns dict of (B,) arrays. Users with no test items get 0s; callers
    mask them out of the average.
    """
    m = topk_metrics_multi(scores, test_mask, (k,))
    return {"recall": m[f"recall@{k}"], "ndcg": m[f"ndcg@{k}"],
            "precision": m[f"precision@{k}"], "hit": m[f"hit@{k}"],
            "valid": m["valid"]}
