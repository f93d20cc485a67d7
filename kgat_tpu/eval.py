"""Full-ranking evaluation: recall@K / ndcg@K against all items.

Reference semantics (SURVEY.md §3.5): for each block of test users, score
U_block @ I^T over the *final concatenated* representations, mask the user's
train items to -inf, take top-K, compute metrics.

Shape discipline: user blocks are a static size; each user's
train/test item lists are flattened into (block, max_pairs, 2) padded int
arrays on the host once, so the whole evaluation is one jitted `lax.scan`
over blocks — no per-user host round trips (the reference does numpy topk
per block instead).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from kgat_tpu.graph import CKGMeta
from kgat_tpu.utils.metrics import topk_metrics_multi


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """Host-precomputed, padded per-block index tables."""

    user_blocks: np.ndarray   # (n_blocks, block) int32, padded with -1
    train_pairs: np.ndarray   # (n_blocks, max_tr, 2) [row_in_block, item], pad -> (block, 0)
    test_pairs: np.ndarray    # (n_blocks, max_te, 2)
    block: int
    n_items: int


def make_eval_plan(train_user_dict: Dict[int, np.ndarray],
                   test_user_dict: Dict[int, np.ndarray],
                   n_items: int, block: int = 2048) -> EvalPlan:
    test_users = np.asarray(sorted(test_user_dict), dtype=np.int32)
    n_blocks = max(1, -(-len(test_users) // block))
    ub = np.full((n_blocks, block), -1, np.int32)
    ub.flat[: len(test_users)] = test_users

    def pack(user_dict):
        # Vectorized: one numpy pass over all (user, item) pairs instead of
        # a Python loop per pair (~1M pairs at amazon-book scale).
        empty = np.full((n_blocks, 1, 2), [block, 0], np.int32)
        keys = np.asarray(sorted(user_dict), dtype=np.int64)
        if keys.size == 0 or test_users.size == 0:
            return empty
        lists = [np.asarray(user_dict[int(u)]).ravel() for u in keys]
        counts = np.asarray([x.size for x in lists], np.int64)
        pos = np.searchsorted(test_users, keys)
        posc = np.minimum(pos, test_users.size - 1)
        valid = (pos < test_users.size) & (test_users[posc] == keys)
        if not valid.any():
            return empty
        items = np.concatenate([x for x, v in zip(lists, valid) if v])
        u_pos = np.repeat(pos[valid], counts[valid])  # nondecreasing
        b = u_pos // block
        j = u_pos % block
        blk_counts = np.bincount(b, minlength=n_blocks)
        blk_start = np.concatenate([[0], np.cumsum(blk_counts)[:-1]])
        off = np.arange(u_pos.size) - blk_start[b]
        max_rows = max(1, int(blk_counts.max()))
        out = np.full((n_blocks, max_rows, 2), [block, 0], np.int32)
        out[b, off, 0] = j
        out[b, off, 1] = items
        return out

    return EvalPlan(user_blocks=ub, train_pairs=pack(train_user_dict),
                    test_pairs=pack(test_user_dict), block=block,
                    n_items=n_items)


@functools.partial(jax.jit, static_argnums=(5, 6))
def _run_eval(all_embed, user_rows, train_pairs, test_pairs, user_blocks,
              n_items: int, ks: tuple):
    item_embed = all_embed[:n_items]                  # (n_items, D)
    neg_inf = jnp.finfo(all_embed.dtype).min

    def block_fn(carry, xs):
        rows, tr, te, ub = xs
        u_emb = all_embed[rows]                               # (B, D)
        scores = u_emb @ item_embed.T                         # (B, n_items)
        # Mask train items (pad rows point at row `block`, dropped).
        scores = scores.at[tr[:, 0], tr[:, 1]].set(neg_inf, mode="drop")
        test_mask = jnp.zeros_like(scores).at[te[:, 0], te[:, 1]].set(
            1.0, mode="drop")
        m = topk_metrics_multi(scores, test_mask, ks)
        valid = m["valid"] * (ub >= 0)
        sums = {k_: jnp.sum(v * valid) for k_, v in m.items() if k_ != "valid"}
        sums["valid"] = jnp.sum(valid)
        return carry, sums

    _, sums = jax.lax.scan(block_fn, 0,
                           (user_rows, train_pairs, test_pairs, user_blocks))
    total = {k_: jnp.sum(v) for k_, v in sums.items()}
    n = jnp.maximum(total.pop("valid"), 1.0)
    return {k_: v / n for k_, v in total.items()}


def evaluate(all_embed: jax.Array, meta: CKGMeta, plan: EvalPlan,
             k: int = 20, ks: tuple = ()) -> Dict[str, float]:
    """Run the full blocked evaluation, jitted; returns scalar metrics.

    ``k`` is the primary cutoff (early stopping, plain-named keys);
    ``ks`` adds extra cutoffs reported as ``recall@K``-style keys — the
    reference's original release evaluates K in {20,40,60,80,100}. All
    cutoffs share one ranking pass (prefix metrics at max K).
    """
    all_ks = tuple(dict.fromkeys((int(k), *(int(x) for x in ks))))
    ub = jnp.asarray(plan.user_blocks)
    user_rows = jnp.where(ub >= 0, meta.user_node(ub), 0)
    out = _run_eval(all_embed, user_rows, jnp.asarray(plan.train_pairs),
                    jnp.asarray(plan.test_pairs), ub, plan.n_items, all_ks)
    res = {k_: float(v) for k_, v in out.items()}
    for name in ("recall", "ndcg", "precision", "hit"):
        res[name] = res[f"{name}@{k}"]
        if len(all_ks) == 1:
            del res[f"{name}@{k}"]
    return res
