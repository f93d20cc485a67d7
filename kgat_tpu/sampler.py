"""Minibatch samplers: BPR (u, i+, i-) and TransR (h, r, t+, t-).

The reference samples on the host with numpy rejection sampling
(SURVEY.md §2.1 CF/KG batch sampler rows, §3.3/§3.4). This module provides
both that host path (bit-compatible semantics) and a
**device-side sampler** the north-star requires (BASELINE.json:5
"minibatch BPR sampler -> device-side negative sampling"): uniform draws
with `jax.random`, membership tests via vectorized binary search over the
sorted interaction/triple tables that live in HBM, and a bounded rejection
loop expressed as `lax.scan` (no data-dependent Python control flow, so the
whole epoch can be one compiled program).

Rejection-failure handling: after `max_tries` the row keeps its last
candidate but gets weight 0; losses consume the weight vector, so a failed
row simply drops out of the batch mean. Collision probability per try is
deg(u)/n_items (~1e-3 on the reference datasets), so weight-0 rows are
~1e-3^max_tries rare — statistically negligible bias (SURVEY.md hard-part #5).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Sorted-pair membership: the device-side replacement for `x in train_dict[u]`.
# ---------------------------------------------------------------------------

def pair_lower_bound(sorted_a: jax.Array, sorted_b: jax.Array,
                     qa: jax.Array, qb: jax.Array) -> jax.Array:
    """Vectorized lexicographic lower bound over pairs (a, b).

    sorted_a/sorted_b: (n,) arrays sorted by (a, b). qa/qb: (m,) queries.
    Returns (m,) indices of the first pair >= (qa, qb).
    """
    n = sorted_a.shape[0]
    steps = max(1, int(np.ceil(np.log2(n + 1))))
    lo = jnp.zeros(qa.shape, jnp.int32)
    hi = jnp.full(qa.shape, n, jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        midc = jnp.minimum(mid, n - 1)
        a, b = sorted_a[midc], sorted_b[midc]
        less = (a < qa) | ((a == qa) & (b < qb))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def pair_member(sorted_a: jax.Array, sorted_b: jax.Array,
                qa: jax.Array, qb: jax.Array) -> jax.Array:
    """True where (qa, qb) is present in the sorted pair table."""
    n = sorted_a.shape[0]
    lb = pair_lower_bound(sorted_a, sorted_b, qa, qb)
    lbc = jnp.minimum(lb, n - 1)
    return (lb < n) & (sorted_a[lbc] == qa) & (sorted_b[lbc] == qb)


def triple_member(sorted_a: jax.Array, sorted_b: jax.Array,
                  sorted_c: jax.Array, qa: jax.Array, qb: jax.Array,
                  qc: jax.Array) -> jax.Array:
    """True where (qa, qb, qc) is present in the lex-sorted triple table.

    Three separate int32 keys instead of a packed key: h*R+r overflows
    int32 once n_entities * n_relations >= 2^31 (~10x the reference
    datasets), and device int64 requires the global x64 flag.
    """
    n = sorted_a.shape[0]
    steps = max(1, int(np.ceil(np.log2(n + 1))))
    lo = jnp.zeros(qa.shape, jnp.int32)
    hi = jnp.full(qa.shape, n, jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        midc = jnp.minimum(mid, n - 1)
        a, b, c = sorted_a[midc], sorted_b[midc], sorted_c[midc]
        less = ((a < qa) | ((a == qa) & (b < qb))
                | ((a == qa) & (b == qb) & (c < qc)))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
    lbc = jnp.minimum(lo, n - 1)
    return ((lo < n) & (sorted_a[lbc] == qa) & (sorted_b[lbc] == qb)
            & (sorted_c[lbc] == qc))


# ---------------------------------------------------------------------------
# Segment-bounded membership: the sampler already knows each query's CSR
# segment (the user's item run / the head's triple run), so the binary
# search only needs log2(max segment) rounds over ONE (or two) key arrays
# instead of log2(table) rounds over two (three). At Yelp2018 scale this
# cut the device KG sampler from 17.7 ms to the low single digits — it was
# ~85% of the whole KG train step (the binary-search rounds are serially
# dependent scalar-gather waves; fewer x narrower rounds is the win).
# ---------------------------------------------------------------------------

def ranged_member(sorted_v: jax.Array, lo0: jax.Array, hi0: jax.Array,
                  q: jax.Array, steps: int) -> jax.Array:
    """True where q appears in sorted_v[lo0:hi0) (per-query bounds).

    steps must be >= ceil(log2(max segment length + 1)) — pass the static
    bound the table records at build time.
    """
    n = sorted_v.shape[0]
    lo, hi = lo0, hi0

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = sorted_v[jnp.minimum(mid, n - 1)]
        less = v < q
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, _ = jax.lax.fori_loop(0, max(1, steps), body, (lo, hi))
    return (lo < hi0) & (sorted_v[jnp.minimum(lo, n - 1)] == q)


def ranged_lower_bound(sorted_v: jax.Array, lo0: jax.Array, hi0: jax.Array,
                       q: jax.Array, steps: int) -> jax.Array:
    """Index of the first element >= q within sorted_v[lo0:hi0)."""
    n = sorted_v.shape[0]
    lo, hi = lo0, hi0

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = sorted_v[jnp.minimum(mid, n - 1)]
        # mid < hi guards the converged state: once lo == hi, the probe
        # reads OUTSIDE [lo0, hi0) (the next segment's keys) and an
        # unguarded step would walk lo past the range end.
        less = (v < q) & (mid < hi)
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, _ = jax.lax.fori_loop(0, max(1, steps), body, (lo, hi))
    return lo


def rank_skip(sorted_v: jax.Array, lo0: jax.Array, g: jax.Array,
              k: jax.Array, steps: int) -> jax.Array:
    """Order-statistics core of the direct negative draw.

    sorted_v[lo0:lo0+g) is a sorted run of FORBIDDEN values (unique).
    For a rank k (0-indexed) among the allowed values, returns p = the
    number of forbidden values <= the k-th allowed value; the sample is
    then k + p. This converts rejection sampling into ONE log2(max run)
    binary search — same uniform-over-non-members distribution, no
    retries, no failure rows (SURVEY.md hard-part #5 revisited: the r4
    KG phase was 77% sampler, and the sampler was ~all membership-probe
    gather waves; see ROADMAP r4).

    Invariant: sorted_v[lo0+p] - p = the count of allowed values below
    that forbidden value; binary-search the smallest p with
    sorted_v[lo0+p] - p > k.
    """
    n = sorted_v.shape[0]
    lo_p = jnp.zeros_like(k)
    hi_p = jnp.broadcast_to(g, jnp.shape(k)).astype(k.dtype)

    def body(_, state):
        lo_p, hi_p = state
        mid = (lo_p + hi_p) // 2
        v = sorted_v[jnp.minimum(lo0 + mid, n - 1)]
        # mid < hi_p guards the converged state (p* == g would otherwise
        # probe one past the forbidden run — the next segment's values).
        le = ((v - mid) <= k) & (mid < hi_p)
        return jnp.where(le, mid + 1, lo_p), jnp.where(le, hi_p, mid)

    p, _ = jax.lax.fori_loop(0, max(1, steps), body, (lo_p, hi_p))
    return p


def ranged_member_pair(sorted_b: jax.Array, sorted_c: jax.Array,
                       lo0: jax.Array, hi0: jax.Array, qb: jax.Array,
                       qc: jax.Array, steps: int) -> jax.Array:
    """True where (qb, qc) appears lex-sorted in rows [lo0:hi0)."""
    n = sorted_b.shape[0]
    lo, hi = lo0, hi0

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        midc = jnp.minimum(mid, n - 1)
        b, c = sorted_b[midc], sorted_c[midc]
        less = (b < qb) | ((b == qb) & (c < qc))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, _ = jax.lax.fori_loop(0, max(1, steps), body, (lo, hi))
    lbc = jnp.minimum(lo, n - 1)
    return (lo < hi0) & (sorted_b[lbc] == qb) & (sorted_c[lbc] == qc)


def _auto_tries(p_max: float, floor: int = 4, cap: int = 16) -> int:
    """Smallest try count keeping the all-tries-collide probability under
    ~1e-9 at the worst query (p_max = max per-query collision odds). The
    fixed 16 the tables used before is ~4x more membership volume than
    reference-scale graphs need (p ~ 1e-3)."""
    if p_max <= 0.0:
        return floor
    if p_max >= 1.0:
        return cap
    import math
    t = int(np.ceil(-9.0 / math.log10(p_max)))
    return int(min(max(t, floor), cap))


def _log_steps(max_len: int) -> int:
    return max(1, int(np.ceil(np.log2(max_len + 1))))


# ---------------------------------------------------------------------------
# Device-side CF sampler.
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CFSampleTable:
    """Device-resident CF training interactions, sorted by (user, item)."""

    users: jax.Array       # (n_train,) int32 sorted
    items: jax.Array       # (n_train,) int32, sorted within each user
    user_ptr: jax.Array    # (n_users + 1,) int32 CSR offsets into items
    active_users: jax.Array  # (n_active,) users with >= 1 interaction
    n_items: int = dataclasses.field(metadata=dict(static=True))
    max_tries: int = dataclasses.field(default=16, metadata=dict(static=True))
    max_deg: int = dataclasses.field(default=0, metadata=dict(static=True))

    @staticmethod
    def build(cf_train: np.ndarray, n_users: int, n_items: int,
              max_tries: "int | None" = None) -> "CFSampleTable":
        pairs = np.asarray(cf_train, dtype=np.int64)
        # Unique (user, item) pairs: positives are drawn from the user's
        # item SET (reference dict semantics), and the rank_skip direct
        # negative draw requires unique sorted forbidden runs.
        pairs = np.unique(pairs, axis=0)
        user_ptr = np.searchsorted(pairs[:, 0], np.arange(n_users + 1))
        active = np.unique(pairs[:, 0])
        max_deg = int(np.max(np.diff(user_ptr))) if len(pairs) else 0
        if max_tries is None:
            max_tries = _auto_tries(max_deg / max(n_items, 1))
        return CFSampleTable(
            users=jnp.asarray(pairs[:, 0], jnp.int32),
            items=jnp.asarray(pairs[:, 1], jnp.int32),
            user_ptr=jnp.asarray(user_ptr, jnp.int32),
            active_users=jnp.asarray(active, jnp.int32),
            n_items=int(n_items),
            max_tries=int(max_tries),
            max_deg=max_deg,
        )


def sample_cf_batch(table: CFSampleTable, rng: jax.Array, batch_size: int
                    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Device-side (u, i+, i-, weight) batch.

    Semantics mirror the reference's generate_cf_batch: users drawn uniformly
    from users with interactions, one positive uniformly from the user's
    items, one negative rejection-sampled outside them.
    """
    r_user, r_pos, r_neg = jax.random.split(rng, 3)
    uidx = jax.random.randint(r_user, (batch_size,), 0,
                              table.active_users.shape[0])
    u = table.active_users[uidx]
    lo, hi = table.user_ptr[u], table.user_ptr[u + 1]
    pos_off = jax.random.randint(r_pos, (batch_size,), 0, 1 << 30)
    i_pos = table.items[lo + pos_off % jnp.maximum(hi - lo, 1)]

    # Direct draw over the user's NON-interacted items (no rejection):
    # sample a rank among the n_items - deg allowed items, then convert
    # rank -> item id with one order-statistics binary search over the
    # user's sorted item run (rank_skip). Exactly the uniform-over-
    # non-members distribution rejection sampling converges to, at a
    # deterministic log2(max degree) gather rounds.
    deg = hi - lo
    n_allowed = table.n_items - deg
    k = jax.random.randint(r_neg, (batch_size,), 0,
                           jnp.maximum(n_allowed, 1))
    p = rank_skip(table.items, lo, deg, k, _log_steps(table.max_deg))
    i_neg = k + p
    valid = n_allowed > 0  # degenerate: user interacted with everything
    return (u, i_pos, jnp.where(valid, i_neg, 0),
            valid.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Device-side KG sampler.
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KGSampleTable:
    """Device-resident KG triples (with inverses), lex-sorted by (h, r, t).

    Three separate int32 key arrays (no packed h*R+r key): safe for graphs
    up to 2^31 entities regardless of relation count.
    """

    h: jax.Array         # (n_kg,) int32, in *sampling* order (original)
    r: jax.Array
    t: jax.Array
    h_sorted: jax.Array   # (n_unique,) int32, lex-sorted by (h, r, t)
    r_sorted: jax.Array
    t_sorted: jax.Array
    h_ptr: jax.Array      # (n_entities + 1,) int32 CSR offsets by head
    n_entities: int = dataclasses.field(metadata=dict(static=True))
    n_relations: int = dataclasses.field(metadata=dict(static=True))
    max_tries: int = dataclasses.field(default=16, metadata=dict(static=True))
    max_deg: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Largest (h, r) group — the rank_skip search bound for the direct
    # negative draw.
    max_rg: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Per ORIGINAL triple row: its (h, r) group's [lo, hi) bounds in the
    # sorted arrays — precomputed so the negative draw needs ZERO
    # narrowing rounds (the bounds depend only on the sampled row).
    rg_lo: "jax.Array | None" = None
    rg_hi: "jax.Array | None" = None

    @staticmethod
    def build(triples: np.ndarray, n_entities: int, n_relations: int,
              max_tries: "int | None" = None) -> "KGSampleTable":
        tr = np.asarray(triples, dtype=np.int64)
        # Sorted arrays are membership/rank indexes: they must be UNIQUE
        # for the rank_skip draw (duplicate triples would under-count the
        # allowed set). The h/r/t sampling arrays keep multiplicity — the
        # reference samples positives uniformly over the triple LIST.
        srt = np.unique(tr, axis=0)
        h_ptr = np.searchsorted(srt[:, 0], np.arange(n_entities + 1))
        # (h, r) group bounds per ORIGINAL row (packed int64 keys, host).
        R64 = max(int(n_relations), 1)
        skey = srt[:, 0] * R64 + srt[:, 1]
        okey = tr[:, 0] * R64 + tr[:, 1]
        rg_lo = np.searchsorted(skey, okey, side="left")
        rg_hi = np.searchsorted(skey, okey, side="right")
        max_deg = int(np.max(np.diff(h_ptr))) if len(tr) else 0
        if len(tr):
            _, cnt = np.unique(srt[:, :2], axis=0, return_counts=True)
            max_rg = int(cnt.max())
        else:
            max_rg = 0
        if max_tries is None:
            # Worst collision odds: the largest (h, r) group over the
            # entity count (the draw collides only within the query's own
            # (h, r) tail set).
            max_tries = _auto_tries(max_rg / max(n_entities, 1)
                                    if len(tr) else 0.0)
        return KGSampleTable(
            h=jnp.asarray(tr[:, 0], jnp.int32),
            r=jnp.asarray(tr[:, 1], jnp.int32),
            t=jnp.asarray(tr[:, 2], jnp.int32),
            h_sorted=jnp.asarray(srt[:, 0], jnp.int32),
            r_sorted=jnp.asarray(srt[:, 1], jnp.int32),
            t_sorted=jnp.asarray(srt[:, 2], jnp.int32),
            h_ptr=jnp.asarray(h_ptr, jnp.int32),
            n_entities=int(n_entities),
            n_relations=int(n_relations),
            max_tries=int(max_tries),
            max_deg=max_deg,
            max_rg=max_rg,
            rg_lo=jnp.asarray(rg_lo, jnp.int32),
            rg_hi=jnp.asarray(rg_hi, jnp.int32),
        )


def sample_kg_batch(table: KGSampleTable, rng: jax.Array, batch_size: int
                    ) -> Tuple[jax.Array, ...]:
    """Device-side (h, r, t+, t-, weight) batch (reference generate_kg_batch).

    Negative tails are drawn DIRECTLY over the allowed set (no
    rejection): the sampled row's (h, r) sub-run bounds come precomputed
    (rg_lo/rg_hi — zero narrowing rounds), then rank_skip converts a
    uniform rank among the n_entities - |sub-run| allowed tails into the
    tail id. Distribution identical to rejection sampling (uniform over
    non-members); cost drops from max_tries x log2(max_deg) two-key
    gather rounds to log2(max (h,r) group) one-key rounds (the r4 KG
    phase was 77% sampler: 5.9 of 7.7 ms/step -> 1.4 with the search,
    less with the precomputed bounds).
    """
    r_idx, r_neg = jax.random.split(rng)
    idx = jax.random.randint(r_idx, (batch_size,), 0, table.h.shape[0])
    h, r, t_pos = table.h[idx], table.r[idx], table.t[idx]

    lo2, hi2 = table.rg_lo[idx], table.rg_hi[idx]
    g = hi2 - lo2                       # forbidden tails of this (h, r)
    n_allowed = table.n_entities - g
    k = jax.random.randint(r_neg, (batch_size,), 0,
                           jnp.maximum(n_allowed, 1))
    p = rank_skip(table.t_sorted, lo2, g, k, _log_steps(table.max_rg))
    t_neg = k + p
    valid = n_allowed > 0
    return (h, r, t_pos, jnp.where(valid, t_neg, 0),
            valid.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Host-side samplers (reference-style numpy rejection sampling).
# ---------------------------------------------------------------------------

class HostCFSampler:
    """Numpy sampler with the reference's exact semantics, for parity runs."""

    def __init__(self, train_user_dict, n_items: int, seed: int = 0):
        self.dict = {u: set(v.tolist()) for u, v in train_user_dict.items()}
        self.users = np.asarray(sorted(self.dict), dtype=np.int64)
        self.items_by_user = {u: np.asarray(sorted(s), dtype=np.int64)
                              for u, s in self.dict.items()}
        self.n_items = n_items
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int):
        u = self.rng.choice(self.users, size=batch_size)
        i_pos = np.empty(batch_size, np.int64)
        i_neg = np.empty(batch_size, np.int64)
        for k, uu in enumerate(u):
            items = self.items_by_user[int(uu)]
            i_pos[k] = items[self.rng.integers(len(items))]
            while True:
                cand = int(self.rng.integers(self.n_items))
                if cand not in self.dict[int(uu)]:
                    i_neg[k] = cand
                    break
        return u, i_pos, i_neg


class HostKGSampler:
    def __init__(self, triples: np.ndarray, n_entities: int, seed: int = 0):
        self.triples = np.asarray(triples, dtype=np.int64)
        self.existing = set(map(tuple, self.triples.tolist()))
        self.n_entities = n_entities
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int):
        idx = self.rng.integers(len(self.triples), size=batch_size)
        h, r, t_pos = self.triples[idx].T
        t_neg = np.empty(batch_size, np.int64)
        for k in range(batch_size):
            while True:
                cand = int(self.rng.integers(self.n_entities))
                if (int(h[k]), int(r[k]), cand) not in self.existing:
                    t_neg[k] = cand
                    break
        return h, r, t_pos, t_neg
