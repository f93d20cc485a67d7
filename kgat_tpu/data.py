"""Data layer: dataset loaders, CKG construction, and synthetic data.

Counterpart of the reference's data loader (SURVEY.md §2.1,
`jennyzhang0215/DGL-KGAT` dataloader.py — reconstructed, mount empty).
File formats (SURVEY.md §2.4, original KGAT release):

  train.txt / test.txt : one user per line: ``uid iid iid ...``
  kg_final.txt         : one triple per line: ``h r t`` (ids already remapped,
                         items occupy entity ids [0, n_items))

Everything here is host-side numpy; the output is a :class:`Dataset` whose
``build()`` produces the device-side :class:`~kgat_tpu.graph.Graph`.
No real datasets ship with this machine, so :func:`synthetic_dataset`
generates structurally-faithful data (power-law-ish degrees) at any scale
for tests and benchmarks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from kgat_tpu.graph import CKGMeta, Graph, build_ckg

# Try the native (C++) fast loaders first; fall back to numpy.
try:  # pragma: no cover - exercised when the native lib is built
    from kgat_tpu.native import parse_user_items as _native_parse
    from kgat_tpu.native import parse_triples as _native_triples
except Exception:  # noqa: BLE001
    _native_parse = None
    _native_triples = None


@dataclasses.dataclass
class Dataset:
    """A loaded recsys+KG dataset, host-side."""

    name: str
    cf_train: np.ndarray            # (n_train, 2) int64 (user, item)
    cf_test: np.ndarray             # (n_test, 2) int64
    kg_triples: np.ndarray          # (n_triples, 3) int64 (h, r, t)
    n_users: int
    n_items: int
    n_entities: int
    n_relations_kg: int

    # Derived, filled in __post_init__:
    train_user_dict: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    test_user_dict: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.train_user_dict:
            self.train_user_dict = _group_by_user(self.cf_train)
        if not self.test_user_dict:
            self.test_user_dict = _group_by_user(self.cf_test)

    @property
    def n_cf_train(self) -> int:
        return len(self.cf_train)

    @property
    def n_kg_train(self) -> int:
        return len(self.kg_triples)

    def build(self, *, edge_block: int = 2048, rel_block: int = 1024,
              cache_dir: "str | None" = None) -> Tuple[Graph, CKGMeta]:
        """Construct the collaborative knowledge graph from train CF + KG.

        cache_dir: if set, the built graph round-trips through
        ``<cache_dir>/ckg-<contenthash>.npz`` (graph.save_graph) — repeated
        runs on the same inputs skip the host build (the DGL-format-cache
        analog, SURVEY.md §2.2 graph-index row).
        """
        if cache_dir is not None:
            import hashlib

            from kgat_tpu.graph import (GRAPH_CACHE_VERSION, load_graph,
                                        save_graph)
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(self.cf_train).tobytes())
            h.update(np.ascontiguousarray(self.kg_triples).tobytes())
            h.update(repr((self.n_users, self.n_entities, self.n_items,
                           self.n_relations_kg, edge_block, rel_block,
                           GRAPH_CACHE_VERSION)).encode())
            path = os.path.join(cache_dir, f"ckg-{h.hexdigest()[:16]}.npz")
            if os.path.exists(path):
                import zipfile

                from kgat_tpu.graph import LAST_BUILD_STAGES
                try:
                    g, meta = load_graph(path)
                    if meta is not None:
                        # clear stale stage timings from any earlier cold
                        # build in this process before flagging warm
                        LAST_BUILD_STAGES.clear()
                        LAST_BUILD_STAGES["graph_cache"] = "warm"
                        return g, meta
                except (ValueError, KeyError, OSError, EOFError,
                        zipfile.BadZipFile):
                    pass  # stale/corrupt cache: rebuild below
        g, meta = build_ckg(
            self.cf_train, self.kg_triples,
            n_users=self.n_users, n_entities=self.n_entities,
            n_items=self.n_items, n_relations_kg=self.n_relations_kg,
            edge_block=edge_block, rel_block=rel_block,
        )
        if cache_dir is not None:
            from kgat_tpu.graph import LAST_BUILD_STAGES
            os.makedirs(cache_dir, exist_ok=True)
            save_graph(path, g, meta)
            LAST_BUILD_STAGES["graph_cache"] = "cold"
        return g, meta


def _group_by_user(pairs: np.ndarray) -> Dict[int, np.ndarray]:
    if len(pairs) == 0:
        return {}
    pairs = np.unique(np.asarray(pairs, dtype=np.int64), axis=0)
    uids, starts = np.unique(pairs[:, 0], return_index=True)
    chunks = np.split(pairs[:, 1], starts[1:])
    return {int(u): c for u, c in zip(uids, chunks)}


def _parse_user_items(path: str) -> np.ndarray:
    """Parse ``uid iid iid ...`` lines -> (n, 2) pairs. Native-accelerated."""
    if _native_parse is not None:
        return _native_parse(path)
    pairs = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            u = int(toks[0])
            for t in toks[1:]:
                pairs.append((u, int(t)))
    return np.asarray(pairs, dtype=np.int64)


def load_dataset(root: str, name: str) -> Dataset:
    """Load a dataset in the reference's on-disk format (amazon-book etc.)."""
    ddir = os.path.join(root, name)
    train = _parse_user_items(os.path.join(ddir, "train.txt"))
    test = _parse_user_items(os.path.join(ddir, "test.txt"))
    kg_path = os.path.join(ddir, "kg_final.txt")
    if _native_triples is not None:
        kg = _native_triples(kg_path)
    else:
        kg = np.loadtxt(kg_path, dtype=np.int64).reshape(-1, 3)
    # Deduplicate triples as the reference loader does.
    kg = np.unique(kg, axis=0)
    n_users = int(max(train[:, 0].max(), test[:, 0].max())) + 1
    n_items = int(max(train[:, 1].max(), test[:, 1].max())) + 1
    n_entities = int(max(kg[:, 0].max(), kg[:, 2].max(), n_items - 1)) + 1
    n_relations = int(kg[:, 1].max()) + 1
    return Dataset(
        name=name, cf_train=train, cf_test=test, kg_triples=kg,
        n_users=n_users, n_items=n_items, n_entities=n_entities,
        n_relations_kg=n_relations,
    )


def synthetic_dataset(
    seed: int = 0,
    n_users: int = 200,
    n_items: int = 150,
    n_entities: int = 300,
    n_relations_kg: int = 6,
    n_interactions: int = 2000,
    n_triples: int = 1500,
    test_frac: float = 0.2,
    name: str = "synthetic",
    n_factors: int = 32,
    cf_affinity: float = 0.75,
    kg_affinity: float = 0.75,
    user_mixture: int = 1,
) -> Dataset:
    """Generate a structurally-faithful synthetic dataset.

    Item/entity popularity follows a Zipf-like law (as in real recsys
    data), and interactions carry a LATENT-FACTOR signal: every entity
    (items included) belongs to one of ``n_factors`` clusters, each user
    prefers one cluster, and a ``cf_affinity`` fraction of each user's
    interactions are drawn from their preferred cluster (the rest from
    global popularity). KG triples are intra-cluster with probability
    ``kg_affinity``, so the knowledge graph genuinely links items that
    co-occur in preferences — the structure KGAT's attentive propagation
    is designed to exploit (KGAT paper §1's premise). With
    ``cf_affinity=0`` interactions are pure popularity draws and the
    recall ceiling collapses to the popularity baseline; the default makes
    held-out items predictable from train history + KG, so
    epochs-to-recall trajectories measure real collaborative learning.
    Every user has at least one train and one test interaction so
    evaluation is well-defined.

    user_mixture > 1 gives each user a Dirichlet-weighted taste over that
    many clusters instead of a single one — the taste space grows from K
    to ~K^m combinations, which stretches the epochs-to-recall curve
    (single-cluster tastes at published-scale sparsity are learned by the
    first eval; mixtures force the model to resolve per-user weights).
    """
    rng = np.random.default_rng(seed)
    assert n_entities >= n_items

    # Zipf-ish item popularity.
    item_p = 1.0 / (np.arange(n_items) + 1.0)
    item_p = rng.permutation(item_p)
    item_p /= item_p.sum()

    # Latent clusters over ALL entities (items are entities [0, n_items)).
    K = max(1, min(int(n_factors), n_items))
    ent_cluster = rng.integers(0, K, size=n_entities)
    m_mix = max(1, int(user_mixture))
    user_clusters = rng.integers(0, K, size=(n_users, m_mix))
    if m_mix == 1:
        user_w = np.ones((n_users, 1))
    else:
        user_w = rng.dirichlet(np.ones(m_mix), size=n_users)
    user_w_cum = np.cumsum(user_w, axis=1)

    def draw_items(uids: np.ndarray) -> np.ndarray:
        """Affinity mixture: cluster sampled from the user's taste weights
        w.p. cf_affinity, global popularity otherwise."""
        n = len(uids)
        out = rng.choice(n_items, size=n, p=item_p)     # popularity draws
        use_aff = rng.random(n) < cf_affinity
        mix_pick = (rng.random(n)[:, None]
                    < user_w_cum[uids]).argmax(axis=1)
        chosen = user_clusters[uids, mix_pick]
        for c in range(K):
            m = use_aff & (chosen == c)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            members = np.nonzero(ent_cluster[:n_items] == c)[0]
            if len(members) == 0:
                continue
            pc = item_p[members] / item_p[members].sum()
            out[m] = rng.choice(members, size=cnt, p=pc)
        return out

    users = rng.integers(0, n_users, size=n_interactions)
    items = draw_items(users)
    # Guarantee >= 2 interactions per user (1 train + 1 test).
    base_u = np.repeat(np.arange(n_users), 2)
    base_i = draw_items(base_u)
    users = np.concatenate([base_u, users])
    items = np.concatenate([base_i, items])
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)

    # Per-user split: test_frac of each user's items to test (vectorized:
    # rank each pair within its user's shuffled run, compare to cutoff).
    order = rng.permutation(len(pairs))
    pairs = pairs[order]
    sort = np.argsort(pairs[:, 0], kind="stable")
    pairs = pairs[sort]
    uids = pairs[:, 0]
    starts = np.searchsorted(uids, np.arange(n_users), side="left")
    ends = np.searchsorted(uids, np.arange(n_users), side="right")
    counts = ends - starts
    rank = np.arange(len(pairs)) - np.repeat(starts, counts)
    n_test_per_user = np.maximum(1, (counts * test_frac).astype(np.int64))
    n_test_per_user = np.minimum(n_test_per_user, np.maximum(counts - 1, 0))
    is_test = rank < np.repeat(n_test_per_user, counts)
    cf_train = pairs[~is_test]
    cf_test = pairs[is_test]

    ent_p = 1.0 / (np.arange(n_entities) + 1.0)
    ent_p = rng.permutation(ent_p)
    ent_p /= ent_p.sum()

    def draw_tails(heads: np.ndarray) -> np.ndarray:
        """Tail w.p. kg_affinity from the head's cluster, else global."""
        n = len(heads)
        out = rng.choice(n_entities, size=n, p=ent_p)
        use_aff = rng.random(n) < kg_affinity
        for c in range(K):
            m = use_aff & (ent_cluster[heads] == c)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            members = np.nonzero(ent_cluster == c)[0]
            if len(members) == 0:
                continue
            pc = ent_p[members] / ent_p[members].sum()
            out[m] = rng.choice(members, size=cnt, p=pc)
        return out

    h = rng.choice(n_entities, size=n_triples, p=ent_p)
    t = draw_tails(h)
    r = rng.integers(0, n_relations_kg, size=n_triples)
    # Ensure every item appears in the KG (items are entities [0, n_items)).
    # Intra-cluster coverage tails collide with their own head often enough
    # (small clusters, Zipf-weighted draws) that a single draw + the
    # `keep` filter below would silently drop the guaranteed row — redraw
    # self-loops, with a guaranteed-distinct fallback.
    cov_h = np.arange(n_items)
    cov_t = draw_tails(cov_h)
    for _ in range(4):
        m = cov_t == cov_h
        if not m.any():
            break
        cov_t[m] = draw_tails(cov_h[m])
    cov_t = np.where(cov_t == cov_h, (cov_h + 1) % n_entities, cov_t)
    h = np.concatenate([h, cov_h])
    t = np.concatenate([t, cov_t])
    r = np.concatenate([r, rng.integers(0, n_relations_kg, size=n_items)])
    keep = h != t
    kg = np.unique(np.stack([h[keep], r[keep], t[keep]], axis=1), axis=0)

    return Dataset(
        name=name, cf_train=cf_train.astype(np.int64),
        cf_test=cf_test.astype(np.int64), kg_triples=kg.astype(np.int64),
        n_users=n_users, n_items=n_items, n_entities=n_entities,
        n_relations_kg=n_relations_kg,
    )


def save_dataset(ds: Dataset, root: str) -> str:
    """Write a dataset in the reference's on-disk format.

    Produces <root>/<name>/{train,test,kg_final}.txt exactly as the
    reference repo ships them (SURVEY.md §2.4), so synthetic data can
    round-trip through the real loaders and users can export/import.
    """
    ddir = os.path.join(root, ds.name)
    os.makedirs(ddir, exist_ok=True)

    def write_ui(path, user_dict):
        with open(path, "w") as f:
            for u in sorted(user_dict):
                items = " ".join(str(i) for i in user_dict[u])
                f.write(f"{u} {items}\n")

    write_ui(os.path.join(ddir, "train.txt"), ds.train_user_dict)
    write_ui(os.path.join(ddir, "test.txt"), ds.test_user_dict)
    with open(os.path.join(ddir, "kg_final.txt"), "w") as f:
        for h, r, t in ds.kg_triples:
            f.write(f"{h} {r} {t}\n")
    return ddir
