"""Run configuration: dataclasses + argparse overrides + named presets.

The reference configures runs purely through main.py argparse flags
(SURVEY.md §5 config row, §2.9 for the default recipe). Here the same
recipe is a dataclass; the five BASELINE.json configs are checked in as
named presets (SURVEY.md §5 prescription).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from kgat_tpu.models.kgat import KGATConfig


@dataclasses.dataclass
class TrainConfig:
    # data
    dataset: str = "synthetic"          # synthetic | amazon-book | last-fm | yelp2018
    data_root: str = "datasets"
    # model (SURVEY.md §2.9 reference defaults)
    model: KGATConfig = dataclasses.field(default_factory=KGATConfig)
    # optimization
    lr: float = 1e-4
    cf_batch_size: int = 1024
    kg_batch_size: int = 2048
    epochs: int = 1000
    eval_every: int = 10
    stopping_steps: int = 10            # bad evals on recall@K before stop
    k: int = 20
    ks: tuple = ()                      # extra report-only cutoffs, e.g. (40, 100)
    test_block: int = 2048
    seed: int = 1234
    sampler: str = "device"             # device | host
    sparse_adam: bool = False           # lazy row-sparse Adam for the KG
                                        # phase (TF-LazyAdam semantics;
                                        # default OFF = dense optax.adam,
                                        # the reference semantics)
    # infra
    log_dir: Optional[str] = "runs"
    run_name: str = "kgat"
    ckpt_path: Optional[str] = None     # defaults to <log_dir>/<run_name>_best
    resume: bool = False
    n_devices: int = 1                  # >1/0: edge-partitioned over mesh
    dp_replicas: int = 1                # >1: 2D (dp, ep) mesh — n_devices
                                        # split into dp_replicas batch-
                                        # parallel groups of ep shards
    halo_exchange: str = "allgather"    # allgather | ring | a2a
    pretrain_path: Optional[str] = None  # npz with user_embed/item_embed
    profile_epochs: int = 0             # capture a jax.profiler trace
    graph_cache: Optional[str] = None   # dir for built-graph npz cache
    # synthetic dataset scale (used when dataset == synthetic)
    syn_users: int = 300
    syn_items: int = 200
    syn_entities: int = 500
    syn_relations: int = 8
    syn_interactions: int = 6000
    syn_triples: int = 4000


# The five driver configs (BASELINE.json:6-12), as named presets.
PRESETS = {
    # 1: CPU-runnable smoke: 1-layer GCN, small graph, full-graph propagation
    "smoke-gcn": dict(
        dataset="synthetic", epochs=30, eval_every=5, lr=1e-3,
        cf_batch_size=256, kg_batch_size=512,
        model=KGATConfig(aggregator="gcn", conv_dims=(32,),
                         mess_dropout=(0.1,)),
    ),
    # 2: reference recipe, 3-layer bi-interaction
    "lastfm-bi": dict(dataset="last-fm",
                      model=KGATConfig(aggregator="bi-interaction")),
    # 3: GraphSage ablation on Amazon-book
    "amazon-graphsage": dict(dataset="amazon-book",
                             model=KGATConfig(aggregator="graphsage")),
    # 4: Yelp2018 with device-side BPR sampling
    "yelp-device-sampling": dict(dataset="yelp2018", sampler="device",
                                 model=KGATConfig(
                                     aggregator="bi-interaction")),
    # 5: edge-partitioned multi-device Yelp2018
    "yelp-partitioned": dict(dataset="yelp2018", sampler="device",
                             n_devices=0,  # 0 = use all available
                             model=KGATConfig(aggregator="bi-interaction")),
}


def parse_args(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(description="KGAT trainer")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--aggregator", default=None,
                   choices=["gcn", "graphsage", "bi-interaction"])
    p.add_argument("--conv-dims", default=None,
                   help="comma-separated, e.g. 64,32,16")
    p.add_argument("--mess-dropout", default=None, help="comma-separated")
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--relation-dim", type=int, default=None)
    p.add_argument("--reg-cf", type=float, default=None,
                   help="L2 reg on CF embeddings (reference --regs[0])")
    p.add_argument("--reg-kg", type=float, default=None,
                   help="L2 reg on TransR triples (reference --regs[1])")
    p.add_argument("--compute-dtype", default=None,
                   choices=["f32", "bf16"],
                   help="SpMM feature-stream dtype of the GPU kernel; bf16 "
                        "halves the bytes it gathers (f32 accumulation)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--cf-batch-size", type=int, default=None)
    p.add_argument("--kg-batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--stopping-steps", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--ks", default=None,
                   help="comma-separated extra eval cutoffs (reference "
                        "release reports K in 20,40,60,80,100); --k stays "
                        "the early-stopping metric")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sampler", default=None, choices=["device", "host"])
    p.add_argument("--sparse-adam", action="store_true", default=None,
                   help="lazy row-sparse Adam for the KG phase: update "
                        "entity-embedding moments only for rows the "
                        "batch touches (TF-LazyAdam semantics; the "
                        "TransR loss reaches <=3B of ~150k rows). "
                        "Default off = dense optax.adam everywhere")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--run-name", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--n-devices", type=int, default=None,
                   help="devices for edge-partitioned training; 0 = all")
    p.add_argument("--dp-replicas", type=int, default=None,
                   help="2D (dp, ep) mesh: split --n-devices into this "
                        "many batch-parallel groups, each holding a full "
                        "edge partition (pod layout)")
    p.add_argument("--halo-exchange", default=None,
                   choices=["allgather", "ring", "a2a"],
                   help="partitioned boundary exchange: per-layer "
                        "all-gather (dense fast path), the overlapped "
                        "ring of bucket reduces, or selective halo "
                        "all-to-all (tables too large to replicate)")
    p.add_argument("--use-pretrain", dest="pretrain_path", default=None,
                   help="npz with user_embed/item_embed (BPR-MF init)")
    p.add_argument("--profile-epochs", type=int, default=None,
                   help="capture a jax.profiler trace of the first N epochs")
    p.add_argument("--graph-cache", default=None, metavar="DIR",
                   help="cache built graphs as npz under DIR (skips the "
                        "host-side build on repeated runs)")
    for f in ("users", "items", "entities", "relations", "interactions",
              "triples"):
        p.add_argument(f"--syn-{f}", type=int, default=None,
                       help=f"synthetic dataset: number of {f}")
    a = p.parse_args(argv)

    cfg = TrainConfig(**PRESETS[a.preset]) if a.preset else TrainConfig()
    for field in ("dataset", "data_root", "lr", "cf_batch_size",
                  "kg_batch_size", "epochs", "eval_every", "stopping_steps",
                  "k", "seed", "sampler", "sparse_adam", "log_dir",
                  "run_name", "n_devices",
                  "dp_replicas",
                  "halo_exchange", "pretrain_path",
                  "profile_epochs",
                  "graph_cache", "syn_users",
                  "syn_items", "syn_entities", "syn_relations",
                  "syn_interactions", "syn_triples"):
        v = getattr(a, field)
        if v is not None:
            setattr(cfg, field, v)
    if a.resume:
        cfg.resume = True
    if a.ks:
        cfg.ks = tuple(int(x) for x in a.ks.split(","))

    m = {}
    if a.aggregator:
        m["aggregator"] = a.aggregator
    if a.conv_dims:
        m["conv_dims"] = tuple(int(x) for x in a.conv_dims.split(","))
    if a.mess_dropout:
        m["mess_dropout"] = tuple(float(x) for x in a.mess_dropout.split(","))
    if a.embed_dim:
        m["embed_dim"] = a.embed_dim
    if a.relation_dim:
        m["relation_dim"] = a.relation_dim
    if a.reg_cf is not None:
        m["reg_cf"] = a.reg_cf
    if a.reg_kg is not None:
        m["reg_kg"] = a.reg_kg
    if a.compute_dtype:
        import jax.numpy as jnp
        m["compute_dtype"] = (jnp.bfloat16 if a.compute_dtype == "bf16"
                              else None)
    if m:
        if ("conv_dims" in m) != ("mess_dropout" in m):
            base = m.get("conv_dims", cfg.model.conv_dims)
            m.setdefault("mess_dropout", tuple(0.1 for _ in base))
        cfg.model = dataclasses.replace(cfg.model, **m)
    if len(cfg.model.conv_dims) != len(cfg.model.mess_dropout):
        p.error(f"--conv-dims has {len(cfg.model.conv_dims)} layers but "
                f"--mess-dropout has {len(cfg.model.mess_dropout)} rates; "
                "they must match")
    return cfg
