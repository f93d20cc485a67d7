"""End-to-end integration (SURVEY.md §4 prescription 4 / BASELINE config 1):
1-layer GCN on a synthetic subsample, full-graph, CPU — loss decreases and
the eval metric clears an untrained floor."""

import numpy as np
import pytest

from kgat_tpu.models.kgat import KGATConfig
from kgat_tpu.train import Trainer
from kgat_tpu.utils.config import TrainConfig


def _cfg(tmp_path, sampler="device", epochs=8):
    return TrainConfig(
        dataset="synthetic", epochs=epochs, eval_every=epochs,
        lr=5e-3, cf_batch_size=256, kg_batch_size=256,
        sampler=sampler, seed=3, log_dir=str(tmp_path),
        syn_users=80, syn_items=60, syn_entities=120, syn_relations=4,
        syn_interactions=1200, syn_triples=800,
        model=KGATConfig(aggregator="gcn", conv_dims=(32,),
                         mess_dropout=(0.1,)),
    )


def test_train_loss_decreases_and_metrics(tmp_path):
    tr = Trainer(_cfg(tmp_path))
    first_cf, first_kg = tr.train_one_epoch()
    for _ in range(6):
        cf, kg = tr.train_one_epoch()
    assert cf < first_cf, f"CF loss did not decrease: {first_cf} -> {cf}"
    assert kg < first_kg, f"KG loss did not decrease: {first_kg} -> {kg}"
    m = tr.evaluate()
    assert 0.0 < m["recall"] <= 1.0
    assert 0.0 <= m["ndcg"] <= 1.0
    # Must beat a random ranker by a wide margin on this tiny catalogue:
    # random recall@20 with 60 items ~ 20/60 * small; trained model should
    # exceed 0.05 easily after a few epochs.
    assert m["recall"] > 0.05


def test_host_sampler_path(tmp_path):
    tr = Trainer(_cfg(tmp_path, sampler="host", epochs=2))
    cf1, kg1 = tr.train_one_epoch()
    cf2, kg2 = tr.train_one_epoch()
    assert np.isfinite([cf1, cf2, kg1, kg2]).all()


def test_checkpoint_resume_roundtrip(tmp_path):
    cfg = _cfg(tmp_path, epochs=2)
    cfg.eval_every = 1
    tr = Trainer(cfg)
    tr.train()
    assert tr.best_metric > 0

    # Load the saved best into a fresh trainer: the full state round-trips
    # (params + opt state + counters) and reproduces the recorded metric.
    cfg2 = _cfg(tmp_path, epochs=2)
    cfg2.eval_every = 1
    tr2 = Trainer(cfg2)
    from kgat_tpu.utils.checkpoint import load_checkpoint
    p, o, meta, rng = load_checkpoint(tr.ckpt_path(), tr2.params,
                                      tr2.opt_state)
    assert meta["epoch"] >= 1
    tr2.params, tr2.opt_state = p, o
    m = tr2.evaluate()
    np.testing.assert_allclose(m["recall"], meta["best_metric"], rtol=1e-5)


def test_reg_flags_and_packs():
    """--reg-cf/--reg-kg reach the model config (reference --regs parity);
    presets leave the ops backend to the platform; the SpMM kernel pads
    each layer's feature width to the power-of-two tile it needs."""
    from kgat_tpu.ops.pallas_backend import _feature_width
    from kgat_tpu.utils.config import parse_args

    cfg = parse_args(["--preset", "smoke-gcn", "--reg-cf", "3e-4",
                      "--reg-kg", "2e-5"])
    assert cfg.model.reg_cf == 3e-4 and cfg.model.reg_kg == 2e-5
    assert parse_args(["--preset", "yelp-device-sampling"]
                      ).model.ops_backend is None
    # default 3-layer config: spmm dims 64/64/32 need no padding.
    assert [_feature_width(d) for d in (64, 32, 16, 128)] == [64, 32, 16, 128]
    assert [_feature_width(d) for d in (8, 24, 100)] == [16, 32, 128]


def test_ks_flag_reaches_eval_config():
    from kgat_tpu.utils.config import parse_args

    cfg = parse_args(["--preset", "smoke-gcn", "--ks", "20,40,100"])
    assert cfg.ks == (20, 40, 100)
    assert cfg.k == 20  # primary (early-stopping) cutoff unchanged
    assert parse_args(["--preset", "smoke-gcn"]).ks == ()


def test_resume_prefers_newest_of_best_and_last(tmp_path):
    """The rolling _last checkpoint advances every eval; --resume restores
    from whichever of {best, last} has the higher epoch."""
    cfg = _cfg(tmp_path, epochs=3)
    cfg.eval_every = 1
    tr = Trainer(cfg)
    tr.train()
    import json
    import os
    assert os.path.exists(tr.last_ckpt_path() + ".npz")
    with open(tr.last_ckpt_path() + ".json") as f:
        last_meta = json.load(f)
    with open(tr.ckpt_path() + ".json") as f:
        best_meta = json.load(f)
    assert last_meta["epoch"] == 3            # saved on the final eval
    assert last_meta["epoch"] >= best_meta["epoch"]
    assert "model" in last_meta               # sidecar carries model config

    cfg2 = _cfg(tmp_path, epochs=3)
    cfg2.eval_every = 1
    cfg2.resume = True
    tr2 = Trainer(cfg2)
    tr2._resume()
    assert tr2.epoch == last_meta["epoch"]
    assert tr2.best_metric == best_meta["best_metric"]
    assert tr2.bad_evals == last_meta["bad_evals"]

    # With only the best checkpoint present, resume falls back to it.
    os.remove(tr.last_ckpt_path() + ".npz")
    tr3 = Trainer(cfg2)
    tr3._resume()
    assert tr3.epoch == best_meta["epoch"]


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Per-host sharded checkpoints (SURVEY.md §5 checkpoint row): every
    process writes its row-slice of the large tables; resume reassembles.
    Multi-host is simulated by writing both shards from one process with
    explicit (process_index, process_count) — the degenerate single-host
    path is what Trainer uses when jax.process_count() > 1."""
    import jax
    import optax
    from kgat_tpu.utils.checkpoint import (load_checkpoint_sharded,
                                           save_checkpoint_sharded)

    tr = Trainer(_cfg(tmp_path, epochs=1))
    opt_state = tr.opt_state
    rng = jax.random.key(7)
    path = str(tmp_path / "sharded_ck")
    for pi in range(2):
        save_checkpoint_sharded(path, tr.params, opt_state, epoch=4,
                                rng=rng, best_metric=0.25, bad_evals=1,
                                process_index=pi, process_count=2)
    import os
    assert os.path.exists(path + ".shard0of2.npz")
    assert os.path.exists(path + ".shard1of2.npz")
    p, o, meta, rng2 = load_checkpoint_sharded(path, tr.params, opt_state)
    assert meta["epoch"] == 4 and meta["n_shards"] == 2
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(o), jax.tree.leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jax.random.key_data(rng2),
                                  jax.random.key_data(rng))
