"""Alternating-phase KGAT trainer (reference main.py's train loop).

Reference control flow (SURVEY.md §3.1): per epoch, optimize the BPR CF loss
over all CF minibatches, then the TransR KG loss over all KG minibatches,
then recompute all edge attentions with no gradient, evaluating every
``eval_every`` epochs with early stopping on recall@K.

Device-resident restructuring: with device-side negative sampling
(kgat_tpu.sampler), each phase is ONE jitted ``lax.scan`` over its
minibatches — the host stays out of the hot loop entirely (the reference
crosses host->GPU per batch). The host-sampler path (reference-parity
semantics) keeps a per-batch jitted step instead.

KG phase trains over all CKG triples (KG + inverses + interact relations),
i.e. the collaborative knowledge graph the paper defines (SURVEY.md §2.4).
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from kgat_tpu import eval as evaluation
from kgat_tpu import graph as graph_mod
from kgat_tpu.data import Dataset, load_dataset, synthetic_dataset
from kgat_tpu.models import kgat
from kgat_tpu.ops import resolve_backend
from kgat_tpu.sampler import (CFSampleTable, KGSampleTable, sample_cf_batch,
                              sample_kg_batch)
from kgat_tpu.utils.checkpoint import (load_checkpoint_sharded,
                                       save_checkpoint,
                                       save_checkpoint_sharded)
from kgat_tpu.utils.config import TrainConfig, parse_args
from kgat_tpu.utils.logging import RunLogger


def load_any_dataset(cfg: TrainConfig) -> Dataset:
    if cfg.dataset == "synthetic":
        return synthetic_dataset(
            seed=cfg.seed, n_users=cfg.syn_users, n_items=cfg.syn_items,
            n_entities=cfg.syn_entities, n_relations_kg=cfg.syn_relations,
            n_interactions=cfg.syn_interactions, n_triples=cfg.syn_triples)
    return load_dataset(cfg.data_root, cfg.dataset)


def _chunked_epoch(scan_fn, n_batches: int, chunk: int, with_att: bool):
    """Wrap a scan-of-steps into bounded-size jitted device calls.

    Returns epoch(params, opt_state[, att], rng) -> (params, opt_state,
    mean_loss) running exactly n_batches steps as ceil-division chunks.
    """
    sizes = [chunk] * (n_batches // chunk)
    if n_batches % chunk:
        sizes.append(n_batches % chunk)

    jitted = {}
    for size in set(sizes):
        if getattr(scan_fn, "pre_jitted", False):
            # Partitioned scans arrive jitted (donation inside): re-jitting
            # would embed the global stacked graph as a constant, which a
            # multi-host mesh rejects (halo.make_cf_scan passes it through
            # the jit boundary as an argument instead).
            jitted[size] = scan_fn
        elif with_att:
            jitted[size] = jax.jit(
                lambda p, o, a, k, f=scan_fn: f(p, o, a, k),
                donate_argnums=(0, 1))
        else:
            jitted[size] = jax.jit(
                lambda p, o, k, f=scan_fn: f(p, o, k),
                donate_argnums=(0, 1))

    def epoch(params, opt_state, *args):
        *maybe_att, rng = args
        total = 0.0
        for i, size in enumerate(sizes):
            rng, sub = jax.random.split(rng)
            keys = jax.random.split(sub, size)
            if with_att:
                params, opt_state, s = jitted[size](params, opt_state,
                                                    maybe_att[0], keys)
            else:
                params, opt_state, s = jitted[size](params, opt_state, keys)
            total += float(s)
        return params, opt_state, total / n_batches

    return epoch


class Trainer:
    def __init__(self, cfg: TrainConfig, dataset: Optional[Dataset] = None):
        self.cfg = cfg
        # Form the multi-host process group FIRST: jax.distributed must
        # initialize before anything touches jax.devices() (the backend
        # pins to local-only otherwise). No-op single-process.
        from kgat_tpu.parallel.multihost import initialize_distributed
        initialize_distributed()
        self.ds = dataset if dataset is not None else load_any_dataset(cfg)
        self.graph, self.meta = self.ds.build(cache_dir=cfg.graph_cache)
        # Only process 0 writes the event log (and prints): per-process
        # appends to one JSONL would interleave garbage on a pod.
        p0 = jax.process_index() == 0
        self.logger = RunLogger(cfg.log_dir if p0 else None, cfg.run_name,
                                resume=cfg.resume, quiet=not p0)
        n_dev = len(jax.devices()) if cfg.n_devices == 0 else cfg.n_devices
        self.n_devices = n_dev
        self.partitioned = n_dev > 1

        # Samplers: CF over train interactions; KG over all CKG triples.
        self.cf_table = CFSampleTable.build(
            self.ds.cf_train, self.meta.n_users, self.meta.n_items)
        g = self.graph
        coo = graph_mod.host_coo(g)
        ckg_triples = np.stack([coo["dst"], coo["etype"], coo["src"]], axis=1)
        self.kg_table = KGSampleTable.build(
            ckg_triples, n_entities=self.meta.n_nodes,
            n_relations=self.meta.n_relations)

        self.eval_plan = evaluation.make_eval_plan(
            self.ds.train_user_dict, self.ds.test_user_dict,
            self.meta.n_items, block=cfg.test_block)

        # Reference batch counts: n_train // batch_size + 1 (ceil-ish, so
        # every epoch covers at least the full training set in expectation).
        self.n_cf_batches = self.ds.n_cf_train // cfg.cf_batch_size + 1
        self.n_kg_batches = g.n_edges // cfg.kg_batch_size + 1

        self.rng = jax.random.key(cfg.seed)
        self.rng, init_rng = jax.random.split(self.rng)
        pretrain = None
        if cfg.pretrain_path:
            # Reference --use_pretrain: BPR-MF npz with user_embed/item_embed.
            z = np.load(cfg.pretrain_path)
            pretrain = (z["user_embed"], z["item_embed"],
                        self.meta.n_entities)
        self.params = kgat.init_params(
            init_rng, self.meta.n_nodes, self.meta.n_relations, cfg.model,
            pretrain=pretrain)
        # One shared Adam over all params, both phases (the torch reference
        # drives both losses through a single optimizer instance).
        self.opt = optax.adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.epoch = 0
        self.best_metric = -1.0
        self.bad_evals = 0
        # Cached staged attention: recomputed once per epoch AFTER the KG
        # phase (reference order, SURVEY.md §3.1); serves evaluation and
        # the next epoch's CF phase. Params never change between epochs,
        # so end-of-epoch(N) attention == start-of-epoch(N+1) attention.
        self._att = None

        self._build_steps()

    # ------------------------------------------------------------------
    def _build_steps(self):
        if self.partitioned:
            self._build_partitioned_steps()
            return
        cfg, graph, meta = self.cfg, self.graph, self.meta
        mcfg = cfg.model
        opt = self.opt

        def cf_loss_fn(params, att, u, ip, ineg, w, rng):
            return kgat.cf_loss(params, graph, att, meta, u, ip, ineg, mcfg,
                                rng=rng, train=True, weight=w)

        def kg_loss_fn(params, h, r, tp, tn, w):
            return kgat.kg_loss(params, h, r, tp, tn, mcfg, weight=w)

        if cfg.sparse_adam:
            # Lazy row-sparse Adam for the KG phase (VERDICT r4 item 4):
            # TransR touches <=3B entity rows per batch; the dense optax
            # pass streams the full tables every step. Opt-in — TF-
            # LazyAdam semantics, see kgat_tpu/optim.py.
            from kgat_tpu.optim import make_sparse_kg_step
            sparse_kg = make_sparse_kg_step(mcfg, cfg.lr)

            def kg_update(params, opt_state, h, r, tp, tn, w):
                return sparse_kg(params, opt_state, h, r, tp, tn, w)
        else:
            def kg_update(params, opt_state, h, r, tp, tn, w):
                loss, grads = jax.value_and_grad(kg_loss_fn)(
                    params, h, r, tp, tn, w)
                updates, opt_state = opt.update(grads, opt_state)
                return optax.apply_updates(params, updates), opt_state, loss

        # Epochs run as scans of device-side-sampled steps, 64 CF / 512 KG
        # steps per device call; each chunk length is one compiled program
        # (ROADMAP A5 re-derives the sizes from a trace on the card).
        def cf_scan(params, opt_state, att, keys):
            def step(carry, key):
                params, opt_state = carry
                k_samp, k_drop = jax.random.split(key)
                u, ip, ineg, w = sample_cf_batch(
                    self.cf_table, k_samp, cfg.cf_batch_size)
                loss, grads = jax.value_and_grad(cf_loss_fn)(
                    params, att, u, ip, ineg, w, k_drop)
                updates, opt_state = opt.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), keys)
            return params, opt_state, jnp.sum(losses)

        def kg_scan(params, opt_state, keys):
            def step(carry, key):
                params, opt_state = carry
                h, r, tp, tn, w = sample_kg_batch(
                    self.kg_table, key, cfg.kg_batch_size)
                params, opt_state, loss = kg_update(
                    params, opt_state, h, r, tp, tn, w)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), keys)
            return params, opt_state, jnp.sum(losses)

        cf_epoch = _chunked_epoch(cf_scan, self.n_cf_batches,
                                  chunk=64, with_att=True)
        kg_epoch = _chunked_epoch(kg_scan, self.n_kg_batches,
                                  chunk=512, with_att=False)

        @jax.jit
        def attention(params):
            return kgat.attention_for_training(params, graph, mcfg)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def cf_step_host(params, opt_state, att, u, ip, ineg, rng):
            loss, grads = jax.value_and_grad(cf_loss_fn)(
                params, att, u, ip, ineg, None, rng)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def kg_step_host(params, opt_state, h, r, tp, tn):
            return kg_update(params, opt_state, h, r, tp, tn, None)

        @jax.jit
        def all_embed_fn(params, att):
            return kgat.propagate(params, graph, att, mcfg)

        self._cf_epoch = cf_epoch
        self._kg_epoch = kg_epoch
        self._attention = attention
        self._cf_step_host = cf_step_host
        self._kg_step_host = kg_step_host
        self._all_embed = all_embed_fn

        if cfg.sampler == "host":
            from kgat_tpu.sampler import HostCFSampler, HostKGSampler
            self._host_cf = HostCFSampler(self.ds.train_user_dict,
                                          self.meta.n_items, cfg.seed)
            coo = graph_mod.host_coo(graph)
            tri = np.stack([coo["dst"], coo["etype"], coo["src"]], axis=1)
            self._host_kg = HostKGSampler(tri, self.meta.n_nodes, cfg.seed)

    def _build_partitioned_steps(self):
        """Edge-partitioned CF phase + data-parallel KG phase over a mesh
        (BASELINE config 5: multi-device with boundary-embedding exchange).

        Both phases are device-resident chunked scans — ~20 host dispatches
        per epoch, same structure as the single-device path (a per-batch
        host loop costs ~3,700 round trips per epoch at reference scale)."""
        from kgat_tpu.parallel.dp import make_dp_kg_scan, make_mesh
        from kgat_tpu.parallel.halo import AXIS, make_partitioned
        from kgat_tpu.parallel.partition import partition_graph

        cfg, graph, meta = self.cfg, self.graph, self.meta
        if cfg.sparse_adam:
            raise ValueError(
                "--sparse-adam is single-device only: the data-parallel "
                "KG scan psums DENSE grad trees across replicas "
                "(parallel/dp.py); drop the flag or --n-devices")
        g = graph
        coo = graph_mod.host_coo(g)
        src, dst, ety = coo["src"], coo["dst"], coo["etype"]
        # (The DCN process group was formed at Trainer construction —
        # before any device access; initialize_distributed is idempotent.)
        dp = max(1, cfg.dp_replicas)
        if self.n_devices % dp:
            raise ValueError(f"--dp-replicas {dp} must divide "
                             f"--n-devices {self.n_devices}")
        n_ep = self.n_devices // dp
        if dp > 1:
            # 2D (dp, ep) mesh: each dp row holds a full edge partition;
            # CF/KG batches shard over both axes. Graph shards stack over
            # the ep axis and replicate across dp rows (stack_shards
            # places per-device shards via make_array_from_callback).
            devs = jax.devices()[: self.n_devices]
            self.mesh = jax.make_mesh(
                (dp, n_ep), ("dp", AXIS),
                axis_types=(jax.sharding.AxisType.Auto,) * 2, devices=devs)
        else:
            self.mesh = make_mesh(self.n_devices, axis=AXIS)
        stack_mesh = self.mesh
        self.pgraph, self.pinfo = partition_graph(
            src, dst, ety, meta.n_nodes, meta.n_relations, n_ep,
            mesh=stack_mesh)
        ring_buckets = sel_halo = None
        if cfg.halo_exchange == "ring":
            from kgat_tpu.parallel.partition import build_ring_buckets
            ring_buckets = build_ring_buckets(src, dst, self.pinfo,
                                              mesh=stack_mesh)
        elif cfg.halo_exchange == "a2a":
            from kgat_tpu.parallel.partition import build_selective_halo
            sel_halo = build_selective_halo(src, dst, self.pinfo,
                                            mesh=stack_mesh)
        attention_p, propagate_eval_p, _make_cf_step, make_cf_scan = \
            make_partitioned(self.mesh, self.pgraph, self.pinfo, meta,
                             cfg.model, exchange=cfg.halo_exchange,
                             ring_buckets=ring_buckets, sel_halo=sel_halo,
                             dp_axis="dp" if dp > 1 else None)
        self._attention = lambda params: attention_p(self.pgraph, params)[1]
        self._propagate_eval = propagate_eval_p
        # batch sizes must divide the device count
        rnd = lambda b: -(-b // self.n_devices) * self.n_devices  # noqa: E731
        self._cf_bs = rnd(cfg.cf_batch_size)
        self._kg_bs = rnd(cfg.kg_batch_size)
        self._cf_epoch_part = _chunked_epoch(
            make_cf_scan(self.opt, self.cf_table, self._cf_bs),
            self.n_cf_batches, chunk=64, with_att=True)
        kg_axis = ("dp", AXIS) if dp > 1 else AXIS
        self._kg_epoch_part = _chunked_epoch(
            make_dp_kg_scan(self.mesh, cfg.model, self.opt, self.kg_table,
                            self._kg_bs, axis=kg_axis),
            self.n_kg_batches, chunk=512, with_att=False)

    def _partitioned_epoch(self, r_cf, r_kg, ew) -> Tuple[float, float]:
        self.params, self.opt_state, cf_l = self._cf_epoch_part(
            self.params, self.opt_state, ew, r_cf)
        self.params, self.opt_state, kg_l = self._kg_epoch_part(
            self.params, self.opt_state, r_kg)
        return float(cf_l), float(kg_l)

    # ------------------------------------------------------------------
    def train_one_epoch(self) -> Tuple[float, float]:
        cfg = self.cfg
        self.rng, r_cf, r_kg = jax.random.split(self.rng, 3)
        att = (self._att if self._att is not None
               else self._attention(self.params))
        self._att = None  # params are about to change
        try:
            if self.partitioned:
                return self._partitioned_epoch(r_cf, r_kg, att)
            if cfg.sampler == "device":
                self.params, self.opt_state, cf_l = self._cf_epoch(
                    self.params, self.opt_state, att, r_cf)
                self.params, self.opt_state, kg_l = self._kg_epoch(
                    self.params, self.opt_state, r_kg)
                return float(cf_l), float(kg_l)
            return self._host_sampled_epoch(att, r_cf)
        finally:
            # Reference order (SURVEY.md §3.1): attention recomputed after
            # the KG phase, reused by evaluate() and the next epoch.
            self._att = self._attention(self.params)

    def _host_sampled_epoch(self, att, r_cf) -> Tuple[float, float]:
        cfg = self.cfg
        cf_losses, kg_losses = [], []
        for b in range(self.n_cf_batches):
            u, ip, ineg = self._host_cf.sample(cfg.cf_batch_size)
            r_cf, sub = jax.random.split(r_cf)
            self.params, self.opt_state, l = self._cf_step_host(
                self.params, self.opt_state, att,
                jnp.asarray(u, jnp.int32), jnp.asarray(ip, jnp.int32),
                jnp.asarray(ineg, jnp.int32), sub)
            cf_losses.append(float(l))
        for b in range(self.n_kg_batches):
            h, r, tp, tn = self._host_kg.sample(cfg.kg_batch_size)
            self.params, self.opt_state, l = self._kg_step_host(
                self.params, self.opt_state,
                jnp.asarray(h, jnp.int32), jnp.asarray(r, jnp.int32),
                jnp.asarray(tp, jnp.int32), jnp.asarray(tn, jnp.int32))
            kg_losses.append(float(l))
        return float(np.mean(cf_losses)), float(np.mean(kg_losses))

    def evaluate(self) -> dict:
        att = (self._att if self._att is not None
               else self._attention(self.params))
        if self.partitioned:
            all_embed = self._propagate_eval(att, self.params)
        else:
            all_embed = self._all_embed(self.params, att)
        return evaluation.evaluate(all_embed, self.meta, self.eval_plan,
                                   k=self.cfg.k, ks=self.cfg.ks)

    # ------------------------------------------------------------------
    def ckpt_path(self) -> str:
        if self.cfg.ckpt_path:
            return self.cfg.ckpt_path
        base = self.cfg.log_dir or "."
        return f"{base}/{self.cfg.run_name}_best"

    def last_ckpt_path(self) -> str:
        return self.ckpt_path() + "_last"

    def _save_ckpt(self, path: str) -> None:
        mc = self.cfg.model
        # Multi-host: each process writes its row-slice of the big tables
        # (SURVEY.md §5 checkpoint row); single process keeps the
        # transparent one-file format.
        save = (save_checkpoint if jax.process_count() == 1
                else save_checkpoint_sharded)
        save(path, self.params, self.opt_state,
             epoch=self.epoch, rng=self.rng,
             best_metric=self.best_metric,
             bad_evals=self.bad_evals,
             extra={"model": {
                 "embed_dim": mc.embed_dim,
                 "relation_dim": mc.relation_dim,
                 "conv_dims": list(mc.conv_dims),
                 "aggregator": mc.aggregator,
                 "mess_dropout": list(mc.mess_dropout),
             }, "dataset": self.cfg.dataset})

    def _resume(self) -> None:
        """Restore from the newest of {best, last} checkpoints.

        The best checkpoint only advances on eval improvement; the rolling
        last checkpoint advances every eval, so a campaign killed between
        improvements resumes from where it actually was (losing at most
        eval_every epochs), with best_metric/bad_evals early-stop state
        intact."""
        states = []
        for path in (self.ckpt_path(), self.last_ckpt_path()):
            try:
                # Handles both formats: single-file and per-host shards.
                states.append((load_checkpoint_sharded(
                    path, self.params, self.opt_state), path))
            except FileNotFoundError:
                pass
        if not states:
            self.logger.log("resume_missing")
            return
        (state, path) = max(states, key=lambda s: s[0][2]["epoch"])
        self.params, self.opt_state, meta, self.rng = state
        self._att = None  # params changed; recompute lazily
        self.epoch = meta["epoch"]
        self.best_metric = meta["best_metric"]
        self.bad_evals = meta["bad_evals"]
        self.logger.log("resume", epoch=self.epoch, best=self.best_metric,
                        bad_evals=self.bad_evals, source=path)

    def train(self) -> dict:
        cfg = self.cfg
        g = self.graph
        if cfg.resume:
            self._resume()

        self.logger.log("start", dataset=self.ds.name,
                        n_nodes=self.meta.n_nodes, n_edges=g.n_edges,
                        n_relations=self.meta.n_relations,
                        cf_batches=self.n_cf_batches,
                        kg_batches=self.n_kg_batches,
                        aggregator=cfg.model.aggregator,
                        backend=resolve_backend(cfg.model.ops_backend),
                        sampler=cfg.sampler)
        self._profiling = False
        if cfg.profile_epochs > 0 and cfg.log_dir:
            # SURVEY.md §5 tracing: perfetto-compatible device trace.
            jax.profiler.start_trace(f"{cfg.log_dir}/trace_{cfg.run_name}")
            self._profiling = True
        try:
            final = self._train_loop()
        finally:
            # early stop / short runs must still terminate an open trace
            if self._profiling:
                jax.profiler.stop_trace()
                self._profiling = False
        self.logger.log("done", best_recall=self.best_metric)
        return final

    def _train_loop(self) -> dict:
        cfg = self.cfg
        g = self.graph
        final = {}
        while self.epoch < cfg.epochs:
            self.epoch += 1
            t0 = time.time()
            cf_l, kg_l = self.train_one_epoch()
            dt = time.time() - t0
            if self._profiling and self.epoch >= cfg.profile_epochs:
                jax.profiler.stop_trace()
                self._profiling = False
                self.logger.log("profile_saved",
                                dir=f"{cfg.log_dir}/trace_{cfg.run_name}")
            # Propagation touches every edge per layer, fwd+bwd, per batch.
            edges = (self.n_cf_batches * len(cfg.model.conv_dims)
                     * g.n_edges * 3)  # fwd + 2 bwd segment passes
            self.logger.log("epoch", epoch=self.epoch, cf_loss=cf_l,
                            kg_loss=kg_l, secs=round(dt, 3),
                            edges_per_s=round(edges / dt))
            if self.epoch % cfg.eval_every == 0 or self.epoch == cfg.epochs:
                m = self.evaluate()
                self.logger.log("eval", epoch=self.epoch, **m)
                final = m
                if m["recall"] > self.best_metric:
                    self.best_metric = m["recall"]
                    self.bad_evals = 0
                    self._save_ckpt(self.ckpt_path())
                else:
                    self.bad_evals += 1
                # Rolling full-state checkpoint every eval: --resume picks
                # the newest of {best, last}, so a kill between
                # improvements costs at most eval_every epochs.
                self._save_ckpt(self.last_ckpt_path())
                if self.bad_evals >= cfg.stopping_steps:
                    self.logger.log("early_stop", epoch=self.epoch,
                                    best=self.best_metric)
                    break
        return final


def main(argv=None):
    cfg = parse_args(argv)
    # Multi-host: the process group must form before anything touches
    # jax.devices(). Env-driven, no-op otherwise.
    from kgat_tpu.parallel.multihost import initialize_distributed
    initialize_distributed()
    from kgat_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    trainer = Trainer(cfg)
    return trainer.train()


if __name__ == "__main__":
    main()
