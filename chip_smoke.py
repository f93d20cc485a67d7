"""Smoke test of KGAT on an NVIDIA GPU through the normal entry points.

Phases, in order (each prints its checks; any failure exits nonzero):

  (a) device   JAX must see a GPU; prints its kind, count and the card's
               name and power limit from nvidia-smi.
  (b) kernels  at Yelp2018 scale: the CSR SpMM kernel compiled for the card
               at the model's SpMM widths (d = 64, 64, 32), f32 and bf16
               feature streams, forward and VJP, each compared once with
               the XLA reference at highest matmul precision; the card-only
               tests (pytest marker ``gpu``); memory_analysis() of the
               compiled CF step.
  (c) train    kgat_tpu.train.main on a seeded synthetic export of Yelp2018
               at published scale (yelp-device-sampling recipe), one epoch
               and one eval: finite losses and a finite recall@20.
  (d) serve    kgat_tpu.recommend.main from that run's checkpoint: top-20
               for a few users with train items masked.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Usage (from the repository root; one process owns the card):
  python chip_smoke.py            # phases (a)-(d) on one GPU
  python chip_smoke.py --kernels  # phases (a)-(b) only (bring-up)
  python chip_smoke.py --four     # the partitioned path on four GPUs only

--four runs the yelp-partitioned path (BASELINE config 5) on 4 cards: the
allgather, a2a and ring exchanges on a 4-way edge partition and a
(dp=2, ep=2) mesh, each compared with the single-device propagate on card
0, plus one CF step and one KG step, and each card's peak memory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# Yelp2018 at published scale (KGAT paper Tab.1): users, items, entities,
# KG relations, interactions, triples.
YELP = (45_919, 45_538, 90_961, 42, 1_185_068, 1_853_704)
SEED = 0
SPMM_DIMS = (64, 64, 32)   # SpMM input widths: embed_dim, conv_dims[:-1]
# Tolerances of the on-card comparisons, each with its reason:
#  - f32 SpMM vs the f32 reference: summation order only;
#  - bf16 feature stream vs the reference on the same rounded values:
#    summation order, plus for the VJP the cotangent rounded to bf16
#    (8-bit mantissa) on its way into the kernel;
#  - the production forward: TF32 aggregator matmuls vs highest precision.
TOL = {"f32": 1e-4, "bf16_fwd": 1e-4, "bf16_vjp": 2e-2, "model": 2e-2}

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def rel_err(got, want) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"{'PASS' if ok else 'FAIL'} {name}: max rel err {err:.3e} "
        f"(tolerance {tol:.0e})")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside tolerance")


def phase_device(n_expected: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < n_expected:
        raise SystemExit(f"chip_smoke: needs {n_expected} GPUs, JAX found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"(a) device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}; jax {jax.__version__}")
    print(smi, flush=True)
    return devs


def yelp_dataset():
    from kgat_tpu.data import synthetic_dataset
    u, i, e, r, n, t = YELP
    return synthetic_dataset(seed=SEED, n_users=u, n_items=i, n_entities=e,
                             n_relations_kg=r, n_interactions=n,
                             n_triples=t, test_frac=0.1, name="yelp2018")


def phase_kernels(graph, meta) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import pytest

    from kgat_tpu.models import kgat
    from kgat_tpu.ops import pallas_backend as pb
    from kgat_tpu.ops import ref

    rng = np.random.default_rng(SEED)
    w = jnp.asarray(rng.uniform(size=graph.n_edges_pad).astype(np.float32))
    ew = jax.jit(lambda w_: pb.prepare_weights(graph, w_))(w)
    for d in sorted(set(SPMM_DIMS), reverse=True):
        xf = jnp.asarray(rng.normal(size=(graph.n_nodes, d))
                         .astype(np.float32))
        cot = jnp.asarray(rng.normal(size=(graph.n_nodes, d))
                          .astype(np.float32))
        with jax.default_matmul_precision("highest"):
            want, vjp_r = jax.vjp(
                jax.jit(lambda x_: ref.spmm(graph, w, x_)), xf)
            (dx_r,) = vjp_r(cot)
        for dt in ("f32", "bf16"):
            x = xf if dt == "f32" else xf.astype(jnp.bfloat16)
            t0 = time.perf_counter()
            got, vjp = jax.vjp(jax.jit(lambda x_: pb.spmm(graph, ew, x_)), x)
            (dx,) = vjp(cot)
            jax.block_until_ready((got, dx))
            log(f"(b) csr_spmm d={d} {dt}: compiled and ran fwd+vjp in "
                f"{time.perf_counter() - t0:.1f}s")
            if dt == "bf16":
                # Reference on the same bf16-rounded features.
                with jax.default_matmul_precision("highest"):
                    want_b = jax.jit(lambda x_: ref.spmm(graph, w, x_))(
                        x.astype(jnp.float32))
                check(f"spmm fwd d={d} bf16", rel_err(got, want_b),
                      TOL["bf16_fwd"])
                check(f"spmm vjp d={d} bf16", rel_err(dx, dx_r),
                      TOL["bf16_vjp"])
            else:
                check(f"spmm fwd d={d} f32", rel_err(got, want), TOL["f32"])
                check(f"spmm vjp d={d} f32", rel_err(dx, dx_r), TOL["f32"])

    # The production forward (kernel SpMM, TF32 aggregators) against the
    # reference forward at highest precision.
    cfg = kgat.KGATConfig()
    cfg_ref = kgat.KGATConfig(ops_backend="ref")
    params = kgat.init_params(jax.random.key(SEED), meta.n_nodes,
                              meta.n_relations, cfg)
    att = jax.jit(lambda p: kgat.attention_for_training(p, graph, cfg))(
        params)
    emb = jax.jit(lambda p, a: kgat.propagate(p, graph, a, cfg))(params, att)
    with jax.default_matmul_precision("highest"):
        att_r = jax.jit(lambda p: kgat.compute_attention(
            p, graph, cfg_ref))(params)
        emb_r = jax.jit(lambda p, a: kgat.propagate(p, graph, a, cfg_ref))(
            params, att_r)
    check("propagate (kernel, TF32) vs reference", rel_err(emb, emb_r),
          TOL["model"])

    log("(b) card-only tests (pytest -m gpu)")
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "--noconftest", "-p",
                      "no:cacheprovider",
                      os.path.join(here, "tests", "test_pallas_ops.py")])
    if rc != 0:
        raise SystemExit(f"chip_smoke: card-only tests failed (rc={rc})")

    opt = optax.adam(1e-4)
    b = 1024
    u = jnp.arange(b, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(b, dtype=jnp.int32) % meta.n_items
    ineg = (ip + 7) % meta.n_items

    def cf_step(params, opt_state, att):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, graph, att, meta, u, ip, ineg, cfg,
                                   rng=jax.random.key(0)))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    compiled = jax.jit(cf_step).lower(params, opt.init(params), att).compile()
    log(f"(b) CF step memory_analysis: {compiled.memory_analysis()}")


def phase_train(data_root: str, log_dir: str) -> str:
    import numpy as np

    from kgat_tpu import train
    args = ["--preset", "yelp-device-sampling", "--dataset", "yelp2018",
            "--data-root", data_root, "--epochs", "1", "--eval-every", "1",
            "--seed", str(SEED), "--log-dir", log_dir,
            "--run-name", "smoke"]
    log(f"(c) train: python -m kgat_tpu.train {' '.join(args)}")
    final = train.main(args)
    with open(os.path.join(log_dir, "smoke.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epoch = [e for e in events if e.get("event") == "epoch"][-1]
    log(f"(c) epoch: {json.dumps(epoch)}")
    if not np.isfinite([epoch["cf_loss"], epoch["kg_loss"]]).all():
        raise SystemExit("chip_smoke: non-finite training loss")
    if not np.isfinite(final["recall"]):
        raise SystemExit("chip_smoke: non-finite recall@20")
    log(f"(c) eval: recall@20 {final['recall']:.6f} "
        f"ndcg@20 {final['ndcg']:.6f}")
    return os.path.join(log_dir, "smoke_best")


def phase_serve(data_root: str, ckpt: str, out_path: str) -> None:
    from kgat_tpu import recommend
    from kgat_tpu.data import load_dataset

    users = [0, 1, 2, 3, 4, 5, 6, 7]
    args = ["--ckpt", ckpt, "--dataset", "yelp2018", "--data-root",
            data_root, "--users", ",".join(map(str, users)), "--k", "20",
            "--out", out_path]
    log(f"(d) serve: python -m kgat_tpu.recommend {' '.join(args)}")
    if recommend.main(args) != 0:
        raise SystemExit("chip_smoke: recommend failed")
    train = load_dataset(data_root, "yelp2018").train_user_dict
    with open(out_path) as f:
        recs = [json.loads(line) for line in f]
    if [r["user"] for r in recs] != users:
        raise SystemExit("chip_smoke: recommend answered other users")
    for r in recs:
        seen = set(int(i) for i in train.get(r["user"], ()))
        if len(r["items"]) != 20 or len(r["scores"]) != 20:
            raise SystemExit(f"chip_smoke: user {r['user']} got "
                             f"{len(r['items'])} finite items, not 20")
        if seen & set(r["items"]):
            raise SystemExit(f"chip_smoke: user {r['user']} was "
                             "recommended a train item")
    log(f"(d) top-20 for {len(recs)} users, none in train; user 0: "
        f"{recs[0]['items'][:5]}...")


def phase_four(ds, graph, meta) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from kgat_tpu.graph import host_coo
    from kgat_tpu.models import kgat
    from kgat_tpu.parallel.dp import make_dp_kg_step, make_mesh
    from kgat_tpu.parallel.halo import AXIS, make_partitioned
    from kgat_tpu.parallel.partition import (build_ring_buckets,
                                             build_selective_halo,
                                             partition_graph)
    from kgat_tpu.sampler import (CFSampleTable, KGSampleTable,
                                  sample_cf_batch, sample_kg_batch)

    cfg = kgat.KGATConfig()
    dev0 = jax.devices()[0]
    params = kgat.init_params(jax.random.key(SEED), meta.n_nodes,
                              meta.n_relations, cfg)
    with jax.default_device(dev0):
        emb_1 = np.asarray(jax.jit(lambda p: kgat.propagate(
            p, graph, kgat.attention_for_training(p, graph, cfg), cfg))(
                params))
    log("(four) single-device propagate on card 0 done")
    coo = host_coo(graph)
    src, dst, ety = coo["src"], coo["dst"], coo["etype"]
    opt = optax.adam(1e-4)
    cf_table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items)
    kg_table = KGSampleTable.build(np.stack([dst, ety, src], axis=1),
                                   meta.n_nodes, meta.n_relations)
    u, ip, ineg, w = sample_cf_batch(cf_table, jax.random.key(1), 1024)
    h, r, tp, tn, _ = sample_kg_batch(kg_table, jax.random.key(2), 2048)

    mesh4 = make_mesh(4, axis=AXIS)
    mesh22 = jax.make_mesh((2, 2), ("dp", AXIS),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2,
                           devices=jax.devices()[:4])
    pg4, info4 = partition_graph(src, dst, ety, meta.n_nodes,
                                 meta.n_relations, 4, mesh=mesh4)
    pg2, info2 = partition_graph(src, dst, ety, meta.n_nodes,
                                 meta.n_relations, 2, mesh=mesh22)
    runs = [
        ("allgather ep=4", mesh4, pg4, info4, {}),
        ("a2a ep=4", mesh4, pg4, info4,
         dict(exchange="a2a", sel_halo=build_selective_halo(
             src, dst, info4, mesh=mesh4))),
        ("ring ep=4", mesh4, pg4, info4,
         dict(exchange="ring", ring_buckets=build_ring_buckets(
             src, dst, info4, mesh=mesh4))),
        ("allgather dp=2 x ep=2", mesh22, pg2, info2, dict(dp_axis="dp")),
    ]
    for name, mesh, pg, info, kw in runs:
        attention, propagate_eval, make_cf_step, _ = make_partitioned(
            mesh, pg, info, meta, cfg, **kw)
        _, ew = attention(pg, params)
        emb = propagate_eval(ew, params)
        check(f"{name} propagate vs single device", rel_err(emb, emb_1),
              TOL["model"])
        p2, _, loss = make_cf_step(opt)(jax.tree.map(jnp.copy, params),
                                        opt.init(params), ew, u, ip, ineg,
                                        w, jax.random.key(3))
        if not np.isfinite(float(loss)):
            raise SystemExit(f"chip_smoke: {name} CF loss not finite")
        log(f"(four) {name}: CF step loss {float(loss):.6f}")
    kg_step = make_dp_kg_step(mesh4, cfg, opt, axis=AXIS)
    _, _, kg_l = kg_step(params, opt.init(params), h, r, tp, tn)
    if not np.isfinite(float(kg_l)):
        raise SystemExit("chip_smoke: KG step loss not finite")
    log(f"(four) data-parallel KG step loss {float(kg_l):.6f}")
    for d in jax.devices()[:4]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", -1)
        log(f"(four) {d}: peak_bytes_in_use {peak} "
            f"({peak / 2**30:.2f} GiB)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", action="store_true",
                   help="stop after phase (b)")
    p.add_argument("--four", action="store_true",
                   help="run only the partitioned path on four GPUs")
    a = p.parse_args(argv)

    devs = phase_device(4 if a.four else 1)
    from kgat_tpu.utils.cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    from kgat_tpu.data import save_dataset

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke")
    data_root = os.path.join(work, "datasets")
    shutil.rmtree(work, ignore_errors=True)
    ds = yelp_dataset()
    save_dataset(ds, data_root)
    graph, meta = ds.build()
    log(f"yelp2018 synthetic export: {meta.n_nodes} nodes, "
        f"{graph.n_edges} CKG edges, {meta.n_relations} relations, "
        f"{ds.n_cf_train} train interactions -> {data_root}")
    if a.four:
        phase_four(ds, graph, meta)
    else:
        phase_kernels(graph, meta)
        if not a.kernels:
            del graph
            ckpt = phase_train(data_root, os.path.join(work, "logs"))
            phase_serve(data_root, ckpt,
                        os.path.join(work, "recommend.jsonl"))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
