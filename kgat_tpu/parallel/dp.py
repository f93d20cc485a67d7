"""Data-parallel training over a device mesh (`dp` axis).

Strategy (SURVEY.md §2.3 DP row): CF/KG minibatches are sharded over chips
on the batch axis; parameters are replicated; XLA inserts the gradient
all-reduce from the sharding annotations (pick a mesh, annotate, let XLA
place collectives; on GPUs they run over NCCL). There is nothing to port:
the reference has no distributed path at all.

The graph (edge arrays) is replicated here; edge-*partitioned* execution
lives in kgat_tpu.parallel.partition / halo and composes with this DP axis.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kgat_tpu.graph import CKGMeta, Graph
from kgat_tpu.models import kgat


def _global_batch(sharding: NamedSharding, *arrays):
    """Host batches -> global sharded arrays on a multi-process runtime.

    On a real multi-host process group, jit rejects numpy (or process-
    local jax.Array) inputs under non-replicated in_shardings. Every
    process holds the identical full batch (deterministic sampling), so
    each device's shard is sliced straight out of the host copy. No-op
    single-process, and for arrays that are already global.

    CONTRACT: on a multi-process group the caller must pass either global
    jax.Arrays or host batches that are IDENTICAL on every process (the
    trainer seeds its host samplers identically); a divergent host batch
    silently yields wrong gradients. Set KGAT_DP_CHECK_BATCH=1 to verify
    the contract every step (a psum'd checksum — debug only, it costs a
    collective + host sync). Keep multi-process batches as numpy: a
    fully-addressable device array is pulled back to host here (ADVICE
    r3), which works but wastes a device round trip per step.
    """
    if jax.process_count() == 1:
        return arrays

    hosts = []

    def to_global(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return x  # already a global array
        h = np.asarray(x)
        hosts.append(h)
        return jax.make_array_from_callback(
            h.shape, sharding, lambda idx, h=h: h[idx])

    out = tuple(to_global(x) for x in arrays)
    if hosts and os.environ.get("KGAT_DP_CHECK_BATCH") == "1":
        _assert_identical_across_processes(sharding.mesh, hosts)
    return out


def _assert_identical_across_processes(mesh: Mesh, hosts) -> None:
    """Debug check: every process sampled the same host batch (see
    _global_batch contract). Checksums are psum'd over the mesh; if any
    process diverged, per-device contributions differ and the total stops
    being n_devices * local."""
    local = np.float64(sum(float(np.asarray(h, np.float64).sum())
                           + h.size * 1e-3 for h in hosts))
    dev = jax.make_array_from_callback(
        (len(mesh.devices.flat),),
        NamedSharding(mesh, P(mesh.axis_names)),
        lambda idx: np.full((1,), local, np.float64))
    total = float(jnp.sum(dev))
    expect = local * len(mesh.devices.flat)
    if not np.isclose(total, expect, rtol=1e-12, atol=1e-6):
        raise AssertionError(
            "KGAT_DP_CHECK_BATCH: host batches diverged across processes "
            f"(psum {total!r} != {expect!r}); the DP identical-batch "
            "contract is violated — check sampler seeding.")


def make_mesh(n_devices: int = 0, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices <= 0:
        n_devices = len(devs)
    # Auto axis types (jax.make_mesh defaults to Explicit since 0.9):
    # the framework is written auto-style — shard_map + in_shardings —
    # and Explicit-typed global arrays flip tracing into the
    # sharding-in-types mode, which breaks un-annotated model code on a
    # real multi-process group (tests/test_multihost_2proc.py).
    return jax.make_mesh((n_devices,), (axis,),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=devs[:n_devices])


def make_dp_cf_step(mesh: Mesh, graph: Graph, meta: CKGMeta,
                    cfg: kgat.KGATConfig, opt: optax.GradientTransformation,
                    axis: str = "dp") -> Callable:
    """Jitted CF step: batch sharded over `dp`, params replicated.

    Returns step(params, opt_state, att, u, ip, ineg, rng) -> (params,
    opt_state, loss). Batch size must divide the dp axis size.
    """
    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(axis))

    def loss_fn(params, att, u, ip, ineg, rng):
        return kgat.cf_loss(params, graph, att, meta, u, ip, ineg, cfg,
                            rng=rng, train=True)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, repl, batch_sh, batch_sh, batch_sh, repl),
        out_shardings=(repl, repl, repl),
        donate_argnums=(0, 1),
    )
    def _step(params, opt_state, att, u, ip, ineg, rng):
        loss, grads = jax.value_and_grad(loss_fn)(params, att, u, ip, ineg,
                                                  rng)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    def step(params, opt_state, att, u, ip, ineg, rng):
        u, ip, ineg = _global_batch(batch_sh, u, ip, ineg)
        return _step(params, opt_state, att, u, ip, ineg, rng)

    return step


def make_dp_kg_step(mesh: Mesh, cfg: kgat.KGATConfig,
                    opt: optax.GradientTransformation,
                    axis: str = "dp") -> Callable:
    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(axis))

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl) + (batch_sh,) * 4,
        out_shardings=(repl, repl, repl),
        donate_argnums=(0, 1),
    )
    def _step(params, opt_state, h, r, tp, tn):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.kg_loss(p, h, r, tp, tn, cfg))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    def step(params, opt_state, h, r, tp, tn):
        h, r, tp, tn = _global_batch(batch_sh, h, r, tp, tn)
        return _step(params, opt_state, h, r, tp, tn)

    return step


def make_dp_kg_scan(mesh: Mesh, cfg: kgat.KGATConfig,
                    opt: optax.GradientTransformation, kg_table,
                    batch_size: int, axis: str = "dp") -> Callable:
    """Device-resident DP KG phase: lax.scan over minibatches in one
    compiled program — device-side negative sampling, the TransR loss
    shard_map'd over the batch axis (per-shard partial sums psum'd),
    optimizer update replicated."""
    from kgat_tpu.sampler import sample_kg_batch

    def dp_loss_inner(params, h, r, tp, tn, w):
        pair, ssq = kgat.kg_pair_terms(params, h, r, tp, tn)
        num = jax.lax.psum(jnp.sum(pair * w), axis)
        den = jnp.maximum(jax.lax.psum(jnp.sum(w), axis), 1.0)
        reg = jax.lax.psum(ssq, axis) / batch_size
        return num / den + cfg.reg_kg * reg

    def dp_loss(params, h, r, tp, tn, w):
        smapped = jax.shard_map(
            dp_loss_inner, mesh=mesh,
            in_specs=(P(),) + (P(axis),) * 5, out_specs=P(),
            check_vma=False)
        return smapped(params, h, r, tp, tn, w)

    def scan(params, opt_state, keys):
        def step(carry, key):
            params, opt_state = carry
            h, r, tp, tn, w = sample_kg_batch(kg_table, key, batch_size)
            loss, grads = jax.value_and_grad(dp_loss)(params, h, r, tp,
                                                      tn, w)
            updates, opt_state = opt.update(grads, opt_state)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), keys)
        return params, opt_state, jnp.sum(losses)

    return scan
