"""Test config: run everything on CPU with 8 virtual devices.

The suite runs on the CPU: multi-device sharding tests run on a fake
8-device CPU mesh (SURVEY.md §4.3: `xla_force_host_platform_device_count`
— DGL's analog is faking multi-node with multi-process on localhost), and
the GPU SpMM kernel runs in the Pallas interpreter (``interpret=True``).
Tests marked ``gpu`` need the card and skip here; on the GPU,
``python chip_smoke.py`` runs them (see README).

The platform must be pinned before any jax import, hence conftest. Plugins
such as jaxtyping may import jax before this file runs, so besides the
environment variables, jax.config.update pins the CPU; XLA_FLAGS is read at
first backend init, so it still takes effect here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_platform_name", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def tiny_dataset():
    from kgat_tpu.data import synthetic_dataset
    return synthetic_dataset(seed=7, n_users=30, n_items=25, n_entities=50,
                             n_relations_kg=4, n_interactions=300,
                             n_triples=200)


@pytest.fixture(scope="session")
def tiny_graph(tiny_dataset):
    g, meta = tiny_dataset.build()
    return g, meta
