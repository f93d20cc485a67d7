"""REAL multi-process execution of the edge-partitioned trainer machinery
(SURVEY.md §2.3 DCN row, §M5): two OS processes form a jax.distributed
group over localhost (gloo = the CPU stand-in for pod DCN collectives),
each owning 4 of the 8 mesh devices, and run attention + partitioned CF
step + DP KG step + eval propagate with the activation exchanges crossing
the process boundary. Both processes — and the single-process 8-device
oracle — must agree on losses and the embedding fingerprint.

This upgrades the n_hosts=1 degenerate coverage of test_multihost.py to
genuine multi-process semantics: per-process shard materialization
(stack_pytrees / make_array_from_callback), cross-process collectives,
process_index-dependent local_shard_ids.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

# (subprocess timeouts below bound the test; pytest-timeout isn't installed)

_WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")
_RESULT = re.compile(
    r"RESULT pid=(\d+) nproc=(\d+) shards=(\[[^]]*\]) "
    r"cf=([-\d.]+) kg=([-\d.]+) fp=([-\d.]+)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(_WORKER))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    # The workers set their own XLA_FLAGS device count; drop any inherited
    # one so it can't double up.
    env.pop("XLA_FLAGS", None)
    return env


def _run(pid: int, nproc: int, port: int, ndev: int = 8
         ) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(nproc), str(port),
         str(ndev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())


def _communicate(proc: subprocess.Popen) -> str:
    try:
        return proc.communicate(timeout=540)[0]
    except subprocess.TimeoutExpired:
        proc.kill()  # exact PID we started
        return proc.communicate()[0] + "\n<killed: timeout>"


def _parse(out: str):
    m = _RESULT.search(out)
    assert m, f"no RESULT line in worker output:\n{out[-3000:]}"
    return (m.group(3), float(m.group(4)), float(m.group(5)),
            float(m.group(6)))


def test_two_process_partitioned_training_matches_single():
    port = _free_port()
    workers = [_run(p, 2, port) for p in range(2)]
    outs = [_communicate(w) for w in workers]
    for w, o in zip(workers, outs):
        assert w.returncode == 0, f"worker failed:\n{o[-3000:]}"
    (sh0, cf0, kg0, fp0), (sh1, cf1, kg1, fp1) = map(_parse, outs)
    # each process owns its own half of the shards
    assert sh0 == "[0, 1, 2, 3]" and sh1 == "[4, 5, 6, 7]"
    # replicated results agree across the process group
    assert cf0 == pytest.approx(cf1, abs=1e-6)
    assert kg0 == pytest.approx(kg1, abs=1e-6)
    assert fp0 == pytest.approx(fp1, rel=1e-6)

    # single-process 8-device oracle: same program, no process group
    oracle = _run(0, 1, port)
    out = _communicate(oracle)
    assert oracle.returncode == 0, f"oracle failed:\n{out[-3000:]}"
    _, cf_s, kg_s, fp_s = _parse(out)
    assert cf0 == pytest.approx(cf_s, abs=1e-5)
    assert kg0 == pytest.approx(kg_s, abs=1e-5)
    assert fp0 == pytest.approx(fp_s, rel=1e-5)


def test_two_process_train_cli(tmp_path):
    """The FULL train CLI on a real 2-process group: process-group
    formation precedes any device access (main() calls
    initialize_distributed first), only process 0 writes the event log,
    checkpoints save as per-host shards, and training completes with a
    done event. This is the coverage mp_worker cannot give: eval,
    logging, early-stop bookkeeping, and checkpointing under
    multi-process semantics."""
    port = _free_port()
    env_base = _env()
    env_base.update({
        "JAX_PLATFORM_NAME": "cpu", "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "COORDINATOR_ADDRESS": f"localhost:{port}",
        "NUM_PROCESSES": "2",
    })
    args = [sys.executable, "-m", "kgat_tpu.train",
            "--dataset", "synthetic",
            "--epochs", "2", "--eval-every", "2",
            "--log-dir", str(tmp_path), "--run-name", "cli2p"]
    procs = []
    for pid in range(2):
        env = dict(env_base, PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env))
    outs = [_communicate(p) for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"CLI worker failed:\n{o[-3000:]}"

    log = tmp_path / "cli2p.jsonl"
    assert log.exists()
    events = [l.split('"event": "')[1].split('"')[0]
              for l in log.read_text().splitlines()]
    assert events.count("start") == 1  # only process 0 logs
    assert events.count("done") == 1
    assert "epoch" in events and "eval" in events
    # per-host sharded checkpoint: both processes wrote their shards
    shards = sorted(str(f.name) for f in tmp_path.glob("cli2p_best*shard*"))
    assert any("shard0" in s for s in shards), shards
    assert any("shard1" in s for s in shards), shards

    # resume: the sharded checkpoint reassembles across the (new) process
    # group and training continues from epoch 2
    port2 = _free_port()
    env_base["COORDINATOR_ADDRESS"] = f"localhost:{port2}"
    procs = []
    for pid in range(2):
        env = dict(env_base, PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            args[:-4] + ["--epochs", "4", "--resume",
                         "--log-dir", str(tmp_path), "--run-name", "cli2p"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs = [_communicate(p) for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"resume worker failed:\n{o[-3000:]}"
    text = log.read_text()
    assert '"event": "resume"' in text
    events = [l.split('"event": "')[1].split('"')[0]
              for l in text.splitlines()]
    assert events.count("done") == 2
