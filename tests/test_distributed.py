"""Multi-host path (SURVEY.md §2.5 P6): 2 real processes, gloo collectives.

Spawns two cooperating JAX processes (2 virtual CPU devices each — a 4-device
global mesh), runs the distributed encode+decode over process-spanning
arrays, and checks the payload bytes are identical to the single-process
encoder's (the format invariant: sharding is purely a throughput decision).
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.mark.slow
def test_two_process_encode_decode(tmp_path):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_CPU_COLLECTIVES_IMPLEMENTATION="gloo",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    worker = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
    port = "12431"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), port, str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (
            f"worker failed:\n{so.decode()[-2000:]}\n{se.decode()[-2000:]}"
        )

    # single-process reference payloads (bit-identical format invariant)
    sys.path.insert(0, env["PYTHONPATH"])
    from comprox_tpu.codec.block import encode_block

    from tests._dist_worker import corpus_and_params

    data, p = corpus_and_params()
    cap = p.capacity
    nblk = -(-data.size // cap)
    ref = b"".join(
        encode_block(data[b * cap : (b + 1) * cap], p) for b in range(nblk)
    )
    expect = hashlib.sha256(ref).hexdigest()
    got = (tmp_path / "hash.txt").read_text()
    assert got == expect, "distributed payloads differ from single-process"
