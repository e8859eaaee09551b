"""Multi-host runtime plumbing: REAL multi-process CPU runs via subprocesses.

Each test launches N python processes that call jax.distributed.initialize
(Gloo collectives between processes), build a global mesh over all
processes' devices, and run the sharded pipeline with HOST-LOCAL data
feeding — the closest exercisable analogue of a multi-host job in this
single-machine environment (SURVEY §2 required-components table, last row).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiproc_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(args, n_procs=2, timeout=300):
    port = _free_port()
    env = dict(os.environ)
    procs = []
    for i in range(n_procs):
        e = dict(
            env,
            JAX_COORDINATOR=f"localhost:{port}",
            JAX_NUM_PROCESSES=str(n_procs),
            JAX_PROCESS_ID=str(i),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, *args],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


def test_two_process_sharded_signed_field(tmp_path):
    out_npy = str(tmp_path / "mp.npy")
    outs = _launch([str(16), out_npy])
    assert any("proc 0 ok (2 procs, 8 devices)" in o for o in outs)
    got = np.load(out_npy)

    # single-process reference (this process: virtual 8-device CPU mesh)
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.ops import edt

    rng = np.random.default_rng(7)
    mask = rng.random((16, 16, 16)) < 0.1
    mask[0, 0, 0] = True
    ref, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.1, backend="stencil")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_two_process_train_step_dryrun():
    outs = _launch(["train"])
    for o in outs:
        assert "train-step ok" in o, o[-2000:]
