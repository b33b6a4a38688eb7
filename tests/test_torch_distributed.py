# SPDX-License-Identifier: CECILL-2.1
"""Multi-process wiring of the port: ``parallel.init_distributed`` over a
real 2-process job (counterpart of ``tests/test_distributed.py``).

Two OS processes rendezvous through ``tcp://127.0.0.1:<port>`` with the
``gloo`` backend (no card). Each runs its half of the frames through
``run_stack_program`` on a local two-entry CPU mesh, and one ``all_reduce``
gives the global mean, held against the whole stack's. As in the JAX
package, this is wiring only: no stack pipeline spans processes.

Skips (with the reason) when the runner forbids localhost sockets or the
rendezvous cannot complete.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    port, pid = sys.argv[1], int(sys.argv[2])

    from barc4dip_tpu_torch.metrics.common import run_stack_program
    from barc4dip_tpu_torch.parallel import frame_mesh, init_distributed

    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert dist.is_initialized() and dist.get_world_size() == 2, dist.get_world_size()
    assert dist.get_rank() == pid and dist.get_backend() == "gloo"

    frames = np.arange(2 * 4 * 8 * 8, dtype=np.float64).reshape(8, 8, 8)
    mine = frames[4 * pid : 4 * (pid + 1)]
    local = frame_mesh(["cpu", "cpu"])
    per_frame = run_stack_program(mine, lambda x: {"m": x.mean((-2, -1))}, frame_chunk=2,
                                  mesh=local, device="cpu")["m"]
    np.testing.assert_allclose(per_frame, mine.mean((1, 2)), rtol=1e-12)
    total = torch.tensor(per_frame.sum())
    dist.all_reduce(total)
    np.testing.assert_allclose(float(total) / 8, frames.mean(), rtol=1e-12)
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"WORKER_OK pid={pid} world=2")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_two_process_mesh(tmp_path):
    # bounded by the 150 s communicate() timeout below
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover - locked-down runner
        pytest.skip(f"runner forbids localhost sockets: {e}")

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""  # the CPU process group, gloo

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.skip(
            "2-process rendezvous did not complete in 150s — runner likely "
            "blocks the localhost rendezvous socket"
        )

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "WORKER_OK" in out, out[-3000:]


def test_init_distributed_arguments(monkeypatch):
    """The address becomes ``tcp://host:port`` (kept where it names a
    scheme), the backend is gloo without a card and nccl with one, and an
    argument left out is read from the environment."""
    import torch
    import torch.distributed as dist

    from barc4dip_tpu_torch.parallel import init_distributed

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_distributed("10.0.0.1:1234", 4, 2)
    init_distributed("tcp://h:9", 2, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    init_distributed()
    assert seen == [
        ("gloo", dict(init_method="tcp://10.0.0.1:1234", world_size=4, rank=2)),
        ("gloo", dict(init_method="tcp://h:9", world_size=2, rank=0)),
        ("nccl", dict(init_method="env://", world_size=3, rank=1)),
    ]
