"""The JAX package's multi-host rendezvous in the port
(parallel/mesh.py:initialize_distributed).

A process launched as the JAX CLIs are launched, with only
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID in its environment, joins
one group with the others, as tests/test_multihost.py shows for the JAX
package: two gloo processes on the CPU here, each run as this file's
`worker`. The precedence of arguments over the environment (with JAX's
`process_id or ...` quirk, and torchrun's variables before JAX's), the no-op
without either, and the ranks tools.train spawns on a host of several cards
are checked in this process, on the arguments the join would be given.

    python tests/test_torch_rendezvous.py   (one rank; the test starts two)
"""

import datetime
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker():
    """One rank: join from the environment, sum the ranks' ids + 1, print."""
    import torch.distributed as dist

    from yololp_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    assert mesh.initialize_distributed("gloo", datetime.timedelta(seconds=TIMEOUT_S))
    total = mesh.global_sum(torch.tensor([float(mesh.rank() + 1)]))
    print(f"RANK {mesh.rank()} WORLD {mesh.world_size()} SUM {float(total[0])}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def test_two_processes_join_on_the_jax_variables_alone():
    base = {k: v for k, v in os.environ.items() if k not in JAX_VARS + TORCHRUN_VARS}
    base.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=dict(base, COORDINATOR_ADDRESS=coordinator, NUM_PROCESSES="2", PROCESS_ID=str(r)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=2 * TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}\n{out[-3000:]}"
        assert f"RANK {r} WORLD 2 SUM 3.0" in out, out[-3000:]


@pytest.fixture
def joins(monkeypatch):
    """The keyword arguments of each init_process_group call, made a no-op."""
    from yololp_tpu_torch.parallel import mesh

    for k in JAX_VARS + TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_arguments_override_the_environment(joins, monkeypatch):
    from yololp_tpu_torch.parallel import mesh

    # neither arguments nor variables: one process, nothing joined
    assert mesh.initialize_distributed(backend="gloo") is False and not joins
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1111")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert mesh.initialize_distributed(backend="gloo")
    assert mesh.initialize_distributed("gloo", coordinator="127.0.0.1:2222", num_processes=2,
                                       process_id=1)
    # JAX's `process_id or env`: an explicit 0 is falsy and takes the variable
    mesh.initialize_distributed("gloo", coordinator="127.0.0.1:2222", num_processes=2,
                                process_id=0)
    # torchrun's per-process variables come before a host-wide
    # COORDINATOR_ADDRESS; an explicit coordinator still comes first
    monkeypatch.setenv("WORLD_SIZE", "8")
    mesh.initialize_distributed(backend="gloo", timeout=datetime.timedelta(seconds=5))
    mesh.initialize_distributed("gloo", coordinator="127.0.0.1:2222", num_processes=2,
                                process_id=1)
    assert joins == [
        {"backend": "gloo", "init_method": "tcp://127.0.0.1:1111", "world_size": 4, "rank": 3},
        {"backend": "gloo", "init_method": "tcp://127.0.0.1:2222", "world_size": 2, "rank": 1},
        {"backend": "gloo", "init_method": "tcp://127.0.0.1:2222", "world_size": 2, "rank": 3},
        {"backend": "gloo", "init_method": "env://", "timeout": datetime.timedelta(seconds=5)},
        {"backend": "gloo", "init_method": "tcp://127.0.0.1:2222", "world_size": 2, "rank": 1}]
    with pytest.raises(ValueError, match="host:port"):
        mesh.initialize_distributed("gloo", coordinator="127.0.0.1")
    # a coordinator given where the backend goes
    with pytest.raises(ValueError, match="coordinator="):
        mesh.initialize_distributed("127.0.0.1:2222")
    assert len(joins) == 5


@pytest.mark.parametrize("launch, first_rank, world, addr", [
    ({}, 0, 2, "localhost"),
    ({"COORDINATOR_ADDRESS": "host0:29500", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
     2, 4, "host0"),
], ids=["one_host", "jax_host_1_of_2"])
def test_train_spawns_one_rank_a_card(joins, monkeypatch, launch, first_rank, world, addr):
    """tools.train on a host that shows 2 cards spawns one rank per card;
    launched as the JAX CLI is (one process a host), host h's cards are the
    ranks 2h and 2h + 1 of 2 * NUM_PROCESSES, met at the coordinator, and the
    children see torchrun's variables and none of JAX's. Each child here is
    main's stand-in: it records its environment and joins, made a no-op."""
    from unittest import mock

    from yololp_tpu_torch.parallel import mesh
    from yololp_tpu_torch.tools import train
    from yololp_tpu_torch.utils import device

    for k, v in launch.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(device, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    children = []

    def child_main(argv):
        children.append({k: os.environ.get(k) for k in JAX_VARS + TORCHRUN_VARS})
        assert mesh.initialize_distributed("gloo")

    def spawn(fn, args, nprocs):
        for i in range(nprocs):
            with mock.patch.dict(os.environ):
                fn(i, *args)

    monkeypatch.setattr(torch.multiprocessing, "spawn", spawn)
    parent_main = train.main
    monkeypatch.setattr(train, "main", child_main)
    # the global batch is split over every host's cards
    with pytest.raises(SystemExit):
        parent_main(["--synthetic-data", "--batch-size", str(2 * world + 1)])
    assert not children
    assert parent_main(["--synthetic-data", "--batch-size", str(2 * world)]) is None
    port = children[0]["MASTER_PORT"]
    assert launch.get("COORDINATOR_ADDRESS", f"localhost:{port}") == f"{addr}:{port}"
    assert children == [
        {"COORDINATOR_ADDRESS": None, "NUM_PROCESSES": None, "PROCESS_ID": None,
         "RANK": str(first_rank + i), "WORLD_SIZE": str(world), "LOCAL_RANK": str(i),
         "MASTER_ADDR": addr, "MASTER_PORT": port} for i in range(2)]
    assert joins == [{"backend": "gloo", "init_method": "env://"}] * 2
    assert {k: os.environ.get(k) for k in JAX_VARS} == {k: launch.get(k) for k in JAX_VARS}


if __name__ == "__main__":
    worker()
