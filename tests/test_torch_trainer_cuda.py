"""The trainer's data parallelism over NCCL: one DistributedDataParallel
step on N cards (N = the cards present, at most 4), one sample a card,
against one process on one card with the batch of N. Skips with fewer than
two CUDA devices. Imports neither jax nor devo_tpu, so that it runs where
only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_trainer_cuda.py

Each process scales its losses by the global batch and the all-reduce sums
(train/trainer.py), so the N-card step is the one-card step up to the order
of the sums; on the card that order moves the step as far as the card
moves from the CPU (chip_smoke.TRAIN_TOL: loss terms within 1e-3 relative,
gradients within 1e-3 relative plus 1e-3 of their tensor's largest entry
plus 1e-6 of the network's largest, parameters within 2 x lr).
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.cuda

TOL = 1e-3
DIMS = dict(dim_inet=32, dim_fnet=16, dim=8)


def _batch(index):
    from devo_tpu_torch.train.__main__ import _make_batch
    from devo_tpu_torch.train.synthetic import SyntheticClips
    data = SyntheticClips(5, 64, 96)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _make_batch(data, index).items()}


def _trainer(dev):
    from devo_tpu_torch.nets.evonet import EVONet
    from devo_tpu_torch.train.trainer import Trainer
    from devo_tpu_torch.utils.params import random_state_dict
    net = EVONet(**DIMS)
    net.load_state_dict(random_state_dict(net, 0))
    return Trainer(net=net, total_steps=100, steps_unrolled=3, ppi=4,
                   grow_after=2, device=dev)


def _record(tr, m):
    return {"metrics": m, "lr0": tr.lr_at(0),
            "grads": {n: p.grad.detach().cpu().double()
                      for n, p in tr.net.named_parameters()},
            "params": {n: p.detach().cpu().double()
                       for n, p in tr.net.named_parameters()}}


def ddp_worker(rank, world, port, backend, out):
    """One process of the data-parallel step: sample `rank` of the batch,
    on card `rank` (NCCL) or the CPU (gloo); rank 0 saves the record."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        tr = _trainer(dev)
        m = tr.train_step(_batch([rank]))
        if rank == 0:
            torch.save(_record(tr, m), out)
    finally:
        dist.destroy_process_group()


def run_ddp(world, backend, out):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.start_processes(
        ddp_worker, args=(world, port, backend, out), nprocs=world,
        join=True, start_method="spawn")
    return torch.load(out, weights_only=False)


def compare(ddp, one):
    """The distances of the data-parallel record from the one-process one;
    raises beyond the tolerance."""
    m_d, m_o = ddp["metrics"], one["metrics"]
    for k in ("loss", "flow", "pose", "scores"):
        assert abs(m_d[k] - m_o[k]) <= TOL * abs(m_o[k]), k
    assert m_d["grad_nonfinite"] == m_o["grad_nonfinite"] == 0
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for name, g in one["grads"].items():
        allowed = TOL * g.abs() + TOL * float(g.abs().max()) + 1e-6 * top
        assert bool(((ddp["grads"][name] - g).abs() <= allowed).all()), name
        assert float((ddp["params"][name] - one["params"][name]).abs().max()) \
            <= 2 * one["lr0"], name


def test_ddp_over_nccl_matches_one_card(tmp_path):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    world = min(n, 4)
    ddp = run_ddp(world, "nccl", str(tmp_path / "ddp.pt"))
    tr = _trainer(torch.device("cuda", 0))
    one = _record(tr, tr.train_step(_batch(list(range(world)))))
    compare(ddp, one)
