"""Training-stability run (counterpart of scripts/train_stability.py): N
optimizer steps, each step's loss and grad_nonfinite, then the verdict.

    python -m devo_tpu_torch.scripts.train_stability [--steps 100]

PASS iff grad_nonfinite is 0 on every step and the mean loss of the last
10% of the full-loss steps is below that of their first 10%. The first 10%
of the steps run structure-only (as the first 1000 of a real run), whose
loss leaves the pose terms out, so the comparison stays inside the
full-loss phase. The schedule's total is the run's length, so that the run
crosses the warmup and the anneal. Defaults: small dims on synthetic clips
of the bench's sliding texture (train/synthetic.py); `run` takes any
TartanAirEVS-like dataset.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.train.__main__ import _make_batch
from devo_tpu_torch.train.synthetic import SyntheticClips
from devo_tpu_torch.train.trainer import Trainer
from devo_tpu_torch.utils.params import random_state_dict

from . import common


def verdict(losses, nonfinite, warm: int) -> dict:
    """The PASS rule over per-step losses and grad_nonfinite counts, the
    first `warm` steps structure-only."""
    full = losses[warm:]
    k = max(len(full) // 10, 1)
    head = float(np.mean(full[:k]))
    tail = float(np.mean(full[-k:]))
    total = int(sum(nonfinite))
    return {"grad_nonfinite_total": total, "fullphase_head": head,
            "fullphase_tail": tail, "pass": total == 0 and tail < head}


def run(dataset, device=None, steps: int = 100, lr: float = 8e-5,
        dim_inet: int = 64, dim_fnet: int = 32, dim: int = 8, iters: int = 4,
        ppi: int = 8, grow_after: int = 2, log=print) -> dict:
    """`steps` optimizer steps from seeded random weights on items drawn
    from `dataset` by a seeded generator. Returns the verdict with the
    per-step record."""
    from devo_tpu_torch.runtime.engine import resolve_device
    dev = resolve_device(device)
    net = EVONet(dim_inet=dim_inet, dim_fnet=dim_fnet, dim=dim)
    net.load_state_dict(random_state_dict(net, 0))
    tr = Trainer(net=net, lr=lr, total_steps=steps, steps_unrolled=iters,
                 ppi=ppi, grow_after=grow_after, device=dev)
    rng = np.random.default_rng(0)
    warm = max(steps // 10, 1)
    losses, nonfinite = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        items = _make_batch(dataset, rng.integers(0, len(dataset), 1))
        b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in items.items()}
        m = tr.train_step(b, structure_only=step < warm)
        losses.append(m["loss"])
        nonfinite.append(m["grad_nonfinite"])
        if log is not None:
            log(f"step {step:4d}  loss {m['loss']:9.4f}  grad_nonfinite "
                f"{m['grad_nonfinite']}  ({time.perf_counter() - t0:.1f} s)")
    out = verdict(losses, nonfinite, warm)
    out.update(steps=steps, warm=warm, wall_s=time.perf_counter() - t0,
               losses=losses)
    return out


def main(argv=None):
    p = common.parser("Training-stability run (see the module's docstring).")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=8e-5)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--n_frames", type=int, default=5)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--ppi", type=int, default=8)
    p.add_argument("--dims", type=int, nargs=3, default=(64, 32, 8),
                   metavar=("DIM_INET", "DIM_FNET", "DIM"))
    args = p.parse_args(argv)
    dev = common.device(args)
    data = SyntheticClips(args.n_frames, args.height, args.width)
    out = run(data, dev, steps=args.steps, lr=args.lr, dim_inet=args.dims[0],
              dim_fnet=args.dims[1], dim=args.dims[2], iters=args.iters,
              ppi=args.ppi)
    out["card"] = common.card(dev)
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}),
          flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
