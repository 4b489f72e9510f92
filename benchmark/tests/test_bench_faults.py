"""Drive a whole training run on the CPU (the look for a card skipped)
with the timed path broken underneath, and see `correct` come out false.
Unbroken, the same run is correct."""
import time

import pytest

from benchmark import harness
from benchmark.runners import train


def _train(tiny, **kw):
    cell = harness.load_cell("tiny-train-tartan-remat", root=tiny)
    return train.run(cell, seed=5, seconds=6.0, trace=False,
                     t_process=time.monotonic(), device="cpu", **kw)


def test_unbroken_train_run_is_correct(tiny):
    out = _train(tiny)
    assert out["correct"], out["compared"]
    assert out["end_to_end"]["train_clips_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", train.FAULTS)
def test_broken_train_run_is_not_correct(tiny, fault):
    out = _train(tiny, fault=fault)
    assert not out["correct"], out["compared"]


def test_train_control_is_not_correct(tiny):
    """The training control, TF32 on, exists on the card alone."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 is a CUDA mode: this control runs on the card")
    cell = harness.load_cell("tiny-train-tartan-remat", root=tiny)
    out = train.run(cell, seed=5, seconds=1.0, trace=False,
                    t_process=time.monotonic(),
                    program=cell["workload"]["control"])
    assert not out["correct"], out["compared"]
