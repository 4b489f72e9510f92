"""The frozen reference equals the port's plain path at a small size on
the CPU: the train step."""
import torch

from benchmark import harness
from benchmark.runners import train


def test_reference_trainer_equals_the_ports(tiny):
    from devo_tpu_torch.nets import evonet as p_evonet
    from devo_tpu_torch.train import trainer as p_trainer

    from benchmark.reference.nets import evonet as r_evonet
    from benchmark.reference.train import trainer as r_trainer
    torch.set_num_threads(1)
    cell = harness.load_cell("tiny-train-tartan-remat", root=tiny)
    cfg = cell["config"]["train"]
    clips = train.clips_of(cell, 3, "cpu")
    wts = train.weights_of(cell, 3, "cpu")
    got = []
    for ev, trm, remat in ((p_evonet, p_trainer, True),
                           (r_evonet, r_trainer, False)):
        tr = train._trainer(ev, trm, cfg, wts, torch.device("cpu"), remat)
        grad1 = {}
        losses = train.drive(tr, clips, range(2), torch.device("cpu"),
                             lambda: grad1.update(train.first_grad(tr)))
        got.append(train.readings(tr, wts, losses, grad1))
    gaps = train.compare(*got)
    assert gaps["loss"] < 1e-6 and gaps["grad"] < 1e-5 and gaps["change"] < 1e-5
