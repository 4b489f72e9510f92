"""Training of the port (counterpart of devo_tpu/train/): the unrolled
forward, the losses, the trainer, validation; `python -m
devo_tpu_torch.train` is the counterpart of train.py."""
