"""Probe and profiling drivers of the port, each the counterpart of a
TPU-era script of the same name in scripts/: run with
`python -m devo_tpu_torch.scripts.<name>` (on the card unless given
`--device cpu`)."""
