"""The port's drivers and offline scripts, each the counterpart of a script
of the same name in scripts/, run with `python -m
devo_tpu_torch.scripts.<name>`: the probe and profiling drivers (on the
card unless given `--device cpu`), and the host-side dataset tools
(pp_*.py, convert_tartan, e2v_undist, evaluate_rpe,
compute_median_from_restxt, orb3_pp_eds, orb3_eval, plot_h5), with their
originals' arguments and outputs."""
