"""Device kernels one train step runs (torch.profiler over one step)."""
UNIT, BETTER, SOURCE = "kernels/step", "lower", "device_trace"
LAYER, MOVES = "trainer (train/forward.py, train/trainer.py, ops/corr.corr_pyramid_train)", "train_clips_per_s"


def read(trace):
    if trace.get("kind") != "train" or not trace["n_kernels"]:
        return None
    return trace["n_kernels"] / trace["steps_profiled"]
