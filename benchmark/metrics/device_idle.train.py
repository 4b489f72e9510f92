"""The card's idle share over the profiled step: 1 - (the union of its
kernel intervals) / (the step's wall time)."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device (H100)", "train_clips_per_s"


def read(trace):
    if trace.get("kind") != "train" or trace["window_s"] <= 0 or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
