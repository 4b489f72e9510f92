"""The whole step's share of the card's f32 peak without TF32 (67
TFLOP/s): a step's model FLOPs, forward and backward (3 x the forward,
counted from shapes: yardstick/flops.train_step_flops), times the traced
run's completed steps a second."""
from benchmark.yardstick.flops import PEAK_F32

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "whole step", "train_clips_per_s"


def read(trace):
    if trace.get("kind") != "train" or not trace["busy_s"]:
        return None
    return 100.0 * trace["step_flops"] * trace["steps_per_s"] / PEAK_F32
