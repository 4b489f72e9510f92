"""yardstick/spans.py: kernels given to the innermost span open at their
launch, "(none)" outside every span, the spans' sums equal to the busy
time, the idle gaps named by the host's span, the layer readings of a
trace, and the tiny cell's profiled steps with the tracer off and on."""
import json

import pytest

from benchmark.yardstick import spans as sp
from benchmark.yardstick import trace as tt
from devo_tpu_torch.utils.timing import Span

# a step: root [0, 1000); under it corr [100, 300) and, opened later on
# another thread, corr.bwd [200, 400) (as deep: the later opened wins);
# leaf [150, 250) under corr; update [500, 700) marked recompute
SPANS = [Span(0, None, 3, 1, "train.step", 0, 1000, {"step": 3}),
         Span(1, 0, 3, 1, "train.corr", 100, 300, {}),
         Span(2, 0, 3, 2, "train.corr.bwd", 200, 400, {}),
         Span(3, 1, 3, 1, "leaf", 150, 250, {}),
         Span(4, 0, 3, 1, "train.update", 500, 700, {"recompute": True})]


@pytest.mark.parametrize("t, name", [
    (50, "train.step"), (120, "train.corr"), (160, "leaf"), (240, "leaf"),
    (260, "train.corr.bwd"), (350, "train.corr.bwd"), (450, "train.step"),
    (600, "train.update (recompute)"), (1000, "(none)"), (-5, "(none)")])
def test_the_innermost_span_owns_a_time(t, name):
    assert sp.key(sp.owner(sp.timeline(SPANS), t)) == name


def test_kernels_go_to_their_launchs_span_and_sum_to_busy():
    # (start, end, correlation id): launched at 160 (leaf), at 350
    # (corr.bwd), at 600 (update), at 1500 (none); the last has no launch
    # and is placed by its start, 2000 (none); 7 overlaps 5 by 50 ns
    kernels = [(400, 500, 5), (450, 600, 7), (900, 950, 8),
               (1600, 1700, 9), (2000, 2100, 10)]
    launches = {5: 160, 7: 350, 8: 600, 9: 1500}
    got = sp.attribute(SPANS, kernels, launches)
    assert got["by_launch"] == 4 and got["by_start"] == 1
    dev = {k: round(v * 1e9) for k, v in got["dev_s"].items()}
    assert dev == {"leaf": 100, "train.corr.bwd": 100,
                   "train.update (recompute)": 50, "(none)": 200}
    busy = tt.merge([(s, e) for s, e, _ in kernels])
    assert sum(got["dev_s"].values()) == pytest.approx(
        sum(e - s for s, e in busy) / 1e9, rel=1e-12)


def test_idle_gaps_are_named_by_the_hosts_span():
    summary = {"busy": [(0, 100), (180, 220), (600, 650), (1200, 1300)],
               "kernels": {"k": [1e-7, 4]},
               "starts": [(0, "k_a"), (180, "k_b" * 40), (600, "k_c"),
                          (1200, "k_d")]}
    bd = tt.breakdown(summary)
    named = sp.name_gaps(summary, bd, SPANS)
    assert named["device_ops"] == bd["device_ops"]
    # by length: [650, 1200), its midpoint 925 in train.step alone;
    # [220, 600), 410, train.step (corr.bwd closed at 400); [100, 180),
    # 140, train.corr (leaf opens at 150)
    assert [n for n, _ in named["idle_gaps"]] == [
        "train.step: before k_d", "train.step: before k_c",
        ("train.corr: before " + ("k_b" * 40)[:57])[:64]]
    assert [s for _, s in named["idle_gaps"]] == [s for _, s in bd["idle_gaps"]]
    assert all(len(n) <= 64 for n, _ in named["idle_gaps"])


def test_gap_detail_places_each_gap_and_its_runtime_calls():
    busy = [(0, 100), (180, 220), (600, 650), (1200, 1300)]
    runtime = [(150, 190, "cudaLaunchKernel"), (700, 900, "cudaMemcpyAsync"),
               (1150, 1250, "cudaMalloc"), (1260, 1270, "cudaLaunchKernel")]
    got = sp.gap_detail(busy, SPANS, runtime, t0=-100)
    assert [(round(g["s"] * 1e9), round(g["at_s"] * 1e9), g["spans"])
            for g in got] == [(550, 750, "train.step"),
                              (380, 320, "train.step"),
                              (80, 200, "train.step/train.corr")]
    assert [{k: (n, round(v * 1e9)) for k, (n, v) in g["calls"].items()}
            for g in got] == [{"cudaMemcpyAsync": (1, 200), "cudaMalloc": (1, 50)},
                              {}, {"cudaLaunchKernel": (1, 30)}]
    it = [Span(0, None, 1, 1, "train.step", 0, 100, {"step": 1}),
          Span(1, 0, 1, 1, "train.iter", 10, 90, {"s": 2}),
          Span(2, 1, 1, 1, "train.ba", 20, 30, {"recompute": True})]
    by_id = {s.id: s for s in it}
    assert sp.path(it[2], by_id) == (
        "train.step/train.iter[s=2]/train.ba (recompute)")
    assert sp.path(None, by_id) == "(none)"


def test_layers_read_a_trace():
    trace = {"span_dev_s": {"train.corr": 0.5, "train.corr (recompute)": 0.25,
                            "train.corr.bwd": 0.75, "train.update": 0.1,
                            "train.update (recompute)": 0.1, "train.ba": 0.2,
                            "(none)": 0.05},
             "span_host_s": {"train.optimizer": 0.04},
             "counts": {"host_waits": 346}, "steps_profiled": 2}
    got = sp.layers(trace)
    assert got == pytest.approx({
        "corr_dev_ms.train": 750.0, "update_dev_ms.train": 100.0,
        "ba_dev_ms.train": 100.0, "optimizer_ms.train": 20.0,
        "host_waits_per_step.train": 173.0})
    assert sp.layers({"kind": "train", "busy_s": 1.0}) == {}


def test_tiny_cell_profiled_with_the_tracer_off_and_on(tiny, capsys):
    assert sp.main(["--workload", "tiny-train-tartan-remat", "--seed",
                    "2200000099", "--steps", "1", "--device", "cpu",
                    "--root", str(tiny)]) == 0
    off, on = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert not off["traced"] and on["traced"] and on["n_spans"] > 20
    assert set(on["layers"]) == {
        "corr_dev_ms.train", "update_dev_ms.train", "ba_dev_ms.train",
        "optimizer_ms.train", "host_waits_per_step.train"}
    assert on["layers"]["optimizer_ms.train"] > 0
    assert on["layers"]["host_waits_per_step.train"] == on["counts"][
        "host_waits"] > 0
    assert on["span_host_s"]["train.step"] > 0
    # the CPU's profile has no device: no kernel to place
    assert on["n_kernels"] == off["n_kernels"] == 0 and on["span_dev_s"] == {}
    assert on["gaps"] == off["gaps"] == []
