"""The end-to-end rate: the train rate counts completed steps over their
own time."""
import pytest

from benchmark.runners.train import clips_rate


def test_clips_rate_counts_completed_steps_over_their_own_time():
    ends = [10.0 + 5.8 * k for k in range(1, 9)]         # 8 steps, 46.4 s
    assert clips_rate(10.0, ends, 51.0, 1) == pytest.approx(8 / 46.4)
    assert clips_rate(10.0, ends, 51.0, 2) == pytest.approx(16 / 46.4)


def test_a_step_cut_by_the_window_changes_nothing():
    ends = [10.0 + 5.8 * k for k in range(1, 9)]
    cut = ends + [ends[-1] + 5.8]                        # ends at 62.2 > 61
    assert clips_rate(10.0, cut, 51.0, 1) == clips_rate(10.0, ends, 51.0, 1)
    slow_cut = ends + [ends[-1] + 30.0]
    assert clips_rate(10.0, slow_cut, 51.0, 1) == clips_rate(10.0, ends, 51.0, 1)


def test_no_completed_step_is_no_rate():
    assert clips_rate(0.0, [60.0], 51.0, 1) == 0.0
