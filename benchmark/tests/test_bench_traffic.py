"""The traffic generator: one seed gives the same inputs, another seed
gives different ones; a batch is the texture's slices at the mix's slide."""
import numpy as np
import torch

from benchmark.traffic.clips import Clips, derived_seed

BIG = 2 ** 31 + 12345


def test_clips_same_for_one_seed_and_differ_across_seeds():
    a, b, c = (Clips(s, 5, 32, 48, 5) for s in (BIG, BIG, BIG + 1))
    for k, v in a.batch([3]).items():
        assert torch.equal(v, b.batch([3])[k]), k
    assert not torch.equal(a.batch([3])["voxels"], c.batch([3])["voxels"])
    assert not torch.equal(a.batch([3])["voxels"], a.batch([4])["voxels"])


def test_batch_is_the_texture_sliding_shift_px_a_frame():
    c = Clips(7, 5, 32, 48, 5, shift_px=3.0, disp=2.0)
    got = c.batch([1, 2])
    assert tuple(got["voxels"].shape) == (2, 5, 32, 48, 5)
    assert got["voxels"].is_contiguous()
    base = c.base.numpy()
    for b, item in enumerate((1, 2)):
        s = c.start(item)
        for f in range(5):
            col = (3 * (s + f)) % 48
            np.testing.assert_array_equal(got["voxels"][b, f].numpy(),
                                          base[:, col:col + 48])
        # the camera moves 3 px / (fx * disp) a frame along x
        steps = np.diff(got["poses"][b, :, 0].numpy())
        np.testing.assert_allclose(steps, -3.0 / (24.0 * 2.0), rtol=1e-6)
    assert torch.all(got["disps"] == 2.0)
    assert 0.05 < (base != 0).mean() < 0.15


def test_derived_seeds_fit_a_generator_and_differ():
    seeds = {derived_seed(BIG, k, w) for k in range(3) for w in range(4)}
    assert len(seeds) == 12 and all(0 <= s < 2 ** 63 for s in seeds)
