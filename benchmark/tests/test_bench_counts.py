"""The yardstick's FLOP counts against hand counts at small shapes."""
from benchmark.yardstick import flops


def test_update_flops_per_edge_by_hand():
    d, corr = 16, 2 * 49 * 9
    # corr: corr->d, d->d, d->d; c1, c2: 2 each; two SoftAggs: 3 each;
    # two GatedResiduals: 3 each; the two heads d->2
    linear = corr * d + 2 * d * d + 4 * d * d + 6 * d * d + 6 * d * d + 2 * 2 * d
    assert flops.update_flops_per_edge(d, 3) == 2 * linear


def test_patchify_flops_by_hand():
    ht, wd, b, di, df, dim = 32, 32, 5, 8, 8, 4

    def encoder(out):
        h1, h2 = ht // 2, ht // 4
        c = 2 * b * dim * 49 * h1 * h1                   # conv1 7x7 stride 2
        c += 4 * 2 * dim * dim * 9 * h1 * h1             # layer1: 4 convs
        c += 2 * dim * 2 * dim * 9 * h2 * h2             # layer2 strided 3x3
        c += 3 * 2 * (2 * dim) ** 2 * 9 * h2 * h2        # its 3 other 3x3s
        c += 2 * dim * 2 * dim * h2 * h2                 # its 1x1 downsample
        c += 2 * 2 * dim * out * h2 * h2                 # conv2 1x1
        return c

    def scorer():
        c, h, cin = 0, ht, b
        for cout in (8, 16, 32, 1):
            h -= 2
            c += 2 * cin * cout * 9 * h * h
            cin = cout
        return c

    got = flops.patchify_flops(ht, wd, b, di, df, dim, scorer=True)
    assert got == encoder(df) + encoder(di) + scorer()


def test_corr_and_ba_flops_per_edge_by_hand():
    # each level and patch pixel: 8 x 8 window dot products of C channels,
    # then 7 x 7 taps of 4 products and 3 sums
    assert flops.corr_flops_per_edge(3, 128, 2) == 2 * 9 * (64 * 2 * 128 + 49 * 7)
    # two Gauss-Newton iterations of a 2 x 13 Jacobian: 13 x 13 + 13
    # multiply-adds a row
    assert flops.ba_flops_per_edge(2) == 2 * 2 * 2 * (169 + 13)
