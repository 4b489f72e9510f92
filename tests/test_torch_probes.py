"""Port parity for the three probe kernels and their drivers.

The plain versions (devo_tpu_torch/ops/probe.py) against the TPU-era probe
scripts' Pallas kernels, which these tests load from scripts/ through
importlib (the scripts are not a package, and are not edited):

- K13, scripts/bench_banded_ablate.py `make_kernel(mode)`: wrapped in this
  test's own PrefetchScalarGridSpec, built as the script's `build` builds
  it, at E = 128 (two blocks of 64 edges, the second gated off by
  nlive = 64) on a (3, 2, 24, 24, 128) bf16 ring, in interpret mode. Two
  reads of that kernel are undefined (unwritten scratch): the strip columns
  at or past 24 (rx = 2), and the whole "noDMA" window. Those compare to
  the port's definition: 0.
- K15, scripts/bench_gather.py `mk_kernel`: the script's main() at E = 128,
  T = 64, with its timing chain replaced by one that records each call, in
  interpret mode; the kernel's offsets are rebuilt by repeating the
  script's draws in order.
- K14, scripts/probe_desc_wall.py `kernel` / `kernel_ns`: closures over
  9600 copies, too slow to interpret; the plain version is held against a
  numpy restatement of the kernel body, line by line, exactly.

Tolerances: the products are f32 sums of 128 bf16 products taken in
another order, atol 2e-4 + rtol 1e-4 (outputs up to ~0.3 in K13, ~55 in
K15); window values and integer sums exactly.

Then each driver of devo_tpu_torch/scripts/ runs its main() on the CPU at a
tiny size (the plain versions), and each refusal is checked: a bad kernel
name, a dropped TPU knob, a mode the card cannot hold. The kernels
themselves run on the card: tests/test_torch_probe_cuda.py and
chip_smoke.py.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from devo_tpu_torch.ops import probe, probe_cuda

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-4, rtol=1e-4)
SMALL = ["--set", "BUFFER_SIZE=64", "--set", "PATCHES_PER_FRAME=4",
         "--set", "PATCH_LIFETIME=5", "--set", "REMOVAL_WINDOW=9",
         "--set", "OPTIMIZATION_WINDOW=4", "--set", "MEM=16",
         "--set", "DIM_INET=32", "--set", "DIM_FNET=16", "--set", "DIM=8",
         "--set", "MIXED_PRECISION=False", "--size", "64", "64"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several xdist workers share the machine: one intra-op thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, shape, scale=1.0):
    """Values that bf16 holds exactly, as f32 numpy and as torch bf16."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32)).bfloat16()
    return t.float().numpy(), t


# ---------------------------------------------------------------- K13

E13 = 128


@pytest.fixture(scope="module")
def ablate_case():
    rng = np.random.default_rng(0)
    ring_np, ring = _bf16(rng, (3, 2, 24, probe.BWIN, 128), 0.1)
    g_np, g = _bf16(rng, (E13, 16, 128), 0.1)
    ry = rng.integers(0, 8, (E13, 16)).astype(np.int32)
    rx = rng.integers(0, 3, (E13, 16)).astype(np.int32)
    slot = rng.integers(0, 3, E13).astype(np.int32)
    band = rng.integers(0, 2, E13).astype(np.int32)
    y0 = rng.integers(0, 24 - probe.WIN, E13).astype(np.int32)
    nlive = np.asarray([64], np.int32)
    jx = (nlive, slot, band, y0, g_np, ry, rx, ring_np)
    pt = (torch.from_numpy(nlive), torch.from_numpy(slot),
          torch.from_numpy(band), torch.from_numpy(y0), g, torch.from_numpy(ry),
          torch.from_numpy(rx), ring)
    return _script("bench_banded_ablate"), jx, pt


def _ablate_jax(mod, mode, nlive, slot, band, y0, g, ry, rx, ring):
    """The script's kernel under a grid spec built as its `build`
    (scripts/bench_banded_ablate.py:88-111), at this test's E."""
    E, C = g.shape[0], g.shape[-1]
    BE, PP = mod.BE, mod.PP
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4,
        grid=(E // BE,),
        in_specs=[
            pl.BlockSpec((BE, 16, C), lambda b, *_: (b, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((BE, 16), lambda b, *_: (b, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((BE, 16), lambda b, *_: (b, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((BE, 8, 16 * PP), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((mod.K, mod.WIN, mod.BWIN, C), jnp.bfloat16)]
        + [pltpu.VMEM((mod.WIN, mod.BWIN + 8, 16), jnp.float32)
           for _ in range(4)]
        + [pltpu.SemaphoreType.DMA((mod.K,))],
    )
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            mod.make_kernel(mode), grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((E, 8, 16 * PP), jnp.float32),
        )(jnp.asarray(nlive), jnp.asarray(slot), jnp.asarray(band),
          jnp.asarray(y0), jnp.asarray(g, jnp.bfloat16), jnp.asarray(ry),
          jnp.asarray(rx), jnp.asarray(ring, jnp.bfloat16))
    return np.asarray(out)


def _strip_defined(rx):
    """(E, 8, 144) bool: the strip entries whose column 8 rx + c lies inside
    the 24 columns the TPU kernel wrote."""
    c = np.arange(16)
    inside = (8 * rx[:, :probe.PP, None] + c) < probe.BWIN         # (E, PP, 16)
    return np.broadcast_to(inside.reshape(rx.shape[0], 1, -1),
                           (rx.shape[0], 8, 16 * probe.PP))


@pytest.mark.parametrize("mode", probe.ABLATE_MODES)
def test_band_ablate_matches_the_tpu_kernel(ablate_case, mode):
    mod, jx, pt = ablate_case
    want = _ablate_jax(mod, mode, *jx)[:64]        # the live block
    got = probe.band_ablate(*pt, mode=mode).numpy()
    assert not got[64:].any()                      # the gated block: 0 here
    got = got[:64]
    if mode == "noDMA":
        # undefined on the TPU (a window scratch nothing writes), 0 here
        assert not np.isfinite(want).any()
        assert not got.any()
    elif mode == "nomm":
        np.testing.assert_array_equal(got, want)
    elif mode == "noext":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        defined = _strip_defined(jx[6][:64])
        assert (~defined).any() and not np.isfinite(want[~defined]).all()
        np.testing.assert_allclose(got[defined], want[defined], **TOL)
        assert not got[~defined].any()


def test_band_ablate_wrapper_on_the_cpu(ablate_case):
    """On CPU tensors the wrapper is the plain version; the mode is checked
    on either device."""
    _, _, pt = ablate_case
    np.testing.assert_array_equal(probe_cuda.band_ablate_cuda(*pt, "noext").numpy(),
                                  probe.band_ablate(*pt, "noext").numpy())
    with pytest.raises(ValueError, match="mode"):
        probe_cuda.band_ablate_cuda(*pt, "nodma")
    assert probe_cuda.window_depth() == 2


# ---------------------------------------------------------------- K15

@pytest.fixture(scope="module")
def gather_runs():
    """The script's main() at E = 128, T = 64: its kernel calls by name."""
    mod = _script("bench_gather")
    mod.E, mod.T = 128, 64
    mod.rng = np.random.default_rng(0)
    calls = {}

    def record(fn, args, iters=8, name=""):
        calls[name] = (args, np.asarray(fn(*args)))
        return 1.0

    mod.chain = record
    with pltpu.force_tpu_interpret_mode():
        mod.main()
    return mod, calls


def _gather_inputs(E, T):
    """The kernel's inputs, by repeating the script's draws in order
    (scripts/bench_gather.py:33-37, 67-72)."""
    rng = np.random.default_rng(0)
    rng.standard_normal((T, 384))
    rng.standard_normal((T, 27))
    rng.standard_normal((32, 7))
    rng.integers(0, T, E)
    rng.integers(0, 32, E)
    fmap = rng.standard_normal((144, 184, 128))
    gm = rng.standard_normal((E, 16, 128))
    y0 = rng.integers(0, 144 - 16, (E, 1))
    x08 = rng.integers(0, (184 - 24) // 8, (E, 1))
    ry = rng.integers(0, 9, (E, 16))
    rx8 = rng.integers(0, 2, (E, 16))
    return fmap, gm, y0, x08, ry, rx8


@pytest.mark.parametrize("extract,nsc", [(True, 1), (True, 4), (False, 1)])
def test_frame_windows_match_the_tpu_kernel(gather_runs, extract, nsc):
    mod, calls = gather_runs
    (gm_j, fmap_j), want = calls[f"pallas grouped extract={extract} nsc={nsc}"]
    fmap, gm, y0, x08, ry, rx8 = _gather_inputs(mod.E, mod.T)
    fmap_t = torch.from_numpy(np.asarray(jnp.asarray(fmap, jnp.bfloat16),
                                         np.float32)).bfloat16()
    gm_t = torch.from_numpy(np.asarray(jnp.asarray(gm, jnp.bfloat16),
                                       np.float32)).bfloat16()
    # the replayed draws are the script's
    np.testing.assert_array_equal(fmap_t.float().numpy(), np.asarray(fmap_j, np.float32))
    np.testing.assert_array_equal(gm_t.float().numpy(), np.asarray(gm_j, np.float32))
    ints = [torch.from_numpy(a.astype(np.int32)) for a in (y0, x08, ry, rx8)]
    got = probe.frame_windows(fmap_t, gm_t, *ints, extract=extract).numpy()
    if extract:
        want = want[:, :8]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(
        probe_cuda.frame_probe_cuda(fmap_t, gm_t, *ints, extract=extract).numpy(),
        got)


# ---------------------------------------------------------------- K14

def _desc_wall_numpy(ring, slot, row0, mode, colr):
    """scripts/probe_desc_wall.py's kernel bodies restated in numpy, each
    copy made at once where the kernel starts it (the ring of K = 8 windows
    holds a copy until it is read: IF = 4 < K)."""
    C, WR, K, IF = ring.shape[-1], 16 * 24, 8, 4           # :41-47
    S, M, NS = probe.copy_plan(mode)                      # :49-61
    nd = slot.shape[0]
    acc = np.zeros((C,), np.float32)
    if NS > 1:                                            # kernel_ns :75
        wins = np.zeros((NS, K, WR, C), np.int8)

        def dma_ns(s, j):                                 # :81-87
            i = j * NS + s
            r0 = row0[i]
            wins[s][j % K] = ring[slot[i], r0:r0 + WR]

        for j in range(IF):                               # :89-91
            for s in range(NS):
                dma_ns(s, j)
        for j in range(nd // NS):                         # :93-106
            if j + IF < nd // NS:                         # :98-101
                for s in range(NS):
                    dma_ns(s, j + IF)
            for s in range(NS):                           # :102-103
                acc = acc + wins[s][j % K, 0, :].astype(np.float32)
        return acc[None]                                  # :108
    col = ring[0, :colr] if mode == "local" else None     # :111-117
    win = np.zeros((K, S, WR, C) if S == 2 else (K, M * WR, C), np.int8)

    def dma(i):                                           # :119-132
        r0 = row0[i]
        if mode == "local":
            r0 = min(r0, colr - WR - 8) & ~7
            win[i % K] = col[r0:r0 + WR]
        elif S == 1:
            win[i % K] = ring[slot[i], r0:r0 + M * WR]
        else:
            win[i % K] = ring[slot[i]:slot[i] + 2, r0:r0 + WR]

    for k in range(IF):                                   # :134-135
        dma(k)
    for i in range(nd):                                   # :137-147
        if i + IF < nd:
            dma(i + IF)
        w = win[i % K]
        if S == 2:
            acc = (acc + w[0, 0, :].astype(np.float32)
                   + w[1, 0, :].astype(np.float32))
        else:
            acc = acc + w[0, :].astype(np.float32)
    return acc[None]                                      # :151


@pytest.fixture(scope="module")
def copy_ring():
    rng = np.random.default_rng(0)
    return rng, rng.integers(-127, 127, (4, 4200, 128)).astype(np.int8)


@pytest.mark.parametrize("colr", [4096, probe.COLR])
@pytest.mark.parametrize("mode", probe.COPY_MODES)
def test_copy_probe_matches_the_kernel_body(copy_ring, mode, colr):
    rng, ring = copy_ring
    S, M, _ = probe.copy_plan(mode)
    n = probe.copy_count(mode, 96)
    slot = rng.integers(0, ring.shape[0] - (S - 1), n).astype(np.int32)   # :70
    max_r0 = ring.shape[1] - M * probe.WR - 8                            # :71-73
    row0 = (rng.integers(0, max_r0 // 8, n) * 8).astype(np.int32)
    want = _desc_wall_numpy(ring, slot, row0, mode, colr)
    got = probe.copy_probe(torch.from_numpy(ring), torch.from_numpy(slot),
                           torch.from_numpy(row0), mode, colr).numpy()
    np.testing.assert_array_equal(got, want)


def test_copy_probe_plan():
    """The ring depths fitted to a block's shared memory, and tall8's
    refusal on either device."""
    plans = {m: probe_cuda.copy_depth(m) for m in probe.COPY_MODES if m != "tall8"}
    assert plans == {"single": (4, 1), "dual": (4, 2), "quad": (4, 4),
                     "pair": (2, 1), "tall2": (2, 1), "tall4": (1, 1),
                     "local": (2, 1)}
    ring = torch.zeros((2, 4000, 128), dtype=torch.int8)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="393216 bytes"):
        probe_cuda.copy_probe_cuda(ring, idx, idx, "tall8")
    with pytest.raises(ValueError, match="route"):
        probe_cuda.copy_probe_cuda(ring, idx, idx, "single", route="dma")
    assert probe_cuda.copy_probe_cuda(ring, idx, idx, "pair").shape == (1, 128)


# ---------------------------------------------------------------- drivers

def _main(name, argv):
    mod = importlib.import_module(f"devo_tpu_torch.scripts.{name}")
    return mod.main(argv + ["--device", "cpu"])


DRIVER_RUNS = {
    "bench_banded_ablate": ["--edges", "128", "--live", "64", "--mem", "14",
                            "--nbx", "3", "--hp", "24", "--iters", "2",
                            "--repeats", "1", "--drift", "--layouts", "random",
                            "cyclic"],
    "probe_desc_wall": ["single", "pair", "tall2", "local", "quad", "--nd", "32",
                        "--mem", "4", "--rows", "4200", "--nit", "1",
                        "--repeats", "2", "--blocks", "1"],
    "bench_gather": ["--edges", "64", "--slots", "32", "--iters", "1",
                     "--repeats", "1"],
    "bench_banded_tune": ["--edges", "64", "--live", "40", "--size", "24", "32",
                          "--iters", "2", "--repeats", "1", "--stage", "noext"],
    "bench_pallas": ["--edges", "64", "--live", "32", "--size", "24", "32",
                     "--iters", "1", "--repeats", "1"],
    "bench_pallas2": ["--edges", "64", "--live", "32", "--check", "16",
                      "--size", "24", "32", "--iters", "1", "--repeats", "1"],
    "probe_level_split": ["--edges", "48", "--live", "32", "--iters", "1",
                          "--repeats", "1"],
    "probe_l4_resident": ["--edges", "48", "--live", "32", "--iters", "1",
                          "--repeats", "1"],
    "profile_step": ["9", "--profiled", "2", "--top", "5"] + SMALL,
    "bench_eval_path": ["10", "--warm", "9"] + SMALL,
}


@pytest.mark.parametrize("name", sorted(DRIVER_RUNS))
def test_driver_runs_on_the_cpu(name, capsys):
    out = _main(name, DRIVER_RUNS[name])
    text = capsys.readouterr().out
    assert "[cpu]" in text or '"card": "cpu"' in text, text
    if name == "bench_banded_ablate":
        assert set(out) == {(lay, m) for lay in ("random", "cyclic")
                            for m in probe.ABLATE_MODES}
    if name == "probe_desc_wall":
        assert "4 copies in flight" in text and "2 ring(s)" not in text
    if name == "bench_pallas2":
        assert out[0] == 0.0                       # the plain version itself


@pytest.mark.parametrize("name,argv,env,match", [
    ("probe_desc_wall", ["tall8"], {}, "393216 bytes"),
    ("probe_desc_wall", ["wide"], {}, "unknown copy mode"),
    ("bench_banded_tune", ["--depth", "5"], {}, "depth must be 2 to 4"),
    ("probe_l4_resident", ["--patch", "4"], {}, "251904 bytes"),
    ("profile_step", [], {"BENCH_CORR_WR1": "16"}, "BENCH_CORR_WR1"),
    ("profile_step", ["--hlo"], {}, "HLO"),
    ("bench_eval_path", [], {"BENCH_CORR_KERNEL": "mono9"}, "mono9"),
    ("bench_gather", [], {"DEVO_CORR_IF": "4"}, "DEVO_CORR_IF"),
    ("bench_banded_ablate", [], {"CORR_WIN_L1": "10"}, "CORR_WIN_L1"),
])
def test_driver_refusals(name, argv, env, match, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as exc:
        _main(name, argv)
    assert exc.value.code not in (0, None) and match in str(exc.value.code)
