"""What the drivers share: the device argument, the timing, the card's name
and the refusal of the TPU scripts' knobs that the port does not have."""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

# environment knobs of devo_tpu that choose a TPU transport, layout or
# compiled shape; a driver that finds one set exits
DROPPED_KNOBS = ("BENCH_WIRE", "BENCH_CORR_WR1", "BENCH_SCORER_S2D",
                 "BENCH_ENCODER_S2D", "DEVO_FORCE_BUCKET", "DEVO_CORR_IF",
                 "DEVO_CORR_K", "DEVO_CORR_BE", "DEVO_CORR_BE2P",
                 "DEVO_CORR_BE3", "CORR_WIN_L1")


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions (a test's size only: "
                        "its times say nothing about the card); default: "
                        "the current CUDA device, which must exist")
    return p


def device(args) -> torch.device:
    """The device of a run: --device if given, else the current CUDA device.
    Exits where there is none. Also refuses the dropped knobs."""
    refuse_dropped()
    if args.device is not None:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this program runs on the card (--device cpu "
                 "runs the plain versions)")
    return torch.device("cuda", torch.cuda.current_device())


def refuse_dropped(environ=os.environ):
    for name in DROPPED_KNOBS:
        if name in environ:
            sys.exit(f"{name} is set, and devo_tpu_torch has no counterpart "
                     f"of what it chooses (a TPU transport, layout or "
                     f"compiled shape): unset it")


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from devo_tpu_torch.bench import card as smi
    return smi()


def median_ms(fn, dev: torch.device, launches: int = 10, repeats: int = 5,
              before=None) -> list:
    """The mean time of `launches` back-to-back calls of fn(i), i the call's
    index, in each of `repeats` repeats (one warm-up call first): between two
    CUDA events on the card, by the host clock around a synchronised run on
    the CPU. `before(rep)`, if given, runs ahead of each repeat, outside its
    clock. Returns the sorted per-repeat times in ms."""
    fn(0)
    times = []
    for rep in range(repeats):
        if before is not None:
            before(rep)
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(launches):
                fn(i)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / launches)
        else:
            t0 = time.perf_counter()
            for i in range(launches):
                fn(i)
            times.append(1e3 * (time.perf_counter() - t0) / launches)
    return sorted(times)


def median(times) -> float:
    return float(np.median(times))


def overrides(pairs) -> dict:
    """VOConfig overrides from KEY=VALUE strings, each value a Python
    literal (a number, True/False, a quoted string)."""
    import ast
    out = {}
    for pair in pairs or ():
        key, sep, value = pair.partition("=")
        if not sep:
            sys.exit(f"--set {pair!r}: expected KEY=VALUE")
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def randn(shape, dev, seed: int, scale: float = 1.0, dtype=torch.bfloat16):
    """Seeded normal values made on the device (bulk data: a ring of
    hundreds of MB is not drawn on the host)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
