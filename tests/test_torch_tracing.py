"""The port's tracer, utils/timing.py, on the CPU: what a span costs with
tracing off, the span tree of a train step, the parent of a span on another
thread, the `host_waits` counter against the train step's copies worked
out from its edge schedule, the spans on torch.profiler's clock, and
training with tracing on bit for bit as with it off.

The card's half (a span around one kernel holds that kernel's device
interval) is tests/test_torch_tracing_cuda.py.
"""
import threading

import numpy as np
import pytest
import torch

from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.train.__main__ import _make_batch
from devo_tpu_torch.train.forward import build_edge_schedule
from devo_tpu_torch.train.synthetic import SyntheticClips
from devo_tpu_torch.train.trainer import METRICS, Trainer
from devo_tpu_torch.utils import timing
from devo_tpu_torch.utils.params import random_state_dict

N_FRAMES, ITERS, PPI, GROW_AFTER = 5, 3, 4, 2
ITER_SPANS = ["train.edges", "train.corr", "train.update", "train.ba",
              "train.reproject"]


def _trainer(remat=True):
    net = EVONet(dim_inet=32, dim_fnet=16, dim=8)
    net.load_state_dict(random_state_dict(net, 0))
    return Trainer(net=net, total_steps=100, steps_unrolled=ITERS, ppi=PPI,
                   grow_after=GROW_AFTER, remat=remat, device="cpu")


def _batch(index):
    data = SyntheticClips(N_FRAMES, 64, 96)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _make_batch(data, [index]).items()}


@pytest.fixture(scope="module")
def recorded():
    """One traced step of a tiny CPU trainer, with remat on and off:
    {remat: (trainer, recording)}."""
    out = {}
    for remat in (True, False):
        tr = _trainer(remat)
        with timing.recording() as rec:
            tr.train_step(_batch(0))
        out[remat] = (tr, rec)
    return out


def _children(rec, parent):
    return sorted((s for s in rec.spans if s.parent == parent.id),
                  key=lambda s: s.t0_ns)


def test_span_off_records_nothing_and_leaves_the_profiler_alone(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @timing.span("decorated")
    def f(x):
        return x + 1

    with timing.span("block", s=1):
        assert f(1) == 2
    timing.count("host_waits", 3)
    assert timing.upload([1.0, 2.0], "cpu").tolist() == [1.0, 2.0]
    assert timing.read(torch.tensor(4)) == 4
    assert timing._rec is None and not timing._on
    with timing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_the_decorator_and_recordings_nest():
    @timing.span("decorated", kind="fn")
    def f():
        with timing.span("inner"):
            return 7

    assert f() == 7                     # decorated while tracing was off
    with timing.recording() as outer:
        with timing.span("root", step=4):
            timing.count("n", 2)
        with timing.recording() as inner:
            with timing.span("other", step=9):
                f()
                timing.count("n")
        with pytest.raises(RuntimeError):
            with timing.span("raises", step=5):
                timing.count("n", 5)
                raise RuntimeError
    assert [s.name for s in inner.spans] == ["inner", "decorated", "other"]
    assert inner.counts == {(9, "n"): 1}
    assert {s.step for s in inner.spans} == {9}
    assert [s.name for s in outer.spans] == ["root", "raises"]
    assert outer.counts == {(4, "n"): 2, (5, "n"): 5}
    assert timing._stack() == [] and not timing._on
    (dec,) = [s for s in inner.spans if s.name == "decorated"]
    assert dec.attrs == {"kind": "fn"}


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_span_tree(recorded, remat):
    tr, rec = recorded[remat]
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "train.step" and root.attrs == {"step": 0}
    assert {s.step for s in rec.spans} == {0}
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert [s.name for s in _children(rec, root)] == [
        "train.forward", "train.loss", "train.backward", "train.optimizer",
        "train.readout"]
    fwd, _, bwd, opt, _ = _children(rec, root)
    top = [s.name for s in _children(rec, fwd)]
    assert top == ["train.patchify", "train.schedule"] + ["train.iter"] * ITERS
    iters = _children(rec, fwd)[2:]
    assert [s.attrs for s in iters] == [{"s": s} for s in range(ITERS)]
    for it in iters:
        kids = _children(rec, it)
        assert [s.name for s in kids] == ITER_SPANS
        assert all(not s.attrs.get("recompute") for s in kids)
    assert [s.name for s in _children(rec, opt)] == [
        "train.sanitize", "train.clip", "train.adamw"]

    under = [s.name for s in _children(rec, bwd)]
    assert under.count("train.corr.bwd") == ITERS
    again = [s for s in rec.spans if s.attrs.get("recompute")]
    if remat:
        assert sorted(s.name for s in again) == sorted(
            ["train.corr", "train.update", "train.ba"] * ITERS)
        assert all(s.parent == bwd.id for s in again)
    else:
        assert again == [] and under == ["train.corr.bwd"] * ITERS

    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)


def test_a_span_on_another_thread_takes_the_backward_as_parent():
    seen = []

    def worker():
        with timing.span("train.corr.bwd"):
            with timing.span("leaf"):
                pass
        seen.append(timing._stack())

    with timing.recording() as rec:
        with timing.span("train.step", step=3):
            with timing.span("train.backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        lone = threading.Thread(target=worker)   # no span open anywhere
        lone.start()
        lone.join()
    by = {s.name + str(s.step): s for s in rec.spans
          if s.thread != threading.get_ident()}
    bwd = next(s for s in rec.spans if s.name == "train.backward")
    assert by["train.corr.bwd3"].parent == bwd.id
    assert by["leaf3"].parent == by["train.corr.bwd3"].id
    assert by["train.corr.bwdNone"].parent is None
    assert by["leafNone"].parent == by["train.corr.bwdNone"].id
    assert seen == [[], []]


@pytest.mark.parametrize("remat", [True, False])
def test_host_waits_count_the_steps_copies(recorded, remat):
    tr, rec = recorded[remat]
    sched = build_edge_schedule(N_FRAMES, PPI, ITERS, grow_after=GROW_AFTER)
    assert tr.net.patchify.patch_selector == "scorer" and tr.corr_dropout < 1
    # forward: bounds, the selector's candidates (x, y), the initial
    # depths; each iteration ii, jj, kk, emask, ij_seg and the keep mask
    forward = 1 + 2 + 1 + 6 * len(sched)
    # losses: each iteration the flow loss's edge mask and the pose loss's
    # ii, jj; the last one the scorer loss's edge mask and kk
    loss = 3 * len(sched) + 2
    readout = len(METRICS) + 1
    assert rec.counts == {(0, "host_waits"): forward + loss + readout}


def test_spans_lie_on_the_profilers_clock():
    """Each span's [t0_ns, t1_ns] inside the profiler's event of its
    record_function, to within 1 ms."""
    x = torch.randn(256, 256)
    with timing.recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with timing.span(f"clock.{i}"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    assert len(rec.spans) == 3 and set(events) == {s.name for s in rec.spans}
    for s in rec.spans:
        e = events[s.name]
        assert e.start_ns() - 1_000_000 <= s.t0_ns, (s, e.start_ns())
        assert s.t1_ns <= e.end_ns() + 1_000_000, (s, e.end_ns())
        assert s.t1_ns - s.t0_ns <= e.end_ns() - e.start_ns() + 1_000_000


def test_training_with_tracing_on_is_bitwise_tracing_off():
    runs = []
    for traced in (False, True):
        tr = _trainer()
        losses = []
        for step in range(2):
            if traced:
                with timing.recording() as rec:
                    losses.append(tr.train_step(_batch(step)))
                assert len(rec.spans) > 0
            else:
                losses.append(tr.train_step(_batch(step)))
        runs.append((losses, [p.detach().clone() for p in tr.net.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
