"""The tracer's clock against the card's: a span around one kernel launch
and a synchronise holds that kernel's device interval, as a device-only
torch.profiler run reads it. Skips without a GPU. Imports neither jax nor
devo_tpu, so that it runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_tracing_cuda.py
"""
import pytest
import torch

from devo_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda


def test_a_span_holds_its_kernels_device_interval():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs on the card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 4096, device="cuda")
    x.mul_(0.5)
    torch.cuda.synchronize()
    with timing.recording() as rec, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with timing.span(f"kernel.{i}"):
                x.mul_(0.5)                      # one element-wise kernel
                torch.cuda.synchronize()
    kernels = sorted(
        (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    spans = sorted((s.t0_ns, s.t1_ns) for s in rec.spans)
    assert len(kernels) == 3 and len(spans) == 3, (kernels, spans)
    for (k0, k1), (s0, s1) in zip(kernels, spans):
        assert s0 <= k0 <= k1 <= s1, (k0 - s0, s1 - k1)
