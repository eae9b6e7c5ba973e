"""engine/profiling.py: the step timer against the JAX package's, the
NaN checks behind `--debug_nans`, and the torch.profiler trace, on the
CPU (tolerance: exact; the timer's summary is the same float64
arithmetic)."""
import os

import numpy as np
import pytest
import torch

from itermvs_tpu.engine.profiling import StepTimer as JaxStepTimer
from itermvs_tpu_torch.engine.profiling import StepTimer, maybe_enable_nan_debugging, trace


@pytest.mark.parametrize("skip", [0, 1, 5])
def test_step_timer_summary_matches_jax(skip):
    times = list(np.random.RandomState(3).uniform(0.01, 0.5, 7))
    port, ref = StepTimer(), JaxStepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary(skip) == ref.summary(skip)
    with port.measure():
        pass
    assert len(port.times) == 8 and port.times[-1] >= 0


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU())
        self.head = torch.nn.Linear(4, 1)

    def forward(self, x):
        return {"out": [self.head(self.inner(x))]}


def test_forward_nan_names_the_first_module():
    net = _Net()
    x = torch.ones(2, 3)
    x[1, 2] = float("nan")
    with maybe_enable_nan_debugging(net, True):
        net(torch.ones(2, 3))                          # clean: no raise
        with pytest.raises(FloatingPointError, match=r"module inner\.0 \(Linear\)"):
            net(x)
    net(x)                                             # hooks gone after the block
    assert not any(m._forward_hooks for m in net.modules())


def test_backward_nan_raises_in_anomaly_mode():
    w = torch.ones(3, requires_grad=True)
    with maybe_enable_nan_debugging(torch.nn.Module(), True):
        y = (torch.sqrt(w - 1.0) * 0).sum()            # forward 0; backward 0/0 at sqrt
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert not torch.is_anomaly_enabled()


def test_nan_checks_follow_the_environment(monkeypatch):
    net = _Net()
    x = torch.full((1, 3), float("nan"))
    with maybe_enable_nan_debugging(net):
        net(x)                                         # off: nothing checks
    monkeypatch.setenv("ITERMVS_DEBUG_NANS", "1")
    with maybe_enable_nan_debugging(net), pytest.raises(FloatingPointError):
        net(x)


def test_trace_writes_a_profile(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    written = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert any(f.endswith(".pt.trace.json") for f in written), written
