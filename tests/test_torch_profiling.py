"""The port's profiling hooks (neuspeech1_tpu_torch/train/profiling.py;
the port of tests/test_trainer.py:171-190): a Profiler window over one
step writes a chrome trace holding the annotated region, the StepTimer
times every step, and ``block`` returns on tensors in any container."""

import json

import torch

from neuspeech1_tpu_torch.train.profiling import Profiler, StepTimer, annotate


def test_profiler_and_step_timer(tmp_path):
    prof = Profiler(str(tmp_path / "prof"), start_step=1, num_steps=1)
    timer = StepTimer()
    x = torch.ones((8, 8))
    for step in range(3):
        prof.maybe_start(step)
        with timer.measure():
            with annotate("matmul"):
                y = x @ x
            timer.block({"y": [y, (y,)]})
        prof.maybe_stop(step)
    prof.close()
    assert timer.mean_ms >= 0
    assert len(timer.times) == 3
    files = list((tmp_path / "prof").iterdir())
    assert [f.name for f in files] == ["trace_1_2.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    # the window spans steps 1 and 2, as the JAX Profiler's does
    assert names.count("matmul") == 2


def test_close_ends_an_open_window(tmp_path):
    prof = Profiler(str(tmp_path / "p"), start_step=0, num_steps=100)
    prof.maybe_start(0)
    with annotate("open"):
        torch.ones(2).sum()
    prof.close()
    assert prof.trace_path.endswith("trace_0_100.json")
    assert "open" in open(prof.trace_path).read()
    prof.close()  # a second close is a no-op
