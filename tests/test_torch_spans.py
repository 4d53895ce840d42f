"""The layer spans of the run loop and the LeNet step
(``psvi_torch/utils/resource.py::span``).

- Off, with no profiler recording, ``span`` returns the one shared null
  context and records nothing.
- A short CPU ``run_psvi`` of the LeNet engine through the fused step (the
  kernel pair's plain versions) records all seven names with step
  indices; in each step the unroll's and the outer IW-ELBO's spans follow
  one another inside ``psvi.step``, ``psvi.unroll.rev`` inside
  ``psvi.outer.bwd``, so they and the step's self time add up to it.
- ``profile_dir``'s Chrome trace holds the program's spans.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import json
from collections import defaultdict

import numpy as np
import pytest
import torch

from psvi_torch.data.datasets import DataBundle
from psvi_torch.data.synthetic import make_synth_images
from psvi_torch.inference.psvi import PSVI
from psvi_torch.utils import resource as R

NAMES = ("psvi.step", "psvi.unroll.fwd", "psvi.unroll.rev", "psvi.outer.fwd",
         "psvi.outer.bwd", "psvi.evaluate", "psvi.readback")
IN_STEP = ("psvi.unroll.fwd", "psvi.unroll.rev", "psvi.outer.fwd", "psvi.outer.bwd")


def _engine(**kw):
    x, y, xt, yt = make_synth_images(n_per_class=3, n_test_per_class=2,
                                     rng=np.random.default_rng(0))
    data = DataBundle(x, y, xt, yt, len(x), 28 * 28, 10, channels=1)
    return PSVI(data, method="psvi_learn_v", architecture="lenet", num_pseudo=10,
                mc_samples=2, inner_it=2, data_minibatch=8, init_sd=1e-3, num_epochs=3,
                log_every=2, seed=0, device="cpu", fused_inner=True, **kw)


@pytest.fixture
def recorder():
    R.take_spans()
    R.enable_spans()
    yield R
    R.disable_spans()
    R.take_spans()


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    R.disable_spans()
    R.take_spans()
    a, b = R.span("psvi.step"), R.span("psvi.evaluate")
    assert a is b
    with a:
        pass
    assert R.take_spans() == []


def test_span_on_records_name_step_and_interval(recorder):
    with R.span("psvi.step"):
        with R.span("psvi.outer.fwd"):
            pass
    with R.span("psvi.evaluate"):
        pass
    recs = R.take_spans()
    assert [r[0] for r in recs] == ["psvi.outer.fwd", "psvi.step", "psvi.evaluate"]
    step = recs[1][1]
    assert [r[1] for r in recs] == [step, step, step]
    assert all(t0 <= t1 for _, _, t0, t1 in recs)
    assert recs[1][2] <= recs[0][2] <= recs[0][3] <= recs[1][3]
    assert R.take_spans() == []


def test_lenet_run_records_every_span_and_the_split_adds_up(recorder):
    eng = _engine()
    assert eng._step.__name__ == "_nested_step_fused_lenet"
    eng.run_psvi()
    recs = R.take_spans()
    assert {r[0] for r in recs} == set(NAMES)
    by_step = defaultdict(lambda: defaultdict(list))
    for name, step, t0, t1 in recs:
        by_step[step][name].append((t0, t1))
    steps = [s for s in by_step if "psvi.step" in by_step[s]]
    assert len(steps) == 3 and len(set(steps)) == 3
    assert sum(len(by_step[s]["psvi.evaluate"]) for s in by_step) == 2
    assert sum(len(by_step[s]["psvi.readback"]) for s in by_step) == 2
    for s in steps:
        spans = by_step[s]
        assert all(len(spans[n]) == 1 for n in ("psvi.step",) + IN_STEP)
        (s0, s1), (f0, f1), (r0, r1), (o0, o1), (b0, b1) = (
            spans[n][0] for n in ("psvi.step",) + IN_STEP)
        # draws, unroll forward, outer forward, outer backward around the
        # unroll's reverse, hyper update, in this order inside the step: so
        # the unroll's spans, the outer's less the reverse, and the step's
        # self time add up to the step
        assert s0 <= f0 <= f1 <= o0 <= o1 <= b0 <= r0 <= r1 <= b1 <= s1


def test_profile_dir_trace_holds_the_spans(tmp_path):
    R.disable_spans()
    eng = _engine(profile_dir=str(tmp_path / "prof"), dnm="synth")
    eng.num_epochs = 1
    eng.run_psvi()
    assert not torch.autograd.profiler._is_profiler_enabled
    trace = json.loads((tmp_path / "prof" / "psvi_synth_0.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"psvi.step", "psvi.unroll.fwd", "psvi.evaluate"} <= names
    assert R.take_spans() == []
