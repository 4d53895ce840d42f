"""The harness on the CPU at a toy size: the program's plain path against
the reference, each planted fault caught, the result line's shape and the
trace reduction."""

import math
import time

import pytest

from portbench import check, faults
from portbench import harness as H
from portbench import trace as TR

CELLS = ("lenet_m100", "lenet_m30")
TOY_LIMITS = {"outer": 1e-5, "inner": 1e-5, "net": 1e-3, "hyper": 1e-2, "update": 1e-3}


def _run(cell, seed=11):
    cell.limits = TOY_LIMITS
    return H.run_cell(cell, seed, 1.0, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_plain_path(toy_cell, name):
    out = _run(toy_cell(name))
    assert out["info"]["step"] == "_nested_step_fused_lenet"
    nums = out["info"]["numbers"]
    assert nums["outer"] < 1e-6 and nums["inner"] < 1e-6
    assert nums["net"] < 1e-4 and nums["hyper"] < 1e-3 and nums["update"] < 1e-4
    assert len(out["info"]["per_step"]["net"]) == toy_cell(name).mix["check_steps"]
    assert out["result"]["correct"] is True


def test_the_control_runs_the_same_record(toy_cell):
    """The control stands in the program's place: its steps give the same
    record, and on the CPU (no TF32) it agrees with the reference."""
    cell = toy_cell("lenet_m100")
    inputs = H.make_inputs(cell, 5, "cpu")
    steps = H.control_states(cell, inputs)
    assert len(steps) == cell.mix["check_steps"]
    nums = check.numbers(steps, H.reference_readings(cell, inputs, steps))
    assert nums["outer"] < 1e-6 and nums["net"] < 1e-4 and nums["hyper"] < 1e-3


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_comes_out_not_correct(toy_cell, name, kind):
    with faults.planted(kind):
        out = _run(toy_cell(name))
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_result_line_shape(toy_cell, name):
    res = _run(toy_cell(name))["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for row in res["check"].values():
        assert set(row) == {"value", "limit"} and math.isfinite(row["value"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_judge_needs_limits_and_refuses_non_finite():
    nums = {k: 0.0 for k in check.NAMES}
    assert check.judge(nums, None)["correct"] is False
    assert check.judge(nums, {"outer": 1e-6})["correct"] is True
    assert check.judge({**nums, "outer": math.nan}, {"outer": 1e-6})["correct"] is False
    assert check._over_steps(min, [1.0, math.inf]) == math.inf
    assert check._geometric_mean([1e-2, 1e-4, 1e-6]) == pytest.approx(1e-4)


class _Ev:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return False


def test_trace_reduction():
    evs = [_Ev("portbench.block", 0, 1000, False), _Ev("portbench.step", 100, 500, False),
           _Ev("void k_gemm<1>(GemmArgs)", 0, 200, True), _Ev("k_gemm", 150, 100, True),
           _Ev("void k_conv1(ConvArgs)", 400, 100, True),
           _Ev("portbench.step", 0, 900, True)]  # the device side of a span: no work
    t = TR.reduce(evs, H.SPANS, 1e-6)
    assert t["busy_s"] == pytest.approx(350e-9)
    assert t["kernel_s"] == pytest.approx({"k_gemm": 300e-9, "k_conv1": 100e-9})
    assert t["idle_gaps"] == [["portbench.step", pytest.approx(150e-9)]]
