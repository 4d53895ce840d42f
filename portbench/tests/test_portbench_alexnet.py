"""The AlexNet configuration's files on the CPU at a toy size (the
published widths, S=2, T=3, M=10, B=16): its reference imports nothing of
the program; its work counter meets a count of the step's convolutions and
products; its per-layer readers read hand-made records; the program's plain
step agrees with the reference over three checked steps.

``TOY_LIMITS`` are this toy's, not the cell's, and leave out ``hyper``:
the float32 hypergradient of AlexNet's unroll lies far from float64's
(Adam's inner step divides by |g| + 1e-8, which magnifies the rounding of
the parameters whose inner gradient is small).
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import work
from portbench import harness as H
from portbench.tests.conftest import toy

NAME = "alexnet_cifar"
TOY_LIMITS = {"outer": 1e-6, "inner": 1e-6, "net": 1e-3, "update": 1e-3}
FORBIDDEN = {"jax", "jaxlib", "flax", "psvi_tpu", "psvi_torch"}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            "import portbench.reference.common, portbench.reference.alexnet\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not set(json.loads(p.stdout.strip().splitlines()[-1])) & FORBIDDEN


class _Calls(TorchDispatchMode):
    """Operations of every convolution and batched product, by layer:
    conv1's im2col product has C·k² = 75 on an axis, the dense layers'
    products the rest."""

    def __init__(self):
        super().__init__()
        self.ops = {"conv1": 0, "conv2": 0, "fc": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        sh = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        if func is aten.convolution.default:
            x, w, transposed, groups = sh[0], sh[1], args[6], args[8]
            if transposed:  # x is the forward's output side
                macs = x[0] * x[1] * x[2] * x[3] * w[1] * w[2] * w[3]
            else:
                macs = tuple(out.shape)[0] * w[0] * out.shape[2] * out.shape[3] * (
                    x[1] // groups) * w[2] * w[3]
            self.ops["conv2"] += 2 * macs
        elif func is aten.convolution_backward.default:
            go, w, mask = sh[0], sh[2], args[10]
            self.ops["conv2"] += 2 * go[0] * go[1] * go[2] * go[3] * w[1] * w[2] * w[3] * sum(
                bool(m) for m in mask[:2])
        elif func is aten.bmm.default:
            a, b = sh
            self.ops["conv1" if 75 in a or 75 in b else "fc"] += 2 * a[0] * a[1] * a[2] * b[2]
        return out


@pytest.mark.parametrize("S,T,M,B", [(2, 3, 6, 10), (3, 2, 5, 7)])
def test_the_work_counter_meets_a_count_of_the_step(S, T, M, B):
    cell = toy(NAME)
    cell.config["engine"].update(mc_samples=S, inner_it=T, data_minibatch=B)
    cell.mix.update(num_pseudo=M)
    inputs = H.make_inputs(cell, 5, "cpu")
    eng = H.build_engine(cell, inputs, 5, "cpu")
    (xb, yb), (e_in, e_out) = inputs.batches[0], inputs.eps[0]
    trees = [H._engine_tree(eng.net, [{"w": w, "b": b} for w, b in e], {}) for e in e_in]
    out = H._engine_tree(eng.net, [{"w": w, "b": b} for w, b in e_out], {})
    with _Calls() as calls:
        eng._nested_step(eng.state, batch=(xb, yb), eps=(trees, out))
    counter = work.counter(cell)
    ops, byts = counter.conv_work(cell)
    assert ops["step"] == calls.ops["conv2"]
    assert counter.step_ops(cell) == sum(calls.ops.values())
    assert byts["step"] > 0 and byts["evaluation"] > 0


def _reader(name):
    return H.load_module(H.HERE / "metrics" / f"{name}.py")


def _record(cell, kernel_s, steps=2):
    return SimpleNamespace(cell=cell, trace={"kernel_s": kernel_s},
                           traced_window=SimpleNamespace(steps=steps),
                           peaks={"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12})


def test_the_convolution_readers_read_the_counters_kernels_only():
    cell = toy(NAME)
    kernels = work.counter(cell).CONV_KERNELS
    rec = _record(cell, {kernels[0]: 0.3, kernels[1]: 0.1, "elementwise_kernel": 5.0})
    assert _reader("conv_device_ms").read(rec) == pytest.approx(200.0)
    ops, byts = work.counter(cell).conv_work(cell)
    bound = sum(work.bound_s(ops[k], byts[k], 67e12, 3.35e12) for k in ops)
    assert _reader("conv_roofline").read(rec) == pytest.approx(100 * bound / 0.2)
    assert _reader("conv_device_ms").read(_record(cell, {"elementwise_kernel": 5.0})) is None
    assert _reader("conv_device_ms").read(_record(toy("lenet_m100"), {kernels[0]: 0.3})) is None
    assert _reader("conv_roofline").read(SimpleNamespace(**{**vars(rec), "trace": None})) is None


def test_the_unroll_reader_reads_the_programs_counter(monkeypatch):
    from psvi_torch.inference import psvi

    monkeypatch.setattr(psvi, "UNROLL", {"iterations": 20, "remat": False,
                                         "resident_bytes": 3 * 2**30, "resident_bytes_max": 0})
    rec = _record(toy(NAME), {})
    assert _reader("unroll_resident_gib").read(rec) == 3.0
    assert _reader("unroll_resident_gib").read(SimpleNamespace(trace=None)) is None
    psvi.UNROLL["resident_bytes"] = 0  # the CPU's reading, and the fused steps'
    assert _reader("unroll_resident_gib").read(rec) is None


def test_the_plain_step_agrees_with_the_reference():
    cell = toy(NAME)
    cell.limits = TOY_LIMITS
    out = H.run_cell(cell, 11, 1.0, False, time.perf_counter(), device="cpu")
    assert out["info"]["step"] == "_nested_step"
    nums = out["info"]["numbers"]
    assert nums["outer"] < 1e-6 and nums["inner"] < 1e-6
    assert nums["net"] < 1e-3 and nums["update"] < 1e-3
    assert out["result"]["correct"] is True
