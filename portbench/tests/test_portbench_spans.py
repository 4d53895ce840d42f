"""The host's split from the program's layer spans (``portbench/spans.py``)
on hand-made records; and, on the card, where the spans land on the
profiler's timeline:

    python3 -m pytest portbench/tests -m card -k spans
"""

import pytest
import torch

from portbench import harness as H
from portbench import spans as SP
from portbench import trace as TR
from portbench import work

MS = 1_000_000  # ns


def _step(step, t, unroll_fwd=3, outer_fwd=2, bwd_before=1, rev=4, bwd_after=1, tail=2):
    """One step's records from ``t`` (ms): a millisecond of draws, the
    unroll's forward, the outer forward, the outer backward around the
    unroll's reverse, then the hyper update."""
    r, c = [], t + 1
    r.append(("psvi.unroll.fwd", step, c * MS, (c + unroll_fwd) * MS))
    c += unroll_fwd
    r.append(("psvi.outer.fwd", step, c * MS, (c + outer_fwd) * MS))
    c += outer_fwd
    b0 = c
    r.append(("psvi.unroll.rev", step, (c + bwd_before) * MS, (c + bwd_before + rev) * MS))
    c += bwd_before + rev + bwd_after
    r.append(("psvi.outer.bwd", step, b0 * MS, c * MS))
    c += tail
    r.append(("psvi.step", step, t * MS, c * MS))
    return r, c


def _records():
    recs, t = [], 0
    for step in (1, 2):
        r, t = _step(step, t)
        recs += r
    recs += [("psvi.evaluate", 2, (t + 1) * MS, (t + 11) * MS),
             ("psvi.readback", 2, (t + 11) * MS, (t + 14) * MS)]
    r, t = _step(3, t + 20, unroll_fwd=5, rev=8)
    return recs + r


def test_self_time_takes_out_the_spans_inside():
    rows = {(n, s): (length, own) for n, s, length, own in SP.self_times(_records())}
    assert rows[("psvi.outer.bwd", 1)] == (6 * MS, 2 * MS)
    assert rows[("psvi.step", 1)] == (14 * MS, 3 * MS)
    assert rows[("psvi.unroll.rev", 1)] == (4 * MS, 4 * MS)
    assert rows[("psvi.evaluate", 2)] == (10 * MS, 10 * MS)


@pytest.mark.parametrize("name,want", [
    ("step_ms", (14 + 14 + 20) / 3),
    ("host_unroll_ms", (7 + 7 + 13) / 3),
    ("host_outer_ms", (4 + 4 + 4) / 3),
    ("host_step_self_ms", 3.0),
    ("host_eval_ms", 10.0),
    ("host_wait_ms", 3.0),
])
def test_the_split_reads(name, want):
    assert SP.split(_records())[name] == pytest.approx(want)


def test_the_split_adds_up_to_the_step():
    s = SP.split(_records())
    assert s["host_unroll_ms"] + s["host_outer_ms"] + s["host_step_self_ms"] == \
        pytest.approx(s["step_ms"])


def test_the_summary_counts_each_name():
    s = SP.summary(_records())
    assert set(s) == set(SP.NAMES)
    assert s["psvi.step"]["count"] == 3
    assert s["psvi.step"]["total_ms"] == pytest.approx(48.0)
    assert s["psvi.step"]["self_ms"] == pytest.approx(9.0)
    assert s["psvi.evaluate"] == {"count": 1, "total_ms": 10.0, "self_ms": 10.0}


def test_no_step_reads_nothing():
    assert SP.split([]) == {}
    assert SP.split([("psvi.evaluate", 0, 0, MS)]) == {}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
def test_the_pairs_kernels_start_after_their_spans_and_no_span_is_device_work():
    """On one traced window of lenet_m30: each kernel of the pair was
    launched inside a ``psvi.unroll.fwd`` or ``psvi.unroll.rev`` span (its
    own step's) and starts on the device after that span began; the
    benchmark's reduction counts no ``psvi.*`` name as device work."""
    dev = _card()
    cell = H.load_cell("lenet_m30")
    inputs = H.make_inputs(cell, 2147484011, dev)
    eng, probe = H.set_up(cell, inputs, 2147484011, dev)
    run_blocks = cell.mix["run_steps"] // cell.mix["log_every"]
    tw, events = H.run_traced(eng, probe, 1.0, run_blocks, eng.state)
    pair = set(work.counter(cell).KERNELS)
    spans, launches, kernels = [], {}, []
    for e in events:
        name, s = e.name(), e.start_ns()
        if str(e.device_type()).endswith("CUDA"):
            if TR.base_name(name) in pair:
                kernels.append((s, e.correlation_id(), name))
        elif name in ("psvi.unroll.fwd", "psvi.unroll.rev"):
            spans.append((s, s + e.duration_ns(), name))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = s
    n_fwd = sum(1 for sp in spans if sp[2] == "psvi.unroll.fwd")
    n_rev = len(spans) - n_fwd
    assert n_fwd >= tw.steps and n_rev >= tw.steps, (n_fwd, n_rev, tw.steps)
    assert kernels
    for start, corr, name in kernels:
        launched = launches.get(corr)
        assert launched is not None, f"no launch of {name} (correlation {corr})"
        own = [sp for sp in spans if sp[0] <= launched <= sp[1]]
        assert len(own) == 1, (name, launched, own)
        assert start >= own[0][0], (name, start, own[0])
    red = TR.reduce(events, H.SPANS, tw.seconds)
    assert not [k for k in red["kernel_s"] if k.startswith("psvi.")]
    assert not [k for k, _ in red["device_ops"] if k.startswith("psvi.")]
    assert red["busy_s"] == TR.reduce(events, H.SPANS + SP.NAMES, tw.seconds)["busy_s"]
