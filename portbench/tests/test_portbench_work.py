"""The frozen operation and byte counts give chip_smoke.py's numbers at
each cell's configuration; each configuration's work counter is found by
name and reads its sizes from the configuration."""

import copy

import pytest

import chip_smoke
from portbench import harness as H
from portbench import work as W
from psvi_torch.ops import fused_lenet as FL

from portbench.tests.conftest import manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_frozen_counts_match_chip_smoke(name):
    cell = H.load_cell(name, manifest())
    counter = W.counter(cell)
    shape = counter.shape(cell)
    cfg = FL.LeNetCfg(T=shape.T, S=shape.S, M=shape.M, nc=shape.nc, N=1.0,
                      parameterised=True, use_alpha=False, prior_sd=1.0)
    assert counter.kernel_work(cell) == chip_smoke.lenet_work(cfg)
    assert counter.step_ops(cell) > sum(counter.kernel_work(cell)[0].values())


def test_the_counter_reads_the_configurations_widths():
    cell = copy.deepcopy(H.load_cell(CELLS[0], manifest()))
    base = W.counter(cell).step_ops(cell)
    cell.config["net"]["conv"][1][1] = 32  # conv2 6→32
    cell.config["net"]["fc"][0] = 32 * 5 * 5
    assert W.counter(cell).shape(cell).K2 == 32
    assert W.counter(cell).step_ops(cell) > base


def test_a_net_no_counter_covers_raises():
    cell = copy.deepcopy(H.load_cell(CELLS[0], manifest()))
    cell.config["net"]["conv"].append([16, 32, 3, 1])
    with pytest.raises(ValueError):
        W.counter(cell).step_ops(cell)
    del cell.config["work"]
    with pytest.raises(ValueError):
        W.counter(cell)
    cell.config["work"] = "alexnet"
    with pytest.raises(ValueError):
        W.counter(cell)
