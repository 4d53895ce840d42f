"""The benchmark's own CPU tests. Tests that need the card carry the
``card`` marker and decide inside the test whether a card is there."""

import copy

import pytest

from portbench import harness as H


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def manifest() -> dict:
    return H.load_json(H.ROOT / "BENCHMARK.json")


def toy(name: str) -> H.Cell:
    """A cell at a size the CPU runs in seconds: the same configuration and
    traffic with fewer points, samples and iterations."""
    c = copy.deepcopy(H.load_cell(name, manifest()))
    c.config["data"].update(n_per_class=20, n_test_per_class=4)
    c.config["engine"].update(mc_samples=2, inner_it=3, data_minibatch=16)
    c.mix.update(num_pseudo=10, run_steps=c.mix["log_every"])
    return c


@pytest.fixture
def toy_cell():
    return toy
