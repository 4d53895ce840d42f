"""Host-streamed minibatches (``stream_data=True``), the counterparts of
``tests/test_stream_data.py``: the train set stays in host memory, each log
block's batch indices are drawn on the device from the engine's generator
(as a resident run draws them, its noise between them) and copied to the
host in one copy, its rows gathered there and shipped in one copy. So the
streamed run equals the resident run bit for bit (accuracies and NLLs at
atol 0), through every trainer and through the fused step (its plain
versions on the CPU), as JAX's gates let streamed batches through.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import numpy as np
import pytest

from psvi_torch.data.datasets import DataBundle
from psvi_torch.inference.psvi import PSVI


def _bundle(n=256, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (x @ w > 0).astype(np.int32)
    return DataBundle(x, y, x[:64], y[:64], n, d, 2)


CFG = dict(method="psvi_learn_v", num_pseudo=6, mc_samples=4, inner_it=3, num_epochs=8,
           log_every=4, data_minibatch=32, seed=0, device="cpu")
RUNS = {"nested": {}, "joint": dict(trainer="joint"), "alternating": dict(trainer="alternating"),
        "hyper": dict(trainer="hyper", hyper_K=2), "fused": dict(fused_inner=True),
        "fused_stream_eps": dict(fused_inner=True, fused_eps="stream"),
        "reset": dict(reset=True, reset_interval=3), "register_elbos": dict(register_elbos=True)}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_stream_equals_resident(name):
    data = _bundle()
    res_resident = PSVI(data, **CFG, **RUNS[name]).run_psvi()
    eng = PSVI(data, stream_data=True, **CFG, **RUNS[name])
    shipped = []
    ship = eng._ship_rows
    eng._ship_rows = lambda idx: shipped.append(idx.shape[0]) or ship(idx)
    res_stream = eng.run_psvi()
    assert res_stream["accs"] == res_resident["accs"]
    assert res_stream["nlls"] == res_resident["nlls"]
    assert res_stream["elbos"] == res_resident["elbos"]
    # one copy a log block, or a step at a time where a hook draws between steps
    assert shipped == ([1] * 8 if name == "reset" else [4, 4])


def test_stream_train_set_stays_on_host():
    data = _bundle()
    eng = PSVI(data, stream_data=True, **CFG)
    assert eng.x_train.device.type == "cpu" and eng.y_train.device.type == "cpu"
    eng.run_psvi()
    assert eng.x_train.device.type == "cpu"


def test_stream_rejects_increment():
    data = _bundle()
    with pytest.raises(ValueError, match="stream_data"):
        PSVI(data, stream_data=True, increment=True, increment_interval=2,
             increment_sizes=(4, 6), **CFG)
