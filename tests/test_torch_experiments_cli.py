"""The port's CLI (``python -m psvi_torch.experiments``) against JAX's.

- The registry (``INF_DICT``, ``REGRESSOR_METHODS``), every flag with its
  default, choices and action, and ``ExperimentConfig``'s fields and
  defaults equal JAX's; the port has one flag more, ``--device``.
- The counterparts of ``tests/test_experiments_cli.py``, run with
  ``--device cpu``: a PSVI run end to end into ``tmp_path`` in the flat
  layout, the timestamped layout with the input data and the notes, a
  baseline method, ``--init_dataset`` by name, the layer knobs reaching
  the engine.
- ``--trial_parallel`` (all trials as one vmapped program), ``--fp64`` and
  ``--debug_nans`` run, and leave the process's default dtype and anomaly
  mode as they were.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses
import json
import os

import numpy as np
import torch

from psvi_torch import experiments as PE
from psvi_torch.data import read_dataset
from psvi_torch.inference.psvi import PSVI
from psvi_torch.models.layers import MaxPool2d, VIConvPool2d
from psvi_torch.utils.config import ExperimentConfig
from psvi_tpu import experiments as JE
from psvi_tpu.utils.config import ExperimentConfig as JExperimentConfig

RUN = ["--datasets", "halfmoon", "--methods", "psvi_learn_v", "--coreset_sizes", "10",
       "--num_trials", "1", "--num_epochs", "6", "--inner_it", "3", "--mc_samples", "4",
       "--log_every", "3", "--init_sd", "1e-3", "--device", "cpu"]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, type(a).__name__,
                     a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


def test_registry_equals_jax():
    assert set(PE.INF_DICT) == set(JE.INF_DICT)
    assert PE.REGRESSOR_METHODS == JE.REGRESSOR_METHODS


def test_flags_equal_jax_plus_device():
    port, jax_ = _flags(PE.build_parser()), _flags(JE.build_parser())
    assert set(port) == set(jax_) | {"device"}
    for dest, spec in jax_.items():
        assert port[dest] == spec, dest
    assert port["device"][1] is None


def test_experiment_config_equals_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(ExperimentConfig)]
    jax_ = [(f.name, f.default) for f in dataclasses.fields(JExperimentConfig)]
    assert port == jax_
    assert ExperimentConfig().method_kwargs(seed=3)["seed"] == 3


def test_cli_end_to_end(tmp_path):
    res = PE.main(RUN + ["--results_folder", str(tmp_path)])
    r = res["halfmoon"]["psvi_learn_v"][10][0]
    assert len(r["accs"]) == 2 and all(np.isfinite(r["accs"]))
    for f in ("results.json", "results.pk", "config.json"):
        assert os.path.exists(tmp_path / f)


def test_cli_save_new_folder_and_input_data(tmp_path):
    PE.main(["--datasets", "halfmoon", "--methods", "random", "--num_trials", "1",
             "--num_epochs", "11", "--log_every", "10", "--mc_samples", "4",
             "--results_folder", str(tmp_path), "--fnm", "myrun", "--save_new_folder",
             "--save_input_data", "--notes", "cli layout parity test", "--device", "cpu"])
    subdirs = os.listdir(tmp_path)
    assert len(subdirs) == 1  # one timestamped folder
    folder = tmp_path / subdirs[0]
    for f in ("myrun.json", "myrun.pk", "input_data_halfmoon.npz"):
        assert os.path.exists(folder / f)
    cfg = json.load(open(folder / "config.json"))
    assert cfg["notes"] == "cli layout parity test" and cfg["device"] == "cpu"


def test_cli_baseline_method(tmp_path):
    res = PE.main(["--datasets", "halfmoon", "--methods", "random", "--num_trials", "1",
                   "--num_epochs", "11", "--log_every", "10", "--mc_samples", "4",
                   "--results_folder", str(tmp_path), "--device", "cpu"])
    assert res["halfmoon"]["random"][-1][0]["csizes"] == [0, 10]


def test_cli_init_dataset_name_resolves(tmp_path):
    res = PE.main(["--datasets", "halfmoon", "--methods", "psvi_learn_v", "--coreset_sizes",
                   "6", "--num_trials", "1", "--num_epochs", "3", "--inner_it", "2",
                   "--mc_samples", "4", "--log_every", "2", "--init_sd", "1e-3",
                   "--results_folder", str(tmp_path), "--init_dataset", "four_blobs",
                   "--device", "cpu"])
    assert all(np.isfinite(res["halfmoon"]["psvi_learn_v"][6][0]["accs"]))


def test_cli_perf_knobs_roundtrip():
    args = PE.build_parser().parse_args(["--no-fuse_convpool", "--pool_backend", "argmax",
                                         "--inner_unroll", "4"])
    assert args.fuse_convpool is False and args.pool_backend == "argmax"
    assert args.inner_unroll == 4
    kw = PE._engine_kwargs({**vars(args), "num_pseudo": 4, "mc_samples": 3,
                            "architecture": "lenet", "inner_it": 2, "num_epochs": 1,
                            "data_minibatch": 8, "log_every": 10, "seed": 0,
                            "device": "cpu", "init_args": "subsample"})
    assert kw["fused_inner"] == "auto" and "num_trials" not in kw
    data = read_dataset("synth_mnist")
    layers = PSVI(data, **{**kw, "pool_backend": "reshape", "fuse_convpool": True}).net.layers
    assert any(isinstance(layer, VIConvPool2d) for layer in layers)
    eng_am = PSVI(data, **kw)
    pools = [layer for layer in eng_am.net.layers if isinstance(layer, MaxPool2d)]
    assert pools and all(p.backend == "argmax" for p in pools)
    assert not any(isinstance(layer, VIConvPool2d) for layer in eng_am.net.layers)
    assert eng_am.inner_unroll == 4


def test_cli_trial_parallel(tmp_path):
    joined = torch.distributed.is_initialized()
    res = PE.main(RUN[:6] + ["--num_trials", "3"] + RUN[8:]
                  + ["--trial_parallel", "--results_folder", str(tmp_path)])
    runs = res["halfmoon"]["psvi_learn_v"][10]
    assert sorted(runs) == [0, 1, 2]
    assert all(len(r["accs"]) == 2 and np.isfinite(r["accs"]).all() for r in runs.values())
    assert os.path.exists(tmp_path / "results.json")
    # a one-process run joins no process group
    assert torch.distributed.is_initialized() == joined


def test_cli_fp64_and_debug_nans_restore_the_process(tmp_path):
    dtype, anomaly = torch.get_default_dtype(), torch.is_anomaly_enabled()
    res = PE.main(RUN + ["--fp64", "--debug_nans", "--results_folder", str(tmp_path)])
    assert all(np.isfinite(res["halfmoon"]["psvi_learn_v"][10][0]["nlls"]))
    assert torch.get_default_dtype() == dtype and torch.is_anomaly_enabled() == anomaly
