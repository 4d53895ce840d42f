"""Experiment drivers and the command line: ``python -m psvi_torch.experiments``.

Counterpart of ``psvi_tpu/experiments.py`` (ref ``psvi_experiments.py``):
the same flags with the same defaults (ref :50-380), the ``INF_DICT``
registry of method names (ref :402-458), and ``experiment_driver`` /
``regressor_experiment_driver`` sweeping (dataset × method × coreset_size
× trial) with seed = trial index (ref :461-573, :536), the results saved
in ``utils/results.py``'s layout (ref :669-710).

One flag more than JAX's: ``--device`` (default: the CUDA card; ``cpu``
runs the plain PyTorch path), the counterpart of JAX's ``JAX_PLATFORMS``
handling. The flags that name JAX machinery map to the port's:
``--distributed`` joins the ``torch.distributed`` process group
(``parallel/distributed.py``: NCCL on the card, gloo on the CPU) from
``torchrun``'s environment; ``--trial_parallel`` runs each PSVI method's
trials as one vmapped program over the world's ``trial`` axis
(``parallel/trials.py``; ``--mesh_trial_axis`` ranks, 0 = all);
``--debug_nans`` is ``torch.autograd.set_detect_anomaly(True)`` (the
reference's own guard); ``--fp64`` makes float64 the default dtype, which
the engines' tensors follow (the fused kernels are float32 and refuse it).
JAX's persistent compile cache (``utils/cache.py``) has no counterpart:
the port compiles nothing at run time but its CUDA sources, which
``ops/_build.py`` caches by content hash.
"""

from __future__ import annotations

import argparse
import inspect
import os
from typing import Any, Dict, List

import numpy as np
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.inference import baselines as B
from psvi_torch.inference.psvi import PSVI, make_psvi_engine, run_psvi
from psvi_torch.inference.sparsebbvi import run_sparsevi_with_bb_elbo
from psvi_torch.utils.config import METHOD_SPECS
from psvi_torch.utils.results import get_save_foldername, save_results
from psvi_torch.utils.results import recursive_dict as rec_dd

# (the results' nested defaultdicts take utils/results.py's factory: a
# factory defined here would pickle as __main__'s under ``python -m`` and
# load nowhere else)


# what the engines take of the driver's keyword arguments (the JAX engine
# swallows the rest in **kwargs; the port's names its arguments)
_ENGINE_ARGS = set(inspect.signature(PSVI.__init__).parameters) - {"self", "data", "method"}


def _engine_kwargs(kw):
    out = {k: v for k, v in kw.items() if k in _ENGINE_ARGS}
    if out.get("fused_inner", "auto") is None:  # the CLI's default: where supported
        out["fused_inner"] = "auto"
    return out


def _psvi_method(name):
    def run(data=None, **kw):
        return run_psvi(data, method=name, **_engine_kwargs(kw))

    return run


# method registry (ref psvi_experiments.py:402-458)
INF_DICT: Dict[str, Any] = {
    **{name: _psvi_method(name) for name in METHOD_SPECS},
    "sparsebbvi": lambda data=None, **kw: run_sparsevi_with_bb_elbo(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, **kw),
    "opsvi": lambda data=None, **kw: B.run_opsvi(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "random": lambda data=None, **kw: B.run_random(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "sparsevi": lambda data=None, **kw: B.run_sparsevi(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "giga": lambda data=None, **kw: B.run_giga(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "mfvi": lambda data=None, **kw: B.run_mfvi(train=data, N=data.N, D=data.D, **kw),
    "mfvi_subset": lambda data=None, **kw: B.run_mfvi_subset(train=data, D=data.D, **kw),
    "mfvi_regressor": lambda data=None, **kw: B.run_mfvi_regressor(train=data, **kw),
    "mfvi_subset_regressor": lambda data=None, **kw: B.run_mfvi_subset_regressor(
        train=data, **kw),
    "el2n": lambda data=None, **kw: B.run_el2n_coreset(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "kmeans": lambda data=None, **kw: B.run_kmeans(
        x=data.x, y=data.y, xt=data.xt, yt=data.yt, N=data.N, D=data.D, **kw),
    "mfvi_selection": lambda data=None, **kw: B.run_selection_with_mfvi(train=data, **kw),
}

REGRESSOR_METHODS = {
    "psvi_regressor", "psvi_learn_v_regressor", "psvi_alpha_v_regressor",
    "mfvi_regressor", "mfvi_subset_regressor",
}


def _read(dnm, methods, method_args):
    """The dataset as the driver reads it: the regression reader when any
    method is a regressor."""
    if any(m in REGRESSOR_METHODS for m in methods):
        return read_regression_dataset(
            dnm, seed=method_args.get("seed", 0), num_test=method_args.get("num_test", 100),
            data_dir=method_args.get("data_folder", "data"))
    return read_dataset(dnm, test_ratio=method_args.get("test_ratio", 0.2),
                        data_folder=method_args.get("data_folder", "data"))


def experiment_driver(datasets: List[str], methods: List[str], method_args: Dict[str, Any]):
    """Sweep (dataset × method × coreset_size × trial); seed = trial index
    (ref psvi_experiments.py:461-573)."""
    results = rec_dd()
    for dnm in datasets:
        data = _read(dnm, methods, method_args)
        for nm_alg in methods:
            inf_alg = INF_DICT[nm_alg]
            compute_weights_entropy = (
                not nm_alg.startswith(("opsvi", "mfvi_subset"))
            ) and method_args.get("compute_weights_entropy", True)
            tps = (method_args["coreset_sizes"]
                   if nm_alg.startswith(("psvi", "opsvi", "mfvi_subset", "mfvi_selection"))
                   else [-1])
            for ps in tps:
                engine = None  # PSVI-family: one engine, reseeded per trial
                for t in range(method_args.get("num_trials", 1)):
                    kw = dict(method_args)
                    kw.pop("datasets", None), kw.pop("methods", None)
                    kw.pop("coreset_sizes", None)
                    kw["num_pseudo"] = ps
                    kw["seed"] = t
                    kw["nc"] = data.nc
                    kw["dnm"] = dnm
                    kw["compute_weights_entropy"] = compute_weights_entropy
                    kw["init_args"] = kw.pop("init_at", "subsample")
                    kw["taus"] = getattr(data, "taus", ())
                    if nm_alg in METHOD_SPECS:
                        # sequential trials share one engine (seed = trial
                        # index, ref psvi_experiments.py:536)
                        if engine is None:
                            engine = make_psvi_engine(data=data, method=nm_alg,
                                                      **_engine_kwargs(kw))
                        else:
                            engine.reseed(t)
                        results[dnm][nm_alg][ps][t] = engine.run_psvi()
                    else:
                        results[dnm][nm_alg][ps][t] = inf_alg(data=data, **kw)
    return results


def regressor_experiment_driver(datasets, methods, method_args):
    return experiment_driver(datasets, methods, method_args)


def build_parser() -> argparse.ArgumentParser:
    """Flag surface parity with ref psvi_experiments.py:50-380."""
    p = argparse.ArgumentParser(description="PSVI experiments on PyTorch and CUDA")
    p.add_argument("--datasets", nargs="+", default=["halfmoon"])
    p.add_argument("--methods", nargs="+", default=["psvi_learn_v"])
    p.add_argument("--mc_samples", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=301)
    p.add_argument("--num_trials", type=int, default=3)
    p.add_argument("--data_minibatch", type=int, default=128)
    p.add_argument("--inner_it", type=int, default=100)
    p.add_argument("--outer_it", type=int, default=100)
    p.add_argument("--trainer", type=str, default="nested",
                   choices=["nested", "hyper", "joint", "alternating"])
    p.add_argument("--hypergrad_approx", type=str, default="cg_normaleq",
                   choices=["cg_normaleq", "fixed_point", "neumann"],
                   help="implicit-differentiation solver of --trainer hyper")
    p.add_argument("--stream_data", action="store_true",
                   help="the train set stays in host memory; each log block's "
                        "batches are gathered there and shipped in one copy")
    p.add_argument("--inner_optimizer", type=str, default="adam",
                   choices=["adam", "adamw", "sgd", "heavy_ball", "rmsprop",
                            "adagrad", "adadelta", "adamax", "asgd", "rprop"],
                   help="inner-loop differentiable optimizer")
    p.add_argument("--hyper_K", type=int, default=30,
                   help="the implicit solver's iterations")
    p.add_argument("--linsys_lr", type=float, default=1e-4,
                   help="fixed-point map step size of the implicit solver")
    p.add_argument("--diagonal", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--giga_growth", type=str, default="log_every",
                   choices=["log_every", "every_step"],
                   help="GIGA coreset growth cadence: 'log_every' grows on "
                        "logged iterations only, as the reference does; "
                        "'every_step' every step")
    p.add_argument("--architecture", type=str, default="logistic_regression")
    p.add_argument("--n_hidden", type=int, default=40)
    p.add_argument("--n_layers", type=int, default=1)
    p.add_argument("--init_sd", type=float, default=1e-6)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--register_elbos", action="store_true", default=False)
    p.add_argument("--init_at", type=str, default="subsample",
                   choices=["random", "subsample", "custom", "saved"])
    p.add_argument("--lr0net", type=float, default=1e-3)
    p.add_argument("--lr0u", type=float, default=1e-4)
    p.add_argument("--lr0v", type=float, default=1e-3)
    p.add_argument("--lr0z", type=float, default=1e-3)
    p.add_argument("--lr0alpha", type=float, default=1e-3)
    p.add_argument("--lr0joint", type=float, default=1e-3)
    p.add_argument("--init_dataset", type=str, default=None)
    p.add_argument("--coreset_sizes", nargs="+", type=int, default=[10])
    p.add_argument("--reset", action="store_true", default=False)
    p.add_argument("--reset_interval", type=int, default=10)
    p.add_argument("--prune", action="store_true", default=False)
    p.add_argument("--prune_interval", type=int, default=None)
    p.add_argument("--prune_sizes", nargs="+", type=int, default=[])
    p.add_argument("--increment", action="store_true", default=False)
    p.add_argument("--increment_interval", type=int, default=None)
    p.add_argument("--increment_sizes", nargs="+", type=int, default=[])
    p.add_argument("--retrain_on_coreset", action="store_true", default=False)
    p.add_argument("--test_ratio", type=float, default=0.2)
    p.add_argument("--log_pseudodata", action="store_true", default=False)
    p.add_argument("--data_folder", type=str, default="data")
    p.add_argument("--results_folder", type=str, default="results")
    p.add_argument("--learn_z", action="store_true", default=False)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--mfvi_selection_method", type=str, default="random")
    p.add_argument("--pretrain_epochs", type=int, default=5)
    p.add_argument("--load_from_saved", action="store_true", default=False)
    p.add_argument("--distance_fn", type=str, default="euclidean")
    p.add_argument("--last_layer_only", action="store_true", default=False)
    p.add_argument("--loaded_from_psvi", action="store_true", default=False)
    p.add_argument("--multiple_pts_per_cluster",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--choose_difficult", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--scoring_run", action="store_true", default=False)
    p.add_argument("--alpha_dirichlet", type=float, default=0.0)
    p.add_argument("--compute_weights_entropy",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--num_test", type=int, default=100)
    p.add_argument("--tau", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fnm", type=str, default="results",
                   help="filename (stem) for stored results")
    p.add_argument("--save_new_folder", action="store_true", default=False,
                   help="save results in a new timestamped folder")
    p.add_argument("--save_input_data", action="store_true", default=False,
                   help="save the input dataset arrays next to the results")
    p.add_argument("--notes", type=str, default="no notes",
                   help="notes on what this experiment is trying to "
                        "accomplish (persisted in config.json)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="operand dtype of the matmul/conv stack; bfloat16 "
                        "keeps the loss math in float32")
    p.add_argument("--trial_parallel", action="store_true", default=False,
                   help="advance all trials of a PSVI method as one vmapped "
                        "program over the world's trial axis")
    p.add_argument("--mesh_trial_axis", type=int, default=0,
                   help="trial mesh axis size in ranks (0 = all ranks)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of each PSVI run here")
    p.add_argument("--inner_unroll", type=int, default=None,
                   help="JAX's lax.scan unroll factor of the inner loop; the "
                        "port's loop is a Python loop, on which it has no effect")
    p.add_argument("--fuse_convpool", action=argparse.BooleanOptionalAction, default=True,
                   help="fold (conv, 2x2-maxpool) pairs into the parity-split "
                        "pooled conv; --no-fuse_convpool keeps the literal "
                        "conv->pool net (the LeNet kernel pair serves both)")
    p.add_argument("--pool_backend", type=str, default="reshape",
                   choices=["reshape", "argmax"],
                   help="max-pool formulation for unfused pools: 'argmax' "
                        "sends the gradient to each window's first argmax "
                        "(disables fuse_convpool)")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="torch.autograd.set_detect_anomaly(True): a backward "
                        "that produces a NaN raises at the op that made it "
                        "(the reference's guard, psvi_experiments.py:48)")
    p.add_argument("--fp64", action="store_true", default=False,
                   help="float64 as the default dtype, which the engines' "
                        "tensors follow (numerics debugging; the fused "
                        "kernels are float32 and refuse it)")
    p.add_argument("--backend", type=str, default="xla", choices=["xla", "pallas"],
                   help="dense-layer products: 'xla' the plain product, "
                        "'pallas' the CUDA kernel B3 (first-order paths)")
    p.add_argument("--fused_inner", action=argparse.BooleanOptionalAction, default=None,
                   help="the fused CUDA kernels of the nested step (dense "
                        "nets, LeNet). Default: where the configuration is "
                        "supported, on the card; --fused_inner requires them "
                        "(errors if unsupported), --no-fused_inner disables")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join the torch.distributed process group before "
                        "anything else, from torchrun's MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE and RANK (NCCL on the card, "
                        "gloo on the CPU) — see parallel/distributed.py")
    p.add_argument("--device", type=str, default=None,
                   help="the device to run on (default: the CUDA card; 'cpu' "
                        "runs the plain PyTorch path)")
    return p


def main(argv=None):
    """Run the CLI; the default dtype and anomaly detection that
    ``--fp64`` and ``--debug_nans`` set are restored on return."""
    dtype, anomaly = torch.get_default_dtype(), torch.is_anomaly_enabled()
    try:
        return _main(build_parser().parse_args(argv))
    finally:
        torch.set_default_dtype(dtype)
        torch.autograd.set_detect_anomaly(anomaly)


def _main(args):
    if args.distributed:
        from psvi_torch.parallel.distributed import initialize_distributed

        on_card = args.device is None or torch.device(args.device).type == "cuda"
        initialize_distributed("nccl" if on_card else "gloo")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.fp64:
        torch.set_default_dtype(torch.float64)
    method_args = vars(args)
    datasets = method_args.pop("datasets")
    methods = method_args.pop("methods")

    # --init_dataset names an alternate dataset whose points seed the
    # subsample init (engine kwarg init_dataset=(x, y); ref
    # psvi_classes.py:115,234 exposes it constructor-only)
    if isinstance(method_args.get("init_dataset"), str):
        pool = read_dataset(method_args["init_dataset"], test_ratio=method_args["test_ratio"],
                            data_folder=method_args["data_folder"])
        method_args["init_dataset"] = (pool.x, pool.y)

    if method_args.pop("trial_parallel", False):
        import torch.distributed as dist

        from psvi_torch.parallel import make_mesh, run_trials

        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(trial=method_args.pop("mesh_trial_axis", 0) or world)
        results = rec_dd()
        for dnm in datasets:
            data = read_dataset(dnm, test_ratio=method_args["test_ratio"],
                                data_folder=method_args["data_folder"])
            for nm in methods:
                kw = dict(method_args)
                for drop in ("num_trials", "coreset_sizes", "seed", "mesh_trial_axis"):
                    kw.pop(drop, None)
                kw["init_args"] = kw.pop("init_at", "subsample")
                for ps in method_args["coreset_sizes"]:
                    res = run_trials(data, method_args["num_trials"], method=nm, mesh=mesh,
                                     num_pseudo=ps, **_engine_kwargs(kw))
                    for t, r in enumerate(res):
                        results[dnm][nm][ps][t] = r
    else:
        results = experiment_driver(datasets, methods, method_args)

    # save layout parity with ref write_to_files (psvi_experiments.py:669-710):
    # --save_new_folder → timestamped subfolder; else flat into results_folder
    if method_args.get("save_new_folder", False):
        folder = get_save_foldername(
            method_args.get("results_folder", "results"), datasets, methods,
            method_args.get("mfvi_selection_method", "random"))
    else:
        folder = method_args.get("results_folder", "results")
    save_results(results, folder, config={**method_args, "datasets": datasets,
                                          "methods": methods},
                 fnm=method_args.get("fnm", "results"))
    if method_args.get("save_input_data", False):
        for dnm in datasets:
            data = _read(dnm, methods, method_args)
            np.savez(os.path.join(folder, f"input_data_{dnm}.npz"),
                     x=np.asarray(data.x), y=np.asarray(data.y),
                     xt=np.asarray(data.xt), yt=np.asarray(data.yt))
    print(f"results saved to {folder}")
    return results


if __name__ == "__main__":
    main()
