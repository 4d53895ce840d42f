"""Typed experiment configuration, and the method specifications.

A copy of ``psvi_tpu/utils/config.py``: ``ExperimentConfig``, the CLI's
flags as a dataclass with the same field names and defaults (ref
``psvi_experiments.py:50-380``; ``psvi_torch/experiments.py`` exposes the
same flags), and ``MethodSpec``/``METHOD_SPECS``, the PSVI subclass
lattice as static flags (ref ``psvi/inference/psvi_classes.py:1344-1934``).
The port keeps its own so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    # datasets / methods sweep (ref psvi_experiments.py:51-79)
    datasets: Tuple[str, ...] = ("halfmoon",)
    methods: Tuple[str, ...] = ("psvi_learn_v",)
    coreset_sizes: Tuple[int, ...] = (10,)
    num_trials: int = 1

    # scale (ref :80-102)
    mc_samples: int = 10
    num_epochs: int = 301
    data_minibatch: int = 128
    inner_it: int = 100
    outer_it: int = 100
    trainer: str = "nested"  # nested | hyper | joint | alternating
    hypergrad_approx: str = "cg_normaleq"  # cg_normaleq | fixed_point | neumann
    inner_optimizer: str = "adam"  # any key of ops/optim.REGISTRY
    stream_data: bool = False  # the train set in host memory
    diagonal: bool = True  # diagonal vs full covariance for the Laplace baselines
    # GIGA growth cadence: 'log_every' (the reference's) or 'every_step'
    giga_growth: str = "log_every"

    # architecture (ref :103-140)
    architecture: str = "logistic_regression"
    n_hidden: int = 40
    n_layers: int = 1
    init_sd: float = 1e-6

    # logging (ref :141-166)
    log_every: int = 10
    register_elbos: bool = False
    log_pseudodata: bool = False

    # learning rates (ref :167-229)
    lr0net: float = 1e-3
    lr0u: float = 1e-4
    lr0v: float = 1e-3
    lr0z: float = 1e-3
    lr0alpha: float = 1e-3
    lr0joint: float = 1e-3
    gamma: float = 1.0  # StepLR decay

    # init / lifecycle (ref :230-330)
    init_at: str = "subsample"  # random | subsample | custom | saved
    reset: bool = False
    reset_interval: int = 10
    prune: bool = False
    prune_interval: Optional[int] = None
    prune_sizes: Tuple[int, ...] = ()
    increment: bool = False
    increment_interval: Optional[int] = None
    increment_sizes: Tuple[int, ...] = ()
    retrain_on_coreset: bool = False
    learn_z: bool = False

    # data handling (ref :331-380)
    test_ratio: float = 0.2
    data_folder: str = "data"
    results_folder: str = "results"

    # selection subsystem
    mfvi_selection_method: str = "random"
    pretrain_epochs: int = 5
    load_from_saved: bool = False
    distance_fn: str = "euclidean"
    last_layer_only: bool = False
    loaded_from_psvi: bool = True
    multiple_pts_per_cluster: bool = True
    choose_difficult: bool = True
    scoring_run: bool = False
    alpha_dirichlet: float = 0.0

    # regression
    tau: float = 0.1

    # extras
    seed: int = 0
    compute_weights_entropy: bool = True
    fp64: bool = False  # float64 tensors (numerics debugging)
    debug_nans: bool = False  # torch.autograd.set_detect_anomaly(True)
    backend: str = "xla"  # dense products: 'xla' plain, 'pallas' kernel B3
    mesh_trial_axis: int = 1  # ranks on the mesh's trial axis
    mesh_data_axis: int = 1  # ranks on the mesh's data-batch axis
    compute_dtype: str = "float32"  # 'bfloat16': bf16 operands, fp32 loss math
    # the fused kernels (None = where supported on the card; True require;
    # False never)
    fused_inner: Optional[bool] = None
    # fold (conv, 2x2-maxpool) pairs into the pooled conv; False = literal
    fuse_convpool: bool = True
    pool_backend: str = "reshape"  # 'argmax' = gradient to the first argmax
    # JAX's lax.scan unroll of the inner loop; no effect on the port's loop
    inner_unroll: Optional[int] = None

    def method_kwargs(self, **overrides):
        d = dataclasses.asdict(self)
        d.update(overrides)
        return d


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Static structure of a PSVI-family method."""

    learn_v: bool = False
    parameterised: bool = False  # v on simplex via softmax (PSVILearnV)
    learn_alpha: bool = False  # global evidence rescaler (PSVIAV)
    learn_u: bool = True  # False for the FixedU variants
    learn_z: bool = False  # soft-label optimization
    no_rescaling: bool = False  # PSVI_No_Rescaling
    ablated: bool = False  # PSVI_Ablated objective
    single_sample_train: bool = False  # PSVI_No_IW
    evaluate_only: bool = False  # PSVIEvaluate
    # exp(alpha) applied in f(v) with alpha fixed (PSVIEvaluate)
    alpha_fixed: bool = False
    increment_compatible: bool = True
    regressor: bool = False


# name → spec, mirroring inf_dict (ref psvi_experiments.py:402-458)
METHOD_SPECS = {
    "psvi": MethodSpec(),
    "psvi_learn_v": MethodSpec(learn_v=True, parameterised=True),
    "psvi_no_rescaling": MethodSpec(no_rescaling=True),
    "psvi_free_v": MethodSpec(learn_v=True, parameterised=False),
    "psvi_ablated": MethodSpec(learn_v=True, parameterised=True, ablated=True),
    "psvi_no_iw": MethodSpec(
        learn_v=True, parameterised=True, ablated=True, single_sample_train=True
    ),
    "psvi_alpha_v": MethodSpec(learn_v=True, parameterised=True, learn_alpha=True),
    "psvi_fixed_u": MethodSpec(learn_v=True, parameterised=True, learn_u=False),
    "psvi_alpha_fixed_u": MethodSpec(
        learn_v=True, parameterised=True, learn_alpha=True, learn_u=False
    ),
    "psvi_evaluate": MethodSpec(
        learn_v=False,
        learn_u=False,
        learn_z=True,
        learn_alpha=False,
        parameterised=True,
        alpha_fixed=True,
        evaluate_only=True,
    ),
    "psvi_regressor": MethodSpec(regressor=True, learn_z=True),
    "psvi_learn_v_regressor": MethodSpec(
        learn_v=True, parameterised=True, regressor=True, learn_z=True
    ),
    "psvi_alpha_v_regressor": MethodSpec(
        learn_v=True, parameterised=True, learn_alpha=True, regressor=True,
        learn_z=True,
    ),
}
