"""PSVI inference engine — the four trainers of the port.

Counterpart of ``psvi_tpu/inference/psvi.py`` for the nested (bilevel)
trainer, the first-order ``joint`` and ``alternating`` trainers and the
implicit-differentiation ``hyper`` trainer, on the dense mean-field nets
(logistic regression and the ``fn`` MLP) and on LeNet with the categorical
likelihood (hard or learned soft labels), and on the regression MLP with
the Gaussian likelihood and learned targets (``PSVIRegressor``), for every
method of ``METHOD_SPECS``:

- ``PSVIState`` — parameters, pseudodata (u, z), weights v, α and the
  Adam states of the hyperparameters;
- ``_nested_step`` — the plain path: T differentiable inner Adam steps
  through ``torch.autograd`` (``create_graph=True``), the outer IW-ELBO,
  and its gradient w.r.t. (u, v, z, α) through the unroll (ref
  ``nested_step`` :541-600); with ``truncated``, T − K warm-up steps that
  are not differentiated, then K that are; with ``remat_inner``, each
  differentiated iteration recomputed in the backward pass; with no
  hyperparameters (``psvi_evaluate``), a net-only step;
- ``_nested_step_fused`` — the same step through the fused kernels of
  ``ops/fused_nested.py`` (hand-written CUDA on the card);
- ``_nested_step_fused_lenet`` — the LeNet step with its inner unroll
  through the kernel pair of ``ops/fused_lenet.py`` and the outer IW-ELBO
  through autograd;
- ``_joint_step`` and ``_alternating_step`` — single-level Adam steps on
  the outer objective (ref ``joint_step`` :517-525, ``alternating_step``
  :527-539), and ``_retrain_step``, the net-only step of the retrain loop;
  with ``backend="pallas"`` every batched dense forward on these paths goes
  through kernel B3 (``ops/sampled_linear.py``);
- ``_hyper_step`` — an inner solve that is not differentiated, then the
  hypergradient by an implicit-function solver of ``ops/hypergrad.py``
  (``cg_normaleq``, ``fixed_point`` or ``neumann``; ref ``hyper_step``
  :602-687);
- ``_evaluate_fn`` and the ``run_psvi`` loop with the reference's
  results-dict keys, the ``register_elbos`` streams, ``reset`` and
  ``retrain_on_coreset``; the loop's layer spans (``utils/resource.py::
  span``) ``psvi.step``, ``psvi.evaluate`` and ``psvi.readback``, and in
  the LeNet step and the plain nested step ``psvi.outer.fwd`` and
  ``psvi.outer.bwd`` (the kernel pair's own are ``psvi.unroll.fwd`` and
  ``psvi.unroll.rev``; the plain step's ``psvi.unroll.fwd`` is its
  differentiated inner loop, whose reverse runs inside ``psvi.outer.bwd``);
  ``UNROLL`` counts the plain step's differentiated inner iterations and
  the memory their graph holds for the reverse;
- ``PSVIRegressor`` — the Gaussian likelihood at precision ``tau``, the
  pseudo-targets z learned with the other hyperparameters, RMSE and
  predictive-LL evaluation;
- the coreset lifecycle (JAX ``psvi.py:1380-1838``): ``prune_coreset``,
  the incremental (class-by-class) coreset with replay
  (``increment_coreset``, ``sample_replay_indices``,
  ``_advance_increment_task``), ``save_checkpoint``/``load_checkpoint``
  (bit-exact resume), ``load_saved_coreset`` (warm start from a saved
  run), ``reseed``, ``pred_on_grid``, the data-difficulty scoring run and
  ``profile_dir``. A change of M or of the class count re-chooses the step
  (``_rebuild``), so the fused gates are checked again at the new shape;
- the engine options (JAX ``psvi.py:120-181``): the inner optimizer by
  name (``ops/optim.REGISTRY``), ``compute_dtype`` (bf16 operands, fp32
  loss math), ``pool_backend`` and ``fuse_convpool`` (the literal conv →
  MaxPool2d LeNet, which the LeNet kernel pair also serves), ``packed``
  (``models/packed.py``), ``fused_eps`` and ``inner_unroll``;
- parallelism (JAX ``psvi.py:180-193``, ``:309-370``): ``mesh`` with
  ``shard_batch`` (this rank's rows of every minibatch) and ``shard_mc``
  (this rank's MC samples), the objectives' sums over either axis as
  all-reduces (``parallel/mesh.py``); ``stream_data`` (the train set in
  host memory, each block's batches gathered there and shipped in one
  copy); and the seam of the trial runner (``parallel/trials.py``): under
  ``_in_trial_vmap`` the step takes every gradient through ``torch.func``
  so that ``torch.func.vmap`` batches it over a leading trial axis.

Noise, batches and initial parameters come from one ``torch.Generator``
per engine on its device, seeded from ``seed`` (the JAX engine's
``trial_key``). The pseudodata init is host-side NumPy and draws the same
points as the JAX engine for the same seed.

The trainers' steps and the regressor's evaluation accept injected batches
and noise; the tests use that seam to line the port up with JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from psvi_torch.data.datasets import DataBundle
from psvi_torch.device import resolve_device
from psvi_torch.inference.cuda_graph import EvalGraph, StepGraph
from psvi_torch.models.layers import (VILinear, fuse_conv_pool, with_compute_dtype,
                                     with_dense_backend, with_pool_backend)
from psvi_torch.models.networks import set_up_model
from psvi_torch.models.packed import pack_net
from psvi_torch.ops import elbo as E
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import fused_nested as FN
from psvi_torch.ops import hypergrad as H
from psvi_torch.ops import optim as O
from psvi_torch.utils.checkpoint import load_state, save_state
from psvi_torch.utils.config import METHOD_SPECS
from psvi_torch.utils.resource import LogResource, span
from psvi_torch.utils.results import retrieve_results
from psvi_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class FlatEps(NamedTuple):
    """A fused step's noise as it draws it under ``fused_eps="batched"``:
    the inner noise in the kernels' flat (T, n_eps) layout, and the outer
    draw (flat for the dense kernels, a tree for LeNet)."""

    inner: torch.Tensor
    outer: Any


def _flat_eps(eps, pack_eps, didx, pack_outer=False):
    """A fused step's ``eps`` as ``(flat inner draw, outer part)``: a
    ``FlatEps`` as it is; injected or ``"stream"`` trees ``(T inner trees,
    outer tree)`` with each inner tree's layers ``didx`` packed by the
    kernels' ``pack_eps``, and the outer tree too where ``pack_outer``."""
    if isinstance(eps, FlatEps):
        return eps
    eps_inner, eps_outer = eps
    e_in = torch.stack([pack_eps([e[i] for i in didx]) for e in eps_inner])
    return e_in, pack_eps([eps_outer[i] for i in didx]) if pack_outer else eps_outer


class PSVIState(NamedTuple):
    params: Any  # tuple over net.layers of parameter dicts
    u: torch.Tensor  # pseudo-inputs (M, D), or (M, C, H, W) for images
    z: torch.Tensor  # pseudo-labels or regression pseudo-targets (M,), float
    v: torch.Tensor  # raw log-likelihood weights (M,)
    alpha: torch.Tensor  # global evidence rescaler (1,)
    opt_u: Any
    opt_v: Any
    opt_z: Any
    opt_alpha: Any
    opt_net: Any  # the net's Adam (alternating trainer, retrain loop)
    opt_joint: Any  # the joint trainer's Adam over {params, u[, v]}
    net_step: int  # StepLR counter


#: The plain nested step's differentiated unroll: ``iterations``, the inner
#: iterations run with their graph kept (or recomputed, under ``remat``);
#: ``remat``, whether the last step ran under ``remat_inner``;
#: ``resident_bytes``, the device memory the last step's unroll left
#: allocated for the reverse (``torch.cuda.memory_allocated`` after it less
#: before it: the allocator's host-side count, no synchronise; 0 off the
#: card), and ``resident_bytes_max``, the largest such reading.
UNROLL = {"iterations": 0, "remat": False, "resident_bytes": 0, "resident_bytes_max": 0}


def reset_unroll():
    UNROLL.update(iterations=0, remat=False, resident_bytes=0, resident_bytes_max=0)


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _real():
    """The engines' floating dtype: float32, or the default dtype where a
    caller made it float64 (the CLI's ``--fp64``)."""
    return torch.get_default_dtype()


def _count_pad(n, b):
    return (b - n % b) % b


def _value_grad_aux(fn, hyper: dict, functional: bool):
    """``fn(hyper) = (loss, aux)``: the detached loss, its gradient with
    respect to each entry of ``hyper``, and ``aux``; through
    ``torch.autograd``, or through ``torch.func`` when ``functional``."""
    if functional:
        grads, (loss, aux) = torch.func.grad_and_value(fn, has_aux=True)(hyper)
        return loss.detach(), grads, aux
    with torch.enable_grad():
        leaves = {k: x.detach().clone().requires_grad_(True) for k, x in hyper.items()}
        loss, aux = fn(leaves)
        with span("psvi.outer.bwd"):
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.detach(), grads, aux


class PSVI:
    """Black-box coreset VI engine (classification).

    ``trainer``: ``"nested"`` (bilevel, the default), ``"joint"``,
    ``"alternating"`` or ``"hyper"`` (implicit differentiation by the solver
    ``hypergrad_approx`` ∈ {``"cg_normaleq"``, ``"fixed_point"``,
    ``"neumann"``}, ``hyper_K`` iterations, fixed-point map one gradient
    step at ``linsys_lr``). ``truncated``: differentiate only the last
    ``truncated_K`` of the ``inner_it`` inner steps. ``remat_inner``:
    recompute each differentiated inner iteration in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its graph. ``learn_z``:
    learn the pseudo-labels too (soft labels under the categorical
    likelihood). ``backend``: ``"xla"`` (the plain dense product) or
    ``"pallas"`` — JAX's two values, so that a JAX config selects the same
    path; in the port ``"pallas"`` means the hand-written CUDA kernel B3 for
    every batched dense forward. Its backward is first-order only, so the
    nested and hyper trainers refuse it, as the JAX engine does.

    ``device=None`` means CUDA (raises without a GPU); pass ``device="cpu"``
    for the plain PyTorch path on the CPU. ``fused_inner``: ``"auto"`` uses
    the fused kernels on CUDA whenever :func:`ops.fused_nested.supports`
    (the dense step) or :func:`ops.fused_lenet.supports` (the LeNet inner
    unroll) holds; ``True`` requires them (on the CPU their plain versions
    run); ``False`` always takes the plain autograd step.

    One deliberate difference from the JAX engine: ``"auto"`` selects the
    LeNet kernel pair on CUDA. The JAX engine never auto-selected its
    Pallas pair because of the Mosaic compile envelope (S ≤ 4, M·P1² ≤
    4096); the CUDA kernels have no such envelope.

    The lifecycle options, with JAX's defaults and meanings: ``prune``
    down-samples the coreset to ``prune_sizes[i]`` after step
    ``(i + 1)·prune_interval``; ``increment`` starts on classes {0, 1} at
    M = ``increment_sizes[0]`` and adds one class and its points every
    ``increment_interval`` steps, the train set then the new class plus a
    replay drawn from the coreset; ``log_pseudodata`` logs u, z and, for
    2-D inputs, ``pred_on_grid`` at every evaluation; ``scoring_run``
    tracks forgetting events and writes the data-difficulty scores and the
    embeddings as CSV files into ``data_folder``, named by ``dnm`` and the
    seed; ``results_folder`` is where ``load_saved_coreset`` looks;
    ``init_dataset`` = (x, y) is the pool the pseudodata init subsamples
    in place of the train set; ``profile_dir`` writes a torch.profiler
    Chrome trace of the run there. The step is re-chosen after each prune
    and increment, so a shape the fused gate refuses takes the plain step
    (and ``fused_inner=True`` raises there).

    The engine options, with JAX's defaults and errors:

    - ``inner_optimizer``: the inner loop's optimizer by name, any key of
      ``ops/optim.REGISTRY`` (case-insensitive; ``ValueError`` otherwise),
      at lr0net; the nested, truncated and hyper steps take it, the
      truncated warm-up keeps its own Adam(1e-4). Both fused gates require
      ``"adam"``.
    - ``compute_dtype``: ``"bfloat16"`` casts the matmul and conv operands
      and keeps the activations bf16 between layers; parameters, KL, NKL
      and the loss math stay float32 (``models/layers.with_compute_dtype``).
      B3 is float32 only, so its layers take the plain product; both fused
      gates refuse any other dtype than float32.
    - ``pool_backend``: ``"reshape"`` or ``"argmax"`` (the gradient to each
      window's first argmax, ``layers._argmax_pool``). Another backend than
      ``"reshape"``, ``fuse_convpool=False`` or ``packed`` keeps the literal
      conv → MaxPool2d net; else conv + pool pairs fold into the
      parity-split pooled conv. The LeNet kernel pair serves both forms.
    - ``packed``: the flat ``{mu, rho}`` net of ``models/packed.py``
      (``ValueError`` where it cannot be packed); the fused gates refuse it.
    - ``fused_eps``: the fused steps' noise. ``"batched"`` draws the inner
      noise in the kernels' flat layout in one ``torch.randn`` a step;
      ``"stream"`` draws it as ``_nested_step`` does (the batch, T
      ``_sample_eps``, the outer draw) and packs it, so from one generator
      state the fused and plain steps see the same ε. JAX's ``"batched"``
      LeNet mode draws the noise in the kernel (``eps_mode="prng"``); the
      port reads a drawn ε instead (ROADMAP.md §B).
    - ``inner_unroll``: ``None`` or an integer, stored as ``max(int(x), 1)``.
      It unrolls JAX's ``lax.scan``, which has no torch meaning: the port's
      inner loop is a Python loop, and the option has no effect.
    - ``spec``: a ``MethodSpec`` in place of ``METHOD_SPECS[method]``.

    ``init_args="custom"`` picks the initial pseudodata by
    ``inference/selection.py::CoresetSelect`` with ``mfvi_selection_method``
    as its ``score_method`` (JAX's default ``"random"``), and the raw v
    standard normal. The selection options keep JAX's names and defaults:
    ``pretrain_epochs`` (the MFVI pretraining of the score and embedding
    methods), ``load_from_saved``, ``multiple_pts_per_cluster``,
    ``alpha_dirichlet``, ``choose_difficult``, ``distance_fn``,
    ``last_layer_only`` and ``loaded_from_psvi`` (the scores and embeddings
    of a scoring run, read from ``data_folder``). The step is then chosen
    as for any other init: B1 on the dense nets, B2 on LeNet.

    Parallelism, with JAX's names, defaults and errors (``mesh`` from
    ``parallel.make_mesh``; every rank builds the engine and runs the same
    calls): ``shard_batch`` splits each minibatch's rows over the mesh's
    ``data`` axis, the minibatch rounded down to a multiple of the axis;
    ``shard_mc`` splits the S (and S_eval) samples over its ``mc`` axis,
    which must divide them. Every rank draws the whole batch and noise from
    the same generator and keeps its own rows or samples; the gradients of
    a loss that sums over an axis are averaged over it. They serve the
    nested (plain step), joint and alternating trainers, the retrain loop
    and the evaluations; the hyper trainer (its ``torch.func`` products
    cannot pass a collective) and ``shard_batch`` with learned soft labels
    (their softmax runs over the whole batch) raise. ``stream_data`` keeps
    the train set in host memory (``x_train`` stays a CPU tensor): the
    batch indices are drawn on the device from the engine's generator, as
    in a resident run, and each log block's are copied to the host in one
    copy, its rows gathered there and shipped in one copy; the run equals
    the resident one bit for bit. It refuses ``increment``. The fused
    gates refuse ``shard_batch``, ``shard_mc`` and a vmapped trial, as
    JAX's do; streamed batches go through them.
    """

    # set only while the trial runner resolves the step (parallel/trials.py)
    _in_trial_vmap = False

    likelihood = "categorical"

    def __init__(
        self,
        data: DataBundle,
        method: str = "psvi_learn_v",
        num_pseudo: int = 10,
        seed: int = 0,
        mc_samples: int = 10,
        architecture: str = "logistic_regression",
        n_hidden: int = 40,
        n_layers: int = 1,
        init_sd: float = 1e-3,
        data_minibatch: int = 128,
        inner_it: int = 10,
        trainer: str = "nested",
        lr0net: float = 1e-3,
        lr0u: float = 1e-4,
        lr0v: float = 1e-3,
        lr0z: float = 1e-3,
        lr0alpha: float = 1e-3,
        lr0joint: float = 1e-3,
        gamma: float = 1.0,
        num_epochs: int = 100,
        log_every: int = 10,
        register_elbos: bool = False,
        init_args: str = "subsample",
        learn_z=None,
        reset: bool = False,
        reset_interval: int = 10,
        prune: bool = False,
        prune_interval=None,
        prune_sizes: tuple = (),
        increment: bool = False,
        increment_interval=None,
        increment_sizes: tuple = (),
        retrain_on_coreset: bool = False,
        log_pseudodata: bool = False,
        compute_weights_entropy: bool = True,
        tau: float = 0.1,
        hyper_K: int = 30,
        linsys_lr: float = 1e-4,
        hypergrad_approx: str = "cg_normaleq",
        truncated: bool = False,
        truncated_K: int = 5,
        remat_inner: bool = False,
        backend: str = "xla",
        fused_inner="auto",
        data_folder=None,
        results_folder=None,
        dnm: str = "data",
        scoring_run: bool = False,
        profile_dir=None,
        init_dataset=None,
        inner_optimizer: str = "adam",
        inner_unroll=None,
        compute_dtype: str = "float32",
        pool_backend: str = "reshape",
        fuse_convpool: bool = True,
        fused_eps: str = "batched",
        packed=None,
        mfvi_selection_method: str = "random",
        pretrain_epochs: int = 5,
        load_from_saved: bool = False,
        multiple_pts_per_cluster: bool = True,
        alpha_dirichlet: float = 0.0,
        choose_difficult: bool = True,
        distance_fn: str = "euclidean",
        last_layer_only: bool = False,
        loaded_from_psvi: bool = False,
        spec=None,
        mesh=None,
        shard_batch: bool = False,
        shard_mc: bool = False,
        stream_data: bool = False,
        device=None,
    ):
        if inner_optimizer.lower() not in O.REGISTRY:
            raise ValueError(f"unknown inner_optimizer {inner_optimizer!r}; "
                             f"available: {sorted(O.REGISTRY)}")
        if fused_eps not in ("batched", "stream"):
            raise ValueError(f"unknown fused_eps {fused_eps!r}")
        if backend == "pallas" and trainer in ("nested", "hyper"):
            raise ValueError(
                "backend='pallas' serves first-order paths only (joint/alternating "
                "trainers, retrain, evaluation): the nested trainer differentiates twice "
                "through the layer and the hyper trainer applies forward mode to it; the "
                "kernel's autograd Function gives neither"
            )
        if trainer not in ("nested", "joint", "alternating", "hyper"):
            raise ValueError(f"unknown trainer {trainer!r}")
        if hypergrad_approx not in ("cg_normaleq", "fixed_point", "neumann"):
            raise ValueError(f"unknown hypergrad_approx {hypergrad_approx!r} "
                             "(expected cg_normaleq | fixed_point | neumann)")
        if truncated and not 1 <= truncated_K <= inner_it:
            raise ValueError(f"truncated_K must lie in [1, inner_it={inner_it}], "
                             f"got {truncated_K}")
        if fused_inner not in ("auto", True, False):
            raise ValueError(f"fused_inner must be 'auto', True or False, got {fused_inner!r}")
        self.device = resolve_device(device)
        self.data = data
        self.method = method
        self.spec = spec if spec is not None else METHOD_SPECS[method]
        if learn_z:
            self.spec = dataclasses.replace(self.spec, learn_z=True)
        self.seed = seed
        # N stays the full data.N under increment, as in JAX: the core
        # weights N·f(v) and the StepLR quarter read it
        self.N, self.D, self.nc = data.N, data.D, data.nc
        self.num_pseudo = increment_sizes[0] if increment and increment_sizes else num_pseudo
        # PSVI_No_IW trains on one sample and evaluates on five (ref :1411-1472)
        self.mc_samples = 1 if self.spec.single_sample_train else mc_samples
        self.mc_samples_eval = 5 if self.spec.single_sample_train else mc_samples
        self.architecture = architecture
        self.n_hidden, self.n_layers, self.init_sd = n_hidden, n_layers, init_sd
        self.inner_it = inner_it
        self.trainer = trainer
        self.lrs = dict(net=lr0net, u=lr0u, v=lr0v, z=lr0z, alpha=lr0alpha, joint=lr0joint)
        self.gamma = gamma
        self.num_epochs = num_epochs
        self.log_every = log_every
        self.register_elbos = register_elbos
        self.init_args = init_args
        self.reset, self.reset_interval = reset, reset_interval
        self.prune, self.prune_interval = prune, prune_interval
        self.prune_sizes = tuple(prune_sizes or ())
        self.increment, self.increment_interval = increment, increment_interval
        self.increment_sizes = tuple(increment_sizes or ())
        self.log_pseudodata = log_pseudodata
        self.data_folder, self.results_folder, self.dnm = data_folder, results_folder, dnm
        self.scoring_run = scoring_run
        self.profile_dir = profile_dir
        self.init_dataset = init_dataset
        self.retrain_on_coreset = retrain_on_coreset
        self.backend = backend
        self.compute_weights_entropy = compute_weights_entropy
        self.tau = tau
        self.hyper_K, self.linsys_lr = hyper_K, linsys_lr
        self.hypergrad_approx = hypergrad_approx
        self.truncated, self.truncated_K = truncated, truncated_K
        self.remat_inner = remat_inner
        self.fused_inner = fused_inner
        self.inner_optimizer = inner_optimizer.lower()
        self.inner_unroll = None if inner_unroll is None else max(int(inner_unroll), 1)
        self.compute_dtype, self.pool_backend = compute_dtype, pool_backend
        self.fuse_convpool, self.fused_eps, self.packed = fuse_convpool, fused_eps, packed
        # the selection of init_args='custom' (inference/selection.py::CoresetSelect)
        self.mfvi_selection_method, self.pretrain_epochs = mfvi_selection_method, pretrain_epochs
        self.load_from_saved, self.loaded_from_psvi = load_from_saved, loaded_from_psvi
        self.multiple_pts_per_cluster = multiple_pts_per_cluster
        self.alpha_dirichlet, self.choose_difficult = alpha_dirichlet, choose_difficult
        self.distance_fn, self.last_layer_only = distance_fn, last_layer_only
        self._custom_v = None
        self._eval_graph, self._eval_test = EvalGraph(), None
        self._step_graph = StepGraph()
        self._setup_parallel(mesh, shard_batch, shard_mc, stream_data)
        self.elbos: list = []
        self.results: dict = {}
        self.chosen_indices: list = []
        # the scoring run's per-datapoint trackers (_forgetting_calculator)
        self.forgetting_events = self.last_acc = self.never_learnt = None

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

        self.data_minibatch = min(data_minibatch, self.N)
        if self.increment:  # the first task: classes {0, 1} (ref run_psvi :823-832)
            self.nc = 2
            self._reset_increment_data()
        else:
            self._set_data(data.x, data.y, data.xt, data.yt)
        self._build_model()
        self._init_state()
        self._rebuild()
        # what prune and increment change, for reseed
        self._orig_num_pseudo, self._orig_nc = self.num_pseudo, self.nc

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def _setup_parallel(self, mesh, shard_batch, shard_mc, stream_data):
        """The mesh's data and mc axes, as the objectives see them, and the
        streamed train set, with JAX's checks (``psvi.py:309-370``)."""
        from psvi_torch.parallel.mesh import AxisShard, axis_size

        if stream_data and self.increment:
            raise ValueError(
                "stream_data is incompatible with incremental learning "
                "(the growing task re-materializes the train set; "
                "incremental datasets are small by construction)")
        self.stream_data = stream_data
        self._stream_block: list = []
        self.mesh = mesh
        self.data_shard = AxisShard(mesh, "data") if mesh is not None and shard_batch else None
        self.shard_mc = bool(shard_mc)
        self.mc_shard = None
        if self.shard_mc:
            if mesh is None or "mc" not in mesh.mesh_dim_names:
                raise ValueError("shard_mc=True needs a mesh with an 'mc' axis "
                                 "(parallel.make_mesh(mc=...))")
            msize = axis_size(mesh, "mc")
            if self.mc_samples % msize or self.mc_samples_eval % msize:
                raise ValueError(
                    f"mc_samples ({self.mc_samples}) and mc_samples_eval "
                    f"({self.mc_samples_eval}) must be divisible by the "
                    f"mesh 'mc' axis size ({msize})")
            self.mc_shard = AxisShard(mesh, "mc")
        if self.data_shard or self.mc_shard:
            if self.trainer == "hyper":
                raise ValueError("shard_batch and shard_mc serve the nested, joint and "
                                 "alternating trainers: the hyper trainer's torch.func "
                                 "Jacobian products cannot pass a collective")
            if self.data_shard and self._learn_z_kldiv:
                raise ValueError("shard_batch with learned soft labels (learn_z): the "
                                 "soft-label NLL normalises over the whole batch")

    def _set_data(self, x, y, xt, yt):
        """Put the current train and test sets on the device (under
        ``stream_data`` the train set in host memory); the minibatch shrinks
        to a smaller train set and never grows back, and under
        ``shard_batch`` is rounded down to a multiple of the data axis."""
        dev = self.device
        host = torch.device("cpu") if self.stream_data else dev
        self.x_train = torch.as_tensor(x, dtype=_real(), device=host)
        self.y_train = torch.as_tensor(y, dtype=_real(), device=host)
        self.x_test = torch.as_tensor(xt, dtype=_real(), device=dev)
        self.y_test = torch.as_tensor(yt, dtype=_real(), device=dev)
        self.n_train_now = int(self.x_train.shape[0])
        self.data_minibatch = min(self.data_minibatch, self.n_train_now)
        if self.data_shard is not None:
            dsize = self.data_shard.size
            self.data_minibatch = max(dsize, (self.data_minibatch // dsize) * dsize)

    def _reset_increment_data(self):
        """The incremental run's first task, classes {0, 1} (JAX
        ``_reset_increment_data``)."""
        d = self.data
        tr, te = np.isin(d.y, [0, 1]), np.isin(d.yt, [0, 1])
        self._set_data(d.x[tr], d.y[tr], d.xt[te], d.yt[te])
        self.train_data_so_far = self.n_train_now

    def _build_model(self):
        """The net at the current class count, in JAX ``_build_model``'s
        order: the compute dtype; then the pool backend, or, unless packed,
        conv + max-pool pairs folded into the parity-split pooled conv
        (``fuse_convpool``); then the dense backend; then packing."""
        net = set_up_model(self.architecture, self.D, self.n_hidden, self.nc, self.init_sd,
                           n_layers=self.n_layers, n_channels=self.data.channels or 1)
        if self.compute_dtype != "float32":
            net = with_compute_dtype(net, self.compute_dtype)
        if self.pool_backend != "reshape":
            net = with_pool_backend(net, self.pool_backend)
        elif self.fuse_convpool and not self.packed:
            net = fuse_conv_pool(net)
        if self.backend != "xla":
            net = with_dense_backend(net, self.backend)
        if self.packed:
            packed = pack_net(net)
            if packed is None:
                raise ValueError(f"packed=True unsupported for architecture "
                                 f"{self.architecture!r} (non-mean-field or stateful layers)")
            net = packed
        self.net = net.to(self.device)

    def _rebuild(self):
        """Re-choose the step for the current M, class count and minibatch
        (JAX ``_compile``): the fused gates are checked again."""
        self._step, self._draw_eps = self._trainer_fn()

    def _core_weights(self, v, alpha):
        """N·f(v) and f(v) (ref ``psvi_classes.py:111,1358-1360,1486-1488``)."""
        fv = torch.softmax(v, dim=0) if self.spec.parameterised else v
        if self.spec.learn_alpha or self.spec.alpha_fixed:
            fv = torch.exp(alpha[0]) * fv
        return self.N * fv, fv

    def _init_pool(self):
        """The (x, y) the pseudodata init draws from, as NumPy arrays:
        ``init_dataset`` when given (ref :115,234), else the current train
        set (under ``increment`` the first task's, not ``data.x``)."""
        if self.init_dataset is not None:
            return np.asarray(self.init_dataset[0]), np.asarray(self.init_dataset[1])
        return self.x_train.cpu().numpy(), self.y_train.cpu().numpy()

    def _init_pseudodata(self):
        """Pseudodata init (ref :229-308) on the host with NumPy, the same
        draws as the JAX engine: 'subsample' = class-balanced random subset
        of the current train set, or of ``init_dataset`` when one is given;
        'saved' the same ('load_saved_coreset' warm-starts from a stored
        run); 'random' = noisy empirical mean + balanced labels; 'custom' =
        the points ``CoresetSelect`` picks (``_custom_init``)."""
        M, nc = self.num_pseudo, self.nc
        x_np, y_np = self._init_pool()
        rng = np.random.default_rng(self.seed)
        ppc = [M // nc] * nc
        ppc[-1] = M - sum(ppc[:-1])
        self._custom_v = None
        if self.init_args == "custom":
            return self._custom_init(x_np, y_np, rng)
        if self.init_args in ("subsample", "saved"):
            us, zs, idcs = [], [], []
            for c in range(nc):
                cls_idx = np.where(y_np == c)[0]
                take = rng.choice(cls_idx, size=ppc[c], replace=len(cls_idx) < ppc[c])
                us.append(x_np[take])
                zs.append(np.full(ppc[c], c, dtype=np.float32))
                idcs.extend(take.tolist())
            u, z = np.concatenate(us), np.concatenate(zs)
            self.chosen_indices = idcs
        elif self.init_args == "random":
            mean = x_np.mean(axis=0, keepdims=True)
            u = mean + 1.0 * rng.standard_normal((M,) + x_np.shape[1:]).astype(np.float32)
            z = np.concatenate([np.full(p, c, dtype=np.float32) for c, p in enumerate(ppc)])
        else:
            raise ValueError(f"unknown init_args {self.init_args!r}")
        dev = self.device
        return (torch.as_tensor(u, dtype=_real(), device=dev),
                torch.as_tensor(z, dtype=_real(), device=dev))

    def _custom_init(self, x_np, y_np, rng):
        """Pseudodata chosen by ``CoresetSelect`` with
        ``mfvi_selection_method`` (JAX ``_init_pseudodata``'s custom branch;
        ref ``custom_init`` :310-375): its points and labels, and raw v
        drawn standard normal from the engine's NumPy stream."""
        from psvi_torch.inference.selection import CoresetSelect

        sel = CoresetSelect(
            x_np, y_np, self.x_test.cpu().numpy(), self.y_test.cpu().numpy(),
            num_pseudo=self.num_pseudo, nc=self.nc, architecture=self.architecture, D=self.D,
            n_hidden=self.n_hidden or 100, mc_samples=self.mc_samples, init_sd=self.init_sd,
            data_minibatch=self.data_minibatch, pretrain_epochs=self.pretrain_epochs,
            lr0net=self.lrs["net"], seed=self.seed, score_method=self.mfvi_selection_method,
            data_folder=self.data_folder, load_from_saved=self.load_from_saved, dnm=self.dnm,
            multiple_pts_per_cluster=self.multiple_pts_per_cluster,
            alpha_dirichlet=self.alpha_dirichlet, choose_difficult=self.choose_difficult,
            distance_fn=self.distance_fn, last_layer_only=self.last_layer_only,
            loaded_from_psvi=self.loaded_from_psvi, n_channels=self.data.channels or 1,
            device=self.device)
        idx, xs, zs, _ = sel.select_data()
        self.chosen_indices = idx
        dev = self.device
        self._custom_v = torch.as_tensor(rng.standard_normal(self.num_pseudo).astype(np.float32),
                                         dtype=_real(), device=dev)
        return (torch.as_tensor(np.asarray(xs), dtype=_real(), device=dev),
                torch.as_tensor(np.asarray(zs), dtype=_real(), device=dev))

    def _init_v(self):
        M = self.num_pseudo
        if self._custom_v is not None:
            return self._custom_v  # custom selection init: raw v ~ N(0, 1) (ref :373-374)
        if self.spec.parameterised:
            return torch.zeros(M, device=self.device)  # PSVILearnV (:1353-1357)
        v = torch.full((M,), 1.0 / M, device=self.device)
        if self.spec.no_rescaling:
            v = v / self.N  # PSVI_No_Rescaling (:1371-1373)
        return v

    def _init_state(self):
        params = self.net.init(self.gen)
        u, z = self._init_pseudodata()
        if self._learn_z_kldiv:  # soft labels start one-hot (ref :552-553)
            z = torch.nn.functional.one_hot(z.long(), self.nc).to(_real())
        v = self._init_v()
        alpha = torch.zeros(1, device=self.device)
        self.opt_u = O.adam(self.lrs["u"])
        self.opt_v = O.adam(self.lrs["v"])
        self.opt_z = O.adam(self.lrs["z"])
        self.opt_alpha = O.adam(self.lrs["alpha"])
        self.opt_net = O.adam(self.lrs["net"])
        self.opt_joint = O.adam(self.lrs["joint"])
        # the retrain loop takes a fresh Adam at lr0joint (ref :971)
        self.opt_retrain = O.adam(self.lrs["joint"])
        self.inner_opt = O.make(self.inner_optimizer, self.lrs["net"])
        # StepLR schedule for the net lr (ref :803-807,864-866)
        epoch_quarter = (self.N // self.data_minibatch) // 4
        self.lr_net_sched = O.step_lr(
            self.lrs["net"], epoch_quarter if epoch_quarter > 0 else 10000, self.gamma)
        self.state = PSVIState(
            params=params, u=u, z=z, v=v, alpha=alpha,
            opt_u=self.opt_u.init(u), opt_v=self.opt_v.init(v), opt_z=self.opt_z.init(z),
            opt_alpha=self.opt_alpha.init(alpha), opt_net=self.opt_net.init(params),
            opt_joint=self.opt_joint.init(self._joint_leaves(params, u, v)), net_step=0,
        )

    def _joint_leaves(self, params, u, v):
        """What the joint trainer learns: the net, u and, where v is learned,
        v; z and α are not (ref optimizer :876-882)."""
        leaves = {"params": params, "u": u}
        if self.spec.learn_v:
            leaves["v"] = v
        return leaves

    def weight_reset(self):
        """Reinitialise the variational parameters and the net's Adam (ref
        :1110-1128)."""
        params = self.net.init(self.gen)
        self.state = self.state._replace(params=params, opt_net=self.opt_net.init(params))

    def reseed(self, seed: int):
        """Re-initialise for a new trial of the same static config (JAX
        ``reseed``): the original M, class count and, under ``increment``,
        the first task's data come back, then a fresh state from ``seed``."""
        self.seed = seed
        self.gen.manual_seed(seed)
        self.elbos, self.results, self.chosen_indices = [], {}, []
        self.forgetting_events = self.last_acc = self.never_learnt = None
        if self.num_pseudo != self._orig_num_pseudo or self.nc != self._orig_nc:
            self.num_pseudo, self.nc = self._orig_num_pseudo, self._orig_nc
            if self.increment:
                self._reset_increment_data()
            self._build_model()
        self._init_state()
        self._rebuild()

    # ------------------------------------------------------------------
    # lifecycle: checkpoints, saved coresets, prune, increment
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str):
        """The whole state and the generator's state in one ``.npz``, for a
        bit-exact resume (JAX ``save_checkpoint``; the generator's state
        takes the place of JAX's key)."""
        save_state(path, self.state, extra={"gen": self.gen.get_state()})

    def load_checkpoint(self, path: str):
        """Resume from ``save_checkpoint``'s file, written by an engine of
        the same static config (``ValueError`` otherwise)."""
        state, extra = load_state(path, self.state)
        if "gen" not in extra:
            raise ValueError(f"{path}: no generator state; not a checkpoint of this package")
        self.state = state
        self.gen.set_state(torch.as_tensor(extra["gen"], dtype=torch.uint8))

    def load_saved_coreset(self, subfolder_name: str, dataset: str, method: str,
                           coreset_size: int, trial: int = 0, ablated_weights: bool = True,
                           ablated_alpha: bool = True, ablated_labels: bool = True,
                           fnm: str = "results"):
        """Warm-start the coreset from a saved run (JAX
        ``load_saved_coreset``; ref ``custom_init_evaluate`` :377-442): the
        stored chosen points of the train set, and the stored weights, α and
        labels unless ablated; ablated weights are drawn standard normal
        from NumPy's ``default_rng(seed)``, ablated α is 0 and ablated
        labels are the points' own. The Adam states of u, v, z and α start
        fresh."""
        d = retrieve_results(self.results_folder or "results", subfolder_name, dataset,
                             method, coreset_size, trial, fnm=fnm)
        rng = np.random.default_rng(self.seed)
        dev = self.device
        self.chosen_indices = [int(i) for i in d["chosen_indices"]]
        idx = torch.as_tensor(self.chosen_indices, dtype=torch.long, device=self.x_train.device)
        u = self.x_train[idx].to(dev)
        if ablated_labels or d["labels"] is None:
            z = self.y_train[idx].to(dev)
        else:
            z = torch.as_tensor(d["labels"], dtype=_real(), device=dev)
        if self._learn_z_kldiv and z.dim() == 1:
            z = torch.nn.functional.one_hot(z.long(), self.nc).to(_real())
        if ablated_weights or d["weights"] is None:
            v = rng.standard_normal(self.num_pseudo).astype(np.float32)
        else:
            v = d["weights"]
        v = torch.as_tensor(v, dtype=_real(), device=dev)
        alpha = (torch.zeros(1, device=dev) if ablated_alpha else
                 torch.as_tensor(np.atleast_1d(d["alpha"]), dtype=_real(), device=dev))
        self.state = self.state._replace(
            u=u, z=z, v=v, alpha=alpha, opt_u=self.opt_u.init(u), opt_v=self.opt_v.init(v),
            opt_z=self.opt_z.init(z), opt_alpha=self.opt_alpha.init(alpha))

    def prune_coreset(self, to_size: int, keep=None):
        """Down-sample the coreset to ``to_size`` points drawn without
        replacement with probabilities f(v)/Σf(v) (JAX ``prune_coreset``;
        ref :1177-1192); ``keep`` hands in the indices instead. v restarts
        at 0, and the Adam states of u, v, z, the net and the joint trainer
        restart at the new M."""
        st = self.state
        if keep is None:
            _, fv = self._core_weights(st.v, st.alpha)
            keep = torch.multinomial(fv / fv.sum(), to_size, replacement=False,
                                     generator=self.gen)
        keep = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        self._set_coreset(st.u[keep], st.z[keep], torch.zeros(to_size, device=self.device))

    def increment_coreset(self, to_size: int, new_class: int, increment_idx: int):
        """Grow the coreset to ``to_size`` with points of ``new_class``
        (JAX ``increment_coreset``; ref :1194-1217), drawn from the whole
        train set by NumPy's ``default_rng(seed + increment_idx)`` (under
        ``init_args='random'``, noisy means); the new weights are Σv/to_size.
        The Adam states of u, v, z, α, the net and the joint trainer
        restart at the new M."""
        st = self.state
        dev = self.device
        n_extra = to_size - int(st.v.shape[0])
        v = torch.cat([st.v, (torch.sum(st.v) / to_size) * torch.ones(n_extra, device=dev)])
        if self.increment:
            x_np, y_np = np.asarray(self.data.x), np.asarray(self.data.y)
        else:
            x_np, y_np = self.x_train.cpu().numpy(), self.y_train.cpu().numpy()
        rng = np.random.default_rng(self.seed + increment_idx)
        if self.init_args == "random":
            mean = x_np.mean(axis=0, keepdims=True)
            new_u = mean + rng.standard_normal((n_extra,) + x_np.shape[1:]).astype(np.float32)
            new_z = np.full(n_extra, float(new_class))
        else:
            cls_idx = np.where(y_np == new_class)[0]
            take = rng.choice(cls_idx, size=n_extra, replace=len(cls_idx) < n_extra)
            new_u, new_z = x_np[take], y_np[take]
        u = torch.cat([st.u, torch.as_tensor(new_u, dtype=_real(), device=dev)])
        z = torch.cat([st.z, torch.as_tensor(new_z, dtype=_real(), device=dev)])
        self._set_coreset(u, z, v, opt_alpha=self.opt_alpha.init(st.alpha))

    def _set_coreset(self, u, z, v, **fresh):
        """Install a coreset of another size: M follows u, the Adam states of
        u, v, z, the net and the joint trainer (and those in ``fresh``)
        restart, and the step is chosen again."""
        st = self.state
        self.num_pseudo = int(u.shape[0])
        self.state = st._replace(
            u=u, z=z, v=v, opt_u=self.opt_u.init(u), opt_v=self.opt_v.init(v),
            opt_z=self.opt_z.init(z),
            opt_joint=self.opt_joint.init(self._joint_leaves(st.params, u, v)),
            opt_net=self.opt_net.init(st.params), **fresh)
        self._rebuild()

    def sample_replay_indices(self):
        """The replay: ``train_data_so_far`` coreset indices drawn with
        replacement by the current f(v) (JAX ``sample_replay_indices``).
        Call it before ``increment_coreset``: the reference draws over the
        pre-increment weights (ref :952)."""
        _, fv = self._core_weights(self.state.v, self.state.alpha)
        return torch.multinomial(fv / fv.sum(), self.train_data_so_far, replacement=True,
                                 generator=self.gen)

    def _advance_increment_task(self, increment_idx: int, samples):
        """The next task (JAX ``_advance_increment_task``; ref :946-965):
        train on class ``increment_idx + 1`` plus the replay of the coreset
        points ``samples``, test on classes 0..increment_idx + 1. The old
        points keep their leading positions through the increment, so the
        replay gathers from the grown u and z."""
        samples = torch.as_tensor(samples, dtype=torch.long, device=self.device)
        rep_u = self.state.u[samples].cpu().numpy()
        rep_z = self.state.z[samples].cpu().numpy()
        d, new_cls = self.data, increment_idx + 1
        tr, te = d.y == new_cls, np.isin(d.yt, list(range(new_cls + 1)))
        self._set_data(np.concatenate([d.x[tr], rep_u]), np.concatenate([d.y[tr], rep_z]),
                       d.xt[te], d.yt[te])
        self.train_data_so_far = self.n_train_now
        self._rebuild()

    # ------------------------------------------------------------------
    # objectives
    # ------------------------------------------------------------------

    @property
    def _learn_z_kldiv(self):
        """Learned soft labels: the KLDiv NLL of ``ops/elbo.soft_label_nll``."""
        return self.spec.learn_z and self.likelihood == "categorical"

    def _local_eps(self, eps):
        """This rank's samples of a noise tree drawn for all S (itself
        unless ``shard_mc``)."""
        return eps if self.mc_shard is None else tree_map(self.mc_shard.take, eps)

    def _mean_grads(self, grads, axes=("data", "mc")):
        """Gradients of a loss that sums over the sharded ``axes``, averaged
        over them (``parallel/mesh.py``: the data-parallel rule)."""
        for shard in (self.data_shard if "data" in axes else None,
                      self.mc_shard if "mc" in axes else None):
            if shard is not None:
                grads = shard.mean(grads)
        return grads

    def _inner_loss(self, params, eps, u, z, v, alpha):
        cw, _ = self._core_weights(v, alpha)
        return E.inner_elbo(self.net, params, self._local_eps(eps), u, z, cw,
                            likelihood=self.likelihood, learn_z=self._learn_z_kldiv, nc=self.nc,
                            tau=self.tau, mc_shard=self.mc_shard)

    def _outer_loss(self, params, eps, u, z, v, alpha, xb, yb):
        """The outer objective on a whole batch and noise draw; each rank
        takes its rows and samples under ``shard_batch`` and ``shard_mc``."""
        eps = self._local_eps(eps)
        if self.data_shard is not None:
            xb, yb = self.data_shard.take(xb), self.data_shard.take(yb)
        shards = dict(data_shard=self.data_shard, mc_shard=self.mc_shard)
        if self.spec.ablated:
            return E.ablated_elbo(self.net, params, eps, xb, yb, self.N,
                                  likelihood=self.likelihood, nc=self.nc, tau=self.tau, **shards)
        cw, _ = self._core_weights(v, alpha)
        return E.psvi_elbo(self.net, params, eps, u, z, cw, xb, yb, self.N,
                           likelihood=self.likelihood, learn_z=self._learn_z_kldiv,
                           nc=self.nc, tau=self.tau, **shards)

    def _sample_eps(self, S):
        return self.net.sample_eps(self.gen, S)

    @contextlib.contextmanager
    def _drawing_from(self, gen):
        """Draw from ``gen`` in place of the engine's generator (the trial
        runner's per-trial streams)."""
        saved, self.gen = self.gen, gen
        try:
            yield
        finally:
            self.gen = saved

    def _batch_index(self):
        return torch.randperm(self.n_train_now, generator=self.gen,
                              device=self.device)[:self.data_minibatch]

    def _sample_batch(self):
        """A minibatch drawn without replacement; under ``stream_data`` its
        indices come to the host, and its rows back to the device."""
        idx = self._batch_index()
        if self.stream_data:
            (xb, yb), = self._ship_rows(idx[None])
            return xb, yb
        return self.x_train[idx], self.y_train[idx]

    def _ship_rows(self, idx):
        """Under ``stream_data``: the (n, B) indices to the host in one copy,
        the rows gathered there (into pinned memory on a card) and shipped to
        the device in one copy of each of x and y; the n batches."""
        idx = idx.cpu()
        xb, yb = self.x_train[idx], self.y_train[idx]
        if self.device.type == "cuda":
            xb = xb.pin_memory().to(self.device, non_blocking=True)
            yb = yb.pin_memory().to(self.device, non_blocking=True)
        return list(zip(xb, yb))

    def _take_step(self, it):
        """The run loop's next step. Under ``stream_data`` it takes its batch
        and noise from the current block: a block is drawn at its first step,
        every step's batch indices and then its noise from the engine's
        generator in a resident run's order, and its rows shipped at once.
        A block reaches the next evaluation, or is one step where a hook
        draws between steps (reset, prune, the scoring run)."""
        if not self.stream_data:
            return self._step(self.state)
        if not self._stream_block:
            per_step = self.reset or self.prune or self.scoring_run
            n = 1 if per_step else min(self.log_every - it % self.log_every,
                                       self.num_epochs - it)
            idx, eps = [], []
            for _ in range(n):
                idx.append(self._batch_index())
                eps.append(self._draw_eps())
            self._stream_block = list(zip(self._ship_rows(torch.stack(idx)), eps))
        batch, eps = self._stream_block.pop(0)
        return self._step(self.state, batch=batch, eps=eps)

    def _inner_iter(self, params, ostate, eps, u, z, v, alpha, lr_now, opt, create_graph,
                    functional=False):
        """One inner step: the inner loss and its gradient, then ``opt``'s
        update. ``create_graph`` keeps the step differentiable; under
        ``functional`` the gradient comes from ``torch.func`` (differentiable
        under an enclosing ``torch.func`` transform, and vmappable)."""
        if functional:
            g, loss = torch.func.grad_and_value(
                lambda p: self._inner_loss(p, eps, u, z, v, alpha))(params)
        elif create_graph:
            loss = self._inner_loss(params, eps, u, z, v, alpha)
            g = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params),
                                                           create_graph=True))
        else:
            with torch.enable_grad():
                leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
                loss = self._inner_loss(leaves, eps, u, z, v, alpha)
                g = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(leaves)))
        params, ostate = opt.step(params, self._mean_grads(g, axes=("mc",)), ostate, lr_now)
        return params, ostate, loss.detach()

    def _run_inner(self, params0, u, z, v, alpha, lr_now, eps=None, n_steps=None, opt=None,
                   create_graph=True, functional=False):
        """``n_steps`` (default ``inner_it``) inner steps of ``opt`` (default
        the inner Adam) from a fresh optimizer state (ref nested_step
        :549-555). ``create_graph=True`` keeps every step differentiable;
        under ``remat_inner`` each such step is recomputed in the backward
        pass (``torch.utils.checkpoint``) instead of keeping its graph.
        ``create_graph=False`` runs them without a graph. ``functional``
        takes each gradient through ``torch.func`` (``_inner_iter``). All
        noise draws are made before the loop, as the JAX engine pre-draws
        them outside its scan."""
        T = self.inner_it if n_steps is None else n_steps
        opt = opt or self.inner_opt
        eps_stack = eps if eps is not None else [
            self._sample_eps(self.mc_samples) for _ in range(T)]
        if not create_graph and not functional:
            params0 = tree_map(lambda x: x.detach(), params0)
        params, ostate = params0, opt.init(params0)
        remat = create_graph and self.remat_inner and not functional
        losses = []
        for t in range(T):
            args = (params, ostate, eps_stack[t], u, z, v, alpha, lr_now, opt, create_graph,
                    functional)
            if remat:
                params, ostate, loss = torch.utils.checkpoint.checkpoint(
                    self._inner_iter, *args, use_reentrant=False)
            else:
                params, ostate, loss = self._inner_iter(*args)
            losses.append(loss)
        return params, torch.stack(losses)

    # ------------------------------------------------------------------
    # trainers
    # ------------------------------------------------------------------

    def _hyper_names(self):
        """The hyperparameters the outer step learns (JAX ``_hyper_tree``):
        u and z unless fixed or evaluate-only, v and α where learned."""
        names = []
        if self.spec.learn_u and not self.spec.evaluate_only:
            names.append("u")
        if self.spec.learn_v:
            names.append("v")
        if self.spec.learn_z and not self.spec.evaluate_only:
            names.append("z")
        if self.spec.learn_alpha:
            names.append("alpha")
        return names

    def _apply_hyper_updates(self, state: PSVIState, grads):
        u, v, z, alpha = state.u, state.v, state.z, state.alpha
        opt_u, opt_v, opt_z, opt_alpha = state.opt_u, state.opt_v, state.opt_z, state.opt_alpha
        if "u" in grads:
            u, opt_u = self.opt_u.step(u, grads["u"], opt_u)
        if "v" in grads:
            v, opt_v = self.opt_v.step(v, grads["v"], opt_v)
            if not self.spec.parameterised:
                v = O.clip_nonnegative(v)  # clamp (ref :585-591)
        if "z" in grads:
            z, opt_z = self.opt_z.step(z, grads["z"], opt_z)
        if "alpha" in grads:
            alpha, opt_alpha = self.opt_alpha.step(alpha, grads["alpha"], opt_alpha)
        return state._replace(u=u, v=v, z=z, alpha=alpha, opt_u=opt_u, opt_v=opt_v,
                              opt_z=opt_z, opt_alpha=opt_alpha)

    def _nested_step(self, state: PSVIState, batch=None, eps=None, functional=False):
        """Bilevel step through torch.autograd: differentiate the outer
        IW-ELBO through the unrolled inner loop (ref ``nested_step``
        :541-600). ``eps = (list of T inner noise trees, outer noise tree)``;
        under ``truncated`` the first T − K inner trees drive the warm-up
        and the last K the differentiated steps. With no hyperparameters
        (``psvi_evaluate``) the step only fits the net: no graph, no outer
        gradient. ``functional``: every gradient through ``torch.func``, the
        inner ones nested in the outer (the trial runner's vmapped step)."""
        xb, yb = batch if batch is not None else self._sample_batch()
        eps_inner, eps_outer = eps if eps is not None else self._stream_eps()
        lr_now = self.lr_net_sched(state.net_step)
        names = self._hyper_names()
        params0 = state.params
        if self.truncated:
            # T − K warm-up steps that are not differentiated, with a fresh
            # Adam(1e-4) at lr 1e-4 (ref :561-571)
            n_warm = self.inner_it - self.truncated_K
            params0, _ = self._run_inner(params0, self.net.prep_input(state.u), state.z,
                                         state.v, state.alpha, 1e-4, eps_inner[:n_warm],
                                         n_steps=n_warm, opt=O.adam(1e-4), create_graph=False,
                                         functional=functional)
            eps_inner = eps_inner[n_warm:]
        if not names:
            paramsT, inner_losses = self._run_inner(
                params0, self.net.prep_input(state.u), state.z, state.v, state.alpha, lr_now,
                eps_inner, n_steps=len(eps_inner), create_graph=False, functional=functional)
            with torch.no_grad():
                loss = self._outer_loss(paramsT, eps_outer, state.u, state.z, state.v,
                                        state.alpha, xb, yb)
            return (state._replace(params=paramsT, net_step=state.net_step + 1),
                    {"outer_loss": loss, "inner_losses": inner_losses})
        if not functional:
            params0 = tree_map(lambda x: x.detach().requires_grad_(True), params0)

        def outer(hyper):
            u = hyper.get("u", state.u)
            v = hyper.get("v", state.v)
            z = hyper.get("z", state.z)
            alpha = hyper.get("alpha", state.alpha)
            before = _allocated(self.device)
            with span("psvi.unroll.fwd"):
                # patch-extract u once, outside the inner loop (a no-op for
                # dense nets; layers.PrePatched)
                paramsT, inner_losses = self._run_inner(params0, self.net.prep_input(u), z, v,
                                                        alpha, lr_now, eps_inner,
                                                        n_steps=len(eps_inner),
                                                        functional=functional)
            held = _allocated(self.device) - before
            UNROLL.update(iterations=UNROLL["iterations"] + len(eps_inner),
                          remat=bool(self.remat_inner and not functional), resident_bytes=held,
                          resident_bytes_max=max(UNROLL["resident_bytes_max"], held))
            with span("psvi.outer.fwd"):
                loss = self._outer_loss(paramsT, eps_outer, u, z, v, alpha, xb, yb)
            return loss, (paramsT, inner_losses)

        loss, grads, (paramsT, inner_losses) = _value_grad_aux(
            outer, {k: getattr(state, k) for k in names}, functional)
        state = self._apply_hyper_updates(state, self._mean_grads(grads))
        state = state._replace(params=tree_map(lambda x: x.detach(), paramsT),
                               net_step=state.net_step + 1)
        return state, {"outer_loss": loss, "inner_losses": inner_losses}

    def _hyper_step(self, state: PSVIState, batch=None, eps=None, functional=False):
        """AID step (JAX ``_hyper_step``; ref ``hyper_step`` :602-687): T
        inner steps that are not differentiated, at the constant lr0net
        (the reference never steps the net's StepLR here), then the
        hypergradient of the outer loss at that solution by the solver
        ``hypergrad_approx`` over ``hyper_K`` iterations, its fixed-point
        map one gradient step on the inner loss at ``linsys_lr``. The
        hyperparameters take one hyper-Adam step; ``net_step`` is not
        advanced. ``eps = (list of T inner noise trees, the outer noise
        tree, {tag: noise tree} for the solver's products)`` (tags:
        ``ops/hypergrad.py``), drawn by ``_hyper_eps`` when not given.
        ``functional``: the inner gradients and the solver's outer gradient
        through ``torch.func``."""
        xb, yb = batch if batch is not None else self._sample_batch()
        eps_inner, eps_outer, draws = eps if eps is not None else self._hyper_eps()
        paramsT, inner_losses = self._run_inner(
            state.params, self.net.prep_input(state.u), state.z, state.v, state.alpha,
            self.lrs["net"], eps_inner, create_graph=False, functional=functional)

        def unpack(h):
            return (h.get("u", state.u), h.get("z", state.z), h.get("v", state.v),
                    h.get("alpha", state.alpha))

        def fp_map(p, h, tag):  # one gradient step on the inner loss
            u, z, v, alpha = unpack(h)
            e = draws[tag]
            g = torch.func.grad(lambda q: self._inner_loss(q, e, u, z, v, alpha))(p)
            return tree_map(lambda w, gw: w - self.linsys_lr * gw, p, g)

        def outer_loss_fn(p, h):
            u, z, v, alpha = unpack(h)
            return self._outer_loss(p, eps_outer, u, z, v, alpha, xb, yb)

        # every method this step serves learns u or v (psvi_evaluate, with no
        # hyperparameters, takes the net-only nested step)
        solver = {"cg_normaleq": H.cg_normaleq, "fixed_point": H.fixed_point,
                  "neumann": H.neumann}[self.hypergrad_approx]
        hg = solver(fp_map, outer_loss_fn, paramsT,
                    {k: getattr(state, k) for k in self._hyper_names()}, self.hyper_K,
                    functional=functional)
        state = self._apply_hyper_updates(state, hg.hyper_grads)
        return (state._replace(params=paramsT),
                {"outer_loss": hg.outer_loss, "inner_losses": inner_losses})

    def _fused_dense_idx(self):
        return [i for i, l in enumerate(self.net.layers) if isinstance(l, VILinear)]

    def _fused_cfg(self, B: int) -> FN.FusedCfg:
        dense = [self.net.layers[i] for i in self._fused_dense_idx()]
        return FN.FusedCfg(
            T=self.inner_it, S=self.mc_samples,
            widths=tuple([dense[0].in_dim] + [l.out_dim for l in dense]),
            M=self.num_pseudo, B=B, N=float(self.N),
            parameterised=self.spec.parameterised,
            use_alpha=self.spec.learn_alpha or self.spec.alpha_fixed,
            prior_sd=float(dense[0].prior_sd),
            likelihood=self.likelihood, tau=float(self.tau),
            learn_z=bool(self.spec.learn_z and self.likelihood == "gaussian"),
        )

    # Each step's noise, drawn from the engine's generator in the step's
    # order and in the form its ``eps`` argument takes. A step given no
    # ``eps`` calls its own; ``_trainer_fn`` pairs each step with it, so the
    # trial runner and ``stream_data`` can draw ahead of the step.

    def _stream_eps(self):
        """The noise of ``_nested_step``, in its order: T inner trees, then
        the outer tree (the fused steps' under ``fused_eps="stream"``)."""
        return ([self._sample_eps(self.mc_samples) for _ in range(self.inner_it)],
                self._sample_eps(self.mc_samples))

    def _hyper_eps(self):
        """``_hyper_step``'s: the nested step's, then one tree per solver tag
        in the order the solver first asks for them."""
        eps_inner, eps_outer = self._stream_eps()
        tags = H.noise_tags(self.hypergrad_approx, self.hyper_K)
        return eps_inner, eps_outer, {tag: self._sample_eps(self.mc_samples) for tag in tags}

    def _joint_eps(self):
        return self._sample_eps(self.mc_samples)

    def _alternating_eps(self):
        """The net step's tree, then the u step's."""
        return self._sample_eps(self.mc_samples), self._sample_eps(self.mc_samples)

    def _fused_dense_eps(self, n_eps=None):
        """``_nested_step_fused``'s: under ``fused_eps="batched"`` the flat
        (T, n_eps) inner and (n_eps,) outer draws; ``n_eps`` is the step's
        config's, built here when not given."""
        if self.fused_eps == "stream":
            return self._stream_eps()
        if n_eps is None:
            n_eps = self._fused_cfg(self.data_minibatch).n_eps
        return FlatEps(torch.randn((self.inner_it, n_eps), generator=self.gen, device=self.device),
                       torch.randn((n_eps,), generator=self.gen, device=self.device))

    def _fused_lenet_eps(self, n_eps=None):
        """``_nested_step_fused_lenet``'s: under ``fused_eps="batched"`` the
        flat (T, n_eps) inner draw, then the outer noise tree."""
        if self.fused_eps == "stream":
            return self._stream_eps()
        if n_eps is None:
            n_eps = FL.cfg_from_engine(self).n_eps
        return FlatEps(torch.randn((self.inner_it, n_eps), generator=self.gen, device=self.device),
                       self._sample_eps(self.mc_samples))

    def _nested_step_fused(self, state: PSVIState, batch=None, eps=None):
        """The nested step through the fused kernels: the CUDA kernels on
        the card, their plain versions on the CPU. Under ``fused_eps=
        "batched"`` the noise is drawn in the kernels' flat layout in one
        call per step (``FlatEps``, which ``eps`` may also hand in);
        injected noise (``eps`` as for ``_nested_step``), or under
        ``"stream"`` noise drawn as ``_nested_step`` draws it, is packed
        into it. The targets are class labels, or for a Gaussian
        likelihood the real pseudo- and batch targets as flat (M,) and (B,)
        rows."""
        xb, yb = batch if batch is not None else self._sample_batch()
        if self.likelihood == "gaussian":
            yb = yb.reshape(-1)
        didx = self._fused_dense_idx()
        cfg = self._fused_cfg(xb.shape[0])
        if eps is None:
            eps = self._fused_dense_eps(cfg.n_eps)
        e_in, e_out = _flat_eps(eps, FN.pack_eps, didx, pack_outer=True)
        p0 = FN.pack_params([state.params[i] for i in didx])
        lr_now = self.lr_net_sched(state.net_step)
        loss, inner_losses, pT, g_u, g_v, g_a, g_z = FN.fused_nested_flat(
            p0, state.u, state.v, state.alpha, state.z, xb, yb, e_in, e_out, lr_now, cfg)
        all_grads = {"u": g_u, "v": g_v, "z": g_z, "alpha": g_a}
        grads = {k: all_grads[k] for k in self._hyper_names()}
        state = self._apply_hyper_updates(state, grads)
        params = list(state.params)
        for k, p in zip(didx, FN.unpack_params(pT.clone(), cfg)):
            params[k] = p
        state = state._replace(params=tuple(params), net_step=state.net_step + 1)
        return state, {"outer_loss": loss, "inner_losses": inner_losses}

    def _nested_step_fused_lenet(self, state: PSVIState, batch=None, eps=None):
        """The LeNet nested step with the T-iteration inner unroll through
        the kernel pair (``ops/fused_lenet.py``: the CUDA kernels on the
        card, their plain versions on the CPU) and the outer IW-ELBO and
        its gradient through autograd, as ``_nested_step``. Under
        ``fused_eps="batched"`` the inner noise is drawn in the kernels' flat
        layout in one call per step (``FlatEps``); injected noise (``eps`` as for
        ``_nested_step``), or under ``"stream"`` noise drawn as
        ``_nested_step`` draws it, is packed into it. The net is the folded
        or the literal LeNet; both hold the same parameter tree. The step
        past its draws (``_fused_lenet_body``) is replayed on the card from
        one CUDA graph (``inference/cuda_graph.py``)."""
        xb, yb = batch if batch is not None else self._sample_batch()
        cfg = FL.cfg_from_engine(self)
        if eps is None:
            eps = self._fused_lenet_eps(cfg.n_eps)
        e_in, eps_outer = _flat_eps(eps, FL.pack_eps, self.net.variational_layers)
        return self._step_graph(self, state, cfg, (xb, yb, e_in, eps_outer))

    def _fused_lenet_body(self, state: PSVIState, cfg, xb, yb, e_in, eps_outer):
        """``_nested_step_fused_lenet`` from its drawn inputs: the pair's
        unroll, the outer IW-ELBO and its gradient, the hyper-Adam. Returns
        the state with the hyperparameters stepped, the flat net the unroll
        ended at (``_with_unrolled_net`` puts it in) and the aux."""
        didx = self.net.variational_layers
        lr_now = self.lr_net_sched(state.net_step)
        names = self._hyper_names()
        p0 = FL.pack_params([state.params[i] for i in didx])
        with torch.enable_grad():
            hyper = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in names}
            u = hyper.get("u", state.u)
            v = hyper.get("v", state.v)
            alpha = hyper.get("alpha", state.alpha)
            pT, inner_losses = FL.lenet_unroll(p0, u, v, alpha, state.z, e_in, lr_now, cfg)
            paramsT = list(state.params)
            for i, layer in zip(didx, FL.unpack_params(pT, cfg)):
                paramsT[i] = layer
            with span("psvi.outer.fwd"):
                loss = self._outer_loss(tuple(paramsT), eps_outer, u, state.z, v, alpha, xb, yb)
            with span("psvi.outer.bwd"):
                grads = (dict(zip(names, torch.autograd.grad(loss, list(hyper.values()))))
                         if names else {})
        state = self._apply_hyper_updates(state, grads)
        return (state, pT.detach(),
                {"outer_loss": loss.detach(), "inner_losses": inner_losses.detach()})

    def _with_unrolled_net(self, state: PSVIState, pT, cfg):
        """``state`` with the net the unroll ended at, views of the flat
        ``pT``, and the StepLR counter one on."""
        params = list(state.params)
        for i, layer in zip(self.net.variational_layers, FL.unpack_params(pT, cfg)):
            params[i] = layer
        return state._replace(params=tuple(params), net_step=state.net_step + 1)

    def _joint_step(self, state: PSVIState, batch=None, eps=None, functional=False):
        """One Adam step on (params, u[, v]) jointly, on the outer objective
        (JAX ``_joint_step``; ref ``joint_step`` :517-525). ``eps`` is one
        noise tree; ``functional``: the gradient through ``torch.func``."""
        xb, yb = batch if batch is not None else self._sample_batch()
        if eps is None:
            eps = self._joint_eps()
        leaves = self._joint_leaves(state.params, state.u, state.v)
        loss, grads = H.value_and_grad(lambda lv: self._outer_loss(
            lv["params"], eps, lv["u"], state.z, lv.get("v", state.v), state.alpha, xb, yb),
            leaves, functional)
        leaves, opt_joint = self.opt_joint.step(leaves, self._mean_grads(grads), state.opt_joint)
        state = state._replace(params=leaves["params"], u=leaves["u"],
                               v=leaves.get("v", state.v), opt_joint=opt_joint)
        return state, {"outer_loss": loss, "inner_losses": torch.zeros(1, device=self.device)}

    def _alternating_step(self, state: PSVIState, batch=None, eps=None, functional=False):
        """A net step, then a u step at the new net, each on the outer
        objective with its own noise draw (JAX ``_alternating_step``; ref
        ``alternating_step`` :527-539). ``eps`` is the pair of draws, net
        step first. ``inner_losses`` holds the u step's loss, as JAX returns
        it (the stream tag 1 of ``register_elbos``). ``functional``: the
        gradients through ``torch.func``."""
        xb, yb = batch if batch is not None else self._sample_batch()
        eps_net, eps_u = eps if eps is not None else self._alternating_eps()
        loss0, gp = H.value_and_grad(lambda p: self._outer_loss(
            p, eps_net, state.u, state.z, state.v, state.alpha, xb, yb), state.params, functional)
        params, opt_net = self.opt_net.step(state.params, self._mean_grads(gp), state.opt_net)
        loss1, gu = H.value_and_grad(lambda u: self._outer_loss(
            params, eps_u, u, state.z, state.v, state.alpha, xb, yb), state.u, functional)
        u, opt_u = self.opt_u.step(state.u, self._mean_grads(gu), state.opt_u)
        state = state._replace(params=params, u=u, opt_net=opt_net, opt_u=opt_u)
        return state, {"outer_loss": loss0, "inner_losses": loss1[None]}

    def _retrain_step(self, state: PSVIState, eps=None):
        """Net-only Adam step on the inner ELBO over the coreset, with the
        retrain Adam at lr0joint on ``state.opt_net`` (JAX ``_retrain_step``;
        ref retrain loop :996-1003). Returns (state, loss)."""
        if eps is None:
            eps = self._sample_eps(self.mc_samples)
        loss, g = H.value_and_grad(lambda p: self._inner_loss(
            p, eps, state.u, state.z, state.v, state.alpha), state.params)
        params, opt_net = self.opt_retrain.step(state.params, self._mean_grads(g, axes=("mc",)),
                                                state.opt_net)
        return state._replace(params=params, opt_net=opt_net), loss

    def _use_fused_inner(self):
        """Which fused path serves this config: ``'dense'``
        (ops/fused_nested), ``'lenet'`` (ops/fused_lenet) or ``None``."""
        if self.fused_inner is False:
            return None
        which = "dense" if FN.supports(self) else ("lenet" if FL.supports(self) else None)
        if self.fused_inner is True:
            if which is None:
                raise ValueError(
                    "fused_inner=True requires a configuration the fused kernels support "
                    "(see psvi_torch.ops.fused_nested.supports and fused_lenet.supports)")
            return which
        return which if self.device.type == "cuda" else None

    def _trainer_fn(self):
        """The step for this config and the draw of its noise (a step given
        no ``eps`` draws the same)."""
        # evaluated first, so that fused_inner=True raises for a configuration
        # the kernels do not serve, a first-order trainer included (JAX
        # psvi.py:1258-1261)
        which = self._use_fused_inner()
        if self.spec.evaluate_only:
            # PSVIEvaluate: the net-only nested step
            step, draw = self._nested_step, self._stream_eps
        elif self.trainer in ("joint", "alternating", "hyper"):
            step = getattr(self, f"_{self.trainer}_step")
            draw = getattr(self, f"_{self.trainer}_eps")
        else:
            step, draw = {"dense": (self._nested_step_fused, self._fused_dense_eps),
                          "lenet": (self._nested_step_fused_lenet, self._fused_lenet_eps),
                          }.get(which, (self._nested_step, self._stream_eps))
        return (self._vmappable(step) if self._in_trial_vmap else step), draw

    def _vmappable(self, step):
        """``step`` with every gradient through ``torch.func``, so that
        ``torch.func.vmap`` batches it over a leading trial axis of the state
        (the trial runner). Its noise and batch are handed in: ``vmap``
        draws nothing. What cannot pass ``vmap`` raises, by name."""
        for bad, why in ((self.remat_inner, "remat_inner: torch.utils.checkpoint's saved-tensor "
                                            "hooks do not pass torch.func"),
                         (self.backend == "pallas", "backend='pallas': kernel B3's "
                                                    "autograd.Function has no vmap rule"),
                         (self.data_shard or self.mc_shard, "shard_batch/shard_mc: a "
                                                            "collective does not pass vmap")):
            if bad:
                raise ValueError(f"the trial runner cannot vmap the step with {why}")
        return functools.wraps(step)(functools.partial(step, functional=True))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _padded_test(self):
        """The test set padded to whole batches of B = min(minibatch, test
        size) with its own first points, and the mask of the real ones:
        ``(B, x, y, mask)``, built once per test set."""
        n_test = int(self.x_test.shape[0])
        B = min(self.data_minibatch, n_test)
        t = self._eval_test
        if t is not None and t[0] is self.x_test and t[1] is self.y_test and t[2][0] == B:
            return t[2]
        pad = _count_pad(n_test, B)
        xt = torch.cat([self.x_test, self.x_test[:pad]]) if pad else self.x_test
        yt = torch.cat([self.y_test, self.y_test[:pad]]) if pad else self.y_test
        mask = torch.cat([torch.ones(n_test, device=self.device),
                          torch.zeros(pad, device=self.device)])
        self._eval_test = (self.x_test, self.y_test, (B, xt, yt, mask))
        return self._eval_test[2]

    @torch.no_grad()
    def _evaluate_fn(self, state: PSVIState, correction: bool = True):
        """Importance-weighted predictive accuracy and NLL over padded test
        batches, and the IW diagnostics of the last batch (ref ``evaluate``
        :1031-1108); under ``shard_mc`` each rank's samples, the mixture
        over S summed over the mc axis. On a CUDA device the loop
        (``_evaluate_batches``) is replayed from a CUDA graph
        (``inference/cuda_graph.py``), which draws the same noise."""
        return self._eval_graph(self, state, correction, self._padded_test())

    def _evaluate_batches(self, state: PSVIState, correction, test):
        """``_evaluate_fn``'s loop over the padded test set ``test``."""
        B, xt, yt, mask = test
        S = self.mc_samples_eval
        cw, fv = self._core_weights(state.v, state.alpha)
        M = state.u.shape[0]
        corrects = nll_sum = total = 0.0
        weights = None
        mc = self.mc_shard
        for b0 in range(0, xt.shape[0], B):
            xb, yb, m = xt[b0:b0 + B], yt[b0:b0 + B], mask[b0:b0 + B]
            eps = self._local_eps(self._sample_eps(S))
            all_logits = self.net.apply(state.params, eps, torch.cat([state.u, xb]))
            lw = E.importance_log_weights(self.net, state.params, eps, state.u, state.z, cw,
                                          learn_z=self._learn_z_kldiv, nc=self.nc,
                                          pseudo_out=all_logits[:, :M], mc_shard=mc)
            probs, weights = E.predictive_mixture(all_logits[:, M:], lw, correction=correction,
                                                  mc_shard=mc)
            pred = torch.argmax(probs, dim=-1).to(torch.float32)
            corrects = corrects + torch.sum((pred == yb) * m)
            p_true = torch.gather(probs, 1, yb.long()[:, None])[:, 0]
            nll_sum = nll_sum - torch.sum(torch.log(torch.clamp_min(p_true, 1e-38)) * m)
            total = total + torch.sum(m)
        iw_ent, ness, vent = E.iw_diagnostics(weights, fv, self.num_pseudo, mc)
        return corrects / total, nll_sum / total, iw_ent, ness, vent

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------

    def run_psvi(self) -> dict:
        """Run the engine (``_run_psvi_impl``); under ``profile_dir``, inside
        torch.profiler, with its Chrome trace written into that directory
        (JAX writes an XLA trace there, ``psvi.py:1566-1574``). On CUDA a
        trace that recorded no device activity raises."""
        if not self.profile_dir:
            return self._run_psvi_impl()
        from torch.profiler import ProfilerActivity, profile

        on_card = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            results = self._run_psvi_impl()
        if on_card and not any(e.device_type == torch.autograd.DeviceType.CUDA
                               for e in prof.events()):
            raise RuntimeError("torch.profiler recorded no CUDA activity: the device "
                               "trace did not start")
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"psvi_{self.dnm}_{self.seed}.trace.json"))
        return results

    def _run_psvi_impl(self) -> dict:
        """Train for ``num_epochs`` outer steps, evaluating every
        ``log_every``, with the lifecycle hooks in JAX's order
        (``psvi.py:1593-1721``): the forgetting calculator, the evaluation
        (and u, z and the grid predictions under ``log_pseudodata``), the
        reset, the step, then the prune and the increment; with
        ``retrain_on_coreset``, then re-fit the net on the coreset alone for
        as many steps, evaluated without the IW correction (ref :967-1003);
        then the scoring. Returns the reference's results dict: raw v in
        ``vs`` while training, f(v) while retraining."""
        nlls, accs, csizes, iws_ent, nesses, vs_ent, vs, times = [], [], [], [], [], [], [], [0.0]
        us, zs, grid_preds = [], [], []
        if self.spec.learn_alpha:
            self.results.setdefault("alpha", [])
        log_resource = LogResource(self.device)
        t_start = time.time()
        prune_idx = increment_idx = 0
        self._stream_block = []
        for it in range(self.num_epochs):
            self._forgetting_calculator()
            if it % self.log_every == 0:
                with span("psvi.evaluate"):
                    acc, nll, iw_ent, ness, vent = self._evaluate_fn(self.state)
                with span("psvi.readback"):
                    accs.append(float(acc))
                    nlls.append(float(nll))
                    csizes.append(self.num_pseudo)
                    times.append(times[-1] + time.time() - t_start)
                    vs.append(self.state.v.cpu().numpy())
                    if self.compute_weights_entropy:
                        iws_ent.append(float(iw_ent))
                        vs_ent.append(float(vent))
                    nesses.append(float(ness))
                    if self.spec.learn_alpha:
                        self.results["alpha"].append(self.state.alpha.cpu().numpy())
                if self.log_pseudodata:
                    us.append(self.state.u.cpu().numpy())
                    zs.append(self.state.z.cpu().numpy())
                    if self.D == 2:
                        grid_preds.append(self.pred_on_grid())
            if self.reset and it % self.reset_interval == 0:
                self.weight_reset()
            with span("psvi.step"):
                self.state, aux = self._take_step(it)
            if self.register_elbos:
                # stream tags (ref :521-559): 1 for the inner entries, then
                # the step's own, 2 for the joint trainer and 0 otherwise
                inner = aux["inner_losses"].cpu()
                for j in range(0, inner.shape[0], max(self.log_every, 1)):
                    self.elbos.append((1, -float(inner[j])))
                self.elbos.append((2 if self.trainer == "joint" else 0,
                                   -float(aux["outer_loss"])))
            log_resource.update()
            if (self.prune and it > 0 and self.prune_interval
                    and it % self.prune_interval == 0 and prune_idx < len(self.prune_sizes)):
                self.prune_coreset(self.prune_sizes[prune_idx])
                prune_idx += 1
                self.weight_reset()
            if (self.increment and it > 0 and self.increment_interval
                    and it % self.increment_interval == 0
                    and increment_idx < len(self.increment_sizes) - 1):
                increment_idx += 1
                self.nc += 1
                self._build_model()
                self.weight_reset()
                replay = self.sample_replay_indices()
                self.increment_coreset(self.increment_sizes[increment_idx],
                                       new_class=increment_idx + 1, increment_idx=increment_idx)
                self._advance_increment_task(increment_idx, replay)
        if self.retrain_on_coreset:
            self.weight_reset()
            for it in range(self.num_epochs):
                if it % self.log_every == 0:
                    acc, nll, *_ = self._evaluate_fn(self.state, correction=False)
                    accs.append(float(acc))
                    nlls.append(float(nll))
                    csizes.append(self.num_pseudo)
                    times.append(times[-1] + time.time() - t_start)
                    _, fv = self._core_weights(self.state.v, self.state.alpha)
                    vs.append(fv.cpu().numpy())
                self.state, _ = self._retrain_step(self.state)
        resources = log_resource.get_resources()
        self._do_scoring()
        self.results.update(
            accs=accs, nlls=nlls, csizes=csizes, times=times[1:], elbos=self.elbos,
            went=iws_ent, ness=nesses, vent=vs_ent, vs=vs,
            avg_epoch_time=resources["time"], gpu_memory=resources["memory"],
            chosen_indices=self.chosen_indices,
        )
        if self.log_pseudodata:
            self.results.update(us=us, zs=zs, grid_preds=grid_preds)
        return self.results

    # ------------------------------------------------------------------
    # the data-difficulty scoring run (ref :1219-1339) and the grid
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _train_set_mean_probs(self, eps=None, batch: int = 1024):
        """The MC-mean softmax probabilities over the (ordered) train set,
        ``batch`` points at a time; ``eps`` injects one noise tree per batch
        (else each is drawn)."""
        out = []
        for j, i in enumerate(range(0, self.n_train_now, batch)):
            e = eps[j] if eps is not None else self._sample_eps(self.mc_samples_eval)
            logits = self.net.apply(self.state.params, self._local_eps(e),
                                    self.x_train[i:i + batch].to(self.device))
            if self.mc_shard is None:
                mean = logits.mean(dim=0)
            else:
                mean = self.mc_shard.sum(logits.sum(dim=0)) / self.mc_samples_eval
            out.append(torch.softmax(mean, dim=-1).cpu().numpy())
        return np.concatenate(out, axis=0)

    def _forgetting_calculator(self, eps=None):
        """Forgetting events over the train set, once before every step of
        a scoring run (ref ``_forgetting_calculator`` :1277-1306); ``eps``
        as for ``_train_set_mean_probs``."""
        if not self.scoring_run:
            return
        if self.forgetting_events is None:
            n = self.n_train_now
            self.forgetting_events = np.zeros(n, np.float32)
            self.last_acc = np.zeros(n, np.float32)
            self.never_learnt = np.ones(n, np.float32)
        probs = self._train_set_mean_probs(eps)
        y = self.y_train.cpu().numpy().astype(int)
        curr_acc = (probs.argmax(-1) == y).astype(np.float32)
        self.forgetting_events[self.last_acc > curr_acc] += 1
        self.last_acc = curr_acc
        self.never_learnt = np.minimum(self.never_learnt, 1.0 - curr_acc)

    def _do_scoring(self, eps=None, emb_eps=None):
        """The final EL2N, forgetting, entropy and least-confidence scores of
        a scoring run, one row per train point, into
        ``{data_folder}/score_psvi_{dnm}_{seed}.csv`` (ref ``_do_scoring``
        :1219-1274), then the embeddings. ``eps`` and ``emb_eps`` inject
        the per-batch noise of the probabilities and of the embeddings."""
        if not self.scoring_run:
            return
        probs = self._train_set_mean_probs(eps)
        y = self.y_train.cpu().numpy().astype(int)
        onehot = np.eye(self.nc, dtype=np.float32)[y]
        entropy = -(probs * np.log(probs + 1e-20)).sum(1)
        least_conf = 1.0 - probs.max(1)
        el2n = np.linalg.norm(probs - onehot, axis=1)
        self.forgetting_events = np.maximum(self.num_epochs * self.never_learnt,
                                            self.forgetting_events)
        folder = self.data_folder or "."
        os.makedirs(folder, exist_ok=True)
        np.savetxt(os.path.join(folder, f"score_psvi_{self.dnm}_{self.seed}.csv"),
                   np.column_stack([el2n, self.forgetting_events, entropy, least_conf]),
                   delimiter=",", header="el2n,forgetting,entropy,least_confidence",
                   comments="")
        self._save_embeddings(emb_eps)

    @torch.no_grad()
    def _save_embeddings(self, eps=None, batch: int = 1024):
        """The penultimate layer's activations summed over the S samples,
        one row per train point, into
        ``{data_folder}/embedding_{dnm}_{seed}.csv`` (ref ``_get_embeddings``
        :1308-1339); ``eps`` injects one noise tree per batch."""
        S = self.mc_samples_eval
        packed = hasattr(self.net, "unpack")  # the flat representation
        params = self.net.unpack(self.state.params) if packed else self.state.params
        rows = []
        for j, i in enumerate(range(0, self.n_train_now, batch)):
            e = self._local_eps(eps[j] if eps is not None else self._sample_eps(S))
            if packed:
                e = self.net.unpack_eps(e)
            xb = self.x_train[i:i + batch].to(self.device)
            h = xb.unsqueeze(0).expand((S // (self.mc_shard.size if self.mc_shard else 1),)
                                       + tuple(xb.shape))
            for layer, p, el in zip(list(self.net.layers)[:-1], params[:-1], e[:-1]):
                h = layer.apply(p, el, h)
            h = h.sum(dim=0) if self.mc_shard is None else self.mc_shard.sum(h.sum(dim=0))
            rows.append(h.float().cpu().numpy())
        np.savetxt(os.path.join(self.data_folder or ".", f"embedding_{self.dnm}_{self.seed}.csv"),
                   np.concatenate(rows, axis=0), delimiter=",")

    @torch.no_grad()
    def pred_on_grid(self, n_test_per_dim: int = 250, correction: bool = True, eps=None):
        """The predictive probabilities over the 2-D grid [-3, 4] × [-2, 3]
        (ref :1130-1175), in JAX's ``indexing="ij"`` order: a (nc, n²) array.
        ``eps`` injects the noise tree (S = ``mc_samples_eval``)."""
        dev = self.device
        g0, g1 = torch.meshgrid(torch.linspace(-3, 4, n_test_per_dim, device=dev),
                                torch.linspace(-2, 3, n_test_per_dim, device=dev),
                                indexing="ij")
        grid = torch.stack([g0.reshape(-1), g1.reshape(-1)], dim=-1)
        if eps is None:
            eps = self._sample_eps(self.mc_samples_eval)
        eps = self._local_eps(eps)
        st = self.state
        cw, _ = self._core_weights(st.v, st.alpha)
        logits = self.net.apply(st.params, eps, torch.cat([st.u, grid]))
        M = st.u.shape[0]
        lw = E.importance_log_weights(self.net, st.params, eps, st.u, st.z, cw,
                                      likelihood=self.likelihood, learn_z=self._learn_z_kldiv,
                                      nc=self.nc, tau=self.tau, pseudo_out=logits[:, :M],
                                      mc_shard=self.mc_shard)
        probs, _ = E.predictive_mixture(logits[:, M:], lw, correction=correction,
                                        mc_shard=self.mc_shard)
        return probs.T.cpu().numpy()


class PSVIRegressor(PSVI):
    """Regression PSVI (JAX ``PSVIRegressor``; ref ``PSVI_regressor`` and
    subclasses, ``psvi_classes.py:1940-2335``): Gaussian likelihood with
    precision ``tau``, pseudodata initialised as a random subsample of (x,
    y) pairs, the pseudo-targets z learned with u and v, and RMSE /
    predictive-LL evaluation with de-normalised targets."""

    likelihood = "gaussian"

    def _init_pseudodata(self):
        """A random subsample of (x, y) pairs (ref :2019-2031), the same
        draws as the JAX engine for the same seed."""
        rng = np.random.default_rng(self.seed)
        x_pool, y_pool = self._init_pool()
        idx = rng.choice(x_pool.shape[0], size=self.num_pseudo, replace=False)
        return (torch.as_tensor(x_pool[idx], dtype=_real(), device=self.device),
                torch.as_tensor(y_pool[idx].reshape(-1), dtype=_real(), device=self.device))

    @torch.no_grad()
    def _evaluate_fn(self, state: PSVIState, correction: bool = True, eps=None):
        """RMSE and predictive LL with de-normalised targets, from one noise
        draw over u and the whole test set, and the IW diagnostics (ref
        :2221-2264). ``eps`` injects that draw."""
        y_mean, y_std = self.data.y_mean, self.data.y_std
        cw, fv = self._core_weights(state.v, state.alpha)
        if eps is None:
            eps = self._sample_eps(self.mc_samples_eval)
        eps, mc = self._local_eps(eps), self.mc_shard
        out = self.net.apply(state.params, eps, torch.cat([state.u, self.x_test])).squeeze(-1)
        M = state.u.shape[0]
        lw = E.importance_log_weights(self.net, state.params, eps, state.u, state.z, cw,
                                      likelihood="gaussian", nc=self.nc, tau=self.tau,
                                      pseudo_out=out[:, :M], mc_shard=mc)
        weights = E.sample_softmax(lw, mc)
        test_out = out[:, M:] * y_std + y_mean  # revert_norm (ref :2226-2227)
        y_pred = torch.einsum("sn,s->n", test_out, weights)
        if mc is not None:
            y_pred = mc.sum(y_pred)
        yt = self.y_test.reshape(-1)
        rmse = torch.sqrt(torch.mean(torch.square(y_pred - yt)))
        scale = 1.0 / torch.sqrt(torch.tensor(self.tau, dtype=torch.float32))
        ll = torch.mean(-0.5 * torch.square((yt - y_pred) / scale) - torch.log(scale)
                        - E.HALF_LOG_2PI)
        iw_ent, ness, vent = E.iw_diagnostics(weights, fv, self.num_pseudo, mc)
        return rmse, ll, iw_ent, ness, vent

    def _run_psvi_impl(self) -> dict:
        """Train for ``num_epochs`` outer steps, evaluating every
        ``log_every``; returns the JAX regressor's results dict
        (``psvi.py:1895-1919``). ``vs`` holds f(v), not the raw v. As in
        JAX, the regressor's loop has no prune, increment or scoring hook."""
        lls, rmses, csizes, vs, times = [], [], [], [], [0.0]
        if self.spec.learn_alpha:
            self.results.setdefault("alpha", [])
        t_start = time.time()
        self._stream_block = []
        for it in range(self.num_epochs):
            if it % self.log_every == 0:
                rmse, ll, *_ = self._evaluate_fn(self.state)
                rmses.append(float(rmse))
                lls.append(float(ll))
                csizes.append(self.num_pseudo)
                times.append(times[-1] + time.time() - t_start)
                _, fv = self._core_weights(self.state.v, self.state.alpha)
                vs.append(fv.cpu().numpy())
                if self.spec.learn_alpha:
                    self.results["alpha"].append(self.state.alpha.cpu().numpy())
            self.state, _ = self._take_step(it)
        self.results.update(rmses=rmses, lls=lls, csizes=csizes, times=times[1:], vs=vs,
                            went=[], ness=[], vent=[])
        return self.results


def make_psvi_engine(data: DataBundle, method: str = "psvi_learn_v", **kwargs):
    """Build the engine class for ``method``: ``PSVIRegressor`` for the
    regressor family, ``PSVI`` otherwise."""
    cls = PSVIRegressor if METHOD_SPECS[method].regressor else PSVI
    return cls(data, method=method, **kwargs)


def run_psvi(data: DataBundle, method: str = "psvi_learn_v", **kwargs) -> dict:
    """Functional entry: build the engine for ``method`` and run it."""
    return make_psvi_engine(data, method=method, **kwargs).run_psvi()
