#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``psvi_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it exits non-zero, before printing any result, when
there is no card or no ``psvi_torch`` beside it. Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi), versions;
2. build   — nvcc builds every kernel of the main paths from the sources in
             the checkout (``psvi_torch/ops/csrc``), one nvcc per source, all
             started at once; ``k_sampled_linear``, ``k_prng_fwd``,
             ``k_prng_dx``, ``k_prng_dparam_partial``,
             ``k_prng_dparam_reduce``, ``k_prng_nkl``,
             ``k_prng_nkl_reduce``, the redesigned LeNet kernels
             (``k_conv1``, ``k_conv2``, ``k_conv2_back``, ``k_conv2_wpart``,
             ``k_ubar_part``, ``k_ubar_sum``, ``k_gemm``, each instantiation)
             and the redesigned dense ``nested_fwd_kernel``,
             ``nested_outer_kernel`` and ``nested_rev_kernel`` must report no
             spill bytes; the last three's stack-frame bytes are reported;
3. kernels — each dense CUDA kernel against its plain PyTorch version on the
             same CUDA inputs (the outer step's cotangents also against the
             plain version in float64), ``nested_fwd``, ``nested_outer`` and
             ``nested_rev`` also against a rerun of themselves, bit for bit,
             with their cluster plans (``_nested_plan``: blocks, samples a
             block, maps shared or global) on each config's line, and the
             composed step against the
             plain and the autograd-oracle backends (TF32 off): three configs
             of the categorical head, and three of the Gaussian head on
             sinus (1-40-1 psvi_learn_v_regressor τ=0.1, the regression main
             path; 1-40-40-1 with α, τ=1; psvi_regressor, f(v) = v), z̄ and
             g_z included;
   centring — at the regression main path, the outer IW-ELBO's gradient in
             fp32 with and without d centred, each against float64;
   caps    — at each edge of the dense ``supports()`` (widest layer, S = 32
             with M + B = 2048, eight layers), for each head, the composed
             CUDA step against the plain version run in float64;
   sampled_linear — kernel B3 against its plain version (max |Δ| ≤ 1e-5·max
             |ref|, and a rerun bit for bit) at the LeNet fc shapes (S=10,
             N=356), fn's second layer (40→4, N=176) and ragged and edge shapes
             (N = 1 and 7, Dout = 1, S = 1, S = 64 with N = 2048, 2048→64,
             which runs the forward's Din-chunk branch, and 37→20, its
             4-byte copies) and the zoo's dense heads (AlexNet's 4096→384,
             384→192, 192→10 at S=10, N=228; ResNet-18's 512→10 at S=4,
             N=178), with the split counts of its plan; its
             Function's backward against autograd through the plain
             version;
   sampled_linear_prng — kernel B4 (four kernels, one Philox generator):
             their Philox words against the plain generator's, bit for bit;
             ε as the kernels see it (W_s, b_s recovered from the forward at
             x = I and x = 0); each kernel against its plain version (max |Δ|
             ≤ 1e-5·max |ref|, a rerun bit for bit) at the LeNet fc shapes,
             the JAX docstring's 400→120 at N = 104 and 1024, B3's ragged
             and edge shapes and 64→2048 (dx's Dout-chunk branch), with the
             split counts of the forward's, dx's and dparam's plans, the NKL
             at S = 10 on the fc shapes, at S = 4000, at a ragged E (37→20:
             760 elements, no multiple of the 256-element tile) and at S = 1,
             with the tile and group counts of its plan (``_nkl_plan``); the
             statistical tests of tests/test_pallas.py:60-124; then B4's
             path, the composed 400-120-84-10 step (S=10, N=356, synth_mnist)
             through ``sampled_linear_prng`` and ``vi_linear_nkl_prng`` with
             B4's launch counters set to 0 just before and read just after,
             against B3 and ``VILinear.nkl`` fed the same ε;
   lenet   — ``lenet_fwd`` and ``lenet_rev`` against their plain versions
             (and against a rerun of themselves, bit for bit) on four
             configs: the flagship psvi_learn_v (S=10, M=100, T=20),
             psvi_alpha_v (S=4, M=16, T=5), psvi (S=3, M=8, T=3) and
             psvi_learn_v (S=2, M=13, T=3), whose last chunk of points in the
             conv tiles is ragged; on the last three also the composed
             ``LeNetUnroll`` against the autograd oracle; and at the caps of
             the LeNet ``supports()`` (S = 64, M = 1024, T = 2);
4. engine  — the main paths through ``run_psvi``'s engine, with every launch
             counter (by kernel and likelihood branch) set to 0 just before
             and read just after: four_blobs with the fn BNN 2-40-4
             (psvi_learn_v, M=48, S=10, inner_it=10, B=128, init_sd 1e-3,
             101 outer steps); halfmoon logistic regression (M=30, 101
             steps); the regression path, sinus regressor_net 1-40-1
             (psvi_learn_v_regressor, M=10, S=10, inner_it=10, B=64, τ=0.1,
             lr 1e-2 for u, v, z, 101 steps, final test RMSE ≤ 0.30); the
             LeNet path, synth_mnist LeNet psvi_learn_v (M=100, S=10,
             inner_it=20, B=256, init_sd 1e-3, 31 outer steps); then the
             first-order paths with ``backend="pallas"``, where every batched
             dense forward launches B3: the LeNet flagship under the joint
             trainer (31 steps) and four_blobs fn 2-40-4 under the
             alternating trainer with ``retrain_on_coreset`` and
             ``register_elbos`` (101 steps, then 101 retrain steps), each
             with B3's launch count derived from the loops; no engine run
             launches B4;
   methods — the paths no kernel serves, in JAX as here (every launch
             counter must read 0): on the dense flagship above, through
             ``run_psvi``, psvi_ablated, psvi_no_iw, psvi_evaluate and
             psvi_learn_v with ``learn_z=True`` under the nested trainer,
             psvi_learn_v with ``truncated=True, truncated_K=5`` (26 steps
             each), the hyper trainer with ``cg_normaleq`` (21 steps) and
             with ``fixed_point`` and ``neumann`` (11 steps each): finite
             losses, v moved where learned, u, v and z bit for bit under
             psvi_evaluate, and the final accuracy at or above JAX's lowest
             over three seeds minus 0.05 (``METHODS_GATES``,
             scripts/torch_methods_jax_gates.py); ``remat_inner=True``
             against the plain step on one injected draw (hypergradients
             and state within 1e-6·max |ref|); at the LeNet flagship's
             widths 3 steps each of the hyper trainer (``cg_normaleq``) and
             of the truncated step (K=5): finite, v moved;
   lifecycle — the coreset lifecycle through ``run_psvi``, every launch
             counter checked exactly: the dense flagship pruned 48 → 24
             after step 50 (101 steps; B1 101 launches each, u (24, 2));
             the incremental coreset, classes {0, 1} at M=24, one class and
             12 points more every 34 steps (101 steps; B1 101 each, four
             classes, u (48, 2)); the joint trainer through B3 pruned after
             step 50 (151 steps; B3's count from its loops, no B1); each held
             to its gate, JAX's lowest accuracy over three seeds minus 0.05
             (``LIFECYCLE_GATES``), with the fused step's median ms at
             each (M, classes); checkpoint resumes at the dense flagship
             (30 steps, save, 20 more, against a fresh engine that loads
             and runs the same 20) and at the LeNet flagship (3 + 3), every
             state leaf equal, with the save and load ms; a scoring run
             with ``log_pseudodata`` (halfmoon logreg M=30, 101 steps): both
             CSV files with N rows, every grid prediction summing to 1
             within 1e-4, the forgetting calculator's ms; a psvi_evaluate
             engine warm-started from that run's saved results, v equal
             to the saved ``vs[-1]``, 11 steps, no kernel launch;
   options — the engine options and the data readers (``check_options``):
             the literal and argmax-pooled LeNet flagship through
             ``lenet_fwd``/``lenet_rev``, 3 steps each, within the B2 gate of
             the default's state; ``fused_eps="stream"`` at the dense,
             regression and LeNet flagships and LeNet M=16 S=4 T=5, the
             fused step against ``_nested_step`` from one generator state
             and both against float64; every inner optimizer (B1 only
             under Adam); bf16 and packed LeNet and the bf16 LeNet joint run
             through ``backend="pallas"``, no kernel launch; ``synth_cifar``
             read; the argmax pool's tie on the card; then each run of
             ``OPTIONS_RUNS`` (another optimizer, bf16, packed, the stream
             noise, normal_mvn and synth_mnist_hard) held to
             ``OPTIONS_GATES``, JAX's lowest accuracy over three seeds minus
             0.05, every launch count exact;
   zoo     — the model zoo (``check_zoo``): AlexNet (M=100, S=5, T=10,
             B=128, 21 steps) and ResNet-18 (M=50, S=4, T=5, B=128, 11
             steps) at full width on synth_cifar under the nested
             trainer in fp32, halfmoon fn2 2-50-2 and the full-covariance
             logreg (M=30, 101 steps) and fn2 under the hyper trainer (CG,
             11 steps), no kernel launched, each held to ``ZOO_GATES``
             with its step's median ms and peak memory; the joint trainer
             on both nets with ``backend="pallas"`` beside ``"xla"`` (one
             step from one state and generator within B3's gate, and
             within 1e-6 of the xla step fed B3's head values, B3's
             launches by shape as derived, AlexNet's accuracy within 0.05
             of the xla run's after 31 steps); one full-width AlexNet and
             ResNet-18 nested step in float64 on the card against the host
             (CPU) in float64; AlexNet under bf16 with
             ``remat_inner``; one AlexNet nested step rerun bit for bit;
   baselines — the baselines and coreset selection (``check_baselines``):
             every runner of ``BASELINE_RUNS`` through its JAX signature on
             halfmoon logreg (M=30), four_blobs fn 2-40-4 (M=48) and sinus,
             no kernel launched, each held to ``BASELINE_GATES`` (JAX's
             lowest final accuracy over seeds 0-2 minus 0.05; sinus: its
             highest RMSE plus 0.05), with every Laplace evaluation's
             seconds and the NUTS evaluation's accept statistic,
             divergences and seconds; ``CUSTOM_RUNS``, the engine with
             ``init_args='custom'``: the selection launches nothing, then
             B1 (five score methods on four_blobs, 26 steps) or B2 (the
             LeNet flagship on its pretrained net's embeddings, 11 steps)
             once a step, each held to its gate; k-means on those LeNet
             embeddings on the card against the native C++ build from one
             set of k-means++ centroids, inertia within 1e-4, both timed;
   parallel — parallelism and the CLI (``check_parallel``) at the dense
             flagship (four_blobs fn 2-40-4 psvi_learn_v M=48 S=10 T=10
             B=128): the trial runner, 8 trials of 11 steps as one vmapped
             step (B1 refuses it: 0 launches), chained against unchained,
             each trial against a plain engine of its seed fed its
             generator, the batched step's ms beside one trial's plain
             step; the sharded engine on two gloo ranks on the one card
             (``shard_batch`` 64 + 64 rows, ``shard_mc`` 5 + 5 samples,
             each step against the unsharded plain step, the shard_mc
             evaluation, ``run_mfvi`` with ``shard_batch``); ``stream_data``,
             26 steps streamed against resident bit for bit through B1 (26
             launches each), with the µs of a block's index copy; and
             ``python -m psvi_torch.experiments`` (run in this process by
             runpy, so the launch counters read): psvi_learn_v 2 trials of
             26 epochs (B1 26 launches a trial), with ``--trial_parallel``
             and 4 trials (none), and the random baseline, each trial at
             its gate (``PARALLEL_GATES``, ``BASELINE_GATES``);
5. times   — CUDA-event medians of each kernel (each head at its main
             path's shapes; the dense ones also as 50 calls queued behind a
             device sleep), its plain version, the fused engine steps and
             the plain autograd engine steps; B3, its plain version and a
             cuBLAS product on pre-sampled weights at the LeNet fc shapes
             and the zoo's heads (calls queued back to back behind a
             device sleep), and so B4a–c
             at fc1–fc3 and N = 1024 beside B3 and a cuBLAS product, B4d at
             the fc shapes and S = 4000 with its plan; each methods run's
             step (beside the fused nested step at the same config) and the
             LeNet-width hyper and truncated steps; the LeNet
             joint and alternating steps with ``backend="pallas"`` against
             ``backend="xla"``;
   profile — torch.profiler's device time by CUDA kernel over one call of
             each LeNet kernel, one fused LeNet engine step, one LeNet
             joint step with each backend, and 20 calls each of B4c (its
             two passes), B4b, B4a and B3 at fc1; and over one AlexNet and
             one ResNet-18 nested step, with each one's busy share.

Then, as its last three lines: the ``kernels`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no ``ok`` line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Tolerances (kernel against its plain version, both fp32 on the card):
# - losses: rtol 1e-5 — the same fp32 terms summed in another order;
# - paramsT: rtol 2e-4, atol 1e-6 — ten Adam steps divide by √n, which
#   amplifies last-bit differences in small gradients;
# - hypergradients g_u, g_v, g_z, the cotangents p̄, ū, c̄w, z̄ and the Adam
#   moments m, n: cosine > 0.9999 and max |Δ| ≤ 1e-3·max |ref| — sums over S·M
#   terms with cancellation, so an elementwise rtol is not meaningful;
# - g_α: rtol 0.05 — ∂/∂α sums N-scaled terms with heavy cancellation (the
#   JAX reference documents the same f32 spread, tests/test_fused_nested.py).
RTOL_LOSS, RTOL_P, ATOL_P, COS_MIN, REL_G, RTOL_ALPHA = 1e-5, 2e-4, 1e-6, 0.9999, 1e-3, 0.05

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# TF32 on them, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

TPU_KERNEL = "psvi_tpu/ops/fused_nested.py:448"
SOURCE = "psvi_torch/ops/csrc/fused_nested.cu"
LENET_SOURCE = "psvi_torch/ops/csrc/fused_lenet.cu"
LENET_REPLACES = {"lenet_fwd": "psvi_tpu/ops/fused_lenet.py:973",
                  "lenet_rev": "psvi_tpu/ops/fused_lenet.py:997"}
SL_SOURCE = "psvi_torch/ops/csrc/sampled_linear.cu"
SL_REPLACES = "psvi_tpu/ops/pallas_vi.py:84"

# B3 (sampled_linear) against its plain version: the same fp32 products
# summed in another order, so max |Δ| ≤ 1e-5·max |ref| on the output and on
# each gradient of the backward (which also needs cosine > 0.99999).
REL_B3, COS_B3 = 1e-5, 0.99999
# (label, S, N, Din, Dout): the LeNet fc layers at N = M + B = 356, S = 10;
# fn's second layer (40→4) at N = 48 + 128; then ragged and edge shapes; a
# Din past the 512 columns of W_s the forward keeps resident, so that its
# Din-chunk branch runs; and a Din that is no multiple of 4, so that the
# forward's 4-byte copies and loads run
SL_SHAPES = [
    ("fc1", 10, 356, 400, 120), ("fc2", 10, 356, 120, 84), ("fc3", 10, 356, 84, 10),
    ("fn 40-4", 10, 176, 40, 4), ("N=1", 10, 1, 400, 120), ("N=7", 10, 7, 84, 10),
    ("Dout=1", 10, 356, 40, 1), ("S=1", 1, 356, 120, 84), ("S=64 N=2048", 64, 2048, 400, 120),
    ("Din=2048", 2, 64, 2048, 64), ("Din=37", 10, 356, 37, 20),
]

SLP_SOURCE = "psvi_torch/ops/csrc/sampled_linear_prng.cu"
SLP_REPLACES = {"prng_fwd": "psvi_tpu/ops/pallas_vi.py:285",
                "prng_dx": "psvi_tpu/ops/pallas_vi.py:317",
                "prng_dparam": "psvi_tpu/ops/pallas_vi.py:330",
                "prng_nkl": "psvi_tpu/ops/pallas_vi.py:369"}
# B4 (sampled_linear_prng), each kernel against its plain version at REL_B3:
# the LeNet fc shapes at N = 356, the JAX docstring's S=10 400→120
# (pallas_vi.py:25-28) at N = 104 and 1024, and B3's ragged and edge shapes
# (Din=2048 and Din=37 among them: the forward's Din-chunk branch and its
# 4-byte copies);
# the NKL at S = 10 on the fc shapes and at S = 4000 on 64→32 (the KL check's),
# timed; checked also at a ragged E (37→20: 760 elements, three tiles, the
# last ragged) and at S = 1;
# last, a Dout past what dx keeps of W_s in shared memory at once (384 rows),
# so that its Dout-chunk branch runs
SLP_SHAPES = (SL_SHAPES[:3] + [("N=104", 10, 104, 400, 120), ("N=1024", 10, 1024, 400, 120)]
              + SL_SHAPES[4:] + [("Dout=2048", 2, 64, 64, 2048)])
NKL_SHAPES = [(label, 10, Din, Dout) for label, _, _, Din, Dout in SL_SHAPES[:3]] + [
    ("S=4000 64-32", 4000, 64, 32)]
NKL_CHECK_SHAPES = NKL_SHAPES + [("E=760 37-20", 10, 37, 20), ("S=1", 1, 400, 120)]
# Operations of one normal of the in-kernel generator: Philox4x32-10 is 98
# (each of ten rounds two 32-bit multiplies for the low and high words and
# four XORs, nine key bumps of two adds), Box–Muller 13 (two shifts, two
# conversions, three scalings and an add, log, sqrt, cos and the product,
# each counted once).
GEN_OPS = 98 + 13
# the B3 and B4 kernels redesigned for the card, which must build with no spills
B3_NO_SPILL = ("k_sampled_linear",)
B4_NO_SPILL = ("k_prng_fwd", "k_prng_dx", "k_prng_dparam_partial", "k_prng_dparam_reduce",
               "k_prng_nkl", "k_prng_nkl_reduce")
# the LeNet sub-kernels redesigned for the card (the convs, conv2's backward
# and weight gradient and ū from shared-memory tiles; the fc GEMM)
LENET_NO_SPILL = ("k_conv1", "k_conv2", "k_conv2_back", "k_conv2_wpart", "k_ubar_part",
                  "k_ubar_sum", "k_gemm")
# the dense kernels redesigned for the card (a cluster, the per-parameter sums
# spread over threads), which must build with no spills
NESTED_NO_SPILL = ("nested_fwd_kernel", "nested_outer_kernel", "nested_rev_kernel")

# The methods phase: the remaining methods and trainers on the dense
# flagship (four_blobs fn 2-40-4, PERF.md §4), each through run_psvi with
# the final evaluation after steps − 1 steps; (label, engine options, steps).
METHODS_BASE = dict(method="psvi_learn_v", num_pseudo=48, mc_samples=10, architecture="fn",
                    n_hidden=40, n_layers=1, inner_it=10, data_minibatch=128, init_sd=1e-3,
                    seed=0)
# The runs are host-bound plain PyTorch steps (0.1-2.3 s each on the H100),
# so they are cut to 26 steps, and CG on the normal equations to 21, to
# keep the script near four minutes.
METHODS_RUNS = [
    ("psvi_ablated", dict(method="psvi_ablated"), 26),
    ("psvi_no_iw", dict(method="psvi_no_iw"), 26),
    ("psvi_evaluate", dict(method="psvi_evaluate"), 26),
    ("psvi_learn_v learn_z", dict(learn_z=True), 26),
    ("psvi_learn_v truncated K=5", dict(truncated=True, truncated_K=5), 26),
    ("hyper cg_normaleq", dict(trainer="hyper", hypergrad_approx="cg_normaleq"), 21),
    ("hyper fixed_point", dict(trainer="hyper", hypergrad_approx="fixed_point"), 11),
    ("hyper neumann", dict(trainer="hyper", hypergrad_approx="neumann"), 11),
]
# each run's gate: the JAX engine's lowest final accuracy over seeds 0-2 on
# the CPU, minus 0.05 (scripts/torch_methods_jax_gates.py; PERF.md §2)
METHODS_GATES = {"psvi_ablated": 0.875, "psvi_no_iw": 0.875, "psvi_evaluate": 0.905,
                 "psvi_learn_v learn_z": 0.905, "psvi_learn_v truncated K=5": 0.85,
                 "hyper cg_normaleq": 0.87, "hyper fixed_point": 0.84, "hyper neumann": 0.84}

# The parallel phase's runs through the CLI and the trial runner: the dense
# flagship (METHODS_BASE) for 26 steps, its gate JAX's lowest over seeds
# 0-3 minus 0.05 (scripts/torch_methods_jax_gates.py --phases parallel
# --seeds 0 1 2 3; the trial runner's CLI run has four trials)
PARALLEL_RUNS = [("psvi_learn_v", {}, 26)]
PARALLEL_GATES = {"psvi_learn_v": 0.875}

# The lifecycle phase: the dense flagship above (METHODS_BASE) with a
# prune, with the incremental coreset (classes {0, 1} first, one class
# added every 34 steps) and, under the joint trainer through B3, with a
# prune; each through run_psvi, the final evaluation after steps − 1 steps;
# (label, engine options, steps).
LIFECYCLE_RUNS = [
    ("prune 48->24 at 50", dict(prune=True, prune_interval=50, prune_sizes=(24,)), 101),
    ("increment 24-36-48 every 34",
     dict(increment=True, increment_sizes=(24, 36, 48), increment_interval=34), 101),
    # 151 steps: the joint trainer restarts its net at the prune, and 100
    # steps after it are needed for a gate. After 21 steps (pruned at 10)
    # JAX reads 0.51 / 0.045 / 0.535 over seeds 0-2, which gates nothing;
    # after 101 (pruned at 50) it spreads over 0.70-0.905 on seeds 0-4, and
    # the card's seeds 0-4 over 0.585-0.95 (PERF.md §6)
    ("joint pallas prune 48->24 at 50",
     dict(trainer="joint", backend="pallas", prune=True, prune_interval=50, prune_sizes=(24,)),
     151),
]
# each run's gate: the JAX engine's lowest final accuracy over seeds 0-2 on
# the CPU, minus 0.05 (scripts/torch_methods_jax_gates.py; PERF.md §2)
LIFECYCLE_GATES = {"prune 48->24 at 50": 0.90, "increment 24-36-48 every 34": 0.895,
                   "joint pallas prune 48->24 at 50": 0.845}


# The options phase: the engine options and the data readers, each run
# through run_psvi with its final evaluation after steps − 1 steps;
# (label, dataset, base options, engine options, steps, the fused path
# it must take: "dense" (B1 once a step), "lenet" (B2 once a step) or
# None (no kernel: another inner optimizer, bf16 or packed))
LOGREG_BASE = dict(method="psvi_learn_v", num_pseudo=30, mc_samples=10,
                   architecture="logistic_regression", inner_it=10, data_minibatch=128,
                   init_sd=1e-3, seed=0)
LENET_BASE = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=100, mc_samples=10,
                  inner_it=20, data_minibatch=256, init_sd=1e-3, seed=0)
OPTIONS_RUNS = [
    ("four_blobs fn 2-40-4 M=48 fused_eps=stream", "four_blobs", METHODS_BASE,
     dict(fused_eps="stream"), 101, "dense"),
    ("four_blobs fn 2-40-4 M=48 inner rmsprop", "four_blobs", METHODS_BASE,
     dict(inner_optimizer="rmsprop"), 26, None),
    ("four_blobs fn 2-40-4 M=48 inner adamw", "four_blobs", METHODS_BASE,
     dict(inner_optimizer="adamw"), 26, None),
    ("halfmoon logreg M=30 bfloat16", "halfmoon", LOGREG_BASE,
     dict(compute_dtype="bfloat16"), 101, None),
    ("four_blobs fn 2-40-4 M=48 packed", "four_blobs", METHODS_BASE, dict(packed=True), 26, None),
    ("normal_mvn logreg M=30", "normal_mvn", LOGREG_BASE, {}, 26, "dense"),
    ("synth_mnist_hard lenet M=100 S=10 T=20 B=256", "synth_mnist_hard", LENET_BASE, {}, 31,
     "lenet"),
]
# each run's gate: the JAX engine's lowest final accuracy over seeds 0-2 on
# the CPU, minus 0.05, and those accuracies (scripts/torch_methods_jax_gates.py
# --phases options; PERF.md §2); the stream run keeps the engine phase's
# 0.90 for four_blobs. synth_mnist_hard has a Bayes ceiling near 0.90, and
# JAX's seeds leave its gate above chance (0.1).
OPTIONS_JAX_ACCS = {
    "four_blobs fn 2-40-4 M=48 fused_eps=stream": [0.945, 0.945, 0.970],
    "four_blobs fn 2-40-4 M=48 inner rmsprop": [0.945, 0.950, 0.965],
    "four_blobs fn 2-40-4 M=48 inner adamw": [0.925, 0.950, 0.965],
    "halfmoon logreg M=30 bfloat16": [0.820, 0.840, 0.765],
    "four_blobs fn 2-40-4 M=48 packed": [0.925, 0.950, 0.960],
    "normal_mvn logreg M=30": [0.6875, 0.6475, 0.3875],
    "synth_mnist_hard lenet M=100 S=10 T=20 B=256": [0.850, 0.835, 0.839],
}
OPTIONS_GATES = {
    "four_blobs fn 2-40-4 M=48 fused_eps=stream": 0.90,
    "four_blobs fn 2-40-4 M=48 inner rmsprop": 0.895,
    "four_blobs fn 2-40-4 M=48 inner adamw": 0.875,
    "halfmoon logreg M=30 bfloat16": 0.715,
    "four_blobs fn 2-40-4 M=48 packed": 0.875,
    # below chance (0.5): JAX's seed 2 reads 0.3875 after 26 steps
    "normal_mvn logreg M=30": 0.3375,
    "synth_mnist_hard lenet M=100 S=10 T=20 B=256": 0.785,
}

# The zoo phase: the model zoo's nested runs through run_psvi, each with its
# final evaluation after steps − 1 steps; (label, dataset, engine options,
# steps). AlexNet and ResNet-18 run RESULTS.md's synth_cifar configurations
# (the nested trainer, psvi_learn_v) in fp32 without remat; the
# full-covariance nets the halfmoon logreg cell's (LOGREG_BASE).
ZOO_BASE = dict(method="psvi_learn_v", init_sd=1e-3, seed=0)
ALEXNET_KW = dict(ZOO_BASE, architecture="alexnet", num_pseudo=100, mc_samples=5, inner_it=10,
                  data_minibatch=128)
RESNET_KW = dict(ZOO_BASE, architecture="resnet", num_pseudo=50, mc_samples=4, inner_it=5,
                 data_minibatch=128)
FN2_KW = dict(LOGREG_BASE, architecture="fn2", n_hidden=50)
ZOO_RUNS = [
    ("synth_cifar alexnet M=100 S=5 T=10 B=128", "synth_cifar", ALEXNET_KW, 21),
    ("synth_cifar resnet18 M=50 S=4 T=5 B=128", "synth_cifar", RESNET_KW, 11),
    ("halfmoon fn2 2-50-2 M=30", "halfmoon", FN2_KW, 101),
    ("halfmoon logreg_fullcov M=30", "halfmoon",
     dict(LOGREG_BASE, architecture="logistic_regression_fullcov"), 101),
    ("halfmoon fn2 2-50-2 M=30 hyper cg_normaleq", "halfmoon",
     dict(FN2_KW, trainer="hyper", hypergrad_approx="cg_normaleq"), 11),
]
# each run's gate: the JAX engine's lowest final accuracy over seeds 0-2 on
# the CPU, minus 0.05, and those accuracies (scripts/torch_methods_jax_gates.py
# --phases zoo); for AlexNet and ResNet-18 the accuracy RESULTS.md records for
# the JAX package's run of the same configuration under bf16 and remat
# (1.000 at the last evaluation) minus 0.05: their unrolled inner loops take
# about 16 GB in JAX (RESULTS.md), so the gates script runs them only as a
# phase of their own, ``--phases zoo_cifar``, on a host with that memory free
# (not yet run). Both nets reach 1.0 on synth_cifar within the first few
# steps, so these two gates catch a broken run more than a wrong step: the
# float64 check below (ZOO_F64_RUNS) holds the step itself
ZOO_JAX_ACCS = {
    "synth_cifar alexnet M=100 S=5 T=10 B=128": "RESULTS.md: 1.000 at steps 5, 10 and 20",
    "synth_cifar resnet18 M=50 S=4 T=5 B=128": "RESULTS.md: 1.000 at step 10",
    "halfmoon fn2 2-50-2 M=30": [0.845, 0.870, 0.860],
    "halfmoon logreg_fullcov M=30": [0.805, 0.840, 0.855],
    "halfmoon fn2 2-50-2 M=30 hyper cg_normaleq": [0.640, 0.740, 0.795],
}
ZOO_GATES = {
    "synth_cifar alexnet M=100 S=5 T=10 B=128": 0.95,
    "synth_cifar resnet18 M=50 S=4 T=5 B=128": 0.95,
    "halfmoon fn2 2-50-2 M=30": 0.795,
    "halfmoon logreg_fullcov M=30": 0.755,
    "halfmoon fn2 2-50-2 M=30 hyper cg_normaleq": 0.59,
}
# B3 at the zoo's dense heads, (label, S, N, Din, Dout): AlexNet's three
# under the joint trainer at S=10, N = M + B = 100 + 128, and ResNet-18's at
# its nested run's S=4, N = 50 + 128
ZOO_SL_SHAPES = [
    ("alexnet fc1", 10, 228, 4096, 384), ("alexnet fc2", 10, 228, 384, 192),
    ("alexnet fc3", 10, 228, 192, 10), ("resnet18 fc", 4, 178, 512, 10),
]

# the joint step on the zoo nets, B3 beside xla from one state and draw
# (scripts/torch_zoo_fp64_gaps.py, H100): the B3 step against the xla step
# fed B3's head values read ≤ 1.6e-7·max|ref| in every leaf (the backward
# is autograd's; only the heads' forward rounding differs), gated at 1e-6;
# the B3 step against the xla step read 1.26e-3 (AlexNet's conv2 ρ) and
# 4.6e-5 (ResNet-18), where the fp32 xla step itself lies 3.2e-3–4.3e-3
# (AlexNet's conv2 leaves) and up to 6.5e-2 (ResNet-18) off its float64
# run: gated at 5e-3
REL_B3_HEADS_ONLY, REL_JOINT_MOMENT = 1e-6, 5e-3
# one full-width nested step of each conv net on the card against the same
# step on the host, both in float64 (fewer samples and inner steps than the
# runs, the same widths): the script read 1.8e-9 (AlexNet) and 2.9e-8
# (ResNet-18) at the runs' own M, S, T, B, gated at 1e-6; the fp32 step is
# reported beside it (far from float64: Adam's first inner step,
# −lr·sign(g), flips where |g| lies within fp32's rounding)
REL_F64_HOST = 1e-6
ZOO_F64_RUNS = [
    ("synth_cifar alexnet M=100 S=2 T=3 B=128", {**ALEXNET_KW, "mc_samples": 2, "inner_it": 3}),
    ("synth_cifar resnet18 M=50 S=2 T=2 B=64",
     {**RESNET_KW, "mc_samples": 2, "inner_it": 2, "data_minibatch": 64}),
]

# The baselines phase (queue A.10): the baselines and coreset selection.
# Each runner keeps JAX's signature: (label, module, runner, dataset,
# options). halfmoon Bayesian logreg at BENCHMARKS.md's target M=30 (the
# growth baselines run until the coreset reaches it; GIGA 10·M + 1 epochs,
# a greedy step every 10; opsvi and mfvi_subset 101 epochs at M=30); four_blobs
# fn 2-40-4 (BENCHMARKS.md's four_blobs table: M=48, 101 epochs, the MFVI
# selection flows pretraining 5 epochs); sinus regressor_net 1-40-1 with
# the tau grid search (20 epochs of B=128 steps). The halfmoon runs take
# lr0net=1e-2 (the package default is 1e-3): a run's final accuracy is one
# Laplace evaluation, 1000 Adam steps from θ0 ~ N(0, I), and at 1e-3 those
# steps cannot reach the MAP (|θ| ≈ 5.6 on a coreset of 30), so the reading
# is a draw of an unconverged fit (JAX over seeds 0-7: sparsevi 0.575-0.825,
# mfvi_subset 0.495-0.83; the card's seed 0 read 0.43 and 0.19, its
# evaluation of one coreset over 16 draws 0.14-0.86): no gate can hold it.
# At 1e-2 JAX reads 0.82-0.875 and 0.825-0.875 over seeds 0-7. k-means and
# EL2N keep 1e-3: they evaluate each coreset with the weights of the
# previous one (the reference's order), near the prior whatever the fit.
HALFMOON_LR = dict(mc_samples=10, seed=0, lr0net=1e-2)
BLOBS_FN = dict(architecture="fn", n_hidden=40, nc=4, mc_samples=10, data_minibatch=128,
                init_sd=1e-3, seed=0)
BASELINE_RUNS = [
    ("halfmoon random M=30", "baselines", "run_random", "halfmoon",
     dict(HALFMOON_LR, num_epochs=31, log_every=30)),
    ("halfmoon giga log_every M=30", "baselines", "run_giga", "halfmoon",
     dict(HALFMOON_LR, num_epochs=301, log_every=10, data_minibatch=128)),
    ("halfmoon giga every_step M=30", "baselines", "run_giga", "halfmoon",
     dict(HALFMOON_LR, num_epochs=301, log_every=10, data_minibatch=128,
          giga_growth="every_step")),
    ("halfmoon sparsevi M=30", "baselines", "run_sparsevi", "halfmoon",
     dict(HALFMOON_LR, num_epochs=31, log_every=30, inner_it=20, outer_it=100,
          data_minibatch=128)),
    ("halfmoon opsvi M=30", "baselines", "run_opsvi", "halfmoon",
     dict(HALFMOON_LR, num_pseudo=30, num_epochs=101, log_every=50, inner_it=20,
          data_minibatch=128)),
    ("halfmoon sparsebbvi M=30", "sparsebbvi", "run_sparsevi_with_bb_elbo", "halfmoon",
     dict(HALFMOON_LR, num_epochs=31, log_every=30, inner_it=10, outer_it=20,
          data_minibatch=128)),
    ("halfmoon mfvi_subset M=30", "baselines", "run_mfvi_subset", "halfmoon",
     dict(HALFMOON_LR, architecture="logistic_regression", nc=2, num_pseudo=30, num_epochs=101,
          log_every=50, init_sd=1e-3, data_minibatch=128)),
    ("halfmoon kmeans M=30", "baselines", "run_kmeans", "halfmoon",
     dict(HALFMOON_LR, nc=2, num_epochs=31, log_every=30, lr0net=1e-3)),
    ("halfmoon el2n M=30", "baselines", "run_el2n_coreset", "halfmoon",
     dict(HALFMOON_LR, nc=2, num_epochs=31, log_every=30, lr0net=1e-3)),
    ("halfmoon random mcmc M=30", "baselines", "run_random", "halfmoon",
     dict(HALFMOON_LR, num_epochs=31, log_every=30, mcmc=True)),
    ("four_blobs fn 2-40-4 mfvi", "baselines", "run_mfvi", "four_blobs",
     dict(BLOBS_FN, num_epochs=101, log_every=50)),
    ("four_blobs fn 2-40-4 mfvi_subset M=48", "baselines", "run_mfvi_subset", "four_blobs",
     dict(BLOBS_FN, num_pseudo=48, num_epochs=101, log_every=50)),
    ("four_blobs fn 2-40-4 mfvi_selection el2n M=48", "baselines", "run_selection_with_mfvi",
     "four_blobs", dict(BLOBS_FN, mfvi_selection_method="el2n", num_pseudo=48,
                        num_epochs=101, log_every=50, pretrain_epochs=5)),
    ("four_blobs fn 2-40-4 mfvi_selection kmeans M=48", "baselines", "run_selection_with_mfvi",
     "four_blobs", dict(BLOBS_FN, mfvi_selection_method="kmeans", num_pseudo=48,
                        num_epochs=101, log_every=50, pretrain_epochs=5)),
    ("sinus mfvi_regressor", "baselines", "run_mfvi_regressor", "sinus",
     dict(mc_samples=10, num_epochs=20, log_every=50, seed=0, model_selection=True)),
    ("sinus mfvi_subset_regressor M=50", "baselines", "run_mfvi_subset_regressor", "sinus",
     dict(mc_samples=10, num_epochs=20, log_every=50, seed=0, num_pseudo=50)),
]
# the engine with init_args='custom' at the methods phase's base (four_blobs
# fn 2-40-4, M=48, S=10, T=10, B=128), B1 once a step, and at the LeNet
# flagship (synth_mnist, M=100, S=10, T=20, B=256) on the pretrained net's
# embeddings, B2 once a step; (label, dataset, options, steps, fused path)
CUSTOM_RUNS = [
    *[(f"four_blobs fn 2-40-4 M=48 custom {m}", "four_blobs",
       dict(METHODS_BASE, init_args="custom", mfvi_selection_method=m), 26, "dense")
      for m in ("kmeans", "submodular", "entropy", "scored_kmeans_entropy", "kmeans_gradient")],
    ("synth_mnist lenet M=100 S=10 T=20 B=256 custom kmeans", "synth_mnist",
     dict(LENET_BASE, init_args="custom", mfvi_selection_method="kmeans", pretrain_epochs=5),
     11, "lenet"),
]
# each run's gate: the JAX package's lowest final accuracy over seeds 0-2 on
# the CPU minus 0.05 (sinus: its highest final test RMSE plus 0.05), and
# those readings (scripts/torch_methods_jax_gates.py --phases baselines)
BASELINE_JAX = {
    'halfmoon random M=30': [0.87, 0.865, 0.84],
    'halfmoon giga log_every M=30': [0.295, 0.775, 0.745],
    'halfmoon giga every_step M=30': [0.86, 0.885, 0.855],
    'halfmoon sparsevi M=30': [0.835, 0.84, 0.865],
    'halfmoon opsvi M=30': [0.855, 0.875, 0.875],
    'halfmoon sparsebbvi M=30': [0.78, 0.825, 0.84],
    'halfmoon mfvi_subset M=30': [0.865, 0.85, 0.875],
    'halfmoon kmeans M=30': [0.42, 0.505, 0.62],
    'halfmoon el2n M=30': [0.42, 0.505, 0.62],
    'halfmoon random mcmc M=30': [0.88, 0.87, 0.84],
    'four_blobs fn 2-40-4 mfvi': [0.945, 0.945, 0.945],
    'four_blobs fn 2-40-4 mfvi_subset M=48': [0.935, 0.945, 0.96],
    'four_blobs fn 2-40-4 mfvi_selection el2n M=48': [0.73, 0.51, 0.66],
    'four_blobs fn 2-40-4 mfvi_selection kmeans M=48': [0.955, 0.96, 0.95],
    'sinus mfvi_regressor': [0.3909, 0.4187, 0.4088],
    'sinus mfvi_subset_regressor M=50': [0.4051, 0.4409, 0.4109],
    'four_blobs fn 2-40-4 M=48 custom kmeans': [0.96, 0.95, 0.965],
    'four_blobs fn 2-40-4 M=48 custom submodular': [0.965, 0.94, 0.95],
    'four_blobs fn 2-40-4 M=48 custom entropy': [0.845, 0.8, 0.865],
    'four_blobs fn 2-40-4 M=48 custom scored_kmeans_entropy': [0.97, 0.96, 0.97],
    'four_blobs fn 2-40-4 M=48 custom kmeans_gradient': [0.96, 0.94, 0.95],
    'synth_mnist lenet M=100 S=10 T=20 B=256 custom kmeans': [1.0, 1.0, 1.0],
}
BASELINE_GATES = {
    'halfmoon random M=30': 0.79,
    'halfmoon giga log_every M=30': 0.245,
    'halfmoon giga every_step M=30': 0.805,
    'halfmoon sparsevi M=30': 0.785,
    'halfmoon opsvi M=30': 0.805,
    'halfmoon sparsebbvi M=30': 0.73,
    'halfmoon mfvi_subset M=30': 0.8,
    'halfmoon kmeans M=30': 0.37,
    'halfmoon el2n M=30': 0.37,
    'halfmoon random mcmc M=30': 0.79,
    'four_blobs fn 2-40-4 mfvi': 0.895,
    'four_blobs fn 2-40-4 mfvi_subset M=48': 0.885,
    'four_blobs fn 2-40-4 mfvi_selection el2n M=48': 0.46,
    'four_blobs fn 2-40-4 mfvi_selection kmeans M=48': 0.9,
    'sinus mfvi_regressor': 0.4687,
    'sinus mfvi_subset_regressor M=50': 0.4909,
    'four_blobs fn 2-40-4 M=48 custom kmeans': 0.9,
    'four_blobs fn 2-40-4 M=48 custom submodular': 0.89,
    'four_blobs fn 2-40-4 M=48 custom entropy': 0.75,
    'four_blobs fn 2-40-4 M=48 custom scored_kmeans_entropy': 0.91,
    'four_blobs fn 2-40-4 M=48 custom kmeans_gradient': 0.89,
    'synth_mnist lenet M=100 S=10 T=20 B=256 custom kmeans': 0.95,
}
TRAIN_RUNNERS = ("run_mfvi", "run_mfvi_subset", "run_selection_with_mfvi", "run_mfvi_regressor",
                 "run_mfvi_subset_regressor")


def runner_data(module, runner, data):
    """A runner's data arguments, as the JAX package's INF_DICT passes them."""
    if runner in TRAIN_RUNNERS:
        return {"train": data, **({"N": data.N, "D": data.D} if runner == "run_mfvi" else {})}
    xy = dict(x=data.x, y=data.y, xt=data.xt, yt=data.yt)
    return xy if module == "sparsebbvi" else {**xy, "N": data.N, "D": data.D}


def final_metric(res):
    """A run's final accuracy, or final test RMSE for the regressors."""
    return ("rmse", res["rmses"][-1]) if "rmses" in res else ("acc", res["accs"][-1])

_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_properties(log):
    """{mangled kernel name: its stack and spill line} from nvcc's ``-Xptxas
    -v`` output, where each "Function properties for <name>" line is
    followed by that line."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif name and "spill stores" in ln:
            out[name] = ln
            name = None
    return out


def ptxas_spills(log):
    """{mangled kernel name: (spill store bytes, spill load bytes)}."""
    return {name: tuple(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
            for name, ln in ptxas_properties(log).items()}


def ptxas_stack(log, kernels):
    """Each kernel's stack-frame bytes, one entry per instantiation (matched
    as ``check_no_spills`` matches)."""
    stack = {name: int(re.search(r"(\d+) bytes stack frame", ln).group(1))
             for name, ln in ptxas_properties(log).items()}
    return {k: [v for m, v in stack.items() if f"{len(k)}{k}" in m] for k in kernels}


def check_no_spills(log, kernels):
    """Each kernel's spill bytes, one (stores, loads) pair per instantiation
    of a template (a C++ kernel's mangled name holds its name after its
    length); raises unless every one is built with none."""
    spills = ptxas_spills(log)
    got = {k: [v for m, v in spills.items() if f"{len(k)}{k}" in m] for k in kernels}
    bad = {k: v for k, v in got.items() if not v or any(any(x) for x in v)}
    if bad:
        raise AssertionError(f"kernels built with spills, or not found in ptxas's report: {bad}")
    return got


def _rel(x, y):
    return float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)


def _cos(x, y):
    x, y = x.double().flatten(), y.double().flatten()
    return float(x @ y / (x.norm() * y.norm() + 1e-30))


class Checker:
    """Collects comparisons; raises on the first that fails."""

    def __init__(self):
        self.max_abs = {}

    def _note(self, kernel, x, y):
        e = float((x - y).abs().max())
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), e)
        return e

    def allclose(self, kernel, what, x, y, rtol, atol=0.0):
        e = self._note(kernel, x, y)
        ok = bool(torch.all((x - y).abs() <= atol + rtol * y.abs()))
        if not ok:
            raise AssertionError(f"{kernel}/{what}: max |diff| {e} exceeds rtol {rtol} atol {atol}")
        return e

    def grad(self, kernel, what, x, y):
        e = self._note(kernel, x, y)
        c, r = _cos(x, y), _rel(x, y)
        if not (c > COS_MIN and r <= REL_G):
            raise AssertionError(f"{kernel}/{what}: cos {c}, max|Δ|/max|ref| {r}")
        return {"max_abs": e, "cos": c}


def main_cfg(FN, data, widths, M, parameterised, use_alpha, B=128, tau=None):
    """The main paths' step shape (S = 10, T = 10) for one net: the
    categorical head, or with ``tau`` the Gaussian head at that precision
    with learned targets (the regressors)."""
    lik = {} if tau is None else dict(likelihood="gaussian", tau=tau, learn_z=True)
    return FN.FusedCfg(T=10, S=10, widths=tuple(widths), M=M, B=B, N=float(data.N),
                       parameterised=parameterised, use_alpha=use_alpha, prior_sd=1.0, **lik)


def branch(cfg, name):
    """A kernel's name for its likelihood branch, as the launch counters and
    the ``kernels`` line name it."""
    return name + ("_gaussian" if cfg.gaussian else "")


def kernel_inputs(FN, cfg, x, y, seed, dev, dtype=torch.float32, lr=1e-3):
    """Engine-like inputs for ``cfg`` from numpy.random.default_rng(seed), in
    the engine's natural layouts and flat: U(±1/√in) means, ρ =
    softplus⁻¹(1e-3) plus a small spread, coreset and minibatch rows drawn
    from (x, y) (int32 labels, or real targets for a Gaussian head), noise
    ~ N(0, 1). The same seed gives the same numbers in any ``dtype``."""
    rng = np.random.default_rng(seed)
    rho0 = math.log(math.expm1(1e-3))
    T, S = cfg.T, cfg.S
    layers, e_in, e_out = [], [], []
    for i, o in cfg.layer_dims():
        b = 1.0 / math.sqrt(i)
        layers.append({
            "mu_w": rng.uniform(-b, b, (o, i)), "rho_w": rho0 + 0.1 * rng.standard_normal((o, i)),
            "mu_b": rng.uniform(-b, b, o), "rho_b": rho0 + 0.1 * rng.standard_normal(o)})
        e_in.append({"w": rng.standard_normal((T, S, o, i)), "b": rng.standard_normal((T, S, o))})
        e_out.append({"w": rng.standard_normal((S, o, i)), "b": rng.standard_normal((S, o))})
    iu = rng.choice(len(x), cfg.M, replace=False)
    ib = rng.choice(len(x), cfg.B, replace=False)
    v = 0.3 * rng.standard_normal(cfg.M) if cfg.parameterised else np.full(cfg.M, 1.0 / cfg.M)
    y = np.asarray(y).reshape(len(y), -1)[:, 0]
    ty = dtype if cfg.gaussian else torch.int32

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    def tree(ls):
        return [{k: t(v) for k, v in d.items()} for d in ls]

    a = dict(params0=tree(layers), eps_inner=tree(e_in), eps_outer=tree(e_out), u=t(x[iu]),
             z=t(y[iu], ty), xb=t(x[ib]), yb=t(y[ib], ty), v=t(v),
             alpha=t([0.1 if cfg.use_alpha else 0.0]), lr=lr)
    a.update(p0=FN.pack_params(a["params0"]), e_in=FN.pack_eps(a["eps_inner"], lead=(T,)),
             e_out=FN.pack_eps(a["eps_outer"]))
    return a


def composed_step(FN, cfg, a, backend):
    """``fused_nested_outer`` on the natural layouts; paramsT comes back flat."""
    loss, il, pT, g_u, g_v, g_a, g_z = FN.fused_nested_outer(
        a["params0"], a["u"], a["v"], a["alpha"], a["z"], a["xb"], a["yb"], a["eps_inner"],
        a["eps_outer"], a["lr"], cfg, backend=backend)
    return loss, il, FN.pack_params(pT), g_u, g_v, g_a, g_z


def compare_steps(chk, tag, cfg, k, r):
    """The composed step's outputs ``k`` against the reference's ``r``."""
    out = {
        "loss": chk.allclose(tag, "loss", k[0], r[0], RTOL_LOSS),
        "inner_losses": chk.allclose(tag, "inner_losses", k[1], r[1], RTOL_LOSS),
        "paramsT": chk.allclose(tag, "paramsT", k[2], r[2], RTOL_P, ATOL_P),
        "g_u": chk.grad(tag, "g_u", k[3], r[3]),
        "g_v": chk.grad(tag, "g_v", k[4], r[4]),
    }
    if cfg.use_alpha:
        out["g_alpha"] = chk.allclose(tag, "g_alpha", k[5], r[5], RTOL_ALPHA, ATOL_P)
    if cfg.learn_z:
        out["g_z"] = chk.grad(tag, "g_z", k[6], r[6])
    return out


def check_kernels(FN, chk, name, cfg, a):
    """Each kernel against its plain version on the same CUDA inputs (each
    fed the plain versions' upstream outputs), then the composed step
    against the plain and the autograd-oracle backends. For a Gaussian head
    also z̄: the outer step's, and the reverse sweep's from a zero z̄ input,
    so that the T iterations' terms are compared on their own."""
    p0, u, z, xb, yb, v, al, e_in, e_out, lr = (a[k] for k in (
        "p0", "u", "z", "xb", "yb", "v", "alpha", "e_in", "e_out", "lr"))
    fwd, outer, rev = (branch(cfg, k) for k in ("nested_fwd", "nested_outer", "nested_rev"))
    rep = {"phase": "kernels", "config": name, "widths": list(cfg.widths), "M": cfg.M,
           "likelihood": cfg.likelihood, "plans": nested_plans(FN, cfg)}
    # nested_fwd, and a rerun bit for bit
    l_k, h_k, cw_k = FN._nested_fwd_cuda(p0, u, z, v, al, e_in, lr, cfg)
    same_bits(FN._nested_fwd_cuda(p0, u, z, v, al, e_in, lr, cfg), (l_k, h_k, cw_k), fwd)
    l_t, h_t, cw_t = FN.nested_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)
    torch.cuda.synchronize()
    rep["fwd"] = {
        "losses": chk.allclose(fwd, "losses", l_k, l_t, RTOL_LOSS),
        "paramsT": chk.allclose(fwd, "paramsT", h_k[:, 0], h_t[:, 0], RTOL_P, ATOL_P),
        "m": chk.grad(fwd, "m", h_k[:, 1], h_t[:, 1]),
        "n": chk.grad(fwd, "n", h_k[:, 2], h_t[:, 2]),
        "cw": chk.allclose(fwd, "cw", cw_k, cw_t, RTOL_LOSS),
    }
    # nested_outer on the plain version's paramsT and core weights, and a rerun
    pT = h_t[cfg.T, 0].contiguous()
    o_k = FN._nested_outer_cuda(pT, u, z, cw_t, xb, yb, e_out, cfg)
    same_bits(FN._nested_outer_cuda(pT, u, z, cw_t, xb, yb, e_out, cfg), o_k, outer)
    o_t = FN.nested_outer_torch(pT, u, z, cw_t, xb, yb, e_out, cfg)
    torch.cuda.synchronize()
    rep["outer"] = {
        "loss": chk.allclose(outer, "loss", o_k[0], o_t[0], RTOL_LOSS),
        "pbar": chk.grad(outer, "pbar", o_k[1], o_t[1]),
        "ubar": chk.grad(outer, "ubar", o_k[2], o_t[2]),
        "cwbar": chk.grad(outer, "cwbar", o_k[3], o_t[3]),
    }
    if cfg.learn_z:
        rep["outer"]["zbar"] = chk.grad(outer, "zbar", o_k[4], o_t[4])
    # both fp32 versions against the plain version in float64 on the same
    # inputs: max |Δ|/max |ref| of each cotangent
    o_64 = FN.nested_outer_torch(*(x.double() if x.is_floating_point() else x
                                   for x in (pT, u, z, cw_t, xb, yb, e_out)), cfg)
    rep["outer"]["vs_float64"] = {
        nm: {"kernel": _rel(o_k[i].double(), o_64[i]), "plain": _rel(o_t[i].double(), o_64[i])}
        for i, nm in enumerate(("pbar", "ubar", "cwbar", "zbar"), 1)
        if i < 4 or cfg.learn_z}
    # nested_rev on the plain versions' history and cotangents, and a rerun
    zbar0 = torch.zeros_like(o_t[4])
    rev_args = (h_t, o_t[1].contiguous(), o_t[2].contiguous(), o_t[3].contiguous(), zbar0, u,
                z, cw_t, v, al, e_in, lr, cfg)
    r_k = FN._nested_rev_cuda(*rev_args)
    same_bits(FN._nested_rev_cuda(*rev_args), r_k, rev)
    r_t = FN.nested_rev_torch(h_t, o_t[1], o_t[2], o_t[3], zbar0, u, z, cw_t, v, al, e_in, lr,
                              cfg)
    torch.cuda.synchronize()
    rep["rev"] = {"g_u": chk.grad(rev, "g_u", r_k[0], r_t[0]),
                  "g_v": chk.grad(rev, "g_v", r_k[1], r_t[1])}
    if cfg.use_alpha:
        rep["rev"]["g_alpha"] = chk.allclose(rev, "g_alpha", r_k[2], r_t[2], RTOL_ALPHA, ATOL_P)
    if cfg.learn_z:
        rep["rev"]["g_z_unroll_terms"] = chk.grad(rev, "g_z", r_k[3], r_t[3])
    # the composed step: cuda against torch and against the autograd oracle
    outs = {b: composed_step(FN, cfg, a, b) for b in ("cuda", "torch", "autograd")}
    torch.cuda.synchronize()
    rep["step"] = {ref: compare_steps(chk, f"step_vs_{ref}", cfg, outs["cuda"], outs[ref])
                   for ref in ("torch", "autograd")}
    emit(rep)


def nested_plans(FN, cfg):
    """The launch plans of the three dense kernels at ``cfg``
    (``_nested_plan``): the cluster's blocks C, the samples a block holds at
    most, and whether the maps lie in shared memory."""
    out = {}
    for kernel in ("nested_fwd", "nested_outer", "nested_rev"):
        p = FN._nested_plan(cfg, kernel)
        out[kernel] = {"blocks": p.blocks, "samples_per_block": p.samples_per_block,
                       "maps": "shared" if p.shared else "global", "smem_bytes": p.smem_bytes}
    return out


def centring_effect(FN, cfg, a):
    """Does the Gaussian head need the outer IW-ELBO's centring? The outer
    loss's gradient w.r.t. (u, z, cw) at paramsT in fp32 on the card, written
    as the JAX package writes it (Σ_s w_s·d_s) and as the port does (d
    centred at its weighted mean), each against float64; max |Δ|/max |ref|."""
    from psvi_torch.models.networks import make_dense
    from psvi_torch.ops import elbo as E

    def grads(dtype, centred):
        net = make_dense(cfg.widths, prior_sd=cfg.prior_sd)
        c = {k: (a[k].to(dtype) if torch.is_tensor(a[k]) else a[k]) for k in a}
        _, h, cw = FN.nested_fwd_torch(c["p0"], c["u"], c["z"], c["v"], c["alpha"], c["e_in"],
                                       c["lr"], cfg)
        params = [{} for _ in net.layers]
        eps = [{} for _ in net.layers]
        for k, (p, (w, b)) in enumerate(zip(FN.unpack_params(h[cfg.T, 0], cfg),
                                            FN.unpack_eps(c["e_out"], cfg))):
            params[2 * k], eps[2 * k] = p, {"w": w, "b": b}
        with torch.enable_grad():
            u, z, cw = (x.detach().clone().requires_grad_(True) for x in (c["u"], c["z"], cw))
            out = net.apply(tuple(params), tuple(eps), torch.cat([u, c["xb"]]))[..., 0]
            nll = E.gaussian_nll(out, torch.cat([z, c["yb"]]), cfg.tau)
            pseudo = nll[:, :cfg.M] @ cw
            lw = -pseudo + net.nkl(tuple(params), tuple(eps))
            w = torch.softmax(lw, 0)
            d = (cfg.N / cfg.B) * nll[:, cfg.M:].sum(1) - pseudo
            ref = (w * d).sum().detach() if centred else 0.0
            loss = ref + (w * (d - ref)).sum() - lw.mean()
            return torch.autograd.grad(loss, (u, z, cw)), float(loss.detach())

    truth, loss64 = grads(torch.float64, True)
    rep = {"phase": "centring", "outer_loss_float64": loss64}
    for centred in (False, True):
        got, _ = grads(torch.float32, centred)
        rep["centred" if centred else "uncentred"] = {
            k: _rel(g.double(), r) for k, g, r in zip(("ubar", "zbar", "cwbar"), got, truth)}
    emit(rep)


def regression_bundle(DataBundle, D, n=4096, seed=0):
    """N(0, 1) inputs and normalised targets: enough rows for any cap."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = rng.standard_normal((n, 1)).astype(np.float32)
    return DataBundle(x, y, x[:256], y[:256], n, D, 1)


def synthetic_bundle(DataBundle, D, nc, n=4096, seed=0):
    """N(0, 1) inputs with uniform labels: enough rows for any cap."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = rng.integers(0, nc, n).astype(np.float32)
    return DataBundle(x, y, x[:256], y[:256], n, D, nc)


# Engines at the edges of supports(): the widest layer of the JAX gate at
# S = 10, S·width = 2048 with S = 32 and M + B = 2048, and L = 8 dense layers;
# for each head (nc = 1 is the Gaussian one, the regressors).
CAPS = [
    ("fn 64-100-10 psvi M=30", 64, 10,
     dict(method="psvi", architecture="fn", n_hidden=100, num_pseudo=30, mc_samples=10,
          data_minibatch=128)),
    ("fn 2-64-4 psvi_alpha_v S=32 M=48 B=2000", 2, 4,
     dict(method="psvi_alpha_v", architecture="fn", n_hidden=64, num_pseudo=48, mc_samples=32,
          data_minibatch=2000)),
    ("fn 2-(40x7)-4 psvi_learn_v L=8 M=48", 2, 4,
     dict(method="psvi_learn_v", architecture="fn", n_hidden=40, n_layers=7, num_pseudo=48,
          mc_samples=10, data_minibatch=128)),
    ("regressor 64-100-1 psvi_learn_v_regressor M=30", 64, 1,
     dict(method="psvi_learn_v_regressor", architecture="regressor_net", n_hidden=100,
          num_pseudo=30, mc_samples=10, data_minibatch=128, tau=0.1)),
    ("regressor 1-64-1 psvi_alpha_v_regressor S=32 M=48 B=2000", 1, 1,
     dict(method="psvi_alpha_v_regressor", architecture="regressor_net", n_hidden=64,
          num_pseudo=48, mc_samples=32, data_minibatch=2000, tau=1.0)),
    ("regressor 1-(40x7)-1 psvi_regressor L=8 M=48", 1, 1,
     dict(method="psvi_regressor", architecture="regressor_net", n_hidden=40, n_layers=7,
          num_pseudo=48, mc_samples=10, data_minibatch=128, tau=0.1)),
]


def check_caps(FN, make_psvi_engine, DataBundle, chk, dev):
    """At each edge of supports(): the engine admits the config, and the
    composed CUDA step agrees with the plain version run in float64 (the
    judge of both fp32 versions) within the tolerances above."""
    for seed, (name, D, nc, kw) in enumerate(CAPS):
        data = (regression_bundle(DataBundle, D, seed=seed) if nc == 1
                else synthetic_bundle(DataBundle, D, nc, seed=seed))
        eng = make_psvi_engine(data, inner_it=10, init_sd=1e-3, seed=seed, **kw)
        if not FN.supports(eng):
            raise AssertionError(f"supports() refuses the cap config {name}")
        cfg = eng._fused_cfg(eng.data_minibatch)
        k = composed_step(FN, cfg, kernel_inputs(FN, cfg, data.x, data.y, seed, dev), "cuda")
        r = composed_step(FN, cfg, kernel_inputs(FN, cfg, data.x, data.y, seed, dev,
                                                 torch.float64), "torch")
        torch.cuda.synchronize()
        emit({"phase": "caps", "config": name, "widths": list(cfg.widths), "S": cfg.S,
              "M": cfg.M, "B": cfg.B, "likelihood": cfg.likelihood,
              "vs_float64": compare_steps(chk, "caps", cfg, k, r)})


def read_launches(mods, expected):
    """Every kernel's launch count since the last reset; each must equal
    ``expected[name]``."""
    launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items()}
    for k, n in launches.items():
        if n != expected[k]:
            raise AssertionError(f"kernel {k} launched {n} times, expected {expected[k]}")
    return launches


def run_engine(mods, make_psvi_engine, data, expected, **kw):
    """One run_psvi through the user's entry point, with the launch counters
    of every kernel module (``mods``) set to 0 just before and read just
    after; each kernel must have launched ``expected[name]`` times. Returns
    (engine, results, launch counts, seconds)."""
    eng = make_psvi_engine(data, **kw)
    losses, events = [], []
    step = eng._step

    def recording_step(state, **kw):  # kw: a streamed block's batch and noise
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, aux = step(state, **kw)
        ev[1].record()
        events.append(ev)
        losses.append(aux["outer_loss"])
        return state, aux

    eng._step = recording_step
    eng.step_path = step.__name__
    eng.state0 = eng.state
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    res = eng.run_psvi()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(mods, expected)
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    if not finite:
        raise AssertionError("non-finite outer loss on the main path")
    # the step's median ms over the run (CUDA events around each call)
    eng.step_ms = float(np.median([a.elapsed_time(b) for a, b in events]))
    return eng, res, launches, secs


def hypergrads_of(eng, step, state, batch, eps):
    """One step and the hypergradients it hands to the hyper-Adam update
    (``batch`` and ``eps`` None: the step draws its own). A graphed LeNet
    step calls the hook only where it captures (``inference/cuda_graph.py``):
    its eager warm-up's gradients are kept, the captured run's hold no
    values."""
    seen = {}
    apply = eng._apply_hyper_updates

    def capture(st, grads):
        if not torch.cuda.is_current_stream_capturing():
            seen.update(grads)
        return apply(st, grads)

    eng._apply_hyper_updates = capture
    try:
        new, aux = step(state, batch=batch, eps=eps)
    finally:
        eng._apply_hyper_updates = apply
    return new, aux, seen


def check_methods(mods, make_psvi_engine, blobs, mnist, only):
    """The methods phase: each run of ``METHODS_RUNS`` through run_psvi on
    the dense flagship, then ``remat_inner`` against the plain step on one
    injected draw, then the hyper trainer and the truncated step at the
    LeNet flagship's widths. Every launch counter must read 0 (no fused
    gate serves these paths, as in JAX), every loss be finite, v move
    where it is learned and u, v, z stay bit for bit under
    ``psvi_evaluate``; each run's final accuracy must meet its gate from
    the JAX package (``METHODS_GATES``). Returns the runs' engines by label
    for the times phase."""
    engines = {}
    for label, opts, steps in METHODS_RUNS:
        eng, res, launches, secs = run_engine(
            mods, make_psvi_engine, blobs, only(),
            **{**METHODS_BASE, **opts, "num_epochs": steps, "log_every": steps - 1})
        s0, s1 = eng.state0, eng.state
        same = {k: bool(torch.equal(getattr(s1, k), getattr(s0, k))) for k in ("u", "v", "z")}
        acc = res["accs"][-1]
        emit({"phase": "methods", "config": f"four_blobs fn 2-40-4 M=48 {label}", "steps": steps,
              "accs": res["accs"], "nlls": res["nlls"], "gate": METHODS_GATES[label],
              "launches": launches, "unchanged": same, "seconds": secs,
              "step_path": eng.step_path})
        if eng.spec.evaluate_only and not all(same.values()):
            raise AssertionError(f"{label}: the pseudodata moved: {same}")
        if eng.spec.learn_v and same["v"]:
            raise AssertionError(f"{label}: v did not move")
        if not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            raise AssertionError(f"{label}: non-finite accuracy or NLL")
        if not acc >= METHODS_GATES[label]:
            raise AssertionError(f"{label}: final accuracy {acc} < {METHODS_GATES[label]}")
        engines[label] = eng
    # remat_inner against the plain step: one nested step on the same draw
    kw = {**METHODS_BASE, "method": "psvi_alpha_v", "fused_inner": False}
    plain, remat = (make_psvi_engine(blobs, **kw, remat_inner=r) for r in (False, True))
    batch = plain._sample_batch()
    eps = ([plain._sample_eps(plain.mc_samples) for _ in range(plain.inner_it)],
           plain._sample_eps(plain.mc_samples))
    for mod in mods:
        mod.reset_launches()
    sp, ap, gp = hypergrads_of(plain, plain._nested_step, plain.state, batch, eps)
    sr, ar, gr = hypergrads_of(remat, remat._nested_step, plain.state, batch, eps)
    torch.cuda.synchronize()
    rel = {k: _rel(gr[k], gp[k]) for k in gp}
    rel.update({f"state_{k}": _rel(getattr(sr, k), getattr(sp, k)) for k in ("u", "v", "alpha")})
    launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
    emit({"phase": "methods", "config": "four_blobs fn 2-40-4 M=48 psvi_alpha_v remat_inner "
          "against the plain step", "rel_to_plain": rel,
          "loss": [float(ap["outer_loss"]), float(ar["outer_loss"])], "launches": launches})
    if set(gr) != set(gp) or not all(r <= 1e-6 for r in rel.values()) or launches:
        raise AssertionError(f"remat_inner: max|Δ|/max|ref| {rel}, launches {launches}")
    # the LeNet flagship's widths: forward over reverse through the conv path
    lenet = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=100, mc_samples=10,
                 inner_it=20, data_minibatch=256, init_sd=1e-3, num_epochs=3, log_every=2,
                 seed=0)
    for label, opts in (("hyper cg_normaleq", dict(trainer="hyper")),
                        ("truncated K=5", dict(truncated=True, truncated_K=5))):
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, mnist, only(),
                                              **lenet, **opts)
        moved = not torch.equal(eng.state.v, eng.state0.v)
        emit({"phase": "methods", "config": f"synth_mnist lenet psvi_learn_v M=100 S=10 T=20 "
              f"B=256 {label}", "steps": 3, "accs": res["accs"], "nlls": res["nlls"],
              "launches": launches, "v_moved": moved, "seconds": secs,
              "step_path": eng.step_path})
        if not moved or not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            raise AssertionError(f"LeNet {label}: v moved {moved}, accs {res['accs']}")
        engines[f"lenet {label}"] = eng
    return engines


def run_lifecycle(mods, make_psvi_engine, data, expected, prepare=None, **kw):
    """One run_psvi of a lifecycle run, with the launch counters as in
    ``run_engine`` (``prepare(engine)``, if given, runs before they are set
    to 0). The run re-chooses its step at each change of shape, so the
    engine's fused dense step itself is wrapped: CUDA events around each
    call give its median ms by (M, classes). Returns (engine, results,
    launch counts, seconds, {"M=..,nc=..": [median ms, steps]})."""
    eng = make_psvi_engine(data, **kw)
    eng.step_path = eng._step.__name__
    fused, timed_steps = eng._nested_step_fused, []

    def timed(state, batch=None, eps=None):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, aux = fused(state, batch=batch, eps=eps)
        ev[1].record()
        timed_steps.append((f"M={eng.num_pseudo},nc={eng.nc}", ev, aux["outer_loss"]))
        return state, aux

    eng._nested_step_fused = timed
    eng._rebuild()
    if prepare is not None:
        prepare(eng)
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    res = eng.run_psvi()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(mods, expected)
    by_shape = {}
    for shape, (s, e), loss in timed_steps:
        if not math.isfinite(float(loss)):
            raise AssertionError(f"non-finite outer loss at {shape}")
        by_shape.setdefault(shape, []).append(s.elapsed_time(e))
    step_ms = {shape: [float(np.median(ms)), len(ms)] for shape, ms in by_shape.items()}
    quality = res.get("accs", []) + res.get("nlls", [])
    if not all(math.isfinite(x) for x in quality):
        raise AssertionError(f"non-finite accuracy or NLL: {quality}")
    return eng, res, launches, secs, step_ms


def check_lifecycle(mods, make_psvi_engine, blobs, halfmoon, mnist, only, lenet_kw, card):
    """The lifecycle phase, every run through ``run_psvi`` with every
    launch counter checked exactly: the prune, incremental and joint-prune
    runs of ``LIFECYCLE_RUNS`` (their shapes after the run, their gates
    from the JAX package); a checkpoint resume at the dense flagship (30
    steps, save, 20 more; a fresh engine loads and runs the same 20) and
    at the LeNet flagship (3 + 3), state leaves equal bit for bit; a
    scoring run with ``log_pseudodata`` (halfmoon logreg M=30: both CSV
    files, N rows; every grid prediction sums to 1); then a psvi_evaluate
    engine warm-started from that run's saved results (v equals the saved
    ``vs[-1]``; no kernel launches, in JAX as here)."""
    import tempfile

    from psvi_torch.utils.results import save_results
    from psvi_torch.utils.tree import tree_leaves

    for label, opts, steps in LIFECYCLE_RUNS:
        kw = {**METHODS_BASE, **opts, "num_epochs": steps, "log_every": steps - 1}
        if opts.get("trainer") == "joint":
            expected = only(sampled_linear=b3_expected(blobs, kw, 1))
        else:
            expected = only(nested_fwd=steps, nested_outer=steps, nested_rev=steps)
        eng, res, launches, secs, step_ms = run_lifecycle(mods, make_psvi_engine, blobs,
                                                          expected, **kw)
        acc, gate = res["accs"][-1], LIFECYCLE_GATES[label]
        classes = sorted(int(c) for c in torch.unique(eng.y_test).tolist())
        emit({"phase": "lifecycle", "card": card, "config": f"four_blobs fn 2-40-4 M=48 {label}",
              "steps": steps, "accs": res["accs"], "nlls": res["nlls"], "csizes": res["csizes"],
              "gate": gate, "launches": launches, "seconds": secs, "step_path": eng.step_path,
              "u_shape": list(eng.state.u.shape), "nc": eng.nc, "test_classes": classes,
              "fused_step_ms_by_shape": step_ms})
        want_u = (48, 2) if opts.get("increment") else (24, 2)
        if tuple(eng.state.u.shape) != want_u or eng.num_pseudo != want_u[0]:
            raise AssertionError(f"{label}: u {tuple(eng.state.u.shape)}, expected {want_u}")
        if opts.get("increment") and (eng.nc != 4 or classes != [0, 1, 2, 3]):
            raise AssertionError(f"{label}: {eng.nc} classes, test classes {classes}")
        if not opts.get("increment") and res["csizes"][-1] != 24:
            raise AssertionError(f"{label}: csizes {res['csizes']}")
        if not acc >= gate:
            raise AssertionError(f"{label}: final accuracy {acc} < {gate}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # checkpoint resume, bit for bit
        dense_kw = {**METHODS_BASE, "log_every": 10}
        mismatched = {}
        for name, data, kw, n1, n2 in (
                ("four_blobs fn 2-40-4 M=48", blobs, dense_kw, 30, 20),
                ("synth_mnist lenet psvi_learn_v M=100 S=10 T=20 B=256", mnist, lenet_kw, 3, 3)):
            path = str(tmp / "ckpt.npz")
            first = make_psvi_engine(data, **{**kw, "num_epochs": n1})
            for mod in mods:
                mod.reset_launches()
            first.run_psvi()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first.save_checkpoint(path)
            save_ms = (time.perf_counter() - t0) * 1e3
            first.num_epochs = n2
            res_a = first.run_psvi()
            resumed = make_psvi_engine(data, **{**kw, "num_epochs": n2})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed.load_checkpoint(path)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            res_b = resumed.run_psvi()
            torch.cuda.synchronize()
            n = n1 + 2 * n2
            launches = read_launches(mods, only(lenet_fwd=n, lenet_rev=n) if data is mnist else
                                     only(nested_fwd=n, nested_outer=n, nested_rev=n))
            la, lb = tree_leaves(first.state), tree_leaves(resumed.state)
            differ = [i for i, (x, y) in enumerate(zip(la, lb))
                      if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]
            same_accs = res_a["accs"] == res_b["accs"] and res_a["nlls"] == res_b["nlls"]
            emit({"phase": "lifecycle", "card": card, "config": f"{name} checkpoint resume "
                  f"{n1} + {n2} steps", "leaves": len(la), "leaves_differing": differ,
                  "accs_equal": same_accs, "accs": res_b["accs"], "save_ms": save_ms,
                  "load_ms": load_ms, "bytes": Path(path).stat().st_size,
                  "launches": launches})
            if differ or not same_accs or len(la) != len(lb):
                mismatched[name] = differ
        if mismatched:
            raise AssertionError(f"checkpoint resume not bit for bit: leaves {mismatched}")

        # a scoring run with logged pseudodata, then a warm start from it
        sc_kw = dict(method="psvi_learn_v", num_pseudo=30, mc_samples=10,
                     architecture="logistic_regression", inner_it=10, data_minibatch=128,
                     init_sd=1e-3, num_epochs=101, log_every=50, seed=0, scoring_run=True,
                     log_pseudodata=True, data_folder=str(tmp), dnm="halfmoon")
        eng, res, launches, secs, step_ms = run_lifecycle(
            mods, make_psvi_engine, halfmoon,
            only(nested_fwd=101, nested_outer=101, nested_rev=101), **sc_kw)
        t0 = time.perf_counter()
        for _ in range(20):
            eng._forgetting_calculator()
        forget_ms = (time.perf_counter() - t0) / 20 * 1e3
        scores = np.genfromtxt(tmp / "score_psvi_halfmoon_0.csv", delimiter=",", names=True)
        emb = np.loadtxt(tmp / "embedding_halfmoon_0.csv", delimiter=",")
        grid_err = max(float(np.abs(g.sum(axis=0) - 1).max()) for g in res["grid_preds"])
        emit({"phase": "lifecycle", "card": card, "config": "halfmoon logreg psvi_learn_v M=30 "
              "scoring_run log_pseudodata", "accs": res["accs"], "launches": launches,
              "seconds": secs, "fused_step_ms_by_shape": step_ms,
              "forgetting_calculator_ms": forget_ms, "score_columns": list(scores.dtype.names),
              "score_rows": len(scores), "embedding_shape": list(emb.shape),
              "grid_preds": [list(g.shape) for g in res["grid_preds"]],
              "grid_sum_max_err": grid_err})
        if (list(scores.dtype.names) != ["el2n", "forgetting", "entropy", "least_confidence"]
                or len(scores) != halfmoon.N or emb.shape != (halfmoon.N, 2)):
            raise AssertionError(f"scoring CSVs: columns {scores.dtype.names}, "
                                 f"{len(scores)} rows, embeddings {emb.shape}")
        if len(res["grid_preds"]) != 3 or len(res["us"]) != 3 or not grid_err <= 1e-4:
            raise AssertionError(f"grid predictions: {len(res['grid_preds'])}, err {grid_err}")
        save_results({"halfmoon": {"psvi_learn_v": {30: {0: res}}}}, str(tmp / "run"))
        saved_v = torch.as_tensor(res["vs"][-1])
        ws_kw = {**sc_kw, "method": "psvi_evaluate", "num_epochs": 11, "log_every": 10,
                 "scoring_run": False, "log_pseudodata": False, "results_folder": str(tmp)}
        loaded = {}

        def warm_start(e):
            e.load_saved_coreset("run", "halfmoon", "psvi_learn_v", 30, ablated_weights=False,
                                 ablated_alpha=False, ablated_labels=False)
            loaded["v"] = bool(torch.equal(e.state.v.cpu(), saved_v))

        eng, res, launches, secs, _ = run_lifecycle(mods, make_psvi_engine, halfmoon, only(),
                                                    prepare=warm_start, **ws_kw)
        kept = bool(torch.equal(eng.state.v.cpu(), saved_v))
        emit({"phase": "lifecycle", "card": card, "config": "halfmoon logreg psvi_evaluate M=30 "
              "warm start from the saved scoring run", "steps": 11, "accs": res["accs"],
              "v_equals_saved": loaded["v"], "v_kept": kept, "launches": launches,
              "seconds": secs, "step_path": eng.step_path})
        if not (loaded["v"] and kept):
            raise AssertionError(f"warm start: v equals the saved v {loaded['v']}, kept {kept}")


def _gate_close(a, b):
    """The B1/B2 gate: cosine > 0.9999 and max|Δ| ≤ 1e-3·max|ref|."""
    c, r = _cos(a, b), _rel(a, b)
    return {"cos": c, "rel": r, "ok": c > COS_MIN and r <= REL_G}


def _double(tree):
    """A tree's floating tensors in float64."""
    from psvi_torch.utils.tree import tree_map

    return tree_map(lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point()
                    else x, tree)


@contextlib.contextmanager
def _plain_versions(FN, FL):
    """The fused steps through the kernels' plain versions (any dtype), for
    a float64 reference on CUDA tensors."""
    flat, unroll = FN.fused_nested_flat, FL.lenet_unroll
    FN.fused_nested_flat = functools.partial(flat, backend="torch")
    FL.lenet_unroll = functools.partial(unroll, backend="torch")
    try:
        yield
    finally:
        FN.fused_nested_flat, FL.lenet_unroll = flat, unroll


@contextlib.contextmanager
def _double_bias_corrections(O):
    """The plain step's Adam with its bias corrections in double, the fused
    steps' convention."""
    bc = O.bias_corrections
    O.bias_corrections = lambda t, b1, b2: (1.0 - b1 ** t, math.sqrt(1.0 - b2 ** t))
    try:
        yield
    finally:
        O.bias_corrections = bc


def _state_leaves(st):
    """u, v, α, z and the net's leaves of a state, by name."""
    from psvi_torch.utils.tree import tree_leaves

    out = {k: getattr(st, k) for k in ("u", "v", "alpha", "z")}
    out.update({f"net{i}": x for i, x in enumerate(tree_leaves(st.params))})
    return out


def check_options(mods, make_psvi_engine, read_dataset, data, only, reg_kw, card, dev):
    """The options phase: the engine options and the data readers through
    the user's entry points, every launch counter set to 0 just before each
    run and read just after.

    1. The literal LeNet: the flagship, three steps each of the default,
       ``fuse_convpool=False`` and ``pool_backend="argmax"`` from one seed
       (the same draws); each launches ``lenet_fwd``/``lenet_rev`` as the
       default does and ends within the B2 gate of its state.
    2. ``fused_eps="stream"`` at the dense flagship, the regression step,
       the LeNet flagship and LeNet at M=16 S=4 T=5: one fused step and one
       ``_nested_step`` from the same generator state, both generators left
       in the same state, the fused step 1 launch of each kernel, the plain
       one 0; the same draws in float64 through both steps with the same
       constants (the fused one through its kernels' plain versions): the
       same function, within the B1/B2 gate; and, except at the LeNet
       flagship, where the plain fp32 step itself misses that gate against
       its own float64 run, u, v, α, z and the net at the gate between the
       fp32 steps and the fused step's hypergradients within it of its own
       float64 run (g_α at its rtol).
    3. Every inner optimizer of the registry, three steps each on the dense
       flagship: finite, v moved; B1 once a step under Adam, never else.
    4. bf16 and packed at the LeNet flagship (3 steps: finite, no B2
       launch, the step's ms beside the fp32 plain step's), the LeNet joint
       trainer with ``backend="pallas"`` under bf16 (no B3 launch).
    5. ``synth_cifar`` read; the argmax pool's tie on the card.
    6. Each run of ``OPTIONS_RUNS`` held to its gate."""
    from psvi_torch.models import layers as TL
    from psvi_torch.ops import fused_lenet as FL
    from psvi_torch.ops import fused_nested as FN
    from psvi_torch.ops import optim as O

    blobs, mnist, sinus = data["four_blobs"], data["synth_mnist"], data["sinus"]
    failed = []  # every check runs; the phase fails at its end if any did
    lenet3 = {**LENET_BASE, "num_epochs": 3, "log_every": 2}

    # 1. the literal and argmax-pooled LeNet through B2, against the default
    ref = None
    for label, opts in (("default", {}), ("fuse_convpool=False", dict(fuse_convpool=False)),
                        ("pool_backend=argmax", dict(pool_backend="argmax"))):
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, mnist,
                                              only(lenet_fwd=3, lenet_rev=3), **lenet3, **opts)
        layers = [type(l).__name__ for l in eng.net.layers[:2]]
        leaves = _state_leaves(eng.state)
        if ref is None:
            ref, diff = leaves, {}
        else:
            diff = {k: _gate_close(leaves[k], ref[k]) for k in ("u", "v")}
            net = [_gate_close(leaves[k], ref[k]) for k in leaves if k.startswith("net")]
            diff["net_worst"] = min(net, key=lambda d: (d["ok"], d["cos"], -d["rel"]))
        emit({"phase": "options", "card": card, "config": "synth_mnist lenet psvi_learn_v M=100 "
              f"S=10 T=20 B=256 {label}", "layers": layers, "steps": 3, "accs": res["accs"],
              "launches": launches, "step_ms": eng.step_ms, "step_path": eng.step_path,
              "vs_default": diff, "seconds": secs})
        if eng.step_path != "_nested_step_fused_lenet" or not all(
                d["ok"] for d in diff.values()):
            failed.append(f"LeNet {label}: path {eng.step_path}, against the default "
                                 f"{diff}")

    # 2. fused_eps="stream": the fused step against the plain step
    # (name, data, options, launches of the fused step, fp32 gated): at the
    # LeNet flagship the plain fp32 step itself misses the gate against its
    # own float64 run (PERF.md §6), so there the fp32 numbers are
    # reported and the float64 same-function check gates; the fp32 gates
    # hold the LeNet pair at a shorter unroll of the same widths
    for name, d, kw, expect, fp32_gated in (
            ("four_blobs fn 2-40-4 psvi_learn_v M=48 S=10 T=10 B=128", blobs, METHODS_BASE,
             only(nested_fwd=1, nested_outer=1, nested_rev=1), True),
            ("sinus regressor_net 1-40-1 psvi_learn_v_regressor M=10 S=10 T=10 B=64", sinus,
             reg_kw, only(nested_fwd_gaussian=1, nested_outer_gaussian=1,
                          nested_rev_gaussian=1), True),
            ("synth_mnist lenet psvi_learn_v M=100 S=10 T=20 B=256", mnist, LENET_BASE,
             only(lenet_fwd=1, lenet_rev=1), False),
            ("synth_mnist lenet psvi_learn_v M=16 S=4 T=5 B=64", mnist,
             {**LENET_BASE, "num_pseudo": 16, "mc_samples": 4, "inner_it": 5,
              "data_minibatch": 64}, only(lenet_fwd=1, lenet_rev=1), True)):
        kw = {k: v for k, v in kw.items() if k not in ("num_epochs", "log_every")}
        fused = make_psvi_engine(d, **kw, fused_inner=True, fused_eps="stream")
        plain = make_psvi_engine(d, **kw, fused_inner=False)
        gen0 = plain.gen.get_state()
        torch.cuda.synchronize()
        for mod in mods:
            mod.reset_launches()
        sf, af, gf = hypergrads_of(fused, fused._step, fused.state, None, None)
        torch.cuda.synchronize()
        launches = read_launches(mods, expect)
        sp, ap, gp = hypergrads_of(plain, plain._step, plain.state, None, None)
        torch.cuda.synchronize()
        read_launches(mods, expect)  # the plain step adds none
        same_draws = bool(torch.equal(fused.gen.get_state(), plain.gen.get_state()))
        # the same draws again, in float64: the plain step, as it is (the
        # plain fp32 step's own reference) and with the fused steps' Adam
        # bias corrections in double (JAX's fused cores compute them in
        # double, its plain step in float32), and the fused step through its
        # kernels' plain versions: with the same constants, the same function
        plain.gen.set_state(gen0)
        batch, eps = _double(plain._sample_batch()), _double(plain._stream_eps())
        s64, a64, g64 = hypergrads_of(plain, plain._nested_step, _double(plain.state), batch, eps)
        with _double_bias_corrections(O):
            sd, ad, gd = hypergrads_of(plain, plain._nested_step, _double(plain.state), batch,
                                       eps)
        with _plain_versions(FN, FL), _double_bias_corrections(O):
            sq, aq, gq = hypergrads_of(fused, fused._step, _double(fused.state), batch, eps)
        torch.cuda.synchronize()
        ld, lq, l0 = _state_leaves(sd), _state_leaves(sq), _state_leaves(plain.state)
        moved = [k for k in ld if not torch.equal(ld[k], _double(l0[k]))]
        same_fn = {f"g_{k}": _gate_close(gq[k], gd[k]) for k in gd}
        same_fn.update({k: _gate_close(lq[k], ld[k]) for k in moved})
        grads = {}
        for k in gd:
            if k == "alpha":
                rel = {w: float((g[k].double() - r[k]).abs().max() / r[k].abs().max())
                       for w, g, r in (("fused", gf, gq), ("plain", gp, g64))}
                grads[k] = {"fused_vs_own_float64": rel["fused"],
                            "plain_vs_own_float64": rel["plain"],
                            "ok": rel["fused"] <= RTOL_ALPHA}
            else:
                own = _gate_close(gf[k].double(), gq[k])
                grads[k] = {"fused_vs_own_float64": own,
                            "plain_vs_own_float64": _gate_close(gp[k].double(), g64[k]),
                            "fused_vs_plain": _gate_close(gf[k], gp[k]), "ok": own["ok"]}
        lf, lp = _state_leaves(sf), _state_leaves(sp)
        states = {k: _gate_close(lf[k], lp[k]) for k in moved}
        emit({"phase": "options", "card": card, "config": f"{name} fused_eps=stream: the fused "
              "step against _nested_step from one generator state; both in float64 with the "
              "same constants (the fused step through its kernels' plain versions); each fp32 "
              "step's hypergradients against its own float64 run", "fp32_gated": fp32_gated,
              "launches": launches, "paths": [fused._step.__name__, plain._step.__name__],
              "same_draws": same_draws, "float64_same_function": same_fn, "hypergrads": grads,
              "states_fused_vs_plain": states,
              "loss": {"fused": float(af["outer_loss"]), "plain": float(ap["outer_loss"]),
                       "plain_float64": float(a64["outer_loss"]),
                       "fused_float64": float(aq["outer_loss"])}})
        bad = [f"float64 {k}" for k, v in same_fn.items() if not v["ok"]]
        if fp32_gated:
            bad += ([f"g_{k}" for k, v in grads.items() if not v["ok"]]
                    + [k for k, v in states.items() if not v["ok"]])
        if not same_draws or bad or not set(gf) == set(gp) == set(gd) == set(gq):
            failed.append(f"stream {name}: same draws {same_draws}, outside the gate {bad}")
    run = dict(METHODS_BASE)

    # 3. every inner optimizer, three steps each
    for opt in sorted(O.REGISTRY):
        expect = only(nested_fwd=3, nested_outer=3, nested_rev=3) if opt == "adam" else only()
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, blobs, expect, **run,
                                              inner_optimizer=opt, num_epochs=3, log_every=2)
        moved = not torch.equal(eng.state.v, eng.state0.v)
        emit({"phase": "options", "card": card, "config": f"four_blobs fn 2-40-4 M=48 inner "
              f"{opt}", "steps": 3, "accs": res["accs"], "launches": launches,
              "step_ms": eng.step_ms, "step_path": eng.step_path, "v_moved": moved})
        if not moved or not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            failed.append(f"inner {opt}: v moved {moved}, accs {res['accs']}")

    # 4. bf16 and packed at the LeNet flagship; the LeNet joint run under bf16
    plain_fp32 = make_psvi_engine(mnist, **LENET_BASE, fused_inner=False)
    batch = plain_fp32._sample_batch()
    st = plain_fp32.state
    fp32_ms = median_ms(lambda: plain_fp32._nested_step(st, batch), reps=3, warmup=1)
    for label, opts in (("compute_dtype=bfloat16", dict(compute_dtype="bfloat16")),
                        ("packed", dict(packed=True))):
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, mnist, only(),
                                              **lenet3, **opts)
        moved = not torch.equal(eng.state.v, eng.state0.v)
        emit({"phase": "options", "card": card, "config": "synth_mnist lenet psvi_learn_v M=100 "
              f"S=10 T=20 B=256 {label}", "steps": 3, "accs": res["accs"], "launches": launches,
              "step_ms": eng.step_ms, "fp32_plain_step_ms": fp32_ms,
              "step_path": eng.step_path, "v_moved": moved})
        if not moved or not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            failed.append(f"LeNet {label}: v moved {moved}, accs {res['accs']}")
    eng, res, launches, secs = run_engine(
        mods, make_psvi_engine, mnist, only(),
        **{**lenet3, "trainer": "joint", "backend": "pallas", "compute_dtype": "bfloat16"})
    emit({"phase": "options", "card": card, "config": "synth_mnist lenet psvi_learn_v M=100 S=10 "
          "B=256 joint backend=pallas compute_dtype=bfloat16", "steps": 3, "accs": res["accs"],
          "launches": launches, "step_ms": eng.step_ms, "step_path": eng.step_path})
    if not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
        failed.append(f"LeNet joint bf16: accs {res['accs']}")

    # 5. synth_cifar read; the argmax pool's tie on the card: the first
    # index of each window takes the gradient, as on the CPU and as the
    # card's max_pool2d routes it
    t0 = time.perf_counter()
    cifar = read_dataset("synth_cifar")
    read_s = time.perf_counter() - t0
    x = torch.randint(-2, 3, (4, 6, 28, 28), generator=torch.Generator().manual_seed(0)).float()
    w = torch.randn(4, 6, 14, 14, generator=torch.Generator().manual_seed(1))
    g = {}
    for where, pool in (("cpu", lambda a: TL._argmax_pool(a, 2)),
                        ("cuda", lambda a: TL._argmax_pool(a, 2)),
                        ("cuda max_pool2d", lambda a: torch.nn.functional.max_pool2d(a, 2))):
        xx = x.to("cpu" if where == "cpu" else dev).requires_grad_(True)
        (g[where],) = torch.autograd.grad(torch.sum(w.to(xx.device) * pool(xx)), xx)
    ties_ok = all(torch.equal(g["cpu"], v.cpu()) for v in g.values())
    emit({"phase": "options", "card": card, "config": "readers and ties",
          "synth_cifar": {"x": list(cifar.x.shape), "xt": list(cifar.xt.shape), "N": cifar.N,
                          "D": cifar.D, "nc": cifar.nc, "channels": cifar.channels,
                          "read_s": read_s},
          "argmax_ties_first_index_on_card": ties_ok})
    if cifar.x.shape != (6000, 3, 32, 32) or not ties_ok:
        failed.append(f"synth_cifar {cifar.x.shape}, ties {ties_ok}")

    # 6. the gated runs
    for label, name, base, opts, steps, path in OPTIONS_RUNS:
        expect = {"dense": only(nested_fwd=steps, nested_outer=steps, nested_rev=steps),
                  "lenet": only(lenet_fwd=steps, lenet_rev=steps), None: only()}[path]
        d = data[name] if name in data else read_dataset(name)
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, d, expect,
                                              **{**base, **opts, "num_epochs": steps,
                                                 "log_every": steps - 1})
        acc, gate = res["accs"][-1], OPTIONS_GATES[label]
        emit({"phase": "options", "card": card, "config": label, "steps": steps,
              "accs": res["accs"], "nlls": res["nlls"], "gate": gate,
              "jax_accs_seeds_0_1_2": OPTIONS_JAX_ACCS[label], "launches": launches,
              "step_ms": eng.step_ms, "step_path": eng.step_path, "seconds": secs})
        if not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            failed.append(f"{label}: non-finite accuracy or NLL")
        if gate is not None and not acc >= gate:
            failed.append(f"{label}: final accuracy {acc} < {gate}")
    if failed:
        raise AssertionError("options phase: " + "; ".join(failed))


def _nondeterministic_ops(fn):
    """The ops PyTorch names as having no deterministic implementation
    while ``fn`` runs (``use_deterministic_algorithms`` in warn-only mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    names = {str(w.message).split(" does not have")[0] for w in caught
             if "deterministic" in str(w.message)}
    return sorted(names)


def _dense_outputs(net, params, eps, x):
    """Each VILinear's output in a forward of ``net`` (its top-level layers)."""
    from psvi_torch.models.layers import VILinear

    outs = []
    with torch.no_grad():
        for layer, p, e in zip(net.layers, params, eps):
            x = layer.apply(p, e, x)
            if isinstance(layer, VILinear):
                outs.append(x)
    return outs


def joint_moment(eng, state, batch, eps, heads_from_b3=False):
    """The joint Adam's first moment (0.1·the gradient) after one step of
    ``eng`` from ``state`` on the given draws, by leaf. With
    ``heads_from_b3`` each dense head's forward value is B3's on the same
    inputs, its backward autograd's (``y + (y_B3 − y).detach()``), which
    isolates what B3's forward rounding alone does to the step."""
    from psvi_torch.models.layers import VILinear
    from psvi_torch.ops import sampled_linear as SL
    from psvi_torch.utils.tree import tree_leaves

    apply = VILinear.apply

    def b3_values(self, params, e, x):
        y = apply(self, params, e, x)
        if x.dim() != 3:
            return y
        with torch.no_grad():
            yk = SL._sampled_linear_cuda(x, params["mu_w"], params["rho_w"], params["mu_b"],
                                         params["rho_b"], e["w"], e["b"])
        return y + (yk - y).detach()

    if heads_from_b3:
        VILinear.apply = b3_values
    try:
        new, _ = eng._joint_step(state, batch=batch, eps=eps)
    finally:
        VILinear.apply = apply
    torch.cuda.synchronize()
    return [x for x in tree_leaves(new.opt_joint.mu) if torch.is_tensor(x)]


def _to_cpu(tree):
    from psvi_torch.utils.tree import tree_map

    return tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, tree)


def nested_vs_host(make_psvi_engine, data, kw, remat64=False):
    """One nested step of ``kw``'s engine on the card in fp32, then the same
    draws and state in float64 on the card and on the host (the CPU's conv,
    pooling and norm ops: a reference that shares no kernel with cuDNN).
    Returns the hypergradients' max|Δ|/max|ref| and cosine of each card run
    against the host's, the losses and each float64 run's seconds."""
    eng = make_psvi_engine(data, **kw)
    gen0 = eng.gen.get_state()
    _, a32, g32 = hypergrads_of(eng, eng._nested_step, eng.state, None, None)
    eng.gen.set_state(gen0)
    batch = eng._sample_batch()
    eps = ([eng._sample_eps(kw["mc_samples"]) for _ in range(kw["inner_it"])],
           eng._sample_eps(kw["mc_samples"]))
    args = (_double(eng.state), _double(batch), _double(eps))
    card64 = make_psvi_engine(data, **kw, remat_inner=True) if remat64 else eng
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, a64, g64 = hypergrads_of(card64, card64._nested_step, *args)
    torch.cuda.synchronize()
    secs = {"card_float64": time.perf_counter() - t0}
    peak = torch.cuda.max_memory_allocated()
    host = make_psvi_engine(data, **kw, remat_inner=remat64, device="cpu")
    t0 = time.perf_counter()
    _, ah, gh = hypergrads_of(host, host._nested_step, *_to_cpu(args))
    secs["host_float64"] = time.perf_counter() - t0

    def pair(x, y):
        return {"rel": _rel(x.double().cpu(), y), "cos": _cos(x.cpu(), y)}

    return {"float64_remat_inner": remat64, "card_float64_peak_memory_bytes": peak,
            "seconds": secs, "host_threads": torch.get_num_threads(),
            "loss": {"fp32": float(a32["outer_loss"]), "card_float64": float(a64["outer_loss"]),
                     "host_float64": float(ah["outer_loss"])},
            "card_float64_vs_host_float64": {f"g_{k}": pair(g64[k], gh[k]) for k in gh},
            "card_fp32_vs_host_float64": {f"g_{k}": pair(g32[k], gh[k]) for k in gh}}


def zoo_b3_shapes(data, kw, heads):
    """B3's launches in one joint run_psvi on a zoo net, by shape, derived
    from its loops: each training step's forward and each evaluation's
    forward over cat(u, test batch) launch it once a dense head, all at S
    samples and N = M + B points (the last test batch is padded to B)."""
    n = b3_expected(data, kw, 1) // len(heads)
    N = kw["num_pseudo"] + min(kw["data_minibatch"], len(data.xt))
    return {(kw["mc_samples"], N, i, o): n for i, o in heads}


def check_zoo(mods, make_psvi_engine, read_dataset, halfmoon, only, card, SL):
    """The zoo phase: the model zoo through the user's entry points, every
    launch counter set to 0 just before each run and read just after.

    1. ``ZOO_RUNS`` through run_psvi, the nested trainer (and the hyper
       trainer for fn2): no kernel launch (B1 refuses the full-covariance
       nets, B2 AlexNet and ResNet), each held to ``ZOO_GATES``, with its
       step's median ms and peak memory; the synth_cifar runs in fp32
       without ``remat_inner`` (an out-of-memory error fails the phase).
    2. The joint trainer on AlexNet (S=10) and ResNet-18 (the nested run's
       M, S, B), ``backend="pallas"`` beside ``"xla"``: one step of each
       from the same state and generator, the loss and each dense head's
       output on the step's draws within B3's gate, and the joint Adam's
       first moment (0.1·the gradient) in every leaf at cosine > 0.99999,
       within ``REL_JOINT_MOMENT`` of the xla step's and within
       ``REL_B3_HEADS_ONLY`` of the xla step fed B3's head values
       (``joint_moment``), each leaf's distance from the xla step in
       float64 reported for both backends, beside the ReLU crossings after
       the heads and the change of the IW-ELBO's importance weights; then
       runs through B3, its launches by shape
       exactly as ``zoo_b3_shapes`` derives them, AlexNet for 31 steps with
       each backend, the accuracies within 0.05.
    3. ``ZOO_F64_RUNS``: one full-width nested step of AlexNet and of
       ResNet-18 in float64 on the card, g_u and g_v within
       ``REL_F64_HOST`` of the same step in float64 on the host
       (``nested_vs_host``); the fp32 step's distance reported.
    4. AlexNet under bf16 with ``remat_inner``, 3 steps: finite, v moved,
       no launch.
    5. One AlexNet nested step rerun from the same state and generator:
       bit for bit, or the ops PyTorch names as nondeterministic.
    Every check runs; the phase fails at its end if any did. Returns the
    nested engines by label and B3's launches by shape on the zoo."""
    from psvi_torch.ops import elbo as E
    from psvi_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    failed = []
    cifar = read_dataset("synth_cifar")
    dsets = {"synth_cifar": cifar, "halfmoon": halfmoon}

    # 1. the nested runs, each held to its gate
    engines = {}
    for label, name, kw, steps in ZOO_RUNS:
        opts = {**kw, "num_epochs": steps, "log_every": 5 if name == "synth_cifar" else steps - 1}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, res, launches, secs = run_engine(mods, make_psvi_engine, dsets[name], only(),
                                              **opts)
        engines[label] = eng
        acc, gate = res["accs"][-1], ZOO_GATES[label]
        emit({"phase": "zoo", "card": card, "config": label, "steps": steps,
              "accs": res["accs"], "nlls": res["nlls"], "gate": gate,
              "jax_accs": ZOO_JAX_ACCS[label], "launches": launches, "step_ms": eng.step_ms,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "step_path": eng.step_path, "seconds": secs})
        if not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
            failed.append(f"{label}: non-finite accuracy or NLL")
        if not acc >= gate:
            failed.append(f"{label}: final accuracy {acc} < {gate}")

    # 2. the joint trainer, B3 at the dense heads beside the plain product
    shapes = {}
    for net, kw, heads, steps in (
            ("alexnet", {**ALEXNET_KW, "mc_samples": 10},
             [(4096, 384), (384, 192), (192, 10)], 31),
            ("resnet18", RESNET_KW, [(512, 10)], 3)):
        kw = {**kw, "trainer": "joint", "num_epochs": steps, "log_every": 10 if steps > 3 else 2}
        es = {b: make_psvi_engine(cifar, **kw, backend=b) for b in ("xla", "pallas")}
        same_start = bool(torch.equal(es["xla"].gen.get_state(), es["pallas"].gen.get_state())
                          and all(torch.equal(a, b) for a, b in zip(
                              tree_leaves(es["xla"].state), tree_leaves(es["pallas"].state))
                                  if torch.is_tensor(a)))
        g0 = es["xla"].gen.get_state()
        out = {b: e._joint_step(e.state) for b, e in es.items()}
        # the step's draws again: the heads' outputs of each backend on
        # them, the xla step fed B3's head values and the xla step in float64
        es["xla"].gen.set_state(g0)
        batch = es["xla"]._sample_batch()
        eps = es["xla"]._sample_eps(kw["mc_samples"])
        xb, st = batch[0], es["xla"].state
        heads_out = {b: _dense_outputs(e.net, e.state.params, eps, torch.cat([e.state.u, xb]))
                     for b, e in es.items()}
        torch.cuda.synchronize()
        loss = {b: o[1]["outer_loss"] for b, o in out.items()}
        m = {b: [x for x in tree_leaves(o[0].opt_joint.mu) if torch.is_tensor(x)]
             for b, o in out.items()}
        m["xla_b3_heads"] = joint_moment(es["xla"], st, batch, eps, heads_from_b3=True)
        m["xla64"] = joint_moment(es["xla"], _double(st), _double(batch), _double(eps))
        moment = [{"leaf": i, "shape": list(x.shape), "cos": _cos(x, y), "rel": _rel(x, y),
                   "rel_vs_xla_b3_heads": _rel(x, h), "rel_vs_float64": _rel(x.double(), d),
                   "xla_rel_vs_float64": _rel(y.double(), d)}
                  for i, (x, y, h, d) in enumerate(zip(m["pallas"], m["xla"], m["xla_b3_heads"],
                                                       m["xla64"]))]
        worst = max(moment, key=lambda d: d["rel"])
        worst_heads = max(moment, key=lambda d: d["rel_vs_xla_b3_heads"])
        worst_cos = min(d["cos"] for d in moment)
        loss_rel = float(abs(loss["pallas"] - loss["xla"]) / abs(loss["xla"]))
        outputs_rel = [_rel(x, y) for x, y in zip(heads_out["pallas"], heads_out["xla"])]
        # a head's output next to 0 may take the other side of the ReLU
        # after it: that unit's gradient then changes by its whole term
        flips = [int(((x > 0) != (y > 0)).sum())
                 for x, y in zip(heads_out["pallas"][:-1], heads_out["xla"][:-1])]
        # the outer ELBO's importance log-weights −Σ_m cw_m·NLL_m + NKL on
        # each backend's outputs: a softmax over S of terms ~1e6, so a
        # relative change of the outputs near 1e-6 moves the weights, and
        # with them every gradient, by more
        st = es["xla"].state
        cw, _ = es["xla"]._core_weights(st.v, st.alpha)
        with torch.no_grad():
            nkl = es["xla"].net.nkl(st.params, eps)
            lw = {b: nkl - E.categorical_nll(h[-1][:, :st.u.shape[0]], st.z) @ cw
                  for b, h in heads_out.items()}
        iw = {"log_weights_max_abs_diff": float((lw["pallas"] - lw["xla"]).abs().max()),
              "weights_max_abs_diff": float((torch.softmax(lw["pallas"], 0)
                                             - torch.softmax(lw["xla"], 0)).abs().max()),
              "log_weights_spread": float(lw["xla"].max() - lw["xla"].min())}
        # then whole runs, B3's launches by shape as derived from the loops
        expect = zoo_b3_shapes(cifar, kw, heads)
        runs = {}
        for b in ("pallas", "xla"):
            n = sum(expect.values()) if b == "pallas" else 0
            eng, res, launches, secs = run_engine(mods, make_psvi_engine, cifar,
                                                  only(sampled_linear=n), **kw, backend=b)
            runs[b] = {"accs": res["accs"], "nlls": res["nlls"], "launches": launches,
                       "step_ms": eng.step_ms, "seconds": secs}
            if b == "pallas":
                got = dict(SL.LAUNCH_SHAPES)
                shapes.update(got)
        gap = abs(runs["pallas"]["accs"][-1] - runs["xla"]["accs"][-1])
        emit({"phase": "zoo", "card": card, "config": f"synth_cifar {net} joint M="
              f"{kw['num_pseudo']} S={kw['mc_samples']} B={kw['data_minibatch']}: "
              "backend=pallas beside xla", "same_start": same_start,
              "one_step": {"loss": {b: float(x) for b, x in loss.items()}, "loss_rel": loss_rel,
                           "heads_outputs_rel": outputs_rel, "relu_flips_after_heads": flips,
                           "importance_weights": iw, "first_moment_worst_leaf": worst,
                           "first_moment_min_cos": worst_cos,
                           "first_moment_worst_vs_xla_b3_heads": worst_heads},
              "b3_launches_by_shape": {f"{s}x{n}x{i}x{o}": c for (s, n, i, o), c in got.items()},
              "b3_expected_by_shape": {f"{s}x{n}x{i}x{o}": c
                                       for (s, n, i, o), c in expect.items()},
              "runs": runs, "acc_gap": gap})
        bad = []
        if not same_start:
            bad.append("engines not at the same start")
        if not (loss_rel <= REL_B3 and max(outputs_rel) <= REL_B3 and worst_cos > COS_B3
                and worst["rel"] <= REL_JOINT_MOMENT
                and worst_heads["rel_vs_xla_b3_heads"] <= REL_B3_HEADS_ONLY):
            bad.append(f"one step: loss rel {loss_rel}, heads' outputs {outputs_rel}, "
                       f"first moment {worst}, against the xla step fed B3's head values "
                       f"{worst_heads}")
        if got != expect:
            bad.append(f"B3 launches {got} != {expect}")
        if not all(math.isfinite(x) for r in runs.values() for x in r["accs"] + r["nlls"]):
            bad.append("non-finite accuracy or NLL")
        if steps > 3 and not gap <= 0.05:
            bad.append(f"accuracy gap {gap} > 0.05")
        if bad:
            failed.append(f"{net} joint: " + "; ".join(bad))

    # 3. one full-width nested step of each conv net in float64 on the card
    # against the host
    for label, kw in ZOO_F64_RUNS:
        kw = {k: v for k, v in kw.items() if k not in ("num_epochs", "log_every")}
        rep = nested_vs_host(make_psvi_engine, cifar, kw)
        emit({"phase": "zoo", "card": card, "config": f"{label}: one nested step's "
              "hypergradients, fp32 and float64 on the card against float64 on the host",
              "gate_rel": REL_F64_HOST, **rep})
        far = {k: v for k, v in rep["card_float64_vs_host_float64"].items()
               if not v["rel"] <= REL_F64_HOST}
        if far or set(rep["card_float64_vs_host_float64"]) != {"g_u", "g_v"}:
            failed.append(f"{label} float64: card against host {far}")

    # 4. AlexNet under bf16 with remat_inner: no kernel
    eng, res, launches, secs = run_engine(
        mods, make_psvi_engine, cifar, only(),
        **{**ALEXNET_KW, "compute_dtype": "bfloat16", "remat_inner": True, "num_epochs": 3,
           "log_every": 2})
    moved = not torch.equal(eng.state.v, eng.state0.v)
    emit({"phase": "zoo", "card": card, "config": "synth_cifar alexnet M=100 S=5 T=10 B=128 "
          "compute_dtype=bfloat16 remat_inner", "steps": 3, "accs": res["accs"],
          "launches": launches, "step_ms": eng.step_ms, "v_moved": moved, "seconds": secs})
    if not moved or not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
        failed.append(f"AlexNet bf16 remat: v moved {moved}, accs {res['accs']}")

    # 5. one AlexNet nested step twice from the same state and generator
    eng = engines[ZOO_RUNS[0][0]]
    step, st, g0 = getattr(eng, eng.step_path), eng.state, eng.gen.get_state()
    outs = []
    for _ in range(2):
        eng.gen.set_state(g0)
        outs.append(tree_leaves(step(st)[0]))
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(*outs))
              if torch.is_tensor(a) and not torch.equal(a, b)]
    ops = []
    if differ:
        eng.gen.set_state(g0)
        ops = _nondeterministic_ops(lambda: step(st))
    emit({"phase": "zoo", "card": card, "config": "synth_cifar alexnet nested step rerun from "
          "one state and generator", "bit_for_bit": not differ, "leaves": len(outs[0]),
          "differing_leaves": len(differ), "nondeterministic_ops": ops})
    if differ and not ops:
        failed.append(f"AlexNet rerun: {len(differ)} leaves differ and no op is named")
    emit({"phase": "zoo", "card": card, "seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("zoo phase: " + "; ".join(failed))
    return engines, shapes


def _agreement(x, ref):
    return {"cos": _cos(x, ref), "rel": _rel(x, ref)}


def _parallel_rank(rank, base):
    """One of the parallel phase's two ranks, both on the one card (gloo:
    NCCL refuses two ranks on one device). From one state, batch and noise
    (the same generator on both ranks): a nested step with ``shard_batch``
    (64 + 64 rows) and with ``shard_mc`` (5 + 5 samples) against the
    unsharded plain step on the card, the shard_mc evaluation against the
    unsharded one on the same draws, and ``run_mfvi`` with ``shard_batch``
    against the unsharded run; no fused kernel launches (the gates refuse
    both modes)."""
    from psvi_torch.data import read_dataset
    from psvi_torch.inference.baselines import run_mfvi
    from psvi_torch.inference.psvi import PSVI
    from psvi_torch.ops import fused_lenet as FL
    from psvi_torch.ops import fused_nested as FN
    from psvi_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda:0")
    blobs = read_dataset("four_blobs")
    ref = PSVI(blobs, fused_inner=False, device=dev, **base)
    batch, eps = ref._sample_batch(), ref._stream_eps()
    st0 = ref.state
    s_ref, aux_ref, g_ref = hypergrads_of(ref, ref._nested_step, st0, batch, eps)

    def evaluate(eng, state):
        with eng._drawing_from(torch.Generator(dev).manual_seed(5)):
            return [float(x) for x in eng._evaluate_fn(state)]

    out = {}
    for mod in (FN, FL):
        mod.reset_launches()
    for name, axis in (("shard_batch", "data"), ("shard_mc", "mc")):
        eng = PSVI(blobs, mesh=make_mesh(**{axis: 2}), shard_batch=axis == "data",
                   shard_mc=axis == "mc", device=dev, **base)
        t0 = time.perf_counter()
        s1, aux, g = hypergrads_of(eng, eng._step, st0, batch, eps)
        torch.cuda.synchronize()
        out[name] = {"step_path": eng._step.__name__, "seconds": time.perf_counter() - t0,
                     "loss": float(aux["outer_loss"]), "loss_ref": float(aux_ref["outer_loss"]),
                     "grads": {k: _agreement(g[k], g_ref[k]) for k in g_ref},
                     "v": _agreement(s1.v - st0.v, s_ref.v - st0.v),
                     "u": _agreement(s1.u - st0.u, s_ref.u - st0.u),
                     "eval": evaluate(eng, s_ref), "eval_ref": evaluate(ref, s_ref)}
    mkw = dict(train=blobs, N=blobs.N, D=blobs.D, architecture="fn", n_hidden=40, nc=4,
               mc_samples=10, data_minibatch=128, num_epochs=26, log_every=25, seed=0,
               device=dev)
    plain = run_mfvi(**mkw)
    sharded = run_mfvi(**mkw, mesh=make_mesh(data=2), shard_batch=True)
    out["mfvi"] = {k: (plain[k], sharded[k]) for k in ("accs", "nlls")}
    out["mfvi"]["elbos"] = (plain["elbos"][-1], sharded["elbos"][-1])
    out["launches"] = {k: n for mod in (FN, FL) for k, n in mod.LAUNCHES.items()}
    return out


def run_cli(mods, expected, argv):
    """``python -m psvi_torch.experiments`` with ``argv``, in this process
    (``runpy``, as ``-m`` runs it) so that the launch counters, set to 0
    just before, can be read just after; returns its saved results and
    seconds."""
    import runpy

    from psvi_torch.utils.results import load_results

    for mod in mods:
        mod.reset_launches()
    saved = sys.argv
    sys.argv = ["psvi_torch.experiments"] + argv
    t0 = time.perf_counter()
    try:
        runpy.run_module("psvi_torch.experiments", run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    read_launches(mods, expected)
    folder = argv[argv.index("--results_folder") + 1]
    for f in ("results.json", "results.pk", "config.json"):
        if not Path(folder, f).exists():
            raise AssertionError(f"the CLI wrote no {f} into {folder}")
    return load_results(folder), secs


def check_parallel(mods, make_psvi_engine, read_dataset, only, card, dev):
    """The parallel phase (queue A.11 and A.12) at the dense flagship
    (``METHODS_BASE``: four_blobs fn 2-40-4 psvi_learn_v M=48 S=10 T=10
    B=128), every launch counter set to 0 just before each run and read
    just after:

    1. the trial runner: 8 trials of 11 steps (log_every 5) as one vmapped
       step, B1 launched 0 times (its gate refuses the vmapped step);
       chained equals unchained; each trial against a plain engine of its
       seed on the card fed the trial's generator (u's and v's moves at
       cosine > 0.9999 and max|Δ| ≤ 1e-3·max|ref|, the final accuracy
       within one test point on one evaluation draw); the batched step's
       median ms beside one trial's plain step;
    2. the sharded engine: two gloo ranks on the card (``_parallel_rank``),
       each check held to the hypergradient gate (cosine > 0.9999, max|Δ|
       ≤ 1e-3·max|ref|), losses at rtol 1e-5, the evaluations' accuracy
       equal and NLL at rtol 1e-4, run_mfvi's accuracies equal and last
       ELBO at rtol 1e-4, no kernel launched;
    3. ``stream_data``: 26 steps streamed against resident, bit for bit,
       B1 launched 26 times in each; the train set on the host; the µs of
       one log block's index copy;
    4. the CLI, in this process: psvi_learn_v 2 trials of 26 epochs (B1 26
       launches a trial), the same with ``--trial_parallel`` and 4 trials
       (no launch), and the random baseline at ``BASELINE_RUNS``' config;
       each run's results files written, each trial at its gate
       (``PARALLEL_GATES``; the random run at ``BASELINE_GATES``).
    Every check runs; the phase fails at its end if any did."""
    import tempfile

    from psvi_torch.parallel.distributed import spawn
    from psvi_torch.parallel.trials import TrialParallelPSVI, index_tree
    from psvi_torch.utils.prng import trial_generator

    t_phase = time.perf_counter()
    failed = []
    blobs = read_dataset("four_blobs")
    gate = PARALLEL_GATES["psvi_learn_v"]

    def check(ok, what):
        if not ok:
            failed.append(what)

    def agrees(a, what):
        check(a["cos"] > COS_MIN and a["rel"] <= REL_G, f"{what}: {a}")

    # 1. the trial runner (the runner seeds trial t itself)
    kw = {k: v for k, v in METHODS_BASE.items() if k != "seed"}
    kw.update(num_epochs=11, log_every=5)
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    tp = TrialParallelPSVI(blobs, 8, **kw)
    res = tp.run(chain_steps=True)
    torch.cuda.synchronize()
    trial_secs = time.perf_counter() - t0
    trial_launches = read_launches(mods, only())
    res_unchained = TrialParallelPSVI(blobs, 8, **kw).run(chain_steps=False)
    for a, b in zip(res, res_unchained):
        check(all(a[k] == b[k] for k in ("accs", "nlls", "ness")),
              f"chained and unchained trial runs differ: {a['accs']} {b['accs']}")
    trials, plain_ms = [], []
    for i, t in enumerate(tp.trials):
        eng = make_psvi_engine(blobs, **{**kw, "seed": t, "fused_inner": False})
        eng.gen = trial_generator(1000, t, dev)
        st = s0 = eng.state
        for _ in range(kw["num_epochs"]):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            st, _ = eng._step(st)
            ev[1].record()
            plain_ms.append(ev)
        s_t = index_tree(tp.states, i)
        row = {"trial": t, "u": _agreement(s_t.u - s0.u, st.u - s0.u),
               "v": _agreement(s_t.v - s0.v, st.v - s0.v)}
        accs = []
        for state in (s_t, st):
            with eng._drawing_from(torch.Generator(dev).manual_seed(11)):
                accs.append(float(eng._evaluate_fn(state)[0]))
        row["acc"], row["acc_plain"] = accs
        agrees(row["u"], f"trial {t} u"), agrees(row["v"], f"trial {t} v")
        check(abs(accs[0] - accs[1]) <= 1.0 / eng.x_test.shape[0] + 1e-6,
              f"trial {t} accuracy {accs[0]} against the plain engine's {accs[1]}")
        trials.append(row)
    torch.cuda.synchronize()
    plain_step_ms = float(np.median([a.elapsed_time(b) for a, b in plain_ms]))
    draws = [tp.draw() for _ in range(5)]
    vstep_ms = []
    states = tp.states
    for batches, eps in draws:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        states, _ = tp.vstep(states, batches, eps)
        ev[1].record()
        vstep_ms.append(ev)
    torch.cuda.synchronize()
    emit({"phase": "parallel", "part": "trials", "card": card,
          "config": "four_blobs fn 2-40-4 psvi_learn_v M=48 S=10 T=10 B=128, 8 trials x 11 "
                    "steps, log_every 5", "step_path": tp._step.__name__,
          "launches": trial_launches, "seconds": trial_secs,
          "accs": [r["accs"] for r in res], "per_trial": trials,
          "vmapped_step_ms_8_trials": float(np.median([a.elapsed_time(b)
                                                       for a, b in vstep_ms])),
          "plain_step_ms_one_trial": plain_step_ms})

    # 2. the sharded engine: two ranks on the one card
    t0 = time.perf_counter()
    ranks = spawn(_parallel_rank, 2, METHODS_BASE, backend="gloo", timeout=600)
    shard_secs = time.perf_counter() - t0
    same = [{k: v for k, v in rk.items() if k != "seconds"} for rk in ranks]
    for rk in same:
        for name in ("shard_batch", "shard_mc"):
            rk[name] = {k: v for k, v in rk[name].items() if k != "seconds"}
    check(same[0] == same[1], "the two ranks disagree")
    r = ranks[0]
    check(not any(r["launches"].values()), f"a sharded run launched a kernel: {r['launches']}")
    for name in ("shard_batch", "shard_mc"):
        c = r[name]
        check(c["step_path"] == "_nested_step", f"{name} took {c['step_path']}")
        check(abs(c["loss"] - c["loss_ref"]) <= RTOL_LOSS * abs(c["loss_ref"]),
              f"{name} loss {c['loss']} against {c['loss_ref']}")
        for k, a in c["grads"].items():
            agrees(a, f"{name} g_{k}")
        agrees(c["v"], f"{name} v"), agrees(c["u"], f"{name} u")
        ev, ref = c["eval"], c["eval_ref"]
        check(ev[0] == ref[0] and abs(ev[1] - ref[1]) <= 1e-4 * abs(ref[1]),
              f"{name} evaluation {ev[:2]} against {ref[:2]}")
    m = r["mfvi"]
    check(m["accs"][0] == m["accs"][1], f"run_mfvi sharded accuracies {m['accs']}")
    check(abs(m["elbos"][0] - m["elbos"][1]) <= 1e-4 * abs(m["elbos"][0]),
          f"run_mfvi sharded last ELBO {m['elbos']}")
    emit({"phase": "parallel", "part": "sharded", "card": card,
          "config": "two gloo ranks on one card; the dense flagship, one nested step each way; "
                    "run_mfvi four_blobs fn 2-40-4 26 epochs", "seconds": shard_secs, **r})

    # 3. stream_data: streamed against resident through B1
    skw = dict(METHODS_BASE, num_epochs=26, log_every=5, fused_inner="auto")
    b1 = only(nested_fwd=26, nested_outer=26, nested_rev=26)
    eng_r, res_r, _, secs_r = run_engine(mods, make_psvi_engine, blobs, b1, **skw)
    eng_s, res_s, launches_s, secs_s = run_engine(mods, make_psvi_engine, blobs, b1,
                                                  stream_data=True, **skw)
    check(res_s["accs"] == res_r["accs"] and res_s["nlls"] == res_r["nlls"],
          f"streamed run {res_s['accs']} against resident {res_r['accs']}")
    check(all(torch.equal(getattr(eng_s.state, k), getattr(eng_r.state, k))
              for k in ("u", "v", "z")), "streamed and resident states differ")
    check(eng_s.x_train.device.type == "cpu", "the streamed train set left the host")
    copy_us = []
    for _ in range(20):
        idx = torch.stack([eng_s._batch_index() for _ in range(skw["log_every"])])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.cpu()
        copy_us.append(1e6 * (time.perf_counter() - t0))
    emit({"phase": "parallel", "part": "stream_data", "card": card,
          "config": "the dense flagship, 26 steps, log_every 5", "launches": launches_s,
          "step_path": eng_s.step_path, "accs": res_s["accs"], "seconds_streamed": secs_s,
          "seconds_resident": secs_r, "step_ms_streamed": eng_s.step_ms,
          "step_ms_resident": eng_r.step_ms,
          "index_copy_us_block_of_5x128": float(np.median(copy_us))})

    # 4. the CLI
    flagship = ["--datasets", "four_blobs", "--methods", "psvi_learn_v", "--architecture", "fn",
                "--n_hidden", "40", "--coreset_sizes", "48", "--mc_samples", "10",
                "--inner_it", "10", "--data_minibatch", "128", "--init_sd", "1e-3",
                "--num_epochs", "26", "--log_every", "25"]
    random_run = ["--datasets", "halfmoon", "--methods", "random", "--num_epochs", "31",
                  "--log_every", "30", "--mc_samples", "10", "--lr0net", "1e-2",
                  "--num_trials", "1"]
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv, expected, n in (
                ("psvi_learn_v 2 trials", flagship + ["--num_trials", "2"],
                 only(nested_fwd=52, nested_outer=52, nested_rev=52), 2),
                ("psvi_learn_v --trial_parallel 4 trials",
                 flagship + ["--num_trials", "4", "--trial_parallel"], only(), 4),
                ("random", random_run, only(), 1)):
            folder = str(Path(tmp, label.replace(" ", "_")))
            res, secs = run_cli(mods, expected, argv + ["--results_folder", folder])
            method = "random" if label == "random" else "psvi_learn_v"
            size = -1 if method == "random" else 48
            node = res["four_blobs" if size > 0 else "halfmoon"][method][size]
            accs = [node[t]["accs"][-1] for t in range(n)]
            g = BASELINE_GATES["halfmoon random M=30"] if method == "random" else gate
            check(len(node) == n and all(a >= g for a in accs),
                  f"CLI {label}: final accuracies {accs} against the gate {g}")
            cli[label] = {"accs": accs, "gate": g, "seconds": secs}
    emit({"phase": "parallel", "part": "cli", "card": card, "runs": cli,
          "t_phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("parallel phase: " + "; ".join(failed))


def check_baselines(mods, make_psvi_engine, read_dataset, read_regression_dataset, only, card):
    """The baselines phase (queue A.10), every launch counter set to 0 just
    before each run and read just after.

    1. ``BASELINE_RUNS`` through each runner's JAX signature: no kernel
       launch (the baselines' nets take no dense backend and no fused
       step), each final accuracy (sinus: test RMSE) held to
       ``BASELINE_GATES``, with its seconds; every Laplace evaluation
       (1000 Adam steps, a host loop of small launches) timed, and the
       NUTS evaluation's accept statistic, divergences and seconds.
    2. ``CUSTOM_RUNS``: the engine with ``init_args='custom'``; the
       selection (pretraining, scores, k-means) launches no kernel, then
       run_psvi launches B1 (dense) or B2 (LeNet) once a step; each held to
       its gate, with the selection's and the run's seconds.
    3. k-means on the LeNet run's penultimate embeddings (6000 × 84, k =
       20): the on-device Lloyd from the native library's k-means++
       centroids against the native fit from the same seed, inertia
       within 1e-4 relative, and both times.
    Every check runs; the phase fails at its end if any did."""
    from psvi_torch import native
    from psvi_torch.inference import baselines, sparsebbvi
    from psvi_torch.inference import selection as PS
    from psvi_torch.models import logreg as LR
    from psvi_torch.ops import kmeans as PK

    t_phase = time.perf_counter()
    failed = []
    dsets = {"halfmoon": read_dataset("halfmoon"), "four_blobs": read_dataset("four_blobs"),
             "synth_mnist": read_dataset("synth_mnist"),
             "sinus": read_regression_dataset("sinus")}
    modules = {"baselines": baselines, "sparsebbvi": sparsebbvi}
    timed = {"laplace": [], "nuts": []}
    real_eval, real_mcmc = LR.evaluate_coreset_laplace, LR.mcmc_sample

    def eval_laplace(*a, **k):
        t0 = time.perf_counter()
        out = tuple(float(v) for v in real_eval(*a, **k))
        timed["laplace"].append(time.perf_counter() - t0)
        return out

    def mcmc_sample(*a, **k):
        t0 = time.perf_counter()
        samples, info = real_mcmc(*a, **k)
        timed["nuts"].append({
            "seconds": time.perf_counter() - t0, "draws": int(samples.shape[0]),
            "accept_stat_mean": float(info["accept_stat"].mean()),
            "divergences": int(info["diverging"].sum()), "step_size": float(info["step_size"])})
        return samples, info

    LR.evaluate_coreset_laplace, LR.mcmc_sample = eval_laplace, mcmc_sample
    try:
        for label, module, runner, name, opts in BASELINE_RUNS:
            timed["laplace"].clear()
            timed["nuts"].clear()
            for mod in mods:
                mod.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = getattr(modules[module], runner)(**runner_data(module, runner, dsets[name]),
                                                   **opts)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
            kind, val = final_metric(res)
            gate = BASELINE_GATES[label]
            curve = res.get("rmses", res.get("accs"))
            line = {"phase": "baselines", "card": card, "config": label, "runner": runner,
                    kind + "s": curve, "gate": gate, "jax": BASELINE_JAX[label],
                    "csizes": res.get("csizes") if runner != "run_mfvi_subset" else None,
                    "launches": launches, "seconds": secs}
            if timed["laplace"]:
                line["laplace_eval_s"] = timed["laplace"][:]
            if timed["nuts"]:
                line["nuts"] = timed["nuts"][:]
            emit(line)
            if launches:
                failed.append(f"{label}: kernels launched {launches}")
            if not all(math.isfinite(x) for x in curve):
                failed.append(f"{label}: non-finite {kind}")
            if (val > gate) if kind == "rmse" else (val < gate):
                failed.append(f"{label}: final {kind} {val} beyond the gate {gate}")
    finally:
        LR.evaluate_coreset_laplace, LR.mcmc_sample = real_eval, real_mcmc

    # 2. init_args='custom' through the engine
    embeddings = {}
    real_emb = PS.Selection._penultimate_embeddings

    def penultimate(self):
        embeddings["lenet"] = real_emb(self)
        return embeddings["lenet"]

    def make_checked(data, **kw):
        for mod in mods:
            mod.reset_launches()
        t0 = time.perf_counter()
        eng = make_psvi_engine(data, **kw)
        torch.cuda.synchronize()
        eng.init_seconds = time.perf_counter() - t0
        eng.init_launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
        return eng

    PS.Selection._penultimate_embeddings = penultimate
    try:
        for label, name, opts, steps, path in CUSTOM_RUNS:
            expected = (only(nested_fwd=steps, nested_outer=steps, nested_rev=steps)
                        if path == "dense" else only(lenet_fwd=steps, lenet_rev=steps))
            eng, res, launches, secs = run_engine(mods, make_checked, dsets[name], expected,
                                                  **opts, num_epochs=steps,
                                                  log_every=steps - 1)
            acc, gate = res["accs"][-1], BASELINE_GATES[label]
            emit({"phase": "baselines", "card": card, "config": label, "steps": steps,
                  "accs": res["accs"], "nlls": res["nlls"], "gate": gate,
                  "jax": BASELINE_JAX[label], "launches": launches,
                  "selection_launches": eng.init_launches,
                  "selection_seconds": eng.init_seconds, "seconds": secs,
                  "step_ms": eng.step_ms, "step_path": eng.step_path,
                  "chosen": len(set(eng.chosen_indices))})
            if eng.init_launches:
                failed.append(f"{label}: the selection launched {eng.init_launches}")
            if len(set(eng.chosen_indices)) != eng.num_pseudo:
                failed.append(f"{label}: {len(set(eng.chosen_indices))} distinct points chosen")
            if not all(math.isfinite(x) for x in res["accs"] + res["nlls"]):
                failed.append(f"{label}: non-finite accuracy or NLL")
            if not acc >= gate:
                failed.append(f"{label}: final accuracy {acc} < {gate}")
    finally:
        PS.Selection._penultimate_embeddings = real_emb

    # 3. k-means on the LeNet embeddings: on the device against the native build
    X = np.ascontiguousarray(embeddings["lenet"], np.float32)
    k, iters = 20, 25
    c0, _, _ = native.kmeans_fit(X, k, iters=0, seed=0)  # the k-means++ centroids
    native_s, device_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        cn, ln, inertia_n = native.kmeans_fit(X, k, iters=iters, seed=0)
        native_s.append(time.perf_counter() - t0)
    Xd, c0d = torch.as_tensor(X, device="cuda"), torch.as_tensor(c0, device="cuda")
    for _ in range(6):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        cd, ld = PK.kmeans_fit(None, Xd, k, iters, init=c0d)
        ev[1].record()
        torch.cuda.synchronize()
        device_ms.append(ev[0].elapsed_time(ev[1]))
    _, inertia_d = native.assign_labels(X, cd.cpu().numpy())
    rel = abs(inertia_d - inertia_n) / inertia_n
    same_labels = float(np.mean(ld.cpu().numpy() == ln))
    emit({"phase": "baselines", "card": card, "config": f"k-means on the LeNet embeddings "
          f"{X.shape[0]}x{X.shape[1]} k={k} iters={iters}", "inertia_native": inertia_n,
          "inertia_device": inertia_d, "rel": rel, "labels_equal_share": same_labels,
          "native_seconds_median": float(np.median(native_s)),
          "device_ms_median": float(np.median(device_ms[1:])), "device_ms": device_ms})
    if not rel <= 1e-4:
        failed.append(f"k-means inertia: device {inertia_d} native {inertia_n}, rel {rel}")
    emit({"phase": "baselines", "card": card, "seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("baselines phase: " + "; ".join(failed))


def median_ms(fn, reps=60, warmup=5):
    """Median per-call time from CUDA events around each call, issued back
    to back so the card stays busy between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def dense_calls(FN, cfg, a):
    """Each dense kernel and its plain version on the inputs ``a``, each fed
    the plain versions' upstream outputs, ready to time."""
    p0, u, z, xb, yb, v, al, e_in, e_out, lr = (a[k] for k in (
        "p0", "u", "z", "xb", "yb", "v", "alpha", "e_in", "e_out", "lr"))
    _, h, cw = FN.nested_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)
    pT = h[cfg.T, 0].contiguous()
    bars = [x.contiguous() for x in FN.nested_outer_torch(pT, u, z, cw, xb, yb, e_out, cfg)[1:]]
    rev = (h, *bars, u, z, cw, v, al, e_in, lr, cfg)
    return {
        "nested_fwd": (lambda: FN._nested_fwd_cuda(p0, u, z, v, al, e_in, lr, cfg),
                       lambda: FN.nested_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)),
        "nested_outer": (lambda: FN._nested_outer_cuda(pT, u, z, cw, xb, yb, e_out, cfg),
                         lambda: FN.nested_outer_torch(pT, u, z, cw, xb, yb, e_out, cfg)),
        "nested_rev": (lambda: FN._nested_rev_cuda(*rev), lambda: FN.nested_rev_torch(*rev)),
    }


def work(cfg):
    """Bytes each kernel must move (inputs once, outputs once) and the fp32
    operations it must do at this config (multiply-adds count 2). The head
    counts 8 operations an output for either likelihood; the Gaussian head
    adds the z̄ sums over samples (S·M adds in the outer step and in each
    reverse iteration). Every call reads and writes its (M,) z̄ rows: the
    categorical head's are zeros."""
    S, T, M, B, P, E = cfg.S, cfg.T, cfg.M, cfg.B, cfg.n_params, cfg.n_eps
    D, nc = cfg.D, cfg.nc
    dims = cfg.layer_dims()
    W = sum(o * i for i, o in dims)
    U = sum(o for _, o in dims)
    Wbp = sum(o * i for i, o in dims[1:])
    elem = 12 * S * (W + U)  # sampling, the ε-weighted sums, Adam, KL/NKL
    zsum = S * M if cfg.gaussian else 0

    def step_ops(NP):  # forward, head, backprop, per-parameter sums
        return 2 * S * NP * (W + Wbp + W + U) + 8 * S * NP * nc + elem

    ops = {
        "nested_fwd": T * step_ops(M),
        "nested_outer": step_ops(M + B) + 2 * S * M * D * dims[0][1] + zsum,
        # recompute + tangent forward, tangent backprop, tangent sums, ū, z̄
        "nested_rev": T * (step_ops(M) + 4 * S * M * W + 4 * S * M * Wbp
                           + 4 * S * M * (W + U) + 4 * S * M * D * dims[0][1] + zsum),
    }
    f = 4
    byts = {
        "nested_fwd": f * (P + M * D + 2 * M + 1 + T * E) + f * (T + (T + 1) * 3 * P + M),
        "nested_outer": f * (P + M * D + 2 * M + B * D + B + E) + f * (1 + P + M * D + 2 * M),
        "nested_rev": f * ((T + 1) * 3 * P + P + 2 * M * D + 5 * M + 1 + T * E)
                      + f * (M * D + 2 * M + 1),
    }
    return ops, byts


def sl_inputs(S, N, Din, Dout, seed, dev):
    """B3's inputs from numpy.random.default_rng(seed): post-ReLU activations,
    U(±1/√Din) means, ρ = softplus⁻¹(1e-3) with a spread of 3 (both branches
    of softplus), N(0, 1) noise."""
    rng = np.random.default_rng(seed)
    rho0, b = math.log(math.expm1(1e-3)), 1.0 / math.sqrt(Din)
    arrays = (np.maximum(rng.standard_normal((S, N, Din)), 0.0), rng.uniform(-b, b, (Dout, Din)),
              rho0 + 3.0 * rng.standard_normal((Dout, Din)), rng.uniform(-b, b, Dout),
              rho0 + 3.0 * rng.standard_normal(Dout), rng.standard_normal((S, Dout, Din)),
              rng.standard_normal((S, Dout)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def check_sampled_linear(SL, chk, dev):
    """B3 against its plain version on the same CUDA inputs at every shape of
    SL_SHAPES and ZOO_SL_SHAPES, and a rerun bit for bit; then the
    Function's backward (JAX's _bwd in torch products, after the kernel's
    forward) against autograd through the plain version, for a random
    output cotangent."""
    names = ("dx", "dmu_w", "drho_w", "dmu_b", "drho_b")
    rep = {"phase": "kernels", "config": "sampled_linear", "gate_rel": REL_B3, "shapes": {}}
    for seed, (label, S, N, Din, Dout) in enumerate(SL_SHAPES + ZOO_SL_SHAPES):
        a = sl_inputs(S, N, Din, Dout, 100 + seed, dev)
        y = SL._sampled_linear_cuda(*a)
        same_bits([SL._sampled_linear_cuda(*a)], [y], "sampled_linear")
        ref = SL.sampled_linear_reference(*a)
        torch.cuda.synchronize()
        e, r = chk._note("sampled_linear", y, ref), _rel(y, ref)
        if not r <= REL_B3:
            raise AssertionError(f"sampled_linear {label}: max|Δ|/max|ref| {r} > {REL_B3}")
        g = torch.randn((S, N, Dout), generator=torch.Generator(dev).manual_seed(seed),
                        device=dev)
        grads = {}
        for key, fn in (("function", SL.sampled_linear), ("autograd", SL.sampled_linear_reference)):
            leaves = [t.clone().requires_grad_(True) for t in a[:5]]
            with torch.enable_grad():
                grads[key] = torch.autograd.grad(fn(*leaves, *a[5:]), leaves, g)
        torch.cuda.synchronize()
        bwd = {}
        for nm, x, ref_g in zip(names, grads["function"], grads["autograd"]):
            c, rg = _cos(x, ref_g), _rel(x, ref_g)
            if not (c > COS_B3 and rg <= REL_B3):
                raise AssertionError(f"sampled_linear backward {label}/{nm}: cos {c}, rel {rg}")
            bwd[nm] = {"cos": c, "rel": rg}
        rep["shapes"][label] = {"S": S, "N": N, "Din": Din, "Dout": Dout,
                                "n_splits": SL._fwd_plan(S, N, Din, Dout), "max_abs": e,
                                "rel": r, "backward": bwd}
    emit(rep)


def philox_bits_check(SLP, dev):
    """The kernels' Philox words equal the plain generator's, bit for bit, on
    zeros, all ones, the Random123 vector and (e, s, 0, 0) for every s < 64
    and e spread up to 2²⁰, under six keys."""
    M = 0xFFFFFFFF
    es = [0, 1, 2, 399, 48_119, 48_239, 2**20 - 1, 2**20]
    es += np.random.default_rng(0).integers(0, 2**20, 24).tolist()
    ctrs = [(0, 0, 0, 0), (M, M, M, M), (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344)]
    ctrs += [(e, s, 0, 0) for s in range(64) for e in es]
    keys = [(0, 0), (M, M), (0xa4093822, 0x299f31d0), SLP.philox_key(-1), SLP.philox_key(7),
            SLP.philox_key(2**40 + 3)]
    ctr = torch.tensor(ctrs, dtype=torch.int64, device=dev)
    ctr32 = torch.where(ctr >= 2**31, ctr - 2**32, ctr).to(torch.int32)  # the same 32 bits
    for key in keys:
        got = SLP._philox_bits_cuda(ctr32, key).to(torch.int64) & M
        if not torch.equal(got, SLP.philox4x32(ctr, key)):
            raise AssertionError(f"philox_bits: the kernel's words differ from the plain "
                                 f"generator's under key {key}")
    return {"counters": len(ctrs), "keys": len(keys), "equal": True}


def slp_calls(SLP, a, g, seed):
    """B4a–c and their plain versions on the inputs a = (x, μ_w, ρ_w, μ_b,
    ρ_b) and the output cotangent g."""
    x, mu_w, rho_w, mu_b, rho_b = a
    return {
        "prng_fwd": (lambda: SLP._prng_fwd_cuda(x, mu_w, rho_w, mu_b, rho_b, seed),
                     lambda: SLP.sampled_linear_prng_reference(x, mu_w, rho_w, mu_b, rho_b, seed)),
        "prng_dx": (lambda: SLP._prng_dx_cuda(g, mu_w, rho_w, seed),
                    lambda: SLP.prng_dx_reference(g, mu_w, rho_w, seed)),
        "prng_dparam": (lambda: SLP._prng_dparam_cuda(g, x, rho_w, rho_b, seed),
                        lambda: SLP.prng_dparam_reference(g, x, rho_w, rho_b, seed)),
    }


def nkl_call(SLP, p, seed, S):
    """B4d and its plain version on p = (μ_w, ρ_w, μ_b, ρ_b)."""
    return (lambda: SLP._prng_nkl_cuda(*p, seed, S),
            lambda: SLP.vi_linear_nkl_prng_reference(*p, seed, S))


def nkl_plan(SLP, S, Din, Dout):
    """B4d's grid (``_nkl_plan``): element tiles, sample groups, samples a
    group."""
    return dict(zip(("tiles", "groups", "samples_per_group"), SLP._nkl_plan(S, Din, Dout)))


def check_against_plain(chk, name, label, kern, plain):
    """One kernel against its plain version at REL_B3 on every output, and a
    rerun bit for bit. Returns max |Δ|/max |ref| over the outputs."""
    k = kern()
    k = k if isinstance(k, tuple) else (k,)
    rerun = kern()
    same_bits(rerun if isinstance(rerun, tuple) else (rerun,), k, name)
    r = plain()
    r = r if isinstance(r, tuple) else (r,)
    torch.cuda.synchronize()
    rel = 0.0
    for x, y in zip(k, r):
        chk._note(name, x, y)
        rel = max(rel, _rel(x, y))
    if not rel <= REL_B3:
        raise AssertionError(f"{name} {label}: max|Δ|/max|ref| {rel} > {REL_B3}")
    return rel


def pallas_args(S, N, Din, Dout, seed, dev):
    """tests/test_pallas.py:21's scales: x ~ N(0, 1), μ ~ 0.1·N(0, 1),
    ρ ~ 0.1·N(0, 1) − 3."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((S, N, Din)), 0.1 * rng.standard_normal((Dout, Din)),
         0.1 * rng.standard_normal((Dout, Din)) - 3, 0.1 * rng.standard_normal(Dout),
         0.1 * rng.standard_normal(Dout) - 3)
    return [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in a]


def prng_statistics(SLP, VILinear, dev):
    """tests/test_pallas.py:60-124 on the kernels: determinism with samples
    and seeds distinct; cross-tile consistency; E[−nkl] over 4000 samples
    against the closed-form KL; dx against the weights recovered from the
    forward."""
    fwd = SLP.sampled_linear_prng
    a = pallas_args(6, 64, 32, 16, 0, dev)
    y1, y2, y3 = fwd(*a, 7), fwd(*a, 7), fwd(*a, 8)
    out = {"deterministic": torch.equal(y1, y2),
           "samples_differ": float((y1[0] - y1[1]).abs().max()),
           "seeds_differ": float((y1 - y3).abs().max())}
    x, *p = pallas_args(4, 1024, 400, 120, 1, dev)
    x[:, 512] = x[:, 0]
    y = fwd(x, *p, 3)
    out["cross_tile_max_abs"] = float((y[:, 512] - y[:, 0]).abs().max())
    _, *p = pallas_args(1, 1, 64, 32, 2, dev)
    kl = float(VILinear(64, 32).kl(dict(zip(("mu_w", "rho_w", "mu_b", "rho_b"), p))))
    nkl = SLP.vi_linear_nkl_prng(*p, 11, 4000).double()
    se = float(nkl.std()) / math.sqrt(4000)
    out["kl"] = {"closed_form": kl, "mc": -float(nkl.mean()), "se": se}
    S, N, Din, Dout = 4, 256, 128, 64
    x, *p = pallas_args(S, N, Din, Dout, 3, dev)
    b_rec = fwd(torch.zeros(S, 8, Din, device=dev), *p, 5)[:, 0]
    eye = torch.eye(Din, device=dev).expand(S, Din, Din)
    w_rec = (fwd(eye, *p, 5) - b_rec[:, None, :]).transpose(1, 2)
    x.requires_grad_(True)
    with torch.enable_grad():
        y = fwd(x, *p, 5)
        (gx,) = torch.autograd.grad(torch.sin(y).sum(), [x])
    want = torch.einsum("sno,soi->sni", torch.cos(y.detach()), w_rec)
    out["dx_vs_recovered_max_abs"] = float((gx - want).abs().max())
    if not (out["deterministic"] and out["samples_differ"] > 1e-3 and out["seeds_differ"] > 1e-3):
        raise AssertionError(f"B4 determinism: {out}")
    if not out["cross_tile_max_abs"] <= 1e-6:
        raise AssertionError(f"B4 cross-tile: {out['cross_tile_max_abs']}")
    if not abs(out["kl"]["mc"] - kl) < 5 * se + 1e-3 * abs(kl):
        raise AssertionError(f"B4 E[-nkl] against KL: {out['kl']}")
    if not bool(torch.all((gx - want).abs() <= 1e-5 + 1e-4 * want.abs())):
        raise AssertionError(f"B4 dx against the recovered weights: {out}")
    return out


def prng_stack_loss(S, N, n_data, x, labels, layers, seeds, forward, nkl):
    """A dense stack with ReLU between layers and one seed per layer: the
    categorical NLL scaled to the data, minus the mean NKL (a value only)."""
    h, total = x, 0.0
    for k, (p, seed) in enumerate(zip(layers, seeds)):
        h = forward(h, *p, seed)
        if k < len(layers) - 1:
            h = torch.relu(h)
        total = total + nkl(*p, seed).detach()
    nll = -torch.log_softmax(h, -1).gather(-1, labels[None, :, None].expand(S, N, 1))[..., 0]
    return n_data / N * nll.sum(1).mean() - total.mean()


def composed_prng_check(SLP, SL, VILinear, mnist, dev):
    """The four B4 kernels draw one ε: the 400-120-84-10 stack at S = 10,
    N = 356 on synth_mnist rows (the central 20×20 pixels), once through
    sampled_linear_prng and vi_linear_nkl_prng, with B4's launch counters set
    to 0 just before and read just after, then through B3's sampled_linear
    and VILinear.nkl fed the ε that prng_normal gives for each seed. Loss at
    rtol 1e-5; the gradients of x, μ and ρ at cosine > COS_B3 and ≤
    REL_B3·max |ref|."""
    S, N, widths, seeds = 10, 356, (400, 120, 84, 10), (11, -12, 13)
    rng = np.random.default_rng(5)
    rows = rng.choice(len(mnist.x), N, replace=False)
    x0 = mnist.x[rows][:, 0, 4:24, 4:24].reshape(N, 400)
    labels = torch.as_tensor(mnist.y[rows], dtype=torch.int64, device=dev)
    rho0 = math.log(math.expm1(1e-3))
    leaves = [torch.as_tensor(x0, dtype=torch.float32, device=dev).expand(S, N, 400)]
    for i, o in zip(widths[:-1], widths[1:]):
        b = 1.0 / math.sqrt(i)
        leaves += [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (
            rng.uniform(-b, b, (o, i)), rho0 + 0.1 * rng.standard_normal((o, i)),
            rng.uniform(-b, b, o), rho0 + 0.1 * rng.standard_normal(o))]
    leaves = [t.contiguous().requires_grad_(True) for t in leaves]
    layers = [leaves[1 + 4 * k:5 + 4 * k] for k in range(3)]

    def b3_forward(h, mu_w, rho_w, mu_b, rho_b, seed):
        return SL.sampled_linear(h, mu_w, rho_w, mu_b, rho_b,
                                 *SLP.prng_eps(seed, S, *mu_w.shape, dev))

    def port_nkl(mu_w, rho_w, mu_b, rho_b, seed):
        w, b = SLP.prng_eps(seed, S, *mu_w.shape, dev)
        p = {"mu_w": mu_w, "rho_w": rho_w, "mu_b": mu_b, "rho_b": rho_b}
        return VILinear(mu_w.shape[1], mu_w.shape[0]).nkl(p, {"w": w, "b": b})

    runs = {}
    torch.cuda.synchronize()
    SLP.reset_launches()
    with torch.enable_grad():
        loss = prng_stack_loss(S, N, float(mnist.N), leaves[0], labels, layers, seeds,
                               SLP.sampled_linear_prng,
                               lambda *p: SLP.vi_linear_nkl_prng(*p, S))
        runs["prng"] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    launches = dict(SLP.LAUNCHES)
    if launches != {k: 3 for k in SLP.LAUNCHES}:
        raise AssertionError(f"the composed B4 step launched {launches}, expected 3 of each")
    with torch.enable_grad():
        loss = prng_stack_loss(S, N, float(mnist.N), leaves[0], labels, layers, seeds,
                               b3_forward, port_nkl)
        runs["b3"] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    (lk, gk), (lr, gr) = runs["prng"], runs["b3"]
    rep = {"loss": float(lk), "loss_b3": float(lr), "launches": launches, "grads": {}}
    if not abs(float(lk) - float(lr)) <= 1e-5 * abs(float(lr)):
        raise AssertionError(f"composed B4 loss {float(lk)} against B3's {float(lr)}")
    names = ["x"] + [f"fc{k + 1}.{n}" for k in range(3) for n in ("mu_w", "rho_w", "mu_b", "rho_b")]
    for nm, x, y in zip(names, gk, gr):
        c, r = _cos(x, y), _rel(x, y)
        if not (c > COS_B3 and r <= REL_B3):
            raise AssertionError(f"composed B4 gradient {nm}: cos {c}, rel {r}")
        rep["grads"][nm] = {"cos": c, "rel": r}
    return rep, launches


def check_sampled_linear_prng(SLP, SL, VILinear, softplus, mnist, chk, dev):
    """Kernel B4 on the card: the generator's bits; ε as the kernels see it
    (W_s and b_s recovered from B4a at x = I and x = 0, against the plain
    ε); each kernel against its plain version and a rerun at SLP_SHAPES and
    NKL_CHECK_SHAPES; the statistical tests; the composed stack. Returns B4's
    launches in the composed step."""
    rep = {"phase": "sampled_linear_prng", "gate_rel": REL_B3,
           "bits": philox_bits_check(SLP, dev), "eps": {}, "shapes": {}, "nkl": {}}
    for seed, (label, S, _, Din, Dout) in enumerate(SL_SHAPES[:3]):
        x, mu_w, rho_w, mu_b, rho_b = sl_inputs(S, 1, Din, Dout, 400 + seed, dev)[:5]
        b_rec = SLP._prng_fwd_cuda(torch.zeros(S, 1, Din, device=dev), mu_w, rho_w, mu_b, rho_b,
                                   seed)[:, 0]
        eye = torch.eye(Din, device=dev).expand(S, Din, Din).contiguous()
        y_eye = SLP._prng_fwd_cuda(eye, mu_w, rho_w, mu_b, rho_b, seed)
        w_rec = (y_eye - b_rec[:, None, :]).transpose(1, 2)
        eps_w, eps_b = SLP.prng_eps(seed, S, Dout, Din, dev)
        w = mu_w + softplus(rho_w) * eps_w
        b = mu_b + softplus(rho_b) * eps_b
        rel = {"w": _rel(w_rec, w), "b": _rel(b_rec, b)}
        if not max(rel.values()) <= REL_B3:
            raise AssertionError(f"B4 eps as the kernels see it, {label}: {rel}")
        rep["eps"][label] = rel
    for seed, (label, S, N, Din, Dout) in enumerate(SLP_SHAPES):
        a = sl_inputs(S, N, Din, Dout, 500 + seed, dev)[:5]
        g = torch.randn((S, N, Dout), generator=torch.Generator(dev).manual_seed(seed), device=dev)
        rep["shapes"][label] = {"S": S, "N": N, "Din": Din, "Dout": Dout, "n_splits": {
            "prng_fwd": SLP._fwd_plan(S, N, Din, Dout), "prng_dx": SLP._dx_plan(S, N, Din, Dout),
            "prng_dparam": SLP._dparam_plan(S, N, Din, Dout)}, **{
            name: check_against_plain(chk, name, label, kern, plain)
            for name, (kern, plain) in slp_calls(SLP, a, g, -seed).items()}}
    for seed, (label, S, Din, Dout) in enumerate(NKL_CHECK_SHAPES):
        p = sl_inputs(1, 1, Din, Dout, 600 + seed, dev)[1:5]
        rep["nkl"][label] = {"S": S, "Din": Din, "Dout": Dout, "plan": nkl_plan(SLP, S, Din, Dout),
                             "rel": check_against_plain(chk, "prng_nkl", label,
                                                        *nkl_call(SLP, p, 2**40 + seed, S))}
    rep["statistics"] = prng_statistics(SLP, VILinear, dev)
    rep["composed"], launches = composed_prng_check(SLP, SL, VILinear, mnist, dev)
    emit(rep)
    return launches


def slp_work(name, S, N, Din, Dout):
    """B4's fp32 operations and bytes: each ε drawn once per (sample,
    parameter) at GEN_OPS, then the sampling's multiply and add (dparam: the
    add into dμ and the multiply-add into dρ); the products' multiply-adds
    count 2, the bias add or sum one a term; the NKL's two densities and the
    sum 12 a term (softplus is not counted, as in sl_work). Bytes: each input
    read once, each output written once; no ε. Last, the operations among
    them that run as a 3xTF32 product on the tensor cores (the forward's
    product; dx and dparam keep fp32 FMA loops)."""
    W, E = Dout * Din, Dout * Din + Dout
    prod = 2 * S * N * Din * Dout
    ops = {"prng_fwd": prod + S * N * Dout + S * E * (GEN_OPS + 2),
           "prng_dx": prod + S * W * (GEN_OPS + 2),
           "prng_dparam": prod + S * N * Dout + S * E * (GEN_OPS + 3),
           "prng_nkl": S * E * (GEN_OPS + 12)}[name]
    byts = 4 * {"prng_fwd": S * N * Din + 2 * E + S * N * Dout,
                "prng_dx": S * N * Dout + 2 * W + S * N * Din,
                "prng_dparam": S * N * Dout + S * N * Din + E + 2 * E,
                "prng_nkl": 2 * E + S}[name]
    return ops, byts, prod if name == "prng_fwd" else 0


def queued_row(name, source, replaces, kern, plain, lib_fn, ops, byts, mma_ops, launches, chk,
               kernel, **extra):
    """The kernels-line entry of a kernel whose one call costs more host
    time than device time: the kernel, its plain version and a library call
    (or None) timed with ``queued_ms``. Its bound takes the ``mma_ops`` of
    its ``ops`` as three TF32 passes at the tensor cores' rate (a 3xTF32
    product), the rest at the fp32 rate."""
    ms, q_k = queued_ms(kern)
    plain_ms, q_p = queued_ms(plain)
    lib_ms, q_l = queued_ms(lib_fn) if lib_fn else (None, True)
    t_ops = ((ops - mma_ops) / PEAK_FP32_FLOPS + 3 * mma_ops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": chk.max_abs[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms,
            "queued_ahead": q_k and q_p and q_l, "ops": ops, "mma_ops": mma_ops, "bytes": byts,
            **extra}


def sl_work(S, N, Din, Dout):
    """B3's fp32 operations (the product's multiply-adds count 2, the
    sampling a multiply and an add per sampled weight and bias, the bias add
    one), bytes (each input read once, the output written once) and the
    product's operations, which run as a 3xTF32 product on the tensor cores."""
    prod = 2 * S * N * Din * Dout
    ops = prod + 2 * S * Dout * (Din + 1) + S * N * Dout
    byts = 4 * (S * N * Din + 2 * Dout * Din + 2 * Dout + S * Dout * Din + S * Dout + S * N * Dout)
    return ops, byts, prod


def b3_expected(data, kw, forwards_per_step, retrain=False):
    """B3's launches in one run_psvi, derived from its loops. Each forward of
    the net launches it once for every VILinear that sees a batched (S, N, ·)
    input: LeNet's and AlexNet's three fc layers, ResNet's head, every fn
    layer after the first. A
    training step runs ``forwards_per_step`` forwards, an evaluation one per
    test batch, a retrain step one."""
    n3 = {"lenet": 3, "alexnet": 3, "resnet": 1}.get(kw["architecture"]) or kw["n_layers"]
    evals = len(range(0, kw["num_epochs"], kw["log_every"]))
    n_test = len(data.xt)
    per_eval = -(-n_test // min(kw["data_minibatch"], n_test))
    n = kw["num_epochs"] * forwards_per_step + evals * per_eval
    if retrain:
        n += kw["num_epochs"] + evals * per_eval
    return n3 * n


def queued_ms(fn, reps=50, rounds=5):
    """Device time per call: CUDA events around ``reps`` calls queued behind
    a device sleep, so the host's launch cost is hidden and the calls run
    back to back; the median over ``rounds``. Also whether the host finished
    queueing before the sleep ended (else the time includes host gaps)."""
    fn()
    torch.cuda.synchronize()
    times, queued = [], True
    for _ in range(rounds):
        e0, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(100_000_000)
        s.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        torch.cuda.synchronize()
        queued = queued and host_ms < e0.elapsed_time(s)
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times)), queued


def lenet_cfg(FL, data, S, M, T, parameterised, use_alpha):
    return FL.LeNetCfg(T=T, S=S, M=M, nc=data.nc, N=float(data.N), parameterised=parameterised,
                       use_alpha=use_alpha, prior_sd=1.0)


def lenet_inputs(FL, cfg, data, seed, dev):
    """Engine-like inputs of the LeNet unroll from numpy.random.default_rng:
    U(±1/√fan_in) means, ρ = softplus⁻¹(1e-3) plus a small spread, a coreset
    of synth_mnist images, N(0, 1) noise, and random cotangents of paramsT
    and of the inner losses for the reverse sweep."""
    rng = np.random.default_rng(seed)
    rho0 = math.log(math.expm1(1e-3))
    layers = []
    for wshape, o in cfg.layer_shapes():
        b = 1.0 / math.sqrt(math.prod(wshape[1:]))
        layers.append({"mu_w": rng.uniform(-b, b, wshape),
                       "rho_w": rho0 + 0.1 * rng.standard_normal(wshape),
                       "mu_b": rng.uniform(-b, b, o), "rho_b": rho0 + 0.1 * rng.standard_normal(o)})

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    iu = rng.choice(len(data.x), cfg.M, replace=False)
    v = 0.3 * rng.standard_normal(cfg.M) if cfg.parameterised else np.full(cfg.M, 1.0 / cfg.M)
    return dict(p0=FL.pack_params([{k: t(x) for k, x in d.items()} for d in layers]),
                e_in=t(rng.standard_normal((cfg.T, cfg.n_eps))), u=t(data.x[iu]),
                z=t(data.y[iu], torch.int32), v=t(v), alpha=t([0.1 if cfg.use_alpha else 0.0]),
                pbar=t(rng.standard_normal(cfg.n_params)), dlosses=t(rng.standard_normal(cfg.T)),
                lr=1e-3)


def lenet_unroll_grads(FL, cfg, a, backend):
    """pT, the inner losses and the gradients of ⟨p̄, pT⟩ + ⟨dl, losses⟩ with
    respect to (p0, u, v, α) through ``lenet_unroll``."""
    leaves = [a[k].detach().clone().requires_grad_(True) for k in ("p0", "u", "v", "alpha")]
    p0, u, v, al = leaves
    with torch.enable_grad():
        pT, losses = FL.lenet_unroll(p0, u, v, al, a["z"], a["e_in"], a["lr"], cfg,
                                     backend=backend)
        obj = (pT * a["pbar"]).sum() + (losses * a["dlosses"]).sum()
        grads = torch.autograd.grad(obj, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return [pT.detach(), losses.detach()] + grads


def same_bits(outs, ref, kernel):
    """A second launch on the same inputs gives the same bits: the kernels
    reduce in a fixed order and use no float atomics."""
    if not all(torch.equal(x, y) for x, y in zip(outs, ref)):
        raise AssertionError(f"{kernel}: a rerun on the same inputs changed the result")


def check_lenet(FL, chk, name, cfg, a, composed):
    """lenet_fwd and lenet_rev against their plain versions on the same CUDA
    inputs (the reverse sweep on the plain forward's history), each rerun
    bit for bit, and with ``composed`` the whole LeNetUnroll (CUDA) against
    the autograd oracle."""
    p0, u, z, v, al, e_in, lr = (a[k] for k in ("p0", "u", "z", "v", "alpha", "e_in", "lr"))
    rep = {"phase": "lenet", "config": name, "S": cfg.S, "M": cfg.M, "T": cfg.T,
           "parameterised": cfg.parameterised, "use_alpha": cfg.use_alpha}
    l_k, h_k, cw_k = FL._lenet_fwd_cuda(p0, u, z, v, al, e_in, lr, cfg)
    same_bits(FL._lenet_fwd_cuda(p0, u, z, v, al, e_in, lr, cfg), (l_k, h_k, cw_k), "lenet_fwd")
    l_t, h_t, cw_t = FL.lenet_fwd_torch(p0, u, z, v, al, e_in, lr, cfg)
    torch.cuda.synchronize()
    rep["fwd"] = {
        "losses": chk.allclose("lenet_fwd", "losses", l_k, l_t, RTOL_LOSS),
        "paramsT": chk.allclose("lenet_fwd", "paramsT", h_k[:, 0], h_t[:, 0], RTOL_P, ATOL_P),
        "m": chk.grad("lenet_fwd", "m", h_k[:, 1], h_t[:, 1]),
        "n": chk.grad("lenet_fwd", "n", h_k[:, 2], h_t[:, 2]),
        "cw": chk.allclose("lenet_fwd", "cw", cw_k, cw_t, RTOL_LOSS),
    }
    r_k = FL._lenet_rev_cuda(h_t, a["pbar"], a["dlosses"], u, z, v, al, e_in, lr, cfg)
    same_bits(FL._lenet_rev_cuda(h_t, a["pbar"], a["dlosses"], u, z, v, al, e_in, lr, cfg), r_k,
              "lenet_rev")
    r_t = FL.lenet_rev_torch(h_t, a["pbar"], a["dlosses"], u, z, v, al, e_in, lr, cfg)
    torch.cuda.synchronize()
    rep["rev"] = {nm: chk.grad("lenet_rev", nm, x, y)
                  for nm, x, y in zip(("p0bar", "ubar", "vbar"), r_k, r_t)}
    if cfg.use_alpha:
        rep["rev"]["abar"] = chk.allclose("lenet_rev", "abar", r_k[3], r_t[3], RTOL_ALPHA, ATOL_P)
    if composed:
        k, r = (lenet_unroll_grads(FL, cfg, a, b) for b in ("cuda", "autograd"))
        torch.cuda.synchronize()
        tag = "lenet_step_vs_autograd"
        rep["step_vs_autograd"] = {
            "paramsT": chk.allclose(tag, "paramsT", k[0], r[0], RTOL_P, ATOL_P),
            "inner_losses": chk.allclose(tag, "inner_losses", k[1], r[1], RTOL_LOSS),
            "p0bar": chk.grad(tag, "p0bar", k[2], r[2]),
            "ubar": chk.grad(tag, "ubar", k[3], r[3]),
            "vbar": chk.grad(tag, "vbar", k[4], r[4]),
        }
        if cfg.use_alpha:
            rep["step_vs_autograd"]["abar"] = chk.allclose(tag, "abar", k[5], r[5], RTOL_ALPHA,
                                                           ATOL_P)
    emit(rep)
    return h_t


def check_lenet_caps(FL, PSVI, mnist, chk, dev):
    """At the caps of the LeNet ``supports()`` (S = 64, M = 1024): the engine
    admits the config and refuses one more sample or point, and both
    kernels agree with their plain versions (T = 2)."""
    kw = dict(method="psvi_learn_v", architecture="lenet", inner_it=2, data_minibatch=256,
              init_sd=1e-3, seed=0)
    eng = PSVI(mnist, num_pseudo=FL.MAX_POINTS, mc_samples=FL.MAX_SAMPLES, **kw)
    if not FL.supports(eng) or eng._step.__name__ != "_nested_step_fused_lenet":
        raise AssertionError("the LeNet supports() refuses its own caps")
    for over in (dict(num_pseudo=FL.MAX_POINTS + 1, mc_samples=FL.MAX_SAMPLES),
                 dict(num_pseudo=FL.MAX_POINTS, mc_samples=FL.MAX_SAMPLES + 1)):
        if FL.supports(PSVI(mnist, **over, **kw)):
            raise AssertionError(f"the LeNet supports() admits {over}")
    cfg = FL.cfg_from_engine(eng)
    check_lenet(FL, chk, f"caps S={cfg.S} M={cfg.M} T={cfg.T}", cfg,
                lenet_inputs(FL, cfg, mnist, 11, dev), False)


def lenet_work(cfg):
    """Operations (multiply-adds count 2) and bytes of lenet_fwd and
    lenet_rev at this config. The pool keeps one of four conv outputs, so
    every pass after the pooled forward (the backprop, the weight gradients,
    the tangent pass at the stored winners, ū) counts the winners only; the
    forward computes all four parities for the max."""
    S, M, T, K1, K2, q, nc = cfg.S, cfg.M, cfg.T, cfg.K1, cfg.K2, cfg.q, cfg.nc
    F0, F1, F2 = cfg.fc[:3]
    SM = S * M
    conv1 = 2 * SM * K1 * cfg.H * cfg.H * q
    conv2 = 2 * SM * K2 * cfg.H2 * cfg.H2 * K1 * q
    conv1_win, conv2_win = conv1 // 4, conv2 // 4
    fc = 2 * SM * (F0 * F1 + F1 * F2 + F2 * nc)
    head = 8 * SM * nc
    elem = 12 * S * cfg.n_theta  # sampling, the ε-weighted sums, Adam, KL
    # forward; backprop (fc data, conv2 data) and weight gradients
    fwd_iter = conv1 + conv2 + fc + head + (2 * fc + 2 * conv2_win + conv1_win) + elem
    # tangent forward (conv1, both conv2 terms, both fc terms), tangent backprop and
    # weight gradients (two terms each, one for conv1), ū (two terms)
    tangent = (conv1_win + 2 * conv2_win + 2 * fc + head + 2 * fc + 2 * conv2_win
               + 2 * fc + 2 * conv2_win + conv1_win + 2 * conv1_win + elem)
    ops = {"lenet_fwd": T * fwd_iter, "lenet_rev": T * (fwd_iter + tangent)}
    P, E, U = cfg.n_params, cfg.n_eps, M * cfg.H * cfg.H
    f = 4
    byts = {
        "lenet_fwd": f * (P + U + 3 * M + 1 + T * E) + f * (T + (T + 1) * 3 * P + M),
        "lenet_rev": f * ((T + 1) * 3 * P + P + T + U + 3 * M + 1 + T * E)
                     + f * (P + U + M + 1),
    }
    return ops, byts


def timed_kernel(name, kern, plain, ops, byts, launches, chk, source, replaces, reps,
                 **extra):
    """The kernels-line entry of one kernel: its median time and its plain
    version's on the same inputs, beside the bound from ops and bytes."""
    ms, plain_ms = median_ms(kern, reps=reps, warmup=2), median_ms(plain, reps=reps, warmup=2)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": chk.max_abs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "ops": ops, "bytes": byts, **extra}


def profile_calls(calls, sums=None):
    """Device time by CUDA kernel over one call of each function, from
    torch.profiler: the device events' own time summed by name (ms; host
    ranges such as an autograd Function's are left out, so nothing counts
    twice), the launch counts, and the host wall time of the call; for each
    ``sums`` entry (key: a substring of kernel names) the device time of
    every kernel whose name holds it. ``device_ms`` is None where the
    profiler saw no device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key.split("(")[0], e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        device_ms = sum(r[1] for r in rows) or None
        out[name] = {"wall_ms_profiled": wall_ms, "device_ms": device_ms,
                     "top": [{"kernel": k, "ms": ms, "launches": c} for k, ms, c in rows[:24]],
                     **{key: sum(ms for k, ms, _ in rows if sub in k)
                        for key, sub in (sums or {}).items()}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import psvi_torch  # noqa: F401  (fails outside a checkout)
    from psvi_torch.data import DataBundle, read_dataset, read_regression_dataset
    from psvi_torch.inference.psvi import PSVI, make_psvi_engine
    from psvi_torch.models.layers import VILinear, softplus
    from psvi_torch.ops import _build
    from psvi_torch.ops import fused_lenet as FL
    from psvi_torch.ops import fused_nested as FN
    from psvi_torch.ops import sampled_linear as SL
    from psvi_torch.ops import sampled_linear_prng as SLP

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true fp32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build every kernel source of the paths, one nvcc each, all at once
    t0 = time.perf_counter()
    sources = ["fused_nested", "fused_lenet", "sampled_linear", "sampled_linear_prng"]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    ptxas = {src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for src, (_, log) in zip(sources, built)}
    # an empty log means the library was already built (no ptxas report)
    spills = {src: check_no_spills(built[sources.index(src)][1], kernels)
              if built[sources.index(src)][1] else "not rebuilt"
              for src, kernels in (("sampled_linear", B3_NO_SPILL),
                                   ("sampled_linear_prng", B4_NO_SPILL),
                                   ("fused_lenet", LENET_NO_SPILL),
                                   ("fused_nested", NESTED_NO_SPILL))}
    nested_log = built[sources.index("fused_nested")][1]
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, "spill_bytes": spills,
          "stack_bytes": ptxas_stack(nested_log, NESTED_NO_SPILL) if nested_log
          else "not rebuilt"})

    # 3. kernels against their plain versions on the card
    halfmoon, blobs = read_dataset("halfmoon"), read_dataset("four_blobs")
    mnist, sinus = read_dataset("synth_mnist"), read_regression_dataset("sinus")
    chk = Checker()
    configs = [
        ("halfmoon_logreg_M30", halfmoon, [2, 2], 30, True, False),
        ("four_blobs_fn_2-40-4_M48", blobs, [2, 40, 4], 48, True, False),
        ("four_blobs_fn2layer_2-40-40-4_M48_alpha", blobs, [2, 40, 40, 4], 48, True, True),
    ]
    for seed, (name, data, widths, M, par, ua) in enumerate(configs):
        cfg = main_cfg(FN, data, widths, M, par, ua)
        check_kernels(FN, chk, name, cfg, kernel_inputs(FN, cfg, data.x, data.y, seed, dev))
    # the Gaussian head on sinus (N = 800, B = 64): the regression main path,
    # two hidden layers with α, and f(v) = v with hypers (u, z) only
    reg_configs = [  # name, widths, parameterised, use_alpha, tau, inner lr
        ("sinus 1-40-1 psvi_learn_v_regressor M=10 tau=0.1", [1, 40, 1], True, False, 0.1, 1e-3),
        ("sinus 1-40-40-1 psvi_alpha_v_regressor M=10 tau=1", [1, 40, 40, 1], True, True, 1.0,
         1e-2),
        ("sinus 1-40-1 psvi_regressor M=10 tau=0.1", [1, 40, 1], False, False, 0.1, 1e-2),
    ]
    for seed, (name, widths, par, ua, tau, lr) in enumerate(reg_configs):
        cfg = main_cfg(FN, sinus, widths, 10, par, ua, B=64, tau=tau)
        a = kernel_inputs(FN, cfg, sinus.x, sinus.y, seed, dev, lr=lr)
        check_kernels(FN, chk, name, cfg, a)
        if seed == 0:
            centring_effect(FN, cfg, a)
    check_caps(FN, make_psvi_engine, DataBundle, chk, dev)
    lenet_configs = [  # name, S, M, T, parameterised, use_alpha, composed check
        ("psvi_learn_v S=10 M=100 T=20", 10, 100, 20, True, False, False),
        ("psvi_alpha_v S=4 M=16 T=5", 4, 16, 5, True, True, True),
        ("psvi S=3 M=8 T=3", 3, 8, 3, False, False, True),
        # the conv tiles take two points a block: M = 13 leaves a ragged
        # chunk. (At T = 2 the plain version's own fp32 p̄0 is 0.12 of max|p̄0|
        # off its float64 run on these inputs, t = 1's Adam VJP ∝ 1/|g|:
        # scripts/torch_lenet_fp32_gap.py.)
        ("psvi_learn_v S=2 M=13 T=3", 2, 13, 3, True, False, True),
    ]
    for seed, (name, S, M, T, par, ua, composed) in enumerate(lenet_configs):
        cfg = lenet_cfg(FL, mnist, S, M, T, par, ua)
        check_lenet(FL, chk, name, cfg, lenet_inputs(FL, cfg, mnist, seed, dev), composed)
    check_lenet_caps(FL, PSVI, mnist, chk, dev)
    check_sampled_linear(SL, chk, dev)
    launches_b4 = check_sampled_linear_prng(SLP, SL, VILinear, softplus, mnist, chk, dev)

    # 4. the main paths, through the user's entry point (no engine path
    # launches B4, in JAX or here)
    mods = (FN, FL, SL, SLP)

    def only(**n):  # expected launches: n of the named kernels, none of the rest
        return {k: n.get(k, 0) for mod in mods for k in mod.LAUNCHES}

    dense_only = only(nested_fwd=101, nested_outer=101, nested_rev=101)
    main_kw = dict(method="psvi_learn_v", num_pseudo=48, mc_samples=10, architecture="fn",
                   n_hidden=40, n_layers=1, inner_it=10, data_minibatch=128, init_sd=1e-3,
                   num_epochs=101, log_every=50, seed=0, fused_inner="auto")
    eng, res, launches, secs = run_engine(mods, make_psvi_engine, blobs, dense_only, **main_kw)
    acc = res["accs"][-1]
    emit({"phase": "engine", "config": "four_blobs fn 2-40-4 psvi_learn_v M=48", "accs": res["accs"],
          "nlls": res["nlls"], "launches": launches, "seconds": secs,
          "step_path": eng.step_path})
    if not acc >= 0.90:
        raise AssertionError(f"four_blobs fn final accuracy {acc} < 0.90")
    _, res_h, launches_h, secs_h = run_engine(
        mods, make_psvi_engine, halfmoon, dense_only, method="psvi_learn_v", num_pseudo=30,
        mc_samples=10, architecture="logistic_regression", inner_it=10, data_minibatch=128,
        init_sd=1e-3, num_epochs=101, log_every=50, seed=0)
    acc_h = res_h["accs"][-1]
    emit({"phase": "engine", "config": "halfmoon logreg psvi_learn_v M=30", "accs": res_h["accs"],
          "nlls": res_h["nlls"], "launches": launches_h, "seconds": secs_h})
    if not abs(acc_h - 0.797) <= 0.09:
        raise AssertionError(f"halfmoon logreg final accuracy {acc_h} outside 0.797 ± 0.09")
    # the regression main path: the run_psvi call of the regressor parity
    # study (sinus, regressor_net 1-40-1, 101 steps)
    reg_kw = dict(method="psvi_learn_v_regressor", architecture="regressor_net", n_hidden=40,
                  n_layers=1, num_pseudo=10, mc_samples=10, inner_it=10, data_minibatch=64,
                  tau=0.1, init_sd=1e-3, lr0u=1e-2, lr0v=1e-2, lr0z=1e-2, num_epochs=101,
                  log_every=25, seed=0)
    reg_only = only(nested_fwd_gaussian=101, nested_outer_gaussian=101,
                    nested_rev_gaussian=101)
    eng_r, res_r, launches_r, secs_r = run_engine(mods, make_psvi_engine, sinus, reg_only,
                                                  **reg_kw)
    rmse = res_r["rmses"][-1]
    emit({"phase": "engine", "config": "sinus regressor_net 1-40-1 psvi_learn_v_regressor M=10 "
          "S=10 T=10 B=64 tau=0.1", "rmses": res_r["rmses"], "lls": res_r["lls"],
          "launches": launches_r, "seconds": secs_r, "step_path": eng_r.step_path})
    if not all(math.isfinite(x) for x in res_r["rmses"] + res_r["lls"]):
        raise AssertionError("non-finite RMSE or LL on the regression path")
    if not rmse <= 0.30:
        raise AssertionError(f"sinus regressor final test RMSE {rmse} > 0.30")
    lenet_kw = dict(method="psvi_learn_v", architecture="lenet", num_pseudo=100, mc_samples=10,
                    inner_it=20, data_minibatch=256, init_sd=1e-3, num_epochs=31, log_every=10,
                    seed=0, fused_inner="auto")
    lenet_only = only(lenet_fwd=31, lenet_rev=31)
    eng_l, res_l, launches_l, secs_l = run_engine(mods, make_psvi_engine, mnist, lenet_only,
                                                  **lenet_kw)
    acc_l = res_l["accs"][-1]
    emit({"phase": "engine", "config": "synth_mnist lenet psvi_learn_v M=100 S=10 T=20 B=256",
          "accs": res_l["accs"], "nlls": res_l["nlls"], "launches": launches_l,
          "seconds": secs_l, "step_path": eng_l.step_path})
    if not acc_l >= 0.99:
        raise AssertionError(f"synth_mnist LeNet final accuracy {acc_l} < 0.99")
    # the first-order paths with backend="pallas": every batched dense
    # forward (training, retrain, evaluation) launches B3, no nested kernel
    lj_kw = {**lenet_kw, "trainer": "joint", "backend": "pallas"}
    del lj_kw["fused_inner"]
    n_lj = b3_expected(mnist, lj_kw, 1)
    eng_lj, res_lj, launches_lj, secs_lj = run_engine(mods, make_psvi_engine, mnist,
                                                      only(sampled_linear=n_lj), **lj_kw)
    shapes_lj = {f"{s}x{n}x{i}x{o}": c for (s, n, i, o), c in SL.LAUNCH_SHAPES.items()}
    acc_lj = res_lj["accs"][-1]
    emit({"phase": "engine", "config": "synth_mnist lenet psvi_learn_v M=100 S=10 B=256 joint "
          "backend=pallas", "accs": res_lj["accs"], "nlls": res_lj["nlls"],
          "launches": launches_lj, "b3_launches_by_shape": shapes_lj, "seconds": secs_lj,
          "step_path": eng_lj.step_path})
    if not all(math.isfinite(x) for x in res_lj["accs"] + res_lj["nlls"]):
        raise AssertionError("non-finite accuracy or NLL on the LeNet joint path")
    if not acc_lj >= 0.99:
        raise AssertionError(f"synth_mnist LeNet joint final accuracy {acc_lj} < 0.99")
    fb_kw = {**main_kw, "trainer": "alternating", "backend": "pallas",
             "retrain_on_coreset": True, "register_elbos": True}
    del fb_kw["fused_inner"]
    n_fb = b3_expected(blobs, fb_kw, 2, retrain=True)
    eng_fb, res_fb, launches_fb, secs_fb = run_engine(mods, make_psvi_engine, blobs,
                                                      only(sampled_linear=n_fb), **fb_kw)
    tags = sorted({t for t, _ in res_fb["elbos"]})
    n_eval = len(res_fb["accs"]) // 2
    emit({"phase": "engine", "config": "four_blobs fn 2-40-4 psvi_learn_v M=48 alternating "
          "backend=pallas retrain_on_coreset register_elbos", "accs": res_fb["accs"],
          "nlls": res_fb["nlls"], "launches": launches_fb, "elbos": len(res_fb["elbos"]),
          "elbo_tags": tags, "seconds": secs_fb, "step_path": eng_fb.step_path})
    if not all(math.isfinite(x) for x in res_fb["accs"] + res_fb["nlls"]):
        raise AssertionError("non-finite accuracy or NLL on the four_blobs alternating path")
    for what, acc_fb in (("training", res_fb["accs"][n_eval - 1]), ("retrain", res_fb["accs"][-1])):
        if not acc_fb >= 0.85:
            raise AssertionError(f"four_blobs alternating {what} final accuracy {acc_fb} < 0.85")
    if len(res_fb["elbos"]) != 2 * fb_kw["num_epochs"] or tags != [0, 1]:
        raise AssertionError(f"elbos: {len(res_fb['elbos'])} entries with tags {tags}")

    # 4b. the remaining methods and trainers, which no kernel serves
    method_engines = check_methods(mods, make_psvi_engine, blobs, mnist, only)

    # 4c. the coreset lifecycle, through the same kernels at shapes that
    # change mid-run
    check_lifecycle(mods, make_psvi_engine, blobs, halfmoon, mnist, only, lenet_kw, card)

    # 4d. the engine options and the data readers
    check_options(mods, make_psvi_engine, read_dataset,
                  {"four_blobs": blobs, "halfmoon": halfmoon, "synth_mnist": mnist,
                   "sinus": sinus}, only, reg_kw, card, dev)

    # 4e. the model zoo: AlexNet and ResNet-18 on synth_cifar, the
    # full-covariance nets, B3 at the zoo's dense heads
    zoo_engines, zoo_shapes = check_zoo(mods, make_psvi_engine, read_dataset, halfmoon, only,
                                        card, SL)

    # 4f. the baselines and coreset selection; init_args='custom' into B1 and B2
    check_baselines(mods, make_psvi_engine, read_dataset, read_regression_dataset, only, card)

    # 4g. parallelism and the CLI: the trial runner, the sharded engine on
    # two ranks, streamed batches through B1, python -m psvi_torch.experiments
    check_parallel(mods, make_psvi_engine, read_dataset, only, card, dev)

    # 5. times at the main paths' shapes (four_blobs fn 2-40-4, M=48; sinus
    # regressor 1-40-1, M=10, B=64; LeNet flagship)
    cfg = main_cfg(FN, blobs, [2, 40, 4], 48, True, False)
    rcfg = main_cfg(FN, sinus, [1, 40, 1], 10, True, False, B=64, tau=0.1)
    lcfg = lenet_cfg(FL, mnist, 10, 100, 20, True, False)
    la = lenet_inputs(FL, lcfg, mnist, 7, dev)
    _, lh, _ = FL.lenet_fwd_torch(la["p0"], la["u"], la["z"], la["v"], la["alpha"], la["e_in"],
                                  la["lr"], lcfg)
    largs = (la["u"], la["z"], la["v"], la["alpha"], la["e_in"], la["lr"], lcfg)
    lcalls = {
        "lenet_fwd": (lambda: FL._lenet_fwd_cuda(la["p0"], *largs),
                      lambda: FL.lenet_fwd_torch(la["p0"], *largs)),
        "lenet_rev": (lambda: FL._lenet_rev_cuda(lh, la["pbar"], la["dlosses"], *largs),
                      lambda: FL.lenet_rev_torch(lh, la["pbar"], la["dlosses"], *largs)),
    }
    lops, lbyts = lenet_work(lcfg)
    with torch.no_grad():
        kernels = []
        for c, data, runs in ((cfg, blobs, launches), (rcfg, sinus, launches_r)):
            ops, byts = work(c)
            plans = nested_plans(FN, c)
            # the median of single calls, and 50 calls queued behind a device
            # sleep (a call's host cost, about its device time, stays out)
            kernels += [timed_kernel(branch(c, name), kern, plain, ops[name], byts[name], runs,
                                     chk, SOURCE, TPU_KERNEL, 60, queued_ms=queued_ms(kern)[0],
                                     **({"plan": plans[name]} if name in plans else {}))
                        for name, (kern, plain) in dense_calls(
                            FN, c, kernel_inputs(FN, c, data.x, data.y, 1, dev)).items()]
        kernels += [timed_kernel(name, kern, plain, lops[name], lbyts[name], launches_l, chk,
                                 LENET_SOURCE, LENET_REPLACES[name], 10)
                    for name, (kern, plain) in lcalls.items()]
        # B3 at the LeNet fc shapes and at B4's 400→120, N = 1024: the
        # kernel, its plain version and one cuBLAS product on pre-sampled
        # weights (sampling excluded)
        b3_ms = {}
        for label, S, N, Din, Dout in SL_SHAPES[:3] + [SLP_SHAPES[4]]:
            a = sl_inputs(S, N, Din, Dout, 200, dev)
            w_t = (a[1][None] + softplus(a[2])[None] * a[5]).transpose(1, 2)
            b = (a[3][None] + softplus(a[4])[None] * a[6])[:, None, :]
            kernels.append(queued_row(
                f"sampled_linear_{label}", SL_SOURCE, SL_REPLACES,
                lambda: SL._sampled_linear_cuda(*a), lambda: SL.sampled_linear_reference(*a),
                lambda: torch.baddbmm(b, a[0], w_t), *sl_work(S, N, Din, Dout),
                shapes_lj.get(f"{S}x{N}x{Din}x{Dout}", 0), chk, "sampled_linear",
                library="torch.baddbmm on pre-sampled W (cuBLAS product only, sampling "
                        "excluded)",
                shape=f"S={S} N={N} {Din}->{Dout}", launches_of="LeNet joint run",
                n_splits=SL._fwd_plan(S, N, Din, Dout),
                per_call_ms=median_ms(lambda: SL._sampled_linear_cuda(*a))))
        # B3 at the zoo's dense heads (AlexNet's three, ResNet-18's one)
        for label, S, N, Din, Dout in ZOO_SL_SHAPES:
            a = sl_inputs(S, N, Din, Dout, 200, dev)
            w_t = (a[1][None] + softplus(a[2])[None] * a[5]).transpose(1, 2)
            b = (a[3][None] + softplus(a[4])[None] * a[6])[:, None, :]
            kernels.append(queued_row(
                f"sampled_linear_{label}", SL_SOURCE, SL_REPLACES,
                lambda: SL._sampled_linear_cuda(*a), lambda: SL.sampled_linear_reference(*a),
                lambda: torch.baddbmm(b, a[0], w_t), *sl_work(S, N, Din, Dout),
                zoo_shapes.get((S, N, Din, Dout), 0), chk, "sampled_linear",
                library="torch.baddbmm on pre-sampled W (cuBLAS product only, sampling "
                        "excluded)",
                shape=f"S={S} N={N} {Din}->{Dout}",
                launches_of=f"{label.split()[0]} joint run (backend=pallas)",
                n_splits=SL._fwd_plan(S, N, Din, Dout),
                per_call_ms=median_ms(lambda: SL._sampled_linear_cuda(*a))))
        # B4a-c at the fc shapes and the docstring's N = 1024: each beside its
        # plain version, one cuBLAS product on pre-sampled weights (sampling
        # excluded) and, for the forward, B3 reading the same amount of ε
        b4_of = "composed 400-120-84-10 step (one launch at each fc shape)"
        libs = {"prng_fwd": "torch.baddbmm on pre-sampled W", "prng_dx": "torch.bmm(g, W)",
                "prng_dparam": "torch.bmm(g^T, x)"}
        plans = {"prng_fwd": SLP._fwd_plan, "prng_dx": SLP._dx_plan,
                 "prng_dparam": SLP._dparam_plan}
        for label, S, N, Din, Dout in SLP_SHAPES[:3] + [SLP_SHAPES[4]]:
            a = sl_inputs(S, N, Din, Dout, 300, dev)
            g = torch.randn((S, N, Dout), generator=torch.Generator(dev).manual_seed(3),
                            device=dev)
            w = a[1][None] + softplus(a[2])[None] * a[5]
            b = (a[3][None] + softplus(a[4])[None] * a[6])[:, None, :]
            lib = {"prng_fwd": lambda: torch.baddbmm(b, a[0], w.transpose(1, 2)),
                   "prng_dx": lambda: torch.bmm(g, w),
                   "prng_dparam": lambda: torch.bmm(g.transpose(1, 2), a[0])}
            b3_ms[label] = queued_ms(lambda: SL._sampled_linear_cuda(*a))[0]
            for name, (kern, plain) in slp_calls(SLP, a[:5], g, 300).items():
                extra = {"n_splits": plans[name](S, N, Din, Dout),
                         **({"b3_ms": b3_ms[label]} if name == "prng_fwd" else {})}
                kernels.append(queued_row(
                    f"{name}_{label}", SLP_SOURCE, SLP_REPLACES[name], kern, plain, lib[name],
                    *slp_work(name, S, N, Din, Dout), launches_b4[name], chk, name,
                    library=libs[name] + " (cuBLAS product only, sampling excluded)",
                    shape=f"S={S} N={N} {Din}->{Dout}", launches_of=b4_of, **extra))
        for label, S, Din, Dout in NKL_SHAPES:
            p = sl_inputs(1, 1, Din, Dout, 301, dev)[1:5]
            kernels.append(queued_row(
                f"prng_nkl_{label}", SLP_SOURCE, SLP_REPLACES["prng_nkl"],
                *nkl_call(SLP, p, 301, S), None, *slp_work("prng_nkl", S, 1, Din, Dout),
                launches_b4["prng_nkl"], chk, "prng_nkl", library=None,
                shape=f"S={S} {Din}->{Dout}", launches_of=b4_of,
                plan=nkl_plan(SLP, S, Din, Dout)))
    # whole engine steps on the same card: fused kernels vs plain autograd
    steps = {}
    for key, e, data, kw in (("nested", eng, blobs, main_kw), ("regressor", eng_r, sinus, reg_kw)):
        batch = e._sample_batch()
        e_plain = make_psvi_engine(data, **{**kw, "fused_inner": False})
        st_f, st_p = e.state, e_plain.state
        steps[f"{key}_step_fused_ms"] = median_ms(lambda: e._nested_step_fused(st_f, batch),
                                                  reps=50)
        steps[f"{key}_step_plain_autograd_ms"] = median_ms(
            lambda: e_plain._nested_step(st_p, batch), reps=50)
    # each methods run's step at the dense flagship, beside the fused
    # nested step above (the same config and batch); the LeNet-width hyper
    # and truncated steps
    batch = eng._sample_batch()
    methods_ms = {}
    for label, e in method_engines.items():
        st, b = e.state, (batch if not label.startswith("lenet") else e._sample_batch())
        # the runs above warmed each step up; the hyper steps take seconds
        reps = 2 if e.trainer == "hyper" else 5
        fn = getattr(e, e.step_path)  # the step itself, not run_engine's recorder
        methods_ms[label] = median_ms(lambda: fn(st, batch=b), reps=reps, warmup=0)
    batch_l = eng_l._sample_batch()
    eng_lp = PSVI(mnist, **{**lenet_kw, "fused_inner": False})
    st_lf, st_lp = eng_l.state, eng_lp.state
    lenet_fused_ms = median_ms(lambda: eng_l._nested_step_fused_lenet(st_lf, batch_l), reps=10,
                               warmup=2)
    lenet_plain_ms = median_ms(lambda: eng_lp._nested_step(st_lp, batch_l), reps=3, warmup=1)
    # the first-order LeNet steps, backend "pallas" (B3) against "xla", in
    # turns (xla, pallas, pallas, xla) on the same batch and state
    fo = {}
    for trainer in ("joint", "alternating"):
        kw = {**lenet_kw, "trainer": trainer}
        del kw["fused_inner"]
        es = {b: PSVI(mnist, **{**kw, "backend": b}) for b in ("xla", "pallas")}
        fns = {b: getattr(e, f"_{trainer}_step") for b, e in es.items()}
        runs = {b: [] for b in es}
        for b in ("xla", "pallas", "pallas", "xla"):
            st = es[b].state
            runs[b].append(median_ms(lambda: fns[b](st, batch_l), reps=20, warmup=3))
        fo[f"lenet_{trainer}_step_ms"] = runs
    emit({"phase": "times", "card": card,
          "config": {"dense": "four_blobs fn 2-40-4 M=48 S=10 T=10 B=128",
                     "regressor": "sinus regressor_net 1-40-1 M=10 S=10 T=10 B=64 tau=0.1",
                     "lenet": "synth_mnist LeNet M=100 S=10 T=20 B=256"},
          "kernel_ms": {k["name"]: k["ms"] for k in kernels},
          "plain_ms": {k["name"]: k["plain_ms"] for k in kernels},
          "bound_ms": {k["name"]: k["bound_ms"] for k in kernels},
          **steps, "methods_step_ms": methods_ms, "lenet_step_fused_ms": lenet_fused_ms,
          "lenet_step_plain_autograd_ms": lenet_plain_ms, **fo})
    # where the LeNet time goes, by kernel (torch.profiler)
    with torch.no_grad():
        prof = profile_calls({name: kern for name, (kern, _) in lcalls.items()})
    prof.update(profile_calls(
        {"lenet_step_fused": lambda: eng_l._nested_step_fused_lenet(st_lf, batch_l)}))
    # B4c, B4b, B4a and B3 at fc1: the split of dparam's call between its
    # two passes, and each kernel's device time. 20 calls a window: the
    # profiler has seen no device time in a window of one 35 µs call
    _, S, N, Din, Dout = SLP_SHAPES[0]
    a = sl_inputs(S, N, Din, Dout, 300, dev)
    g = torch.randn((S, N, Dout), generator=torch.Generator(dev).manual_seed(3), device=dev)
    fc1 = {name: kern for name, (kern, _) in slp_calls(SLP, a[:5], g, 300).items()}
    fc1["sampled_linear"] = lambda: SL._sampled_linear_cuda(*a)
    with torch.no_grad():
        prof.update(profile_calls({
            f"{name}_fc1_x20": lambda f=fc1[name]: [f() for _ in range(20)]
            for name in ("prng_dparam", "prng_dx", "prng_fwd", "sampled_linear")}))
    # one LeNet joint step with each backend: B3's share and the busy share
    eng_jx = PSVI(mnist, **{**lj_kw, "backend": "xla"})
    st_jp, st_jx = eng_lj.state, eng_jx.state
    prof.update(profile_calls({
        "lenet_joint_step_pallas": lambda: eng_lj._joint_step(st_jp, batch_l),
        "lenet_joint_step_xla": lambda: eng_jx._joint_step(st_jx, batch_l)},
        sums={"b3_ms": "sampled_linear"}))
    for backend in ("pallas", "xla"):
        p = prof[f"lenet_joint_step_{backend}"]
        if p["device_ms"]:
            # the profiler's own host cost lengthens the profiled wall, so
            # also against the step's unprofiled median (times phase)
            p["busy_share"] = p["device_ms"] / p["wall_ms_profiled"]
            p["busy_share_of_step"] = p["device_ms"] / float(
                np.median(fo["lenet_joint_step_ms"][backend]))
    emit({"phase": "profile", "card": card, "config": "synth_mnist LeNet M=100 S=10 T=20 B=256",
          **prof})
    # the zoo's nested steps: device time by kernel and the busy share
    zprof = {}
    for label, eng in zoo_engines.items():
        if not label.startswith("synth_cifar"):
            continue
        step, st, zb = getattr(eng, eng.step_path), eng.state, eng._sample_batch()
        p = profile_calls({label: lambda: step(st, zb)})[label]
        if p["device_ms"]:
            p["busy_share"] = p["device_ms"] / p["wall_ms_profiled"]
            p["busy_share_of_step"] = p["device_ms"] / eng.step_ms
        p["step_ms_unprofiled"] = eng.step_ms
        zprof[label] = p
    emit({"phase": "profile", "card": card, "config": "zoo nested steps", **zprof})

    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
