"""psvi_torch — black-box coreset variational inference on PyTorch and CUDA.

The PyTorch port of ``psvi_tpu`` (PSVI; Manousakas, Ritter, Karaletsos,
NeurIPS 2022) for an NVIDIA H100. It mirrors the JAX package's file and
class names so each counterpart is easy to find; inside it uses PyTorch
idiom: ``nn.Module`` layers that hold their configuration, functional
``apply(params, eps, x)`` methods for the differentiable inner unroll, and
hand-written CUDA kernels behind plain-PyTorch twins.

Entry points take ``device=None``, which means CUDA; without a GPU they
raise. Pass ``device="cpu"`` to run the plain PyTorch path on the CPU.

Layout:
  device.py   device resolution, the fp32 and determinism policy
  data/       every dataset reader of the JAX package (generated,
              scikit-learn's, file-gated)
  models/     mean-field variational layers, the network constructors, packed nets,
              Bayesian and frequentist logistic regression
  ops/        ELBOs, the differentiable optimizers, hypergradient solvers,
              the hand-written CUDA kernels and their plain versions,
              k-means on the device, NUTS
  native/     the C++ k-means, built by g++ at first use
  inference/  the PSVI engines (nested, joint, alternating and hyper
              trainers; the lifecycle; the engine options), the baselines,
              sparse black-box VI, coreset selection
  parallel/   the ('trial', 'data', 'mc') mesh over torch.distributed ranks,
              the process group and local launchers, trial-parallel runs
  experiments.py
              the CLI (python -m psvi_torch.experiments)
  utils/      the experiment config and method specs, per-trial generators,
              JAX-to-torch conversion, checkpoints, results, resource
              logging, the baselines' random draws
"""

from psvi_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
