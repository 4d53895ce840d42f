"""Device resolution, the float32 policy and the determinism policy.

``device=None`` means the CUDA card: the port has no CPU fallback. The CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.

Every product on the nested path runs in true float32: a single bf16 or
TF32 pass in the second-order terms collapses the u-hypergradient (the JAX
kernel measured cosine 0.29 against its oracle with one bf16 pass). So
:func:`resolve_device` turns TF32 off for both matmuls and cuDNN.

One exception, and only one: the forward kernels of the first-order dense
op, B3 (``ops/csrc/sampled_linear.cu``) and B4a
(``ops/csrc/sampled_linear_prng.cu``), run their product as corrected
3xTF32 on the tensor cores (``ops/csrc/sampled_linear_gemm.cuh``): each
operand split into two TF32 parts, three passes, fp32 accumulation. It
holds their gate of 1e-5·max|ref| against the plain fp32 version, which a
single TF32 pass does not. Both ops are ``once_differentiable``, so no
second-order term passes through them; no kernel of the nested path (B1,
B2) uses TF32.

Under ``compute_dtype="bfloat16"`` the layers' products take bf16 operands
(JAX's contract: bf16 products accumulated in float32). cuBLAS may reduce a
bf16 GEMM in reduced precision unless told not to, so the policy also turns
``allow_bf16_reduced_precision_reduction`` off.

Every kernel of the port sums in a fixed order, so a rerun is bitwise; so
is a resumed run (``PSVI.load_checkpoint``). The one library call on a
step's path that is not, by default, is cuDNN's backward of a
convolution: the LeNet outer IW-ELBO's gradient through conv2 then
differs in the last bits from run to run. So :func:`resolve_device` also
asks cuDNN for its deterministic algorithms (on the H100 the LeNet step
took the same time both ways; PERF.md §6).
"""

from __future__ import annotations

import torch


def fp32_exact():
    """Disable TF32 for CUDA matmuls and cuDNN convolutions and reduced-
    precision bf16 reductions, and take cuDNN's deterministic algorithms
    (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a GPU); otherwise the given device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "psvi_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    if dev.type == "cuda":
        fp32_exact()
    return dev
