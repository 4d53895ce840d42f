"""Operations and bytes of the AlexNet nested step, counted from the
configuration's shapes (a configuration names this counter by
``"work": "alexnet_cifar10"``).

The step: T inner Adam iterations on the M pseudo points, each a forward
and the parameters' gradient with its graph kept, then the outer IW-ELBO
over the M + B points and its gradient with respect to u and v through
the whole unroll. S weight samples run together, so a pass of a layer over
n image-samples costs that layer's multiply-adds per image times n, and a
multiply-add counts 2.

How many passes each layer makes was counted once, by recording every
convolution and batched product of one ``PSVI._nested_step`` of the plain
engine on the CPU (``aten.convolution``, ``aten.convolution_backward``
with each of its gradients a pass, ``aten.bmm``) at S × T × M × B = 2×2×4×8,
2×3×4×8, 3×2×4×8, 2×2×6×8 and 2×2×4×12, and solving for the integer
multipliers; every one of the five counts is met exactly:

- conv2, the grouped convolution over the S samples (cuDNN): S·M·(9T − 1)
  + 3·S·(M + B) passes: per inner iteration the forward, its data and
  weight gradients, and in the outer reverse their second-order terms and
  the forward's reverse again (one pass fewer at one iteration); the outer
  stage's forward, data and weight gradients;
- conv1, the im2col product of the unbatched input (cuBLAS): S·M·(6T − 1)
  + 3·S·(M + B) passes (the inner gradient does not reach the input);
- the dense layers: S·M·(9T − 2) + 3·S·(M + B) passes of fc1 → fc2 → fc3.

``portbench/tests/test_portbench_alexnet.py`` counts the calls again at
other toy sizes and holds these formulas to them. ``step_ops`` counts all
three; the elementwise work (sampling, pools, ReLU, LRN, Adam, KL) is left
out, under 2 % of the step's operations at these widths, so
``step_mfu`` reads a little low and never high. ``conv_work`` counts
conv2 alone: conv1's products run on the same cuBLAS kernels as the dense
layers', so the trace cannot tell their time apart. It adds the
evaluation's conv2 forwards (S·(M + B) images a test batch, one
evaluation every ``log_every`` steps), whose kernels the traced window
holds too.

Bytes: each pass reads its inputs and writes its output once, fp32: the
images' input and output activations and the S samples' weights.

``CONV_KERNELS``: the device kernels that ran conv2's passes, by base name
(``portbench/trace.py::base_name``), as a trace of the cell on an H100
80GB HBM3 showed them (torch 2.11, CUDA 12.8, cuDNN 9.22 held to its
deterministic algorithms): cuDNN's implicit GEMMs, Winograd transforms and
layout transposes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

CONV_KERNELS: Tuple[str, ...] = (
    "implicit_convolve_sgemm",
    "genericTranspose_kernel",
    "sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_"
    "warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8_stage3_"
    "warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn",
    "winogradForwardData9x9_5x5",
    "winogradWgradDelta9x9_5x5",
    "winogradWgradOutput9x9_5x5",
)


# per layer (a, c): a·T + c passes over the S·M inner images, and 3 over the
# S·(M + B) outer images (the forward and the two gradients)
PASSES = {"conv1": (6, -1), "conv2": (9, -1), "fc": (9, -2)}
OUTER_PASSES = 3


@dataclasses.dataclass(frozen=True)
class AlexNetShape:
    """The step's sizes: T, S, M, B, the input's side H, the two convs'
    (in, out, k, pad) and the dense widths. Both convs keep their input's
    side ('same' padding); a 3/2 max-pool with padding 1 follows each."""

    T: int
    S: int
    M: int
    B: int
    H: int
    conv: Tuple[Tuple[int, int, int, int], ...]
    fc: Tuple[int, ...]

    def sides(self):
        """conv1's and conv2's side."""
        return self.H, _pooled(self.H)

    def units(self, layer: str):
        """Passes over the S·M inner and the S·(M + B) outer images."""
        a, c = PASSES[layer]
        return a * self.T + c, OUTER_PASSES

    def images(self, layer: str) -> int:
        inner, outer = self.units(layer)
        return self.S * self.M * inner + self.S * (self.M + self.B) * outer


def _pooled(h: int) -> int:
    return (h + 2 - 3) // 2 + 1


def shape(cell) -> AlexNetShape:
    """The step's sizes at a cell, from its configuration; a net of
    another topology raises."""
    e, net, data = cell.config["engine"], cell.config["net"], cell.config["data"]
    conv, fc = net.get("conv"), net.get("fc")
    if not conv or len(conv) != 2 or not fc or len(fc) != 4:
        raise ValueError("the alexnet work counter covers two convs and three dense layers")
    (c0, k1, q1, p1), (c1, k2, q2, p2) = conv
    H = data["side"]
    if (c0 != data["channels"] or c1 != k1 or (p1, p2) != ((q1 - 1) // 2, (q2 - 1) // 2)
            or fc[0] != k2 * _pooled(_pooled(H)) ** 2):
        raise ValueError(f"the alexnet work counter does not cover the net {net}")
    return AlexNetShape(T=e["inner_it"], S=e["mc_samples"], M=cell.mix["num_pseudo"],
                        B=e["data_minibatch"], H=H, conv=tuple(map(tuple, conv)),
                        fc=tuple(fc))


def _conv2(s: AlexNetShape, images: int, passes: int):
    """Operations and bytes of ``passes`` passes of conv2 over ``images``
    image-samples in all."""
    (cin, cout, k, _), side = s.conv[1], s.sides()[1]
    ops = 2 * cout * cin * k * k * side * side * images
    byts = 4 * ((cin + cout) * side * side * images + s.S * (cout * cin * k * k + cout) * passes)
    return ops, byts


def conv_work(cell):
    """Operations and bytes of the grouped convolution (conv2) a step: the
    step's passes, and the evaluation's forwards spread over the
    ``log_every`` steps that follow it:
    ``({"step": ops, "evaluation": ops}, {"step": bytes, "evaluation": bytes})``."""
    s = shape(cell)
    step = _conv2(s, s.images("conv2"), sum(s.units("conv2")))
    n_test = cell.config["data"]["nc"] * cell.config["data"]["n_test_per_class"]
    batches = -(-n_test // min(s.B, n_test))
    ev = _conv2(s, batches * s.S * (s.M + s.B), batches)
    every = cell.mix["log_every"]
    return ({"step": step[0], "evaluation": ev[0] / every},
            {"step": step[1], "evaluation": ev[1] / every})


def step_ops(cell) -> int:
    """Operations of one whole step: every convolution and batched product
    of the unroll, the outer IW-ELBO and their gradients."""
    s = shape(cell)
    total = 0
    for name, (cin, cout, k, _), side in zip(("conv1", "conv2"), s.conv, s.sides()):
        total += 2 * cout * cin * k * k * side * side * s.images(name)
    return total + 2 * sum(a * b for a, b in zip(s.fc, s.fc[1:])) * s.images("fc")
