"""AlexNet and ResNet-18 of the port at their full widths against the JAX
package: the forward at S = 2 on two 3×32×32 inputs, the KL and the NKL,
from JAX's initial parameters and noise (``params_from_jax``). Tolerances
of ``test_torch_model_zoo.net_pair_check``: the forward within 1e-5·max
|ref|, KL and NKL within 2e-5 (fp32 sums over up to 11M terms in another
order)."""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np

from psvi_torch.models import networks as TN
from psvi_tpu.models import networks as JN
from test_torch_model_zoo import net_pair_check


def _x():
    return np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)


def test_alexnet_full_width_matches_jax():
    tp, _ = net_pair_check(JN.make_alexnet(init_sd=1e-3, prior_sd=0.5),
                           TN.make_alexnet(init_sd=1e-3, prior_sd=0.5), _x())
    net = TN.make_alexnet(init_sd=1e-3, prior_sd=0.5)
    # JAX's quirk: the convs keep the default init_sd and prior_sd, the last
    # dense layer the default init_sd
    assert (net.layers[0].init_sd, net.layers[0].prior_sd) == (0.01, 1.0)
    assert (net.layers[4].init_sd, net.layers[4].prior_sd) == (0.01, 1.0)
    assert (net.layers[9].init_sd, net.layers[9].prior_sd) == (1e-3, 0.5)
    assert (net.layers[-1].init_sd, net.layers[-1].prior_sd) == (0.01, 0.5)
    assert [tuple(tp[i]["mu_w"].shape) for i in (9, 11, 13)] == [(384, 4096), (192, 384),
                                                                  (10, 192)]


def test_resnet18_full_width_matches_jax():
    tp, jp = net_pair_check(JN.make_resnet("resnet18"), TN.make_resnet("resnet18"), _x())
    assert tuple(tp[-1]["mu_w"].shape) == (10, 512)
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(tp))
            == sum(a.size for a in jax.tree_util.tree_leaves(jp)))
