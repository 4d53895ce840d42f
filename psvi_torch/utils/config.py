"""Method specifications: the PSVI subclass lattice as static flags.

A copy of ``psvi_tpu/utils/config.py``'s ``MethodSpec`` and
``METHOD_SPECS`` (ref ``psvi/inference/psvi_classes.py:1344-1934``); the
port keeps its own so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses


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
