"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points default to CUDA and raise without it."""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset, read_regression_dataset
from psvi_torch.device import resolve_device
from psvi_torch.inference.psvi import PSVI, make_psvi_engine, run_psvi
from psvi_torch.ops import fused_nested as FN
from psvi_torch.utils.convert import params_from_jax, state_from_jax

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import psvi_torch
for m in pkgutil.walk_packages(psvi_torch.__path__, "psvi_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "psvi_tpu"))
assert not bad, bad
print("ok", len([k for k in sys.modules if k.startswith("psvi_torch")]))
"""


def test_import_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "psvi_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_statement(path):
    text = (REPO / path).read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|psvi_tpu)\b", re.M)
    assert not pat.search(text)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = read_dataset("halfmoon")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PSVI(data, num_pseudo=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_psvi_engine(data, num_pseudo=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_psvi(data, num_pseudo=4, num_epochs=1)
    sinus = read_regression_dataset("sinus")
    for method in ("psvi_regressor", "psvi_learn_v_regressor", "psvi_alpha_v_regressor"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_psvi_engine(sinus, method=method, architecture="regressor_net", num_pseudo=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_psvi(sinus, method="psvi_learn_v_regressor", architecture="regressor_net",
                 num_pseudo=4, num_epochs=1)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    # the converters that carry JAX's numbers across
    tree = {"mu_w": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(tree)
    assert params_from_jax(tree, device="cpu")["mu_w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax(None)


def test_cuda_backend_refuses_cpu_tensors():
    cfg = FN.FusedCfg(T=1, S=2, widths=(2, 2), M=3, B=4, N=10.0, parameterised=True,
                      use_alpha=False, prior_sd=1.0)
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        FN.fused_nested_flat(z(cfg.n_params), z(3, 2), z(3), z(1), z(3), z(4, 2), z(4),
                             z(1, cfg.n_eps), z(cfg.n_eps), 1e-3, cfg, backend="cuda")


def _wrapper_args(cfg, bad):
    """Arguments of each CUDA wrapper at cfg's shapes, with ``bad`` given
    one row too many."""
    M, B, D, P, E, T = cfg.M, cfg.B, cfg.D, cfg.n_params, cfg.n_eps, cfg.T
    f = lambda name, *shape: torch.zeros(  # noqa: E731
        (shape[0] + (name == bad),) + shape[1:])
    i = lambda name, n: torch.zeros(n + (name == bad), dtype=torch.int32)  # noqa: E731
    inner = (f("u", M, D), i("y", M), f("v", M), f("alpha", 1), f("eps_in", T, E))
    return {
        FN._nested_fwd_cuda: (f("p0", P),) + inner + (1e-3, cfg),
        FN._nested_outer_cuda: (f("pT", P), f("u", M, D), i("y", M), f("cw", M),
                                f("xb", B, D), i("yb", B), f("eps_out", E), cfg),
        FN._nested_rev_cuda: (f("hist", T + 1, 3, P), f("pbar", P), f("ubar", M, D),
                              f("cwbar", M), f("zbar", M), inner[0], inner[1], f("cw", M),
                              inner[2], inner[3], inner[4], 1e-3, cfg),
    }


@pytest.mark.parametrize("bad", ["p0", "pT", "hist", "u", "y", "yb", "xb", "eps_in",
                                 "eps_out", "cwbar", "zbar"])
def test_cuda_wrappers_validate_shapes(bad):
    """The wrappers check every extent the kernel reads before any pointer
    is passed; a correct CPU call gets as far as the device check."""
    cfg = FN.FusedCfg(T=2, S=2, widths=(3, 5, 2), M=4, B=6, N=10.0, parameterised=True,
                      use_alpha=False, prior_sd=1.0)
    for fn, args in _wrapper_args(cfg, bad).items():
        takes = any(t.shape != g.shape for t, g in zip(
            args, _wrapper_args(cfg, None)[fn]) if isinstance(t, torch.Tensor))
        match = f"{bad}: expected shape" if takes else "one CUDA device"
        with pytest.raises(ValueError, match=match):
            fn(*args)


@pytest.mark.parametrize("dtype,match", [(torch.int32, "y: expected torch.float32"),
                                         (torch.float32, "one CUDA device")])
def test_gaussian_wrappers_take_real_targets(dtype, match):
    """The Gaussian branch reads float32 targets where the categorical one
    reads int32 labels."""
    cfg = FN.FusedCfg(T=2, S=2, widths=(1, 5, 1), M=4, B=6, N=10.0, parameterised=True,
                      use_alpha=False, prior_sd=1.0, likelihood="gaussian", tau=0.5,
                      learn_z=True)
    z = torch.zeros
    with pytest.raises(ValueError, match=match):
        FN._nested_fwd_cuda(z(cfg.n_params), z(4, 1), z(4, dtype=dtype), z(4), z(1),
                            z(2, cfg.n_eps), 1e-3, cfg)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA card (as here) the smoke script exits non-zero and
    prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
