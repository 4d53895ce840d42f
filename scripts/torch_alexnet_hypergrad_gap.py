"""Where the float32 hypergradient of the AlexNet nested step leaves
float64's, at the ``alexnet_cifar10`` configuration's sizes (S=10, T=20,
M=100, B=256).

    python3 scripts/torch_alexnet_hypergrad_gap.py --seeds <n> ... [--out FILE]

On a CUDA card. For each seed, from the start ``portbench``'s
``make_inputs`` makes for the configuration under the ``m100_log10`` mix,
and its first checked step's minibatch and noise:

- the plain reference (``portbench/reference/alexnet.py``) makes the step
  in float64, in float32 (TF32 off), and in float64 from a start whose net
  leaves are moved by one float32 ulp at most (each entry times
  1 + 2^-24·r, r uniform in [-1, 1], from the seed), with the inner Adam's
  ε at each value of ``--eps`` (1e-8 is the engine's);
- the same float64 step with each inner iteration's gradient rounded to
  float32 before Adam takes it (``rounded``; the reverse passes the
  rounding by unchanged);
- the same float64 step held to float32's path (``f32_path``): each Adam
  step's gradient and its new parameters and moments take the values the
  float32 step had there, while the reverse through them runs in float64;
  so float32's forward with a float64 reverse; and with only the gradients
  taken from float32 (``f32_grads``), at every iteration or at the first
  (``f32_grads_t1``);
- each of these hypergradients of u and v against float64's at the same ε
  (cosine and the gap of norms);
- the program's own first step (``PSVI._nested_step`` through the
  benchmark's set-up), its u and v hypergradients read from the hyper-Adam's
  first moments, against float64's at ε = 1e-8;
- the first inner gradient's entries by size (float64), and how many
  change sign between float32 and float64.

At t = 1 the inner Adam step is −lr·g/(|g| + ε), whose derivative in g is
lr·ε/(|g| + ε)²: 1/ε = 1e8 where |g| ≪ ε. The unroll's reverse passes
through it, so an entry's float32 rounding reaches the hypergradient
magnified where its inner gradient is small. If the gap were only that,
it would shrink as ε grows; if it comes from the rounding of the inner
gradients, ``rounded`` lies as far from float64 as float32 does; if from
the forward's rounding, ``f32_path`` does; if from the reverse's,
``f32_path`` lies near float64. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench.reference import common as R  # noqa: E402


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _gap(a, b):
    return float(abs(a.double().norm() - b.double().norm()) / b.double().norm())


EPSILONS = (1e-8, 1e-6, 1e-5, 1e-4, 1e-3)
HELD = {"name": "alexnet_cifar", "config": "alexnet_cifar10", "traffic": "m100_log10", "chips": 1}


def _moved(layers, seed):
    """Each net leaf's entries times 1 + 2^-24·r, r uniform in [-1, 1]."""
    g = torch.Generator(device=layers[0][R.KEYS[0]].device).manual_seed(seed)
    return [{k: x * (1 + 2.0**-24 * (2 * torch.rand(x.shape, generator=g, device=x.device,
                                                     dtype=x.dtype) - 1))
             for k, x in layer.items()} for layer in layers]


class _RoundedGradient:
    """Inside the block, the reference's Adam takes its gradient rounded
    to float32, and passes the reverse through the rounding unchanged."""

    def __enter__(self):
        self.adam = R.adam

        def adam(p, m, n, g, t, lr, hp):
            g = g + (g.float().double() - g).detach()
            return self.adam(p, m, n, g, t, lr, hp)

        R.adam = adam

    def __exit__(self, *exc):
        R.adam = self.adam


class _Path:
    """Inside the block, the reference's Adam steps are recorded (no
    ``steps`` given) or take the recorded values in order, the reverse
    passing through as if they were its own: the gradient and the outputs,
    or the gradient alone (``grads_only``), at iterations up to ``last``."""

    def __init__(self, steps=None, grads_only=False, last=None):
        self.steps = [] if steps is None else list(steps)
        self.take = steps is not None
        self.grads_only, self.last = grads_only, last

    def __enter__(self):
        self.adam = R.adam
        it = iter(self.steps)

        def adam(p, m, n, g, t, lr, hp):
            if not self.take:
                out = self.adam(p, m, n, g, t, lr, hp)
                self.steps.append(tuple(x.detach() for x in (g,) + out))
                return out
            rec = next(it)
            if self.last is not None and t > self.last:
                return self.adam(p, m, n, g, t, lr, hp)
            rec = [x.to(g.dtype) for x in rec]
            g = g + (rec[0] - g).detach()
            out = self.adam(p, m, n, g, t, lr, hp)
            if self.grads_only:
                return out
            return tuple(x + (r - x).detach() for x, r in zip(out, rec[1:]))

        R.adam = adam
        return self

    def __exit__(self, *exc):
        R.adam = self.adam


def _reference(cell, inputs, dtype, adam_eps, move_seed=None, rounded=False, path=None):
    if rounded:
        with _RoundedGradient():
            return _reference(cell, inputs, dtype, adam_eps, move_seed)
    if path is not None:
        with path:
            return _reference(cell, inputs, dtype, adam_eps, move_seed)
    model, hp = H._reference_parts(cell, inputs)
    cast = H._widen if dtype == torch.float64 else (lambda x: x)
    b = cast(H._first_state(inputs))
    if move_seed is not None:
        b["layers"] = _moved(b["layers"], move_seed)
    (xb, yb), (e_in, e_out) = cast((inputs.batches[0], inputs.eps[0]))
    t0 = time.perf_counter()
    with H._TF32(False):
        rec = R.nested_step(model, b["layers"], b["u"], cast(inputs.z0), b["v"],
                            R.HyperAdam(*b["opt_u"]), R.HyperAdam(*b["opt_v"]), xb, yb, e_in,
                            e_out, hp._replace(adam_eps=adam_eps))[-1]
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--eps", type=float, nargs="+", default=list(EPSILONS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    man = H.load_json(H.ROOT / "BENCHMARK.json")
    man["workloads"].append(HELD)  # the cell is held out of the benchmark (PERF.md §4)
    cell = H.load_cell(HELD["name"], man)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in args.seeds:
        inputs = H.make_inputs(cell, seed, dev)
        eng, probe = H.set_up(cell, inputs, seed, dev)
        st = probe.records[0][0]
        # the first step's moment from zero: m = (1 − β₁)·g
        program = {h: getattr(st, f"opt_{h}")[1].double() / (1 - check.B1) for h in ("u", "v")}
        del eng, probe, st
        gc.collect()
        torch.cuda.empty_cache()
        for adam_eps in args.eps:
            r64 = _reference(cell, inputs, torch.float64, adam_eps)
            rec = _Path()
            r32 = _reference(cell, inputs, torch.float32, adam_eps, path=rec)
            sides = {"": r32,
                     "f32_path_": _reference(cell, inputs, torch.float64, adam_eps,
                                             path=_Path(rec.steps)),
                     "moved_": _reference(cell, inputs, torch.float64, adam_eps, move_seed=seed),
                     "f32_grads_": _reference(cell, inputs, torch.float64, adam_eps,
                                              path=_Path(rec.steps, grads_only=True)),
                     "f32_grads_t1_": _reference(cell, inputs, torch.float64, adam_eps,
                                                 path=_Path(rec.steps, grads_only=True, last=1)),
                     "rounded_": _reference(cell, inputs, torch.float64, adam_eps, rounded=True)}
            row = {"seed": seed, "adam_eps": adam_eps, "f64_s": r64["seconds"],
                   "f32_s": r32["seconds"]}
            for h in ("u", "v"):
                for name, r in sides.items():
                    row[f"{name}g_{h}_cos"] = _cos(r[f"g_{h}"], r64[f"g_{h}"])
                    row[f"{name}g_{h}_norm_gap"] = _gap(r[f"g_{h}"], r64[f"g_{h}"])
                row[f"f32_to_f32_path_g_{h}_cos"] = _cos(r32[f"g_{h}"],
                                                         sides["f32_path_"][f"g_{h}"])
            if adam_eps == 1e-8:
                for h in ("u", "v"):
                    row[f"program_g_{h}_cos"] = _cos(program[h], r64[f"g_{h}"])
                    row[f"program_g_{h}_norm_gap"] = _gap(program[h], r64[f"g_{h}"])
                sizes = {}
                for i, (g32, g64) in enumerate(zip(r32["g_net"], r64["g_net"])):
                    a = g64.abs()
                    sizes[f"leaf{i}"] = {
                        "n": a.numel(), "under_1e-8": int((a < 1e-8).sum()),
                        "under_1e-6": int((a < 1e-6).sum()), "under_1e-4": int((a < 1e-4).sum()),
                        "sign_flips": int((torch.sign(g32.double()) != torch.sign(g64)).sum())}
                row["first_inner_gradient"] = sizes
            emit(row)
            del r32, r64, sides, rec
            torch.cuda.empty_cache()
        del inputs
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
