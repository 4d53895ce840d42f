"""The benchmark of ``psvi_torch``: one cell's run, driven by data.

A cell of ``BENCHMARK.json`` names a configuration
(``portbench/configs/<config>.json``: the engine's settings, the data
generator, the net's shapes, the reference model) and a traffic mix
(``portbench/mixes/<traffic>.json``: the coreset size, the evaluation
cadence, the steps the check follows and the traced window). Each metric
is read by its own file, ``portbench/metrics/<metric>.py``, and each cell's
limits of the output check sit in ``portbench/limits/<cell>.json``. Adding
a cell, a configuration or a metric adds files and entries; no file here
names one.

A run:

1. set-up: the data from the seed on the host; the engine on the card; its
   starting net, coreset and weights replaced by the benchmark's own, drawn
   from the seed on the card; then ``run_psvi`` once, as users call it, for
   one evaluation and ``check_steps`` + 1 steps, the first ``check_steps``
   fed the benchmark's own minibatches and noise through the step's
   injection seam (``PSVI._step(state, batch=..., eps=...)``) and recorded;
   every shape of the window is then warm;
2. the window: ``run_psvi`` in blocks of ``log_every`` steps on the same
   engine (one evaluation, then the steps) until ``--seconds`` are up, as
   runs of ``run_steps`` steps, the published run length: each run starts
   from the state the set-up left, so every run does the same work. Each
   step is timed by CUDA events recorded as the harness enters and leaves
   ``PSVI._step`` (read after the window, no synchronise added);
3. with ``--trace 1``, then a window of ``trace_seconds`` under
   ``torch.profiler``, with the benchmark's spans around each step, each
   evaluation and each block;
4. the check: once the peak memory is read and the engine freed, the plain
   reference (``portbench/reference/``), in float64, makes one step from
   each state the program was in before a checked step, on the same
   minibatch and noise, and the numbers of ``portbench/check.py`` are held
   to the cell's limits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from portbench import check
from portbench.reference import common as R

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
SPANS = ("portbench.block", "portbench.step", "portbench.evaluate")
FORBIDDEN = ("jax", "jaxlib", "flax", "psvi_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(path: Path):
    """A module of the benchmark's folders by file path (metric names hold
    dots, so they are not import names)."""
    key = str(path)
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(f"portbench_file_{len(_MODULES)}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # a dataclass looks its module up there
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    limits: Optional[dict]


def _reports(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(workload: str, manifest: Optional[dict] = None) -> Cell:
    man = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    w = next((w for w in man["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, workload, names)]
    lim_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(lim_path) if lim_path.exists() else None
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer, limits)


# ---------------------------------------------------------------------------
# inputs, made from the seed
# ---------------------------------------------------------------------------


def layer_shapes(net: dict):
    """(weight shape, bias size) of each variational layer, in order."""
    shapes = [((o, i, k, k), o) for i, o, k, _ in net.get("conv", [])]
    widths = net["fc"] if "conv" in net else net["widths"]
    shapes += [((widths[l + 1], widths[l]), widths[l + 1]) for l in range(len(widths) - 1)]
    return shapes


@dataclass
class Inputs:
    x: np.ndarray
    y: np.ndarray
    xt: np.ndarray
    yt: np.ndarray
    nc: int
    layers0: list  # per variational layer {mu_w, rho_w, mu_b, rho_b}
    u0: torch.Tensor
    z0: torch.Tensor
    v0: torch.Tensor
    batches: list  # per checked step (xb, yb)
    eps: list  # per checked step (T lists of per-layer (w, b), one such list)


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """The data, the starting net and coreset, and the checked steps'
    minibatches (rows that all differ) and noise, all from ``seed``: the
    arrays on the host by NumPy, the weights and noise on ``device`` by one
    ``torch.Generator`` in a few large calls."""
    cfg, mix = cell.config, cell.mix
    data = dict(cfg["data"])
    gen_mod = load_module(HERE / "datasets" / f"{data.pop('generator')}.py")
    x, y, xt, yt, nc = gen_mod.make(data, seed)
    rng = np.random.default_rng(seed)
    M, B = mix["num_pseudo"], cfg["engine"]["data_minibatch"]
    S, T, K = cfg["engine"]["mc_samples"], cfg["engine"]["inner_it"], mix["check_steps"]
    # the coreset starts as a class-balanced subset of the train set
    ppc = [M // nc] * nc
    ppc[-1] = M - sum(ppc[:-1])
    idx = np.concatenate([rng.choice(np.where(y == c)[0], size=p, replace=False)
                          for c, p in enumerate(ppc)])
    rows = rng.permutation(len(x))[:K * B].reshape(K, B)
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shapes = layer_shapes(cfg["net"])
    n_theta = sum(math.prod(w) + o for w, o in shapes)
    # μ ~ U(±1/√fan_in) (torch's Linear and Conv2d init), ρ = softplus⁻¹(init_sd)
    unif = torch.rand(n_theta, generator=g, device=dev) * 2.0 - 1.0
    layers0, off = [], 0
    for (wshape, o), sd in zip(shapes, cfg["net"]["init_sd"]):
        bound, rho = 1.0 / math.sqrt(math.prod(wshape[1:])), math.log(math.expm1(sd))
        nw = math.prod(wshape)
        mu_w = unif[off:off + nw].view(wshape) * bound
        mu_b = unif[off + nw:off + nw + o] * bound
        off += nw + o
        layers0.append({"mu_w": mu_w, "rho_w": torch.full(wshape, rho, device=dev),
                        "mu_b": mu_b, "rho_b": torch.full((o,), rho, device=dev)})
    noise = torch.randn((K, T + 1, S * n_theta), generator=g, device=dev)

    def draw(flat):
        out, o2 = [], 0
        for wshape, o in shapes:
            nw = S * math.prod(wshape)
            out.append((flat[o2:o2 + nw].view(S, *wshape),
                        flat[o2 + nw:o2 + nw + S * o].view(S, o)))
            o2 += nw + S * o
        return out

    eps = [([draw(noise[k, t]) for t in range(T)], draw(noise[k, T])) for k in range(K)]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    batches = [(as_t(x[r]), as_t(y[r])) for r in rows]
    return Inputs(x, y, xt, yt, nc, layers0, as_t(x[idx]), as_t(y[idx]),
                  torch.zeros(M, device=dev), batches, eps)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class StepProbe:
    """Stands in the engine's ``_step``: feeds the queued (batch, noise)
    through the step's injection seam and records what the step returned;
    times every step by CUDA events as it enters and leaves, and by the host
    clock (the enqueue), under the span ``portbench.step``."""

    def __init__(self, step, device):
        self.step, self.device = step, device
        self.feed: list = []
        self.records: list = []
        self.reset()

    def reset(self):
        self.events, self.host_s, self.losses = [], [], []

    def __call__(self, state, batch=None, eps=None):
        fed = bool(self.feed)
        if fed:
            batch, eps = self.feed.pop(0)
        on_card = self.device.type == "cuda"
        with torch.profiler.record_function("portbench.step"):
            if on_card:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            state, aux = self.step(state, batch=batch, eps=eps)
            t1 = time.perf_counter()
            if on_card:
                e1.record()
                self.events.append((e0, e1))
        self.host_s.append(t1 - t0)
        self.losses.append(aux["outer_loss"])
        if fed:
            self.records.append((state, {k: v.detach().clone() for k, v in aux.items()}))
        return state, aux


def _engine_tree(net, per_layer, empty):
    """The engine's tree over its net's layers: ``per_layer`` at the
    variational layers, ``empty`` elsewhere."""
    vi = list(net.variational_layers)
    tree = [empty for _ in net.layers]
    for i, x in zip(vi, per_layer):
        tree[i] = x
    return tuple(tree)


def build_engine(cell: Cell, inputs: Inputs, seed: int, device):
    """The engine as users build it, on ``device``, with the benchmark's
    starting net, coreset and weights in its state. On the CPU (the tests'
    rehearsal) the fused step is asked for, so that its plain versions run
    where the card runs the kernels."""
    from psvi_torch.data.datasets import DataBundle
    from psvi_torch.inference.psvi import PSVI

    x = inputs.x
    channels = x.shape[1] if x.ndim == 4 else 0
    D = int(x.shape[-1] * x.shape[-2]) if x.ndim == 4 else int(x.shape[1])
    data = DataBundle(inputs.x, inputs.y, inputs.xt, inputs.yt, len(x), D, inputs.nc,
                      channels=channels)
    dev = torch.device(device)
    kw = dict(cell.config["engine"])
    if dev.type == "cpu":
        kw.setdefault("fused_inner", True)
    log_every = cell.mix["log_every"]
    eng = PSVI(data, num_pseudo=cell.mix["num_pseudo"], seed=seed, num_epochs=log_every,
               log_every=log_every, device=dev, **kw)
    params = _engine_tree(eng.net, [dict(p) for p in inputs.layers0], {})
    for have, want in zip(eng.state.params, params):
        if {k: tuple(v.shape) for k, v in have.items()} != {k: tuple(v.shape)
                                                              for k, v in want.items()}:
            raise ValueError("the configuration's net does not match the engine's")
    u, z, v = inputs.u0.clone(), inputs.z0.clone(), inputs.v0.clone()
    eng.state = eng.state._replace(
        params=params, u=u, z=z, v=v, opt_u=eng.opt_u.init(u), opt_v=eng.opt_v.init(v),
        opt_z=eng.opt_z.init(z), opt_alpha=eng.opt_alpha.init(eng.state.alpha),
        opt_net=eng.opt_net.init(params),
        opt_joint=eng.opt_joint.init(eng._joint_leaves(params, u, v)), net_step=0)
    eng._rebuild()
    return eng


def _spanned(fn, name):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def set_up(cell: Cell, inputs: Inputs, seed: int, device):
    """Build the engine, put the probe in its step and the span around its
    evaluation, and run ``run_psvi`` once: one evaluation, the checked steps
    fed through the seam, then one step of the engine's own draws."""
    dev = torch.device(device)
    eng = build_engine(cell, inputs, seed, dev)
    probe = StepProbe(eng._step, dev)
    eng._step = probe
    eng._evaluate_fn = _spanned(eng._evaluate_fn, "portbench.evaluate")
    for batch, (e_in, e_out) in zip(inputs.batches, inputs.eps):
        trees = [_engine_tree(eng.net, [{"w": w, "b": b} for w, b in e], {}) for e in e_in]
        probe.feed.append((batch, (trees, _engine_tree(eng.net, [{"w": w, "b": b}
                                                                 for w, b in e_out], {}))))
    eng.num_epochs = cell.mix["check_steps"] + 1
    eng.run_psvi()
    eng.num_epochs = cell.mix["log_every"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return eng, probe


def _snapshot(layers, u, v, opt_u, opt_v) -> dict:
    """A step's state as the check reads it: the net's (μ, ρ) of each
    variational layer, u, v and the hyper-Adam's (count, m, n) of each."""
    c = lambda t: t.detach().clone()  # noqa: E731
    return {"layers": [{k: c(p[k]) for k in R.KEYS} for p in layers], "u": c(u), "v": c(v),
            "opt_u": (int(opt_u[0]), c(opt_u[1]), c(opt_u[2])),
            "opt_v": (int(opt_v[0]), c(opt_v[1]), c(opt_v[2]))}


def _first_state(inputs: Inputs) -> dict:
    zero = lambda t: (0, torch.zeros_like(t), torch.zeros_like(t))  # noqa: E731
    return _snapshot(inputs.layers0, inputs.u0, inputs.v0, zero(inputs.u0), zero(inputs.v0))


def program_states(eng, probe: StepProbe, inputs: Inputs) -> list:
    """What each checked step of the program was given and produced: its
    state before and after (the benchmark's own start for the first), the
    outer loss and the T inner losses it reported."""
    vi = list(eng.net.variational_layers)
    steps, before = [], _first_state(inputs)
    for st, aux in probe.records:
        after = _snapshot([st.params[i] for i in vi], st.u, st.v, st.opt_u, st.opt_v)
        steps.append({"before": before, "after": after, "outer": float(aux["outer_loss"]),
                      "inner": aux["inner_losses"].double().cpu().tolist()})
        before = after
    return steps


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _widen(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, dict):
        return {k: _widen(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_widen(v) for v in x)
    return x


def _reference_parts(cell: Cell, inputs: Inputs):
    cfg = cell.config
    model = load_module(HERE / "reference" / f"{cfg['reference']}.py").make_model(cfg)
    e = cfg["engine"]
    hp = R.Hyper(N=float(len(inputs.x)), T=e["inner_it"], lr_net=e["lr0net"], lr_u=e["lr0u"],
                 lr_v=e["lr0v"], prior_sd=cfg["net"]["prior_sd"])
    return model, hp


class _TF32:
    """TF32 on (or off) for matmuls and convolutions inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def control_states(cell: Cell, inputs: Inputs) -> list:
    """The control, put in the program's place: the plain reference run
    through the checked steps from the benchmark's start, in the
    configuration's float32 with TF32 on for matmuls and convolutions (the
    next precision below the configuration's); the same record as
    ``program_states``."""
    model, hp = _reference_parts(cell, inputs)
    steps, before = [], _first_state(inputs)
    with _TF32(True):
        for (xb, yb), (e_in, e_out) in zip(inputs.batches, inputs.eps):
            b = before
            layers, u, v, opt_u, opt_v, rec = R.nested_step(
                model, b["layers"], b["u"], inputs.z0, b["v"], R.HyperAdam(*b["opt_u"]),
                R.HyperAdam(*b["opt_v"]), xb, yb, e_in, e_out, hp)
            after = _snapshot(layers, u, v, opt_u, opt_v)
            steps.append({"before": before, "after": after, "outer": float(rec["outer_loss"]),
                          "inner": rec["inner_losses"].double().cpu().tolist()})
            before = after
    return steps


def reference_readings(cell: Cell, inputs: Inputs, steps: list) -> list:
    """The plain reference, in float64, one step from each state the judged
    side was in before a checked step, on that step's minibatch and noise;
    and the outer loss again at the net that side's unroll ended at (same
    u, v, minibatch and noise), the outer stage alone. Per step: the
    reference's first inner loss, its net after the unroll, its
    hypergradients of u and v and the u and v its hyper-Adam made of them,
    the norm of each net leaf's first inner gradient, and the outer stage's
    loss."""
    model, hp = _reference_parts(cell, inputs)
    out = []
    with _TF32(False):
        for step, (xb, yb), (e_in, e_out) in zip(steps, inputs.batches, inputs.eps):
            b = _widen(step["before"])
            xb, yb, e_in, e_out = _widen((xb, yb, e_in, e_out))
            z = inputs.z0.double()
            layers, u, v, _, _, rec = R.nested_step(
                model, b["layers"], b["u"], z, b["v"], R.HyperAdam(*b["opt_u"]),
                R.HyperAdam(*b["opt_v"]), xb, yb, e_in, e_out, hp)
            with torch.no_grad():
                cw = hp.N * torch.softmax(b["v"], dim=0)
                stage = R.outer_loss(model, _widen(step["after"]["layers"]), e_out, b["u"], z, cw,
                                     xb, yb, hp.N, hp.prior_sd)
            out.append({"inner1": float(rec["inner_losses"][0]), "layers": layers,
                        "g_u": rec["g_u"], "g_v": rec["g_v"], "u": u, "v": v,
                        "outer_stage": float(stage),
                        "first_grad": [float(torch.linalg.vector_norm(g)) for g in rec["g_net"]]})
    return out


# ---------------------------------------------------------------------------
# the window and the trace
# ---------------------------------------------------------------------------


@dataclass
class Window:
    seconds: float
    steps: int
    blocks: int
    step_ms: list
    host_step_ms: list
    losses: Any


def run_window(eng, probe: StepProbe, seconds: float, run_blocks: int, start) -> Window:
    """``run_psvi`` in blocks of ``log_every`` steps until ``seconds`` are
    up, as runs of ``run_blocks`` blocks: after each, the engine starts its
    next run from ``start``, the state the set-up left. The window closes
    when the card has finished the last block."""
    dev = probe.device
    torch.cuda.synchronize(dev)
    probe.reset()
    t0 = time.perf_counter()
    blocks = 0
    while True:
        with torch.profiler.record_function("portbench.block"):
            eng.run_psvi()
        blocks += 1
        if blocks % run_blocks == 0:
            eng.state = start
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in probe.events]
    return Window(window, len(probe.host_s), blocks, step_ms,
                  [s * 1e3 for s in probe.host_s], torch.stack(probe.losses))


def run_traced(eng, probe: StepProbe, seconds: float, run_blocks: int, start):
    """The traced window: ``run_window`` under ``torch.profiler`` for
    ``seconds``; returns the window and the profiler's raw events."""
    from torch.profiler import ProfilerActivity, profile

    eng.state = start
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        win = run_window(eng, probe, seconds, run_blocks, start)
    return win, prof.profiler.kineto_results.events()


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: Cell
    seed: int
    device_kind: str
    setup_s: float
    window: Window
    trace: Optional[dict] = None
    traced_window: Optional[Window] = None
    launches_per_step: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)


def launch_counters():
    from psvi_torch.ops import fused_lenet as FL
    from psvi_torch.ops import fused_nested as FN

    return {**FN.LAUNCHES, **FL.LAUNCHES}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(rec: RunRecord, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda") -> dict:
    """One run of a cell; returns the result line's object and the run's
    record for its file. On the CPU (the tests' rehearsal) the window is one
    block, untimed, and no metric of the card is read."""
    from portbench import trace as TR

    workload = cell.name
    dev = torch.device(device)
    inputs = make_inputs(cell, seed, dev)
    eng, probe = set_up(cell, inputs, seed, dev)
    setup_s = time.perf_counter() - t_start
    on_card = dev.type == "cuda"
    start, run_blocks = eng.state, cell.mix["run_steps"] // cell.mix["log_every"]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counters()
        win = run_window(eng, probe, seconds, run_blocks, start)
        after = launch_counters()
        launches = {k: (after[k] - before[k]) / max(win.steps, 1) for k in after
                    if after[k] != before[k]}
    else:  # the tests' rehearsal: no timing, one block
        eng.run_psvi()
        win = Window(0.0, len(probe.host_s), 1, [], [], torch.stack(probe.losses))
        launches = {}
    peaks = load_json(HERE / "peaks.json")
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rec = RunRecord(cell, seed, kind, setup_s, win, launches_per_step=launches,
                    peaks=peaks.get(kind, {}))
    if trace and on_card:
        tw, events = run_traced(eng, probe, cell.mix["trace_seconds"], run_blocks, start)
        rec.traced_window = tw
        rec.trace = TR.reduce(events, SPANS, tw.seconds)
    peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    failed = int((~torch.isfinite(win.losses)).sum())
    attempted = win.steps
    steps = program_states(eng, probe, inputs)
    step_name = getattr(probe.step, "__name__", str(probe.step))
    del eng, probe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_readings(cell, inputs, steps)
    numbers = check.numbers(steps, ref)
    verdict = check.judge(numbers, cell.limits)
    metrics = read_metrics(rec, cell.per_layer if trace else cell.end_to_end)
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
              "memory_peak_bytes": peak_bytes}
    if rec.trace is not None:
        device.update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
    result = {"correct": verdict["correct"] and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"][:10],
                               "idle_gaps": rec.trace["idle_gaps"][:10]}
    result["check"] = verdict["check"]
    info = {"workload": workload, "seed": seed, "step": step_name, "setup_s": setup_s,
            "window_s": win.seconds, "steps": win.steps, "blocks": win.blocks,
            "launches_per_step": launches, "memory_peak_bytes": peak_bytes,
            "step_ms_median": statistics.median(win.step_ms) if win.step_ms else None,
            "host_step_ms_mean": statistics.fmean(win.host_step_ms) if win.host_step_ms else None,
            "per_step": check.per_step(steps, ref), "numbers": numbers}
    if rec.trace is not None:
        info["trace"] = {k: v for k, v in rec.trace.items() if k != "intervals"}
        info["traced_steps"] = rec.traced_window.steps
    return {"result": result, "info": info}
