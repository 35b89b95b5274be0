"""One run of one cell: set-up, the measured window, the trace, the output
check and the result.

Set-up (``setup_s``, from the process's start): load the port, make the
problem's inputs and the pool of right-hand sides from the seed, call
``openmg_tpu_torch.setup`` as a user does, and warm up with one call of the
cell's own kind.  The window: one client calls the solver back to back for
``seconds``, each call timed by the host clock from its start to its
solution ready (after a device synchronize); the window runs from the first
call's start to the last call's end.  The check, after the window, once the
peak memory is read and the solver freed: the answers of the calls in
progress at moments drawn from the seed, every member of each, against the
plain float64 reference's ‖b − A x‖₂ (the answers are copied into pinned
host buffers between calls; in a traced run a moment that falls in the
traced calls takes the first call after them); and every call's own
report.

``run_cell`` runs on the device it is given; the command (``run.py``)
gives it the card and nothing else, the tests the CPU at tiny sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import subprocess
import sys
import time

import numpy as np
import torch

from omgbench import spec as specs
from omgbench import tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "openmg_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``openmg_tpu_torch`` is not ``openmg_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def seeded(seed: int, tag: str) -> int:
    """A 64-bit seed of the stream ``tag`` of the run seed ``seed``."""
    words = [abs(int(seed)), int(seed < 0), *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class Call:
    """One call of the window: the host clock at its start and at its
    solution ready, and its report a member."""

    t0: float
    t1: float
    cycles: list
    converged: list
    final_norm: list

    @property
    def steps(self) -> int:
        """Outer steps of the call: its members run in lockstep."""
        return max(self.cycles)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    kind: str  # the device's name
    unknowns: int  # a right-hand side's
    setup_s: float
    spans: dict  # set-up's parts, seconds
    calls: list
    window_s: float
    peak_bytes: int | None  # device memory, None off the card
    trace: tracing.Summary | None


def _solve(solver, b):
    x, info = solver.solve(b)
    hi, lo = info.get("x_df") or (x, torch.zeros_like(x))
    return (hi[None], lo[None]), [info["cycles"]], [info["converged"]], [info["final_norm"]]


def _solve_many(solver, b):
    xs, info = solver.solve_many(b)
    pair = info.get("x_df") or (xs, torch.zeros_like(xs))
    return pair, list(info["cycles"]), list(info["converged"]), list(info["final_norm"])


# a traffic mix's "call": what one call of the window is
CALLS = {"solve": _solve, "solve_many": _solve_many}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_pool(traffic: dict, shape, generator) -> torch.Tensor:
    """``traffic["pool"]`` distinct right-hand sides ``(pool, *shape)``,
    float32, standard normal, each scaled to ‖b‖₂ = 1, drawn on the device
    in one call."""
    g = generator("rhs")
    pool = torch.randn((traffic["pool"],) + tuple(shape), generator=g,
                       device=g.device, dtype=torch.float32)
    for b in pool:
        b /= torch.linalg.vector_norm(b, dtype=torch.float64).to(torch.float32)
    return pool


def batches(traffic: dict, pool: torch.Tensor) -> list:
    """The inputs of the calls, in turn: a grid for ``solve``, a stack of
    ``batch`` for ``solve_many``."""
    k = traffic["batch"]
    if traffic["call"] == "solve":
        return [pool[j] for j in range(pool.shape[0])]
    return [pool[j:j + k] for j in range(0, pool.shape[0] - k + 1, k)]


def device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def power_limit(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, as it prints
    them."""
    if device.type != "cuda":
        return "not a GPU"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"unknown ({err})"
    return out.stdout.strip()


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, *, root=specs.ROOT, t_start=None, control=False):
    """One run of cell ``name``: ``(line, spans)``, the result line as a
    dict and the seconds of set-up's parts.  ``control`` applies the
    configuration's ``control`` settings (the program's lower-precision
    path), which must come out not correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = specs.cell(bench, name)
    config = specs.config(bench, cell, root)
    traffic = specs.traffic(cell["traffic"], root)
    problem_mod = specs.module("problems", config["problem"], root)
    reference_mod = specs.module("reference", config["problem"], root)
    readers = [(m, specs.module("metrics", m["name"], root))
               for m in specs.metrics(bench, name, trace)]
    call = CALLS[traffic["call"]]

    import openmg_tpu_torch as mg

    spans = {"import_s": time.perf_counter() - t_start}

    def generator(tag):
        g = torch.Generator(device=device)
        g.manual_seed(seeded(seed, tag))
        return g

    t0 = time.perf_counter()
    problem = problem_mod.make(config, generator)
    spans["inputs_s"] = time.perf_counter() - t0
    spans.update(problem["spans"])
    solver_kw = dict(config["solver"], **(config["control"] if control else {}))
    t0 = time.perf_counter()
    solver = mg.setup(problem.pop("setup"), mg.SolverConfig(**solver_kw),
                      faced=config.get("faced", True), device=device)
    _sync(device)
    spans["hierarchy_build_s"] = time.perf_counter() - t0
    got = [list(L.grid_shape) for L in solver.hierarchy.levels]
    want = [list(L["shape"]) for L in config["levels"]]
    if got != want:
        raise RuntimeError(f"the program built levels {got}; {config['name']} states {want}")
    pool = make_pool(traffic, config["shape"], generator)
    inputs = batches(traffic, pool)
    t0 = time.perf_counter()
    call(solver, inputs[0])
    _sync(device)
    spans["warmup_s"] = time.perf_counter() - t0
    tracer = tracing.Tracer(device, traffic["trace_skip"], traffic["trace_calls"]) \
        if trace else None
    if tracer:
        t0 = time.perf_counter()
        tracer.warm(lambda: (call(solver, inputs[0]), _sync(device)))
        spans["tracer_warmup_s"] = time.perf_counter() - t0

    # host buffers for the checked answers, pinned so that a copy takes
    # milliseconds of the window
    rng = np.random.default_rng(seeded(seed, "check"))
    picks = sorted(rng.random(traffic["check_calls"]) * seconds)
    pinned = device.type == "cuda"
    answer_shape = (traffic["batch"],) + tuple(config["shape"])
    buffers = [tuple(torch.empty(answer_shape, pin_memory=pinned) for _ in range(2))
               for _ in picks]
    setup_s = time.perf_counter() - t_start

    # the window (a traced run goes on until its traced calls are done)
    calls, answers = [], []
    win0 = time.perf_counter()
    while True:
        i = len(calls)
        j = i % len(inputs)
        if tracer:
            tracer.before(i)
        with tracer.span() if tracer else contextlib.nullcontext():
            t0 = time.perf_counter()
            pair, cycles, converged, final = call(solver, inputs[j])
            _sync(device)
            t1 = time.perf_counter()
        calls.append(Call(t0, t1, cycles, converged, final))
        if tracer:
            tracer.after(i)
        # a moment that falls in the traced calls takes the first call after them
        if picks and win0 + picks[0] <= t1 and not (tracer and tracer.active):
            while picks and win0 + picks[0] <= t1:
                picks.pop(0)
            hi, lo = buffers[len(answers)]
            hi.copy_(pair[0])
            lo.copy_(pair[1])
            answers.append((i, j, hi, lo))
        del pair
        if t1 >= win0 + seconds and (tracer is None or tracer.done):
            break
    window_s = calls[-1].t1 - calls[0].t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    summary = tracer.finish() if tracer else None

    run = Run(config=config, traffic=traffic, kind=device_name(device),
              unknowns=math.prod(config["shape"]), setup_s=setup_s, spans=spans,
              calls=calls, window_s=window_s, peak_bytes=peak, trace=summary)
    metrics = {}
    for m, reader in readers:
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check, on the program's answers, with the solver freed
    del solver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limit = float(config["check"]["residual_limit"])
    op = reference_mod.prepare(problem["reference"], device)
    residuals, bad = [], set()
    for i, j, hi, lo in answers:
        for m in range(hi.shape[0]):
            x = hi[m].to(device, torch.float64) + lo[m].to(device, torch.float64)
            b = inputs[j].reshape((-1,) + tuple(config["shape"]))[m].to(torch.float64)
            r = reference_mod.residual_norm(op, b, x)
            residuals.append(r)
            if not r <= limit:  # a NaN fails too
                bad.add((i, m))
    unconverged = 0
    for i, c in enumerate(calls):
        for m, ok in enumerate(c.converged):
            if not ok:
                unconverged += 1
                bad.add((i, m))
    checks = {
        "residual_max": {"value": max(residuals) if residuals else None, "limit": limit},
        "unconverged": {"value": unconverged, "limit": 0},
    }
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.kind, "count": 1, "memory_peak_bytes": peak,
           "power_limit": power_limit(device)}
    if trace:
        dev["busy_s"] = summary.busy_s if summary else 0.0
        dev["window_s"] = summary.window_s if summary else 0.0
    result = {
        "correct": bool(residuals) and not bad,
        "attempted": sum(len(c.cycles) for c in calls),
        "failed": len(bad),
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        result["breakdown"] = {
            "device_ops": summary.device_ops if summary else [],
            "idle_gaps": summary.idle_gaps if summary else [],
        }
    result["checks"] = checks
    return result, spans
