"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The system under test is ``ba_path_planning_torch`` on one card: its batch
entry ``ShardedSCPSolver.solve_compacted`` with the solver the cell's
configuration names.  One client runs a closed loop: each call takes one
batch of the traffic's size from a pool of scenarios drawn at set-up
(``generator.py``, on the host; the same scenarios for every seed, in the
order ``--seed`` gives them), and returns when its answers are on the host;
the next call starts at once.  The window starts at the first
timed call and closes at the end of the first call that ends after
``--seconds``.

After the window the answers are judged: a solve counts when the float64
rollout of its accelerations is collision-free and goal-exact
(``reference/judge.py``), and a sample of answers drawn from the seed is
compared with the plain reference's float64 solve of the same scenarios
(``reference/scp.py``); ``correct`` holds when every number compared is
within the configuration's limit.  With ``--trace 1`` a few more calls run
under ``torch.profiler`` after the window, and the line carries the
per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the line's last
key, ``checks``.  Exits with 3 and prints no result where there is no card
or fewer cards than the cell asks for, and with 4 where JAX or the JAX
package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import registry, tracing  # noqa: E402
from .generator import scenario_batch  # noqa: E402
from .reference import judge, scp  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ba_path_planning_tpu")


@dataclass
class Call:
    """One call of the loop: its wall time, the driver's ``last_timing``,
    the pool batch it solved and host copies of its answers."""
    wall_s: float
    batch: int
    timing: dict = field(default_factory=dict)
    iterations: torch.Tensor | None = None
    status: torch.Tensor | None = None
    accelerations: torch.Tensor | None = None
    positions: torch.Tensor | None = None
    raised: str | None = None


@dataclass
class Context:
    """What a per-layer metric reads (``metrics/``)."""
    calls: list
    traced_calls: list
    trace: dict | None
    spec: scp.Spec


def _log(*parts):
    print("port_bench:", *parts, file=sys.stderr, flush=True)


def _finite(x):
    """JSON has no inf or nan: those are written as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def batch_seed(seed: int, b: int) -> int:
    """The generator seed of the pool's draw ``b`` (0, then redraws)."""
    return (int(seed) * 1_000_003 + b) % (1 << 63)


def draw_pool(config: dict, traffic: dict, seed: int):
    """The cell's scenarios, in the order ``seed`` gives them: a list of
    ``pool_batches`` (p0, pf) float64 (B, N, 2) host tensors.

    The scenarios are the same for every seed: ``pool_batches`` x ``batch``
    complete draws from the mix's ``pool_seed`` (a scenario whose rejection
    sampling gave up is replaced by one of a redraw).  ``seed`` permutes the
    order of the batches and of the scenarios in each, so every seed gives
    the loop the same work in another order; which scenarios are solved is
    the mix's, and which answers are compared is the seed's."""
    N = config["problem"]["n_vehicles"]
    R = config["problem"]["min_distance"]
    B, nb = traffic["batch"], traffic["pool_batches"]
    ps = traffic["pool_seed"]
    init, fin, ok = scenario_batch(batch_seed(ps, 0), B * nb, N, R)
    redraw = 1
    while not bool(ok.all()):
        i2, f2, ok2 = scenario_batch(batch_seed(ps, redraw), B * nb, N, R)
        bad = torch.nonzero(~ok)[:, 0]
        good = torch.nonzero(ok2)[:, 0][:bad.numel()]
        bad = bad[:good.numel()]
        init[bad], fin[bad], ok[bad] = i2[good], f2[good], True
        redraw += 1
    # both sides get the same values: the draw rounded to the program's dtype
    dtype = getattr(torch, config["dtype"])
    init, fin = (t.to(dtype).to(torch.float64) for t in (init, fin))
    gen = torch.Generator().manual_seed(batch_seed(seed, 0))
    order = torch.randperm(nb, generator=gen)
    lanes = torch.argsort(torch.rand((nb, B), generator=gen), dim=1)
    return [tuple(t[b * B:(b + 1) * B][lanes[i]] for t in (init, fin))
            for i, b in enumerate(order.tolist())]


def build_solver(config: dict, device):
    """The program's batch solver for the configuration; raises where the
    solver the program builds departs from what the configuration
    states."""
    from ba_path_planning_torch.parallel.mesh import ShardedSCPSolver
    from ba_path_planning_torch.utils.config import (ProblemConfig,
                                                     SolverConfig)
    pcfg = dict(config["problem"])
    pcfg["space_dims"] = tuple(pcfg["space_dims"])
    problem = ProblemConfig(**pcfg)
    preset = getattr(SolverConfig, config["solver_preset"])
    solver = preset(problem=problem)
    for key, want in config["solver"].items():
        have = getattr(solver, key)
        same = (float(have) == float(want)
                if isinstance(have, (int, float)) else have == want)
        if not same:
            raise ValueError(f"the program's {config['solver_preset']} "
                             f"solver has {key}={have!r}, the configuration "
                             f"states {want!r}")
    dtype = getattr(torch, config["dtype"])
    return ShardedSCPSolver(problem, solver, dtype=dtype, device=device,
                            seed=config["angle_seed"])


def _call(solver, inputs, b, chunk) -> Call:
    p0, pf = inputs[b]
    v0 = torch.zeros_like(p0)
    t0 = time.perf_counter()
    try:
        res = solver.solve_compacted(p0, v0, pf, v0, chunk=chunk)
        out = Call(0.0, b, dict(solver.last_timing),
                   res.iterations.cpu(), res.status.cpu(),
                   res.accelerations.cpu(), res.positions.cpu())
    except RuntimeError as err:            # a call that raised: no answers
        out = Call(0.0, b, raised=repr(err))
    out.wall_s = time.perf_counter() - t0
    return out


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float = _T0) -> tuple[dict, dict]:
    """Run the cell once on ``device``; returns the result line and the
    checks (each number compared, its value and its limit)."""
    config, traffic = cell.config, cell.traffic
    spec = scp.from_config(config)
    device = torch.device(device)
    B, chunk = traffic["batch"], traffic["chunk"]

    solver = build_solver(config, device)
    t_solver = time.perf_counter() - t_start
    dtype = getattr(torch, config["dtype"])
    pool = draw_pool(config, traffic, seed)
    inputs = [(p0.to(device, dtype), pf.to(device, dtype))
              for p0, pf in pool]
    t_pool = time.perf_counter() - t_start
    for w in range(traffic["warmup_calls"]):
        warm = _call(solver, inputs, w % len(inputs), chunk)
        if warm.raised:
            raise RuntimeError(f"warm-up call raised: {warm.raised}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    setup_s = time.perf_counter() - t_start
    calls = []
    tw0 = time.perf_counter()
    while True:
        calls.append(_call(solver, inputs, len(calls) % len(inputs), chunk))
        if time.perf_counter() - tw0 >= seconds:
            break
    window_s = time.perf_counter() - tw0
    done = [c for c in calls if not c.raised]
    p50 = np.median([c.wall_s for c in calls]) * 1e3
    iters = np.mean([float(c.iterations.double().mean()) for c in done])
    disp = np.mean([c.timing["loop_dispatches"] for c in done])
    _log(f"setup_s={setup_s:.3f} window_s={window_s:.3f} calls={len(calls)}"
         f" batch={B} call_ms_p50={p50:.2f} scp_iters_mean={iters:.4f}"
         f" dispatches_per_call={disp:.3f}")
    _log(f"set-up: solver built at {t_solver:.3f} s, pool on the card at "
         f"{t_pool:.3f} s, warm-up to {setup_s:.3f} s")

    traced, summary = [], None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for t in range(traffic["trace_calls"]):
                with record_function(tracing.CALL_RANGE):
                    traced.append(_call(solver, inputs,
                                        (len(calls) + t) % len(inputs),
                                        chunk))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        tt = time.perf_counter()
        summary = tracing.summarize(prof.profiler.kineto_results.events())
        _log(f"traced calls={len(traced)} window_s={summary.get('window_s')}"
             f" busy_s={summary.get('busy_s')} reduced in"
             f" {time.perf_counter() - tt:.1f} s")
        del prof

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del solver, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # judge every answer of the window
    tj = time.perf_counter()
    first, repeats, same = {}, 0, 0
    for c in done:             # the solver keeps no state across calls
        if c.batch in first:
            repeats += 1
            same += int(torch.equal(c.accelerations,
                                    first[c.batch].accelerations))
        else:
            first[c.batch] = c
    _log(f"repeated batches with identical answers: {same} of {repeats}")
    n_ok = count_ok(spec, pool, done, device)
    attempted = B * len(calls)

    # compare a sample of the answers with the reference
    checks_ok, checks = False, {}
    if done:
        values = compare(spec, config, pool, done, seed,
                         traffic["check_sample"], device)[0]
        values["not_ok_pct"] = 100.0 * (1 - n_ok / (B * len(done)))
        _log("readings " + json.dumps(_finite(values)))
        checks_ok, checks = judge.verdict(values, config["limits"])
    correct = checks_ok and len(done) == len(calls)
    _log(f"judged {attempted} answers, ok {n_ok}, and a sample against the "
         f"reference in {time.perf_counter() - tj:.1f} s")

    e2e = {"solves_per_s": n_ok / window_s, "setup_s": setup_s}
    metrics = {}
    if trace:
        ctx = Context(done, [c for c in traced if not c.raised], summary,
                      spec)
        for entry, module in cell.per_layer:
            v = module.read(ctx)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": e2e[entry["name"]],
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": attempted - n_ok, "metrics": metrics, "device": dev}
    if trace and summary:
        line["breakdown"] = summary["breakdown"]
    line["checks"] = checks
    return line, checks


def count_ok(spec, pool, calls, device) -> int:
    """How many of the calls' answers are ok (``judge.ok``)."""
    return sum(int(judge.ok(c.accelerations.to(device), *pool[c.batch],
                            spec).sum()) for c in calls)


def solve_reference(spec, config, pool, keys, device,
                    num: scp.Numerics = scp.Numerics()) -> scp.Result:
    """The reference's solve of the scenarios ``keys`` ((pool batch, lane)
    each) in the arithmetic ``num`` (float64), in blocks of ``ref_block``
    scenarios."""
    p0 = torch.stack([pool[b][0][lane] for b, lane in keys]).to(device)
    pf = torch.stack([pool[b][1][lane] for b, lane in keys]).to(device)
    lanes = torch.tensor([lane for _, lane in keys], device=device)
    blk = config["ref_block"]
    cache: dict = {}
    parts = [scp.solve(spec, p0[i:i + blk], pf[i:i + blk], lanes[i:i + blk],
                       num, normal=cache)
             for i in range(0, len(keys), blk)]
    return scp.Result(*(torch.cat(t).cpu() for t in zip(*parts)))


def compare(spec, config, pool, calls, seed, size, device):
    """Draw ``size`` of the calls' answers from ``seed``, solve their
    scenarios with the reference and compare: (readings, the sampled
    answers, the scenarios' (batch, lane) keys, the reference's solve of
    them, row for row)."""
    B = calls[0].iterations.numel()
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(calls) * B, size=min(size, len(calls) * B),
                      replace=False)
    which = [(int(k) // B, int(k) % B) for k in np.sort(pick)]
    keys = [(calls[c].batch, lane) for c, lane in which]
    unique = sorted(set(keys))
    ref = solve_reference(spec, config, pool, unique, device)
    row = {key: r for r, key in enumerate(unique)}
    ref = scp.Result(*(t[[row[k] for k in keys]] for t in ref))
    prog = {k: torch.stack([getattr(calls[c], k)[lane] for c, lane in which])
            for k in ("positions", "iterations", "status")}
    return judge.readings(prog, ref), prog, keys, ref


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = registry.cell(args.workload)
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        _log(f"needs {chips} CUDA device(s); found {found}")
        return 3
    torch.set_num_threads(4)
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda:0")
    _log(f"card: {_power_limit()}")       # after set-up: nvidia-smi is slow
    bad = forbidden_modules()
    if bad:
        _log(f"loaded modules it must not load: {bad}")
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
