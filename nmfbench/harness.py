"""One run of one cell: set-up, the measured window, the trace, the check.

``main(argv)`` is ``nmfbench/run.py``.  A one-chip cell runs in this
process.  A cell on several chips starts one rank process per card
(``run.py`` again, with the hidden ``--rank`` options), each joined to a
NCCL process group at ``tcp://localhost:<free port>`` and to
``parallel.make_mesh``; rank 0 decides when the window closes, runs the
check and hands its reading back, and this process prints the line.

A run:

1. set-up (``setup_s``): torch and the port imported, V (and M) made on
   the card from the seed, the tolerance worked out, one short solve of
   the cell's own shapes (the first run in a checkout builds the port's
   kernel library there, into ``nmf_toolbox_tpu_torch/_build/``);
2. the window: solves back to back, the configuration's solver
   (``solvers/<solver>.py``: the port's entry point) from a new seeded
   init each, until ``--seconds`` have passed; a solve that starts
   inside runs to its end and counts;
3. with ``--trace 1``, one more solve under ``torch.profiler``;
4. the check (``check.py``): a solve drawn from the seed is worked out
   again by the plain reference that the configuration names, after the
   program's state is freed.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from . import cells, check, data, timing, work

BANNED = ("jax", "jaxlib", "flax", "nmf_toolbox_tpu")  # top-level names
RANK_TIMEOUT = 330  # seconds a rank process may take, set-up and check included
GROUP_TIMEOUT = 120  # seconds a collective may wait for the other ranks
WARM_ITERS = 3  # iterations of the set-up's solve, which meets every shape of the window


def banned_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def cache_env(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout, and
    nothing that would load JAX."""
    cache = root / "nmfbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["NCCL_SHM_DISABLE"] = "1"  # no segments under /dev/shm; NVLink P2P stays


class Run:
    """What a metric's reader reads (``metrics/<name>.py: read(run)``)."""

    def __init__(self, cell, kind, reading):
        cfg, traffic = cell.config, cell.traffic
        self.chips = cell.chips
        self.kind = kind
        self.solves = reading["solves"]
        self.iters = sum(s["n_iters"] for s in self.solves)
        self.window_s = reading["window_s"]
        self.setup_s = reading["setup_s"]
        self.counters = reading["counters"]
        self.profile = reading.get("profile")
        self.flops_per_iter = work.flops_per_iter(cfg, traffic, cell.solver)
        self.least_s_per_iter = work.least_seconds_per_iter(cfg, traffic, kind, cell.chips,
                                                            cell.solver)
        p = work.peaks(kind)
        self.peak_flops = None if p is None else p["flops"]


def program_solve(cell, V, init, tol, M, mesh, maxiter=None):
    """One solve of the port as the cell makes it: the solver's call, with
    the traffic file's ``"options"`` as keyword arguments of the entry
    point."""
    tr = cell.traffic
    return cell.solver.solve(cell.config, tr, V, init, tol, int(maxiter or tr["cap"]),
                             M=M, mesh=mesh, **(tr.get("options") or {}))


def serve(cell, seed, seconds, trace, device, t0, mesh=None):
    """Set-up, window and trace of one rank (or of the only process).
    Returns the program side of the reading; ``reading["check"]`` holds
    what :func:`check_solve` needs."""
    import torch
    from nmf_toolbox_tpu_torch import core
    from nmf_toolbox_tpu_torch.parallel import collectives
    cfg, tr = cell.config, cell.traffic
    is_root = mesh is None or torch.distributed.get_rank() == 0

    def agree(value: float) -> float:
        """Rank 0's value on every rank."""
        if mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        torch.distributed.broadcast(t, src=0)
        return float(t.item())

    steps = [("imports", time.time() - t0)]
    V, parts = data.make_v(cfg, tr, seed, device)
    M = data.make_mask(cfg, tr, seed, device)
    timing.sync(torch, device)
    steps.append(("inputs", time.time() - t0))
    tol = agree(data.tolerance(cfg, tr, V, parts, M, cell.solver))
    del parts
    steps.append(("tolerance", time.time() - t0))
    program_solve(cell, V, data.make_init(cfg, seed, "warm", device, cell.solver), tol, M,
                  mesh, maxiter=WARM_ITERS)
    timing.sync(torch, device)
    steps.append(("warm solve", time.time() - t0))
    if is_root:
        print("nmfbench: set-up (s since start) " + ", ".join(f"{n} {v:.2f}" for n, v in steps),
            file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if mesh is not None:
        torch.distributed.barrier()

    reads0, coll0 = core.host_reads, collectives.calls
    start = time.perf_counter()
    setup_s = time.time() - t0
    solves, factors, end = [], [], start
    while agree(float(time.perf_counter() - start < seconds)):
        init = data.make_init(cfg, seed, len(solves), device, cell.solver)
        res, sec = timing.wall(torch, device,
                               lambda: program_solve(cell, V, init, tol, M, mesh))
        end = time.perf_counter()
        solves.append({"n_iters": int(res.n_iters), "stopped": bool(res.converged),
                       "seconds": sec, "cost": res.cost})
        factors.append((res.W, res.H) if is_root else None)
        del res, init
    reading = {"solves": solves, "window_s": end - start, "setup_s": setup_s,
               "counters": {"host_reads": core.host_reads - reads0,
                            "collectives": collectives.calls - coll0},
               "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                     if device.type == "cuda" else 0)}
    if trace:
        init = data.make_init(cfg, seed, len(solves), device, cell.solver)
        before = cell.solver.launches()
        res, prof = timing.profile(torch, device,
                                   lambda: program_solve(cell, V, init, tol, M, mesh))
        prof["iters"] = int(res.n_iters)
        after = cell.solver.launches()
        counts = prof.pop("device_op_counts")
        for name, count in after.items():
            if count - before[name]:
                seen = sum(c for op, c in counts.items() if name in op)
                print(f"nmfbench: the profiler saw {seen} {name} launches of "
                    f"{count - before[name]}", file=sys.stderr)
        reading["profile"] = prof
        del res, init
    drawn = data.substream(seed, "check") % len(solves)
    reading["check"] = {"index": drawn, "tolerance": tol, "V": V, "M": M,
                        "factors": factors[drawn] if is_root else None}
    del factors
    return reading


def check_solve(cell, seed, reading, device):
    """The numbers of ``check.py`` for the run, the program's state freed."""
    import torch
    got = reading.pop("check")
    V, M, (W, H) = got["V"], got["M"], got["factors"]
    solves, tol = reading["solves"], got["tolerance"]
    drawn = solves[got["index"]]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    init = data.make_init(cell.config, seed, got["index"], device, cell.solver)
    ref = cell.solver.reference_solve(cell.reference, cell.config, cell.traffic, V, init, tol,
                                      M=M, snapshots=(drawn["n_iters"],))
    numbers = check.trajectory_gaps(torch, drawn["cost"], drawn["n_iters"], W, H, ref)
    numbers["stop_breaks"] = sum(check.stop_breaks(s["cost"], s["n_iters"], s["stopped"], tol)
                                 for s in solves)
    numbers["ref_n_iters"] = ref["n_iters"]
    return numbers


def rank_command(argv_common, rank, world, port, t0, root):
    return [sys.executable, str(Path(root) / "nmfbench" / "run.py"), *argv_common,
            "--rank", str(rank), "--world", str(world), "--port", str(port), "--t0", repr(t0)]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(argv_common, world, t0, root):
    """One rank process per card (``LOCAL_RANK`` set), joined at a free
    port of this host."""
    port = free_port()
    return [subprocess.Popen(rank_command(argv_common, r, world, port, t0, root),
                             stdout=subprocess.PIPE, text=True,
                             env=dict(os.environ, LOCAL_RANK=str(r)))
            for r in range(world)]


def wait_ranks(procs):
    """Each rank's last line of output, read as JSON, once every rank has
    ended (RANK_TIMEOUT in all); a rank that failed raises."""
    outs, deadline = [], time.monotonic() + RANK_TIMEOUT
    for p in procs:
        out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        outs.append(out)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {failed} exited with "
                           f"{[procs[r].returncode for r in failed]}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def stop_ranks(procs):
    """Kill and reap every rank process still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def rank_main(args, cell, t0):
    """A rank process: its process group, its mesh, :func:`serve`, and on
    rank 0 the check; prints one JSON line."""
    import torch
    import torch.distributed as dist
    from nmf_toolbox_tpu_torch.parallel import init_distributed, make_mesh
    if not args.cpu_test and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < args.world):
        print(f"nmfbench: rank {args.rank} finds fewer than {args.world} CUDA cards",
              file=sys.stderr)
        return 2
    backend = "gloo" if args.cpu_test else "nccl"
    init_distributed(f"tcp://localhost:{args.port}", args.world, args.rank,
                     backend=backend, timeout=GROUP_TIMEOUT)
    mesh = make_mesh(args.world, device_type="cpu" if args.cpu_test else "cuda")  # 1 x world
    device = mesh.device
    reading = serve(cell, args.seed, args.seconds, args.trace, device, t0, mesh=mesh)
    dist.barrier()
    dist.destroy_process_group()
    out = {"rank": args.rank, "memory_peak_bytes": reading["memory_peak_bytes"]}
    if "profile" in reading:
        out["busy_s"] = reading["profile"]["busy_s"]
    if args.rank == 0:
        out["numbers"] = check_solve(cell, args.seed, reading, device)
        for s in reading["solves"]:
            s.pop("cost")
        out["reading"] = reading
    else:
        reading.pop("check")
    out["banned"] = banned_modules()
    print(json.dumps(out), flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="nmfbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    hidden = argparse.SUPPRESS
    p.add_argument("--rank", type=int, default=None, help=hidden)
    p.add_argument("--world", type=int, default=None, help=hidden)
    p.add_argument("--port", type=int, default=None, help=hidden)
    p.add_argument("--t0", type=float, default=None, help=hidden)
    # tests only: run on the CPU at the sizes of a test's own files
    p.add_argument("--cpu-test", action="store_true", help=hidden)
    return p.parse_args(argv)


def common_argv(args):
    out = ["--workload", args.workload, "--seed", str(args.seed),
           "--seconds", repr(args.seconds), "--trace", str(args.trace)]
    return out + (["--cpu-test"] if args.cpu_test else [])


def main(argv=None, root: Path = cells.ROOT, t0: float | None = None):
    t0 = time.time() if t0 is None else t0
    args = parse(sys.argv[1:] if argv is None else argv)
    cache_env(Path(root))
    cell = cells.load(args.workload, root)
    if args.rank is not None:
        import torch
        torch.set_num_threads(1 if args.cpu_test else 4)
        return rank_main(args, cell, args.t0)
    # the ranks start first: their imports overlap this process's
    procs = (start_ranks(common_argv(args), cell.chips, t0, root)
             if cell.chips > 1 else [])
    try:
        return run_cell(args, cell, t0, procs)
    finally:
        stop_ranks(procs)


def run_cell(args, cell, t0, procs):
    import torch
    if args.cpu_test:
        device, kind, platform = torch.device("cpu"), "cpu", "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"nmfbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
                  f"found {count}. No result.", file=sys.stderr)
            return 2
        device, platform = torch.device("cuda", 0), "gpu"
        kind = torch.cuda.get_device_name(0)
    import nmf_toolbox_tpu_torch  # noqa: F401  (no program, no run)

    if cell.chips == 1:
        reading = serve(cell, args.seed, args.seconds, args.trace, device, t0)
        peak = reading["memory_peak_bytes"]
        numbers = check_solve(cell, args.seed, reading, device)
        busy = reading["profile"]["busy_s"] if args.trace else None
        banned = banned_modules()
    else:
        ranks = wait_ranks(procs)
        root_out = ranks[0]
        reading, numbers = root_out["reading"], root_out["numbers"]
        peak = max(r["memory_peak_bytes"] for r in ranks)
        busy = (sum(r["busy_s"] for r in ranks) / len(ranks)) if args.trace else None
        if args.trace:
            reading["profile"]["busy_s"] = busy
        banned = sorted(set(banned_modules()).union(*(r["banned"] for r in ranks)))
    if banned:
        print(f"nmfbench: modules that must not load were loaded: {banned}. No result.",
              file=sys.stderr)
        return 3
    return emit(cell, args, reading, numbers, platform, kind, peak, busy)


def emit(cell, args, reading, numbers, platform, kind, peak, busy):
    run = Run(cell, kind, reading)
    metrics = {}
    for spec, mod in (cell.per_layer if args.trace else cell.end_to_end):
        value = mod.read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    correct, checks = check.judge(numbers, cell.traffic["limits"])
    solves = reading["solves"]
    device = {"platform": platform, "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(solves),
            "failed": sum(1 for s in solves if not s["stopped"]),
            "metrics": metrics, "device": device}
    if args.trace:
        prof = reading["profile"]
        device["busy_s"] = busy
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    print(json.dumps({"solves": [[s["n_iters"], s["seconds"]] for s in solves],
                      "numbers": numbers}), file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    return 0
