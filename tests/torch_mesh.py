"""Gloo ranks on the CPU for the port's mesh tests.

:class:`Ranks` starts ``n`` processes once (a module-scoped fixture holds
it), joins them into one Gloo process group through a ``file://``
rendezvous in a temporary directory (no TCP port, so parallel pytest
workers cannot collide) and runs every case in all of them: ``run(fn,
*args)`` calls the module-level function ``fn`` on every rank and returns
the ranks' results, rank 0 first.  Every wait is bounded: a case that
deadlocks fails after ``timeout`` seconds, the ranks are killed and the
next case starts fresh ones.  :func:`one_rank` is a one-process Gloo
group in the test's own process, for the checks that need a mesh but no
second rank.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np

GROUP_TIMEOUT = 60  # seconds: a collective that waits longer raises
JOIN_TIMEOUT = 10


def _worker(rank, world, init_file, tasks, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except Exception as e:  # reported to the test, which decides
            results.put((rank, False, (type(e).__name__, str(e),
                                       traceback.format_exc())))
    dist.destroy_process_group()


class RankError(Exception):
    """A case raised on a rank: ``kind`` and ``message`` are the
    exception's type name and text."""

    def __init__(self, kind, message, tb):
        super().__init__(f"{kind}: {message}\n{tb}")
        self.kind, self.message = kind, message


class Ranks:
    def __init__(self, n: int, timeout: float = 120.0):
        self.n, self.timeout = n, timeout
        self.procs = []

    def _start(self):
        ctx = mp.get_context("spawn")
        self.dir = tempfile.TemporaryDirectory()
        init_file = os.path.join(self.dir.name, "rendezvous")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(self.n)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.n, init_file, self.tasks[r],
                                        self.results))
                      for r in range(self.n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on every rank; the results by rank.  A
        case that raised on any rank raises :class:`RankError` (rank 0's,
        or the first one's) after every rank has answered."""
        if not self.procs:
            self._start()
        for q in self.tasks:
            q.put((fn, args, kwargs))
        got = {}
        try:
            while len(got) < self.n:
                rank, ok, value = self.results.get(timeout=self.timeout)
                got[rank] = (ok, value)
        except queue.Empty:
            self.close(kill=True)
            raise TimeoutError(f"{fn.__name__}: {self.n - len(got)} rank(s) gave "
                               f"no answer within {self.timeout} s") from None
        errors = [got[r][1] for r in range(self.n) if not got[r][0]]
        if errors:
            raise RankError(*errors[0])
        return [got[r][1] for r in range(self.n)]

    def solve(self, fn, *args, **kwargs):
        """:func:`call` on every rank: rank 0's fields, once every rank's
        are checked bit-identical to them."""
        return same_on_ranks(self.run(call, fn, *args, **kwargs))

    def close(self, kill=False):
        if not self.procs:
            return
        if not kill:
            for q in self.tasks:
                q.put(None)
        for p in self.procs:
            p.join(JOIN_TIMEOUT if not kill else 0)
            if p.is_alive():
                p.kill()
                p.join(JOIN_TIMEOUT)
        self.procs = []
        self.dir.cleanup()


@contextlib.contextmanager
def one_rank():
    """A one-rank Gloo process group in this process, torn down on exit."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        try:
            yield
        finally:
            dist.destroy_process_group()


_MESHES: dict = {}


def mesh_of(kind):
    """This rank's mesh of ``kind``: "1d" (every rank on the sample axis)
    or "2d" (a (2, world/2) grid), built once per process."""
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    import torch.distributed as dist
    if kind not in _MESHES:
        world = dist.get_world_size()
        _MESHES[kind] = (make_mesh(world, device_type="cpu") if kind == "1d"
                         else make_mesh(shape=(2, world // 2), device_type="cpu"))
    return _MESHES[kind]


def call(fn, *args, mesh=None, fields=("W", "H", "cost"), **kwargs):
    """Rank side: ``fn`` (a dotted name, e.g. "nmf_toolbox_tpu_torch.nmf")
    called with ``mesh=mesh_of(mesh)``; its Result's ``fields`` as NumPy."""
    import importlib
    mod, name = fn.rsplit(".", 1)
    f = getattr(importlib.import_module(mod), name)
    if mesh is not None:
        kwargs["mesh"] = mesh_of(mesh)
    return result_fields(f(*args, **kwargs), fields)


def call_counted(fn, *args, **kwargs):
    """Rank side: :func:`call`, with the host reads the call made
    (``core.host_reads``: line-search trials, projection groups, stop
    rule)."""
    from nmf_toolbox_tpu_torch import core
    before = core.host_reads
    out = call(fn, *args, **kwargs)
    out["host_reads"] = core.host_reads - before
    return out


def profiled_spans(fn):
    """``fn()`` under ``torch.profiler`` (CPU activity): its result and
    the spans it recorded (``user_annotation`` events of the exported
    trace) as ``(name, start_us, end_us)`` in the order they start."""
    import json
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation")
    return out, [(name, s, e) for s, e, name in spans]


def collective_spans(fn, *args, **kwargs):
    """Rank side: :func:`call` under the profiler; the names of the
    ``collectives.*`` spans it recorded, in order, and the collectives it
    issued (``collectives.calls``)."""
    from nmf_toolbox_tpu_torch.parallel import collectives
    before = collectives.calls
    _, spans = profiled_spans(lambda: call(fn, *args, **kwargs))
    return ([name for name, _, _ in spans if name.startswith("collectives.")],
            collectives.calls - before)


def streaming(V, k, draws, mesh, **kwargs):
    """Rank side: ``nmf_streaming`` on the mesh, its block inits the
    arrays ``draws`` in order (as the JAX package's are patched to)."""
    import importlib
    import torch
    mod = importlib.import_module("nmf_toolbox_tpu_torch.models.streaming")
    it = iter(draws)
    orig = mod.uniform_init
    mod.uniform_init = lambda *a, **kw: torch.from_numpy(next(it))
    try:
        return call("nmf_toolbox_tpu_torch.nmf_streaming", V, k, mesh=mesh, **kwargs)
    finally:
        mod.uniform_init = orig


def sample_block(x, mesh):
    """This rank's block of x's last axis, sharded over the sample axis."""
    import torch
    b = x.shape[-1] // mesh.size("n")
    c = mesh.coord("n")
    return torch.from_numpy(np.ascontiguousarray(x[..., c * b:(c + 1) * b]))


def halos(x, width, kind):
    """Rank side: the left and right halos of width ``width`` of this
    rank's block of x."""
    from nmf_toolbox_tpu_torch.parallel.collectives import halo
    mesh = mesh_of(kind)
    blk = sample_block(x, mesh)
    return halo(mesh, blk, width, "left").numpy(), halo(mesh, blk, width, "right").numpy()


def shift_ops(H, Y, T, n_valid, kind):
    """Rank side: ``stack_shifts_right`` of this rank's block of H and
    ``shift_sum`` of its block of Y (..., T, k, n), on the mesh."""
    from nmf_toolbox_tpu_torch.ops.shift import shift_sum, stack_shifts_right
    mesh = mesh_of(kind)
    return (stack_shifts_right(sample_block(H, mesh), T, n_valid, mesh).numpy(),
            shift_sum(sample_block(Y, mesh), mesh).numpy())


def consensus(V, mesh, **kwargs):
    """Rank side: ``consensus_stability`` on the mesh; its recommendation
    and per-rank (consensus, cophenetic, mean cost)."""
    import nmf_toolbox_tpu_torch as nt
    sel = nt.consensus_stability(V, mesh=mesh_of(mesh), **kwargs)
    return sel.recommended, [(s.consensus, s.cophenetic, s.mean_cost)
                             for s in sel.stats]


def estimator(X, mesh, **kwargs):
    """Rank side: ``estimators.NMF(mesh=...).fit_transform(X)``; the
    components, the transform and the cost trace."""
    from nmf_toolbox_tpu_torch.estimators import NMF
    est = NMF(mesh=mesh_of(mesh), **kwargs)
    H = est.fit_transform(X)
    return est.components_, H, est.cost_trace_


def run_cli(argv):
    """Rank side: ``cli.main(argv)`` in this process; (exit code, stdout)."""
    import contextlib
    import io
    from nmf_toolbox_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def host(x):
    """A result as NumPy: tensors (and lists of them) to arrays."""
    import torch
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x) if isinstance(x, np.ndarray) else x


def result_fields(res, fields=("W", "H", "cost")):
    """The named fields of a solver Result as NumPy, with n_iters."""
    out = {f: host(getattr(res, f)) for f in fields}
    out["n_iters"] = int(res.n_iters)
    return out


def same_on_ranks(results):
    """Rank 0's result, after checking every rank's is bit-identical."""
    assert_ranks_identical(results)
    return results[0]


def assert_ranks_identical(results):
    """Every rank's result is bit-identical to rank 0's."""
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        _identical(first, other, f"rank {r}")


def _identical(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _identical(a[k], b[k], f"{where} {k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _identical(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# Targets of chip_smoke.spawn_ranks: target(rank, tmp, queue) in a fresh
# spawned process that has joined no group; each puts (rank, value).
# ---------------------------------------------------------------------------

def gloo_sum(rank, tmp, queue):
    """Join a Gloo group of four through a ``file://`` rendezvous in
    ``tmp``, sum the ranks and leave it; this process' pid, its
    ``LOCAL_RANK`` and the sum."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=4,
                            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    dist.destroy_process_group()
    queue.put((rank, {"pid": os.getpid(), "local_rank": os.environ["LOCAL_RANK"],
                      "sum": float(t)}))


def fail_on_two(rank, tmp, queue):
    """Rank 2 reports an error, the others their pid."""
    queue.put((rank, {"error": "rank 2 failed"} if rank == 2 else {"pid": os.getpid()}))


def cli_own_group(rank, tmp, queue):
    """``cli.main`` as a torchrun rank of two (the environment torchrun
    sets, the port in ``tmp/port``, the arguments in ``tmp/argv.json``):
    the exit code and whether a process group is left after it."""
    import json
    import pathlib
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=pathlib.Path(tmp, "port").read_text())
    argv = json.loads(pathlib.Path(tmp, "argv.json").read_text())
    rc, _ = run_cli(argv + ["--out", f"{tmp}/own{rank}.npz"])
    queue.put((rank, {"rc": rc, "initialized_after": dist.is_initialized()}))


def cli_kept_group(argv):
    """Rank side: ``cli.main`` inside the caller's process group; the
    exit code and whether that group is still there after it."""
    import torch.distributed as dist
    rc, _ = run_cli(argv)
    return rc, dist.is_initialized()


def build_library(rank, tmp, queue):
    """``_build.build`` with the fake ``nvcc`` under ``tmp/cuda/bin`` and
    the build directory ``tmp/build``: the library's path and bytes."""
    import pathlib
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    os.environ["CUDA_HOME"] = f"{tmp}/cuda"
    _build.PKG_BUILD_DIR = _build.CACHE_BUILD_DIR = pathlib.Path(tmp, "build")
    out = _build.build()
    queue.put((rank, {"path": str(out), "bytes": out.read_bytes()}))
