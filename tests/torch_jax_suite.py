"""The JAX package's own test modules, run against the port.

:func:`collect` loads a test module of this directory (``tests/test_nmf.py``
and so on) under a name of its own, with :func:`port_import` as its
``__import__``: every import of the JAX package, at the module's top and
inside a test alike, gets the port's module of the same path behind a
:class:`Shim`, which calls the port's functions with ``device="cpu"``
unless the test names a device and returns their results as NumPy, as
the JAX package returns them.  The test files themselves are not
touched.  A test that never reads the port (one that drives only JAX, a
subprocess or a benchmark script) fails (:func:`_reaches_the_port`).
The tests that stay with the JAX package are left out by name, each with
its reason; :func:`collect` fails when such a name no longer exists, so
the list cannot go stale.  A ``tests/test_torch_jax_suite_*.py`` file
puts what it collects into its own namespace, named
``test_<module>__<test>``, where pytest finds it.
"""
from __future__ import annotations

import builtins
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import inspect
import io
import pathlib
import subprocess
import sys
import traceback
import types

import numpy as np
import pytest
import torch

import nmf_toolbox_tpu_torch as port

TESTS = pathlib.Path(__file__).resolve().parent
REACHED = [0]  # reads of the port through a Shim, and calls through on_cpu

# Left out everywhere: the JAX package's tests that no port call can pass.
MESH = "hands the port a JAX Mesh, which it refuses on purpose (mesh.check_mesh); " \
       "tests/test_torch_parallel*.py hold mesh= against the JAX package"
SEEDED = "a threshold tuned to the JAX package's seeded default draws; the port " \
         "draws default inits from a torch.Generator (ROADMAP, intended differences)"
DEVICE_OUTPUT = "device_output= selects JAX arrays on the device; the port's " \
                "engines accept it and ignore it (ROADMAP, intended differences)"
TORCH_ARGS = "passes a JAX {} where the port takes a torch {} (ROADMAP, intended differences)"
JAX_ONLY = "drives only the JAX package ({}); it never reaches the port"
JAX_INTERNALS = "reaches into the JAX package's internals ({}), which the port does not have"


def host(x):
    """A port result as the JAX package returns it: tensors as NumPy
    (bfloat16 widened to float32), recursively through Results, lists,
    tuples and dicts."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, port.Result):
        return dataclasses.replace(x, **{f.name: host(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if f.name not in ("fields", "n_iters", "converged")})
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(host(v) for v in x)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


@functools.cache
def on_cpu(fn):
    """``fn`` with ``device="cpu"`` unless given where it takes a device,
    else with its NumPy arguments as CPU tensors (unless it is declared to
    take NumPy); its result through :func:`host`."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):  # a builtin without a signature
        params = []
    takes_device = any(p.name == "device" or p.kind is p.VAR_KEYWORD for p in params)
    takes_numpy = bool(params) and "ndarray" in str(params[0].annotation)
    takes_argv = bool(params) and params[0].name == "argv"

    @functools.wraps(fn)
    def call(*args, **kwargs):
        REACHED[0] += 1
        if takes_argv and args and "--device" not in args[0]:  # the CLI: its flag
            args = ([*args[0], "--device", "cpu"], *args[1:])
        if takes_device:
            kwargs.setdefault("device", "cpu")
        elif not takes_numpy:  # a function on tensors: NumPy arguments become CPU tensors
            args = tuple(tensor(a) for a in args)
            kwargs = {k: tensor(v) for k, v in kwargs.items()}
        return host(fn(*args, **kwargs))
    call.__port__ = fn  # what Shim.__setattr__ puts back (monkeypatch's undo)
    return call


@functools.cache
def on_cpu_class(cls):
    """``cls``, or where its constructor takes a device (the estimator) a
    subclass of it that passes ``device="cpu"`` unless given; each instance
    made counts as reaching the port."""
    try:
        params = inspect.signature(cls).parameters.values()
    except (TypeError, ValueError):
        return cls
    if not any(p.name == "device" or p.kind is p.VAR_KEYWORD for p in params):
        return cls

    def __init__(self, *args, **kwargs):
        REACHED[0] += 1
        kwargs.setdefault("device", "cpu")
        cls.__init__(self, *args, **kwargs)
    return type(cls.__name__, (cls,), {"__init__": __init__, "__port__": cls,
                                       "__module__": cls.__module__})


def is_jax_array(x) -> bool:
    jax = sys.modules.get("jax")
    return jax is not None and isinstance(x, jax.Array)


def from_jax(x):
    """A JAX array as a CPU tensor, through tuples and lists."""
    if is_jax_array(x):
        return torch.from_numpy(np.array(x))
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(from_jax(v) for v in x)
    return x


def tensor(x):
    """A NumPy array, or a JAX array a test made (``jnp.asarray``), as a CPU
    tensor; a test's own function that the port calls back (a loop's step)
    with its JAX results as tensors; anything else as it is."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, types.FunctionType) and not hasattr(x, "__port__"):
        return functools.wraps(x)(lambda *args, **kwargs: from_jax(x(*args, **kwargs)))
    return from_jax(x)


class Shim(types.ModuleType):
    """A port module behind the JAX package's module of the same path:
    each function through :func:`on_cpu`, each submodule as a Shim,
    classes and constants as the port has them.  Setting an attribute
    (``monkeypatch.setattr``) sets it on the port's module.  Every read
    counts as reaching the port (:data:`REACHED`)."""

    def __init__(self, module):
        super().__init__(module.__name__)
        vars(self)["_module"] = module

    def __getattr__(self, name):
        REACHED[0] += 1
        module = vars(self)["_module"]
        try:
            obj = getattr(module, name)
        except AttributeError:
            try:
                obj = importlib.import_module(f"{module.__name__}.{name}")
            except ModuleNotFoundError:
                raise AttributeError(f"the port's {module.__name__} has no {name}") from None
        if isinstance(obj, types.ModuleType):
            return shim(obj)
        if isinstance(obj, type):
            return on_cpu_class(obj)
        if callable(obj):
            return on_cpu(obj)
        return obj

    def __setattr__(self, name, value):
        setattr(vars(self)["_module"], name, getattr(value, "__port__", value))

    def __delattr__(self, name):
        delattr(vars(self)["_module"], name)


@functools.cache
def shim(module) -> Shim:
    return Shim(module)


SHIM = shim(port)


def port_name(name: str) -> str:
    """The port's module for a JAX module path: the same path under
    ``nmf_toolbox_tpu_torch``, with ``ops.pallas`` (the Pallas kernels) as
    ``ops.kernels`` (their CUDA counterparts, the same signatures)."""
    name = "nmf_toolbox_tpu_torch" + name[len("nmf_toolbox_tpu"):]
    return name.replace(".ops.pallas", ".ops.kernels")


def run_port_cli(argv):
    """The port's CLI, ``cli.main(argv)`` with ``--device cpu`` unless
    given, in this process, as a finished ``python -m`` command: its exit
    code, standard output and standard error (an uncaught exception as a
    traceback and code 1, as the interpreter reports it)."""
    from nmf_toolbox_tpu_torch import cli
    REACHED[0] += 1
    argv = [*argv, "--device", "cpu"] if "--device" not in argv else list(argv)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = cli.main(argv) or 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
            if not isinstance(e.code, (int, type(None))):
                print(e.code, file=sys.stderr)
        except Exception:  # the interpreter's report of an uncaught exception
            traceback.print_exc()
            code = 1
    return subprocess.CompletedProcess(["python", "-m", "nmf_toolbox_tpu_torch", *argv],
                                       code, out.getvalue(), err.getvalue())


class Subprocess(types.ModuleType):
    """``subprocess`` for a loaded test module: ``run`` of ``[python, "-m",
    "nmf_toolbox_tpu", *argv]`` (the JAX package's CLI) runs the port's CLI
    instead (:func:`run_port_cli`); every other command and name is the
    real module's."""

    def __init__(self):
        super().__init__("subprocess")

    def __getattr__(self, name):
        return getattr(subprocess, name)

    @staticmethod
    def run(cmd, *args, **kwargs):
        cmd = list(cmd) if isinstance(cmd, (list, tuple)) else cmd
        if isinstance(cmd, list) and cmd[1:3] == ["-m", "nmf_toolbox_tpu"]:
            return run_port_cli([str(a) for a in cmd[3:]])
        return subprocess.run(cmd, *args, **kwargs)


SUBPROCESS = Subprocess()


def port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` with the JAX package's modules replaced by the
    port's of the same path (:func:`port_name`), as :class:`Shim`\\ s;
    ``subprocess`` as :class:`Subprocess`, and a test module of this
    directory as :func:`load` makes it."""
    if level == 0 and (name == "nmf_toolbox_tpu" or name.startswith("nmf_toolbox_tpu.")):
        module = importlib.import_module(port_name(name))
        return shim(module) if fromlist else SHIM
    if level == 0 and name == "subprocess":
        return SUBPROCESS
    if level == 0 and name.startswith("test_") and (TESTS / f"{name}.py").is_file():
        return load(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


@pytest.fixture(autouse=True)
def _reaches_the_port():
    """Fails a test that never read the port: one that reached only JAX."""
    before = REACHED[0]
    yield
    assert REACHED[0] > before, "the test never reached the port"


def load(module: str) -> types.ModuleType:
    """``tests/<module>.py`` executed once with :func:`port_import` as its
    ``__import__`` (at the module's top and inside every test)."""
    name = f"torch_jax_suite.{module}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, TESTS / f"{module}.py")
        mod = importlib.util.module_from_spec(spec)
        mod.__builtins__ = {**vars(builtins), "__import__": port_import}
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def collect(module: str, excluded: dict[str, str]) -> dict:
    """The tests, test classes and fixtures of ``tests/<module>.py``
    (:func:`load`), under the names a suite file exposes; ``excluded``
    maps each left-out test to its reason."""
    mod = load(module)
    missing = sorted(set(excluded) - set(vars(mod)))
    if missing:
        raise LookupError(f"{module}: excluded tests not found: {missing}")
    out = {"_reaches_the_port": _reaches_the_port}
    for name, obj in vars(mod).items():
        if name in excluded:
            continue
        if name.startswith("Test") and isinstance(obj, type):
            out[f"Test_{module[5:]}__{name[4:]}"] = obj
        elif name.startswith("test") and callable(obj):
            out[f"test_{module[5:]}__{name.removeprefix('test_').removeprefix('test')}"] = obj
        elif type(obj).__name__ == "FixtureFunctionDefinition":
            out[name] = obj
    return out


def suite(excluded: dict[str, dict[str, str]]) -> dict:
    """:func:`collect` of each module named in ``excluded`` (module ->
    its left-out tests), merged; two modules' fixtures of one name are
    an error, as one would shadow the other."""
    out = {}
    for module, left_out in excluded.items():
        for name, obj in collect(module, left_out).items():
            if name in out and out[name] is not obj:
                raise NameError(f"{module}: {name} is also defined by an earlier module")
            out[name] = obj
    return out


