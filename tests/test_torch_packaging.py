"""What the port ships and exports: package-data covers every source its
builds read, and ``ops.__all__`` / ``utils.__all__`` match the JAX
package's."""
import fnmatch
import pathlib
import re
import tomllib

import pytest

pytest.importorskip("torch")

import nmf_toolbox_tpu.ops as jops  # noqa: E402
import nmf_toolbox_tpu.utils as jutils  # noqa: E402
import nmf_toolbox_tpu_torch.ops as tops  # noqa: E402
import nmf_toolbox_tpu_torch.utils as tutils  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "nmf_toolbox_tpu_torch"


def shipped(path: pathlib.Path) -> bool:
    """Whether a package-data glob of pyproject.toml covers ``path``."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]
    for package, patterns in globs.items():
        root = REPO.joinpath(*package.split("."))
        try:
            rel = path.relative_to(root).as_posix()
        except ValueError:
            continue
        if any(fnmatch.fnmatch(rel, pat) for pat in patterns):
            return True
    return False


def test_package_data_covers_every_build_input():
    """An installed port builds from the installed files: every CUDA
    source, every header a source includes, and the native C++ source
    are package data."""
    sources = sorted((PKG / "csrc").glob("*.cu")) + sorted((PKG / "native").glob("*.cpp"))
    assert sources and any(p.suffix == ".cpp" for p in sources)
    needed = set(sources)
    for src in list(sources) + sorted((PKG / "csrc").glob("*.cuh")):
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            header = (src.parent / name).resolve()
            assert header.is_file(), f"{src.name} includes missing {name}"
            needed.add(header)
    assert PKG / "csrc" / "tile_ops.cuh" in needed
    missing = sorted(str(p.relative_to(REPO)) for p in needed if not shipped(p))
    assert not missing, f"not in pyproject.toml's package-data: {missing}"


def test_console_script_names_the_port_cli():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["nmf-tpu-torch"] == "nmf_toolbox_tpu_torch.cli:main"
    assert scripts["nmf-tpu"] == "nmf_toolbox_tpu.cli:main"


def test_ops_all_equals_jax():
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert getattr(tops, name) is not None
    from nmf_toolbox_tpu_torch.ops import canon, loop, projfunc  # noqa: F401
    assert tops.loop.__name__ == "nmf_toolbox_tpu_torch.ops.loop"
    assert tops.canon("KL") == jops.canon("KL")


def test_utils_all_equals_jax_less_orbax():
    """Every name of the JAX package's utils is the port's own, the
    directory checkpoints of sharded runs (save_factors_orbax,
    load_factors_orbax, wait_for_saves, on torch.distributed.checkpoint)
    included."""
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert getattr(tutils, name).__module__.startswith("nmf_toolbox_tpu_torch.")


def test_every_jax_test_module_is_collected():
    """Every test module of the JAX package (tests/test_*.py but the
    port's own) is collected by a tests/test_torch_jax_suite_*.py file."""
    here = REPO / "tests"
    named = set()
    for path in here.glob("test_torch_jax_suite_*.py"):
        named |= set(re.findall(r'^    "(test_\w+)": ', path.read_text(), re.M))
    jax_modules = {p.stem for p in here.glob("test_*.py") if not p.stem.startswith("test_torch_")}
    assert len(jax_modules) == 44 and jax_modules == named


def test_module_trees_match_the_jax_package():
    """The two packages list the same modules, apart from the kernels'
    folder (ops/pallas <-> ops/kernels) and the port's own interop.py and
    parallel/collectives.py; utils.debug has the emulation's counterpart."""
    def modules(root, kernels):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if not p.relative_to(root).as_posix().startswith(kernels)}
    jax_modules = modules(REPO / "nmf_toolbox_tpu", "ops/pallas/")
    port_modules = modules(PKG, "ops/kernels/")
    assert port_modules - jax_modules == {"interop.py", "parallel/collectives.py"}
    assert jax_modules <= port_modules and "utils/deviceprobe.py" in port_modules
    from nmf_toolbox_tpu.utils import debug as jdebug
    from nmf_toolbox_tpu_torch.utils import debug
    assert callable(jdebug.emulate_tpu_matmul_numerics)
    assert callable(debug.emulate_card_matmul_numerics)
