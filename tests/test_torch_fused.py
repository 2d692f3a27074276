"""Port's fused KL/IS kernels (nmf_toolbox_tpu_torch/ops/kernels/fused.py).

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX package's Pallas kernels, run as its own tests run them
(interpreter mode, f32).  Tests marked ``cuda`` hold each CUDA kernel
against its plain version on a card and skip without one.  They import
no JAX, so a machine with a card and no JAX runs them with

    python -m pytest tests/test_torch_fused.py -m cuda --noconftest
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu_torch.ops.kernels import fused as fk  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
# tests/test_pallas.py's f32 threshold: both sides form V_hat and the
# contractions in f32, in different summation orders.
REL_TOL = 1e-4
KERNELS = ("phi_dot_ht", "wt_dot_phi", "cost_terms")


def make(m=300, n=700, k=40, seed=0):
    """Non-tile-aligned shapes, as tests/test_pallas.py uses."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0.1, 1, s).astype(np.float32)
                 for s in ((m, n), (m, k), (k, n)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def counts():
    return tuple(getattr(fk, f"{name}_launches") for name in KERNELS)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("mode", ["kl", "is"])
def test_plain_version_matches_pallas(name, mode):
    jnp = pytest.importorskip("jax.numpy")
    from nmf_toolbox_tpu.ops import pallas as jk
    V, W, H = make(seed=KERNELS.index(name) + (3 if mode == "is" else 0))
    want = as_tuple(getattr(jk, name)(jnp.asarray(V), jnp.asarray(W),
                                      jnp.asarray(H), mode))
    before = counts()
    got = as_tuple(getattr(fk, name)(*(torch.from_numpy(x) for x in (V, W, H)), mode))
    assert counts() == before  # CPU tensors never launch a kernel
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert tuple(g.shape) == np.shape(w)
        assert rel(g.numpy(), w) < REL_TOL


def test_wrapper_is_its_plain_version_on_cpu():
    V, W, H = (torch.from_numpy(x) for x in make(40, 50, 7, seed=9))
    for name in KERNELS:
        for mode in ("kl", "is"):
            got = as_tuple(getattr(fk, name)(V, W, H, mode))
            want = as_tuple(getattr(fk, f"{name}_reference")(V, W, H, mode))
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_input_checks():
    V, W, H = (torch.from_numpy(x) for x in make(20, 30, 5))
    for name in KERNELS:
        fn = getattr(fk, name)
        with pytest.raises(ValueError):
            fn(V, W, H, "euclidean")
        with pytest.raises(TypeError):
            fn(V.double(), W.double(), H.double(), "kl")
        with pytest.raises(TypeError):
            fn(V[0], W, H, "kl")
        with pytest.raises(ValueError):
            fn(V, W[:, :4], H, "kl")
        with pytest.raises(ValueError):
            fn(V, torch.ones(20, 1025), torch.ones(1025, 30), "kl")
        with pytest.raises(ValueError):
            fn(V.to("meta"), W.to("meta"), H.to("meta"), "kl")


def test_import_builds_nothing_and_never_imports_jax():
    code = (
        "import sys\n"
        "import nmf_toolbox_tpu_torch, nmf_toolbox_tpu_torch.interop\n"
        "from nmf_toolbox_tpu_torch.ops.kernels import _build, fused, fused_dma, naive_kl\n"
        "from nmf_toolbox_tpu_torch.models import batched, hals, streaming\n"
        "import nmf_toolbox_tpu_torch.models.lnmf, nmf_toolbox_tpu_torch.models.seminmf\n"
        "import nmf_toolbox_tpu_torch.models.convexnmf, nmf_toolbox_tpu_torch.models.chnmf\n"
        "import nmf_toolbox_tpu_torch.models.symnmf, nmf_toolbox_tpu_torch.models.constrainednmf\n"
        "from nmf_toolbox_tpu_torch import rank\n"
        "from nmf_toolbox_tpu_torch.utils import init\n"
        "import nmf_toolbox_tpu_torch.cli, nmf_toolbox_tpu_torch.__main__\n"
        "import nmf_toolbox_tpu_torch.estimators, nmf_toolbox_tpu_torch.native as native\n"
        "from nmf_toolbox_tpu_torch.utils import checkpoint, io, viz, debug\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'nmf_toolbox_tpu'], "
        "'nmf_toolbox_tpu imported'\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
        "assert _build.load.cache_info().currsize == 0, 'library loaded'\n"
        "assert native._lib is None and not native._tried, 'native library loaded'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("mode", ["kl", "is"])
# k: the MMA granule's edges (1, 8), one chunk (40, 100), two chunks (129),
# eight (1024); (m, n): one span, several, and no multiple of any tile.
@pytest.mark.parametrize("k", [1, 8, 40, 100, 129, 1024])
@pytest.mark.parametrize("m,n", [(300, 700), (1000, 2000), (257, 513)])
def test_kernel_matches_plain_version_on_card(cuda, name, mode, k, m, n):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(m, n, k))
    fn = getattr(fk, name)
    before = getattr(fk, f"{name}_launches")
    got = as_tuple(fn(V, W, H, mode))
    torch.cuda.synchronize()
    assert getattr(fk, f"{name}_launches") == before + 1
    want = as_tuple(getattr(fk, f"{name}_reference")(V, W, H, mode))
    for g, w in zip(got, want):
        assert g.device == V.device and g.shape == w.shape
        assert rel(g.cpu().numpy(), w.cpu().numpy()) < REL_TOL
    if name == "cost_terms":  # fixed-order reduction: same bits every run
        again = as_tuple(fn(V, W, H, mode))
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi_dot_ht", "wt_dot_phi"])
@pytest.mark.parametrize("mode", ["kl", "is"])
@pytest.mark.parametrize("m,n,k", [(1000, 2000, 100), (4000, 3000, 100), (257, 513, 129)])
def test_phase_kernels_are_deterministic_on_card(cuda, name, mode, m, n, k):
    """Span partials are added in a fixed order: same bits on every call."""
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(m, n, k, seed=5))
    fn = getattr(fk, name)
    first = as_tuple(fn(V, W, H, mode))
    for _ in range(2):
        again = as_tuple(fn(V, W, H, mode))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_card_rejects_non_contiguous(cuda):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(30, 40, 5))
    with pytest.raises(ValueError, match="contiguous"):
        fk.phi_dot_ht(V.T.contiguous().T, W, H, "kl")
