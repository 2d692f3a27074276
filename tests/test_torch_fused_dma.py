"""Port's streamed KL W-phase kernel
(nmf_toolbox_tpu_torch/ops/kernels/fused_dma.py).

On the CPU the wrapper runs its plain PyTorch version, held against the
JAX package's Pallas kernel run as tests/test_pallas.py runs it
(interpreter mode).  That kernel feeds bf16 to its dots, so the two agree
to 5e-3 relative (test_pallas.py's threshold for it); the port's plain
version is f32 throughout and agrees with an f64 NumPy reference to 1e-4.
Tests marked ``cuda`` hold the CUDA kernel against its plain version on a
card and skip without one; they import no JAX:

    python -m pytest tests/test_torch_fused_dma.py -m cuda --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu_torch.ops.kernels import _build  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk  # noqa: E402

REL_TOL = 1e-4       # f32 vs f64, and kernel vs plain version (test_pallas.py)
PALLAS_TOL = 5e-3    # the Pallas kernel's bf16 dots (test_pallas.py:102-103)


def make(m=300, n=700, k=40, seed=7):
    """Non-tile-aligned shapes, as tests/test_pallas.py uses."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0.1, 1, s).astype(np.float32)
                 for s in ((m, n), (m, k), (k, n)))


def f64_reference(V, W, H):
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    return (V / (W @ H)) @ H.T


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6))


def test_plain_version_matches_pallas_interpret():
    jnp = pytest.importorskip("jax.numpy")
    from nmf_toolbox_tpu.ops.pallas.fused_dma import kl_phi_dot_ht_dma
    V, W, H = make()
    want = np.asarray(kl_phi_dot_ht_dma(*(jnp.asarray(x) for x in (V, W, H))))
    before = dk.kl_phi_dot_ht_dma_launches
    got = dk.kl_phi_dot_ht_dma(*(torch.from_numpy(x) for x in (V, W, H)))
    assert dk.kl_phi_dot_ht_dma_launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (300, 40)
    assert rel(got.numpy(), want) < PALLAS_TOL
    ref = f64_reference(V, W, H)
    assert rel(got.numpy(), ref) < REL_TOL
    assert rel(want, ref) < PALLAS_TOL


@pytest.mark.parametrize("m,n,k", [(300, 700, 40), (33, 29, 1), (64, 96, 512)])
def test_plain_version_matches_f64(m, n, k):
    V, W, H = make(m, n, k, seed=m + k)
    got = dk.kl_phi_dot_ht_dma(*(torch.from_numpy(x) for x in (V, W, H)))
    assert torch.equal(got, dk.kl_phi_dot_ht_dma_reference(
        *(torch.from_numpy(x) for x in (V, W, H))))
    assert rel(got.numpy(), f64_reference(V, W, H)) < REL_TOL


def test_guards():
    V, W, H = (torch.from_numpy(x) for x in make(20, 30, 5))
    for k in (0, 513):  # the Pallas kernel's scope is 1 <= k <= 512
        with pytest.raises(ValueError, match="512"):
            dk.kl_phi_dot_ht_dma(V, torch.ones(20, k), torch.ones(k, 30))
    with pytest.raises(ValueError):
        dk.kl_phi_dot_ht_dma(V, W[:, :4], H)
    with pytest.raises(ValueError):
        dk.kl_phi_dot_ht_dma(V[:10], W, H)
    with pytest.raises(TypeError):
        dk.kl_phi_dot_ht_dma(V.double(), W.double(), H.double())
    with pytest.raises(TypeError):
        dk.kl_phi_dot_ht_dma(V[0], W, H)
    with pytest.raises(ValueError):
        dk.kl_phi_dot_ht_dma(V.to("meta"), W.to("meta"), H.to("meta"))


def test_build_covers_every_source(monkeypatch, tmp_path):
    """The library is built from every csrc/*.cu, and its name hashes
    all of them and the headers they include, so editing any one source
    or header gives a new build."""
    assert [p.name for p in _build.sources()] == ["fused.cu", "fused_dma.cu", "hoyer.cu",
                                                  "naive_kl.cu"]
    assert [p.name for p in _build.headers()] == ["tile_ops.cuh"]
    for p in _build.sources() + _build.headers():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    seen = {_build.library_path()}
    assert next(iter(seen)).name.startswith("libnmf_kernels_")
    for name in ("fused_dma.cu", "hoyer.cu", "naive_kl.cu", "tile_ops.cuh"):
        (tmp_path / name).write_text((tmp_path / name).read_text() + "\n// edited\n")
        seen.add(_build.library_path())
    assert len(seen) == 5
    assert "nmf_kl_phi_dot_ht_dma" in _build._SIGNATURES
    assert "nmf_hoyer_project" in _build._SIGNATURES
    assert {"nmf_kl_field", "nmf_kl_cost_partials", "nmf_kl_cost"} <= set(_build._SIGNATURES)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Ragged and odd shapes, k = 1, and both sides of each tier edge (128,
# 256, 424) up to k = 512.
CARD_SHAPES = [(300, 700, 40), (301, 701, 40), (300, 703, 1), (1000, 999, 300),
               (20_000, 5_000, 100), (2000, 3000, 128), (2000, 3000, 129),
               (2000, 3000, 256), (2000, 3000, 257), (2000, 3000, 424),
               (2000, 3000, 425), (2000, 3000, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", CARD_SHAPES)
def test_kernel_matches_plain_version_on_card(cuda, m, n, k):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(m, n, k))
    before = dk.kl_phi_dot_ht_dma_launches
    got = dk.kl_phi_dot_ht_dma(V, W, H)
    torch.cuda.synchronize()
    assert dk.kl_phi_dot_ht_dma_launches == before + 1
    want = dk.kl_phi_dot_ht_dma_reference(V, W, H)
    assert got.device == V.device and got.shape == want.shape
    assert rel(got.cpu().numpy(), want.cpu().numpy()) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", [100, 200, 512])
def test_kernel_reruns_bit_identical_on_card(cuda, k):
    """A block owns its output rows for the whole n loop, with no atomics:
    two runs give the same bits."""
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(1000, 2000, k))
    assert torch.equal(dk.kl_phi_dot_ht_dma(V, W, H), dk.kl_phi_dot_ht_dma(V, W, H))


@pytest.mark.cuda
def test_card_guards(cuda):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in make(30, 40, 5))
    with pytest.raises(ValueError, match="contiguous"):
        dk.kl_phi_dot_ht_dma(V.T.contiguous().T, W, H)
    with pytest.raises(ValueError, match="512"):
        dk.kl_phi_dot_ht_dma(V, torch.ones(30, 513, device=cuda),
                             torch.ones(513, 40, device=cuda))
