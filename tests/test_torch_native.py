"""The port's native host layer (``nmf_toolbox_tpu_torch.native``): its
monotone-chain hull and threaded loader against the JAX package's copy
and against the port's Python fallbacks.  Mirrors tests/test_native.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu import native as jnative  # noqa: E402
from nmf_toolbox_tpu_torch import native  # noqa: E402
from nmf_toolbox_tpu_torch.utils import init as ti  # noqa: E402
from nmf_toolbox_tpu_torch.utils.io import load_matrix, save_matrix  # noqa: E402

needs_native = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")


@pytest.fixture
def python_chain(monkeypatch):
    """The port with its native library switched off."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "convhull2d", lambda points: None)
    monkeypatch.setattr(native, "load_bytes", lambda *a, **k: False)


@needs_native
def test_native_hull_matches_support_function():
    rng = np.random.default_rng(0)
    for n in (10, 100, 5000):
        pts = rng.normal(size=(n, 2))
        idx = native.convhull2d(pts)
        hull = pts[idx]
        for a in np.linspace(0, 2 * np.pi, 48):
            d = np.array([np.cos(a), np.sin(a)])
            assert np.max(pts @ d) <= np.max(hull @ d) + 1e-9


@needs_native
def test_native_hull_degenerate():
    pts = np.array([[0.0, 0.0], [1.0, 1.0]])
    assert set(native.convhull2d(pts).tolist()) == {0, 1}
    # collinear points: the hull is the two extremes
    pts = np.stack([np.arange(5.0), np.arange(5.0)], 1)
    idx = native.convhull2d(pts)
    assert 0 in idx and 4 in idx


@needs_native
def test_loader_npy_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(513, 401)).astype(np.float32)
    p = str(tmp_path / "a.npy")
    save_matrix(p, A)
    np.testing.assert_array_equal(load_matrix(p), A)


@needs_native
def test_loader_raw_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(100, 37)).astype(np.float64)
    p = str(tmp_path / "a.bin")
    save_matrix(p, A)
    np.testing.assert_array_equal(load_matrix(p, shape=(100, 37), dtype=np.float64), A)
    with pytest.raises(ValueError):
        load_matrix(p)  # raw needs shape/dtype


def test_python_hull_fallback_still_works(python_chain):
    """chnmf's init works without the native library."""
    rng = np.random.default_rng(3)
    V = rng.uniform(size=(6, 80))
    S = ti.convex_hull_anchors(V, device="cpu")
    assert S.shape[0] == 6 and S.shape[1] >= 3


@needs_native
@pytest.mark.parametrize("n", [3, 10, 257, 5000])
def test_hull_equals_jax_native_and_python_chain(n, monkeypatch):
    """The port's native chain, the JAX package's native chain and the
    port's Python chain give the same hull (ascending indices) of points
    in general position (of exact duplicates, which index a chain keeps
    depends on its sort); NaN rows are left out before the native code
    sees them."""
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 2))
    want = jnative.convhull2d(pts)
    np.testing.assert_array_equal(native.convhull2d(pts), want)
    np.testing.assert_array_equal(ti._convhull_2d(pts), want)
    monkeypatch.setattr(native, "convhull2d", lambda points: None)
    np.testing.assert_array_equal(ti._convhull_2d(pts), want)
    pts[1] = np.nan
    monkeypatch.undo()
    with_nan = ti._convhull_2d(pts)
    assert 1 not in with_nan.tolist()
    keep = np.delete(np.arange(n), 1)
    np.testing.assert_array_equal(with_nan, keep[jnative.convhull2d(pts[keep])])


@needs_native
@pytest.mark.parametrize("m", [6, 40])
def test_anchors_same_with_native_on_and_off(m, monkeypatch):
    rng = np.random.default_rng(m)
    V = rng.gamma(1.0, 1.0, (m, 4)) @ rng.gamma(1.0, 1.0, (4, 300))
    on = ti.convex_hull_anchors(V, device="cpu")
    monkeypatch.setattr(native, "convhull2d", lambda points: None)
    off = ti.convex_hull_anchors(V, device="cpu")
    assert torch.equal(on, off) and on.shape[1] >= 3


@needs_native
def test_library_is_hashed_and_not_beside_the_source():
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    path = native.library_path()
    assert path.parent == _build.build_dir() and path.is_file()
    assert path.parent != native.SRC.parent
    assert path.name.startswith("libnmf_native_") and len(path.stem) == len("libnmf_native_") + 16
    assert not list(native.SRC.parent.glob("*.so"))


def test_loader_falls_back_without_native(tmp_path, python_chain):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(31, 17)).astype(np.float32)
    save_matrix(str(tmp_path / "a.npy"), torch.from_numpy(A))  # a tensor saves too
    np.testing.assert_array_equal(load_matrix(str(tmp_path / "a.npy")), A)
    save_matrix(str(tmp_path / "a.bin"), A)
    np.testing.assert_array_equal(
        load_matrix(str(tmp_path / "a.bin"), shape=(31, 17), dtype=np.float32), A)


@needs_native
def test_load_bytes_refuses_a_strided_destination(tmp_path):
    save_matrix(str(tmp_path / "a.bin"), np.arange(12, dtype=np.uint8))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.load_bytes(str(tmp_path / "a.bin"), np.empty(24, np.uint8)[::2])


def test_build_dir_falls_back_to_user_cache(tmp_path, monkeypatch):
    """A package build directory that cannot be made (here: its parent is
    a file) sends builds to the user's cache directory."""
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    (tmp_path / "pkg").write_text("")
    monkeypatch.setattr(_build, "PKG_BUILD_DIR", tmp_path / "pkg" / "_build")
    monkeypatch.setattr(_build, "CACHE_BUILD_DIR", tmp_path / "cache" / "_build")
    assert _build.build_dir() == tmp_path / "cache" / "_build"
    assert (tmp_path / "cache" / "_build").is_dir()
    assert _build.library_path().parent == tmp_path / "cache" / "_build"
    assert native.library_path().parent == tmp_path / "cache" / "_build"
