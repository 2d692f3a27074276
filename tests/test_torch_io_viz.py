"""The port's io and viz utilities against the JAX package's: mirrors the
sort_dictionary / view_dictionary / view_consensus tests of
tests/test_utils.py on the Agg backend, with tensors as inputs, and npy
and raw round trips of load_matrix / save_matrix."""
import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu.utils import io as jio  # noqa: E402
from nmf_toolbox_tpu.utils import viz as jviz  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.utils import (load_matrix, save_matrix,  # noqa: E402
                                         sort_dictionary, view_consensus,
                                         view_dictionary)


def oracle_sort(W, H=None):
    """Literal SortDictionary.m:31-47."""
    W = np.asarray(W)
    k = W.shape[1]
    csum = np.cumsum(W, axis=0)
    cog = np.zeros(k, dtype=int)
    for j in range(k):
        idx = np.nonzero(csum[:, j] <= csum[-1, j] / 2)[0]
        cog[j] = (idx[-1] + 1) if idx.size else 1
    order = np.argsort(cog, kind="stable")
    if H is None:
        return W[:, order]
    return W[:, order], np.asarray(H)[order, :]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_sort_dictionary_matches_oracle_and_jax(as_tensor):
    rng = np.random.default_rng(0)
    for _ in range(5):
        W = rng.uniform(size=(30, 6))
        H = rng.uniform(size=(6, 12))
        args = (torch.from_numpy(W), torch.from_numpy(H)) if as_tensor else (W, H)
        Ws, Hs = sort_dictionary(*args)
        assert isinstance(Ws, np.ndarray) and isinstance(Hs, np.ndarray)
        Wo, Ho = oracle_sort(W, H)
        np.testing.assert_array_equal(Ws, Wo)
        np.testing.assert_array_equal(Hs, Ho)
        Wj, Hj = jviz.sort_dictionary(W, H)
        np.testing.assert_array_equal(Ws, Wj)
        np.testing.assert_array_equal(Hs, Hj)


def test_sort_dictionary_centered_basis():
    W = np.zeros((20, 3))
    W[15, 0] = 1.0
    W[2, 1] = 1.0
    W[8, 2] = 1.0
    Ws = sort_dictionary(torch.from_numpy(W))
    assert np.argmax(Ws[:, 0]) == 2
    assert np.argmax(Ws[:, 1]) == 8
    assert np.argmax(Ws[:, 2]) == 15


def test_sort_dictionary_rejects_3d():
    with pytest.raises(ValueError):
        sort_dictionary(torch.zeros((4, 3, 2)))


def test_view_dictionary_2d_and_3d(tmp_path):
    rng = np.random.default_rng(1)
    W2 = rng.uniform(size=(16, 4))
    ax = view_dictionary(torch.from_numpy(W2), sort=True, logscale=True, threshold=1e-3)
    assert ax.get_xlabel() == "Basis index"
    jax_ax = jviz.view_dictionary(W2, sort=True, logscale=True, threshold=1e-3)
    np.testing.assert_array_equal(np.asarray(ax.images[0].get_array()),
                                  np.asarray(jax_ax.images[0].get_array()))
    ax.figure.savefig(tmp_path / "nmf.png")
    ax3 = view_dictionary(torch.from_numpy(rng.uniform(size=(16, 3, 4))), spacing=2,
                          flipud=True)
    assert ax3.images[0].get_array().shape == (16, 3 * (4 + 2))
    ax3.figure.savefig(tmp_path / "cnmf.png")
    assert (tmp_path / "cnmf.png").stat().st_size > 0


def test_view_dictionary_cnmf_flatten_content():
    """Frame t of basis k lands at column k*(T+spacing)+t, with -inf gap
    columns (ViewDictionary.m:66-74)."""
    rng = np.random.default_rng(6)
    m, K, T, sp = 5, 3, 4, 2
    W = rng.uniform(size=(m, K, T))
    img = np.asarray(view_dictionary(torch.from_numpy(W), spacing=sp).images[0].get_array())
    expected = np.full((m, K * (T + sp)), -np.inf)
    for k in range(K):
        for t in range(T):
            expected[:, k * (T + sp) + t] = W[:, k, t]
    np.testing.assert_array_equal(img, expected)


def test_view_consensus():
    C = np.kron(np.eye(3), np.ones((4, 4)))
    p = np.random.default_rng(0).permutation(12)
    ax = view_consensus(torch.from_numpy(C[np.ix_(p, p)]))
    img = np.asarray(ax.images[0].get_array())
    assert img.shape == (12, 12)
    for r in img:
        on = np.nonzero(r)[0]
        assert len(on) == 4 and on[-1] - on[0] == 3
    np.testing.assert_array_equal(
        img, np.asarray(jviz.view_consensus(C[np.ix_(p, p)]).images[0].get_array()))
    with pytest.raises(ValueError, match="square"):
        view_consensus(np.ones((3, 4)))


def test_view_consensus_of_a_rank_sweep():
    """The consensus matrix of the port's own sweep plots as it is."""
    rng = np.random.default_rng(2)
    V = np.kron(np.eye(2), np.ones((5, 6))) + 0.01 * rng.uniform(size=(10, 12))
    sel = tt.consensus_stability(V, (2,), n_seeds=4, device="cpu")
    ax = view_consensus(sel.stats[0].consensus)
    assert ax.images[0].get_array().shape == (12, 12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_npy_round_trip_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(37, 23)).astype(dtype)
    if np.iscomplexobj(A):
        A = A + 1j * rng.normal(size=A.shape).astype(dtype)
    save_matrix(str(tmp_path / "t.npy"), torch.from_numpy(A))
    np.testing.assert_array_equal(jio.load_matrix(str(tmp_path / "t.npy")), A)
    jio.save_matrix(str(tmp_path / "j.npy"), A)
    out = load_matrix(str(tmp_path / "j.npy"))
    assert out.dtype == A.dtype
    np.testing.assert_array_equal(out, A)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_round_trip_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(19, 41)).astype(dtype)
    save_matrix(str(tmp_path / "t.bin"), A.T)  # non-contiguous: written C-order
    np.testing.assert_array_equal(
        jio.load_matrix(str(tmp_path / "t.bin"), shape=(41, 19), dtype=dtype), A.T)
    jio.save_matrix(str(tmp_path / "j.bin"), A)
    np.testing.assert_array_equal(
        load_matrix(str(tmp_path / "j.bin"), shape=(19, 41), dtype=dtype), A)


def test_fortran_order_npy_falls_back_to_numpy(tmp_path):
    A = np.asfortranarray(np.random.default_rng(5).normal(size=(7, 9)))
    np.save(tmp_path / "f.npy", A)
    np.testing.assert_array_equal(load_matrix(str(tmp_path / "f.npy")), A)
