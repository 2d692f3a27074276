"""Port's audio front end (utils/audio.py) and Wiener separation
(utils/separation.py) against the JAX package, mirroring
tests/test_audio.py and tests/test_separation.py.

Both packages get the same NumPy signals and factors, in f64 on the CPU
(f32 where the JAX test pins f32 behaviour): transforms, masks, estimates
and waveforms within rtol 1e-9 of their largest entry.  ``griffinlim``
is held to JAX from JAX's own initial angles (the port draws its angles
from a ``torch.Generator``).  Also here: the port exports every public
name of the JAX package.
"""
import numpy as np
import pytest
import scipy.signal

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.utils import audio as taudio  # noqa: E402

RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def test_exports_cover_the_jax_package():
    assert set(jt.__all__) <= set(tt.__all__)
    for name in jt.__all__:
        assert getattr(tt, name) is not None


def test_window_matches_scipy():
    w = taudio.hann_window(64, torch.float64)
    np.testing.assert_allclose(w.numpy(), scipy.signal.get_window("hann", 64, fftbins=True),
                               atol=1e-12)
    close(w, jt.utils.hann_window(64, jnp.float64))


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("planes", [False, True])
def test_stft_matches_jax(center, planes):
    x = np.random.default_rng(0).normal(size=1000)
    Z = tt.stft(x, n_fft=128, hop_length=32, center=center, planes=planes, **CPU)
    close(Z, jt.stft(x, n_fft=128, hop_length=32, center=center, planes=planes))


@pytest.mark.parametrize("n_fft,hop,length", [
    (128, 32, 1000), (128, 64, 1000), (256, 64, 777), (64, 16, 64), (128, 48, 500),
])
def test_istft_matches_jax_and_inverts(n_fft, hop, length):
    x = np.random.default_rng(1).normal(size=length)
    Z = tt.stft(x, n_fft=n_fft, hop_length=hop, **CPU)
    Zj = jt.stft(x, n_fft=n_fft, hop_length=hop)
    for ln in (length, None):
        close(tt.istft(Z, hop_length=hop, length=ln), jt.istft(Zj, hop_length=hop, length=ln))
    np.testing.assert_allclose(tt.istft(Z, hop_length=hop, length=length).numpy(), x,
                               atol=1e-8)


def test_uncentered_and_custom_windows_match_jax():
    x = np.random.default_rng(2).normal(size=1024)
    for kw in (dict(center=False), dict(window="rect", center=False),
               dict(window=np.hamming(128)), dict(window=tuple(np.hamming(128)))):
        Z = tt.stft(x, n_fft=128, hop_length=32, **kw, **CPU)
        Zj = jt.stft(x, n_fft=128, hop_length=32, **kw)
        close(Z, Zj)
        close(tt.istft(Z, hop_length=32, **kw), jt.istft(Zj, hop_length=32, **kw))


def test_batched_leading_dims_and_planes_roundtrip():
    x = np.random.default_rng(3).normal(size=(2, 3, 600))
    Z = tt.stft(x, n_fft=128, hop_length=32, **CPU)
    assert Z.shape[:3] == (2, 3, 65)
    assert torch.equal(Z[0, 0], tt.stft(x[0, 0], n_fft=128, hop_length=32, **CPU))
    close(Z, jt.stft(x, n_fft=128, hop_length=32))
    np.testing.assert_allclose(tt.istft(Z, hop_length=32, length=600).numpy(), x, atol=1e-8)
    P = tt.stft(x, n_fft=128, hop_length=32, planes=True, **CPU)
    y = tt.istft(P, hop_length=32, length=600, planes=True)
    close(y, jt.istft(jt.stft(x, n_fft=128, hop_length=32, planes=True), hop_length=32,
                      length=600, planes=True))


def test_f32_dtypes():
    x32 = np.random.default_rng(5).normal(size=300).astype(np.float32)
    Z = tt.stft(x32, n_fft=64, **CPU)
    assert Z.dtype == torch.complex64
    y = tt.istft(Z, length=300)
    assert y.dtype == torch.float32
    close(y, jt.istft(jt.stft(x32, n_fft=64), length=300), rtol=1e-5)


def test_errors():
    x32 = np.random.default_rng(5).normal(size=300).astype(np.float32)
    Z = tt.stft(x32, n_fft=64, **CPU)
    with pytest.raises(TypeError):
        tt.stft(Z)  # complex input
    for bad in (dict(hop_length=0), dict(window="blackman"), dict(n_fft=65)):
        with pytest.raises(ValueError):
            tt.stft(x32, **dict(dict(n_fft=64), **bad), **CPU)
    with pytest.raises(ValueError):
        tt.stft(np.zeros(10), n_fft=64, center=False, **CPU)  # too short
    with pytest.raises(ValueError):
        tt.istft(torch.zeros((1,), dtype=torch.complex64))
    with pytest.raises(ValueError):
        tt.istft(Z, hop_length=16, planes=True)  # complex with planes=True
    with pytest.raises(ValueError):
        tt.istft(np.zeros((3, 33, 10), np.float32), planes=True, **CPU)  # not 2 planes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tt.stft(x32)  # an array with no device= and no card


def test_magnitude_matches_jax():
    Z = np.array([[3 + 4j, 0.0]])
    np.testing.assert_allclose(tt.magnitude(Z, **CPU).numpy(), [[5.0, 0.0]])
    np.testing.assert_allclose(tt.magnitude(Z, power=2.0, **CPU).numpy(), [[25.0, 0.0]])
    x = np.random.default_rng(6).normal(size=700)
    for power in (1.0, 2.0, 0.5):
        for planes in (False, True):
            Zp = jt.stft(x, n_fft=64, hop_length=16, planes=planes)
            close(tt.magnitude(np.array(Zp), power=power, planes=planes, **CPU),
                  jt.magnitude(Zp, power=power, planes=planes))


@pytest.mark.parametrize("momentum", [0.99, 0.0])
def test_griffinlim_matches_jax_from_its_angles(momentum):
    x = np.random.default_rng(7).normal(size=(2, 900))
    mag = np.abs(np.asarray(jt.stft(x, n_fft=64, hop_length=16)))
    key = jax.random.PRNGKey(3)
    ang = np.array(jax.random.uniform(key, mag.shape, mag.dtype, -jnp.pi, jnp.pi))
    y = taudio._griffinlim(torch.from_numpy(mag), torch.from_numpy(ang), 10, 16, "hann",
                           momentum, 900)
    close(y, jt.griffinlim(mag, n_iter=10, hop_length=16, momentum=momentum,
                           length=900, key=key))


def test_griffinlim_converges_and_is_seeded():
    t = np.arange(6000) / 8000
    x = 0.7 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1250 * t + 0.4)
    mag = tt.magnitude(tt.stft(x, n_fft=256, hop_length=64, **CPU))

    def sc(y):
        M = tt.magnitude(tt.stft(y, n_fft=256, hop_length=64))
        return float(torch.linalg.norm(M - mag) / torch.linalg.norm(mag))

    y0 = tt.griffinlim(mag, n_iter=0, hop_length=64, length=len(x))
    y = tt.griffinlim(mag, n_iter=48, hop_length=64, length=len(x))
    assert y.shape == (len(x),) and not y.is_complex()
    assert sc(y) < 0.12 and sc(y) < 0.3 * sc(y0)
    assert torch.equal(y0, tt.griffinlim(mag, n_iter=0, hop_length=64, length=len(x)))
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a = tt.griffinlim(mag, n_iter=8, hop_length=64, generator=g())
    assert torch.equal(a, tt.griffinlim(mag, n_iter=8, hop_length=64, generator=g()))
    with pytest.raises(TypeError):
        tt.griffinlim(mag.to(torch.complex128), n_iter=2)


# ---------------------------------------------------------------------------
# Separation
# ---------------------------------------------------------------------------

def two_sources(seed=0, m=40, n=60, kA=4, kB=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.gamma(2.0, 1.0, (m, k)).astype(dtype) for k in (kA, kB)], \
        [rng.gamma(0.5, 1.0, (k, n)).astype(dtype) for k in (kA, kB)]


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_wiener_masks_match_jax(power):
    W, H = two_sources()
    H[0][:, 0] = H[1][:, 0] = 0.0  # a bin no model explains: 1/S each
    M = tt.wiener_masks(W, H, power=power, **CPU)
    close(M, jt.wiener_masks(W, H, power=power))
    np.testing.assert_allclose(M.sum(0).numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose(M[:, :, 0].numpy(), 0.5)


@pytest.mark.parametrize("kind", ["magnitude", "complex", "convolutive", "nmf2d"])
def test_separate_matches_jax(kind):
    rng = np.random.default_rng(1)
    W, H = two_sources(1)
    if kind == "convolutive":  # (m, k, T) bases, one 2-D and one 3-D
        W = [rng.gamma(2.0, 1.0, (40, 3, 3)), W[1]]
        H = [rng.gamma(0.5, 1.0, (3, 60)), H[1]]
    if kind == "nmf2d":  # (m, k, T) bases with (k, n, P) encodings
        W = [rng.gamma(2.0, 1.0, (40, 2, 2)) for _ in range(2)]
        H = [rng.gamma(0.7, 1.0, (2, 60, 2)) for _ in range(2)]
    V = np.asarray(jt.reconstruct(W[0], H[0]) + jt.reconstruct(W[1], H[1])) + 0.3
    if kind == "complex":
        V = V * np.exp(1j * rng.uniform(0, 2 * np.pi, V.shape))
    est = tt.separate(V, W, H, **CPU)
    close(est, jt.separate(V, W, H))
    close(est.sum(0), V, rtol=1e-12)


def test_separation_validation():
    W, H = two_sources(6)
    with pytest.raises(TypeError, match="lists"):
        tt.wiener_masks(W[0], H[0], **CPU)
    with pytest.raises(ValueError, match="matching"):
        tt.wiener_masks([W[0]], H, **CPU)
    with pytest.raises(ValueError, match="reconstruct"):
        tt.separate(np.zeros((3, 3)), W, H, **CPU)
    with pytest.raises(ValueError):
        tt.separate_waveforms(np.zeros((3, 65, 10), np.float32), [np.ones((65, 2))],
                              [np.ones((2, 10))], hop_length=32, **CPU)
    with pytest.raises(ValueError, match="reconstruct"):
        tt.separate_waveforms(np.zeros((2, 65, 10)), [np.ones((65, 2))],
                              [np.ones((2, 11))], hop_length=32, **CPU)


@pytest.mark.parametrize("planes", [False, True])
def test_separate_waveforms_matches_jax(planes):
    rng = np.random.default_rng(5)
    x = rng.normal(size=3000)
    Z = jt.stft(x, n_fft=128, hop_length=32, planes=planes)
    W = [rng.uniform(size=(65, 3)) for _ in range(2)]
    H = [rng.uniform(size=(3, Z.shape[-1])) for _ in range(2)]
    got = tt.separate_waveforms(np.array(Z), W, H, hop_length=32, length=len(x), **CPU)
    assert got.shape == (2, len(x))
    close(got, jt.separate_waveforms(Z, W, H, hop_length=32, length=len(x)))
    # the sources sum back to the mixture's waveform
    Zc = tt.stft(x, n_fft=128, hop_length=32, **CPU)
    np.testing.assert_allclose(got.sum(0).numpy(), x, atol=1e-9)
    est = tt.separate(Zc, W, H)
    close(got, torch.stack([tt.istft(e, hop_length=32, length=len(x)) for e in est]))
