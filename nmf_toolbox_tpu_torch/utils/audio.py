"""STFT / iSTFT front end for the audio workflows, on ``torch.fft``.

PyTorch counterpart of ``nmf_toolbox_tpu/utils/audio.py``: signal ->
complex STFT -> {nmf family, cmfwisa, encode engines} -> Wiener masks
(utils/separation.py) -> iSTFT -> signal, on the device.

The JAX package's conventions (librosa-style): periodic Hann window,
``center=True`` reflect-pads by n_fft//2 so frame ``t`` is centered on
sample ``t*hop_length``, spectrograms laid out ``(freq, time)`` = the
toolbox's (m, n) orientation, and ``istft(stft(x))`` gives back ``x`` up
to fp rounding whenever the window/hop pair satisfies NOLA (Hann at any
hop <= n_fft//2).  Framing is a strided view (``unfold``); the
overlap-add is ``F.fold`` (each output sample gathers its frames in a
fixed order, so it is deterministic on the card).  Leading dimensions
batch.  ``planes=True`` takes or gives the real (2, ..., F, T) stack of
(real, imag) planes, the JAX package's form for runtimes that cannot
move complex buffers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import (as_tensor, complex_dtype_of, real_dtype_of, resolve_device,
                    resolve_dtype)

__all__ = ["hann_window", "stft", "istft", "magnitude", "griffinlim"]


def hann_window(n_fft: int, dtype=torch.float32, device=None):
    """Periodic Hann window (the DFT-even form used for spectral
    analysis; scipy's ``get_window('hann', n, fftbins=True)``); the cos
    form keeps w[0] == 0 exactly."""
    t = torch.arange(n_fft, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * t / n_fft)


def _resolve_window(window, n_fft, dtype, device):
    if isinstance(window, str):
        if window == "hann":
            return hann_window(n_fft, dtype, device)
        if window in ("rect", "boxcar", "ones"):
            return torch.ones((n_fft,), dtype=dtype, device=device)
        raise ValueError(f"unknown window {window!r}; pass 'hann', "
                         "'rect', or an (n_fft,) array")
    w = as_tensor(np.asarray(window) if isinstance(window, tuple) else window,
                  dtype, device)
    if tuple(w.shape) != (n_fft,):
        raise ValueError(f"window has shape {tuple(w.shape)}; need ({n_fft},)")
    return w


def _is_complex(x) -> bool:
    return x.is_complex() if torch.is_tensor(x) else np.iscomplexobj(x)


def _signal(x, device):
    """x as a real tensor on the run's device (a tensor stays where it is)."""
    dev = resolve_device(x, device)
    if _is_complex(x):
        raise TypeError("stft expects a real signal; factorize complex "
                        "spectrograms directly instead")
    return as_tensor(x, resolve_dtype(x, None), dev)


def _stft(x, n_fft, hop, window, center):
    if hop <= 0:
        raise ValueError(f"hop_length must be positive, got {hop}")
    w = _resolve_window(window, n_fft, x.dtype, x.device)
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*lead, -1)
    if x.shape[-1] < n_fft:
        raise ValueError(f"signal length {x.shape[-1]} (after centering) is "
                         f"shorter than n_fft={n_fft}")
    frames = x.unfold(-1, n_fft, hop) * w  # (..., n_frames, n_fft)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)  # (..., freq, time)


def stft(x, n_fft: int = 512, hop_length: int | None = None,
         window="hann", center: bool = True, planes: bool = False,
         device=None):
    """Short-time Fourier transform of a real signal ``(..., length)``
    (leading dims batch).  Returns the complex spectrogram
    ``(..., n_fft//2 + 1, n_frames)`` — (freq, time), ready for
    ``cmfwisa`` or ``magnitude`` — or with ``planes=True`` the real
    ``(2, ..., freq, time)`` stack of its (real, imag) planes.

    ``window``: 'hann' (default), 'rect', or an (n_fft,) array.
    ``center=True`` reflect-pads by ``n_fft // 2`` so istft reconstructs
    the edges too; ``center=False`` frames the raw signal.  A tensor stays
    on its device; an array goes to ``device`` (default: the card).
    """
    if n_fft % 2 or n_fft < 2:
        # istft/griffinlim infer n_fft = 2*(F-1) from the row count; an
        # odd n_fft would silently reconstruct with the wrong size.
        raise ValueError(f"n_fft must be even and >= 2; got {n_fft}")
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    Z = _stft(_signal(x, device), n_fft, hop, window, center)
    return torch.stack([Z.real, Z.imag]) if planes else Z


def _istft(Z, hop_length, window, center, length):
    if Z.ndim < 2:
        raise ValueError(f"Z must be (..., freq, frames); got {tuple(Z.shape)}")
    n_freq, n_frames = Z.shape[-2], Z.shape[-1]
    n_fft = 2 * (n_freq - 1)
    if n_fft <= 0:
        raise ValueError(f"need at least 2 frequency rows, got {n_freq}")
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    rdt = real_dtype_of(Z.dtype)
    w = _resolve_window(window, n_fft, rdt, Z.device)

    frames = torch.fft.irfft(Z.transpose(-1, -2), n=n_fft, dim=-1) * w
    lead = frames.shape[:-2]
    out_len = n_fft + hop * (n_frames - 1)

    def overlap_add(fr):  # (N, n_frames, n_fft) -> (N, out_len)
        return F.fold(fr.transpose(-1, -2), (1, out_len), (1, n_fft),
                      stride=(1, hop)).reshape(fr.shape[0], out_len)

    x = overlap_add(frames.reshape(-1, n_frames, n_fft)).reshape(*lead, out_len)
    # NOLA normalization: the overlap-added squared window.
    wsq = overlap_add((w * w).expand(1, n_frames, n_fft))[0]
    tiny = float(torch.finfo(rdt).tiny) ** 0.5
    x = torch.where(wsq > tiny, x / torch.clamp_min(wsq, tiny), 0.0)
    if center:
        # Trim the analysis padding.  With an explicit length keep the
        # right-hand tail: the final frames extend past length-1 into
        # the reflect padding, and OLA is exact at every covered sample.
        hi = out_len if length is not None else out_len - n_fft // 2
        x = x[..., n_fft // 2: hi]
    if length is not None:
        have = x.shape[-1]
        x = x[..., :length] if have >= length else F.pad(x, (0, length - have))
    return x


def _complex_of_planes(Z):
    if Z.is_complex() or Z.ndim < 3 or Z.shape[0] != 2:
        raise ValueError("planes=True expects a real (2, ..., freq, frames) "
                         f"stack; got {Z.dtype} {tuple(Z.shape)}")
    return torch.complex(Z[0], Z[1])


def istft(Z, hop_length: int | None = None, window="hann",
          center: bool = True, length: int | None = None,
          planes: bool = False, device=None):
    """Inverse STFT by windowed overlap-add (Griffin & Lim's least-squares
    signal for the given frames).

    ``Z``: complex spectrogram ``(..., n_fft//2 + 1, n_frames)`` as
    :func:`stft` gives it (n_fft is ``2*(F-1)``), or with
    ``planes=True`` the real ``(2, ..., freq, frames)`` plane stack.
    ``length``: trim or zero-pad the output to this many samples.  Exact
    inverse of :func:`stft` wherever the squared-window overlap-add is
    positive (NOLA); samples where it is ~0 come back as 0.
    """
    dev = resolve_device(Z, device)
    if planes:
        Z = _complex_of_planes(as_tensor(Z, resolve_dtype(Z, None), dev))
    else:
        Z = as_tensor(Z, complex_dtype_of(resolve_dtype(Z, None)), dev)
    return _istft(Z, hop_length, window, center, length)


def magnitude(Z, power: float = 1.0, planes: bool = False, device=None):
    """|Z|**power — the nonnegative spectrogram the magnitude solvers
    factorize (power=1 magnitude, 2 power spectrogram).  ``planes=True``:
    ``Z`` is the real (2, ...) (real, imag) stack."""
    Z = as_tensor(Z, resolve_dtype(Z, None), resolve_device(Z, device))
    if planes:
        if Z.is_complex() or Z.shape[0] != 2:
            raise ValueError("planes=True expects a real (2, ...) stack; "
                             f"got {Z.dtype} {tuple(Z.shape)}")
        mag = torch.sqrt(Z[0] * Z[0] + Z[1] * Z[1])
    else:
        mag = torch.abs(Z)
    return mag if power == 1.0 else mag ** power


def _griffinlim(mag, angles, n_iter, hop_length, window, momentum, length):
    """Fast Griffin-Lim (Perraudin 2013) from the initial phase angles."""
    n_fft = 2 * (mag.shape[-2] - 1)
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    angles = torch.exp(1j * angles).to(complex_dtype_of(mag.dtype))
    mom = momentum / (1.0 + momentum)
    tiny = float(torch.finfo(mag.dtype).tiny)
    tprev = torch.zeros_like(angles)
    for _ in range(int(n_iter)):
        # istft -> stft keeps the frame count for center=True
        rebuilt = _stft(_istft(mag * angles, hop, window, True, None),
                        n_fft, hop, window, True)
        t = rebuilt - mom * tprev
        angles = t / torch.clamp_min(torch.abs(t), tiny)
        tprev = rebuilt
    return _istft(mag * angles, hop, window, True, length)


def griffinlim(mag, n_iter: int = 32, hop_length: int | None = None,
               window="hann", momentum: float = 0.99,
               length: int | None = None, generator=None, device=None):
    """Waveform from a MAGNITUDE spectrogram by Griffin-Lim phase
    reconstruction (the fast accelerated variant, Perraudin 2013).

    ``mag``: nonnegative ``(..., n_fft//2 + 1, n_frames)`` (stft layout;
    leading dims batch).  ``momentum``: 0 = classic Griffin & Lim 1984,
    0.99 (default) = accelerated.  The initial phases are uniform in
    [-pi, pi), drawn on ``generator``'s device (default: a generator on
    mag's device seeded with 0, so the result is deterministic).
    Returns the real waveform ``(..., length)`` on mag's device.
    """
    if _is_complex(mag):
        raise TypeError("griffinlim takes a magnitude (real, nonnegative) "
                        "spectrogram; complex STFTs already carry phase — "
                        "use istft directly")
    mag = as_tensor(mag, resolve_dtype(mag, None), resolve_device(mag, device))
    gen = (torch.Generator(mag.device).manual_seed(0) if generator is None
           else generator)
    ang = (torch.rand(mag.shape, generator=gen, dtype=mag.dtype,
                      device=gen.device) * 2.0 - 1.0) * math.pi
    return _griffinlim(mag, ang.to(mag.device), n_iter, hop_length, window,
                       momentum, length)
