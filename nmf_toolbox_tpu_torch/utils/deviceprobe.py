"""Bounded probing of the CUDA cards (PyTorch counterpart of
``nmf_toolbox_tpu/utils/deviceprobe.py``).

A CUDA context on a wedged card, or on one the CUDA runtime lost, can
hang the first call that touches the card with no output at all, and a
program that made that call itself cannot leave it.  So the probe runs
in a BOUNDED subprocess: it imports ``torch`` (never ``jax``), counts
the cards, and on every card allocates a tensor, runs one elementwise op
and synchronises, so a card that ``device_count`` still counts but that
no longer computes shows as dead.  Its last line reads ``cuda N``; an
earlier line names the cards.

The verdict is ``("cuda", N)`` or ``(None, 0)``: no card, a timeout and
a crash all give ``(None, 0)``, never ``"cpu"``.  Nothing in the port
falls back to the CPU on it; a caller that needs the card stops.

The environment variables (``NMF_TORCH_PROBE_*``) and the cache file are
this package's own, so the JAX package's probe cache never answers for
the cards, nor this one for its backend.  ``chip_smoke.py`` calls
``probe_auto(no_wait=True)`` before its own process first touches CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# One bounded probe: long enough for torch's import and a CUDA context on
# each of several cards (seconds each), short enough that a hung card
# does not eat a run's time limit.
PROBE_TIMEOUT_S = float(os.environ.get("NMF_TORCH_PROBE_TIMEOUT_S", 60))
# The retry window of probe_with_retry, for callers that may wait for a
# card to come back (a reset, a busy card).
RETRY_WINDOW_S = float(os.environ.get("NMF_TORCH_PROBE_WINDOW_S", 600))
RETRY_INTERVAL_S = float(os.environ.get("NMF_TORCH_PROBE_INTERVAL_S", 60))

_PROBE_SRC = """\
import sys
import torch
n = torch.cuda.device_count() if torch.cuda.is_available() else 0
if n == 0:
    sys.exit("no CUDA card")
names = []
for i in range(n):
    x = torch.full((1024,), 2.0, device=f"cuda:{i}")
    s = float((x * x + 1.0).sum())
    torch.cuda.synchronize(i)
    if s != 5120.0:
        sys.exit(f"card {i} computed {s}, not 5120")
    names.append(torch.cuda.get_device_name(i))
print("; ".join(names))
print("cuda", n)
"""

# Cross-process cache: a hung card burns a probe's whole timeout, so a
# caller that re-discovers the same dead card pays it again.  Each probe
# writes its verdict here; cached_probe() trusts a fresh DEAD entry only.
CACHE_PATH = os.environ.get("NMF_TORCH_PROBE_CACHE",
                            os.path.join(tempfile.gettempdir(),
                                         "nmf_torch_probe_cache.json"))
CACHE_MAX_AGE_S = float(os.environ.get("NMF_TORCH_PROBE_CACHE_AGE_S", 600))


def _cache_write(plat, n, timeout=None) -> None:
    try:
        if plat is None and timeout is not None:
            # A fresh dead verdict keeps the longest budget of a recent one:
            # short probes must not demote a long probe's dead entry (its
            # caller would pay the long probe again).  Sound, because a card
            # that came back answers the short probe too.
            prev = _cache_read(CACHE_MAX_AGE_S)
            if (prev is not None and prev[0] is None
                    and prev[2] is not None and float(prev[2]) > timeout):
                timeout = float(prev[2])
        tmp = f"{CACHE_PATH}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "platform": plat, "n": n,
                       "timeout": timeout}, f)
        os.replace(tmp, CACHE_PATH)
    except OSError:
        pass


def _cache_read(max_age_s):
    try:
        with open(CACHE_PATH) as f:
            d = json.load(f)
        if time.time() - float(d["ts"]) <= max_age_s:
            return d["platform"], int(d["n"]), d.get("timeout")
    except (OSError, ValueError, KeyError):
        pass
    return None


def probe_once(timeout: float = PROBE_TIMEOUT_S):
    """One bounded subprocess probe.

    Returns ``("cuda", n_cards)``, or ``(None, 0)`` when there is no
    card, the probe crashed or it did not answer within ``timeout``
    seconds (the child is then killed).  The subprocess inherits the
    environment (``CUDA_VISIBLE_DEVICES`` included)."""
    try:
        p = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                           capture_output=True, text=True, timeout=timeout)
        if p.returncode == 0 and p.stdout.strip():
            plat, n = p.stdout.strip().splitlines()[-1].split()
            _cache_write(plat, int(n), timeout)
            return plat, int(n)
        print(f"device probe found no live card: exit {p.returncode}: "
              f"{p.stderr.strip()[-500:]}", file=sys.stderr)
    except (subprocess.TimeoutExpired, OSError, ValueError) as e:
        print(f"device probe failed: {type(e).__name__}: {e}",
              file=sys.stderr)
    _cache_write(None, 0, timeout)
    return None, 0


def cached_probe(timeout: float = PROBE_TIMEOUT_S,
                 max_age_s: float = CACHE_MAX_AGE_S):
    """probe_once, short-circuited ONLY by a fresh cross-process DEAD
    entry written by a probe whose budget was at least ours.  A cached
    LIVE entry is never trusted: the card may have hung since, and a
    caller acting on it would hand its own unbounded CUDA start a hang;
    confirming a live card costs seconds."""
    hit = _cache_read(max_age_s)
    if hit is not None:
        plat, n, t = hit
        if plat is None and t is not None and float(t) >= timeout:
            print(f"device probe cache hit: no live card "
                  f"(probed with {t:.0f}s budget)", file=sys.stderr)
            return None, 0
    return probe_once(timeout)


def probe_with_retry(window_s: float = RETRY_WINDOW_S,
                     interval_s: float = RETRY_INTERVAL_S,
                     probe_timeout_s: float = PROBE_TIMEOUT_S):
    """Probe repeatedly until the cards answer or the window closes.

    Returns ``("cuda", n_cards)`` on success, ``(None, 0)`` after the
    deadline.  Progress lines go to stderr, so a log shows the probe is
    alive, not hung."""
    deadline = time.monotonic() + window_s
    attempt = 0
    while True:
        attempt += 1
        plat, n = probe_once(probe_timeout_s)
        if plat is not None:
            if attempt > 1:
                print(f"device probe recovered on attempt {attempt}: "
                      f"{plat} x{n}", file=sys.stderr)
            return plat, n
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            print(f"device probe gave up after {attempt} attempts "
                  f"({window_s:.0f}s window)", file=sys.stderr)
            return None, 0
        wait = min(interval_s, remaining)
        print(f"device probe attempt {attempt} found no live card; "
              f"retrying in {wait:.0f}s ({remaining:.0f}s left in window)",
              file=sys.stderr)
        time.sleep(wait)


def probe_auto(no_wait: bool = False, timeout: float = PROBE_TIMEOUT_S):
    """The entry-point policy in one place: a single bounded probe for
    interactive runs (``no_wait``), the retry window otherwise.  Returns
    ``("cuda", n_cards)`` or ``(None, 0)``."""
    return probe_once(timeout) if no_wait else probe_with_retry()
