"""Command-line interface: factorize a matrix file with any solver
(the PyTorch port's counterpart of ``nmf_toolbox_tpu/cli.py``).

    nmf-tpu-torch nmf V.npy --k 32 --divergence kl --maxiter 200 --out factors.npz
    nmf-tpu-torch cnmf spec.npy --k 64 --context-len 8 --out factors.npz
    nmf-tpu-torch encode batch.npy --dict factors.npz --out enc.npz
    nmf-tpu-torch separate mix.wav --solos piano.wav,drums.wav --ks 16,8 --out stem
    python -m nmf_toolbox_tpu_torch ...   (equivalent)

The same flags as ``nmf-tpu``, plus ``--device`` (default: the CUDA card;
``cpu`` runs on the CPU).  Input: .npy (or raw binary with
--shape/--dtype); output: an .npz checkpoint loadable with
utils.checkpoint.load_factors of either package (and therefore resumable
straight back into the solvers).

``--mesh N`` shards every solver, ``separate``'s fits, ``nmf
--streaming`` and the --pick-rank sweep over N processes, one per device,
started by torchrun (``encode --streaming`` is the one-device
out-of-core path and refuses it, as the JAX package's CLI does):

    torchrun --nproc-per-node 4 -m nmf_toolbox_tpu_torch nmf V.npy --k 32 --mesh 4 --out f.npz

Every rank reads the input and runs the solve; rank 0 writes --out (and
the npz checkpoints) and prints the summary, and with
``--checkpoint-backend orbax`` every rank writes its blocks of a
directory checkpoint, which ``--resume`` accepts.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SOLVERS = ("nmf", "nmf_hals", "nmfsc", "cnmf", "cnmfsc", "cmfwisa", "lnmf",
           "convexnmf", "seminmf", "chnmf", "chcnmf", "constrainednmf",
           "nmf2d", "symnmf", "encode", "separate")


def build_parser():
    p = argparse.ArgumentParser(prog="nmf-tpu-torch", description=__doc__)
    from . import __version__
    p.add_argument("--version", action="version",
                   version=f"nmf-tpu-torch {__version__}")
    p.add_argument("solver", choices=SOLVERS)
    p.add_argument("input", help=".npy matrix (or raw binary with --shape)")
    p.add_argument("--k", type=int, default=None,
                   help="number of basis elements (required unless "
                        "--pick-rank chooses it)")
    p.add_argument("--pick-rank", default=None, metavar="2,3,..,8|svd",
                   help="choose k from data before factorizing: a comma "
                        "list of candidates runs the consensus/stability "
                        "sweep (restarts fused on device); 'svd' reads k "
                        "off the randomized-SVD energy curve")
    p.add_argument("--rank-seeds", type=int, default=10,
                   help="restarts per candidate rank for --pick-rank")
    p.add_argument("--rank-energy", type=float, default=0.9,
                   help="energy fraction for --pick-rank svd")
    p.add_argument("--context-len", type=int, default=None,
                   help="time shifts T (convolutive solvers)")
    p.add_argument("--pitch-len", type=int, default=None,
                   help="frequency shifts P (nmf2d)")
    p.add_argument("--labels", default=None,
                   help=".npy label vector (constrainednmf; -1 = unlabeled)")
    p.add_argument("--divergence", default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--w-sparsity", type=float, default=None)
    p.add_argument("--h-sparsity", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None,
                   choices=("random", "nndsvd", "nndsvda", "nndsvdar"),
                   help="factor seeding for nmf/nmf_hals (default random)")
    p.add_argument("--inner-iters", type=int, default=None,
                   help="accelerated-MU/HALS inner repetitions per V pass "
                        "(euclidean nmf / nmf_hals)")
    p.add_argument("--cost-every", type=int, default=None,
                   help="evaluate the objective every N iterations instead "
                        "of every iteration (nmf/cnmf; the factor updates "
                        "are unchanged, the tolerance check coarsens to "
                        "N-iteration windows — skips the objective's "
                        "reconstruction+divergence pass)")
    p.add_argument("--dtype", default=None, help="compute dtype override")
    p.add_argument("--shape", default=None, help="rows,cols for raw binary input")
    p.add_argument("--input-dtype", default="float32", help="raw binary dtype")
    p.add_argument("--resume", default=None,
                   help="checkpoint (.npz, or an orbax directory) to resume "
                        "factors from")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="run in chunks of this many iterations, saving "
                        "--out after each (crash-resumable)")
    p.add_argument("--checkpoint-backend", default="auto",
                   choices=("auto", "npz", "orbax"),
                   help="with --checkpoint-every: npz = one host file; "
                        "orbax = directory checkpoint with per-shard "
                        "writes + sharded restore (mesh runs); auto = "
                        "orbax for --mesh runs with a non-.npz --out")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard over this many devices (sample axis), one "
                        "process each under torchrun (nmf, nmf_hals, "
                        "encode, --pick-rank)")
    p.add_argument("--device", default="cuda",
                   help="where the solvers run: the CUDA card (default) or "
                        "'cpu'")
    p.add_argument("--streaming", action="store_true",
                   help="out-of-core euclidean NMF: memory-map the input "
                        "and stream column blocks (nmf solver only)")
    p.add_argument("--block-size", type=int, default=4096,
                   help="columns per streamed block (with --streaming)")
    p.add_argument("--weights", default=None, metavar="M.npy",
                   help="per-entry weight matrix, same shape as the input "
                        "(0 = missing/ignored entry); nmf, cnmf, "
                        "constrainednmf, nmf_hals")
    p.add_argument("--fix", default=None, choices=("W", "H"),
                   help="hold one factor fixed while fitting the other; "
                        "requires --resume to supply it. --fix W = encode "
                        "new data against a frozen dictionary (serving)")
    p.add_argument("--dict", dest="dictionary", default=None,
                   metavar="W.npy|ckpt.npz",
                   help="frozen dictionary for the 'encode' solver: a .npy "
                        "W matrix or an .npz checkpoint from a training run "
                        "(multi-source W blocks are concatenated)")
    p.add_argument("--dicts", default=None, metavar="W1.npz,W2.npz,...",
                   help="'separate' solver: per-source frozen dictionaries "
                        "(.npy W or .npz checkpoints, one per source)")
    p.add_argument("--solos", default=None, metavar="a.wav,b.wav,...",
                   help="'separate' solver: learn each source's dictionary "
                        "from a solo recording instead of --dicts")
    p.add_argument("--ks", default=None, metavar="16,8,...",
                   help="per-source ranks for --solos (one int reuses it "
                        "for all sources)")
    p.add_argument("--n-fft", type=int, default=1024,
                   help="STFT size for .wav / 1-D signal input (separate)")
    p.add_argument("--hop", type=int, default=None,
                   help="STFT hop (default n_fft // 4)")
    p.add_argument("--power", type=float, default=None,
                   help="soft-mask exponent (default 2 = Wiener, 1 = ratio "
                        "masks; mask mode only)")
    p.add_argument("--phase-aware", action="store_true",
                   help="'separate': fit the complex mixture with cmfwisa "
                        "(per-source phases, King 2012) instead of "
                        "magnitude NMF + Wiener masks; needs complex/wav "
                        "input")
    p.add_argument("--out", required=True,
                   help="output .npz checkpoint (solvers) or stem path "
                        "prefix ('separate')")
    p.add_argument("--quiet", action="store_true")
    return p


def _load_dictionary_list(path):
    """A frozen dictionary as a LIST of per-source W blocks — one block
    for a .npy matrix or a single-source .npz checkpoint, the saved
    per-source blocks for a multi-source checkpoint."""
    from .utils.io import load_matrix
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "W" in z:
                return [z["W"]]
            if "W__len" in z:
                return [z[f"W__{s}"] for s in range(int(z["W__len"]))]
            raise ValueError(f"{path} has no W factor")
    return [load_matrix(path)]


def _load_dictionary(path):
    """A frozen W from a .npy matrix or an .npz training checkpoint
    (multi-source W blocks are concatenated)."""
    parts = _load_dictionary_list(path)
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


def _read_signal(path):
    """(signal float64 1-D, sample_rate | None).  .wav via scipy (PCM
    normalized to [-1, 1] — unsigned formats like uint8 are re-centered
    on their midpoint; multi-channel averaged to mono); .npy 1-D."""
    if path.endswith(".wav"):
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        x = np.asarray(data, np.float64)
        if np.issubdtype(data.dtype, np.integer):
            info = np.iinfo(data.dtype)
            span = float(info.max) + 1.0  # 32768 for int16, 128 for uint8
            if info.min == 0:  # unsigned PCM: silence sits at span/2
                x = (x - span / 2.0) / (span / 2.0)
            else:
                x = x / span
        if x.ndim == 2:
            x = x.mean(axis=1)
        return x, int(rate)
    x = np.load(path)
    if x.ndim != 1:
        raise ValueError(f"{path}: expected a 1-D signal or .wav; a 2-D "
                         ".npy mixture is treated as a spectrogram")
    return np.asarray(x, np.float64), None


def _cmd_separate(args, mesh=None):
    """Source separation: mixture (wav / 1-D signal / 2-D spectrogram)
    -> per-source dictionaries (--dicts, or learned from --solos) ->
    W_fixed multi-source encode -> soft masks -> stems.

    Wav / signal input goes through the on-device STFT and the stems
    come back through iSTFT (utils/audio.py); spectrogram input skips
    the transform and stems are written as .npy.  With ``--mesh`` the
    fits (nmf of the solos, the W_fixed nmf or cmfwisa of the mixture)
    run sharded on every rank, and rank 0 writes the stems."""
    import nmf_toolbox_tpu_torch as nt
    from .core import to_host

    dev = args.device
    bad = [f for f, v in [
        ("--k (ranks come from the dictionaries / --ks)", args.k),
        ("--pick-rank", args.pick_rank), ("--resume", args.resume),
        ("--fix", args.fix), ("--checkpoint-every", args.checkpoint_every),
        ("--weights", args.weights), ("--streaming",
                                      args.streaming or None),
        ("--context-len", args.context_len), ("--labels", args.labels),
        ("--w-sparsity", args.w_sparsity),
        ("--init", args.init if args.init not in (None, "random") else None),
        ("--inner-iters", args.inner_iters),
        ("--cost-every", args.cost_every),
        ("--dict (use --dicts for separate)", args.dictionary),
    ] if v is not None]
    if bad:
        print(f"error: separate does not support: {', '.join(bad)}",
              file=sys.stderr)
        return 2
    if (args.dicts is None) == (args.solos is None):
        print("error: separate requires exactly one of --dicts (frozen "
              "per-source dictionaries) or --solos (learn them from solo "
              "recordings)", file=sys.stderr)
        return 2

    if args.phase_aware:
        # cmfwisa is complex-euclidean with no mask exponent: error
        # rather than silently ignore (the CLI's convention).
        pa_bad = [f for f, v in [("--divergence", args.divergence),
                                 ("--alpha", args.alpha),
                                 ("--beta", args.beta),
                                 ("--power", args.power)] if v is not None]
        if pa_bad:
            print("error: --phase-aware (cmfwisa fit, complex euclidean) "
                  f"does not support: {', '.join(pa_bad)}", file=sys.stderr)
            return 2

    hop = args.hop if args.hop is not None else args.n_fft // 4
    is_wav = args.input.endswith(".wav")
    rate = None
    try:
        if is_wav or np.load(args.input, mmap_mode="r").ndim == 1:
            sig, rate = _read_signal(args.input)
            # planar boundary: only REAL buffers cross the program
            # boundary (a complex jit output faults the relay-attached
            # TPU transfer layer — utils/audio.py stft docstring)
            Pm = to_host(nt.stft(sig, n_fft=args.n_fft, hop_length=hop,
                                 planes=True, device=dev))
            Zm = Pm[0] + 1j * Pm[1]
            length = len(sig)
        else:
            Zm = np.load(args.input)  # precomputed spectrogram
            sig = length = None
    except (ValueError, OSError, AttributeError, KeyError) as e:
        print(f"error: cannot read mixture {args.input!r}: {e} "
              "(separate takes a .wav, a 1-D signal .npy, or a 2-D "
              "spectrogram .npy)", file=sys.stderr)
        return 2

    cfg = {"maxiter": args.maxiter, "tolerance": args.tolerance,
           "seed": args.seed, "device": dev}
    for key, val in [("divergence", args.divergence),
                     ("alpha", args.alpha), ("beta", args.beta),
                     ("H_sparsity", args.h_sparsity), ("dtype", args.dtype)]:
        if val is not None:
            cfg[key] = val
    if mesh is not None:
        cfg["mesh"] = mesh

    ys = None  # waveforms, when a fused decode produced them directly
    try:
        if args.dicts is not None:
            Ws = [to_host(_load_dictionary(p))
                  for p in args.dicts.split(",")]
        else:
            solos = args.solos.split(",")
            if args.ks is None:
                print("error: --solos requires --ks (per-source ranks)",
                      file=sys.stderr)
                return 2
            ks = [int(x) for x in args.ks.split(",")]
            if len(ks) == 1:
                ks = ks * len(solos)
            if len(ks) != len(solos):
                print(f"error: --ks gives {len(ks)} ranks for "
                      f"{len(solos)} solos", file=sys.stderr)
                return 2
            Ws = []
            for i, (path, k) in enumerate(zip(solos, ks)):
                if path.endswith(".wav") or np.load(
                        path, mmap_mode="r").ndim == 1:
                    s, solo_rate = _read_signal(path)
                    if rate is not None and solo_rate is not None \
                            and solo_rate != rate:
                        print(f"error: solo {path!r} is sampled at "
                              f"{solo_rate} Hz but the mixture is {rate} "
                              "Hz — their frequency axes do not line up; "
                              "resample first", file=sys.stderr)
                        return 2
                    Ps = nt.stft(s, n_fft=args.n_fft,
                                 hop_length=hop, planes=True, device=dev)
                    S = to_host(nt.magnitude(Ps, planes=True))
                else:
                    S = np.abs(np.load(path))
                Ws.append(to_host(
                    nt.nmf(S, k, **{**cfg, "seed": args.seed + i}).W))
        Zm = np.asarray(Zm)
        m = Zm.shape[0]
        for i, W in enumerate(Ws):
            if W.ndim != 2 or W.shape[0] != m:
                print(f"error: dictionary {i} has shape {W.shape}; the "
                      f"mixture spectrogram has {m} rows", file=sys.stderr)
                return 2
        ks_out = [W.shape[1] for W in Ws]
        if args.phase_aware:
            # cmfwisa fit (per-source phases); the per-source estimates
            # are the model's final targets V_bar_s = (W_s H_s) P_s +
            # beta_s (V - V_hat) (cmfwisa.m:179): phase-aware AND summing
            # to the mixture exactly (sum_s beta_s = 1).
            if not np.iscomplexobj(Zm):
                print("error: --phase-aware needs phase information — a "
                      ".wav / 1-D signal input or a complex spectrogram",
                      file=sys.stderr)
                return 2
            res = nt.cmfwisa(Zm, ks_out, W_init=Ws, W_fixed=True, **cfg)
            Hs = list(res.H) if isinstance(res.H, (list, tuple)) else [res.H]
            Ps = list(res.P) if isinstance(res.P, (list, tuple)) else [res.P]
            # the solver unit-L2-normalizes W at entry (cmfwisa.m:154) and
            # H was fit against THAT basis — rebuild from res.W, not Ws
            Wn = list(res.W) if isinstance(res.W, (list, tuple)) else [res.W]
            WH = np.stack([to_host(W_) @ to_host(H_)
                           for W_, H_ in zip(Wn, Hs)])
            Ps = [to_host(P_) for P_ in Ps]
            V_hat = np.sum(WH * np.stack(Ps), axis=0)
            R = np.maximum(np.sum(WH, axis=0), nt.EPS)
            est = WH * np.stack(Ps) + (WH / R) * (Zm - V_hat)[None]
        else:
            # the magnitude of wav inputs is taken on the run's device
            mag = (nt.magnitude(Pm, planes=True, device=dev)
                   if sig is not None else np.abs(Zm))
            res = nt.nmf(mag, ks_out, W_init=Ws, W_fixed=True, **cfg)
            Hs = list(res.H) if isinstance(res.H, (list, tuple)) else [res.H]
            # res.W: the entry-normalized basis the encodings were fit to
            Wn = list(res.W) if isinstance(res.W, (list, tuple)) else [res.W]
            power = 2.0 if args.power is None else args.power
            if sig is not None:
                # serving decode on the device: Wiener masks, the
                # mixture's phase and a batched iSTFT, waveforms out — no
                # (S, m, n) estimate goes to the host
                ys = to_host(nt.separate_waveforms(
                    Pm, Wn, Hs, hop_length=hop, length=length, power=power,
                    device=dev))
            else:
                # spectrogram in -> spectrogram out: masks computed on
                # the device, complex mask-multiply on the host
                masks = to_host(nt.wiener_masks(Wn, Hs, power=power,
                                                device=dev))
                if masks.shape[1:] != Zm.shape:
                    # same message separate()/separate_waveforms raise —
                    # a mismatched precomputed spectrogram must not
                    # surface as a raw numpy broadcast error
                    raise ValueError(
                        f"V has shape {Zm.shape}; factors reconstruct "
                        f"{masks.shape[1:]}")
                est = masks * Zm[None]
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    stems = []
    if sig is not None and ys is None:
        # phase-aware path: per-source complex estimates already on host;
        # one batched planar iSTFT over the source axis (real boundary)
        ys = to_host(nt.istft(np.stack([est.real, est.imag]),
                              hop_length=hop, length=length,
                              planes=True, device=dev))
    for i in range(len(ks_out)):
        if sig is not None:
            y = ys[i]
            if is_wav:
                from scipy.io import wavfile
                path = f"{args.out}_source{i}.wav"
                if _writer():
                    wavfile.write(path, rate, y.astype(np.float32))
            else:
                path = f"{args.out}_source{i}.npy"
                if _writer():
                    np.save(path, y)
        else:
            path = f"{args.out}_source{i}.npy"
            if _writer():
                np.save(path, est[i])
        stems.append(path)
    if not args.quiet:
        print(json.dumps({
            "solver": "separate", "sources": len(stems),
            "spectrogram_shape": list(np.asarray(Zm).shape),
            "ranks": [int(k_) for k_ in ks_out],
            "iterations": int(res.n_iters),
            **({"phase_aware": True} if args.phase_aware
               else {"power": 2.0 if args.power is None else args.power}),
            **({"sample_rate": rate} if rate else {}),
            "stems": stems}))
    return 0


def _refusal(args):
    """The error for a device this port cannot use; None otherwise."""
    import torch
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        return f"--device {args.device!r}: {e}"
    if device.type == "cuda" and not torch.cuda.is_available():
        return "--device cuda: no CUDA card found; pass --device cpu"
    return None


def _mesh(args):
    """The mesh of ``--mesh N``: this process joins torchrun's process
    group (Gloo for ``--device cpu``, NCCL on cards) unless it has joined
    one, and the mesh spans its N ranks."""
    import torch.distributed as dist
    from .parallel import init_distributed, make_mesh
    cpu = args.device == "cpu"
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("--mesh runs one process per device: start the "
                             "command with torchrun --nproc-per-node N")
        init_distributed(backend="gloo" if cpu else "nccl")
    return make_mesh(args.mesh, device_type="cpu" if cpu else "cuda")


def _writer() -> bool:
    """True on the process that writes --out and prints: rank 0 of a mesh
    run, the only process otherwise."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.mesh:
        return _main(args)
    # A --mesh run tears down the process group it joined, and only that
    # one: a caller's group outlives the command.
    import torch.distributed as dist
    joined = dist.is_initialized()
    try:
        return _main(args)
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _main(args):
    refusal = _refusal(args)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    if args.mesh:
        try:
            mesh = _mesh(args)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        mesh = None
    if not _writer():
        args.quiet = True
    if args.solver == "separate":
        return _cmd_separate(args, mesh)
    if (args.dicts is not None or args.solos is not None
            or args.ks is not None or args.phase_aware):
        print("error: --dicts/--solos/--ks/--phase-aware only apply to the "
              "'separate' solver", file=sys.stderr)
        return 2
    import nmf_toolbox_tpu_torch as nt
    from .core import to_host
    from .utils.io import load_matrix
    from .utils.checkpoint import load_factors, run_checkpointed
    from .utils.checkpoint import save_factors as save_npz

    def save_factors(path, res):
        if _writer():
            save_npz(path, res)

    shape = tuple(int(x) for x in args.shape.split(",")) if args.shape else None
    if args.streaming:
        if args.solver not in ("nmf", "encode") or not args.input.endswith(".npy"):
            print("error: --streaming supports the nmf and encode solvers "
                  "with .npy input", file=sys.stderr)
            return 2
    if args.streaming and args.solver == "nmf":
        # The streaming TRAINING path is euclidean-only with a reduced
        # config; error rather than silently ignore options it cannot
        # honor.  (Streaming ENCODE supports the full encode config and
        # is handled in the encode branch below.)
        unsupported = [flag for flag, val in [
            ("--divergence", args.divergence if args.divergence
             not in (None, "euclidean") else None),
            ("--dtype", args.dtype), ("--w-sparsity", args.w_sparsity),
            ("--h-sparsity", args.h_sparsity), ("--alpha", args.alpha),
            ("--beta", args.beta), ("--resume", args.resume),
            ("--checkpoint-every", args.checkpoint_every),
            ("--init", args.init if args.init not in (None, "random")
             else None),
            ("--inner-iters", args.inner_iters),
            ("--cost-every", args.cost_every),
            # the consensus sweep would np.asarray the memory-map
            # (materializing the out-of-core matrix in RAM); the svd
            # estimator streams (estimate_rank_svd block_size=) and is
            # allowed
            ("--pick-rank (consensus mode)",
             args.pick_rank if args.pick_rank not in (None, "svd") else None),
            ("--fix", args.fix),
        ] if val is not None]
        if unsupported:
            print("error: --streaming (euclidean out-of-core) does not "
                  f"support: {', '.join(unsupported)}", file=sys.stderr)
            return 2
        V = np.load(args.input, mmap_mode="r")
    elif args.streaming:  # encode: memory-map, blocks staged by the engine
        V = np.load(args.input, mmap_mode="r")
    else:
        V = load_matrix(args.input, shape=shape, dtype=args.input_dtype)

    cfg = {"maxiter": args.maxiter, "tolerance": args.tolerance,
           "seed": args.seed, "device": args.device}
    for key, val in [("divergence", args.divergence), ("alpha", args.alpha),
                     ("beta", args.beta), ("W_sparsity", args.w_sparsity),
                     ("H_sparsity", args.h_sparsity), ("dtype", args.dtype)]:
        if val is not None:
            cfg[key] = val
    if args.dictionary is not None and args.solver != "encode":
        print("error: --dict only applies to the 'encode' solver (use "
              "--resume + --fix W for single-matrix fixed-basis fits)",
              file=sys.stderr)
        return 2
    if args.solver == "encode":
        # Fixed-dictionary batched encoding (nmf_encode): a (B, m, n)
        # stack against one frozen W.  Its own branch — the generic
        # path's --k/--pick-rank/--resume/--fix machinery doesn't apply.
        bad = [f for f, v in [
            ("--k (the dictionary sets k)", args.k),
            ("--pick-rank", args.pick_rank),
            ("--w-sparsity", args.w_sparsity),
            ("--resume", args.resume), ("--fix", args.fix),
            ("--checkpoint-every", args.checkpoint_every),
            ("--init", args.init if args.init not in (None, "random")
             else None),
            ("--inner-iters", args.inner_iters),
            ("--context-len", args.context_len),
            ("--labels", args.labels),
        ] if v is not None]
        if bad:
            print(f"error: encode does not support: {', '.join(bad)}",
                  file=sys.stderr)
            return 2
        if args.dictionary is None:
            print("error: encode requires --dict (the frozen dictionary)",
                  file=sys.stderr)
            return 2
        try:
            W = _load_dictionary(args.dictionary)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.weights is not None:
            # (m, n) shared across the batch or (B, m, n) per problem
            cfg["weights"] = load_matrix(args.weights)
        if mesh is not None:
            cfg["mesh"] = mesh
        cfg.pop("tolerance", None)  # fixed-iteration batched engine
        if args.streaming:
            # Out-of-core: ONE wide (m, n) matrix streamed in column
            # blocks against a 2-D dictionary (exact; H is column-local).
            if np.ndim(W) == 3:
                print("error: --streaming encode supports 2-D dictionaries",
                      file=sys.stderr)
                return 2
            if np.iscomplexobj(V):
                print("error: --streaming encode supports real magnitude "
                      "input (complex batches use the in-memory "
                      "phase-aware engine)", file=sys.stderr)
                return 2
            if args.cost_every is not None:
                print("error: --cost-every is not supported by "
                      "nmf_encode_streaming", file=sys.stderr)
                return 2
            try:
                res = nt.nmf_encode_streaming(V, W,
                                              block_size=args.block_size,
                                              **cfg)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            save_factors(args.out, res)
            if not args.quiet:
                print(json.dumps({
                    "solver": "encode", "streaming": True,
                    "shape": list(V.shape), "k": int(W.shape[1]),
                    "iterations": int(res.n_iters),
                    "final_cost": float(to_host(res.cost)[-1]),
                    "out": args.out}))
            return 0
        # Engine selection: complex batch -> phase-aware cmfwisa_encode
        # (per-source dictionary blocks preserved — the beta ratios are
        # per source); 3-D dictionary (m, k, T) -> convolutive engine.
        if np.iscomplexobj(V):
            if np.ndim(W) == 3:
                print("error: complex input takes magnitude dictionaries; "
                      "a convolutive (m, k, T) dictionary is not supported",
                      file=sys.stderr)
                return 2
            if args.cost_every is not None:
                print("error: --cost-every is not supported by "
                      "cmfwisa_encode", file=sys.stderr)
                return 2
            parts = _load_dictionary_list(args.dictionary)
            try:
                # single-source dict -> plain factors (matching the real
                # encode engines); multi-source keeps per-source blocks
                res = nt.cmfwisa_encode(
                    V, parts[0] if len(parts) == 1 else parts, **cfg)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            save_factors(args.out, res)
            if not args.quiet:
                print(json.dumps({
                    "solver": "encode", "engine": "cmfwisa_encode",
                    "shape": list(V.shape), "k": int(W.shape[1]),
                    "iterations": int(res.n_iters),
                    "final_cost_sum": float(
                        to_host(res.cost)[:, -1].sum()),
                    "out": args.out}))
            return 0
        # A 3-D dictionary selects the convolutive engine — or, with
        # --pitch-len, the 2-D deconvolutional one (batched
        # pitch-invariant transcription).
        if args.pitch_len is not None:
            if np.ndim(W) != 3:
                print("error: --pitch-len encoding needs a 3-D (m, k, T) "
                      "dictionary (an nmf2d training checkpoint)",
                      file=sys.stderr)
                return 2
            engine = lambda Vx, Wx, **kw: nt.nmf2d_encode(  # noqa: E731
                Vx, Wx, args.pitch_len, **kw)
            engine_name = "nmf2d_encode"
        elif np.ndim(W) == 3:
            engine, engine_name = nt.cnmf_encode, "cnmf_encode"
        else:
            engine, engine_name = nt.nmf_encode, "nmf_encode"
        if args.cost_every is not None:
            # error rather than silently ignore (the CLI's convention)
            if engine_name not in ("nmf_encode", "cnmf_encode"):
                print(f"error: --cost-every is not supported by "
                      f"{engine_name}", file=sys.stderr)
                return 2
            cfg["cost_every"] = args.cost_every
        try:
            res = engine(V, W, **cfg)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        save_factors(args.out, res)
        if not args.quiet:
            print(json.dumps({
                "solver": "encode", "engine": engine_name,
                "shape": list(V.shape),
                "k": int(W.shape[1]), "iterations": int(res.n_iters),
                "final_cost_sum": float(to_host(res.cost)[:, -1].sum()),
                "out": args.out}))
        return 0

    if args.solver == "symnmf":
        # symmetric euclidean only, no sparsity penalties: error rather
        # than silently ignore (the CLI's convention).
        bad = [f for f, v in [("--divergence", args.divergence),
                              ("--alpha", args.alpha),
                              ("--beta", args.beta),
                              ("--w-sparsity", args.w_sparsity),
                              ("--h-sparsity", args.h_sparsity),
                              ("--weights", args.weights),
                              ("--fix", args.fix),
                              ("--context-len", args.context_len)]
               if v is not None]
        if bad:
            print(f"error: symnmf (symmetric euclidean A ~ H H') does "
                  f"not support: {', '.join(bad)}", file=sys.stderr)
            return 2
    if args.solver == "nmf_hals":
        # hals is euclidean-only with no sparsity penalties; error rather
        # than silently ignore flags it cannot honor.
        bad = [f for f, v in [("--divergence", args.divergence
                               if args.divergence not in (None, "euclidean")
                               else None),
                              ("--alpha", args.alpha), ("--beta", args.beta),
                              ("--w-sparsity", args.w_sparsity),
                              ("--h-sparsity", args.h_sparsity)]
               if v is not None]
        if bad:
            print(f"error: nmf_hals (euclidean HALS) does not support: "
                  f"{', '.join(bad)}", file=sys.stderr)
            return 2
        cfg.pop("divergence", None)
    if args.inner_iters is not None:
        if args.solver not in ("nmf", "nmf_hals"):
            print("error: --inner-iters is only supported for nmf/nmf_hals",
                  file=sys.stderr)
            return 2
        cfg["inner_iters"] = args.inner_iters
    if args.cost_every is not None:
        if args.solver not in ("nmf", "cnmf", "nmf2d", "lnmf",
                               "constrainednmf") or args.streaming:
            print("error: --cost-every is only supported for "
                  "nmf/cnmf/nmf2d/lnmf/constrainednmf (non-streaming)",
                  file=sys.stderr)
            return 2
        cfg["cost_every"] = args.cost_every
    if args.weights is not None:
        if args.solver not in ("nmf", "cnmf", "constrainednmf", "nmf_hals"):
            print("error: --weights is only supported for "
                  "nmf/cnmf/constrainednmf/nmf_hals", file=sys.stderr)
            return 2
        if args.streaming:
            print("error: --weights is not supported with --streaming",
                  file=sys.stderr)
            return 2
        cfg["weights"] = load_matrix(args.weights)
    if args.init and args.init != "random":
        if args.solver not in ("nmf", "nmf_hals"):
            print("error: --init nndsvd* is only supported for nmf/nmf_hals",
                  file=sys.stderr)
            return 2
        if args.resume:
            print("error: --init cannot be combined with --resume "
                  "(resume restores the factors)", file=sys.stderr)
            return 2
        cfg["init"] = args.init
    if mesh is not None:
        cfg["mesh"] = mesh
    if args.fix:
        # Only solvers with a real fixed-factor code path (the others
        # read config with .get and would silently ignore the flag).
        fixable = ("nmf", "nmfsc", "lnmf", "cnmf", "cnmfsc", "seminmf",
                   "cmfwisa", "nmf2d")
        if args.solver not in fixable:
            print(f"error: --fix is only supported for "
                  f"{'/'.join(fixable)}", file=sys.stderr)
            return 2
        if not args.resume:
            print("error: --fix requires --resume to supply the fixed "
                  "factor", file=sys.stderr)
            return 2
        cfg[f"{args.fix}_fixed"] = True
    if args.resume:
        if os.path.isdir(args.resume):  # orbax directory checkpoint
            from .utils.checkpoint_orbax import load_factors_orbax
            cfg.update(load_factors_orbax(args.resume))
        else:
            cfg.update(load_factors(args.resume))
        if args.fix:
            # Encoding new data against a frozen factor: the checkpoint's
            # OTHER factor was fit to the training sample/feature count
            # and must not be injected as an init for differently-shaped
            # new data — drop everything but the fixed factor's init.
            keep = f"{args.fix}_init"
            for key in [k for k in cfg if k.endswith("_init") and k != keep]:
                del cfg[key]

    rank_info = None
    if args.pick_rank:
        if args.k is not None:
            print("error: give either --k or --pick-rank, not both",
                  file=sys.stderr)
            return 2
        try:
            if args.pick_rank == "svd":
                # out-of-core inputs (--streaming) stream the estimate in
                # column blocks; in-memory inputs keep the one-shot path
                k, curve = nt.estimate_rank_svd(
                    V if args.streaming else np.asarray(V),
                    energy=args.rank_energy,
                    dtype=args.dtype, seed=args.seed,
                    block_size=args.block_size if args.streaming else None,
                    device=args.device)
                rank_info = {"method": "svd", "recommended": int(k),
                             "energy_curve": np.round(curve, 6).tolist()}
            else:
                ranks = tuple(int(x) for x in args.pick_rank.split(","))
                # sweep under the same objective the final fit will use
                # when the engine supports it (euclid/kl); IS/AB sweeps
                # fall back to euclid with a note in the summary.
                from .ops.divergence import canon
                sweep_div = (canon(args.divergence)
                             if args.divergence is not None else "euclidean")
                if sweep_div not in ("euclidean", "kl"):
                    sweep_div = "euclidean"
                n_seeds = args.rank_seeds
                if mesh is not None:
                    # restarts shard over the mesh's sample axis — round
                    # the restart count up to the next multiple
                    from .parallel import mesh_multiples
                    _, nmul = mesh_multiples(mesh)
                    n_seeds = -(-n_seeds // nmul) * nmul
                sel = nt.consensus_stability(
                    np.asarray(V), ranks, n_seeds=n_seeds,
                    seed=args.seed, dtype=args.dtype,
                    divergence=sweep_div, device=args.device, mesh=mesh)
                k = sel.recommended
                rank_info = {"method": "consensus",
                             "sweep_divergence": sweep_div,
                             "n_seeds": int(n_seeds),
                             "recommended": int(k),
                             "cophenetic": {str(s.rank): round(s.cophenetic, 6)
                                            for s in sel.stats},
                             "dispersion": {str(s.rank): round(s.dispersion, 6)
                                            for s in sel.stats}}
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        args.k = int(k)
    elif args.k is None:
        print("error: --k is required (or use --pick-rank)", file=sys.stderr)
        return 2

    solver = getattr(nt, args.solver)
    pos = [args.k]
    if args.solver in ("cnmf", "cnmfsc", "chcnmf", "nmf2d"):
        if args.context_len is None:
            print("error: --context-len is required for convolutive solvers",
                  file=sys.stderr)
            return 2
        pos.append(args.context_len)
    if args.solver == "nmf2d":
        if args.pitch_len is None:
            print("error: --pitch-len is required for nmf2d",
                  file=sys.stderr)
            return 2
        pos.append(args.pitch_len)
    elif args.pitch_len is not None:
        print("error: --pitch-len only applies to nmf2d (or the encode "
              "solver's 2-D engine selection)", file=sys.stderr)
        return 2
    if args.solver == "constrainednmf":
        if args.labels is None:
            print("error: --labels is required for constrainednmf",
                  file=sys.stderr)
            return 2
        pos = [np.load(args.labels), args.k]

    # Invalid option COMBINATIONS (e.g. --weights with --inner-iters > 1)
    # are validated by the solvers themselves in one place; surface their
    # ValueError as a clean CLI error instead of a traceback.
    try:
        if args.streaming:
            res = nt.nmf_streaming(V, args.k, block_size=args.block_size,
                                   epochs=max(1, args.maxiter),
                                   tolerance=args.tolerance, seed=args.seed,
                                   return_H=False, device=args.device, mesh=mesh)
            save_factors(args.out, res)
        elif args.checkpoint_every:
            res = run_checkpointed(solver, V, *pos, total_iters=args.maxiter,
                                   chunk=args.checkpoint_every, path=args.out,
                                   backend=args.checkpoint_backend,
                                   **{k: v for k, v in cfg.items()
                                      if k != "maxiter"})
        else:
            res = solver(V, *pos, **cfg)
            save_factors(args.out, res)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    summary = {"solver": args.solver, "shape": list(V.shape), "k": args.k,
               "iterations": int(res.n_iters), "converged": bool(res.converged),
               "final_cost": res.final_cost,
               "out": args.out}
    if rank_info is not None:
        summary["rank_selection"] = rank_info
    if not args.quiet:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
