#!/usr/bin/env python3
"""On-card smoke run of nmf_toolbox_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a; phase 19 needs four) and the CUDA toolkit:

    python3 chip_smoke.py

``python3 chip_smoke.py --phase 19`` runs phases 0 and 1, phase 7's V
on card 0 and phase 19 alone (four cards), and ends with the line
"phase 19 only: ok" in place of the last line below.

Phases, one line each; any failure raises and the script exits non-zero
without printing the last line:

0. before this process first touches CUDA, one bounded probe of the
   cards in a subprocess (``utils/deviceprobe.probe_auto(no_wait=True)``:
   on every card an allocation, an elementwise op and a synchronise,
   within its timeout); a dead, hung or absent card ends the run with a
   non-zero exit and the probe's words, with no CPU path.  Then the
   probe's verdict, card count and seconds, the device check (no CUDA
   device: exit 1), the card's name and power limit from nvidia-smi,
   TF32 off for matmuls and cuDNN;
1. build the CUDA kernels from csrc/ with nvcc; each kernel's registers
   and spills (none allowed in the tensor-core kernels), and for every
   instantiation of the tensor-core kernels (phi_dot_ht, wt_dot_phi and
   cost_terms in fused.cu, kl_phi_dot_ht_dma in fused_dma.cu) the count of
   tensor-core instructions (HMMA / HGMMA) in the library's SASS from
   ``cuobjdump -sass``, which must not be 0;
2. each kernel in both modes against its plain PyTorch version on the
   card at 300x700 k=40, 40 000x10 000 k=100 and 2 000x3 000 k=1024:
   max relative error <= 1e-4 (tests/test_pallas.py's f32 threshold),
   phase kernels and cost_terms bit-identical over two runs, kernel and
   plain times and the kernel's TFLOP/s (4mnk kl / 6mnk is for the
   phases, 2mnk for cost_terms' V_hat) at the main shape, beside its
   bound there: the larger of its FLOPs at the f32-accurate tensor-core
   rate (3xTF32, 495 / 3 = 165 TFLOP/s) and its bytes (V, W and H read
   once, the output written once) at 3.35 TB/s, with which of the two
   binds and the kernel's share of it; the streamed KL W-phase kernel
   (kl_phi_dot_ht_dma, k <= 512) likewise, bit-identical over two runs,
   at 300x700 k=40, the W-phase comparison's three shapes (TFLOP/s, 4mnk,
   at the main one) and both sides of each of its tier edges at
   2 000x3 000, each with the tier that ran; a ValueError at k=1024;
2b. the naive KL step's two passes (csrc/naive_kl.cu) at 40 000x10 000
   against their plain PyTorch versions on the card, V with NaN where a
   fifth of the zero weights lie (the M > 0 gate must zero them):
   ``kl_field`` (weighted) ``torch.equal`` to ``kl_field_reference``,
   ``kl_cost_terms`` weighted and unweighted within 1e-7 relative of an
   f64 sum of the plain version's f32 terms, each bit-identical over two
   runs; kernel and plain ms beside the byte bound at 3.35 TB/s (16
   bytes an entry for the field, 12 and 8 for the cost).  Then a
   weighted KL ``nmf(method="naive")`` at 40 000x10 000 r100 (80 % of
   the weights above 0), 10 iterations: W and H ``torch.equal`` to the
   same solve with the wrappers swapped for their plain versions, the
   counters (set to 0 before) at 20 fields and 10 costs, ms/iter both
   ways;
3. the main path, ``nmf(method="fused")`` at 40 000x10 000 rank 100 f32,
   KL and IS, 10 iterations, with every kernel's launch counter
   (kl_phi_dot_ht_dma's too) set to 0 before and read after, each fused
   kernel's required above 0; costs finite, KL non-increasing, and
   within rtol 2e-3 of ``method="naive"`` on the same inits
   (test_fused_solver_matches_naive's threshold), the naive KL run
   launching the naive KL cost pass once an iteration and no field pass
   (its counters set to 0 before and read after; the naive IS run none);
   ms/iteration of both;
   then torch.profiler's device time per kernel and the device's idle
   share over one more fused KL run of 10 iterations;
4. the default Euclidean ``gram`` path at 100 000x10 000 rank 200 f32,
   10 iterations (no kernel of its own: two cuBLAS GEMMs per iteration);
5. bench.py's objective check: f32 port vs the f64 NumPy oracle at
   1000x500 rank 25 over 200 iterations, within 1e-5 relative; the port
   gets NumPy arrays and no ``device=``, so its factors (and an NNDSVD
   seed of the same V) must land on the card;
5b. the card's matmul numerics (seconds): with
   ``torch.backends.cuda.matmul.fp32_precision = "tf32"`` (restored after),
   the card's 1024x1024x1024 f32 product of standard normal operands
   against the CPU's, emulated (``utils/debug.emulate_card_matmul_numerics``)
   and plain: the emulated product within 1e-5 of the card's and the
   plain one more than 1e-4 from it (max |difference| / max |entry|,
   tests/test_tpu_emulation.py's two thresholds); the products with each
   TF32 rounding (nearest-even, nearest-away, toward zero) printed beside
   them; every member of the matmul family the emulation models (``@``,
   ``mm``, ``addmm``, ``bmm``, ``einsum``, and the GEMVs
   ``mv``, ``addmv``, a vector operand, one row or one column out) at
   512x512x512, emulated within 1e-5 of the card's; printed, not gated:
   the fused kernels' products at 300x700 k=40 against their plain
   versions under the emulation (3xTF32), and BASELINE #1 (1000x500 r25,
   200 iterations, gram) on the card in TF32 and on the CPU emulated and
   plain, each against f64;
6. the W-phase comparison (benchmarks/pallas_compare.py's op and
   shapes): (V / (W H)) @ H' as the plain composition, phi_dot_ht and
   kl_phi_dot_ht_dma (with the tier that ran), ms by CUDA events, against
   the one-V-read floor from a device-to-device copy measured in the same
   run;
7. nmf_hals at 100 000x10 000 rank 200 f32: 20 plain sweeps (ms/iter,
   the sweeps' share), 20 extrapolated, bench.py's time-to-tolerance loop
   from random and NNDSVD-seeded inits (seeding inside the clock);
   weighted HALS at 20 000x2 000 rank 50; f32 card (NumPy inputs, no
   ``device=``) vs an f64 NumPy HALS at 1000x500 rank 25 over 50 sweeps,
   within 1e-4 relative;
8. nmf on the gram path at 100 000x10 000 rank 200 with init='nndsvd',
   in f32 and with data_dtype='bfloat16': costs finite and
   non-increasing, the bf16 final cost within 1e-2 of the f32 one;
9. serving (benchmarks/batched_serving_tpu.py's shape): B = 256 problems
   of 257x400 at rank 16, 100 iterations, f32, gamma bases times codes
   + 0.01.  ``nmf_batched`` euclid f32, euclid with bf16-stored V and KL;
   ``nmf_encode`` against problem 0's normalized bases, euclid and KL,
   each with cost_every 1 and 10.  Median ms per call of 3 after a
   warm-up and ms per problem; torch.profiler's idle share of a KL
   encode.  Checks: problems 0 and 255 against the port's own ``nmf``
   from the same inits (``W_fixed=True`` for encode), cost traces within
   rtol 1e-4; every trace finite and non-increasing within 1e-4
   relative; cost_every=10 leaves H bit-identical; the bf16 final costs
   within 1e-2 of f32; and each engine's inner solve runs on the card
   under ``torch.cuda.set_sync_debug_mode("error")``, so it never waits
   on the host;
10. rank selection (benchmarks/rank_sweep_tpu.py's configuration): V =
   2049x4000 of true rank 12, 16 restarts.  ``nmf_multiseed`` euclid and
   KL at rank 16 (restarts 0 and 15 against single ``nmf`` runs within
   rtol 1e-4; the euclid run's peak device memory far below 16 copies
   of V), ``pick_rank`` over ranks 8, 16, 24, 32 with its seconds split
   into the solves and scipy's linkage, and ``estimate_rank_svd`` on
   phase 4's 100 000x10 000 V in memory on the card and streamed from a
   host copy in blocks of 2000 columns: same rank, curves within 1e-4;
11. streaming at phase 7's 100 000x10 000 r200 f32 V, copied to the host
   once: ``nmf_streaming`` (blocks of 2048 columns, 5 epochs, 3 inner
   encodings) from the host array and from a ``.npy`` memmap of it
   written to a temporary directory (write time printed), which must
   give the same W and cost trace bit for bit; finite epoch costs, the
   last no higher than the first; the device memory it adds (peak over
   the call, ``max_memory_allocated``) below 2.5 GB while V is 4.0 GB.
   ``nmf_encode_streaming`` KL, 20 iterations, of the memmap into a
   (k, n) memmap against the trained W, and in-memory ``nmf_encode`` of
   V from the same H_init: cost traces within rtol 1e-4, H within 1e-3
   of its largest entry.  Prints s/epoch, GB/s of V streamed, the host
   gather and the pinned and pageable host-to-device GB/s of one block,
   and ``profile_device_ms``' split and idle share of one epoch;
12. the Gram/MU family at benchmarks/gram_family_marginal.py:57's
   100 000x10 000 r200 f32, on phase 7's V: ``lnmf``, ``seminmf``,
   ``convexnmf`` (non-negative V: the 3-product step), ``chnmf`` (S = V's
   first 400 columns) and KL ``constrainednmf`` (half the columns labeled
   in 10 classes), ms per iteration from calls of 2 and 22 iterations;
   seconds of the one-time Grams (V'V; S'V with S'S) and of the default
   inits (``kmeans_indicator_h`` at k = 200, ``convex_hull_anchors`` on
   its randomized path, with the anchor count p); ``symnmf`` on a planted
   20-block similarity of n = 10 000 at k = 20 (ms per iteration; after
   300 iterations its row-wise argmax matches the blocks on >= 95 % of
   the points under the best matching). Checks: every run finite with all
   its iterations; the six goldens of tests/goldens on the card in f64 at
   tests/test_goldens.py's tolerances (factors atol 1e-9, costs rtol
   1e-9, constrainednmf's A exact); each solver in f32 on the card (NumPy
   inputs, no ``device=``) within 1e-4 relative of the port's f64 run on
   the CPU, cost traces at 1000x500 r25 over 50 iterations (symnmf on a
   planted 25-block similarity of n = 500). The kernel counters (the
   naive KL passes' too), set to 0 before phase 11, are printed after
   phase 12: this slice's path runs no kernel;
13. the convolutive family at the JAX package's shapes for it, f32: ``cnmf``
   at 513x10 000 r64 T8 (euclid ``gram`` and ``naive``, KL, IS) and
   ``nmf2d`` there with P5 (euclid, KL), ms per iteration from calls of 2
   and 22 iterations, the gram trace within rtol 1e-4 (plus 8 eps_f32
   ||V||^2) of naive's; ``chcnmf`` at 100 000x10 000 r200 T8 on phase 7's
   V with S = its first 500 columns: the one-time S'V and S'S in seconds,
   ms per iteration, and the inner fit of G to a W_init (all steps and
   one); ``cnmf_encode`` (T4) and ``nmf2d_encode`` (T3 P4) on phase 9's
   batch, euclid and KL at cost_every 1 and 10, median ms per call, held
   like phase 9's encodes to the port's ``cnmf`` / ``nmf2d`` with
   ``W_fixed=True`` (problems 0 and 255), cost_every=10 leaving H
   bit-identical, the inner solves under set_sync_debug_mode("error");
   ``profile_device_ms`` of a KL ``cnmf`` call and a KL ``cnmf_encode``
   call; the goldens cnmf_euclid (both methods), chcnmf and nmf2d_kl on
   the card in f64 at tests/test_goldens.py's tolerances; each solver in
   f32 on the card (NumPy inputs, no ``device=``) within 1e-4 relative of
   its f64 run on the CPU, cost traces at 129x400 r8 T4 P3 (chcnmf p = 40)
   over 50 iterations.  The kernel counters (the naive KL passes' too),
   set to 0 before phase 13, must read 0 after it: the JAX modules it
   ports reach no pallas_call, and it runs no naive KL ``nmf``;
14. the projected-gradient and complex solvers and the audio front end at
   the JAX package's shapes for them, f32, TF32 off.  ``nmfsc`` at
   BASELINE #2's 5000x2000 r50 with H_sparsity 0.6, V uniform in [0.1, 1]
   (benchmarks/run_all.py:162-208), at linesearch_width 0 and 8: ms and
   host reads (``core.host_reads``) per iteration from calls of 2 and 22
   iterations, the two widths' traces within rtol 1e-3; ``nmfsc`` at
   100 000x10 000 r200 on phase 7's V with W_sparsity 0.5 and H_sparsity
   0.6, ms/iter and ``profile_device_ms``' split; ``cnmfsc`` at 513x10 000
   r64 T8 with H_sparsity 0.5 (benchmarks/cnmfsc_marginal_tpu.py:31-41),
   and with W_sparsity 0.5 too (which ends on a line-search underflow in
   its first iteration, as the reference does), ms/iter, reads and the
   idle share of one call; ``cmfwisa`` complex64 at 513x5000 r32
   (run_all.py:231-269), one source and two (16 + 16); ``cmfwisa_encode``
   on phase 9's batch with uniform random phases, median ms per call,
   problems 0 and 255 against ``cmfwisa(W_fixed=True)`` as phase 9 holds
   its encoders, the solve under set_sync_debug_mode("error"); the audio
   path on a synthetic two-source waveform (n_fft 1024, hop 256, 513 x
   5000 frames): ``istft(stft(x))`` within 1e-5 of x, two-source
   ``cmfwisa`` and ``separate_waveforms`` (the estimates sum to
   ``istft(Z)`` within 1e-4), 32 ``griffinlim`` iterations, ms each; the
   goldens nmfsc_sparse, cnmfsc_sparse and cmfwisa in f64 at
   tests/test_goldens.py's tolerances; f32 on the card (NumPy inputs, no
   ``device=``) against f64 on the CPU: cmfwisa's cost trace within 1e-4,
   nmfsc's and cnmfsc's final cost within 1e-3 relative, with whether
   their step sizes agreed; every nmfsc / cnmfsc trace non-increasing
   within 1e-5 relative.  The kernel counters (the naive KL passes'
   too), set to 0 before phase 14, must read 0 after it.
15. the checkpointed run, io, native, the CLI, the estimator and the
   debug helpers (~45 s), on phase 3's V (rebuilt from its seed) and
   phase 7's: ``run_checkpointed(nmf, method="fused")`` KL at 40 000x10 000
   r100, 20 iterations in chunks of 5, bit-identical to one call (W, H,
   costs), each fused kernel's counter set to 0 before it and 20 after, a
   crash after 10 resumed from the file bit-identical too, ms/iter both
   ways and the save per chunk; extrapolated ``nmf_hals`` at 100 000x10 000 r200
   and ``nmfsc`` at BASELINE #2, chunked (HALS also crash-resumed)
   bit-identical to one call; ``native.available()`` must be true;
   phase 7's V as a 4 GB .npy through ``save_matrix``, read back
   bit-equal by ``load_matrix`` (native) and ``np.load``, GB/s each;
   ``convex_hull_anchors`` there with the native and the Python chain,
   the same anchors, seconds against PR 8's 2.98; ``python -m
   nmf_toolbox_tpu_torch nmf`` on that .npy at r200 with checkpoints
   every 5 iterations in a subprocess, its factors within 1e-6 of one
   ``nmf`` call in process (and whether the bits match), then
   the same command in process, timed into load, solve and save;
   ``estimators.NMF(method="fused")`` KL on X = V.T, its NumPy outputs
   equal to ``nmf``'s W.T and H.T bit for bit, 20 launches of each fused
   kernel; ``profile_to`` around 3 fused iterations under ``trace("nmf")``
   writes a Chrome trace naming ``phase_kernel``, ``cost_kernel`` and
   ``nmf``; ``check_finite`` passes the run and raises on a NaN copy;
   ``iteration_logger`` through ``callback=`` prints 3 lines.
16. mesh= on the card (~60 s).  One NCCL rank (``init_distributed`` with
   world size 1, ``make_mesh(1)``): ``nmf`` fused KL and IS at 40 000x10 000
   r100, gram on phase 7's V and ``nmf_hals`` on a V of rank 200 plus
   noise at 100 000x10 000 r200, ``nmf`` gram with ``init="nndsvd"`` and
   ``nmf_hals`` with ``init="nndsvda"`` on that V as a host array, 10
   iterations each, and ``nmf_batched`` euclidean and ``nmf_encode`` KL on
   phase 9's batch, each bit-identical to the same call with no mesh, ms
   per iteration (or call) of both and collectives per iteration; the
   fused kernels' counters, set to 0 before, above 0 after.  Then two
   ranks spawned by the script, sharing the card over Gloo (``make_mesh(2)``):
   the first four runs at 5 iterations and the engines on the batch split
   in two, the ranks bit-identical to each other and within 1e-4 of one
   rank (W, H and the cost), with each rank's ms, collectives and device
   memory peak, and each rank's fused-kernel counters, set to 0 before,
   above 0 (kl_phi_dot_ht_dma's at 0, on one rank and on two); ``run_checkpointed(nmf, method="fused", backend="orbax")``
   over the two ranks, 20 iterations in chunks of 5, straight through and
   crash-resumed, bit-identical to one meshed call, with the ms per save.
   Phase 19 runs a mesh of one NCCL rank a card where there are four.
17. mesh= for the rest of the solvers (~1.5 min).  One NCCL rank, 5
   iterations each, every input a tensor on the card: ``lnmf``,
   ``seminmf``, ``convexnmf``, ``chnmf`` and ``constrainednmf`` KL at
   100 000x10 000 r200 on phase 7's V with phase 12's inits, ``symnmf``
   on phase 12's planted n = 10 000 r20, ``cnmf`` gram and KL and
   ``nmf2d`` KL (P5) at 513x10 000 r64 T8, ``chcnmf`` at 100 000x10 000
   r200 T8 p500, ``nmfsc`` at 5000x2000 r50 H_sparsity 0.6, ``cnmfsc``
   at 513x10 000 r64 T8 H_sparsity 0.5, ``cmfwisa`` complex64 at
   513x5000 r32, and one epoch of ``nmf_streaming`` of phase 7's V from
   a host copy: each bit-identical (every field) to the same call with
   no mesh, with ms per iteration of both and collectives per
   iteration.  From a host copy of phase 7's V, as the CLI passes it:
   ``convexnmf`` and ``chnmf`` with their default inits bit-identical to
   no mesh, the k-means and the hull search reading V on the card, and
   ``convexnmf`` with phase 12's inits (its rows of V'V built from the
   host V in column chunks) within 1e-4 of no mesh.  Then two Gloo ranks spawned by the script sharing the
   card (``make_mesh(2)``): cnmf gram, nmf2d KL, chcnmf and cnmfsc at
   those shapes (the T - 1 columns of context cross the split),
   ``nmfsc`` with both factors sparse and ``constrainednmf`` KL on
   5000x2000 r50 with 40 % of the columns unlabeled (labeled columns on
   both ranks), ``symnmf`` at n = 9 999 (padded to two ranks),
   ``cmfwisa`` and one epoch of ``nmf_streaming`` at 20 000x10 000 r100
   from the host: the ranks bit-identical to each other and within 1e-4
   of one rank on W, H and the cost, nmfsc and cnmfsc in f64 within
   1e-9 (their line searches compare summed objectives, whose f32 order
   could flip a decision).  The six kernels' counters (the fused three,
   the dma one and the naive KL passes), set to 0 at the phase's start,
   read 0 at its end on every process; the phase prints
   its wall time.
18. nmfsc's phased dispatch and its kernel (~1.5 min).  (a) the Hoyer
   projection kernel (hoyer_project, csrc/hoyer.cu) against its plain
   version on the card in f32 and f64, 48 passes allowed: first every
   tier of the kernel's table (``hoyer_tiers``, read from the library:
   one CTA, clusters of 2 to 16 CTAs) at its largest N on 3 vectors,
   every other tier's as a strided W.mT view; then H's 50 rows of 2000
   and W's 50 columns of 5000 (BASELINE #2; the columns as a strided
   W.mT view), 200 rows of 10 000 and 200 columns of 100 000 (phase 7's
   shape), a batched round of 8 x 50 x 2000, the streaming tier on 3
   vectors of 1 000 000, W's columns padded (``valid`` 99 000 of 100 000)
   and targets k1 and k2 per vector at H's and W's shapes: the same done
   flags, pass counts equal in f64 and within one in f32 (the sums'
   order), max error within 1e-4 (f32) and 1e-10 (f64) of the largest
   entry, the pad 0, identical bits over two runs.  For
   each case after the sweep: the device ms a call (CUDA events around
   each of 20 calls queued behind a device sleep) and the kernel's own
   ms a launch from ``profile_device_ms`` over 20 calls (the mean over
   the launches the profiler saw, with the share of the calls it saw: in
   a long process it loses some), beside the ms a call by CUDA events
   over 20 back-to-back calls, which the host paces (at W's shapes the
   wrapper copies the strided columns contiguous first), at H's 50 rows
   of 2000 the wrapper's host µs a call (200 calls queued, the clock read
   before the synchronise), the plain version's ms and the bound, the larger of one
   read of S and one write of v at 3.35 TB/s and 12 operations per entry
   and pass at 67 (f32) or 34 (f64) TFLOP/s, with the share of it.  (b)
   ``nmfsc(dispatch="phased")`` against the default dispatch in turns
   (default, phased, phased, default) through ``sparse_timing`` at
   BASELINE #2 (H_sparsity 0.6, bench.py's seed-3 inits) and at
   100 000x10 000 r200 with W 0.5 and H 0.6 on phase 7's V: ms, host
   reads and ``hoyer_project`` launches per iteration (the default's
   projections launch it too), final f32 costs within
   1e-3; ``profile_device_ms`` (device kernels per iteration, idle
   share) of both dispatches at BASELINE #2 and of the phased one at
   full width; linesearch_width 8 through both dispatches at BASELINE
   #2, final costs within 1e-3.  (c) bench.py's ``_nmfsc_b2_child`` on
   the port: 30 phased iterations, best wall s of two.  Then phased
   (and phased with trials=2, whose searches take the slow path's host
   redo) against default in f64 at 200x300 r10 (both sparse, 50
   iterations) within rtol 1e-9 with the same n_iters; hoyer_project's counter, set to 0 before (b),
   above 0 and the four fused counters 0; phased with a one-rank NCCL
   mesh raises ValueError.  The phase prints its wall time.

19. the mesh on four cards (~2 min), where ``torch.cuda.device_count()``
   is at least 4 (else one line: "did not run", with the card count),
   after a check that phase 0's probe counted as many live cards: the links (``nvidia-smi topo -m``, ``nvidia-smi nvlink --status``,
   peer access), then four ranks spawned by the script, one NCCL rank a
   card (rank r on card r), each on ``make_mesh(4)`` and on
   ``make_mesh(shape=(2, 2))``, running at full width, 10 iterations:
   ``nmf`` fused KL and IS at 40 000x10 000 r100, gram from phase 16's
   inits and with NNDSVD seeding from a host V, ``nmf_hals`` and default
   ``nmfsc`` (W 0.5, H 0.6) at 100 000x10 000 r200; at phase 17's shapes,
   3 iterations: the Gram/MU family, cnmf, nmf2d, chcnmf, nmfsc and
   cnmfsc in f64, constrainednmf, symnmf, cmfwisa, one streamed epoch,
   KL ``nmf`` with weights, and the engines (``nmf_multiseed``,
   ``nmf_batched``, ``nmf_encode``, ``cnmf_encode``, ``nmf2d_encode``,
   ``cmfwisa_encode``; phases 9-10's inputs, 3 iterations).  Rank 0 runs
   each also with no mesh on card 0.  Per solve and mesh: every rank
   bit-identical to rank 0 (a hash of W, H and the cost), the largest
   relative error of W, H and the cost against one card within 1e-4 (f32)
   or 1e-9 (f64), the same n_iters; the f32 HALS, seminmf and full-width
   nmfsc, whose steps amplify the order of a sum past 1e-4, are timed
   and their error printed, and an f64 twin of each is held to 1e-9;
   HALS from NNDSVDA seeds of a host V runs in f64: the seeds (NNDSVDA
   of the whole V on each rank's card, as the solver seeds under a mesh)
   and 1 iteration are held to 1e-9; at 5 iterations its error is
   printed and not held (3.5e-8 in W, cost 7.7e-10).
   ms/iter on one card and on each rank, collectives per iteration, MB
   reduced per iteration (PERF.md §3's formulas), each rank's kernel
   counters (set to 0 before the meshed call): the three fused kernels
   above 0 on every rank of the fused runs and ``kl_phi_dot_ht_dma`` at
   0, ``hoyer_project`` above 0 on every rank of nmfsc and cnmfsc, no
   fused kernel elsewhere; the naive KL passes on every rank of the
   weighted KL ``nmf`` (two fields and one cost, each rank's own block's,
   an iteration) and nowhere else.  On each mesh ``save_factors_orbax`` and
   ``load_factors_orbax`` of a fused KL result restored bit-identical,
   and ``run_checkpointed`` fused KL, 20 iterations in chunks of 5,
   straight and crash-resumed, bit-identical to one meshed call.  The
   device ms (CUDA events, 20 calls) and host µs of one ``all_reduce`` of
   3 floats to 80.2 MB between the four cards and within each axis of
   the 2x2 mesh, of the port's ``sum_all`` of two tensors, of cnmf's
   halo (an ``all_gather`` of T - 1 columns a rank), and of a
   host-bound step's round trip (3 floats summed over the four cards and
   read back) beside the same step with no sum.  Then ``torchrun --nproc-per-node 4 -m
   nmf_toolbox_tpu_torch nmf V.npy --k 200 --mesh 4`` on phase 7's V
   from injected inits: every rank exits 0, rank 0 alone prints, the
   factors within 1e-4 of the same command in process on card 0, and no
   process of the command left after it.  The phase prints its wall
   time.

Then the card's name and power limit once more (a long log's tail
keeps them), a JSON line of per-kernel results and, last, the device
line.  A
kernel's ``launches`` count its launches on its path: phase 3 for the
three fused kernels, phase 6 (the only path that runs it) for
kl_phi_dot_ht_dma, phase 18's (b) and (c) for hoyer_project, phase 2b's
weighted solve for kl_field and kl_cost (``launches_unweighted``: the
cost's in phase 3's naive KL run), each counter set to 0 just before; ``launches_per_iter`` is each fused
kernel's launches in phase 3's two fused runs over their iterations
(kl_phi_dot_ht_dma's counted there too, where no solver calls it), and
hoyer_project's per phased iteration at BASELINE #2 in (b), with
``launches_per_iter_default`` the default dispatch's there; its ms (the
device's, events queued behind a device sleep; ``profiler_ms`` the
kernel's own a launch from the profiler, null only where it saw no
launch, and ``profiler_seen`` the share of the calls it saw; ``event_ms``
by CUDA events back to back; ``host_us`` the wrapper's),
plain ms and bound are at H's 50 rows of 2000 in f32; the naive KL
passes' at 40 000x10 000 (phase 2b).  ``library_ms`` is null for all
seven: no single PyTorch call computes any of them.  Each fused
kernel's, hoyer_project's and the naive KL passes' entry also lists its
launches on each rank in phase 19's 1x4 run (fused KL; full-width
nmfsc; weighted KL), or null where phase 19 did not run.  Imports nothing of JAX.  Phases 16, 17 and
19 join their spawned ranks and stop multiprocessing's resource tracker
before they end; on the way
out, pass or fail, any child process still there is stopped and named
on stderr.
"""
from __future__ import annotations

import importlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

KERNELS = (("phi_dot_ht", "nmf_toolbox_tpu/ops/pallas/fused.py:128"),
           ("wt_dot_phi", "nmf_toolbox_tpu/ops/pallas/fused.py:218"),
           ("cost_terms", "nmf_toolbox_tpu/ops/pallas/fused.py:292"))
SOURCE = "nmf_toolbox_tpu_torch/csrc/fused.cu"
# The tensor-core kernels: wrapper, kernel template and the template
# arguments that select it in the mangled name (phase_kernel's TRANS).
TENSOR_CORE = (("phi_dot_ht", "phase_kernel", "ILb0E"),
               ("wt_dot_phi", "phase_kernel", "ILb1E"),
               ("cost_terms", "cost_kernel", "ILb"),
               ("kl_phi_dot_ht_dma", "kl_dma_kernel", "ILi"))
DMA = ("kl_phi_dot_ht_dma", "nmf_toolbox_tpu/ops/pallas/fused_dma.py:85",
       "nmf_toolbox_tpu_torch/csrc/fused_dma.cu")
# The naive KL step's passes: no pallas_call, the XLA fusion of the JAX
# package's fields and cost in its jitted loop.
NAIVE_KL = (("kl_field", "nmf_toolbox_tpu/ops/divergence.py:74 (weighted KL, fused by XLA)"),
            ("kl_cost", "nmf_toolbox_tpu/ops/divergence.py:173 (KL, fused by XLA)"))
NAIVE_KL_SOURCE = "nmf_toolbox_tpu_torch/csrc/naive_kl.cu"
NAIVE_KL_BYTES = {"kl_field": 16, "kl_cost": 12, "kl_cost unweighted": 8}  # an entry
NAIVE_KL_COST_RTOL = 1e-7  # the card's f64 sum, rounded once to f32
CHECK_SHAPES = ((300, 700, 40), (40_000, 10_000, 100), (2_000, 3_000, 1024))
# Both sides of each edge between kl_phi_dot_ht_dma's tiers, and k = 512.
DMA_EDGES = tuple((2_000, 3_000, k) for k in (128, 129, 256, 257, 424, 425, 512))
MAIN = (40_000, 10_000, 100)   # the KL shape of models/nmf.py:316-321
GRAM = (100_000, 10_000, 200)  # bench.py's headline shape
COMPARE = ((40_000, 10_000, 100), (20_000, 5_000, 100), (10_000, 10_000, 200))
# ^ benchmarks/pallas_compare.py:32
WEIGHTED = (20_000, 2_000, 50)  # weighted HALS: 2k passes over m*n per sweep
SERVING = (256, 257, 400, 16)  # B, m, n, k: benchmarks/batched_serving_tpu.py:39
RANK_SWEEP = (2049, 4000, 12)  # m, n, true rank: benchmarks/rank_sweep_tpu.py:50-56
RANK_SEEDS, RANK_CANDIDATES = 16, (8, 16, 24, 32)
SVD_BLOCK = 2000      # columns per block of the streamed rank estimate
STREAM_BLOCK, STREAM_EPOCHS, STREAM_INNER = 2048, 5, 3  # phase 11's nmf_streaming
STREAM_PEAK = 2.5e9   # bytes of device memory nmf_streaming may add (V is 4.0 GB)
ENCODE_ITERS = 20     # phase 11's KL encodes
FAMILY_ITERS = 20     # phase 12's timed iterations per solver
CHNMF_ANCHORS = 400   # phase 12's S = V's first columns
LABEL_CLASSES = 10    # phase 12's constrainednmf: half of V's columns labeled
SYM = (10_000, 20)    # phase 12's symnmf: n, k of a planted block similarity
SYM_RECOVERY_ITERS, SYM_ACCURACY = 300, 0.95  # 20 iterations do not recover it
SMALL, SMALL_ITERS = (1000, 500, 25), 50  # phase 12's f32 card vs f64 CPU runs
CONV = (513, 10_000, 64, 8)  # m, n, k, T: benchmarks/run_all.py:212-221, cost_every_tpu.py:13
CONV_P = 5            # nmf2d's pitch shifts: benchmarks/solver_marginal_sweep.py:112-132
CONV_ITERS = 20       # phase 13's timed iterations per solver (calls of 2 and 22)
CHCNMF = (200, 8, 500)  # k, T, anchors p on phase 7's V: benchmarks/hull_marginal.py:32-34,98-138
CONV_ENCODE_T, NMF2D_ENCODE_TP = 4, (3, 4)  # benchmarks/batched_serving_tpu.py:84-126
CONV_SMALL = (129, 400, 8, 4, 3, 40)  # m, n, k, T, P, p: phase 13's f32 card vs f64 CPU runs
CONV_GOLDEN_TOL = {"cnmf_euclid": 1e-8, "chcnmf": 1e-8, "nmf2d_kl": 1e-9}  # test_goldens.py
F32_RTOL = 1e-4       # f32 on the card vs f64 on the CPU, cost traces
SPARSE_BASE = (5000, 2000, 50)  # nmfsc, BASELINE #2: benchmarks/run_all.py:162-208
SPARSE_WIDTHS = (0, 8)  # linesearch_width: sequential, and the JAX package's TPU width
SPARSE_ITERS = 20      # phase 14's timed iterations (calls of 2 and 22)
SPARSE_MONO = 1e-5     # nmfsc / cnmfsc traces non-increasing within this, relative
WIDTH_RTOL = 1e-3      # widths 0 and 8: cost traces (the JAX package measured ~4e-5)
SPARSE_F32_RTOL = 1e-3  # nmfsc / cnmfsc final cost, f32 card vs f64 CPU
CMF = (513, 5000, 32)  # cmfwisa complex64: benchmarks/run_all.py:231-269
AUDIO = (1024, 256, 5000, 20, 32)  # n_fft, hop, frames, cmfwisa and griffinlim iterations
AUDIO_ATOL = (1e-5, 1e-4)  # istft(stft(x)) vs x; the separated sum vs istft(Z)
SPARSE_SMALL = (200, 300, 10, 4)  # m, n, k, T of phase 14's f32-vs-f64 runs (cnmfsc: 129 bins)
SPARSE_GOLDEN_TOL = {"nmfsc_sparse": 1e-9, "cnmfsc_sparse": 1e-9, "cmfwisa": 1e-9}  # test_goldens.py
GOLDEN_ATOL = GOLDEN_RTOL = 1e-9  # tests/test_goldens.py, f64
NEVER = 1e-30         # a tolerance no stop rule meets (0 falls back to 1e-3)
CKPT_ITERS, CKPT_CHUNK = 20, 5  # phase 15's checkpointed runs, CLI and estimator
CLI_RTOL = 1e-6       # the CLI's factors against one nmf call in process
HULL_PR8_S = 2.98     # convex_hull_anchors at 100 000x10 000 in PR 8's phase 12
SLEEP_CYCLES = 10 ** 9  # ~0.5 s of device clock ahead of each gated solve
QUEUE_CYCLES = 5 * 10 ** 7  # ~25 ms of device clock while phase 18 queues its timed calls
GATE_ITERS = 10       # iterations of a gated solve (its launches fit the queue)
REL_TOL = 1e-4        # tests/test_pallas.py, f32 path
SOLVER_RTOL = 2e-3    # tests/test_pallas.py::test_fused_solver_matches_naive
ORACLE_RTOL = 1e-5    # bench.py objective check
HALS_ORACLE_RTOL = 1e-4  # f32 HALS vs f64 HALS objective, 50 sweeps
EMULATED_TOL = 1e-5   # emulated vs the card's TF32 product (tests/test_tpu_emulation.py)
PLAIN_MIN = 1e-4      # plain f32 vs the card's TF32 product: the emulation is no no-op
NUMERICS_SHAPE = 1024  # phase 5b's product, n x n x n
FAMILY_SHAPE = 512    # phase 5b's matmul family, n x n x n
BF16_RTOL = 1e-2      # bf16-stored V vs f32 V, final gram-path cost
ENGINE_RTOL = 1e-4    # batched engines vs single nmf, f32 cost traces
GRAM_SLACK = 8 * float(np.finfo(np.float32).eps)  # of ||V||^2, euclidean traces
FACTOR_RTOL = 1e-3    # batched engines vs single nmf, f32 factors (of max |x|)
CURVE_ATOL = 1e-4     # in-memory vs streamed energy curves, f32
REL_DECREASE_TOL = 1e-4  # bench.py:52
TOL_CHUNK, TOL_CAP = 20, 600  # bench.py:103,133
ITERS = 10
HALS_ITERS = 20
ENGINE_ITERS = 100  # phases 9 and 10
MESH_RANK_ITERS = 5   # phase 16's two-rank runs
MESH_RTOL = 1e-4      # two ranks vs one, f32 (the engines' threshold)
MESH_TIMEOUT = 150    # seconds: phase 16's process groups and its ranks' answers
MESH_RTOL_F64 = 1e-9  # phase 17's f64 two-rank runs vs one rank (tests/test_parallel.py)
SYM17 = (9_999, 20)   # phase 17's two-rank symnmf: an odd n, padded to two ranks
STREAM17 = (20_000, 10_000, 100)  # phase 17's two-rank nmf_streaming, one epoch
ERROR_GRACE = 30      # seconds the other ranks get once one has failed
CARDS19 = 4           # phase 19's cards, one NCCL rank each
ITERS19 = 10          # phase 19's full-width solves (phase 16's depth)
SMALL_ITERS19 = 3     # phase 19's solves at phase 17's shapes (phase 17: 5; engines: 100)
TIMEOUT19 = 600       # seconds: phase 19's process group and its ranks' answers
ALLREDUCE_REPS = 20   # all_reduce calls per timing
# Phase 19's all_reduce sizes in floats, from PERF.md §3's formulas (1-D mesh of 4).
ALLREDUCE19 = {"3 floats": 3, "k x k at r200, 0.16 MB": 200 * 200,
               "fused KL W-phase, 16.0 MB": 40_000 * 100,
               "fused IS W-phase, 32.0 MB": 2 * 40_000 * 100,
               "gram V H' and H H', 80.2 MB": 100_000 * 200 + 200 * 200}
HOYER = ("hoyer_project",
         "nmf_toolbox_tpu/ops/projection.py:89 (project_columns' lax.while_loop); "
         "nmf_toolbox_tpu/models/nmfsc_phased.py:70 (_project_columns_bounded's lax.fori_loop)",
         "nmf_toolbox_tpu_torch/csrc/hoyer.cu")
# Phase 18's projections: label, rows x length (W's columns as rows of
# W.mT, a strided view), sparseness.  BASELINE #2's H and W, phase 7's
# shape, and one batched round of 8 candidates of BASELINE #2's H.
HOYER_SHAPES = (("H rows", (50, 2000), False, 0.6), ("W columns", (50, 5000), True, 0.5),
                ("H rows", (200, 10_000), False, 0.6), ("W columns", (200, 100_000), True, 0.5),
                ("batched round", (8, 50, 2000), False, 0.6))
# Phase 18 (a)'s further cases: label, rows x length, W.mT view, sparseness,
# valid (None: all), targets per vector.  The streaming tier (vectors
# longer than a cluster holds), padded columns as a mesh pads W, and
# per-vector k1 and k2 as projfunc's callers may give them.
HOYER_EXTRA = (("streaming tier", (3, 1_000_000), False, 0.6, None, False),
               ("valid W columns", (200, 100_000), True, 0.5, 99_000, False),
               ("per-vector k H rows", (50, 2000), False, 0.6, None, True),
               ("per-vector k W columns", (200, 100_000), True, 0.5, None, True))
HOYER_TIER_ROWS = 3  # vectors per case of the tier sweep
HOST_REPS = 200  # calls for the wrapper's host µs per call
HOYER_RTOL = {"float32": 1e-4, "float64": 1e-10}  # of the largest entry
HOYER_PASS_SLACK = {"float32": 1, "float64": 0}  # the sums' order may move a pass in f32
HOYER_OPS = 12  # operations (an FMA as two) per entry and pass, counted from csrc/hoyer.cu
PHASED_RTOL_F64 = 1e-9  # phased vs default nmfsc in f64 on the card
DISPATCH = {"default": None, "phased": "phased"}  # nmfsc's dispatch= for phase 18
B2_ITERS, B2_SEED = 30, 3  # bench.py's _nmfsc_b2_child
# The card's peaks for a kernel's bound (H100 SXM data sheet): f32-accurate
# tensor-core work in 3xTF32 (three TF32 products per f32 product) and
# device memory.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# outside the tensor cores, for the Hoyer projection's arithmetic
PEAK_SIMT = {"float32": 67e12, "float64": 34e12}


def say(msg):
    print(msg, flush=True)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def rel_err(a, b):
    """max |a - b| / max(|b|, 1e-6), in f64 (test_pallas.py's measure)."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def profile_device_ms(torch, run, iters):
    """Device ms per iteration by kernel (the 12 largest), busy and wall ms
    per iteration, device kernels per iteration and the device's idle
    share, from torch.profiler over one call of ``run``, which runs
    ``iters`` iterations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel, counts, kernels = {}, {}, 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            by_kernel[evt.key[:80]] = us / 1e3 / iters
            counts[evt.key[:80]] = evt.count / iters
            kernels += evt.count
    busy = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {"device_ms_per_iter": top, "busy_ms_per_iter": busy,
            "wall_ms_per_iter": wall / iters, "kernels_per_iter": kernels / iters,
            "idle_share": 1 - busy * iters / wall,
            "launches_per_iter_by_kernel": {k: counts[k] for k in top}}


def phase0_probe():
    """The bounded probe of the cards, run before this process touches
    CUDA: a card that hangs or no longer computes stops the run here, in
    the probe's subprocess, and not in a CUDA call of this process that
    nothing could end.  Exits non-zero unless the verdict is a live card."""
    from nmf_toolbox_tpu_torch.utils import deviceprobe
    t0 = time.perf_counter()
    platform, count = deviceprobe.probe_auto(no_wait=True)
    seconds = time.perf_counter() - t0
    if platform != "cuda" or count < 1:
        raise SystemExit(f"chip_smoke: the device probe found no live CUDA card "
                         f"(verdict {platform}, {count} cards, {seconds:.1f} s; the "
                         "probe's words are above on stderr); no CPU path")
    return {"verdict": platform, "count": count, "seconds": seconds}


def phase0_device(torch, probe):
    say(f"phase 0 probe: {probe['verdict']}, {probe['count']} card"
        f"{'' if probe['count'] == 1 else 's'}, {probe['seconds']:.2f} s "
        "(utils/deviceprobe.probe_auto(no_wait=True), before this process "
        "touched CUDA)")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    say(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 0 device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def flops(name, mode, m, n, k):
    """The FLOPs a kernel's algorithm needs: V_hat (2mnk) plus one (kl) or
    two (is) contractions of 2mnk for the phases; V_hat for cost_terms."""
    if name == "cost_terms":
        return 2 * m * n * k
    return (4 if mode == "kl" else 6) * m * n * k


def bound(name, mode, m, n, k):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a kernel's work, the larger of its FLOPs at PEAK_FLOPS and its
    bytes (V, W, H read once, its outputs written once) at PEAK_BYTES."""
    outs = 2 if mode == "is" else 1
    out_floats = {"phi_dot_ht": m * k, "kl_phi_dot_ht_dma": m * k,
                  "wt_dot_phi": k * n, "cost_terms": 1}[name] * outs
    nbytes = 4 * (m * n + m * k + k * n + out_floats)
    t_ops, t_bytes = flops(name, mode, m, n, k) / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_counts(_build):
    """HMMA / HGMMA instructions per kernel function of the built library,
    from cuobjdump -sass (beside nvcc in the toolkit)."""
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def instance_of(fn, template):
    """Whether the mangled kernel name ``fn`` is an instantiation of
    ``template``: its length-prefixed name before the template arguments
    (``11cost_kernelI``), so that ``kl_cost_kernel`` is not ``cost_kernel``."""
    return f"{len(template)}{template}I" in fn


def phase1_build():
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name}, from {len(_build.sources())} sources)")
    counts = tensor_core_counts(_build)
    for wrapper, template, selector in TENSOR_CORE:
        mine = {fn: c for fn, c in counts.items()
                if instance_of(fn, template) and selector in fn}
        say(f"phase 1 sass {wrapper}: {sum(mine.values())} tensor-core instructions "
            f"(HMMA/HGMMA) in {len(mine)} instantiations of {template} "
            f"({sorted(mine.values())})")
        if not mine or min(mine.values()) == 0:
            raise AssertionError(f"{wrapper}: an instantiation of {template} has no "
                                 "HMMA or HGMMA in the library's SASS")
    # Each kernel's registers and spills, from nvcc's -Xptxas -v output.
    name = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            short = name.split("_cu_")[-1] if "_cu_" in name else name
            say(f"phase 1 ptxas {short}: {line.split(':', 1)[1].strip()}; {spills}")
            if (any(instance_of(name, template) for _, template, _ in TENSOR_CORE)
                    and "0 bytes spill stores, 0 bytes spill loads" not in spills):
                raise AssertionError(f"{short} spills: {spills}")
            name = None


def phase2_kernels(torch, fk, main_V):
    stats = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0} for name, _ in KERNELS}
    rng = np.random.default_rng(1)
    for (m, n, k) in CHECK_SHAPES:
        if (m, n) == MAIN[:2]:
            V = main_V
        else:
            V = torch.from_numpy(rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
        W = torch.from_numpy(rng.uniform(0.1, 1, (m, k)).astype(np.float32)).cuda()
        H = torch.from_numpy(rng.uniform(0.1, 1, (k, n)).astype(np.float32)).cuda()
        for name, _ in KERNELS:
            fn = getattr(fk, name)
            ref = getattr(fk, f"{name}_reference")
            for mode in ("kl", "is"):
                got = as_tuple(fn(V, W, H, mode))
                torch.cuda.synchronize()
                want = as_tuple(ref(V, W, H, mode))
                rel = max(rel_err(a, b) for a, b in zip(got, want))
                abs_ = max(float((a.double() - b.double()).abs().max())
                           for a, b in zip(got, want))
                if not rel <= REL_TOL:
                    raise AssertionError(f"{name} {mode} at {m}x{n} k={k}: max "
                                         f"relative error {rel:.3g} > {REL_TOL}")
                again = as_tuple(fn(V, W, H, mode))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name} {mode} at {m}x{n} k={k}: "
                                         "two runs differ in their bits")
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], abs_)
                s["max_rel_err"] = max(s["max_rel_err"], rel)
                line = f"phase 2 {name} {mode} {m}x{n} k={k}: rel {rel:.3g}, abs {abs_:.3g}"
                if (m, n, k) == MAIN:
                    ms = cuda_ms(torch, lambda: fn(V, W, H, mode), 5)
                    plain = cuda_ms(torch, lambda: ref(V, W, H, mode), 5)
                    suffix = "" if mode == "kl" else "_is"
                    tflops = flops(name, mode, m, n, k) / (ms * 1e-3) / 1e12
                    b_ms, b_by = bound(name, mode, m, n, k)
                    s["ms" + suffix], s["plain_ms" + suffix] = ms, plain
                    s["tflops" + suffix] = tflops
                    s["bound_ms" + suffix], s["bound_by" + suffix] = b_ms, b_by
                    line += (f", kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
                             f"plain {plain:.3f} ms, bound {b_ms:.3f} ms by "
                             f"{b_by} ({100 * b_ms / ms:.1f}% of bound)")
                say(line)
        del V, W, H
    return stats


def dma_tier(lib, k):
    """The tier kl_phi_dot_ht_dma launches at k, from the library."""
    import ctypes
    info = (ctypes.c_int * 4)()
    tier = lib.nmf_dma_tier(k, info)
    return {"tier": tier, "rows": info[0], "warps": info[1], "column_groups": info[2],
            "blocks_per_sm": info[3], "smem_bytes": lib.nmf_dma_smem_bytes(k)}


def check_dma(torch, dk, V, W, H, stats, label):
    """kl_phi_dot_ht_dma against its plain version on one input, and
    bit-identical over two runs."""
    got = dk.kl_phi_dot_ht_dma(V, W, H)
    torch.cuda.synchronize()
    want = dk.kl_phi_dot_ht_dma_reference(V, W, H)
    rel = rel_err(got, want)
    abs_ = float((got.double() - want.double()).abs().max())
    if not rel <= REL_TOL:
        raise AssertionError(f"kl_phi_dot_ht_dma at {label}: max relative "
                             f"error {rel:.3g} > {REL_TOL}")
    if not torch.equal(got, dk.kl_phi_dot_ht_dma(V, W, H)):
        raise AssertionError(f"kl_phi_dot_ht_dma at {label}: two runs differ in their bits")
    stats["max_abs_err"] = max(stats["max_abs_err"], abs_)
    stats["max_rel_err"] = max(stats["max_rel_err"], rel)
    return rel, abs_


def phase2_dma(torch, dk, lib, main_V):
    """The streamed W-phase kernel at the check shapes it takes (k <= 512),
    the W-phase comparison's shapes and its tier edges; k = 1024 must
    raise."""
    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    rng = np.random.default_rng(2)
    for (m, n, k) in ((300, 700, 40),) + COMPARE + DMA_EDGES:
        V = main_V if (m, n) == MAIN[:2] else torch.from_numpy(
            rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
        W = torch.from_numpy(rng.uniform(0.1, 1, (m, k)).astype(np.float32)).cuda()
        H = torch.from_numpy(rng.uniform(0.1, 1, (k, n)).astype(np.float32)).cuda()
        rel, abs_ = check_dma(torch, dk, V, W, H, stats, f"{m}x{n} k={k}")
        line = (f"phase 2 kl_phi_dot_ht_dma {m}x{n} k={k}: rel {rel:.3g}, abs {abs_:.3g}, "
                f"bits equal over two runs, tier {json.dumps(dma_tier(lib, k))}")
        if (m, n, k) == MAIN:
            stats["ms"] = cuda_ms(torch, lambda: dk.kl_phi_dot_ht_dma(V, W, H), 5)
            stats["plain_ms"] = cuda_ms(
                torch, lambda: dk.kl_phi_dot_ht_dma_reference(V, W, H), 5)
            stats["bound_ms"], stats["bound_by"] = bound(DMA[0], "kl", m, n, k)
            stats["tflops"] = flops(DMA[0], "kl", m, n, k) / (stats["ms"] * 1e-3) / 1e12
            line += (f", kernel {stats['ms']:.3f} ms ({stats['tflops']:.1f} TFLOP/s), "
                     f"plain {stats['plain_ms']:.3f} ms, "
                     f"bound {stats['bound_ms']:.3f} ms by {stats['bound_by']} "
                     f"({100 * stats['bound_ms'] / stats['ms']:.1f}% of bound)")
        say(line)
        del V, W, H
    m, n, k = CHECK_SHAPES[2]
    try:
        dk.kl_phi_dot_ht_dma(*(torch.ones(s, device="cuda")
                               for s in ((m, n), (m, k), (k, n))))
    except ValueError as e:
        say(f"phase 2 kl_phi_dot_ht_dma {m}x{n} k={k}: ValueError ({e})")
    else:
        raise AssertionError("kl_phi_dot_ht_dma accepted k = 1024")
    return stats


def f64_kl_cost(torch, V, Vh, M):
    """The f64 sum of the plain KL cost's f32 terms, weighted by M."""
    t = V * torch.log(V / Vh) - V + Vh
    if M is not None:
        t = torch.where(M > 0, M * t, torch.zeros((), dtype=t.dtype, device=t.device))
    return float(torch.sum(t.double()))


def naive_kl_counts(nk):
    return {name: getattr(nk, f"{name}_launches") for name, _ in NAIVE_KL}


def zero_naive_kl_counts(nk):
    nk.kl_field_launches = nk.kl_cost_launches = 0


def phase2_naive_kl(torch, nk, nmf, main_V, W0, H0):
    """Phase 2b: the naive KL passes at the main shape against their
    plain versions, then a weighted naive KL solve against the same solve
    on the plain versions."""
    m, n, k = MAIN
    g = torch.Generator(device="cuda").manual_seed(22)
    W, H = torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    Vh = W @ H
    u = torch.rand((m, n), generator=g, device="cuda")
    M = torch.where(u < 0.2, torch.zeros((), device="cuda"), u)
    # NaN under a fifth of the zero weights: the gate must zero them
    V = main_V.masked_fill(u < 0.04, float("nan"))
    del u
    stats = {}
    phi = nk.kl_field(V, Vh, M)
    if not torch.equal(phi, nk.kl_field_reference(V, Vh, M)):
        raise AssertionError("phase 2b kl_field differs from its plain version")
    if not torch.equal(nk.kl_field(V, Vh, M), phi):
        raise AssertionError("phase 2b kl_field: two runs differ in their bits")
    del phi
    ms = cuda_ms(torch, lambda: nk.kl_field(V, Vh, M), 5)
    plain = cuda_ms(torch, lambda: nk.kl_field_reference(V, Vh, M), 5)
    b_ms = 1e3 * NAIVE_KL_BYTES["kl_field"] * m * n / PEAK_BYTES
    stats["kl_field"] = {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": ms, "plain_ms": plain,
                         "bound_ms": b_ms, "bound_by": "bytes"}
    say(f"phase 2b kl_field weighted {m}x{n}: torch.equal to its plain version, kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms by bytes "
        f"({100 * b_ms / ms:.1f}% of bound)")
    cost = {"max_abs_err": 0.0, "max_rel_err": 0.0, "bound_by": "bytes"}
    for label, Mx in (("", M), (" unweighted", None)):
        Vx = V if Mx is not None else main_V  # no gate: no NaN
        c = nk.kl_cost_terms(Vx, Vh, Mx)
        want = f64_kl_cost(torch, Vx, Vh, Mx)
        rel = abs(float(c) - want) / abs(want)
        if not rel <= NAIVE_KL_COST_RTOL:
            raise AssertionError(f"phase 2b kl_cost{label}: {float(c)!r} against the f64 sum "
                                 f"{want!r}, {rel:.3g} relative > {NAIVE_KL_COST_RTOL}")
        if not torch.equal(nk.kl_cost_terms(Vx, Vh, Mx), c):
            raise AssertionError(f"phase 2b kl_cost{label}: two runs differ in their bits")
        ms = cuda_ms(torch, lambda: nk.kl_cost_terms(Vx, Vh, Mx), 5)
        plain = cuda_ms(torch, lambda: nk.kl_cost_terms_reference(Vx, Vh, Mx), 5)
        b_ms = 1e3 * NAIVE_KL_BYTES["kl_cost" + label] * m * n / PEAK_BYTES
        suffix = label.replace(" ", "_")
        cost["max_abs_err"] = max(cost["max_abs_err"], abs(float(c) - want))
        cost["max_rel_err"] = max(cost["max_rel_err"], rel)
        cost["ms" + suffix], cost["plain_ms" + suffix] = ms, plain
        cost["bound_ms" + suffix] = b_ms
        say(f"phase 2b kl_cost{label or ' weighted'} {m}x{n}: {rel:.3g} relative to the f64 "
            f"sum, kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms by bytes "
            f"({100 * b_ms / ms:.1f}% of bound)")
    stats["kl_cost"] = cost
    del V, Vh, W, H
    torch.cuda.empty_cache()
    kw = dict(W_init=W0, H_init=H0, weights=M, divergence="kl", method="naive",
              maxiter=ITERS, tolerance=NEVER, device="cuda")
    nmf(main_V, k, **{**kw, "maxiter": 2})
    zero_naive_kl_counts(nk)
    got, ms = wall_ms(torch, lambda: nmf(main_V, k, **kw))
    launches = naive_kl_counts(nk)
    if got.n_iters != ITERS or launches != {"kl_field": 2 * ITERS, "kl_cost": ITERS}:
        raise AssertionError(f"phase 2b weighted naive KL: n_iters {got.n_iters}, "
                             f"launches {launches}")
    routed = nk.kl_field, nk.kl_cost_terms
    nk.kl_field, nk.kl_cost_terms = nk.kl_field_reference, nk.kl_cost_terms_reference
    try:
        want, ms_plain = wall_ms(torch, lambda: nmf(main_V, k, **kw))
    finally:
        nk.kl_field, nk.kl_cost_terms = routed
    if not (torch.equal(got.W, want.W) and torch.equal(got.H, want.H)):
        raise AssertionError("phase 2b weighted naive KL: W, H differ from the plain versions'")
    cg, cw = np.asarray(got.cost), np.asarray(want.cost)
    cost_gap = float(np.max(np.abs(cg - cw) / np.abs(cw)))
    for name, _ in NAIVE_KL:
        stats[name]["launches"] = launches[name]
        stats[name]["launches_per_iter"] = launches[name] / got.n_iters
    say(f"phase 2b weighted nmf kl naive {m}x{n} r{k}, 80% weights, {ITERS} iterations: W, H "
        f"torch.equal to the plain versions', cost trace {cost_gap:.3g} relative from theirs; "
        f"{ms / ITERS:.2f} ms/iter, plain versions {ms_plain / ITERS:.2f} ms/iter; "
        f"launches {json.dumps(launches)}")
    del got, want, M
    torch.cuda.empty_cache()
    return stats


def phase3_main_path(torch, fk, dk, nk, nmf, V, W0, H0):
    k = MAIN[2]
    kw = dict(W_init=W0, H_init=H0, maxiter=ITERS, tolerance=1e-30, device="cuda")
    for d in ("kl", "is"):  # warm both paths (allocator, cuBLAS handles)
        nmf(V, k, divergence=d, method="fused", **{**kw, "maxiter": 2})
        nmf(V, k, divergence=d, method="naive", **{**kw, "maxiter": 2})
    out = {}
    for d in ("kl", "is"):
        fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0
        dk.kl_phi_dot_ht_dma_launches = 0
        fused, ms_fused = wall_ms(torch, lambda: nmf(V, k, divergence=d, method="fused", **kw))
        launches = {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}
        launches[DMA[0]] = dk.kl_phi_dot_ht_dma_launches
        if not all(launches[name] > 0 for name, _ in KERNELS):
            raise AssertionError(f"fused {d} run missed a kernel: {launches}")
        zero_naive_kl_counts(nk)
        naive, ms_naive = wall_ms(torch, lambda: nmf(V, k, divergence=d, method="naive", **kw))
        naive_launches = naive_kl_counts(nk)
        if naive_launches != {"kl_field": 0, "kl_cost": naive.n_iters if d == "kl" else 0}:
            raise AssertionError(f"naive {d} run, {naive.n_iters} iterations: naive KL "
                                 f"launches {naive_launches}")
        cf, cn = np.asarray(fused.cost), np.asarray(naive.cost)
        if fused.n_iters != ITERS or not np.all(np.isfinite(cf)):
            raise AssertionError(f"fused {d}: n_iters {fused.n_iters}, cost {cf}")
        if d == "kl" and not np.all(np.diff(cf) <= 0):
            raise AssertionError(f"fused kl cost increased: {cf}")
        if not np.allclose(cf, cn, rtol=SOLVER_RTOL, atol=0):
            raise AssertionError(f"fused vs naive {d} cost: {cf} vs {cn}")
        for name in ("W", "H"):
            x = getattr(fused, name)
            if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"fused {d} {name} not finite on the card")
        out[d] = {"launches": launches, "iters": fused.n_iters,
                  "naive_launches": naive_launches, "naive_iters": naive.n_iters,
                  "ms_per_iter_fused": ms_fused / ITERS,
                  "ms_per_iter_naive": ms_naive / ITERS}
        say(f"phase 3 nmf {d} {MAIN[0]}x{MAIN[1]} r{k}: fused "
            f"{ms_fused / ITERS:.2f} ms/iter, naive {ms_naive / ITERS:.2f} ms/iter, "
            f"launches {launches}, naive launches {naive_launches}, final cost fused "
            f"{cf[-1]:.7g} naive {cn[-1]:.7g}")
    # Where a fused KL iteration's device time goes (counters already read).
    prof = profile_device_ms(
        torch, lambda: nmf(V, k, divergence="kl", method="fused", **kw), ITERS)
    say(f"phase 3 profile fused kl: {json.dumps(prof)}")
    return out


def phase4_gram(torch, nmf):
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(0)
    V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30)
    nmf(V, k, maxiter=2, **kw)
    res, ms = wall_ms(torch, lambda: nmf(V, k, maxiter=ITERS, **kw))
    c = np.asarray(res.cost)
    if res.n_iters != ITERS or not np.all(np.isfinite(c)) or not np.all(np.diff(c) <= 0):
        raise AssertionError(f"gram path: n_iters {res.n_iters}, cost {c}")
    say(f"phase 4 nmf euclidean gram {m}x{n} r{k}: {ms / ITERS:.2f} ms/iter, "
        f"final cost {c[-1]:.7g}")
    return ms / ITERS


def phase5_objective(torch, nmf):
    """bench.py:55-88 on the card: literal nmf.m Euclidean updates in f64
    NumPy against the port's f32 run, which gets NumPy inputs and no
    device= and must land on the card (nndsvd likewise)."""
    from nmf_toolbox_tpu_torch.utils.init import nndsvd
    rng = np.random.default_rng(42)
    V = rng.uniform(0.05, 1.0, (1000, 500))
    W0 = rng.uniform(size=(1000, 25))
    H0 = rng.uniform(size=(25, 500))
    eps = np.finfo(np.float64).eps
    W, H = W0 / np.sqrt((W0 ** 2).sum(0, keepdims=True)), H0.copy()
    for _ in range(200):
        Vh = W @ H
        neg = V @ H.T + W * np.diag(H @ Vh.T @ W)[None, :]
        pos = Vh @ H.T + W * np.diag(H @ V.T @ W)[None, :]
        W = W * (neg / np.maximum(pos, eps))
        W = W / np.sqrt((W ** 2).sum(0, keepdims=True))
        Vh = W @ H
        H = H * ((W.T @ V) / np.maximum(W.T @ Vh, eps))
    c_oracle = 0.5 * np.sum((V - W @ H) ** 2)
    # NumPy inputs and no device=: the port's default puts them on the card.
    r = nmf(V.astype(np.float32), 25, W_init=W0.astype(np.float32),
            H_init=H0.astype(np.float32), maxiter=200, tolerance=1e-30)
    Ws, _ = nndsvd(V.astype(np.float32), 25)
    if r.W.device.type != "cuda" or Ws.device.type != "cuda":
        raise AssertionError(f"NumPy V ran on {r.W.device} (nmf), {Ws.device} "
                             "(nndsvd), not on the card")
    Wf, Hf = (x.cpu().numpy().astype(np.float64) for x in (r.W, r.H))
    rel = abs(0.5 * np.sum((V - Wf @ Hf) ** 2) - c_oracle) / c_oracle
    if not rel <= ORACLE_RTOL:
        raise AssertionError(f"objective {rel:.3g} from the f64 oracle > {ORACLE_RTOL}")
    say(f"phase 5 objective check 1000x500 r25: {rel:.3g} relative to the f64 oracle")
    return rel


def scaled_err(a, b):
    """max |a - b| / max |b|, in f64 on the host."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def matmul_family(torch, A, B, v):
    """The members of the matmul family emulate_card_matmul_numerics
    models, by name, as functions of (A, B, v); the last four are GEMVs
    on the card."""
    return {
        "@": lambda: A @ B, "mm": lambda: torch.mm(A, B),
        "addmm": lambda: torch.addmm(B, A, B),
        "bmm": lambda: torch.bmm(A.reshape(4, -1, A.shape[1]), B.reshape(4, B.shape[0], -1)),
        "einsum": lambda: torch.einsum("mk,kn->mn", A, B),
        "mv": lambda: torch.mv(A, v), "addmv": lambda: torch.addmv(v, A, v, alpha=-1),
        "one column out": lambda: A @ B[:, :1], "one row out": lambda: A[:1] @ B,
    }


def phase5b_card_numerics(torch, nmf):
    """The card's f32 matmul numerics against the CPU emulation of them
    (utils/debug.emulate_card_matmul_numerics), in TF32 mode."""
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk, tf32
    from nmf_toolbox_tpu_torch.utils import debug
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    n = NUMERICS_SHAPE
    A, B = (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)) for _ in range(2))
    n = FAMILY_SHAPE
    Af, Bf = (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)) for _ in range(2))
    vf = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    backend = torch.backends.cuda.matmul
    saved = backend.fp32_precision
    try:
        backend.fp32_precision = "tf32"
        card = (A.cuda() @ B.cuda()).cpu()
        with debug.emulate_card_matmul_numerics():
            emulated = A @ B
        plain = A @ B
        out = {"emulated": scaled_err(emulated, card), "plain": scaled_err(plain, card)}
        for name, rounding in (("nearest-even", tf32.tf32_rne), ("nearest-away", tf32.tf32_rna),
                               ("toward zero", tf32.tf32_rz)):
            out[f"operands {name}"] = scaled_err(tf32.mm1(A, B, rounding), card)
        on_card = {k: f().cpu() for k, f in matmul_family(
            torch, Af.cuda(), Bf.cuda(), vf.cuda()).items()}
        with debug.emulate_card_matmul_numerics():
            family = {k: scaled_err(f(), on_card[k]) for k, f in matmul_family(
                torch, Af, Bf, vf).items()}
        # The kernels' products under the emulation (3xTF32), at phase 2's
        # first shape, against the kernels on the card.
        m, n_, k = CHECK_SHAPES[0]
        V, W, H = (torch.from_numpy(rng.uniform(0.1, 1, s).astype(np.float32))
                   for s in ((m, n_), (m, k), (k, n_)))
        with debug.emulate_card_matmul_numerics():
            twins = {"phi_dot_ht": fk.phi_dot_ht(V, W, H), "wt_dot_phi": fk.wt_dot_phi(V, W, H),
                     "cost_terms": fk.cost_terms(V, W, H)}
        Vc, Wc, Hc = V.cuda(), W.cuda(), H.cuda()
        kernels = {"phi_dot_ht": fk.phi_dot_ht(Vc, Wc, Hc), "wt_dot_phi": fk.wt_dot_phi(Vc, Wc, Hc),
                   "cost_terms": fk.cost_terms(Vc, Wc, Hc)}
        out["kernels vs emulated twins"] = {k: scaled_err(twins[k], kernels[k]) for k in twins}
        out["kernels vs plain"] = {k: scaled_err(getattr(fk, f"{k}_reference")(V, W, H), kernels[k])
                                   for k in twins}
        # BASELINE #1 (bench.py:55-88's problem) in TF32 on the card and
        # emulated on the CPU, against f64 on the CPU.
        rng = np.random.default_rng(42)
        V = rng.uniform(0.05, 1.0, (1000, 500))
        W0, H0 = rng.uniform(size=(1000, 25)), rng.uniform(size=(25, 500))
        kw = dict(W_init=W0.astype(np.float32), H_init=H0.astype(np.float32),
                  maxiter=200, tolerance=NEVER)
        V32 = V.astype(np.float32)
        runs = {"card tf32": nmf(V32, 25, device="cuda", **kw)}
        with debug.emulate_card_matmul_numerics():
            runs["cpu emulated"] = nmf(V32, 25, device="cpu", **kw)
    finally:
        backend.fp32_precision = saved
    runs["cpu plain"] = nmf(V32, 25, device="cpu", **kw)
    ref = nmf(V, 25, W_init=W0, H_init=H0, maxiter=200, tolerance=NEVER, device="cpu")
    out["baseline1 vs f64"] = {
        k: {"final cost": abs(float(r.cost[-1]) - float(ref.cost[-1])) / float(ref.cost[-1]),
            "W": scaled_err(r.W, ref.W), "H": scaled_err(r.H, ref.H)} for k, r in runs.items()}
    out["family emulated vs card"] = family
    out["seconds"] = time.perf_counter() - t0
    say(f"phase 5b card matmul numerics, TF32, {NUMERICS_SHAPE}^3 normal f32 (max |diff| / "
        f"max |entry| against the card's product): {json.dumps(out)}")
    bad = {k: e for k, e in family.items() if not e <= EMULATED_TOL}
    if not out["emulated"] <= EMULATED_TOL or not out["plain"] > PLAIN_MIN or bad:
        raise AssertionError(f"phase 5b: emulated {out['emulated']:.3g} (<= {EMULATED_TOL}), "
                             f"plain {out['plain']:.3g} (> {PLAIN_MIN}), family {bad}")
    return out


def copy_gbps(torch):
    """Device-to-device copy bandwidth, read plus write, of a 2 GiB buffer."""
    x = torch.empty(2 ** 29, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_ms(torch, lambda: y.copy_(x), 10)
    return 2 * x.numel() * 4 / (ms * 1e-3) / 1e9


def phase6_wphase_compare(torch, fk, dk, lib, stats):
    """benchmarks/pallas_compare.py on the card: the KL W-phase op three
    ways at its three shapes, with the one-V-read floor from the copy
    bandwidth measured here.  Returns the dma kernel's launches, counted
    from 0 at the start of this phase."""
    gbps = copy_gbps(torch)
    say(f"phase 6 device-to-device copy: {gbps:.1f} GB/s (read + write)")
    dk.kl_phi_dot_ht_dma_launches = 0
    for si, (m, n, k) in enumerate(COMPARE):
        rng = np.random.default_rng(si)
        V, W, H = (torch.from_numpy(rng.uniform(0.05, 1.0, s).astype(np.float32)).cuda()
                   for s in ((m, n), (m, k), (k, n)))
        floor_ms = m * n * 4 / (gbps * 1e9) * 1e3
        check_dma(torch, dk, V, W, H, stats, f"{m}x{n} k={k} (phase 6)")
        variants = (("plain", lambda: dk.kl_phi_dot_ht_dma_reference(V, W, H)),
                    ("fused", lambda: fk.phi_dot_ht(V, W, H, "kl")),
                    ("dma", lambda: dk.kl_phi_dot_ht_dma(V, W, H)))
        for name, fn in variants:
            ms = cuda_ms(torch, fn, 10)
            row = {"variant": name, "shape": f"{m}x{n} r{k}", "ms": ms,
                   "floor_ms": floor_ms, "pct_of_floor": 100 * floor_ms / ms}
            if name == "dma":
                row.update(dma_tier(lib, k))
            say(f"phase 6 {json.dumps(row)}")
        del V, W, H
    launches = dk.kl_phi_dot_ht_dma_launches
    if launches <= 0:
        raise AssertionError("the W-phase comparison never launched kl_phi_dot_ht_dma")
    return launches


def direct_cost(torch, V, W, H):
    """0.5 ||V - W H||^2 as a direct f32 residual (bench.py's measure)."""
    E = torch.addmm(V, W, H, alpha=-1.0)
    c = 0.5 * float(torch.linalg.vector_norm(E)) ** 2
    del E
    return c


def check_trace(name, res, iters, torch, monotone=True, slack=0.0):
    c = np.asarray(res.cost, np.float64)
    if res.n_iters != iters or not np.all(np.isfinite(c)):
        raise AssertionError(f"{name}: n_iters {res.n_iters}, cost {c}")
    if monotone and not np.all(np.diff(c) <= slack * np.abs(c[:-1])):
        raise AssertionError(f"{name}: cost increased: {c}")
    for f in ("W", "H"):
        x = getattr(res, f)
        if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {f} not finite on the card")
    return c


def hals_oracle(V, W, H, sweeps, eps):
    """Literal HALS sweeps (models/hals.py:123-152) in f64 NumPy."""
    W, H = W.copy(), H.copy()
    k = W.shape[1]
    for _ in range(sweeps):
        HHt, VHt = H @ H.T, V @ H.T
        dH = np.maximum(np.diag(HHt), eps)
        for j in range(k):
            W[:, j] = np.maximum(W[:, j] + (VHt[:, j] - W @ HHt[:, j]) / dH[j], eps)
        WtW, WtV = W.T @ W, W.T @ V
        dW = np.maximum(np.diag(WtW), eps)
        for j in range(k):
            H[j] = np.maximum(H[j] + (WtV[j] - WtW[j] @ H) / dW[j], eps)
    return W, H


def phase7_hals(torch, nmf_hals, V):
    from nmf_toolbox_tpu_torch.core import EPS
    from nmf_toolbox_tpu_torch.models.hals import _sweep_rows
    from nmf_toolbox_tpu_torch.utils.init import nndsvd
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(1)
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    kw = dict(tolerance=1e-30)
    nmf_hals(V, k, W_init=W0, H_init=H0, maxiter=2, **kw)  # warm-up
    res, ms = wall_ms(torch, lambda: nmf_hals(V, k, W_init=W0, H_init=H0,
                                              maxiter=HALS_ITERS, **kw))
    c = check_trace("hals", res, HALS_ITERS, torch, slack=0.0)
    # The sweeps alone (2k in-place row updates) against one iteration.
    Wt, H = res.W.T.contiguous(), res.H.clone()
    HHt, VHt_t, WtW, WtV = H @ H.T, H @ V.T, Wt @ Wt.T, Wt @ V
    dH = torch.clamp_min(torch.diagonal(HHt), EPS)
    dW = torch.clamp_min(torch.diagonal(WtW), EPS)
    sweeps_ms = cuda_ms(torch, lambda: (_sweep_rows(Wt, HHt.T, VHt_t, dH, EPS),
                                        _sweep_rows(H, WtW, WtV, dW, EPS)), 3)
    gemm_ms = cuda_ms(torch, lambda: (H @ V.T, Wt @ V), 3)
    del Wt, H, HHt, VHt_t, WtW, WtV
    say(f"phase 7 hals {m}x{n} r{k}: {ms / HALS_ITERS:.2f} ms/iter; sweeps "
        f"{sweeps_ms:.2f} ms ({100 * sweeps_ms * HALS_ITERS / ms:.1f}% of an "
        f"iteration), the two V products {gemm_ms:.2f} ms; final cost {c[-1]:.7g}")
    res_x, ms_x = wall_ms(torch, lambda: nmf_hals(
        V, k, W_init=W0, H_init=H0, maxiter=HALS_ITERS, extrapolate=True, **kw))
    cx = check_trace("hals extrapolate", res_x, HALS_ITERS, torch, monotone=False)
    true_x, true_p = (direct_cost(torch, V, r.W, r.H) for r in (res_x, res))
    say(f"phase 7 hals extrapolate: {ms_x / HALS_ITERS:.2f} ms/iter; objective "
        f"after {HALS_ITERS} sweeps {true_x:.7g} (plain {true_p:.7g}); "
        f"surrogate trace ends {cx[-1]:.7g}")
    del res, res_x

    def run_to_tol(W, H, seeded):
        """bench.py:121-142: chunks of TOL_CHUNK sweeps until the direct
        cost's relative decrease per chunk is below REL_DECREASE_TOL per
        iteration, at most TOL_CAP iterations; seeding inside the clock."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if seeded:
            W, H = nndsvd(V, k, generator=torch.Generator(device="cuda").manual_seed(2))
        c_prev, iters = None, 0
        while iters < TOL_CAP:
            r = nmf_hals(V, k, W_init=W, H_init=H, maxiter=TOL_CHUNK, **kw)
            W, H = r.W, r.H
            iters += TOL_CHUNK
            c = direct_cost(torch, V, W, H)
            if c_prev is not None and (c_prev - c) / c < REL_DECREASE_TOL * TOL_CHUNK:
                break
            c_prev = c
        torch.cuda.synchronize()
        if not (np.isfinite(c) and bool(torch.isfinite(W).all())):
            raise AssertionError(f"time-to-tolerance run ended at cost {c}")
        return time.perf_counter() - t0, iters, c

    nndsvd(V, k, generator=torch.Generator(device="cuda").manual_seed(9))  # warm-up
    for label, seeded in (("random", False), ("nndsvd", True)):
        dt, iters, c = run_to_tol(W0, H0, seeded)
        v_sq = float(torch.linalg.vector_norm(V)) ** 2
        say(f"phase 7 hals time-to-tolerance ({label} init): {dt:.3f} s over "
            f"{iters} iterations (cap {TOL_CAP}), rel recon err "
            f"{(2 * c / v_sq) ** 0.5:.5f}")
    del W0, H0

    m2, n2, k2 = WEIGHTED
    g2 = torch.Generator(device="cuda").manual_seed(3)
    V2 = 0.05 + 0.95 * torch.rand((m2, n2), generator=g2, device="cuda")
    M = (torch.rand((m2, n2), generator=g2, device="cuda") < 0.7).float()
    res_w, ms_w = wall_ms(torch, lambda: nmf_hals(V2, k2, weights=M, maxiter=5,
                                                  seed=4, **kw))
    # f32 rounding of the carried residual: allow 1e-6 relative per sweep
    cw = check_trace("weighted hals", res_w, 5, torch, slack=1e-6)
    say(f"phase 7 weighted hals {m2}x{n2} r{k2}, 70% weights: {ms_w / 5:.2f} "
        f"ms/iter, cost {cw[0]:.7g} -> {cw[-1]:.7g}")
    del V2, M, res_w

    rng = np.random.default_rng(42)
    Vo = rng.uniform(0.05, 1.0, (1000, 500))
    Wo, Ho = rng.uniform(size=(1000, 25)), rng.uniform(size=(25, 500))
    Wf, Hf = hals_oracle(Vo, Wo, Ho, 50, EPS)
    c_oracle = 0.5 * np.sum((Vo - Wf @ Hf) ** 2)
    r = nmf_hals(Vo.astype(np.float32), 25, W_init=Wo.astype(np.float32),
                 H_init=Ho.astype(np.float32), maxiter=50, **kw)
    if r.W.device.type != "cuda":
        raise AssertionError(f"nmf_hals ran a NumPy V on {r.W.device}, not the card")
    Wc, Hc = (x.cpu().numpy().astype(np.float64) for x in (r.W, r.H))
    rel = abs(0.5 * np.sum((Vo - Wc @ Hc) ** 2) - c_oracle) / c_oracle
    if not rel <= HALS_ORACLE_RTOL:
        raise AssertionError(f"hals objective {rel:.3g} from the f64 oracle "
                             f"> {HALS_ORACLE_RTOL}")
    say(f"phase 7 hals objective check 1000x500 r25, 50 sweeps: {rel:.3g} "
        "relative to the f64 NumPy HALS")


def phase8_nmf_options(torch, nmf, V):
    k = GRAM[2]
    kw = dict(init="nndsvd", maxiter=ITERS, tolerance=1e-30)
    final = {}
    for label, extra in (("f32", {}), ("bf16", {"data_dtype": "bfloat16"})):
        nmf(V, k, **{**kw, **extra, "maxiter": 2})  # warm-up
        r, ms = wall_ms(torch, lambda: nmf(V, k, **kw, **extra))
        c = check_trace(f"nmf nndsvd {label}", r, ITERS, torch)
        final[label] = c[-1]
        say(f"phase 8 nmf gram init='nndsvd' {label} data {GRAM[0]}x{GRAM[1]} "
            f"r{k}: {ms / ITERS:.2f} ms/iter (seeding included), cost "
            f"{c[0]:.7g} -> {c[-1]:.7g}")
    rel = abs(final["bf16"] - final["f32"]) / final["f32"]
    if not rel <= BF16_RTOL:
        raise AssertionError(f"bf16 final cost {rel:.3g} from f32 > {BF16_RTOL}")
    say(f"phase 8 bf16 vs f32 final cost: {rel:.3g} relative")

def median_ms(torch, fn, reps=3):
    """Median host ms of ``reps`` synchronised calls after one warm-up."""
    out = fn()
    times = []
    for _ in range(reps):
        out, ms = wall_ms(torch, fn)
        times.append(ms)
    return out, float(np.median(times))


def gram_floor(torch, V):
    """The euclidean traces' absolute slack: the Gram identity
    0.5 (||V||^2 - 2<W'V, H> + <W'W H, H>) cancels in f32 near a good fit,
    so two summation orders differ by ~eps_f32 * ||V||^2 whatever the
    cost, (B,) per matrix or one number for a shared V."""
    return GRAM_SLACK * np.asarray(torch.sum(V.double() ** 2, dim=(-2, -1)).cpu())


def check_engine(name, res, torch, refs, floor=0.0, rtol=ENGINE_RTOL):
    """Finite traces, non-increasing within 1e-4 relative (plus ``floor``,
    the euclidean traces' f32 slack), factors on the card; ``refs`` maps a
    problem index to the single-solver Result whose cost trace it must
    match within ``rtol`` (plus ``floor``) and whose factors within
    FACTOR_RTOL of their largest entry.  A bf16-stored V's trace is held
    only to its single run, at BF16_RTOL: the products round the factors
    to bf16 (as nmf's bf16 path does), and the Gram identity turns that
    into noise of ~1e-4 of ||V||^2 near the fit, neither monotone nor
    equal across summation orders.  Returns the worst relative cost and
    factor gaps."""
    monotone = rtol == ENGINE_RTOL
    c = np.asarray(res.cost, np.float64)
    floor = np.broadcast_to(np.asarray(floor, np.float64), c.shape[:1])[:, None]
    if c.shape[1] != ENGINE_ITERS or not np.all(np.isfinite(c)):
        raise AssertionError(f"{name}: cost shape {c.shape} or not finite")
    if monotone and not np.all(np.diff(c, axis=1)
                               <= REL_DECREASE_TOL * np.abs(c[:, :-1]) + floor):
        raise AssertionError(f"{name}: a cost trace increased")
    for f in ("W", "H"):
        x = getattr(res, f)
        if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {f} not finite on the card")
    worst, worst_f = 0.0, 0.0
    for b, ref in refs.items():
        r = np.asarray(ref.cost, np.float64)
        gap = np.abs(c[b] - r)
        if not (len(r) == ENGINE_ITERS and np.all(gap <= rtol * np.abs(r) + floor[b])):
            raise AssertionError(f"{name}: problem {b} {np.max(gap / r):.3g} from single nmf")
        worst = max(worst, float(np.max(gap / np.abs(r))))
        for f in ("W", "H"):
            x, y = getattr(res, f), getattr(ref, f).double()
            x = (x[b] if x.ndim > y.ndim else x).double()  # an encoder's W is shared
            gap_f = float((x - y).abs().max() / y.abs().max())
            if not gap_f <= FACTOR_RTOL:
                raise AssertionError(f"{name}: problem {b} {f} {gap_f:.3g} from single nmf")
            worst_f = max(worst_f, gap_f)
    return worst, worst_f


def serving_batch(torch):
    """Phase 9's batch on the card (B gamma bases times gamma codes, + 0.01),
    its bases and the generator that drew them, for the draws after."""
    B, m, n, k = SERVING
    rng = np.random.default_rng(0)
    bases = rng.gamma(2.0, 1.0, (B, m, k)).astype(np.float32)
    codes = rng.gamma(0.5, 1.0, (B, k, n)).astype(np.float32)
    return rng, bases, torch.from_numpy(np.einsum("bmk,bkn->bmn", bases, codes) + 0.01).cuda()


def phase9_serving(torch):
    from nmf_toolbox_tpu_torch import nmf, nmf_batched, nmf_encode
    from nmf_toolbox_tpu_torch.core import EPS
    from nmf_toolbox_tpu_torch.models import batched as tb
    B, m, n, k = SERVING
    rng, bases, Vs = serving_batch(torch)
    W0, H0 = (torch.from_numpy(rng.uniform(size=s).astype(np.float32)).cuda()
              for s in ((B, m, k), (B, k, n)))
    Wd = torch.from_numpy(bases[0] / np.sqrt((bases[0] ** 2).sum(0))).cuda()
    a, b = (torch.ones((4, 8, 8), dtype=torch.bfloat16, device="cuda") for _ in range(2))
    try:
        torch.bmm(a, b, out_dtype=torch.float32)
        say("phase 9 torch.bmm takes out_dtype (bf16 in, f32 out): yes")
    except (TypeError, RuntimeError) as e:
        say(f"phase 9 torch.bmm takes out_dtype: no ({type(e).__name__})")
    one = dict(maxiter=ENGINE_ITERS, tolerance=1e-30)
    runs = {
        "batched euclidean f32": ("batched", {}),
        "batched euclidean bf16": ("batched", {"data_dtype": "bfloat16"}),
        "batched kl f32": ("batched", {"divergence": "kl"}),
        "encode euclidean": ("encode", {}),
        "encode euclidean cost_every=10": ("encode", {"cost_every": 10}),
        "encode kl": ("encode", {"divergence": "kl"}),
        "encode kl cost_every=10": ("encode", {"divergence": "kl", "cost_every": 10}),
    }
    out = {}
    for name, (engine, cfg) in runs.items():
        if engine == "batched":
            res, ms = median_ms(torch, lambda: nmf_batched(
                Vs, k, W_init=W0, H_init=H0, maxiter=ENGINE_ITERS, **cfg))
            refs = {i: nmf(Vs[i], k, W_init=W0[i], H_init=H0[i], **one, **cfg)
                    for i in (0, B - 1)}
        else:
            res, ms = median_ms(torch, lambda: nmf_encode(
                Vs, Wd, H_init=H0, maxiter=ENGINE_ITERS, **cfg))
            refs = {} if "cost_every" in cfg else {
                i: nmf(Vs[i], k, W_init=Wd, W_fixed=True, H_init=H0[i], **one, **cfg)
                for i in (0, B - 1)}
        if "data_dtype" in cfg:
            gap, gap_f = check_engine(name, res, torch, refs, rtol=BF16_RTOL)
        else:
            floor = 0.0 if cfg.get("divergence") == "kl" else gram_floor(torch, Vs)
            gap, gap_f = check_engine(name, res, torch, refs, floor)
        out[name] = {"ms_per_call": ms, "ms_per_problem": ms / B, "res": res,
                     "cost_gap": gap, "factor_gap": gap_f}
        say(f"phase 9 {name} B{B} {m}x{n} r{k}, {ENGINE_ITERS} iterations: "
            f"{ms:.2f} ms/call, {1e3 * ms / B:.2f} us/problem, final cost "
            f"mean {np.mean(res.cost[:, -1]):.7g}; problems 0 and {B - 1} against "
            f"single nmf: costs {gap:.3g}, factors {gap_f:.3g} relative")
    for div in ("euclidean", "kl"):
        r1, r10 = out[f"encode {div}"]["res"], out[f"encode {div} cost_every=10"]["res"]
        checks = [i for i in range(ENGINE_ITERS) if i == 0 or (i + 1) % 10 == 0]
        if not (torch.equal(r1.H, r10.H)
                and np.array_equal(r1.cost[:, checks], r10.cost[:, checks])):
            raise AssertionError(f"encode {div}: cost_every=10 moved H or a check's cost")
    # The batch's final cost (the sum over its problems) with bf16-stored
    # V against f32; the worst single problem is printed beside it.
    f32, bf16 = (out[f"batched euclidean {x}"]["res"].cost[:, -1].astype(np.float64)
                 for x in ("f32", "bf16"))
    rel = abs(bf16.sum() - f32.sum()) / f32.sum()
    if not rel <= BF16_RTOL:
        raise AssertionError(f"batched bf16 final cost {rel:.3g} from f32 > {BF16_RTOL}")
    say(f"phase 9 cost_every=10 leaves H bit-identical; the bf16 batch's final cost "
        f"{rel:.3g} from f32 (worst problem {np.max(np.abs(bf16 - f32) / f32):.3g})")
    # Each engine's inner solve on device tensors, with no host sync: at
    # full length under sync debug mode (which does not see every sync),
    # then each at GATE_ITERS iterations (a few hundred launches, inside
    # the launch queue, which blocks the host when full) queued behind a
    # device sleep that must still be running when the solve returns.
    hsp = torch.zeros(k, device="cuda")
    W0n = W0 / torch.sqrt(torch.sum(W0 * W0, dim=1, keepdim=True))
    Vb = Vs.bfloat16()

    def solves(iters):
        for div, V in (("euclidean", Vb), ("kl", Vs)):
            yield lambda: tb._solve(tb._Spec(iters, EPS, div, 1, 10), V, W0n, H0)
            yield lambda: tb._solve_encode(tb._EncSpec(iters, EPS, div, cost_every=10),
                                           V, Wd, H0, hsp)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for solve in solves(ENGINE_ITERS):
            solve()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gate, queued_ms = torch.cuda.Event(), []
    for solve in solves(GATE_ITERS):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        gate.record()
        t0 = time.perf_counter()
        solve()
        queued_ms.append((time.perf_counter() - t0) * 1e3)
        if gate.query():
            raise AssertionError("a solve came back only after the device sleep ended")
    torch.cuda.synchronize()
    say(f"phase 9 nmf_batched and nmf_encode solves (bf16 euclidean, kl): "
        f"{ENGINE_ITERS} iterations under set_sync_debug_mode('error'), and "
        f"{GATE_ITERS} queued in {', '.join(f'{t:.1f}' for t in queued_ms)} ms "
        "behind a device sleep still running: no host sync")
    prof = profile_device_ms(torch, lambda: nmf_encode(
        Vs, Wd, H_init=H0, divergence="kl", maxiter=ENGINE_ITERS), ENGINE_ITERS)
    say(f"phase 9 profile encode kl: {json.dumps(prof)}")
    summary = {name: {key: v for key, v in r.items() if key != "res"}
               for name, r in out.items()}
    summary["encode kl"]["idle_share"] = prof["idle_share"]
    say(f"phase 9 {json.dumps(summary)}")


def phase10_rank(torch, V_big):
    import nmf_toolbox_tpu_torch.rank as rank
    from nmf_toolbox_tpu_torch import estimate_rank_svd, nmf, nmf_multiseed, pick_rank
    m, n, r = RANK_SWEEP
    S, k = RANK_SEEDS, 16
    rng = np.random.default_rng(0)
    Wt = rng.gamma(2.0, 1.0, (m, r)).astype(np.float32)
    Ht = rng.gamma(0.5, 1.0, (r, n)).astype(np.float32)
    V = torch.from_numpy(Wt @ Ht + 0.01).cuda()
    W0, H0 = (torch.from_numpy(rng.uniform(size=s).astype(np.float32)).cuda()
              for s in ((S, m, k), (S, k, n)))
    v_bytes = V.numel() * V.element_size()
    summary = {}
    for div in ("euclidean", "kl"):
        run = lambda: nmf_multiseed(V, k, S, W_init=W0, H_init=H0,
                                    maxiter=ENGINE_ITERS, divergence=div)
        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, ms = wall_ms(torch, run)
        peak = torch.cuda.max_memory_allocated() - base
        _, ms = median_ms(torch, run)
        refs = {s: nmf(V, k, W_init=W0[s], H_init=H0[s], maxiter=ENGINE_ITERS,
                       tolerance=1e-30, divergence=div) for s in (0, S - 1)}
        gap, gap_f = check_engine(f"multiseed {div}", res, torch, refs,
                                  0.0 if div == "kl" else gram_floor(torch, V))
        if div == "euclidean" and not peak < S * v_bytes / 4:
            raise AssertionError(f"multiseed euclidean peak {peak} B: V copied per restart?")
        summary[f"multiseed {div}"] = {"ms_per_call": ms, "ms_per_restart": ms / S,
                                       "peak_mb": peak / 2 ** 20, "cost_gap": gap,
                                       "factor_gap": gap_f}
        say(f"phase 10 nmf_multiseed {div} {m}x{n} r{k} S{S}, {ENGINE_ITERS} "
            f"iterations: {ms:.2f} ms/call, {ms / S:.2f} ms/restart, peak "
            f"{peak / 2 ** 20:.1f} MiB over V's {v_bytes / 2 ** 20:.1f} MiB, "
            f"restarts 0 and {S - 1} against single nmf: costs {gap:.3g}, "
            f"factors {gap_f:.3g} relative")

    scipy_s = []
    metrics = rank._consensus_metrics

    def timed_metrics(consensus):
        t0 = time.perf_counter()
        try:
            return metrics(consensus)
        finally:
            scipy_s.append(time.perf_counter() - t0)

    rank._consensus_metrics = timed_metrics
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = pick_rank(V, ranks=RANK_CANDIDATES, n_seeds=S, maxiter=ENGINE_ITERS)
        total = time.perf_counter() - t0
    finally:
        rank._consensus_metrics = metrics
    if sel.recommended not in RANK_CANDIDATES or len(sel.stats) != len(RANK_CANDIDATES):
        raise AssertionError(f"pick_rank recommended {sel.recommended}")
    summary["pick_rank"] = {"seconds": total, "scipy_seconds": sum(scipy_s),
                            "solve_seconds": total - sum(scipy_s),
                            "recommended": sel.recommended,
                            "cophenetic": [s.cophenetic for s in sel.stats]}
    say(f"phase 10 pick_rank consensus ranks {RANK_CANDIDATES} S{S}: {total:.2f} s "
        f"({total - sum(scipy_s):.2f} s solves and consensus, {sum(scipy_s):.2f} s "
        f"scipy), recommended {sel.recommended}, cophenetic "
        f"{[round(s.cophenetic, 4) for s in sel.stats]}")
    del V, W0, H0, res, refs

    mb, nb = V_big.shape
    (rank_mem, curve_mem), ms_mem = wall_ms(torch, lambda: estimate_rank_svd(V_big))
    host = V_big.cpu().numpy()
    (rank_str, curve_str), ms_str = wall_ms(
        torch, lambda: estimate_rank_svd(host, block_size=SVD_BLOCK))
    del host
    gap = float(np.max(np.abs(curve_mem - curve_str)))
    if rank_mem != rank_str or not gap <= CURVE_ATOL:
        raise AssertionError(f"estimate_rank_svd: rank {rank_mem} vs {rank_str} "
                             f"streamed, curves {gap:.3g} apart")
    summary["estimate_rank_svd"] = {"ms_in_memory": ms_mem, "ms_streamed": ms_str,
                                    "rank": rank_mem, "curve_gap": gap}
    say(f"phase 10 estimate_rank_svd {mb}x{nb}: in memory {ms_mem:.1f} ms, "
        f"streamed from the host in blocks of {SVD_BLOCK} columns {ms_str:.1f} ms; "
        f"rank {rank_mem} both ways, curves {gap:.3g} apart (energy of the first "
        f"component {curve_mem[0]:.5f}, of all {len(curve_mem)} {curve_mem[-1]:.5f})")
    say(f"phase 10 {json.dumps(summary)}")


def phase11_streaming(torch, V):
    """nmf_streaming and nmf_encode_streaming from a host copy of V and
    from a .npy memmap of it, against each other and the in-memory encode;
    the host-to-device floor of one block; one epoch's device split."""
    import os
    import tempfile
    from nmf_toolbox_tpu_torch import nmf_encode, nmf_encode_streaming, nmf_streaming
    m, n = V.shape
    k = GRAM[2]
    host = V.cpu().numpy()
    gb = host.nbytes / 1e9
    kw = dict(block_size=STREAM_BLOCK, epochs=STREAM_EPOCHS, inner_iters=STREAM_INNER,
              tolerance=NEVER)

    # The floor: one block gathered into pinned memory, then copied from
    # pinned and from pageable memory.
    block_gb = m * STREAM_BLOCK * 4 / 1e9
    pinned = torch.empty((m, STREAM_BLOCK), pin_memory=True)
    t0 = time.perf_counter()
    np.copyto(pinned.numpy(), host[:, :STREAM_BLOCK])
    gather_s = time.perf_counter() - t0
    pageable = torch.from_numpy(np.ascontiguousarray(host[:, :STREAM_BLOCK]))
    _, pinned_ms = median_ms(torch, lambda: pinned.to("cuda", non_blocking=True))
    _, pageable_ms = median_ms(torch, lambda: pageable.to("cuda"))
    del pinned, pageable
    say(f"phase 11 one block {m}x{STREAM_BLOCK} ({block_gb:.2f} GB): host gather "
        f"{block_gb / gather_s:.2f} GB/s, host to device pinned "
        f"{block_gb / pinned_ms * 1e3:.2f} GB/s, pageable {block_gb / pageable_ms * 1e3:.2f} GB/s")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, ms = wall_ms(torch, lambda: nmf_streaming(host, k, **kw))
    peak = torch.cuda.max_memory_allocated() - base
    c = np.asarray(res.cost)
    if (res.n_iters != STREAM_EPOCHS or not np.all(np.isfinite(c)) or not c[-1] <= c[0]
            or res.W.device.type != "cuda"):
        raise AssertionError(f"nmf_streaming: n_iters {res.n_iters}, cost {c}, W on {res.W.device}")
    if not peak < STREAM_PEAK:
        raise AssertionError(f"nmf_streaming added {peak / 1e9:.2f} GB of device memory")
    say(f"phase 11 nmf_streaming {m}x{n} r{k} from a host array, block {STREAM_BLOCK}, "
        f"{STREAM_EPOCHS} epochs: {ms / 1e3 / STREAM_EPOCHS:.3f} s/epoch, "
        f"{gb * STREAM_EPOCHS / ms * 1e3:.2f} GB/s of V streamed, peak device memory "
        f"{peak / 1e9:.3f} GB beside V's {gb:.2f}, cost {c[0]:.7g} -> {c[-1]:.7g}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        np.save(os.path.join(tmp, "V.npy"), host)
        write_s = time.perf_counter() - t0
        Vmm = np.load(os.path.join(tmp, "V.npy"), mmap_mode="r")
        res_mm, ms_mm = wall_ms(torch, lambda: nmf_streaming(Vmm, k, **kw))
        if not (torch.equal(res.W, res_mm.W) and np.array_equal(res.cost, res_mm.cost)):
            raise AssertionError("nmf_streaming from the memmap differs from the host array")
        say(f"phase 11 nmf_streaming from a .npy memmap (written in {write_s:.2f} s): "
            f"{ms_mm / 1e3 / STREAM_EPOCHS:.3f} s/epoch, "
            f"{gb * STREAM_EPOCHS / ms_mm * 1e3:.2f} GB/s; W and cost equal to the host "
            "array's bit for bit")

        H0 = np.random.default_rng(11).uniform(size=(k, n)).astype(np.float32)
        out = np.lib.format.open_memmap(os.path.join(tmp, "H.npy"), mode="w+",
                                        dtype=np.float32, shape=(k, n))
        enc = dict(divergence="kl", maxiter=ENCODE_ITERS)
        streamed, ms_s = wall_ms(torch, lambda: nmf_encode_streaming(
            Vmm, res.W, H_init=H0, out=out, block_size=STREAM_BLOCK, **enc))
        whole, ms_w = wall_ms(torch, lambda: nmf_encode(
            V[None], res.W, H_init=torch.from_numpy(H0)[None].cuda(), **enc))
        cs, cw = np.asarray(streamed.cost), np.asarray(whole.cost[0], np.float64)
        cost_gap = float(np.max(np.abs(cs - cw) / np.abs(cw)))
        Hw = whole.H[0].cpu().numpy()
        h_gap = float(np.max(np.abs(np.asarray(out) - Hw)) / np.max(np.abs(Hw)))
        if streamed.H is not out or not (cost_gap <= ENGINE_RTOL and h_gap <= FACTOR_RTOL):
            raise AssertionError(f"nmf_encode_streaming vs nmf_encode: cost {cost_gap:.3g}, "
                                 f"H {h_gap:.3g}")
        say(f"phase 11 nmf_encode_streaming kl {ENCODE_ITERS} iterations from the memmap "
            f"into a (k, n) memmap: {ms_s / 1e3:.3f} s; in-memory nmf_encode "
            f"{ms_w / 1e3:.3f} s; cost traces {cost_gap:.3g} apart, H {h_gap:.3g} of "
            "its largest entry")
        del Vmm, out

    prof = profile_device_ms(torch, lambda: nmf_streaming(host, k, **{**kw, "epochs": 1}), 1)
    say(f"phase 11 profile one epoch: {json.dumps(prof)}")
    say(f"phase 11 {json.dumps({'s_per_epoch': ms / 1e3 / STREAM_EPOCHS, 's_per_epoch_memmap': ms_mm / 1e3 / STREAM_EPOCHS, 'gbps_streamed': gb * STREAM_EPOCHS / ms * 1e3, 'h2d_pinned_gbps': block_gb / pinned_ms * 1e3, 'h2d_pageable_gbps': block_gb / pageable_ms * 1e3, 'gather_gbps': block_gb / gather_s, 'peak_gb': peak / 1e9, 'npy_write_s': write_s, 'encode_streamed_s': ms_s / 1e3, 'encode_in_memory_s': ms_w / 1e3, 'idle_share': prof['idle_share']})}")


def cluster_accuracy(truth, pred, k):
    """Share of points whose cluster maps to their planted block under the
    best one-to-one matching of clusters to blocks."""
    from scipy.optimize import linear_sum_assignment
    C = np.zeros((k, k))
    np.add.at(C, (truth, pred), 1)
    rows, cols = linear_sum_assignment(-C)
    return C[rows, cols].sum() / len(truth)


def planted_similarity(rng, n, k):
    """A symmetric f32 similarity of k planted blocks of n / k points
    (0.95 within a block, 0.05 across, plus uniform noise of 0.05;
    tests/test_symnmf.py's), and each point's block."""
    truth = np.repeat(np.arange(k), n // k)
    A = (truth[:, None] == truth[None, :]) * 0.9 + 0.05 + 0.05 * rng.uniform(size=(n, n))
    return ((A + A.T) / 2).astype(np.float32), truth


def golden_runs(tt, dev):
    """The six goldens of tests/goldens as tests/test_goldens.py runs them:
    name -> (run(g), factor fields held at GOLDEN_ATOL)."""
    f64 = dict(maxiter=15, tolerance=1e-12, dtype=np.float64, device=dev)
    return {
        "lnmf": (lambda g: tt.lnmf(g["V"], g["W0"].shape[1], W_init=g["W0"],
                                   H_init=g["H0"], **f64), ("W", "H")),
        "seminmf": (lambda g: tt.seminmf(g["V"], g["W0"].shape[1], W_init=g["W0"],
                                         H_init=g["H0"], **f64), ("W", "H")),
        "convexnmf": (lambda g: tt.convexnmf(g["V"], g["G0"].shape[1], G_init=g["G0"],
                                             H_init=g["H0"], **f64), ("W", "H", "G")),
        "chnmf": (lambda g: tt.chnmf(g["V"], g["G0"].shape[1], S_init=g["S"],
                                     G_init=g["G0"], H_init=g["H0"], **f64), ("W", "H")),
        "symnmf": (lambda g: tt.symnmf(g["A"], g["H0"].shape[1], H_init=g["H0"], **f64),
                   ("H",)),
        "constrainednmf_kl": (lambda g: tt.constrainednmf(
            g["V"], g["labels"], g["W0"].shape[1], W_init=g["W0"], Z_init=g["Z0"],
            divergence="kl", **f64), ("W", "H", "Z")),
    }


def family_inits(rng, m, n, k, dtype=np.float32):
    """The inits phase 12 gives each solver, from a NumPy generator, and
    the half-labeled label vector of constrainednmf."""
    u = lambda *s: rng.uniform(size=s).astype(dtype)
    labels = rng.integers(0, LABEL_CLASSES, n)
    labels[rng.permutation(n)[: n // 2]] = -1
    p = min(CHNMF_ANCHORS, n // 4)
    return {"W": u(m, k), "H": u(k, n) + 0.2, "G": u(n, k), "Gs": u(p, k),
            "Z": u(k, int(np.sum(labels < 0)) + LABEL_CLASSES), "p": p, "labels": labels}


def family_calls(tt, V, k, ini, iters, **kw):
    """Phase 12's runs of the five solvers on V (m, n): name -> call()."""
    kw = dict(maxiter=iters, tolerance=NEVER, **kw)
    return {
        "lnmf": lambda: tt.lnmf(V, k, W_init=ini["W"], H_init=ini["H"], **kw),
        "seminmf": lambda: tt.seminmf(V, k, W_init=2 * ini["W"] - 1, H_init=ini["H"], **kw),
        "convexnmf": lambda: tt.convexnmf(V, k, G_init=ini["G"], H_init=ini["H"], **kw),
        "chnmf": lambda: tt.chnmf(V, k, S_init=V[:, : ini["p"]], G_init=ini["Gs"],
                                  H_init=ini["H"], **kw),
        "constrainednmf kl": lambda: tt.constrainednmf(
            V, ini["labels"], k, W_init=ini["W"], Z_init=ini["Z"], divergence="kl", **kw),
    }


def ran_out(name, res, iters):
    """Whether a run did all its iterations.  lnmf's inclusive rule
    (lnmf.m:89) stops once two f32 costs are equal, whatever the
    tolerance, so an lnmf run may also stop by it after the first two."""
    if name == "lnmf" and res.converged:
        return 2 < res.n_iters <= iters
    return res.n_iters == iters


def phase12_gram_family(torch, V):
    """The Gram/MU family at benchmarks/gram_family_marginal.py's width:
    ms per iteration, the one-time Grams, the default inits, symnmf's
    planted clusters, the goldens on the card in f64, and f32 on the card
    against f64 on the CPU."""
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.utils import convex_hull_anchors, kmeans_indicator_h
    m, n, k = GRAM
    ini = {key: torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) and x.dtype == np.float32
           else x for key, x in family_inits(np.random.default_rng(12), m, n, k).items()}
    summary = {}
    for iters in (2, 2 + FAMILY_ITERS):
        for name, call in family_calls(tt, V, k, ini, iters).items():
            if iters == 2:
                call()  # warm-up
            res, ms = wall_ms(torch, call)
            c = np.asarray(res.cost)[: res.n_iters]
            if not (ran_out(name, res, iters) and np.all(np.isfinite(c))):
                raise AssertionError(f"{name}: n_iters {res.n_iters}, cost {c}")
            summary.setdefault(name, {}).update({f"ms_{iters}": ms, "n_iters": res.n_iters})
    for name, s in summary.items():
        s["ms_per_iter"] = (s[f"ms_{2 + FAMILY_ITERS}"] - s["ms_2"]) / (s["n_iters"] - 2)
        say(f"phase 12 {name} {m}x{n} r{k}: {s['ms_per_iter']:.3f} ms/iter "
            f"(calls of 2 and {s['n_iters']} iterations: {s['ms_2']:.1f} and "
            f"{s[f'ms_{2 + FAMILY_ITERS}']:.1f} ms)")
    del ini
    S = V[:, :CHNMF_ANCHORS]
    V.T @ V  # warm-up
    _, vtv_ms = wall_ms(torch, lambda: V.T @ V)
    _, sv_ms = wall_ms(torch, lambda: (S.T @ V, S.T @ S))
    kmeans_indicator_h(torch.Generator().manual_seed(1), V[:, :1000], k)  # warm-up
    _, km_ms = wall_ms(torch, lambda: kmeans_indicator_h(torch.Generator().manual_seed(0), V, k))
    anchors, hull_ms = wall_ms(torch, lambda: convex_hull_anchors(V, seed=0))
    summary["grams_s"] = {"VtV": vtv_ms / 1e3, "StV_StS": sv_ms / 1e3}
    summary["inits_s"] = {"kmeans_indicator_h": km_ms / 1e3,
                          "convex_hull_anchors": hull_ms / 1e3, "anchors": anchors.shape[1]}
    say(f"phase 12 one-time Grams: V'V {vtv_ms / 1e3:.3f} s, S'V with S'S (p "
        f"{CHNMF_ANCHORS}) {sv_ms / 1e3:.3f} s; default inits: kmeans_indicator_h "
        f"k={k} {km_ms / 1e3:.3f} s, convex_hull_anchors (randomized path) "
        f"{hull_ms / 1e3:.3f} s, p = {anchors.shape[1]}")
    del S, anchors

    ns, ks = SYM
    A, truth = planted_similarity(np.random.default_rng(13), ns, ks)
    A = torch.from_numpy(A).cuda()
    sym = lambda it: tt.symnmf(A, ks, maxiter=it, tolerance=NEVER, seed=0)
    sym(2)
    (_, ms2), (res, ms22) = (wall_ms(torch, lambda: sym(it)) for it in (2, 2 + FAMILY_ITERS))
    acc20 = cluster_accuracy(truth, torch.argmax(res.H, dim=1).cpu().numpy(), ks)
    res = sym(SYM_RECOVERY_ITERS)
    acc = cluster_accuracy(truth, torch.argmax(res.H, dim=1).cpu().numpy(), ks)
    if not (acc >= SYM_ACCURACY and np.all(np.isfinite(res.cost))):
        raise AssertionError(f"symnmf recovered {acc:.3f} of the planted blocks")
    summary["symnmf"] = {"ms_per_iter": (ms22 - ms2) / FAMILY_ITERS, "accuracy": acc,
                         "accuracy_22": acc20}
    say(f"phase 12 symnmf n={ns} r{ks}, {ks} planted blocks: {(ms22 - ms2) / FAMILY_ITERS:.3f} "
        f"ms/iter; clusters match the blocks on {acc:.4f} of the points after "
        f"{SYM_RECOVERY_ITERS} iterations ({acc20:.4f} after {2 + FAMILY_ITERS})")
    del A, res

    gold = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
    worst = 0.0
    for name, (run, fields) in golden_runs(tt, "cuda").items():
        g = np.load(gold / f"{name}.npz")
        r = run(g)
        for f in fields:
            x = getattr(r, f)
            if x.device.type != "cuda":
                raise AssertionError(f"golden {name}: {f} on {x.device}")
            err = float(np.max(np.abs(x.cpu().numpy() - g[f])))
            worst = max(worst, err)
            if not err <= GOLDEN_ATOL:
                raise AssertionError(f"golden {name} {f}: {err:.3g} > {GOLDEN_ATOL}")
        if not np.allclose(r.cost, g["cost"], rtol=GOLDEN_RTOL, atol=0):
            raise AssertionError(f"golden {name}: cost trace off")
        if name.startswith("constrainednmf") and not np.array_equal(r.A, g["A"]):
            raise AssertionError("golden constrainednmf_kl: A differs")
    say(f"phase 12 goldens on the card in f64 (lnmf, seminmf, convexnmf, chnmf, symnmf, "
        f"constrainednmf_kl): factors within {worst:.3g} (<= {GOLDEN_ATOL}), costs within "
        f"rtol {GOLDEN_RTOL}, A exact")

    ms_, ns_, ks_ = SMALL
    rng = np.random.default_rng(42)
    Vs = rng.uniform(0.05, 1.0, (ms_, ns_))
    ini = family_inits(rng, ms_, ns_, ks_, np.float64)
    As = planted_similarity(rng, ns_, ks_)[0].astype(np.float64)
    Hs = rng.uniform(size=(ns_, ks_))
    f32 = {key: x.astype(np.float32) if isinstance(x, np.ndarray) and x.dtype == np.float64
           else x for key, x in ini.items()}
    card = family_calls(tt, Vs.astype(np.float32), ks_, f32, SMALL_ITERS)
    card["symnmf"] = lambda: tt.symnmf(As.astype(np.float32), ks_, H_init=Hs.astype(np.float32),
                                       maxiter=SMALL_ITERS, tolerance=NEVER)
    cpu = family_calls(tt, Vs, ks_, ini, SMALL_ITERS, device="cpu")
    cpu["symnmf"] = lambda: tt.symnmf(As, ks_, H_init=Hs, maxiter=SMALL_ITERS,
                                      tolerance=NEVER, device="cpu")
    gaps = {}
    for name, call in card.items():
        a, b = call(), cpu[name]()
        if getattr(a, a.fields[0]).device.type != "cuda":
            raise AssertionError(f"{name}: NumPy input did not run on the card")
        if not (ran_out(name, a, SMALL_ITERS) and b.n_iters == SMALL_ITERS):
            raise AssertionError(f"{name}: {a.n_iters} and {b.n_iters} iterations")
        c32 = np.asarray(a.cost, np.float64)[: a.n_iters]
        c64 = np.asarray(b.cost)[: a.n_iters]
        gaps[name] = float(np.max(np.abs(c32 - c64) / np.abs(c64)))
        if not gaps[name] <= F32_RTOL:
            raise AssertionError(f"{name}: f32 card {gaps[name]:.3g} from f64 CPU")
    summary["f32_vs_f64"] = gaps
    say(f"phase 12 f32 on the card vs f64 on the CPU, {ms_}x{ns_} r{ks_}, {SMALL_ITERS} "
        f"iterations, cost traces: {json.dumps(gaps)}")
    say(f"phase 12 {json.dumps(summary)}")


def per_iter_ms(torch, calls, iters=CONV_ITERS, phase=13):
    """name -> call(iters): ms per iteration from calls of 2 and
    2 + ``iters`` iterations after a warm-up, so one-time work drops out;
    each run finite with all its iterations.  Returns name -> (ms/iter,
    the longer run's Result)."""
    out = {}
    for name, call in calls.items():
        call(2)  # warm-up
        (_, ms2), (res, ms22) = (wall_ms(torch, lambda: call(it)) for it in (2, 2 + iters))
        c = np.asarray(res.cost)
        if res.n_iters != 2 + iters or not np.all(np.isfinite(c)):
            raise AssertionError(f"{name}: n_iters {res.n_iters}, cost {c}")
        out[name] = ((ms22 - ms2) / iters, res)
        say(f"phase {phase} {name}: {out[name][0]:.3f} ms/iter (calls of 2 and "
            f"{2 + iters} iterations: {ms2:.1f} and {ms22:.1f} ms), final cost "
            f"{c[-1]:.7g}")
    return out


def conv_golden_runs(tt, dev):
    """The convolutive goldens as tests/test_goldens.py runs them:
    name -> (golden file, run(g), factor fields held at its tolerance)."""
    f64 = dict(tolerance=1e-12, dtype=np.float64, device=dev)
    cnmf = lambda method: (lambda g: tt.cnmf(
        g["V"], g["W0"].shape[1], g["W0"].shape[2], W_init=g["W0"], H_init=g["H0"],
        maxiter=15, method=method, **f64))
    return {
        "cnmf_euclid naive": ("cnmf_euclid", cnmf("naive"), ("W",)),
        "cnmf_euclid gram": ("cnmf_euclid", cnmf("gram"), ("W",)),
        "chcnmf": ("chcnmf", lambda g: tt.chcnmf(
            g["V"], g["G0"].shape[1], int(g["T"]), S_init=g["S"], G_init=g["G0"],
            H_init=g["H0"], H_sparsity=float(g["H_sparsity"]), maxiter=12, **f64),
            ("W", "H")),
        "nmf2d_kl": ("nmf2d_kl", lambda g: tt.nmf2d(
            g["V"], g["W0"].shape[1], g["W0"].shape[2], g["H0"].shape[2], W_init=g["W0"],
            H_init=g["H0"], divergence="kl", maxiter=15, **f64), ("W", "H")),
    }


def conv_small_calls(tt, V, ini, **kw):
    """Phase 13's f32-vs-f64 runs on V (m, n): name -> call()."""
    _, _, k, T, P, p = CONV_SMALL
    kw = dict(maxiter=SMALL_ITERS, tolerance=NEVER, **kw)
    cnmf = lambda **c: tt.cnmf(V, k, T, W_init=ini["W"], H_init=ini["H"], **c, **kw)
    nmf2d = lambda **c: tt.nmf2d(V, k, T, P, W_init=ini["W"], H_init=ini["H3"], **c, **kw)
    return {
        "cnmf euclidean": lambda: cnmf(),
        "cnmf kl": lambda: cnmf(divergence="kl"),
        "nmf2d euclidean": lambda: nmf2d(),
        "nmf2d kl": lambda: nmf2d(divergence="kl"),
        "chcnmf": lambda: tt.chcnmf(V, k, T, S_init=V[:, :p], G_init=ini["G"],
                                    H_init=ini["H"], **kw),
    }


def phase13_convolutive(torch, V_big):
    """The convolutive family at the JAX package's shapes for it: ms per
    iteration, the encoders per call, profiles, the goldens on the card in
    f64, and f32 on the card against f64 on the CPU."""
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.core import EPS
    from nmf_toolbox_tpu_torch.models import batched as tb
    from nmf_toolbox_tpu_torch.ops.divergence import ab_params
    tchc = importlib.import_module("nmf_toolbox_tpu_torch.models.chcnmf")
    summary = {}

    # a, b: cnmf and nmf2d at 513x10 000 r64 T8 (P5)
    m, n, k, T = CONV
    g = torch.Generator(device="cuda").manual_seed(13)
    V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
    W0 = torch.rand((m, k, T), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    H3 = torch.rand((k, n, CONV_P), generator=g, device="cuda")
    kw = dict(W_init=W0, tolerance=NEVER)
    timed = per_iter_ms(torch, {
        f"cnmf euclidean gram {m}x{n} r{k} T{T}": lambda it: tt.cnmf(
            V, k, T, H_init=H0, maxiter=it, method="gram", **kw),
        f"cnmf euclidean naive {m}x{n} r{k} T{T}": lambda it: tt.cnmf(
            V, k, T, H_init=H0, maxiter=it, method="naive", **kw),
        f"cnmf kl {m}x{n} r{k} T{T}": lambda it: tt.cnmf(
            V, k, T, H_init=H0, maxiter=it, divergence="kl", **kw),
        f"cnmf is {m}x{n} r{k} T{T}": lambda it: tt.cnmf(
            V, k, T, H_init=H0, maxiter=it, divergence="is", **kw),
        f"nmf2d euclidean {m}x{n} r{k} T{T} P{CONV_P}": lambda it: tt.nmf2d(
            V, k, T, CONV_P, H_init=H3, maxiter=it, **kw),
        f"nmf2d kl {m}x{n} r{k} T{T} P{CONV_P}": lambda it: tt.nmf2d(
            V, k, T, CONV_P, H_init=H3, maxiter=it, divergence="kl", **kw),
    })
    summary["ms_per_iter"] = {name: ms for name, (ms, _) in timed.items()}
    gram, naive = (np.asarray(timed[f"cnmf euclidean {x} {m}x{n} r{k} T{T}"][1].cost, np.float64)
                   for x in ("gram", "naive"))
    floor = float(gram_floor(torch, V))
    gap = np.abs(gram - naive)
    if not np.all(gap <= ENGINE_RTOL * np.abs(naive) + floor):
        raise AssertionError(f"cnmf gram trace {np.max(gap / naive):.3g} from naive's")
    summary["gram_vs_naive"] = float(np.max(gap / naive))
    say(f"phase 13 cnmf gram vs naive cost traces: {summary['gram_vs_naive']:.3g} "
        f"relative (allowed rtol {ENGINE_RTOL} + {floor:.3g})")
    prof = profile_device_ms(torch, lambda: tt.cnmf(
        V, k, T, H_init=H0, maxiter=ITERS, divergence="kl", **kw), ITERS)
    say(f"phase 13 profile cnmf kl: {json.dumps(prof)}")
    summary["idle_share_cnmf_kl"] = prof["idle_share"]
    del V, W0, H0, H3, timed

    # c: chcnmf at 100 000x10 000 r200 T8, S = V's first 500 columns
    m, n = V_big.shape
    k, T, p = CHCNMF
    S = V_big[:, :p]
    g = torch.Generator(device="cuda").manual_seed(14)
    G0 = torch.rand((p, k, T), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    (S.T @ V_big, S.T @ S)  # warm-up
    _, grams_ms = wall_ms(torch, lambda: (S.T @ V_big, S.T @ S))
    timed = per_iter_ms(torch, {f"chcnmf {m}x{n} r{k} T{T} p{p}": lambda it: tt.chcnmf(
        V_big, k, T, S_init=S, G_init=G0, H_init=H0, maxiter=it, tolerance=NEVER)})
    summary["ms_per_iter"].update({name: ms for name, (ms, _) in timed.items()})
    W_init = V_big[:, p:p + k * T].reshape(m, k, T)
    tchc._fit_g_to_w(S, W_init, G0, iters=1)  # warm-up
    _, step_ms = wall_ms(torch, lambda: tchc._fit_g_to_w(S, W_init, G0, iters=1))
    G_fit, fit_ms = wall_ms(torch, lambda: tchc._fit_g_to_w(S, W_init, G0))
    if not bool(torch.isfinite(G_fit).all()):
        raise AssertionError("chcnmf's fit of G to W_init is not finite")
    summary["chcnmf_one_time_s"] = {"StV_StS": grams_ms / 1e3, "fit_g_to_w": fit_ms / 1e3,
                                    "fit_g_to_w_one_step": step_ms / 1e3}
    say(f"phase 13 chcnmf one-time: S'V with S'S {grams_ms / 1e3:.4f} s; the fit of G to a "
        f"W_init ({m}x{k}x{T}) {fit_ms / 1e3:.3f} s, one step of it {step_ms:.2f} ms")
    del S, G0, H0, W_init, G_fit, timed

    # d: the encoders on phase 9's batch
    B, m, n, k = SERVING
    rng, _, Vs = serving_batch(torch)
    T, (T2, P2) = CONV_ENCODE_T, NMF2D_ENCODE_TP
    Wc, W2 = (torch.from_numpy(rng.gamma(2.0, 1.0, (m, k, t)).astype(np.float32)).cuda()
              for t in (T, T2))
    H0, H02 = (torch.from_numpy(rng.uniform(size=s).astype(np.float32)).cuda()
               for s in ((B, k, n), (B, k, n, P2)))
    one = dict(maxiter=ENGINE_ITERS, tolerance=NEVER, W_fixed=True)
    engines = {
        "cnmf_encode": (lambda **c: tt.cnmf_encode(Vs, Wc, H_init=H0, maxiter=ENGINE_ITERS, **c),
                        lambda i, **c: tt.cnmf(Vs[i], k, T, W_init=Wc, H_init=H0[i], **one, **c)),
        "nmf2d_encode": (lambda **c: tt.nmf2d_encode(Vs, W2, P2, H_init=H02,
                                                     maxiter=ENGINE_ITERS, **c),
                         lambda i, **c: tt.nmf2d(Vs[i], k, T2, P2, W_init=W2, H_init=H02[i],
                                                 **one, **c)),
    }
    out = {}
    for engine, (call, single) in engines.items():
        for div in ("euclidean", "kl"):
            for ce in (1, 10):
                name = f"{engine} {div}" + ("" if ce == 1 else f" cost_every={ce}")
                res, ms = median_ms(torch, lambda: call(divergence=div, cost_every=ce))
                refs = {} if ce > 1 else {i: single(i, divergence=div) for i in (0, B - 1)}
                gap, gap_f = check_engine(name, res, torch, refs,
                                          0.0 if div == "kl" else gram_floor(torch, Vs))
                out[name] = {"ms_per_call": ms, "ms_per_problem": ms / B, "res": res,
                             "cost_gap": gap, "factor_gap": gap_f}
                say(f"phase 13 {name} B{B} {m}x{n} r{k}, {ENGINE_ITERS} iterations: "
                    f"{ms:.2f} ms/call, {1e3 * ms / B:.2f} us/problem, final cost mean "
                    f"{np.mean(res.cost[:, -1]):.7g}; problems 0 and {B - 1} against the "
                    f"single solver: costs {gap:.3g}, factors {gap_f:.3g} relative")
            r1, r10 = out[f"{engine} {div}"]["res"], out[f"{engine} {div} cost_every=10"]["res"]
            checks = [i for i in range(ENGINE_ITERS) if i == 0 or (i + 1) % 10 == 0]
            if not (torch.equal(r1.H, r10.H)
                    and np.array_equal(r1.cost[:, checks], r10.cost[:, checks])):
                raise AssertionError(f"{engine} {div}: cost_every=10 moved H or a check's cost")
    hsp = torch.zeros(k, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for div in ("euclidean", "kl"):
            a, b = ab_params(div, 1.0, 1.0)
            tb._solve_conv_encode(tb._EncSpec(ENGINE_ITERS, EPS, div, a, b), Vs, Wc, H0, hsp)
            tb._solve_nmf2d_encode(tb._EncSpec(ENGINE_ITERS, EPS, div, a, b, 10, P2),
                                   Vs, W2, H02, hsp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"phase 13 cost_every=10 leaves H bit-identical; the cnmf_encode and nmf2d_encode "
        f"solves (euclidean, kl), {ENGINE_ITERS} iterations each, ran under "
        "set_sync_debug_mode('error'): no host sync")
    prof = profile_device_ms(torch, lambda: tt.cnmf_encode(
        Vs, Wc, H_init=H0, divergence="kl", maxiter=ENGINE_ITERS), ENGINE_ITERS)
    say(f"phase 13 profile cnmf_encode kl: {json.dumps(prof)}")
    summary["encoders"] = {name: {key: v for key, v in r.items() if key != "res"}
                           for name, r in out.items()}
    summary["idle_share_cnmf_encode_kl"] = prof["idle_share"]
    del Vs, Wc, W2, H0, H02, out

    # f: the goldens on the card in f64
    gold = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
    worst = {}
    for name, (file, run, fields) in conv_golden_runs(tt, "cuda").items():
        g = np.load(gold / f"{file}.npz")
        tol = CONV_GOLDEN_TOL[file]
        r = run(g)
        for f in fields:
            x = getattr(r, f)
            err = float(np.max(np.abs(x.cpu().numpy() - g[f])))
            if x.device.type != "cuda" or not err <= tol:
                raise AssertionError(f"golden {name} {f}: {err:.3g} > {tol} on {x.device}")
            worst[name] = max(worst.get(name, 0.0), err)
        if not np.allclose(r.cost, g["cost"], rtol=tol, atol=0):
            raise AssertionError(f"golden {name}: cost trace off")
    summary["goldens_f64_max_abs_err"] = worst
    say(f"phase 13 goldens on the card in f64, factors' max abs error (tolerance "
        f"{json.dumps(CONV_GOLDEN_TOL)}, costs at the same rtol): {json.dumps(worst)}")

    # g: f32 on the card (NumPy inputs, no device=) against f64 on the CPU
    ms_, ns_, ks_, Ts, Ps, ps = CONV_SMALL
    rng = np.random.default_rng(44)
    Vsm = rng.uniform(0.05, 1.0, (ms_, ns_))
    ini = {"W": rng.uniform(size=(ms_, ks_, Ts)), "H": rng.uniform(size=(ks_, ns_)),
           "H3": rng.uniform(size=(ks_, ns_, Ps)), "G": rng.uniform(size=(ps, ks_, Ts))}
    f32 = {key: x.astype(np.float32) for key, x in ini.items()}
    card = conv_small_calls(tt, Vsm.astype(np.float32), f32)
    cpu = conv_small_calls(tt, Vsm, ini, device="cpu")
    gaps = {}
    for name, call in card.items():
        a, b = call(), cpu[name]()
        if a.W.device.type != "cuda":
            raise AssertionError(f"{name}: NumPy input did not run on the card")
        if not (a.n_iters == b.n_iters == SMALL_ITERS):
            raise AssertionError(f"{name}: {a.n_iters} and {b.n_iters} iterations")
        c32, c64 = np.asarray(a.cost, np.float64), np.asarray(b.cost)
        gaps[name] = float(np.max(np.abs(c32 - c64) / np.abs(c64)))
        if not gaps[name] <= F32_RTOL:
            raise AssertionError(f"{name}: f32 card {gaps[name]:.3g} from f64 CPU")
    summary["f32_vs_f64"] = gaps
    say(f"phase 13 f32 on the card vs f64 on the CPU, {ms_}x{ns_} r{ks_} T{Ts} P{Ps} "
        f"(chcnmf p {ps}), {SMALL_ITERS} iterations, cost traces: {json.dumps(gaps)}")
    say(f"phase 13 {json.dumps(summary)}")


def sparse_timing(torch, name, call, phase=14, launches=None):
    """ms and host reads (``core.host_reads``) per iteration of
    ``call(iters)`` from calls of 2 and 2 + SPARSE_ITERS iterations after
    a warm-up, and kernel launches per iteration where ``launches()``
    reads a counter; the trace finite and non-increasing within
    SPARSE_MONO relative.  A solve that ends on a line-search underflow
    (cnmfsc with a sparse W does in its first iteration, as the reference
    does) is reported per executed iteration of the longer call."""
    from nmf_toolbox_tpu_torch import core
    count = launches or (lambda: 0)
    call(2)  # warm-up
    r0, l0 = core.host_reads, count()
    short, ms2 = wall_ms(torch, lambda: call(2))
    r1, l1 = core.host_reads, count()
    res, ms22 = wall_ms(torch, lambda: call(2 + SPARSE_ITERS))
    r2, l2 = core.host_reads, count()
    c = np.asarray(res.cost, np.float64)
    if not np.all(np.isfinite(c)) or not np.all(np.diff(c) <= SPARSE_MONO * np.abs(c[:-1])):
        raise AssertionError(f"{name}: cost trace not finite or not non-increasing: {c}")
    if not bool(torch.isfinite(res.W).all() & torch.isfinite(res.H).all()):
        raise AssertionError(f"{name}: factors not finite")
    done = res.n_iters - short.n_iters
    if done > 0:
        out = {"ms_per_iter": (ms22 - ms2) / done,
               "reads_per_iter": ((r2 - r1) - (r1 - r0)) / done,
               "launches_per_iter": ((l2 - l1) - (l1 - l0)) / done}
    else:  # both calls ended on the same underflow: the whole call per iteration
        out = {"ms_per_iter": ms22 / res.n_iters, "reads_per_iter": (r2 - r1) / res.n_iters,
               "launches_per_iter": (l2 - l1) / res.n_iters}
    out.update(n_iters=res.n_iters, ended_on_underflow=res.n_iters < 2 + SPARSE_ITERS,
               final_cost=float(c[-1]), ms_calls=(ms2, ms22))
    say(f"phase {phase} {name}: {out['ms_per_iter']:.3f} ms/iter, {out['reads_per_iter']:.2f} "
        f"host reads/iter"
        + (f", {out['launches_per_iter']:.2f} kernel launches/iter" if launches else "")
        + f" (calls of 2 and {2 + SPARSE_ITERS}: {ms2:.1f} and {ms22:.1f} ms, "
        f"{short.n_iters} and {res.n_iters} iterations"
        + (", ended on a line-search underflow" if out["ended_on_underflow"] else "")
        + f"), final cost {c[-1]:.7g}")
    return out, res


def sparse_golden_runs(tt, dev):
    """The goldens of this slice as tests/test_goldens.py runs them:
    name -> (run(g), fields held at its tolerance)."""
    f64 = dict(tolerance=1e-12, dtype=np.float64, device=dev)
    return {
        "nmfsc_sparse": (lambda g: tt.nmfsc(
            g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"], W_sparsity=0.5,
            H_sparsity=0.6, maxiter=12, **f64), ("W",)),
        "cnmfsc_sparse": (lambda g: tt.cnmfsc(
            g["V"], g["W0"].shape[1], int(g["T"]), W_init=g["W0"], H_init=g["H0"],
            W_sparsity=float(g["W_sparsity"]), H_sparsity=float(g["H_sparsity"]),
            maxiter=10, **f64), ("W", "H")),
        "cmfwisa": (lambda g: tt.cmfwisa(
            g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
            H_sparsity=float(g["H_sparsity"]), maxiter=15, tolerance=1e-12,
            dtype=np.complex128, device=dev), ("W", "H", "P")),
    }


def sparse_small_calls(tt, ini, **kw):
    """Phase 14's f32-vs-f64 runs: name -> call()."""
    kw = dict(maxiter=SMALL_ITERS, tolerance=NEVER, **kw)
    _, _, k, T = SPARSE_SMALL
    return {
        "nmfsc": lambda: tt.nmfsc(ini["V"], k, W_init=ini["W"], H_init=ini["H"],
                                  W_sparsity=0.5, H_sparsity=0.6, **kw),
        "cnmfsc": lambda: tt.cnmfsc(ini["Vc"], k, T, W_init=ini["W3"], H_init=ini["H"],
                                    H_sparsity=0.5, **kw),
        "cmfwisa": lambda: tt.cmfwisa(ini["Z"], k, W_init=ini["W"][:129], H_init=ini["H"],
                                      H_sparsity=0.1, **kw),
    }


def two_source_signal(n_fft, hop, frames):
    """A tonal source (two steady sines with a slow vibrato) and a
    percussive one (decaying noise bursts), at 16 kHz, long enough for
    ``frames`` centered STFT frames; f32."""
    rng = np.random.default_rng(14)
    t = np.arange(hop * (frames - 1)) / 16_000
    a = 0.5 * np.sin(2 * np.pi * 440 * t + 2 * np.sin(2 * np.pi * 0.5 * t)) \
        + 0.3 * np.sin(2 * np.pi * 660 * t)
    b = np.zeros_like(t)
    for i in range(800, len(t) - 2000, 4000):
        b[i: i + 2000] += 0.8 * rng.normal(size=2000) * np.exp(-np.arange(2000) / 300.0)
    return a.astype(np.float32), b.astype(np.float32)


def phase14_sparse_complex_audio(torch, V_big):
    """The projected-gradient and complex solvers and the audio front end
    at the JAX package's shapes for them, f32, TF32 off: ms per iteration
    and host reads per iteration, both line-search widths, the encoder
    per call, the audio path, the goldens in f64, and f32 on the card
    against f64 on the CPU."""
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.core import EPS
    from nmf_toolbox_tpu_torch.models import batched as tb
    from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk
    summary = {"ms_per_iter": {}, "reads_per_iter": {}, "hoyer_launches_per_iter": {}}
    launches = lambda: hk.hoyer_project_launches  # noqa: E731

    def keep(name, out):
        summary["ms_per_iter"][name] = out["ms_per_iter"]
        summary["reads_per_iter"][name] = out["reads_per_iter"]
        summary["hoyer_launches_per_iter"][name] = out["launches_per_iter"]

    # a: nmfsc at BASELINE #2, both line-search widths
    m, n, k = SPARSE_BASE
    g = torch.Generator(device="cuda").manual_seed(15)
    V = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    traces = {}
    for w in SPARSE_WIDTHS:
        name = f"nmfsc H_sparsity 0.6 {m}x{n} r{k} width {w}"
        call = lambda it: tt.nmfsc(V, k, W_init=W0, H_init=H0, H_sparsity=0.6,  # noqa: E731
                                   maxiter=it, tolerance=NEVER, linesearch_width=w)
        out, res = sparse_timing(torch, name, call, launches=launches)
        keep(name, out)
        traces[w] = np.asarray(res.cost, np.float64)
        if w == 0:  # the default's idle share
            prof = profile_device_ms(torch, lambda: call(ITERS), ITERS)
            summary[f"idle_share {name}"] = prof["idle_share"]
            say(f"phase 14 profile {name}, {ITERS} iterations with the one-time work: "
                f"{json.dumps(prof)}")
    a, b = (traces[w] for w in SPARSE_WIDTHS)
    gap = float(np.max(np.abs(a - b) / np.abs(a))) if len(a) == len(b) else np.inf
    if not gap <= WIDTH_RTOL:
        raise AssertionError(f"nmfsc widths {SPARSE_WIDTHS}: traces {gap:.3g} apart")
    summary["widths_gap"] = gap
    say(f"phase 14 nmfsc widths {SPARSE_WIDTHS[0]} and {SPARSE_WIDTHS[1]}: cost traces "
        f"{gap:.3g} apart (allowed rtol {WIDTH_RTOL})")
    del V, W0, H0

    # b: nmfsc at full width on phase 7's V, both factors sparse
    m, n = V_big.shape
    k = GRAM[2]
    g = torch.Generator(device="cuda").manual_seed(16)
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    name = f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {m}x{n} r{k}"
    call = lambda it: tt.nmfsc(V_big, k, W_init=W0, H_init=H0, W_sparsity=0.5,  # noqa: E731
                               H_sparsity=0.6, maxiter=it, tolerance=NEVER)
    out, _ = sparse_timing(torch, name, call, launches=launches)
    keep(name, out)
    prof = profile_device_ms(torch, lambda: call(ITERS), ITERS)
    summary["profile_nmfsc_full"] = prof
    summary[f"idle_share {name}"] = prof["idle_share"]
    say(f"phase 14 profile {name}, {ITERS} iterations with the one-time work: {json.dumps(prof)}")
    del W0, H0

    # c: cnmfsc at 513x10 000 r64 T8, H sparse, then W sparse too
    m, n, k, T = CONV
    g = torch.Generator(device="cuda").manual_seed(17)
    V = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    W0 = 0.1 + 0.9 * torch.rand((m, k, T), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    for extra in ({}, {"W_sparsity": 0.5}):
        name = f"cnmfsc H_sparsity 0.5{' W_sparsity 0.5' if extra else ''} {m}x{n} r{k} T{T}"
        call = lambda it: tt.cnmfsc(V, k, T, W_init=W0, H_init=H0, H_sparsity=0.5,  # noqa: E731
                                    maxiter=it, tolerance=NEVER, **extra)
        out, _ = sparse_timing(torch, name, call, launches=launches)
        keep(name, out)
        iters = min(ITERS, out["n_iters"])  # a sparse W ends in its first iteration
        prof = profile_device_ms(torch, lambda: call(ITERS), iters)
        summary[f"idle_share {name}"] = prof["idle_share"]
        say(f"phase 14 profile {name}, {iters} iterations with the one-time work: "
            f"{json.dumps(prof)}")
    del V, W0, H0

    # d: cmfwisa complex64 at 513x5000 r32, one source and two
    m, n, k = CMF
    g = torch.Generator(device="cuda").manual_seed(18)
    mag = torch.rand((m, n), generator=g, device="cuda")
    Z = mag * torch.exp(1j * (2 * torch.rand((m, n), generator=g, device="cuda") - 1) * np.pi)
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    h = k // 2
    timed = per_iter_ms(torch, {
        f"cmfwisa complex64 {m}x{n} r{k}": lambda it: tt.cmfwisa(
            Z, k, W_init=W0, H_init=H0, maxiter=it, tolerance=NEVER),
        f"cmfwisa complex64 {m}x{n} r{h}+{h}": lambda it: tt.cmfwisa(
            Z, [h, h], W_init=[W0[:, :h], W0[:, h:]], H_init=[H0[:h], H0[h:]],
            maxiter=it, tolerance=NEVER),
    }, iters=SPARSE_ITERS, phase=14)
    summary["ms_per_iter"].update({name: ms for name, (ms, _) in timed.items()})
    del Z, mag, W0, H0, timed

    # e: cmfwisa_encode on phase 9's batch with uniform random phases
    B, m, n, k = SERVING
    rng, _, Vs = serving_batch(torch)
    Vc = Vs * torch.exp(1j * torch.from_numpy(
        rng.uniform(-np.pi, np.pi, (B, m, n)).astype(np.float32)).cuda())
    Wd = torch.from_numpy(rng.gamma(2.0, 1.0, (m, k)).astype(np.float32)).cuda()
    H0 = torch.from_numpy(rng.uniform(size=(B, k, n)).astype(np.float32)).cuda()
    res, ms = median_ms(torch, lambda: tt.cmfwisa_encode(Vc, Wd, H_init=H0, maxiter=ENGINE_ITERS))
    refs = {i: tt.cmfwisa(Vc[i], k, W_init=Wd, H_init=H0[i], W_fixed=True,
                          maxiter=ENGINE_ITERS, tolerance=NEVER) for i in (0, B - 1)}
    gap, gap_f = check_engine("cmfwisa_encode", res, torch, refs)
    hsp = torch.zeros(k, device="cuda")
    P0 = torch.exp(1j * torch.angle(Vc))[:, None]
    Wn = res.W  # the normalized dictionary
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tb._solve_cmf_encode(tb._CmfEncSpec(ENGINE_ITERS, EPS, ((0, k),), (False,)),
                             Vc, Wn, H0, P0, hsp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    summary["cmfwisa_encode"] = {"ms_per_call": ms, "ms_per_problem": ms / B,
                                 "cost_gap": gap, "factor_gap": gap_f}
    say(f"phase 14 cmfwisa_encode B{B} {m}x{n} r{k} complex64, {ENGINE_ITERS} iterations: "
        f"{ms:.2f} ms/call, {1e3 * ms / B:.2f} us/problem; problems 0 and {B - 1} against "
        f"cmfwisa(W_fixed=True): costs {gap:.3g}, factors {gap_f:.3g} relative; the solve "
        "ran under set_sync_debug_mode('error')")
    del Vs, Vc, Wd, H0, P0, res, refs

    # f: the audio path on a synthetic two-source waveform
    n_fft, hop, frames, cmf_iters, gl_iters = AUDIO
    a, b = two_source_signal(n_fft, hop, frames)
    x = torch.from_numpy(a + b).cuda()
    # warm-ups at the timed sizes: cuFFT plans a transform at its first call
    tt.istft(tt.stft(x, n_fft=n_fft, hop_length=hop), hop_length=hop, length=len(x))
    Z, stft_ms = wall_ms(torch, lambda: tt.stft(x, n_fft=n_fft, hop_length=hop))
    y, istft_ms = wall_ms(torch, lambda: tt.istft(Z, hop_length=hop, length=len(x)))
    err = float((y - x).abs().max())
    if not (Z.shape == (n_fft // 2 + 1, frames) and err <= AUDIO_ATOL[0]):
        raise AssertionError(f"stft {tuple(Z.shape)}; istft(stft(x)) {err:.3g} from x")
    mags = [tt.magnitude(tt.stft(torch.from_numpy(s).cuda(), n_fft=n_fft, hop_length=hop))
            for s in (a, b)]
    W_src = [tt.nmf(M, 16, maxiter=30, seed=i).W for i, M in enumerate(mags)]
    ks = [16, 16]
    res, cmf_ms = wall_ms(torch, lambda: tt.cmfwisa(Z, ks, W_init=W_src, maxiter=cmf_iters,
                                                    tolerance=NEVER, seed=3))
    c = np.asarray(res.cost)
    if not (res.n_iters == cmf_iters and np.all(np.isfinite(c))):
        raise AssertionError(f"audio cmfwisa: n_iters {res.n_iters}, cost {c}")
    sep = lambda: tt.separate_waveforms(Z, res.W, res.H, hop_length=hop, length=len(x))  # noqa: E731
    sep()
    est, sep_ms = wall_ms(torch, sep)
    y_mix = tt.istft(Z, hop_length=hop, length=len(x))
    err_sum = float((est.sum(0) - y_mix).abs().max())
    if not (est.shape == (2, len(x)) and err_sum <= AUDIO_ATOL[1]):
        raise AssertionError(f"separate_waveforms: {tuple(est.shape)}, sum {err_sum:.3g} off")
    sdr = [float(10 * torch.log10((s ** 2).sum() / ((s - e) ** 2).sum()))
           for s, e in zip((torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()), est)]
    gl = lambda: tt.griffinlim(mags[0], n_iter=gl_iters, hop_length=hop, length=len(x))  # noqa: E731
    gl()
    y_gl, gl_ms = wall_ms(torch, gl)
    if not bool(torch.isfinite(y_gl).all()):
        raise AssertionError("griffinlim: not finite")
    summary["audio_ms"] = {"stft": stft_ms, "istft": istft_ms, "cmfwisa": cmf_ms,
                           "separate_waveforms": sep_ms, "griffinlim": gl_ms}
    say(f"phase 14 audio, {len(x)} samples, n_fft {n_fft} hop {hop} -> {tuple(Z.shape)}: stft "
        f"{stft_ms:.2f} ms, istft {istft_ms:.2f} ms (max error {err:.3g}), cmfwisa 16+16 "
        f"{cmf_iters} iterations {cmf_ms:.1f} ms, separate_waveforms {sep_ms:.2f} ms (the "
        f"estimates sum to istft(Z) within {err_sum:.3g}; SDR {sdr[0]:.2f} and {sdr[1]:.2f} dB), "
        f"griffinlim {gl_iters} iterations {gl_ms:.1f} ms")
    del x, Z, y, mags, W_src, res, est, y_mix, y_gl

    # g: the goldens on the card in f64
    gold = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
    worst = {}
    for name, (run, fields) in sparse_golden_runs(tt, "cuda").items():
        gd = np.load(gold / f"{name}.npz")
        tol = SPARSE_GOLDEN_TOL[name]
        r = run(gd)
        if len(r.cost) != len(gd["cost"]) or not np.allclose(r.cost, gd["cost"], rtol=tol, atol=0):
            raise AssertionError(f"golden {name}: cost trace off")
        for f in fields:
            x = getattr(r, f)
            err = float(np.max(np.abs(x.cpu().numpy() - gd[f])))
            if x.device.type != "cuda" or not err <= tol:
                raise AssertionError(f"golden {name} {f}: {err:.3g} > {tol} on {x.device}")
            worst[name] = max(worst.get(name, 0.0), err)
    summary["goldens_f64_max_abs_err"] = worst
    say(f"phase 14 goldens on the card in f64, factors' max abs error (tolerance "
        f"{json.dumps(SPARSE_GOLDEN_TOL)}, costs at the same rtol): {json.dumps(worst)}")

    # h: f32 on the card (NumPy inputs, no device=) against f64 on the CPU
    ms_, ns_, ks_, Ts = SPARSE_SMALL
    rng = np.random.default_rng(45)
    H = rng.uniform(size=(ks_, ns_))
    ini = {"V": rng.uniform(0.05, 1.0, (ms_, ns_)), "Vc": rng.uniform(0.05, 1.0, (129, ns_)),
           "W": rng.uniform(size=(ms_, ks_)), "W3": rng.uniform(0.1, 1.0, (129, ks_, Ts)),
           "H": H / np.sqrt((H ** 2).sum(1, keepdims=True)),
           "Z": rng.uniform(0.1, 1.0, (129, ns_)) * np.exp(1j * rng.uniform(-np.pi, np.pi, (129, ns_)))}
    f32 = {key: x.astype(np.complex64 if np.iscomplexobj(x) else np.float32)
           for key, x in ini.items()}
    card_calls = sparse_small_calls(tt, f32)
    cpu_calls = sparse_small_calls(tt, ini, device="cpu")
    gaps, steps = {}, {}
    for name, call in card_calls.items():
        r32, r64 = call(), cpu_calls[name]()
        if r32.W.device.type != "cuda":
            raise AssertionError(f"{name}: NumPy input did not run on the card")
        c32, c64 = np.asarray(r32.cost, np.float64), np.asarray(r64.cost)
        if name == "cmfwisa":
            if len(c32) != len(c64):
                raise AssertionError(f"cmfwisa: {len(c32)} and {len(c64)} costs")
            gaps[name] = float(np.max(np.abs(c32 - c64) / np.abs(c64)))
            tol = F32_RTOL
        else:
            gaps[name] = float(abs(c32[-1] - c64[-1]) / abs(c64[-1]))
            tol = SPARSE_F32_RTOL
            steps[name] = bool(r32.n_iters == r64.n_iters and np.allclose(
                np.asarray(r32.resume_state["step_w"], np.float64),
                np.asarray(r64.resume_state["step_w"]), rtol=1e-5) and np.isclose(
                r32.resume_state["step_h"], r64.resume_state["step_h"], rtol=1e-5))
            if not (np.all(np.isfinite(c32)) and np.all(np.diff(c32) <= SPARSE_MONO * np.abs(c32[:-1]))):
                raise AssertionError(f"{name}: f32 trace not finite or not non-increasing")
        if not gaps[name] <= tol:
            raise AssertionError(f"{name}: f32 card {gaps[name]:.3g} from f64 CPU")
    summary["f32_vs_f64"] = gaps
    summary["f32_steps_agree"] = steps
    say(f"phase 14 f32 on the card vs f64 on the CPU, {ms_}x{ns_} r{ks_} (cnmfsc and cmfwisa "
        f"129x{ns_}, T{Ts}), {SMALL_ITERS} iterations: cmfwisa cost trace, nmfsc and cnmfsc "
        f"final cost {json.dumps(gaps)}; the same iterations and step sizes (rtol 1e-5): "
        f"{json.dumps(steps)}")
    say(f"phase 14 {json.dumps(summary)}")


def fused_counts(fk):
    return {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}


def zero_fused_counts(fk):
    fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0


def max_rel(a, b):
    """max |a - b| / max |b|, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def checkpoint_phase(torch, fk, V3, V_big, tmp):
    """Chunked runs against one call: fused KL (with a crash resume),
    extrapolated HALS and nmfsc, their launches and save times."""
    from nmf_toolbox_tpu_torch import nmf, nmf_hals, nmfsc
    from nmf_toolbox_tpu_torch.utils.checkpoint import run_checkpointed, save_factors
    summary = {}
    k = MAIN[2]
    kw = dict(divergence="kl", method="fused", tolerance=NEVER)
    total, chunk = CKPT_ITERS, CKPT_CHUNK
    nmf(V3, k, maxiter=2, **kw)  # warm-up
    one, one_ms = wall_ms(torch, lambda: nmf(V3, k, maxiter=total, **kw))
    zero_fused_counts(fk)
    res, ck_ms = wall_ms(torch, lambda: run_checkpointed(
        nmf, V3, k, total_iters=total, chunk=chunk, path=tmp / "fused.npz", **kw))
    counts = fused_counts(fk)
    if set(counts.values()) != {total}:
        raise AssertionError(f"the checkpointed fused run launched {counts}, not {total} each")
    if not (res.n_iters == total and torch.equal(res.W, one.W) and torch.equal(res.H, one.H)
            and np.array_equal(res.cost, one.cost)):
        gap = max(max_rel(res.W, one.W), max_rel(res.H, one.H))
        raise AssertionError(f"checkpointed fused KL: n_iters {res.n_iters}, factors "
                             f"{gap:.3g} from one call, not bit-identical")
    # A crash after half the iterations, then a fresh call on the file.
    run_checkpointed(nmf, V3, k, total_iters=total // 2, chunk=chunk,
                     path=tmp / "crash.npz", **kw)
    zero_fused_counts(fk)
    resumed = run_checkpointed(nmf, V3, k, total_iters=total, chunk=chunk,
                               path=tmp / "crash.npz", **kw)
    counts_resumed = fused_counts(fk)
    if not (torch.equal(resumed.W, one.W) and torch.equal(resumed.H, one.H)
            and np.array_equal(resumed.cost, one.cost)):
        raise AssertionError("the crash-resumed fused run differs from one call")
    if set(counts_resumed.values()) != {total - total // 2}:
        raise AssertionError(f"the resumed fused run launched {counts_resumed}")
    extra = {"iters_done": total, "cost_so_far": res.cost}
    save_factors(tmp / "save.npz", res, extra=extra)  # warm-up
    save_ms = [wall_ms(torch, lambda: save_factors(tmp / "save.npz", res, extra=extra))[1]
               for _ in range(3)]
    summary["fused_kl"] = {
        "ms_per_iter_one_call": one_ms / total, "ms_per_iter_chunked": ck_ms / total,
        "save_ms_per_chunk": float(np.median(save_ms)), "launches": counts}
    say(f"phase 15 run_checkpointed fused KL {MAIN[0]}x{MAIN[1]} r{k}, {total} iterations "
        f"in chunks of {chunk}: {ck_ms / total:.3f} ms/iter against {one_ms / total:.3f} in "
        f"one call; a save {np.median(save_ms):.2f} ms per chunk (W, H, cost); launches "
        f"{json.dumps(counts)}; W, H and costs bit-identical to one call; crash after "
        f"{total // 2} and resume from the file: bit-identical too, launches "
        f"{json.dumps(counts_resumed)}")

    # Extrapolated HALS: the momentum rides in resume_state, as tensors
    # between chunks and through the file after a crash.
    kg = GRAM[2]
    hk = dict(extrapolate=True, tolerance=NEVER, seed=3)
    one, one_ms = wall_ms(torch, lambda: nmf_hals(V_big, kg, maxiter=total, **hk))
    res, ck_ms = wall_ms(torch, lambda: run_checkpointed(
        nmf_hals, V_big, kg, total_iters=total, chunk=chunk, path=tmp / "hals.npz", **hk))
    run_checkpointed(nmf_hals, V_big, kg, total_iters=total // 2, chunk=chunk,
                     path=tmp / "hals_crash.npz", **hk)
    resumed = run_checkpointed(nmf_hals, V_big, kg, total_iters=total, chunk=chunk,
                               path=tmp / "hals_crash.npz", **hk)
    for name, r in (("chunked", res), ("crash-resumed", resumed)):
        if not (torch.equal(r.W, one.W) and torch.equal(r.H, one.H)
                and np.array_equal(r.cost, one.cost)):
            raise AssertionError(f"{name} extrapolated nmf_hals differs from one call")
    summary["hals_extrapolate"] = {"ms_per_iter_one_call": one_ms / total,
                                   "ms_per_iter_chunked": ck_ms / total}
    say(f"phase 15 run_checkpointed nmf_hals extrapolate {GRAM[0]}x{GRAM[1]} r{kg}: chunked "
        f"and crash-resumed bit-identical to one call; {ck_ms / total:.3f} ms/iter against "
        f"{one_ms / total:.3f} (each save writes W, H, Wy, Hy)")

    m, n, ks = SPARSE_BASE
    g = torch.Generator(device="cuda").manual_seed(15)
    Vs = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    sk = dict(H_sparsity=0.6, tolerance=NEVER, seed=4)
    one, one_ms = wall_ms(torch, lambda: nmfsc(Vs, ks, maxiter=total, **sk))
    res, ck_ms = wall_ms(torch, lambda: run_checkpointed(
        nmfsc, Vs, ks, total_iters=total, chunk=chunk, path=tmp / "nmfsc.npz", **sk))
    if not (torch.equal(res.W, one.W) and torch.equal(res.H, one.H)
            and np.array_equal(res.cost, one.cost)):
        raise AssertionError("chunked nmfsc differs from one call")
    summary["nmfsc"] = {"ms_per_iter_one_call": one_ms / total,
                        "ms_per_iter_chunked": ck_ms / total}
    say(f"phase 15 run_checkpointed nmfsc {m}x{n} r{ks} H_sparsity 0.6: chunked "
        f"bit-identical to one call (step sizes through resume_state); "
        f"{ck_ms / total:.3f} ms/iter against {one_ms / total:.3f}")
    return summary


def io_native_phase(torch, V_big, tmp):
    """The native library, load_matrix against np.load on phase 7's V as
    an .npy, and the native hull against the Python chain."""
    from nmf_toolbox_tpu_torch import native
    from nmf_toolbox_tpu_torch.utils import convex_hull_anchors, load_matrix, save_matrix
    if not native.available():
        raise AssertionError("the native library did not build")
    path = tmp / "V.npy"
    host = V_big.cpu().numpy()
    gb = host.nbytes / 1e9
    t0 = time.perf_counter()
    save_matrix(str(path), V_big)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_matrix(str(path))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np_loaded = np.load(path)
    np_s = time.perf_counter() - t0
    if not (np.array_equal(loaded, host) and np.array_equal(np_loaded, host)):
        raise AssertionError("load_matrix did not read back what save_matrix wrote")
    del loaded, np_loaded, host
    summary = {"gb": gb, "save_matrix_s": save_s, "load_matrix_gbps": gb / native_s,
               "np_load_gbps": gb / np_s}
    say(f"phase 15 io {V_big.shape[0]}x{V_big.shape[1]} f32 .npy ({gb:.2f} GB): save_matrix "
        f"{save_s:.2f} s from the card, load_matrix (native, 8 threads) {gb / native_s:.2f} "
        f"GB/s, np.load {gb / np_s:.2f} GB/s, both bit-equal (the file is in the page cache: "
        "memory bandwidth, not the disk's)")

    anchors, native_ms = wall_ms(torch, lambda: convex_hull_anchors(V_big, seed=0))
    saved = native._lib, native._tried
    native._lib, native._tried = None, True  # native.available() is now False
    try:
        python, python_ms = wall_ms(torch, lambda: convex_hull_anchors(V_big, seed=0))
    finally:
        native._lib, native._tried = saved
    if not torch.equal(anchors, python):
        raise AssertionError("the native and the Python hull chains chose other anchors")
    summary["convex_hull_anchors_s"] = {"native": native_ms / 1e3, "python": python_ms / 1e3,
                                        "pr8": HULL_PR8_S, "anchors": anchors.shape[1]}
    say(f"phase 15 convex_hull_anchors {V_big.shape[0]}x{V_big.shape[1]}: native chain "
        f"{native_ms / 1e3:.3f} s, Python chain {python_ms / 1e3:.3f} s (PR 8: "
        f"{HULL_PR8_S} s), the same {anchors.shape[1]} anchors")
    return summary, path


def cli_phase(torch, V_big, npy, tmp):
    """nmf through `python -m nmf_toolbox_tpu_torch` on phase 7's V with
    checkpoints, against one nmf call in process; the same command in
    process, timed by step."""
    import os
    from nmf_toolbox_tpu_torch import cli, nmf
    from nmf_toolbox_tpu_torch.utils import checkpoint, io
    k, total, chunk = GRAM[2], CKPT_ITERS, CKPT_CHUNK
    argv = ["nmf", str(npy), "--k", str(k), "--maxiter", str(total), "--tolerance",
            str(NEVER), "--checkpoint-every", str(chunk)]
    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nmf_toolbox_tpu_torch", *argv, "--out",
                           str(tmp / "cli.npz")], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(tmp / "cli.npz") as z:
        W, H = (torch.from_numpy(z[f]).cuda() for f in ("W", "H"))
        if int(z["extra__iters_done"]) != total or out["iterations"] != total:
            raise AssertionError(f"the CLI ran {out['iterations']} iterations")
    one = nmf(V_big, k, maxiter=total, tolerance=NEVER, seed=0)
    gap = max(max_rel(W, one.W), max_rel(H, one.H))
    bits = torch.equal(W, one.W) and torch.equal(H, one.H)
    if not gap <= CLI_RTOL:
        raise AssertionError(f"the CLI's factors are {gap:.3g} from one nmf call")

    # The same command in process, with the load, the saves and the solve
    # timed apart.
    spent = {"load": 0.0, "save": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t0
        return wrapper
    load, save = io.load_matrix, checkpoint.save_factors
    io.load_matrix, checkpoint.save_factors = timed(load, "load"), timed(save, "save")
    try:
        _, total_ms = wall_ms(torch, lambda: cli.main(argv + ["--out", str(tmp / "cli2.npz"),
                                                              "--quiet"]))
    finally:
        io.load_matrix, checkpoint.save_factors = load, save
    with np.load(tmp / "cli2.npz") as z:
        same = np.array_equal(z["W"], W.cpu().numpy()) and np.array_equal(z["H"], H.cpu().numpy())
    split = {"load_s": spent["load"], "save_s": spent["save"],
             "solve_s": total_ms / 1e3 - spent["load"] - spent["save"]}
    say(f"phase 15 CLI nmf {V_big.shape[0]}x{V_big.shape[1]} --k {k} --maxiter {total} "
        f"--checkpoint-every {chunk} (euclidean gram): python -m {wall_s:.2f} s wall with "
        f"its start; factors {gap:.3g} from one nmf call in process (bits equal: {bits}); "
        f"in process "
        f"{total_ms / 1e3:.2f} s: load {split['load_s']:.2f}, solve {split['solve_s']:.2f}, "
        f"save {split['save_s']:.2f} ({total // chunk} saves); the same factors as the "
        f"subprocess's: {same}")
    return {"module_wall_s": wall_s, "max_rel_vs_one_call": gap, "bits_vs_one_call": bits,
            **split}


def estimator_debug_phase(torch, fk, V3, tmp):
    """estimators.NMF with the fused kernels against nmf, and the debug
    helpers around a fused KL run."""
    import contextlib
    import io as _io
    from nmf_toolbox_tpu_torch import nmf
    from nmf_toolbox_tpu_torch.estimators import NMF
    from nmf_toolbox_tpu_torch.utils.debug import (check_finite, iteration_logger,
                                                   profile_to, trace)
    k = MAIN[2]
    kw = dict(divergence="kl", method="fused", tolerance=NEVER)
    ref = nmf(V3, k, maxiter=CKPT_ITERS, seed=0, **kw)
    est = NMF(n_components=k, divergence="kl", method="fused", max_iter=CKPT_ITERS,
              tol=NEVER, random_state=0)
    zero_fused_counts(fk)
    Ht, est_ms = wall_ms(torch, lambda: est.fit_transform(V3.T))
    counts = fused_counts(fk)
    if not (isinstance(Ht, np.ndarray) and isinstance(est.components_, np.ndarray)
            and np.array_equal(est.components_, ref.W.cpu().numpy().T)
            and np.array_equal(Ht, ref.H.cpu().numpy().T)
            and np.array_equal(est.cost_trace_, ref.cost)):
        raise AssertionError("the estimator's NumPy outputs differ from nmf's factors")
    if set(counts.values()) != {CKPT_ITERS}:
        raise AssertionError(f"the estimator launched {counts}")
    say(f"phase 15 estimators.NMF(n_components={k}, kl, fused, max_iter={CKPT_ITERS}) "
        f"fit_transform on X = V.T ({V3.shape[1]}x{V3.shape[0]}, NumPy): {est_ms:.1f} ms with "
        f"the copy to the card; components_ and the encoding equal nmf's W.T and H.T bit "
        f"for bit; launches {json.dumps(counts)}")

    Vd = torch.from_numpy(V3).cuda()
    logdir = tmp / "profile"
    with profile_to(str(logdir)):
        with trace("nmf"):
            res = nmf(Vd, k, maxiter=3, **kw)
        torch.cuda.synchronize()
    traces = list(logdir.glob("trace_*.json"))
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    found = {"phase_kernel": any("phase_kernel" in nm for nm in names),
             "cost_kernel": any("cost_kernel" in nm for nm in names),
             "nmf": "nmf" in names}
    if len(traces) != 1 or not all(found.values()):
        raise AssertionError(f"the profile trace lacks {found}")
    check_finite(res)
    bad = res.H.clone()
    bad[0, 0] = float("nan")
    res.H = bad
    try:
        check_finite(res)
    except FloatingPointError:
        pass
    else:
        raise AssertionError("check_finite passed a NaN")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        nmf(Vd, k, maxiter=3, callback=iteration_logger(), **kw)
    lines = buf.getvalue().splitlines()
    if len(lines) != 3 or not all(ln.startswith(f"iter {i + 1}: cost = ")
                                  for i, ln in enumerate(lines)):
        raise AssertionError(f"iteration_logger printed {lines}")
    say(f"phase 15 debug: profile_to wrote {traces[0].name} "
        f"({traces[0].stat().st_size / 1e6:.1f} MB) naming {json.dumps(found)}; check_finite "
        f"passed the run and raised on a NaN; iteration_logger printed {lines}")
    return {"estimator_ms": est_ms, "launches": counts}


def phase15_utilities_front_ends(torch, fk, V_big):
    """The checkpointed run, io and native, the CLI, the estimator and the
    debug helpers, on phase 3's V (40 000x10 000, rebuilt from its seed)
    and phase 7's V (100 000x10 000)."""
    import tempfile
    t0 = time.perf_counter()
    m, n, _ = MAIN
    V3 = np.random.default_rng(0).uniform(0.1, 1, (m, n)).astype(np.float32)  # phase 3's V
    summary = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = pathlib.Path(tmpdir)
        summary["checkpoint"] = checkpoint_phase(torch, fk, torch.from_numpy(V3).cuda(),
                                                 V_big, tmp)
        torch.cuda.empty_cache()
        summary["io_native"], npy = io_native_phase(torch, V_big, tmp)
        summary["cli"] = cli_phase(torch, V_big, npy, tmp)
        summary["estimator_debug"] = estimator_debug_phase(torch, fk, V3, tmp)
    summary["phase_s"] = time.perf_counter() - t0
    say(f"phase 15 {json.dumps(summary)}")


# ---------------------------------------------------------------------------
# Phase 16: mesh= on the one card (one NCCL rank; two Gloo ranks sharing it)
# ---------------------------------------------------------------------------

def mesh_inputs(torch, V_gram=None):
    """Phase 16's inputs, drawn on the card from seeds, so that every
    process draws the same: the fused runs' V (MAIN) and inits, phase 7's
    V (GRAM, redrawn unless given) and the gram inits, and at the gram
    shape a V of sparse rank-k factors plus noise with inits of the same
    sparsity scaled to its mean.  HALS runs on the latter: its factors
    are well determined there, while on phase 7's uniform V (or from
    dense inits, whose rows are near parallel) the order of a sum moves
    the factors far more than the objective."""
    g = torch.Generator(device="cuda").manual_seed(16)
    m, n, k = MAIN
    Vf = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    Wf, Hf = (torch.rand(s, generator=g, device="cuda") for s in ((m, k), (k, n)))
    m, n, k = GRAM
    if V_gram is None:
        g0 = torch.Generator(device="cuda").manual_seed(0)
        V_gram = 0.05 + 0.95 * torch.rand((m, n), generator=g0, device="cuda")
    Wg, Hg = (torch.rand(s, generator=g, device="cuda") for s in ((m, k), (k, n)))

    def sparse(shape):  # a tenth of the entries uniform, the rest 0
        x = torch.rand(shape, generator=g, device="cuda")
        return x.mul_(torch.rand(shape, generator=g, device="cuda") < 0.1)
    Vl = torch.rand((m, n), generator=g, device="cuda").mul_(0.01)
    Vl.addmm_(sparse((m, k)), sparse((k, n)))
    Wl, Hl = sparse((m, k)), sparse((k, n))
    scale = float(Vl.mean() / (Wl.mean(0) @ Hl.mean(1))) ** 0.5
    return Vf, Wf, Hf, V_gram, Wg, Hg, Vl, Wl.mul_(scale), Hl.mul_(scale)


def mesh_runs(inputs, iters, mesh):
    """The solves phase 16 runs with and without a mesh: name -> call."""
    from nmf_toolbox_tpu_torch import nmf, nmf_hals
    Vf, Wf, Hf, Vg, Wg, Hg, Vl, Wl, Hl = inputs
    one = dict(maxiter=iters, tolerance=NEVER, mesh=mesh)
    fused = dict(W_init=Wf, H_init=Hf, method="fused", **one)
    return {
        "nmf fused kl": lambda: nmf(Vf, MAIN[2], divergence="kl", **fused),
        "nmf fused is": lambda: nmf(Vf, MAIN[2], divergence="is", **fused),
        "nmf gram": lambda: nmf(Vg, GRAM[2], W_init=Wg, H_init=Hg, method="gram", **one),
        "nmf_hals": lambda: nmf_hals(Vl, GRAM[2], W_init=Wl, H_init=Hl, **one),
    }


def mesh_nndsvd(V_host, iters, mesh):
    """The SVD-seeded solves of the one-rank runs, V a host array as the
    CLI gives it: under a mesh the seeding runs on the card as without,
    on the whole V, and the placement takes each rank's block from the
    host."""
    from nmf_toolbox_tpu_torch import nmf, nmf_hals
    one = dict(maxiter=iters, tolerance=NEVER, mesh=mesh)
    return {
        "nmf gram nndsvd": lambda: nmf(V_host, GRAM[2], init="nndsvd", method="gram", **one),
        "nmf_hals nndsvda": lambda: nmf_hals(V_host, GRAM[2], init="nndsvda", **one),
    }


def engine_inputs(torch):
    """Phase 9's batch, its inits and problem 0's normalized bases."""
    B, m, n, k = SERVING
    rng, bases, Vs = serving_batch(torch)
    W0, H0 = (torch.from_numpy(rng.uniform(size=s).astype(np.float32)).cuda()
              for s in ((B, m, k), (B, k, n)))
    Wd = torch.from_numpy(bases[0] / np.sqrt((bases[0] ** 2).sum(0))).cuda()
    return Vs, W0, H0, Wd


def mesh_engines(batch, mesh):
    """``nmf_batched`` euclidean and ``nmf_encode`` KL on phase 9's batch,
    ENGINE_ITERS iterations, with or without a mesh."""
    from nmf_toolbox_tpu_torch import nmf_batched, nmf_encode
    Vs, W0, H0, Wd = batch
    k = SERVING[3]
    return {
        "nmf_batched euclidean": lambda: nmf_batched(Vs, k, W_init=W0, H_init=H0,
                                                     maxiter=ENGINE_ITERS, mesh=mesh),
        "nmf_encode kl": lambda: nmf_encode(Vs, Wd, H_init=H0, divergence="kl",
                                            maxiter=ENGINE_ITERS, mesh=mesh),
    }


def same_result(torch, a, b):
    return (torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
            and np.array_equal(a.cost, b.cost) and a.n_iters == b.n_iters)


def mesh_rank(rank, tmp, queue):
    """One of phase 16's two Gloo ranks sharing the card: the mesh runs of
    MESH_RANK_ITERS iterations, the engines on the batch split in two and
    the orbax-checkpointed fused run; the results go to ``tmp`` and the
    numbers to ``queue``."""
    import faulthandler
    import traceback
    faulthandler.dump_traceback_later(MESH_TIMEOUT - 30)  # where a hang waits
    say(f"phase 16 rank {rank}: started")
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        from nmf_toolbox_tpu_torch import nmf
        from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
        from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
        from nmf_toolbox_tpu_torch.parallel import collectives, init_distributed, make_mesh
        from nmf_toolbox_tpu_torch.utils import run_checkpointed, save_factors_orbax
        init_distributed(f"file://{tmp}/rendezvous2", 2, rank, backend="gloo",
                         timeout=MESH_TIMEOUT)
        say(f"phase 16 rank {rank}: joined")
        mesh = make_mesh(2)
        say(f"phase 16 rank {rank}: {mesh}")
        out, saved = {"rank": rank}, {}
        inputs = mesh_inputs(torch)
        runs = dict(mesh_runs(inputs, MESH_RANK_ITERS, mesh),
                    **mesh_engines(engine_inputs(torch), mesh))
        zero_fused_counts(fk)
        dk.kl_phi_dot_ht_dma_launches = 0
        for name, run in runs.items():
            say(f"phase 16 rank {rank}: {name}")
            run()  # warm-up
            torch.cuda.reset_peak_memory_stats()
            calls = collectives.calls
            res, ms = wall_ms(torch, run)
            iters = res.n_iters if name.startswith(("nmf ", "nmf_hals")) else 1
            unit = "iter" if iters > 1 else "call"
            out[name] = {f"ms_per_{unit}": ms / iters,
                         f"collectives_per_{unit}": (collectives.calls - calls) / iters,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            saved[name] = {f: getattr(res, f).cpu() for f in ("W", "H")}
            saved[name]["cost"] = np.asarray(res.cost)
        out["launches"] = dict(fused_counts(fk), **{DMA[0]: dk.kl_phi_dot_ht_dma_launches})
        # orbax checkpoints of the fused KL run, every rank writing its blocks
        say(f"phase 16 rank {rank}: run_checkpointed")
        Vf, Wf, Hf = inputs[:3]
        del inputs, runs
        kw = dict(W_init=Wf, H_init=Hf, method="fused", divergence="kl",
                  tolerance=NEVER, mesh=mesh)
        total, chunk, k = CKPT_ITERS, CKPT_CHUNK, MAIN[2]
        one, one_ms = wall_ms(torch, lambda: nmf(Vf, k, maxiter=total, **kw))
        res, ck_ms = wall_ms(torch, lambda: run_checkpointed(
            nmf, Vf, k, total_iters=total, chunk=chunk, path=f"{tmp}/ck", backend="orbax", **kw))
        run_checkpointed(nmf, Vf, k, total_iters=total // 2, chunk=chunk,
                         path=f"{tmp}/crash", backend="orbax", **kw)
        resumed = run_checkpointed(nmf, Vf, k, total_iters=total, chunk=chunk,
                                   path=f"{tmp}/crash", backend="orbax", **kw)
        save_ms = [wall_ms(torch, lambda: save_factors_orbax(
            f"{tmp}/save", one, mesh=mesh, solver="nmf"))[1] for _ in range(3)]
        out["checkpoint"] = {
            "chunked_identical": bool(same_result(torch, res, one)),
            "resumed_identical": bool(same_result(torch, resumed, one)),
            "ms_per_iter_one_call": one_ms / total, "ms_per_iter_chunked": ck_ms / total,
            "save_ms": float(np.median(save_ms[1:]))}
        torch.save(saved, f"{tmp}/rank{rank}.pt")
        torch.distributed.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, {"error": traceback.format_exc()}))


def check_mesh_launches(launches, who):
    """Phase 16's runs launch each fused kernel and never the dma one."""
    if min(launches[name] for name, _ in KERNELS) == 0 or launches[DMA[0]]:
        raise AssertionError(f"phase 16 {who}: launches {launches}: every fused "
                             f"kernel above 0 and {DMA[0]} at 0 expected")


def rank_entry(target, rank, tmp, queue):
    """A spawned rank: ``LOCAL_RANK`` set to ``rank`` and, with a card,
    pinned to the card ``parallel.mesh.local_card`` names (the rule that
    ``init_distributed`` and ``make_mesh`` follow), then
    ``target(rank, tmp, queue)``."""
    import os
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    if torch.cuda.is_available():
        from nmf_toolbox_tpu_torch.parallel.mesh import local_card
        torch.cuda.set_device(local_card(rank))
    target(rank, tmp, queue)


def spawn_ranks(target, tmp, n=2, timeout=MESH_TIMEOUT):
    """{rank: what it put on the queue} from ``target(rank, tmp, queue)``
    run in ``n`` spawned processes (:func:`rank_entry`), each waited for
    up to ``timeout`` seconds; once a rank reports an error the others
    get ERROR_GRACE seconds, and a rank that gave no answer is reported
    as an error.  Each rank is joined (killed past its wait), the queue
    closed and freed, and the resource tracker that spawning starts
    stopped unless other children of this process still use it, so that
    no process outlives the phase."""
    import gc
    import multiprocessing
    import os
    import queue as queues
    from multiprocessing import resource_tracker
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_entry, args=(target, r, tmp, queue)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        got = {}
        while len(got) < n:
            failed = any("error" in v for v in got.values())
            try:
                rank, value = queue.get(timeout=ERROR_GRACE if failed else timeout)
            except queues.Empty:
                if not failed:
                    raise TimeoutError(f"{n - len(got)} rank(s) gave no answer in "
                                       f"{timeout} s") from None
                for r in range(n):
                    got.setdefault(r, {"error": "no answer after another rank failed"})
                break
            got[rank] = value
        return got
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
            p.close()
        queue.close()
        queue.join_thread()
        del queue, procs
        gc.collect()  # the queue's semaphores unregister while the tracker runs
        tracker = resource_tracker._resource_tracker
        if multiprocessing.active_children():
            pass  # other children of this process hold the tracker open
        elif hasattr(tracker, "_stop"):
            tracker._stop()
        elif getattr(tracker, "_pid", None) is not None:
            os.close(tracker._fd)  # its end of file stops the tracker
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def stop_children():
    """Stop and reap every child process still there at the end (none is
    expected), naming each on stderr."""
    import os
    import signal
    me = str(os.getpid())
    kids = {}
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if fields[1] == me:
                cmd = (stat.parent / "cmdline").read_bytes().replace(b"\0", b" ")
                kids[int(stat.parent.name)] = (fields[0], cmd.decode(errors="replace")[:200])
        except (OSError, IndexError):
            continue
    for pid, (state, cmd) in kids.items():
        print(f"chip_smoke: stopping child {pid} ({state}) {cmd}", file=sys.stderr)
        for sig in (signal.SIGTERM, signal.SIGKILL):
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                break
            for _ in range(50):
                try:
                    if os.waitpid(pid, os.WNOHANG)[0]:
                        break
                except ChildProcessError:
                    break
                time.sleep(0.1)
            else:
                continue
            break


def phase16_mesh(torch, fk, V_gram):
    """mesh= on the card: one NCCL rank bit-identical to no mesh, then two
    Gloo ranks sharing the card, identical to each other and within
    MESH_RTOL of one rank, with orbax checkpoints across them."""
    import tempfile
    import torch.distributed as dist
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
    from nmf_toolbox_tpu_torch.parallel import collectives, init_distributed, make_mesh
    t0 = time.perf_counter()
    summary = {"one_rank_nccl": {}, "two_ranks_gloo": {}}
    inputs, batch = mesh_inputs(torch, V_gram), engine_inputs(torch)
    V_host = inputs[6].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, backend="nccl",
                         timeout=MESH_TIMEOUT)
        mesh = make_mesh(1)
        plain = dict(mesh_runs(inputs, ITERS, None), **mesh_nndsvd(V_host, ITERS, None),
                     **mesh_engines(batch, None))
        meshed = dict(mesh_runs(inputs, ITERS, mesh), **mesh_nndsvd(V_host, ITERS, mesh),
                      **mesh_engines(batch, mesh))
        zero_fused_counts(fk)
        dk.kl_phi_dot_ht_dma_launches = 0
        for name in plain:
            plain[name]()  # warm-ups (the first collective starts NCCL)
            meshed[name]()
            a, ms_a = wall_ms(torch, plain[name])
            calls = collectives.calls
            b, ms_b = wall_ms(torch, meshed[name])
            per = a.n_iters if name.startswith(("nmf ", "nmf_hals")) else 1
            if not same_result(torch, a, b):
                raise AssertionError(f"phase 16 {name}: a one-rank NCCL mesh is not "
                                     "bit-identical to no mesh")
            unit = "iter" if per > 1 else "call"
            summary["one_rank_nccl"][name] = {"ms_no_mesh": ms_a / per, "ms_mesh": ms_b / per,
                                              f"collectives_per_{unit}":
                                              (collectives.calls - calls) / per}
            say(f"phase 16 one NCCL rank, {name}: bit-identical to no mesh; {ms_b / per:.3f} "
                f"ms per {unit} against {ms_a / per:.3f} without; "
                f"{(collectives.calls - calls) / per:g} collectives per {unit}")
        launches = dict(fused_counts(fk), **{DMA[0]: dk.kl_phi_dot_ht_dma_launches})
        say(f"phase 16 one NCCL rank, kernel launches: {json.dumps(launches)}")
        check_mesh_launches(launches, "one NCCL rank")
        dist.destroy_process_group()
        del plain, meshed, V_host
        torch.cuda.empty_cache()

        # The single-rank references of the two-rank runs.
        refs = {}
        for name, run in dict(mesh_runs(inputs, MESH_RANK_ITERS, None),
                              **mesh_engines(batch, None)).items():
            res = run()
            refs[name] = {"W": res.W, "H": res.H, "cost": np.asarray(res.cost)}
        del inputs, batch
        torch.cuda.empty_cache()
        got = spawn_ranks(mesh_rank, tmp)
        for r in (0, 1):
            if "error" in got[r]:
                raise AssertionError(f"phase 16 rank {r} failed:\n{got[r]['error']}")
        saved = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in (0, 1)]
    for name, ref in refs.items():
        a, b = saved
        if not all(torch.equal(a[name][f], b[name][f]) for f in ("W", "H")) or \
                not np.array_equal(a[name]["cost"], b[name]["cost"]):
            raise AssertionError(f"phase 16 {name}: the two ranks differ")
        gap = {f: max_rel(a[name][f], ref[f].cpu()) for f in ("W", "H")}
        gap["cost"] = float(np.max(np.abs(a[name]["cost"] / ref["cost"] - 1)))
        row = {"rank_identical": True, "vs_one_rank": gap,
               "ranks": [got[r][name] for r in (0, 1)]}
        summary["two_ranks_gloo"][name] = row
        say(f"phase 16 two Gloo ranks, {name}: ranks bit-identical; from one rank "
            f"W {gap['W']:.3g}, H {gap['H']:.3g}, cost {gap['cost']:.3g} relative; "
            f"{json.dumps(row['ranks'])}")
        if max(gap.values()) > MESH_RTOL:
            raise AssertionError(f"phase 16 {name}: two ranks are {gap} from one rank, "
                                 f"beyond {MESH_RTOL}")
    for r in (0, 1):
        check_mesh_launches(got[r]["launches"], f"rank {r}")
        ck = got[r]["checkpoint"]
        if not (ck["chunked_identical"] and ck["resumed_identical"]):
            raise AssertionError(f"phase 16 rank {r}: the orbax-checkpointed run is not "
                                 f"bit-identical to one meshed call: {ck}")
    summary["two_ranks_gloo"]["launches"] = [got[r]["launches"] for r in (0, 1)]
    summary["two_ranks_gloo"]["checkpoint"] = [got[r]["checkpoint"] for r in (0, 1)]
    say(f"phase 16 two Gloo ranks, kernel launches per rank: "
        f"{json.dumps(summary['two_ranks_gloo']['launches'])}")
    say(f"phase 16 two Gloo ranks, run_checkpointed fused KL backend='orbax', "
        f"{CKPT_ITERS} iterations in chunks of {CKPT_CHUNK}, straight and crash-resumed: "
        f"bit-identical to one meshed call; {json.dumps(summary['two_ranks_gloo']['checkpoint'])}")
    summary["phase_s"] = time.perf_counter() - t0
    say(f"phase 16 {json.dumps(summary)}")


# ---------------------------------------------------------------------------
# Phase 17: mesh= for the rest of the solvers
# ---------------------------------------------------------------------------

def solver_inputs(torch, V_gram=None):
    """Phase 17's one-rank inputs, drawn on the card from seeds: phase 7's
    V (GRAM, redrawn unless given) with the Gram/MU family's inits, the
    planted similarity of phase 12, the convolutive V and inits of phase
    13, nmfsc's V of phase 14 and cmfwisa's complex V."""
    g = torch.Generator(device="cuda").manual_seed(170)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")  # noqa: E731
    m, n, k = GRAM
    if V_gram is None:
        g0 = torch.Generator(device="cuda").manual_seed(0)
        V_gram = 0.05 + 0.95 * torch.rand((m, n), generator=g0, device="cuda")
    ini = {key: torch.from_numpy(x).cuda() if isinstance(x, np.ndarray) and x.dtype == np.float32
           else x for key, x in family_inits(np.random.default_rng(12), m, n, k).items()}
    A = torch.from_numpy(planted_similarity(np.random.default_rng(13), *SYM)[0]).cuda()
    mc, nc, kc, T = CONV
    p = CHCNMF[2]
    ms, ns, ks = SPARSE_BASE
    mx, nx, kx = CMF
    Vx = torch.polar(0.1 + 0.9 * rand(mx, nx), 6.283 * rand(mx, nx))
    return {"V": V_gram, "ini": ini, "A": A, "HA": 0.05 * rand(SYM[0], SYM[1]),
            "Vc": 0.05 + 0.95 * rand(mc, nc), "Wc": rand(mc, kc, T), "Hc": rand(kc, nc),
            "H3": rand(kc, nc, CONV_P), "Gch": rand(p, CHCNMF[0], CHCNMF[1]),
            "Vs": 0.1 + 0.9 * rand(ms, ns), "Ws": rand(ms, ks), "Hs": rand(ks, ns),
            "Vx": Vx, "Wx": rand(mx, kx), "Hx": rand(kx, nx)}


def solver_runs(x, iters, mesh):
    """The solves of phase 17's one NCCL rank, with or without a mesh:
    name -> call().  Every input is a tensor on the card, so both runs
    stage, normalize and draw on the card alike."""
    import nmf_toolbox_tpu_torch as tt
    one = dict(maxiter=iters, tolerance=NEVER, mesh=mesh)
    V, ini = x["V"], x["ini"]
    m, n, k = GRAM
    mc, nc, kc, T = CONV
    runs = {f"{name} {m}x{n} r{k}": (lambda c=c: c()) for name, c in
            family_calls(tt, V, k, ini, iters, mesh=mesh).items()}
    runs.update({
        f"symnmf n={SYM[0]} r{SYM[1]}": lambda: tt.symnmf(x["A"], SYM[1], H_init=x["HA"], **one),
        f"cnmf euclidean gram {mc}x{nc} r{kc} T{T}": lambda: tt.cnmf(
            x["Vc"], kc, T, W_init=x["Wc"], H_init=x["Hc"], method="gram", **one),
        f"cnmf kl {mc}x{nc} r{kc} T{T}": lambda: tt.cnmf(
            x["Vc"], kc, T, W_init=x["Wc"], H_init=x["Hc"], divergence="kl", **one),
        f"nmf2d kl {mc}x{nc} r{kc} T{T} P{CONV_P}": lambda: tt.nmf2d(
            x["Vc"], kc, T, CONV_P, W_init=x["Wc"], H_init=x["H3"], divergence="kl", **one),
        f"chcnmf {m}x{n} r{CHCNMF[0]} T{CHCNMF[1]} p{CHCNMF[2]}": lambda: tt.chcnmf(
            V, CHCNMF[0], CHCNMF[1], S_init=V[:, :CHCNMF[2]], G_init=x["Gch"],
            H_init=ini["H"], **one),
        f"nmfsc H_sparsity 0.6 {'x'.join(map(str, SPARSE_BASE[:2]))} r{SPARSE_BASE[2]}":
            lambda: tt.nmfsc(x["Vs"], SPARSE_BASE[2], W_init=x["Ws"], H_init=x["Hs"],
                             H_sparsity=0.6, **one),
        f"cnmfsc H_sparsity 0.5 {mc}x{nc} r{kc} T{T}": lambda: tt.cnmfsc(
            x["Vc"], kc, T, W_init=x["Wc"], H_init=x["Hc"], H_sparsity=0.5, **one),
        f"cmfwisa complex64 {'x'.join(map(str, CMF[:2]))} r{CMF[2]}": lambda: tt.cmfwisa(
            x["Vx"], CMF[2], W_init=x["Wx"], H_init=x["Hx"], **one),
    })
    return runs


def result_equal(torch, a, b):
    """Every field of two Results bit-identical, and the same n_iters."""
    def same(u, v):
        if isinstance(u, (list, tuple)):
            return len(u) == len(v) and all(same(p, q) for p, q in zip(u, v))
        if torch.is_tensor(u):
            return torch.equal(u, v)
        return np.array_equal(np.asarray(u), np.asarray(v))
    return a.n_iters == b.n_iters and all(same(getattr(a, f), getattr(b, f)) for f in a.fields)


def rank_inputs(torch, V_gram=None):
    """The two Gloo ranks' inputs, drawn on the card from seeds in every
    process: the convolutive V of phase 13 with inits, phase 7's V for
    chcnmf, nmfsc's V of phase 14 and constrainednmf on it with 40 %
    unlabeled columns (so both halves hold labeled ones), a planted
    similarity of odd n (symnmf pads it), cmfwisa's complex V and the
    streamed V, host copies; phase 7's V redrawn unless given."""
    g = torch.Generator(device="cuda").manual_seed(171)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")  # noqa: E731
    x = solver_inputs(torch, V_gram)
    ms, ns, ks = SPARSE_BASE
    labels = np.random.default_rng(17).integers(0, LABEL_CLASSES, ns)
    labels[np.random.default_rng(18).permutation(ns)[: 2 * ns // 5]] = -1
    truth = np.arange(SYM17[0]) * SYM17[1] // SYM17[0]
    A = (truth[:, None] == truth[None, :]) * 0.9 + 0.05 \
        + 0.05 * np.random.default_rng(19).uniform(size=(SYM17[0],) * 2)
    mt, nt, kt = STREAM17
    x.update(labels=labels, Z=rand(ks, int(np.sum(labels < 0)) + LABEL_CLASSES),
             A17=torch.from_numpy((A + A.T).astype(np.float32) / 2).cuda(),
             HA17=0.05 * rand(SYM17[0], SYM17[1]),
             Vt=(0.05 + 0.95 * rand(mt, nt)).cpu().numpy(), Wt=rand(mt, kt))
    return x


def rank_runs(x, iters, mesh):
    """The solves phase 17 runs on two ranks and on one: name -> call().
    nmfsc and cnmfsc run in f64: their line searches accept a trial when
    a summed objective does not increase, and in f32 the order of the
    sums (one rank's or two) can flip such a decision near a tie and send
    the runs apart; in f64 the decisions agree and the results hold to
    1e-9."""
    import torch
    import nmf_toolbox_tpu_torch as tt
    one = dict(maxiter=iters, tolerance=NEVER, mesh=mesh)
    f64 = dict(one, dtype=torch.float64)
    mc, nc, kc, T = CONV
    ms, ns, ks = SPARSE_BASE
    m, n, k = GRAM
    mt, nt, kt = STREAM17
    return {
        f"cnmf euclidean gram {mc}x{nc} r{kc} T{T}": lambda: tt.cnmf(
            x["Vc"], kc, T, W_init=x["Wc"], H_init=x["Hc"], method="gram", **one),
        f"nmf2d kl {mc}x{nc} r{kc} T{T} P{CONV_P}": lambda: tt.nmf2d(
            x["Vc"], kc, T, CONV_P, W_init=x["Wc"], H_init=x["H3"], divergence="kl", **one),
        f"chcnmf {m}x{n} r{CHCNMF[0]} T{CHCNMF[1]} p{CHCNMF[2]}": lambda: tt.chcnmf(
            x["V"], CHCNMF[0], CHCNMF[1], S_init=x["V"][:, :CHCNMF[2]], G_init=x["Gch"],
            H_init=x["ini"]["H"], **one),
        f"cnmfsc H_sparsity 0.5 {mc}x{nc} r{kc} T{T} f64": lambda: tt.cnmfsc(
            x["Vc"], kc, T, W_init=x["Wc"], H_init=x["Hc"], H_sparsity=0.5, **f64),
        f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {ms}x{ns} r{ks} f64": lambda: tt.nmfsc(
            x["Vs"], ks, W_init=x["Ws"], H_init=x["Hs"], W_sparsity=0.5, H_sparsity=0.6, **f64),
        f"constrainednmf kl {ms}x{ns} r{ks}": lambda: tt.constrainednmf(
            x["Vs"], x["labels"], ks, W_init=x["Ws"], Z_init=x["Z"], divergence="kl", **one),
        f"symnmf n={SYM17[0]} r{SYM17[1]}": lambda: tt.symnmf(
            x["A17"], SYM17[1], H_init=x["HA17"], **one),
        f"cmfwisa complex64 {'x'.join(map(str, CMF[:2]))} r{CMF[2]}": lambda: tt.cmfwisa(
            x["Vx"], CMF[2], W_init=x["Wx"], H_init=x["Hx"], **one),
        f"nmf_streaming one epoch {mt}x{nt} r{kt} from the host": lambda: tt.nmf_streaming(
            x["Vt"], kt, W_init=x["Wt"], epochs=1, block_size=STREAM_BLOCK, return_H=True,
            mesh=mesh),
    }


def mesh17_rank(rank, tmp, queue):
    """One of phase 17's two Gloo ranks sharing the card: rank_runs on a
    mesh of two, the results to ``tmp`` and the numbers to ``queue``."""
    import faulthandler
    import traceback
    faulthandler.dump_traceback_later(MESH_TIMEOUT - 30)
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
        from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
        from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk
        from nmf_toolbox_tpu_torch.parallel import collectives, init_distributed, make_mesh
        init_distributed(f"file://{tmp}/rendezvous17", 2, rank, backend="gloo",
                         timeout=MESH_TIMEOUT)
        mesh = make_mesh(2)
        out, saved = {"rank": rank}, {}
        zero_fused_counts(fk)
        dk.kl_phi_dot_ht_dma_launches = 0
        zero_naive_kl_counts(nk)
        for name, run in rank_runs(rank_inputs(torch), MESH_RANK_ITERS, mesh).items():
            calls = collectives.calls
            res, ms = wall_ms(torch, run)
            out[name] = {"ms": ms, "collectives": collectives.calls - calls}
            saved[name] = factors(torch, res)
        out["launches"] = dict(fused_counts(fk), **{DMA[0]: dk.kl_phi_dot_ht_dma_launches},
                               **naive_kl_counts(nk))
        torch.save(saved, f"{tmp}/rank17_{rank}.pt")
        torch.distributed.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, {"error": traceback.format_exc()}))


def factors(torch, res):
    """A Result's W and H (those it has) on the host as tensors, and its
    cost trace."""
    out = {f: (x.cpu() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x)))
           for f in ("W", "H") if (x := getattr(res, f)) is not None}
    out["cost"] = np.asarray(res.cost)
    return out


def host_v_runs(torch, x, V_host, mesh):
    """Phase 17's one NCCL rank from a host V, as the CLI passes one:
    convexnmf and chnmf with their default inits, bit-identical to no
    mesh, with the k-means and the hull search reading V on the card;
    and convexnmf with injected inits, whose rows of V'V the mesh run
    forms from the host V in column chunks (convexnmf.row_gram), held
    within MESH_RTOL of no mesh (the chunks' products may sum in
    another order than the whole product's)."""
    import importlib
    import nmf_toolbox_tpu_torch as tt
    m, n, k = GRAM
    seen, patched = [], []
    for mod, fn in (("convexnmf", "kmeans_indicator_h"), ("chnmf", "convex_hull_anchors")):
        module = importlib.import_module(f"nmf_toolbox_tpu_torch.models.{mod}")
        orig = getattr(module, fn)

        def spy(*args, orig=orig, fn=fn, **kwargs):
            seen.append((fn, next(a for a in args if torch.is_tensor(a)).device.type))
            return orig(*args, **kwargs)
        setattr(module, fn, spy)
        patched.append((module, fn, orig))
    one = dict(maxiter=MESH_RANK_ITERS, tolerance=NEVER, seed=3)
    runs = {
        f"convexnmf {m}x{n} r{k} default inits (k-means)":
            lambda msh: tt.convexnmf(V_host, k, mesh=msh, **one),
        f"chnmf {m}x{n} r{k} default inits (hull)":
            lambda msh: tt.chnmf(V_host, k, mesh=msh, **one),
        f"convexnmf {m}x{n} r{k} injected inits (chunked row Gram)":
            lambda msh: tt.convexnmf(V_host, k, G_init=x["ini"]["G"], H_init=x["ini"]["H"],
                                     mesh=msh, **one),
    }
    out = {}
    try:
        for name, run in runs.items():
            del seen[:]
            a, ms_a = wall_ms(torch, lambda: run(None))
            b, ms_b = wall_ms(torch, lambda: run(mesh))
            same = result_equal(torch, a, b)
            gap = {f: max_rel(getattr(b, f), getattr(a, f)) for f in ("W", "H")}
            gap["cost"] = float(np.max(np.abs(np.asarray(b.cost) / np.asarray(a.cost) - 1)))
            row = {"bit_identical": same, "vs_no_mesh": gap, "init_devices": sorted(set(seen)),
                   "s_no_mesh": ms_a / 1e3, "s_mesh": ms_b / 1e3}
            out[name] = row
            say(f"phase 17 one NCCL rank from a host V, {name}: {json.dumps(row)}")
            if "default" in name and not (same and seen and
                                          all(dev == "cuda" for _, dev in seen)):
                raise AssertionError(f"phase 17 {name}: not bit-identical to no mesh, or "
                                     f"the init read V off the card: {row}")
            if not max(gap.values()) <= MESH_RTOL or a.n_iters != b.n_iters:
                raise AssertionError(f"phase 17 {name}: {gap} from no mesh, beyond {MESH_RTOL}")
    finally:
        for module, fn, orig in patched:
            setattr(module, fn, orig)
    return out


def phase17_mesh_solvers(torch, fk, V_gram):
    """mesh= for the solvers this slice ports: one NCCL rank bit-identical
    to no mesh at the shapes of phases 12-14 (timed in turns), two Gloo
    ranks sharing the card identical to each other and within MESH_RTOL
    (f64 solvers: 1e-9) of one rank, and no fused kernel launched."""
    import tempfile
    import torch.distributed as dist
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
    from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk
    from nmf_toolbox_tpu_torch.parallel import collectives, init_distributed, make_mesh
    t0 = time.perf_counter()
    zero_fused_counts(fk)
    dk.kl_phi_dot_ht_dma_launches = 0
    zero_naive_kl_counts(nk)
    summary = {"one_rank_nccl": {}, "two_ranks_gloo": {}}
    x = solver_inputs(torch, V_gram)
    V_host = V_gram.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, backend="nccl", timeout=MESH_TIMEOUT)
        mesh = make_mesh(1)
        stream = f"nmf_streaming one epoch {GRAM[0]}x{GRAM[1]} r{GRAM[2]} from the host"
        plain, meshed = (dict(solver_runs(x, MESH_RANK_ITERS, msh), **{
            stream: lambda msh=msh: tt.nmf_streaming(
                V_host, GRAM[2], W_init=x["ini"]["W"], epochs=1, block_size=STREAM_BLOCK,
                mesh=msh)}) for msh in (None, mesh))
        for name in plain:
            plain[name]()  # warm-ups
            meshed[name]()
            # in turns (no mesh, mesh, mesh, no mesh): each time the mean of two
            a, ms_a = wall_ms(torch, plain[name])
            calls = collectives.calls
            b, ms_b = wall_ms(torch, meshed[name])
            calls = collectives.calls - calls
            ms_b += wall_ms(torch, meshed[name])[1]
            ms_a += wall_ms(torch, plain[name])[1]
            if not result_equal(torch, a, b):
                raise AssertionError(f"phase 17 {name}: a one-rank NCCL mesh is not "
                                     "bit-identical to no mesh")
            per = 2 * max(a.n_iters, 1)
            row = {"ms_per_iter_no_mesh": ms_a / per, "ms_per_iter_mesh": ms_b / per,
                   "collectives_per_iter": 2 * calls / per, "n_iters": a.n_iters}
            summary["one_rank_nccl"][name] = row
            say(f"phase 17 one NCCL rank, {name}: bit-identical to no mesh; "
                f"{row['ms_per_iter_mesh']:.3f} ms/iter against {row['ms_per_iter_no_mesh']:.3f} "
                f"without (two calls of {a.n_iters} iterations each, in turns, one-time work "
                f"included); {row['collectives_per_iter']:g} collectives per iteration")
        summary["one_rank_nccl_host_v"] = host_v_runs(torch, x, V_host, mesh)
        dist.destroy_process_group()
        del plain, meshed, x, V_host
        torch.cuda.empty_cache()

        # The single-rank references of the two-rank runs.
        refs = {}
        for name, run in rank_runs(rank_inputs(torch), MESH_RANK_ITERS, None).items():
            refs[name] = factors(torch, run())
        torch.cuda.empty_cache()
        got = spawn_ranks(mesh17_rank, tmp)
        for r in (0, 1):
            if "error" in got[r]:
                raise AssertionError(f"phase 17 rank {r} failed:\n{got[r]['error']}")
        saved = [torch.load(f"{tmp}/rank17_{r}.pt", weights_only=False) for r in (0, 1)]
    for name, ref in refs.items():
        a, b = (sv[name] for sv in saved)
        fields = [f for f in ("W", "H") if f in ref]
        if not all(torch.equal(a[f], b[f]) for f in fields) or \
                not np.array_equal(a["cost"], b["cost"]):
            raise AssertionError(f"phase 17 {name}: the two ranks differ")
        gap = {f: max_rel(a[f], ref[f]) for f in fields}
        gap["cost"] = (float(np.max(np.abs(a["cost"] / ref["cost"] - 1)))
                       if a["cost"].shape == ref["cost"].shape else float("inf"))
        tol = MESH_RTOL_F64 if name.endswith("f64") else MESH_RTOL
        row = {"rank_identical": True, "vs_one_rank": gap, "rtol": tol,
               "ranks": [got[r][name] for r in (0, 1)]}
        summary["two_ranks_gloo"][name] = row
        say(f"phase 17 two Gloo ranks, {name}: ranks bit-identical; from one rank "
            f"{', '.join(f'{f} {v:.3g}' for f, v in gap.items())} relative "
            f"(allowed {tol:g}); {json.dumps(row['ranks'])}")
        if not max(gap.values()) <= tol:
            raise AssertionError(f"phase 17 {name}: two ranks are {gap} from one rank, "
                                 f"beyond {tol}")
    launches = dict(fused_counts(fk), **{DMA[0]: dk.kl_phi_dot_ht_dma_launches},
                    **naive_kl_counts(nk))
    ranks_launches = [got[r]["launches"] for r in (0, 1)]
    summary["launches"] = {"one_rank": launches, "two_ranks": ranks_launches}
    say(f"phase 17 kernel launches: one rank {json.dumps(launches)}, two ranks "
        f"{json.dumps(ranks_launches)}")
    if any(launches.values()) or any(v for rl in ranks_launches for v in rl.values()):
        raise AssertionError(f"phase 17 launched a kernel: {summary['launches']}")
    summary["phase_s"] = time.perf_counter() - t0
    say(f"phase 17 wall time {summary['phase_s']:.1f} s")
    say(f"phase 17 {json.dumps(summary)}")


def hoyer_input(torch, shape, transposed, dtype, seed):
    """A projection input like a line-search trial's: a sparse non-negative
    factor minus a gradient step (rand**4 minus normal noise), generated
    on the card in f64; W's columns come as rows of a strided W.mT."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = shape[:-2] + shape[-2:][::-1] if transposed else shape
    X = torch.rand(full, generator=g, device="cuda", dtype=torch.float64) ** 4
    X = (X - 0.05 * torch.randn(full, generator=g, device="cuda", dtype=torch.float64)).to(dtype)
    return X.mT if transposed else X


def hoyer_bound(S, iters):
    """(ms, "bytes" or "operations"): one read of S and one write of v at
    PEAK_BYTES against HOYER_OPS per entry per pass this run's vectors
    took, plus the hyperplane step, at the dtype's SIMT peak."""
    dt = str(S.dtype).split(".")[-1]
    N = S.shape[-1]
    t_bytes = 2 * S.numel() * S.element_size() / PEAK_BYTES
    t_ops = N * float((2 + HOYER_OPS * iters.double()).sum()) / PEAK_SIMT[dt]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def hoyer_tiers(hk, dtype):
    """The kernel's tiers for ``dtype``, read from the library's table: a
    list of (index, threads, entries per thread, CTAs per vector, largest
    N), the streaming tier last with largest N None."""
    tiers, N = [], 1
    while True:
        index, threads, items, cluster = hk.tier(N, dtype)
        if items == 0:
            return tiers + [(index, threads, items, cluster, None)]
        tiers.append((index, threads, items, cluster, threads * items * cluster))
        N = threads * items * cluster + 1


def hoyer_targets(torch, S, sp, valid, per_vector, seed):
    """(k1, k2): a sparseness's L1 target for unit L2 norm, or per vector
    sparsenesses around ``sp`` at squared norms 0.5-2, on the card."""
    from nmf_toolbox_tpu_torch.ops.projection import hoyer_l1_target
    n = S.shape[-1] if valid is None else valid
    if not per_vector:
        return hoyer_l1_target(n, sp), 1.0
    rng = np.random.default_rng(seed)
    batch = S.shape[:-1]
    k2 = rng.uniform(0.5, 2.0, batch)
    k1 = np.vectorize(lambda x: hoyer_l1_target(n, x))(rng.uniform(sp - 0.2, sp + 0.2, batch))
    return (torch.from_numpy(k1 * np.sqrt(k2)).to("cuda", S.dtype),
            torch.from_numpy(k2).to("cuda", S.dtype))


def check_hoyer(torch, hk, S, k1, k2, valid, name):
    """The kernel against its plain version on S (48 passes allowed): the
    same done flags, every vector done, passes equal in f64 and within one
    in f32, v within HOYER_RTOL of the largest entry, the pad 0, bits
    equal over two runs.  Returns (iters, pass gap, abs error, rel error)."""
    dt = str(S.dtype).split(".")[-1]
    v, done, iters = hk.hoyer_project(S, k1, k2, 48, valid)
    torch.cuda.synchronize()
    pv, pdone, piters = hk.hoyer_project_reference(S, k1, k2, 48, valid)
    gap = int((iters - piters).abs().max())
    err = float((v.double() - pv.double()).abs().max())
    rel = err / float(pv.double().abs().max())
    if not (torch.equal(done, pdone) and bool(done.all())):
        raise AssertionError(f"hoyer_project {name}: done flags differ or not all done")
    if not (gap <= HOYER_PASS_SLACK[dt] and rel <= HOYER_RTOL[dt]):
        raise AssertionError(f"hoyer_project {name}: passes {gap} apart, rel {rel:.3g}")
    if valid is not None and bool(v[..., valid:].any()):
        raise AssertionError(f"hoyer_project {name}: the pad past {valid} is not 0")
    again = hk.hoyer_project(S, k1, k2, 48, valid)
    if not all(torch.equal(a, b) for a, b in zip((v, done, iters), again)):
        raise AssertionError(f"hoyer_project {name}: two runs differ in their bits")
    return iters, gap, err, rel


def queued_device_ms(torch, call, reps):
    """Device ms a call: ``reps`` calls queued behind a device sleep, each
    between two CUDA events, so that a pair brackets the card's work for
    the call (a wrapper's copy included) and none of the host's."""
    call()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(QUEUE_CYCLES)
    for start, end in pairs:
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def kernel_device_ms(torch, call, reps):
    """(device ms a call by ``queued_device_ms``; the projection kernel's
    own device ms a launch from ``profile_device_ms`` over ``reps`` calls,
    the mean over the launches the profiler saw, None where it saw none;
    the share of the calls whose launch it saw).  In a long process the
    profiler now and then loses kernels (seen on the card: none, or a
    fraction, of a window's launches)."""
    queued = queued_device_ms(torch, call, reps)
    prof = profile_device_ms(torch, lambda: [call() for _ in range(reps)], reps)
    seen = sum(n for key, n in prof["launches_per_iter_by_kernel"].items() if "hoyer" in key)
    ms = sum(ms for key, ms in prof["device_ms_per_iter"].items() if "hoyer" in key)
    return queued, (ms / seen if seen else None), seen


def wrapper_host_us(torch, call, reps):
    """The host's µs per call: ``reps`` calls queued back to back, the
    clock read before the synchronise."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def phase18_hoyer_kernel(torch, hk):
    """The Hoyer projection kernel against its plain version on the card,
    f32 and f64: every tier of the table, then the solvers' shapes and
    the streaming, ``valid`` and per-vector cases, timed."""
    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0}

    def keep(err, rel):
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["max_rel_err"] = max(stats["max_rel_err"], rel)

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        for index, threads, items, cluster, cap in hoyer_tiers(hk, dtype):
            if cap is None:
                continue  # the streaming tier: HOYER_EXTRA's first case
            S = hoyer_input(torch, (HOYER_TIER_ROWS, cap), index % 2 == 1, dtype, 170 + index)
            name = f"tier {index} ({threads} threads x {items} x {cluster} CTAs) N {cap} {dt}"
            k1, k2 = hoyer_targets(torch, S, 0.6, None, False, index)
            iters, gap, err, rel = check_hoyer(torch, hk, S, k1, k2, None, name)
            keep(err, rel)
            say(f"phase 18 hoyer_project {name}{' (a W.mT view)' if index % 2 else ''}: done "
                f"flags equal, passes {int(iters.min())}-{int(iters.max())} within {gap} of "
                f"the plain version's, rel {rel:.3g}, bits equal over two runs")
            del S
    cases = [c + (None, False) for c in HOYER_SHAPES] + list(HOYER_EXTRA)
    for i, (label, shape, transposed, sp, valid, per_vector) in enumerate(cases):
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).split(".")[-1]
            S = hoyer_input(torch, shape, transposed, dtype, 180 + i)
            k1, k2 = hoyer_targets(torch, S, sp, valid, per_vector, i)
            name = f"{label} {'x'.join(map(str, shape))} {dt}"
            iters, gap, err, rel = check_hoyer(torch, hk, S, k1, k2, valid, name)
            keep(err, rel)
            call = (lambda: hk.hoyer_project(S, k1, k2, 48, valid))  # noqa: E731
            ms = cuda_ms(torch, call, 20)
            dev_ms, prof_ms, seen = kernel_device_ms(torch, call, 20)
            plain = cuda_ms(torch, lambda: hk.hoyer_project_reference(S, k1, k2, 48, valid), 3)
            b_ms, b_by = hoyer_bound(S, iters)
            row = {"ms": ms, "device_ms": dev_ms, "profiler_ms": prof_ms, "profiler_seen": seen,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "passes": [int(iters.min()), int(iters.max())],
                   "rel": rel, "tier": hk.tier(shape[-1], dtype)}
            extra = " (a contiguous copy of W's columns, then the kernel)" if transposed else ""
            if i == 0:  # BASELINE #2's H search: the wrapper's host time
                row["host_us"] = wrapper_host_us(torch, call, HOST_REPS)
                extra = f", the wrapper's host time {row['host_us']:.1f} µs a call"
            stats[name] = row
            if i == 0 and dtype == torch.float32:
                stats.update(ms=dev_ms, profiler_ms=prof_ms, profiler_seen=seen, event_ms=ms,
                             plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                             host_us=row["host_us"])
            profiled = ("the profiler saw no launch of it" if prof_ms is None
                        else f"the profiler's {prof_ms:.4f} ms a launch for the kernel alone, "
                        f"{seen:.2f} of the calls' launches seen")
            say(f"phase 18 hoyer_project {name}{' (a W.mT view)' if transposed else ''}, tier "
                f"{row['tier']}: done flags equal, passes {row['passes'][0]}-"
                f"{row['passes'][1]} within {gap} of the plain version's, rel {rel:.3g}, abs "
                f"{err:.3g}, bits equal over two runs; device {dev_ms:.4f} ms a call (events "
                f"queued behind a device sleep; {profiled}), CUDA events back to back "
                f"{ms:.4f} ms a call{extra}; plain {plain:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({100 * b_ms / (prof_ms or dev_ms):.1f}% of bound on the device, "
                f"{'the kernel alone' if prof_ms else 'a call'})")
            del S, k1, k2
    return stats


def phase18_phased(torch, fk, dk, hk, V_big):
    """nmfsc(dispatch="phased") against the default dispatch in turns at
    BASELINE #2 and at phase 7's width, bench.py's _nmfsc_b2_child on the
    port, f64 agreement at SPARSE_SMALL, and the refusal of a mesh; the
    kernel counters set to 0 before and read after."""
    import tempfile
    import torch.distributed as dist
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.parallel import init_distributed, make_mesh
    zero_fused_counts(fk)
    dk.kl_phi_dot_ht_dma_launches = 0
    hk.hoyer_project_launches = 0
    summary = {}
    count = lambda: hk.hoyer_project_launches  # noqa: E731

    def in_turns(label, calls):
        """default, phased, phased, default through sparse_timing; the
        mean of each pair, and f32 final costs within SPARSE_F32_RTOL."""
        outs = {"default": [], "phased": []}
        for d in ("default", "phased", "phased", "default"):
            out, _ = sparse_timing(torch, f"{label} dispatch {d}", calls[d], phase=18,
                                   launches=count)
            outs[d].append(out)
        row = {d: {key: float(np.mean([o[key] for o in os_]))
                   for key in ("ms_per_iter", "reads_per_iter", "launches_per_iter")}
               for d, os_ in outs.items()}
        costs = [o["final_cost"] for os_ in outs.values() for o in os_]
        gap = (max(costs) - min(costs)) / min(costs)
        if not gap <= SPARSE_F32_RTOL:
            raise AssertionError(f"{label}: final costs {costs} spread {gap:.3g}")
        row["final_cost_gap"] = gap
        say(f"phase 18 {label}, in turns: default {row['default']['ms_per_iter']:.3f} ms/iter, "
            f"{row['default']['reads_per_iter']:.2f} reads/iter, "
            f"{row['default']['launches_per_iter']:.2f} kernel launches/iter; phased "
            f"{row['phased']['ms_per_iter']:.3f} ms/iter, {row['phased']['reads_per_iter']:.2f} "
            f"reads/iter, {row['phased']['launches_per_iter']:.2f} kernel launches/iter; "
            f"final costs within {gap:.3g}")
        return row

    # b: BASELINE #2 with bench.py's seed-3 inits, then phase 7's width
    m, n, k = SPARSE_BASE
    rng = np.random.default_rng(B2_SEED)
    V = torch.from_numpy(rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)).cuda()
    W0 = torch.from_numpy(rng.uniform(size=(m, k)).astype(np.float32)).cuda()
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    H0 = torch.from_numpy(H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))).cuda()
    b2 = {d: (lambda it, d=d: tt.nmfsc(V, k, W_init=W0, H_init=H0, H_sparsity=0.6,
                                        maxiter=it, tolerance=NEVER, dispatch=DISPATCH[d]))
          for d in DISPATCH}
    label = f"nmfsc H_sparsity 0.6 {m}x{n} r{k}"
    summary[label] = in_turns(label, b2)
    # batched rounds: linesearch_width 8 through both dispatches
    finals = {}
    for d in DISPATCH:
        out, _ = sparse_timing(torch, f"{label} width 8 dispatch {d}", lambda it, d=d: tt.nmfsc(
            V, k, W_init=W0, H_init=H0, H_sparsity=0.6, maxiter=it, tolerance=NEVER,
            linesearch_width=8, dispatch=DISPATCH[d]), phase=18, launches=count)
        summary[label][f"{d}_width_8"] = out
        finals[d] = out["final_cost"]
    gap = abs(finals["phased"] - finals["default"]) / finals["default"]
    if not gap <= SPARSE_F32_RTOL:
        raise AssertionError(f"{label} width 8: final costs {finals} apart by {gap:.3g}")
    for d in ("default", "phased"):
        prof = profile_device_ms(torch, lambda: b2[d](ITERS), ITERS)
        summary[label][d]["profile"] = prof
        say(f"phase 18 profile {label} dispatch {d}, {ITERS} iterations with the one-time "
            f"work: {json.dumps(prof)}")

    # c: bench.py's _nmfsc_b2_child on the port, 30 iterations, best of 2
    b2["phased"](2)  # warm-up
    best = None
    for _ in range(2):
        f = float(1.0 + 1e-5 * np.random.default_rng().uniform(0.1, 1.0))
        r, ms = wall_ms(torch, lambda: tt.nmfsc(V, k, W_init=W0 * f, H_init=H0,
                                                H_sparsity=0.6, maxiter=B2_ITERS,
                                                tolerance=NEVER, dispatch="phased"))
        c = np.asarray(r.cost)
        if not (r.n_iters == B2_ITERS and np.all(np.isfinite(c))):
            raise AssertionError(f"bench.py's nmfsc child on the port: n_iters {r.n_iters}")
        best = ms if best is None else min(best, ms)
    summary["nmfsc_b2"] = {"nmfsc_b2_wall_s": best / 1e3,
                           "nmfsc_b2_ms_per_iter": best / B2_ITERS,
                           "nmfsc_b2_final_cost": float(c[-1])}
    say(f"phase 18 bench.py's _nmfsc_b2_child on the port: {json.dumps(summary['nmfsc_b2'])}")
    del V, W0, H0, b2

    m, n = V_big.shape
    k = GRAM[2]
    g = torch.Generator(device="cuda").manual_seed(16)
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    big = {d: (lambda it, d=d: tt.nmfsc(V_big, k, W_init=W0, H_init=H0, W_sparsity=0.5,
                                         H_sparsity=0.6, maxiter=it, tolerance=NEVER,
                                         dispatch=DISPATCH[d]))
           for d in DISPATCH}
    label = f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {m}x{n} r{k}"
    summary[label] = in_turns(label, big)
    prof = profile_device_ms(torch, lambda: big["phased"](ITERS), ITERS)
    summary[label]["phased"]["profile"] = prof
    say(f"phase 18 profile {label} dispatch phased, {ITERS} iterations with the one-time "
        f"work: {json.dumps(prof)}")
    del W0, H0, big
    torch.cuda.empty_cache()

    # f64 at SPARSE_SMALL: phased against default
    ms_, ns_, ks_, _ = SPARSE_SMALL
    rng = np.random.default_rng(46)
    Hs = rng.uniform(size=(ks_, ns_))
    small = dict(W_init=rng.uniform(size=(ms_, ks_)),
                 H_init=Hs / np.sqrt((Hs ** 2).sum(1, keepdims=True)), W_sparsity=0.5,
                 H_sparsity=0.6, maxiter=SMALL_ITERS, tolerance=NEVER, dtype=np.float64,
                 device="cuda")
    Vs = rng.uniform(0.05, 1.0, (ms_, ns_))
    a = tt.nmfsc(Vs, ks_, **small)
    b = tt.nmfsc(Vs, ks_, dispatch="phased", **small)
    gap = float(np.max(np.abs(b.cost - a.cost) / np.abs(a.cost))) if len(a.cost) == len(b.cost) \
        else np.inf
    if not (a.n_iters == b.n_iters and gap <= PHASED_RTOL_F64):
        raise AssertionError(f"f64 phased vs default: n_iters {b.n_iters} / {a.n_iters}, "
                             f"costs {gap:.3g} apart")
    gap_f = max(float((x - y).abs().max() / y.abs().max()) for x, y in ((b.W, a.W), (b.H, a.H)))
    # trials=2 sends searches to the slow path's host redo
    c = tt.nmfsc(Vs, ks_, dispatch="phased", trials=2, **small)
    gap2 = float(np.max(np.abs(c.cost - a.cost) / np.abs(a.cost))) \
        if len(a.cost) == len(c.cost) else np.inf
    if not (a.n_iters == c.n_iters and gap2 <= PHASED_RTOL_F64):
        raise AssertionError(f"f64 phased trials=2 vs default: n_iters {c.n_iters} / "
                             f"{a.n_iters}, costs {gap2:.3g} apart")
    summary["f64_small_gap"], summary["f64_small_factor_gap"] = gap, gap_f
    summary["f64_small_gap_trials_2"] = gap2
    say(f"phase 18 f64 {ms_}x{ns_} r{ks_} W 0.5 H 0.6, {SMALL_ITERS} iterations: phased vs "
        f"default cost traces {gap:.3g} apart (allowed {PHASED_RTOL_F64}), W and H {gap_f:.3g} "
        f"of their largest entry, {a.n_iters} iterations each; with trials=2 (slow-path "
        f"redos) {gap2:.3g}")

    launches = fused_counts(fk)
    launches[DMA[0]] = dk.kl_phi_dot_ht_dma_launches
    launches[HOYER[0]] = hk.hoyer_project_launches
    say(f"phase 18 kernel launches in phase 18: {json.dumps(launches)}")
    if launches[HOYER[0]] == 0 or any(v for key, v in launches.items() if key != HOYER[0]):
        raise AssertionError(f"phase 18 launches: {launches}")
    summary["launches"] = launches[HOYER[0]]

    # a one-rank mesh is refused by the phased dispatch
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/rendezvous18", 1, 0, backend="nccl",
                         timeout=MESH_TIMEOUT)
        try:
            tt.nmfsc(Vs, ks_, dispatch="phased", mesh=make_mesh(1), **small)
        except ValueError as e:
            say(f"phase 18 phased with a one-rank mesh: ValueError ({e})")
        else:
            raise AssertionError("the phased dispatch accepted mesh=")
        finally:
            dist.destroy_process_group()
    say(f"phase 18 {json.dumps(summary)}")
    return summary


# ---------------------------------------------------------------------------
# Phase 19: the mesh on four cards, one NCCL rank a card
# ---------------------------------------------------------------------------

def p19_inputs(torch):
    """Phase 19's inputs, drawn on this rank's card from seeds, so that
    every process draws the same: phase 16's (the fused runs, phase 7's V
    with the gram inits, the sparse V for HALS), phase 17's two-rank set
    on that V, the weighted KL problem, phase 10's restarts and phase 9's
    batch with the encoders' dictionaries and phases."""
    m16 = mesh_inputs(torch)
    x = rank_inputs(torch, m16[3])
    rng = np.random.default_rng(19)
    u = lambda *s: torch.from_numpy(rng.uniform(size=s).astype(np.float32)).cuda()  # noqa: E731
    mw, nw, kw = WEIGHTED
    mr, nr, r = RANK_SWEEP
    S, kr = RANK_SEEDS, 16
    Vr = (torch.from_numpy(rng.gamma(2.0, 1.0, (mr, r)).astype(np.float32))
          @ torch.from_numpy(rng.gamma(0.5, 1.0, (r, nr)).astype(np.float32)) + 0.01)
    B, mb, nb, kb = SERVING
    _, bases, Vb = serving_batch(torch)
    T, (T2, P2) = CONV_ENCODE_T, NMF2D_ENCODE_TP
    x.update(
        mesh16=m16, V_host=m16[6].cpu().numpy(),
        Vw=0.1 + 0.9 * u(mw, nw), Mw=(u(mw, nw) < 0.8).float(), Ww=u(mw, kw), Hw=u(kw, nw),
        Vr=Vr.cuda(), Wr=u(S, mr, kr), Hr=u(S, kr, nr),
        Vb=Vb, Wb=u(B, mb, kb), Hb=u(B, kb, nb), Hb4=u(B, kb, nb, P2),
        Wd=torch.from_numpy(bases[0] / np.sqrt((bases[0] ** 2).sum(0))).cuda(),
        Wc4=u(mb, kb, T) + 0.1, W2=u(mb, kb, T2) + 0.1,
        Vbc=Vb * torch.exp(1j * (2 * np.pi) * u(B, mb, nb)))
    return x


def p19_runs(x):
    """Phase 19's solves: name -> (call(mesh), iterations, tolerance
    against one card, timed).  Full width at ITERS19 iterations (the four
    timed ones get a warm-up on one card and on each mesh); the rest at
    phase 17's shapes cut to SMALL_ITERS19 iterations (phase 17: 5), the
    engines to SMALL_ITERS19 too (phases 9-10: 100).

    A tolerance of None marks an f32 solve whose steps amplify the order
    of a sum: four ranks sum V H', H H' and the like in another order
    than one card, and HALS's column sweeps (and their eps floor on a
    sparse V), seminmf's solve with H H' and the Hoyer projection's
    thresholds in nmfsc carry that difference far past 1e-4 (a four-card
    run of these calls measured, against one card: HALS 4.8e-4 in W after
    10 iterations, 0.78 from NNDSVDA seeds after 5; seminmf 5.8e-4 after 3;
    nmfsc 4.3e-4 after 10, its cost within 1.2e-7).  Such a run is timed
    and its gap printed; its f64 twin holds the same call to
    MESH_RTOL_F64 (HALS from NNDSVDA seeds after 5 iterations: see its
    entry; its seeds and its first sweep are held)."""
    import torch
    import nmf_toolbox_tpu_torch as tt
    Vf, Wf, Hf, Vg, Wg, Hg, Vl, Wl, Hl = x["mesh16"]
    full, small = ITERS19, SMALL_ITERS19
    m, n, k = GRAM
    one = dict(tolerance=NEVER)
    f64 = dict(one, dtype=torch.float64)
    ini = x["ini"]
    runs = {
        "nmf fused kl": (lambda msh: tt.nmf(Vf, MAIN[2], divergence="kl", method="fused",
                                            W_init=Wf, H_init=Hf, maxiter=full, mesh=msh, **one),
                         full, MESH_RTOL, True),
        "nmf fused is": (lambda msh: tt.nmf(Vf, MAIN[2], divergence="is", method="fused",
                                            W_init=Wf, H_init=Hf, maxiter=full, mesh=msh, **one),
                         full, MESH_RTOL, False),
        "nmf gram": (lambda msh: tt.nmf(Vg, k, W_init=Wg, H_init=Hg, method="gram",
                                        maxiter=full, mesh=msh, **one), full, MESH_RTOL, True),
        "nmf gram nndsvd from a host V": (lambda msh: tt.nmf(
            x["V_host"], k, init="nndsvd", method="gram", maxiter=full, mesh=msh, **one),
            full, MESH_RTOL, False),
        "nmf_hals": (lambda msh: tt.nmf_hals(Vl, k, W_init=Wl, H_init=Hl, maxiter=full,
                                             mesh=msh, **one), full, None, True),
        "nmf_hals f64": (lambda msh: tt.nmf_hals(Vl, k, W_init=Wl, H_init=Hl, maxiter=full,
                                                 mesh=msh, **f64), full, MESH_RTOL_F64, False),
        # From NNDSVDA's seeds, in f64, four ranks stand 3.5e-8 in W (cost
        # 7.7e-10) from one card after 5 iterations and 3.4e-8 after 10:
        # not held.  The seeds are bit-identical to one card's (each rank
        # seeds from the whole V on its own card) and the first sweep stood
        # 4.8e-14 from one card (four-card runs): both held, so the gap
        # grows in sweeps 2-5, from the order of the sweeps' sums.
        "nndsvda seeds of a host V f64": (lambda msh: nndsvda_seeds(x["V_host"], k, msh),
                                          0, MESH_RTOL_F64, False),
        "nmf_hals nndsvda from a host V f64, 1 iteration": (lambda msh: tt.nmf_hals(
            x["V_host"], k, init="nndsvda", maxiter=1, mesh=msh, **f64), 1, MESH_RTOL_F64,
            False),
        "nmf_hals nndsvda from a host V f64": (lambda msh: tt.nmf_hals(
            x["V_host"], k, init="nndsvda", maxiter=MESH_RANK_ITERS, mesh=msh, **f64),
            MESH_RANK_ITERS, None, False),
        f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {m}x{n} r{k}": (lambda msh: tt.nmfsc(
            Vg, k, W_init=Wg, H_init=Hg, W_sparsity=0.5, H_sparsity=0.6, maxiter=full,
            mesh=msh, **one), full, None, True),
        f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {m}x{n} r{k} f64": (lambda msh: tt.nmfsc(
            Vg, k, W_init=Wg, H_init=Hg, W_sparsity=0.5, H_sparsity=0.6, maxiter=full,
            mesh=msh, **f64), full, MESH_RTOL_F64, False),
        f"seminmf {m}x{n} r{k} f64": (lambda msh: tt.seminmf(
            Vg, k, W_init=2 * ini["W"] - 1, H_init=ini["H"], maxiter=small, mesh=msh, **f64),
            small, MESH_RTOL_F64, False),
    }
    for name in family_calls(tt, Vg, k, ini, small):
        runs[f"{name} {m}x{n} r{k}"] = (lambda msh, name=name: family_calls(
            tt, Vg, k, ini, small, mesh=msh)[name](), small,
            None if name == "seminmf" else MESH_RTOL, False)
    for name in rank_runs(x, small, None):
        tol = MESH_RTOL_F64 if name.endswith("f64") else MESH_RTOL
        runs[name] = (lambda msh, name=name: rank_runs(x, small, msh)[name](), small, tol, False)
    mw, nw, kw = WEIGHTED
    mr, nr, r = RANK_SWEEP
    B, mb, nb, kb = SERVING
    T, (T2, P2) = CONV_ENCODE_T, NMF2D_ENCODE_TP
    eng = dict(maxiter=small)
    runs.update({
        f"nmf kl weights {mw}x{nw} r{kw}": (lambda msh: tt.nmf(
            x["Vw"], kw, W_init=x["Ww"], H_init=x["Hw"], weights=x["Mw"], divergence="kl",
            maxiter=small, mesh=msh, **one), small, MESH_RTOL, False),
        f"nmf_multiseed kl {mr}x{nr} S{RANK_SEEDS} r16": (lambda msh: tt.nmf_multiseed(
            x["Vr"], 16, RANK_SEEDS, W_init=x["Wr"], H_init=x["Hr"], divergence="kl",
            mesh=msh, **eng), small, MESH_RTOL, False),
        f"nmf_batched B{B} {mb}x{nb} r{kb}": (lambda msh: tt.nmf_batched(
            x["Vb"], kb, W_init=x["Wb"], H_init=x["Hb"], mesh=msh, **eng),
            small, MESH_RTOL, False),
        f"nmf_encode kl B{B}": (lambda msh: tt.nmf_encode(
            x["Vb"], x["Wd"], H_init=x["Hb"], divergence="kl", mesh=msh, **eng),
            small, MESH_RTOL, False),
        f"cnmf_encode kl B{B} T{T}": (lambda msh: tt.cnmf_encode(
            x["Vb"], x["Wc4"], H_init=x["Hb"], divergence="kl", mesh=msh, **eng),
            small, MESH_RTOL, False),
        f"nmf2d_encode B{B} T{T2} P{P2}": (lambda msh: tt.nmf2d_encode(
            x["Vb"], x["W2"], P2, H_init=x["Hb4"], mesh=msh, **eng), small, MESH_RTOL, False),
        f"cmfwisa_encode B{B}": (lambda msh: tt.cmfwisa_encode(
            x["Vbc"], x["Wd"], H_init=x["Hb"], mesh=msh, **eng), small, MESH_RTOL, False),
    })
    return runs


def nndsvda_seeds(V_host, k, mesh):
    """The seeds ``nmf_hals(V_host, k, init="nndsvda", dtype=float64,
    mesh=mesh)`` starts from: NNDSVDA of the whole V in f64 on the run's
    card (the mesh's device on this rank, else the current card) with the
    solver's generator (seed 0), as a Result-like object whose cost is
    the seeds' squared error."""
    import types
    import torch
    from nmf_toolbox_tpu_torch.utils import nndsvd
    device = mesh.device if mesh is not None else torch.device("cuda", torch.cuda.current_device())
    V = torch.from_numpy(V_host).to(device, torch.float64)
    W, H = nndsvd(V, k, generator=torch.Generator().manual_seed(0), variant="nndsvda")
    err = torch.sum(torch.sub(V, W @ H, out=V).square_())
    return types.SimpleNamespace(W=W, H=H, cost=[float(err)], n_iters=0)


def reduced_mb(name, m, n, k, R, C):
    """MB each rank reduces an iteration by PERF.md §3's formulas (f32;
    sums of k or fewer floats left out), on a mesh of R x C ranks (R
    over V's rows, C over its columns); None for a solve they do not
    cover."""
    mk, kn, kk = m // R * k, k * (n // C), k * k
    by_samples = {"nmf gram": mk + kk, "nmf_hals": mk + kk, "nmf fused kl": mk,
                  "nmf fused is": 2 * mk}
    by_features = {"nmf gram": kn + kk, "nmf_hals": kn + kk, "nmf fused kl": kn,
                   "nmf fused is": 2 * kn}
    if name not in by_samples:
        return None
    floats = (by_samples[name] if C > 1 else 0) + (by_features[name] if R > 1 else 0)
    return 4 * floats / 1e6


def digest(got):
    """A hash of a result's W, H and cost bits: equal on two ranks only
    if their results are bit-identical."""
    import hashlib
    h = hashlib.sha256()
    for f in ("W", "H"):
        if f in got:
            h.update(np.ascontiguousarray(got[f].numpy()).tobytes())
    h.update(np.ascontiguousarray(got["cost"]).tobytes())
    return h.hexdigest()


def gaps(got, ref):
    """The largest relative error of W and H (of their largest entry) and
    of the cost trace against a reference, as phases 16-17 measure it."""
    out = {f: max_rel(got[f], ref[f]) for f in ("W", "H") if f in ref}
    out["cost"] = (float(np.max(np.abs(got["cost"] / ref["cost"] - 1)))
                   if got["cost"].shape == ref["cost"].shape else float("inf"))
    return out


def collective_times(torch, dist, meshes):
    """The device ms (CUDA events around ALLREDUCE_REPS calls back to
    back, after a warm-up) and the host µs a call (the clock read before
    the synchronise) of: one all_reduce of each size of ALLREDUCE19
    between the four cards and within each axis of the 2 x 2 mesh; the
    port's sum_all of a k x k and a k tensor (one flat buffer); the
    halo of cnmf's T * k-row operand at phase 13's shape (one all_gather
    of T - 1 columns a rank); and a host-bound step's round trip, 3
    floats made, summed over the four cards and read back, beside the
    same step with no sum."""
    from nmf_toolbox_tpu_torch.parallel import collectives
    m14, m22 = meshes["1x4"], meshes["2x2"]
    cases = {}
    for label, group in {"4 cards": None, "2 cards (2x2 'n' axis)": m22.group("n"),
                         "2 cards (2x2 'm' axis)": m22.group("m")}.items():
        for size_name, floats in ALLREDUCE19.items():
            t = torch.ones(floats, device="cuda")
            cases[f"all_reduce {label} {size_name}"] = (
                lambda t=t, group=group: dist.all_reduce(t, group=group))
    k = GRAM[2]
    a, b = torch.ones(k, k, device="cuda"), torch.ones(k, device="cuda")
    cases["sum_all 4 cards, k x k and k floats"] = lambda: collectives.sum_all(m14, a, b)
    mc, nc, kc, T = CONV
    H = torch.ones(T * kc, nc // CARDS19, device="cuda")  # cnmf's widest halo operand
    cases[f"halo 4 cards, {T - 1} columns of {T * kc} rows"] = lambda: collectives.halo(
        m14, H, T - 1, "left")
    cases["step and read 4 cards, sum_all of 3 floats"] = lambda: float(
        collectives.sum_all(m14, torch.ones(3, device="cuda"))[0])
    cases["step and read, no collective"] = lambda: float(torch.ones(3, device="cuda")[0])
    out = {}
    for name, call in cases.items():
        call()
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(ALLREDUCE_REPS):
            call()
        end.record()
        host_us = (time.perf_counter() - t0) * 1e6 / ALLREDUCE_REPS
        torch.cuda.synchronize()
        out[name] = {"device_ms": start.elapsed_time(end) / ALLREDUCE_REPS, "host_us": host_us}
    return out


def checkpoint19(torch, x, meshes, tmp):
    """Orbax checkpoints on each mesh: save_factors_orbax and
    load_factors_orbax of a fused KL result, every rank writing and
    reading its blocks, restored bit-identical; run_checkpointed of that
    run in chunks, straight and crash-resumed, bit-identical to one
    meshed call."""
    from nmf_toolbox_tpu_torch import nmf
    from nmf_toolbox_tpu_torch.parallel.collectives import dtensor_whole
    from nmf_toolbox_tpu_torch.utils import (load_factors_orbax, run_checkpointed,
                                             save_factors_orbax)
    Vf, Wf, Hf = x["mesh16"][:3]
    k, total, chunk = MAIN[2], CKPT_ITERS, CKPT_CHUNK
    out = {}
    for label, mesh in meshes.items():
        kw = dict(W_init=Wf, H_init=Hf, method="fused", divergence="kl", tolerance=NEVER,
                  mesh=mesh)
        one = nmf(Vf, k, maxiter=total, **kw)
        path = f"{tmp}/save19_{label}"
        save_ms = wall_ms(torch, lambda: save_factors_orbax(path, one, mesh=mesh,
                                                            solver="nmf"))[1]
        back = load_factors_orbax(path, mesh=mesh, solver="nmf")
        restored = all(torch.equal(dtensor_whole(back[f"{f}_init"]).to(one.W.device),
                                   getattr(one, f)) for f in ("W", "H"))
        res, ck_ms = wall_ms(torch, lambda: run_checkpointed(
            nmf, Vf, k, total_iters=total, chunk=chunk, path=f"{tmp}/ck19_{label}",
            backend="orbax", **kw))
        run_checkpointed(nmf, Vf, k, total_iters=total // 2, chunk=chunk,
                         path=f"{tmp}/crash19_{label}", backend="orbax", **kw)
        resumed = run_checkpointed(nmf, Vf, k, total_iters=total, chunk=chunk,
                                   path=f"{tmp}/crash19_{label}", backend="orbax", **kw)
        out[label] = {"restored_identical": bool(restored),
                      "chunked_identical": bool(same_result(torch, res, one)),
                      "resumed_identical": bool(same_result(torch, resumed, one)),
                      "save_ms": save_ms, "ms_per_iter_chunked": ck_ms / total}
    return out


def mesh19_rank(rank, tmp, queue):
    """One of phase 19's four NCCL ranks, one a card: every solve of
    p19_runs on a 1-D mesh of four and on a 2 x 2 mesh (rank 0 also runs
    each with no mesh on its card, card 0, and measures the error against
    it), the orbax checkpoints, and the collectives' times; the numbers
    go to ``queue``."""
    import faulthandler
    import traceback
    faulthandler.dump_traceback_later(TIMEOUT19 - 30)  # where a hang waits
    try:
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
        from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
        from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk
        from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk
        from nmf_toolbox_tpu_torch.parallel import collectives, init_distributed, make_mesh
        t0 = time.perf_counter()
        init_distributed(f"file://{tmp}/rendezvous19", CARDS19, rank, backend="nccl",
                         timeout=TIMEOUT19)
        meshes = {"1x4": make_mesh(CARDS19), "2x2": make_mesh(shape=(2, CARDS19 // 2))}
        out = {"rank": rank, "device": str(meshes["1x4"].device),
               "current_device": torch.cuda.current_device(), "solves": {}}
        x = p19_inputs(torch)
        dist.barrier()
        out["start_s"] = time.perf_counter() - t0

        def counts():
            return dict(fused_counts(fk), **{DMA[0]: dk.kl_phi_dot_ht_dma_launches,
                                             HOYER[0]: hk.hoyer_project_launches},
                        **naive_kl_counts(nk))
        for name, (call, iters, tol, timed) in p19_runs(x).items():
            row, ref = {"rtol": tol}, None
            if rank == 0:
                if timed:
                    call(None)
                res, ms = wall_ms(torch, lambda: call(None))
                ref = factors(torch, res)
                row["one_card"] = {"ms_per_iter": ms / max(res.n_iters, 1),
                                   "n_iters": res.n_iters}
                del res
            for label, mesh in meshes.items():
                if timed:
                    call(mesh)
                dist.barrier()
                zero_fused_counts(fk)
                dk.kl_phi_dot_ht_dma_launches = hk.hoyer_project_launches = 0
                zero_naive_kl_counts(nk)
                calls = collectives.calls
                res, ms = wall_ms(torch, lambda: call(mesh))
                got = factors(torch, res)
                per = max(res.n_iters, 1)
                cell = {"ms_per_iter": ms / per, "n_iters": res.n_iters,
                        "collectives_per_iter": (collectives.calls - calls) / per,
                        "launches": counts(), "digest": digest(got)}
                if ref is not None:
                    cell["vs_one_card"] = gaps(got, ref)
                    cell["n_iters_equal"] = res.n_iters == row["one_card"]["n_iters"]
                row[label] = cell
                del res, got
            out["solves"][name] = row
            del ref
            torch.cuda.empty_cache()
        out["checkpoint"] = checkpoint19(torch, x, meshes, tmp)
        del x
        torch.cuda.empty_cache()
        out["collectives"] = collective_times(torch, dist, meshes)
        out["rank_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, {"error": traceback.format_exc()}))


def check19(got):
    """Phase 19's verdicts from the ranks' answers: per solve and mesh,
    every rank bit-identical to rank 0, rank 0 within the solve's
    tolerance of one card with the same n_iters, the fused kernels
    launched on every rank of the fused runs (the dma kernel never),
    hoyer_project on every rank of the sparse runs and the naive KL
    passes on every rank of the weighted KL run alone; the checkpoints
    bit-identical.  Prints a line per solve and mesh, and raises once
    every line is out if any of them failed."""
    ranks = [got[r] for r in range(CARDS19)]
    summary = {"devices": [g["device"] for g in ranks],
               "start_s": [g["start_s"] for g in ranks],
               "rank_s": [g["rank_s"] for g in ranks], "solves": {}}
    if sorted(summary["devices"]) != [f"cuda:{r}" for r in range(CARDS19)]:
        raise AssertionError(f"phase 19: the ranks did not take one card each: "
                             f"{summary['devices']}")
    runs, failures = ranks[0]["solves"], []
    for name, row in runs.items():
        tol = row["rtol"]
        one = row["one_card"]
        out = {"one_card_ms_per_iter": one["ms_per_iter"], "n_iters": one["n_iters"]}
        for label in ("1x4", "2x2"):
            cells = [g["solves"][name][label] for g in ranks]
            R, C = (1, CARDS19) if label == "1x4" else (2, CARDS19 // 2)
            shape = MAIN if name.startswith("nmf fused") else GRAM
            cell = {"vs_one_card": cells[0]["vs_one_card"], "rtol": tol,
                    "rank_identical": all(c["digest"] == cells[0]["digest"] for c in cells),
                    "n_iters_equal": cells[0]["n_iters_equal"],
                    "ms_per_iter": [c["ms_per_iter"] for c in cells],
                    "collectives_per_iter": cells[0]["collectives_per_iter"],
                    "reduced_mb_per_iter": reduced_mb(name, *shape, R, C),
                    "launches": [c["launches"] for c in cells]}
            out[label] = cell
            fused = name.startswith("nmf fused")
            sparse = name.startswith(("nmfsc", "cnmfsc"))
            launched = all(min(c[k] for k, _ in KERNELS) > 0 and c[DMA[0]] == 0
                           for c in cell["launches"]) if fused else True
            projected = all(c[HOYER[0]] > 0 for c in cell["launches"]) if sparse else True
            quiet = all(not any(c[k] for k, _ in KERNELS) and not c[DMA[0]]
                        for c in cell["launches"]) if not fused else True
            # the naive KL passes: two fields and a cost an iteration on
            # every rank of the weighted KL solve, none elsewhere
            per = cells[0]["n_iters"] if name.startswith("nmf kl weights") else 0
            naive = all({k: c[k] for k, _ in NAIVE_KL} == {"kl_field": 2 * per, "kl_cost": per}
                        for c in cell["launches"])
            gap = max(cell["vs_one_card"].values())
            allowed = "not held: see p19_runs" if tol is None else f"allowed {tol:g}"
            say(f"phase 19 {label}, {name}: ranks bit-identical {cell['rank_identical']}; from "
                f"one card {', '.join(f'{f} {v:.3g}' for f, v in cell['vs_one_card'].items())} "
                f"relative ({allowed}), n_iters equal {cell['n_iters_equal']}; ms/iter "
                f"{one['ms_per_iter']:.3f} on one card, "
                f"{', '.join(f'{v:.3f}' for v in cell['ms_per_iter'])} on the ranks; "
                f"{cell['collectives_per_iter']:g} collectives per iteration"
                + (f", {cell['reduced_mb_per_iter']:.2f} MB reduced per iteration"
                   if cell["reduced_mb_per_iter"] is not None else "")
                + f"; launches per rank {json.dumps(cell['launches'])}")
            if not (cell["rank_identical"] and cell["n_iters_equal"]
                    and (tol is None or gap <= tol) and launched and projected and quiet
                    and naive):
                failures.append(f"{label} {name}: {json.dumps(cell)}")
        summary["solves"][name] = out
    for label in ("1x4", "2x2"):
        ck = [g["checkpoint"][label] for g in ranks]
        say(f"phase 19 {label}, orbax save/load of fused KL and run_checkpointed "
            f"{CKPT_ITERS} iterations in chunks of {CKPT_CHUNK}, straight and crash-resumed, "
            f"per rank: {json.dumps(ck)}")
        if not all(c["restored_identical"] and c["chunked_identical"] and c["resumed_identical"]
                   for c in ck):
            failures.append(f"{label}: a checkpoint is not bit-identical: {ck}")
    summary["checkpoint"] = [g["checkpoint"] for g in ranks]
    summary["collectives"] = [g["collectives"] for g in ranks]
    for key in ranks[0]["collectives"]:
        device = [g["collectives"][key]["device_ms"] for g in ranks]
        host = [g["collectives"][key]["host_us"] for g in ranks]
        say(f"phase 19 {key}: device ms a call "
            f"{', '.join(f'{v:.4f}' for v in device)} per rank, host µs a call "
            f"{', '.join(f'{v:.1f}' for v in host)}")
    if failures:
        raise AssertionError("phase 19 failed:\n" + "\n".join(failures))
    return summary


def cli19(torch, V, tmp):
    """``torchrun --nproc-per-node 4 -m nmf_toolbox_tpu_torch nmf V.npy
    --k 200 --mesh 4`` on phase 7's V saved as a .npy, from injected inits
    (``--resume``): every rank exits 0, rank 0 alone writes and prints,
    the factors within MESH_RTOL of the same command in process on one
    card, and no process of the command is left after it."""
    import os
    from nmf_toolbox_tpu_torch import cli
    from nmf_toolbox_tpu_torch.utils.checkpoint import save_factors
    m, n, k = GRAM
    npy, init = tmp / "V19.npy", tmp / "init19.npz"
    np.save(npy, V.cpu().numpy())
    rng = np.random.default_rng(191)
    save_factors(init, {"W": rng.uniform(size=(m, k)).astype(np.float32),
                        "H": rng.uniform(size=(k, n)).astype(np.float32)})
    argv = ["nmf", str(npy), "--k", str(k), "--maxiter", str(ITERS19), "--tolerance",
            str(NEVER), "--resume", str(init)]
    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root), "PYTHONFAULTHANDLER": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(CARDS19), "-m", "nmf_toolbox_tpu_torch",
                           *argv, "--mesh", str(CARDS19), "--out", str(tmp / "cli19.npz")],
                          cwd=root, env=env, capture_output=True, text=True, timeout=TIMEOUT19)
    wall_s = time.perf_counter() - t0
    left = [pid for pid, cmd in processes_naming(str(npy))]
    if proc.returncode != 0:
        raise AssertionError(f"phase 19 CLI: torchrun exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    printed = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    _, ms = wall_ms(torch, lambda: cli.main(argv + ["--out", str(tmp / "one19.npz"), "--quiet"]))
    with np.load(tmp / "cli19.npz") as a, np.load(tmp / "one19.npz") as b:
        gap = {f: max_rel(torch.from_numpy(a[f]), torch.from_numpy(b[f])) for f in ("W", "H")}
    row = {"exit_code": proc.returncode, "lines_printed": len(printed), "wall_s": wall_s,
           "one_card_in_process_s": ms / 1e3, "vs_one_card": gap, "left_processes": left}
    say(f"phase 19 CLI torchrun --nproc-per-node {CARDS19} nmf {m}x{n} --k {k} --mesh "
        f"{CARDS19} --maxiter {ITERS19}: {json.dumps(row)}")
    if len(printed) != 1 or max(gap.values()) > MESH_RTOL or left:
        raise AssertionError(f"phase 19 CLI: {json.dumps(row)}")
    return row


def processes_naming(text):
    """(pid, command line) of every process whose command line holds
    ``text``, this one left out."""
    import os
    out = []
    for cmdline in pathlib.Path("/proc").glob("[0-9]*/cmdline"):
        try:
            cmd = cmdline.read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if text in cmd and int(cmdline.parent.name) != os.getpid():
            out.append((int(cmdline.parent.name), cmd[:200]))
    return out


def phase19_four_cards(torch, V_gram, probe):
    """The mesh on four cards, one NCCL rank a card: every solve that
    takes a mesh held against one card, the orbax checkpoints, the
    collectives' times, the CLI under torchrun.  With fewer cards, one line
    that says so.  The probe's card count must equal this process's before
    any rank is spawned."""
    import tempfile
    count = torch.cuda.device_count()
    if probe["count"] != count:
        raise AssertionError(f"phase 19: the probe counted {probe['count']} live "
                             f"cards, torch.cuda.device_count() {count}")
    if count < CARDS19:
        say(f"phase 19 did not run: {count} card{'' if count == 1 else 's'}; the "
            f"four-card mesh needs {CARDS19}")
        return None
    t0 = time.perf_counter()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60)
    say(f"phase 19 nvidia-smi topo -m (exit {topo.returncode}):\n"
        f"{(topo.stdout + topo.stderr).rstrip()}")
    links = subprocess.run(["nvidia-smi", "nvlink", "--status"], capture_output=True,
                           text=True, timeout=60)
    speeds = {}  # card -> the speed of each of its NVLink links
    for line in links.stdout.splitlines():
        if line.startswith("GPU "):
            speeds[line.split(":")[0]] = []
        elif "Link " in line and speeds:
            speeds[list(speeds)[-1]].append(line.split(":", 1)[1].strip())
    say(f"phase 19 nvidia-smi nvlink --status (exit {links.returncode}): " + "; ".join(
        f"{gpu}: {len(v)} links, {', '.join(sorted(set(v)))} each" for gpu, v in speeds.items()))
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(count)]
             for i in range(count)]
    say(f"phase 19 peer access between the cards (torch.cuda.can_device_access_peer): {peers}")
    say(f"phase 19 cards:\n{card()}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(mesh19_rank, tmp, n=CARDS19, timeout=TIMEOUT19)
        failed = {r: g["error"] for r, g in got.items() if "error" in g}
        if failed:
            raise AssertionError("phase 19 ranks failed:\n" + "\n".join(
                f"rank {r}:\n{e}" for r, e in failed.items()))
        summary = check19(got)
        summary["cli"] = cli19(torch, V_gram, pathlib.Path(tmp))
    summary["phase_s"] = time.perf_counter() - t0
    say(f"phase 19 wall time {summary['phase_s']:.1f} s")
    say(f"phase 19 {json.dumps(summary)}")
    return summary


def main():
    probe = phase0_probe()
    import torch
    phase0_device(torch, probe)
    phase1_build()
    if sys.argv[1:] == ["--phase", "19"]:
        m, n, k = GRAM
        g = torch.Generator(device="cuda").manual_seed(0)
        V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
        if phase19_four_cards(torch, V, probe) is None:
            raise SystemExit("phase 19 only: fewer than four cards")
        say("phase 19 only: ok")
        return
    if sys.argv[1:]:
        raise SystemExit(f"usage: chip_smoke.py [--phase 19]; got {sys.argv[1:]}")
    from nmf_toolbox_tpu_torch import nmf, nmf_hals
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
    from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk

    m, n, k = MAIN
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)

    stats = phase2_kernels(torch, fk, V)
    dma_stats = phase2_dma(torch, dk, _build.load(), V)
    naive_stats = phase2_naive_kl(torch, nk, nmf, V, W0, H0)
    main_path = phase3_main_path(torch, fk, dk, nk, nmf, V, W0, H0)
    del V
    torch.cuda.empty_cache()
    phase4_gram(torch, nmf)
    phase5_objective(torch, nmf)
    phase5b_card_numerics(torch, nmf)
    dma_launches = phase6_wphase_compare(torch, fk, dk, _build.load(), dma_stats)
    torch.cuda.empty_cache()
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(0)
    V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
    phase7_hals(torch, nmf_hals, V)
    phase8_nmf_options(torch, nmf, V)
    phase9_serving(torch)
    phase10_rank(torch, V)
    # Phases 11-12 run no kernel of their own (the JAX modules they port
    # reach no pallas_call); the counters say whether any launched.
    fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0
    dk.kl_phi_dot_ht_dma_launches = 0
    zero_naive_kl_counts(nk)
    phase11_streaming(torch, V)
    phase12_gram_family(torch, V)
    launches = {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}
    launches[DMA[0]] = dk.kl_phi_dot_ht_dma_launches
    launches.update(naive_kl_counts(nk))
    say(f"phase 12 kernel launches in phases 11-12: {json.dumps(launches)}")
    # Phase 13 ports modules that reach no pallas_call: no kernel may launch.
    fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0
    dk.kl_phi_dot_ht_dma_launches = 0
    zero_naive_kl_counts(nk)
    phase13_convolutive(torch, V)
    launches = {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}
    launches[DMA[0]] = dk.kl_phi_dot_ht_dma_launches
    launches.update(naive_kl_counts(nk))
    say(f"phase 13 kernel launches in phase 13: {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"phase 13 launched a kernel: {launches}")
    # Phase 14 ports modules that reach no pallas_call: no fused kernel may
    # launch (their projections launch hoyer_project, counted per run).
    fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0
    dk.kl_phi_dot_ht_dma_launches = 0
    zero_naive_kl_counts(nk)
    phase14_sparse_complex_audio(torch, V)
    launches = {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}
    launches[DMA[0]] = dk.kl_phi_dot_ht_dma_launches
    launches.update(naive_kl_counts(nk))
    say(f"phase 14 kernel launches in phase 14: {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched a kernel: {launches}")
    phase15_utilities_front_ends(torch, fk, V)
    phase16_mesh(torch, fk, V)
    phase17_mesh_solvers(torch, fk, V)
    from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk
    t18 = time.perf_counter()
    hoyer_stats = phase18_hoyer_kernel(torch, hk)
    phased = phase18_phased(torch, fk, dk, hk, V)
    say(f"phase 18 wall time {time.perf_counter() - t18:.1f} s")
    four = phase19_four_cards(torch, V, probe)
    del V

    def mesh_launches(solve, name):
        """A kernel's launches on each rank in phase 19's 1x4 run of a
        solve; None where phase 19 did not run."""
        if four is None:
            return None
        return [c[name] for c in four["solves"][solve]["1x4"]["launches"]]

    def per_iter(name):
        """Launches per fused iteration, counted in phase 3's runs."""
        return (sum(r["launches"][name] for r in main_path.values())
                / sum(r["iters"] for r in main_path.values()))

    kernels = []
    for name, replaces in KERNELS:
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(main_path[d]["launches"][name] for d in ("kl", "is")),
            "launches_per_iter": per_iter(name),
            "max_abs_err": s["max_abs_err"], "max_rel_err": s["max_rel_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": None,
            "ms_is": s["ms_is"], "plain_ms_is": s["plain_ms_is"],
            "bound_ms_is": s["bound_ms_is"], "bound_by_is": s["bound_by_is"],
            "tflops": s["tflops"], "tflops_is": s["tflops_is"],
            "four_card_launches_per_rank": mesh_launches("nmf fused kl", name),
        })
    name, replaces, source = DMA
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": dma_launches, "launches_per_iter": per_iter(name),
        "max_abs_err": dma_stats["max_abs_err"],
        "max_rel_err": dma_stats["max_rel_err"], "ms": dma_stats["ms"],
        "plain_ms": dma_stats["plain_ms"], "bound_ms": dma_stats["bound_ms"],
        "bound_by": dma_stats["bound_by"], "library_ms": None,
        "tflops": dma_stats["tflops"],
    })
    name, replaces, source = HOYER
    b2 = phased[f"nmfsc H_sparsity 0.6 {'x'.join(map(str, SPARSE_BASE[:2]))} r{SPARSE_BASE[2]}"]
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": phased["launches"],
        "launches_per_iter": b2["phased"]["launches_per_iter"],
        "launches_per_iter_default": b2["default"]["launches_per_iter"],
        "max_abs_err": hoyer_stats["max_abs_err"], "max_rel_err": hoyer_stats["max_rel_err"],
        "ms": hoyer_stats["ms"], "profiler_ms": hoyer_stats["profiler_ms"],
        "profiler_seen": hoyer_stats["profiler_seen"], "event_ms": hoyer_stats["event_ms"],
        "host_us": hoyer_stats["host_us"], "plain_ms": hoyer_stats["plain_ms"],
        "bound_ms": hoyer_stats["bound_ms"], "bound_by": hoyer_stats["bound_by"],
        "library_ms": None,
        "four_card_launches_per_rank": mesh_launches(
            f"nmfsc W_sparsity 0.5 H_sparsity 0.6 {GRAM[0]}x{GRAM[1]} r{GRAM[2]}", name),
    })
    mw, nw, kw = WEIGHTED
    for name, replaces in NAIVE_KL:
        s = naive_stats[name]
        row = {"name": name, "route": "cuda", "source": NAIVE_KL_SOURCE, "replaces": replaces,
               **s, "library_ms": None,
               "four_card_launches_per_rank": mesh_launches(f"nmf kl weights {mw}x{nw} r{kw}",
                                                            name)}
        if name == "kl_cost":
            row["launches_unweighted"] = main_path["kl"]["naive_launches"][name]
        kernels.append(row)
    say(card())  # again, where the tail of a long log keeps it
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
