#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cyten_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout, holds each against its
plain PyTorch version on the card, drives the port's main paths (U(1) Heisenberg
two-site DMRG: HeisenbergModel -> SimpleMPS -> DMRGEngine.run, dynamic and then in
static mode, with checkpoints, rollback and excited states; and the port's bench step,
cyten_tpu_torch.bench) at the full width of
the repo's production setting, SU(2) Heisenberg DMRG and the Fibonacci golden chain on
the fusion-tree backend, the models layer (sites, couplings, CouplingModel,
SpinChainModel, mpo_from_terms) on spin-1/2, spin-1 and J1-J2 chains, and fermions
(FermiHubbardModel, KitaevChainModel, hopping with a next-nearest term) with the
Ising-anyon chain, one-site DMRG (DMRG1SEngine) and the infinite chain (iDMRGEngine,
MultiCellIDMRGEngine, the infinite MPS's canonical forms and correlation length), and
time evolution (TEBDEngine, TDVPEngine, TDVP2Engine, TDVPQREngine with its fused site
steps replayed as CUDA graphs, iTDVPEngine, VUMPSEngine),
checks the energies, and ends with one JSON line
naming the device. Exits non-zero, with no result, when CUDA is absent or any phase
fails. Imports nothing of JAX or cyten_tpu.

    python3 chip_smoke.py --kernels-only   # phases 1, 2, 2b and 6, then stop
    python3 chip_smoke.py --su2-only       # phases 1, 2, 2b and 11, then stop
    python3 chip_smoke.py --golden-only    # phases 1, 2, 2b and 12, then stop
    python3 chip_smoke.py --bench-only     # phases 1 to 7b (7b with its plain-list
                                           # re-sweeps), 10 and 13, then stop
    python3 chip_smoke.py --engine-only    # phases 1, 2, 2b, 4 and 14, then stop
    python3 chip_smoke.py --models-only    # phases 1, 2, 2b and 15, then the kernels
                                           # line of phase 15 and the device line
    python3 chip_smoke.py --fermions-only  # phases 1, 2, 2b and 16 at full width, then
                                           # the kernels line of phase 16 and the
                                           # device line
    python3 chip_smoke.py --infinite-only  # phases 1, 2, 2b and 17 at full width, then
                                           # the kernels line of phase 17 and the
                                           # device line
    python3 chip_smoke.py --evolution-only # phases 1, 2, 2b and 18 at full width, then
                                           # the kernels line of phase 18 and the
                                           # device line
    python3 chip_smoke.py --steady-ab      # phase 1, then steady_ab, then stop
    python3 chip_smoke.py --against OLD.cu # the grouped GEMM against another build
                                           # of it in turns (ab_run: lists, bench
                                           # steps, replayed sweeps), then stop

The full run takes phases 11, 12 and 13 at less depth than --su2-only, --golden-only
and --bench-only do, to stay inside its time limit with phases 14 to 16: SU(2) and the
golden chain without the eager static sweep before their graphs and without the
profile of a replayed sweep, SU(2) without the profile of a dynamic bond and the eager
bench step, the golden chain without L=6 and 8; the bench without its own JSON line (so
without the chi=8192 ladder and the SVD timings) and without the Hubbard and dense
matvec timings, the ceilings measured in the phase; phase 10 runs with --bench-only.
The thin form's crossover (phase 2c) runs with --kernels-only alone. Phase 15 takes
the spin-1 chain at L=10 alone, swept until converged (--models-only adds (a), the
CouplingModel Heisenberg chain at L=24, and the spin-1 chain at L=32 at chi 1024,
dynamic and static) and the J1-J2 chain at L=32, chi_max=16 (--models-only: L=64,
chi_max 64); phase 14 leaves out the child process's resume, the precision
escalation on an f32 copy and the excited state (--engine-only keeps them); phase 7b
leaves out its eager re-sweeps with the mixed kind's lists and with every list on
their plain versions (--bench-only keeps them). Phase 16 takes the Hubbard chain at L=8 and the
Kitaev chain at L=32 (--fermions-only: L=32 at chi_max=1024 with a profile of its
replayed sweep, and L=64). Phase 17 takes one-site DMRG on the TFI chain at L=8 and
iDMRG on the infinite TFI chain at chi 32 (--infinite-only: (a) to (f) at full width in
their place). Phase 18 takes the TFI chain at L=8 and the infinite TFI chain at chi 16
(--evolution-only: (a) to (e) at full width in their place).

Phases:
  1. card name and power limit; kernel build time and each kernel's -Xptxas -v
     report (registers, shared memory, spills); the grouped GEMM's SASS holds
     DMMA (f64, complex128 at both tiles) and HGMMA (bf16, TF32, the bf16 pass and
     the mixed kind's three bf16 passes: wgmma), and no HMMA in TF32 and no FFMA in
     the mixed kind, and every thin form FFMA or DFMA and no tensor-core
     instruction, checked with cuobjdump where the toolkit has it; the host-sync
     counter's count on a function that does nothing (the first count in a process
     holds one sync that PyTorch reports at torch/cuda/__init__.py)
  2. grouped GEMM against its plain version: the pair lists of
     tests/test_pallas_grouped.py, the ragged lists of
     tests/test_torch_grouped_gemm.py, and the chi=4096 tdot(LP, theta) on the
     bench.py build_workload structure, in f64, f32 and bf16. Each prints the
     wrapper's time (ms), the kernel alone launched on tables built once
     (device_ms) and a per-pair torch.matmul loop (library_ms), timed in turns
     with the spread of each, the plain version's time and the bound
  2c. the grouped GEMM's converting kinds against their plain versions on the ragged
     lists and the chi=4096 list: TF32 ('tensorfloat32'), one bf16 pass ('default')
     and mixed bf16 x f32 at each precision, held to K 2^-23 |A||B| (their products
     are exact, their sums in another order; bias and rms: the kernel's and the
     plain version's sums against the exact f64 sums, sum_bias); the bound of the
     mixed kind its bf16 passes on the tensor cores (mixed_ops_s); library_ms a
     per-pair torch.matmul under TF32, on bf16-cast operands, or with the bf16
     operand widened per call.
     TF32, the bf16 pass and the mixed kind also on the lists their raw staging
     must get right (staged_hard_lists: unaligned bases with odd pitches, ragged K
     with K = 0 pairs and shared outputs, TF32 operands just above the rounding
     midpoint; the mixed kind's mixed_lists: f32 values whose low bits only its mid
     and lo pieces carry, K of 4100 and 5000, every mix of f32 and bf16 pair by
     pair, values from 2^-118 to 2^-108; a list with an f32 x f32 pair runs the f32
     kind), TF32 and the bf16 pass at each of their two tiles (STAGED_WIDTHS), the
     mixed kind at its one, whose sums may lean toward zero by at most MIXED_LEAN
     of their size (sum_bias, here and on every list of the kind), and at the
     chi=4096 list beside their
     device_ms of the register-staged form they replace (STAGED_BEFORE_MS); then
     each list of the chi=4096 bench step at every precision setting ('float32',
     'tensorfloat32', 'default', each with LP and RP in f32 and in bf16; f64; bf16
     work) and of one static SU(2) (f64) and golden-chain (complex128) bond update
     at 512 multiplets, as the main path plans it (step_list_phase): each thin list
     (the environment updates' contractions with W) held against its plain version,
     its device_ms beside bound_ms, library_ms and the kind's tiled form on the same
     list; at 'tensorfloat32' and 'default' the other lists' tile picked and time at
     each tile; the mixed kind's lists (at 'float32' with LP and RP bf16) held against
     their plain version at its one tile. Then the thin form against the
     tiled kinds on lists of growing depth and narrow side, f32, f64 and complex128
     (thin_crossover)
  2d. the grouped GEMM's complex128 kind against its plain version, held elementwise
     to 2 K 2^-52 |A||B|: the ragged lists with random complex operands, real x complex
     and complex x real (the real operand copied to complex128 by the wrapper), each at
     the tile (or thin form) picked and at both tiles, and the chi=4096 tdot(LP,
     theta) list made complex128; the form or tile of each list; library_ms a per-pair
     complex128 torch.matmul loop; bound at 8 real operations a complex multiply-add
     on the f64 tensor cores (67 TFLOP/s)
  2b. (and tridiag_evolve_phase: tridiagonal_evolve, csrc/tridiag.cu's second kernel,
     against its plain version on the same families, closed Krylov spaces among them,
     from f64 and f32 buffers at a real, an imaginary and a complex delta, to 1e-12 of
     the largest coefficient, NaN giving NaN; at N=30 its times, graph_ms, the plain
     version's, torch.linalg.matrix_exp's (library_ms) and torch.linalg.eigh's, the
     bound, and the host syncs of eigh and matrix_exp on the card)
     the tridiagonal kernel (csrc/tridiag.cu) against its plain version on the
     Lanczos families of tests/test_torch_tridiag.py (N=1; closing at every k;
     graded like a converged state's; a near-degenerate lowest pair; random N=10,
     20, 37 and 64), from f64 and f32 buffers: E to 1e-12 relative, the
     coefficients to 1e-10 where the lowest gap is at least 1e-8 |T|, else the
     residual to 1e-13 |T|; NaN input gives NaN. Its times at N=10 and 20 in turns
     beside torch.linalg.eigh and the probe kernel (the launch floor), and replayed
     from a CUDA graph (graph_ms), beside the bound
  3. L=12 Heisenberg DMRG, chi_max=64, against exact diagonalization (1e-9)
  4. L=24 Heisenberg DMRG at chi_max=1024, eps=0, N_max=10 (bench.py:1124-1145
     without bf16), swept until the centre bond holds chi=1024, against
     HEIS24_E_REF (1e-8), with the kernel counted; then the time of the centre
     bond by stage, the kernel at the centre pair list (also at each converting
     kind of 2c) with a host-time breakdown of one wrapper call, and one bond
     update under torch.profiler
  5. one effective-Hamiltonian matvec at chi=4096 in f32, card against CPU (1e-5)
  6. the probe kernel (csrc/probe.cu) against its plain version, bitwise, also on
     unaligned arrays with a tail; its times and the host cost of each piece of
     one call
  7. static mode on the converged L=24 engine of phase 4: one eager steady sweep
     against HEIS24_E_REF (1e-8) with every B right-isometric (1e-8); the centre
     bond's static update by stage, its host syncs and one static update under
     torch.profiler, and the tridiagonal kernel on its own Lanczos matrix (as in
     2b); then two sweep_static_batched() sweeps through CUDA graphs
     (same checks; the runs of _static_runs, graphs captured and capture seconds,
     launches counted through replays, host syncs of a batched sweep, peak reserved
     memory), the centre bond's graph replay under torch.profiler, and one more
     eager sweep that must agree with the graphs' energy (1e-10)
  7b. static mode with env_dtype=bfloat16 on the same engine, its state and MPO made
     f32, through graphs: every interior LP/RP bf16 after replayed sweeps; graphs
     captured anew after matmul_precision='default', and again after env_dtype=None
     with f32 environments (|dE| < 0.02 relative with bf16 environments, 1e-3 with
     f32 ones; each bf16 setting's |dE| beside the parent kernel's, PARENT_7B_DE);
     then the first 'default' sweep again from the state it started from, eager, on
     the kernel, and (--bench-only) with the mixed kind's lists on their plain
     version, and with every list on its plain version (lists_on_plain)
  8. the bench step (cyten_tpu_torch.bench.step_run) at chi=4096: steady in f32 and
     f64, eager and as a CUDA graph (CUDA-event times), exact in f32; one chi=1024
     f64 static step, card against CPU (E 1e-9 relative, S 1e-8); then
     step_decomposition()
  9. the bench step at chi=4096 in f32 at 'tensorfloat32' and at 'default', with
     env_dtype='bfloat16' (the mixed kind, at 'float32') and with
     work_dtype='bfloat16', eager and as a graph (each graph beside phase 8's f32
     graph step): ms,
     TFLOP/s, launches of each kind, E against the f32 'float32' step (within 0.05
     relative; every output of the bf16-work step bf16); the LP/RP bytes a matvec
     reads in f32 and in bf16
  10. (--bench-only) bench.accuracy_bf16work(chi=1024, L=24, n_bf16_sweeps=4):
     polished and raw bf16 dE against HEIS24_E_REF beside cyten_tpu's CPU figures
     (1.04e-5, 2.25e-3); the polished dE must stay below 1e-3
  11. SU(2) Heisenberg on the fusion-tree backend: L=8 against exact diagonalization
     (1e-9); L=24 at chi_max=512 multiplets, eps=0, N_max=10, from singlet pairs,
     swept dynamically until the centre bond holds 512 multiplets, against
     HEIS24_E_REF and phase 4's U(1) energy (1e-8), with the grouped GEMM counted,
     and one dynamic bond update under torch.profiler; static mode on it: one eager
     steady sweep (1e-8, B right-isometric), two sweep_static_batched() sweeps
     through CUDA graphs (the runs of _static_runs, period 2; graphs captured and
     capture seconds; grouped-GEMM and tridiagonal launches counted through
     replays; host syncs of a replayed sweep; one replayed sweep under
     torch.profiler), one eager sweep that must agree (1e-10); the centre bond's
     compose pair list (one pair per coupled sector) on the kernel against its plain
     version in f64, timed as in phase 2; one static bond update at 32 multiplets,
     card against CPU (E 1e-9 relative, S 1e-8); bench.su2_run and bench.su2_step at
     512 multiplets, eager and as a graph (ms, capture seconds)
  12. the Fibonacci golden chain on the fusion-tree backend, in c128 (its MPO is
     complex128, so every compose list runs on the complex128 kind): L=6, 8 and 10 at
     chi_max=16, eps=1e-13, against MPSKit.jl's energies (GoldenChainModel
     .EXACT_ENERGIES, 1e-9), L=10 then in static mode, two eager sweeps and two through
     graphs (1e-9); L=28 at chi_max=512 multiplets, eps=0, N_max=10, from fusion
     pairs, swept dynamically until the centre bond holds 512 multiplets, against
     GOLDEN28_E_REF (1e-9), one dynamic bond update under torch.profiler; static mode
     on it: one eager sweep, two sweep_static_batched() sweeps through graphs (runs,
     graphs and capture seconds, complex128 and tridiagonal launches through replays,
     host syncs of a replayed sweep, at most 1; one replayed sweep under
     torch.profiler), one eager sweep, each within 1e-10 of the dynamic energy (the
     eager one of the graphs') with every B right-isometric; the centre compose list
     on the complex128 kind, timed as in phase 2; bench.golden_run at 512 multiplets
  13. the rest of the port's bench (bench_phase): python -m cyten_tpu_torch.bench
     (its JSON line: the measured ceilings beside the data sheet's, the chi=8192
     ladder, the four SVD timings with their spreads); the grouped-GEMM lists of one
     U(1) x U(1) Hubbard matvec at chi=2048 at each kind of bench.HUBBARD_KINDS (f64,
     f32 at each precision, bf16 environments, bf16), of one padded chi=4096 bf16-work step and the chi=8192
     tdot(LP, theta) in f32 and bf16, each held to its plain version as in phase 2,
     its bound on the data sheet and on the measured ceilings; the Hubbard matvec
     through the kernel and through a torch.matmul per pair, eager and as a graph;
     the dense TFI matvec at chi=4096; the padded step as a graph; the chi=4096 graph
     steps of phases 8 and 9 with frac_peak and frac_roofline against the measured
     ceilings, each at most 1
  14. the rest of DMRGEngine (engine_phase) on phase 4's converged state (a copy taken
     at its end): (a) a checkpoint through CheckpointManager, synchronously and with
     async_save (seconds and bytes on disk, no more than the blocks and the tree),
     restored onto the card bitwise, one dynamic sweep of each engine to 1e-10; (b) a
     child python3 that resumes run(checkpoint=dir) and sweeps once, to 1e-8 of
     HEIS24_E_REF; (c) static mode with graphs, a NaN B, run(n_sweeps=3,
     checkpoint=...): the rollback, the old graphs released and new ones captured by
     two batched sweeps (1e-8, B right-isometric, reserved memory after empty_cache
     within 1.25x), then (--engine-only) on an f32 copy with env_dtype=bfloat16 the
     rollback that
     drops env_dtype (every LP/RP f32 after it, E to 1e-3 relative) and FaultError
     with no checkpoint; (d) the first excited state of Sz=0 (orthogonal_to=[phase 4's
     state]) against the Sz=1 ground state, both at chi_max=1024, eps=0, N_max=10, to
     1e-8 with overlap below 1e-8: the gap, mpo_variance of both (below 1e-6), the
     centre entropy, s/sweep and launches per sweep of both, and one projected bond
     update under torch.profiler with its host syncs. With --engine-only it also
     runs two static sweeps from the state after phase 4's centre-bond updates, which
     drift from HEIS24_E_REF (measured only; PERF.md §6)
  15. the models layer (models_phase), each run's launches of the grouped GEMM (its
     thin form apart) and the tridiagonal kernel counted: (a, --models-only) the
     spin-1/2 Heisenberg
     chain at L=24 from CouplingModel([SpinHalfSite('Sz')] * 24), heisenberg_coupling
     on every bond and build_H_mpo(), its MPO's bond dimensions those of the
     hand-built HeisenbergModel's; dynamic sweeps at chi_max=1024, eps=0, N_max=10
     until converged at chi 1024 from the product state, then three
     sweep_static_batched() sweeps (the
     first updates each bond structure eagerly, the second captures its graph, the
     third replays them), each to 1e-8 of HEIS24_E_REF; (b) SpinChainModel(S=1,
     'Sz'): L=10 against sparse exact diagonalization on the host (1e-9), dynamic and
     one static sweep (the tridiagonal kernel's launches in the full run), then, in
     the sector of total Sz = 1, L=32 at chi_max=1024, eps=0, N_max=10, dynamic until
     converged at chi_max, three static sweeps as in (a) to 1e-8 of the dynamic
     energy (the full run leaves L=32 out); mpo_variance, E/L beside the
     bulk HALDANE_E_PER_SITE (printed), s per dynamic and static sweep and the
     launches of each; the centre tdot(LP, theta) list on the kernel against plain,
     timed as in phase 2; (c) the J1-J2 chain at the Majumdar-Ghosh point (J2 = J1/2),
     L=64, from mpo_from_terms with nearest and next-nearest S.S terms (MPO bond
     dimension 11), chi_max=64 (the full run: L=32, chi_max=16), eps=0, swept until E
     changes by less than 1e-10: E = -3 L / 8 exactly (1e-8), thin-form launches
     counted; the largest W list of two
     bond updates (thin if one is) against its plain version, held elementwise to
     check_f64's bound and timed as in phase 2
  16. fermions and the Ising-anyon chain (fermions_phase), each kernel's launches
     counted over the phase: (a) FermiHubbardModel(L=8, t=1, U=4) (FermionNumber('N')
     x U1('2*Sz') on the fusion-tree backend) from half filling, chi_max=256,
     eps=1e-14, against sparse ED of the model's own bonds in the N=8, Sz=0 sector
     (4900 states, 1e-9); then static mode: one eager sweep, sweeps through CUDA
     graphs until one captures nothing (the replayed sweep), each within 1e-10 of the
     dynamic energy, at most one host sync a replayed sweep, the device constants held
     against _CONSTANTS_MAX and by the graphs; --fermions-only takes L=32 at
     chi_max=1024, eps=0, N_max=10 (at most 8 dynamic sweeps) to 1e-8, with
     mpo_variance, a replayed sweep under torch.profiler and a replay after the
     backend dropped every device constant and their memory was written over (the
     graphs keep what they read alive); (b) KitaevChainModel(L=32, t=1, delta=0.6,
     mu=0.4) (FermionParity) from the vacuum at chi_max 32 (--fermions-only: L=64,
     chi_max 64) against the BdG pair of exact_finite_gs_energy(parity='both') (1e-9:
     the even sector's energy is one of the two); (c) spinless fermions with t1 = 1 and
     t2 = 0.6 at L=16 from mpo_from_terms, chi_max=64, against the single-particle
     spectrum, and correlation_function(Cd, 0, C, 15) and (Cd, 7, C, 8) against the
     exact correlation matrix (1e-9); (d) the Ising-anyon chain at L=8, chi 16, against
     the ED built inside the framework on the card (full_chain_hamiltonian, eigh;
     1e-9); (e) the largest compose list of (a)'s centre bond update on the kernel
     against its plain version, held elementwise to check_f64's bound ([fermions e]:
     err_units, device_ms, bound_ms, library_ms, launches)

  17. one-site DMRG and the infinite chain (infinite_phase), each engine's launches of
     the grouped GEMM (its thin form apart) counted over the phase: the full run holds
     DMRG1SEngine on the parity TFI chain (L=8, g=1.2, chi_max 16, alpha 1e-2 decaying
     by 0.2 to 1e-10, five sweeps) to tfi_exact_finite_gs_energy (1e-10) and
     iDMRGEngine on the infinite parity TFI chain (g=1.5, chi_max 32) to
     tfi_exact_infinite_gs_energy (1e-9). --infinite-only runs in their place: (a)
     DMRG1SEngine on the U(1) Heisenberg chain at L=24, chi_max=1024, f64, from the
     Neel state (eps 1e-14, alpha 1e-3, alpha_decay 0.5, swept until E moves by less
     than 1e-10, at most 16 sweeps) to HEIS24_E_REF (1e-8), its chi, seconds and
     launches per sweep, and from the converged state one more one-site sweep beside
     one two-site dynamic sweep (N_max=10, the same eps); (b) DMRG1SEngine on the SU(2) chain at
     L=8, chi_max 24, with each mixer, to exact diagonalization (1e-9); (c) iDMRGEngine
     on the critical U(1) Heisenberg chain at chi_max=1024 (at most 120 steps, until
     e/site moves by less than 1e-10) to 1/4 - ln 2 (5e-5), its gap, seconds per step,
     steps and correlation_length() with its seconds; (d) the spin-1 Haldane chain at
     chi 48 to HALDANE_E_PER_SITE (1e-5), both methods of canonicalize_infinite on its
     cell with each B's isometry error (1e-10); (e) MultiCellIDMRGEngine on the uniform
     L=4 Heisenberg cell at chi 16 to the Bethe energy (2e-4); (f) MultiCellIDMRGEngine
     on the dimerized XX chain (J1 1, J2 0.6) at chi 32 to its band integral (1e-6).
     Then every f64 list of one one-site update (its expansion on) and one iDMRG step
     on the kernel against its plain version, held elementwise by check_f64, and the
     largest of each (and the largest thin list) timed as in phase 2
  18. time evolution (evolution_phase), the launches of the grouped GEMM and of
     tridiagonal_evolve counted over the phase (and the real operands of complex lists
     copied to complex, 'converted'): the full run holds, on the parity TFI chain at L=8
     (g=1.5) from a DMRG state at g=1, one real-time TDVPEngine step (dt 0.05) against
     exact evolution (overlap 1e-8, energy and norm 1e-10), one TDVP2Engine step from
     the all-up state (dt 0.1) likewise, six TEBD steps (dt 0.05) by the central <sz>
     (5e-4), and three fused TDVPQREngine steps (eager, capturing, replayed; N_max 12)
     against three eager ones (|a - b| / |a| of the state vectors, 1e-10), from the DMRG
     state made complex128; on the
     infinite chain at chi 16, two imaginary-time iTDVP steps and VUMPSEngine from the
     same cell, to tfi_exact_infinite_gs_energy (1e-12).
     --evolution-only runs in their place: (a) the L=24 U(1) Heisenberg ground state at
     chi_max=1024 (phase 4's sweeps) with Sz applied at site 12, made complex128, then
     EVOLUTION_STEPS real-time steps (dt 0.05) of TDVPEngine, TDVPQREngine and
     TDVPQREngine(fused=True; its first step eager, its second capturing) from it:
     energy and norm to 1e-8, the QR engine to the SVD engine by overlap (1e-8), the
     fused one to the eager QR one by overlap (1e-10) and by |a - b| / |a| from the three
     overlaps (1e-7: the overlaps' rounding sets a floor under it, printed beside it as
     the same measure between the eager QR state and itself regauged); seconds and
     launches a step, graphs and capture seconds, the host syncs of a replayed sweep
     (at most 1), a replayed sweep under torch.profiler, peak reserved memory; (b)
     TDVP2Engine from the Neel state at L=16, chi_max 256, dt 0.1 to t=2 against sparse
     exact evolution of the Sz=0 sector (12870 states; overlap and norm 1e-8); (c) TEBD from the all-up TFI chain at g=1:
     L=12 to t=1 by the central <sz> against exact evolution (5e-4), L=64 at chi_max
     512, dt 0.05, 40 steps (energy per site within 1e-3, truncation error, chi,
     seconds a step); (d) iTDVP on the infinite TFI chain (g=1.5) from iDMRG at chi_max
     256: ten imaginary-time steps (1e-12), then a quench to g=2.5, dt 0.02 to t=0.5
     (energy conserved to 1e-6; seconds and environment iterations a step); (e)
     VUMPSEngine.from_warm_start on the spin-1 Heisenberg chain at chi 128 to
     HALDANE_E_PER_SITE (1e-7), until the gradient norm is below 1e-6 (at most
     VUMPS_MAX_ITER iterations), the gradient norm of each. Then every f64 and c128 list of one fused TDVP site step, one TEBD bond and
     one iTDVP step on the kernel against its plain version (check_f64), the largest of
     each timed as in phase 2

--steady-ab runs the build, then steady_ab: the steady SVD with its QR against the
same SVD without it, in turns, on the L=24 chain's replayed sweep and the bench step.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
import weakref

import numpy as np

HEIS24_E_REF = -10.45378576040958  # bench.py:1121: f64 DMRG of L=24 at chi=512
HALDANE_E_PER_SITE = -1.401484038971  # S=1 bulk energy per site (White & Huse, PRB 48, 3844)
EVOLUTION_STEPS = 5  # phase 18 (a): real-time TDVP steps of each engine at chi 1024
VUMPS_MAX_ITER = 40  # phase 18 (e): VUMPS iterations on the spin-1 chain at chi 128
CHI_BENCH = 4096
# (rtol, atol) of the kernel against its plain version; the check is
# max|kernel - plain| <= atol + rtol * max|plain| over each output
TOLERANCES = {'float32': (2e-5, 2e-4), 'bfloat16': (2e-2, 0.)}
# ragged lists: name -> (shapes (M, K, N), out_ids), as in tests/test_torch_grouped_gemm.py
RAGGED = {
    'k_odd': ([(37, 131, 65), (64, 295, 40), (3, 1, 5)], [0, 1, 2]),
    'k_not_multiple_of_8': ([(130, 6, 70), (20, 10, 129), (129, 1462, 3)], [0, 1, 2]),
    'below_one_tile': ([(5, 3, 7), (1, 1, 1), (127, 15, 63), (2, 60, 127)], [0, 1, 2, 3]),
    'twenty_into_one': ([(70, k, 90) for k in range(1, 41, 2)], [0] * 20),
    'all_k_zero': ([(30, 0, 20), (30, 0, 20), (9, 4, 11)], [0, 0, 1]),
    # more table rows than fit in the launch's parameters
    'six_hundred_pairs': ([(9, 1 + k % 7, 5) for k in range(600)], [k // 2 for k in range(600)]),
}
# |dE| of phase 7b's settings with the parent kernel (PERF.md §5); ab_sweeps holds
# the two kernels' energies in one call
PARENT_7B_DE = {'env bf16, float32': 4.855e-3, 'env bf16, default': 6.010e-2}
PALLAS_SHAPES = [(37, 130, 65), (256, 128, 300), (5, 7, 9), (140, 260, 129),
                 (128, 128, 128), (128, 128, 128), (128, 128, 128), (1, 1, 1), (2, 300, 2)]


def hbm_bytes_per_s() -> float:
    """The H100 SXM's HBM rate of its data sheet (cyten_tpu_torch.bench.DATASHEET)."""
    from cyten_tpu_torch.bench import DATASHEET

    return DATASHEET['hbm_bytes_per_s']


def peak_ops_per_s(dtype, precision: str = None) -> float:
    """Dense peak of one H100 SXM for the kernel's arithmetic (data sheet,
    cyten_tpu_torch.bench.DATASHEET): f32 outside the tensor cores (67 TFLOP/s), bf16
    tensor cores (989.4), f64 tensor cores (67, also for complex128, whose real
    operations they run), and for an f32 result at 'tensorfloat32' the TF32 tensor
    cores (494.7) and at 'default' the bf16 ones. The mixed kind's rate depends on its
    pairs: mixed_ops_s."""
    import torch
    from cyten_tpu_torch.bench import DATASHEET

    if dtype == torch.float32 and precision in ('tensorfloat32', 'default'):
        return DATASHEET['tensorfloat32' if precision == 'tensorfloat32' else 'bfloat16']
    return DATASHEET[{torch.float64: 'float64', torch.float32: 'float32',
                      torch.bfloat16: 'bfloat16', torch.complex128: 'float64'}[dtype]]


def mixed_ops_s(PA, PB) -> float:
    """The least time of the mixed kind's products on the pair lists PA, PB: each
    pair's 2 M K N operations once for each bf16 pass it runs (three where one
    operand is f32, one where both are bf16) on the bf16 tensor cores (989.4
    TFLOP/s)."""
    import torch

    ops = sum(2 * A.shape[0] * A.shape[1] * B.shape[1]
              * (1 if A.dtype == B.dtype == torch.bfloat16 else 3) for A, B in zip(PA, PB))
    return ops / peak_ops_per_s(torch.bfloat16)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lp_theta_pairs(LP, theta):
    """The grouped-GEMM operands of the matvec's first contraction tdot(LP, theta):
    ``(As, Bs, pairs, out_id, n_out)``, each block once, as the backend passes them."""
    return LP.backend.tdot_operands(LP, theta, [LP.get_leg_idx('vR')],
                                    [theta.get_leg_idx('vL')])[:5]


def work_of(As, Bs, out_id, out_itemsize: int, complex_out: bool = False):
    """(operations, bytes) the grouped product of the pair lists ``As``, ``Bs`` must do
    and move: each distinct input matrix read once in its own dtype, each output
    written once (``out_itemsize`` bytes an element). A complex multiply-add counts
    as 8 real operations (``complex_out``)."""
    flops = sum(2 * A.shape[0] * A.shape[1] * B.shape[1] for A, B in zip(As, Bs))
    flops *= 4 if complex_out else 1
    inputs = {t.data_ptr(): t.numel() * t.element_size() for t in (*As, *Bs)}
    out_m = {o: (A.shape[0], B.shape[1]) for A, B, o in zip(As, Bs, out_id.tolist())}
    out_bytes = sum(m * n for m, n in out_m.values()) * out_itemsize
    return flops, sum(inputs.values()) + out_bytes


def check_rounded(label, got, ref, As, Bs, out_id, n_out, pairs, precision):
    """Kernel against plain for an f32 result of rounded operands: the two differ only
    by the order of their f32 sums, so each element is held to K_o * 2^-23 times the
    same product of the rounded operands' magnitudes (K_o: the summed depth of the
    output's pairs). Returns the largest error; raises past the bound."""
    import torch
    from cyten_tpu_torch.blocks import grouped_gemm as gg

    mag = gg.grouped_matmul_plain(
        [gg._rounded(A, precision).abs().double() for A in As],
        [gg._rounded(B, precision).abs().double() for B in Bs], out_id, n_out, pairs)
    ks = np.zeros(n_out)
    a_idx = range(len(out_id)) if pairs is None else pairs[0].tolist()
    np.add.at(ks, np.asarray(out_id), [As[i].shape[1] for i in a_idx])
    err = 0.
    for o, (c, r, m) in enumerate(zip(got, ref, mag)):
        if not c.numel():
            continue
        diff = (c.double() - r.double()).abs()
        if not bool((diff <= ks[o] * 2. ** -23 * m).all()):
            worst = float((diff - ks[o] * 2. ** -23 * m).max())
            raise AssertionError(f'{label}: kernel disagrees with plain past K 2^-23 |A||B| '
                                 f'(output {o}, by {worst})')
        err = max(err, float(diff.max()))
    return err


# how far the mixed kind's sums may lean toward zero, relative to their size (sum_bias):
# one accumulator over the whole depth leans by some K 2^-26 (-1.3e-5 at K = 4386 on
# the card, PERF.md §6), the kernel's sum of k slices by that of one slice (~1e-7)
MIXED_LEAN = 2. ** -20


def sum_bias(outs, As, Bs, out_id, n_out, pairs, precision):
    """``(bias, rms)`` of an f32 result ``outs`` against the f64 product of the same
    rounded operands (the exact sums): sum((C - exact) sign(exact)) / sum|exact|, below
    zero for sums that lean toward zero, and the relative root-mean-square error."""
    from cyten_tpu_torch.blocks import grouped_gemm as gg

    exact = gg.grouped_matmul_plain([gg._rounded(A, precision).double() for A in As],
                                    [gg._rounded(B, precision).double() for B in Bs],
                                    out_id, n_out, pairs)
    lean = sum(float(((c.double() - r) * r.sign()).sum()) for c, r in zip(outs, exact))
    err2 = sum(float(((c.double() - r) ** 2).sum()) for c, r in zip(outs, exact))
    size = sum(float(r.abs().sum()) for r in exact)
    norm2 = sum(float((r ** 2).sum()) for r in exact)
    return lean / size if size else 0., (err2 / norm2) ** 0.5 if norm2 else 0.


def check_f64(label, got, ref, As, Bs, out_id, n_out, pairs):
    """Kernel against plain for a float64 or complex128 result: each element is held to
    2 K_o 2^-52 (|A||B|)_ij, K_o the summed depth of the output's pairs and |A||B|
    the product of the operands' moduli (each side's f64 error is at most half of
    that, in whatever order it sums). A bound on each element, not on the largest
    output, so that sums which cancel are held as tightly as the rest. Returns the
    largest error and the largest in units of K_o 2^-52 (|A||B|)_ij (at most 2);
    raises past the bound."""
    from cyten_tpu_torch.blocks import grouped_gemm as gg

    mag = gg.grouped_matmul_plain([A.abs().double() for A in As],
                                  [B.abs().double() for B in Bs], out_id, n_out, pairs)
    ks = np.zeros(n_out)
    a_idx = range(len(out_id)) if pairs is None else pairs[0].tolist()
    np.add.at(ks, np.asarray(out_id), [As[i].shape[1] for i in a_idx])
    err = units = 0.
    for o, (c, r, m) in enumerate(zip(got, ref, mag)):
        if not c.numel():
            continue
        diff = (c - r).abs()
        unit = ks[o] * 2. ** -52 * m
        if not bool((diff <= 2 * unit).all()):
            worst = float((diff - 2 * unit).max())
            raise AssertionError(f'{label}: kernel disagrees with plain past 2 K 2^-52 '
                                 f'|A||B| (output {o}, by {worst})')
        err = max(err, float(diff.max()))
        live = unit > 0
        if bool(live.any()):
            units = max(units, float((diff[live] / unit[live]).max()))
    return err, units


def library_call(PA, PB, precision):
    """One PyTorch call per pair computing what the kernel's kind computes, as the
    yardstick (``library_ms``): a per-pair torch.matmul loop, under TF32 for
    'tensorfloat32', on operands cast to bf16 once with an f32 result for 'default',
    and with the bf16 operand widened per call for a mixed list ('float32')."""
    import torch

    if precision == 'tensorfloat32':
        def run():
            before = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return [torch.matmul(A.float(), B.float()) for A, B in zip(PA, PB)]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = before
        return run
    if precision == 'default':
        A16 = [A.to(torch.bfloat16) for A in PA]
        B16 = [B.to(torch.bfloat16) for B in PB]
        try:
            torch.mm(A16[0], B16[0], out_dtype=torch.float32)
            return lambda: [torch.mm(A, B, out_dtype=torch.float32) for A, B in zip(A16, B16)]
        except (TypeError, NotImplementedError, RuntimeError):  # no out_dtype: bf16 widened
            return lambda: [torch.mm(A, B).float() for A, B in zip(A16, B16)]
    return lambda: [torch.matmul(A.float(), B.float()) for A, B in zip(PA, PB)]


def compare_kernel(label, As, Bs, out_id, n_out, dtype, pairs=None, reps: int = 20,
                   rounds: int = 2, precision: str = None, b_dtype=None,
                   as_given: bool = False, width: str = None):
    """Kernel against plain on the card, then times in turns: the wrapper (``ms``),
    the kernel alone (``device_ms``: the C entry point launched on tables built
    once) and a per-pair torch.matmul loop (``library_ms``, see library_call); then
    the plain version. ``pairs`` as in grouped_matmul. The operands are made
    ``dtype``, those of B ``b_dtype`` where given (a mixed bf16 x f32 list); an f32
    result is computed at ``precision`` (config.matmul_precision while the wrapper
    plans, the plain version's argument) and held to check_rounded's bound, an f64 or
    complex one to check_f64's, the others (f32, bf16) to TOLERANCES. With ``as_given``
    the operands, already of those dtypes, are used as they lie (views whose rows
    start anywhere); ``width`` runs TF32 and the bf16 pass at that tile ('wide' or
    'narrow', grouped_matmul_plan's argument) in place of the one the wrapper picks.
    Raises if kernel and plain disagree."""
    import torch
    from cyten_tpu_torch.blocks.grouped_gemm import (
        grouped_matmul, grouped_matmul_plain, grouped_matmul_plan,
    )
    from cyten_tpu_torch.config import config

    b_dtype = dtype if b_dtype is None else b_dtype
    if not as_given:
        As = [A.to(dtype).contiguous() for A in As]
        Bs = [B.to(b_dtype).contiguous() for B in Bs]
    out_dtype = torch.promote_types(dtype, b_dtype)
    rounded = out_dtype == torch.float32 and (precision is not None or dtype != b_dtype)
    complex_out = out_dtype.is_complex
    name = ' x '.join(dict.fromkeys(str(t).split('.')[-1] for t in (dtype, b_dtype)))
    if rounded:
        name = f'{precision or "float32"} {name}'
    def wrapper():
        if width is None:
            return grouped_matmul(As, Bs, out_id, n_out, pairs)
        return grouped_matmul_plan(As, Bs, out_id, n_out, pairs, width)[1]()

    old = config.matmul_precision
    config.matmul_precision = precision or 'float32'
    try:
        got = wrapper()
        ref = grouped_matmul_plain(As, Bs, out_id, n_out, pairs, precision)
        torch.cuda.synchronize()
        err, units = 0., None
        if rounded:
            err = check_rounded(f'{label} {name}', got, ref, As, Bs, out_id, n_out, pairs,
                                precision)
            bias = (*sum_bias(got, As, Bs, out_id, n_out, pairs, precision),
                    *sum_bias(ref, As, Bs, out_id, n_out, pairs, precision))
        elif complex_out or out_dtype == torch.float64:
            if got and got[0].dtype != out_dtype:
                raise AssertionError(f'{label} {name}: the kernel gave {got[0].dtype}')
            err, units = check_f64(f'{label} {name}', got, ref, As, Bs, out_id, n_out, pairs)
        else:
            rtol, atol = TOLERANCES[name]
            for c, r in zip(got, ref):
                e = float((c.double() - r.double()).abs().max()) if c.numel() else 0.
                scale = float(r.double().abs().max()) if r.numel() else 0.
                if not e <= atol + rtol * scale:
                    raise AssertionError(f'{label} {name}: kernel disagrees with plain: '
                                         f'{e} > {atol} + {rtol} * {scale}')
                err = max(err, e)
        _, launch = grouped_matmul_plan(As, Bs, out_id, n_out, pairs, width)
        if getattr(launch, 'kind', None) == 'float32_mixed' and not abs(bias[0]) <= MIXED_LEAN:
            raise AssertionError(f'{label} {name}: the sums lean {bias[0]:.3e} of their size '
                                 f'toward zero, past {MIXED_LEAN:.3e}')
        # the pair lists, for the library loop and the work count
        PA = As if pairs is None else [As[i] for i in pairs[0].tolist()]
        PB = Bs if pairs is None else [Bs[i] for i in pairs[1].tolist()]
        if rounded:
            library = library_call(PA, PB, precision)
        elif dtype != b_dtype:  # real x complex: torch.matmul takes one dtype
            library = lambda: [torch.matmul(A.to(out_dtype), B.to(out_dtype))
                               for A, B in zip(PA, PB)]
        else:
            library = lambda: [torch.matmul(A, B) for A, B in zip(PA, PB)]
        (ms, device_ms, library_ms), spread = turns([wrapper, launch, library], reps, rounds)
        plain_ms = cuda_ms(lambda: grouped_matmul_plain(As, Bs, out_id, n_out, pairs,
                                                        precision))
    finally:
        config.matmul_precision = old
    flops, nbytes = work_of(PA, PB, out_id, got[0].element_size(), complex_out)
    if getattr(launch, 'kind', None) == 'float32_mixed':
        t_ops = mixed_ops_s(PA, PB)
    else:
        t_ops = flops / peak_ops_per_s(out_dtype, precision)
    t_bytes = nbytes / hbm_bytes_per_s()
    res = {'pairs': len(PA), 'outputs': n_out, 'tile': getattr(launch, 'tile', None),
           'form': getattr(launch, 'form', None),
           'gflop': flops / 1e9, 'mbytes': nbytes / 1e6,
           'max_abs_err': err, 'ms': ms, 'device_ms': device_ms, 'plain_ms': plain_ms,
           'library_ms': library_ms, 'spread': dict(zip(('ms', 'device_ms', 'library_ms'),
                                                        spread)),
           'bound_ms': max(t_ops, t_bytes) * 1e3,
           'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'}
    if units is not None:  # the largest error in units of K_o 2^-52 (|A||B|)_ij
        res['err_units'] = units
    if rounded:  # the sums against the exact ones: the kernel's, then the plain version's
        res.update(zip(('bias', 'rms', 'plain_bias', 'plain_rms'), bias))
    print(f'[kernel] {label} {name}: ' + json.dumps(res), flush=True)
    return res


# the converting kinds of the grouped GEMM: (precision, A dtype, B dtype), by the name
# of the kind they run; f32 x f32 at 'float32' is the f32 path of phase 2
def rounded_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    return [('tensorfloat32', f32, f32), ('tensorfloat32', bf16, f32),
            ('tensorfloat32', f32, bf16), ('default', f32, f32), ('default', bf16, f32),
            ('default', f32, bf16), (None, bf16, f32), (None, f32, bf16)]


# device_ms of the TF32, bf16-pass and mixed ('float32', precision None) kinds in their
# register-staged form, which the warp-specialised one replaced (PERF.md §6, this
# script's runs of that form), at the chi=4096 list: (precision, A dtype name) -> ms
STAGED_BEFORE_MS = {('tensorfloat32', 'float32'): 1.627, ('tensorfloat32', 'bfloat16'): 1.751,
                    ('default', 'float32'): 1.037, ('default', 'bfloat16'): 1.337,
                    (None, 'bfloat16'): 3.676}
# ... and at the L=24 centre list (chi=1024), LP bf16
CENTRE_BEFORE_MS = {('tensorfloat32', 'bfloat16'): 0.050, ('default', 'bfloat16'): 0.042,
                    (None, 'bfloat16'): 0.0792}


def misaligned(rng, rows, cols, pitch, dtype):
    """A [rows, cols] view on the card with row pitch ``pitch`` whose first element
    lies one element past an aligned address."""
    import torch

    buf = torch.from_numpy(rng.normal(size=rows * pitch + 1)).cuda().to(dtype)
    return buf[1:].view(rows, pitch)[:, :cols]


# the staged kinds' two tiles, as grouped_matmul_plan(width=) names them
STAGED_WIDTHS = ('wide', 'narrow')


def staged_hard_lists(rng, a_dtype, b_dtype, precision):
    """The lists the staged kinds' raw staging must get right (as in
    tests/test_torch_cuda.py): name -> (As, Bs, out_ids). Odd pitches with bases one
    element past alignment (K = 295); K not a multiple of BK = 32, K = 0 pairs,
    shared outputs, M < 64 and N < BN; for TF32 with f32 operands, values just above
    the rounding midpoint (low 13 bits 0x1001), where truncation would miss the
    bound; for the mixed kind (precision None, bf16 A) its own lists, mixed_lists."""
    import torch

    def dense(shapes):
        return ([torch.from_numpy(rng.normal(size=(M, K))).cuda().to(a_dtype)
                 for M, K, N in shapes],
                [torch.from_numpy(rng.normal(size=(K, N))).cuda().to(b_dtype)
                 for M, K, N in shapes])

    lists = {'odd_pitches': ([misaligned(rng, 150, 295, 297, a_dtype),
                              misaligned(rng, 37, 131, 133, a_dtype)],
                             [misaligned(rng, 295, 140, 143, b_dtype),
                              misaligned(rng, 131, 65, 67, b_dtype)], [0, 1])}
    shapes = [(40, 33, 100), (40, 0, 100), (40, 95, 100), (5, 1, 7), (5, 0, 7),
              (130, 64, 129)]
    lists['ragged'] = (*dense(shapes), [0, 0, 0, 1, 1, 2])
    if precision == 'tensorfloat32' and a_dtype == b_dtype == torch.float32:
        def midpoint(X):
            bits = X.abs().view(torch.int32)
            return ((bits & ~0x1FFF) | 0x1001).view(torch.float32)
        As, Bs = dense([(150, 295, 140), (70, 40, 90)])
        lists['midpoint'] = ([midpoint(A) for A in As], [midpoint(B) for B in Bs], [0, 1])
    if precision is None and a_dtype == torch.bfloat16:
        lists.update(mixed_lists(rng))
    return lists


def mixed_lists(rng):
    """The mixed kind's own lists, on the card, as tests/test_torch_cuda.py::mixed_lists
    makes them: name -> (As, Bs, out_ids). 'fine_bits': bf16 A against f32 B of values
    1 + j 2^-20, whose low bits only B's mid and lo pieces carry (one bf16 pass misses
    the bound there); 'deep': K = 4100 and 5000 summed into one output; 'per_pair':
    bf16 x f32, f32 x f32 (nine passes), bf16 x bf16 (one), f32 x bf16 in one list,
    shared outputs; 'tiny': f32 values from 2^-118 to 2^-108 on either side (the kernel
    splits them times 2^24)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests'))
    from test_torch_cuda import mixed_lists as lists

    return lists(rng, 'cuda')


def turns(fns, reps: int, rounds: int = 2):
    """CUDA-event ms per call of each of ``fns``, timed in ``rounds`` turns (the list,
    then the list reversed, and so on): the median of each over the turns, and its
    spread, (max - min) / median."""
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            times[i].append(cuda_ms(fns[i], reps))
    medians = [float(np.median(t)) for t in times]
    return medians, [(max(t) - min(t)) / m for t, m in zip(times, medians)]


def step_lists(precision: str, **kw) -> list:
    """The distinct grouped-GEMM lists that the bench step at chi=CHI_BENCH plans at
    ``precision`` (bench.step_run's warm-up and one step, with ``kw``: env_dtype,
    work_dtype, dtype), as bench.recorded_lists gives them."""
    from cyten_tpu_torch import bench

    return bench.recorded_lists(lambda: bench.step_run(CHI_BENCH, lengths=(1,), repeats=1,
                                                 precision=precision, **kw))


def fusion_step_lists(symmetry, workload, dtype) -> list:
    """The distinct grouped-GEMM lists of one static bond update on the fusion-tree
    backend at 512 multiplets (bench.build_step_state of ``workload``, in ``dtype``),
    as bench.recorded_lists gives them."""
    from cyten_tpu_torch import get_backend
    from cyten_tpu_torch.algorithms.dmrg import HEffective, _get_static_bond_fn
    from cyten_tpu_torch.bench import build_step_state, recorded_lists

    LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
        get_backend(symmetry, device='cuda'), 512, builder=workload, dtype=dtype)
    return recorded_lists(lambda: _get_static_bond_fn(10, 'steady')(
        HEffective(LP, RP, W1, W2), S, B1, B2, tmpl, None))


def list_name(As, Bs, pairs, count) -> str:
    """A pair list by its pairs, largest M, K and N, and operand dtypes."""
    PA = As if pairs is None else [As[i] for i in pairs[0].tolist()]
    PB = Bs if pairs is None else [Bs[i] for i in pairs[1].tolist()]
    return (f'x{count} {len(PA)} pairs, M {max(A.shape[0] for A in PA)}, K '
            f'{max(A.shape[1] for A in PA)}, N {max(B.shape[1] for B in PB)}, '
            f'{str(PA[0].dtype)[6:]} x {str(PB[0].dtype)[6:]}')


def step_settings():
    """The settings of the bench step whose lists step_list_phase reads: (name,
    matmul_precision, step_run keywords)."""
    from cyten_tpu_torch import Dtype

    bf16 = {'env_dtype': 'bfloat16'}
    return [('float32', 'float32', {}), ('tensorfloat32', 'tensorfloat32', {}),
            ('default', 'default', {}), ('env bf16, float32', 'float32', bf16),
            ('env bf16, tensorfloat32', 'tensorfloat32', bf16),
            ('env bf16, default', 'default', bf16),
            ('float64', 'float32', {'dtype': Dtype.float64}),
            ('work bf16', 'float32', {'work_dtype': 'bfloat16'})]


def staged_kind(As, Bs) -> bool:
    """Whether a list of these operands runs one of the staged kinds (TF32, the bf16
    pass, the mixed kind) at config.matmul_precision as it is now."""
    from cyten_tpu_torch.blocks import grouped_gemm as gg

    dtypes = {t.dtype for t in (*As, *Bs)}
    return gg._kind(dtypes, gg._common_dtype(dtypes))[0] in (
        'tensorfloat32', 'default', 'float32_mixed')


def step_list_phase() -> dict:
    """Each distinct list of the chi=CHI_BENCH bench step at every setting of
    step_settings, and of one static SU(2) (f64) and golden-chain (complex128) bond
    update at 512 multiplets, as the main path plans it ([step list] lines). A thin
    list is held against its plain version by compare_kernel, its device_ms beside
    bound_ms, library_ms and the device ms of the kind's tiled form on the same list;
    at 'tensorfloat32' and 'default' the other lists give the tile picked and the
    kernel's device ms at each of the two tiles (the data behind
    blocks/grouped_gemm.py::_TILE_MODEL); the mixed kind's (at 'float32' with LP and
    RP bf16) are held against their plain version by compare_kernel at its one tile,
    their sums' lean to MIXED_LEAN. Returns the compare_kernel
    results of the thin lists, by '<setting> <form>': of a form's lists, the one
    planned most often (a step's W contractions, not a list of the state's set-up),
    then the largest."""
    import torch
    from cyten_tpu_torch import fibonacci_anyon_category, su2_symmetry, Dtype
    from cyten_tpu_torch.bench import build_golden_workload, build_su2_workload
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul_plan
    from cyten_tpu_torch.config import config

    thin = {}
    sources = [(name, prec, lambda prec=prec, kw=kw: step_lists(prec, **kw))
               for name, prec, kw in step_settings()]
    sources += [('SU(2)', None, lambda: fusion_step_lists(su2_symmetry, build_su2_workload,
                                                          Dtype.float64)),
                ('golden', None, lambda: fusion_step_lists(
                    fibonacci_anyon_category, build_golden_workload, Dtype.complex128))]
    for setting, precision, lists in sources:
        for (prec, As, Bs, out_ids, n_out, pairs), count in lists():
            if precision is not None and prec != precision:  # an operator run at another
                continue                                     # precision
            name = f'{setting} {list_name(As, Bs, pairs, count)}'
            old = config.matmul_precision
            config.matmul_precision = prec
            try:
                launch = grouped_matmul_plan(As, Bs, out_ids, n_out, pairs)[1]
                staged = staged_kind(As, Bs)
                if launch.form is not None:
                    tiled = grouped_matmul_plan(As, Bs, out_ids, n_out, pairs, 'tiled')[1]
                    times, spread = turns([launch, tiled], 20)
                elif staged and prec != 'float32':  # TF32, the bf16 pass: two tiles
                    launches = [grouped_matmul_plan(As, Bs, out_ids, n_out, pairs, w)[1]
                                for w in STAGED_WIDTHS]
                    times, spread = turns(launches, 20)
            finally:
                config.matmul_precision = old
            if launch.form is None:
                if staged and prec != 'float32':
                    print(f'[step list] {name}: tile {launch.tile}, device ms wide '
                          f'{times[0]:.4f}, narrow {times[1]:.4f} (spreads {spread[0]:.3f}, '
                          f'{spread[1]:.3f})', flush=True)
                elif staged:  # the mixed kind (one tile), held to its plain version
                    compare_kernel(f'step list {name}', As, Bs, out_ids, n_out, As[0].dtype,
                                   pairs, b_dtype=Bs[0].dtype, as_given=True)
                continue
            rounded = prec in ('tensorfloat32', 'default')
            res = compare_kernel(f'step list {name}', As, Bs, out_ids, n_out, As[0].dtype,
                                 pairs, precision=prec if rounded else None,
                                 b_dtype=Bs[0].dtype, as_given=True)
            res['tiled_ms'], res['tiled_tile'] = times[1], tiled.tile
            print(f'[step list] {name}: thin {launch.form}, device_ms {res["device_ms"]:.4f} '
                  f'(as timed beside the tiled form {times[0]:.4f}, spread {spread[0]:.3f}), '
                  f'bound {res["bound_ms"]:.4f} ({res["bound_by"]}), library_ms '
                  f'{res["library_ms"]:.4f}, tiled {tiled.tile} {times[1]:.4f} (spread '
                  f'{spread[1]:.3f})', flush=True)
            key = f'{setting} {launch.form}'
            res['count'] = count
            if key not in thin or (count, res['mbytes']) > (thin[key]['count'],
                                                            thin[key]['mbytes']):
                thin[key] = res
        torch.cuda.empty_cache()
    return thin


# (K, narrow side) of the lists thin_crossover times
CROSSOVER = [(3, 3), (4, 4), (8, 8), (16, 16), (3, 16), (16, 3)]


def thin_crossover() -> None:
    """Where the thin form stops beating the tiled kinds ([crossover] lines: the data
    behind blocks/grouped_gemm.py::THIN_PICK_K and THIN_PICK_S): in f32 at 'float32',
    f64 and complex128, a tall list of two pairs [2^20, K] @ [K, S] summed into one
    output, and the wide list [S, K] @ [K, 2^20] alike, for each (K, S) of CROSSOVER:
    the device ms of the thin form and of the kind's tiled form, in turns, and the
    form the wrapper picks."""
    import torch
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul_plan
    from cyten_tpu_torch.config import config

    gen = torch.Generator(device='cuda').manual_seed(0)
    big = 1 << 20
    old = config.matmul_precision
    config.matmul_precision = 'float32'
    try:
        for dtype in (torch.float32, torch.float64, torch.complex128):
            for K, S in CROSSOVER:
                for form in ('tall', 'wide'):
                    a, b = ((big, K), (K, S)) if form == 'tall' else ((S, K), (K, big))
                    As = [torch.randn(a, dtype=dtype, device='cuda', generator=gen)
                          for _ in range(2)]
                    Bs = [torch.randn(b, dtype=dtype, device='cuda', generator=gen)
                          for _ in range(2)]
                    ids = np.zeros(2, np.int64)
                    picked = grouped_matmul_plan(As, Bs, ids)[1].form
                    thin, tiled = (grouped_matmul_plan(As, Bs, ids, width=w)[1]
                                   for w in ('thin', 'tiled'))
                    times, spread = turns([thin, tiled], 10)
                    print(f'[crossover] {str(dtype)[6:]} {form} K={K} S={S}: thin '
                          f'{times[0]:.4f}, tiled {tiled.tile} {times[1]:.4f} (spreads '
                          f'{spread[0]:.3f}, {spread[1]:.3f}); picked {picked or "tiled"}',
                          flush=True)
                    del As, Bs, thin, tiled
            torch.cuda.empty_cache()
    finally:
        config.matmul_precision = old


_THIN_FORM = None  # blocks/grouped_gemm.py::_thin_form, while another build is routed


def route_grouped_gemm(lib) -> None:
    """Plans made from now on launch the grouped GEMM of the ctypes library ``lib``
    (None: this tree's build). A build without the narrow codes runs a list of a kind
    of two widths at its wide tile; a build without the thin forms runs every list at
    its kind's tile (no list is taken to be thin)."""
    import ctypes
    from cyten_tpu_torch.blocks import _kernels, grouped_gemm as gg

    global _THIN_FORM
    if _THIN_FORM is None:
        _THIN_FORM = gg._thin_form
    lib = lib or _kernels.library('grouped_gemm')
    fns = {}
    for symbol, (argtypes, restype) in _kernels._SIGNATURES['grouped_gemm'].items():
        fn = fns[symbol] = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
    info = fns['cyten_grouped_gemm_info']
    probe = (ctypes.c_int64 * 3)()

    def has(code):
        return info(code, ctypes.addressof(probe)) == 0

    lacks = {narrow: gg._KIND_CODE[kind] for kind, narrow in gg._NARROW_CODE.items()
             if not has(narrow)}
    thin = has(gg._THIN_BASE['tall'])
    gg._thin_form = _THIN_FORM if thin else (lambda *args: None)
    if lacks or not thin:
        def routed_info(code, out):
            if code >= gg._THIN_BASE['tall'] and not thin:  # bounds of no use
                return 0
            return info(lacks.get(code, code), out)
        fns['cyten_grouped_gemm_info'] = routed_info
    for symbol, fn in fns.items():
        _kernels._functions['grouped_gemm', symbol] = fn
    gg._kernel_info.cache_clear()
    gg._LAYOUTS.clear()


def converged(eng, full, max_sweeps: int) -> float:
    """Dynamic sweeps of ``eng`` until its energy moves by less than 1e-10 with
    ``full()`` true (the centre bond at chi_max), at most ``max_sweeps``; then one
    eager static sweep, which gives every bond the structure the graphs capture.
    Returns the dynamic energy."""
    E = None
    for _ in range(max_sweeps):
        E_new = eng.run(n_sweeps=1)
        done = E is not None and abs(E_new - E) < 1e-10 and full()
        E = E_new
        if done:
            break
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    eng.sweep()
    return E


def ab_sweeps(builds: dict, label: str, eng, n: int = 2) -> None:
    """Replayed static sweeps of ``eng`` on each build of ``builds`` in turns (old,
    new, new, old; [ab sweep]), each turn from the same state (the engine's B, S, LP
    and RP as they were, copied): the graphs captured anew on that build, then ``n``
    sweeps replayed and timed on the host clock, ended by a sync; the energy after
    each turn, the largest relative difference between the builds' energies and
    within a build's turns, and the launches of the last sweep by kind (thin: the
    thin forms)."""
    import torch
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul

    psi = eng.psi
    start = [[t.copy() for t in ts] for ts in (psi.Bs, psi.Ss, eng.LPs, eng.RPs)]
    seconds, energy, counts = {k: [] for k in builds}, {k: [] for k in builds}, {}
    for name in ('old', 'new', 'new', 'old'):
        psi.Bs, psi.Ss, eng.LPs, eng.RPs = ([t.copy() for t in ts] for ts in start)
        route_grouped_gemm(builds[name])
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
        eng.sweep_static_batched()  # captures this build's graphs
        torch.cuda.synchronize()
        for _ in range(n):
            for k in (*grouped_matmul.kinds.values(), grouped_matmul.thin):
                k.launches = 0
            t0 = time.perf_counter()
            E = eng.sweep_static_batched()
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
        energy[name].append(E)
        counts[name] = {k: v.launches for k, v in grouped_matmul.kinds.items() if v.launches}
        counts[name]['thin'] = grouped_matmul.thin.launches
    route_grouped_gemm(None)
    E_ref = abs(energy['old'][0])
    between = max(abs(a - b) for a in energy['old'] for b in energy['new']) / E_ref
    within = max(abs(v[0] - v[1]) for v in energy.values()) / E_ref
    print(f'[ab sweep] {label}: replayed sweep s ' + ', '.join(
        f'{k} {np.median(v):.4f} {[round(t, 4) for t in v]}' for k, v in seconds.items())
        + f'; E old {energy["old"]!r}, new {energy["new"]!r} (relative between the builds '
        f'{between:.3e}, within {within:.3e}); launches by kind old '
        f'{json.dumps(counts["old"])}, new {json.dumps(counts["new"])}', flush=True)


def ab_run(against: str) -> int:
    """``--against OLD.cu``: this tree's grouped GEMM against another version of
    csrc/grouped_gemm.cu with the same C interface (for example the parent commit's,
    ``git show HEAD~1:cyten_tpu_torch/csrc/grouped_gemm.cu > chip_checkout/old.cu``), in
    one process, each measurement on the builds in turns (old, new, new, old):
    - at 'tensorfloat32' and 'default', with bf16 environments at 'float32' and in
      f32 at 'float32', the chi=CHI_BENCH bench step as a CUDA graph ([ab step], ms),
      then each distinct list of the first two's step ([ab list]);
    - each thin list of the bench step at every other setting of step_settings and
      each list of the mixed kind ([ab list]), the bench's chi=1024 and chi=CHI_BENCH
      tdot(LP, theta) lists, LP in f32 and in bf16 (at 'float32' LP bf16 only: the
      mixed kind) ([ab tdot]), and the chi=CHI_BENCH list made complex128
      ([ab complex]): device ms, medians over four turns, spreads;
    - replayed static sweeps (ab_sweeps): U(1) L=24 at chi_max=1024 in f64, then in
      f32 with bf16 environments at 'float32' and 'default' (phase 7b's settings),
      SU(2) L=24 and the golden chain L=28 at 512 multiplets, and the golden centre
      compose list ([ab complex])."""
    import ctypes
    import torch
    from cyten_tpu_torch import Dtype, get_backend, u1_symmetry
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, GoldenChainModel, HEffective, HeisenbergModel, SimpleMPS,
    )
    from cyten_tpu_torch.bench import build_workload, step_run
    from cyten_tpu_torch.blocks import _kernels
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul_plan
    from cyten_tpu_torch.config import config

    out = _kernels.BUILD_DIR.parent / 'ab' / 'libgrouped_gemm_against.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-o', str(out),
                             against], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _kernels.build()
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f'nvcc failed for {against}:\n{log}')
    builds = {'old': ctypes.PyDLL(str(out)), 'new': None}

    def timed(As, Bs, out_ids, n_out, pairs, precision):
        launches, old = {}, config.matmul_precision
        config.matmul_precision = precision
        try:
            for name, lib in builds.items():
                route_grouped_gemm(lib)
                launches[name] = grouped_matmul_plan(As, Bs, out_ids, n_out, pairs)[1]
        finally:
            config.matmul_precision = old
            route_grouped_gemm(None)
        times, spread = turns(list(launches.values()), 20, 4)
        form = launches['new'].form or launches['new'].tile
        return ', '.join(f'{k} {t:.4f} ({s:.3f})' for k, t, s in zip(builds, times, spread)) + (
            f', new as {form}')

    for label, kw in (('tensorfloat32', {'precision': 'tensorfloat32'}),
                      ('default', {'precision': 'default'}),
                      ('env bf16, float32', {'env_dtype': 'bfloat16'}),
                      ('float32', {})):
        step_ms = {'old': [], 'new': []}
        for name in ('old', 'new', 'new', 'old'):
            route_grouped_gemm(builds[name])
            step_ms[name].append(step_run(CHI_BENCH, graph=True, **kw)[0] * 1e3)
        print(f'[ab step] chi={CHI_BENCH} {label} graph, ms: ' + ', '.join(
            f'{k} {np.mean(v):.3f} {[round(t, 3) for t in v]}' for k, v in step_ms.items()),
            flush=True)
        route_grouped_gemm(None)
    for setting, precision, kw in step_settings():
        for (prec, As, Bs, out_ids, n_out, pairs), count in step_lists(precision, **kw):
            old = config.matmul_precision
            config.matmul_precision = prec
            try:
                form = grouped_matmul_plan(As, Bs, out_ids, n_out, pairs)[1].form
                mixed = staged_kind(As, Bs) and prec == 'float32'
            finally:
                config.matmul_precision = old
            if prec == precision and (form is not None or mixed or (
                    not kw and prec in ('tensorfloat32', 'default'))):
                print(f'[ab list] {setting} {list_name(As, Bs, pairs, count)}, device ms '
                      f'(spread): {timed(As, Bs, out_ids, n_out, pairs, prec)}', flush=True)
        torch.cuda.empty_cache()
    backend = get_backend(u1_symmetry, device='cuda')
    for chi in (1024, CHI_BENCH):
        LP, RP, W1, W2, theta = build_workload(backend, chi, dtype=Dtype.float32)
        As, Bs, pairs, out_id, n_out = lp_theta_pairs(LP, theta)
        for precision in ('tensorfloat32', 'default', 'float32'):
            for a_dtype in (torch.float32, torch.bfloat16):
                if precision == 'float32' and a_dtype == torch.float32:
                    continue  # the f32 kind: not a converting one
                row = timed([A.to(a_dtype) for A in As], Bs, out_id, n_out, pairs, precision)
                print(f'[ab tdot] chi={chi} tdot(LP, theta) {precision} {str(a_dtype)[6:]} '
                      f'x float32, device ms (spread): {row}', flush=True)
        if chi == CHI_BENCH:
            cAs = [torch.complex(A.double(), torch.randn_like(A.double())) for A in As]
            cBs = [torch.complex(B.double(), torch.randn_like(B.double())) for B in Bs]
            print(f'[ab complex] chi={chi} tdot(LP, theta) complex128, device ms (spread): '
                  f'{timed(cAs, cBs, out_id, n_out, pairs, None)}', flush=True)
            del cAs, cBs
        del LP, RP, W1, W2, theta, As, Bs
    torch.cuda.empty_cache()

    # replayed static sweeps: U(1) L=24 f64, then phase 7b's bf16 environments
    L = 24
    model = HeisenbergModel(L=L, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2))
    eng = DMRGEngine(psi, model, chi_max=1024, eps=0., lanczos_options={'N_max': 10})
    converged(eng, lambda: psi.max_chi() == 1024, 6)
    ab_sweeps(builds, 'U(1) L=24 chi_max=1024 f64', eng)
    model.H_mpo = [W.to_dtype(Dtype.float32) for W in model.H_mpo]
    psi.Bs = [B.to_dtype(Dtype.float32) for B in psi.Bs]
    psi.Ss = [S.to_dtype(Dtype.float32) for S in psi.Ss]
    eng.env_dtype = Dtype.bfloat16
    eng.LPs = [eng.LPs[0].to_dtype(Dtype.float32),
               *(t.to_dtype(Dtype.bfloat16) for t in eng.LPs[1:])]
    eng.RPs = [*(t.to_dtype(Dtype.bfloat16) for t in eng.RPs[:-1]),
               eng.RPs[-1].to_dtype(Dtype.float32)]
    for precision in ('float32', 'default'):
        eng.matmul_precision = precision
        ab_sweeps(builds, f'U(1) L=24 env bf16, {precision}', eng)
    del eng, psi, model
    torch.cuda.empty_cache()
    # SU(2) L=24 and the golden chain L=28 at 512 multiplets
    for label, L, make in (('SU(2) L=24', 24, lambda: HeisenbergModel(L=24, conserve='SU(2)')),
                           ('golden L=28', 28, lambda: GoldenChainModel(28))):
        model = make()
        psi = (SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
               if label.startswith('SU') else
               SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend))
        eng = DMRGEngine(psi, model, chi_max=512, eps=0., lanczos_options={'N_max': 10})
        i = L // 2 - 1
        converged(eng, lambda: int(np.sum(psi.Ss[i + 1].leg.multiplicities)) == 512, 12)
        ab_sweeps(builds, f'{label} 512 multiplets', eng)
        if label.startswith('golden'):
            H = HEffective(eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
            As, Bs, pairs, out_id, n_out = su2_compose_pairs(H.LP, psi.get_theta2(i))
            print(f'[ab complex] golden L=28 centre compose(theta, LP), device ms (spread): '
                  f'{timed(As, Bs, out_id, n_out, pairs, None)}', flush=True)
        del eng, psi, model
        torch.cuda.empty_cache()
    return 0


def wrapper_breakdown(As, Bs, out_id, n_out, pairs, reps: int = 50) -> dict:
    """Host ms per call of each step of one grouped_matmul call, over ``reps`` calls:
    the steps of grouped_matmul_plan called here one by one (its device checks
    left out), then the launch."""
    import torch
    from cyten_tpu_torch.blocks import grouped_gemm as gg
    from cyten_tpu_torch.blocks._kernels import call, function

    fn = function('grouped_gemm', 'cyten_grouped_gemm')
    steps = ('prepare', 'casts', 'outputs', 'tables', 'upload', 'launch')
    t = dict.fromkeys(steps, 0.)
    torch.cuda.synchronize()
    for _ in range(reps):
        marks = [time.perf_counter()]
        (ua, ia, a, _, a_dt), (ub, ib, b, _, b_dt) = gg._pair_list(As, Bs, pairs)
        dtype = gg._common_dtype(a_dt | b_dt)
        kind, readable = gg._kind(a_dt | b_dt, dtype)
        code, inline_words, n, out_layout, table_layout, _ = gg._kind_layouts(
            a, ia, b, ib, out_id, n_out, dtype, kind, 0)
        marks.append(time.perf_counter())
        a_bf16 = gg._as_operands(ua, a, a_dt, dtype, readable)
        b_bf16 = gg._as_operands(ub, b, b_dt, dtype, readable)
        marks.append(time.perf_counter())
        _, flat = gg._outputs(out_layout, dtype, ua[0].device)
        marks.append(time.perf_counter())
        table = gg._fill_table(table_layout, a, ia, b, ib, flat.data_ptr(), a_bf16, b_bf16)
        marks.append(time.perf_counter())
        table_args, _ = gg._table_args(table, flat.device, inline_words)
        marks.append(time.perf_counter())
        call(fn, (code, *table_args, n, table_layout.n_tiles),
             flat.get_device(), 'grouped_gemm')
        marks.append(time.perf_counter())
        for step, t0, t1 in zip(steps, marks, marks[1:]):
            t[step] += (t1 - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def count_syncs(fn) -> int:
    """Host syncs that ``fn()`` makes, as torch.cuda.set_sync_debug_mode('warn')
    reports them (it sees syncs that PyTorch makes, not those inside a library).
    Leaves the source line of each in ``count_syncs.where``. The first count in a
    process holds one sync of PyTorch's own (phase 1 counts it on a function that
    does nothing)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()  # outside: PyTorch may report this sync once per process
    syncs = [w for w in caught if 'synchroniz' in str(w.message)]
    count_syncs.where = [f'{os.path.relpath(w.filename)}:{w.lineno}' for w in syncs]
    return len(syncs)


def assert_right_isometric(psi, tol: float):
    """Every B of psi but the first is right-isometric: M M^dag == 1 for M = B as
    [vL | p, vR]."""
    from cyten_tpu_torch.tensors import SymmetricTensor, compose, dagger, norm, permute_legs

    for i in range(1, psi.L):
        B = psi.Bs[i]
        M = permute_legs(B, codomain=['vL'], domain=['vR', 'p'])
        eye = SymmetricTensor.from_eye(M.codomain.factors, backend=B.backend, dtype=B.dtype)
        err = float(norm(compose(M, dagger(M)) - eye))
        if not err < tol:
            raise AssertionError(f'B[{i}] is not right-isometric: {err}')


def profile_run(label: str, fn, top: int = 8):
    """``fn()`` under torch.profiler: wall time, the device's busy share and the
    kernels that took the most device time. Reports what the trace holds and checks
    nothing: an empty device trace prints as 'not measured'. Returns the number of
    kernels traced (None if none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.count, getattr(e, 'self_device_time_total', 0.))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(t for _, _, t in kernels)
    if busy_us <= 0:
        print(f'[profile {label}] wall {wall_us / 1e3:.1f} ms; device time not measured',
              flush=True)
        return
    kernels.sort(key=lambda k: -k[2])
    print(f'[profile {label}] wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms '
          f'({100 * busy_us / wall_us:.1f} %), {sum(c for _, c, _ in kernels)} kernels',
          flush=True)
    for name, count, t in kernels[:top]:
        print(f'[profile {label}]   {t / 1e3:9.3f} ms  x{count:<5d} {name[:90]}', flush=True)
    profile_run.kernels = kernels  # (name, count, device us), the longest first
    return sum(c for _, c, _ in kernels)


def probe_phase() -> dict:
    """The probe kernel against its plain version (bitwise), at [256, 256] and on
    unaligned tails; its times beside the bound."""
    import torch
    from cyten_tpu_torch.blocks._kernels import call, function
    from cyten_tpu_torch.blocks.probe import scale2, scale2_plain

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(256, 256))).to('cuda', torch.float32)
    if not torch.equal(scale2(x), scale2_plain(x)):
        raise AssertionError('probe kernel disagrees with its plain version')
    y = torch.from_numpy(rng.normal(size=1031)).to('cuda', torch.float32)
    for t in (y, y[1:], y[3:1030]):  # n % 4 != 0, and arrays off 16-byte alignment
        if not torch.equal(scale2(t), scale2_plain(t)):
            raise AssertionError('probe kernel disagrees on an unaligned or ragged array')
    out = torch.empty_like(x)
    fn = function('probe', 'cyten_scale2')
    kernel = lambda: call(fn, (x.data_ptr(), out.data_ptr(), x.numel()), 0, 'scale2')  # noqa: E731
    (ms, device_ms, library_ms), spread = turns(
        [lambda: scale2(x), kernel, lambda: x * 2.0], 200, rounds=8)
    probe = {'max_abs_err': 0., 'ms': ms, 'device_ms': device_ms,
             'plain_ms': cuda_ms(lambda: scale2_plain(x), reps=500),
             'library_ms': library_ms,
             'spread': dict(zip(('ms', 'device_ms', 'library_ms'), spread))}
    # read x once, write o once; one multiply per element
    t_bytes = 2 * x.numel() * x.element_size() / hbm_bytes_per_s()
    t_ops = x.numel() / peak_ops_per_s(torch.float32)
    probe['bound_ms'] = max(t_bytes, t_ops) * 1e3
    probe['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
    print('[probe] [256, 256] f32, bitwise equal: ' + json.dumps(probe), flush=True)
    print('[probe] host us per call: ' + json.dumps(probe_breakdown(x, out, fn)), flush=True)
    return probe


def probe_breakdown(x, out, fn, reps: int = 2000) -> dict:
    """Host microseconds of each piece of one scale2 call, each timed alone."""
    import torch
    from cyten_tpu_torch.blocks import _kernels

    args = (x.data_ptr(), out.data_ptr(), x.numel())
    stream = torch.cuda.current_stream(0).cuda_stream
    pieces = {
        'checks': lambda: (x.is_cuda, x.dtype != torch.float32, x.is_contiguous()),
        'empty_like': lambda: torch.empty_like(x),
        'args': lambda: (x.data_ptr(), out.data_ptr(), x.numel(), x.get_device()),
        'current_stream (public)': lambda: torch.cuda.current_stream(0).cuda_stream,
        'raw_stream (used)': lambda: _kernels._current_stream(0),
        'ctypes_call': lambda: fn(*args, 0, stream),
        'x * 2.0': lambda: x * 2.0,
    }
    res = {}
    for name, f in pieces.items():
        f()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        res[name] = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return res


def tridiag_families():
    """``(FAMILIES, check_ground_state, valid_block)`` of tests/test_torch_tridiag.py:
    the Lanczos matrices the tridiagonal kernel must handle (N=1; closing at every k
    at N=10; graded like a converged state's; a lowest pair 1e-10 |T| apart, as a
    Lanczos ghost gives; random at N=10, 20, 37 and 64), the check that holds a
    result against a reference, and the valid leading block of a matrix."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests'))
    from test_torch_tridiag import FAMILIES, check_ground_state, valid_block

    return FAMILIES, check_ground_state, valid_block


def tridiag_errors(E, c, ab, E_ref, c_ref) -> dict:
    """The valid block's size m, |dE| and relative |dE|, max |dc|, the residual
    |T c - E c| / |T| and the lowest gap / |T| of the kernel's ``(E, c)`` against the
    plain ``(E_ref, c_ref)`` on the Lanczos matrix ``ab`` (its valid block T; numpy
    arrays)."""
    T, m = tridiag_families()[2](ab)
    evals = np.linalg.eigvalsh(T)
    norm_T = np.abs(evals).max()
    E, E_ref, c = float(E), float(E_ref), np.asarray(c, np.float64)
    return {'m': m, 'abs_dE': abs(E - E_ref), 'dE': abs(E - E_ref) / abs(E_ref),
            'dc': float(np.abs(c - np.asarray(c_ref)).max()),
            'residual': float(np.linalg.norm(T @ c[:m] - E * c[:m]) / norm_T),
            'gap': float((evals[1] - evals[0]) / norm_T) if m > 1 else None}


def check_tridiag(label, ab) -> dict:
    """The kernel against its plain version (on the CPU, where the fused Lanczos's
    tests run it) on the Lanczos matrix ``ab`` (a [2, N] tensor on the card): E to
    1e-12 relative; the coefficients to 1e-10 where the lowest gap is at least
    1e-8 |T|, else the residual to 1e-13 |T| (check_ground_state). Prints the errors;
    raises if they are out of bounds."""
    from cyten_tpu_torch.blocks.tridiag import (
        tridiagonal_ground_state, tridiagonal_ground_state_plain,
    )

    _, check_ground_state, _ = tridiag_families()
    E, c = tridiagonal_ground_state(ab)
    E, c = E.cpu(), c.cpu()
    E_ref, c_ref = tridiagonal_ground_state_plain(ab.cpu())
    abd = ab.cpu().double().numpy()
    err = tridiag_errors(E, c.numpy(), abd, E_ref, c_ref.numpy())
    print(f'[tridiag] {label} {str(ab.dtype).split(".")[-1]}: E {float(E)!r}, '
          + ', '.join(f'{k} {v:.3e}' if isinstance(v, float) else f'{k} {v}'
                      for k, v in err.items()), flush=True)
    check_ground_state(E, c.numpy(), abd, ref=(E_ref, c_ref.numpy()), label=label)
    return err


def graph_ms(launch, reps: int = 100) -> float:
    """Device ms per launch of ``launch`` (a raw C entry point call, no wrapper),
    ``reps`` launches captured in one CUDA graph and replayed: the kernel's own time
    and the gap between graph nodes, without the host's launch cost."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            launch()
    return cuda_ms(g.replay, reps=5) / reps


def tridiag_phase() -> dict:
    """The tridiagonal kernel against its plain version on every Lanczos family, from
    f64 and f32 buffers, and on NaN input; then, at N=10 and N=20 (f64), its times in
    turns beside torch.linalg.eigh of the built matrix and the probe kernel (the
    launch floor), and beside the bound. Returns the N=10 (the static sweeps'
    n_lanczos) numbers."""
    import torch
    from cyten_tpu_torch.blocks._kernels import call, function
    from cyten_tpu_torch.blocks.tridiag import (
        tridiagonal_ground_state, tridiagonal_ground_state_plain,
    )

    families = tridiag_families()[0]
    err = 0.
    for label, ab in families:
        for dtype in (torch.float64, torch.float32):
            e = check_tridiag(label, torch.from_numpy(ab).to('cuda', dtype))
            # the coefficients count where they are held to the plain version's
            err = max(err, e['abs_dE'], e['dc'] if e['gap'] is None or e['gap'] >= 1e-8
                      else 0.)
    nan_ab = torch.from_numpy(families[-1][1]).cuda()
    nan_ab[0, 3] = float('nan')
    E, c = tridiagonal_ground_state(nan_ab)
    if not (torch.isnan(E) and torch.isnan(c).all()):
        raise AssertionError('tridiag kernel: NaN input did not give NaN output')
    print('[tridiag] NaN input: every output NaN', flush=True)

    x = torch.ones(256, 256, device='cuda', dtype=torch.float32)
    x_out = torch.empty_like(x)
    probe_fn = function('probe', 'cyten_scale2')
    probe = lambda: call(probe_fn, (x.data_ptr(), x_out.data_ptr(), x.numel()), 0,  # noqa: E731
                         'scale2')
    fn = function('tridiag', 'cyten_tridiag_ground_state')
    results = {}
    for n in (10, 20):
        ab = torch.from_numpy(dict(families)[f'random N={n}']).cuda()
        out = torch.empty(n + 1, dtype=torch.float64, device='cuda')
        kernel = lambda: call(fn, (ab.data_ptr(), 0, n, out.data_ptr()), 0, 'tridiag')  # noqa: E731
        a, b = ab
        T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
        (ms, device_ms, library_ms, probe_ms), spread = turns(
            [lambda: tridiagonal_ground_state(ab), kernel, lambda: torch.linalg.eigh(T),
             probe], 50, rounds=4)
        res = {'N': n, 'max_abs_err': err, 'ms': ms, 'device_ms': device_ms,
               'plain_ms': cuda_ms(lambda: tridiagonal_ground_state_plain(ab), reps=20),
               'library_ms': library_ms, 'probe_device_ms': probe_ms,
               'graph_ms': graph_ms(kernel), 'probe_graph_ms': graph_ms(probe),
               'spread': dict(zip(('ms', 'device_ms', 'library_ms', 'probe_device_ms'),
                                  spread))}
        # read 2N f64, write N + 1. The work the function needs: one eigenvalue to f64
        # precision by bisection on Sturm counts (53 halvings of N pivot steps of 3
        # operations) and its vector by one twisted factorisation (about 10 N)
        t_bytes = (3 * n + 1) * 8 / hbm_bytes_per_s()
        t_ops = (53 * 3 * n + 10 * n) / peak_ops_per_s(torch.float64)
        res['bound_ms'] = max(t_bytes, t_ops) * 1e3
        res['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
        print(f'[tridiag] N={n}: ' + json.dumps(res), flush=True)
        results[n] = res
    return results[10]


# kernel policy (its mangled name) -> the SASS instruction its products must run on
# (TF32 and the bf16 pass at each width: TF32Pass<256>, TF32Pass<128>, ...; the mixed
# kind's one, F32WPass; complex128 at each tile: ComplexTile<128>, ComplexTile<64>)
SASS_OPS = {'3F64': 'DMMA', '4BF16': 'HGMMA', '3F32': 'FFMA',
            '8TF32PassILi256': 'HGMMA', '8TF32PassILi128': 'HGMMA',
            '8BF16PassILi256': 'HGMMA', '8BF16PassILi128': 'HGMMA',
            '8F32WPassE': 'HGMMA', '11ComplexTileILi128E': 'DMMA', '11ComplexTileILi64E': 'DMMA'}
# ... and the instructions it must not hold: TF32 runs on wgmma, not mma.sync (HMMA);
# the mixed kind's products are its bf16 passes on wgmma, none on the FMA pipes (FFMA)
SASS_ABSENT = {'8TF32PassILi256': 'HMMA', '8TF32PassILi128': 'HMMA',
               '8F32WPassE': 'FFMA'}
# the thin forms (seven kinds, two forms, two table paths) run on the CUDA cores' FMA
# pipes and hold no tensor-core instruction
THIN_KERNELS = 28
TENSOR_CORE_OPS = ('DMMA', 'HGMMA', 'HMMA')


def check_sass(kernels):
    """The SASS of each kind of the grouped GEMM holds the instruction its products
    must run on (SASS_OPS: DMMA for f64 and complex128, HGMMA for bf16, TF32, the bf16
    pass and the mixed kind, FFMA for f32) and none of SASS_ABSENT's (no HMMA in TF32,
    no FFMA in the mixed kind), and each of
    the THIN_KERNELS thin forms FFMA or DFMA and no tensor-core instruction, by
    cuobjdump where the toolkit has it; raises if one is missing or one is found."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        print('[sass] cuobjdump not found: the instructions are not checked', flush=True)
        return
    sass = subprocess.run([tool, '-sass', str(kernels._lib_path('grouped_gemm'))],
                          capture_output=True, text=True, check=True).stdout
    found, thin = {}, []
    for part in sass.split('Function : ')[1:]:
        name = part.split(None, 1)[0]
        if 'grouped_gemm_thin' in name:
            thin.append(('FFMA' in part or 'DFMA' in part)
                        and not any(op in part for op in TENSOR_CORE_OPS))
            continue
        for policy, op in SASS_OPS.items():
            if policy in name:
                absent = SASS_ABSENT.get(policy)
                found[policy] = (op, op in part and not (absent and absent in part))
    print(f'[sass] {json.dumps(found)}; thin forms on FFMA or DFMA without tensor cores: '
          f'{sum(thin)} of {len(thin)}', flush=True)
    if (sorted(found) != sorted(SASS_OPS) or not all(ok for _, ok in found.values())
            or len(thin) != THIN_KERNELS or not all(thin)):
        raise AssertionError(f'the grouped GEMM kinds do not run on {SASS_OPS} '
                             f'without {SASS_ABSENT}, or a thin form on tensor cores')


def su2_compose_pairs(LP, theta):
    """The grouped-GEMM operands of a fusion-tree matvec's first compose (SU(2) or
    the golden chain), inside
    tdot(theta, LP, 'vL', 'vR'), as the fusion-tree backend passes them: the
    permuted theta's and LP's blocks, ``(As, Bs, pairs, out_id, n_out)`` with one
    pair and one output per coupled sector."""
    from cyten_tpu_torch.backends.fusion_tree import _compose_pairs
    from cyten_tpu_torch.tensors import permute_legs

    t1 = permute_legs(theta, codomain=['p0', 'p1', 'vR'], domain=['vL'])
    t2 = permute_legs(LP, codomain=['vR'], domain=['wR', 'vR*'])
    a, b = t1.data.block_inds, t2.data.block_inds
    ia, ib, rows = _compose_pairs(a.tobytes(), len(a), b.tobytes(), len(b))
    return t1.data.blocks, t2.data.blocks, (ia, ib), np.arange(len(rows)), len(rows)


def su2_phase(E24, deep: bool = True) -> dict:
    """Phase 11: SU(2) Heisenberg on the fusion-tree backend (see the module
    docstring). ``E24``: phase 4's U(1) energy (None where phase 4 did not run).
    Returns the numbers of its kernels-line entry."""
    import torch
    from cyten_tpu_torch import get_backend, su2_symmetry
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, HEffective, HeisenbergModel, SimpleMPS,
        heisenberg_exact_finite_gs_energy,
    )
    from cyten_tpu_torch.algorithms.dmrg import _get_static_bond_fn
    from cyten_tpu_torch.bench import build_step_state, build_su2_workload, su2_run, su2_step
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.torch_backend import _CONSTANTS_MAX
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_ground_state

    # L=8 against exact diagonalization: the BASELINE.md anchor
    model = HeisenbergModel(L=8, conserve='SU(2)')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, 8, backend=model.backend)
    E8 = DMRGEngine(psi, model, chi_max=16).run(n_sweeps=6)
    E8_exact = heisenberg_exact_finite_gs_energy(8, 1.)
    print(f'[SU(2) L=8] E = {E8!r}, exact {E8_exact!r}, |dE| = {abs(E8 - E8_exact):.3e}',
          flush=True)
    if not abs(E8 - E8_exact) < 1e-9:
        raise AssertionError('SU(2) L=8 DMRG energy wrong')

    # L=24 at 512 multiplets from singlet pairs, dynamic until the centre bond is full
    L, chi_max = 24, 512
    model = HeisenbergModel(L=L, conserve='SU(2)')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=0., lanczos_options={'N_max': 10})
    i = L // 2 - 1

    def centre_mult():
        return int(np.sum(psi.Ss[i + 1].leg.multiplicities))

    grouped_matmul.launches = 0
    tridiagonal_ground_state.launches = 0
    E = None
    dyn_s = []
    for sweep in range(12):
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        dyn_s.append(time.perf_counter() - t0)
        print(f'[SU(2) L=24] sweep {sweep + 1}: E = {E_new!r}, {dyn_s[-1]:.2f} s, centre '
              f'bond {centre_mult()} multiplets, {int(psi.Ss[i + 1].leg.dim)} states',
              flush=True)
        converged = E is not None and abs(E_new - E) < 1e-10
        E = E_new
        if converged and centre_mult() == chi_max:
            break
    launches = grouped_matmul.launches
    dE_u1 = None if E24 is None else abs(E - E24)
    print(f'[SU(2) L=24] E = {E!r}, ref {HEIS24_E_REF!r}, |dE| = {abs(E - HEIS24_E_REF):.3e}, '
          f'|E - E(U(1), phase 4)| = {dE_u1}, grouped-GEMM launches {launches}, sweep s '
          f'{json.dumps(dyn_s)}', flush=True)
    if not (abs(E - HEIS24_E_REF) < 1e-8 and (dE_u1 is None or dE_u1 < 1e-8)
            and launches > 0 and centre_mult() == chi_max):
        raise AssertionError('SU(2) L=24 DMRG energy, width or kernel launches wrong')
    if deep:
        profile_run(f'SU(2) dynamic bond {i}', lambda: eng.update_bond(i))

    # static mode: one eager steady sweep (deep only), two through graphs, one eager
    # after
    eager_s = []
    if deep:
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
        t0 = time.perf_counter()
        E_static = eng.sweep()
        torch.cuda.synchronize()
        eager_s = [time.perf_counter() - t0]
        print(f'[SU(2) static] eager sweep 1: E = {E_static!r}, {eager_s[-1]:.2f} s',
              flush=True)
        if not abs(E_static - HEIS24_E_REF) < 1e-8:
            raise AssertionError('SU(2) static-mode energy wrong')
        assert_right_isometric(psi, 1e-8)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    print(f'[SU(2) graphs] runs of _static_runs: {eng._static_runs()}', flush=True)
    graph_s = []
    for sweep in range(2):
        grouped_matmul.launches = 0
        grouped_matmul.thin.launches = 0
        tridiagonal_ground_state.launches = 0
        t0 = time.perf_counter()
        E_graph = eng.sweep_static_batched()
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
        sweep_launches = grouped_matmul.launches
        tridiag_launches = tridiagonal_ground_state.launches
        print(f'[SU(2) graphs] batched sweep {sweep + 1}: E = {E_graph!r}, '
              f'{graph_s[-1]:.2f} s, grouped-GEMM launches {sweep_launches} (thin form '
              f'{grouped_matmul.thin.launches}), tridiag launches {tridiag_launches}',
              flush=True)
    graphs = eng.static_graphs()
    syncs = count_syncs(eng.sweep_static_batched)
    constants = len(model.backend.block_backend._constants)
    print(f'[SU(2) graphs] {len(graphs)} graphs captured in '
          f'{sum(g.capture_seconds for g in graphs):.2f} s; device constants held '
          f'{constants} (cap {_CONSTANTS_MAX}); launches per replayed sweep: '
          f'grouped GEMM {sweep_launches}, tridiag {tridiag_launches}; host syncs of a '
          f'replayed sweep {syncs} (at {count_syncs.where}); sweep s eager '
          f'{json.dumps(eager_s)}, graphs {json.dumps(graph_s)}', flush=True)
    if not (abs(E_graph - HEIS24_E_REF) < 1e-8 and sweep_launches > 0
            and tridiag_launches > 0 and graphs and syncs <= 1):
        raise AssertionError('SU(2) batched static sweeps: energy, launches or syncs wrong')
    if deep:
        profile_run('SU(2) replayed sweep', eng.sweep_static_batched, top=8)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    E_eager = eng.sweep()
    print(f'[SU(2) graphs] eager sweep after: E = {E_eager!r}, |E - E_graphs| = '
          f'{abs(E_eager - E_graph):.3e}', flush=True)
    if not abs(E_eager - E_graph) < 1e-10:
        raise AssertionError('the eager SU(2) static sweep disagrees with the graphs')
    assert_right_isometric(psi, 1e-8)

    # the centre bond's compose pair list on the kernel
    H = HEffective(eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
    As, Bs, pairs, out_id, n_out = su2_compose_pairs(H.LP, psi.get_theta2(i))
    compose = compare_kernel(f'SU(2) L=24 centre compose(theta, LP) {chi_max} multiplets',
                             As, Bs, out_id, n_out, torch.float64, pairs, rounds=8)
    del eng, psi, model, H, As, Bs
    torch.cuda.empty_cache()

    # one SU(2) bond update at small chi: the same host-drawn state on card and CPU
    out = {}
    for device in ('cuda', 'cpu'):
        LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
            get_backend(su2_symmetry, device=device), 32, builder=build_su2_workload)
        out[device] = _get_static_bond_fn(10, 'steady')(HEffective(LP, RP, W1, W2), S,
                                                         B1, B2, tmpl, None)
    (E_card, _, S_card, *_), (E_cpu, _, S_cpu, *_) = out['cuda'], out['cpu']
    E_card, E_cpu = float(E_card), float(E_cpu)
    dE = abs(E_card - E_cpu) / abs(E_cpu)
    dS = float(np.abs(S_card.to_numpy() - S_cpu.to_numpy()).max())
    print(f'[SU(2) step 32 multiplets f64] card against CPU: E {E_card!r} vs {E_cpu!r} '
          f'(relative {dE:.3e}), max |dS| {dS:.3e}', flush=True)
    if not (dE < 1e-9 and dS < 1e-8):
        raise AssertionError('the SU(2) static step disagrees between card and CPU')

    # the port's bench: the matvec and the step at 512 multiplets
    t_mv, _ = su2_run(chi_max, (10, 50), 2)
    print(f'[SU(2) bench {chi_max} multiplets] matvec {t_mv * 1e3:.3f} ms', flush=True)
    for graph in (False, True) if deep else (True,):  # eager: 20x longer, a short slope
        setup_s, t_step = su2_step(chi_max, graph=graph,
                                   lengths=(5, 25) if graph else (2, 6))
        print(f'[SU(2) bench {chi_max} multiplets{" graph" if graph else ""}] step '
              f'{t_step * 1e3:.3f} ms, {"capture" if graph else "first call"} '
              f'{setup_s:.2f} s, E {su2_step.energy!r}, {su2_step.launches_per_step} '
              f'grouped-GEMM launches/step', flush=True)
    return {**compose, 'launches': launches, 'sweep_launches': sweep_launches,
            'tridiag_launches': tridiag_launches}


def complex_phase(As, Bs, out_id, n_out, pairs, rng) -> dict:
    """Phase 2d: the grouped GEMM's complex128 kind against its plain version, held
    to check_f64's bound: the ragged lists with random complex operands, real x
    complex and complex x real, and the chi=4096 tdot(LP, theta) list ``As``, ``Bs``
    (f64) made complex128 (its imaginary parts drawn anew). Returns the chi=4096
    result."""
    import torch

    c128 = torch.complex128

    def draw(shapes, side: str, cplx: bool):
        dims = [(M, K) if side == 'A' else (K, N) for M, K, N in shapes]
        return [torch.from_numpy(rng.normal(size=d) + 1j * rng.normal(size=d) if cplx
                                 else rng.normal(size=d)).cuda() for d in dims]

    tiles = {}  # the form or tile the kind picks for each list
    for case, (shapes, out_ids) in RAGGED.items():
        ids, n = np.array(out_ids), max(out_ids) + 1
        cA, cB = draw(shapes, 'A', True), draw(shapes, 'B', True)
        res = compare_kernel(f'ragged {case}', cA, cB, ids, n, c128, reps=5)
        tiles[case] = res['form'] or res['tile']
        compare_kernel(f'ragged {case}', draw(shapes, 'A', False), cB, ids, n,
                       torch.float64, reps=5, b_dtype=c128)
        compare_kernel(f'ragged {case}', cA, draw(shapes, 'B', False), ids, n, c128,
                       reps=5, b_dtype=torch.float64)
        for width in ('wide', 'narrow'):  # each tile, whatever the list
            compare_kernel(f'ragged {case} {width}', cA, cB, ids, n, c128, reps=5,
                           width=width)
    cAs = [torch.complex(A, torch.randn_like(A)) for A in As]
    cBs = [torch.complex(B, torch.randn_like(B)) for B in Bs]
    res = compare_kernel(f'chi={CHI_BENCH} tdot(LP, theta)', cAs, cBs, out_id, n_out, c128,
                         pairs)
    tiles[f'chi={CHI_BENCH} tdot(LP, theta)'] = res['tile']
    print(f'[complex tile] the form or tile of each list: {json.dumps(tiles)}', flush=True)
    return res


def golden_phase(deep: bool = True) -> dict:
    """Phase 12: the Fibonacci golden chain on the fusion-tree backend (see the module
    docstring). Returns the numbers of its kernels-line entry."""
    import torch
    from cyten_tpu_torch.algorithms import DMRGEngine, GoldenChainModel, HEffective, SimpleMPS
    from cyten_tpu_torch.bench import GOLDEN28_E_REF, golden_run
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_ground_state

    c128 = grouped_matmul.kinds['complex128']
    t_phase = time.perf_counter()
    # L = 6, 8 (deep only) and 10 against MPSKit.jl's energies: the BASELINE.md anchor
    for L in (6, 8, 10) if deep else (10,):
        model = GoldenChainModel(L)
        psi = SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend)
        eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13)
        before = c128.launches
        E = eng.run(n_sweeps=10)
        exact = model.exact_finite_gs_energy()
        print(f'[golden L={L}] E = {E!r}, MPSKit {exact!r}, |dE| = {abs(E - exact):.3e}, '
              f'MPO {model.H_mpo[1].dtype}, B {psi.Bs[1].dtype}, complex128 launches '
              f'{c128.launches - before}', flush=True)
        if not (abs(E - exact) < 1e-9 and c128.launches > before):
            raise AssertionError(f'golden chain L={L}: energy or complex launches wrong')
    eng.enable_static_mode(n_lanczos=16, svd_mode='steady', cuda_graphs=False)
    E_eager = [eng.sweep() for _ in range(2)]
    eng.enable_static_mode(n_lanczos=16, svd_mode='steady')
    E_graph = [eng.sweep_static_batched() for _ in range(2)]
    print(f'[golden L=10 static] eager {E_eager}, graphs {E_graph}, '
          f'{len(eng.static_graphs())} graphs', flush=True)
    if not all(abs(e - exact) < 1e-9 for e in E_eager + E_graph):
        raise AssertionError('golden chain L=10 static energy wrong')

    # L=28 at 512 multiplets from fusion pairs, dynamic until the centre bond is full
    print(f'[golden] L=6/8/10: {time.perf_counter() - t_phase:.1f} s', flush=True)
    L, chi_max = 28, 512
    model = GoldenChainModel(L)
    psi = SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=0., lanczos_options={'N_max': 10})
    i = L // 2 - 1

    def centre_mult():
        return int(np.sum(psi.Ss[i + 1].leg.multiplicities))

    grouped_matmul.launches = 0
    c128.launches = 0
    tridiagonal_ground_state.launches = 0
    E = None
    dyn_s = []
    for sweep in range(12):
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        dyn_s.append(time.perf_counter() - t0)
        print(f'[golden L=28] sweep {sweep + 1}: E = {E_new!r}, {dyn_s[-1]:.2f} s, centre '
              f'bond {centre_mult()} multiplets', flush=True)
        converged = E is not None and abs(E_new - E) < 1e-10
        E = E_new
        if converged and centre_mult() == chi_max:
            break
    launches, c128_launches = grouped_matmul.launches, c128.launches
    print(f'[golden L=28] E = {E!r}, ref {GOLDEN28_E_REF!r}, |dE| = '
          f'{abs(E - GOLDEN28_E_REF):.3e}, grouped-GEMM launches {launches} (complex128 '
          f'{c128_launches}), sweep s {json.dumps(dyn_s)}', flush=True)
    if not (abs(E - GOLDEN28_E_REF) < 1e-9 and c128_launches > 0
            and centre_mult() == chi_max):
        raise AssertionError('golden L=28 DMRG energy, width or complex launches wrong')
    profile_run(f'golden dynamic bond {i}', lambda: eng.update_bond(i))

    # static mode: one eager steady sweep (deep only), two through graphs, one eager after
    eager_s = []
    if deep:
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
        t0 = time.perf_counter()
        E_static = eng.sweep()
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
        print(f'[golden static] eager sweep 1: E = {E_static!r}, {eager_s[-1]:.2f} s',
              flush=True)
        if not abs(E_static - E) < 1e-10:
            raise AssertionError('golden static-mode energy disagrees with the dynamic one')
        assert_right_isometric(psi, 1e-8)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    print(f'[golden graphs] runs of _static_runs: {eng._static_runs()}', flush=True)
    graph_s = []
    for sweep in range(2):
        c128.launches = 0
        grouped_matmul.thin.launches = 0
        tridiagonal_ground_state.launches = 0
        t0 = time.perf_counter()
        E_graph = eng.sweep_static_batched()
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
        sweep_launches = c128.launches
        tridiag_launches = tridiagonal_ground_state.launches
        print(f'[golden graphs] batched sweep {sweep + 1}: E = {E_graph!r}, '
              f'{graph_s[-1]:.2f} s, complex128 launches {sweep_launches} (thin form '
              f'{grouped_matmul.thin.launches}, every kind), tridiag launches '
              f'{tridiag_launches}', flush=True)
    graphs = eng.static_graphs()
    syncs = count_syncs(eng.sweep_static_batched)
    print(f'[golden graphs] {len(graphs)} graphs captured in '
          f'{sum(g.capture_seconds for g in graphs):.2f} s ({len(eng.static_graphs())} '
          f'after the counted sweep); launches per replayed sweep: complex128 '
          f'{sweep_launches}, tridiag {tridiag_launches}; host syncs of a replayed sweep '
          f'{syncs} (at {count_syncs.where}); sweep s eager {json.dumps(eager_s)}, graphs '
          f'{json.dumps(graph_s)}', flush=True)
    if not (abs(E_graph - E) < 1e-10 and sweep_launches > 0 and tridiag_launches > 0
            and graphs and syncs <= 1):
        raise AssertionError('golden batched static sweeps: energy, launches or syncs wrong')
    assert_right_isometric(psi, 1e-8)
    if deep:
        profile_run('golden replayed sweep', eng.sweep_static_batched, top=8)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    t0 = time.perf_counter()
    E_after = eng.sweep()
    torch.cuda.synchronize()
    print(f'[golden graphs] eager sweep after: E = {E_after!r}, {time.perf_counter() - t0:.2f} '
          f's, |E - E_graphs| = {abs(E_after - E_graph):.3e}', flush=True)
    if not abs(E_after - E_graph) < 1e-10:
        raise AssertionError('the eager golden static sweep disagrees with the graphs')
    assert_right_isometric(psi, 1e-8)

    # the centre bond's compose pair list on the complex128 kind
    H = HEffective(eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
    As, Bs, pairs, out_id, n_out = su2_compose_pairs(H.LP, psi.get_theta2(i))
    compose = compare_kernel(f'golden L=28 centre compose(theta, LP) {chi_max} multiplets',
                             As, Bs, out_id, n_out, torch.complex128, pairs, rounds=8)
    del eng, psi, model, H, As, Bs
    torch.cuda.empty_cache()

    # the port's bench: the golden matvec at 512 multiplets, eager
    t_mv = golden_run(chi_max)
    print(f'[golden bench {chi_max} multiplets] matvec {t_mv * 1e3:.3f} ms; phase '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return {**compose, 'launches': c128_launches}


# the bar rung of bench.py:1344-1363: the padded chi=4096 step in bf16 work at 'default'
# with the converged-sweep cleanup of the steady SVD
PADDED_STEP = {'precision': 'default', 'work_dtype': 'bfloat16',
               'steady_opts': {'n_jacobi': 1, 'ns_polish': 1}}
# the chi=CHI_BENCH step settings whose frac_peak and frac_roofline [bench] prints:
# name -> step_run keywords; phases 8 and 9 time the same steps as graphs
ROOF_SETTINGS = {'float64': {'dtype': 'float64'}, 'float32': {},
                 'tensorfloat32': {'precision': 'tensorfloat32'},
                 'default': {'precision': 'default'}, 'env bf16': {'env_dtype': 'bfloat16'},
                 'work bf16': {'work_dtype': 'bfloat16'}}


def hubbard_settings(args):
    """The Hubbard matvec at each setting of bench.HUBBARD_KINDS, whose lists
    bench_phase holds to plain: (kind, matmul_precision, LP, RP, W1, W2, theta) from
    the f32 workload ``args``."""
    from cyten_tpu_torch.bench import HUBBARD_KINDS

    return [(kind, precision, [t.to_dtype(env) for t in args[:2]]
             + [t.to_dtype(work) for t in args[2:]])
            for kind, (precision, work, env) in HUBBARD_KINDS.items()]


def measured_bound(label, res, ceilings, precision, a_dtype, b_dtype) -> None:
    """Adds ``measured_bound_ms`` to a compare_kernel result ``res``: its operations and
    bytes over this card's measured ceilings (bench.step_ceiling names the arithmetic
    and passes of the list's kind), and prints it beside the data sheet's bound."""
    import torch
    from cyten_tpu_torch import bench

    bf16 = torch.bfloat16
    arith, passes = bench.step_ceiling(
        precision or 'float32', env_dtype='bfloat16' if a_dtype != b_dtype else None,
        work_dtype='bfloat16' if a_dtype == b_dtype == bf16 else None,
        dtype='float64' if torch.float64 in (a_dtype, b_dtype) else 'float32')
    t_ops = res['gflop'] * passes / ceilings[arith]  # ms: 1e9 / 1e12 * 1e3
    t_bytes = res['mbytes'] / ceilings['hbm_gbps']  # ms: 1e6 / 1e9 * 1e3
    res['measured_bound_ms'] = max(t_ops, t_bytes)
    print(f'[bench list] {label}: device_ms {res["device_ms"]:.4f}, bound {res["bound_ms"]:.4f} '
          f'on the data sheet, {res["measured_bound_ms"]:.4f} on the measured ceilings '
          f'({arith} x{passes}, {"operations" if t_ops >= t_bytes else "bytes"}), '
          f'library_ms {res["library_ms"]:.4f}, {res["pairs"]} pairs, tile {res["tile"]}, '
          f'form {res["form"]}', flush=True)


def bench_lists(label, lists, ceilings, only: str = None, reps: int = 20) -> dict:
    """compare_kernel on each recorded list (bench.recorded_lists; with ``only``, those
    planned at that matmul_precision) at the kind its operands and matmul_precision
    pick, with its bound on the measured ``ceilings`` (measured_bound); returns the
    result of the list of most operations."""
    best = None
    for (prec, As, Bs, out_ids, n_out, pairs), count in lists:
        if only is not None and prec != only:  # the state's set-up, not the step
            continue
        rounded = prec in ('tensorfloat32', 'default')
        name = f'{label} {list_name(As, Bs, pairs, count)}'
        res = compare_kernel(name, As, Bs, out_ids, n_out, As[0].dtype, pairs, reps,
                             precision=prec if rounded else None, b_dtype=Bs[0].dtype,
                             as_given=True)
        measured_bound(name, res, ceilings, prec, As[0].dtype, Bs[0].dtype)
        if best is None or res['gflop'] > best['gflop']:
            best = res
    return best


def hubbard_and_dense_matvecs(out: dict, flops: float) -> None:
    """Phase 13 under --bench-only: the Hubbard matvec at chi=2048 through the kernel
    and through a torch.matmul per pair (bench.lists_on_plain), eager and as a graph
    (its eager run's launches into ``out['hubbard']``), and the dense TFI matvec."""
    import torch
    from cyten_tpu_torch import Dtype, bench, get_backend
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul

    hubbard = bench.build_hubbard_workload
    # the main path: the Hubbard matvec through the kernel and a torch.matmul per pair
    times = {}
    for route, routing in (('kernel', contextlib.nullcontext),
                           ('per-pair torch.matmul', bench.lists_on_plain)):
        for graph in (False, True):
            grouped_matmul.launches = 0
            with routing():
                times[route, graph] = bench.matvec_run(
                    2048, (10, 50) if graph else (2, 6), 1, builder=hubbard, graph=graph)
            if route == 'kernel' and not graph:
                out['hubbard']['launches'] = grouped_matmul.launches
    print(f'[bench hubbard chi=2048] matvec ms, {flops / 1e9:.3f} GFLOP: kernel eager '
          f'{times["kernel", False] * 1e3:.3f}, graph {times["kernel", True] * 1e3:.4f}; '
          f'a torch.matmul per pair eager {times["per-pair torch.matmul", False] * 1e3:.3f}, '
          f'graph {times["per-pair torch.matmul", True] * 1e3:.4f}; grouped-GEMM launches '
          f'of the eager run {out["hubbard"]["launches"]}', flush=True)
    if not out['hubbard']['launches']:
        raise AssertionError('the Hubbard matvec did not launch the grouped GEMM')
    # the dense TFI matvec (torch.tensordot: no grouped GEMM on this backend)
    dense = bench.build_dense_workload
    d_flops = bench.matvec_flops(*dense(get_backend(bench._builder_symmetry(dense),
                                                    device='cuda'), CHI_BENCH,
                                        dtype=Dtype.float32))
    t_d = bench.matvec_run(CHI_BENCH, (5, 20), 1, builder=dense)
    print(f'[bench dense chi={CHI_BENCH}] matvec {t_d * 1e3:.4f} ms, '
          f'{d_flops / t_d / 1e12:.3f} TFLOP/s', flush=True)
    torch.cuda.empty_cache()


def bench_phase(graph_steps: dict = None, deep: bool = True) -> dict:
    """Phase 13, [bench]: the rest of the port's bench (cyten_tpu_torch.bench) on the
    card. First ``python -m cyten_tpu_torch.bench`` as a subprocess (its
    JSON line: the measured ceilings, printed beside the data sheet's, the chi=8192
    ladder, the SVD timings with their spreads; every frac at most 1); with
    ``deep=False`` (the full run) only the ceilings, measured here
    (``bench.measured_peak_tflops``, ``measured_hbm_gbps``). Then the
    grouped-GEMM lists of one Hubbard (U(1) x U(1)) matvec at chi=2048 at each setting
    of hubbard_settings, of one padded chi=4096 bf16-work step and the chi=8192
    tdot(LP, theta) in f32 and bf16, each held to its plain version by compare_kernel,
    its bound on the data sheet and on the measured ceilings; with ``deep``, the
    Hubbard matvec through the kernel and through a torch.matmul per pair, eager and
    as a graph, and the dense (no-symmetry) TFI matvec at chi=4096
    (hubbard_and_dense_matvecs); the padded step as a graph; and the chi=CHI_BENCH step at each of ROOF_SETTINGS (as graphs;
    ``graph_steps`` gives phases 8 and 9's (seconds, FLOPs) by name) with frac_peak
    and frac_roofline against the measured ceilings. Returns the kernels-line numbers
    of the largest f32 Hubbard list and padded list, each with the launches of its
    main-path run."""
    import torch
    from cyten_tpu_torch import Dtype, bench, get_backend, u1_symmetry
    from cyten_tpu_torch.algorithms import HEffective
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.config import config

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    # the bench's own JSON line: ceilings, the chi=8192 ladder, the SVD timings (deep;
    # else the golden scenario's line, a few seconds, and the ceilings measured here)
    if deep:
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        run = subprocess.run([sys.executable, '-m', 'cyten_tpu_torch.bench'],
                             cwd=root, env={**os.environ, 'PYTHONPATH': root},
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise AssertionError('python -m cyten_tpu_torch.bench failed:\n'
                                 f'{run.stderr[-4000:]}')
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(f'[bench json] {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)',
              flush=True)
    else:
        line = {f'measured_peak_{key}_tflops': bench.measured_peak_tflops(arith)
                for arith, key in bench._PEAK_KEYS.items()}
        line['measured_hbm_gbps'] = bench.measured_hbm_gbps()
    ceilings = {arith: line[f'measured_peak_{key}_tflops']
                for arith, key in bench._PEAK_KEYS.items()}
    ceilings['hbm_gbps'] = line['measured_hbm_gbps']
    print('[bench ceilings] measured against the data sheet: ' + ', '.join(
        f'{arith} {ceilings[arith]:.2f} of {bench.DATASHEET[arith] / 1e12:.1f} TFLOP/s'
        for arith in bench._PEAK_KEYS) + f', HBM {ceilings["hbm_gbps"]:.1f} of '
        f'{bench.DATASHEET["hbm_bytes_per_s"] / 1e9:.0f} GB/s', flush=True)
    if deep:
        print('[bench ladder] ' + json.dumps({k: v for k, v in line.items()
                                              if k.startswith('step8192')}), flush=True)
        print('[bench svd] ' + json.dumps({k: v for k, v in line.items()
                                           if k.startswith('svd_')}), flush=True)
    fracs = {k: v for k, v in line.items() if '_frac_' in k}
    # the Hubbard lists of one matvec at each setting, against plain
    hubbard = bench.build_hubbard_workload
    args = hubbard(get_backend(bench._builder_symmetry(hubbard), device='cuda'), 2048,
                   dtype=Dtype.float32)
    for name, precision, margs in hubbard_settings(args):
        H = HEffective(*margs[:4])
        old = config.matmul_precision
        config.matmul_precision = precision
        grouped_matmul.launches = 0
        try:
            lists = bench.recorded_lists(lambda: H.matvec(margs[4]))
        finally:
            config.matmul_precision = old
        launches = grouped_matmul.launches
        # 5 reps: the per-pair loops of 2000 pairs take 50-100 ms a call
        res = bench_lists(f'hubbard {name}', lists, ceilings, reps=5)
        if name == 'float32':
            out['hubbard'] = {**res, 'launches': launches}
    flops = bench.matvec_flops(*args)
    del args, margs, H, lists
    if not out['hubbard']['launches']:
        raise AssertionError('the Hubbard matvec did not launch the grouped GEMM')
    if deep:
        hubbard_and_dense_matvecs(out, flops)
    torch.cuda.empty_cache()
    # the padded step's lists against plain, then the step as a graph
    padded = bench.build_padded_workload
    out['padded'] = bench_lists('padded', bench.recorded_lists(lambda: bench.step_run(
        CHI_BENCH, lengths=(1,), repeats=1, builder=padded, **PADDED_STEP)), ceilings,
        'default')
    grouped_matmul.launches = 0
    t_p, f_p = bench.step_run(CHI_BENCH, lengths=(2, 6), repeats=1, builder=padded,
                              graph=True, **PADDED_STEP)
    out['padded']['launches'] = grouped_matmul.launches
    print(f'[bench padded chi={CHI_BENCH}] bond {bench.padded_chi(CHI_BENCH)}, graph step '
          f'{t_p * 1e3:.3f} ms, {f_p / t_p / 1e12:.3f} TFLOP/s, E {bench.step_run.energy!r}, '
          f'{bench.step_run.launches_per_step} grouped-GEMM launches a step, '
          f'{out["padded"]["launches"]} in the run', flush=True)
    if not (out['padded']['launches'] and np.isfinite(bench.step_run.energy)):
        raise AssertionError('the padded step did not launch the grouped GEMM or E is off')
    torch.cuda.empty_cache()
    # the chi=8192 ladder's largest list, tdot(LP, theta), in f32 and bf16
    LP, _, _, _, theta = bench.build_workload(get_backend(u1_symmetry, device='cuda'),
                                              8192, dtype=Dtype.float32)
    As, Bs, pairs, out_id, n_out = lp_theta_pairs(LP, theta)
    del LP, theta
    for dtype in (torch.float32, torch.bfloat16):
        name = 'chi=8192 tdot(LP, theta)'
        res = compare_kernel(name, As, Bs, out_id, n_out, dtype, pairs)
        measured_bound(f'{name} {str(dtype)[6:]}', res, ceilings, None, dtype, dtype)
    del As, Bs
    torch.cuda.empty_cache()
    # the chi=CHI_BENCH step at each setting against the measured ceilings
    for name, kw in ROOF_SETTINGS.items():
        t, f = (graph_steps or {}).get(name) or bench.step_run(
            CHI_BENCH, lengths=(2, 6), repeats=1, graph=True, **kw)
        roof = bench.step_roofline(CHI_BENCH, t, f, ceilings, **kw)
        fracs[f'step {name}'] = roof['frac_peak']
        fracs[f'step {name} roofline'] = roof['frac_roofline']
        print(f'[bench roofline chi={CHI_BENCH} {name}] graph step {t * 1e3:.3f} ms, '
              f'{f / t / 1e12:.3f} TFLOP/s; ceiling {roof["ceiling"]} x{roof["passes"]}: '
              f'frac_peak {roof["frac_peak"]:.4f}, frac_roofline '
              f'{roof["frac_roofline"]:.4f}', flush=True)
    if not all(0 < v <= 1 for v in fracs.values()):
        raise AssertionError(f'a frac of peak or roofline past 1: {fracs}')
    print(f'[bench] peak reserved {torch.cuda.max_memory_reserved() / 1e9:.2f} GB here, '
          f'{line.get("peak_reserved_gb")} GB in the bench; wall '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return out


def accuracy_phase() -> None:
    """Phase 10: bench.accuracy_bf16work at the reference's scale (see the module
    docstring); under --bench-only."""
    import torch
    from cyten_tpu_torch.bench import accuracy_bf16work
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul

    t_phase = time.perf_counter()
    kinds = grouped_matmul.kinds
    for k in kinds.values():
        k.launches = 0
    n_bf16 = 4
    E_pol, E_bf16, dE_pol = accuracy_bf16work(chi=1024, L=24, n_bf16_sweeps=n_bf16)
    torch.cuda.synchronize()
    acc_s = time.perf_counter() - t_phase
    counts = {k: v.launches for k, v in kinds.items() if v.launches}
    dE_raw = abs(E_bf16 - HEIS24_E_REF)
    print(f'[accuracy] L=24 chi=1024, {n_bf16} bf16 sweeps + 1 f32 polish: polished E '
          f'{E_pol!r} dE {dE_pol:.3e} (cyten_tpu on a CPU: 1.04e-5), raw bf16 E {E_bf16!r} '
          f'dE {dE_raw:.3e} (2.25e-3); {acc_s:.1f} s, {acc_s / (n_bf16 + 1):.1f} s per '
          f'sweep; launches by kind {json.dumps(counts)}', flush=True)
    if not dE_pol < 1e-3 or not counts.get('default'):
        raise AssertionError(f'accuracy protocol: polished dE {dE_pol} or kinds {counts}')


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _mps_blocks(psi) -> list:
    return [b for t in psi.Bs + psi.Ss for b in t.data.blocks]


def _sweep_to_convergence(label: str, eng, max_sweeps: int = 12) -> dict:
    """Dynamic sweeps of ``eng`` until E changes by less than 1e-10 with the bond
    dimension at chi_max; the grouped-GEMM launches of each sweep counted as phase 4
    counts them. Returns E, the sweeps, their seconds and the last sweep's launches."""
    import torch
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul

    E, sweep_s, launches = None, [], []
    for sweep in range(max_sweeps):
        grouped_matmul.launches = 0
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        launches.append(grouped_matmul.launches)
        print(f'[{label}] sweep {sweep + 1}: E = {E_new!r}, {sweep_s[-1]:.2f} s, max chi '
              f'{eng.psi.max_chi()}, grouped-GEMM launches {launches[-1]}', flush=True)
        done = E is not None and abs(E_new - E) < 1e-10 and eng.psi.max_chi() == eng.chi_max
        E = E_new
        if done:
            break
    return {'E': E, 'sweeps': len(sweep_s), 'sweep_s': sweep_s,
            'launches_per_sweep': launches[-1], 'launches': launches}


def engine_phase(model, psi4, E24, psi_mid=None, deep: bool = True) -> dict:
    """Phase 14: the rest of DMRGEngine on phase 4's converged L=24, chi_max=1024 state
    (``psi4``, a copy taken at the end of its last sweep; ``model`` its f64 model;
    ``deep=False``, the full run, leaves out the resume in a child process, the
    precision escalation and the excited state):
    checkpoints, resume in a child process, rollback in static mode through graphs and
    the precision escalation on an f32 copy, and the first excited state of Sz=0.
    Raises on any failed check. ``psi_mid``, the state after phase 4's centre-bond
    updates, is only measured: two static sweeps from it, against psi4's."""
    import io as _io

    import torch
    from cyten_tpu_torch import Dtype
    from cyten_tpu_torch.algorithms import DMRGEngine, FaultError, HeisenbergModel, SimpleMPS
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.tools.checkpoint import CheckpointManager, wait_for_saves

    L = psi4.L
    opts = {'chi_max': 1024, 'eps': 0., 'lanczos_options': {'N_max': 10}}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_ckpt')
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    state = {'psi': psi4, 'E': float(E24), 'sweep': 1, 'trunc_err': 0.}
    block_bytes = sum(b.numel() * b.element_size() for b in _mps_blocks(psi4))

    # (a) checkpoint the converged state, synchronously and with async_save; restore
    for async_save in (False, True):
        mgr = CheckpointManager(os.path.join(root, 'async' if async_save else 'sync'),
                                async_save=async_save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, state)
        t_call = time.perf_counter() - t0
        wait_for_saves()
        t_done = time.perf_counter() - t0
        on_disk = _dir_bytes(os.path.join(mgr.directory, 'step_00000001'))
        res['save_async' if async_save else 'save_sync'] = (t_call, t_done, on_disk)
        print(f'[engine ckpt] {"async" if async_save else "sync"} save: returned in '
              f'{t_call:.3f} s, written in {t_done:.3f} s, {on_disk} bytes on disk '
              f'(blocks {block_bytes} bytes, {len(_mps_blocks(psi4))} blocks)', flush=True)
        if on_disk > block_bytes + 1024 * (len(_mps_blocks(psi4)) + 64):
            raise AssertionError('the checkpoint holds more than its blocks and its tree')
    mgr = CheckpointManager(os.path.join(root, 'sync'))
    t0 = time.perf_counter()
    payload = mgr.restore(device='cuda')
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    restored = payload['psi']
    same = all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(_mps_blocks(restored), _mps_blocks(psi4)))
    inds = all(np.array_equal(a.data.block_inds, b.data.block_inds)
               for a, b in zip(restored.Bs + restored.Ss, psi4.Bs + psi4.Ss))
    eng_a = DMRGEngine(psi4.copy(), model, **opts)
    eng_b = DMRGEngine(restored, model, **opts)
    E_a, E_b = eng_a.sweep(), eng_b.sweep()
    print(f'[engine ckpt] restored in {t_restore:.3f} s, blocks bitwise {same}, block '
          f'indices {inds}; one dynamic sweep each: E {E_a!r} and {E_b!r}, |dE| '
          f'{abs(E_a - E_b):.3e}', flush=True)
    if not (same and inds and abs(E_a - E_b) < 1e-10):
        raise AssertionError('the restored state differs from the saved one')
    del eng_a, eng_b, restored, payload

    # (b) resume run(checkpoint=dir) in a child process, one more sweep (deep only)
    child = (
        'import sys\n'
        f'sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n'
        'from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS\n'
        f'model = HeisenbergModel(L={L}, conserve="Sz")\n'
        f'psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * {L // 2})\n'
        f'eng = DMRGEngine(psi, model, chi_max=1024, eps=0., lanczos_options={{"N_max": 10}})\n'
        f'E = eng.run(n_sweeps=1, checkpoint={mgr.directory!r})\n'
        'print("RESUMED", eng._sweeps_done, repr(E))\n')
    if deep:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, '-c', child], capture_output=True, text=True,
                             timeout=600)
        t_child = time.perf_counter() - t0
        line = [ln for ln in out.stdout.splitlines() if ln.startswith('RESUMED')]
        if out.returncode != 0 or not line:
            raise AssertionError(f'the resuming child failed: {out.stderr[-2000:]}')
        _, done, E_child = line[0].split()
        E_child = float(E_child)
        print(f'[engine resume] child process resumed step 1 and swept once: E '
              f'{E_child!r}, |E - HEIS24_E_REF| {abs(E_child - HEIS24_E_REF):.3e}, sweeps '
              f'done {done}, {t_child:.1f} s', flush=True)
        if not (abs(E_child - HEIS24_E_REF) < 1e-8 and int(done) == 2):
            raise AssertionError('the resumed run is off')

    # static sweeps from the state after phase 4's centre-bond updates, measured only
    # (from the state at the end of the sweep: the first two sweeps of (c))
    if psi_mid is not None:
        eng = DMRGEngine(psi_mid.copy(), model, **opts)
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
        dE = [eng.sweep() - HEIS24_E_REF for _ in range(2)]
        print(f'[engine static start] two static sweeps from the state after the '
              f'centre-bond updates: E - HEIS24_E_REF {json.dumps(dE)}', flush=True)
        del eng
        torch.cuda.empty_cache()

    # (c) rollback in static mode through graphs, f64
    eng = DMRGEngine(psi4.copy(), model, **opts, auto_static=True)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    mgr_c = CheckpointManager(os.path.join(root, 'static'))
    torch.cuda.reset_peak_memory_stats()
    static_E = []
    for sweep in range(2):  # static sweeps, their graphs captured; a checkpoint each
        static_E.append(eng.run(n_sweeps=1, checkpoint=mgr_c, tol=0.))
    torch.cuda.synchronize()
    print(f'[engine rollback] f64 static sweeps through graphs before the poison: E '
          f'{json.dumps(static_E)}, {len(eng.static_graphs())} graphs', flush=True)
    if not all(abs(E - HEIS24_E_REF) < 1e-8 for E in static_E):
        raise AssertionError('the static sweeps before the poison are off')
    old = [weakref.ref(g) for g in eng.static_graphs()]
    peak_before = torch.cuda.max_memory_reserved()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_reserved()
    i = L // 2
    eng.psi.Bs[i] = eng.psi.Bs[i] * float('nan')
    log = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        E_c = eng.run(n_sweeps=3, checkpoint=mgr_c, verbose=True)
    t_run = time.perf_counter() - t0
    print(''.join(f'[engine rollback] {ln}\n' for ln in log.getvalue().splitlines()),
          end='', flush=True)
    static_on = eng.static_mode  # auto_static on again: the structures repeated
    released = all(r() is None for r in old)
    if not static_on:
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    graph_s = []
    for sweep in range(2):  # the restored structures, captured anew
        grouped_matmul.launches = 0
        t0 = time.perf_counter()
        E_graph = eng.sweep_static_batched()
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
    n_new = len(eng.static_graphs())
    peak_after = torch.cuda.max_memory_reserved()
    torch.cuda.empty_cache()
    held_after = torch.cuda.memory_reserved()
    res['rollback'] = {'graphs_before': len(old), 'graphs_after': n_new,
                       'peak_before': peak_before, 'peak_after': peak_after,
                       'held_before': held_before, 'held_after': held_after}
    print(f'[engine rollback] f64: run(n_sweeps=3) {t_run:.1f} s, E {E_c!r}; auto_static '
          f'turned static mode on again: {static_on}; the {len(old)} graphs of before '
          f'released {released}; two batched sweeps '
          f'{json.dumps([round(t, 3) for t in graph_s])} s, E '
          f'{E_graph!r}, |dE| {abs(E_graph - HEIS24_E_REF):.3e}, grouped-GEMM launches '
          f'{grouped_matmul.launches}, {n_new} graphs captured anew; peak reserved '
          f'{peak_before / 1e9:.3f} GB before, {peak_after / 1e9:.3f} GB after; reserved '
          f'after empty_cache {held_before / 1e9:.3f} GB and {held_after / 1e9:.3f} GB',
          flush=True)
    if not ('rollback to checkpoint' in log.getvalue() and old and released
            and n_new and abs(E_c - HEIS24_E_REF) < 1e-8
            and abs(E_graph - HEIS24_E_REF) < 1e-8 and held_after < 1.25 * held_before):
        raise AssertionError('the static-mode rollback: no rollback, no new graphs, E off '
                             'or the old graphs kept')
    assert_right_isometric(eng.psi, 1e-8)
    del eng
    torch.cuda.empty_cache()

    # the precision escalation on an f32 copy with bf16 environments (as phase 7b; deep
    # only)
    if not deep:
        shutil.rmtree(root, ignore_errors=True)
        return res
    model32 = HeisenbergModel(L=L, conserve='Sz')
    model32.H_mpo = [W.to_dtype(Dtype.float32) for W in model.H_mpo]
    psi32 = SimpleMPS([B.to_dtype(Dtype.float32) for B in psi4.Bs],
                      [S.to_dtype(Dtype.float32) for S in psi4.Ss])
    eng = DMRGEngine(psi32, model32, **opts, env_dtype=Dtype.bfloat16)
    mgr_32 = CheckpointManager(os.path.join(root, 'f32'))
    eng.run(n_sweeps=1, checkpoint=mgr_32)
    envs_before = sorted({t.dtype.name for t in eng.LPs[1:-1] + eng.RPs[1:-1]})
    eng.psi.Bs[i] = eng.psi.Bs[i] * float('nan')
    log = _io.StringIO()
    with contextlib.redirect_stdout(log):
        E_32 = eng.run(n_sweeps=2, checkpoint=mgr_32, verbose=True)
    print(''.join(f'[engine rollback f32] {ln}\n' for ln in log.getvalue().splitlines()),
          end='', flush=True)
    envs_after = sorted({t.dtype.name for t in eng.LPs + eng.RPs})
    rel = abs(E_32 - HEIS24_E_REF) / abs(HEIS24_E_REF)
    print(f'[engine rollback f32] env_dtype {eng.env_dtype}, interior LP/RP before '
          f'{envs_before}, every LP/RP after {envs_after}; E {E_32!r}, relative '
          f'{rel:.3e}', flush=True)
    if not (envs_before == ['bfloat16'] and 'env_dtype -> None' in log.getvalue()
            and eng.env_dtype is None and envs_after == ['float32'] and rel < 1e-3):
        raise AssertionError('the precision escalation on rollback')
    eng.psi.Bs[i] = eng.psi.Bs[i] * float('nan')
    try:
        eng.run(n_sweeps=1)
    except FaultError as exc:
        print(f'[engine rollback f32] with no checkpoint: FaultError({exc})', flush=True)
    else:
        raise AssertionError('a poisoned sweep with no checkpoint did not raise')
    del eng, psi32, model32
    torch.cuda.empty_cache()

    # (d) the first excited state of Sz=0 against the Sz=1 ground state (deep only)
    if deep:
        psi1 = SimpleMPS.from_product_state(model.site_legs, [1, 0] * (L // 2))
        eng1 = DMRGEngine(psi1, model, **opts, orthogonal_to=[psi4])
        ex = _sweep_to_convergence('engine excited', eng1)
        psit = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2 - 1) + [0, 0])
        engt = DMRGEngine(psit, model, **opts)
        gs1 = _sweep_to_convergence('engine Sz=1', engt)
        ov = abs(eng1.psi.overlap(psi4))
        var1 = eng1.psi.mpo_variance(model.H_mpo)
        var_t = engt.psi.mpo_variance(model.H_mpo)
        S_mid = eng1.psi.entanglement_entropy()[L // 2 - 1]
        S0_mid = psi4.entanglement_entropy()[L // 2 - 1]
        res['excited'] = ex
        res['triplet'] = gs1
        print(f'[engine excited] E1 {ex["E"]!r} (Sz=0, orthogonal to phase 4), E(Sz=1) '
              f'{gs1["E"]!r}, |dE| {abs(ex["E"] - gs1["E"]):.3e}; gap E1 - E0 '
              f'{ex["E"] - E24!r}; |<psi1|psi0>| {ov:.3e}; mpo_variance {var1:.3e} and '
              f'{var_t:.3e}; centre entropy {S_mid:.6f} (ground state {S0_mid:.6f})',
              flush=True)
        print(f'[engine excited] s/sweep excited '
              f'{json.dumps([round(t, 3) for t in ex["sweep_s"]])}, Sz=1 ground state '
              f'{json.dumps([round(t, 3) for t in gs1["sweep_s"]])}; '
              f'grouped-GEMM launches per converged sweep {ex["launches_per_sweep"]} with the '
              f'overlap environments, {gs1["launches_per_sweep"]} without', flush=True)
        if not (abs(ex['E'] - gs1['E']) < 1e-8 and ov < 1e-8 and var1 < 1e-6 and var_t < 1e-6):
            raise AssertionError('the excited state disagrees with the Sz=1 ground state')
        b = L // 2 - 1
        profile_run(f'projected bond {b}', lambda: eng1.update_bond(b))
        print(f'[engine excited] host syncs of one projected bond update: '
              f'{count_syncs(lambda: eng1.update_bond(b))}', flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


class MpoModel:
    """A model that is its MPO alone, as DMRGEngine reads it."""

    def __init__(self, H_mpo):
        self.H_mpo = H_mpo


def spin_chain_exact_gs_energy(L: int, S: float) -> float:
    """Ground energy of the open spin-S Heisenberg chain (J=1) by sparse exact
    diagonalization on the host."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla
    from cyten_tpu_torch.models import SpinDOF

    ops = SpinDOF.spin_ops(S)
    d = ops['Sz'].shape[0]

    def op_at(o, i):
        return sp.kron(sp.kron(sp.identity(d ** i), sp.csr_matrix(o)),
                       sp.identity(d ** (L - i - 1)), format='csr')

    H = sp.csr_matrix((d ** L, d ** L))
    for i in range(L - 1):
        H = H + 0.5 * (op_at(ops['Sp'], i) @ op_at(ops['Sm'], i + 1)
                       + op_at(ops['Sm'], i) @ op_at(ops['Sp'], i + 1)) \
            + op_at(ops['Sz'], i) @ op_at(ops['Sz'], i + 1)
    return float(sla.eigsh(H, k=1, which='SA', return_eigenvectors=False)[0])


def _counts_zero() -> None:
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_ground_state

    grouped_matmul.launches = grouped_matmul.thin.launches = 0
    tridiagonal_ground_state.launches = 0


def _counts() -> dict:
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_ground_state

    return {'grouped_gemm': grouped_matmul.launches, 'thin': grouped_matmul.thin.launches,
            'tridiag': tridiagonal_ground_state.launches}


def _dynamic_then_graphs(label: str, eng, max_sweeps: int) -> dict:
    """Dynamic sweeps of ``eng`` until converged at chi_max (_sweep_to_convergence),
    then three sweep_static_batched() sweeps: the first updates each bond structure
    eagerly, the second captures a CUDA graph per structure, the third replays them;
    the launches of each kernel counted per sweep (through replays). Returns E of
    both, seconds and launches per sweep."""
    import torch

    _counts_zero()
    dyn = _sweep_to_convergence(label, eng, max_sweeps)
    # _sweep_to_convergence counts the grouped GEMM sweep by sweep
    launches = {'dynamic run': {**_counts(), 'grouped_gemm': sum(dyn['launches'])}}
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    graph_s = []
    for sweep in range(3):
        _counts_zero()
        t0 = time.perf_counter()
        E_graph = eng.sweep_static_batched()
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
        launches[f'static sweep {sweep + 1}'] = _counts()
        print(f'[{label} graphs] sweep {sweep + 1}: E = {E_graph!r}, {graph_s[-1]:.2f} s, '
              f'|E - E_dynamic| = {abs(E_graph - dyn["E"]):.3e}, launches '
              f'{json.dumps(launches[f"static sweep {sweep + 1}"])}', flush=True)
    graphs = eng.static_graphs()
    print(f'[{label} graphs] {len(graphs)} graphs captured in '
          f'{sum(g.capture_seconds for g in graphs):.2f} s', flush=True)
    return {**dyn, 'E_graph': E_graph, 'graph_s': graph_s, 'launches': launches}


def models_phase(deep: bool = True) -> dict:
    """Phase 15: the models layer on the card (see the module docstring).
    ``deep=False`` (the full run) leaves out (a) and (b)'s L=32 chain at chi 1024 and
    takes (c) at chi_max=16 in place of 64. Returns the numbers of its kernels-line entries:
    the spin-1 centre tdot(LP, theta) list, the J1-J2 chain's W list, and the launches
    of each kernel over the phase's runs."""
    import torch
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, HeisenbergModel, SimpleMPS, SpinChainModel, mpo_from_terms,
        spin_half_site,
    )
    from cyten_tpu_torch.bench import recorded_lists
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul_plan
    from cyten_tpu_torch.models import CouplingModel, SpinHalfSite, heisenberg_coupling

    total = {'grouped_gemm': 0, 'thin': 0, 'tridiag': 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) under --models-only alone (the full run's phase 4 drives the same MPO)
    if deep:
        # (a) spin-1/2 Heisenberg, L=24, through CouplingModel + heisenberg_coupling +
        # build_H_mpo, against the hand-built MPO's bonds and HEIS24_E_REF
        t_sub = time.perf_counter()
        L = 24
        sites = [SpinHalfSite('Sz')] * L
        cm = CouplingModel(sites)
        for i in range(L - 1):
            cm.add_coupling(i, heisenberg_coupling([sites[i], sites[i + 1]]))
        H_mpo = cm.build_H_mpo()
        dims = [(W.get_leg_co_domain('wL').dim, W.get_leg_co_domain('wR').dim) for W in H_mpo]
        hand = [(W.get_leg_co_domain('wL').dim, W.get_leg_co_domain('wR').dim)
                for W in HeisenbergModel(L=L, conserve='Sz').H_mpo]
        print(f'[models a] CouplingModel MPO bond dims {dims[:3]}... equal to the hand-built '
              f"HeisenbergModel's: {dims == hand}; device {H_mpo[0].device}", flush=True)
        if dims != hand or str(H_mpo[0].device).split(':')[0] != 'cuda':
            raise AssertionError('the CouplingModel MPO differs from the hand-built one in its '
                                 'bonds, or is not on the card')
        psi = SimpleMPS.from_product_state([s.leg for s in sites], [0, 1] * (L // 2))
        eng = DMRGEngine(psi, MpoModel(H_mpo), chi_max=1024, eps=0.,
                         lanczos_options={'N_max': 10})
        a = _dynamic_then_graphs('models a L=24', eng, 8)
        for counts in a['launches'].values():
            add(counts)
        print(f'[models a] E dynamic {a["E"]!r}, through graphs {a["E_graph"]!r}, ref '
              f'{HEIS24_E_REF!r}: |dE| {abs(a["E"] - HEIS24_E_REF):.3e}, '
              f'{abs(a["E_graph"] - HEIS24_E_REF):.3e}; sweeps {a["sweeps"]} from '
              f'the product state, s per dynamic sweep '
              f'{json.dumps([round(s, 3) for s in a["sweep_s"]])}, per static sweep (eager, '
              f'captures, replayed) {json.dumps([round(s, 3) for s in a["graph_s"]])}; '
              f'{time.perf_counter() - t_sub:.1f} s',
              flush=True)
        run = a['launches']
        if not (abs(a['E'] - HEIS24_E_REF) < 1e-8 and abs(a['E_graph'] - HEIS24_E_REF) < 1e-8
                and run['dynamic run']['grouped_gemm'] > 0 and run['dynamic run']['thin'] > 0
                and run['static sweep 3']['grouped_gemm'] > 0
                and run['static sweep 3']['thin'] > 0
                and run['static sweep 3']['tridiag'] > 0 and psi.max_chi() == 1024):
            raise AssertionError('models (a): energy, width or kernel launches wrong')
        del eng, psi, H_mpo, cm
        torch.cuda.empty_cache()

    # (b) spin-1 SpinChainModel, conserve 'Sz': L=10 against sparse ED on the host;
    # under --models-only then L=32 at chi_max=1024, dynamic and static, in the sector
    # of total Sz = 1: its lowest state (the open chain's edge spins aligned) lies a
    # Haldane gap below the next, where in Sz = 0 the singlet and the triplet's Sz = 0
    # state are split by exp(-L / 6) and the sweeps converge slowly
    t_sub = time.perf_counter()
    E10_ed = spin_chain_exact_gs_energy(10, 1.)
    L, model = 10, SpinChainModel(L=10, S=1.)
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 2] * 5)
    _counts_zero()
    eng = DMRGEngine(psi, model, chi_max=243, eps=1e-14)
    E10 = _sweeps_until('models b L=10', eng, 10, tol=1e-11)['E']
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    E10_static = eng.sweep_static_batched()
    c10 = _counts()
    add(c10)
    print(f'[models b L=10] E = {E10!r}, static {E10_static!r}, sparse ED {E10_ed!r}, |dE| '
          f'{abs(E10 - E10_ed):.3e}, {abs(E10_static - E10_ed):.3e}; launches '
          f'{json.dumps(c10)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(E10 - E10_ed) < 1e-9 and abs(E10_static - E10_ed) < 1e-9
            and c10['grouped_gemm'] > 0 and c10['tridiag'] > 0):
        raise AssertionError('models (b): the L=10 spin-1 energy or its launches wrong')
    if deep:
        t_sub = time.perf_counter()
        L, chi_max, model = 32, 1024, SpinChainModel(L=32, S=1.)
        label = f'models b L={L}'
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 2] * 15 + [0, 1])
        eng = DMRGEngine(psi, model, chi_max=chi_max, eps=0., lanczos_options={'N_max': 10})
        b = _dynamic_then_graphs(label, eng, 10)
        for counts in b['launches'].values():
            add(counts)
        var = psi.mpo_variance(model.H_mpo)
        print(f'[{label}] Sz=1: E dynamic {b["E"]!r}, through graphs {b["E_graph"]!r}, '
              f'|dE| {abs(b["E_graph"] - b["E"]):.3e}; E/L {b["E_graph"] / L!r} beside the '
              f'bulk {HALDANE_E_PER_SITE} (open ends); mpo_variance {var:.3e}; max chi '
              f'{psi.max_chi()}; sweeps {b["sweeps"]}, s per dynamic sweep '
              f'{json.dumps([round(s, 3) for s in b["sweep_s"]])}, per static sweep (eager, '
              f'captures, replayed) {json.dumps([round(s, 3) for s in b["graph_s"]])}; '
              f'launches per sweep by kernel: last dynamic sweep {b["launches_per_sweep"]} '
              f'grouped GEMM, replayed {json.dumps(b["launches"]["static sweep 3"])}; '
              f'{time.perf_counter() - t_sub:.1f} s', flush=True)
        run = b['launches']
        if not (abs(b['E_graph'] - b['E']) < 1e-8 and psi.max_chi() == chi_max
                and run['dynamic run']['grouped_gemm'] > 0
                and run['static sweep 3']['grouped_gemm'] > 0
                and run['static sweep 3']['tridiag'] > 0):
            raise AssertionError('models (b): the static energy, width or launches wrong')
    # the centre tdot(LP, theta) list of the spin-1 state, on the kernel against plain
    i = L // 2 - 1
    As, Bs, pairs, out_id, n_out = lp_theta_pairs(eng.LPs[i], psi.get_theta2(i))
    centre = compare_kernel(f'models b L={L} chi={psi.max_chi()} centre tdot(LP, theta)',
                            As, Bs, out_id, n_out, torch.float64, pairs)
    del eng, psi, model
    torch.cuda.empty_cache()

    # (c) the J1-J2 chain from mpo_from_terms at the Majumdar-Ghosh point, L=64 (32 in
    # the full run)
    t_sub = time.perf_counter()
    L = 64 if deep else 32
    sz = np.diag([0.5, -0.5])
    sp = np.array([[0., 1.], [0., 0.]])
    SS = 0.5 * (np.kron(sp, sp.T) + np.kron(sp.T, sp)) + np.kron(sz, sz)
    leg = spin_half_site('Sz')
    mpo = mpo_from_terms([leg] * L, couplings=[(i, i + 1, SS, 1.) for i in range(L - 1)]
                         + [(i, i + 2, SS, 0.5) for i in range(L - 2)])
    wR = max(W.get_leg_co_domain('wR').dim for W in mpo)
    psi = SimpleMPS.from_product_state([leg] * L, [i % 2 for i in range(L)])
    eng = DMRGEngine(psi, MpoModel(mpo), chi_max=64 if deep else 16, eps=0.,
                     lanczos_options={'N_max': 10})
    _counts_zero()
    c = {'E': None, 'sweep_s': []}
    for sweep in range(6):  # until E changes by less than 1e-10
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        c['sweep_s'].append(time.perf_counter() - t0)
        print(f'[models c L={L}] sweep {sweep + 1}: E = {E_new!r}, {c["sweep_s"][-1]:.2f} s, '
              f'max chi {psi.max_chi()}', flush=True)
        done = c['E'] is not None and abs(E_new - c['E']) < 1e-10
        c['E'] = E_new
        if done:
            break
    c['sweeps'] = len(c['sweep_s'])
    cc = _counts()
    add(cc)
    E_exact = -0.75 * (L // 2)
    print(f'[models c] J1-J2 L={L}, J2 = J1/2: E = {c["E"]!r}, exact {E_exact}, |dE| '
          f'{abs(c["E"] - E_exact):.3e}; MPO bond dimension {wR} (max_range '
          f'{mpo.max_range}); s per sweep {json.dumps([round(s, 3) for s in c["sweep_s"]])}; '
          f'launches {json.dumps(cc)} ({cc["thin"] / c["sweeps"]:.1f} thin a sweep); '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(c['E'] - E_exact) < 1e-8 and cc['grouped_gemm'] > 0 and cc['thin'] > 0):
        raise AssertionError('models (c): the Majumdar-Ghosh energy or launches wrong')
    # the W lists (a narrow side of at most 16: the contractions with W) of the bond
    # updates at the chain's quarter and centre: the largest thin one (else the largest
    # W list, tiled) on the kernel against plain, held elementwise to check_f64's bound
    lists = recorded_lists(lambda: [eng.update_bond(i) for i in (L // 4, L // 2 - 1)])

    def narrow(l):
        (prec, As, Bs, ids, n_out, pairs), count = l
        PA = As if pairs is None else [As[k] for k in pairs[0].tolist()]
        PB = Bs if pairs is None else [Bs[k] for k in pairs[1].tolist()]
        return min(max(A.shape[1] for A in PA), max(B.shape[1] for B in PB),
                   max(A.shape[0] for A in PA)) <= 16

    w_lists = [l for l in lists if narrow(l)]
    thin_lists = [l for l in w_lists if grouped_matmul_plan(*l[0][1:])[1].form is not None]
    if not w_lists:
        raise AssertionError('models (c): no W list in the bond updates')
    (_, As, Bs, ids, n_out, pairs), count = max(
        thin_lists or w_lists, key=lambda l: sum(t.numel() for t in (*l[0][1], *l[0][2])))
    w_list = compare_kernel(f'models c J1-J2 chi={psi.max_chi()} W list '
                            f'{list_name(As, Bs, pairs, count)}', As, Bs, ids, n_out,
                            As[0].dtype, pairs, as_given=True)
    print(f'[models c] {len(w_lists)} W lists of {len(lists)} in two bond updates, '
          f'{len(thin_lists)} thin; the one held: {w_list["form"] or "tiled"}, largest error '
          f'{w_list["max_abs_err"]:.3e}, {w_list["err_units"]:.4f} K 2^-52 |A||B|; '
          f'device_ms {w_list["device_ms"]:.4f}, bound {w_list["bound_ms"]:.4f} '
          f'({w_list["bound_by"]}), library_ms {w_list["library_ms"]:.4f}', flush=True)
    del eng, psi, mpo
    torch.cuda.empty_cache()
    print(f'[models] launches over the phase: {json.dumps(total)}', flush=True)
    return {'centre': centre, 'w_list': w_list, 'launches': total,
            'launches_c': cc['grouped_gemm']}


def full_chain_hamiltonian(h_bonds, site_leg, backend):
    """H = sum_i 1 x .. x h_i x .. x 1 as one tensor [p0..pL-1 | p0*..pL-1*], built
    inside the framework (an anyonic chain has no dense form): site by site, H' = H x 1
    + 1 x h, from outer products and permutations (tests/test_anyonic_ed.py:17-40
    builds each term apart)."""
    from cyten_tpu_torch.tensors import SymmetricTensor, outer, permute_legs

    def ordered(t, n):
        return permute_legs(t, codomain=[f'p{j}' for j in range(n)],
                            domain=[f'p{j}*' for j in range(n)])

    H = ordered(h_bonds[0].relabelled(['p0', 'p1', 'p1*', 'p0*']), 2)
    for m, h in enumerate(h_bonds[1:], 2):
        h = h.relabelled([f'p{m - 1}', f'p{m}', f'p{m}*', f'p{m - 1}*'])
        eye = SymmetricTensor.from_eye([site_leg], backend=backend, labels=[f'p{m}'],
                                       dtype=h.dtype)
        rest = SymmetricTensor.from_eye([site_leg] * (m - 1), backend=backend,
                                        labels=[f'p{j}' for j in range(m - 1)], dtype=h.dtype)
        H = ordered(outer(H, eye), m + 1) + ordered(outer(rest, h), m + 1)
    return H


def _sweeps_until(label: str, eng, max_sweeps: int, tol: float = 1e-10) -> dict:
    """Dynamic sweeps until E changes by less than ``tol`` (at most ``max_sweeps``):
    E, the seconds of each sweep."""
    import torch

    E, sweep_s = None, []
    for sweep in range(max_sweeps):
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        print(f'[{label}] sweep {sweep + 1}: E = {E_new!r}, {sweep_s[-1]:.2f} s, max chi '
              f'{eng.psi.max_chi()}', flush=True)
        done = E is not None and abs(E_new - E) < tol
        E = E_new
        if done:
            break
    return {'E': E, 'sweep_s': sweep_s}


def _static_sweeps(label: str, eng, E_dyn: float, tol: float, deep: bool) -> dict:
    """Static mode after the dynamic sweeps of ``eng``: one eager sweep
    (cuda_graphs=False), then sweeps through CUDA graphs until one captures no new
    graph (the replayed sweep), each to ``tol`` of ``E_dyn``; the host syncs of one
    more replayed sweep, each kernel's launches per sweep, the device constants of the
    backend against _CONSTANTS_MAX and those the graphs hold. With ``deep``, a
    replayed sweep under torch.profiler, and a replay after the backend's constants
    were all dropped and their memory reused (the graphs keep what they read alive:
    _kernels.keep_alive)."""
    import torch
    from cyten_tpu_torch.blocks import torch_backend
    from cyten_tpu_torch.blocks.torch_backend import _CONSTANTS_MAX
    from cyten_tpu_torch.tensors import permute_legs

    res = {'static_s': [], 'E_static': []}
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    t0 = time.perf_counter()
    E = eng.sweep()
    torch.cuda.synchronize()
    res['static_s'].append(time.perf_counter() - t0)
    res['E_static'].append(E)
    print(f'[{label} static] eager sweep: E = {E!r}, |E - E_dynamic| = {abs(E - E_dyn):.3e}, '
          f'{res["static_s"][-1]:.2f} s', flush=True)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    for sweep in range(4):
        n_graphs = len(eng.static_graphs())
        _counts_zero()
        t0 = time.perf_counter()
        E = eng.sweep_static_batched()
        torch.cuda.synchronize()
        res['static_s'].append(time.perf_counter() - t0)
        res['E_static'].append(E)
        res['launches'] = _counts()
        new = len(eng.static_graphs()) - n_graphs
        print(f'[{label} graphs] sweep {sweep + 1}: E = {E!r}, |E - E_dynamic| = '
              f'{abs(E - E_dyn):.3e}, {res["static_s"][-1]:.2f} s, {new} graphs captured, '
              f'launches {json.dumps(res["launches"])}', flush=True)
        if new == 0 and sweep > 0:
            break
    res['E_graph'] = E
    res['syncs'] = count_syncs(eng.sweep_static_batched)
    graphs = eng.static_graphs()
    bb = eng.psi.Bs[0].backend.block_backend
    held = {id(x): x for g in graphs for x in g.graph.keep}
    lru = {id(v) for v in bb._constants.values()}
    res['constants'] = len(bb._constants)
    print(f'[{label} graphs] {len(graphs)} graphs, captured in '
          f'{sum(g.capture_seconds for g in graphs):.2f} s; host syncs of a replayed sweep '
          f'{res["syncs"]} (at {count_syncs.where}); device constants held by the backend '
          f'{res["constants"]} (cap {_CONSTANTS_MAX}), device buffers held by the graphs '
          f'{len(held)} ({len(set(held) & lru)} of them the backend\'s constants); peak '
          f'reserved {torch.cuda.max_memory_reserved() / 1e9:.2f} GB', flush=True)
    if deep:
        res['profile_kernels'] = profile_run(f'{label} replayed sweep',
                                             eng.sweep_static_batched, top=10)
        if res['profile_kernels']:
            # the plan application of the fermionic symmetries (a concatenation, one
            # signed gather): the kernels one permute_legs launches, named, and their
            # share of the sweep's device time (an upper bound: other steps launch
            # kernels of these names too)
            sweep = profile_run.kernels
            theta = eng.psi.get_theta2(eng.psi.L // 2 - 1)
            profile_run(f'{label} one plan application',
                        lambda: permute_legs(theta, ['vL', 'p0'], ['vR', 'p1']), top=4)
            names = {name for name, _, _ in profile_run.kernels}
            plan = [(c, t) for name, c, t in sweep if name in names]
            busy = sum(t for _, _, t in sweep)
            print(f'[profile {label} replayed sweep] kernels of the plan application\'s '
                  f'names: {sum(c for c, _ in plan)} kernels, '
                  f'{sum(t for _, t in plan) / 1e3:.3f} ms, '
                  f'{100 * sum(t for _, t in plan) / busy:.1f} % of the device time',
                  flush=True)
        # drop every constant of the backend, reuse their memory, replay
        bb._constants.clear()
        torch.cuda.empty_cache()
        junk = torch.full((2 ** 27,), float('nan'), dtype=torch.float64, device='cuda')
        del junk
        E_kept = eng.sweep_static_batched()
        print(f'[{label} graphs] replayed after the backend dropped all '
              f'{res["constants"]} constants and their memory was written over: E = '
              f'{E_kept!r}, |E - E_dynamic| = {abs(E_kept - E_dyn):.3e} (the graphs held '
              f'{len(held)} of them alive; _CONSTANTS_MAX {torch_backend._CONSTANTS_MAX})',
              flush=True)
        res['E_static'].append(E_kept)
    bad = [E for E in res['E_static'] if not abs(E - E_dyn) < tol]
    if bad or res['syncs'] > 1 or res['launches']['grouped_gemm'] == 0 \
            or res['launches']['tridiag'] == 0:
        raise AssertionError(f'{label}: static sweeps off the dynamic energy ({bad}), more '
                             f'than one host sync, or no kernel launched')
    return res


def fermions_phase(deep: bool = False) -> dict:
    """Phase 16: fermions and the Ising-anyon chain (see the module docstring).
    ``deep`` (--fermions-only) takes (a) at L=32, chi_max=1024 and (b) at L=64, chi_max
    64. Returns the numbers of its kernels-line entries: the largest compose list of a
    Hubbard bond update and the launches of each kernel over the phase."""
    import torch
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, FermiHubbardModel, KitaevChainModel, SimpleMPS, mpo_from_bond_op,
        mpo_from_terms,
    )
    from cyten_tpu_torch.bench import recorded_lists
    from cyten_tpu_torch.models.couplings import hopping, sector_projection_coupling
    from cyten_tpu_torch.models.sites import IsingAnyonSite, SpinlessFermionSite
    from cyten_tpu_torch.tensors import eigh

    total = {'grouped_gemm': 0, 'thin': 0, 'tridiag': 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) the Fermi-Hubbard chain, FermionNumber('N') x U1('2*Sz') on the fusion-tree
    # backend, from half filling
    t_sub = time.perf_counter()
    L = 32 if deep else 8
    model = FermiHubbardModel(L, t=1., U=4.)
    label = f'fermions a Hubbard L={L}'
    psi = SimpleMPS.from_product_state(model.site_legs, [1, 2] * (L // 2))
    if str(psi.Bs[0].device).split(':')[0] != 'cuda' \
            or type(model.backend).__name__ != 'FusionTreeBackend':
        raise AssertionError('the Hubbard chain is not on the card\'s fusion-tree backend')
    _counts_zero()
    if deep:
        eng = DMRGEngine(psi, model, chi_max=1024, eps=0., lanczos_options={'N_max': 10})
        dyn = _sweeps_until(label, eng, 8)
        E_ref, tol = dyn['E'], 1e-8
        print(f'[{label}] dynamic: E = {dyn["E"]!r}, E/L {dyn["E"] / L!r}, max chi '
              f'{psi.max_chi()}, centre sectors {psi.Ss[L // 2].leg.num_sectors}', flush=True)
        if psi.max_chi() != 1024:
            raise AssertionError(f'{label}: the bond dimension did not reach chi_max')
    else:
        eng = DMRGEngine(psi, model, chi_max=256, eps=1e-14)
        dyn = _sweeps_until(label, eng, 8)
        t0 = time.perf_counter()
        E_ref = model.exact_finite_gs_energy([L, 0])
        print(f'[{label}] E = {dyn["E"]!r}, sparse ED of the N={L}, Sz=0 sector (4900 '
              f'states) {E_ref!r} in {time.perf_counter() - t0:.1f} s, |dE| '
              f'{abs(dyn["E"] - E_ref):.3e}', flush=True)
        if not abs(dyn['E'] - E_ref) < 1e-9:
            raise AssertionError(f'{label}: the DMRG energy is off exact diagonalization')
        E_ref, tol = dyn['E'], 1e-10
    c_dyn = _counts()
    add(c_dyn)
    # (e) the largest compose list of one bond update at the centre, on the kernel
    # against its plain version, held elementwise to check_f64's bound
    i = L // 2 - 1
    lists = recorded_lists(lambda: eng.update_bond(i))
    (_, As, Bs, ids, n_out, pairs), count = max(
        lists, key=lambda l: sum(t.numel() for t in (*l[0][1], *l[0][2])))
    compose = compare_kernel(f'fermions e Hubbard L={L} chi={psi.max_chi()} centre compose '
                             f'{list_name(As, Bs, pairs, count)}', As, Bs, ids, n_out,
                             As[0].dtype, pairs, as_given=True)
    static = _static_sweeps(label, eng, E_ref, tol, deep)
    c_static = _counts()
    add(c_static)
    var = psi.mpo_variance(model.H_mpo)
    print(f'[{label}] dynamic launches {json.dumps(c_dyn)} over {len(dyn["sweep_s"])} sweeps; '
          f's per dynamic sweep {json.dumps([round(x, 3) for x in dyn["sweep_s"]])}, per '
          f'static sweep (eager, then through graphs) '
          f'{json.dumps([round(x, 3) for x in static["static_s"]])}; replayed sweep '
          f'launches {json.dumps(static["launches"])}; mpo_variance {var:.3e}; '
          f'{len(lists)} lists in the centre bond update; '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    print(f'[fermions e] centre compose list: {compose["pairs"]} pairs into '
          f'{compose["outputs"]} outputs, err_units {compose["err_units"]:.4f}, device_ms '
          f'{compose["device_ms"]:.4f}, bound_ms {compose["bound_ms"]:.5f} '
          f'({compose["bound_by"]}), library_ms {compose["library_ms"]:.4f}, grouped-GEMM '
          f'launches in (a) {c_dyn["grouped_gemm"] + c_static["grouped_gemm"]}', flush=True)
    del eng, psi, model, lists, As, Bs
    torch.cuda.empty_cache()

    # (b) the Kitaev chain, FermionParity, from the vacuum (even parity) against the
    # BdG pair: the even sector's lowest energy is one of the two
    t_sub = time.perf_counter()
    L, chi_max = (64, 64) if deep else (32, 32)
    model = KitaevChainModel(L, t=1., delta=0.6, mu=0.4)
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L)
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=1e-14)
    _counts_zero()
    b = _sweeps_until(f'fermions b Kitaev L={L}', eng, 10)
    cb = _counts()
    add(cb)
    pair = model.exact_finite_gs_energy('both')
    dE = min(abs(b['E'] - e) for e in pair)
    print(f'[fermions b] Kitaev L={L}, chi_max {chi_max}: E = {b["E"]!r}, BdG pair '
          f'{json.dumps(pair)} (split {abs(pair[1] - pair[0]):.3e}), |dE| {dE:.3e}; s per '
          f'sweep {json.dumps([round(x, 3) for x in b["sweep_s"]])}; launches '
          f'{json.dumps(cb)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (dE < 1e-9 and cb['grouped_gemm'] > 0):
        raise AssertionError('fermions (b): the Kitaev energy or its launches wrong')
    del eng, psi, model

    # (c) spinless fermions with t1 = 1, t2 = 0.6 from mpo_from_terms (its odd
    # passthrough sector is the t2 hopping's string) against the single-particle
    # spectrum, and two correlations against the exact correlation matrix
    t_sub = time.perf_counter()
    L, t1, t2 = 16, 1., 0.6
    site = SpinlessFermionSite('N')
    h1 = hopping([site, site], t=t1).to_tensor()
    h2 = hopping([site, site], t=t2).to_tensor()
    mpo = mpo_from_terms([site.leg] * L, couplings=[(i, i + 1, h1) for i in range(L - 1)]
                         + [(i, i + 2, h2) for i in range(L - 2)], backend=site.backend)
    h_sp = np.diag(-t1 * np.ones(L - 1), 1) + np.diag(-t2 * np.ones(L - 2), 2)
    eps_sp, phi = np.linalg.eigh(h_sp + h_sp.T)
    n0 = int((eps_sp < 0).sum())
    E_exact = float(eps_sp[:n0].sum())
    corr = phi[:, :n0] @ phi[:, :n0].T
    psi = SimpleMPS.from_product_state([site.leg] * L, [1] * n0 + [0] * (L - n0),
                                       backend=site.backend)
    eng = DMRGEngine(psi, MpoModel(mpo), chi_max=64, eps=1e-14)
    _counts_zero()
    c = _sweeps_until(f'fermions c t1-t2 L={L}', eng, 10, tol=1e-11)
    cc = _counts()
    add(cc)
    Cd, C = site.get_op('Cd'), site.get_op('C')
    corrs = {(i, j): psi.correlation_function(Cd, i, C, j) for i, j in ((0, L - 1), (7, 8))}
    dC = max(abs(v - corr[i, j]) for (i, j), v in corrs.items())
    print(f'[fermions c] t1-t2 L={L}, N={n0}: E = {c["E"]!r}, single-particle {E_exact!r}, '
          f'|dE| {abs(c["E"] - E_exact):.3e}; <Cd_0 C_{L - 1}> {corrs[0, L - 1]!r}, '
          f'<Cd_7 C_8> {corrs[7, 8]!r}, largest error against the exact correlation '
          f'matrix {dC:.3e}; launches {json.dumps(cc)}; {time.perf_counter() - t_sub:.1f} s',
          flush=True)
    if not (abs(c['E'] - E_exact) < 1e-9 and dC < 1e-9 and cc['grouped_gemm'] > 0):
        raise AssertionError('fermions (c): the t1-t2 energy or correlations wrong')
    del eng, psi, mpo

    # (d) the Ising-anyon chain against the ED built inside the framework, on the card
    t_sub = time.perf_counter()
    L = 8
    site = IsingAnyonSite()
    h_bond = sector_projection_coupling([site, site], J=-1.,
                                        sector=site.leg.symmetry.trivial_sector).to_tensor()
    W, _ = eigh(full_chain_hamiltonian([h_bond] * (L - 1), site.leg, site.backend))
    E_ed = min(float(b.real.min()) for b in W.data.blocks)
    psi = SimpleMPS.from_fusion_pairs(site.leg, L, backend=site.backend)
    eng = DMRGEngine(psi, MpoModel(mpo_from_bond_op(h_bond, L)), chi_max=16, eps=1e-13)
    _counts_zero()
    d = _sweeps_until(f'fermions d Ising anyons L={L}', eng, 8)
    cd = _counts()
    add(cd)
    print(f'[fermions d] Ising-anyon chain L={L}: E = {d["E"]!r}, internal ED {E_ed!r} '
          f'(on {W.data.blocks[0].device}), |dE| {abs(d["E"] - E_ed):.3e}; launches {json.dumps(cd)}; '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(d['E'] - E_ed) < 1e-9 and cd['grouped_gemm'] > 0):
        raise AssertionError('fermions (d): the Ising-anyon energy or its launches wrong')
    del eng, psi, W
    torch.cuda.empty_cache()
    print(f'[fermions] launches over the phase: {json.dumps(total)}', flush=True)
    return {'compose': compose, 'launches': total}


def fermions_kernels(fermions: dict, tridiag: dict) -> list:
    """The kernels-line entries of phase 16: the grouped GEMM at the largest compose
    list of a Hubbard bond update and the tridiagonal kernel (its numbers from phase
    2b), each with its launches over phase 16."""
    keys = ('max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    return [{'name': 'grouped_gemm[fermions]', 'route': 'cuda',
             'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
             'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
             'launches': fermions['launches']['grouped_gemm'],
             **{k: fermions['compose'][k] for k in keys}},
            {'name': 'tridiag[fermions]', 'route': 'cuda',
             'source': 'cyten_tpu_torch/csrc/tridiag.cu',
             'replaces': 'jnp.linalg.eigh in cyten_tpu/tensors/krylov_based.py:396',
             'launches': fermions['launches']['tridiag'], **{k: tridiag[k] for k in keys}}]


def _hold_lists(label: str, lists, dtypes=None) -> dict:
    """Every list of ``lists`` (bench.recorded_lists) whose operands are of ``dtypes``
    (default f64; c128 and real x complex lists where phase 18 asks) on the kernel
    against its plain version, held elementwise by check_f64; then the largest list
    (and the largest thin one, where a list is thin) timed by compare_kernel. Returns
    their results."""
    import torch
    from cyten_tpu_torch.blocks.grouped_gemm import (
        grouped_matmul, grouped_matmul_plain, grouped_matmul_plan,
    )

    dtypes = {torch.float64} if dtypes is None else dtypes
    held, worst = 0, 0.
    lists = [e for e in lists if {e[0][1][0].dtype, e[0][2][0].dtype} <= dtypes]
    for (_, As, Bs, ids, n_out, pairs), _count in lists:
        got = grouped_matmul(As, Bs, ids, n_out, pairs)
        ref = grouped_matmul_plain(As, Bs, ids, n_out, pairs)
        torch.cuda.synchronize()
        _, units = check_f64(f'{label} list {held}', got, ref, As, Bs, ids, n_out, pairs)
        held += 1
        worst = max(worst, units)
    names = '/'.join(sorted(str(d).split('.')[-1] for d in dtypes))
    print(f'[{label}] {held} {names} lists held to 2 K 2^-52 |A||B|, largest err_units '
          f'{worst:.3f}', flush=True)
    if held == 0:
        raise AssertionError(f'{label}: no {names} list recorded')

    def size(entry):
        return sum(t.numel() for t in (*entry[0][1], *entry[0][2]))

    res = {}
    thin = [e for e in lists if grouped_matmul_plan(*e[0][1:6])[1].form is not None]
    for key, pool in (('largest', lists), ('thin', thin)):
        if not pool:
            continue
        (_, As, Bs, ids, n_out, pairs), count = max(pool, key=size)
        res[key] = compare_kernel(f'{label} {key} {list_name(As, Bs, pairs, count)}', As,
                                  Bs, ids, n_out, As[0].dtype, pairs, as_given=True,
                                  b_dtype=Bs[0].dtype)
    return res


def _centre_update_lists(eng) -> list:
    """The grouped-GEMM lists (bench.recorded_lists) of one right-moving one-site update
    at the centre of ``eng``'s chain, after right moves from site 0 that rebuild the
    left environments up to it (a finished sweep leaves them stale)."""
    from cyten_tpu_torch.bench import recorded_lists

    c = eng.psi.L // 2 - 1
    for i in range(c):
        eng.update_site(i, True)
    return recorded_lists(lambda: eng.update_site(c, True))


def _idmrg_until(label: str, eng, max_steps: int, tol: float) -> dict:
    """iDMRG steps until e/site changes by less than ``tol`` (at most ``max_steps``):
    e/site, the steps and the seconds of each."""
    import torch

    e, step_s = None, []
    for n in range(max_steps):
        t0 = time.perf_counter()
        e_new = eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if n % 10 == 0 or n == max_steps - 1:
            print(f'[{label}] step {eng.n_steps}: e/site {e_new!r}, {step_s[-1]:.3f} s, '
                  f'chi {int(eng.S.leg.dim)}', flush=True)
        done = e is not None and e_new is not None and abs(e_new - e) < tol
        e = e_new
        if done:
            break
    return {'e': e, 'steps': len(step_s), 'step_s': step_s}


def _dimerized_xx(J1: float, J2: float):
    """The dimerized XX chain's two-site MPO cell (bond J1 after site 0, J2 after site
    1, as tests/test_idmrg.py builds it) and its exact energy per site (the two-band
    integral)."""
    import scipy.integrate
    from cyten_tpu_torch.algorithms import spin_half_site
    from cyten_tpu_torch.algorithms.models import _factorize_bond
    from cyten_tpu_torch.backends import get_backend
    from cyten_tpu_torch.tensors import SymmetricTensor, tensor_from_grid

    p = spin_half_site('Sz')
    backend = get_backend(p.symmetry)
    Sp = np.array([[0., 1.], [0., 0.]])
    Sm = Sp.T

    def xx_bond(J):
        h = J / 2. * (np.kron(Sp, Sm) + np.kron(Sm, Sp))
        return SymmetricTensor.from_dense_block(
            h.reshape(2, 2, 2, 2).transpose(0, 1, 3, 2), [p, p], [p, p], backend=backend,
            labels=['p0', 'p1', 'p1*', 'p0*'])

    A1, B1, Id = _factorize_bond(xx_bond(J1), 1e-12)
    A2, B2, _ = _factorize_bond(xx_bond(J2), 1e-12)

    def W(A, B):
        return tensor_from_grid([[Id, A, None], [None, None, B], [None, None, Id]],
                                labels=['wL', 'p', 'wR', 'p*'], row_leg='wL',
                                col_leg='wR')

    class Dimerized:
        bc = 'infinite'
        H_mpo = [W(A1, B2), W(A2, B1)]

    t1, t2 = J1 / 2., J2 / 2.
    e_exact = -scipy.integrate.quad(lambda k: abs(t1 + t2 * np.exp(1j * k)),
                                    -np.pi, np.pi)[0] / (2 * np.pi) / 2.
    return Dimerized(), p, backend, e_exact


def infinite_phase(deep: bool = False) -> dict:
    """Phase 17: one-site DMRG and the infinite chain (see the module docstring).
    ``deep`` (--infinite-only) runs (a) to (f) at full width in place of the full run's
    two small checks. Returns the numbers of its kernels-line entries: each kernel's
    launches over the phase and the lists of a one-site update and an iDMRG step."""
    import torch
    from cyten_tpu_torch.algorithms import (
        DMRG1SEngine, DMRGEngine, HeisenbergModel, MultiCellIDMRGEngine, SimpleMPS,
        SpinChainModel, TFIModel, heisenberg_exact_finite_gs_energy, iDMRGEngine,
        tfi_exact_finite_gs_energy, tfi_exact_infinite_gs_energy,
    )
    from cyten_tpu_torch.bench import recorded_lists

    launches = {'dmrg1': {}, 'idmrg': {}}

    def add(kind, c):
        for k, v in c.items():
            launches[kind][k] = launches[kind].get(k, 0) + v

    def canonical_errors(psi):
        from cyten_tpu_torch.tensors import dagger, eye, norm, tdot
        errs = []
        for B in psi.Bs:
            E = tdot(B, dagger(B), ['p', 'vR'], ['p*', 'vR*'])
            ey = eye([B.get_leg_co_domain('vL')], backend=B.backend, labels=['vL', 'vL*'],
                     dtype=B.dtype).as_SymmetricTensor()
            errs.append(float(norm(E + (-1.) * ey)))
        return errs

    lists = {}
    bethe = 0.25 - np.log(2.)
    if not deep:
        # DMRG1S on the parity TFI chain at L=8, chi 16 (tests/test_dmrg1.py's run, five
        # of its sweeps), against the exact energy
        t_sub = time.perf_counter()
        L, g = 8, 1.2
        model = TFIModel(L=L, g=g, conserve='parity')
        psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
        eng = DMRG1SEngine(psi, model, chi_max=16, eps=1e-14, alpha=1e-2, alpha_decay=0.2,
                           alpha_min=1e-10)
        _counts_zero()
        E = eng.run(n_sweeps=5, tol=1e-13)
        torch.cuda.synchronize()
        c = _counts()
        add('dmrg1', c)
        E_exact = tfi_exact_finite_gs_energy(L, 1., g)
        print(f'[infinite dmrg1] TFI L={L}, g={g}, chi_max 16, five sweeps: E = {E!r}, exact '
              f'{E_exact!r}, |dE| {abs(E - E_exact):.3e}, max chi {psi.max_chi()}; launches '
              f'{json.dumps(c)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
        if not (abs(E - E_exact) < 1e-10 and psi.max_chi() == 16 and c['grouped_gemm'] > 0):
            raise AssertionError('phase 17: the one-site TFI energy, chi or launches wrong')
        eng.alpha = 1e-2  # the expansion on: its lists too
        lists['dmrg1'] = _centre_update_lists(eng)
        # iDMRG on the parity TFI chain at g=1.5, chi 32, against the exact density
        t_sub = time.perf_counter()
        model = TFIModel(L=2, g=1.5, conserve='parity', bc='infinite')
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                           bc='infinite')
        ieng = iDMRGEngine(psi, model, chi_max=32, eps=1e-12)
        _counts_zero()
        e = ieng.run(n_steps=150, tol=1e-12)
        torch.cuda.synchronize()
        c = _counts()
        add('idmrg', c)
        e_exact = tfi_exact_infinite_gs_energy(1., 1.5)
        print(f'[infinite idmrg] TFI g=1.5, chi_max 32: e/site {e!r}, exact {e_exact!r}, '
              f'|de| {abs(e - e_exact):.3e} after {ieng.n_steps} steps; launches '
              f'{json.dumps(c)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
        if not (abs(e - e_exact) < 1e-9 and c['grouped_gemm'] > 0):
            raise AssertionError('phase 17: the iDMRG TFI energy or its launches wrong')
        lists['idmrg'] = recorded_lists(ieng.step)
        out = {k: _hold_lists(f'infinite {k}', v) for k, v in lists.items()}
        return {'lists': out, 'launches': launches}

    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul

    # (a) DMRG1S on the U(1) Heisenberg chain at L=24, chi_max=1024, from the Neel state,
    # swept until E moves by less than 1e-10; then, from the converged state, one more
    # one-site sweep and one two-site dynamic sweep (N_max=10, the same eps), timed
    t_sub = time.perf_counter()
    L, chi_max, eps = 24, 1024, 1e-14
    alpha, alpha_decay, max_sweeps = 1e-3, 0.5, 16
    model = HeisenbergModel(L=L, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    eng = DMRG1SEngine(psi, model, chi_max=chi_max, eps=eps, alpha=alpha,
                       alpha_decay=alpha_decay)
    E, sweep_s, per_sweep, chis = None, [], [], []

    def timed_sweep(engine):
        before = grouped_matmul.launches
        t0 = time.perf_counter()
        E_new = engine.sweep()
        torch.cuda.synchronize()
        return E_new, time.perf_counter() - t0, grouped_matmul.launches - before

    _counts_zero()
    for sweep in range(max_sweeps):
        E_new, sec, n = timed_sweep(eng)
        sweep_s.append(sec)
        per_sweep.append(n)
        chis.append(psi.max_chi())
        print(f'[infinite a] DMRG1S L={L} sweep {sweep + 1}: E = {E_new!r}, {sec:.2f} s, '
              f'max chi {chis[-1]}, alpha {eng.alpha:.1e}, grouped-GEMM launches {n}',
              flush=True)
        done = E is not None and abs(E_new - E) < 1e-10
        E = E_new
        if done:  # the sweep that shows it is the converged one-site sweep
            break
    c = _counts()
    add('dmrg1', c)
    converged = {'one-site': (sweep_s[-1], per_sweep[-1])}
    eng.alpha = alpha  # one centre update with the expansion on, for its lists
    lists['dmrg1'] = _centre_update_lists(eng)
    two = DMRGEngine(psi, model, chi_max=chi_max, eps=eps, lanczos_options={'N_max': 10})
    E2, two_s, two_n = timed_sweep(two)
    converged['two-site'] = (two_s, two_n)
    print(f'[infinite a] DMRG1S Heisenberg L={L}, chi_max {chi_max}, eps {eps}, alpha '
          f'{alpha}, alpha_decay {alpha_decay}: E = {E!r}, ref {HEIS24_E_REF!r}, |dE| '
          f'{abs(E - HEIS24_E_REF):.3e} after {len(sweep_s)} sweeps; max chi per sweep '
          f'{json.dumps(chis)}; s per sweep '
          f'{json.dumps([round(x, 3) for x in sweep_s])}, grouped-GEMM launches per sweep '
          f'{json.dumps(per_sweep)}; from the converged state, (s, launches) a sweep: '
          f'{json.dumps(converged)} (the two-site sweep: E = {E2!r}, max chi '
          f'{psi.max_chi()}); {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(E - HEIS24_E_REF) < 1e-8 and c['grouped_gemm'] > 0):
        raise AssertionError('phase 17 (a): the one-site L=24 energy or its launches wrong')
    del eng, two, psi, model
    torch.cuda.empty_cache()

    # (b) DMRG1S on the SU(2) chain at L=8, once with each mixer, against ED
    for mixer in ('expand', 'density_matrix'):
        t_sub = time.perf_counter()
        L = 8
        model = HeisenbergModel(L=L, conserve='SU(2)')
        psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
        eng = DMRG1SEngine(psi, model, chi_max=24, eps=1e-14, alpha=1e-2, mixer=mixer)
        _counts_zero()
        E = None
        for sweep in range(12):
            E_new = eng.sweep()
            done = E is not None and abs(E_new - E) < 1e-12
            E = E_new
            if done:
                break
        torch.cuda.synchronize()
        c = _counts()
        add('dmrg1', c)
        E_exact = heisenberg_exact_finite_gs_energy(L, 1.)
        print(f'[infinite b] DMRG1S SU(2) L={L}, mixer {mixer}: E = {E!r}, exact '
              f'{E_exact!r}, |dE| {abs(E - E_exact):.3e} after {sweep + 1} sweeps; '
              f'launches {json.dumps(c)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
        if not (abs(E - E_exact) < 1e-9 and c['grouped_gemm'] > 0):
            raise AssertionError(f'phase 17 (b): the SU(2) {mixer} energy or launches wrong')

    # (c) iDMRG on the critical U(1) Heisenberg chain at chi_max=1024
    t_sub = time.perf_counter()
    model = HeisenbergModel(L=2, conserve='Sz', bc='infinite')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1], backend=model.backend,
                                       bc='infinite')
    ieng = iDMRGEngine(psi, model, chi_max=1024, eps=1e-12)
    _counts_zero()
    run = _idmrg_until('infinite c', ieng, 120, 1e-10)
    c = _counts()
    add('idmrg', c)
    lists['idmrg'] = recorded_lists(ieng.step)
    t0 = time.perf_counter()
    xi = ieng.psi.correlation_length()
    xi_s = time.perf_counter() - t0
    e = run['e']
    print(f'[infinite c] iDMRG Heisenberg chi_max 1024: e/site {e!r}, Bethe {bethe!r}, '
          f'gap {e - bethe:.3e} after {run["steps"]} steps (chi {int(ieng.S.leg.dim)}); s '
          f'per step: median {np.median(run["step_s"]):.3f}, last '
          f'{run["step_s"][-1]:.3f}, total {sum(run["step_s"]):.1f}; launches '
          f'{json.dumps(c)} ({c["grouped_gemm"] / run["steps"]:.0f} per step); '
          f'correlation_length {xi!r} in {xi_s:.2f} s; {time.perf_counter() - t_sub:.1f} s',
          flush=True)
    if not (abs(e - bethe) < 5e-5 and c['grouped_gemm'] > 0 and xi > 0):
        raise AssertionError('phase 17 (c): the critical iDMRG energy or launches wrong')
    del ieng, psi, model
    torch.cuda.empty_cache()

    # (d) the spin-1 Haldane chain at chi 48, and both canonical forms of its cell
    t_sub = time.perf_counter()
    model = SpinChainModel(L=2, S=1.0, conserve='Sz', bc='infinite')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 2], backend=model.backend,
                                       bc='infinite')
    ieng = iDMRGEngine(psi, model, chi_max=48, eps=1e-12)
    _counts_zero()
    e = ieng.run(n_steps=400, tol=1e-12)
    c = _counts()
    add('idmrg', c)
    iso = {}
    for method in ('fixed_point', 'window'):
        t0 = time.perf_counter()
        cell = ieng.psi.canonicalize_infinite(method=method,
                                              n_cells=16 if method == 'window' else None)
        iso[method] = {'errors': canonical_errors(cell),
                       'energy': model.energy(cell),
                       's': time.perf_counter() - t0}
    print(f'[infinite d] Haldane chain chi_max 48: e/site {e!r}, ref {HALDANE_E_PER_SITE!r}, '
          f'|de| {abs(e - HALDANE_E_PER_SITE):.3e} after {ieng.n_steps} steps; launches '
          f'{json.dumps(c)}; canonical forms (each B\'s isometry error, e/site, s) '
          f'{json.dumps(iso)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(e - HALDANE_E_PER_SITE) < 1e-5
            and max(max(v['errors']) for v in iso.values()) < 1e-10):
        raise AssertionError('phase 17 (d): the Haldane energy or a canonical form wrong')

    # (e) the multi-cell engine on the uniform L=4 Heisenberg cell at chi 16
    t_sub = time.perf_counter()
    model = HeisenbergModel(L=4, conserve='Sz', bc='infinite')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1],
                                       backend=model.backend, bc='infinite')
    meng = MultiCellIDMRGEngine(psi, model, chi_max=16, eps=1e-12)
    _counts_zero()
    e = meng.run(n_steps=20, tol=1e-9)
    c = _counts()
    add('idmrg', c)
    print(f'[infinite e] multi-cell L=4 Heisenberg chi_max 16: e/site {e!r}, Bethe '
          f'{bethe!r}, gap {e - bethe:.3e} after {meng.n_steps} steps; launches '
          f'{json.dumps(c)}; {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(e - bethe) < 2e-4 and c['grouped_gemm'] > 0):
        raise AssertionError('phase 17 (e): the multi-cell energy or launches wrong')

    # (f) the multi-cell engine on the dimerized XX chain at chi 32
    t_sub = time.perf_counter()
    model, p, backend, e_exact = _dimerized_xx(1.0, 0.6)
    psi = SimpleMPS.from_product_state([p, p], [0, 1], backend=backend, bc='infinite')
    meng = MultiCellIDMRGEngine(psi, model, chi_max=32, eps=1e-12)
    _counts_zero()
    e = meng.run(n_steps=60, tol=1e-10)
    c = _counts()
    add('idmrg', c)
    print(f'[infinite f] multi-cell dimerized XX (J1 1, J2 0.6) chi_max 32: e/site {e!r}, '
          f'band integral {e_exact!r}, |de| {abs(e - e_exact):.3e} after {meng.n_steps} '
          f'steps; launches {json.dumps(c)}; {time.perf_counter() - t_sub:.1f} s',
          flush=True)
    if not (abs(e - e_exact) < 1e-6 and c['grouped_gemm'] > 0):
        raise AssertionError('phase 17 (f): the dimerized XX energy or launches wrong')
    out = {k: _hold_lists(f'infinite {k}', v) for k, v in lists.items()}
    return {'lists': out, 'launches': launches}


def infinite_kernels(infinite: dict) -> list:
    """The kernels-line entries of phase 17: the grouped GEMM at the largest list of a
    one-site update and of an iDMRG step, each with the launches of its engines over
    the phase, and its thin form at the largest thin list of either, with the thin
    launches over the phase."""
    keys = ('max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    source = {'route': 'cuda', 'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
              'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151'}
    lists, launches = infinite['lists'], infinite['launches']
    res = [{'name': f'grouped_gemm[{kind}]', **source,
            'launches': launches[kind].get('grouped_gemm', 0),
            **{k: lists[kind]['largest'][k] for k in keys}} for kind in ('dmrg1', 'idmrg')]
    thin = [lists[kind]['thin'] for kind in ('dmrg1', 'idmrg') if 'thin' in lists[kind]]
    n_thin = sum(launches[kind].get('thin', 0) for kind in ('dmrg1', 'idmrg'))
    if thin:
        res.append({'name': 'grouped_gemm[thin, infinite]', **source, 'launches': n_thin,
                    **{k: max(thin, key=lambda r: r['mbytes'])[k] for k in keys}})
    elif n_thin:
        raise AssertionError('phase 17: thin launches counted but no thin list recorded')
    return res


def tridiag_evolve_phase() -> dict:
    """Phase 18's kernel: tridiagonal_evolve (csrc/tridiag.cu) against its plain version
    on every Lanczos family of tests/test_torch_tridiag.py (closed Krylov spaces among
    them: zero betas before N), from f64 and f32 buffers, at a real (imaginary-time)
    and an imaginary (real-time) delta and a complex one, each coefficient to 1e-12 of
    the largest; NaN in, NaN out. Then, at N=30 (the TDVP engines' Krylov length), its
    times in turns: the wrapper (ms), the C entry point (device_ms), launches replayed
    from a CUDA graph (graph_ms), beside the plain version, torch.linalg.matrix_exp of
    delta T (library_ms: one PyTorch call computing the same function) and
    torch.linalg.eigh of T, the bound, and the host syncs of eigh and matrix_exp on the
    card. Returns the N=30 numbers."""
    import torch
    from cyten_tpu_torch.blocks._kernels import call, function
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve, tridiagonal_evolve_plain

    families = tridiag_families()[0]
    err, rel = 0., 0.
    for label, ab in families:
        for dtype in (torch.float64, torch.float32):
            t = torch.from_numpy(ab).to(dtype)
            nrm0 = torch.tensor(0.75, dtype=dtype)
            for delta in (-0.025, -0.025j, 0.01 - 0.025j):
                got = tridiagonal_evolve(t.cuda(), delta, nrm0.cuda()).cpu()
                want = tridiagonal_evolve_plain(t, delta, nrm0)
                e = float((got - want).abs().max())
                scale = max(1., float(want.abs().max()))
                if got.dtype != want.dtype or not e <= 1e-12 * scale:
                    raise AssertionError(f'tridiag_evolve {label} {dtype} delta {delta}: '
                                         f'{e} past 1e-12 x {scale}')
                err, rel = max(err, e), max(rel, e / scale)
    bad = torch.from_numpy(families[-1][1]).cuda()
    bad[0, 3] = float('nan')
    if not torch.isnan(tridiagonal_evolve(bad, -0.025j, torch.ones((), dtype=bad.dtype,
                                                                    device='cuda'))).all():
        raise AssertionError('tridiag_evolve: NaN input did not give NaN output')
    print(f'[tridiag evolve] {len(families)} families x f64/f32 x 3 deltas against plain: '
          f'max |dc| {err:.3e} ({rel:.3e} of the largest coefficient); NaN in, NaN out',
          flush=True)

    n, delta = 30, -0.025j
    rng = np.random.default_rng(18)
    ab = torch.from_numpy(np.stack([rng.normal(size=n), 0.1 + np.abs(rng.normal(size=n))]))
    ab = ab.cuda()
    nrm0 = torch.ones((), dtype=torch.float64, device='cuda')
    out = torch.empty(n, dtype=torch.complex128, device='cuda')
    fn = function('tridiag', 'cyten_tridiag_evolve')
    kernel = lambda: call(fn, (ab.data_ptr(), nrm0.data_ptr(), 0, n, 0., delta.imag, 1,  # noqa: E731
                               out.data_ptr()), 0, 'tridiag_evolve')
    a, b = ab
    T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    dT = (delta * T).to(torch.complex128)
    (ms, device_ms, library_ms, eigh_ms), spread = turns(
        [lambda: tridiagonal_evolve(ab, delta, nrm0), kernel,
         lambda: torch.linalg.matrix_exp(dT), lambda: torch.linalg.eigh(T)], 50, rounds=4)
    res = {'N': n, 'max_abs_err': err, 'ms': ms, 'device_ms': device_ms,
           'graph_ms': graph_ms(kernel),
           'plain_ms': cuda_ms(lambda: tridiagonal_evolve_plain(ab, delta, nrm0), reps=20),
           'library_ms': library_ms, 'eigh_ms': eigh_ms,
           'syncs': {'eigh': count_syncs(lambda: torch.linalg.eigh(T)),
                     'matrix_exp': count_syncs(lambda: torch.linalg.matrix_exp(dT)),
                     'tridiag_evolve': count_syncs(
                         lambda: tridiagonal_evolve(ab, delta, nrm0))},
           'spread': dict(zip(('ms', 'device_ms', 'library_ms', 'eigh_ms'), spread))}
    # read 2N + 1 f64, write N c128; the work the function needs: the eigenvectors of T
    # (about two QL sweeps an eigenvalue, each rotation 6 operations a row: 6 N^3) and
    # the combination (8 N^2)
    t_bytes = ((2 * n + 1) * 8 + n * 16) / hbm_bytes_per_s()
    t_ops = (6 * n ** 3 + 8 * n ** 2) / peak_ops_per_s(torch.float64)
    res['bound_ms'] = max(t_bytes, t_ops) * 1e3
    res['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
    print(f'[tridiag evolve] N={n}: ' + json.dumps(res), flush=True)
    if res['syncs']['tridiag_evolve']:
        raise AssertionError('tridiag_evolve synced with the host')
    return res


def _full_vector(psi) -> np.ndarray:
    """The state vector of a finite MPS (site 0 slowest), on the host."""
    from cyten_tpu_torch.tensors import tdot

    s = psi.get_theta1(0)
    for i in range(1, psi.L):
        s = tdot(s, psi.Bs[i].relabelled({'p': f'p{i}'}), 'vR', 'vL')
    return np.asarray(s.to_numpy()).reshape(-1)


def _bond_sum_sparse(H_bonds, d: int):
    """The sparse Hamiltonian sum_i h_i of the finite chain's bond terms (legs [p0, p1,
    p1*, p0*]) on the public basis, site 0 slowest."""
    import scipy.sparse as sp

    L = len(H_bonds) + 1
    H = sp.csr_matrix((d ** L, d ** L), dtype=complex)
    for i, h in enumerate(H_bonds):
        hd = np.asarray(h.to_numpy()).transpose(0, 1, 3, 2).reshape(d * d, d * d)
        H = H + sp.kron(sp.kron(sp.identity(d ** i), sp.csr_matrix(hd)),
                        sp.identity(d ** (L - i - 2))).tocsr()
    return H


def _overlap_error(a: np.ndarray, b: np.ndarray) -> float:
    return abs(abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)) - 1.)


def _mps_overlap_error(a, b) -> float:
    """1 - |<a|b>| / (|a| |b|) of two finite MPS, contracted on the card."""
    ab, aa, bb = (abs(complex(x.overlap(y))) for x, y in ((a, b), (a, a), (b, b)))
    return abs(ab / np.sqrt(aa * bb) - 1.)


def _distance(a: np.ndarray, b: np.ndarray) -> float:
    """|a - b| / |a| of two state vectors: linear in the error, global phase included."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _mps_distance(a, b) -> tuple:
    """|a - b| / |a| of two finite MPS from their three overlaps, contracted on the card,
    and |a - b|^2 / |a|^2 = (<a|a> + <b|b> - 2 Re <a|b>) / <a|a> as it came out. The
    overlaps' rounding, a few ulps of <a|a>, sets a floor under the square, some 1e-15,
    and so under the distance, the square root of that: below it, the square is noise of
    either sign."""
    ab, aa, bb = complex(a.overlap(b)), complex(a.overlap(a)).real, complex(b.overlap(b)).real
    sq = (aa + bb - 2. * ab.real) / aa
    return float(np.sqrt(max(sq, 0.))), sq


def _evo_counts_zero() -> None:
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve

    _counts_zero()
    tridiagonal_evolve.launches = 0
    grouped_matmul.converted = 0


def _evo_counts() -> dict:
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve

    return {**_counts(), 'tridiag_evolve': tridiagonal_evolve.launches,
            'converted': grouped_matmul.converted}


def _timed_steps(label: str, eng, n: int, step=None) -> dict:
    """``n`` steps of ``eng`` (``eng.sweep`` or ``step``), each timed to a synchronize
    with its kernel launches counted; prints a line a step."""
    import torch

    step = eng.sweep if step is None else step
    secs, counts = [], []
    for k in range(n):
        _evo_counts_zero()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(_evo_counts())
        print(f'[{label}] step {k + 1}: {secs[-1]:.3f} s, launches {json.dumps(counts[-1])}',
              flush=True)
    return {'s': secs, 'counts': counts}


def _as_complex(psi):
    """``psi`` with complex128 tensors: a real state that real-time evolution would make
    complex at its first step, made so before it, so that a fused engine's first step
    meets the structures (dtypes included) of every later one."""
    from cyten_tpu_torch import Dtype
    from cyten_tpu_torch.algorithms import SimpleMPS

    return SimpleMPS([B.to_dtype(Dtype.complex128) for B in psi.Bs], list(psi.Ss), bc=psi.bc)


def _diag_op(leg, backend, diag):
    """The single-site operator diag(``diag``) on the public basis of ``leg`` (a [p, p*]
    tensor): Sz of a spin-1/2 site as diag(0.5, -0.5), the TFI chain's sz as
    diag(1, -1)."""
    from cyten_tpu_torch.tensors import SymmetricTensor

    return SymmetricTensor.from_dense_block(np.diag(np.asarray(diag, float)), [leg], [leg],
                                            backend=backend, labels=['p', 'p*'])


def _tdvp_site_step_lists(eng, i: int) -> list:
    """The grouped-GEMM lists of one fused right-moving site step of ``eng`` (a
    TDVPQREngine) at site i, run eagerly on the state as it is."""
    from cyten_tpu_torch.algorithms.tdvp import _site_step
    from cyten_tpu_torch.bench import recorded_lists

    d_site, d_bond = eng._deltas(eng.dt / 2.)
    fn = _site_step('R', d_site, d_bond, eng.lanczos_options.get('N_max', 30), {})
    args = (eng.LPs[i], eng.RPs[i], eng.model.H_mpo[i], eng.psi.get_theta1(i))
    return recorded_lists(lambda: fn(*args))


def evolution_phase(deep: bool = False) -> dict:
    """Phase 18: time evolution (see the module docstring). ``deep`` (--evolution-only)
    runs (a) to (e) at full width in place of the full run's small checks. Every f64 and
    c128 list of one TDVP site step, one TEBD bond and one iTDVP step is held to its
    plain version (check_f64). Returns the launches over the phase and the lists'
    results, for the kernels line."""
    import scipy.linalg
    import scipy.sparse.linalg as spla
    import torch
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, HeisenbergModel, SimpleMPS, SpinChainModel, TDVP2Engine, TDVPEngine,
        TDVPQREngine, TEBDEngine, TFIModel, VUMPSEngine, iDMRGEngine, iTDVPEngine,
        tfi_exact_infinite_gs_energy,
    )
    from cyten_tpu_torch.bench import recorded_lists

    launches = {}

    def add(c):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v

    def steps(label, eng, n, step=None):
        run = _timed_steps(label, eng, n, step)
        for c in run['counts']:
            add(c)
        return run

    c128 = {torch.float64, torch.complex128}
    lists = {}
    if not deep:
        # the TFI chain at L=8 (parity), from a DMRG state at g=1 (chi 16, full rank),
        # under g=1.5: 1-TDVP, TDVP2 and TEBD against exact evolution, the fused QR
        # engine through graphs against the eager one. (At g=3 the smallest Schmidt
        # values lie near the rounding, which then decides the directions that carry
        # them, and the two engines part by far more than the rounding:
        # scripts/torch_tdvp_conditioning.py.)
        t_sub = time.perf_counter()
        L, g = 8, 1.5
        model = TFIModel(L=L, g=g, conserve='parity')
        model0 = TFIModel(L=L, g=1.0, conserve='parity')
        psi0 = SimpleMPS.from_product_state(model0.site_legs, [0] * L, backend=model0.backend)
        DMRGEngine(psi0, model0, chi_max=16, eps=1e-14).run(n_sweeps=3)
        H = _bond_sum_sparse(model.H_bonds, 2)
        v0 = _full_vector(psi0)
        psi = psi0.copy()
        eng = TDVPEngine(psi, model, dt=0.05)
        E0 = eng.energy()
        run = steps('evolution tdvp L=8', eng, 1)
        v = _full_vector(psi)
        exact = spla.expm_multiply(-1j * 0.05 * H, v0)
        checks = {'tdvp': (_overlap_error(exact, v), abs(eng.energy() - E0),
                           abs(np.linalg.norm(v) - np.linalg.norm(v0)))}
        psi2 = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
        w0 = _full_vector(psi2)
        steps('evolution tdvp2 L=8', TDVP2Engine(psi2, model, dt=0.1, chi_max=16), 1)
        w = _full_vector(psi2)
        checks['tdvp2'] = (_overlap_error(spla.expm_multiply(-1j * 0.1 * H, w0), w),
                           psi2.max_chi(), abs(np.linalg.norm(w) - 1.))
        psi3 = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
        tebd = TEBDEngine(psi3, model, dt=0.05, chi_max=16, imaginary=False)
        steps('evolution tebd L=8', tebd, 6)
        sz = _diag_op(model.site_legs[0], model.backend, [1., -1.])
        u = spla.expm_multiply(-1j * 0.3 * H, w0)
        sz_mid = np.kron(np.kron(np.eye(2 ** (L // 2)), np.diag([1., -1.])),
                         np.eye(2 ** (L - L // 2 - 1)))
        sz_ed = float(np.real(np.vdot(u, sz_mid @ u)))
        sz_mps = float(np.real(complex(psi3.site_expectation_value(sz, L // 2))))
        checks['tebd'] = (abs(sz_mps - sz_ed),)
        lists['tebd'] = recorded_lists(lambda: tebd.update_bond(L // 2 - 1,
                                                                tebd.U_full[L // 2 - 1]))
        # (a complex start: the fused engine's first step is its only eager one)
        psi_q, psi_f = _as_complex(psi0), _as_complex(psi0)
        opts = {'lanczos_options': {'N_max': 12}}
        steps('evolution qr L=8', TDVPQREngine(psi_q, model, dt=0.05, **opts), 3)
        fused = TDVPQREngine(psi_f, model, dt=0.05, fused=True, **opts)
        frun = steps('evolution qr fused L=8', fused, 3)
        checks['fused'] = (_distance(_full_vector(psi_q), _full_vector(psi_f)),
                           len(fused.graphs()), frun['counts'][-1]['tridiag_evolve'])
        lists['tdvp'] = _tdvp_site_step_lists(fused, L // 2 - 1)
        print(f'[evolution small] TFI L={L}: 1-TDVP (overlap error, |dE|, |d norm|) '
              f'{checks["tdvp"]}; TDVP2 (overlap error, chi, |d norm|) {checks["tdvp2"]}; '
              f'TEBD |<sz_mid> - exact| {checks["tebd"][0]:.3e}; fused against eager QR '
              f'(|a - b| / |a|, graphs, tridiag_evolve launches of a replayed sweep) '
              f'{checks["fused"]}; {time.perf_counter() - t_sub:.1f} s', flush=True)
        if not (checks['tdvp'][0] < 1e-8 and max(checks['tdvp'][1:]) < 1e-10
                and checks['tdvp2'][0] < 1e-8 and checks['tdvp2'][1] > 1
                and checks['tdvp2'][2] < 1e-8 and checks['tebd'][0] < 5e-4
                and checks['fused'][0] < 1e-10 and checks['fused'][1] > 0
                and checks['fused'][2] > 0 and run['counts'][-1]['grouped_gemm'] > 0):
            raise AssertionError('phase 18: a small evolution check failed')
        # the infinite TFI chain at g=1.5, chi 16: iTDVP in imaginary time and VUMPS
        t_sub = time.perf_counter()
        imodel = TFIModel(L=2, g=1.5, conserve='parity', bc='infinite')
        ipsi = SimpleMPS.from_product_state(imodel.site_legs, [0, 0], backend=imodel.backend,
                                            bc='infinite')
        ieng = iDMRGEngine(ipsi, imodel, chi_max=16, eps=1e-14)
        ieng.run(n_steps=150, tol=1e-13)
        cell = ieng.psi.canonicalize_infinite(n_cells=20)
        e_exact = tfi_exact_infinite_gs_energy(1., 1.5)
        it = iTDVPEngine(cell.copy(), imodel, dt=0.05, imaginary=True)
        steps('evolution itdvp chi 16', it, 2, it.step)
        lists['itdvp'] = recorded_lists(it.step)
        e_it = it.energy_density()
        vu = VUMPSEngine(cell.copy(), imodel)
        e_vu = vu.run(max_iter=8, tol=1e-11)
        print(f'[evolution small] infinite TFI g=1.5, chi 16: iTDVP imaginary time e/site '
              f'{e_it!r}, exact {e_exact!r}, |de| {abs(e_it - e_exact):.3e}; VUMPS {e_vu!r} '
              f'(|de| {abs(e_vu - e_exact):.3e}, gradient {vu.grad_norm:.3e}, '
              f'{vu.n_steps} iterations); {time.perf_counter() - t_sub:.1f} s', flush=True)
        if not (abs(e_it - e_exact) < 1e-12 and abs(e_vu - e_exact) < 1e-12):
            raise AssertionError('phase 18: the iTDVP or VUMPS energy density is off')
        out = {k: _hold_lists(f'evolution {k}', v, c128) for k, v in lists.items()}
        return {'lists': out, 'launches': launches}

    # (a) finite TDVP at chi 1024 from the L=24 Heisenberg ground state with Sz applied
    # at site 12
    t_sub = time.perf_counter()
    L = 24
    model = HeisenbergModel(L=L, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2))
    dmrg = _sweep_to_convergence('evolution a DMRG', DMRGEngine(
        psi, model, chi_max=1024, eps=0., lanczos_options={'N_max': 10}), max_sweeps=8)
    if not (abs(dmrg['E'] - HEIS24_E_REF) < 1e-8 and psi.max_chi() == 1024):
        raise AssertionError('phase 18 (a): the L=24 ground state is off')
    psi0 = _as_complex(psi.apply_local_op(_diag_op(model.site_legs[12], model.backend,
                                                   [.5, -.5]), 12))
    del psi
    print(f'[evolution a] ground state E {dmrg["E"]!r} in {dmrg["sweeps"]} sweeps, chi '
          f'{psi0.max_chi()}; Sz applied at site 12: <psi|psi> '
          f'{abs(complex(psi0.overlap(psi0))):.12f}; {time.perf_counter() - t_sub:.1f} s',
          flush=True)
    n_steps = EVOLUTION_STEPS
    res_a = {}
    for name, kw in (('svd', None), ('qr', {}), ('qr fused', {'fused': True})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p = psi0.copy()
        eng = TDVPEngine(p, model, dt=0.05) if kw is None else TDVPQREngine(p, model, dt=0.05,
                                                                            **kw)
        E0, n0 = eng.energy(), abs(complex(p.overlap(p)))
        run = steps(f'evolution a {name}', eng, n_steps)
        E1, n1 = eng.energy(), abs(complex(p.overlap(p)))
        entry = {'psi': p.copy(), 'E': (E0, E1), 'norm2': (n0, n1), 's': run['s'],
                 'counts': run['counts'][-1],
                 'peak_reserved_gb': torch.cuda.max_memory_reserved() / 1e9}
        if name == 'qr fused':
            graphs = eng.graphs()
            entry['graphs'] = len(graphs)
            entry['capture_s'] = sum(g.capture_seconds for g in graphs)
            entry['syncs'] = count_syncs(eng.sweep)
            entry['syncs_at'] = count_syncs.where
            entry['profile_kernels'] = profile_run('replayed fused TDVP sweep', eng.sweep)
            lists['tdvp'] = _tdvp_site_step_lists(eng, L // 2 - 1)
        res_a[name] = entry
        print(f'[evolution a] {name}: E {E0!r} -> {E1!r} (|dE| {abs(E1 - E0):.3e}), '
              f'<psi|psi> {n0!r} -> {n1!r}; s per step '
              f'{json.dumps([round(x, 3) for x in run["s"]])}; launches of the last step '
              f'{json.dumps(entry["counts"])}; peak reserved {entry["peak_reserved_gb"]:.2f} GB'
              + (f'; {entry["graphs"]} graphs captured in {entry["capture_s"]:.2f} s; host '
                 f'syncs of a replayed sweep {entry["syncs"]} (at {entry["syncs_at"]})'
                 if name == 'qr fused' else ''), flush=True)
        del eng
        if not (abs(E1 - E0) < 1e-8 and abs(n1 - n0) < 1e-8):
            raise AssertionError(f'phase 18 (a) {name}: energy or norm not conserved')
    ov_qr = _mps_overlap_error(res_a['svd']['psi'], res_a['qr']['psi'])
    ov_fused = _mps_overlap_error(res_a['qr']['psi'], res_a['qr fused']['psi'])
    # the fused engine against the eager QR one, also linearly; beside it the same measure
    # between the eager QR state and itself regauged (canonicalize): its rounding floor
    d_fused, sq_fused = _mps_distance(res_a['qr']['psi'], res_a['qr fused']['psi'])
    d_floor, sq_floor = _mps_distance(res_a['qr']['psi'],
                                      res_a['qr']['psi'].copy().canonicalize(normalize=False))
    print(f'[evolution a] QR against SVD: overlap error {ov_qr:.3e}; fused against QR: '
          f'overlap error {ov_fused:.3e}, |a - b| / |a| {d_fused:.3e} (its square '
          f'{sq_fused:.3e}); the eager QR state against itself regauged {d_floor:.3e} '
          f'(its square {sq_floor:.3e}); {time.perf_counter() - t_sub:.1f} s', flush=True)
    fused = res_a['qr fused']
    if not (ov_qr < 1e-8 and ov_fused < 1e-10 and d_fused < 1e-7 and fused['graphs'] > 0
            and fused['syncs'] <= 1 and fused['counts']['tridiag_evolve'] > 0):
        raise AssertionError('phase 18 (a): the QR engines disagree, or the fused sweep '
                             'synced or skipped its graphs')
    del res_a, psi0
    torch.cuda.empty_cache()

    # (b) TDVP2 from the Neel state at L=16, chi_max 256, against exact evolution of the
    # Sz=0 sector
    t_sub = time.perf_counter()
    L = 16
    model = HeisenbergModel(L=L, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2))
    v0 = _full_vector(psi)
    bits = (np.arange(2 ** L)[:, None] >> np.arange(L)[None, :]) & 1
    sector = np.flatnonzero(bits.sum(1) == L // 2)
    H = _bond_sum_sparse(model.H_bonds, 2)[sector][:, sector]
    eng = TDVP2Engine(psi, model, dt=0.1, chi_max=256, eps=1e-12)
    run = steps('evolution b tdvp2', eng, 20)
    u = spla.expm_multiply(-1j * 2.0 * H, v0[sector])
    v = _full_vector(psi)
    err_b = (_overlap_error(u, v[sector]), abs(np.linalg.norm(v) - 1.),
             float(np.linalg.norm(np.delete(v, sector))))
    print(f'[evolution b] TDVP2 L={L} to t=2: overlap error {err_b[0]:.3e}, |d norm| '
          f'{err_b[1]:.3e}, weight outside Sz=0 {err_b[2]:.3e}; {len(sector)} sector states; '
          f'chi {psi.max_chi()}, trunc_err {eng.trunc_err:.3e}; s per step median '
          f'{np.median(run["s"]):.3f}; {time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (err_b[0] < 1e-8 and err_b[1] < 1e-8):
        raise AssertionError('phase 18 (b): TDVP2 is off exact evolution')
    del eng, psi, H

    # (c) TEBD from the all-up state of the TFI chain at g=1.0
    t_sub = time.perf_counter()
    L = 12
    model = TFIModel(L=L, g=1.0, conserve='parity')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    w0 = _full_vector(psi)
    tebd = TEBDEngine(psi, model, dt=0.05, chi_max=64, imaginary=False)
    tebd.run(20)
    H = _bond_sum_sparse(model.H_bonds, 2)
    u = spla.expm_multiply(-1j * 1.0 * H, w0)
    sz_mid = np.kron(np.kron(np.ones(2 ** (L // 2)), np.array([1., -1.])),
                     np.ones(2 ** (L - L // 2 - 1)))
    sz = _diag_op(model.site_legs[0], model.backend, [1., -1.])
    d_sz = abs(float(np.real(complex(psi.site_expectation_value(sz, L // 2))))
               - float(np.sum(sz_mid * np.abs(u) ** 2)))
    L = 64
    model = TFIModel(L=L, g=1.0, conserve='parity')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    tebd = TEBDEngine(psi, model, dt=0.05, chi_max=512, imaginary=False)
    e0 = tebd.energy() / L
    run = steps('evolution c tebd', tebd, 40)
    e1 = tebd.energy() / L
    lists['tebd'] = recorded_lists(lambda: tebd.update_bond(L // 2 - 1, tebd.U_full[L // 2 - 1]))
    print(f'[evolution c] TEBD L=12 to t=1: |<sz_mid> - exact| {d_sz:.3e}; L={L}, chi_max '
          f'512, 40 steps: e/site {e0!r} -> {e1!r} (|de| {abs(e1 - e0):.3e}), trunc_err '
          f'{tebd.trunc_err:.3e}, chi {psi.max_chi()}, s per step median '
          f'{np.median(run["s"]):.3f}, last {run["s"][-1]:.3f}; '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (d_sz < 5e-4 and abs(e1 - e0) < 1e-3):
        raise AssertionError('phase 18 (c): TEBD is off')
    del tebd, psi

    # (d) iTDVP on the infinite TFI chain, warm-started by iDMRG at chi_max 256
    t_sub = time.perf_counter()
    model = TFIModel(L=2, g=1.5, conserve='parity', bc='infinite')
    ipsi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                        bc='infinite')
    ieng = iDMRGEngine(ipsi, model, chi_max=256, eps=1e-14)
    ieng.run(n_steps=150, tol=1e-13)
    cell = ieng.psi.canonicalize_infinite(n_cells=20)
    e_exact = tfi_exact_infinite_gs_energy(1., 1.5)
    it = iTDVPEngine(cell.copy(), model, dt=0.05, imaginary=True)
    run_i = steps('evolution d itdvp imaginary', it, 10, it.step)
    e_im = it.energy_density()
    quench = TFIModel(L=2, g=2.5, conserve='parity', bc='infinite')
    e0 = quench.energy(cell)
    it = iTDVPEngine(cell.copy(), quench, dt=0.02)
    iters = []
    run_r = steps('evolution d itdvp real', it, 25, lambda: iters.append(it.step().env_iters))
    e1 = quench.energy(it.psi)
    lists['itdvp'] = recorded_lists(it.step)
    print(f'[evolution d] iTDVP: chi {cell.max_chi()}; imaginary time e/site {e_im!r}, '
          f'exact {e_exact!r}, |de| {abs(e_im - e_exact):.3e}, s per step median '
          f'{np.median(run_i["s"]):.3f}; quench to g=2.5, t=0.5: e/site {e0!r} -> {e1!r} '
          f'(|de| {abs(e1 - e0):.3e}), s per step median {np.median(run_r["s"]):.3f}, '
          f'environment iterations per step {json.dumps(iters)}; '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    if not (abs(e_im - e_exact) < 1e-12 and abs(e1 - e0) < 1e-6):
        raise AssertionError('phase 18 (d): iTDVP is off')

    # (e) VUMPS on the spin-1 Heisenberg chain at chi 128
    t_sub = time.perf_counter()
    model = SpinChainModel(L=2, S=1.0, conserve='Sz', bc='infinite')
    vu = VUMPSEngine.from_warm_start(model, initial_state=[0, 2], chi_max=128)
    t_warm = time.perf_counter() - t_sub
    grads, secs = [], []
    for _ in range(VUMPS_MAX_ITER):
        _evo_counts_zero()
        t0 = time.perf_counter()
        grads.append(vu.step())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        add(_evo_counts())
        if grads[-1] < 1e-6:  # the energy's error is second order in the gradient
            break
    e = vu.energy_density()
    print(f'[evolution e] VUMPS spin-1 chi 128: e/site {e!r}, White & Huse '
          f'{HALDANE_E_PER_SITE!r}, |de| {abs(e - HALDANE_E_PER_SITE):.3e}; gradient norm per '
          f'iteration {json.dumps([float(f"{x:.3e}") for x in grads])}; warm start '
          f'{t_warm:.1f} s, s per iteration median {np.median(secs):.3f}; '
          f'{time.perf_counter() - t_sub:.1f} s', flush=True)
    if not abs(e - HALDANE_E_PER_SITE) < 1e-7:
        raise AssertionError('phase 18 (e): the VUMPS energy is off')
    out = {k: _hold_lists(f'evolution {k}', v, c128) for k, v in lists.items()}
    return {'lists': out, 'launches': launches}


def evolution_kernels(evolution: dict, tev: dict) -> list:
    """The kernels-line entries of phase 18: the grouped GEMM at the largest list of a
    TDVP site step (c128; its launches over the phase) and tridiag_evolve (its numbers
    from tridiag_evolve_phase, its launches over the phase)."""
    keys = ('max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    launches = evolution['launches']
    return [{'name': 'grouped_gemm[evolution]', 'route': 'cuda',
             'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
             'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
             'launches': launches.get('grouped_gemm', 0),
             **{k: evolution['lists']['tdvp']['largest'][k] for k in keys}},
            {'name': 'tridiag_evolve', 'route': 'cuda',
             'source': 'cyten_tpu_torch/csrc/tridiag.cu',
             'replaces': 'jnp.linalg.eigh and the phase product in '
                         'cyten_tpu/tensors/krylov_based.py:458-460',
             'launches': launches.get('tridiag_evolve', 0), **{k: tev[k] for k in keys}}]


def steady_ab() -> None:
    """--steady-ab: the steady SVD as it is (Newton-Schulz, then the thin QR of
    tensors/steady.py::_orthonormal_columns) against the same SVD without the QR
    (Newton-Schulz's U as it comes), in turns in one process (without, with, with,
    without): each turn three sweep_static_batched() sweeps of a fresh engine on one
    converged L=24, chi 1024 state (eager, capturing, replayed) and the chi=CHI_BENCH
    f32 bench step as a graph (step_run). Prints each turn's seconds and energies and
    raises if a replayed sweep is off HEIS24_E_REF by 1e-8."""
    import torch
    from cyten_tpu_torch import Dtype
    from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS
    from cyten_tpu_torch.bench import step_run
    from cyten_tpu_torch.tensors import steady

    model = HeisenbergModel(L=24, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 12)
    opts = {'chi_max': 1024, 'eps': 0., 'lanczos_options': {'N_max': 10}}
    _sweep_to_convergence('steady a/b L=24', DMRGEngine(psi, model, **opts))
    with_qr = steady._orthonormal_columns
    for turn in ('without QR', 'with QR', 'with QR', 'without QR'):
        steady._orthonormal_columns = with_qr if turn == 'with QR' else (lambda U, S: U)
        try:
            eng = DMRGEngine(psi.copy(), model, **opts)
            eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
            sweep_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                E = eng.sweep_static_batched()
                torch.cuda.synchronize()
                sweep_s.append(time.perf_counter() - t0)
            del eng
            torch.cuda.empty_cache()
            t_step, _ = step_run(CHI_BENCH, svd_mode='steady', dtype=Dtype.float32,
                                 graph=True, lengths=(2, 6), repeats=3)
        finally:
            steady._orthonormal_columns = with_qr
        print(f'[steady a/b] {turn}: L=24 chi 1024 static sweeps (eager, capturing, '
              f'replayed) {json.dumps([round(t, 4) for t in sweep_s])} s, replayed E {E!r} '
              f'(|dE| {abs(E - HEIS24_E_REF):.3e}); chi={CHI_BENCH} f32 graph step '
              f'{t_step * 1e3:.3f} ms, E {step_run.energy!r}', flush=True)
        if not abs(E - HEIS24_E_REF) < 1e-8:
            raise AssertionError(f'steady a/b {turn}: the replayed sweep is off')


def models_kernels(models: dict, tridiag: dict) -> list:
    """The kernels-line entries of phase 15: the grouped GEMM at the spin-1 centre
    tdot(LP, theta) list (its launches over phase 15) and at the J1-J2 chain's W list
    (its launches in that run), and the tridiagonal kernel (its numbers from phase 2b,
    its launches over phase 15)."""
    keys = ('max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    source = {'route': 'cuda', 'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
              'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151'}
    return [{'name': 'grouped_gemm[models]', **source,
             'launches': models['launches']['grouped_gemm'],
             **{k: models['centre'][k] for k in keys}},
            {'name': 'grouped_gemm[J1-J2 W list]', **source, 'launches': models['launches_c'],
             **{k: models['w_list'][k] for k in keys}},
            {'name': 'tridiag[models]', 'route': 'cuda',
             'source': 'cyten_tpu_torch/csrc/tridiag.cu',
             'replaces': 'jnp.linalg.eigh in cyten_tpu/tensors/krylov_based.py:396',
             'launches': models['launches']['tridiag'], **{k: tridiag[k] for k in keys}}]


def main() -> int:
    import torch

    kernels_only = '--kernels-only' in sys.argv[1:]
    su2_only = '--su2-only' in sys.argv[1:]
    golden_only = '--golden-only' in sys.argv[1:]
    bench_only = '--bench-only' in sys.argv[1:]
    engine_only = '--engine-only' in sys.argv[1:]
    models_only = '--models-only' in sys.argv[1:]
    fermions_only = '--fermions-only' in sys.argv[1:]
    infinite_only = '--infinite-only' in sys.argv[1:]
    evolution_only = '--evolution-only' in sys.argv[1:]
    steady_only = '--steady-ab' in sys.argv[1:]
    against = sys.argv[sys.argv.index('--against') + 1] if '--against' in sys.argv else None

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from cyten_tpu_torch import Dtype, get_backend, u1_symmetry
    from cyten_tpu_torch.algorithms import (
        DMRGEngine, HEffective, HeisenbergModel, SimpleMPS,
        heisenberg_exact_finite_gs_energy,
    )
    from cyten_tpu_torch.algorithms.dmrg import _get_static_bond_fn
    from cyten_tpu_torch.bench import (
        build_step_state, build_workload, lists_on_plain, step_decomposition, step_run,
    )
    from cyten_tpu_torch.blocks import _kernels
    from cyten_tpu_torch.blocks.grouped_gemm import _LAYOUTS, grouped_matmul
    from cyten_tpu_torch.blocks.probe import scale2
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_ground_state
    from cyten_tpu_torch.tensors.krylov_based import fused_lanczos_impl
    from cyten_tpu_torch.tensors.steady import steady_truncated_svd

    t_start = time.perf_counter()
    # --- 1. card and build -------------------------------------------------------------
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    if against:
        ab_run(against)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (A/B)', flush=True)
        return 0
    t0 = time.perf_counter()
    seconds = _kernels.build(verbose=True)  # prints each kernel's -Xptxas -v report
    print(f'[build] {json.dumps(seconds)} (wall {time.perf_counter() - t0:.1f} s)',
          flush=True)
    check_sass(_kernels)
    if steady_only:
        steady_ab()
        print(f'[total] {time.perf_counter() - t_start:.1f} s (steady a/b)', flush=True)
        return 0
    # the sync counter's own count, on a function that does nothing (see count_syncs)
    idle = count_syncs(lambda: None)
    print(f'[syncs] a function that does nothing counts {idle} (at {count_syncs.where})',
          flush=True)

    # --- 2. kernel against plain ---------------------------------------------------------
    rng = np.random.default_rng(0)
    As = [torch.from_numpy(rng.normal(size=(M, K))).cuda() for M, K, N in PALLAS_SHAPES]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).cuda() for M, K, N in PALLAS_SHAPES]
    ids = np.arange(len(As))
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        compare_kernel('pallas-test shapes', As, Bs, ids, len(As), dtype)
    for case, (shapes, out_ids) in RAGGED.items():
        As = [torch.from_numpy(rng.normal(size=(M, K))).cuda() for M, K, N in shapes]
        Bs = [torch.from_numpy(rng.normal(size=(K, N))).cuda() for M, K, N in shapes]
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            compare_kernel(f'ragged {case}', As, Bs, np.array(out_ids), max(out_ids) + 1,
                           dtype, reps=5)
    backend = get_backend(u1_symmetry, device='cuda')
    LP, RP, W1, W2, theta = build_workload(backend, CHI_BENCH, dtype=Dtype.float64)
    As, Bs, pairs, out_id, n_out = lp_theta_pairs(LP, theta)
    permute_ms = cuda_ms(lambda: lp_theta_pairs(LP, theta))
    print(f'[permute] chi={CHI_BENCH} tdot(LP, theta) operand permute+copy f64: '
          f'{permute_ms:.3f} ms for {len(out_id)} pairs', flush=True)
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        compare_kernel(f'chi={CHI_BENCH} tdot(LP, theta)', As, Bs, out_id, n_out, dtype,
                       pairs)
    # --- 2c. the converting kinds: TF32, the bf16 pass, mixed bf16 x f32 -----------------
    rounded = {}  # (precision, A dtype, B dtype) -> the chi=4096 result
    for precision, a_dtype, b_dtype in rounded_cases():
        for case, (shapes, out_ids) in RAGGED.items():
            rA = [torch.from_numpy(rng.normal(size=(M, K))).cuda() for M, K, N in shapes]
            rB = [torch.from_numpy(rng.normal(size=(K, N))).cuda() for M, K, N in shapes]
            compare_kernel(f'ragged {case}', rA, rB, np.array(out_ids), max(out_ids) + 1,
                           a_dtype, reps=5, precision=precision, b_dtype=b_dtype)
        # the staged kinds (TF32, the bf16 pass, mixed): the lists their staging must get
        # right, at each tile
        for case, (hA, hB, ids) in staged_hard_lists(rng, a_dtype, b_dtype,
                                                     precision).items():
            # the mixed kind has one tile
            for width in STAGED_WIDTHS if precision is not None else (None,):
                compare_kernel(f'staged {case} {width or "tiled"}', hA, hB, np.array(ids),
                               max(ids) + 1, a_dtype, reps=5, precision=precision,
                               b_dtype=b_dtype, as_given=True, width=width)
        if b_dtype == torch.float32:  # LP as the bf16 operand: the env_dtype matvec
            res = rounded[precision, a_dtype] = compare_kernel(
                f'chi={CHI_BENCH} tdot(LP, theta)', As, Bs, out_id, n_out, a_dtype, pairs,
                precision=precision, b_dtype=b_dtype)
            before = STAGED_BEFORE_MS.get((precision, str(a_dtype).split('.')[-1]))
            if before is not None:
                print(f'[kernel] chi={CHI_BENCH} tdot(LP, theta) {precision or "float32"} '
                      f'{str(a_dtype).split(".")[-1]} x float32: device_ms '
                      f'{res["device_ms"]:.4f} against {before} in the register-staged form, '
                      f'bound {res["bound_ms"]:.4f}'
                      + (f' (the FMA pipes\' {res["gflop"] / 67:.4f})' if precision is None
                         else '') + f', library_ms {res["library_ms"]:.4f}', flush=True)
    del LP, RP, W1, W2, theta
    torch.cuda.empty_cache()
    # the bench step's own lists, the thin ones held to plain
    thin = step_list_phase()
    if kernels_only:  # a measurement: with --kernels-only alone
        thin_crossover()
    # --- 2d. the complex128 kind ------------------------------------------------------------
    complex_phase(As, Bs, out_id, n_out, pairs, rng)
    del As, Bs
    torch.cuda.empty_cache()
    # --- 2b. the tridiagonal kernels against their plain versions -------------------------
    tridiag = tridiag_phase()
    tev = tridiag_evolve_phase()
    if kernels_only:
        probe = probe_phase()
        print(f'[total] {time.perf_counter() - t_start:.1f} s (kernels only)', flush=True)
        return 0
    if su2_only:
        su2_phase(None)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (SU(2) only)', flush=True)
        return 0
    if golden_only:
        golden_phase()
        print(f'[total] {time.perf_counter() - t_start:.1f} s (golden chain only)',
              flush=True)
        return 0
    if fermions_only:
        t_phase = time.perf_counter()
        fermions = fermions_phase(deep=True)
        print(f'[phases] wall seconds {{"16": {time.perf_counter() - t_phase:.1f}}}',
              flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (fermions only)', flush=True)
        print(json.dumps({'kernels': fermions_kernels(fermions, tridiag)}))
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return 0
    if infinite_only:
        t_phase = time.perf_counter()
        infinite = infinite_phase(deep=True)
        print(f'[phases] wall seconds {{"17": {time.perf_counter() - t_phase:.1f}}}',
              flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (infinite only)', flush=True)
        print(json.dumps({'kernels': infinite_kernels(infinite)}))
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return 0
    if evolution_only:
        t_phase = time.perf_counter()
        evolution = evolution_phase(deep=True)
        print(f'[phases] wall seconds {{"18": {time.perf_counter() - t_phase:.1f}}}',
              flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (evolution only)', flush=True)
        print(json.dumps({'kernels': evolution_kernels(evolution, tev)}))
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return 0
    if models_only:
        t_phase = time.perf_counter()
        models = models_phase(deep=True)
        print(f'[phases] wall seconds {{"15": {time.perf_counter() - t_phase:.1f}}}',
              flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (models only)', flush=True)
        print(json.dumps({'kernels': models_kernels(models, tridiag)}))
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return 0

    # --- 3. main path, small: L=12 against exact diagonalization -------------------------
    if not engine_only:
        grouped_matmul.launches = 0
        model = HeisenbergModel(L=12, conserve='Sz')
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 6)
        E12 = DMRGEngine(psi, model, chi_max=64, eps=1e-14).run(n_sweeps=10)
        E12_exact = heisenberg_exact_finite_gs_energy(12, 1.)
        print(f'[L=12] E = {E12!r}, exact {E12_exact!r}, |dE| = '
              f'{abs(E12 - E12_exact):.3e}, launches {grouped_matmul.launches}', flush=True)
        if not abs(E12 - E12_exact) < 1e-9 or grouped_matmul.launches == 0:
            raise AssertionError('L=12 DMRG energy or kernel launches wrong')

    # --- 4. main path at full width: L=24, chi_max=1024 ----------------------------------
    # From the product state two-site DMRG at most doubles chi per half sweep, so the
    # centre bond reaches chi_max=1024 in the fifth sweep (eps=0 keeps every value).
    L, chi_max = 24, 1024
    model = HeisenbergModel(L=L, conserve='Sz')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2))
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=0., lanczos_options={'N_max': 10})
    layouts = len(_LAYOUTS)
    grouped_matmul.launches = 0
    grouped_matmul.thin.launches = 0
    E24 = None
    n_sweeps = 0
    for sweep in range(6):
        t0 = time.perf_counter()
        E_new = eng.run(n_sweeps=1)
        torch.cuda.synchronize()
        n_sweeps += 1
        print(f'[L=24] sweep {sweep + 1}: E = {E_new!r}, {time.perf_counter() - t0:.2f} s, '
              f'max chi {psi.max_chi()}', flush=True)
        converged = E24 is not None and abs(E_new - E24) < 1e-10
        E24 = E_new
        if converged and psi.max_chi() == chi_max:
            break
    launches = grouped_matmul.launches
    thin_launches = grouped_matmul.thin.launches
    bonds = n_sweeps * 2 * (L - 1)
    print(f'[L=24] E = {E24!r}, ref {HEIS24_E_REF!r}, |dE| = {abs(E24 - HEIS24_E_REF):.3e}, '
          f'launches {launches} ({launches / bonds:.1f} per bond over {bonds} bonds; thin '
          f'form {thin_launches}), pair lists laid out anew {len(_LAYOUTS) - layouts}',
          flush=True)
    if not (abs(E24 - HEIS24_E_REF) < 1e-8 and launches > 0 and thin_launches > 0
            and psi.max_chi() == chi_max):
        raise AssertionError('L=24 DMRG energy, width or kernel launches wrong')
    # phase 14 starts from the state at the end of the last sweep: the centre-bond
    # updates below leave B[i] = S_i^-1 A S off its B form where S_i holds values near
    # 1e-15 (eps=0), and static sweeps from such a state drift (PERF.md §6)
    psi4 = psi.copy()

    # the centre bond of the converged state: where the time of a bond goes, and the
    # kernel at the shapes the main path gives it
    i = L // 2 - 1
    H = HEffective(eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
    theta0 = psi.get_theta2(i)
    matvec_ms = cuda_ms(lambda: H.matvec(theta0), reps=3)
    from cyten_tpu_torch.algorithms.mps import split_truncate_theta
    from cyten_tpu_torch.tensors import lanczos, permute_legs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, theta, n_iter = lanczos(H, theta0, eng.lanczos_options)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    split_truncate_theta(theta, eng.chi_max, eng.eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    split_ms = (t2 - t1) * 1e3
    print(f'[L=24 centre bond] matvec {matvec_ms:.3f} ms; lanczos {n_iter} its '
          f'{(t1 - t0) * 1e3:.1f} ms; split_truncate_theta (SVD) {(t2 - t1) * 1e3:.1f} ms',
          flush=True)
    As, Bs, pairs, out_id, n_out = lp_theta_pairs(H.LP, theta0)
    main = compare_kernel(f'L=24 chi={psi.max_chi()} centre tdot(LP, theta)', As, Bs,
                          out_id, n_out, torch.float64, pairs, rounds=8)
    for precision, a_dtype, b_dtype in rounded_cases():
        res = compare_kernel(f'L=24 chi={psi.max_chi()} centre tdot(LP, theta)', As, Bs,
                             out_id, n_out, a_dtype, pairs, precision=precision,
                             b_dtype=b_dtype, rounds=8)
        before = CENTRE_BEFORE_MS.get((precision, str(a_dtype).split('.')[-1]))
        if before is not None and b_dtype == torch.float32:
            print(f'[kernel] L=24 centre tdot(LP, theta) {precision or "float32"} '
                  f'{str(a_dtype).split(".")[-1]} x float32: device_ms '
                  f'{res["device_ms"]:.4f} (spread {res["spread"]["device_ms"]:.3f}) against '
                  f'{before} in the register-staged form', flush=True)
    breakdown = wrapper_breakdown(As, Bs, out_id, n_out, pairs)
    print(f'[breakdown] wrapper host ms per call, {len(out_id)} pairs of {len(As)} + '
          f'{len(Bs)} operands, {n_out} outputs of {len({B.shape[1] for B in Bs})} widths: '
          f'{json.dumps(breakdown)} (sum {sum(breakdown.values()):.4f})', flush=True)
    profile_run(f'bond {i}', lambda: eng.update_bond(i))
    print(f'[L=24 centre bond] host syncs of one dynamic update: '
          f'{count_syncs(lambda: eng.update_bond(i))}', flush=True)
    if engine_only:
        t_phase = time.perf_counter()
        # with the state after the centre-bond updates, which phase 14 measures here
        engine_phase(model, psi4, E24, psi.copy())
        print(f'[phases] wall seconds {{"14": {time.perf_counter() - t_phase:.1f}}}',
              flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (engine only)', flush=True)
        return 0

    # --- 5. bench-shaped matvec at chi=4096, f32: card against CPU -----------------------
    args = build_workload(backend, CHI_BENCH, dtype=Dtype.float32)
    Hg = HEffective(*args[:4])
    grouped_matmul.launches = 0
    y = Hg.matvec(args[4])
    torch.cuda.synchronize()
    mv_launches = grouped_matmul.launches
    mv_ms = cuda_ms(lambda: Hg.matvec(args[4]), reps=3)
    cpu = get_backend(u1_symmetry, device='cpu')
    moved = []
    for t in args:
        t = t.copy(deep=False)
        t.backend = cpu
        t.data = type(t.data)([b.cpu() for b in t.data.blocks], t.data.block_inds,
                              t.data.dtype, is_sorted=True)
        moved.append(t)
    y_cpu = HEffective(*moved[:4]).matvec(moved[4])
    diff = np.linalg.norm(y.to_numpy() - y_cpu.to_numpy()) / np.linalg.norm(y_cpu.to_numpy())
    print(f'[matvec chi={CHI_BENCH} f32] {mv_ms:.3f} ms on the card, {mv_launches} '
          f'grouped-GEMM launches, relative difference to the CPU {diff:.3e}', flush=True)
    if not diff < 1e-5 or mv_launches == 0:
        raise AssertionError('chi=4096 matvec disagrees with the CPU or skipped the kernel')

    phase_s = {'1-5': time.perf_counter() - t_start}

    # --- 6. the probe kernel against its plain version -----------------------------------
    t_phase = time.perf_counter()
    probe = probe_phase()
    phase_s['6'] = time.perf_counter() - t_phase

    # --- 7. static mode on the converged L=24 engine -------------------------------------
    t_phase = time.perf_counter()
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    grouped_matmul.launches = 0
    scale2.launches = 0
    # one eager sweep: it gives every bond its static structure, which the graphs
    # below capture
    t0 = time.perf_counter()
    E_static = eng.sweep()
    torch.cuda.synchronize()
    eager_s = [time.perf_counter() - t0]
    print(f'[L=24 static] eager sweep 1: E = {E_static!r}, {eager_s[-1]:.2f} s', flush=True)
    static_launches = grouped_matmul.launches
    print(f'[L=24 static] |dE| = {abs(E_static - HEIS24_E_REF):.3e}, grouped-GEMM '
          f'launches {static_launches} ({static_launches / (2 * (L - 1)):.1f} per bond)',
          flush=True)
    if not abs(E_static - HEIS24_E_REF) < 1e-8 or static_launches == 0:
        raise AssertionError('L=24 static-mode energy or kernel launches wrong')
    assert_right_isometric(psi, 1e-8)
    # the centre bond in static mode, by stage
    H = HEffective(eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
    theta_tmpl, _ = eng._static_consts(i)
    th = psi.get_theta2(i) + theta_tmpl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, theta = fused_lanczos_impl(H, th, 10)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    thp = permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    Vh_prev = permute_legs(psi.Bs[i + 1].relabelled({'p': 'p1'}), codomain=['vL'],
                           domain=['vR', 'p1'])
    steady_truncated_svd(thp, Vh_prev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng.update_bond(i)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f'[L=24 static centre bond] fused lanczos (10 its) {(t1 - t0) * 1e3:.1f} ms; '
          f'steady SVD {(t2 - t1) * 1e3:.1f} ms (phase 4 exact split: '
          f'{split_ms:.1f} ms); whole static update {(t3 - t2) * 1e3:.1f} ms; '
          f'host syncs of one static update: {count_syncs(lambda: eng.update_bond(i))}',
          flush=True)
    profile_run(f'bond {i}', lambda: eng.update_bond(i))
    # the tridiagonal kernel on this bond's own Lanczos matrix: once the state has
    # converged beta_0 is tiny, and ghosts of the lowest eigenvalue can appear
    import cyten_tpu_torch.tensors.krylov_based as krylov

    lanczos_ab = []
    krylov.tridiagonal_ground_state = lambda ab: (lanczos_ab.append(ab.clone()),
                                                  tridiagonal_ground_state(ab))[1]
    try:
        fused_lanczos_impl(H, th, 10)
    finally:
        krylov.tridiagonal_ground_state = tridiagonal_ground_state
    print(f'[L=24 static centre bond] Lanczos matrix: alphas '
          f'{json.dumps(lanczos_ab[0][0].tolist())}, betas '
          f'{json.dumps(lanczos_ab[0][1].tolist())}', flush=True)
    check_tridiag('L=24 static centre bond', lanczos_ab[0])

    # the same engine, its sweeps batched and each bond update a CUDA graph
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    torch.cuda.reset_peak_memory_stats()
    print(f'[L=24 graphs] runs of _static_runs: {eng._static_runs()}', flush=True)
    graph_s = []
    for sweep in range(2):
        grouped_matmul.launches = 0
        grouped_matmul.thin.launches = 0
        tridiagonal_ground_state.launches = 0
        t0 = time.perf_counter()
        E_graph = eng.sweep_static_batched()
        torch.cuda.synchronize()
        graph_s.append(time.perf_counter() - t0)
        launches_graph = grouped_matmul.launches
        tridiag_launches = tridiagonal_ground_state.launches
        print(f'[L=24 graphs] batched sweep {sweep + 1}: E = {E_graph!r}, '
              f'{graph_s[-1]:.2f} s, |dE| = {abs(E_graph - HEIS24_E_REF):.3e}, '
              f'grouped-GEMM launches {launches_graph} (thin form '
              f'{grouped_matmul.thin.launches}), tridiag launches {tridiag_launches}',
              flush=True)
    graphs = eng.static_graphs()
    syncs = count_syncs(eng.sweep_static_batched)
    peak_gb = torch.cuda.max_memory_reserved() / 1e9
    print(f'[L=24 graphs] {len(graphs)} graphs captured in '
          f'{sum(g.capture_seconds for g in graphs):.2f} s; launches per replayed sweep: '
          f'grouped GEMM {launches_graph}, tridiag {tridiag_launches}; host syncs of a '
          f'batched sweep {syncs} (at {count_syncs.where}); peak reserved {peak_gb:.2f} GB; '
          f'sweep s eager {json.dumps(eager_s)}, graphs {json.dumps(graph_s)}', flush=True)
    if not (abs(E_graph - HEIS24_E_REF) < 1e-8 and launches_graph > 0
            and tridiag_launches > 0 and syncs <= 2 and graphs):
        raise AssertionError('L=24 batched static sweeps: energy, launches or syncs wrong')
    assert_right_isometric(psi, 1e-8)
    profile_run(f'bond {i} graph', lambda: eng.update_bond(i))
    sweep_kernels = profile_run('batched sweep', eng.sweep_static_batched, top=4)
    print(f'[L=24 graphs] kernels of one replayed sweep (torch.profiler): {sweep_kernels}',
          flush=True)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
    E_eager = eng.sweep()
    print(f'[L=24 graphs] eager sweep after: E = {E_eager!r}, |E - E_graphs| = '
          f'{abs(E_eager - E_graph):.3e}', flush=True)
    if not abs(E_eager - E_graph) < 1e-10:
        raise AssertionError('the eager static sweep disagrees with the graphs')
    phase_s['7'] = time.perf_counter() - t_phase

    # --- 7b. static mode with bf16 environments, through graphs ----------------------------
    t_phase = time.perf_counter()
    kinds = grouped_matmul.kinds
    model.H_mpo = [W.to_dtype(Dtype.float32) for W in model.H_mpo]
    psi.Bs = [B.to_dtype(Dtype.float32) for B in psi.Bs]
    psi.Ss = [S.to_dtype(Dtype.float32) for S in psi.Ss]
    eng.env_dtype = Dtype.bfloat16
    eng.LPs = [eng.LPs[0].to_dtype(Dtype.float32),
               *(t.to_dtype(Dtype.bfloat16) for t in eng.LPs[1:])]
    eng.RPs = [*(t.to_dtype(Dtype.bfloat16) for t in eng.RPs[:-1]),
               eng.RPs[-1].to_dtype(Dtype.float32)]
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    captured = []  # graphs held after each setting's sweeps
    for setting, n_sweeps in (('env bf16, float32', 3), ('env bf16, default', 2),
                              ('env f32, float32', 2)):
        if setting == 'env bf16, default':
            eng.matmul_precision = 'default'
            before_default = (list(psi.Bs), list(psi.Ss), list(eng.LPs), list(eng.RPs))
        elif setting == 'env f32, float32':
            eng.env_dtype, eng.matmul_precision = None, 'float32'
            eng.LPs = [t.to_dtype(Dtype.float32) for t in eng.LPs]
            eng.RPs = [t.to_dtype(Dtype.float32) for t in eng.RPs]
        for k in (*kinds.values(), grouped_matmul.thin):
            k.launches = 0
        sweep_s = []
        for sweep in range(n_sweeps):
            t0 = time.perf_counter()
            E_env = eng.sweep_static_batched()
            torch.cuda.synchronize()
            sweep_s.append(time.perf_counter() - t0)
            if sweep == 0:
                E_first = E_env
        captured.append(len(eng.static_graphs()))
        env_dtypes = sorted({t.dtype.name for t in eng.LPs[1:-1] + eng.RPs[1:-1]})
        counts = {k: v.launches for k, v in kinds.items() if v.launches}
        counts['thin'] = grouped_matmul.thin.launches
        parent = PARENT_7B_DE.get(setting)
        print(f'[L=24 static env] {setting}: E = {E_env!r}, |dE| = '
              f'{abs(E_env - HEIS24_E_REF):.3e}'
              f'{f" (the parent kernel: {parent:.3e})" if parent else ""}, '
              f'sweep s {json.dumps(sweep_s)}, graphs '
              f'{captured[-1]}, interior LP/RP {env_dtypes}, grouped-GEMM launches by '
              f'kind {json.dumps(counts)}', flush=True)
        # bf16 environments perturb the Lanczos energy to first order (0.02 relative,
        # tests/test_bf16.py:142); with f32 ones it is held to the polish bound
        want = 'float32' if setting == 'env f32, float32' else 'bfloat16'
        bound = 1e-3 if want == 'float32' else 0.02 * abs(HEIS24_E_REF)
        if env_dtypes != [want] or not abs(E_env - HEIS24_E_REF) < bound:
            raise AssertionError(f'static mode {setting}: environments or energy wrong')
        if setting == 'env bf16, default':
            E_default = E_first  # the eager sweeps below are held to its first sweep
    if not captured[0] < captured[1] < captured[2]:
        raise AssertionError(f'static graphs were not captured anew: {captured}')
    # the first 'env bf16, default' sweep again from the state it started from, eager,
    # on the kernel, with the mixed kind's lists on their plain version, and with
    # every list on its plain version at 'default' (the same products, the sums in
    # another order): how far the order of the sums alone moves this setting's
    # energy, and how much of that the mixed kind's sums make
    plain_resweeps = (('mixed-kind plain', lambda: lists_on_plain({'float32_mixed'})),
                      ('plain', lists_on_plain))  # under --bench-only
    for lists, routing in (('kernel', contextlib.nullcontext),
                           *(plain_resweeps if bench_only else ())):
        psi.Bs, psi.Ss, eng.LPs, eng.RPs = (list(x) for x in before_default)
        eng.env_dtype, eng.matmul_precision = Dtype.bfloat16, 'default'
        eng.enable_static_mode(n_lanczos=10, svd_mode='steady', cuda_graphs=False)
        with routing():
            E_eager = eng.sweep()
        print(f'[L=24 static env] env bf16, default, eager, {lists} lists: E = '
              f'{E_eager!r}, |dE| = {abs(E_eager - HEIS24_E_REF):.3e}, |E - E_graphs| = '
              f'{abs(E_eager - E_default):.3e}', flush=True)
        if not abs(E_eager - HEIS24_E_REF) < 0.02 * abs(HEIS24_E_REF):
            raise AssertionError(f'static mode env bf16, default, eager on {lists} lists: '
                                 'energy wrong')
    del eng, psi, model, H
    torch.cuda.empty_cache()
    phase_s['7b'] = time.perf_counter() - t_phase
    if bench_only:
        accuracy_phase()
        bench_phase()
        print(f'[phases] wall seconds {json.dumps(phase_s)}', flush=True)
        print(f'[total] {time.perf_counter() - t_start:.1f} s (bench only)', flush=True)
        return 0

    # --- 8. the bench step -----------------------------------------------------------------
    t_phase = time.perf_counter()
    lengths, repeats = (1, 3), 1
    graph_steps = {}  # setting -> (s, FLOPs) of its graph step, for phase 13
    for svd_mode, dtype, graph in (('steady', Dtype.float32, False),
                                   ('steady', Dtype.float32, True),
                                   ('steady', Dtype.float64, False),
                                   ('steady', Dtype.float64, True),
                                   ('exact', Dtype.float32, False)):
        t_step, flops = step_run(CHI_BENCH, svd_mode=svd_mode, dtype=dtype, graph=graph,
                                 lengths=(2, 6) if graph else lengths, repeats=repeats)
        if (svd_mode, dtype, graph) == ('steady', Dtype.float32, False):
            E_step32 = step_run.energy
        if (svd_mode, dtype, graph) == ('steady', Dtype.float32, True):
            step32_graph_ms = t_step * 1e3
        if svd_mode == 'steady' and graph:
            graph_steps[dtype.name] = t_step, flops
        print(f'[step chi={CHI_BENCH} {svd_mode} {dtype.name}'
              f'{" graph" if graph else ""}] {t_step * 1e3:.3f} ms/step, '
              f'{flops / t_step / 1e12:.3f} TFLOP/s ({flops / 1e9:.2f} GFLOP/step), '
              f'{step_run.launches_per_step} grouped-GEMM launches/step', flush=True)
    # one static step at chi=1024, f64: the same host-drawn state on card and CPU
    out = {}
    for device in ('cuda', 'cpu'):
        LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
            get_backend(u1_symmetry, device=device), 1024)
        out[device] = _get_static_bond_fn(10, 'steady')(HEffective(LP, RP, W1, W2), S,
                                                         B1, B2, tmpl, None)
    (E_card, _, S_card, *_), (E_cpu, _, S_cpu, *_) = out['cuda'], out['cpu']
    E_card, E_cpu = float(E_card), float(E_cpu)
    dE = abs(E_card - E_cpu) / abs(E_cpu)
    dS = float(np.abs(S_card.to_numpy() - S_cpu.to_numpy()).max())
    print(f'[step chi=1024 f64] card against CPU: E {E_card!r} vs {E_cpu!r} '
          f'(relative {dE:.3e}), max |dS| {dS:.3e}', flush=True)
    if not (dE < 1e-9 and dS < 1e-8):
        raise AssertionError('the chi=1024 static step disagrees between card and CPU')
    del out
    torch.cuda.empty_cache()
    grouped_matmul.launches = 0
    scale2.launches = 0
    decomposition = step_decomposition(CHI_BENCH, lengths=lengths, repeats=repeats)
    bench_launches = {'grouped_gemm': grouped_matmul.launches, 'probe': scale2.launches}
    print(f'[step_decomposition] {json.dumps(decomposition)}; launches {bench_launches}',
          flush=True)
    if not decomposition['probe_works'] or 0 in bench_launches.values():
        raise AssertionError('step_decomposition: probe failed or a kernel was not run')
    phase_s['8'] = time.perf_counter() - t_phase

    # --- 9. the bench step in the precision settings ----------------------------------------
    t_phase = time.perf_counter()
    LP, RP, *_ = build_step_state(backend, CHI_BENCH, dtype=Dtype.float32)
    env_mb = {name: sum(b.numel() for t in (LP, RP) for b in t.data.blocks) * size / 1e6
              for name, size in (('float32', 4), ('bfloat16', 2))}
    del LP, RP
    print(f'[step chi={CHI_BENCH} env bytes] LP + RP read per matvec, MB: '
          f'{json.dumps(env_mb)}', flush=True)
    kind_launches = {}  # the kind each setting must run -> its launches there
    for name, kw, kind in (('tensorfloat32', {'precision': 'tensorfloat32'}, 'tensorfloat32'),
                           ('default', {'precision': 'default'}, 'default'),
                           ('env bf16', {'env_dtype': 'bfloat16'}, 'float32_mixed'),
                           ('work bf16', {'work_dtype': 'bfloat16'}, 'bfloat16')):
        for graph in (False, True):
            for k in (*kinds.values(), grouped_matmul.thin):
                k.launches = 0
            t_step, flops = step_run(CHI_BENCH, svd_mode='steady', graph=graph,
                                     lengths=(2, 6) if graph else lengths,
                                     repeats=repeats, **kw)
            counts = {k: v.launches for k, v in kinds.items() if v.launches}
            kind_launches[kind] = kind_launches.get(kind, 0) + counts.get(kind, 0)
            if graph:
                graph_steps[name] = t_step, flops
            counts['thin'] = grouped_matmul.thin.launches
            dE = abs(step_run.energy - E_step32) / abs(E_step32)
            out_dtypes = [d.name for d in step_run.out_dtypes]
            print(f'[step chi={CHI_BENCH} steady float32 {name}'
                  f'{" graph" if graph else ""}] {t_step * 1e3:.3f} ms/step'
                  f'{f" (the f32 step as a graph: {step32_graph_ms:.3f})" if graph else ""}, '
                  f'{flops / t_step / 1e12:.3f} TFLOP/s, E {step_run.energy!r} against '
                  f'the float32 step {E_step32!r} (relative {dE:.3e}), outputs '
                  f'{out_dtypes}, launches by kind {json.dumps(counts)}', flush=True)
            if not (counts.get(kind) and counts['thin'] and np.isfinite(step_run.energy)
                    and dE < 0.05):
                raise AssertionError(f'step {name}: kind {kind} or the thin form not run, '
                                     'or E off')
            if 'work_dtype' in kw and set(out_dtypes) != {'bfloat16'}:
                raise AssertionError(f'the bf16-work step promoted: {out_dtypes}')
    phase_s['9'] = time.perf_counter() - t_phase

    # --- 11. SU(2) Heisenberg on the fusion-tree backend -------------------------------------
    t_phase = time.perf_counter()
    su2 = su2_phase(E24, deep=False)
    phase_s['11'] = time.perf_counter() - t_phase

    # --- 12. the Fibonacci golden chain on the fusion-tree backend ---------------------------
    t_phase = time.perf_counter()
    golden = golden_phase(deep=False)
    phase_s['12'] = time.perf_counter() - t_phase

    # --- 13. the rest of the port's bench ---------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    bench = bench_phase(graph_steps, deep=False)
    phase_s['13'] = time.perf_counter() - t_phase

    # --- 14. the rest of DMRGEngine on phase 4's state -------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    engine_phase(HeisenbergModel(L=psi4.L, conserve='Sz'), psi4, E24, deep=False)
    phase_s['14'] = time.perf_counter() - t_phase

    # --- 15. the models layer: CouplingModel, SpinChainModel, mpo_from_terms -------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    models = models_phase(deep=False)
    phase_s['15'] = time.perf_counter() - t_phase

    # --- 16. fermions and the Ising-anyon chain ----------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fermions = fermions_phase(deep=False)
    phase_s['16'] = time.perf_counter() - t_phase

    # --- 17. one-site DMRG and the infinite chain ----------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    infinite = infinite_phase(deep=False)
    phase_s['17'] = time.perf_counter() - t_phase

    # --- 18. time evolution ------------------------------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    evolution = evolution_phase(deep=False)
    phase_s['18'] = time.perf_counter() - t_phase
    print(f'[phases] wall seconds {json.dumps(phase_s)}', flush=True)

    print(f'[total] {time.perf_counter() - t_start:.1f} s', flush=True)
    kernels = [{'name': 'grouped_gemm', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                'launches': launches, 'max_abs_err': main['max_abs_err'],
                'ms': main['ms'], 'device_ms': main['device_ms'], 'plain_ms': main['plain_ms'],
                'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
                'library_ms': main['library_ms']},
               *({'name': f'grouped_gemm[{kind}]', 'route': 'cuda',
                  'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                  'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                  'launches': kind_launches[kind],
                  **{k: rounded[key][k] for k in ('max_abs_err', 'ms', 'device_ms',
                                                  'plain_ms', 'bound_ms', 'bound_by',
                                                  'library_ms')}}
                 for kind, key in (('tensorfloat32', ('tensorfloat32', torch.float32)),
                                   ('default', ('default', torch.float32)),
                                   ('float32_mixed', (None, torch.bfloat16)))),
               {'name': 'grouped_gemm[thin]', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                'launches': thin_launches,
                **{k: thin['float32 tall'][k] for k in ('max_abs_err', 'ms', 'device_ms',
                                                         'plain_ms', 'bound_ms', 'bound_by',
                                                         'library_ms')}},
               {'name': 'grouped_gemm[su2_compose]', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                **{k: su2[k] for k in ('launches', 'max_abs_err', 'ms', 'device_ms',
                                       'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}},
               {'name': 'grouped_gemm[complex128]', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                **{k: golden[k] for k in ('launches', 'max_abs_err', 'ms', 'device_ms',
                                          'plain_ms', 'bound_ms', 'bound_by',
                                          'library_ms')}},
               *({'name': f'grouped_gemm[{name}]', 'route': 'cuda',
                  'source': 'cyten_tpu_torch/csrc/grouped_gemm.cu',
                  'replaces': 'cyten_tpu/blocks/pallas_grouped.py:151',
                  **{k: bench[key][k] for k in ('launches', 'max_abs_err', 'ms', 'device_ms',
                                                'plain_ms', 'bound_ms', 'bound_by',
                                                'library_ms')}}
                 for name, key in (('hubbard', 'hubbard'), ('padded bf16', 'padded'))),
               {'name': 'probe', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/probe.cu',
                'replaces': 'scripts/exp_r5_step_decomp.py:59',
                'launches': bench_launches['probe'],
                **{k: v for k, v in probe.items() if k != 'spread'}},
               {'name': 'tridiag', 'route': 'cuda',
                'source': 'cyten_tpu_torch/csrc/tridiag.cu',
                'replaces': 'jnp.linalg.eigh in cyten_tpu/tensors/krylov_based.py:396',
                'launches': tridiag_launches,
                **{k: tridiag[k] for k in ('max_abs_err', 'ms', 'device_ms', 'plain_ms',
                                           'bound_ms', 'bound_by', 'library_ms')}},
               *models_kernels(models, tridiag),
               *fermions_kernels(fermions, tridiag),
               *infinite_kernels(infinite),
               *evolution_kernels(evolution, tev)]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
