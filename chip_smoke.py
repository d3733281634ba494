#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py [--parent DIR] [--mg-tiles]

DIR is an unpacked `git archive` of the commit whose multigrid descent and
ascent kernels phase 4c holds k_down and k_up to by bits; --mg-tiles runs
phase 4c alone, with the kernels' timing (phases 1 and 2 for
mg_vcycle.cu only).

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA sources of pyro2_tpu_torch/csrc (ctu_step.cu,
     mg_vcycle.cu, mol_substep.cu, swe_step.cu, lm_interface.cu,
     mg_deep.cu) with nvcc, one process each, started together, and print
     what ptxas reports (registers, shared memory, stack and spills; the
     main path's CTU kernel, k_ctu<float, nvar 4, cartesian>, the swe
     kernel k_swe<float, 4>, the descent k_down, the rk stage k_rk<float,
     4>, the deep smoother k_deep<const, rbgs, v_fc, float> and the lm_atm
     stages k_lm_mac, k_lm_rho and k_lm_states<float> once more; the
     stage prefixes of the CTU kernel, k_ctu<float|double, nvar 4,
     cartesian, stages 1..3>, are among its lines);
  3. the CTU kernel (one fused launch a step) against its plain PyTorch
     version on the card, one step from the same state after 3 kernel
     steps, for seven configurations (CGF limiter 2 on sod, HLLC limiters
     2, 1 and 0 -- the last without flattening -- on quad, HLLC_lm on
     periodic kh, rt with gravity, and solid walls with a floor, a sponge
     and a passive scalar) at 200x136 and 1024x1000, whose last tiles are
     ragged, and at 1024^2, in float64 (max |diff| <= 1e-12 max|U|) and
     float32 (<= 1e-5 max|U|), every ghost of the output equal to the
     input's;
  3c. the CTU kernel on spherical grids (advect on r in [0.5, 1] and the
     Sedov blast on r in [0.05, 1], theta in [pi/4, 3 pi/4], CGF, outflow)
     the same way, at the same three shapes, and the padded entries of
     solvers/compressible/padded_step.py against their plain steps on
     periodic frames, one step from the same filled frame after 3 kernel
     steps: ctu_periodic on advect and ctu_padin on kh at the same three
     shapes, ctu_ensemble on 3 x 200x136 and 8 x 256^2 acoustic_pulse
     members, each member also equal to its one-member kernel step bit for
     bit; and the stage prefixes of ctu_periodic (make_ctu_step_padded's
     stages 1..3, ctu_periodic_s1 .. _s3) on advect at the three shapes
     against padded_step.plain_stages from the same filled frame after 3
     kernel steps, float64 max |diff| <= 1e-12 max|out| per variable,
     float32 <= 1e-5 max|out|, every ghost of the output the input's;
  3a. the swe kernel (one fused launch a step) against its plain step the
     same way, for five configurations (quad Roe limiter 2 outflow, kh
     HLLC periodic, dam Roe limiter 1 with reflecting y walls, advect
     limiter 0 with grav 0.001, quad HLLC with a passive scalar) at
     200x136, 1024x1000 (a ragged last tile column) and 1024^2;
  3b. the MOL stage-increment kernels (mol_rk, mol_fv4) against their plain
     versions on the card, one increment from the same state after 3
     kernel steps, for four rk and three fv4 configurations at a ragged
     200x136 (fv4 rt: 200x600, square cells), at 1024x1000 (a ragged last
     tile column) and at 1024^2, in float64 (max |diff|
     <= 1e-12 of max|F_x|/dx + max|F_y|/dy + max|S|, the terms k cancels)
     and float32 (<= 1e-5 of it), the ghosts of k exactly zero;
  4. the multigrid kernels against their plain versions from the same
     inputs, each entry, one whole V-cycle and one whole solve, at 64^2
     (core only) and 1024^2 (core up to 128^2 in float32 and 64^2 in
     float64, the finer levels peeled), in float64 (<= 1e-12 max|v|) and
     float32 (<= 1e-5 max|v|; a residual to the same factors of the terms
     it cancels), with equal float64 cycle counts: the constant operator
     (mg_core, mg_down, mg_up) as diffusion's Neumann Helmholtz, the
     projections' periodic Poisson, the cavity's Crank-Nicolson Helmholtz
     on Dirichlet walls under the moving lid (the kernels' ZERO edge, every
     top ghost of every frame +0.0 bit for bit, as the plain fill writes
     it) and burgers_viscous tophat's on periodic edges; the coefficient
     operators as
     VarCoeffCCMG2d (the _vc entries) with lm_atm's edges (periodic x,
     Neumann bottom, Dirichlet top) and on Neumann walls, and GeneralMG2d
     (the _general entries, alpha 10, beta xy + 1, gamma (1, 1)) with
     homogeneous Dirichlet edges; then mg_core of every case at every top
     it holds (2^2 .. 128^2 in float32, .. 64^2 in float64), from a guess
     and from a zero guess; and mg_down and mg_up of every case at every
     peeled level with nsmooth 50, whose halo no box holds, so the plan
     splits the sweeps into rounds (mg_kernel.tile_plan), v with its
     ghosts, the restricted residual and the finest level's residual
     against down_plain and up_plain;
  4c. with --parent: k_down and k_up of every case of phase 4 at every
     peeled level of 1024^2 and 4096^2, float64 and float32, equal by bits
     to the parent's kernels (built from DIR in the same call) -- v with
     its ghosts, the restricted residual, the finest level's residual --
     and within phase 4's tolerances of the plain versions; both builds'
     ptxas lines of k_down and k_up.  Alone (--mg-tiles), also the
     profiler's device us a launch of both, in turns: the constant
     operator at 4096^2 and 2048^2 on diffusion gaussian's frames and on
     random frames (with their subnormal share), and each operator at its
     1024^2 cycle's peeled levels;
  4a. the lm_atm interface kernels (lm_mac, lm_rho, lm_states; one launch
     a call, tiles in shared memory) against their plain versions, on
     decisively signed random fields at 200x136, 1024x1000 (a ragged last
     tile column) and 1024^2 and on a bubble state at 1024^2 after 3
     kernel steps, in
     float64 (<= 1e-12 of each stated scale) and float32 (<= 1e-5), the
     MAC frames zero exactly where the plain version's are;
  4b. the sharded multigrid's kernels (mg_deep_smooth, mg_correct) against
     their plain versions, f64 (1e-12) and f32 (1e-5; a residual to those
     factors of the terms it cancels): on the 1x1 frames of the sharded
     path's levels (256^2, 512^2, 1024^2, one halo cell, d = 21, 10 sweeps)
     with every emit, and the correction; at every block of a 2x2 and a 1x4
     split of 1024^2 (d = 21) with Dirichlet and periodic edges, the frames
     filled from one global array as the exchange fills them and the flags
     from parallel.sharded_mg.kernel_flags; Jacobi, Chebyshev and the vc
     and general operators at 256^2; and every smoother at 50 sweeps,
     whose halo no box holds, so the plan splits the round into sub-rounds
     (sharded_mg_kernel.deep_plan), on the 1x1 1024^2 frame and on a block
     of a 2x2 split of 1024^2 as deep as the sweeps reach;
  5. the main paths through Pyro -> run_sim on CUDA in float32, each with
     every launch count reset just before and read just after:
     compressible quad at 1024^2 for 100 steps and rt at 256x768 for 50
     steps (one CTU launch per step), then diffusion gaussian and
     incompressible shear at 1024^2 for 10 steps each (per multigrid
     cycle one mg_core and one mg_down plus one mg_up per peeled level),
     then the MOL solvers, each timed after one warm-up step:
     compressible_rk quad 1024^2 and rt 256x768 for 20 RK4 steps each (4
     mol_rk launches a step), compressible_fv4 acoustic_pulse 1024^2 for
     20 steps (4 mol_fv4 a step) and compressible_sdc acoustic_pulse
     1024^2 for 5 steps (9 mol_fv4 a step), with no CTU or multigrid
     launch on those paths; then swe quad (Roe, limiter 2) and kh (HLLC)
     at 1024^2 for 100 steps each, one swe launch a step and no other
     kernel's; no earlier path makes a swe launch; then lm_atm bubble at
     1024^2 for 10 steps after one warm-up step (one lm_mac, lm_rho and
     lm_states a step; per multigrid cycle one mg_core_vc and one
     mg_down_vc plus one mg_up_vc per peeled level; no other launch, and
     no lm or coefficient-multigrid launch on an earlier path), and one
     GeneralMG2d solve at 1024^2 (multigrid/examples'
     mg_test_general_dirichlet operator, checked against its exact
     solution); then compressible spherical advect 1024^2 for 100 steps
     (one CTU launch a step), and the padded entries at full width, fill +
     step as the JAX package's benchmark chains them: ctu_periodic on
     periodic advect 1024^2 for 100 steps, ctu_padin on kh 1024^2 for 20
     steps (the Simulation's fill), ctu_ensemble on 8 acoustic_pulse 256^2
     members for 20 steps through parallel.ensemble_step, one launch of
     that entry a step and no other kernel's; no earlier path launches a
     padded entry or a sharded-multigrid kernel;
  5c. parallel.ShardedDiffusion gaussian 1024^2 float32 on the 1x1 mesh of
     parallel.make_mesh() for 10 steps: per cycle 2 mg_deep_smooth and 1
     mg_correct per sharded level and 1 mg_core (10 at 1024^2), no
     mg_down / mg_up, phi against the serial diffusion run of phase 5;
     and at 256^2 in float64 against the serial diffusion: the same cycles
     in every solve and phi to 1e-12;
  5d. the multigrid's last consumers through Pyro -> run_sim, CUDA float32,
     the counts reset just before and read just after each: burgers tophat
     1024^2 for 100 steps (no kernel launched: Burgers has no TPU kernel),
     burgers_viscous tophat 1024^2 for 10 steps (2 solves a step) and
     incompressible_viscous cavity 1024^2 for 10 steps (4 solves a step),
     per cycle one mg_core and one mg_down plus one mg_up per peeled level
     and no other launch; then the cavity at 128^2 in float64 for 5 steps
     on the card against the port's own CPU run of the same inputs: equal
     cycle counts in every solve, u and v within 1e-10 max|U| after each
     step;
  5e. the five advection solvers through Pyro -> run_sim on CUDA float32
     at 1024^2, the counts reset just before and read just after each:
     advection smooth and advection_nonuniform slotted for 100 steps,
     advection_rk, advection_fv4 and advection_weno smooth for 20 RK4
     steps, no kernel launched (the advection family has no TPU kernel);
     the five at 128^2 in float64 for 10 steps on the card against the
     port's own CPU run (max |diff| <= 1e-12 max|a| and equal dt after
     each step); the regression driver's 16 runs (pyro2_tpu_torch/test.py,
     through PyroBenchmark) on the card in float64 against the port's
     golden copies, compare returning 0 at rtol 1e-12, each run with its
     seconds, its max abs and rel error and its launches, which must be
     the kernels of its solver (CTU in compressible, mol_rk in
     compressible_rk, mol_fv4 in fv4 and sdc, the constant multigrid in
     diffusion, shear and the cavity, the lm stages and mg_core_vc in
     lm_atm, swe_step in dam, none in the advection runs and burgers);
     then write -> io_pyro.read on the card of the quad 1024^2 float32
     state and a cavity 64^2 float64 state, equal by bits, the dtype and
     device kept, the read cavity's top edge the kernels' ZERO kind;
  5f. the compressible family's problem sources, spherical and
     well-balanced MOL stages and compressible_react: the CTU kernel with
     the heating, convection and plume sources (its weight plane) and
     compressible_react's flame and rt (nvar 6) against the plain step,
     and the MOL kernels' extended instantiation (rk heating, rk spherical
     Sedov with CGF and with HLLC_lm, rk hse with well_balanced = 1 and
     limiter 1, fv4 convection, fv4 spherical Sedov) against the plain
     stage increment, as in phases 3 and 3b, at 200x136, 1024x1000 and
     1024^2 (fv4's domains sized to square cells, convection's heated
     layer at y 0.3 inside them), and each of both kernels' configurations
     again at the grid and inputs of each path below, in float64 (1e-12)
     and float32 (1e-5); whole runs in float64 at the published
     grids for 10 steps on the card against the port's CPU run (interiors
     within 1e-10 max|a| and equal dt after each step, the kernel of the
     solver launched once a step or stage and no other); then the paths
     through Pyro -> run_sim on CUDA float32, the counts reset just
     before and read just after each: heating 1024^2, convection
     512x1536, plume 512x1024, compressible_react rt 256x768 and flame
     1024^2 for 50 steps (one CTU launch a step), compressible_rk heating
     1024^2, spherical Sedov 1024^2 (r in [0.05, 1], CGF) and hse
     576x1728 with well_balanced = 1 for 10 steps (4 mol_rk a step),
     compressible_fv4 convection 512x1536 for 10 steps (4 mol_fv4 a step)
     and compressible_sdc convection 512x1536 for 3 steps (9 a step);
  5g. tracer particles and the on-device chunked loop: the CTU kernel's
     device-dt entry (dt read from device memory) against its host-dt
     entry with the same dt (bits) and the plain step (1e-12 / 1e-5 of
     max|U|) on quad, heating and spherical advect at 1024^2, f64 and f32;
     kh 1024^2 f32 through Pyro -> run_sim for 50 steps without and with
     1024^2 grid particles (ms/step, one CTU launch a step, the particles
     finite, inside or inactive, moved); kh 128^2 f64 with 4096 random
     particles on the card against the CPU (positions within 1e-12 of the
     domain, `active` equal, after each of 10 steps), and so swe quad,
     compressible_rk quad, compressible_fv4 acoustic_pulse and
     incompressible shear (the kernels of rows 5, 6a, 6b and 8-12 under
     particles); incompressible shear
     512^2 with 256^2 particles for 5 steps (the constant multigrid's
     launches per cycle); driver_loop.run_sim_fast (one CUDA graph a
     chunk of 64 bodies) against run_sim on quad 1024^2 for 200 steps in
     f64 (states, output files' too, equal by bits) and f32 (1e-5 of the
     scale), and advection smooth 1024^2 with 256^2 particles for 100
     steps (f32), the same n and output steps; each loop's host-clock
     ms/step, the graph's replays and frozen tail, the wrapper's count
     over the capturing run (a warm-up body and the chunk's bodies); the
     device-dt entry's CUDA-event time.  Then the swe kernel's
     device-dt entry against its host-dt entry (bits) and the plain step
     on swe quad 1024^2, f64 (1e-12) and f32 (1e-5), its ptxas lines
     beside the host-dt entry's; run_sim_fast against run_sim on swe quad
     1024^2 and the ramp at its published 1024x256 for 200 steps, f64 by
     bits and f32 to 1e-5 of the scale (the ramp: its mean |diff| to 1e-4
     of its mean |U|), and swe dam 1024^2 with 256^2 grid particles
     (f32); both loops' ms/step, replays and wrapper counts
     on swe quad and the ramp (f32), and the swe device-dt entry's
     CUDA-event time;
  5h. inhomogeneous multigrid BC values, the analytic solves and
     iterative refinement: mg_test_general_inhomogeneous's operator and
     Dirichlet values, and a constant Helmholtz operator with Neumann
     values on all four edges, each entry at every peeled level (the core
     when it holds the finest level: 128^2 in float32, 64^2 in float64),
     one whole cycle and one whole solve at those sizes and 1024^2, the
     kernels fed mg_kernel.lifted_rhs on the finest level against the
     plain versions filling the values in the cycle (interiors and
     residuals; the cycle's and the solve's ghosts after the refill;
     float64 1e-12 with equal solve cycles, float32 1e-5), with the lifted
     cycle's CUDA-event time at 1024^2; the regression driver's four
     analytic solves (MG_EXPECTED) at 256^2 in float64 within 10% of their
     L2 errors, each launching its operator's three entries and no other
     kernel, and at 64^2 on the card against the CPU (equal cycles, L2
     errors within 1e-10); solve_ir in float32 on mg_test_simple's
     problem at 128^2 and 1024^2 and solve_ir_sharded on the 1 x 1 mesh
     at 1024^2 (the direct float32 solve's residual, the refined one and
     its passes, wall times and launches: the refined residual below 1e-4
     of the direct one, hi + lo within 1e-8 of a float64 card solve at
     rtol 1e-11; the sharded solve launching mg_deep_smooth, mg_correct
     and mg_core alone);
  5i. the sharded hyperbolic tier (parallel/sharded.py,
     sharded_hyperbolic.py, sharded_particles.py): k_ctu at every block of
     a 2x2 and a 1x4 split of quad 1024^2 (HLLC, outflow), rt 1024^2
     (gravity, periodic x, hse y), sod 1024^2 with reflecting walls on
     both axes (the solid clamp gated by block), spherical Sedov 1024^2
     (CGF, outflow) and the ramp at 1024x256 (at t > 0), and k_swe the
     same way on swe quad (Roe, outflow) and dam (Roe, reflecting y
     walls), in float64 and float32, after 3 serial kernel steps: each
     block set up as parallel.sharded sets up that rank (its solid and
     domain-edge flags, its window of the spherical geometry, its gated
     source fill), its frame the window of the serial filled frame (what
     the halo exchange and the extended fills leave there), its kernel
     launched alone; the reassembled interiors equal to the serial kernel
     step by bits, each block's kernel within 1e-12 / 1e-5 of max|U| of
     its plain step with the same flags; then the tier on
     parallel.make_mesh()'s 1x1 mesh in float32, every count reset just
     before and read just after each run: ShardedCompressible quad 1024^2
     for 100 steps (one k_ctu a step, no other kernel) and ShardedSWE
     quad 1024^2 for 100 steps (one k_swe a step), at the sharded CFL dt;
     ShardedAdvection smooth and ShardedBurgers tophat 1024^2 for 100
     steps (no kernel launched); ShardedCompressible advect 1024^2 with
     10^4 grid particles for 20 steps (one k_ctu a step); each run's
     state (and positions and `active`) equal by bits to the serial
     Simulation's stepped with the same dts, with its ms/step;
  5j. the sharded MOL tier and the solvers with inline sharded solves
     (parallel/sharded_mol.py, sharded_incompressible.py,
     sharded_burgers_viscous.py): k_rk, with each block's domain-edge
     flags (ints 21..24), at every block of a 2x2 and a 1x4 split of rk
     quad 1024^2 (HLLC, outflow, cvisc 0.1) and rk kh 1024^2 (periodic),
     and k_fv4 the same way on acoustic_pulse 1024^2, in float64 and
     float32, after 3 serial kernel steps: each block set up as that rank
     is, its frame the window of the serial filled frame, its kernel
     launched alone; the reassembled increments equal to the serial
     kernel increment by bits, each block's kernel within 1e-12 / 1e-5 of
     its plain stage with the same flags (of the increment scale, as
     mol_check); then on parallel.make_mesh()'s 1x1 mesh in float32, every
     count reset just before and read just after each run:
     ShardedCompressibleRK quad 1024^2 for 20 steps (4 k_rk a step, no
     other kernel), ShardedCompressibleFV4 acoustic_pulse 1024^2 for 20
     (4 k_fv4 a step) and ShardedCompressibleSDC for 5 (9 a step), from
     preevolve_interior (equal to the serial preevolve by bits), each
     equal by bits to the serial Simulation stepped with the same dts;
     ShardedIncompressible shear 1024^2 (preevolve + 10 steps),
     ShardedIncompressibleViscous shear 1024^2 (preevolve + 5) and
     ShardedBurgersViscous tophat 1024^2 (10 steps), launching
     mg_deep_smooth, mg_correct and mg_core alone in the numbers
     sharded_mg.stats' solves and cycles imply (2 and 1 per sharded level
     a cycle, 1), against the serial float32 run with the same dts within
     1e-3 of max(1, max|U|), and the same three at 256^2 in float64 for 3
     steps against the serial float64 card run within 1e-11 (the serial
     CFL dt before each step within 1e-11 of the sharded one); each run's
     ms/step beside the serial run's;
  5l. the plain structure of the sharded multigrid on the card
     (use_pallas=False and comm_mode="sweep"): the half-sweep kernel
     mg_sweep (k_sweep: one colour pass between refreshes of the physical
     ghosts, or the residual and its restriction) against sweep_plain at
     every block of a 2x2 and a 1x4 split of 1024^2 (the one-ghost frames
     from one global array as the exchange fills them, the blocks' flags)
     with Dirichlet, Neumann and periodic edges and the constant, vc and
     general operators, each colour and residual emit, and on the 1x1
     frame of every level of a 1024^2 solve down to 2x2, f64 (1e-12
     max|v|) and f32 (1e-5; a residual to those factors of the terms it
     cancels); mg_kernel.coarse_cycle (the serial kernels' cycle from a
     level above CORE_MAX: one core, a down and an up a level above it)
     against serial._v_cycle, three operators, f64 and f32; ShardedMG,
     ShardedVarCoeffMG and ShardedGeneralMG with use_pallas=False and with
     comm_mode="sweep" on make_mesh()'s 1x1 mesh, every count reset just
     before and read just after each solve and every multigrid plain
     version made to raise on a CUDA tensor (plain_guard): at 256^2 f64
     the CPU plain structure's cycles and its solution to 1e-12 max|v|,
     at 1024^2 f32 the kernel structure's solution to 1e-5 max|v|, deep
     and sweep equal by bits on the card, launches a cycle equal to
     sharded_mg.structure's plan, and ms a solve of each beside the
     kernel structure's;
  6. CUDA-event timing of each kernel and its plain version at the main
     paths' shapes (quad 1024^2; the sharded quad path's block step on
     the 1x1 mesh and a 2x2 block with its seam flags; the sharded rk
     quad path's k_rk block step the same way (a 2x2 block is 512^2,
     ints 22 and 24 zero); the 1024^2
     solves' levels, constant, vc and general; the rk quad and fv4
     acoustic_pulse 1024^2 increments;
     the swe quad 1024^2 step; the lm_atm stages on the 1024^2 bubble;
     the spherical CTU step and each padded entry at its path's shape;
     mg_deep_smooth and mg_correct at the sharded path's finest level, and
     mg_deep_smooth on a block of a 2x2 split of 1024^2, d 21; mg_sweep,
     a red pass and the restricted residual, on the 1x1 1024^2 frame and a
     256^2 block of a 4x4 split),
     beside each kernel's bound on this card, the multigrid ascent and
     descent at every peeled level with their plan, the swe step with
     other tiles, and the host time of building lm_atm's VarCoeffCCMG2d at
     1024^2; the CTU step's, the rk and fv4 stages' and the swe step's
     peak device memory at quad, quad, acoustic_pulse and quad 1024^2,
     and the bytes each lm_atm stage allocates on the bubble (its outputs
     alone); the constant kernels on the cavity's operator with its ZERO
     edge beside the same operator on Neumann walls;
     the core's schedule at the 1024^2
     cycles' 128^2 top with its barriers counted by kind, and its time on
     the coarse problems one ShardedDiffusion step hands it against random
     data (the share of subnormal values in each); and phase 5f's
     configurations at their paths' shapes, each beside its bound from
     work() with the weight plane and the spherical lines counted; the
     stage split of ctu_periodic at advect 1024^2 float32 (bench.py's):
     100 fills alone (stage 0), then 100 fill + step calls of each of
     stages 1, 2, 3 and 4 from the same filled frame (a prefix's output is
     no state to step on from), each run with the counts reset just
     before and read just after (100 launches of its entry and no other),
     each stage's ms and its difference from the stage before under
     bench.py's names, an estimate and not a partition (each prefix is a
     kernel of its own, with its own registers), beside the ptxas line of
     every k_ctu instantiation, and each prefix kernel against its plain
     version and its bound;
  7. under the profiler, after every CUDA-event timing: the kernels one
     swe step launches (k_swe, once), one rk stage (k_rk, once), one
     mg_deep_smooth call at the solvers' 10 sweeps (k_deep, once), each
     timed mg_sweep call (k_sweep, once), one
     call of each lm_atm stage on the 1024^2 bubble (k_lm_mac, k_lm_rho,
     k_lm_states, once each) and one mg_correct at 1024^2, 512^2 and 256^2
     (k_correct, once) with their device time a launch, the stage
     split's kernels (k_ctu of stages 1..4, once a call) with their
     device us a launch and the differences, the k_down
     launches of a cycle (one
     a peeled level) and of a call split into rounds (one a round), the
     device time of k_down and k_up a call at every peeled level of the
     three operators' 1024^2 cycles (and of the cavity's, beside Neumann
     walls'), and mg_down with tiles of other
     sizes; then torch.profiler breakdowns of 20 quad steps, 20
     ctu_periodic advect
     steps (fill + step), 5 diffusion steps, 5 shear steps, 5 rk quad
     steps, 5 fv4 and 3
     sdc acoustic_pulse steps, 5 swe quad steps, 5 lm_atm bubble steps, 2
     GeneralMG2d solves, 20 spherical advect steps, 5 sharded diffusion
     steps, 20 burgers, 5 burgers_viscous and 5 cavity steps, 10 steps
     of each phase 5i class on the 1x1 mesh (quad, swe quad, advection,
     burgers), 5 steps of each phase 5j class on the 1x1 mesh and, for
     the three multigrid ones, 5 serial steps beside them, 20
     advection and 5 advection_weno smooth steps, and phase 5f's paths
     (10 CTU steps each, 3 rk and fv4 steps, 2 sdc steps): device time
     by kernel and the device's busy share of the wall time; phase 5g's
     device kernels a kh step with and without particles, and one whole
     run of each loop (host and on-device) with its device-busy us/step
     and idle share, and the device-dt k_ctu (k_swe on swe) launches of
     the on-device run as the profiler counts them (the replays times the
     chunk's bodies, frozen ones included: the kernels line's launches of
     ctu_step_device_dt and swe_step_dev). Each profiler
     session idles 20 ms on each side of its calls and is made up to
     three times; if none records a device kernel, the
     wrappers' counts count the launches, CUDA events time them, and the
     log says so.

The line before the last is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# data-sheet peaks (dense, no sparsity): memory bytes/s and float32
# (non-tensor-core) operations/s, by the name nvidia-smi reports
PEAKS = (("H100 PCIe", 2.0e12, 51.2e12),
         ("H100 NVL", 3.9e12, 60.0e12),
         ("H100", 3.35e12, 66.9e12),
         ("H200", 4.8e12, 66.9e12))

# one step each: (name, problem, inputs, extra passive scalars)
CONFIGS = (
    ("sod_cgf_lim1", "sod", {"compressible.riemann": "CGF",
                             "mesh.ymax": 1.0}, None),
    ("quad_hllc", "quad", {}, None),
    ("quad_lim1", "quad", {"compressible.limiter": 1}, None),
    ("quad_lim0_noflat", "quad", {"compressible.limiter": 0,
                                  "compressible.use_flattening": 0}, None),
    ("kh_hllc_lm_periodic", "kh", {"compressible.riemann": "HLLC_lm"}, None),
    ("rt_gravity_hse", "rt", {}, None),
    ("walls_floor_sponge_scalar", "quad", {
        "mesh.xlboundary": "reflect", "mesh.xrboundary": "reflect",
        "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect",
        "compressible.riemann": "CGF", "compressible.small_dens": 0.2,
        "compressible.grav": -0.5, "sponge.do_sponge": 1,
        "sponge.sponge_rho_begin": 0.6, "sponge.sponge_rho_full": 0.3},
     ["passive"]),
)


# the CTU kernel on spherical grids (theta in [pi/4, 3 pi/4], CGF, outflow
# edges): advect on r in [0.5, 1] and the Sedov blast on r in [0.05, 1].
# Here and on the padded entries' frames below every step takes the CFL dt:
# the advect and acoustic_pulse inputs fix a dt for 64^2 and 128^2 that is
# far past the CFL limit at 1024^2
SPHERICAL = {"mesh.grid_type": "SphericalPolar", "driver.fix_dt": -1.0,
             "mesh.ymin": 0.7853981633974483, "mesh.ymax": 2.356194490192345,
             "mesh.xlboundary": "outflow", "mesh.xrboundary": "outflow",
             "mesh.ylboundary": "outflow", "mesh.yrboundary": "outflow",
             "compressible.riemann": "CGF"}
SPH_ADVECT = {**SPHERICAL, "mesh.xmin": 0.5, "mesh.xmax": 1.0}
SPH_CONFIGS = (
    ("sph_advect_cgf", "advect", SPH_ADVECT, None),
    ("sph_sedov_cgf", "sedov", {**SPHERICAL, "mesh.xmin": 0.05,
                                "mesh.xmax": 1.0, "sedov.r_init": 0.1},
     None),
)

# the padded-frame entries (solvers/compressible/padded_step.py) run on
# doubly periodic frames without a floor, as the JAX package's benchmark
# sets them up (bench.py)
PERIODIC = {"mesh.xlboundary": "periodic", "mesh.xrboundary": "periodic",
            "mesh.ylboundary": "periodic", "mesh.yrboundary": "periodic",
            "compressible.small_dens": -1.e30, "driver.fix_dt": -1.0}

# the CTU checks' grids: ragged against every tile shape (200x136, and
# 1024x1000, whose last tile column is partial), and the main path's
CTU_SHAPES = ((200, 136), (1024, 1000), (1024, 1024))


# one MOL stage increment each: (name, solver, problem, inputs, extras).
# fv4 needs square cells: its domains are sized to the grid in mol_sim
WALLS = {"mesh.xlboundary": "reflect", "mesh.xrboundary": "reflect",
         "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect"}
MOL_CONFIGS = (
    ("rk_quad_hllc", "compressible_rk", "quad", {}, None),
    ("rk_kh_hllc_lm_periodic", "compressible_rk", "kh",
     {"compressible.riemann": "HLLC_lm"}, None),
    ("rk_rt_gravity_hse", "compressible_rk", "rt", {}, None),
    ("rk_walls_floor_sponge_scalar", "compressible_rk", "quad", {
        **WALLS, "compressible.riemann": "CGF",
        "compressible.small_dens": 0.2, "compressible.grav": -0.5,
        "sponge.do_sponge": 1, "sponge.sponge_rho_begin": 0.6,
        "sponge.sponge_rho_full": 0.3}, ["passive"]),
    ("fv4_acoustic_pulse", "compressible_fv4", "acoustic_pulse", {}, None),
    ("fv4_kh", "compressible_fv4", "kh", {}, None),
    ("fv4_rt_gravity", "compressible_fv4", "rt", {}, None),
)

MOL_KERNELS = ("mol_rk", "mol_fv4")


# phase 5f: the compressible family's problem sources, spherical and
# well-balanced MOL stages, and compressible_react.  The CTU kernel's
# configurations, one step each: (name, solver, problem, inputs)
SRC_CONFIGS = (
    ("heating", "compressible", "heating", {}),
    ("convection", "compressible", "convection", {}),
    ("plume", "compressible", "plume", {}),
    ("react_flame", "compressible_react", "flame", {}),
    ("react_rt_nvar6", "compressible_react", "rt", {}),
)
# the Sedov blast on a SphericalPolar grid for the MOL stages, r in
# [0.05, 1] (theta as SPHERICAL's; fv4's square cells narrow it)
SPH_MOL = {k: v for k, v in SPHERICAL.items() if k != "compressible.riemann"}
SPH_MOL.update({"mesh.xmin": 0.05, "mesh.xmax": 1.0, "sedov.r_init": 0.1})
WELL_BALANCED = {"compressible.well_balanced": 1, "compressible.limiter": 1}
# one stage increment each: (name, solver, problem, inputs).  fv4's
# domains are sized to the grid (mol_sim): convection's heated layer is
# put at y 0.3, inside the shallow domain
MOL_SRC_CONFIGS = (
    ("rk_heating", "compressible_rk", "heating", {}),
    ("rk_sph_sedov_cgf", "compressible_rk", "sedov",
     {**SPH_MOL, "compressible.riemann": "CGF"}),
    ("rk_sph_sedov_hllc_lm", "compressible_rk", "sedov",
     {**SPH_MOL, "compressible.riemann": "HLLC_lm"}),
    ("rk_hse_well_balanced", "compressible_rk", "hse", WELL_BALANCED),
    ("fv4_convection", "compressible_fv4", "convection",
     {"convection.y_height": 0.3}),
    ("fv4_sph_sedov", "compressible_fv4", "sedov", SPH_MOL),
)
# phase 5f's full-width paths, each with its problem's published inputs
# and only the grid and the step count changed: (label, solver, problem,
# nx, ny, steps, inputs); the MOL ones also name their kernel and its
# launches a step.  Each kernel configuration is also held against its
# plain version at its path's grid and inputs
SRC_PATHS = (
    ("heating", "compressible", "heating", 1024, 1024, 50, {}),
    ("convection", "compressible", "convection", 512, 1536, 50, {}),
    ("plume", "compressible", "plume", 512, 1024, 50, {}),
    ("react_rt", "compressible_react", "rt", 256, 768, 50, {}),
    ("react_flame", "compressible_react", "flame", 1024, 1024, 50, {}),
)
MOL_SRC_PATHS = (
    ("rk_heating", "compressible_rk", "heating", 1024, 1024, 10, "mol_rk", 4,
     {}),
    ("fv4_convection", "compressible_fv4", "convection", 512, 1536, 10,
     "mol_fv4", 4, {}),
    ("sdc_convection", "compressible_sdc", "convection", 512, 1536, 3,
     "mol_fv4", 9, {}),
    ("rk_sph_sedov", "compressible_rk", "sedov", 1024, 1024, 10, "mol_rk", 4,
     {**SPH_MOL, "compressible.riemann": "CGF"}),
    ("rk_hse_well_balanced", "compressible_rk", "hse", 576, 1728, 10,
     "mol_rk", 4, WELL_BALANCED),
)
# whole runs in float64 on the card against the CPU at the published
# grids (the spherical Sedov runs on 128^2, fv4's theta from 128 dr):
# (solver, problem, inputs, kernel, launches a step)
CARD_VS_CPU_RUNS = (
    ("compressible", "heating", {}, "ctu_step", 1),
    ("compressible", "convection", {}, "ctu_step", 1),
    ("compressible", "plume", {}, "ctu_step", 1),
    ("compressible_react", "flame", {}, "ctu_step", 1),
    ("compressible_react", "rt", {}, "ctu_step", 1),
    ("compressible_rk", "heating", {}, "mol_rk", 4),
    ("compressible_rk", "sedov", {**SPH_MOL, "mesh.nx": 128,
                                  "mesh.ny": 128,
                                  "compressible.riemann": "CGF"},
     "mol_rk", 4),
    ("compressible_rk", "sedov", {**SPH_MOL, "mesh.nx": 128,
                                  "mesh.ny": 128,
                                  "compressible.riemann": "HLLC_lm"},
     "mol_rk", 4),
    ("compressible_rk", "hse", WELL_BALANCED, "mol_rk", 4),
    ("compressible_fv4", "heating", {}, "mol_fv4", 4),
    ("compressible_fv4", "convection", {}, "mol_fv4", 4),
    ("compressible_fv4", "sedov", {
        **SPH_MOL, "mesh.nx": 128, "mesh.ny": 128,
        "mesh.ymax": SPH_MOL["mesh.ymin"] + 0.95}, "mol_fv4", 4),
    ("compressible_sdc", "convection", {}, "mol_fv4", 9),
)


# multigrid checks: (name, operator, edges x-lo x-hi y-lo y-hi, whether
# the right-hand side needs zero mean).  The constant operator as the
# solvers use it: diffusion's Crank-Nicolson Helmholtz operator (alpha 1,
# beta = dt k / 2 with dt = 2 dx^2) on Neumann walls, and the projections'
# Poisson operator (alpha 0, beta -1) on the doubly periodic shear domain;
# the vc operator with lm_atm's phi edges and a stratified coefficient
# with a bump (as beta0^2 / rho), and on Neumann walls; the general
# operator of tests/test_multigrid.py's TestGeneralMG with homogeneous
# Dirichlet edges; then the Crank-Nicolson Helmholtz operators of the
# viscous solvers: incompressible_viscous's cavity (alpha 1, beta = dt nu /
# 2 with nu = 0.0025 from inputs.cavity and dt = 0.8 dx, the CFL dt of a
# unit lid at 1024^2) on Dirichlet walls under the moving lid, whose ghosts
# are +0.0 at multigrid level (mg_kernel.ZERO), and burgers_viscous
# tophat's (beta = dt eps / 2, eps = 0.005, dt = 0.8 dx) on periodic edges
LM_EDGES = ("periodic", "periodic", "neumann", "dirichlet")
CAVITY_EDGES = ("dirichlet", "dirichlet", "dirichlet", "moving_lid")
CAVITY_BETA = 0.5 * (0.8 / 1024) * 0.0025
BURGERS_BETA = 0.5 * (0.8 / 1024) * 0.005
MG_CASES = (("neumann_helmholtz", "const", ("neumann",) * 4, False),
            ("periodic_poisson", "const", ("periodic",) * 4, True),
            ("vc_lm_edges", "vc", LM_EDGES, False),
            ("vc_neumann", "vc", ("neumann",) * 4, True),
            ("general_dirichlet", "general", ("dirichlet",) * 4, False),
            ("cavity_cn", "const", CAVITY_EDGES, False),
            ("periodic_helmholtz", "const", ("periodic",) * 4, False))
# the cases before these two are the parent's: their worst errors are
# logged apart, to be held against its runs
NEW_MG_CASES = ("cavity_cn", "periodic_helmholtz")

MG_KERNELS = ("mg_core", "mg_down", "mg_up")
VC_KERNELS = ("mg_core_vc", "mg_down_vc", "mg_up_vc")
GENERAL_KERNELS = ("mg_core_general", "mg_down_general", "mg_up_general")
LM_KERNELS = ("lm_mac", "lm_rho", "lm_states")

# one swe step each: (name, problem, inputs, extra passive scalars); the
# dam's y extent is widened from 0.05 to 1 so that its cells are not
# slivers
SWE_CONFIGS = (
    ("swe_quad_roe", "quad", {"swe.riemann": "Roe", "swe.limiter": 2},
     None),
    ("swe_kh_hllc_periodic", "kh", {"swe.riemann": "HLLC"}, None),
    ("swe_dam_roe_lim1_walls", "dam", {"swe.riemann": "Roe",
                                       "swe.limiter": 1, "mesh.ymax": 1.0},
     None),
    ("swe_advect_lim0", "advect", {}, None),
    ("swe_quad_hllc_scalar", "quad", {"swe.riemann": "HLLC"}, ["passive"]),
)


def log(*a):
    print(*a, flush=True)


def make_sim(problem, inputs, dtype, extra_vars=None,
             solver="compressible"):
    import numpy as np

    from pyro2_tpu_torch import Pyro

    p = Pyro(solver, device="cuda", dtype=dtype)
    p.initialize_problem(problem, inputs_dict=inputs)
    if not extra_vars:
        return p.sim
    sim = type(p.sim)(solver, problem, p.problem_func, p.rp,
                      device="cuda", dtype=dtype)
    sim.initialize(extra_vars=extra_vars)
    sim.preevolve()
    rng = np.random.default_rng(5)
    base = sim.cc_data.data[0].cpu().numpy()    # density or height
    for name in extra_vars:
        sim.cc_data.set_var(name, base * rng.random(base.shape))
    sim.cc_data.t = 0.0
    return sim


def interior(U, g):
    return U[..., g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


def compare(name, problem, inputs, extra, nx, ny, dtype, tol,
            solver="compressible"):
    """Kernel vs plain step from the same state after 3 kernel steps."""
    sim = make_sim(problem, {"mesh.nx": nx, "mesh.ny": ny, **inputs},
                   dtype, extra, solver=solver)
    return ctu_check(name, sim, tol)


def ctu_check(name, sim, tol):
    """The CTU kernel vs its plain step on a live simulation on the card,
    one step from the same state after 3 kernel steps; returns
    max |diff|."""
    import torch

    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    got = sim._step.launch(U, t, dt)
    ref = sim._step.plain(U, t, dt)
    torch.cuda.synchronize()
    g = sim.cc_data.grid
    a, b = interior(ref, g), interior(got, g)
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    ghost = torch.ones(U.shape[1:], dtype=torch.bool, device=U.device)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    ghosts = torch.equal(got[:, ghost], U[:, ghost])
    ok = bool(torch.isfinite(b).all()) and err <= tol * scale and ghosts
    log(f"  {'ok ' if ok else 'BAD'} {name:27s} {g.nx}x{g.ny} "
        f"{str(U.dtype)[6:]:8s} max|diff| = {err:.3e}  "
        f"(tol {tol:g} x max|U| = {tol * scale:.3e}), ghosts kept: {ghosts}")
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain step: {name}")
    return err


def mol_sim(solver, problem, inputs, extra, nx, ny, dtype):
    """A MOL simulation on the card, stepping at the CFL dt (the
    acoustic_pulse inputs fix dt for 128^2); fv4 grids get square cells
    (SphericalPolar ones: dtheta = dr, theta from its ymin)."""
    inputs = {"mesh.nx": nx, "mesh.ny": ny, "driver.fix_dt": -1.0, **inputs}
    if solver != "compressible_rk":
        inputs.update(square_cells(inputs, nx, ny))
    return make_sim(problem, inputs, dtype, extra, solver=solver)


def square_cells(inputs, nx, ny):
    """The domain bounds that make a grid's cells square: x in [0, 1] and
    y in [0, ny / nx]; on a SphericalPolar grid theta from ymin over ny
    times dr."""
    if inputs.get("mesh.grid_type") == "SphericalPolar":
        dr = (inputs["mesh.xmax"] - inputs["mesh.xmin"]) / nx
        return {"mesh.ymax": inputs["mesh.ymin"] + ny * dr}
    return {"mesh.xmax": 1.0, "mesh.ymax": ny / nx}


def mol_compare(name, solver, problem, inputs, extra, nx, ny, dtype, tol):
    """A MOL kernel vs its plain version, one stage increment from the
    same state after 3 kernel steps; returns max |diff|."""
    return mol_check(name, mol_sim(solver, problem, inputs, extra, nx, ny,
                                   dtype), tol)


def mol_check(name, sim, tol):
    """A MOL kernel vs its plain version on a live simulation on the card,
    one stage increment from the same state after 3 kernel steps; returns
    max |diff|."""
    import torch

    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    step = sim._step
    got = step.launch(U, t, dt)
    ref = step.plain(U, t, dt)
    torch.cuda.synchronize()
    scale = mol_kernel.increment_scale(sim, step.kind, U, t, dt)
    err = float((ref - got).abs().max())
    g = sim.cc_data.grid
    ghost = torch.ones(U.shape[1:], dtype=torch.bool, device=U.device)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    zero = not bool(got[:, ghost].any())
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale and zero
    log(f"  {'ok ' if ok else 'BAD'} {name:29s} {g.nx}x{g.ny} "
        f"{str(U.dtype)[6:]:8s} max|diff| = {err:.3e}  (tol {tol:g} x "
        f"{scale:.4g} = {tol * scale:.3e}), ghosts of k zero: {zero}")
    if not ok:
        raise AssertionError(f"MOL kernel disagrees with its plain "
                             f"version: {name}")
    return err


def mol_main_path(solver, problem, nx, ny, steps, kernel, per_step,
                  inputs=None):
    """Pyro(solver) -> run_sim on CUDA float32 for `steps` steps after one
    untimed warm-up step, with every count reset just before and read just
    after; returns (pyro, launches of `kernel`)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": nx, "mesh.ny": ny, "driver.max_steps": steps + 1,
        "driver.tmax": 1.0e30, **(inputs or {})})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    p.single_step()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, mg, _ = read_counts()
    no_swe_launches(solver)
    no_lm_launches(solver)
    no_padded_launches(solver)
    no_sharded_launches(solver)
    mol = dict(mol_kernel.launches)
    expect = dict.fromkeys(MOL_KERNELS, 0)
    expect[kernel] = per_step * steps
    if sim.n != steps + 1 or mol != expect or ctu != 0 or any(mg.values()):
        raise AssertionError(
            f"{solver} {problem}: {sim.n} steps, MOL launches {mol}, CTU "
            f"{ctu}, multigrid {mg}; expected {steps} + 1 steps, MOL "
            f"{expect} "
            "and no other launch")
    g = sim.cc_data.grid
    dens = interior(sim.cc_data.data, g)[sim.ivars.idens]
    pres = interior(sim.cc_data.get_var("pressure"), g)
    for name, f in (("density", dens), ("pressure", pres)):
        if not bool(torch.isfinite(f).all()) or float(f.min()) <= 0.0:
            raise AssertionError(f"{solver} {problem}: {name} not finite "
                                 "and positive")
    zps = nx * ny * steps / seconds
    log(f"  {solver} {problem} {nx}x{ny} f32: {steps} steps (after 1) in "
        f"{seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, "
        f"{zps:.4e} zone-updates/s, {kernel} launches {mol[kernel]} "
        f"({per_step}/step), CTU 0, multigrid 0, t = {sim.cc_data.t:.6g}, "
        f"min rho {float(dens.min()):.6g}, min p {float(pres.min()):.6g}")
    return p, mol[kernel]


def card_vs_cpu_run(solver, problem, inputs, steps, tol, kernel, per_step):
    """`solver` on `problem` with its published inputs (plus `inputs`) in
    float64 through Pyro on the card and on the CPU for `steps` steps: the
    card's run launches `kernel` per_step times a step and no other
    kernel (the counts reset just before it and read just after), and
    after each step its interior is within tol max|a| of the CPU run's
    and its dt equal to rtol tol; returns the worst |diff| / max|a|."""
    import torch

    from pyro2_tpu_torch import Pyro

    pyros = []
    for device in ("cpu", "cuda"):
        p = Pyro(solver, device=device, dtype=torch.float64)
        p.initialize_problem(problem, inputs_dict={
            "driver.max_steps": steps, "driver.tmax": 1.0e30, **inputs})
        pyros.append(p)
    cpu, card = pyros
    g = card.sim.cc_data.grid
    worst = 0.0
    torch.cuda.synchronize()
    reset_counts()
    for k in range(steps):
        cpu.single_step()
        card.single_step()
        a = interior(cpu.sim.cc_data.data, g)
        b = interior(card.sim.cc_data.data, g).cpu()
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        if (not bool(torch.isfinite(b).all()) or err > tol * scale or
                abs(card.sim.dt - cpu.sim.dt) > tol * cpu.sim.dt):
            raise AssertionError(
                f"{solver} {problem} f64 step {k + 1}: max|diff| {err:.3e} "
                f"> {tol:g} x {scale:.3g}, or dt {card.sim.dt!r} against "
                f"{cpu.sim.dt!r}")
    launched = {k: v for k, v in all_counts().items() if v}
    if launched != {kernel: per_step * steps}:
        raise AssertionError(f"{solver} {problem} f64 on the card: launches "
                             f"{launched}, expected {kernel} "
                             f"{per_step * steps} and no other")
    grid = "spherical " if getattr(g, "coord_type", 0) else ""
    log(f"  ok  {solver} {grid}{problem} {g.nx}x{g.ny} f64, {steps} steps, "
        f"card against CPU: worst max|diff| / max|a| {worst:.3e} (tol "
        f"{tol:g}); {kernel} launches {launched[kernel]}")
    return worst


def main_path(problem, nx, ny, steps, inputs=None, solver="compressible"):
    """Pyro(solver) -> run_sim on CUDA float32 (a CTU solver: compressible
    or compressible_react); returns (pyro, seconds, launches)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": nx, "mesh.ny": ny, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **(inputs or {})})
    assert p.sim.cc_data.data.is_cuda
    assert p.sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_launch = ctu_kernel.launches
    if any(read_counts()[1].values()):
        raise AssertionError(f"{problem}: multigrid kernels launched")
    no_mol_launches(problem)
    no_swe_launches(problem)
    no_lm_launches(problem)
    no_padded_launches(problem)
    no_sharded_launches(problem)

    sim = p.sim
    g = sim.cc_data.grid
    dens = interior(sim.cc_data.data, g)[sim.ivars.idens]
    pres = interior(sim.cc_data.get_var("pressure"), g)
    if sim.n != steps or n_launch != steps:
        raise AssertionError(f"{problem}: {sim.n} steps, {n_launch} kernel "
                             f"launches, expected {steps} of each")
    for name, f in (("density", dens), ("pressure", pres)):
        if not bool(torch.isfinite(f).all()) or float(f.min()) <= 0.0:
            raise AssertionError(f"{problem}: {name} not finite and positive")
    zps = nx * ny * steps / seconds
    grid = "spherical " if getattr(g, "coord_type", 0) else ""
    if solver != "compressible":
        grid = f"{solver} {grid}"
    log(f"  {grid}{problem} {nx}x{ny} f32: {steps} steps in {seconds:.3f} s, "
        f"{1e3 * seconds / steps:.3f} ms/step, {zps:.4e} zone-updates/s, "
        f"kernel launches {n_launch}, t = {sim.cc_data.t:.6g}, "
        f"min rho {float(dens.min()):.6g}, min p {float(pres.min()):.6g}")
    return p, seconds, n_launch


def reset_counts():
    """Every kernel's launch count, and the multigrid solve and cycle
    counts (serial and sharded), to 0."""
    from pyro2_tpu_torch.multigrid import MG, mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.parallel import sharded_mg
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    from pyro2_tpu_torch.solvers.compressible import padded_step

    ctu_kernel.launches = 0
    swe_kernel.launches = 0
    for counts in (mg_kernel.launches, mol_kernel.launches,
                   lm_kernel.launches, padded_step.launches, MG.stats,
                   sharded_mg_kernel.launches, sharded_mg.stats):
        for key in counts:
            counts[key] = 0


def read_counts():
    """(CTU launches, multigrid launches by kernel, multigrid stats)."""
    from pyro2_tpu_torch.multigrid import MG, mg_kernel
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    return ctu_kernel.launches, dict(mg_kernel.launches), dict(MG.stats)


def no_mol_launches(what):
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    if any(mol_kernel.launches.values()):
        raise AssertionError(f"{what}: MOL kernels launched "
                             f"{mol_kernel.launches}")


def no_lm_launches(what):
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    if any(lm_kernel.launches.values()):
        raise AssertionError(f"{what}: the lm_atm kernels launched "
                             f"{lm_kernel.launches}")


def no_padded_launches(what):
    from pyro2_tpu_torch.solvers.compressible import padded_step

    if any(padded_step.launches.values()):
        raise AssertionError(f"{what}: the padded CTU entries launched "
                             f"{padded_step.launches}")


def no_sharded_launches(what):
    from pyro2_tpu_torch.multigrid import sharded_mg_kernel

    if any(sharded_mg_kernel.launches.values()):
        raise AssertionError(f"{what}: the sharded multigrid kernels "
                             f"launched {sharded_mg_kernel.launches}")


def no_swe_launches(what):
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    if swe_kernel.launches:
        raise AssertionError(f"{what}: the swe kernel launched "
                             f"{swe_kernel.launches} times")


def swe_main_path(problem, nx, ny, steps, inputs):
    """Pyro("swe") -> run_sim on CUDA float32 with every count reset just
    before and read just after; returns (pyro, swe launches)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    p = Pyro("swe")                     # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": nx, "mesh.ny": ny, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **inputs})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, mg, _ = read_counts()
    no_lm_launches(f"swe {problem}")
    no_padded_launches(f"swe {problem}")
    no_sharded_launches(f"swe {problem}")
    n_swe = swe_kernel.launches
    if (sim.n != steps or n_swe != steps or ctu != 0 or any(mg.values())
            or any(mol_kernel.launches.values())):
        raise AssertionError(
            f"swe {problem}: {sim.n} steps, swe launches {n_swe}, CTU "
            f"{ctu}, multigrid {mg}, MOL {mol_kernel.launches}; expected "
            f"{steps} steps, one swe launch each and no other launch")
    g = sim.cc_data.grid
    h = interior(sim.cc_data.data, g)[sim.ivars.ih]
    if not bool(torch.isfinite(interior(sim.cc_data.data, g)).all()) or \
            float(h.min()) <= 0.0:
        raise AssertionError(f"swe {problem}: the state is not finite or "
                             "the height not positive")
    zps = nx * ny * steps / seconds
    log(f"  swe {problem} {nx}x{ny} f32 ({sim.rp.get_param('swe.riemann')},"
        f" limiter {sim.rp.get_param('swe.limiter')}): {steps} steps in "
        f"{seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, {zps:.4e} "
        f"zone-updates/s, swe launches {n_swe}, CTU 0, MOL 0, multigrid 0, "
        f"t = {sim.cc_data.t:.6g}, min h {float(h.min()):.6g}, max h "
        f"{float(h.max()):.6g}")
    return p, n_swe


def padded_entry(entry, problem, nx, ny, dtype, n_ens=None):
    """A padded entry for Pyro(problem)'s periodic state on the card:
    (sim, step, fill, frame of the initial state, the CFL dt).  Row 3
    (ctu_padin) is filled by the Simulation's own ghost fill, as its JAX
    counterpart is; the ensemble's members are the state rolled by 7 m
    cells in y."""
    import torch

    from pyro2_tpu_torch.solvers.compressible import padded_step

    sim = make_sim(problem, {"mesh.nx": nx, "mesh.ny": ny, **PERIODIC},
                   dtype)
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    g = sim.cc_data.grid
    args = (g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
            sim.rp.params, sim.ivars)
    U0 = sim.cc_data.data
    if entry == "ctu_ensemble":
        to_p, _, fill, step = padded_step.make_ctu_ensemble_step(n_ens,
                                                                 *args)
        P = to_p(torch.stack([torch.roll(U0, 7 * m, -1)
                              for m in range(n_ens)]))
    elif entry == "ctu_periodic":
        to_p, _, fill, step = padded_step.make_ctu_step_padded(*args)
        P = to_p(U0)
    else:
        step = padded_step.make_ctu_step(*args)
        fill = sim.cc_data.fill_bc_stack
        P = U0.clone()
    return sim, step, fill, P, sim.dt


def padded_compare(entry, problem, nx, ny, dtype, tol, n_ens=None):
    """A padded entry's kernel vs its plain step, one step from the same
    filled frame after 3 kernel steps, ghosts equal to the input's; a batch
    member also equals its one-member (ctu_periodic) kernel step bit for
    bit.  Returns max |diff|."""
    import torch

    from pyro2_tpu_torch.solvers.compressible import padded_step

    sim, step, fill, P, dt = padded_entry(entry, problem, nx, ny, dtype,
                                          n_ens)
    for _ in range(3):
        P = step.launch(fill(P), dt)
    P = fill(P)
    got = step.launch(P, dt)
    ref = step.plain(P, dt)
    torch.cuda.synchronize()
    g = sim.cc_data.grid
    a, b = interior(ref, g), interior(got, g)
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    ghost = torch.ones(P.shape[-2:], dtype=torch.bool, device=P.device)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    ghosts = torch.equal(got[..., ghost], P[..., ghost])
    alone = True
    if n_ens:
        _, _, _, one = padded_step.make_ctu_step_padded(
            g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
            sim.rp.params, sim.ivars)
        alone = all(torch.equal(got[m], one.launch(P[m].contiguous(), dt))
                    for m in range(n_ens))
    ok = bool(torch.isfinite(b).all()) and err <= tol * scale and ghosts \
        and alone
    what = f"{n_ens} x {nx}x{ny}" if n_ens else f"{nx}x{ny}"
    log(f"  {'ok ' if ok else 'BAD'} {entry:12s} {problem:14s} {what:14s} "
        f"{str(dtype)[6:]:8s} max|diff| = {err:.3e}  (tol {tol:g} x max|U| "
        f"= {tol * scale:.3e}), ghosts kept: {ghosts}"
        + (f", each member = its own step: {alone}" if n_ens else ""))
    if not ok:
        raise AssertionError(f"{entry} disagrees with its plain step")
    return err


def padded_path(entry, problem, n, steps, n_ens=None):
    """A padded entry on CUDA float32 at full width: `steps` steps of fill
    + step from Pyro(problem)'s initial state at its CFL dt, as the JAX
    package's benchmark chains them (bench.py) -- the ensemble through
    parallel.ensemble_step --, every count reset just before and read just
    after.  Returns (sim, step, frame, dt, launches, the fill + step
    function of (frame, dt))."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.parallel import ensemble_step
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel, padded_step
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    sim, step, fill, P, dt = padded_entry(entry, problem, n, n,
                                          torch.float32, n_ens)
    advance = ensemble_step(step, fill_bc=fill) if n_ens else \
        (lambda P, dt: step(fill(P), dt))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        P = advance(P, dt)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(padded_step.launches)
    expect = dict.fromkeys(padded_step.launches, 0)
    expect[entry] = steps
    no_lm_launches(entry)
    no_sharded_launches(entry)
    if (launches != expect or ctu_kernel.launches or swe_kernel.launches
            or any(mg_kernel.launches.values())
            or any(mol_kernel.launches.values())):
        raise AssertionError(
            f"{entry}: launches {launches}, CTU {ctu_kernel.launches}; "
            f"expected {expect} and no other launch")
    g = sim.cc_data.grid
    U = interior(P, g)
    dens = U[..., sim.ivars.idens, :, :]
    if not bool(torch.isfinite(U).all()) or float(dens.min()) <= 0.0:
        raise AssertionError(f"{entry}: the state is not finite or the "
                             "density not positive")
    zones = n * n * (n_ens or 1)
    what = f"{n_ens} x {problem} {n}^2" if n_ens else f"{problem} {n}^2"
    log(f"  {entry} ({what} f32, periodic): {steps} steps of fill + step in "
        f"{seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, "
        f"{zones * steps / seconds:.4e} zone-updates/s, {entry} launches "
        f"{launches[entry]} (1/step), no other; min rho "
        f"{float(dens.min()):.6g}")
    return sim, step, P, dt, launches[entry], advance


# the pipeline's stages as the JAX package's benchmark names them
# (bench.py's stage breakdown): the time a stage adds to the prefix before
STAGE_NAMES = {1: "interface_states", 2: "transverse_flux(2xRiemann)",
               3: "final_riemann(x2)", 4: "avisc+update"}


def periodic_stage(sim, stages):
    """make_ctu_step_padded(..., stages) for sim's grid: (fill, step)."""
    from pyro2_tpu_torch.solvers.compressible import padded_step

    g = sim.cc_data.grid
    _, _, fill, step = padded_step.make_ctu_step_padded(
        g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
        sim.rp.params, sim.ivars, stages=stages)
    return fill, step


def stage_compare(stages, nx, ny, dtype, tol):
    """A stage prefix of ctu_periodic (periodic advect) against its plain
    version (padded_step.plain_stages), one call from the same filled
    frame after 3 kernel steps of the whole step: max |diff| <= tol
    max|out| per variable in float64, over the frame in float32, and every
    ghost of the output the input's.  Returns max |diff|."""
    import torch

    sim, step, fill, P, dt = padded_entry("ctu_periodic", "advect", nx, ny,
                                          dtype)
    _, prefix = periodic_stage(sim, stages)
    for _ in range(3):
        P = step.launch(fill(P), dt)
    P = fill(P)
    got = prefix.launch(P, dt)
    ref = prefix.plain(P, dt)
    torch.cuda.synchronize()
    g = sim.cc_data.grid
    a, b = interior(ref, g), interior(got, g)
    diff = (a - b).abs().flatten(1).amax(1)
    scale = a.abs().flatten(1).amax(1)
    if dtype == torch.float64:
        within = bool((diff <= tol * scale).all())
        bound = ", ".join(f"{float(x):.3e}" for x in tol * scale)
        what = f"per variable {', '.join(f'{float(x):.3e}' for x in diff)}"
    else:
        within = float(diff.max()) <= tol * float(scale.max())
        bound = f"{tol * float(scale.max()):.3e}"
        what = f"{float(diff.max()):.3e}"
    ghost = torch.ones(P.shape[-2:], dtype=torch.bool, device=P.device)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    ghosts = torch.equal(got[..., ghost], P[..., ghost])
    ok = bool(torch.isfinite(b).all()) and within and ghosts
    log(f"  {'ok ' if ok else 'BAD'} {prefix.name:16s} advect {nx}x{ny} "
        f"{str(dtype)[6:]:8s} max|diff| {what} (tol {tol:g} x max|out| = "
        f"{bound}), ghosts kept: {ghosts}")
    if not ok:
        raise AssertionError(f"{prefix.name} disagrees with its plain "
                             "version")
    return float(diff.max())


def stage_split(psim, P, dt, reps, ctu_ptxas, bw, fp32, smi):
    """The stage split of ctu_periodic at its path's frame (bench.py's
    bench_stages): `reps` fills alone (stage 0), then `reps` fill + step
    calls of each of stages 1..4, all from the same filled frame (a
    prefix's output is no state: chained, stage 1's sum of four states
    would grow fourfold a call), each with every count reset just before
    and read just after; CUDA events.  Then each prefix's kernel alone
    against its plain version and its bound.  Returns ({stage: (fill,
    step)}, {stage: fill + step ms}, {stage: launches}, {stage: time_pair
    of the kernel}); stage 4's time_pair is the padded entries' own."""
    import torch

    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    g = psim.cc_data.grid
    entries = {s: periodic_stage(psim, s) for s in (1, 2, 3, 4)}
    fill = entries[4][0]
    P = fill(P)
    torch.cuda.synchronize()
    ms = {0: event_ms(lambda: fill(P), reps)}
    launches = {}
    for s, (_, step) in entries.items():
        event_ms(lambda: step(fill(P), dt), 3)          # warm up
        torch.cuda.synchronize()
        reset_counts()
        ms[s] = event_ms(lambda: step(fill(P), dt), reps)
        torch.cuda.synchronize()
        launched = {k: v for k, v in all_counts().items() if v}
        if launched != {step.name: reps}:
            raise AssertionError(f"stage {s}: {reps} fill + step calls "
                                 f"launched {launched}")
        launches[s] = reps
    log(f"  stage 0 (fill alone): {ms[0]:.4f} ms a call ({reps} calls)")
    for s in (1, 2, 3, 4):
        name = entries[s][1].name
        log(f"  stage {s} (fill + {name}): {ms[s]:.4f} ms a call, "
            f"{launches[s]} {name} launches and no other kernel; "
            f"{STAGE_NAMES[s]} {ms[s] - ms[s - 1]:+.4f} ms")
    log("  (the differences are an estimate, not a partition: each prefix "
        "is a kernel of its own, compiled with its own registers and so "
        "its own occupancy; the ptxas lines:)")
    for line in ctu_ptxas:
        log("    " + line)
    times = {}
    for s in (1, 2, 3):
        step = entries[s][1]
        times[s] = time_pair(
            f"{step.name} ({psim.problem_name} {g.nx}x{g.ny}, stage {s})",
            lambda: step.launch(P, dt), lambda: step.plain(P, dt),
            ctu_kernel.work(g.nx, g.ny, psim.ivars.nvar, torch.float32,
                            stages=s), bw, fp32)
    log(f"  [{smi}]")
    return entries, ms, launches, times


def stage_profile(entries, P, dt, calls):
    """Under the profiler, `calls` calls of each stage's step launch its
    k_ctu once each and no other kernel; each stage's device us a launch
    and its difference from the stage before."""
    us, prev = {}, 0.0
    for s, (_, step) in entries.items():
        us[s] = one_launch_each(lambda: step.launch(P, dt), calls, "k_ctu",
                                f"{step.name} calls (stage {s})", step.name)
    for s in (1, 2, 3, 4):
        log(f"  stage {s} ({entries[s][1].name}): {us[s]:.2f} us a launch; "
            f"{STAGE_NAMES[s]} {us[s] - prev:+.2f} us (an estimate, not a "
            "partition)")
        prev = us[s]
    return us


def make_mg(n, bc, alpha, beta, dtype):
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    return CellCenterMG2d(n, n, xl_BC_type=bc, xr_BC_type=bc,
                          yl_BC_type=bc, yr_BC_type=bc, alpha=alpha,
                          beta=(1.0 / n) ** 2 if beta is None else beta,
                          device="cuda", dtype=dtype)


def make_case_mg(n, name, op, edges, dtype):
    """An n^2 multigrid object of one of MG_CASES on the card."""
    import numpy as np

    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.mesh.grid import Grid2d
    from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
    from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d

    if name == "cavity_cn":
        from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
        from pyro2_tpu_torch.solvers.incompressible_viscous import BC

        # as the solver registers it (incompressible_viscous.simulation)
        bnd.define_bc("moving_lid", BC.user, is_solid=False)
        return CellCenterMG2d(n, n, xl_BC_type=edges[0],
                              xr_BC_type=edges[1], yl_BC_type=edges[2],
                              yr_BC_type=edges[3], alpha=1.0,
                              beta=CAVITY_BETA, device="cuda", dtype=dtype)
    if op == "const":
        return make_mg(n, edges[0], *{
            "neumann_helmholtz": (1.0, None),
            "periodic_poisson": (0.0, -1.0),
            "periodic_helmholtz": (1.0, BURGERS_BETA)}[name], dtype)
    kw = dict(xl_BC_type=edges[0], xr_BC_type=edges[1],
              yl_BC_type=edges[2], yr_BC_type=edges[3], device="cuda",
              dtype=dtype)
    g = Grid2d(n, n, ng=1)
    x, y = g.x2d, g.y2d
    if op == "vc":
        if edges == LM_EDGES:
            eta = np.exp(-2.0 * y) * (1.0 + 0.5 * np.exp(
                -((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01))
            bc = bnd.BC(xlb="periodic", xrb="periodic", ylb="reflect",
                        yrb="outflow")
        else:
            eta = 2.0 + np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y)
            bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                        yrb="neumann")
        return VarCoeffCCMG2d(n, n, coeffs=eta, coeffs_bc=bc, **kw)
    return GeneralMG2d(n, n, coeffs=general_coeffs(
        g, 10.0 + 0 * x, x * y + 1.0, 1.0 + 0 * x, 1.0 + 0 * y, dtype), **kw)


def general_coeffs(g, alpha, beta, gamma_x, gamma_y, dtype):
    """The CellCenterData2d of GeneralMG2d's four coefficients (Neumann
    ghost fills, as the JAX package's tests and examples use)."""
    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.mesh import patch

    d = patch.CellCenterData2d(g, dtype=dtype, device="cuda")
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    for name in ("alpha", "beta", "gamma_x", "gamma_y"):
        d.register_var(name, bc)
    d.create()
    for name, a in (("alpha", alpha), ("beta", beta), ("gamma_x", gamma_x),
                    ("gamma_y", gamma_y)):
        d.set_var(name, a)
    return d


def frame(rng, g, dtype, scale=1.0, zero_mean=False):
    """A random (qx, qy) frame on the card; zero_mean removes the interior
    mean (a periodic Poisson right-hand side must have none)."""
    import torch

    a = scale * rng.standard_normal((g.qx, g.qy))
    if zero_mean:
        a[1:-1, 1:-1] -= a[1:-1, 1:-1].mean()
    return torch.as_tensor(a, dtype=dtype, device="cuda")


def resid_scale(mg, level, v, f):
    """The size of the terms a residual of a level cancels: its roundoff is
    relative to these, not to the residual.  The constant operator's
    f - alpha v + beta L v sums |alpha| v and 8 |beta| v / dx^2; the
    coefficient forms sum 8 times their largest edge coefficient (already
    scaled by 1/dx^2) times v, and the general one alpha v and its two
    gamma differences."""
    from pyro2_tpu_torch.multigrid import mg_kernel

    vmax, fmax = float(v.abs().max()), float(f.abs().max())
    op = mg_kernel.flavour(mg)
    if op == "const":
        return fmax + abs(mg.alpha) * vmax + \
            8.0 * abs(mg.beta) * vmax / mg.grids[level].dx ** 2
    top = mg.planes[level].abs().amax(dim=(1, 2)).tolist()
    if op == "vc":
        return fmax + 8.0 * max(top) * vmax
    alpha, bx, by, gx, gy = top
    return fmax + (alpha + 8.0 * max(bx, by) + 2.0 * (gx + gy)) * vmax


def zero_top_ghosts(mg, what, *frames):
    """For a case whose top edge is ZERO (the moving lid): every cell of
    each frame's top ghost row, corners included, must be +0.0 bit for bit,
    as the plain fill writes it (a ghost written as 0 times a negative
    value would be -0.0, equal in value but not in bits).  Returns the
    frames checked (0 for other cases)."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    if mg_kernel.edge_kinds(mg.bc_v[-1])[3] != mg_kernel.ZERO:
        return 0
    for a in frames:
        ints = torch.int32 if a.dtype == torch.float32 else torch.int64
        bits = a[:, -1].contiguous().view(ints)
        if bool((bits != 0).any()):
            raise AssertionError(f"{what}: a top ghost is not +0.0 by bits "
                                 f"({int((bits != 0).sum())} cells)")
    return len(frames)


def mg_compare(n, case, dtype, tol, errs):
    """Each multigrid kernel of one of MG_CASES, one whole cycle and one
    whole solve against their plain versions from the same inputs; records
    the worst |diff| of each kernel in errs[kernel]."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    name, op, edges, zero_mean = case
    mg = make_case_mg(n, *case[:3], dtype)
    sfx = mg_kernel.FLAVOURS[op][0]
    rng = np.random.default_rng(n)
    top, peeled = mg_kernel.split(mg, dtype)
    fine = mg.nlevels - 1
    rows = []
    ghosts = [0]

    def check(what, kernel, ref, got, scale=None):
        """|diff| <= tol max|ref|, or tol times the size of the terms a
        residual cancels (scale) for a residual; the top ghosts of a ZERO
        edge +0.0 by bits in both."""
        ghosts[0] += zero_top_ghosts(mg, f"{what} {n}^2 {name}", ref, got)
        err = float((ref - got).abs().max())
        if scale is None:
            scale = float(ref.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        rows.append((what, err, scale, ok))
        if kernel:
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not ok:
            raise AssertionError(f"multigrid kernel disagrees with its plain "
                                 f"version: {what} {n}^2 {name} {dtype}")

    for guess in (True, False):                  # the core
        g = mg.grids[top]
        v = frame(rng, g, dtype, 0.1) if guess else None
        f = frame(rng, g, dtype)
        ref = mg_kernel.core_plain(mg, top, v, f, True)
        got = mg_kernel.launch_core(mg, top, v, f, True)
        check(f"mg_core v {g.nx}^2", "mg_core" + sfx, ref[0], got[0])
        check(f"mg_core r {g.nx}^2", "mg_core" + sfx, ref[1], got[1],
              resid_scale(mg, top, ref[0], f))
    for lv in peeled:                            # every peeled level
        g, gc = mg.grids[lv], mg.grids[lv - 1]
        v, f = frame(rng, g, dtype, 0.1), frame(rng, g, dtype)
        for guess in ((v, None) if lv < fine else (v,)):
            ref = mg_kernel.down_plain(mg, lv, guess, f)
            got = mg_kernel.launch_down(mg, lv, guess, f)
            check(f"mg_down v {g.nx}^2", "mg_down" + sfx, ref[0], got[0])
            check(f"mg_down fc {g.nx}^2", "mg_down" + sfx, ref[1],
                  got[1], resid_scale(mg, lv, ref[0], f))
        vc = frame(rng, gc, dtype, 0.1)
        ref = mg_kernel.up_plain(mg, lv, v, f, vc, lv == fine)
        got = mg_kernel.launch_up(mg, lv, v, f, vc, lv == fine)
        check(f"mg_up v {g.nx}^2", "mg_up" + sfx, ref[0], got[0])
        if lv == fine:
            check(f"mg_up r {g.nx}^2", "mg_up" + sfx, ref[1], got[1],
                  resid_scale(mg, lv, ref[0], f))

    g = mg.soln_grid                             # one whole cycle
    v = frame(rng, g, dtype, 0.1)
    f = frame(rng, g, dtype, zero_mean=zero_mean)
    ref = mg_kernel.core_plain(mg, fine, v, f, True)
    got = mg_kernel.cycle(mg, v, f)
    check("cycle v", None, ref[0], got[0])
    check("cycle r", None, ref[1], got[1], resid_scale(mg, fine, ref[0], f))

    # one whole solve: the kernels' and, with the plain cycle, the plain
    # version's, from a zero guess
    solves = []
    for plain in (True, False):
        m = make_case_mg(n, *case[:3], dtype)
        m.init_zeros()
        m.init_RHS(f)
        saved = mg_kernel.cycle
        if plain:
            mg_kernel.cycle = lambda mm, vv, ff, f_h=None: \
                mg_kernel.core_plain(mm, mm.nlevels - 1, vv, ff, True)
        try:
            m.solve(rtol=1.e-11)
        finally:
            mg_kernel.cycle = saved
        solves.append(m)
    ref, got = solves
    check("solve v", None, ref.get_solution(), got.get_solution())
    if dtype == torch.float64 and got.num_cycles != ref.num_cycles:
        raise AssertionError(f"solve: {got.num_cycles} kernel cycles, "
                             f"{ref.num_cycles} plain")
    ghosts[0] += zero_top_ghosts(mg, f"solve {n}^2 {name}",
                                 ref.get_solution(), got.get_solution())
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r[1] / r[2])
    zero = (f"; top ghosts +0.0 by bits in {ghosts[0]} frames"
            if ghosts[0] else "")
    log(f"  ok  {n:5d}^2 {name:17s} {str(dtype)[6:]:8s} core top "
        f"{2 ** (top + 1)}^2, {len(peeled)} peeled; {len(rows)} checks, "
        f"worst {worst[0]}: {worst[1]:.3e} (tol {tol:g} x "
        f"{worst[2]:.3g}); solve cycles kernel "
        f"{got.num_cycles} plain {ref.num_cycles}, residual "
        f"{got.residual_error:.3e} / {ref.residual_error:.3e}{zero}")


def core_tops_compare(case, dtype, tol):
    """mg_core of one of MG_CASES at every top it holds (2^2 up to
    mg_kernel.CORE_MAX[dtype]) against core_plain, from a guess and from a
    zero guess: v to tol max|v|, the residual to tol times the terms it
    cancels."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    name, op, edges, _ = case
    mg = make_case_mg(mg_kernel.CORE_MAX[dtype], name, op, edges, dtype)
    rng = np.random.default_rng(11)
    worst, checks, ghosts = (0.0, 1.0, ""), 0, 0
    for top in range(mg.nlevels):
        g = mg.grids[top]
        for guess in (True, False):
            v = frame(rng, g, dtype, 0.1) if guess else None
            f = frame(rng, g, dtype)
            ref = mg_kernel.core_plain(mg, top, v, f, True)
            got = mg_kernel.launch_core(mg, top, v, f, True)
            ghosts += zero_top_ghosts(mg, f"mg_core {name} {g.nx}^2 top",
                                      ref[0], got[0], ref[1], got[1])
            for what, a, b, scale in (
                    ("v", ref[0], got[0], float(ref[0].abs().max())),
                    ("r", ref[1], got[1], resid_scale(mg, top, ref[0], f))):
                err = float((a - b).abs().max())
                checks += 1
                if not bool(torch.isfinite(b).all()) or err > tol * scale:
                    raise AssertionError(
                        f"mg_core {name} {g.nx}^2 top {str(dtype)[6:]}: "
                        f"{what} max|diff| {err:.3e} > {tol:g} x {scale:.3g}")
                if err / scale > worst[0] / worst[1]:
                    worst = (err, scale, f"{what} {g.nx}^2")
    torch.cuda.synchronize()
    zero = f"; top ghosts +0.0 by bits in {ghosts} frames" if ghosts else ""
    log(f"  ok  mg_core{mg_kernel.FLAVOURS[op][0]:8s} {name:17s} "
        f"{str(dtype)[6:]:8s} tops 2^2..{mg_kernel.CORE_MAX[dtype]}^2 "
        f"(warps per level {mg_kernel.core_schedule(mg.nlevels - 1)}): "
        f"{checks} checks, worst {worst[2]}: {worst[0]:.3e} (tol {tol:g} x "
        f"{worst[1]:.3g}){zero}")


def rounds_compare(kernel, case, dtype, tol, nsmooth):
    """mg_down or mg_up (`kernel`) of one of MG_CASES at every peeled level
    of 1024^2 with `nsmooth` sweeps against down_plain / up_plain: v with
    its ghosts to tol max|v|, the restricted residual (mg_down, from a
    guess on the finest level and from a zero guess below it, as the cycle
    calls it) and the finest level's residual (mg_up) to tol times the
    terms they cancel; the plan must split the finest level's sweeps into
    rounds."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    name, op, edges, _ = case
    mg = make_case_mg(1024, name, op, edges, dtype)
    mg.nsmooth = nsmooth
    rng = np.random.default_rng(13)
    fine = mg.nlevels - 1
    rows, ghosts = [], 0
    for lv in mg_kernel.split(mg, dtype)[1]:
        g, gc = mg.grids[lv], mg.grids[lv - 1]
        v, f = frame(rng, g, dtype, 0.1), frame(rng, g, dtype)
        plan = mg_kernel.tile_plan(g.nx, nsmooth, dtype, op)
        if kernel == "mg_down":
            guess = v if lv == fine else None
            ref = mg_kernel.down_plain(mg, lv, guess, f)
            got = mg_kernel.launch_down(mg, lv, guess, f)
            checks = [("v", ref[0], got[0], float(ref[0].abs().max())),
                      ("fc", ref[1], got[1], resid_scale(mg, lv, ref[0], f))]
            ghosts += zero_top_ghosts(mg, f"{kernel} {name} {g.nx}^2",
                                      ref[0], got[0], ref[1], got[1])
        else:
            vc = frame(rng, gc, dtype, 0.1)
            want_r = lv == fine
            ref = mg_kernel.up_plain(mg, lv, v, f, vc, want_r)
            got = mg_kernel.launch_up(mg, lv, v, f, vc, want_r)
            checks = [("v", ref[0], got[0], float(ref[0].abs().max()))]
            ghosts += zero_top_ghosts(mg, f"{kernel} {name} {g.nx}^2",
                                      ref[0], got[0])
            if want_r:
                checks.append(("r", ref[1], got[1],
                               resid_scale(mg, lv, ref[0], f)))
        for what, a, b, scale in checks:
            err = float((a - b).abs().max())
            if not bool(torch.isfinite(b).all()) or err > tol * scale:
                raise AssertionError(
                    f"{kernel} {name} {g.nx}^2 nsmooth {nsmooth} "
                    f"{str(dtype)[6:]}: {what} max|diff| {err:.3e} > "
                    f"{tol:g} x {scale:.3g}")
            rows.append(f"{g.nx}^2 {what} {err:.3e}")
        rows[-1] += f" ({plan.rounds} rounds of {plan.round_iters()})"
        if lv == fine and plan.rounds < 2:
            raise AssertionError(f"nsmooth {nsmooth} took one round")
    torch.cuda.synchronize()
    if ghosts:
        rows.append(f"top ghosts +0.0 by bits in {ghosts} frames")
    log(f"  ok  {kernel}{mg_kernel.FLAVOURS[op][0]:8s} {name:17s} "
        f"{str(dtype)[6:]:8s} nsmooth {nsmooth}: " + "; ".join(rows))


def mol_peak_memory(step, U, t, dt):
    """Peak device bytes one MOL stage increment allocates above what is
    allocated before it (its k alone in the fused designs)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k = step.launch(U, t, dt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  peak device memory of one {step.name} stage: {peak} B above the "
        f"{base} B allocated before it (k is {k.numel() * k.element_size()} "
        "B)")
    del k
    return peak


def mg_main_path(solver, problem, n, steps, solves_per_step=None,
                 inputs=None):
    """Pyro(solver) -> run_sim on CUDA float32 with the counts reset just
    before and read just after (and, if given, the multigrid solves a step
    checked; `inputs` are added to the run's); returns (pyro, launches by
    kernel, seconds)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **(inputs or {})})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, launches, stats = read_counts()
    no_mol_launches(solver)
    no_swe_launches(solver)
    no_lm_launches(solver)
    no_padded_launches(solver)
    no_sharded_launches(solver)

    peeled = len(mg_kernel.split(make_mg(n, "periodic", 0.0, -1.0,
                                         torch.float32), torch.float32)[1])
    cycles = stats["cycles"]
    expect = dict.fromkeys(launches, 0)
    expect.update({"mg_core": cycles, "mg_down": cycles * peeled,
                   "mg_up": cycles * peeled})
    if sim.n != steps or ctu != 0 or launches != expect or cycles == 0:
        raise AssertionError(
            f"{solver}: {sim.n} steps, launches {launches} (CTU {ctu}) for "
            f"{cycles} cycles, expected {expect}")
    if solves_per_step and stats["solves"] != solves_per_step * steps:
        raise AssertionError(f"{solver}: {stats['solves']} solves in {steps} "
                             f"steps, expected {solves_per_step} a step")
    data = sim.cc_data.data
    if not bool(torch.isfinite(data).all()):
        raise AssertionError(f"{solver}: the state is not finite")
    zps = n * n * steps / seconds
    log(f"  {solver} {problem} {n}x{n} f32: {steps} steps in {seconds:.3f} s,"
        f" {1e3 * seconds / steps:.3f} ms/step, {zps:.4e} zone-updates/s; "
        f"{stats['solves']} solves, {cycles} cycles "
        f"({cycles / stats['solves']:.2f} per solve); launches {launches}; "
        f"t = {sim.cc_data.t:.6g}, max|state| {float(data.abs().max()):.6g}")
    return p, launches, seconds


def burgers_path(n, steps):
    """Pyro("burgers") tophat -> run_sim on CUDA float32, the counts reset
    just before and read just after: Burgers has no TPU kernel, so its
    plain tensor step runs on the card and no kernel of the port is
    launched; returns the pyro."""
    import torch

    from pyro2_tpu_torch import Pyro

    p = Pyro("burgers")                 # default device: CUDA, float32
    p.initialize_problem("tophat", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, launches, stats = read_counts()
    no_mol_launches("burgers")
    no_swe_launches("burgers")
    no_lm_launches("burgers")
    no_padded_launches("burgers")
    no_sharded_launches("burgers")
    if sim.n != steps or ctu or any(launches.values()) or stats["solves"]:
        raise AssertionError(f"burgers: {sim.n} steps, CTU {ctu}, "
                             f"multigrid {launches}, {stats}")
    data = sim.cc_data.data
    if not bool(torch.isfinite(data).all()):
        raise AssertionError("burgers: the state is not finite")
    log(f"  burgers tophat {n}x{n} f32: {steps} steps in {seconds:.3f} s, "
        f"{1e3 * seconds / steps:.3f} ms/step, "
        f"{n * n * steps / seconds:.4e} zone-updates/s; no kernel launched; "
        f"t = {sim.cc_data.t:.6g}, max|state| {float(data.abs().max()):.6g}")
    return p


def record_cycles():
    """(list, undo): from now on each CellCenterMG2d solve appends its
    cycle count to the list, until undo() is called."""
    from pyro2_tpu_torch.multigrid import MG

    counts = []
    orig = MG.CellCenterMG2d.solve

    def solve(self, rtol=1.e-11):
        orig(self, rtol)
        counts.append(self.num_cycles)

    MG.CellCenterMG2d.solve = solve

    def undo():
        MG.CellCenterMG2d.solve = orig

    return counts, undo


def cavity_card_vs_cpu(n, steps, tol):
    """incompressible_viscous cavity n^2, float64, `steps` steps through
    Pyro on the card (the kernels' ZERO edge in every C-N solve) and on
    the CPU (the plain cycle and MG._fill_v): equal cycle counts in every
    solve, and after each step u and v within tol max|U| of the CPU run's;
    returns the largest |diff| / max|U| over the steps."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel

    runs = {}
    for device in ("cpu", "cuda"):
        p = Pyro("incompressible_viscous", device=device,
                 dtype=torch.float64)
        counts, undo = record_cycles()
        try:
            p.initialize_problem("cavity", inputs_dict={
                "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
                "driver.tmax": 1.0e30})
            before = dict(mg_kernel.launches)
            states = []
            for _ in range(steps):
                p.single_step()
                states.append(p.sim.cc_data.data[:2].cpu().clone())
        finally:
            undo()
        launched = {k: mg_kernel.launches[k] - before[k] for k in MG_KERNELS}
        runs[device] = (counts, states, launched)
    (c_cpu, s_cpu, l_cpu), (c_gpu, s_gpu, l_gpu) = runs["cpu"], runs["cuda"]
    if c_cpu != c_gpu:
        raise AssertionError(f"cavity {n}^2 f64: cycles per solve on the "
                             f"card {c_gpu}, on the CPU {c_cpu}")
    if any(l_cpu.values()) or not all(l_gpu.values()):
        raise AssertionError(f"cavity {n}^2 f64: launches card {l_gpu}, "
                             f"CPU {l_cpu}")
    worst = 0.0
    for k, (a, b) in enumerate(zip(s_cpu, s_gpu)):
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        if not bool(torch.isfinite(b).all()) or err > tol * scale:
            raise AssertionError(f"cavity {n}^2 f64 step {k + 1}: u, v "
                                 f"max|diff| {err:.3e} > {tol:g} x "
                                 f"{scale:.3g}")
    log(f"  ok  cavity {n}^2 f64, {steps} steps, card against CPU: cycles "
        f"per solve {c_gpu} (equal); u, v worst max|diff| / max|U| "
        f"{worst:.3e} (tol {tol:g}); card launches {l_gpu}")
    return worst


# ---------------------------------------------------------------------------
# phase 5e: the advection solvers, the regression driver and checkpoints
# ---------------------------------------------------------------------------

# the advection paths at 1024^2: (solver, problem, steps); the two CTU-type
# solvers take 100 steps, the three RK4 ones 20
ADVECTION_PATHS = (("advection", "smooth", 100),
                   ("advection_nonuniform", "slotted", 100),
                   ("advection_rk", "smooth", 20),
                   ("advection_fv4", "smooth", 20),
                   ("advection_weno", "smooth", 20))

# the kernels each regression run must launch (and the ones it may):
# every kernel of the port covers the driver's f64 grids, so a run that
# launched none where one is expected has routed around it
_MG_CONST = {"mg_core", "mg_down", "mg_up"}
REGRESSION_KERNELS = {
    "advection": (set(), set()),
    "advection_nonuniform": (set(), set()),
    "advection_rk": (set(), set()),
    "advection_fv4": (set(), set()),
    "burgers": (set(), set()),
    "compressible": ({"ctu_step"}, {"ctu_step"}),
    "compressible_rk": ({"mol_rk"}, {"mol_rk"}),
    "compressible_fv4": ({"mol_fv4"}, {"mol_fv4"}),
    "compressible_sdc": ({"mol_fv4"}, {"mol_fv4"}),
    # gaussian is 128^2: the f64 core holds 64^2, one level is peeled
    "diffusion": (_MG_CONST, _MG_CONST),
    "incompressible": ({"mg_core"}, _MG_CONST),
    "incompressible_viscous": ({"mg_core"}, _MG_CONST),
    "lm_atm": ({"lm_mac", "lm_rho", "lm_states", "mg_core_vc"},
               {"lm_mac", "lm_rho", "lm_states", "mg_core_vc", "mg_down_vc",
                "mg_up_vc"}),
    "swe": ({"swe_step"}, {"swe_step"}),
}


def all_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel, padded_step
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    counts = {"ctu_step": ctu_kernel.launches,
              "swe_step": swe_kernel.launches}
    for table in (mg_kernel.launches, mol_kernel.launches,
                  lm_kernel.launches, padded_step.launches,
                  sharded_mg_kernel.launches):
        counts.update(table)
    return counts


def advection_path(solver, problem, n, steps):
    """Pyro(solver) -> run_sim on CUDA float32 at n^2, the counts reset
    just before and read just after: the advection solvers have no TPU
    kernel, so their plain tensor steps run on the card and no kernel of
    the port is launched; returns the pyro."""
    import torch

    from pyro2_tpu_torch import Pyro

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_counts().items() if v}
    if sim.n != steps or launched:
        raise AssertionError(f"{solver} {problem}: {sim.n} steps, "
                             f"launches {launched}")
    dens = sim.cc_data.get_var("density")
    if not bool(torch.isfinite(sim.cc_data.data).all()):
        raise AssertionError(f"{solver} {problem}: the state is not finite")
    log(f"  {solver} {problem} {n}x{n} f32: {steps} steps in "
        f"{seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, "
        f"{n * n * steps / seconds:.4e} zone-updates/s; no kernel launched; "
        f"t = {sim.cc_data.t:.6g}, density in "
        f"[{float(dens.min()):.6g}, {float(dens.max()):.6g}]")
    return p


def advection_card_vs_cpu(solver, problem, n, steps, tol):
    """`solver` on `problem` at n^2 in float64 through Pyro on the card and
    on the CPU: after each step the state within tol max|a| of the CPU
    run's, and equal dt; returns the largest |diff| / max|a|."""
    import torch

    from pyro2_tpu_torch import Pyro

    pyros = []
    for device in ("cpu", "cuda"):
        p = Pyro(solver, device=device, dtype=torch.float64)
        p.initialize_problem(problem, inputs_dict={
            "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
            "driver.tmax": 1.0e30})
        pyros.append(p)
    cpu, card = pyros
    worst = 0.0
    for k in range(steps):
        cpu.single_step()
        card.single_step()
        a = cpu.sim.cc_data.data
        b = card.sim.cc_data.data.cpu()
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        if (not bool(torch.isfinite(b).all()) or err > tol * scale or
                abs(card.sim.dt - cpu.sim.dt) > tol * cpu.sim.dt):
            raise AssertionError(
                f"{solver} {problem} {n}^2 f64 step {k + 1}: max|diff| "
                f"{err:.3e} > {tol:g} x {scale:.3g}, or dt {card.sim.dt!r} "
                f"against {cpu.sim.dt!r}")
    log(f"  ok  {solver} {problem} {n}^2 f64, {steps} steps, card against "
        f"CPU: worst max|diff| / max|a| {worst:.3e} (tol {tol:g})")
    return worst


def regression_on_card(rtol):
    """The regression driver's 16 runs (pyro2_tpu_torch/test.py), each
    through driver.run_test -> PyroBenchmark on the card in float64
    against the port's golden copy, the counts reset just before and read
    just after: compare must return 0 at rtol, and the run must launch the
    kernels REGRESSION_KERNELS names.  Returns {run: seconds}."""
    import contextlib
    import io

    import torch

    from pyro2_tpu_torch import test as driver
    from pyro2_tpu_torch.util import compare

    seen = []
    orig = compare.compare

    def recording(data1, data2, rtol=1.e-12):
        seen.append((data1, data2))
        return orig(data1, data2, rtol)

    compare.compare = recording
    seconds = {}
    failed = []
    try:
        for t in driver.get_test_list():
            seen.clear()
            out = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                name, err = driver.run_test(t, False, False, rtol,
                                            device="cuda")
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launched = {k: v for k, v in all_counts().items() if v}
            required, allowed = REGRESSION_KERNELS[t.solver]
            run, bench = seen[0]
            assert run.data.is_cuda and bench.data.is_cuda
            assert run.dtype == bench.dtype == torch.float64
            g = run.grid
            valid = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
            abs_err = rel_err = 0.0
            for var in run.names:
                d1 = run.get_var(var)[valid]
                d2 = bench.get_var(var)[valid]
                diff = (d1 - d2).abs()
                abs_err = max(abs_err, float(diff.max()))
                nz = d2 != 0
                if bool(nz.any()):
                    rel_err = max(rel_err,
                                  float((diff[nz] / d2[nz].abs()).max()))
            ok = (err == 0 and required <= set(launched) and
                  set(launched) <= allowed)
            log(f"  {'ok ' if ok else 'BAD'} {name:34s} {seconds[name]:7.3f} "
                f"s; max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                f"(nonzero golden zones); compare {err!r}; launches "
                f"{launched}")
            if not ok:
                log(out.getvalue())
                failed.append(name)
    finally:
        compare.compare = orig
    if failed:
        raise AssertionError(f"regression runs failed on the card: {failed}")
    return seconds


def checkpoint_on_card(quad):
    """write -> io_pyro.read on the card: the quad 1024^2 float32 state of
    the main path and a cavity 64^2 float64 state, read back with
    device="cuda" equal by bits, their dtype and device kept; the read
    cavity's top edge maps to the kernels' ZERO kind."""
    import torch

    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.solvers.incompressible_viscous import BC
    from pyro2_tpu_torch.util import io_pyro

    cavity = Pyro("incompressible_viscous", dtype=torch.float64)
    cavity.initialize_problem("cavity", inputs_dict={
        "mesh.nx": 64, "mesh.ny": 64, "driver.max_steps": 3})
    cavity.run_sim()
    out = os.path.join(HERE, "test_outputs", "chip_smoke_checkpoints")
    os.makedirs(out, exist_ok=True)
    try:
        for label, sim in (("quad 1024^2 f32", quad.sim),
                           ("cavity 64^2 f64", cavity.sim)):
            fn = os.path.join(out, label.split()[0])
            t0 = time.perf_counter()
            sim.write(fn)
            t1 = time.perf_counter()
            back = io_pyro.read(fn, device="cuda", dtype=sim.dtype)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            d, r = sim.cc_data, back.cc_data
            g = d.grid
            valid = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
            assert r.data.is_cuda and r.dtype == d.dtype == sim.dtype
            assert back.n == sim.n and r.t == d.t and r.grid == g
            assert sorted(r.names) == sorted(d.names)
            for var in d.names:
                if not torch.equal(r.get_var(var)[valid],
                                   d.get_var(var)[valid]):
                    raise AssertionError(f"{label}: {var} read back differs")
            log(f"  ok  {label} write -> read on the card: equal by bits, "
                f"{r.dtype} on {r.data.device}; write {t1 - t0:.3f} s, "
                f"read {t2 - t1:.3f} s, "
                f"{os.path.getsize(fn + '.h5')} B")
        kinds = mg_kernel.edge_kinds(back.cc_data.BCs["x-velocity"])
        if kinds[3] != mg_kernel.ZERO or \
                bnd.ext_bcs["moving_lid"] is not BC.user:
            raise AssertionError(f"read cavity: edge kinds {kinds}")
        log(f"  ok  the read cavity's edge kinds {kinds}: yrb is ZERO")
    finally:
        for name in os.listdir(out):
            os.remove(os.path.join(out, name))
        os.rmdir(out)


# ---------------------------------------------------------------------------
# phase 5g: tracer particles, and the on-device chunked loop
# (driver_loop.run_sim_fast, one CUDA graph a chunk) over k_ctu's device-dt
# entry
# ---------------------------------------------------------------------------

# k_ctu's device-dt entry against its host-dt entry (bits) and the plain
# step: (name, problem, inputs) at 1024^2; the quad main path's, a problem
# source's and the spherical instantiation's
DEVDT_CONFIGS = (("quad", "quad", {}), ("heating", "heating", {}),
                 ("sph_advect_cgf", "advect", SPH_ADVECT))
# k_swe's device-dt entry the same way: (name, problem, inputs) at 1024^2
SWE_DEVDT_CONFIGS = (("swe_quad", "quad", {}),)
# the on-device loop's step kernel by solver: its wrapper's count and its
# device kernel, one launch a body (advection's step launches none)
LOOP_KERNELS = {"compressible": ("ctu_step", "k_ctu"),
                "swe": ("swe_step", "k_swe")}
# grid particles, 1024^2 of them, on kh at 1024^2
PARTICLES_GRID = {"particles.do_particles": 1,
                  "particles.particle_generator": "grid"}


def devdt_check(name, sim, tol):
    """k_ctu's (or k_swe's) device-dt entry on a live simulation, one
    step from the
    same state after 3 kernel steps: its output equal by bits to the
    host-dt entry's with the same dt (the dt rounded to the state's dtype,
    as the on-device loop carries it), and within tol max|U| of the plain
    step, every ghost the input's; returns max |diff|."""
    import torch

    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t = sim.cc_data.data, sim.cc_data.t
    dt_dev = torch.tensor(sim.dt, dtype=U.dtype, device=U.device)
    dt = float(dt_dev)
    host = sim._step.launch(U, t, dt)
    dev = sim._step.launch(U, t, dt_dev)
    ref = sim._step.plain(U, t, dt)
    torch.cuda.synchronize()
    bits = torch.equal(host, dev)
    g = sim.cc_data.grid
    a, b = interior(ref, g), interior(dev, g)
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    ghost = torch.ones(U.shape[1:], dtype=torch.bool, device=U.device)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    ghosts = torch.equal(dev[:, ghost], U[:, ghost])
    ok = bits and bool(torch.isfinite(b).all()) and err <= tol * scale \
        and ghosts
    log(f"  {'ok ' if ok else 'BAD'} {name:16s} {g.nx}x{g.ny} "
        f"{str(U.dtype)[6:]:8s} device dt: host-dt entry's bits {bits}; "
        f"max|diff| to the plain step {err:.3e} (tol {tol:g} x max|U| = "
        f"{tol * scale:.3e}), ghosts kept: {ghosts}")
    if not ok:
        raise AssertionError(f"the device-dt entry disagrees: {name}")
    return err


def particles_path(problem, n, steps, inputs):
    """Pyro("compressible") -> run_sim on CUDA float32 at n^2 for `steps`
    steps after one untimed warm-up step, the counts reset just before and
    read just after: one CTU launch a step and no other kernel; returns
    (pyro, seconds, CTU launches)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    p = Pyro("compressible")            # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps + 1,
        "driver.tmax": 1.0e30, **inputs})
    p.single_step()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_counts().items() if v}
    if launched != {"ctu_step": steps} or p.sim.n != steps + 1:
        raise AssertionError(f"{problem} {n}^2: {p.sim.n} steps, launches "
                             f"{launched}; expected ctu_step {steps}")
    return p, seconds, ctu_kernel.launches


def check_particles(what, parts, myg, n_expected):
    """The particles' positions finite and inside the domain (or inactive),
    and moved; returns the number active."""
    import torch

    pos, act = parts.positions, parts.active
    inside = ((pos[:, 0] >= myg.xmin) & (pos[:, 0] <= myg.xmax) &
              (pos[:, 1] >= myg.ymin) & (pos[:, 1] <= myg.ymax))
    moved = float((pos - parts.init_positions).abs().max())
    n_active = int(act.sum())
    if (pos.shape != (n_expected, 2) or not bool(torch.isfinite(pos).all())
            or not bool((inside | ~act).all()) or moved <= 0.0):
        raise AssertionError(f"{what}: particles {tuple(pos.shape)}, finite "
                             f"{bool(torch.isfinite(pos).all())}, moved "
                             f"{moved}")
    return n_active, moved


def kernels_a_step(fn, steps):
    """(device kernels a step, device-busy us a step, wall us a step) of
    `steps` calls of fn under the profiler, or None if it recorded no
    device kernel."""
    rows, wall_us = profiled(fn, steps)
    if not rows:
        return None
    return (sum(c for _, c, _ in rows) / steps,
            sum(us for *_, us in rows) / steps, wall_us / steps)


def particles_on_card():
    """kh 1024^2 f32 with and without 1024^2 grid particles (50 steps
    each): ms/step and the CTU launches; returns ({"without", "with":
    pyro}, the CTU launches of both runs)."""
    n, steps = 1024, 50
    runs = {}
    for label, inputs in (("without", {}),
                          ("with", {**PARTICLES_GRID,
                                    "particles.n_particles": n * n})):
        p, seconds, launches = particles_path("kh", n, steps, inputs)
        runs[label] = (p, seconds, launches)
        note = ""
        if label == "with":
            active, moved = check_particles("kh 1024^2", p.sim.particles,
                                            p.sim.cc_data.grid, n * n)
            note = (f", {n * n} particles, {active} active, moved up to "
                    f"{moved:.4g}")
        log(f"  kh {n}x{n} f32 {label} particles: {steps} steps (after 1) "
            f"in {seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, "
            f"ctu_step launches {launches}{note}")
    return ({label: p for label, (p, _, _) in runs.items()},
            sum(launches for _, _, launches in runs.values()))


def particles_profile(pyros, smi):
    """The device kernels a kh step launches with and without particles
    under the profiler (10 steps each), and the extra ones a step."""
    prof = {label: kernels_a_step(p.single_step, 10)
            for label, p in pyros.items()}
    if not all(prof.values()):
        log("  device kernels a step: not measured (the profiler recorded "
            "no device kernel)")
        return
    (k0, b0, w0), (k1, b1, w1) = prof["without"], prof["with"]
    log(f"  kh 1024^2 f32, 10 steps each: {k0:.1f} device kernels a step "
        f"without particles, {k1:.1f} with, {k1 - k0:.1f} extra a step (the "
        f"advance: gathers, midpoint, edges); device busy {b0:.1f} / "
        f"{b1:.1f} us/step ({100 - 100 * b0 / w0:.1f}% / "
        f"{100 - 100 * b1 / w1:.1f}% idle); {smi}")


# the particle runs in float64 on the card against the CPU: (solver,
# problem), one a kernel row the particles now ride on (rows 1, 5, 6a, 6b
# and the constant multigrid's 8-12)
PARTICLE_RUNS = (("compressible", "kh"), ("swe", "quad"),
                 ("compressible_rk", "quad"),
                 ("compressible_fv4", "acoustic_pulse"),
                 ("incompressible", "shear"))


def particles_card_vs_cpu(solver, problem, n, steps, tol):
    """`solver` on `problem` with 4096 random particles (one numpy seed)
    in float64 on the card and on the CPU for `steps` steps: after each
    step the positions within tol of the domain's width, `active` equal;
    returns the worst |diff|."""
    import numpy as np
    import torch

    from pyro2_tpu_torch import Pyro

    pyros = []
    for device in ("cpu", "cuda"):
        np.random.seed(16)
        p = Pyro(solver, device=device, dtype=torch.float64)
        p.initialize_problem(problem, inputs_dict={
            "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
            "driver.tmax": 1.0e30, "particles.do_particles": 1,
            "particles.particle_generator": "random",
            "particles.n_particles": 4096})
        pyros.append(p)
    cpu, card = pyros
    g = card.sim.cc_data.grid
    width = max(g.xmax - g.xmin, g.ymax - g.ymin)
    worst = 0.0
    for k in range(steps):
        cpu.single_step()
        card.single_step()
        a, b = cpu.sim.particles, card.sim.particles
        err = float((a.positions - b.positions.cpu()).abs().max())
        same = torch.equal(a.active, b.active.cpu())
        worst = max(worst, err)
        if err > tol * width or not same:
            raise AssertionError(f"{solver} {problem} particles f64 step "
                                 f"{k + 1}: max|diff| {err:.3e}, active "
                                 f"equal {same}")
    log(f"  ok  {solver} {problem} {n}x{n} f64, 4096 random particles, "
        f"{steps} steps, card against CPU: worst max|diff| {worst:.3e} (tol "
        f"{tol:g} x "
        f"{width:g}), active equal ({int(card.sim.particles.active.sum())} "
        "active)")
    return worst


def restorer(sim):
    """A function that puts sim back at its state now: data, t = 0,
    n = 0, and its particles'."""
    U0 = sim.cc_data.data.clone()
    parts = sim.particles
    P0 = None if parts is None else (parts.positions.clone(),
                                     parts.active.clone())

    def restore():
        sim.cc_data.data = U0.clone()
        sim.cc_data.t = 0.0
        sim.n = 0
        sim.dt_old = -1.e33
        sim.n_num_out = 0
        if P0 is not None:
            parts.positions, parts.active = P0[0].clone(), P0[1].clone()
    return restore


def fast_vs_host(solver, problem, n, steps, dtype, tol, inputs=None,
                 chunk=64, ny=None, f32_norm="max"):
    """run_sim_fast(chunk_steps=chunk) against run_sim on `problem` at n^2
    (n x ny with ny) for `steps` steps, output every steps / 2 (and by no
    dt_out: an f32 t crosses a dt_out multiple a step apart from the host
    loop's double) into a temporary directory:
    the same n and output steps; the states (and particles) equal by bits
    in float64 (the run stops at max_steps, so the tmax clamp never acts),
    within tol of the scale in float32, the files' states too; returns
    max |diff| / scale.  With f32_norm="mean" the float32 states are held
    by their mean |diff| over the mean |U| instead (both are logged, and
    the count of values beyond 1e-5 of the scale): where a shock is strong
    (the ramp's Mach 10) or a fill is a step function of t (the ramp's top
    ghosts: a quadrature point on one side of the front or the other), the
    two loops' float32 rounding of dt and t moves the cells a shock or
    front crosses by far more than the rounding, and the mean by little
    (PERF.md)."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.driver_loop import run_sim_fast
    from pyro2_tpu_torch.util import io_pyro

    cwd = os.getcwd()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for fast in (False, True):
            d = os.path.join(tmp, "fast" if fast else "host")
            os.mkdir(d)
            os.chdir(d)
            try:
                np.random.seed(16)
                p = Pyro(solver, dtype=dtype)
                p.initialize_problem(problem, inputs_dict={
                    "mesh.nx": n, "mesh.ny": ny or n,
                    "driver.max_steps": steps,
                    "driver.tmax": 1.0e30, "io.n_out": steps // 2,
                    "io.dt_out": 1.0e30, "io.basename": "fast_",
                    **(inputs or {})})
                p.rp.set_param("io.do_io", 1)
                if fast:
                    run_sim_fast(p, chunk_steps=chunk)
                else:
                    p.run_sim()
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)
            files = sorted(os.path.basename(f)
                           for f in glob.glob(os.path.join(d, "*.h5")))
            states = [io_pyro.read(os.path.join(d, f), dtype=dtype)
                      .cc_data.data for f in files]
            runs.append((p, files, states))
    (ph, fh, sh), (pf, ff, sf) = runs
    g = ph.sim.cc_data.grid
    scale = float(interior(ph.sim.cc_data.data, g).abs().max())
    err = max(float((a - b).abs().max()) for a, b in
              zip(sh + [ph.sim.cc_data.data], sf + [pf.sim.cc_data.data]))
    bits = all(torch.equal(a, b) for a, b in
               zip(sh + [ph.sim.cc_data.data], sf + [pf.sim.cc_data.data]))
    mean = max(float((interior(a, g) - interior(b, g)).abs().mean() /
                     interior(a, g).abs().mean()) for a, b in
               zip(sh + [ph.sim.cc_data.data], sf + [pf.sim.cc_data.data]))
    parts = ""
    if ph.sim.particles is not None:
        a, b = ph.sim.particles, pf.sim.particles
        perr = float((a.positions - b.positions).abs().max())
        same = torch.equal(a.active, b.active)
        bits = bits and perr == 0.0
        parts = f", particles max|diff| {perr:.3e}, active equal {same}"
        if not same or perr > tol * (g.xmax - g.xmin):
            raise AssertionError(f"{problem}: the fast loop's particles "
                                 f"differ ({perr:.3e}, active {same})")
    f64 = dtype == torch.float64
    close = mean <= tol if f32_norm == "mean" else err <= tol * scale
    beyond = sum(int(((a - b).abs() > 1e-5 * scale).sum()) for a, b in
                 zip(sh + [ph.sim.cc_data.data], sf + [pf.sim.cc_data.data]))
    ok = (ph.sim.n == pf.sim.n == steps and fh == ff and len(fh) >= 3 and
          (bits if f64 else close))
    log(f"  {'ok ' if ok else 'BAD'} {solver} {problem} {n}x{ny or n} "
        f"{str(dtype)[6:]}: fast loop (chunk {chunk}) against the host loop,"
        f" n {pf.sim.n} / {ph.sim.n}, output steps {ff} / {fh}, bits "
        f"{bits}, max|diff| {err:.3e} (scale {scale:.4g}), mean|diff| / "
        f"mean|U| {mean:.3e} (held by the {f32_norm if not f64 else 'bits'}"
        f"), {beyond} values beyond 1e-5 x scale{parts}")
    if not ok:
        raise AssertionError(f"{problem}: the fast loop differs")
    return err / scale


def fast_loop_timing(solver, problem, n, steps, dtype, smi, inputs=None,
                     chunk=64, ny=None):
    """Host-clock ms/step of run_sim and of run_sim_fast on `problem` at
    n^2 (n x ny with ny; steps steps, no output, each after a first run:
    the kernels' loads, the graph's capture), the capture run's seconds,
    the replays
    and the frozen tail; the wrappers' counts over the capturing run
    (reset just before, read just after): one warm-up body and the
    chunk's bodies launch the solver's step kernel (LOOP_KERNELS: ctu_step
    or swe_step), and nothing else launches.  The returned function
    (section 7 calls it) profiles one whole run of each loop: device-busy
    us/step and idle share, and for the on-device loop the launches of the
    step kernel's device-dt entry as the profiler counts them, which must
    be the profiled run's replays times the chunk's bodies (none of a
    host-dt entry); it returns that count.  Returns (host ms, fast ms,
    replays, frozen) and the profiling function."""
    import re

    import numpy as np
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.driver_loop import make_chunk_runner, run_sim_fast

    entry, kern = LOOP_KERNELS.get(solver, (None, None))
    per_body = 1 if entry else 0
    what = f"{solver} {problem} {n}x{ny or n} {str(dtype)[6:]}"

    def fresh():
        np.random.seed(16)
        p = Pyro(solver, dtype=dtype)
        p.initialize_problem(problem, inputs_dict={
            "mesh.nx": n, "mesh.ny": ny or n, "driver.max_steps": steps,
            "driver.tmax": 1.0e30, **(inputs or {})})
        return p

    def host_run():
        host.run_sim()

    def fast_run():
        run_sim_fast(fast, chunk_steps=chunk)

    host, fast = fresh(), fresh()
    restore = {"host": restorer(host.sim), "fast": restorer(fast.sim)}
    seconds = {}
    for label, run in (("host", host_run), ("fast", fast_run)):
        for k in range(2):
            restore[label]()
            torch.cuda.synchronize()
            if k == 0 and label == "fast":
                reset_counts()
            if k == 1 and label == "fast":
                runner = make_chunk_runner(fast.sim, chunk)
                replays0 = runner.replays
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds[label, k] = time.perf_counter() - t0
            if k == 0 and label == "fast":
                captured = {k: v for k, v in all_counts().items() if v}
    replays = runner.replays - replays0
    frozen = replays * chunk - fast.sim.n
    expect = {entry: chunk + 1} if per_body else {}
    if fast.sim.n != steps or captured != expect:
        raise AssertionError(f"{problem} fast loop: {fast.sim.n} steps, "
                             f"the capturing run's wrapper counts "
                             f"{captured}, expected {expect}")
    host_ms = 1e3 * seconds["host", 1] / steps
    fast_ms = 1e3 * seconds["fast", 1] / steps
    log(f"  {what}: host loop "
        f"{host_ms:.4f} ms/step; fast loop {fast_ms:.4f} ms/step ({steps} "
        f"steps, {replays} replays of a {chunk}-body graph, {frozen} frozen "
        f"bodies in the tail); the first runs {seconds['host', 0]:.3f} s, "
        f"{seconds['fast', 0]:.3f} s (the capture); wrapper counts over "
        f"the capturing run {captured}")

    def profile():
        last = {}

        def fast_once():
            restore["fast"]()
            before = runner.replays
            fast_run()
            last["replays"] = runner.replays - before

        devdt = None
        for loop, fn in (("host", lambda: (restore["host"](), host_run())),
                         ("fast", fast_once)):
            rows, wall = profiled(fn, 1)
            if not rows:
                log(f"  {loop} loop: device time not measured (the "
                    "profiler recorded no device kernel)")
                continue
            busy = sum(us for *_, us in rows)
            log(f"  {what}, {loop} "
                f"loop, one run of {steps} steps: device busy "
                f"{busy / steps:.1f} us/step, "
                f"{100 - 100 * busy / wall:.1f}% idle, "
                f"{sum(c for _, c, _ in rows) / steps:.1f} device kernels "
                f"a step; {smi}")
            if loop == "fast":
                steps_k = {}
                for key, count, _ in rows:
                    m = re.search(r"(k_ctu|k_swe)<([^<>]*)>", key)
                    if m:
                        k = kernel_name(m.group(1), m.group(2).split(", "))
                        steps_k[k] = steps_k.get(k, 0) + count
                devdt = sum(c for k, c in steps_k.items() if kern and
                            k.startswith(kern) and "device dt" in k)
                want = last["replays"] * chunk * per_body
                log(f"  the on-device run's step-kernel launches "
                    f"(profiler): {steps_k}; {last['replays']} replays x "
                    f"{chunk} bodies x {per_body} = {want}")
                if devdt != want or sum(steps_k.values()) != devdt:
                    raise AssertionError(
                        f"{problem} fast loop: step-kernel launches "
                        f"{steps_k}, expected {want} of the {kern} "
                        "device-dt entry alone")
        if devdt is None:
            raise AssertionError(f"{problem} fast loop: the profiler "
                                 "recorded no device kernel; the device-dt "
                                 "launches are not measured")
        return devdt

    return (host_ms, fast_ms, replays, frozen), profile


# ---------------------------------------------------------------------------
# phase 5h: inhomogeneous multigrid BC values (the kernels take them lifted
# into the finest level's right-hand side), the regression driver's
# analytic solves, and double-f32 iterative refinement
# ---------------------------------------------------------------------------

# the lifted configurations: mg_test_general_inhomogeneous's operator and
# Dirichlet values, and a constant Helmholtz operator with Neumann values
# on all four edges (both signs of the -/+ dx value offset)
LIFTED_CASES = ("general_inhomogeneous", "neumann_values")


def make_lifted_mg(n, name, dtype, device="cuda"):
    """An n^2 MG of one of LIFTED_CASES."""
    import numpy as np

    from pyro2_tpu_torch.mesh.grid import Grid2d
    from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    if name == "general_inhomogeneous":
        g = Grid2d(n, n, ng=1)
        x, y = g.x2d, g.y2d
        return GeneralMG2d(
            n, n, xl_BC_type="dirichlet", xr_BC_type="dirichlet",
            yl_BC_type="dirichlet", yr_BC_type="dirichlet",
            xl_BC=lambda y: np.cos(np.pi * y / 2.0),
            yl_BC=lambda x: np.cos(np.pi * x / 2.0),
            coeffs=general_coeffs(g, 10.0 + 0 * x, x * y + 1.0, 1.0 + 0 * x,
                                  1.0 + 0 * y, dtype),
            device=device, dtype=dtype)
    return CellCenterMG2d(
        n, n, xl_BC_type="neumann", xr_BC_type="neumann",
        yl_BC_type="neumann", yr_BC_type="neumann",
        xl_BC=lambda y: np.cos(np.pi * y), xr_BC=lambda y: 1.0 + y,
        yl_BC=lambda x: x ** 2, yr_BC=lambda x: -np.sin(3.0 * x),
        alpha=1.0, beta=(1.0 / n) ** 2, device=device, dtype=dtype)


def lifted_compare(n, name, dtype, tol, errs):
    """Each multigrid kernel of one of LIFTED_CASES at every peeled level
    (or the core, when it holds the finest level), one whole cycle and one
    whole solve against their plain versions from the same inputs.  On the
    finest level the kernel takes the lifted right-hand side
    (mg_kernel.lifted_rhs) and the plain version f with the values filled
    in the cycle: their interiors and residuals are compared (the
    kernel's ghosts are the homogeneous fill); the whole cycle's output,
    ghosts included, after cycle's refill.  Records the worst |diff| of
    each kernel in errs[kernel]."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.mesh.indexer import ai
    from pyro2_tpu_torch.multigrid import mg_kernel

    mg = make_lifted_mg(n, name, dtype)
    op = mg_kernel.check(mg)
    sfx = mg_kernel.FLAVOURS[op][0]
    rng = np.random.default_rng(n + 17)
    top, peeled = mg_kernel.split(mg, dtype)
    fine = mg.nlevels - 1
    rows = []

    def check(what, kernel, level, ref, got, scale=None):
        """|diff| <= tol max|ref| (tol times the terms a residual cancels
        for one); on the finest level, the interiors alone."""
        if level == fine and kernel:
            g = mg.grids[level]
            ref, got = ai(ref, g).v(), ai(got, g).v()
        err = float((ref - got).abs().max())
        if scale is None:
            scale = float(ref.abs().max())
        rows.append((what, err, scale))
        if kernel:
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not bool(torch.isfinite(got).all()) or err > tol * scale:
            raise AssertionError(f"lifted {name} {n}^2 {dtype}: {what} "
                                 f"max|diff| {err:.3e} > {tol:g} x "
                                 f"{scale:.3g}")

    g = mg.grids[top]                            # the core
    for guess in (True, False):
        v = frame(rng, g, dtype, 0.1) if guess else None
        f = frame(rng, g, dtype)
        f_k = mg_kernel.lifted_rhs(mg, f) if top == fine else f
        ref = mg_kernel.core_plain(mg, top, v, f, True)
        got = mg_kernel.launch_core(mg, top, v, f_k, True)
        check(f"mg_core v {g.nx}^2", "mg_core" + sfx, top, ref[0], got[0])
        check(f"mg_core r {g.nx}^2", "mg_core" + sfx, top, ref[1], got[1],
              resid_scale(mg, top, ref[0], f_k))
    for lv in peeled:                            # every peeled level
        g, gc = mg.grids[lv], mg.grids[lv - 1]
        v, f = frame(rng, g, dtype, 0.1), frame(rng, g, dtype)
        f_k = mg_kernel.lifted_rhs(mg, f) if lv == fine else f
        for guess in ((v, None) if lv < fine else (v,)):
            ref = mg_kernel.down_plain(mg, lv, guess, f)
            got = mg_kernel.launch_down(mg, lv, guess, f_k)
            check(f"mg_down v {g.nx}^2", "mg_down" + sfx, lv, ref[0], got[0])
            check(f"mg_down fc {g.nx}^2", "mg_down" + sfx, lv - 1, ref[1],
                  got[1], resid_scale(mg, lv, ref[0], f_k))
        vc = frame(rng, gc, dtype, 0.1)
        ref = mg_kernel.up_plain(mg, lv, v, f, vc, lv == fine)
        got = mg_kernel.launch_up(mg, lv, v, f_k, vc, lv == fine)
        check(f"mg_up v {g.nx}^2", "mg_up" + sfx, lv, ref[0], got[0])
        if lv == fine:
            check(f"mg_up r {g.nx}^2", "mg_up" + sfx, lv, ref[1], got[1],
                  resid_scale(mg, lv, ref[0], f_k))

    g = mg.soln_grid                             # one whole cycle
    v = frame(rng, g, dtype, 0.1)
    f = frame(rng, g, dtype)
    scale = resid_scale(mg, fine, v, mg_kernel.lifted_rhs(mg, f))
    ref = mg_kernel.core_plain(mg, fine, v, f, True)
    got = mg_kernel.cycle(mg, v, f)
    check("cycle v (ghosts refilled)", None, fine, ref[0], got[0])
    check("cycle r", None, fine, ref[1], got[1], scale)

    solves = []                                  # one whole solve
    for plain in (True, False):
        m = make_lifted_mg(n, name, dtype)
        m.init_zeros()
        m.init_RHS(f)
        saved = mg_kernel.cycle
        if plain:
            mg_kernel.cycle = lambda mm, vv, ff, f_h=None: \
                mg_kernel.core_plain(mm, mm.nlevels - 1, vv, ff, True)
        try:
            m.solve(rtol=1.e-11)
        finally:
            mg_kernel.cycle = saved
        solves.append(m)
    ref, got = solves
    check("solve v (ghosts filled)", None, fine, ref.get_solution(),
          got.get_solution())
    if dtype == torch.float64 and got.num_cycles != ref.num_cycles:
        raise AssertionError(f"lifted {name} {n}^2 solve: {got.num_cycles} "
                             f"kernel cycles, {ref.num_cycles} plain")
    if got.source_norm != ref.source_norm or got.f[-1] is not ref.f[-1]:
        raise AssertionError(f"lifted {name} {n}^2: the solve changed f or "
                             "its norm")
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r[1] / r[2])
    log(f"  ok  {n:5d}^2 {name:21s} {str(dtype)[6:]:8s} core top "
        f"{2 ** (top + 1)}^2, {len(peeled)} peeled; {len(rows)} checks, "
        f"worst {worst[0]}: {worst[1]:.3e} (tol {tol:g} x {worst[2]:.3g}); "
        f"solve cycles kernel {got.num_cycles} plain {ref.num_cycles}, "
        f"residual {got.residual_error:.3e} / {ref.residual_error:.3e}")


def lifted_cycle_timing(n, name, smi):
    """CUDA-event ms of one float32 cycle of a LIFTED_CASES operator: the
    kernels with the lift (lifted_rhs and the refill each call), the same
    cycle given f_h (a solve's cycles), lifted_rhs alone, and the plain
    cycle."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    mg = make_lifted_mg(n, name, torch.float32)
    rng = np.random.default_rng(5)
    g = mg.soln_grid
    v, f = frame(rng, g, torch.float32, 0.1), frame(rng, g, torch.float32)
    f_h = mg_kernel.lifted_rhs(mg, f)
    runs = (("lifted cycle", lambda: mg_kernel.cycle(mg, v, f), 10),
            ("cycle given f_h", lambda: mg_kernel.cycle(mg, v, f, f_h), 10),
            ("lifted_rhs", lambda: mg_kernel.lifted_rhs(mg, f), 10),
            ("plain cycle", lambda: mg_kernel.core_plain(
                mg, mg.nlevels - 1, v, f, True), 2))
    times = {}
    for what, fn, reps in runs:
        event_ms(fn, 1)                               # warm up
        times[what] = event_ms(fn, reps)
    log(f"  {name} {n}^2 float32: " + "; ".join(
        f"{k} {t:.4f} ms" for k, t in times.items()) + f" [{smi}]")
    return times


def analytic_on_card():
    """The regression driver's four analytic solves (MG_EXPECTED) at their
    published 256^2 in float64 on the card, the counts set to 0 just
    before each and read just after: each within 10% of its expected L2
    error, launching its operator's three entries and no other kernel.
    Returns {name: (L2 error, cycles, seconds, launches)}."""
    import torch

    from pyro2_tpu_torch import test as regression

    entries = {"mg_poisson_dirichlet": MG_KERNELS,
               "mg_vc_poisson_dirichlet": VC_KERNELS,
               "mg_vc_poisson_periodic": VC_KERNELS,
               "mg_general_poisson_inhomogeneous": GENERAL_KERNELS}
    out = {}
    for name, (n, fn, expected) in regression.MG_EXPECTED.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = fn(n, device="cuda", dtype=torch.float64)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _, _, stats = read_counts()
        launched = {k: c for k, c in all_counts().items() if c}
        if abs(err - expected) / expected >= 0.1:
            raise AssertionError(f"{name}: L2 error {err:g}, expected "
                                 f"{expected:g} within 10%")
        if set(launched) != set(entries[name]):
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"{entries[name]} alone")
        out[name] = (err, stats["cycles"], seconds, launched)
        log(f"  ok  {name:33s} {n}^2 float64: L2 error {err:.6g} (expected "
            f"{expected:g}), {stats['cycles']} cycles, {seconds:.3f} s, "
            f"launches {launched}")
    return out


def analytic_card_vs_cpu(n, tol):
    """The four analytic solves at n^2 in float64 on the card and on the
    CPU: equal cycles, L2 errors within tol relative."""
    import torch

    from pyro2_tpu_torch import test as regression
    from pyro2_tpu_torch.multigrid import MG

    for name, (_, fn, _) in regression.MG_EXPECTED.items():
        got = []
        for device in ("cuda", "cpu"):
            MG.stats["cycles"] = 0
            err = fn(n, device=device, dtype=torch.float64)
            got.append((err, MG.stats["cycles"]))
        (card, c_card), (cpu, c_cpu) = got
        if c_card != c_cpu or abs(card - cpu) > tol * cpu:
            raise AssertionError(f"{name} {n}^2: card {card:.12g} in "
                                 f"{c_card} cycles, CPU {cpu:.12g} in "
                                 f"{c_cpu}")
        log(f"  ok  {name:33s} {n}^2: {c_card} cycles on both, L2 error "
            f"card {card:.12g} CPU {cpu:.12g} (|diff| "
            f"{abs(card - cpu):.3e}, tol {tol:g} relative)")


def simple_rhs(g):
    """mg_test_simple's right-hand side on grid g (numpy)."""
    from pyro2_tpu_torch.multigrid.examples import mg_test_simple

    return mg_test_simple.f(g.x2d, g.y2d)


def f64_solution(n, f):
    """The interior of a float64 card solve of the constant Dirichlet
    Poisson problem at rtol 1e-11, and its seconds."""
    import torch

    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    mg = CellCenterMG2d(n, n, device="cuda", dtype=torch.float64)
    mg.init_zeros()
    mg.init_RHS(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mg.solve(rtol=1e-11)
    torch.cuda.synchronize()
    g = mg.soln_grid
    return (mg.get_solution()[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1],
            time.perf_counter() - t0, mg.num_cycles)


def refine_check(what, direct, res, passes, v, ref):
    """solve_ir's bounds: the refined residual below 1e-4 of the direct
    float32 solve's, hi + lo within 1e-8 of the float64 solve."""
    d = float((v - ref).abs().max())
    if not res < 1e-4 * direct or not d < 1e-8:
        raise AssertionError(f"{what}: refined residual {res:.3e} after "
                             f"{passes} passes (direct {direct:.3e}), "
                             f"|hi + lo - f64| {d:.3e}")
    return d


def refine_on_card(n, smi):
    """solve_ir in float32 on the constant Dirichlet Poisson operator with
    mg_test_simple's right-hand side: the direct float32 solve's stalled
    residual, the refined residual and passes, each one's wall time and
    launches (the counts set to 0 just before and read just after), and
    hi + lo against a float64 card solve at rtol 1e-11."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
    from pyro2_tpu_torch.multigrid.refine import solve_ir

    mg = CellCenterMG2d(n, n, device="cuda", dtype=torch.float32)
    g = mg.soln_grid
    f = simple_rhs(g)
    interior = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    row = {}
    for what in ("warm-up", "direct", "refined"):
        mg.init_zeros()
        mg.init_RHS(f)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "refined":
            solve_ir(mg, rtol=1e-10)
        else:
            mg.solve(rtol=1e-10)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row[what] = (mg.residual_error, mg.num_cycles, seconds,
                     {k: c for k, c in all_counts().items() if c},
                     read_counts()[2]["cycles"])
    # the float64 solve of the float32 right-hand side
    ref, s64, c64 = f64_solution(n, f.astype("float32"))
    v = mg.get_solution()[interior].double() + mg.v_lo[interior].double()
    direct, refined = row["direct"], row["refined"]
    d = refine_check(f"solve_ir {n}^2", direct[0], refined[0], refined[1],
                     v, ref)
    # the core alone where it holds the finest level
    want = set(MG_KERNELS) if mg_kernel.split(mg, torch.float32)[1] \
        else {"mg_core"}
    for what, (_, _, _, launched, _) in (("direct", direct),
                                         ("refined", refined)):
        if set(launched) != want:
            raise AssertionError(f"solve_ir {n}^2 {what}: launched "
                                 f"{launched}, expected {want} alone")
    log(f"  ok  solve_ir {n}^2 float32: direct residual {direct[0]:.3e} "
        f"({direct[1]} cycles, {1e3 * direct[2]:.3f} ms, launches "
        f"{direct[3]}); refined {refined[0]:.3e} in {refined[1]} passes "
        f"({refined[4]} cycles, {1e3 * refined[2]:.3f} ms, launches "
        f"{refined[3]}); float64 solve {c64} cycles, {1e3 * s64:.3f} ms; "
        f"|hi + lo - f64| {d:.3e} [{smi}]")
    return row, s64


def refine_sharded_on_card(n, smi):
    """solve_ir_sharded in float32 on the 1 x 1 mesh of
    parallel.make_mesh(): the bounds of refine_on_card, launching
    mg_deep_smooth, mg_correct and mg_core and no mg_down or mg_up."""
    import torch

    from pyro2_tpu_torch.multigrid.refine import solve_ir_sharded
    from pyro2_tpu_torch.parallel import make_mesh
    from pyro2_tpu_torch.parallel.sharded_mg import ShardedMG

    smg = ShardedMG(n, n, make_mesh(), dtype=torch.float32)
    f = simple_rhs(smg.soln_grid)
    row = {}
    for what in ("warm-up", "direct", "refined"):
        smg.init_zeros()
        smg.init_RHS(f)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "refined":
            solve_ir_sharded(smg, rtol=1e-10)
        else:
            smg.solve(rtol=1e-10)
        torch.cuda.synchronize()
        row[what] = (smg.residual_error, smg.num_cycles,
                     time.perf_counter() - t0,
                     {k: c for k, c in all_counts().items() if c})
    ref, _, _ = f64_solution(n, f.astype("float32"))
    v = smg.v_int.double() + smg.v_lo.double()
    direct, refined = row["direct"], row["refined"]
    d = refine_check(f"solve_ir_sharded {n}^2", direct[0], refined[0],
                     refined[1], v, ref)
    want = {"mg_deep_smooth", "mg_correct", "mg_core"}
    if set(refined[3]) != want or set(direct[3]) != want:
        raise AssertionError(f"solve_ir_sharded {n}^2: launched "
                             f"{refined[3]} / {direct[3]}, expected {want}")
    log(f"  ok  solve_ir_sharded {n}^2 float32 (1 x 1 mesh): direct "
        f"residual {direct[0]:.3e} ({direct[1]} cycles, "
        f"{1e3 * direct[2]:.3f} ms, launches {direct[3]}); refined "
        f"{refined[0]:.3e} in {refined[1]} passes ({1e3 * refined[2]:.3f} "
        f"ms, launches {refined[3]}); |hi + lo - f64| {d:.3e} [{smi}]")
    return row


# ---------------------------------------------------------------------------
# phase 5i: the sharded hyperbolic tier (parallel/sharded.py,
# sharded_hyperbolic.py, sharded_particles.py): the block steps k_ctu, with
# the block's solid and domain-edge flags, and k_swe
# ---------------------------------------------------------------------------

# the seam checks' configurations, one step at every block of each split:
# (name, solver, problem, nx, ny, inputs)
SEAM_CASES = (
    ("quad_hllc_outflow", "compressible", "quad", 1024, 1024, {}),
    ("rt_gravity_hse", "compressible", "rt", 1024, 1024, {}),
    ("sod_reflect_walls", "compressible", "sod", 1024, 1024,
     {**WALLS, "mesh.ymax": 1.0}),
    ("sph_sedov_cgf", "compressible", "sedov", 1024, 1024,
     {**SPHERICAL, "mesh.xmin": 0.05, "mesh.xmax": 1.0,
      "sedov.r_init": 0.1}),
    ("ramp", "compressible", "ramp", 1024, 256, {}),
    ("swe_quad_roe_outflow", "swe", "quad", 1024, 1024,
     {"swe.riemann": "Roe", "swe.limiter": 2}),
    ("swe_dam_roe_reflect_y", "swe", "dam", 1024, 1024,
     {"swe.riemann": "Roe", "mesh.ymax": 1.0,
      "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect"}),
)
SEAM_SPLITS = ((2, 2), (1, 4))


def seam_check(name, solver, problem, nx, ny, inputs, dtype, tol):
    """The block step at every block of a 2x2 and a 1x4 split of a serial
    state on the card, after 3 serial kernel steps (t > 0).  Each block is
    set up as parallel.sharded sets up that rank (a Mesh of the split's
    shape at the block's coordinates: its solid and domain-edge flags, its
    window of the spherical geometry, its gated source fill), its frame is
    the window of the serial filled frame (what the halo exchange and the
    extended fills leave in it), and its kernel (k_ctu or k_swe) is
    launched alone.  The reassembled interiors must equal the serial
    kernel step by bits, and each block's kernel its plain step with the
    same flags within tol x max|U|.  Returns the worst block |diff|."""
    import torch

    from pyro2_tpu_torch.parallel import ShardedCompressible, ShardedSWE
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh

    sim = make_sim(problem, {"mesh.nx": nx, "mesh.ny": ny, **inputs}, dtype,
                   solver=solver)
    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    g = sim.cc_data.grid
    serial = interior(sim._step.launch(U, t, dt), g)
    cls = ShardedCompressible if solver == "compressible" else ShardedSWE
    worst = 0.0
    for px, py in SEAM_SPLITS:
        bx, by = nx // px, ny // py
        got = torch.empty_like(serial)
        rel = 0.0
        for ix in range(px):
            for iy in range(py):
                sh = cls(sim.rp, Mesh((px, py), "cuda", (ix, iy)),
                         problem=problem, dtype=dtype)
                frame = U[:, ix * bx:(ix + 1) * bx + 2 * g.ng,
                          iy * by:(iy + 1) * by + 2 * g.ng].contiguous()
                step, lg = sh._block_step, sh.local_grid
                k = interior(step.launch(frame, t, dt), lg)
                p = interior(step.plain(frame, t, dt), lg)
                got[:, ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by] = k
                err = float((k - p).abs().max())
                scale = float(p.abs().max())
                if not bool(torch.isfinite(k).all()) or err > tol * scale:
                    raise AssertionError(
                        f"{name} {px}x{py} block ({ix}, {iy}): the kernel "
                        f"is {err:.3e} off its plain step (tol {tol:g} x "
                        f"{scale:.3e})")
                worst = max(worst, err)
                rel = max(rel, err / scale)
                flags = (sh.local_sim.solid.__dict__,
                         getattr(sh.local_sim, "domain_edges", None))
        torch.cuda.synchronize()
        bits = torch.equal(got, serial)
        log(f"  {'ok ' if bits else 'BAD'} {name:24s} {nx}x{ny} "
            f"{str(U.dtype)[6:]:8s} {px}x{py}: blocks equal to the serial "
            f"kernel step by bits: {bits}; worst block kernel against its "
            f"plain step {rel:.3e} x max|U| (tol {tol:g}); t = {t:.6g}; "
            f"last block's solid {flags[0]}, edges "
            f"{None if flags[1] is None else flags[1].flags()}")
        if not bits:
            raise AssertionError(f"{name} {px}x{py}: the blocks' kernel "
                                 "steps differ from the serial step")
    return worst


def hyperbolic_path(cls_name, solver, problem, n, steps, inputs=None,
                    n_particles=0, *, smi):
    """parallel.<cls_name> on make_mesh()'s 1 x 1 mesh, CUDA float32, for
    `steps` steps, every launch count reset just before and read just
    after; then the serial Simulation (Pyro's) stepped with the same dts,
    whose state (and particles) it must equal by bits.  The CTU and swe
    tiers step at the sharded CFL dt (Mesh.pmin), advection at its serial
    CFL dt, burgers at the serial CFL dt of its initial state.  Returns
    (sharded object, seconds, launches by kernel, a one-step function)."""
    import torch

    from pyro2_tpu_torch import Pyro, parallel

    extra = {"particles.do_particles": 1, "particles.n_particles":
             n_particles, "particles.particle_generator": "grid"} \
        if n_particles else {}
    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **(inputs or {}), **extra})
    sim = p.sim
    g = sim.cc_data.grid
    sh = getattr(parallel, cls_name)(sim.rp, parallel.make_mesh(),
                                     problem=problem, dtype=sim.dtype)
    U = sh.init_interior()
    if U.dtype != torch.float32 or not U.is_cuda or \
            not torch.equal(U, interior(sim.cc_data.data, g)):
        raise AssertionError(f"{cls_name} {problem}: the blockwise initial "
                             "state is not the serial one on the card")
    if hasattr(sh, "compute_dt"):
        dt_of = sh.compute_dt
    else:
        sim.cc_data.fill_BC_all()
        sim.method_compute_timestep()
        fixed = sim.dt

        def dt_of(_):
            return fixed
    parts = sim.particles
    carry = [U, 0.0]
    if parts is not None:
        advance = sh.build_step_with_particles(parts)
        carry += [parts.positions.clone(), parts.active.clone()]

    def one_step():
        U, t = carry[0], carry[1]
        dt = dt_of(U)
        if parts is not None:
            carry[0], carry[2], carry[3] = advance(U, carry[2], carry[3],
                                                   t, dt)
        else:
            carry[0] = sh.step(U, t, dt)
        carry[1] = t + dt
        return dt

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dts = [one_step() for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_counts().items() if v}

    sim.cc_data.t = 0.0
    for dt in dts:
        sim.cc_data.fill_BC_all()
        sim.dt = dt
        sim.evolve()
    U = carry[0]
    same = torch.equal(U, interior(sim.cc_data.data, g))
    if parts is not None:
        same = (same and torch.equal(carry[2], parts.positions) and
                torch.equal(carry[3], parts.active))
    finite = bool(torch.isfinite(U).all())
    log(f"  {'ok ' if same and finite else 'BAD'} {cls_name} {problem} "
        f"{n}x{n} f32, 1x1 mesh"
        f"{f', {parts.n_particles} particles' if parts else ''}: {steps} "
        f"steps in {seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, "
        f"launches {launched}; equal to the serial run with the same dts "
        f"by bits{' (positions and active too)' if parts else ''}: {same}; "
        f"t = {carry[1]:.6g} [{smi}]")
    if not same or not finite:
        raise AssertionError(f"{cls_name} {problem}: the sharded run is not "
                             "the serial run")
    return sh, seconds, launched, one_step


def hyper_block_timing(sh, bw, fp32):
    """CUDA-event ms of the sharded quad path's block step (k_ctu through
    the block's CTUStep; on the 1x1 mesh every edge is a domain edge)
    against its plain step, beside its bound; then block (0, 0) of a 2x2
    split of the same frame, whose high edges are seams (xr = yr = 0).
    Returns the 1x1 block's (ms, plain ms, bound ms, bound by)."""
    import torch

    from pyro2_tpu_torch.parallel import ShardedCompressible
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    U_int = sh.init_interior()
    dt = sh.compute_dt(U_int)
    frame = sh._step_input(U_int, 0.0)
    out = None
    for blk in (sh, ShardedCompressible(sh.rp, Mesh((2, 2), "cuda", (0, 0)),
                                        problem=sh.problem)):
        g, step = blk.local_grid, blk._block_step
        f = frame[:, :g.qx, :g.qy].contiguous()
        times = time_pair(
            f"ctu_step sharded block (quad {g.nx}x{g.ny} of a "
            f"{blk.px}x{blk.py} mesh, edges "
            f"{blk.local_sim.domain_edges.flags()})",
            lambda: step.launch(f, 0.0, dt), lambda: step.plain(f, 0.0, dt),
            ctu_kernel.work(g.nx, g.ny, blk.nvar, torch.float32,
                            step.with_sources), bw, fp32)
        out = out or times
    return out


# ---------------------------------------------------------------------------
# phase 5j: the sharded MOL tier (parallel/sharded_mol.py: k_rk with the
# block's domain-edge flags, k_fv4) and the solvers with inline sharded
# multigrid solves (sharded_incompressible.py, sharded_burgers_viscous.py)
# ---------------------------------------------------------------------------

# the MOL seam checks' configurations, one stage increment at every block
# of each split: (name, solver, problem, inputs)
MOL_SEAM_CASES = (
    ("rk_quad_hllc_outflow", "compressible_rk", "quad",
     {"compressible.riemann": "HLLC", "compressible.cvisc": 0.1,
      "mesh.xlboundary": "outflow", "mesh.xrboundary": "outflow",
      "mesh.ylboundary": "outflow", "mesh.yrboundary": "outflow"}),
    ("rk_kh_periodic", "compressible_rk", "kh", {}),
    ("fv4_acoustic_pulse", "compressible_fv4", "acoustic_pulse", {}),
)
MOL_SHARDED = {"compressible_rk": "ShardedCompressibleRK",
               "compressible_fv4": "ShardedCompressibleFV4",
               "compressible_sdc": "ShardedCompressibleSDC"}


def mol_seam_check(name, solver, problem, inputs, n, dtype, tol):
    """The MOL stage increment at every block of a 2x2 and a 1x4 split of a
    serial state on the card after 3 serial kernel steps (t > 0): each
    block set up as parallel.sharded_mol sets up that rank (its solid and
    domain-edge flags), its frame the window of the serial filled frame
    (what the halo exchange leaves in it), its kernel (k_rk or k_fv4)
    launched alone.  The reassembled increments must equal the serial
    kernel increment by bits, and each block's kernel its plain stage with
    the same flags within tol x the block's increment scale
    (mol_kernel.increment_scale, max|F_x|/dx + max|F_y|/dy + max|S|: the
    terms k cancels, the yardstick of mol_check; max|k| itself is what is
    left after the cancellation, 0.3 against fluxes / dx of ~1e3 on kh).
    Returns the worst block |diff|."""
    import torch

    from pyro2_tpu_torch import parallel
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    sim = mol_sim(solver, problem, inputs, None, n, n, dtype)
    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    g = sim.cc_data.grid
    serial = interior(sim._step.launch(U, t, dt), g)
    cls = getattr(parallel, MOL_SHARDED[solver])
    worst = 0.0
    for px, py in SEAM_SPLITS:
        bx, by = n // px, n // py
        got = torch.empty_like(serial)
        rel = 0.0
        for ix in range(px):
            for iy in range(py):
                sh = cls(sim.rp, Mesh((px, py), "cuda", (ix, iy)),
                         problem=problem, dtype=dtype)
                frame = U[:, ix * bx:(ix + 1) * bx + 2 * g.ng,
                          iy * by:(iy + 1) * by + 2 * g.ng].contiguous()
                step, lg = sh._block_step, sh.local_grid
                k = interior(step.launch(frame, t, dt), lg)
                p = interior(step.plain(frame, t, dt), lg)
                got[:, ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by] = k
                err = float((k - p).abs().max())
                scale = mol_kernel.increment_scale(sh.local_sim, step.kind,
                                                   frame, t, dt)
                if not bool(torch.isfinite(k).all()) or err > tol * scale:
                    raise AssertionError(
                        f"{name} {px}x{py} block ({ix}, {iy}): the kernel "
                        f"is {err:.3e} off its plain stage (tol {tol:g} x "
                        f"{scale:.3e})")
                worst = max(worst, err)
                rel = max(rel, err / scale)
                edges = sh.local_sim.domain_edges.flags()
        torch.cuda.synchronize()
        bits = torch.equal(got, serial)
        log(f"  {'ok ' if bits else 'BAD'} {name:22s} {n}x{n} "
            f"{str(U.dtype)[6:]:8s} {px}x{py}: block increments equal to "
            f"the serial kernel increment by bits: {bits}; worst block "
            f"kernel against its plain stage {rel:.3e} x the increment "
            f"scale (tol "
            f"{tol:g}); t = {t:.6g}; last block's edges {edges}, kernel "
            f"ints 21..24 {step.kernel_args(frame, dt)[0][21:]}")
        if not bits:
            raise AssertionError(f"{name} {px}x{py}: the blocks' stage "
                                 "increments differ from the serial one")
    return worst


def mol_sharded_path(solver, problem, n, steps, kernel, per_step, smi,
                     inputs=None):
    """parallel.ShardedCompressible{RK,FV4,SDC} on make_mesh()'s 1 x 1 mesh,
    CUDA float32, for `steps` steps at the sharded CFL dt (Mesh.pmin), every
    launch count reset just before and read just after: `per_step`
    launches of `kernel` a step and no other.  fv4 and sdc start from
    preevolve_interior, which must equal the serial preevolve by bits.
    Then the serial Simulation (Pyro's) stepped with the same dts, whose
    state it must equal by bits, and its ms/step.  Returns (sharded
    object, seconds, launches, a one-step function, serial seconds,
    pyro)."""
    import torch

    from pyro2_tpu_torch import Pyro, parallel

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **(inputs or {})})
    sim = p.sim
    g = sim.cc_data.grid
    sh = getattr(parallel, MOL_SHARDED[solver])(
        sim.rp, parallel.make_mesh(), problem=problem, dtype=sim.dtype)
    U = sh.init_interior()
    if hasattr(sh, "preevolve_interior"):
        U = sh.preevolve_interior(U)
    if U.dtype != torch.float32 or not U.is_cuda or \
            not torch.equal(U, interior(sim.cc_data.data, g)):
        raise AssertionError(f"{solver} {problem}: the sharded initial "
                             "state is not the serial one on the card")
    carry = [U, 0.0]

    def one_step():
        dt = sh.compute_dt(carry[0])
        carry[0] = sh.step(carry[0], carry[1], dt)
        carry[1] += dt
        return dt

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dts = [one_step() for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_counts().items() if v}
    if launched != {kernel: per_step * steps}:
        raise AssertionError(f"sharded {solver} {problem}: launched "
                             f"{launched}, expected {per_step * steps} "
                             f"{kernel}")
    sim.cc_data.t = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for dt in dts:
        sim.cc_data.fill_BC_all()
        sim.dt = dt
        sim.evolve()
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    same = torch.equal(carry[0], interior(sim.cc_data.data, g))
    finite = bool(torch.isfinite(carry[0]).all())
    log(f"  {'ok ' if same and finite else 'BAD'} {MOL_SHARDED[solver]} "
        f"{problem} {n}x{n} f32, 1x1 mesh: {steps} steps in {seconds:.3f} "
        f"s, {1e3 * seconds / steps:.3f} ms/step (the serial run with the "
        f"same dts {1e3 * serial_s / steps:.3f} ms/step), launches "
        f"{launched}; equal to the serial run by bits: {same}; t = "
        f"{carry[1]:.6g} [{smi}]")
    if not same or not finite:
        raise AssertionError(f"sharded {solver} {problem}: the sharded run "
                             "is not the serial run")
    return sh, seconds, launched, one_step, serial_s, p


# the solvers with inline sharded solves: (class, solver, problem, the
# multigrid solves of the preevolve, and of a step)
MG_SHARDED = (
    ("ShardedIncompressible", "incompressible", "shear", 3, 2),
    ("ShardedIncompressibleViscous", "incompressible_viscous", "shear", 5,
     4),
    ("ShardedBurgersViscous", "burgers_viscous", "tophat", 0, 2),
)


def mg_sharded_path(cls_name, solver, problem, pre_solves, step_solves, n,
                    steps, dtype, tol, smi, core="mg_core", per_step=None):
    """parallel.<cls_name> on make_mesh()'s 1 x 1 mesh on the card in
    `dtype`: its preevolve (where the solver has one; timed on its own)
    and `steps` steps at its CFL dt (Mesh.pmax; timed alone, as the serial
    steps are), every count reset just before and read just after: mg_deep_smooth, mg_correct and `core` alone, in the numbers
    sharded_mg.stats' solves and cycles imply, and the kernels of
    `per_step` (name -> launches) each step, the preevolve's throwaway
    step included.  Then the serial Simulation (Pyro's, preevolved at its
    initialization) stepped with the same dts: the states within tol x
    max(1, max|U|), and the serial CFL dt before each step within tol of
    the sharded one.  Returns (sharded object, the steps' seconds,
    launches, a one-step function, the serial steps' seconds, pyro, the
    |diff| / scale, the preevolve's seconds)."""
    import torch

    from pyro2_tpu_torch import Pyro, parallel
    from pyro2_tpu_torch.parallel import sharded_mg

    p = Pyro(solver, dtype=dtype)       # default device: CUDA
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    sim = p.sim
    g = sim.cc_data.grid
    sh = getattr(parallel, cls_name)(sim.rp, parallel.make_mesh(),
                                     problem=problem, dtype=dtype)
    if sh.U_int.dtype != dtype or not sh.U_int.is_cuda:
        raise AssertionError(f"{cls_name}: the state is not {dtype} on the "
                             "card")

    def one_step():
        sh.method_compute_timestep()
        sh.evolve()
        return sh.dt

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if pre_solves:
        sh.preevolve()
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dts = [one_step() for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_counts().items() if v}
    stats = dict(sharded_mg.stats)
    levels = sh.smg.nlevels - sh.smg.k_cross
    cycles = stats["cycles"]
    expect = {"mg_deep_smooth": 2 * levels * cycles,
              "mg_correct": levels * cycles, core: cycles}
    evolves = steps + (1 if pre_solves else 0)
    expect.update({k: v * evolves for k, v in (per_step or {}).items()})
    solves = pre_solves + step_solves * steps
    if launched != expect or stats["solves"] != solves:
        raise AssertionError(
            f"{cls_name}: launched {launched} in {stats['solves']} solves "
            f"and {cycles} cycles of {levels} sharded levels; expected "
            f"{expect} in {solves} solves")
    sim.cc_data.t = 0.0
    worst_dt = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for dt in dts:
        sim.cc_data.fill_BC_all()
        sim.method_compute_timestep()
        worst_dt = max(worst_dt, abs(sim.dt - dt) / dt)
        sim.dt = dt
        sim.evolve()
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    ref = interior(sim.cc_data.data, g)
    scale = max(1.0, float(ref.abs().max()))
    err = float((sh.U_int - ref).abs().max()) / scale
    finite = bool(torch.isfinite(sh.U_int).all())
    ok = finite and err <= tol and worst_dt <= tol
    log(f"  {'ok ' if ok else 'BAD'} {cls_name} {problem} {n}x{n} "
        f"{str(dtype)[6:]}, 1x1 mesh: "
        + (f"preevolve in {pre_s:.3f} s, then " if pre_solves else "")
        + f"{steps} steps in {seconds:.3f} s, {1e3 * seconds / steps:.3f} "
        f"ms/step (the serial run's steps "
        f"{1e3 * serial_s / steps:.3f} ms/step); {stats['solves']} solves, "
        f"{cycles} cycles ({cycles / stats['solves']:.2f} per solve), "
        f"{levels} sharded levels above a {2 ** sh.smg.k_cross}^2 core; "
        f"launches {launched}; against the serial run with the same dts: "
        f"|diff| {err:.3e} x max(1, max|U|) (tol {tol:g}), serial CFL dt "
        f"within {worst_dt:.3e} of the sharded one [{smi}]")
    if not ok:
        raise AssertionError(f"{cls_name}: the sharded run is not the "
                             "serial run")
    return sh, seconds, launched, one_step, serial_s, p, err, pre_s


# ---------------------------------------------------------------------------
# phase 5k: the sharded lm_atm (parallel/sharded_lm_atm.py: the lm stages on
# blocks, a coefficient hierarchy installed a projection on the sharded vc
# multigrid) and the overlapped step (parallel/overlap.py: k_ctu and k_swe
# as a core and four band steps)
# ---------------------------------------------------------------------------

def lm_block_check(dtype, tol, errs):
    """The lm stages at every block of a 2x2 and a 1x4 split of a serial
    bubble 1024^2 state on the card after 3 serial kernel steps: each
    block's frames the windows of the serial step's frames (what the halo
    and seam exchanges leave in them), its kernel launched alone on its
    block grid (the global dx and dy).  Every block's MAC faces of its own
    cells and the high face beyond them (a seam face where a neighbour
    follows; the ghost faces further out the seam exchange replaces), and
    its reassembled rho increments and advective terms must equal the
    serial kernel's by bits,
    and each block's kernel its plain stage within tol x the stage's scale
    (lm_scales).  Returns the worst block |diff| by stage."""
    import torch

    from pyro2_tpu_torch.parallel.blocks import block_grid
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    g, calls = lm_bubble_calls(1024, dtype)
    ng = g.ng
    lm = lm_kernel.LMInterface(g)
    serial = {"lm_mac": lm.launch_mac(*((calls["lm_mac"][0],) +
                                        calls["lm_mac"][1])),
              "lm_rho": (lm.launch_rho(calls["lm_rho"][0],
                                       *calls["lm_rho"][1]),),
              "lm_states": lm.launch_states(calls["lm_states"][0],
                                            *calls["lm_states"][1])}
    plains = {"lm_mac": lm_kernel.mac_vels_plain,
              "lm_rho": lm_kernel.rho_increment_plain,
              "lm_states": lm_kernel.advect_terms_plain}
    for px, py in SEAM_SPLITS:
        bx, by = g.nx // px, g.ny // py
        got = {k: [torch.empty_like(a) for a in serial[k]]
               for k in ("lm_rho", "lm_states")}
        window = True
        rel = dict.fromkeys(plains, 0.0)
        for ix in range(px):
            for iy in range(py):
                bg = block_grid(g, px, py, ix, iy)
                blm = lm_kernel.LMInterface(bg)
                r0, c0 = ix * bx, iy * by
                win = (slice(r0, r0 + bx + 2 * ng),
                       slice(c0, c0 + by + 2 * ng))
                inner = (slice(r0, r0 + bx), slice(c0, c0 + by))
                bcalls = {name: (dt, tuple(a[win].contiguous()
                                           for a in planes))
                          for name, (dt, planes) in calls.items()}
                scales = lm_scales(bg, bcalls)
                for name, launch in (("lm_mac", blm.launch_mac),
                                     ("lm_rho", blm.launch_rho),
                                     ("lm_states", blm.launch_states)):
                    dt, bp = bcalls[name]
                    k = launch(dt, *bp)
                    k = k if isinstance(k, tuple) else (k,)
                    ref = plains[name](bg, dt, *bp)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    err = max(float((a - b).abs().max())
                              for a, b in zip(k, ref))
                    scale = scales.get(
                        name, max(float(a.abs().max()) for a in ref))
                    if err > tol * scale or not all(
                            bool(torch.isfinite(a).all()) for a in k):
                        raise AssertionError(
                            f"{name} {px}x{py} block ({ix}, {iy}): the "
                            f"kernel is {err:.3e} off its plain stage "
                            f"(tol {tol:g} x {scale:.3e})")
                    errs[name] = max(errs.get(name, 0.0), err)
                    rel[name] = max(rel[name], err / scale)
                    if name == "lm_mac":
                        # u on the x faces lo..hi+1, v on the y faces
                        for a, b, ex, ey in zip(k, serial["lm_mac"],
                                                (1, 0), (0, 1)):
                            box = (slice(ng, ng + bx + ex),
                                   slice(ng, ng + by + ey))
                            sbox = (slice(r0 + ng, r0 + ng + bx + ex),
                                    slice(c0 + ng, c0 + ng + by + ey))
                            window = window and torch.equal(a[box], b[sbox])
                    else:
                        for a, b in zip(got[name], k):
                            a[inner] = b
        torch.cuda.synchronize()
        bits = {k: all(torch.equal(a, b) for a, b in zip(got[k], serial[k]))
                for k in got}
        ok = window and all(bits.values())
        log(f"  {'ok ' if ok else 'BAD'} lm stages bubble 1024x1024 "
            f"{str(dtype)[6:]:8s} {px}x{py}: every block's MAC faces (lo to "
            f"hi+1 along the normal, seam faces included) equal to the "
            f"serial kernel's by bits: {window}; reassembled rho and states "
            f"equal "
            f"by bits: {bits}; worst block kernel against its plain stage "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f" x its scale (tol {tol:g})")
        if not ok:
            raise AssertionError(f"lm stages {px}x{py}: the blocks' kernel "
                                 "outputs differ from the serial ones")
    return errs


def install_ms(sh, reps=5):
    """Host-clock ms of one coefficient install of a ShardedLMAtm (gather
    the density, beta0^2 / rho, ShardedVarCoeffMG.install_coefficients),
    ending in a sync."""
    import torch

    rho = sh.U_int[sh.irho]
    sh._install(rho)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sh._install(rho)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def lm_block_timing(bw, fp32):
    """CUDA-event ms of each lm stage on block (0, 0) of a 2x2 split of the
    1024^2 f32 bubble (a 512^2 block frame, its seams on the high sides)
    against its plain stage, beside its bound."""
    import torch

    from pyro2_tpu_torch.parallel.blocks import block_grid
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    g, calls = lm_bubble_calls(1024, torch.float32)
    bg = block_grid(g, 2, 2, 0, 0)
    win = (slice(0, bg.qx), slice(0, bg.qy))
    blm = lm_kernel.LMInterface(bg)
    out = {}
    for name, launch, plain in (
            ("lm_mac", blm.launch_mac, lm_kernel.mac_vels_plain),
            ("lm_rho", blm.launch_rho, lm_kernel.rho_increment_plain),
            ("lm_states", blm.launch_states, lm_kernel.advect_terms_plain)):
        dt, planes = calls[name]
        bp = tuple(a[win].contiguous() for a in planes)
        out[name] = time_pair(
            f"{name} sharded block (bubble 512x512 of a 2x2 mesh)",
            lambda: launch(dt, *bp), lambda: plain(bg, dt, *bp),
            lm_kernel.work(name, bg.nx, bg.ny, torch.float32), bw, fp32)
    return out


# the overlapped paths: (label, class, solver, problem, inputs, kernel)
OVERLAP_CASES = (
    ("quad", "ShardedCompressible", "compressible", "quad", {}, "ctu_step"),
    ("swe_quad", "ShardedSWE", "swe", "quad",
     {"swe.riemann": "Roe", "swe.limiter": 2}, "swe_step"),
)


def overlap_frames(ov, U_pad, U_fill):
    """The five (block step, frame) pairs of one overlapped step: the core
    on the unfilled padded block, the bands on the filled one."""
    return [(ov.ss._block_step, U_pad)] + [
        (band, U_fill[src].contiguous()) for src, band, _, _ in ov._bands]


def overlap_assembled(ov, pairs, t, dt, how):
    """The overlapped step's interior from the five frames, each block step
    called through `how` ("launch" or "plain")."""
    (core, U_pad), bands = pairs[0], pairs[1:]
    out = ov.ss._interior(getattr(core, how)(U_pad, t, dt))
    for (src, _, rim, cells), (band, frame) in zip(ov._bands, bands):
        out[rim] = getattr(band, how)(frame, t, dt)[cells]
    return out


def overlap_block_check(label, cls_name, solver, problem, inputs, n, dtype):
    """Every block of a 2x2 split of a serial state on the card after 3
    serial kernel steps: the overlapped step's core from the block's
    unfilled window (its interior, zero ghosts) and its bands from the
    filled window (the serial filled frame's, with the seam floor) must
    equal the plain block step (the kernel on the filled window) by bits,
    and the blocks reassembled the serial kernel step.  Returns the worst
    |diff| of the overlapped kernels against their plain steps."""
    import torch
    import torch.nn.functional as F

    from pyro2_tpu_torch import parallel
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh

    sim = make_sim(problem, {"mesh.nx": n, "mesh.ny": n, **inputs}, dtype,
                   solver=solver)
    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    g = sim.cc_data.grid
    ng = g.ng
    serial = interior(sim._step.launch(U, t, dt), g)
    got = torch.empty_like(serial)
    same, worst = True, 0.0
    bx, by = n // 2, n // 2
    for ix in range(2):
        for iy in range(2):
            sh = getattr(parallel, cls_name)(
                sim.rp, Mesh((2, 2), "cuda", (ix, iy)), problem=problem,
                overlap=True, dtype=dtype)
            win = (slice(None), slice(ix * bx, ix * bx + bx + 2 * ng),
                   slice(iy * by, iy * by + by + 2 * ng))
            U_fill = sh._floor_seams(U[win].contiguous())
            U_pad = F.pad(interior(U_fill, sh.local_grid), (ng,) * 4)
            ov = sh._overlapped
            pairs = overlap_frames(ov, U_pad, U_fill)
            k = overlap_assembled(ov, pairs, t, dt, "launch")
            p = overlap_assembled(ov, pairs, t, dt, "plain")
            plain_blk = interior(sh._block_step.launch(U_fill, t, dt),
                                 sh.local_grid)
            same = same and torch.equal(k, plain_blk)
            worst = max(worst, float((k - p).abs().max()))
            got[:, ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by] = k
    torch.cuda.synchronize()
    bits = torch.equal(got, serial)
    ok = same and bits
    log(f"  {'ok ' if ok else 'BAD'} overlap {label:9s} {n}x{n} "
        f"{str(dtype)[6:]:8s} 2x2: every block's core (unfilled window) + "
        f"4 bands (filled window) equal to the plain block step by bits: "
        f"{same}; reassembled equal to the serial kernel step: {bits}; the "
        f"overlapped kernels against their plain steps {worst:.3e}; t = "
        f"{t:.6g}")
    if not ok:
        raise AssertionError(f"overlap {label}: the overlapped block steps "
                             "differ from the plain ones")
    return worst


def overlap_path(label, cls_name, solver, problem, inputs, kernel, n, steps,
                 smi):
    """parallel.<cls_name> plain and with overlap=True on make_mesh()'s 1x1
    mesh, CUDA float32: `steps` plain steps at the sharded CFL dt, then
    the overlapped run with the same dts, the counts reset just before
    each: 1 and 5 launches of `kernel` a step and no other, equal final
    states by bits; then both timed with those dts in turns (plain,
    overlap, overlap, plain).  Returns (overlapped object, launches,
    plain ms/step, overlapped ms/step)."""
    import torch

    from pyro2_tpu_torch import Pyro, parallel

    p = Pyro(solver)                    # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30, **inputs})
    rp = p.sim.rp
    cls = getattr(parallel, cls_name)
    plain = cls(rp, parallel.make_mesh(), problem=problem,
                dtype=torch.float32)
    over = cls(rp, parallel.make_mesh(), problem=problem, overlap=True,
               dtype=torch.float32)
    U0 = plain.init_interior()

    def run(sh, dts):
        U, t = U0, 0.0
        for dt in dts:
            U = sh.step(U, t, dt)
            t += dt
        return U

    torch.cuda.synchronize()
    reset_counts()
    U, t, dts = U0, 0.0, []
    for _ in range(steps):
        dts.append(plain.compute_dt(U))
        U = plain.step(U, t, dts[-1])
        t += dts[-1]
    torch.cuda.synchronize()
    n_plain = {k: v for k, v in all_counts().items() if v}
    reset_counts()
    V = run(over, dts)
    torch.cuda.synchronize()
    n_over = {k: v for k, v in all_counts().items() if v}
    same = torch.equal(U, V) and bool(torch.isfinite(V).all())
    times = {}
    for name, sh in (("plain", plain), ("overlap", over), ("overlap", over),
                     ("plain", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(sh, dts)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(
            1e3 * (time.perf_counter() - t0) / steps)
    ms = {k: 0.5 * sum(v) for k, v in times.items()}
    ok = same and n_plain == {kernel: steps} and \
        n_over == {kernel: 5 * steps}
    log(f"  {'ok ' if ok else 'BAD'} {cls_name} {problem} {n}x{n} f32, "
        f"1x1 mesh, {steps} steps: overlapped equal to plain by bits: "
        f"{same}; launches plain {n_plain}, overlapped {n_over}; host clock "
        f"plain {ms['plain']:.3f} ms/step ({times['plain'][0]:.3f}, "
        f"{times['plain'][1]:.3f}), overlapped {ms['overlap']:.3f} "
        f"({times['overlap'][0]:.3f}, {times['overlap'][1]:.3f}) [{smi}]")
    if not ok:
        raise AssertionError(f"overlap {label}: the overlapped run is not "
                             "the plain run")
    return over, n_over[kernel], ms["plain"], ms["overlap"]


def overlap_timing(over, kernel, bw, fp32):
    """CUDA-event ms of one overlapped step's five block steps (core + 4
    bands, k_ctu or k_swe) on the 1x1 quad 1024^2 f32 block against their
    plain steps, beside the five calls' summed bound."""
    import torch
    import torch.nn.functional as F

    from pyro2_tpu_torch.solvers.compressible import ctu_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    sh = over
    U_int = sh.init_interior()
    dt = sh.compute_dt(U_int)
    U_fill = sh._step_input(U_int, 0.0)
    U_pad = F.pad(U_int, (sh.ng,) * 4)
    pairs = overlap_frames(sh._overlapped, U_pad, U_fill)
    nbytes = nops = 0
    for step, frame in pairs:
        g = step.sim.cc_data.grid
        if kernel == "ctu_step":
            w = ctu_kernel.work(g.nx, g.ny, sh.nvar, torch.float32,
                                step.with_sources)
        else:
            w = swe_kernel.work(g.nx, g.ny, sh.nvar, torch.float32,
                                step.method)
        nbytes, nops = nbytes + w[0], nops + w[1]
    g = sh.local_grid
    return time_pair(
        f"{kernel} overlapped (core {g.nx}x{g.ny} + 4 bands of 8 x "
        f"{g.ny} / {g.nx} x 8, one step's five launches)",
        lambda: [s.launch(f, 0.0, dt) for s, f in pairs],
        lambda: [s.plain(f, 0.0, dt) for s, f in pairs],
        (nbytes, nops), bw, fp32)


def halo_stats_lines(n):
    """parallel.halo_stats of quad n^2 blocks on a 2x2 and a 1x4 split, in
    float32 (computed from the block geometry: one card holds one
    rank)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.parallel import ShardedCompressible, halo_stats
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh

    p = Pyro("compressible")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": n, "mesh.ny": n})
    for shape in SEAM_SPLITS:
        sh = ShardedCompressible(p.sim.rp, Mesh(shape, "cuda", (0, 0)),
                                 problem="quad", dtype=torch.float32)
        log(f"  halo_stats quad {n}x{n} f32 {shape[0]}x{shape[1]} (computed, "
            f"not measured): {json.dumps(halo_stats(sh))}")


def mol_block_timing(sh, bw, fp32):
    """CUDA-event ms of the sharded rk quad path's block step (k_rk through
    the block's MOLSubstep; on the 1x1 mesh every edge is a domain edge)
    against its plain stage, beside its bound; then block (0, 0) of a 2x2
    split of the same frame, whose high edges are seams (k_rk's ints 22
    and 24 are 0).  Returns the 1x1 block's (ms, plain ms, bound ms, bound
    by)."""
    import torch

    from pyro2_tpu_torch.parallel import ShardedCompressibleRK
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    U_int = sh.init_interior()
    dt = sh.compute_dt(U_int)
    frame = sh._padded(U_int, 0.0)
    out = None
    for blk in (sh, ShardedCompressibleRK(sh.rp, Mesh((2, 2), "cuda",
                                                      (0, 0)),
                                          problem=sh.problem)):
        g, step = blk.local_grid, blk._block_step
        f = frame[:, :g.qx, :g.qy].contiguous()
        times = time_pair(
            f"mol_rk sharded block (quad {g.nx}x{g.ny} of a "
            f"{blk.px}x{blk.py} mesh, edges "
            f"{blk.local_sim.domain_edges.flags()})",
            lambda: step.launch(f, 0.0, dt), lambda: step.plain(f, 0.0, dt),
            mol_kernel.work("rk", g.nx, g.ny, blk.nvar, torch.float32), bw,
            fp32)
        out = out or times
    return out


def time_pair(name, kern, plain, work, bw, fp32):
    """CUDA-event ms of a kernel and its plain version (plain, kernel,
    kernel, plain), beside the kernel's bound; returns (ms, plain ms,
    bound ms, bound by)."""
    nbytes, nops = work
    event_ms(kern, 3)                               # warm up
    event_ms(plain, 1)
    plain_a = event_ms(plain, 3)
    kern_a = event_ms(kern, 20)
    kern_b = event_ms(kern, 20)
    plain_b = event_ms(plain, 3)
    kern_ms, plain_ms = 0.5 * (kern_a + kern_b), 0.5 * (plain_a + plain_b)
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / fp32
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  {name}: kernel {kern_ms:.4f} ms ({kern_a:.4f}, {kern_b:.4f}); "
        f"plain {plain_ms:.4f} ms ({plain_a:.4f}, {plain_b:.4f}); bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B = {bytes_ms:.4f} ms, "
        f"{nops} ops = {ops_ms:.4f} ms); kernel at "
        f"{100 * bound_ms / kern_ms:.2f}% of it")
    return kern_ms, plain_ms, bound_ms, bound_by


def step_peak_memory(step, U, t, dt):
    """Peak device bytes one CTU or swe step allocates above what is
    allocated before it (its output state, and nothing else in the fused
    designs)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step.launch(U, t, dt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  peak device memory of one step: {peak} B above the "
        f"{base} B allocated before it (the state is "
        f"{U.numel() * U.element_size()} B)")
    del out
    return peak


def one_launch_each(fn, calls, kernel, what, entry):
    """Under the profiler, `calls` calls of fn launch `kernel` once each
    and no other device kernel; returns its device us a launch. If no
    profiler session recorded every launch the wrapper of `entry` counted,
    the wrapper's count counts the launches and CUDA events time them."""
    import torch

    rows = device_kernels(fn, calls, (kernel, entry))
    if not rows:
        reset_counts()
        ms = event_ms(fn, calls)
        torch.cuda.synchronize()
        n = launch_count(entry)
        if n != calls:
            raise AssertionError(f"{calls} {what} counted {n} {entry} "
                                 "launches")
        log(f"  by the wrappers' counts: {calls} {what} launch {kernel} "
            f"{n} times ({1e3 * ms:.2f} us each by CUDA events); no "
            "profiler session was whole, so other kernels were not "
            "observed")
        return 1e3 * ms
    names = [(key, n) for key, n, _ in rows]
    if len(rows) != 1 or f"{kernel}<" not in rows[0][0] or \
            rows[0][1] != calls:
        raise AssertionError(f"{calls} {what} launched {names}, not "
                             f"{calls} {kernel}")
    log(f"  under the profiler: {calls} {what} launch {kernel} "
        f"{rows[0][1]} times ({rows[0][2] / calls:.2f} us each) and no "
        "other kernel")
    return rows[0][2] / calls


def launch_count(entry):
    """The launch count of a kernel wrapper, by its entry name."""
    from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.solvers.compressible import padded_step
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    if entry == "swe_step":
        return swe_kernel.launches
    for counts in (mg_kernel.launches, mol_kernel.launches,
                   sharded_mg_kernel.launches, lm_kernel.launches,
                   padded_step.launches):
        if entry in counts:
            return counts[entry]
    raise KeyError(entry)


def swe_tiles(step, U, t, dt, work, bw, fp32):
    """CUDA-event ms of the swe step with other tiles of the same block
    (512 threads in float32), beside the plan's tile."""
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    g = step.sim.cc_data.grid
    for tile in ((30, 14), (14, 30), (62, 6), (22, 22), (46, 14), (30, 30)):
        p = swe_kernel.plan(g.nx, g.ny, step.shape[0], U.dtype, tile)
        event_ms(lambda: step.launch(U, t, dt, tile), 3)
        ms = event_ms(lambda: step.launch(U, t, dt, tile), 20)
        bound_ms = max(1e3 * work[0] / bw, 1e3 * work[1] / fp32)
        log(f"  swe_step {tile[0]} x {tile[1]} tiles ({p.box('traced')} "
            f"traced cells, {p.smem} B): {ms:.4f} ms, "
            f"{100 * bound_ms / ms:.2f}% of the bound")


def down_launches(mg):
    """Under the profiler: one cycle of mg at the solvers' nsmooth launches
    k_down once a peeled level (one round each), and an mg_down call at
    nsmooth 50 on the finest level once a round of its plan."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    rng = np.random.default_rng(9)
    dtype = torch.float32
    peeled = mg_kernel.split(mg, dtype)[1]
    fine = mg.nlevels - 1
    v = frame(rng, mg.soln_grid, dtype, 0.1)
    f = frame(rng, mg.soln_grid, dtype, zero_mean=True)

    def count(fn):
        """k_down's launches under the profiler, or None if it recorded
        no device kernel."""
        rows = device_kernels(fn, 1)
        return sum(n for key, n, _ in rows if "k_down<" in key) \
            if rows else None

    n_cycle = count(lambda: mg_kernel.cycle(mg, v, f))
    how = "launched"
    if n_cycle is None:             # one mg_down call a peeled level
        reset_counts()
        mg_kernel.cycle(mg, v, f)
        torch.cuda.synchronize()
        n_cycle, how = launch_count("mg_down"), "was called"
    op = mg_kernel.flavour(mg)
    rounds = [mg_kernel.tile_plan(mg.grids[lv].nx, mg.nsmooth, dtype,
                                  op).rounds
              for lv in peeled]
    if n_cycle != sum(rounds) or rounds != [1] * len(peeled):
        raise AssertionError(f"a cycle launched k_down {n_cycle} times for "
                             f"{len(peeled)} peeled levels")
    saved = mg.nsmooth
    mg.nsmooth = 50
    try:
        plan = mg_kernel.tile_plan(mg.grids[fine].nx, 50, dtype, op)
        n_50 = count(lambda: mg_kernel.launch_down(mg, fine, v, f))
    finally:
        mg.nsmooth = saved
    if plan.rounds < 2 or n_50 not in (None, plan.rounds):
        raise AssertionError(f"mg_down at nsmooth 50 launched k_down {n_50} "
                             f"times for {plan.rounds} rounds")
    log(f"  one cycle: k_down {how} {n_cycle} times for {len(peeled)} "
        f"peeled levels (one round each); mg_down at nsmooth 50 on "
        f"{mg.grids[fine].nx}^2: "
        + (f"{n_50} launches for {plan.rounds} rounds" if n_50 is not None
           else f"{plan.rounds} rounds, launches not observed (the "
           "profiler recorded nothing)"))


def down_tiles(mg, label):
    """CUDA-event ms and the profiler's device us of mg_down at every
    peeled level with the tiles of plans that keep at least 128, 64, 32,
    16 and 4 tiles (tile_plan keeps mg_kernel.TILE_BLOCKS)."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    dtype = torch.float32
    rng = np.random.default_rng(8)
    fine = mg.nlevels - 1
    for lv in reversed(mg_kernel.split(mg, dtype)[1]):
        g = mg.grids[lv]
        f, v = frame(rng, g, dtype), frame(rng, g, dtype, 0.1)
        guess = v if lv == fine else None
        seen = set()
        for blocks in (128, 64, 32, 16, 4):
            plan = mg_kernel.TilePlan(g.nx, mg.nsmooth, dtype, blocks,
                                      op=mg_kernel.flavour(mg))
            if plan.tile in seen:
                continue
            seen.add(plan.tile)
            call = lambda: mg_kernel.launch_down(mg, lv, guess, f, plan)
            event_ms(call, 3)
            ms = event_ms(call, 20)
            us, how = kernel_device_us(call, 20, "k_down")
            log(f"  mg_down ({label}, {g.nx}^2) {plan.tile}^2 tiles "
                f"({plan.tiles ** 2} blocks): {ms:.4f} ms, {how} "
                f"{us:.2f} us")


def mg_level_kernels(mg, label):
    """The profiler's device us of k_down and k_up a call at every peeled
    level of mg's 1024^2 float32 cycle, called as the cycle calls them
    (CUDA events around a level below ~0.05 ms time the host's enqueue
    too)."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    dtype = torch.float32
    sfx = mg_kernel.FLAVOURS[mg_kernel.flavour(mg)][0]
    fine = mg.nlevels - 1
    rng = np.random.default_rng(7)
    for lv in reversed(mg_kernel.split(mg, dtype)[1]):
        g, gc = mg.grids[lv], mg.grids[lv - 1]
        f, vc = frame(rng, g, dtype), frame(rng, gc, dtype, 0.1)
        v = frame(rng, g, dtype, 0.1)
        guess = v if lv == fine else None
        down, how_down = kernel_device_us(
            lambda: mg_kernel.launch_down(mg, lv, guess, f), 20, "k_down")
        up, how_up = kernel_device_us(
            lambda: mg_kernel.launch_up(mg, lv, v, f, vc, lv == fine), 20,
            "k_up")
        log(f"  {label} {g.nx}^2: k_down{sfx} {down:.2f} us ({how_down}), "
            f"k_up{sfx} {up:.2f} us ({how_up}) a call")


def tile_plan_text(plan):
    """A TilePlan of mg_down or mg_up, in words."""
    return (f"{plan.tile}^2 tiles ({plan.tiles ** 2} blocks of "
            f"{plan.threads}), halo {plan.halo}, {plan.rounds} round(s) of "
            f"{plan.round_iters()}, {plan.smem} B of shared memory")


# a profiler session idles this long on each side of its calls, so that a
# kernel whose device timestamps the tracer places a little outside the
# host's window of the session still falls inside it; a session that
# recorded no device kernel at all, or fewer launches of a kernel than its
# wrapper counted in the session, is made again, up to PROFILER_TRIES, with
# the longer pad PROFILER_RETRY_PAD_S (after many sessions, a 20 ms pad has
# recorded every launch call and none of their kernels, where a 0.5 s pad
# recorded all five in one run and three in another: profiler_records)
PROFILER_PAD_S = 0.02
PROFILER_RETRY_PAD_S = 0.5
PROFILER_TRIES = 3


def profiled(fn, reps, whole=None):
    """torch.profiler over `reps` calls of fn (after one unprofiled call):
    ([(kernel name, launches, device us)] of every device kernel, wall us
    of the calls); the list is empty if no session recorded one.  With
    `whole` = (kernel, wrapper entry), a session must also record every
    launch the wrapper counted in it (the counts are reset before each
    session); the list is empty if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_TRIES + 1):
        if whole:
            reset_counts()
        pad = PROFILER_PAD_S if attempt == 1 else PROFILER_RETRY_PAD_S
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
            time.sleep(pad)
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    dev_us > 0:
                rows.append((e.key, e.count, dev_us))
        if rows and whole:
            kernel, entry = whole
            seen = sum(n for key, n, _ in rows if f"{kernel}<" in key)
            counted = launch_count(entry)
            if seen < counted:
                log(f"  the profiler recorded {seen} of the {counted} "
                    f"{kernel} launches its wrapper counted (session "
                    f"{attempt} of {PROFILER_TRIES})")
                continue
        if rows:
            return rows, wall_us
        log(f"  the profiler recorded no device kernel (session {attempt} "
            f"of {PROFILER_TRIES})")
    return [], wall_us


def device_kernels(fn, reps, whole=None):
    """[(kernel name, launches, device us)] of every device kernel of
    `reps` calls of fn under the profiler; empty if it recorded none (or,
    with `whole`, none whole: see profiled)."""
    return profiled(fn, reps, whole)[0]


def kernel_device_us(fn, reps, kernel):
    """Device us a call of fn spends in `kernel` (k_down, k_up, ...) under
    the profiler, and how it was taken: the CUDA-event time of a call
    instead if the profiler recorded no device kernel."""
    import re

    rows = device_kernels(fn, reps)
    if not rows:
        return 1e3 * event_ms(fn, reps), "by CUDA events"
    return sum(us for key, _, us in rows
               if re.search(rf"\b{kernel}<", key)) / reps, \
        "under the profiler"


def mg_timing(mg, label, bw, fp32):
    """CUDA-event times of each multigrid kernel of mg's operator and its
    plain version as one 1024^2 float32 cycle calls them: the core from a
    zero guess, and the down and up of every peeled level (mg_up with
    mg_kernel.tile_plan's tiles, printed beside it); returns the core's and
    the finest level's, keyed by entry name, and every level's, keyed by
    (entry name, n)."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    dtype = torch.float32
    sfx = mg_kernel.FLAVOURS[mg_kernel.flavour(mg)][0]
    top, peeled = mg_kernel.split(mg, dtype)
    fine = mg.nlevels - 1
    rng = np.random.default_rng(7)
    gt = mg.grids[top]
    ft = frame(rng, gt, dtype)
    out = {"mg_core" + sfx: time_pair(
        f"mg_core{sfx} ({label}, {gt.nx}^2 top, zero guess)",
        lambda: mg_kernel.launch_core(mg, top, None, ft, False),
        lambda: mg_kernel.core_plain(mg, top, None, ft, False),
        mg_kernel.work("mg_core" + sfx, gt.nx, mg.nsmooth, dtype,
                       nsmooth_bottom=mg.nsmooth_bottom, with_guess=False,
                       want_r=False), bw, fp32)}
    for lv in reversed(peeled):
        g, gc = mg.grids[lv], mg.grids[lv - 1]
        f, vc = frame(rng, g, dtype), frame(rng, gc, dtype, 0.1)
        v = frame(rng, g, dtype, 0.1)
        guess = v if lv == fine else None           # as the cycle calls it
        want_r = lv == fine
        plan = mg_kernel.tile_plan(g.nx, mg.nsmooth, dtype,
                                   mg_kernel.flavour(mg))
        log(f"  mg_down{sfx} and mg_up{sfx} {g.nx}^2 plan: "
            f"{tile_plan_text(plan)}")
        times = {
            "mg_down" + sfx: time_pair(
                f"mg_down{sfx} ({label}, {g.nx}^2)",
                lambda: mg_kernel.launch_down(mg, lv, guess, f),
                lambda: mg_kernel.down_plain(mg, lv, guess, f),
                mg_kernel.work("mg_down" + sfx, g.nx, mg.nsmooth, dtype,
                               with_guess=guess is not None), bw, fp32),
            "mg_up" + sfx: time_pair(
                f"mg_up{sfx} ({label}, {g.nx}^2)",
                lambda: mg_kernel.launch_up(mg, lv, v, f, vc, want_r),
                lambda: mg_kernel.up_plain(mg, lv, v, f, vc, want_r),
                mg_kernel.work("mg_up" + sfx, g.nx, mg.nsmooth, dtype,
                               want_r=want_r), bw, fp32)}
        if lv == fine:
            out.update(times)
        out.update({(k, g.nx): t for k, t in times.items()})
    v, f = frame(rng, mg.soln_grid, dtype, 0.1), frame(rng, mg.soln_grid,
                                                       dtype)
    cyc = event_ms(lambda: mg_kernel.cycle(mg, v, f), 10)
    log(f"  one 1024^2 {label} cycle (1 core, {len(peeled)} down, "
        f"{len(peeled)} up): {cyc:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# the lm_atm interface kernels and the coefficient multigrid paths
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a Simulation's LMInterface: passes each call on and
    keeps its arguments, so the kernels can be checked on a real state."""

    def __init__(self, lm):
        self.lm = lm
        self.g = lm.g
        self.calls = {}

    def mac_vels(self, dt, *planes):
        self.calls["lm_mac"] = (dt, planes)
        return self.lm.mac_vels(dt, *planes)

    def rho_increment(self, dt, *planes):
        self.calls["lm_rho"] = (dt, planes)
        return self.lm.rho_increment(dt, *planes)

    def advect_terms(self, dt, *planes):
        self.calls["lm_states"] = (dt, planes)
        return self.lm.advect_terms(dt, *planes)


def lm_random_calls(nx, ny, dtype, seed):
    """(grid, calls) of the three stages on decisively signed random
    fields (u > 0, v < 0, as tests/test_lm_pallas.py makes them), the MAC
    velocities from the plain mac_vels."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.mesh.grid import Cartesian2d
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    g = Cartesian2d(nx, ny, ng=4, xmax=1.0, ymax=ny / nx)
    rng = np.random.default_rng(seed)

    def mk(lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, (g.qx, g.qy)),
                               dtype=dtype, device="cuda")

    vel = (mk(0.2, 1.2), mk(-1.2, -0.2)) + tuple(mk() for _ in range(7))
    rho = (mk(0.5, 1.5), mk(), mk())
    dt = 0.2 * g.dx
    um, vm = lm_kernel.mac_vels_plain(g, dt, *vel)
    return g, {"lm_mac": (dt, vel),
               "lm_rho": (dt, (rho[0], um, vm, rho[1], rho[2])),
               "lm_states": (dt, vel + (um, vm))}


def lm_bubble_calls(n, dtype, steps=3):
    """(grid, calls) of the three stages as lm_atm bubble's evolve makes
    them on the card, after `steps` kernel steps."""
    from pyro2_tpu_torch import Pyro

    p = Pyro("lm_atm", device="cuda", dtype=dtype)
    p.initialize_problem("bubble", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": 10 ** 6,
        "driver.tmax": 1.0e30})
    for _ in range(steps):
        p.single_step()
    rec = Recorder(p.sim.lm)
    p.sim.lm = rec
    p.single_step()
    p.sim.lm = rec.lm
    return rec.g, rec.calls


def lm_scales(g, calls):
    """The scale each stage's roundoff is held to: max|u_MAC|, |v_MAC| for
    mac_vels; for the increment and the advective terms, the sizes of the
    terms their differences cancel: 2 max|state| (max|u_MAC| / dx +
    max|v_MAC| / dy), times dt for rho, with the plain interface states."""
    from pyro2_tpu_torch.solvers.lm_atm import LM_atm_interface as lmi

    def amax(*ts):
        return max(float(t.abs().max()) for t in ts)

    dt, planes = calls["lm_rho"]
    rho, um, vm = planes[:3]
    s_rho = amax(*lmi.rho_states(g, g.dx, g.dy, dt, *planes))
    flow = amax(um) / g.dx + amax(vm) / g.dy
    dt, planes = calls["lm_states"]
    s_uv = amax(*lmi.states(g, g.dx, g.dy, dt, *planes))
    return {"lm_rho": abs(dt) * 2.0 * s_rho * flow,
            "lm_states": 2.0 * s_uv * flow}


def lm_compare(what, g, calls, dtype, tol, errs):
    """Each lm_atm kernel against its plain version on the recorded
    arguments; the MAC frames must be zero exactly where the plain
    version's are."""
    import torch

    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    lm = lm_kernel.LMInterface(g)
    scales = lm_scales(g, calls)
    rows = []
    for name, plain, launch in (
            ("lm_mac", lm_kernel.mac_vels_plain, lm.launch_mac),
            ("lm_rho", lm_kernel.rho_increment_plain, lm.launch_rho),
            ("lm_states", lm_kernel.advect_terms_plain, lm.launch_states)):
        dt, planes = calls[name]
        ref = plain(g, dt, *planes)
        got = launch(dt, *planes)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        err = max(float((a - b).abs().max()) for a, b in zip(ref, got))
        scale = scales.get(name, max(float(a.abs().max()) for a in ref))
        ok = err <= tol * scale and all(bool(torch.isfinite(b).all())
                                        for b in got)
        if name == "lm_mac":
            ok = ok and all(torch.equal(a == 0, b == 0)
                            for a, b in zip(ref, got))
        rows.append(f"{name} {err:.3e} (tol x {scale:.4g})")
        errs[name] = max(errs.get(name, 0.0), err)
        if not ok:
            raise AssertionError(f"lm_atm kernel disagrees with its plain "
                                 f"version: {name} {what} {dtype}")
    torch.cuda.synchronize()
    log(f"  ok  {what:18s} {g.nx}x{g.ny} {str(dtype)[6:]:8s} "
        + "; ".join(rows) + "; MAC zeros equal")


def lm_main_path(n, steps):
    """Pyro("lm_atm") bubble -> run_sim on CUDA float32 for `steps` steps
    after one untimed warm-up step, with every count reset just before and
    read just after; returns (pyro, launches by kernel, cycles/solve)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel

    p = Pyro("lm_atm")                  # default device: CUDA, float32
    p.initialize_problem("bubble", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps + 1,
        "driver.tmax": 1.0e30})
    sim = p.sim
    assert sim.cc_data.data.is_cuda
    assert sim.cc_data.data.dtype == torch.float32
    p.single_step()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, mg, stats = read_counts()
    no_padded_launches("lm_atm")
    no_sharded_launches("lm_atm")
    lm = dict(lm_kernel.launches)
    peeled = len(mg_kernel.split(make_mg(n, "periodic", 0.0, -1.0,
                                         torch.float32), torch.float32)[1])
    cycles = stats["cycles"]
    expect_mg = dict.fromkeys(mg, 0)
    expect_mg.update({"mg_core_vc": cycles, "mg_down_vc": cycles * peeled,
                      "mg_up_vc": cycles * peeled})
    if (sim.n != steps + 1 or lm != dict.fromkeys(LM_KERNELS, steps) or
            mg != expect_mg or cycles == 0 or stats["solves"] != 2 * steps
            or ctu or swe_kernel.launches or
            any(mol_kernel.launches.values())):
        raise AssertionError(
            f"lm_atm: {sim.n} steps, lm {lm}, multigrid {mg} for {cycles} "
            f"cycles in {stats['solves']} solves, CTU {ctu}, swe "
            f"{swe_kernel.launches}, MOL {mol_kernel.launches}; expected "
            f"{steps} + 1 steps, each lm kernel once a step, {expect_mg} "
            "and no other launch")
    g = sim.cc_data.grid
    data = interior(sim.cc_data.data, g)
    dens = interior(sim.cc_data.get_var("density"), g)
    if not bool(torch.isfinite(data).all()) or float(dens.min()) <= 0.0:
        raise AssertionError("lm_atm: the state is not finite or the "
                             "density not positive")
    vmax = float(interior(sim.cc_data.get_var("y-velocity"), g).abs().max())
    zps = n * n * steps / seconds
    log(f"  lm_atm bubble {n}x{n} f32: {steps} steps (after 1) in "
        f"{seconds:.3f} s, {1e3 * seconds / steps:.3f} ms/step, {zps:.4e} "
        f"zone-updates/s; {stats['solves']} solves, {cycles} cycles "
        f"({cycles / stats['solves']:.2f} per solve); launches lm {lm}, "
        f"mg_core_vc {mg['mg_core_vc']}, mg_down_vc {mg['mg_down_vc']}, "
        f"mg_up_vc {mg['mg_up_vc']} ({peeled} peeled), no other; t = "
        f"{sim.cc_data.t:.6g}, min rho {float(dens.min()):.6g}, max|v| "
        f"{vmax:.6g}")
    return p, {**lm, **{k: mg[k] for k in VC_KERNELS}}, cycles / stats[
        "solves"]


def general_path(n):
    """One GeneralMG2d solve on CUDA float32 with the operator of
    multigrid/examples/mg_test_general_dirichlet.py (alpha 1, beta = 2 +
    cos 2 pi x cos 2 pi y, gamma = (sin 2 pi x, sin 2 pi y), homogeneous
    Dirichlet, exact phi = sin 2 pi x sin 2 pi y), counts reset just before
    and read just after; returns the launches by kernel."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.mesh.grid import Grid2d
    from pyro2_tpu_torch.mesh.indexer import ai
    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d

    g = Grid2d(n, n, ng=1)
    x, y = g.x2d, g.y2d
    s2, c2 = np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y), \
        np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y)
    d = general_coeffs(g, 1.0 + 0 * x, 2.0 + c2, np.sin(2 * np.pi * x),
                       np.sin(2 * np.pi * y), torch.float32)
    rhs = (-16.0 * np.pi ** 2 * c2 + 2.0 * np.pi * np.cos(2 * np.pi * x) +
           2.0 * np.pi * np.cos(2 * np.pi * y) - 16.0 * np.pi ** 2 + 1.0) * s2
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mg = GeneralMG2d(n, n, coeffs=d)        # default device: CUDA, float32
    mg.init_zeros()
    mg.init_RHS(rhs)
    mg.solve(rtol=1.e-11)
    err = float(ai(mg.get_solution() - torch.as_tensor(
        s2, dtype=torch.float32, device="cuda"), g).norm())
    seconds = time.perf_counter() - t0
    ctu, launches, stats = read_counts()
    peeled = len(mg_kernel.split(mg, torch.float32)[1])
    cycles = mg.num_cycles
    expect = dict.fromkeys(launches, 0)
    expect.update({"mg_core_general": cycles,
                   "mg_down_general": cycles * peeled,
                   "mg_up_general": cycles * peeled})
    no_lm_launches("general multigrid")
    no_padded_launches("general multigrid")
    no_sharded_launches("general multigrid")
    # the truncation error of this problem falls as dx^2 (the JAX package's
    # example); at 1024^2 it is far below this bound
    if launches != expect or cycles == 0 or ctu or not err < 1e-3:
        raise AssertionError(f"general multigrid: launches {launches} for "
                             f"{cycles} cycles, CTU {ctu}, error {err}")
    log(f"  GeneralMG2d {n}^2 f32 (mg_test_general_dirichlet): {cycles} "
        f"cycles in {seconds:.3f} s, residual {mg.residual_error:.3e}, L2 "
        f"error from the exact solution {err:.3e}; launches "
        f"{ {k: launches[k] for k in GENERAL_KERNELS} }, no other")

    def solve():
        mg.init_zeros()
        mg.init_RHS(rhs)
        mg.solve(rtol=1.e-11)

    return {k: launches[k] for k in GENERAL_KERNELS}, solve


def lm_timing(calls, g, bw, fp32):
    """CUDA-event times of each lm_atm kernel and its plain version on the
    recorded bubble arguments, beside each kernel's bound."""
    import torch

    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    lm = lm_kernel.LMInterface(g)
    out = {}
    for name, plain, launch in (
            ("lm_mac", lm_kernel.mac_vels_plain, lm.launch_mac),
            ("lm_rho", lm_kernel.rho_increment_plain, lm.launch_rho),
            ("lm_states", lm_kernel.advect_terms_plain, lm.launch_states)):
        dt, planes = calls[name]
        t = lm_kernel.plan(name, g.nx, g.ny, g.ng, torch.float32)
        log(f"  {name} plan: {t.tx} x {t.ty} tiles ({t.gx * t.gy} blocks "
            f"of {t.threads}), halo {t.lo} below and {t.hi} above, "
            f"{t.smem} B of shared memory")
        out[name] = time_pair(
            f"{name} (bubble {g.nx}x{g.ny})",
            lambda: launch(dt, *planes),
            lambda: plain(g, dt, *planes),
            lm_kernel.work(name, g.nx, g.ny, torch.float32), bw, fp32)
    return out


def lm_peak_memory(calls, g):
    """The device bytes each lm_atm stage allocates in a call, which must
    be what allocating its outputs alone takes: a call allocates no
    scratch.  Counted by the allocator's running total of bytes allocated,
    which a free during the call (the garbage collector's) cannot hide,
    beside the peak above what was allocated before the call."""
    import gc

    import torch

    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    lm = lm_kernel.LMInterface(g)
    f32 = torch.float32

    def allocates(fn):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        total = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        total = torch.cuda.memory_stats()[
            "allocated_bytes.all.allocated"] - total
        del out
        return total, torch.cuda.max_memory_allocated() - base

    out = {}
    for name, launch, shapes in (
            ("lm_mac", lm.launch_mac, [(g.qx, g.qy)] * 2),
            ("lm_rho", lm.launch_rho, [(g.nx, g.ny)]),
            ("lm_states", lm.launch_states, [(g.nx, g.ny)] * 2)):
        dt, planes = calls[name]
        total, peak = allocates(lambda: launch(dt, *planes))
        alone, _ = allocates(lambda: [torch.empty(s, dtype=f32, device="cuda")
                                      for s in shapes])
        log(f"  {name}: a call allocates {total} B (peak {peak} B above "
            f"what was allocated before it); its outputs alone {alone} B")
        if total != alone:
            raise AssertionError(f"{name} allocates {total} B, not its "
                                 f"outputs' {alone} B")
        out[name] = total
    return out


def lm_correct_device_us(calls, g, bw):
    """Under the profiler: one call of each lm_atm stage on the recorded
    bubble arguments and one mg_correct at 1024^2, 512^2 and 256^2 each
    launch their one kernel once; their device us a launch, beside the
    bound."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    lm = lm_kernel.LMInterface(g)
    out = {}
    for name, launch in (("lm_mac", lm.launch_mac),
                         ("lm_rho", lm.launch_rho),
                         ("lm_states", lm.launch_states)):
        dt, planes = calls[name]
        out[name] = one_launch_each(
            lambda: launch(dt, *planes), 20, f"k_{name}",
            f"{name} calls (bubble {g.nx}x{g.ny})", name)
    rng = np.random.default_rng(29)
    for n in (1024, 512, 256):
        v = torch.as_tensor(rng.standard_normal((n + 2, n + 2)),
                            dtype=torch.float32, device="cuda")
        vc = torch.as_tensor(0.1 * rng.standard_normal(
            (n // 2 + 2, n // 2 + 2)), dtype=torch.float32, device="cuda")
        out[f"mg_correct {n}"] = one_launch_each(
            lambda: smk.launch_correct(v, vc), 20, "k_correct",
            f"mg_correct calls ({n}^2)", "mg_correct")
    for key, us in out.items():
        name, n = (key.split() + ["1024"])[:2]
        nbytes = (lm_kernel.work(name, g.nx, g.ny, torch.float32)[0]
                  if name.startswith("lm_") else
                  smk.work("mg_correct", bx=int(n), by=int(n),
                           dtype=torch.float32)[0])
        bound_us = 1e6 * nbytes / bw
        log(f"  {key}: {us:.3f} us a launch, bound {bound_us:.3f} us "
            f"(bytes), at {100 * bound_us / us:.1f}% of it")
    return out


def vc_build_ms(sim, reps=5):
    """Host-clock ms of building one of lm_atm's VarCoeffCCMG2d (the edge
    coefficients of every level) from the state, ending in a sync."""
    import torch

    rho = sim.cc_data.get_var("density")
    coeff2 = (1.0 / rho) * sim._t(sim.base["beta0"].full2d()) ** 2
    sim._vc_mg("phi", coeff2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sim._vc_mg("phi", coeff2)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    log(f"  VarCoeffCCMG2d build ({sim.cc_data.grid.nx}^2 f32): {ms:.3f} ms "
        f"per solve object (host clock, {reps} builds)")
    return ms


# ---------------------------------------------------------------------------
# the sharded multigrid (parallel/sharded_mg.py, csrc/mg_deep.cu)
# ---------------------------------------------------------------------------

SHARDED_KERNELS = ("mg_deep_smooth", "mg_correct")
# diffusion gaussian's Crank-Nicolson operator at 1024^2 (alpha 1, beta =
# dt k / 2 with dt = 2 dx^2), as the sharded levels of its solve use it
DIFF_AB = (1.0, (1.0 / 1024) ** 2)


def frame_from_global(A, ix, iy, px, py, dpx, dpy):
    """Block (ix, iy)'s deep frame of the global interior A on a px x py
    mesh, as parallel.mesh_comm.deep_pad_exchange(phys=False) fills it: a
    split axis takes the ring neighbours' strips (around the domain), an
    unsplit one zeros."""
    import torch

    nx, ny = A.shape
    bx, by = nx // px, ny // py
    rows = torch.arange(ix * bx - dpx, ix * bx + bx + dpx, device=A.device)
    cols = torch.arange(iy * by - dpy, iy * by + by + dpy, device=A.device)
    F = A[rows % nx][:, cols % ny].contiguous()
    if px == 1:
        F[(rows < 0) | (rows >= nx)] = 0.0
    if py == 1:
        F[:, (cols < 0) | (cols >= ny)] = 0.0
    return F


def deep_resid_scale(ab, planes, dx, v, f):
    """The size of the terms a residual of the deep frame cancels (as
    resid_scale)."""
    vmax, fmax = float(v.abs().max()), float(f.abs().max())
    if planes is None:
        return fmax + abs(ab[0]) * vmax + 8.0 * abs(ab[1]) * vmax / dx ** 2
    top = planes.abs().amax(dim=(1, 2)).tolist()
    if len(top) == 2:
        return fmax + 8.0 * max(top) * vmax
    alpha, bx, by, gx, gy = top
    return fmax + (alpha + 8.0 * max(bx, by) + 2.0 * (gx + gy)) * vmax


def sharded_compare(dtype, tol, errs):
    """mg_deep_smooth and mg_correct against their plain versions from the
    same inputs: (a) the 1x1 frames of the path (256^2, 512^2, 1024^2, one
    halo cell, d = 21, 10 sweeps) with each emit, and the correction; (b)
    every block of a 2x2 and of a 1x4 decomposition of 1024^2 (d = 21),
    Dirichlet and periodic edges, the frames filled from one global array
    as the exchange fills them; (c) Jacobi and Chebyshev, and the vc and
    general operators, at 256^2.  Records the worst |diff| of the path's
    1024^2 shapes in errs."""
    import numpy as np
    import torch

    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.parallel import (ShardedGeneralMG,
                                          ShardedVarCoeffMG, make_mesh)
    from pyro2_tpu_torch.parallel.sharded_mg import kernel_flags

    rng = np.random.default_rng(17)
    rows = []

    def rand(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=dtype, device="cuda")

    def check(what, kernel, ref, got, scale=None, record=False):
        err = float((ref - got).abs().max())
        if scale is None:
            scale = float(ref.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        rows.append((what, err, scale, ok))
        if record:
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not ok:
            raise AssertionError(f"sharded multigrid kernel disagrees with "
                                 f"its plain version: {what} {dtype}")

    def compare(what, vd, fd, flags, record=False, **kw):
        ref = smk.deep_smooth_plain(vd, fd, flags, **kw)
        got = smk.launch_deep_smooth(vd, fd, flags, **kw)
        check(f"{what} v", "mg_deep_smooth", ref[0], got[0], record=record)
        if ref[1] is not None:
            check(f"{what} {kw['emit']}", "mg_deep_smooth", ref[1], got[1],
                  deep_resid_scale(kw.get("ab"), kw.get("planes"), kw["dx"],
                                   ref[0], fd), record=record)

    neumann = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                     yrb="neumann")
    one = kernel_flags(neumann, 1, 1, 0, 0)
    for n in (256, 512, 1024):                   # (a) the path's frames
        vd, fd = rand(n + 2, n + 2, scale=0.1), rand(n + 2, n + 2)
        for emit in smk.EMITS:
            compare(f"1x1 {n}^2", vd, fd, one, record=n == 1024, dpx=1,
                    dpy=1, d=21, n_sweeps=10, dx=1.0 / n, dy=1.0 / n,
                    bc=neumann, px=1, py=1, ab=DIFF_AB, emit=emit)
        v, vc = rand(n + 2, n + 2), rand(n // 2 + 2, n // 2 + 2, scale=0.1)
        check(f"mg_correct {n}^2", "mg_correct", smk.correct_plain(v, vc),
              smk.launch_correct(v, vc), record=n == 1024)
    n = 1024                                     # (b) the blocks of 1024^2
    Av, Af = rand(n, n, scale=0.1), rand(n, n)
    for kinds in (("dirichlet",) * 4, ("periodic",) * 4):
        bc = bnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])
        for px, py in ((2, 2), (1, 4)):
            bx, by = n // px, n // py
            d = min([21] + ([bx] if px > 1 else []) + ([by] if py > 1
                                                       else []))
            dpx, dpy = (d if px > 1 else 1), (d if py > 1 else 1)
            for ix in range(px):
                for iy in range(py):
                    vd = frame_from_global(Av, ix, iy, px, py, dpx, dpy)
                    fd = frame_from_global(Af, ix, iy, px, py, dpx, dpy)
                    for emit in ("v_fc", "v_r"):
                        compare(f"{px}x{py} block ({ix}, {iy}) {kinds[0]}",
                                vd, fd, kernel_flags(bc, px, py, ix, iy),
                                dpx=dpx, dpy=dpy, d=d, n_sweeps=10,
                                dx=1.0 / n, dy=1.0 / n, bc=bc, px=px, py=py,
                                ab=DIFF_AB, emit=emit)
    n = 256                                      # (c) smoothers, operators
    vd, fd = rand(n + 2, n + 2, scale=0.1), rand(n + 2, n + 2)
    for smoother in ("jacobi", "chebyshev"):
        for emit in smk.EMITS:
            compare(f"{smoother} {n}^2", vd, fd, one, dpx=1, dpy=1, d=21,
                    n_sweeps=8 if smoother == "jacobi" else 4, dx=1.0 / n,
                    dy=1.0 / n, bc=neumann, px=1, py=1, ab=(0.0, -1.0),
                    emit=emit, smoother=smoother)
    mesh = make_mesh()
    for case in MG_CASES:
        name, op, edges, _ = case
        if op == "const":
            continue
        serial = make_case_mg(n, name, op, edges, dtype)
        kw = dict(xl_BC_type=edges[0], xr_BC_type=edges[1],
                  yl_BC_type=edges[2], yr_BC_type=edges[3], dtype=dtype)
        if op == "vc":
            smg = ShardedVarCoeffMG(n, n, mesh,
                                    coeffs=serial.aux["coeffs"][-1],
                                    coeffs_bc=serial.aux_bc["coeffs"], **kw)
        else:
            smg = ShardedGeneralMG(n, n, mesh, coeffs=general_coeffs(
                serial.grids[-1], *(serial.aux[c][-1] for c in
                                    ("alpha", "beta", "gamma_x",
                                     "gamma_y")), dtype), **kw)
        top = smg.nlevels - 1
        for smoother in smk.SMOOTHERS:
            for emit in ("v_fc", "v_r"):
                compare(f"{name} {smoother} {n}^2", vd, fd, one, dpx=1,
                        dpy=1, d=21, n_sweeps={"rbgs": 10, "jacobi": 8,
                                               "chebyshev": 4}[smoother],
                        dx=1.0 / n, dy=1.0 / n, bc=smg.bc, px=1, py=1,
                        planes=smg._planes[top], emit=emit,
                        smoother=smoother)
    n = 1024                                     # (d) sub-rounds
    dirichlet = bnd.BC(xlb="dirichlet", xrb="dirichlet", ylb="dirichlet",
                       yrb="dirichlet")
    for smoother in smk.SMOOTHERS:
        for px, bc in ((1, neumann), (2, dirichlet)):
            d = 21 if px == 1 else 2 * smk.REACH[smoother] * 25 + 1
            dp = 1 if px == 1 else d
            ix = px - 1
            vd = frame_from_global(Av, ix, 0, px, px, dp, dp)
            fd = frame_from_global(Af, ix, 0, px, px, dp, dp)
            plan = smk.deep_plan(n // px, n // px, dp, dp, 50, smoother,
                                 dtype)
            for emit in ("v_fc", "v_r"):
                compare(f"{px}x{px} block ({ix}, 0) {smoother} 50 sweeps "
                        f"in {plan.rounds} launches", vd, fd,
                        kernel_flags(bc, px, px, ix, 0), dpx=dp, dpy=dp, d=d,
                        n_sweeps=50, dx=1.0 / n, dy=1.0 / n, bc=bc, px=px,
                        py=px, ab=DIFF_AB, emit=emit, smoother=smoother)
            if plan.rounds < 2:
                raise AssertionError(f"{smoother} at 50 sweeps took one "
                                     "launch")
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r[1] / r[2])
    log(f"  ok  {str(dtype)[6:]:8s} {len(rows)} checks, worst {worst[0]}: "
        f"{worst[1]:.3e} (tol {tol:g} x {worst[2]:.3g})")
    for what, err, scale, _ in rows:
        if "50 sweeps" in what:
            log(f"      {what}: max|diff| {err:.3e} (scale {scale:.3g})")


def sharded_path(n, steps, dtype):
    """ShardedDiffusion gaussian on a 1x1 mesh (parallel.make_mesh() on the
    card) for `steps` steps with every count reset just before and read
    just after; returns (the ShardedDiffusion, seconds, launches by kernel,
    cycles of each solve)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.parallel import ShardedDiffusion, make_mesh
    from pyro2_tpu_torch.parallel import sharded_mg

    p = Pyro("diffusion")               # the runtime parameters, on CUDA
    p.initialize_problem("gaussian", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.device.type == "cuda"
    sd = ShardedDiffusion(p.rp, mesh, dtype=dtype)
    assert sd.phi_int.is_cuda and sd.phi_int.dtype == dtype
    torch.cuda.synchronize()
    reset_counts()
    cycles = []
    t0 = time.perf_counter()
    for _ in range(steps):
        sd.evolve()
        cycles.append(sd.smg.num_cycles)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, mg_launches, _ = read_counts()
    no_mol_launches("sharded diffusion")
    no_swe_launches("sharded diffusion")
    no_lm_launches("sharded diffusion")
    no_padded_launches("sharded diffusion")
    sharded = {k: n for k, n in sharded_mg_kernel.launches.items() if n}
    levels = sd.smg.nlevels - sd.smg.k_cross
    total = sharded_mg.stats["cycles"]
    expect_mg = dict.fromkeys(mg_launches, 0)
    expect_mg["mg_core"] = total
    expect = {"mg_deep_smooth": 2 * levels * total,
              "mg_correct": levels * total}
    if (ctu or mg_launches != expect_mg or sharded != expect or
            total != sum(cycles) or sharded_mg.stats["solves"] != steps):
        raise AssertionError(
            f"sharded diffusion: launches {sharded}, multigrid {mg_launches}"
            f" (CTU {ctu}) for {total} cycles of {levels} sharded levels, "
            f"expected {expect} and mg_core {total}")
    if not bool(torch.isfinite(sd.phi_int).all()):
        raise AssertionError("sharded diffusion: phi is not finite")
    zps = n * n * steps / seconds
    log(f"  ShardedDiffusion gaussian {n}x{n} {str(dtype)[6:]} on a 1x1 mesh:"
        f" {steps} steps in {seconds:.3f} s, {1e3 * seconds / steps:.3f} "
        f"ms/step, {zps:.4e} zone-updates/s; {steps} solves, {total} cycles "
        f"({total / steps:.2f} per solve), {levels} sharded levels above a "
        f"{2 ** sd.smg.k_cross}^2 core; launches {sharded}, mg_core "
        f"{mg_launches['mg_core']}, mg_down {mg_launches['mg_down']}, mg_up "
        f"{mg_launches['mg_up']}")
    return sd, seconds, {**sharded, "mg_core": mg_launches["mg_core"]}, \
        cycles


def sharded_vs_serial(n, steps, dtype, tol):
    """ShardedDiffusion on a 1x1 mesh against the serial diffusion (Pyro,
    CUDA) from the same parameters: the same cycle count in every solve and
    phi within tol max|phi|."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import MG

    sd, _, _, cycles = sharded_path(n, steps, dtype)
    p = Pyro("diffusion", dtype=dtype)
    p.initialize_problem("gaussian", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    serial = []
    for _ in range(steps):
        before = MG.stats["cycles"]
        p.single_step()
        serial.append(MG.stats["cycles"] - before)
    if dtype == torch.float64 and cycles != serial:
        raise AssertionError(f"ShardedDiffusion {n}^2: cycles per solve "
                             f"{cycles}, the serial diffusion's {serial}")
    return sharded_phi_check(sd, p, tol, f"cycles per solve {cycles}, "
                             f"serial {serial}")


def sharded_phi_check(sd, p, tol, note=""):
    """ShardedDiffusion's phi against the serial diffusion Pyro p after as
    many steps: max|diff| <= tol max|phi|."""
    g = p.sim.cc_data.grid
    ref = p.get_var("phi")[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    err = float((sd.get_phi() - ref).abs().max())
    scale = float(ref.abs().max())
    ok = sd.n == p.sim.n and err <= tol * scale
    log(f"  {'ok ' if ok else 'BAD'} ShardedDiffusion vs serial diffusion "
        f"{g.nx}^2 {str(sd.phi_int.dtype)[6:]}, {sd.n} steps: max|diff| "
        f"{err:.3e} (tol {tol:g} x {scale:.6g}) {note}")
    if not ok:
        raise AssertionError("ShardedDiffusion disagrees with the serial "
                             "diffusion")
    return err


def sharded_timing(sd, bw, fp32):
    """CUDA-event times of mg_deep_smooth and mg_correct and their plain
    versions as the finest level of the path's cycle calls them, and of
    mg_deep_smooth on a block of a 2x2 split of that level (d 21 toward its
    seams), each with its plan; returns (the times by entry, the two
    mg_deep_smooth calls by frame)."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.parallel.sharded_mg import kernel_flags

    smg = sd.smg
    top = smg.nlevels - 1
    geom = smg._deep_geom[top]
    lg = smg.local_grids[top]
    dtype = smg.dtype
    rng = np.random.default_rng(23)
    vd = torch.as_tensor(0.1 * rng.standard_normal(
        (lg.nx + 2 * geom["dpx"], lg.ny + 2 * geom["dpy"])), dtype=dtype,
        device="cuda")
    fd = torch.as_tensor(rng.standard_normal(tuple(vd.shape)), dtype=dtype,
                         device="cuda")
    kw = dict(dpx=geom["dpx"], dpy=geom["dpy"], d=geom["d"],
              n_sweeps=geom["sweeps_rb"][0], dx=lg.dx, dy=lg.dy, bc=smg.bc,
              px=1, py=1, ab=(smg.serial.alpha, smg.serial.beta),
              emit="v_fc")
    calls = {}
    out = {}
    b2, d2 = lg.nx // 2, 21
    flags2 = kernel_flags(smg.bc, 2, 2, 0, 0)
    vd2 = torch.as_tensor(0.1 * rng.standard_normal(
        (b2 + 2 * d2, b2 + 2 * d2)), dtype=dtype, device="cuda")
    fd2 = torch.as_tensor(rng.standard_normal(tuple(vd2.shape)),
                          dtype=dtype, device="cuda")
    kw2 = dict(kw, dpx=d2, dpy=d2, d=d2, px=2, py=2)
    for key, label, (v_, f_, fl, k_, b_) in (
            ("mg_deep_smooth", f"1x1 {lg.nx}^2 frame",
             (vd, fd, smg._flags, kw, lg.nx)),
            ("mg_deep_smooth 2x2", f"block (0, 0) of a 2x2 split, "
             f"{b2}^2 + d {d2}", (vd2, fd2, flags2, kw2, b2))):
        plan = smk.deep_plan(b_, b_, k_["dpx"], k_["dpy"], k_["n_sweeps"],
                             "rbgs", dtype)
        log(f"  mg_deep_smooth {label} plan: {plan.tx}^2 tiles "
            f"({plan.gx * plan.gy} blocks of {plan.threads}), halo "
            f"{plan.halo}, {plan.rounds} launch(es) of "
            f"{plan.round_iters()} sweeps, boxes {plan.bh} x {plan.bw}, "
            f"{plan.smem} B of shared memory")
        calls[label] = (lambda v_=v_, f_=f_, fl=fl, k_=k_:
                        smk.launch_deep_smooth(v_, f_, fl, **k_))
        out[key] = time_pair(
            f"mg_deep_smooth ({label}, d {k_['d']}, {k_['n_sweeps']} "
            "sweeps, v_fc)", calls[label],
            lambda v_=v_, f_=f_, fl=fl, k_=k_:
                smk.deep_smooth_plain(v_, f_, fl, **k_),
            smk.work("mg_deep_smooth", bx=b_, by=b_, dtype=dtype,
                     dpx=k_["dpx"], dpy=k_["dpy"], d=k_["d"],
                     n_sweeps=k_["n_sweeps"], flags=fl, emit="v_fc"),
            bw, fp32)
    v = torch.as_tensor(rng.standard_normal((lg.nx + 2, lg.ny + 2)),
                        dtype=dtype, device="cuda")
    vc = torch.as_tensor(0.1 * rng.standard_normal(
        (lg.nx // 2 + 2, lg.ny // 2 + 2)), dtype=dtype, device="cuda")
    out["mg_correct"] = time_pair(
        f"mg_correct ({lg.nx}^2)", lambda: smk.launch_correct(v, vc),
        lambda: smk.correct_plain(v, vc),
        smk.work("mg_correct", bx=lg.nx, by=lg.ny, dtype=dtype), bw, fp32)
    return out, calls


def core_barriers(top, nsmooth, nsmooth_bottom, warps, cluster):
    """The barriers one core launch passes, by kind, as mg_vcycle.cu's
    k_core ends its phases: the cluster's (every thread of its CTAs), the
    block's (__syncthreads), a named barrier of 2..16 warps, or one warp's
    __syncwarp.  cluster is mg_kernel.core_cluster's (CTAs, first spread
    level)."""
    kinds = {"cluster": 0, "block": 0, "named": 0, "warp": 0}
    first = cluster[1]

    def add(lv, n):
        w = warps[lv]
        kind = "cluster" if lv >= first else "warp" if w == 1 else \
            "block" if w >= warps[top] else "named"
        kinds[kind] += n

    add(top, 1)                                         # the load
    for lv in range(top, 0, -1):        # descent: sweeps, ghosts, restrict
        add(lv, 2 * nsmooth + (1 if lv >= first else 2))
        if lv >= first:
            kinds["block"] += 2                         # the halo rows
    add(0, 2 * nsmooth_bottom + 1)                      # the bottom
    for lv in range(1, top + 1):        # ascent: prolong, sweeps, ghosts
        add(lv, 2 * nsmooth + (2 if lv >= first else 3))
        if lv >= first:
            kinds["block"] += 2
    if top >= first:                    # before any CTA of the cluster exits
        kinds["cluster"] += 1
    return kinds


def core_schedule_log(mg, label):
    """The core's schedule at the 1024^2 float32 cycle's top: the warps of
    each level, the cluster, and its barriers by kind against the first
    design's block-wide ones."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    top, _ = mg_kernel.split(mg, torch.float32)
    warps = mg_kernel.core_schedule(top)
    cluster = mg_kernel.core_cluster(top)
    first = top * (2 * mg.nsmooth + 1) * 2 + 1 + 2 * mg.nsmooth_bottom
    bars = core_barriers(top, mg.nsmooth, mg.nsmooth_bottom, warps, cluster)
    log(f"  mg_core{mg_kernel.FLAVOURS[mg_kernel.flavour(mg)][0]} "
        f"({label}, {2 ** (top + 1)}^2 top): warps {warps}, cluster "
        f"{cluster}, barriers {bars}; the first design: {first} "
        "block-wide barriers of 1024 threads")


def core_on_sharded_data(sd):
    """The core's time on the coarse right-hand sides one ShardedDiffusion
    step hands it, against random data of the same size and of subnormal
    size, with the share of subnormal values in each: whether the data
    sets the core's pace."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    seen, core = [], mg_kernel.core

    def spy(mg, top, v, f, want_r):
        seen.append((mg, top, f.clone()))
        return core(mg, top, v, f, want_r)

    mg_kernel.core = spy
    try:
        sd.evolve()
    finally:
        mg_kernel.core = core
    torch.cuda.synchronize()
    tiny = torch.finfo(torch.float32).tiny
    rng = np.random.default_rng(29)

    def sub(a):
        return float(((a != 0) & (a.abs() < tiny)).float().mean())

    def timed(what, mg, top, f):
        run = lambda: mg_kernel.launch_core(mg, top, None, f, False)
        v = run()[0]
        event_ms(run, 2)
        ms = event_ms(run, 10)
        log(f"    {what}: {ms:.4f} ms; max|f| {float(f.abs().max()):.3e}, "
            f"subnormal share of f {sub(f):.3f}, of the output v "
            f"{sub(v):.3f}")

    log(f"  mg_core on one ShardedDiffusion step's coarse problems "
        f"({len(seen)} cycles) and on random data:")
    for k, (mg, top, f) in enumerate(seen):
        timed(f"cycle {k + 1} of the solve", mg, top, f)
    mg, top, f = seen[-1]
    g = mg.grids[top]
    rand = frame(rng, g, torch.float32, float(f.abs().max()))
    timed("random, scaled by the last cycle's max|f|", mg, top, rand)
    timed("random, max|f| 1", mg, top, frame(rng, g, torch.float32))
    timed("random, max|f| 1e-36", mg, top,
          frame(rng, g, torch.float32, 1e-36))


# ---------------------------------------------------------------------------
# phase 5l: the plain structure of the sharded multigrid on the card
# (use_pallas=False and comm_mode="sweep"), through the half-sweep kernel
# mg_sweep, k_deep, k_correct and the serial kernels' replicated coarse
# cycle
# ---------------------------------------------------------------------------

# the operators of the phase: (operator, MG_CASES name, edges), one edge
# kind each of Neumann, periodic (with lm_atm's Neumann / Dirichlet y) and
# Dirichlet
A20_CASES = (("const", "neumann_helmholtz", ("neumann",) * 4),
             ("vc", "vc_lm_edges", LM_EDGES),
             ("general", "general_dirichlet", ("dirichlet",) * 4))
# the plain structure's two schedules
A20_STRUCTURES = (("plain deep", {"use_pallas": False}),
                  ("sweep", {"comm_mode": "sweep"}))


def a20_mg(op, name, edges, n, dtype, device="cuda", **kw):
    """A ShardedMG, ShardedVarCoeffMG or ShardedGeneralMG of one of
    A20_CASES (the operator of make_case_mg's serial object) on the 1x1
    mesh of make_mesh(device=...)."""
    from pyro2_tpu_torch.parallel import (ShardedGeneralMG, ShardedMG,
                                          ShardedVarCoeffMG, make_mesh)

    serial = make_case_mg(n, name, op, edges, dtype)
    mesh = make_mesh(device=device)
    kw = dict(xl_BC_type=edges[0], xr_BC_type=edges[1],
              yl_BC_type=edges[2], yr_BC_type=edges[3], dtype=dtype, **kw)
    if op == "const":
        return ShardedMG(n, n, mesh, alpha=serial.alpha, beta=serial.beta,
                         **kw)
    if op == "vc":
        return ShardedVarCoeffMG(n, n, mesh, coeffs=serial.aux["coeffs"][-1],
                                 coeffs_bc=serial.aux_bc["coeffs"], **kw)
    return ShardedGeneralMG(n, n, mesh, coeffs=general_coeffs(
        serial.grids[-1], *(serial.aux[c][-1] for c in
                            ("alpha", "beta", "gamma_x", "gamma_y")), dtype),
        **kw)


def a20_rhs(n, dtype, device="cuda"):
    """A random interior right-hand side from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(41)
    return torch.as_tensor(rng.standard_normal((n, n)), dtype=dtype,
                           device=device)


class plain_guard:
    """While open, every plain version of the multigrid (the sharded
    kernels', the serial kernels' and the serial classes' smoothers,
    residuals and cycle) raises on a CUDA tensor."""

    def __enter__(self):
        import torch

        from pyro2_tpu_torch.multigrid import mg_kernel
        from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
        from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
        from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
        from pyro2_tpu_torch.multigrid.variable_coeff_MG import \
            VarCoeffCCMG2d

        def guarded(fn, what):
            def g(*args, **kw):
                for a in list(args) + list(kw.values()):
                    if isinstance(a, torch.Tensor) and a.is_cuda:
                        raise AssertionError(f"the plain version {what} "
                                             "ran on a CUDA tensor")
                return fn(*args, **kw)
            return g

        self.saved = []
        targets = [(smk, n) for n in ("deep_smooth_plain", "correct_plain",
                                      "sweep_plain")]
        targets += [(mg_kernel, n) for n in ("core_plain", "down_plain",
                                             "up_plain")]
        for cls in (CellCenterMG2d, VarCoeffCCMG2d, GeneralMG2d):
            targets += [(cls, n) for n in ("_smooth_once", "_smooth_n",
                                           "_residual", "_v_cycle")
                        if n in vars(cls)]
        for owner, n in targets:
            fn = getattr(owner, n)
            self.saved.append((owner, n, fn))
            setattr(owner, n, guarded(fn, f"{getattr(owner, '__name__')}."
                                          f"{n}"))
        return self

    def __exit__(self, *exc):
        for owner, n, fn in reversed(self.saved):
            setattr(owner, n, fn)
        return False


def sweep_compare(dtype, tol, errs):
    """mg_sweep against sweep_plain from the same inputs: every block of a
    2x2 and a 1x4 split of 1024^2, the one-ghost frames from one global
    array as the exchange fills them (a split axis's ghosts the ring
    neighbours' strips, an unsplit one's zeros, which the kernel's refresh
    fills), with Dirichlet, Neumann and periodic edges, the constant, vc
    and general operators (random planes of each block's frame), each
    colour pass and each residual emit; then the 1x1 frames of every level
    of a 1024^2 solve, 1024^2 down to 2x2, Neumann.  Frames to tol
    max|v|, residuals to tol of the terms they cancel.  Records the worst
    |diff| in errs and returns (checks, checks equal by bits)."""
    import numpy as np
    import torch

    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.parallel.sharded_mg import kernel_flags

    rng = np.random.default_rng(43)
    rows = []

    def rand(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=dtype, device="cuda")

    def planes_of(ncoef, shape):
        if ncoef == 0:
            return None
        p = torch.as_tensor(rng.uniform(1.0, 3.0, (ncoef,) + shape),
                            dtype=dtype, device="cuda")
        if ncoef == 5:
            p[0] *= -1.0
            p[3:] = torch.as_tensor(rng.uniform(-0.5, 0.5, (2,) + shape),
                                    dtype=dtype, device="cuda")
        return p

    def compare(what, v, f, flags, **kw):
        ref = smk.sweep_plain(v, f, flags, **kw)
        got = smk.launch_sweep(v, f, flags, **kw)
        pairs = [("v", ref[0], got[0], float(ref[0].abs().max()))]
        if ref[1] is not None:
            pairs.append((kw["emit"], ref[1], got[1], deep_resid_scale(
                kw.get("ab"), kw.get("planes"), kw["dx"], ref[0], f)))
        for part, a, b, scale in pairs:
            err = float((a - b).abs().max())
            ok = bool(torch.isfinite(b).all()) and err <= tol * scale
            rows.append((f"{what} {part}", err, scale, ok,
                         bool(torch.equal(a, b))))
            errs["mg_sweep"] = max(errs.get("mg_sweep", 0.0), err)
            if not ok:
                raise AssertionError(f"mg_sweep disagrees with its plain "
                                     f"version: {what} {part} {dtype}")

    calls = ((0, "v"), (1, "v"), (None, "v_fc"), (None, "v_r"))
    n = 1024
    Av, Af = rand(n, n, scale=0.1), rand(n, n)
    for kinds in (("dirichlet",) * 4, ("neumann",) * 4, ("periodic",) * 4):
        bc = bnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])
        for px, py in ((2, 2), (1, 4)):
            bx, by = n // px, n // py
            for ix in range(px):
                for iy in range(py):
                    v = frame_from_global(Av, ix, iy, px, py, 1, 1)
                    f = frame_from_global(Af, ix, iy, px, py, 1, 1)
                    flags = kernel_flags(bc, px, py, ix, iy)
                    for ncoef in (0, 2, 5):
                        planes = planes_of(ncoef, (bx + 2, by + 2))
                        for colour, emit in calls:
                            compare(f"{px}x{py} block ({ix}, {iy}) "
                                    f"{kinds[0]} ncoef {ncoef} colour "
                                    f"{colour}", v, f, flags, colour=colour,
                                    dx=1.0 / n, dy=1.0 / n, bc=bc, px=px,
                                    py=py, ab=DIFF_AB if ncoef == 0 else
                                    None, planes=planes, emit=emit)
    neumann = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                     yrb="neumann")
    one = kernel_flags(neumann, 1, 1, 0, 0)
    m = n
    while m >= 2:                               # every level to 2x2
        v, f = rand(m + 2, m + 2, scale=0.1), rand(m + 2, m + 2)
        for colour, emit in calls:
            compare(f"1x1 {m}^2 colour {colour}", v, f, one, colour=colour,
                    dx=1.0 / m, dy=1.0 / m, bc=neumann, px=1, py=1,
                    ab=(1.0, (1.0 / m) ** 2), emit=emit)
        m //= 2
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r[1] / r[2])
    bits = sum(r[4] for r in rows)
    log(f"  ok  {str(dtype)[6:]:8s} {len(rows)} checks, {bits} equal by "
        f"bits, worst {worst[0]}: {worst[1]:.3e} (tol {tol:g} x "
        f"{worst[2]:.3g})")
    return len(rows), bits


def a20_solve(mg, f):
    """One solve of mg from a zero guess with every count reset just before
    and read just after: (seconds, sharded kernel launches, serial kernel
    launches); the launches must be the plan's per cycle times the cycles,
    and no other kernel may launch."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.parallel import sharded_mg

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mg.init_zeros()
    mg.init_RHS(f)
    mg.solve(rtol=1e-11)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctu, serial, _ = read_counts()
    sharded = {k: n for k, n in sharded_mg_kernel.launches.items() if n}
    serial = {k: n for k, n in serial.items() if n}
    want = {k: n * mg.num_cycles for k, n in mg.plan.launches.items()}
    if ({**sharded, **serial} != want or ctu or
            sharded_mg.stats["cycles"] != mg.num_cycles):
        raise AssertionError(f"plain sharded solve: launched {sharded}, "
                             f"{serial} (CTU {ctu}) in {mg.num_cycles} "
                             f"cycles, the plan {mg.plan.launches} a cycle")
    no_mol_launches("plain sharded solve")
    no_swe_launches("plain sharded solve")
    no_lm_launches("plain sharded solve")
    no_padded_launches("plain sharded solve")
    if not bool(torch.isfinite(mg.v_int).all()):
        raise AssertionError("plain sharded solve: v is not finite")
    return seconds, sharded, serial


def a20_solves(smi):
    """The three operators' plain structures on make_mesh()'s 1x1 mesh:
    256^2 float64 (the CPU plain structure's cycles, the solution to 1e-12
    max|v|), 1024^2 float32 (to 1e-5 max|v| of the kernel structure's
    solution), deep against sweep by bits, launches a cycle equal to the
    plan; every plain version guarded.  Returns ({operator: (ms a solve
    plain deep, sweep, kernel structure, cycles)} at 1024^2 f32, the
    mg_sweep launches of the 1024^2 f32 solves)."""
    import torch

    out, sweep_launches = {}, 0
    for n, dtype, tol in ((256, torch.float64, 1e-12),
                          (1024, torch.float32, 1e-5)):
        for op, name, edges in A20_CASES:
            f = a20_rhs(n, dtype)
            if dtype == torch.float64:
                cpu = a20_mg(op, name, edges, n, dtype, device="cpu",
                             use_pallas=False)
                t0 = time.perf_counter()
                cpu.init_zeros()
                cpu.init_RHS(f.cpu())
                cpu.solve(rtol=1e-11)
                cpu_s = time.perf_counter() - t0
                ref, ref_cycles = cpu.v_int.to("cuda"), cpu.num_cycles
                ref_what = f"the CPU plain structure ({cpu_s:.2f} s)"
            else:
                kern = a20_mg(op, name, edges, n, dtype, use_pallas=True)
                with plain_guard():
                    k_s = a20_solve(kern, f)[0]
                ref, ref_cycles = kern.v_int, kern.num_cycles
                ref_what = "the kernel structure"
            sols = {}
            with plain_guard():
                for label, kw in A20_STRUCTURES:
                    mg = a20_mg(op, name, edges, n, dtype, **kw)
                    a20_solve(mg, f)                 # warm-up
                    s, sharded, serial = a20_solve(mg, f)
                    sols[label] = (mg.v_int, mg.num_cycles, s)
                    if dtype == torch.float32:
                        sweep_launches += sharded.get("mg_sweep", 0)
                    scale = float(ref.abs().max())
                    err = float((mg.v_int - ref).abs().max())
                    ok = err <= tol * scale and (
                        dtype == torch.float32 or
                        mg.num_cycles == ref_cycles)
                    log(f"  {'ok ' if ok else 'BAD'} {type(mg).__name__} "
                        f"{label} {n}^2 {str(dtype)[6:]} ({name}): "
                        f"{mg.num_cycles} cycles ({ref_cycles} in "
                        f"{ref_what}), max|diff| {err:.3e} (tol {tol:g} x "
                        f"{scale:.6g}); {1e3 * s:.2f} ms a solve, host "
                        f"clock; launches {sharded} {serial} [{smi}]")
                    if not ok:
                        raise AssertionError(
                            f"the plain sharded structure disagrees: {op} "
                            f"{label} {n}^2 {dtype}")
            (vd, cd, sd), (vs, cs, ss) = sols["plain deep"], sols["sweep"]
            if cd != cs or not torch.equal(vd, vs):
                raise AssertionError(f"deep and sweep schedules differ on "
                                     f"the card: {op} {n}^2 {dtype}")
            log(f"  deep equals sweep by bits on the card: {op} {n}^2 "
                f"{str(dtype)[6:]}, {cd} cycles")
            if dtype == torch.float32:
                out[op] = (1e3 * sd, 1e3 * ss, 1e3 * k_s, cd, ref_cycles)
            torch.cuda.empty_cache()
    return out, sweep_launches


def coarse_cycle_check(dtype, tol):
    """mg_kernel.coarse_cycle from each level above CORE_MAX of the three
    operators' 1024^2 serial objects against serial._v_cycle from the
    same level (a zero guess): to tol max|v|, launching one core and a
    down and an up a level above it."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    rng = np.random.default_rng(47)
    for op, name, edges in A20_CASES:
        serial = make_case_mg(1024, name, op, edges, dtype)
        top = mg_kernel.split(serial, dtype)[0]
        for kc in range(top + 1, serial.nlevels, 2):
            g = serial.grids[kc]
            f = frame(rng, g, dtype)
            f[0], f[-1], f[:, 0], f[:, -1] = 0.0, 0.0, 0.0, 0.0
            ref = serial._v_cycle(kc, torch.zeros_like(f), f)
            reset_counts()
            with plain_guard():
                got = mg_kernel.coarse_cycle(serial, kc, f)
            torch.cuda.synchronize()
            launched = {k: n for k, n in mg_kernel.launches.items() if n}
            sfx = mg_kernel.FLAVOURS[op][0]
            want = {f"mg_core{sfx}": 1, f"mg_down{sfx}": kc - top,
                    f"mg_up{sfx}": kc - top}
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            ok = launched == want and err <= tol * scale
            log(f"  {'ok ' if ok else 'BAD'} coarse_cycle {op} from "
                f"{g.nx}^2 (core top {2 ** (top + 1)}^2) "
                f"{str(dtype)[6:]}: max|diff| {err:.3e} (tol {tol:g} x "
                f"{scale:.6g}), equal by bits: "
                f"{bool(torch.equal(got, ref))}; launches {launched}")
            if not ok:
                raise AssertionError(f"coarse_cycle disagrees with "
                                     f"_v_cycle: {op} {g.nx}^2 {dtype}")
        torch.cuda.empty_cache()


def sweep_timing(bw, fp32):
    """CUDA-event times of mg_sweep and sweep_plain (one red pass; the
    residual restriction) on the 1x1 frame of a 1024^2 level and on a
    256^2 block of a 4x4 split (its seam flags), constant operator,
    float32; returns (the 1024^2 colour pass's times, the calls by label
    for the profiler)."""
    import numpy as np
    import torch

    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.parallel.sharded_mg import kernel_flags

    rng = np.random.default_rng(53)
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    out, calls = {}, {}
    for label, b, p, ix in (("1x1 1024^2 frame", 1024, 1, 0),
                            ("256^2 block (1, 1) of a 4x4 split", 256, 4,
                             1)):
        v = torch.as_tensor(0.1 * rng.standard_normal((b + 2, b + 2)),
                            dtype=torch.float32, device="cuda")
        f = torch.as_tensor(rng.standard_normal((b + 2, b + 2)),
                            dtype=torch.float32, device="cuda")
        flags = kernel_flags(bc, p, p, ix, ix)
        for colour, emit in ((0, "v"), (None, "v_fc")):
            kw = dict(colour=colour, dx=1.0 / 1024, dy=1.0 / 1024, bc=bc,
                      px=p, py=p, ab=DIFF_AB, emit=emit)
            what = f"{label}, {'red pass' if colour == 0 else emit}"
            call = (lambda v=v, f=f, fl=flags, kw=kw:
                    smk.launch_sweep(v, f, fl, **kw))
            calls[what] = call
            out[what] = time_pair(
                f"mg_sweep ({what})", call,
                lambda v=v, f=f, fl=flags, kw=kw:
                    smk.sweep_plain(v, f, fl, **kw),
                smk.work("mg_sweep", bx=b, by=b, dtype=torch.float32,
                         flags=flags, emit=emit, colour=colour), bw, fp32)
    return out["1x1 1024^2 frame, red pass"], calls


def profiler_records(swe_call, smi):
    """An open question (PERF.md section 7): after phase 7's profiles, a
    torch.profiler session of five k_swe launches has recorded fewer than
    five.  Logs, per session, the launches the wrapper counted, the launch
    calls and k_swe kernels the profiler recorded and their starts (us
    after the first launch call, to place a missing one): with the 20 ms
    pad of `profiled`, its retries' 0.5 s pad, and the CUDA activity
    alone; then `profiled` with its retries.  Checks nothing: the checks
    that need whole sessions retry them (profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sstep, sU, st, sdt = swe_call
    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    log(f"[profiler records after phase 7's profiles: sessions of 5 k_swe "
        f"launches (swe quad 1024^2 float32); {smi}]")
    for label, pad, acts in (("20 ms pad", PROFILER_PAD_S, (cpu, cuda)),
                             ("20 ms pad", PROFILER_PAD_S, (cpu, cuda)),
                             ("0.5 s pad", PROFILER_RETRY_PAD_S,
                              (cpu, cuda)),
                             ("CUDA activity alone", PROFILER_PAD_S,
                              (cuda,))):
        sstep.launch(sU, st, sdt)
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=list(acts)) as prof:
            time.sleep(pad)
            for _ in range(5):
                sstep.launch(sU, st, sdt)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        dev = sorted(e.time_range.start for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "k_swe<" in e.name)
        calls = sorted(e.time_range.start for e in events
                       if "LaunchKernel" in e.name and
                       e.device_type != torch.autograd.DeviceType.CUDA)
        t0 = (calls or dev or [0.0])[0]
        log(f"  {label}: the wrapper counted {launch_count('swe_step')}, "
            f"the profiler recorded {len(calls)} launch calls at "
            f"{[round(c - t0, 1) for c in calls]} us and {len(dev)} k_swe "
            f"at {[round(d - t0, 1) for d in dev]} us")
    rows = device_kernels(lambda: sstep.launch(sU, st, sdt), 5,
                          ("k_swe", "swe_step"))
    log("  profiled, with its retries: " +
        (f"{sum(n for key, n, _ in rows if 'k_swe<' in key)} k_swe of 5"
         if rows else "no session whole"))


def profile_steps(step, steps, label):
    """torch.profiler over `steps` main-path steps (calls of `step`):
    device time by kernel and the device's busy share of the wall time."""
    import re

    found, wall_us = profiled(step, steps)
    if not found:
        log(f"[profile: {steps} main-path steps, {label}]")
        log(f"  wall {wall_us / steps:.1f} us/step; device time not "
            "measured (the profiler recorded no device kernel)")
        return
    rows = []
    for key, count, dev_us in found:
        m = re.search(r"(k_[a-z0-9_]+)<([^<>]*)>", key)
        name = (f"{kernel_source(m.group(1))} "
                f"{kernel_name(m.group(1), m.group(2).split(', '))}"
                if m else key[:72])
        rows.append((dev_us, count, name))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f"[profile: {steps} main-path steps, {label}]")
    log(f"  wall {wall_us / steps:.1f} us/step, device busy "
        f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f}% "
        f"busy, {100 - 100 * busy_us / wall_us:.1f}% idle)")
    for dev_us, count, name in rows[:14]:
        log(f"  {dev_us / steps:9.2f} us/step  {count // steps:3d}x  {name}")


def ptxas_summary(text):
    """One line per compiled kernel from ptxas' verbose report: its name
    and type, registers, shared memory, stack frame and spills."""
    import re

    out, name, info = [], None, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            if name:
                out.append(f"{name}: {', '.join(info)}")
            k = re.search(r"(k_[a-z0-9_]+)I((?:Li\d+E|Lb\dE|[fd])+)E",
                          m.group(1))
            args = [{"f": "float", "d": "double"}.get(t, t) for t in
                     re.findall(r"Li(\d+)E|Lb(\d)E|([fd])", k.group(2))
                     for t in t if t] if k else []
            name = kernel_name(k.group(1), args) if k else m.group(1)[:60]
            info = []
            continue
        for pat in (r"Used (\d+ registers)", r"(\d+ bytes smem)",
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores"):
            m = re.search(pat, line)
            if m and name:
                item = m.group(1) if m.lastindex == 1 else \
                    f"{m.group(1)} B stack, {m.group(2)} B spilled"
                # the entry's own frame comes first; callees' follow
                if "stack" not in item or not any("stack" in i
                                                  for i in info):
                    info.append(item)
    if name:
        out.append(f"{name}: {', '.join(info)}")
    return out


# the operator template argument of the multigrid kernels (mg_vcycle.cu,
# mg_deep.cu), and the smoother and emit ones of mg_deep.cu's k_deep
OPS = {"0": "const, ", "1": "vc, ", "2": "general, "}
DEEP_SMOOTHERS = ("rbgs, ", "jacobi, ", "chebyshev, ")
DEEP_EMITS = ("v, ", "v_fc, ", "v_r, ")


def kernel_name(kernel, args):
    """A kernel and its template arguments, named: args as a profiler key
    or a mangled name gives them ("0", "float", "true" or "1")."""
    if kernel == "k_ctu":               # <T, NV, SPH, DEVDT, STAGES>
        geometry = "spherical" if args[2] in ("true", "1") else "cartesian"
        devdt = ", device dt" if args[3:4] in (["true"], ["1"]) else ""
        stages = f", stages {args[4]}" if args[4:5] not in ([], ["4"]) \
            else ""
        return f"k_ctu<{args[0]}, nvar {args[1]}, {geometry}{devdt}" \
            f"{stages}>"
    if kernel == "k_swe" and len(args) == 3:   # <T, NV, DEVDT>
        devdt = ", device dt" if args[2] in ("true", "1") else ""
        return f"k_swe<{args[0]}, {args[1]}{devdt}>"
    if kernel in ("k_rk", "k_fv4") and len(args) == 3:   # <T, NV, X>
        if args[2] in ("true", "1"):
            return f"{kernel}<{args[0]}, {args[1]}, extended>"
        return f"{kernel}<{args[0]}, {args[1]}>"
    if kernel == "k_deep" and len(args) == 4:
        return (f"k_deep<{OPS[args[0]]}{DEEP_SMOOTHERS[int(args[1])]}"
                f"{DEEP_EMITS[int(args[2])]}{args[3]}>")
    if kernel == "k_sweep" and len(args) == 3:
        return f"k_sweep<{OPS[args[0]]}{DEEP_EMITS[int(args[1])]}{args[2]}>"
    return f"{kernel}<{''.join(OPS.get(a, a + ', ') for a in args[:-1])}" \
        f"{args[-1]}>"


def kernel_source(kernel):
    """The source file of a device kernel, by its name."""
    if kernel in ("k_core", "k_down", "k_up"):
        return "mg_vcycle.cu"
    if kernel in ("k_deep", "k_correct", "k_sweep"):
        return "mg_deep.cu"
    if kernel.startswith("k_lm_"):
        return "lm_interface.cu"
    if kernel in ("k_rk", "k_fv4"):
        return "mol_substep.cu"
    if kernel.startswith("k_swe"):
        return "swe_step.cu"
    return "ctu_step.cu"


def event_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# -- the tiled descent and ascent against the parent's kernels ----------------
#
# `python3 chip_smoke.py --mg-tiles [--parent DIR]` runs phase 4c alone (the
# card line, mg_vcycle.cu's build and ptxas lines, the checks, the timing);
# the full run makes phase 4c's checks after phase 4.  DIR is a `git
# archive` of the commit to hold k_down and k_up to: its mg_kernel.py and
# csrc/ are built and loaded beside this tree's.

# the levels of phase 4c's checks, and the cases (MG_CASES: every operator
# and edge kind)
TILE_CHECK_SIZES = (1024, 4096)


def parent_mg_kernel(root):
    """The mg_kernel module of the tree at `root`, loaded beside this
    tree's under another name, its library built from that tree's
    mg_vcycle.cu and headers (cuda_build names the library by their
    hash)."""
    import importlib.util
    from pathlib import Path

    path = Path(root) / "pyro2_tpu_torch" / "multigrid" / "mg_kernel.py"
    spec = importlib.util.spec_from_file_location("parent_mg_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = Path(root) / "pyro2_tpu_torch" / "csrc" / "mg_vcycle.cu"
    return mod


def same_bits(a, b):
    """a and b equal bit for bit (+0.0 and -0.0 apart)."""
    import torch

    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(ints), b.view(ints))


def tile_ptxas(libs):
    """Build mg_vcycle.cu of each (label, module), all at once, with
    ptxas' report and log its k_down and k_up lines; returns {label:
    {kernel: line}}."""
    from pyro2_tpu_torch.util import cuda_build

    out = {}
    built = cuda_build.build_many([mod.SOURCE for _, mod in libs],
                                  verbose=True)
    for (label, mod), (_, seconds, ptxas) in zip(libs, built):
        mod._lib = None
        mod._load()
        log(f"  {label}: mg_vcycle.cu built in {seconds:.1f} s")
        out[label] = {}
        for line in ptxas_summary(ptxas):
            if line.startswith(("k_down<", "k_up<")):
                log("    " + line)
                out[label][line.split(":")[0]] = line
    return out


def tile_check(libs, dtype, tol):
    """k_down and k_up of every case of MG_CASES at every peeled level of
    TILE_CHECK_SIZES: each (label, module) of libs against the first one
    by bits (v with its ghosts, the restricted residual, the finest
    level's residual), and each against down_plain and up_plain within
    phase 4's tolerances."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    for n in TILE_CHECK_SIZES:
        for case in MG_CASES:
            name, op, edges, _ = case
            mg = make_case_mg(n, name, op, edges, dtype)
            fine = mg.nlevels - 1
            rng = np.random.default_rng(n + 17)
            rows, worst = 0, 0.0
            for lv in mg_kernel.split(mg, dtype)[1]:
                g, gc = mg.grids[lv], mg.grids[lv - 1]
                v, f = frame(rng, g, dtype, 0.1), frame(rng, g, dtype)
                vc = frame(rng, gc, dtype, 0.1)
                runs = []
                for guess in ((v, None) if lv < fine else (v,)):
                    ref = mg_kernel.down_plain(mg, lv, guess, f)
                    gots = [m.launch_down(mg, lv, guess, f) for _, m in libs]
                    runs.append(("k_down", ref, gots,
                                 [None, resid_scale(mg, lv, ref[0], f)]))
                want_r = lv == fine
                ref = mg_kernel.up_plain(mg, lv, v, f, vc, want_r)
                gots = [m.launch_up(mg, lv, v, f, vc, want_r)
                        for _, m in libs]
                runs.append(("k_up", ref, gots,
                             [None, resid_scale(mg, lv, ref[0], f)
                              if want_r else None]))
                for kernel, ref, gots, scales in runs:
                    for k in range(2):
                        if ref[k] is None:
                            continue
                        scale = scales[k] if scales[k] is not None else \
                            float(ref[k].abs().max())
                        for (label, _), got in zip(libs, gots):
                            err = float((ref[k] - got[k]).abs().max())
                            if not bool(torch.isfinite(got[k]).all()) or \
                                    err > tol * scale:
                                raise AssertionError(
                                    f"{label} {kernel} {name} {g.nx}^2 "
                                    f"{str(dtype)[6:]} output {k}: "
                                    f"max|diff| {err:.3e} > {tol:g} x "
                                    f"{scale:.3g}")
                            worst = max(worst, err / scale)
                        for (label, _), got in zip(libs[1:], gots[1:]):
                            if not same_bits(got[k], gots[0][k]):
                                raise AssertionError(
                                    f"{label} {kernel} {name} {g.nx}^2 "
                                    f"{str(dtype)[6:]} output {k} differs "
                                    f"from {libs[0][0]}'s by bits")
                        rows += 1
            torch.cuda.synchronize()
            same = (f"equal by bits to {libs[0][0]}'s, " if len(libs) > 1
                    else "")
            log(f"  ok  k_down, k_up {name:18s} {n:5d}^2 "
                f"{str(dtype)[6:]:8s}: {rows} outputs of "
                f"{' and '.join(label for label, _ in libs)}, {same}"
                f"worst |diff| to the plain versions {worst:.3e} of scale")
            del mg
            torch.cuda.empty_cache()


def gaussian_frames(n, dtype):
    """The mg_down and mg_up calls of the first V-cycle of diffusion
    gaussian's solve at n^2 (BENCHMARK.json's diffusion.gaussian, t_0 1e-4)
    after one step: (mg, [(level, v, f)], [(level, v, f, vc, want_r)])."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.multigrid import mg_kernel

    p = Pyro("diffusion", device="cuda", dtype=dtype)
    p.initialize_problem("gaussian", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.cfl": 2.0,
        "gaussian.t_0": 1e-4, "driver.max_steps": 10 ** 9,
        "driver.tmax": 1.0e30, "driver.verbose": 0})
    p.single_step()
    downs, ups, seen = [], [], {}
    saved = mg_kernel.down, mg_kernel.up

    def clone(a):
        return None if a is None else a.clone()

    def down(mg, level, v, f):
        if "mg" not in seen:
            seen["mg"] = mg
        if len(downs) < len(mg_kernel.split(mg, f.dtype)[1]):
            downs.append((level, clone(v), f.clone()))
        return saved[0](mg, level, v, f)

    def up(mg, level, v, f, vc, want_r):
        if len(ups) < len(downs):
            ups.append((level, v.clone(), f.clone(), vc.clone(), want_r))
        return saved[1](mg, level, v, f, vc, want_r)

    mg_kernel.down, mg_kernel.up = down, up
    try:
        p.single_step()
    finally:
        mg_kernel.down, mg_kernel.up = saved
    torch.cuda.synchronize()
    return seen["mg"], downs, ups


def subnormal_share(*frames):
    """The share of a frame's nonzero values that are subnormal, over
    frames (None skipped)."""
    import torch

    sub = tot = 0
    for a in frames:
        if a is None:
            continue
        tiny = torch.finfo(a.dtype).tiny
        nz = a != 0
        sub += int((nz & (a.abs() < tiny)).sum())
        tot += int(a.numel())
    return sub / max(tot, 1)


def tile_timing(libs, smi):
    """The profiler's device us a launch of k_down and k_up under each
    (label, module) of libs, in turns (first, others, others reversed,
    first): the constant operator at 4096^2 and 2048^2 on the frames of
    diffusion gaussian's first cycle and on random frames of the same
    size, float32 and float64, with the share of subnormal values of
    each; and every operator of MG_CASES at its 1024^2 cycle's peeled
    levels (random frames), float32 and float64."""
    import numpy as np
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    order = list(libs) + list(reversed(libs[1:])) + [libs[0]] \
        if len(libs) > 1 else list(libs) * 2

    def times(calls, reps=10):
        """{label: [us a launch of each call, each turn]}"""
        out = {label: [[] for _ in calls] for label, _ in libs}
        for label, mod in order:
            for c, (kernel, fn) in enumerate(calls):
                fn(mod)
                us, _ = kernel_device_us(lambda: fn(mod), reps, kernel)
                out[label][c].append(us)
        return out

    def line(what, calls, out):
        for c, (kernel, _) in enumerate(calls):
            cells = "; ".join(
                f"{label} " + " / ".join(f"{u:.1f}" for u in out[label][c])
                for label, _ in libs)
            log(f"  {what[c]} {kernel}: {cells} us a launch")

    log(f"  (profiler device us a launch, 10 launches a session, in turns "
        f"{' -> '.join(label for label, _ in order)}; {smi})")
    for dtype in (torch.float32, torch.float64):
        mg, downs, ups = gaussian_frames(4096, dtype)
        rng = np.random.default_rng(11)
        up_of = {u[0]: u for u in ups}
        for lv, v, f in downs[:2]:                # 4096^2, 2048^2
            lu, vu, fu, vc, want_r = up_of[lv]
            g = mg.grids[lv]
            rv = None if v is None else frame(rng, g, dtype, 0.1)
            rf, rvu = frame(rng, g, dtype), frame(rng, g, dtype, 0.1)
            rvc = frame(rng, mg.grids[lv - 1], dtype, 0.1)
            for data, args in (("gaussian", (v, f, vu, fu, vc)),
                               ("random", (rv, rf, rvu, rf, rvc))):
                dv, df, uv, uf, uc = args
                calls = [("k_down", lambda m: m.launch_down(mg, lv, dv, df)),
                         ("k_up", lambda m: m.launch_up(mg, lu, uv, uf, uc,
                                                         want_r))]
                out = times(calls)
                share = [subnormal_share(dv, df), subnormal_share(uv, uf, uc)]
                what = [f"{str(dtype)[6:]} {g.nx}^2 {data} (subnormal "
                        f"{100 * s:.3g}% of the inputs)" for s in share]
                line(what, calls, out)
        del mg, downs, ups
        torch.cuda.empty_cache()
        for case in MG_CASES:
            name, op, edges, _ = case
            if name not in ("neumann_helmholtz", "vc_lm_edges",
                            "general_dirichlet"):
                continue
            mg = make_case_mg(1024, name, op, edges, dtype)
            fine = mg.nlevels - 1
            for lv in reversed(mg_kernel.split(mg, dtype)[1]):
                g, gc = mg.grids[lv], mg.grids[lv - 1]
                v, f = frame(rng, g, dtype, 0.1), frame(rng, g, dtype)
                vc = frame(rng, gc, dtype, 0.1)
                guess = v if lv == fine else None
                calls = [("k_down",
                          lambda m: m.launch_down(mg, lv, guess, f)),
                         ("k_up", lambda m: m.launch_up(mg, lv, v, f, vc,
                                                         lv == fine))]
                out = times(calls)
                line([f"{str(dtype)[6:]} {name} {g.nx}^2"] * 2, calls, out)
            del mg
            torch.cuda.empty_cache()


def mg_tiles_main(parent):
    """Phase 4c alone: the card, mg_vcycle.cu's build and ptxas lines (and
    the parent's), the checks and the timing."""
    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = ([("parent", parent_mg_kernel(parent))] if parent else []) + \
        [("change" if parent else "this tree", mg_kernel)]
    log("[4c. mg_vcycle.cu's k_down and k_up: build, ptxas]")
    tile_ptxas(libs)
    log("[4c. k_down and k_up of every case at "
        f"{' and '.join(f'{n}^2' for n in TILE_CHECK_SIZES)}"
        + (", against the parent's by bits" if parent else "") + "]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tile_check(libs, dtype, tol)
    log("[4c. k_down and k_up timing]")
    tile_timing(libs, smi)
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(parent=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
    from pyro2_tpu_torch.solvers.swe import swe_kernel
    from pyro2_tpu_torch.util import cuda_build

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device 0: {kind}")
    bw, fp32 = next((b, f) for key, b, f in PEAKS if key in kind)

    # 2. build, one nvcc per source, all started together
    log("[build]")
    t0 = time.perf_counter()
    built = cuda_build.build_many([ctu_kernel.SOURCE, mg_kernel.SOURCE,
                                   mol_kernel.SOURCE, swe_kernel.SOURCE,
                                   lm_kernel.SOURCE, sharded_mg_kernel.SOURCE],
                                  verbose=True)
    for module in (ctu_kernel, mg_kernel, mol_kernel, swe_kernel,
                   lm_kernel, sharded_mg_kernel):
        module._load()
    log(f"  built in {time.perf_counter() - t0:.1f} s (with load)")
    main_ptxas, ctu_ptxas = {}, []
    for so, nvcc_s, ptxas in built:
        log(f"  {os.path.relpath(so, HERE)}: nvcc {nvcc_s:.1f} s")
        for line in ptxas_summary(ptxas):
            log("    " + line)
            if line.startswith("k_ctu<"):
                ctu_ptxas.append(line)
            for head in ("k_ctu<float, nvar 4, cartesian>",
                         "k_ctu<float, nvar 4, cartesian, stages 1>",
                         "k_ctu<float, nvar 4, cartesian, stages 2>",
                         "k_ctu<float, nvar 4, cartesian, stages 3>",
                         "k_swe<float, 4>",
                         "k_swe<float, 4, device dt>", "k_swe<double, 4>",
                         "k_swe<double, 4, device dt>",
                         "k_down<const, float>", "k_up<const, float>",
                         "k_down<float>", "k_up<float>",
                         "k_down<double>", "k_up<double>",
                         "k_down<vc, float>",
                         "k_down<general, float>", "k_rk<float, 4>",
                         "k_rk<double, 4>",
                         "k_deep<const, rbgs, v_fc, float>",
                         "k_deep<const, rbgs, v_r, float>",
                         "k_sweep<const, v, float>",
                         "k_lm_mac<float>", "k_lm_rho<float>",
                         "k_lm_states<float>"):
                if line.startswith(head + ":"):
                    main_ptxas[head] = line
    for head, line in main_ptxas.items():
        log(f"  a main path's kernel: {line}")

    # 3. the CTU kernel vs its plain step on the card
    log("[ctu_step vs plain step on the card]")
    ctu_err = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in CTU_SHAPES:
            for name, problem, inputs, extra in CONFIGS:
                err = compare(name, problem, inputs, extra, nx, ny, dtype,
                              tol)
                if (name == "quad_hllc" and nx == 1024 and
                        dtype == torch.float32):
                    ctu_err = err
            torch.cuda.empty_cache()

    # 3c. the CTU kernel on spherical grids, and the padded entries, vs
    # their plain steps on the card
    log(f"[ctu_step spherical, ctu_periodic, ctu_padin, ctu_ensemble vs "
        f"plain steps, ctu_periodic's stage prefixes vs plain_stages, on "
        f"the card; {smi}]")
    sph_err, padded_err = None, {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in CTU_SHAPES:
            for name, problem, inputs, extra in SPH_CONFIGS:
                err = compare(name, problem, inputs, extra, nx, ny, dtype,
                              tol)
                if (name == "sph_advect_cgf" and nx == 1024 and
                        dtype == torch.float32):
                    sph_err = err
            for entry, problem in (("ctu_periodic", "advect"),
                                   ("ctu_padin", "kh")):
                err = padded_compare(entry, problem, nx, ny, dtype, tol)
                if nx == 1024 and dtype == torch.float32:
                    padded_err[entry] = err
            for stages in (1, 2, 3):
                err = stage_compare(stages, nx, ny, dtype, tol)
                if (nx, ny) == (1024, 1024) and dtype == torch.float32:
                    padded_err[f"ctu_periodic_s{stages}"] = err
            torch.cuda.empty_cache()
        padded_compare("ctu_ensemble", "acoustic_pulse", 200, 136, dtype,
                       tol, n_ens=3)
        err = padded_compare("ctu_ensemble", "acoustic_pulse", 256, 256,
                             dtype, tol, n_ens=8)
        if dtype == torch.float32:
            padded_err["ctu_ensemble"] = err
        torch.cuda.empty_cache()

    # 3a. the swe kernel vs its plain step on the card
    log("[swe_step vs plain step on the card]")
    swe_err = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in CTU_SHAPES:
            for name, problem, inputs, extra in SWE_CONFIGS:
                err = compare(name, problem, inputs, extra, nx, ny, dtype,
                              tol, solver="swe")
                if (name == "swe_quad_roe" and nx == 1024 and
                        dtype == torch.float32):
                    swe_err = err
            torch.cuda.empty_cache()

    # 3b. the MOL kernels vs their plain versions on the card
    log("[mol_substep vs plain stage increment on the card]")
    mol_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in ((200, 136), (1024, 1000), (1024, 1024)):
            for name, solver, problem, inputs, extra in MOL_CONFIGS:
                shape = (nx, ny)
                if name == "fv4_rt_gravity" and nx == 200:
                    shape = (200, 600)          # square cells, rt's 1 x 3
                err = mol_compare(name, solver, problem, inputs, extra,
                                  *shape, dtype, tol)
                if nx == 1024 and dtype == torch.float32 and name in (
                        "rk_quad_hllc", "fv4_acoustic_pulse"):
                    mol_err["mol_" + name[:name.index("_")]] = err
            torch.cuda.empty_cache()

    # 4. the multigrid kernels vs their plain versions on the card
    log("[multigrid kernels vs plain versions on the card]")
    mg_err, mg_err_new = {}, {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for n in (64, 1024):
            for case in MG_CASES:
                errs = mg_err_new if case[0] in NEW_MG_CASES else mg_err
                mg_compare(n, case, dtype, tol,
                           errs if (n, dtype) == (1024, torch.float32)
                           else {})
        torch.cuda.empty_cache()
    log(f"  1024^2 float32 worst |diff| of the parent's cases "
        f"{ {k: mg_err[k] for k in MG_KERNELS} }, of "
        f"{', '.join(NEW_MG_CASES)} {mg_err_new}")
    for k, err in mg_err_new.items():
        mg_err[k] = max(mg_err[k], err)

    log("[mg_core at every top it holds, each operator, vs core_plain]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for case in MG_CASES:
            core_tops_compare(case, dtype, tol)
        torch.cuda.empty_cache()

    log("[mg_down and mg_up in rounds (nsmooth 50) at every peeled level vs "
        "down_plain and up_plain]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for case in MG_CASES:
            for kernel in ("mg_down", "mg_up"):
                rounds_compare(kernel, case, dtype, tol, 50)
        torch.cuda.empty_cache()

    # 4c. k_down and k_up against the parent's kernels by bits
    if parent:
        log(f"[4c. k_down and k_up of every case at "
            f"{' and '.join(f'{n}^2' for n in TILE_CHECK_SIZES)}, against "
            f"the parent's ({parent}) by bits]")
        tiles = [("parent", parent_mg_kernel(parent)), ("change", mg_kernel)]
        tile_ptxas(tiles)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            tile_check(tiles, dtype, tol)
        torch.cuda.empty_cache()

    # 4a. the lm_atm interface kernels vs their plain versions on the card
    log("[lm_interface vs plain stages on the card]")
    lm_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for what, (g, calls) in (
                ("random", lm_random_calls(200, 136, dtype, 1)),
                ("random", lm_random_calls(1024, 1024, dtype, 2)),
                ("random", lm_random_calls(1024, 1000, dtype, 3)),
                ("bubble, 3 steps", lm_bubble_calls(1024, dtype))):
            lm_compare(what, g, calls, dtype, tol,
                       lm_err if (g.nx, g.ny, dtype) ==
                       (1024, 1024, torch.float32) else {})
            if what != "random" and dtype == torch.float32:
                bubble_g, bubble_calls = g, calls
        torch.cuda.empty_cache()

    # 4b. the sharded multigrid kernels vs their plain versions on the card
    log(f"[mg_deep_smooth, mg_correct vs plain versions on the card; {smi}]")
    sharded_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        sharded_compare(dtype, tol,
                        sharded_err if dtype == torch.float32 else {})
        torch.cuda.empty_cache()

    # 5. the main paths
    log("[main paths: Pyro -> run_sim, CUDA float32]")
    p, quad_seconds, quad_launches = main_path("quad", 1024, 1024, 100)
    main_path("rt", 256, 768, 50)
    diff, diff_launches, diff_seconds = mg_main_path("diffusion", "gaussian",
                                                     1024, 10)
    shear, shear_launches, _ = mg_main_path("incompressible", "shear", 1024,
                                            10)
    mg_launches = {k: diff_launches[k] + shear_launches[k]
                   for k in MG_KERNELS}
    rk_quad, n_rk_quad = mol_main_path("compressible_rk", "quad", 1024,
                                       1024, 20, "mol_rk", 4)
    _, n_rk_rt = mol_main_path("compressible_rk", "rt", 256, 768, 20,
                               "mol_rk", 4)
    fv4, n_fv4 = mol_main_path("compressible_fv4", "acoustic_pulse", 1024,
                               1024, 20, "mol_fv4", 4,
                               {"driver.fix_dt": 0.192 / 1024})
    sdc, n_sdc = mol_main_path("compressible_sdc", "acoustic_pulse", 1024,
                             1024, 5, "mol_fv4", 9,
                             {"driver.fix_dt": 0.192 / 1024})
    mol_launches = {"mol_rk": n_rk_quad + n_rk_rt, "mol_fv4": n_fv4 + n_sdc}
    swe_quad, n_swe_quad = swe_main_path(
        "quad", 1024, 1024, 100, {"swe.riemann": "Roe", "swe.limiter": 2})
    _, n_swe_kh = swe_main_path("kh", 1024, 1024, 100,
                                {"swe.riemann": "HLLC"})
    lm, lm_launches, cycles_per_solve = lm_main_path(1024, 10)
    general_launches, general_solve = general_path(1024)
    sph, _, sph_launches = main_path("advect", 1024, 1024, 100, SPH_ADVECT)
    padded = {
        "ctu_periodic": padded_path("ctu_periodic", "advect", 1024, 100),
        "ctu_padin": padded_path("ctu_padin", "kh", 1024, 20),
        "ctu_ensemble": padded_path("ctu_ensemble", "acoustic_pulse", 256,
                                    20, n_ens=8)}
    log("[the sharded multigrid: ShardedDiffusion on a 1x1 mesh, CUDA]")
    sharded, sh_seconds, sh_launches, _ = sharded_path(1024, 10,
                                                       torch.float32)
    log(f"  serial diffusion gaussian 1024x1024 f32 in the same run: "
        f"{100 * diff_seconds:.3f} ms/step; sharded "
        f"{100 * sh_seconds:.3f} ms/step")
    sharded_phi_check(sharded, diff, 1e-5)
    sharded_vs_serial(256, 5, torch.float64, 1e-12)
    log(f"[the multigrid's last consumers: burgers, burgers_viscous, "
        f"incompressible_viscous cavity, CUDA float32; {smi}]")
    burgers = burgers_path(1024, 100)
    bv, bv_launches, _ = mg_main_path("burgers_viscous", "tophat", 1024, 10,
                                      solves_per_step=2)
    cavity, cavity_launches, _ = mg_main_path(
        "incompressible_viscous", "cavity", 1024, 10, solves_per_step=4)
    total = {k: mg_launches[k] + bv_launches[k] + cavity_launches[k]
             for k in MG_KERNELS}
    log(f"  multigrid launches of diffusion + shear {mg_launches}; with "
        f"burgers_viscous and the cavity {total}")
    mg_launches = total
    log("[the cavity 128^2 float64 on the card against the CPU]")
    cavity_card_vs_cpu(128, 5, 1e-10)

    # 5e. the advection solvers, the regression driver and checkpoints
    log(f"[the advection solvers, CUDA float32; {smi}]")
    advect = {solver: advection_path(solver, problem, 1024, steps)
              for solver, problem, steps in ADVECTION_PATHS}
    log("[the advection solvers 128^2 float64 on the card against the CPU]")
    for solver, problem, _ in ADVECTION_PATHS:
        advection_card_vs_cpu(solver, problem, 128, 10, 1e-12)
    log(f"[the regression driver's 16 runs on the card, float64, against "
        f"the golden copies at rtol 1e-12; {smi}]")
    t0 = time.perf_counter()
    regression_on_card(1e-12)
    log(f"  16 runs passed in {time.perf_counter() - t0:.1f} s")
    log("[write -> io_pyro.read on the card]")
    checkpoint_on_card(p)

    # 5f. the compressible family's problem sources, spherical and
    # well-balanced MOL stages, and compressible_react
    log(f"[ctu_step with problem sources, and compressible_react (nvar 6), "
        f"vs plain step on the card; {smi}]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in CTU_SHAPES:
            for name, solver, problem, inputs in SRC_CONFIGS:
                compare(name, problem, inputs, None, nx, ny, dtype, tol,
                        solver=solver)
            torch.cuda.empty_cache()
    log(f"[ctu_step with problem sources and nvar 6 vs plain step at the "
        f"phase 5f paths' grids and inputs; {smi}]")
    src_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for label, solver, problem, nx, ny, _, inputs in SRC_PATHS:
            err = ctu_check(label, make_sim(problem, {
                "mesh.nx": nx, "mesh.ny": ny, **inputs}, dtype,
                solver=solver), tol)
            if dtype == torch.float32:
                src_err[label] = err
            torch.cuda.empty_cache()
    log(f"[mol_substep's extended instantiation (problem sources, spherical "
        f"grids, well-balanced) vs plain stage increment on the card; "
        f"{smi}]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in CTU_SHAPES:
            for name, solver, problem, inputs in MOL_SRC_CONFIGS:
                mol_compare(name, solver, problem, inputs, None, nx, ny,
                            dtype, tol)
            torch.cuda.empty_cache()
    log(f"[mol_substep's extended instantiation vs plain stage increment at "
        f"the phase 5f paths' grids and inputs; {smi}]")
    mol_src_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for label, solver, problem, nx, ny, *_, inputs in MOL_SRC_PATHS:
            err = mol_check(label, make_sim(problem, {
                "mesh.nx": nx, "mesh.ny": ny, **inputs}, dtype,
                solver=solver), tol)
            if dtype == torch.float32:
                mol_src_err[label] = err
            torch.cuda.empty_cache()
    log(f"[whole runs at the published grids, float64, 10 steps, card "
        f"against CPU; {smi}]")
    for solver, problem, inputs, kernel, per_step in CARD_VS_CPU_RUNS:
        card_vs_cpu_run(solver, problem, inputs, 10, 1e-10, kernel,
                        per_step)
    log(f"[phase 5f paths: Pyro -> run_sim, CUDA float32; {smi}]")
    src_paths = {
        label: main_path(problem, nx, ny, steps, inputs, solver=solver)
        for label, solver, problem, nx, ny, steps, inputs in SRC_PATHS}
    mol_src_paths = {
        label: mol_main_path(solver, problem, nx, ny, steps, kernel,
                             per_step, inputs)
        for (label, solver, problem, nx, ny, steps, kernel, per_step,
             inputs) in MOL_SRC_PATHS}

    # 5g. tracer particles, and the on-device chunked loop over k_ctu's
    # device-dt entry
    log(f"[ctu_step's device-dt entry vs its host-dt entry (bits) and the "
        f"plain step at 1024^2; {smi}]")
    devdt_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, problem, inputs in DEVDT_CONFIGS:
            err = devdt_check(name, make_sim(problem, {
                "mesh.nx": 1024, "mesh.ny": 1024, **inputs}, dtype), tol)
            if dtype == torch.float32:
                devdt_err[name] = err
            torch.cuda.empty_cache()
    log(f"[swe_step's device-dt entry vs its host-dt entry (bits) and the "
        f"plain step at 1024^2; {smi}]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, problem, inputs in SWE_DEVDT_CONFIGS:
            err = devdt_check(name, make_sim(problem, {
                "mesh.nx": 1024, "mesh.ny": 1024, **inputs}, dtype,
                solver="swe"), tol)
            if dtype == torch.float32:
                devdt_err[name] = err
            torch.cuda.empty_cache()
    log(f"[particles: kh 1024^2 float32, without and with 1024^2 grid "
        f"particles, Pyro -> run_sim; {smi}]")
    kh_pyros, _ = particles_on_card()
    log("[particles: 128^2 float64 on the card against the CPU]")
    for solver, problem in PARTICLE_RUNS:
        particles_card_vs_cpu(solver, problem, 128, 10, 1e-12)
    log(f"[particles: incompressible shear 512^2 float32 with 256^2 grid "
        f"particles, Pyro -> run_sim; {smi}]")
    shear_p, _, _ = mg_main_path("incompressible", "shear", 512, 5, inputs={
        **PARTICLES_GRID, "particles.n_particles": 256 * 256})
    active, moved = check_particles("shear 512^2", shear_p.sim.particles,
                                    shear_p.sim.cc_data.grid, 256 * 256)
    log(f"  shear particles: {active} active, moved up to {moved:.4g}")
    del shear_p
    log(f"[the on-device loop: run_sim_fast (a CUDA graph a chunk of 64) "
        f"against run_sim; {smi}]")
    advect_particles = {**PARTICLES_GRID, "particles.n_particles": 256 * 256}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        fast_vs_host("compressible", "quad", 1024, 200, dtype, tol)
        torch.cuda.empty_cache()
    fast_vs_host("advection", "smooth", 1024, 100, torch.float32, 1e-5,
                 inputs=advect_particles)
    log(f"[the on-device loop on swe and the ramp's moving front: "
        f"run_sim_fast against run_sim; {smi}]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        fast_vs_host("swe", "quad", 1024, 200, dtype, tol)
        torch.cuda.empty_cache()
        # float32: the mean norm at 1e-4 (fast_vs_host): a front frozen at
        # t = 0 moves it by ~0.2 (256 x 64 on the CPU), the loops' rounding
        # by ~5e-6
        fast_vs_host("compressible", "ramp", 1024, 200, dtype,
                     tol if dtype == torch.float64 else 1e-4, ny=256,
                     f32_norm="mean")
        torch.cuda.empty_cache()
    fast_vs_host("swe", "dam", 1024, 200, torch.float32, 1e-5,
                 inputs={**PARTICLES_GRID, "particles.n_particles": 256 * 256,
                         "mesh.ymax": 1.0})
    torch.cuda.empty_cache()
    log(f"[the on-device loop against the host loop: host-clock ms/step, "
        f"replays, launches; {smi}]")
    loop_profiles = []
    for solver, problem, steps, dtype, inputs, ny in (
            ("compressible", "quad", 200, torch.float32, None, None),
            ("compressible", "quad", 200, torch.float64, None, None),
            ("advection", "smooth", 100, torch.float32, advect_particles,
             None),
            ("swe", "quad", 200, torch.float32, None, None),
            ("compressible", "ramp", 200, torch.float32, None, 256)):
        _, prof = fast_loop_timing(solver, problem, 1024, steps, dtype, smi,
                                   inputs=inputs, ny=ny)
        loop_profiles.append(prof)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log(f"[timing: ctu_step's device-dt entry at quad 1024^2 float32, CUDA "
        f"events; {smi}]")
    dsim = make_sim("quad", {"mesh.nx": 1024, "mesh.ny": 1024},
                    torch.float32)
    dsim.cc_data.fill_BC_all()
    dsim.compute_timestep()
    dU = dsim.cc_data.data
    d_dt = torch.tensor(dsim.dt, dtype=dU.dtype, device=dU.device)
    dstep = dsim._step
    g = dsim.cc_data.grid
    devdt_times = time_pair(
        f"ctu_step device dt (quad {g.nx}x{g.ny})",
        lambda: dstep.launch(dU, 0.0, d_dt),
        lambda: dstep.plain(dU, 0.0, float(d_dt)),
        ctu_kernel.work(g.nx, g.ny, dsim.ivars.nvar, torch.float32,
                        dstep.with_sources), bw, fp32)
    log(f"[timing: swe_step's device-dt entry at swe quad 1024^2 float32, "
        f"CUDA events, beside its host-dt entry; {smi}]")
    wsim = make_sim("quad", {"mesh.nx": 1024, "mesh.ny": 1024},
                    torch.float32, solver="swe")
    wsim.cc_data.fill_BC_all()
    wsim.compute_timestep()
    wU = wsim.cc_data.data
    w_dt = torch.tensor(wsim.dt, dtype=wU.dtype, device=wU.device)
    w_host = float(w_dt)         # read once: a read a call would time it
    wstep = wsim._step
    g = wsim.cc_data.grid
    w_work = swe_kernel.work(g.nx, g.ny, wsim.ivars.nvar, torch.float32,
                             wstep.method)
    swe_devdt_times = time_pair(
        f"swe_step device dt (quad {g.nx}x{g.ny}, {wstep.method})",
        lambda: wstep.launch(wU, 0.0, w_dt),
        lambda: wstep.plain(wU, 0.0, w_host), w_work, bw, fp32)
    time_pair(f"swe_step host dt, the same call (quad {g.nx}x{g.ny})",
              lambda: wstep.launch(wU, 0.0, w_host),
              lambda: wstep.plain(wU, 0.0, w_host), w_work, bw, fp32)
    del wsim, wU, wstep

    # 5h. inhomogeneous multigrid BC values, the analytic solves and
    # iterative refinement
    t5h = time.perf_counter()
    log(f"[phase 5h: the multigrid kernels with BC values lifted into the "
        f"right-hand side vs the plain in-cycle fill; {smi}]")
    lifted_err = {}
    for dtype, tol, sizes in ((torch.float64, 1e-12, (64, 1024)),
                              (torch.float32, 1e-5, (128, 1024))):
        for n in sizes:
            for name in LIFTED_CASES:
                lifted_compare(n, name, dtype, tol,
                               lifted_err if (n, dtype) ==
                               (1024, torch.float32) else {})
        torch.cuda.empty_cache()
    log(f"  1024^2 float32 worst |diff| of {', '.join(LIFTED_CASES)} "
        f"{lifted_err} (apart from the kernels line's, which holds the "
        f"parent's cases)")
    for name in LIFTED_CASES:
        lifted_cycle_timing(1024, name, smi)
    log(f"[phase 5h: the regression driver's analytic solves, float64 on "
        f"the card; {smi}]")
    analytic_on_card()
    analytic_card_vs_cpu(64, 1e-10)
    log(f"[phase 5h: solve_ir and solve_ir_sharded, float32 on the card; "
        f"{smi}]")
    for n in (128, 1024):
        refine_on_card(n, smi)
    refine_sharded_on_card(1024, smi)
    torch.cuda.empty_cache()
    log(f"  phase 5h in {time.perf_counter() - t5h:.1f} s")

    # 5i. the sharded hyperbolic tier: the block steps at every block of a
    # split, and the tier's classes on the 1x1 mesh
    t5i = time.perf_counter()
    log(f"[phase 5i: k_ctu and k_swe at every block of a 2x2 and a 1x4 "
        f"split, each block's frame from one global array and its flags "
        f"set, against the serial kernel step (bits) and the plain block "
        f"step; {smi}]")
    seam_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for case in SEAM_CASES:
            err = seam_check(*case, dtype, tol)
            if dtype == torch.float32:
                seam_err[case[0]] = err
        torch.cuda.empty_cache()
    log(f"[phase 5i: the sharded tier on make_mesh()'s 1x1 mesh, CUDA "
        f"float32; {smi}]")
    hyper = {}
    for label, args, want in (
            ("quad", ("ShardedCompressible", "compressible", "quad", 1024,
                      100), {"ctu_step": 100}),
            ("swe_quad", ("ShardedSWE", "swe", "quad", 1024, 100,
                          {"swe.riemann": "Roe", "swe.limiter": 2}),
             {"swe_step": 100}),
            ("advection", ("ShardedAdvection", "advection", "smooth", 1024,
                           100), {}),
            ("burgers", ("ShardedBurgers", "burgers", "tophat", 1024, 100),
             {}),
            ("particles", ("ShardedCompressible", "compressible", "advect",
                           1024, 20, None, 10000),
             {"ctu_step": 20})):
        hyper[label] = hyperbolic_path(*args, smi=smi)
        if hyper[label][2] != want:
            raise AssertionError(f"sharded {label}: launched "
                                 f"{hyper[label][2]}, expected {want}")
    log(f"  serial quad 1024^2 f32 in phase 5: "
        f"{1e3 * quad_seconds / 100:.3f} ms/step (Pyro -> run_sim); the "
        f"sharded 1x1 run {1e3 * hyper['quad'][1] / 100:.3f} ms/step "
        f"[{smi}]")
    torch.cuda.empty_cache()
    log(f"  phase 5i in {time.perf_counter() - t5i:.1f} s")

    # 5j. the sharded MOL tier and the solvers with inline sharded solves:
    # the stage increments at every block of a split, and the classes on
    # the 1x1 mesh
    t5j = time.perf_counter()
    log(f"[phase 5j: k_rk (with the blocks' domain-edge flags) and k_fv4 at "
        f"every block of a 2x2 and a 1x4 split, each block's frame from one "
        f"global array, against the serial kernel increment (bits) and the "
        f"plain block stage; {smi}]")
    mol_seam_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for name, solver, problem, inputs in MOL_SEAM_CASES:
            err = mol_seam_check(name, solver, problem, inputs, 1024, dtype,
                                 tol)
            if dtype == torch.float32:
                mol_seam_err[name] = err
        torch.cuda.empty_cache()
    log(f"[phase 5j: the sharded MOL tier on make_mesh()'s 1x1 mesh, CUDA "
        f"float32; {smi}]")
    mol_sh = {}
    for label, args in (
            ("rk", ("compressible_rk", "quad", 1024, 20, "mol_rk", 4, smi,
                    MOL_SEAM_CASES[0][3])),
            ("fv4", ("compressible_fv4", "acoustic_pulse", 1024, 20,
                     "mol_fv4", 4, smi)),
            ("sdc", ("compressible_sdc", "acoustic_pulse", 1024, 5,
                     "mol_fv4", 9, smi))):
        mol_sh[label] = mol_sharded_path(*args)
    torch.cuda.empty_cache()
    log(f"[phase 5j: the solvers with inline sharded solves on the 1x1 "
        f"mesh: f32 at 1024^2 against the serial f32 run, f64 at 256^2 "
        f"against the serial f64 card run; {smi}]")
    mg_sh = {}
    for (cls_name, solver, problem, pre, per_step), steps in zip(
            MG_SHARDED, (10, 5, 10)):
        mg_sh[cls_name] = mg_sharded_path(cls_name, solver, problem, pre,
                                          per_step, 1024, steps,
                                          torch.float32, 1e-3, smi)
        torch.cuda.empty_cache()
    for cls_name, solver, problem, pre, per_step in MG_SHARDED:
        mg_sharded_path(cls_name, solver, problem, pre, per_step, 256, 3,
                        torch.float64, 1e-11, smi)
    torch.cuda.empty_cache()
    log(f"  phase 5j in {time.perf_counter() - t5j:.1f} s")

    # 5k. the sharded lm_atm and the overlapped step: the lm stages at
    # every block of a split, ShardedLMAtm on the 1x1 mesh, the overlapped
    # step on the 1x1 mesh and at every block of a 2x2 split, halo_stats
    t5k = time.perf_counter()
    log(f"[phase 5k: k_lm_mac, k_lm_rho and k_lm_states at every block of a "
        f"2x2 and a 1x4 split of the bubble 1024^2, each block's frames "
        f"from the serial step's, against the serial kernel outputs (bits) "
        f"and the plain block stages; {smi}]")
    lm_seam_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        lm_block_check(dtype, tol, lm_seam_err if dtype == torch.float32
                       else {})
        torch.cuda.empty_cache()
    log(f"[phase 5k: ShardedLMAtm on make_mesh()'s 1x1 mesh: bubble 1024^2 "
        f"f32 against the serial f32 run, 256^2 f64 against the serial f64 "
        f"card run; {smi}]")
    lm_per_step = dict.fromkeys(LM_KERNELS, 1)
    lm_sh = mg_sharded_path("ShardedLMAtm", "lm_atm", "bubble", 3, 2, 1024,
                            10, torch.float32, 1e-3, smi, core="mg_core_vc",
                            per_step=lm_per_step)
    torch.cuda.empty_cache()
    mg_sharded_path("ShardedLMAtm", "lm_atm", "bubble", 3, 2, 256, 3,
                    torch.float64, 1e-11, smi, core="mg_core_vc",
                    per_step=lm_per_step)
    log(f"  ShardedLMAtm bubble 1024^2 f32: {lm_sh[0].n} steps, "
        f"{1e3 * lm_sh[1] / 10:.3f} ms/step against the serial "
        f"{1e3 * lm_sh[4] / 10:.3f} (steps alone; the preevolve "
        f"{1e3 * lm_sh[7]:.3f} ms); one coefficient install (gather, "
        f"beta0^2 / rho, install_coefficients) {install_ms(lm_sh[0]):.3f} "
        f"ms, host clock [{smi}]")
    torch.cuda.empty_cache()
    log(f"[phase 5k: the overlapped step at every block of a 2x2 split "
        f"(core from the unfilled window, bands from the filled one), "
        f"against the plain block step and the serial step (bits); {smi}]")
    overlap_err = {}
    for dtype in (torch.float64, torch.float32):
        for label, cls_name, solver, problem, inputs, _ in OVERLAP_CASES:
            err = overlap_block_check(label, cls_name, solver, problem,
                                      inputs, 1024, dtype)
            if dtype == torch.float32:
                overlap_err[label] = err
        torch.cuda.empty_cache()
    log(f"[phase 5k: the overlapped step on make_mesh()'s 1x1 mesh against "
        f"the plain sharded step, CUDA float32; {smi}]")
    overlap = {label: overlap_path(label, cls_name, solver, problem, inputs,
                                   kernel, 1024, 20, smi)
               for label, cls_name, solver, problem, inputs, kernel
               in OVERLAP_CASES}
    halo_stats_lines(1024)
    torch.cuda.empty_cache()
    log(f"  phase 5k in {time.perf_counter() - t5k:.1f} s")

    # 5l. the plain structure of the sharded multigrid on the card: the
    # half-sweep kernel against its plain version, the replicated coarse
    # cycle above CORE_MAX, and the three operators' solves
    t5l = time.perf_counter()
    log(f"[phase 5l: mg_sweep at every block of a 2x2 and a 1x4 split of "
        f"1024^2 and at every level of a 1024^2 solve, against sweep_plain; "
        f"{smi}]")
    a20_err = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        sweep_compare(dtype, tol, a20_err if dtype == torch.float32 else {})
        torch.cuda.empty_cache()
    log(f"[phase 5l: mg_kernel.coarse_cycle from the levels above CORE_MAX "
        f"against serial._v_cycle; {smi}]")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        coarse_cycle_check(dtype, tol)
    log(f"[phase 5l: ShardedMG, ShardedVarCoeffMG and ShardedGeneralMG with "
        f"use_pallas=False and with comm_mode='sweep' on make_mesh()'s 1x1 "
        f"mesh, every plain version guarded; {smi}]")
    a20_ms, a20_launches = a20_solves(smi)
    from pyro2_tpu_torch.parallel import sharded_mg as smg_mod
    for label, kw in A20_STRUCTURES + (("kernel", {}),):
        st = smg_mod.structure(1024, 1024, 1, 1, dtype=torch.float32,
                               **kw)
        log(f"  {label} structure, 1024^2 float32, 1x1 mesh: launches a "
            f"cycle {st.launches} ({sum(st.launches.values())})")
    for op, (d_ms, s_ms, k_ms, cyc, k_cyc) in a20_ms.items():
        log(f"  {op} 1024^2 float32, ms a solve (host clock, after a "
            f"warm-up solve): plain deep {d_ms:.2f}, sweep {s_ms:.2f} "
            f"({cyc} cycles), kernel structure {k_ms:.2f} ({k_cyc} "
            f"cycles) [{smi}]")
    log(f"  phase 5l in {time.perf_counter() - t5l:.1f} s")

    # 6. timing at the main paths' shapes
    log(f"[timing: the sharded block step, quad 1024^2 float32 on the 1x1 "
        f"mesh and a 2x2 block with its seam flags, CUDA events; {smi}]")
    hyper_times = hyper_block_timing(hyper["quad"][0], bw, fp32)
    log(f"[timing: the sharded rk block step, quad 1024^2 float32 on the 1x1 "
        f"mesh and a 2x2 block (512^2) with its seam flags, CUDA events; "
        f"{smi}]")
    mol_sh_times = mol_block_timing(mol_sh["rk"][0], bw, fp32)
    log(f"[timing: the lm stages on a 2x2 block of the 1024^2 f32 bubble, "
        f"and one overlapped step's five block steps (quad and swe quad "
        f"1024^2 f32, 1x1 mesh), CUDA events; {smi}]")
    lm_sh_times = lm_block_timing(bw, fp32)
    overlap_times = {label: overlap_timing(overlap[label][0], kernel, bw,
                                           fp32)
                     for label, _, _, _, _, kernel in OVERLAP_CASES}

    log("[timing: quad 1024^2 float32, CUDA events]")
    sim = p.sim
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    step = sim._step
    event_ms(lambda: step.launch(U, t, dt), 3)          # warm up
    event_ms(lambda: step.plain(U, t, dt), 1)
    plain_a = event_ms(lambda: step.plain(U, t, dt), 5)
    kern_a = event_ms(lambda: step.launch(U, t, dt), 20)
    kern_b = event_ms(lambda: step.launch(U, t, dt), 20)
    plain_b = event_ms(lambda: step.plain(U, t, dt), 5)
    kern_ms = 0.5 * (kern_a + kern_b)
    plain_ms = 0.5 * (plain_a + plain_b)

    g = sim.cc_data.grid
    nbytes, nops = ctu_kernel.work(g.nx, g.ny, sim.ivars.nvar,
                                   torch.float32, step.with_sources)
    bytes_ms = 1e3 * nbytes / bw
    ops_ms = 1e3 * nops / fp32
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  kernel {kern_ms:.4f} ms/step ({kern_a:.4f}, {kern_b:.4f}); "
        f"plain {plain_ms:.4f} ms/step ({plain_a:.4f}, {plain_b:.4f}); "
        f"speed-up {plain_ms / kern_ms:.2f}x")
    log(f"  bound {bound_ms:.4f} ms ({bound_by}): {nbytes} B at "
        f"{bw:.3g} B/s = {bytes_ms:.4f} ms, {nops} ops "
        f"({ctu_kernel.FLOPS_PER_ZONE}/zone) at {fp32:.3g} op/s = "
        f"{ops_ms:.4f} ms; kernel at {100 * bound_ms / kern_ms:.2f}% of it")
    ctu_peak = step_peak_memory(step, U, t, dt)
    log("[timing: the 1024^2 float32 solves' levels, CUDA events]")
    mg_times = mg_timing(make_mg(1024, "periodic", 0.0, -1.0,
                                 torch.float32), "periodic Poisson", bw,
                         fp32)
    for case in MG_CASES:
        if case[0] in ("vc_lm_edges", "general_dirichlet"):
            mg_times.update(mg_timing(make_case_mg(1024, *case[:3],
                                                   torch.float32),
                                      case[0], bw, fp32))
    log(f"[timing: the cavity's ZERO edge beside Neumann walls, the same "
        f"Crank-Nicolson operator, 1024^2 float32, CUDA events; {smi}]")
    lid = {label: mg_timing(make_case_mg(1024, "cavity_cn", "const", edges,
                                         torch.float32), label, bw, fp32)
           for label, edges in (("cavity", CAVITY_EDGES),
                                ("Neumann walls", ("neumann",) * 4))}
    log("  " + "; ".join(f"{k}: cavity {lid['cavity'][k][0]:.4f} ms, "
                         f"Neumann walls {lid['Neumann walls'][k][0]:.4f} ms"
                         for k in MG_KERNELS))
    log(f"[mg_up and mg_down at every peeled level, float32, CUDA events; "
        f"{smi}]")
    for key in sorted(k for k in mg_times if isinstance(k, tuple)):
        ms, p_ms, b_ms, b_by = mg_times[key]
        log(f"  {key[0]:16s} {key[1]:5d}^2: {ms:.4f} ms, plain {p_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), at {100 * b_ms / ms:.2f}% "
            "of it")
    log("[timing: the MOL increments at 1024^2 float32, CUDA events]")
    mol_times, mol_peak, mol_calls = {}, {}, {}
    for kname, pp in (("mol_rk", rk_quad), ("mol_fv4", fv4)):
        msim = pp.sim
        msim.cc_data.fill_BC_all()
        msim.compute_timestep()
        mU, mt, mdt = msim.cc_data.data, msim.cc_data.t, msim.dt
        mstep = msim._step
        g = msim.cc_data.grid
        mol_times[kname] = time_pair(
            f"{kname} ({msim.problem_name} {g.nx}x{g.ny})",
            lambda: mstep.launch(mU, mt, mdt),
            lambda: mstep.plain(mU, mt, mdt),
            mol_kernel.work(mstep.kind, g.nx, g.ny, msim.ivars.nvar,
                            torch.float32), bw, fp32)
        mol_peak[kname] = mol_peak_memory(mstep, mU, mt, mdt)
        mol_calls[kname] = (mstep, mU, mt, mdt)

    log(f"[timing: phase 5f's configurations at their paths' shapes, "
        f"float32, CUDA events; {smi}]")
    src_times = {}
    for label, (pp, _, _) in src_paths.items():
        tsim = pp.sim
        tsim.cc_data.fill_BC_all()
        tsim.compute_timestep()
        tU, tt, tdt = tsim.cc_data.data, tsim.cc_data.t, tsim.dt
        tstep = tsim._step
        g = tsim.cc_data.grid
        src_times[label] = time_pair(
            f"ctu_step ({label} {g.nx}x{g.ny}, nvar {tsim.ivars.nvar})",
            lambda: tstep.launch(tU, tt, tdt),
            lambda: tstep.plain(tU, tt, tdt),
            ctu_kernel.work(g.nx, g.ny, tsim.ivars.nvar, torch.float32,
                            with_sources=tstep.with_sources,
                            problem=tstep.problem), bw, fp32)
    mol_src_times = {}
    for label, (pp, _) in mol_src_paths.items():
        if label == "sdc_convection":
            continue                    # fv4_convection's kernel and shape
        msim = pp.sim
        msim.cc_data.fill_BC_all()
        msim.compute_timestep()
        mU, mt, mdt = msim.cc_data.data, msim.cc_data.t, msim.dt
        mstep = msim._step
        g = msim.cc_data.grid
        mol_src_times[label] = time_pair(
            f"{mstep.name} extended ({label} {g.nx}x{g.ny})",
            lambda: mstep.launch(mU, mt, mdt),
            lambda: mstep.plain(mU, mt, mdt),
            mol_kernel.work(mstep.kind, g.nx, g.ny, msim.ivars.nvar,
                            torch.float32, spherical=mstep.spherical,
                            problem=mstep.problem,
                            well_balanced=mstep.well_balanced), bw, fp32)

    log("[timing: the swe step at quad 1024^2 float32, CUDA events]")
    ssim = swe_quad.sim
    ssim.cc_data.fill_BC_all()
    ssim.compute_timestep()
    sU, st, sdt = ssim.cc_data.data, ssim.cc_data.t, ssim.dt
    sstep = ssim._step
    g = ssim.cc_data.grid
    swe_work = swe_kernel.work(g.nx, g.ny, ssim.ivars.nvar, torch.float32,
                               sstep.method)
    swe_plan = swe_kernel.plan(g.nx, g.ny, ssim.ivars.nvar, torch.float32)
    log(f"  plan: {swe_plan.tx} x {swe_plan.ty} tiles, {swe_plan.threads} "
        f"threads, grid {swe_plan.grid}, {swe_plan.smem} B of shared memory")
    swe_times = time_pair(
        f"swe_step (quad {g.nx}x{g.ny}, {sstep.method})",
        lambda: sstep.launch(sU, st, sdt),
        lambda: sstep.plain(sU, st, sdt), swe_work, bw, fp32)
    swe_peak = step_peak_memory(sstep, sU, st, sdt)
    swe_call = (sstep, sU, st, sdt)
    swe_tiles(sstep, sU, st, sdt, swe_work, bw, fp32)

    log("[timing: the lm_atm stages on the 1024^2 float32 bubble, CUDA "
        "events; the host's multigrid set-up]")
    lm_times = lm_timing(bubble_calls, bubble_g, bw, fp32)
    lm_peak_memory(bubble_calls, bubble_g)
    vc_build_ms(lm.sim)

    log(f"[timing: the spherical CTU step and the padded entries at the "
        f"new paths' shapes, float32, CUDA events; {smi}]")
    ssim = sph.sim
    ssim.cc_data.fill_BC_all()
    ssim.compute_timestep()
    sU, st, sdt = ssim.cc_data.data, ssim.cc_data.t, ssim.dt
    sstep = ssim._step
    g = ssim.cc_data.grid
    sph_times = time_pair(
        f"ctu_step spherical (advect {g.nx}x{g.ny}, CGF)",
        lambda: sstep.launch(sU, st, sdt), lambda: sstep.plain(sU, st, sdt),
        ctu_kernel.work(g.nx, g.ny, ssim.ivars.nvar, torch.float32,
                        with_sources=True, spherical=True), bw, fp32)
    padded_times = {}
    for entry, (psim, pstep, P, pdt, _, _) in padded.items():
        g = psim.cc_data.grid
        padded_times[entry] = time_pair(
            f"{entry} ({psim.problem_name} "
            f"{pstep.n_members} x {g.nx}x{g.ny})",
            lambda: pstep.launch(P, pdt), lambda: pstep.plain(P, pdt),
            ctu_kernel.work(g.nx, g.ny, psim.ivars.nvar, torch.float32,
                            n_members=pstep.n_members), bw, fp32)
    psim, _, P, pdt, _, _ = padded["ctu_periodic"]
    log(f"[timing: the stage split of ctu_periodic at advect "
        f"{psim.cc_data.grid.nx}^2 float32 (bench.py's stages), CUDA "
        f"events; {smi}]")
    stage_entries, _, stage_launches, stage_times = stage_split(
        psim, P, pdt, 100, ctu_ptxas, bw, fp32, smi)

    log(f"[timing: the sharded multigrid kernels at the 1024^2 path's "
        f"finest level, float32, CUDA events; {smi}]")
    sharded_times, deep_calls = sharded_timing(sharded, bw, fp32)
    log(f"[timing: mg_sweep, a colour pass and the residual restriction, "
        f"on a 1024^2 frame and a 256^2 block, float32, CUDA events; "
        f"{smi}]")
    sweep_times, sweep_calls = sweep_timing(bw, fp32)
    log(f"[the core: its schedule and barriers, and its time on the "
        f"sharded solve's data, float32, CUDA events; {smi}]")
    core_schedule_log(make_mg(1024, "periodic", 0.0, -1.0, torch.float32),
                      "periodic Poisson")
    core_on_sharded_data(sharded)

    # 7. where a main-path step's time goes: the kernels' launches and
    # device times under the profiler, after every CUDA-event timing, and
    # the main paths' breakdowns
    log(f"[the swe step, mg_down's launches, the multigrid kernels by level "
        f"and mg_down with other tiles under the profiler, float32; {smi}]")
    sstep, sU, st, sdt = swe_call
    one_launch_each(lambda: sstep.launch(sU, st, sdt), 5, "k_swe",
                    "swe steps (quad 1024^2)", "swe_step")
    mstep, mU, mt, mdt = mol_calls["mol_rk"]
    one_launch_each(lambda: mstep.launch(mU, mt, mdt), 5, "k_rk",
                    "rk stages (quad 1024^2)", "mol_rk")
    for label, call in deep_calls.items():
        one_launch_each(call, 5, "k_deep", f"mg_deep_smooth calls ({label})",
                        "mg_deep_smooth")
    for label, call in sweep_calls.items():
        one_launch_each(call, 5, "k_sweep", f"mg_sweep calls ({label})",
                        "mg_sweep")
    log(f"[the lm_atm stages and mg_correct under the profiler, float32; "
        f"{smi}]")
    lm_correct_device_us(bubble_calls, bubble_g, bw)
    down_launches(make_mg(1024, "periodic", 0.0, -1.0, torch.float32))
    mg_level_kernels(make_mg(1024, "periodic", 0.0, -1.0, torch.float32),
                     "periodic Poisson")
    for case in MG_CASES:
        if case[0] in ("vc_lm_edges", "general_dirichlet"):
            mg_level_kernels(make_case_mg(1024, *case[:3], torch.float32),
                             case[0])
    for label, edges in (("cavity_cn", CAVITY_EDGES),
                         ("cavity_cn on Neumann walls", ("neumann",) * 4)):
        mg_level_kernels(make_case_mg(1024, "cavity_cn", "const", edges,
                                      torch.float32), label)
    for case in MG_CASES:
        if case[0] in ("neumann_helmholtz", "vc_lm_edges",
                       "general_dirichlet"):
            down_tiles(make_case_mg(1024, *case[:3], torch.float32),
                       case[0])
    profile_steps(p.single_step, 20, "quad 1024^2 float32")
    _, _, frame_p, pdt, _, advance = padded["ctu_periodic"]
    held = [frame_p]

    def periodic_step():
        held[0] = advance(held[0], pdt)

    profile_steps(periodic_step, 20,
                  "ctu_periodic advect 1024^2 float32 (fill + step)")
    log(f"[the stage split of ctu_periodic under the profiler, advect "
        f"1024^2 float32; {smi}]")
    stage_profile(stage_entries, stage_entries[4][0](held[0]), pdt, 5)
    profile_steps(diff.single_step, 5, "diffusion gaussian 1024^2 float32")
    profile_steps(shear.single_step, 5,
                  "incompressible shear 1024^2 float32")
    profile_steps(rk_quad.single_step, 5,
                  "compressible_rk quad 1024^2 float32")
    profile_steps(fv4.single_step, 5,
                  "compressible_fv4 acoustic_pulse 1024^2 float32")
    profile_steps(sdc.single_step, 3,
                  "compressible_sdc acoustic_pulse 1024^2 float32")
    profile_steps(swe_quad.single_step, 5, "swe quad 1024^2 float32")
    profile_steps(lm.single_step, 5, "lm_atm bubble 1024^2 float32")
    profile_steps(general_solve, 2,
                  "GeneralMG2d 1024^2 float32, one solve a step")
    profile_steps(sph.single_step, 20, "spherical advect 1024^2 float32")
    profile_steps(sharded.evolve, 5,
                  "ShardedDiffusion gaussian 1024^2 float32, 1x1 mesh")
    profile_steps(burgers.single_step, 20, "burgers tophat 1024^2 float32")
    profile_steps(bv.single_step, 5,
                  "burgers_viscous tophat 1024^2 float32")
    profile_steps(cavity.single_step, 5,
                  "incompressible_viscous cavity 1024^2 float32")
    profile_steps(advect["advection"].single_step, 20,
                  "advection smooth 1024^2 float32")
    for label, what in (("quad", "ShardedCompressible quad"),
                        ("swe_quad", "ShardedSWE quad"),
                        ("advection", "ShardedAdvection smooth"),
                        ("burgers", "ShardedBurgers tophat")):
        profile_steps(hyper[label][3], 10,
                      f"{what} 1024^2 float32, 1x1 mesh [{smi}]")
    profile_steps(advect["advection_weno"].single_step, 5,
                  "advection_weno smooth 1024^2 float32")
    for label, what in (("rk", "ShardedCompressibleRK quad"),
                        ("fv4", "ShardedCompressibleFV4 acoustic_pulse"),
                        ("sdc", "ShardedCompressibleSDC acoustic_pulse")):
        profile_steps(mol_sh[label][3], 5,
                      f"{what} 1024^2 float32, 1x1 mesh [{smi}]")
    for cls_name, solver, problem, _, _ in MG_SHARDED:
        profile_steps(mg_sh[cls_name][3], 5,
                      f"{cls_name} {problem} 1024^2 float32, 1x1 mesh "
                      f"[{smi}]")
        profile_steps(mg_sh[cls_name][5].single_step, 5,
                      f"{solver} {problem} 1024^2 float32, serial "
                      f"(Pyro.single_step) [{smi}]")
    profile_steps(lm_sh[3], 5, f"ShardedLMAtm bubble 1024^2 float32, 1x1 "
                  f"mesh (phase 5k) [{smi}]")
    for label, (pp, _, _) in src_paths.items():
        g = pp.sim.cc_data.grid
        profile_steps(pp.single_step, 10,
                      f"{pp.solver_name} {pp.problem_name} {g.nx}x{g.ny} "
                      "float32")
    for label, (pp, _) in mol_src_paths.items():
        g = pp.sim.cc_data.grid
        profile_steps(pp.single_step, 2 if label.startswith("sdc") else 3,
                      f"{pp.solver_name} {pp.problem_name} {g.nx}x{g.ny} "
                      f"float32 ({label})")
    log(f"[phase 5g under the profiler: the kernels a particle advance "
        f"adds, and the host and on-device loops' device-busy share; {smi}]")
    particles_profile(kh_pyros, smi)
    # the kernels line's launches: the f32 quad on-device run's, from the
    # profiler
    loop_launches = [prof() for prof in loop_profiles]
    devdt_launches, swe_devdt_launches = loop_launches[0], loop_launches[3]
    profiler_records(swe_call, smi)

    kernels = [{
        "name": "ctu_step",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
        "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
        "launches": quad_launches,
        "max_abs_err": ctu_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    for name, line in (("mg_core", 191), ("mg_down", 236), ("mg_up", 260)):
        ms, p_ms, b_ms, b_by = mg_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/mg_vcycle.cu",
            "replaces": f"pyro2_tpu/multigrid/pallas_mg.py:{line}",
            "launches": mg_launches[name],
            "max_abs_err": mg_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for name in MOL_KERNELS:
        ms, p_ms, b_ms, b_by = mol_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/mol_substep.cu",
            "replaces": "pyro2_tpu/solvers/compressible_fv4/pallas_step.py:92",
            "launches": mol_launches[name],
            "max_abs_err": mol_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    ms, p_ms, b_ms, b_by = swe_times
    kernels.append({
        "name": "swe_step",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/swe_step.cu",
        "replaces": "pyro2_tpu/solvers/swe/pallas_step.py:75",
        "launches": n_swe_quad + n_swe_kh,
        "max_abs_err": swe_err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    coef_launches = {**lm_launches, **general_launches}
    for name, line in (
            ("mg_core_vc", 150), ("mg_down_vc", 195), ("mg_up_vc", 218),
            ("mg_core_general", 150), ("mg_down_general", 195),
            ("mg_up_general", 218)):
        ms, p_ms, b_ms, b_by = mg_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/mg_vcycle.cu",
            "replaces": f"pyro2_tpu/multigrid/pallas_gen_mg.py:{line}",
            "launches": coef_launches[name],
            "max_abs_err": mg_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for name, line in (("lm_mac", 200), ("lm_rho", 227),
                       ("lm_states", 259)):
        ms, p_ms, b_ms, b_by = lm_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/lm_interface.cu",
            "replaces": f"pyro2_tpu/solvers/lm_atm/pallas_interface.py:{line}",
            "launches": lm_launches[name],
            "max_abs_err": lm_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    ms, p_ms, b_ms, b_by = sph_times
    kernels.append({
        "name": "ctu_step_spherical",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
        "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
        "launches": sph_launches,
        "max_abs_err": sph_err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    for name, line in (("ctu_periodic", 375), ("ctu_padin", 281),
                       ("ctu_ensemble", 478)):
        ms, p_ms, b_ms, b_by = padded_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
            "replaces":
                f"pyro2_tpu/solvers/compressible/pallas_step.py:{line}",
            "launches": padded[name][4],
            "max_abs_err": padded_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for stages in (1, 2, 3):
        name = f"ctu_periodic_s{stages}"
        ms, p_ms, b_ms, b_by = stage_times[stages]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
            "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:375",
            "launches": stage_launches[stages],
            "max_abs_err": padded_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for name, line in (("mg_deep_smooth", 87), ("mg_correct", 307)):
        ms, p_ms, b_ms, b_by = sharded_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/mg_deep.cu",
            "replaces": f"pyro2_tpu/multigrid/pallas_sharded_mg.py:{line}",
            "launches": sh_launches[name],
            "max_abs_err": sharded_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    # each new configuration's entry: the time and the float32 check of
    # one path (its grid and inputs), the launches of the paths that run
    # the configuration
    for name, label, keys in (
            ("ctu_step_problem_source", "heating",
             ("heating", "convection", "plume")),
            ("ctu_step_nvar6", "react_flame", ("react_rt", "react_flame"))):
        ms, p_ms, b_ms, b_by = src_times[label]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
            "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
            "launches": sum(src_paths[k][2] for k in keys),
            "max_abs_err": src_err[label],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for name, label, keys in (
            ("mol_rk_extended", "rk_sph_sedov",
             ("rk_heating", "rk_sph_sedov", "rk_hse_well_balanced")),
            ("mol_fv4_extended", "fv4_convection",
             ("fv4_convection", "sdc_convection"))):
        ms, p_ms, b_ms, b_by = mol_src_times[label]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/mol_substep.cu",
            "replaces": "pyro2_tpu/solvers/compressible_fv4/pallas_step.py:92",
            "launches": sum(mol_src_paths[k][1] for k in keys),
            "max_abs_err": mol_src_err[label],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    ms, p_ms, b_ms, b_by = hyper_times
    kernels.append({
        "name": "ctu_step_sharded",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
        "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
        "launches": hyper["quad"][2]["ctu_step"],
        "max_abs_err": seam_err["quad_hllc_outflow"],
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    ms, p_ms, b_ms, b_by = mol_sh_times
    kernels.append({
        "name": "mol_rk_sharded",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/mol_substep.cu",
        "replaces": "pyro2_tpu/solvers/compressible_fv4/pallas_step.py:92",
        "launches": mol_sh["rk"][2]["mol_rk"],
        "max_abs_err": mol_seam_err["rk_quad_hllc_outflow"],
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    for name, line in (("lm_mac", 200), ("lm_rho", 227),
                       ("lm_states", 259)):
        ms, p_ms, b_ms, b_by = lm_sh_times[name]
        kernels.append({
            "name": name + "_sharded",
            "route": "cuda",
            "source": "pyro2_tpu_torch/csrc/lm_interface.cu",
            "replaces": f"pyro2_tpu/solvers/lm_atm/pallas_interface.py:{line}",
            "launches": lm_sh[2][name],
            "max_abs_err": lm_seam_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    for label, name, source, replaces in (
            ("quad", "ctu_step_overlap", "pyro2_tpu_torch/csrc/ctu_step.cu",
             "pyro2_tpu/solvers/compressible/pallas_step.py:603"),
            ("swe_quad", "swe_step_overlap",
             "pyro2_tpu_torch/csrc/swe_step.cu",
             "pyro2_tpu/solvers/swe/pallas_step.py:75")):
        ms, p_ms, b_ms, b_by = overlap_times[label]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": overlap[label][1],
            "max_abs_err": overlap_err[label],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    ms, p_ms, b_ms, b_by = devdt_times
    kernels.append({
        "name": "ctu_step_device_dt",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
        "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
        "launches": devdt_launches,
        "max_abs_err": devdt_err["quad"],
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    ms, p_ms, b_ms, b_by = swe_devdt_times
    kernels.append({
        "name": "swe_step_dev",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/swe_step.cu",
        "replaces": "pyro2_tpu/solvers/swe/pallas_step.py:75",
        "launches": swe_devdt_launches,
        "max_abs_err": devdt_err["swe_quad"],
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    ms, p_ms, b_ms, b_by = sweep_times
    kernels.append({
        "name": "mg_sweep",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/mg_deep.cu",
        "replaces": "pyro2_tpu/parallel/sharded_mg.py:855",
        "launches": a20_launches,
        "max_abs_err": a20_err["mg_sweep"],
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    log(f"  lm_atm bubble 1024^2: {cycles_per_solve:.2f} multigrid cycles "
        "per solve")
    log(f"  quad 1024^2 float32 CTU step: peak device memory {ctu_peak} B "
        "above the state")
    log(f"  swe quad 1024^2 float32 step: peak device memory {swe_peak} B "
        "above the state")
    log(f"  quad 1024^2 float32 rk stage: peak device memory "
        f"{mol_peak['mol_rk']} B above the state")
    log(f"  acoustic_pulse 1024^2 float32 fv4 stage: peak device memory "
        f"{mol_peak['mol_fv4']} B above the state")
    log(smi)                            # the card, again, for the record
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    sys.exit(mg_tiles_main(parent) if "--mg-tiles" in args else main(parent))
