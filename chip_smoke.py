#!/usr/bin/env python3
"""Smoke run of the PyTorch port (membrane_solver_tpu_torch) on one NVIDIA GPU.

Phases, each printing its own lines; any failure raises and exits non-zero.
Every phase runs the card's default line-search form, the batched one
(``membrane_solver_tpu_torch/utils/tuning.py``), except where phases 55-57
set ``MEMBRANE_SOLVER_BATCHED_LS`` to compare the two.

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No CUDA device -> exit 2 before anything else.
2. build: compiles the CUDA sources of ``membrane_solver_tpu_torch/csrc``
   (``frozen_tilt.cu``, ``tri_kernels.cu``, ``vertex_sum.cu``, which share
   ``vertex_sum.cuh`` and ``block_sum.cuh``) with nvcc, one process per
   source, all started together; prints the seconds taken and the ptxas
   report.
3. kernels: every kernel against its plain PyTorch twin on the card, on the
   kozlov L3 lane's topology (10,817 vertices, 21,504 triangles) and the
   vesicle lane's (12,290 / 24,576), both built as phases 4-7 build them:
   - the frozen-tilt entry point, float32, seeded vertex tilts, P1
     gradients and payload at T = 301 and on the kozlov L3 topology, energy
     alone and energy plus vertex gradients: energy to rel 1e-6, gradients
     to 5e-6 * max|g|;
   - the vertex-sum kernel against its twin, equal bits (the same
     additions in the same order; ``check_vertex_sum``): float32 and
     float64, widths 1 and 3 and the weighted form on the kozlov L3 corner
     CSR, the dual-source forms inside the frozen-tilt gradient and the
     curvature data, the member entry at B = 1, 3 and 8 (member m the bits
     of a single launch), and a skewed slot CSR with rows at the kernel's
     chunk edges, one of 131 slots and one of a single -0.0;
   - the per-triangle kernels (surface, curvature forward and backward with
     per-triangle outputs), float32 and float64, on seeded
     triangles (T = 301) and on the vesicle lane's own triangles (its start
     positions plus a seeded 1e-3 perturbation), and the curvature data
     entry point and its backward (vertex sums) on both lanes: float32 to
     the JAX kernel tests' bounds (surface e rel 2e-6 / atol 1e-7, corner
     gradients rel 2e-5 / atol 1e-6, curvature and the masked divergence
     rel 5e-5 / atol 1e-5, curvature backward 5e-5 * max|g|), float64 to
     1e-12 * max(|want|, 1) (curvature backward 1e-11 * max|g|).  Curvature
     rows within 1e-6 of a Meyer branch tie (a cotangent at 0), and the
     vertex sums that include one, are left out: there the two sides may
     take different branches;
   - on the same three sets, float32 and float64, the surface and
     divergence whole calls: the surface energy (tension mask and sum in
     the kernel) alone and with its vertex gradient, the masked divergence
     and its tilt backward (the weighted vertex sum): energy to rel 2e-6
     (float32) / 1e-12 (float64), vertex gradients to 2e-5 / 1e-12 and the
     tilt backward to 5e-5 / 1e-12 of max|g|, the divergence to the
     per-triangle kernels' bounds;
   - determinism: two energy-plus-gradient calls of the frozen-tilt and
     the surface entry points, and two forward-plus-backward calls of
     ``curvature_data`` and of ``p1_triangle_divergence``, on the same
     inputs must give the same bits;
   - one such call of each of the four entry points under
     ``torch.profiler``: no index, scatter, gather, sort or reduction
     kernel of PyTorch's own may appear among its device operations;
   - timing, at the kozlov L3 lane's shapes, float32 (the rows that
     ``tools/time_torch_kernels.py`` also times on the vesicle lane and at
     float64): for every kernel, twin and
     caller, the device ms per call (``torch.profiler``'s device time of
     the operations one call issues, over 200 back-to-back calls), the
     event ms per call (CUDA events around 200 back-to-back calls), the
     host µs per call (the same loop, no sync) and the bound; the callers
     (a relax energy evaluation, an ``eval_grads``-style energy and vertex
     gradient, ``curvature_data`` forward, forward plus backward, the
     surface energy module forward plus backward, the bending-tilt
     divergence, forward plus tilt backward) also the median µs of one
     call followed by a device sync.
4. kozlov L3, float32: the kozlov coupled-tilt protocol that its fixture's
   ``protocol`` block records (meshgen ``kozlov_1disk`` with the bench
   global parameters -> three refinement rounds -> 10,817 vertices, 21,504
   triangles -> five ``minimize(1)`` calls), then ``minimize(2)`` as warm-up
   and ``minimize(5)`` timed.  Every energy must be finite and the last
   below the first.  Host syncs of one step are counted with
   ``torch.cuda.set_sync_debug_mode`` and listed by the source line that
   issued them.
5. kozlov L3, float64: the same protocol; its five energies must match the
   JAX package's recorded trajectory
   (``tests/fixtures/torch_port/kozlov_L3_f64_jax.json``) to rel 1e-8, and
   the float32 energies of phase 4 must lie within rel 2e-3 of them.  Then
   the per-triangle kernels, the surface and divergence whole calls and the
   curvature data against their twins, at float32 and float64 with phase
   3's tolerances, on this lane's own 21,504
   triangles as the run left them: one set per leaflet, with that leaflet's
   tilts and the ``tri_valid & tri_present`` mask its bending-tilt
   curvature call takes.
6. helfrich_cube L5, float32: the Helfrich vesicle protocol of
   ``helfrich_cube_L5_f64_jax.json`` (meshgen cube, surface + Helfrich
   bending, hard volume constraint -> polygonal refine and five triangle
   refines -> 12,290 vertices, 24,576 triangles -> five ``minimize(1)``
   calls at the adaptive step), then 2 warm-up and 5 timed steps.
7. helfrich_cube L5, float64: the same; rel 1e-8 against the JAX fixture,
   and phase 6's energies within rel 2e-3 of these.
8. cube_cli L5, float32: the command list of
   ``tests/fixtures/torch_port/cube_cli_L5_f64_jax.json`` (the recipe of
   ``meshes/cube.json``, ``g50; r; u; V2; ...; g200`` to 770 vertices; the
   stepper segment ``bfgs; g10; hessian 2; cg; g20; gd``; then ``r; u; V2;
   g20; r; u; V2; cg; g20; energy stats`` up to 12,290 vertices and 24,576
   triangles) through the port's command layer, in the command context
   that ``cli.make_context`` builds for ``-q --non-interactive -i
   meshes/cube.json --f32``.  Per command: the energy, the vertex and facet
   counts, the host seconds (a device sync on both sides), ms per step for
   ``g`` commands, and after each ``u`` a digest of the connectivity; then
   the host syncs of one more ``g1`` by source line.
9. cube_cli L5, float64: the same without ``--f32``; every energy within
   rel 1e-8 of the JAX fixture with equal vertex and facet counts, and
   phase 8's energies within rel max(2e-3, 2 x the JAX package's own
   float32 deviation on these commands, the fixture's
   ``float32_reference``: 2.34e-3) of these.  Near the recipe's minimum
   a float32 run's line searches can fail and its step size decay (the
   JAX package's does, at ``g200``), and it then falls behind on the L5
   extension.  Phase 8's connectivity after each ``u`` is printed beside
   this phase's.
    Phase 8 also holds its connectivity after each ``u`` against the JAX
    package's own float32 run (the fixture's ``float32_reference``
    digests) and prints whether they are equal.  Before phase 9 (ROADMAP
    C4, a ``[9 cube_cli_L5 C4]`` line): the port's float32 ``u`` from the
    JAX package's own float32 state before the last ``u``
    (``tests/fixtures/torch_port/cube_cli_f32_pre_u_jax.json.gz``) must give
    the JAX package's connectivity; printed with the state's smallest
    first-pass Delaunay margin against float32 round-off and, between
    phase 8's own state there and the JAX package's, the lowest edge id
    whose first-pass flip verdict differs and its margin in both.
10. the console entry: ``python -m membrane_solver_tpu_torch
    --non-interactive -q -i meshes/cube.json -o <tmp>`` in a subprocess, on
    the card (no ``--cpu``); it must exit 0, and the saved mesh, reloaded
    and evaluated by the port at float64 on the card, must be within rel
    1e-8 of the fixture's energy after the recipe (4.835205065742603).
11. square_to_circle L1, float32: the shape family's lane, the command list
    of ``tests/fixtures/torch_port/square_to_circle_L1_f64_jax.json``
    (meshgen ``square_to_circle`` at n = 56, 3,249 vertices and 6,272
    triangles, written to a JSON file and loaded by the CLI; its recipe
    ``g40; r; g40; u; V4; g60`` refines it to 12,769 vertices and 25,088
    triangles; ``surface`` at zero tension and ``line_tension`` on the
    boundary, under the hard ``global_area`` constraint, whose projection
    takes its area and gradient from the surface whole call) through the
    command layer as phases 8-9 run theirs, with the same per-command
    lines.
12. square_to_circle L1, float64: the same; every energy within rel 1e-8 of
    the fixture with equal counts, phase 11's within rel max(2e-3, 2 x the
    JAX package's own float32 deviation) of these.  Then, on this lane's
    12,769 vertices and 25,088 triangles as the run left them, the area
    constraints' entry ``surface_energy_and_gradient`` against its twin at
    the lane's own tension (``surface``, zero here) and at unit tension
    (``global_area``), float32 and float64, with phase 3's whole-call
    bounds, and phase 3's tri-kernel checks on the same triangles scaled
    to unit mean edge length.

13. rect_tilt_source L0, float32: the single-field tilt lane, the command
    list of ``tests/fixtures/torch_port/rect_tilt_source_L0_f64_jax.json``
    (meshgen ``rect_tilt_source`` at nx = 160, ny = 64: 10,465 vertices and
    20,480 right isosceles triangles on the builder's 5 x 2 sheet, a unit
    tilt held on one edge; ``surface`` at zero tension, ``tilt`` and
    ``tilt_smoothness``; its recipe ``g5``, nested tilt solve with 60 inner
    CG steps, as five ``g1``) through the command layer as phases 8-9 run
    theirs, with the same per-command lines, then a ``g1 split`` line: the
    host seconds of one more ``g1``, of one ``minimize(1)`` and of the
    ``g`` command's host collision scan, each synced.
14. rect_tilt_source L0, float64: the same; every energy within rel 1e-8 of
    the fixture with equal counts, phase 13's within rel max(2e-3, 2 x the
    JAX package's own float32 deviation) of these.  The curvature data's
    backward must not launch on either run (the smoothness term takes its
    cotangents on detached positions).  Then phase 3's tri-kernel checks,
    float32 and float64, on the sheet's triangles as the run left them
    (the flat sheet's right angles make nearly every row a Meyer branch
    tie, which the checks leave out and count) and on the same triangles
    perturbed by 1e-3.
15. kozlov L3 theta_B scan, float64 then float32: phase 5's (phase 4's)
    minimizer, back at the state its five protocol steps left (the saved
    state of its determinism check; no second refinement), with the scan
    parameters of ``tests/fixtures/torch_port/kozlov_L3_thetaB_f64_jax.json``
    (a scan every iteration, delta 0.01) and one ``minimize(3)``: relax ->
    scan -> step each iteration.  Per scan, the three candidates' energies
    beside the reference's and the selected theta_B, which must equal the
    fixture's (float64) or the JAX package's own float32 selections
    (float32); every candidate energy and the final one within rel 1e-8 of
    the fixture (float64) or within rel max(2e-3, 2 x the JAX package's own
    float32 deviation) of the float64 run (float32); the ``compile_state``
    calls during the call (the minimize-entry enforcement's recompile, as
    in the JAX package, and none after it: a scan's theta_B write
    refreshes the parameters only); the scans' host seconds.
16. kozlov L3 reduced, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_reduced_f64_jax.json`` (the kozlov
    protocol of phases 4-5 with ``line_search_reduced_energy`` on, its
    default 10 inner steps per trial, and ``rim_slope_match_mode``
    ``shared_rim_staggered_v1``; five ``minimize(1)``): every Armijo trial
    and the baseline re-relax both leaflet tilts before they are scored.
    Energies within rel 1e-8 of the fixture and the fixture's accept flag
    at every step; then ``minimize(3)`` timed after two warm-up steps
    (ms per step, line-search trials per step, accepted steps).
17. kozlov L3 reduced, float32: the same; energies within rel max(2e-3, 2
    x the JAX package's own float32 deviation, the fixture's
    ``float32_reference``) of phase 16's.  The frozen-tilt kernel's
    launches per ``minimize`` step (both variants) must exceed phase 4's:
    here it runs inside every trial's relax.  A ``[16-17 ...]`` line gives
    the two phases' seconds.
18. kozlov L3 smooth, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_smooth_f64_jax.json`` (the kozlov
    protocol of phases 4-5 with ``tilt_smoothness_in`` and
    ``tilt_smoothness_out`` added to its energy modules, the fixture's
    ``extra_energy_modules``; five ``minimize(1)``), then the determinism
    check and ``minimize(5)`` timed after two warm-up steps.  Energies
    within rel 1e-8 of the fixture with its accept flags; the breakdown's
    two smoothness terms within rel 1e-8 of the fixture's, floored at 1e-12
    of the lane's energy (the outer leaflet is undriven here: its tilts and
    its smoothness stay at round-off, ~2e-30 in the JAX package's own run),
    and nonzero where the fixture's is above that floor.  Its host syncs
    per ``minimize(1)`` are printed beside phase 5's.
19. kozlov L3 smooth, float32: the same; energies within rel max(2e-3, 2
    x the JAX package's own float32 deviation) of phase 18's, the JAX
    package's own float32 accept flags.  Then the fold, on the state the
    run left: the fused frozen-tilt energy the relax builds has both
    smoothness rigidities (``k_vec[4]``, ``k_vec[5]``) above 0, nonzero
    ``w_in`` and ``w_out`` payload columns and neither smoothness module
    in its per-module rest; the frozen-tilt kernel launched on every step
    (launches per step printed); and the entry point, energy alone and
    energy with gradients, against its twin on the lane's own g, payload
    and k_vec with the lane's tilts and with seeded tilts (energy rel
    1e-6, vertex gradients 5e-6 * max|g|).  The ms per step is printed
    beside phase 4's after the workers (phases 18-19 run in another group
    than phase 4).
20. kozlov L3 drives, float64 then float32: the kozlov L3 mesh after its
    refinements with ``tests/test_module_gradients_fd.py``'s set-up
    (``drives_setup``: its global parameters and module list plus
    ``tilt_smoothness_leaflet``, the rim ring tagged as the disk-target
    ring, the disk vertices in the disk-contact group, seeded tilts), the
    protocol of ``tests/fixtures/torch_port/kozlov_L3_drives_f64_jax.json``.
    For each of the ten leaflet tilt-field energies (the three smoothness
    modules, splay-twist, the three rim sources, the two disk targets and
    the disk contact), the energy and its gradients in the positions and
    both leaflet tilts on the fixture's inputs: float64 within rel 1e-10 of
    the fixture (gradients 1e-10 * max|g|), float32 against float64 within
    max(2e-3, 2 x the JAX package's own float32 deviation per module and
    field).  The divergence kernel and its tilt backward must launch
    inside ``tilt_splay_twist_in``.  An ``[18-20 ...]`` line gives the three
    phases' seconds.
21. kozlov L3 free disk, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_free_disk_f64_jax.json`` (the
    kozlov protocol of phases 4-5 with ``rigid_disk`` appended and no
    ``rigid_disk_group``: the 1,611 ``preset: disk`` vertices, whose own
    ``pin_to_plane`` is dropped at L0, ``lane_edits``), five ``minimize(1)``
    step by step, then the determinism check and 2 warm-up and 5 timed
    steps.  After every step the disk's anchor-pair distances equal the
    reference shape's to 1e-9 of the disk radius.  The accept flags and,
    per step, the multiplier-finite flag of the shape KKT solve (the JAX
    package's branch: non-finite multipliers skip the projection) equal
    the fixture's; per step the energy less ``tilt_thetaB_contact_in``
    within rel 1e-8 of the fixture's, every other term of the breakdown
    after the step within 1e-8 of the energy, and that work term within
    rel 1e-2 (it reads the refined disk group as a ring in angular order,
    and round-off in the rigid fit reorders it).  The line also gives the
    null-space fallback per step (``jit_core.solve_kkt_with_rescue``), the
    largest multiplier, ms per step and the seconds of the compact K x K
    solve (K = 4,827 pairwise rows plus the rim's).
22. kozlov L3 free disk, float32: the same; anchor pairs to 1e-5, energies
    within rel max(2e-3, 2 x the JAX package's own float32 deviation) of
    phase 21's; the flags beside the JAX package's own float32 ones.
23. kozlov L3 interface, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_interface_f64_jax.json`` (the
    kozlov protocol with ``rim_slope_match_out`` replaced by
    ``curved_local_interface_hard`` and the ``curved_local_interface_law``
    energy at strength 0.8), as phase 21 runs it (2 timed steps, not 5:
    the relax evaluates the whole tilt energy per iteration, 0.5-1.5 s per
    step): energies within rel 1e-8
    of the fixture with its accept flags, the breakdown's law term within
    rel 1e-8, floored at 1e-12 of the energy.  The relax projects every
    module's dense tilt rows (the hard row has no compact form): the row
    count is printed, and the compact path fails the phase.
24. kozlov L3 interface, float32: the same against phase 23 within rel
    max(2e-3, 2 x the JAX package's own float32 deviation).  The law has no
    frozen split (nor has the JAX package's), so this relax evaluates the
    whole tilt energy per iteration and the frozen-tilt kernel does not run.
25. kozlov L3 match drives, float64 then float32: the kozlov L3 mesh after
    its refinements with ``match_drives_setup`` (seeded heights and
    tilts, the rim and outer rings as the leaflet- and vector-match groups,
    the disk and its boundary ring as the rigid group with radius 1), the
    protocol of ``tests/fixtures/torch_port/kozlov_L3_match_drives_f64_jax.json``:
    on the fixture's inputs (``port_match_record``), the energies and
    gradients of ``curved_local_interface_penalty``, the soft
    ``rim_slope_match_out``, ``bending_tilt`` and ``mean_curvature_tilt``
    (exactly 0), the tilt rows and enforcement changes of
    ``tilt_leaflet_match_rim`` and ``tilt_vector_match_rim`` (three modes
    each) and ``curved_local_interface_match`` (vector_average,
    local_mixed_match_v1), and the rigid disk's double fit: float64 within
    1e-10 of the fixture, float32 within max(2e-3, 2 x the JAX package's own
    float32 deviation per item).  The curvature-data and divergence kernels
    and the divergence's tilt backward must launch inside ``bending_tilt``.
    A ``[21-25 ...]`` line gives the five phases' seconds.
26. kozlov L3 physical edge, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_physical_edge_f64_jax.json`` (the
    kozlov protocol with ``rim_slope_match_mode`` ``physical_edge_staggered_v1``,
    the disk-targeted flavour: the 1,601 disk rows matched to a 16-row
    shell, up to 101 conditions per shell row, enforced in levels) as
    phase 23 runs it (2 timed steps): energies within rel 1e-8 of the
    fixture with its accept flags, its ``trace_z`` decisions and each
    relax's accepted CG steps; the compiled shells (radii, conditions, shell
    rows, shared targets) equal to the fixture's, printed with the number of
    levels the shared rows run in; the host syncs of one ``minimize(1)``.
27. kozlov L3 physical edge, float32: the same against phase 26 within rel
    max(2e-3, 2 x the JAX package's own float32 deviation); the relax's
    accepted CG steps beside the JAX package's own float32 ones.  The
    frozen-tilt kernel runs in the relax.
28. kozlov L3 scaffold trace, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_scaffold_f64_jax.json`` (the trace
    shell at ``parity_trace_layer_radius`` 1.364262, three scaffold shells,
    ``theory_parity_lane``, the trace-reconstructed outer divergence, the
    ``trace_boundary_v1`` stencil and the ``trace_z`` fallback; the shells
    tagged after the refinements, ``lane_tags``), as phase 26.  The
    frozen-tilt kernel must not launch: it steps aside for the recovered and
    reconstructed divergence, as the JAX package's does.
29. kozlov L3 scaffold trace, float32: as phase 27, without the frozen-tilt
    kernel.  A ``[26-29 ...]`` line gives the four phases' seconds and the
    host syncs per ``minimize(1)`` of phases 5, 26 and 28.
30. kozlov L3 J0 fit, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_J0_fit_f64_jax.json`` (the inner
    leaflet's assume-J0 disk rows and the outer leaflet's physical-disk
    base-term region take a zero base term, the legacy theta_B contact
    penalty with its closed-form theta_B per iteration, the rim ring's
    ``pin_to_circle`` fit and the disk's ``pin_to_plane`` slide, set on the
    presets' definitions by ``lane_edits``), step by step: energies within
    rel 1e-8 of the fixture, its accept flags and relax counts, theta_B, the
    fitted rim circle and the slide plane offset per step within
    ``J0_FIT_ATOL``, no compile inside ``minimize``, the host syncs of one
    ``minimize(1)``.
31. kozlov L3 J0 fit, float32: the same against phase 30 within rel
    max(2e-3, 2 x the JAX package's own float32 deviation); the frozen-tilt
    kernel runs in the relax, and on the lane's payload, whose base columns
    are 0 on the zeroed rows, it holds against its twin.
32. kozlov L3 mode drives (``tests/fixtures/torch_port/kozlov_L3_mode_drives_f64_jax.json``):
    four problems on the L3 mesh with seeded heights and tilts, covering
    the bending-tilt in-update modes (the divergence cap binding on the
    seeded tilts), the flat-reference base term per leaflet, the
    assume-J0 presets with their radius clip, both base-term regions, the
    contact term's ``field_linear`` work and legacy penalty, the diagonal
    tilt mass and both pin constraints in their slide and fit modes:
    energies and gradients (sampled rows and norms), the frozen splits, the
    pin enforcements and normals, the closed-form theta_B and the
    Gauss-Bonnet invariant at float64 within 1e-10 of the fixture, float32
    against float64; a float32 relax makes no frozen-tilt launch under
    ``diagonal`` and the in-update modes; one ``check_gauss_bonnet`` call
    timed.  A ``[30-32 ...]`` line gives the three phases' seconds.
33. kozlov L3 parameter sweep, float64: the protocol of
    ``tests/fixtures/torch_port/kozlov_L3_sweep_f64_jax.json`` on the state
    phase 5 left after its five protocol steps (restored into a fresh L3
    minimizer): ``parallel.sweep.run_sweep`` with eight members
    (``sweep_members``: positions times 1 + 0.001 m, ``tilt_modulus_in``
    times 1 + 0.1 m, ``tilt_thetaB_value`` plus 0.01 m), five steps at
    1e-3, no tilt relax, as the JAX sweep; the member line search in the
    card's batched form (phase 58 holds it to the sequential one), as in
    every sweep phase.  Per member the energies, the
    gradient norm and the step size within rel 1e-8 of the fixture, its
    accept flags and iterations, the final positions' sketch (512 sampled
    rows and the norm) within 1e-8; each member equal in bits to a
    one-member sweep of that member (positions, tilts, every stat and
    flag; ``member_bits``); every kernel counter
    of the sweep, and of a sweep of B copies of it, equal to that of the
    one-member sweep whose line searches scored the most trial states (the
    launches do not grow with B); two
    sweeps from one state give equal sha256 digests; no ``compile_state``
    call inside the sweep.  The member-axis kernels on the members' final
    states (per-member seeded tilts): each against its member twin with
    phase 3's bounds, and member by member equal in bits to the
    single-member kernel.  Then ms per sweep step and member-steps per
    second at B = 1, 2, 4 and 8 (three steps each after a warm-up step) and
    the profiler's busy share of a one-step sweep at B = 8, each with the
    card's name and power limit.
34. kozlov L3 parameter sweep, float32: the same on phase 4's state; the
    members within rel max(2e-3, 2 x the JAX package's own float32
    deviation) of phase 33, the JAX package's own float32 flags; and the
    member-axis kernels timed at B = 8 (``[34 ... kernel timing]``).
35. the multi-disk sweep analysis on the card
    (``analysis.multidisk_sweep.run_sweep``, ``plot=False``): three meshgen
    cube meshes in a temporary directory; every key of every row within
    rel 1e-10 of the same analysis on the CPU at float64.  A ``[33-35
    ...]`` line gives the three phases' seconds and busy shares.
36. Helfrich vesicle L5 parameter sweep, float64: the protocol of
    ``tests/fixtures/torch_port/helfrich_cube_L5_sweep_f64_jax.json`` on
    the state phase 7 left after its five protocol steps, restored into a
    fresh vesicle minimizer whose global parameters also hold
    ``spontaneous_curvature`` 0.0: eight members (positions times 1 +
    0.001 m, ``bending_modulus`` times 1 + 0.1 m, ``spontaneous_curvature``
    0.1 m), five steps at 1e-3 with ``enforce_in_line_search`` (the lane's
    Minimizer's options).  Phase 33's checks (``drive_sweep``), the launch
    check on B copies of the member with the most trial states; at least
    one accepted member-step, in the fixture and on the card; no
    single-member launch; the final volume of every member that accepted a
    step within the lane's ``volume_tolerance`` of its target, and every
    member that accepted none on its start positions bit for bit (the
    dilated starts are 0.1-2.1% off the target, and only an accepted,
    enforced trial moves a member).  Then ms per sweep step and
    member-steps per second at B = 1, 8 and 32 and the busy share at B = 8.
    Before the timing, the volume drift check's projection: the members on
    the lane's own state with ``volume_tolerance`` 1e-9, three steps at the
    lane's own step size without per-trial enforcement, with and without
    ``volume_drift_check``: without it a stepped member's volume ends off
    by more than 1e-9, with it within 1e-9 (``[36 ... drift]``).
37. the same at float32 on phase 6's state, less the drift run, against
    phase 36 within rel max(2e-3, 2 x the JAX package's own float32
    deviation), with the JAX package's own float32 flags; each member
    equal in bits to its one-member sweep, as at float64.
38. square_to_circle L1 parameter sweep, float64: the protocol of
    ``square_to_circle_L1_sweep_f64_jax.json`` on the state at the end of
    phase 12's command list (12,769 vertices): four members (positions
    times 1 + 0.001 m, ``target_surface_area`` times 1 + 0.01 m), three
    steps with ``enforce_in_line_search``.  Phase 36's checks, the area of
    each member that accepted a step within 1e-10 of its target; the hard
    area's energy-and-gradient call under ``vmap`` launches
    ``tri_surface_energy_members`` (``surface_area_grad_members`` > 0) and
    no plain twin of the kernels is called inside the sweep
    (``counted_twins``); on the members' final
    states that call against its member twin (phase 3's bounds) and, member
    by member, equal in bits to the single call; the launch and its twin
    timed.  A ``[36-38 ...]`` line gives the three phases' seconds.
39. rect_tilt_source L0 tilt-decay sweep, float64: the protocol of
    ``tests/fixtures/torch_port/rect_tilt_source_L0_sweep_f64_jax.json``:
    the lane's command list (phase 14's, 160 x 64, 10,465 vertices) with
    ``tilt_smoothness_rigidity`` 1.0 set before it (the lane's kappa; the
    smoothness module reads 0 without it, and from the state the recipe
    leaves without it no member-step is ever accepted: the smoothness term
    has no shape gradient), each command's energy within rel 1e-8 of the
    fixture's; then eight members (positions times 1 + 0.001 m,
    ``tilt_modulus`` and the rigidity times 1 + 0.1 m), five steps at 1e-3
    under the default options.  Phase 33's checks (``drive_sweep``), at
    least one accepted member-step (in the fixture and on the card), no
    single-member launch and no plain twin called (``counted_twins``),
    every member's tilts after the sweep equal to the start's bit for bit;
    ms per sweep step at B = 1 and 8 and the busy share at 8.
40. the same at float32, against phase 39 within rel max(2e-3, 2 x the
    JAX package's own float32 deviation), with the JAX package's own
    float32 flags.
41. the leaflet tilt-field family over a member axis on kozlov L3, float64
    with float32 items: phase 20's set-up and phase 21's (with ``tilt`` and
    ``tilt_smoothness`` added, ``sweep_tilt_setup``) on their fixtures'
    inputs, four members with seeded offsets (``tilt_member_inputs``); each
    of the sixteen energy modules alone under ``torch.func.vmap`` (its
    energy and its gradients in the four fields, autograd through the map,
    as the sweep takes them) and each mode of the two tilt-match
    constraints (tilt rows, tilt enforcement) against the JAX package's
    ``jax.vmap`` in ``kozlov_L3_sweep_tilt_drives_f64_jax.json`` (rel
    1e-10, gradients of max|g|); member m of the map equal in bits to
    member m's single call; float32 against float64
    within max(2e-3, 2 x the JAX package's own float32 deviation per
    item); the member divergence kernel launched under
    ``tilt_splay_twist_in`` and ``bending_tilt``, the member curvature data
    under the smoothness modules and ``bending_tilt`` (``mean_curvature_tilt``
    is the reference's inert stub), no single-entry launch inside a map and
    no plain twin called.  A ``[39-41 ...]`` line gives the three phases'
    seconds and busy shares.
42-43. ``kozlov_L3_interface_sweep`` f64/f32 and 44-45.
    ``kozlov_L3_free_disk_sweep`` f64/f32 (``phase_lane_sweep``): four
    members from the state phases 23-24 and 21-22 saved (the free disk made
    uneven first, ``uneven_disk``), three steps, against
    ``kozlov_L3_{interface,free_disk}_sweep_f64_jax.json`` with
    ``drive_sweep``'s checks (float32: the energies against float64); the
    ordered rows' levels per enforcement; at 44-45 the shape KKT flags per
    member beside JAX's, the rigid fit mapped over the final states, and
    the final energy less the work term.
46. ``kozlov_L3_sweep_interface_drives`` (``phase_interface_drives``): the
    interface family and the rigid disk over four members under ``vmap`` on
    phase 25's set-up, against JAX's ``jax.vmap``, every member equal in
    bits to its single call.
47. ``kozlov_L3_viz_face_values`` (``phase_viz_face_values``): the
    visualization's face values on phase 23's state, card vs CPU, kernel 4
    vs its twin; matplotlib is never imported (checked again at the end).
    A ``[42-47 ...]`` line gives the six phases' seconds.
48-49. ``kozlov_L3_physical_edge_sweep`` f64/f32 and 50-51.
    ``kozlov_L3_scaffold_sweep`` f64/f32 (``phase_lane_sweep``): four
    members from the state phases 26-27 and 28-29 saved, three steps with
    the enforcement in every line-search trial (the lanes' own minimize
    enforces there), against
    ``kozlov_L3_{physical_edge,scaffold}_sweep_f64_jax.json`` with
    ``drive_sweep``'s checks; the ordered rows' levels and their builds
    (once per topology, before any map, ``counted_level_builds``); per
    member the ``trace_z`` fallbacks, and at 50-51 each member-step's
    fallback viability and accepted search beside JAX's (float64: equal).
52. ``kozlov_L3_sweep_physical_edge_drives`` (``phase_physical_edge_drives``):
    the scaffold lane's four tilt energies and, on both lanes, the rim
    placement's compact rows and enforcement over four members under
    ``vmap``, against JAX's ``jax.vmap``, every member equal in bits to its
    single call.  A ``[48-52 ...]`` line gives the five phases' seconds.
53. ``kozlov_L3_sweep_placed`` (``phase_sweep_placed``), float64 and
    float32: phase 33's (34's) sweep, eight members for five steps, placed
    with ``device_mesh`` on ``[cuda:0] * 2`` and ``[cuda:0] * 4`` (member
    groups in turn on one card): each member equal in bits to phase 33's
    (34's) own, the fields that are not printed (an empty list); each
    group in bits and launch for launch its unplaced sweep of the same
    members (``sweep.GROUP_RECORD``); two placed runs' digests equal.  Then
    two members for two steps on ``[cuda:0, cpu]`` (two host threads): the
    card member in bits its one-member sweep and the card's unplaced sweep
    of the two's member; the CPU member, which runs the kernels' plain
    twins (other arithmetic), within ``MEMBER_RTOL`` of the card's; launches
    in the card group only, the states back on the card.  With more than one card, the sweep on distinct cards, with
    ms per sweep step beside the card's name and power limit.
54. ``kozlov_L3_tensor_parallel`` (``phase_tensor_parallel``), float64 and
    float32, from phase 5's (4's) state: ``tp_energy_and_grad`` on
    ``[cuda:0] * 4`` against the one-card ``jit_core.make_energy_vg``
    (``TP_BARS``: energy rel 1e-12 and gradient 1e-11 * max|g| at float64,
    2e-6 and 2e-5 at float32), two calls in bits, every shard's own launch
    tally holding every kernel of the path; the same call on
    ``[cuda:0, cpu]`` (the CPU shard launching nothing); one
    ``tp_minimize_block`` step against the one-card block (energy to
    ``TP_BLOCK_RTOL``, the same accept flag, finite positions).  A
    ``[53-54 ...]`` line gives their seconds.
55. ``kozlov_L3_batched_ls`` (``phase_batched_ls``), float64, and
56. the same at float32: the batched line search (``utils/tuning``, the
    card's default, which every other phase runs) against the sequential
    one.  The kozlov L3 lane as phases 4-5 build it, then the bench
    protocol (2 warm-up and 3 timed ``minimize(1)`` steps) under each form
    from one saved state: equal accept flags, energies equal in bits and
    one sha256 of positions, tilts and energies; per step and form the ms,
    the line-search trials, the host syncs (a second run, whose digest must
    be the first's) and the member launches, which the batched form must
    make (the Armijo tail's trial energies; at float32 also
    ``frozen_tilt_members`` in the relax's tail) and the sequential form
    must not.  The line also prints the reduced-energy search's form
    (``jit_core.REDUCED_LS_FORM``: batched on the card).  At float32 then
    ``frozen_tilt_members`` on the relax's own fused inputs at this state
    and seeded tilts, at B = 1, 3 and 11: each member the bits of a single
    launch and of the entry point under ``torch.func.vmap``, and within rel
    1e-6 of its twin; its timing row at B = 11 waits for the quiet stage.
    A ``[55-56 ...]`` line gives their seconds.
57. ``kozlov_L3_reduced_batched_ls`` (``phase_reduced_batched_ls``, group 4),
    float64 then float32: the reduced-energy line search's batched form
    (candidates 1-9 relaxed together by the member-batched leaflet relax,
    ``tilt_relax.make_relax_leaflet_tilts_members``) against its sequential
    form, on phase 16's (17's) minimizer from the state its determinism check
    saved: three ``minimize(1)`` under each form, equal accept flags,
    energies equal in bits and one sha256; per step and form the ms, the
    trials, the host syncs and the member launches, which the batched form
    must make (at float32 kernel 1's member launches, energy and gradient)
    and the sequential form must not.  At float32 then ``frozen_tilt_members``
    with the gradient on the member relax's own per-member g and payload
    (taken from one batched step) and seeded tilts, at B = 1, 3 and 9: each
    member's energy and vertex gradients the bits of a single launch, within
    rel 1e-6 (energy) and 5e-6 of max|g| (gradients) of its twin; its
    timing row at B = 9 waits for the quiet stage.
58. the sweeps' member line search under both forms
    (``phase_sweep_forms``), float64 then float32, from the problems of
    phases 33-34 (``58 kozlov``, group 1: every member rejects every step,
    so every batched search scores a tail of 9 rows a member), 36-37
    (``58 vesicle``, group 2: members accept tail candidates) and 50-51
    (``58 scaffold``, group 6: the ``trace_z`` fallback's second search):
    the lane's sweep protocol under the sequential and then the batched
    form (``sweep_form_run``, the counts set to 0 just before each and read
    just after): every member's positions, tilts and stats but ``trials``
    equal in bits, one sha256, that of the sweep phase's own main run; per
    form the member surface-energy launches equal to the trial-energy maps
    (``member_block.SEARCH_RECORD``); at most three host reads a batched
    search; per form ms a step, host reads a block call, tail rows and
    chunks, member launches and peak GiB allocated.  The forms' timing
    (three steps each) waits for the quiet stage.  A ``[58 ...]`` line gives
    their seconds.

Every lane phase (4-9, 11-19, 21-24, 26-31) also checks determinism: from the state its
protocol leaves (phases 4-7, 16-19, 21-24 and 26-31: the five steps; phases 8-9 and
11-14: the command list; phase 15: its ``minimize(3)``), it saves the state, runs
``minimize(2)`` (``g2`` through the command layer), takes a sha256 of the
positions, the tilts and the energies, restores the state and runs again;
a ``[... determinism]`` line prints both digests, and unequal digests fail
the run.  A ``[phase seconds]`` line gives each phase's seconds, and the
last line before the kernels line the whole run's.

Phases 4-58 run in seven worker processes side by side (``GROUPS``, each
``python3 chip_smoke.py --worker <i>``; a group holds every phase whose state
a later phase of it reads), started once phase 3 has ended: the host drives
every lane and leaves the card idle most of a step.  Each worker hands the
allocator's unused cache back to the card after every phase (the
``[phase peak memory]`` line gives each phase's peak), and its lines are
printed whole, group by group, once all have ended; the lines that read
phases of several groups (the ``[16-17 ...]`` to ``[48-52 ...]`` lines, phase
17's launch check) follow them.  The member rows' timing behind the kernels
line (phases 34, 38, 56 and 57) and the sweeps' timing and busy-share lines (phases
33-34, 36-37, 39-40 and 58) wait for a quiet stage (:func:`quiet`): once every
worker has finished its lanes, each one times in turn while the others wait.
Every other time that phases 4-58 print (ms per step, host seconds, a phase's
seconds) is taken with the other workers running.

Phases 4-9 and 11-58 each drive one path with every kernel launch counter
set to 0 just before and read just after; a kernel of that path that was
never launched fails the run (phases 33-34: the member-axis surface
energy, both variants, curvature data and its backward, divergence and
vertex sum; 36-37: the same less the divergence; 38: the member-axis
surface energy, both variants, its area route and the vertex sum; 39-40:
the member-axis surface energy, both variants, curvature data and vertex
sum; 41: per module, as above; 42-45 and 48-51: as 33-34, the trial energy only
where a member scored a trial; 47: the divergence; 53: as 33-34, per placed run; 54: the
surface energy's gradient variant, curvature data and its backward, divergence and vertex
sum, on every shard; 55-57: per step, and the member launches of the batched form; 58: per
form, the member surface energy once per trial-energy map) (the
frozen-tilt entry point, both variants,
lies on the float32 kozlov paths with a frozen relax, phases 4, 15, 17, 19,
22, 27 and 31; the surface energy, both variants, and the vertex sum on phases
4-9, 11-19, 21-24 and 26-31; the curvature data forward on phases 4-9,
13-19 and 21-32 (on the cube paths through ``energy stats``), its backward
on phases 4-7, 15-19, 21-24 and 26-32; the divergence forward on the kozlov
paths 4-5, 15-19 and 21-32, and it and its tilt backward inside phase 20's
splay-twist, phase 25's ``bending_tilt`` and phase 32's bending-tilt modes).

The line before the last is a JSON object ``{"kernels": [...]}``: per entry
point, its launches over phases 4-9 and 11-58, its largest error against its twin,
and phase 3's device ms per call (``ms``), its twin's (``plain_ms``), the
bound, and, for the vertex sum, ``index_add_``'s (``library_ms``); the
member-axis entries' times are phase 34's at B = 8, float32, beside their
single-member entry's (``single_ms``); the area route's are phase 38's at
B = 4, float64; ``frozen_tilt_members``'s phase 56's at B = 11, float32, and
``frozen_tilt_members_grad``'s phase 57's at B = 9, float32.  The
card's name and power limit follow it again (``nvidia-smi``), and the
last line is ``{"ok": true, "device": {...}}``.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 chip_smoke.py
"""

from __future__ import annotations

import base64
import collections
import contextlib
import dataclasses
import gzip
import hashlib
import json
import math
import os
import pickle
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
KOZLOV_FIXTURE = FIXTURES / "kozlov_L3_f64_jax.json"
VESICLE_FIXTURE = FIXTURES / "helfrich_cube_L5_f64_jax.json"
CUBE_CLI_FIXTURE = FIXTURES / "cube_cli_L5_f64_jax.json"
SQUARE_FIXTURE = FIXTURES / "square_to_circle_L1_f64_jax.json"
RECT_FIXTURE = FIXTURES / "rect_tilt_source_L0_f64_jax.json"
THETAB_FIXTURE = FIXTURES / "kozlov_L3_thetaB_f64_jax.json"
REDUCED_FIXTURE = FIXTURES / "kozlov_L3_reduced_f64_jax.json"
SMOOTH_FIXTURE = FIXTURES / "kozlov_L3_smooth_f64_jax.json"
DRIVES_FIXTURE = FIXTURES / "kozlov_L3_drives_f64_jax.json"
FREE_DISK_FIXTURE = FIXTURES / "kozlov_L3_free_disk_f64_jax.json"
INTERFACE_FIXTURE = FIXTURES / "kozlov_L3_interface_f64_jax.json"
MATCH_FIXTURE = FIXTURES / "kozlov_L3_match_drives_f64_jax.json"
PHYSICAL_EDGE_FIXTURE = FIXTURES / "kozlov_L3_physical_edge_f64_jax.json"
SCAFFOLD_FIXTURE = FIXTURES / "kozlov_L3_scaffold_f64_jax.json"
J0_FIT_FIXTURE = FIXTURES / "kozlov_L3_J0_fit_f64_jax.json"
MODE_DRIVES_FIXTURE = FIXTURES / "kozlov_L3_mode_drives_f64_jax.json"
C4_FIXTURE = FIXTURES / "cube_cli_f32_pre_u_jax.json.gz"
CSRC = "membrane_solver_tpu_torch/csrc/"
# entry point -> (source, the TPU kernel or JAX function it replaces, the
# name of its timing rows, its launch counter)
KERNELS = {
    # the Pallas _fwd_kernel and _bwd_kernel, both behind the pallas_call at
    # frozen_tilt.py:186
    "frozen_tilt_energy": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:83",
                           "frozen_tilt_energy", "frozen_tilt.energy"),
    "frozen_tilt_energy_grad": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:111",
                                "frozen_tilt_energy_grad", "frozen_tilt.energy_grad"),
    # no Pallas kernel: the JAX package's segment sums (geo.scatter_add_rows)
    "vertex_sum": ("vertex_sum.cuh", "device/geo.py:95", "vertex_sum",
                   "vertex_sum.vertex_sum"),
    # _surface_kernel with the tension mask, the energy sum and the scatter
    # of its corner gradients
    "tri_surface_energy": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80", "surface_energy",
                           "tri_kernels.surface_energy"),
    "tri_surface_energy_grad": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80",
                                "surface_energy_grad", "tri_kernels.surface_energy_grad"),
    # _curvature_kernel with the stock geo.curvature_data scatter after it
    "tri_curvature_data": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:143",
                           "curvature_data", "tri_kernels.curvature_data"),
    # the backward JAX takes for curvature_corners_pallas (stock AD)
    "tri_curvature_data_bwd": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:193",
                               "curvature_data_bwd", "tri_kernels.curvature_data_bwd"),
    # _p1_div_kernel with the stock p1_triangle_divergence masks
    "tri_p1_div": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:228", "p1_div",
                   "tri_kernels.p1_div"),
    # the backward JAX takes for the divergence in the tilts (stock AD); no
    # lane path differentiates the tilts, so phase 3 alone launches it
    "tri_p1_div_bwd": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:262", "p1_div_bwd",
                       "tri_kernels.p1_div_bwd"),
    # the member axis of the parameter sweep (phases 33-34): the same kernels
    # over B stacked members, one launch, the members on the grid's y axis
    "tri_surface_energy_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80",
                                   "surface_energy_members",
                                   "tri_kernels.surface_energy_members"),
    "tri_surface_energy_grad_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80",
                                        "surface_energy_grad_members",
                                        "tri_kernels.surface_energy_grad_members"),
    "tri_curvature_data_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:143",
                                   "curvature_data_members",
                                   "tri_kernels.curvature_data_members"),
    "tri_curvature_data_bwd_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:193",
                                       "curvature_data_bwd_members",
                                       "tri_kernels.curvature_data_bwd_members"),
    "tri_p1_div_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:228",
                           "p1_div_members", "tri_kernels.p1_div_members"),
    "vertex_sum_members": ("vertex_sum.cuh", "device/geo.py:95", "vertex_sum_members",
                           "vertex_sum.vertex_sum_members"),
    # the area constraints' energy-and-gradient call over the members (phase
    # 38): the surface kernel's member launch at unit tension
    "tri_surface_area_grad_members": ("tri_kernels.cu", "pallas_kernels/tri_kernels.py:80",
                                      "surface_area_grad_members",
                                      "tri_kernels.surface_area_grad_members"),
    # the frozen-tilt energy over B stacked tilt pairs (the batched line search's relax
    # candidates, phases 55-56): the energy kernel with the members on the grid's y axis
    "frozen_tilt_members": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:83",
                            "frozen_tilt_members", "frozen_tilt.energy_members"),
    # the same with the vertex gradients, each member on its own g and payload (the member
    # relax of the batched reduced search, phase 57)
    "frozen_tilt_members_grad": ("frozen_tilt.cu", "pallas_kernels/frozen_tilt.py:111",
                                 "frozen_tilt_members_grad", "frozen_tilt.energy_grad_members"),
}
# each member-axis entry's single-member entry (its B = 1 time sits beside it)
SINGLE_OF = {"tri_surface_energy_members": "surface_energy",
             "tri_surface_energy_grad_members": "surface_energy_grad",
             "tri_curvature_data_members": "curvature_data",
             "tri_curvature_data_bwd_members": "curvature_data_bwd",
             "tri_p1_div_members": "p1_div", "vertex_sum_members": "vertex_sum",
             "frozen_tilt_members": "frozen_tilt_energy",
             "frozen_tilt_members_grad": "frozen_tilt_energy_grad"}
# the per-entry-point error keys of phases 3 and 5
ERRORS = {"frozen_tilt_energy": ("ft_energy",), "frozen_tilt_energy_grad": ("ft_energy", "ft_grad"),
          "vertex_sum": ("vertex_sum",),
          "tri_surface_energy": ("surface_energy", "surface_fwd"),
          "tri_surface_energy_grad": ("surface_energy", "surface_grad", "surface_fwd"),
          "tri_curvature_data": ("curvature_data", "curvature_fwd"),
          "tri_curvature_data_bwd": ("curvature_data_bwd", "curvature_bwd"),
          "tri_p1_div": ("p1_div",), "tri_p1_div_bwd": ("p1_div_bwd",),
          "tri_surface_energy_members": ("surface_energy_members",),
          "tri_surface_energy_grad_members": ("surface_energy_members", "surface_grad_members"),
          "tri_curvature_data_members": ("curvature_data_members",),
          "tri_curvature_data_bwd_members": ("curvature_data_bwd_members",),
          "tri_p1_div_members": ("p1_div_members",), "vertex_sum_members": ("vertex_sum_members",),
          "tri_surface_area_grad_members": ("surface_area_members", "surface_area_grad_members"),
          "frozen_tilt_members": ("ft_members",),
          "frozen_tilt_members_grad": ("ft_members_grad",)}
# PyTorch's own kernels that the redesigned entry points must not issue
LIBRARY_KERNEL = re.compile(r"index|scatter|gather|sort|reduce", re.IGNORECASE)
OWN_KERNELS = ("frozen_tilt_kernel", "vertex_sum_kernel", "curvature_fwd_kernel",
               "curvature_bwd_kernel", "curvature_data_kernel", "surface_kernel",
               "p1_div_kernel")

DEVICE = "cuda"
WARMUP_STEPS = 2
TIMED_STEPS = 5
REDUCED_TIMED_STEPS = 3  # phases 16-17: each step relaxes once per line-search trial
# phases 23-24: each relax iteration evaluates the whole tilt energy (the
# law has no frozen split), 0.5-1.5 s per step
INTERFACE_TIMED_STEPS = 2
PHYSICAL_TIMED_STEPS = 2  # phases 26-29: the shared shell rows' levels in every enforcement
J0_TIMED_STEPS = 2  # phases 30-31: one host sync and theta_B update per iteration
# phase 30: theta_B, the fitted rim circle and the slide plane per step vs the fixture
J0_FIT_ATOL = 1e-9

ENERGY_RTOL = 1e-6  # frozen-tilt kernel vs twin energy (f32 reduction order)
GRAD_RTOL = 5e-6  # frozen-tilt kernel vs twin gradient, relative to max|g|
F64_RTOL = 1e-8  # f64 trajectory vs the JAX fixture (CUDA scatter order)
F32_RTOL = 2e-3  # f32 vs f64 trajectory
DRIVES_F64_RTOL = 1e-10  # phases 20, 25: module values vs the JAX fixture (of |E|, of max|g|)
# phases 21-22: the rigid disk's anchor-pair distances vs the reference shape's,
# as a share of the disk radius (1)
PAIR_TOL = {"float64": 1e-9, "float32": 1e-5}
# phase 21: the scalar work term that reads the refined disk group as a ring
# in angular order; it carries no gradient, and round-off in the rigid fit
# reorders the patch (five orderings on this lane span 3e-3 of the term)
ORDER_TERM, ORDER_RTOL = "tilt_thetaB_contact_in", 1e-2
CONSOLE_TIMEOUT_S = 300  # phase 10's subprocess
# per-triangle kernels vs twins: (rtol, atol) elementwise at float32 (the JAX
# kernel tests' bounds), rtol of max(|want|, 1) at float64
TK_F32 = {"e": (2e-6, 1e-7), "g": (2e-5, 1e-6), "curv": (5e-5, 1e-5)}
TK_F64 = 1e-12
TK_BWD = {"float32": 5e-5, "float64": 1e-11}  # of max|g|
# the surface and divergence whole calls: energy rel; vertex sums of max|g|
WC_ENERGY = {"float32": 2e-6, "float64": 1e-12}
WC_SURFACE_GRAD = {"float32": 2e-5, "float64": 1e-12}
WC_DIV_BWD = {"float32": 5e-5, "float64": 1e-12}
TIE = 1e-6  # |cot| below this: a Meyer branch tie


# The card's published peaks (H100 SXM data sheet: memory rate, float32 and
# float64 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Floating-point operations per triangle, counted from the CUDA sources and
# rounded up (the gradient row is the frozen-tilt gradient's own work, on top
# of the energy's).  Every kernel here is bound by bytes by a factor of ten or
# more, so these only need the right order.
FLOPS_PER_TRI = {
    "frozen_tilt_energy": 190,
    "frozen_tilt_grad": 270,
    "surface_energy": 30,
    "surface_grad": 45,
    "curvature_fwd": 140,
    "curvature_bwd": 320,
    "p1_div": 80,
    "p1_div_bwd": 18,
}


def bound_ms(moved_bytes: int, flops: float, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


# timing work held back to the quiet stage, in the order it was registered
QUIET: list = []


def quiet(fn) -> None:
    """Hold ``fn`` (timing rows and lines) back to the quiet stage: every worker has
    finished its lanes, and the workers time one after another (:func:`main`)."""
    QUIET.append(fn)


def run_quiet() -> float:
    """Runs the held-back timing work; returns its seconds."""
    t0 = time.perf_counter()
    while QUIET:
        QUIET.pop(0)()
    return time.perf_counter() - t0


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    smi_text = smi_line()
    print(smi_text, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    say("1 device", name=repr(device["kind"]), count=device["count"],
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return device


def phase_build(mods) -> None:
    from membrane_solver_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(*(m.KERNEL for m in mods))  # one nvcc per source, in parallel
    for m in mods:
        m.build()
    seconds = time.perf_counter() - t0
    say("2 build", seconds=f"{seconds:.3f}",
        libraries=",".join(m.KERNEL.library_path().name for m in mods))
    for m in mods:
        for ln in m.KERNEL.log().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                say("2 build ptxas", source=m.KERNEL.name, line=repr(ln.strip()))


LOOP = 200  # back-to-back calls per timing
# profiled windows a timing row tries: the profiler has come back from a
# window of 200 kernel launches on the card with none of them (once in a
# whole run of this script) or with a third of them missing, which reads as
# a shorter call; a row keeps the first whole window, else the fullest
PROFILE_TRIES = 3
# profiled calls of a twin or a caller (hundreds of operations a call: the
# profiler's own cost grows with the operations it records); a hand
# kernel's row keeps LOOP (at 50 the profiler once saw no device operation)
PROFILED_PLAIN_CALLS = 10


def time_call(torch, fn, calls: int = LOOP, warmup: int = 5, profiled: int | None = None) -> dict:
    """Device and host time per call of ``fn`` over ``calls`` back-to-back calls.

    Inputs are prepared by the caller, outside the window.  Returns
    - ``event_ms``: CUDA events around the loop, divided by ``calls`` (the
      device's wall time per call; where the host is slower than the
      device this is the host's pace);
    - ``host_us``: ``time.perf_counter`` around the same loop, no sync;
    - ``device_ms``: the device time of the operations one call issues,
      summed from ``torch.profiler`` over a second loop of ``profiled``
      calls (``calls`` when None; no host gaps);
    - ``ops_per_call`` and ``ops``: those operations, by name;
    - ``windows``: the profiled loops it took (``PROFILE_TRIES``).
    """
    profiled = calls if profiled is None else profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    rows = []
    for windows in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                fn()
            torch.cuda.synchronize()
        window = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in window) > sum(e.count for e in rows):
            rows = window
        # whole: every operation seen once (or k times) per call
        if rows and all(e.count % profiled == 0 for e in rows):
            break
    if not rows:
        raise RuntimeError(f"the profiler recorded no device-side operation in {PROFILE_TRIES} "
                           "windows")
    return {
        "event_ms": start.elapsed_time(end) / calls,
        "host_us": host_s * 1e6 / calls,
        "device_ms": sum(e.self_device_time_total for e in rows) / 1e3 / profiled,
        "ops_per_call": sum(e.count for e in rows) / profiled,
        "ops": {e.key: e.count / profiled for e in rows},
        "windows": windows,
    }


def synced_us(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median host µs of one call followed by a device sync: what a caller that reads the result waits."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def device_ops(torch, fn) -> list:
    """Names of the device operations one call of ``fn`` issues (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


# ----------------------------------------------------------------------
# timing rows: (name, kind, fn, inputs and outputs' tensors, flops)
# ----------------------------------------------------------------------
CALLER_CALLS = 50  # caller-level loops issue several operations per call


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    if hasattr(out, "k_vecs"):  # CurvatureData
        return [out.k_vecs, out.vertex_areas, out.weights, out.corner_areas]
    return [out] if out is not None else []


def frozen_tilt_rows(torch, ft, topo, n_vertices: int) -> list:
    """(name, kind, fn, inputs, flops) for the frozen-tilt entry point, its twin and callers, float32.

    ``inputs`` are the function's own: the CSR counts only for the vertex
    sum, whose input it is (the entry point's gradient would need no CSR
    under another scatter design).
    """
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    rows = topo.tri_rows
    T = rows.shape[0]
    tin, tout, g, pay, k = _ft_inputs(torch, rows, n_vertices, 13)
    csr = topo.corner_csr()
    ws = ft.Workspace(T, rows.device)
    base = (tin, tout, rows, csr, g, pay, k)
    e_in = (tin, tout, rows, g, pay, k)
    corner = torch.randn((T, 3, 3), dtype=torch.float32, device=rows.device,
                         generator=torch.Generator(device=rows.device).manual_seed(13))
    flat_rows = rows.reshape(-1)
    out = torch.zeros((n_vertices, 3), dtype=torch.float32, device=rows.device)
    flops_e = FLOPS_PER_TRI["frozen_tilt_energy"] * T
    flops_g = flops_e + FLOPS_PER_TRI["frozen_tilt_grad"] * T

    def relax_energy():
        with torch.no_grad():
            return ft.frozen_tilt_energy(*base, ws)

    def eval_grads():
        a, b = tin.detach().requires_grad_(True), tout.detach().requires_grad_(True)
        return torch.autograd.grad(ft.frozen_tilt_energy(a, b, *base[2:], ws), (a, b))

    return [
        ("frozen_tilt_energy", "kernel", lambda: ft.launch(*base, ws, grad=False), e_in, flops_e),
        ("frozen_tilt_energy_grad", "kernel", lambda: ft.launch(*base, ws, grad=True), e_in,
         flops_g),
        ("frozen_tilt_energy", "twin", lambda: ft.reference_vertex(*base, grad=False), e_in,
         flops_e),
        ("frozen_tilt_energy_grad", "twin", lambda: ft.reference_vertex(*base, grad=True), e_in,
         flops_g),
        ("vertex_sum", "kernel", lambda: vs.launch(corner, csr), (corner, csr.offsets, csr.slots),
         corner.numel()),
        ("vertex_sum", "twin", lambda: vs.reference(corner, csr), (corner, csr.offsets, csr.slots),
         corner.numel()),
        ("vertex_sum", "library", lambda: out.index_add_(0, flat_rows, corner.reshape(-1, 3)),
         (corner, flat_rows), corner.numel()),
        ("frozen_tilt relax energy", "caller", relax_energy, e_in, flops_e),
        ("frozen_tilt eval_grads", "caller", eval_grads, e_in, flops_g),
    ]


def tri_rows_of(torch, tk, topo, positions, dtype) -> list:
    """(name, kind, fn, inputs, flops) for the per-triangle kernels, twins and callers."""
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device import tilt_ops
    from membrane_solver_tpu_torch.energy import surface

    rng = np.random.default_rng(19)
    rows, v = topo.tri_rows, topo.tri_valid
    T, n = rows.shape[0], positions.shape[0]
    dev = rows.device
    p = positions.to(dtype).contiguous()
    tl = torch.as_tensor(0.3 * rng.standard_normal((n, 3)), dtype=dtype, device=dev)
    gamma = torch.where(v, 1.0, 0.0).to(dtype)
    cts = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
           for s in ((T, 3), (T, 3, 3), (T, 3), (T,))]
    g_kvecs = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype, device=dev)
    g_varea = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
    csr = topo.corner_csr()
    d_in = (p, rows, v)
    b_in = d_in + (g_kvecs, g_varea)
    F = FLOPS_PER_TRI

    def corners(x):
        return [x[rows[:, i]] for i in range(3)]

    def data_fwd():
        with torch.no_grad():
            return tk.curvature_data(p, rows, v, csr)

    def data_fwd_bwd():
        x = p.detach().requires_grad_(True)
        cd = tk.curvature_data(x, rows, v, csr)
        return torch.autograd.grad((cd.k_vecs, cd.vertex_areas), (x,), (g_kvecs, g_varea))

    tension = topo.tri_surface_tension.to(dtype)
    s_topo = dataclasses.replace(topo, tri_surface_tension=tension)
    s_in = (p, rows, v, tension)
    ws = tk.Workspace(T, dtype, dev)

    def surface_fwd_bwd():
        x = p.detach().requires_grad_(True)
        e = surface.energy(None, types.SimpleNamespace(positions=x), s_topo, {})
        return (e.detach(),) + torch.autograd.grad(e, (x,))

    ct_div = cts[3]
    div_in = (p, tl, rows, v)

    def div_fwd():
        with torch.no_grad():
            return tk.p1_triangle_divergence(p, tl, rows, v, csr)

    def div_fwd_bwd():
        t = tl.detach().requires_grad_(True)
        div, area, g = tk.p1_triangle_divergence(p, t, rows, v, csr)
        return (div.detach(), area, g) + torch.autograd.grad(div, (t,), (ct_div,))

    g_div = tilt_ops.p1_triangle_divergence(p, tl, rows, v)[2]
    bwd_in = (g_div, v, ct_div)
    e_flops, g_flops = F["surface_energy"] * T, (F["surface_energy"] + F["surface_grad"]) * T

    return [
        ("surface_energy", "kernel",
         lambda: tk.launch_surface_energy(p, rows, v, tension, csr, ws, grad=False), s_in,
         e_flops),
        ("surface_energy", "twin",
         lambda: tk.surface_energy_reference(p, rows, v, tension, csr, False), s_in, e_flops),
        ("surface_energy_grad", "kernel",
         lambda: tk.launch_surface_energy(p, rows, v, tension, csr, ws, grad=True), s_in,
         g_flops),
        ("surface_energy_grad", "twin",
         lambda: tk.surface_energy_reference(p, rows, v, tension, csr, True), s_in, g_flops),
        ("p1_div", "kernel", lambda: tk.launch_p1_divergence(p, tl, rows, v), div_in,
         F["p1_div"] * T),
        ("p1_div", "twin", lambda: tilt_ops.p1_triangle_divergence(p, tl, rows, v), div_in,
         F["p1_div"] * T),
        ("p1_div_bwd", "kernel", lambda: tk.launch_p1_div_bwd(g_div, v, ct_div, csr), bwd_in,
         F["p1_div_bwd"] * T),
        ("p1_div_bwd", "twin", lambda: tk.p1_div_vjp_reference(g_div, v, ct_div, csr), bwd_in,
         F["p1_div_bwd"] * T),
        ("surface_fwd", "kernel", lambda: tk.launch_surface(p, rows, gamma), (p, rows, gamma),
         g_flops),
        ("surface_fwd", "twin", lambda: dgeo.surface_corner_terms(*corners(p), gamma),
         (p, rows, gamma), g_flops),
        ("curvature_fwd", "kernel", lambda: tk.launch_curvature(p, rows, v), d_in,
         F["curvature_fwd"] * T),
        ("curvature_fwd", "twin", lambda: dgeo.curvature_corners(*corners(p), v), d_in,
         F["curvature_fwd"] * T),
        ("curvature_bwd", "kernel", lambda: tk.launch_curvature_bwd(p, rows, v, *cts),
         (p, rows, v, *cts), F["curvature_bwd"] * T),
        ("curvature_bwd", "twin", lambda: tk.curvature_corners_vjp(p, rows, v, *cts),
         (p, rows, v, *cts), F["curvature_bwd"] * T),
        ("curvature_data", "kernel", lambda: tk.launch_curvature_data(p, rows, v, csr), d_in,
         F["curvature_fwd"] * T),
        ("curvature_data", "twin", lambda: tk.curvature_data_reference(p, rows, v, csr), d_in,
         F["curvature_fwd"] * T),
        ("curvature_data_bwd", "kernel",
         lambda: tk.launch_curvature_data_bwd(p, rows, v, csr, g_kvecs, g_varea, None, None),
         b_in, F["curvature_bwd"] * T),
        ("curvature_data_bwd", "twin",
         lambda: tk.curvature_data_vjp_reference(p, rows, v, csr, g_kvecs, g_varea, None, None),
         b_in, F["curvature_bwd"] * T),
        ("curvature_data", "caller", data_fwd, d_in, F["curvature_fwd"] * T),
        ("curvature_data fwd+bwd", "caller", data_fwd_bwd, b_in,
         (F["curvature_fwd"] + F["curvature_bwd"]) * T),
        ("surface energy fwd+bwd", "caller", surface_fwd_bwd, s_in, g_flops),
        ("bending-tilt divergence", "caller", div_fwd, div_in, F["p1_div"] * T),
        ("divergence fwd+tilt bwd", "caller", div_fwd_bwd, div_in + (ct_div,),
         (F["p1_div"] + F["p1_div_bwd"]) * T),
    ]


def measure(torch, rows: list, lane: str, dtype_name: str) -> list:
    """Times each row (``time_call``; callers also ``synced_us``) and computes its bound."""
    recs = []
    for name, kind, fn, inputs, flops in rows:
        outputs = _flat(fn())
        torch.cuda.synchronize()
        calls = CALLER_CALLS if kind == "caller" else LOOP
        timing = time_call(torch, fn, calls=calls,
                           profiled=calls if kind in ("kernel", "library")
                           else PROFILED_PLAIN_CALLS)
        moved = _nbytes(inputs) + _nbytes(outputs)
        bound, bound_by = bound_ms(moved, flops, dtype_name)
        rec = {"name": name, "kind": kind, "lane": lane, "dtype": dtype_name, "calls": calls,
               **{k: v for k, v in timing.items() if k != "ops"},
               "bytes": moved, "bound_ms": bound, "bound_by": bound_by,
               "ops": {k[:80]: c for k, c in timing["ops"].items()}}
        if kind == "caller":
            rec["synced_us"] = synced_us(torch, fn)
        recs.append(rec)
    return recs


# ----------------------------------------------------------------------
# phase 3: every kernel against its twin
# ----------------------------------------------------------------------
def _ft_inputs(torch, rows, nv: int, seed: int):
    """Seeded (t_in, t_out, g, payload, k_vec) float32 on the card for ``rows``' triangles."""
    rng = np.random.default_rng(seed)
    T = rows.shape[0]
    f32 = np.float32
    arrays = (
        rng.standard_normal((nv, 3)).astype(f32),
        rng.standard_normal((nv, 3)).astype(f32),
        rng.standard_normal((T, 3, 3)).astype(f32),
        np.abs(rng.standard_normal((T, 20))).astype(f32),
        rng.uniform(0.5, 2.0, 6).astype(f32),
    )
    return [torch.from_numpy(a).to(DEVICE) for a in arrays]


def check_frozen_tilt(torch, ft, rows, nv: int, seed: int) -> dict:
    """The entry point (energy alone, energy and gradients) vs its twin; max abs errors."""
    from membrane_solver_tpu_torch.device.state import corner_csr

    t_in, t_out, g, pay, k = _ft_inputs(torch, rows, nv, seed)
    return compare_frozen_tilt(torch, ft, rows, corner_csr(rows, nv), t_in, t_out, g, pay, k)


def compare_frozen_tilt(torch, ft, rows, csr, t_in, t_out, g, pay, k) -> dict:
    """One launch of each variant of the entry point vs ``reference_vertex`` on the same inputs."""
    ws = ft.Workspace(rows.shape[0], rows.device)
    want_e, want_in, want_out = ft.reference_vertex(t_in, t_out, rows, csr, g, pay, k, grad=True)
    e_only, _, _ = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=False)
    e, gin, gout = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
    e_err = max(abs(float(x) - float(want_e)) for x in (e_only, e))
    if not (math.isfinite(e_err) and e_err <= ENERGY_RTOL * abs(float(want_e))):
        raise AssertionError(f"T={rows.shape[0]}: kernel energy {float(e)!r} vs twin {float(want_e)!r}")
    g_err, g_rel = 0.0, 0.0
    for got, want in ((gin, want_in), (gout, want_out)):
        err = float(torch.max(torch.abs(got - want)))
        scale = float(torch.max(torch.abs(want)))
        if not err <= GRAD_RTOL * scale:
            raise AssertionError(f"T={rows.shape[0]}: vertex gradient error {err!r} > "
                                 f"{GRAD_RTOL} * {scale!r}")
        g_err, g_rel = max(g_err, err), max(g_rel, err / scale)
    return {"ft_energy": e_err, "ft_grad": g_err, "energy_rel_err": e_err / abs(float(want_e)),
            "grad_rel_err": g_rel}


def skewed_slot_case(chunk: int, width: int, seed: int = 31) -> dict:
    """A slot list whose rows straddle the vertex-sum kernel's chunks, with seeded values.

    The kernel takes a row's corners in chunks of ``chunk`` (C).  Row
    degrees 0, 1, C - 1, C, C + 1, 2C + 1 and 131, then 40 seeded rows of 0
    to 9, each row's slots in seeded order: the skew of ``state.slot_csr``'s
    group sums and spare row.  Numpy arrays: ``rows`` (K,) target rows over
    ``n_rows``, ``values`` (S / 3, 3[, 3]) float64 for the S slots of the
    padded list (row 1's one value -0.0, which sums to +0.0), and the
    weighted form's per-triple ``weight`` and ``mask``.
    """
    rng = np.random.default_rng(seed)
    degrees = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 131]
    degrees += rng.integers(0, 10, 40).tolist()
    rows = rng.permutation(np.repeat(np.arange(len(degrees)), degrees))
    n_slots = rows.size + (-rows.size) % 3
    values = rng.standard_normal((n_slots,) + ((width,) if width > 1 else ()))
    values[np.flatnonzero(rows == 1)] = -0.0
    return {"rows": rows, "n_rows": len(degrees),
            "values": values.reshape((n_slots // 3, 3) + values.shape[1:]),
            "weight": rng.standard_normal(n_slots // 3),
            "mask": rng.random(n_slots // 3) < 0.8}


def same_bits(torch, got, want) -> bool:
    """Equal shapes and equal bits (so -0.0 differs from +0.0, and a NaN equals itself)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype])))


def check_vertex_sum(torch, mods, kozlov) -> dict:
    """The vertex-sum kernel against its twin, equal bits in every launch form.

    On the kozlov L3 corner CSR: float32 and float64, widths 1 and 3, and
    the weighted form with a mask (``tri_p1_div_bwd``); the dual-source
    form inside ``frozen_tilt_energy_grad``, whose vertex rows must be the
    twin's sum of its two scratch slabs; the member entry at B = 1, 3 and
    8, member m the bits of a single launch on member m.  On a skewed slot
    CSR (``skewed_slot_case``: degrees at the kernel's chunk edges, a row
    of 131 slots, a -0.0 row): widths 1 and 3, both dtypes, weighted, three
    members, and the spare-row form ``row_sum`` launches on
    (``vertex_sum.summed_rows``: the spare row zero, the others the same
    bits).  Returns the kernel's chunk (``vertex_sum.CHUNK``) and the
    cases' names (all equal).
    """
    from membrane_solver_tpu_torch.device.state import slot_csr

    ft, tk, vs = mods
    topo, nv = kozlov.topo, kozlov.n_vertices
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T = rows.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cases = []

    def expect(name, got, want):
        if not same_bits(torch, got, want):
            err = float(torch.max(torch.abs(got.double() - want.double())))
            raise AssertionError(f"vertex_sum {name}: differs from its twin (max abs {err!r})")
        cases.append(name)

    def seeded(shape, dtype):
        return torch.randn(shape, dtype=dtype, device=DEVICE, generator=gen)

    def members(name, vals, csr_):
        got = vs.launch_members(vals, csr_)
        expect(f"{name} members B={vals.shape[0]}", got, vs.members_reference(vals, csr_))
        for m in range(vals.shape[0]):
            expect(f"{name} member {m} of {vals.shape[0]} vs single", got[m],
                   vs.launch(vals[m].contiguous(), csr_))

    for dtype in (torch.float32, torch.float64):
        d = str(dtype).removeprefix("torch.")
        for shape in ((T, 3), (T, 3, 3)):
            vals = seeded(shape, dtype)
            expect(f"L3 {d} width {1 if len(shape) == 2 else 3}", vs.launch(vals, csr),
                   vs.reference(vals, csr))
        g, w = seeded((T, 3, 3), dtype), seeded((T,), dtype)
        mask = valid & (torch.rand(T, device=DEVICE, generator=gen) < 0.8)
        expect(f"L3 {d} weighted", tk.launch_p1_div_bwd(g, mask, w, csr),
               tk.p1_div_vjp_reference(g, mask, w, csr))
    # the dual-source form inside the frozen-tilt gradient: both leaflets' rows
    t_in, t_out, g, pay, k = _ft_inputs(torch, rows, nv, 37)
    ws = ft.Workspace(T, DEVICE)
    _e, gin, gout = ft.launch(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
    expect("L3 frozen_tilt_energy_grad t_in", gin, vs.reference(ws.din_c, csr))
    expect("L3 frozen_tilt_energy_grad t_out", gout, vs.reference(ws.dout_c, csr))
    for B in (1, 3, 8):
        members("L3 float32 width 3", seeded((B, T, 3, 3), torch.float32), csr)
    members("L3 float64 width 1", seeded((3, T, 3), torch.float64), csr)

    for width in (1, 3):
        case = skewed_slot_case(vs.CHUNK, width)
        skew = slot_csr(torch.as_tensor(case["rows"], device=DEVICE), case["n_rows"])
        for dtype in (torch.float32, torch.float64):
            d = str(dtype).removeprefix("torch.")
            vals = torch.as_tensor(case["values"], dtype=dtype, device=DEVICE)
            expect(f"skewed {d} width {width}", vs.launch(vals, skew), vs.reference(vals, skew))
            kept = vs.summed_rows(skew)
            got = vs.launch(vals, kept)
            expect(f"skewed {d} width {width} without the spare row", got,
                   vs.reference(vals, kept))
            expect(f"skewed {d} width {width} kept rows as with the spare row", got[:-1],
                   vs.launch(vals, skew)[:-1])
            if bool(torch.any(got[-1] != 0)):
                raise AssertionError("vertex_sum: the emptied spare row is not zero")
            stack = torch.stack([vals, -vals, 2 * vals]).contiguous()
            members(f"skewed {d} width {width}", stack, skew)
            if width == 3:
                w = torch.as_tensor(case["weight"], dtype=dtype, device=DEVICE)
                mask = torch.as_tensor(case["mask"], device=DEVICE)
                expect(f"skewed {d} weighted", tk.launch_p1_div_bwd(vals, mask, w, skew),
                       tk.p1_div_vjp_reference(vals, mask, w, skew))
                ws3 = torch.stack([w, -w, 0.5 * w]).contiguous()
                got = tk.launch_p1_div_bwd_members(stack, mask, ws3, skew)
                for m in range(3):
                    expect(f"skewed {d} weighted member {m} vs single", got[m],
                           tk.launch_p1_div_bwd(stack[m].contiguous(), mask,
                                                ws3[m].contiguous(), skew))
    torch.cuda.synchronize()
    return {"chunk": vs.CHUNK, "cases": sorted(cases)}


def check_curvature_data(torch, tk, vs, kozlov) -> list:
    """The curvature whole calls in bits, on kozlov L3.

    The forward is one launch of a lane group per corner-CSR row, the
    backward the tiled kernel reading the vertex upstreams itself, then the
    vertex sum.  Each output equals the per-triangle entry points
    (``launch_curvature`` / ``launch_curvature_bwd``, the backward's vertex
    upstreams gathered under ``tri_rows`` beforehand) followed by the vertex
    sum over the corner CSR, as a launch and as its twin.  Float32 and float64;
    the lane's mask and every triangle invalid (m = 0); the backward with
    the path's upstreams (``k_vecs``, ``vertex_areas``) and with all four;
    a row longer than the vertex sum's chunk (the lane's degree-16 vertex);
    the member entries at B = 1, 3 and 8, member m the bits of a single
    call on member m.  Returns the cases' names (all equal).
    """
    topo, nv = kozlov.topo, kozlov.n_vertices
    rows, csr = topo.tri_rows, topo.corner_csr()
    T = rows.shape[0]
    if not csr.max_degree > vs.CHUNK:
        raise AssertionError(f"kozlov L3's busiest row has {csr.max_degree} corners, not more "
                             f"than the chunk {vs.CHUNK}")
    rng = np.random.default_rng(41)
    cases = []

    def expect(name, got, want):
        if not same_bits(torch, got, want):
            err = float(torch.max(torch.abs(got.double() - want.double())))
            raise AssertionError(f"curvature data {name}: differs (max abs {err!r})")
        cases.append(name)

    def seeded(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=DEVICE)

    def two_launch_bwd(p, valid, ups):
        g_kvecs, g_varea, g_cot, g_va = ups
        zeros = p.new_zeros((T, 3))
        g_k = (zeros[:, :, None].expand(T, 3, 3) if g_kvecs is None else g_kvecs[rows])
        g_va_c = zeros if g_va is None else g_va
        if g_varea is not None:
            g_va_c = g_va_c + g_varea[rows]
        g_cot = zeros if g_cot is None else g_cot
        return tk.launch_curvature_bwd(p, rows, valid, g_cot.contiguous(), g_k.contiguous(),
                                       g_va_c.contiguous(), zeros[:, 0].contiguous())

    for dtype in (torch.float32, torch.float64):
        d = str(dtype).removeprefix("torch.")
        p = kozlov.state.positions.detach().to(dtype).contiguous()
        for label, valid in (("lane mask", topo.tri_valid),
                             ("all invalid", torch.zeros_like(topo.tri_valid))):
            cot, va, k_vecs, areas = tk.launch_curvature_data(p, rows, valid, csr)
            cot1, k1, va1, _area = tk.launch_curvature(p, rows, valid)
            expect(f"{d} {label} cot", cot, cot1)
            expect(f"{d} {label} va", va, va1)
            for what, got, corner in (("k_vecs", k_vecs, k1), ("vertex_areas", areas, va1)):
                expect(f"{d} {label} {what} vs the vertex sum", got, vs.launch(corner, csr))
                expect(f"{d} {label} {what} vs its twin", got, vs.reference(corner, csr))
            full = [seeded(s, dtype) for s in ((nv, 3), (nv,), (T, 3), (T, 3))]
            for ups_label, ups in (("path upstreams", full[:2] + [None, None]),
                                   ("all upstreams", full)):
                dpos = tk.launch_curvature_data_bwd(p, rows, valid, csr, *ups)
                dc = two_launch_bwd(p, valid, ups)
                expect(f"{d} {label} backward {ups_label} vs the vertex sum", dpos,
                       vs.launch(dc, csr))
                expect(f"{d} {label} backward {ups_label} vs its twin", dpos,
                       vs.reference(dc, csr))
        for B in (1, 3, 8):
            ps = torch.stack([p * (1 + 0.001 * m) for m in range(B)]).contiguous()
            ups = [seeded((B,) + s, dtype) for s in ((nv, 3), (nv,), (T, 3), (T, 3))]
            got = tk.launch_curvature_data_members(ps, rows, topo.tri_valid, csr)
            dpos = tk.launch_curvature_data_bwd_members(ps, rows, topo.tri_valid, csr, *ups)
            for m in range(B):
                single = tk.launch_curvature_data(ps[m].contiguous(), rows, topo.tri_valid, csr)
                for what, a, b in zip(("cot", "va", "k_vecs", "vertex_areas"), got, single):
                    expect(f"{d} members B={B} member {m} {what} vs single", a[m], b)
                expect(f"{d} members B={B} member {m} backward vs single", dpos[m],
                       tk.launch_curvature_data_bwd(ps[m].contiguous(), rows, topo.tri_valid, csr,
                                                    *(u[m].contiguous() for u in ups)))
    torch.cuda.synchronize()
    return sorted(cases)


def check_unaligned_members(torch, tk) -> list:
    """The tiled member kernels where a member's (T, 3, 3) slab is not 16-byte aligned.

    At T = 301 a member's 9T values start off a 16-byte boundary (float32
    and float64), so the staged stores of the surface gradient, the P1
    shape gradients and the curvature backward's corner gradients go
    plainly there: three members, each the bits of a single call on its own.
    Returns the cases' names.
    """
    from membrane_solver_tpu_torch.device.state import corner_csr

    pos, rows_np, valid_np, tilts = _seeded_triangles(301, 43)
    rows = torch.as_tensor(rows_np, device=DEVICE)
    v = torch.as_tensor(valid_np, device=DEVICE)
    T, nv = rows.shape[0], pos.shape[0]
    csr = corner_csr(rows, nv)
    rng = np.random.default_rng(43)
    cases = []
    for dtype in (torch.float32, torch.float64):
        d = str(dtype).removeprefix("torch.")
        ps = torch.as_tensor(np.stack([pos * (1 + 0.01 * m) for m in range(3)]), dtype=dtype,
                             device=DEVICE)
        ts = torch.as_tensor(np.stack([tilts * (1 - 0.01 * m) for m in range(3)]), dtype=dtype,
                             device=DEVICE)
        tension = torch.as_tensor(rng.uniform(0.5, 2.0, T), dtype=dtype, device=DEVICE)
        ups = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=DEVICE)
               for s in ((3, nv, 3), (3, nv), (3, T, 3), (3, T, 3))]
        _e, g = tk.launch_surface_energy_members(ps, rows, v, tension, csr,
                                                 tk.MemberWorkspace(3, T, dtype, DEVICE), grad=True)
        div = tk.launch_p1_divergence_members(ps, ts, rows, v)
        dpos = tk.launch_curvature_data_bwd_members(ps, rows, v, csr, *ups)
        for m in range(3):
            p_m = ps[m].contiguous()
            single = {
                "surface gradient": (g[m], tk.launch_surface_energy(
                    p_m, rows, v, tension, csr, tk.Workspace(T, dtype, DEVICE), grad=True)[1]),
                "p1 shape gradients": (div[2][m], tk.launch_p1_divergence(
                    p_m, ts[m].contiguous(), rows, v)[2]),
                "curvature backward": (dpos[m], tk.launch_curvature_data_bwd(
                    p_m, rows, v, csr, *(u[m].contiguous() for u in ups))),
            }
            for what, (got, want) in single.items():
                if not same_bits(torch, got, want):
                    raise AssertionError(f"T=301 member {m} {what} ({d}) differs from its "
                                         "single call")
                cases.append(f"T=301 {d} member {m} {what}")
    torch.cuda.synchronize()
    return cases


def _seeded_triangles(T: int, seed: int):
    """(positions, tri_rows, valid, tilts) as float64 numpy: random distinct-corner triangles."""
    rng = np.random.default_rng(seed)
    nv = T // 2 + 3
    rows = rng.integers(0, nv, size=(T, 3))
    rows[:, 1] = (rows[:, 0] + 1 + rows[:, 1] % (nv - 2)) % nv
    rows[:, 2] = (rows[:, 1] + 1 + rows[:, 2] % (nv - 2)) % nv
    valid = np.ones(T, dtype=bool)
    valid[-7:] = False
    return rng.standard_normal((nv, 3)), rows, valid, 0.3 * rng.standard_normal((nv, 3))


def _lane_triangles(prob, seed: int, unit_edges: bool = False):
    """A lane's own triangles: its positions, perturbed by 1e-3, as numpy.

    With ``unit_edges``, the positions are first scaled to a mean edge
    length of 1: the float32 bounds are absolute at that scale, and every
    kernel here is scale-covariant.
    """
    rng = np.random.default_rng(seed)
    pos = prob.state.positions.detach().cpu().numpy()
    rows = prob.topo.tri_rows.cpu().numpy()
    if unit_edges:
        pos = pos / np.mean(np.linalg.norm(pos[rows] - pos[np.roll(rows, 1, axis=1)], axis=2))
    pos = pos + 1e-3 * rng.standard_normal(pos.shape)
    return pos, rows, prob.topo.tri_valid.cpu().numpy(), 0.3 * rng.standard_normal(pos.shape)


def _tk_check(torch, name, got, want, dtype, kind, rows=None) -> float:
    """Max abs error of kernel vs twin; raises beyond the stated tolerance."""
    if rows is not None:
        got, want = got[rows], want[rows]
    err = torch.abs(got - want)
    max_err = float(torch.max(err)) if err.numel() else 0.0
    if dtype == torch.float64:
        scale = max(float(torch.max(torch.abs(want))), 1.0)
        ok = max_err <= TK_F64 * scale
        bound = f"{TK_F64} * {scale!r}"
    else:
        rtol, atol = TK_F32[kind]
        ok = bool(torch.all(err <= atol + rtol * torch.abs(want)))
        bound = f"{atol} + {rtol} * |want|"
    if not (ok and math.isfinite(max_err)):
        raise AssertionError(f"{name} ({dtype}): max abs err {max_err!r} beyond {bound}")
    return max_err


def _bwd_check(torch, name, got, want, dtype, rows) -> float:
    if not bool(torch.any(rows)):
        return 0.0  # every row at a tie
    err = float(torch.max(torch.abs(got[rows] - want[rows])))
    scale = float(torch.max(torch.abs(want[rows])))
    if not err <= TK_BWD[str(dtype).removeprefix("torch.")] * scale:
        raise AssertionError(f"{name} ({dtype}): max abs err {err!r}, max|g| {scale!r}")
    return err


def _sum_check(torch, name, got, want, rtol: float) -> float:
    """Max abs error of a vertex sum (or a scalar) against its twin, within rtol of max|want|."""
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: max abs err {err!r} beyond {rtol} * {scale!r}")
    return err


def check_whole_calls(torch, tk, p, t_rows, v, tl, csr, seed: int) -> dict:
    """The surface and divergence whole calls vs their twins: max abs errors.

    The surface energy alone and with its vertex gradient (a seeded tension
    on every triangle, masked by ``v`` in the kernel), the masked divergence
    and its tilt backward (on the twin's shape gradients and a seeded
    upstream).
    """
    from membrane_solver_tpu_torch.device import tilt_ops

    dtype, T = p.dtype, t_rows.shape[0]
    name = str(dtype).removeprefix("torch.")
    rng = np.random.default_rng(seed + 1)
    tension = torch.as_tensor(rng.uniform(0.5, 2.0, T), dtype=dtype, device=DEVICE)
    ws = tk.Workspace(T, dtype, DEVICE)
    e_only, _ = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=False)
    e, dpos = tk.launch_surface_energy(p, t_rows, v, tension, csr, ws, grad=True)
    want_e, want_g = tk.surface_energy_reference(p, t_rows, v, tension, csr, True)
    errs = {
        "surface_energy": max(_sum_check(torch, f"surface energy ({name})", x[0], want_e,
                                         WC_ENERGY[name]) for x in (e_only, e)),
        "surface_grad": _sum_check(torch, f"surface vertex gradient ({name})", dpos, want_g,
                                   WC_SURFACE_GRAD[name]),
    }
    div, area, g = tk.launch_p1_divergence(p, tl, t_rows, v)
    want = tilt_ops.p1_triangle_divergence(p, tl, t_rows, v)
    errs["p1_div"] = max(
        _tk_check(torch, "masked p1 div", div, want[0], dtype, "curv"),
        _tk_check(torch, "masked p1 area", area, want[1], dtype, "curv"),
        _tk_check(torch, "masked p1 g", g, want[2], dtype, "curv"),
    )
    ct = torch.as_tensor(rng.standard_normal(T), dtype=dtype, device=DEVICE)
    errs["p1_div_bwd"] = _sum_check(torch, f"p1 div tilt backward ({name})",
                                    tk.launch_p1_div_bwd(want[2], v, ct, csr),
                                    tk.p1_div_vjp_reference(want[2], v, ct, csr), WC_DIV_BWD[name])
    return errs


def check_tri_kernels(torch, tk, arrays, dtype, seed: int, data: bool) -> tuple[dict, int]:
    """The per-triangle kernels, the surface and divergence whole calls (and, with
    ``data``, the curvature data) vs their twins.

    Returns the max abs errors and the number of rows left out at a tie.
    """
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device.state import corner_csr

    pos, rows, valid, tilts = arrays
    dev = DEVICE
    p = torch.as_tensor(pos, dtype=dtype, device=dev)
    t_rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    v = torch.as_tensor(valid, device=dev)
    tl = torch.as_tensor(tilts, dtype=dtype, device=dev)
    T = t_rows.shape[0]
    corners = [p[t_rows[:, i]] for i in range(3)]
    csr = corner_csr(t_rows, p.shape[0])
    errs = check_whole_calls(torch, tk, p, t_rows, v, tl, csr, seed)

    gamma = torch.where(v, 1.7, 0.0).to(dtype)
    e, g = tk.launch_surface(p, t_rows, gamma)
    want = dgeo.surface_corner_terms(*corners, gamma)
    errs["surface_fwd"] = max(_tk_check(torch, "surface e", e, want[0], dtype, "e"),
                              _tk_check(torch, "surface g", g, torch.stack(want[1:], 1), dtype, "g"))

    cot, k, va, area = tk.launch_curvature(p, t_rows, v)
    want = dgeo.curvature_corners(*corners, v)
    clear = ~(v & torch.any(torch.abs(want[0]) < TIE, dim=1))
    errs["curvature_fwd"] = max(
        _tk_check(torch, "curvature cot", cot, want[0], dtype, "curv", clear),
        _tk_check(torch, "curvature k", k, torch.stack(want[1:4], 1), dtype, "curv", clear),
        _tk_check(torch, "curvature va", va, want[4], dtype, "curv", clear),
        _tk_check(torch, "curvature area", area, want[5], dtype, "curv"),
    )

    rng = np.random.default_rng(seed)
    cts = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)
           for s in ((T, 3), (T, 3, 3), (T, 3), (T,))]
    dp = tk.launch_curvature_bwd(p, t_rows, v, *cts)
    want = tk.curvature_corners_vjp(p, t_rows, v, *cts)
    errs["curvature_bwd"] = _bwd_check(torch, "curvature bwd", dp, want, dtype, clear)

    if data:
        vclear = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        vclear[t_rows[~clear].reshape(-1)] = False  # vertex sums free of tie rows
        got = tk.launch_curvature_data(p, t_rows, v, csr)
        want = tk.curvature_data_reference(p, t_rows, v, csr)
        errs["curvature_data"] = max(
            _tk_check(torch, "curvature data " + name, a, b, dtype, "curv", rows_ok)
            for a, b, name, rows_ok in zip(got, want, ("cot", "va", "k_vecs", "vertex_areas"),
                                           (clear, clear, vclear, vclear)))
        ups = (torch.as_tensor(rng.standard_normal((p.shape[0], 3)), dtype=dtype, device=dev),
               torch.as_tensor(rng.standard_normal(p.shape[0]), dtype=dtype, device=dev),
               cts[0], cts[2])
        dpos = tk.launch_curvature_data_bwd(p, t_rows, v, csr, *ups)
        want = tk.curvature_data_vjp_reference(p, t_rows, v, csr, *ups)
        errs["curvature_data_bwd"] = _bwd_check(torch, "curvature data bwd", dpos, want, dtype,
                                                vclear)

    torch.cuda.synchronize()
    return errs, int(T - int(torch.sum(clear)))


def check_tri_sets(torch, tk, phase: str, sets, errs_out: dict) -> None:
    """check_tri_kernels at float32 and float64 on each (label, arrays, seed, data); folds max errors."""
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for label, arrays, seed, data in sets:
            errs, ties = check_tri_kernels(torch, tk, arrays, dtype, seed, data)
            say(phase, dtype=name, inputs=repr(label), live_rows=int(np.sum(arrays[2])),
                tie_rows_left_out=ties, **{k: repr(v) for k, v in errs.items()})
            for k, v in errs.items():
                errs_out[k] = max(errs_out.get(k, 0.0), v)


def kozlov_triangles(torch, mn) -> list:
    """The kozlov lane's own kernel inputs after its run, one set per leaflet.

    Positions and that leaflet's tilts as the run left them, and the mask
    its bending-tilt curvature call takes (``tri_valid & tri_present``).
    """
    from membrane_solver_tpu_torch.energy.leaflet_presence import present_triangles

    p = mn.problem()
    pos = p.state.positions.detach().cpu().numpy()
    rows = p.topo.tri_rows.cpu().numpy()
    sets = []
    for leaflet, tilts in (("in", p.state.tilts_in), ("out", p.state.tilts_out)):
        present = present_triangles(p.topo, leaflet)
        keep = p.topo.tri_valid if present is None else p.topo.tri_valid & present
        sets.append((f"kozlov leaflet {leaflet} T={rows.shape[0]}",
                     (pos, rows, keep.cpu().numpy(), tilts.detach().cpu().numpy()), 19, True))
    return sets


def sheet_triangles(prob) -> list:
    """The rect sheet's triangles as a run left them, and the same perturbed by 1e-3."""
    pos = prob.state.positions.detach().cpu().numpy()
    rows = prob.topo.tri_rows.cpu().numpy()
    tilts = 0.3 * np.random.default_rng(37).standard_normal(pos.shape)
    valid = prob.topo.tri_valid.cpu().numpy()
    return [(f"rect sheet T={rows.shape[0]}", (pos, rows, valid, tilts), 37, True),
            (f"rect sheet T={rows.shape[0]} +1e-3", _lane_triangles(prob, 37), 37, True)]


def check_area_calls(torch, tk, phase: str, prob, errs_out: dict) -> None:
    """The surface whole call as the square_to_circle path calls it, on that lane's last triangles.

    ``surface_energy_and_gradient`` against ``surface_energy_reference(...,
    True)`` at the topology's own tension (``surface``, zero on this lane)
    and at unit tension (``global_area``), both masked by ``tri_valid``, at
    float32 and float64 with phase 3's whole-call bounds; then phase 3's
    tri-kernel checks on the same triangles, scaled to unit mean edge
    length (the lane's edges are ~0.009 long, and a 1e-3 perturbation there
    makes slivers whose float32 divergence exceeds the unit-scale bounds by
    round-off alone).
    """
    topo = prob.topo
    rows, valid, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        pos = prob.state.positions.detach().to(dtype)
        ws = tk.workspace(topo, pos)
        tension = topo.tri_surface_tension.to(dtype)
        for module, t in (("surface", tension), ("global_area", torch.ones_like(tension))):
            e, g = tk.surface_energy_and_gradient(pos, rows, valid, t, csr, ws)
            want_e, want_g = tk.surface_energy_reference(pos, rows, valid, t, csr, True)
            errs = {
                "surface_energy": _sum_check(torch, f"{module} area call energy ({name})", e,
                                             want_e, WC_ENERGY[name]),
                "surface_grad": _sum_check(torch, f"{module} area call gradient ({name})", g,
                                           want_g, WC_SURFACE_GRAD[name]),
            }
            say(phase, dtype=name, module=module, T=rows.shape[0], max_tension=repr(float(t.max())),
                energy=repr(float(e)), **{k: repr(v) for k, v in errs.items()})
            for k, v in errs.items():
                errs_out[k] = max(errs_out.get(k, 0.0), v)
    check_tri_sets(torch, tk, phase + " tri kernels",
                   ((f"square_to_circle T={rows.shape[0]}, unit edges",
                     _lane_triangles(prob, 17, unit_edges=True), 17, True),),
                   errs_out)


def check_determinism(torch, ft, tk, kozlov) -> dict:
    """Two energy-plus-gradient calls of each redesigned entry point give the same bits.

    The frozen-tilt energy and the surface energy with their gradients, the
    curvature data and the divergence forward with their backwards.
    Also runs one such call of each under torch.profiler and fails on a
    PyTorch index, scatter, gather, sort or reduction kernel among its
    device operations.  Returns the device operations by entry point.
    """
    topo, nv = kozlov.topo, kozlov.n_vertices
    rows, csr = topo.tri_rows, topo.corner_csr()
    t_in, t_out, g, pay, k = _ft_inputs(torch, rows, nv, 23)
    ws = ft.Workspace(rows.shape[0], rows.device)
    pos = kozlov.state.positions.detach().to(torch.float32)
    rng = np.random.default_rng(29)
    ups = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=DEVICE)
           for s in ((nv, 3), (nv,), (rows.shape[0], 3))]

    def frozen_tilt():
        a, b = t_in.detach().requires_grad_(True), t_out.detach().requires_grad_(True)
        e = ft.frozen_tilt_energy(a, b, rows, csr, g, pay, k, ws)
        return (e.detach(),) + torch.autograd.grad(e, (a, b))

    def curvature():
        x = pos.detach().requires_grad_(True)
        cd = tk.curvature_data(x, rows, topo.tri_valid, csr)
        outs = (cd.k_vecs, cd.vertex_areas, cd.corner_areas)
        return tuple(o.detach() for o in outs) + torch.autograd.grad(outs, (x,), tuple(ups))

    tension = topo.tri_surface_tension.to(torch.float32)
    s_ws = tk.Workspace(rows.shape[0], torch.float32, DEVICE)
    tilts = torch.as_tensor(0.3 * rng.standard_normal((nv, 3)), dtype=torch.float32, device=DEVICE)
    ct = torch.as_tensor(rng.standard_normal(rows.shape[0]), dtype=torch.float32, device=DEVICE)

    def surface():
        x = pos.detach().requires_grad_(True)
        e = tk.surface_energy(x, rows, topo.tri_valid, tension, csr, s_ws)
        return (e.detach(),) + torch.autograd.grad(e, (x,))

    def divergence():
        t = tilts.detach().requires_grad_(True)
        div, area, grads = tk.p1_triangle_divergence(pos, t, rows, topo.tri_valid, csr)
        return (div.detach(), area, grads) + torch.autograd.grad(div, (t,), (ct,))

    ops = {}
    for name, fn in (("frozen_tilt_energy", frozen_tilt), ("curvature_data", curvature),
                     ("surface_energy", surface), ("p1_triangle_divergence", divergence)):
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name}: two energy-plus-gradient calls differ")
        ops[name] = device_ops(torch, fn)
        bad = [n for n in ops[name]
               if LIBRARY_KERNEL.search(n) and not any(o in n for o in OWN_KERNELS)]
        if bad:
            raise AssertionError(f"{name}: PyTorch's own index/scatter/reduction kernels ran: {bad}")
        say("3 determinism", entry=name, repeat_equal=True,
            device_ops=json.dumps([n[:60] for n in ops[name]]))
    return ops


def time_kernels(torch, ft, tk, kozlov) -> dict:
    """Every timing row at the kozlov L3 lane's shapes, float32, keyed by (name, kind)."""
    rows = frozen_tilt_rows(torch, ft, kozlov.topo, kozlov.n_vertices)
    rows += tri_rows_of(torch, tk, kozlov.topo, kozlov.state.positions.detach(), torch.float32)
    recs = measure(torch, rows, "kozlov_L3", "float32")
    for r in recs:
        say("3 timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                           for k, v in r.items() if k != "ops"})
    return {(r["name"], r["kind"]): r for r in recs}


def phase_kernels(torch, mods, kozlov, vesicle) -> dict:
    """Phase 3 on the two lanes' topologies: checks, determinism, profile check, timing."""
    ft, tk, vs = mods
    errs = {}
    for label, rows, nv, seed in (
            ("T=301", *_seeded_ft_rows(torch, 301, 7), 7),
            (f"kozlov T={kozlov.n_tris}", kozlov.topo.tri_rows, kozlov.n_vertices, 13)):
        e = check_frozen_tilt(torch, ft, rows, nv, seed)
        say("3 frozen tilt", inputs=repr(label), energy_abs_err=repr(e["ft_energy"]),
            energy_rel_err=repr(e["energy_rel_err"]), grad_max_abs_err=repr(e["ft_grad"]),
            grad_err_of_max_g=repr(e["grad_rel_err"]))
        for key in ("ft_energy", "ft_grad"):
            errs[key] = max(errs.get(key, 0.0), e[key])
    checked = check_vertex_sum(torch, mods, kozlov)
    errs["vertex_sum"] = 0.0
    say("3 vertex sum", T=kozlov.n_tris, chunk=checked["chunk"], equal_to_twin=True,
        cases=len(checked["cases"]), names=json.dumps(checked["cases"]))
    curv_cases = check_curvature_data(torch, tk, vs, kozlov)
    say("3 curvature data", T=kozlov.n_tris, max_degree=kozlov.topo.corner_csr().max_degree,
        chunk=vs.CHUNK, equal=True, cases=len(curv_cases), names=json.dumps(curv_cases))
    odd = check_unaligned_members(torch, tk)
    say("3 unaligned members", T=301, members=3, equal=True, cases=len(odd))
    check_tri_sets(torch, tk, "3 tri kernels", (
        ("T=301", _seeded_triangles(301, 7), 7, False),
        (f"vesicle T={vesicle.n_tris}", _lane_triangles(vesicle, 17), 17, True),
        (f"kozlov T={kozlov.n_tris}", _lane_triangles(kozlov, 17), 17, True),
    ), errs)
    check_determinism(torch, ft, tk, kozlov)
    return {"errs": errs, "timing": time_kernels(torch, ft, tk, kozlov)}


def _seeded_ft_rows(torch, T: int, seed: int):
    """(tri_rows on the card, vertex count) of seeded distinct-corner triangles."""
    _pos, rows, _valid, _tilts = _seeded_triangles(T, seed)
    return torch.as_tensor(rows, device=DEVICE), T // 2 + 3


# ----------------------------------------------------------------------
# the main paths
# ----------------------------------------------------------------------
def load_fixture(path: Path = KOZLOV_FIXTURE) -> dict:
    """A JAX trajectory and the protocol it was recorded with.

    The fixture's ``protocol`` block (mesh, modules, global parameters, step
    size, refinement rounds, steps) is what ``run_protocol`` runs, so the
    two cannot drift.
    """
    fixture = json.loads(path.read_text())
    proto = fixture["protocol"]
    if proto["mesh"] not in ("meshgen kozlov_1disk", "meshgen cube") or proto["dtype"] != "float64":
        raise AssertionError(f"unexpected fixture protocol: {proto}")
    if len(fixture["energies"]) != proto["steps"] or proto["steps"] < 2:
        raise AssertionError(f"fixture holds {len(fixture['energies'])} energies for {proto['steps']} steps")
    return fixture


def build_lane(torch, protocol: dict, dtype):
    """A fixture protocol's lane on the card up to its first step: build, parse, refine."""
    from membrane_solver_tpu_torch import Minimizer, parse_geometry
    from membrane_solver_tpu_torch.meshgen import build
    from membrane_solver_tpu_torch.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    if protocol["mesh"] == "meshgen kozlov_1disk":
        mesh = parse_geometry(build("kozlov_1disk"))
        mesh.global_parameters.update(protocol["global_parameters"])
        lane_edits(mesh, protocol)
        mn = Minimizer(mesh, device=DEVICE, dtype=dtype, quiet=True)
        mn.step_size = protocol["step_size"]
        for _ in range(protocol["refines"]):
            m = refine_polygonal_facets(mn.mesh)
            m = refine_triangle_mesh(m)
            mn.mesh = m
            mn.invalidate()
            mn.enforce_constraints_after_mesh_ops()
        lane_tags(mn, protocol)
        return mn
    data = build("cube")
    if protocol["drop_instructions"]:
        data.pop("instructions", None)
    data["energy_modules"] = list(protocol["energy_modules"])
    data["constraint_modules"] = list(protocol["constraint_modules"])
    data["global_parameters"].update(protocol["global_parameters"])
    mn = Minimizer(parse_geometry(data), device=DEVICE, dtype=dtype, quiet=True)
    mn.step_size = protocol["step_size"]
    for _ in range(protocol["polygonal_refines"]):
        mn.mesh = refine_polygonal_facets(mn.mesh)
    for _ in range(protocol["refines"]):
        mn.mesh = refine_triangle_mesh(mn.mesh)
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def lane_edits(mesh, protocol: dict) -> None:
    """A kozlov protocol's changes to the parsed L0 mesh (either package's), before the refinements.

    ``extra_energy_modules`` and ``extra_constraint_modules`` are appended
    to the mesh's lists, ``drop_constraint_modules`` taken out of them;
    ``free_disk_preset`` names a preset whose vertices lose their own
    ``pin_to_plane`` (from the vertices' constraint lists and from the
    preset's definition, so the refinements' new vertices do not take it
    back): the free-disk lane's disk then moves as one rigid body under
    ``rigid_disk``.  ``definition_options`` {preset: {key: value}} sets
    options on a preset's definition and on its vertices (the J0-fit
    lane's ``pin_to_circle_mode`` fit on the rim and ``pin_to_plane_mode``
    slide on the disk).
    """
    for preset, options in protocol.get("definition_options", {}).items():
        mesh.definitions[preset] = {**mesh.definitions[preset], **options}
        for v in mesh.vertices.values():
            if (v.options or {}).get("preset") == preset:
                v.options.update(options)
    for key, modules in (("extra_energy_modules", mesh.energy_modules),
                         ("extra_constraint_modules", mesh.constraint_modules)):
        modules.extend(m for m in protocol.get(key, ()) if m not in modules)
    drop = set(protocol.get("drop_constraint_modules", ()))
    mesh.constraint_modules[:] = [m for m in mesh.constraint_modules if m not in drop]
    preset = protocol.get("free_disk_preset")
    if preset is None:
        return

    def unpinned(options: dict) -> None:
        if "constraints" in options:
            options["constraints"] = [c for c in options["constraints"] if c != "pin_to_plane"]

    definition = dict(mesh.definitions[preset])
    unpinned(definition)
    mesh.definitions[preset] = definition
    for v in mesh.vertices.values():
        if (v.options or {}).get("preset") == preset:
            unpinned(v.options)


def lane_tags(mn, protocol: dict) -> None:
    """A kozlov protocol's vertex tags after the refinements (either package's minimizer).

    ``scaffold_tags`` {``trace_radius``, ``support_shells``}: the rows within
    1e-5 (relative) of the cylindrical radius nearest ``trace_radius`` (the
    trace shell that ``parity_trace_layer_radius`` selects) get
    ``pin_to_circle_group`` ``trace_layer``, and the rows of the next
    ``support_shells`` distinct radii outside it (rounded to 1e-9)
    ``outer_shell_scaffold_index`` 1, 2, ...: the scaffold-trace lane's trace
    shell and its scaffold-support shells.  The minimizer then recompiles.
    """
    tags = protocol.get("scaffold_tags")
    if not tags:
        return
    import numpy as np

    verts = mn.mesh.vertices
    vids = sorted(verts)
    radii = np.array([float(np.linalg.norm(np.asarray(verts[v].position)[:2])) for v in vids])
    r_trace = float(radii[np.argmin(np.abs(radii - float(tags["trace_radius"])))])
    tol = max(1e-9, 1e-5 * max(1.0, abs(r_trace)))
    shells = np.unique(np.round(radii[radii > r_trace + tol], 9))[: int(tags["support_shells"])]
    for v, r in zip(vids, radii):
        hit = np.flatnonzero(shells == round(r, 9))
        if abs(r - r_trace) <= tol or hit.size:
            if verts[v].options is None:
                verts[v].options = {}
            if abs(r - r_trace) <= tol:
                verts[v].options["pin_to_circle_group"] = "trace_layer"
            else:
                verts[v].options["outer_shell_scaffold_index"] = int(hit[0]) + 1
    mn.invalidate()


def drives_setup(mesh, protocol: dict) -> None:
    """The leaflet tilt-field drives on a kozlov host mesh (either package's).

    ``tests/test_module_gradients_fd.py``'s kozlov set-up: the protocol's
    global parameters and energy modules, the rim ring (``rim_slope_match_group``
    rim) tagged as the disk-target ring of both leaflets, the disk vertices
    (``tilt_thetaB_group_in`` disk) in the disk-contact group, and seeded
    tilts (``numpy.random.default_rng(tilt_seed)`` times ``tilt_scale``, in
    the mesh's vertex order) on every vertex whose tilts are free.
    """
    mesh.global_parameters.update(protocol["global_parameters"])
    mesh.energy_modules.extend(m for m in protocol["energy_modules"]
                               if m not in mesh.energy_modules)
    for v in mesh.vertices.values():
        opts = v.options or {}
        if opts.get("rim_slope_match_group") == "rim":
            opts["tilt_disk_target_group_in"] = "dt_ring"
            opts["tilt_disk_target_group_out"] = "dt_ring"
        if opts.get("tilt_thetaB_group_in") == "disk":
            opts["tilt_disk_contact_group"] = "disk"
    rng = np.random.default_rng(protocol["tilt_seed"])
    for v in mesh.vertices.values():
        if not (v.tilt_fixed_in or v.tilt_fixed_out):
            v.tilt_in = protocol["tilt_scale"] * rng.standard_normal(3)
            v.tilt_out = protocol["tilt_scale"] * rng.standard_normal(3)


def match_drives_setup(mesh, protocol: dict) -> None:
    """The local-interface and rim-matching drives on a kozlov host mesh (either package's).

    The protocol's global parameters, energy and constraint modules; the
    ``rim_slope_match_group`` rim ring (radius 1) tagged as the
    ``tilt_leaflet_match_group`` ring and, as role disk, with the outer ring
    (role rim, radius 1.36; both 32 vertices at L3) as one
    ``tilt_vector_match_group``; the ``rigid_disk_group`` made of the
    ``preset: disk`` vertices and the rim-preset ring at radius 1 (the
    disk boundary, which the double fit re-pins); then, in the mesh's
    vertex order (``numpy.random.default_rng(seed)``), an offset of
    ``xy_scale`` in x and y and ``z_scale`` in z on every free vertex and
    seeded leaflet and single-field tilts of ``tilt_scale`` where they are
    free.  The in-plane offsets part the rigid group's two in-plane second
    moments, which the disk's 16-fold symmetry makes equal: the closed-form
    Kabsch fit loses digits at a repeated singular value.
    """
    groups = protocol["groups"]
    mesh.global_parameters.update(protocol["global_parameters"])
    mesh.energy_modules.extend(m for m in protocol["energy_modules"]
                               if m not in mesh.energy_modules)
    mesh.constraint_modules.extend(m for m in protocol["constraint_modules"]
                                   if m not in mesh.constraint_modules)
    for v in mesh.vertices.values():
        opts = v.options
        ring = opts.get("rim_slope_match_group")
        if ring == "rim":
            opts["tilt_leaflet_match_group"] = groups["leaflet_match"]
            opts["tilt_vector_match_group"] = groups["vector_match"]
            opts["tilt_vector_match_role"] = "disk"
        elif ring == "outer":
            opts["tilt_vector_match_group"] = groups["vector_match"]
            opts["tilt_vector_match_role"] = "rim"
        radius = float(np.hypot(v.position[0], v.position[1]))
        if opts.get("preset") == "disk" or (opts.get("preset") == "rim"
                                            and abs(radius - 1.0) <= 1e-9):
            opts["rigid_disk_group"] = groups["rigid_disk"]
    rng = np.random.default_rng(protocol["seed"])
    for v in mesh.vertices.values():
        offset = rng.standard_normal(3) * np.array(
            [protocol["xy_scale"], protocol["xy_scale"], protocol["z_scale"]])
        if not v.fixed:
            v.position[:] = v.position + offset
        tilts = protocol["tilt_scale"] * rng.standard_normal((3, 3))
        if not (v.tilt_fixed_in or v.tilt_fixed_out):
            v.tilt_in, v.tilt_out = tilts[0], tilts[1]
        if not v.tilt_fixed:
            v.tilt = tilts[2]


def match_problems(minimizer, mesh, protocol: dict, **kw) -> dict:
    """Per ``curved_local_interface_match`` mode, the problem compiled with it.

    ``minimizer`` is either package's Minimizer class (``kw`` its keywords),
    ``mesh`` the host mesh after :func:`match_drives_setup`; the first
    mode's problem holds every other module's evaluation.
    """
    key, modes = protocol["modes"]["curved_local_interface_match"]
    out = {}
    for mode in modes:
        mesh.global_parameters.update({key: mode})
        out[mode] = minimizer(mesh, quiet=True, **kw).problem()
    return out


def port_match_record(torch, mesh, protocol: dict, dtype, device, inputs=None,
                      counters=None) -> dict:
    """The match drives by the port, in the format of the recorder's ``match_drives_run``.

    ``mesh`` is the kozlov host mesh after :func:`match_drives_setup`;
    ``inputs`` (field -> (n, 3) float64 array) replaces the compiled state
    (the fixture's inputs), else the port's own is used.  With
    ``counters``, the record's ``launches`` holds, per energy module, the
    curvature-data and divergence launches (forward, backward) its
    evaluation made.
    """
    from membrane_solver_tpu_torch import Minimizer
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.energy import get_module

    fields = ("positions", "tilts", "tilts_in", "tilts_out")
    problems = match_problems(Minimizer, mesh, protocol, device=device, dtype=dtype)
    nv = next(iter(problems.values())).n_vertices
    for q in problems.values():
        if inputs is not None:
            q.state = dataclasses.replace(q.state, **{
                f: torch.as_tensor(inputs[f], dtype=dtype, device=device) for f in fields})
    p = next(iter(problems.values()))
    as_np = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    kernel_keys = ("curvature_data", "curvature_data_bwd", "p1_div", "p1_div_bwd")
    energies, launches = {}, {}
    for name in protocol["energy_modules"]:
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fn = maker(p.spec) if maker is not None else module.energy
        leaves = [getattr(p.state, f).detach().clone().requires_grad_(True) for f in fields]
        st = dataclasses.replace(p.state, **dict(zip(fields, leaves)))
        before = [counters["tri_kernels"][k] for k in kernel_keys] if counters else None
        geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
        e = fn(geo, st, p.topo, p.params)
        grads = (torch.autograd.grad(e, leaves, allow_unused=True) if e.requires_grad
                 else [None] * len(leaves))
        if counters:
            if e.is_cuda:
                torch.cuda.synchronize()
            launches[name] = [counters["tri_kernels"][k] - b for k, b in zip(kernel_keys, before)]
        energies[name] = {"energy": float(e.detach()), **{
            f: encode_rows(np.zeros((nv, 3)) if g is None else as_np(g))
            for f, g in zip(fields, grads)}}
    constraints = {}
    for name, (_key, modes) in protocol["modes"].items():
        mod = get_constraint(name)
        for mode in modes:
            if name == "curved_local_interface_match":
                q = problems[mode]
                spec = q.spec
            else:
                q, spec = p, static_variant(p.spec, f"constraint:{name}", mode)
            rows = as_np(mod.make_tilt_constraint_rows(spec)(q.state, q.topo, q.params))
            out = mod.make_enforce_tilts(spec)(q.state, q.topo, q.params)
            constraints[f"{name}/{mode}"] = {
                "rows": [[encode_rows(rows[k, leaf]) for leaf in range(2)]
                         for k in range(rows.shape[0])],
                **{f: encode_rows(as_np(getattr(out, f)) - as_np(getattr(q.state, f)))
                   for f in ("tilts_in", "tilts_out")}}
    rng = np.random.default_rng(protocol["rigid_seed"])
    moved = as_np(p.state.positions) + protocol["rigid_scale"] * rng.standard_normal((nv, 3))
    st = dataclasses.replace(p.state, positions=torch.as_tensor(moved, dtype=dtype, device=device))
    out = get_constraint("rigid_disk").make_enforce(p.spec)(st, p.topo, p.params)
    return {
        "n_vertices": nv,
        "n_triangles": p.n_tris,
        "inputs": {f: encode_rows(as_np(getattr(p.state, f))) for f in fields},
        "energies": energies,
        "constraints": constraints,
        "rigid_disk": encode_rows(as_np(out.positions) - moved),
        "launches": launches,
    }


def static_variant(spec, key: str, value: str):
    """``spec`` with the first entry of ``key``'s compile-time static tuple set to ``value``.

    The mode of ``tilt_leaflet_match_rim`` and ``tilt_vector_match_rim``, which
    no compiled table depends on; either package's spec.
    """
    extra = tuple((k, (value,) + tuple(v[1:]) if k == key else v) for k, v in spec.extra_static)
    return dataclasses.replace(spec, extra_static=extra)


def match_deviations(want: dict, got: dict, np) -> dict:
    """Largest deviations of a match-drives record ``got`` from ``want`` (both as recorded).

    Per energy module: the energy's relative deviation and, per field, the
    gradient's largest error over its largest entry; per constraint and
    mode, the same for its tilt rows (all blocks) and for each leaflet's
    enforcement change; and for the rigid disk's position change.  An array
    that is zero in ``want`` gives its largest absolute entry in ``got``.
    """
    n = want["n_vertices"]

    def dev(w_rec, g_rec):
        w, g = decode_rows(w_rec, n), decode_rows(g_rec, n)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        return err / scale if scale > 0 else err

    out = {"energies": {}, "constraints": {}}
    for name, w in want["energies"].items():
        g = got["energies"][name]
        e = abs(g["energy"] - w["energy"])
        row = {"energy": e / abs(w["energy"]) if w["energy"] != 0.0 else e}
        row.update({f: dev(w[f], g[f]) for f in w if f != "energy"})
        out["energies"][name] = row
    for key, w in want["constraints"].items():
        g = got["constraints"][key]
        blocks = [(wb, gb) for wk, gk in zip(w["rows"], g["rows"], strict=True)
                  for wb, gb in zip(wk, gk, strict=True)]
        scale = max(float(np.max(np.abs(decode_rows(wb, n)))) for wb, _gb in blocks)
        err = max(float(np.max(np.abs(decode_rows(gb, n) - decode_rows(wb, n))))
                  for wb, gb in blocks)
        out["constraints"][key] = {"rows": err / scale if scale > 0 else err,
                                   **{f: dev(w[f], g[f]) for f in ("tilts_in", "tilts_out")}}
    out["rigid_disk"] = dev(want["rigid_disk"], got["rigid_disk"])
    return out


def encode_rows(arr) -> dict:
    """An (n, 3) float64 array as its nonzero rows: base64 int32 row numbers and float64 values."""
    arr = np.ascontiguousarray(arr, dtype="<f8")
    rows = np.flatnonzero(np.any(arr != 0.0, axis=1)).astype("<i4")
    return {"rows": base64.b64encode(rows.tobytes()).decode(),
            "values": base64.b64encode(arr[rows].tobytes()).decode()}


def decode_rows(rec: dict, n: int):
    """The (n, 3) array of :func:`encode_rows`."""
    out = np.zeros((n, 3))
    rows = np.frombuffer(base64.b64decode(rec["rows"]), dtype="<i4")
    out[rows] = np.frombuffer(base64.b64decode(rec["values"]), dtype="<f8").reshape(-1, 3)
    return out


def run_protocol(torch, dtype, protocol: dict):
    """A fixture's protocol on the card.

    Returns (minimizer, per-step energies, per-step (accepted, next step
    size), set-up seconds).
    """
    t0 = time.perf_counter()
    mn = build_lane(torch, protocol, dtype)
    setup_s = time.perf_counter() - t0
    energies, steps = [], []
    for _ in range(protocol["steps"]):
        res = mn.minimize(1)
        energies.append(float(res["energy"]))
        steps.append((bool(res["step_success"]), float(mn.step_size)))
    return mn, energies, steps, setup_s


def timed_steps(torch, mn, steps: int = TIMED_STEPS) -> float:
    mn.minimize(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mn.minimize(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / max(int(res["iterations"]), 1)


def count_syncs(torch, step) -> tuple[int, list]:
    """Synchronizing CUDA operations in one call of ``step()``: (count, [(n, "file:line")], most first)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{Path(w.filename).relative_to(REPO) if Path(w.filename).is_relative_to(REPO) else w.filename}"
        f":{w.lineno}" for w in caught if "synchronizing" in str(w.message))
    return sum(sites.values()), [(n, site) for site, n in sites.most_common()]


def reset_counts(counters) -> None:
    for launches in counters.values():
        for key in launches:
            launches[key] = 0


def read_counts(counters) -> dict:
    return {f"{mod}.{key}": n for mod, launches in counters.items() for key, n in launches.items()}


STATE_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def snapshot(mn) -> dict:
    """What a run from the minimizer's current state starts from: host mesh, step, stepper, theta_B."""
    mn.problem()
    mn._sync_host()
    verts = {vid: tuple(getattr(v, f).copy() for f in ("position", "tilt", "tilt_in", "tilt_out"))
             for vid, v in mn.mesh.vertices.items()}
    return {"verts": verts, "step_size": mn.step_size, "stepper": mn._stepper_state,
            "thetaB": mn.global_params.get("tilt_thetaB_value")}


def restore(mn, snap: dict) -> None:
    """Back to ``snap``: the host mesh written back, the problem compiled anew from it."""
    for vid, arrays in snap["verts"].items():
        v = mn.mesh.vertices[vid]
        for f, a in zip(("position", "tilt", "tilt_in", "tilt_out"), arrays):
            getattr(v, f)[:] = a
    if snap["thetaB"] is not None:  # the theta_B scan writes it
        mn.global_params.set("tilt_thetaB_value", snap["thetaB"])
    mn.invalidate()
    mn.problem()
    mn._stepper_state = snap["stepper"]
    mn.step_size = snap["step_size"]


def state_digest(torch, mn, energies) -> str:
    """sha256 of the device positions and tilts and of the energies, as bytes."""
    state = mn.problem().state
    h = hashlib.sha256()
    for f in STATE_FIELDS:
        h.update(getattr(state, f).detach().cpu().numpy().tobytes())
    h.update(np.asarray(energies, dtype=np.float64).tobytes())
    return h.hexdigest()


def check_repeat(torch, label: str, mn, run) -> dict:
    """Run ``run()`` twice from one saved state; unequal digests fail.

    ``run`` makes two steps and returns the energies it reports; the phase
    goes on from the second run's state.  Returns the saved state.
    """
    snap = snapshot(mn)
    digests = []
    for _ in range(2):
        restore(mn, snap)
        energies = run()
        torch.cuda.synchronize()
        digests.append(state_digest(torch, mn, energies))
    say(label + " determinism", steps=2, first=digests[0], second=digests[1],
        equal=digests[0] == digests[1])
    if digests[0] != digests[1]:
        raise AssertionError(f"{label}: two runs from one state differ: {digests}")
    return snap


def phase_path(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
               f32_energies=None) -> dict:
    """Drive one lane at one dtype with the launch counts reset just before and read just after."""
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, fixture["protocol"])
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    ms = timed_steps(torch, mn)
    launches = read_counts(counters)
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    if not all(math.isfinite(e) for e in energies) or not energies[-1] < energies[0]:
        raise AssertionError(f"{label}: energies not finite and descending: {energies}")
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "steps": json.dumps(steps),
              "ms_per_step": f"{ms:.3f}", "launches": json.dumps(launches)}
    out = {"energies": energies, "ms": ms, "launches": launches, "mn": mn, "snap": snap}
    if dtype == torch.float64:
        ref = fixture["energies"]
        out["dev_jax"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        fields["max_rel_dev_vs_jax"] = repr(out["dev_jax"])
        fields["jax_step_sizes"] = json.dumps(fixture["step_sizes"])
    if f32_energies is not None:
        devs = [abs(a - b) / abs(b) for a, b in zip(f32_energies, energies, strict=True)]
        out["dev_f32"] = max(devs)
        fields["rel_dev_f32_vs_f64_per_step"] = json.dumps(devs)
        fields["max_rel_dev_f32_vs_f64"] = repr(out["dev_f32"])
    fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
    out["syncs"] = fields["syncs_per_step"]
    say(label, **fields)
    say(label + " sync sites", sites=json.dumps(sites))
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if "dev_jax" in out and not out["dev_jax"] <= F64_RTOL:
        raise AssertionError(f"{label}: f64 trajectory deviates from the JAX fixture by {out['dev_jax']!r}")
    if "dev_f32" in out and not out["dev_f32"] <= F32_RTOL:
        raise AssertionError(f"{label}: f32 trajectory deviates from f64 by {out['dev_f32']!r}")
    return out


def connectivity_digest(mesh) -> str:
    """sha256 of the facets' signed edge lists and the edges' endpoints, by id."""
    text = json.dumps([sorted((int(f), [int(e) for e in mesh.facets[f].edge_indices])
                              for f in mesh.facets),
                       sorted((int(e), int(mesh.edges[e].tail_index), int(mesh.edges[e].head_index))
                              for e in mesh.edges)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def flip_margins(mesh) -> dict:
    """First-pass Delaunay margins of a triangulated mesh (either package's): edge id -> margin.

    For every interior edge of two triangles that is not fixed, the sum of
    the two opposite angles in the quadrilateral's tangent plane less
    (pi + 1e-3), with the arithmetic of the equiangulation's first pass
    (``runtime/equiangulation._bulk_flip_verdicts``): a positive margin
    flips the edge.  Degenerate quadrilaterals are left out.
    """
    mesh.build_connectivity_maps()
    ids, quads = [], []
    for eid, edge in mesh.edges.items():
        adjacent = mesh.facets_of_edge(eid)
        if edge.fixed or len(adjacent) != 2:
            continue
        offs = []
        for facet in adjacent:
            loop = mesh.facet_vertex_loop(facet)
            rest = [v for v in loop if v not in (edge.tail_index, edge.head_index)]
            offs.append(rest[0] if len(loop) == 3 and len(rest) == 1 else None)
        if None in offs:
            continue
        ids.append(eid)
        quads.append((edge.tail_index, edge.head_index, offs[0], offs[1]))
    P = np.array([[mesh.vertices[v].position for v in q] for q in quads], dtype=float)
    p1, p2, q1, q2 = P[:, 0], P[:, 1], P[:, 2], P[:, 3]
    n1 = np.cross(p2 - p1, q1 - p1)
    n2 = np.cross(q2 - p1, p2 - p1)
    n = n1 + n2
    nn = np.linalg.norm(n, axis=1)
    n = np.where((nn < 1e-12)[:, None], np.where(
        (np.linalg.norm(n1, axis=1) >= 1e-12)[:, None], n1, n2), n)
    nn = np.linalg.norm(n, axis=1)
    n = n / np.maximum(nn, 1e-300)[:, None]
    u = (p2 - p1) / np.maximum(np.linalg.norm(p2 - p1, axis=1), 1e-300)[:, None]
    v = np.cross(n, u)
    v = v / np.maximum(np.linalg.norm(v, axis=1), 1e-300)[:, None]

    def proj(p):
        rel = p - p1
        return np.stack([np.einsum("ij,ij->i", rel, u), np.einsum("ij,ij->i", rel, v)], axis=1)

    a1, a2, b1, b2 = np.zeros((len(ids), 2)), proj(p2), proj(q1), proj(q2)

    def angle_at(p, x, y):
        vx, vy = x - p, y - p
        den = np.maximum(np.linalg.norm(vx, axis=1) * np.linalg.norm(vy, axis=1), 1e-300)
        return np.arccos(np.clip(np.einsum("ij,ij->i", vx, vy) / den, -1.0, 1.0))

    margin = angle_at(b1, a1, a2) + angle_at(b2, a1, a2) - (np.pi + 1e-3)
    ok = (nn >= 1e-12) & np.isfinite(margin)
    return {int(e): float(m) for e, m, k in zip(ids, margin, ok) if k}


def first_verdict_difference(mine: dict, theirs: dict) -> dict:
    """The lowest edge id whose first-pass flip verdict differs between two margin maps."""
    common = sorted(set(mine) & set(theirs))
    out = {"common_edges": len(common), "differing_verdicts": 0, "first_edge": None}
    for eid in common:
        if (mine[eid] > 0.0) != (theirs[eid] > 0.0):
            out["differing_verdicts"] += 1
            if out["first_edge"] is None:
                out.update(first_edge=eid, margin_port=mine[eid], margin_jax=theirs[eid])
    return out


def c4_u_from_jax_state(torch, fixture: dict, dtype, cpu: bool = False) -> dict:
    """ROADMAP C4: the port's ``u`` from the JAX package's float32 state before the last ``u``.

    The state (``tests/fixtures/torch_port/cube_cli_f32_pre_u_jax.json.gz``)
    parsed by the port into the command context ``cli.make_context`` builds
    at ``dtype`` (on the CPU with ``cpu``), the ``u`` command, and its
    connectivity digest against the JAX package's after the same ``u``
    from the same reloaded state.  Also the state's first-pass margins
    (``flip_margins``): their smallest size against float32's unit
    round-off (2^-23 of the angle sum, about 3.7e-7).
    """
    from membrane_solver_tpu_torch import cli, parse_geometry
    from membrane_solver_tpu_torch.commands import execute_command_line

    proto = fixture["protocol"]
    extra = (["--f32"] if dtype == torch.float32 else []) + (["--cpu"] if cpu else [])
    argv = [a if a != proto["mesh"] else str(REPO / proto["mesh"]) for a in proto["cli_args"]]
    args = cli.build_parser().parse_args(argv + extra)
    mesh = parse_geometry(json.loads(json.dumps(fixture["mesh"])))
    margins = flip_margins(mesh)
    ctx = cli.make_context(args, mesh)
    execute_command_line(ctx, proto["commands"][proto["stop_before"]])
    ctx.sync_mesh()
    digest = connectivity_digest(ctx.mesh)
    smallest = min(abs(m) for m in margins.values())
    return {"digest": digest, "jax_digest": fixture["digest_after_u_reloaded"],
            "equal": digest == fixture["digest_after_u_reloaded"],
            "n_vertices": len(ctx.mesh.vertices), "n_facets": len(ctx.mesh.facets),
            "smallest_abs_margin": smallest,
            "smallest_margin_over_f32_roundoff": smallest / (np.pi * 2.0**-23),
            "margins": margins}


def cli_context(torch, protocol: dict, dtype):
    """The command context ``cli.main`` builds for the protocol's command line, on the card.

    A meshgen protocol's lane is first written to a JSON file, as
    ``python -m membrane_solver_tpu_torch.meshgen NAME --set k=v -o FILE``
    writes it, and the CLI loads that file; the protocol's
    ``global_parameters``, where it has them, update the loaded mesh's.
    """
    import tempfile

    from membrane_solver_tpu_torch import cli
    from membrane_solver_tpu_torch.meshgen import build

    with tempfile.TemporaryDirectory() as tmp:
        mesh_path = REPO / protocol["mesh"]
        if "meshgen" in protocol:
            spec = protocol["meshgen"]
            mesh_path = Path(tmp) / protocol["mesh"]
            mesh_path.write_text(json.dumps(build(spec["name"], **spec["args"])))
        argv = [str(mesh_path) if a == protocol["mesh"] else a for a in protocol["cli_args"]]
        args = cli.build_parser().parse_args(argv + (["--f32"] if dtype == torch.float32 else []))
        mesh = cli.load_mesh_interactive(args.input, interactive=False)
        mesh.global_parameters.update(protocol.get("global_parameters", {}))
        return cli.make_context(args, mesh)


def g1_split(torch, ctx) -> dict:
    """Host seconds, synced, of one ``g1`` command, one ``minimize(1)`` and the ``g`` command's collision scan."""
    from membrane_solver_tpu_torch.commands import execute_command_line
    from membrane_solver_tpu_torch.runtime.topology_guards import detect_vertex_edge_collisions

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return {"g1_s": timed(lambda: execute_command_line(ctx, "g1")),
            "minimize_1_s": timed(lambda: ctx.minimizer.minimize(1)),
            "collision_scan_s": timed(lambda: detect_vertex_edge_collisions(ctx.mesh))}


def phase_cli(torch, counters, label: str, fixture: dict, dtype, expect: tuple, f32=None,
              split: bool = False, margins_before: int | None = None) -> dict:
    """The fixture's command list through the command layer, counts reset just before and read after.

    With ``split``, a ``g1`` split (:func:`g1_split`) follows the counted run;
    with ``margins_before``, the first-pass Delaunay margins of the host
    mesh just before that command are kept (``pre_u_margins``, ROADMAP C4).
    """
    from membrane_solver_tpu_torch.commands import execute_command_line

    proto, trace = fixture["protocol"], fixture["trace"]
    jax_f32 = fixture["float32_reference"]
    reset_counts(counters)
    ctx = cli_context(torch, proto, dtype)
    rows, digests, pre_u = [], [], None
    for cmd in proto["commands"]:
        if len(rows) == margins_before:
            pre_u = flip_margins(ctx.mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mn = ctx.minimizer
        row = {"cmd": cmd, "energy": float(mn.compute_energy()),
               "n_vertices": len(ctx.mesh.vertices), "n_facets": len(ctx.mesh.facets),
               "host_s": seconds}
        name = cmd.split()[0]
        if name[0] == "g" and name[1:].isdigit():
            row["ms_per_step"] = seconds * 1e3 / int(name[1:])
        if cmd == "u":
            digests.append(connectivity_digest(ctx.mesh))
            row["connectivity"] = digests[-1]
            if dtype == torch.float32:
                # the JAX package's own float32 run after the same command
                i = len(rows)
                row["jax_f32_counts"] = jax_f32["counts"][i]
                row["jax_f32_connectivity"] = jax_f32["connectivity"][i]
                row["jax_f32_connectivity_equal"] = jax_f32["connectivity"][i] == digests[-1]
        rows.append(row)
        say(label + " command", **{k: (f"{v:.6f}" if k in ("host_s", "ms_per_step") else repr(v))
                                   for k, v in row.items()})

    def g2():
        execute_command_line(ctx, "g2")
        ctx.sync_mesh()
        return [float(ctx.minimizer.compute_energy())]

    snap = check_repeat(torch, label, ctx.minimizer, g2)
    syncs, sites = count_syncs(torch, lambda: execute_command_line(ctx, "g1"))
    launches = read_counts(counters)
    energies = [r["energy"] for r in rows]
    out = {"energies": energies, "rows": rows, "digests": digests, "launches": launches,
           "mn": ctx.minimizer, "snap": snap, "pre_u_margins": pre_u}
    fields = {"vertices": rows[-1]["n_vertices"], "facets": rows[-1]["n_facets"],
              "launches": json.dumps(launches), "g1_host_syncs": syncs}
    if dtype == torch.float32:
        fields["jax_f32_connectivity_after_u_equal"] = json.dumps(
            [r["jax_f32_connectivity_equal"] for r in rows if r["cmd"] == "u"])
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    if dtype == torch.float64:
        if len(rows) != len(trace):
            raise AssertionError(f"{label}: {len(rows)} commands, the fixture has {len(trace)}")
        counts = [(r["n_vertices"], r["n_facets"]) for r in rows]
        want = [(t["n_vertices"], t["n_facets"]) for t in trace]
        if counts != want:
            raise AssertionError(f"{label}: entity counts {counts} differ from the fixture's {want}")
        devs = [abs(r["energy"] - t["energy"]) / abs(t["energy"]) for r, t in zip(rows, trace)]
        out["dev_jax"] = max(devs)
        fields["max_rel_dev_vs_jax"] = repr(out["dev_jax"])
        fields["rel_dev_vs_jax_per_command"] = json.dumps(devs)
    f32_bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
    if f32 is not None:
        devs = [abs(a - b) / abs(b) for a, b in zip(f32["energies"], energies, strict=True)]
        out["dev_f32"] = max(devs)
        fields["max_rel_dev_f32_vs_f64"] = repr(out["dev_f32"])
        fields["f32_bound"] = repr(f32_bound)
        fields["rel_dev_f32_vs_f64_per_command"] = json.dumps(devs)
        fields["f32_connectivity_after_u_equal"] = json.dumps(
            [a == b for a, b in zip(f32["digests"], digests, strict=True)])
    say(label, **fields)
    say(label + " g1 sync sites", sites=json.dumps(sites))
    if split:
        say(label + " g1 split", **{k: f"{v:.6f}" for k, v in g1_split(torch, ctx).items()})
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if "dev_jax" in out and not out["dev_jax"] <= F64_RTOL:
        raise AssertionError(f"{label}: f64 energies deviate from the JAX fixture by {out['dev_jax']!r}")
    if "dev_f32" in out and not out["dev_f32"] <= f32_bound:
        raise AssertionError(f"{label}: f32 energies deviate from f64 by {out['dev_f32']!r}")
    return out


def phase_c4(torch, label: str, fixture: dict, port_margins: dict) -> dict:
    """ROADMAP C4 on the card: the port's float32 ``u`` from the JAX package's float32 state.

    :func:`c4_u_from_jax_state` at float32: its connectivity must equal the
    JAX package's after the same ``u``.  Then the port's own float32 state
    before its last ``u`` (phase 8's ``pre_u_margins``) against the JAX
    package's: the lowest edge id whose first-pass verdict differs, with its
    margin in both states, and the count of differing verdicts.
    """
    got = c4_u_from_jax_state(torch, fixture, torch.float32)
    diff = first_verdict_difference(port_margins, got["margins"])
    say(label, digest=got["digest"], jax_digest=got["jax_digest"], equal=got["equal"],
        vertices=got["n_vertices"], facets=got["n_facets"],
        smallest_abs_margin=repr(got["smallest_abs_margin"]),
        smallest_margin_over_f32_roundoff=repr(got["smallest_margin_over_f32_roundoff"]),
        port_state_vs_jax_state=json.dumps(diff))
    if not got["equal"]:
        raise AssertionError(f"{label}: the port's u from the JAX state gives another "
                             f"connectivity: {got['digest']} vs {got['jax_digest']}")
    return {**{k: v for k, v in got.items() if k != "margins"}, "verdicts": diff}


def thetaB_energies(trace: list, final: float) -> list:
    """Every candidate's energy, scan by scan, then the call's final energy."""
    return [c["energy"] for r in trace for c in r["candidate_energies"]] + [final]


def phase_thetaB(torch, counters, label: str, fixture: dict, mn, snap: dict, expect: tuple,
                 f64=None) -> dict:
    """The theta_B scan on kozlov L3 from a saved state, counts reset just before and read after.

    At float64 (``f64`` None) the selected theta_B and the energies are held
    against the fixture; at float32 the selections against the JAX
    package's own float32 run (the fixture's ``float32_reference``) and
    the energies against ``f64``, the float64 phase's result.
    """
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.runtime import tilt_optimization as topt

    proto = fixture["protocol"]
    restore(mn, snap)
    mn.global_params.update(proto["global_parameters"])
    mn.problem()  # the compile the new static options need, before the call
    mn.mesh._thetaB_scan_trace = []
    scan_s, compiles_at = [], []
    real = topt.optimize_thetaB_scalar

    def timed(minimizer, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(minimizer, **kw)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t0)

    reset_counts(counters)
    compiles0 = tstate.COMPILES["compile_state"]
    topt.optimize_thetaB_scalar = timed
    try:
        t0 = time.perf_counter()
        res = mn.minimize(proto["minimize"], callback=lambda _mesh, _i: compiles_at.append(
            tstate.COMPILES["compile_state"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        topt.optimize_thetaB_scalar = real
    launches = read_counts(counters)
    trace = mn.mesh._thetaB_scan_trace
    compiles_end = tstate.COMPILES["compile_state"]
    thetaB_after = mn.global_params.get("tilt_thetaB_value")
    if f64 is None:
        ref_trace, bound = fixture["trace"], F64_RTOL
        ref_selected = [r["selected_thetaB"] for r in ref_trace]
        ref_energies = thetaB_energies(ref_trace, fixture["energy"])
    else:
        ref_trace = f64["trace"]
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        ref_selected = fixture["float32_reference"]["selected_thetaB"]
        ref_energies = f64["energies"]
    if len(trace) != len(ref_trace):
        raise AssertionError(f"{label}: {len(trace)} scans, the reference has {len(ref_trace)}")
    energies = thetaB_energies(trace, res["energy"])
    devs = [abs(a - b) / abs(b) for a, b in zip(energies, ref_energies, strict=True)]
    selected_equal = [r["selected_thetaB"] == w for r, w in zip(trace, ref_selected)]
    for k, (got, want) in enumerate(zip(trace, ref_trace)):
        say(label + " scan", iteration=got["iteration"], base=repr(got["base_thetaB"]),
            selected=repr(got["selected_thetaB"]), reference_selected=repr(ref_selected[k]),
            thetas=json.dumps([c["thetaB"] for c in got["candidate_energies"]]),
            energies=json.dumps([c["energy"] for c in got["candidate_energies"]]),
            reference_energies=json.dumps([c["energy"] for c in want["candidate_energies"]]),
            host_s=f"{scan_s[k]:.6f}")
    after_entry = compiles_end - compiles_at[0]
    out = {"launches": launches, "energies": energies, "trace": [dict(r) for r in trace],
           "max_rel_dev": max(devs), "mn": mn}
    out["snap"] = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    say(label, vertices=len(mn.mesh.vertices), iterations=res["iterations"],
        energy=repr(res["energy"]), reference_energy=repr(ref_energies[-1]),
        max_rel_dev=repr(out["max_rel_dev"]), bound=repr(bound),
        reference="the JAX fixture" if f64 is None else "the float64 phase",
        selected_equal=json.dumps(selected_equal), thetaB_after=repr(thetaB_after),
        compiles_in_call=compiles_end - compiles0, compiles_after_entry=after_entry,
        seconds=f"{seconds:.3f}", scan_host_s=json.dumps([round(x, 6) for x in scan_s]),
        launches=json.dumps(launches))
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if not all(selected_equal):
        raise AssertionError(f"{label}: selected theta_B differs from the reference: {selected_equal}")
    if not out["max_rel_dev"] <= bound:
        raise AssertionError(f"{label}: energies deviate from the reference by {out['max_rel_dev']!r}")
    if after_entry != 0 or compiles_end - compiles0 > 1:
        raise AssertionError(f"{label}: {compiles_end - compiles0} compiles in the call, "
                             f"{after_entry} after the entry enforcement")
    return out


def phase_reduced(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
                  f64=None) -> dict:
    """The reduced-energy line search on kozlov L3, counts reset just before and read after.

    The fixture's protocol (five ``minimize(1)``), the determinism check
    (two ``minimize(2)`` from one saved state), then ``minimize(3)`` timed
    after two warm-up steps.  At float64 (``f64`` None) the energies and
    the accept flags are held against the fixture; at float32 the energies
    against ``f64``, the float64 phase's result, within max(2e-3, 2 x the
    JAX package's own float32 deviation).  The launches per step divide
    the counts by every ``minimize`` step the phase ran.
    """
    proto = fixture["protocol"]
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, proto)
    accepted = [ok for ok, _step in steps]
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    mn.minimize(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mn.minimize(REDUCED_TIMED_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(int(res["iterations"]), 1)
    launches = read_counts(counters)
    n_steps = proto["steps"] + 2 * 2 + WARMUP_STEPS + REDUCED_TIMED_STEPS
    per_step = {k: n / n_steps for k, n in launches.items()}
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    out = {"energies": energies, "accepted": accepted, "ms": ms, "launches": launches,
           "per_step": per_step, "mn": mn, "snap": snap,
           "trials_per_step": res["line_search_trials"] / max(int(res["iterations"]), 1),
           "accepted_timed": res["accepted_steps"]}
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "accepted": json.dumps(accepted),
              "ms_per_step": f"{ms:.3f}", "trials_per_step": repr(out["trials_per_step"]),
              "accepted_steps_timed": f"{res['accepted_steps']}/{res['iterations']}",
              "steps_counted": n_steps, "launches": json.dumps(launches)}
    if f64 is None:
        ref = fixture["energies"]
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        bound, reference = F64_RTOL, "the JAX fixture"
        ref_accepted = fixture["accepted"]
    else:
        ref = f64["energies"]
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, ref, strict=True))
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        reference, ref_accepted = "the float64 phase", fixture["float32_reference"]["accepted"]
    fields.update(reference=repr(reference), max_rel_dev=repr(out["dev"]), bound=repr(bound),
                  reference_accepted=json.dumps(ref_accepted))
    fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
    say(label, **fields)
    say(label + " sync sites", sites=json.dumps(sites))
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if f64 is None and accepted != ref_accepted:
        raise AssertionError(f"{label}: accept flags {accepted} differ from the fixture's {ref_accepted}")
    if not out["dev"] <= bound:
        raise AssertionError(f"{label}: energies deviate from {reference} by {out['dev']!r}")
    return out


def fused_tilt_energy_of(torch, mn):
    """(FusedTiltEnergy or None, problem): what the relax builds on the minimizer's current state."""
    from membrane_solver_tpu_torch.runtime import tilt_relax

    p = mn.problem()
    e_pre, e_fns, _c_pre, _c_fns, e_names = tilt_relax.collect_frozen_tilt_program(p.spec)
    e_frozen = [pre(p.state, p.topo, p.params) for pre in e_pre]
    fused = tilt_relax.build_fused_tilt_energy(p.spec, e_names, e_fns, e_frozen, p.topo, p.params,
                                               p.state.positions.dtype)
    if fused is None:
        return None, p
    return fused[0], p


def smooth_terms(breakdown: dict, want: dict, energy: float, modules) -> dict:
    """Per smoothness module: (value, fixture's, deviation, bound).

    The bound is rel 1e-8 of the fixture's value, floored at 1e-12 of the
    lane's energy: on this lane the outer leaflet is undriven (its tilts
    stay at round-off, ~1e-30 of energy in the JAX package's own run), so
    its term carries no digits to hold at its own scale.
    """
    out = {}
    for name in modules:
        scale = max(abs(want[name]), 1e-12 * abs(energy))
        out[name] = (breakdown[name], want[name], abs(breakdown[name] - want[name]),
                     F64_RTOL * scale)
    return out


def phase_smooth(torch, ft, counters, label: str, fixture: dict, dtype, expect: tuple,
                 f64=None) -> dict:
    """kozlov_L3 with the leaflet smoothness, counts reset just before and read after.

    The fixture's protocol (five ``minimize(1)``), the determinism check,
    then 2 warm-up and 5 timed steps.  At float64 the energies, accept
    flags and the breakdown's smoothness terms against the fixture; at
    float32 the energies against ``f64`` (max(2e-3, 2 x the JAX package's
    own float32 deviation)), and the fold: the relax's fused energy on the
    lane's state has both smoothness rigidities in its k_vec and neither
    module in its per-module rest, the frozen-tilt kernel launched on every
    step, and one call of each kernel variant on the lane's own g, payload
    (live w_in and w_out columns) and k_vec against the twin, with the
    lane's tilts and with seeded tilts of scale 0.1 on every vertex.
    """
    proto = fixture["protocol"]
    reset_counts(counters)
    mn, energies, steps, setup_s = run_protocol(torch, dtype, proto)
    accepted = [ok for ok, _step in steps]
    breakdown = {k: float(v) for k, v in mn.compute_energy_breakdown().items()}
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    ms = timed_steps(torch, mn)
    launches = read_counts(counters)
    n_steps = proto["steps"] + 2 * 2 + WARMUP_STEPS + TIMED_STEPS
    per_step = {k: n / n_steps for k, n in launches.items()}
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    modules = proto["extra_energy_modules"]
    out = {"energies": energies, "accepted": accepted, "ms": ms, "launches": launches,
           "per_step": per_step, "mn": mn, "snap": snap, "breakdown": breakdown}
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "accepted": json.dumps(accepted),
              "ms_per_step": f"{ms:.3f}", "steps_counted": n_steps,
              "launches": json.dumps(launches),
              "breakdown": json.dumps({k: breakdown[k] for k in modules})}
    if f64 is None:
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, fixture["energies"],
                                                             strict=True))
        bound, reference, ref_accepted = F64_RTOL, "the JAX fixture", fixture["accepted"]
        terms = smooth_terms(breakdown, fixture["breakdown_after"], fixture["energy_after"],
                             modules)
        fields["smoothness_vs_fixture"] = json.dumps(terms)
    else:
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, f64["energies"],
                                                             strict=True))
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        reference, ref_accepted = "the float64 phase", fixture["float32_reference"]["accepted"]
    fields.update(reference=repr(reference), max_rel_dev=repr(out["dev"]), bound=repr(bound),
                  reference_accepted=json.dumps(ref_accepted))
    fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
    out["syncs"] = fields["syncs_per_step"]
    say(label, **fields)
    say(label + " sync sites", sites=json.dumps(sites))
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if accepted != ref_accepted:
        raise AssertionError(f"{label}: accept flags {accepted} differ from {ref_accepted}")
    if not out["dev"] <= bound:
        raise AssertionError(f"{label}: energies deviate from {reference} by {out['dev']!r}")
    if f64 is None:
        for name, (got, want, dev, term_bound) in terms.items():
            floor = 1e-12 * abs(fixture["energy_after"])
            if not dev <= term_bound or (abs(want) > floor and not got != 0.0):
                raise AssertionError(f"{label}: {name} {got!r} vs the fixture's {want!r}")
        return out

    # float32: the fold, on the state the run left
    fused, p = fused_tilt_energy_of(torch, mn)
    if fused is None:
        raise AssertionError(f"{label}: the relax builds no fused frozen-tilt energy")
    k_vec = [float(x) for x in fused.k_vec]
    folded = [m for m in modules if m not in fused.rest_names]
    live_w = [float(torch.max(torch.abs(fused.payload[:, c:c + 3]))) for c in (14, 17)]
    state = p.state
    rng = np.random.default_rng(19)
    seeded = [torch.as_tensor(0.1 * rng.standard_normal((p.n_vertices, 3)), dtype=dtype,
                              device=DEVICE) for _ in range(2)]
    errs = {}
    for what, (t_in, t_out) in (("lane tilts", (state.tilts_in, state.tilts_out)),
                                ("seeded tilts", seeded)):
        errs[what] = compare_frozen_tilt(torch, ft, p.topo.tri_rows, p.topo.corner_csr(),
                                         t_in.contiguous(), t_out.contiguous(), fused.g,
                                         fused.payload, fused.k_vec)
    per = {k: per_step[f"frozen_tilt.{k}"] for k in ("energy", "energy_grad")}
    say(label + " fold", k_vec=json.dumps(k_vec), rest=json.dumps(list(fused.rest_names)),
        folded=json.dumps(folded), max_abs_w_in=repr(live_w[0]), max_abs_w_out=repr(live_w[1]),
        frozen_tilt_launches_per_step=json.dumps(per),
        kernel_vs_twin=json.dumps(errs), ms_per_step=f"{ms:.3f}")
    out["fold_errs"] = errs
    if not (k_vec[4] > 0.0 and k_vec[5] > 0.0) or folded != list(modules):
        raise AssertionError(f"{label}: the smoothness did not fold: k_vec {k_vec}, "
                             f"rest {fused.rest_names}")
    if not (live_w[0] > 0.0 and live_w[1] > 0.0):
        raise AssertionError(f"{label}: the payload's smoothness columns are zero: {live_w}")
    if not all(n > 0 for n in per.values()):
        raise AssertionError(f"{label}: the frozen-tilt kernel did not launch every step: {per}")
    return out


def phase_drives(torch, counters, label: str, fixture: dict) -> dict:
    """The leaflet tilt-field drives on kozlov L3, float64 against the fixture, then float32.

    ``drives_setup`` on the kozlov lane's mesh after its refinements
    (built at float64); per module, the energy and its gradients in the
    positions and both leaflet tilts, by autograd on the card, on the
    fixture's inputs (the lane's own, built on the card, must lie within
    1e-12 of them), against the JAX package's values (rel 1e-10; gradients
    1e-10 * max|g|, and exact zeros where the JAX package's gradient is
    zero).  Then the same host mesh compiled at float32, on the same
    inputs rounded: each value against the float64 one within
    max(2e-3, 2 x the JAX package's own float32 deviation, per module and
    field, the fixture's ``float32_reference``).  The divergence kernel
    must launch while ``tilt_splay_twist_in`` is evaluated.
    """
    from membrane_solver_tpu_torch import Minimizer
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.energy import get_module

    proto = fixture["protocol"]
    t0 = time.perf_counter()
    reset_counts(counters)
    mesh = build_lane(torch, proto["kozlov"], torch.float64).mesh
    drives_setup(mesh, proto)
    mn = Minimizer(mesh, device=DEVICE, dtype=torch.float64, quiet=True)  # the full module list
    setup_s = time.perf_counter() - t0
    nv = fixture["n_vertices"]
    fields = ("positions", "tilts_in", "tilts_out")

    def values(p):
        out, p1 = {}, {}
        for name in proto["modules"]:
            module = get_module(name)
            maker = getattr(module, "make_energy", None)
            fn = maker(p.spec) if maker is not None else module.energy
            leaves = [getattr(p.state, f).detach().clone().requires_grad_(True) for f in fields]
            st = dataclasses.replace(p.state, **dict(zip(fields, leaves)))
            before = [counters["tri_kernels"][k] for k in ("p1_div", "p1_div_bwd")]
            geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
            e = fn(geo, st, p.topo, p.params)
            grads = torch.autograd.grad(e, leaves, allow_unused=True)
            torch.cuda.synchronize()
            p1[name] = [counters["tri_kernels"][k] - b
                        for k, b in zip(("p1_div", "p1_div_bwd"), before)]
            out[name] = [float(e.detach())] + [
                np.zeros((nv, 3)) if g is None else g.detach().cpu().double().numpy()
                for g in grads]
        return out, p1

    p64 = mn.problem()
    if (p64.n_vertices, p64.n_tris) != (nv, fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p64.n_vertices, p64.n_tris)} differs")
    # the lane as the card built it, against the fixture's inputs; the
    # modules are then held on the fixture's inputs exactly
    inputs = {f: decode_rows(fixture["inputs"][f], nv) for f in fields}
    input_dev = {f: float(np.max(np.abs(getattr(p64.state, f).cpu().numpy() - inputs[f])))
                 for f in fields}
    if not all(d <= 1e-12 * max(float(np.max(np.abs(inputs[f]))), 1.0)
               for f, d in input_dev.items()):
        raise AssertionError(f"{label}: the lane's inputs differ from the fixture's: {input_dev}")

    def on_inputs(p, dtype):
        p.state = dataclasses.replace(p.state, **{
            f: torch.as_tensor(inputs[f], dtype=dtype, device=DEVICE) for f in fields})
        return p

    t1 = time.perf_counter()
    v64, p1 = values(on_inputs(p64, torch.float64))
    s64 = time.perf_counter() - t1
    mn32 = Minimizer(mesh, device=DEVICE, dtype=torch.float32, quiet=True)
    t1 = time.perf_counter()
    v32, _p1 = values(on_inputs(mn32.problem(), torch.float32))
    s32 = time.perf_counter() - t1
    launches = read_counts(counters)
    f32_ref = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    rows, failed = {}, []
    for name in proto["modules"]:
        want = fixture["modules"][name]
        got, got32 = v64[name], v32[name]
        dev = {"energy": abs(got[0] - want["energy"]) / abs(want["energy"])}
        dev32 = {"energy": abs(got32[0] - got[0]) / abs(got[0])}
        bound32 = {k: max(F32_RTOL, 2 * f32_ref[name][k]) for k in ("energy",) + fields}
        for i, f in enumerate(fields, start=1):
            w = decode_rows(want[f], nv)
            scale = float(np.max(np.abs(w)))
            err = float(np.max(np.abs(got[i] - w)))
            dev[f] = err / scale if scale > 0 else err
            scale64 = float(np.max(np.abs(got[i])))
            err32 = float(np.max(np.abs(got32[i] - got[i])))
            dev32[f] = err32 / scale64 if scale64 > 0 else err32
        if not all(d <= DRIVES_F64_RTOL for d in dev.values()):
            failed.append(f"{name} float64 {dev}")
        if not all(dev32[k] <= bound32[k] for k in dev32):
            failed.append(f"{name} float32 {dev32} bound {bound32}")
        rows[name] = {"energy": got[0], "fixture": want["energy"], "dev_f64": dev,
                      "energy_f32": got32[0], "dev_f32": dev32, "bound_f32": bound32,
                      "p1_div_and_bwd_launches": p1[name]}
        say(label + " module", name=name, **{k: json.dumps(v) for k, v in rows[name].items()})
    say(label, vertices=nv, triangles=fixture["n_triangles"], setup_s=f"{setup_s:.3f}",
        input_max_abs_dev=json.dumps(input_dev), f64_s=f"{s64:.3f}", f32_s=f"{s32:.3f}",
        launches=json.dumps(launches))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    if not min(p1["tilt_splay_twist_in"]) > 0:
        raise AssertionError(f"{label}: tilt_splay_twist_in did not launch the divergence kernel "
                             f"and its tilt backward: {p1['tilt_splay_twist_in']}")
    return {"launches": launches, "rows": rows}


def pair_distance_error(torch, mn) -> float:
    """Largest |d_ij - d_ij(reference)| over the rigid disk's anchor pairs, on the device state."""
    p = mn.problem()
    x = lambda k: p.topo.extras[f"constraint:rigid_disk/{k}"]  # noqa: E731
    pairs = x("pairs")
    pos = p.state.positions[x("rows")]
    ref = x("ref")
    d = torch.linalg.vector_norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], dim=1)
    d_ref = torch.linalg.vector_norm(ref[pairs[:, 0]] - ref[pairs[:, 1]], dim=1)
    return float(torch.max(torch.abs(d - d_ref)))


def lane_steps(torch, protocol: dict, dtype, per_step=None):
    """A fixture's lane on the card, step by step: (minimizer, energies, accepted, per-step rows, setup s).

    Per step: the shape KKT solves' flags (``jit_core.KKT_RECORD``: the LU's
    multipliers finite, the null-space fallback taken, max|lam|) and the
    breakdown after the step, plus ``per_step(mn)`` when given.
    """
    from membrane_solver_tpu_torch.runtime import jit_core, tilt_relax

    t0 = time.perf_counter()
    mn = build_lane(torch, protocol, dtype)
    setup_s = time.perf_counter() - t0
    energies, accepted, rows = [], [], []
    try:
        for _ in range(protocol["steps"]):
            jit_core.KKT_RECORD = []
            tilt_relax.RELAX_RECORD = []
            res = mn.minimize(1)
            solves = [(bool(f), bool(r), float(m)) for f, r, m in jit_core.KKT_RECORD]
            energies.append(float(res["energy"]))
            accepted.append(bool(res["step_success"]))
            row = {"finite": all(f for f, _r, _m in solves),
                   "fallback": any(r for _f, r, _m in solves),
                   "lam_max": max((m for _f, _r, m in solves), default=0.0),
                   "relax": list(tilt_relax.RELAX_RECORD),
                   "trace_z": bool(res["trace_z_fallbacks"]),
                   "breakdown": {k: float(v) for k, v in mn.compute_energy_breakdown().items()}}
            if per_step is not None:
                row.update(per_step(mn))
            rows.append(row)
    finally:
        jit_core.KKT_RECORD = None
        tilt_relax.RELAX_RECORD = None
    return mn, energies, accepted, rows, setup_s


def kkt_solve_seconds(torch, mn) -> tuple[float, int]:
    """(seconds, K) of the largest shape KKT solve of one more ``minimize(1)``, synced around it."""
    from membrane_solver_tpu_torch.runtime import jit_core

    solve = jit_core.solve_kkt_with_rescue
    timed = []

    def wrapped(A, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam = solve(A, b)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0, A.shape[0]))
        return lam

    jit_core.solve_kkt_with_rescue = wrapped
    try:
        mn.minimize(1)
    finally:
        jit_core.solve_kkt_with_rescue = solve
    return max(timed, key=lambda t: t[1]) if timed else (0.0, 0)


def lane_phase(torch, counters, label: str, fixture: dict, dtype, expect: tuple, f64=None,
               per_step=None, timed=TIMED_STEPS) -> tuple[dict, dict]:
    """The common part of phases 21-24, counts reset just before and read after.

    The fixture's protocol step by step (:func:`lane_steps`), the determinism
    check (two ``minimize(2)`` from one saved state), 2 warm-up and ``timed``
    timed steps; at float32 the energies against ``f64`` (the float64 phase's
    result) within max(2e-3, 2 x the JAX package's own float32 deviation).
    Returns (result, the fields of its line).
    """
    proto = fixture["protocol"]
    reset_counts(counters)
    mn, energies, accepted, rows, setup_s = lane_steps(torch, proto, dtype, per_step)
    snap = check_repeat(torch, label, mn, lambda: [float(mn.minimize(2)["energy"])])
    ms = timed_steps(torch, mn, timed)
    launches = read_counts(counters)
    p = mn.problem()
    if (p.n_vertices, p.n_tris) != (fixture["n_vertices"], fixture["n_triangles"]):
        raise AssertionError(f"{label}: mesh size {(p.n_vertices, p.n_tris)} differs from the fixture")
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError(f"{label}: non-finite energies: {energies}")
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    out = {"energies": energies, "accepted": accepted, "rows": rows, "ms": ms,
           "launches": launches, "mn": mn, "snap": snap}
    fields = {"vertices": p.n_vertices, "triangles": p.n_tris, "setup_s": f"{setup_s:.3f}",
              "energies": json.dumps(energies), "accepted": json.dumps(accepted),
              "multipliers_finite": json.dumps([r["finite"] for r in rows]),
              "null_space_fallback": json.dumps([r["fallback"] for r in rows]),
              "lam_max": json.dumps([r["lam_max"] for r in rows]),
              "ms_per_step": f"{ms:.3f}", "launches": json.dumps(launches)}
    if f64 is not None:
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(energies, f64["energies"],
                                                             strict=True))
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        fields.update(reference="'the float64 phase'", max_rel_dev=repr(out["dev"]),
                      bound=repr(bound),
                      jax_float32_accepted=json.dumps(fixture["float32_reference"]["accepted"]),
                      jax_float32_multipliers_finite=json.dumps(
                          fixture["float32_reference"]["multipliers_finite"]))
        if not out["dev"] <= bound:
            raise AssertionError(f"{label}: energies deviate from the float64 phase by {out['dev']!r}")
    return out, fields


def phase_free_disk(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
                    f64=None) -> dict:
    """The free-disk lane on kozlov L3 (``lane_phase``), then its own checks.

    After every step the rigid disk's anchor-pair distances equal the
    reference shape's (``PAIR_TOL``).  At float64: the accept flags and the
    multiplier-finite flags (the JAX package's branch) equal the fixture's;
    per step the energy less ``ORDER_TERM`` (the breakdown's, after the
    step) within rel 1e-8 of the fixture's, and every other breakdown term
    within 1e-8 of the lane's energy; ``ORDER_TERM`` within ``ORDER_RTOL``.
    Then the seconds of the compact K x K solve of one more step.
    """
    tol = PAIR_TOL[str(dtype).split(".")[-1]]
    out, fields = lane_phase(torch, counters, label, fixture, dtype, expect, f64,
                             per_step=lambda mn: {"pair_err": pair_distance_error(torch, mn)})
    pair_err = max(r["pair_err"] for r in out["rows"])
    solve_s, k = kkt_solve_seconds(torch, out["mn"])
    fields.update(pair_distance_max_err=repr(pair_err), pair_bound=repr(tol),
                  kkt_K=k, kkt_solve_s=f"{solve_s:.4f}")
    failed = []
    if not pair_err <= tol:
        failed.append(f"anchor-pair distances off by {pair_err!r}")
    if f64 is None:
        want_e, rows = fixture["energies"], out["rows"]
        reduced_dev, term_dev, order_dev = [], [], []
        for e, w, r, wb in zip(out["energies"], want_e, rows, fixture["breakdowns"], strict=True):
            bd = r["breakdown"]
            reduced_dev.append(abs((e - bd[ORDER_TERM]) - (w - wb[ORDER_TERM]))
                               / abs(w - wb[ORDER_TERM]))
            term_dev.append(max(abs(bd[k] - wb[k]) for k in wb if k != ORDER_TERM) / abs(w))
            order_dev.append(abs(bd[ORDER_TERM] - wb[ORDER_TERM]) / abs(wb[ORDER_TERM]))
        out["dev"] = max(reduced_dev)
        fields.update(jax_accepted=json.dumps(fixture["accepted"]),
                      jax_multipliers_finite=json.dumps(fixture["multipliers_finite"]),
                      jax_lam_max=json.dumps(fixture["multipliers_max_abs"]),
                      max_rel_dev_less_order_term=repr(out["dev"]),
                      max_term_dev=repr(max(term_dev)), order_term_rel_dev=json.dumps(order_dev),
                      total_rel_dev=json.dumps([abs(a - b) / abs(b) for a, b in
                                                zip(out["energies"], want_e, strict=True)]))
        if out["accepted"] != fixture["accepted"]:
            failed.append(f"accept flags {out['accepted']} vs {fixture['accepted']}")
        if [r["finite"] for r in rows] != fixture["multipliers_finite"]:
            failed.append("multiplier-finite flags differ from the fixture's")
        if not (out["dev"] <= F64_RTOL and max(term_dev) <= F64_RTOL
                and max(order_dev) <= ORDER_RTOL):
            failed.append(f"energies: {reduced_dev} {term_dev} {order_dev}")
    say(label, **fields)
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    out["kkt_solve_s"], out["kkt_K"] = solve_s, k
    return out


def phase_interface(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
                    f64=None) -> dict:
    """The local-interface lane on kozlov L3 (``lane_phase``), then its own checks.

    The relax must take every module's dense tilt rows (the hard interface
    row has no compact form): their count is printed.  At float64 the
    energies within rel 1e-8 of the fixture with its accept flags, and the
    breakdown's ``curved_local_interface_law`` term within rel 1e-8 of the
    fixture's, floored at 1e-12 of the lane's energy (it starts at 0).
    """
    from membrane_solver_tpu_torch.runtime import tilt_relax

    out, fields = lane_phase(torch, counters, label, fixture, dtype, expect, f64,
                             timed=INTERFACE_TIMED_STEPS)
    p = out["mn"].problem()
    compact = tilt_relax.make_compact_tilt_collector(p.spec)
    rows = tilt_relax.make_tilt_constraint_rows(p.spec)(p.state, p.topo, p.params)
    fields.update(dense_tilt_rows=int(rows.shape[0]), compact_tilt_path=compact is not None,
                  relax_accepted_steps=json.dumps([r["relax"] for r in out["rows"]]))
    if f64 is not None:
        fields["jax_float32_relax_accepted_steps"] = json.dumps(
            fixture["float32_reference"].get("relax_accepted_steps"))
    else:
        fields["jax_relax_accepted_steps"] = json.dumps(fixture.get("relax_accepted_steps"))
    out["dense_rows"] = int(rows.shape[0])
    failed = [] if compact is None else ["the relax took compact tilt rows"]
    if f64 is None:
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(out["energies"], fixture["energies"],
                                                             strict=True))
        law = "curved_local_interface_law"
        got, want = out["rows"][-1]["breakdown"][law], fixture["breakdown_after"][law]
        floor = 1e-12 * abs(fixture["energy_after"])
        fields.update(jax_accepted=json.dumps(fixture["accepted"]), max_rel_dev=repr(out["dev"]),
                      law_term=repr(got), law_term_fixture=repr(want))
        if out["accepted"] != fixture["accepted"]:
            failed.append(f"accept flags {out['accepted']} vs {fixture['accepted']}")
        if not out["dev"] <= F64_RTOL:
            failed.append(f"energies deviate from the JAX fixture by {out['dev']!r}")
        if not abs(got - want) <= F64_RTOL * max(abs(want), floor):
            failed.append(f"{law} {got!r} vs {want!r}")
    say(label, **fields)
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return out


def shell_line(mn) -> dict:
    """The physical-edge rim placement's compiled shells on the lane, and its sequential levels."""
    from membrane_solver_tpu_torch.constraints import rim_slope_match_out as rim

    p = mn.problem()
    flags = rim._spec_flags(p.spec)
    outer = p.topo.extras[f"{rim._KEY}/outer"]
    disk_r, rim_r, outer_r = p.topo.extras[f"{rim._KEY}/shell_radii"].tolist()
    counts = np.bincount(outer.detach().cpu().numpy())
    return {"disk_radius": disk_r, "rim_radius": rim_r, "outer_radius": outer_r,
            "conditions": int(outer.shape[0]), "shell_rows": int((counts > 0).sum()),
            "most_conditions_per_row": int(counts.max()),
            "shared_targets": flags.shared_targets,
            "levels": len(rim._condition_levels(p.topo, outer)),
            "disk_targeting": flags.disk_targeting, "scaffold": flags.scaffold}


def phase_physical_edge(torch, counters, label: str, fixture: dict, dtype, expect: tuple,
                        f64=None, forbid: tuple = ()) -> dict:
    """A physical-edge lane on kozlov L3 (``lane_phase``), then its own checks.

    The compiled shells (trace radius, conditions, shell rows, shared
    targets) are printed, and at float64 equal the fixture's (at float32 the
    positions the shells are chosen from are rounded, and the azimuth
    pairing may move); the kernels in ``forbid`` (the frozen-tilt
    entry point on the scaffold lane, where the recovered and reconstructed
    divergence mix triangles) launch no time.  Per step the ``trace_z``
    fallback's decision and each leaflet relax's accepted CG steps are
    printed beside the JAX package's (float64: the fixture's; float32: its
    ``float32_reference``).  At float64: the energies within rel 1e-8 of the
    fixture, its accept flags, its ``trace_z`` decisions and relax counts,
    and the host syncs of one more ``minimize(1)``.
    """
    out, fields = lane_phase(torch, counters, label, fixture, dtype, expect, f64,
                             timed=PHYSICAL_TIMED_STEPS)
    mn = out["mn"]
    shells = shell_line(mn)
    ran = [k for k in forbid if out["launches"][k]]
    trace_z = [r["trace_z"] for r in out["rows"]]
    relax = [r["relax"] for r in out["rows"]]
    ref = fixture if f64 is None else fixture["float32_reference"]
    fields.update(shells=json.dumps(shells), trace_z=json.dumps(trace_z),
                  jax_trace_z=json.dumps(ref["trace_z"]), relax_accepted_steps=json.dumps(relax),
                  jax_relax_accepted_steps=json.dumps(ref["relax_accepted_steps"]),
                  frozen_tilt_launches=json.dumps(
                      {k: out["launches"][f"frozen_tilt.{k}"] for k in ("energy", "energy_grad")}))
    failed = [f"launched {ran}"] if ran else []
    if f64 is None:
        want = fixture["shells"]
        for key in ("conditions", "shell_rows", "most_conditions_per_row", "shared_targets"):
            if shells[key] != want[key]:
                failed.append(f"shells {key} {shells[key]} vs {want[key]}")
        for key in ("disk_radius", "rim_radius", "outer_radius"):
            if not abs(shells[key] - want[key]) <= 1e-12 * abs(want[key]):
                failed.append(f"shells {key} {shells[key]!r} vs {want[key]!r}")
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(out["energies"], fixture["energies"],
                                                             strict=True))
        fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
        fields.update(jax_accepted=json.dumps(fixture["accepted"]), max_rel_dev=repr(out["dev"]),
                      sync_sites=json.dumps(sites[:6]))
        out["syncs"] = fields["syncs_per_step"]
        if out["accepted"] != fixture["accepted"]:
            failed.append(f"accept flags {out['accepted']} vs {fixture['accepted']}")
        if trace_z != fixture["trace_z"]:
            failed.append(f"trace_z decisions {trace_z} vs {fixture['trace_z']}")
        if relax != fixture["relax_accepted_steps"]:
            failed.append(f"relax accepted steps {relax} vs {fixture['relax_accepted_steps']}")
        if not out["dev"] <= F64_RTOL:
            failed.append(f"energies deviate from the JAX fixture by {out['dev']!r}")
    say(label, **fields)
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    out["shells"] = shells
    return out


def phase_match_drives(torch, counters, label: str, fixture: dict) -> dict:
    """The local-interface family's drives on kozlov L3, float64 against the fixture, then float32.

    ``match_drives_setup`` on the kozlov lane's mesh after its refinements
    (built at float64; the lane's own inputs within 1e-12 of the
    fixture's), then ``port_match_record`` on the fixture's inputs: the
    energies and gradients, the constraints' tilt rows and enforcement
    changes in every mode, the rigid disk's double fit, within 1e-10 of the
    fixture (of |E|, of each array's largest entry); then the same at
    float32 against the float64 record within max(2e-3, 2 x the JAX
    package's own float32 deviation per item).  The curvature-data kernel,
    the divergence kernel and its tilt backward must launch inside
    ``bending_tilt``.
    """
    proto = fixture["protocol"]
    t0 = time.perf_counter()
    reset_counts(counters)
    mesh = build_lane(torch, proto["kozlov"], torch.float64).mesh
    match_drives_setup(mesh, proto)
    setup_s = time.perf_counter() - t0
    nv = fixture["n_vertices"]
    fields = ("positions", "tilts", "tilts_in", "tilts_out")
    inputs = {f: decode_rows(fixture["inputs"][f], nv) for f in fields}
    t1 = time.perf_counter()
    own = port_match_record(torch, mesh, proto, torch.float64, DEVICE)
    input_dev = {f: float(np.max(np.abs(decode_rows(own["inputs"][f], nv) - inputs[f])))
                 for f in fields}
    rec64 = port_match_record(torch, mesh, proto, torch.float64, DEVICE, inputs, counters)
    s64 = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec32 = port_match_record(torch, mesh, proto, torch.float32, DEVICE, inputs)
    s32 = time.perf_counter() - t1
    launches = read_counts(counters)
    dev64 = match_deviations(fixture, rec64, np)
    dev32 = match_deviations(rec64, rec32, np)
    ref32 = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    failed = []
    if not all(d <= 1e-12 * max(float(np.max(np.abs(inputs[f]))), 1.0)
               for f, d in input_dev.items()):
        failed.append(f"the lane's inputs differ from the fixture's: {input_dev}")
    for group in ("energies", "constraints"):
        for name, row in dev64[group].items():
            bound32 = {k: max(F32_RTOL, 2 * ref32[group][name][k]) for k in row}
            say(label + " item", item=name, dev_f64=json.dumps(row),
                dev_f32=json.dumps(dev32[group][name]), bound_f32=json.dumps(bound32))
            if not all(d <= DRIVES_F64_RTOL for d in row.values()):
                failed.append(f"{name} float64 {row}")
            if not all(dev32[group][name][k] <= bound32[k] for k in row):
                failed.append(f"{name} float32 {dev32[group][name]} bound {bound32}")
    bound_rigid = max(F32_RTOL, 2 * ref32["rigid_disk"])
    say(label + " item", item="rigid_disk", dev_f64=repr(dev64["rigid_disk"]),
        dev_f32=repr(dev32["rigid_disk"]), bound_f32=repr(bound_rigid))
    if not dev64["rigid_disk"] <= DRIVES_F64_RTOL:
        failed.append(f"rigid_disk float64 {dev64['rigid_disk']!r}")
    if not dev32["rigid_disk"] <= bound_rigid:
        failed.append(f"rigid_disk float32 {dev32['rigid_disk']!r}")
    stub = (rec64["energies"]["mean_curvature_tilt"]["energy"],
            rec32["energies"]["mean_curvature_tilt"]["energy"])
    if stub != (0.0, 0.0):
        failed.append(f"mean_curvature_tilt is not 0: {stub}")
    bt = rec64["launches"]["bending_tilt"]  # curvature fwd, bwd, divergence fwd, tilt bwd
    say(label, vertices=nv, triangles=fixture["n_triangles"], setup_s=f"{setup_s:.3f}",
        input_max_abs_dev=json.dumps(input_dev), f64_s=f"{s64:.3f}", f32_s=f"{s32:.3f}",
        bending_tilt_launches=json.dumps(bt), launches=json.dumps(launches))
    if not (bt[0] > 0 and bt[2] > 0 and bt[3] > 0):
        failed.append(f"bending_tilt did not launch kernels 3, 4 and the tilt backward: {bt}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "dev64": dev64, "dev32": dev32}


# --- phases 30-32: the last per-module modes ----------------------------------


def pin_fit_record(mn) -> dict:
    """The port's fitted rim circle (center, radius) and slide plane offsets on the device state."""
    from membrane_solver_tpu_torch.constraints import pin_to_circle, pin_to_plane

    p = mn.problem()
    out = {}
    if pin_to_circle._has_groups(p.topo):
        _n, center, radius, _c = pin_to_circle._group_circles(p.state.positions, p.topo)
        out["circle_center"] = center.detach().cpu().double().numpy().tolist()
        out["circle_radius"] = radius.detach().cpu().double().numpy().tolist()
    if pin_to_plane._has_groups(p.topo):
        normals, points = pin_to_plane._group_planes(p.state.positions, p.topo)
        out["plane_offset"] = (normals * points).sum(dim=1).detach().cpu().double().numpy().tolist()
    return out


def fit_deviation(got: dict, want: dict) -> float:
    """Largest absolute difference of the per-step theta_B, circle and plane records."""
    dev = 0.0
    for g, w in zip(got, want, strict=True):
        for key in ("thetaB", "circle_center", "circle_radius", "plane_offset"):
            a, b = np.asarray(g[key], dtype=float), np.asarray(w[key], dtype=float)
            dev = max(dev, float(np.max(np.abs(a - b))))
    return dev


def j0_payload_check(torch, ft, mn) -> dict:
    """The fused frozen-tilt energy on the lane's state: zeroed base rows and kernel vs twin.

    The payload's inner base columns are 0 on every corner of an assume-J0
    row and the outer ones on every corner of a region row (the largest
    base value elsewhere is printed: on this lane's flat start it is the
    round-off of a flat mesh's curvature); one call of each kernel variant
    on the lane's payload and tilts, and on seeded tilts, against the twin.
    """
    fused, p = fused_tilt_energy_of(torch, mn)
    if fused is None:
        raise AssertionError("the relax builds no fused frozen-tilt energy on the J0-fit lane")
    rows = p.topo.tri_rows
    out = {}
    for side, key, cols in (("in", "energy:bending_tilt_in/assume_J0", slice(2, 5)),
                            ("out", "energy:bending_tilt_out/region_zero", slice(8, 11))):
        masked = p.topo.extras[key][rows]
        base = fused.payload[:, cols]
        out[f"zeroed_corners_{side}"] = int(masked.sum())
        out[f"max_abs_base_on_zeroed_{side}"] = float(torch.max(torch.abs(base[masked])))
        out[f"max_abs_base_elsewhere_{side}"] = float(torch.max(torch.abs(base[~masked])))
    rng = np.random.default_rng(23)
    seeded = [torch.as_tensor(0.1 * rng.standard_normal((p.n_vertices, 3)), dtype=torch.float32,
                              device=DEVICE) for _ in range(2)]
    for what, (t_in, t_out) in (("lane tilts", (p.state.tilts_in, p.state.tilts_out)),
                                ("seeded tilts", seeded)):
        out[what] = compare_frozen_tilt(torch, ft, rows, p.topo.corner_csr(), t_in.contiguous(),
                                        t_out.contiguous(), fused.g, fused.payload, fused.k_vec)
    return out


def phase_j0_fit(torch, ft, counters, label: str, fixture: dict, dtype, expect: tuple,
                 f64=None) -> dict:
    """The J0-fit lane on kozlov L3 (``lane_phase``), then its own checks.

    Per step theta_B after the closed-form update (the legacy contact
    penalty), the fitted rim circle and the disk's slide plane offset, and
    each leaflet relax's accepted CG steps, beside the JAX package's.  At
    float64: the energies within rel 1e-8 of the fixture, its accept flags
    and relax counts, theta_B, the circle and the plane within
    ``J0_FIT_ATOL``, no compile after the minimize entry, and the host
    syncs of one more ``minimize(1)``.  At float32 (``f64``): the energies
    within max(2e-3, 2 x the JAX package's own float32 deviation) of the
    float64 phase, and on the lane's payload (its zeroed base rows) the
    frozen-tilt kernel against its twin.
    """
    from membrane_solver_tpu_torch.device import state as dstate

    def per_step(mn):
        return {"thetaB": float(mn.global_params.get("tilt_thetaB_value")), **pin_fit_record(mn)}

    out, fields = lane_phase(torch, counters, label, fixture, dtype, expect, f64,
                             per_step=per_step, timed=J0_TIMED_STEPS)
    mn = out["mn"]
    # compiles after the minimize entry (which recompiles after its
    # constraint enforcement): the per-iteration theta_B writes refresh the
    # parameters only
    compiles = []
    mn.minimize(2, callback=lambda _mesh, _i: compiles.append(dstate.COMPILES["compile_state"]))
    compiles.append(dstate.COMPILES["compile_state"])
    fits = [{k: r[k] for k in ("thetaB", "circle_center", "circle_radius", "plane_offset")}
            for r in out["rows"]]
    relax = [r["relax"] for r in out["rows"]]
    ref = fixture if f64 is None else fixture["float32_reference"]
    fields.update(thetaB=json.dumps([f["thetaB"] for f in fits]),
                  jax_thetaB=json.dumps([f["thetaB"] for f in ref["fits"]]),
                  circle_radius=json.dumps([f["circle_radius"] for f in fits]),
                  plane_offset=json.dumps([f["plane_offset"] for f in fits]),
                  relax_accepted_steps=json.dumps(relax),
                  jax_relax_accepted_steps=json.dumps(ref["relax_accepted_steps"]),
                  compiles_after_entry=compiles[-1] - compiles[0],
                  frozen_tilt_launches=json.dumps(
                      {k: out["launches"][f"frozen_tilt.{k}"] for k in ("energy", "energy_grad")}))
    failed = []
    if compiles[-1] != compiles[0]:
        failed.append(f"compile_state ran inside minimize: {compiles}")
    out["fit_dev"] = fit_deviation(fits, ref["fits"])
    fields["fit_max_abs_dev"] = repr(out["fit_dev"])
    if f64 is None:
        out["dev"] = max(abs(a - b) / abs(b) for a, b in zip(out["energies"], fixture["energies"],
                                                             strict=True))
        fields["syncs_per_step"], sites = count_syncs(torch, lambda: mn.minimize(1))
        fields.update(jax_accepted=json.dumps(fixture["accepted"]), max_rel_dev=repr(out["dev"]),
                      fit_bound=repr(J0_FIT_ATOL), sync_sites=json.dumps(sites[:6]))
        out["syncs"] = fields["syncs_per_step"]
        if out["accepted"] != fixture["accepted"]:
            failed.append(f"accept flags {out['accepted']} vs {fixture['accepted']}")
        if relax != fixture["relax_accepted_steps"]:
            failed.append(f"relax accepted steps {relax} vs {fixture['relax_accepted_steps']}")
        if not out["dev"] <= F64_RTOL:
            failed.append(f"energies deviate from the JAX fixture by {out['dev']!r}")
        if not out["fit_dev"] <= J0_FIT_ATOL:
            failed.append(f"theta_B / circle / plane deviate by {out['fit_dev']!r}")
    else:
        payload = j0_payload_check(torch, ft, mn)
        fields["payload"] = json.dumps(payload)
        out["payload"] = payload
        for side in ("in", "out"):
            if not (payload[f"zeroed_corners_{side}"] > 0
                    and payload[f"max_abs_base_on_zeroed_{side}"] == 0.0):
                failed.append(f"the payload's {side} base rows are not zeroed: {payload}")
    say(label, **fields)
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return out


def mode_drives_setup(mesh, protocol: dict) -> dict:
    """Seeded heights and leaflet tilts on a kozlov host mesh (either package's).

    The protocol's global parameters; then, in vertex-id order
    (``numpy.random.default_rng(seed)``), ``z_scale`` of height on every
    free vertex and leaflet tilts of ``tilt_scale`` where they are free.
    Returns the vertices' options, which :func:`mode_problem_setup` restores.
    """
    mesh.global_parameters.update(protocol["global_parameters"])
    rng = np.random.default_rng(protocol["seed"])
    for vid in sorted(mesh.vertices):
        v = mesh.vertices[vid]
        dz = protocol["z_scale"] * rng.standard_normal()
        tilts = protocol["tilt_scale"] * rng.standard_normal((2, 3))
        if not v.fixed:
            v.position[2] += dz
        if not (v.tilt_fixed_in or v.tilt_fixed_out):
            v.tilt_in, v.tilt_out = tilts[0], tilts[1]
    return {vid: dict(v.options or {}) for vid, v in mesh.vertices.items()}


def mode_problem_setup(mesh, protocol: dict, snapshot: dict, name: str) -> None:
    """The host mesh as the protocol's problem ``name`` compiles it (either package's).

    Every global parameter any problem sets is unset, then the problem's
    own set; every vertex's options are restored from ``snapshot``, then
    the problem's ``definition_options`` {preset: {key: value}} set on its
    presets' vertices (a value of None removes a given normal or radius).
    """
    gp = mesh.global_parameters
    for other in protocol["problems"].values():
        for key in other["global_parameters"]:
            gp.unset(key)
    gp.update(protocol["problems"][name]["global_parameters"])
    opts = protocol["problems"][name].get("definition_options", {})
    for vid, v in mesh.vertices.items():
        v.options = dict(snapshot[vid])
        v.options.update(opts.get(v.options.get("preset"), {}))


def sample_rows(protocol: dict, n: int):
    """The fixed row sample of the mode drives' dense arrays (``sample_seed``)."""
    rng = np.random.default_rng(protocol["sample_seed"])
    return np.sort(rng.choice(n, size=min(protocol["sample_rows"], n), replace=False))


def sketch(arr, rows) -> dict:
    """A dense (n, 3) array as its sampled rows (base64 float64), its L2 norm and its max |entry|."""
    arr = np.ascontiguousarray(arr, dtype="<f8")
    return {"sample": base64.b64encode(arr[rows].tobytes()).decode(),
            "norm": float(np.linalg.norm(arr)), "max": float(np.max(np.abs(arr)))}


def sketch_deviation(want: dict, got: dict) -> float:
    """Largest sampled-row error and L2-norm error of ``got``, over ``want``'s max |entry|."""
    w = np.frombuffer(base64.b64decode(want["sample"]), dtype="<f8")
    g = np.frombuffer(base64.b64decode(got["sample"]), dtype="<f8")
    err = max(float(np.max(np.abs(g - w))) if w.size else 0.0, abs(got["norm"] - want["norm"]))
    return err / want["max"] if want["max"] > 0 else err


MODE_FIELDS = ("positions", "tilts_in", "tilts_out")


def port_mode_record(torch, mesh, protocol: dict, snapshot: dict, dtype, device,
                     counters=None) -> dict:
    """The mode drives by the port, in the format of the recorder's ``mode_drives_run``.

    Per problem of the protocol: each listed energy module's value and
    gradients in the positions and both leaflet tilts (sketched), its
    frozen split against them (``frozen``: the largest deviation of the
    split's value and tilt gradients, held here and not recorded by the
    JAX package), the divergence cap's capped triangles, and each pin
    constraint's enforcement (the position change) and local normals; with
    ``counters``, the frozen-tilt launches of a short float32 relax of the
    problem (``relax_launches``).  Then the closed-form theta_B of the
    legacy penalty on the seeded host state and its Gauss-Bonnet
    invariant.
    """
    from membrane_solver_tpu_torch import Minimizer
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.energy import bending_tilt_leaflet as bt
    from membrane_solver_tpu_torch.energy import get_module, tilt_thetaB_contact_in
    from membrane_solver_tpu_torch.kernels import tri_kernels
    from membrane_solver_tpu_torch.runtime.diagnostics.gauss_bonnet import gauss_bonnet_invariant

    as_np = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    rec = {"problems": {}}
    for name, prob in protocol["problems"].items():
        mode_problem_setup(mesh, protocol, snapshot, name)
        mn = Minimizer(mesh, device=device, dtype=dtype, quiet=True)
        p = mn.problem()
        rows = sample_rows(protocol, p.n_vertices)
        if "inputs" not in rec:
            rec.update(n_vertices=p.n_vertices, n_triangles=p.n_tris,
                       inputs={f: sketch(as_np(getattr(p.state, f)), rows) for f in MODE_FIELDS})
        out = {"energies": {}, "frozen": {}, "enforce": {}, "normals": {}}
        for mod_name in prob["energies"]:
            module = get_module(mod_name)
            leaves = [getattr(p.state, f).detach().clone().requires_grad_(True)
                      for f in MODE_FIELDS]
            st = dataclasses.replace(p.state, **dict(zip(MODE_FIELDS, leaves)))
            geo = dgeo.triangle_geometry(st.positions, p.topo.tri_rows, p.topo.tri_valid)
            maker = getattr(module, "make_energy", None)
            fn = maker(p.spec) if maker is not None else module.energy
            e = fn(geo, st, p.topo, p.params)
            grads = torch.autograd.grad(e, leaves, allow_unused=True)
            grads = [np.zeros((p.n_vertices, 3)) if g is None else as_np(g) for g in grads]
            out["energies"][mod_name] = {"energy": float(e.detach()), **{
                f: sketch(g, rows) for f, g in zip(MODE_FIELDS, grads)}}
            pre, fn = module.make_tilt_frozen(p.spec)
            tin, tout = (getattr(p.state, f).detach().clone().requires_grad_(True)
                         for f in ("tilts_in", "tilts_out"))
            ef = fn(tin, tout, pre(p.state, p.topo, p.params), p.topo, p.params)
            fg = [np.zeros((p.n_vertices, 3)) if g is None else as_np(g)
                  for g in torch.autograd.grad(ef, (tin, tout), allow_unused=True)]
            dev = abs(float(ef.detach()) - float(e.detach())) / max(abs(float(e.detach())), 1e-300)
            for g_f, g in zip(fg, grads[1:]):
                scale = float(np.max(np.abs(g)))
                err = float(np.max(np.abs(g_f - g)))
                dev = max(dev, err / scale if scale > 0 else err)
            out["frozen"][mod_name] = dev
        if prob["global_parameters"].get("bending_tilt_in_update_mode") == (
                "outer_near_divergence_cap_v1"):
            with torch.no_grad():
                pos = p.state.positions
                div, _a, _g = tri_kernels.p1_triangle_divergence(
                    pos, p.state.tilts_in, p.topo.tri_rows, p.topo.tri_valid,
                    p.topo.corner_csr())
                capped = bt._apply_divergence_cap(-div, *bt.cap_masks(pos, p.topo, p.params))
                out["capped"] = int(torch.sum(capped != -div))
        for con in ("pin_to_plane", "pin_to_circle"):
            mod = get_constraint(con)
            moved = mod.enforce(p.state, p.topo, p.params, context="minimize")
            out["enforce"][con] = encode_rows(as_np(moved.positions) - as_np(p.state.positions))
            normals = as_np(mod.local_constraint_normals(p.state, p.topo, p.params))
            out["normals"][con] = [encode_rows(normals[:, k]) for k in range(normals.shape[1])]
        if counters is not None:
            mn32 = Minimizer(mesh, device=device, dtype=torch.float32, quiet=True)
            before = sum(counters["frozen_tilt"].values())
            mn32.relax_leaflet_tilts(max_iters=protocol["relax_iters"])
            torch.cuda.synchronize()
            out["relax_launches"] = sum(counters["frozen_tilt"].values()) - before
        rec["problems"][name] = out
    gp = mesh.global_parameters
    mode_problem_setup(mesh, protocol, snapshot, protocol["thetaB_problem"])
    before = gp.get("tilt_thetaB_value")
    tilt_thetaB_contact_in.update_scalar_params(mesh, gp)
    rec["thetaB_update"] = float(gp.get("tilt_thetaB_value"))
    gp.set("tilt_thetaB_value", before)
    g, k_int, b_total, _per_loop = gauss_bonnet_invariant(mesh)
    rec["gauss_bonnet"] = {"G": g, "K_int": k_int, "B": b_total}
    return rec


def mode_deviations(want: dict, got: dict) -> dict:
    """Per problem and item, the largest deviation of ``got`` from ``want`` (both as recorded).

    Energies: the value's relative deviation and each gradient sketch's
    (:func:`sketch_deviation`); constraints: the enforcement change's and
    each normal block's largest error over the largest entry; the capped
    triangle count's difference; theta_B's and the invariant's relative
    deviations.
    """
    n = want["n_vertices"]

    def dense(w_rec, g_rec):
        w, g = decode_rows(w_rec, n), decode_rows(g_rec, n)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        return err / scale if scale > 0 else err

    out = {"inputs": max(sketch_deviation(want["inputs"][f], got["inputs"][f])
                         for f in MODE_FIELDS)}
    for name, w in want["problems"].items():
        g = got["problems"][name]
        for mod_name, wm in w["energies"].items():
            gm = g["energies"][mod_name]
            e = abs(gm["energy"] - wm["energy"])
            row = {"energy": e / abs(wm["energy"]) if wm["energy"] != 0.0 else e}
            row.update({f: sketch_deviation(wm[f], gm[f]) for f in MODE_FIELDS})
            out[f"{name}/{mod_name}"] = row
        for con, wc in w["enforce"].items():
            out[f"{name}/{con}"] = {
                "enforce": dense(wc, g["enforce"][con]),
                "normals": max(dense(a, b) for a, b in zip(w["normals"][con],
                                                           g["normals"][con], strict=True))}
        if "capped" in w:
            out[f"{name}/capped"] = {"count": abs(g["capped"] - w["capped"])}
    out["thetaB_update"] = {"value": abs(got["thetaB_update"] - want["thetaB_update"])
                            / abs(want["thetaB_update"])}
    out["gauss_bonnet"] = {k: abs(got["gauss_bonnet"][k] - v) / max(abs(v), 1.0)
                           for k, v in want["gauss_bonnet"].items()}
    return out


def phase_mode_drives(torch, counters, label: str, fixture: dict) -> dict:
    """The per-module modes on kozlov L3, float64 against the fixture, then float32.

    ``mode_drives_setup`` on the kozlov lane's mesh after its refinements,
    then per problem of the protocol (``port_mode_record``): float64 within
    ``DRIVES_F64_RTOL`` of the fixture (the sampled and summed gradients,
    the pin enforcements and normals, the capped triangle count equal), the
    frozen splits within 1e-12 of the full energies; float32 against the
    float64 record within max(2e-3, 2 x the JAX package's own float32
    deviation per item).  A short float32 relax of each problem: no
    frozen-tilt launch under ``diagonal`` and the in-update modes (the JAX
    package's gate), some on the problem with neither.  Then one
    ``check_gauss_bonnet`` call on the L3 host mesh, timed.
    """
    from membrane_solver_tpu_torch import Minimizer
    from membrane_solver_tpu_torch.runtime.diagnostics.audit import check_gauss_bonnet

    proto = fixture["protocol"]
    t0 = time.perf_counter()
    reset_counts(counters)
    mesh = build_lane(torch, proto["kozlov"], torch.float64).mesh
    snapshot = mode_drives_setup(mesh, proto)
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    rec64 = port_mode_record(torch, mesh, proto, snapshot, torch.float64, DEVICE, counters)
    s64 = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec32 = port_mode_record(torch, mesh, proto, snapshot, torch.float32, DEVICE)
    s32 = time.perf_counter() - t1
    dev64 = mode_deviations(fixture, rec64)
    dev32 = mode_deviations(rec64, rec32)
    ref32 = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    failed = []
    if not dev64["inputs"] <= 1e-12:
        failed.append(f"the lane's inputs differ from the fixture's: {dev64['inputs']!r}")
    for item, row in dev64.items():
        if item == "inputs":
            continue
        bound32 = {k: max(F32_RTOL, 2 * ref32[item][k]) for k in row}
        say(label + " item", item=item, dev_f64=json.dumps(row), dev_f32=json.dumps(dev32[item]),
            bound_f32=json.dumps(bound32))
        bound64 = 0 if item.endswith("/capped") else DRIVES_F64_RTOL
        if not all(d <= bound64 for d in row.values()):
            failed.append(f"{item} float64 {row}")
        if not item.endswith("/capped") and not all(dev32[item][k] <= bound32[k] for k in row):
            failed.append(f"{item} float32 {dev32[item]} bound {bound32}")
    frozen = {f"{name}/{m}": d for name, q in rec64["problems"].items()
              for m, d in q["frozen"].items()}
    launches = {name: q["relax_launches"] for name, q in rec64["problems"].items()}
    capped = {name: q["capped"] for name, q in rec64["problems"].items() if "capped" in q}
    if not all(d <= 1e-12 for d in frozen.values()):
        failed.append(f"frozen splits off their full energies: {frozen}")
    want_none = [name for name, q in proto["problems"].items() if not q["kernel_in_relax"]]
    if any(launches[name] for name in want_none) or not all(
            launches[name] > 0 for name in proto["problems"] if name not in want_none):
        failed.append(f"frozen-tilt launches per problem's float32 relax: {launches}")
    if not all(c > 0 for c in capped.values()):
        failed.append(f"the divergence cap binds nowhere: {capped}")
    mesh.global_parameters.set("gauss_bonnet_monitor", True)
    mn = Minimizer(mesh, device=DEVICE, dtype=torch.float64, quiet=True)
    t1 = time.perf_counter()
    check_gauss_bonnet(mn)
    gb_s = time.perf_counter() - t1
    mesh.global_parameters.unset("gauss_bonnet_monitor")
    all_launches = read_counts(counters)
    say(label, vertices=rec64["n_vertices"], triangles=rec64["n_triangles"],
        setup_s=f"{setup_s:.3f}", f64_s=f"{s64:.3f}", f32_s=f"{s32:.3f}",
        input_dev=repr(dev64["inputs"]), frozen_split_dev=json.dumps(frozen),
        capped_triangles=json.dumps(capped), jax_capped=json.dumps(
            {name: q["capped"] for name, q in fixture["problems"].items() if "capped" in q}),
        f32_relax_frozen_tilt_launches=json.dumps(launches),
        thetaB_update=repr(rec64["thetaB_update"]), gauss_bonnet=json.dumps(rec64["gauss_bonnet"]),
        check_gauss_bonnet_s=f"{gb_s:.4f}", launches=json.dumps(all_launches))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"dev64": dev64, "dev32": dev32, "relax_launches": launches, "launches": all_launches,
            "gauss_bonnet_s": gb_s}


# ----------------------------------------------------------------------
# phases 33-35: the parameter sweep and the multi-disk sweep analysis
# ----------------------------------------------------------------------
SWEEP_FIXTURE = FIXTURES / "kozlov_L3_sweep_f64_jax.json"
SWEEP_STATS = ("energy", "accepted_energy", "grad_norm", "step_size", "step_success",
               "iterations")


def member_scan(protocol: dict) -> dict:
    """The protocol's parameter scan: {key: {"scale": s} or {"shift": s}}.

    The kozlov sweep's protocol names its two steps (``modulus_step``,
    ``thetaB_step``); the later ones give a ``scan`` block.
    """
    if "scan" in protocol:
        return protocol["scan"]
    return {"tilt_modulus_in": {"scale": protocol["modulus_step"]},
            "tilt_thetaB_value": {"shift": protocol["thetaB_step"]}}


def sweep_members(protocol: dict, positions, params) -> tuple[list, list]:
    """(member_params, member_positions) of the sweep protocol, from either package's problem.

    Member m: positions times 1 + ``dilation`` m; each scanned parameter
    times 1 + ``scale`` m or plus ``shift`` m (:func:`member_scan`).
    ``positions`` is a numpy array in the problem's dtype.
    """
    scan = member_scan(protocol)
    base = {key: float(params[key]) for key in scan}
    members = range(protocol["members"])
    return ([{key: base[key] * (1.0 + rule["scale"] * m) if "scale" in rule
              else base[key] + rule["shift"] * m for key, rule in scan.items()} for m in members],
            [positions * (1.0 + protocol["dilation"] * m) for m in members])


def sweep_options(protocol: dict) -> dict:
    """The protocol's ``MinimizeOptions`` arguments (the kozlov sweep's: the defaults)."""
    options = protocol.get("options")
    return dict(options) if isinstance(options, dict) else {}


def sweep_record(protocol: dict, stats: dict, positions) -> dict:
    """Per-member stats lists and a sketch of each member's final (n, 3) positions."""
    rows = sample_rows(protocol, positions.shape[1])
    out = {k: np.asarray(stats[k]).tolist() for k in SWEEP_STATS}
    out["positions"] = [sketch(p, rows) for p in positions]
    return out


SWEEP_EXPECT = ("tri_kernels.surface_energy_members", "tri_kernels.surface_energy_grad_members",
                "tri_kernels.curvature_data_members", "tri_kernels.curvature_data_bwd_members",
                "tri_kernels.p1_div_members", "vertex_sum.vertex_sum_members")
SWEEP_SIZES = (1, 2, 4, 8)  # members per timed sweep
SWEEP_TIMED_STEPS = 3
# the sweep steps the busy share is read over: the profiler's own cost grows
# with the operations it records (seconds per kozlov step at B = 8), and one
# step keeps the script inside its time limit
BUSY_STEPS = 1
# phase 53's [cuda:0, cpu] placement only: a member on the CPU runs the kernels' plain twins,
# another arithmetic than the card's kernels, against the card's sweep of the same members
# (every other member check is in bits: ``member_bits``)
MEMBER_RTOL = {"float64": 1e-12, "float32": 2e-6}
# the member twins loop over the members (thousands of operations a call):
# fewer timed calls keep the profiler's trace small
MEMBER_PLAIN_CALLS = 3
MULTIDISK_RTOL = 1e-10  # phase 35: the card's rows vs the CPU's, float64


def _stats_of(stats) -> dict:
    return {k: np.asarray(getattr(stats, k)) for k in SWEEP_STATS}


FLOAT_STATS = ("energy", "accepted_energy", "grad_norm", "step_size")


def _stat_devs(got: dict, want: dict, keys=FLOAT_STATS) -> list:
    """Per member, the largest relative deviation of the float stats ``keys``."""
    out = []
    for m in range(len(got["energy"])):
        out.append(max(abs(float(got[k][m]) - float(want[k][m])) / abs(float(want[k][m]))
                       for k in keys))
    return out


def member_bits(states, stats, m: int, w_states, w_stats, wm: int) -> list:
    """The state fields and ``MinimizeStats`` fields in which member ``m`` is not member ``wm``
    of the reference in bits."""
    def raw(x):
        return x.detach().cpu().numpy().tobytes()

    out = [f for f in STATE_FIELDS if raw(getattr(states, f)[m]) != raw(getattr(w_states, f)[wm])]
    return out + [f.name for f in dataclasses.fields(stats)
                  if np.asarray(getattr(stats, f.name))[m].tobytes()
                  != np.asarray(getattr(w_stats, f.name))[wm].tobytes()]


def _flags_equal(got: dict, want: dict) -> bool:
    return all(np.array_equal(np.asarray(got[k], dtype=np.int64), np.asarray(want[k], dtype=np.int64))
               for k in ("step_success", "iterations"))


def sweep_digest(states, stats: dict) -> str:
    """sha256 of the members' positions and tilts and of their stats, as bytes."""
    h = hashlib.sha256()
    for f in STATE_FIELDS:
        h.update(getattr(states, f).detach().cpu().numpy().tobytes())
    for k in SWEEP_STATS:
        h.update(np.ascontiguousarray(stats[k]).tobytes())
    return h.hexdigest()


def member_kernel_inputs(torch, states, seed: int):
    """(positions, tilts) (B, N, 3) on the card: the members' own, tilts with seeded per-member offsets."""
    pos = states.positions.detach().contiguous()
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(1e-2 * rng.standard_normal(tuple(pos.shape)), dtype=pos.dtype,
                            device=pos.device)
    return pos, (states.tilts_in.detach() + noise).contiguous()


def check_member_kernels(torch, tk, vs, topo, pos, tilts, seed: int) -> dict:
    """Each member-axis entry against its member twin (phase 3's bounds) and, member by
    member, against the single-member kernel (equal bits).  Returns the max abs errors.
    """
    dtype = pos.dtype
    name = str(dtype).removeprefix("torch.")
    B, n = pos.shape[0], pos.shape[1]
    rows, v, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T = rows.shape[0]
    tension = topo.tri_surface_tension.to(dtype)
    rng = np.random.default_rng(seed)

    def seeded(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=DEVICE)

    def same_bits(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"member-axis {what} ({name}) differs from the single-member "
                                 f"kernel: max abs diff {float(torch.max(torch.abs(got - want)))!r}")

    errs = {}
    ws = tk.MemberWorkspace(B, T, dtype, DEVICE)
    e_only, _ = tk.launch_surface_energy_members(pos, rows, v, tension, csr, ws, grad=False)
    e, dpos = tk.launch_surface_energy_members(pos, rows, v, tension, csr, ws, grad=True)
    want_e, want_g = tk.surface_energy_members_reference(pos, rows, v, tension, csr, True)
    errs["surface_energy_members"] = max(
        _sum_check(torch, f"member surface energy {m} ({name})", x[m], want_e[m], WC_ENERGY[name])
        for x in (e_only, e) for m in range(B))
    errs["surface_grad_members"] = max(
        _sum_check(torch, f"member surface gradient {m} ({name})", dpos[m], want_g[m],
                   WC_SURFACE_GRAD[name]) for m in range(B))

    cd = tk.launch_curvature_data_members(pos, rows, v, csr)
    want_cd = tk.curvature_data_members_reference(pos, rows, v, csr)
    ups = (seeded((B, n, 3)), seeded((B, n)), seeded((B, T, 3)), seeded((B, T, 3)))
    bwd = tk.launch_curvature_data_bwd_members(pos, rows, v, csr, *ups)
    want_bwd = tk.curvature_data_vjp_members_reference(pos, rows, v, csr, *ups)
    div = tk.launch_p1_divergence_members(pos, tilts, rows, v)
    want_div = tk.p1_divergence_members_reference(pos, tilts, rows, v)
    ct = seeded((B, T))
    dtl = tk.launch_p1_div_bwd_members(want_div[2].contiguous(), v, ct, csr)
    want_dtl = tk.p1_div_vjp_members_reference(want_div[2], v, ct, csr)
    corners = pos[:, rows].contiguous()
    vsum = vs.launch_members(corners, csr)
    vsum1 = vs.launch_members(want_cd[1].contiguous(), csr)
    for key in ("curvature_data_members", "curvature_data_bwd_members", "p1_div_members",
                "p1_div_bwd_members", "vertex_sum_members"):
        errs[key] = 0.0
    for m in range(B):
        clear = ~(v & torch.any(torch.abs(want_cd[0][m]) < TIE, dim=1))
        vclear = torch.ones(n, dtype=torch.bool, device=DEVICE)
        vclear[rows[~clear].reshape(-1)] = False
        errs["curvature_data_members"] = max(errs["curvature_data_members"], *(
            _tk_check(torch, f"member curvature data {what} {m}", a[m], b[m], dtype, "curv", ok)
            for a, b, what, ok in zip(cd, want_cd, ("cot", "va", "k_vecs", "vertex_areas"),
                                      (clear, clear, vclear, vclear))))
        errs["curvature_data_bwd_members"] = max(errs["curvature_data_bwd_members"], _bwd_check(
            torch, f"member curvature data bwd {m}", bwd[m], want_bwd[m], dtype, vclear))
        errs["p1_div_members"] = max(errs["p1_div_members"], *(
            _tk_check(torch, f"member p1 {what} {m}", a[m], b[m], dtype, "curv")
            for a, b, what in zip(div, want_div, ("div", "area", "g"))))
        errs["p1_div_bwd_members"] = max(errs["p1_div_bwd_members"], _sum_check(
            torch, f"member p1 div tilt backward {m} ({name})", dtl[m], want_dtl[m],
            WC_DIV_BWD[name]))
        for got, want in ((vsum, vs.members_reference(corners, csr)),
                          (vsum1, vs.members_reference(want_cd[1], csr))):
            if not torch.equal(got[m], want[m]):
                raise AssertionError(f"member vertex sum {m} ({name}) differs from its twin")
        # member m of each launch: the bits of the single-member kernel on member m
        p_m, t_m = pos[m].contiguous(), tilts[m].contiguous()
        e1, g1 = tk.launch_surface_energy(p_m, rows, v, tension, csr,
                                          tk.Workspace(T, dtype, DEVICE), grad=True)
        same_bits("surface energy", e[m], e1[0])
        same_bits("surface gradient", dpos[m], g1)
        for a, b in zip(cd, tk.launch_curvature_data(p_m, rows, v, csr)):
            same_bits("curvature data", a[m], b)
        same_bits("curvature data backward", bwd[m], tk.launch_curvature_data_bwd(
            p_m, rows, v, csr, *(u[m].contiguous() for u in ups)))
        # and the two-launch form the whole calls replace: the per-triangle
        # kernel, then the vertex sum
        cot1, k1, va1, _area = tk.launch_curvature(p_m, rows, v)
        for what, got, want in (("cot", cd[0][m], cot1), ("va", cd[1][m], va1),
                                ("k_vecs", cd[2][m], vs.launch(k1, csr)),
                                ("vertex_areas", cd[3][m], vs.launch(va1, csr))):
            same_bits(f"curvature data {what} vs the two-launch form", got, want)
        g_kvecs, g_varea, g_cot, g_va = (u[m] for u in ups)
        dc = tk.launch_curvature_bwd(p_m, rows, v, g_cot.contiguous(), g_kvecs[rows].contiguous(),
                                     (g_va + g_varea[rows]).contiguous(), p_m.new_zeros(T))
        same_bits("curvature data backward vs the two-launch form", bwd[m], vs.launch(dc, csr))
        for a, b in zip(div, tk.launch_p1_divergence(p_m, t_m, rows, v)):
            same_bits("p1 divergence", a[m], b)
        same_bits("p1 divergence tilt backward", dtl[m], tk.launch_p1_div_bwd(
            want_div[2][m].contiguous(), v, ct[m].contiguous(), csr))
        same_bits("vertex sum", vsum[m], vs.launch(corners[m].contiguous(), csr))
    torch.cuda.synchronize()
    return errs


def member_rows(torch, tk, vs, topo, pos, tilts) -> list:
    """(name, kind, fn, inputs, flops) of the member-axis kernels, their twins and a library call."""
    dtype = pos.dtype
    B, n = pos.shape[0], pos.shape[1]
    rows, v, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    T = rows.shape[0]
    tension = topo.tri_surface_tension.to(dtype)
    rng = np.random.default_rng(23)
    g_kvecs = torch.as_tensor(rng.standard_normal((B, n, 3)), dtype=dtype, device=DEVICE)
    g_varea = torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype, device=DEVICE)
    ws = tk.MemberWorkspace(B, T, dtype, DEVICE)
    corners = pos[:, rows].contiguous()
    # index_add_ of the same sums: every member's corner rows into its own vertex rows
    flat_rows = (csr.rows.reshape(1, -1) + n * torch.arange(B, device=DEVICE)[:, None]).reshape(-1)
    flat_corners = corners.reshape(-1, 3)

    def library_sum():
        return torch.zeros((B * n, 3), dtype=dtype, device=DEVICE).index_add_(0, flat_rows,
                                                                              flat_corners)

    F = FLOPS_PER_TRI
    s_in, d_in, b_in = (pos, rows, v, tension), (pos, rows, v), (pos, rows, v, g_kvecs, g_varea)
    div_in = (pos, tilts, rows, v)
    e_flops, g_flops = F["surface_energy"] * T * B, (F["surface_energy"] + F["surface_grad"]) * T * B
    return [
        ("surface_energy_members", "kernel", lambda: tk.launch_surface_energy_members(
            pos, rows, v, tension, csr, ws, grad=False), s_in, e_flops),
        ("surface_energy_members", "twin", lambda: tk.surface_energy_members_reference(
            pos, rows, v, tension, csr, False), s_in, e_flops),
        ("surface_energy_grad_members", "kernel", lambda: tk.launch_surface_energy_members(
            pos, rows, v, tension, csr, ws, grad=True), s_in, g_flops),
        ("surface_energy_grad_members", "twin", lambda: tk.surface_energy_members_reference(
            pos, rows, v, tension, csr, True), s_in, g_flops),
        ("curvature_data_members", "kernel",
         lambda: tk.launch_curvature_data_members(pos, rows, v, csr), d_in,
         F["curvature_fwd"] * T * B),
        ("curvature_data_members", "twin",
         lambda: tk.curvature_data_members_reference(pos, rows, v, csr), d_in,
         F["curvature_fwd"] * T * B),
        ("curvature_data_bwd_members", "kernel", lambda: tk.launch_curvature_data_bwd_members(
            pos, rows, v, csr, g_kvecs, g_varea, None, None), b_in, F["curvature_bwd"] * T * B),
        ("curvature_data_bwd_members", "twin", lambda: tk.curvature_data_vjp_members_reference(
            pos, rows, v, csr, g_kvecs, g_varea, None, None), b_in, F["curvature_bwd"] * T * B),
        ("p1_div_members", "kernel", lambda: tk.launch_p1_divergence_members(pos, tilts, rows, v),
         div_in, F["p1_div"] * T * B),
        ("p1_div_members", "twin", lambda: tk.p1_divergence_members_reference(pos, tilts, rows, v),
         div_in, F["p1_div"] * T * B),
        ("vertex_sum_members", "kernel", lambda: vs.launch_members(corners, csr),
         (corners, csr.offsets, csr.slots), 3 * 3 * T * B),
        ("vertex_sum_members", "twin", lambda: vs.members_reference(corners, csr),
         (corners, csr.offsets, csr.slots), 3 * 3 * T * B),
        ("vertex_sum_members", "library", library_sum, (corners, flat_rows), 3 * 3 * T * B),
    ]


def measure_members(torch, rows: list, dtype_name: str) -> dict:
    """``measure`` for the member rows (the twins, a loop over the members, with fewer calls)."""
    recs = {}
    for name, kind, fn, inputs, flops in rows:
        outputs = _flat(fn())
        torch.cuda.synchronize()
        timing = time_call(torch, fn,
                           calls=LOOP if kind in ("kernel", "library") else MEMBER_PLAIN_CALLS)
        moved = _nbytes(inputs) + _nbytes(outputs)
        bound, bound_by = bound_ms(moved, flops, dtype_name)
        recs[(name, kind)] = {"name": name, "kind": kind, "dtype": dtype_name,
                              **{k: v for k, v in timing.items() if k != "ops"},
                              "bytes": moved, "bound_ms": bound, "bound_by": bound_by}
    return recs


def sweep_busy(torch, run) -> tuple[float, float]:
    """(unprofiled ms per step, profiler busy ms per step) of ``run()``, a BUSY_STEPS sweep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / BUSY_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device-side operation")
    return wall_ms, sum(e.self_device_time_total for e in rows) / 1e3 / BUSY_STEPS


def drive_sweep(torch, counters, label: str, fixture: dict, dtype, problem, f64=None,
                widest_launches: bool = False,
                stat_bound: float | None = None, kkt: bool = False,
                f32_stats=FLOAT_STATS, trace_z: bool = False) -> dict:
    """The sweep protocol on ``problem``: the main run with the counts reset just before and
    read just after, then the checks every sweep phase shares.

    Against the reference (the JAX fixture at float64; at float32 the float64
    phase, with the fixture's ``float32_reference`` flags): per member the
    stats, the flags and a positions sketch.  Member m equal in bits to a
    one-member sweep of member m (:func:`member_bits`: its positions, tilts
    and every stat and flag); B copies of the member whose line searches scored the
    most trial states against its one-member sweep, launch for launch (the
    launches do not grow with B); two sweeps' digests; no ``compile_state``
    inside the sweep.  The B distinct members' launches equal that one-member
    sweep's where one member takes the most line-search rounds at every
    iteration (printed; with ``widest_launches`` a check, as on the kozlov
    lane, where every member rejects every step).  ``stat_bound`` replaces the
    float64 bound of the stats against the fixture, ``f32_stats`` the stats
    held against the float64 phase at float32; with ``kkt`` the main
    run's shape KKT solves are returned (``kkt``: per solve, (B,) finite
    and fallback flags and max|lam| on the host); with ``trace_z`` the main
    run's ``trace_z`` fallback per member and iteration (``trace_z``:
    per member, the fallback's viability and whether its search accepted,
    ``member_block.TRACE_Z_RECORD``).  Each member's fallback count equals
    its one-member sweep's (a stat).  Prints the phase's lines
    and returns what the caller checks and prints beside them; the returned
    ``check`` raises on a failed check.
    """
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.parallel import member_block
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime import jit_core
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    proto = fixture["protocol"]
    B = proto["members"]
    options = MinimizeOptions(**sweep_options(proto))
    params, positions = sweep_members(proto, problem.state.positions.detach().cpu().numpy(),
                                      problem.params)

    def run(members=range(B), steps=proto["steps"]):
        sel = list(members)
        out = run_sweep(problem, [params[m % B] for m in sel], steps,
                        step_size=proto["step_size"], options=options,
                        member_positions=[positions[m % B] for m in sel])
        torch.cuda.synchronize()
        return out

    parts = {}
    reset_counts(counters)
    compiles0 = tstate.COMPILES["compile_state"]
    t0 = time.perf_counter()
    jit_core.KKT_RECORD = [] if kkt else None
    member_block.TRACE_Z_RECORD = [] if trace_z else None
    try:
        states, _ss, stats = run()
    finally:
        solves, jit_core.KKT_RECORD = jit_core.KKT_RECORD, None
        fallback_rec, member_block.TRACE_Z_RECORD = member_block.TRACE_Z_RECORD, None
    seconds = time.perf_counter() - t0
    parts["sweep"] = seconds
    launches = read_counts(counters)
    compiles = tstate.COMPILES["compile_state"] - compiles0
    got = _stats_of(stats)
    n = problem.n_vertices
    rows = sample_rows(proto, n)
    sketches = [sketch(p, rows) for p in states.positions.detach().cpu().double().numpy()]
    if f64 is None:
        want, want_sketches, bound = fixture, fixture["positions"], F64_RTOL
        want_flags = {k: fixture[k] for k in ("step_success", "iterations")}
        stat_bound = bound if stat_bound is None else stat_bound
    else:
        want, want_sketches = f64["stats"], f64["sketches"]
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        want_flags = {k: fixture["float32_reference"][k] for k in ("step_success", "iterations")}
        stat_bound = bound
    devs = _stat_devs(got, want, FLOAT_STATS if f64 is None else f32_stats)
    pos_devs = [sketch_deviation(w, g) for w, g in zip(want_sketches, sketches)]
    flags_equal = _flags_equal(got, want_flags)

    # member m against a one-member sweep of member m, in bits; the launches of the
    # one-member sweep whose line searches scored the most trial states
    t1 = time.perf_counter()
    single_devs, not_bits, single_launches = [], {}, []
    for m in range(B):
        reset_counts(counters)
        s_states, _s, s_stats = run([m])
        single_launches.append(read_counts(counters))
        unequal = member_bits(states, stats, m, s_states, s_stats, 0)
        if unequal:
            not_bits[m] = unequal
        dev = max(_stat_devs(_stats_of(s_stats), {k: got[k][m:m + 1] for k in SWEEP_STATS}))
        scale = max(float(torch.max(torch.abs(states.positions[m]))), 1.0)
        dev = max(dev, float(torch.max(torch.abs(s_states.positions[0] - states.positions[m])))
                  / scale)
        single_devs.append(dev)
    reset_counts(counters)
    parts["one_member_sweeps"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    trials = np.asarray(stats.trials)
    widest = int(np.argmax(trials))
    launches_equal = launches == single_launches[widest]
    reset_counts(counters)
    run([widest] * B)
    copies_equal = read_counts(counters) == single_launches[widest]
    reset_counts(counters)

    digests = [sweep_digest(states, got)]
    r_states, _r, r_stats = run()
    digests.append(sweep_digest(r_states, _stats_of(r_stats)))
    parts["repeat"] = time.perf_counter() - t1
    accepted = int(np.sum(np.asarray(stats.accepted_steps)))
    say(label, members=B, vertices=n, steps=proto["steps"], seconds=f"{seconds:.3f}",
        energy=json.dumps(got["energy"].tolist()),
        reference_energy=json.dumps(list(want["energy"])),
        step_success=json.dumps(got["step_success"].tolist()),
        reference_step_success=json.dumps(list(want_flags["step_success"])),
        iterations=json.dumps(got["iterations"].tolist()),
        trials=json.dumps(trials.tolist()), accepted_member_steps=accepted,
        max_rel_dev=repr(max(devs)), max_position_dev=repr(max(pos_devs)), bound=repr(bound),
        stat_bound=repr(stat_bound),
        reference="the JAX fixture" if f64 is None else "the float64 phase",
        compiles_after_entry=compiles, launches=json.dumps(launches))
    say(label + " members", max_rel_dev_vs_single=repr(max(single_devs)),
        members_not_bits=json.dumps(not_bits), widest_member=widest,
        copies_launch_as_one_member=copies_equal,
        launches_equal_to_one_member=launches_equal,
        one_member_launches=json.dumps(single_launches[widest]))
    say(label + " determinism", first=digests[0], second=digests[1],
        equal=digests[0] == digests[1])

    def check():
        if not flags_equal:
            raise AssertionError(f"{label}: accept flags or iterations differ from the reference")
        if not (max(devs) <= stat_bound and max(pos_devs) <= bound):
            raise AssertionError(f"{label}: members deviate from the reference by {max(devs)!r} "
                                 f"(positions {max(pos_devs)!r}), bound {bound!r}")
        if not_bits:
            raise AssertionError(f"{label}: members are not their one-member sweeps' bits: "
                                 f"{not_bits} (largest deviations {single_devs})")
        if not copies_equal or (widest_launches and not launches_equal):
            raise AssertionError(f"{label}: the {B}-member sweep launched {launches} (copies of "
                                 f"member {widest} equal: {copies_equal}), the one-member sweep "
                                 f"of member {widest} {single_launches[widest]}")
        if digests[0] != digests[1]:
            raise AssertionError(f"{label}: two sweeps from one state differ: {digests}")
        if compiles != 0:
            raise AssertionError(f"{label}: {compiles} compile_state calls inside the sweep")

    return {"launches": launches, "stats": got, "sketches": sketches, "states": states,
            "digest": digests[0],
            "accepted": accepted, "member_accepted": np.asarray(stats.accepted_steps),
            "start": positions, "params": params,
            "parts": parts, "run": run, "check": check,
            "kkt": [tuple(t.cpu() for t in s) for s in solves or ()], "trials": trials,
            "fallbacks": np.asarray(stats.trace_z_fallbacks),
            "trace_z": [{"viable": [bool(v[m]) for live, v, _a in fallback_rec or () if live[m]],
                         "accepted": [bool(a[m]) for live, _v, a in fallback_rec or () if live[m]]}
                        for m in range(B)]}


def unmoved_members(torch, out: dict) -> list:
    """The members that accepted no step: each must end on its start positions, bit for bit."""
    idle = [m for m, a in enumerate(out["member_accepted"]) if a == 0]
    for m in idle:
        start = torch.as_tensor(out["start"][m], device=DEVICE)
        if not torch.equal(out["states"].positions[m].detach(), start):
            raise AssertionError(f"member {m} accepted no step but moved")
    return idle


def sweep_timing(torch, label: str, run, sizes, busy_members=None) -> tuple[dict, float | None]:
    """ms per sweep step and member-steps per second at each member count (a warm-up step,
    then SWEEP_TIMED_STEPS timed), and with ``busy_members`` the profiler's busy share there
    (over BUSY_STEPS steps)."""
    per_size = {}
    for b in sizes:
        run(range(b), steps=1)  # warm-up at this member count
        t0 = time.perf_counter()
        run(range(b), steps=SWEEP_TIMED_STEPS)
        wall = time.perf_counter() - t0
        per_size[b] = {"ms_per_step": wall * 1e3 / SWEEP_TIMED_STEPS,
                       "member_steps_per_s": b * SWEEP_TIMED_STEPS / wall}
    card = smi_line()
    for b, rec in per_size.items():
        say(label + " timing", members=b, ms_per_step=f"{rec['ms_per_step']:.3f}",
            member_steps_per_s=f"{rec['member_steps_per_s']:.3f}", card=repr(card))
    if busy_members is None:
        return per_size, None
    wall_ms, busy_ms = sweep_busy(torch, lambda: run(range(busy_members), steps=BUSY_STEPS))
    say(label + " busy", members=busy_members, steps=BUSY_STEPS,
        ms_per_step=f"{wall_ms:.3f}", busy_ms_per_step=f"{busy_ms:.3f}",
        busy_share=f"{busy_ms / wall_ms:.4f}", card=repr(card))
    return per_size, busy_ms / wall_ms


def sweep_result(torch, label: str, out: dict, sizes, busy_members, res: dict) -> dict:
    """``res`` with ``per_size`` and ``busy_share``, which ``sweep_timing`` fills at the quiet
    stage (:func:`quiet`)."""
    res.update(per_size=None, busy_share=None)

    def timing_lines():
        t0 = time.perf_counter()
        res["per_size"], res["busy_share"] = sweep_timing(torch, label, out["run"], sizes,
                                                          busy_members)
        say(label + " timing parts", timing_s=f"{time.perf_counter() - t0:.3f}")

    quiet(timing_lines)
    return res


def phase_sweep(torch, tk, vs, counters, label: str, fixture: dict, dtype, snap: dict,
                f64=None) -> dict:
    """The parameter sweep on kozlov L3: B = 8 members of phase 5's (4's) state, one card.

    ``snap``: the state phase 5 (phase 4 at float32) left after the
    protocol's five steps, restored into a fresh L3 minimizer.  The main run
    with the counts reset just before and read just after, then the checks
    of the module docstring's phases 33-34 and the timing lines.
    """
    proto = fixture["protocol"]
    name = str(dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    mn = build_lane(torch, proto["kozlov"], dtype)
    restore(mn, snap)
    problem = mn.problem()
    setup_s = time.perf_counter() - t0
    out = drive_sweep(torch, counters, label, fixture, dtype, problem, f64, widest_launches=True)
    parts = {"setup": setup_s, **out["parts"]}
    launches = out["launches"]

    t1 = time.perf_counter()
    pos, tilts = member_kernel_inputs(torch, out["states"], seed=29)
    errs = check_member_kernels(torch, tk, vs, problem.topo, pos, tilts, seed=31)
    parts["kernel_checks"] = time.perf_counter() - t1
    say(label + " parts", setup_s=f"{setup_s:.3f}",
        parts_s=json.dumps({k: round(v, 3) for k, v in parts.items()}))
    say(label + " kernels", **{k: repr(v) for k, v in errs.items()})
    missing = [k for k in SWEEP_EXPECT if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    out["check"]()
    res = {"launches": launches, "stats": out["stats"], "sketches": out["sketches"],
           "errs": errs, "timing": {}, "per_size": None, "busy_share": None,
           # what phases 53 and 58 place on a device list or rerun and hold against
           "problem": problem, "states": out["states"], "digest": out["digest"],
           "members": (out["params"], out["start"])}

    def timing_lines():
        t1 = time.perf_counter()
        if dtype == torch.float32:
            res["timing"] = measure_members(
                torch, member_rows(torch, tk, vs, problem.topo, pos, tilts), name)
        t2 = time.perf_counter()
        res["per_size"], res["busy_share"] = sweep_timing(
            torch, label, out["run"], SWEEP_SIZES,
            proto["members"] if dtype == torch.float32 else None)
        say(label + " timing parts", kernel_timing_s=f"{t2 - t1:.3f}",
            timing_s=f"{time.perf_counter() - t2:.3f}")
        for rec in res["timing"].values():
            say(label + " kernel timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                             for k, v in rec.items()})

    quiet(timing_lines)
    return res


# ----------------------------------------------------------------------
# phases 36-38: the sweep over the shape family
# ----------------------------------------------------------------------
VESICLE_SWEEP_FIXTURE = FIXTURES / "helfrich_cube_L5_sweep_f64_jax.json"
SQUARE_SWEEP_FIXTURE = FIXTURES / "square_to_circle_L1_sweep_f64_jax.json"
# the vesicle's member-axis kernels: the surface energy with its gradient
# and alone (the line search's trials), the curvature data both ways, the
# vertex sums (the volume rows and enforcement, the effective areas)
VESICLE_SWEEP_EXPECT = ("tri_kernels.surface_energy_members",
                        "tri_kernels.surface_energy_grad_members",
                        "tri_kernels.curvature_data_members",
                        "tri_kernels.curvature_data_bwd_members", "vertex_sum.vertex_sum_members")
# square_to_circle's: the surface energy both ways, the hard area's
# energy-and-gradient route (every enforcement pass), its vertex sums
SQUARE_SWEEP_EXPECT = ("tri_kernels.surface_energy_members",
                       "tri_kernels.surface_energy_grad_members",
                       "tri_kernels.surface_area_grad_members", "vertex_sum.vertex_sum_members")
SHAPE_SWEEP_SIZES = (1, 8, 32)  # phases 36-37
# phase 36's drift run: the members' volume tolerance, and its steps
DRIFT_TOL = 1e-9
DRIFT_STEPS = 3
AREA_TOL = 1e-10  # phase 38: each member's area vs its target, relative (the projection's 1e-12)


def vesicle_sweep_problem(torch, fixture: dict, dtype, snap: dict):
    """Phase 7's (6's) state after its five steps, in a fresh vesicle minimizer whose global
    parameters also hold the protocol's ``global_parameters``."""
    proto = fixture["protocol"]
    lane = dict(proto["vesicle"])
    lane["global_parameters"] = {**lane["global_parameters"], **proto["global_parameters"]}
    mn = build_lane(torch, lane, dtype)
    restore(mn, snap)
    return mn.problem()


def member_volumes(torch, states, topo):
    """(B, bodies) volumes of the members' positions."""
    from torch.func import vmap

    from membrane_solver_tpu_torch.device import geo as dgeo

    return vmap(lambda x: dgeo.body_volumes(x, topo.tri_rows, topo.tri_valid, topo.tri_body,
                                            topo.body_valid.shape[0]))(states.positions)


def phase_vesicle_sweep(torch, counters, label: str, fixture: dict, dtype, snap: dict,
                        f64=None) -> dict:
    """The parameter sweep on the Helfrich vesicle at L5 (phases 36-37).

    ``drive_sweep``'s checks, at least one accepted member-step (the
    fixture's too), no single-member launch, the final volume of every
    member that accepted a step within the lane's ``volume_tolerance`` of
    its target (:func:`unmoved_members` holds the others on their starts),
    at float64 :func:`check_drift`, then the timing lines at 1, 8 and 32
    members and the busy share at 8.
    """
    t0 = time.perf_counter()
    problem = vesicle_sweep_problem(torch, fixture, dtype, snap)
    setup_s = time.perf_counter() - t0
    f32_ref = fixture["float32_reference"]
    out = drive_sweep(torch, counters, label, fixture, dtype, problem, f64)
    launches = out["launches"]
    topo = problem.topo
    idle = unmoved_members(torch, out)
    stepped = torch.as_tensor([m not in idle for m in range(len(out["member_accepted"]))],
                              device=DEVICE)
    vols = member_volumes(torch, out["states"], topo)
    active = (topo.body_valid & topo.body_has_target)
    target = topo.body_target_volume
    rel = torch.where(active, torch.abs(vols - target) / torch.clamp(torch.abs(target), min=1.0),
                      0.0)
    vol_dev = float(torch.max(torch.where(stepped[:, None], rel, 0.0)))
    vol_tol = float(problem.params["volume_tolerance"])
    want_accepted = (fixture if f64 is None else f32_ref)["accepted_last_step"]
    t1 = time.perf_counter()
    if f64 is None:
        check_drift(torch, label, fixture, problem, float(snap["step_size"]))
    parts = {"setup": setup_s, **out["parts"], "drift": time.perf_counter() - t1}
    say(label + " volumes", max_rel_volume_dev=repr(vol_dev), volume_tolerance=repr(vol_tol),
        accepted_per_member=json.dumps(out["member_accepted"].tolist()),
        unmoved_members=json.dumps(idle),
        accepted_member_steps=out["accepted"], reference_accepted_last_steps=want_accepted,
        parts_s=json.dumps({k: round(v, 3) for k, v in parts.items()}))
    missing = [k for k in VESICLE_SWEEP_EXPECT if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    single = {k: n for k, n in launches.items() if not k.endswith("_members") and n}
    if single:
        raise AssertionError(f"{label}: the sweep launched single-member kernels: {single}")
    out["check"]()
    if not (out["accepted"] > 0 and want_accepted > 0):
        raise AssertionError(f"{label}: no accepted member-step ({out['accepted']}, the "
                             f"reference {want_accepted})")
    if not vol_dev <= vol_tol:
        raise AssertionError(f"{label}: a member's volume is {vol_dev!r} off its target")
    return sweep_result(torch, label, out, SHAPE_SWEEP_SIZES, fixture["protocol"]["members"],
                        {"launches": launches, "stats": out["stats"],
                         "sketches": out["sketches"], "problem": problem,
                         "digest": out["digest"]})


def check_drift(torch, label: str, fixture: dict, problem, step_size: float) -> dict:
    """The volume drift check's projection on the card (phase 36).

    The protocol's members on the lane's own state (no dilation), their
    ``volume_tolerance`` at ``DRIFT_TOL``, ``DRIFT_STEPS`` steps at the
    lane's own step size after its five steps (``step_size``) without the
    per-trial enforcement, once with ``volume_drift_check`` and once
    without: without it an accepted step leaves the volume off by more than
    the tolerance, with it every member that stepped ends within it.
    """
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    proto = fixture["protocol"]
    x = problem.state.positions.detach().cpu().numpy()
    params = [{**p, "volume_tolerance": DRIFT_TOL}
              for p in sweep_members(proto, x, problem.params)[0]]
    topo = problem.topo
    active = topo.body_valid & topo.body_has_target
    target = topo.body_target_volume
    out = {}
    for on in (False, True):
        states, _ss, stats = run_sweep(problem, params, DRIFT_STEPS, step_size=step_size,
                                       options=MinimizeOptions(volume_drift_check=on),
                                       member_positions=[x] * len(params))
        stepped = torch.as_tensor(np.asarray(stats.accepted_steps) > 0, device=DEVICE)
        rel = torch.abs(member_volumes(torch, states, topo) - target) / torch.clamp(
            torch.abs(target), min=1.0)
        rel = torch.where(stepped[:, None] & active, rel, 0.0)
        out["on" if on else "off"] = (float(torch.max(rel)), int(stepped.sum()))
    say(label + " drift", tolerance=DRIFT_TOL, steps=DRIFT_STEPS, step_size=repr(step_size),
        max_rel_volume_dev_without=repr(out["off"][0]), stepped_without=out["off"][1],
        max_rel_volume_dev_with=repr(out["on"][0]), stepped_with=out["on"][1])
    if not (out["off"][1] > 0 and out["on"][1] > 0 and out["off"][0] > DRIFT_TOL
            and out["on"][0] <= DRIFT_TOL):
        raise AssertionError(f"{label}: the drift check did not project as it should: {out}")
    return out


def check_area_route(torch, tk, label: str, states, topo) -> dict:
    """The area constraints' energy-and-gradient call under ``vmap`` on the members' states:
    against its member twin (phase 3's bounds) and, member by member, the single call's bits."""
    from torch.func import vmap

    pos = states.positions.detach().contiguous()
    dtype = pos.dtype
    name = str(dtype).removeprefix("torch.")
    csr = topo.corner_csr()
    unit = torch.ones_like(topo.tri_surface_tension).to(dtype)
    ws = tk.workspace(topo, pos[0])
    before = tk.LAUNCHES["surface_area_grad_members"]
    area, grad = vmap(lambda x: tk.surface_energy_and_gradient(
        x, topo.tri_rows, topo.tri_valid, unit, csr, ws))(pos)
    launched = tk.LAUNCHES["surface_area_grad_members"] - before
    want_a, want_g = tk.surface_energy_members_reference(pos, topo.tri_rows, topo.tri_valid, unit,
                                                         csr, True)
    errs = {"surface_area_members": 0.0, "surface_area_grad_members": 0.0}
    for m in range(pos.shape[0]):
        errs["surface_area_members"] = max(errs["surface_area_members"], _sum_check(
            torch, f"{label} area {m} ({name})", area[m], want_a[m], WC_ENERGY[name]))
        errs["surface_area_grad_members"] = max(errs["surface_area_grad_members"], _sum_check(
            torch, f"{label} area gradient {m} ({name})", grad[m], want_g[m],
            WC_SURFACE_GRAD[name]))
        a1, g1 = tk.surface_energy_and_gradient(pos[m], topo.tri_rows, topo.tri_valid, unit, csr,
                                                ws)
        if not (torch.equal(area[m], a1.reshape(())) and torch.equal(grad[m], g1)):
            raise AssertionError(f"{label}: the area route's member {m} differs from the single "
                                 "call")
    if launched != 1:
        raise AssertionError(f"{label}: the area route took {launched} member launches, not 1")
    say(label + " area route", launches=launched, **{k: repr(v) for k, v in errs.items()})
    return errs


def area_rows(torch, tk, topo, pos) -> list:
    """(name, kind, fn, inputs, flops) of the area route's member launch (unit tension) and its twin."""
    B, T = pos.shape[0], topo.tri_rows.shape[0]
    rows, v, csr = topo.tri_rows, topo.tri_valid, topo.corner_csr()
    unit = torch.ones(T, dtype=pos.dtype, device=DEVICE)
    ws = tk.MemberWorkspace(B, T, pos.dtype, DEVICE)
    flops = (FLOPS_PER_TRI["surface_energy"] + FLOPS_PER_TRI["surface_grad"]) * T * B
    inputs = (pos, rows, v, unit)
    return [
        ("surface_area_grad_members", "kernel", lambda: tk.launch_surface_energy_members(
            pos, rows, v, unit, csr, ws, True, "surface_area_grad_members"), inputs, flops),
        ("surface_area_grad_members", "twin", lambda: tk.surface_energy_members_reference(
            pos, rows, v, unit, csr, True), inputs, flops),
    ]


def phase_square_sweep(torch, tk, counters, label: str, fixture: dict, mn, snap: dict) -> dict:
    """The parameter sweep on square_to_circle L1 from phase 12's post-recipe state (phase 38).

    ``drive_sweep``'s checks; the hard area's member route launched and no
    plain twin called (:func:`counted_twins`); the area of every member that accepted a step
    at its target; then the
    route against its twin and the single call on the members' final states.
    """
    t0 = time.perf_counter()
    restore(mn, snap)
    problem = mn.problem()
    setup_s = time.perf_counter() - t0
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins:
        out = drive_sweep(torch, counters, label, fixture, torch.float64, problem)
    twin_calls = {k: n for k, n in twins.items() if n}
    launches = out["launches"]
    topo = problem.topo
    targets = torch.as_tensor([p["target_surface_area"] for p in sweep_members(
        fixture["protocol"], problem.state.positions.cpu().numpy(), problem.params)[0]],
        dtype=torch.float64, device=DEVICE)
    from torch.func import vmap

    from membrane_solver_tpu_torch.device import geo as dgeo

    areas = vmap(lambda x: torch.sum(dgeo.triangle_geometry(x, topo.tri_rows,
                                                            topo.tri_valid).area))(
        out["states"].positions)
    idle = unmoved_members(torch, out)
    area_dev = max((float(torch.abs(areas[m] - targets[m]) / targets[m])
                    for m in range(len(targets)) if m not in idle), default=0.0)
    errs = check_area_route(torch, tk, label, out["states"], topo)
    say(label + " areas", max_rel_area_dev=repr(area_dev), bound=AREA_TOL,
        accepted_per_member=json.dumps(out["member_accepted"].tolist()),
        unmoved_members=json.dumps(idle),
        twin_calls_in_sweep=json.dumps(twin_calls), setup_s=f"{setup_s:.3f}",
        parts_s=json.dumps({k: round(v, 3) for k, v in out["parts"].items()}))
    missing = [k for k in SQUARE_SWEEP_EXPECT if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    single = {k: n for k, n in launches.items() if not k.endswith("_members") and n}
    if single or twin_calls:
        raise AssertionError(f"{label}: single-member launches {single}, twin calls "
                             f"{twin_calls}")
    out["check"]()
    if not area_dev <= AREA_TOL:
        raise AssertionError(f"{label}: a member's area is {area_dev!r} off its target")
    res = {"launches": launches, "stats": out["stats"], "errs": errs, "timing": {}}
    pos = out["states"].positions.detach().contiguous()

    def timing_lines():
        res["timing"] = measure_members(torch, area_rows(torch, tk, topo, pos), "float64")
        for rec in res["timing"].values():
            say(label + " kernel timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                             for k, v in rec.items()})

    quiet(timing_lines)
    return res


# ----------------------------------------------------------------------
# phases 39-41: the sweep over the leaflet tilt-field family
# ----------------------------------------------------------------------
RECT_SWEEP_FIXTURE = FIXTURES / "rect_tilt_source_L0_sweep_f64_jax.json"
TILT_SWEEP_FIXTURE = FIXTURES / "kozlov_L3_sweep_tilt_drives_f64_jax.json"
TILT_FIELDS = ("positions", "tilts", "tilts_in", "tilts_out")


def sweep_tilt_setup(mesh, protocol: dict, setup: str) -> None:
    """Phase 41's host mesh (either package's): phase 20's drives or phase 21's match drives.

    ``setup`` "drives": :func:`drives_setup` with ``protocol["drives"]``;
    "match": :func:`match_drives_setup` with ``protocol["match"]``, then the
    ``single_field_parameters`` and the single-field modules (``tilt``,
    ``tilt_smoothness``) added, so that they compile on the same mesh.
    """
    if setup == "drives":
        drives_setup(mesh, protocol["drives"])
        return
    match_drives_setup(mesh, protocol["match"])
    mesh.global_parameters.update(protocol["single_field_parameters"])
    mesh.energy_modules.extend(m for m in protocol["energies"]["match"]
                               if m not in mesh.energy_modules)


def tilt_base_inputs(protocol: dict, setup: str, n: int) -> dict:
    """The set-up's inputs: the fields its fixture (phase 20's or 25's) recorded; tilts 0 else."""
    rec = json.loads((FIXTURES / protocol["inputs"][setup]).read_text())
    return {f: decode_rows(rec["inputs"][f], n) if f in rec["inputs"] else np.zeros((n, 3))
            for f in TILT_FIELDS}


def tilt_member_inputs(protocol: dict, base: dict) -> list:
    """Per member m, ``base`` (field -> (n, 3) float64) plus seeded offsets.

    ``numpy.random.default_rng(member_seed + m)``, in ``TILT_FIELDS`` order:
    ``z_scale`` normals on the positions' z, ``tilt_scale`` normals on every
    tilt field, on every row.
    """
    out = []
    for m in range(protocol["members"]):
        rng = np.random.default_rng(protocol["member_seed"] + m)
        rec = {}
        for f in TILT_FIELDS:
            a = np.array(base[f], dtype=np.float64)
            if f == "positions":
                a[:, 2] += protocol["z_scale"] * rng.standard_normal(a.shape[0])
            else:
                a += protocol["tilt_scale"] * rng.standard_normal(a.shape)
            rec[f] = a
        out.append(rec)
    return out


def pack_rows(arr, rows) -> dict:
    """An (n, 3) array for a fixture: its nonzero rows (:func:`encode_rows`) where they are
    no more than the sample's, else its :func:`sketch`."""
    arr = np.asarray(arr, dtype=np.float64)
    if int(np.count_nonzero(np.any(arr != 0.0, axis=1))) <= len(rows):
        return encode_rows(arr)
    return sketch(arr, rows)


def packed_deviation(want: dict, arr, rows) -> float:
    """Largest error of the dense (n, 3) ``arr`` against a :func:`pack_rows` record, over the
    record's largest entry (absolute where that is 0)."""
    arr = np.asarray(arr, dtype=np.float64)
    if "rows" in want:
        w = decode_rows(want, arr.shape[0])
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(arr - w)))
        return err / scale if scale > 0 else err
    return sketch_deviation(want, sketch(arr, rows))


def relative_error(got, want) -> float:
    """max |got - want| over max |want| (absolute where ``want`` is 0); scalars or arrays."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    return err / scale if scale > 0 else err


# the member twins of the kernels on phases 39-41's paths, and the single
# entries' twins: on the card none may be called (no fallback hides a launch)
TWINS = {"tri_kernels": ("surface_energy_reference", "curvature_data_reference",
                         "curvature_data_vjp_reference", "p1_div_vjp_reference",
                         "surface_energy_members_reference", "curvature_data_members_reference",
                         "curvature_data_vjp_members_reference",
                         "p1_divergence_members_reference", "p1_div_vjp_members_reference"),
         "vertex_sum": ("reference", "members_reference")}
# the rect sweep's member-axis kernels: the surface energy with its gradient
# and alone, the smoothness cotangents (curvature data, frozen positions:
# no backward), the vertex sums (the tilt energy's areas, the normals of the
# single-field tangent re-projection)
RECT_SWEEP_EXPECT = ("tri_kernels.surface_energy_members",
                     "tri_kernels.surface_energy_grad_members",
                     "tri_kernels.curvature_data_members", "vertex_sum.vertex_sum_members")
RECT_SWEEP_SIZES = (1, 8)  # phases 39-40
# phase 41: the member-axis kernel each module must launch under vmap
# (``mean_curvature_tilt`` is the reference's inert stub: no kernel)
TILT_DRIVES_EXPECT = {
    "tilt_splay_twist_in": ("p1_div_members",),
    "tilt_smoothness_in": ("curvature_data_members",),
    "tilt_smoothness_out": ("curvature_data_members",),
    "tilt_smoothness_leaflet": ("curvature_data_members",),
    "tilt_smoothness": ("curvature_data_members",),
    "bending_tilt": ("curvature_data_members", "p1_div_members"),
}
TILT_MEMBER_KEYS = ("curvature_data_members", "curvature_data_bwd_members", "p1_div_members",
                    "p1_div_bwd_members")


@contextlib.contextmanager
def counted_twins(modules: dict):
    """Count the calls of every plain twin in ``TWINS`` while the block runs: {name: calls}."""
    counts, saved = {}, []
    for mod_name, names in TWINS.items():
        mod = modules[mod_name]
        for name in names:
            fn = getattr(mod, name)
            key = f"{mod_name}.{name}"
            counts[key] = 0

            def wrapped(*args, _fn=fn, _key=key, **kw):
                counts[_key] += 1
                return _fn(*args, **kw)

            setattr(mod, name, wrapped)
            saved.append((mod, name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_rect_sweep(torch, tk, vs, counters, label: str, fixture: dict, dtype,
                     f64=None) -> dict:
    """The tilt-decay sweep on rect_tilt_source L0 (phases 39-40).

    The lane's command list with ``tilt_smoothness_rigidity`` 1.0 set
    before it (the fixture's ``rect_tilt_source`` protocol): per command the
    energy against the fixture's ``lane_energies`` (float64) or the float64
    phase's (float32).  Then ``drive_sweep``'s checks on the state it
    leaves; at least one accepted member-step (the fixture's too); no
    single-member launch and no twin call inside the sweep; every member's
    tilts after the sweep equal to the start's bit for bit (no relax, no
    per-trial enforcement, and the flat sheet's tangent re-projection
    changes no bit); then ms per sweep step at B = 1 and 8 and the busy
    share at 8.
    """
    from membrane_solver_tpu_torch.commands import execute_command_line

    proto = fixture["protocol"]
    f32_ref = fixture["float32_reference"]
    t0 = time.perf_counter()
    ctx = cli_context(torch, proto["rect_tilt_source"], dtype)
    lane = []
    for cmd in proto["rect_tilt_source"]["commands"]:
        execute_command_line(ctx, cmd)
        ctx.sync_mesh()
        lane.append(float(ctx.minimizer.compute_energy()))
    setup_s = time.perf_counter() - t0
    if f64 is None:
        lane_want, lane_bound = fixture["lane_energies"], F64_RTOL
    else:
        lane_want = f64["lane"]
        lane_bound = max(F32_RTOL, 2 * f32_ref["max_rel_dev_vs_float64"])
    lane_dev = max(abs(a - b) / abs(b) for a, b in zip(lane, lane_want, strict=True))
    problem = ctx.minimizer.problem()
    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins:
        out = drive_sweep(torch, counters, label, fixture, dtype, problem, f64)
    launches = out["launches"]
    states = out["states"]
    tilts_equal = all(torch.equal(getattr(states, f),
                                  getattr(problem.state, f).expand_as(getattr(states, f)))
                      for f in ("tilts", "tilts_in", "tilts_out"))
    want_accepted = (fixture if f64 is None else f32_ref)["accepted_last_step"]
    parts = {"setup": setup_s, **out["parts"]}
    say(label + " lane", energies=json.dumps(lane), reference=json.dumps(lane_want),
        max_rel_dev=repr(lane_dev), bound=repr(lane_bound),
        tilts_equal_to_start=tilts_equal,
        accepted_per_member=json.dumps(out["member_accepted"].tolist()),
        accepted_member_steps=out["accepted"], reference_accepted_last_steps=want_accepted,
        twin_calls=json.dumps({k: v for k, v in twins.items() if v}),
        parts_s=json.dumps({k: round(v, 3) for k, v in parts.items()}))
    if not lane_dev <= lane_bound:
        raise AssertionError(f"{label}: the lane's energies deviate by {lane_dev!r}")
    missing = [k for k in RECT_SWEEP_EXPECT if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    single = {k: n for k, n in launches.items() if not k.endswith("_members") and n}
    if single or any(twins.values()):
        raise AssertionError(f"{label}: single-member launches {single}, twin calls "
                             f"{ {k: v for k, v in twins.items() if v} }")
    out["check"]()
    if not (out["accepted"] > 0 and want_accepted > 0):
        raise AssertionError(f"{label}: no accepted member-step ({out['accepted']}, the "
                             f"reference {want_accepted})")
    if not tilts_equal:
        raise AssertionError(f"{label}: the sweep changed the members' tilts")
    return sweep_result(torch, label, out, RECT_SWEEP_SIZES, proto["members"],
                        {"launches": launches, "stats": out["stats"],
                         "sketches": out["sketches"], "lane": lane})


def tilt_problems(torch, protocol: dict, setup: str):
    """Phase 41's problems of one set-up on the card, float64 and float32 from one host mesh,
    on its fixture's inputs: (p64, p32, base inputs, the lane's own inputs' largest
    deviation from them)."""
    from membrane_solver_tpu_torch import Minimizer

    mesh = build_lane(torch, protocol[setup]["kozlov"], torch.float64).mesh
    sweep_tilt_setup(mesh, protocol, setup)
    p64, p32 = (Minimizer(mesh, device=DEVICE, dtype=dtype, quiet=True).problem()
                for dtype in (torch.float64, torch.float32))
    base = tilt_base_inputs(protocol, setup, p64.n_vertices)
    dev = max(float(np.max(np.abs(getattr(p64.state, f).detach().cpu().numpy() - base[f])))
              for f in TILT_FIELDS if f != "tilts")
    return p64, p32, base, dev


def tilt_items(torch, p, protocol: dict, setup: str, members: list, counters=None) -> dict:
    """Every item of phase 41 on ``p``: under ``vmap`` over the members (``members[m]``: field
    -> (n, 3) float64) and member by member.

    Per energy module (``energy/NAME``): (B,) energies and per field (B, n, 3)
    gradients, as ``make_member_energy_and_grad`` takes them (autograd
    through the map); per constraint and mode the tilt rows and the
    enforcement's tilt changes.  Returns ``{"vmapped": {item: array},
    "single": {item: [array per member]}, "launches": {module: counts}}``,
    arrays on the host in float64; with ``counters``, each module's
    member-axis launches in its vmapped evaluation (and its single-entry
    launches there, ``single_in_map``).
    """
    from torch.func import vmap

    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.device import geo as dgeo
    from membrane_solver_tpu_torch.device.state import MeshState
    from membrane_solver_tpu_torch.energy import get_module

    dtype, topo, params = p.state.positions.dtype, p.topo, p.params
    host = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    stacked = {f: torch.as_tensor(np.stack([m[f] for m in members]), dtype=dtype, device=DEVICE)
               for f in TILT_FIELDS}
    B = len(members)
    out = {"vmapped": {}, "single": {}, "launches": {}}
    for name in protocol["energies"][setup]:
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fn = maker(p.spec) if maker is not None else module.energy

        def energy(*fields, fn=fn):
            st = MeshState(*fields)
            return fn(dgeo.triangle_geometry(st.positions, topo.tri_rows, topo.tri_valid), st,
                      topo, params)

        def value_and_grads(leaves, e):
            grads = (torch.autograd.grad(e.sum(), leaves, allow_unused=True) if e.requires_grad
                     else [None] * len(leaves))
            return [host(e)] + [np.zeros(tuple(x.shape)) if g is None else host(g)
                                for g, x in zip(grads, leaves)]

        before = read_counts(counters) if counters else None
        leaves = [stacked[f].clone().requires_grad_(True) for f in TILT_FIELDS]
        got = value_and_grads(leaves, vmap(energy)(*leaves))
        if counters:
            torch.cuda.synchronize()
            after = read_counts(counters)
            diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            out["launches"][name] = {
                **{k: diff.get(f"tri_kernels.{k}", 0) for k in TILT_MEMBER_KEYS},
                "single_in_map": {k: v for k, v in diff.items() if not k.endswith("_members")}}
        singles = []
        for m in range(B):
            one = [stacked[f][m].clone().requires_grad_(True) for f in TILT_FIELDS]
            singles.append(value_and_grads(one, energy(*one)))
        out["vmapped"][f"energy/{name}"] = got[0]
        out["single"][f"energy/{name}"] = [s[0] for s in singles]
        for i, f in enumerate(TILT_FIELDS, start=1):
            out["vmapped"][f"energy/{name}/{f}"] = got[i]
            out["single"][f"energy/{name}/{f}"] = [s[i] for s in singles]
    if setup != "match":
        return out
    states = MeshState(*(stacked[f] for f in TILT_FIELDS))
    with torch.no_grad():
        for name, (_key, modes) in protocol["constraints"].items():
            mod = get_constraint(name)
            for mode in modes:
                spec = static_variant(p.spec, f"constraint:{name}", mode)
                rows_fn, enforce = mod.make_tilt_constraint_rows(spec), mod.make_enforce_tilts(spec)
                key = f"constraint/{name}/{mode}"
                rows = vmap(lambda st: rows_fn(st, topo, params))(states)
                moved = vmap(lambda st: enforce(st, topo, params))(states)
                out["vmapped"][key + "/rows"] = host(rows)
                for f in ("tilts_in", "tilts_out"):
                    out["vmapped"][f"{key}/{f}"] = host(getattr(moved, f) - getattr(states, f))
                one_rows, one_moved = [], {"tilts_in": [], "tilts_out": []}
                for m in range(B):
                    st = MeshState(*(stacked[f][m] for f in TILT_FIELDS))
                    one_rows.append(host(rows_fn(st, topo, params)))
                    o1 = enforce(st, topo, params)
                    for f in one_moved:
                        one_moved[f].append(host(getattr(o1, f) - getattr(st, f)))
                out["single"][key + "/rows"] = one_rows
                for f in one_moved:
                    out["single"][f"{key}/{f}"] = one_moved[f]
    return out


def tilt_item_deviation(want, got, rows) -> float:
    """Largest deviation of a (B, ...) item from its fixture record (``pack_rows`` per member)."""
    got = np.asarray(got)
    if got.ndim == 1:
        return max(relative_error(g, w) for g, w in zip(got, want, strict=True))
    if got.ndim == 3:
        return max(packed_deviation(w, g, rows) for g, w in zip(got, want, strict=True))
    return max(packed_deviation(w[k][leaf], g[k, leaf], rows)
               for g, w in zip(got, want, strict=True)
               for k in range(g.shape[0]) for leaf in range(2))


def phase_tilt_drives(torch, tk, vs, counters, label: str, fixture: dict) -> dict:
    """The leaflet tilt-field family over a member axis on kozlov L3 (phase 41).

    Phase 20's and phase 21's set-ups (:func:`sweep_tilt_setup`) on their
    fixtures' inputs (the lane's own, built on the card, within 1e-12 of
    them), B members with seeded offsets (:func:`tilt_member_inputs`); every
    item of :func:`tilt_items` at float64 against the JAX package's
    ``jax.vmap`` (rel 1e-10; gradients of max|g|); member m of the map
    equal in bits to member m's single call (every sum on a member's path
    adds in an order that does not depend on the batch,
    ``device/reduce.tree_sum``); the same items at float32 against float64
    within max(2e-3, 2 x the JAX package's own float32 deviation per
    item).  The member-axis kernels of ``TILT_DRIVES_EXPECT``
    launch inside each module's map, no single-entry launch and no twin
    call there.
    """
    proto = fixture["protocol"]
    f32_ref = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    rows = None
    failed, rec_launches, per_item = [], {}, {}
    seconds = {}
    reset_counts(counters)
    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins:
        for setup in ("drives", "match"):
            t0 = time.perf_counter()
            p64, p32, base, input_dev = tilt_problems(torch, proto, setup)
            seconds[f"{setup}_setup"] = time.perf_counter() - t0
            if not input_dev <= 1e-12 * max(float(np.max(np.abs(base["positions"]))), 1.0):
                failed.append(f"{setup}: the lane's inputs lie {input_dev!r} off the fixture's")
            rows = sample_rows(proto, p64.n_vertices)
            members = tilt_member_inputs(proto, base)
            t0 = time.perf_counter()
            v64 = tilt_items(torch, p64, proto, setup, members, counters)
            seconds[f"{setup}_f64"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            v32 = tilt_items(torch, p32, proto, setup, members)
            seconds[f"{setup}_f32"] = time.perf_counter() - t0
            rec_launches.update(v64["launches"])
            for item, got in v64["vmapped"].items():
                dev = tilt_item_deviation(fixture["items"][item], got, rows)
                exact, off = 0, 0.0
                for m, one in enumerate(v64["single"][item]):
                    if np.array_equal(got[m], one):
                        exact += 1
                    else:
                        off = max(off, relative_error(got[m], one))
                dev32 = relative_error(v32["vmapped"][item], got)
                bound32 = max(F32_RTOL, 2 * f32_ref[item])
                per_item[item] = {"dev_f64": dev, "members_equal_bits": exact,
                                  "member_dev": off, "dev_f32": dev32, "bound_f32": bound32}
                say(label + " item", item=item, dev_f64=repr(dev),
                    members_equal_bits=f"{exact}/{len(members)}", member_dev=repr(off),
                    dev_f32=repr(dev32), bound_f32=repr(bound32))
                if not dev <= DRIVES_F64_RTOL:
                    failed.append(f"{item} float64 {dev!r}")
                if exact != len(members):
                    failed.append(f"{item}: {len(members) - exact} members differ from their "
                                  f"single calls (by {off!r})")
                if not dev32 <= bound32:
                    failed.append(f"{item} float32 {dev32!r} bound {bound32!r}")
    launches = read_counts(counters)
    for name, rec in rec_launches.items():
        say(label + " launches", module=name, **{k: json.dumps(v) for k, v in rec.items()})
        want = TILT_DRIVES_EXPECT.get(name, ())
        if not all(rec[k] > 0 for k in want):
            failed.append(f"{name} did not launch {want}: {rec}")
        if rec["single_in_map"]:
            failed.append(f"{name} launched single entries inside the map: "
                          f"{rec['single_in_map']}")
    calls = {k: v for k, v in twins.items() if v}
    if calls:
        failed.append(f"twin calls {calls}")
    say(label, members=proto["members"], vertices=fixture["n_vertices"],
        triangles=fixture["n_triangles"], items=len(per_item),
        items_all_bits_equal=sum(1 for r in per_item.values()
                                 if r["members_equal_bits"] == proto["members"]),
        seconds_s=json.dumps({k: round(v, 3) for k, v in seconds.items()}),
        launches=json.dumps(launches))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "items": per_item}


# ----------------------------------------------------------------------
# phases 42-47: the local-interface family and the rigid disk in the sweep,
# and the visualization's face values
# ----------------------------------------------------------------------
INTERFACE_SWEEP_FIXTURE = FIXTURES / "kozlov_L3_interface_sweep_f64_jax.json"
FREE_DISK_SWEEP_FIXTURE = FIXTURES / "kozlov_L3_free_disk_sweep_f64_jax.json"
INTERFACE_DRIVES_FIXTURE = FIXTURES / "kozlov_L3_sweep_interface_drives_f64_jax.json"
# the viz colour modes of phase 47: the divergence modes (kernel 4) and the tilt modes
VIZ_MODES = ("div_in", "div_out", "divergence", "tilt_in", "tilt_out", "tilt_bilayer")
VIZ_CPU_RTOL = 1e-12  # phase 47: the card's float64 face values vs the CPU's, of their max


def interface_drives_setup(mesh, protocol: dict) -> None:
    """Phase 46's host mesh (either package's): phase 25's set-up (:func:`match_drives_setup`
    with ``protocol["match"]``), then the law's strength and the law energy and the hard
    interface constraint added."""
    match_drives_setup(mesh, protocol["match"])
    mesh.global_parameters.update(protocol["global_parameters"])
    mesh.energy_modules.extend(m for m in protocol["extra_energy_modules"]
                               if m not in mesh.energy_modules)
    mesh.constraint_modules.extend(m for m in protocol["extra_constraint_modules"]
                                   if m not in mesh.constraint_modules)


def interface_problems(minimizer, mesh, protocol: dict, **kw) -> dict:
    """{None: the problem of every module but the match's other mode, mode: the problem
    compiled with each ``curved_local_interface_match`` mode} (:func:`match_problems`)."""
    problems = match_problems(minimizer, mesh, protocol["match"], **kw)
    return {None: next(iter(problems.values())), **problems}


def pad_compact(vals, n: int):
    """Compact rows' values (B, K, 2, 3) as (B, max(n, 2K), 3): their 2K rows zero-padded to at
    least the vertex count n, so that they pack like a vertex array (``pack_rows``)."""
    vals = np.asarray(vals, dtype=np.float64)
    flat = vals.reshape(vals.shape[0], -1, 3)
    return np.concatenate([flat, np.zeros((flat.shape[0], max(n - flat.shape[1], 0), 3))],
                          axis=1)


def mapped_items(torch, out: dict, key: str, fn, q, states, singles: list, post,
                 counters=None) -> None:
    """``fn(state, topo, params)`` on problem ``q``, under ``vmap`` over ``states`` and on each
    state of ``singles``: the arrays of ``post(result, state, single=...)`` into ``out``
    (:func:`tilt_items`' form) under ``key``; with ``counters``, the single-entry launches
    inside the map.  The ordered rows' levels are built first
    (``member_block.prime_ordered_levels``), as the sweep builds them."""
    from torch.func import vmap

    from membrane_solver_tpu_torch.parallel.member_block import prime_ordered_levels

    prime_ordered_levels(q.spec, q.topo)
    before = read_counts(counters) if counters else None
    got = post(vmap(lambda st: fn(st, q.topo, q.params))(states), states)
    if counters:
        torch.cuda.synchronize()
        after = read_counts(counters)
        out["launches"].setdefault(key, {"single_in_map": {}})["single_in_map"].update(
            {k: after[k] - before[k] for k in after
             if after[k] != before[k] and not k.endswith("_members")})
    one = [post(fn(st, q.topo, q.params), st, single=True) for st in singles]
    for item in got:
        out["vmapped"][f"{key}/{item}"] = got[item]
        out["single"][f"{key}/{item}"] = [o[item] for o in one]


def interface_items(torch, problems: dict, protocol: dict, members: list, counters=None) -> dict:
    """Every item of phase 46 on ``problems`` (:func:`interface_problems`): under ``vmap`` over
    the members and member by member, as :func:`tilt_items` takes them.

    The two interface energies' values and gradients; the hard and the match
    constraint's tilt rows and enforcement per mode; the rigid disk's compact
    rows (:func:`_pad_compact`) and the position change of its enforcement.
    Before the maps, the ordered rows' levels are built
    (``member_block.prime_ordered_levels``), as the sweep builds them.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.device.state import MeshState

    p = problems[None]
    dtype, n = p.state.positions.dtype, p.n_vertices
    host = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    stacked = {f: torch.as_tensor(np.stack([m[f] for m in members]), dtype=dtype, device=DEVICE)
               for f in TILT_FIELDS}
    sub = {"energies": {"drives": protocol["energies"]}}
    out = tilt_items(torch, p, sub, "drives", members, counters)
    B = len(members)
    states = MeshState(*(stacked[f] for f in TILT_FIELDS))
    singles = [MeshState(*(stacked[f][m] for f in TILT_FIELDS)) for m in range(B)]

    def mapped(key, fn, q, post):
        mapped_items(torch, out, key, fn, q, states, singles, post, counters)

    def tilt_changes(moved, st, single=False):
        return {f: host(getattr(moved, f) - getattr(st, f)) for f in ("tilts_in", "tilts_out")}

    with torch.no_grad():
        for name in protocol["constraints"]:
            mod = get_constraint(name)
            for mode, q in problems.items():
                if (mode is None) == (name == "curved_local_interface_match"):
                    continue
                key = f"constraint/{name}/{mode or '-'}"
                mapped(key, mod.make_tilt_constraint_rows(q.spec), q,
                       lambda rows, _st, single=False: {"rows": host(rows)})
                mapped(key, mod.make_enforce_tilts(q.spec), q, tilt_changes)
        rigid = get_constraint("rigid_disk")
        mapped("constraint/rigid_disk/-", rigid.make_compact_constraint_rows(p.spec), p,
               lambda rows, _st, single=False: {"rows": (pad_compact(host(rows[0])[None], n)[0]
                                                         if single else
                                                         pad_compact(host(rows[0]), n))})
        mapped("constraint/rigid_disk/-", rigid.make_enforce(p.spec), p,
               lambda moved, st, single=False: {"positions": host(moved.positions
                                                                  - st.positions)})
    return out


def ordered_levels(topo) -> dict:
    """{key: levels} of the ``state.ordered_index_add`` calls kept with ``topo``."""
    store = topo.__dict__.get("_kept")
    if store is None:
        return {}
    return {k[1]: len(v) for k, v in store[1].items()
            if isinstance(k, tuple) and k[0] == "ordered_index_add"}


@contextlib.contextmanager
def counted_level_builds():
    """Count the occurrence levels built while the block runs: {"primed": builds of
    ``member_block.prime_ordered_levels``, before any map; "inside": any other build (in
    ``state.ordered_index_add`` or ``rim_slope_match_out``'s condition levels)}."""
    from membrane_solver_tpu_torch.constraints import rim_slope_match_out as rim
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.parallel import member_block

    counts = {"primed": 0, "inside": 0}
    build = tstate.occurrence_levels

    def counted(kind):
        def levels(rows):
            counts[kind] += 1
            return build(rows)

        return levels

    saved = [(mod, mod.occurrence_levels) for mod in (member_block, tstate, rim)]
    member_block.occurrence_levels = counted("primed")
    tstate.occurrence_levels = rim.occurrence_levels = counted("inside")
    try:
        yield counts
    finally:
        for mod, fn in saved:
            mod.occurrence_levels = fn


def phase_interface_drives(torch, tk, vs, counters, label: str, fixture: dict) -> dict:
    """The local-interface family and the rigid disk over a member axis on kozlov L3 (phase 46).

    Phase 25's set-up with the law and the hard constraint added
    (:func:`interface_drives_setup`) on its fixture's inputs, four members
    with seeded offsets (:func:`tilt_member_inputs`); every item of
    :func:`interface_items` at float64 against the JAX package's
    ``jax.vmap`` (rel 1e-10; arrays of their largest entry), member m of the
    map equal in bits to member m's single call, the same items at float32
    against float64 within max(2e-3, 2 x the JAX package's own float32
    deviation per item); no single-entry launch and no twin call inside a
    map.
    """
    from membrane_solver_tpu_torch import Minimizer
    from membrane_solver_tpu_torch.device.state import COMPILES

    proto = fixture["protocol"]
    f32_ref = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    failed, per_item, seconds = [], {}, {}
    t0 = time.perf_counter()
    mesh = build_lane(torch, proto["match"]["kozlov"], torch.float64).mesh
    interface_drives_setup(mesh, proto)
    by_dtype = {d: interface_problems(Minimizer, mesh, proto, device=DEVICE, dtype=d)
                for d in (torch.float64, torch.float32)}
    p64 = by_dtype[torch.float64][None]
    n = p64.n_vertices
    base = tilt_base_inputs(proto, "match", n)
    input_dev = max(float(np.max(np.abs(getattr(p64.state, f).detach().cpu().numpy() - base[f])))
                    for f in TILT_FIELDS if f != "tilts")
    if not input_dev <= 1e-12 * max(float(np.max(np.abs(base["positions"]))), 1.0):
        failed.append(f"the lane's inputs lie {input_dev!r} off the fixture's")
    rows = sample_rows(proto, n)
    members = tilt_member_inputs(proto, base)
    seconds["setup"] = time.perf_counter() - t0
    reset_counts(counters)
    compiles0 = COMPILES["compile_state"]
    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins:
        t0 = time.perf_counter()
        v64 = interface_items(torch, by_dtype[torch.float64], proto, members, counters)
        seconds["f64"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        v32 = interface_items(torch, by_dtype[torch.float32], proto, members)
        seconds["f32"] = time.perf_counter() - t0
    launches = read_counts(counters)
    compiles = COMPILES["compile_state"] - compiles0
    for item, got in v64["vmapped"].items():
        dev = tilt_item_deviation(fixture["items"][item], got, rows)
        exact = sum(1 for m, one in enumerate(v64["single"][item]) if np.array_equal(got[m], one))
        dev32 = relative_error(v32["vmapped"][item], got)
        bound32 = max(F32_RTOL, 2 * f32_ref[item])
        per_item[item] = {"dev_f64": dev, "members_equal_bits": exact, "dev_f32": dev32,
                          "bound_f32": bound32}
        say(label + " item", item=item, dev_f64=repr(dev),
            members_equal_bits=f"{exact}/{len(members)}", dev_f32=repr(dev32),
            bound_f32=repr(bound32))
        if not dev <= DRIVES_F64_RTOL:
            failed.append(f"{item} float64 {dev!r}")
        if exact != len(members):
            failed.append(f"{item}: {len(members) - exact} members differ from their single calls")
        if not dev32 <= bound32:
            failed.append(f"{item} float32 {dev32!r} bound {bound32!r}")
    for key, rec in v64["launches"].items():
        say(label + " launches", item=key, **{k: json.dumps(v) for k, v in rec.items()})
        if rec["single_in_map"]:
            failed.append(f"{key} launched single entries inside the map: {rec['single_in_map']}")
    calls = {k: v for k, v in twins.items() if v}
    if calls:
        failed.append(f"twin calls {calls}")
    if compiles:
        failed.append(f"{compiles} compile_state calls inside the maps")
    say(label, members=proto["members"], vertices=fixture["n_vertices"],
        triangles=fixture["n_triangles"], items=len(per_item),
        items_all_bits_equal=sum(1 for r in per_item.values()
                                 if r["members_equal_bits"] == proto["members"]),
        ordered_levels=json.dumps(ordered_levels(p64.topo)),
        seconds_s=json.dumps({k: round(v, 3) for k, v in seconds.items()}),
        launches=json.dumps(launches))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "items": per_item}


def uneven_disk(mn, protocol: dict) -> None:
    """The sweep protocol's ``uneven_disk`` offsets on either package's minimizer, if it has them.

    Every vertex of the ``preset`` (the free disk), in vertex-id order
    (``numpy.random.default_rng(seed)``), moves by ``xy_scale`` normals in x
    and y and ``z_scale`` in z; the minimizer then compiles anew.  A planar
    disk's pairwise rows leave the shape KKT system a null space (ROADMAP
    C5), where the JAX package's solve returns multipliers of 1e19-1e30 and
    a projection made of round-off; on an uneven disk the rows are
    independent.
    """
    rec = protocol.get("uneven_disk")
    if rec is None:
        return
    mn._sync_host()
    rng = np.random.default_rng(rec["seed"])
    scale = np.array([rec["xy_scale"], rec["xy_scale"], rec["z_scale"]])
    for vid in sorted(mn.mesh.vertices):
        v = mn.mesh.vertices[vid]
        if (v.options or {}).get("preset") == rec["preset"]:
            v.position[:] = v.position + scale * rng.standard_normal(3)
    mn.invalidate()


def member_pair_errors(torch, states, topo) -> list:
    """Per member, the largest |d_ij - d_ij(reference)| over the rigid disk's anchor pairs."""
    x = lambda k: topo.extras[f"constraint:rigid_disk/{k}"]  # noqa: E731
    pairs, ref = x("pairs"), x("ref")
    d_ref = torch.linalg.vector_norm(ref[pairs[:, 0]] - ref[pairs[:, 1]], dim=1)
    pos = states.positions[:, x("rows")]
    d = torch.linalg.vector_norm(pos[:, pairs[:, 0]] - pos[:, pairs[:, 1]], dim=2)
    return torch.max(torch.abs(d - d_ref), dim=1).values.tolist()


def member_breakdowns(torch, problem, states, params) -> list:
    """Per member, the energy breakdown of its state ({module: float})."""
    from membrane_solver_tpu_torch.runtime import jit_core

    breakdown = jit_core.make_energy_breakdown(problem.spec)
    out = []
    for m in range(states.positions.shape[0]):
        st = dataclasses.replace(problem.state, **{f: getattr(states, f)[m] for f in STATE_FIELDS})
        vals = breakdown(st, problem.topo, {k: v for k, v in problem.params.items()} | {
            k: torch.as_tensor(v, dtype=problem.params[k].dtype, device=DEVICE)
            for k, v in params[m].items()})
        out.append({k: float(v) for k, v in vals.items()})
    return out


def phase_lane_sweep(torch, tk, vs, counters, label: str, fixture: dict, dtype, snap: dict,
                     f64=None, mn=None) -> dict:
    """The sweep on a lane's state (phases 42-43 interface, 44-45 free disk, 48-49 physical
    edge, 50-51 scaffold).

    ``snap``: the state phase 23 (24), 21 (22), 26 (27) or 28 (29) left
    after its protocol's steps, restored into ``mn`` (that phase's
    minimizer; default a fresh L3 minimizer of the lane), on the free-disk
    lane with the protocol's :func:`uneven_disk` offsets.  ``drive_sweep``'s checks,
    no twin call inside the sweep (its single launches printed), then the
    lane's own: on every lane the occurrence levels built in the sweep
    (:func:`counted_level_builds`: each kept key once, before any map,
    none inside it); on the interface and physical-edge lanes the ordered
    rows' levels per enforcement; on the physical-edge lanes each member's
    ``trace_z`` fallbacks, and on the scaffold lane per member and
    iteration the fallback's viability and accepted search against JAX's
    (fixture at float64, printed beside its float32 run's at float32), at
    float64 at least one member-step taking it where JAX's does; on the
    free-disk lane, per member, the shape KKT solves'
    multiplier-finite flags against JAX's (fixture, or its float32 run) and
    the null-space fallback beside them; the rigid fit mapped over the final
    states (the default options enforce nothing in the line search, and
    the members start dilated) within ``PAIR_TOL`` of the reference shape's
    anchor-pair distances; and at float64 the final state's
    energy less ``ORDER_TERM`` within rel 1e-8 of JAX's and that term within
    ``ORDER_RTOL``.  The work term carries no gradient but reads the ring in
    its compiled angular order (ROADMAP C5), so the sweep's energies are
    held at 1e-8 plus ``ORDER_RTOL`` of the term's share of the energy.  At
    float32 the stats held against the float64 phase are the energies: the
    JAX package's own float32 sweeps take other line-search decisions than
    its float64 ones here (on the free-disk lane it rejects every step that
    float64 accepts), so step sizes, gradient norms and accepted energies
    follow other decisions; the flags are held against JAX's float32 run.
    """
    proto = fixture["protocol"]
    name = str(dtype).removeprefix("torch.")
    free_disk = "rigid_disk" in proto["kozlov"].get("extra_constraint_modules", ())
    gp = proto["kozlov"]["global_parameters"]
    physical = gp.get("rim_slope_match_mode") == "physical_edge_staggered_v1"
    trace_z = gp.get("shape_scaffold_rejected_step_fallback") == "trace_z"
    t0 = time.perf_counter()
    if mn is None:
        mn = build_lane(torch, proto["kozlov"], dtype)
    restore(mn, snap)
    uneven_disk(mn, proto)
    problem = mn.problem()
    setup_s = time.perf_counter() - t0
    built_before = len(ordered_levels(problem.topo))
    stat_bound = None
    if free_disk and f64 is None:
        share = max(abs(b[ORDER_TERM]) / abs(e) for b, e in
                    zip(fixture["final_breakdowns"], fixture["energy"], strict=True))
        stat_bound = F64_RTOL + ORDER_RTOL * share
    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins, \
            counted_level_builds() as builds:
        out = drive_sweep(torch, counters, label, fixture, dtype, problem, f64,
                          stat_bound=stat_bound, kkt=free_disk or physical,
                          f32_stats=("energy",), trace_z=trace_z)
    launches, states = out["launches"], out["states"]
    failed = []
    levels = ordered_levels(problem.topo)
    if builds["inside"] or builds["primed"] != len(levels) - built_before:
        failed.append(f"occurrence levels built {builds} times for {len(levels)} kept keys "
                      f"({built_before} before the sweep)")
    # the trial energies launch only where a member scores a trial: on the free-disk lane at
    # float32 no projected gradient is a descent direction (JAX's float32 run rejects too)
    expect = [k for k in SWEEP_EXPECT if int(np.sum(out["trials"])) > 0
              or k != "tri_kernels.surface_energy_members"]
    missing = [k for k in expect if not launches[k] > 0]
    if missing:
        failed.append(f"the path did not launch {missing}")
    if any(twins.values()):
        failed.append(f"twin calls {({k: v for k, v in twins.items() if v})}")
    # the pins' normals of the shared reference shape take single vertex sums (phases 33-34 too)
    fields = {"single_launches": json.dumps({k: v for k, v in launches.items()
                                             if not k.endswith("_members") and v})}
    fields["level_builds"] = json.dumps(builds)
    if physical:
        # the shells' singular rim systems: a zero pivot skips the projection, as in JAX
        ref = fixture if f64 is None else fixture["float32_reference"]
        fields.update(trace_z_fallbacks=json.dumps(out["fallbacks"].tolist()),
                      multipliers_finite=json.dumps([[bool(s[0][m]) for s in out["kkt"]]
                                                     for m in range(proto["members"])]),
                      jax_multipliers_finite=json.dumps(ref["multipliers_finite"]))
    if trace_z:
        ref = fixture if f64 is None else fixture["float32_reference"]
        viable = [t["viable"] for t in out["trace_z"]]
        taken = [t["accepted"] for t in out["trace_z"]]
        fields.update(trace_z_viable=json.dumps(viable), trace_z_accepted=json.dumps(taken),
                      jax_trace_z_viable=json.dumps(ref["trace_z_viable"]),
                      jax_trace_z_accepted=json.dumps(ref["trace_z_accepted"]))
        if [sum(v) for v in viable] != out["fallbacks"].tolist():
            failed.append(f"fallback counts {out['fallbacks'].tolist()} vs viable steps {viable}")
        if f64 is None and (viable, taken) != (ref["trace_z_viable"], ref["trace_z_accepted"]):
            failed.append(f"trace_z fallback flags {viable} {taken} vs JAX's "
                          f"{ref['trace_z_viable']} {ref['trace_z_accepted']}")
        if f64 is None and any(map(any, ref["trace_z_viable"])) and not out["fallbacks"].sum():
            failed.append("no member-step took the trace_z fallback")
    if not free_disk:
        fields["ordered_levels_per_enforcement"] = json.dumps(levels)
    else:
        solves = out["kkt"]
        finite = [[bool(s[0][m]) for s in solves] for m in range(proto["members"])]
        fallback = [[bool(s[1][m]) for s in solves] for m in range(proto["members"])]
        want = (fixture if f64 is None else fixture["float32_reference"])["multipliers_finite"]
        # the default options enforce nothing in the line search: the dilated members keep
        # their dilated disks; the rigid fit mapped over the final states restores them
        from torch.func import vmap

        from membrane_solver_tpu_torch.constraints import get_constraint

        enforce = get_constraint("rigid_disk").make_enforce(problem.spec)
        with torch.no_grad():
            fitted = vmap(lambda st: enforce(st, problem.topo, problem.params))(states)
        pair_errs = member_pair_errors(torch, fitted, problem.topo)
        tol = PAIR_TOL[name]
        params, _positions = sweep_members(proto, problem.state.positions.detach().cpu().numpy(),
                                           problem.params)
        bds = member_breakdowns(torch, problem, states, params)
        fields.update(multipliers_finite=json.dumps(finite), jax_multipliers_finite=json.dumps(want),
                      null_space_fallback=json.dumps(fallback),
                      lam_max=json.dumps([[float(s[2][m]) for s in solves]
                                          for m in range(proto["members"])]),
                      sweep_pair_distance_err=json.dumps(member_pair_errors(torch, states,
                                                                            problem.topo)),
                      fitted_pair_distance_err=json.dumps(pair_errs), pair_bound=repr(tol))
        if finite != want:
            failed.append(f"multiplier-finite flags {finite} vs JAX's {want}")
        if not max(pair_errs) <= tol:
            failed.append(f"anchor-pair distances off by {max(pair_errs)!r}")
        if f64 is None:
            less = [abs((sum(g.values()) - g[ORDER_TERM]) - (sum(w.values()) - w[ORDER_TERM]))
                    / abs(sum(w.values()) - w[ORDER_TERM])
                    for g, w in zip(bds, fixture["final_breakdowns"], strict=True)]
            term = [abs(g[ORDER_TERM] - w[ORDER_TERM]) / abs(w[ORDER_TERM])
                    for g, w in zip(bds, fixture["final_breakdowns"], strict=True)]
            fields.update(final_rel_dev_less_order_term=json.dumps(less),
                          order_term_rel_dev=json.dumps(term), stat_bound=repr(stat_bound))
            if not (max(less) <= F64_RTOL and max(term) <= ORDER_RTOL):
                failed.append(f"final energies: {less} {term}")
    say(label + " lane", setup_s=f"{setup_s:.3f}",
        parts_s=json.dumps({k: round(v, 3) for k, v in out["parts"].items()}), **fields)
    out["check"]()
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "stats": out["stats"], "sketches": out["sketches"],
            "fallbacks": out["fallbacks"].tolist(), "sweep_s": out["parts"]["sweep"],
            "problem": problem, "digest": out["digest"]}


def phase_viz_face_values(torch, tk, counters, label: str, mn) -> dict:
    """The visualization's face values on phase 23's state (phase 47).

    Per colour mode of ``VIZ_MODES``: the face values on the card at
    float64 (``visualization.plot_core._face_values``; the divergence modes
    launch ``tri_p1_div``) against the CPU's float64 values within
    ``VIZ_CPU_RTOL`` of their max; the divergence of each field through the
    kernel against its twin on the same card tensors within kernel 4's
    bounds at float64 and float32.  matplotlib is not imported.
    """
    from membrane_solver_tpu_torch.device import tilt_ops
    from membrane_solver_tpu_torch.device.state import corner_csr
    from membrane_solver_tpu_torch.visualization import plot_core

    mn.problem()
    mn._sync_host()
    mesh = mn.mesh
    failed, rows_out = [], {}
    reset_counts(counters)
    t0 = time.perf_counter()
    card = {mode: plot_core._face_values(mesh, mode, DEVICE) for mode in VIZ_MODES}
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts(counters)
    for mode in VIZ_MODES:
        fids, got = card[mode]
        _fids, want = plot_core._face_values(mesh, mode, "cpu")
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        err = float(np.max(np.abs(got - want))) if want.size else 0.0
        rows_out[mode] = {"max": scale, "cpu_err": err}
        if not (list(fids) == list(_fids) and err <= VIZ_CPU_RTOL * max(scale, 1e-300)
                and np.all(np.isfinite(got))):
            failed.append(f"{mode}: card vs CPU {err!r} of max {scale!r}")
    tri, _fids = mesh.triangle_rows()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        pos = torch.as_tensor(mesh.positions_array(), dtype=dtype, device=DEVICE)
        t_rows = torch.as_tensor(np.asarray(tri), dtype=torch.int64, device=DEVICE)
        valid = torch.ones(t_rows.shape[0], dtype=torch.bool, device=DEVICE)
        csr = corner_csr(t_rows, pos.shape[0])
        for mode in ("div_in", "div_out", "divergence"):
            tl = torch.as_tensor(plot_core._tilt_field_for(mesh, mode), dtype=dtype, device=DEVICE)
            got = tk.p1_triangle_divergence(pos, tl, t_rows, valid, csr)
            want = tilt_ops.p1_triangle_divergence(pos, tl, t_rows, valid)
            key = f"{mode} {str(dtype).removeprefix('torch.')}"
            try:
                errs[key] = max(_tk_check(torch, f"{label} {key} div", got[0], want[0], dtype,
                                          "curv"),
                                _tk_check(torch, f"{label} {key} area", got[1], want[1], dtype, "e"))
            except AssertionError as exc:
                failed.append(str(exc))
    if not launches["tri_kernels.p1_div"] > 0:
        failed.append(f"the face values did not launch tri_p1_div: {launches}")
    if "matplotlib" in sys.modules:
        failed.append("matplotlib was imported")
    say(label, vertices=len(mesh.vertices), facets=len(mesh.facets), card_s=f"{card_s:.3f}",
        modes=json.dumps(rows_out), kernel_vs_twin=json.dumps(errs),
        launches=json.dumps({k: v for k, v in launches.items() if v}))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "errs": errs}


# ----------------------------------------------------------------------
# phases 48-52: the physical-edge rim placement and the trace_z fallback in the sweep
# ----------------------------------------------------------------------
PHYSICAL_EDGE_SWEEP_FIXTURE = FIXTURES / "kozlov_L3_physical_edge_sweep_f64_jax.json"
SCAFFOLD_SWEEP_FIXTURE = FIXTURES / "kozlov_L3_scaffold_sweep_f64_jax.json"
PHYSICAL_EDGE_DRIVES_FIXTURE = FIXTURES / "kozlov_L3_sweep_physical_edge_drives_f64_jax.json"
RIM = "rim_slope_match_out"


def physical_edge_problems(torch, protocol: dict) -> dict:
    """Phase 52's problems, {dtype: {lane: problem}}: each lane of ``protocol["lanes"]`` built
    once on the host up to its first step and compiled at float64 and float32."""
    from membrane_solver_tpu_torch import Minimizer

    out = {torch.float64: {}, torch.float32: {}}
    for lane, lane_protocol in protocol["lanes"].items():
        mesh = build_lane(torch, lane_protocol, torch.float64).mesh
        for dtype, problems in out.items():
            problems[lane] = Minimizer(mesh, device=DEVICE, dtype=dtype, quiet=True).problem()
    return out


def physical_edge_inputs(protocol: dict, problems: dict) -> dict:
    """Per lane the members' inputs (:func:`tilt_member_inputs`) about the lane's compiled start."""
    return {lane: tilt_member_inputs(protocol, {
        f: getattr(p.state, f).detach().cpu().double().numpy() for f in TILT_FIELDS})
        for lane, p in problems.items()}


def physical_edge_items(torch, problems: dict, protocol: dict, inputs: dict,
                        counters=None) -> dict:
    """Every item of phase 52 on ``problems`` ({lane: problem}) with ``inputs`` ({lane: the
    members' inputs}): under ``vmap`` over the members and member by member, as
    :func:`tilt_items` takes them.

    The scaffold lane's four tilt energies with their gradients; per lane
    ``rim_slope_match_out``'s compact tilt rows and the two slots of its
    compact shape rows (their values, :func:`pad_compact`), its tilt
    enforcement's changes and, on the trace lane, its shape enforcement's
    (the trace-shell projection) changes of the positions and outer tilts.
    """
    from membrane_solver_tpu_torch.constraints import get_constraint
    from membrane_solver_tpu_torch.device.state import MeshState

    rim = get_constraint(RIM)
    host = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    out = {"vmapped": {}, "single": {}, "launches": {}}
    for lane, p in problems.items():
        members = inputs[lane]
        if lane in protocol["energies"]:
            sub = {"energies": {"drives": protocol["energies"][lane]}}
            got = tilt_items(torch, p, sub, "drives", members, counters)
            for k in out:
                out[k].update(got[k])
        stacked = {f: torch.as_tensor(np.stack([m[f] for m in members]),
                                      dtype=p.state.positions.dtype, device=DEVICE)
                   for f in TILT_FIELDS}
        states = MeshState(*(stacked[f] for f in TILT_FIELDS))
        singles = [MeshState(*(stacked[f][m] for f in TILT_FIELDS)) for m in range(len(members))]

        def compact(name, vals, single, n=p.n_vertices):
            vals = host(vals)
            return {name: pad_compact(vals[None], n)[0] if single else pad_compact(vals, n)}

        def changes(*fields):
            return lambda moved, st, single=False: {
                f: host(getattr(moved, f) - getattr(st, f)) for f in fields}

        key = f"constraint/{RIM}/{lane}"
        with torch.no_grad():
            for fn, post in (
                    (rim.make_compact_tilt_rows(p.spec),
                     lambda rows, _st, single=False: compact("tilt_rows", rows[0], single)),
                    (rim.make_compact_constraint_rows(p.spec),
                     lambda rows, _st, single=False: compact("shape_rows", rows[0][..., :2, :],
                                                             single)),
                    (rim.make_enforce_tilts(p.spec), changes("tilts_in", "tilts_out"))):
                mapped_items(torch, out, key, fn, p, states, singles, post, counters)
            enforce = rim.make_enforce(p.spec)
            if enforce is not None:
                mapped_items(torch, out, key + "/enforce", enforce, p, states, singles,
                             changes("positions", "tilts_out"), counters)
    return out


def phase_physical_edge_drives(torch, tk, vs, counters, label: str, fixture: dict) -> dict:
    """The physical-edge rim placement over a member axis on kozlov L3 (phase 52).

    Both lanes (plain and scaffold-trace) from their compiled starts, four
    members with seeded offsets (:func:`physical_edge_inputs`, held against
    the fixture's inputs at 1e-12); every item of :func:`physical_edge_items`
    at float64 against the JAX package's ``jax.vmap`` (rel 1e-10; arrays of
    their largest entry), member m of the map equal in bits to member m's
    single call, the same items at float32 against float64 within max(2e-3,
    2 x the JAX package's own float32 deviation per item); no single-entry
    launch and no twin call inside a map, no ``compile_state`` call, and the
    ordered rows' levels built before the maps alone.
    """
    from membrane_solver_tpu_torch.device.state import COMPILES

    proto = fixture["protocol"]
    f32_ref = fixture["float32_reference"]["max_rel_dev_vs_float64"]
    failed, per_item, seconds = [], {}, {}
    t0 = time.perf_counter()
    by_dtype = physical_edge_problems(torch, proto)
    p64 = by_dtype[torch.float64]
    n = p64["scaffold"].n_vertices
    rows = sample_rows(proto, n)
    inputs = physical_edge_inputs(proto, p64)
    input_dev = max(tilt_item_deviation(fixture["items"][f"input/{lane}/{f}"],
                                        np.stack([m[f] for m in members]), rows)
                    for lane, members in inputs.items() for f in TILT_FIELDS)
    if not input_dev <= 1e-12:
        failed.append(f"the lanes' inputs lie {input_dev!r} off the fixture's")
    seconds["setup"] = time.perf_counter() - t0

    def kept_keys():
        return sum(len(ordered_levels(q.topo)) for problems in by_dtype.values()
                   for q in problems.values())

    built_before = kept_keys()
    reset_counts(counters)
    compiles0 = COMPILES["compile_state"]
    with counted_twins({"tri_kernels": tk, "vertex_sum": vs}) as twins, \
            counted_level_builds() as builds:
        t0 = time.perf_counter()
        v64 = physical_edge_items(torch, p64, proto, inputs, counters)
        seconds["f64"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        v32 = physical_edge_items(torch, by_dtype[torch.float32], proto, inputs)
        seconds["f32"] = time.perf_counter() - t0
    launches = read_counts(counters)
    compiles = COMPILES["compile_state"] - compiles0
    for item, got in v64["vmapped"].items():
        dev = tilt_item_deviation(fixture["items"][item], got, rows)
        exact = sum(1 for m, one in enumerate(v64["single"][item]) if np.array_equal(got[m], one))
        dev32 = relative_error(v32["vmapped"][item], got)
        bound32 = max(F32_RTOL, 2 * f32_ref[item])
        per_item[item] = {"dev_f64": dev, "members_equal_bits": exact, "dev_f32": dev32,
                          "bound_f32": bound32}
        say(label + " item", item=item, dev_f64=repr(dev),
            members_equal_bits=f"{exact}/{proto['members']}", dev_f32=repr(dev32),
            bound_f32=repr(bound32))
        if not dev <= DRIVES_F64_RTOL:
            failed.append(f"{item} float64 {dev!r}")
        if exact != proto["members"]:
            failed.append(f"{item}: {proto['members'] - exact} members differ from their single "
                          "calls")
        if not dev32 <= bound32:
            failed.append(f"{item} float32 {dev32!r} bound {bound32!r}")
    missing = sorted(set(fixture["items"]) - set(v64["vmapped"]) - {
        k for k in fixture["items"] if k.startswith("input/")})
    if missing:
        failed.append(f"items not evaluated: {missing}")
    for key, rec in v64["launches"].items():
        say(label + " launches", item=key, **{k: json.dumps(v) for k, v in rec.items()})
        if rec["single_in_map"]:
            failed.append(f"{key} launched single entries inside the map: {rec['single_in_map']}")
    calls = {k: v for k, v in twins.items() if v}
    if calls:
        failed.append(f"twin calls {calls}")
    if compiles:
        failed.append(f"{compiles} compile_state calls inside the maps")
    if builds["inside"] or builds["primed"] != kept_keys() - built_before:
        failed.append(f"occurrence levels built {builds} for {kept_keys()} kept keys "
                      f"({built_before} before the maps)")
    say(label, members=proto["members"], vertices=fixture["n_vertices"],
        triangles=fixture["n_triangles"], items=len(per_item),
        items_all_bits_equal=sum(1 for r in per_item.values()
                                 if r["members_equal_bits"] == proto["members"]),
        input_dev=repr(input_dev),
        ordered_levels=json.dumps({lane: ordered_levels(q.topo) for lane, q in p64.items()}),
        level_builds=json.dumps(builds),
        seconds_s=json.dumps({k: round(v, 3) for k, v in seconds.items()}),
        launches=json.dumps(launches))
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"launches": launches, "items": per_item}


def phase_multidisk(torch, counters, label: str) -> dict:
    """The multi-disk sweep analysis on the card: three cube meshes, rows vs the CPU's."""
    import tempfile

    from membrane_solver_tpu_torch.analysis import multidisk_sweep as md
    from membrane_solver_tpu_torch.meshgen import build

    with tempfile.TemporaryDirectory() as tmp:
        runs = Path(tmp) / "runs"
        runs.mkdir()
        for L in (2.0, 3.0, 4.5):
            (runs / f"run_L{L}.json").write_text(json.dumps(build("cube", size=1.0 + 0.1 * L)))
        reset_counts(counters)
        t0 = time.perf_counter()
        rows = md.run_sweep(runs, Path(tmp) / "card", plot=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
        want = md.run_sweep(runs, Path(tmp) / "cpu", plot=False, device="cpu")
        written = json.loads((Path(tmp) / "card" / "results.json").read_text())
    devs = {}
    for got_row, want_row in zip(rows, want, strict=True):
        if set(got_row) != set(want_row):
            raise AssertionError(f"{label}: keys differ: {sorted(set(got_row) ^ set(want_row))}")
        for key, w in want_row.items():
            if isinstance(w, float):
                devs[key] = max(devs.get(key, 0.0), abs(got_row[key] - w) / max(abs(w), 1e-300))
            elif got_row[key] != w:
                raise AssertionError(f"{label}: {key} {got_row[key]!r} vs {w!r}")
    worst = max(devs.values())
    say(label, files=json.dumps([r["file"] for r in rows]),
        separations=json.dumps([r["separation"] for r in rows]),
        energies=json.dumps([r["energy"] for r in rows]), max_rel_dev_vs_cpu=repr(worst),
        bound=MULTIDISK_RTOL, seconds=f"{seconds:.3f}", launches=json.dumps(launches))
    if written != rows:
        raise AssertionError(f"{label}: results.json differs from the returned rows")
    if not worst <= MULTIDISK_RTOL:
        raise AssertionError(f"{label}: the card's rows deviate from the CPU's by {worst!r}")
    if not launches["tri_kernels.surface_energy"] > 0:
        raise AssertionError(f"{label}: the analysis did not launch the surface energy kernel")
    return {"launches": launches}


# ----------------------------------------------------------------------
# phases 53-54: placement on a list of devices (the sweep's device_mesh, the
# vertex-sharded evaluation)
# ----------------------------------------------------------------------
PLACED_SIZES = (2, 4)  # phase 53: the main sweep on [cuda:0] * k
MIXED_MEMBERS = 2  # phase 53: the sweep on [cuda:0, cpu]
MIXED_STEPS = 2
TP_SHARDS = 4  # phase 54: [cuda:0] * TP_SHARDS
# phase 54: the sharded energy and gradient against the one-card call: the
# per-triangle kernel bars (energy relative, gradient of max|g|)
TP_BARS = {"float64": (1e-12, 1e-11), "float32": (2e-6, 2e-5)}
TP_BLOCK_RTOL = {"float64": 1e-12, "float32": 2e-6}  # the block step's energy
TP_EXPECT = ("tri_kernels.surface_energy_grad", "tri_kernels.curvature_data",
             "tri_kernels.curvature_data_bwd", "tri_kernels.p1_div", "vertex_sum.vertex_sum")


def nonzero(launches: dict) -> dict:
    return {k: n for k, n in launches.items() if n}


def member_match(torch, states, stats: dict, w_states, w_stats: dict, m: int, wm: int) -> tuple:
    """(the fields not equal in bits, largest relative deviation) of member ``m`` against member
    ``wm`` of the reference: its positions, tilts and stats."""
    unequal = [f for f in STATE_FIELDS if not torch.equal(
        getattr(states, f)[m].cpu(), getattr(w_states, f)[wm].cpu())]
    unequal += [k for k in SWEEP_STATS if not np.array_equal(np.asarray(stats[k])[m],
                                                             np.asarray(w_stats[k])[wm])]
    dev = max(abs(float(stats[k][m]) - float(w_stats[k][wm])) / abs(float(w_stats[k][wm]))
              for k in FLOAT_STATS)
    for f in STATE_FIELDS:
        want = getattr(w_states, f)[wm].detach().cpu().double()
        got = getattr(states, f)[m].detach().cpu().double()
        dev = max(dev, float(torch.max(torch.abs(got - want))) / max(float(torch.max(
            torch.abs(want))), 1.0))
    return unequal, dev


def phase_sweep_placed(torch, counters, label: str, fixture: dict, dtype, w: dict) -> dict:
    """Phase 33's sweep (34's at float32) placed on ``[cuda:0] * k`` and ``[cuda:0, cpu]``.

    ``w``: phase 33's (34's) result, its problem, members and final states.
    Each group against an unplaced sweep of its own members on the card: in
    bits, launch for launch (the placement adds nothing to a group's
    computation).  Each placed member against phase 33's member: in bits
    (a member is its one-member sweep's bits at any member count), the
    fields that are not printed.  Two placed runs' digests.  Then two
    members for ``MIXED_STEPS`` steps on ``[cuda:0, cpu]``: the card member
    in bits against its one-member sweep and against the card's unplaced
    sweep of the two, the CPU member within ``MEMBER_RTOL`` of the latter
    (the one comparison of two arithmetics: the CPU runs the kernels' plain
    twins), launches on the card group only.  With more than one card, the
    sweep on distinct cards too, in bits, with ms per sweep step.
    """
    from membrane_solver_tpu_torch.parallel import sweep as psweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    proto = fixture["protocol"]
    B, steps = proto["members"], proto["steps"]
    name = str(dtype).removeprefix("torch.")
    problem, (params, positions) = w["problem"], w["members"]
    options = MinimizeOptions(**sweep_options(proto))
    card = smi_line()

    def sweep(mesh=None, members=range(B), n_steps=steps):
        sel = list(members)
        out = psweep.run_sweep(problem, [params[m] for m in sel], n_steps,
                               step_size=proto["step_size"], options=options,
                               member_positions=[positions[m] for m in sel], device_mesh=mesh)
        torch.cuda.synchronize()
        return out

    def placed(mesh, members=range(B), n_steps=steps):
        """The placed sweep with the counts reset just before and read just after."""
        reset_counts(counters)
        psweep.GROUP_RECORD = []
        t0 = time.perf_counter()
        try:
            states, _ss, stats = sweep(mesh, members, n_steps)
            groups = psweep.GROUP_RECORD
        finally:
            psweep.GROUP_RECORD = None
        seconds = time.perf_counter() - t0
        return states, _stats_of(stats), groups, read_counts(counters), seconds

    def groups_against_unplaced(states, got, groups, first, n_steps):
        """Per group: (its members' unequal fields against an unplaced sweep of those members,
        its launches equal to that sweep's)."""
        out = []
        for _d, (lo, hi), g in groups:
            reset_counts(counters)
            u_states, _u, u_stats = sweep(None, range(first + lo, first + hi), n_steps)
            want = nonzero(read_counts(counters))
            u = _stats_of(u_stats)
            unequal = sorted({f for m in range(lo, hi)
                              for f in member_match(torch, states, got, u_states, u, m, m - lo)[0]})
            out.append((unequal, nonzero(g) == want))
        return out

    failures, out = [], {}
    cuda0 = torch.device("cuda", 0)
    for k in PLACED_SIZES:
        states, got, groups, launches, seconds = placed([cuda0] * k)
        matches = [member_match(torch, states, got, w["states"], w["stats"], m, m)
                   for m in range(B)]
        per_group = groups_against_unplaced(states, got, groups, 0, steps)
        missing = [key for key in SWEEP_EXPECT if not launches[key] > 0]
        say(label + " placed", mesh=f"cuda:0x{k}", members=B, steps=steps,
            seconds=f"{seconds:.3f}", ms_per_step=f"{seconds * 1e3 / steps:.3f}",
            groups=json.dumps([[str(d), list(span)] for d, span, _g in groups]),
            groups_bits_equal_to_unplaced=json.dumps([not u for u, _e in per_group]),
            groups_launch_as_unplaced=json.dumps([e for _u, e in per_group]),
            max_rel_dev_vs_phase_33=repr(max(d for _u, d in matches)),
            fields_not_bits_of_phase_33=json.dumps([u for u, _d in matches]),
            group_launches=json.dumps(nonzero(groups[0][2])), card=repr(card))
        if len(groups) != k or not all(not u and e for u, e in per_group):
            failures.append(f"[cuda:0]*{k}: groups against their unplaced sweeps {per_group}")
        if any(u for u, _d in matches):
            failures.append(f"[cuda:0]*{k}: members are not phase 33's bits: {matches}")
        if missing:
            failures.append(f"[cuda:0]*{k}: the path did not launch {missing}: {launches}")
        out[k] = {"states": states, "stats": got, "launches": launches}
    digests = [sweep_digest(out[PLACED_SIZES[0]]["states"], out[PLACED_SIZES[0]]["stats"])]
    r_states, _r, r_stats = sweep([cuda0] * PLACED_SIZES[0])
    digests.append(sweep_digest(r_states, _stats_of(r_stats)))
    say(label + " placed determinism", mesh=f"cuda:0x{PLACED_SIZES[0]}", first=digests[0],
        second=digests[1], equal=digests[0] == digests[1])
    if digests[0] != digests[1]:
        failures.append(f"two placed sweeps differ: {digests}")

    # a card group and a CPU group side by side, two host threads
    ref_states, _rs, ref_stats = sweep(None, range(MIXED_MEMBERS), MIXED_STEPS)
    ref = _stats_of(ref_stats)
    states, got, groups, launches, seconds = placed([cuda0, torch.device("cpu")],
                                                    range(MIXED_MEMBERS), MIXED_STEPS)
    card_unequal, _e = groups_against_unplaced(states, got, groups[:1], 0, MIXED_STEPS)[0]
    card_vs_two, card_dev = member_match(torch, states, got, ref_states, ref, 0, 0)
    _u, cpu_dev = member_match(torch, states, got, ref_states, ref, 1, 1)
    by_device = {str(d): nonzero(g) for d, _span, g in groups}
    say(label + " mixed", mesh="cuda:0,cpu", members=MIXED_MEMBERS, steps=MIXED_STEPS,
        seconds=f"{seconds:.3f}", card_member_bits_of_its_unplaced_sweep=not card_unequal,
        card_member_fields_not_bits_of_the_sweep_of_two=json.dumps(card_vs_two),
        card_member_dev=repr(card_dev), cpu_member_dev=repr(cpu_dev),
        cpu_bound=repr(MEMBER_RTOL[name]), positions_device=str(states.positions.device),
        group_launches=json.dumps(by_device))
    if card_unequal or card_vs_two or not cpu_dev <= MEMBER_RTOL[name]:
        failures.append(f"[cuda:0, cpu]: card member {card_unequal} {card_vs_two}, CPU member "
                        f"{cpu_dev!r}")
    if not (sum(by_device.get("cuda:0", {}).values()) > 0 and not by_device.get("cpu")
            and states.positions.device == cuda0):
        failures.append(f"[cuda:0, cpu]: launches by group {by_device}, states on "
                        f"{states.positions.device}")

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = max(k for k in (2, 4, 8) if k <= n_cards and B % k == 0)
        mesh = [torch.device("cuda", i) for i in range(n)]
        sweep(mesh, range(B), 1)  # warm-up: every card's context and library
        states, got, groups, launches, seconds = placed(mesh)
        matches = [member_match(torch, states, got, w["states"], w["stats"], m, m)
                   for m in range(B)]
        t0 = time.perf_counter()
        sweep(None)
        single_s = time.perf_counter() - t0
        say(label + " distinct cards", cards=n, seconds=f"{seconds:.3f}",
            ms_per_step=f"{seconds * 1e3 / steps:.3f}",
            one_card_ms_per_step=f"{single_s * 1e3 / steps:.3f}",
            max_rel_dev_vs_phase_33=repr(max(d for _u, d in matches)),
            group_launches=json.dumps([[str(d), sum(g.values())] for d, _s, g in groups]),
            card=repr(card))
        if any(u for u, _d in matches) or not all(sum(g.values()) > 0 for _d, _s, g in groups):
            failures.append(f"distinct cards: {matches} {groups}")
    else:
        say(label + " distinct cards", cards=n_cards, measured=False)
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return {"launches": out[PLACED_SIZES[0]]["launches"]}


def tp_block_inner(gp) -> int:
    """The tilt relax's iterations per block call, as the minimizer reads them."""
    tilt_mode = str(gp.get("tilt_solve_mode", "fixed") or "fixed")
    if tilt_mode == "nested":
        inner = int(gp.get("tilt_inner_steps", 0) or 0)
    else:
        inner = int(gp.get("tilt_coupled_steps", gp.get("tilt_inner_steps", 0)) or 0)
    if str(gp.get("tilt_solver", "cg") or "cg").lower() == "cg":
        inner = int(gp.get("tilt_cg_max_iters", inner) or inner)
    return inner


def phase_tensor_parallel(torch, counters, label: str, fixture: dict, dtype, snap: dict) -> dict:
    """The vertex-sharded energy, gradient and block step on kozlov L3 from phase 5's (4's) state.

    ``tp_energy_and_grad`` on ``[cuda:0] * TP_SHARDS`` (the counts reset
    just before and read just after) against the one-card
    ``jit_core.make_energy_vg``, to ``TP_BARS``; every shard's own launches
    (its CSR's tally); two calls in bits; the same call on
    ``[cuda:0, cpu]``; one ``tp_minimize_block`` step against the one-card
    block (energy to ``TP_BLOCK_RTOL``, the same accept flag, finite
    positions).
    """
    from membrane_solver_tpu_torch.parallel import tensor as tp
    from membrane_solver_tpu_torch.runtime import jit_core

    name = str(dtype).removeprefix("torch.")
    e_bar, g_bar = TP_BARS[name]
    mn = build_lane(torch, fixture["protocol"], dtype)
    restore(mn, snap)
    p = mn.problem()
    E0, g0 = jit_core.make_energy_vg(p.spec)(p.state.positions, p.state, p.topo, p.params)
    g_scale = float(torch.max(torch.abs(g0)))
    failures = []

    def evaluate(mesh, tag):
        state, topo = tp.shard_problem(p, mesh)
        run = tp.tp_energy_and_grad(p.spec, mesh)
        reset_counts(counters)
        t0 = time.perf_counter()
        E, g = run(state, topo, p.params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
        shards = tp.shard_launches(topo)
        e_dev = abs(float(E) - float(E0)) / abs(float(E0))
        g_dev = float(torch.max(torch.abs(g.full() - g0))) / g_scale
        E2, g2 = run(state, topo, p.params)
        same = bool(torch.equal(E, E2) and torch.equal(g.full(), g2.full()))
        say(label + " " + tag, shards=len(mesh), vertices=p.n_vertices, triangles=p.n_tris,
            seconds=f"{seconds:.3f}", energy=repr(float(E)), one_card_energy=repr(float(E0)),
            energy_rel_dev=repr(e_dev), grad_dev_of_max=repr(g_dev),
            bounds=json.dumps([e_bar, g_bar]), two_calls_equal=same,
            ranges=json.dumps([[s.lo, s.hi] for s in topo.plan.shards]),
            owners=json.dumps([[str(d), a, b] for d, a, b in topo.plan.owners]),
            grad_blocks=json.dumps([str(d) for d in g.devices]),
            shard_launches=json.dumps([[str(d), nonzero(t)] for d, t in shards]))
        if not (e_dev <= e_bar and g_dev <= g_bar and same):
            failures.append(f"{tag}: energy {e_dev!r}, gradient {g_dev!r}, repeat equal {same}")
        return state, topo, launches, shards

    state, topo, launches, shards = evaluate([torch.device("cuda", 0)] * TP_SHARDS,
                                             f"cuda:0x{TP_SHARDS}")
    missing = [k for k in TP_EXPECT if not launches[k] > 0]
    if missing:
        failures.append(f"the sharded path did not launch {missing}: {launches}")
    idle = [i for i, (_d, t) in enumerate(shards) if not all(t.get(k, 0) > 0 for k in TP_EXPECT)]
    if idle:
        failures.append(f"shards {idle} launched not every kernel: {shards}")
    _s, _t, _l, mixed = evaluate([torch.device("cuda", 0), torch.device("cpu")], "cuda:0,cpu")
    if not (all(mixed[0][1].get(k, 0) > 0 for k in TP_EXPECT) and not mixed[1][1]):
        failures.append(f"[cuda:0, cpu]: shard launches {mixed}")

    # one block step, sharded and on one card, from phase 5's (4's) state
    options = jit_core.MinimizeOptions(enforce_in_line_search=True)
    inner = tp_block_inner(mn.mesh.global_parameters)

    def step(block, st, tp_):
        ss = jit_core.fresh_stepper_state(p.n_vertices, "gradient_descent", dtype=dtype,
                                          device=DEVICE)
        out = block(st, tp_, p.params, ss, 1, mn.step_size, mn.step_size, mn.tol,
                    mn.step_size_floor, mn.max_zero_steps, 0, inner)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    want_state, _ss, want = step(jit_core.minimize_block(p.spec, options), p.state, p.topo)
    t1 = time.perf_counter()
    shards_before = tp.shard_launches(topo)
    reset_counts(counters)
    got_state, _ss, got = step(tp.tp_minimize_block(p.spec, options, topo.plan.devices),
                               state, topo)
    t2 = time.perf_counter()
    block_launches = read_counts(counters)
    b_dev = abs(got.energy - want.energy) / abs(want.energy)
    finite = bool(torch.isfinite(got_state.positions).all())
    say(label + " block", shards=TP_SHARDS, inner=inner, energy=repr(got.energy),
        one_card_energy=repr(want.energy), energy_rel_dev=repr(b_dev),
        bound=repr(TP_BLOCK_RTOL[name]), step_success=got.step_success,
        one_card_step_success=want.step_success, finite=finite,
        seconds=f"{t2 - t1:.3f}", one_card_seconds=f"{t1 - t0:.3f}",
        launches=json.dumps(nonzero(block_launches)),
        shard_launches=json.dumps([[str(d), nonzero({k: n - b.get(k, 0) for k, n in t.items()})]
                                   for (d, t), (_d, b) in zip(tp.shard_launches(topo),
                                                              shards_before)]))
    if not (b_dev <= TP_BLOCK_RTOL[name] and got.step_success == want.step_success and finite
            and got.iterations == want.iterations):
        failures.append(f"block step: energy {b_dev!r}, flags {got.step_success} vs "
                        f"{want.step_success}, finite {finite}")
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return {"launches": launches}


# ----------------------------------------------------------------------
# phases 55-56: the batched line search against the sequential one
# ----------------------------------------------------------------------
BATCHED_ENV = "MEMBRANE_SOLVER_BATCHED_LS"
BATCHED_STEPS = 3  # phases 55-56: timed steps per form, after WARMUP_STEPS warm-up steps
FT_MEMBERS = (1, 3, 11)  # phase 56: frozen_tilt_members against single launches and its twin
FT_MEMBER_TIMED = 11  # phase 56's timing row: the relax's eleven tail candidates
# member launches the batched form must make on the lane (the Armijo tail's trial energies;
# at float32 also the relax's tail candidates through kernel 1)
BATCHED_EXPECT = {"float64": ("tri_kernels.surface_energy_members",
                              "tri_kernels.curvature_data_members",
                              "vertex_sum.vertex_sum_members"),
                  "float32": ("tri_kernels.surface_energy_members",
                              "tri_kernels.curvature_data_members",
                              "vertex_sum.vertex_sum_members", "frozen_tilt.energy_members")}


@contextlib.contextmanager
def line_search_form(batched: bool):
    """The line searches and relax backtracks in the batched (or sequential) form while inside."""
    saved = os.environ.get(BATCHED_ENV)
    os.environ[BATCHED_ENV] = "1" if batched else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(BATCHED_ENV, None)
        else:
            os.environ[BATCHED_ENV] = saved


def bench_form_steps(torch, counters, mn, snap: dict, batched: bool,
                     steps: int = WARMUP_STEPS + BATCHED_STEPS) -> dict:
    """The bench protocol's ``steps`` from ``snap`` under one form.

    First run: per step the accept flag, the energy, ms (a device sync on
    both sides), the line-search trials and the member launches (the counts
    set to 0 just before each step and read just after), then a digest of the
    state and the energies.  Second run from ``snap``: the host syncs of each
    step; its digest must be the first run's.
    """
    with line_search_form(batched):
        restore(mn, snap)
        rows, launches = [], collections.Counter()
        for _ in range(steps):
            reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mn.minimize(1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts(counters)
            launches.update(counts)
            rows.append({"accepted": bool(res["step_success"]), "energy": float(res["energy"]),
                         "ms": ms, "trials": int(res["line_search_trials"]),
                         "member_launches": {k: n for k, n in counts.items()
                                             if k.endswith("_members") and n}})
        energies = [r["energy"] for r in rows]
        digest = state_digest(torch, mn, energies)
        restore(mn, snap)
        again = []
        for row in rows:
            box = {}
            row["syncs"], _sites = count_syncs(torch, lambda: box.update(res=mn.minimize(1)))
            again.append(float(box["res"]["energy"]))
        if state_digest(torch, mn, again) != digest:
            raise AssertionError(f"two runs of the {'batched' if batched else 'sequential'} "
                                 "form from one state differ")
    return {"rows": rows, "digest": digest, "energies": energies,
            "flags": [r["accepted"] for r in rows], "launches": dict(launches)}


def check_ft_members(torch, ft, mn) -> tuple[dict, list]:
    """``frozen_tilt_members`` on the lane's own fused inputs (the relax's at this state) and
    seeded tilts: each member in bits of a single launch, the entry point's ``vmap`` the same
    bits, and within the frozen-tilt bounds of the twin, at B = 1, 3 and 11.  Returns the
    errors and phase 56's timing rows at B = 11."""
    fused, p = fused_tilt_energy_of(torch, mn)
    if fused is None:
        raise AssertionError("the float32 kozlov lane built no fused frozen-tilt energy")
    rows, csr, g, pay, k, ws = fused.tri_rows, fused.csr, fused.g, fused.payload, fused.k_vec, \
        fused.ws
    gen = torch.Generator(device=DEVICE).manual_seed(37)
    base_in, base_out = p.state.tilts_in.contiguous(), p.state.tilts_out.contiguous()

    def member_tilts(B):
        noise = torch.randn((2, B) + tuple(base_in.shape), dtype=torch.float32, device=DEVICE,
                            generator=gen)
        return (base_in + 0.01 * noise[0]).contiguous(), (base_out + 0.01 * noise[1]).contiguous()

    err, cases = 0.0, []
    for B in FT_MEMBERS:
        t_in, t_out = member_tilts(B)
        got = ft.launch_members(t_in, t_out, rows, csr, g, pay, k, ws)[0]
        singles = torch.stack([ft.launch(t_in[m].clone(), t_out[m].clone(), rows, csr, g, pay,
                                         k, ws, grad=False)[0].reshape(()) for m in range(B)])
        mapped = torch.func.vmap(fused)(t_in, t_out)
        twin = ft.reference_members(t_in, t_out, rows, csr, g, pay, k)[0]
        e = float(torch.max(torch.abs(got.double() - twin.double())))
        scale = float(torch.max(torch.abs(twin.double())))
        if not same_bits(torch, got, singles) or not same_bits(torch, mapped, got):
            raise AssertionError(f"frozen_tilt_members at B={B}: not the bits of single launches")
        if not (math.isfinite(e) and e <= ENERGY_RTOL * scale):
            raise AssertionError(f"frozen_tilt_members at B={B}: {e!r} from its twin "
                                 f"(bound {ENERGY_RTOL} x {scale!r})")
        err = max(err, e)
        cases.append({"B": B, "max_abs_err": e, "equal_to_single_launches": True})
    t_in, t_out = member_tilts(FT_MEMBER_TIMED)
    B, T = FT_MEMBER_TIMED, rows.shape[0]
    inputs, flops = (t_in, t_out, rows, g, pay, k), FLOPS_PER_TRI["frozen_tilt_energy"] * T * B
    timing_rows = [
        ("frozen_tilt_members", "kernel",
         lambda: ft.launch_members(t_in, t_out, rows, csr, g, pay, k, ws), inputs, flops),
        ("frozen_tilt_members", "twin",
         lambda: ft.reference_members(t_in, t_out, rows, csr, g, pay, k), inputs, flops),
    ]
    return {"ft_members": err, "cases": cases}, timing_rows


def compare_forms(torch, counters, label: str, mn, snap: dict, steps: int, warmup: int,
                  expect: tuple, **fields) -> tuple:
    """``steps`` ``minimize(1)`` from ``snap`` under the sequential and then the batched
    line-search form (``bench_form_steps``): a line per step and form, a summary line (with
    ``fields``), and the checks: equal accept flags, energies in bits and one digest, every
    member launch of ``expect`` made by the batched form, none by the sequential one.
    Returns (sequential, batched, per_step): ``per_step(out, key)`` is the median of ``key``
    over the steps after the first ``warmup``."""
    from membrane_solver_tpu_torch.runtime import jit_core

    forms = {"sequential": bench_form_steps(torch, counters, mn, snap, False, steps),
             "batched": bench_form_steps(torch, counters, mn, snap, True, steps)}
    for form, out in forms.items():
        for i, row in enumerate(out["rows"]):
            say(f"{label} {form} step", step=i + 1, accepted=row["accepted"],
                energy=repr(row["energy"]), ms=f"{row['ms']:.3f}", trials=row["trials"],
                syncs=row["syncs"], member_launches=json.dumps(row["member_launches"]))
    seq, bat = forms["sequential"], forms["batched"]

    def per_step(out, key):
        return statistics.median(r[key] for r in out["rows"][warmup:])

    p = mn.problem()
    say(label, vertices=p.n_vertices, triangles=p.n_tris, **fields, steps=steps,
        flags=json.dumps(bat["flags"]), flags_equal=seq["flags"] == bat["flags"],
        energies=json.dumps(bat["energies"]), energies_equal=seq["energies"] == bat["energies"],
        digest_sequential=seq["digest"], digest_batched=bat["digest"],
        equal=seq["digest"] == bat["digest"],
        ms_per_step=json.dumps({f: per_step(o, "ms") for f, o in forms.items()}),
        trials_per_step=json.dumps({f: per_step(o, "trials") for f, o in forms.items()}),
        syncs_per_step=json.dumps({f: per_step(o, "syncs") for f, o in forms.items()}),
        launches_sequential=json.dumps(seq["launches"]), launches=json.dumps(bat["launches"]),
        reduced_line_search=repr(jit_core.REDUCED_LS_FORM))
    if seq["flags"] != bat["flags"] or seq["energies"] != bat["energies"]:
        raise AssertionError(f"{label}: the forms' flags or energies differ: {seq['flags']} "
                             f"{seq['energies']} vs {bat['flags']} {bat['energies']}")
    if seq["digest"] != bat["digest"]:
        raise AssertionError(f"{label}: the forms' states differ: {seq['digest']} vs "
                             f"{bat['digest']}")
    missing = [k for k in expect if not bat["launches"].get(k, 0) > 0]
    if missing:
        raise AssertionError(f"{label}: the batched form did not launch {missing}: "
                             f"{bat['launches']}")
    if any(k.endswith("_members") and n for k, n in seq["launches"].items()):
        raise AssertionError(f"{label}: the sequential form made member launches: "
                             f"{seq['launches']}")
    return seq, bat, per_step


def phase_batched_ls(torch, ft, counters, label: str, fixture: dict, dtype) -> dict:
    """The kozlov L3 bench protocol under the sequential and the batched line search from one
    state (``compare_forms``): equal accept flags, energies in bits and one digest; per step
    and form the ms, the line-search trials, the host syncs and the member launches.  At
    float32 also ``frozen_tilt_members`` against single launches and its twin
    (``check_ft_members``)."""
    name = str(dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    mn = build_lane(torch, fixture["protocol"], dtype)
    snap = snapshot(mn)
    setup_s = time.perf_counter() - t0
    steps = WARMUP_STEPS + BATCHED_STEPS
    _seq, bat, per_step = compare_forms(torch, counters, label, mn, snap, steps, WARMUP_STEPS,
                                        BATCHED_EXPECT[name], setup_s=f"{setup_s:.3f}")
    res = {"launches": bat["launches"], "errs": {}, "timing": {},
           "per_step": {k: n / steps for k, n in bat["launches"].items()},
           "ms": per_step(bat, "ms")}
    if dtype == torch.float32:
        errs, timing_rows = check_ft_members(torch, ft, mn)
        res["errs"] = {"ft_members": errs["ft_members"]}
        say(label + " frozen_tilt_members", cases=json.dumps(errs["cases"]),
            launches_per_step=repr(res["per_step"]["frozen_tilt.energy_members"]))

        def timing_lines():
            res["timing"] = measure_members(torch, timing_rows, name)
            for rec in res["timing"].values():
                say(label + " kernel timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                                 for k, v in rec.items()})

        quiet(timing_lines)
    return res


# ----------------------------------------------------------------------
# phase 57: the reduced-energy line search's batched form against its sequential one
# ----------------------------------------------------------------------
REDUCED_BATCHED_STEPS = 3  # phase 57: minimize(1) steps per form, the first a warm-up
FT_GRAD_MEMBERS = (1, 3, 9)  # phase 57: frozen_tilt_members with the gradient vs single launches
FT_GRAD_MEMBER_TIMED = 9  # phase 57's timing row: the reduced search's nine tail candidates
# member launches the batched reduced form must make (the tail's trial energies; at float32
# also kernel 1's member launches in the member relax, energy and gradient)
REDUCED_BATCHED_EXPECT = {
    "float64": ("tri_kernels.surface_energy_members", "tri_kernels.curvature_data_members",
                "vertex_sum.vertex_sum_members"),
    "float32": ("tri_kernels.surface_energy_members", "tri_kernels.curvature_data_members",
                "vertex_sum.vertex_sum_members", "frozen_tilt.energy_members",
                "frozen_tilt.energy_grad_members")}


def member_relax_inputs(torch, ft, mn, snap: dict) -> tuple:
    """(g (B, T, 3, 3), payload (B, T, 20), the fused energy of member 0): the frozen inputs
    the batched reduced search's member relax builds for its candidates, taken from one
    ``minimize(1)`` from ``snap`` (its first member call of kernel 1 with the gradient)."""
    seen = []
    real = ft.frozen_tilt_energy_members

    def spy(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws=None):
        if not seen and t_in.requires_grad:
            seen.append((g.clone(), payload.clone(), (tri_rows, csr, k_vec, ws)))
        return real(t_in, t_out, tri_rows, csr, g, payload, k_vec, ws)

    ft.frozen_tilt_energy_members = spy
    try:
        with line_search_form(True):
            restore(mn, snap)
            mn.minimize(1)
    finally:
        ft.frozen_tilt_energy_members = real
    if not seen:
        raise AssertionError("the batched reduced search made no member call of kernel 1 with "
                             "the gradient")
    return seen[0]


def check_ft_members_grad(torch, ft, mn, snap: dict) -> tuple[dict, list]:
    """``frozen_tilt_members`` with the gradient on the member relax's own per-member g and
    payload (``member_relax_inputs``) and seeded tilts, at B = 1, 3 and 9: each member's energy
    and both vertex gradients the bits of a single ``frozen_tilt_vertex`` launch on it, within
    rel ``ENERGY_RTOL`` (the energy) and ``GRAD_RTOL`` of max|g| (the gradients) of the twin.
    Returns the errors and the timing rows at B = 9."""
    g_all, pay_all, (rows, csr, k, ws) = member_relax_inputs(torch, ft, mn, snap)
    p = mn.problem()
    gen = torch.Generator(device=DEVICE).manual_seed(57)
    base_in, base_out = p.state.tilts_in.contiguous(), p.state.tilts_out.contiguous()
    if g_all.shape[0] < max(FT_GRAD_MEMBERS):
        raise AssertionError(f"the member relax ran {g_all.shape[0]} members")

    def member_inputs(B):
        noise = torch.randn((2, B) + tuple(base_in.shape), dtype=torch.float32, device=DEVICE,
                            generator=gen)
        return ((base_in + 0.01 * noise[0]).contiguous(), (base_out + 0.01 * noise[1]).contiguous(),
                g_all[:B].contiguous(), pay_all[:B].contiguous())

    err, cases = 0.0, []
    for B in FT_GRAD_MEMBERS:
        t_in, t_out, g, pay = member_inputs(B)
        e, gin, gout = ft.launch_members(t_in, t_out, rows, csr, g, pay, k, ws, grad=True)
        singles = [ft.launch(t_in[m].clone(), t_out[m].clone(), rows, csr, g[m].clone(),
                             pay[m].clone(), k, ws, grad=True) for m in range(B)]
        for m, (e1, h_in, h_out) in enumerate(singles):
            if not (same_bits(torch, e[m:m + 1], e1) and same_bits(torch, gin[m], h_in)
                    and same_bits(torch, gout[m], h_out)):
                raise AssertionError(f"frozen_tilt_members with the gradient at B={B}: member "
                                     f"{m} is not the bits of its single launch")
        te, t_gin, t_gout = ft.reference_members(t_in, t_out, rows, csr, g, pay, k, grad=True)
        e_err = float(torch.max(torch.abs(e.double() - te.double())))
        e_scale = float(torch.max(torch.abs(te.double())))
        g_err = max(float(torch.max(torch.abs(a.double() - b.double())))
                    for a, b in ((gin, t_gin), (gout, t_gout)))
        g_scale = max(float(torch.max(torch.abs(b.double()))) for b in (t_gin, t_gout))
        if not (math.isfinite(e_err) and e_err <= ENERGY_RTOL * e_scale):
            raise AssertionError(f"frozen_tilt_members at B={B}: energy {e_err!r} from its twin "
                                 f"(bound {ENERGY_RTOL} x {e_scale!r})")
        if not (math.isfinite(g_err) and g_err <= GRAD_RTOL * g_scale):
            raise AssertionError(f"frozen_tilt_members at B={B}: gradient {g_err!r} from its "
                                 f"twin (bound {GRAD_RTOL} x {g_scale!r})")
        err = max(err, e_err, g_err)
        cases.append({"B": B, "energy_max_abs_err": e_err, "grad_max_abs_err": g_err,
                      "grad_scale": g_scale, "equal_to_single_launches": True})
    t_in, t_out, g, pay = member_inputs(FT_GRAD_MEMBER_TIMED)
    B, T = FT_GRAD_MEMBER_TIMED, rows.shape[0]
    inputs = (t_in, t_out, rows, csr.offsets, csr.slots, g, pay, k)
    flops = (FLOPS_PER_TRI["frozen_tilt_energy"] + FLOPS_PER_TRI["frozen_tilt_grad"]) * T * B
    timing_rows = [
        ("frozen_tilt_members_grad", "kernel",
         lambda: ft.launch_members(t_in, t_out, rows, csr, g, pay, k, ws, grad=True), inputs,
         flops),
        ("frozen_tilt_members_grad", "twin",
         lambda: ft.reference_members(t_in, t_out, rows, csr, g, pay, k, grad=True), inputs,
         flops),
    ]
    return {"ft_members_grad": err, "cases": cases}, timing_rows


def phase_reduced_batched_ls(torch, ft, counters, label: str, dtype, base: dict) -> dict:
    """The reduced-energy line search on kozlov L3 (phase 16's or 17's minimizer, from the
    state its determinism check saved) under the sequential and the batched form
    (``compare_forms``): equal accept flags, energies in bits and one digest; per step and form
    the ms, the trials, the host syncs and the member launches, which the batched form must
    make (at float32 kernel 1's member launches with the gradient) and the sequential form must
    not.  At float32 also ``frozen_tilt_members`` with the gradient on the member relax's own
    inputs (``check_ft_members_grad``)."""
    name = str(dtype).removeprefix("torch.")
    mn, snap = base["mn"], base["snap"]
    seq, bat, per_step = compare_forms(torch, counters, label, mn, snap, REDUCED_BATCHED_STEPS,
                                       1, REDUCED_BATCHED_EXPECT[name])
    res = {"launches": bat["launches"], "errs": {}, "timing": {},
           "per_step": {k: n / REDUCED_BATCHED_STEPS for k, n in bat["launches"].items()},
           "ms": {"sequential": per_step(seq, "ms"), "batched": per_step(bat, "ms")}}
    if dtype == torch.float32:
        errs, timing_rows = check_ft_members_grad(torch, ft, mn, snap)
        res["errs"] = {"ft_members_grad": errs["ft_members_grad"]}
        say(label + " frozen_tilt_members grad", cases=json.dumps(errs["cases"]),
            launches_per_step=repr(res["per_step"]["frozen_tilt.energy_grad_members"]))

        def timing_lines():
            res["timing"] = measure_members(torch, timing_rows, name)
            for rec in res["timing"].values():
                say(label + " kernel timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                                 for k, v in rec.items()})

        quiet(timing_lines)
    return res


# ----------------------------------------------------------------------
# phase 58: the sweeps' member line search under both forms
# ----------------------------------------------------------------------
# the stats the forms must give in bits (``trials`` counts as each single-problem form counts)
FORM_STATS = ("energy", "accepted_energy", "grad_norm", "step_size", "step_success", "converged",
              "terminated_early", "zero_step_counter", "iterations", "accepted_steps",
              "trace_z_fallbacks")


def sweep_form_run(torch, counters, problem, proto: dict, batched: bool, steps: int) -> dict:
    """The lane's sweep protocol (its members, options and step size) for ``steps`` steps under
    one member line-search form: states, stats, digest, seconds, launches (the counts set to 0
    just before and read just after), the searches' record (``member_block.SEARCH_RECORD``)
    and the run's peak GiB allocated."""
    from membrane_solver_tpu_torch.parallel import member_block
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep
    from membrane_solver_tpu_torch.runtime.jit_core import MinimizeOptions

    params, positions = sweep_members(proto, problem.state.positions.detach().cpu().numpy(),
                                      problem.params)
    with line_search_form(batched):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        member_block.SEARCH_RECORD = []
        t0 = time.perf_counter()
        try:
            states, _ss, stats = run_sweep(problem, params, steps, step_size=proto["step_size"],
                                           options=MinimizeOptions(**sweep_options(proto)),
                                           member_positions=positions)
            torch.cuda.synchronize()
        finally:
            record, member_block.SEARCH_RECORD = member_block.SEARCH_RECORD, None
        seconds = time.perf_counter() - t0
    stats = {k: np.asarray(getattr(stats, k)) for k in FORM_STATS + ("trials",)}
    return {"states": states, "stats": stats, "digest": sweep_digest(states, stats),
            "seconds": seconds, "launches": read_counts(counters), "record": record,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_sweep_forms(torch, counters, label: str, fixture: dict, dtype, base: dict) -> dict:
    """The lane's sweep from the state its sweep phase ran (``base``: that phase's problem and
    main-run digest, taken under the card's default, the batched form) under the sequential
    and then the batched member line search (``sweep_form_run``).

    Checks: every member's state fields and every stat but ``trials`` equal in
    bits under both forms, one digest, that of the sweep phase's main run;
    under each form the member surface-energy launches equal the trial-energy
    maps its searches made; the batched form makes at most three host reads a
    search; on the kozlov lane
    (every member rejects every step) every batched search scores the tail, 9
    rows a member.  Prints per form the ms a step, the host reads per block
    call, the tail's rows and chunks, the maps, the launches and the peak GiB;
    the forms' timing (``SWEEP_TIMED_STEPS`` steps each, one after the other)
    waits for the quiet stage."""
    proto = fixture["protocol"]
    problem = base["problem"]
    steps = proto["steps"]
    B = proto["members"]
    forms = {"sequential": sweep_form_run(torch, counters, problem, proto, False, steps),
             "batched": sweep_form_run(torch, counters, problem, proto, True, steps)}
    seq, bat = forms["sequential"], forms["batched"]

    def raw(x):
        return x.detach().cpu().numpy().tobytes() if hasattr(x, "detach") else x.tobytes()

    unequal = [f for f in STATE_FIELDS
               if raw(getattr(seq["states"], f)) != raw(getattr(bat["states"], f))]
    unequal += [k for k in FORM_STATS if raw(seq["stats"][k]) != raw(bat["stats"][k])]
    failed = []
    for form, out in forms.items():
        rec = out["record"]
        maps = sum(r["maps"] for r in rec)
        member_launches = {k: n for k, n in out["launches"].items()
                           if k.endswith("_members") and n}
        say(f"{label} {form}", members=B, steps=steps,
            ms_per_step=f"{out['seconds'] * 1e3 / steps:.3f}",
            searches=len(rec), host_reads_per_block_call=sum(r["reads"] for r in rec),
            host_reads_per_search=json.dumps(sorted({r["reads"] for r in rec})),
            tail_rows=sum(r["rows"] for r in rec),
            tail_rows_per_search=json.dumps([r["rows"] for r in rec]),
            tail_chunks=sum(r["chunks"] for r in rec), energy_maps=maps,
            trials=json.dumps(out["stats"]["trials"].tolist()),
            step_success=json.dumps(out["stats"]["step_success"].tolist()),
            digest=out["digest"], peak_gib=f"{out['peak_gib']:.3f}",
            member_launches=json.dumps(member_launches))
        if out["launches"]["tri_kernels.surface_energy_members"] != maps:
            failed.append(f"{form}: {out['launches']['tri_kernels.surface_energy_members']} "
                          f"member surface-energy launches for {maps} trial-energy maps")
        if {r["form"] for r in rec} != {form}:
            failed.append(f"{form}: the searches took the forms {sorted({r['form'] for r in rec})}")
    if any(r["reads"] > 3 for r in bat["record"]):
        failed.append(f"batched searches with more than three host reads: {bat['record']}")
    if base.get("tail_every_step") and not all(r["rows"] == 9 * B for r in bat["record"]):
        failed.append(f"a batched search did not score every member's tail: {bat['record']}")
    say(label, members=B, vertices=problem.n_vertices, steps=steps, equal=not unequal,
        unequal=json.dumps(unequal), digest=bat["digest"], sweep_phase_digest=base["digest"],
        equal_to_sweep_phase=bat["digest"] == base["digest"] == seq["digest"],
        host_reads_per_block_call=json.dumps({f: sum(r["reads"] for r in o["record"])
                                              for f, o in forms.items()}),
        ms_per_step=json.dumps({f: o["seconds"] * 1e3 / steps for f, o in forms.items()}),
        peak_gib=json.dumps({f: round(o["peak_gib"], 3) for f, o in forms.items()}),
        card=repr(smi_line()))
    if unequal:
        failed.append(f"the forms differ in {unequal}")
    if not bat["digest"] == base["digest"] == seq["digest"]:
        failed.append(f"digests: sequential {seq['digest']}, batched {bat['digest']}, the sweep "
                      f"phase's {base['digest']}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    res = {"launches": bat["launches"], "ms": None}

    def timing_lines():
        ms = {}
        for form, batched in (("sequential", False), ("batched", True)):
            out = sweep_form_run(torch, counters, problem, proto, batched, SWEEP_TIMED_STEPS)
            ms[form] = out["seconds"] * 1e3 / SWEEP_TIMED_STEPS
        res["ms"] = ms
        say(label + " timing", members=B, steps=SWEEP_TIMED_STEPS,
            ms_per_step=json.dumps(ms), card=repr(smi_line()))

    quiet(timing_lines)
    return res


def phase_console(torch, fixture: dict) -> None:
    """``python -m membrane_solver_tpu_torch`` on the card; the saved mesh re-evaluated at float64."""
    import tempfile

    from membrane_solver_tpu_torch import Minimizer, load_data, parse_geometry

    proto = fixture["protocol"]
    want = fixture["trace"][len(proto["recipe"]) - 1]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "cube_out.json"
        cmd = [sys.executable, "-m", "membrane_solver_tpu_torch", "--non-interactive", "-q",
               "-i", str(REPO / proto["mesh"]), "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=CONSOLE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"console run exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        mesh = parse_geometry(load_data(out))
    energy = float(Minimizer(mesh, device=DEVICE, dtype=torch.float64, quiet=True).compute_energy())
    dev = abs(energy - want["energy"]) / abs(want["energy"])
    say("10 console", command=repr(" ".join(cmd[1:])), rc=proc.returncode, seconds=f"{seconds:.3f}",
        vertices=len(mesh.vertices), facets=len(mesh.facets), energy=repr(energy),
        want=repr(want["energy"]), rel_dev=repr(dev))
    if (len(mesh.vertices), len(mesh.facets)) != (want["n_vertices"], want["n_facets"]):
        raise AssertionError(f"console run saved {len(mesh.vertices)} vertices, "
                             f"{len(mesh.facets)} facets; want {want}")
    if not dev <= F64_RTOL:
        raise AssertionError(f"console run's energy {energy!r} deviates from {want['energy']!r}")


def kernels_line(kern: dict, runs: dict) -> list:
    """The ``{"kernels": [...]}`` entries: one per entry point, every key filled."""
    out = []
    for name, (source, replaces, row, counter) in KERNELS.items():
        timing = kern["timing"]
        k_row, twin = timing[(row, "kernel")], timing[(row, "twin")]
        library = timing.get((row, "library"))
        out.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": "membrane_solver_tpu/" + replaces,
            "launches": sum(run["launches"][counter] for run in runs.values()),
            "max_abs_err": max(kern["errs"][k] for k in ERRORS[name]),
            "ms": k_row["device_ms"], "plain_ms": twin["device_ms"],
            "bound_ms": k_row["bound_ms"], "bound_by": k_row["bound_by"],
            "library_ms": None if library is None else library["device_ms"],
            "event_ms": k_row["event_ms"], "host_us": k_row["host_us"],
        })
        if name in SINGLE_OF:
            out[-1]["single_ms"] = timing[(SINGLE_OF[name], "kernel")]["device_ms"]
    return out


# Phases 4-58 run in these groups, one worker process each, side by side: the
# host drives every lane and leaves the card idle most of a step.  A group
# holds every phase whose state a later phase of it reads; within a group the
# phases run in the order of their numbers.
GROUPS = (
    ("4", "5", "15", "33", "34", "35", "53", "54", "58 kozlov"),
    ("6", "7", "8", "9", "10", "20", "36", "37", "58 vesicle"),
    ("11", "12", "13", "14", "38", "39", "40", "41"),
    ("16", "17", "21", "22", "44", "45", "57"),
    ("23", "24", "25", "42", "43", "47", "55", "56"),
    ("26", "27", "28", "29", "48", "49", "50", "51", "58 scaffold"),
    ("18", "19", "30", "31", "32", "46", "52"),
)
# what a worker sends back of each phase's result
SUMMARY_KEYS = ("launches", "syncs", "per_step", "errs", "timing", "busy_share", "ms")


def kernel_modules() -> tuple:
    """The port's three kernel modules (frozen_tilt, tri_kernels, vertex_sum)."""
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    return ft, tk, vs


def load_fixtures() -> types.SimpleNamespace:
    return types.SimpleNamespace(
        kozlov=load_fixture(KOZLOV_FIXTURE), vesicle=load_fixture(VESICLE_FIXTURE),
        cube_cli=json.loads(CUBE_CLI_FIXTURE.read_text()),
        square=json.loads(SQUARE_FIXTURE.read_text()),
        rect=json.loads(RECT_FIXTURE.read_text()),
        thetaB=json.loads(THETAB_FIXTURE.read_text()),
        reduced=load_fixture(REDUCED_FIXTURE), smooth=load_fixture(SMOOTH_FIXTURE),
        drives=json.loads(DRIVES_FIXTURE.read_text()),
        free_disk=load_fixture(FREE_DISK_FIXTURE), interface=load_fixture(INTERFACE_FIXTURE),
        match=json.loads(MATCH_FIXTURE.read_text()),
        physical_edge=load_fixture(PHYSICAL_EDGE_FIXTURE),
        scaffold=load_fixture(SCAFFOLD_FIXTURE), j0_fit=load_fixture(J0_FIT_FIXTURE),
        c4=json.loads(gzip.decompress(C4_FIXTURE.read_bytes())),
        mode_drives=json.loads(MODE_DRIVES_FIXTURE.read_text()),
        sweep=json.loads(SWEEP_FIXTURE.read_text()),
        vesicle_sweep=json.loads(VESICLE_SWEEP_FIXTURE.read_text()),
        square_sweep=json.loads(SQUARE_SWEEP_FIXTURE.read_text()),
        rect_sweep=json.loads(RECT_SWEEP_FIXTURE.read_text()),
        tilt_sweep=json.loads(TILT_SWEEP_FIXTURE.read_text()),
        interface_sweep=json.loads(INTERFACE_SWEEP_FIXTURE.read_text()),
        free_disk_sweep=json.loads(FREE_DISK_SWEEP_FIXTURE.read_text()),
        interface_drives=json.loads(INTERFACE_DRIVES_FIXTURE.read_text()),
        physical_edge_sweep=json.loads(PHYSICAL_EDGE_SWEEP_FIXTURE.read_text()),
        scaffold_sweep=json.loads(SCAFFOLD_SWEEP_FIXTURE.read_text()),
        physical_edge_drives=json.loads(PHYSICAL_EDGE_DRIVES_FIXTURE.read_text()))


def phase_timer(torch, seconds: dict, peaks: dict):
    """``timed(phase, fn, *args, **kw)``: runs ``fn``, keeps its seconds and the GiB the
    allocator reserved at its peak on the busiest card, then hands the allocator's unused
    cache back to the cards (the workers share them).  Only the calling thread writes the
    two dicts; a phase's own host threads (phase 53's groups) end inside ``fn``."""

    def timed(phase, fn, *args, **kw):
        torch.cuda.init()  # the allocator's per-card stats need CUDA initialized
        cards = range(torch.cuda.device_count())
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[phase] = round(time.perf_counter() - t0, 3)
        peaks[phase] = round(max(torch.cuda.max_memory_reserved(i) for i in cards) / 2**30, 3)
        torch.cuda.empty_cache()
        return out

    return timed


def drive_phases(torch, mods, fx, todo) -> tuple[dict, dict, dict, dict]:
    """The phases of 4-58 named in ``todo``, in order, in this process: (runs, errs, seconds,
    peak GiB).

    ``errs`` holds the largest errors of the tri-kernel checks on the lanes'
    own triangles (phases 5, 12 and 14), by key.
    """
    ft, tk, vs = mods
    counters = {"frozen_tilt": ft.LAUNCHES, "tri_kernels": tk.LAUNCHES,
                "vertex_sum": vs.LAUNCHES}
    runs, errs, seconds, peaks = {}, {}, {}, {}
    timed = phase_timer(torch, seconds, peaks)

    shared = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
              "tri_kernels.curvature_data", "tri_kernels.curvature_data_bwd",
              "vertex_sum.vertex_sum")
    kozlov_path = shared + ("tri_kernels.p1_div",)
    frozen = ("frozen_tilt.energy", "frozen_tilt.energy_grad")
    f32_kozlov_path = kozlov_path + frozen
    if "4" in todo:
        runs["k32"] = timed("4", phase_path, torch, counters, "4 kozlov_L3 f32", fx.kozlov,
                            torch.float32, f32_kozlov_path)
    if "5" in todo:
        runs["k64"] = timed("5", phase_path, torch, counters, "5 kozlov_L3 f64", fx.kozlov,
                            torch.float64, kozlov_path, f32_energies=runs["k32"]["energies"])
        timed("5 tri kernels", check_tri_sets, torch, tk, "5 kozlov_L3 tri kernels",
              kozlov_triangles(torch, runs["k64"]["mn"]), errs)
    if "6" in todo:
        runs["v32"] = timed("6", phase_path, torch, counters, "6 helfrich_cube_L5 f32",
                            fx.vesicle, torch.float32, shared)
    if "7" in todo:
        runs["v64"] = timed("7", phase_path, torch, counters, "7 helfrich_cube_L5 f64",
                            fx.vesicle, torch.float64, shared,
                            f32_energies=runs["v32"]["energies"])
    cli_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    if "8" in todo:
        runs["c32"] = timed("8", phase_cli, torch, counters, "8 cube_cli_L5 f32", fx.cube_cli,
                            torch.float32, cli_path,
                            margins_before=fx.c4["protocol"]["stop_before"])
    if "9" in todo:
        timed("9 C4", phase_c4, torch, "9 cube_cli_L5 C4", fx.c4, runs["c32"]["pre_u_margins"])
        runs["c64"] = timed("9", phase_cli, torch, counters, "9 cube_cli_L5 f64", fx.cube_cli,
                            torch.float64, cli_path, f32=runs["c32"])
    if "10" in todo:
        timed("10", phase_console, torch, fx.cube_cli)
    square_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                   "vertex_sum.vertex_sum")
    if "11" in todo:
        runs["s32"] = timed("11", phase_cli, torch, counters, "11 square_to_circle_L1 f32",
                            fx.square, torch.float32, square_path)
    if "12" in todo:
        runs["s64"] = timed("12", phase_cli, torch, counters, "12 square_to_circle_L1 f64",
                            fx.square, torch.float64, square_path, f32=runs["s32"])
        timed("12 area calls", check_area_calls, torch, tk, "12 square_to_circle_L1 area calls",
              runs["s64"]["mn"].problem(), errs)
    rect_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                 "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    if "13" in todo:
        runs["r32"] = timed("13", phase_cli, torch, counters, "13 rect_tilt_source_L0 f32",
                            fx.rect, torch.float32, rect_path, split=True)
    if "14" in todo:
        runs["r64"] = timed("14", phase_cli, torch, counters, "14 rect_tilt_source_L0 f64",
                            fx.rect, torch.float64, rect_path, f32=runs["r32"], split=True)
        for key in ("r32", "r64"):
            if runs[key]["launches"]["tri_kernels.curvature_data_bwd"]:
                raise AssertionError(f"the rect lane ran the curvature backward: "
                                     f"{runs[key]['launches']}")
        timed("14 tri kernels", check_tri_sets, torch, tk, "14 rect_tilt_source_L0 tri kernels",
              sheet_triangles(runs["r64"]["mn"].problem()), errs)
    if "15" in todo:
        runs["t64"] = timed("15 f64", phase_thetaB, torch, counters, "15 kozlov_L3_thetaB f64",
                            fx.thetaB, runs["k64"]["mn"], runs["k64"]["snap"], kozlov_path)
        runs["t32"] = timed("15 f32", phase_thetaB, torch, counters, "15 kozlov_L3_thetaB f32",
                            fx.thetaB, runs["k32"]["mn"], runs["k32"]["snap"], f32_kozlov_path,
                            f64=runs["t64"])
    # the frozen-tilt kernel inside every line-search trial's relax at float32
    if "16" in todo:
        runs["d64"] = timed("16", phase_reduced, torch, counters, "16 kozlov_L3_reduced f64",
                            fx.reduced, torch.float64, kozlov_path)
    if "17" in todo:
        runs["d32"] = timed("17", phase_reduced, torch, counters, "17 kozlov_L3_reduced f32",
                            fx.reduced, torch.float32, f32_kozlov_path, f64=runs["d64"])
    # the leaflet smoothness folded into the frozen-tilt kernel, then the drives
    if "18" in todo:
        runs["m64"] = timed("18", phase_smooth, torch, ft, counters, "18 kozlov_L3_smooth f64",
                            fx.smooth, torch.float64, kozlov_path)
    if "19" in todo:
        runs["m32"] = timed("19", phase_smooth, torch, ft, counters, "19 kozlov_L3_smooth f32",
                            fx.smooth, torch.float32, f32_kozlov_path, f64=runs["m64"])
    if "20" in todo:
        runs["x"] = timed("20", phase_drives, torch, counters, "20 kozlov_L3_drives", fx.drives)
    # the rigid free disk, the local-interface lane (dense tilt rows), the
    # family's drives
    if "21" in todo:
        runs["f64"] = timed("21", phase_free_disk, torch, counters, "21 kozlov_L3_free_disk f64",
                            fx.free_disk, torch.float64, kozlov_path)
    if "22" in todo:
        runs["f32"] = timed("22", phase_free_disk, torch, counters, "22 kozlov_L3_free_disk f32",
                            fx.free_disk, torch.float32, f32_kozlov_path, f64=runs["f64"])
    if "23" in todo:
        runs["i64"] = timed("23", phase_interface, torch, counters, "23 kozlov_L3_interface f64",
                            fx.interface, torch.float64, kozlov_path)
    if "24" in todo:
        runs["i32"] = timed("24", phase_interface, torch, counters, "24 kozlov_L3_interface f32",
                            fx.interface, torch.float32, kozlov_path, f64=runs["i64"])
    if "25" in todo:
        runs["md"] = timed("25", phase_match_drives, torch, counters,
                           "25 kozlov_L3_match_drives", fx.match)
    # the physical-edge rim placement and its scaffold-trace lane: the
    # frozen-tilt kernel on the first at float32, on neither at the scaffold
    if "26" in todo:
        runs["p64"] = timed("26", phase_physical_edge, torch, counters,
                            "26 kozlov_L3_physical_edge f64", fx.physical_edge, torch.float64,
                            kozlov_path)
    if "27" in todo:
        runs["p32"] = timed("27", phase_physical_edge, torch, counters,
                            "27 kozlov_L3_physical_edge f32", fx.physical_edge, torch.float32,
                            f32_kozlov_path, f64=runs["p64"])
    if "28" in todo:
        runs["q64"] = timed("28", phase_physical_edge, torch, counters,
                            "28 kozlov_L3_scaffold f64", fx.scaffold, torch.float64, kozlov_path,
                            forbid=frozen)
    if "29" in todo:
        runs["q32"] = timed("29", phase_physical_edge, torch, counters,
                            "29 kozlov_L3_scaffold f32", fx.scaffold, torch.float32, kozlov_path,
                            f64=runs["q64"], forbid=frozen)
    # the last per-module modes: the J0-fit lane (the frozen-tilt kernel on
    # its zeroed base rows at float32) and the mode drives
    if "30" in todo:
        runs["j64"] = timed("30", phase_j0_fit, torch, ft, counters, "30 kozlov_L3_J0_fit f64",
                            fx.j0_fit, torch.float64, kozlov_path)
    if "31" in todo:
        runs["j32"] = timed("31", phase_j0_fit, torch, ft, counters, "31 kozlov_L3_J0_fit f32",
                            fx.j0_fit, torch.float32, f32_kozlov_path, f64=runs["j64"])
    if "32" in todo:
        runs["o"] = timed("32", phase_mode_drives, torch, counters, "32 kozlov_L3_mode_drives",
                          fx.mode_drives)
    # the parameter sweep (member-axis kernels) and the multi-disk analysis
    if "33" in todo:
        runs["w64"] = timed("33", phase_sweep, torch, tk, vs, counters,
                            "33 kozlov_L3_sweep f64", fx.sweep, torch.float64,
                            runs["k64"]["snap"])
    if "34" in todo:
        runs["w32"] = timed("34", phase_sweep, torch, tk, vs, counters,
                            "34 kozlov_L3_sweep f32", fx.sweep, torch.float32,
                            runs["k32"]["snap"], f64=runs["w64"])
    if "35" in todo:
        runs["a"] = timed("35", phase_multidisk, torch, counters, "35 multidisk_sweep")
    # the sweep over the shape family: the Helfrich vesicle (accepted steps,
    # curvature data both ways, the volume rows and enforcement) and
    # square_to_circle (the hard area's member route)
    if "36" in todo:
        runs["h64"] = timed("36", phase_vesicle_sweep, torch, counters,
                            "36 helfrich_cube_L5_sweep f64", fx.vesicle_sweep, torch.float64,
                            runs["v64"]["snap"])
    if "37" in todo:
        runs["h32"] = timed("37", phase_vesicle_sweep, torch, counters,
                            "37 helfrich_cube_L5_sweep f32", fx.vesicle_sweep, torch.float32,
                            runs["v32"]["snap"], f64=runs["h64"])
    if "38" in todo:
        runs["g64"] = timed("38", phase_square_sweep, torch, tk, counters,
                            "38 square_to_circle_L1_sweep f64", fx.square_sweep,
                            runs["s64"]["mn"], runs["s64"]["snap"])
    # the sweep over the leaflet tilt-field family: the tilt-decay scan on
    # rect_tilt_source (accepted steps, the smoothness cotangents on the
    # member axis) and every module of the family mapped over members
    if "39" in todo:
        runs["e64"] = timed("39", phase_rect_sweep, torch, tk, vs, counters,
                            "39 rect_tilt_source_L0_sweep f64", fx.rect_sweep, torch.float64)
    if "40" in todo:
        runs["e32"] = timed("40", phase_rect_sweep, torch, tk, vs, counters,
                            "40 rect_tilt_source_L0_sweep f32", fx.rect_sweep, torch.float32,
                            f64=runs["e64"])
    if "41" in todo:
        runs["u"] = timed("41", phase_tilt_drives, torch, tk, vs, counters,
                          "41 kozlov_L3_sweep_tilt_drives", fx.tilt_sweep)
    # the local-interface family and the rigid disk in the sweep, from the
    # states phases 23-24 and 21-22 left; the family and the rigid disk
    # mapped over members; the visualization's face values (kernel 4)
    if "42" in todo:
        runs["n64"] = timed("42", phase_lane_sweep, torch, tk, vs, counters,
                            "42 kozlov_L3_interface_sweep f64", fx.interface_sweep,
                            torch.float64, runs["i64"]["snap"])
    if "43" in todo:
        runs["n32"] = timed("43", phase_lane_sweep, torch, tk, vs, counters,
                            "43 kozlov_L3_interface_sweep f32", fx.interface_sweep,
                            torch.float32, runs["i32"]["snap"], f64=runs["n64"])
    if "44" in todo:
        runs["y64"] = timed("44", phase_lane_sweep, torch, tk, vs, counters,
                            "44 kozlov_L3_free_disk_sweep f64", fx.free_disk_sweep,
                            torch.float64, runs["f64"]["snap"])
    if "45" in todo:
        runs["y32"] = timed("45", phase_lane_sweep, torch, tk, vs, counters,
                            "45 kozlov_L3_free_disk_sweep f32", fx.free_disk_sweep,
                            torch.float32, runs["f32"]["snap"], f64=runs["y64"])
    if "46" in todo:
        runs["z"] = timed("46", phase_interface_drives, torch, tk, vs, counters,
                          "46 kozlov_L3_sweep_interface_drives", fx.interface_drives)
    if "47" in todo:
        runs["vz"] = timed("47", phase_viz_face_values, torch, tk, counters,
                           "47 kozlov_L3_viz_face_values", runs["i64"]["mn"])
    # the physical-edge shells and the trace_z fallback in the sweep, from the
    # states phases 26-29 left; the rim placement's items mapped over members
    if "48" in todo:
        runs["pe64"] = timed("48", phase_lane_sweep, torch, tk, vs, counters,
                             "48 kozlov_L3_physical_edge_sweep f64", fx.physical_edge_sweep,
                             torch.float64, runs["p64"]["snap"], mn=runs["p64"]["mn"])
    if "49" in todo:
        runs["pe32"] = timed("49", phase_lane_sweep, torch, tk, vs, counters,
                             "49 kozlov_L3_physical_edge_sweep f32", fx.physical_edge_sweep,
                             torch.float32, runs["p32"]["snap"], f64=runs["pe64"],
                             mn=runs["p32"]["mn"])
    if "50" in todo:
        runs["sc64"] = timed("50", phase_lane_sweep, torch, tk, vs, counters,
                             "50 kozlov_L3_scaffold_sweep f64", fx.scaffold_sweep,
                             torch.float64, runs["q64"]["snap"], mn=runs["q64"]["mn"])
    if "51" in todo:
        runs["sc32"] = timed("51", phase_lane_sweep, torch, tk, vs, counters,
                             "51 kozlov_L3_scaffold_sweep f32", fx.scaffold_sweep,
                             torch.float32, runs["q32"]["snap"], f64=runs["sc64"],
                             mn=runs["q32"]["mn"])
    if "52" in todo:
        runs["pd"] = timed("52", phase_physical_edge_drives, torch, tk, vs, counters,
                           "52 kozlov_L3_sweep_physical_edge_drives", fx.physical_edge_drives)
    # placement on a list of devices: phase 33's (34's) sweep in member groups, and the
    # vertex-sharded evaluation from phase 5's (4's) state
    if "53" in todo:
        runs["pl64"] = timed("53 f64", phase_sweep_placed, torch, counters,
                             "53 kozlov_L3_sweep_placed f64", fx.sweep, torch.float64,
                             runs["w64"])
        runs["pl32"] = timed("53 f32", phase_sweep_placed, torch, counters,
                             "53 kozlov_L3_sweep_placed f32", fx.sweep, torch.float32,
                             runs["w32"])
    if "54" in todo:
        runs["tp64"] = timed("54 f64", phase_tensor_parallel, torch, counters,
                             "54 kozlov_L3_tensor_parallel f64", fx.kozlov, torch.float64,
                             runs["k64"]["snap"])
        runs["tp32"] = timed("54 f32", phase_tensor_parallel, torch, counters,
                             "54 kozlov_L3_tensor_parallel f32", fx.kozlov, torch.float32,
                             runs["k32"]["snap"])
    # the batched line search against the sequential one on the bench protocol, and the
    # frozen-tilt kernel's member axis
    if "55" in todo:
        runs["bl64"] = timed("55", phase_batched_ls, torch, ft, counters,
                             "55 kozlov_L3_batched_ls f64", fx.kozlov, torch.float64)
    if "56" in todo:
        runs["bl32"] = timed("56", phase_batched_ls, torch, ft, counters,
                             "56 kozlov_L3_batched_ls f32", fx.kozlov, torch.float32)
        errs["ft_members"] = runs["bl32"]["errs"]["ft_members"]
    # the reduced-energy line search's batched form against its sequential one, from phases
    # 16-17's states, and kernel 1's member launch with the gradient
    if "57" in todo:
        runs["rb64"] = timed("57 f64", phase_reduced_batched_ls, torch, ft, counters,
                             "57 kozlov_L3_reduced_batched_ls f64", torch.float64, runs["d64"])
        runs["rb32"] = timed("57 f32", phase_reduced_batched_ls, torch, ft, counters,
                             "57 kozlov_L3_reduced_batched_ls f32", torch.float32, runs["d32"])
        errs["ft_members_grad"] = runs["rb32"]["errs"]["ft_members_grad"]
    # the sweeps' member line search under both forms, from the states phases 33-34, 36-37
    # and 50-51 ran
    for key, lane, name, fixture, sources in (
            ("sf", "kozlov", "kozlov_L3_sweep", fx.sweep, ("w64", "w32")),
            ("sv", "vesicle", "helfrich_cube_L5_sweep", fx.vesicle_sweep, ("h64", "h32")),
            ("ss", "scaffold", "kozlov_L3_scaffold_sweep", fx.scaffold_sweep, ("sc64", "sc32"))):
        if f"58 {lane}" not in todo:
            continue
        for dtype, src in zip((torch.float64, torch.float32), sources):
            bits = str(dtype).removeprefix("torch.float")
            base = dict(runs[src], tail_every_step=lane == "kozlov")
            runs[key + bits] = timed(f"58 {lane} f{bits}", phase_sweep_forms, torch, counters,
                                     f"58 {name}_forms f{bits}", fixture, dtype, base)
    return runs, errs, seconds, peaks


def check_imports(cli: bool) -> None:
    """No JAX, no JAX package and no matplotlib in this process; with ``cli`` the CLI and
    the command layer imported (phases 8-10 import them)."""
    if cli and not ({"membrane_solver_tpu_torch.cli", "membrane_solver_tpu_torch.commands"}
                    <= set(sys.modules)):
        raise AssertionError("the CLI and the command layer were not imported")
    if "jax" in sys.modules or any(m.split(".")[0] == "membrane_solver_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    if "matplotlib" in sys.modules:
        raise AssertionError("matplotlib was imported (the card's host has none)")


def worker(index: int) -> int:
    """One group of ``GROUPS``: its phases, a ``@@ready`` line, then, at ``go`` on stdin, its
    held-back timing; last a ``@@result`` line (the phases' summaries, the errors, the
    seconds; pickled, base64)."""
    import torch

    mods = kernel_modules()
    for m in mods:
        m.build()  # the libraries phase 2 built
    group = GROUPS[index]
    runs, errs, seconds, peaks = drive_phases(torch, mods, load_fixtures(), set(group))
    check_imports(cli="8" in group)
    print("@@ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    seconds[f"quiet {index + 1}"] = round(run_quiet(), 3)
    result = {"runs": {k: {f: r[f] for f in SUMMARY_KEYS if f in r} for k, r in runs.items()},
              "errs": errs, "seconds": seconds, "peaks": peaks}
    print("@@result " + base64.b64encode(pickle.dumps(result)).decode(), flush=True)
    return 0


class Workers:
    """The worker processes of ``GROUPS``, all started at once.  Each one's output lines are
    kept apart and printed whole; every process still running is ended on the way out."""

    def __init__(self):
        # the allocator maps and unmaps its segments page by page, so the cache each
        # worker hands back between phases is not held by a few live blocks
        env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", **os.environ}
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(i)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1, env=env)
            for i in range(len(GROUPS))]
        self.lines = [[] for _ in self.procs]
        self.ready = [False] * len(self.procs)
        self.results = [None] * len(self.procs)
        self.events = [threading.Event() for _ in self.procs]
        self.threads = [threading.Thread(target=self._read, args=(i,), daemon=True)
                        for i in range(len(self.procs))]
        for t in self.threads:
            t.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        return False

    def _read(self, i: int) -> None:
        for line in self.procs[i].stdout:
            if line.startswith("@@ready"):
                self.ready[i] = True
                self.events[i].set()
            elif line.startswith("@@result "):
                self.results[i] = pickle.loads(base64.b64decode(line[len("@@result "):]))
            else:
                self.lines[i].append(line)
        self.events[i].set()

    def fail(self, i: int) -> None:
        self.print_lines()
        raise RuntimeError(f"worker {i + 1} (phases {', '.join(GROUPS[i])}) exited "
                           f"{self.procs[i].wait()}")

    def print_lines(self) -> None:
        for lines in self.lines:
            sys.stdout.write("".join(lines))
        sys.stdout.flush()

    def wait_ready(self) -> None:
        """Until every worker has finished its lanes; a worker that ended before fails."""
        while not all(self.ready):
            for i, event in enumerate(self.events):
                if event.is_set() and not self.ready[i]:
                    self.fail(i)
            time.sleep(0.2)

    def quiet_stage(self) -> list:
        """Each worker's held-back timing, one after another; returns their results."""
        for i, p in enumerate(self.procs):
            p.stdin.write("go\n")
            p.stdin.flush()
            self.threads[i].join()
            if p.wait() != 0 or self.results[i] is None:
                self.fail(i)
        return self.results


def phase_key(phase: str) -> tuple:
    head, _, rest = phase.partition(" ")
    return (int(head) if head.isdigit() else 99, rest)


def summary_lines(fx, runs: dict, seconds: dict) -> None:
    """The lines and the check that read the results of phases in different workers."""
    say("16-17 kozlov_L3_reduced", seconds=f"{seconds['16'] + seconds['17']:.3f}")
    k_steps = fx.kozlov["protocol"]["steps"] + 2 * 2 + WARMUP_STEPS + TIMED_STEPS
    for key in ("frozen_tilt.energy", "frozen_tilt.energy_grad"):
        plain, inside = runs["k32"]["launches"][key] / k_steps, runs["d32"]["per_step"][key]
        say("17 kozlov_L3_reduced f32 frozen tilt", kernel=key, per_step=repr(inside),
            phase_4_per_step=repr(plain))
        if not inside > plain:
            raise AssertionError(f"{key}: {inside} launches per step in the reduced line search, "
                                 f"not above phase 4's {plain}")
    say("19 kozlov_L3_smooth f32 fold ms", ms_per_step=f"{runs['m32']['ms']:.3f}",
        phase_4_ms_per_step=f"{runs['k32']['ms']:.3f}")
    say("18 kozlov_L3_smooth f64 host syncs", per_minimize_1=runs["m64"]["syncs"],
        phase_5_per_minimize_1=runs["k64"]["syncs"])

    def span(name, keys, **more):
        say(name, seconds=f"{sum(seconds[k] for k in keys):.3f}",
            phases=json.dumps({k: seconds[k] for k in keys}), **more)

    span("18-20", ("18", "19", "20"))
    span("21-25", ("21", "22", "23", "24", "25"))
    span("26-29", ("26", "27", "28", "29"),
         host_syncs_per_minimize_1=json.dumps({"5": runs["k64"]["syncs"],
                                               "26": runs["p64"]["syncs"],
                                               "28": runs["q64"]["syncs"]}))
    span("30-32", ("30", "31", "32"),
         host_syncs_per_minimize_1=json.dumps({"5": runs["k64"]["syncs"],
                                               "30": runs["j64"]["syncs"]}))
    span("33-35", ("33", "34", "35"), busy_share_34=runs["w32"]["busy_share"])
    span("36-38", ("36", "37", "38"),
         busy_share=json.dumps({"36": runs["h64"]["busy_share"],
                                "37": runs["h32"]["busy_share"]}))
    span("39-41", ("39", "40", "41"),
         busy_share=json.dumps({"39": runs["e64"]["busy_share"],
                                "40": runs["e32"]["busy_share"]}))
    span("42-47", ("42", "43", "44", "45", "46", "47"))
    span("48-52", ("48", "49", "50", "51", "52"))
    span("53-54", ("53 f64", "53 f32", "54 f64", "54 f32"))
    span("55-56", ("55", "56"),
         ms_per_step=json.dumps({"55": runs["bl64"]["ms"], "56": runs["bl32"]["ms"]}))
    span("57", ("57 f64", "57 f32"),
         ms_per_step=json.dumps({"f64": runs["rb64"]["ms"], "f32": runs["rb32"]["ms"]}))
    span("58", tuple(f"58 {lane} {d}" for lane in ("kozlov", "vesicle", "scaffold")
                     for d in ("f64", "f32")),
         ms_per_step=json.dumps({f"{key}{d}": runs[f"{key}{d}"]["ms"]
                                 for key in ("sf", "sv", "ss") for d in ("64", "32")}))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(int(sys.argv[2]))
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    mods = kernel_modules()
    fx = load_fixtures()
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # the workers end with this process
    seconds, peaks = {}, {}
    timed = phase_timer(torch, seconds, peaks)

    device = timed("1", phase_device, torch)
    timed("2", phase_build, mods)
    kern = timed("3", lambda: phase_kernels(
        torch, mods, build_lane(torch, fx.kozlov["protocol"], torch.float64).problem(),
        build_lane(torch, fx.vesicle["protocol"], torch.float64).problem()))
    # phases 4-58 in the workers, then the quiet stage: each worker's timing in turn
    with Workers() as pool:
        t0 = time.perf_counter()
        pool.wait_ready()
        seconds["workers' lanes"] = round(time.perf_counter() - t0, 3)
        results = pool.quiet_stage()
        seconds["quiet stage"] = round(time.perf_counter() - t0 - seconds["workers' lanes"], 3)
        pool.print_lines()
    runs = {}
    for res in results:
        runs.update(res["runs"])
        seconds.update(res["seconds"])
        peaks.update(res["peaks"])
        for k, v in res["errs"].items():
            kern["errs"][k] = max(kern["errs"].get(k, 0.0), v)
    for key in ("w64", "w32", "g64"):
        for k, v in runs[key]["errs"].items():
            kern["errs"][k] = max(kern["errs"].get(k, 0.0), v)
    for key in ("w32", "g64", "bl32", "rb32"):
        kern["timing"].update(runs[key]["timing"])
    summary_lines(fx, runs, seconds)
    check_imports(cli=False)

    say("phase seconds", seconds=json.dumps(dict(sorted(seconds.items(),
                                                        key=lambda kv: phase_key(kv[0])))))
    say("phase peak memory", gib=json.dumps(dict(sorted(peaks.items(),
                                                        key=lambda kv: phase_key(kv[0])))))
    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": kernels_line(kern, runs)}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
