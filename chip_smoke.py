#!/usr/bin/env python3
"""Smoke run of the PyTorch port (membrane_solver_tpu_torch) on one NVIDIA GPU.

Phases, each printing its own lines; any failure raises and exits non-zero:

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
   - the vertex-sum kernel, float32 and float64, widths 1 and 3, on the
     kozlov L3 corner CSR: equal to its twin bit for bit (the same
     additions in the same order);
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
    beside phase 4's.
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
    1e-3, no tilt relax, as the JAX sweep.  Per member the energies, the
    gradient norm and the step size within rel 1e-8 of the fixture, its
    accept flags and iterations, the final positions' sketch (512 sampled
    rows and the norm) within 1e-8; each member within rel 1e-12 of a
    one-member sweep of that member, with its flags; every kernel counter
    of the sweep equal to that of the one-member sweep whose line searches
    scored the most trial states (the launches do not grow with B); two
    sweeps from one state give equal sha256 digests; no ``compile_state``
    call inside the sweep.  The member-axis kernels on the members' final
    states (per-member seeded tilts): each against its member twin with
    phase 3's bounds, and member by member equal in bits to the
    single-member kernel.  Then ms per sweep step and member-steps per
    second at B = 1, 2, 4 and 8 (three steps each after a warm-up step) and
    the profiler's busy share of a three-step sweep at B = 8, each with the
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

Every lane phase (4-9, 11-19, 21-24, 26-31) also checks determinism: from the state its
protocol leaves (phases 4-7, 16-19, 21-24 and 26-31: the five steps; phases 8-9 and
11-14: the command list; phase 15: its ``minimize(3)``), it saves the state, runs
``minimize(2)`` (``g2`` through the command layer), takes a sha256 of the
positions, the tilts and the energies, restores the state and runs again;
a ``[... determinism]`` line prints both digests, and unequal digests fail
the run.  A ``[phase seconds]`` line gives each phase's seconds, and the
last line before the kernels line the whole run's.

Phases 4-9 and 11-35 each drive one path with every kernel launch counter
set to 0 just before and read just after; a kernel of that path that was
never launched fails the run (phases 33-34: the member-axis surface
energy, both variants, curvature data and its backward, divergence and
vertex sum) (the frozen-tilt entry point, both variants,
lies on the float32 kozlov paths with a frozen relax, phases 4, 15, 17, 19,
22, 27 and 31; the surface energy, both variants, and the vertex sum on phases
4-9, 11-19, 21-24 and 26-31; the curvature data forward on phases 4-9,
13-19 and 21-32 (on the cube paths through ``energy stats``), its backward
on phases 4-7, 15-19, 21-24 and 26-32; the divergence forward on the kozlov
paths 4-5, 15-19 and 21-32, and it and its tilt backward inside phase 20's
splay-twist, phase 25's ``bending_tilt`` and phase 32's bending-tilt modes).

The line before the last is a JSON object ``{"kernels": [...]}``: per entry
point, its launches over phases 4-9 and 11-35, its largest error against its twin,
and phase 3's device ms per call (``ms``), its twin's (``plain_ms``), the
bound, and, for the vertex sum, ``index_add_``'s (``library_ms``); the
member-axis entries' times are phase 34's at B = 8, float32, beside their
single-member entry's (``single_ms``).  The
card's name and power limit follow it again (``nvidia-smi``), and the
last line is ``{"ok": true, "device": {...}}``.

Usage (from the repository root, on a machine with a CUDA GPU)::

    python3 chip_smoke.py
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import gzip
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
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
}
# each member-axis entry's single-member entry (its B = 1 time sits beside it)
SINGLE_OF = {"tri_surface_energy_members": "surface_energy",
             "tri_surface_energy_grad_members": "surface_energy_grad",
             "tri_curvature_data_members": "curvature_data",
             "tri_curvature_data_bwd_members": "curvature_data_bwd",
             "tri_p1_div_members": "p1_div", "vertex_sum_members": "vertex_sum"}
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
          "tri_p1_div_members": ("p1_div_members",), "vertex_sum_members": ("vertex_sum_members",)}
# PyTorch's own kernels that the redesigned entry points must not issue
LIBRARY_KERNEL = re.compile(r"index|scatter|gather|sort|reduce", re.IGNORECASE)
OWN_KERNELS = ("frozen_tilt_kernel", "vertex_sum_kernel", "curvature_fwd_kernel",
               "curvature_bwd_kernel", "surface_kernel", "p1_div_kernel")

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
# profiled calls of a twin or a caller (hundreds of operations a call: the
# profiler's own cost grows with the operations it records); a hand
# kernel's row keeps LOOP (at 50 the profiler once saw no device operation)
PROFILED_PLAIN_CALLS = 20


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
    - ``ops_per_call`` and ``ops``: those operations, by name.
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device-side operation")
    return {
        "event_ms": start.elapsed_time(end) / calls,
        "host_us": host_s * 1e6 / calls,
        "device_ms": sum(e.self_device_time_total for e in rows) / 1e3 / profiled,
        "ops_per_call": sum(e.count for e in rows) / profiled,
        "ops": {e.key: e.count / profiled for e in rows},
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


def check_vertex_sum(torch, vs, rows, nv: int) -> float:
    """The vertex-sum kernel against its twin: equal bits, float32 and float64, widths 1 and 3."""
    from membrane_solver_tpu_torch.device.state import corner_csr

    csr = corner_csr(rows, nv)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for shape in ((rows.shape[0], 3), (rows.shape[0], 3, 3)):
            vals = torch.randn(shape, dtype=dtype, device=DEVICE, generator=gen)
            got, want = vs.launch(vals, csr), vs.reference(vals, csr)
            if not torch.equal(got, want):
                err = float(torch.max(torch.abs(got - want)))
                raise AssertionError(f"vertex_sum {dtype} {shape}: differs from its twin by {err!r}")
    return 0.0


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
    errs["vertex_sum"] = check_vertex_sum(torch, vs, kozlov.topo.tri_rows, kozlov.n_vertices)
    say("3 vertex sum", T=kozlov.n_tris, equal_to_twin=True)
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
    writes it, and the CLI loads that file.
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
        return cli.make_context(args, cli.load_mesh_interactive(args.input, interactive=False))


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

    check_repeat(torch, label, ctx.minimizer, g2)
    syncs, sites = count_syncs(torch, lambda: execute_command_line(ctx, "g1"))
    launches = read_counts(counters)
    energies = [r["energy"] for r in rows]
    out = {"energies": energies, "rows": rows, "digests": digests, "launches": launches,
           "mn": ctx.minimizer, "pre_u_margins": pre_u}
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
                 f64=None, k32=None) -> dict:
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
        kernel_vs_twin=json.dumps(errs), ms_per_step=f"{ms:.3f}",
        phase_4_ms_per_step=f"{k32['ms']:.3f}")
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


def sweep_members(protocol: dict, positions, params) -> tuple[list, list]:
    """(member_params, member_positions) of the sweep protocol, from either package's problem.

    Member m: positions times 1 + ``dilation`` m, ``tilt_modulus_in`` times
    1 + ``modulus_step`` m, ``tilt_thetaB_value`` plus ``thetaB_step`` m.
    ``positions`` is a numpy array in the problem's dtype.
    """
    k_in, theta = float(params["tilt_modulus_in"]), float(params["tilt_thetaB_value"])
    members = range(protocol["members"])
    return ([{"tilt_modulus_in": k_in * (1.0 + protocol["modulus_step"] * m),
              "tilt_thetaB_value": theta + protocol["thetaB_step"] * m} for m in members],
            [positions * (1.0 + protocol["dilation"] * m) for m in members])


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
# member m of the B-member sweep vs a one-member sweep of member m: PyTorch's
# reductions over a (B, ...) batch add in another order than over one member
# (float32: 1.8e-7 on an H100, about 1.5 ulp)
MEMBER_RTOL = {"float64": 1e-12, "float32": 2e-6}
# the member twins loop over the members (thousands of operations a call):
# fewer timed calls keep the profiler's trace small
MEMBER_PLAIN_CALLS = 3
MULTIDISK_RTOL = 1e-10  # phase 35: the card's rows vs the CPU's, float64


def _stats_of(stats) -> dict:
    return {k: np.asarray(getattr(stats, k)) for k in SWEEP_STATS}


def _stat_devs(got: dict, want: dict) -> list:
    """Per member, the largest relative deviation of the float stats."""
    out = []
    for m in range(len(got["energy"])):
        out.append(max(abs(float(got[k][m]) - float(want[k][m])) / abs(float(want[k][m]))
                       for k in ("energy", "accepted_energy", "grad_norm", "step_size")))
    return out


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
    """(unprofiled ms per step, profiler busy ms per step) of ``run()``, a SWEEP_TIMED_STEPS sweep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SWEEP_TIMED_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device-side operation")
    return wall_ms, sum(e.self_device_time_total for e in rows) / 1e3 / SWEEP_TIMED_STEPS


def phase_sweep(torch, tk, vs, counters, label: str, fixture: dict, dtype, snap: dict,
                f64=None) -> dict:
    """The parameter sweep on kozlov L3: B = 8 members of phase 5's (4's) state, one card.

    ``snap``: the state phase 5 (phase 4 at float32) left after the
    protocol's five steps, restored into a fresh L3 minimizer.  The main run
    with the counts reset just before and read just after, then the checks
    of the module docstring's phases 33-34 and the timing lines.
    """
    from membrane_solver_tpu_torch.device import state as tstate
    from membrane_solver_tpu_torch.parallel.sweep import run_sweep

    proto = fixture["protocol"]
    B = proto["members"]
    name = str(dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    mn = build_lane(torch, proto["kozlov"], dtype)
    restore(mn, snap)
    problem = mn.problem()
    setup_s = time.perf_counter() - t0
    params, positions = sweep_members(proto, problem.state.positions.detach().cpu().numpy(),
                                      problem.params)

    def run(members=range(B), steps=proto["steps"]):
        sel = list(members)
        out = run_sweep(problem, [params[m] for m in sel], steps, step_size=proto["step_size"],
                        member_positions=[positions[m] for m in sel])
        torch.cuda.synchronize()
        return out

    parts = {"setup": setup_s}
    reset_counts(counters)
    compiles0 = tstate.COMPILES["compile_state"]
    t0 = time.perf_counter()
    states, _ss, stats = run()
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
    else:
        want, want_sketches = f64["stats"], f64["sketches"]
        bound = max(F32_RTOL, 2 * fixture["float32_reference"]["max_rel_dev_vs_float64"])
        want_flags = {k: fixture["float32_reference"][k] for k in ("step_success", "iterations")}
    devs = _stat_devs(got, want)
    pos_devs = [sketch_deviation(w, g) for w, g in zip(want_sketches, sketches)]
    flags_equal = _flags_equal(got, want_flags)

    # member m against a one-member sweep of member m; the launches of the
    # one-member sweep whose line searches scored the most trial states
    single_devs, single_flags, single_launches = [], [], []
    for m in range(B):
        reset_counts(counters)
        s_states, _s, s_stats = run([m])
        single_launches.append(read_counts(counters))
        s_got = _stats_of(s_stats)
        one = {k: got[k][m:m + 1] for k in SWEEP_STATS}
        dev = max(_stat_devs(s_got, one))
        scale = max(float(torch.max(torch.abs(states.positions[m]))), 1.0)
        dev = max(dev, float(torch.max(torch.abs(s_states.positions[0] - states.positions[m])))
                  / scale)
        single_devs.append(dev)
        single_flags.append(_flags_equal(s_got, one))
    reset_counts(counters)
    parts["one_member_sweeps"] = time.perf_counter() - t0 - seconds
    t1 = time.perf_counter()
    trials = np.asarray(stats.trials)
    widest = int(np.argmax(trials))
    launches_equal = launches == single_launches[widest]

    digests = [sweep_digest(states, got)]
    r_states, _r, r_stats = run()
    digests.append(sweep_digest(r_states, _stats_of(r_stats)))
    parts["repeat"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    pos, tilts = member_kernel_inputs(torch, states, seed=29)
    errs = check_member_kernels(torch, tk, vs, problem.topo, pos, tilts, seed=31)
    parts["kernel_checks"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    timing = measure_members(torch, member_rows(torch, tk, vs, problem.topo, pos, tilts), name) \
        if dtype == torch.float32 else {}
    parts["kernel_timing"] = time.perf_counter() - t1
    t1 = time.perf_counter()

    per_size = {}
    for b in SWEEP_SIZES:
        run(range(b), steps=1)  # warm-up at this member count
        t0 = time.perf_counter()
        run(range(b), steps=SWEEP_TIMED_STEPS)
        wall = time.perf_counter() - t0
        per_size[b] = {"ms_per_step": wall * 1e3 / SWEEP_TIMED_STEPS,
                       "member_steps_per_s": b * SWEEP_TIMED_STEPS / wall}
    parts["per_size_timing"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    if dtype == torch.float32:
        wall_ms, busy_ms = sweep_busy(torch, lambda: run(range(B), steps=SWEEP_TIMED_STEPS))
    parts["busy"] = time.perf_counter() - t1
    card = smi_line()
    say(label, members=B, vertices=n, steps=proto["steps"], setup_s=f"{setup_s:.3f}",
        seconds=f"{seconds:.3f}", energy=json.dumps(got["energy"].tolist()),
        reference_energy=json.dumps(list(want["energy"])),
        step_success=json.dumps(got["step_success"].tolist()),
        reference_step_success=json.dumps(list(want_flags["step_success"])),
        iterations=json.dumps(got["iterations"].tolist()),
        trials=json.dumps(trials.tolist()), max_rel_dev=repr(max(devs)),
        max_position_dev=repr(max(pos_devs)), bound=repr(bound),
        reference="the JAX fixture" if f64 is None else "the float64 phase",
        compiles_after_entry=compiles, launches=json.dumps(launches),
        parts_s=json.dumps({k: round(v, 3) for k, v in parts.items()}))
    say(label + " members", max_rel_dev_vs_single=repr(max(single_devs)),
        bound=MEMBER_RTOL[name],
        flags_equal=json.dumps(single_flags), widest_member=widest,
        launches_equal_to_one_member=launches_equal,
        one_member_launches=json.dumps(single_launches[widest]))
    say(label + " determinism", first=digests[0], second=digests[1],
        equal=digests[0] == digests[1])
    say(label + " kernels", **{k: repr(v) for k, v in errs.items()})
    for b, rec in per_size.items():
        say(label + " timing", members=b, ms_per_step=f"{rec['ms_per_step']:.3f}",
            member_steps_per_s=f"{rec['member_steps_per_s']:.3f}", card=repr(card))
    if dtype == torch.float32:
        say(label + " busy", members=B, steps=SWEEP_TIMED_STEPS, ms_per_step=f"{wall_ms:.3f}",
            busy_ms_per_step=f"{busy_ms:.3f}", busy_share=f"{busy_ms / wall_ms:.4f}",
            card=repr(card))
    for rec in timing.values():
        say(label + " kernel timing", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                                         for k, v in rec.items()})
    missing = [k for k in SWEEP_EXPECT if not launches[k] > 0]
    if missing:
        raise AssertionError(f"{label}: the path did not launch {missing}: {launches}")
    if not flags_equal:
        raise AssertionError(f"{label}: accept flags or iterations differ from the reference")
    if not (max(devs) <= bound and max(pos_devs) <= bound):
        raise AssertionError(f"{label}: members deviate from the reference by {max(devs)!r} "
                             f"(positions {max(pos_devs)!r}), bound {bound!r}")
    if not (all(single_flags) and max(single_devs) <= MEMBER_RTOL[name]):
        raise AssertionError(f"{label}: members differ from their one-member sweeps: "
                             f"{single_devs} {single_flags}")
    if not launches_equal:
        raise AssertionError(f"{label}: the {B}-member sweep launched {launches}, the one-member "
                             f"sweep of member {widest} {single_launches[widest]}")
    if digests[0] != digests[1]:
        raise AssertionError(f"{label}: two sweeps from one state differ: {digests}")
    if compiles != 0:
        raise AssertionError(f"{label}: {compiles} compile_state calls inside the sweep")
    return {"launches": launches, "stats": got, "sketches": sketches, "errs": errs,
            "timing": timing, "per_size": per_size,
            "busy_share": busy_ms / wall_ms if dtype == torch.float32 else None}


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


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from membrane_solver_tpu_torch.kernels import frozen_tilt as ft
    from membrane_solver_tpu_torch.kernels import tri_kernels as tk
    from membrane_solver_tpu_torch.kernels import vertex_sum as vs

    kozlov = load_fixture(KOZLOV_FIXTURE)
    vesicle = load_fixture(VESICLE_FIXTURE)
    cube_cli = json.loads(CUBE_CLI_FIXTURE.read_text())
    square = json.loads(SQUARE_FIXTURE.read_text())
    rect = json.loads(RECT_FIXTURE.read_text())
    thetaB = json.loads(THETAB_FIXTURE.read_text())
    reduced = load_fixture(REDUCED_FIXTURE)
    smooth = load_fixture(SMOOTH_FIXTURE)
    drives = json.loads(DRIVES_FIXTURE.read_text())
    free_disk = load_fixture(FREE_DISK_FIXTURE)
    interface = load_fixture(INTERFACE_FIXTURE)
    match = json.loads(MATCH_FIXTURE.read_text())
    physical_edge = load_fixture(PHYSICAL_EDGE_FIXTURE)
    scaffold = load_fixture(SCAFFOLD_FIXTURE)
    j0_fit = load_fixture(J0_FIT_FIXTURE)
    c4 = json.loads(gzip.decompress(C4_FIXTURE.read_bytes()))
    mode_drives = json.loads(MODE_DRIVES_FIXTURE.read_text())
    sweep = json.loads(SWEEP_FIXTURE.read_text())
    seconds = {}

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[phase] = round(time.perf_counter() - t0, 3)
        return out

    device = timed("1", phase_device, torch)
    timed("2", phase_build, (ft, tk, vs))
    kern = timed("3", lambda: phase_kernels(
        torch, (ft, tk, vs), build_lane(torch, kozlov["protocol"], torch.float64).problem(),
        build_lane(torch, vesicle["protocol"], torch.float64).problem()))

    counters = {"frozen_tilt": ft.LAUNCHES, "tri_kernels": tk.LAUNCHES,
                "vertex_sum": vs.LAUNCHES}
    shared = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
              "tri_kernels.curvature_data", "tri_kernels.curvature_data_bwd",
              "vertex_sum.vertex_sum")
    kozlov_path = shared + ("tri_kernels.p1_div",)
    f32_kozlov_path = kozlov_path + ("frozen_tilt.energy", "frozen_tilt.energy_grad")
    runs = {}
    runs["k32"] = timed("4", phase_path, torch, counters, "4 kozlov_L3 f32", kozlov,
                        torch.float32, f32_kozlov_path)
    runs["k64"] = timed("5", phase_path, torch, counters, "5 kozlov_L3 f64", kozlov,
                        torch.float64, kozlov_path, f32_energies=runs["k32"]["energies"])
    timed("5 tri kernels", check_tri_sets, torch, tk, "5 kozlov_L3 tri kernels",
          kozlov_triangles(torch, runs["k64"]["mn"]), kern["errs"])
    runs["v32"] = timed("6", phase_path, torch, counters, "6 helfrich_cube_L5 f32", vesicle,
                        torch.float32, shared)
    runs["v64"] = timed("7", phase_path, torch, counters, "7 helfrich_cube_L5 f64", vesicle,
                        torch.float64, shared, f32_energies=runs["v32"]["energies"])
    cli_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    runs["c32"] = timed("8", phase_cli, torch, counters, "8 cube_cli_L5 f32", cube_cli,
                        torch.float32, cli_path, margins_before=c4["protocol"]["stop_before"])
    timed("9 C4", phase_c4, torch, "9 cube_cli_L5 C4", c4, runs["c32"]["pre_u_margins"])
    runs["c64"] = timed("9", phase_cli, torch, counters, "9 cube_cli_L5 f64", cube_cli,
                        torch.float64, cli_path, f32=runs["c32"])
    timed("10", phase_console, torch, cube_cli)
    square_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                   "vertex_sum.vertex_sum")
    runs["s32"] = timed("11", phase_cli, torch, counters, "11 square_to_circle_L1 f32", square,
                        torch.float32, square_path)
    runs["s64"] = timed("12", phase_cli, torch, counters, "12 square_to_circle_L1 f64", square,
                        torch.float64, square_path, f32=runs["s32"])
    timed("12 area calls", check_area_calls, torch, tk, "12 square_to_circle_L1 area calls",
          runs["s64"]["mn"].problem(), kern["errs"])
    rect_path = ("tri_kernels.surface_energy", "tri_kernels.surface_energy_grad",
                 "tri_kernels.curvature_data", "vertex_sum.vertex_sum")
    runs["r32"] = timed("13", phase_cli, torch, counters, "13 rect_tilt_source_L0 f32", rect,
                        torch.float32, rect_path, split=True)
    runs["r64"] = timed("14", phase_cli, torch, counters, "14 rect_tilt_source_L0 f64", rect,
                        torch.float64, rect_path, f32=runs["r32"], split=True)
    for key in ("r32", "r64"):
        if runs[key]["launches"]["tri_kernels.curvature_data_bwd"]:
            raise AssertionError(f"the rect lane ran the curvature backward: {runs[key]['launches']}")
    timed("14 tri kernels", check_tri_sets, torch, tk, "14 rect_tilt_source_L0 tri kernels",
          sheet_triangles(runs["r64"]["mn"].problem()), kern["errs"])
    runs["t64"] = timed("15 f64", phase_thetaB, torch, counters, "15 kozlov_L3_thetaB f64",
                        thetaB, runs["k64"]["mn"], runs["k64"]["snap"], kozlov_path)
    runs["t32"] = timed("15 f32", phase_thetaB, torch, counters, "15 kozlov_L3_thetaB f32",
                        thetaB, runs["k32"]["mn"], runs["k32"]["snap"], f32_kozlov_path,
                        f64=runs["t64"])
    # the frozen-tilt kernel inside every line-search trial's relax at float32
    runs["d64"] = timed("16", phase_reduced, torch, counters, "16 kozlov_L3_reduced f64",
                        reduced, torch.float64, kozlov_path)
    runs["d32"] = timed("17", phase_reduced, torch, counters, "17 kozlov_L3_reduced f32",
                        reduced, torch.float32, f32_kozlov_path, f64=runs["d64"])
    say("16-17 kozlov_L3_reduced", seconds=f"{seconds['16'] + seconds['17']:.3f}")
    k_steps = kozlov["protocol"]["steps"] + 2 * 2 + WARMUP_STEPS + TIMED_STEPS
    for key in ("frozen_tilt.energy", "frozen_tilt.energy_grad"):
        plain, inside = runs["k32"]["launches"][key] / k_steps, runs["d32"]["per_step"][key]
        say("17 kozlov_L3_reduced f32 frozen tilt", kernel=key, per_step=repr(inside),
            phase_4_per_step=repr(plain))
        if not inside > plain:
            raise AssertionError(f"{key}: {inside} launches per step in the reduced line search, "
                                 f"not above phase 4's {plain}")
    # the leaflet smoothness folded into the frozen-tilt kernel, then the drives
    runs["m64"] = timed("18", phase_smooth, torch, ft, counters, "18 kozlov_L3_smooth f64",
                        smooth, torch.float64, kozlov_path)
    runs["m32"] = timed("19", phase_smooth, torch, ft, counters, "19 kozlov_L3_smooth f32",
                        smooth, torch.float32, f32_kozlov_path, f64=runs["m64"], k32=runs["k32"])
    say("18 kozlov_L3_smooth f64 host syncs", per_minimize_1=runs["m64"]["syncs"],
        phase_5_per_minimize_1=runs["k64"]["syncs"])
    runs["x"] = timed("20", phase_drives, torch, counters, "20 kozlov_L3_drives", drives)
    say("18-20", seconds=f"{seconds['18'] + seconds['19'] + seconds['20']:.3f}",
        phases=json.dumps({k: seconds[k] for k in ("18", "19", "20")}))
    # the rigid free disk, the local-interface lane (dense tilt rows), the
    # family's drives
    runs["f64"] = timed("21", phase_free_disk, torch, counters, "21 kozlov_L3_free_disk f64",
                        free_disk, torch.float64, kozlov_path)
    runs["f32"] = timed("22", phase_free_disk, torch, counters, "22 kozlov_L3_free_disk f32",
                        free_disk, torch.float32, f32_kozlov_path, f64=runs["f64"])
    runs["i64"] = timed("23", phase_interface, torch, counters, "23 kozlov_L3_interface f64",
                        interface, torch.float64, kozlov_path)
    runs["i32"] = timed("24", phase_interface, torch, counters, "24 kozlov_L3_interface f32",
                        interface, torch.float32, kozlov_path, f64=runs["i64"])
    runs["md"] = timed("25", phase_match_drives, torch, counters, "25 kozlov_L3_match_drives",
                       match)
    new = ("21", "22", "23", "24", "25")
    say("21-25", seconds=f"{sum(seconds[k] for k in new):.3f}",
        phases=json.dumps({k: seconds[k] for k in new}))
    # the physical-edge rim placement and its scaffold-trace lane: the
    # frozen-tilt kernel on the first at float32, on neither at the scaffold
    frozen = ("frozen_tilt.energy", "frozen_tilt.energy_grad")
    runs["p64"] = timed("26", phase_physical_edge, torch, counters,
                        "26 kozlov_L3_physical_edge f64", physical_edge, torch.float64,
                        kozlov_path)
    runs["p32"] = timed("27", phase_physical_edge, torch, counters,
                        "27 kozlov_L3_physical_edge f32", physical_edge, torch.float32,
                        f32_kozlov_path, f64=runs["p64"])
    runs["q64"] = timed("28", phase_physical_edge, torch, counters, "28 kozlov_L3_scaffold f64",
                        scaffold, torch.float64, kozlov_path, forbid=frozen)
    runs["q32"] = timed("29", phase_physical_edge, torch, counters, "29 kozlov_L3_scaffold f32",
                        scaffold, torch.float32, kozlov_path, f64=runs["q64"], forbid=frozen)
    new = ("26", "27", "28", "29")
    say("26-29", seconds=f"{sum(seconds[k] for k in new):.3f}",
        phases=json.dumps({k: seconds[k] for k in new}),
        host_syncs_per_minimize_1=json.dumps({"5": runs["k64"]["syncs"], "26": runs["p64"]["syncs"],
                                              "28": runs["q64"]["syncs"]}))
    # the last per-module modes: the J0-fit lane (the frozen-tilt kernel on
    # its zeroed base rows at float32) and the mode drives
    runs["j64"] = timed("30", phase_j0_fit, torch, ft, counters, "30 kozlov_L3_J0_fit f64",
                        j0_fit, torch.float64, kozlov_path)
    runs["j32"] = timed("31", phase_j0_fit, torch, ft, counters, "31 kozlov_L3_J0_fit f32",
                        j0_fit, torch.float32, f32_kozlov_path, f64=runs["j64"])
    runs["o"] = timed("32", phase_mode_drives, torch, counters, "32 kozlov_L3_mode_drives",
                      mode_drives)
    new = ("30", "31", "32")
    say("30-32", seconds=f"{sum(seconds[k] for k in new):.3f}",
        phases=json.dumps({k: seconds[k] for k in new}),
        host_syncs_per_minimize_1=json.dumps({"5": runs["k64"]["syncs"],
                                              "30": runs["j64"]["syncs"]}))
    # the parameter sweep (member-axis kernels) and the multi-disk analysis
    runs["w64"] = timed("33", phase_sweep, torch, tk, vs, counters, "33 kozlov_L3_sweep f64",
                        sweep, torch.float64, runs["k64"]["snap"])
    runs["w32"] = timed("34", phase_sweep, torch, tk, vs, counters, "34 kozlov_L3_sweep f32",
                        sweep, torch.float32, runs["k32"]["snap"], f64=runs["w64"])
    runs["a"] = timed("35", phase_multidisk, torch, counters, "35 multidisk_sweep")
    for key in ("w64", "w32"):
        for k, v in runs[key]["errs"].items():
            kern["errs"][k] = max(kern["errs"].get(k, 0.0), v)
    kern["timing"].update(runs["w32"]["timing"])
    new = ("33", "34", "35")
    say("33-35", seconds=f"{sum(seconds[k] for k in new):.3f}",
        phases=json.dumps({k: seconds[k] for k in new}),
        busy_share_34=runs["w32"]["busy_share"])
    # phases 8-10 have imported the CLI and the command layer by now
    if not {"membrane_solver_tpu_torch.cli", "membrane_solver_tpu_torch.commands"} <= set(sys.modules):
        raise AssertionError("the CLI and the command layer were not imported")
    if "jax" in sys.modules or any(m.split(".")[0] == "membrane_solver_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    say("phase seconds", seconds=json.dumps(seconds))
    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": kernels_line(kern, runs)}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
