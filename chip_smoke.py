#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``cup3d_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda) and the
repo checkout; it imports nothing of JAX or of the JAX package.  Phases,
each of which raises on a fault (nothing is caught):

1. versions, the card's name and power limit, the TF32 flags;
2. build the CUDA kernels from ``cup3d_tpu_torch/csrc`` with nvcc (timed),
   and the native lab-table builder (``csrc/tables.cpp``) with g++;
3. each of the five fused-BiCGSTAB kernels at the main path's shape
   (256^3, T = 32768 tiles, f32) against its plain PyTorch version on the
   same seeded inputs (update also on its breakdown branch; lap on the
   periodic grid, reading its neighbour faces from w, its Aw bitwise the
   plain version's), then timed with CUDA events and by torch.profiler
   (device time a launch) beside the plain version and its bound, lap
   also beside its library call (one conv3d of the 7-point stencil on
   the grid layout and the two dots);
4. one whole Poisson solve at 64^3, kernels against plain versions; the
   device kernels a fused iteration launches, by profile, on the
   periodic grid and on config #5's BCs (walls in y);
5. the uniform main path through the CLI entry: ``build_driver``,
   ``init()``, ``simulate()`` of the 256^3 Taylor-Green vortex with the
   iterative solver and ``CUP3D_FUSED=1`` for 20 steps, with the
   kernels' launch counters set to 0 just before and read just after;
   then a few steps with a synchronise after each operator for the
   step's time split, and a few under ``torch.profiler`` for the
   device's busy share and its time by kernel name;
6. the AMR path's set-up through the CLI entry: ``build_driver`` of
   BASELINE config #3 (Taylor-Green on a 2-level forest, bpd 16: a 128^3
   base whose vortex cores refine to 256^3-equivalent) and ``init()``
   (its adaptation rounds and table builds, timed), then the mesh is
   frozen (``adapt_enabled = False``), as the static config defines; the
   forest is capacity-bucketed (the default, as the JAX package's):
   9,472 blocks padded to 9,625;
7. each of the five forest-BiCGSTAB kernels at that forest's block count
   (its capacity: inputs 0 on the padding rows, each output's padding
   rows exactly 0 after each launch) against its plain version (labs and
   reflux increments assembled from the forest's own tables), timed
   beside the plain version and its bound;
   B9 also at a ragged block count and rerun bitwise, beside its library
   call and its time before its redesign;
8. one whole forest solve, kernels against plain versions, and the same
   kernel solve twice (bitwise-equal answers);
9. the AMR main path: ``simulate()`` for 20 steps with the ``amr_*``
   launch counters set to 0 just before and read just after, then the
   solve's synchronised per-piece split and a ``torch.profiler`` window;
   then the forest window: 2 more steps in one capture window of the
   port's attribution (``obs/profile.CONTROLLER.capture()``), its
   BiCGSTAB sections (B8, B9, B11-B13) each above zero, no telemetry
   failure, the sum invariant, and the kernel names each section caught;
10. the tile-only getZ kernels B3 (at 256^3) and B10 (at the forest's
    block count) and the CG getZ kernel B7 (at 256^3, lanes layout, with
    a zero and a random per-tile shift) against their plain versions,
    timed beside them and their bounds, B3 and B10 beside their library
    calls;
11. the uniform self-healing loop: the 256^3 TGV through ``build_driver``
    + ``simulate()`` with ``CUP3D_FAULT=solver.itercap@2:3``, so the
    recovery engine walks warm-restart -> zero-guess -> tile-only and the
    rebuilt fused solve runs B3 (its launches twice the iterations
    executed after the rebuild, no getz_two there); kinetic energy held
    to phase 5's at the same simulated time;
12. the forest's: phase 9's driver on with the same fault plan, at least
    3 steps past the tile-only rung (B10), the restore reusing the live
    forest's tables;
13. ``CUP3D_GETZ=cg``: 5 steps of the 256^3 TGV through the CLI's legacy
    composition (B7's launches equal the preconditioner applications),
    then one uniform (256^3) and one forest CG-getZ solve, kernels
    against plain versions (iterations +-1, x within 1e-4 relative);
14. the fish main path, BASELINE config #2 (bench.py bench_fish_uniform:
    one self-propelled StefanFish on a uniform 128^3 grid, iterative
    Poisson 1e-6/1e-4, non-pipelined, ``CUP3D_FUSED=1``): first the five
    uniform kernels against their plain versions at its shape (T = 4096
    tiles), then ``build_driver`` + ``init()`` + ``simulate()`` for
    FISH_STEPS steps with the launch counters set to 0 just before and
    read just after (each equal to the executed iterations times its
    launches per iteration); the body volume sum(chi) of the first
    step's CreateObstacles held against the port's own on the CPU
    (1e-5 relative), max|div u| in the fluid against the JAX bench's
    fish gate, the fields and the fish's velocity and position finite;
    one step with torch's sync debug mode raising inside the body and
    fluid operators; the fish's surface-point record dumped
    (``ops/surface.dump_surface_points``: rows finite, their traction sum
    the step's force QoI within 1e-3); then the operator split,
    CreateObstacles in pieces and a profiler window;
15. the block-sharded forest: BASELINE config #3 as
    ``AMRSimulation(cfg, mesh=make_block_mesh([cuda] * SHARDS))`` with
    ``CUP3D_RING_HALO=1`` (init's adaptation rounds each a re-shard, then
    the mesh frozen); the ring-step kernel B14 against its plain
    version, bitwise, at every exchange size of the config, an odd byte
    count, misaligned slices, strided slab slices read in place and each
    exchange's all-to-all landing in a view, timed beside ``torch.roll``,
    and one whole exchange (one launch, the kernels on its profile
    counted) beside D one-step launches and the axis swap;
    the unsharded, unpadded (``CUP3D_BUCKET=0``) port forest of the same
    state through the same static tile-only solve as the reference: the first RK3 stage bitwise, one
    solve (iterations in the reference's range under 1e-7 noise, +-1;
    x within 1e-5 when both are solved to 1e-6 relative), 2 steps on the
    ring and on the axis-swap transport bitwise, then SHARD_STEPS steps
    through ``simulate()`` with B14's counter set to 0 just before and
    read just after (velocity within 5e-3 of the reference's), the step
    split, a profiler window and the sharded lanes Laplacian at 256^3
    (1e-5 of max |ref|);
16. BASELINE config #2 as the bench runs it (bench.py bench_fish_uniform
    and _megaloop_split): ``build_driver`` with ``-pipelined 1`` for
    FISH_STEPS steps (launch counters against the executed iterations,
    the QoI stream's counters printed), then ``-scan_k 8``: K = 8
    megaloops from the start, 2 untimed and 4 timed in each of a
    synchronised and a back-to-back window (wall/device ratio, launch
    counters against the executed iterations), the device midline's time
    alone and a profiler window over one megaloop; K = 1 against K = 8
    over 16 steps (mean KE within 1e-6 relative); the fluid's max|div u|
    under the fish gate and the fields, transVel and position finite
    after each run; the ms/step of phase 14's non-pipelined step, the
    pipelined step and the megaloop side by side; then the 256^3 TGV
    through ``-pipelined 1 -scan_k 8`` for 16 steps beside phase 5's
    ms/step;
17. BASELINE config #5 (bench.py bench_channel: 128x64x64, walls in y,
    uMax_forced 0.5, bFixMassFlux, iterative Poisson 1e-6/1e-4) through
    ``build_driver`` under ``CUP3D_FUSED=1``: B2 and B4 against their
    plain versions on its wall-bounded lanes (T = 1,024, reruns bitwise;
    B4's Aw bitwise at f32 and bf16),
    the bench's window (3 warm-up steps, 10 timed: ms/step, iterations a
    step, max|div u| under phase 5's gate, the flux.txt bulk velocity
    within 5% of its target); the bench's state stays a streamwise u(y)
    whose solves converge at iteration 0, so the kernels' launches on the
    walls are counted on a run from a seeded divergent state, its
    velocity held to the legacy solve's from the same state (1e-3 of
    max|u|, iterations +-1);
18. the output path on config #5: two dumps through the async sharded
    writer, their bytes equal to the single writer's of the same fields;
    an injected ``dump.write_fail`` (dropped and counted, the run goes
    on); the step time with and without a dump in a 10-step window; an
    async checkpoint of the perturbed run restored and resumed bitwise;
19. ``-implicitDiffusion 1`` on phase 5's 256^3 TGV for 10 steps (KE
    finite and decaying, max|div u| under phase 5's gate);
20. ``-initCond vorticity`` at 128^3: the init's time and max|div u|;
21. bodies on config #2's 128^3 box: the two StefanFish of run.sh for 20
    non-pipelined steps (the collision pass's pair checks and collisions
    counted), a towed sphere and a towed NACA foil for 10 steps each,
    launch counters against the executed iterations, the fluid's
    max|div u| under the fish gate, fields and kinematics finite;
22. BASELINE config #4 (bench.py bench_two_fish_amr, run.sh's flags: two
    StefanFish on the adapting forest, levelMax 4, levelStart 3) on the
    host path under ``CUP3D_FUSED=1`` through ``build_driver``:
    ``init()`` (every interface block at level 3), the bench's first
    step, 8 warm-up and 12 timed steps (the bench's 24 and 20, cut) with
    the forest kernels'
    counters set to 0 just before and read just after (each equal to the
    executed iterations times its launches per iteration), per step the
    blocks, the levels, the regrids, the iterations and the ms; the
    window's ms/step as the bench takes it (trimmed mean); the fluid's
    max|div u| under the bench's 0.01, both fish finite and moving; the
    step's split by section and a profiler window; B8, B9, B11-B13
    against their plain versions on its forest and rerun bitwise; 5
    steps of the fused solve against the legacy one from one state
    (iterations +-1, velocity within 1e-4 of max|u|);
    ``CUP3D_FAULT=solver.itercap`` on the same driver (B10 on the
    tile-only rung, both fish restored at each rollback); an async
    checkpoint with both fish resumed bitwise.  Then one StefanFish towed
    through the same forest for 45 steps: its regrids after step 10
    change the block count, the kernels' launches against its executed
    iterations, and the five against their plain versions (rerun
    bitwise) on the topology of its last regrid.

23. BASELINE config #3 as the bench runs it (bench.py bench_amr_tgv:
    ``-pipelined 1``, the mesh frozen after init, on the device dt chain
    on the card): the bench's first step, 4 warm-up (the bench's 9, cut)
    and 10 timed steps
    (the trimmed mean of its _time_steps_robust) beside phase 9's host
    path, with the forest kernels' counters set to 0 just before and
    read just after (each equal to the executed iterations times its
    launches per iteration); max|div u| under 0.05; the QoI stream's
    bytes (streamed and staged) and stall, a profiler window; the
    bench's regrid probe (adaptation on, 2 warm-up and 22 timed steps,
    steady and regrid steps apart, blocks, regrids, the scores
    prefetch's hits and misses); 5 fixed-dt steps pipelined and on the
    host path from one state, kinetic energy within 1e-4 relative; the
    host path's step in the same window from the same state;
24. BASELINE config #4 as the bench runs it (bench.py bench_two_fish_amr,
    ``-pipelined 1``: the bodies' rigid state chained on the device):
    the bench's first step, 8 warm-up and 12 timed steps beside phase
    22's host path, the launches against the executed iterations, the
    fluid's max|div u| under 0.01, the collision fallbacks taken, the
    stream's reads and stalls; one forest solve on
    the pressure RHS of the run's last state, B8, B9, B11-B13 against
    their plain versions, and their reruns bitwise;
25. the forest's physics at smaller depths: a walled forest channel
    (128x64x64 cells at level 1, FixMassFlux at uMax_forced 0.5, fixed
    dt) on the host path and pipelined, the bulk velocity within 5% of
    its target and the two paths' flux.txt rows equal; config #3's
    forest at bpd 4 with ``-implicitDiffusion 1`` under
    ``CUP3D_GETZ=cg`` from a perturbed state: B7 with the per-block
    shift column against its plain version on the Helmholtz's own input,
    the Helmholtz iterations a component, B7's launches twice the
    executed Krylov iterations; the vorticity IC on a 2-level forest
    (its init time and max|div u|); the obstacle-free pipelined step on
    4 shards of the card under ``CUP3D_RING_HALO=1`` (config #3's forest
    at bpd 8, 5 fixed-dt steps): bitwise the sharded host path, within
    5e-3 of the unsharded pipelined forest, B14's launches a step;
26. bf16 Krylov storage (``CUP3D_KRYLOV_DTYPE=bf16``): the twelve bf16
    kernels (B1-B6 at 256^3, B8-B13 on config #3's forest of phase 6,
    built again under bf16) against their bf16 plain versions on the same
    seeded inputs by the stage rule (BF16_BITWISE; B1/B8 on the breakdown
    branch too; the getZ kernels also their f32 twin rounded, on every
    cell, B9 by that alone), timed beside their plain versions, their f32
    twins on the same values in the same call and their bounds (from the
    port's ``bytes_model``); one 64^3 bf16
    solve, kernels against plain versions (iterations +-1, x within
    1e-2, the reported residual at the target, ||b - A x|| printed); the
    tile-only bf16 kernels on the entry points: config #2 at 128^3 (B3)
    and config #4 (B10) under ``CUP3D_COARSE=0``, launches against the
    executed iterations, then config #2's first system (held to
    tests/data/config2_128_first_rhs.npz) solved tile-only at f32 and
    bf16, kernels and plain versions, on 8 noisy copies: the bf16
    breakdowns counted (the JAX package's solve of it breaks down too,
    tests/test_torch_bf16_tile.py), the f32 solves converged, every bf16
    kernel solve's best x within 1e-2 of the f32 x;
27. config #2 as the bench's fish256 (256^3, pipelined, through
    ``build_driver`` and ``simulate()``) for 8 steps (12 before, cut)
    from the initial state at bf16 and at f32, each at ``CUP3D_FUSED``'s default (the
    fused bf16 kernels; the legacy f32 composition), then at f32 on the
    fused kernels: ms/step, the device's busy share, iterations a solve
    (bf16 at most f32's + 10), launches against the executed iterations,
    the fluid's max|div u| under the bench's 0.07, the Krylov gauges;
28. config #3 under bf16: phase 23's main path (the first step, 9
    warm-up and 10 timed, pipelined on the device dt chain) with the bf16
    forest kernels' launches against the executed iterations and max|div
    u| under 0.05, beside phase 23's f32 run; phase 15's 4-shard forest
    under bf16, whose static solver takes the JAX package's route (the
    legacy composition at f32), held to the unsharded static solve (x
    within 1e-5 at 1e-6 relative), the unsharded forest's fused bf16
    solve at its maxiter beside it (its best x within 1e-2 of the sharded
    solve's, its iterations and residual printed), and B14 moving bf16
    bitwise as its plain copy;
29. the bucketed forest: config #3 as the bench runs it under
    ``CUP3D_BUCKET=0`` (phase 23's run without its profiler window and
    host-path comparisons) beside phase 23's bucketed run of the same
    call: ms/step, the regrid probe's steady p95 and regrid_wall_max_s,
    capacity against blocks, the table memo's hits and misses
    (``bucket.*`` metrics), the bytes each adaptation read for its
    decision (int8 tags a slot against the score fields), the
    iterations of each step within +-1; then B8, B9, B11-B13 at the
    unpadded forest's block count (their rows' ``unpadded`` times);
    configs #4 (phases 22, 24) and the towed fish report the same
    bucket state (fields at capacity, padding rows exactly 0);
30. config #3's set-up with the numpy lab-table builder
    (``CUP3D_NO_NATIVE=1``) beside phase 6's native one, and the final
    forest's width-1 lab tables from both builders timed and bitwise
    equal;
31. bench.py bench_mesh2d as the bench runs it: the TGV (bs 16,
    spectral, nu 0.02, CFL 0.3, pipelined, K = 8) through ``Simulation``
    at 64^3 and at 256^3, solo and under ``CUP3D_MESH_X=4`` (the
    megaloop on 4 x-slabs of the card, the halos by B14): 2 untimed and
    4 timed megaloops each, ms/step of both legs and their ratio (on one
    card it measures overhead, not scaling: no efficiency gate); the
    sharded leg really sharded (``_scan_mesh``), B14's launches a step
    (set to 0 just before the timed megaloops, read just after), the
    sharded velocity against the solo one (``torch.equal``, its largest
    difference printed; within 1e-6 of max |u| and KE within 1e-6
    relative); at 256^3 B14 against its plain version at the slab halo
    shapes (strided component planes), bitwise, and timed;
32. config #2's box (128^3, one StefanFish) with ``-poissonSolver
    spectral`` as K = 8 megaloops for 16 steps, solo and on 4 x-slabs:
    KE within 1e-6 relative, position within 1e-6, B14's launches a step,
    ms/step; then config #2 as it stands (iterative) under
    ``CUP3D_MESH_X=4``: the solo megaloop (``_scan_mesh`` None, no B14
    launch), as the JAX package routes it;
33. bodies on the sharded forest: config #4 (phase 22's) after init,
    checkpointed and restored on 4 shards of the card (``mesh=``) and
    unsharded, ``CUP3D_RING_HALO=1``: 3 steps on the host path, then 3
    pipelined from the same state, each against the unsharded run
    (positions within 1e-7, transVel within 1e-5, the velocity within
    5e-4, tests/test_forest.py's bounds; the padding rows 0), B14's
    launches a step (set to 0 just before each run, read just after),
    ms/step beside phases 22 and 24; the sphere of
    tests/test_parity_gaps.py saved unsharded and resumed sharded beside
    its unsharded resume (velocity within 5e-5 after 2 steps).
34. the fleet (``cup3d_tpu_torch/fleet/``): bench.py bench_fleet32 as
    the bench runs it: 32 fish lanes at 32^3, 16 steps (K = 8) after a
    warm-up drain, served by one lane batch against the same jobs served
    one at a time through the per-step path: fleet_cells_per_s,
    solo_cells_per_s, wall_per_lane_step_s, host_dispatch_per_lane_s and
    fleet_amortization_ratio beside the bench's gate of 4.0 (reported,
    not asserted); every job done; lanes 0 and 17 against the port's
    solo K = 8 megaloop of the spec (KE within 1e-4 relative, position
    within 1e-5); the Frenet kernel launched once a step for all lanes,
    and at the fleet's shape against its plain version;
35. 8 ``amr_tgv`` lanes on config #3's forest as bench_amr_tgv builds it
    at its default scale (bpd 8, levelMax 2, levelStart 0, Rtol 1.8,
    Ctol 0.05, nu 1e-3), CFLs 0.30-0.40, 16 steps, ``CUP3D_FUSED=1``:
    every other lane at the first dispatch's journaled snapshot against the
    port's solo fused forest step of its spec over the same 8 steps
    (velocity within 1e-4, time and dt within 1e-4 relative); B8, B9 and
    B11-B13 launched as many times an executed Krylov iteration at 8
    lanes as at 1, the iterations the most any lane takes (chunks of
    4); B8, B12 and B13 with a scalar row a lane on the 8 lanes' stacked
    blocks at f32 and bf16: each lane's vectors bitwise its plain
    version, the lane launch bitwise the one-lane launches, the (1, 8)
    call bitwise the (8,) one; B9, B11 by phase 7's rule; each timed at
    8 x capacity blocks; ``fleet.lane_nan`` at lane 3 (the other lanes
    ``torch.equal`` the unfaulted run, lane 3 rolled back and done); a
    ``server.crash`` drill in this process (the exit intercepted) whose
    ``recover()`` ends with every job's QoI bytes equal to the uncrashed
    run; the crashed journal recovered by a server at bf16 storage, its
    lanes finishing the second dispatch from the f32 snapshots;
36. device-time attribution on the drivers (``obs/profile.py``,
    ``obs/export.py``, ``obs/costs.py``): config #2 as bench_fish_uniform
    runs it (128^3, pipelined, ``CUP3D_FUSED=1``: B1, B2, B4-B6) for 6
    steps through ``build_driver`` and ``simulate()`` under
    ``CUP3D_PROFILE=once:2``, ``CUP3D_PROFILE_STEPS=2``, ``CUP3D_TRACE=1``
    and ``CUP3D_TRACE_XLA=1``, the exporter on an ephemeral loopback port:
    the window's ``kind="device"`` record; bicgstab.update,
    bicgstab.getz_lap and bicgstab.finish above zero; the sum invariant
    to 1e-9 relative; each of those sections within 25% of the window's
    launches (the counters at the window's open and close) times phase
    3's profile us of its kernels scaled by cells from 256^3 to 128^3
    (phase 14's back-to-back us at 128^3 printed beside: their vectors
    stay in L2, the solve's do not); no capture, parse
    or empty-capture count; the window's ops on the pid-2 track of
    ``trace.pfto.json``; a scrape of ``/metrics`` giving the same
    ``profile.device_ms`` values, ``/health`` one window and an armed
    flight recorder, ``/federate`` schema 1; ``costs.device_peaks()`` the
    H100 entry and ``memory_watermarks()`` a peak on cuda:0; the capture
    trimmed to a test fixture (``torch_profile_h100.trace.json.gz``).
    The card's ceilings for every bound come from ``obs/costs.py``;
37. the compiled store and the background compile service
    (``cup3d_tpu_torch/aot/``, ``CUP3D_AOT_STORE``): a fresh copy of the
    package (no ``csrc/build/``) in a child process builds the kernels
    with nvcc into an empty store (timed), a second fresh copy loads them
    from the store with no nvcc, and its launches of every kernel (B1-B14
    and the Frenet kernel, once each on seeded inputs at small shapes)
    are bitwise this process's nvcc build's, which are held to their
    plain versions; config #3 (bpd 16) set up cold, then a fresh driver
    on the warm store (no table built): tables ``torch.equal`` leaf by
    leaf, 2 steps bitwise; 4 tgv lanes at 32^3 and 2 ``amr_tgv`` lanes at
    bpd 8 on a server with no store, on a cold store (the ``amr_tgv``
    jobs' tables built by the service while the tgv jobs dispatch:
    ``compile_wait`` and the pid-5 spans printed) and on a warm one (no
    table build, no nvcc; every run binds its advances), the seconds to
    each kind's first dispatch in the three, rows bitwise across them,
    and the helper's tables record ``torch.equal`` a build of the same
    forest on the card; the dispatch thread's ms a step for warm tgv
    lanes alone and over the rounds that overlap a cold ``amr_tgv``
    signature's background table build, in the service's helper process
    and on the worker thread; ``compile.service_die`` on the ``amr_tgv``
    jobs (they end done).  Phase 37 stays under 120 s.

The five uniform kernels' rows report their times at the fish path's
shape and their launches on it (phase 14); the 256^3 times and the TGV
path's launches ride in each row's ``tgv256``, config #5's launches (the
perturbed run, phase 17) in ``channel_launches``; the forest rows carry
config #4's launches a step (``fish_amr_launches_per_step``, B10's
ladder launches in ``fish_amr_launches``) and their times on its forest
(``fish_amr``) and on the towed forest (``tow_amr``), their times at
config #3's capacity beside the unpadded forest's (``unpadded``, phase
29; ``blocks``, ``capacity``), and their launches
a step on the pipelined configs #3 and #4 (``pipe_amr_launches_per_step``,
``pipe_fish_amr_launches_per_step``); B7's row its launches a step on the
forest Helmholtz (``helmholtz_launches_per_step``), B14's on the sharded
pipelined step (``pipe_shard_launches_per_step``), on the x-slab megaloop
and at its halo shapes (``slab_mesh``: phases 31-32) and under the bodies
on the sharded forest (``sharded_bodies_launches_per_step``, phase 33).
B14's row: its launches on phase 15's main path, its times at the Krylov loop's exchange (the
largest exchange's in ``largest``, one whole exchange's in
``exchange``).  B2, B14, B3/B10, B7, B9 and B4 were redesigned after
their port: their rows carry ``redesigned`` (the change that did it).
The uniform rows carry ``profile_us`` (the device time a launch by
profile); B4's carries ``library_ms`` (one ``conv3d`` and two dots) and
``iteration_kernels`` (phase 4).  B3's row
carries ``library_ms``: one ``torch.matmul`` by the dense tile operator;
B10's one ``torch.einsum`` by it and the column of -h^2, B9's the same
on the rows of w - azf.  The twelve bf16 rows (``<name>_bf16``) name
their f32 twin (``twin``) and carry its time in the same call
(``f32_ms``), their bitwise share and ulps; their launches are from
fish256 at bf16 (B1, B2, B4-B6), configs #2 (B3) and #4 (B10) under
``CUP3D_COARSE=0`` and config #3 pipelined at bf16 (B8, B9, B11-B13);
B3, B9 and B10 carry the f32 rows' library calls on the up-cast input.
The fleet (phases 34-35): B8, B9 and B11-B13 (f32 and bf16) carry a
``lanes`` block: their launches a dispatch at 8 lanes and at 1, the
Krylov iterations executed, and (f32) their device time a launch at
8 x capacity blocks with its bound; the Frenet row its launches a step
of the 32-lane batch and its time on the 32 lanes' midlines.

Prints ``{"kernels": [...]}``, then the card's ``nvidia-smi`` name and
power limit, then as its last line ``{"ok": true, "device": ...}``.
Writes the per-step diagnostics, the profiler's kernel tables
(``kernels.txt``, ``amr_kernels.txt``, ``shard_kernels.txt``, ...) and
Chrome traces (``trace.json``, ``fish_trace.json``, ...) under
``runs/chip_smoke/`` (git-ignored).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 256            # the main path's grid: 256^3 (bench_tgv_iterative)
N_SOLVE = 64            # the whole-solve comparison
STEPS = 20
# the AMR main path: BASELINE config #3 at N = 256 (bench.py bench_amr_tgv,
# bpd = N/16), iterative solve at the production tolerances
AMR_ARGV = ("-bpdx 16 -bpdy 16 -bpdz 16 -levelMax 2 -levelStart 0 "
            "-extent 6.283185307179586 -initCond taylorGreen -Rtol 1.8 "
            "-Ctol 0.05 -CFL 0.4 -rampup 0 -nu 1e-3 -poissonSolver iterative "
            f"-poissonTol 1e-6 -poissonTolRel 1e-4 -tend 0 -nsteps {STEPS}")
AMR_DIV_GATE = 0.05     # max|div u| after projection (bench.py amr_tgv)
# uniform max|div u| after projection: the iterative solve's stopping
# target (1e-6 abs / 1e-4 rel) leaves it residual-limited near 1e-5
UNIFORM_DIV_GATE = 1e-4
DT_MAIN = 1e-3          # the uniform main path's fixed dt
LADDER_FAULT = "solver.itercap@{step}:3"  # 3 rollbacks: the rungs to tile-only
LADDER_STEPS = 10       # the uniform ladder run's tend, in steps of DT_MAIN
FOREST_LADDER_STEPS = 10  # forest steps from the ladder's start: the
                          # rung's retry runs at dt/8 up to the fault's step
                          # + 4 (recovery.py), then 3 steps at full dt
CG_STEPS = 5            # CUP3D_GETZ=cg steps at 256^3
CG_ITERS = 24           # B7 sweeps (precond_iters of the production routes)
# the fish main path: BASELINE config #2 (bench.py bench_fish_uniform) at
# 128^3, non-pipelined in phase 14 (pipelined in phase 16), FISH_STEPS
# steps inside the 100-step CFL ramp
N_FISH = 128
FISH_STEPS = 30
FISH = ("StefanFish L=0.4 T=1.0 xpos=0.5 ypos=0.5 zpos=0.5 bFixFrameOfRef=1 "
        "heightProfile=danio widthProfile=stefan")
FISH_ARGV = (f"-bpdx {N_FISH // 8} -bpdy {N_FISH // 8} -bpdz {N_FISH // 8} "
             "-levelMax 1 -levelStart 0 -extent 1 -CFL 0.4 -nu 1e-3 "
             "-rampup 100 -poissonSolver iterative -poissonTol 1e-6 "
             f"-poissonTolRel 1e-4 -tend 0 -nsteps {FISH_STEPS} -verbose 0 "
             "-freqDiagnostics 1")
CHI_RTOL = 1e-5         # body volume on the card against the CPU port's
# max|div u| in the fluid (3 cells off the chi band) after the fish run:
# the JAX package's bench gate for the 128^3 fish (bench.py:52-59, twice
# its measured 0.017).  Inside the band the Brinkman forcing and the
# body's div(udef) are imposed, so the whole-domain max is printed only.
FISH_DIV_FLUID_GATE = 0.04
# phase 16: config #2 as the bench runs it (bench.py bench_fish_uniform,
# then _megaloop_split, on one driver): pipelined, no per-step
# diagnostics rows, FISH_STEPS steps; then SCAN_WARM untimed megaloops
# and SCAN_DISPATCHES timed in each window; K = 1 against K = 8 over
# SCAN_STEPS steps; the 256^3 TGV pipelined on the device dt chain and
# as K = 8 megaloops, TGV_SCAN_STEPS steps each at a CFL whose dt is
# phase 5's 1e-3 (max|u| = 1)
SCAN_K = 8
SCAN_WARM = 2
SCAN_DISPATCHES = 4
SCAN_STEPS = 16
SCAN_KE_RTOL = 1e-6     # fish K = 1 against K = 8 (tests/test_megaloop.py)
# the megaloop after the pipelined steps against the per-step port from the
# same state at the same dts: the same operations but the device midline
# in f32 (the host's in f64), grown over 80 steps: max|div u| in the fluid
# (a max of a difference quotient) within 10%, mean KE within 1e-4 (the
# ROADMAP's lane-vs-solo bound)
SCAN_DIV_RTOL = 0.1
SCAN_WITNESS_KE_RTOL = 1e-4
TGV_SCAN_STEPS = 16
TGV_SCAN_CFL = 0.04     # dt ~ 0.04 h / max|u| = 0.98e-3 at 256^3
MIDLINE_REPS = 5
# the Frenet kernel against its plain loop: ~100 dependent Euler steps,
# each renormalised, in another operation order -> 1e-5 of max |plain|
FRENET_RTOL = 1e-5
# the block-sharded forest: BASELINE config #3 on SHARDS shards of the card
SHARDS = 4
SHARD_STEPS = 5
SHARD_X_ATOL = 1e-5     # one solve, sharded vs unsharded (test_forest.py)
SHARD_TIGHT = 1e-6      # ... both solved to this relative residual
SHARD_TIGHT_ITERS = 400
SHARD_VEL_ATOL = 5e-3   # velocity after the steps (__graft_entry__.py)
LAP_SHARD_RTOL = 1e-5   # sharded lanes Laplacian (test_sharding.py)
SEED = 0
TIMING_SAMPLES = 21     # median over samples of LAUNCHES_PER_SAMPLE launches
LAUNCHES_PER_SAMPLE = 10
OUT_DIR = os.path.join("runs", "chip_smoke")

# Tolerances of kernel vs plain version (max abs error over max |plain|):
# elementwise outputs differ only by FMA contraction -> 2e-6, the bound
# the JAX package holds its Pallas kernels to; getz sums 6 axis transforms
# of 8 terms where the plain version sums two 512-term matmuls -> 1e-5.
# Per-tile partials (512-term sums in another order) are held to 1e-5 of
# the largest per-tile sum of |terms|.
VEC_RTOL = 2e-6
GETZ_RTOL = 1e-5
PART_RTOL = 1e-5
# B9 by CUDA events at config #3's 9,472 blocks before its redesign onto
# the shared getZ core (one 512-thread block a tile, six block barriers;
# NVIDIA H100 80GB HBM3, 700 W), printed beside its time now
B9_EARLIER_MS = 0.0685

_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log; each phase's header carries the
    seconds since the start."""
    if msg.startswith("phase "):
        msg = f"{msg}  [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peaks():
    """The card's memory bytes/s and f32 FLOP/s outside the tensor cores,
    from the port's one peak table (``obs/costs.py``).  A card with no
    entry there gets the nominal entry, and stops the run."""
    from cup3d_tpu_torch.obs import costs

    pk = costs.device_peaks()
    if pk.nominal:
        raise RuntimeError(f"no published peaks known for card "
                           f"{torch.cuda.get_device_name(0)!r}")
    return pk.hbm_bytes_per_s, pk.f32_flops


def time_ms(fn, per_sample: int = LAUNCHES_PER_SAMPLE) -> float:
    """Median device time of one call: CUDA events around batches of
    ``per_sample`` back-to-back calls, so host overhead hides behind the
    queue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMING_SAMPLES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per_sample):
            fn()
        e1.record()
        e1.synchronize()
        samples.append(e0.elapsed_time(e1) / per_sample)
    return statistics.median(samples)


def profile_us(fn, match: str, calls: int = 20) -> float:
    """Device microseconds a launch of the kernels whose name holds
    ``match``, over ``calls`` calls of ``fn`` under ``torch.profiler``
    (events read the host's launch rate where a kernel is shorter); None
    when three windows saw none of its records (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window can miss its kernels' records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.name]
        if ours:
            return sum(e.time_range.elapsed_us() for e in ours) / len(ours)
    return None


#: each uniform stage's CUDA kernel (csrc/fused_bicgstab.cu)
UNIFORM_KERNEL_NAMES = {"update": "k_update", "getz_two": "k_getz_two",
                        "getz_tile": "k_getz_tile", "lap": "k_lap",
                        "axpy": "k_axpy", "finish": "k_finish"}
#: each forest stage's CUDA kernel (csrc/fused_bicgstab.cu)
FOREST_KERNEL_NAMES = {"amr_update": "k_update", "amr_getz_two": "k_getz_amr",
                       "amr_getz_tile": "k_getz_tile",
                       "amr_lap": "k_lap_amr", "amr_axpy": "k_axpy",
                       "amr_finish": "k_finish"}


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|)."""
    err = float(torch.max(torch.abs(got - want)))
    return err, float(torch.max(torch.abs(want)))


def check_close(name, got, want, rtol, abs_scale=None) -> float:
    err, scale = max_err(got, want)
    scale = abs_scale if abs_scale is not None else scale
    if not err <= rtol * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err:.3e} > "
                             f"{rtol:g} x {scale:.3e}")
    return err


def _zero_rows(name: str, nb: int, *ts) -> None:
    """The bucketed forest's padding rows (past its nb real blocks) of
    each block field in ``ts`` are exactly 0."""
    for t in ts:
        if (t.dim() == 4 and tuple(t.shape[1:]) == (8, 8, 8)
                and t.shape[0] > nb and bool(t[nb:].any())):
            raise AssertionError(f"{name}: nonzero padding rows")


def _bucket_check(tag: str, d) -> dict:
    """The bucketed forest's state: every field at capacity with its
    padding rows exactly 0; capacity, the table memo and the bytes each
    adaptation read for its decision, logged."""
    nb = d.grid.nb
    for k, f in d.state.items():
        if f.shape[0] != (d._cap or nb) or bool(f[nb:].any()):
            raise AssertionError(f"{tag}: {k} {tuple(f.shape)}, nonzero "
                                 f"padding rows past {nb}")
    info = dict(bucketed=d._bucketing, capacity=d._cap, blocks=nb,
                memo=len(d._table_memo), memo_bytes=d.memo_bytes(),
                adapt_bytes=list(d.adapt_bytes))
    log(f"  {tag}: bucketed {d._bucketing}, {nb} blocks at capacity "
        f"{d._cap}, padding rows 0; table memo {info['memo']} topologies "
        f"({info['memo_bytes'] / 1e6:.2f} MB); bytes read for each of "
        f"{len(d.adapt_bytes)} adaptations: "
        f"{sorted(set(d.adapt_bytes))} (last {d.adapt_bytes[-3:]})")
    return info


def _forest_vecs(d, gen):
    """(geometry, padded block count, real block count, vec): the
    forest's operator geometry (nb = capacity when bucketed) and a
    seeded block field with its padding rows 0."""
    g = d._geom
    n, nb = g.nb, d.grid.nb

    def vec(dtype=torch.float32):
        v = torch.randn((n, 8, 8, 8), generator=gen, device=d.device)
        v[nb:] = 0.0
        return v.to(dtype)

    return g, n, nb, vec


def check_bitwise(name, got, want) -> float:
    """A kernel's output bitwise its plain version's (returns the max abs
    error, 0.0)."""
    if not torch.equal(got, want):
        err, _ = max_err(got.float(), want.float())
        raise AssertionError(f"{name}: not bitwise its plain version "
                             f"(max abs err {err:.3e})")
    return 0.0


def lap_library_ms(w, a, inv_h2, shape, pad_mode) -> float:
    """B4's library yardstick (TF32 off): one ``conv3d`` of the 7-point
    stencil / h^2 on the grid layout of ``w`` (padded by ``pad_mode``:
    circular for periodic axes, replicate for the zero-gradient ones),
    plus the two dots a . Aw and Aw . Aw; the layout conversion is outside
    the timed call."""
    import torch.nn.functional as F

    from cup3d_tpu_torch.ops import krylov

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("the library yardstick runs with TF32 off")
    u = krylov.from_lanes(krylov.tiles_to_lanes(w.float()), shape)[None, None]
    ag = krylov.from_lanes(krylov.tiles_to_lanes(a.float()), shape).reshape(-1)
    k = torch.zeros((1, 1, 3, 3, 3), device=w.device)
    k[0, 0, 1, 1, 1] = -6.0 * inv_h2
    for i in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        k[(0, 0) + i] = inv_h2

    def call():
        aw = F.conv3d(F.pad(u, (1,) * 6, mode=pad_mode), k).reshape(-1)
        return torch.dot(ag, aw), torch.dot(aw, aw)

    return time_ms(call)


def part_scale(*terms) -> float:
    """Largest per-tile sum of |terms| (the partials' error scale)."""
    acc = 0
    for t in terms:
        acc = acc + torch.abs(t)
    return float(torch.max(torch.sum(acc, dim=(1, 2, 3))))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shape
# ---------------------------------------------------------------------------


def kernel_phase(bw: float, fp32_flops: float, dev="cuda",
                 n: int = N_MAIN) -> dict:
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    dev = torch.device(dev)
    T = (n // 8) ** 3
    cells = T * 512
    h = 2 * math.pi / n
    h2 = h * h
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def vec():
        return torch.randn((T, 8, 8, 8), generator=gen, device=dev)

    def row(*vals):
        return fb._scalars(*(torch.tensor(v, device=dev) for v in vals))

    # per kernel: max_abs_err is over its vector outputs (the per-tile
    # partials are checked to PART_RTOL and printed beside it)
    results = {}

    def record(name, errs, perrs, kernel_fn, plain_fn, nbytes, flops):
        _record(results, name, errs, kernel_fn, plain_fn, nbytes, flops, bw,
                fp32_flops, perrs=perrs)
        # events read the host's launch rate where a kernel is shorter:
        # the device time a launch by profile beside them
        us = profile_us(kernel_fn, UNIFORM_KERNEL_NAMES[name])
        results[name]["profile_us"] = us
        log(f"    device time by profile {us} us a launch")

    # -- B1 update (in place on p, rhat: compare on clones) ---------------
    r, p, v, rhat = vec(), vec(), vec(), vec()
    errs, perrs = [], []
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        sc = row(*vals)
        want = fb.update(r, p.clone(), v, rhat.clone(), sc, kernels=False)
        got = fb.update(r, p.clone(), v, rhat.clone(), sc)
        for g, w in zip(got[:2], want[:2]):
            errs.append(check_close("update", g, w, VEC_RTOL))
        perrs.append(check_close("update partial", got[2], want[2],
                                 PART_RTOL, part_scale(want[0])))
    # breakdown: p and v are selected away, whatever they hold
    bad = torch.full_like(p, float("inf"))
    got = fb.update(r, bad.clone(), bad, rhat.clone(), row(0.0, 1.3, 1.0))
    if not (torch.equal(got[0], r) and torch.equal(got[1], r)):
        raise AssertionError("update: breakdown branch leaked p or v")
    sc = row(0.7, 1.3, 0.0)
    pk, rk = p.clone(), rhat.clone()
    # without breakdown the kernel reads r, p, v and writes p: rhat is
    # neither read nor written (it is re-seeded in place only on breakdown)
    record("update", errs, perrs,
           lambda: fb.update(r, pk, v, rk, sc),
           lambda: fb.update(r, p, v, rhat, sc, kernels=False),
           4 * 4 * cells, 4 * cells)

    # -- B2 getz_two ----------------------------------------------------------
    w = vec()
    aux = torch.randn((8, T), generator=gen, device=dev)
    aux[7] = 0.0
    want = fb.getz_two(w, aux, h2, kernels=False)
    got = fb.getz_two(w, aux, h2)
    errs = [check_close("getz_two", got, want, GETZ_RTOL)]
    # 6 axis transforms of 8 FMAs + the A zc / divide / add: ~110 flop/cell
    record("getz_two", errs, [0.0], lambda: fb.getz_two(w, aux, h2),
           lambda: fb.getz_two(w, aux, h2, kernels=False),
           2 * 4 * cells, 110 * cells)

    # -- B4 lap (the periodic n^3 grid, its neighbour faces read from w) ----
    from cup3d_tpu_torch.grid.uniform import UniformGrid

    w, a = vec(), vec()
    grid = UniformGrid((n, n, n), (2 * math.pi,) * 3)
    geom = fb.LapGeom(grid)
    inv_h2 = 1.0 / h2
    want = fb.lap(w, a, inv_h2, geom, kernels=False)
    got = fb.lap(w, a, inv_h2, geom)
    errs = [check_bitwise("lap", got[0], want[0])]
    perrs = [check_close("lap partial a.Aw", got[1], want[1], PART_RTOL,
                        part_scale(a * want[0])),
            check_close("lap partial Aw.Aw", got[2], want[2], PART_RTOL,
                        part_scale(want[0] * want[0]))]
    # w, a in, Aw out; 7 flops a cell for Aw, 4 for the two partials
    record("lap", errs, perrs, lambda: fb.lap(w, a, inv_h2, geom),
           lambda: fb.lap(w, a, inv_h2, geom, kernels=False),
           3 * 4 * cells, 11 * cells)
    results["lap"]["library_ms"] = lap_library_ms(
        w, a, inv_h2, (n, n, n), "circular")

    # -- B5 axpy -----------------------------------------------------------------
    r, v = vec(), vec()
    sc = row(0.37)
    want = fb.axpy(r, v, sc, kernels=False)
    got = fb.axpy(r, v, sc)
    errs = [check_close("axpy", got[0], want[0], VEC_RTOL)]
    perrs = [check_close("axpy partial", got[1], want[1], PART_RTOL,
                        part_scale(want[0]))]
    record("axpy", errs, perrs, lambda: fb.axpy(r, v, sc),
           lambda: fb.axpy(r, v, sc, kernels=False), 3 * 4 * cells, 3 * cells)

    # -- B6 finish (in place on x, r written into s: compare on clones) --------
    x, y, z, s, t, rh = (vec() for _ in range(6))
    sc = row(0.37, 1.21)
    want = fb.finish(x.clone(), y, z, s.clone(), t, rh, sc, kernels=False)
    got = fb.finish(x.clone(), y, z, s.clone(), t, rh, sc)
    errs = [check_close("finish x", got[0], want[0], VEC_RTOL),
            check_close("finish r", got[1], want[1], VEC_RTOL)]
    perrs = [check_close("finish partial r.r", got[2], want[2], PART_RTOL,
                        part_scale(want[1] * want[1])),
            check_close("finish partial rhat.r", got[3], want[3], PART_RTOL,
                        part_scale(rh * want[1]))]
    xk, sk = x.clone(), s.clone()
    record("finish", errs, perrs, lambda: fb.finish(xk, y, z, sk, t, rh, sc),
           lambda: fb.finish(x, y, z, s, t, rh, sc, kernels=False),
           8 * 4 * cells, 10 * cells)
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 4: one whole solve, kernels against plain versions
# ---------------------------------------------------------------------------


def solve_phase(dev="cuda") -> dict:
    """The whole solve, kernels against plain versions; then the device
    kernels a fused iteration launches (tools/kernel_ab.py's count: the
    solve at tolerance 0 over one chunk and over two, by profile) on the
    periodic grid and on config #5's BCs (walls in y); returns those."""
    from cup3d_tpu_torch.grid.uniform import UniformGrid
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import krylov
    from cup3d_tpu_torch.tools.kernel_ab import iteration_kernels

    n = N_SOLVE
    grid = UniformGrid((n, n, n), (1.0, 1.0, 1.0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rhs = torch.randn((n, n, n), generator=gen, device=dev)
    bt = krylov.to_lanes(rhs - torch.mean(rhs))
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=200)
    x_k, rn_k, k_k = fb.fused_bicgstab(grid, bt, **kw)
    x_p, rn_p, k_p = fb.fused_bicgstab(grid, bt, kernels=False, **kw)
    k_k, k_p = int(k_k), int(k_p)
    rel = float(torch.max(torch.abs(x_k - x_p)) / torch.max(torch.abs(x_p)))
    log(f"  {n}^3 fused solve: kernels {k_k} its (resid {float(rn_k):.3e}), "
        f"plain {k_p} its (resid {float(rn_p):.3e}), x rel diff {rel:.3e}")
    if abs(k_k - k_p) > 1 or not rel <= 1e-4:
        raise AssertionError(f"whole solve disagrees: its {k_k} vs {k_p}, "
                             f"x rel {rel:.3e} (bounds +-1, 1e-4)")
    counts = {}
    for g in (grid, UniformGrid((n, n // 2, n // 2), (1.0, 0.5, 0.5),
                                ("periodic", "wall", "periodic"))):
        bc = g.bc[1].value
        b = krylov.lanes_to_tiles(bt) if g is grid else torch.randn(
            (g.ncells // 512, 8, 8, 8), generator=gen, device=dev)
        fb.reset_launches()
        counts[bc] = iteration_kernels(torch, fb, g, b - torch.mean(b))
        log(f"  device kernels of the fused solve, {g.shape} {bc} in y: "
            f"{counts[bc]}; the wrappers' launches {dict(fb.launches)}")
        if not fb.launches["lap"] > 0:
            raise AssertionError("the fused solve launched no B4")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the main path through the CLI entry
# ---------------------------------------------------------------------------


def main_path_phase() -> dict:
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    os.makedirs(OUT_DIR, exist_ok=True)
    for name in ("energy.txt", "div.txt"):
        if os.path.exists(os.path.join(OUT_DIR, name)):
            os.remove(os.path.join(OUT_DIR, name))
    nb = N_MAIN // 8
    argv = (f"-bpdx {nb} -bpdy {nb} -bpdz {nb} -levelMax 1 "
            "-extent 6.283185307179586 -initCond taylorGreen "
            "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
            f"-nu 1e-3 -dt {DT_MAIN} -tend 0 -nsteps {STEPS} -verbose 0 "
            f"-freqDiagnostics 1 -path4serialization {OUT_DIR}").split()
    t0 = time.perf_counter()
    d = build_driver(argv)
    d.init()
    torch.cuda.synchronize()
    log(f"  build_driver + init: {time.perf_counter() - t0:.2f} s")
    s = d.sim
    ke0 = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
                ["kinetic_energy"])
    maxiter = d.pipeline[1].solver_maxiter

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    t0 = time.perf_counter()
    d.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fb.launches)
    executed = fb.iterations["executed"]
    residual = fb.residual_launches["lap"]  # B4 on the warm starts' r0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    energy = _read_table(os.path.join(OUT_DIR, "energy.txt"))
    div = _read_table(os.path.join(OUT_DIR, "div.txt"))
    log(f"  step  wall_s     iters  resid       KE            max|div u|")
    for i, row in enumerate(d.step_log):
        log(f"  {row['step']:4d}  {row['wall_s']:.4f}  {int(row['iters']):5d}"
            f"  {row['resid']:.3e}  {energy[i][1]:.8e}  {div[i][3]:.3e}")
    iters = [row["iters"] for row in d.step_log]
    if len(iters) != STEPS:
        raise AssertionError(f"ran {len(iters)} steps, expected {STEPS}")
    if not all(math.isfinite(k) and 0 <= k <= maxiter for k in iters):
        raise AssertionError(f"iteration counts out of range: {iters}")
    kes = [e[1] for e in energy]
    if not (all(math.isfinite(k) for k in kes) and kes[-1] < ke0):
        raise AssertionError(f"kinetic energy not finite or not decaying: "
                             f"KE0 {ke0}, per step {kes}")
    div_max = max(r[3] for r in div)
    if not div_max < UNIFORM_DIV_GATE:
        raise AssertionError(f"max|div u| {div_max:.3e} over the gate "
                             f"{UNIFORM_DIV_GATE:g}")
    _check_launches("TGV", iters, launches, executed)
    log(f"  {STEPS} steps in {wall:.3f} s ({wall / STEPS * 1e3:.2f} ms/step), "
        f"{int(sum(iters))} iterations ({executed} executed), "
        f"KE {ke0:.8e} -> {kes[-1]:.8e}, peak memory {peak_gb:.2f} GB")
    log(f"  launches: {launches}; B4 on the warm starts' residual: "
        f"{residual}")
    if not residual > 0:
        raise AssertionError("TGV: no warm-start residual on B4")
    split = _step_split(d)
    _profile_window(d)
    # KE at the end of each step (a row logs the step's start time)
    ke_curve = [(0.0, ke0)] + [(e[0] + DT_MAIN, e[1]) for e in energy]
    return dict(launches=launches, wall=wall, iters=iters, split=split,
                ke_curve=ke_curve, residual=residual)


def _check_launches(tag, iters, launches, executed) -> None:
    """Each executed iteration (chunk tails included) launches update,
    axpy and finish once and getz_two and lap twice; a solve of k
    iterations executes k rounded up to the chunk."""
    from cup3d_tpu_torch.ops import krylov

    chunk = krylov.ITER_CHUNK
    want_exec = sum(chunk * math.ceil(int(k) / chunk) for k in iters)
    want = {"update": executed, "axpy": executed, "finish": executed,
            "getz_two": 2 * executed, "getz_tile": 0, "lap": 2 * executed}
    if executed != want_exec or launches != want or executed == 0:
        raise AssertionError(f"{tag} launch counts {launches}, executed "
                             f"{executed}, expected {want_exec} executed")


def _read_table(path):
    with open(path) as f:
        return [[float(x) for x in line.split()] for line in f if line.strip()]


def _step_split(d, steps: int = 3) -> dict:
    """Host time of each operator with a synchronise around it, over a few
    more steps of the same run (the step's split between advection, the
    pressure solve and the diagnostics)."""
    s = d.sim
    totals: dict = {}
    for _ in range(steps):
        dt = d.calc_max_timestep()
        dt_dev = torch.tensor(dt, dtype=s.dtype, device=s.device)
        t_step = time.perf_counter()
        for op in d.pipeline:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op(dt_dev)
            torch.cuda.synchronize()
            totals[op.name] = totals.get(op.name, 0.0) + (
                time.perf_counter() - t0)
        d.end_step(dt, dt_dev, t_step)
    split = {k: v / steps * 1e3 for k, v in totals.items()}
    log("  per-step split (ms, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    return split


def _busy_ms(events) -> float:
    """Union length of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _profile_window(d, steps: int = 3, prefix: str = "", run=None,
                    trace: bool = True) -> dict:
    """A few more steps of the same run under torch.profiler: the host wall
    per step, the device's busy share of it, and the device time by kernel
    name (the full table and, with ``trace``, a Chrome trace go to
    OUT_DIR).  ``run``, when given, takes the ``steps`` steps itself (a
    megaloop)."""
    from torch.profiler import ProfilerActivity, profile

    t_win = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is not None:
            run()
        else:
            for _ in range(steps):
                d.advance(d.calc_max_timestep())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof.events())
    averages = prof.key_averages()  # one pass over the window's events
    with open(os.path.join(OUT_DIR, prefix + "kernels.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total",
                               row_limit=40))
    if trace:
        prof.export_chrome_trace(os.path.join(OUT_DIR,
                                              prefix + "trace.json"))
    # device-side entries only: the CPU ops' rows repeat their kernels' time
    rows = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  profiler, {steps} steps: wall {wall_ms / steps:.3f} ms/step, "
        f"device busy {busy / steps:.3f} ms/step ({busy / wall_ms:.1%}), "
        f"kernel time {total / steps:.3f} ms/step, iterations "
        f"{[int(r['iters']) for r in d.step_log[-steps:]]}")
    log(f"  {'kernel':<72}{'calls/step':>11}{'ms/step':>10}{'share':>8}")
    for e in rows[:25]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"  {e.key[:70]:<72}{e.count / steps:>11.1f}{ms:>10.3f}"
            f"{ms * steps / total:>8.1%}")
    # the port's own kernels, by device time per launch on this path
    # (CUDA events around back-to-back launches read the host's launch
    # rate instead when a kernel is shorter than its launch)
    ours = [e for e in rows if "::k_" in e.key or e.key.startswith("k_")]
    log("  port kernels on this path (device us per launch): " + ", ".join(
        f"{e.key.split('k_', 1)[1].split('(')[0]} "
        f"{e.self_device_time_total / e.count:.1f}" for e in ours))
    log(f"  (the profiler window took {time.perf_counter() - t_win:.1f} s "
        f"with its tables)")
    return dict(wall_ms=wall_ms / steps, busy_ms=busy / steps,
                kernel_ms=total / steps)


# ---------------------------------------------------------------------------
# phases 6-9: the AMR forest path (BASELINE config #3)
# ---------------------------------------------------------------------------


def amr_setup_phase():
    """build_driver + init() of the forest, timed with its table builds;
    then the mesh is frozen.  Returns the driver."""
    import numpy as np
    from cup3d_tpu_torch.__main__ import build_driver

    out = os.path.join(OUT_DIR, "amr")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    d = build_driver(f"{AMR_ARGV} -verbose 0 -path4serialization {out}"
                     .split())
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d.adapt_enabled = False
    d.smoke_init_s = init_s  # this script's bookkeeping
    g = d.grid
    counts = np.bincount(g.level, minlength=g.tree.cfg.level_max)
    log(f"  build_driver + init: {init_s:.2f} s, of which table builds "
        f"{sum(d.table_build_s):.2f} s over {len(d.table_build_s)} "
        f"topologies ({', '.join(f'{t:.2f}' for t in d.table_build_s)} s)")
    log(f"  forest: {g.nb} blocks ({g.nb * g.bs ** 3 / 1e6:.3f} M cells), "
        f"per level {dict(enumerate(counts.tolist()))}")
    if not (counts[0] > 0 and counts[1] > 0):
        raise AssertionError(f"the forest is not two-level: {counts}")
    return d


def forest_kernel_phase(d, bw: float, fp32_flops: float) -> dict:
    """B8, B9, B11, B12, B13 at the forest's block count (its capacity
    when bucketed: inputs 0 on the padding rows, and each output's
    padding rows exactly 0 after each launch) against their plain
    versions, then timed; labs and reflux increments are assembled from
    the forest's own width-1 face and flux tables."""
    from cup3d_tpu_torch.ops import amr_ops, tilesolve
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    dev = d.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    g, n, nb, vec = _forest_vecs(d, gen)
    cells = n * 512
    log(f"  at {n} blocks ({nb} real, bucketed {d._bucketing})")

    def row(*vals):
        return fb._scalars(*(torch.tensor(v, device=dev) for v in vals))

    h = g.h_column(torch.float32, dev).reshape(n)
    vol = d._vol.reshape(n).float().contiguous()
    h2 = (h * h).contiguous()
    inv_h2 = (1.0 / h2).contiguous()
    results = {}

    def record(name, errs, perrs, kernel_fn, plain_fn, nbytes, flops):
        _record(results, name, errs, kernel_fn, plain_fn, nbytes, flops, bw,
                fp32_flops, perrs=perrs)
        # events read the launch rate at this size: the device time too
        results[name]["profile_us"] = profile_us(
            kernel_fn, FOREST_KERNEL_NAMES[name])
        log(f"    device time by profile {results[name]['profile_us']} us a "
            f"launch")

    # -- B8 update (in place on p, rhat: compare on clones) ---------------
    r, p, v, rhat = vec(), vec(), vec(), vec()
    errs, perrs = [], []
    for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
        sc = row(*vals)
        want = fa.update(r, p.clone(), v, rhat.clone(), vol, sc,
                         kernels=False)
        got = fa.update(r, p.clone(), v, rhat.clone(), vol, sc)
        _zero_rows("amr_update", nb, *got[:2])
        for gt, wt in zip(got[:2], want[:2]):
            errs.append(check_close("amr_update", gt, wt, VEC_RTOL))
        perrs.append(check_close("amr_update partial", got[2], want[2],
                                 PART_RTOL, part_scale(want[0] * vol[
                                     :, None, None, None])))
    sc = row(0.7, 1.3, 0.0)
    pk, rk = p.clone(), rhat.clone()
    record("amr_update", errs, perrs,
           lambda: fa.update(r, pk, v, rk, vol, sc),
           lambda: fa.update(r, p, v, rhat, vol, sc, kernels=False),
           4 * 4 * cells, 5 * cells)

    # -- B9 getz on -h2 (w - azf) with a real A zf -------------------------
    w = vec()
    zc = torch.randn(n, generator=gen, device=dev)
    zc[nb:] = 0.0  # the coarse solve's padding rows
    zf = zc[:, None, None, None].expand(n, 8, 8, 8)
    azf = amr_ops.laplacian_blocks(g, zf, d._tab1, d._ftab).contiguous()
    want = fa.getz_two(w, azf, zc, h2, kernels=False)
    got = fa.getz_two(w, azf, zc, h2)
    _zero_rows("amr_getz_two", nb, azf, got)
    errs = [check_close("amr_getz_two", got, want, GETZ_RTOL)]
    if not torch.equal(fa.getz_two(w, azf, zc, h2), got):
        raise AssertionError("amr_getz_two: a rerun differs")
    # a ragged block count (not a multiple of the warps of a CTA), on the
    # same columns
    m = n - 3
    args = (w[:m].contiguous(), azf[:m].contiguous(), zc[:m].contiguous(),
            h2[:m].contiguous())
    errs.append(check_close("amr_getz_two ragged", fa.getz_two(*args),
                            fa.getz_two(*args, kernels=False), GETZ_RTOL))
    record("amr_getz_two", errs, [0.0],
           lambda: fa.getz_two(w, azf, zc, h2),
           lambda: fa.getz_two(w, azf, zc, h2, kernels=False),
           3 * 4 * cells + 8 * n, 110 * cells)
    # its library yardstick: one einsum of the precomputed (n, 512) rows
    # of w - azf, the dense tile operator and the -h^2 column (TF32 off);
    # the product only, not the + zc
    W = tilesolve.dense_operator(8, torch.float32, str(dev))
    rows_ = (w - azf).view(n, 512)
    neg_h2 = -h2
    lib_ms = time_ms(lambda: torch.einsum("tc,cd,t->td", rows_, W, neg_h2))
    results["amr_getz_two"]["library_ms"] = lib_ms
    log(f"  amr_getz_two library: torch.einsum by the tile operator and the "
        f"-h^2 column {lib_ms:.4f} ms; before its redesign "
        f"{B9_EARLIER_MS} ms")

    # -- B11 lap on the forest's lab + reflux increment --------------------
    w, a = vec(), vec()
    lab = d._tab1.assemble_scalar(w, 8).contiguous()
    inv_h = (1.0 / h)[:, None, None, None]
    corr = d._ftab.apply(torch.zeros_like(w),
                         amr_ops.face_fluxes(lab, 1, 8, inv_h)).contiguous()
    want = fa.lap(lab, corr, a, inv_h2, kernels=False)
    got = fa.lap(lab, corr, a, inv_h2)
    _zero_rows("amr_lap", nb, corr, got[0])
    errs = [check_close("amr_lap", got[0], want[0], VEC_RTOL)]
    perrs = [check_close("amr_lap partial a.Aw", got[1], want[1], PART_RTOL,
                         part_scale(a * want[0])),
             check_close("amr_lap partial Aw.Aw", got[2], want[2], PART_RTOL,
                         part_scale(want[0] * want[0]))]
    record("amr_lap", errs, perrs,
           lambda: fa.lap(lab, corr, a, inv_h2),
           lambda: fa.lap(lab, corr, a, inv_h2, kernels=False),
           (1000 / 512 + 3) * 4 * cells, 10 * cells)

    # -- B12 axpy ------------------------------------------------------------
    r, v = vec(), vec()
    sc = row(0.37)
    want = fa.axpy(r, v, vol, sc, kernels=False)
    got = fa.axpy(r, v, vol, sc)
    _zero_rows("amr_axpy", nb, got[0])
    errs = [check_close("amr_axpy", got[0], want[0], VEC_RTOL)]
    perrs = [check_close("amr_axpy partial", got[1], want[1], PART_RTOL,
                         part_scale(want[0] * vol[:, None, None, None]))]
    record("amr_axpy", errs, perrs, lambda: fa.axpy(r, v, vol, sc),
           lambda: fa.axpy(r, v, vol, sc, kernels=False),
           3 * 4 * cells, 4 * cells)

    # -- B13 finish (the B6 kernel; in place on x, r into s) ----------------
    x, y, z, s_, t, rh = (vec() for _ in range(6))
    sc = row(0.37, 1.21)
    want = fa.finish(x.clone(), y, z, s_.clone(), t, rh, sc, kernels=False)
    got = fa.finish(x.clone(), y, z, s_.clone(), t, rh, sc)
    _zero_rows("amr_finish", nb, *got[:2])
    errs = [check_close("amr_finish x", got[0], want[0], VEC_RTOL),
            check_close("amr_finish r", got[1], want[1], VEC_RTOL)]
    perrs = [check_close("amr_finish partial r.r", got[2], want[2],
                         PART_RTOL, part_scale(want[1] * want[1])),
             check_close("amr_finish partial rhat.r", got[3], want[3],
                         PART_RTOL, part_scale(rh * want[1]))]
    xk, sk = x.clone(), s_.clone()
    record("amr_finish", errs, perrs,
           lambda: fa.finish(xk, y, z, sk, t, rh, sc),
           lambda: fa.finish(x, y, z, s_, t, rh, sc, kernels=False),
           8 * 4 * cells, 10 * cells)
    torch.cuda.synchronize()
    return results


def forest_solve_phase(d, rhs=None) -> None:
    """One whole forest solve: kernels against plain versions (+-1
    iteration, x within 1e-4), and the kernel solve twice (bitwise).
    ``rhs``: the right-hand side (default: seeded noise)."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    g, dev, nb = d._geom, d.device, d.grid.nb
    if rhs is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 3)
        rhs = torch.randn((g.nb, 8, 8, 8), generator=gen, device=dev)
        rhs[nb:] = 0.0
    vol = d._vol
    b = rhs - torch.sum(rhs * vol) / (torch.sum(vol) * 512)
    if d._pmask is not None:
        b = b * d._pmask  # the dynamic solver's padding mask
    kw = dict(tab=d._tab1, ftab=d._ftab, vol=vol, graph=d._graph,
              tol_abs=1e-6, tol_rel=1e-4, maxiter=200)
    t0 = time.perf_counter()
    x_k, rn_k, k_k = fa.fused_amr_bicgstab(g, b, **kw)
    k_k = int(k_k)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_p, rn_p, k_p = fa.fused_amr_bicgstab(g, b, kernels=False, **kw)
    k_p = int(k_p)
    t_p = time.perf_counter() - t0
    x_k2, _, k_k2 = fa.fused_amr_bicgstab(g, b, **kw)
    _zero_rows("forest solve x", nb, x_k, x_p)
    rel = float(torch.max(torch.abs(x_k - x_p)) / torch.max(torch.abs(x_p)))
    same = bool(torch.equal(x_k, x_k2)) and int(k_k2) == k_k
    log(f"  forest solve ({g.nb} blocks): kernels {k_k} its in {t_k:.3f} s "
        f"(resid {float(rn_k):.3e}), plain {k_p} its in {t_p:.3f} s (resid "
        f"{float(rn_p):.3e}), x rel diff {rel:.3e}, rerun bitwise {same}")
    if abs(k_k - k_p) > 1 or not rel <= 1e-4 or not same:
        raise AssertionError(f"forest solve disagrees: its {k_k} vs {k_p}, "
                             f"x rel {rel:.3e}, rerun bitwise {same}")


def _kinetic_energy(d) -> float:
    from cup3d_tpu_torch.ops import amr_ops

    return float(amr_ops.dissipation_blocks(
        d._geom, d.state["vel"], d.nu, d._tab1)["kinetic_energy"])


def amr_main_path_phase(d) -> dict:
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import krylov

    ke0 = _kinetic_energy(d)
    maxiter = d._solver.maxiter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    d.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    executed = fa.iterations["executed"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"  step  blocks  wall_s     iters  resid       umax")
    for r in d.step_log:
        log(f"  {r['step']:4d}  {r['nb']:6d}  {r['wall_s']:.4f}"
            f"  {int(r['iters']):5d}  {r['resid']:.3e}  {r['umax']:.6f}")
    iters = [r["iters"] for r in d.step_log]
    if len(iters) != STEPS:
        raise AssertionError(f"ran {len(iters)} steps, expected {STEPS}")
    if not all(math.isfinite(k) and 0 <= k <= maxiter for k in iters):
        raise AssertionError(f"iteration counts out of range: {iters}")
    ke = _kinetic_energy(d)
    _, div_max = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"],
                                                 d._tab1)
    div_max = float(div_max)
    # the JAX bench's divergence gate for this config (bench.py:62-65)
    if not (math.isfinite(ke) and ke < ke0 and div_max < AMR_DIV_GATE):
        raise AssertionError(f"kinetic energy not finite or not decaying, "
                             f"or divergence over {AMR_DIV_GATE}: KE0 {ke0}, "
                             f"KE {ke}, max|div u| {div_max}")
    chunk = krylov.ITER_CHUNK
    want_exec = sum(chunk * math.ceil(int(k) / chunk) for k in iters)
    want = {"amr_update": executed, "amr_getz_two": 2 * executed,
            "amr_getz_tile": 0, "amr_lap": 2 * executed,
            "amr_axpy": executed, "amr_finish": executed}
    if executed != want_exec or launches != want or executed == 0:
        raise AssertionError(f"launch counts {launches}, executed "
                             f"{executed}, expected {want_exec} executed")
    log(f"  {STEPS} steps in {wall:.3f} s ({wall / STEPS * 1e3:.2f} ms/step), "
        f"{int(sum(iters))} iterations ({executed} executed, "
        f"{sum(iters) / STEPS:.2f} per step), KE {ke0:.8e} -> {ke:.8e}, "
        f"max|div u| {div_max:.3e}, peak memory {peak_gb:.2f} GB")
    log(f"  launches: {launches}")
    split = _amr_step_split(d)
    pieces = _amr_solve_pieces(d)
    prof = _profile_window(d, steps=1, prefix="amr_", trace=False)
    window = forest_window(d)
    return dict(launches=launches, wall=wall, iters=iters, split=split,
                pieces=pieces, prof=prof, window=window)


class _SyncProfiler:
    """The driver's Profiler protocol with a synchronise at both ends of
    each section, so section times are device-inclusive."""

    def __init__(self):
        self.totals: dict = {}

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def section():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                torch.cuda.synchronize()
                self.totals[name] = self.totals.get(name, 0.0) + (
                    time.perf_counter() - t0)
        return section()


def _amr_step_split(d, steps: int = 3) -> dict:
    """A few more steps with the driver's sections synchronised: the
    step's split between advection, the pressure projection and the
    end-of-step read."""
    prof, d.profiler = d.profiler, _SyncProfiler()
    try:
        for _ in range(steps):
            d.advance(d.calc_max_timestep())
        totals = d.profiler.totals
    finally:
        d.profiler = prof
    split = {k: v / steps * 1e3 for k, v in totals.items()}
    log("  per-step split (ms, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    return split


def _amr_solve_pieces(d) -> dict:
    """Device time of each piece of one forest iteration at the main
    path's shapes (CUDA events): the plain-torch glue between the
    kernels (coarse graph solve, the refluxed A zf, lab + reflux
    increment) beside the five kernels; an iteration runs each glue
    piece and getz/lap twice, update/axpy/finish once."""
    from cup3d_tpu_torch.ops import amr_ops, krylov

    g, dev, n = d._geom, d.device, d._geom.nb
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    w = torch.randn((n, 8, 8, 8), generator=gen, device=dev)
    tsum = torch.randn(n, generator=gen, device=dev)
    inv_h = 1.0 / g.h_column(torch.float32, dev)
    zc = krylov.coarse_solve_graph(tsum, d._graph)
    zf = zc[:, None, None, None].expand(n, 8, 8, 8)

    def lab_corr():
        lab = d._tab1.assemble_scalar(w, 8)
        return d._ftab.apply(torch.zeros_like(w),
                             amr_ops.face_fluxes(lab, 1, 8, inv_h))

    pieces = {
        "coarse_solve_graph": lambda: krylov.coarse_solve_graph(tsum,
                                                                 d._graph),
        "laplacian_blocks(zf)": lambda: amr_ops.laplacian_blocks(
            g, zf, d._tab1, d._ftab),
        "lab + reflux increment": lab_corr,
    }
    out = {k: time_ms(fn) for k, fn in pieces.items()}
    per_iter = 2 * sum(out.values())
    log("  one forest iteration, glue pieces (ms each, x2 per iteration): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f"; glue {per_iter:.3f} ms per iteration")
    out["glue_per_iteration"] = per_iter
    return out


# ---------------------------------------------------------------------------
# phases 10-13: the tile-only and CG getZ kernels, the self-healing loop
# ---------------------------------------------------------------------------


def _record(results, name, errs, kernel_fn, plain_fn, nbytes, flops, bw,
            fp32_flops, perrs=None,
            plain_per_sample=LAUNCHES_PER_SAMPLE) -> None:
    """Time a kernel and its plain version; store the kernel's row (its
    bound from the bytes it must move and the operations it must do)."""
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn, plain_per_sample)
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / fp32_flops * 1e3
    results[name] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    parts = "" if perrs is None else f" (partials {max(perrs):.3e})"
    log(f"  {name:13s} err {max(errs):.3e}{parts}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms "
        f"({results[name]['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")


def getz_kernel_phase(d, bw: float, fp32_flops: float) -> dict:
    """B3 at 256^3, B10 at the forest's block count, B7 at 256^3 in the
    lanes layout of the uniform legacy solve (shift 0, then a random
    per-tile shift) and in the forest's blocks layout, each against its
    plain version; then timed."""
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import getz_cg, tilesolve

    dev = torch.device("cuda")
    T = (N_MAIN // 8) ** 3
    cells = T * 512
    h2 = (2 * math.pi / N_MAIN) ** 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    results = {}

    # -- B3: y = tilesolve(-h2 w), one h2; 6 axis transforms of 8 FMAs,
    # the 1/lam scale and the -h2 prologue: ~98 flop/cell
    w = torch.randn((T, 8, 8, 8), generator=gen, device=dev)
    errs = [check_close("getz_tile", fb.getz_tile(w, h2),
                        fb.getz_tile(w, h2, kernels=False), GETZ_RTOL)]
    _record(results, "getz_tile", errs, lambda: fb.getz_tile(w, h2),
            lambda: fb.getz_tile(w, h2, kernels=False), 2 * 4 * cells,
            98 * cells, bw, fp32_flops)
    # its library yardstick: one product of the (T, 512) rows by the dense
    # tile operator S3 diag(1/lam3) S3 times -h2, built once, TF32 off
    W = tilesolve.dense_operator(8, torch.float32, str(dev))
    M = -h2 * W
    lib_ms = time_ms(lambda: torch.matmul(w.view(T, 512), M))
    results["getz_tile"]["library_ms"] = lib_ms
    log(f"  getz_tile library: torch.matmul by the 512 x 512 tile operator "
        f"{lib_ms:.4f} ms")

    # -- B10: the same at each block's own h^2 -----------------------------
    g, n, nb, fvec = _forest_vecs(d, gen)
    h = g.h_column(torch.float32, dev).reshape(n)
    h2c = (h * h).contiguous()
    wf = fvec()
    got = fa.getz_tile(wf, h2c)
    _zero_rows("amr_getz_tile", nb, got)
    errs = [check_close("amr_getz_tile", got,
                        fa.getz_tile(wf, h2c, kernels=False), GETZ_RTOL)]
    _record(results, "amr_getz_tile", errs, lambda: fa.getz_tile(wf, h2c),
            lambda: fa.getz_tile(wf, h2c, kernels=False),
            2 * 4 * n * 512 + 4 * n, 98 * n * 512, bw, fp32_flops)
    # its library yardstick: one einsum of the (n, 512) rows, the tile
    # operator and the column of -h^2 (negated outside the timed call)
    neg_h2 = -h2c
    lib_ms = time_ms(lambda: torch.einsum("tc,cd,t->td", wf.view(n, 512), W,
                                          neg_h2))
    results["amr_getz_tile"]["library_ms"] = lib_ms
    log(f"  amr_getz_tile library: torch.einsum by the tile operator and "
        f"the -h^2 column {lib_ms:.4f} ms")

    # -- B7: CG_ITERS sweeps of 19 flop/cell (stencil 7, shifted apply 2,
    # two dots 4, three axpys 6) plus the initial r.r ---------------------
    bt = torch.randn((8, 8, 8, T), generator=gen, device=dev)
    shift = torch.rand(T, generator=gen, device=dev)
    errs = []
    for sh in (0.0, shift):
        errs.append(check_close(
            "getz_cg", getz_cg.cg_tiles_lanes(bt, CG_ITERS, sh),
            getz_cg.cg_tiles_lanes(bt, CG_ITERS, sh, kernels=False),
            GETZ_RTOL))
    hb = h2c[:, None, None, None]
    errs.append(check_close(
        "getz_cg blocks", getz_cg.cg_tiles_blocks(wf, CG_ITERS, hb),
        getz_cg.cg_tiles_blocks(wf, CG_ITERS, hb, kernels=False),
        GETZ_RTOL))
    flops = (19 * CG_ITERS + 2) * cells
    _record(results, "getz_cg", errs,
            lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS, 0.0),
            lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS, 0.0, kernels=False),
            2 * 4 * cells, flops, bw, fp32_flops, plain_per_sample=1)
    ms_shift = time_ms(lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS, shift))
    ms_blocks = time_ms(lambda: getz_cg.cg_tiles_blocks(wf, CG_ITERS, hb))
    log(f"  getz_cg with a per-tile shift {ms_shift:.4f} ms at {N_MAIN}^3; "
        f"blocks layout at {n} blocks {ms_blocks:.4f} ms (bound "
        f"{(19 * CG_ITERS + 2) * n * 512 / fp32_flops * 1e3:.4f} ms)")
    torch.cuda.synchronize()
    return results


class _env:
    """Set ``CUP3D_*`` variables for one phase (None: unset one); restore
    them (and clear the process-global fault plan) on the way out."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        from cup3d_tpu_torch.resilience import faults

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.clear()
        return False


def _watch_recovery(d) -> dict:
    """Wrap the driver's restore and solver-rebuild hooks: where in
    ``step_log`` each rebuild happened, and each restore's time."""
    marks = {"rebuild_at": [], "restore_s": []}
    rebuild, restore = d._resilience_rebuild_poisson, d._resilience_restore

    def rebuild_hook(*a, **kw):
        marks["rebuild_at"].append(len(d.step_log))
        rebuild(*a, **kw)

    def restore_hook(payload):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(payload)
        torch.cuda.synchronize()
        marks["restore_s"].append(time.perf_counter() - t0)

    d._resilience_rebuild_poisson = rebuild_hook
    d._resilience_restore = restore_hook
    return marks


def _executed(rows) -> int:
    """Iterations the chunked Krylov loop executed for these step rows."""
    from cup3d_tpu_torch.ops import krylov

    chunk = krylov.ITER_CHUNK
    return sum(chunk * math.ceil(int(r["iters"]) / chunk) for r in rows)


def _check_ladder(delta, marks, out_dir) -> None:
    stages = {k.split("stage=")[1].rstrip("}"): v for k, v in delta.items()
              if k.startswith("resilience.retries") and v}
    flights = [f for f in os.listdir(out_dir) if f.startswith("flight_")]
    if (delta.get("resilience.rollbacks") != 3 or stages != {
            "warm-restart": 1, "zero-guess": 1, "tile-only": 1}
            or delta.get("resilience.giveups", 0) or flights
            or len(marks["rebuild_at"]) != 1):
        raise AssertionError(f"ladder: rollbacks "
                             f"{delta.get('resilience.rollbacks')}, stages "
                             f"{stages}, giveups "
                             f"{delta.get('resilience.giveups', 0)}, "
                             f"postmortems {flights}, rebuilds {marks}")


def uniform_ladder_phase(ke_curve) -> dict:
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = os.path.join(OUT_DIR, "ladder")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    nb = N_MAIN // 8
    tend = LADDER_STEPS * DT_MAIN
    argv = (f"-bpdx {nb} -bpdy {nb} -bpdz {nb} -levelMax 1 "
            "-extent 6.283185307179586 -initCond taylorGreen "
            "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
            f"-nu 1e-3 -dt {DT_MAIN} -tend {tend} -nsteps 0 -verbose 0 "
            f"-freqDiagnostics 1 -path4serialization {out}").split()
    with _env(CUP3D_FUSED="1", CUP3D_FAULT=LADDER_FAULT.format(step=2)):
        d = build_driver(argv)
        d.init()
        marks = _watch_recovery(d)
        s = d.sim
        ke0 = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
                    ["kinetic_energy"])
        torch.cuda.synchronize()
        m0 = metrics.snapshot()
        fb.reset_launches()
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fb.launches)
        executed = fb.iterations["executed"]
        delta = metrics.delta(m0)
    _check_ladder(delta, marks, out)
    idx = marks["rebuild_at"][0]
    before, after = d.step_log[:idx], d.step_log[idx:]
    ex_b, ex_a = _executed(before), _executed(after)
    want = {"update": executed, "getz_two": 2 * ex_b, "getz_tile": 2 * ex_a,
            "lap": 2 * executed, "axpy": executed, "finish": executed}
    if executed != ex_b + ex_a or launches != want or ex_a == 0:
        raise AssertionError(f"ladder launches {launches}, executed "
                             f"{executed}, expected {want}")
    ke = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
               ["kinetic_energy"])
    ke_ref = _interp(ke_curve, s.time)
    div = _read_table(os.path.join(out, "div.txt"))[-1][3]
    if not (math.isfinite(ke) and ke < ke0
            and abs(ke - ke_ref) <= 0.05 * ke_ref and div < UNIFORM_DIV_GATE
            and s.time >= tend - 1e-12):
        raise AssertionError(f"ladder run: KE {ke} (start {ke0}, phase 5 "
                             f"{ke_ref} at t={s.time}), max|div u| {div}")
    log(f"  {len(d.step_log)} steps ({len(before)} before the tile-only "
        f"rung, {len(after)} after) in {wall:.3f} s "
        f"({wall / len(d.step_log) * 1e3:.2f} ms/step); to t={s.time:.6f}")
    log(f"  iterations before the rung {[int(r['iters']) for r in before]}")
    _log_after(after, ex_a, 2)
    log(f"  KE {ke0:.8e} -> {ke:.8e} (phase 5 at t={s.time:.6f}: "
        f"{ke_ref:.8e}, rel diff {abs(ke - ke_ref) / ke_ref:.3e}), "
        f"max|div u| {div:.3e}; restores "
        f"{', '.join(f'{t * 1e3:.1f}' for t in marks['restore_s'])} ms")
    log(f"  launches: {launches}")
    return dict(launches=launches, wall=wall, before=before, after=after,
                restore_s=marks["restore_s"])


def _log_after(after, executed, fault_step) -> None:
    """The tile-only steps: all of them, and those at full dt (the engine
    scales dt by 0.5**attempt up to the fault's step + 4)."""
    full = [r for r in after if r["step"] > fault_step + 4]
    log(f"  tile-only iterations {[int(r['iters']) for r in after]} "
        f"({executed} executed), ms/step after the rung "
        f"{sum(r['wall_s'] for r in after) / len(after) * 1e3:.2f}")
    if full:
        log(f"  at full dt ({len(full)} steps): iterations "
            f"{[int(r['iters']) for r in full]}, ms/step "
            f"{sum(r['wall_s'] for r in full) / len(full) * 1e3:.2f}")


def _interp(curve, t) -> float:
    """Linear interpolation of [(t, value), ...] (sorted by t) at t."""
    for (t0, v0), (t1, v1) in zip(curve, curve[1:]):
        if t0 <= t <= t1:
            return v0 + (v1 - v0) * (t - t0) / (t1 - t0)
    raise AssertionError(f"t={t} outside the reference run's "
                         f"[{curve[0][0]}, {curve[-1][0]}]")


def forest_ladder_phase(d) -> dict:
    """Phase 9's driver on through the ladder: the fault at its current
    step + 2, FOREST_LADDER_STEPS steps from there."""
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    s0 = d.step_idx
    d.cfg.nsteps = s0 + FOREST_LADDER_STEPS
    out = d.cfg.path4serialization
    for f in os.listdir(out):
        if f.startswith("flight_"):
            os.remove(os.path.join(out, f))
    tables = len(d.table_build_s)
    marks = _watch_recovery(d)
    ke0 = _kinetic_energy(d)
    log_start = len(d.step_log)
    # the tile-only rung rebuilds the solver, reading CUP3D_FUSED again
    with _env(CUP3D_FUSED="1", CUP3D_FAULT=LADDER_FAULT.format(step=s0 + 2)):
        torch.cuda.synchronize()
        m0 = metrics.snapshot()
        fa.reset_launches()
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.launches)
        executed = fa.iterations["executed"]
        delta = metrics.delta(m0)
    _check_ladder(delta, marks, out)
    idx = marks["rebuild_at"][0]
    before, after = d.step_log[log_start:idx], d.step_log[idx:]
    ex_b, ex_a = _executed(before), _executed(after)
    want = {"amr_update": executed, "amr_getz_two": 2 * ex_b,
            "amr_getz_tile": 2 * ex_a, "amr_lap": 2 * executed,
            "amr_axpy": executed, "amr_finish": executed}
    if executed != ex_b + ex_a or launches != want or len(after) < 3:
        raise AssertionError(f"forest ladder launches {launches}, executed "
                             f"{executed}, expected {want}, {len(after)} "
                             f"steps after the rung")
    ke = _kinetic_energy(d)
    _, div = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"], d._tab1)
    div = float(div)
    # the bucketed forest's tile-only rung rebuilds its memo once (the
    # JAX package's: the memo carries the graph); restores build nothing
    tables += int(d._bucketing)
    if not (math.isfinite(ke) and ke < ke0 and div < AMR_DIV_GATE
            and d._graph is None and len(d.table_build_s) == tables
            and d.step_idx == d.cfg.nsteps):
        raise AssertionError(f"forest ladder: KE {ke} (start {ke0}), "
                             f"max|div u| {div}, graph {d._graph is None}, "
                             f"table builds {len(d.table_build_s)} vs "
                             f"{tables}, step {d.step_idx}")
    log(f"  {len(d.step_log) - log_start} steps ({len(before)} before the "
        f"tile-only rung, {len(after)} after) in {wall:.3f} s")
    log(f"  iterations before the rung {[int(r['iters']) for r in before]}")
    _log_after(after, ex_a, s0 + 2)
    log(f"  restores (live tables reused, no table build) "
        f"{', '.join(f'{t * 1e3:.1f}' for t in marks['restore_s'])} ms; "
        f"KE {ke0:.8e} -> {ke:.8e}, max|div u| {div:.3e}")
    log(f"  launches: {launches}")
    return dict(launches=launches, wall=wall, before=before, after=after,
                restore_s=marks["restore_s"])


def cg_phase(d_forest, graph) -> dict:
    """CUP3D_GETZ=cg: CG_STEPS steps of the 256^3 TGV through the CLI's
    legacy composition, then one uniform and one forest CG-getZ solve,
    kernels against plain versions."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import getz_cg, krylov

    out = os.path.join(OUT_DIR, "cg")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    nb = N_MAIN // 8
    argv = (f"-bpdx {nb} -bpdy {nb} -bpdz {nb} -levelMax 1 "
            "-extent 6.283185307179586 -initCond taylorGreen "
            "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
            f"-nu 1e-3 -dt {DT_MAIN} -tend 0 -nsteps {CG_STEPS} -verbose 0 "
            f"-freqDiagnostics 1 -path4serialization {out}").split()
    with _env(CUP3D_FUSED="1", CUP3D_GETZ="cg"):
        d = build_driver(argv)
        d.init()
        s = d.sim
        ke0 = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
                    ["kinetic_energy"])
        torch.cuda.synchronize()
        getz_cg.reset_launches()
        fb.reset_launches()
        krylov.iterations["executed"] = 0
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(getz_cg.launches)
        executed = krylov.iterations["executed"]
        iters = [int(r["iters"]) for r in d.step_log]
        ke = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
                   ["kinetic_energy"])
        div = max(r[3] for r in _read_table(os.path.join(out, "div.txt")))
        if (launches["getz_cg"] != 2 * executed or executed == 0
                or fb.iterations["executed"] or len(iters) != CG_STEPS
                or not (math.isfinite(ke) and ke < ke0)
                or not div < UNIFORM_DIV_GATE):
            raise AssertionError(f"CG-getZ run: launches {launches}, "
                                 f"executed {executed}, fused "
                                 f"{fb.iterations['executed']}, iterations "
                                 f"{iters}, KE {ke0} -> {ke}, max|div u| "
                                 f"{div}")
        log(f"  {CG_STEPS} steps at {N_MAIN}^3 in {wall:.3f} s "
            f"({wall / CG_STEPS * 1e3:.2f} ms/step), iterations {iters} "
            f"({executed} executed), getz_cg launches {launches['getz_cg']} "
            f"= 2 x executed; KE {ke0:.8e} -> {ke:.8e}, max|div u| "
            f"{div:.3e}")
        # one uniform solve of the same composition, kernels against the
        # plain getZ on the card
        gen = torch.Generator(device=s.device)
        gen.manual_seed(SEED + 7)
        rhs = torch.randn(s.grid.shape, generator=gen, device=s.device)
        u_res = {}
        for name, kernels in (("kernels", None), ("plain", False)):
            solve = krylov.build_iterative_solver(
                s.grid, tol_abs=1e-6, tol_rel=1e-4, maxiter=200,
                kernels=kernels)
            getz_cg.reset_launches()
            krylov.iterations["executed"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, st = solve(rhs, with_stats=True)
            k = int(st[1])
            u_res[name] = (x, k, time.perf_counter() - t0,
                           getz_cg.launches["getz_cg"],
                           krylov.iterations["executed"])
        (x_k, k_k, t_k, l_k, e_k), (x_p, k_p, t_p, l_p, _) = (
            u_res["kernels"], u_res["plain"])
        rel = float(torch.max(torch.abs(x_k - x_p))
                    / torch.max(torch.abs(x_p)))
        log(f"  uniform CG-getZ solve ({N_MAIN}^3): kernels {k_k} its in "
            f"{t_k:.3f} s, plain {k_p} its in {t_p:.3f} s, x rel diff "
            f"{rel:.3e}; getz_cg launches {l_k} (plain run {l_p})")
        if (abs(k_k - k_p) > 1 or not rel <= 1e-4 or l_k != 2 * e_k
                or l_p != 0):
            raise AssertionError(f"uniform CG-getZ solve: its {k_k} vs "
                                 f"{k_p}, x rel {rel:.3e}, launches {l_k} "
                                 f"for {e_k} executed, plain {l_p}")
        del d, s, u_res, x, x_k, x_p, rhs
        torch.cuda.empty_cache()

        # one forest solve with the CG getZ (two-level, legacy loop)
        dev = d_forest.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 6)
        g, _, _, fvec = _forest_vecs(d_forest, gen)
        rhs = fvec()
        kw = dict(tab_arg=d_forest._tab1, flux_arg=d_forest._ftab, geom=g,
                  vol=d_forest._vol, pmask=d_forest._pmask, graph=graph,
                  with_stats=True)
        res = {}
        for name, kernels in (("kernels", None), ("plain", False)):
            solve = amr_ops.build_amr_poisson_solver_dynamic(
                8, maxiter=200, kernels=kernels)
            getz_cg.reset_launches()
            krylov.iterations["executed"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, st = solve(rhs, **kw)
            k = int(st[1])
            res[name] = (x, k, time.perf_counter() - t0,
                         dict(getz_cg.launches),
                         krylov.iterations["executed"])
        (x_k, k_k, t_k, l_k, e_k), (x_p, k_p, t_p, l_p, _) = (
            res["kernels"], res["plain"])
        rel = float(torch.max(torch.abs(x_k - x_p))
                    / torch.max(torch.abs(x_p)))
        log(f"  forest CG-getZ solve ({g.nb} blocks): kernels {k_k} its in "
            f"{t_k:.3f} s, plain {k_p} its in {t_p:.3f} s, x rel diff "
            f"{rel:.3e}; getz_cg launches {l_k['getz_cg']} (plain run "
            f"{l_p['getz_cg']})")
        if (abs(k_k - k_p) > 1 or not rel <= 1e-4
                or l_k["getz_cg"] != 2 * e_k or l_p["getz_cg"] != 0):
            raise AssertionError(f"forest CG-getZ solve: its {k_k} vs {k_p}, "
                                 f"x rel {rel:.3e}, launches {l_k} for "
                                 f"{e_k} executed, plain {l_p}")
    return dict(launches=launches, wall=wall, iters=iters)


# ---------------------------------------------------------------------------
# phase 14: the fish main path (BASELINE config #2)
# ---------------------------------------------------------------------------


class _FirstChi:
    """Stands in for the driver's CreateObstacles: runs it and keeps the
    device sum of chi after its first call (read after the run)."""

    def __init__(self, op):
        self.op, self.name, self.first = op, op.name, None

    def __call__(self, dt):
        self.op(dt)
        if self.first is None:
            self.first = torch.sum(self.op.sim.state["chi"].double())


def fish_argv(out_dir: str, device=None) -> list:
    argv = FISH_ARGV.split() + ["-path4serialization", out_dir,
                                "-factory-content", FISH]
    return argv + (["-device", device] if device else [])


def fish_cpu_chi() -> float:
    """sum(chi) after the first step's CreateObstacles of the port on the
    CPU, same config, same first dt."""
    from cup3d_tpu_torch.__main__ import build_driver

    c = build_driver(fish_argv(os.path.join(OUT_DIR, "fish_cpu"), "cpu"))
    c.init()
    dt = c.calc_max_timestep()
    c.pipeline[0](torch.tensor(dt, dtype=c.sim.dtype))
    return float(torch.sum(c.sim.state["chi"].double()))


def fish_phase() -> dict:
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = os.path.join(OUT_DIR, "fish")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    t0 = time.perf_counter()
    d = build_driver(fish_argv(out))
    d.init()
    torch.cuda.synchronize()
    s = d.sim
    ob = s.obstacles[0]
    log(f"  build_driver + init: {time.perf_counter() - t0:.2f} s; "
        f"{s.grid.shape} cells, T = {s.grid.ncells // 512} tiles, midline "
        f"{ob.myFish.Nm} points, window {ob._window_shape}")
    watch = _FirstChi(d.pipeline[0])
    d.pipeline[0] = watch
    maxiter = next(op.solver_maxiter for op in d.pipeline
                   if op.name == "PressureProjection")

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    t0 = time.perf_counter()
    d.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fb.launches)
    executed = fb.iterations["executed"]
    residual = fb.residual_launches["lap"]  # B4 on the warm starts' r0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    div = _read_table(os.path.join(out, "div.txt"))
    forces = _read_table(os.path.join(out, "forces_0.txt"))
    log("  step  wall_s     iters  resid       umax        max|div u|  "
        "Fx")
    for i, row in enumerate(d.step_log):
        log(f"  {row['step']:4d}  {row['wall_s']:.4f}  {int(row['iters']):5d}"
            f"  {row['resid']:.3e}  {row['umax']:.4e}  {div[i][3]:.3e}  "
            f"{forces[i][1]:+.4e}")
    iters = [row["iters"] for row in d.step_log]
    if len(iters) != FISH_STEPS:
        raise AssertionError(f"ran {len(iters)} steps, expected {FISH_STEPS}")
    if not all(math.isfinite(k) and 0 <= k <= maxiter for k in iters):
        raise AssertionError(f"iteration counts out of range: {iters}")
    div_max = max(r[3] for r in div)
    div_fluid = float(diag.fluid_divergence_max(s.grid, s.state["vel"],
                                                s.state["chi"]))
    if not div_fluid <= FISH_DIV_FLUID_GATE:
        raise AssertionError(f"fish max|div u| in the fluid {div_fluid:.3e} "
                             f"over the gate {FISH_DIV_FLUID_GATE:g}")
    fields_ok = all(bool(torch.isfinite(s.state[k]).all())
                    for k in ("vel", "p", "chi", "udef"))
    kin = np.concatenate([ob.transVel, ob.angVel, ob.position, ob.force])
    if not fields_ok or not np.all(np.isfinite(kin)):
        raise AssertionError(f"non-finite fish run: fields {fields_ok}, "
                             f"kinematics {kin}")
    _check_launches("fish", iters, launches, executed)
    chi_card = float(watch.first)
    chi_cpu = fish_cpu_chi()
    rel = abs(chi_card - chi_cpu) / chi_cpu
    log(f"  sum(chi) at step 0: card {chi_card:.9e}, CPU port "
        f"{chi_cpu:.9e} (rel {rel:.3e}; gate {CHI_RTOL:g})")
    if not rel <= CHI_RTOL:
        raise AssertionError(f"sum(chi) card {chi_card} vs CPU {chi_cpu}")
    log(f"  {FISH_STEPS} steps in {wall:.3f} s ({wall / FISH_STEPS * 1e3:.2f} "
        f"ms/step), {int(sum(iters))} iterations ({executed} executed), "
        f"max|div u| {div_max:.3e} (in the fluid {div_fluid:.3e}, gate "
        f"{FISH_DIV_FLUID_GATE:g}), peak memory {peak_gb:.2f} GB")
    log(f"  fish: transVel {ob.transVel.tolist()}, angVel "
        f"{ob.angVel.tolist()}, position {ob.position.tolist()}, "
        f"force {ob.force.tolist()}, surface points {ob.n_surf_points:.0f}")
    log(f"  launches: {launches}; B4 on the warm starts' residual: "
        f"{residual}")
    if not residual > 0:
        raise AssertionError("fish: no warm-start residual on B4")
    surface = surface_dump_phase(d)
    _no_sync_step(d)
    split = _step_split(d)
    _create_split(d)
    _profile_window(d, prefix="fish_")
    return dict(launches=launches, wall=wall, iters=iters, split=split,
                surface=surface, residual=residual)


SURF_RTOL = 1e-3  # the dump's traction sum against the step's force QoI


def surface_dump_phase(d) -> dict:
    """The fish's surface-point record (ops/surface.py
    ``dump_surface_points``) on config #2's last state: the .npy file's
    rows finite, their traction sum the step's force QoI within
    SURF_RTOL (tests/test_surface.py's driver check)."""
    from cup3d_tpu_torch.ops import surface as sf

    s, ob = d.sim, d.sim.obstacles[0]
    path = os.path.join(OUT_DIR, "fish_surface_points.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sf.dump_surface_points(path, s.grid, s.state, ob, s.nu)
    dump_s = time.perf_counter() - t0
    rows = np.load(path)
    cols = {k: i for i, k in enumerate(sf.SURFACE_POINT_COLUMNS)}
    force = (rows[:, [cols["fxP"], cols["fyP"], cols["fzP"]]].sum(0)
             + rows[:, [cols["fxV"], cols["fyV"], cols["fzV"]]].sum(0))
    want = np.asarray(ob.force, np.float64)
    rel = float(np.linalg.norm(force - want) / np.linalg.norm(want))
    log(f"  surface-point dump: {n} points ({ob.n_surf_points:.0f} in the "
        f"band), {os.path.getsize(path) / 1e6:.2f} MB in {dump_s:.3f} s; "
        f"traction sum {force.tolist()} against the force QoI "
        f"{want.tolist()} (rel {rel:.2e}, gate {SURF_RTOL:g})")
    if not (n > 0 and rows.shape == (n, len(sf.SURFACE_POINT_COLUMNS))
            and np.all(np.isfinite(rows)) and rel <= SURF_RTOL):
        raise AssertionError(f"surface-point dump: {n} rows, rel {rel}")
    return dict(points=n, rel=rel, dump_s=dump_s)


def _create_split(d, reps: int = 3) -> None:
    """CreateObstacles in pieces, synchronised: the host midline (numpy),
    the rasterizer on its window, the Towers chi and udef mask."""
    from cup3d_tpu_torch.models.fish import rasterize
    from cup3d_tpu_torch.ops.chi import towers_chi

    s = d.sim
    ob = s.obstacles[0]
    tot = {"host midline": 0.0, "rasterize": 0.0, "chi + mask": 0.0}
    for _ in range(reps):
        t0 = time.perf_counter()
        ob.update_shape(s.time, s.dt)
        t1 = time.perf_counter()
        sdf, udef = ob.rasterize(s.time)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        chi = towers_chi(s.grid.pad_scalar(sdf, 1), s.grid.h)
        udef = udef * (chi > 0)[..., None]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(tot, (t1 - t0, t2 - t1, t3 - t2)):
            tot[k] += v
    n = int(np.prod(ob._window_shape))
    chunk = max(1, min(ob.myFish.Nm - 1, rasterize.CHUNK_ELEMS // n))
    log("  CreateObstacles pieces (ms, synchronised): " + ", ".join(
        f"{k} {v / reps * 1e3:.3f}" for k, v in tot.items())
        + f" (window {ob._window_shape}, {ob.myFish.Nm - 1} segments in "
        f"chunks of {chunk})")


#: operators of the fish step that must never wait for the device (the
#: projection's chunked Krylov loop reads its stop flag once a chunk, and
#: the diagnostics read their sums: both by design)
NO_SYNC_OPS = ("CreateObstacles", "AdvectionDiffusion", "UpdateObstacles",
               "Penalization", "ComputeForces")


def _no_sync_step(d) -> None:
    """One more step with torch's sync debug mode set to raise inside the
    body and fluid operators: a device read, a blocking copy or a
    ``nonzero`` there fails the run."""
    s = d.sim
    dt = d.calc_max_timestep()
    dt_dev = torch.tensor(dt, dtype=s.dtype, device=s.device)
    t0 = time.perf_counter()
    for op in d.pipeline:
        guard = op.name in NO_SYNC_OPS
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            op(dt_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    d.end_step(dt, dt_dev, t0)
    log(f"  no host sync in {', '.join(NO_SYNC_OPS)} (torch sync debug "
        "mode 'error' around them for one step)")


# ---------------------------------------------------------------------------
# phase 16: config #2 as the bench runs it (pipelined, megaloops)
# ---------------------------------------------------------------------------


def _set_flag(argv: list, flag: str, value) -> list:
    out = list(argv)
    if flag in out:
        out[out.index(flag) + 1] = str(value)
    else:
        out += [flag, str(value)]
    return out


def _bench_fish_argv(out_dir: str, nsteps: int, scan_k: int) -> list:
    argv = fish_argv(out_dir)
    for flag, value in (("-freqDiagnostics", 0), ("-nsteps", nsteps),
                        ("-pipelined", 1), ("-scan_k", scan_k)):
        argv = _set_flag(argv, flag, value)
    return argv


def _mean_ke(vel) -> float:
    return float(torch.mean(torch.sum(vel.double() ** 2, dim=-1)))


def _check_fish(d, tag: str) -> float:
    """Fields, transVel and position finite; max|div u| in the fluid
    under the bench's gate.  Returns that divergence."""
    from cup3d_tpu_torch.ops import diagnostics as diag

    s = d.sim
    ob = s.obstacles[0]
    fields_ok = all(bool(torch.isfinite(s.state[k]).all())
                    for k in ("vel", "p", "chi", "udef"))
    kin = np.concatenate([ob.transVel, ob.position])
    if not fields_ok or not np.all(np.isfinite(kin)):
        raise AssertionError(f"{tag}: non-finite run: fields {fields_ok}, "
                             f"transVel and position {kin}")
    div_fluid = float(diag.fluid_divergence_max(s.grid, s.state["vel"],
                                                s.state["chi"]))
    if not div_fluid <= FISH_DIV_FLUID_GATE:
        raise AssertionError(f"{tag}: max|div u| in the fluid "
                             f"{div_fluid:.3e} over {FISH_DIV_FLUID_GATE:g}")
    return div_fluid


def _scan_rows(d, n0: int):
    rows = d.step_log[n0:]
    if not rows or not all(r.get("scan") for r in rows):
        raise AssertionError("megaloop rows missing from the step log")
    return [r["iters"] for r in rows]


def frenet_kernel_phase(gait, bw: float, fp32_flops: float) -> dict:
    """The Frenet kernel against its plain loop on the gait's curvature at
    a few times of the first period (the main path's Nm), bitwise rerun,
    timed beside the loop and its bound."""
    from cup3d_tpu_torch.models.fish import device_midline as dm

    rs = gait["rs"]
    n = int(rs.shape[0])
    keys = ("r", "v", "nor", "vnor", "bin", "vbin")
    errs = []
    for t in (0.05, 0.3, 0.7):
        rk, vk = dm._curvature_dev(gait, torch.tensor(t, device=rs.device))
        got = dm._frenet_scan_dev(rs, rk, vk)
        want = dm._frenet_scan_dev(rs, rk, vk, kernels=False)
        for k in keys:
            errs.append(check_close(f"frenet {k} at t={t}", got[k], want[k],
                                    FRENET_RTOL))
        again = dm._frenet_scan_dev(rs, rk, vk)
        if not all(torch.equal(again[k], got[k]) for k in keys):
            raise AssertionError("frenet: a rerun differs")
    results = {}
    # reads rs, curv, dcurv, writes (n, 6, 3); ~60 flop a point
    _record(results, "frenet", errs, lambda: dm._frenet_scan_dev(rs, rk, vk),
            lambda: dm._frenet_scan_dev(rs, rk, vk, kernels=False),
            (3 + 18) * 4 * n, 60 * n, bw, fp32_flops, plain_per_sample=1)
    return results["frenet"]


def _fluid_div(d) -> float:
    from cup3d_tpu_torch.ops import diagnostics as diag

    s = d.sim
    return float(diag.fluid_divergence_max(s.grid, s.state["vel"],
                                           s.state["chi"]))


def _snapshot_fish(d) -> dict:
    """The driver's state as the recovery engine keeps it (fields cloned,
    the obstacle pickled from its host mirrors, which a flush made
    current), for another driver's ``_resilience_restore``."""
    import pickle

    from cup3d_tpu_torch.io.checkpoint import build_payload

    p = build_payload(d)
    p["fields"] = {k: torch.clone(v) for k, v in p["fields"].items()}
    p["obstacles"] = pickle.dumps(p["obstacles"])
    return p


def _witness(out: str, snap: dict, t_end: float = 0.0, dts=()) -> tuple:
    """The per-step non-pipelined port from ``snap``: with the megaloop's
    ``dts`` (each step's dt set as calc_max_timestep sets it), or with its
    own dt policy up to ``t_end``.  Its (step, t, max|div u| in the
    fluid) every SCAN_K steps and at its end, and its mean KE."""
    from cup3d_tpu_torch.__main__ import build_driver

    w = build_driver(_set_flag(_set_flag(fish_argv(out), "-freqDiagnostics",
                                         0), "-nsteps", 10 ** 6))
    w.init()
    w._resilience_restore(snap)
    s = w.sim
    curve = []
    dts = list(dts)
    while (s.step - snap["step"] < len(dts)) if dts else s.time < t_end:
        if dts:
            s.dt = dts[s.step - snap["step"]]
            if w.cfg.DLM > 0:
                s.lambda_penal = w.cfg.DLM / s.dt
            w.advance(s.dt)
        else:
            w.advance(w.calc_max_timestep())
        if (s.step - snap["step"]) % SCAN_K == 0:
            curve.append((s.step, s.time, _fluid_div(w)))
    if not curve or curve[-1][0] != s.step:
        curve.append((s.step, s.time, _fluid_div(w)))
    return curve, _mean_ke(s.state["vel"])


def bench_fish_phase(bw: float, fp32_flops: float) -> dict:
    """Config #2 as bench.py runs it, on ONE driver: FISH_STEPS pipelined
    per-step steps (bench_fish_uniform), a flush, then K-step megaloops
    (_megaloop_split's windows); the fluid's divergence gate after each
    part, beside the per-step non-pipelined port from the same state."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.models.fish import device_midline as dm
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = os.path.join(OUT_DIR, "fish16")
    os.makedirs(out, exist_ok=True)
    nscan = (SCAN_WARM + 2 * SCAN_DISPATCHES) * SCAN_K
    d = build_driver(_bench_fish_argv(out, FISH_STEPS + nscan, SCAN_K))
    d.init()
    s = d.sim
    if d._scan_k != SCAN_K:
        raise AssertionError("the fish megaloop is not eligible")
    # -- pipelined per step, as bench_fish_uniform steps it ---------------
    torch.cuda.synchronize()
    m0 = metrics.snapshot()
    fb.reset_launches()
    t0 = time.perf_counter()
    for _ in range(FISH_STEPS):
        d.advance(d.calc_max_timestep())
    d.flush_packs()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, executed = dict(fb.launches), fb.iterations["executed"]
    iters = [r["iters"] for r in d.step_log]
    if len(iters) != FISH_STEPS:
        raise AssertionError(f"pipelined: {len(iters)} steps, expected "
                             f"{FISH_STEPS}")
    _check_launches("pipelined fish", iters, launches, executed)
    stream = {k: v for k, v in metrics.delta(m0).items()
              if k.startswith("stream.") and k.endswith("{stream=qoi}")}
    div_p = _check_fish(d, "pipelined")
    pipe_ms = wall / FISH_STEPS * 1e3
    log(f"  pipelined: {FISH_STEPS} steps in {wall:.3f} s ({pipe_ms:.2f} "
        f"ms/step) to t={s.time:.4f}, {int(sum(iters))} iterations "
        f"({executed} executed), max|div u| in the fluid {div_p:.3e}; "
        f"launches {launches}")
    log("  stream: " + ", ".join(
        f"{k.split('{')[0][7:]} {v:.4g}" for k, v in sorted(stream.items())))
    snap = _snapshot_fish(d)

    # -- K-step megaloops on the same driver (_megaloop_split's windows) ---
    if not d._scan_ready():
        raise AssertionError("the fish megaloop is not ready")
    ob = s.obstacles[0]
    gait = dm.freeze_gait(ob, s.time, s.dtype)
    frenet = frenet_kernel_phase(gait, bw, fp32_flops)
    n0 = len(d.step_log)
    fb.reset_launches()
    dm.launches["frenet"] = 0
    curve = []
    for _ in range(SCAN_WARM):
        d.advance_megaloop()
        curve.append((s.step, _fluid_div(d)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCAN_DISPATCHES):
        d.advance_megaloop()
        torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / (SCAN_DISPATCHES * SCAN_K) * 1e3
    curve.append((s.step, _fluid_div(d)))
    host = 0.0
    t0 = time.perf_counter()
    for _ in range(SCAN_DISPATCHES):
        t1 = time.perf_counter()
        d.advance_megaloop()
        host += time.perf_counter() - t1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (SCAN_DISPATCHES * SCAN_K) * 1e3
    d.flush_packs()
    launches, executed = dict(fb.launches), fb.iterations["executed"]
    frenet["launches"] = dm.launches["frenet"]
    scan_iters = _scan_rows(d, n0)
    if len(scan_iters) != nscan or frenet["launches"] != nscan:
        raise AssertionError(f"megaloops: {len(scan_iters)} rows, "
                             f"{frenet['launches']} Frenet launches")
    _check_launches("fish megaloop", scan_iters, launches, executed)
    curve.append((s.step, _fluid_div(d)))
    log(f"  megaloop K={SCAN_K}: wall {wall_ms:.2f} ms/step, synchronised "
        f"each dispatch {device_ms:.2f} ms/step (wall/device "
        f"{wall_ms / device_ms:.3f}), host dispatch "
        f"{host / (SCAN_DISPATCHES * SCAN_K) * 1e3:.2f} ms/step; "
        f"{nscan} steps to t={s.time:.4f}, {int(sum(scan_iters))} "
        f"iterations ({executed} executed); launches {launches}")
    # the megaloop against the per-step port from the same state: at the
    # megaloop's dts it must read what the megaloop reads; at its own dt
    # policy it shows how far the reading moves with the dt sequence
    same_dt, ke_w = _witness(os.path.join(out, "witness"), snap,
                             dts=[r["dt"] for r in d.step_log[n0:]])
    own_dt, _ = _witness(os.path.join(out, "witness_own"), snap,
                         t_end=s.time)
    ke = _mean_ke(s.state["vel"])
    log("  max|div u| in the fluid, (step, value): megaloops " + ", ".join(
        f"({k}, {v:.4e})" for k, v in curve) + f"; the per-step port from "
        f"step {snap['step']} at the megaloop's dts " + ", ".join(
        f"({k}, {v:.4e})" for k, _, v in same_dt) + ", at its own dts "
        "(step, t, value) " + ", ".join(
        f"({k}, {t:.4f}, {v:.4e})" for k, t, v in own_dt) + f"; mean KE "
        f"{ke:.9e} against the per-step port's {ke_w:.9e}")
    fields_ok = all(bool(torch.isfinite(s.state[k]).all())
                    for k in ("vel", "p", "chi", "udef"))
    kin = np.concatenate([ob.transVel, ob.position])
    if not fields_ok or not np.all(np.isfinite(kin)):
        raise AssertionError(f"megaloop: non-finite run: fields {fields_ok}, "
                             f"transVel and position {kin}")
    want = {k: v for k, _, v in same_dt}
    for k, v in curve:
        if k in want and not abs(v - want[k]) <= SCAN_DIV_RTOL * want[k]:
            raise AssertionError(
                f"megaloop: max|div u| in the fluid {v:.4e} at step {k}, "
                f"the per-step port's at the same dts {want[k]:.4e}")
    if not abs(ke - ke_w) <= SCAN_WITNESS_KE_RTOL * ke_w:
        raise AssertionError(f"megaloop: mean KE {ke} against the per-step "
                             f"port's {ke_w} at the same dts")
    # the device midline alone, synchronised: with the Frenet kernel, and
    # the recurrence's plain loop alone
    carry = d._scan_carry
    samples = []
    for _ in range(MIDLINE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dm.midline_state_device(gait, carry["time"], carry["dt"],
                                carry["qint"])
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    midline_ms = statistics.median(samples)
    log(f"  device midline ({ob.myFish.Nm} points): {midline_ms:.3f} ms a "
        f"call, synchronised (median of {MIDLINE_REPS}); its Frenet loop "
        f"alone, plain: {frenet['plain_ms']:.3f} ms, kernel "
        f"{frenet['ms']:.4f} ms")
    prof = _profile_window(d, steps=SCAN_K, prefix="fish_scan_", run=lambda: (
        d.advance_megaloop(), d.flush_packs()), trace=False)
    d._scan_carry = None

    # -- K = 1 against K = 8 on the card -----------------------------------
    kes = {}
    for k in (1, SCAN_K):
        dk = build_driver(_bench_fish_argv(os.path.join(out, f"k{k}"),
                                           SCAN_STEPS, k))
        dk.init()
        dk.simulate()
        if dk._scan_k != k or dk.sim.step != SCAN_STEPS:
            raise AssertionError(f"K={k}: scan_k {dk._scan_k}, step "
                                 f"{dk.sim.step}")
        _check_fish(dk, f"K={k}")
        kes[k] = _mean_ke(dk.sim.state["vel"])
        del dk
    dke = abs(kes[1] - kes[SCAN_K])
    log(f"  K=1 against K={SCAN_K} over {SCAN_STEPS} steps: mean KE "
        f"{kes[1]:.9e} / {kes[SCAN_K]:.9e} (|diff| {dke:.3e}, gate "
        f"{SCAN_KE_RTOL:g} relative)")
    if not dke <= SCAN_KE_RTOL * max(abs(kes[1]), 1e-12):
        raise AssertionError(f"fish K=1 vs K={SCAN_K}: KE {kes}")
    return dict(pipelined_ms=pipe_ms, scan_wall_ms=wall_ms,
                scan_device_ms=device_ms, midline_ms=midline_ms,
                busy=prof["busy_ms"] / max(prof["wall_ms"], 1e-9),
                frenet=frenet)


def tgv_scan_phase(phase5_ms: float) -> dict:
    """The 256^3 TGV through build_driver, pipelined: per step on the
    device dt chain (-scan_k 0), then as K = 8 megaloops; for each,
    launch counts, decaying KE, max|div u| and ms/step, beside phase 5's
    (non-pipelined, fixed dt 1e-3, diagnostics every step)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    nb = N_MAIN // 8
    out = {}
    for tag, k in (("dt chain", 0), (f"K={SCAN_K} megaloop", SCAN_K)):
        argv = (f"-bpdx {nb} -bpdy {nb} -bpdz {nb} -levelMax 1 "
                "-extent 6.283185307179586 -initCond taylorGreen "
                "-poissonSolver iterative -poissonTol 1e-6 "
                f"-poissonTolRel 1e-4 -nu 1e-3 -CFL {TGV_SCAN_CFL} "
                f"-rampup 0 -tend 0 -nsteps {TGV_SCAN_STEPS} -verbose 0 "
                f"-freqDiagnostics 0 -pipelined 1 -scan_k {k} "
                "-path4serialization "
                f"{os.path.join(OUT_DIR, f'tgv_scan{k}')}").split()
        d = build_driver(argv)
        d.init()
        s = d.sim
        if d._scan_k != k or not (k or d._dt_chain):
            raise AssertionError(f"TGV {tag}: K {d._scan_k}, dt chain "
                                 f"{d._dt_chain}")
        ke0 = _mean_ke(s.state["vel"])
        torch.cuda.synchronize()
        fb.reset_launches()
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, executed = dict(fb.launches), fb.iterations["executed"]
        iters = _scan_rows(d, 0) if k else [r["iters"] for r in d.step_log]
        if len(iters) != TGV_SCAN_STEPS:
            raise AssertionError(f"TGV {tag}: {len(iters)} steps")
        _check_launches(f"TGV {tag}", iters, launches, executed)
        ke = _mean_ke(s.state["vel"])
        _, div = diag.divergence_norms(s.grid, s.state["vel"])
        if not (math.isfinite(ke) and ke < ke0
                and float(div) < UNIFORM_DIV_GATE):
            raise AssertionError(f"TGV {tag}: KE {ke0} -> {ke}, max|div u| "
                                 f"{float(div)}")
        out[k] = wall / TGV_SCAN_STEPS * 1e3
        dts = [r["dt"] for r in d.step_log]
        log(f"  {tag}: {TGV_SCAN_STEPS} steps in {wall:.3f} s "
            f"({out[k]:.2f} ms/step; phase 5, fixed dt 1e-3: "
            f"{phase5_ms:.2f}), dt {min(dts):.4e}..{max(dts):.4e}, "
            f"{int(sum(iters))} iterations ({executed} executed), KE "
            f"{ke0:.8e} -> {ke:.8e}, max|div u| {float(div):.3e}")
        del d
    return out


# ---------------------------------------------------------------------------
# phase 15: the block-sharded forest (BASELINE config #3 on SHARDS shards)
# ---------------------------------------------------------------------------


def _shard_argv(out_dir: str) -> list:
    return (AMR_ARGV.replace(f"-nsteps {STEPS}", f"-nsteps {SHARD_STEPS}")
            + f" -verbose 0 -path4serialization {out_dir}").split()


def shard_setup_phase(dev="cuda"):
    """AMRSimulation(cfg, mesh=make_block_mesh([dev] * SHARDS)) of BASELINE
    config #3 and init(): each adaptation round builds a new ShardedForest
    (a re-shard), timed with its table builds; then the mesh is frozen."""
    from cup3d_tpu_torch.config import parse_args
    from cup3d_tpu_torch.parallel.forest import make_block_mesh
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    out = os.path.join(OUT_DIR, "shard")
    os.makedirs(out, exist_ok=True)
    cfg = parse_args(_shard_argv(out))
    t0 = time.perf_counter()
    d = AMRSimulation(cfg, mesh=make_block_mesh([torch.device(dev)]
                                                * SHARDS))
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d.adapt_enabled = False
    fo, g = d.forest, d.grid
    tab1 = d._tab1
    plans = [p for _, _, p in tab1.groups] + [tab1.final_plan]
    log(f"  AMRSimulation(mesh) + init: {init_s:.2f} s, of which forest "
        f"table builds {sum(d.table_build_s):.2f} s over "
        f"{len(d.table_build_s)} topologies "
        f"({', '.join(f'{t:.2f}' for t in d.table_build_s)} s)")
    log(f"  {g.nb} blocks on {fo.D} shards of nbs {fo.nbs}: nb_pad "
        f"{fo.nb_pad}, {fo.nb_pad - g.nb} padding blocks; width-1 face "
        f"tables: {len(plans)} exchanges, M = "
        f"{[p.M for p in plans]}, rows a shard {tab1.n_local}")
    return d, cfg, init_s


def _exchange_sizes(d) -> list:
    """(M, C) of every exchange the step runs: the width-1 tables
    assemble scalars (the solve) and vectors (the projection's
    divergence, the scores), the width-3 tables vectors (RK3)."""
    sizes = set()
    for tab, comps in ((d._tab1, (1, 3)), (d._tab3, (3,))):
        for _, _, plan in tuple(tab.groups) + ((None, None, tab.final_plan),):
            if plan.send_rows is not None:
                sizes.update((plan.M, c) for c in comps)
    return sorted(sizes)


def ring_kernel_phase(d, bw: float, dev="cuda") -> dict:
    """B14 against its plain version, bitwise, at every exchange size
    the config produces (every shift), at an odd byte count, on slices
    off 16- and 4-byte alignment, on strided slab slices (read in place)
    and as each exchange's all-to-all landing in a view of a wider
    buffer; then timed at the Krylov loop's exchange (the width-1 final
    exchange of a scalar) beside the plain version, torch.roll and the
    bound, with its device time a launch on the profile and its time
    into a given out (no allocation: the exchange's form); and one whole
    exchange of that size: one launch against D one-step launches and
    the axis swap, its kernels counted on a fresh process's profile
    (one: the gathers and landings around the ring steps are the
    kernel's own reads and writes)."""
    from cup3d_tpu_torch.parallel import compat, ring

    D = d.forest.D
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    sizes = _exchange_sizes(d)
    checked = []

    def same(a, s, out=None):
        got = ring.ring_shift_kernel(a, s, out=out)
        if not torch.equal(got, ring.ring_shift_plain(a, s)):
            raise AssertionError(f"ring_shift: kernel != plain at "
                                 f"{tuple(a.shape)} {a.dtype} shift {s}")
        checked.append((tuple(a.shape), str(a.dtype), s))

    for M, C in sizes:
        x = torch.randn((D, M, C, 8, 8, 8), generator=gen, device=dev)
        for s in range(1, D):
            same(x, s)
    odd = torch.randint(0, 256, (D, 1001), generator=gen, device=dev,
                        dtype=torch.uint8)
    same(odd, 1)
    same(odd, -1)
    for dtype, off in ((torch.float32, 1), (torch.uint8, 3)):
        n = D * 4099
        buf = torch.randint(0, 100, (n + 2 * off,), generator=gen,
                            device=dev).to(dtype)
        dst = torch.zeros_like(buf)
        same(buf[off:off + n].view(D, -1), 1,
             out=dst[off:off + n].view(D, -1))
        if dst[:off].any() or dst[off + n:].any():
            raise AssertionError("ring_shift: wrote outside the slice")
    # strided reads: a slab's x-ghost slice and one component of a vector
    # slab (words at a 12-byte stride), as _pad_slab_x reads them
    f = torch.randn((D, 16, 64, 64), generator=gen, device=dev)
    u = torch.randn((D, 16, 64, 64, 3), generator=gen, device=dev)
    for a in (f[:, 13:], f[:, :3], u[..., 1][:, 13:]):
        for s in (1, -1):
            got = ring.ring_shift(a, s)
            if not torch.equal(got, ring.ring_shift_plain(a, s)):
                raise AssertionError(f"ring_shift: strided {a.stride()} "
                                     f"shift {s}: kernel != plain")
            checked.append((tuple(a.shape), "strided", s))
    # the all-to-all in one launch, reading each chunk in place and
    # landing it in a view of a wider buffer (faces.py's recv region)
    for M, C in sizes:
        send = torch.randn((D, D, M, C, 8, 8, 8), generator=gen, device=dev)
        want = ring.ring_steps_plain(send, torch.empty_like(send), 0, D,
                                     True)
        ext = torch.zeros((D, D * M + 5, C, 8, 8, 8), device=dev)
        region = ext[:, 5:].unflatten(1, (D, M))
        ring.ring_all_to_all(send, out=region)
        if not (torch.equal(region, want) and torch.equal(
                want, compat.all_to_all(send)) and not ext[:, :5].any()):
            raise AssertionError(f"ring_all_to_all at M={M}, C={C}: kernel "
                                 "!= plain / swap, or wrote outside")
        checked.append(((D, D, M, C), "all_to_all", 0))
    torch.cuda.synchronize()
    log(f"  B14 bitwise equal to the plain copy: {len(checked)} cases, "
        f"exchange sizes (M, C) {sizes}, shifts 1..{D - 1}, {D}x1001 "
        "bytes, f32 and uint8 slices off alignment, strided slab slices, "
        "each exchange's all-to-all into a view")
    Mk = d._tab1.final_plan.M
    x = torch.randn((D, Mk, 1, 8, 8, 8), generator=gen, device=dev)
    nbytes = x.numel() * x.element_size()
    pre = torch.empty_like(x)
    res = dict(max_abs_err=0.0,
               ms=time_ms(lambda: ring.ring_shift_kernel(x, 1)),
               into_ms=time_ms(lambda: ring.ring_steps_kernel(x, pre, 1)),
               plain_ms=time_ms(lambda: ring.ring_shift_plain(x, 1)),
               bound_ms=2 * nbytes / bw * 1e3, bound_by="bytes",
               library_ms=time_ms(lambda: torch.roll(x, 1, 0)),
               shape=list(x.shape))
    # one whole exchange of the Krylov loop's size: B14 in one launch, in
    # D launches of one step each, and the axis swap; its kernels on the
    # profile
    send = torch.randn((D, D, Mk, 1, 8, 8, 8), generator=gen, device=dev)
    sb = send.numel() * send.element_size()

    def by_steps():
        out = torch.empty_like(send)
        for k in range(D):
            ring.ring_steps_kernel(send, out, k, 1, chunked=True)
        return out

    # its launches: B14's from the wrapper's count; every kernel (gathers
    # and landings included) and the device times from torch.profiler in
    # a fresh process at this exchange's size (tools/kernel_ab.py: a
    # profiler window late in this long process can miss kernel records)
    ring.reset_launches()
    ring.ring_all_to_all(send)
    torch.cuda.synchronize()
    b14 = ring.launches["ring_shift"]
    ab = subprocess.run(
        [sys.executable, os.path.join("cup3d_tpu_torch", "tools",
                                      "kernel_ab.py"), "--only", "ring",
         "--child", ".", str(Mk)], capture_output=True, text=True,
        check=True, timeout=600)
    prof = json.loads(ab.stdout.strip().splitlines()[-1])
    res["device_us"] = prof["ring_shift"]["device_us"]
    res["exchange"] = dict(
        shape=list(send.shape), ms=time_ms(lambda: ring.ring_all_to_all(send)),
        steps_ms=time_ms(by_steps),
        swap_ms=time_ms(lambda: compat.all_to_all(send)),
        bound_ms=2 * sb / bw * 1e3,
        device_us=prof["all_to_all"]["ring_device_us"], launches=b14,
        kernels=prof["all_to_all"]["kernels"])
    Mb, Cb = max(sizes, key=lambda s: s[0] * s[1])
    xb = torch.randn((D, Mb, Cb, 8, 8, 8), generator=gen, device=dev)
    nb2 = xb.numel() * xb.element_size()
    res["largest"] = dict(
        shape=list(xb.shape),
        ms=time_ms(lambda: ring.ring_shift_kernel(xb, 1)),
        plain_ms=time_ms(lambda: ring.ring_shift_plain(xb, 1)),
        library_ms=time_ms(lambda: torch.roll(xb, 1, 0)),
        bound_ms=2 * nb2 / bw * 1e3)
    for key, r, b in (("Krylov exchange", res, nbytes),
                      ("largest exchange", res["largest"], nb2)):
        log(f"  ring_shift at {key} {tuple(r['shape'])} ({b / 1e6:.3f} MB): "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"torch.roll {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            "ms (bytes)")
    e = res["exchange"]

    def us(v):
        return "not measured" if v is None else f"{v:.2f} us"

    log(f"  device {us(res['device_us'])} a launch; into a given out "
        f"{res['into_ms']:.4f} ms a call; one ring_all_to_all "
        f"{tuple(e['shape'])} ({sb / 1e6:.3f} MB): {e['ms']:.4f} ms in one "
        f"launch ({us(e['device_us'])} on the device), {e['steps_ms']:.4f}"
        f" ms in {D} one-step launches, the swap {e['swap_ms']:.4f} ms, "
        f"bound {e['bound_ms']:.4f} ms; {e['launches']} B14 launch(es), "
        f"{e['kernels']:g} kernel(s) in all on its profile")
    if not (e["launches"] == 1 and 0 < e["kernels"] <= D):
        raise AssertionError(f"one exchange launched {e['kernels']} kernels "
                             f"({e['launches']} B14)")
    return res


def _snapshot(d) -> dict:
    from cup3d_tpu_torch.io.checkpoint import build_payload

    payload = build_payload(d)
    payload["fields"] = {k: v.clone() for k, v in payload["fields"].items()}
    return payload


def _steps(d, n: int) -> None:
    for _ in range(n):
        d.advance(d.calc_max_timestep())


def shard_phase(d, cfg, bw: float, dev="cuda") -> dict:
    """The sharded forest against the unsharded port forest of the same
    state through the same static tile-only composition: the first RK3
    stage (bitwise), one Poisson solve at the production tolerances (its
    iterations in the reference's range under 1e-7 input noise widened
    by one) and to SHARD_TIGHT (x within SHARD_X_ATOL), ring and
    axis-swap transport (bitwise over 2 steps); then
    the main path (SHARD_STEPS steps through simulate(), the B14 counter
    set to 0 just before and read just after) against the reference's
    (velocity within SHARD_VEL_ATOL); a profiler window; the sharded lanes
    Laplacian at N_MAIN^3.  Every gate is checked and reported before
    the phase fails."""
    from cup3d_tpu_torch.grid.uniform import UniformGrid
    from cup3d_tpu_torch.ops import amr_ops, krylov
    from cup3d_tpu_torch.parallel import ring
    from cup3d_tpu_torch.parallel.forest import make_block_mesh
    from cup3d_tpu_torch.sim.amr import (AMRSimulation, load_state_numpy,
                                         state_to_numpy)

    fo, g = d.forest, d.grid
    problems = []
    s0 = _snapshot(d)
    # -- the reference: the same state on the unsharded forest, with the
    # static tile-only solve
    t0 = time.perf_counter()
    with _env(CUP3D_BUCKET="0"):  # the unpadded forest of PR 5's bitwise
        ref = AMRSimulation(cfg, device=dev)
    load_state_numpy(ref, *state_to_numpy(d))
    ref.adapt_enabled = False
    ref._solver = amr_ops.build_amr_poisson_solver(
        ref.grid, tol_abs=cfg.poissonTol, tol_rel=cfg.poissonTolRel,
        maxiter=ref._poisson_maxiter, tab=ref._tab1, flux_tab=ref._ftab,
        mean_constraint=cfg.bMeanConstraint, two_level=False, device=dev)
    torch.cuda.synchronize()
    log(f"  reference (unsharded forest, static tile-only solve) set up in "
        f"{time.perf_counter() - t0:.2f} s; same forest: "
        f"{ref.grid.keys == g.keys}")

    # -- the first RK3 stage, then the step and one solve ----------------
    dt = d.calc_max_timestep()
    dt_dev = torch.tensor(dt, dtype=d.dtype, device=d.device)
    uinf = d.uinf_device()
    st_s = amr_ops.advdiff_rhs_blocks(fo.geom, d.state["vel"], d._tab3, d.nu,
                                      uinf, d._ftab)
    st_r = amr_ops.advdiff_rhs_blocks(g, ref.state["vel"], ref._tab3, ref.nu,
                                      uinf, ref._ftab)
    stage_eq = torch.equal(fo.unpad(st_s), st_r)
    pad_zero = not st_s[g.nb:].any()
    if not (stage_eq and pad_zero):
        problems.append(f"first RK3 stage: bitwise {stage_eq}, padding "
                        f"zero {pad_zero}, max diff "
                        f"{float((fo.unpad(st_s) - st_r).abs().max()):.3e}")
    v_s = amr_ops.rk3_step_blocks(fo.geom, d.state["vel"], dt_dev, d.nu,
                                  uinf, d._tab3, d._ftab)
    v_r = amr_ops.rk3_step_blocks(g, ref.state["vel"], dt_dev, ref.nu, uinf,
                                  ref._tab3, ref._ftab)
    rk3_diff = float((fo.unpad(v_s) - v_r).abs().max())
    b_s = amr_ops.pressure_rhs_blocks(fo.geom, v_s, dt_dev, d._tab1, d._ftab)
    b_r = amr_ops.pressure_rhs_blocks(g, v_r, dt_dev, ref._tab1, ref._ftab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_s, k_s = d._solver(b_s, None, tab_arg=d._tab1, flux_arg=d._ftab,
                         with_stats=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_r, k_r = ref._solver(b_r, None, tab_arg=ref._tab1, flux_arg=ref._ftab,
                           with_stats=True)
    torch.cuda.synchronize()
    solve_r = time.perf_counter() - t0
    x_prod = float((fo.unpad(x_s) - x_r).abs().max())
    k_s, k_r = int(k_s[1]), int(k_r[1])
    # x held at convergence: both solved to SHARD_TIGHT (the trajectories
    # of two f32 tile-only solves part at rounding level, so x at the
    # production stopping point differs by up to its tolerance)
    tight = dict(tol_abs=0.0, tol_rel=SHARD_TIGHT, maxiter=SHARD_TIGHT_ITERS)
    xt_s, kt_s = fo.build_poisson_solver(**tight)(b_s, with_stats=True)
    xt_r, kt_r = amr_ops.build_amr_poisson_solver(
        g, tab=ref._tab1, flux_tab=ref._ftab, two_level=False, device=dev,
        **tight)(b_r, with_stats=True)
    x_diff = float((fo.unpad(xt_s) - xt_r).abs().max())
    kt = (int(kt_s[1]), int(kt_r[1]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    noise = 1e-7 * float(b_r.abs().max())
    ks = [k_r] + [int(ref._solver(
        b_r + noise * torch.randn(b_r.shape, generator=gen, device=dev),
        None, tab_arg=ref._tab1, flux_arg=ref._ftab, with_stats=True)[1][1])
        for _ in range(4)]
    log(f"  first RK3 stage bitwise {stage_eq} (padding rows zero "
        f"{pad_zero}); the whole RK3 step max diff {rk3_diff:.3e}; one "
        f"solve: sharded {k_s} its in {solve_s:.3f} s, unsharded {k_r} in "
        f"{solve_r:.3f} s (under 1e-7 noise {ks[1:]}), max|x diff| "
        f"{x_prod:.3e} (max|x| {float(x_r.abs().max()):.3e}); solved to "
        f"{SHARD_TIGHT:g} relative ({kt[0]} and {kt[1]} its): max|x diff| "
        f"{x_diff:.3e}")
    if not x_diff <= SHARD_X_ATOL:
        problems.append(f"converged solve x diff {x_diff:.3e} > "
                        f"{SHARD_X_ATOL}")
    if not min(ks) - 1 <= k_s <= max(ks) + 1:
        problems.append(f"solve iterations {k_s} outside {ks} +-1")
    del st_s, st_r, v_s, v_r, b_s, b_r, x_s, x_r, xt_s, xt_r

    # -- ring and axis-swap transport: 2 steps each, bitwise -------------
    fields, step_ms = {}, {}
    for halo in ("1", "0"):
        d._resilience_restore(s0)
        with _env(CUP3D_RING_HALO=halo):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _steps(d, 2)
            torch.cuda.synchronize()
            step_ms[halo] = (time.perf_counter() - t0) / 2 * 1e3
        fields[halo] = {k: v.clone() for k, v in d.state.items()}
    swap_eq = all(torch.equal(fields["1"][k], fields["0"][k])
                  for k in fields["1"])
    log(f"  2 steps on the ring transport ({step_ms['1']:.2f} ms/step) and "
        f"on the axis swap ({step_ms['0']:.2f} ms/step): bitwise equal "
        f"{swap_eq}")
    if not swap_eq:
        problems.append("ring and axis-swap runs differ")
    del fields

    # -- the main path -----------------------------------------------------
    d._resilience_restore(s0)
    d.step_log.clear()
    with _env(CUP3D_RING_HALO="1"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ring.reset_launches()
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ring.launches["ring_shift"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        ref.simulate()
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        vel_diff = float((fo.unpad(d.state["vel"])
                          - ref.state["vel"]).abs().max())
        iters = [int(r["iters"]) for r in d.step_log]
        ref_iters = [int(r["iters"]) for r in ref.step_log]
        maxiter = d._solver.maxiter
        ke = float(amr_ops.dissipation_blocks(
            fo.geom, d.state["vel"], d.nu, d._tab1)["kinetic_energy"])
        _, div_max = amr_ops.divergence_norms_blocks(fo.geom, d.state["vel"],
                                                     d._tab1)
        div_max = float(div_max)
        log(f"  {SHARD_STEPS} steps sharded in {wall:.3f} s "
            f"({wall / SHARD_STEPS * 1e3:.2f} ms/step), iterations {iters}; "
            f"unsharded reference {ref_wall / SHARD_STEPS * 1e3:.2f} ms/step, "
            f"iterations {ref_iters}; max|vel diff| {vel_diff:.3e}; "
            f"B14 launches {launches} ({launches / SHARD_STEPS:.1f} a step); "
            f"KE {ke:.8e}, max|div u| {div_max:.3e}; peak memory "
            f"{peak_gb:.2f} GB")
        if len(iters) != SHARD_STEPS or not all(0 < k <= maxiter
                                                for k in iters):
            problems.append(f"iteration counts {iters}")
        if not vel_diff <= SHARD_VEL_ATOL:
            problems.append(f"velocity diff {vel_diff:.3e} > "
                            f"{SHARD_VEL_ATOL}")
        if not (launches > 0 and math.isfinite(ke)
                and div_max < AMR_DIV_GATE):
            problems.append(f"launches {launches}, KE {ke}, max|div u| "
                            f"{div_max}")
        split = _amr_step_split(d)
        prof = _profile_window(d, steps=1, prefix="shard_", trace=False)
    del ref
    torch.cuda.empty_cache()

    # -- the sharded lanes Laplacian at N_MAIN^3 ---------------------------
    grid = UniformGrid((N_MAIN,) * 3, (2 * math.pi,) * 3)
    t = krylov.to_lanes(torch.randn((N_MAIN,) * 3, generator=gen,
                                    device=dev))
    want = krylov.make_laplacian_lanes(grid)(t)
    got = ring.make_laplacian_lanes_sharded(
        grid, make_block_mesh([torch.device(dev)] * SHARDS))(t)
    lap_err, lap_scale = max_err(got, want)
    log(f"  sharded lanes Laplacian at {N_MAIN}^3 on {SHARDS} shards: max "
        f"err {lap_err:.3e} ({lap_err / lap_scale:.2e} of max |ref|)")
    if not lap_err <= LAP_SHARD_RTOL * lap_scale:
        problems.append(f"sharded lanes Laplacian err {lap_err:.3e}")
    if problems:
        raise AssertionError("phase 15: " + "; ".join(problems))
    return dict(launches=launches, wall=wall, ref_wall=ref_wall,
                iters=iters, split=split, prof=prof)


# ---------------------------------------------------------------------------
# phases 17-21: the uniform driver complete and the output path
# ---------------------------------------------------------------------------

# BASELINE config #5 (bench.py bench_channel): 128 x 64 x 64, walls in y
CHANNEL_ARGV = ("-bpdx 16 -bpdy 8 -bpdz 8 -levelMax 1 -levelStart 0 "
                "-extent 2 -CFL 0.4 -nu 1e-3 -tend 0 -nsteps 1000000000 "
                "-rampup 0 -BC_y wall -uMax_forced 0.5 -bFixMassFlux 1 "
                "-poissonSolver iterative -poissonTol 1e-6 "
                "-poissonTolRel 1e-4 -verbose 0 -freqDiagnostics 0 "
                "-dumpVelocity 1 -dumpOmega 1")
CH_WARM, CH_TIMED = 3, 10   # bench.py _time_steps(warmup=3, iters=10)
CH_FLUX_RTOL = 0.05         # bulk velocity vs target (tests/test_massflux.py)
# the channel from a seeded divergent state (the bench's own state stays
# u(y), div u = 0, every solve at iteration 0): the kernels on wall faces,
# the fused solve against the legacy one (ROADMAP rule 2: its bound on
# the velocity through the drivers, tests/test_torch_simulation.py)
CH_PERTURB = 0.05
CH_PERTURB_STEPS = 5
CH_VEL_RTOL = 1e-3
CH_RESUME_STEPS = 3
# -implicitDiffusion 1 on phase 5's 256^3 TGV
IMPLICIT_STEPS = 10
# bodies: config #2's 128^3 box
TWO_FISH = ("StefanFish L=0.4 T=1.0 xpos=0.2 ypos=0.5 zpos=0.5 "
            "planarAngle=180 heightProfile=danio widthProfile=stefan "
            "bFixFrameOfRef=1\n"
            "StefanFish L=0.4 T=1.0 xpos=0.7 ypos=0.5 zpos=0.5 "
            "heightProfile=danio widthProfile=stefan")  # baseline/run_baseline.sh
TWO_FISH_STEPS = 20
# towed at 0.1 through the box (a free body in fluid at rest stays at
# rest): the sphere's drag, the foil's lift at 10 degrees
RIGID_BODIES = ("sphere L=0.2 xpos=0.5 ypos=0.5 zpos=0.5 xvel=0.1 "
                "bForcedInSimFrame=1",
                "naca L=0.4 xpos=0.5 ypos=0.5 zpos=0.5 planarAngle=10 "
                "xvel=0.1 bForcedInSimFrame=1")
RIGID_STEPS = 10


def _fresh_dir(out: str) -> str:
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    return out


def _channel_driver(out: str, extra: str = ""):
    from cup3d_tpu_torch.__main__ import build_driver

    _fresh_dir(out)
    return build_driver(f"{CHANNEL_ARGV} {extra} -path4serialization "
                        f"{out}".split())


def _steps_ms(d, n: int) -> float:
    """Mean host wall of ``n`` steps between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _wall_lanes(grid, gen):
    """Seeded tile-major w with the wall grid's coarse aux (B2), built as
    the fused driver builds it (B4 reads its faces from w itself)."""
    from cup3d_tpu_torch.ops import krylov

    T = grid.ncells // 512
    w = torch.randn((T, 8, 8, 8), generator=gen, device="cuda")
    zc = krylov._make_coarse_core(grid, 8)(torch.sum(w, dim=(1, 2, 3)))
    aux = torch.cat([krylov.make_face_deltas(grid, 8)(zc), zc[None, :],
                     zc.new_zeros(1, T)], dim=0)
    return w, aux


def channel_wall_kernels(grid) -> dict:
    """B2 and B4 on config #5's wall-bounded lanes against their plain
    versions, and each rerun bitwise."""
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    w, aux = _wall_lanes(grid, gen)
    a = torch.randn(w.shape, generator=gen, device="cuda")
    h2 = grid.h * grid.h
    got = fb.getz_two(w, aux, h2)
    errs = {"getz_two": check_close("getz_two (walls)", got,
                                    fb.getz_two(w, aux, h2, kernels=False),
                                    GETZ_RTOL)}
    same = torch.equal(got, fb.getz_two(w, aux, h2))
    geom = fb.LapGeom(grid)
    for store in (torch.float32, BF16):  # B4 bitwise at both storages
        ws, as_ = w.to(store), a.to(store)
        got = fb.lap(ws, as_, 1.0 / h2, geom)
        want = fb.lap(ws, as_, 1.0 / h2, geom, kernels=False)
        errs["lap"] = check_bitwise(f"lap (walls, {store})", got[0], want[0])
        aw = got[0].float()
        check_close("lap partial (walls)", got[1], want[1], PART_RTOL,
                    part_scale(as_.float() * aw))
        check_close("lap partial Aw.Aw (walls)", got[2], want[2], PART_RTOL,
                    part_scale(aw * aw))
        again = fb.lap(ws, as_, 1.0 / h2, geom)
        same = same and all(torch.equal(x, y) for x, y in zip(got, again))
    if not same:
        raise AssertionError("B2/B4 on wall lanes: rerun not bitwise")
    log(f"  B2, B4 on the wall-bounded lanes (T = {w.shape[0]}, NB "
        f"{geom.nb}): max abs err {errs['getz_two']:.3e}; B4's Aw bitwise "
        "its plain version at f32 and bf16; reruns bitwise")
    return errs


def channel_phase() -> dict:
    """BASELINE config #5 as the bench runs it (its window and gates), B2
    and B4 on its wall-bounded lanes, then the run from a seeded
    divergent state: the kernels' launches on the walls, the fused solve
    against the legacy one."""
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = os.path.join(OUT_DIR, "channel")
    t0 = time.perf_counter()
    d = _channel_driver(out)
    d.init()
    torch.cuda.synchronize()
    s = d.sim
    log(f"  build_driver + init: {time.perf_counter() - t0:.2f} s; "
        f"{s.grid.shape} cells, BCs {[b.value for b in s.grid.bc]}")
    errs = channel_wall_kernels(s.grid)

    # -- as the bench runs it: 3 warm-up steps, 10 timed -----------------
    fb.reset_launches()
    for _ in range(CH_WARM):
        d.advance(d.calc_max_timestep())
    ms = _steps_ms(d, CH_TIMED)
    iters = [r["iters"] for r in d.step_log]
    _, div_max = diag.divergence_norms(s.grid, s.state["vel"])
    div_max = float(div_max)
    s.logger.flush()
    flux = _read_table(os.path.join(out, "flux.txt"))
    target = 2.0 / 3.0 * d.cfg.uMax_forced
    u_bulk = flux[-1][2]
    log(f"  bench window: {ms:.3f} ms/step over {CH_TIMED} steps after "
        f"{CH_WARM}; iterations a step {iters}; max|div u| {div_max:.3e}; "
        f"flux.txt last {flux[-1]} (target {target:.6f})")
    if not (div_max < UNIFORM_DIV_GATE and abs(u_bulk - target)
            < CH_FLUX_RTOL * target and len(flux) == CH_WARM + CH_TIMED):
        raise AssertionError(f"config #5: max|div u| {div_max:.3e}, bulk "
                             f"{u_bulk} vs {target}, {len(flux)} rows")
    if not bool(torch.isfinite(s.state["vel"]).all()):
        raise AssertionError("config #5: non-finite velocity")

    # -- from a seeded divergent state: the kernels on the walls ----------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    vel0 = s.state["vel"] + CH_PERTURB * torch.randn(
        s.state["vel"].shape, generator=gen, device="cuda")
    runs = {}
    for fused in ("1", "0"):
        with _env(CUP3D_FUSED=fused):
            r = _channel_driver(os.path.join(out, f"fused{fused}"))
        r.init()
        r.sim.state["vel"] = vel0.clone()
        r.sim.time, r.sim.step = s.time, s.step
        fb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CH_PERTURB_STEPS):
            r.advance(r.calc_max_timestep())
        torch.cuda.synchronize()
        runs[fused] = dict(
            d=r, wall=time.perf_counter() - t0, launches=dict(fb.launches),
            executed=fb.iterations["executed"],
            iters=[x["iters"] for x in r.step_log])
    f1, f0 = runs["1"], runs["0"]
    _check_launches("channel", f1["iters"], f1["launches"], f1["executed"])
    v1, v0 = f1["d"].sim.state["vel"], f0["d"].sim.state["vel"]
    rel = float(torch.max(torch.abs(v1 - v0)) / torch.max(torch.abs(v0)))
    log(f"  from a perturbed state ({CH_PERTURB_STEPS} steps): fused "
        f"iterations {f1['iters']}, legacy {f0['iters']}; fused "
        f"{f1['wall'] / CH_PERTURB_STEPS * 1e3:.2f} ms/step; velocity "
        f"fused vs legacy {rel:.3e} of max|u| (gate {CH_VEL_RTOL:g}); "
        f"launches {f1['launches']}")
    if not (rel <= CH_VEL_RTOL and all(
            abs(a - b) <= 1 for a, b in zip(f1["iters"], f0["iters"]))):
        raise AssertionError("config #5 perturbed: fused and legacy differ")
    return dict(d=d, perturbed=f1["d"], ms=ms, iters=iters, div_max=div_max,
                launches=f1["launches"], errs=errs)


def output_phase(d, r) -> dict:
    """The output path on config #5's drivers: two dumps (bytes equal to
    the single writer's of the same fields), an injected dump.write_fail,
    the step time with and without a dump in the window, and an async
    checkpoint of the perturbed run restored and resumed bitwise."""
    from cup3d_tpu_torch.io import dump as dmp
    from cup3d_tpu_torch.io.checkpoint import load_checkpoint
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.resilience import faults

    s = d.sim
    out = d.cfg.path4serialization
    out_ref = os.path.join(out, "single")
    os.makedirs(out_ref, exist_ok=True)
    sizes = []
    for _ in range(2):
        d.dump_fields()
        d.drain_streams()
        prefix = f"dump_{s.step:07d}"
        # the same fields, read and written by the single writer
        host = dmp.collect_dump_fields(
            d.cfg, s.state, lambda v: diag.vorticity_magnitude(s.grid, v))
        dmp.dump_fields(os.path.join(out_ref, prefix), s.time, s.grid, host)
        names = sorted(n for n in os.listdir(out) if n.startswith(prefix))
        for n in names:
            with open(os.path.join(out, n), "rb") as f1, \
                    open(os.path.join(out_ref, n), "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"dump {n}: bytes differ from the "
                                         "single writer's")
        sizes.append({n: os.path.getsize(os.path.join(out, n))
                      for n in names})
        d.advance(d.calc_max_timestep())
    log(f"  two dumps, bytes equal to the single writer's: {sizes[0]} "
        f"(and {len(sizes[1])} files at the second)")
    faults.arm("dump.write_fail", s.step, count=d._dumper.retries + 1)
    d.dump_fields()
    d.drain_streams()
    faults.clear()
    d.advance(d.calc_max_timestep())
    h = d._dumper.health()
    if h["dropped"] != 1 or h["write_failures"] != d._dumper.retries + 1:
        raise AssertionError(f"injected dump.write_fail: health {h}")
    log(f"  injected dump.write_fail: the step after it ran; dumper {h}")
    # step time with one dump in a window of CH_TIMED steps: the driver's
    # dumper (one writer thread), then one writer a core (the JAX
    # package's default)
    from cup3d_tpu_torch.stream.dump import AsyncDumper

    ms_plain = _steps_ms(d, CH_TIMED)
    windows, own = {}, d._dumper
    for tag, dumper in (("one writer", own),
                        ("a writer a core", AsyncDumper(nshards=0))):
        d._dumper = dumper
        s.cadence.fdump = CH_TIMED
        while s.step % CH_TIMED != CH_TIMED // 2:
            d.advance(d.calc_max_timestep())
        n_dumps = dumper.stats["dumps"]
        windows[tag] = _steps_ms(d, CH_TIMED)
        s.cadence.fdump = 0
        d.drain_streams()
        if dumper.stats["dumps"] != n_dumps + 1:
            raise AssertionError("the dump window held no dump")
        log(f"  {CH_TIMED} steps with one dump ({tag}): "
            f"{windows[tag]:.3f} ms/step ({windows[tag] - ms_plain:+.3f} "
            f"against {ms_plain:.3f} without); staging "
            f"{dumper.stats['submit_s'] * 1e3:.2f} ms over "
            f"{dumper.stats['dumps']} dumps, writing "
            f"{dumper.stats['write_s'] * 1e3:.1f} ms on the writer threads")
    ms_dump = windows["one writer"]
    d._dumper = own

    # -- an async checkpoint, restored and resumed bitwise ----------------
    path = r._checkpointer.save(r)
    r.drain_streams()
    back = load_checkpoint(path)
    for drv in (r, back):
        for _ in range(CH_RESUME_STEPS):
            drv.advance(drv.calc_max_timestep())
    same = all(torch.equal(r.sim.state[k], back.sim.state[k])
               for k in ("vel", "p"))
    log(f"  async checkpoint {os.path.getsize(path) / 1e6:.1f} MB, "
        f"snapshot {r._checkpointer.stats['snapshot_s'] * 1e3:.2f} ms; "
        f"resumed {CH_RESUME_STEPS} steps bitwise: {same}")
    if not same or back.sim.time != r.sim.time:
        raise AssertionError("resumed checkpoint run differs")
    return dict(ms_plain=ms_plain, ms_dump=ms_dump,
                ms_dump_cores=windows["a writer a core"])


def implicit_phase() -> dict:
    """Phase 5's 256^3 TGV with -implicitDiffusion 1 (explicit Euler
    advection, the spectral Helmholtz solve) for IMPLICIT_STEPS steps."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag

    out = _fresh_dir(os.path.join(OUT_DIR, "implicit"))
    nb = N_MAIN // 8
    d = build_driver(
        f"-bpdx {nb} -bpdy {nb} -bpdz {nb} -levelMax 1 -extent "
        "6.283185307179586 -initCond taylorGreen -implicitDiffusion 1 "
        "-poissonSolver iterative -poissonTol 1e-6 -poissonTolRel 1e-4 "
        f"-nu 1e-3 -dt {DT_MAIN} -tend 0 -nsteps {IMPLICIT_STEPS} -verbose 0 "
        f"-freqDiagnostics 1 -path4serialization {out}".split())
    d.init()
    s = d.sim
    ke0 = float(diag.dissipation(s.grid, s.state["vel"], s.nu)
                ["kinetic_energy"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    energy = _read_table(os.path.join(out, "energy.txt"))
    div = _read_table(os.path.join(out, "div.txt"))
    kes = [e[1] for e in energy]
    div_max = max(r[3] for r in div)
    ms = wall / IMPLICIT_STEPS * 1e3
    log(f"  {IMPLICIT_STEPS} steps in {wall:.3f} s ({ms:.2f} ms/step), "
        f"KE {ke0:.8e} -> {kes[-1]:.8e}, max|div u| "
        f"{div_max:.3e}, iterations {[r['iters'] for r in d.step_log]}")
    if not (all(math.isfinite(k) for k in kes) and kes[-1] < ke0
            and div_max < UNIFORM_DIV_GATE):
        raise AssertionError(f"implicit diffusion: KE {ke0} -> {kes}, "
                             f"max|div u| {div_max:.3e}")
    return dict(ms=ms)


def vorticity_phase() -> dict:
    """initCond vorticity at 128^3: the coil's nearest-point search in
    chunks and three spectral solves, timed; max|div u| of the result."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag

    d = build_driver(f"-bpdx {N_FISH // 8} -bpdy {N_FISH // 8} -bpdz "
                     f"{N_FISH // 8} -levelMax 1 -extent 2 -initCond vorticity "
                     f"-nu 1e-3 -tend 0 -nsteps 1 -verbose 0 -path4serialization "
                     f"{os.path.join(OUT_DIR, 'vorticity')}".split())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vel = d.sim.state["vel"]
    _, div_max = diag.divergence_norms(d.sim.grid, vel)
    umax = float(torch.max(torch.abs(vel)))
    log(f"  init {init_s:.3f} s; max|u| {umax:.4e}, max|div u| "
        f"{float(div_max):.3e}")
    if not (math.isfinite(umax) and umax > 0
            and float(div_max) < UNIFORM_DIV_GATE):
        raise AssertionError(f"vorticity IC: max|u| {umax}, max|div u| "
                             f"{float(div_max)}")
    return dict(init_s=init_s)


def _body_run(body: str, nsteps: int, tag: str):
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = _fresh_dir(os.path.join(OUT_DIR, tag))
    argv = _set_flag(FISH_ARGV.split(), "-nsteps", nsteps)
    d = build_driver(_set_flag(argv, "-freqDiagnostics", 0)
                     + ["-path4serialization", out, "-factory-content", body])
    d.init()
    pen = next(op for op in d.pipeline if op.name == "Penalization")
    fb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = d.sim
    iters = [r["iters"] for r in d.step_log]
    _check_launches(tag, iters, dict(fb.launches), fb.iterations["executed"])
    div_fluid = float(diag.fluid_divergence_max(s.grid, s.state["vel"],
                                                s.state["chi"]))
    ok = all(bool(torch.isfinite(s.state[k]).all())
             for k in ("vel", "p", "chi", "udef"))
    towed = np.any(s.obstacles[0].bForcedInSimFrame)
    for ob in s.obstacles:
        kin = np.concatenate([ob.transVel, ob.angVel, ob.position, ob.force])
        ok = ok and bool(np.all(np.isfinite(kin)))
        if towed:  # the drag opposes the tow
            ok = ok and float(np.dot(ob.force, ob.transVel)) < 0
        log(f"  {type(ob).__name__}: sum(chi) {float(torch.sum(ob.chi)):.1f}, "
            f"transVel {ob.transVel.tolist()}, force {ob.force.tolist()}")
    # the fish gate is the JAX bench's for swimmers; a body towed from
    # rest starts impulsively and has no gate in the JAX package
    gate = math.inf if towed else FISH_DIV_FLUID_GATE
    log(f"  {nsteps} steps in {wall:.3f} s ({wall / nsteps * 1e3:.2f} "
        f"ms/step), {int(sum(iters))} iterations, max|div u| in the fluid "
        f"{div_fluid:.3e} (gate {gate:g}); collision pass: "
        f"{len(s.obstacles) * (len(s.obstacles) - 1) // 2 * nsteps} pair "
        f"checks, {pen.collisions} steps with a collision")
    if not ok or not div_fluid <= gate:
        raise AssertionError(f"{tag}: finite {ok}, fluid div {div_fluid}")
    return dict(ms=wall / nsteps * 1e3, collisions=pen.collisions,
                launches=dict(fb.launches))


def bodies_phase() -> dict:
    out = {"two_fish": _body_run(TWO_FISH, TWO_FISH_STEPS, "two_fish")}
    for body in RIGID_BODIES:
        kind = body.split()[0]
        out[kind] = _body_run(body, RIGID_STEPS, kind)
    return out


# ---------------------------------------------------------------------------
# phase 22: BASELINE config #4 (bodies on the adapting forest)
# ---------------------------------------------------------------------------

# run.sh's flags (README.md "Running") with the bench's two factory lines
# (bench.py bench_two_fish_amr: levelMax 4, levelStart 3, Rtol 5, Ctol
# 0.1, CFL 0.4, nu 1e-3, rampup 100, iterative Poisson 1e-6/1e-4);
# non-pipelined here (the host path), CUP3D_FUSED=1
FISH_AMR_ARGV = ("-bpdx 1 -bpdy 1 -bpdz 1 -levelMax 4 -levelStart 3 "
                 "-extent 1 -Rtol 5 -Ctol 0.1 -CFL 0.4 -nu 0.001 "
                 "-rampup 100 -poissonSolver iterative -poissonTol 1e-6 "
                 "-poissonTolRel 1e-4 -tend 0 -nsteps 1000000000 -verbose 0 "
                 "-freqDiagnostics 0")
BENCH_TWO_FISH = ("StefanFish L=0.4 T=1.0 xpos=0.3 ypos=0.5 zpos=0.5 "
                  "planarAngle=180 heightProfile=danio widthProfile=stefan "
                  "bFixFrameOfRef=1\n"
                  "StefanFish L=0.4 T=1.0 xpos=0.7 ypos=0.5 zpos=0.5 "
                  "heightProfile=danio widthProfile=stefan")
# bench.py takes its first step, 24 warm-up and 20 timed; the depth here
# is cut to 8 and 12 to keep the whole run in its time limit
FA_WARM, FA_TIMED = 8, 12
FA_DIV_GATE = 0.01          # bench.py:61 ("two_fish_amr")
FA_LEGACY_STEPS = 5         # the fused solve against the legacy one
FA_VEL_RTOL = 1e-4
FA_LADDER_STEPS = 10
FA_RESUME_STEPS = 3
# a forest that regrids while it steps: one StefanFish towed at 1.0
# through config #4's forest (fixed dt, CFL 0.32 at h = 1/64); its body
# leaves blocks and enters others between the adaptations at steps 20
# and 40 (tests/test_torch_amr_sim.py tows one at levelMax 3)
TOW_AMR_ARGV = FISH_AMR_ARGV.replace("-rampup 100", "-rampup 0 -dt 0.005")
TOWED_FISH = ("StefanFish L=0.4 T=1.0 xpos=0.3 ypos=0.5 zpos=0.5 xvel=1.0 "
              "bForcedInSimFrame=1 heightProfile=danio widthProfile=stefan")
TOW_STEPS = 45


def _forest_want(executed: int, tile: int = 0) -> dict:
    """The forest kernels' launches for ``executed`` iterations, ``tile``
    of them on the tile-only rung."""
    return {"amr_update": executed, "amr_getz_two": 2 * (executed - tile),
            "amr_getz_tile": 2 * tile, "amr_lap": 2 * executed,
            "amr_axpy": executed, "amr_finish": executed}


def _levels(g) -> list:
    return np.bincount(g.level, minlength=g.tree.cfg.level_max).tolist()


def _watch_regrids(d) -> list:
    """Record (step, nb before, nb after, levels) at each regrid that
    changed the forest."""
    log_ = []
    apply = d._apply_states

    def hook(states):
        nb = d.grid.nb
        changed = apply(states)
        if changed:
            log_.append((d.step_idx, nb, d.grid.nb, _levels(d.grid)))
        return changed

    d._apply_states = hook
    return log_


def _interface_levels(d) -> np.ndarray:
    """Levels of the blocks that touch a body's interface."""
    _, near = d.scores()
    return d.grid.level[near.cpu().numpy()]


def _fish_ok(d) -> bool:
    ok = all(bool(torch.isfinite(d.state[k]).all())
             for k in ("vel", "p", "chi", "udef"))
    for ob in d.obstacles:
        kin = np.concatenate([ob.transVel, ob.angVel, ob.position, ob.force])
        ok = ok and bool(np.all(np.isfinite(kin)))
        ok = ok and float(np.linalg.norm(ob.transVel)) > 0
    return ok


def _fish_snapshot(d) -> dict:
    """The recovery engine's snapshot of the driver: fields cloned, the
    bodies pickled."""
    import pickle

    payload = _snapshot(d)
    payload["obstacles"] = pickle.dumps(payload["obstacles"])
    return payload


def _forest_reruns_bitwise(d) -> None:
    """Each of B8, B9, B11, B12, B13 twice on the same inputs at the
    forest's current topology: the outputs bitwise equal."""
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    dev = d.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    g, n, nb, vec = _forest_vecs(d, gen)

    def sc(*v):
        return fb._scalars(*(torch.tensor(x, device=dev) for x in v))

    h = g.h_column(torch.float32, dev).reshape(n)
    vol = d._vol.reshape(n).float().contiguous()
    h2 = (h * h).contiguous()
    r, p, v, rh, w, a, x, y, z, s_, t = (vec() for _ in range(11))
    zc = torch.randn(n, generator=gen, device=dev)
    zc[nb:] = 0.0
    azf = amr_ops.laplacian_blocks(
        g, zc[:, None, None, None].expand(n, 8, 8, 8), d._tab1,
        d._ftab).contiguous()
    lab = d._tab1.assemble_scalar(w, 8).contiguous()
    inv_h = (1.0 / h)[:, None, None, None]
    corr = d._ftab.apply(torch.zeros_like(w), amr_ops.face_fluxes(
        lab, 1, 8, inv_h)).contiguous()
    calls = {
        "amr_update": lambda: fa.update(r, p.clone(), v, rh.clone(), vol,
                                        sc(0.7, 1.3, 0.0)),
        "amr_getz_two": lambda: (fa.getz_two(w, azf, zc, h2),),
        "amr_lap": lambda: fa.lap(lab, corr, a, (1.0 / h2).contiguous()),
        "amr_axpy": lambda: fa.axpy(r, v, vol, sc(0.37)),
        "amr_finish": lambda: fa.finish(x.clone(), y, z, s_.clone(), t, rh,
                                        sc(0.37, 1.21)),
    }
    for name, call in calls.items():
        first, again = call(), call()
        _zero_rows(name, nb, *first)
        if not all(torch.equal(u, w_) for u, w_ in zip(first, again)):
            raise AssertionError(f"{name}: a rerun on the forest of {n} "
                                 "blocks differs")
    log(f"  B8, B9, B11, B12, B13 rerun bitwise on this forest ({n} blocks)")


FOREST_NO_SYNC = ("CreateObstacles", "Penalization", "ComputeForces")


class _NoSyncSections:
    """The driver's Profiler protocol with torch's sync debug mode set to
    raise inside the named sections."""

    def __init__(self, names):
        self.names = names

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def section():
            if name in self.names:
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return section()


def _forest_no_sync_step(d) -> None:
    """One step with a device read, a blocking copy or a ``nonzero``
    inside the forest's body sections failing the run (their reads ride
    the step's moments read and its end-of-step read)."""
    prof, d.profiler = d.profiler, _NoSyncSections(FOREST_NO_SYNC)
    try:
        d.advance(d.calc_max_timestep())
    finally:
        d.profiler = prof
    log(f"  no host sync in {', '.join(FOREST_NO_SYNC)} (torch sync debug "
        "mode 'error' around them for one step)")


def _timed_steps(d, n: int) -> list:
    """``n`` steps, the host wall of each (each ends in the step's read)."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        d.advance(d.calc_max_timestep())
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return walls


def fish_amr_phase(bw: float, fp32_flops: float) -> dict:
    """BASELINE config #4 on the host path (see the module docstring,
    phase 22); CUP3D_FUSED=1 is set by the caller."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.io.checkpoint import load_checkpoint
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    out = _fresh_dir(os.path.join(OUT_DIR, "fish_amr"))
    t0 = time.perf_counter()
    d = build_driver(FISH_AMR_ARGV.split() + [
        "-path4serialization", out, "-factory-content", BENCH_TWO_FISH])
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lv = _interface_levels(d)
    log(f"  build_driver + init: {init_s:.2f} s ({len(d.table_build_s)} "
        f"topologies, tables {sum(d.table_build_s):.2f} s); forest "
        f"{d.grid.nb} blocks, per level {_levels(d.grid)}; {lv.size} "
        f"interface blocks at levels {sorted(set(lv.tolist()))}")
    finest = d.cfg.levelMax - 1
    if not (lv.size > 0 and np.all(lv == finest)):
        raise AssertionError(f"interface blocks off the finest level: {lv}")
    regrids = _watch_regrids(d)
    maxiter = d._solver.maxiter
    # -- the main path: the bench's first step, FA_WARM, FA_TIMED ----------
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    walls = _timed_steps(d, 1 + FA_WARM + FA_TIMED)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    executed = fa.iterations["executed"]
    rows = d.step_log[-(1 + FA_WARM + FA_TIMED):]
    hist = {0: _levels(d.grid)}
    for step, _, _, lvls in regrids:
        hist[step] = lvls
    log("  step  blocks  levels            regrid  iters  ms")
    for r, w in zip(rows, walls):
        at = [x for x in regrids if x[0] == r["step"]]
        lv_now = [v for k, v in sorted(hist.items()) if k <= r["step"]][-1]
        log(f"  {r['step']:4d}  {r['nb']:6d}  {str(lv_now):16s}  "
            f"{(str(at[0][1]) + '->' + str(at[0][2])) if at else '-':6s}  "
            f"{int(r['iters']):5d}  {w * 1e3:.2f}")
    iters = [r["iters"] for r in rows]
    if not all(math.isfinite(k) and 0 <= k <= maxiter for k in iters):
        raise AssertionError(f"iteration counts out of range: {iters}")
    want = _forest_want(executed)
    if executed != _executed(rows) or launches != want or executed == 0:
        raise AssertionError(f"config #4 launch counts {launches}, executed "
                             f"{executed}, expected {want}")
    tw = np.sort(np.asarray(walls[-FA_TIMED:]))
    keep = max(1, int(np.ceil(len(tw) * 0.9)))
    ms = float(tw[:keep].mean()) * 1e3
    div = float(diag.fluid_divergence_max_blocks(
        d._geom, d.state["vel"], d.state["chi"], d._tab1))
    lv = _interface_levels(d)
    late = [x for x in regrids if x[0] > 10]
    log(f"  {len(rows)} steps in {wall:.3f} s; the bench's window "
        f"({FA_TIMED} steps after {1 + FA_WARM}): {ms:.2f} ms/step "
        f"(trimmed mean; mean {tw.mean() * 1e3:.2f}, max "
        f"{tw.max() * 1e3:.2f}); first step {walls[0] * 1e3:.2f} ms; "
        f"{sum(iters) / len(iters):.2f} iterations a step ({executed} "
        f"executed); fluid max|div u| {div:.3e} (gate {FA_DIV_GATE}); "
        f"regrids that changed the forest: {len(regrids)} "
        f"({len(late)} after step 10)")
    log(f"  launches: {launches} (per step: "
        f"{ {k: v / len(rows) for k, v in launches.items()} })")
    for i, ob in enumerate(d.obstacles):
        log(f"  fish {i}: transVel {ob.transVel.tolist()}, position "
            f"{ob.position.tolist()}, force {ob.force.tolist()}")
    if not (div < FA_DIV_GATE and _fish_ok(d) and np.all(lv == finest)):
        raise AssertionError(f"config #4: fluid div {div}, fish finite and "
                             f"moving {_fish_ok(d)}, interface levels "
                             f"{sorted(set(lv.tolist()))}")
    split = _amr_step_split(d)
    _forest_no_sync_step(d)
    prof = _profile_window(d, steps=1, prefix="fish_amr_", trace=False)

    # -- the kernels on this run's (last) topology ------------------------
    log(f"  the five forest kernels against their plain versions on this "
        f"forest ({d.grid.nb} blocks)")
    kernels = forest_kernel_phase(d, bw, fp32_flops)
    _forest_reruns_bitwise(d)

    # -- the fused solve against the legacy one from one state -------------
    snap = _fish_snapshot(d)
    runs = {}
    for tag, fused in (("fused", "1"), ("legacy", "0"), ("fused", "1")):
        d._resilience_restore(snap)
        with _env(CUP3D_FUSED=fused):
            d._build_solver_core()
            d._bind_solver()
        _steps(d, FA_LEGACY_STEPS)
        runs[tag] = ([r["iters"] for r in d.step_log[-FA_LEGACY_STEPS:]],
                     d.state["vel"].clone())
    (it_f, v_f), (it_l, v_l) = runs["fused"], runs["legacy"]
    rel = float(torch.max(torch.abs(v_f - v_l)) / torch.max(torch.abs(v_l)))
    log(f"  {FA_LEGACY_STEPS} steps from one state: iterations fused {it_f},"
        f" legacy {it_l}; velocity max diff {rel:.3e} of max|u|")
    if max(abs(a - b) for a, b in zip(it_f, it_l)) > 1 or \
            not rel <= FA_VEL_RTOL:
        raise AssertionError(f"fused against legacy: iterations {it_f} vs "
                             f"{it_l}, velocity {rel:.3e}")

    # -- the self-healing loop with both fish (B10 on the ladder) ----------
    s0 = d.step_idx
    d.cfg.nsteps = s0 + FA_LADDER_STEPS
    marks = _watch_recovery(d)
    restored = []
    restore = d._resilience_restore

    def restore_check(payload):
        import pickle

        restore(payload)
        want_pos = [ob.position for ob in pickle.loads(payload["obstacles"])]
        restored.append(len(d.obstacles) == 2 and all(
            ob.sim is d and np.array_equal(ob.position, w)
            for ob, w in zip(d.obstacles, want_pos)))

    d._resilience_restore = restore_check
    log_start = len(d.step_log)
    with _env(CUP3D_FUSED="1", CUP3D_FAULT=LADDER_FAULT.format(step=s0 + 2)):
        torch.cuda.synchronize()
        m0 = metrics.snapshot()
        fa.reset_launches()
        d.simulate()
        torch.cuda.synchronize()
        l_launches = dict(fa.launches)
        l_executed = fa.iterations["executed"]
        delta = metrics.delta(m0)
    d._resilience_restore = restore
    _check_ladder(delta, marks, out)
    idx = marks["rebuild_at"][0]
    before, after = d.step_log[log_start:idx], d.step_log[idx:]
    ex_a = _executed(after)
    want = _forest_want(l_executed, ex_a)
    if (l_launches != want or l_executed != _executed(before) + ex_a
            or len(after) < 3 or not restored or not all(restored)
            or not _fish_ok(d) or d.step_idx != d.cfg.nsteps):
        raise AssertionError(f"config #4 ladder: launches {l_launches} "
                             f"(expected {want}), {len(after)} steps after "
                             f"the rung, fish restored {restored}")
    log(f"  ladder (fault at step {s0 + 2}): {len(before)} steps before the "
        f"tile-only rung, {len(after)} after; both fish restored at each "
        f"of {len(restored)} rollbacks; B10 launches "
        f"{l_launches['amr_getz_tile']}")

    # -- an async checkpoint with both fish, resumed bitwise ---------------
    with _env(CUP3D_FUSED="1"):
        d._resilience_rebuild_poisson()  # back to the two-level solve
        snap = _fish_snapshot(d)
        path = d._checkpointer.save(d)
        d.drain_streams()
        back = load_checkpoint(path)
    # a restore re-creates the bodies at the restored time (the frame
    # velocity from the updated fish, as the JAX package's loader): the
    # live run takes the same state through its in-memory rollback
    d._resilience_restore(snap)
    for drv in (d, back):
        _steps(drv, FA_RESUME_STEPS)
    same = all(torch.equal(d.state[k], back.state[k])
               for k in ("vel", "p", "chi", "udef")) and all(
        np.array_equal(a.position, b.position)
        and np.array_equal(a.transVel, b.transVel)
        for a, b in zip(d.obstacles, back.obstacles))
    log(f"  async checkpoint with both fish ({os.path.getsize(path) / 1e6:.1f}"
        f" MB) resumed {FA_RESUME_STEPS} steps bitwise: {same}")
    if not same or back.time != d.time:
        raise AssertionError("the resumed config #4 checkpoint differs")
    bucket = _bucket_check("config #4", d)
    return dict(ms=ms, first_ms=walls[0] * 1e3, init_s=init_s, bucket=bucket,
                nb=d.grid.nb, levels=_levels(d.grid), iters=iters,
                launches=launches, executed=executed, steps=len(rows),
                tile_launches=l_launches["amr_getz_tile"], split=split,
                prof=prof, kernels=kernels, regrids=len(regrids))


def tow_amr_phase(bw: float, fp32_flops: float) -> dict:
    """One StefanFish towed through config #4's forest: the forest regrids
    while stepping, the kernels' launches against the executed
    iterations, and the five held against their plain versions on the
    topology of its last regrid."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    out = _fresh_dir(os.path.join(OUT_DIR, "tow_amr"))
    d = build_driver(TOW_AMR_ARGV.split() + [
        "-path4serialization", out, "-factory-content", TOWED_FISH])
    d.init()
    regrids = _watch_regrids(d)
    torch.cuda.synchronize()
    fa.reset_launches()
    walls = _timed_steps(d, TOW_STEPS)
    launches = dict(fa.launches)
    executed = fa.iterations["executed"]
    rows = d.step_log[-TOW_STEPS:]
    want = _forest_want(executed)
    late = [x for x in regrids if x[0] > 10]
    for step, a, b, lvls in regrids:
        log(f"  regrid at step {step}: {a} -> {b} blocks, per level {lvls}")
    log(f"  {TOW_STEPS} steps, {sum(walls) / len(walls) * 1e3:.2f} ms/step, "
        f"blocks {sorted(set(r['nb'] for r in rows))}, iterations "
        f"{[int(r['iters']) for r in rows]}; launches {launches}")
    if executed != _executed(rows) or launches != want or executed == 0:
        raise AssertionError(f"towed forest launch counts {launches}, "
                             f"executed {executed}, expected {want}")
    ok = all(bool(torch.isfinite(d.state[k]).all()) for k in d.state)
    if not (late and any(a != b for _, a, b, _ in late) and ok):
        raise AssertionError(f"towed forest: regrids after step 10 "
                             f"{late}, fields finite {ok}")
    bucket = _bucket_check("towed fish", d)
    log(f"  the five forest kernels against their plain versions after the "
        f"last regrid (step {regrids[-1][0]}, {d.grid.nb} blocks)")
    kernels = forest_kernel_phase(d, bw, fp32_flops)
    _forest_reruns_bitwise(d)
    return dict(regrids=regrids, launches=launches, kernels=kernels,
                ms=sum(walls) / len(walls) * 1e3, bucket=bucket)


# ---------------------------------------------------------------------------
# phases 23-25: the pipelined forest (BASELINE configs #3 and #4 as the
# bench runs them) and the forest's physics
# ---------------------------------------------------------------------------

# bench.py bench_amr_tgv's window is 9 warm-up and 10 timed steps; the
# warm-up is cut to 4 to keep the whole run in its time limit
PIPE_WARM, PIPE_TIMED = 4, 10
PROFILE_STEPS = 1                  # phase 23's profiler window
REGRID_WARM, REGRID_TIMED = 2, 22  # its regrid probe
PIPE_KE_STEPS = 5                  # fixed-dt steps, pipelined vs host
PIPE_KE_DT = 1e-3
PIPE_KE_RTOL = 1e-4
FOREST_CHANNEL_ARGV = ("-bpdx 8 -bpdy 4 -bpdz 4 -levelMax 2 -levelStart 1 "
                       "-extent 2 -BC_y wall -Rtol 100 -Ctol 0 -dt 0.01 "
                       "-nu 1e-3 -rampup 0 -uMax_forced 0.5 "
                       "-bFixMassFlux 1 -poissonSolver iterative "
                       "-poissonTol 1e-6 -poissonTolRel 1e-4 -tend 0 "
                       "-verbose 0")
FOREST_CHANNEL_STEPS = 10
IMPLICIT_AMR_STEPS = 3
IMPLICIT_AMR_DT = 0.01
IMPLICIT_PERTURB = 0.05  # seeded noise: gives the Helmholtz solves work
VORT_AMR_ARGV = ("-bpdx 8 -bpdy 8 -bpdz 8 -levelMax 2 -levelStart 0 "
                 "-extent 2 -initCond vorticity -Rtol 0.5 -Ctol 0.01 "
                 "-nu 1e-3 -poissonSolver iterative -poissonTol 1e-6 "
                 "-poissonTolRel 1e-4 -tend 0 -nsteps 1 -verbose 0")
PIPE_SHARD_STEPS = 5


def _bench_window(d, warm: int, iters: int, regrid_log=None):
    """bench.py's _time_steps_robust: ``warm`` steps, then ``iters``
    timed ones, the last synchronised; the trimmed mean (the top 10% of
    samples out).  With ``regrid_log`` (``_watch_regrids``' list) the
    walls are split into steady and regrid steps as
    _time_steps_split_regrid does."""
    for _ in range(warm):
        d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    walls, flags = [], []
    for i in range(iters):
        n0 = len(regrid_log) if regrid_log is not None else 0
        t0 = time.perf_counter()
        d.advance(d.calc_max_timestep())
        if i == iters - 1:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        flags.append(regrid_log is not None and len(regrid_log) > n0)
    w, f = np.asarray(walls), np.asarray(flags)
    steady = np.sort(w[~f]) if (~f).any() else np.sort(w)
    keep = max(1, int(np.ceil(steady.size * 0.9)))
    return dict(ms=float(steady[:keep].mean()) * 1e3,
                mean_ms=float(steady.mean()) * 1e3,
                max_ms=float(steady.max()) * 1e3,
                p95_ms=float(np.percentile(steady, 95)) * 1e3,
                regrid_ms=[float(x) * 1e3 for x in w[f]])


def _stream_line(d) -> str:
    st = d._pack_reader.snapshot()
    return (f"stream: {st['packs_emitted']} packs in {st['groups_read']} "
            f"reads, {st['bytes_streamed']} B streamed + "
            f"{st['bytes_staged']} B staged, stall "
            f"{st['stall_s'] * 1e3:.2f} ms, read {st['read_s'] * 1e3:.2f} ms,"
            f" kicks {st['kicks']}")


def _check_forest_launches(tag, d, launches, executed, rows) -> None:
    want = _forest_want(executed)
    if executed != _executed(rows) or launches != want or executed == 0:
        raise AssertionError(f"{tag} launch counts {launches}, executed "
                             f"{executed} (rows {_executed(rows)}), "
                             f"expected {want}")


def pipe_amr_phase(host_ms: float, full: bool = True) -> dict:
    """BASELINE config #3 as the bench runs it (see the module docstring,
    phase 23); CUP3D_FUSED=1 is set by the caller.  ``full=False``
    (phase 29's unbucketed twin) skips the profiler window and the
    comparisons with the host path."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    out = _fresh_dir(os.path.join(OUT_DIR, "pipe_amr"))
    t0 = time.perf_counter()
    d = build_driver(f"-pipelined 1 -freqDiagnostics 0 {AMR_ARGV} "
                     f"-verbose 0 -path4serialization {out}".split())
    d.init()
    d.adapt_enabled = False
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not d._dt_chain:
        raise AssertionError("config #3 pipelined is not on the device dt "
                             "chain on the card")
    log(f"  build_driver + init: {init_s:.2f} s; {d.grid.nb} blocks, per "
        f"level {_levels(d.grid)}; the device dt chain on; bucketed "
        f"{d._bucketing} (capacity {d._cap}); table builds "
        f"{sum(d.table_build_s):.2f} s")
    # -- the main path: the bench's first step, PIPE_WARM, PIPE_TIMED ------
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    win = _bench_window(d, PIPE_WARM, PIPE_TIMED)
    d.flush_packs()
    launches = dict(fa.launches)
    executed = fa.iterations["executed"]
    rows = d.step_log[-(1 + PIPE_WARM + PIPE_TIMED):]
    _check_forest_launches("config #3 pipelined", d, launches, executed,
                           rows)
    _, div_max = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"],
                                                 d._tab1)
    div_max = float(div_max)
    iters = [r["iters"] for r in rows]
    log(f"  the bench's window: {win['ms']:.2f} ms/step pipelined (trimmed "
        f"mean; mean {win['mean_ms']:.2f}, max {win['max_ms']:.2f}); the "
        f"host path (phase 9) {host_ms:.2f} ms/step; first step "
        f"{first_ms:.2f} ms; {sum(iters) / len(iters):.2f} iterations a "
        f"step ({executed} executed), dt {rows[-1]['dt']:.4e}, max|div u| "
        f"{div_max:.3e} (gate {AMR_DIV_GATE})")
    log(f"  launches: {launches} (per step "
        f"{ {k: v / len(rows) for k, v in launches.items()} }); "
        + _stream_line(d))
    if not (div_max < AMR_DIV_GATE and all(math.isfinite(k) for k in iters)):
        raise AssertionError(f"config #3 pipelined: max|div u| {div_max}")
    prof = None
    if full:
        t0 = time.perf_counter()
        prof = _profile_window(d, steps=PROFILE_STEPS, prefix="pipe_amr_",
                               trace=False)
        log(f"  (profiler window {time.perf_counter() - t0:.1f} s)")
    else:  # the same steps, unprofiled: the regrid probe starts alike
        for _ in range(PROFILE_STEPS):
            d.advance(d.calc_max_timestep())
    d.flush_packs()
    # -- the bench's regrid probe: adaptation on, 2 warm-up, 22 timed ------
    d.adapt_enabled = True
    d.prefetch = {"hits": 0, "misses": 0}
    regrids = _watch_regrids(d)
    nb0 = d.grid.nb
    m0 = metrics.snapshot()
    nbytes0 = len(d.adapt_bytes)
    probe = _bench_window(d, REGRID_WARM, REGRID_TIMED, regrid_log=regrids)
    d.flush_packs()
    delta = {k: v for k, v in metrics.delta(m0).items()
             if k.startswith(("bucket.", "amr.")) and v}
    probe.update(bucket=dict(
        capacity=d._cap, blocks=d.grid.nb, obs_delta=delta,
        regrid_wall_max_s=max(probe["regrid_ms"], default=0.0) / 1e3,
        adapt_bytes=d.adapt_bytes[nbytes0:],
        memo_entries=len(d._table_memo), memo_bytes=d.memo_bytes()),
        iters=[r["iters"] for r in d.step_log[-REGRID_TIMED:]])
    log(f"  regrid probe ({REGRID_WARM} + {REGRID_TIMED} steps, adaptation "
        f"on): steady {probe['ms']:.2f} ms/step (mean {probe['mean_ms']:.2f},"
        f" p95 {probe['p95_ms']:.2f}, max {probe['max_ms']:.2f}), regrid "
        f"steps {[round(x, 2) for x in probe['regrid_ms']]} ms; blocks {nb0}"
        f" -> {d.grid.nb} (capacity {d._cap}), regrids that changed the "
        f"forest {len(regrids)}; scores prefetch {d.prefetch}; decision "
        f"bytes read {probe['bucket']['adapt_bytes']}; metrics {delta}; "
        f"memo {len(d._table_memo)} topologies, "
        f"{probe['bucket']['memo_bytes'] / 1e6:.2f} MB; " + _stream_line(d))
    if d.prefetch["hits"] < 1:
        raise AssertionError(f"the scores prefetch was never used: "
                             f"{d.prefetch}")
    if not full:
        return dict(ms=win["ms"], first_ms=first_ms, init_s=init_s,
                    tables_s=sum(d.table_build_s), launches=launches,
                    steps=len(rows), executed=executed, div_max=div_max,
                    probe=probe, prefetch=dict(d.prefetch), nb=d.grid.nb,
                    iters=iters)
    # -- pipelined against the host path: the same fixed-dt steps ----------
    d.adapt_enabled = False
    snap = _snapshot(d)
    ke = {}
    for tag, pipe in (("pipelined", True), ("host", False)):
        d._resilience_restore(snap)
        d.cfg.pipelined = pipe
        for _ in range(PIPE_KE_STEPS):
            d.advance(PIPE_KE_DT)
        d.flush_packs()
        ke[tag] = _kinetic_energy(d)
    rel = abs(ke["pipelined"] - ke["host"]) / abs(ke["host"])
    log(f"  {PIPE_KE_STEPS} steps at dt {PIPE_KE_DT} from one state: KE "
        f"pipelined {ke['pipelined']:.8e}, host path {ke['host']:.8e} "
        f"(rel {rel:.2e}, gate {PIPE_KE_RTOL})")
    if not rel <= PIPE_KE_RTOL:
        raise AssertionError(f"config #3 pipelined KE {ke} (rel {rel})")
    # -- the host path's step in the bench's window, from the same state
    # (the chain's dt policy is the host path's) --------------------------
    d._resilience_restore(snap)
    d._dt_chain = False
    host = _bench_window(d, PIPE_WARM, PIPE_TIMED)
    log(f"  the host path from the window's end state, the same window: "
        f"{host['ms']:.2f} ms/step (mean {host['mean_ms']:.2f}, max "
        f"{host['max_ms']:.2f}); pipelined {win['ms']:.2f}")
    return dict(ms=win["ms"], host_ms=host["ms"], first_ms=first_ms,
                init_s=init_s, tables_s=sum(d.table_build_s),
                launches=launches, steps=len(rows), executed=executed,
                div_max=div_max, prof=prof, probe=probe,
                prefetch=dict(d.prefetch), nb=d.grid.nb, iters=iters)


def pipe_fish_amr_phase(host_ms: float) -> dict:
    """BASELINE config #4 as the bench runs it (see the module docstring,
    phase 24); CUP3D_FUSED=1 is set by the caller."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    out = _fresh_dir(os.path.join(OUT_DIR, "pipe_fish_amr"))
    t0 = time.perf_counter()
    d = build_driver(["-pipelined", "1"] + FISH_AMR_ARGV.split() + [
        "-path4serialization", out, "-factory-content", BENCH_TWO_FISH])
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  build_driver + init: {init_s:.2f} s; forest {d.grid.nb} blocks, "
        f"per level {_levels(d.grid)}")
    regrids = _watch_regrids(d)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    d.advance(d.calc_max_timestep())
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    win = _bench_window(d, FA_WARM, FA_TIMED)
    d.flush_packs()
    launches = dict(fa.launches)
    executed = fa.iterations["executed"]
    rows = d.step_log[-(1 + FA_WARM + FA_TIMED):]
    _check_forest_launches("config #4 pipelined", d, launches, executed,
                           rows)
    div = float(diag.fluid_divergence_max_blocks(
        d._geom, d.state["vel"], d.state["chi"], d._tab1))
    iters = [r["iters"] for r in rows]
    log(f"  the bench's window ({FA_TIMED} steps after {1 + FA_WARM}): "
        f"{win['ms']:.2f} ms/step pipelined (trimmed mean; mean "
        f"{win['mean_ms']:.2f}, max {win['max_ms']:.2f}); the host path "
        f"(phase 22) {host_ms:.2f} ms/step; first step {first_ms:.2f} ms; "
        f"{sum(iters) / len(iters):.2f} iterations a step ({executed} "
        f"executed); fluid max|div u| {div:.3e} (gate {FA_DIV_GATE}); "
        f"collision fallbacks {d.collision_fallbacks}; regrids that changed "
        f"the forest {len(regrids)}; scores prefetch {d.prefetch}")
    log(f"  launches: {launches} (per step "
        f"{ {k: v / len(rows) for k, v in launches.items()} }); "
        + _stream_line(d))
    for i, ob in enumerate(d.obstacles):
        log(f"  fish {i}: transVel {ob.transVel.tolist()}, position "
            f"{ob.position.tolist()}")
    if not (div < FA_DIV_GATE and _fish_ok(d)):
        raise AssertionError(f"config #4 pipelined: fluid div {div}, fish "
                             f"finite and moving {_fish_ok(d)}")
    bucket = _bucket_check("config #4 pipelined", d)
    # -- the five forest kernels on one pipelined step's state -------------
    s = d.state
    rhs = amr_ops.pressure_rhs_blocks(
        d._geom, s["vel"], torch.tensor(d.dt, device=d.device), d._tab1,
        d._ftab, s["chi"], s["udef"])
    log(f"  one forest solve on this state's pressure RHS ({d.grid.nb} "
        f"blocks): B8, B9, B11-B13 against their plain versions")
    forest_solve_phase(d, rhs)
    _forest_reruns_bitwise(d)
    return dict(ms=win["ms"], first_ms=first_ms, init_s=init_s,
                launches=launches, steps=len(rows), executed=executed,
                div=div, fallbacks=d.collision_fallbacks, nb=d.grid.nb,
                bucket=bucket)


def _forest_channel(extra: str, out: str):
    from cup3d_tpu_torch.__main__ import build_driver

    _fresh_dir(out)
    d = build_driver(f"{extra} {FOREST_CHANNEL_ARGV} -nsteps "
                     f"{FOREST_CHANNEL_STEPS} -path4serialization {out}"
                     .split())
    d.init()
    return d


def forest_physics_phase() -> dict:
    """The forest's physics that the megastep carries (see the module
    docstring, phase 25); CUP3D_FUSED=1 is set by the caller."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import amr_ops, getz_cg, krylov
    from cup3d_tpu_torch.parallel import ring

    res = {}
    # -- (a) the walled forest channel: FixMassFlux, pipelined and not -----
    rows = {}
    for tag, extra in (("host", "-pipelined 0"), ("pipelined",
                                                   "-pipelined 1")):
        out = os.path.join(OUT_DIR, f"forest_channel_{tag}")
        d = _forest_channel(extra, out)
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FOREST_CHANNEL_STEPS * 1e3
        rows[tag] = _read_table(os.path.join(out, "flux.txt"))
        u, target = rows[tag][-1][2], rows[tag][-1][3]
        log(f"  forest channel ({d.grid.nb} blocks, walls in y) {tag}: "
            f"{ms:.2f} ms/step, bulk {u:.6f} against {target:.6f}; flux.txt "
            f"rows {rows[tag]}")
        if not (len(rows[tag]) == FOREST_CHANNEL_STEPS
                and abs(u - target) < CH_FLUX_RTOL * target):
            raise AssertionError(f"forest channel {tag}: bulk {u}, target "
                                 f"{target}, {len(rows[tag])} rows")
        res[f"channel_{tag}_ms"] = ms
    if rows["host"] != rows["pipelined"]:
        raise AssertionError("the pipelined flux.txt rows differ from the "
                             "host path's")
    log("  the pipelined step's flux.txt rows equal the host path's")
    del d
    # -- (b) implicit diffusion under CUP3D_GETZ=cg: B7 with a shift column
    with _env(CUP3D_GETZ="cg"):
        out = _fresh_dir(os.path.join(OUT_DIR, "implicit_amr"))
        argv = (f"-pipelined 1 -implicitDiffusion 1 -dt {IMPLICIT_AMR_DT} "
                f"{AMR_ARGV} -verbose 0 -path4serialization {out}").split()
        for ax in ("-bpdx", "-bpdy", "-bpdz"):
            argv[argv.index(ax) + 1] = "4"
        d = build_driver(argv)
        d.init()
        d.adapt_enabled = False
        gen = torch.Generator(device=d.device)
        gen.manual_seed(SEED + 9)
        vel = d.state["vel"]
        noise = torch.randn(vel.shape, generator=gen, device=d.device)
        noise[d.grid.nb:] = 0.0  # the bucketed forest's padding rows
        d.state["vel"] = vel + IMPLICIT_PERTURB * noise
        # B7 on the Helmholtz's own input: the preconditioner's first
        # application, shift h^2/(nu dt) a block
        from cup3d_tpu_torch.ops import diffusion as dif

        nudt = d.nu * IMPLICIT_AMR_DT
        ustar = dif.advect_euler_blocks(d._geom, d.state["vel"],
                                        IMPLICIT_AMR_DT, d.uinf_device(),
                                        d._tab3)
        h2 = (d._geom.h_column(torch.float32, d.device)) ** 2
        shift = h2 / nudt
        b = ustar[..., 0]
        r0 = b - dif.helmholtz_comp_blocks(d._geom, b, d._tab1, nudt, 0,
                                           d._ftab)
        x = (shift * r0).contiguous()
        err = check_close("getz_cg (Helmholtz)",
                          getz_cg.cg_tiles_blocks(x, CG_ITERS, shift),
                          getz_cg.cg_tiles_blocks(x, CG_ITERS, shift,
                                                  kernels=False), GETZ_RTOL)
        getz_cg.launches["getz_cg"] = 0
        krylov.iterations["executed"] = 0
        t0 = time.perf_counter()
        helm_iters = []
        for _ in range(IMPLICIT_AMR_STEPS):
            d.advance(d.calc_max_timestep())
            helm_iters.append([int(s_[1]) for s_ in d._helm.last_stats])
        d.flush_packs()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / IMPLICIT_AMR_STEPS * 1e3
        b7 = getz_cg.launches["getz_cg"]
        executed = krylov.iterations["executed"]
        _, div = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"],
                                                 d._tab1)
        log(f"  implicit diffusion on config #3's forest at bpd 4 "
            f"({d.grid.nb} blocks, CUP3D_GETZ=cg, perturbed by "
            f"{IMPLICIT_PERTURB}): B7 with the per-block shift column "
            f"against its plain version err {err:.3e}; {ms:.2f} ms/step; "
            f"Helmholtz iterations a component {helm_iters}; B7 launches "
            f"{b7} (2 x {executed} executed Krylov iterations, Helmholtz "
            f"and Poisson); max|div u| {float(div):.3e}")
        if not (b7 == 2 * executed and min(min(h) for h in helm_iters) > 0
                and bool(torch.isfinite(d.state["vel"]).all())):
            raise AssertionError(f"implicit forest: B7 {b7}, executed "
                                 f"{executed}, Helmholtz {helm_iters}")
        res.update(helmholtz_iters=helm_iters, b7_launches=b7,
                   b7_per_step=b7 / IMPLICIT_AMR_STEPS, implicit_ms=ms)
        del d
    # -- (c) the vorticity IC on a 2-level forest --------------------------
    out = _fresh_dir(os.path.join(OUT_DIR, "vort_amr"))
    t0 = time.perf_counter()
    d = build_driver(f"{VORT_AMR_ARGV} -path4serialization {out}".split())
    d.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, div = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"],
                                             d._tab1)
    umax = float(d.state["vel"].abs().max())
    log(f"  vorticity IC: init {init_s:.2f} s, {d.grid.nb} blocks per level "
        f"{_levels(d.grid)}, max|u| {umax:.4f}, max|div u| "
        f"{float(div):.3e}")
    if not (len([c for c in _levels(d.grid) if c]) == 2
            and math.isfinite(float(div))):
        raise AssertionError(f"vorticity IC forest {_levels(d.grid)}")
    res.update(vort_init_s=init_s, vort_div=float(div))
    del d
    # -- (d) the obstacle-free pipelined step on 4 shards of the card ------
    from cup3d_tpu_torch.config import parse_args
    from cup3d_tpu_torch.parallel.forest import make_block_mesh
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    vels = {}
    with _env(CUP3D_RING_HALO="1"):
        for tag, pipe, shards in (("sharded pipelined", 1, SHARDS),
                                  ("sharded host", 0, SHARDS),
                                  ("unsharded pipelined", 1, 0)):
            out = _fresh_dir(os.path.join(OUT_DIR, "pipe_shard"))
            argv = (f"-pipelined {pipe} -dt {PIPE_KE_DT} {AMR_ARGV} "
                    f"-verbose 0 -path4serialization {out}").split()
            for ax in ("-bpdx", "-bpdy", "-bpdz"):
                argv[argv.index(ax) + 1] = "8"
            argv[argv.index("-nsteps") + 1] = str(PIPE_SHARD_STEPS)
            mesh = (make_block_mesh([torch.device("cuda")] * shards)
                    if shards else None)
            d = AMRSimulation(parse_args(argv), mesh=mesh)
            d.init()
            d.adapt_enabled = False
            torch.cuda.synchronize()
            ring.reset_launches()
            t0 = time.perf_counter()
            d.simulate()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PIPE_SHARD_STEPS * 1e3
            vels[tag] = d._unpad(d.state["vel"]).clone()
            b14 = ring.launches["ring_shift"]
            log(f"  {tag} ({d.grid.nb} blocks): {ms:.2f} ms/step, B14 "
                f"launches {b14} ({b14 / PIPE_SHARD_STEPS:.1f} a step)")
            if tag == "sharded pipelined":
                res.update(shard_ms=ms, b14_launches=b14,
                           b14_per_step=b14 / PIPE_SHARD_STEPS)
                if not (b14 > 0 and not d.state["vel"][d.grid.nb:].any()):
                    raise AssertionError("sharded pipelined: no B14 launch "
                                         "or nonzero padding rows")
            del d
    same = bool(torch.equal(vels["sharded pipelined"], vels["sharded host"]))
    diff = float(torch.max(torch.abs(vels["sharded pipelined"]
                                     - vels["unsharded pipelined"])))
    log(f"  sharded pipelined against the sharded host path (the same "
        f"arithmetic): bitwise {same}; against the unsharded pipelined "
        f"forest (tile-only against two-level solve): max diff {diff:.3e} "
        f"(gate {SHARD_VEL_ATOL})")
    if not (same and diff <= SHARD_VEL_ATOL):
        raise AssertionError(f"sharded pipelined: bitwise {same}, diff "
                             f"{diff}")
    return res


# ---------------------------------------------------------------------------
# phases 26-28: bf16 Krylov storage (CUP3D_KRYLOV_DTYPE=bf16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# The stage rule of a bf16 kernel against its bf16 plain version on the
# same inputs (tests/test_torch_bf16.py holds the plain versions to the
# JAX package's by the same rule): its stored bf16 outputs bitwise equal
# on at least BF16_BITWISE of the cells, and each cell within one bf16
# ulp of the plain value, or, where the value is so near 0 that an ulp
# is finer than f32 arithmetic in another order resolves, within the f32
# twin's own bound (VEC_RTOL or GETZ_RTOL of max |plain|).  Its f32
# partials within BF16_PART_RTOL of each tile's sum of |terms| of the
# sum over its OWN stored vector (a one-ulp difference in a stored cell
# moves the partial by that cell's ulp, which is the vector's rule);
# x within VEC_RTOL as the f32 rows.  A getZ kernel (B2, B3, B9, B10)
# is also held to its f32 twin on the up-cast inputs: its store is the
# twin's output rounded, and the plain version's store is the f32 plain
# version's rounded, on every cell, so the cells where the two bf16
# outputs differ are exactly those where the f32 twin and its plain
# version (held by GETZ_RTOL in phases 7 and 10) round apart.  B9 is held
# by that rule and not by the share: on its random zc the f32 twin and
# its plain version round apart in ~0.1% of the cells (the tile solve
# cancels the jump of A zf at every block face there).
BF16_BITWISE = 0.999
BF16_PART_RTOL = 2e-5
# one whole 64^3 bf16 solve, kernels against plain versions
BF16_SOLVE_ITS = 1
BF16_SOLVE_X = 1e-2
# phase 27: config #2 as the bench's fish256 (bench.py:637-640, 2166-2199:
# bench_fish_uniform(256), pipelined), bf16 and f32 from one state
N_FISH256 = 256
FISH256_STEPS = 8
#: steps in each fish256 run's profiler window (its busy share)
FISH256_PROFILE_STEPS = 1
FISH256_DIV_GATE = 0.07     # bench.py:57-58, ("fish", 256)
FISH256_EXTRA_ITS = 10      # bf16 iterations a solve <= f32's + 10
# the knobs of a phase's solver: f32 on the fused kernels, or bf16 storage
# at CUP3D_FUSED's default (auto: fused iff bf16)
F32_KNOBS = dict(CUP3D_FUSED="1")
BF16_KNOBS = dict(CUP3D_FUSED=None, CUP3D_KRYLOV_DTYPE="bf16")
BF16_NAMES = ("update", "getz_two", "getz_tile", "lap", "axpy", "finish",
              "amr_update", "amr_getz_two", "amr_getz_tile", "amr_lap",
              "amr_axpy", "amr_finish")


def _counts(mod, bf16: bool) -> dict:
    """The launch counters of ``mod``'s kernels of one storage; the other
    storage's must be all 0."""
    other = mod.launches if bf16 else mod.launches_bf16
    if any(other.values()):
        raise AssertionError(f"kernels of the other storage launched: "
                             f"{other}")
    return dict(mod.launches_bf16 if bf16 else mod.launches)


def _bf16_bits(t):
    """A bf16 tensor's bits as ordered integers (sign-magnitude -> a line
    on which neighbouring values are 1 apart)."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _bf16_check(stats, name, got, want, f32_rtol,
                share_min=BF16_BITWISE, twin=None) -> float:
    """The stage rule for a stored bf16 output (see BF16_BITWISE); adds
    the bitwise share and the largest distance in ulps to ``stats``;
    returns max |got - want|.  ``twin``: the f32 twin's output and its
    f32 plain version's on the up-cast inputs, which ``got`` and ``want``
    must equal rounded, on every cell (the getZ rule); ``share_min`` 0
    then holds the ulps and that rule only."""
    og, ow = _bf16_bits(got), _bf16_bits(want)
    share = float((og == ow).double().mean())
    if twin is not None:
        k32, p32 = twin
        rounded = (torch.equal(got.view(torch.int16),
                               k32.to(BF16).view(torch.int16)),
                   torch.equal(want.view(torch.int16),
                               p32.to(BF16).view(torch.int16)))
        same32 = float((k32.view(torch.int32)
                        == p32.view(torch.int32)).double().mean())
        stats["twin_bitwise"] = min(stats.get("twin_bitwise", 1.0), same32)
        log(f"    {name}: {share:.5%} bitwise its plain version; the store "
            f"is its f32 twin's rounded {rounded[0]}, the plain version's "
            f"its f32 plain's rounded {rounded[1]}; the f32 twin "
            f"{same32:.5%} bitwise its plain version")
        if not all(rounded):
            raise AssertionError(f"{name}: not its f32 twin rounded "
                                 f"(kernel, plain): {rounded}")
    wf = want.float()
    err = torch.abs(got.float() - wf)
    floor = f32_rtol * float(torch.max(torch.abs(wf)))
    # distance in ulps where the f32 bound does not cover the difference
    ulps = int(torch.max(torch.where(err > floor, torch.abs(og - ow), 0)))
    stats["bitwise"] = min(stats.get("bitwise", 1.0), share)
    stats["max_ulps"] = max(stats.get("max_ulps", 0), ulps)
    if share < share_min or ulps > 1:
        raise AssertionError(f"{name}: {share:.5%} bitwise (need "
                             f"{share_min:.1%}), {ulps} ulps off beyond "
                             f"{floor:.3e}")
    return float(torch.max(err))


def _bf16_part(name, got, own, *terms) -> float:
    """A kernel's f32 per-tile partial against the same sum over its own
    stored output, within BF16_PART_RTOL of each tile's sum of |terms|;
    returns the largest error over its tolerance."""
    scale = sum(torch.sum(torch.abs(t.float()), dim=(1, 2, 3))
                for t in terms)
    tol = BF16_PART_RTOL * torch.clamp(scale, min=1e-30)
    ratio = float(torch.max(torch.abs(got - own) / tol))
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: partial off its own stored sum by "
                             f"{ratio:.2f}x the bound")
    return ratio


def bf16_kernel_phase(d, bw: float, fp32_flops: float) -> dict:
    """The twelve bf16 kernels against their bf16 plain versions (the stage
    rule above): B1-B6 at 256^3 (T = 32,768), B8-B13 at the config #3
    forest of ``d``; timed beside their plain version and their f32 twin
    on the same values (the bf16 inputs up-cast), their bound from the
    bytes they move by the port's bytes_model at bf16 (and the per-tile
    columns) or their f32 operations where those take longer."""
    from cup3d_tpu_torch.ops import amr_ops, tilesolve
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    dev = torch.device(d.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    results = {}

    def row(*vals):
        return fb._scalars(*(torch.tensor(v, device=dev) for v in vals))

    def rec(name, stats, errs, perrs, kernel_fn, plain_fn, f32_fn, nbytes,
            flops):
        key = name + "_bf16"
        _record(results, key, errs, kernel_fn, plain_fn, nbytes, flops, bw,
                fp32_flops, perrs=perrs)
        f32_ms = time_ms(f32_fn)
        results[key].update(twin=name, f32_ms=f32_ms, **stats)
        if name in FOREST_KERNEL_NAMES:
            # the forest rows' events read the launch rate: their device
            # time by profile
            results[key]["profile_us"] = profile_us(
                kernel_fn, FOREST_KERNEL_NAMES[name])
            log(f"    device time by profile {results[key]['profile_us']} "
                f"us a launch")
        log(f"    bitwise {stats['bitwise']:.5%}, at most "
            f"{stats['max_ulps']} ulp off beyond the f32 bound; its f32 "
            f"twin {f32_ms:.4f} ms in this call "
            f"(bf16/f32 {results[key]['ms'] / f32_ms:.3f})")

    def f32(*ts):
        return [t.float() for t in ts]

    for n, pre, mod, vol in (((N_MAIN // 8) ** 3, "", fb, None),
                             (d._geom.nb, "amr_", fa, True)):
        # the forest's real blocks (its capacity's padding rows stay 0)
        nb = d.grid.nb if vol else n
        cells = n * 512
        model = mod.bytes_model(BF16)

        def moved(stage, calls=1, less=0.0):
            """Bytes of one launch of ``stage`` over the cells: the port's
            bytes_model entry (an iteration's bytes a cell) over its
            launches an iteration, less what the kernel does not move."""
            return (model[stage] / calls - less) * cells

        def vec():
            v = torch.randn((n, 8, 8, 8), generator=gen, device=dev)
            v[nb:] = 0.0
            return v.to(BF16)

        if vol:
            h = d._geom.h_column(torch.float32, dev).reshape(n)
            vol = d._vol.reshape(n).float().contiguous()
            h2 = (h * h).contiguous()
            w_ = (vol,)
            wt = vol[:, None, None, None]
        else:
            h2 = (2 * math.pi / N_MAIN) ** 2
            w_, wt = (), 1.0

        # -- B1 / B8 update (in place on p, rhat: compare on clones) -------
        r, p, v, rh = (vec() for _ in range(4))
        stats, errs, perrs = {}, [], []
        for vals in ((0.7, 1.3, 0.0), (0.0, 1.3, 1.0)):
            sc = row(*vals)
            want = mod.update(r, p.clone(), v, rh.clone(), *w_, sc,
                              kernels=False)
            got = mod.update(r, p.clone(), v, rh.clone(), *w_, sc)
            _zero_rows(pre + "update_bf16", nb, *got[:2])
            for g_, w in zip(got[:2], want[:2]):
                errs.append(_bf16_check(stats, pre + "update_bf16", g_, w,
                                        VEC_RTOL))
            perrs.append(_bf16_part(pre + "update_bf16 partial", got[2],
                                    fb._cellsum(got[0].float() * wt),
                                    got[0].float() * wt))
        bad = torch.full_like(p, float("inf"))
        got = mod.update(r, bad.clone(), bad, rh.clone(), *w_,
                         row(0.0, 1.3, 1.0))
        if not (torch.equal(got[0], r) and torch.equal(got[1], r)):
            raise AssertionError(f"{pre}update_bf16: breakdown leaked p "
                                 "or v")
        sc = row(0.7, 1.3, 0.0)
        pk, rk = p.clone(), rh.clone()
        r32, p32, v32, rh32 = f32(r, p, v, rh)
        rec(pre + "update", stats, errs, perrs,
            lambda: mod.update(r, pk, v, rk, *w_, sc),
            lambda: mod.update(r, p, v, rh, *w_, sc, kernels=False),
            lambda: mod.update(r32, p32, v32, rh32, *w_, sc),
            # the model reads and writes rhat every iteration; the kernel
            # writes it only on a breakdown, and reads it never
            moved("update", less=2 * 2) + 4 * len(w_) * n,
            (4 + len(w_)) * cells)

        # -- B2 / B9 getz, two-level --------------------------------------
        w = vec()
        stats = {}
        if vol is None:
            aux = torch.randn((8, n), generator=gen, device=dev)
            aux[7] = 0.0
            args, nbytes = (aux, h2), moved("getz", 2) + 28 * n
            lib = None
        else:
            zc = torch.randn(n, generator=gen, device=dev)
            zc[nb:] = 0.0
            zf = zc[:, None, None, None].expand(n, 8, 8, 8)
            azf = amr_ops.laplacian_blocks(d._geom, zf, d._tab1,
                                           d._ftab).contiguous()
            args, nbytes = (azf, zc, h2), moved("getz", 2) + 8 * n
            W = tilesolve.dense_operator(8, torch.float32, str(dev))
            rows_ = (w.float() - azf).view(n, 512)
            neg_h2 = -h2
            lib = lambda: torch.einsum("tc,cd,t->td", rows_, W, neg_h2)
        want = mod.getz_two(w, *args, kernels=False)
        got = mod.getz_two(w, *args)
        _zero_rows(pre + "getz_two_bf16", nb, got)
        w32 = w.float()
        twin = (mod.getz_two(w32, *args),
                mod.getz_two(w32, *args, kernels=False))
        errs = [_bf16_check(stats, pre + "getz_two_bf16", got, want,
                            GETZ_RTOL, twin=twin,
                            share_min=0.0 if vol is not None
                            else BF16_BITWISE)]
        if not torch.equal(mod.getz_two(w, *args), got):
            raise AssertionError(f"{pre}getz_two_bf16: a rerun differs")
        rec(pre + "getz_two", stats, errs, [0.0],
            lambda: mod.getz_two(w, *args),
            lambda: mod.getz_two(w, *args, kernels=False),
            lambda: mod.getz_two(w32, *args), nbytes, 110 * cells)
        if lib is not None:
            results[pre + "getz_two_bf16"]["library_ms"] = time_ms(lib)

        # -- B3 / B10 getz, tile-only --------------------------------------
        w = vec()
        stats = {}
        want = mod.getz_tile(w, h2, kernels=False)
        got = mod.getz_tile(w, h2)
        _zero_rows(pre + "getz_tile_bf16", nb, got)
        w32 = w.float()
        twin = (mod.getz_tile(w32, h2), mod.getz_tile(w32, h2, kernels=False))
        errs = [_bf16_check(stats, pre + "getz_tile_bf16", got, want,
                            GETZ_RTOL, twin=twin)]
        W = tilesolve.dense_operator(8, torch.float32, str(dev))
        rows_ = w32.view(n, 512)
        if vol is None:
            M = -h2 * W
            lib = lambda: torch.matmul(rows_, M)
        else:
            neg_h2 = -h2
            lib = lambda: torch.einsum("tc,cd,t->td", rows_, W, neg_h2)
        rec(pre + "getz_tile", stats, errs, [0.0],
            lambda: mod.getz_tile(w, h2),
            lambda: mod.getz_tile(w, h2, kernels=False),
            lambda: mod.getz_tile(w32, h2),
            # the forest's model counts B9's f32 azf, which B10 does not read
            moved("getz", 2, less=4 if vol is not None else 0)
            + (4 * n if vol is not None else 0), 98 * cells)
        results[pre + "getz_tile_bf16"]["library_ms"] = time_ms(lib)

        # -- B4 / B11 lap --------------------------------------------------
        w, a = vec(), vec()
        stats = {}
        if vol is None:
            # B4 on the periodic 256^3 grid, its faces read from w
            from cup3d_tpu_torch.grid.uniform import UniformGrid

            geom = fb.LapGeom(UniformGrid((N_MAIN,) * 3, (2 * math.pi,) * 3))
            inv = 1.0 / h2

            def lap_of(w_, a_, **kw):
                return fb.lap(w_, a_, inv, geom, **kw)

            w32 = w.float()
            nbytes, flops = moved("lap", 2), 11 * cells
        else:
            lab = d._tab1.assemble_scalar(w.float(), 8).contiguous()
            inv_h = (1.0 / h)[:, None, None, None]
            corr = d._ftab.apply(torch.zeros((n, 8, 8, 8), device=dev),
                                 amr_ops.face_fluxes(lab, 1, 8, inv_h))
            corr = corr.contiguous()
            inv = (1.0 / h2).contiguous()

            def lap_of(w_, a_, **kw):  # the lab stands for w
                return fa.lap(lab, corr, a_, inv, **kw)

            w32 = None
            nbytes = moved("lap", 2)
            flops = 10 * cells
        want = lap_of(w, a, kernels=False)
        got = lap_of(w, a)
        _zero_rows(pre + "lap_bf16", nb, got[0])
        if vol is None:  # the same f32 arithmetic, one rounding: bitwise
            check_bitwise("lap_bf16", got[0], want[0])
        errs = [_bf16_check(stats, pre + "lap_bf16", got[0], want[0],
                            VEC_RTOL)]
        awk = got[0].float()
        perrs = [_bf16_part(pre + "lap_bf16 partial a.Aw", got[1],
                            fb._cellsum(a.float() * awk), a.float() * awk),
                 _bf16_part(pre + "lap_bf16 partial Aw.Aw", got[2],
                            fb._cellsum(awk * awk), awk * awk)]
        a32 = a.float()
        rec(pre + "lap", stats, errs, perrs,
            lambda: lap_of(w, a),
            lambda: lap_of(w, a, kernels=False),
            lambda: lap_of(w32, a32), nbytes, flops)
        if vol is None:
            results["lap_bf16"]["profile_us"] = profile_us(
                lambda: lap_of(w, a), "k_lap")
            log(f"    device time by profile "
                f"{results['lap_bf16']['profile_us']} us a launch")

        # -- B5 / B12 axpy -------------------------------------------------
        r, v = vec(), vec()
        stats = {}
        sc = row(0.37)
        want = mod.axpy(r, v, *w_, sc, kernels=False)
        got = mod.axpy(r, v, *w_, sc)
        _zero_rows(pre + "axpy_bf16", nb, got[0])
        errs = [_bf16_check(stats, pre + "axpy_bf16", got[0], want[0],
                            VEC_RTOL)]
        perrs = [_bf16_part(pre + "axpy_bf16 partial", got[1],
                            fb._cellsum(got[0].float() * wt),
                            got[0].float() * wt)]
        r32, v32 = f32(r, v)
        rec(pre + "axpy", stats, errs, perrs,
            lambda: mod.axpy(r, v, *w_, sc),
            lambda: mod.axpy(r, v, *w_, sc, kernels=False),
            lambda: mod.axpy(r32, v32, *w_, sc),
            moved("axpy") + 4 * len(w_) * n, (3 + len(w_)) * cells)

        # -- B6 / B13 finish (x f32 in place, r into s) ---------------------
        x = torch.randn((n, 8, 8, 8), generator=gen, device=dev)
        x[nb:] = 0.0
        y, z, s_, t, rh = (vec() for _ in range(5))
        stats = {}
        sc = row(0.37, 1.21)
        want = mod.finish(x.clone(), y, z, s_.clone(), t, rh, sc,
                          kernels=False)
        got = mod.finish(x.clone(), y, z, s_.clone(), t, rh, sc)
        _zero_rows(pre + "finish_bf16", nb, *got[:2])
        errs = [check_close(pre + "finish_bf16 x", got[0], want[0],
                            VEC_RTOL),
                _bf16_check(stats, pre + "finish_bf16 r", got[1], want[1],
                            VEC_RTOL)]
        rk = got[1].float()
        perrs = [_bf16_part(pre + "finish_bf16 partial r.r", got[2],
                            fb._cellsum(rk * rk), rk * rk),
                 _bf16_part(pre + "finish_bf16 partial rhat.r", got[3],
                            fb._cellsum(rh.float() * rk), rh.float() * rk)]
        xk, sk = x.clone(), s_.clone()
        y32, z32, s32, t32, rh32 = f32(y, z, s_, t, rh)
        xk32, sk32 = x.clone(), s32.clone()
        rec(pre + "finish", stats, errs, perrs,
            lambda: mod.finish(xk, y, z, sk, t, rh, sc),
            lambda: mod.finish(x, y, z, s_, t, rh, sc, kernels=False),
            lambda: mod.finish(xk32, y32, z32, sk32, t32, rh32, sc),
            moved("finish"), 10 * cells)
    torch.cuda.synchronize()
    return results


def bf16_solve_phase(dev="cuda") -> dict:
    """One whole 64^3 bf16 solve (phase 4's system), kernels against plain
    versions, beside the f32 solve's iterations and the residual."""
    from cup3d_tpu_torch.grid.uniform import UniformGrid
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import krylov

    n = N_SOLVE
    grid = UniformGrid((n, n, n), (1.0, 1.0, 1.0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rhs = torch.randn((n, n, n), generator=gen, device=dev)
    bt = krylov.to_lanes(rhs - torch.mean(rhs))
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=200)
    fb.reset_launches()
    x_k, rn_k, k_k = fb.fused_bicgstab(grid, bt, store_dtype=BF16, **kw)
    k_k = int(k_k)
    launches = dict(fb.launches_bf16)
    executed = fb.iterations["executed"]
    x_p, rn_p, k_p = fb.fused_bicgstab(grid, bt, store_dtype=BF16,
                                       kernels=False, **kw)
    k_p = int(k_p)
    _, rn_f, k_f = fb.fused_bicgstab(grid, bt, store_dtype=torch.float32,
                                     **kw)
    rel = float(torch.max(torch.abs(x_k - x_p)) / torch.max(torch.abs(x_p)))
    A = krylov.make_laplacian_lanes(grid)
    res = float(torch.sqrt(torch.sum((bt - A(x_k)) ** 2)))
    target = max(1e-6, 1e-4 * float(torch.sqrt(torch.sum(bt * bt))))
    # the stopping test reads the stored r's norm, as the JAX package's
    # bf16 solve does; ||b - A x|| is printed beside it
    log(f"  {n}^3 bf16 fused solve: kernels {k_k} its (resid "
        f"{float(rn_k):.3e}, ||b - A x|| {res:.3e}, target {target:.3e}), "
        f"plain {k_p} its (resid {float(rn_p):.3e}), x rel diff "
        f"{rel:.3e}; f32 {int(k_f)} its; bf16 launches {launches}")
    if (abs(k_k - k_p) > BF16_SOLVE_ITS or not rel <= BF16_SOLVE_X
            or not float(rn_k) <= 1.01 * target or k_k > int(k_f) + 10
            or launches["update"] != executed):
        raise AssertionError(f"bf16 solve: its {k_k} vs {k_p} (f32 "
                             f"{int(k_f)}), x rel {rel:.3e}, residual "
                             f"{float(rn_k):.3e} vs {target:.3e}, launches "
                             f"{launches} for {executed} executed")
    return dict(its=k_k, its_plain=k_p, its_f32=int(k_f), rel=rel,
                true_res=res / target)


BF16_TILE_STEPS = 3     # config #2 and config #4 under CUP3D_COARSE=0, bf16
# config #2's first nonzero pressure system at 128^3 (sparse: flat index,
# value), as this phase catches it on the card; tests/test_torch_bf16_tile.py
# solves it in both packages on the CPU
TILE_SYSTEM = os.path.join("tests", "data", "config2_128_first_rhs.npz")
TILE_SYSTEM_RTOL = 1e-5  # the card's system against the committed one
BF16_TILE_SEEDS = 8      # its tile-only bf16 solves: rhs + 1e-5 noise draws
TILE_NOISE = 1e-5


def _catch_solves(d):
    """Wrap the uniform driver's pressure solver: returns the list that
    receives (rhs, x0) of every solve from now on."""
    from cup3d_tpu_torch.sim.operators import PressureProjection

    s, caught = d.sim, []
    solver = s.poisson_solver

    def spy(rhs, x0=None, with_stats=False):
        caught.append((rhs.clone(), None if x0 is None else x0.clone()))
        return solver(rhs, x0, with_stats=with_stats)

    spy.supports_stats, spy.maxiter = True, solver.maxiter
    s.poisson_solver = spy
    for i, op in enumerate(d.pipeline):
        if isinstance(op, PressureProjection):
            d.pipeline[i] = PressureProjection(s)
    return caught


def _tile_system(caught, out: str):
    """The first nonzero system of ``caught`` (its x0 is the zero
    pressure), written sparse to ``out`` and held to TILE_SYSTEM."""
    rhs = next(r for r, _ in caught if bool(torch.any(r != 0)))
    flat = rhs.reshape(-1)
    idx = torch.nonzero(flat).reshape(-1)
    np.savez_compressed(out, shape=np.array(rhs.shape), idx=idx.cpu().numpy()
                        .astype(np.int32), val=flat[idx].cpu().numpy())
    ref = np.load(TILE_SYSTEM)
    want = torch.zeros(int(np.prod(ref["shape"])), device=rhs.device)
    want[torch.as_tensor(ref["idx"], device=rhs.device).long()] = \
        torch.as_tensor(ref["val"], device=rhs.device)
    diff = float(torch.max(torch.abs(flat - want)) / torch.max(torch.abs(want)))
    return rhs, idx.numel(), diff


def bf16_tile_phase() -> dict:
    """The tile-only getZ kernels at bf16 on the entry points, under
    CUP3D_COARSE=0: config #2 at 128^3 (B3) and config #4 on the host path
    (B10) for BF16_TILE_STEPS steps each, the launches against the
    executed iterations, the fluid's max|div u| under the bench's gates,
    the fields finite.  Config #2's first nonzero system (held to
    TILE_SYSTEM, which tests/test_torch_bf16_tile.py solves on the CPU) is
    then solved tile-only at bf16, kernels and plain versions, on
    BF16_TILE_SEEDS noisy copies: a tile-only bf16 solve of it breaks
    down (NaN) or stalls at maxiter in a share of the copies, in the JAX
    package too (that test), so the breakdowns are counted and printed;
    the f32 tile-only solve must converge on every copy; the best x of
    each bf16 kernel solve, broken down or not (the x the driver keeps;
    its mean removed, as the solver returns it), within BF16_SOLVE_X of
    the f32 x, as the JAX package's is after its breakdown (that test;
    the plain versions' and ||b - A x|| are printed); the two-level bf16
    solve's kernels and plain versions agree within one iteration."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import diagnostics as diag
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import krylov

    out = _fresh_dir(os.path.join(OUT_DIR, "tile_bf16"))
    with _env(**BF16_KNOBS, CUP3D_COARSE="0"):
        d = build_driver(fish_argv(out))
        d.init()
        caught = _catch_solves(d)
        fb.reset_launches()
        for _ in range(BF16_TILE_STEPS):
            d.advance(d.calc_max_timestep())
        torch.cuda.synchronize()
        launches = _counts(fb, True)
        executed = fb.iterations["executed"]
    rows = d.step_log[-BF16_TILE_STEPS:]
    want = {"update": executed, "getz_two": 0, "getz_tile": 2 * executed,
            "lap": 2 * executed, "axpy": executed, "finish": executed}
    div = _check_fish(d, "config #2 tile-only at bf16")
    log(f"  config #2 at {N_FISH}^3, bf16, CUP3D_COARSE=0: iterations "
        f"{[int(r['iters']) for r in rows]}, residuals "
        f"{[float(r['resid']) for r in rows]}; fluid max|div u| {div:.3e}; "
        f"bf16 launches {launches}")
    if executed != _executed(rows) or launches != want or executed == 0:
        raise AssertionError(f"config #2 tile-only bf16: launches "
                             f"{launches}, executed {executed}, expected "
                             f"{want}")
    uniform = dict(launches=launches, iters=[int(r["iters"]) for r in rows])
    rhs, nnz, diff = _tile_system(caught, os.path.join(out, "first_rhs.npz"))
    log(f"  its first nonzero system: {nnz} nonzero cells, against "
        f"{TILE_SYSTEM} {diff:.3e} of max |rhs| (gate {TILE_SYSTEM_RTOL})")
    if not diff <= TILE_SYSTEM_RTOL:
        raise AssertionError(f"config #2's first system is not "
                             f"{TILE_SYSTEM}: {diff}")
    gen = torch.Generator(device=rhs.device)
    scale = TILE_NOISE * float(torch.max(torch.abs(rhs)))
    kw = dict(tol_abs=1e-6, tol_rel=1e-4, maxiter=1000)
    A = krylov.make_laplacian_tiles(d.sim.grid, 8)
    res = {"kernels": [], "plain": [], "f32": []}
    # the best x's distance from the f32 x and ||b - A x|| / |b|, by tag
    gaps = {"kernels": [0.0, 0.0], "plain": [0.0, 0.0]}

    def centred(x):
        return x - torch.mean(x)

    for seed in range(BF16_TILE_SEEDS):
        r = rhs
        if seed:
            gen.manual_seed(SEED + seed)
            r = rhs + scale * torch.randn(rhs.shape, generator=gen,
                                          device=rhs.device)
        bt = krylov.to_tiles(r - torch.mean(r))
        ref = torch.sqrt(torch.sum(bt * bt))
        x32, rn, k = fb.fused_bicgstab_tiles(
            d.sim.grid, bt, rnorm_ref=ref, two_level=False,
            store_dtype=torch.float32, **kw)
        res["f32"].append((int(k), float(rn)))
        target = max(1e-6, 1e-4 * float(ref))
        # x as the solver returns it (its mean removed: the periodic
        # system fixes x up to a constant)
        x32 = centred(x32)
        for tag, kern in (("kernels", None), ("plain", False)):
            x, rn, k = fb.fused_bicgstab_tiles(
                d.sim.grid, bt, rnorm_ref=ref, two_level=False,
                store_dtype=BF16, kernels=kern, **kw)
            res[tag].append((int(k), float(rn)))
            gap = float(torch.max(torch.abs(centred(x) - x32))
                        / torch.max(torch.abs(x32)))
            true = float(torch.sqrt(torch.sum((bt - A(x)) ** 2)) / ref)
            gaps[tag] = [max(gaps[tag][0], gap), max(gaps[tag][1], true)]
        if seed == 0:
            two = [int(fb.fused_bicgstab_tiles(
                d.sim.grid, bt, rnorm_ref=ref, store_dtype=BF16,
                kernels=kern, **kw)[2]) for kern in (None, False)]
            f32_ok = float(res["f32"][0][1]) <= target

    def broke(runs):
        return sum(1 for k, rn in runs if not rn <= 1e6 or k >= 1000)

    def conv(runs):
        return all(k < 1000 and rn == rn for k, rn in runs)

    log(f"  tile-only solves of it on {BF16_TILE_SEEDS} copies (the first "
        f"as caught, then + {TILE_NOISE:g} of max |rhs| noise), iterations: "
        f"bf16 kernels {[k for k, _ in res['kernels']]} "
        f"({broke(res['kernels'])} broke down or stalled), plain "
        f"{[k for k, _ in res['plain']]} ({broke(res['plain'])}), f32 "
        f"kernels {[k for k, _ in res['f32']]}; the bf16 solves' best x "
        f"within {gaps['kernels'][0]:.3e} (kernels; gate {BF16_SOLVE_X}) "
        f"and {gaps['plain'][0]:.3e} (plain) of the f32 x, ||b - A x|| at "
        f"most {gaps['kernels'][1]:.3e} and {gaps['plain'][1]:.3e} of |b|; "
        f"two-level bf16 kernels / plain {two[0]} / {two[1]}")
    if (not conv(res["f32"]) or not f32_ok
            or not gaps["kernels"][0] <= BF16_SOLVE_X
            or abs(two[0] - two[1]) > BF16_SOLVE_ITS):
        raise AssertionError(f"config #2's system: f32 tile-only "
                             f"{res['f32']}, bf16 x and residual {gaps}, "
                             f"two-level {two}")
    uniform.update(broke=broke(res["kernels"]), broke_plain=broke(
        res["plain"]), copies=BF16_TILE_SEEDS, gaps=gaps)
    del d
    torch.cuda.empty_cache()

    out = _fresh_dir(os.path.join(OUT_DIR, "tile_amr_bf16"))
    with _env(**BF16_KNOBS, CUP3D_COARSE="0"):
        d = build_driver(FISH_AMR_ARGV.split() + [
            "-path4serialization", out, "-factory-content", BENCH_TWO_FISH])
        d.init()
        fa.reset_launches()
        for _ in range(BF16_TILE_STEPS):
            d.advance(d.calc_max_timestep())
        torch.cuda.synchronize()
        launches = _counts(fa, True)
        executed = fa.iterations["executed"]
    rows = d.step_log[-BF16_TILE_STEPS:]
    want = _forest_want(executed, tile=executed)
    div = float(diag.fluid_divergence_max_blocks(
        d._geom, d.state["vel"], d.state["chi"], d._tab1))
    log(f"  config #4 ({d.grid.nb} blocks), bf16, CUP3D_COARSE=0: "
        f"{BF16_TILE_STEPS} steps, iterations "
        f"{[int(r['iters']) for r in rows]}; fluid max|div u| {div:.3e} "
        f"(gate {FA_DIV_GATE}); bf16 launches {launches}")
    if (executed != _executed(rows) or launches != want or executed == 0
            or not div < FA_DIV_GATE or not _fish_ok(d)):
        raise AssertionError(f"config #4 tile-only bf16: launches "
                             f"{launches}, executed {executed}, expected "
                             f"{want}; max|div u| {div}")
    return dict(uniform=uniform, forest=dict(launches=launches))


def _fish256_argv(out: str) -> list:
    """Config #2 as bench_fish_uniform(256) builds it: 256^3, pipelined,
    no per-step diagnostics rows, FISH256_STEPS steps."""
    argv = fish_argv(out)
    nb = N_FISH256 // 8
    for flag, value in (("-bpdx", nb), ("-bpdy", nb), ("-bpdz", nb),
                        ("-nsteps", FISH256_STEPS), ("-pipelined", 1),
                        ("-freqDiagnostics", 0)):
        argv = _set_flag(argv, flag, value)
    return argv


def fish256_phase() -> dict:
    """The bench's fish256 through build_driver and simulate(), at bf16
    storage and at f32 (each at CUP3D_FUSED's default: the fused bf16
    kernels, the legacy f32 composition), then at f32 on the fused f32
    kernels (CUP3D_FUSED=1), each from the initial state: ms/step, the
    device's busy share under torch.profiler, iterations a solve,
    launches against the executed iterations, the fluid's max|div u|
    under the bench's fish256 gate, the Krylov gauges."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.obs import metrics
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.ops import krylov

    runs = {}
    for tag, knobs in (("bf16", BF16_KNOBS),
                       ("f32", dict(CUP3D_FUSED=None,
                                    CUP3D_KRYLOV_DTYPE=None)),
                       ("f32 fused", F32_KNOBS)):
        out = _fresh_dir(os.path.join(OUT_DIR,
                                      "fish256_" + tag.replace(" ", "_")))
        with _env(**knobs):
            t0 = time.perf_counter()
            d = build_driver(_fish256_argv(out))
            d.init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            gauges = {k: metrics.gauge(k).value
                      for k in ("poisson.krylov_bf16",
                                "poisson.fused_iteration")}
            fb.reset_launches()
            krylov.iterations["executed"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.simulate()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            bf16 = tag == "bf16"
            launches = _counts(fb, bf16)
            executed = fb.iterations["executed"]
            legacy = krylov.iterations["executed"]
            iters = [r["iters"] for r in d.step_log]
            if len(iters) != FISH256_STEPS:
                raise AssertionError(f"fish256 {tag}: {len(iters)} steps")
            if tag == "f32":  # the legacy composition: no fused launch
                if executed or any(launches.values()) or not legacy:
                    raise AssertionError(f"fish256 f32 at its default: "
                                         f"fused {executed}, launches "
                                         f"{launches}, legacy {legacy}")
            else:
                _check_launches(f"fish256 {tag}", iters, launches, executed)
            div = _fluid_div(d)
            s = d.sim
            ob = s.obstacles[0]
            kin = np.concatenate([ob.transVel, ob.position])
            finite = all(bool(torch.isfinite(s.state[k]).all())
                         for k in ("vel", "p", "chi", "udef"))
            prof = _profile_window(
                d, prefix=f"fish256_{tag.replace(' ', '_')}_", trace=False,
                run=lambda: ([d.advance(d.calc_max_timestep())
                              for _ in range(FISH256_PROFILE_STEPS)],
                             d.flush_packs()))
        ms = wall / FISH256_STEPS * 1e3
        runs[tag] = dict(ms=ms, iters=iters, div=div, launches=launches,
                         executed=executed, legacy=legacy,
                         busy=prof["busy_ms"] / max(prof["wall_ms"], 1e-9),
                         gauges=gauges, init_s=init_s, t=s.time)
        log(f"  {tag}: build + init {init_s:.2f} s; {FISH256_STEPS} steps "
            f"{ms:.2f} ms/step to t={s.time:.5f}; iterations a solve "
            f"{[int(k) for k in iters]} (mean "
            f"{sum(iters) / len(iters):.2f}); fused executed {executed}, "
            f"legacy {legacy}; launches a step "
            f"{ {k: v / FISH256_STEPS for k, v in launches.items()} }; "
            f"fluid max|div u| {div:.4e} (gate {FISH256_DIV_GATE}); "
            f"busy {runs[tag]['busy']:.1%}; gauges {gauges}")
        if not (finite and np.all(np.isfinite(kin))
                and div <= FISH256_DIV_GATE):
            raise AssertionError(f"fish256 {tag}: fields finite {finite}, "
                                 f"transVel/position {kin}, max|div u| "
                                 f"{div}")
        if gauges["poisson.krylov_bf16"] != float(bf16):
            raise AssertionError(f"fish256 {tag}: gauges {gauges}")
        del d
        torch.cuda.empty_cache()
    b, f = runs["bf16"]["iters"], runs["f32"]["iters"]
    worst = max(kb - kf for kb, kf in zip(b, f))
    log(f"  bf16 - f32 iterations a solve: at most {worst} (bound "
        f"{FISH256_EXTRA_ITS}); ms/step bf16 {runs['bf16']['ms']:.2f}, f32 "
        f"(legacy) {runs['f32']['ms']:.2f}, f32 fused "
        f"{runs['f32 fused']['ms']:.2f}")
    if worst > FISH256_EXTRA_ITS:
        raise AssertionError(f"fish256: bf16 iterations {b} against f32 "
                             f"{f}")
    return runs


def pipe_amr_bf16_phase(f32_run: dict) -> dict:
    """Config #3 as the bench runs it (phase 23's main path: the first
    step, PIPE_WARM warm-up and PIPE_TIMED timed on the device dt chain)
    under bf16:
    the bf16 forest kernels' launches equal to the executed iterations,
    max|div u| under 0.05, beside phase 23's f32 run; a profiler
    window."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    out = _fresh_dir(os.path.join(OUT_DIR, "pipe_amr_bf16"))
    with _env(**BF16_KNOBS):
        t0 = time.perf_counter()
        d = build_driver(f"-pipelined 1 -freqDiagnostics 0 {AMR_ARGV} "
                         f"-verbose 0 -path4serialization {out}".split())
        d.init()
        d.adapt_enabled = False
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if not d._dt_chain:
            raise AssertionError("config #3 bf16 is not on the device dt "
                                 "chain")
        fa.reset_launches()
        d.advance(d.calc_max_timestep())
        win = _bench_window(d, PIPE_WARM, PIPE_TIMED)
        d.flush_packs()
        launches = _counts(fa, True)
        executed = fa.iterations["executed"]
        rows = d.step_log[-(1 + PIPE_WARM + PIPE_TIMED):]
        _check_forest_launches("config #3 pipelined bf16", d, launches,
                               executed, rows)
        _, div_max = amr_ops.divergence_norms_blocks(d._geom, d.state["vel"],
                                                     d._tab1)
        div_max = float(div_max)
        iters = [r["iters"] for r in rows]
        log(f"  build_driver + init {init_s:.2f} s; the bench's window "
            f"{win['ms']:.2f} ms/step (phase 23 at f32 "
            f"{f32_run['ms']:.2f}); "
            f"{sum(iters) / len(iters):.2f} iterations a step (f32 "
            f"{f32_run['executed'] / f32_run['steps']:.2f} executed a step), "
            f"{executed} executed; max|div u| {div_max:.3e} (gate "
            f"{AMR_DIV_GATE}); bf16 launches a step "
            f"{ {k: v / len(rows) for k, v in launches.items()} }")
        if not (div_max < AMR_DIV_GATE
                and all(math.isfinite(k) for k in iters)):
            raise AssertionError(f"config #3 bf16: max|div u| {div_max}")
        prof = _profile_window(d, steps=1, prefix="pipe_amr_bf16_",
                               trace=False)
        d.flush_packs()
    return dict(ms=win["ms"], launches=launches, steps=len(rows),
                executed=executed, div_max=div_max, prof=prof,
                iters=iters)


def shard_bf16_phase(dev="cuda") -> dict:
    """Phase 15's 4-shard forest under bf16: its static solver takes the
    JAX package's route (the legacy composition at f32, no fused launch),
    held to the unsharded static solver as phase 15 holds it (both to
    SHARD_TIGHT: x within SHARD_X_ATOL); the unsharded forest's own route
    under bf16 (the fused bf16 two-level solve at the driver's maxiter)
    beside it: its best x within BF16_SOLVE_X of max |x| of the sharded
    solve's, its launches equal to its executed iterations; its
    iterations and residual are printed (on this cold Taylor-Green system
    it breaks down, a NaN residual after its best x was kept, as the
    uniform cold Taylor-Green solve stalls in both packages); B14 moves
    bf16 bitwise as its plain copy."""
    from cup3d_tpu_torch.grid.flux import build_flux_tables
    from cup3d_tpu_torch.ops import amr_ops, krylov
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.parallel import ring

    with _env(**BF16_KNOBS, CUP3D_RING_HALO="1"):
        d, cfg, _ = shard_setup_phase(dev)
        fo, g = d.forest, d.grid
        dt_dev = torch.tensor(d.calc_max_timestep(), dtype=d.dtype,
                              device=d.device)
        v_s = amr_ops.rk3_step_blocks(fo.geom, d.state["vel"], dt_dev, d.nu,
                                      d.uinf_device(), d._tab3, d._ftab)
        b_s = amr_ops.pressure_rhs_blocks(fo.geom, v_s, dt_dev, d._tab1,
                                          d._ftab)
        b_r = fo.unpad(b_s).contiguous()
        tab, ftab = g.face_tables(1, dev), build_flux_tables(g, dev)
        fa.reset_launches()
        krylov.iterations["executed"] = 0
        x_s, st_s = d._solver(b_s, None, tab_arg=d._tab1, flux_arg=d._ftab,
                              with_stats=True)
        routed = (fa.iterations["executed"], krylov.iterations["executed"])
        tight = dict(tol_abs=0.0, tol_rel=SHARD_TIGHT,
                     maxiter=SHARD_TIGHT_ITERS)
        xt_s, _ = fo.build_poisson_solver(**tight)(b_s, with_stats=True)
        xt_r, _ = amr_ops.build_amr_poisson_solver(
            g, tab=tab, flux_tab=ftab, two_level=False, device=dev,
            **tight)(b_r, with_stats=True)
        x_tight = float((fo.unpad(xt_s) - xt_r).abs().max())
        x_prod = fo.unpad(x_s)
        # the unsharded forest's own route under bf16: the fused bf16
        # two-level solve
        maxiter = d._poisson_maxiter
        fused = amr_ops.build_amr_poisson_solver_dynamic(
            g.bs, tol_abs=cfg.poissonTol, tol_rel=cfg.poissonTolRel,
            maxiter=maxiter)
        fa.reset_launches()
        vol = (g.h_column(torch.float32, dev) ** 3).contiguous()
        x_f, st_f = fused(b_r, tab_arg=tab, flux_arg=ftab, geom=g, vol=vol,
                          graph=krylov.block_graph_tables(g, dev),
                          with_stats=True)
        launched = _counts(fa, True)
        rel = float((x_prod - x_f).abs().max() / x_prod.abs().max())
        bm = b_r - torch.sum(b_r * vol) / (torch.sum(vol) * g.bs ** 3)
        target = max(cfg.poissonTol, cfg.poissonTolRel * float(
            torch.sqrt(torch.sum(bm * bm))))
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 28)
        a = torch.randn((fo.D, 4099), generator=gen, device=dev).to(BF16)
        ring_ok = all(torch.equal(ring.ring_shift_kernel(a, s_),
                                  ring.ring_shift_plain(a, s_))
                      for s_ in (1, -1))
    log(f"  the sharded solve under bf16: {int(st_s[1])} iterations, fused "
        f"executed {routed[0]}, legacy {routed[1]} (the JAX package's "
        f"route: the static solver's legacy composition at f32); to "
        f"{SHARD_TIGHT:g} against the unsharded static solve: x within "
        f"{x_tight:.3e} (gate {SHARD_X_ATOL:g}); the unsharded forest's "
        f"fused bf16 solve {int(st_f[1])} "
        f"iterations (cap {maxiter}), residual "
        f"{float(st_f[0]):.3e} (target {target:.3e}), x rel diff from the "
        f"sharded solve {rel:.3e} (gate {BF16_SOLVE_X}), launches "
        f"{launched}; B14 on bf16 bitwise "
        f"its plain copy {ring_ok}")
    if not (routed[0] == 0 and routed[1] > 0 and x_tight <= SHARD_X_ATOL
            and rel <= BF16_SOLVE_X and ring_ok
            and launched["amr_update"] == fa.iterations["executed"]):
        raise AssertionError(f"sharded bf16: route {routed}, x tight "
                             f"{x_tight}, x vs fused bf16 {rel}, launches "
                             f"{launched}, ring {ring_ok}")
    return dict(its=int(st_s[1]), x_tight=x_tight, rel=rel,
                its_bf16=int(st_f[1]), resid_bf16=float(st_f[0]),
                target=target)


# ---------------------------------------------------------------------------
# phases 29-30: the bucketed forest (A6c) and the native lab tables (A6e)
# ---------------------------------------------------------------------------


def bucket_phase(pipe_amr: dict, host_ms: float, bw: float,
                 fp32_flops: float) -> dict:
    """Config #3 as the bench runs it under ``CUP3D_BUCKET=0`` beside
    phase 23's bucketed run of the same call: ms/step, the regrid probe's
    steady p95 and regrid_wall_max_s, capacity against blocks, the table
    memo's hits and misses, the iterations of each step within +-1; then
    B8, B9, B11-B13 at the unpadded forest's block count, the rows'
    times beside phase 7's at capacity."""
    with _env(CUP3D_FUSED="1", CUP3D_BUCKET="0"):
        unb = pipe_amr_phase(host_ms, full=False)
    b, u = pipe_amr, unb
    for tag, r in (("bucketed", b), ("unbucketed", u)):
        pr = r["probe"]
        log(f"  config #3 {tag}: {r['ms']:.2f} ms/step in the bench's window"
            f" ({sum(r['iters']) / len(r['iters']):.2f} iterations a step);"
            f" set-up {r['init_s']:.2f} s (tables {r['tables_s']:.2f} s); "
            f"regrid probe steady {pr['ms']:.2f} ms/step, p95 "
            f"{pr['p95_ms']:.2f}, regrid_wall_max_s "
            f"{pr['bucket']['regrid_wall_max_s']:.4f}; blocks "
            f"{pr['bucket']['blocks']} at capacity {pr['bucket']['capacity']};"
            f" metrics {pr['bucket']['obs_delta']}")
    pairs = list(zip(b["iters"], u["iters"])) + list(
        zip(b["probe"]["iters"], u["probe"]["iters"]))
    worst = max(abs(x - y) for x, y in pairs)
    bk = b["probe"]["bucket"]
    memo = {k: v for k, v in bk["obs_delta"].items() if "memo" in k}
    log(f"  iterations bucketed against unbucketed, {len(pairs)} steps: "
        f"largest difference {worst:.0f} (gate 1); the bucketed probe's "
        f"table memo {memo}")
    if not (worst <= 1 and bk["capacity"] > bk["blocks"]
            and u["probe"]["bucket"]["capacity"] is None):
        raise AssertionError(f"bucketed against unbucketed: iterations "
                             f"{pairs}, capacity {bk}")
    log("  the forest kernels at the unpadded forest's block count "
        "(CUP3D_BUCKET=0)")
    with _env(CUP3D_FUSED="1", CUP3D_BUCKET="0"):
        d = amr_setup_phase()
    kernels = forest_kernel_phase(d, bw, fp32_flops)
    nb = d.grid.nb
    del d
    torch.cuda.empty_cache()
    return dict(unbucketed=u, kernels=kernels, nb=nb)


def native_tables_phase(native_s: float) -> dict:
    """Config #3's set-up (``build_driver`` + ``init()``) with the numpy
    lab-table builder (``CUP3D_NO_NATIVE=1``) beside phase 6's native
    one; the final forest's per-cell tables of width 1 from both
    builders timed and bitwise equal."""
    from cup3d_tpu_torch import native

    with _env(CUP3D_FUSED="1", CUP3D_NO_NATIVE="1"):
        d = amr_setup_phase()
    numpy_s = d.smoke_init_s
    g = d.grid
    del d
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nat = g._build_lab_tables(1)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = g._build_lab_tables_numpy(1)
    np_s = time.perf_counter() - t0
    same = all(nat[k].dtype == ref[k].dtype and np.array_equal(nat[k], ref[k])
               for k in ref if k != "any_coarse"
               ) and nat["any_coarse"] == ref["any_coarse"]
    log(f"  config #3 set-up: native tables {native_s:.2f} s, numpy tables "
        f"{numpy_s:.2f} s; the final forest's width-1 lab tables "
        f"({g.nb} blocks): native {nat_s:.3f} s, numpy {np_s:.3f} s, bitwise "
        f"equal {same} (library {native.library_path().name})")
    if not (same and native.enabled()):
        raise AssertionError("native and numpy lab tables differ")
    return dict(native_s=native_s, numpy_s=numpy_s, lab_native_s=nat_s,
                lab_numpy_s=np_s)



# ---------------------------------------------------------------------------
# phases 31-33: ROADMAP A7's one-card steps (the x-slab megaloop, bodies on
# the sharded forest)
# ---------------------------------------------------------------------------

MESH_X = 4               # CUP3D_MESH_X: x-slabs of the card
MESH_K = 8
MESH_WARM, MESH_TIMED = 2, 4   # megaloops (bench.py bench_mesh2d)
MESH_SIZES = (64, 256)   # bench_mesh2d's 64^3, bench_spectral's 256^3
MESH_FISH_STEPS = 16
MESH_KE_RTOL = 1e-6      # sharded against solo (tests/test_topology.py)
MESH_POS_ATOL = 1e-6
GHOST_W = 3              # the upwind stencil's ghost planes (ops/advection)
SB_STEPS = 3             # config #4 steps, host path and pipelined
SB_POS_ATOL = 1e-7       # tests/test_forest.py's driver bounds
SB_VEL_ATOL = 1e-5       # (transVel)
SB_FIELD_ATOL = 5e-4
CKPT_SPHERE = ("Sphere radius=0.14 xpos=0.4 ypos=0.5 zpos=0.5 xvel=0.3 "
               "bForcedInSimFrame=1")   # tests/test_parity_gaps.py
CKPT_ATOL = 5e-5


def _mesh2d_leg(n: int, mesh_x: int, tag: str) -> dict:
    """bench.py bench_mesh2d's leg: the TGV (bs 16, spectral, nu 0.02,
    CFL 0.3, pipelined, K = 8) through ``Simulation``: MESH_WARM
    megaloops, then MESH_TIMED timed ones each ended by a host read of
    one value, B14's counter set to 0 just before and read just
    after."""
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.parallel import ring
    from cup3d_tpu_torch.sim.simulation import Simulation

    bpd = n // 16
    cfg = SimulationConfig(
        bpdx=bpd, bpdy=bpd, bpdz=bpd, block_size=16, levelMax=1,
        levelStart=0, extent=float(2 * np.pi), CFL=0.3, nu=0.02,
        nsteps=10 ** 9, tend=0.0, rampup=0, initCond="taylorGreen",
        pipelined=True, verbose=False, freqDiagnostics=0, scan_k=MESH_K,
        path4serialization=_fresh_dir(os.path.join(
            OUT_DIR, f"mesh2d_{n}_{tag}")))
    with _env(CUP3D_MESH_X=str(mesh_x) if mesh_x else None):
        d = Simulation(cfg)
        d.init()
        if not d._scan_ready():
            raise AssertionError(f"mesh2d {n}^3 {tag}: megaloop not eligible")
    if (d._scan_mesh is not None) != bool(mesh_x):
        raise AssertionError(f"mesh2d {n}^3 {tag}: _scan_mesh "
                             f"{d._scan_mesh} (a slab build fell back)")
    for _ in range(MESH_WARM):
        d.advance_megaloop()
    torch.cuda.synchronize()
    ring.reset_launches()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED):
        d.advance_megaloop()
        float(d.sim.state["vel"][0, 0, 0, 0])
    wall = time.perf_counter() - t0
    launches = ring.launches["ring_shift"]
    d.flush_packs()
    steps = MESH_TIMED * MESH_K
    return dict(d=d, ms=wall / steps * 1e3, b14_per_step=launches / steps)


def _slab_ring_check(vel, D: int, bw: float) -> dict:
    """B14 at the x-slab halo shapes of a (n, n, n, 3) field on D slabs
    against its plain version, bitwise (the 3-plane ghosts of each
    component, the 1-plane ghosts of a scalar slab, both shifts); timed
    at one component's 3-plane ghost planes (a strided (D, 3, n, n) view,
    words at a 12-byte stride) beside the plain version, torch.roll of
    the same view and its bound."""
    from cup3d_tpu_torch.parallel import ring

    n = vel.shape[0]
    sx = n // D
    u = vel.reshape(D, sx, n, n, 3)
    f = u[..., 0]
    views = ([u[..., c][:, sx - GHOST_W:] for c in range(3)]
             + [u[..., c][:, :GHOST_W] for c in range(3)]
             + [f[:, sx - 1:], f[:, :1]])
    for x in views:
        for k in (1, -1):
            if not torch.equal(ring.ring_shift_kernel(x, k),
                               ring.ring_shift_plain(x, k)):
                raise AssertionError(f"B14 at the slab shape {tuple(x.shape)}"
                                     f" stride {x.stride()}: kernel != plain")
    x = views[0]
    nbytes = x.numel() * x.element_size()
    r = dict(shape=list(x.shape), stride=list(x.stride()), checked=len(views) * 2,
             max_abs_err=0.0,
             ms=time_ms(lambda: ring.ring_shift_kernel(x, 1)),
             plain_ms=time_ms(lambda: ring.ring_shift_plain(x, 1)),
             library_ms=time_ms(lambda: torch.roll(x, 1, 0)),
             bound_ms=2 * nbytes / bw * 1e3, bound_by="bytes")
    log(f"  B14 at the slab halo shapes ({len(views)} views x 2 shifts, "
        f"bitwise its plain version); at {tuple(x.shape)} stride "
        f"{tuple(x.stride())}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
        f"torch.roll {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}")
    return r



def mesh2d_phase(bw: float) -> dict:
    """Phase 31 (see the module docstring)."""
    out = {}
    for n in MESH_SIZES:
        solo = _mesh2d_leg(n, 0, "solo")
        v_solo = solo.pop("d").sim.state["vel"].clone()
        torch.cuda.empty_cache()
        shd = _mesh2d_leg(n, MESH_X, "sharded")
        d = shd.pop("d")
        v = d.sim.state["vel"]
        equal = torch.equal(v, v_solo)
        diff = float(torch.max(torch.abs(v - v_solo)))
        scale = float(torch.max(torch.abs(v_solo)))
        ke, ke_solo = _mean_ke(v), _mean_ke(v_solo)
        log(f"  {n}^3 TGV, K={MESH_K}, {MESH_TIMED * MESH_K} timed steps: "
            f"solo {solo['ms']:.3f} ms/step, {MESH_X} x-slabs "
            f"{shd['ms']:.3f} ms/step (ratio {shd['ms'] / solo['ms']:.3f}: "
            f"overhead on one card, not scaling); B14 "
            f"{shd['b14_per_step']:.1f} launches a step (solo "
            f"{solo['b14_per_step']:.1f}); sharded vel == solo vel "
            f"{equal} (largest difference {diff:.3e} of max |u| "
            f"{scale:.3e}); KE {ke_solo:.10e} / {ke:.10e}")
        if not (shd["b14_per_step"] > 0 and solo["b14_per_step"] == 0
                and math.isfinite(ke)
                and abs(ke - ke_solo) <= MESH_KE_RTOL * abs(ke_solo)
                and diff <= 1e-6 * scale):
            raise AssertionError(f"mesh2d {n}^3: {shd}, {solo}, vel diff "
                                 f"{diff}, KE {ke} / {ke_solo}")
        row = dict(solo_ms=solo["ms"], sharded_ms=shd["ms"],
                   ratio=shd["ms"] / solo["ms"],
                   b14_per_step=shd["b14_per_step"], bitwise=equal,
                   max_diff=diff)
        if n == MESH_SIZES[-1]:
            row["slab_kernel"] = _slab_ring_check(v, MESH_X, bw)
        out[n] = row
        del d, v, v_solo
        torch.cuda.empty_cache()
    return out


def _spectral_fish_argv(out: str, nsteps: int) -> list:
    return _set_flag(_bench_fish_argv(out, nsteps, MESH_K),
                     "-poissonSolver", "spectral")


def fish_mesh_phase() -> dict:
    """Phase 32 (see the module docstring)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.parallel import ring

    runs = {}
    for tag, mx in (("solo", None), ("sharded", str(MESH_X))):
        out = _fresh_dir(os.path.join(OUT_DIR, f"fish_mesh_{tag}"))
        with _env(CUP3D_MESH_X=mx):
            d = build_driver(_spectral_fish_argv(out, MESH_FISH_STEPS))
            d.init()
            torch.cuda.synchronize()
            ring.reset_launches()
            t0 = time.perf_counter()
            d.simulate()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if d._scan_k != MESH_K or (d._scan_mesh is not None) != bool(mx):
            raise AssertionError(f"fish {tag}: K {d._scan_k}, _scan_mesh "
                                 f"{d._scan_mesh}")
        ob = d.sim.obstacles[0]
        runs[tag] = dict(ms=wall / MESH_FISH_STEPS * 1e3,
                         b14=ring.launches["ring_shift"] / MESH_FISH_STEPS,
                         ke=_mean_ke(d.sim.state["vel"]),
                         pos=np.asarray(ob.position, np.float64),
                         vel=d.sim.state["vel"].clone(),
                         steps=d.sim.step)
        _check_fish(d, f"spectral fish {tag}")
        del d
        torch.cuda.empty_cache()
    a, b = runs["solo"], runs["sharded"]
    equal = torch.equal(a["vel"], b["vel"])
    dpos = float(np.abs(a["pos"] - b["pos"]).max())
    log(f"  config #2's box at {N_FISH}^3, spectral, K={MESH_K}, "
        f"{MESH_FISH_STEPS} steps: solo {a['ms']:.2f} ms/step, {MESH_X} "
        f"x-slabs {b['ms']:.2f} ms/step (ratio {b['ms'] / a['ms']:.3f}); B14 "
        f"{b['b14']:.1f} launches a step; KE {a['ke']:.10e} / "
        f"{b['ke']:.10e}, position difference {dpos:.3e}, vel bitwise "
        f"{equal}")
    if not (a["steps"] == b["steps"] == MESH_FISH_STEPS and b["b14"] > 0
            and abs(a["ke"] - b["ke"]) <= MESH_KE_RTOL * abs(a["ke"])
            and dpos <= MESH_POS_ATOL):
        raise AssertionError(f"fish on the slab mesh: {a['ke']} / {b['ke']},"
                             f" position {dpos}, B14 {b['b14']}")
    # config #2 as it stands (iterative Poisson): the solo megaloop
    out = _fresh_dir(os.path.join(OUT_DIR, "fish_mesh_iterative"))
    with _env(CUP3D_MESH_X=str(MESH_X)):
        d = build_driver(_bench_fish_argv(out, MESH_K, MESH_K))
        d.init()
        ring.reset_launches()
        d.simulate()
        torch.cuda.synchronize()
    routed = dict(scan_k=d._scan_k, mesh=d._scan_mesh,
                  b14=ring.launches["ring_shift"], steps=d.sim.step)
    log(f"  config #2 as it stands (iterative) under CUP3D_MESH_X={MESH_X}: "
        f"{routed['steps']} steps, K {routed['scan_k']}, _scan_mesh "
        f"{routed['mesh']}, B14 launches {routed['b14']} (the solo megaloop)")
    if not (routed["scan_k"] == MESH_K and routed["mesh"] is None
            and routed["b14"] == 0 and routed["steps"] == MESH_K):
        raise AssertionError(f"config #2 iterative under the slab mesh: "
                             f"{routed}")
    del d
    torch.cuda.empty_cache()
    return dict(solo_ms=a["ms"], sharded_ms=b["ms"], b14_per_step=b["b14"],
                bitwise=equal)


def _sb_compare(tag: str, sh, ref) -> dict:
    """Sharded against unsharded: positions, transVel, the velocity."""
    dpos = max(float(np.abs(np.asarray(a.position) - b.position).max())
               for a, b in zip(sh.obstacles, ref.obstacles))
    dtv = max(float(np.abs(np.asarray(a.transVel) - b.transVel).max())
              for a, b in zip(sh.obstacles, ref.obstacles))
    dvel = float(torch.max(torch.abs(sh._unpad(sh.state["vel"])
                                     - ref._unpad(ref.state["vel"]))))
    pad = all(not bool(v[sh.grid.nb:].any()) for v in sh.state.values())
    if not (sh.grid.keys == ref.grid.keys and dpos <= SB_POS_ATOL
            and dtv <= SB_VEL_ATOL and dvel <= SB_FIELD_ATOL and pad
            and _fish_ok(sh)):
        raise AssertionError(f"{tag}: positions {dpos}, transVel {dtv}, vel "
                             f"{dvel}, padding rows 0 {pad}")
    return dict(pos=dpos, trans_vel=dtv, vel=dvel)


def sharded_bodies_phase(host_ms: float, pipe_ms: float) -> dict:
    """Phase 33 (see the module docstring)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.config import parse_args
    from cup3d_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.parallel import ring
    from cup3d_tpu_torch.parallel.forest import make_block_mesh
    from cup3d_tpu_torch.sim.amr import AMRSimulation

    mesh = make_block_mesh([torch.device("cuda")] * SHARDS)
    out = _fresh_dir(os.path.join(OUT_DIR, "sharded_bodies"))
    res = {}
    with _env(CUP3D_FUSED="1", CUP3D_RING_HALO="1"):
        t0 = time.perf_counter()
        d = build_driver(FISH_AMR_ARGV.split() + [
            "-path4serialization", out, "-factory-content", BENCH_TWO_FISH])
        d.init()
        path = save_checkpoint(d, os.path.join(out, "init.pkl"))
        log(f"  config #4: build_driver + init {time.perf_counter() - t0:.2f}"
            f" s, {d.grid.nb} blocks; its state restored unsharded and on "
            f"{SHARDS} shards of the card")
        del d
        for mode in ("host", "pipelined"):
            drv = {}
            for tag, m in (("sharded", mesh), ("unsharded", None)):
                t0 = time.perf_counter()
                x = load_checkpoint(path, mesh=m)
                load_s = time.perf_counter() - t0
                x.cfg.pipelined = mode == "pipelined"
                torch.cuda.synchronize()
                ring.reset_launches()
                fa.reset_launches()
                walls = _timed_steps(x, SB_STEPS)
                if x.cfg.pipelined:
                    x.flush_packs()
                torch.cuda.synchronize()
                drv[tag] = (x, dict(
                    load_s=load_s, ms=float(np.mean(walls[1:])) * 1e3,
                    first_ms=walls[0] * 1e3,
                    b14=ring.launches["ring_shift"] / SB_STEPS,
                    fused={k: v / SB_STEPS for k, v in fa.launches.items()}))
            sh, s_info = drv["sharded"]
            ref, u_info = drv["unsharded"]
            cmp = _sb_compare(f"config #4 {mode}, sharded", sh, ref)
            log(f"  {mode}: {SB_STEPS} steps, {SHARDS} shards "
                f"{s_info['ms']:.2f} ms/step (first {s_info['first_ms']:.2f})"
                f" against unsharded {u_info['ms']:.2f} (phase "
                f"{22 if mode == 'host' else 24}: "
                f"{host_ms if mode == 'host' else pipe_ms:.2f}); nb_pad "
                f"{sh.forest.nb_pad} for {sh.grid.nb} blocks; B14 "
                f"{s_info['b14']:.1f} launches a step, forest kernels a step"
                f" {s_info['fused']}; positions within {cmp['pos']:.3e}, "
                f"transVel {cmp['trans_vel']:.3e}, vel {cmp['vel']:.3e}; "
                f"restore {s_info['load_s']:.2f} s sharded")
            if not s_info["b14"] > 0:
                raise AssertionError(f"config #4 {mode} sharded: no B14 "
                                     "launch")
            res[mode] = dict(sharded=s_info, unsharded=u_info, **cmp)
            del drv, sh, ref
            torch.cuda.empty_cache()
        # the sphere of tests/test_parity_gaps.py: saved unsharded, resumed
        # sharded beside its unsharded resume
        cfg = parse_args(
            ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 2 -levelStart 0 -extent 1 "
             "-CFL 0.4 -Ctol 0.1 -Rtol 5 -nu 1e-3 -tend 0 -nsteps 2 "
             "-rampup 0 -dt 1e-3 -poissonSolver iterative -poissonTol 1e-5 "
             "-poissonTolRel 1e-3 -verbose 0 -freqDiagnostics 0 "
             f"-path4serialization {out}").split()
            + ["-factory-content", CKPT_SPHERE])
        d = AMRSimulation(cfg)
        d.init()
        d.simulate()
        path = save_checkpoint(d, os.path.join(out, "sphere.pkl"))
        ref = load_checkpoint(path)
        sh = load_checkpoint(path, mesh=mesh)
        ring.reset_launches()
        for x in (ref, sh):
            x.adapt_enabled = False
            for _ in range(2):
                x.advance(1e-3)
        torch.cuda.synchronize()
        dvel = float(torch.max(torch.abs(sh._unpad(sh.state["vel"])
                                         - ref.state["vel"][:ref.grid.nb])))
        pad = all(not bool(v[sh.grid.nb:].any()) for v in sh.state.values())
        log(f"  the sphere resumed on {SHARDS} shards (nb_pad "
            f"{sh.forest.nb_pad}, {sh.grid.nb} blocks) beside its unsharded "
            f"resume: vel within {dvel:.3e} (gate {CKPT_ATOL}), padding rows "
            f"0 {pad}, B14 {ring.launches['ring_shift']} launches")
        if not (dvel <= CKPT_ATOL and pad and sh.state["vel"].shape[0]
                == sh.forest.nb_pad and ring.launches["ring_shift"] > 0):
            raise AssertionError(f"sharded resume of the sphere: vel {dvel}")
        res["ckpt_vel"] = dvel
    return res


# ---------------------------------------------------------------------------
# phases 34-35: the fleet (A8a), lanes of one batched K-step advance
# ---------------------------------------------------------------------------

# phase 34: bench_fleet32 as bench.py:1523-1662 runs it: FLEET_LANES fish
# lanes at FLEET_N^3, FLEET_STEPS steps (K = 8), after a warm-up drain,
# against the same jobs served one at a time through the per-step path
FLEET_LANES = 32
FLEET_N = 32
FLEET_STEPS = 16
FLEET_GATE = 4.0        # bench.py's fleet_amortization_gate (reported)
FLEET_SPEC = dict(kind="fish", n=FLEET_N, nsteps=FLEET_STEPS, cfl=0.3,
                  L=0.3, T=1.0, xpos=0.5)
FLEET_CHECK_LANES = (0, 17)
# tests/test_fleet.py's lane-vs-solo bounds
FLEET_KE_RTOL = 1e-4
FLEET_POS_ATOL = 1e-5
# phase 35: FA_LANES amr_tgv lanes on config #3's forest as bench.py's
# bench_amr_tgv builds it at its default scale (:1155-1175: bpd 8,
# levelMax 2, levelStart 0, Rtol 1.8, Ctol 0.05, nu 1e-3), CFLs spread
# over 0.30-0.40, FA_FLEET_STEPS steps, CUP3D_FUSED=1
FA_LANES = 8
FA_FLEET_STEPS = 16
FA_FLEET_SPEC = dict(kind="amr_tgv", bpd=8, levelMax=2, levelStart=0,
                     rtol=1.8, ctol=0.05, nu=1e-3, nsteps=FA_FLEET_STEPS)
FA_FLEET_SNAP = 8       # a journaled snapshot every dispatch (K = 8)
# the server's default lane ladder pads the 8 jobs to 9 lanes; the
# padding lane is frozen, and its Poisson solve does not iterate
FA_NAN_LANE = 3
FA_SOLO_EVERY = 2       # every other lane against its solo run (time)
# tests/test_fused_amr.py's lane-vs-solo bounds
FA_VEL_ATOL = 1e-4
FA_TIME_RTOL = 1e-4
#: the forest stages' launches a Krylov iteration (the fused driver)
FA_PER_ITER = {"amr_update": 1, "amr_getz_two": 2, "amr_lap": 2,
               "amr_axpy": 1, "amr_finish": 1}


def _fleet_drain(specs, out: str, before_steps=None, **kw):
    """A fresh server drains ``specs``; ``before_steps()`` runs after the
    batches are assembled (the lanes' drivers built and initialised) and
    before the first dispatch.  Returns (server, job ids, seconds of the
    drain after assembly: dispatches, fan-out and journal snapshots)."""
    from cup3d_tpu_torch.fleet.server import FleetServer

    srv = FleetServer(workdir=out, **kw)
    ids = [srv.submit(f"tenant-{i}", dict(sp)) for i, sp in enumerate(specs)]
    srv.assemble()
    torch.cuda.synchronize()
    if before_steps is not None:
        before_steps()
    t0 = time.perf_counter()
    srv.drain()
    torch.cuda.synchronize()
    return srv, ids, time.perf_counter() - t0


def _lane_np(srv, job_id) -> dict:
    """One job's lane of its batch's carry, f64 host copies."""
    job = srv._jobs[job_id]
    return {k: v[job.lane].detach().double().cpu().numpy()
            for k, v in job.batch.carry.items() if k != "left"}


def fleet32_phase(bw: float) -> dict:
    """bench_fleet32 on the port: serving throughput of FLEET_LANES fish
    jobs in one lane batch against the same jobs served one at a time
    (both warm, both paying their set-up in the window); two lanes held to
    the port's solo K = 8 megaloop of the spec; the Frenet kernel launched
    once a step for all lanes."""
    from cup3d_tpu_torch.config import SimulationConfig
    from cup3d_tpu_torch.fleet.server import FleetServer
    from cup3d_tpu_torch.models.fish import device_midline as dm
    from cup3d_tpu_torch.sim.simulation import Simulation

    B, n, nsteps = FLEET_LANES, FLEET_N, FLEET_STEPS
    out = _fresh_dir(os.path.join(OUT_DIR, "fleet32"))
    srv = FleetServer(max_lanes=B, snap_every=10**9, workdir=out)
    for _ in range(B):
        srv.submit("warmup", dict(FLEET_SPEC, nsteps=8))
    srv.drain()
    torch.cuda.synchronize()
    ids = [srv.submit(f"lane-{i}", dict(FLEET_SPEC)) for i in range(B)]
    host = 0.0
    t0 = time.perf_counter()
    (batch,) = srv.assemble()
    torch.cuda.synchronize()
    dm.launches["frenet"] = 0
    t_loop = time.perf_counter()
    while (batch.left_h > 0).any():
        t1 = time.perf_counter()
        batch.dispatch()
        host += time.perf_counter() - t1
    batch.settle()  # every QoI row consumed: every lane-step done
    t_end = time.perf_counter()
    frenet = dm.launches["frenet"]
    wall, loop_wall = t_end - t0, t_end - t_loop
    done = sum(srv.poll(j)["status"] == "done" for j in ids)
    if done != B:
        raise AssertionError(f"fleet32: {done} of {B} jobs done")
    if batch.carry["vel"].is_cuda and frenet != nsteps:
        raise AssertionError(f"fleet32: {frenet} Frenet launches for "
                             f"{nsteps} steps of {B} lanes (want one a step)")
    fleet_cells = B * n ** 3 * nsteps / wall

    def cfg_of(**kw):
        base = dict(bpdx=1, bpdy=1, bpdz=1, block_size=n, levelMax=1,
                    levelStart=0, extent=1.0, nu=1e-4, CFL=0.3,
                    nsteps=nsteps, tend=0.0, rampup=0,
                    factory_content="stefanfish L=0.3 T=1.0 xpos=0.5",
                    dtype="float32", verbose=False, freqDiagnostics=0,
                    path4serialization=out)
        base.update(kw)
        return SimulationConfig(**base)

    def solo_job():
        d = Simulation(cfg_of(scan_k=0))
        d.init()
        for _ in range(nsteps):
            d.advance(d.calc_max_timestep())
        torch.cuda.synchronize()
        return d

    solo_job()  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        solo_job()
    solo_wall = (time.perf_counter() - t0) / 3
    solo_cells = n ** 3 * nsteps / solo_wall
    ratio = fleet_cells / max(solo_cells, 1e-9)

    # two lanes against the port's solo K = 8 megaloop of the spec
    d = Simulation(cfg_of(scan_k=SCAN_K, pipelined=True))
    d.init()
    d.simulate()
    torch.cuda.synchronize()
    if d._scan_k != SCAN_K:
        raise AssertionError("fleet32: the solo twin did not take the "
                             "megaloop")
    s = d.sim
    vel_s = s.state["vel"].double()
    ke_s = float(torch.sum(vel_s * vel_s))
    pos_s = np.asarray(s.obstacles[0].position, np.float64)
    errs = {}
    for lane in FLEET_CHECK_LANES:
        ln = _lane_np(srv, ids[lane])
        ke = float(np.sum(ln["vel"] ** 2))
        dke = abs(ke - ke_s) / ke_s
        dpos = float(np.max(np.abs(ln["rigid"][6:9] - pos_s)))
        if not (dke <= FLEET_KE_RTOL and dpos <= FLEET_POS_ATOL):
            raise AssertionError(f"fleet32 lane {lane}: KE rel {dke:.3e}, "
                                 f"position {dpos:.3e} off the solo "
                                 "megaloop")
        errs[lane] = (dke, dpos)
    res = {
        "fleet_cells_per_s": fleet_cells,
        "solo_cells_per_s": solo_cells,
        "fleet_steady_cells_per_s": B * n ** 3 * nsteps / loop_wall,
        "wall_per_lane_step_s": loop_wall / (B * nsteps),
        "host_dispatch_per_lane_s": host / (B * nsteps),
        "solo_job_wall_s": solo_wall,
        "fleet_amortization_ratio": ratio,
        "fleet_amortization_gate": FLEET_GATE,
        "dispatches": int(batch.dispatches), "jobs_done": int(done),
        "frenet_launches": frenet, "frenet_lanes": B,
    }
    log(f"  {B} fish lanes at {n}^3, {nsteps} steps: fleet_cells_per_s "
        f"{fleet_cells:.6g}, solo_cells_per_s {solo_cells:.6g}, "
        f"wall_per_lane_step_s {res['wall_per_lane_step_s']:.6g}, "
        f"host_dispatch_per_lane_s {res['host_dispatch_per_lane_s']:.6g}, "
        f"fleet_amortization_ratio {ratio:.4f} (bench gate {FLEET_GATE}; "
        f"reported, not asserted); serving wall {wall:.3f} s (dispatch loop "
        f"{loop_wall:.3f} s), solo job {solo_wall:.3f} s")
    log(f"  every job done; the Frenet kernel {frenet} launches for "
        f"{nsteps} steps of {B} lanes; lanes {FLEET_CHECK_LANES} against "
        f"the solo K={SCAN_K} megaloop: KE rel / position "
        + ", ".join(f"{a:.3e} / {b:.3e}" for a, b in errs.values()))
    # the Frenet kernel at the fleet's shape: one launch on B midlines
    gaits = batch.gaits
    rs = gaits["rs"].contiguous()
    t = batch.carry["time"]
    from cup3d_tpu_torch.models.fish.device_midline import (
        midline_curvature_device)

    rk, vk = torch.func.vmap(midline_curvature_device)(gaits, t)
    rk, vk = rk.contiguous(), vk.contiguous()
    got = dm._frenet_scan_dev(rs, rk, vk)
    want = dm._frenet_scan_dev(rs, rk, vk, kernels=False)
    ferr = max(check_close(f"frenet lanes {k}", got[k], want[k], FRENET_RTOL)
               for k in got)
    nm = rs.shape[-1]
    res["frenet_lanes_ms"] = time_ms(lambda: dm._frenet_scan_dev(rs, rk, vk))
    res["frenet_lanes_plain_ms"] = time_ms(
        lambda: dm._frenet_scan_dev(rs, rk, vk, kernels=False), 1)
    res["frenet_lanes_bound_ms"] = (B * nm * (3 * 4 + 18 * 4)) / bw * 1e3
    res["frenet_lanes_err"] = ferr
    log(f"  frenet at {B} lanes x {nm} points: {res['frenet_lanes_ms']:.4f} "
        f"ms a launch (plain {res['frenet_lanes_plain_ms']:.4f} ms), err "
        f"{ferr:.3e}")
    del srv, batch, d
    # the CLI entry on a mixed queue: `python -m cup3d_tpu_torch fleet
    # --scenarios spec.json` (in this process), its summary JSON
    import contextlib
    import io

    from cup3d_tpu_torch.__main__ import main as cli_main

    spec = os.path.join(out, "mixed.json")
    with open(spec, "w") as f:
        json.dump({"scenarios": [
            dict(kind="tgv", n=32, nsteps=8, cfl=0.3, tenant="tgv"),
            dict(FLEET_SPEC, nsteps=8, tenant="fish"),
            dict(kind="amr_tgv", bpd=2, levelMax=2, nsteps=8,
                 tenant="amr")]}, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(["fleet", "--scenarios", spec, "--workdir",
                      os.path.join(out, "cli")])
            code = 0
        except SystemExit as e:
            code = e.code
    summary = json.loads(buf.getvalue())
    got = {t: v["statuses"] for t, v in summary.items()}
    if code != 0 or got != {t: {"done": 1} for t in ("tgv", "fish", "amr")}:
        raise AssertionError(f"fleet CLI: exit {code}, {got}")
    log(f"  python -m cup3d_tpu_torch fleet --scenarios (tgv + fish + "
        f"amr_tgv): exit 0, per-tenant statuses {got}")
    return res


def _fa_stack_vecs(d, L: int, gen):
    """L lanes of the template forest's capacity stacked along the block
    axis: seeded block fields with every lane's padding rows 0, the
    volume column tiled, the lanes' real block count."""
    g = d._geom
    n, nb = g.nb, d.grid.nb
    dev = d.device

    def vec(dtype=torch.float32):
        v = torch.randn((L, n, 8, 8, 8), generator=gen, device=dev)
        v[:, nb:] = 0.0
        return v.reshape(L * n, 8, 8, 8).to(dtype)

    vol = d._vol.reshape(n).float().repeat(L).contiguous()
    return n, vec, vol


def fleet_lane_kernels(d, L: int, bw: float, fp32_flops: float) -> dict:
    """B8, B12, B13 with an (L, 8) block of scalar rows, one row a lane, on
    L lanes of the template forest stacked along the block axis, at f32
    and bf16: each lane's stored vectors bitwise its plain version on its
    blocks, the partials within PART_RTOL, the L-lane launch bitwise the
    one-lane launches, the (1, 8) call bitwise the (8,) one; B9 and B11 on
    the same L x cap blocks against their plain versions (the stage rule
    of phase 7).  Each timed at L x cap blocks."""
    from cup3d_tpu_torch.ops import amr_ops
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa

    dev = d.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 35)
    n, vec, vol = _fa_stack_vecs(d, L, gen)
    cells = L * n * 512
    rows = torch.randn((L, 8), generator=gen, device=dev)
    rows[:, 2] = 0.0
    rows[FA_NAN_LANE % L, 2] = 1.0  # one lane on the breakdown branch
    out = {}
    for store in (torch.float32, torch.bfloat16):
        tag = "f32" if store == torch.float32 else "bf16"
        r, p, v, rh, y, z, s_, t = (vec(store) for _ in range(8))
        x = vec()
        stages = {
            "amr_update": lambda sc, sl=slice(None), kk=None: fa.update(
                r[sl], p[sl].clone(), v[sl], rh[sl].clone(), vol[sl], sc,
                kernels=kk),
            "amr_axpy": lambda sc, sl=slice(None), kk=None: fa.axpy(
                r[sl], v[sl], vol[sl], sc, kernels=kk),
            "amr_finish": lambda sc, sl=slice(None), kk=None: fa.finish(
                x[sl].clone(), y[sl], z[sl], s_[sl].clone(), t[sl], rh[sl],
                sc, kernels=kk),
        }

        def scales(name, outs, sl):
            """The partials' error scales: per block sums of |terms|."""
            f = [u.float() for u in outs]
            if name == "amr_finish":
                return (part_scale(f[1] * f[1]),
                        part_scale(rh[sl].float() * f[1]))
            return (part_scale(f[0] * vol[sl][:, None, None, None]),)
        for name, fn in stages.items():
            got = fn(rows)
            want = fn(rows, kk=False)
            worst = 0.0
            for lane in range(L):
                sl = slice(lane * n, (lane + 1) * n)
                one = fn(rows[lane].contiguous(), sl)
                for a, b in zip(got, one):
                    if not torch.equal(a[sl], b):
                        raise AssertionError(f"{name} {tag}: lane {lane} of "
                                             "the lane launch differs from "
                                             "its one-lane launch")
                sc_iter = iter(scales(name, one, sl))
                for a, b in zip(got, want):
                    if a.dim() > 1:
                        if not torch.equal(a[sl], b[sl]):
                            raise AssertionError(
                                f"{name} {tag}: lane {lane} not bitwise "
                                "its plain version")
                    else:
                        worst = max(worst, check_close(
                            f"{name} {tag} lane {lane} partials", a[sl],
                            b[sl], PART_RTOL, next(sc_iter)))
            first = fn(rows[:1].contiguous(), slice(0, n))
            old = fn(rows[0].contiguous(), slice(0, n))
            if not all(torch.equal(a, b) for a, b in zip(first, old)):
                raise AssertionError(f"{name} {tag}: the (1, 8) call is not "
                                     "bitwise the (8,) call")
            out.setdefault(name, {})[f"partials_err_{tag}"] = worst
            log(f"    {name} {tag} at {L} lanes x {n} blocks: vectors bitwise "
                "the plain version a lane, the lane launch bitwise the "
                "one-lane launches, (1, 8) bitwise (8,); partials "
                f"{worst:.3e}")
    # B9 and B11 on the lanes' stacked blocks (per-block columns tiled)
    h = d._geom.h_column(torch.float32, dev).reshape(n)
    h2 = (h * h).repeat(L).contiguous()
    inv_h2 = (1.0 / (h * h)).repeat(L).contiguous()
    w = vec()
    zc = torch.randn(L * n, generator=gen, device=dev)
    zc.view(L, n)[:, d.grid.nb:] = 0.0
    azf = torch.func.vmap(lambda u: amr_ops.laplacian_blocks(
        d._geom, u[:, None, None, None].expand(n, 8, 8, 8), d._tab1,
        d._ftab))(zc.view(L, n)).reshape(L * n, 8, 8, 8).contiguous()
    e9 = check_close("amr_getz_two lanes", fa.getz_two(w, azf, zc, h2),
                     fa.getz_two(w, azf, zc, h2, kernels=False), GETZ_RTOL)
    inv_h = (1.0 / h)[:, None, None, None]

    def lab_corr(u):
        lab = d._tab1.assemble_scalar(u, 8)
        return lab, d._ftab.apply(torch.zeros_like(u),
                                  amr_ops.face_fluxes(lab, 1, 8, inv_h))

    lab, corr = torch.func.vmap(lab_corr)(w.view(L, n, 8, 8, 8))
    lab = lab.reshape(L * n, 10, 10, 10).contiguous()
    corr = corr.reshape(L * n, 8, 8, 8).contiguous()
    a = vec()
    got, want = fa.lap(lab, corr, a, inv_h2), fa.lap(lab, corr, a, inv_h2,
                                                     kernels=False)
    e11 = check_close("amr_lap lanes", got[0], want[0], VEC_RTOL)
    log(f"    amr_getz_two / amr_lap at {L} lanes x {n} blocks against their "
        f"plain versions: {e9:.3e} / {e11:.3e}")
    # device time per launch at L x cap blocks, f32
    r, p, v, rh, y, z, s_, t = (vec() for _ in range(8))
    x = vec()
    timed = {
        "amr_update": (lambda: fa.update(r, p, v, rh, vol, rows),
                       4 * 4 * cells, 5 * cells),
        "amr_getz_two": (lambda: fa.getz_two(w, azf, zc, h2),
                         3 * 4 * cells + 8 * L * n, 110 * cells),
        "amr_lap": (lambda: fa.lap(lab, corr, a, inv_h2),
                    (1000 / 512 + 3) * 4 * cells, 10 * cells),
        "amr_axpy": (lambda: fa.axpy(r, v, vol, rows), 3 * 4 * cells,
                     4 * cells),
        "amr_finish": (lambda: fa.finish(x, y, z, s_, t, rh, rows),
                       8 * 4 * cells, 10 * cells),
    }
    for name, (fn, nbytes, flops) in timed.items():
        ms = time_ms(fn)
        us = profile_us(fn, FOREST_KERNEL_NAMES[name])
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_flops * 1e3
        out.setdefault(name, {}).update(
            blocks=L * n, ms=ms, profile_us=us,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"    {name:13s} at {L} x {n} blocks: {ms:.4f} ms a launch "
            f"(profile {us} us), bound {max(t_bytes, t_ops):.4f} ms")
    torch.cuda.synchronize()
    return out


def _fa_iters(rows) -> list:
    return [int(r[1]) for r in rows]


def fleet_amr_phase(bw: float, fp32_flops: float) -> dict:
    """FA_LANES amr_tgv lanes on config #3's forest under CUP3D_FUSED=1
    (the caller sets it): the lanes against the port's solo fused forest
    step of their specs; the forest stages' launches a dispatch at
    FA_LANES lanes and at one; the stage kernels with a scalar row a lane;
    fleet.lane_nan at lane FA_NAN_LANE; a server.crash drill recovered in
    this process; the lanes at bf16 storage."""
    from unittest import mock

    from cup3d_tpu_torch.fleet import batch as FB
    from cup3d_tpu_torch.fleet import server as S
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.resilience import faults
    from cup3d_tpu_torch.sim.amr import make_amr_tgv_step

    cfls = [float(c) for c in np.linspace(0.30, 0.40, FA_LANES)]
    specs = [dict(FA_FLEET_SPEC, cfl=c) for c in cfls]
    out = _fresh_dir(os.path.join(OUT_DIR, "fleet_amr"))
    res = {}

    # -- the f32 drain: every lane done, the launches a dispatch -----------
    t0 = time.perf_counter()
    srv, ids, loop_s = _fleet_drain(specs, os.path.join(out, "f32"),
                                    before_steps=fa.reset_launches,
                                    snap_every=FA_FLEET_SNAP)
    wall = time.perf_counter() - t0
    if srv.jobs_by_status() != {"done": FA_LANES}:
        raise AssertionError(f"fleet amr: {srv.jobs_by_status()}")
    batch = srv._jobs[ids[0]].batch
    tmpl = batch.template.sim
    executed = fa.iterations["executed"]
    disp = int(batch.dispatches)
    counts = dict(fa.launches)
    on_card = tmpl.state["vel"].is_cuda
    for kname, per in FA_PER_ITER.items():
        if on_card and counts[kname] != per * executed:
            raise AssertionError(f"fleet amr: {kname} {counts[kname]} "
                                 f"launches for {executed} iterations")
    # every live lane steps until the last one stops, in chunks of 4; the
    # padding lane does not iterate
    rows = {jid: srv._jobs[jid].rows for jid in ids}
    most = [max(int(rows[j][k, 1]) for j in ids)
            for k in range(FA_FLEET_STEPS)]
    want_exec = sum(4 * math.ceil(m / 4) for m in most)
    if executed != want_exec:
        raise AssertionError(f"fleet amr: {executed} iterations executed, "
                             f"the most a lane took needs {want_exec}")
    res.update(lanes=FA_LANES, batch_lanes=batch.B, blocks=tmpl.grid.nb,
               capacity=tmpl._cap, wall_s=wall, loop_s=loop_s,
               ms_per_step=loop_s / FA_FLEET_STEPS * 1e3,
               dispatches=disp, executed=executed,
               launches_per_dispatch={k: counts[k] / disp
                                      for k in FA_PER_ITER},
               most_iters=most)
    log(f"  {FA_LANES} lanes of {tmpl.grid.nb} blocks (capacity {tmpl._cap}) "
        f"in a batch of {batch.B}, CFL {cfls[0]:.2f}-{cfls[-1]:.2f}, "
        f"{FA_FLEET_STEPS} steps in {disp} dispatches: {wall:.2f} s with "
        f"set-up, {loop_s:.3f} s after assembly = "
        f"{res['ms_per_step']:.1f} ms a step of all lanes (dispatches, "
        f"fan-out, journal snapshots); {executed} iterations "
        f"executed (the most a lane took a step: {most}); launches a "
        f"dispatch {res['launches_per_dispatch']}")

    # -- one lane: the same launches an executed iteration ------------------
    fa.reset_launches()
    adv = FB.build_fleet_advance(tmpl, kind="amr_tgv")
    c1 = FB.stack_carries([FB.init_amr_carry(tmpl)], [FA_FLEET_STEPS])
    c1, _ = adv(c1, np.full((1, SCAN_K), cfls[0]), None)
    disp1 = 1
    torch.cuda.synchronize()
    ex1 = fa.iterations["executed"]
    one = dict(fa.launches)
    for kname, per in FA_PER_ITER.items():
        if on_card and one[kname] != per * ex1:
            raise AssertionError(f"fleet amr, one lane: {kname} "
                                 f"{one[kname]} for {ex1} iterations")
    res["one_lane"] = dict(executed=ex1, launches_per_dispatch={
        k: one[k] / disp1 for k in FA_PER_ITER})
    log(f"  one lane: {ex1} iterations executed, launches a dispatch "
        f"{res['one_lane']['launches_per_dispatch']}: the same launches an "
        f"iteration at {FA_LANES} lanes as at 1")

    # -- each lane against the port's solo fused forest step, over the
    # first dispatch: the lane's state there is its journaled snapshot --
    snaps = {r["job_id"]: r["carry"] for r in srv.journal.records()
             if r["type"] == "snapshot" and r["step"] == SCAN_K}
    step = make_amr_tgv_step(tmpl)
    worst = [0.0, 0.0]
    t0 = time.perf_counter()
    solo = list(enumerate(zip(ids, cfls)))[::FA_SOLO_EVERY]
    for lane, (jid, cfl) in solo:
        carry = FB.init_amr_carry(tmpl)
        for k in range(SCAN_K):
            carry, _ = step(carry, torch.tensor(cfl, device=tmpl.device))
        ln = {k: np.asarray(v, np.float64) for k, v in snaps[jid].items()}
        dv = float(torch.max(torch.abs(carry["vel"].double().cpu()
                                       - torch.from_numpy(ln["vel"]))))
        dt_rel = max(abs(float(carry[k]) - float(ln[k])) / abs(float(ln[k]))
                     for k in ("time", "dt"))
        if not (dv <= FA_VEL_ATOL and dt_rel <= FA_TIME_RTOL):
            raise AssertionError(f"fleet amr lane {lane}: vel {dv:.3e}, "
                                 f"time/dt rel {dt_rel:.3e} off its solo run")
        worst = [max(worst[0], dv), max(worst[1], dt_rel)]
    torch.cuda.synchronize()
    res["solo_err"] = worst
    res["solo_s"] = time.perf_counter() - t0
    log(f"  lanes {[lane for lane, _ in solo]} against their solo fused "
        f"runs over the first dispatch ({SCAN_K} steps each, "
        f"{res['solo_s']:.2f} s): vel {worst[0]:.3e}, time/dt rel "
        f"{worst[1]:.3e}")

    # -- the stage kernels with a scalar row a lane --------------------------
    res["kernels"] = fleet_lane_kernels(tmpl, FA_LANES, bw, fp32_flops)

    # -- fleet.lane_nan at lane FA_NAN_LANE ---------------------------------
    faults.arm("fleet.lane_nan", FA_NAN_LANE, 1)
    try:
        nsrv, nids, _ = _fleet_drain(specs, os.path.join(out, "nan"),
                                     snap_every=FA_FLEET_SNAP)
    finally:
        faults.clear()
    for lane, (a, b) in enumerate(zip(ids, nids)):
        if lane == FA_NAN_LANE:
            continue
        ca, cb = srv._jobs[a].batch.carry, nsrv._jobs[b].batch.carry
        if not all(torch.equal(ca[k][lane], cb[k][lane]) for k in ca):
            raise AssertionError(f"fleet amr: lane {lane} moved under lane "
                                 f"{FA_NAN_LANE}'s fault")
    st = nsrv.poll(nids[FA_NAN_LANE])
    rb = nsrv.health()["rollbacks"]
    if st["status"] != "done" or rb != 1:
        raise AssertionError(f"fleet amr: faulted lane {st}, rollbacks {rb}")
    log(f"  fleet.lane_nan at lane {FA_NAN_LANE}: the other lanes "
        f"torch.equal the unfaulted run, lane {FA_NAN_LANE} rolled back "
        f"{rb} time and done")
    del nsrv
    torch.cuda.empty_cache()

    # -- a server.crash drill, recovered in this process --------------------
    class _Crash(Exception):
        pass

    cdir = os.path.join(out, "crash")
    faults.arm("server.crash", 1, 1)
    try:
        with mock.patch.object(S.os, "_exit", side_effect=_Crash):
            csrv = S.FleetServer(workdir=cdir, snap_every=FA_FLEET_SNAP)
            for i, sp in enumerate(specs):
                csrv.submit(f"tenant-{i}", dict(sp))
            crashed = False
            try:
                csrv.drain()
            except _Crash:
                crashed = True
    finally:
        faults.clear()
    if not crashed:
        raise AssertionError("fleet amr: the crash drill did not crash")
    del csrv
    # the crashed journal again, for the bf16 lanes below
    shutil.copytree(cdir, cdir + "_bf16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rsrv = S.FleetServer(workdir=cdir, snap_every=FA_FLEET_SNAP)
    stats = rsrv.recover()
    rsrv.drain()
    torch.cuda.synchronize()
    same = all(rsrv._jobs[j].qoi_bytes() == srv._jobs[j].qoi_bytes()
               for j in ids)
    if stats["resumed"] != FA_LANES or not same:
        raise AssertionError(f"fleet amr crash drill: {stats}, QoI bytes "
                             f"equal {same}")
    log(f"  server.crash at dispatch 1: recover() {stats}, every job's QoI "
        "bytes equal to the uncrashed run")
    del rsrv
    torch.cuda.empty_cache()

    # -- the lanes at bf16 storage: the crashed journal recovered by a bf16
    # server, its lanes resuming from the f32 snapshots at step K (a warm
    # pressure; a cold bf16 first solve runs hundreds of iterations) ----
    with _env(CUP3D_KRYLOV_DTYPE="bf16"):
        bsrv = S.FleetServer(workdir=cdir + "_bf16",
                             snap_every=FA_FLEET_SNAP)
        bstats = bsrv.recover()
        fa.reset_launches()
        t0 = time.perf_counter()
        bsrv.drain()
        torch.cuda.synchronize()
        bwall = time.perf_counter() - t0
    if (bstats["resumed"] != FA_LANES
            or bsrv.jobs_by_status() != {"done": FA_LANES}):
        raise AssertionError(f"fleet amr bf16: {bstats}, "
                             f"{bsrv.jobs_by_status()}")
    bdv = 0.0
    for jid in ids:
        ln = _lane_np(bsrv, jid)
        if not np.isfinite(ln["vel"]).all():
            raise AssertionError("fleet amr bf16: non-finite velocity")
        bdv = max(bdv, float(np.max(np.abs(ln["vel"]
                                           - _lane_np(srv, jid)["vel"]))))
    bdisp = int(bsrv._jobs[ids[0]].batch.dispatches)
    res["bf16"] = dict(wall_s=bwall, executed=fa.iterations["executed"],
                       dispatches=bdisp, launches=dict(fa.launches_bf16),
                       vel_vs_f32=bdv)
    for kname, per in FA_PER_ITER.items():
        if on_card and fa.launches_bf16[kname] != (
                per * fa.iterations["executed"]):
            raise AssertionError(f"fleet amr bf16: {kname} launches")
    log(f"  bf16 storage (the crashed journal resumed by a bf16 server, "
        f"steps {SCAN_K}-{FA_FLEET_STEPS}): every lane done and finite, "
        f"{bwall:.2f} s, {fa.iterations['executed']} iterations executed, "
        f"max |vel - f32 lanes| {bdv:.3e}; bf16 launches "
        f"{dict(fa.launches_bf16)}")
    del bsrv, srv
    torch.cuda.empty_cache()
    return res


KERNELS = (
    # name, TPU kernel body it replaces, the port's source
    ("update", "cup3d_tpu/ops/fused_bicgstab.py:173", "fused_bicgstab.cu"),
    ("getz_two", "cup3d_tpu/ops/fused_bicgstab.py:185", "fused_bicgstab.cu"),
    ("getz_tile", "cup3d_tpu/ops/fused_bicgstab.py:190", "fused_bicgstab.cu"),
    ("lap", "cup3d_tpu/ops/fused_bicgstab.py:195", "fused_bicgstab.cu"),
    ("axpy", "cup3d_tpu/ops/fused_bicgstab.py:203", "fused_bicgstab.cu"),
    ("finish", "cup3d_tpu/ops/fused_bicgstab.py:209", "fused_bicgstab.cu"),
    ("getz_cg", "cup3d_tpu/ops/getz_pallas.py:42", "getz_cg.cu"),
    ("amr_update", "cup3d_tpu/ops/fused_amr_bicgstab.py:183",
     "fused_bicgstab.cu"),
    ("amr_getz_two", "cup3d_tpu/ops/fused_amr_bicgstab.py:195",
     "fused_bicgstab.cu"),
    ("amr_getz_tile", "cup3d_tpu/ops/fused_amr_bicgstab.py:202",
     "fused_bicgstab.cu"),
    ("amr_lap", "cup3d_tpu/ops/fused_amr_bicgstab.py:208",
     "fused_bicgstab.cu"),
    ("amr_axpy", "cup3d_tpu/ops/fused_amr_bicgstab.py:217",
     "fused_bicgstab.cu"),
    ("amr_finish", "cup3d_tpu/ops/fused_amr_bicgstab.py:224",
     "fused_bicgstab.cu"),
    ("ring_shift", "cup3d_tpu/parallel/ring.py:89", "ring.cu"),
    # no Pallas kernel: the lax.scan of the JAX device midline
    ("frenet", "cup3d_tpu/models/fish/device_midline.py:158", "frenet.cu"),
)
# kernels redesigned after their port, by the PR of the redesign
REDESIGNED = {"getz_two": 6, "ring_shift": 6, "getz_tile": 7,
              "amr_getz_tile": 7, "getz_cg": 7, "amr_getz_two": 8,
              "lap": 16}


# ---------------------------------------------------------------------------
# phase 36 and the forest window: device-time attribution on the drivers
# ---------------------------------------------------------------------------

PROFILE_FISH_STEPS = 6      # config #2 steps in phase 36
PROFILE_AT, PROFILE_LEN = 2, 2  # CUP3D_PROFILE=once:2, CUP3D_PROFILE_STEPS=2
PROFILE_AGREE = 0.25        # a section against launches x phase 3's us
PROFILE_INVARIANT = 1e-9    # sum(sections) + other == total, relative
#: each BiCGSTAB section's port kernels (their launch counter keys)
SECTION_KERNELS = {"bicgstab.update": ("update",),
                   "bicgstab.getz_lap": ("getz_two", "getz_tile", "lap"),
                   "bicgstab.finish": ("axpy", "finish")}
FIXTURE_OPS = 120           # device ops kept in the trimmed capture


def _telemetry_errors(snap: dict) -> dict:
    return {k: snap.get(k, 0) for k in (
        "profile.capture_errors", "profile.parse_errors",
        "profile.empty_captures")}


def _check_attribution(tag: str, attr, before: dict, after: dict) -> None:
    """The window's attribution: no telemetry failure, the three
    BiCGSTAB sections above zero, the sum invariant; logs what each
    section caught (cub's scan kernels reach megaloop.body by the JAX
    package's fragments: this line shows any such catch)."""
    errs = {k: after[k] - before[k] for k in before}
    if any(errs.values()):
        raise AssertionError(f"{tag}: telemetry failures {errs}")
    if attr is None:
        raise AssertionError(f"{tag}: the window produced no attribution")
    total = sum(attr.sections.values()) + attr.other_ms
    if abs(total - attr.total_ms) > PROFILE_INVARIANT * attr.total_ms:
        raise AssertionError(f"{tag}: sections + other {total} != total "
                             f"{attr.total_ms}")
    missing = [k for k in SECTION_KERNELS if not attr.sections.get(k, 0) > 0]
    if missing:
        raise AssertionError(f"{tag}: no device time in {missing}: "
                             f"{attr.sections}")
    log(f"  {tag}: device total {attr.total_ms:.3f} ms over "
        f"{len(attr.events)} ops; sections " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(attr.sections.items()))
        + f", other {attr.other_ms:.3f} ms")
    for sec, names in sorted(attr.kernels_by_section().items()):
        top = sorted(names.items(), key=lambda kv: -kv[1])
        log(f"    {sec}: {len(names)} kernel names, "
            f"{sum(names.values())} ops: " + "; ".join(
                f"{n[:60]} x{c}" for n, c in top[:6]))


def forest_window(d) -> dict:
    """Two more steps of phase 9's config #3 run in one programmatic
    capture window (``CONTROLLER.capture()``): B8, B9 and B11-B13 in the
    three BiCGSTAB sections."""
    from cup3d_tpu_torch.obs import metrics as om
    from cup3d_tpu_torch.obs import profile as op

    before = _telemetry_errors(om.snapshot())
    t0 = time.perf_counter()
    with op.CONTROLLER.capture("forest_window"):
        for _ in range(2):
            d.advance(d.calc_max_timestep())
    attr = op.CONTROLLER.last_attribution
    _check_attribution("forest window, 2 steps", attr, before,
                       _telemetry_errors(om.snapshot()))
    log(f"  (forest window {time.perf_counter() - t0:.1f} s with its "
        f"capture and parse)")
    return dict(total_ms=attr.total_ms, sections=dict(attr.sections),
                other_ms=attr.other_ms)


def _trim_capture(path: str, out: str, n_ops: int = FIXTURE_OPS) -> int:
    """Cut a Kineto capture to ``n_ops`` consecutive device ops from the
    first ``k_update`` on, their host launches, the record_function
    ranges and device-side ranges around them and the metadata: a test
    fixture of the card's own format.  Returns the events kept."""
    import gzip

    from cup3d_tpu_torch.obs import profile as op

    trace = op.load_chrome_trace(path)
    ev = trace["traceEvents"]
    ops = sorted((e for e in ev if str(e.get("cat", "")).lower()
                  in op.KINETO_DEVICE_CATS), key=lambda e: e["ts"])
    first = next(i for i, e in enumerate(ops) if "k_update" in e["name"])
    keep = ops[first:first + n_ops]
    corr = {e.get("args", {}).get("correlation") for e in keep}
    launches = [e for e in ev if e.get("ph") == "X"
                and str(e.get("cat", "")).lower() not in op.KINETO_DEVICE_CATS
                and isinstance(e.get("args"), dict)
                and e["args"].get("correlation") in corr]
    t_lo = min([e["ts"] for e in launches + keep])
    t_hi = max([e["ts"] + e.get("dur", 0) for e in launches + keep])
    ranges = [e for e in ev if e.get("cat") in ("user_annotation",
                                                "gpu_user_annotation")
              and e["ts"] <= t_hi and e["ts"] + e.get("dur", 0) >= t_lo]
    meta = [e for e in ev if e.get("ph") == "M"]
    kept = meta + ranges + launches + keep
    with open(out, "wb") as raw:
        with gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                           mtime=0) as f:
            f.write(json.dumps({"schemaVersion": trace.get("schemaVersion"),
                                "traceEvents": kept}).encode())
    return len(kept)


def profile_phase(main_us: dict, fish_us: dict) -> dict:
    """Phase 36 (see the module docstring).  ``main_us``: phase 3's
    device us a launch by profile at N_MAIN^3, ``fish_us`` phase 14's at
    N_FISH^3 (back to back: their vectors stay in the 50 MB L2 there, the
    solve's working set does not, so they are printed, not held)."""
    import urllib.request

    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.obs import costs, export
    from cup3d_tpu_torch.obs import metrics as om
    from cup3d_tpu_torch.obs import profile as op
    from cup3d_tpu_torch.obs import trace as ot
    from cup3d_tpu_torch.ops import fused_bicgstab as fb

    out = _fresh_dir(os.path.join(OUT_DIR, "profile36"))
    ot.TRACE.configure(enabled=True, directory=out, xla_annotate=True)
    ex = export.ensure_exporter(port=0)
    if ex is None:
        raise AssertionError("phase 36: the exporter did not start")
    with _env(CUP3D_PROFILE=f"once:{PROFILE_AT}",
              CUP3D_PROFILE_STEPS=str(PROFILE_LEN),
              CUP3D_PROFILE_DIR=None, CUP3D_TRACE="1", CUP3D_TRACE_XLA="1"):
        ctl = op.CONTROLLER = op.CaptureController.from_env()
    # the launch counters at the window's open and close
    marks = []
    start, stop = ctl._start, ctl._stop

    def counts():
        c = dict(fb.launches)
        c["lap"] += fb.residual_launches["lap"]
        return c

    def start_marked(logdir):
        start(logdir)
        marks.append(counts())

    def stop_marked():
        marks.append(counts())
        stop()

    ctl._start, ctl._stop = start_marked, stop_marked
    before = _telemetry_errors(om.snapshot())
    try:
        d = build_driver(_bench_fish_argv(out, PROFILE_FISH_STEPS, 0))
        d.init()
        fb.reset_launches()
        t0 = time.perf_counter()
        d.simulate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attr = ctl.last_attribution
        _check_attribution(f"config #2 window (steps {PROFILE_AT}-"
                           f"{PROFILE_AT + PROFILE_LEN - 1})", attr, before,
                           _telemetry_errors(om.snapshot()))
        if ctl.windows != 1 or len(marks) != 2:
            raise AssertionError(f"phase 36: {ctl.windows} windows, "
                                 f"{len(marks)} counter marks")
        log(f"  {PROFILE_FISH_STEPS} steps in {wall:.2f} s with the window "
            f"(capture, export, parse); iterations "
            f"{[int(r['iters']) for r in d.step_log]}")
        # each section against the window's launches times phase 3's
        # device us a launch, scaled from N_MAIN^3 to the window's cells
        # (the kernels are bandwidth-bound there: time goes with bytes)
        delta = {k: marks[1][k] - marks[0][k] for k in marks[0]}
        scale = (N_FISH / N_MAIN) ** 3
        agree = {}
        for sec, kernels in SECTION_KERNELS.items():
            ks = [k for k in kernels if delta[k]]
            if any(main_us.get(k) is None for k in ks):
                raise AssertionError(f"phase 36: {sec}: a kernel without "
                                     f"its profile time {main_us}")
            want = sum(delta[k] * main_us[k] * scale for k in ks) / 1e3
            warm = sum(delta[k] * (fish_us.get(k) or math.nan)
                       for k in ks) / 1e3
            got = attr.sections[sec]
            agree[sec] = dict(ms=got, want_ms=want, warm_ms=warm,
                              launches={k: delta[k] for k in ks},
                              rel=(got - want) / want)
            log(f"  {sec}: {got:.3f} ms in the window against {want:.3f} "
                f"ms = launches {agree[sec]['launches']} x phase 3's "
                f"profile us x {scale:.4f} ({(got - want) / want:+.1%}); "
                f"x phase 14's back-to-back us {warm:.3f} ms")
            if not abs(got - want) <= PROFILE_AGREE * want:
                raise AssertionError(f"phase 36: {sec} {got} ms against "
                                     f"{want} ms from the launches")
        # the kind="device" record and the pid-2 track of the trace
        ot.TRACE.flush()
        with open(ot.TRACE.jsonl_path) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        dev = [r for r in recs if r.get("kind") == "device"]
        if len(dev) != 1 or ot.validate_step_record(dev[0]):
            raise AssertionError(f"phase 36: device records {dev}")
        ot.TRACE.export_chrome()
        with open(ot.TRACE.perfetto_path) as f:
            pid2 = [e for e in json.load(f)["traceEvents"]
                    if e.get("pid") == op.DEVICE_PID and e.get("ph") == "X"]
        if len(pid2) != len(attr.events) or not any(
                "k_update" in e["name"] for e in pid2):
            raise AssertionError(f"phase 36: {len(pid2)} pid-2 events for "
                                 f"{len(attr.events)} device ops")
        # the exporter over loopback
        def get(path):
            with urllib.request.urlopen(ex.url + path, timeout=30) as r:
                return r.read().decode()

        scraped = export.parse_prometheus_text(get("/metrics"))
        for sec, ms in list(attr.sections.items()) + [("other",
                                                       attr.other_ms)]:
            key = ("cup3d_profile_device_ms", frozenset({("section", sec)}))
            if scraped.get(key) != ms:
                raise AssertionError(f"phase 36: /metrics {sec} "
                                     f"{scraped.get(key)} != {ms}")
        health = json.loads(get("/health"))
        mine = [f for f in health["flight_recorders"]
                if f["directory"] == out]
        if health["profile"]["windows"] != 1 or not (
                mine and mine[0]["armed"]):
            raise AssertionError(f"phase 36: /health profile "
                                 f"{health['profile']}, recorders {mine}")
        fed = json.loads(get("/federate"))
        if fed.get("schema") != 1:
            raise AssertionError(f"phase 36: /federate schema "
                                 f"{fed.get('schema')}")
        pk = costs.device_peaks()
        if pk.nominal or "H100" not in pk.kind:
            raise AssertionError(f"phase 36: device peaks {pk}")
        marks_mem = costs.memory_watermarks()
        if not marks_mem.get("cuda:0", {}).get("peak_bytes_in_use", 0) > 0:
            raise AssertionError(f"phase 36: watermarks {marks_mem}")
        log(f"  device record {dev[0]['device_sections']}; pid-2 track "
            f"{len(pid2)} events; /metrics, /health (windows 1, recorder "
            f"armed), /federate (schema 1) on {ex.url}; peaks {pk.kind} "
            f"({pk.hbm_bytes_per_s:.3g} B/s, {pk.f32_flops:.3g} f32 "
            f"FLOP/s); cuda:0 peak "
            f"{marks_mem['cuda:0']['peak_bytes_in_use'] / 1e9:.2f} GB")
        cap = op.find_trace_files(ctl.directory)[-1]
        n = _trim_capture(cap, os.path.join(OUT_DIR,
                                            "torch_profile_h100.trace.json.gz"))
        log(f"  capture {cap} ({os.path.getsize(cap) / 1e6:.1f} MB gz); "
            f"trimmed to {n} events")
        return dict(total_ms=attr.total_ms, sections=dict(attr.sections),
                    other_ms=attr.other_ms, agree=agree, wall_s=wall,
                    ops=len(attr.events))
    finally:
        ex.stop()
        export.EXPORTER = None
        ot.TRACE.configure(enabled=False, xla_annotate=False)


# ---------------------------------------------------------------------------
# phase 37: the compiled store and the background compile service
# ---------------------------------------------------------------------------

AOT_N = 32              # the uniform kernels' grid in phase 37 (T = 64)
AOT_FOREST_ARGV = ("-bpdx 2 -bpdy 2 -bpdz 2 -levelMax 2 -levelStart 1 "
                   "-extent 6.283185307179586 -initCond taylorGreen "
                   "-poissonSolver iterative -tend 0 -nsteps 2")
AOT_TGV = dict(kind="tgv", n=32, nsteps=2, cfl=0.3)
AOT_TGV_LANES = 4
AOT_AMR_LANES = 2
AOT_AMR_STEPS = 2
#: compile.service_die's jobs: a small forest whose cold tables are the
#: service's build
AOT_DIE_AMR = dict(kind="amr_tgv", bpd=4, levelMax=2, levelStart=0,
                   nsteps=1)
#: the dispatch-thread probe: warm tgv lanes that run through a cold
#: amr_tgv signature's background table build (a uniform level-1 forest
#: at bpd 8: 4,096 blocks, no adaptation)
AOT_PROBE_TGV = dict(AOT_TGV, nsteps=96)
AOT_PROBE_AMR = dict(kind="amr_tgv", bpd=8, levelMax=2, levelStart=1,
                     nsteps=8)
AOT_PROBE_AT = 4        # the dispatch round the amr_tgv job arrives at
AOT_PHASE_BUDGET_S = 120.0
AOT_CHILD = """
import json, os, sys, time
sys.path.insert(1, {repo!r})
import torch
import cup3d_tpu_torch
from cup3d_tpu_torch.obs import metrics as M
from cup3d_tpu_torch.ops import cuda_lib
t0 = time.perf_counter()
lib = cuda_lib.load()
load_s = time.perf_counter() - t0
if {run!r}:
    import chip_smoke
    torch.save(chip_smoke.aot_kernel_outputs(), {out!r})
snap = M.snapshot()
print(json.dumps(dict(
    package=os.path.dirname(cup3d_tpu_torch.__file__),
    build_s=lib.build_s, load_s=load_s, origins=lib.origins,
    nvcc_builds=int(snap.get("kernels.nvcc_builds", 0)),
    store_hits=int(snap.get("kernels.store_hits", 0)))))
"""


def _outputs(res) -> list:
    """A wrapper's tensor outputs, flattened (tuples and dicts in order)."""
    if isinstance(res, torch.Tensor):
        return [res]
    if isinstance(res, dict):
        return [v for k in sorted(res) for v in _outputs(res[k])]
    return [t for r in res for t in _outputs(r)]


def aot_kernel_outputs(check_plain: bool = False) -> dict:
    """Every kernel (B1-B14 and the Frenet kernel) launched once on seeded
    inputs at small shapes (the uniform stages at 32^3, the forest's on a
    69-block bucketed forest, B14 on 4 shards): {name: [outputs on the
    host]}.  With ``check_plain`` each is held to its plain version on the
    same inputs (this script's tolerances; B4's Aw and B14 bitwise)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.grid.uniform import UniformGrid
    from cup3d_tpu_torch.models.fish import device_midline as dm
    from cup3d_tpu_torch.ops import amr_ops, getz_cg
    from cup3d_tpu_torch.ops import fused_amr_bicgstab as fa
    from cup3d_tpu_torch.ops import fused_bicgstab as fb
    from cup3d_tpu_torch.parallel import ring

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    T = (AOT_N // 8) ** 3
    h2 = (2 * math.pi / AOT_N) ** 2
    outs, calls = {}, {}

    def vec(n=T):
        return torch.randn((n, 8, 8, 8), generator=gen, device=dev)

    def row(*vals):
        return fb._scalars(*(torch.tensor(v, device=dev) for v in vals))

    def run(name, fn, plain, rtol, first_only=True):
        got = _outputs(fn())
        outs[name] = [t.detach().cpu().clone() for t in got]
        if check_plain:
            want = _outputs(plain())
            for i, (g, w) in enumerate(zip(got, want)):
                if first_only and i:
                    break
                if rtol == 0:
                    check_bitwise(f"aot {name}", g, w)
                else:
                    check_close(f"aot {name}", g, w, rtol)
        calls[name] = fn

    r, p, v, rh = vec(), vec(), vec(), vec()
    sc = row(0.7, 1.3, 0.0)
    run("update", lambda: fb.update(r, p.clone(), v, rh.clone(), sc),
        lambda: fb.update(r, p.clone(), v, rh.clone(), sc, kernels=False),
        VEC_RTOL)
    w = vec()
    aux = torch.randn((8, T), generator=gen, device=dev)
    aux[7] = 0.0
    run("getz_two", lambda: fb.getz_two(w, aux, h2),
        lambda: fb.getz_two(w, aux, h2, kernels=False), GETZ_RTOL)
    run("getz_tile", lambda: fb.getz_tile(w, h2),
        lambda: fb.getz_tile(w, h2, kernels=False), GETZ_RTOL)
    a = vec()
    geom = fb.LapGeom(UniformGrid((AOT_N,) * 3, (2 * math.pi,) * 3))
    run("lap", lambda: fb.lap(w, a, 1.0 / h2, geom),
        lambda: fb.lap(w, a, 1.0 / h2, geom, kernels=False), 0)
    sc1 = row(0.37)
    run("axpy", lambda: fb.axpy(r, v, sc1),
        lambda: fb.axpy(r, v, sc1, kernels=False), VEC_RTOL)
    x, y, z, s, t, rr = (vec() for _ in range(6))
    sc2 = row(0.37, 1.21)
    run("finish", lambda: fb.finish(x.clone(), y, z, s.clone(), t, rr, sc2),
        lambda: fb.finish(x.clone(), y, z, s.clone(), t, rr, sc2,
                          kernels=False), VEC_RTOL)
    bt = torch.randn((8, 8, 8, T), generator=gen, device=dev)
    run("getz_cg", lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS, 0.0),
        lambda: getz_cg.cg_tiles_lanes(bt, CG_ITERS, 0.0, kernels=False),
        GETZ_RTOL)

    out = os.path.join(OUT_DIR, "aot_forest")
    os.makedirs(out, exist_ok=True)
    d = build_driver(f"{AOT_FOREST_ARGV} -verbose 0 -path4serialization "
                     f"{out}".split())
    g, n, nb, fvec = _forest_vecs(d, gen)
    h = g.h_column(torch.float32, dev).reshape(n)
    fh2 = (h * h).contiguous()
    vol = d._vol.reshape(n).float().contiguous()
    r, p, v, rh = fvec(), fvec(), fvec(), fvec()
    run("amr_update",
        lambda: fa.update(r, p.clone(), v, rh.clone(), vol, sc),
        lambda: fa.update(r, p.clone(), v, rh.clone(), vol, sc,
                          kernels=False), VEC_RTOL)
    w = fvec()
    zc = torch.randn(n, generator=gen, device=dev)
    zc[nb:] = 0.0
    zf = zc[:, None, None, None].expand(n, 8, 8, 8)
    azf = amr_ops.laplacian_blocks(g, zf, d._tab1, d._ftab).contiguous()
    run("amr_getz_two", lambda: fa.getz_two(w, azf, zc, fh2),
        lambda: fa.getz_two(w, azf, zc, fh2, kernels=False), GETZ_RTOL)
    run("amr_getz_tile", lambda: fa.getz_tile(w, fh2),
        lambda: fa.getz_tile(w, fh2, kernels=False), GETZ_RTOL)
    a = fvec()
    lab = d._tab1.assemble_scalar(w, 8).contiguous()
    corr = d._ftab.apply(torch.zeros_like(w), amr_ops.face_fluxes(
        lab, 1, 8, (1.0 / h)[:, None, None, None])).contiguous()
    run("amr_lap", lambda: fa.lap(lab, corr, a, 1.0 / fh2),
        lambda: fa.lap(lab, corr, a, 1.0 / fh2, kernels=False), VEC_RTOL)
    run("amr_axpy", lambda: fa.axpy(r, v, vol, sc1),
        lambda: fa.axpy(r, v, vol, sc1, kernels=False), VEC_RTOL)
    x, y, z, s, t, rr = (fvec() for _ in range(6))
    run("amr_finish",
        lambda: fa.finish(x.clone(), y, z, s.clone(), t, rr, sc2),
        lambda: fa.finish(x.clone(), y, z, s.clone(), t, rr, sc2,
                          kernels=False), VEC_RTOL)
    del d
    xs = torch.randn((SHARDS, 16, 512), generator=gen, device=dev)
    run("ring_shift", lambda: ring.ring_shift_kernel(xs, 1),
        lambda: ring.ring_shift_plain(xs, 1), 0)
    m = torch.arange(64, device=dev, dtype=torch.float32)
    rs = m * (0.4 / 63)
    curv = torch.sin(2 * math.pi * rs / 0.4) * 3.0
    dcurv = torch.cos(2 * math.pi * rs / 0.4)
    run("frenet", lambda: dm._frenet_scan_dev(rs, curv, dcurv),
        lambda: dm._frenet_scan_dev(rs, curv, dcurv, kernels=False),
        FRENET_RTOL, first_only=False)
    torch.cuda.synchronize()
    return outs


def _aot_child(copy: str, store: str, tag: str, run: bool) -> dict:
    """One fresh process on a fresh copy of the package (no csrc/build/)
    and the store: it loads the kernels (nvcc or the store) and, with
    ``run``, launches each once on phase 37's inputs and saves the
    outputs (the forest's lab tables by numpy: the copy has no g++
    build either)."""
    out = os.path.abspath(os.path.join(OUT_DIR, f"aot_{tag}.pt"))
    script = AOT_CHILD.format(repo=os.path.abspath("."), out=out, run=run)
    env = dict(os.environ, CUP3D_AOT_STORE=os.path.abspath(store),
               CUP3D_FUSED="1", CUP3D_NO_NATIVE="1")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"aot {tag} child failed:\n{res.stderr[-3000:]}")
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    if not rep["package"].startswith(os.path.abspath(copy)):
        raise AssertionError(f"aot {tag} child imported {rep['package']}")
    rep["wall_s"] = wall
    rep["outputs"] = torch.load(out) if run else None
    return rep


def _fresh_copy(dst: str) -> str:
    """The package's sources without any build: a fresh checkout's."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree("cup3d_tpu_torch", os.path.join(dst, "cup3d_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return dst


def _aot_fleet(specs, out: str, **kw):
    """A fresh server drains ``specs``; returns (server, job ids, wall s,
    {kind: seconds from the server's construction to its first job's
    first dispatch}).  The server's compile service, if any, is closed
    (its helper process stopped)."""
    from cup3d_tpu_torch.fleet.server import DONE, FleetServer
    from cup3d_tpu_torch.obs import trace as OT

    t0 = time.perf_counter()
    c0 = OT.now()
    srv = FleetServer(workdir=out, **kw)
    ids = [srv.submit(f"t{i}", dict(sp)) for i, sp in enumerate(specs)]
    try:
        srv.drain()
    finally:
        if srv._aot_service is not None:
            srv._aot_service.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [j for j in ids if srv._jobs[j].status != DONE]
    if bad:
        raise AssertionError(f"aot fleet: jobs not done: {bad}")
    first = {}
    for j, sp in zip(ids, specs):
        t = srv._jobs[j].event_time("dispatched") - c0
        first[sp["kind"]] = min(first.get(sp["kind"], t), t)
    return srv, ids, wall, first


def _tick_ms(srv, done, inject=None):
    """Wrap ``srv._schedule`` (called once a dispatch round) to stamp each
    round; ``inject`` = (round, spec) submits one more job at the start of
    that round, once the lanes already there are dispatching, and cancels
    it once ``done()`` (its background build finished: its own run is not
    what is measured).  Returns the stamps list."""
    stamps = []
    orig = srv._schedule
    late = []

    def sched():
        if inject is not None and len(stamps) == inject[0]:
            late.append(srv.submit("late", dict(inject[1])))
        if late and done() and srv.poll(late[0])["status"] == "queued":
            srv.cancel(late[0])
        stamps.append((time.perf_counter(),
                       any(b.active() for b in srv.batches)))
        return orig()

    srv._schedule = sched
    return stamps


def _round_ms(stamps, K: int, window=None) -> tuple:
    """(ms a step, rounds) of the dispatch rounds between ``stamps`` that
    started with lanes to dispatch: the median round over K without
    ``window``; with ``window`` = (t0, t1) (a background build) the rounds
    that overlap it, from the start of the first to the end of the last,
    over their steps (a round that spans the whole build counts as one)."""
    rounds = [(a[0], b[0]) for a, b in zip(stamps, stamps[1:]) if a[1]]
    if window is None:
        dts = [(b - a) * 1e3 / K for a, b in rounds]
        return (statistics.median(dts) if dts else None), len(dts)
    hit = [(a, b) for a, b in rounds if b > window[0] and a < window[1]]
    if not hit:
        return None, 0
    return (hit[-1][1] - hit[0][0]) * 1e3 / (len(hit) * K), len(hit)


def aot_phase() -> dict:
    """Phase 37 (module doc)."""
    from cup3d_tpu_torch.__main__ import build_driver
    from cup3d_tpu_torch.aot import store as aot_store
    from cup3d_tpu_torch.obs import metrics as M
    from cup3d_tpu_torch.obs import trace as OT
    from cup3d_tpu_torch.resilience import faults
    from cup3d_tpu_torch.sim.megaloop import DEFAULT_SCAN_K

    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "aot")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {}

    # -- kernels: cold (nvcc into an empty store), then warm (the store) ---
    kstore = os.path.join(root, "kstore")
    cold = _aot_child(_fresh_copy(os.path.join(root, "cold")), kstore,
                      "cold", run=False)
    warm = _aot_child(_fresh_copy(os.path.join(root, "warm")), kstore,
                      "warm", run=True)
    n_src = len(cold["origins"])
    if cold["nvcc_builds"] != n_src or set(cold["origins"].values()) != {
            "nvcc"}:
        raise AssertionError(f"aot cold: {cold['origins']}")
    if warm["nvcc_builds"] != 0 or set(warm["origins"].values()) != {
            "store"}:
        raise AssertionError(f"aot warm ran nvcc: {warm['origins']}")
    mine = aot_kernel_outputs(check_plain=True)
    for name, want in mine.items():
        got = warm["outputs"][name]
        if len(got) != len(want) or not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"aot warm: {name} differs from this "
                                 "process's nvcc build")
    log(f"  kernels: cold copy {cold['nvcc_builds']} nvcc builds in "
        f"{cold['build_s']:.2f} s (load {cold['load_s']:.2f} s, process "
        f"{cold['wall_s']:.1f} s); warm copy 0 nvcc, {warm['store_hits']} "
        f"libraries from the store, load {warm['load_s']:.3f} s (process "
        f"{warm['wall_s']:.1f} s); its {len(mine)} kernels' outputs bitwise "
        "this process's nvcc build, held to their plain versions")
    res["kernels"] = dict(
        cold_nvcc_s=cold["build_s"], cold_load_s=cold["load_s"],
        warm_load_s=warm["load_s"], warm_nvcc_builds=warm["nvcc_builds"],
        cold_wall_s=cold["wall_s"], warm_wall_s=warm["wall_s"],
        kernels=sorted(mine))

    # -- tables: config #3 set up cold, then on the warm store -------------
    tstore = os.path.join(root, "tstore")
    argv = (f"{AMR_ARGV} -verbose 0 -path4serialization "
            f"{os.path.join(root, 'amr')}").split()
    drivers, setup = [], []
    with _env(CUP3D_AOT_STORE=tstore, CUP3D_FUSED="1"):
        for _ in range(2):
            t0 = time.perf_counter()
            d = build_driver(argv)
            d.init()
            torch.cuda.synchronize()
            setup.append(time.perf_counter() - t0)
            d.adapt_enabled = False
            drivers.append(d)
        d1, d2 = drivers
        if not aot_store.tensors_equal(d1._geo, d2._geo):
            raise AssertionError("aot tables: the loaded tables differ")
        if d2.table_build_s:
            raise AssertionError(f"aot tables: the warm driver built "
                                 f"{len(d2.table_build_s)} topologies")
        for d in drivers:
            _steps(d, 2)
        torch.cuda.synchronize()
        for k in ("vel", "p"):
            if not torch.equal(d1.state[k], d2.state[k]):
                raise AssertionError(f"aot tables: 2 steps' {k} differ")
        rows = [[(r["dt"], r["umax"], r["resid"], r["iters"])
                 for r in d.step_log] for d in drivers]
        if rows[0] != rows[1]:
            raise AssertionError("aot tables: the steps' rows differ")
    log(f"  config #3 set-up: cold {setup[0]:.2f} s ({len(d1.table_build_s)} "
        f"topologies built, {sum(d1.table_build_s):.2f} s), warm "
        f"{setup[1]:.2f} s (0 built, loaded from the store); tables "
        "torch.equal leaf by leaf, 2 steps bitwise")
    res["tables"] = dict(cold_setup_s=setup[0], warm_setup_s=setup[1],
                         cold_table_build_s=list(d1.table_build_s),
                         warm_table_build_s=list(d2.table_build_s))
    del drivers, d, d1, d2
    torch.cuda.empty_cache()

    # -- the fleet: cold without a store, cold with the service, warm -----
    from cup3d_tpu_torch.fleet.server import _job_config
    from cup3d_tpu_torch.sim import amr as amr_mod

    fstore = os.path.join(root, "fstore")
    amr = dict(FA_FLEET_SPEC, nsteps=AOT_AMR_STEPS)
    specs = ([dict(AOT_TGV, cfl=0.3 + 0.02 * i)
              for i in range(AOT_TGV_LANES)]
             + [dict(amr, cfl=0.3 + 0.05 * i) for i in range(AOT_AMR_LANES)])
    keys = ("fleet.executable_builds", "bucket.table_builds",
            "aot.background_compiles", "aot.store_hits",
            "kernels.nvcc_builds")

    def deltas(before):
        now = M.snapshot()
        return {k: now.get(k, 0) - before.get(k, 0) for k in keys}

    tdir = os.path.join(root, "trace")
    with _env(CUP3D_AOT_STORE=None, CUP3D_FUSED="1"):
        before = M.snapshot()
        s0, i0, wall0, first0 = _aot_fleet(specs, os.path.join(root, "f0"))
        off_d = deltas(before)
    with _env(CUP3D_AOT_STORE=fstore, CUP3D_FUSED="1"):
        before = M.snapshot()
        OT.TRACE.configure(enabled=True, directory=tdir)
        try:
            s1, i1, wall1, first1 = _aot_fleet(specs,
                                               os.path.join(root, "f1"))
            OT.TRACE.flush()
            OT.TRACE.export_chrome()
        finally:
            OT.TRACE.close()
            OT.TRACE.configure(enabled=False)
        cold_d = deltas(before)
        helper_s = s1._aot_service.host.start_s
        waits = {j: s1._jobs[j].phases().get("compile_wait", 0.0)
                 for j in i1}
        with open(os.path.join(tdir, "trace.pfto.json")) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events
                 if e.get("pid") == OT.COMPILE_PID and e.get("ph") == "X"]
        before = M.snapshot()
        s2, i2, wall2, first2 = _aot_fleet(specs, os.path.join(root, "f2"))
        warm_d = deltas(before)
        # the helper process's record (built on the host, loaded here)
        # against the same forest's tables built live on the card
        _, cfg = _job_config(amr, os.path.join(root, "f3"))
        rec = aot_store.active_store().get(amr_mod.initial_tables_sig(cfg),
                                           device="cuda")
        g, dt, with_bodies, coarse = amr_mod._initial_knobs(cfg)
        live = amr_mod.bucket_tables(g, cfg, dt, torch.device("cuda"),
                                     with_bodies, coarse)
    if rec is None:
        raise AssertionError("aot fleet: no tables record of the amr_tgv "
                             "forest in the store")
    if int(rec["cap"]) != live[0] or not aot_store.tensors_equal(
            rec["geo"], live[1]):
        raise AssertionError("aot fleet: the helper's tables differ from "
                             "a build on the card")
    amr_ids = set(i1[AOT_TGV_LANES:])
    if not all(waits[j] > 0 for j in amr_ids):
        raise AssertionError(f"aot fleet: an amr_tgv job did not wait on "
                             f"its table build {waits}")
    if any(s1._jobs[j].event_time("compile_wait") is not None
           for j in i1[:AOT_TGV_LANES]):
        raise AssertionError(f"aot fleet: a tgv job waited {waits}")
    if not spans:
        raise AssertionError("aot fleet: no pid-5 compile span")
    if warm_d["bucket.table_builds"] or warm_d["kernels.nvcc_builds"]:
        raise AssertionError(f"aot fleet: the warm server built {warm_d}")
    if not (warm_d["fleet.executable_builds"]
            == cold_d["fleet.executable_builds"]
            == off_d["fleet.executable_builds"] > 0):
        raise AssertionError(f"aot fleet: binds {off_d} {cold_d} {warm_d}")
    if not off_d["bucket.table_builds"] >= AOT_AMR_LANES:
        raise AssertionError(f"aot fleet: the store-off run built {off_d}")
    for a, b, c in zip(i0, i1, i2):
        if not (s0._jobs[a].qoi_bytes() == s1._jobs[b].qoi_bytes()
                == s2._jobs[c].qoi_bytes()):
            raise AssertionError(f"aot fleet: {a}, {b}, {c}'s rows differ")
        if s2._jobs[c].event_time("compile_wait") is not None:
            raise AssertionError(f"aot fleet: warm {c} waited on a build")

    def fd(first):
        return ", ".join(f"{k} {v:.3f} s" for k, v in sorted(first.items()))

    log(f"  fleet ({AOT_TGV_LANES} tgv lanes at 32^3, {AOT_AMR_LANES} "
        f"amr_tgv at bpd 8): no store {wall0:.2f} s, first dispatch "
        f"{fd(first0)}, {off_d}; cold store {wall1:.2f} s, first dispatch "
        f"{fd(first1)}, {cold_d}; compile_wait a job "
        f"{', '.join(f'{v:.3f}' for v in waits.values())} s (tgv none); "
        f"pid-5 spans "
        f"{[(e['name'], round(e['dur'] / 1e3, 2)) for e in spans]} (ms), "
        f"the helper's start {helper_s:.2f} s of it; "
        f"warm store {wall2:.2f} s, first dispatch {fd(first2)}, {warm_d}; "
        "every advance bound in all three (a bind builds nothing); rows "
        "bitwise across the three, no compile_wait warm; the helper's "
        "tables record torch.equal a build on the card")
    res["fleet"] = dict(
        off_s=wall0, cold_s=wall1, warm_s=wall2, off=off_d, cold=cold_d,
        warm=warm_d, first_dispatch_s=dict(off=first0, cold=first1,
                                           warm=first2),
        helper_start_s=helper_s,
        compile_wait_s=list(waits.values()),
        spans=[(e["name"], e["dur"] / 1e3) for e in spans])
    del s0, s1, s2, rec, live
    torch.cuda.empty_cache()

    # -- the dispatch thread during a background table build ---------------
    from cup3d_tpu_torch.fleet.server import FleetServer

    K = DEFAULT_SCAN_K
    tg = [dict(AOT_PROBE_TGV, cfl=0.3 + 0.02 * i)
          for i in range(AOT_TGV_LANES)]
    child = amr_mod.host_tables_build_child

    def in_thread(cfg, host, timeout=None):
        # the build on the worker thread itself, for comparison
        return amr_mod.host_tables_build(cfg)

    probe = {}
    try:
        for tag, build in (("alone", None), ("process", child),
                           ("thread", in_thread)):
            builds = []

            def timed(cfg, host, timeout=None, build=build, builds=builds):
                t0 = time.perf_counter()
                try:
                    return build(cfg, host, timeout=timeout)
                finally:
                    builds.append((t0, time.perf_counter()))

            amr_mod.host_tables_build_child = timed
            pstore = os.path.join(root, f"pstore-{tag}")
            shutil.copytree(fstore, pstore)  # warm tgv, cold probe tables
            with _env(CUP3D_AOT_STORE=pstore, CUP3D_FUSED="1"):
                srv = FleetServer(workdir=os.path.join(root, f"p-{tag}"))
                for i, sp in enumerate(tg):
                    srv.submit(f"t{i}", dict(sp))
                stamps = _tick_ms(srv, lambda: bool(builds), inject=(
                    AOT_PROBE_AT, AOT_PROBE_AMR) if build else None)
                try:
                    srv.drain()
                finally:
                    if srv._aot_service is not None:
                        srv._aot_service.close()
                torch.cuda.synchronize()
            if build is not None and len(builds) != 1:
                raise AssertionError(f"aot {tag}: {len(builds)} builds")
            if build is child:
                probe["helper_start_s"] = srv._aot_service.host.start_s
            ms, n = _round_ms(stamps, K, builds[0] if build else None)
            if not n:
                raise AssertionError(f"aot {tag}: no dispatch round")
            probe[tag] = dict(ms=ms, rounds=n, build_s=(
                builds[0][1] - builds[0][0] if build else None))
    finally:
        amr_mod.host_tables_build_child = child
    log(f"  dispatch thread, {AOT_TGV_LANES} warm tgv lanes at 32^3 (K={K}): "
        f"{probe['alone']['ms']:.3f} ms a step alone (median of "
        f"{probe['alone']['rounds']} rounds); over the rounds that overlap "
        f"a cold amr_tgv signature's background table build (bpd 8, 4,096 "
        f"blocks): {probe['process']['ms']:.3f} ms a step with the build in "
        f"the service's helper process ({probe['process']['rounds']} rounds, "
        f"{probe['process']['build_s']:.2f} s, its start "
        f"{probe['helper_start_s']:.2f} s), "
        f"{probe['thread']['ms']:.3f} with it on the worker thread "
        f"({probe['thread']['rounds']} rounds, "
        f"{probe['thread']['build_s']:.2f} s)")
    res["dispatch"] = probe

    # -- compile.service_die: the jobs still end done ----------------------
    with _env(CUP3D_AOT_STORE=os.path.join(root, "dstore"), CUP3D_FUSED="1"):
        before = M.snapshot()
        faults.arm("compile.service_die", "*", 1)
        _, ids, wall, _ = _aot_fleet(
            [dict(AOT_DIE_AMR, cfl=0.3 + 0.05 * i)
             for i in range(AOT_AMR_LANES)], os.path.join(root, "die"))
        fb_ = M.snapshot().get("aot.service_fallbacks", 0) - before.get(
            "aot.service_fallbacks", 0)
    if not fb_ >= 1:
        raise AssertionError("aot: the dead worker's build was not reaped")
    log(f"  compile.service_die: {len(ids)} jobs done in {wall:.2f} s, "
        f"{fb_:.0f} build(s) reaped and built inline")
    res["service_die"] = dict(fallbacks=fb_, wall_s=wall)
    took = time.perf_counter() - t_phase
    res["phase_s"] = took
    if took > AOT_PHASE_BUDGET_S:
        raise AssertionError(f"phase 37 took {took:.1f} s > "
                             f"{AOT_PHASE_BUDGET_S} s")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    from cup3d_tpu_torch.ops import cuda_lib

    # -- phase 1 ----------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card {name} x{torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    bw, fp32_flops = card_peaks()

    # -- phase 2 ----------------------------------------------------------
    from cup3d_tpu_torch import native

    t0 = time.perf_counter()
    lib = cuda_lib.load()
    log(f"phase 2: built {', '.join(p.name for p in lib.paths)} in "
        f"{lib.build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    native.load()  # the lab-table builder, csrc/tables.cpp (g++)
    log(f"  built and loaded {native.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    log(f"phase 3: kernels vs plain versions at {N_MAIN}^3")
    per_kernel = kernel_phase(bw, fp32_flops)
    main_us = {k: r.get("profile_us") for k, r in per_kernel.items()}
    log(f"phase 4: whole solve at {N_SOLVE}^3")
    iter_kernels = solve_phase()
    log(f"phase 5: main path, {N_MAIN}^3 TGV, {STEPS} steps")
    with _env(CUP3D_FUSED="1"):
        run = main_path_phase()
    torch.cuda.empty_cache()

    log("phase 6: AMR path set-up (BASELINE config #3, bpd 16, levelMax 2)")
    with _env(CUP3D_FUSED="1"):  # read when the forest's solver is built
        d = amr_setup_phase()
    native_s = d.smoke_init_s
    forest_nb, forest_cap = d.grid.nb, d._cap
    log(f"phase 7: forest kernels vs plain versions at {d._geom.nb} blocks "
        f"({d.grid.nb} real)")
    per_kernel.update(forest_kernel_phase(d, bw, fp32_flops))
    log("phase 8: one whole forest solve")
    forest_solve_phase(d)
    log(f"phase 9: AMR main path, {STEPS} steps")
    amr_run = amr_main_path_phase(d)
    graph = d._graph  # the two-level forest's, for phase 13

    log(f"phase 10: tile-only and CG getZ kernels vs plain versions "
        f"({N_MAIN}^3, {d.grid.nb} blocks)")
    per_kernel.update(getz_kernel_phase(d, bw, fp32_flops))
    log(f"phase 11: uniform self-healing loop, {N_MAIN}^3 TGV with "
        f"CUP3D_FAULT={LADDER_FAULT.format(step=2)}")
    ladder = uniform_ladder_phase(run["ke_curve"])
    torch.cuda.empty_cache()
    log("phase 12: forest self-healing loop (phase 9's driver on)")
    forest_ladder = forest_ladder_phase(d)
    log("phase 13: CUP3D_GETZ=cg (uniform legacy composition, forest solve)")
    cg_run = cg_phase(d, graph)
    del d, graph
    torch.cuda.empty_cache()

    log(f"phase 14: the fish main path, BASELINE config #2 at {N_FISH}^3: "
        f"kernels vs plain versions at T = {(N_FISH // 8) ** 3} tiles, then "
        f"{FISH_STEPS} steps")
    fish_kernels = kernel_phase(bw, fp32_flops, n=N_FISH)
    with _env(CUP3D_FUSED="1"):
        fish_run = fish_phase()
    torch.cuda.empty_cache()

    log(f"phase 15: the block-sharded forest, BASELINE config #3 on "
        f"{SHARDS} shards of the card (CUP3D_RING_HALO=1)")
    with _env(CUP3D_RING_HALO="1"):
        d, cfg, _ = shard_setup_phase()
    per_kernel["ring_shift"] = ring_kernel_phase(d, bw)
    shard_run = shard_phase(d, cfg, bw)
    del d
    torch.cuda.empty_cache()

    log(f"phase 16: BASELINE config #2 as the bench runs it at {N_FISH}^3: "
        f"pipelined, then K={SCAN_K} megaloops on the same driver; the "
        f"{N_MAIN}^3 TGV pipelined on the device dt chain and as megaloops")
    with _env(CUP3D_FUSED="1"):
        bench_run = bench_fish_phase(bw, fp32_flops)
        log(f"  config #2 ms/step: non-pipelined (phase 14) "
            f"{fish_run['wall'] / FISH_STEPS * 1e3:.2f}, pipelined "
            f"{bench_run['pipelined_ms']:.2f}, K={SCAN_K} megaloop "
            f"{bench_run['scan_wall_ms']:.2f}")
        tgv = tgv_scan_phase(run["wall"] / STEPS * 1e3)
        log(f"  {N_MAIN}^3 TGV ms/step: phase 5 "
            f"{run['wall'] / STEPS * 1e3:.2f}, "
            f"pipelined on the device dt chain {tgv[0]:.2f}, K={SCAN_K} "
            f"megaloop {tgv[SCAN_K]:.2f}")
    torch.cuda.empty_cache()

    log("phase 17: BASELINE config #5 at 128x64x64 (forced channel, walls "
        "in y, CUP3D_FUSED=1) through the CLI: the bench's window, B2 and "
        "B4 on its wall-bounded lanes, the run from a perturbed state")
    with _env(CUP3D_FUSED="1"):
        channel = channel_phase()
        log("phase 18: the output path on config #5: dumps, an injected "
            "dump.write_fail, a dump in the step window, an async "
            "checkpoint resumed")
        output = output_phase(channel.pop("d"), channel.pop("perturbed"))
    log(f"  config #5: {channel['ms']:.3f} ms/step as the bench runs it "
        f"(iterations {channel['iters'][-1]:.0f} a step, max|div u| "
        f"{channel['div_max']:.3e}); {output['ms_plain']:.3f} without a "
        f"dump, {output['ms_dump']:.3f} with one in the window (one writer; "
        f"{output['ms_dump_cores']:.3f} with a writer a core); {smi}")
    torch.cuda.empty_cache()
    log(f"phase 19: -implicitDiffusion 1 on the {N_MAIN}^3 TGV, "
        f"{IMPLICIT_STEPS} steps")
    with _env(CUP3D_FUSED="1"):
        implicit_phase()
    torch.cuda.empty_cache()
    log(f"phase 20: initCond vorticity at {N_FISH}^3")
    vorticity_phase()
    log(f"phase 21: bodies at {N_FISH}^3: two StefanFish (run.sh's lines) "
        f"for {TWO_FISH_STEPS} steps, a sphere and a NACA foil for "
        f"{RIGID_STEPS} each")
    with _env(CUP3D_FUSED="1"):
        bodies_phase()
    torch.cuda.empty_cache()
    log("phase 22: BASELINE config #4 (run.sh's two StefanFish on the "
        "adapting levelMax-4 forest, host path, CUP3D_FUSED=1): init, the "
        f"bench's {1 + FA_WARM + FA_TIMED} steps, the kernels on its forest, "
        "fused against legacy, the ladder, a checkpoint resumed; then a "
        "towed fish on the same forest, regridding while it steps")
    with _env(CUP3D_FUSED="1"):
        fish_amr = fish_amr_phase(bw, fp32_flops)
        torch.cuda.empty_cache()
        tow = tow_amr_phase(bw, fp32_flops)
    log(f"  config #4: {fish_amr['ms']:.2f} ms/step over the bench's window "
        f"({fish_amr['nb']} blocks, per level {fish_amr['levels']}, "
        f"{sum(fish_amr['iters']) / len(fish_amr['iters']):.2f} iterations "
        f"a step); {smi}")
    torch.cuda.empty_cache()
    log("phase 23: BASELINE config #3 as the bench runs it (-pipelined 1, "
        f"the device dt chain): {PIPE_WARM} warm-up and {PIPE_TIMED} timed "
        f"steps, the regrid probe ({REGRID_WARM} + {REGRID_TIMED} steps), "
        f"{PIPE_KE_STEPS} fixed-dt steps against the host path")
    t0 = time.perf_counter()
    with _env(CUP3D_FUSED="1"):
        pipe_amr = pipe_amr_phase(amr_run["wall"] / STEPS * 1e3)
    log(f"  phase 23 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log("phase 24: BASELINE config #4 as the bench runs it (-pipelined 1): "
        f"{FA_WARM} warm-up and {FA_TIMED} timed steps")
    t0 = time.perf_counter()
    with _env(CUP3D_FUSED="1"):
        pipe_fish = pipe_fish_amr_phase(fish_amr["ms"])
    log(f"  phase 24 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log("phase 25: the forest's physics: FixMassFlux on a walled forest "
        "channel, implicit diffusion under CUP3D_GETZ=cg, the vorticity IC, "
        f"the pipelined step on {SHARDS} shards of the card")
    t0 = time.perf_counter()
    with _env(CUP3D_FUSED="1"):
        physics = forest_physics_phase()
    log(f"  phase 25 took {time.perf_counter() - t0:.1f} s")
    log(f"  ms/step, host path -> pipelined: config #3 "
        f"{amr_run['wall'] / STEPS * 1e3:.2f} (phase 9; the same window "
        f"from one state {pipe_amr['host_ms']:.2f}) -> {pipe_amr['ms']:.2f}; "
        f"config #4 {fish_amr['ms']:.2f} -> {pipe_fish['ms']:.2f}; {smi}")
    torch.cuda.empty_cache()

    log("phase 26: bf16 Krylov storage: the twelve bf16 kernels against "
        f"their bf16 plain versions (B1-B6 at {N_MAIN}^3, B8-B13 on config "
        f"#3's forest), one {N_SOLVE}^3 bf16 solve, the tile-only kernels "
        "on config #2 and config #4 under CUP3D_COARSE=0 at bf16")
    t0 = time.perf_counter()
    with _env(**BF16_KNOBS):  # read when the forest's solver is built
        d = amr_setup_phase()
    bf16_rows = bf16_kernel_phase(d, bw, fp32_flops)
    del d
    torch.cuda.empty_cache()
    bf16_solve_phase()
    bf16_tile = bf16_tile_phase()
    torch.cuda.empty_cache()
    log(f"  phase 26 took {time.perf_counter() - t0:.1f} s")
    log(f"phase 27: config #2 as the bench's fish256 ({N_FISH256}^3, "
        f"pipelined, CUP3D_FUSED at its default) for {FISH256_STEPS} steps "
        "at bf16 and at f32, then at f32 on the fused kernels")
    t0 = time.perf_counter()
    fish256 = fish256_phase()
    log(f"  phase 27 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log("phase 28: config #3 under bf16: phase 23's pipelined run on the "
        f"device dt chain; one solve of the {SHARDS}-shard forest")
    t0 = time.perf_counter()
    pipe_bf16 = pipe_amr_bf16_phase(pipe_amr)
    torch.cuda.empty_cache()
    shard_bf16_phase()
    log(f"  phase 28 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log("phase 29: the bucketed forest: config #3 as the bench runs it "
        "under CUP3D_BUCKET=0 beside phase 23's bucketed run, the forest "
        "kernels at the unpadded block count")
    bucket = bucket_phase(pipe_amr, amr_run["wall"] / STEPS * 1e3, bw,
                          fp32_flops)
    torch.cuda.empty_cache()
    log("phase 30: config #3's set-up with the numpy lab tables beside "
        "phase 6's native ones")
    tables = native_tables_phase(native_s)
    log(f"  bucketed config #3: {pipe_amr['ms']:.2f} ms/step against "
        f"{bucket['unbucketed']['ms']:.2f} unbucketed; set-up "
        f"{tables['native_s']:.2f} s native against {tables['numpy_s']:.2f} "
        f"s numpy; {smi}")
    torch.cuda.empty_cache()
    log(f"phase 31: bench_mesh2d as the bench runs it: the TGV megaloop "
        f"(K={MESH_K}, spectral) solo and on CUP3D_MESH_X={MESH_X} x-slabs "
        f"of the card at {' and '.join(f'{n}^3' for n in MESH_SIZES)}")
    t0 = time.perf_counter()
    mesh2d = mesh2d_phase(bw)
    log(f"  phase 31 took {time.perf_counter() - t0:.1f} s; {smi}")
    log(f"phase 32: config #2's box ({N_FISH}^3, one StefanFish) with the "
        f"spectral solver as K={MESH_K} megaloops, solo and on {MESH_X} "
        "x-slabs; config #2 as it stands under CUP3D_MESH_X")
    t0 = time.perf_counter()
    fish_mesh = fish_mesh_phase()
    log(f"  phase 32 took {time.perf_counter() - t0:.1f} s; {smi}")
    log(f"phase 33: bodies on the sharded forest: config #4 on {SHARDS} "
        "shards of the card (CUP3D_RING_HALO=1), host path and pipelined, "
        "beside the unsharded forest from one state; a sharded resume")
    t0 = time.perf_counter()
    sbodies = sharded_bodies_phase(fish_amr["ms"], pipe_fish["ms"])
    log(f"  phase 33 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log(f"phase 34: bench_fleet32 as the bench runs it: {FLEET_LANES} fish "
        f"lanes at {FLEET_N}^3, {FLEET_STEPS} steps (K={SCAN_K}), against "
        "the same jobs served one at a time")
    t0 = time.perf_counter()
    fleet32 = fleet32_phase(bw)
    log(f"  phase 34 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log(f"phase 35: {FA_LANES} amr_tgv lanes on config #3's forest (bpd 8, "
        f"levelMax 2), {FA_FLEET_STEPS} steps, CUP3D_FUSED=1: every other "
        "lane against its solo run, the forest stages a lane, lane_nan, a "
        "crash drill, bf16 storage")
    t0 = time.perf_counter()
    with _env(CUP3D_FUSED="1"):
        fleet_amr = fleet_amr_phase(bw, fp32_flops)
    log(f"  phase 35 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log(f"phase 36: device-time attribution on the port's drivers: "
        f"config #2 at {N_FISH}^3 as bench_fish_uniform runs it, "
        f"{PROFILE_FISH_STEPS} steps under CUP3D_PROFILE=once:{PROFILE_AT}, "
        f"CUP3D_PROFILE_STEPS={PROFILE_LEN}, CUP3D_TRACE=1, "
        "CUP3D_TRACE_XLA=1, the exporter on loopback")
    t0 = time.perf_counter()
    with _env(CUP3D_FUSED="1"):
        profile_phase(main_us, {k: r.get("profile_us")
                                for k, r in fish_kernels.items()})
    log(f"  phase 36 took {time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()
    log("phase 37: the compiled store and the background compile service: "
        "the kernels from nvcc into an empty store and back from it in "
        "fresh copies of the package, config #3's tables cold and warm, "
        f"{AOT_TGV_LANES} tgv and {AOT_AMR_LANES} amr_tgv lanes on a cold "
        "and a warm server, the dispatch thread during a background table "
        "build, compile.service_die")
    t0 = time.perf_counter()
    aot = aot_phase()
    log(f"  phase 37 took {time.perf_counter() - t0:.1f} s; {smi}")
    with open(os.path.join(OUT_DIR, "aot.json"), "w") as f:
        json.dump(aot, f, indent=1, default=str)
    log(f"  the whole run: {time.perf_counter() - _T0:.1f} s")
    # each kernel's launches from its own path's run: the five uniform
    # kernels' from the fish path, with their 256^3 numbers and the TGV
    # path's launches beside them; B14's from the sharded forest's
    launches = {**amr_run["launches"],
                "getz_tile": ladder["launches"]["getz_tile"],
                "amr_getz_tile": forest_ladder["launches"]["amr_getz_tile"],
                "getz_cg": cg_run["launches"]["getz_cg"],
                "ring_shift": shard_run["launches"]}
    per_kernel["frenet"] = bench_run["frenet"]
    launches["frenet"] = bench_run["frenet"].pop("launches")
    for kname in fish_kernels:
        launches[kname] = fish_run["launches"][kname]
        per_kernel[kname] = dict(fish_kernels[kname], tgv256=dict(
            per_kernel[kname], launches=run["launches"][kname]),
            channel_launches=channel["launches"][kname])
    # B4's stage is the kernel alone: the device kernels an iteration;
    # its launches include those without partials (the warm starts' r0)
    per_kernel["lap"]["iteration_kernels"] = iter_kernels
    per_kernel["lap"]["residual_launches"] = fish_run["residual"]
    per_kernel["lap"]["tgv256"]["residual_launches"] = run["residual"]
    per_kernel["lap"]["tgv256"]["launches"] += run["residual"]
    launches["lap"] += fish_run["residual"]
    # the forest kernels on config #4 (phase 22): their launches a step on
    # its main path, their times on its forest and on the towed forest
    # after its last regrid
    for kname in _forest_want(0):
        row = per_kernel[kname]
        if kname == "amr_getz_tile":
            row["fish_amr_launches"] = fish_amr["tile_launches"]
        else:
            row["fish_amr_launches_per_step"] = (
                fish_amr["launches"][kname] / fish_amr["steps"])
            row["fish_amr"] = fish_amr["kernels"][kname]
            row["tow_amr"] = tow["kernels"][kname]
            # the pipelined configs #3 and #4 (phases 23, 24)
            row["pipe_amr_launches_per_step"] = (
                pipe_amr["launches"][kname] / pipe_amr["steps"])
            row["pipe_fish_amr_launches_per_step"] = (
                pipe_fish["launches"][kname] / pipe_fish["steps"])
            # phase 7's row is at config #3's capacity; the unpadded
            # forest's in the same call (phase 29)
            row.update(blocks=forest_nb, capacity=forest_cap,
                       unpadded=dict(bucket["kernels"][kname],
                                     blocks=bucket["nb"]))
    # B7 on the forest Helmholtz, B14 on the sharded pipelined step (25)
    per_kernel["getz_cg"]["helmholtz_launches_per_step"] = (
        physics["b7_per_step"])
    per_kernel["ring_shift"]["pipe_shard_launches_per_step"] = (
        physics["b14_per_step"])
    # B14 on the x-slab megaloop (phases 31, 32) and under the bodies on
    # the sharded forest (phase 33)
    big = mesh2d[MESH_SIZES[-1]]
    per_kernel["ring_shift"]["slab_mesh"] = dict(
        big.pop("slab_kernel"),
        tgv_launches_per_step={n: r["b14_per_step"]
                               for n, r in mesh2d.items()},
        fish_launches_per_step=fish_mesh["b14_per_step"])
    per_kernel["ring_shift"]["sharded_bodies_launches_per_step"] = {
        m: sbodies[m]["sharded"]["b14"] for m in ("host", "pipelined")}

    # the bf16 kernels' launches: B1, B2, B4-B6 on fish256 at bf16 (phase
    # 27), B3 on config #2 and B10 on config #4 under CUP3D_COARSE=0
    # (phase 26), B8, B9, B11-B13 on config #3 pipelined at bf16 (phase
    # 28)
    for kname in BF16_NAMES:
        key = kname + "_bf16"
        launches[key] = (
            bf16_tile["uniform"]["launches"][kname] if kname == "getz_tile"
            else bf16_tile["forest"]["launches"][kname]
            if kname == "amr_getz_tile"
            else pipe_bf16["launches"][kname] if kname.startswith("amr_")
            else fish256["bf16"]["launches"][kname])
        per_kernel[key] = bf16_rows[key]
    # the fleet's lanes (phases 34, 35)
    for kname in FA_PER_ITER:
        per_kernel[kname]["lanes"] = dict(
            fleet_amr["kernels"][kname], lanes=FA_LANES,
            launches_per_dispatch=fleet_amr["launches_per_dispatch"][kname],
            launches_per_dispatch_1lane=(
                fleet_amr["one_lane"]["launches_per_dispatch"][kname]),
            executed=fleet_amr["executed"],
            executed_1lane=fleet_amr["one_lane"]["executed"])
        bf = fleet_amr["kernels"][kname].get("partials_err_bf16")
        per_kernel[kname + "_bf16"]["lanes"] = dict(
            partials_err=bf, lanes=FA_LANES,
            launches_per_dispatch=(fleet_amr["bf16"]["launches"][kname]
                                   / fleet_amr["bf16"]["dispatches"]),
            executed=fleet_amr["bf16"]["executed"])
    per_kernel["frenet"]["lanes"] = dict(
        lanes=fleet32["frenet_lanes"],
        launches_per_step=fleet32["frenet_launches"] / FLEET_STEPS,
        ms=fleet32["frenet_lanes_ms"],
        plain_ms=fleet32["frenet_lanes_plain_ms"],
        bound_ms=fleet32["frenet_lanes_bound_ms"],
        max_abs_err=fleet32["frenet_lanes_err"])
    replaces = {k: (r, src) for k, r, src in KERNELS}
    rows = []
    for kname, replaces_at, src in KERNELS + tuple(
            (k + "_bf16", *replaces[k]) for k in BF16_NAMES):
        if not launches[kname] > 0:
            raise AssertionError(f"{kname}: no launch on its path")
        row = dict(name=kname, route="cuda",
                   source=f"cup3d_tpu_torch/csrc/{src}", replaces=replaces_at,
                   launches=launches[kname], **per_kernel[kname])
        if kname in REDESIGNED:
            row["redesigned"] = REDESIGNED[kname]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
