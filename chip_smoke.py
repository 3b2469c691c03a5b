#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``etol_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its findings beside the card's name and power
limit; any failure raises, so the script exits non-zero and prints no
result line:

1. device  — CUDA must be available; the card's name and power limit;
2. build   — compile the KKT kernel (``etol_tpu_torch/csrc/bt_solve.cu``),
             the device loop (``etol_tpu_torch/csrc/graph_loop.cu``), the
             step coupling's kernel
             (``etol_tpu_torch/csrc/hs_coupling.cu``) and the line search's
             (``etol_tpu_torch/csrc/ls_candidates.cu``) with nvcc from this
             checkout, one nvcc each at once, and load them;
3. kernel  — the two kernels of the source (the shared-memory one the
             paths launch wherever a lane's factor fits a block, and the
             stream one they launch for longer horizons) against the
             plain PyTorch version on the card, each where it takes the
             shape, at every (K, w, batch) that a later phase gives the
             kernel (the full batches and the stage batches of the main
             path, of the ladder's models and of the B=64 A/Bs, taken from
             the registry), at the stream kernel's horizons (K=2048 at
             B=1, each side of the switch at w = 4, 5, 9, batched long
             horizons) and at ragged batches, each shape's planned kernel
             printed; a later phase fails if it
             launched the kernel at a shape not checked here; a lane with
             an indefinite block must come out
             non-finite and leave the others alone; then, at the main
             path's four batch sizes, the ladder's full batches and every
             timed shape, the kernels in turns and
             the plain version timed with CUDA events over rotating
             inputs (the kernels as replays of a CUDA graph of
             launches), beside the bound from the shapes and a dense
             ``torch.linalg.solve`` of the assembled systems as the
             library yardstick where that batch is under 8 GB; then the
             Hermite–Simpson step coupling's kernel (``ops/hs_coupling``)
             against its plain version (``_ALFuncs._pair_coupling``) at
             every one of those shapes of the unicycle's width (uas_2d
             at K - 1 steps; a trip that assembles launches the KKT
             kernel at its own shape), under the exact curvature and
             Gauss-Newton alone, Z drawn inside the bounds, the defect
             multipliers within +-HS_LAM and rho log-uniform up to
             rho_max: max |diff| / max |plain| within HS_TOL on Dc and O;
             a later phase fails if it launched this kernel at a shape
             not checked here; the kernel and the plain version timed
             at the main path's shapes (each a replay of a CUDA graph),
             beside the kernel's bound, and the non-view aten ops and
             hand-written launches of one uas_2d trip on each route; then
             the line search's candidate kernel (``ops/ls_candidates``)
             against the plain candidate pass at every one of those
             shapes of a separable family (``LS_GRIDS``: ocp_2d_ex1 at
             (33, 4), pm3d at (41, 6), the dry run's single integrator),
             from a state two plain trips from the cold start with its
             multipliers redrawn: each candidate's AL value and decrease
             within LS_TOL of its terms' magnitudes, its point bitwise,
             the pick the plain route's on every lane no such difference
             can move (both rules), the chosen step's defects and rows; a
             later phase fails if it launched this kernel at a shape not
             checked here, and the main, ladder, facade, exact and fleet
             phases hold its launches to two a trip where the route takes
             the problem (ocp_2d_ex1, pm3d) and none elsewhere; the
             kernel, the route's pass (the candidates' launch, the cost
             and the chosen launch) and the plain pass (with the chosen
             step's gathers) timed at each of
             those shapes beside the kernel's bound, and one ocp_2d_ex1
             trip's ops on each route;
4. main    — the port's main path on the default device: ``uas_2d`` N=50,
             B=2048, shooting seeds, the staged cold solve, the obstacle
             audit, and the warm fleet re-solve on x0 + 0.01; the kernel's
             launch count, by batch size, over exactly that run, and the
             step coupling's kernel's, one a trip at each shape;
4b. graph  — the bench's seeds at B=2048 (``shooting.plan_guess``,
             256 walks and 16 pulled rollouts, a program of
             ``trip_graph``) eager, on the graph (its key's first use:
             an eager run, then the capture), on the graph again
             and eager again: z0 bitwise equal, ms, the card's own ms of
             a replay, busy share, captures and pool bytes;
4c. loop   — the solver loop as one graph launch, a while node whose
             stop test runs on the card (``ops/graph_loop.py``, built
             from ``csrc/graph_loop.cu``), against the eager loop (a host
             sync a trip) and the replayed trip (the flag read a trip
             late, one idle trip a solve), in turns: eager, the device
             loop's first use, replay, device loop twice, replay. On (i)
             the main path's phase-1 cold solve (uas_2d N=50, B=2048, the
             bench's seeds), (ii) the whole staged cold solve at B=2048
             with the bench's stages (one captured program: phase 1, each
             stage's gather and loop, the merges) and (iii) 20 MPC ticks
             at B=1 (``run_mpc``: p50 and pipelined ms). On the card each
             of these solves is one program (``trip_graph.run``: the
             prologue, the loops' while nodes and the result in one
             graph), so the device-loop sides are the program route: one
             program call and one graph launch a solve (the MPC's cold
             solve and its ticks two programs holding one loop), the
             card's own ms a tick (the tick program replayed). Every
             device-loop result bitwise the eager route's (the MPC's cold
             solve and every tick), the replays' within GRAPH_TOL, one
             launch of the kernel a trip, no idle trip, and captures on a
             key's first use only; each side's trips (the
             device counter's), launches,
             idle trips, ms a trip, the card's own trip, busy share,
             graph launches, captures, capture seconds and pool bytes;
             the CUDA runtime, CUDA driver and nvcc versions; then the loop's
             own cost a trip on a two-kernel body against the same body
             replayed with a host read a trip. Every phase runs its loops
             on the device loop (all but the horizon solve over ranks, a
             collective) and ends with its captures, trips on static
             buffers and in device loops, graph launches, eager trips and
             program calls; an idle trip outside this phase fails the
             run;
4d. programs — the reference's other jitted solves as one program a
             call: the facade's cold ``solve_batch`` at B=2048 with a
             rescue of 512 lanes (``solve_batched_rescue``: phase 1, the
             gather, the per-lane seeds, the flat multistart batch of 2048
             starts and the merge in one graph launch) on its key's first
             use and twice after (one program call and one graph launch
             each, bitwise the first use; wall and the card's own ms, pool
             bytes), the same at B=256 with 64 rescued lanes against the
             eager route (bitwise), and ``solve_multistart`` on both
             shipped problems eager, on its first use and replayed
             (bitwise, one launch); the exact waves (one program call and
             one graph launch a wave) are held in the exact phase;
5. a/b     — B=64, N=50 cold solves with the kernel and with the plain
             "scan" KKT path, both on the card;
6. cr      — cyclic reduction (plain torch ops, no kernel of its own)
             against the plain block Cholesky and the kernel on the card,
             at the ladder's shapes and one width above the kernel's 9;
             then one problem (B=1) at K = 51, 101, 511, 2047, w=5: the
             plain scan, cyclic reduction and the kernel timed;
7. mpc     — the single-problem warm re-solve at N=50
             (``bench_harness.run_mpc``) under ``kkt_solver="kernel"``
             (every iteration a launch at B=1) and again under ``"cr"``
             (the JAX package's route, no launch; the first MPC_CR_STEPS
             of the MPC_STEPS re-solves): statuses, latencies, launches and
             cyclic-reduction solves of each;
8. bench   — ``bench_harness.bench`` at B=2048 with one timed cold and
             one timed warm batch and phase 7's MPC figures under
             "kernel": its JSON line;
9. ladder  — ``bench_scaling.run_config`` for pm20 (K=21, w=6, B=1024),
             pm3d (K=41, w=6, B=1024) and fw100 (K=101, w=9, B=256) under
             the registry configs: solved fractions, the kernel's launches
             by shape, and an A/B at B=64 for each: pm20's and pm3d's cold
             solves under the kernel against the plain "scan" path, and for
             fw100 a warm re-solve of moved starts under the kernel against
             "cr" (its cold solve is 156 KKT solves at K=101, a second each
             by the scan and a quarter by cyclic reduction; the plain
             version is held against the kernel at that shape in phase 3,
             and against cyclic reduction in phase 6);
10. facade — the library's entry point on the default device: the README's
             Quick start on ``ocp_2d_ex1.xml`` (load, setup, solve, debug,
             get_xtraj, save, load_csv), MPC_STEPS ``mpc_step``s under
             "kernel" and MPC_CR_STEPS under "cr", ``solve_multistart`` on
             both shipped problems
             (the OCP against the golden CSVs), ``solve_batch`` at B=2048
             cold with a rescue of 512 lanes and warm, a small fleet whose
             tight budget forces the rescue phase, and the CLI's
             ``solve_ocp`` and ``mpc_demo 5`` in-process; one JSON line of
             its findings;
11. exact  — the exact MILP path: ``side_branch.solve_exact`` on
             ``mip_2d_ex1.xml`` with ``convex_relaxation=True`` under
             ``kkt_solver="kernel"`` (every Newton trip of every wave one
             launch at (17, 6, 8)) and under ``"cr"`` (no launch), and the
             facade's ``solve_exact`` on the composed demo (a BINARY boost
             and an obstacle, wave 16; launches at (7, 5, 16)), with
             ``get_xtraj`` and ``save``; nodes, waves, trips, launches and
             seconds of each, and one JSON line of its findings;
12. planners — the sampling planners on ``uas_2d`` N=50 (three boxes) at
             the problem's default budget (N dt = 10 s, 20480 samples):
             each of the seven names eager, on the graph (its key's first
             use: an eager run, the capture, a replay) and on the graph
             again, X, U and every ``info`` tensor bitwise equal across
             the three (samples, trips, seconds of each route, the card's
             own seconds of a replay, the staged draws' bytes, pool
             bytes, best score, tree counts, PDST's largest priority);
             planner-seeded
             ``al_sqp.solve``s under "kernel" from RRT, SST and PDST
             (launches at (51, 5, 1)); the facade's ``set_planner`` +
             ``plan`` on ``ocp_2d_ex1.xml`` for every name, at a budget
             of 4 s (8192 samples); one JSON line;
13. fleet  — the multi-vehicle model: three vehicles (w = 12, above the
             kernel's 9: cyclic reduction, no launch) under "kernel", then
             re-solved warm under "cr", two vehicles (w = 8) single under "kernel" (launches at
             (25, 8, 1)), and a batch of FLEET_B two-vehicle fleets with
             starts moved by a fixed draw of +-0.25 (launches at (25, 8,
             FLEET_B)); one JSON line;
14. parallel — the parallel layer: the horizon-sharded SPIKE KKT solve
             (``parallel.kkt.make_solver`` over n slabs, one launch for
             the slabs' interiors with their 2w+1 columns as lanes and one
             for the separators) at B=1, w=5, K in SPIKE_K and n in
             SPIKE_N against the direct launch (the stream kernel at
             K=2048) and the plain version
             (max |dx|, host ms with a sync); ``dryrun_multichip(8)`` on
             the card (a batch-sharded tiny uas_2d, warm ticks, a K=512
             obstacle solve horizon-sharded over 8 slabs against the
             unsharded one, the sharded evaluators); the dry run's
             long-horizon problem at K=2048 solved unsharded (every KKT
             solve the stream kernel at (2048, 4, 1)) and horizon-sharded
             over 8 slabs, both SOLVED and held to each other as the dry
             run holds K=512; ``cli fleet_batch
             512`` in-process; two subprocess ranks on this card over gloo
             (``python -m etol_tpu_torch.parallel.distributed``, loading
             the library this process built) whose gathered objectives
             must be this process's ``solve_batched``; one JSON line;
15. variants — the solver's line-search and Levenberg variants: the
             bench's problem and seeds (uas_2d N=50, B=VARIANT_B) staged
             through ``solve_batched_staged`` under the uas registry
             config and under three variants (the nonmonotone line search
             with the "best" rule, the count-rule damping without the
             patience exit, the over-relaxed multipliers with a sparse
             exponent grid and the deep-step round exit): solved share,
             trips, seconds, launches by shape, and every solved lane held
             to ``tol_cons`` by its violation and the exact audit; the
             canonical OCP through the facade under the three knob
             configurations of ``tests/test_solver.py`` (each SOLVED,
             ``viol_eq < 1e-4``); one ``newton_step`` of NEWTON_B lanes
             (one launch at (51, 5, NEWTON_B)) against the same step on the
             plain route; one JSON line.

The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py
--phases kernel,cr`` runs phases 1 and 2 and the named ones only, and
prints neither line; ``python3 chip_smoke.py loop`` (that one argument
alone) runs the loop phase so.
"""
import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (K, w, B) that are timed: the main path's K=51, w=5 at every batch its
# stages give the kernel (2048, then B/2, B/8, B/32), and the full batches
# of the ladder's other models (pm20, pm3d, fw100)
MAIN_SHAPES = ((51, 5, 2048), (51, 5, 1024), (51, 5, 256), (51, 5, 64))
LADDER_SHAPES = ((21, 6, 1024), (41, 6, 1024), (101, 9, 256))
# the facade's: ocp_2d_ex1.xml is K=33, w=4 (one problem, 8 starts, the
# fleet, its rescue batch of RESCUE_LANES lanes times 4 starts, which is
# the fleet's size again, the batch of a default rescue, B // 8 lanes
# times 4, and the small fleet of FORCED_B lanes whose rescue takes
# FORCED_LANES of them), mip_2d_ex1.xml is K=17, w=6 (8 starts); and the
# main path's one problem. About one fleet lane in six ends its first
# phase in an infeasible basin (the starts lie 0.01 outside a moving
# obstacle), so the rescue is given a quarter of the fleet, not the
# default eighth.
FACADE_B, FORCED_B, FORCED_LANES = 2048, 64, 8
RESCUE_LANES = FACADE_B // 4
FACADE_SHAPES = ((33, 4, 1), (33, 4, 8), (33, 4, FACADE_B),
                 (33, 4, FACADE_B // 2), (17, 6, 8))
# the programs phase holds the rescue bitwise against the eager route at
# PROGRAM_B lanes with PROGRAM_RESCUE rescued (the eager route at the
# facade's 2048 lanes takes ~500 host-synced trips); both phases launch at
# (33, 4, PROGRAM_B)
PROGRAM_B, PROGRAM_RESCUE = 256, 64
PROGRAM_SHAPES = ((33, 4, PROGRAM_B),)
FORCED_SHAPES = ((33, 4, FORCED_B), (33, 4, FORCED_LANES * 4))
B1_SHAPE = (51, 5, 1)
# the exact path: a wave of EXACT_WAVE nodes is one batched solve, so
# mip_2d_ex1.xml launches at (17, 6, 8) (a facade shape already) and the
# composed demo (K=7, w=5: two states, two controls, the boost) at (7, 5,
# COMPOSED_WAVE): waves of 16 since the parallel phase came (on a CPU 22
# waves, 1044 trips, against 40 and 1589 at 8; the same certified optimum)
EXACT_WAVE, COMPOSED_WAVE, EXACT_MAX_NODES = 8, 16, 384
EXACT_SHAPES = ((17, 6, EXACT_WAVE), (7, 5, COMPOSED_WAVE))
# the fleet phase: fleet_2d's 24 steps (K=25) of two vehicles (w = 4V = 8)
# solved one at a time and as a batch of FLEET_B fleets whose starts move
# by a fixed numpy draw within +-FLEET_SPREAD; solve_batched keeps the
# whole batch to the end, so it launches at the full batch only
FLEET_B, FLEET_SPREAD, FLEET_SEED = 1024, 0.25, 0
FLEET_SHAPES = ((25, 8, 1), (25, 8, FLEET_B))
# the fleet test's limits (tests/test_fleet.py): goals within 0.06, the
# separation d_min = 0.5 held to 1e-2
FLEET_GOAL_TOL, FLEET_DMIN = 0.06, 0.49
# the single two-vehicle fleet (the parity test's draw) converges to
# FLEET2_OBJ in the JAX package on a CPU and in the port on a CPU to
# 1.1e-7 relative (tests/test_torch_fleet.py checks the figure); it stops
# in a flat valley whose objective moves with the arithmetic (8.668407 on
# an H100, 0.32% lower; solved to 1e-6 instead it runs out of iterations
# at 3.6e-5 on the card in float32), so the card is held to 1% of it
FLEET2_OBJ, FLEET2_RTOL = 8.696102, 1e-2
# the golden's objective for mip_2d_ex1.xml (tests/golden/mip_2d_ex1.csv),
# the composed demo's certified optimum, and how close a certified search
# is held to them: for the MIP the JAX package's own limit for its exact
# search against HiGHS's certified optimum (tests/test_golden.py, random
# instances; a SOLVED node is feasible only to tol_cons, and this MIP's
# closing relaxations spread over 11.954-11.963 with their warm starts),
# 1e-3 for the composed demo; the two KKT routes' MIP objectives are held
# within MIP_ROUTE_TOL of each other (9.3e-5 apart on an H100, 1.5e-3 when
# the same script's exact phase runs on a CPU)
MIP_GOLDEN, COMPOSED_OPT = 11.96, 8.44876
MIP_TOL, COMPOSED_TOL, MIP_ROUTE_TOL = 7e-3, 1e-3, 2e-3
# the parallel phase: SPIKE at B=1, w=SPIKE_W over n slabs; the dry-run
# over DRYRUN_N entries (horizon 2), its long horizon K = DRYRUN_NSTEPS + 1
# single-integrator nodes (w = 4) over DRYRUN_N slabs and its tiny uas_2d
# (K = 8, B = 8: the chunks share the card, one batch); cli fleet_batch at
# FLEET_BATCH_B (one card, one chunk); the two ranks' demo (double
# integrator K = 21, w = 6, 4 lanes a rank, 8 in this process; SPIKE at
# K = 16, w = 3 and the horizon solve at K = 16, w = 4, a slab a rank)
SPIKE_K, SPIKE_N, SPIKE_W, SPIKE_REPS = (512, 2048), (8, 32), 5, 20
DRYRUN_N, DRYRUN_NSTEPS = 8, 511
FLEET_BATCH_B = 512
# the long-horizon step of the parallel phase: the dry run's problem at
# K = LONG_NSTEPS + 1 nodes, unsharded (every KKT solve one launch of the
# stream kernel at (K, 4, 1)) and horizon-sharded over DRYRUN_N slabs
LONG_NSTEPS = 2047
DIST_RANKS, DIST_B = 2, 8


def spike_shapes(K, w, n, B=1, slabs=None):
    """The two launches of one SPIKE solve of B systems over n slabs, of
    which a process holds ``slabs`` (n; 1 a rank): the interiors with
    their 2w+1 columns as lanes, and the separators."""
    slabs = n if slabs is None else slabs
    return ((K // n - 1, w, B * slabs * (2 * w + 1)), (n, w, B))


# the variants phase (15): the bench's batch and seed, the configurations
# of its uas_2d runs and of its facade OCP solves (at (33, 4, 1)), and the
# lanes of its newton_step
VARIANT_B, VARIANT_SEED, NEWTON_B = 1024, 3, 8
VARIANT_RUNS = (
    ("default", {}),
    ("nonmonotone_best", dict(ls_eta=0.85, ls_rule="best")),
    ("count", dict(lm_rule="count", round_viol_patience=0)),
    ("relaxed_sparse_deep", dict(
        dual_relax=1.6, ls_exponents=(0, 1, 2, 3, 4, 5, 6, 7, 9, 12, 16, 22),
        ls_deep_round=12)),
)
OCP_KNOBS = (
    ("ls_eta", dict(ls_eta=0.85)),
    ("patience", dict(round_viol_patience=4, rho_growth=3.16)),
    ("count", dict(lm_rule="count", round_viol_patience=0)),
)
NEWTON_SHAPE = (51, 5, NEWTON_B)


PARALLEL_SHAPES = tuple(dict.fromkeys(
    [s for K in SPIKE_K for n in SPIKE_N
     for s in spike_shapes(K, SPIKE_W, n)]
    + list(spike_shapes(DRYRUN_NSTEPS + 1, 4, DRYRUN_N))
    + [(DRYRUN_NSTEPS + 1, 4, 1), (8, 5, 8), (51, 5, FLEET_BATCH_B),
       (21, 6, DIST_B), (21, 6, DIST_B // DIST_RANKS)]
    + list(spike_shapes(16, 3, DIST_RANKS, slabs=1))
    + list(spike_shapes(16, 4, DIST_RANKS, slabs=1)) + [(16, 4, 1)]
    + [(LONG_NSTEPS + 1, 4, 1)]
    + list(spike_shapes(LONG_NSTEPS + 1, 4, DRYRUN_N))
    + [(K, SPIKE_W, 1) for K in SPIKE_K]))
# the stream kernel's horizons (the lane factor past a block's shared
# memory), checked and timed though no path runs some of them: the long
# B=1 solves, each side of the switch at w = 4, 5, 9, batched long horizons
LONG_SHAPES = ((2048, 4, 1), (2048, 5, 1), (2047, 5, 1),
               (1614, 4, 8), (1615, 4, 8), (1076, 5, 8), (1077, 5, 8),
               (387, 9, 8), (388, 9, 8),
               (1077, 5, 64), (388, 9, 256), (2048, 5, 64))
TIMED_SHAPES = tuple(dict.fromkeys(
    MAIN_SHAPES + LADDER_SHAPES + FACADE_SHAPES + (B1_SHAPE,)
    + tuple(s for s in EXACT_SHAPES if s not in FACADE_SHAPES)
    + FLEET_SHAPES
    + tuple(s for s in PARALLEL_SHAPES if s != B1_SHAPE)
    + (NEWTON_SHAPE,) + LONG_SHAPES + ((2048, 5, 3),)))
# batches that are no multiple of the lanes a block takes
RAGGED_SHAPES = ((51, 5, 3), (41, 6, 7), (21, 6, 1000), (2048, 5, 3))
TIMED_SET_BYTES = 100 * 2 ** 20
# launches recorded into the CUDA graph that times a kernel
TIMED_INNER = 10
# single calls of the plain version timed at each shape (0.07-0.8 s each)
PLAIN_REPS = 3
# the two kernels of bt_solve.cu: a lane across w threads with the
# factor in shared memory, and the same with the factor in device memory
# (streamed back through shared memory)
VARIANTS = ("smem", "stream")
# a dense [B, K w, K w] batch above this is not built for the library time
DENSE_MAX_BYTES = 8e9
# published peaks of one H100 SXM: device memory rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
MAIN_B, MAIN_NSTEPS, AB_B = 2048, 50, 64
# ladder config -> its (K, w)
LADDER = {"pm20": (21, 6), "pm3d": (41, 6), "fw100": (101, 9)}
# (K, w, B) the kernel phase held against the plain version; None until
# that phase has run (a run of picked phases without it checks no launch)
CHECKED = None
# phase 6: shapes where cyclic reduction is held against the plain block
# Cholesky (and the kernel, up to its width), and the B=1 horizons timed
CR_SHAPES = ((51, 5, 64), (41, 6, 64), (101, 9, 64), (21, 10, 64))
B1_HORIZONS = (51, 101, 511, 2047)
# phases 7 and 10: re-solves under "kernel" and of the "cr" side (20 and
# 10 until the parallel phase came, cut to keep the script near half its
# time limit)
MPC_STEPS, MPC_CR_STEPS = 10, 5
# phase 9, fw100's warm A/B: the starts move by this much (km; the ladder
# scatters them within 0.05), and a re-solve gets this many iterations
WARM_DRIFT, WARM_BUDGET = 0.005, 60
PHASES = ("kernel", "main", "graph", "loop", "programs", "a/b", "cr", "mpc",
          "bench", "ladder", "facade", "exact", "planners", "fleet",
          "parallel", "variants")
# the graph phase: replays a timed run of one trip's graph, and the
# difference allowed between the graph's results and the eager loop's
# where they are not bitwise equal
GRAPH_REPS = 10
GRAPH_TOL = 1e-6
# the loop phase: MPC ticks, the trips of the loop's own timing, and the
# bytes its condition kernel moves a trip (the flag read, the two
# counters and the stamp slot's trips read and written)
LOOP_MPC_STEPS = 20
LOOP_BENCH_TRIPS = 1000
LOOP_COND_BYTES = 1 + 3 * 16
# the planners phase: the planner-seeded solves, and the facade's budget
# on ocp_2d_ex1.xml: 4 s, 8192 samples, a quarter of its problem-derived
# 16 s (32768 samples, 511 trips a tree, 48 s of the phase on a slower
# host) to keep the whole script near half its time limit
SEEDED = ("RRT", "SST", "PDST")
FACADE_PLAN_SECONDS = 4.0

# the step coupling's kernel: the limit on max |kernel - plain| over max
# |plain| of Dc and of O (float32 in another order of operations: 8e-8 on
# the host build of its arithmetic, tests/test_torch_hs_coupling.py), the
# solver's hessians it is checked under, the defect multipliers' range and
# rho's (log-uniform from RHO_LO to SolverConfig.rho_max); the (K, w, B)
# it was held at, None until the kernel phase has run
HS_TOL = 1e-5
HS_HESSIANS = ("defect", "gn")
HS_LAM, HS_RHO_LO = 50.0, 10.0
HS_CHECKED = None
# timed: the kernel in a graph of HS_INNER launches, the plain version of
# HS_PLAIN_INNER calls; the batch of the per-trip op count
HS_INNER, HS_PLAIN_INNER, HS_COUNT_B = 10, 2, 64

# the line search's candidate kernel (ops/ls_candidates): the candidates
# each separable family on the paths runs, by (K, w): ocp_2d_ex1 and the
# dry run's single integrator at the default ls_grid, pm3d at the
# registry's 16; the limit on |kernel - plain| over the sum of the
# magnitudes of a candidate's terms (its value's and its decrease's:
# float32 sums in another order, 4.1e-7 at most on the host build of its
# arithmetic, tests/test_torch_ls_candidates.py, 1.8e-6 on an H100 at the
# rescue's shape); the redrawn defect
# multipliers' range (+-), the inequality multipliers' (0 to) and rho's
# (log-uniform); the (K, w, n, B) it was held at, None until the kernel
# phase has run
LS_GRIDS = {(33, 4): 24, (41, 6): 16, (DRYRUN_NSTEPS + 1, 4): 24,
            (LONG_NSTEPS + 1, 4): 24, (16, 4): 24}
LS_TOL = 1e-5
LS_LAM, LS_MU, LS_RHO = 5.0, 2.0, (10.0, 1e4)
LS_CHECKED = None
# timed at every checked shape: the kernel in a graph of LS_INNER
# launches, the plain pass of LS_PLAIN_INNER calls; the batch of the
# per-trip op count
LS_INNER, LS_PLAIN_INNER, LS_COUNT_B = 10, 2, 64
# its launches by (K, w, n, B) at the last reset_counts
LS_BASE = {}

CARD = None
# the solver loop's module (etol_tpu_torch.solve.trip_graph) and the
# device loop's (etol_tpu_torch.ops.graph_loop), once built
TG = GL = None
# the step coupling's kernel's module (etol_tpu_torch.ops.hs_coupling)
# and the line search's (etol_tpu_torch.ops.ls_candidates)
HS = LS = None
# the phases whose replay route runs idle trips past a stop (a run of
# any other phase with one fails: every loop there is the device loop)
REPLAY_PHASES = ("loop",)


def say(phase, msg):
    print(f"[{phase}] [{CARD}] {msg}", flush=True)


class Clock:
    """Seconds since the script's start and since the last call, said at
    the end of each phase."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.graphs = None

    def lap(self, phase):
        now = time.perf_counter()
        say(phase, f"phase took {now - self.last:.1f} s "
                   f"({now - self.start:.1f} s since the start)")
        self.last = now
        if TG is not None:
            TG.settle()
            c = dict(TG.COUNTS, cond_launches=GL.LAUNCHES,
                     loop_trips=GL.TRIPS)
            was = self.graphs or dict.fromkeys(c, 0)
            d = {k: c[k] - was[k] for k in c}
            say(phase, f"solver loop: {d['captures']} captures in "
                       f"{d['capture_s']:.2f} s, {d['trips']} trips on "
                       f"static buffers ({d['loop_trips']} of them in "
                       f"device loops, {d['idle_trips']} idle past a "
                       f"replayed stop), {d['eager_trips']} eager trips, "
                       f"{d['loop_graphs']} launches of graphs holding a "
                       f"loop, {d['cond_launches']} condition-kernel "
                       f"launches, {d['programs']} program calls on "
                       f"graphs; {len(TG._CACHE)} keys "
                       f"cached, pools {TG.pool_bytes()} bytes, static "
                       f"buffers {TG.static_bytes()} bytes")
            self.graphs = c
            if d["idle_trips"] and phase not in REPLAY_PHASES:
                raise AssertionError(
                    f"{phase}: {d['idle_trips']} idle trips: every loop "
                    "of this phase should run on the device loop")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def spd_problem(torch, B, K, w, seed):
    """SPD block-tridiagonal systems as tests/test_pallas_bt.py makes
    them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = rng.normal(size=(B, K, w, w)).astype(np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 5 * np.eye(w, dtype=np.float32)
    O = (rng.normal(size=(B, K - 1, w, w)) * 0.3).astype(np.float32)
    r = rng.normal(size=(B, K, w)).astype(np.float32)
    return [torch.tensor(a, device="cuda") for a in (D, O, r)]


def spd_problem_sets(torch, B, K, w, seed):
    """The same kind of systems made on the card, in as many sets as hold
    more than twice the 50 MB L2 together (at most 64): a timed launch
    takes the next set in turn and finds its inputs as cold as the cache
    lets a caller find them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    set_bytes = 4 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)
    n = max(2, min(64, -(-TIMED_SET_BYTES // set_bytes)))
    eye = 5 * torch.eye(w, device="cuda")
    sets = []
    for _ in range(n):
        A = torch.randn((B, K, w, w), generator=gen, device="cuda")
        D = (A @ A.transpose(-1, -2) + eye).contiguous()
        O = 0.3 * torch.randn((B, K - 1, w, w), generator=gen,
                              device="cuda")
        r = torch.randn((B, K, w), generator=gen, device="cuda")
        sets.append((D, O, r))
    return sets


def _median_event_ms(torch, run, reps, per):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    times.sort()
    return times[len(times) // 2]


def median_ms(torch, fn, reps=20):
    """Median over ``reps`` single calls of ``fn(i)``, each between two
    CUDA events, after one warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    calls = iter(range(1, reps + 1))
    return _median_event_ms(torch, lambda: fn(next(calls)), reps, 1)


def graph_ms(torch, fn, reps=20, inner=10):
    """The card's time for one call of ``fn(i)``: ``inner`` calls in a row
    are recorded into a CUDA graph, and the median over ``reps`` replays,
    each between two CUDA events, is divided by ``inner``. A replay costs
    the host one call, so a kernel shorter than its wrapper's host time is
    timed by the card and not by the host that enqueues it."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = [fn(i) for i in range(1, inner + 1)]
    graph.replay()
    torch.cuda.synchronize()
    ms = _median_event_ms(torch, graph.replay, reps, inner)
    del held
    return ms


def bound(K, w, B):
    """The least time the card could take for one (K, w, B) solve:
    (bound_ms, bound_by, bytes, flops). Bytes: D, O, r read once, x
    written once. Operations a node and lane: Cholesky w^3/3, W = L^-1 O
    w^3, Schur update 2 w^3, four sweeps of 3 w^2, residual 6 w^2."""
    nbytes = 4 * B * (K * w * w + (K - 1) * w * w + 2 * K * w)
    flops = B * K * (w ** 3 / 3 + 3 * w ** 3 + 18 * w ** 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_flops else "operations"
    return max(t_bytes, t_flops), by, nbytes, flops


def path_shapes(bench_scaling):
    """Every (K, w, B) the later phases give the kernel, from the
    registry: each model's full batch and its stages' batches (the cold
    ones, and the warm re-solve's for the main path), at the size its path
    runs and at the A/B's (uas_2d at the main path's batch and at the
    variants phase's)."""
    from etol_tpu_torch.models.tuned import tuned_config, warm_config

    runs = [("uas_2d", 51, 5, MAIN_B), ("uas_2d", 51, 5, VARIANT_B)]
    runs += [(bench_scaling.LADDER[name][1], K, w,
              bench_scaling.LADDER[name][3])
             for name, (K, w) in LADDER.items()]
    shapes = []
    for model, K, w, full in runs:
        for B in (full, AB_B):
            cfg, stages = tuned_config(model, batch=B)
            if model == "uas_2d":
                stages += warm_config(cfg, batch=B)[1]
            for b in [B] + [min(cap, B) for cap, _ in stages]:
                if (K, w, b) not in shapes:
                    shapes.append((K, w, b))
    for shape in ((B1_SHAPE,) + FACADE_SHAPES + PROGRAM_SHAPES
                  + FORCED_SHAPES + EXACT_SHAPES
                  + FLEET_SHAPES + PARALLEL_SHAPES + (NEWTON_SHAPE,)):
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def assert_checked(path, launches_by, ls_by=None):
    """Fail if ``path`` launched the kernel at a (K, w, B) that the kernel
    phase did not hold against the plain version, or the step coupling's
    kernel at one (since the process started) that it did not hold
    against ``_pair_coupling``, or the line search's at a (K, w, n, B)
    (``ls_by``, by default its launches since the process started) that it
    did not hold against the plain candidate pass."""
    if CHECKED is None:
        return
    missed = sorted({key[1:] for key in launches_by} - CHECKED)
    if missed:
        raise AssertionError(
            f"{path}: kernel launches at {missed}, shapes the kernel phase "
            "did not compare with the plain version")
    missed = sorted(set(HS.TALLY.by) - HS_CHECKED)
    if missed:
        raise AssertionError(
            f"{path}: step coupling launches at {missed}, shapes the "
            "kernel phase did not compare with _pair_coupling")
    missed = sorted(set(LS.TALLY.by if ls_by is None else ls_by)
                    - LS_CHECKED)
    if missed:
        raise AssertionError(
            f"{path}: line search kernel launches at {missed}, shapes the "
            "kernel phase did not compare with the plain candidate pass")


def takes(bt_cuda, variant, K, w, B):
    """Whether the kernel ``variant`` can take a (K, w, B) solve (the
    shared-memory kernel only where one lane's factor fits a block)."""
    try:
        bt_cuda.plan(K, w, B, variant)
    except ValueError:
        return False
    return True


def compare(torch, bt_cuda, btridiag, K, w, B, seed, inputs=None):
    """Every kernel variant that takes the shape against the plain version
    at one shape, on ``inputs`` (D, O, r) or on systems made from
    ``seed``; returns (the larger max |x_kernel - x_plain|, the plain
    call's host milliseconds with a sync)."""
    D, O, r = inputs or spd_problem(torch, B, K, w, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xp = btridiag.solve_refined(D, O, r)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    scale = float(xp.abs().max())
    res_p = float((r - btridiag.matvec(D, O, xp)).abs().max())
    worst = 0.0
    for variant in VARIANTS:
        if not takes(bt_cuda, variant, K, w, B):
            continue
        xk = bt_cuda.solve(D, O, r, variant=variant)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        res_k = float((r - btridiag.matvec(D, O, xk)).abs().max())
        say("kernel", f"K={K} w={w} B={B} {variant}: max|x_kernel - "
                      f"x_plain| {err:.3e} (limit "
                      f"{2e-4 * (1 + scale):.3e}), |r - Hx|inf kernel "
                      f"{res_k:.3e} plain {res_p:.3e}")
        if not (err <= 2e-4 * (1.0 + scale)):
            raise AssertionError(
                f"{variant} kernel disagrees at {(K, w, B)}: {err}")
        if not (res_k <= res_p + 1e-4):
            raise AssertionError(
                f"{variant} kernel residual {res_k} > plain {res_p}")
        worst = max(worst, err)
    CHECKED.add((K, w, B))
    return worst, plain_ms


def check_indefinite(torch, bt_cuda):
    """One lane's D block set to -I: that lane's x is non-finite, every
    other lane is what it is without the bad block."""
    K, w, B = 51, 5, 64
    bad = 17
    D, O, r = spd_problem(torch, B, K, w, seed=11)
    Dbad = D.clone()
    Dbad[bad, 3] = -torch.eye(w, device="cuda")
    keep = torch.arange(B, device="cuda") != bad
    for variant in VARIANTS:
        x = bt_cuda.solve(D, O, r, variant=variant)
        xb = bt_cuda.solve(Dbad, O, r, variant=variant)
        torch.cuda.synchronize()
        if bool(torch.isfinite(xb[bad]).all()):
            raise AssertionError(
                f"{variant}: the indefinite lane came out finite")
        if not torch.equal(xb[keep], x[keep]):
            raise AssertionError(
                f"{variant}: an indefinite lane changed another lane")
        say("kernel", f"indefinite lane {bad} of {B} ({variant}): "
                      f"non-finite x there, all other lanes unchanged")


def check_kernel(torch, bt_cuda, btridiag, shapes):
    """Phase 3: every kernel that takes a shape vs plain on the card at
    ``shapes`` (those the paths run), the stream kernel's horizons and the
    ragged ones, then the timings at TIMED_SHAPES (a timed shape past
    K=200 is checked there, on the first of its timed input sets, so that
    its one timed call of the plain version is on those sets too);
    returns (max_abs_err, times) with times[(K, w, B)] = dict(smem (None
    where it cannot take the shape), stream, plain, library (None where
    the dense batch is too large), bound, bound_by, variant)."""
    global CHECKED
    CHECKED = set()
    worst = 0.0
    checked = tuple(dict.fromkeys(tuple(shapes) + LONG_SHAPES
                                  + RAGGED_SHAPES))
    if not set(TIMED_SHAPES) <= set(checked):
        raise AssertionError("a timed shape is not one phase 3 checks")
    for i, (K, w, B) in enumerate(checked):
        say("kernel", f"K={K} w={w} B={B}: planned "
                      f"{bt_cuda.plan(K, w, B).variant}")
        if K > 200 and (K, w, B) in TIMED_SHAPES:
            continue
        err, _ = compare(torch, bt_cuda, btridiag, K, w, B, seed=K + w + i)
        worst = max(worst, err)
    check_indefinite(torch, bt_cuda)

    times = {}
    for K, w, B in TIMED_SHAPES:
        sets = spd_problem_sets(torch, B, K, w, seed=B)
        n = len(sets)
        long_k = K > 200
        t = {"variant": bt_cuda.plan(K, w, B).variant}
        if long_k:
            # the check, and the plain version's one timed call (1.4 s at
            # K=511, 5 s at K=2048), on the first timed set
            err, plain_ms = compare(torch, bt_cuda, btridiag, K, w, B,
                                    seed=None, inputs=sets[0])
            worst = max(worst, err)
        # in turns within one process on one card: the shared-memory
        # kernel, the stream kernel, the stream kernel, the shared-memory
        # kernel (the stream kernel twice where the other cannot take the
        # shape); past K=200 a launch takes milliseconds and a graph of 2
        # launches, 5 replays, does
        order = ["stream", "stream"]
        if takes(bt_cuda, "smem", K, w, B):
            order = ["smem"] + order + ["smem"]
        runs = []
        for variant in order:
            runs.append((variant, graph_ms(
                torch,
                lambda i, v=variant: bt_cuda.solve(*sets[i % n], variant=v),
                reps=5 if long_k else 20,
                inner=2 if long_k else TIMED_INNER,
            )))
        for variant in VARIANTS:
            both = [ms for v, ms in runs if v == variant]
            t[variant] = sum(both) / len(both) if both else None
        # past K=200, the checking call above; below, the median of
        # PLAIN_REPS calls
        t["plain"] = plain_ms if long_k else median_ms(
            torch, lambda i: btridiag.solve_refined(*sets[i % n]),
            reps=PLAIN_REPS)
        # the nearest single PyTorch call: a dense solve of the assembled
        # [B, K w, K w] systems, no refinement; the assembly is not timed
        D, O, r = sets[0]
        if 4 * B * (K * w) ** 2 <= DENSE_MAX_BYTES:
            H = dense(torch, D, O)
            rhs = r.reshape(B, K * w, 1)
            t["library"] = median_ms(
                torch, lambda i: torch.linalg.solve(H, rhs),
                reps=5 if not long_k else 3)
            xd = torch.linalg.solve(H, rhs).reshape(B, K, w)
            err_d = float((xd - bt_cuda.solve(D, O, r)).abs().max())
            del H, xd
            lib = (f"torch.linalg.solve on the dense [{B}, {K * w}, "
                   f"{K * w}] systems (no refinement) {t['library']:.4f} "
                   f"ms, median of {5 if not long_k else 3}, max|x_dense "
                   f"- x_kernel| {err_d:.3e}")
        else:
            t["library"] = None
            lib = (f"library not measured: the dense [{B}, {K * w}, "
                   f"{K * w}] batch is {4 * B * (K * w) ** 2 / 1e9:.1f} GB")
        torch.cuda.empty_cache()
        t["bound"], t["bound_by"], nbytes, flops = bound(K, w, B)
        say("kernel", f"K={K} w={w} B={B} (planned {t['variant']}; {n} "
                      "input sets in turn): "
                      + ", ".join(f"{v} {ms:.4f} ms" for v, ms in runs)
                      + f", plain {t['plain']:.4f} ms (CUDA events: median "
                        f"of the replays of a graph of launches, "
                        f"{5 if long_k else 20} x "
                        f"{2 if long_k else TIMED_INNER}; plain: "
                        f"{'one call on the first set, host clock' if long_k else f'median of {PLAIN_REPS} calls'}); "
                        f"bound {t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops:.0f} flop); "
                        + lib)
        times[(K, w, B)] = t
    return worst, times


def dense(torch, D, O):
    """The systems of (D, O) as dense matrices [B, K w, K w]."""
    B, K, w, _ = D.shape
    H = torch.zeros((B, K, w, K, w), device=D.device)
    k = torch.arange(K, device=D.device)
    H[:, k, :, k, :] = D.permute(1, 0, 2, 3)
    H[:, k[:-1], :, k[1:], :] = O.permute(1, 0, 2, 3)
    H[:, k[1:], :, k[:-1], :] = O.permute(1, 0, 3, 2)
    return H.reshape(B, K * w, K * w)


def hs_batch(K, B, hessian="defect"):
    """The solver's building blocks for uas_2d at K - 1 steps, its data
    tiled over B lanes on the card, under ``hessian``."""
    from etol_tpu_torch.core import problem
    from etol_tpu_torch.models import problems
    from etol_tpu_torch.solve import al_sqp

    vgp, nlp = problems.uas_2d(nsteps=K - 1)
    data, _ = vgp.to_device()
    return al_sqp._ALFuncs(nlp, al_sqp.SolverConfig(hessian=hessian),
                           problem.batch_tile(data, B))


def hs_inputs(torch, F, seed):
    """(Z, lam_def, rho) for F's batch from ``seed``: Z uniform inside the
    bounds, the multipliers uniform within +-HS_LAM, rho log-uniform from
    HS_RHO_LO to rho_max."""
    import math

    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, K, w = F.lb.shape

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    Z = F.lb + u(B, K, w) * (F.ub - F.lb)
    lam = HS_LAM * (2.0 * u(B, K - 1, F.cscale.shape[1]) - 1.0)
    lo, hi = math.log(HS_RHO_LO), math.log(F.cfg.rho_max)
    return Z, lam, torch.exp(lo + (hi - lo) * u(B))


def hs_kernel(F, Z, lam, rho):
    return HS.coupling(F.nlp.dynamics, Z, lam, rho, F.cscale.contiguous(),
                       F.data.dt.contiguous(), exact=F.cfg.hessian != "gn")


def hs_plain(F, Z, lam, rho):
    return F._lanes(F._pair_coupling, F.cscale, Z, lam, rho)


def check_hs(torch, shapes):
    """Phase 3, the step coupling's kernel: against ``_pair_coupling`` at
    each of ``shapes`` of the unicycle's width under HS_HESSIANS, then
    timed beside the plain version at the main path's shapes and B=1, and
    one trip's ops counted on each route; returns (the largest max
    |diff| / max |plain|, times by shape, the trip's counts)."""
    global HS_CHECKED
    HS_CHECKED = set()
    from etol_tpu_torch.models import dynamics

    model = HS.models()[dynamics.unicycle]
    w = model.nx + model.nu
    worst = 0.0
    for i, (K, w_, B) in enumerate(
            s for s in shapes if s[1] == w and s[0] >= 2):
        errs = {}
        for hessian in HS_HESSIANS:
            F = hs_batch(K, B, hessian)
            if F.coupling != "kernel":
                raise AssertionError(f"uas_2d at {(K, w, B)} on the card "
                                     "took the plain coupling route")
            Z, lam, rho = hs_inputs(torch, F, seed=K + B + i)
            ref = hs_plain(F, Z, lam, rho)
            got = hs_kernel(F, Z, lam, rho)
            torch.cuda.synchronize()
            errs[hessian] = [float((g - r).abs().max() / r.abs().max())
                             for g, r in zip(got, ref)]
            del F, ref, got
        say("kernel", f"hs_coupling K={K} w={w} B={B}: max|diff| / "
                      "max|plain| (Dc, O) " + ", ".join(
                          f"{h} {e[0]:.2e} {e[1]:.2e}"
                          for h, e in errs.items())
                      + f" (limit {HS_TOL:.0e})")
        top = max(max(e) for e in errs.values())
        if not top <= HS_TOL:
            raise AssertionError(
                f"hs_coupling disagrees with _pair_coupling at "
                f"{(K, w, B)}: {errs}")
        worst = max(worst, top)
        HS_CHECKED.add((K, w, B))
    torch.cuda.empty_cache()

    times = {}
    for K, w_, B in MAIN_SHAPES + (B1_SHAPE,):
        F = hs_batch(K, B)
        sets = [hs_inputs(torch, F, seed=B + j) for j in range(3)]
        n = len(sets)
        runs = []
        # in turns: kernel, plain, plain, kernel; each a CUDA graph
        for side in ("kernel", "plain", "plain", "kernel"):
            fn = hs_kernel if side == "kernel" else hs_plain
            runs.append((side, graph_ms(
                torch, lambda i, f=fn: f(F, *sets[i % n]),
                reps=20 if side == "kernel" else 5,
                inner=HS_INNER if side == "kernel" else HS_PLAIN_INNER)))
        flops, nbytes = HS.cost(K, w, model.nx, B)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / FP32_FLOPS * 1e3
        t = {side: sum(ms for s_, ms in runs if s_ == side) / 2
             for side in ("kernel", "plain")}
        t.update(bound=max(t_bytes, t_flops),
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 bytes=nbytes, flops=flops)
        say("kernel", f"hs_coupling K={K} w={w} B={B}: "
                      + ", ".join(f"{side} {ms:.4f} ms" for side, ms in runs)
                      + f" (CUDA events: median of the replays of a graph "
                        f"of {HS_INNER} launches, 20 replays; plain "
                        f"_pair_coupling a graph of {HS_PLAIN_INNER} "
                        f"calls, 5 replays); bound {t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops} flop), "
                        f"{100 * t['bound'] / t['kernel']:.1f}% of it")
        times[(K, w, B)] = t
        del F, sets
        torch.cuda.empty_cache()
    return worst, times, hs_trip_ops(torch)


def hs_trip_ops(torch):
    """One trip of the bench's problem and config (uas_2d N=50,
    HS_COUNT_B lanes, cold start) on each coupling route: the non-view
    aten ops it dispatches and the hand-written kernels it launches."""
    import copy

    from torch.utils._python_dispatch import TorchDispatchMode

    from etol_tpu_torch import bench_harness
    from etol_tpu_torch.core.problem import map_lanes
    from etol_tpu_torch.ops import bt_cuda
    from etol_tpu_torch.solve import al_sqp

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    nlp, cfg, _, data, _ = bench_harness.prepare(HS_COUNT_B, MAIN_NSTEPS,
                                                 seed=1)
    F = al_sqp._ALFuncs(nlp, cfg, data)
    st = al_sqp._start(F, cfg, map_lanes(nlp.initial_guess, data),
                       al_sqp.init_multipliers(nlp, data))
    exps = al_sqp._exponents(cfg, F.dtype, F.lb.device)
    active = al_sqp._active(cfg, st, cfg.max_outer * cfg.max_inner)
    out = {}
    for route in ("plain", "kernel"):
        G = copy.copy(F)
        G.coupling = route
        before = HS.TALLY.count, bt_cuda.TALLY.count
        with Count() as count:
            al_sqp._trip(G, cfg, st, exps, active)
        torch.cuda.synchronize()
        hs, kkt = HS.TALLY.count - before[0], bt_cuda.TALLY.count - before[1]
        out[route] = dict(aten_ops=count.ops, hs_launches=hs,
                          kkt_launches=kkt, launches=count.ops + hs + kkt)
        say("kernel", f"one uas_2d trip at B={HS_COUNT_B}, coupling "
                      f"{route}: {count.ops} non-view aten ops, {hs} step "
                      f"coupling and {kkt} KKT kernel launches")
    return out


def ls_family(K, w):
    """One problem of the separable family at (K, w) on the card, (nlp,
    data): ocp_2d_ex1.xml through the facade (33, 4), pm3d's
    point_mass_3d (41, 6), the dry run's long-horizon single integrator
    (w = 4 at the other horizons)."""
    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.parallel import dryrun

    if (K, w) == (33, 4):
        topt = TrajectoryOptimizer()
        topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
        topt.set_dynamics(dynamics.single_integrator)
        topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
        topt.setup()
        return topt.nlp, topt.data
    if (K, w) == (41, 6):
        vgp, nlp = problems.point_mass_3d(nsteps=K - 1)
        return nlp, vgp.to_device()[0]
    nlp, data, _ = dryrun.horizon_problem(K - 1, "cuda")
    return nlp, data


def ls_batch(torch, K, w, n, B, seed):
    """The family's problem over B lanes, starts moved within +-0.05, a
    loop state two plain-route trips from the cold start with its
    multipliers redrawn (so that every AL term counts), and the pass's
    inputs there: (F, cfg, st, grad, p, ref, exps); F takes the kernel
    route."""
    import copy
    import math

    from etol_tpu_torch.core.problem import batch_tile, map_lanes
    from etol_tpu_torch.solve import al_sqp

    nlp, one = ls_family(K, w)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    data = batch_tile(one, B)
    data = dataclasses.replace(
        data, x0=data.x0 + 0.1 * (u(*data.x0.shape) - 0.5))
    cfg = al_sqp.SolverConfig(ls_grid=n)
    F = al_sqp._ALFuncs(nlp, cfg, data)
    if F.line_search != "kernel":
        raise AssertionError(f"the family at {(K, w, B)} on the card took "
                             "the plain line search")
    P = copy.copy(F)
    P.line_search = "plain"
    st = al_sqp._start(P, cfg, map_lanes(nlp.initial_guess, data),
                       al_sqp.init_multipliers(nlp, data))
    exps = al_sqp._exponents(cfg, F.dtype, F.lb.device)
    for _ in range(2):
        st = al_sqp._trip(P, cfg, st, exps, al_sqp._active(cfg, st, 10**6))
    st["lam_def"] = LS_LAM * (2.0 * u(*st["lam_def"].shape) - 1.0)
    st["mu"] = LS_MU * u(*st["mu"].shape)
    lo, hi = math.log(LS_RHO[0]), math.log(LS_RHO[1])
    st["rho"] = torch.exp(lo + (hi - lo) * u(B))
    m = (st["Z"], st["lam_def"], st["lam_eq"], st["mu"], st["rho"])
    grad = F.al_grad(*m)
    p, _ = F.direction(st["Z"], grad, *m[1:], st["lm"], st["g"])
    ref = F.al_from_parts(st["cost"], st["cd"], st["ce"], st["g"], *m[1:])
    return F, cfg, st, grad, p, ref, exps


def ls_plain(F, st, grad, p, exps):
    """The plain route's candidate pass as ``al_sqp._body`` runs it:
    (Zc, valc, decc, cdc, gc, costc)."""
    import torch

    Z = st["Z"]
    Zc = torch.clamp(
        Z[:, None] + (0.5 ** exps)[None, :, None, None] * p[:, None],
        F.lb[:, None], F.ub[:, None])
    (cdc, cec, gc), costc = F.candidate_residuals(Zc)
    valc = F.al_from_parts(costc, cdc, cec, gc, st["lam_def"][:, None],
                           st["lam_eq"][:, None], st["mu"][:, None],
                           st["rho"][:, None])
    decc = torch.sum(grad[:, None] * (Zc - Z[:, None]), dim=(2, 3))
    return Zc, valc, decc, cdc, gc, costc


def ls_route(F, st, grad, p, exps):
    """The kernel route's pass: (Zc, valc, decc), the cost added."""
    Zc, part, dec = F.ls_kernel(st["Z"], p, grad, 0.5 ** exps,
                                st["lam_def"], st["mu"], st["rho"])
    return Zc, F.candidate_cost(Zc) + part, dec


def ls_magnitudes(torch, st, grad, Zc, cdc, gc, costc):
    """The sums of the magnitudes of each candidate's terms, [B, n]: 1 +
    |cost| + |lam c| + rho/2 c^2 + (s^2 + mu^2)/(2 rho) for its value, 1 +
    |grad (Zc - Z)| for its decrease."""
    rho, mu = st["rho"][:, None], st["mu"][:, None]
    s = torch.clamp(mu + rho[..., None, None] * gc, min=0.0)
    val = (1.0 + costc.abs()
           + (st["lam_def"][:, None] * cdc).abs().sum(dim=(-2, -1))
           + 0.5 * rho * (cdc ** 2).sum(dim=(-2, -1))
           + (0.5 / rho) * (s * s + mu * mu).sum(dim=(-2, -1)))
    dec = 1.0 + (grad[:, None] * (Zc - st["Z"][:, None])).abs().sum(
        dim=(-2, -1))
    return val, dec


def ls_pick(torch, rule, c1, valc, decc, ref):
    """The Armijo test and the pick of ``al_sqp._body`` under ``rule``:
    (sel, the margins ref + c1 dec - val)."""
    margin = ref[:, None] + c1 * decc - valc
    ok = (margin >= 0) & torch.isfinite(valc) & (decc < 0.0)
    if rule == "best":
        sel = torch.argmin(torch.where(
            ok, valc, torch.full_like(valc, float("inf"))), dim=1)
    else:
        sel = torch.argmax(ok.to(torch.int32), dim=1)
    return sel, margin


def ls_decided(torch, rule, sel, valc, decc, margin, scale, dtol):
    """Lanes whose pick no difference within ``scale`` of a candidate's
    value and ``dtol`` of its decrease can move: for "first" every
    candidate before the pick clearly fails and the pick clearly passes;
    for "best" the pick clearly passes and every other candidate clearly
    fails or lies more than twice the tolerance above it; where none
    passes, every candidate clearly fails."""
    passes = (margin > scale) & (decc < -dtol) & torch.isfinite(valc)
    fails = (margin < -scale) | (decc > dtol) | ~torch.isfinite(valc)
    lanes = torch.arange(valc.shape[0], device=valc.device)
    j = torch.arange(valc.shape[1], device=valc.device)[None, :]
    if rule == "best":
        others = (fails | (valc > valc[lanes, sel][:, None] + 2 * scale)
                  | (j == sel[:, None]))
    else:
        others = fails | (j >= sel[:, None])
    return fails.all(dim=1) | (passes[lanes, sel] & others.all(dim=1))


def check_ls(torch, shapes):
    """Phase 3, the line search's kernel: against the plain candidate pass
    at each of ``shapes`` of a separable family (LS_GRIDS), each
    candidate's AL value and decrease within LS_TOL of its terms'
    magnitudes, its point bitwise, the pick the plain route's on every
    lane no such difference can move (under both rules), and the chosen
    step's point, defects and rows at the plain pick; then timed beside
    the plain pass at each of those shapes, and one ocp_2d_ex1 trip's ops
    counted on each route; returns (the largest difference over its
    magnitude, times by shape, the trip's counts)."""
    global LS_CHECKED
    LS_CHECKED = set()
    worst = 0.0
    for i, (K, w, B) in enumerate(s for s in shapes if s[:2] in LS_GRIDS):
        n = LS_GRIDS[(K, w)]
        F, cfg, st, grad, p, ref, exps = ls_batch(torch, K, w, n, B,
                                                  seed=K + B + i)
        Zc, valc, decc, cdc, gc, costc = ls_plain(F, st, grad, p, exps)
        kZc, kval, kdec = ls_route(F, st, grad, p, exps)
        mval, mdec = ls_magnitudes(torch, st, grad, Zc, cdc, gc, costc)
        err = max(float(((kval - valc).abs() / mval).max()),
                  float(((kdec - decc).abs() / mdec).max()))
        picks = {}
        for rule in ("first", "best"):
            sel, margin = ls_pick(torch, rule, cfg.ls_c1, valc, decc, ref)
            ksel, _ = ls_pick(torch, rule, cfg.ls_c1, kval, kdec, ref)
            decided = ls_decided(torch, rule, sel, valc, decc, margin,
                                 LS_TOL * mval, LS_TOL * mdec)
            picks[rule] = (int(decided.sum()), bool(torch.equal(
                ksel[decided], sel[decided])), sel)
        sel = picks["first"][2]
        lanes = torch.arange(B, device="cuda")
        Zs, cd, g = F.ls_kernel(st["Z"], p, grad, 0.5 ** exps,
                                st["lam_def"], st["mu"], st["rho"], sel)
        torch.cuda.synchronize()
        chosen = [float((a - b).abs().max()) / (1.0 + float(
            b.abs().max())) if b.numel() else 0.0
            for a, b in ((cd, cdc[lanes, sel]), (g, gc[lanes, sel]))]
        same_z = bool(torch.equal(kZc, Zc)) and bool(
            torch.equal(Zs, Zc[lanes, sel]))
        say("kernel", f"ls_candidates K={K} w={w} n={n} B={B}: max|diff| / "
                      f"magnitude {err:.2e} (limit {LS_TOL:.0e}); points "
                      f"bitwise {same_z}; picks the plain route's on the "
                      + ", ".join(f"{d} decided lanes of {B} ({rule}): {ok}"
                                  for rule, (d, ok, _) in picks.items())
                      + f"; the chosen step's defects and rows "
                        f"{chosen[0]:.2e} {chosen[1]:.2e}")
        if not (err <= LS_TOL and same_z and max(chosen) <= LS_TOL
                and all(ok for _, ok, _ in picks.values())):
            raise AssertionError(
                f"ls_candidates disagrees with the plain pass at "
                f"{(K, w, n, B)}: {err}, {same_z}, {picks}, {chosen}")
        worst = max(worst, err, *chosen)
        LS_CHECKED.add((K, w, n, B))
        del F, st, Zc, valc, decc, cdc, gc, costc, kZc, kval, kdec
        torch.cuda.empty_cache()

    times = {}
    for K, w, n, B in sorted(LS_CHECKED, key=lambda s: (s[:2], -s[3])):
        F, cfg, st, grad, p, ref, exps = ls_batch(torch, K, w, n, B, seed=B)
        alphas = 0.5 ** exps
        kargs = (st["Z"], p, grad, alphas, st["lam_def"], st["mu"],
                 st["rho"])
        sel = torch.zeros((B,), dtype=torch.int64, device="cuda")
        lanes = torch.arange(B, device="cuda")

        def route(i):
            # what _body runs on the kernel route up to the pick's
            # gathers: the candidates' launch, the cost, the chosen launch
            Zc, valc, decc = ls_route(F, st, grad, p, exps)
            return (F.ls_kernel(*kargs, sel), valc[lanes, sel])

        def plain(i):
            # and on the plain route: the pass and the chosen step's
            # gathers
            Zc, valc, decc, cdc, gc, costc = ls_plain(F, st, grad, p, exps)
            return (Zc[lanes, sel], cdc[lanes, sel], gc[lanes, sel],
                    valc[lanes, sel])

        sides = {
            "kernel": (lambda i: F.ls_kernel(*kargs), 20, LS_INNER),
            "route": (route, 20, LS_INNER),
            "plain": (plain, 5, LS_PLAIN_INNER)}
        runs = []
        # in turns: kernel, route, plain, plain, route, kernel; each a CUDA
        # graph
        for side in ("kernel", "route", "plain", "plain", "route",
                     "kernel"):
            fn, reps, inner = sides[side]
            runs.append((side, graph_ms(torch, fn, reps=reps, inner=inner)))
        o, tr = F.data.obstacles, F.data.tracks
        ell, pcs, trk = LS._forms(F.nlp)
        flops, nbytes = LS.cost(
            K, F.nlp.dims.nx, F.nlp.dims.nu, n, B,
            E=ell * o.ellipses.shape[1], P=pcs * o.piece_mask.shape[1],
            H=pcs * o.halfspaces.shape[2], T=trk * tr.radius.shape[1],
            D=trk * F.track_ctrs.shape[-1])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / FP32_FLOPS * 1e3
        t = {side: sum(ms for s_, ms in runs if s_ == side) / 2
             for side in sides}
        t.update(bound=max(t_bytes, t_flops),
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 bytes=nbytes, flops=flops)
        say("kernel", f"ls_candidates K={K} w={w} n={n} B={B}: "
                      + ", ".join(f"{side} {ms:.4f} ms" for side, ms in runs)
                      + f" (CUDA events: median of the replays of a graph; "
                        f"the candidates' launch and the route's pass (that "
                        f"launch, the cost, the chosen launch) {LS_INNER} "
                        f"calls, 20 replays; the plain pass with the "
                        f"chosen step's gathers {LS_PLAIN_INNER} calls, 5 "
                        f"replays); route / plain "
                        f"{t['route'] / t['plain']:.3f}; bound "
                        f"{t['bound']:.6f} ms by "
                        f"{t['bound_by']} ({nbytes} B, {flops} flop), "
                        f"{100 * t['bound'] / t['kernel']:.1f}% of it")
        times[(K, w, n, B)] = t
        del F, st
        torch.cuda.empty_cache()
    return worst, times, ls_trip_ops(torch)


def ls_trip_ops(torch):
    """One ocp_2d_ex1 trip at LS_COUNT_B lanes from the cold start on each
    line-search route: the non-view aten ops it dispatches and the
    hand-written kernels it launches."""
    import copy

    from torch.utils._python_dispatch import TorchDispatchMode

    from etol_tpu_torch.core.problem import batch_tile, map_lanes
    from etol_tpu_torch.ops import bt_cuda
    from etol_tpu_torch.solve import al_sqp

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    nlp, one = ls_family(33, 4)
    data = batch_tile(one, LS_COUNT_B)
    cfg = al_sqp.SolverConfig()
    F = al_sqp._ALFuncs(nlp, cfg, data)
    st = al_sqp._start(F, cfg, map_lanes(nlp.initial_guess, data),
                       al_sqp.init_multipliers(nlp, data))
    exps = al_sqp._exponents(cfg, F.dtype, F.lb.device)
    active = al_sqp._active(cfg, st, cfg.max_outer * cfg.max_inner)
    out = {}
    for route in ("plain", "kernel"):
        G = copy.copy(F)
        G.line_search = route
        before = LS.TALLY.count, bt_cuda.TALLY.count
        with Count() as count:
            al_sqp._trip(G, cfg, st, exps, active)
        torch.cuda.synchronize()
        ls, kkt = LS.TALLY.count - before[0], bt_cuda.TALLY.count - before[1]
        out[route] = dict(aten_ops=count.ops, ls_launches=ls,
                          kkt_launches=kkt, launches=count.ops + ls + kkt)
        say("kernel", f"one ocp_2d_ex1 trip at B={LS_COUNT_B}, line search "
                      f"{route}: {count.ops} non-view aten ops, {ls} line "
                      f"search and {kkt} KKT kernel launches")
    return out


def host_ms(torch, fn, reps, warm=True):
    """Median host-clock milliseconds of ``fn()`` followed by a device
    sync, after one warm-up call (none with ``warm`` off, for calls that
    take seconds): what a caller that waits for the answer sees."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def check_cr(torch, bt_cuda, btridiag, cyclic_reduction):
    """Phase 6: cyclic reduction against the plain version and the kernel,
    then the B=1 route table; returns {K: dict(scan, cr, kernel,
    variant)} in milliseconds."""
    for i, (K, w, B) in enumerate(CR_SHAPES):
        D, O, r = spd_problem(torch, B, K, w, seed=100 + i)
        xp = btridiag.solve_refined(D, O, r)
        xc = cyclic_reduction.solve_refined(D, O, r)
        limit = 2e-4 * (1.0 + float(xp.abs().max()))
        err_p = float((xc - xp).abs().max())
        msg = (f"K={K} w={w} B={B}: max|x_cr - x_plain| {err_p:.3e} "
               f"(limit {limit:.3e})")
        if not err_p <= limit:
            raise AssertionError(f"cyclic reduction disagrees: {msg}")
        if w <= bt_cuda.MAX_W:
            err_k = float((xc - bt_cuda.solve(D, O, r)).abs().max())
            msg += f", max|x_cr - x_kernel| {err_k:.3e}"
            if not err_k <= limit:
                raise AssertionError(
                    f"cyclic reduction and the kernel disagree: {msg}")
        else:
            try:
                bt_cuda.solve(D, O, r)
            except ValueError:
                msg += ", the kernel's wrapper refuses this width"
            else:
                raise AssertionError(f"bt_cuda.solve took w={w}")
        say("cr", msg)

    table = {}
    w = 5
    for K in B1_HORIZONS:
        D, O, r = spd_problem(torch, 1, K, w, seed=K)
        variant = bt_cuda.plan(K, w, 1).variant
        row = dict(
            # one call at the long horizons, with no warm-up: the scan
            # takes 1.4 s and 5.2 s there
            scan=host_ms(torch, lambda: btridiag.solve_refined(D, O, r),
                         reps=1 if K > 200 else 7, warm=K <= 200),
            cr=host_ms(torch,
                       lambda: cyclic_reduction.solve_refined(D, O, r),
                       reps=11),
            kernel=host_ms(torch, lambda: bt_cuda.solve(D, O, r), reps=21),
            variant=variant,
        )
        xk = bt_cuda.solve(D, O, r)
        xc = cyclic_reduction.solve_refined(D, O, r)
        err = float((xk - xc).abs().max())
        if not err <= 2e-4 * (1.0 + float(xc.abs().max())):
            raise AssertionError(f"B=1 K={K}: kernel and cr differ {err}")
        say("cr", f"B=1 K={K} w={w}: scan {row['scan']:.3f} ms, cyclic "
                  f"reduction {row['cr']:.3f} ms, kernel ({variant}) "
                  f"{row['kernel']:.3f} ms (host clock with a sync, "
                  f"median); max|x_kernel - x_cr| {err:.3e}")
        table[K] = row
    return table


def reset_counts(bt_cuda, cyclic_reduction):
    """Every route's count to 0, just before a path is driven (what the
    device loops ran before is read first, and goes to no path)."""
    TG.settle()
    bt_cuda.TALLY.clear()
    cyclic_reduction.TALLY.clear()
    LS_BASE.clear()
    LS_BASE.update(LS.TALLY.by)


def ls_gained():
    """The line search kernel's launches by (K, w, n, B) since the last
    reset_counts (settled by the caller)."""
    return {k: v - LS_BASE.get(k, 0) for k, v in LS.TALLY.by.items()
            if v > LS_BASE.get(k, 0)}


def assert_ls_trips(path, kkt_by):
    """Fail unless the line search kernel launched twice a trip since the
    last reset_counts at the (K, w) of LS_GRIDS and nowhere else, a trip
    being a KKT kernel launch at (K, w, B) in ``kkt_by``; returns the
    launches."""
    want = {}
    for (_, K, w, B), n in kkt_by.items():
        if (K, w) in LS_GRIDS:
            key = (K, w, LS_GRIDS[(K, w)], B)
            want[key] = want.get(key, 0) + 2 * n
    got = ls_gained()
    if got != want:
        raise AssertionError(
            f"{path}: line search kernel launches {got}, expected {want}: "
            f"two a trip where the route takes the problem, else none")
    return got


def latest(kind):
    """The most recently used cached entry of ``kind`` (``TG._Entry``, a
    loop's, or ``TG._Program``, a seed's or a planner's)."""
    return next(e for e in reversed(TG._CACHE.values())
                if isinstance(e, kind))


def replay_ms(torch, graph, reps=GRAPH_REPS, runs=3):
    """The card's time for one replay of ``graph``: the median over
    ``runs`` of ``reps`` replays back to back between two CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(torch, lambda: [
        graph.replay() for _ in range(reps)], runs, reps)


def trip_device_ms(torch, reps=GRAPH_REPS):
    """The card's time for one trip of the most recently used loop key:
    its graph replayed back to back. The loop has ended, so these trips
    are frozen and change nothing; they are not counted as launches of a
    path."""
    return replay_ms(torch, latest(TG._Entry).graph, reps)


def graph_side(torch, bt_cuda, cyclic_reduction, label, run, route=None,
               lag=None):
    """``run()`` under ``trip_graph.override(route, lag)``, timed with the
    host clock around work that ends in a sync; returns (its result, a
    dict of its counts and of the device memory its run held at its peak
    over what was held before)."""
    reset_counts(bt_cuda, cyclic_reduction)
    c0 = dict(TG.COUNTS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TG.override(route, lag):
        out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    TG.settle()
    c = {k: TG.COUNTS[k] - c0[k] for k in c0}
    side = dict(
        wall_s=wall, trips=c["trips"] + c["eager_trips"],
        idle_trips=c["idle_trips"], captures=c["captures"],
        capture_s=c["capture_s"], programs=c["programs"],
        launches=bt_cuda.TALLY.count,
        launches_by={"%s_K%d_w%d_B%d" % k: n
                     for k, n in sorted(bt_cuda.TALLY.by.items())},
        pool_bytes=TG.pool_bytes(), static_bytes=TG.static_bytes(),
        peak_bytes=torch.cuda.max_memory_allocated() - held)
    side["ms_a_trip"] = 1e3 * wall / max(side["trips"], 1)
    assert_checked(f"graph {label}", bt_cuda.TALLY.by)
    return out, side


def same_result(torch, a, b, fields=("z", "obj", "lam_def", "lam_eq", "mu",
                                     "rho", "grad_norm")):
    """max |a - b| over the float fields (0.0 where bitwise equal) and
    whether statuses and iteration counts are equal."""
    diff = 0.0
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            diff = max(diff, float((x - y).abs().max()))
    counts_equal = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "status", "inner_iters", "outer_iters"))
    return diff, counts_equal


def check_graph(torch, bench_harness, bt_cuda, cyclic_reduction):
    """Phase 4b: the bench's seeds on their program's graph
    (:func:`check_seeds`)."""
    from etol_tpu_torch.models.tuned import tuned_extras

    out = {"seeds": {}}
    nlp, _, _, data, gen = bench_harness.prepare(MAIN_B, MAIN_NSTEPS)
    check_seeds(torch, bt_cuda, cyclic_reduction, nlp, data, gen,
                tuned_extras("uas_2d"), out["seeds"])
    return out


def bitwise(torch, a, b):
    """Whether two results (trees of tensors) are bitwise equal, and the
    largest difference of their float leaves."""
    from etol_tpu_torch.core.problem import tree_flatten

    diff, equal = 0.0, True
    for x, y in zip(tree_flatten(a), tree_flatten(b)):
        if not torch.equal(x, y):
            equal = False
            if x.is_floating_point():
                diff = max(diff, float((x - y).abs().max()))
            else:
                diff = float("inf")
    return equal, diff


def loop_side(torch, bt_cuda, cyclic_reduction, label, run, route):
    """:func:`graph_side` with the device loop's counts: the trips its
    condition kernel ran, its launches and the launches of graphs that
    hold a loop."""
    TG.settle()
    g0 = (GL.LAUNCHES, GL.TRIPS, TG.COUNTS["loop_graphs"])
    out, side = graph_side(torch, bt_cuda, cyclic_reduction, label, run,
                           route)
    side.update(cond_launches=GL.LAUNCHES - g0[0],
                loop_trips=GL.TRIPS - g0[1],
                graph_launches=TG.COUNTS["loop_graphs"] - g0[2])
    return out, side


def absorb(entries):
    """Count the device counters' gains of ``entries`` (from launches made
    only to time them) as read, so no path's counts take them."""
    for e in entries:
        e.read = tuple(e.counts.tolist())


def loop_ms(torch, reps=LOOP_BENCH_TRIPS):
    """The loop's own cost a trip, on a body of two small kernels (a
    counter and its flag): the device loop (one graph launch between CUDA
    events), inserted with a stamp slot as the solver's loops are,
    against the plain version, the same body replayed with the flag read
    on the host each trip (host clock, medians of 3 runs). The slot's
    trips and runs must match the loop's device counters."""
    dev = torch.device("cuda")
    n = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    slot = torch.zeros(GL.SLOT, dtype=torch.int64, device=dev)

    def body():
        n.add_(1)
        flag.copy_(n < reps)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        body()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        GL.insert(graph.raw_cuda_graph(), flag, counts, slot)

    def reset():
        n.zero_()
        flag.fill_(True)

    def device_loop():
        reset()
        outer.replay()

    def plain():
        reset()
        GL.plain(graph.replay, flag)

    dev_ms = _median_event_ms(torch, device_loop, 3, reps)
    if int(n) != reps or counts.tolist()[1] % reps:
        raise AssertionError(f"the timed device loop ran {int(n)} trips, "
                             f"not {reps}")
    launches, trips = counts.tolist()
    stamped = dict(zip(GL.SLOT_FIELDS, slot.tolist()))
    if (stamped["trips"], stamped["runs"]) != (trips, launches - trips) \
            or stamped["ns"] <= 0:
        raise AssertionError(f"the loop's stamp slot {stamped} does not "
                             f"match its counters ({trips} trips in "
                             f"{launches - trips} runs)")
    plain_ms = host_ms(torch, plain, 3) / reps
    return dict(ms=dev_ms, plain_ms=plain_ms, trips=reps,
                bound_ms=1e3 * LOOP_COND_BYTES / HBM_BYTES_PER_S,
                bound_by="bytes")


def check_loop(torch, bench_harness, bt_cuda, cyclic_reduction):
    """Phase 4c: the solver loop as one graph launch with its stop test on
    the card (a while node, ``ops/graph_loop.py``) against the eager loop
    (a host sync a trip) and the replayed trip (the host reads the flag
    a trip late): (i) the main path's phase-1 cold solve (uas_2d N=50,
    B=MAIN_B, the bench's seeds), (ii) the whole staged cold solve at
    B=MAIN_B with the bench's stages (on the device loop one captured
    program: phase 1, each stage's gather and loop, the merges), (iii)
    LOOP_MPC_STEPS MPC ticks at B=1. Each kind's loop keys and staged
    programs are dropped first, so its first use on the device loop makes
    them. Sides in turns: eager, the device loop's first use, replay,
    device loop, device loop, replay (the MPC: eager, first use, replay,
    replay, device loop). Every device-loop result must be bitwise the
    eager route's (the MPC's cold solve and every tick), the replays
    within GRAPH_TOL (the MPC's too); the device loop runs no idle trip,
    launches the kernel once a trip and launches one graph a solve;
    captures happen on a key's first use only. Each side: trips (the
    device counter's on the device loop), launches, idle trips, ms a
    trip, the card's own trip (the trip's graph replayed back to back)
    and the busy share (trips times that over the wall time), graph
    launches, captures, capture seconds, pool bytes. Then the loop's own
    cost a trip on a two-kernel body (:func:`loop_ms`)."""
    from etol_tpu_torch.models.tuned import tuned_extras
    from etol_tpu_torch.solve import al_sqp, shooting

    out = {"versions": dict(GL.VERSIONS, torch_cuda=torch.version.cuda),
           "phase1": {}, "staged": {}, "mpc": {}}
    nlp, cfg, stages, data, gen = bench_harness.prepare(MAIN_B, MAIN_NSTEPS)
    extras = tuned_extras("uas_2d")
    z0 = shooting.plan_guess(nlp, data, extras["seed_walks"], gen,
                             pulled=extras["seed_pulled"])
    def drop():
        """Every loop key and staged program, so that a kind's first use
        here makes its own."""
        TG.settle()
        for key in [k for k, e in TG._CACHE.items()
                    if isinstance(e, TG._Entry) or e.parts]:
            del TG._CACHE[key]

    sides = (("eager", "eager"), ("loop_first", None), ("replay", "replay"),
             ("loop", None), ("loop_again", None),
             ("replay_again", "replay"))

    def run_sides(kind, run, sides=sides):
        drop()
        results = {}
        for name, route in sides:
            results[name], out[kind][name] = loop_side(
                torch, bt_cuda, cyclic_reduction, f"loop {kind} {name}", run,
                route)
        return results

    def held(kind, results, ref, trips):
        """Each side against the eager one: bitwise on the device loop,
        within GRAPH_TOL on the replay; the device loop's counts."""
        for name, side in out[kind].items():
            equal, diff = bitwise(torch, ref, results[name])
            side.update(bitwise=equal, max_abs_diff=diff)
            if name.startswith("loop"):
                if not equal:
                    raise AssertionError(
                        f"loop {kind} {name}: not bitwise the eager "
                        f"route's (max |d| {diff})")
                if side["idle_trips"] or side["launches"] != trips or \
                        side["trips"] != trips:
                    raise AssertionError(
                        f"loop {kind} {name}: {side['launches']} launches "
                        f"and {side['trips']} trips ({side['idle_trips']} "
                        f"idle) for {trips}: one launch a trip, no idle "
                        "trip")
            elif name.startswith("replay") and not diff <= GRAPH_TOL:
                raise AssertionError(f"loop {kind} {name}: max |d| {diff}")

    # (i) phase 1
    def phase1():
        return al_sqp.solve_batched(nlp, cfg, data, z0)

    results = run_sides("phase1", phase1)
    ref = results["eager"]
    trips = int(ref.inner_iters.max())
    held("phase1", results, ref, trips)
    dev_ms = trip_device_ms(torch)
    for name, side in out["phase1"].items():
        side.update(device_ms_a_trip=dev_ms,
                    busy=dev_ms * side["trips"] / (1e3 * side["wall_s"]))
        say("loop", f"phase 1, uas_2d N={MAIN_NSTEPS} B={MAIN_B}, {name}: "
                    f"{json.dumps(side)}")
    p1 = out["phase1"]
    if tuple(p1[n]["graph_launches"] for n in (
            "loop_first", "loop", "loop_again")) != (1, 1, 1) or tuple(
            p1[n]["programs"] for n in (
            "loop_first", "replay", "loop", "loop_again")) != (
            1, 0, 1, 1) or tuple(
            p1[n]["captures"] for n in (
            "loop_first", "replay", "loop", "loop_again",
            "replay_again")) != (2, 0, 0, 0, 0) or (
            p1["loop"]["loop_trips"] != trips):
        raise AssertionError("phase 1 as one program: two captures on its "
                             "first use (the trip, the program) and none "
                             "after, one program call and one graph launch "
                             "a solve running every trip")
    say("loop", f"phase 1: {trips} trips; ms a trip eager "
                f"{p1['eager']['ms_a_trip']:.3f}, replay "
                f"{p1['replay']['ms_a_trip']:.3f} / "
                f"{p1['replay_again']['ms_a_trip']:.3f}, device loop "
                f"{p1['loop']['ms_a_trip']:.3f} / "
                f"{p1['loop_again']['ms_a_trip']:.3f}, the card's own "
                f"{dev_ms:.3f}")

    # (ii) the staged cold solve
    def cold():
        return al_sqp.solve_batched_staged(nlp, cfg, data, z0, stages,
                                           return_stage_trips=True)

    results = run_sides("staged", cold)
    ref, stage_trips = results["eager"]
    program = next(e for e in reversed(TG._CACHE.values())
                   if isinstance(e, TG._Program) and e.parts)
    torch.cuda.synchronize()
    staged_dev_ms = _median_event_ms(torch, program.graph.replay, 3, 1)
    torch.cuda.synchronize()
    absorb(program.parts)
    for name, side in out["staged"].items():
        side.update(stage_trips=list(results[name][1]),
                    device_ms=staged_dev_ms,
                    busy=staged_dev_ms / (1e3 * side["wall_s"]))
        if side["stage_trips"] != list(stage_trips):
            raise AssertionError(f"loop staged {name}: stage trips "
                                 f"{side['stage_trips']}, eager "
                                 f"{list(stage_trips)}")
    held("staged", {k: v[0] for k, v in results.items()}, ref,
         sum(stage_trips))
    for name, side in out["staged"].items():
        say("loop", f"staged cold solve, uas_2d N={MAIN_NSTEPS} "
                    f"B={MAIN_B}, stages {stages}, {name}: "
                    f"{json.dumps(side)}")
    st = out["staged"]
    if (st["loop"]["graph_launches"], st["loop_again"]["graph_launches"],
            st["loop"]["programs"], st["loop_first"]["captures"]) != (
            1, 1, 1, len(stages) + 2) or any(
            st[n]["captures"] for n in (
                "replay", "loop", "loop_again", "replay_again")):
        raise AssertionError(
            "the staged solve on the device loop: its first use captures "
            "each loop's trip and the program, then one launch of the "
            "program's graph a solve and no capture")
    say("loop", f"staged cold solve: stage trips {list(stage_trips)}; wall "
                f"ms eager {1e3 * st['eager']['wall_s']:.1f}, replay "
                f"{1e3 * st['replay']['wall_s']:.1f} / "
                f"{1e3 * st['replay_again']['wall_s']:.1f}, device loop "
                f"first use {1e3 * st['loop_first']['wall_s']:.1f}, then "
                f"{1e3 * st['loop']['wall_s']:.1f} / "
                f"{1e3 * st['loop_again']['wall_s']:.1f}; the card's own "
                f"{staged_dev_ms:.1f} ms a launch; pool "
                f"{sum(e.pool_bytes for e in (program, *program.parts))} "
                f"bytes (glue {program.pool_bytes})")

    # (iii) the MPC re-solve at B=1
    nlp1, cfg1, _, _, _ = bench_harness.prepare(1, MAIN_NSTEPS)
    single = bench_harness.single_problem(MAIN_NSTEPS)
    mpc_sides = (("eager", "eager"), ("loop", None), ("replay", "replay"),
                 ("replay_again", "replay"), ("loop_again", None))
    mpc = run_sides("mpc", lambda: bench_harness.run_mpc(
        nlp1, cfg1, single, steps=LOOP_MPC_STEPS), mpc_sides)
    dev1 = trip_device_ms(torch)
    # the card's own time of one tick: the tick program's graph (the last
    # tick's inputs are still in its buffers) replayed between two events
    tick = latest(TG._Program)
    torch.cuda.synchronize()
    tick_ms = _median_event_ms(torch, tick.graph.replay, 3, 1)
    torch.cuda.synchronize()
    absorb(tick.parts)
    ref = mpc["eager"]
    # the cold solve, the untimed first re-solve, the timed ones and the
    # ones dispatched back to back
    solves = 2 + 2 * LOOP_MPC_STEPS
    for name, side in out["mpc"].items():
        m = mpc[name]
        held_ = [bitwise(torch, a, b) for a, b in zip(
            [ref["cold"]] + ref["ticks"], [m["cold"]] + m["ticks"])]
        equal = all(e for e, _ in held_)
        diff = max(d for _, d in held_)
        side.update(p50_ms=m["p50_ms"], pipelined_ms=m["pipelined_ms"],
                    statuses=m["statuses"], iters=m["iters"],
                    bitwise=equal, max_abs_diff=diff, device_ms_a_trip=dev1,
                    device_ms_a_tick=tick_ms,
                    tick_pool_bytes=tick.pool_bytes,
                    busy=dev1 * side["trips"] / (1e3 * side["wall_s"]))
        say("loop", f"mpc uas_2d N={MAIN_NSTEPS}, {LOOP_MPC_STEPS} ticks, "
                    f"{name}: {json.dumps(side)}")
        if m["statuses"] != ref["statuses"] or m["iters"] != ref["iters"]:
            raise AssertionError(f"mpc {name}: statuses or iterations "
                                 "differ from the eager route's")
        if name.startswith("loop") and (
                not equal or side["idle_trips"]
                or side["launches"] != side["trips"]
                or side["graph_launches"] != solves
                or side["programs"] != solves):
            raise AssertionError(f"mpc {name}: the cold solve or a tick is "
                                 "not bitwise the eager route's, a launch "
                                 "is not a trip, or a solve is not one "
                                 f"program call ({side['programs']}) and "
                                 f"one graph launch "
                                 f"({side['graph_launches']}) for {solves}")
        if name.startswith("replay") and not diff <= GRAPH_TOL:
            raise AssertionError(f"mpc {name}: the cold solve or a tick "
                                 f"differs from the eager route's by {diff}")
        if side["captures"] != (3 if name == "loop" else 0):
            raise AssertionError(f"mpc {name}: {side['captures']} captures; "
                                 "the cold solve and every tick share one "
                                 "loop key (its trip captured once) and are "
                                 "two programs (cold, warm), each captured "
                                 "once on its first use")
    m = out["mpc"]
    say("loop", f"mpc: p50 eager {m['eager']['p50_ms']:.2f} ms, replay "
                f"{m['replay']['p50_ms']:.2f} / "
                f"{m['replay_again']['p50_ms']:.2f}, device loop "
                f"{m['loop']['p50_ms']:.2f} / {m['loop_again']['p50_ms']:.2f}"
                f"; pipelined ms a tick replay "
                f"{m['replay']['pipelined_ms']:.2f} / "
                f"{m['replay_again']['pipelined_ms']:.2f}, device loop "
                f"{m['loop']['pipelined_ms']:.2f} / "
                f"{m['loop_again']['pipelined_ms']:.2f}; the card's own "
                f"{dev1:.3f} ms a trip, {tick_ms:.3f} ms a tick (the last "
                f"tick's {ref['iters'][-1]} trips, one program replay)")

    out["overhead"] = loop_ms(torch)
    say("loop", f"the loop's own cost on a two-kernel body, "
                f"{LOOP_BENCH_TRIPS} trips: device loop "
                f"{out['overhead']['ms']:.5f} ms a trip, replayed with a "
                f"host read each trip {out['overhead']['plain_ms']:.5f}")
    out["max_abs_err"] = max(
        side["max_abs_diff"] for kind in ("phase1", "staged")
        for name, side in out[kind].items() if name.startswith("loop"))
    return out


def check_programs(torch, bt_cuda, cyclic_reduction):
    """Phase 4d: the reference's remaining jitted solves, each one
    program a call on the card (``trip_graph.run``): the facade's cold
    ``solve_batch`` at B=FACADE_B with a rescue of RESCUE_LANES lanes
    (``solve_batched_rescue``: phase 1, the gather, the seeds, the flat
    multistart batch and the merge) on its key's first use and twice
    after, each after-call one program call and one graph launch, bitwise
    the first use, its wall and the card's own ms and its pool bytes; the
    same against the eager route at PROGRAM_B with PROGRAM_RESCUE lanes
    (eager, first use, replay: bitwise); ``solve_multistart`` on both
    shipped problems, eager, on its first use and replayed (bitwise, one
    launch). The MPC's ticks are the loop phase's, the exact waves the
    exact phase's."""
    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.solve import al_sqp

    out = {"rescue": {}, "rescue_small": {}, "multistart_ocp": {},
           "multistart_mip": {}}

    def facade():
        topt = TrajectoryOptimizer()
        topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
        topt.set_dynamics(dynamics.single_integrator)
        topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
        topt.setup()
        return topt

    def sides(kind, run, names):
        """``run()`` on each (name, route); every result bitwise the
        first's; the counts of each side."""
        results = {}
        for name, route in names:
            results[name], out[kind][name] = loop_side(
                torch, bt_cuda, cyclic_reduction, f"programs {kind} {name}",
                run, route)
        first = results[names[0][0]]
        for name, side in out[kind].items():
            side["bitwise"], side["max_abs_diff"] = bitwise(
                torch, first, results[name])
            if not side["bitwise"]:
                raise AssertionError(f"programs {kind} {name}: not bitwise "
                                     f"the {names[0][0]} side's (max |d| "
                                     f"{side['max_abs_diff']})")
            if name.startswith("replay") and (
                    side["programs"], side["graph_launches"],
                    side["captures"]) != (1, 1, 0):
                raise AssertionError(
                    f"programs {kind} {name}: {side['programs']} program "
                    f"calls, {side['graph_launches']} graph launches, "
                    f"{side['captures']} captures: one call, one launch")
        return results[names[0][0]]

    def report(kind, label, program):
        """The card's own ms of one launch of ``program``'s graph (its
        last call's inputs), each side's wall ms, the pool bytes."""
        torch.cuda.synchronize()
        dev_ms = _median_event_ms(torch, program.graph.replay, 3, 1)
        torch.cuda.synchronize()
        absorb(program.parts)
        pool = sum(e.pool_bytes for e in (program, *program.parts))
        for name, side in out[kind].items():
            side.update(device_ms=dev_ms, pool_bytes_program=pool,
                        busy=dev_ms / (1e3 * side["wall_s"]))
            say("programs", f"{label}, {name}: {json.dumps(side)}")
        say("programs", f"{label}: wall ms " + ", ".join(
            f"{name} {1e3 * side['wall_s']:.1f}"
            for name, side in out[kind].items())
            + f"; the card's own {dev_ms:.1f} ms a launch; pool {pool} "
              f"bytes (glue {program.pool_bytes}, {len(program.parts)} "
              f"loops)")

    # the facade's cold fleet with a rescue: x0 = (1, 2) plus offsets, as
    # the facade phase makes them
    rng = np.random.default_rng(0)
    x0 = (np.array([1.0, 2.0]) + rng.uniform(
        [-0.1, -0.1], [0.0, 0.1], size=(FACADE_B, 2))).astype(np.float32)
    topt = facade()
    res = sides("rescue", lambda: topt.solve_batch(
        x0=x0, rescue_lanes=RESCUE_LANES), (
        ("first_use", None), ("replay", None), ("replay_again", None)))
    solved = float((res.status == 1).float().mean())
    report("rescue", f"solve_batch B={FACADE_B}, rescue {RESCUE_LANES} "
                     f"lanes x 4 starts, solved {solved:.4f}",
           latest(TG._Program))
    out["rescue_solved_fraction"] = solved
    if not solved >= 0.99:
        raise AssertionError(f"the rescued fleet solved {solved}")
    sides("rescue_small", lambda: topt.solve_batch(
        x0=x0[:PROGRAM_B], rescue_lanes=PROGRAM_RESCUE), (
        ("eager", "eager"), ("first_use", None), ("replay", None)))
    report("rescue_small", f"solve_batch B={PROGRAM_B}, rescue "
                           f"{PROGRAM_RESCUE} lanes x 4 starts",
           latest(TG._Program))

    # multistart on both shipped problems (the facade phase's calls)
    for kind, make, seed in (
            ("multistart_ocp", problems.canonical_ocp_2d, 0),
            ("multistart_mip", problems.canonical_mip_2d, cli.MIP_SEED)):
        vgp, nlp = make()
        data, _ = vgp.to_device()
        res = sides(kind, lambda: al_sqp.solve_multistart(
            nlp, al_sqp.SolverConfig(), data, 8,
            torch.Generator().manual_seed(seed)), (
            ("eager", "eager"), ("first_use", None), ("replay", None)))
        report(kind, f"solve_multistart({make.__name__}, 8, seed {seed}): "
                     f"status {int(res.status)}, objective "
                     f"{float(res.obj):.6f}", latest(TG._Program))
        if int(res.status) != 1:
            raise AssertionError(f"{kind}: status {int(res.status)}")
    return out


def check_seeds(torch, bt_cuda, cyclic_reduction, nlp, data, gen, extras,
                out):
    """Phase 4b's seeds: the bench's ``plan_guess`` at B=MAIN_B eager, on
    the graph (its key's first use: the main phase made the key, so the
    programs' entries are dropped first), on the graph again and eager
    again, each from the generator's same state; z0 must be bitwise
    equal. Fills ``out`` with each side's counts, ms, the card's own ms of
    one replay and the busy share (that over the wall ms), and returns
    the graph's z0."""
    from etol_tpu_torch.solve import shooting

    state = gen.get_state()

    def seeds():
        gen.set_state(state)
        return shooting.plan_guess(nlp, data, extras["seed_walks"], gen,
                                   pulled=extras["seed_pulled"])

    for key in [k for k, e in TG._CACHE.items()
                if isinstance(e, TG._Program)]:
        del TG._CACHE[key]
    sides = (("eager", "eager"), ("graph_first", None), ("graph", None),
             ("eager_again", "eager"))
    z0 = {}
    for name, route in sides:
        z0[name], out[name] = graph_side(
            torch, bt_cuda, cyclic_reduction, f"seeds {name}", seeds, route)
    entry = latest(TG._Program)
    dev_ms = replay_ms(torch, entry.graph)
    for name, _ in sides:
        side = out[name]
        del side["ms_a_trip"]
        side.update(ms=1e3 * side["wall_s"], device_ms=dev_ms,
                    busy=dev_ms / (1e3 * side["wall_s"]),
                    program_static_bytes=entry.static_bytes,
                    program_pool_bytes=entry.pool_bytes,
                    bitwise=torch.equal(z0[name], z0["eager"]))
        say("graph", f"seeds uas_2d N={MAIN_NSTEPS} B={MAIN_B} "
                     f"({extras['seed_walks']} walks, "
                     f"{extras['seed_pulled']} pulled), {name}: "
                     f"{json.dumps(side)}")
        if not side["bitwise"]:
            raise AssertionError(f"seeds {name}: z0 is not bitwise the "
                                 "eager route's")
    if (out["graph_first"]["captures"], out["graph_first"]["programs"],
            out["graph"]["captures"], out["graph"]["programs"],
            out["eager"]["programs"] + out["eager_again"]["programs"]) \
            != (1, 1, 0, 1, 0):
        raise AssertionError("the seeds should capture once on the graph's "
                             "first use, replay on the next, and take no "
                             "program route eagerly")
    say("graph", f"seeds: eager {out['eager']['ms']:.2f} ms, graph first "
                 f"use {out['graph_first']['ms']:.2f} ms, graph "
                 f"{out['graph']['ms']:.2f} ms, the card's own "
                 f"{dev_ms:.3f} ms a replay")
    return z0["graph"]


def check_mpc(torch, bench_harness, bt_cuda, cyclic_reduction):
    """Phase 7: the single-problem warm re-solve at N=50 on the card under
    both KKT routes; returns {route: ``run_mpc``'s result with the
    kernel's launches and the cyclic-reduction solves over it}. Under
    "kernel" every Newton iteration is one launch at B=1 and cyclic
    reduction is never called; under "cr" the reverse. The "cr" side,
    which only stands beside the other for comparison, takes the first
    MPC_CR_STEPS of the MPC_STEPS re-solves and skips the back-to-back
    part."""
    nlp, cfg, _, _, _ = bench_harness.prepare(1, MAIN_NSTEPS)
    if cfg.kkt_solver != "kernel":
        raise AssertionError("the registry's route is not the kernel")
    single = bench_harness.single_problem(MAIN_NSTEPS)
    runs = {}
    for route in ("kernel", "cr"):
        reset_counts(bt_cuda, cyclic_reduction)
        out = bench_harness.run_mpc(
            nlp, dataclasses.replace(cfg, kkt_solver=route), single,
            steps=MPC_STEPS if route == "kernel" else MPC_CR_STEPS,
            pipelined=route == "kernel")
        TG.settle()
        out["launches"] = bt_cuda.TALLY.count
        out["cr_solves"] = cyclic_reduction.TALLY.count
        by = dict(bt_cuda.TALLY.by)
        n_ok = out["statuses"].count(1)
        say("mpc", f"uas_2d N={MAIN_NSTEPS}, one problem, kkt_solver="
                   f"{route}: {out['launches']} kernel launches "
                   f"{sorted(by.items())}, {out['cr_solves']} cyclic-"
                   f"reduction solves; cold status "
                   f"{int(out['cold'].status)} after "
                   f"{int(out['cold'].inner_iters)} iterations; re-solve "
                   f"statuses {out['statuses']}, iterations {out['iters']}")
        tail = ("" if out["pipelined_ms"] is None else
                f", {out['pipelined_ms']:.2f} ms a step with {MPC_STEPS} "
                f"dispatched "
                f"back to back and one sync")
        say("mpc", f"kkt_solver={route}: p50 re-solve latency "
                   f"{out['p50_ms']:.2f} ms over {len(out['statuses'])} "
                   f"re-solves with a sync after each{tail}")
        if not out["finite"]:
            raise AssertionError("an MPC re-solve returned non-finite z")
        if n_ok < len(out["statuses"]) - 2:
            raise AssertionError(
                f"only {n_ok} of {len(out['statuses'])} MPC re-solves "
                f"SOLVED")
        if route == "kernel":
            if out["launches"] <= 0 or out["cr_solves"] or set(by) != {
                    ("smem",) + B1_SHAPE}:
                raise AssertionError(
                    "under 'kernel' the unbatched solve should launch the "
                    f"shared-memory kernel at {B1_SHAPE} and nothing else")
            assert_checked("mpc", by)
        elif out["launches"] or out["cr_solves"] <= 0:
            raise AssertionError(
                "under 'cr' the unbatched solve should take cyclic "
                "reduction and launch no kernel")
        runs[route] = out
    return runs


def ab_runs(torch, bt_cuda, name, solve, other="scan"):
    """``solve(kkt)`` -> (result, stage trips) under "kernel" and under
    ``other`` ("scan" or "cr", neither a kernel); every launch of the
    kernel side must be at a checked shape."""
    runs = {}
    for kkt in ("kernel", other):
        TG.settle()
        bt_cuda.TALLY.clear()
        t0 = time.perf_counter()
        runs[kkt], trips = solve(kkt)
        torch.cuda.synchronize()
        say("a/b", f"{name} {kkt}: stage trips {list(trips)} in "
                   f"{time.perf_counter() - t0:.1f} s")
        TG.settle()
        assert_checked(f"{name} a/b ({kkt})", bt_cuda.TALLY.by)
    ab(torch, name, runs, other)


def ab(torch, name, runs, other):
    """Kernel against ``other`` on the same batch: solved counts within 2,
    mean objectives over the lanes both solved within 1%."""
    ok_k = runs["kernel"].status == 1
    ok_s = runs[other].status == 1
    both = ok_k & ok_s
    n_k, n_s = int(ok_k.sum()), int(ok_s.sum())
    obj_k = float(runs["kernel"].obj[both].mean())
    obj_s = float(runs[other].obj[both].mean())
    say("a/b", f"{name} B={AB_B}: solved kernel {n_k} {other} {n_s}; mean "
               f"objective over {int(both.sum())} lanes solved by both: "
               f"kernel {obj_k:.6f} {other} {obj_s:.6f}")
    if abs(n_k - n_s) > 2:
        raise AssertionError(
            f"{name}: kernel and {other} solved counts differ by > 2")
    if not abs(obj_k - obj_s) <= 0.01 * abs(obj_s):
        raise AssertionError(
            f"{name}: kernel and {other} objectives differ by > 1%")


def check_ladder(torch, bench_scaling, bt_cuda):
    """Phase 9: the ladder's three other models on the default device
    under the registry configs, then their A/B against a plain route;
    returns {name: dict(solved_fraction, ..., launches_by)}."""
    from etol_tpu_torch.ops import cyclic_reduction

    out = {}
    for name, (K, w) in LADDER.items():
        label, nlp, bdata, cfg, stages, _, gen = bench_scaling.prepare(name)
        B = bdata.x0.shape[0]
        if cfg.kkt_solver != "kernel" or bdata.x0.device.type != "cuda":
            raise AssertionError(f"{name}: not the kernel on the card")
        reset_counts(bt_cuda, cyclic_reduction)
        run = bench_scaling.run_config(
            label, nlp, bdata, cfg, stages, reps=0, generator=gen,
            log=lambda line: say("ladder", line))
        TG.settle()
        launches, by = bt_cuda.TALLY.count, dict(bt_cuda.TALLY.by)
        say("ladder", f"{name}: kernel launches {launches} by (variant, K, "
                      f"w, B): {sorted(by.items(), key=lambda kv: -kv[0][3])}")
        res = run["result"]
        if not run["solved_fraction"] >= 0.95:
            raise AssertionError(
                f"{name}: solved {run['solved_fraction']} < 0.95")
        if not bool(torch.isfinite(res.z).all()):
            raise AssertionError(f"{name}: non-finite z")
        # one KKT solve per Newton iteration (chord steps included)
        if launches != sum(run["stage_trips"]) or any(
                key[:3] != ("smem", K, w) for key in by):
            raise AssertionError(
                f"{name}: {launches} launches for stage trips "
                f"{run['stage_trips']}, by shape {by}: every KKT solve "
                f"should be the shared-memory kernel at K={K}, w={w}")
        if max(key[3] for key in by) != B:
            raise AssertionError(f"{name}: no launch at the full batch {B}")
        assert_checked(name, by)
        ls = assert_ls_trips(name, by)
        say("ladder", f"{name}: line search kernel launches by (K, w, n, "
                      f"B): {sorted(ls.items(), key=lambda kv: -kv[0][3])}")
        run.pop("result")
        out[name] = dict(run, batch=B, launches=launches, launches_by={
            str(key[3]): n for key, n in sorted(
                by.items(), key=lambda kv: -kv[0][3])},
            ls_launches=sum(ls.values()))
    for name in ("pm20", "pm3d"):
        def solve(kkt, name=name):
            _, nlp, bdata, cfg, stages, _, _ = bench_scaling.prepare(
                name, batch=AB_B, kkt_solver=kkt)
            return bench_scaling.al_sqp.solve_batched_staged(
                nlp, cfg, bdata, None, stages, return_stage_trips=True)

        ab_runs(torch, bt_cuda, name, solve)
    warm_ab(torch, bench_scaling, bt_cuda, "fw100")
    return out


def warm_ab(torch, bench_scaling, bt_cuda, name):
    """The A/B of a model whose cold solve is long (fw100: 156 KKT solves
    at K=101, a quarter of a second each by cyclic reduction): one cold
    staged solve at B=64 under the kernel, then the same batch with its
    starts moved by WARM_DRIFT re-solved from that result, under "kernel"
    and under "cr", within WARM_BUDGET iterations."""
    al_sqp = bench_scaling.al_sqp
    _, nlp, bdata, cfg, stages, _, _ = bench_scaling.prepare(
        name, batch=AB_B)
    TG.settle()
    bt_cuda.TALLY.clear()
    t0 = time.perf_counter()
    cold, trips = al_sqp.solve_batched_staged(
        nlp, cfg, bdata, None, stages, return_stage_trips=True)
    n_cold = int((cold.status == 1).sum())
    say("a/b", f"{name} kernel, cold: stage trips {list(trips)}, {n_cold} "
               f"of {AB_B} solved in {time.perf_counter() - t0:.1f} s")
    TG.settle()
    assert_checked(f"{name} a/b (cold)", bt_cuda.TALLY.by)
    if n_cold < AB_B - 2:
        raise AssertionError(f"{name}: the cold solve left lanes unsolved")
    drift = torch.zeros_like(bdata.x0[0])
    drift[:2] = WARM_DRIFT
    moved = dataclasses.replace(bdata, x0=bdata.x0 + drift)

    def solve(kkt):
        res = al_sqp.solve_batched(
            nlp, dataclasses.replace(cfg, kkt_solver=kkt,
                                     max_total=WARM_BUDGET),
            moved, cold.z, (cold.lam_def, cold.lam_eq, cold.mu), cold.rho)
        return res, (int(res.inner_iters.max()),)

    ab_runs(torch, bt_cuda, f"{name} warm", solve, other="cr")


def check_facade(torch, bt_cuda, cyclic_reduction):
    """Phase 10: the library's own entry point on the default device (no
    ``device`` argument anywhere); returns its findings. Every step
    raises on a miss."""
    import tempfile

    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.core import trajectory
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.solve import al_sqp

    SOLVED = int(Status.SOLVED)
    out = {}
    ls_by = out["ls_launches"] = {}

    def counts(path, kkt_route=True):
        """The counts since the last reset, every launch at a checked
        shape, and on the KKT kernel's route two line search launches a
        trip where that route takes the problem."""
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        assert_checked(f"facade {path}", by)
        if kkt_route:
            ls_by[path] = sum(assert_ls_trips(f"facade {path}",
                                              by).values())
        return bt_cuda.TALLY.count, by, cyclic_reduction.TALLY.count

    def by_batch(by):
        return {f"K{k[1]}_w{k[2]}_B{k[3]}": n for k, n in sorted(
            by.items(), key=lambda kv: -kv[0][3])}

    # -- the README's Quick start
    reset_counts(bt_cuda, cyclic_reduction)
    topt = TrajectoryOptimizer()
    topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    res = topt.solve()
    text = topt.debug()
    score = topt.get_score()
    times, X = topt.get_xtraj()
    with tempfile.TemporaryDirectory() as tmp:
        path = topt.save((times, X), os.path.join(tmp, "state.csv"))
        t_back, X_back = trajectory.load_csv(path)
    launches, by, cr_solves = counts("solve")
    iters = int(res.inner_iters)
    say("facade", f"Quick start on ocp_2d_ex1.xml: {topt.get_status().name}"
                  f", score {score:.6f}, {iters} iterations in "
                  f"{topt.last_solve_seconds:.2f} s (first-use costs "
                  f"included), xN {X[-1].tolist()}; {launches} kernel "
                  f"launches {sorted(by.items())}, {cr_solves} cyclic-"
                  f"reduction solves")
    if X.device.type != "cuda":
        raise AssertionError("the facade's default device is not the card")
    if topt.get_status() != Status.SOLVED or not 1.2 < score < 1.8:
        raise AssertionError(f"Quick start: {topt.get_status()}, {score}")
    if "status=SOLVED" not in text or "nodes=33" not in text:
        raise AssertionError(f"debug() says: {text}")
    if float((X[-1].cpu() - torch.tensor([5.0, 4.0])).abs().max()) > 0.011:
        raise AssertionError(f"xN {X[-1].tolist()} is not the goal")
    if tuple(X_back.shape) != (33, 2) or float(
            (X_back - X.cpu().double()).abs().max()) > 1e-6 or float(
            (t_back - times.cpu().double()).abs().max()) > 1e-6:
        raise AssertionError("the saved CSV does not read back")
    if by != {("smem", 33, 4, 1): iters} or cr_solves:
        raise AssertionError(
            f"facade.solve(): {iters} iterations should be {iters} launches"
            f" of the shared-memory kernel at (33, 4, 1), and no cyclic "
            f"reduction")
    out["solve"] = dict(score=score, iters=iters, launches=launches,
                        seconds=topt.last_solve_seconds)

    # -- MPC steps along the solved trajectory, under both routes, each
    # from the state the Quick start left
    snap = (topt.data, topt.result, list(topt.vgp.x0))
    cfg0 = topt.config
    out["mpc"] = {}
    for route in ("kernel", "cr"):
        topt.config = dataclasses.replace(cfg0, kkt_solver=route)
        topt.data, topt.result = snap[0], snap[1]
        topt.vgp.x0 = list(snap[2])
        reset_counts(bt_cuda, cyclic_reduction)
        lat, statuses, its = [], [], []
        steps = MPC_STEPS if route == "kernel" else MPC_CR_STEPS
        for _ in range(steps):
            _, Xk = topt.get_xtraj()
            r = topt.mpc_step(Xk[1])
            lat.append(topt.last_solve_seconds * 1e3)
            statuses.append(int(r.status))
            its.append(int(r.inner_iters))
        launches, by, cr_solves = counts(f"mpc_step ({route})",
                                         route == "kernel")
        p50 = sorted(lat)[len(lat) // 2]
        mean = sum(lat) / len(lat)
        say("facade", f"{steps} mpc_steps, kkt_solver={route}: statuses "
                      f"{statuses}, iterations {its}; p50 {p50:.2f} ms, "
                      f"mean {mean:.2f} ms (last_solve_seconds, a sync "
                      f"each); {launches} kernel launches "
                      f"{sorted(by.items())}, {cr_solves} cyclic-reduction "
                      f"solves")
        if statuses != [SOLVED] * steps:
            raise AssertionError(f"mpc_step under {route}: {statuses}")
        n = sum(its)
        if ls_gained() != {(33, 4, LS_GRIDS[(33, 4)], 1): 2 * n}:
            raise AssertionError(
                f"mpc_step under {route}: line search launches "
                f"{ls_gained()} for {n} iterations, two each")
        want = ((n, 0) if route == "kernel" else (0, n))
        if (launches, cr_solves) != want or (
                by and set(by) != {("smem", 33, 4, 1)}):
            raise AssertionError(
                f"mpc_step under {route}: {launches} launches {by}, "
                f"{cr_solves} cyclic-reduction solves for {sum(its)} "
                f"iterations")
        out["mpc"][route] = dict(p50_ms=p50, mean_ms=mean, launches=launches,
                                 cr_solves=cr_solves, iters=sum(its))
    topt.config = cfg0
    topt.data, topt.result = snap[0], snap[1]
    topt.vgp.x0 = list(snap[2])

    # -- multistart on both shipped problems
    fixtures = []
    for name in ("ocp_2d_ex1.csv", "ocp_2d_ex1_alt.csv"):
        path = os.path.join(HERE, "tests", "golden", name)
        with open(path) as fh:
            obj_g = float(fh.readline().split("obj=")[1].split(",")[0])
        rows = np.loadtxt(path, delimiter=",", skiprows=2)
        fixtures.append((name, rows[:, 1:3], obj_g))
    reset_counts(bt_cuda, cyclic_reduction)
    vgp, nlp = problems.canonical_ocp_2d()
    data, _ = vgp.to_device()
    t0 = time.perf_counter()
    res = al_sqp.solve_multistart(nlp, al_sqp.SolverConfig(), data, 8)
    Xm = nlp.unpack(res.z)[0].cpu().numpy()
    ocp_s = time.perf_counter() - t0
    launches, by, _ = counts("multistart ocp")
    errs = {n: float(np.max(np.abs(Xm - Xg))) for n, Xg, _ in fixtures}
    name, _, obj_g = min(fixtures, key=lambda f: errs[f[0]])
    say("facade", f"solve_multistart(canonical_ocp_2d, 8): status "
                  f"{int(res.status)}, objective {float(res.obj):.6f} "
                  f"(golden {name}: {obj_g:.6f}), max state error "
                  f"{errs[name]:.3e} (limit 1e-3; both basins {errs}), "
                  f"{ocp_s:.2f} s, launches {by_batch(by)}")
    if int(res.status) != SOLVED or not errs[name] <= 1e-3 or abs(
            float(res.obj) - obj_g) > 2e-3:
        raise AssertionError("the OCP multistart misses its golden")
    if set(by) != {("smem", 33, 4, 8)}:
        raise AssertionError(f"OCP multistart launches: {by}")
    out["multistart_ocp"] = dict(obj=float(res.obj), state_err=errs[name],
                                 golden=name, launches=launches,
                                 seconds=ocp_s)

    reset_counts(bt_cuda, cyclic_reduction)
    vgp, nlp = problems.canonical_mip_2d()
    data, _ = vgp.to_device()
    t0 = time.perf_counter()
    res = al_sqp.solve_multistart(
        nlp, al_sqp.SolverConfig(), data, 8,
        torch.Generator().manual_seed(cli.MIP_SEED))
    mip_obj = float(res.obj)
    mip_s = time.perf_counter() - t0
    launches, by, _ = counts("multistart mip")
    say("facade", f"solve_multistart(canonical_mip_2d, 8, seed "
                  f"{cli.MIP_SEED}): status {int(res.status)}, score "
                  f"{mip_obj:.6f}, violations {float(res.viol_eq):.2e} / "
                  f"{float(res.viol_in):.2e}, {mip_s:.2f} s, launches "
                  f"{by_batch(by)}")
    if int(res.status) != SOLVED or set(by) != {("smem", 17, 6, 8)}:
        raise AssertionError("the MIP multistart did not solve on the "
                             f"kernel at (17, 6, 8): {by}")
    out["multistart_mip"] = dict(obj=mip_obj, launches=launches,
                                 seconds=mip_s)

    # -- the fleet: x0 = (1, 2) plus offsets in [-0.1, 0] x [-0.1, 0.1] (a
    # +x offset starts inside the moving obstacle mexz0), cold with a
    # rescue of RESCUE_LANES lanes, then warm at x0 + 0.01
    rng = np.random.default_rng(0)
    x0 = (np.array([1.0, 2.0]) + rng.uniform(
        [-0.1, -0.1], [0.0, 0.1], size=(FACADE_B, 2))).astype(np.float32)

    def fleet(label, res):
        status = res.status.cpu().numpy()
        frac = float((status == SOLVED).mean())
        launches, by, _ = counts(label)
        found = dict(
            solved_fraction=frac,
            mean_iters=float(res.inner_iters.float().mean()),
            max_iters=int(res.inner_iters.max()),
            seconds=topt.last_solve_seconds, launches=launches,
            launches_by=by_batch(by))
        say("facade", f"solve_batch B={len(status)} {label}: {found}")
        if any(key[:3] != ("smem", 33, 4) for key in by):
            raise AssertionError(f"fleet launches: {by}")
        return found, {int(v): int(n) for v, n in zip(
            *np.unique(status, return_counts=True))}

    reset_counts(bt_cuda, cyclic_reduction)
    cold, cold_status = fleet(
        f"cold with rescue ({RESCUE_LANES} lanes)",
        topt.solve_batch(x0=x0, rescue_lanes=RESCUE_LANES))
    reset_counts(bt_cuda, cyclic_reduction)
    warm, warm_status = fleet("warm", topt.solve_batch(x0=x0 + 0.01,
                                                       warm=True))
    if not (cold["solved_fraction"] >= 0.99
            and warm["solved_fraction"] >= 0.99):
        raise AssertionError(
            f"the fleet solved {cold['solved_fraction']} cold and "
            f"{warm['solved_fraction']} warm; lanes by status: cold "
            f"{cold_status}, warm {warm_status}")
    if not warm["mean_iters"] < max(0.8 * cold["mean_iters"], 30.0):
        raise AssertionError("the warm fleet re-solve shows no warm start")
    out["fleet"] = dict(batch=FACADE_B, cold=cold, warm=warm)

    # -- the rescue, forced: a budget of 40 iterations leaves the whole
    # small fleet unsolved; the rescue re-solves FORCED_LANES of them cold
    # from 4 starts each under the default config
    tight = TrajectoryOptimizer(al_sqp.SolverConfig(max_total=40))
    tight.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    tight.set_dynamics(dynamics.single_integrator)
    tight.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    tight.setup()
    reset_counts(bt_cuda, cyclic_reduction)
    before = tight.solve_batch(x0=x0[:FORCED_B], rescue=False)
    n_before = int((before.status == SOLVED).sum())
    after = tight.solve_batch(x0=x0[:FORCED_B], rescue=True,
                              rescue_lanes=FORCED_LANES,
                              rescue_cfg=al_sqp.SolverConfig())
    n_after = int((after.status == SOLVED).sum())
    launches, by, _ = counts("forced rescue")
    say("facade", f"forced rescue, B={FORCED_B}, max_total=40: {n_before} "
                  f"lanes solved without the rescue, {n_after} with "
                  f"{FORCED_LANES} lanes rescued; launches {by_batch(by)}")
    if n_after - n_before < FORCED_LANES - 2 or not by.get(
            ("smem", 33, 4, FORCED_LANES * 4)):
        raise AssertionError("the rescue phase rescued too few lanes")
    out["forced_rescue"] = dict(solved_before=n_before, solved_after=n_after,
                                launches=by_batch(by))

    # -- the CLI, in-process, in a directory of its own for its CSV files
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for argv in (["solve_ocp"], ["mpc_demo", "5"]):
                reset_counts(bt_cuda, cyclic_reduction)
                rc = cli.main(argv)
                launches, by, cr_solves = counts("cli " + argv[0])
                say("facade", f"cli {' '.join(argv)}: exit code {rc}, "
                              f"{launches} kernel launches, {cr_solves} "
                              f"cyclic-reduction solves")
                if rc != 0 or launches <= 0 or cr_solves:
                    raise AssertionError(f"cli {argv} failed")
        finally:
            os.chdir(here)
    return out


def check_exact(torch, bt_cuda, cyclic_reduction):
    """Phase 11: the exact MILP path on the default device; returns its
    findings. Every step raises on a miss."""
    import tempfile

    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer
    from etol_tpu_torch.core import trajectory
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import problems
    from etol_tpu_torch.solve import al_sqp, side_branch

    SOLVED = int(Status.SOLVED)
    out = {}

    def counts(path):
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        assert_checked(f"exact {path}", by)
        assert_ls_trips(f"exact {path}", by)  # user rows: none
        return bt_cuda.TALLY.count, by, cyclic_reduction.TALLY.count

    def found(mres, seconds, launches, by, cr_solves):
        c = {k: TG.COUNTS[k] - c0[k] for k in c0}
        f = dict(obj=mres.obj, status=mres.status,
                 certified=mres.certified, nodes=mres.nodes_solved,
                 waves=mres.waves, trips=mres.trips, launches=launches,
                 launches_by={"K%d_w%d_B%d" % key[1:]: n
                              for key, n in sorted(by.items())},
                 cr_solves=cr_solves, seconds=seconds,
                 programs=c["programs"], graph_launches=c["loop_graphs"],
                 captures=c["captures"])
        # every wave one program call and one graph launch; one key for
        # the search (its trip and its program captured once)
        if (f["programs"], f["graph_launches"]) != (
                mres.waves, mres.waves) or f["captures"] > 2:
            raise AssertionError(
                f"exact: {f['programs']} program calls, "
                f"{f['graph_launches']} graph launches and {f['captures']} "
                f"captures for {mres.waves} waves")
        return f

    # -- mip_2d_ex1.xml, convex, under both KKT routes
    vgp, nlp = problems.canonical_mip_2d()
    data, _ = vgp.to_device()
    for route in ("kernel", "cr"):
        reset_counts(bt_cuda, cyclic_reduction)
        c0 = dict(TG.COUNTS)
        t0 = time.perf_counter()
        mres = side_branch.solve_exact(
            nlp, al_sqp.SolverConfig(kkt_solver=route), data,
            wave=EXACT_WAVE, convex_relaxation=True)
        seconds = time.perf_counter() - t0
        launches, by, cr_solves = counts(f"mip ({route})")
        f = found(mres, seconds, launches, by, cr_solves)
        say("exact", f"solve_exact(canonical_mip_2d, convex), kkt_solver="
                     f"{route}: {Status(mres.status).name}, certified "
                     f"{mres.certified}, objective {mres.obj:.6f} (golden "
                     f"{MIP_GOLDEN}, limit {MIP_TOL}), {mres.nodes_solved}"
                     f" nodes in {mres.waves} waves, {mres.trips} trips, "
                     f"{seconds:.2f} s; {launches} kernel launches "
                     f"{f['launches_by']}, {cr_solves} cyclic-reduction "
                     f"solves; {f['programs']} program calls, "
                     f"{f['graph_launches']} graph launches, "
                     f"{f['captures']} captures")
        if mres.status != SOLVED or not mres.certified or not abs(
                mres.obj - MIP_GOLDEN) <= MIP_TOL:
            raise AssertionError(f"exact mip under {route}: {f}")
        n = mres.trips
        want = ((n, 0) if route == "kernel" else (0, n))
        if (launches, cr_solves) != want or (
                by and set(by) != {("smem",) + EXACT_SHAPES[0]}):
            raise AssertionError(
                f"exact mip under {route}: {launches} launches {by} and "
                f"{cr_solves} cyclic-reduction solves for {mres.trips} trips")
        out[f"mip_{route}"] = f
    gap = abs(out["mip_kernel"]["obj"] - out["mip_cr"]["obj"])
    say("exact", f"the two routes' objectives differ by {gap:.3e} (limit "
                 f"{MIP_ROUTE_TOL})")
    if not gap <= MIP_ROUTE_TOL:
        raise AssertionError("the exact MIP differs between KKT routes")

    # -- the composed demo through the facade
    vgp, nlp = problems.composed_exact_demo()
    topt = TrajectoryOptimizer()
    topt.vgp, topt.nlp = vgp, nlp
    topt.data, topt.dims = vgp.to_device()
    reset_counts(bt_cuda, cyclic_reduction)
    c0 = dict(TG.COUNTS)
    mres = topt.solve_exact(wave=COMPOSED_WAVE, max_nodes=EXACT_MAX_NODES,
                            convex_relaxation=True)
    launches, by, cr_solves = counts("composed")
    f = found(mres, topt.last_solve_seconds, launches, by, cr_solves)
    times, X = topt.get_xtraj()
    Z = topt.result.z.reshape(topt.dims.nodes, -1).cpu().numpy()
    boost = Z[1:, 4]
    with tempfile.TemporaryDirectory() as tmp:
        path = topt.save((times, X), os.path.join(tmp, "state.csv"))
        _, X_back = trajectory.load_csv(path)
    say("exact", f"facade solve_exact(composed_exact_demo, wave "
                 f"{COMPOSED_WAVE}, max_nodes {EXACT_MAX_NODES}, convex): "
                 f"{topt.get_status().name}, certified {mres.certified}, "
                 f"score {topt.get_score():.6f} (limit {COMPOSED_OPT} +- "
                 f"{COMPOSED_TOL}), boost schedule "
                 f"{np.round(boost, 4).tolist()}, xN {X[-1].tolist()}; "
                 f"{mres.nodes_solved} nodes in {mres.waves} waves, "
                 f"{mres.trips} trips, {topt.last_solve_seconds:.2f} s; "
                 f"{launches} kernel launches {f['launches_by']}; "
                 f"{f['programs']} program calls, {f['graph_launches']} "
                 f"graph launches, {f['captures']} captures")
    if topt.get_status() != Status.SOLVED or not mres.certified or not abs(
            topt.get_score() - COMPOSED_OPT) <= COMPOSED_TOL:
        raise AssertionError(f"exact composed: {f}")
    if not (np.abs(boost - np.round(boost)).max() < 2e-3
            and np.round(boost).max() == 1):
        raise AssertionError(f"the boost schedule {boost} is not an "
                             "integral one that switches on")
    if X.device.type != "cuda" or tuple(X_back.shape) != (7, 2) or float(
            (X_back - X.cpu().double()).abs().max()) > 1e-6:
        raise AssertionError("the composed demo's trajectory does not "
                             "save and read back from the card")
    if launches != mres.trips or set(by) != {
            ("smem",) + EXACT_SHAPES[1]}:
        raise AssertionError(f"exact composed: {launches} launches {by} "
                             f"for {mres.trips} trips")
    out["composed"] = f
    return out


def check_planners(torch, bt_cuda, cyclic_reduction):
    """Phase 12: the sampling planners on the default device; returns its
    findings. Every step raises on a miss."""
    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.core.problem import tree_flatten
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import dynamics, problems
    from etol_tpu_torch.models.tuned import tuned_extras
    from etol_tpu_torch.solve import al_sqp, planners

    sync = torch.cuda.synchronize
    SOLVED = int(Status.SOLVED)
    names = planners.PLANNERS + planners.EXTRA_PLANNERS
    out = {"uas_2d": {}, "seeded": {}, "facade": {}}

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    def on_card(label, *ts):
        for t in ts:
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: an output is not finite on "
                                     "the card")

    def trips_of(name, S):
        if name == "CEM":
            return 8  # rounds
        if name == "SHOOTING":
            return 1
        return planners.tree_shape(S)[2]

    vgp, nlp = problems.uas_2d(nsteps=MAIN_NSTEPS)
    nlp = dataclasses.replace(
        nlp, obstacle_form=tuned_extras("uas_2d")["obstacle_form"])
    data, dims = vgp.to_device()
    S = planners.budget_samples(dims.nsteps * vgp.dt)
    d0 = float(torch.linalg.norm(data.x0 - data.xf))
    plans = {}
    routes = (("eager", "eager"), ("graph_first", None), ("graph", None))
    for name in names:
        # eager, then on the graph: its key's first use (an eager run,
        # the capture, a replay) and a replay; each from seed 0
        runs, secs, calls = {}, {}, {}
        for side, route in routes:
            c0 = dict(TG.COUNTS)
            sync()
            t0 = time.perf_counter()
            with TG.override(route):
                runs[side] = planners.plan(name, nlp.dynamics, dims.nsteps,
                                           data, S, gen())
            sync()
            secs[side] = time.perf_counter() - t0
            calls[side] = (TG.COUNTS["captures"] - c0["captures"],
                           TG.COUNTS["programs"] - c0["programs"])
        if calls != {"eager": (0, 0), "graph_first": (1, 1),
                     "graph": (0, 1)}:
            raise AssertionError(f"{name}: captures and program calls "
                                 f"{calls}: the graph's first use should "
                                 "capture once and the next replay")
        ref = tree_flatten(runs["eager"])
        for side in ("graph_first", "graph"):
            if not all(torch.equal(a, b) for a, b in zip(
                    ref, tree_flatten(runs[side]))):
                raise AssertionError(f"{name}: X, U or an info tensor on "
                                     f"the graph ({side}) is not bitwise "
                                     "the eager route's")
        entry = latest(TG._Program)
        device_s = replay_ms(torch, entry.graph, reps=1) / 1e3
        X, U, info = runs["graph"]
        on_card(f"plan {name}", X, U)
        plans[name] = (X, U)
        dN = float(torch.linalg.norm(X[-1] - data.xf))
        trips = trips_of(name, S)
        if name in planners.PLANNERS:
            best = float(info["scores"][info["best"]])
            prio = info["cell_priority"]
            found = dict(n_nodes=int(info["n_nodes"]),
                         n_pruned=int(info["n_pruned"]),
                         best_depth=int(info["best_depth"]),
                         # a cell picked 128 times overflows float32 to
                         # inf (in the JAX package too) and then reads as
                         # empty
                         max_finite_priority=float(prio[torch.isfinite(
                             prio)].max()),
                         inf_priority_cells=int(torch.isinf(prio).sum()))
        elif name == "CEM":
            best, found = float(info["best_score"]), {}
        else:
            best = float(info["scores"].min())
            found = dict(valid_fraction=float(info["valid_fraction"]))
        found = dict(samples=S, trips=trips, seconds=secs["graph"],
                     seconds_eager=secs["eager"],
                     seconds_graph_first=secs["graph_first"],
                     device_s=device_s, busy=device_s / secs["graph"],
                     s_per_trip=secs["graph"] / trips,
                     s_per_trip_eager=secs["eager"] / trips,
                     staged_bytes=entry.static_bytes,
                     pool_bytes=entry.pool_bytes, bitwise=True,
                     best_score=best, valid=best < 1e6, goal_dist=dN,
                     start_dist=d0, **found)
        say("planners", f"uas_2d N={dims.nsteps} {name}: {found}")
        if name == "SST":
            # SST's witness cells (grid 16 over the 40 x 40 box: 2.5 wide)
            # are wider than one extension (at most 1.6), so on uas_2d a
            # child never leaves its parent's cell cheaper than the cell's
            # champion: the tree stops at the root and the champions of
            # the two cells beside it, in the JAX package as here
            # (tests/test_torch_planners.py::
            # test_sst_stops_on_uas_as_the_reference). Its check is SST's
            # own invariant: the root and one live champion a witness cell.
            cells = int(torch.isfinite(info["witness_cost"]).sum())
            if found["n_nodes"] != 1 + cells or found["n_pruned"] <= 0:
                raise AssertionError(f"SST's tree is not the root and one "
                                     f"champion a cell: {found}, {cells}")
        elif not dN < 0.5 * d0:
            raise AssertionError(f"{name} ends {dN} from the goal, the "
                                 f"start is {d0}")
        out["uas_2d"][name] = found

    # planner-seeded solves: the KKT kernel at a batch of one
    for name in SEEDED:
        z0 = planners.plan_guess(nlp, data, S, gen(), planner=name)
        if not torch.equal(z0, torch.cat(plans[name], dim=-1).reshape(-1)):
            raise AssertionError(f"{name}: plan_guess is not the plan of "
                                 "the same seed")
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        res = al_sqp.solve(nlp, al_sqp.SolverConfig(kkt_solver="kernel"),
                           data, z0)
        sync()
        secs = time.perf_counter() - t0
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        iters = int(res.inner_iters)
        found = dict(status=int(res.status), obj=float(res.obj),
                     iters=iters, seconds=secs, launches=bt_cuda.TALLY.count,
                     cr_solves=cyclic_reduction.TALLY.count,
                     launches_by={"K%d_w%d_B%d" % k[1:]: n
                                  for k, n in sorted(by.items())})
        say("planners", f"{name}-seeded al_sqp.solve, kkt_solver=kernel: "
                        f"{found}")
        on_card(f"{name}-seeded solve", res.z)
        if found["status"] != SOLVED:
            raise AssertionError(f"the {name}-seeded solve: {found}")
        if by != {("smem",) + B1_SHAPE: iters} or \
                found["cr_solves"]:
            raise AssertionError(
                f"the {name}-seeded solve: {iters} iterations should be "
                f"{iters} launches at {B1_SHAPE}, no cyclic reduction")
        assert_checked(f"planners {name}-seeded", by)
        out["seeded"][name] = found

    # the facade, eOMPL's backend role, at the problem-derived budget
    topt = TrajectoryOptimizer()
    topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    d0 = float(torch.linalg.norm(topt.data.x0 - topt.data.xf))
    for name in names:
        topt.set_planner(name)
        res = topt.plan(solve_time=FACADE_PLAN_SECONDS, generator=gen())
        _, X = topt.get_xtraj()
        on_card(f"facade plan {name}", res.z)
        dN = float(torch.linalg.norm(X[-1] - topt.data.xf))
        found = dict(
            samples=planners.budget_samples(FACADE_PLAN_SECONDS),
            status=Status(int(res.status)).name,
            seconds=topt.last_solve_seconds, goal_dist=dN, start_dist=d0,
            viol_in=float(res.viol_in))
        say("planners", f"facade set_planner({name!r}) + plan() on "
                        f"ocp_2d_ex1.xml: {found}")
        if not dN < 0.5 * d0:
            raise AssertionError(f"facade {name} ends {dN} from the goal")
        out["facade"][name] = found
    return out


def check_fleet(torch, bt_cuda, cyclic_reduction):
    """Phase 13: the multi-vehicle model on the default device; returns its
    findings. Every step raises on a miss."""
    import numpy as np

    from etol_tpu_torch.core.problem import batch_tile
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models.fleet import fleet_2d, min_pairwise_distance
    from etol_tpu_torch.solve import al_sqp

    SOLVED = int(Status.SOLVED)
    batch = FLEET_B
    out = {}

    def run(label, nlp, data, route, batched=False, warm=None):
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        solve = al_sqp.solve_batched if batched else al_sqp.solve
        args = () if warm is None else (
            warm.z, (warm.lam_def, warm.lam_eq, warm.mu), warm.rho)
        res = solve(nlp, al_sqp.SolverConfig(kkt_solver=route), data, *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        assert_checked(f"fleet {label}", by)
        assert_ls_trips(f"fleet {label}", by)  # separation rows: none
        if res.z.device.type != "cuda" or not bool(
                torch.isfinite(res.z).all()):
            raise AssertionError(f"fleet {label}: z is not finite on the "
                                 "card")
        return res, dict(seconds=secs, launches=bt_cuda.TALLY.count,
                         cr_solves=cyclic_reduction.TALLY.count,
                         launches_by={"K%d_w%d_B%d" % k[1:]: n
                                      for k, n in sorted(by.items())})

    # three vehicles: w = 12, cyclic reduction under both route names. The
    # "cr" side is a warm re-solve of the same problem from the "kernel"
    # side's result: cold, it would repeat the same solve (114 trips of
    # ~300 ms)
    vgp, nlp = fleet_2d(n_vehicles=3)
    data, dims = vgp.to_device()
    cold = None
    for route in ("kernel", "cr"):
        res, found = run(f"V=3 {route}", nlp, data, route, warm=cold)
        X, _ = nlp.unpack(res.z)
        found.update(status=int(res.status), obj=float(res.obj),
                     iters=int(res.inner_iters),
                     viol=[float(res.viol_eq), float(res.viol_in)],
                     goal_err=float((X[-1] - data.xf).abs().max()),
                     dmin=float(min_pairwise_distance(X, 3)))
        say("fleet", f"fleet_2d V=3 (K={dims.nodes}, w={dims.node_width}), "
                     f"kkt_solver={route}{'' if cold is None else ', warm'}"
                     f": {found}")
        if found["status"] != SOLVED or found["goal_err"] > FLEET_GOAL_TOL \
                or found["dmin"] < FLEET_DMIN:
            raise AssertionError(f"fleet V=3 under {route}: {found}")
        if found["launches"] or \
                found["cr_solves"] != found["iters"] or \
                found["iters"] <= 0:
            raise AssertionError(
                f"fleet V=3 under {route}: w=12 should take cyclic "
                f"reduction for every iteration and launch nothing")
        out[f"v3_{route}"] = found
        cold = res
    # the warm re-solve stays in the cold solve's valley: its objective
    # trades against the violation there within tol_cons (0.44% in 3
    # iterations on an H100, 3.8e-4 in 6 on a CPU; the JAX package's two
    # routes end 0.27% apart from cold), so it is held to 1%, and to fewer
    # iterations than the cold solve
    if abs(out["v3_cr"]["obj"] / out["v3_kernel"]["obj"] - 1) > 1e-2 or \
            out["v3_cr"]["iters"] >= out["v3_kernel"]["iters"]:
        raise AssertionError("fleet V=3: the warm re-solve left the cold "
                             "solve's answer")

    # two vehicles: w = 8 on the kernel; starts moved by the parity
    # test's draw (the default head-on pair never separates, MAX_ITER in
    # both packages)
    rng = np.random.default_rng(FLEET_SEED)
    vgp, nlp = fleet_2d(n_vehicles=2)
    circle = np.asarray(vgp.x0).reshape(2, 2)
    goals = np.asarray(vgp.xf).reshape(2, 2)
    vgp, nlp = fleet_2d(n_vehicles=2, starts=circle + rng.uniform(
        -FLEET_SPREAD, FLEET_SPREAD, size=(2, 2)), goals=goals)
    data, dims = vgp.to_device()
    res, found = run("V=2", nlp, data, "kernel")
    X, _ = nlp.unpack(res.z)
    found.update(status=int(res.status), obj=float(res.obj),
                 iters=int(res.inner_iters),
                 viol=[float(res.viol_eq), float(res.viol_in)],
                 dmin=float(min_pairwise_distance(X, 2)))
    say("fleet", f"fleet_2d V=2 (K={dims.nodes}, w={dims.node_width}) "
                 f"single, kkt_solver=kernel: {found} (the JAX package on a "
                 f"CPU: {FLEET2_OBJ}, limit {FLEET2_RTOL} relative)")
    if found["status"] != SOLVED or abs(found["obj"] / FLEET2_OBJ - 1) > \
            FLEET2_RTOL or found["dmin"] < FLEET_DMIN:
        raise AssertionError(f"fleet V=2: {found}")
    if found["launches_by"] != {"K25_w8_B1": found["iters"]}:
        raise AssertionError(f"fleet V=2: launches {found['launches_by']}"
                             f" for {found['iters']} iterations")
    out["v2"] = found

    # a batch of two-vehicle fleets: the default pair's starts moved by a
    # fixed draw within +-FLEET_SPREAD
    x0 = (np.asarray(fleet_2d(n_vehicles=2)[0].x0)[None, :] + rng.uniform(
        -FLEET_SPREAD, FLEET_SPREAD, size=(batch, 4))).astype(np.float32)
    vgp, nlp = fleet_2d(n_vehicles=2)
    single, _ = vgp.to_device()
    bdata = dataclasses.replace(batch_tile(single, batch),
                                x0=torch.tensor(x0, device=single.x0.device))
    res, found = run(f"batch of {batch}", nlp, bdata, "kernel", batched=True)
    ok = res.status == SOLVED
    trips = int(res.inner_iters.max())
    Xb = res.z.reshape(batch, dims.nodes, -1)[:, :, :4]
    dmins = torch.stack([min_pairwise_distance(Xb[i], 2)
                         for i in range(batch)])
    found.update(batch=batch, solved_fraction=float(ok.float().mean()),
                 trips=trips, mean_iters=float(res.inner_iters.float().mean()),
                 min_dmin_solved=float(dmins[ok].min()) if bool(ok.any())
                 else None)
    say("fleet", f"{batch} two-vehicle fleets, solve_batched, kkt_solver="
                 f"kernel: {found}")
    if not found["solved_fraction"] >= 0.9 or not (
            found["min_dmin_solved"] >= FLEET_DMIN):
        raise AssertionError(f"the batch of fleets: {found}")
    if found["launches_by"] != {f"K25_w8_B{batch}": trips}:
        raise AssertionError(f"the batch of fleets: launches "
                             f"{found['launches_by']} for {trips} trips")
    out["batch"] = found
    return out


def check_parallel(torch, bt_cuda, btridiag, cyclic_reduction):
    """Phase 14: the parallel layer on the card; returns its findings.
    Every step raises on a miss."""
    import contextlib
    import io
    import socket

    from etol_tpu_torch import cli
    from etol_tpu_torch.parallel import distributed, kkt, make_mesh
    from etol_tpu_torch.parallel.dryrun import dryrun_multichip
    from etol_tpu_torch.solve import al_sqp

    sync = torch.cuda.synchronize
    out = {}

    def counts(path):
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        assert_checked(f"parallel {path}", by)
        return bt_cuda.TALLY.count, {"K%d_w%d_B%d" % k[1:]: n
                                  for k, n in sorted(by.items())}, by

    # -- SPIKE against the direct launch and the plain version, B=1
    systems = {K: spd_problem(torch, 1, K, SPIKE_W, seed=K) for K in SPIKE_K}
    meshes = {n: make_mesh(["cuda"] * n, axis_names=("horizon",))
              for n in SPIKE_N}
    solvers = {(n, route): kkt.make_solver(meshes[n], "horizon", route)
               for n in SPIKE_N for route in kkt.ROUTES}
    reset_counts(bt_cuda, cyclic_reduction)
    xs = {(K, n): solvers[n, "kernel"](*systems[K])
          for K in SPIKE_K for n in SPIKE_N}
    sync()
    launches, by_name, by = counts("spike")
    want = {}
    for K in SPIKE_K:
        for n in SPIKE_N:
            for shape in spike_shapes(K, SPIKE_W, n):
                want[("smem",) + shape] = want.get(("smem",) + shape, 0) + 1
    if by != want:
        raise AssertionError(f"SPIKE launches {by}, expected {want}")
    out["spike_launches"] = launches

    def refined(f, D, O, r):
        # what the solver's override does: a solve and one refinement pass
        x = f(D, O, r)
        return x + f(D, O, r - btridiag.matvec(D, O, x))

    rows = {}
    for K in SPIKE_K:
        D, O, r = systems[K]
        direct = bt_cuda.solve(D, O, r)
        sync()
        t0 = time.perf_counter()
        plain = btridiag.solve_refined(D, O, r)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        limit = 2e-4 * (1.0 + float(plain.abs().max()))
        direct_ms = host_ms(torch, lambda: bt_cuda.solve(D, O, r),
                            reps=SPIKE_REPS)
        for n in SPIKE_N:
            x = xs[K, n]
            row = dict(
                variant_direct=bt_cuda.plan(K, SPIKE_W, 1).variant,
                err_direct=float((x - direct).abs().max()),
                err_plain=float((x - plain).abs().max()),
                resid=float((r - btridiag.matvec(D, O, x)).abs().max()),
                spike_ms=host_ms(
                    torch, lambda: solvers[n, "kernel"](D, O, r),
                    reps=SPIKE_REPS),
                spike_refined_ms=host_ms(
                    torch, lambda: refined(solvers[n, "kernel"], D, O, r),
                    reps=SPIKE_REPS),
                spike_plain_ms=host_ms(
                    torch, lambda: solvers[n, "scan"](D, O, r), reps=3),
                direct_ms=direct_ms, plain_direct_ms=plain_ms)
            say("parallel", f"SPIKE B=1 K={K} w={SPIKE_W} over n={n} "
                            f"slabs: {row} (host ms with a sync, median of "
                            f"{SPIKE_REPS}; the plain SPIKE of 3; the plain "
                            f"direct solve one call; limit {limit:.3e})")
            if not (row["err_direct"] <= limit and row["err_plain"] <= limit):
                raise AssertionError(f"SPIKE disagrees at K={K}, n={n}")
            rows[f"K{K}_n{n}"] = row
    out["spike"] = rows

    # -- the dry run, every mesh entry the card
    reset_counts(bt_cuda, cyclic_reduction)
    t0 = time.perf_counter()
    dry = dryrun_multichip(DRYRUN_N, horizon_nsteps=DRYRUN_NSTEPS)
    sync()
    dry["seconds"] = time.perf_counter() - t0
    dry["launches"], dry["launches_by"], by = counts("dryrun")
    say("parallel", f"dryrun_multichip({DRYRUN_N}): {dry}")
    need = [("smem",) + shape for shape in
            spike_shapes(DRYRUN_NSTEPS + 1, 4, DRYRUN_N)
            + ((DRYRUN_NSTEPS + 1, 4, 1), (8, 5, 8))]
    if not all(by.get(key) for key in need) or cyclic_reduction.TALLY.count:
        raise AssertionError(f"the dry run's launches {by}: every KKT solve "
                             f"should be the kernel, at {need}")
    out["dryrun"] = dry

    # -- one long horizon: the dry run's problem at K = LONG_NSTEPS + 1,
    # unsharded (every KKT solve one launch of the stream kernel) and
    # horizon-sharded over DRYRUN_N slabs (shared-memory launches), held to
    # each other as the dry run holds its K=512 pair
    out["long_horizon"] = check_long_horizon(
        torch, bt_cuda, cyclic_reduction, counts)

    # -- cli fleet_batch, in-process
    reset_counts(bt_cuda, cyclic_reduction)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.fleet_batch([str(FLEET_BATCH_B)])
    text = text.getvalue()
    launches, by_name, by = counts("cli fleet_batch")
    solved = float(text.split("solved: ")[1].split("%")[0]) / 100
    say("parallel", f"cli fleet_batch {FLEET_BATCH_B}: exit code {rc}; "
                    + " | ".join(text.strip().splitlines())
                    + f"; {launches} kernel launches {by_name}")
    if rc != 0 or not solved >= 0.95 or set(by) != {
            ("smem", 51, 5, FLEET_BATCH_B)}:
        raise AssertionError(f"cli fleet_batch: solved {solved}, {by}")
    out["fleet_batch"] = dict(solved_fraction=solved, launches=launches,
                              output=text.strip().splitlines())

    # -- two ranks on this card over gloo, against this process's solve
    reset_counts(bt_cuda, cyclic_reduction)
    res = al_sqp.solve_batched(*distributed.demo_problem("cuda", DIST_B))
    obj = res.obj.tolist()
    counts("distributed parent")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(DIST_RANKS):
            env = dict(os.environ, ETOL_COORDINATOR=f"127.0.0.1:{port}",
                       ETOL_NUM_PROCS=str(DIST_RANKS),
                       ETOL_PROC_ID=str(rank),
                       PYTHONPATH=HERE + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etol_tpu_torch.parallel.distributed",
                 "--device", "cuda:0", "--backend", "gloo"],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for rank, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} failed:\n{text[-3000:]}")
        found = json.loads([line for line in text.splitlines()
                            if line.startswith("{")][-1])
        say("parallel", f"rank {rank} of {DIST_RANKS} on cuda:0 over gloo: "
                        f"{found}")
        err = max(abs(a - b) for a, b in zip(found["obj"], obj))

        def shapes(by):
            return {tuple(int(v) for v in re.findall(r"\d+", k)): n
                    for k, n in by.items()}

        assert_checked(f"parallel rank {rank}",
                       {("rank",) + k: n
                        for k, n in shapes(found["launches_by"]).items()},
                       shapes(found["ls_launches_by"]))
        if (found["statuses"] != [1] * (DIST_B // DIST_RANKS)
                or not err <= 1e-4 or found["warm_solved"] != 1.0
                or found["horizon"]["status"] != 1
                or found["launches"] <= 0):
            raise AssertionError(f"rank {rank}: |dobj| {err}: {found}")
        found["max_abs_dobj"] = err
        ranks.append(found)
    out["distributed"] = dict(obj_single_process=obj, ranks=ranks)
    return out


def check_long_horizon(torch, bt_cuda, cyclic_reduction, counts):
    """The parallel phase's long-horizon step: ``horizon_problem`` at K =
    LONG_NSTEPS + 1 (w = 4, B = 1) solved by ``al_sqp.solve`` and by
    ``solve_horizon_sharded`` over DRYRUN_N slabs, from the dry run's seed
    and with its config; both must be SOLVED and agree within the dry
    run's limits, every unsharded launch must be the stream kernel at (K,
    4, 1) and every sharded one the shared-memory kernel at the slabs'
    shapes. Returns the two runs' findings."""
    from etol_tpu_torch.parallel import make_mesh
    from etol_tpu_torch.parallel.dryrun import horizon_problem
    from etol_tpu_torch.parallel.solve_sharded import solve_horizon_sharded
    from etol_tpu_torch.solve import al_sqp
    from etol_tpu_torch.solve.al_sqp import SolverConfig

    K = LONG_NSTEPS + 1
    nlp, data, z0 = horizon_problem(LONG_NSTEPS)
    cfg = SolverConfig(max_total=900, tol_cons=3e-4)
    mesh = make_mesh(["cuda"] * DRYRUN_N, axis_names=("horizon",))
    want = {
        "unsharded": {("stream", K, 4, 1)},
        "sharded": {("smem",) + shape
                    for shape in spike_shapes(K, 4, DRYRUN_N)},
    }
    out, res = {}, {}
    for name in ("unsharded", "sharded"):
        reset_counts(bt_cuda, cyclic_reduction)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "unsharded":
            r = al_sqp.solve(nlp, cfg, data, z0)
        else:
            r = solve_horizon_sharded(nlp, cfg, data, mesh, z0=z0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, _, by = counts(f"long horizon {name}")
        res[name] = r
        out[name] = dict(
            status=int(r.status), obj=float(r.obj),
            trips=int(r.inner_iters), viol_eq=float(r.viol_eq),
            viol_in=float(r.viol_in), seconds=seconds, launches=launches,
            launches_by={"%s_K%d_w%d_B%d" % key: n
                         for key, n in sorted(by.items())},
            cr_solves=cyclic_reduction.TALLY.count)
        say("parallel", f"long horizon K={K} w=4 B=1 {name}: "
                        f"{out[name]}")
        if set(by) != want[name] or cyclic_reduction.TALLY.count:
            raise AssertionError(f"long horizon {name}: launches {by}, "
                                 f"expected every one at {want[name]}")
        if out[name]["status"] != 1:
            raise AssertionError(f"long horizon {name}: status "
                                 f"{out[name]['status']}, not SOLVED")
    obj = out["unsharded"]["obj"]
    dobj = abs(out["sharded"]["obj"] - obj)
    dz = float((res["sharded"].z - res["unsharded"].z).abs().max())
    say("parallel", f"long horizon K={K}: |dobj| {dobj:.3e} (limit "
                    f"{1e-3 + 1e-3 * abs(obj):.3e}), max|dz| {dz:.3e} "
                    "(limit 2e-2)")
    if not (dobj < 1e-3 + 1e-3 * abs(obj) and dz < 2e-2):
        raise AssertionError(f"long horizon: the sharded solve drifted "
                             f"from the unsharded one: {dobj}, {dz}")
    out.update(K=K, dobj=dobj, dz=dz)
    return out


def check_variants(torch, bench_harness, bt_cuda, cyclic_reduction):
    """Phase 15: the solver's line-search and Levenberg variants on the
    card; returns its findings. Every launch must be at a checked shape,
    and every solved lane must pass the exact audit at ``tol_cons``."""
    import numpy as np

    from etol_tpu_torch import TrajectoryOptimizer, cli
    from etol_tpu_torch.core.problem import map_lanes
    from etol_tpu_torch.core.types import Status
    from etol_tpu_torch.models import dynamics
    from etol_tpu_torch.solve import al_sqp

    SOLVED = int(Status.SOLVED)
    out = {"uas": {}, "ocp": {}}

    def counts(path):
        TG.settle()
        by = dict(bt_cuda.TALLY.by)
        assert_checked(f"variants {path}", by)
        if bt_cuda.TALLY.count <= 0 or cyclic_reduction.TALLY.count:
            raise AssertionError(
                f"variants {path}: {bt_cuda.TALLY.count} kernel launches and "
                f"{cyclic_reduction.TALLY.count} cyclic-reduction solves; every "
                "KKT solve should be a launch")
        return bt_cuda.TALLY.count, {f"K{k[1]}_w{k[2]}_B{k[3]}": n for k, n in
                                  sorted(by.items(), key=lambda kv: -kv[0][3])}

    # -- uas_2d N=50 at VARIANT_B: the bench's problem and seeds, made
    # anew from one seed for every run, so each run gets the same batch
    for name, knobs in VARIANT_RUNS:
        nlp, cfg, stages, data, gen = bench_harness.prepare(
            VARIANT_B, MAIN_NSTEPS, seed=VARIANT_SEED)
        cfg = dataclasses.replace(cfg, **knobs)
        reset_counts(bt_cuda, cyclic_reduction)
        cold = bench_harness.run_cold(nlp, cfg, data, stages, gen)
        launches, by = counts(name)
        res = cold["result"]
        ok = res.status == SOLVED
        viol = torch.maximum(res.viol_eq, res.viol_in)
        viol_ok = float(viol[ok].max()) if bool(ok.any()) else 0.0
        row = dict(solved=cold["solved_fraction"],
                   trips=cold["stage_trips"], seconds=cold["cold_s"],
                   seed_seconds=cold["seed_s"], launches=launches,
                   launches_by=by, viol_max_solved=viol_ok,
                   audit_node_depth_max=cold["audit_node_depth_max"])
        say("variants", f"uas_2d N={MAIN_NSTEPS} B={VARIANT_B} {name} "
                        f"{knobs}: solved {row['solved']:.4f}, stage trips "
                        f"{row['trips']} ({sum(row['trips'])}), cold solve "
                        f"{row['seconds']:.2f} s (seeds "
                        f"{row['seed_seconds']:.2f} s), {launches} kernel "
                        f"launches {by}; solved lanes: max violation "
                        f"{viol_ok:.3e}, exact audit's deepest node "
                        f"{row['audit_node_depth_max']:.3e} (limit "
                        f"tol_cons {cfg.tol_cons:g})")
        if not bool(ok.any()):
            raise AssertionError(f"variants {name}: no lane solved")
        if not (viol_ok <= cfg.tol_cons
                and row["audit_node_depth_max"] <= cfg.tol_cons):
            raise AssertionError(
                f"variants {name}: a solved lane fails the audit at "
                f"tol_cons ({viol_ok}, {row['audit_node_depth_max']})")
        if not bool(torch.isfinite(res.z).all()):
            raise AssertionError(f"variants {name}: non-finite z")
        out["uas"][name] = row

    # -- the canonical OCP through the facade under tests/test_solver.py's
    # three knob configurations: each SOLVED with viol_eq < 1e-4
    for name, knobs in OCP_KNOBS:
        reset_counts(bt_cuda, cyclic_reduction)
        topt = TrajectoryOptimizer(al_sqp.SolverConfig(**knobs))
        topt.load_configs(cli.default_config("ocp_2d_ex1.xml"))
        topt.set_dynamics(dynamics.single_integrator)
        topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
        topt.setup()
        res = topt.solve()
        launches, by = counts(f"ocp {name}")
        row = dict(status=topt.get_status().name, score=topt.get_score(),
                   viol_eq=float(res.viol_eq), iterations=int(res.inner_iters),
                   seconds=topt.last_solve_seconds, launches=launches,
                   launches_by=by)
        say("variants", f"ocp_2d_ex1.xml through the facade, {knobs}: "
                        f"{row['status']}, score {row['score']:.6f}, viol_eq "
                        f"{row['viol_eq']:.3e}, {row['iterations']} "
                        f"iterations in {row['seconds']:.2f} s, {launches} "
                        f"launches {by}")
        if int(res.status) != SOLVED or not row["viol_eq"] < 1e-4:
            raise AssertionError(f"variants: the OCP under {knobs} ended "
                                 f"{row['status']}, viol_eq {row['viol_eq']}")
        out["ocp"][name] = row

    # -- one newton_step of NEWTON_B lanes on the kernel, held against the
    # same step on the plain "scan" route on the card
    nlp, cfg, _, data, _ = bench_harness.prepare(NEWTON_B, MAIN_NSTEPS,
                                                 seed=VARIANT_SEED)
    z0 = map_lanes(nlp.initial_guess, data)
    lam = al_sqp.init_multipliers(nlp, data)
    rho = torch.full((NEWTON_B,), cfg.rho0, device=z0.device)
    Z = z0.reshape(NEWTON_B, *NEWTON_SHAPE[:2])
    steps = {}
    for route in ("kernel", "scan"):
        F = al_sqp._ALFuncs(nlp, dataclasses.replace(cfg, kkt_solver=route),
                            data)
        reset_counts(bt_cuda, cyclic_reduction)
        t0 = time.perf_counter()
        steps[route] = F.newton_step(Z, *lam, rho)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if route == "kernel":
            launches, by = counts("newton_step")
            if by != {"K%d_w%d_B%d" % NEWTON_SHAPE: 1}:
                raise AssertionError(
                    f"newton_step launched {by}, not once at {NEWTON_SHAPE}")
            out["newton_step"] = dict(launches=launches, launches_by=by,
                                      ms=ms)
    (Zk, lmk, dk), (Zs, lms, ds) = steps["kernel"], steps["scan"]
    dz = float((Zk - Zs).abs().max())
    scale = 1.0 + float(Zs.abs().max())
    out["newton_step"].update(
        max_abs_dz_vs_scan=dz, ls_ok=int(dk["ls_ok"].sum()),
        ls_steps=dk["ls_steps"].tolist())
    say("variants", f"newton_step, {NEWTON_B} uas_2d lanes, kernel route: "
                    f"{out['newton_step']['ms']:.1f} ms with a sync, "
                    f"launches {out['newton_step']['launches_by']}, passed "
                    f"{int(dk['ls_ok'].sum())} of {NEWTON_B}, backtracks "
                    f"{dk['ls_steps'].tolist()}; max |Z_kernel - Z_scan| "
                    f"{dz:.3e} (limit {1e-4 * scale:.3e})")
    if not (torch.equal(dk["ls_ok"], ds["ls_ok"])
            and torch.equal(dk["ls_steps"], ds["ls_steps"])
            and dz <= 1e-4 * scale
            and np.allclose(lmk.cpu().numpy(), lms.cpu().numpy(),
                            rtol=1e-6)):
        raise AssertionError("newton_step on the kernel disagrees with the "
                             "plain route")
    return out


def main(phases=PHASES):
    """Phases 1 and 2, then the named ones in order; the two result lines
    are printed only when every phase ran."""
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a card")
    if not os.path.isfile(os.path.join(HERE, "etol_tpu_torch",
                                       "__init__.py")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (etol_tpu_torch/ not found)")
    sys.path.insert(0, HERE)

    clock = Clock()
    # 1. device
    CARD = card_line()
    print(CARD, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")

    # 2. build
    from etol_tpu_torch import bench_harness, bench_scaling
    from etol_tpu_torch.ops import bt_cuda, cyclic_reduction
    from etol_tpu_torch.solve import btridiag

    from etol_tpu_torch.ops import graph_loop
    from etol_tpu_torch.solve import trip_graph

    from etol_tpu_torch.ops import hs_coupling, ls_candidates

    global TG, GL, HS, LS
    TG, GL, HS, LS = trip_graph, graph_loop, hs_coupling, ls_candidates
    # the four sources at once, one nvcc each
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(bt_cuda.build), pool.submit(graph_loop.build),
                  pool.submit(hs_coupling.build),
                  pool.submit(ls_candidates.build)]
        for done in builds:
            done.result()
    say("build", f"bt_solve.cu, graph_loop.cu, hs_coupling.cu and "
                 f"ls_candidates.cu built and loaded in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc "
                 f"{bt_cuda.BUILD_SECONDS} s, {graph_loop.BUILD_SECONDS} s, "
                 f"{hs_coupling.BUILD_SECONDS} s and "
                 f"{ls_candidates.BUILD_SECONDS} s)")
    nvcc = subprocess.run([bt_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    versions = graph_loop.VERSIONS
    say("build", f"CUDA runtime {versions['runtime']} (graph_loop.cu), CUDA "
                 f"driver {versions['cuda_driver']}, torch's CUDA "
                 f"{torch.version.cuda}, {nvcc[-1]}")
    for line in graph_loop.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            say("build", "loop_cond_kernel: "
                + line.replace("ptxas info    :", "").strip())
    entry = None
    for line in bt_cuda.BUILD_LOG.splitlines():
        m = re.search(r"bt_(smem|stream)_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            entry = f"{m.group(1)} W={m.group(2)}"
        elif entry and ("registers" in line or "spill" in line):
            info = line.replace("ptxas info    :", "").strip()
            say("build", f"{entry}: {info}")
    entry = None
    for line in hs_coupling.BUILD_LOG.splitlines():
        m = re.search(r"hs_coupling_kernelI\w*?Lb(\d)E", line)
        if m and "Compiling entry function" in line:
            entry = f"hs_coupling exact={m.group(1)}"
        elif entry and ("registers" in line or "spill" in line):
            info = line.replace("ptxas info    :", "").strip()
            say("build", f"{entry}: {info}")
    entry = None
    for line in ls_candidates.BUILD_LOG.splitlines():
        m = re.search(r"ls_candidates_kernelILi(\d)ELi(\d)ELi(\d+)ELb(\d)E",
                      line)
        if m and "Compiling entry function" in line:
            entry = (f"ls_candidates nx={m.group(1)} nu={m.group(2)} "
                     f"G={m.group(3)} chosen={m.group(4)}")
        elif entry and ("registers" in line or "spill" in line):
            info = line.replace("ptxas info    :", "").strip()
            say("build", f"{entry}: {info}")
    clock.lap("build")

    # 3. the kernels vs plain, and their times
    if "kernel" in phases:
        shapes = path_shapes(bench_scaling)
        max_abs_err, times = check_kernel(torch, bt_cuda, btridiag, shapes)
        hs_err, hs_times, hs_ops = check_hs(
            torch, tuple(dict.fromkeys(tuple(shapes) + LONG_SHAPES
                                       + RAGGED_SHAPES)))
        ls_err, ls_times, ls_ops = check_ls(
            torch, tuple(dict.fromkeys(tuple(shapes) + LONG_SHAPES)))
        clock.lap("kernel")

    # 4. main path, on the default device
    if "main" in phases:
        TG.settle()
        bt_cuda.TALLY.clear()
        c0 = (TG.COUNTS["programs"], TG.COUNTS["trips"], GL.LAUNCHES,
              GL.TRIPS)
        hs0 = HS.TALLY.count, dict(HS.TALLY.by)
        ls0 = LS.TALLY.count
        out = bench_harness.main_path(MAIN_B, MAIN_NSTEPS)
        TG.settle()
        launches = bt_cuda.TALLY.count
        launches_by = dict(bt_cuda.TALLY.by)
        main_hs = {k: n - hs0[1].get(k, 0)
                   for k, n in HS.TALLY.by.items()
                   if n > hs0[1].get(k, 0)}
        main_loop = dict(programs=TG.COUNTS["programs"] - c0[0],
                         trips=TG.COUNTS["trips"] - c0[1],
                         cond_launches=GL.LAUNCHES - c0[2],
                         loop_trips=GL.TRIPS - c0[3])
        check_main(torch, out, launches, launches_by, main_loop)
        say("main", f"hs_coupling launches during the main path: "
                    f"{HS.TALLY.count - hs0[0]}; by (K, w, batch): "
                    f"{sorted(main_hs.items(), key=lambda kv: -kv[0][2])}")
        if main_hs != {k[1:]: n for k, n in launches_by.items()}:
            raise AssertionError(
                f"the main path launched the step coupling {main_hs}, the "
                f"KKT kernel {launches_by}: one of each a trip")
        if LS.TALLY.count != ls0:
            raise AssertionError(
                f"the main path (Hermite-Simpson) launched the line search "
                f"kernel {LS.TALLY.count - ls0} times")
        clock.lap("main")

    # 4b. the bench's seeds on their program's graph
    if "graph" in phases:
        graph = check_graph(torch, bench_harness, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "graph", "card": CARD, **graph}),
              flush=True)
        clock.lap("graph")

    # 4c. the solver loop as a device-side while, the staged solve as one
    # program, against the eager and the replayed loop
    if "loop" in phases:
        loop = check_loop(torch, bench_harness, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "loop", "card": CARD, **loop}),
              flush=True)
        clock.lap("loop")

    # 4d. the rescue and multistart as one program each
    if "programs" in phases:
        progs = check_programs(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "programs", "card": CARD, **progs}),
              flush=True)
        clock.lap("programs")

    # 5. in-situ A/B: kernel vs the plain scan path, same batch and seeds
    if "a/b" in phases:
        def solve(kkt):
            nlp, cfg, stages, data, gen = bench_harness.prepare(
                AB_B, MAIN_NSTEPS, seed=1, kkt_solver=kkt)
            cold = bench_harness.run_cold(nlp, cfg, data, stages, gen)
            return cold["result"], cold["stage_trips"]

        ab_runs(torch, bt_cuda, f"uas_2d N={MAIN_NSTEPS}", solve)
        clock.lap("a/b")

    # 6. cyclic reduction, and the B=1 routes
    if "cr" in phases:
        b1 = check_cr(torch, bt_cuda, btridiag, cyclic_reduction)
        clock.lap("cr")

    # 7. the single-problem MPC re-solve
    if "mpc" in phases:
        mpc = check_mpc(torch, bench_harness, bt_cuda, cyclic_reduction)
        clock.lap("mpc")

    # 8. the bench entry point; its JSON line goes out on a line of its
    # own, well before the last two
    if "bench" in phases:
        TG.settle()
        bt_cuda.TALLY.clear()
        bench_line = bench_harness.bench(
            MAIN_B, MAIN_NSTEPS, iters=1,
            mpc=mpc["kernel"] if "mpc" in phases else None)
        print(json.dumps(bench_line), flush=True)
        TG.settle()
        bench_launches = bt_cuda.TALLY.count
        assert_checked("bench", bt_cuda.TALLY.by)
        ex = bench_line["extras"]
        say("bench", f"{bench_line['value']} solved solves/s at B={MAIN_B} "
                     f"(solved {ex['solved_fraction']:.4f}), warm "
                     f"{ex['warm_solves_per_s_per_chip']} (solved "
                     f"{ex['warm_solved_fraction']:.4f}); "
                     f"{bench_launches} kernel launches")
        if not (ex["solved_fraction"] >= 0.95
                and ex["warm_solved_fraction"] >= 0.95
                and ex["audit_node_depth_max"] <= 1e-3):
            raise AssertionError(f"the bench line is unhealthy: {ex}")
        if bench_launches <= 0:
            raise AssertionError("the bench launched no kernel")
        clock.lap("bench")

    # 9. the ladder's other models
    if "ladder" in phases:
        ladder = check_ladder(torch, bench_scaling, bt_cuda)
        clock.lap("ladder")

    # 10. the library's entry point; its JSON line goes out before the
    # last two
    if "facade" in phases:
        hs0 = HS.TALLY.count
        facade = check_facade(torch, bt_cuda, cyclic_reduction)
        TG.settle()
        if HS.TALLY.count != hs0:
            raise AssertionError(
                f"the facade's ocp_2d_ex1 and mip_2d_ex1 solves launched the "
                f"step coupling {HS.TALLY.count - hs0} times: their schemes "
                "take the plain routes")
        say("facade", "no step coupling launch (trapezoidal and euler)")
        print(json.dumps({"phase": "facade", "card": CARD, **facade}),
              flush=True)
        clock.lap("facade")

    # 11. the exact MILP path; its JSON line goes out before the last two
    if "exact" in phases:
        exact = check_exact(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "exact", "card": CARD, **exact}),
              flush=True)
        clock.lap("exact")

    # 12. the sampling planners; their JSON line goes out before the last two
    if "planners" in phases:
        plan_out = check_planners(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "planners", "card": CARD, **plan_out}),
              flush=True)
        clock.lap("planners")

    # 13. the multi-vehicle fleet; its JSON line goes out before the last two
    if "fleet" in phases:
        fleet_out = check_fleet(torch, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "fleet", "card": CARD, **fleet_out}),
              flush=True)
        clock.lap("fleet")

    # 14. the parallel layer; its JSON line goes out before the last two
    if "parallel" in phases:
        par = check_parallel(torch, bt_cuda, btridiag, cyclic_reduction)
        print(json.dumps({"phase": "parallel", "card": CARD, **par}),
              flush=True)
        clock.lap("parallel")

    # 15. the solver's variants; its JSON line goes out before the last two
    if "variants" in phases:
        var = check_variants(torch, bench_harness, bt_cuda, cyclic_reduction)
        print(json.dumps({"phase": "variants", "card": CARD, **var}),
              flush=True)
        clock.lap("variants")

    if tuple(phases) != PHASES:
        return
    print(CARD, flush=True)
    top = times[(51, 5, MAIN_B)]

    def shape_key(shape):
        return "K%d_w%d_B%d" % shape

    print(json.dumps({"kernels": [{
        "name": "bt_solve",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/bt_solve.cu",
        "replaces": "etol_tpu/ops/pallas_bt.py:51",
        "launches": launches,
        "launches_by_batch": {
            str(key[3]): n for key, n in sorted(
                launches_by.items(), key=lambda kv: -kv[0][3])},
        "launches_by_path": {
            "main": launches, "mpc": mpc["kernel"]["launches"],
            "mpc_cr": mpc["cr"]["launches"],
            "bench": bench_launches,
            **{name: run["launches"] for name, run in ladder.items()},
            "facade_solve": facade["solve"]["launches"],
            "facade_mpc": facade["mpc"]["kernel"]["launches"],
            "facade_mpc_cr": facade["mpc"]["cr"]["launches"],
            "facade_multistart_ocp": facade["multistart_ocp"]["launches"],
            "facade_multistart_mip": facade["multistart_mip"]["launches"],
            "facade_fleet_cold": facade["fleet"]["cold"]["launches"],
            "facade_fleet_warm": facade["fleet"]["warm"]["launches"],
            "exact_mip": exact["mip_kernel"]["launches"],
            "exact_mip_cr": exact["mip_cr"]["launches"],
            "exact_composed": exact["composed"]["launches"],
            **{f"planner_seeded_{name}": run["launches"]
               for name, run in plan_out["seeded"].items()},
            "fleet_v3": fleet_out["v3_kernel"]["launches"],
            "fleet_v3_cr": fleet_out["v3_cr"]["launches"],
            "fleet_v2": fleet_out["v2"]["launches"],
            "fleet_batch": fleet_out["batch"]["launches"],
            "parallel_spike": par["spike_launches"],
            "parallel_dryrun": par["dryrun"]["launches"],
            "long_horizon": par["long_horizon"]["unsharded"]["launches"],
            "long_horizon_sharded":
                par["long_horizon"]["sharded"]["launches"],
            "cli_fleet_batch": par["fleet_batch"]["launches"],
            **{f"distributed_rank{r['rank']}": r["launches"]
               for r in par["distributed"]["ranks"]},
            **{f"variants_{name}": run["launches"]
               for name, run in var["uas"].items()},
            **{f"variants_ocp_{name}": run["launches"]
               for name, run in var["ocp"].items()},
            "variants_newton_step": var["newton_step"]["launches"]},
        "launches_by_variant": {
            "main": variant_counts(launches_by),
            "long_horizon": variant_counts(
                par["long_horizon"]["unsharded"]["launches_by"]),
            "long_horizon_sharded": variant_counts(
                par["long_horizon"]["sharded"]["launches_by"])},
        "max_abs_err": max_abs_err,
        "ms": top["smem"],
        "ms_stream": top["stream"],
        "plain_ms": top["plain"],
        "bound_ms": top["bound"],
        "bound_by": top["bound_by"],
        "library_ms": top["library"],
        "by_shape": {
            shape_key(shape): {
                "planned": t["variant"], "ms": t["smem"],
                "ms_stream": t["stream"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["bound_by"],
                "library_ms": t["library"]}
            for shape, t in times.items()},
        "ladder": ladder,
        "b1_routes_ms": {str(K): row for K, row in b1.items()},
        "mpc": {route: {"launches": run["launches"],
                        "cr_solves": run["cr_solves"],
                        "p50_ms": run["p50_ms"],
                        "pipelined_ms": run["pipelined_ms"],
                        "solved": run["statuses"].count(1)}
                for route, run in mpc.items()},
    }, {
        "name": "graph_loop",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/graph_loop.cu",
        # no TPU kernel: the device half of the solver loop's
        # lax.while_loop, whose cond XLA runs on the device
        "replaces": "etol_tpu/solve/al_sqp.py:1069",
        "launches": main_loop["cond_launches"],
        "trips": main_loop["loop_trips"],
        "max_abs_err": loop["max_abs_err"],
        "ms": loop["overhead"]["ms"],
        "plain_ms": loop["overhead"]["plain_ms"],
        "bound_ms": loop["overhead"]["bound_ms"],
        "bound_by": loop["overhead"]["bound_by"],
        "library_ms": None,
        "loop": {kind: {name: {k: side[k] for k in (
            "ms_a_trip", "trips", "launches", "idle_trips",
            "graph_launches", "wall_s") if k in side}
            for name, side in loop[kind].items()}
            for kind in ("phase1", "staged", "mpc")},
    }, {
        "name": "hs_coupling",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/hs_coupling.cu",
        # no TPU kernel: the JAX package leaves the step coupling of its
        # block assembly to XLA
        "replaces": None,
        "launches": sum(main_hs.values()),
        "launches_by_batch": {str(k[2]): n for k, n in sorted(
            main_hs.items(), key=lambda kv: -kv[0][2])},
        "max_rel_err": hs_err,
        "ms": hs_times[(51, 5, MAIN_B)]["kernel"],
        "plain_ms": hs_times[(51, 5, MAIN_B)]["plain"],
        "bound_ms": hs_times[(51, 5, MAIN_B)]["bound"],
        "bound_by": hs_times[(51, 5, MAIN_B)]["bound_by"],
        "library_ms": None,
        "by_shape": {shape_key(shape): t for shape, t in hs_times.items()},
        "trip_ops": hs_ops,
    }, {
        "name": "ls_candidates",
        "route": "cuda",
        "source": "etol_tpu_torch/csrc/ls_candidates.cu",
        # no TPU kernel: the JAX package leaves the line search's candidate
        # pass to XLA
        "replaces": None,
        "launches": LS.TALLY.count,
        "launches_by_path": {
            **{f"facade_{path}": n
               for path, n in facade["ls_launches"].items()},
            "pm3d": ladder["pm3d"]["ls_launches"]},
        "max_rel_err": ls_err,
        "ms": ls_times[(33, 4, 24, FACADE_B)]["kernel"],
        "route_ms": ls_times[(33, 4, 24, FACADE_B)]["route"],
        "plain_ms": ls_times[(33, 4, 24, FACADE_B)]["plain"],
        "bound_ms": ls_times[(33, 4, 24, FACADE_B)]["bound"],
        "bound_by": ls_times[(33, 4, 24, FACADE_B)]["bound_by"],
        "library_ms": None,
        "by_shape": {"K%d_w%d_n%d_B%d" % shape: t
                     for shape, t in ls_times.items()},
        "trip_ops": ls_ops,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def variant_counts(by):
    """Launches by kernel variant, from a count by (variant, K, w, B), or
    by its "variant_K.._w.._B.." names."""
    out = {}
    for key, n in by.items():
        variant = key[0] if isinstance(key, tuple) else key.split("_")[0]
        out[variant] = out.get(variant, 0) + n
    return out


def check_main(torch, out, launches, launches_by, loop):
    """Phase 4's findings and checks; ``loop`` holds the main path's
    program calls on graphs (the seeds and the two staged solves), its
    trips, and the device loops' condition-kernel launches and trips."""
    cold, warm = out["cold"], out["warm"]
    res = warm["result"]
    say("main", f"uas_2d N={MAIN_NSTEPS} B={MAIN_B}: cold solved "
                f"{cold['solved_fraction']:.4f}, warm solved "
                f"{warm['solved_fraction']:.4f}")
    say("main", f"max violation cold {cold['viol_eq_max']:.3e} / "
                f"{cold['viol_in_max']:.3e}, warm {warm['viol_eq_max']:.3e}"
                f" / {warm['viol_in_max']:.3e}")
    say("main", f"stage trips {cold['stage_trips']}")
    say("main", f"audit: deepest node containment "
                f"{cold['audit_node_depth_max']:.3e}, deepest mid-segment "
                f"dip {cold['audit_midseg_depth_max']:.4f}")
    say("main", f"wall: seeds {cold['seed_s']:.3f} s on the graph (its "
                f"key's first use: an eager run, then the capture; "
                f"the graph phase times a replay), cold solve "
                f"{cold['cold_s']:.2f} s, warm re-solve {warm['warm_s']:.2f}"
                f" s")
    if loop["programs"] != 3:
        raise AssertionError(f"the main path made {loop['programs']} "
                             "program calls on graphs: its seeds, its cold "
                             "staged solve and its warm one should be "
                             "three")
    say("main", f"trips {loop['trips']} ({loop['loop_trips']} in device "
                f"loops, the rest each loop's first, eager trip), "
                f"{loop['cond_launches']} condition-kernel launches")
    if launches != loop["trips"]:
        raise AssertionError(f"the main path made {launches} kernel "
                             f"launches in {loop['trips']} trips: one a "
                             "trip, no idle trip")
    say("main", f"bt_solve kernel launches during the main path: {launches}"
                f"; by (variant, K, w, batch): "
                f"{sorted(launches_by.items(), key=lambda kv: -kv[0][3])}")
    n_smem = sum(n for key, n in launches_by.items()
                 if key[:3] == ("smem", 51, 5))
    if launches <= 0 or n_smem != launches:
        raise AssertionError(
            f"the main path made {launches} kernel launches, {n_smem} of "
            "them of the shared-memory kernel at K=51, w=5: all of them "
            "should be")
    assert_checked("main", launches_by)
    if out["data"].x0.device.type != "cuda":
        raise AssertionError("the main path's default device is not the "
                             "card")
    if not cold["solved_fraction"] >= 0.95:
        raise AssertionError(f"cold solved {cold['solved_fraction']} < 0.95")
    if not cold["audit_node_depth_max"] <= 1e-3:
        raise AssertionError("a solved lane has a node inside an obstacle")
    nz = out["nlp"].dims.nz
    if tuple(res.z.shape) != (MAIN_B, nz) or not bool(
            torch.isfinite(res.z).all()):
        raise AssertionError(f"warm z has shape {tuple(res.z.shape)} or "
                             "non-finite values")


if __name__ == "__main__":
    if sys.argv[1:] == ["loop"] or (len(sys.argv) == 3
                                    and sys.argv[1] == "--phases"):
        picked = sys.argv[-1].split(",")
        if not set(picked) <= set(PHASES):
            raise SystemExit(f"chip_smoke: phases are {', '.join(PHASES)}")
        main(tuple(p for p in PHASES if p in picked))
    elif len(sys.argv) == 1:
        main()
    else:
        raise SystemExit("usage: chip_smoke.py [--phases a,b,... | loop]")
