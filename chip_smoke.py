#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

0. the card's name and power limit; build every kernel from ``csrc/``, one
   nvcc per source, all at once (K1 and K6 once per model and dtype);
   registers and spills of each library, of the s = 2 solver
   instantiations the KS path runs, and of K6 at s = 1, 2 and 4 in both
   dtypes (with its static shared memory).
1. each kernel against its plain PyTorch version on CUDA tensors, f64 and
   f32: first the readings behind the limit on K6's adapted dt (eight
   seeds, and the gap of an err twice too large), then the checks of
   ``triflow_tpu_torch.ops.kernel_checks`` at small and odd shapes (K6 at
   the shapes of ``tests/test_torch_megastep.py``), then at the shapes of
   the main paths below, K7 (the banded matvec) among them on the bands
   and vectors of the refine and solver cases (``matvec_path_checks``),
   K3's staged sweep at block sizes 1..8 (one grid and members, Mc = 2,
   odd and no multiple of the stage rows, the forward results kept and
   streamed: ``kernel_checks.check_all_sweeps``), K5 bit for bit at KS
   2^20's shape, unaligned and with a vector tail, K2's staged walk at
   block sizes 1..4 (``kernel_checks.check_all_factors``) and K4's cluster
   solve with shifts at interface blocks 2..16
   (``kernel_checks.check_all_shifts``), and K2-K4 on the padded paths'
   bands and plans (``padded_path_checks``).
2. the main paths through ``Simulation`` on ``device="cuda"``, f32 and f64,
   each case driven with the launch counts set to 0 just before it and read
   just after: the Theta path (Burgers at the reference's N = 10^6, 10
   steps, and N = 2^20, 4 steps; the README model N = 200 with its
   Dirichlet hook, to t = 50, through K6), then the Rosenbrock path:
   Kuramoto-Sivashinsky at N = 10^6 with ``RODASPR`` at a fixed dt (4
   steps of 0.05) and adaptive (tol 1e-3, 2 output steps of 1.0), at
   N = 2^20 the same with 2 steps and 1 output step, KS at N = 2^13 and
   10^4 (K6) adaptive the same way with no hook, Burgers at N = 10^4
   adaptive through K6, the README model through ``Simulation``'s defaults
   (RODASPR, adaptive, K6 steps) and through example 01's call (Theta with
   step doubling).  Each case's chunk plan is the one named in ``CASES``:
   the power-of-two grids close their ring block-cyclic, the others
   (N = 10^6, 10^4) through the Woodbury correction, whose set-up
   launches K4.pcr_solve once per factor on the multi-launch path and
   runs inside K6 on K6's.  The large cases must launch every entry of
   K1-K5 they need, the small ones K6 alone; the results must be finite
   and agree with the port's CPU f64 run (plain versions) of the same
   case, in f64 with the same number of attempts in every output step.
   Then the paths that run K7 and never K6 (``REFINE_CHECKS``): KS at
   N = 10^6 with ``RODASPR(refine=1)``, 4 fixed steps (exactly 24 K7
   launches, against the same case without refinement on the card),
   the advection-diffusion trajectory of ``tests/test_precision.py``
   (N = 1024, 500 steps of 0.01, a grid K6 admits: refine=1 in float32
   within the reference's 5e-5 of the float64 run without it), KS at
   N = 10^4 adaptive with ``refine=1`` (the CPU run's attempts), and
   Burgers at N = 10^6 through ``Theta(solver=...)`` with the port's own
   chunked solve as the solver (10 K7 launches, against the plain Theta).
3. timing with CUDA events at N = 2^20 and 10^6: ms per Theta step
   (Burgers) and per fixed RODASPR step (KS) with cell updates per second,
   ms per adaptive attempt, each kernel entry against its plain version at
   the KS path's shapes (K4.pcr_solve, the Woodbury set-up, and the
   Woodbury correction of K4.pcr_solve_shift at 10^6), K5 against one
   ``torch.mm`` over pre-stacked operands, K7 against one ``torch.sparse``
   CSR matvec of the same matrix (at N = 10^6), and a ``torch.profiler``
   breakdown of the Theta and RODASPR steps by kernel, and at N = 10^6 of
   the RODASPR step with ``refine=1`` beside its time; then the small
   grids: the KS N = 10^4 and Burgers N = 10^4 (K6, Woodbury) adaptive
   output steps, the README step at N = 200 per
   synchronised step (K6 and the multi-launch path) and K6's step under
   ``torch.profiler``, ``device_fixed_scan`` at 100 steps, the KS N = 2^13
   adaptive output step, K6's layout sweeps (every chunk count on every
   cluster size that holds it, ``CLUSTER_SWEEPS``) with the fit of
   ``megastep.cluster_cost_us`` behind its plans and each grid's pick
   against the fastest layout, and the crossover sweeps N = 2^10 .. 2^16
   of fixed RODASPR and Theta steps, K6 against the multi-launch path,
   for Burgers (s = 1), KS (s = 2) and the two-variable model (s = 4),
   behind K6's gate per block size.

K6's cluster body (each member's step on a thread-block cluster of K =
1..16 CTAs, its working set in shared memory) runs in each phase
too: phase 0 prints each K6 instantiation's registers, spills and static
shared memory (against ``megastep.STATIC_SMEM``); phase 1 holds every
entry against its plain version at forced K = 1, 2, 4, 8, 16
(``kernel_checks.check_clusters``: C not divisible by K, block-cyclic
and Woodbury rings, edge grids, s = 1, 2, 4, B = 4, the mixed entry; the
step and mixed entries bit for bit across sizes); phase 2 counts the
cases the gates moved (KS N = 10^4 adaptive: K6); ``phase3_redesign``
times rows 19-22 at the plans of before and after the refit
(``redesign_k6``: host ms, device µs, the barriers and rows a step
takes).

The ensemble path (``parallel.Ensemble``) runs in each phase:
phase 1 holds the member axis of K1-K4 and K6 (B = 4, block-cyclic and
Woodbury rings, f32 and f64), K1.F_terms and K6.adaptive_scan (a shared
dt and per member) against their plain versions, and K6's entries at the
sweep's shapes; phase 2 runs the reference's config 5 (B = 1024 KS members
at N = 10^5, 3 fixed RODASPR steps, K1-K5 with a member axis) and its
sweep (B = 64 KS members at N = 200: ``steps(100)`` fixed, ``steps(4,
0.1)`` adaptive with a shared dt and per member, each one K6 launch, and
one shared adaptive ``step``) and B = 4 KS members at N = 10^5 with
``refine=1`` (the host route, K7 with a member axis), each with its
launch counts, members 0 and
B - 1 against the port's single-grid run on the card, and the sweep
against the port's CPU f64 run; phase 3 times them (aggregate
cell-updates/s, ms per ``steps(100)``), breaks a config-5 step down by
kernel, holds every kernel of that step against its plain version at
config 5's shapes, times K1.F_terms against the combination and the
biased F, sweeps the chunk count of config 5 (behind
``chunked.batch_plan_cost_us``) and of two more shapes through K1-K5 (B =
64 at KS N = 2^13, B = 4 at N = 10^5: which plans the model picks there),
and sweeps K6 against K1-K5 at B = 64 (KS, N = 2^8 .. 2^13).

The df64 mode (``Model(double="df64")``: native float64, float32 step
sizes) runs in each phase too: phase 0 builds K8 (``mixed_residual.cu``)
and each float64 model's library of K6's mixed entry; phase 1 holds K8 and
K6's mixed entry against their plain versions at small shapes
(``kernel_checks.check_all_mixed``) and on the KS N = 10^6 df64 residual,
the KS N = 2^13 and N = 10^4 states and Burgers N = 10^4
(``mixed_path_checks``);
phase 2 runs ``DF64_CASES`` (bench.py's ``bench_df64`` and
``bench_df64_smalln`` grids: KS N = 10^6 with ``df64_mixed_solve=1``,
exactly 24 K8 launches in 4 steps, and with the full solver; KS N = 10^4
for 200 steps on the route the mixed gate picks; KS N = 2^13 through
``device_fixed_scan(200)``, one launch of the mixed entry; Burgers N =
10^4 through a mixed Theta; the README model with its hook; an adaptive
KS N = 10^4 mixed run), each with its exact launches and against the
card's ``double=True`` run of the same case or the port's CPU df64 run;
phase 3 (``phase3_df64``) times the KS N = 10^6 step in double=True, df64
full and df64 mixed (alternated, with profiles), K8 against its bound and
a ``torch.sparse`` CSR matvec with the combination and the cast (each call
on one of three copies of the operands in turn, so that L2 holds none),
K6's
mixed entry at KS N = 2^13 beside K6.step, the Burgers N = 10^6
``Theta(solver=...)`` step beside the plain Theta, and the mixed entry
against the multi-launch mixed path at N = 2^10 .. 2^15 and 10^4 for s =
1, 2, 4 (behind ``megastep.MIXED_MAX_N``).

The opt-in two-pass theta step (kernel K9, ``csrc/megatheta.cu``, the
reference's ``TRIFLOW_MEGATHETA=1`` route of
``Theta.device_fixed_step_folded``) runs in each phase too: phase 0 builds
K9 for Burgers (s = 1) and KS (s = 2) in both dtypes and prints its
registers and spills; phase 1 holds its two entries and its step against
their plain versions at small and odd shapes (``kernel_checks``) and at
Burgers N = 10^6 (Woodbury) and KS N = 2^20 (block-cyclic), on a noisy
state and on the increment each step makes; phase 2
(``phase2_megatheta``) steps Burgers N = 10^6 (bench.py's config 2: x =
0.5 i, cos(8 pi i / N), nu = 0.5, dt = 0.05) 10 times, the same grid with
noise 3 times and KS N = 2^20 4 times through that entry with the
variable set, with exact launches (K9's two entries, K4's factor and solve
with shifts and, on the Woodbury plan, its set-up once per step; nothing
else), against the same entry without the variable on the card (K1-K4)
and the port's CPU f64 run, on the state and on the increment from the
first state; phase 3
(``phase3_megatheta``) times the Burgers 10^6 step through K9 against the
K1-K4 route (alternated, with profiles), K9's entries against their plain
versions and bound, and the chunk-count sweep behind
``megatheta.plan_for``.

Block sizes S = 5..8 (K2-K4's wide libraries, ``csrc/*.cu`` built with
TF_WIDE) run in each phase too: phase 0 builds them and the falling film's
K1 and prints every wide instantiation's registers and spills; phase 1
(``phase1_film``) holds K2-K4 at S = 5..8 against their plain versions in
both dtypes (``kernel_checks.run_wide``: random bands on block-cyclic,
Woodbury and acyclic plans, C = 1 to 8192 chunks, and B = 4 members at S =
6 and 8), on the film's own path at N = 10^6 and 2^20, and in float32 on
the bands the df64 mixed solve rounds; phase 2 (``phase2_film``) runs the
three-field falling film (S = 6, ``FILM``) through ``Simulation``'s
defaults at N = 10^6 (tol 1e-4, 3 output steps of 0.5, against the CPU run
at N = 10^4 tiled) and through fixed RODASPR and Theta steps at N = 10^6
and 2^20, with exact launches of K1, K5 and the wide entries; phase 3
(``phase3_film``) times its steps, profiles them, holds each wide entry
against its plain version and bound, and sweeps the chunk count at N =
10^6 (Woodbury and padded plans) and 2^20 (block-cyclic) behind
``chunked.WIDE_ROW_US`` / ``WIDE_LEVEL_US`` / ``WIDE_WOOD_US``.

Padded grids (plans that grow the system with identity rows) run in
phases 2 and 3: ``phase2_padded`` steps KS at N = 999983 (periodic, N no
multiple of g = 2: the ring closed at the system level, 2 nvar h column
solves per factor), KS on an edge grid of 2 x 1000003 nodes (a prime
supernode count, which planned one chunk before), the README model at N =
199 (K6 keeps its serial plan) and at N = 4099 (K6 declines it, K1-K5 pad
it), each with exact launches and against the port's CPU f64 run
(``padded_cpu_runs``, in a process of its own); ``phase3_padded`` times
the 999983 step beside 10^6 and the edge step beside 2 x 10^6 (with a
profile of the ring's step), the README steps synchronised, and sweeps
the chunk count of KS at N = 10^6 and 10^4 behind ``chunked.ROW_US`` /
``LEVEL_US`` / ``SLAB_US`` (``narrow_sweeps``).

K3's tiled correction and K4's narrow factor across the card run in
each phase too: phase 0 prints the registers and spills of every
narrow instantiation of ``spike_correct_kernel`` and K4's factors; phase 1
holds the correction at s = 1..8 (``kernel_checks.CORRECT_SHAPES``: one
chunk to part-full chunk groups, members, B = 1024) and at config 5's
shape, and the narrow factor by the route its shape picks
(``kernel_checks.GRID_FACTOR_CASES``: block-cyclic, Woodbury, acyclic,
the ring's 1534 chunks, members) against their plain versions; phase 2
counts K4's one block per member (plans of up to
``pcr.FACTOR_MEMBERS_MAX_C`` chunks: config 5) apart
(``K4.pcr_factor_members``).

K4's Woodbury set-up and R-column solve across the card (a cluster per
member and column, the capacitance by one block per member) and K1's
tiled F run in each phase too: phase 0 prints the registers of the
column clusters, the capacitance kernel and K1's F and F_terms of every
model; phase 1 holds the set-up and the R-column solve at s = 1..8
(``kernel_checks.SETUP_CASES``: C = 2 to the cells' 2500, members up to
1024) against their plain versions and bit for bit against the one-block
body, and K1's F and F_terms at odd N (``kernel_checks.TILED_F_SHAPES``:
fewer nodes than the halo spans to 4099, B = 1, 4 and 1024) against
their plain versions, F bit for bit against the per-node body; phase 2
counts the R-column solve's one block per member (config 5:
``pcr.cols_route``) apart (``K4.pcr_solve_members``); ``phase3_redesign``
times the set-up by its route beside the other narrow one, K3's
correction and K4's factor by route at the cells' plans before and after
the refit (``REDESIGN_SHAPES``, ``REFIT_SHAPES``: host ms, device µs on
inputs cold in L2, the bytes bound), and K1's tiled F beside the F entry
of before (``STENCIL_SHAPES``).

K1's J entry on warp tiles (a warp per 32 nodes of one member, the
span's halo exchanged by shuffles) and K7's tiled body (v's span of a tile
in shared memory, the bands streamed by 16-byte loads, (W, nvar) fixed at
compile time for W = 3, 5, 7 and nvar = 1, 2, 3 and at run time for the
rest) run in each phase too: phase 0 prints the registers and spills of
every model's J and of every K7 instantiation; phase 1 holds J at
``kernel_checks.TILED_F_SHAPES`` and past 65535 members on every model of
``STENCIL_MODELS``, periodic and edge (``check_all_tiled_J``), and K7 at
``kernel_checks.MATVEC_SHAPES`` (one grid and B = 4, a number and a
per-member scale, inputs off a 16-byte boundary) and on the refine and
solver paths' bands, each against its plain version and bit for bit
against the body of before its tiles (``stencil.eval_J_nodes``,
``matvec.banded_matvec_nodes``); ``phase3_redesign`` times each beside
that body (``redesign_J`` at ``J_SHAPES``: STENCIL_SHAPES, config 5 and
the film; ``redesign_matvec`` at ``K7_SHAPES``, with K7's scalar loads
on inputs off 16 bytes): host ms, device µs on inputs cold in L2 by the
profiler and by a CUDA graph of the same calls (``graph_us``), the bytes
bound.

The chunked run (``Simulation.run(device_chunk=n)`` through the schemes'
``device_steps``) has a phase 2 and a phase 3 of its own, each dtype:
``phase2_chunked`` holds KS N = 10^6 fixed RODASPR and Burgers N = 10^6
Theta (``CHUNK_CASES``, 100 output steps, ``device_chunk=50``: the graph
route) against their stepwise runs, every emission's i, t and state bit
for bit and the launch counts 100 times one step's; KS N = 2^13 adaptive
at tol 1e-3 (``ADAPTIVE_CHUNK``, one chunk of 8 output steps: K6's
adaptive scan with snapshots, ``K6.adaptive_snapshots``) with the same
attempts per output step and every emission bit for bit, the snapshot
entry's final state bit for bit the entry's without snapshots, and a
failure's valid prefix (from the stepwise state after the first output
step, ``max_iter`` below the first later step that takes more attempts
than every one before it; ``device_chunk=2``) against the stepwise run's;
phase 1 holds the snapshot outputs of K6's step and adaptive scan
against their plain versions (``kernel_checks.check_snapshots``).
``phase3_chunked`` prints ms per output step stepwise against chunked
(host clock, synchronised, in turns), each window's idle share under
``torch.profiler``, and K6.adaptive_snapshots against its plain version
and its bound (the snapshots' bytes counted), beside the card's name and
power limit.

df64 ensembles and the Kahan carry (``compensated=True``) run in each
phase too: phase 0 prints every K6 kernel's registers, stack, spills and
static shared memory (the carry's code is compiled in; PERF.md keeps what
it cost against the kernels without it); phase 1 (``carry_checks``) holds
K6's step, adaptive and adaptive-scan entries, each from a seeded carry,
bit for bit against bare step-entry launches folded by ``kahan_update``
and the adaptive controller replayed on them (u, carry, dt_i, attempts),
and against their plain versions (KS 2^13 one grid and B = 4,
``kernel_checks.COMPENSATED_CASES``, f32 and f64, to
``kernel_checks.TOL``'s solver tolerance of max|u|), and
(``mixed_path_checks``) the member-axis mixed solve of
``ops.mixed.MixedFactorization`` at B = 4 with per-member coef against
its plain version; ``phase2_precision`` runs bench.py's df64 ensemble
(B = 64 KS members at N = 10^5, ``df64_mixed_solve=1``, ``steps(10,
0.05)``: the host route, exactly 60 K8 launches and the counts of the
mixed solve) with members 0, 31 and 63 within 1e-12 of their single-grid
df64 runs on the card and the same clock, a ``per_member_dt`` df64
ensemble (B = 4, KS 10^4, tol 1e-3) against its members' single-grid runs
(equal attempts), compensated RODASPR (tol 1e-3, 2 output steps of 1.0)
through ``device_steps`` at KS 2^13 (the eager route, one K6.compensated
launch of the adaptive entry per output step, f32 and f64) and at KS 10^6
(the host controller, f32, no K6) against the CPU f64 runs, beside the
same run without the flag, a compensated ensemble (B = 4 x KS 2^13,
shared and per-member dt, f32 and f64) on K6's adaptive scan bit for bit
against the host route a hook sends it to, and fixed compensated RODASPR
at KS 10^6 on ``device_steps``' graph route (the carry captured in the
graph) bit for bit against the eager route, with and without the flag;
``phase3_precision`` times the df64 ensemble as aggregate cell-updates/s
(the best of three ``steps(10)`` calls) with a profile of its step,
K6.compensated (the KS 2^13 first output step with the carry) against the
same step without it, its plain version and its bound, and the README
step entry's device µs with and without the carry.

The explicit RK family runs in each phase too: phase 0 builds the wave
model's K1 (example 05: ``["c**2 * dxxu", "v"]``, ``["v", "u"]``);
``phase1_erk`` holds K5 with RK4's, BS32's and DOPRI5's rows (dt columns,
dts not exact in float32, a member axis and one dt per member: the
members body, ``K5.combine_members``) bit for bit against its plain
version; ``phase2_erk`` runs the wave model at N = 10^6 (DOPRI5's FSAL
and generic loops, BS32, RK4 stepwise and through ``device_steps``' graph
route) with exact K1.F / K5 launches per attempt against the port's CPU
f64 run over the first output step (``erk_cpu_runs``; output steps of
``ERK_DT``, under the stability limit), B = 64 wave members at N = 10^4
with per-member dt against their single-grid runs bit for bit, scipy_ode
(vode, vode/BDF with the Jacobian) on the README model against the CPU,
and a Simulation with a container and a checkpoint; ``phase3_erk`` times
a DOPRI5 attempt at 10^6 against its bytes bound, K1.F and K5 under the
profiler, K5's dt entry and members body against plain, bound and one
PyTorch call, RK4 stepwise against the graph route, and one
stability-limited output step.

Spatial sharding runs its own phases, on a ``parallel.Mesh`` of one card:
``phase1_spatial`` holds K1's shard entries (``K1.F_shards``,
``K1.F_terms_shards``, ``K1.J_shards``) and every kernel of the
distributed factorization on the shard axis (K2-K4 of the shards' local
systems, the wrap off; K3 on a spike column; K4 over the shards,
block-cyclic and Woodbury; K3's correction with the shards as chunks)
against their plain versions at small shapes and at the path's own (KS
2^20 over 8 shards, the ring of 999996 over 6, the README grid at 10^6
over 8 in edge mode, 16 Burgers members of 2^16 over 4);
``phase2_spatial`` drives ``Simulation(mesh=)`` (KS 2^20 fixed and
adaptive RODASPR and ``refine=1``, the Woodbury ring, the README grid with its Dirichlet
hook under Theta, DOPRI5 at 2^20), its ``run(device_chunk=2)`` on the
graph route, the df64 mode's mixed solve and ``Ensemble(space_axis=)``
(RODASPR per member, ROS2), each with its launches as the plan predicts
(``shard_launches``) and against the card's single grid and the port's
CPU f64 sharded run (``spatial_cpu_runs``); ``phase3_spatial`` times the
sharded KS 2^20 step against the single grid, the interface system's and
the spike columns' shares of its device µs, the dp x sp output step, and
K1's shard entries against plain and bound.

The last three lines are the kernels' JSON record (launches in phase 2,
largest error against the plain version, f32 ms of kernel, plain version,
bound and library call, with f64 beside them; K4.pcr_solve and K7 at KS
N = 10^6, K9 at Burgers N = 10^6, K2-K4's wide entries at the film's N =
10^6, the others at KS N = 2^20; K8 and K6's
mixed entry have one type pair, their main keys the float64 column and
null float32 keys), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import importlib.util
import json
import itertools
import multiprocessing
import os
import re
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import sympy as sp
import torch

from triflow_tpu_torch import Model, Simulation, schemes
from triflow_tpu_torch.core.rosenbrock import adaptive_controller, member_controller
from triflow_tpu_torch.ops import (_build, _launch, chunked, combine, kernel_checks,
                                   matvec, megastep, megatheta, mixed, pcr, stencil,
                                   thomas)
from triflow_tpu_torch.parallel import Ensemble, Mesh, spatial
from triflow_tpu_torch.utils.convert import ensemble_from_numpy, state_from_numpy

N_BIG = 1 << 20
N_REF = 10 ** 6  # the reference benchmark's headline grids (bench.py)
N_REF_SMALL = 10 ** 4
BURGERS = ("-U * dxU + nu * dxxU", "U", ["nu"])
README = ("k * dxxU - c * dxU", "U", ["k", "c"])
KS = ("-dxxU - dxxxxU - U * dxU", "U", [])
TWO_VAR = kernel_checks.MEGA_MODELS["two_var"]
N_SMALL = 1 << 13
DTYPES = {"float64": torch.float64, "float32": torch.float32}

#: the card's rates (NVIDIA H100 SXM data sheet, at the 700 W limit):
#: device memory, and the non-tensor-core float32 and float64 peaks
BYTES_PER_S = 3.35e12
OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

#: kernel entry -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "K1.F": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
             "triflow_tpu/ops/folded.py:469 eval_F_folded"),
    "K1.F_terms": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
                   "triflow_tpu/ops/folded.py:469 eval_F_folded (u_terms mode)"),
    "K1.J": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
             "triflow_tpu/ops/folded.py:667 eval_J_folded"),
    "K2.spike_factor": ("cuda", "triflow_tpu_torch/csrc/spike_factor.cu",
                        "triflow_tpu/ops/folded.py:902 factor_sweeps_folded + "
                        "triflow_tpu/ops/pallas_thomas.py:322 _bwd_factor_call_cols"),
    "K3.thomas_sweep": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                        "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat"),
    "K3.spike_correct": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                         "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat "
                         "(spike correction of triflow_tpu/ops/folded.py:1478)"),
    "K4.pcr_factor": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                      "triflow_tpu/ops/pallas_pcr.py:246 pcr_factor_fused_sub"),
    # the one block per member, kept up to pcr.FACTOR_MEMBERS_MAX_C chunks
    # (pcr.factor_route: config 5, the refine ensemble, small plans)
    "K4.pcr_factor_members": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                              "triflow_tpu/ops/pallas_pcr.py:246 pcr_factor_fused_sub "
                              "(vmapped over members)"),
    "K4.pcr_solve_shift": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                           "triflow_tpu/ops/pallas_pcr.py:298 interface_shift_solve"),
    "K4.pcr_solve": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                     "triflow_tpu/ops/pallas_pcr.py:408 pcr_solve_fused_sub"),
    # the one block per member, kept where members fill the card on plans
    # of few chunks (pcr.cols_route: config 5)
    "K4.pcr_solve_members": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                             "triflow_tpu/ops/pallas_pcr.py:408 pcr_solve_fused_sub "
                             "(vmapped over members)"),
    "K5.combine": ("cuda", "triflow_tpu_torch/csrc/combine.cu",
                   "triflow_tpu/ops/folded.py:543 combine_folded"),
    # the explicit RK family's stage sums of ensemble members that step by
    # their own dt (combine_members_kernel)
    "K5.combine_members": ("cuda", "triflow_tpu_torch/csrc/combine.cu",
                           "triflow_tpu/ops/folded.py:543 combine_folded (members with "
                           "their own dt)"),
    "K6.step": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                "triflow_tpu/ops/megastep.py:1491 _launch"),
    "K6.adaptive": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                    "triflow_tpu/ops/megastep.py:1242 row_adaptive_step_folded"),
    "K6.adaptive_scan": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                         "triflow_tpu/ops/megastep.py:1313 row_adaptive_scan_folded"),
    # the adaptive scan of one grid writing each output step's snapshot
    # (Simulation.run(device_chunk=n), device_steps)
    "K6.adaptive_snapshots": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                              "triflow_tpu/ops/megastep.py:1313 row_adaptive_scan_folded "
                              "(per-output-step snapshots of triflow_tpu/core/schemes.py:268 "
                              "device_steps)"),
    "K7.matvec": ("cuda", "triflow_tpu_torch/csrc/matvec.cu",
                  "triflow_tpu/ops/pallas_stencil.py:381 banded_matvec_pallas + "
                  "triflow_tpu/ops/folded.py:700 matvec_folded"),
    "K8.residual": ("cuda", "triflow_tpu_torch/csrc/mixed_residual.cu",
                    "triflow_tpu/ops/folded.py:777 matvec_df_folded + "
                    "triflow_tpu/ops/banded_df.py:720 banded_matvec_df"),
    "K6.step_mixed": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                      "triflow_tpu/ops/megastep.py:821 row_step_df_folded + "
                      ":907 theta_step_df_folded"),
    # the step and adaptive entries with the Kahan carry (compensated=True)
    "K6.compensated": ("cuda", "triflow_tpu_torch/csrc/megastep.cu",
                       "triflow_tpu/ops/megastep.py:1242 row_adaptive_step_folded + "
                       ":1313 row_adaptive_scan_folded + :1491 _launch (compensated)"),
    "K9.interface": ("cuda", "triflow_tpu_torch/csrc/megatheta.cu",
                     "triflow_tpu/ops/megatheta.py:284 theta_step_tiled (kernel_a)"),
    "K9.correct": ("cuda", "triflow_tpu_torch/csrc/megatheta.cu",
                   "triflow_tpu/ops/megatheta.py:284 theta_step_tiled (kernel_b)"),
    # K2-K4 at block sizes s = 5..8: the same sources built with TF_WIDE
    "K2.spike_factor_wide": ("cuda", "triflow_tpu_torch/csrc/spike_factor.cu",
                             "triflow_tpu/ops/pallas_thomas.py:368 chunked_factor_sweeps + "
                             ":451 fused_factor_sweeps"),
    "K3.thomas_sweep_wide": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                             "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat"),
    "K3.spike_correct_wide": ("cuda", "triflow_tpu_torch/csrc/spike_solve.cu",
                              "triflow_tpu/ops/pallas_thomas.py:729 chunked_solve_flat "
                              "(spike correction of triflow_tpu/ops/folded.py:1478)"),
    "K4.pcr_factor_wide": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                           "triflow_tpu/ops/pallas_pcr.py:246 pcr_factor_fused_sub"),
    "K4.pcr_solve_shift_wide": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                                "triflow_tpu/ops/pallas_pcr.py:298 interface_shift_solve"),
    "K4.pcr_solve_wide": ("cuda", "triflow_tpu_torch/csrc/pcr.cu",
                          "triflow_tpu/ops/pallas_pcr.py:408 pcr_solve_fused_sub"),
    # K1 on the haloed shards of a grid on a mesh (the reference's
    # SpatialModel._local_F / _local_J under shard_map, whose stencils are
    # these kernels' work): each shard's halo from its ring neighbours, its
    # own dx
    "K1.F_shards": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
                    "triflow_tpu/ops/folded.py:469 eval_F_folded (on the haloed shards of "
                    "triflow_tpu/parallel/spatial.py:422 _local_F)"),
    "K1.F_terms_shards": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
                          "triflow_tpu/ops/folded.py:469 eval_F_folded (u_terms mode, on the "
                          "haloed shards of triflow_tpu/parallel/spatial.py:422 _local_F)"),
    "K1.J_shards": ("cuda", "triflow_tpu_torch/csrc/stencil.cu",
                    "triflow_tpu/ops/folded.py:667 eval_J_folded (on the haloed shards of "
                    "triflow_tpu/parallel/spatial.py:430 _local_J)"),
}
#: the wide instantiations of K2-K4 (block sizes 5..8), which count apart
WIDE = [k for k in KERNELS if k.endswith("_wide")]
#: K1's entries of a grid cut into shards (parallel/spatial.py)
SHARDS = [k for k in KERNELS if k.endswith("_shards")]
#: the kernel entries of the df64 mode's mixed solve: float64 operands only
DF64_ONLY = ("K8.residual", "K6.step_mixed")
#: the kernel entries of the multi-launch path on a block-cyclic plan; a
#: Woodbury plan adds K4.pcr_solve, ``refine=`` and ``Theta(solver=)`` add
#: K7.matvec
MULTI_LAUNCH = [k for k in KERNELS if not k.startswith(("K6", "K9")) and k not in WIDE
                and k not in SHARDS
                and k not in ("K4.pcr_solve", "K1.F_terms", "K7.matvec", "K8.residual",
                              "K4.pcr_factor_members", "K4.pcr_solve_members",
                              "K5.combine_members")]
THETA_KERNELS = [k for k in MULTI_LAUNCH if k != "K5.combine"]
WOOD = ["K4.pcr_solve"]
K7 = ["K7.matvec"]

#: substrings of the device kernels' names in a profiler trace
TRACE_NAMES = {"stencil_F_terms": "K1.F_terms", "stencil_F": "K1.F", "stencil_J": "K1.J",
               "spike_factor_wide": "K2.spike_factor_wide", "spike_factor": "K2.spike_factor",
               "thomas_sweep": "K3.thomas_sweep", "spike_correct": "K3.spike_correct",
               "pcr_factor_kernel": "K4.pcr_factor_members",
               "pcr_factor": "K4.pcr_factor", "pcr_solve_shift": "K4.pcr_solve_shift",
               "pcr_solve_cols_cluster": "K4.pcr_solve", "woodbury_cap": "K4.pcr_solve",
               "pcr_solve_kernel": "K4.pcr_solve_members",
               "combine_members_kernel": "K5.combine_members",
               "combine_kernel": "K5.combine", "combine_vec_kernel": "K5.combine",
               "step_mixed_kernel": "K6.step_mixed",
               "step_kernel": "K6.step", "mixed_residual": "K8.residual",
               "adaptive_kernel": "K6.adaptive", "scan_kernel": "K6.adaptive_scan",
               "matvec_": "K7.matvec",
               "megatheta_interface_kernel": "K9.interface",
               "megatheta_correct_kernel": "K9.correct"}


def log(msg):
    print(msg, flush=True)


def burgers_case(N=N_BIG, dt=0.05, tmax=10 * 0.05):
    i = np.arange(N)
    return ({"x": i * 0.5, "U": np.cos(2 * np.pi * i / N * 4)},
            dict(periodic=True, nu=0.5), dt, tmax, None)


def ks_case(dt, tmax, N=N_BIG):
    """bench.py's KS state: x = 0.5 i, cos(20 pi i / N) + 0.1 randn (seed 0)."""
    i = np.arange(N)
    rng = np.random.RandomState(0)
    return ({"x": 0.5 * i, "U": np.cos(2 * np.pi * 10 * i / N) + 0.1 * rng.randn(N)},
            dict(periodic=True), dt, tmax, None)


def two_var_case(dt, tmax, N):
    """The two-variable model's state of the reference's megastep tests."""
    rng = np.random.RandomState(3)
    i = np.arange(N)
    h, q = (1.2 + 0.1 * np.cos(2 * np.pi * i / N * 5 + k) + 0.01 * rng.randn(N)
            for k in range(2))
    return {"x": i * 0.5, "h": h, "q": q}, dict(periodic=True), dt, tmax, None


def dirichlet(t, fields, pars):
    fields["U"][0] = 1.0
    fields["U"][-1] = 0.0
    return fields, pars


def readme_case():
    x = np.linspace(0, 1, 200)
    return ({"x": x, "U": np.cos(2 * np.pi * x * 5)},
            dict(periodic=False, k=1e-3, c=3e-3), 5.0, 50.0, dirichlet)


def readme_case_at(N):
    """The README model's case on N nodes."""
    fields, pars, dt, tmax, hook = readme_case()
    x = np.linspace(0, 1, N)
    return {"x": x, "U": np.cos(2 * np.pi * x * 5)}, pars, dt, tmax, hook


THETA = dict(scheme=schemes.Theta, theta=1.0, time_stepping=False)
FIXED = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None)
REFINED = dict(FIXED, refine=1)


def advdiff_case():
    """``tests/test_precision.py``'s trajectory: advection-diffusion on a
    periodic N = 1024 grid, 500 steps of 0.01."""
    x = np.linspace(0, 10, 1024, endpoint=False)
    return ({"x": x, "U": np.cos(x * 2 * np.pi / 10) + 2.0},
            dict(periodic=True, k=0.05, c=0.3), 0.01, 500 * 0.01, None)


def chunked_solver(A, B, periodic):
    """``Theta(solver=...)``'s solver: the port's own chunked factor and
    solve of A (K2, K4, K3)."""
    return chunked.factor(0.0, 1.0, A, periodic).solve(B)

#: K6's layout sweeps behind megastep.cluster_cost_us: (label, equations,
#: case, periodic) of grids at s = 1, 2 and 4, each timed (fixed RODASPR
#: steps, 20 per launch) at every chunk count of its own with 2 to
#: CLUSTER_SWEEP_MAX_MC rows a chunk and at most CLUSTER_SWEEP_MAX_C
#: chunks, on every cluster size that holds it
CLUSTER_SWEEPS = [
    ("readme N=200", README, readme_case(), False),
    ("readme N=1000", README, readme_case_at(1000), False),
    ("burgers N=10^4", BURGERS, burgers_case(N_REF_SMALL), True),
    ("burgers N=2^14", BURGERS, burgers_case(1 << 14), True),
    ("ks N=512", KS, ks_case(0.05, 0.2, 512), True),
    ("ks N=2^11", KS, ks_case(0.05, 0.2, 1 << 11), True),
    ("ks N=2^13", KS, ks_case(0.05, 0.2, N_SMALL), True),
    ("ks N=2^15", KS, ks_case(0.05, 0.2, 1 << 15), True),
    ("two-var N=600", TWO_VAR, two_var_case(0.02, 0.2, 600), True),
    ("two-var N=2^12", TWO_VAR, two_var_case(0.02, 0.2, 1 << 12), True),
]
CLUSTER_SWEEP_MAX_C = 4096
CLUSTER_SWEEP_MAX_MC = 256
#: the crossover sweep, K6 against the multi-launch path: (name,
#: equations, case of N, block size s) by scheme, at N = 2^e
SWEEP_MODELS = [("burgers", BURGERS, burgers_case, 1),
                ("ks", KS, lambda N: ks_case(0.05, 0.2, N), 2),
                ("two-var", TWO_VAR, lambda N: two_var_case(0.02, 0.2, N), 4)]
SWEEP_SCHEMES = {"rodaspr": lambda m: schemes.RODASPR(m, time_stepping=False, tol=None),
                 "theta": lambda m: schemes.Theta(m, theta=1.0)}
SWEEP_EXPONENTS = range(10, 17)

#: (name, equations, case, Simulation kwargs, f32 tolerance, f64 tolerance,
#: the kernel entries the case must launch (the grids K6's gate admits step
#: through K6 alone, the others through K1-K5 alone), and the plan the
#: grid must take: (route, C, Woodbury))
CASES = [
    ("burgers N=2^20 theta (4 steps)", BURGERS, burgers_case(N_BIG, 0.05, 4 * 0.05), THETA,
     1e-4, 1e-10, THETA_KERNELS, ("chunked", 4096, False)),
    ("burgers N=10^6 theta", BURGERS, burgers_case(N_REF), THETA, 1e-4, 1e-10,
     THETA_KERNELS + WOOD, ("chunked", 5000, True)),
    ("readme N=200 theta", README, readme_case(), THETA, 1e-3, 1e-10, ["K6.step"],
     ("megastep", 25, False)),
    ("ks N=2^20 rodaspr fixed (2 x 0.05)", KS, ks_case(0.05, 0.1),
     dict(scheme=schemes.RODASPR, time_stepping=False, tol=None), 1e-4, 1e-9, MULTI_LAUNCH,
     ("chunked", 4096, False)),
    ("ks N=10^6 rodaspr fixed (4 x 0.05)", KS, ks_case(0.05, 0.2, N_REF),
     dict(scheme=schemes.RODASPR, time_stepping=False, tol=None), 1e-4, 1e-9,
     MULTI_LAUNCH + WOOD, ("chunked", 4000, True)),
    ("ks N=2^20 rodaspr adaptive tol 1e-3 (1 x 1.0)", KS, ks_case(1.0, 1.0),
     dict(tol=1e-3), 1e-2, 1e-9, MULTI_LAUNCH, ("chunked", 4096, False)),
    ("ks N=10^6 rodaspr adaptive tol 1e-3 (2 x 1.0)", KS, ks_case(1.0, 2.0, N_REF),
     dict(tol=1e-3), 1e-2, 1e-9, MULTI_LAUNCH + WOOD, ("chunked", 4000, True)),
    ("ks N=2^13 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", KS,
     ks_case(1.0, 2.0, N_SMALL), dict(tol=1e-3), 1e-2, 1e-9, ["K6.adaptive"],
     ("megastep", 256, False)),
    ("ks N=10^4 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", KS,
     ks_case(1.0, 2.0, N_REF_SMALL), dict(tol=1e-3), 1e-2, 1e-9, ["K6.adaptive"],
     ("megastep", 250, True)),
    ("burgers N=10^4 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook", BURGERS,
     burgers_case(N_REF_SMALL, 1.0, 2.0), dict(tol=1e-3), 1e-2, 1e-9, ["K6.adaptive"],
     ("megastep", 500, True)),
    ("readme N=200 Simulation defaults (rodaspr)", README, readme_case(), {}, 1e-2,
     1e-9, ["K6.step"], ("megastep", 25, False)),
    ("readme N=200 example 01 (theta, step doubling)", README, readme_case(),
     dict(scheme=schemes.Theta, theta=1.0), 1e-2, 1e-9, ["K6.step"],
     ("megastep", 25, False)),
    # refine= and Theta(solver=): K1-K5 and K7, never K6 (REFINE_CHECKS)
    ("ks N=10^6 rodaspr fixed refine=1 (4 x 0.05)", KS, ks_case(0.05, 0.2, N_REF),
     REFINED, 1e-4, 1e-9, MULTI_LAUNCH + WOOD + K7, ("chunked", 4000, True)),
    ("advdiff N=1024 rodaspr fixed (500 x 0.01)", README, advdiff_case(), FIXED,
     1e-4, 1e-9, ["K6.step"], ("megastep", 64, False)),
    ("advdiff N=1024 rodaspr fixed refine=1 (500 x 0.01)", README, advdiff_case(),
     REFINED, 1e-4, 1e-9, MULTI_LAUNCH + K7, ("chunked", 512, False)),
    ("ks N=10^4 rodaspr adaptive tol 1e-3 refine=1 (2 x 1.0), no hook", KS,
     ks_case(1.0, 2.0, N_REF_SMALL), dict(tol=1e-3, refine=1), 1e-2, 1e-9,
     MULTI_LAUNCH + WOOD + K7, ("chunked", 500, True)),
    ("burgers N=10^6 theta solver= (10 steps)", BURGERS, burgers_case(N_REF),
     dict(THETA, solver=chunked_solver), 1e-4, 1e-10,
     THETA_KERNELS + WOOD + ["K5.combine"] + K7, ("chunked", 5000, True)),
]
#: cases driven by ``scheme(t, fields, dt, pars)`` a fixed number of times
#: (``run_steps``), not by ``Simulation``: 500 steps of 0.01 do not land on
#: one end time in float32 and float64 alike
FIXED_STEP_CASES = {"advdiff N=1024 rodaspr fixed (500 x 0.01)": 500,
                    "advdiff N=1024 rodaspr fixed refine=1 (500 x 0.01)": 500}
#: the refine and solver cases beyond the CPU comparison: their exact
#: launches, and (case, its dtype or None for the same, f32 limit, f64
#: limit, relative to max|u| or absolute) of the run on the card each must
#: agree with: refine=1 with refine=0 (KS), the reference's f32 envelope
#: against the f64 run without refinement (advection-diffusion), the
#: user's chunked solver with the plain Theta (Burgers)
REFINE_CHECKS = {
    "ks N=10^6 rodaspr fixed refine=1 (4 x 0.05)":
        ({"K7.matvec": 24, "K6.step": 0},
         ("ks N=10^6 rodaspr fixed (4 x 0.05)", None, 1e-4, 1e-10, True)),
    "advdiff N=1024 rodaspr fixed refine=1 (500 x 0.01)":
        ({"K7.matvec": 3000, "K6.step": 0},
         ("advdiff N=1024 rodaspr fixed (500 x 0.01)", "float64", 5e-5, 5e-5, False)),
    "ks N=10^4 rodaspr adaptive tol 1e-3 refine=1 (2 x 1.0), no hook":
        ({"K6.adaptive": 0, "K6.step": 0}, None),
    "burgers N=10^6 theta solver= (10 steps)":
        ({"K7.matvec": 10, "K6.step": 0},
         ("burgers N=10^6 theta", None, 1e-4, 1e-10, True)),
}


def noisy_burgers_case(N):
    """bench.py's Burgers state with noise of 0.05 (seed 0), the state of
    ``kernel_checks.megatheta_state``: its steps move u by some 5e-2 of
    max|u|, where those of the smooth state move it by some 3e-6."""
    fields, pars, dt, tmax, hook = burgers_case(N)
    fields["U"] = fields["U"] + 0.05 * np.random.default_rng(0).standard_normal(N)
    return fields, pars, dt, tmax, hook


#: the opt-in two-pass theta step (K9) through the reference's entry
#: ``Theta(model, theta=1).device_fixed_step_folded(N, periodic=True)`` with
#: ``TRIFLOW_MEGATHETA=1``: Burgers at bench.py's config 2 (``bench_burgers``,
#: N = 10^6, a Woodbury plan), the same with noise, and KS at N = 2^20 (s =
#: 2, block-cyclic), dt 0.05: (name, equations, case, steps, Woodbury plan,
#: the dtypes held on the increment).  Ten steps of the smooth Burgers state
#: move u by some 3e-5 of max|u|, under a quarter of float32's limit of
#: 1e-4 over one ulp of u (``kernel_checks.increment_error``): its float32
#: run is held on the state alone, and the noisy case holds float32's
#: increment on the same grid and plan
MEGATHETA_CASES = [
    ("burgers N=10^6 theta opt-in (10 steps)", BURGERS, burgers_case(N_REF), 10, True,
     ("float64",)),
    ("burgers N=10^6 noisy theta opt-in (3 steps)", BURGERS, noisy_burgers_case(N_REF), 3,
     True, ("float64", "float32")),
    ("ks N=2^20 theta opt-in (4 steps)", KS, ks_case(0.05, 0.2), 4, False,
     ("float64", "float32")),
]
K9 = ["K9.interface", "K9.correct"]


#: the reference's ensembles (bench.py: config 5, bench_ensemble, and the
#: sweep, bench_sweep): B KS members on x = 0.5 i, periodic
B_ENS, N_ENS = 1024, 10 ** 5
B_SWEEP, N_SWEEP = 64, 200
SHARED = dict(scheme=schemes.RODASPR, tol=1e-3)
PER_MEMBER = dict(scheme=schemes.RODASPR, tol=1e-3, per_member_dt=True)
B_REFINE = 4


@functools.lru_cache(maxsize=None)
def ensemble_state(B, N, seed, waves):
    """bench.py's ensemble state: cos(2 pi waves i / N + phase_b) + 0.1
    randn, the phases and the noise from one seed."""
    rng = np.random.RandomState(seed)
    phases = rng.rand(B, 1) * 2 * np.pi
    i = np.arange(N)
    return 0.5 * i, np.cos(2 * np.pi * i[None] / N * waves + phases) + 0.1 * rng.randn(B, N)


def make_ensemble(B, N, seed, waves, dtype, device, kwargs, double=None):
    """An ensemble of KS members of ``ensemble_state``; ``double`` overrides
    the model's mode (``"df64"``)."""
    x, u0 = ensemble_state(B, N, seed, waves)
    model = Model(*KS, double=dtype == torch.float64 if double is None else double,
                  device=device)
    return Ensemble(model, **ensemble_from_numpy(model, u0, x, dict(periodic=True)),
                    **kwargs)


#: (name, B, N, seed, waves, Ensemble kwargs, calls ((n, dt): steps(n, dt),
#: (None, dt): step(dt)), route, launches of the whole case (a callable of
#: the plan for the multi-launch route), compare with the CPU f64 run)
ENSEMBLE_CASES = [
    ("config 5: B=1024 x ks N=10^5 rodaspr fixed (steps(3, 0.05))", B_ENS, N_ENS, 1, 10,
     FIXED, [(3, 0.05)], "host",
     lambda plan: {"K1.J": 3, "K2.spike_factor": 3,
                   kernel_checks.factor_entry(plan.s, plan.C): 3,
                   kernel_checks.setup_entry(plan.s, plan.C, plan.B):
                   3 if plan.woodbury else 0, "K1.F_terms": 18,
                   "K3.thomas_sweep": 18, "K4.pcr_solve_shift": 18,
                   "K3.spike_correct": 18, "K5.combine": 3}, False),
    ("sweep: B=64 x ks N=200 rodaspr fixed (steps(100, 0.05))", B_SWEEP, N_SWEEP, 2, 5,
     FIXED, [(100, 0.05)], "K6", lambda plan: {"K6.step": 1}, True),
    ("sweep: B=64 x ks N=200 rodaspr shared dt tol 1e-3 (steps(4, 0.1))", B_SWEEP,
     N_SWEEP, 2, 5, SHARED, [(4, 0.1)], "K6", lambda plan: {"K6.adaptive_scan": 1}, True),
    ("sweep: B=64 x ks N=200 rodaspr shared dt tol 1e-3 (step(0.1))", B_SWEEP,
     N_SWEEP, 2, 5, SHARED, [(None, 0.1)], "K6", lambda plan: {"K6.adaptive_scan": 1},
     True),
    ("sweep: B=64 x ks N=200 rodaspr per-member dt tol 1e-3 (steps(4, 0.1))", B_SWEEP,
     N_SWEEP, 2, 5, PER_MEMBER, [(4, 0.1)], "K6", lambda plan: {"K6.adaptive_scan": 1},
     True),
    # refine=1: the host route, a residual (K7 with a member axis, K5) and
    # one more solve per stage
    ("B=4 x ks N=10^5 rodaspr fixed refine=1 (steps(2, 0.05))", B_REFINE, N_ENS, 1, 10,
     REFINED, [(2, 0.05)], "host",
     lambda plan: {"K1.J": 2, "K2.spike_factor": 2,
                   kernel_checks.factor_entry(plan.s, plan.C): 2,
                   kernel_checks.setup_entry(plan.s, plan.C, plan.B):
                   2 if plan.woodbury else 0, "K1.F_terms": 12,
                   "K3.thomas_sweep": 24, "K4.pcr_solve_shift": 24,
                   "K3.spike_correct": 24, "K5.combine": 14, "K7.matvec": 12}, False),
]


#: the df64 mode's step (bench.py:461 bench_df64 and :545 bench_df64_smalln:
#: 0.0625, exact in float32, so the card's double=True run takes the same dt)
DF64_DT = 0.0625
MIXED1 = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None, df64_mixed_solve=1)
DF64_FULL = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None)


def df64_expect_mixed(per_step):
    """The launches of a df64 mixed case: K6's mixed entry once per step
    where its gate admits the grid, else K8 six times per step (RODASPR,
    one pass) and no K6 entry."""
    def expect(plan, steps):
        if plan is not None:
            return {"K6.step_mixed": steps, "K8.residual": 0}
        return {"K8.residual": per_step * steps, "K6.step_mixed": 0, "K6.step": 0}
    return expect


#: the df64 mode on the card (model double="df64"): (name, equations, case,
#: kwargs, how it runs (("steps", n): n scheme calls; ("scan", n): one
#: device_fixed_scan of n steps; ("sim", None): Simulation), the kernel
#: entries it must launch at least once, the exact launches as a callable of
#: (K6 mixed plan or None, steps or attempts), what it is held to ("f64":
#: the card's double=True run of the same case; "cpu": the port's CPU df64
#: run, attempts equal) and the limit on max|du| / max|u|)
DF64_CASES = [
    ("(a) ks N=10^6 rodaspr df64 mixed=1 (4 x 0.0625)", KS,
     ks_case(DF64_DT, 4 * DF64_DT, N_REF), MIXED1, ("steps", 4),
     MULTI_LAUNCH + WOOD + ["K8.residual"],
     lambda plan, n: {"K8.residual": 24, "K6.step_mixed": 0, "K6.step": 0}, "f64", 1e-11),
    ("(b) ks N=10^6 rodaspr df64 full (4 x 0.0625)", KS,
     ks_case(DF64_DT, 4 * DF64_DT, N_REF), DF64_FULL, ("steps", 4), MULTI_LAUNCH + WOOD,
     lambda plan, n: {"K8.residual": 0, "K6.step_mixed": 0, "K6.step": 0}, "f64", 1e-10),
    ("(c) ks N=10^4 rodaspr df64 mixed=1 (200 x 0.0625)", KS,
     ks_case(DF64_DT, 200 * DF64_DT, N_REF_SMALL), MIXED1, ("steps", 200), [],
     df64_expect_mixed(6), "f64", 1e-10),
    ("(d) ks N=2^13 rodaspr df64 mixed=1 device_fixed_scan(200)", KS,
     ks_case(DF64_DT, 200 * DF64_DT, N_SMALL), MIXED1, ("scan", 200), ["K6.step_mixed"],
     lambda plan, n: {"K6.step_mixed": 1, "K8.residual": 0, "K6.step": 0}, "f64", 1e-10),
    ("(e) burgers N=10^4 theta df64 mixed=1 (10 x 0.0625)", BURGERS,
     burgers_case(N_REF_SMALL, DF64_DT, 10 * DF64_DT),
     dict(scheme=schemes.Theta, theta=1.0, df64_mixed_solve=1), ("steps", 10),
     ["K6.step_mixed"],
     lambda plan, n: {"K6.step_mixed": 10, "K8.residual": 0, "K6.step": 0}, "f64", 1e-10),
    ("(f) readme N=200 Simulation defaults df64 (hook, full solver)", README,
     readme_case(), {}, ("sim", None), ["K6.step"],
     lambda plan, n: {"K6.step": n, "K8.residual": 0, "K6.step_mixed": 0,
                      "K6.adaptive": 0}, "cpu", 1e-10),
    ("(g) ks N=10^4 rodaspr df64 mixed=1 adaptive tol 1e-3 (2 x 1.0)", KS,
     ks_case(1.0, 2.0, N_REF_SMALL), dict(tol=1e-3, df64_mixed_solve=1), ("sim", None), [],
     df64_expect_mixed(6), "cpu", 1e-10),
]


def run_df64(case, device, double):
    """(u, attempts per output step, steps or attempts) of a df64 case run
    with the model's mode ``double`` ("df64", or True for its float64
    twin) on ``device``."""
    _, eqs, state, kwargs, (how, n), *_ = case
    if how == "sim":
        _, u, attempts = run_simulation(eqs, state, device, torch.float64, kwargs, double)
        return u, attempts, sum(attempts)
    if how == "steps":
        _, u, _ = run_steps(eqs, state, device, torch.float64, kwargs, n, double)
        return u, [], n
    fields_np, pars, dt, _, _ = state
    model = Model(*eqs, double=double, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    b = model.backend
    u, helpers, x = b.split_fields(fields)
    kw = {k: v for k, v in kwargs.items() if k != "scheme"}
    scan = kwargs["scheme"](model, **kw).device_fixed_scan(x.shape[-1], periodic=True)
    # the U row of the final state, as the other runs give it
    return scan(0.0, u, helpers, b.pack_pars(pars_t, x), x, dt, n)[0], [], n


def drive(ens, calls):
    for n, dt in calls:
        if n is None:
            ens.step(dt)
        else:
            ens.steps(n, dt)
    return ens


def case_plan(eqs, case, route):
    """The chunk plan the case's grid takes on its route."""
    fields_np, pars, _, _, _ = case
    sysm = Model(*eqs, device="cpu").system
    N = len(fields_np["x"])
    if route == "megastep":
        return megastep.plan_for(N, sysm.nvar, sysm.halo, pars["periodic"])
    return chunked.make_plan(N, sysm.nvar, sysm.halo, pars["periodic"])


def run_case(name, eqs, case, device, dtype, kwargs):
    """(output steps, final u, attempts in each output step) of a case of
    ``CASES``."""
    if name in FIXED_STEP_CASES:
        return run_steps(eqs, case, device, dtype, kwargs, FIXED_STEP_CASES[name])
    return run_simulation(eqs, case, device, dtype, kwargs)


def run_steps(eqs, case, device, dtype, kwargs, n, double=None):
    """``run_simulation`` of n calls of the scheme itself (no attempts
    kept: these schemes are fixed-step)."""
    fields_np, pars, dt, _, hook = case
    double = dtype == torch.float64 if double is None else double
    model = Model(*eqs, double=double, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    kw = {k: v for k, v in kwargs.items() if k != "scheme"}
    scheme = kwargs["scheme"](model, **kw)
    t = 0.0
    for _ in range(n):
        t, fields = scheme(t, fields, dt, pars_t, hook=hook or schemes.null_hook)
    return n, fields["U"], []


def run_simulation(eqs, case, device, dtype, kwargs, double=None):
    """(output steps, final u, attempts in each output step); ``double``
    overrides the model's mode (``"df64"``)."""
    fields_np, pars, dt, tmax, hook = case
    double = dtype == torch.float64 if double is None else double
    model = Model(*eqs, double=double, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax,
                     hook=hook or schemes.null_hook, **kwargs)
    attempts = []
    for t, fields in sim:
        attempts.append(getattr(sim._scheme, "_internal_iter", None))
    if sim.status != "finished" or not np.isclose(t, tmax):
        raise RuntimeError(f"simulation ended at t={t} with status {sim.status}")
    return sim.i, fields["U"], attempts


def cuda_ms(fn, iters):
    """Mean ms of fn() over iters launches, after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(path):
    """(function, registers, stack bytes, spill store bytes) of every kernel
    and non-inlined function in an nvcc ``-Xptxas -v`` log."""
    out, fn, stack, spill = [], None, 0, 0
    for line in path.read_text().splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "bytes stack frame" in line:
            stack = int(re.findall(r"(\d+) bytes stack frame", line)[0])
            spill = int((re.findall(r"(\d+) bytes spill stores", line) or ["0"])[0])
        elif "Used" in line and "registers" in line:
            out.append((fn, int(line.split("Used")[1].split()[0]), stack, spill))
            stack = spill = 0
    return out


def ptxas_smem(path):
    """{function: static shared-memory bytes} of an nvcc ``-Xptxas -v``
    log (the kernels' dynamic shares come from their launch plans)."""
    out, fn = {}, None
    for line in path.read_text().splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "Used" in line and "registers" in line:
            got = re.findall(r"(\d+) bytes smem", line)
            out[fn] = int(got[0]) if got else 0
    return out


def phase0():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 0: card {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    start = time.perf_counter()
    # K1 and K6 carry one dtype each: both dtypes of each model, and the
    # float64 models' libraries of K6's mixed entry (the df64 cases)
    models = [Model(*eqs, double=d).backend for eqs in (BURGERS, README, KS, TWO_VAR)
              for d in (True, False)]
    jobs = [job for lib in (thomas.FACTOR_LIB, thomas.SOLVE_LIB, pcr.LIB, combine.LIB,
                            matvec.LIB, mixed.LIB, thomas.FACTOR_WIDE_LIB,
                            thomas.SOLVE_WIDE_LIB, pcr.WIDE_LIB) for job in lib.builds()]
    # the falling film's K1 (S = 6) and the wave model's (the explicit RK
    # family's cases), both dtypes
    jobs += [Model(*eqs, double=d).backend.stencil.load for eqs in (FILM, WAVE)
             for d in (True, False)]
    jobs += [b.stencil.load for b in models] + [b.megastep.load for b in models]
    jobs += [b.megastep_mixed.load for b in models[::2]]
    # K9 for Burgers (s = 1) and KS (s = 2), both dtypes
    k9_models = models[:2] + models[4:6]
    jobs += [b.megatheta.load for b in k9_models]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for fut in [pool.submit(job) for job in jobs]:
            fut.result()
    log(f"phase 0: built {len(jobs)} libraries in "
        f"{time.perf_counter() - start:.1f} s (nvcc: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items()))
        + ")")
    mega_logs = {}
    for b, label in zip(models, [f"{m} {d}" for m in ("s=1 burgers", "s=1 readme", "s=2 ks",
                                                       "s=4 two-variable")
                                 for d in ("f64", "f32")]):
        mega_logs[Path(b.megastep.lib._name).with_suffix(".log")] = label
        if b.megastep_mixed.lib is not None:
            mega_logs[Path(b.megastep_mixed.lib._name).with_suffix(".log")] = (
                f"{label} mixed entry")
    k9_logs = {Path(b.megatheta.lib._name).with_suffix(".log"): label for b, label in
               zip(k9_models, ("s=1 burgers f64", "s=1 burgers f32", "s=2 ks f64",
                               "s=2 ks f32"))}
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        report = ptxas_report(path)
        smem = ptxas_smem(path)
        spills = [f"{fn} ({sp} bytes spill stores)" for fn, _, _, sp in report if sp]
        log(f"  ptxas {path.stem}: {len(report)} kernels, at most "
            f"{max((r for _, r, _, _ in report), default=0)} registers; spills: "
            f"{'; '.join(spills) or 'none'}")
        for fn, regs, stack, spill in report:
            # the s = 2 instantiations of K2/K3 and S2 = 4 of K4 (the KS path)
            if fn and (("spike" in fn or "thomas" in fn) and "Li2E" in fn
                       or "pcr" in fn and "Li4E" in fn):
                log(f"    registers {fn}: {regs}")
            if path in mega_logs:
                log(f"    K6 {mega_logs[path]} {fn}: {regs} registers, {stack} bytes "
                    f"stack, {spill} bytes spill stores, {smem.get(fn, 0)} bytes static "
                    f"shared memory (at most {megastep.STATIC_SMEM} planned beside a "
                    "cluster plan's dynamic shares)")
                if smem.get(fn, 0) > megastep.STATIC_SMEM:
                    raise RuntimeError(f"K6 {fn}: {smem[fn]} bytes of static shared "
                                       f"memory, over megastep.STATIC_SMEM")
            # K1's tiled F, F_terms and J, each model and dtype
            if fn and path.name.startswith("stencil") and re.search(
                    r"stencil_(F|F_terms|J)_kernel", fn):
                log(f"    K1 {path.stem} {fn}: {regs} registers, {stack} bytes stack, "
                    f"{spill} bytes spill stores")
            # K7's tiled instantiations (W, nvar) and its per-node body
            k7 = re.search(r"matvec_(tiled|nodes)_kernelI([df])(?:Li(\d+)ELi(\d+)E)?", fn or "")
            if k7 and path.name.startswith("matvec"):
                body, typ, W, nv = k7.groups()
                log(f"    K7 {body}<{'double' if typ == 'd' else 'float'}"
                    + (f", W={W}, nvar={nv}" if W else "") + f">: {regs} registers, "
                    f"{stack} bytes stack, {spill} bytes spill stores")
            if path in k9_logs:
                log(f"    K9 {k9_logs[path]} {fn}: {regs} registers, {stack} bytes "
                    f"stack, {spill} bytes spill stores")
            # the wide instantiations, and the narrow ones of K3's tiled
            # correction and K4's factors: kernel<type, sizes..., flags...>
            wide = re.search(r"([a-z][a-z_]*_kernel)I([df])((?:Li\d+E)+)((?:Lb[01]E)*)",
                             fn or "")
            if wide and ("_wide" in path.name or re.match(
                    r"spike_correct|pcr_factor|pcr_solve_cols|woodbury_cap", wide.group(1))):
                name, typ, sizes, flags = wide.groups()
                log(f"    {'wide' if '_wide' in path.name else 'narrow'} "
                    f"{name}<{'double' if typ == 'd' else 'float'}"
                    + "".join(f", {v}" for v in re.findall(r"Li(\d+)E", sizes))
                    + "".join(f", {f}" for f in re.findall(r"Lb([01])E", flags))
                    + f">: {regs} registers, {stack} bytes stack, {spill} bytes spill stores")
    return smi


def path_inputs(eqs, case, dtype, double=None):
    """A model on the card, its state, and the inputs each kernel gets on
    the path's first step; ``double`` overrides the model's mode
    (``"df64"``)."""
    fields_np, pars, dt, _, _ = case
    double = dtype == torch.float64 if double is None else double
    model = Model(*eqs, double=double, device="cuda")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    b = model.backend
    u, helpers, x = b.split_fields(fields)
    pstack = b.pack_pars(pars_t, x)
    return model, fields, pars_t, (u, helpers, pstack, x), dt


def rodaspr_rows():
    """The final combination's rows of RODASPR, as the scheme emits them."""
    ros = schemes.RODASPR(Model(*KS, device="cpu"))
    m = [float(v) for v in ros._m_t]
    d = [float(a - b) for a, b in zip(ros._m_t, ros._m_pred_t)]
    return [[1.0] + m, [0.0] + d], float(ros._gamma[0, 0])


def matvec_path_checks(dtype, res):
    """K7 against its plain version on the bands and vectors of phase 2's
    refine and solver cases: J's bands of each case's state with the first
    stage's solution and g00 dt (the ROW residual), or the state and
    -theta dt (the Theta right-hand side); the B = 4 ensemble's member
    bands with a shared and a per-member scale."""
    T = np.float64 if dtype == torch.float64 else np.float32
    _, g00 = rodaspr_rows()
    for eqs, case, row in ((KS, ks_case(0.05, 0.2, N_REF), True),
                           (README, advdiff_case(), True),
                           (KS, ks_case(1.0, 2.0, N_REF_SMALL), True),
                           (BURGERS, burgers_case(N_REF), False)):
        model, _, _, args, dt = path_inputs(eqs, case, dtype)
        b, periodic = model.backend, case[1]["periodic"]
        N = args[-1].shape[-1]
        bands = b.J_bands(*args, periodic=periodic)
        if row:
            gdt = float(T(g00) * T(dt))
            rhs = b.F(*args, periodic=periodic, scale=gdt)
            k = chunked.factor(1.0, -gdt, bands, periodic).solve(rhs)
            kernel_checks.check_matvec(bands, k, periodic, gdt, res, f"N={N} stage 1")
        else:
            kernel_checks.check_matvec(bands, args[0], periodic, -dt, res, f"N={N} theta")
    ens = make_ensemble(B_REFINE, N_ENS, 1, 10, dtype, "cuda", REFINED)
    b = ens.model.backend
    args = (ens.u, ens.helpers, ens.pstack, ens.x)
    bands = b.J_bands(*args, periodic=True)
    gdt = float(T(g00) * T(0.05))
    plan = ens._scheme._plan(N_ENS, True, B_REFINE)
    k = chunked.factor(1.0, -gdt, bands, True, plan).solve(
        b.F(*args, periodic=True, scale=gdt))
    per_member = megastep.gdt_of(T, g00, 0.05 / 2.0 ** np.arange(B_REFINE), "cuda")
    for scale in (gdt, per_member):
        kernel_checks.check_matvec(bands, k, True, scale, res,
                                   f"B={B_REFINE} N={N_ENS} stage 1")


def carry_checks(sm, sargs, dtype, dt_name, res):
    """K6's Kahan carry, each entry from a seeded carry
    (``kernel_checks.check_compensated``): the step entry bit for bit three
    bare launches folded by kahan_update, the adaptive entry's output step
    and the adaptive scan's two (shared dt, and per member for B = 4) bit
    for bit the controller replayed on the host on step-entry launches
    folded by kahan_update (u, carry, dt_i, attempts), and every entry
    against its plain version, to the solver tolerance of
    ``kernel_checks.TOL`` (KS 2^13 on its path's state and plan, one grid
    and B = 4, and ``COMPENSATED_CASES``: s = 1, 2, 4, one grid and
    B = 4)."""
    for B in (1, kernel_checks.BATCH):
        kernel_checks.check_compensated(sm, N_SMALL, True, 0.05, "cuda", res,
                                        (1.0, 1e-6, 1e-3), B, state=sargs)
    kernel_checks.check_all_compensated("cuda", dtype, res)
    log(f"  K6.compensated {dt_name}: the step entry, the adaptive entry and the "
        "adaptive scan bit for bit their bare launches folded by kahan_update and the "
        "controller replayed on them; against its plain version: max abs error "
        f"{res['K6.compensated']:.3e} (tolerance {kernel_checks.TOL[dtype]['solve']:.0e} "
        f"of max|u|), dt_i {res['K6.compensated dt_i']:.3e}")


def mixed_path_checks(res):
    """The df64 mode's kernels on the main paths' inputs: K8 on the bands,
    the first stage's solution and right-hand side of the KS N = 10^6 df64
    case (its first residual pass); K6's mixed entry (RODASPR and Theta,
    one pass: one step, and 3 steps in one launch bit for bit against 3
    launches) on the KS N = 2^13 path's state, on the KS N = 10^4 path's
    (cases (c) and (g)) and on Burgers N = 10^4 (case (e))."""
    _, g00 = rodaspr_rows()
    gdt = g00 * DF64_DT
    model, _, _, args, _ = path_inputs(KS, ks_case(DF64_DT, 4 * DF64_DT, N_REF),
                                       torch.float64, "df64")
    b = model.backend
    bands = b.J_bands(*args, periodic=True)
    plan = chunked.make_plan(N_REF, 1, 2, True)
    rhs = b.F(*args, periodic=True, scale=gdt)
    k = mixed.MixedFactorization(bands, gdt, True, plan, 0).solve(rhs)
    kernel_checks.check_mixed_residual(bands, k, rhs, gdt, True, res,
                                       f"KS N={N_REF} stage 1")
    for eqs, case in ((KS, ks_case(DF64_DT, 1.0, N_SMALL)),
                      (KS, ks_case(DF64_DT, 1.0, N_REF_SMALL)),
                      (BURGERS, burgers_case(N_REF_SMALL, DF64_DT, 1.0))):
        m, _, _, a, _ = path_inputs(eqs, case, torch.float64, "df64")
        kernel_checks.check_megastep_mixed(m, a[-1].shape[-1], True, DF64_DT, "cuda",
                                           res, state=a, passes=(1,))
    # the member-axis mixed solve of the df64 ensembles (B = 4, per-member
    # coef): K2, K4 in float32, K3 and K4's solves in float32, K8
    kernel_checks.check_all_mixed_members("cuda", res)
    log(f"  mixed solve with a member axis (B = {kernel_checks.BATCH}, per-member coef): "
        f"max abs error {res['mixed solve members']:.3e} against its plain version, "
        f"{res['mixed solve members alone']:.3e} against each member's one-grid solve "
        f"(tolerance {kernel_checks.TOL[torch.float64]['solve']:.0e} of max|k|)")


def phase1():
    log("phase 1: kernels against their plain versions")
    off = []
    for dt_name, dtype in DTYPES.items():
        limit = kernel_checks.TOL[dtype]["dt"]
        for case, rows in kernel_checks.adaptive_dt_readings("cuda", dtype).items():
            gaps = [g for _, g, _, _, _ in rows]
            caught = [not same or bad > limit for _, _, _, bad, same in rows]
            log(f"  K6.adaptive dt_i readings {case} {dt_name} (seed: kernel gap, "
                "attempts equal; err x 2 gap, attempts equal): "
                + "; ".join(f"{sd}: {g:.3e} {a}; {b:.3e} {c}" for sd, g, a, b, c in rows)
                + f" -> largest kernel gap {max(gaps):.3e}, limit {limit:.0e}, "
                f"wrong err caught in {sum(caught)} of {len(rows)}")
            if max(gaps) > limit or not all(a for _, _, a, _, _ in rows):
                off.append(f"{case} {dt_name}")
    if off:
        raise RuntimeError(f"K6.adaptive dt_i or attempts off the plain version: {off}")
    small = kernel_checks.run_all("cuda")
    for dt_name, res in small.items():
        log(f"  small shapes {dt_name}: " + json.dumps(res))
    rows, _ = rodaspr_rows()
    errs = {}
    for dt_name, dtype in DTYPES.items():
        res = dict(small[dt_name])
        model, _, _, args, dt = path_inputs(BURGERS, burgers_case(), dtype)
        kernel_checks.check_stencil(model, N_BIG, True, "cuda", results=res)
        bands = model.backend.J_bands(*args, periodic=True)
        kernel_checks.check_solver(bands, 1.0, -dt, True, results=res)
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        kernel_checks.check_stencil(rm, 200, False, "cuda", results=res)
        fields, pars = state_from_numpy(readme_case()[0], readme_case()[1], rm)
        u, helpers, x = rm.backend.split_fields(fields)
        rbands = rm.backend.J_bands(u, helpers, rm.backend.pack_pars(pars, x), x,
                                    periodic=False)
        kernel_checks.check_solver(rbands, 1.0, -5.0, False, results=res)
        # the KS path: F with bias and J at s = 2, the s = 2 solver, K5 at
        # A = 7, R = 2 and at every stage's A, R = 2
        km, _, _, kargs, kdt = path_inputs(KS, ks_case(0.05, 0.2), dtype)
        kernel_checks.check_stencil(km, N_BIG, True, "cuda", results=res)
        kbands = km.backend.J_bands(*kargs, periodic=True)
        kernel_checks.check_solver(kbands, 1.0, -0.25 * kdt, True, results=res)
        rng = np.random.default_rng(1)
        for A in range(2, 8):
            arrays = [torch.tensor(rng.standard_normal((1, N_BIG)), dtype=dtype,
                                   device="cuda") for _ in range(A)]
            stage_rows = [row[:A] for row in rows] if A < 7 else rows
            kernel_checks.check_combine(stage_rows, arrays, res)
        # K6 on the small KS path of phase 2 (N = 2^13, its state and plan)
        sm, _, _, sargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
        kernel_checks.check_megastep(sm, N_SMALL, True, 0.05, "cuda", res,
                                     adaptive=(1.0, 1e-6, 1e-3), state=sargs)
        carry_checks(sm, sargs, dtype, dt_name, res)
        # the reference's grids, Woodbury plans: the solver at Burgers and KS
        # N = 10^6 and KS N = 10^4, K6 on Burgers N = 10^4
        for eqs, case, g00 in ((BURGERS, burgers_case(N_REF), 1.0),
                               (KS, ks_case(0.05, 0.2, N_REF), 0.25),
                               (KS, ks_case(0.05, 0.2, N_REF_SMALL), 0.25)):
            wm, _, _, wargs, wdt = path_inputs(eqs, case, dtype)
            wbands = wm.backend.J_bands(*wargs, periodic=True)
            kernel_checks.check_solver(wbands, 1.0, -g00 * wdt, True, results=res)
        bm, _, _, bargs, _ = path_inputs(BURGERS, burgers_case(N_REF_SMALL, 1.0, 2.0), dtype)
        kernel_checks.check_megastep(bm, N_REF_SMALL, True, 0.05, "cuda", res,
                                     adaptive=(1.0, 1e-6, 1e-3), state=bargs)
        matvec_path_checks(dtype, res)
        # K9 at the opt-in path's shapes and plans: Burgers N = 10^6
        # (Woodbury) and KS N = 2^20 (block-cyclic), on megatheta_state's
        # noisy state, where a step moves u by far more than the limits
        for eqs, case in ((BURGERS, burgers_case(N_REF)), (KS, ks_case(0.05, 0.2))):
            model, plan, _, _ = megatheta_entry(eqs, case, "cuda", dtype, True)
            kernel_checks.check_megatheta(model, plan.N, case[2], 1.0, "cuda", res,
                                          plan=plan)
        if dtype == torch.float64:
            mixed_path_checks(res)
        # K3's staged sweep at s = 1..8 (one grid and members, Mc = 2, odd,
        # no multiple of the stage rows, kept and streamed), K5 bit for bit
        kernel_checks.check_all_sweeps("cuda", dtype, res)
        kernel_checks.check_combines_exact("cuda", dtype, res)
        # K2's staged walk at s = 1..4 (block-cyclic, Woodbury, acyclic and
        # padded plans, members, the forward results kept and streamed) and
        # K4's cluster solve at s2 = 2..16 (clusters of one CTA and of
        # several, with and without the Woodbury correction, members)
        kernel_checks.check_all_factors("cuda", dtype, res)
        kernel_checks.check_all_shifts("cuda", dtype, res)
        # K3's tiled correction at s = 1..8 (one chunk to part-full chunk
        # groups, Mc no multiple of the block's rows, members, B = 1024) and
        # at config 5's shape; K4's narrow factor by the route its shape
        # picks (block-cyclic, Woodbury, acyclic, the ring's C = 1534,
        # members)
        kernel_checks.check_all_corrections("cuda", dtype, res)
        kernel_checks.check_correct(2, 100, N_ENS // 200, B_ENS, dtype, "cuda", results=res)
        kernel_checks.check_all_grid_factors("cuda", dtype, res)
        # K4's Woodbury set-up and R-column solve across the card at s =
        # 1..8 (C = 2 to the cells' 2500, members up to config 5's 1024), bit
        # for bit the one-block body; K1's tiled F and F_terms at odd N
        # (fewer nodes than the halo spans to 4099; B = 1, 4 and 1024), F
        # bit for bit the per-node body
        kernel_checks.check_all_setups("cuda", dtype, res)
        kernel_checks.check_all_tiled_F("cuda", dtype, res)
        # K1's tiled J on every model, periodic and edge, at the same
        # shapes and beyond 65535 members, bit for bit the per-node body
        kernel_checks.check_all_tiled_J("cuda", dtype, res)
        # K6's cluster body at every cluster size (K = 1, 2, 4, 8, 16 forced):
        # edge grids, block-cyclic and Woodbury rings, C not divisible by K,
        # s = 1, 2, 4, B = 4 members and the mixed entry, each entry against
        # its plain version and every size bit for bit the others
        skipped = []
        kernel_checks.check_clusters("cuda", dtype, res, skipped=skipped)
        log(f"  K6 cluster sizes {dt_name}: every size bit for bit equal; sizes that "
            f"hold no member of the case: {skipped}")
        padded_path_checks(dtype, res)
        log(f"  main-path shapes {dt_name}: " + json.dumps(res))
        errs[dt_name] = res
    # the member axis: K1-K4 and K6 on B = 4 members (block-cyclic and
    # Woodbury rings), K1.F_terms, K6.adaptive_scan with a shared dt and per
    # member; then K6's entries at the sweep's shapes (B = 64, KS N = 200)
    batched = kernel_checks.run_batched("cuda")
    for dt_name, dtype in DTYPES.items():
        res = batched[dt_name]
        log(f"  member axis, B = {kernel_checks.BATCH}, small shapes {dt_name}: "
            + json.dumps(res))
        model = Model(*KS, double=dtype == torch.float64, device="cuda")
        kernel_checks.check_megastep_batched(model, N_SWEEP, True, 0.05, "cuda", res,
                                             adaptive=(0.1, 1e-6, 1e-3), B=B_SWEEP)
        log(f"  member axis, the sweep's shapes (B = {B_SWEEP}, ks N = {N_SWEEP}) "
            f"{dt_name}: " + json.dumps(res))
        for name, err in res.items():
            errs[dt_name][name] = max(errs[dt_name].get(name, 0.0), err)
    return errs


def phase2():
    log("phase 2: the main paths through Simulation on the card")
    runs, launches = {}, dict.fromkeys(KERNELS, 0)
    for name, eqs, case, kwargs, _, _, needs, (route, C, wood) in CASES:
        plan = case_plan(eqs, case, route)
        if plan is None or (plan.C, plan.woodbury) != (C, wood):
            raise RuntimeError(f"{name}: plan {plan} on the {route} route, expected C={C} "
                               f"woodbury={wood}")
        log(f"  {name}: plan C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury} ({route})")
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            steps, u, attempts = run_case(name, eqs, case, "cuda", dtype, kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            runs[(name, dt_name)] = (steps, u, attempts, secs)
            log(f"  {name} {dt_name}: launches "
                + json.dumps({k: v for k, v in counts.items() if v}))
            # K4's factor by the route the plan's chunk count picks
            needs = [kernel_checks.factor_entry(plan.s, plan.C) if k == "K4.pcr_factor" else k
                     for k in needs]
            missing = [k for k in needs if counts[k] <= 0]
            small = any(k.startswith("K6") for k in needs)
            others = [k for k in KERNELS if k not in needs and counts[k]
                      and (small or k.startswith("K6")
                           or k in ("K1.F_terms", "K7.matvec", "K8.residual"))]
            if missing or others:
                raise RuntimeError(f"{name} {dt_name}: kernels not launched {missing}, "
                                   f"launched off this path {others}")
            if "K6.adaptive" in needs and counts["K6.adaptive"] != steps:
                raise RuntimeError(f"{name} {dt_name}: {counts['K6.adaptive']} K6 "
                                   f"adaptive launches for {steps} output steps")
            # the Woodbury set-up: one launch per factor on the multi-launch
            # path, none on a block-cyclic plan (inside K6 on K6's route)
            factors = counts["K2.spike_factor"] if wood and route == "chunked" else 0
            if counts["K4.pcr_solve"] != factors:
                raise RuntimeError(f"{name} {dt_name}: {counts['K4.pcr_solve']} K4.pcr_solve "
                                   f"launches for {counts['K2.spike_factor']} factors")
            exact, _ = REFINE_CHECKS.get(name, ({}, None))
            off = {k: counts[k] for k, v in exact.items() if counts[k] != v}
            if off:
                raise RuntimeError(f"{name} {dt_name}: launches {off}, expected {exact}")
            for k in KERNELS:
                launches[k] += counts[k]
    log("  launches over phase 2: " + json.dumps(launches))
    for name, (_, against) in REFINE_CHECKS.items():
        if against is None:
            continue
        other, other_dt, lim32, lim64, relative = against
        for dt_name in DTYPES:
            u = runs[(name, dt_name)][1].double()
            ref = runs[(other, other_dt or dt_name)][1].double()
            err = float((u - ref).abs().max())
            if relative:
                err /= float(ref.abs().max())
            lim = lim32 if dt_name == "float32" else lim64
            log(f"  {name} {dt_name} against {other} {other_dt or dt_name} on the card: "
                f"max|du|{' / max|u|' if relative else ''} = {err:.3e} (limit {lim:.0e})")
            if not err <= lim:
                raise RuntimeError(f"{name} {dt_name}: off {other} on the card")
    refs = cpu_refs()
    for name, eqs, case, kwargs, tol32, tol64, _, _ in CASES:
        steps_ref, u_ref, att_ref, cpu_s = refs[name]
        u_ref = torch.from_numpy(u_ref)
        scale = float(u_ref.abs().max())
        _, _, dt, tmax, _ = case
        log(f"  {name}: horizon {tmax:g} in output steps of {dt:g}; CPU f64 "
            f"attempts per output step {att_ref} ({cpu_s:.1f} s)")
        for dt_name in DTYPES:
            steps, u, attempts, secs = runs[(name, dt_name)]
            if not bool(torch.isfinite(u).all()) or u.shape != u_ref.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            err = float((u.double().cpu() - u_ref).abs().max()) / scale
            tol = tol32 if dt_name == "float32" else tol64
            log(f"    {dt_name}: {steps} steps in {secs:.3f} s wall (first call, "
                f"launch included); attempts per output step {attempts}; "
                f"max|u - u_cpu_f64| / max|u| = {err:.3e} (tolerance {tol:.0e})")
            if steps != steps_ref or not err <= tol:
                raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
            if dt_name == "float64" and attempts != att_ref:
                raise RuntimeError(f"{name} f64: attempts {attempts} differ from the "
                                   f"CPU run's {att_ref}")
    return launches


def phase2_df64(launches):
    """The df64 mode through the port's entry points on the card
    (``DF64_CASES``): each case with the launch counts set to 0 just before
    it and read just after, held to its exact launches and to the card's
    double=True run of the same case or the port's CPU df64 run."""
    log("phase 2: the df64 mode (Model(double='df64')) on the card")
    for case in DF64_CASES:
        name, eqs, state, kwargs, _, needs, exact, against, limit = case
        fields_np, pars = state[0], state[1]
        N = len(fields_np["x"])
        sysm = Model(*eqs, device="cpu").system
        plan = (megastep.mixed_plan_for(N, sysm.nvar, sysm.halo, pars["periodic"])
                if kwargs.get("df64_mixed_solve") else None)
        torch.cuda.synchronize()
        _launch.reset_counters()
        start = time.perf_counter()
        u, attempts, count = run_df64(case, "cuda", "df64")
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = _launch.counts()
        want = exact(plan, count)
        off = {k: counts[k] for k, v in want.items() if counts[k] != v}
        missing = [k for k in needs if counts[k] <= 0]
        log(f"  {name}: mixed entry plan "
            + ("none (multi-launch)" if plan is None else f"C={plan.C} Mc={plan.Mc} "
               f"woodbury={plan.woodbury}")
            + f"; launches " + json.dumps({k: v for k, v in counts.items() if v})
            + f"; {secs:.3f} s wall (first call, launch included); attempts per output "
            f"step {attempts}")
        if off or missing:
            raise RuntimeError(f"{name}: launches {off} against {want}, not launched "
                               f"{missing}")
        for k in KERNELS:
            launches[k] += counts[k]
        if against == "f64":
            ref, ref_attempts, _ = run_df64(case, "cuda", True)
            what = "the card's double=True run"
        else:
            ref_u, ref_attempts, cpu_s = cpu_refs()[name]
            ref = torch.from_numpy(ref_u)
            what = f"the port's CPU df64 run ({cpu_s:.1f} s)"
        ref = ref.double().cpu()
        if not bool(torch.isfinite(u).all()) or u.shape != ref.shape:
            raise RuntimeError(f"{name}: non-finite or misshapen")
        err = float((u.double().cpu() - ref).abs().max() / ref.abs().max())
        log(f"    against {what}: max|du| / max|u| = {err:.3e} (limit {limit:.0e}); "
            f"attempts {ref_attempts}")
        if not err <= limit or (against == "cpu" and attempts != ref_attempts):
            raise RuntimeError(f"{name}: disagrees with {what}")
    log("  launches over phase 2 with the df64 mode: " + json.dumps(launches))
    return launches


#: bench.py:632 bench_df64_ensemble: B = 64 KS members at N = 10^5 in the
#: df64 mode, fixed RODASPR with one mixed residual pass, steps(10, 0.05),
#: bench.py's ensemble state (seed 1, 10 waves); members 0, 31 and 63 are
#: held to their single-grid df64 runs on the card
B_DF64, N_DF64, STEPS_DF64, DT_DF64 = 64, 10 ** 5, 10, 0.05
DF64_ENS = dict(scheme=schemes.RODASPR, time_stepping=False, tol=None, df64_mixed_solve=1)
DF64_ENS_MEMBERS = (0, 31, 63)
#: per_member_dt in the df64 mode: B = 4 KS members at N = 10^4, tol 1e-3,
#: one mixed pass, steps(2, 1.0) on the host route
B_DF64_PM, N_DF64_PM = 4, N_REF_SMALL
DF64_PM = dict(scheme=schemes.RODASPR, tol=1e-3, df64_mixed_solve=1, per_member_dt=True)
#: compensated=True: f32 RODASPR adaptive (tol 1e-3, 2 output steps of 1.0)
#: through device_steps, held to phase 2's CPU f64 runs of the cases: at KS
#: 2^13 the eager route (a compensated scheme's outer carry), one launch of
#: K6's adaptive entry with the carry per output step; at KS 10^6 the host
#: controller
COMPENSATED_CASES = [("ks N=2^13 rodaspr adaptive tol 1e-3 (2 x 1.0), no hook",
                      N_SMALL, "eager", {"K6.compensated": 2, "K6.adaptive": 0,
                                         "K6.adaptive_scan": 0,
                                         "K6.adaptive_snapshots": 0}),
                     ("ks N=10^6 rodaspr adaptive tol 1e-3 (2 x 1.0)", N_REF, "eager",
                      {"K6.compensated": 0, "K6.adaptive": 0, "K6.adaptive_scan": 0,
                       "K6.adaptive_snapshots": 0})]


def df64_ensemble(B, N, kwargs):
    """A df64 ensemble on the card of bench.py's state (seed 1, 10 waves)."""
    return make_ensemble(B, N, 1, 10, torch.float64, "cuda", kwargs, "df64")


def df64_ensemble_launches(plan, steps, stages=6, passes=1):
    """The launches of ``steps`` fixed df64 RODASPR steps of an ensemble on
    the host route with the mixed solve: per step J, the float32 factor (K2,
    K4, the Woodbury set-up), the final combination, and per stage F_terms,
    (1 + passes) float32 solves and ``passes`` K8 residuals."""
    solves = stages * (1 + passes) * steps
    return {"K1.J": steps, "K2.spike_factor": steps,
            kernel_checks.factor_entry(plan.s, plan.C): steps,
            kernel_checks.setup_entry(plan.s, plan.C, plan.B):
            steps if plan.woodbury else 0, "K1.F_terms": stages * steps,
            "K3.thomas_sweep": solves, "K4.pcr_solve_shift": solves,
            "K3.spike_correct": solves, "K5.combine": steps,
            "K8.residual": stages * passes * steps}


def counted(what, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after: (its result, the counts, the seconds it took)."""
    torch.cuda.synchronize()
    _launch.reset_counters()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _launch.counts(), time.perf_counter() - start


def phase2_precision(launches):
    """df64 ensembles and compensated=True through the port's entry points
    on the card, each case's launches counted exactly
    (``phase2_df64_ensembles``, ``phase2_compensated``)."""
    log("phase 2: df64 ensembles and compensated=True on the card")
    return phase2_compensated_routes(phase2_compensated(phase2_df64_ensembles(launches)))


def phase2_df64_ensembles(launches):
    """bench.py's df64 ensemble (B = 64 x KS N = 10^5, mixed=1, steps(10,
    0.05): the host route, K8 stages x passes x steps times) with members
    0, 31 and 63 against their single-grid df64 runs to 1e-12, and
    per_member_dt in the df64 mode (B = 4, KS 10^4) against its members'
    single-grid runs (equal attempts and clock)."""
    ens = df64_ensemble(B_DF64, N_DF64, DF64_ENS)
    plan = ens._scheme._plan(N_DF64, True, B_DF64)
    if ens.route != "host":
        raise RuntimeError(f"df64 ensemble: route {ens.route}, expected host")
    _, counts, secs = counted("df64 ensemble", lambda: ens.steps(STEPS_DF64, DT_DF64))
    want = {**dict.fromkeys(counts, 0), **df64_ensemble_launches(plan, STEPS_DF64)}
    log(f"  df64 ensemble B={B_DF64} x ks N={N_DF64} rodaspr mixed=1 "
        f"(steps({STEPS_DF64}, {DT_DF64})): route host, plan C={plan.C} Mc={plan.Mc} "
        f"woodbury={plan.woodbury}; launches "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f"; {secs:.3f} s wall (first call); t {ens.t!r}")
    if counts != want:
        raise RuntimeError(f"df64 ensemble: launches {counts}, expected {want}")
    for k in KERNELS:
        launches[k] += counts[k]
    u = ens.u
    if u.dtype != torch.float64 or not bool(torch.isfinite(u).all()):
        raise RuntimeError("df64 ensemble: not a finite float64 state")
    for b, (ub, _, t) in member_runs(B_DF64, N_DF64, 1, 10, torch.float64, DF64_ENS,
                                     [(STEPS_DF64, DT_DF64)], DF64_ENS_MEMBERS,
                                     "df64").items():
        err = float((u[b] - ub).abs().max())
        log(f"    member {b} against its single-grid df64 run on the card: max|du| = "
            f"{err:.3e} (limit 1e-12), max|u| {float(ub.abs().max()):.3f}; clock "
            f"{t!r}")
        if not err <= 1e-12 or t != ens.t:
            raise RuntimeError(f"df64 ensemble: member {b} off its single-grid run")
    del ens, u
    torch.cuda.empty_cache()
    # per_member_dt in the df64 mode
    pm = df64_ensemble(B_DF64_PM, N_DF64_PM, DF64_PM)
    calls = [(2, 1.0)]
    _, counts, secs = counted("df64 per member", lambda: drive(pm, calls))
    log(f"  df64 ensemble B={B_DF64_PM} x ks N={N_DF64_PM} rodaspr tol 1e-3 mixed=1 "
        f"per_member_dt (steps(2, 1.0)): route {pm.route}; member attempts "
        f"{pm.member_iters.tolist()}; launches "
        + json.dumps({k: v for k, v in counts.items() if v}) + f"; {secs:.3f} s wall")
    if pm.route != "host" or counts["K8.residual"] <= 0 or any(
            counts[k] for k in KERNELS if k.startswith("K6")):
        raise RuntimeError("df64 per-member ensemble: not the host route's mixed solve")
    for k in KERNELS:
        launches[k] += counts[k]
    members = member_runs(B_DF64_PM, N_DF64_PM, 1, 10, torch.float64, DF64_PM, calls,
                          double="df64")
    for b, (ub, att, t) in members.items():
        err = float((pm.u[b] - ub).abs().max() / ub.abs().max())
        log(f"    member {b} against its single-grid df64 run: max|du| / max|u| = "
            f"{err:.3e} (limit 1e-9); attempts {att} / {int(pm.member_iters[b])}; "
            f"clock {t!r} / {pm.t!r}")
        if not err <= 1e-9 or att != int(pm.member_iters[b]) or t != pm.t:
            raise RuntimeError(f"df64 per-member ensemble: member {b} off its run")
    del pm
    return launches


def phase2_compensated(launches):
    """compensated=True: f32 (and at KS 2^13 f64) RODASPR through
    device_steps on the eager route (KS 2^13: one launch of K6's adaptive
    entry with the carry per output step, counted as K6.compensated; KS
    10^6: the host controller, no K6), against phase 2's CPU f64 runs of
    the cases."""
    for name, N, route, exact in COMPENSATED_CASES:
        _, eqs, case, kwargs, tol32, tol64, *_ = next(c for c in CASES if c[0] == name)
        fields_np, pars, dt, tmax, _ = case
        steps = int(round(tmax / dt))
        ref_steps, ref_u, ref_attempts, _ = cpu_refs()[name]
        ref = torch.from_numpy(ref_u)
        for dt_name, dtype in DTYPES.items():
            if N == N_REF and dtype == torch.float64:
                continue
            model = Model(*eqs, double=dtype == torch.float64, device="cuda")
            fields, pars_t = state_from_numpy(fields_np, pars, model)
            sch = schemes.RODASPR(model, compensated=True, **kwargs)
            (t, snaps, status), counts, secs = counted(
                name, lambda: sch.device_steps(0.0, fields, steps, dt, pars_t))
            got = snaps[-1][1]["U"].double().cpu()
            err = float((got - ref).abs().max() / ref.abs().max())
            tol = tol64 if dtype == torch.float64 else tol32
            log(f"  compensated {name} {dt_name}: route {sch.steps_route} (expected "
                f"{route}), launches " + json.dumps({k: v for k, v in counts.items() if v})
                + f"; attempts {sch.steps_attempts} (CPU f64 {ref_attempts}); against "
                f"the CPU f64 run max|du| / max|u| = {err:.3e} (tolerance {tol:.0e}); "
                f"{secs:.3f} s wall")
            off = {k: counts[k] for k, v in exact.items() if counts[k] != v}
            if (sch.steps_route != route or status or off or not err <= tol
                    or (dtype == torch.float64 and sch.steps_attempts != ref_attempts)):
                raise RuntimeError(f"compensated {name} {dt_name}: route, launches {off}, "
                                   "status or result off")
            # the same run without the flag: each step's update u_new - u is
            # exact where the states lie within a factor of two (Sterbenz),
            # so the carry stays zero
            bare = schemes.RODASPR(model, **kwargs)
            _, bare_snaps, _ = bare.device_steps(0.0, fields, steps, dt, pars_t)
            bare_u = bare_snaps[-1][1]["U"].double().cpu()
            same = torch.equal(bare_snaps[-1][1]["U"], snaps[-1][1]["U"])
            log(f"    without compensated: {'bit for bit equal' if same else 'differs'} "
                f"(max|du| {float((bare_u - got).abs().max()):.3e}), attempts "
                f"{bare.steps_attempts}, against the CPU f64 run max|du| / max|u| = "
                f"{float((bare_u - ref).abs().max() / ref.abs().max()):.3e}")
            for k in KERNELS:
                launches[k] += counts[k]
    log("  launches over phase 2 with df64 ensembles and compensated: "
        + json.dumps(launches))
    return launches


def cpu_reference_runs(conn):
    """The port's CPU f64 runs (the plain versions) of phase 2's cases, of
    the ensemble cases that compare with one and of the df64 cases held to
    one, sent through ``conn``: run in a process of its own, started before
    phase 0, so that they overlap the card's work.  {case name: (steps, u,
    attempts, s)}, {ensemble case name: (u, t, attempts, member attempts,
    s)} and {df64 case name: (u, attempts, s)}, or ("error", traceback)."""
    try:
        torch.set_num_threads(4)
        out = {}
        for name, eqs, case, kwargs, *_ in CASES:
            start = time.perf_counter()
            steps, u, attempts = run_case(name, eqs, case, "cpu", torch.float64, kwargs)
            out[name] = (steps, u.numpy(), attempts, time.perf_counter() - start)
        for name, B, N, seed, waves, kwargs, calls, _, _, cpu in ENSEMBLE_CASES:
            if cpu:
                start = time.perf_counter()
                ens = drive(make_ensemble(B, N, seed, waves, torch.float64, "cpu", kwargs),
                            calls)
                out[name] = (ens.u.numpy(), ens.t, ens.attempts, ens.member_iters,
                             time.perf_counter() - start)
        for case in DF64_CASES:
            if case[7] == "cpu":
                start = time.perf_counter()
                u, attempts, _ = run_df64(case, "cpu", "df64")
                out[case[0]] = (u.numpy(), attempts, time.perf_counter() - start)
        for name, eqs, case, steps, *_ in MEGATHETA_CASES:
            start = time.perf_counter()
            _, u = megatheta_run(eqs, case, steps, "cpu", torch.float64, True)
            out[name] = (u.numpy(), time.perf_counter() - start)
        # numpy, not tensors: torch would share tensors through file
        # descriptors that close with this process
        conn.send(out)
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


_CPU = {}


def start_cpu_refs():
    """Start the CPU f64 runs, in five processes of their own: phase 2's
    cases (``cpu_reference_runs``), the falling film's (``film_cpu_runs``),
    the padded grids' (``padded_cpu_runs``), the explicit RK family's
    (``erk_cpu_runs``) and the sharded grids' (``spatial_cpu_runs``)."""
    ctx = multiprocessing.get_context("spawn")
    for key, target in (("main", cpu_reference_runs), ("film", film_cpu_runs),
                        ("padded", padded_cpu_runs), ("erk", erk_cpu_runs),
                        ("spatial", spatial_cpu_runs)):
        mine, theirs = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=target, args=(theirs,))
        proc.start()
        theirs.close()
        _CPU[key] = dict(conn=mine, proc=proc)


def cpu_refs(key="main"):
    """The CPU runs' results, waiting for them the first time."""
    slot = _CPU[key]
    if "refs" not in slot:
        start = time.perf_counter()
        refs = slot["conn"].recv()
        slot["proc"].join()
        if isinstance(refs, tuple):
            raise RuntimeError(f"the CPU reference runs ({key}) failed:\n{refs[1]}")
        slot["refs"] = refs
        log(f"  (waited {time.perf_counter() - start:.1f} s for the CPU f64 runs, {key})")
    return slot["refs"]


def stop_cpu_refs():
    for slot in _CPU.values():
        proc = slot["proc"]
        if proc.is_alive():
            proc.terminate()
            proc.join()


def member_runs(B, N, seed, waves, dtype, kwargs, calls, members=None, double=None):
    """Members (0 and B - 1 by default) of an ensemble case run alone on the
    card (the port's single-grid scheme; ``double`` overrides the model's
    mode): {member: (u, attempts, t)}."""
    x, u0 = ensemble_state(B, N, seed, waves)
    kw = {k: v for k, v in kwargs.items() if k not in ("scheme", "per_member_dt")}
    out = {}
    for b in (0, B - 1) if members is None else members:
        model = Model(*KS, double=dtype == torch.float64 if double is None else double,
                      device="cuda")
        fields, pars = state_from_numpy({"x": x, "U": u0[b]}, {"periodic": True}, model)
        scheme = kwargs["scheme"](model, **kw)
        t, attempts = 0.0, 0
        for n, dt in calls:
            for _ in range(n or 1):
                t, fields = scheme(t, fields, dt, pars)
                attempts += getattr(scheme, "_internal_iter", None) or 0
        out[b] = (fields["U"], attempts, t)
    return out


def _null(t, fields, pars):
    return fields, pars


#: a compensated ensemble on K6's route: B members of KS 2^13, RODASPR tol
#: 1e-3, steps(2, 1.0), shared and per-member dt
COMP_ENS_B, COMP_ENS_N, COMP_ENS_CALLS = kernel_checks.BATCH, N_SMALL, [(2, 1.0)]
#: the graph route with the carry: phase 2's fixed KS 10^6 case
COMP_GRAPH = "ks N=10^6 rodaspr fixed (4 x 0.05)"


def phase2_compensated_routes(launches):
    """compensated=True on K6's adaptive scan and on device_steps' graph
    route, each held bit for bit to the route a hook sends it to.  The
    ensemble (``COMP_ENS_*``, f32 and f64, shared and per-member dt) on
    the K6 route (one K6.compensated launch: the scan kernel's carry, each
    output step from zero) against the same ensemble with a hook on the
    host route (a K6 step-entry launch per attempt, the host controller,
    kahan_update); fixed f32 RODASPR at KS 10^6 (``COMP_GRAPH``) through
    the graph route (the carry captured) against the eager route (a hook),
    with and without the flag, the compensated run also against phase 2's
    CPU f64 run of the case."""
    for dt_name, dtype in DTYPES.items():
        for mode, extra in (("shared dt", {}), ("per-member dt", {"per_member_dt": True})):
            kwargs = dict(scheme=schemes.RODASPR, tol=1e-3, compensated=True, **extra)
            ens = make_ensemble(COMP_ENS_B, COMP_ENS_N, 2, 10, dtype, "cuda", kwargs)
            _, counts, secs = counted(mode, lambda: drive(ens, COMP_ENS_CALLS))
            host = make_ensemble(COMP_ENS_B, COMP_ENS_N, 2, 10, dtype, "cuda",
                                 {**kwargs, "hook": _null})
            drive(host, COMP_ENS_CALLS)
            k6 = {k: v for k, v in counts.items() if k.startswith("K6") and v}
            same = (torch.equal(ens.u, host.u) and ens.t == host.t
                    and np.array_equal(np.asarray(ens.attempts),
                                       np.asarray(host.attempts))
                    and np.array_equal(np.asarray(ens.member_iters),
                                       np.asarray(host.member_iters)))
            log(f"  compensated ensemble B={COMP_ENS_B} x ks N={COMP_ENS_N} rodaspr tol "
                f"1e-3 {mode} {dt_name} (steps(2, 1.0)): route {ens.route}, K6 launches "
                f"{json.dumps(k6)}; attempts {ens.attempts} / member "
                f"{np.asarray(ens.member_iters).tolist()}; against the hooked host route "
                f"({host.route}): {'bit for bit equal' if same else 'differs'}; "
                f"{secs:.3f} s wall")
            if (ens.route != "K6" or host.route != "host" or k6 != {"K6.compensated": 1}
                    or not same or not bool(torch.isfinite(ens.u).all())):
                raise RuntimeError(f"compensated ensemble {mode} {dt_name}: route, "
                                   "launches or result off the hooked host route")
            for k in KERNELS:
                launches[k] += counts[k]
            del ens, host
    _, eqs, case, kwargs, tol32, *_ = next(c for c in CASES if c[0] == COMP_GRAPH)
    fields_np, pars, dt, tmax, _ = case
    steps = int(round(tmax / dt))
    ref = torch.from_numpy(cpu_refs()[COMP_GRAPH][1])
    model = Model(*eqs, double=False, device="cuda")
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    finals = {}
    for comp in (True, False):
        sch = schemes.RODASPR(model, compensated=comp, **{
            k: v for k, v in kwargs.items() if k != "scheme"})
        (_, snaps, status), counts, secs = counted(
            COMP_GRAPH, lambda: sch.device_steps(0.0, fields, steps, dt, pars_t))
        route = sch.steps_route
        _, eager, status_e = sch.device_steps(0.0, fields, steps, dt, pars_t, hook=_null)
        same = len(eager) == len(snaps) == steps and all(
            torch.equal(a[1]["U"], b[1]["U"]) for a, b in zip(snaps, eager))
        got = snaps[-1][1]["U"]
        finals[comp] = got
        err = float((got.double().cpu() - ref).abs().max() / ref.abs().max())
        log(f"  {COMP_GRAPH} f32 compensated={comp}: route {route}, launches "
            + json.dumps({k: v for k, v in counts.items() if v})
            + f"; against the eager route (a hook, {sch.steps_route}): "
            f"{'bit for bit equal' if same else 'differs'}; against the CPU f64 run "
            f"max|du| / max|u| = {err:.3e} (tolerance {tol32:.0e}); {secs:.3f} s wall")
        if (route != "graph" or sch.steps_route != "eager" or status or status_e
                or not same or not err <= tol32
                or any(counts[k] for k in KERNELS if k.startswith("K6"))):
            raise RuntimeError(f"{COMP_GRAPH} compensated={comp}: route, launches or "
                               "result off the eager route")
        if comp:
            for k in KERNELS:
                launches[k] += counts[k]
    log(f"    compensated against bare on the graph route: "
        f"{'bit for bit equal' if torch.equal(finals[True], finals[False]) else 'differs'}"
        f" (max|du| {float((finals[True] - finals[False]).abs().max()):.3e}, "
        f"{int((finals[True] != finals[False]).sum())} nodes)")
    log("  launches over phase 2 with compensated routes: " + json.dumps(launches))
    return launches


def phase2_ensembles(launches):
    """The ensemble path: config 5 and the sweep through ``Ensemble`` on the
    card, each case's launch counts, members 0 and B - 1 against the
    single-grid runs, the sweep against the CPU f64 run."""
    log("phase 2: the ensemble path (parallel.Ensemble) on the card")
    for name, B, N, seed, waves, kwargs, calls, route, want, cpu in ENSEMBLE_CASES:
        ref = cpu_refs().get(name)
        if ref is not None:
            log(f"  {name}: CPU f64 run in {ref[4]:.1f} s; attempts {ref[2]}, member "
                f"attempts {None if ref[3] is None else ref[3].tolist()}")
        for dt_name, dtype in DTYPES.items():
            ens = make_ensemble(B, N, seed, waves, dtype, "cuda", kwargs)
            plan = (ens._scheme._plan(N, True, B) if route == "host"
                    else ens._scheme._mega_plan(N, True, B))
            if ens.route != route:
                raise RuntimeError(f"{name}: route {ens.route}, expected {route}")
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            drive(ens, calls)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            expected = {**dict.fromkeys(counts, 0), **want(plan)}
            log(f"  {name} {dt_name}: route {route}, plan C={plan.C} Mc={plan.Mc} "
                f"woodbury={plan.woodbury}; launches "
                + json.dumps({k: v for k, v in counts.items() if v})
                + f"; {secs:.3f} s wall (first call, launch included); attempts "
                f"{ens.attempts}, member attempts "
                f"{None if ens.member_iters is None else ens.member_iters.tolist()}")
            if counts != expected:
                raise RuntimeError(f"{name} {dt_name}: launches {counts}, expected "
                                   f"{expected}")
            for k in KERNELS:
                launches[k] += counts[k]
            u = ens.u
            if not bool(torch.isfinite(u).all()) or tuple(u.shape) != (B, 1, N):
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            adaptive = kwargs.get("tol") is not None
            tol = (1e-2 if adaptive else 1e-4) if dtype == torch.float32 else (
                1e-9 if adaptive else 1e-10)
            if kwargs is not SHARED:
                # alone, a member takes the same steps (fixed, or its own dt)
                for b, (ub, att, _) in member_runs(B, N, seed, waves, dtype, kwargs,
                                                   calls).items():
                    err = float((u[b].double() - ub.double()).abs().max()
                                / ub.double().abs().max())
                    same = ens.member_iters is None or int(ens.member_iters[b]) == att
                    log(f"    member {b} against its single-grid run: max|du| / max|u| "
                        f"= {err:.3e} (tolerance {tol:.0e}); attempts {att}")
                    if not err <= tol or (dtype == torch.float64 and not same):
                        raise RuntimeError(f"{name} {dt_name}: member {b} off its "
                                           "single-grid run")
            if ref is not None:
                u_ref, t_ref, att_ref, iters_ref, _ = ref
                u_ref = torch.from_numpy(u_ref)
                err = float((u.double().cpu() - u_ref).abs().max() / u_ref.abs().max())
                log(f"    against the CPU f64 run: max|du| / max|u| = {err:.3e} "
                    f"(tolerance {tol:.0e}), t {ens.t} / {t_ref}")
                same = (ens.attempts == att_ref and (
                    iters_ref is None or np.array_equal(ens.member_iters, iters_ref)))
                # the clock adds in the model's dtype
                t_off = not np.isclose(ens.t, t_ref, rtol=0 if dtype == torch.float64
                                       else 1e-6, atol=0)
                if not err <= tol or t_off or (dtype == torch.float64 and not same):
                    raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
            del ens
            torch.cuda.empty_cache()
    log("  launches over phase 2 with the ensembles: " + json.dumps(launches))
    return launches


def bound(nbytes, ops, dtype):
    """(bound ms, what bounds it): bytes over the memory rate against
    operations over the dtype's peak."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expr_ops(exprs):
    return sum(int(sp.count_ops(e)) for e in exprs)


def banded_csr(bands, periodic, scale):
    """``scale * A`` of one grid's bands (W, nvar, nvar, N) as a
    torch.sparse CSR matrix on the bands' device, rows and columns in the
    node layout: the library call's operand, built outside its timing."""
    W, nvar, _, N = bands.shape
    k, m, n, i = torch.meshgrid(*(torch.arange(d, device=bands.device)
                                  for d in (W, nvar, nvar, N)), indexing="ij")
    j = i + k - W // 2
    keep = torch.ones_like(j, dtype=torch.bool) if periodic else (j >= 0) & (j < N)
    idx = torch.stack([(m * N + i)[keep], (n * N + j % N)[keep]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the sparse layouts' beta notices
        coo = torch.sparse_coo_tensor(idx, scale * bands[keep], (nvar * N, nvar * N),
                                      check_invariants=False)
        return coo.coalesce().to_sparse_csr()


def solver_pairs(bands, gdt, plan, rhs):
    """(kernel entry -> (kernel call, plain call, bytes, operations, None),
    the solution) of K2-K4 on one grid's J bands, the factor of I - gdt J
    and the solve of ``rhs``, each entry on the inputs the chunked solve
    gives it; on a Woodbury plan also K4.pcr_solve (the set-up) and, timed
    beside the corrected solve, K4.pcr_solve_shift without the correction.
    Entries are named by the plan's block size
    (``kernel_checks.solver_entry``)."""
    W, nvar, _, N = bands.shape
    item = bands.element_size()
    s, C, Mc, nlev = plan.s, plan.C, plan.Mc, pcr.n_levels(plan.C)
    s2, M = 2 * s, plan.M

    def n(name):
        return kernel_checks.solver_entry(name, s)

    sp_ = thomas.spike_factor(bands, 1.0, -gdt, plan)
    red = pcr.pcr_factor(sp_.Lred, sp_.Ured, plan.cyclic)
    wood = pcr.woodbury(red, sp_.Lred, sp_.Ured) if plan.woodbury else ()
    y, yred = thomas.thomas_sweep(sp_, rhs, plan)
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    k = thomas.spike_correct(sp_, y, xm1, xp1, plan)
    blk = s * s * C
    red_bytes = (2 * nlev + 1) * s2 * s2 * C
    # the Woodbury correction reads Z's entries at the 2s shifted rows of
    # every chunk and the capacitance inverse
    wood_bytes = (s2 * s2 * C + s2 * s2) if plan.woodbury else 0
    pairs = {
        # rows: a block inverse and three block products per supernode row
        n("K2.spike_factor"): (lambda: thomas.spike_factor(bands, 1.0, -gdt, plan),
                               lambda: thomas.spike_factor_plain(bands, 1.0, -gdt, plan),
                               (W * nvar * nvar * N + 5 * Mc * blk
                                + 2 * s2 ** 2 * C) * item, 8 * s ** 3 * M, None),
        n("K3.thomas_sweep"): (lambda: thomas.thomas_sweep(sp_, rhs, plan),
                               lambda: thomas.thomas_sweep_plain(sp_, rhs, plan),
                               (3 * Mc * blk + 2 * nvar * N + 2 * s * C) * item,
                               6 * s * s * M, None),
        n("K4.pcr_factor"): (lambda: pcr.pcr_factor(sp_.Lred, sp_.Ured, plan.cyclic),
                             lambda: pcr.pcr_factor_plain(sp_.Lred, sp_.Ured, plan.cyclic),
                             (2 * s2 ** 2 * C + red_bytes) * item, 12 * s2 ** 3 * C * nlev,
                             None),
        n("K4.pcr_solve_shift"): (lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood),
                                  lambda: pcr.pcr_solve_shift_plain(red, yred, plan.wrap,
                                                                    *wood),
                                  (red_bytes + wood_bytes + 4 * s * C) * item,
                                  4 * s2 ** 2 * C * nlev + (4 * s * s2 * C if wood else 0),
                                  None),
        n("K3.spike_correct"): (lambda: thomas.spike_correct(sp_, y, xm1, xp1, plan),
                                lambda: thomas.spike_correct_plain(sp_, y, xm1, xp1, plan),
                                (2 * nvar * N + 2 * Mc * blk + 2 * s * C) * item,
                                4 * s * nvar * N, None),
    }
    if plan.woodbury:
        # the set-up: 2s columns through every level and Dinv, the
        # capacitance's Gauss-Jordan; reads the factor and two corner
        # blocks, writes Z and cap_inv
        pairs[n("K4.pcr_solve")] = (
            lambda: pcr.woodbury(red, sp_.Lred, sp_.Ured),
            lambda: pcr.woodbury_plain(red, sp_.Lred, sp_.Ured),
            (red_bytes + 2 * s2 * s + s2 * s2 * C + s2 * s2) * item,
            s2 * C * (4 * s2 * s2 * nlev + 2 * s2 * s2) + 2 * s2 ** 3, None)
        pairs[n("K4.pcr_solve_shift") + " without the correction"] = (
            lambda: pcr.pcr_solve_shift(red, yred, True),
            lambda: pcr.pcr_solve_shift_plain(red, yred, True),
            (red_bytes + 4 * s * C) * item, 4 * s2 ** 2 * C * nlev, None)
    return pairs, k


def ks_pairs(dtype, N=N_BIG):
    """Kernel entry -> (kernel call, plain call, bytes, operations, library
    call or None), on the inputs of the first fixed RODASPR step of KS at
    N (g00 dt = 0.0125); K2-K4 as ``solver_pairs`` gives them."""
    model, _, _, (u, helpers, pstack, x), dt = path_inputs(KS, ks_case(0.05, 0.2, N), dtype)
    b, sysm = model.backend, model.system
    item = torch.finfo(dtype).bits // 8
    rows, g00 = rodaspr_rows()
    gdt = g00 * dt
    plan = chunked.make_plan(N, 1, 2, True)
    W, nvar = plan.W, sysm.nvar
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
    rng = np.random.default_rng(2)
    bias = torch.tensor(rng.standard_normal((nvar, N)), dtype=dtype, device="cuda")
    bands = b.J_bands(u, helpers, pstack, x, periodic=True)
    rhs = b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias)
    solver, k = solver_pairs(bands, gdt, plan, rhs)
    csr = banded_csr(bands, True, gdt)
    arrays = [u] + [torch.tensor(rng.standard_normal((nvar, N)) * 1e-3, dtype=dtype,
                                 device="cuda") for _ in range(6)]
    A, R = len(arrays), len(rows)
    coefs = torch.tensor(rows, dtype=dtype, device="cuda")
    stacked = torch.stack(arrays).view(A, -1)
    pairs = {
        "K1.F": (lambda: b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias),
                 lambda: stencil.eval_F_plain(b, u, helpers, pstack, x, True, gdt, bias),
                 (n_in + 2 * nvar * N) * item,
                 (expr_ops(sysm.F_exprs) + 2 * nvar) * N, None),
        "K1.J": (lambda: b.J_bands(u, helpers, pstack, x, periodic=True),
                 lambda: b.J_bands_impl(u, helpers, pstack, x, periodic=True),
                 (n_in + W * nvar * nvar * N) * item,
                 expr_ops(sysm.J_band_exprs.values()) * N, None),
        **{name: pair for name, pair in solver.items() if name in KERNELS},
        "K5.combine": (lambda: combine.combine(rows, arrays),
                       lambda: combine.combine_plain(rows, arrays),
                       (A + R) * nvar * N * item, 2 * A * R * nvar * N,
                       lambda: torch.mm(coefs, stacked)),
        # the refinement's residual product on a stage's solution: reads the
        # bands and v once, writes one vector
        "K7.matvec": (lambda: matvec.banded_matvec(bands, k, True, gdt),
                      lambda: matvec.banded_matvec_plain(bands, k, True, gdt),
                      (W * nvar * nvar * N + 2 * nvar * N) * item,
                      (2 * W * nvar + 1) * nvar * N,
                      lambda: torch.mv(csr, k.view(-1))),
        **{name: pair for name, pair in solver.items() if name not in KERNELS},
    }
    return plan, pairs


def profile_step(scheme, fields, pars, dt, steps=5):
    """Device µs per step by kernel, busy and idle share of the device span,
    from torch.profiler over ``steps`` whole fixed steps; None when the
    profiler records no device time."""
    return profile_calls(lambda: scheme(0.0, fields, dt, pars), steps)


def profile_calls(fn, steps, names=TRACE_NAMES):
    """``profile_step`` of ``steps`` calls of ``fn`` (one step each);
    ``names`` maps device kernel names to entries."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name, busy, first, last = {}, 0.0, None, None
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        first = ev.time_range.start if first is None else min(first, ev.time_range.start)
        last = ev.time_range.end if last is None else max(last, ev.time_range.end)
        key = next((k for sub, k in names.items() if sub in ev.name), "other")
        by_name[key] = by_name.get(key, 0.0) + dur
        busy += dur
    if not busy:
        return None
    span = last - first
    return {"us_per_step": {k: v / steps for k, v in sorted(by_name.items())},
            "busy_us_per_step": busy / steps, "span_us_per_step": span / steps,
            "idle_share": 1.0 - busy / span}


def launch_us(fn, key, launches=20, tries=3, names=TRACE_NAMES, kernels=1):
    """(device µs per call, launches recorded) of the kernels of entry
    ``key`` (a ``TRACE_NAMES`` value; ``kernels`` of them a call) over
    ``launches`` calls of ``fn`` alone under torch.profiler; µs None where
    the profiler recorded another number of its launches in each of
    ``tries`` windows (it can drop a window's events, and an average over
    the launches left would read low)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        times = [ev.time_range.end - ev.time_range.start for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and next((k for sub, k in names.items() if sub in ev.name), None) == key]
        if len(times) == launches * kernels:
            return sum(times) / launches, launches
    return None, len(times)


def graph_us(fn, launches, replays=3):
    """Device µs per call of ``fn`` without the host's time: ``launches``
    calls captured in a CUDA graph (outputs from the graph's own pool),
    replayed ``replays`` times between CUDA events; the least replay."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) * 1e3 / launches
        best = us if best is None else min(best, us)
    del graph
    torch.cuda.empty_cache()
    return best


def log_launch_us(what, fn, key, launches=20, names=TRACE_NAMES):
    us, seen = launch_us(fn, key, launches, names=names)
    log(f"  {what}: " + (f"{us:.4f} device us per launch over {launches} launches"
                         if us is not None else
                         f"not measured (the profiler recorded {seen} of {launches} launches)"))


def log_profile(what, dt_name, prof):
    if prof is None:
        log(f"  profiler {what} {dt_name}: no device time recorded; breakdown "
            "not measured")
    else:
        log(f"  profiler {what} {dt_name}: " + json.dumps(prof))


def phase3():
    log("phase 3: timing at N = 2^20 and 10^6 (CUDA events)")
    times = {}
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        for N in (N_BIG, N_REF):
            grid = "N=2^20" if N == N_BIG else "N=10^6"
            # the Theta path (Burgers)
            model, fields, pars_t, _, dt = path_inputs(BURGERS, burgers_case(N), dtype)
            scheme = schemes.Theta(model, theta=1.0)
            step_ms = cuda_ms(lambda: scheme(0.0, fields, dt, pars_t), 20)
            log(f"  theta step burgers {grid} {dt_name}: {step_ms:.4f} ms/step, "
                f"{N / (step_ms * 1e-3):.4e} cell-updates/s")
            log_profile(f"theta step burgers {grid}", dt_name,
                        profile_step(scheme, fields, pars_t, dt))
            # the Rosenbrock path (KS): fixed step, adaptive attempts
            model, fields, pars_t, _, dt = path_inputs(KS, ks_case(0.05, 0.2, N), dtype)
            ros = schemes.RODASPR(model, time_stepping=False, tol=None)
            ros_ms = cuda_ms(lambda: ros(0.0, fields, dt, pars_t), 10)
            log(f"  rodaspr fixed step ks {grid} {dt_name}: {ros_ms:.4f} ms/step, "
                f"{N / (ros_ms * 1e-3):.4e} cell-updates/s")
            for rep in range(2):
                ada = schemes.RODASPR(model, tol=1e-3)
                t, f, attempts = 0.0, fields, []
                torch.cuda.synchronize()
                start = time.perf_counter()
                for _ in range(2):
                    t, f = ada(t, f, 1.0, pars_t)
                    attempts.append(ada._internal_iter)
                torch.cuda.synchronize()
                secs = time.perf_counter() - start
                log(f"  rodaspr adaptive ks {grid} {dt_name} (run {rep}): "
                    f"{secs * 1e3 / sum(attempts):.4f} ms per attempt, attempts per output "
                    f"step {attempts} (host clock, synchronised)")
            log_profile(f"rodaspr fixed step ks {grid}", dt_name,
                        profile_step(ros, fields, pars_t, dt))
            if N == N_REF:
                # refine=1: one residual (K7, K5) and one more solve per stage
                ros_r = schemes.RODASPR(model, time_stepping=False, tol=None, refine=1)
                r_ms = [cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 10)
                        for sch in (ros, ros_r, ros_r, ros)]
                log(f"  rodaspr fixed step ks {grid} {dt_name}, refine=0 / refine=1 / "
                    "refine=1 / refine=0: " + " / ".join(f"{m:.4f}" for m in r_ms)
                    + " ms/step (CUDA events)")
                log_profile(f"rodaspr fixed step refine=1 ks {grid}", dt_name,
                            profile_step(ros_r, fields, pars_t, dt))
            plan, pairs = ks_pairs(dtype, N)
            log(f"  kernels at ks {grid}: plan C={plan.C} Mc={plan.Mc} "
                f"woodbury={plan.woodbury}")
            for name, (kern, plain, nbytes, ops, library) in pairs.items():
                # plain, kernel, kernel, plain: drift in clocks shows as a spread
                p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
                lib_ms = min(cuda_ms(library, 5) for _ in range(2)) if library else None
                b_ms, b_by = bound(nbytes, ops, dtype)
                if N == N_BIG and name != "K7.matvec" or N == N_REF and name in (
                        "K4.pcr_solve", "K7.matvec"):
                    times[dt_name][name] = (min(k1, k2), min(p1, p2), b_ms, b_by, lib_ms)
                if name in ("K1.J", "K7.matvec"):
                    # a second reading of the host call beside the kernels
                    # line's 5 calls: 200 back to back, the lower of two
                    long_ms = min(cuda_ms(kern, 200) for _ in range(2))
                    log(f"  {name} {grid} {dt_name}: kernel {long_ms:.4f} ms "
                        "(200 calls back to back)")
                log(f"  {name} {grid} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                    f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, "
                    f"{ops} operations)"
                    + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
                if name == "K7.matvec" or N == N_BIG and name in ("K5.combine",
                                                                   "K3.thomas_sweep"):
                    # back-to-back launches of a kernel this short time the
                    # wrapper's host work; the profiler gives the device's
                    log_launch_us(f"{name} alone {grid} {dt_name}", kern, name)
    return times


#: chunk counts of config 5's sweep (divisors of its M = 50000 supernodes)
BATCH_CHUNKS = [10, 25, 50, 100, 125, 200, 250, 400, 500, 625, 1000, 1250, 2500]
#: the other shapes of the batch chunk sweep, all through K1-K5: (B, KS N,
#: chunk counts, fixed steps per timed call); B = 64 at N = 2^13 is the
#: largest grid K6 takes at s = 2, here with K6 withheld
BATCH_SHAPES = [(64, 1 << 13, [2 ** k for k in range(1, 12)], 5),
                (4, N_ENS, BATCH_CHUNKS, 3)]


def fit_batch_cost(points):
    """Least-squares fit, relative weights, of us = a * rows walked + b *
    levels walked + c * doublings (``chunked.batch_features``) plus one
    intercept per (dtype, shape) over {(dtype, B, N): [(C, us), ...]}
    (KS, M = N / 2 supernodes); returns (a, b, c, {key: relative residual
    of each point})."""
    keys = sorted(points)
    rows, ys = [], []
    for k, (_, B, N) in enumerate(keys):
        for C, us in points[keys[k]]:
            rows.append([*chunked.batch_features(N // 2, C, B)]
                        + [float(k == j) for j in range(len(keys))])
            ys.append(us)
    A, y = np.array(rows), np.array(ys)
    fit = np.linalg.lstsq(A / y[:, None], np.ones_like(y), rcond=None)[0]
    resid = list(np.abs(A @ fit - y) / y)
    out, at = {}, 0
    for key in keys:
        out[key] = resid[at:at + len(points[key])]
        at += len(points[key])
    return fit[0], fit[1], fit[2], out


def minimax_batch_cost(points):
    """(a, b, c, worst): the constants of ``chunked.batch_plan_cost_us``
    (us per row walked, per level walked, per doubling) on a grid (a in
    0.5..6, b in 0..200, c in 0..3000) whose worst float64 pick over the
    shapes of {(dtype, B, N): [(C, us), ...]} is nearest the fastest
    measured plan, and that worst gap (a share)."""
    grid = np.stack(np.meshgrid(np.linspace(0.5, 6, 23), np.linspace(0, 200, 41),
                                np.linspace(0, 3000, 61), indexing="ij"), -1).reshape(-1, 3)
    worst = np.zeros(len(grid))
    for (dt_name, B, N), pts in points.items():
        if dt_name != "float64":
            continue
        Cs, us = zip(*pts)
        feats = np.array([chunked.batch_features(N // 2, C, B) for C in Cs])
        picks = np.argmin(grid @ feats.T, axis=1)
        worst = np.maximum(worst, np.array(us)[picks] / min(us) - 1)
    at = int(np.argmin(worst))
    return (*grid[at], worst[at])


def nnls_fit(features, ms):
    """Non-negative least squares, relative weights, of the measured ms
    (in us) over the rows of ``features``."""
    from scipy.optimize import nnls

    A = np.array(features, dtype=float)
    y = 1e3 * np.array(ms)
    return nnls(A / y[:, None], np.ones_like(y))[0]


def chunk_sweep(ens, B, N, chunks, steps):
    """[(C, us per fixed step)] of an ensemble on the K1-K5 route under
    each chunk plan (CUDA events over ``steps(steps)``)."""
    key = (N, True, B)
    plan = ens._scheme._plan(N, True, B)
    out = []
    for C in sorted(set(chunks) | {plan.C}):
        ens._scheme._plans[key] = chunked.plan_with(N, 1, 2, True, C, B)
        out.append((C, 1e3 * cuda_ms(lambda: ens.steps(steps, 0.05), 1) / steps))
    ens._scheme._plans[key] = plan
    return out


def phase3_ensembles(errs):
    """The ensemble path: config 5's step rate and its breakdown, every
    kernel of its multi-launch step against its plain version at config
    5's shapes (their errors join ``errs``), the sweep's steps(100),
    K6.adaptive_scan against its plain version, the batch chunk-count
    sweeps and their cost fit, and K6's crossover at B = 64."""
    log("phase 3: the ensemble path")
    times, chunk_points = {}, {}
    ros = schemes.RODASPR(Model(*KS, device="cpu"), time_stepping=False, tol=None)
    g00 = float(ros._gamma[0, 0])
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        T = np.float64 if dtype == torch.float64 else np.float32
        item = torch.finfo(dtype).bits // 8
        ens = make_ensemble(B_ENS, N_ENS, 1, 10, dtype, "cuda", FIXED)
        plan = ens._scheme._plan(N_ENS, True, B_ENS)
        ens.steps(1, 0.05)
        for rep in range(2):
            ms = cuda_ms(lambda: ens.steps(3, 0.05), 1) / 3
            log(f"  config 5 (B={B_ENS} x ks N={N_ENS}, C={plan.C} Mc={plan.Mc}) fixed "
                f"rodaspr {dt_name} (run {rep}): {ms:.4f} ms per step, "
                f"{B_ENS * N_ENS / (ms * 1e-3):.4e} aggregate cell-updates/s (CUDA events "
                "over steps(3, 0.05))")
        log(f"  peak device memory config 5 {dt_name}: "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        log_profile("config 5 fixed rodaspr step", dt_name,
                    profile_calls(lambda: ens.steps(1, 0.05), 2))
        # K1.F_terms against the combination and the biased F: RODASPR's
        # last stage (six terms) at config 5's shapes
        b = ens.model.backend
        rng = np.random.default_rng(4)
        stages = [ens.u] + [torch.tensor(1e-3 * rng.standard_normal((B_ENS, 1, N_ENS)),
                                         dtype=dtype, device="cuda") for _ in range(5)]
        a_row = [1.0] + [float(ros._a_t[5, j]) for j in range(5)]
        c_row = [0.0] + [float(g00 * ros._c_t[5, j]) for j in range(5)]
        terms = list(zip(a_row, c_row, stages))
        gdt = float(T(g00) * T(0.05))
        args = (ens.helpers, ens.pstack, ens.x)
        kern = lambda: b.F_terms(terms, *args, periodic=True, scale=gdt)
        plain = lambda: stencil.eval_F_terms_plain(b, terms, *args, True, gdt)

        def pair():
            u_i, csum = combine.combine([a_row, c_row], stages)
            return b.F(u_i, *args, periodic=True, scale=gdt, bias=csum)

        got, want = kern(), plain()
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel <= kernel_checks.TOL[dtype]["FJ"]:
            raise RuntimeError(f"K1.F_terms config 5 {dt_name}: relative error {rel:.3e}")
        errs[dt_name]["K1.F_terms"] = max(errs[dt_name]["K1.F_terms"],
                                          float((got - want).abs().max()))
        p1, k1, c1, c2, k2, p2 = (cuda_ms(f, 3) for f in (plain, kern, pair, pair, kern,
                                                         plain))
        A, n = len(terms), B_ENS * N_ENS
        sysm = b.system
        nbytes = (A + 1) * n * item + N_ENS * item
        # per node: the combination at every stencil point, F, the scale
        # and the bias terms
        ops = (2 * A * b.window + expr_ops(sysm.F_exprs) + 1
               + 2 * sum(1 for c in c_row if c)) * n
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name]["K1.F_terms"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K1.F_terms config 5 (6 terms) {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, "
            f"combination + biased F (K5 + K1.F) {c1:.4f}/{c2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, {ops} "
            f"operations), kernel against plain {rel:.3e} relative")
        # K3's sweep with the member axis (the batched chunked_solve_sweeps)
        # on config 5's factor and the right-hand side above (held against
        # its plain version below)
        bands = b.J_bands(ens.u, *args, periodic=True)
        sp_ = thomas.spike_factor(bands, 1.0, -gdt, plan)
        kern = lambda: thomas.thomas_sweep(sp_, got, plan)
        plain = lambda: thomas.thomas_sweep_plain(sp_, got, plan)
        p1, k1, k2, p2 = (cuda_ms(f, 1) for f in (plain, kern, kern, plain))
        blk, s_ = plan.s ** 2 * plan.C * B_ENS, plan.s
        nbytes = (3 * plan.Mc * blk + 2 * n + 2 * 2 * s_ * plan.C * B_ENS) * item
        b_ms, b_by = bound(nbytes, 6 * s_ * s_ * (N_ENS // 2) * B_ENS, dtype)
        log(f"  K3.thomas_sweep config 5 (member axis, C={plan.C} Mc={plan.Mc}) {dt_name}: "
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} bytes)")
        # K1.J and every solver piece (K2, K4's factor, Woodbury set-up,
        # R-column solve and per-stage solve, K3's sweep and correction) on
        # config 5's state, factor shift and right-hand side against its
        # plain version; a miss raises
        del sp_
        start = time.perf_counter()
        res = kernel_checks.check_J(b, ens.u, *args, True, f"config 5 {dt_name}")
        kernel_checks.check_solver_pieces(bands, -gdt, plan, got, ens.u, seed=5,
                                          results=res)
        for name, err in res.items():
            errs[dt_name][name] = max(errs[dt_name].get(name, 0.0), err)
        log(f"  config 5's shapes (B={B_ENS}, C={plan.C}, Mc={plan.Mc}, woodbury="
            f"{plan.woodbury}) {dt_name}, kernels against plain versions (max abs error, "
            f"{time.perf_counter() - start:.1f} s): " + json.dumps(res))
        del stages, terms, got, want, bands, res
        # the batch chunk-count sweeps: config 5, then the other shapes
        pts = chunk_points[(dt_name, B_ENS, N_ENS)] = chunk_sweep(
            ens, B_ENS, N_ENS, BATCH_CHUNKS, 1)
        log(f"  config 5 step by chunk count {dt_name} (ms per step, CUDA events): "
            + ", ".join(f"C={C}: {us / 1e3:.2f}" for C, us in pts))
        del ens
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for B, N, chunks, steps in BATCH_SHAPES:
            ens = make_ensemble(B, N, 1, 10, dtype, "cuda", FIXED)
            ens._scheme._mega_plans[(N, True, B)] = None
            ens.steps(1, 0.05)
            pts = chunk_points[(dt_name, B, N)] = chunk_sweep(ens, B, N, chunks, steps)
            log(f"  ks B={B} N={N} (K1-K5) step by chunk count {dt_name} (ms per step, "
                f"CUDA events over steps({steps})): "
                + ", ".join(f"C={C}: {us / 1e3:.4f}" for C, us in pts))
            log_profile(f"ks B={B} N={N} (K1-K5, make_plan's C) fixed rodaspr step",
                        dt_name, profile_calls(lambda: ens.steps(1, 0.05), steps))
            del ens
        # the sweep: steps(100) fixed, one K6 launch
        sw = make_ensemble(B_SWEEP, N_SWEEP, 2, 5, dtype, "cuda", FIXED)
        ms = [cuda_ms(lambda: sw.steps(100, 0.05), 1) for _ in range(2)]
        _launch.reset_counters()
        sw.steps(100, 0.05)
        count = _launch.counts()["K6.step"]
        log(f"  sweep (B={B_SWEEP} x ks N={N_SWEEP}) steps(100, 0.05) {dt_name}: "
            + " / ".join(f"{m:.4f}" for m in ms) + f" ms per call ({count} K6 launch), "
            f"{B_SWEEP * N_SWEEP * 100 / (min(ms) * 1e-3):.4e} aggregate cell-updates/s "
            "(CUDA events)")
        # K6.adaptive_scan against its plain version: steps(4, 0.1), a shared dt
        ad = make_ensemble(B_SWEEP, N_SWEEP, 2, 5, dtype, "cuda", SHARED)
        kplan = ad._scheme._mega_plan(N_SWEEP, True, B_SWEEP)
        table = ad._scheme._table(True)
        s_args = (adaptive_controller, ad.model.backend, kplan, table, True, ad.u,
                  ad.helpers, ad.pstack, ad.x, 0.0, 0.1, 1e-6, 1e-3, 0.9, None, None, 4)
        out = megastep.adaptive_scan(*s_args, attempts=True)
        attempts = out[4]
        cl = megastep.cluster_plan(kplan, len(table.stages), dtype, B_SWEEP)
        kind = megastep.SHARED_KIND
        p1, k1, k2, p2 = (cuda_ms(lambda: fn(*s_args), 1) for fn in (
            megastep.adaptive_scan_plain, megastep.adaptive_scan, megastep.adaptive_scan,
            megastep.adaptive_scan_plain))
        nbytes, ops = k6_work(ad.model, kplan, table, dtype, attempts)
        b_ms, b_by = bound(B_SWEEP * nbytes, B_SWEEP * ops, dtype)
        times[dt_name]["K6.adaptive_scan"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K6.adaptive_scan sweep steps(4, 0.1) shared dt ({attempts} attempts) "
            f"{dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), plan C={kplan.C} Mc={kplan.Mc}, "
            f"{min(B_SWEEP, megastep.capacity(ad.model.backend, dtype, kind, cl))}"
            f" clusters of K={cl.K}")
        pm = make_ensemble(B_SWEEP, N_SWEEP, 2, 5, dtype, "cuda", PER_MEMBER)
        ms = [cuda_ms(lambda: pm.steps(4, 0.1), 1) for _ in range(2)]
        log(f"  sweep steps(4, 0.1) per-member dt {dt_name}: " + " / ".join(
            f"{m:.4f}" for m in ms) + f" ms per call, member attempts "
            f"{pm.member_iters.min()}..{pm.member_iters.max()}")
        # K6 against K1-K5 at B = 64: fixed steps(10, 0.05)
        for e in range(8, 14):
            N = 1 << e
            k6 = make_ensemble(B_SWEEP, N, 2, 5, dtype, "cuda", FIXED)
            multi = make_ensemble(B_SWEEP, N, 2, 5, dtype, "cuda", FIXED)
            multi._scheme._mega_plans[(N, True, B_SWEEP)] = None
            m1, k1, k2, m2 = (cuda_ms(lambda: ens_.steps(10, 0.05), 1) / 10
                              for ens_ in (multi, k6, k6, multi))
            log(f"  ks B={B_SWEEP} N=2^{e} rodaspr fixed step {dt_name}: K6 {k1:.4f}/"
                f"{k2:.4f} ms, multi-launch {m1:.4f}/{m2:.4f} ms (CUDA events over "
                f"steps(10)); K6 {'faster' if min(k1, k2) < min(m1, m2) else 'slower'} "
                f"(the gate admits N <= {megastep.MAX_N[2]})")
    # batch_plan_cost_us is fitted to config 5; the other shapes check the
    # plans it picks there, and a fit over every shape shows what pooling
    # them would pick
    fits = {"config 5": {k: v for k, v in chunk_points.items() if k[1] == B_ENS},
            "every shape": chunk_points}
    for what, pts_ in fits.items():
        a, bb, c, resid = fit_batch_cost(pts_)
        every = [r for rs in resid.values() for r in rs]
        picks = []
        for (dt_name, B, N), pts in chunk_points.items():
            meas = dict(pts)
            feats = {C: chunked.batch_features(N // 2, C, B) for C in meas}
            pick = min(meas, key=lambda C: a * feats[C][0] + bb * feats[C][1]
                       + c * feats[C][2])
            picks.append(f"B={B} {dt_name} C={pick}")
        log(f"  batch cost fit ({what}, f64 and f32 pooled): {a:.4f} us per row walked, "
            f"{bb:.4f} us per level walked, {c:.4f} us per doubling of C; relative "
            f"residuals max {max(every):.4f} rms {np.sqrt(np.mean(np.square(every))):.4f}; "
            f"it picks " + ", ".join(picks))
    a, bb, c, worst = minimax_batch_cost(chunk_points)
    log(f"  batch cost grid (float64, every shape): {a:.3f} us per row walked, {bb:.3f} us "
        f"per level walked, {c:.3f} us per doubling of C; its worst float64 pick "
        f"{100 * worst:.2f} % above the fastest")
    log(f"  batch_plan_cost_us has {chunked.BATCH_ROW_US}, {chunked.BATCH_LEVEL_US} and "
        f"{chunked.BATCH_SPLIT_US}:")
    for (dt_name, B, N), pts in chunk_points.items():
        meas = dict(pts)
        plan_c = chunked.make_plan(N, 1, 2, True, B).C
        best = min(meas, key=meas.get)
        log(f"    B={B} N={N} {dt_name}: make_plan's C={plan_c} ("
            + (f"{meas[plan_c]:.1f} us, {100 * (meas[plan_c] / meas[best] - 1):.1f} % above "
               "the best" if plan_c in meas else "not measured")
            + f"), measured best C={best} ({meas[best]:.1f} us)")
    return times


def latency_ms(step, n=51):
    """(median, p10, p90) ms of one synchronised call of step(), host clock,
    after one warm-up call."""
    lat = []
    for _ in range(n):
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - start)
    lat = sorted(lat[1:])
    k = len(lat)
    return lat[k // 2] * 1e3, lat[k // 10] * 1e3, lat[(9 * k) // 10] * 1e3


def multi_launch(scheme, N, periodic):
    """The scheme with K6's plan withheld for the grid: the K1-K5 path."""
    scheme._mega_plans[(N, periodic)] = None
    return scheme


def step_scalars(table, dt, T):
    """(factor shift, F scale) of one step of ``dt`` with ``table``, in
    the model's dtype ``T``: -g00 dt and g00 dt for a ROW table, -theta dt
    and dt for the theta table."""
    if len(table.stages) == 1:
        return -table.g00 * float(T(dt)), float(T(dt))
    gdt = float(T(table.g00) * T(dt))
    return -gdt, gdt


def k6_work(model, plan, table, dtype, attempts=1):
    """(bytes, operations) of K6 on these inputs: each input read once and
    the state written once; per attempt the operations of J, the factor,
    the PCR factor, and per stage the combinations its table row really
    makes (none where the stage's input is u, a bias only where the row
    has one), F, the sweep, the reduced solve and the correction, then the
    final rows over their columns and err's max."""
    sysm = model.system
    N, nvar, s, C, M = plan.N, sysm.nvar, plan.s, plan.C, plan.M
    s2, nlev, n = 2 * s, pcr.n_levels(plan.C), nvar * plan.N
    item = torch.finfo(dtype).bits // 8
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
    f_ops = expr_ops(sysm.F_exprs) * N
    solve = 6 * s * s * M + 4 * s2 * s2 * C * nlev + 4 * s * n
    per_step = (expr_ops(sysm.J_band_exprs.values()) * N + 8 * s ** 3 * M
                + 12 * s2 ** 3 * C * nlev)
    for a_row, c_row in table.stages:
        combos = 0 if megastep._is_u(a_row) else 2 * len(a_row) * n
        if c_row is not None:
            combos += 2 * len(c_row) * n
        per_step += combos + f_ops + (1 + (c_row is not None)) * n + solve
    per_step += sum(2 * len(row) * n for row in table.final)
    per_step += 2 * n * (len(table.final) - 1)
    return (n_in + n) * item + 32, attempts * per_step


#: the constants of megastep.cluster_cost_us by block size, in the
#: order of ``cluster_features``' columns
COST_KEYS = ("ROW_US", "L2_ROW_US", "LEVEL_US", "L2_LEVEL_US", "NODE_US", "L2_NODE_US")


def cluster_features(s_blk, g, M, C, K, rows_l2, levels_l2, nodes_l2, n_stages=6):
    """The terms of megastep.cluster_cost_us, one column per constant:
    COST_KEYS by block size s = 1, 2, 4, then SYNC_US."""
    Cc = -(-C // K)
    Mc = -(-M // C)
    nlev = pcr.n_levels(C)
    walks = n_stages + 1
    n = len(COST_KEYS)
    col = n * {1: 0, 2: 1, 4: 2}[s_blk]
    f = [0.0] * (3 * n + 1)
    f[col + (1 if rows_l2 else 0)] = walks * Mc * -(-Cc // megastep.THREADS)
    f[col + (3 if levels_l2 else 2)] = walks * nlev
    f[col + (5 if nodes_l2 else 4)] = walks * -(-(Cc * Mc * g) // megastep.THREADS)
    f[3 * n] = walks * (nlev + 3) * (K > 1)
    return f


def fit_cluster_cost(points):
    """Non-negative fit of megastep.cluster_cost_us's constants to the
    layout sweeps' points [(label, s, g, M, C, K, rows in L2, levels in
    L2, node vectors in L2, us)]: ({s: constants of COST_KEYS}, SYNC_US,
    relative residual of each point)."""
    feats = [cluster_features(*p[1:9]) for p in points]
    us = [p[-1] for p in points]
    coef = nnls_fit(feats, [u / 1e3 for u in us])
    model = np.array(feats) @ coef
    resid = list(np.abs(model - np.array(us)) / np.array(us))
    n = len(COST_KEYS)
    return ({sb: tuple(coef[n * i:n * i + n]) for i, sb in enumerate((1, 2, 4))},
            coef[3 * n], resid)


def cluster_sweep(dtype, dt_name):
    """The layout sweeps (CLUSTER_SWEEPS) in one dtype: us per fixed
    RODASPR step (CUDA events, 20 steps a launch) of every chunk count and
    cluster size; returns the points and, per grid, the plan's pick."""
    T = np.float64 if dtype == torch.float64 else np.float32
    tb = kernel_checks.rodaspr_table(False)
    points, picks = [], {}
    for label, eqs, case, periodic in CLUSTER_SWEEPS:
        model, _, _, cargs, cdt = path_inputs(eqs, case, dtype)
        sysm = model.system
        N = cargs[-1].shape[-1]
        g = max(sysm.halo, 1)
        s_blk, M = sysm.nvar * g, N // g
        beta, scale = step_scalars(tb, cdt, T)
        row = []
        for C in chunked.chunk_counts(N, sysm.halo, periodic):
            if C > CLUSTER_SWEEP_MAX_C or M // C > CLUSTER_SWEEP_MAX_MC:
                continue
            cp_ = chunked.plan_with(N, sysm.nvar, sysm.halo, periodic, C)
            for K in megastep.CLUSTER_SIZES:
                try:
                    cl = megastep.cluster_plan(cp_, 6, dtype, K=K)
                except ValueError:
                    continue
                us = 1e3 / 20 * min(cuda_ms(lambda: megastep.step(
                    model.backend, cp_, tb, periodic, *cargs, beta, scale, 20, cluster=cl), 2)
                    for _ in range(2))
                in_l2 = {b for b in megastep.BUFFERS if cl.home(b) == "L2"}
                points.append((label, s_blk, g, M, C, K, bool(in_l2 & megastep.ROW_BUFFERS),
                               bool(in_l2 & megastep.LEVEL_BUFFERS),
                               bool(in_l2 & megastep.NODE_BUFFERS), us))
                row.append(f"C={C} K={K}{' L2 ' + '/'.join(sorted(in_l2)) if in_l2 else ''}"
                           f": {us:.2f}")
        plan = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)
        picks[label] = (plan.C, megastep.cluster_plan(plan, 6, dtype).K)
        log(f"  K6 layout sweep {label} {dt_name} (us per rodaspr step, 20 steps a launch, "
            "CUDA events): " + ", ".join(row))
    return points, picks


def report_cluster_fit(points, picks, dt_name):
    """The fit of the layout sweeps and, per grid, the model's pick
    against the fastest measured layout."""
    per_s, sync, resid = fit_cluster_cost(points)
    log(f"  K6 cluster cost fit {dt_name}: "
        + "; ".join(f"s={sb}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(COST_KEYS, c))
                    for sb, c in per_s.items())
        + f"; SYNC_US {sync:.4f}; relative residuals max "
        f"{max(resid):.3f} rms {np.sqrt(np.mean(np.square(resid))):.3f}; megastep has "
        + ", ".join(f"{k} {getattr(megastep, k)}" for k in COST_KEYS)
        + f", SYNC_US {megastep.SYNC_US}")
    for label, (C, K) in picks.items():
        meas = {(p[4], p[5]): p[-1] for p in points if p[0] == label}
        best = min(meas, key=meas.get)
        got = meas.get((C, K))
        log(f"    {label} {dt_name}: the plan's C={C} K={K} "
            + (f"{got:.2f} us ({got / meas[best]:.3f} of the fastest)" if got is not None
               else "not measured")
            + f", the fastest C={best[0]} K={best[1]} {meas[best]:.2f} us")


def crossover_sweep(dtype, dt_name, sweep):
    """The crossover behind megastep.MAX_N: fixed steps of K6 (the plan
    forced past the gate, where a cluster holds it) against the
    multi-launch path, for each block size and scheme at N = 2^10 ..
    2^16; adds each pairing's win to ``sweep[(s, scheme)][N]``."""
    for label, eqs, make_case, s_blk in SWEEP_MODELS:
        for sch_name, make in SWEEP_SCHEMES.items():
            model = Model(*eqs, double=dtype == torch.float64, device="cuda")
            sysm = model.system
            for e in SWEEP_EXPONENTS:
                N = 1 << e
                fields_np, pars, dt, _, _ = make_case(N)
                fields, pars_t = state_from_numpy(fields_np, pars, model)
                k6 = make(model)
                plan = megastep.make_plan(N, sysm.nvar, sysm.halo, True)
                if not megastep.fits(plan):
                    # no cluster holds the grid: K1-K5 serve it
                    sweep.setdefault((s_blk, sch_name), {}).setdefault(N, []).append(False)
                    log(f"  {label} (s={s_blk}) N=2^{e} {sch_name} {dt_name}: no cluster "
                        f"holds the plan C={plan.C} (megastep.fits)")
                    continue
                k6._mega_plans[(N, True)] = plan
                multi = multi_launch(make(model), N, True)
                m1, k1, k2, m2 = (cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 10)
                                  for sch in (multi, k6, k6, multi))
                sweep.setdefault((s_blk, sch_name), {}).setdefault(N, []).append(
                    min(k1, k2) < min(m1, m2))
                log(f"  {label} (s={s_blk}) N=2^{e} {sch_name} fixed step {dt_name}: "
                    f"K6 {k1:.4f}/{k2:.4f} ms, multi-launch {m1:.4f}/{m2:.4f} ms "
                    f"(CUDA events over 10 steps; C={plan.C}, K="
                    f"{megastep.cluster_plan(plan, 6, dtype).K})")


def phase3_small():
    """The small grids: K6 against the multi-launch path, the gate and the
    cost model, K6's entries against their plain versions."""
    log("phase 3: small grids (K6)")
    times, sweep = {}, {}
    ros_table = kernel_checks.rodaspr_table(False)
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        fields_np, pars, rdt, _, hook = readme_case()
        rf, rp = state_from_numpy(fields_np, pars, rm)
        makers = (("theta", lambda: schemes.Theta(rm, theta=1.0)),
                  ("rodaspr fixed",
                   lambda: schemes.RODASPR(rm, time_stepping=False, tol=None)))
        for label, make in makers:
            k6, multi = make(), multi_launch(make(), 200, False)
            res = {}
            for route, sch in (("K6", k6), ("multi-launch", multi), ("multi-launch", multi),
                               ("K6", k6)):
                res.setdefault(route, []).append(
                    latency_ms(lambda: sch(0.0, rf, rdt, rp, hook=hook)))
            for route, runs in res.items():
                log(f"  readme N=200 {label} step {dt_name} {route}: median "
                    + " / ".join(f"{m:.4f}" for m, _, _ in runs) + " ms (p10 "
                    + " / ".join(f"{a:.4f}" for _, a, _ in runs) + ", p90 "
                    + " / ".join(f"{b:.4f}" for _, _, b in runs)
                    + "), host clock per synchronised step, two runs")
            # nsteps = 100 fixed steps in one launch
            u, helpers, x = rm.backend.split_fields(rf)
            pstack = rm.backend.pack_pars(rp, x)
            scan = k6.device_fixed_scan(200, periodic=False)
            ms = cuda_ms(lambda: scan(0.0, u, helpers, pstack, x, rdt, 100), 5)
            log(f"  readme N=200 {label} device_fixed_scan {dt_name}: "
                f"{ms * 10:.4f} us per step at nsteps = 100 (CUDA events)")
        log_profile("readme N=200 rodaspr fixed K6 step", dt_name,
                    profile_step(schemes.RODASPR(rm, time_stepping=False, tol=None),
                                 rf, rp, rdt))
        # K6.step against its plain version at the README RODASPR step
        plan = megastep.plan_for(200, 1, 1, False)
        u, helpers, x = rm.backend.split_fields(rf)
        args = (u, helpers, rm.backend.pack_pars(rp, x), x)
        T = np.float64 if dtype == torch.float64 else np.float32
        gdt = float(T(ros_table.g00) * T(rdt))
        k_fn = lambda: megastep.step(rm.backend, plan, ros_table, False, *args, -gdt, gdt)
        p_fn = lambda: megastep.step_plain(rm.backend, plan, ros_table, False, *args,
                                           -gdt, gdt)
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (p_fn, k_fn, k_fn, p_fn))
        nbytes, ops = k6_work(rm, plan, ros_table, dtype)
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name]["K6.step"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K6.step readme N=200 rodaspr {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, "
            f"{ops} operations), plan C={plan.C} Mc={plan.Mc}")
        # the small KS path: adaptive output steps through K6
        km, kfields, kpars, kargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
        for rep in range(2):
            ada = schemes.RODASPR(km, tol=1e-3)
            t, f, per = 0.0, kfields, []
            for _ in range(2):
                torch.cuda.synchronize()
                start = time.perf_counter()
                t, f = ada(t, f, 1.0, kpars)
                torch.cuda.synchronize()
                per.append(((time.perf_counter() - start) * 1e3, ada._internal_iter))
            log(f"  ks N=2^13 adaptive output step {dt_name} (run {rep}): "
                + ", ".join(f"{ms:.4f} ms for {it} attempts" for ms, it in per)
                + " (host clock, synchronised)")
        scan = schemes.RODASPR(km, time_stepping=False, tol=None).device_fixed_scan(N_SMALL)
        ms = cuda_ms(lambda: scan(0.0, *kargs, 0.05, 100), 3)
        log(f"  ks N=2^13 rodaspr device_fixed_scan {dt_name}: {ms * 10:.4f} us per step "
            "at nsteps = 100 (CUDA events)")
        # the reference's N = 10^4 grids, Woodbury plans, both through K6
        for label, eqs, case in (("ks N=10^4 (K6)", KS, ks_case(1.0, 2.0, N_REF_SMALL)),
                                 ("burgers N=10^4 (K6)", BURGERS,
                                  burgers_case(N_REF_SMALL, 1.0, 2.0))):
            wm, wfields, wpars, wargs, _ = path_inputs(eqs, case, dtype)
            for rep in range(2):
                ada = schemes.RODASPR(wm, tol=1e-3)
                t, f, per = 0.0, wfields, []
                for _ in range(2):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    t, f = ada(t, f, 1.0, wpars)
                    torch.cuda.synchronize()
                    per.append(((time.perf_counter() - start) * 1e3, ada._internal_iter))
                log(f"  {label} adaptive output step {dt_name} (run {rep}): "
                    + ", ".join(f"{ms:.4f} ms for {it} attempts" for ms, it in per)
                    + " (host clock, synchronised)")
        bm, _, _, bargs, _ = path_inputs(BURGERS, burgers_case(N_REF_SMALL), dtype)
        scan = schemes.RODASPR(bm, time_stepping=False, tol=None).device_fixed_scan(
            N_REF_SMALL)
        ms = cuda_ms(lambda: scan(0.0, *bargs, 0.05, 100), 3)
        log(f"  burgers N=10^4 (K6, woodbury) rodaspr device_fixed_scan {dt_name}: "
            f"{ms * 10:.4f} us per step at nsteps = 100 (CUDA events)")
        kplan = megastep.plan_for(N_SMALL, 1, 2, True)
        table = kernel_checks.rodaspr_table()
        a_args = (adaptive_controller, km.backend, kplan, table, True, *kargs, 0.0, 1.0,
                  1e-6, 1e-3, 0.9, None, None)
        attempts = megastep.row_adaptive_step(*a_args)[2]
        p1, k1, k2, p2 = (cuda_ms(lambda: fn(*a_args), 2) for fn in (
            megastep.adaptive_plain, megastep.row_adaptive_step,
            megastep.row_adaptive_step, megastep.adaptive_plain))
        nbytes, ops = k6_work(km, kplan, table, dtype, attempts)
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name]["K6.adaptive"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
        log(f"  K6.adaptive ks N=2^13 first output step ({attempts} attempts) {dt_name}: "
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}: {nbytes} bytes, {ops} operations), plan C={kplan.C} Mc={kplan.Mc}")
        # the layout sweeps behind megastep.cluster_cost_us, their fit and
        # the plans' picks against the fastest layout
        points, picks = cluster_sweep(dtype, dt_name)
        report_cluster_fit(points, picks, dt_name)
        crossover_sweep(dtype, dt_name, sweep)
    for (s_blk, sch_name), by_n in sorted(sweep.items()):
        wins = [N for N in sorted(by_n) if all(all(by_n[M]) for M in by_n if M <= N)]
        log(f"  crossover s={s_blk} {sch_name}: K6 faster at every N up to "
            f"{max(wins, default=0)} in both dtypes (the gate megastep.MAX_N[{s_blk}] is "
            f"{megastep.MAX_N.get(s_blk)})")
    return times


#: the grids of the mixed entry's crossover sweep behind
#: megastep.MIXED_MAX_N: powers of two and the reference's N = 10^4
#: (bench.py:545 bench_df64_smalln)
MIXED_SWEEP_NS = sorted([1 << e for e in range(10, 16)] + [N_REF_SMALL])
MIXED_SWEEP_SCHEMES = {
    "rodaspr": lambda m: schemes.RODASPR(m, time_stepping=False, tol=None,
                                         df64_mixed_solve=1),
    "theta": lambda m: schemes.Theta(m, theta=1.0, df64_mixed_solve=1)}


def k6_mixed_work(model, plan, table, passes):
    """(bytes, float64 operations, float32 operations) of K6's mixed entry
    on these inputs: each input read once and the state written once; per
    step J, the stage sums and bias, F, the residual passes, the final rows
    and err in float64, the factor, the PCR factor and (1 + passes) solves
    per stage in float32."""
    sysm = model.system
    N, nvar, s, C, M = plan.N, sysm.nvar, plan.s, plan.C, plan.M
    s2, nlev, n = 2 * s, pcr.n_levels(plan.C), nvar * plan.N
    n_in = (nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
    solve = 6 * s * s * M + 4 * s2 * s2 * C * nlev + 4 * s * n
    residual = (2 * plan.W * nvar + 3) * n
    ops64 = expr_ops(sysm.J_band_exprs.values()) * N
    ops32 = 8 * s ** 3 * M + 12 * s2 ** 3 * C * nlev
    for a_row, c_row in table.stages:
        combos = 0 if megastep._is_u(a_row) else 2 * len(a_row) * n
        if c_row is not None:
            combos += 3 * len(c_row) * n
        ops64 += combos + expr_ops(sysm.F_exprs) * N + n + passes * residual
        ops32 += (1 + passes) * solve
    ops64 += sum(2 * len(row) * n for row in table.final) + 2 * n * (len(table.final) - 1)
    return (n_in + n) * 8 + 32, ops64, ops32


def mixed_bound(nbytes, ops64, ops32):
    """``bound`` of work in two types: float64 operations over the float64
    peak plus float32 ones over the float32 peak, against the bytes."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = (ops64 / OPS_PER_S[torch.float64] + ops32 / OPS_PER_S[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixed_crossover():
    """The crossover behind megastep.MIXED_MAX_N: fixed df64 steps with
    one residual pass through K6's mixed entry (the plan forced past the
    gate, where a cluster holds it) against the multi-launch mixed path,
    per block size and scheme over MIXED_SWEEP_NS."""
    sweep = {}
    for label, eqs, make_case, s_blk in SWEEP_MODELS:
        model = Model(*eqs, double="df64", device="cuda")
        sysm = model.system
        for sch_name, make in MIXED_SWEEP_SCHEMES.items():
            row = []
            for N in MIXED_SWEEP_NS:
                fields_np, pars, dt, _, _ = make_case(N)
                fields, pars_t = state_from_numpy(fields_np, pars, model)
                k6, multi = make(model), make(model)
                plan = megastep.make_plan(N, sysm.nvar, sysm.halo, True)
                if not megastep.fits(plan, mixed=True):
                    sweep.setdefault((s_blk, sch_name), {})[N] = False
                    row.append(f"N={N}: no cluster holds C={plan.C}")
                    continue
                k6._mega_plans[(N, True, "mixed")] = plan
                multi._mega_plans[(N, True, "mixed")] = None
                m1, k1, k2, m2 = (cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 10)
                                  for sch in (multi, k6, k6, multi))
                sweep.setdefault((s_blk, sch_name), {})[N] = min(k1, k2) < min(m1, m2)
                row.append(f"N={N}: {k1:.4f}/{k2:.4f} vs {m1:.4f}/{m2:.4f}")
            log(f"  df64 mixed=1 {label} (s={s_blk}) {sch_name} fixed step, K6 mixed entry vs "
                "multi-launch (ms, CUDA events over 10 steps): " + "; ".join(row))
    for (s_blk, sch_name), by_n in sorted(sweep.items()):
        wins = [N for N in sorted(by_n) if all(by_n[M] for M in by_n if M <= N)]
        log(f"  mixed crossover s={s_blk} {sch_name}: K6's mixed entry faster at every N up "
            f"to {max(wins, default=0)} (the gate megastep.MIXED_MAX_N[{s_blk}] is "
            f"{megastep.MIXED_MAX_N.get(s_blk)})")


def phase3_df64():
    """The df64 mode: ms per KS 10^6 RODASPR step in double=True, df64 full
    and df64 mixed=1 (alternated, with profiles); K8 against its bound,
    plain version and library call; K6's mixed entry at KS 2^13 beside
    K6.step in float64; Burgers 10^6 Theta(solver=) per step; the mixed
    entry's crossover sweep behind its gate."""
    log("phase 3: the df64 mode (CUDA events)")
    times = {}
    _, g00 = rodaspr_rows()
    gdt = g00 * DF64_DT
    runs = {}
    for label, double, passes in (("double=True", True, None), ("df64 full", "df64", None),
                                  ("df64 mixed=1", "df64", 1)):
        model, fields, pars_t, _, _ = path_inputs(KS, ks_case(DF64_DT, 4 * DF64_DT, N_REF),
                                                  torch.float64, double)
        runs[label] = (schemes.RODASPR(model, time_stepping=False, tol=None,
                                       df64_mixed_solve=passes), fields, pars_t)
    order = ["double=True", "df64 full", "df64 mixed=1", "df64 mixed=1", "df64 full",
             "double=True"]
    ms = [cuda_ms(lambda: runs[label][0](0.0, runs[label][1], DF64_DT, runs[label][2]), 10)
          for label in order]
    log("  rodaspr fixed step ks N=10^6 (dt 0.0625), ms/step, "
        + " / ".join(order) + ": " + " / ".join(f"{m:.4f}" for m in ms)
        + " (CUDA events over 10 steps)")
    for label, (sch, f, p) in runs.items():
        log_profile(f"rodaspr fixed step ks N=10^6 {label}", "float64",
                    profile_step(sch, f, p, DF64_DT))
    # K8 on the first residual pass of the KS 10^6 df64 step
    model, _, _, args, _ = path_inputs(KS, ks_case(DF64_DT, 4 * DF64_DT, N_REF),
                                       torch.float64, "df64")
    b = model.backend
    bands = b.J_bands(*args, periodic=True)
    rhs = b.F(*args, periodic=True, scale=gdt)
    k = mixed.MixedFactorization(bands, gdt, True, chunked.make_plan(N_REF, 1, 2, True),
                                 0).solve(rhs)
    W, nvar, N = bands.shape[0], 1, N_REF
    # three copies of the operands (3 x 60 MB against the 50 MB L2), taken
    # in turn, so that no call finds its operands in L2, as the bound counts
    sets = [(bands, k, rhs)] + [tuple(a.clone() for a in (bands, k, rhs)) for _ in range(2)]
    sets = [(a, v, r, banded_csr(a, True, gdt)) for a, v, r in sets]
    turn = itertools.count()

    def in_turn(fn):
        return lambda: fn(*sets[next(turn) % len(sets)])

    kern = in_turn(lambda a, v, r, _: mixed.mixed_residual(a, v, r, gdt, True))
    plain = in_turn(lambda a, v, r, _: mixed.mixed_residual_plain(a, v, r, gdt, True))
    library = in_turn(lambda a, v, r, csr: (
        (r - v) + torch.mv(csr, v.view(-1)).view_as(v)).float())
    nbytes = (W * nvar * nvar * N + 2 * nvar * N) * 8 + nvar * N * 4
    ops = (2 * W * nvar + 3) * nvar * N
    p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
    lib_ms = min(cuda_ms(library, 5) for _ in range(2))
    b_ms, b_by = bound(nbytes, ops, torch.float64)
    times["K8.residual"] = (min(k1, k2), min(p1, p2), b_ms, b_by, lib_ms)
    log(f"  K8.residual ks N=10^6: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, {ops} operations), library "
        f"(torch.sparse CSR matvec, combination, cast) {lib_ms:.4f} ms")
    log_launch_us("K8.residual alone ks N=10^6 float64, operands taken in turn from three "
                  "copies", kern, "K8.residual", 21)
    # K6's mixed entry at KS N = 2^13 beside K6.step in float64
    km, _, _, kargs, _ = path_inputs(KS, ks_case(DF64_DT, 1.0, N_SMALL), torch.float64, "df64")
    kb = km.backend
    kplan = megastep.make_plan(N_SMALL, 1, 2, True)
    table = kernel_checks.rodaspr_table(False)
    mixed_fn = lambda n=1: megastep.step_mixed(kb, kplan, table, True, *kargs, -gdt, gdt, 1,
                                               nsteps=n)
    plain_fn = lambda: megastep.step_plain(kb, kplan, table, True, *kargs, -gdt, gdt, 1)
    f64_fn = lambda n=1: megastep.step(kb, kplan, table, True, *kargs, -gdt, gdt, nsteps=n)
    p1, k1, k2, p2 = (cuda_ms(f, 3) for f in (plain_fn, mixed_fn, mixed_fn, plain_fn))
    per = [1e3 / 20 * cuda_ms(lambda: fn(20), 3) for fn in (f64_fn, mixed_fn, mixed_fn, f64_fn)]
    nbytes, o64, o32 = k6_mixed_work(km, kplan, table, 1)
    b_ms, b_by = mixed_bound(nbytes, o64, o32)
    times["K6.step_mixed"] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
    log(f"  K6.step_mixed ks N=2^13 rodaspr one pass: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, {o64} float64 "
        f"and {o32} float32 operations), plan C={kplan.C} Mc={kplan.Mc}; us per step at "
        f"20 steps per launch, K6.step f64 / mixed / mixed / K6.step f64: "
        + " / ".join(f"{v:.2f}" for v in per))
    # Burgers 10^6 Theta(solver=), beside the plain Theta
    for dt_name, dtype in DTYPES.items():
        model, fields, pars_t, _, dt = path_inputs(BURGERS, burgers_case(N_REF), dtype)
        plain_t = schemes.Theta(model, theta=1.0)
        solver_t = schemes.Theta(model, theta=1.0, solver=chunked_solver)
        r = [cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 10)
             for sch in (plain_t, solver_t, solver_t, plain_t)]
        log(f"  theta step burgers N=10^6 {dt_name}, plain / solver= / solver= / plain: "
            + " / ".join(f"{m:.4f}" for m in r) + " ms/step (CUDA events over 10 steps)")
    mixed_crossover()
    return {"float64": times}

def phase3_precision(smi):
    """bench.py's df64 ensemble as aggregate cell-updates/s (B = 64 x KS N =
    10^5, mixed=1, the best of three steps(10, 0.05) calls after one, with
    a profile of its step by kernel), and what the Kahan carry costs K6:
    the KS 2^13 first adaptive output step with and without the carry (in
    turns, CUDA events), K6.compensated against its plain version and its
    bound, and the README step entry's device µs with and without the
    carry (a CUDA graph of 20 launches)."""
    log(f"phase 3: df64 ensembles and the carry (CUDA events; card {smi})")
    ens = df64_ensemble(B_DF64, N_DF64, DF64_ENS)
    ens.steps(STEPS_DF64, DT_DF64)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ens.steps(STEPS_DF64, DT_DF64)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
    if not bool(torch.isfinite(ens.u).all()):
        raise RuntimeError("df64 ensemble: non-finite state")
    rate = B_DF64 * N_DF64 * STEPS_DF64 / min(secs)
    log(f"  df64 ensemble B={B_DF64} x ks N={N_DF64} rodaspr mixed=1 (bench.py:632): "
        f"{rate:.6e} cell-updates/s, the best of steps({STEPS_DF64}, {DT_DF64}) in "
        + " / ".join(f"{x:.4f}" for x in secs) + f" s (host clock, synchronised); {smi}")
    log_profile(f"df64 ensemble step B={B_DF64} x ks N={N_DF64} mixed=1", "float64",
                profile_calls(lambda: ens.step(DT_DF64), 2))
    del ens
    torch.cuda.empty_cache()
    times = {}
    for dt_name, dtype in DTYPES.items():
        km, _, _, kargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
        kplan = megastep.plan_for(N_SMALL, 1, 2, True)
        table = kernel_checks.rodaspr_table()
        a_args = (adaptive_controller, km.backend, kplan, table, True, *kargs, 0.0, 1.0,
                  1e-6, 1e-3, 0.9, None, None)
        u = kargs[0]

        def carried(fn):
            return lambda: fn(*a_args, carry=torch.zeros_like(u))

        seen = []

        def counting(attempt, *args, **kw):
            def recorded(t_, state, dt_eff):
                out = attempt(t_, state, dt_eff)
                seen.append(out[1])
                return out
            return adaptive_controller(recorded, *args, **kw)

        attempts = megastep.adaptive_plain(counting, *a_args[1:],
                                           carry=torch.zeros_like(u))[2]
        accepted = sum(1 for e in seen if e <= 1e-3)
        bare = lambda: megastep.row_adaptive_step(*a_args)
        kern = carried(megastep.row_adaptive_step)
        plain = carried(megastep.adaptive_plain)
        p1, k1, b1, k2, b2, p2 = (cuda_ms(f, 2) for f in (plain, kern, bare, kern, bare,
                                                          plain))
        nbytes, ops = k6_work(km, kplan, table, dtype, attempts)
        n = u.numel()
        # the carry read and written once, four operations per node and
        # accepted attempt
        nbytes += 2 * n * u.element_size()
        ops += 4 * n * accepted
        b_ms, b_by = bound(nbytes, ops, dtype)
        times[dt_name] = {"K6.compensated": (min(k1, k2), min(p1, p2), b_ms, b_by, None)}
        log(f"  K6.compensated ks N=2^13 first output step ({attempts} attempts, "
            f"{accepted} accepted) {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, without the "
            f"carry {b1:.4f}/{b2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}: {nbytes} bytes, {ops} operations), plan C={kplan.C}")
        # the step entry's device time with and without the carry
        rm = Model(*README, double=dtype == torch.float64, device="cuda")
        fields_np, pars, rdt, _, _ = readme_case()
        rf, rp = state_from_numpy(fields_np, pars, rm)
        ru, rh, rx = rm.backend.split_fields(rf)
        rargs = (ru, rh, rm.backend.pack_pars(rp, rx), rx)
        rplan = megastep.plan_for(200, 1, 1, False)
        fixed = kernel_checks.rodaspr_table(False)
        T = np.float64 if dtype == torch.float64 else np.float32
        gdt = float(T(fixed.g00) * T(rdt))
        rc = torch.zeros_like(ru)
        step_bare = lambda: megastep.step(rm.backend, rplan, fixed, False, *rargs, -gdt,
                                          gdt, nsteps=10)
        step_carry = lambda: megastep.step(rm.backend, rplan, fixed, False, *rargs, -gdt,
                                           gdt, nsteps=10, carry=rc)
        us = [graph_us(f, 20) / 10 for f in (step_bare, step_carry, step_carry, step_bare)]
        log(f"  K6 step entry readme N=200 rodaspr {dt_name}, device us per step at 10 "
            "steps a launch, without / with / with / without the carry: "
            + " / ".join(f"{v:.3f}" for v in us) + " (a CUDA graph of 20 launches)")
    return times


@contextlib.contextmanager
def megatheta_opt_in(on):
    """``TRIFLOW_MEGATHETA=1`` (``on``) or unset, while an entry is built."""
    old = os.environ.pop("TRIFLOW_MEGATHETA", None)
    if on:
        os.environ["TRIFLOW_MEGATHETA"] = "1"
    try:
        yield
    finally:
        os.environ.pop("TRIFLOW_MEGATHETA", None)
        if old is not None:
            os.environ["TRIFLOW_MEGATHETA"] = old


def megatheta_entry(eqs, case, device, dtype, opt_in):
    """(model, plan, step, (u, helpers, pstack, x)) of the reference's
    theta entry on a case's grid, built with ``TRIFLOW_MEGATHETA=1``
    (``opt_in``) or without it; ``step(u) -> u'`` is one fixed step of the
    case's dt."""
    fields_np, pars, dt, _, _ = case
    N = len(fields_np["x"])
    model = Model(*eqs, double=dtype == torch.float64, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    scheme = schemes.Theta(model, theta=1.0)
    with megatheta_opt_in(opt_in):
        plan, fixed = scheme.device_fixed_step_folded(N, periodic=True)
    args = scheme._split(fields, pars_t)
    dx = 0.5  # the cases' grid step, x = 0.5 i
    return model, plan, (lambda u: fixed(0.0, u, *args[1:], dx, dt)[0]), args


def megatheta_run(eqs, case, steps, device, dtype, opt_in):
    """(plan, u after ``steps`` steps) of ``megatheta_entry``."""
    _, plan, step, args = megatheta_entry(eqs, case, device, dtype, opt_in)
    u = args[0]
    for _ in range(steps):
        u = step(u)
    return plan, u


def phase2_megatheta(launches):
    """The opt-in two-pass theta step through the reference's entry
    (``MEGATHETA_CASES``): each case with the launch counts set to 0 just
    before it and read just after, held to its exact launches (K9's two
    entries, K4's factor and solve with shifts once per step, the Woodbury
    set-up once per step on a Woodbury plan, nothing else), to the same
    entry without the opt-in on the card (K1-K4) and to the port's CPU f64
    run of the opt-in (plain versions): on the state relative to max|u|,
    and in the case's increment dtypes on the increment from the first
    state (``kernel_checks.increment_error``), both to the same limit."""
    log("phase 2: the opt-in two-pass theta step (TRIFLOW_MEGATHETA=1: K9)")
    refs = cpu_refs()
    for name, eqs, case, steps, wood, inc_dtypes in MEGATHETA_CASES:
        N = len(case[0]["x"])
        sysm = Model(*eqs, device="cpu").system
        want = megatheta.plan_for(N, sysm.nvar, sysm.halo)
        if want is None or want.woodbury != wood:
            raise RuntimeError(f"{name}: plan {want}, expected woodbury={wood}")
        u_cpu, cpu_s = refs[name]
        u_cpu = torch.from_numpy(u_cpu)
        for dt_name, dtype in DTYPES.items():
            _, plan, step, args = megatheta_entry(eqs, case, "cuda", dtype, True)
            if plan != want:
                raise RuntimeError(f"{name} {dt_name}: the entry took plan {plan}, "
                                   f"not K9's {want}")
            u = u0 = args[0]
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            for _ in range(steps):
                u = step(u)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            exact = dict.fromkeys(counts, 0)
            exact.update(dict.fromkeys(K9 + [kernel_checks.factor_entry(plan.s, plan.C),
                                             "K4.pcr_solve_shift"], steps))
            exact["K4.pcr_solve"] = steps if wood else 0
            off = {k: counts[k] for k in counts if counts[k] != exact[k]}
            log(f"  {name} {dt_name}: plan C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
                f"woodbury={plan.woodbury}; launches "
                + json.dumps({k: v for k, v in counts.items() if v})
                + f"; {secs:.3f} s wall (first call, build included)")
            if off:
                raise RuntimeError(f"{name} {dt_name}: launches {off} off {exact}")
            for k in KERNELS:
                launches[k] += counts[k]
            _launch.reset_counters()
            _, u_route = megatheta_run(eqs, case, steps, "cuda", dtype, False)
            if any(_launch.counts()[k] for k in K9):
                raise RuntimeError(f"{name} {dt_name}: K9 launched without the opt-in")
            lim = 1e-10 if dtype == torch.float64 else 1e-4
            if not bool(torch.isfinite(u).all()) or u.shape != u_cpu.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            refs_k = {"the entry without the opt-in on the card (K1-K4)": u_route.double().cpu(),
                      f"the port's CPU f64 run of the opt-in ({cpu_s:.1f} s)": u_cpu}
            got = u.double().cpu()
            errs = []
            for against, ref in refs_k.items():
                err = float((got - ref).abs().max() / ref.abs().max())
                text = f"max|du| / max|u| = {err:.3e}"
                errs.append(err)
                if dt_name in inc_dtypes:
                    err = kernel_checks.increment_error(u, ref, u0, lim, name)[1]
                    text += f", of the increment max|du| / max|u - u0| = {err:.3e}"
                    errs.append(err)
                log(f"    against {against}: {text} (limit {lim:.0e})")
            if not all(e <= lim for e in errs):
                raise RuntimeError(f"{name} {dt_name}: disagrees")
    log("  launches over phase 2 with the opt-in: " + json.dumps(launches))
    return launches


def k9_work(model, plan):
    """(bytes, operations) of K9's interface and correct entries: each reads
    u, the helpers, the parameters and, where the model reads it, x once;
    the interface pass writes the reduced system and its right-hand side,
    the correction pass reads the 2s interface unknowns of every chunk and
    writes u2.  Operations: F and J at every node and, per supernode row,
    the band scaling, the elimination (two products, an inverse, a
    matrix-vector product: about 4 s^3 + 4 s^2) and the back substitution
    to the sub-chunk's first row (three products: 4 s^3 + 2 s^2; the
    correction pass a second, 4 s^2, for its solution); the interface pass
    carries a spike column (2 s^3 more)."""
    sysm, item = model.system, torch.finfo(model.dtype).bits // 8
    N, s, C, g = plan.N, plan.s, plan.C, plan.g
    M = N // g
    reads_x = stencil.uses_x(sysm, model.backend.args_symbols)
    n_in = (sysm.nvar + len(sysm.help_funcs) + len(sysm.pars) + int(reads_x)) * N
    evals = (expr_ops(sysm.F_exprs) + expr_ops(sysm.J_band_exprs.values())
             + sysm.nvar) * N + 3 * s * s * M
    elim = (8 * s ** 3 + 6 * s * s) * M
    interface = ((n_in + (2 * (2 * s) ** 2 + 2 * s) * C) * item,
                 evals + elim + 2 * s ** 3 * M)
    correct = ((n_in + 2 * s * C + sysm.nvar * N) * item, evals + elim + 4 * s * s * M)
    return interface, correct


#: the chunk-count sweep behind ``megatheta.plan_for``: (label, equations,
#: case)
MEGATHETA_SWEEPS = [("burgers N=10^6", BURGERS, burgers_case(N_REF)),
                    ("ks N=2^20", KS, ks_case(0.05, 0.2))]


def k9_pieces(model, plan, args, dt):
    """({piece: (call, another call on inputs cold in L2 or None)}, the
    entries' (bytes, operations), the cold sets, the shifts (xm1, xp1)) of
    one K9 step on ``plan``: K9's entries (cold: on copies of the state, in
    turn), K4's factor, its Woodbury set-up on a Woodbury plan, its solve
    with shifts, and the whole step."""
    b = model.backend
    beta, dts = megatheta.scalars(model.dtype, 1.0, dt)
    Lred, Ured, yred = megatheta.interface(b, plan, *args, beta, dts)
    red = pcr.pcr_factor(Lred, Ured, plan.cyclic)
    wood = pcr.woodbury(red, Lred, Ured) if plan.woodbury else ()
    xm1, xp1 = pcr.pcr_solve_shift(red, yred, plan.wrap, *wood)
    work = k9_work(model, plan)
    sets = cold_sets(work[1][0], lambda i: args if i == 0 else tuple(a.clone() for a in args))
    pieces = {
        "K9.interface": (lambda: megatheta.interface(b, plan, *args, beta, dts),
                         cold_call(sets, lambda *a: megatheta.interface(b, plan, *a, beta,
                                                                        dts))),
        "K9.correct": (lambda: megatheta.correct(b, plan, *args, beta, dts, xm1, xp1),
                       cold_call(sets, lambda *a: megatheta.correct(b, plan, *a, beta, dts,
                                                                    xm1, xp1))),
        "K4.pcr_factor": (lambda: pcr.pcr_factor(Lred, Ured, plan.cyclic), None),
        "K4.pcr_solve": ((lambda: pcr.woodbury(red, Lred, Ured)) if plan.woodbury else None,
                         None),
        "K4.pcr_solve_shift": (lambda: pcr.pcr_solve_shift(red, yred, plan.wrap, *wood), None),
        "step": (lambda: megatheta.theta_step(b, plan, 1.0, *args, dt), None),
    }
    return {k: v for k, v in pieces.items() if v[0] is not None}, work, len(sets), (xm1, xp1)


def k9_fit(points):
    """Non-negative least squares (relative weights; an offset per grid and
    dtype) of each piece's device µs over its ``megatheta.plan_features``:
    {constant name: value}, and each fit's largest relative residual."""
    keys = sorted({(label, d) for label, d, *_ in points})
    terms = {"K9": ((0, 1), ("CHAIN_US", "CHUNK_US"),
                    lambda t: t["K9.interface"] + t["K9.correct"]),
             "K4.pcr_factor": ((2, 3), ("LEVEL_US", "LEVEL_KC_US"),
                               lambda t: t["K4.pcr_factor"]),
             "K4.pcr_solve_shift": ((4,), ("SHIFT_US",), lambda t: t["K4.pcr_solve_shift"]),
             "K4.pcr_solve": ((5,), ("WOOD_US",), lambda t: t.get("K4.pcr_solve"))}
    consts, resid = {}, {}
    for piece, (idx, names, value) in terms.items():
        rows = [(f, (label, d), value(t)) for label, d, _, f, t in points
                if value(t) is not None]
        if not rows:
            continue
        A = np.array([[f[i] for i in idx] + [float(k == key) for key in keys]
                      for f, k, _ in rows])
        y = np.array([v for *_, v in rows])
        coef = nnls_fit(A, y / 1e3)
        consts.update(zip(names, coef[:len(idx)]))
        resid[piece] = float(np.max(np.abs(A @ coef - y) / y))
    return consts, resid


def phase3_megatheta():
    """K9 at Burgers N = 10^6 and KS N = 2^20: ms per step against the
    K1-K4 route of the same entry without the opt-in (alternated, CUDA
    events over 10 steps: the host's pace) and the K9 step's device µs (a
    CUDA graph of its calls, ``graph_us``); at Burgers each step under
    torch.profiler; each entry against its plain version (host call) and,
    by ``graph_us`` on inputs cold in L2, its device µs beside its bound;
    then the chunk-count sweep at both grids: each piece's device µs (K9's
    entries, K4's factor, Woodbury set-up and solve with shifts, the whole
    step; ``graph_us``) at every chunk count the step takes, the fit of
    ``megatheta.plan_cost_us`` they give, and the plan's pick against the
    fastest step."""
    log("phase 3: the opt-in two-pass theta step (CUDA events; device us by CUDA graphs)")
    for label, eqs, case in MEGATHETA_SWEEPS:
        for dt_name, dtype in DTYPES.items():
            _, plan, k9, args = megatheta_entry(eqs, case, "cuda", dtype, True)
            _, plan14, k14, _ = megatheta_entry(eqs, case, "cuda", dtype, False)
            u = args[0]
            ms = [cuda_ms(lambda: f(u), 10) for f in (k14, k9, k9, k14)]
            log(f"  theta step {label} {dt_name}, K1-K4 (C={plan14.C}) / K9 (C={plan.C}) "
                "/ K9 / K1-K4: " + " / ".join(f"{m:.4f}" for m in ms)
                + " ms/step (CUDA events over 10 steps); K9 step "
                f"{min(graph_us(lambda: k9(u), 10) for _ in range(2)):.2f} device us")
    times = {}
    _, eqs, case, *_ = MEGATHETA_CASES[0]
    for dt_name, dtype in DTYPES.items():
        _, _, k9, args = megatheta_entry(eqs, case, "cuda", dtype, True)
        _, _, k14, _ = megatheta_entry(eqs, case, "cuda", dtype, False)
        u = args[0]
        for label, f in (("K9", k9), ("K1-K4", k14)):
            log_profile(f"theta step burgers N=10^6 {label}", dt_name,
                        profile_calls(lambda: f(u), 5))
    for label, eqs, case in MEGATHETA_SWEEPS:
        for dt_name, dtype in DTYPES.items():
            model, plan, _, args = megatheta_entry(eqs, case, "cuda", dtype, True)
            b = model.backend
            beta, dts = megatheta.scalars(dtype, 1.0, case[2])
            pieces, work, n_sets, shifts = k9_pieces(model, plan, args, case[2])
            plains = {
                "K9.interface": lambda: megatheta.interface_plain(b, plan, *args, beta, dts),
                "K9.correct": lambda: megatheta.correct_plain(b, plan, *args, beta, dts,
                                                              *shifts)}
            for key, (nbytes, ops) in zip(("K9.interface", "K9.correct"), work):
                kern, cold = pieces[key]
                p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plains[key], kern, kern, plains[key]))
                us = min(graph_us(cold, max(20, n_sets)) for _ in range(2))
                b_ms, b_by = bound(nbytes, ops, dtype)
                if label == MEGATHETA_SWEEPS[0][0]:
                    times.setdefault(dt_name, {})[key] = (min(k1, k2), min(p1, p2), b_ms, b_by,
                                                          None)
                log(f"  {key} {label} {dt_name} (C={plan.C} Mc={plan.Mc}): kernel "
                    f"{k1:.4f}/{k2:.4f} ms host call, plain {p1:.4f}/{p2:.4f} ms; {us:.2f} "
                    f"device us cold in L2, bound {b_ms * 1e3:.2f} us ({b_by}: {nbytes} bytes, "
                    f"{ops} operations, {us / (b_ms * 1e3):.2f}x); library none (no PyTorch "
                    "call does an implicit step)")
            del pieces
            torch.cuda.empty_cache()
    # the chunk-count sweep: each piece's device µs at every chunk count
    points = {}
    for label, eqs, case in MEGATHETA_SWEEPS:
        for dt_name, dtype in DTYPES.items():
            model, plan0, _, args = megatheta_entry(eqs, case, "cuda", dtype, True)
            sysm, N = model.system, plan0.N
            row = {}
            for C in megatheta.chunk_counts(N, sysm.nvar, sysm.halo):
                plan = megatheta.plan_for(N, sysm.nvar, sysm.halo, C)
                pieces = k9_pieces(model, plan, args, case[2])[0]
                t = {k: min(graph_us(call, 20) for _ in range(2))
                     for k, (call, _) in pieces.items()}
                row[C] = t
                points.setdefault(plan.s, []).append(
                    (label, dt_name, C, megatheta.plan_features(plan.M, C, plan.s,
                                                                plan.woodbury), t))
                del pieces
                torch.cuda.empty_cache()
            best = min(row, key=lambda C: row[C]["step"])
            log(f"  K9 chunk sweep {label} {dt_name} (device us, the lower of two CUDA-graph "
                "readings): " + "; ".join(
                    f"C={C} Mc={plan0.M // C}: " + ", ".join(
                        f"{k.split('.')[-1]} {v:.2f}" for k, v in t.items())
                    for C, t in row.items())
                + f" -> fastest step C={best}; plan_for's C={plan0.C} at "
                f"{row[plan0.C]['step'] / row[best]['step'] - 1:+.2%}")
    for s_blk, pts in sorted(points.items()):
        consts, resid = k9_fit(pts)
        picks = []
        for label, d in sorted({(lb, d) for lb, d, *_ in pts}):
            rows = [(C, f, t) for lb, dd, C, f, t in pts if (lb, dd) == (label, d)]
            key = {name: i for i, name in enumerate(
                ("CHAIN_US", "CHUNK_US", "LEVEL_US", "LEVEL_KC_US", "SHIFT_US", "WOOD_US"))}
            pick = min(rows, key=lambda r: (sum(consts.get(n, 0.0) * r[1][i]
                                                for n, i in key.items()), r[0]))
            best = min(rows, key=lambda r: r[2]["step"])
            picks.append(f"{label} {d}: the fit picks C={pick[0]} "
                         f"({pick[2]['step'] / best[2]['step'] - 1:+.2%}), fastest C={best[0]}")
        log(f"  K9 cost fit s={s_blk}: " + ", ".join(f"{k} = {v:.4f}" for k, v in consts.items())
            + " (megatheta's " + ", ".join(
                f"{k} {getattr(megatheta, k)[s_blk]}" for k in consts)
            + "); largest relative residuals " + ", ".join(
                f"{k} {v:.1%}" for k, v in resid.items()) + "; " + "; ".join(picks))
    return times


#: the s = 6 falling film (nvar 3, halo 2): examples/11_falling_film.py's
#: Shkadov film (h, q; second-order upwind) with a capillary term and an
#: insoluble surfactant G, carried at the surface speed 3q/2h, that pulls on
#: the film through a Marangoni stress; its solves take K2-K4's wide
#: instantiations at S = 6 (interface blocks S2 = 12) and never K6
FILM = (["-dxq",
         "9/7 * q**2 / h**2 * dxh - upwind(17/7 * q / h, q, 2)"
         " + (h - q / h**2) / delta + h * dxxxh / (3 * delta) - Ma * h * dxG",
         "-upwind(3/2 * q / h, G, 2) + dxxG / Pe"],
        ["h", "q", "G"], ["delta", "Ma", "Pe"])
FILM_FIELDS = ("h", "q", "G")
#: the profiler's kernel names on the film's path: K3's and K4's wide
#: instantiations keep their kernels' names
FILM_TRACE_NAMES = {sub: f"{key}_wide" if f"{key}_wide" in KERNELS else key
                    for sub, key in TRACE_NAMES.items()}


def film_case(N, dt=0.5, tmax=0.5):
    """Example 11's film tiled along x = 0.1 i (its grid, one period per
    1000 nodes): h = 1 + 0.1 cos(2 pi 3 x / 100), q = h^3 / 3, G = 1 + 0.05
    sin(2 pi 2 x / 100); delta = 0.1, Ma = 0.5, Pe = 100, periodic."""
    x = 0.1 * np.arange(N)
    h = 1 + 0.1 * np.cos(2 * np.pi * 3 * x / 100)
    return ({"x": x, "h": h, "q": h ** 3 / 3, "G": 1 + 0.05 * np.sin(2 * np.pi * 2 * x / 100)},
            dict(periodic=True, delta=0.1, Ma=0.5, Pe=100.0), dt, tmax, None)


FILM_THETA = dict(scheme=schemes.Theta, theta=1.0)
#: the film on the card: (name, case, kwargs, how (n: n calls of the
#: scheme; "sim": Simulation), the grid of the port's CPU f64 run it is held
#: to).  The adaptive run (Simulation's defaults, tol 1e-4) is held to the
#: CPU run at N = 10^4 tiled 100 times: the state repeats every 1000 nodes,
#: so both grids take the same attempts and the same state to rounding, and
#: the CPU run at N = 10^6 would take minutes.  Output steps of 0.5 set
#: every dt from an err between 0.16 and 10 tol: the smaller errs either
#: grow dt by the controller's cap of 10 or are the clamped last attempt of
#: an output step, which sets no dt (tests/test_torch_film.py).  The fixed
#: steps take dt = 0.1: a float32 RODASPR step of 0.5 (I - g00 dt J with
#: dt J of order 10^3 from the capillary term) sits 1.1e-4 of max|u| from
#: the float64 one in the plain versions, over float32's limit of 1e-4,
#: and two steps of 0.1 3.3e-5.  Each step moves u by some 0.5 of max|u|,
#: so the state's limit resolves a wrong increment in both dtypes
FILM_CASES = [
    ("film N=10^6 Simulation defaults tol 1e-4 (3 x 0.5)", film_case(N_REF, 0.5, 1.5),
     dict(tol=1e-4), "sim", N_REF_SMALL),
    ("film N=10^6 rodaspr fixed (2 x 0.1)", film_case(N_REF, 0.1), FIXED, 2, N_REF),
    ("film N=10^6 theta (2 x 0.1)", film_case(N_REF, 0.1), FILM_THETA, 2, N_REF),
    ("film N=2^20 rodaspr fixed (2 x 0.1)", film_case(N_BIG, 0.1), FIXED, 2, N_BIG),
    ("film N=2^20 theta (2 x 0.1)", film_case(N_BIG, 0.1), FILM_THETA, 2, N_BIG),
]


def film_run(case, kwargs, how, device, dtype, double=None):
    """(u (3, N): h, q, G; attempts per output step) of a film case on
    ``device``; ``double`` overrides the model's mode."""
    fields_np, pars, dt, tmax, _ = case
    double = dtype == torch.float64 if double is None else double
    model = Model(*FILM, double=double, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    attempts = []
    if how == "sim":
        sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax, **kwargs)
        for t, fields in sim:
            attempts.append(sim._scheme._internal_iter)
        if sim.status != "finished" or not np.isclose(t, tmax):
            raise RuntimeError(f"film simulation ended at t={t} with status {sim.status}")
    else:
        scheme = kwargs["scheme"](model, **{k: v for k, v in kwargs.items() if k != "scheme"})
        t = 0.0
        for _ in range(how):
            t, fields = scheme(t, fields, dt, pars_t)
    return torch.stack([fields[k] for k in FILM_FIELDS]), attempts


def film_cpu_runs(conn):
    """The port's CPU f64 runs of ``FILM_CASES`` at their reference grids,
    sent through ``conn`` as {name: (u, attempts, s)} or ("error",
    traceback); run in a process of its own (``start_cpu_refs``)."""
    try:
        torch.set_num_threads(4)
        out = {}
        for name, case, kwargs, how, n_cpu in FILM_CASES:
            start = time.perf_counter()
            _, _, dt, tmax, _ = case
            u, attempts = film_run(film_case(n_cpu, dt, tmax), kwargs, how, "cpu",
                                   torch.float64)
            out[name] = (u.numpy(), attempts, time.perf_counter() - start)
        conn.send(out)
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def film_launches(plan, kwargs, steps):
    """The exact launches of ``steps`` film steps or attempts: per RODASPR
    step J, one factor (K2, K4 and, on a Woodbury plan, its set-up) and
    six stages of F, K5, the sweep, the solve with shifts and the
    correction; per Theta step one of each and no K5; nothing else."""
    stages = 1 if kwargs.get("scheme") is schemes.Theta else 6
    want = dict.fromkeys(KERNELS, 0)
    want.update({"K1.J": steps, "K2.spike_factor_wide": steps, "K4.pcr_factor_wide": steps,
                 "K4.pcr_solve_wide": steps if plan.woodbury else 0,
                 "K1.F": stages * steps, "K3.thomas_sweep_wide": stages * steps,
                 "K4.pcr_solve_shift_wide": stages * steps,
                 "K3.spike_correct_wide": stages * steps,
                 "K5.combine": 0 if stages == 1 else stages * steps})
    return want


def phase1_film(errs):
    """K2-K4's wide instantiations against their plain versions: at S =
    5..8 on random bands (``kernel_checks.run_wide``: one grid on
    block-cyclic, Woodbury and acyclic plans, and B = 4 members at S = 6
    and 8), then on the film's path (its F and J, and its solver on J's
    bands at the first RODASPR stage, g00 dt = 0.125, at N = 10^6 and 2^20
    on the plans the path takes), and at S = 6 in float32 on the bands the
    df64 mode's mixed solve rounds (its factor, N = 10^6)."""
    log("phase 1: K2-K4 at block sizes S = 5..8 against their plain versions")
    wide = kernel_checks.run_wide("cuda")
    _, g00 = rodaspr_rows()
    for dt_name, dtype in DTYPES.items():
        res = wide[dt_name]
        log(f"  wide blocks S = 5..8, small shapes {dt_name}: " + json.dumps(res))
        for N in (N_REF, N_BIG):
            model, _, _, args, dt = path_inputs(FILM, film_case(N), dtype)
            kernel_checks.check_stencil(model, N, True, "cuda", results=res)
            bands = model.backend.J_bands(*args, periodic=True)
            kernel_checks.check_solver(bands, 1.0, -g00 * dt, True, results=res)
        log(f"  the film's path (S = 6, N = 10^6 and 2^20) {dt_name}: " + json.dumps(res))
        for name, err in res.items():
            errs[dt_name][name] = max(errs[dt_name].get(name, 0.0), err)
    model, _, _, args, dt = path_inputs(FILM, film_case(N_REF), torch.float64, "df64")
    bands = model.backend.J_bands(*args, periodic=True)
    gdt = g00 * dt
    plan = chunked.make_plan(N_REF, 3, 2, True)
    _launch.reset_counters()
    fact = mixed.MixedFactorization(bands, gdt, True, plan, 1)
    if _launch.counts()["K2.spike_factor_wide"] != 1:
        raise RuntimeError("the mixed solve's factor did not launch K2 at S = 6")
    rng = np.random.default_rng(5)
    rhs, add = (torch.tensor(rng.standard_normal((3, N_REF)), dtype=torch.float32,
                             device="cuda") for _ in range(2))
    res = kernel_checks.check_solver_pieces(bands.float(), -gdt, plan, rhs, add)
    log("  the df64 mixed solve's float32 factor (S = 6, N = 10^6): " + json.dumps(res))
    for name, err in res.items():
        errs["float32"][name] = max(errs["float32"].get(name, 0.0), err)
    return errs


def phase2_film(launches):
    """The falling film (S = 6) through the port's entry points on the card
    (``FILM_CASES``), both dtypes, each run with the launch counts set to 0
    just before it and read just after: exact launches of K1, K5 and K2-K4's
    wide entries (none of K2-K4's narrow ones, K6, K7, K8 or K9); finite
    h, q, G against the port's CPU f64 run, on the state relative to
    max|u| and, for the fixed steps in float64, on the increment from the
    first state (``kernel_checks.increment_error``), with the same attempts
    in every output step in float64."""
    log("phase 2: the falling film (S = 6) on the card")
    refs = cpu_refs("film")
    for name, case, kwargs, how, n_cpu in FILM_CASES:
        fields_np, pars, dt, tmax, _ = case
        N = len(fields_np["x"])
        plan = chunked.make_plan(N, 3, 2, True)
        u_ref, att_ref, cpu_s = refs[name]
        u_ref = torch.from_numpy(np.tile(u_ref, (1, N // n_cpu)))
        u0 = torch.from_numpy(np.stack([fields_np[k] for k in FILM_FIELDS]))
        log(f"  {name}: plan C={plan.C} Mc={plan.Mc} cyclic={plan.cyclic} "
            f"woodbury={plan.woodbury}; the port's CPU f64 run at N={n_cpu} ({cpu_s:.1f} s), "
            f"attempts per output step {att_ref}")
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            u, attempts = film_run(case, kwargs, how, "cuda", dtype)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            steps = sum(attempts) if how == "sim" else how
            want = film_launches(plan, kwargs, steps)
            off = {k: counts[k] for k in want if counts[k] != want[k]}
            log(f"    {dt_name}: {secs:.3f} s wall (first call, build included); attempts "
                f"per output step {attempts}; launches "
                + json.dumps({k: v for k, v in counts.items() if v}))
            if off:
                raise RuntimeError(f"{name} {dt_name}: launches {off}, expected "
                                   + json.dumps({k: v for k, v in want.items() if v}))
            for k in KERNELS:
                launches[k] += counts[k]
            if not bool(torch.isfinite(u).all()) or u.shape != u_ref.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            got = u.double().cpu()
            err = float((got - u_ref).abs().max() / u_ref.abs().max())
            if how == "sim":
                lim = 1e-9 if dtype == torch.float64 else 1e-2
            else:
                lim = 1e-10 if dtype == torch.float64 else 1e-4
            text = f"max|u - u_cpu| / max|u| = {err:.3e}"
            errs = [err]
            if how != "sim" and dtype == torch.float64:
                inc = kernel_checks.increment_error(u, u_ref, u0, lim, name)[1]
                text += f", of the increment max|du| / max|u - u0| = {inc:.3e}"
                errs.append(inc)
            log(f"      against the CPU f64 run: {text} (limit {lim:.0e})")
            if not all(e <= lim for e in errs):
                raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
            if dtype == torch.float64 and attempts != att_ref:
                raise RuntimeError(f"{name} f64: attempts {attempts} differ from the "
                                   f"CPU run's {att_ref}")
    log("  launches over phase 2 with the film: " + json.dumps(launches))
    return launches


#: chunk counts of the film's sweeps behind ``chunked.plan_cost_us``'s wide
#: constants: at N = 10^6 divisors of its M = 5 10^5 supernodes (Woodbury
#: rings) and the power-of-two counts
#: that pad it (``chunked.padded_counts``: a ring closed at the system
#: level); at N = 2^20 powers of two (block-cyclic)
FILM_CHUNKS = {N_REF: [250, 400, 500, 625, 800, 1000, 1250, 1600, 2000, 2500, 4000, 5000,
                       8000, 512, 1024, 2048, 4096, 8192],
               N_BIG: [512, 1024, 2048, 4096, 8192]}


def film_sweep(dt_name, dtype, points):
    """The film's fixed RODASPR step under each chunk plan of ``FILM_CHUNKS``
    (the lower of two CUDA-event means over 2 steps), at N = 10^6 and 2^20;
    adds (N, C, plan, ms) to ``points``."""
    for N, chunks in FILM_CHUNKS.items():
        model, fields, pars_t, _, dt = path_inputs(FILM, film_case(N), dtype)
        ros = schemes.RODASPR(model, time_stepping=False, tol=None)
        key, plan0 = (N, True, 1), ros._plan(N, True)
        row = {}
        for C in chunks:
            plan = chunked.plan_with(N, 3, 2, True, C)
            ros._plans[key] = plan
            row[C] = min(cuda_ms(lambda: ros(0.0, fields, dt, pars_t), 2) for _ in range(2))
            points.append((N, dt_name, C, plan, row[C]))
        ros._plans[key] = plan0
        best = min(row, key=row.get)
        grid = "N=2^20" if N == N_BIG else "N=10^6"
        log(f"  film chunk sweep {grid} {dt_name} (ms per RODASPR step, the lower of two "
            "CUDA-event means over 2 steps): "
            + "; ".join(f"C={C} Mc={chunked.plan_with(N, 3, 2, True, C).Mc}"
                        f"{' padded' if chunked.plan_with(N, 3, 2, True, C).padded else ''}: "
                        f"{v:.4f}" for C, v in row.items())
            + f" -> fastest C={best}; make_plan's C={plan0.C} "
            + (f"at {row[plan0.C] / row[best] - 1:+.2%}" if plan0.C in row
               else "(not swept)"))


def film_fit(points):
    """The non-negative fit of the wide constants of ``chunked.plan_cost_us``
    and ``woodbury_cost_us`` to the film's sweeps, both grids and dtypes
    pooled with relative weights and one offset per grid and dtype, over
    the plans that pad nothing (a padded plan also pays its ring's column
    solves); then each sweep's fastest plan against make_plan's pick and
    against the fitted model's."""
    exact = [pt for pt in points if not pt[3].padded]
    groups = sorted({(N, dt) for N, dt, *_ in exact})
    feats = []
    for N, dt, C, plan, _ in exact:
        f = list(chunked.wide_features(plan.M, C, 6))
        if not plan.woodbury:
            f[2] = 0
        feats.append(f + [float((N, dt) == grp) for grp in groups])
    coef = nnls_fit(feats, [ms for *_, ms in exact])
    log(f"  film pooled non-negative fit ({len(exact)} plans, both grids and dtypes): "
        f"WIDE_ROW_US = {coef[0]:.3f}, WIDE_LEVEL_US = {coef[1]:.3f}, WIDE_WOOD_US = "
        f"{coef[2]:.3f}, offsets "
        + ", ".join(f"{N} {dt} {c:.1f} us" for (N, dt), c in zip(groups, coef[3:]))
        + f" (chunked has {chunked.WIDE_ROW_US}, {chunked.WIDE_LEVEL_US}, "
        f"{chunked.WIDE_WOOD_US})")
    for N, dt in sorted({(N, dt) for N, dt, *_ in points}):
        row = {C: ms for N_, dt_, C, _, ms in points if (N_, dt_) == (N, dt)}
        best = min(row, key=row.get)
        pick = chunked.make_plan(N, 3, 2, True).C
        model = {}
        for C in row:
            plan = chunked.plan_with(N, 3, 2, True, C)
            if not plan.padded:
                f = chunked.wide_features(plan.M, C, 6)
                model[C] = (coef[0] * f[0] + coef[1] * f[1]
                            + (coef[2] * f[2] if plan.woodbury else 0))
        fitted = min(model, key=model.get)
        log(f"  film N={N} {dt}: fastest C={best} ({row[best]:.4f} ms); make_plan's C={pick}"
            + (f" {row[pick]:.4f} ms ({row[pick] / row[best] - 1:+.2%})" if pick in row
               else " (not swept)")
            + f"; the fit's C={fitted} ({row[fitted] / row[best] - 1:+.2%})")


def phase3_film():
    """The film's step at N = 10^6 and 2^20 (RODASPR fixed and Theta, CUDA
    events, cell-updates/s) with a profile of the RODASPR step, each wide
    kernel entry at the path's inputs (N = 10^6, the first stage) against
    its plain version and its bound, and the chunk-count sweeps at N = 10^6
    and 2^20 with the least-squares fit of ``chunked.plan_cost_us``'s wide
    constants."""
    log("phase 3: the falling film (S = 6, CUDA events)")
    times, points = {}, []
    _, g00 = rodaspr_rows()
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        for N in (N_REF, N_BIG):
            grid = "N=2^20" if N == N_BIG else "N=10^6"
            model, fields, pars_t, args, dt = path_inputs(FILM, film_case(N), dtype)
            ros = schemes.RODASPR(model, time_stepping=False, tol=None)
            theta = schemes.Theta(model, theta=1.0)
            ms = [cuda_ms(lambda: sch(0.0, fields, dt, pars_t), 3)
                  for sch in (ros, theta, theta, ros)]
            log(f"  film {grid} {dt_name}: rodaspr {ms[0]:.4f} / {ms[3]:.4f} ms/step "
                f"({N / (min(ms[0], ms[3]) * 1e-3):.4e} cell-updates/s), theta {ms[1]:.4f} / "
                f"{ms[2]:.4f} ms/step ({N / (min(ms[1], ms[2]) * 1e-3):.4e} cell-updates/s)")
            log_profile(f"rodaspr fixed step film {grid}", dt_name,
                        profile_calls(lambda: ros(0.0, fields, dt, pars_t), 3,
                                      FILM_TRACE_NAMES))
            if N != N_REF:
                continue
            b = model.backend
            gdt = g00 * dt
            plan = chunked.make_plan(N, 3, 2, True)
            bands = b.J_bands(*args, periodic=True)
            rhs = b.F(*args, periodic=True, scale=gdt)
            pairs, _ = solver_pairs(bands, gdt, plan, rhs)
            log(f"  kernels at film {grid}: plan C={plan.C} Mc={plan.Mc} "
                f"woodbury={plan.woodbury}")
            for name, (kern, plain, nbytes, ops, _) in pairs.items():
                p1, k1, k2, p2 = (cuda_ms(f, 3) for f in (plain, kern, kern, plain))
                b_ms, b_by = bound(nbytes, ops, dtype)
                if name in KERNELS:
                    times[dt_name][name] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
                log(f"  {name} film {grid} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                    f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, "
                    f"{ops} operations), library none (no PyTorch call solves a "
                    "block-banded system)")
            del pairs, bands, rhs
        film_sweep(dt_name, dtype, points)
    film_fit(points)
    return times


# ---------------------------------------------------------- padded grids

#: the padded grids' sizes: a prime supernode count at g = 2
#: and a periodic N that is no multiple of g = 2
N_PRIME = 1000003
N_ODD = 999983


def ks_edge_case(N, dt=0.05, tmax=0.1):
    """KS on an edge grid (no ring, no hook): ``ks_case``'s state."""
    fields, _, _, _, _ = ks_case(dt, tmax, N)
    return fields, dict(periodic=False), dt, tmax, None


#: (name, equations, case, scheme kwargs, steps, f32 tolerance, f64
#: tolerance): driven by ``run_steps``, each held to the port's CPU f64 run
#: (``padded_cpu_runs``) and to its exact launches (``padded_launches``).
#: The README model at N = 199 takes whichever route K6's gate picks (its
#: serial plan, cheaper than the multi-launch path); at N = 4099 (prime) K6
#: declines it and K1-K5 pad it
PADDED_CASES = [
    ("ks N=999983 rodaspr fixed (4 x 0.05)", KS, ks_case(0.05, 0.2, N_ODD), FIXED, 4,
     1e-4, 1e-9),
    ("ks edge N=2*1000003 rodaspr fixed (2 x 0.05)", KS, ks_edge_case(2 * N_PRIME), FIXED, 2,
     1e-4, 1e-9),
    ("readme N=199 rodaspr fixed (10 x 5.0)", README, readme_case_at(199), FIXED, 10, 1e-3,
     1e-9),
    ("readme N=4099 rodaspr fixed (10 x 5.0)", README, readme_case_at(4099), FIXED, 10,
     1e-3, 1e-9),
    ("readme N=4099 theta (10 x 5.0)", README, readme_case_at(4099),
     dict(scheme=schemes.Theta, theta=1.0), 10, 1e-3, 1e-10),
]


def padded_cpu_runs(conn):
    """The port's CPU f64 runs of ``PADDED_CASES``, sent through ``conn``
    as {name: (u, s)} or ("error", traceback); run in a process of its own
    (``start_cpu_refs``)."""
    try:
        torch.set_num_threads(2)
        out = {}
        for name, eqs, case, kwargs, steps, *_ in PADDED_CASES:
            start = time.perf_counter()
            _, u, _ = run_steps(eqs, case, "cpu", torch.float64, kwargs, steps)
            out[name] = (u.numpy(), time.perf_counter() - start)
        conn.send(out)
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def padded_launches(plan, kwargs, steps):
    """The exact launches of ``steps`` fixed steps on a padded plan: per
    step J, one factor (K2, K4) and, on a ring, its 2 nvar h columns'
    solves; per stage (six RODASPR, one Theta) F, K5 (RODASPR) and one
    solve (K3's sweep, K4's solve with shifts, K3's correction); never the
    interface-level Woodbury set-up, K6 or anything else.  On K6's route
    (``plan`` None) one K6.step per step."""
    want = dict.fromkeys(KERNELS, 0)
    if plan is None:
        want["K6.step"] = steps
        return want
    stages = 1 if kwargs.get("scheme") is schemes.Theta else 6
    solves = stages + (2 * plan.nvar * plan.halo if plan.ring else 0)
    want.update({"K1.J": steps, "K2.spike_factor": steps,
                 kernel_checks.factor_entry(plan.s, plan.C): steps,
                 "K1.F": stages * steps, "K5.combine": 0 if stages == 1 else stages * steps,
                 "K3.thomas_sweep": solves * steps, "K3.spike_correct": solves * steps,
                 "K4.pcr_solve_shift": solves * steps})
    return want


def padded_path_checks(dtype, res):
    """K2-K4 against their plain versions on the padded paths' first-step
    bands and plans (the padded system's pieces, then the whole solve by
    its residual): KS at N = 999983 (ring) and on the edge grid of 2 x
    1000003 nodes, the README model at N = 199 (its chunked plan pads)."""
    for eqs, case, g00 in ((KS, ks_case(0.05, 0.2, N_ODD), 0.25),
                           (KS, ks_edge_case(2 * N_PRIME), 0.25),
                           (README, readme_case_at(199), 1.0)):
        model, _, pars, args, dt = path_inputs(eqs, case, dtype)
        periodic = bool(pars["periodic"])
        bands = model.backend.J_bands(*args, periodic=periodic)
        kernel_checks.check_solver(bands, 1.0, -g00 * dt, periodic, results=res)


def phase2_padded(launches):
    """The padded grids through the schemes on the card: each case's plan
    must pad (or, at the README model's N = 199, be K6's serial plan), its
    launches must be exact, and its state must agree with the CPU f64 run."""
    log("phase 2: padded grids")
    runs = {}
    for name, eqs, case, kwargs, steps, tol32, tol64 in PADDED_CASES:
        plan = case_plan(eqs, case, "chunked")
        mega = case_plan(eqs, case, "megastep")
        if mega is None and not plan.padded or mega is not None and mega.C != 1:
            raise RuntimeError(f"{name}: plan {plan} pads nothing, or K6's plan {mega} "
                               "is not its serial one")
        log(f"  {name}: " + (f"K6, plan C={mega.C} Mc={mega.Mc}" if mega else
                             f"plan C={plan.C} Mc={plan.Mc} Np={plan.Np} ring={plan.ring}"))
        want = padded_launches(None if mega else plan, kwargs, steps)
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            _, u, _ = run_steps(eqs, case, "cuda", dtype, kwargs, steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            log(f"  {name} {dt_name}: launches "
                + json.dumps({k: v for k, v in counts.items() if v}))
            off = {k: counts[k] for k in KERNELS if counts[k] != want[k]}
            if off:
                raise RuntimeError(f"{name} {dt_name}: launches {off}, expected "
                                   + json.dumps({k: v for k, v in want.items() if v}))
            for k in KERNELS:
                launches[k] += counts[k]
            runs[(name, dt_name)] = (u, secs)
    refs = cpu_refs("padded")
    for name, _, _, _, _, tol32, tol64 in PADDED_CASES:
        u_ref, cpu_s = refs[name]
        u_ref = torch.from_numpy(u_ref)
        scale = float(u_ref.abs().max())
        for dt_name in DTYPES:
            u, secs = runs[(name, dt_name)]
            if not bool(torch.isfinite(u).all()) or u.shape != u_ref.shape:
                raise RuntimeError(f"{name} {dt_name}: non-finite or misshapen")
            err = float((u.double().cpu() - u_ref).abs().max()) / scale
            tol = tol32 if dt_name == "float32" else tol64
            log(f"    {name} {dt_name}: {secs:.3f} s wall (first call); max|u - u_cpu_f64| "
                f"/ max|u| = {err:.3e} (tolerance {tol:.0e}; CPU {cpu_s:.1f} s)")
            if not err <= tol:
                raise RuntimeError(f"{name} {dt_name}: disagrees with the CPU run")
    return launches


#: chunk counts of the KS N = 10^6 sweep (divisors of its M = 500000
#: supernodes), behind ``chunked.ROW_US`` / ``LEVEL_US`` / ``SLAB_US``
KS_CHUNKS = [500, 625, 1000, 1250, 2000, 2500, 3125, 4000, 5000, 6250, 10000, 15625]
#: of KS at N = 10^4 (divisors of its 5000 supernodes)
KS_SMALL_CHUNKS = [25, 40, 50, 100, 125, 200, 250, 500, 625, 1000, 1250]
#: and of Burgers at N = 10^6 (divisors of 10^6)
BURGERS_CHUNKS = [500, 1000, 1250, 2000, 2500, 4000, 5000, 8000, 10000, 12500, 15625]


def phase3_padded():
    """What padding costs: fixed RODASPR steps of KS at N = 999983 (ring)
    beside 10^6, on the edge grid of 2 x 1000003 nodes beside 2 x 10^6,
    in turns (CUDA events), with a profile of the 999983 step; the README
    steps synchronised (N = 200 and 199 through K6, 199 and 4099 through
    K1-K5, padded); and the chunk-count sweeps of KS at N = 10^6 (with the
    least-squares fit of ``chunked.plan_cost_us``'s constants), KS at N =
    2^20 and Burgers Theta at N = 10^6, and the fit of both dtypes' KS 10^6
    sweeps behind the constants."""
    log("phase 3: padded grids and the KS 10^6 chunk sweep (CUDA events)")
    for dt_name, dtype in DTYPES.items():
        for pair in (((ks_case(0.05, 0.2, N_REF), "ks N=10^6"),
                      (ks_case(0.05, 0.2, N_ODD), "ks N=999983")),
                     ((ks_edge_case(2 * 10 ** 6), "ks edge N=2*10^6"),
                      (ks_edge_case(2 * N_PRIME), "ks edge N=2*1000003"))):
            steps = []
            for case, label in pair:
                model, fields, pars_t, _, dt = path_inputs(KS, case, dtype)
                ros = schemes.RODASPR(model, time_stepping=False, tol=None)
                steps.append((label, functools.partial(ros, 0.0, fields, dt, pars_t),
                              ros._plan(len(case[0]["x"]), bool(pars_t["periodic"]))))
            (la, fa, pa), (lb, fb, pb) = steps
            ms = [cuda_ms(f, 5) for f in (fa, fb, fb, fa)]
            log(f"  rodaspr fixed step {dt_name}: {la} (C={pa.C} Mc={pa.Mc}) "
                f"{ms[0]:.4f} / {ms[3]:.4f} ms, {lb} (C={pb.C} Mc={pb.Mc} Np={pb.Np} "
                f"ring={pb.ring}) {ms[1]:.4f} / {ms[2]:.4f} ms: padded / not "
                f"{min(ms[1], ms[2]) / min(ms[0], ms[3]):.4f}")
            if pb.ring:
                log_profile(f"rodaspr fixed step {lb}", dt_name, profile_calls(fb, 3))
        steps = []
        for N, withheld in ((200, False), (199, False), (199, True), (4099, False)):
            model, fields, pars_t, _, dt = path_inputs(README, readme_case_at(N), dtype)
            ros = schemes.RODASPR(model, time_stepping=False, tol=None)
            if withheld:
                multi_launch(ros, N, False)
            steps.append(latency_ms(lambda: ros(0.0, fields, dt, pars_t, hook=dirichlet)))
        log(f"  readme rodaspr step {dt_name}, synchronised (median, p10, p90 ms): " + ", ".join(
            f"{label} " + " / ".join(f"{v:.4f}" for v in lat) for label, lat in zip(
                ("N=200 (K6)", "N=199 (K6, serial plan)", "N=199 (K1-K5, padded)",
                 "N=4099 (K1-K5, padded)"), steps)))
    narrow_sweeps()
    return {dt_name: {} for dt_name in DTYPES}


def narrow_sweeps():
    """The chunk-count sweeps behind ``chunked.plan_cost_us`` at s <= 4: KS
    at N = 10^6 (fixed RODASPR, with each dtype's non-negative fit of the
    constants), KS at N = 2^20 and Burgers Theta at N = 10^6 (which plans
    the model picks there), then the pooled fit of both dtypes' KS 10^6
    sweeps behind the constants."""
    fits = {}
    for dt_name, dtype in DTYPES.items():
        # the chunk-count sweep behind chunked.plan_cost_us (s <= 4), and two
        # more grids whose plans the fit moved (KS 2^20 RODASPR, Burgers
        # 10^6 Theta: which plans it picks there)
        for label, eqs, case, sch, chunks, fit in (
                ("ks N=10^6 rodaspr", KS, ks_case(0.05, 0.2, N_REF), FIXED, KS_CHUNKS, True),
                ("ks N=10^4 rodaspr", KS, ks_case(0.05, 0.2, N_REF_SMALL), FIXED,
                 KS_SMALL_CHUNKS, True),
                ("ks N=2^20 rodaspr", KS, ks_case(0.05, 0.2, N_BIG), FIXED,
                 [1 << e for e in range(8, 15)], False),
                ("burgers N=10^6 theta", BURGERS, burgers_case(N_REF),
                 dict(scheme=schemes.Theta, theta=1.0), BURGERS_CHUNKS, False)):
            model, fields, pars_t, _, dt = path_inputs(eqs, case, dtype)
            N = len(case[0]["x"])
            # the multi-launch path's plans: K6's withheld (KS 10^4 is K6's)
            step = multi_launch(sch["scheme"](model, **{k: v for k, v in sch.items()
                                                         if k != "scheme"}), N, True)
            sysm = model.system
            key, plan0 = (N, True, 1), step._plan(N, True)
            row = {}
            for C in chunks:
                step._plans[key] = chunked.plan_with(N, sysm.nvar, sysm.halo, True, C)
                row[C] = min(cuda_ms(lambda: step(0.0, fields, dt, pars_t), 3)
                             for _ in range(2))
            step._plans[key] = plan0
            M = N // max(sysm.halo, 1)
            best = min(row, key=row.get)
            msg = (f"  chunk sweep {label} {dt_name} (ms per step, the lower of two "
                   "CUDA-event means over 3 steps): "
                   + "; ".join(f"C={C} Mc={M // C}: {v:.4f}" for C, v in row.items())
                   + f" -> fastest C={best}; make_plan's C={plan0.C} at "
                   f"{row[plan0.C] / row[best] - 1:+.2%}")
            if fit:
                coef = nnls_fit([[M // C, pcr.n_levels(C),
                                  pcr.n_levels(C) * -(-C // pcr.BLOCK_THREADS), 1.0]
                                 for C in row], list(row.values()))
                msg += (f"; non-negative fit ROW_US = {coef[0]:.3f}, LEVEL_US = "
                        f"{coef[1]:.3f}, SLAB_US = {coef[2]:.3f}, offset {coef[3]:.1f} us "
                        f"(chunked has {chunked.ROW_US}, {chunked.LEVEL_US}, "
                        f"{chunked.SLAB_US})")
                fits[(label, dt_name)] = (M, row)
            log(msg)
    # both grids' and dtypes' KS sweeps in one fit, one offset each: the
    # constants of chunked.plan_cost_us
    feats = [[M // C, pcr.n_levels(C), pcr.n_levels(C) * -(-C // pcr.BLOCK_THREADS)]
             + [float(d == e) for e in fits] for d, (M, row) in fits.items() for C in row]
    coef = nnls_fit(feats, [t for _, row in fits.values() for t in row.values()])
    picks = []
    for (label, d), (M, row) in fits.items():
        pick = min(row, key=lambda C: (float(np.dot(coef[:3], [
            M // C, pcr.n_levels(C), pcr.n_levels(C) * -(-C // pcr.BLOCK_THREADS)])), C))
        picks.append(f"{label} {d} C={pick} ({row[pick] / min(row.values()) - 1:+.2%})")
    log(f"  pooled non-negative fit of the ks N=10^6 and 10^4 sweeps: ROW_US = {coef[0]:.3f}, "
        f"LEVEL_US = {coef[1]:.3f}, SLAB_US = {coef[2]:.3f}; it picks " + ", ".join(picks))


#: (label, W, nvar, nodes, members, chunks) of phase 3's device times of
#: the solver kernels redesigned lately at the cells' plans: K4's Woodbury
#: set-up (by its route, and the one-block body of before beside it), K3's
#: tiled correction and K4's narrow factor; the plans before the refit to
#: the set-up across the card (KS 10^6 C = 2000, the padded ring N = 999983
#: on 2041 chunks of 1000090 nodes, Burgers 10^6 2500, the film 10^6 1000,
#: KS 2^20 2048), config 5, and after it (REFIT_SHAPES: 4000, 4065 chunks
#: of 999990 nodes, 5000, 2000, 4096)
REDESIGN_SHAPES = [("ks N=2^20", 5, 1, N_BIG, 1, 2048), ("ks N=10^6", 5, 1, N_REF, 1, 2000),
                   ("ks ring N=999983", 5, 1, 1000090, 1, 2041),
                   ("burgers N=10^6", 3, 1, N_REF, 1, 2500),
                   ("config 5", 5, 1, N_ENS, B_ENS, 100), ("film N=10^6", 5, 3, N_REF, 1, 1000)]
REFIT_SHAPES = [("ks N=2^20", 5, 1, N_BIG, 1, 4096), ("ks N=10^6", 5, 1, N_REF, 1, 4000),
                ("ks ring N=999983", 5, 1, 999990, 1, 4065),
                ("burgers N=10^6", 3, 1, N_REF, 1, 5000), ("film N=10^6", 5, 3, N_REF, 1, 2000)]
#: (label, model, N) of phase 3's device times of K1's tiled F against the
#: F entry of before (a RODASPR stage's call: a scale and a bias)
STENCIL_SHAPES = [("ks N=2^20", KS, N_BIG), ("ks N=10^6", KS, N_REF),
                  ("burgers N=10^6", BURGERS, N_REF)]


#: (label, model, N, members) of phase 3's device times of K1's tiled J
#: against the J entry of before: STENCIL_SHAPES, config 5 and the film
J_SHAPES = [(label, eqs, N, 1) for label, eqs, N in STENCIL_SHAPES] + [
    ("config 5", KS, N_ENS, B_ENS), ("film N=10^6", FILM, N_REF, 1)]
#: (label, W, nvar, N, members) of phase 3's device times of K7 against its
#: body of before: KS 10^6's refine=1 residual, the advection-diffusion
#: trajectory's (N = 1024) and the refined ensemble's (B = 4 KS members at
#: N = 10^5)
K7_SHAPES = [("ks N=10^6", 5, 1, N_REF, 1), ("advdiff N=1024", 3, 1, 1024, 1),
             (f"refine B={B_REFINE} N=10^5", 5, 1, N_ENS, B_REFINE)]


#: bytes the inputs of a cold-L2 timing rotate over (``cold_sets``): twice
#: the H100's 50 MB L2
COLD_BYTES = 100 * 2 ** 20


def cold_sets(nbytes, make):
    """Copies ``make(i)`` of a call's inputs, as many as span COLD_BYTES
    with ``nbytes`` each (one where a set alone does): timed in turn
    (``itertools.cycle``), each call reads inputs that COLD_BYTES of other
    traffic has passed through L2 since their last read, so that its time
    stands against the bytes bound (each input read from memory once), not
    against L2's rate."""
    return [make(i) for i in range(1 if nbytes >= COLD_BYTES else 1 + -(-COLD_BYTES // nbytes))]


def cold_call(sets, call):
    """A call of ``call(*inputs)`` on each of ``sets`` in turn."""
    turn = itertools.cycle(sets)
    return lambda: call(*next(turn))


def log_device(what, ms, us, b_ms, nbytes, extra=""):
    log(f"  {what}: {ms:.4f} ms host call, "
        + (f"{us:.2f} device us" if us is not None else "device us not measured")
        + f", bound {b_ms * 1e3:.3f} us ({nbytes} bytes)"
        + (f": {b_ms * 1e3 / us:.1%} of it" if us else "") + extra)


def redesign_setup(label, plan, fact, dtype, dt_name, names):
    """K4's Woodbury set-up at ``plan`` (Woodbury) on the factor of K2's
    ``fact``: by its route (``pcr.cols_route``) and the other narrow one
    beside it (the one block per member of before, or the clusters), on
    inputs cold in L2; (ms, plain ms, bound ms) of config 5's members
    route for the kernels line, else None."""
    B, C, s2 = plan.B, plan.C, 2 * plan.s
    lead = (B,) if B > 1 else ()
    red = pcr.pcr_factor(fact.Lred, fact.Ured, plan.cyclic)
    item = torch.finfo(dtype).bits // 8
    nlev = pcr.n_levels(C)
    # the factor's operators and Dinv, the two corner blocks; Z and cap_inv
    nbytes = B * ((2 * nlev + 1) * s2 * s2 * C + 2 * s2 * s2 + s2 * s2 * C + s2 * s2) * item
    ops = B * (s2 * C * (4 * s2 * s2 * nlev + 2 * s2 * s2) + 2 * s2 ** 3)
    b_ms, _ = bound(nbytes, ops, dtype)
    sets = cold_sets(nbytes, lambda i: (red, fact.Lred, fact.Ured) if i == 0 else (
        pcr.PcrFactor(*(a.clone() for a in red)), fact.Lred.clone(), fact.Ured.clone()))
    route = pcr.cols_route(s2, C, B)
    routes = [route] + ([r for r in ("clusters", "members") if r != route]
                        if s2 <= 2 * thomas.NARROW_S else [])
    out = None
    for r in routes:
        def call(red_, L, U, r=r):
            Z = torch.empty((*lead, s2, s2, C), dtype=dtype, device="cuda")
            cap = torch.empty((*lead, s2, s2), dtype=dtype, device="cuda")
            pcr._launch_cols(red_, None, L, U, Z, cap, s2, B, r)
            return Z, cap

        entry = ("K4.pcr_solve_members" if r == "members"
                 else kernel_checks.solver_entry("K4.pcr_solve", plan.s))
        fn = cold_call(sets, call)
        ms = min(cuda_ms(fn, 5 * len(sets)) for _ in range(2))
        us, _ = launch_us(fn, entry, names=names, kernels=2 if r == "clusters" else 1)
        log_device(f"{entry} (Woodbury set-up) {label} {dt_name} (C={C} B={B}, route {r}"
                   + (" (the plan)" if r == route else "") + "), cold L2", ms, us, b_ms,
                   nbytes)
        if r == "members" and label == "config 5":
            p_ms = min(cuda_ms(lambda: pcr.woodbury_plain(red, fact.Lred, fact.Ured), 2)
                       for _ in range(2))
            out = (ms, p_ms, b_ms, "bytes", None)
    return out


def redesign_stencil(dtype, dt_name):
    """K1's tiled F entry against the F entry of before (one thread per
    node, ``stencil.eval_F_nodes``) at STENCIL_SHAPES, a RODASPR stage's
    call (a scale and a bias): the host call's ms back to back and the
    device µs on inputs cold in L2, beside the bytes bound."""
    rng = np.random.default_rng(6)
    for label, eqs, N in STENCIL_SHAPES:
        model = Model(*eqs, double=dtype == torch.float64, device="cuda")
        b, sysm = model.backend, model.system
        item = torch.finfo(dtype).bits // 8

        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")

        x = torch.linspace(0.0, 0.5 * N, N, dtype=dtype, device="cuda")
        args = (t(sysm.nvar, N), t(len(sysm.help_funcs), N),
                0.5 + t(len(sysm.pars), N).abs(), x, t(sysm.nvar, N))
        n_in = (2 * sysm.nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N
        nbytes = (n_in + sysm.nvar * N) * item
        b_ms, _ = bound(nbytes, (expr_ops(sysm.F_exprs) + 2 * sysm.nvar) * N, dtype)
        sets = cold_sets(nbytes, lambda i: args if i == 0 else tuple(a.clone() for a in args))
        for what, fn in (("K1.F (tiled)", stencil.eval_F),
                         ("K1.F of before (a thread a node)", stencil.eval_F_nodes)):
            def call(u, h, p_, x_, bias, fn=fn):
                return fn(b, u, h, p_, x_, True, 0.05, bias)

            hot = functools.partial(call, *args)
            ms = min(cuda_ms(hot, 200) for _ in range(2))
            us, _ = launch_us(cold_call(sets, call), "K1.F")
            log_device(f"{what} {label} {dt_name} (host call back to back, device cold L2)",
                       ms, us, b_ms, nbytes)


def redesign_J(dtype, dt_name):
    """K1's tiled J entry against the J entry of before (one thread per
    node, ``stencil.eval_J_nodes``) at J_SHAPES, periodic: the host call's
    ms back to back and the device µs on inputs cold in L2 (the profiler's,
    and a CUDA graph's of the same calls, ``graph_us``), beside the bytes
    bound (the inputs read once, the bands written once)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for label, eqs, N, B in J_SHAPES:
        model = Model(*eqs, double=dtype == torch.float64, device="cuda")
        b, sysm = model.backend, model.system
        lead = (B,) if B > 1 else ()

        def rand(rows):
            return 1.0 + 0.1 * torch.randn((*lead, rows, N), dtype=dtype, device="cuda",
                                           generator=gen)

        args = (rand(sysm.nvar), rand(len(sysm.help_funcs)), rand(len(sysm.pars)),
                torch.linspace(0.0, 0.5 * N, N, dtype=dtype, device="cuda"))
        nbytes = (sum(a.numel() for a in args)
                  + B * b.window * sysm.nvar ** 2 * N) * args[0].element_size()
        b_ms, _ = bound(nbytes, expr_ops(sysm.J_band_exprs.values()) * N * B, dtype)
        sets = cold_sets(nbytes, lambda i: args if i == 0 else tuple(a.clone() for a in args))
        for what, fn in (("K1.J (tiled)", stencil.eval_J),
                         ("K1.J of before (a thread a node)", stencil.eval_J_nodes)):
            def call(u, h, p_, x_, fn=fn):
                return fn(b, u, h, p_, x_, True)

            hot = functools.partial(call, *args)
            ms = min(cuda_ms(hot, 3 if B > 1 else 200) for _ in range(2))
            cold = cold_call(sets, call)
            us, _ = launch_us(cold, "K1.J", launches=5 if B > 1 else 20)
            g_us = graph_us(cold, 3 if B > 1 else max(50, len(sets)))
            log_device(f"{what} {label} {dt_name} (B={B}; host call back to back, device "
                       "cold L2)", ms, us, b_ms, nbytes, f"; graph {g_us:.3f} device us, "
                       f"{b_ms * 1e3 / g_us:.1%} of the bound")
        del sets, args
        torch.cuda.empty_cache()


def redesign_matvec(dtype, dt_name):
    """K7 (a number scale, periodic) against its body of before (one
    thread per node, ``matvec.banded_matvec_nodes``) at K7_SHAPES, and
    the tiled body on the same inputs one element off a 16-byte boundary
    (scalar loads of the bands): the host call's ms back to back and the
    device µs on inputs cold in L2 (profiler and ``graph_us``), beside the
    bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, W, nvar, N, B in K7_SHAPES:
        lead = (B,) if B > 1 else ()
        bands = torch.randn((*lead, W, nvar, nvar, N), dtype=dtype, device="cuda",
                            generator=gen)
        v = torch.randn((*lead, nvar, N), dtype=dtype, device="cuda", generator=gen)
        nbytes = (bands.numel() + 2 * v.numel()) * v.element_size()
        b_ms, _ = bound(nbytes, (2 * W * nvar + 1) * nvar * N * B, dtype)
        sets = cold_sets(nbytes, lambda i: (bands, v) if i == 0 else (bands.clone(),
                                                                      v.clone()))
        off = [tuple(kernel_checks.offset_view(a) for a in inputs) for inputs in sets]
        for what, fn, ins in (("K7 (tiled)", matvec.banded_matvec, sets),
                              ("K7 tiled, scalar loads (inputs off 16 bytes)",
                               matvec.banded_matvec, off),
                              ("K7 of before (a thread a node)", matvec.banded_matvec_nodes,
                               sets)):
            def call(bd, vv, fn=fn):
                return fn(bd, vv, True, 0.0125)

            hot = functools.partial(call, *ins[0])
            ms = min(cuda_ms(hot, 200) for _ in range(2))
            cold = cold_call(ins, call)
            us, _ = launch_us(cold, "K7.matvec")
            g_us = graph_us(cold, max(50, len(ins)))
            log_device(f"{what} {label} {dt_name} (B={B}; host call back to back, device "
                       "cold L2)", ms, us, b_ms, nbytes, f"; graph {g_us:.3f} device us, "
                       f"{b_ms * 1e3 / g_us:.1%} of the bound")
        del sets, off, bands, v
        torch.cuda.empty_cache()


#: K6's rows of the kernels table (19-22) at the chunk plans of before
#: this layout's refit (the L2-scratch body's make_plan: README N = 200 C = 100, KS N =
#: 2^13 C = 256, the sweep's KS N = 200 C = 25) and at the plans of now
K6_BEFORE_C = {"readme": 100, "ks": 256, "sweep": 25}


def redesign_k6(dtype, dt_name):
    """K6's entries at rows 19-22's inputs, each at the chunk plan of
    before the refit and at this plan: the host call's ms (CUDA events) and
    device µs (the profiler), the phases a step takes on its cluster (the
    bound of the design: cluster and block barriers, rows walked in
    order), the cluster plan; and the sweep's steps(100) (B = 64 KS
    members at N = 200, one launch)."""
    T = np.float64 if dtype == torch.float64 else np.float32
    ros = kernel_checks.rodaspr_table(False)
    ros_err = kernel_checks.rodaspr_table()

    def both(label, key, model, N, periodic, before_c, call, n_stages=6, B=1, mixed=False):
        sysm = model.system
        own = megastep.make_plan(N, sysm.nvar, sysm.halo, periodic)._replace(B=B)
        for which, plan in (("before", chunked.plan_with(N, sysm.nvar, sysm.halo, periodic,
                                                          before_c, B)), ("now", own)):
            cl = megastep.cluster_plan(plan, n_stages, torch.float64 if mixed else dtype, B,
                                       mixed)
            fn = lambda: call(plan)  # noqa: E731
            ms = min(cuda_ms(fn, 5) for _ in range(2))
            us, _ = launch_us(fn, key, launches=10, tries=5)
            remote, local, rows = megastep.step_phases(plan, n_stages, cl)
            log(f"  {key} {label} {dt_name} at the plan of {which} (C={plan.C} Mc={plan.Mc}; "
                f"K={cl.K}, {cl.bytes} shared bytes a CTA, L2 "
                f"{[b for b in megastep.BUFFERS if cl.home(b) == 'L2']}): {ms:.4f} ms host "
                "call, " + (f"{us:.2f} device us" if us is not None else "device us not "
                            "measured")
                + f"; a step {remote} cluster barriers, {local} block barriers, {rows} rows "
                "walked in order")

    rm = Model(*README, double=dtype == torch.float64, device="cuda")
    rf, rp = state_from_numpy(readme_case()[0], readme_case()[1], rm)
    u, helpers, x = rm.backend.split_fields(rf)
    rargs = (u, helpers, rm.backend.pack_pars(rp, x), x)
    gdt = float(T(ros.g00) * T(readme_case()[2]))
    both("readme N=200 rodaspr step", "K6.step", rm, 200, False, K6_BEFORE_C["readme"],
         lambda plan: megastep.step(rm.backend, plan, ros, False, *rargs, -gdt, gdt))
    km, _, _, kargs, _ = path_inputs(KS, ks_case(1.0, 2.0, N_SMALL), dtype)
    both("ks N=2^13 first adaptive output step", "K6.adaptive", km, N_SMALL, True,
         K6_BEFORE_C["ks"], lambda plan: megastep.row_adaptive_step(
             adaptive_controller, km.backend, plan, ros_err, True, *kargs, 0.0, 1.0, 1e-6,
             1e-3, 0.9, None, None))
    sm = Model(*KS, double=dtype == torch.float64, device="cuda")
    sargs = kernel_checks.mega_members(sm, N_SWEEP, True, "cuda", B_SWEEP)
    sgdt = float(T(ros.g00) * T(0.05))
    both(f"sweep B={B_SWEEP} N={N_SWEEP} steps(100)", "K6.step", sm, N_SWEEP, True,
         K6_BEFORE_C["sweep"], lambda plan: megastep.step(sm.backend, plan, ros, True, *sargs,
                                                           -sgdt, sgdt, 100), B=B_SWEEP)
    both(f"sweep B={B_SWEEP} N={N_SWEEP} adaptive steps(4, 0.1) shared dt",
         "K6.adaptive_scan", sm, N_SWEEP, True, K6_BEFORE_C["sweep"],
         lambda plan: megastep.adaptive_scan(adaptive_controller, sm.backend, plan, ros_err,
                                             True, *sargs, 0.0, 0.1, 1e-6, 1e-3, 0.9, None,
                                             None, 4), B=B_SWEEP)
    if dtype == torch.float64:
        mm, _, _, margs, _ = path_inputs(KS, ks_case(DF64_DT, 1.0, N_SMALL), dtype, "df64")
        mgdt = ros.g00 * DF64_DT
        both("ks N=2^13 mixed step (one residual pass)", "K6.step_mixed", mm, N_SMALL, True,
             K6_BEFORE_C["ks"], lambda plan: megastep.step_mixed(
                 mm.backend, plan, ros, True, *margs, -mgdt, mgdt, 1), mixed=True)


def phase3_redesign():
    """The redesigned kernels at ``REDESIGN_SHAPES`` and ``REFIT_SHAPES``,
    on K2's factor of random bands (B members of one grid's bands), a
    random y, neighbour unknowns and ``add_to``: the host call's ms (CUDA
    events) and device µs per call (``torch.profiler``) beside the bytes
    bound, the inputs cold in L2 (``cold_sets``): K4's Woodbury set-up by
    its route and the other narrow one, K3's tiled correction, K4's narrow
    factor by its route (``pcr.factor_route``) and the other narrow one;
    then K1's tiled F against the F entry of before (``redesign_stencil``).
    Returns config 5's entries of the one block per member for the kernels
    line."""
    log("phase 3: the redesigned kernels at the cells' plans")
    times = {}
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        redesign_k6(dtype, dt_name)
        item = torch.finfo(dtype).bits // 8
        for label, W, nvar, N, B, C in REDESIGN_SHAPES + REFIT_SHAPES:
            plan = chunked.plan_with(N, nvar, W // 2, True, C, B)
            lead = (B,) if B > 1 else ()
            bands = kernel_checks.random_bands(W, nvar, N, dtype, "cuda")
            if B > 1:
                bands = bands.expand(B, *bands.shape).contiguous()
            fact = thomas.spike_factor(bands, 1.0, -0.3, plan)
            del bands
            s, s2, nlev = plan.s, 2 * plan.s, pcr.n_levels(C)
            names = FILM_TRACE_NAMES if s > 4 else TRACE_NAMES
            if plan.woodbury:
                members = redesign_setup(label, plan, fact, dtype, dt_name, names)
                if members is not None:
                    times[dt_name]["K4.pcr_solve_members"] = members
            gen = torch.Generator(device="cuda").manual_seed(3)
            y, add = (torch.randn((*lead, nvar, N), dtype=dtype, device="cuda", generator=gen)
                      for _ in range(2))
            xm1, xp1 = (torch.randn((*lead, plan.s, C), dtype=dtype, device="cuda",
                                    generator=gen) for _ in range(2))
            name = kernel_checks.solver_entry("K3.spike_correct", s)
            # y, add_to and x (nvar N each), W and V (s^2 per supernode each),
            # xm1 and xp1
            nbytes = B * (3 * nvar * N + 2 * plan.Mc * s * s * C + 2 * s * C) * item
            sets = cold_sets(nbytes, lambda i: (fact, y, xm1, xp1, add) if i == 0 else (
                fact._replace(W=fact.W.clone(), V=fact.V.clone()), y.clone(), xm1.clone(),
                xp1.clone(), add.clone()))
            kern = cold_call(sets, lambda f_, y_, m_, p_, a_: thomas.spike_correct(
                f_, y_, m_, p_, plan, add_to=a_))
            ms = min(cuda_ms(kern, 10 * len(sets)) for _ in range(2))
            us, _ = launch_us(kern, name, names=names)
            del sets, kern
            b_ms, _ = bound(nbytes, 4 * s * nvar * N * B, dtype)
            cp = thomas.correct_plan(s, item, plan.Mc, C, B)
            log_device(f"{name} {label} {dt_name} (C={C} Mc={plan.Mc} B={B}, {cp}), cold L2",
                       ms, us, b_ms, nbytes)
            # K4's factor: its route, and the other narrow one beside it
            red_bytes = B * (2 * s2 * s2 * C + (2 * nlev + 1) * s2 * s2 * C) * item
            b_ms, _ = bound(red_bytes, B * 12 * s2 ** 3 * C * nlev, dtype)
            route = pcr.factor_route(s2, C)
            routes = [route] + ([r for r in ("grid", "members") if r != route]
                                if route != "wide" else [])
            for r in routes:
                fn = lambda r=r: pcr._factor(fact.Lred, fact.Ured, plan.cyclic, r)
                entry = {"wide": "K4.pcr_factor_wide", "members": "K4.pcr_factor_members",
                         "grid": "K4.pcr_factor"}[r]
                f_ms = min(cuda_ms(fn, 10) for _ in range(2))
                f_us, _ = launch_us(fn, entry, names=names)
                log_device(f"{entry} {label} {dt_name} (route {r}"
                           + f"{' (the plan)' if r == route else ''})", f_ms, f_us, b_ms,
                           red_bytes)
                if r == "members" and label == "config 5":
                    plain = lambda: pcr.pcr_factor_plain(fact.Lred, fact.Ured, plan.cyclic)
                    p_ms = min(cuda_ms(plain, 2) for _ in range(2))
                    times[dt_name]["K4.pcr_factor_members"] = (f_ms, p_ms, b_ms, "bytes", None)
            del fact, y, add, xm1, xp1
            torch.cuda.empty_cache()
        redesign_stencil(dtype, dt_name)
        redesign_J(dtype, dt_name)
        redesign_matvec(dtype, dt_name)
    return times


# ---- the chunked run: Simulation.run(device_chunk=n) through device_steps ----

#: output steps of the chunked fixed cells, and the chunk they run in
CHUNK_STEPS = 100
CHUNK = 50
#: (label, model, case, scheme kwargs) of the fixed cells of the chunked
#: run, on the graph route (K1-K5, K1-K4)
CHUNK_CASES = [
    ("ks N=10^6 rodaspr fixed", KS, ks_case(0.05, CHUNK_STEPS * 0.05, N_REF), FIXED),
    ("burgers N=10^6 theta", BURGERS, burgers_case(N_REF, 0.05, CHUNK_STEPS * 0.05), THETA),
]
#: the adaptive cell (K6's adaptive scan with snapshots): 8 output steps of
#: 1.0 in one chunk, and the failure run's chunk
ADAPTIVE_CHUNK = ("ks N=2^13 rodaspr adaptive tol 1e-3", KS, ks_case(1.0, 8.0, N_SMALL),
                  dict(tol=1e-3))
FAIL_CHUNK = 2


def chunk_sim(eqs, case, dtype, kwargs, t=0.0, fields=None, internal_dt=None):
    """A Simulation of the case on the card (from ``fields`` at ``t`` where
    given, its scheme's internal dt set where given) and the list its
    stream sink fills with (i, t, U, attempts, internal dt) of every
    emission."""
    fields_np, pars, dt, tmax, _ = case
    model = Model(*eqs, double=dtype == torch.float64)
    f0, pars_t = state_from_numpy(fields_np, pars, model)
    sim = Simulation(model, f0 if fields is None else fields, pars_t, dt=dt, t=t,
                     tmax=tmax, **kwargs)
    if internal_dt is not None:
        sim._scheme._internal_dt = internal_dt
    seen = []
    sim.stream.sink(lambda s: seen.append((s.i, s.t, s.fields["U"].clone(),
                                           getattr(s._scheme, "_internal_iter", None),
                                           getattr(s._scheme, "_internal_dt", None))))
    return sim, seen


def chunk_run(sim, seen, device_chunk, expect_failure=False):
    """Run ``sim`` with ``device_chunk`` and the launch counts set to 0
    just before: (emissions after the first, counts, seconds, the
    RuntimeError raised or None)."""
    torch.cuda.synchronize()
    _launch.reset_counters()
    start = time.perf_counter()
    failure = None
    try:
        sim.run(progress=False, device_chunk=device_chunk)
    except RuntimeError as exc:
        if not expect_failure:
            raise
        failure = exc
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    if expect_failure and (failure is None or sim.status != "failed"):
        raise RuntimeError(f"device_chunk={device_chunk}: no failure (status {sim.status})")
    return seen[1:], _launch.counts(), secs, failure


def same_emissions(label, a, b):
    """Raise unless two runs emitted the same i, t and U bit for bit."""
    if len(a) != len(b):
        raise RuntimeError(f"{label}: {len(a)} emissions against {len(b)}")
    for (ia, ta, ua, *_), (ib, tb, ub, *_) in zip(a, b):
        if (ia, ta) != (ib, tb) or not torch.equal(ua, ub):
            gap = float((ua.double() - ub.double()).abs().max())
            raise RuntimeError(f"{label}: emission {ia} (t={ta!r}) against {ib} "
                               f"(t={tb!r}): max|du| = {gap:.3e}")


def phase2_chunked(launches):
    """``Simulation.run(device_chunk=n)`` against the stepwise run on the
    card, f64 and f32: the fixed cells of ``CHUNK_CASES`` (the graph route,
    launch counts CHUNK_STEPS times one step's), the adaptive cell (K6's
    adaptive scan with snapshots, attempts per output step), the adaptive
    entry with snapshots against the one without, and a failure's prefix.
    Every emission bit for bit."""
    log("phase 2: the chunked run (Simulation.run(device_chunk=n), device_steps)")
    launches = dict(launches)
    for label, eqs, case, kwargs in CHUNK_CASES:
        for dt_name, dtype in DTYPES.items():
            sim_a, seen_a = chunk_sim(eqs, case, dtype, kwargs)
            a, counts_a, _, _ = chunk_run(sim_a, seen_a, 1)
            sim_b, seen_b = chunk_sim(eqs, case, dtype, kwargs)
            b, counts_b, _, _ = chunk_run(sim_b, seen_b, CHUNK)
            route = sim_b._scheme.steps_route
            same_emissions(f"{label} {dt_name}", a, b)
            per_step = {k: v // CHUNK_STEPS for k, v in counts_a.items() if v}
            off = {k: (counts_b[k], counts_a[k]) for k in KERNELS
                   if counts_b[k] != counts_a[k] or counts_a[k] % CHUNK_STEPS}
            log(f"  {label} {dt_name}: {len(b)} emissions bit for bit (i, t, U) against "
                f"the stepwise run; route {route}; launches per step "
                f"{json.dumps(per_step)}")
            if (route != "graph" or off or len(b) != CHUNK_STEPS or sim_b.i != sim_a.i
                    or sim_b.status != "finished" or not per_step):
                raise RuntimeError(f"{label} {dt_name}: route {route}, launches off "
                                   f"{CHUNK_STEPS} x one step's {off}, i {sim_b.i} "
                                   f"against {sim_a.i}, status {sim_b.status}")
            for k in KERNELS:
                launches[k] += counts_b[k]
    label, eqs, case, kwargs = ADAPTIVE_CHUNK
    n_out = int(round(case[3] / case[2]))
    for dt_name, dtype in DTYPES.items():
        sim_a, seen_a = chunk_sim(eqs, case, dtype, kwargs)
        a, _, _, _ = chunk_run(sim_a, seen_a, 1)
        sim_b, seen_b = chunk_sim(eqs, case, dtype, kwargs)
        b, counts_b, _, _ = chunk_run(sim_b, seen_b, n_out)
        scheme = sim_b._scheme
        att_a = [e[3] for e in a]
        same_emissions(f"{label} {dt_name}", a, b)
        log(f"  {label} {dt_name}: {len(b)} emissions bit for bit against the stepwise "
            f"run; attempts per output step {scheme.steps_attempts} (stepwise {att_a}); "
            f"route {scheme.steps_route}; launches "
            + json.dumps({k: v for k, v in counts_b.items() if v}))
        if (scheme.steps_route != "K6_adaptive" or scheme.steps_attempts != att_a
                or counts_b["K6.adaptive_snapshots"] != 1
                or sum(counts_b.values()) != 1):
            raise RuntimeError(f"{label} {dt_name}: route {scheme.steps_route}, "
                               f"attempts {scheme.steps_attempts} against {att_a}, "
                               f"launches {counts_b}")
        for k in KERNELS:
            launches[k] += counts_b[k]
        # the snapshot entry's final state against the entry without
        model, _, _, args, _ = path_inputs(eqs, case, dtype)
        plan = megastep.plan_for(N_SMALL, 1, 2, True)
        a_args = (adaptive_controller, model.backend, plan, kernel_checks.rodaspr_table(),
                  True, *args, 0.0, 1.0, 1e-6, 1e-3, 0.9, None, None, n_out)
        bare = megastep.adaptive_scan(*a_args)
        snap = megastep.adaptive_scan(*a_args, snapshots=True)
        if not (torch.equal(bare[0], snap[0]) and bare[1:] == snap[1:4]
                and torch.equal(snap[-1][0][-1], snap[0])):
            raise RuntimeError(f"{label} {dt_name}: the snapshot entry's final state "
                               "differs from the entry's without snapshots")
        log(f"  {label} {dt_name}: the snapshot entry's final u bit for bit the entry's "
            f"without snapshots ({n_out} output steps, {bare[1]} done)")
        # a failure at a known output step: from the stepwise run's state
        # after its first output step (where the ramp from the seed dt is
        # over), max_iter below the first later step that takes more
        # attempts than every step before it
        att = att_a[1:]
        k = next((j for j in range(1, len(att)) if att[j] > max(att[:j])), None)
        if k is None:
            raise RuntimeError(f"{label} {dt_name}: no output step to fail at in {att_a}")
        max_iter = max(att[:k])
        fields_1 = sim_a._scheme._model.fields_template(
            x=torch.as_tensor(case[0]["x"], dtype=dtype, device="cuda"), U=a[0][2])
        runs = []
        for device_chunk in (1, FAIL_CHUNK):
            # the stepwise run's internal dt after its first output step
            sim_f, seen_f = chunk_sim(eqs, case, dtype, dict(kwargs, max_iter=max_iter),
                                      t=a[0][1], fields=fields_1.copy(),
                                      internal_dt=a[0][4])
            runs.append(chunk_run(sim_f, seen_f, device_chunk, expect_failure=True)[0])
        same_emissions(f"{label} {dt_name} failure prefix", *runs)
        log(f"  {label} {dt_name}: max_iter={max_iter} fails at output step {k + 1}; both "
            f"runs raise RuntimeError with status failed after the same {len(runs[1])} "
            f"emissions, bit for bit (device_chunk={FAIL_CHUNK})")
        if len(runs[1]) != k:
            raise RuntimeError(f"{label} {dt_name}: {len(runs[1])} emissions before the "
                               f"failure, expected {k}")
    return launches


def chunk_scheme(eqs, case, dtype, kwargs):
    """(scheme, fields, parameters, dt) of a case on the card: the scheme
    ``Simulation`` builds from ``kwargs``."""
    fields_np, pars, dt, tmax, _ = case
    model = Model(*eqs, double=dtype == torch.float64)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax, **kwargs)
    return sim._scheme, sim.fields, pars_t, dt


def stepwise_ms(scheme, fields, pars, dt, n):
    """ms per output step of n calls of the scheme (host clock,
    synchronised)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    t, f = 0.0, fields
    for _ in range(n):
        t, f = scheme(t, f, dt, pars)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / n


def chunked_ms(scheme, fields, pars, dt, n):
    """ms per output step of one ``device_steps`` call of n steps."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    scheme.device_steps(0.0, fields, n, dt, pars)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / n


def log_idle(what, prof, per):
    if prof is None:
        log(f"    {what}: idle share not measured (the profiler recorded no device time)")
        return
    log(f"    {what}: device busy {prof['busy_us_per_step'] / per:.2f} us of a "
        f"{prof['span_us_per_step'] / per:.2f} us span per output step, idle share "
        f"{prof['idle_share']:.4f} (torch.profiler)")


def phase3_chunked(smi):
    """ms per output step of the stepwise loop against ``device_steps`` (the
    captured graph of CHUNK steps) on the fixed cells, per output step of
    the adaptive cell (the host controller's K6.adaptive launches against
    one K6.adaptive_snapshots launch), each window's idle share under
    torch.profiler, and K6.adaptive_snapshots' times against its plain
    version and its bound."""
    log(f"phase 3: the chunked run's times ({smi})")
    times = {dt_name: {} for dt_name in DTYPES}
    for label, eqs, case, kwargs in CHUNK_CASES:
        for dt_name, dtype in DTYPES.items():
            scheme, fields, pars, dt = chunk_scheme(eqs, case, dtype, kwargs)
            scheme(0.0, fields, dt, pars)
            scheme.device_steps(0.0, fields, CHUNK, dt, pars)
            s1, c1, c2, s2 = (fn(scheme, fields, pars, dt, CHUNK) for fn in (
                stepwise_ms, chunked_ms, chunked_ms, stepwise_ms))
            log(f"  {label} {dt_name}: {s1:.4f}/{s2:.4f} ms per step stepwise, "
                f"{c1:.4f}/{c2:.4f} ms per step chunked ({CHUNK} steps a graph replay; "
                f"host clock, synchronised; {smi})")
            log_idle("stepwise, 10 steps", profile_calls(
                lambda: scheme(0.0, fields, dt, pars), 10), 1)
            log_idle("chunked, one call of 10 steps", profile_calls(
                lambda: scheme.device_steps(0.0, fields, 10, dt, pars), 1), 10)
    label, eqs, case, kwargs = ADAPTIVE_CHUNK
    n_out = int(round(case[3] / case[2]))
    for dt_name, dtype in DTYPES.items():
        per = []
        for how in ("stepwise", "chunked", "chunked", "stepwise"):
            scheme, fields, pars, dt = chunk_scheme(eqs, case, dtype, kwargs)
            fn = stepwise_ms if how == "stepwise" else chunked_ms
            per.append(fn(scheme, fields, pars, dt, n_out))
        log(f"  {label} {dt_name}: {per[0]:.4f}/{per[3]:.4f} ms per output step stepwise "
            f"(K6.adaptive), {per[1]:.4f}/{per[2]:.4f} ms chunked (one "
            f"K6.adaptive_snapshots launch for {n_out} output steps; host clock, "
            f"synchronised; {smi})")
        # both windows: the n_out output steps from the initial state, the
        # internal dt from its seed
        scheme, fields, pars, dt = chunk_scheme(eqs, case, dtype, kwargs)

        def stepwise():
            scheme._internal_dt = None
            t, f = 0.0, fields
            for _ in range(n_out):
                t, f = scheme(t, f, dt, pars)

        def chunked():
            scheme._internal_dt = None
            scheme.device_steps(0.0, fields, n_out, dt, pars)

        log_idle(f"stepwise, {n_out} output steps", profile_calls(stepwise, 1), n_out)
        log_idle(f"chunked, one call of {n_out} output steps", profile_calls(chunked, 1),
                 n_out)
        # K6.adaptive_snapshots against its plain version and its bound
        model, _, _, args, _ = path_inputs(eqs, case, dtype)
        plan = megastep.plan_for(N_SMALL, 1, 2, True)
        table = kernel_checks.rodaspr_table()
        a_args = (adaptive_controller, model.backend, plan, table, True, *args, 0.0, 1.0,
                  1e-6, 1e-3, 0.9, None, None, n_out)
        got = megastep.adaptive_scan(*a_args, attempts=True, snapshots=True)
        attempts, done = got[4], got[1]

        def plain():
            snap = (torch.empty((n_out,) + tuple(args[0].shape), dtype=dtype,
                                device="cuda"),
                    np.zeros((n_out, megastep.SNAP_INFO)))
            return megastep.adaptive_scan_plain(*a_args, snap=snap)

        def kernel():
            return megastep.adaptive_scan(*a_args, snapshots=True)

        p1, k1, k2, p2 = (cuda_ms(fn, 1) for fn in (plain, kernel, kernel, plain))
        nbytes, ops = k6_work(model, plan, table, dtype, attempts)
        snap_bytes = done * args[0].numel() * args[0].element_size() \
            + done * megastep.SNAP_INFO * 8
        b_ms, b_by = bound(nbytes + snap_bytes, ops, dtype)
        times[dt_name]["K6.adaptive_snapshots"] = (min(k1, k2), min(p1, p2), b_ms, b_by,
                                                   None)
        log(f"  K6.adaptive_snapshots ks N=2^13 {n_out} output steps ({attempts} attempts) "
            f"{dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}: {nbytes + snap_bytes} bytes of which {snap_bytes} "
            f"the snapshots, {ops} operations; CUDA events)")
    return times


# ------------------------------------------------- the explicit RK family
#: example 05's wave equation as a first-order system (variables v, u)
WAVE = (["c**2 * dxxu", "v"], ["v", "u"], ["c"])
#: output step of the runs held to the CPU run at N = 10^6 (dx = 1e-5):
#: below DOPRI5's explicit stability limit there (about 8e-6), so every
#: attempt's err comes from the solution's truncation (far below tol) and
#: the decisions are the same on the card and the CPU.  At a longer output
#: step (ERK_LONG_DT) the adapted dt sits at the stability limit, where an
#: attempt's err comes from rounding noise that the step amplifies, which
#: the card (its F contracts multiply-adds) and the CPU round differently:
#: that run is counted and timed on the card alone (phase 3).
ERK_DT = 5e-6
ERK_LONG_DT = 1e-3
#: the tolerances of the adaptive ERK runs by dtype
ERK_TOL = {torch.float64: 1e-8, torch.float32: 1e-6}
#: (label, scheme, periodic, hook, output steps); the hook is example 05's
#: Dirichlet walls
ERK_CASES = [
    ("wave N=10^6 dopri5 periodic (FSAL loop)", schemes.DOPRI5, True, False, 4),
    ("wave N=10^6 dopri5 dirichlet (generic loop)", schemes.DOPRI5, False, True, 4),
    ("wave N=10^6 bs32 periodic (FSAL loop)", schemes.BS32, True, False, 4),
    ("wave N=10^6 rk4 periodic fixed", schemes.RK4, True, False, 20),
]
#: the ERK ensemble: B wave members at N, each with its own speed c from
#: 0.5 to 3 (the faster members' stability limit, about 0.85 dx / c, lies
#: below the output step ERK_LONG_DT, so their dt is their own)
ERK_B, ERK_B_N, ERK_B_STEPS = 64, N_REF_SMALL, 4


def wave_state(N, shift=0.0):
    x = np.linspace(0, 10, N, endpoint=False)
    return {"x": x, "v": np.zeros(N), "u": np.exp(-4 * (x - 5 - shift) ** 2)}


def wave_dirichlet(t, fields, pars):
    for key in ("v", "u"):
        fields[key][0] = 0.0
        fields[key][-1] = 0.0
    return fields, pars


def erk_f32_limit(steps):
    """The float32 runs' limit on v against the CPU f64 run at N = 10^6
    after ``steps`` steps of the first output step: a state rounded to
    float32 differs from the float64 one by up to d = max|u0 -
    float32(u0)| at a node, which excites the grid's fastest waves
    (frequency w = 2c/dx = 2e5) with a v of amplitude w d (about 6e-3:
    float32 cannot resolve u_xx at dx = 1e-5), whatever the scheme; the
    initial state and each step's result are rounded so, hence (steps + 1)
    w d.  u is held to 1e-4."""
    u0 = wave_state(N_REF)["u"]
    d = float(np.abs(u0 - u0.astype(np.float32)).max())
    return (steps + 1) * (2 * 1.0 / (10 / N_REF)) * d


def erk_scheme(cls, model, dtype):
    if cls is schemes.RK4:
        return cls(model)
    return cls(model, tol=ERK_TOL[dtype])


def erk_stage_launches(scheme):
    """K5 launches of one step of the scheme's tableau: one per stage whose
    input row has a nonzero coefficient, and the final one."""
    return sum(1 for i in range(1, scheme._s) if scheme._a[i, :i].any()) + 1


def erk_expected(scheme, attempts, fsal):
    """Exact K1.F and K5 launches of output steps of ``attempts`` attempts
    each (fixed steps: one per step): the FSAL loop evaluates s - 1 F per
    attempt and one per output step, the generic loop s per attempt."""
    s = scheme._s
    F = sum((s - 1) * a + 1 for a in attempts) if fsal else s * sum(attempts)
    return {"K1.F": F, "K5.combine": erk_stage_launches(scheme) * sum(attempts)}


def erk_run(case, device, dtype, n=None):
    """(u after the first output step, final u, attempts per output step,
    every attempt's err, launches) of an ERK case driven through the
    scheme's own call, the counts read over the run."""
    label, cls, periodic, hooked, steps = case
    n = steps if n is None else n
    model = Model(*WAVE, double=dtype == torch.float64, device=device)
    fields, pars = state_from_numpy(wave_state(N_REF), dict(periodic=periodic, c=1.0),
                                    model)
    scheme = erk_scheme(cls, model, dtype)
    errs, stages = [], scheme._stages

    def recording(*args, **kwargs):
        out = stages(*args, **kwargs)
        errs.append(float(out[1]))
        return out

    scheme._stages = recording
    hook = wave_dirichlet if hooked else schemes.null_hook
    attempts, first, t = [], None, 0.0
    _launch.reset_counters()
    for _ in range(n):
        t, fields = scheme(t, fields, ERK_DT, pars, hook)
        attempts.append(scheme._internal_iter or 1)
        if first is None:
            first = torch.stack([fields["v"], fields["u"]]).double().cpu()
    counts = _launch.counts()
    u = torch.stack([fields["v"], fields["u"]])
    return first, u, attempts, errs, counts, scheme


def erk_cpu_runs(conn):
    """The port's CPU f64 runs of each ``ERK_CASES`` case over its first
    output step, sent through ``conn``: {label: (u, attempts, s)}, or
    ("error", traceback)."""
    try:
        torch.set_num_threads(2)
        out = {}
        for case in ERK_CASES:
            start = time.perf_counter()
            first, _, attempts, _, _, _ = erk_run(case, "cpu", torch.float64, 1)
            out[case[0]] = (first.numpy(), attempts, time.perf_counter() - start)
        conn.send(out)
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase1_erk(errs):
    """K5 with the explicit RK family's rows (dt columns) bit for bit its
    plain version, f32 and f64: every stage input of RK4, BS32 and DOPRI5
    and their final rows (DOPRI5's two over u and all 7 stages, 8 arrays),
    at dts not exact in float32, on the wave state's shape at N = 10^6 and
    with a member axis at the ensemble's (64 x (2, 10^4)), a scalar dt and
    one dt per member (``combine_members_kernel``)."""
    log("phase 1: K5 with the explicit RK family's rows against its plain version")
    for dt_name, dtype in DTYPES.items():
        res = kernel_checks.check_erk_combines((2, N_REF), "cuda", dtype, seed=3)
        kernel_checks.check_erk_combines((2, ERK_B_N), "cuda", dtype, res, seed=4,
                                         B=ERK_B)
        kernel_checks.check_erk_combines((2, 777), "cuda", dtype, res, seed=5, B=3)
        log(f"  ERK rows {dt_name}: bit for bit; " + json.dumps(res))
        for name, err in res.items():
            errs[dt_name][name] = max(errs[dt_name].get(name, 0.0), err)
    return errs


def erk_member_runs(dtype, members):
    """The ERK ensemble on the card (B wave members at N, per-member dt,
    ERK_B_STEPS output steps of ERK_LONG_DT each) and the given members
    run alone: (ensemble, launches, attempts per step, {member: (u,
    attempts)})."""
    model = Model(*WAVE, double=dtype == torch.float64, device="cuda")
    rng = np.random.default_rng(7)
    shifts = rng.uniform(-1, 1, ERK_B)
    cs = np.linspace(0.5, 3.0, ERK_B)
    states = [wave_state(ERK_B_N, s) for s in shifts]
    u0 = np.stack([np.stack([st["v"], st["u"]]) for st in states])
    pars = [dict(periodic=True, c=float(c)) for c in cs]
    dt = ERK_LONG_DT
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, states[0]["x"], pars),
                   scheme=schemes.DOPRI5, tol=ERK_TOL[dtype], per_member_dt=True)
    _launch.reset_counters()
    per_step = []
    for _ in range(ERK_B_STEPS):
        ens.step(dt)
        per_step.append(ens.member_iters.copy())
    counts = _launch.counts()
    alone = {}
    for b in members:
        scheme = erk_scheme(schemes.DOPRI5, model, dtype)
        fields, p = state_from_numpy(states[b], pars[b], model)
        t, att = 0.0, 0
        for _ in range(ERK_B_STEPS):
            t, fields = scheme(t, fields, dt, p)
            att += scheme._internal_iter
        alone[b] = (torch.stack([fields["v"], fields["u"]]), att)
    return ens, counts, per_step, alone


def erk_container_run(dtype):
    """The wave DOPRI5 run (4 output steps of ERK_DT) through Simulation with
    an in-memory container, checkpointed after 2 steps and resumed: (the
    uninterrupted run, the resumed one, how the checkpoint was taken)."""
    from triflow_tpu_torch.utils import checkpoint

    model = Model(*WAVE, double=dtype == torch.float64, device="cuda")

    def simulation():
        fields, pars = state_from_numpy(wave_state(N_REF), dict(periodic=True, c=1.0),
                                        model)
        return Simulation(model, fields, pars, dt=ERK_DT, tmax=4 * ERK_DT,
                          scheme=schemes.DOPRI5, tol=ERK_TOL[dtype])

    full = simulation()
    full.attach_container(None)
    full.run(progress=False)
    first = simulation()
    for _ in range(2):
        next(first)
    if importlib.util.find_spec("h5py") is not None:
        path = Path("build") / f"erk_checkpoint_{str(dtype)[6:]}.h5"
        first.save_checkpoint(path)
        resumed = Simulation.from_checkpoint(path, model, scheme=schemes.DOPRI5,
                                             tol=ERK_TOL[dtype])
        how = f"through {path}"
    else:
        attrs, fields = checkpoint.checkpoint_state(first)
        resumed = checkpoint.simulation_from_state(attrs, fields, model,
                                                   scheme=schemes.DOPRI5,
                                                   tol=ERK_TOL[dtype])
        how = ("in memory (checkpoint_state / simulation_from_state: h5py is not "
               "installed here, so the HDF5 file itself is not written on the card)")
    resumed.run(progress=False)
    return full, resumed, how


def phase2_erk(launches):
    """The explicit RK family through the port's entry points on the card,
    f64 and f32, each run with the counts set to 0 just before it: the wave
    model of example 05 at N = 10^6 (DOPRI5's FSAL loop, its generic loop
    under the Dirichlet hook, BS32, RK4 at a fixed dt under the stability
    limit), exact K1.F and K5 launches per attempt, no other kernel, each
    against the port's CPU f64 run over its first output step; RK4 through
    ``device_steps`` (the graph route) bit for bit its stepwise run; B = 64
    wave members at N = 10^4 with per-member dt (stability-limited), members
    bit for bit their single-grid runs on the card; ``scipy_ode`` (vode, and
    vode's BDF with the Jacobian) on the README model at N = 200 against the
    CPU run; a Simulation with a container and a checkpoint, the resumed
    run bit for bit the uninterrupted one."""
    log(f"phase 2: the explicit RK family (wave N = 10^6, output steps of {ERK_DT}: "
        "under DOPRI5's stability limit there, so every err is far below tol)")
    launches = dict(launches)
    refs = cpu_refs("erk")
    for case in ERK_CASES:
        label, cls, periodic, hooked, steps = case
        for dt_name, dtype in DTYPES.items():
            first, u, attempts, errs, counts, scheme = erk_run(case, "cuda", dtype)
            fixed = cls is schemes.RK4
            fsal = not fixed and scheme._fsal(wave_dirichlet if hooked else
                                              schemes.null_hook)
            want = erk_expected(scheme, attempts if not fixed else [1] * steps, fsal)
            off = {k: counts[k] for k in KERNELS if counts[k] != want.get(k, 0)}
            u_ref, att_ref, secs = refs[label]
            gaps = np.abs(first.numpy() - u_ref).max(axis=1)
            gap = float(gaps.max())
            lim = 1e-10 if dtype == torch.float64 else erk_f32_limit(attempts[0])
            tol = None if fixed else ERK_TOL[dtype]
            margin = None if fixed else min(abs(e / tol - 1.0) for e in errs)
            log(f"  {label} {dt_name}: attempts {attempts} (CPU f64 first output step "
                f"{att_ref}, {secs:.1f} s), launches {json.dumps(want)}; first output "
                f"step against the CPU f64 run: v {gaps[0]:.3e}, u {gaps[1]:.3e} (limit "
                f"{lim:.3e}{', u 1e-4' if dtype == torch.float32 else ''}); largest "
                f"err/tol {max(errs) / tol if tol else 0:.3e}, margin to tol "
                f"{margin if margin is not None else 'n/a'}")
            if (off or not torch.isfinite(u).all() or gap > lim
                    or (dtype == torch.float32 and gaps[1] > 1e-4)
                    or (dtype == torch.float64 and attempts[:1] != att_ref[:1])
                    or (margin is not None and margin <= 1e-6)):
                raise RuntimeError(f"{label} {dt_name}: launches off {off}, gap {gap}, "
                                   f"attempts {attempts} against {att_ref}, margin "
                                   f"{margin}")
            for k in KERNELS:
                launches[k] += counts[k]
    # RK4 through device_steps (the captured graph) against its stepwise run
    for dt_name, dtype in DTYPES.items():
        runs = []
        for chunk in (1, 10):
            model = Model(*WAVE, double=dtype == torch.float64, device="cuda")
            fields, pars = state_from_numpy(wave_state(N_REF), dict(periodic=True, c=1.0),
                                            model)
            sim = Simulation(model, fields, pars, dt=ERK_DT, tmax=20 * ERK_DT,
                             scheme=schemes.RK4, time_stepping=False)
            _launch.reset_counters()
            sim.run(progress=False, device_chunk=chunk)
            runs.append((sim, _launch.counts()))
        (a, ca), (b, cb) = runs
        same = torch.equal(a.fields["u"], b.fields["u"]) and torch.equal(
            a.fields["v"], b.fields["v"])
        off = {k: (cb[k], ca[k]) for k in KERNELS if cb[k] != ca[k]}
        log(f"  wave N=10^6 rk4 device_chunk=10 {dt_name}: route "
            f"{b._scheme.steps_route}, {b.i} steps, "
            f"{'bit for bit' if same else 'NOT bit for bit'} the stepwise run; launches "
            + json.dumps({k: v for k, v in cb.items() if v}))
        if not same or off or b._scheme.steps_route != "graph" or cb["K1.F"] != 80:
            raise RuntimeError(f"rk4 device_steps {dt_name}: same {same}, launches off "
                               f"{off}, route {b._scheme.steps_route}")
        for k in KERNELS:
            launches[k] += cb[k]
    # B = 64 wave members with per-member dt against their single-grid runs
    members = (0, ERK_B // 3, 2 * ERK_B // 3, ERK_B - 1)
    for dt_name, dtype in DTYPES.items():
        ens, counts, per_step, alone = erk_member_runs(dtype, members)
        iters = sum(int(it.max()) for it in per_step)
        want = {"K1.F": 7 * iters, "K5.combine_members": 7 * iters}
        off = {k: counts[k] for k in KERNELS if counts[k] != want.get(k, 0)}
        bad = [b for b in members if not torch.equal(ens.u[b], alone[b][0])
               or sum(int(it[b]) for it in per_step) != alone[b][1]]
        spread = ", ".join(f"{int(it.min())}..{int(it.max())}" for it in per_step)
        log(f"  wave B={ERK_B} x N=10^4 dopri5 per-member dt ({ERK_B_STEPS} x "
            f"{ERK_LONG_DT}) {dt_name}: member attempts per output step {spread}; "
            f"launches "
            f"{json.dumps(want)}; members {members} "
            f"{'bit for bit' if not bad else 'NOT bit for bit'} their single-grid runs "
            f"with the same attempts")
        if off or bad or not torch.isfinite(ens.u).all():
            raise RuntimeError(f"erk ensemble {dt_name}: launches off {off}, members "
                               f"off {bad}")
        for k in KERNELS:
            launches[k] += counts[k]
    # scipy_ode on the README model, on the card against the CPU
    for jac, kw in ((False, {}), (True, {"method": "bdf"})):
        outs = {}
        for device in ("cuda", "cpu"):
            fields_np, pars, dt, _, hook = readme_case()
            model = Model(*README, device=device)
            fields, pars_t = state_from_numpy(fields_np, pars, model)
            scheme = schemes.scipy_ode(model, jac=jac, atol=1e-10, rtol=1e-10,
                                       nsteps=100000, **kw)
            _launch.reset_counters()
            t = 0.0
            for _ in range(2):
                t, fields = scheme(t, fields, dt, pars_t, hook)
            outs[device] = (fields["U"].double().cpu().numpy(), _launch.counts())
        gap = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
        counts = outs["cuda"][1]
        log(f"  readme N=200 scipy_ode vode{'/bdf with jac' if jac else ''} f64: "
            f"against the CPU run {gap:.3e}; launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
        if (gap > 1e-8 or counts["K1.F"] < 1 or (jac and counts["K1.J"] < 1)
                or any(counts[k] for k in KERNELS if k not in ("K1.F", "K1.J"))):
            raise RuntimeError(f"scipy_ode jac={jac}: gap {gap}, launches {counts}")
        for k in KERNELS:
            launches[k] += counts[k]
    # a container and a checkpoint
    for dt_name, dtype in DTYPES.items():
        _launch.reset_counters()
        full, resumed, how = erk_container_run(dtype)
        counts = _launch.counts()
        data = full.container.data
        same = all(torch.equal(full.fields[k], resumed.fields[k]) for k in ("u", "v"))
        frame = np.array_equal(data["u"][-1], full.fields["u"].cpu().numpy())
        log(f"  wave N=10^6 dopri5 Simulation with a container, checkpointed after 2 "
            f"of 4 output steps {how} {dt_name}: {len(data.t)} frames, the last "
            f"{'equal to' if frame else 'NOT equal to'} the final state; the resumed run "
            f"{'bit for bit' if same else 'NOT bit for bit'} the uninterrupted one")
        if not same or not frame or len(data.t) != 5 or resumed.i != 4:
            raise RuntimeError(f"container/checkpoint {dt_name}: same {same}, frame "
                               f"{frame}, frames {len(data.t)}, i {resumed.i}")
        for k in KERNELS:
            launches[k] += counts[k]
    log("  launches over phase 2: " + json.dumps(launches))
    return launches


def erk_attempt_bytes(scheme, N, nvar, itemsize):
    """Bytes one FSAL attempt must move (each input read once, each output
    written once): per F its state, parameter row and x in, F out; per
    stage input and the final call their arrays in and rows out; the error
    row read once for its max."""
    s = scheme._s
    F = (s - 1) * (nvar + 1 + 1 + nvar) * N
    stage = sum(1 + np.count_nonzero(scheme._a[i, :i]) + 1 for i in range(1, s)) * nvar * N
    cols = 1 + np.count_nonzero((scheme._b != 0) | (scheme._b != scheme._b_pred))
    final = (cols + 2) * nvar * N
    return (F + stage + final + nvar * N) * itemsize


def phase3_erk(smi):
    """DOPRI5 at N = 10^6, f32 and f64: ms per FSAL attempt (the
    controller's work: its stages and one err read) and cell updates per
    second, K1.F and K5 device µs and the idle share under torch.profiler,
    the attempt's bytes bound; one stability-limited adaptive output step
    (f64, output dt ERK_LONG_DT) with its exact launches; K5's dt entry (the
    final two rows) and its members body against their plain versions,
    bounds and one PyTorch call; RK4 stepwise against the graph route with
    each window's idle share."""
    log(f"phase 3: the explicit RK family ({smi})")
    times = {name: {} for name in DTYPES}
    for dt_name, dtype in DTYPES.items():
        model = Model(*WAVE, double=dtype == torch.float64, device="cuda")
        fields, pars = state_from_numpy(wave_state(N_REF), dict(periodic=True, c=1.0),
                                        model)
        scheme = schemes.DOPRI5(model, tol=ERK_TOL[dtype])
        problem = scheme._problem(schemes.null_hook, True)
        u, h, p, x = scheme._split(fields, pars)
        k1 = problem.F(u, h, p, x)
        T = scheme._dt_type

        def attempt():
            return T(scheme._stages(problem, u, h, p, x, ERK_DT, k1)[1].item())

        attempt()
        torch.cuda.synchronize()
        n_att = 50
        start = time.perf_counter()
        for _ in range(n_att):
            attempt()
        ms = (time.perf_counter() - start) * 1e3 / n_att
        nbytes = erk_attempt_bytes(scheme, N_REF, 2, u.element_size())
        b_ms, b_by = bound(nbytes, 0, dtype)
        prof = profile_calls(attempt, 10)
        log(f"  dopri5 FSAL attempt N=10^6 {dt_name}: {ms:.4f} ms per attempt (host "
            f"clock, synchronised by its err read), {N_REF / ms * 1e3:.4e} cell updates "
            f"per second; bound {b_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s), "
            f"{b_ms / ms:.3f} of it")
        log_profile("dopri5 FSAL attempt N=10^6", dt_name, prof)
        # K5's dt entry: the final two rows over u and 6 stages
        rows = [r for r in kernel_checks.erk_rows(scheme._a, scheme._b,
                                                  scheme._b_pred)][-1]
        cols = [0] + [j + 1 for j in range(7) if rows[0][j + 1] or rows[1][j + 1]]
        rows = [[r[j] for j in cols] for r in rows]
        rng = np.random.default_rng(9)
        arrays = [torch.tensor(rng.standard_normal((2, N_REF)), dtype=dtype,
                               device="cuda") for _ in cols]
        dt_cols = tuple(range(1, len(cols)))
        k_ms = cuda_ms(lambda: combine.combine(rows, arrays, ERK_DT, dt_cols), 50)
        p_ms = cuda_ms(lambda: combine.combine_plain(rows, arrays, ERK_DT, dt_cols), 20)
        stacked = torch.stack([a.reshape(-1) for a in arrays])
        coef = torch.tensor([[c * (ERK_DT if j else 1.0) for j, c in enumerate(r)]
                             for r in rows], dtype=dtype, device="cuda")
        l_ms = cuda_ms(lambda: torch.mm(coef, stacked), 50)
        kb = (len(cols) + 2) * 2 * N_REF * u.element_size()
        kb_ms, kb_by = bound(kb, 2 * len(cols) * 2 * 2 * N_REF, dtype)
        log(f"  K5 dt entry (DOPRI5 final rows, {len(cols)} arrays of (2, 10^6)) "
            f"{dt_name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.mm "
            f"{l_ms:.4f} ms, bound {kb_ms:.4f} ms ({kb_by}; CUDA events)")
        # the members body at the ensemble's shapes
        arrays = [torch.tensor(rng.standard_normal((ERK_B, 2, ERK_B_N)), dtype=dtype,
                               device="cuda") for _ in cols]
        dts = torch.tensor(ERK_DT * (1 + rng.random(ERK_B)), dtype=dtype, device="cuda")
        m_ms = cuda_ms(lambda: combine.combine(rows, arrays, dts, dt_cols), 50)
        mp_ms = cuda_ms(lambda: combine.combine_plain(rows, arrays, dts, dt_cols), 20)
        stacked = torch.stack([a.reshape(ERK_B, -1) for a in arrays], dim=1)
        mcoef = torch.stack([torch.stack([
            (c * dts) if j else torch.full_like(dts, c) for j, c in enumerate(r)], dim=1)
            for r in rows], dim=1)
        ml_ms = cuda_ms(lambda: torch.bmm(mcoef, stacked), 50)
        mb = (len(cols) + 2) * ERK_B * 2 * ERK_B_N * u.element_size()
        mb_ms, mb_by = bound(mb, 2 * len(cols) * 2 * ERK_B * 2 * ERK_B_N, dtype)
        log(f"  K5.combine_members (DOPRI5 final rows, B={ERK_B} x (2, 10^4), one dt "
            f"per member) {dt_name}: kernel {m_ms:.4f} ms, plain {mp_ms:.4f} ms, "
            f"torch.bmm {ml_ms:.4f} ms, bound {mb_ms:.4f} ms ({mb_by}; CUDA events)")
        times[dt_name]["K5.combine_members"] = (m_ms, mp_ms, mb_ms, mb_by, ml_ms)
        # RK4 stepwise against the graph route
        rk4 = schemes.RK4(model)
        n = 20
        rk4.device_steps(0.0, fields, n, ERK_DT, pars)  # captures the graph
        s_ms = stepwise_ms(rk4, fields, pars, ERK_DT, n)
        g_ms = chunked_ms(rk4, fields, pars, ERK_DT, n)
        route = rk4.steps_route
        log(f"  rk4 N=10^6 {dt_name}: stepwise {s_ms:.4f} ms per step, device_steps "
            f"({route}) {g_ms:.4f} ms per step")
        log_idle(f"rk4 stepwise {dt_name}",
                 profile_calls(lambda: rk4(0.0, fields, ERK_DT, pars), n), 1)
        log_idle(f"rk4 device_steps {dt_name}",
                 profile_calls(lambda: rk4.device_steps(0.0, fields, n, ERK_DT, pars), 2),
                 n)
    # the stability-limited adaptive output step, f64
    model = Model(*WAVE, double=True, device="cuda")
    fields, pars = state_from_numpy(wave_state(N_REF), dict(periodic=True, c=1.0), model)
    scheme = schemes.DOPRI5(model, tol=ERK_TOL[torch.float64])
    t, fields = scheme(0.0, fields, ERK_DT, pars)
    _launch.reset_counters()
    torch.cuda.synchronize()
    start = time.perf_counter()
    t, fields = scheme(t, fields, ERK_LONG_DT, pars)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    att = scheme._internal_iter
    counts = _launch.counts()
    want = erk_expected(scheme, [att], True)
    log(f"  dopri5 N=10^6 f64 stability-limited output step of {ERK_LONG_DT}: {att} "
        f"attempts, {secs * 1e3 / att:.4f} ms per attempt (the controller included), "
        f"adapted dt {scheme._internal_dt:.4e}; launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    if any(counts[k] != want.get(k, 0) for k in KERNELS) or not all(
            torch.isfinite(fields[k]).all() for k in ("u", "v")):
        raise RuntimeError(f"stability-limited dopri5: launches {counts}, want {want}")
    return times


# ---------------------------------------------------------------- spatial sharding

#: the reference's 8-device mesh on the card: one grid cut into shards
SPACE_AXIS = ("space",)
#: the Woodbury ring: KS on 999996 nodes over 6 shards of 166666 (an even
#: shard, no padding; a ring of 6 shards, no power of two)
N_RING6 = 999996
#: dp x sp: B Burgers members of N_DPSP nodes on a (2, 4) mesh of
#: ("ensemble", "space")
DPSP_B, DPSP_N, DPSP_MESH = 16, 1 << 16, (2, 4)
DPSP_BURGERS = ("k * dxxU - U * dxU", "U", "k")


def space_mesh(ndev, device="cuda"):
    return Mesh.on(device, ndev, SPACE_AXIS)


def advdiff_erk_case(N=N_BIG, dt=1e-5, tmax=2e-5):
    """The reference's sharded DOPRI5 model (``k * dxxU - c * dxU``) on
    [0, 10) at N nodes, c = 0.5 and k = 1e-7, with output steps of 1e-5:
    under the explicit limits at dx = 10 / N (advection ~6e-5, diffusion
    ~7e-4 at N = 2^20), so each attempt's err is the truncation error of a
    smooth field, not amplified rounding; the spacing is exact in binary,
    so every shard's dx is the whole grid's."""
    x = np.linspace(0, 10, N, endpoint=False)
    return ({"x": x, "U": np.cos(2 * np.pi * x / 10) + 0.1 * np.sin(2 * np.pi * x * 64 / 10)},
            dict(periodic=True, k=1e-7, c=0.5), dt, tmax, None)


def readme_edge_case(N=N_REF, steps=2):
    """The README case tiled to N nodes at about its own spacing (2^-8
    against 1 / 199) and its wavelength, ``steps`` output steps.  I - 5 J
    keeps about the README grid's condition (10^3); on [0, 1] at N = 10^6
    (dx = 1e-6) it would be about 10^10, and any two solvers of it differ by
    eps times that.  x = i 2^-8 is exact in float32 as in float64, so every
    shard's x[1] - x[0] is the whole grid's dx: in float32 a grid whose x
    takes 20 bits leaves a shard's difference of two x values a few bits
    (the reference's shards take dx that way too)."""
    fields, pars, dt, _, hook = readme_case()
    x = np.arange(N) * 2.0 ** -8
    return {"x": x, "U": np.cos(2 * np.pi * x * 5)}, pars, dt, steps * dt, hook


#: (label, equations, case, shards, scheme kwargs, f32 limit against the CPU
#: f64 sharded run, kind): kind "rodaspr" / "theta" / "dopri5" / "ros2
#: mixed"; ``tol`` None in the kwargs of "dopri5" takes ERK_TOL by dtype
SPATIAL_CASES = [
    ("ks N=2^20 8 shards rodaspr fixed (2 x 0.05)", KS, ks_case(0.05, 0.1), 8,
     FIXED, 1e-4, "rodaspr"),
    ("ks N=2^20 8 shards rodaspr adaptive tol 1e-3 (1 x 1.0)", KS, ks_case(1.0, 1.0), 8,
     dict(tol=1e-3), 1e-2, "rodaspr"),
    ("ks N=2^20 8 shards rodaspr fixed refine=1 (2 x 0.05)", KS, ks_case(0.05, 0.1), 8,
     REFINED, 1e-4, "rodaspr"),
    ("ks N=999996 6 shards rodaspr fixed (2 x 0.05), woodbury ring", KS,
     ks_case(0.05, 0.1, N_RING6), 6, FIXED, 1e-4, "rodaspr"),
    ("readme N=10^6 8 shards theta, edge, dirichlet (2 x 5.0)", README,
     readme_edge_case(), 8, THETA, 1e-4, "theta"),
    ("advdiff N=2^20 8 shards dopri5 (2 x 1e-5)", README, advdiff_erk_case(), 8,
     dict(scheme=schemes.DOPRI5, tol=None), 1e-4, "dopri5"),
]
#: df64: KS 2^20 over 8 shards, ROS2 with df64_mixed_solve=2 at a dt exact
#: in float32, against the card's double=True single grid
SPATIAL_DF64 = ("ks N=2^20 8 shards df64 ros2 df64_mixed_solve=2 (2 x 0.0625)", KS,
                ks_case(0.0625, 0.125), 8,
                dict(scheme=schemes.ROS2, time_stepping=False, df64_mixed_solve=2))
#: dp x sp: (label, scheme kwargs, output steps of dt, dtypes).  The
#: reference's tol 1e-6 runs in float64 only (float32's rounding of a
#: stage difference is not far below it); the fixed ROS2 case runs in both
DPSP_CASES = [
    ("dp x sp burgers B=16 N=2^16 (2, 4) rodaspr tol 1e-6 per_member_dt (1 x 0.5)",
     dict(scheme=schemes.RODASPR, tol=1e-6, per_member_dt=True), 1, 0.5, ("float64",)),
    ("dp x sp burgers B=16 N=2^16 (2, 4) ros2 fixed (2 x 0.05)",
     dict(scheme=schemes.ROS2), 2, 0.05, ("float64", "float32")),
]


def spatial_kwargs(kwargs, dtype):
    kw = dict(kwargs)
    if kw.get("scheme") is schemes.DOPRI5 and kw.get("tol") is None:
        kw["tol"] = ERK_TOL[dtype]
    return kw


def spatial_run(eqs, case, ndev, kwargs, device, dtype, double=None, device_chunk=None):
    """(simulation, final u, attempts per output step, emissions) of a case
    through ``Simulation(mesh=)`` (ndev shards; None: the single grid);
    emissions are (t, u) of every output step."""
    fields_np, pars, dt, tmax, hook = case
    double = dtype == torch.float64 if double is None else double
    model = Model(*eqs, double=double, device=device)
    fields, pars_t = state_from_numpy(fields_np, pars, model)
    mesh = None if ndev is None else space_mesh(ndev, device)
    sim = Simulation(model, fields, pars_t, dt=dt, tmax=tmax, mesh=mesh,
                     hook=hook or schemes.null_hook, **spatial_kwargs(kwargs, dtype))
    seen, attempts = [], []
    sim.stream.sink(lambda s: seen.append((s.t, s.fields["U"].clone())))
    if device_chunk:
        sim.run(progress=False, device_chunk=device_chunk)
    else:
        for _ in sim:
            attempts.append(getattr(sim._scheme, "_internal_iter", None))
    if sim.status != "finished":
        raise RuntimeError(f"simulation ended at t={sim.t} with status {sim.status}")
    return sim, sim.fields["U"], attempts, seen[1:]


def dpsp_state(B=DPSP_B, N=DPSP_N):
    """The sweep of the reference's dp x sp tests (B Burgers members, k
    from 0.5 to 2, random phases) tiled to N nodes at its spacing, 10 / 256:
    on [0, 10) at N = 2^16 I - g00 dt J would have a condition of about
    10^7, past what float32 solves."""
    x = np.linspace(0, 10 * N / 256, N, endpoint=False)
    rng = np.random.RandomState(0)
    u0 = np.stack([np.cos(2 * np.pi * x / 10 + phi) for phi in rng.rand(B)])
    pars = [dict(k=float(k), periodic=True) for k in np.linspace(0.5, 2.0, B)]
    return x, u0, pars


def dpsp_run(kwargs, steps, dt, device, dtype, mesh=True):
    """The dp x sp ensemble (or, ``mesh=False``, the unsharded one) after
    ``steps`` calls of ``step(dt)``: (ensemble, member attempts per call)."""
    x, u0, pars = dpsp_state()
    model = Model(*DPSP_BURGERS, double=dtype == torch.float64, device=device)
    kw = dict(kwargs)
    if mesh:
        kw.update(mesh=Mesh.on(device, DPSP_MESH, ("ensemble", "space")),
                  space_axis="space")
    ens = Ensemble(model, **ensemble_from_numpy(model, u0, x, pars), **kw)
    iters = []
    for _ in range(steps):
        ens.step(dt)
        iters.append(None if ens.member_iters is None else ens.member_iters.tolist())
    return ens, iters


def spatial_cpu_runs(conn):
    """The port's CPU f64 sharded runs of the spatial cases (and the df64
    and dp x sp ones), sent through ``conn``: {label: (u, attempts, s)}, or
    ("error", traceback)."""
    try:
        torch.set_num_threads(2)
        out = {}
        for label, eqs, case, ndev, kwargs, _, _ in SPATIAL_CASES:
            start = time.perf_counter()
            _, u, attempts, _ = spatial_run(eqs, case, ndev, kwargs, "cpu", torch.float64)
            out[label] = (u.numpy(), attempts, time.perf_counter() - start)
        label, eqs, case, ndev, kwargs = SPATIAL_DF64
        start = time.perf_counter()
        _, u, _, _ = spatial_run(eqs, case, ndev, kwargs, "cpu", torch.float64, "df64")
        out[label] = (u.numpy(), [], time.perf_counter() - start)
        for label, kwargs, steps, dt, _ in DPSP_CASES:
            start = time.perf_counter()
            ens, iters = dpsp_run(kwargs, steps, dt, "cpu", torch.float64)
            out[label] = (ens.u.numpy(), iters, time.perf_counter() - start)
        conn.send(out)
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def shard_launches(splan, factors, solves, F=0, F_terms=0, K8=0):
    """The launches of ``factors`` distributed factorizations and ``solves``
    solves of ``parallel.spatial`` on ``splan`` (``F`` / ``F_terms`` K1
    shard launches, ``K8`` mixed residuals beside them): per factor K1.J,
    the local factor (K2, K4), 2P spike columns through the local solve
    (K3, K4, K3), the interface factor over the shards (K4, with the
    Woodbury set-up on a ring that is not block-cyclic); per solve the
    local solve and the interface's solve with shifts (K4) and correction
    (K3)."""
    lp, ip = splan.local, splan.iface
    want = dict.fromkeys(KERNELS, 0)

    def n(name, s):
        return kernel_checks.solver_entry(name, s)

    local = solves + 2 * ip.s * factors
    for name, count in ((n("K2.spike_factor", lp.s), factors),
                        (kernel_checks.factor_entry(lp.s, lp.C), factors),
                        (n("K3.thomas_sweep", lp.s), local),
                        (n("K4.pcr_solve_shift", lp.s), local),
                        (n("K3.spike_correct", lp.s), local),
                        (kernel_checks.factor_entry(ip.s, ip.C), factors),
                        (n("K4.pcr_solve_shift", ip.s), solves),
                        (n("K3.spike_correct", ip.s), solves),
                        ("K1.J_shards", factors), ("K1.F_shards", F),
                        ("K1.F_terms_shards", F_terms), ("K8.residual", K8)):
        want[name] += count
    if ip.woodbury:
        cols = ("K4.pcr_solve_members" if pcr.cols_route(2 * ip.s, ip.C, ip.B) == "members"
                else n("K4.pcr_solve", ip.s))
        want[cols] += factors
    return want


def spatial_plan(eqs, N, ndev, periodic, B=1):
    sysm = Model(*eqs, device="cpu").system
    return spatial.shard_plan(N, sysm.nvar, sysm.halo, ndev, periodic, B)


def expected_spatial(kind, splan, attempts, k5_per_attempt, passes=0, refine=0):
    """A sharded case's launches from its plan and attempts (stages of
    RODASPR 6, ROS2 2, DOPRI5 7 F and no solve, Theta 1 F and 1 solve;
    ``refine`` more solves and K7 residuals a stage); K5 per attempt as the
    single grid's run of the same scheme launched it."""
    if kind == "dopri5":
        want = dict.fromkeys(KERNELS, 0)
        want["K1.F_shards"] = 7 * attempts
    else:
        stages = {"rodaspr": 6, "ros2": 2, "theta": 1}[kind.split()[0]]
        solves = stages * attempts * (1 + passes) * (1 + refine)
        want = shard_launches(splan, attempts, solves, F=stages * attempts,
                              K8=stages * attempts * passes)
        want["K7.matvec"] = stages * attempts * refine
    want["K5.combine"] = round(k5_per_attempt * attempts)
    return want


def attempts_of(attempts, steps):
    """Attempts of a run: the sum of its output steps' (adaptive), else one
    a step."""
    return sum(attempts) if any(attempts) else steps


def phase1_spatial(errs):
    """Every kernel the spatial path launches on a shard axis against its
    plain version (``kernel_checks.check_all_shards`` at small shapes, then
    at the path's own: K1's shard entries and the distributed
    factorization's K2-K4 at KS 2^20 over 8 shards, the Woodbury ring of 6,
    the README grid's 10^6 over 8 in edge mode and dp x sp's 16 members of
    2^16 over 4), f64 and f32."""
    log("phase 1: the spatial path's kernels on the shard axis against their plain "
        "versions")
    for dt_name, dtype in DTYPES.items():
        res = kernel_checks.check_all_shards("cuda", dtype)
        path = [(KS, N_BIG, 8, True, None), (KS, N_RING6, 6, True, None),
                (README, N_REF, 8, False, None),
                (DPSP_BURGERS, DPSP_N, DPSP_MESH[1], True, DPSP_B)]
        for i, (eqs, N, ndev, periodic, B) in enumerate(path):
            model = Model(*eqs, double=dtype == torch.float64, device="cuda")
            b = model.backend
            args = kernel_checks.shard_inputs(model, N, B, "cuda", seed=10 + i)
            what = f"{eqs[0]} N={N} shards={ndev} periodic={periodic} B={B}"
            kernel_checks.check_shard_stencil(model, *args, periodic, ndev, what, res)
            bands = b.J_bands(*args, periodic=periodic, shards=ndev)
            beta0 = -0.5 / float(bands.abs().amax())
            beta = (beta0 if B is None else
                    torch.tensor(beta0 * (1 + np.arange(B)) / B, dtype=dtype, device="cuda"))
            splan = spatial.shard_plan(N, b.system.nvar, b.halo, ndev, periodic,
                                       1 if B is None else B)
            kernel_checks.check_shard_solver(bands, beta, splan, seed=i, results=res)
            log(f"  {what}: local plan C={splan.local.C} Mc={splan.local.Mc} "
                f"padded={splan.local.padded}, interface cyclic={splan.iface.cyclic} "
                f"woodbury={splan.iface.woodbury}: held")
        log(f"  shard checks {dt_name}: " + json.dumps(res))
        for name, err in res.items():
            errs[dt_name][name] = max(errs[dt_name].get(name, 0.0), err)
    return errs


def phase2_spatial(launches):
    """The sharded paths through the port's entry points on the card, f64 and
    f32, each run with the counts set to 0 just before it:
    ``Simulation(mesh=)`` on KS 2^20 over 8 shards (fixed and adaptive
    RODASPR, and ``refine=1``: K7 on the global bands), the Woodbury ring (KS 999996 over 6), the README grid at 10^6
    over 8 in edge mode with its Dirichlet hook (Theta) and DOPRI5 at 2^20
    over 8; each against the card's single grid (f64 within 1e-9 of max|u|,
    f32 within 1e-4; DOPRI5 bit for bit: the same F, no solve) and the
    port's CPU f64 sharded run (f64 within 1e-10 and the same attempts),
    with its launches the plan's; the fixed KS case's ``run(device_chunk=2)``
    bit for bit its stepwise run on the graph route; the df64 mode (ROS2,
    df64_mixed_solve=2) against the card's double=True single grid (1e-11)
    and its CPU run; dp x sp (RODASPR per_member_dt, ROS2) against the
    unsharded ensemble on the card (member attempts equal) and the CPU."""
    log("phase 2: spatial sharding through Simulation(mesh=) and Ensemble(space_axis=)")
    refs = cpu_refs("spatial")
    for label, eqs, case, ndev, kwargs, tol32, kind in SPATIAL_CASES:
        fields_np, pars, dt, tmax, _ = case
        N = len(fields_np["x"])
        splan = spatial_plan(eqs, N, ndev, pars["periodic"])
        u_cpu, att_cpu, cpu_s = refs[label]
        scale = float(np.abs(u_cpu).max())
        log(f"  {label}: local plan C={splan.local.C} Mc={splan.local.Mc} padded="
            f"{splan.local.padded}, interface C={splan.iface.C} cyclic="
            f"{splan.iface.cyclic} woodbury={splan.iface.woodbury}; CPU f64 attempts "
            f"{att_cpu} ({cpu_s:.1f} s)")
        for dt_name, dtype in DTYPES.items():
            torch.cuda.synchronize()
            _launch.reset_counters()
            start = time.perf_counter()
            sim, u, attempts, seen = spatial_run(eqs, case, ndev, kwargs, "cuda", dtype)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = _launch.counts()
            _launch.reset_counters()
            _, u1, att1, _ = spatial_run(eqs, case, None, kwargs, "cuda", dtype)
            single = _launch.counts()
            steps = len(seen)
            n_att = attempts_of(attempts, steps)
            k5 = single["K5.combine"] / attempts_of(att1, steps)
            want = expected_spatial(kind, splan, n_att, k5,
                                    refine=kwargs.get("refine", 0))
            off = {k: (counts[k], want[k]) for k in KERNELS if counts[k] != want[k]}
            if off:
                raise RuntimeError(f"{label} {dt_name}: launches (got, predicted) {off}")
            gap1 = float((u - u1).abs().max() / u1.abs().max())
            gap_cpu = float((u.double().cpu() - torch.from_numpy(u_cpu)).abs().max()) / scale
            log(f"    {dt_name}: {steps} output steps in {secs:.3f} s wall (first call); "
                f"attempts {attempts} (single grid {att1}); launches as predicted "
                + json.dumps({k: v for k, v in counts.items() if v})
                + f"; max|u - u_single| / max|u| = {gap1:.3e}; "
                f"against the CPU f64 sharded run {gap_cpu:.3e}")
            if not bool(torch.isfinite(u).all()):
                raise RuntimeError(f"{label} {dt_name}: non-finite state")
            if kind == "dopri5":
                if not torch.equal(u, u1) or attempts != att1:
                    raise RuntimeError(f"{label} {dt_name}: not bit for bit the single grid")
            elif not gap1 <= (1e-9 if dtype == torch.float64 else 1e-4):
                raise RuntimeError(f"{label} {dt_name}: off the single grid")
            if dtype == torch.float64:
                if not gap_cpu <= 1e-10 or attempts != att_cpu:
                    raise RuntimeError(f"{label} f64: off the CPU f64 sharded run")
            elif not gap_cpu <= tol32:
                raise RuntimeError(f"{label} f32: off the CPU f64 sharded run")
            for k in KERNELS:
                launches[k] += counts[k]
            if label == SPATIAL_CASES[0][0]:
                # the chunked run: every emission bit for bit the stepwise one
                _launch.reset_counters()
                sim_c, _, _, seen_c = spatial_run(eqs, case, ndev, kwargs, "cuda", dtype,
                                                  device_chunk=2)
                chunk_counts = _launch.counts()
                route = sim_c._scheme.steps_route
                same = len(seen_c) == len(seen) and all(
                    ta == tb and torch.equal(ua, ub)
                    for (ta, ua), (tb, ub) in zip(seen, seen_c))
                log(f"    {dt_name}: run(device_chunk=2) route {route}, emissions bit for "
                    f"bit the stepwise run: {same}")
                if route != "graph" or not same or any(
                        chunk_counts[k] for k in KERNELS if k.startswith(("K6", "K9"))):
                    raise RuntimeError(f"{label} {dt_name}: the chunked run is off")
                for k in KERNELS:
                    launches[k] += chunk_counts[k]
    # df64
    label, eqs, case, ndev, kwargs = SPATIAL_DF64
    fields_np, pars, dt, tmax, _ = case
    splan = spatial_plan(eqs, len(fields_np["x"]), ndev, True)
    _launch.reset_counters()
    _, u, _, seen = spatial_run(eqs, case, ndev, kwargs, "cuda", torch.float64, "df64")
    counts = _launch.counts()
    _launch.reset_counters()
    single_kw = {k: v for k, v in kwargs.items() if k != "df64_mixed_solve"}
    _, u1, _, _ = spatial_run(eqs, case, None, single_kw, "cuda", torch.float64)
    single = _launch.counts()
    want = expected_spatial("ros2", splan, len(seen),
                            single["K5.combine"] / len(seen), passes=2)
    off = {k: (counts[k], want[k]) for k in KERNELS if counts[k] != want[k]}
    u_cpu = torch.from_numpy(refs[label][0])
    gap1 = float((u - u1).abs().max() / u1.abs().max())
    gap_cpu = float((u.cpu() - u_cpu).abs().max() / u_cpu.abs().max())
    log(f"  {label}: launches " + json.dumps({k: v for k, v in counts.items() if v})
        + f"; max|u - u_double| / max|u| = {gap1:.3e} (limit 1e-11); against the CPU "
        f"df64 sharded run {gap_cpu:.3e} (limit 1e-10)")
    if off or not gap1 <= 1e-11 or not gap_cpu <= 1e-10:
        raise RuntimeError(f"{label}: off (launches (got, predicted) {off})")
    for k in KERNELS:
        launches[k] += counts[k]
    # dp x sp
    for label, kwargs, steps, dt, dt_names in DPSP_CASES:
        u_cpu, iters_cpu, cpu_s = refs[label]
        splan = spatial_plan(DPSP_BURGERS, DPSP_N, DPSP_MESH[1], True, DPSP_B)
        for dt_name in dt_names:
            dtype = DTYPES[dt_name]
            _launch.reset_counters()
            ens, iters = dpsp_run(kwargs, steps, dt, "cuda", dtype)
            counts = _launch.counts()
            ref, iters1 = dpsp_run(kwargs, steps, dt, "cuda", dtype, mesh=False)
            attempts = counts["K1.J_shards"]
            want = shard_launches(splan, attempts, 6 * attempts if "rodaspr" in label
                                  else 2 * attempts,
                                  F_terms=(6 if "rodaspr" in label else 2) * attempts)
            want["K5.combine"] = attempts
            off = {k: (counts[k], want[k]) for k in KERNELS if counts[k] != want[k]}
            gap1 = float((ens.u - ref.u).abs().max() / ref.u.abs().max())
            gap_cpu = float((ens.u.double().cpu() - torch.from_numpy(u_cpu)).abs().max()
                            / np.abs(u_cpu).max())
            log(f"  {label} {dt_name}: route {ens.route}, {attempts} member-axis attempts, "
                f"member attempts {iters} (unsharded {iters1}, CPU {iters_cpu}); launches "
                + json.dumps({k: v for k, v in counts.items() if v})
                + f"; against the unsharded ensemble {gap1:.3e}, the CPU {gap_cpu:.3e}")
            lim = 1e-9 if dtype == torch.float64 else 1e-4
            if off or not gap1 <= lim or iters != iters1:
                raise RuntimeError(f"{label} {dt_name}: off (launches (got, predicted) "
                                   f"{off})")
            if dtype == torch.float64 and (not gap_cpu <= 1e-10 or iters != iters_cpu):
                raise RuntimeError(f"{label} f64: off the CPU f64 run")
            for k in KERNELS:
                launches[k] += counts[k]
    log("  launches over phase 2 with spatial sharding: " + json.dumps(launches))
    return launches


def interface_pieces(fact, rhs):
    """The interface system's share of a sharded step's solves: its K4
    factor (and Woodbury set-up), then per stage (6) the solve with shifts
    over the shards (K4) and the correction (K3)."""
    ip = fact.plan.iface
    sp_ = fact.spikes
    yred = torch.zeros(sp_.Lred.shape[:-3] + (2 * ip.s, ip.C), dtype=rhs.dtype,
                       device=rhs.device)

    def run():
        red = pcr.pcr_factor(sp_.Lred, sp_.Ured, ip.cyclic)
        wood = pcr.woodbury(red, sp_.Lred, sp_.Ured) if ip.woodbury else ()
        for _ in range(6):
            xm1, xp1 = pcr.pcr_solve_shift(red, yred, ip.wrap, *wood)
            thomas.spike_correct(sp_, rhs, xm1, xp1, ip)

    return run


def phase3_spatial(smi):
    """ms per fixed RODASPR step of KS 2^20 over 8 shards against the single
    grid (in turns: single, sharded, sharded, single; CUDA events), the
    step's device µs under the profiler and the interface system's share of
    them, the spike columns' share, the dp x sp output step (ROS2, B = 16 x
    2^16 over (2, 4)) against the unsharded ensemble, and K1's shard entries
    against their plain versions and bounds; f64 and f32."""
    log(f"phase 3: spatial sharding timed ({smi})")
    times = {}
    for dt_name, dtype in DTYPES.items():
        times[dt_name] = {}
        model, fields, pars_t, (u, helpers, pstack, x), dt = path_inputs(
            KS, ks_case(0.05, 0.1), dtype)
        single = schemes.RODASPR(model, time_stepping=False, tol=None)
        sm = spatial.SpatialModel(model, space_mesh(8), periodic=True)
        sharded = sm._make_scheme(schemes.RODASPR, time_stepping=False, tol=None)
        ms = [cuda_ms(lambda s=s: s(0.0, fields, dt, pars_t), 10)
              for s in (single, sharded, sharded, single)]
        log(f"  ks N=2^20 rodaspr fixed step {dt_name}, single / 8 shards / 8 shards / "
            "single: " + " / ".join(f"{m:.4f}" for m in ms) + " ms/step (CUDA events); "
            f"sharded {min(ms[1:3]) / min(ms[0], ms[3]):.3f}x the single grid")
        prof = profile_step(sharded, fields, pars_t, dt)
        log_profile("rodaspr fixed step ks N=2^20 8 shards", dt_name, prof)
        log_profile("rodaspr fixed step ks N=2^20 single grid", dt_name,
                    profile_step(single, fields, pars_t, dt))
        g00 = rodaspr_rows()[1]
        bands = sm._local_J(u, helpers, pstack, x)
        fact = sm.factor(-g00 * dt, bands)
        iface = profile_calls(interface_pieces(fact, u), 5)
        cols = profile_calls(lambda: [fact.local._tri_solve(
            torch.zeros((8, 1, N_BIG // 8), dtype=dtype, device="cuda"))
            for _ in range(4)], 5)
        if prof and iface and cols:
            log(f"  interface system over the 8 shards {dt_name}: "
                f"{iface['busy_us_per_step']:.1f} device us per step (its factor, 6 solves "
                f"with shifts and corrections) of the step's {prof['busy_us_per_step']:.1f}: "
                f"{iface['busy_us_per_step'] / prof['busy_us_per_step']:.2%}; the 4 spike "
                f"columns' local solves {cols['busy_us_per_step']:.1f} us, "
                f"{cols['busy_us_per_step'] / prof['busy_us_per_step']:.2%}")
        else:
            log(f"  interface share {dt_name}: not measured (no device time recorded)")
        # dp x sp's output step
        ens, _ = dpsp_run(DPSP_CASES[1][1], 1, 0.05, "cuda", dtype)
        ref, _ = dpsp_run(DPSP_CASES[1][1], 1, 0.05, "cuda", dtype, mesh=False)
        d_ms = [cuda_ms(lambda e=e: e.step(0.05), 5) for e in (ref, ens, ens, ref)]
        log(f"  dp x sp ros2 output step B={DPSP_B} x N=2^16 {dt_name}, unsharded "
            f"(route {ref.route}) / (2, 4) mesh (route {ens.route}) / mesh / unsharded: "
            + " / ".join(f"{m:.4f}" for m in d_ms) + " ms")
        # K1's shard entries at KS 2^20 over 8 (F, J) and at dp x sp's step
        # (F_terms: RODASPR's six terms over 16 members of 2^16)
        b, sysm = model.backend, model.system
        item = torch.finfo(dtype).bits // 8
        n_in = (sysm.nvar + len(sysm.help_funcs) + len(sysm.pars) + 1) * N_BIG
        rng = np.random.default_rng(5)
        bias = torch.tensor(rng.standard_normal(u.shape), dtype=dtype, device="cuda")
        gdt = g00 * dt
        pairs = {
            "K1.F_shards": (
                lambda: b.F(u, helpers, pstack, x, periodic=True, scale=gdt, bias=bias,
                            shards=8),
                lambda: stencil.eval_F_plain(b, u, helpers, pstack, x, True, gdt, bias, 8),
                (n_in + 2 * N_BIG) * item, (expr_ops(sysm.F_exprs) + 2) * N_BIG),
            "K1.J_shards": (
                lambda: b.J_bands(u, helpers, pstack, x, periodic=True, shards=8),
                lambda: stencil.eval_J_plain(b, u, helpers, pstack, x, True, 8),
                (n_in + 5 * N_BIG) * item, expr_ops(sysm.J_band_exprs.values()) * N_BIG),
        }
        dmodel = Model(*DPSP_BURGERS, double=dtype == torch.float64, device="cuda")
        db = dmodel.backend
        du, dh, dp, dx = kernel_checks.shard_inputs(dmodel, DPSP_N, DPSP_B, "cuda")
        terms = [(a, c, du + 1e-3 * k) for k, (a, c) in enumerate(
            [(1.0, 0.0), (0.75, 0.3), (0.0, -1.2), (1.0, 1.0), (2.5, 0.0), (-0.4, 0.7)])]
        nodes = DPSP_B * DPSP_N
        pairs["K1.F_terms_shards"] = (
            lambda: db.F_terms(terms, dh, dp, dx, periodic=True, scale=gdt,
                               shards=DPSP_MESH[1]),
            lambda: stencil.eval_F_terms_plain(db, terms, dh, dp, dx, True, gdt,
                                               DPSP_MESH[1]),
            ((len(terms) + 1 + 1) * nodes + DPSP_N) * item,
            (expr_ops(db.system.F_exprs) + 4 * len(terms)) * nodes)
        for name, (kern, plain, nbytes, ops) in pairs.items():
            p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kern, kern, plain))
            b_ms, b_by = bound(nbytes, ops, dtype)
            times[dt_name][name] = (min(k1, k2), min(p1, p2), b_ms, b_by, None)
            log(f"  {name} {dt_name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
                f"{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, {ops} "
                "operations), no library call")
    return times


def timed(fn, *args):
    start = time.perf_counter()
    out = fn(*args)
    log(f"({fn.__name__}: {time.perf_counter() - start:.1f} s)")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    start_cpu_refs()
    try:
        return run()
    finally:
        stop_cpu_refs()


def run():
    smi = timed(phase0)
    errs = timed(phase1_spatial, timed(phase1_erk, timed(phase1_film, timed(phase1))))
    launches = timed(phase2_df64, timed(phase2_ensembles, timed(phase2)))
    launches = timed(phase2_precision, launches)
    launches = timed(phase2_megatheta, launches)
    launches = timed(phase2_film, launches)
    launches = timed(phase2_padded, launches)
    launches = timed(phase2_chunked, launches)
    launches = timed(phase2_erk, launches)
    launches = timed(phase2_spatial, launches)
    times = timed(phase3)
    for part in (timed(phase3_small), timed(phase3_ensembles, errs), timed(phase3_df64),
                 timed(phase3_precision, smi),
                 timed(phase3_megatheta), timed(phase3_film), timed(phase3_padded),
                 timed(phase3_redesign), timed(phase3_chunked, smi),
                 timed(phase3_erk, smi), timed(phase3_spatial, smi)):
        for dt_name, more in part.items():
            times[dt_name].update(more)
    record = []
    for name, (route, source, replaces) in KERNELS.items():
        e64 = errs["float64"][name]
        k64, p64, b64, by64, l64 = times["float64"][name]
        if name in DF64_ONLY:
            # one type pair (float64 operands, float32 inside or out): the
            # main keys carry the float64 column, the float32 one is null
            e32 = k32 = p32 = b32 = l32 = None
            main = (e64, k64, p64, b64, by64, l64)
        else:
            e32 = errs["float32"][name]
            k32, p32, b32, by32, l32 = times["float32"][name]
            main = (max(e32, e64), k32, p32, b32, by32, l32)
        record.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], **dict(zip(
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                main)),
            "max_abs_err_f32": e32, "max_abs_err_f64": e64,
            "ms_f64": k64, "plain_ms_f64": p64, "bound_ms_f64": b64,
            "library_ms_f64": l64,
        })
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
