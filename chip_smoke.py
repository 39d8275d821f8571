#!/usr/bin/env python3
"""Smoke run of the PyTorch port (speedy_ml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--ptxas] [--kernels] [--surface] [--ocean]
                          [--options] [--vertical] [--physics]
                          [--dispatch] [--cli] [--experiments]
                          [--mesh] [--k14-lists]

Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from speedy_ml_tpu_torch/kernels/csrc
     (nvcc for sm_90a, one process per source, all started together);
  3. build the untrained hybrids at full width (T30L8, 1,152 regions,
     m=6000, bf16 Wout): the ML-only one, and the coupled one on a T30
     GCM with the synthetic aquaplanet boundaries;
  4. hold every kernel against its plain PyTorch version on the main
     path's inputs (a coupled state two cycles in), with its tolerance,
     and time kernel, plain version and (K2) the torch.bmm yardstick:
     device time from torch.profiler, call time from CUDA events.
     K1 ESN step, K2 readout (bare product, with a negative control that
     must fail the tolerance; the vector path required and logged for
     every class, each class timed beside torch.bmm, the ML-only form
     checked and timed; its store into the assembled grid, the core
     scatter that was K4, coupled and ML-only: bit-identical to its
     vectors then core_scatter_plain, within K2_RTOL of readout_plain
     then core_scatter_plain; timed in the main path's form, into the
     grid), K3 window gather (its date form, the ML-only cycle's, equal
     to it on K17b's plane, timed beside it),
     K15 spectral_stack (both stacks at the leapfrog's (jd, jp) = (1, 0)
     and stepone's (0, 0), the dynamics stack alone (the dry core's) and
     the physics stack alone (the window exit's), bit-identical to the
     plain versions, a copy with uvspec's n-shifts reversed must fail;
     timed as the median of SHT_SESSIONS sessions), K5 sht_analysis,
     K6 sht_synthesis (each also at every stack size and 1/cos split of
     the coupled cycle: K6 50, 41, 32 fields, K5 73, 33, 2, checked and
     timed as the median of SHT_SESSIONS sessions), K7 grid_dynamics
     (within K7_ULPS, timed as the median of SHT_SESSIONS sessions),
     K8 spectral_tail (the filtered leapfrog step, and stepone's two
     steps, j1 = 1 with imp_half and imp_full; timed as the median of
     SHT_SESSIONS sessions), K9 column_moist, K9_moist_shortwave (K9
     and the clouds and shortwave in one launch, against
     column_moist_plain followed by column_shortwave_plain),
     K10a_down_surface (the downward longwave and the surface fluxes in
     one launch, against radlw_down followed by suflux), K10b radlw_up,
     K12 column_pbl, K12_pbl_flux (K12 and the window's flux sums in one
     launch, against column_pbl_plain followed by flux_accumulate_plain)
     (the column physics: in float64 against the plain float64 version,
     then in float32 with the columns whose integer outputs differ
     counted; each must be bit-identical in both, no column flipped,
     and is timed as the median of SHT_SESSIONS sessions), K17
     surface_forcing (the window's entry on this cycle's date and SST,
     and on a seeded mixed land mask with sea ice, float32 and float64,
     within K17_ULPS of each plane's scale; the surface alone and the
     forcing alone give the same planes; its fsol plane, which the
     coupled cycle feeds back, equal to K17b's TISR plane), K17b
     tisr_plane (likewise; on no cycle's path), K6_inject_synthesis (the
     injection's K6 with K18's spectral glue as phase 0: its state equal
     to inject_spectral_plain's, its grid to the unfused K6 on that plain
     stack, bit for bit), K19 gate_check (float32 and float64, bit-identical
     extrema; each bound tripped in turn and a NaN must read unsafe), K20
     window_select (alone, with ok true and with prev false, float32 and
     float64, bit-identical; K6's fields of the physics stack equal to
     those of the former 33-field exit stack), each timed as the median of
     SHT_SESSIONS sessions; --kernels stops here;
  5. the SPEEDY window on the card against the port on the CPU in float32
     (the plain versions): stepone from the same state, then each of the
     24 steps from the card's state before it, the columns whose physics
     decision fell the other way counted and capped (window_steps);
  6. the ML-only main path, run_prediction with the writer, every launch
     counter set to 0 before and read after (K1, K2, K3; no K17b: K3
     takes the date); fields finite, T in [150, 350] K; cycle_ms, device
     busy and launches per cycle from a profile; one ML-only cycle with
     the kernels against the plain versions;
  7. the coupled main path, run_prediction: launches of every kernel
     (K5-K9, K6_inject_synthesis, K9_moist_shortwave, K10a_down_surface,
     K12, K12_pbl_flux, K15, K17, K19, K20 at most LAUNCHES_PER_CYCLE a
     cycle; no K17b: the cycle feeds back its window's fsol plane),
     cycle_ms (median and range of 5 x 20 cycles), device busy, idle
     share, device launches per cycle (at most LAUNCHES_MAX in the
     5-cycle profile) and how many of them plain, device ms per stage
     (inject_to_speedy must be five launches),
     every plain launch of each stage listed (at most PLAIN_MAX a cycle
     in all), the window's launches split into kernel and plain launches,
     per kernel inside the window (K5-K10b, K12, K15, K17, K20 and the
     fused K9_moist_shortwave and K12_pbl_flux) and per physics kernel,
     the top device ops; a profiled physics step (with and without the
     shortwave, with and without the flux sums) must be four kernel
     launches and no other device op (K9 or K9_moist_shortwave,
     K10a_down_surface, K10b, K12 or K12_pbl_flux), and a profiled
     leapfrog step ten kernel launches and no other device op; physical
     checks (safe, finite, T in [150, 350] K);
  8. one coupled cycle under torch.cuda.set_sync_debug_mode("error");
  9. the safety gate: Wout x 1e7 trips it, SPEEDY's output stays
     finite, and run_prediction stops by cycle 2; a NaN written into the
     injected grid trips K19;
 10. training at full width: K14 gram_update against its plain version
     (float32 and float64), the torch.baddbmm yardstick and an update of
     a symmetric ss that must stay exactly symmetric, at four shapes
     (the run's chunk, a polar chunk, the trainer's default chunk, a
     compute-bound chunk), both tile lists in float64; a nature run of
     the T30 GCM (104 samples at 6 h from 1990-01-01, no spin-up) and
     the imperfect model's 6-h forecasts;
     train_hybrid_production on all 1,152 regions (m=6000, noise 0.2,
     40 discarded samples, 64 pairs, time chunks of 16, region chunks of
     96, the solve in float64) with K14 and K1 launched; finite Wout, the
     solve's residual <= 1e-8 for 8 regions of each class, stage times,
     FLOP/s and peak memory; then the trained weights (a bf16 copy)
     through 12 coupled cycles of run_prediction, the fields finite;
     10f. the checkpoint at full width: save_hybrid and load_hybrid of the
     trained hybrid (float32 Wout) and of its bf16 copy (loaded, then
     cast), every parameter tensor torch.equal to the saved one; two
     coupled cycles of run_prediction from one state by the bf16 hybrid
     and by its loaded twin, equal bit for bit; train_hybrid_production
     with atmo_ckpt twice: the first trains and saves, the second loads,
     launches no K14 and no K1, and its packs equal the first's; seconds
     and bytes of each save and load;
 11. the paths from files (a temporary directory; no h5py): 1,152
     reference-format workers (synthesize_reference_worker, one seeded
     generator a region, no SST input in a seeded 30% of the regions: n =
     5,760 and 6,160) through import_reference_weights, 4 coupled cycles
     of run_prediction with the writer, K1 launched in its per-region cols
     mode only, fields finite, T in [150, 350] K; fort.20-24 and fort.26
     written at T30 (seeded continents, fills), GCM(bd=None, bc_path=) on
     the card, its BoundaryData equal to load_boundary_data on the CPU bit
     for bit, one window finite; save_gcm_restart of that window's state,
     load_gcm_restart into a fresh state, the next window equal to the
     original's bit for bit;
 12. the persistent coupled surface and the daily slab coupler
     (phase_surface): K21 slab_couple in its three forms (accumulate,
     couple with icsea 0, 2, 3, 4 and isstan 1, the day form with three
     anomaly planes; the gate tripped over window sums holding NaN) and
     K17's carry form against their plain versions, float32 and float64,
     0 difference, timed; eight persistent coupled cycles at full width
     through run_prediction on the aquaplanet with smooth continents (K21
     eight launches, the sums zero after cycles 4 and 8 only, stl_lm off
     the climatology over land after a coupling, fields finite, T in
     [150, 350] K), four more with host syncs forbidden, launches a cycle
     (at most LAUNCHES_MAX + 1), busy and cycle_ms; the gate's select
     (safe false keeps the sums bit for bit); GCM.run_days for 2 days with
     icsea 2, isstan 1 and seeded anomalies (sst_am the ice blend of
     sst_om within 1e-4 K, s a day, launches a day) and
     generate_nature_run with its default 5 days of spin-up;
 13. the slab ocean (phase_ocean): K22 slab_ocean in its three forms
     (push, push_mean at three steps, sst with a land fill and the 272 K
     floor) against its plain version at the full-width shapes, float32
     and float64, 0 difference, a negative control (the mean summed in
     slot order) that must differ, each form timed; a nature run of 8
     slab strides (224 samples) and train_hybrid_production(ocean=True)
     loading phase 10's atmosphere from its atmo_ckpt (OCEAN_HYPER, region
     chunks of 32, the solve in float64): Wout finite, the solve's
     residual <= 1e-8 for 8 regions of each class, stage seconds, solve
     FLOP/s, peak memory; K1 and K2 (bare, S = 0 and 4) at the ocean's
     shapes against their plain versions, timed; the ocean hybrid (phase
     10's standardizers and reservoirs with a seeded untrained readout,
     the trained ocean, a land mask of smooth continents) armed by
     start_prediction on the last 16 samples with the 6-h forecast from
     the last one, then 30 persistent coupled cycles of run_prediction:
     the SST grid new on the 28th only (>= 272 K, land the floored fill)
     and bit for bit unchanged on the other 29, K1 and K2 6 launches on
     the slab step and 3 on the others, K22 once a cycle and twice on
     the slab step, the state finite, T in [150, 350] K; a slab step with
     host syncs forbidden; launches and busy of a slab step and of
     another cycle by kernel (the slab step's extra: 3 K1, 3 K2, 1 K22,
     and the ocean kernels' device time; checked where the profiler saw
     every launch, after OCEAN_PAD launches of K17b that absorb the
     events a session loses first); save_hybrid and load_hybrid of
     the ocean hybrid, every ocean tensor equal, and two cycles from step
     26 (the second a slab step) by it and its loaded twin equal bit for
     bit.
 14. the forecast's options (phase_options): K23 sst_by_date against its
     plain version (float32 and float64), 0 difference, timed; K2's
     components form on the main path's inputs against
     readout_components_plain within K2_RTOL, a negative control (the
     vector rounded to bf16) that must differ, its store into three grids
     bit for bit its vectors then the core scatter, timed beside the main
     form; 8 coupled cycles of run_prediction from 1990-01-31 12:00 with
     a 365-day SST table (the aquaplanet SST, a seeded seasonal term, a
     bias ramp), a 6-hourly TISR table of 1,460 rows, emit_components, a
     writer, a seeded truth provider and time means: the stream's keys,
     two months of time means, fields finite, T in [150, 350] K, the
     state's SST the plain table day bit for bit, K23 once a cycle; the
     launches a cycle beside the main path's (one more), busy and ms a
     cycle with and without the writer and the time means.
 15. vertical localization (phase_vertical): train_hybrid with two groups
     of levels ([0, 4) seeing [0, 5), [4, 8) seeing [3, 8)) on phase 10's
     nature run and forecasts at full width (1,152 regions, m = 6000 a
     group, region chunks of 96, the solve in float64): six packs, stage
     seconds, the solve's TFLOP/s; the localized hybrid (those
     standardizers and reservoirs, a seeded untrained bf16 readout): K2's
     store through the bands bit for bit its vectors then the core
     scatter, K3's two gathers within an ulp of the plain version; 8
     coupled cycles of run_prediction (K1 and K2 six launches a cycle,
     fields finite, T in [150, 350] K), launches and busy beside the main
     path's (+3 K1, +3 K2); the localized checkpoint saved and loaded,
     equal, its twin's cycles bit for bit;
 16. the optional physics (phase_physics) on a T30 GCM with SPPT, RDF and
     cgrate on: K24 (both forms), K25 (both forms), K26 (and a trigger
     case) against their plain versions on a step's inputs, float32 and
     float64, 0 difference, K8's tendency form beside its main form, each
     timed; a day from a spun-up state, every step finite, T in [150,
     350] K, the first 24 steps held against the plain step on the CPU
     (phase 5's rule); launches per leapfrog step with all three on (15
     kernel launches, 1 plain: the draw).
 17. the batched prediction loop (phase_dispatch: run_prediction with
     cycles_per_dispatch > 1 as replays of captured CUDA graphs of the
     cycle): the device-scalar forms of K3 (the date and a TISR table's
     row), K17, K21, K22's push forms and K23 against their by-value forms
     and their plain versions, float32 and float64, 0 difference, timed;
     the coupled main path in dispatches of 4 across a day against the
     eager loop (stream, time means, dates, final state bit for bit, the
     launches kernel by kernel), the forms replayed at a second date; the
     persistent surface with the slab ocean, a TISR table and the
     components, the SST and TISR tables with a bias ramp, and the ML-only
     cycle, 28 cycles each in one dispatch, bit for bit; a NaN in the
     state's SST tripping the gate mid-dispatch (the dates stop there, as
     the eager loop's); one dispatch under set_sync_debug_mode("error");
     cycle_ms for K = 1 and K = 28 (5 x 20 cycles), device busy, the idle
     share, device and host launches a cycle.
 18. the config-driven entry point (phase_cli; the earlier phases'
     hybrids freed first): RunConfig's defaults
     at full width, cut in time only and with a raised ridge, `python -m
     speedy_ml_tpu_torch.main run cfg.json` in a subprocess (exit 0),
     then main.main(["predict", cfg.json]) in this process from its
     checkpoint: every kernel of the predict path launched (K22 once a
     cycle and once more on the slab step), the same cycles and gate
     flag, both streams and time means bit for bit; the stream exported
     to NetCDF and read back.
 19. the experiment programs (phase_experiments): the climate run's
     stages A-E (run_climate) and both arms of the skill experiment
     (skill_arm, shift and random) in the scripts' own configuration,
     cut in time only (EXP_*): each stage's files, the result's keys and
     values, a second run_climate that runs no stage, the atmosphere's
     checkpoint deleted, finite RMSE; wall s of each stage and arm, stage
     C's ms a cycle and simulated years a day, stage D's s a simulated
     day, the arms' T-RMSE at days 1, 3, 7 and 14, K1 and K14 launches
     in the random arm, peak host RSS; nothing written outside its work
     directory.
 20. the hub-free sharded cycle (phase_mesh; run after phase 17, before
     18): the main path's hybrid on a mesh of MESH_SHARDS shards (on as
     many cards where they are visible, else all on cuda:0),
     set_mesh(mesh, shard_gcm=False) and set_mesh(mesh) (the GCM sharded
     too: m ranges and latitude bands); MESH_CYCLES cycles of each from
     the unsharded state two cycles in, each cycle's fields and every
     class's x, feedback and local model bit for bit the unsharded
     cycle's, the gate safe; run_prediction the three ways with every
     launch counter set to 0 before and read after (K1, K2 and K3
     MESH_SHARDS times the unsharded launches; with the GCM sharded the
     window's kernels MESH_SHARDS times too but for MESH_WHOLE; every
     other kernel the same), the moves between shards a cycle and their
     bytes, the host clock; busy and device launches a cycle with K1, K2
     and K3 apart (six profile sessions, the three in turn); the
     window's device time alone; the MESH_FORMS (K15's and K8's m-range
     forms, K6's band form, K5's m-range form) and K7 and the column
     physics on bands, on every shard, bit for bit the whole kernels'
     ranges and bands and within phase 4's tolerances of their plain
     versions, shard 1's timed; the dry run's training step at
     m = 6000 (accumulate_batches on 8 interior regions a shard, T = 9,
     solve_wout_sharded in float64: Wout bit for bit solve_wout's) and
     its lat halo exchange of the SST; then the rest of the distributed
     code: (f) run_prediction with cycles_per_dispatch = MESH_LOOP on both
     meshed hybrids (the captured loop: one graph a form where the shards
     share a card), its final state bit for bit the eager meshed loop's
     and the unsharded loop's and its launches the eager meshed loop's
     kernel by kernel, ms a cycle, busy, the idle share, device launches
     and host CUDA calls a cycle; (g) the slab ocean on the mesh (phase
     17's seeded ocean packs on the continents, SLAB_STRIDE
     MESH_SLAB_STRIDE) with the GCM whole and sharded, each cycle through
     the slab step bit for bit the unsharded one (the new SST grid and
     the ocean's states included), its captured loop bit for bit the
     eager one, busy and launches of the slab-step cycle, unsharded and
     meshed; (h) a meshed window with cgrate on and RDF bit for bit the
     unsharded one, and K25's sums and band forms and K26's rows and
     range forms on every shard bit for bit the whole kernels' bands and
     ranges and their plain versions, shard 1's timed (the kernels
     line's K25_rdf_sums, K25_rdf_band, K26_cgrate_rows,
     K26_cgrate_range); (i) the training dry run at m = 6000
     (parallel/train_dryrun.py dryrun_m6000: 8 interior regions a shard,
     each shard's Gram block on its own device, Wout finite and
     sharded).
--surface runs phase 12 alone after phase 3 (no result line); --ocean
trains phase 10's atmosphere and runs phase 13 alone (no result line);
--options runs phase 14 alone, --vertical phase 15 (with its own nature
run), --physics phase 16, --dispatch phase 17, --cli phase 18,
--experiments phase 19 and --mesh phase 20 (no result line);
--train-full runs the full training pass on phase 20's mesh after the
build (train_dryrun.train_full, every region at m = 6000; no result
line).
--k14-lists stops after phase 3 and times K14's two tile lists at several
chunk lengths (k14_lists).  The second-to-last line is the kernels
JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device or
without the package beside this script.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense rates (at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12

SEED = 0
M = 6000
N_REGIONS = 1152
CYCLES_ML = 8       # ML-only main-path cycles
CYCLES = 8          # coupled main-path cycles (with the writer)
N_TIMED = 20        # cycles per timed coupled run
# K2 tolerance, a fraction of the bare product's scale: about 100 times
# the f32 summation error, 20 below the unrounded-aug fault on the card
K2_RTOL = 2e-5
# K5/K6/K8: a fraction of each field's scale (f32 sums in another order);
# K7: ulps of each output field's scale (the same rounded operations)
SHT_RTOL = 1e-5
K7_ULPS = 4
TAIL_RTOL = 1e-5
# K5-K9, K12: measure() sessions per shape (the median is kept: us
# kernels spread between sessions), and the most launches per coupled
# cycle (the counts of the first designs: one launch per call)
SHT_SESSIONS = 5
LAUNCHES_PER_CYCLE = {"K6_sht_synthesis": 53, "K5_sht_analysis": 28,
                      "K7_grid_dynamics": 26, "K8_spectral_tail": 26,
                      "K9_column_moist": 16, "K9_moist_shortwave": 10,
                      "K10a_down_surface": 26,
                      "K12_column_pbl": 2, "K12_pbl_flux": 24,
                      "K15_spectral_stack": 27,
                      "K17_surface_forcing": 1,
                      "K6_inject_synthesis": 1, "K19_gate_check": 1,
                      "K20_window_select": 1}
# the most device launches (kernels, copies, fills) a coupled cycle may
# take in the 5-cycle profile of phase 7: 3,311.6 before K15 and K16
# took the spectral stacks and the flux sums of the window's steps, 703.8
# before K17-K20 took the window's entry and exit and the injection's
# glue, 348.8 before K10a_down_surface took the downward longwave and the
# surface fluxes of a physics step in one launch (26 fewer a cycle),
# 322.8 before K9_moist_shortwave and K12_pbl_flux took the shortwave and
# the window's flux sums into the physics step's launches (34 fewer),
# 288.8 before K2 took the core scatter (K4) into its store and the
# coupled cycle fed back its window's fsol plane in place of K17b's,
# 286.8 before the injection's K6 took K18's spectral glue (K6_inject)
LAUNCHES_MAX = 288
# the launches of inject_to_speedy: the clamp and the cat (plain), K5,
# K6_inject, K19
INJECT_LAUNCHES = 5
# the most plain launches (PyTorch's own kernels, copies, fills) of a
# coupled cycle in phase 7's per-stage profile
PLAIN_MAX = 20
# K17, K17b against their plain versions on the card: ulps of float32 at
# each plane's scale (both sides call the same CUDA functions in the same
# order, and every run on an H100 read 0: bit-identical required)
K17_ULPS = 0
# the column kernels (K9, K9_moist_shortwave, K10a_down_surface, K10b,
# K12, K12_pbl_flux) are held bit-identical to their plain versions in
# float32 and float64 (on an H100 each did so from its first call);
# phase 5: the share of a window step's columns whose physics may take a
# near-tie decision the other way
COLUMN_FLIPS = 0.005
# phase 5, each window step from the card's state against the plain step
# (float32): a fraction of each variable's signal (the worst step on an
# H100: t 5.4e-5, the other variables below 7e-7), and the fraction of a
# tendency field's scale above which a column's physics counts as a
# decision that fell the other way (at most COLUMN_FLIPS of the columns
# in a step; on the H100 one column in one step, the largest difference
# in the others 3.5e-4)
WINDOW_STEP_RTOL = 1e-4
WINDOW_FLIP_RTOL = 1e-3
# phase 10 (training): the nature run, the trainer's settings (main.train's
# for a 6-h series: 240 h discarded, 20 batches of at least 16 samples)
N_NATURE = 104
N_DISCARD = 40
TIME_CHUNK = 16
REGION_CHUNK = 96   # (96, 5892, 5892) f32 Gram: 13.3 GB
TRAIN_SEED = 33
CYCLES_TRAINED = 12
K14_RTOL = 1e-5     # f32: sums of 16 or 1,896 products in another order
K14_RTOL_F64 = 1e-12
# chip_smoke --k14-lists: the chunk lengths at which both tile lists are timed
K14_LIST_CS = (16, 32, 48, 64, 96, 128)
RESIDUAL_MAX = 1e-8
# phase 11: the share of land regions (no SST input: n = 6,160 against
# 5,760) in the reference-format workers, and the imported cycles
LAND_SHARE = 0.3
CYCLES_IMPORTED = 4
# phase 13: the ocean's nature run in slab strides (28 samples each), the
# sync window of start_prediction, the persistent coupled cycles (one slab
# step), the ocean's Gram region chunk, the step of K22's negative
# control (its oldest slot is not slot 0), how far a slab step's extra
# busy may be from its ocean kernels' device time (in the median of
# OCEAN_PROFILE_PAIRS alternating profiles of the two cycles), and the
# launches that go before a profiled cycle for the events a session loses
# first
OCEAN_STRIDES = 8
OCEAN_SYNC = 16
OCEAN_CYCLES = 30
OCEAN_REGION_CHUNK = 32
OCEAN_STEP = 5
OCEAN_BUSY_TOL_MS = 0.05
OCEAN_PROFILE_PAIRS = 5
OCEAN_PAD = 32
# phase 14: the forecast's options' cycles (from 1990-01-31 12:00, over a
# month boundary), the SST table's bias ramp, the TISR table's rows (6 h
# apart), the launches that go before a profiled cycle for the events a
# late session loses first, and the cycles of each timed run with the
# time means or the writer
OPT_CYCLES = 8
OPT_BIAS_PER_YEAR = 2.0
OPT_TISR_ROWS = 1460
OPT_PAD = 32
OPT_IO_CYCLES = 10
# phase 12: the persistent coupled cycles (two couplings) and the days of
# GCM.run_days
# phase 16 (the optional physics): RDF's pattern seed, SPPT's generator
# seed, and the steps of its day held one by one against the CPU
RDF_SEED = 7
PHYS_SEED = 11
PHYS_HELD = 24
PHYS_SPINUP = 5
# phase 15 (vertical localization): two groups of levels, an overlap of
# one level, and the localized hybrid's coupled cycles
VERT_GROUPS = 2
VERT_OVERLAP = 1
VERT_CYCLES = 8
PERSIST_CYCLES = 8
RUN_DAYS = 2
# phase 17 (the batched prediction loop)
DISPATCH_K = 28        # cycles a dispatch in the timed captured runs
DISPATCH_CHECK_K = 4   # cycles a dispatch in the checks (they cross a day)
DISPATCH_CHECK = 8     # cycles of the main path's check
DISPATCH_STRETCH = 28  # cycles of each product form's stretch
DISPATCH_DATE2 = (1990, 7, 15)   # the second date of the replayed forms
DISPATCH_FORMS = ("K3_window_gather_dev", "K17_surface_forcing_dev",
                  "K21_slab_couple_dev", "K22_slab_ocean_dev",
                  "K23_sst_by_date_dev")
# phase 20 (the hub-free sharded cycle): the shards of the mesh (on four
# cards where four are visible, else all on cuda:0), the sharded and
# unsharded cycles held bit for bit, and the cycles of each profile
# session, each after MESH_PAD launches of K17b (late in a full run a
# session lost its first ~34 device events, OCEAN_PAD's 32 and then K1's
# and K2's)
MESH_SHARDS = 4
MESH_CYCLES = 8
# the sharded GCM's forms (the kernels line's rows, after the whole
# kernels'); the kernels it launches a shard (MESH_SHARDS times the
# unsharded count), and those whose launches stay whole on mesh.devices[0]
# (per cycle: the window's exit's K15 and K6; the forcing's and the
# injection's K5)
MESH_FORMS = ("K15_spectral_stack_mrange", "K6_sht_synthesis_band",
              "K5_sht_analysis_mrange", "K8_spectral_tail_mrange",
              "K25_rdf_sums", "K25_rdf_band", "K26_cgrate_rows",
              "K26_cgrate_range")
MESH_BANDED = ("K7_grid_dynamics", "K8_spectral_tail", "K9_column_moist",
               "K9_moist_shortwave", "K10a_down_surface", "K10b_radlw_up",
               "K12_column_pbl", "K12_pbl_flux")
MESH_WHOLE = {"K15_spectral_stack": 1, "K6_sht_synthesis": 1,
              "K5_sht_analysis": 2}
MESH_PROFILE_CYCLES = 4
MESH_PAD = 128
# the captured loop on a mesh: cycles in one dispatch (and in the eager
# loops it is held against), and the timed runs; the slab ocean on a mesh
# at this SLAB_STRIDE (a slab step in its first cycles); the leapfrog steps
# of the meshed window with cgrate and RDF after stepone
MESH_LOOP = 28
MESH_TIMED = 5
MESH_SLAB_STRIDE = 4
MESH_CG_STEPS = 6
# phase 18 (the CLI): RunConfig's own defaults (T30L8, 1,152 regions,
# m = 6000, the slab ocean at m = 4000, the persistent surface, float32)
# cut in time only: 224 nature-run samples (the ocean's 8 slab strides of
# phase 13), 29 cycles (one slab step, at cycle 27), the default discard
# and sync windows; and the atmosphere's ridge raised from beta_res 1e-3
# (a ridge of 1e-6, at which the readout trained on 184 pairs trips the
# gate at the first cycle on the card) to 1.0
CLI_CUTS = dict(training_hours=6 * 224, prediction_hours=6 * 29)
CLI_BETA_RES = 1.0
# the kernels of the CLI's predict path, each launched at least once
CLI_PREDICT_KERNELS = (
    "K1_esn_step", "K2_readout_scatter", "K3_window_gather",
    "K5_sht_analysis", "K6_sht_synthesis", "K7_grid_dynamics",
    "K8_spectral_tail", "K9_column_moist", "K9_moist_shortwave",
    "K10a_down_surface", "K10b_radlw_up", "K12_column_pbl", "K12_pbl_flux",
    "K15_spectral_stack", "K17_surface_forcing", "K6_inject_synthesis",
    "K19_gate_check", "K20_window_select", "K21_slab_couple",
    "K22_slab_ocean")
# phase 19 (the experiments): the scripts' own configuration (T30L8,
# 1,152 regions, float32, the synthetic boundaries and the imperfect
# model, m = 3000, a 30-day spin-up, the slab ocean at ridge 0.01, region
# chunk 96, dispatch 32, the shift topology for the climate run, both
# topologies for the skill arms at 4 ICs x 56 cycles) cut in time only:
# 224 training samples (the slab ocean's 8 strides of phase 13; the
# default is 8,760), stage C 120 cycles and stage D 30 days (the default
# is 20 years of each), and the climatologies' year 112 samples (28
# days; the default 1,460), so that the 224 truth samples hold whole
# years, as the truth's day-of-year climatology requires
EXP_N = 224
EXP_CYCLES = 120
EXP_BASE_DAYS = 30
EXP_SPY = 112
# the atmosphere's ridge of both programs: None keeps the scripts' (the
# climate run's atmo_beta 0.05, the skill arms' beta_res 0.05)
EXP_BETA = None
EXP_LEADS = (("day1", 3), ("day3", 11), ("day7", 27), ("day14", 55))
# the result's keys (scripts/climate_run.py:416-441)
CLIMATE_KEYS = (
    "m", "n_train", "years_requested", "sim_years", "cycles", "wall_s",
    "sim_years_per_day", "safe_never_tripped", "slab_ocean", "ocean_beta",
    "sst_bias", "t_sfc_global_first_year", "t_sfc_global_last_year",
    "t_drift_K_per_decade", "mass_drift_rel", "mass_mean_kg", "nino34_std",
    "nino34_peak_period_years", "climo_rms_hybrid", "climo_rms_speedy",
    "hybrid_beats_speedy_climo", "figures", "calendar", "prediction_start",
    "prediction_end", "peak_rss_pct", "boundary")
# the kernels the coupled main path does not launch (phase 7)
OFF_MAIN_PATH = ("K17b_tisr_plane", "K21_slab_couple", "K22_slab_ocean",
                 "K23_sst_by_date", "K24_sppt", "K25_rdf", "K26_cgrate")
# the CUDA API calls that put work on the card, as the profiler names the
# host's runtime events
HOST_LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                   "cudaMemcpyAsync", "cudaMemsetAsync")
# torch.profiler sessions: idle time at either end of the profiled work,
# and how often a session that saw no device event is run again
PROFILE_PAD_S = 0.02
PROFILE_TRIES = 3
# the record_function ranges of the coupled cycle
RANGES = ("predict_all", "inject_to_speedy", "speedy_window", "physics",
          "build_feedback", "build_local_model", "slab_couple", "slab_ocean",
          "sst_by_date")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_device(torch, fn, reps: int, ranges: bool = False):
    """torch.profiler (CUPTI) over reps calls of fn(): (device ms per call
    summed over every kernel, copy and fill fn runs, key_averages of the
    device events, the profile).  ranges=True also records the host side
    (the record_function ranges of the cycle).

    A session whose device work is short (a few launches, well under a
    millisecond) can come back with no device event at all: the device's
    timestamps are mapped onto the host's clock, and events that land just
    outside the session's window are dropped.  So the work sits between
    PROFILE_PAD_S of idle time at either end, and a session that saw no
    device event is profiled again, up to PROFILE_TRIES times; a fn that
    launches nothing still comes back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges
                                      else [])
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        # device work only: the GPU-side spans of the record_function
        # ranges are not kernels
        avg = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in RANGES]
        if avg:
            break
        log(f"  the profiler saw no device event in session {attempt} of "
            f"{PROFILE_TRIES}")
    dev = sum(_self_device_us(e) for e in avg) / 1e3 / reps
    return dev, avg, prof


def profile_counts(torch, fn, reps: int, short):
    """profile_device over reps calls of fn(), again (up to PROFILE_TRIES
    sessions) while short(key_averages) says the session only lost
    launches: a session can drop device events at its edges (seen once in
    a machine's first run: 19 launches of a kernel called 20 times), never
    add one.  What the caller then checks is the last session's counts."""
    for attempt in range(1, PROFILE_TRIES + 1):
        ms, kk, prof = profile_device(torch, fn, reps)
        if not short(kk):
            break
        log(f"  the profiler dropped launches in session {attempt} of "
            f"{PROFILE_TRIES}: "
            + ", ".join(f"{kernel_name(e.key)} {e.count}" for e in kk))
    return ms, kk, prof


def measure(torch, fn, reps: int = 10, warmup: int = 2):
    """(device_ms, call_ms) per call of fn(): device_ms from the profiler,
    call_ms from CUDA events around back-to-back calls (host gaps
    included).  Fails where the profiler sees no device time: the event
    time of a small kernel is its Python wrapper's, not the kernel's."""
    call = time_ms(torch, fn, reps, warmup)
    dev, _, _ = profile_device(torch, fn, reps)
    if dev <= 0:
        fail("torch.profiler saw no device time")
    return dev, call


def measure_median(torch, fn, sessions: int = SHT_SESSIONS, reps: int = 50):
    """measure() in `sessions` sessions: the medians of (device_ms,
    call_ms), and the device ms of every session."""
    runs = [measure(torch, fn, reps=reps) for _ in range(sessions)]
    return ((statistics.median(r[0] for r in runs),
             statistics.median(r[1] for r in runs)), [r[0] for r in runs])


def measure_one_launch(torch, fn, sessions: int = SHT_SESSIONS,
                       reps: int = 50):
    """measure_median for a fn that is one kernel launch a call, counting
    only the sessions in which the profiler saw every launch: late in a
    run a session can lose half of them, which halves its per-call time
    (phase 16's K25 and K26 read bimodal so).  Up to 3 x sessions
    tries."""
    runs = []
    for _ in range(3 * sessions):
        call = time_ms(torch, fn, reps)
        dev, kk, _ = profile_device(torch, fn, reps)
        if sum(e.count for e in kk) == reps:
            runs.append((dev, call))
        if len(runs) == sessions:
            break
    if not runs:
        fail("the profiler lost launches in every session")
    return ((statistics.median(r[0] for r in runs),
             statistics.median(r[1] for r in runs)), [r[0] for r in runs])


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def port_kernel_names() -> set:
    """The names of the port's kernels, the __global__ functions of
    speedy_ml_tpu_torch/kernels/csrc/*.cu."""
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)")
    csrc = ROOT / "speedy_ml_tpu_torch" / "kernels" / "csrc"
    return {m.group(1) for src in csrc.glob("*.cu")
            for m in pat.finditer(src.read_text())}


def kernel_name(key: str) -> str:
    """The function name of a profiler event's key ("void f<8>(...)" ->
    "f"; "at::native::..." keeps its namespace; a copy's "Memcpy DtoH
    (...)" -> "DtoH")."""
    return key.split("(")[0].split("<")[0].split()[-1] if key.strip() \
        else key


def sst_month0(geom):
    """synthetic_boundary_data's month-0 SST (zonal, seasonal term)."""
    import numpy as np
    lat = geom.lat_radians
    ones = np.ones((geom.nlat, geom.nlon))
    sst = (273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
           + 2.0 * np.sin(lat)[:, None] * np.cos(2 * np.pi * 0.5 / 12) * ones)
    return np.maximum(sst, 271.4)


def per_field_err(torch, got, ref):
    """(max |got - ref| / scale over the leading axis, worst abs error);
    scale: each field's max |ref|."""
    g = got.reshape(got.shape[0], -1)
    r = ref.reshape(ref.shape[0], -1)
    scale = r.abs().amax(dim=1).clamp(min=torch.finfo(torch.float32).tiny)
    rel = ((g - r).abs().amax(dim=1) / scale).max()
    return float(rel), float((g - r).abs().max())


def column_errors(got: dict, ref: dict, int_names=()):
    """Compare the named outputs of a column kernel (name -> tensor whose
    last two axes are (lat, lon)).  Returns (flipped, rel, worst):
    flipped, the number of columns in which an integer output differs (a
    near-tie decision that fell the other way changes the whole column);
    rel, over the other columns, the largest |got - ref| of a float
    output as a fraction of that output's scale (its max |ref|); worst,
    that output's name."""
    first = next(iter(ref.values()))
    agree = first.new_ones(first.shape[-2:], dtype=bool)
    for nm in int_names:
        agree &= got[nm] == ref[nm]
    rel, worst = 0.0, ""
    for nm, r in ref.items():
        if nm in int_names:
            continue
        scale = float(r.abs().max())
        if scale == 0.0:
            scale = 1.0
        diff = (got[nm] - r).abs().masked_fill(~agree, 0.0)
        err = float(diff.max()) / scale
        if not err <= rel:       # also true for NaN
            rel, worst = err, nm
    return int((~agree).sum()), rel, worst


def grid_fields(torch, sht, spec, K):
    """Grid T, u, v, q (K each) and logp of level 0 of a spectral state."""
    ucosm, vcosm = sht.uvspec(spec.vor[0], spec.div[0])
    out = sht.synthesis(torch.cat([spec.t[0], spec.tr[0, 0],
                                   spec.ps[0][None], ucosm, vcosm]),
                        2 * K + 1)
    return dict(t=out[:K], q=out[K:2 * K], logp=out[2 * K][None],
                u=out[2 * K + 1:3 * K + 1], v=out[3 * K + 1:])


def to_device(torch, obj, dev):
    """A copy of a state (tensors, dataclasses and named tuples of them)
    on `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(torch, getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_device(torch, v, dev) for v in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(torch, v, dev) for v in obj)
    return obj


def window_errs(torch, gcm, gcm_c, gk, gp, magnitude=False):
    """signal_err of each grid variable of state gk (on gcm's device)
    against gp (gcm_c's, the CPU)."""
    K = gcm.geom.nlev
    a = grid_fields(torch, gcm.sht, gk.spectral, K)
    b = grid_fields(torch, gcm_c.sht, gp.spectral, K)
    return {v: signal_err(a[v].cpu(), b[v], magnitude) for v in a}


def window_steps(torch, gcm, gcm_c, gk, fo_k, fo_p, nsteps, eta_fn=None):
    """nsteps leapfrog steps of gcm from gk, each held to gcm_c's step (on
    the CPU) from the same state.  The two sides' physics see grids that
    differ in the last bits (their transforms sum in other orders), so a
    near-tie decision (convection on or off, a cloud top) can fall the
    other way in a column, as phase 4 allows for the column kernels: a
    column whose physics tendencies (u, v, t, q at any level) differ by
    more than WINDOW_FLIP_RTOL of the field's largest tendency counts as
    such a flip, and gcm_c's step takes gcm's tendencies there.  Returns (gcm's
    state after the steps, the worst step's window_errs, the flipped
    columns of each step, the largest relative tendency difference in the
    other columns).  eta_fn: with SPPT, a function that draws the step's
    noise on the card; both sides' steps then take that draw."""
    seen, flips, near = [], [], 0.0

    def physics(gm, patch):
        def fn(*a, **kw):
            tend, aux = type(gm)._physics_fn(gm, *a, **kw)
            return patch(tend), aux
        return fn

    def adopt(tend):   # the plain side's tendencies, the card's where flipped
        nonlocal near
        ref = [t.cpu() for t in seen[-1]]
        nlat, nlon = ref[0].shape[-2:]
        d = torch.stack([((c - k).abs() / k.abs().max().clamp(min=1e-30))
                         .reshape(-1, nlat, nlon).amax(0)
                         for c, k in zip(tend, ref)]).amax(0)
        flip = d > WINDOW_FLIP_RTOL
        flips.append(int(flip.sum()))
        near = max(near, float(torch.where(flip, 0.0, d).max()))
        return type(tend)(*[torch.where(flip, k, c)
                            for c, k in zip(tend, ref)])

    es = None
    for _ in range(nsteps):
        seen.clear()
        gcm._physics_fn = physics(gcm, lambda t: seen.append(t) or t)
        gcm_c._physics_fn = physics(gcm_c, adopt)
        kw_k = kw_c = {}
        if eta_fn is not None:
            eta = eta_fn()
            kw_k, kw_c = dict(eta=eta), dict(eta=eta.cpu())
        try:
            nk = gcm.leapfrog(gk, fo_k, **kw_k)
            nc = gcm_c.leapfrog(to_device(torch, gk, torch.device("cpu")),
                                fo_p, **kw_c)
        finally:
            del gcm._physics_fn, gcm_c._physics_fn
        step = window_errs(torch, gcm, gcm_c, nk, nc)
        es = step if es is None else {v: max(es[v], step[v]) for v in es}
        gk = nk
    return gk, es, flips, near


def signal_err(got, ref, magnitude: bool = False):
    """|got - ref| over one variable's (all its levels) signal: its
    largest departure from its mean, or with magnitude=True its largest
    magnitude."""
    sig = float((ref if magnitude else ref - ref.mean()).abs().max())
    return float((got - ref).abs().max()) / max(sig, 1e-30)


def max_abs(torch, t) -> float:
    """max |t| over a (R, ...) tensor, one region at a time (no full-size
    temporary)."""
    return max(float(t[r].abs().max()) for r in range(t.shape[0]))


def max_abs_diff(torch, a, b) -> float:
    return max(float((a[r] - b[r]).abs().max()) for r in range(a.shape[0]))


def k14_operands(torch, C, R, n, S, O, dtype, gen):
    """Random (states, model, target, ss, st) of one chunk on the card."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=dtype)
    A = S + n
    return (torch.tanh(rnd(C, R, n)), rnd(C, R, S), rnd(C, R, O),
            rnd(R, A, A), rnd(R, O, A))


def k14_bound(C, R, n, S, O):
    """K14's bound for the symmetric work, 2*C*R*(A(A+1)/2 + O*A) FLOPs,
    and for the full matrix, 2*C*R*A*(A+O): each (ms, what binds)."""
    A = S + n
    nbytes = 4 * (2 * R * A * (A + O) + C * R * (n + S + O))
    return (bound_ms(nbytes, 2.0 * C * R * (A * (A + 1) / 2 + O * A),
                     PEAK_F32_S),
            bound_ms(nbytes, 2.0 * C * R * A * (A + O), PEAK_F32_S))


def k14_case(torch, label, C, R, n, S, O, card, gen):
    """K14 against its plain version on random operands of one shape, in
    float64 on 8 of the regions (both tile lists, full and symmetric) and
    in float32, then timed in float32: kernel, plain version,
    torch.baddbmm on the materialized aug; in both types an update of a
    symmetric ss must leave it exactly symmetric.  Returns (the float32
    relative error, ((device_ms, call_ms) of kernel, plain version and
    baddbmm, the bound)); the bound is that of the symmetric work, and
    the full-matrix one is logged beside it."""
    from speedy_ml_tpu_torch.kernels.gram_update import (SYM_MIN_C, _update,
                                                         augment,
                                                         gram_update,
                                                         gram_update_plain)
    A = S + n
    own = "symmetric" if C >= SYM_MIN_C else "full"

    def compare(ops, rtol, tag, update):
        states, model, target, ss0, st0 = ops
        ss_k, st_k = ss0.clone(), st0.clone()
        st_start = st0.clone()
        update(ss_k, st_k, states, model, target)
        gram_update_plain(ss0, st0, states, model, target)
        torch.cuda.synchronize()
        if not max_abs_diff(torch, st_k, st_start) > 0:
            fail(f"K14 ({label}, {tag}) left st as it was")
        err = max(max_abs_diff(torch, ss_k, ss0) / max_abs(torch, ss0),
                  max_abs_diff(torch, st_k, st0) / max_abs(torch, st0))
        log(f"K14 {label} {tag}: C={C} R={ss0.shape[0]} A={A} O={O}, "
            f"error {err:.3e} of max|ss|, max|st| (tolerance {rtol:.0e})")
        if not err <= rtol:
            fail(f"K14 ({label}, {tag}) disagrees with its plain version")
        return err, (ss_k, st_k)

    def stays_symmetric(ss, st, states, model, target, tag, update):
        for r in range(ss.shape[0]):
            ss[r] += ss[r].T.clone()
        update(ss, st, states, model, target)
        torch.cuda.synchronize()
        if not all(torch.equal(ss[r], ss[r].T) for r in range(ss.shape[0])):
            fail(f"K14 ({label}, {tag}) left a symmetric ss unsymmetric")

    for sym in (False, True):   # both tile lists in float64
        name = "symmetric" if sym else "full"
        update = lambda *a, sym=sym: _update(*a, sym=sym)
        ops64 = k14_operands(torch, C, min(R, 8), n, S, O, torch.float64,
                             gen)
        _, (ss64, st64) = compare(ops64, K14_RTOL_F64,
                                  f"float64, {name} tile list", update)
        stays_symmetric(ss64, st64, *ops64[:3], f"float64, {name} list",
                        update)
        del ops64, ss64, st64
    ops = k14_operands(torch, C, R, n, S, O, torch.float32, gen)
    err, (ss_k, st_k) = compare(ops, K14_RTOL, "float32", gram_update)
    states, model, target, ss_p, st_p = ops
    k = measure(torch, lambda: gram_update(ss_k, st_k, states, model,
                                           target), reps=5, warmup=1)
    p = measure(torch, lambda: gram_update_plain(ss_p, st_p, states, model,
                                                 target), reps=3, warmup=1)
    aug = augment(states, model).transpose(0, 1).contiguous()   # (R, C, A)
    tgt = target.transpose(0, 1).contiguous()
    augt, tgtt = aug.transpose(1, 2), tgt.transpose(1, 2)
    lib = measure(torch, lambda: (ss_p.baddbmm_(augt, aug),
                                  st_p.baddbmm_(tgtt, aug)), reps=5,
                  warmup=1)
    del aug, tgt, augt, tgtt, ss_p, st_p, ops
    stays_symmetric(ss_k, st_k, states, model, target, "float32",
                    gram_update)
    bound, full = k14_bound(C, R, n, S, O)
    log(f"K14 {label}: kernel {k[0]:.4f} ms ({own} tile list), plain "
        f"{p[0]:.4f} ms, torch.baddbmm {lib[0]:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}, {bound[0] / k[0]:.0%} of it; full "
        f"matrix {full[0]:.4f} ms, {full[1]}); ss stays symmetric [{card}]")
    if k[0] > lib[0]:
        log(f"  K14 {label} is slower than torch.baddbmm")
    return err, (k, p, lib, bound)


def k14_lists(torch, n, S, O, card):
    """chip_smoke --k14-lists: K14's two tile lists timed (float32) at
    chunks of K14_LIST_CS samples of the trainer's default region chunk,
    the numbers that set gram_update.SYM_MIN_C; then, at the interior
    chunk of phase 10, the panel kernel and the tile kernel apart, and an
    in-place add over ss and st (the card's rate for reading and writing
    those bytes back, with no products)."""
    from speedy_ml_tpu_torch.hybrid.chunked import train_class_production
    from speedy_ml_tpu_torch.kernels.gram_update import SYM_MIN_C, _update
    R = inspect.signature(train_class_production) \
        .parameters["region_chunk"].default
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for C in K14_LIST_CS:
        states, model, target, ss, st = k14_operands(torch, C, R, n, S, O,
                                                     torch.float32, gen)
        t = {sym: measure(torch, lambda sym=sym: _update(
            ss, st, states, model, target, sym=sym), reps=5, warmup=1)[0]
             for sym in (False, True)}
        bound, _ = k14_bound(C, R, n, S, O)
        log(f"K14 C={C} R={R}: full tile list {t[False]:.4f} ms, symmetric "
            f"{t[True]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"gram_update takes the "
            f"{'symmetric' if C >= SYM_MIN_C else 'full'} list [{card}]")
        del states, model, target, ss, st
        torch.cuda.empty_cache()
    C, R = TIME_CHUNK, REGION_CHUNK
    states, model, target, ss, st = k14_operands(torch, C, R, n, S, O,
                                                 torch.float32, gen)
    call = lambda: _update(ss, st, states, model, target,
                           sym=C >= SYM_MIN_C)
    call()
    _, avg, _ = profile_device(torch, call, 5)
    split = ", ".join(f"{e.key[:40]} {_self_device_us(e) / 5e3:.4f} ms"
                      for e in avg)
    rmw = measure(torch, lambda: (ss.add_(1.0), st.add_(1.0)), reps=5,
                  warmup=1)
    bound, _ = k14_bound(C, R, n, S, O)
    log(f"K14 C={C} R={R}: {split}; ss.add_ + st.add_ (the same bytes "
        f"read and written, no products) {rmw[0]:.4f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}) [{card}]")


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def pack_tensors(pk) -> dict:
    """A ClassPack's parameter tensors by name."""
    out = {k: getattr(pk.res, k) for k in ("cols", "vals", "win_vals",
                                           "wout", "mean", "std",
                                           "win_cols")}
    out.update({f"std_{k}": getattr(pk.std, k) for k in (
        "comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
        "out_std")})
    return out


def same_packs(torch, a, b, what: str):
    """Every parameter tensor of every pack equal (torch.equal), and the
    static parts; fails naming the first that differs."""
    for p, q in zip(a, b):
        ta, tb = pack_tensors(p), pack_tensors(q)
        for k, v in ta.items():
            w = tb[k]
            if (v is None) != (w is None) or (v is not None and not (
                    v.dtype == w.dtype and torch.equal(v, w))):
                fail(f"{what}: class {p.cls.name} {k} differs")
        if (p.res.n_in, p.res.shifts, p.hyper) != (q.res.n_in, q.res.shifts,
                                                   q.hyper):
            fail(f"{what}: class {p.cls.name}'s static parts differ")
    if len(a) != len(b):
        fail(f"{what}: {len(a)} packs against {len(b)}")


def same_states(torch, a, b) -> bool:
    """Two HybridStates equal bit for bit (every class's x, feedback and
    local model, and the gate)."""
    return bool(a.safe) == bool(b.safe) and all(
        torch.equal(getattr(p, k), getattr(q, k))
        for p, q in zip(a.classes, b.classes)
        for k in ("x", "feedback", "local_model"))


def phase_checkpoint(torch, gcm, layout, hyb_t, hyb_bf, src, hyper, truth,
                     dates, train_wall, card, ck: str):
    """Phase 10f: save and load the trained hybrid at full width (hyb_t,
    float32 Wout; then hyb_bf, its bf16 cast), two coupled cycles of the
    trained and the loaded bf16 hybrid from one state, and
    train_hybrid_production's atmo_ckpt twice (the second call loads and
    trains nothing), into the directory ck, which phase 13 loads."""
    import tempfile

    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid, save_hybrid
    from speedy_ml_tpu_torch.hybrid.chunked import train_hybrid_production
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update

    dev = torch.device("cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for form, hyb in (("float32", hyb_t), ("bf16", hyb_bf)):
            path = tmp / form
            _, t_save = timed(lambda: save_hybrid(hyb, str(path)))
            nbytes = dir_bytes(path)
            loaded, t_load = timed(lambda: load_hybrid(
                gcm, layout, str(path), device=dev))
            if form == "bf16":
                loaded.cast_wout_bf16()
            same_packs(torch, loaded.packs, hyb.packs,
                       f"the {form} checkpoint")
            parts.append(f"{form} Wout: save {t_save:.2f} s, "
                         f"{nbytes / 1e9:.3f} GB on disk, load onto the "
                         f"card {t_load:.2f} s")
            shutil.rmtree(path)
            if form == "float32":
                del loaded
                torch.cuda.empty_cache()
        # two coupled cycles of the trained and the loaded hybrid
        st0 = hyb_bf.init_state(truth["sst"][-1])
        date = dates[-1].advance_hours(6)
        a, _ = run_prediction(hyb_bf, st0, date, 2, stop_if_unsafe=False)
        b, _ = run_prediction(loaded, st0, date, 2, stop_if_unsafe=False)
        if not same_states(torch, a, b):
            fail("two coupled cycles of the loaded hybrid differ from the "
                 "trained hybrid's")
        del loaded, a, b
        torch.cuda.empty_cache()
        log("checkpoint (save_hybrid, load_hybrid; every parameter tensor "
            "torch.equal after the load, and after the bf16 cast): "
            + "; ".join(parts) + "; two coupled cycles of run_prediction "
            f"from one state, trained and loaded hybrid: equal bit for bit "
            f"[{card}]")

        # train_hybrid_production with atmo_ckpt: trains and saves, then
        # loads and trains nothing (no K14, no K1)
        kw = dict(hybrid=True, stride=1, time_chunk=TIME_CHUNK,
                  n_discard=N_DISCARD, region_chunk=REGION_CHUNK,
                  solve_dtype=torch.float64, atmo_ckpt=ck, device=dev)
        first, t_first = timed(lambda: train_hybrid_production(
            gcm, layout, src, hyper, TRAIN_SEED, **kw))
        nbytes = dir_bytes(ck)
        for fn in (esn_step, gram_update):
            fn.launches = 0
        second, t_second = timed(lambda: train_hybrid_production(
            gcm, layout, src, hyper, TRAIN_SEED, **kw))
        n14, n1 = gram_update.launches, esn_step.launches
        if n14 or n1:
            fail(f"the resumed train_hybrid_production launched K14 {n14} "
                 f"and K1 {n1} times")
        same_packs(torch, second.packs, first.packs, "the resumed training")
        log(f"atmo_ckpt: the first train_hybrid_production call trained and "
            f"saved in {t_first:.2f} s ({nbytes / 1e9:.3f} GB), the second "
            f"loaded it in {t_second:.2f} s (the training alone: "
            f"{train_wall:.1f} s in 10c) and launched no K14 and no K1; its "
            f"packs equal the first's [{card}]")
        del first, second
        torch.cuda.empty_cache()


def write_boundary_files(np, root: Path, geom, seed: int):
    """fort.20-24 and fort.26 in the reference's layout (records of
    little-endian float32 rows of nlon, north to south): seeded smooth
    continents with a fractional coast and orography over them, monthly
    climatologies with a seasonal cycle, and the reference's fills: -999
    (read as 0) in the snow and the sea ice, and negative values (filled
    by fillsf from their row) in the SST, over land most of all, and the
    land temperature."""
    rng = np.random.default_rng(seed)
    lat = geom.lat_radians[:, None]
    lon = np.arange(geom.nlon)[None, :] * 2 * np.pi / geom.nlon
    shape = (geom.nlat, geom.nlon)

    def smooth():
        f = sum(rng.normal() * np.cos(k * lon + rng.uniform(0, 2 * np.pi))
                * np.cos(l * lat + rng.uniform(0, 2 * np.pi))
                for k in range(1, 5) for l in range(4))
        return (f - f.mean()) / f.std()

    fmask = np.clip(0.5 + 0.8 * smooth(), 0.0, 1.0)
    land = fmask > 0.9

    def holes(f, frac, value, where=True):
        f = f.copy()
        f[(rng.uniform(size=shape) < frac) & where] = value
        return f

    season = lambda m, amp: amp * np.sin(lat) * np.cos(
        2 * np.pi * (m - 0.5) / 12)
    ones = np.ones(shape)
    sst = 273.0 + 27.0 * np.cos(lat) ** 2 * ones + rng.uniform(-1, 1, shape)
    stl = 250.0 + 40.0 * np.cos(lat) ** 2 * ones + rng.uniform(-2, 2, shape)
    polar = np.clip((np.abs(np.rad2deg(lat)) - 60.0) / 20.0, 0.0, 1.0) * ones

    def write(unit, records):
        data = np.stack([r[::-1] for r in records]).astype("<f4")
        data.tofile(root / f"fort.{unit}")

    months = range(12)
    write(20, [2000.0 * fmask * np.clip(0.5 + 0.3 * smooth(), 0, 1), fmask,
               rng.uniform(0.07, 0.4, shape), rng.uniform(0, 0.8, shape),
               rng.uniform(0, 0.8, shape)])
    write(21, [holes(holes(sst + season(m, 2.0), 0.05, -1.0), 0.5, -1.0,
                     land) for m in months])
    write(22, [holes(np.clip(polar + season(m, 0.2), -0.05, 1.0), 0.03,
                     -999.0) for m in months])
    write(23, [holes(stl + season(m, 8.0), 0.05, -2.0) for m in months])
    write(24, [holes(60.0 * polar * rng.uniform(0, 1, shape), 0.03, -999.0)
               for _ in months])
    write(26, [rng.uniform(0.05, 0.35, shape) for _ in range(36)])


def phase_files(torch, np, gcm, layout, date0, card):
    """Phase 11: the paths from files.  (a) reference-format weights at
    full width through import_reference_weights, 4 coupled cycles of
    run_prediction with K1 in its per-region cols mode; (b) fort.20-26
    written at T30, a GCM on the card from them against the CPU load, and
    one window; (c) a GCM restart: the next window from the loaded state
    against the next window from the original."""
    import tempfile

    from speedy_ml_tpu_torch.data.checkpoint import (gcm_leaves,
                                                     load_gcm_restart,
                                                     save_gcm_restart)
    from speedy_ml_tpu_torch.data.reference_import import (
        import_reference_weights, synthesize_reference_worker)
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.physics.boundaries import (BoundaryData,
                                                        load_boundary_data)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = gcm.geom
    nz = g.nlev

    # -- 11a. reference-format weights: one seeded generator per region;
    #    land regions (a seeded mask) have no SST input, so n is ragged
    land = np.random.default_rng(SEED + 21).uniform(
        size=layout.n_regions) < LAND_SHARE
    shapes = {int(r): (c.core_shape, c.input_shape) for c in layout.classes
              for r in c.region_ids}
    seen = {}

    def reader(region):
        core, inp = shapes[region]
        w = synthesize_reference_worker(
            np.random.default_rng([SEED, 22, region]), nz, core, inp,
            has_sst=not land[region], m=M, model_identity=True)
        seen[w["n"]] = seen.get(w["n"], 0) + 1
        return w

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyb_r = import_reference_weights(gcm, layout, nz, reader, device=dev)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    for pk in hyb_r.packs:
        if (pk.res.cols.ndim != 3 or pk.res.win_cols is None
                or pk.res.shifts is not None):
            fail(f"imported class {pk.cls.name} is not in the per-region "
                 f"cols form")
    hyb_r.cast_wout_bf16()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "pred"
        st = hyb_r.init_state(sst_month0(g))
        torch.cuda.synchronize()
        esn_step.launches = 0
        esn_step.mode_launches = [0, 0, 0]
        end, dts = run_prediction(hyb_r, st, date0, CYCLES_IMPORTED,
                                  output_path=str(out))
        torch.cuda.synchronize()
        modes = list(esn_step.mode_launches)
        z = np.load(str(out) + ".npz")
        atmo = z["atmo"]
    want = CYCLES_IMPORTED * len(hyb_r.packs)
    if modes != [0, 0, want]:
        fail(f"K1 ran {modes} launches by mode (shifts, shared cols, "
             f"per-region cols) in {CYCLES_IMPORTED} imported cycles, not "
             f"{want} in per-region cols")
    if len(dts) != CYCLES_IMPORTED or not bool(end.safe):
        fail(f"the imported hybrid stopped after {len(dts)} cycles")
    if not np.isfinite(atmo).all():
        fail("the imported hybrid's fields are not finite")
    tmin, tmax = float(atmo[:, 0].min()), float(atmo[:, 0].max())
    if not (150.0 <= tmin and tmax <= 350.0):
        fail(f"the imported hybrid's T is outside [150, 350] K: "
             f"{tmin}..{tmax}")
    log(f"reference import: {layout.n_regions} synthesized workers "
        f"(n: " + ", ".join(f"{n} x {c}" for n, c in sorted(seen.items()))
        + f"; m={M}, identity model block) assembled on the card in "
        f"{t_imp:.2f} s wall; {CYCLES_IMPORTED} coupled cycles of "
        f"run_prediction (bf16 Wout), K1 launched {modes[2]} times in its "
        f"per-region cols mode (mode 2, win_cols), fields finite, T "
        f"{tmin:.2f}..{tmax:.2f} K [{card}]")
    del hyb_r, end, st
    torch.cuda.empty_cache()

    # -- 11b. boundary files at T30, a GCM on the card from them
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_boundary_files(np, root, g, SEED + 23)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gcm_f = GCM(g, dtype=torch.float32, bc_path=str(root), device=dev)
        torch.cuda.synchronize()
        t_gcm = time.perf_counter() - t0
        cpu_bd = load_boundary_data(g, path=str(root), dtype=torch.float32,
                                    device="cpu")
        for k in BoundaryData.__dataclass_fields__:
            a = getattr(gcm_f.bd, k)
            if a.device.type != dev.type or not torch.equal(
                    a.cpu(), getattr(cpu_bd, k)):
                fail(f"the GCM's boundary field {k} differs from the CPU "
                     f"load")
        steps = gcm_f.nsteps_day * 6 // 24
        state, forcing = gcm_f.init_state(date0)
        w1 = gcm_f.run_window(gcm_f.stepone(state, forcing), forcing, steps)
        spec = [getattr(w1.spectral, k) for k in ("vor", "div", "t", "ps",
                                                  "tr")]
        if not all(bool(torch.isfinite(torch.view_as_real(v)).all())
                   for v in spec):
            fail("the window of the file-loaded GCM is not finite")
        log(f"boundary files: fort.20-24 and fort.26 at T{g.trunc} "
            f"({g.nlat}x{g.nlon}, a seeded mixed land mask, land fraction "
            f"{float(cpu_bd.fmask_l.mean()):.3f}); GCM(bd=None, bc_path=) on "
            f"the card in {t_gcm:.2f} s, its BoundaryData equal to "
            f"load_boundary_data on the CPU, field by field and bit for "
            f"bit; a window ({steps} steps after stepone) finite [{card}]")

        # -- 11c. the GCM restart
        path = root / "restart.npz"
        t0 = time.perf_counter()
        save_gcm_restart(w1, str(path))
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_gcm_restart(str(path), gcm_f.init_state(date0)[0])
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        nbytes = path.stat().st_size
        a = gcm_f.run_window(w1, forcing, steps)
        b = gcm_f.run_window(back, forcing, steps)
        if a.istep != b.istep or not all(
                torch.equal(x, y) for x, y in zip(gcm_leaves(a)[:-1],
                                                  gcm_leaves(b)[:-1])):
            fail("the window from the restarted state differs from the "
                 "window from the original")
        log(f"GCM restart: save_gcm_restart {t_save:.3f} s "
            f"({nbytes / 1e6:.3f} MB, {len(gcm_leaves(w1))} leaves), "
            f"load_gcm_restart onto the card {t_load:.3f} s; the next "
            f"window from the loaded state equal to the original's, bit for "
            f"bit; phase 11 took {time.perf_counter() - t_phase:.1f} s "
            f"[{card}]")


def continents_bd(torch, np, bd, geom):
    """The boundary data `bd` (the synthetic aquaplanet) with smooth
    continents and a fractional coast (fmask_l from 0 to 1), its other
    fields as they are: land for the slab land model to move, on which
    SPEEDY runs."""
    lat = geom.lat_radians[:, None]
    lon = np.arange(geom.nlon)[None, :] * 2 * np.pi / geom.nlon
    fm = np.clip(0.5 + np.cos(2 * lon) * np.cos(lat)
                 + 0.4 * np.sin(lon + 3 * lat), 0.0, 1.0)
    t = lambda a: torch.as_tensor(a, dtype=bd.fmask_l.dtype,
                                  device=bd.fmask_l.device)
    return dataclasses.replace(
        bd, fmask=t(fm), fmask_l=t(fm), fmask_s=t(1.0 - fm),
        bmask_l=t((fm > 0.5).astype(float)),
        bmask_s=t((fm <= 0.5).astype(float)))


def phase_surface(torch, np, gcm, hyb, date0, card, record, kernels):
    """Phase 12: the persistent coupled surface and the daily slab
    coupler.  (a) K21 in its three forms (accumulate, couple with icsea
    0, 2, 3 and 4 and isstan 1, the day form with three anomaly planes),
    with a tripped gate over window sums that hold NaN, and K17's carry
    form, against their plain versions in float32 and float64 on a seeded
    mixed land mask with sea ice: 0 difference; timed. (b) Eight
    persistent coupled cycles at full width from step 0 through
    run_prediction, on the aquaplanet with smooth continents: K21 eight
    launches, the sums zero after cycles 4 and 8 and non-zero and finite
    otherwise, stl_lm off the climatology over land after a coupling,
    the fields finite and T in [150, 350] K, four more cycles with host
    syncs forbidden, launches a cycle (at most LAUNCHES_MAX + 1) and
    device busy. (c) The gate's select (C4): a cycle from a state whose
    safe is false keeps the sums bit for bit, and a coupling from one
    gives a finite surface. (d) GCM.run_days for 2 days with
    CplFlags(icsea=2, isstan=1) and a seeded anomaly series, sst_am the
    ice blend of sst_om within 1e-4 K; then generate_nature_run with its
    default 5 days of spin-up.  Returns K21's launches in (b)."""
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu_torch.hybrid.training import generate_nature_run
    from speedy_ml_tpu_torch.kernels import slab_couple as k21
    from speedy_ml_tpu_torch.kernels import surface_forcing as sfk
    from speedy_ml_tpu_torch.physics import land_sea

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    g = gcm.geom
    nlat, nlon = g.nlat, g.nlon
    G = nlat * nlon
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    lat_deg = np.rad2deg(g.lat_radians)

    # -- (a) the kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rnd = lambda lo, hi, *lead: lo + (hi - lo) * torch.rand(
        lead + (nlat, nlon), generator=gen, device=dev, dtype=f64)
    fm = torch.where(rnd(0, 1) < 0.4, 0.0, rnd(0, 1))
    bd64 = dataclasses.replace(
        gcm.bd.to(dtype=f64), fmask_l=fm, fmask_s=1.0 - fm,
        phis0=2.0e4 * fm * rnd(0, 1), alb0=rnd(0.1, 0.6),
        stl12=rnd(250, 310, 12), snowd12=rnd(0, 100, 12),
        soilw12=rnd(0, 1, 12), sst12=rnd(268, 305, 12),
        sice12=torch.where(rnd(0, 1, 12) < 0.5, 0.0, rnd(0, 1, 12)))
    ops64 = dict(pert=[rnd(-2, 2) for _ in range(3)],
                 acc=[rnd(-60, 60) for _ in range(4)],
                 win=[rnd(-20, 20) for _ in range(4)], an=rnd(-1.5, 1.5),
                 planes=[rnd(-1.5, 1.5) for _ in range(3)],
                 om12=bd64.sst12 + rnd(-0.5, 0.5, 12),
                 stl=rnd(250, 310))
    wsst64 = torch.as_tensor(land_sea.sea_domain_mask("elnino", lat_deg,
                                                      nlon), device=dev)
    forms = [("accumulate", 0, True), ("accumulate, gate tripped", 0, False),
             ("couple icsea 0", 0, True), ("couple icsea 2", 2, True),
             ("couple icsea 3 (sstom12)", 3, True), ("couple icsea 4", 4,
                                                      True),
             ("couple, gate tripped", 0, False), ("day fmon 0.25", 0, True),
             ("day fmon 0.75", 2, True)]
    worst, k21_err, main_args = {}, 0.0, None
    for dt in (f32, f64):
        c = lambda t: t.to(dt).contiguous()
        bd_ = bd64.to(dtype=dt)
        clim = land_sea.init_surface_state(bd_, imon, fmon,
                                           flags=land_sea.CplFlags(icsea=2))
        carry = dataclasses.replace(clim, **{
            k: getattr(clim, k) + c(p) for k, p in zip(
                ("stl_lm", "sst_om", "tice_om"), ops64["pert"])})
        acc = [c(a) for a in ops64["acc"]]
        win = [c(w) for w in ops64["win"]]
        win_nan = [w.clone() for w in win]
        for w in win_nan:
            w[nlat // 2, 7] = float("nan")
        coef = land_sea.build_slab_coeffs(bd_, lat_deg, dt, device=dev)
        for label, icsea, gate in forms:
            flags = land_sea.CplFlags(icsea=icsea, isstan=1)
            kw = dict(wsst=c(wsst64),
                      sstom12=c(ops64["om12"]) if icsea == 3 else None)
            month = (imon, fmon)
            if label.startswith("day"):
                fm_ = float(label.split()[-1])
                month = (imon, fm_)
                kw.update(sstan=([c(p) for p in ops64["planes"]], fm_))
            else:
                kw.update(window=win if gate else win_nan,
                          ok=torch.tensor(gate, device=dev),
                          do_couple=label.startswith("couple"),
                          sstan=c(ops64["an"]))
            k = k21.slab_couple(bd_, coef, carry, acc, month, flags, **kw)
            p = k21.slab_couple_plain(bd_, coef, carry, acc, month, flags,
                                      **kw)
            err = 0.0
            for a, b in zip(k, p):
                if (a is None) != (b is None):
                    fail(f"K21 ({label}) returned other outputs than its "
                         f"plain version")
                if a is None:
                    continue
                if not bool(torch.isfinite(a).all()):
                    fail(f"K21 ({label}, {dt}) is not finite")
                err = max(err, max_abs_diff(torch, a, b))
            worst[f"{label}, {str(dt)[6:]}"] = err
            if dt == f32:
                k21_err = max(k21_err, err)
            if label == "couple icsea 0" and dt == f32:
                main_args = (bd_, coef, carry, acc, month, flags,
                             dict(kw, sstan=None),
                             [c(p) for p in ops64["planes"]])
        # K17's carry form: the forcing reads the carried stl_lm
        day = (gcm.phys.day_args(tyear) if dt == f32 else sfk.DayArgs(
            tyear, torch.as_tensor(g.sin_lat, dtype=f64, device=dev),
            torch.as_tensor(g.cos_lat, dtype=f64, device=dev),
            gcm.phys.gamlat, gcm.phys.pexp))
        stl = c(ops64["stl"])
        ks, kf = sfk.surface_forcing(bd_, month=(imon, fmon), day=day,
                                     sst_hybrid=bd_.sst12[imon] - 1.0,
                                     stl_carry=stl)
        ps = sfk.surface_plain(bd_, imon, fmon,
                               sst_hybrid=bd_.sst12[imon] - 1.0)
        q = dict(zip(sfk.SURFACE, ps))
        pf = sfk.forcing_plain(bd_, stl, q["snowd"], q["sst_am"], q["sice"],
                               day, nlon)
        e17 = max(max_abs_diff(torch, ks, ps), max_abs_diff(torch, kf, pf))
        worst[f"K17 carry form, {str(dt)[6:]}"] = e17
    bad = {k: v for k, v in worst.items() if v > 0}
    log(f"K21 slab_couple and K17's carry form against their plain "
        f"versions ({len(worst)} cases, float32 and float64, a seeded "
        f"mixed land mask with sea ice; the gate tripped over window sums "
        f"holding NaN): max_abs_err {max(worst.values()):.3e} "
        f"(tolerance 0); cases that differ: {bad or 'none'}")
    if bad:
        fail("K21 or K17's carry form disagrees with its plain version")
    # times: the cycle's two forms and the day form, float32 at T30
    bd_, coef, carry, acc, month, flags, kw, planes = main_args
    win, ok = kw["window"], kw["ok"]
    couple = lambda: k21.slab_couple(bd_, coef, carry, acc, month, flags,
                                     window=win, ok=ok, do_couple=True)
    accum = lambda: k21.slab_couple(bd_, coef, carry, acc, month, flags,
                                    window=win, ok=ok, do_couple=False)
    day_kw = dict(sstan=(planes, fmon))
    dayf = lambda: k21.slab_couple(bd_, coef, carry, acc, month, flags,
                                   **day_kw)
    # bytes: couple, the months forin5 and forint read (16 planes), the
    # carry (3), the coefficients (6), the sums and the window's (8), the
    # flag, out 10 + 4 planes; accumulate 8 in, 4 out; the day form 16 +
    # 3 + 6 + 4 + 3 in, 10 out.  Operations: ~80 a point when coupling
    nb = lambda planes: 4 * G * planes
    (kc, kc_c), kc_runs = measure_median(torch, couple)
    (ka, _), _ = measure_median(torch, accum)
    (kd, _), _ = measure_median(torch, dayf)
    ba = bound_ms(nb(12), 4 * G, PEAK_F32_S)
    bday = bound_ms(nb(42), 80 * G, PEAK_F32_S)
    log(f"K21 sessions, couple form (device ms): "
        + ", ".join(f"{r:.4f}" for r in kc_runs)
        + f"; accumulate form {ka:.4f} ms (bound {ba[0]:.5f}); day form "
        f"{kd:.4f} ms (bound {bday[0]:.5f}) [{card}]")
    record("K21_slab_couple",
           "speedy_ml_tpu_torch/kernels/csrc/slab_couple.cu",
           "speedy_ml_tpu/physics/land_sea.py:244", k21_err, 0.0,
           (kc, kc_c),
           measure(torch, lambda: k21.slab_couple_plain(
               bd_, coef, carry, acc, month, flags, window=win, ok=ok,
               do_couple=True), reps=10),
           bound_ms(nb(47) + 1, 80 * G, PEAK_F32_S))

    # -- (b) eight persistent coupled cycles at full width ----------------
    gcm_l = GCM(g, dtype=f32, bd=continents_bd(torch, np, gcm.bd, g),
                device=dev)
    h = HybridAtmosphere(gcm_l, hyb.layout, hyb.packs, ml_only=False,
                         device=dev)
    h.persist_surface = True
    land = gcm_l.bd.fmask_l >= 1.0 / 3.0
    out = ROOT / "output" / "chip_smoke" / "prediction_persist.npz"
    s = h.init_state(sst_month0(g))
    date = date0
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    walls, notes = [], []
    for i in range(1, PERSIST_CYCLES + 1):
        out.unlink(missing_ok=True)
        t0 = time.perf_counter()
        s, dts = run_prediction(h, s, date, 1, output_path=str(out))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(dts) != 1 or not bool(s.safe):
            fail(f"persistent cycle {i} tripped the gate")
        z = np.load(out)
        t_field = z["atmo"][:, 0]
        if not all(np.isfinite(z[k]).all() for k in z.files) or not (
                150.0 <= t_field.min() and t_field.max() <= 350.0):
            fail(f"persistent cycle {i}: fields not finite or T outside "
                 f"[150, 350] K ({t_field.min()}..{t_field.max()})")
        for k in s.sfc.__dataclass_fields__:
            if not bool(torch.isfinite(getattr(s.sfc, k)).all()):
                fail(f"persistent cycle {i}: sfc.{k} is not finite")
        fx = torch.stack([s.fluxes.hflux_l, s.fluxes.hflux_s,
                          s.fluxes.hflux_i, s.fluxes.precip])
        fx_max = float(fx.abs().max())
        if not bool(torch.isfinite(fx).all()) or (
                (fx_max == 0.0) != (i % 4 == 0)):
            fail(f"persistent cycle {i}: the sums {fx_max:.3e} (zero "
                 f"only after a coupling, finite)")
        if i % 4 == 0:
            stlcl = sfk.surface_plain(gcm_l.bd, date.month - 1,
                                      date.tmonth)[0]
            moved = float((s.sfc.stl_lm - stlcl).abs()[land].max())
            if not moved > 0.0:
                fail(f"cycle {i} coupled, but stl_lm over land is the "
                     f"climatology")
            notes.append(f"after cycle {i} stl_lm {moved:.3f} K off the "
                         f"climatology over land")
        else:
            notes.append(f"sums after cycle {i} max {fx_max:.4g}")
        date = date.advance_hours(6)
    torch.cuda.synchronize()
    n21 = k21.slab_couple.launches
    n17 = kernels["K17_surface_forcing"].launches
    if n21 != PERSIST_CYCLES or n17 != PERSIST_CYCLES + 1:
        fail(f"persistent cycles: K21 {n21} and K17 {n17} launches, "
             f"expected {PERSIST_CYCLES} and {PERSIST_CYCLES + 1}")
    log(f"persistent surface: {PERSIST_CYCLES} coupled cycles through "
        f"run_prediction from step 0, K21 {n21} launches, K17 {n17} (one "
        f"more: the first cycle's climatology); " + "; ".join(notes)
        + f"; T {t_field.min():.2f}..{t_field.max():.2f} K; wall per "
        f"cycle with the "
        f"writer {', '.join(f'{w:.3f}' for w in walls)} s")
    # no host sync in four cycles (an accumulation to a coupling)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            s, _ = h.cycle(s, date.month - 1, date.tmonth, date.tyear)
            date = date.advance_hours(6)
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"a persistent cycle synchronizes with the host: {e}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # launches and busy a cycle, and the cycle's wall time.  After the
    # long phases before it a short profile can drop device events: the
    # session is run again while it saw fewer of the port's kernels than
    # the wrappers count for the same work
    ours = port_kernel_names()

    def profile_all(fn):
        for w in kernels.values():
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        n_kern = sum(w.launches for w in kernels.values())
        return profile_counts(torch, fn, 1, lambda kk: sum(
            e.count for e in kk if kernel_name(e.key) in ours) < n_kern)

    n_prof = 4
    busy, kern, _ = profile_all(lambda: run_prediction(h, s, date, n_prof))
    launches = sum(e.count for e in kern) / n_prof
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_prediction(h, s, date, N_TIMED)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_TIMED * 1e3)
    walls.sort()
    log(f"persistent coupled cycle: {launches:g} device launches a cycle "
        f"(at most {LAUNCHES_MAX + 1}), device busy {busy / n_prof:.4f} "
        f"ms/cycle, cycle_ms {walls[2]:.4f} median (min {walls[0]:.4f}, "
        f"max {walls[-1]:.4f}) over 5 x {N_TIMED} cycles, idle share "
        f"{1 - busy / n_prof / walls[2]:.1%} [{card}]")
    if launches > LAUNCHES_MAX + 1:
        fail(f"{launches:g} launches a persistent cycle, more than "
             f"{LAUNCHES_MAX + 1}")

    # -- (c) the gate's select (C4) ----------------------------------------
    unsafe = torch.zeros((), dtype=torch.bool, device=dev)
    s_acc = dataclasses.replace(s, safe=unsafe, step=4 * (s.step // 4) + 1)
    s2, _ = h.cycle(s_acc, date.month - 1, date.tmonth, date.tyear)
    before = torch.stack(list(dataclasses.astuple(s_acc.fluxes)))
    after = torch.stack(list(dataclasses.astuple(s2.fluxes)))
    if bool(s2.safe) or not torch.equal(before, after) or not bool(
            torch.isfinite(after).all()) or s2.sfc is not s_acc.sfc:
        fail("a cycle with the gate tripped changed the sums or the "
             "surface")
    s_cpl = dataclasses.replace(s, safe=unsafe, step=4 * (s.step // 4) + 3)
    s3, _ = h.cycle(s_cpl, date.month - 1, date.tmonth, date.tyear)
    if not all(bool(torch.isfinite(getattr(s3.sfc, k)).all())
               for k in s3.sfc.__dataclass_fields__):
        fail("a coupling with the gate tripped gave a surface that is not "
             "finite")
    if float(torch.stack(list(dataclasses.astuple(
            s3.fluxes))).abs().max()) != 0.0:
        fail("a coupling with the gate tripped left non-zero sums")
    log("gate (C4): with safe false a persistent cycle keeps the sums bit "
        "for bit (finite) and the surface; a coupling with it gives a "
        "finite surface and zero sums")

    # -- (d) the day loop and the nature run's spin-up ----------------------
    sstan = np.random.default_rng(SEED + 22).normal(
        0.0, 1.0, (24, nlat, nlon)).astype(np.float32)
    gcm_d = GCM(g, dtype=f32, bd=gcm_l.bd, device=dev,
                cpl_flags=land_sea.CplFlags(icsea=2, isstan=1),
                sstan_monthly=sstan, sstan_year0=1990)
    d0 = ModelDate(1990, 6, 1)
    st, fo = gcm_d.init_state(d0)
    st = gcm_d.stepone(st, fo)
    torch.cuda.synchronize()
    k21.slab_couple.launches = 0
    t0 = time.perf_counter()
    st, d2 = gcm_d.run_days(st, d0, RUN_DAYS)
    torch.cuda.synchronize()
    sec_day = (time.perf_counter() - t0) / RUN_DAYS
    sf = st.sfc
    blend = sf.sst_om + sf.sice_am * (sf.tice_am - sf.sst_om)
    e_blend = max_abs_diff(torch, sf.sst_am, blend)
    atmo, _, _ = gcm_d.grid_state(st.spectral)
    if (k21.slab_couple.launches != RUN_DAYS or e_blend > 1e-4
            or not bool(torch.isfinite(atmo).all())
            or not (150.0 <= float(atmo[0].min())
                    and float(atmo[0].max()) <= 350.0)):
        fail(f"run_days: K21 {k21.slab_couple.launches} launches, sst_am "
             f"{e_blend:.3e} K off the ice blend of sst_om, or the state "
             f"not finite / T out of range")
    busy_d, kern_d, _ = profile_all(lambda: gcm_d.run_days(st, d2, 1))
    log(f"run_days (icsea 2, isstan 1, anomalies): {RUN_DAYS} days to "
        f"{d2.year}-{d2.month:02d}-{d2.day:02d}, {sec_day:.3f} s a day, "
        f"{sum(e.count for e in kern_d):g} device launches and "
        f"{busy_d:.3f} device ms a day; sst_am {e_blend:.3e} K off "
        f"sst_om's ice blend (tolerance 1e-4), T "
        f"{float(atmo[0].min()):.2f}..{float(atmo[0].max()):.2f} K "
        f"[{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    truth, _, dates = generate_nature_run(gcm_l, date0, 4)
    torch.cuda.synchronize()
    t_nature = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for v in truth.values()) or (
            dates[0].day != 6):
        fail("the nature run after its 5-day spin-up is not finite or "
             "starts on the wrong day")
    log(f"generate_nature_run, 5 days of spin-up (its default) and 4 "
        f"samples: {t_nature:.2f} s; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return n21


def atmosphere_checkpoint(torch, gcm, layout, date0, ck: str, card):
    """--ocean alone: phase 10's atmosphere (its nature run, forecasts and
    train_hybrid_production settings), trained and saved to `ck` by
    train_hybrid_production's atmo_ckpt, for phase 13 to load."""
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    train_hybrid_production)
    from speedy_ml_tpu_torch.hybrid.training import (generate_nature_run,
                                                     make_imperfect_forecasts)
    t0 = time.perf_counter()
    truth, _, dates = generate_nature_run(gcm, date0, N_NATURE,
                                          spinup_days=0)
    model = make_imperfect_forecasts(gcm, truth, dates)
    train_hybrid_production(
        gcm, layout, ArraySource(truth, model), ESNHyper(), TRAIN_SEED,
        hybrid=True, stride=1, time_chunk=TIME_CHUNK, n_discard=N_DISCARD,
        region_chunk=REGION_CHUNK, solve_dtype=torch.float64, atmo_ckpt=ck,
        device=torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"the atmosphere of phase 10 trained and saved for phase 13: "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def phase_ocean(torch, np, gcm, layout, date0, card, record, kernels,
                atmo_ckpt: str):
    """Phase 13: the slab ocean.  (a) K22 in its three forms against its
    plain version at the full-width shapes, float32 and float64, 0
    difference, with a negative control (the mean summed in slot order),
    each form timed beside its bound. (b) A nature run of OCEAN_STRIDES
    slab strides on phase 10's aquaplanet, then
    train_hybrid_production(ocean=True) loading phase 10's atmosphere from
    atmo_ckpt: OCEAN_HYPER, region chunks of OCEAN_REGION_CHUNK, the
    solve in float64; finite Wout, the solve's residual for 8 regions of
    each class, stage seconds, solve FLOP/s and peak memory; K1 and K2 at
    the ocean's shapes against their plain versions, timed. (c) The
    ocean hybrid with phase 10's standardizers and reservoirs and a
    seeded untrained readout (phase 10's, fit to 64 samples, diverges in
    a closed loop within its first cycles), and a land mask of smooth
    continents for the ML SST's land fill: start_prediction on the last
    OCEAN_SYNC samples with the imperfect model's 6-h forecast from the
    last one, then OCEAN_CYCLES persistent coupled cycles through
    run_prediction: the SST grid new on the slab step only (every point
    >= 272 K, land the floored fill) and bit for bit unchanged on the
    others, K1 and K2 three more launches and K22 one more on the slab
    step, the state finite and T in [150, 350] K; a slab step with host
    syncs forbidden; launches and device busy of a slab step and of
    another cycle, by kernel (checked where the profiler saw every
    launch). (d) save_hybrid and load_hybrid of that
    hybrid: every ocean tensor equal; two cycles from step 26 (the
    second a slab step) by the hybrid and its loaded twin, equal bit for
    bit.  Returns K22's launches in (c)."""

    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid, save_hybrid
    from speedy_ml_tpu_torch.esn.ocean import OCEAN_HYPER, ocean_index_map
    from speedy_ml_tpu_torch.esn.train import (NormalEq, accumulate_batches,
                                               discard_transient, solve_wout)
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    ocean_series_production,
                                                    train_hybrid_production)
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import (HybridAtmosphere,
                                                  ocean_snapshot)
    from speedy_ml_tpu_torch.hybrid.training import (fit_ocean_class,
                                                     generate_nature_run,
                                                     make_imperfect_forecasts)
    from speedy_ml_tpu_torch.kernels import slab_ocean as k22
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step, esn_step_plain
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update
    from speedy_ml_tpu_torch.kernels.readout import (readout, readout_plain,
                                                     vector_path)
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    g = gcm.geom
    nz, nlat, nlon = g.nlev, g.nlat, g.nlon
    G = nlat * nlon
    stride = HybridAtmosphere.SLAB_STRIDE
    W = stride - 1
    classes = layout.classes
    # the land of smooth continents (phase 12's), for the ML SST's fill
    land = continents_bd(torch, np, gcm.bd, g).fmask_l > 0.0

    # -- (a) K22 against its plain version at the full-width shapes --------
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    idx = [torch.as_tensor(ocean_index_map(c, nz).astype(np.int32),
                           device=dev) for c in classes]
    widths = [(4 * nz + 4) * c.input_shape[0] * c.input_shape[1]
              for c in classes]
    worst, main = {}, None
    for dt in (f32, f64):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=f64).to(dt)
        unif = lambda lo, hi, *shape: (lo + (hi - lo) * torch.rand(
            shape, generator=gen, device=dev, dtype=f64)).to(dt)
        fbs = [rnd(c.count, w) for c, w in zip(classes, widths)]
        rings = [rnd(W, c.count, len(i)) for c, i in zip(classes, idx)]
        outs = [rnd(c.count, c.core_shape[0] * c.core_shape[1])
                for c in classes]
        means = [unif(280.0, 290.0, c.count, 1) for c in classes]
        stds = [unif(2.0, 6.0, c.count, 1) for c in classes]
        outs[1][0, 0] = -1e3         # below the floor after unstandardizing
        table = k22.sst_table(layout, classes, unif(250.0, 300.0, nlat, nlon),
                              land, device=dev, dtype=dt)
        for form, step in (("push", OCEAN_STEP), ("push_mean", OCEAN_STEP),
                           ("push_mean", 0), ("push_mean", W - 1)):
            rk = [r.clone() for r in rings]
            rp = [r.clone() for r in rings]
            kw = dict(step=step, fbs=fbs, idx_maps=idx)
            a = k22.slab_ocean(form, bufs=rk, **kw)
            b = k22.slab_ocean_plain(form, bufs=rp, **kw)
            err = max(max_abs_diff(torch, x, y) for x, y in zip(rk, rp))
            if a is not None:
                err = max([err] + [max_abs_diff(torch, x, y)
                                   for x, y in zip(a, b)])
            worst[f"{form} step {step}, {str(dt)[6:]}"] = err
        kw = dict(outs=outs, mean_sst=means, std_sst=stds, table=table)
        a, b = k22.slab_ocean("sst", **kw), k22.slab_ocean_plain("sst", **kw)
        worst[f"sst, {str(dt)[6:]}"] = max_abs_diff(torch, a, b)
        if float(a.min()) < k22.SST_MIN or not torch.equal(
                a[land], torch.clamp_min(table.base[land], k22.SST_MIN)):
            fail("K22's SST grid is below 272 K or its land is not the fill")
        if dt == f32:
            main = (fbs, rings, kw)
    bad = {k: v for k, v in worst.items() if v > 0}
    # the negative control: at OCEAN_STEP the oldest slot is OCEAN_STEP + 1;
    # the mean summed from slot 0 must differ from the kernel's
    fbs, rings, sst_kw = main
    rk = [r.clone() for r in rings]
    means_k = k22.slab_ocean("push_mean", bufs=rk, step=OCEAN_STEP, fbs=fbs,
                             idx_maps=idx)
    wrong = []
    for r in rk:
        s_ = r[0].clone()
        for o in range(1, W):
            s_ = s_ + r[o]
        wrong.append(s_ * (1.0 / W))
    neg = max(max_abs_diff(torch, x, y) for x, y in zip(means_k, wrong))
    log(f"K22 slab_ocean against its plain version at the full-width "
        f"shapes ({len(worst)} cases: push, push_mean at steps "
        f"{OCEAN_STEP}, 0, {W - 1}, sst, float32 and float64): "
        f"max_abs_err {max(worst.values()):.3e} (tolerance 0); cases that "
        f"differ: {bad or 'none'}; negative control, the mean summed in "
        f"slot order: {neg:.3e} off (must differ)")
    if bad:
        fail("K22 disagrees with its plain version")
    if not neg > 0:
        fail("K22's negative control (the mean in slot order) passed")
    N = sum(r[0].numel() for r in rings)
    n_idx = sum(i.numel() for i in idx)
    R_all = sum(c.count for c in classes)
    O_all = sum(o.numel() for o in sst_kw["outs"])
    push = lambda: k22.slab_ocean("push", bufs=rings, step=OCEAN_STEP,
                                  fbs=fbs, idx_maps=idx)
    pmean = lambda: k22.slab_ocean("push_mean", bufs=rings, step=OCEAN_STEP,
                                   fbs=fbs, idx_maps=idx)
    sstf = lambda: k22.slab_ocean("sst", **sst_kw)
    (kp, kp_c), kp_runs = measure_median(torch, push)
    (km, km_c), km_runs = measure_median(torch, pmean)
    (ks, ks_c), ks_runs = measure_median(torch, sstf)
    b_push = bound_ms(4 * (2 * N + n_idx), 0, PEAK_F32_S)
    b_mean = bound_ms(4 * ((W + 2) * N + n_idx), W * N, PEAK_F32_S)
    b_sst = bound_ms(4 * (O_all + 2 * R_all + 3 * G) + G, 3 * G, PEAK_F32_S)
    pl_mean = measure(torch, lambda: k22.slab_ocean_plain(
        "push_mean", bufs=rings, step=OCEAN_STEP, fbs=fbs, idx_maps=idx),
        reps=10)
    pl_sst = measure(torch, lambda: k22.slab_ocean_plain("sst", **sst_kw),
                     reps=10)
    log(f"K22 forms, float32, median of {SHT_SESSIONS} sessions (device "
        f"ms): push {kp:.4f} (sessions "
        + ", ".join(f"{r:.4f}" for r in kp_runs) + f"; bound "
        f"{b_push[0]:.5f}, {b_push[0] / kp:.0%} of it); push_mean {km:.4f} "
        f"(sessions " + ", ".join(f"{r:.4f}" for r in km_runs)
        + f"; bound {b_mean[0]:.5f}, {b_mean[0] / km:.0%}; plain "
        f"{pl_mean[0]:.4f}); sst {ks:.4f} (sessions "
        + ", ".join(f"{r:.4f}" for r in ks_runs) + f"; bound "
        f"{b_sst[0]:.6f}, {b_sst[0] / ks:.0%}; plain {pl_sst[0]:.4f}); "
        f"{N} ocean inputs a slot, {W} slots [{card}]")
    record("K22_slab_ocean",
           "speedy_ml_tpu_torch/kernels/csrc/slab_ocean.cu",
           "speedy_ml_tpu/hybrid/model.py:678", max(worst.values()), 0.0,
           (kp, kp_c),
           measure(torch, lambda: k22.slab_ocean_plain(
               "push", bufs=rings, step=OCEAN_STEP, fbs=fbs, idx_maps=idx),
               reps=10),
           b_push)
    log("  (K22's ms, plain_ms and bound_ms in the kernels line are the "
        "push form's, the one every cycle launches)")
    del main, fbs, rings, sst_kw

    # -- (b) the nature run and the ocean's training at full width ---------
    parts = {"a": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    truth, _, dates = generate_nature_run(gcm, date0, OCEAN_STRIDES * stride,
                                          spinup_days=0)
    torch.cuda.synchronize()
    t_nature = time.perf_counter() - t0
    for key, v in truth.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"the ocean's nature run: {key} is not finite")
    src = ArraySource(truth)
    hyper = ESNHyper()
    timings = {}
    for fn in (esn_step, gram_update):
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = train_hybrid_production(
        gcm, layout, src, hyper, TRAIN_SEED, hybrid=True, ocean=True,
        atmo_ckpt=atmo_ckpt, ocean_region_chunk=OCEAN_REGION_CHUNK,
        stride=1, time_chunk=TIME_CHUNK, n_discard=N_DISCARD,
        region_chunk=REGION_CHUNK, solve_dtype=f64, timings=timings,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if gram_update.launches <= 0 or esn_step.launches <= 0:
        fail("the ocean's training launched no K14 or no K1")
    solve_flops = 0.0
    for op in h.ocean_packs:
        if not bool(torch.isfinite(op.res.wout).all()):
            fail(f"ocean class {op.cls.name}: Wout is not finite")
        R, O_, A = op.res.wout.shape
        solve_flops += R * (2.0 / 3.0 * A ** 3 + 2.0 * A * A * O_)
    # the solve's residual for the first 8 regions of each class, from the
    # same series and reservoirs, in float64
    worst_res = worst_w = 0.0
    n_disc = inspect.signature(fit_ocean_class).parameters[
        "n_discard"].default
    for cls, p, op in zip(classes, h.packs, h.ocean_packs):
        o_series, target, _ = ocean_series_production(
            layout, cls, p.std, src, nz, slab_stride=stride,
            time_chunk=max(TIME_CHUNK, 128), dtype=f32, device=dev)
        r8 = dataclasses.replace(
            op.res, vals=op.res.vals[:, :8].contiguous(),
            win_vals=op.res.win_vals[:8].contiguous(), wout=op.res.wout[:8])
        cut = lambda t: t[:, :8].contiguous()
        S_o = op.res.wout.shape[2] - op.res.n
        model_in = None
        if op.hybrid_readout:
            model_in = torch.cat([target[:1], target[:-1]])
        L = o_series.shape[0] - n_disc
        x0 = discard_transient(r8, op.hyper, cut(o_series[:n_disc]))
        eq, _ = accumulate_batches(
            r8, op.hyper, cut(o_series[n_disc:]), cut(target[n_disc:]),
            None if model_in is None else cut(model_in[n_disc:]), x0,
            max(1, L - 1))
        eq64 = NormalEq(eq.ss.double(), eq.st.double())
        w64 = solve_wout(eq64, op.hyper, S_o)
        bm, br = ((op.hyper.beta_model ** 2, op.hyper.beta_res ** 2)
                  if op.hyper.using_prior else
                  (op.hyper.beta_model, op.hyper.beta_res))
        ridge = torch.full((eq.ss.shape[1],), br, dtype=f64, device=dev)
        ridge[:S_o] = bm
        lhs = torch.linalg.matmul(eq64.ss, w64.transpose(1, 2)) \
            + ridge[None, :, None] * w64.transpose(1, 2)
        rhs = eq64.st.transpose(1, 2)
        rel = (torch.linalg.matrix_norm(lhs - rhs)
               / torch.linalg.matrix_norm(rhs))
        worst_res = max(worst_res, float(rel.max()))
        w_run = op.res.wout[:8].double()
        worst_w = max(worst_w, float((w64.float().double() - w_run).abs()
                                     .max() / w_run.abs().max()))
    log(f"ocean training: a nature run of {OCEAN_STRIDES * stride} samples "
        f"at 6 h on the aquaplanet (no spin-up) in "
        f"{t_nature:.2f} s; train_hybrid_production(ocean=True) loading "
        f"phase 10's atmosphere: {wall:.1f} s; OCEAN_HYPER m="
        f"{OCEAN_HYPER.m}, n " + ", ".join(
            f"{op.cls.name} {op.res.n} (A {op.res.wout.shape[2]})"
            for op in h.ocean_packs)
        + f"; region chunks of {OCEAN_REGION_CHUNK}, solve in float64; "
        f"stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                    timings.items())
        + f"; solve {solve_flops / 1e12:.2f} TFLOP at "
        f"{solve_flops / timings['ocean_solve'] / 1e12:.2f} TFLOP/s; peak "
        f"memory allocated {peak:.2f} GiB; K14 {gram_update.launches} and "
        f"K1 {esn_step.launches} launches; residual <= {worst_res:.3e} "
        f"over 8 regions of each class (tolerance {RESIDUAL_MAX:.0e}), "
        f"their Wout from the retained chunk vs the run's {worst_w:.3e} "
        f"of its scale [{card}]")
    if not worst_res <= RESIDUAL_MAX:
        fail("the ocean's ridge solve's residual is too large")

    # K1 and K2 at the ocean's shapes against their plain versions
    xs = [torch.tanh(torch.randn((op.cls.count, op.res.n), generator=gen,
                                 device=dev)) for op in h.ocean_packs]
    us = [torch.randn((op.cls.count, op.res.n_in), generator=gen,
                      device=dev) for op in h.ocean_packs]
    step_args = [dict(vals=op.res.vals, x=x, u=u, win_vals=op.res.win_vals,
                      shifts=op.res.shifts, leakage=op.hyper.leakage)
                 for op, x, u in zip(h.ocean_packs, xs, us)]
    e1 = max(max_abs_diff(torch, esn_step(**a), esn_step_plain(**a))
             for a in step_args)
    k1 = measure_median(torch, lambda: [esn_step(**a) for a in step_args])
    p1 = measure(torch, lambda: [esn_step_plain(**a) for a in step_args])
    nb1 = op1 = 0
    for a in step_args:
        J, R, n = a["vals"].shape
        nb1 += 4 * (J * R * n + 3 * R * n + a["u"].numel())
        op1 += R * n * (2 * J + 4)
    b1 = bound_ms(nb1, op1, PEAK_F32_S)
    e2, lines2 = 0.0, []
    for S in (0, 4):
        wr = [torch.randn((op.cls.count, 4, S + op.res.n), generator=gen,
                          device=dev) / op.res.n ** 0.5
              for op in h.ocean_packs]
        lm = [None if S == 0 else torch.randn((op.cls.count, S),
                                              generator=gen, device=dev)
              for op in h.ocean_packs]
        if not all(vector_path(w) for w in wr):
            fail(f"K2 at the ocean's shapes (S={S}) is off its vector path")
        for w, x, l in zip(wr, xs, lm):
            ref = readout_plain(w, x, l)
            e2 = max(e2, max_abs_diff(torch, readout(w, x, l), ref)
                     / max_abs(torch, ref))
        k2 = measure_median(torch, lambda: [readout(w, x, l) for w, x, l in
                                            zip(wr, xs, lm)])
        p2 = measure(torch, lambda: [readout_plain(w, x, l) for w, x, l in
                                     zip(wr, xs, lm)])
        nb2 = sum(4 * (w.numel() + x.numel() + w.shape[0] * 4
                       + (0 if l is None else l.numel()))
                  for w, x, l in zip(wr, xs, lm))
        b2 = bound_ms(nb2, sum(2 * w.numel() for w in wr), PEAK_F32_S)
        lines2.append(f"S={S}: {k2[0][0]:.4f} ms (sessions "
                      + ", ".join(f"{r:.4f}" for r in k2[1])
                      + f"; bound {b2[0]:.4f}, {b2[0] / k2[0][0]:.0%} of "
                      f"it; plain {p2[0]:.4f})")
    log(f"K1 at the ocean's shapes (3 classes, J = {step_args[0]['vals'].shape[0]}"
        f", n = " + ", ".join(str(op.res.n) for op in h.ocean_packs)
        + f"): max_abs_err {e1:.3e} (tolerance 1e-5), {k1[0][0]:.4f} ms "
        f"(sessions " + ", ".join(f"{r:.4f}" for r in k1[1])
        + f"; bound {b1[0]:.4f}, {b1[0] / k1[0][0]:.0%} of it; plain "
        f"{p1[0]:.4f}); K2 bare, float32 Wout (R, 4, S + n), vector path: "
        f"max err {e2:.3e} of the scale (tolerance {K2_RTOL:.0e}), "
        + "; ".join(lines2) + f" [{card}]")
    if e1 > 1e-5 or e2 > K2_RTOL:
        fail("K1 or K2 at the ocean's shapes disagrees with its plain "
             "version")
    del xs, us, step_args

    # -- (c) start_prediction, then the persistent coupled cycles ---------
    parts["b"] = time.perf_counter() - t_phase - sum(parts.values())
    # phase 10's readout, fit to 64 samples at a ridge of 1e-6, diverges in
    # a closed loop within its first cycles (T beyond 1e5 K by the second),
    # so the cycles run its standardizers and reservoirs with a seeded
    # untrained readout (build_untrained_hybrid's 1e-3 normal), as the main
    # path runs untrained weights; the ocean is the trained one
    gw = torch.Generator(device=dev).manual_seed(SEED + 23)
    packs = [p._replace(res=dataclasses.replace(p.res, wout=1e-3 * torch.randn(
        p.res.wout.shape, generator=gw, device=dev))) for p in h.packs]
    h = HybridAtmosphere(gcm, layout, packs, ml_only=False,
                         ocean_packs=h.ocean_packs, base_sst=h.base_sst,
                         sea_mask=land, device=dev)
    del packs
    sync = {k: v[-OCEAN_SYNC:] for k, v in truth.items()}
    last = {k: torch.cat([truth[k][-1:]] * 2) for k in ("atmo", "logp",
                                                         "sst")}
    fc = make_imperfect_forecasts(gcm, last, [dates[-1]] * 2)
    model_next = {k: fc[k][1] for k in ("atmo", "logp")}
    h.persist_surface = True
    s = h.start_prediction(sync, model_next, truth["sst"][-1])
    if not (s.step == 0 and len(s.ocean) == len(classes)):
        fail("start_prediction did not arm the ocean")
    date = dates[-1].advance_hours(6)
    base_floor = torch.clamp_min(h.base_sst, k22.SST_MIN)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    walls, stepped = [], []
    for i in range(OCEAN_CYCLES):
        before = {nm: kernels[nm].launches for nm in
                  ("K1_esn_step", "K2_readout_scatter", "K22_slab_ocean")}
        prev, slab = s.sst_grid, s.step % stride == stride - 1
        t0 = time.perf_counter()
        s, dts = run_prediction(h, s, date, 1, stop_if_unsafe=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {nm: kernels[nm].launches - c for nm, c in before.items()}
        want = {"K1_esn_step": 6 if slab else 3,
                "K2_readout_scatter": 6 if slab else 3,
                "K22_slab_ocean": 2 if slab else 1}
        if got != want:
            fail(f"ocean cycle {i + 1} (step {s.step - 1}): launches {got}, "
                 f"expected {want}")
        if slab:
            stepped.append(i + 1)
            if torch.equal(s.sst_grid, prev):
                fail(f"the slab step (cycle {i + 1}) left the SST grid")
            if float(s.sst_grid.min()) < k22.SST_MIN or not torch.equal(
                    s.sst_grid[land], base_floor[land]):
                fail("after the slab step the SST grid is below 272 K or "
                     "its land is not the fill")
            sst_moved = float((s.sst_grid - prev).abs().max())
        elif s.sst_grid is not prev or not torch.equal(s.sst_grid, prev):
            fail(f"cycle {i + 1}, no slab step, changed the SST grid")
        tensors = [s.sst_grid] + [t for c in s.classes for t in
                                  (c.x, c.feedback, c.local_model)] + [
            t for o in s.ocean for t in (o.x, o.buffer)]
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            fail(f"ocean cycle {i + 1}: the state is not finite")
        date = date.advance_hours(6)
    if stepped != [stride]:
        fail(f"slab steps at cycles {stepped}, expected [{stride}]")
    n22 = kernels["K22_slab_ocean"].launches
    _, d = h.cycle(ocean_snapshot(s), date.month - 1, date.tmonth,
                   date.tyear)
    t_min, t_max = float(d["speedy_atmo"][0].min()), float(
        d["speedy_atmo"][0].max())
    if not all(bool(torch.isfinite(d[k]).all()) for k in (
            "atmo", "logp", "speedy_atmo", "speedy_logp")) or not (
            150.0 <= t_min and t_max <= 350.0):
        fail(f"after the ocean cycles the fields are not finite or T is "
             f"outside [150, 350] K ({t_min}..{t_max})")
    log(f"ocean cycles (phase 10's standardizers and reservoirs, a seeded "
        f"untrained readout, the trained ocean, {int(land.sum())} land "
        f"points): start_prediction on the last {OCEAN_SYNC} samples "
        f"with the 6-h forecast from the last, then {OCEAN_CYCLES} "
        f"persistent coupled cycles of run_prediction: the SST grid new "
        f"on cycle {stride} only (up to {sst_moved:.3f} K off the "
        f"start), >= 272 K, land the floored fill, bit for bit unchanged "
        f"on the other {OCEAN_CYCLES - 1}; K1 and K2 6 launches on the "
        f"slab step and 3 on the others, K22 {n22} ({OCEAN_CYCLES} cycles, "
        f"two on the slab step); safe {bool(s.safe)}; state finite, SPEEDY "
        f"T {t_min:.2f}..{t_max:.2f} K; wall per cycle "
        f"{statistics.median(walls):.3f} s median [{card}]")
    # a slab step with host syncs forbidden
    at = lambda st, k: dataclasses.replace(ocean_snapshot(st), step=k)
    slab_state = at(s, stride * (s.step // stride + 1) + stride - 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h.cycle(slab_state, date.month - 1, date.tmonth, date.tyear)
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"a slab-step cycle synchronizes with the host: {e}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # launches and busy of a slab step and of another cycle.  A session
    # can lose its first device events (three when phase 13 runs alone, ~14
    # after phases 10-12): OCEAN_PAD launches of K17b, which no cycle
    # launches, go first and are left out of the counts.  A session that
    # still sees fewer of the port's kernels than the wrappers count is
    # profiled again (profile_counts); if all its tries come up short, the
    # pair is not checked.  The two cycles are profiled in turn,
    # OCEAN_PROFILE_PAIRS times: one pair's busy can be off by more than
    # the tolerance when the card's clock moves between its two sessions
    # (a slab step 0.0244 ms below the other cycle once), so the busy is
    # checked on the median pair.  If no pair is whole, the launches stand
    # on the wrappers' counters (checked above) and the profile is only
    # logged
    ours = port_kernel_names()
    pad = lambda: [tisr_plane(date.tyear, h._slat, h._clat, nlon)
                   for _ in range(OCEAN_PAD)]
    is_pad = lambda e: kernel_name(e.key) == "tisr_kernel"
    seen = lambda kk: sum(e.count for e in kk if kernel_name(e.key) in ours
                          and not is_pad(e))
    cycles = {}
    for label, k in (("slab step", slab_state.step),
                     ("no slab step", slab_state.step + 2)):
        st_k = at(s, k)
        fn = lambda st_k=st_k: h.cycle(st_k, date.month - 1, date.tmonth,
                                       date.tyear)
        fn()
        for w in kernels.values():
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        cycles[label] = (fn, sum(w.launches for w in kernels.values()))

    def profile_cycle(label):
        fn, n_kern = cycles[label]
        ms, kk, _ = profile_counts(torch, lambda: (pad(), fn()), 1,
                                   lambda kk: seen(kk) < n_kern)
        complete = seen(kk) >= n_kern
        kk = [e for e in kk if not is_pad(e)]
        oc = {kernel_name(e.key): (e.count, _self_device_us(e) / 1e3)
              for e in kk}
        return (sum(_self_device_us(e) for e in kk) / 1e3,
                sum(e.count for e in kk), oc, complete)

    want = {"esn_step_kernel": 3, "readout_kernel": 3,
            "slab_push_kernel": 0, "slab_sst_kernel": 1}
    pairs = []
    for _ in range(OCEAN_PROFILE_PAIRS):
        (ms_s, n_s, oc_s, ok_s), (ms_n, n_n, oc_n, ok_n) = (
            profile_cycle("slab step"), profile_cycle("no slab step"))
        extra = {nm: (oc_s.get(nm, (0, 0))[0] - oc_n.get(nm, (0, 0))[0],
                      oc_s.get(nm, (0, 0))[1] - oc_n.get(nm, (0, 0))[1])
                 for nm in want}
        ocean_ms = sum(v[1] for v in extra.values())
        whole = ok_s and ok_n
        if whole and ({k: v[0] for k, v in extra.items()} != want
                      or n_s - n_n != 7):
            fail(f"the slab step's extra launches by kernel "
                 f"{ {k: v[0] for k, v in extra.items()} } ({n_s - n_n:g} "
                 f"in all), expected {want} (the ocean's K1, K2 and K22's "
                 f"SST form)")
        pairs.append(((ms_s - ms_n) - ocean_ms, whole, ms_s, n_s, ms_n,
                      n_n, extra, ocean_ms))
    checked = sorted((p for p in pairs if p[1]), key=lambda p: p[0])
    off, whole, ms_s, n_s, ms_n, n_n, extra, ocean_ms = (
        checked[len(checked) // 2] if checked else pairs[-1])
    log(f"ocean cycle profile ({len(checked)} of {OCEAN_PROFILE_PAIRS} "
        f"alternating pairs whole; the median pair): a slab step {n_s:g} "
        f"device launches, {ms_s:.4f} ms busy; another cycle {n_n:g} "
        f"launches, {ms_n:.4f} ms busy; the slab step's extra: "
        f"{n_s - n_n:g} launches, {ms_s - ms_n:.4f} ms, of which the "
        f"ocean's kernels {ocean_ms:.4f} ms; by kernel (launches, ms) "
        + ", ".join(f"{k} {v[0]:g}, {v[1]:.4f}" for k, v in extra.items())
        + "; each pair's extra busy less the ocean kernels' (ms) "
        + ", ".join(f"{p[0]:.4f}" + ("" if p[1] else " (lost events)")
                    for p in pairs)
        + ("" if checked else "; the profiler lost device events in "
           "every session, so these are not checked (the wrappers' counts "
           "above are)") + f" [{card}]")
    # its busy is the other cycle's and the ocean kernels', to within
    # the run-to-run spread of the other kernels (~0.01 ms a cycle)
    if checked and abs(off) > OCEAN_BUSY_TOL_MS:
        fail(f"the slab step's extra busy {ms_s - ms_n:.4f} ms is not "
             f"the ocean kernels' {ocean_ms:.4f} ms (within "
             f"{OCEAN_BUSY_TOL_MS} ms) in the median of {len(checked)} "
             f"pairs")

    # -- (d) the ocean hybrid's checkpoint ---------------------------------
    parts["c"] = time.perf_counter() - t_phase - sum(parts.values())
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ocean")
        _, t_save = timed(lambda: save_hybrid(h, path))
        nbytes = dir_bytes(path)
        twin, t_load = timed(lambda: load_hybrid(gcm, layout, path,
                                                 device=dev))
    for a, b in zip(h.ocean_packs, twin.ocean_packs):
        for k in ("cols", "vals", "win_vals", "wout", "mean", "std"):
            if not torch.equal(getattr(a.res, k), getattr(b.res, k)):
                fail(f"the loaded ocean pack {a.cls.name}: res.{k} differs")
        if not (torch.equal(a.mean_sst, b.mean_sst)
                and torch.equal(a.std_sst, b.std_sst)
                and np.array_equal(a.idx_map, b.idx_map)
                and (a.hyper, a.hybrid_readout, a.res.shifts)
                == (b.hyper, b.hybrid_readout, b.res.shifts)):
            fail(f"the loaded ocean pack {a.cls.name} differs")
    if not (torch.equal(h.base_sst, twin.base_sst)
            and torch.equal(h.sea_mask, twin.sea_mask)):
        fail("the loaded base_sst or sea_mask differs")
    same_packs(torch, twin.packs, h.packs, "the ocean hybrid's checkpoint")
    twin.persist_surface = True
    st0 = dataclasses.replace(s, step=stride - 2)
    a_, _ = run_prediction(h, ocean_snapshot(st0), date, 2,
                           stop_if_unsafe=False)
    b_, _ = run_prediction(twin, ocean_snapshot(st0), date, 2,
                           stop_if_unsafe=False)
    if not (same_states(torch, a_, b_) and torch.equal(a_.sst_grid,
                                                       b_.sst_grid)
            and not torch.equal(a_.sst_grid, st0.sst_grid)
            and all(torch.equal(p.x, q.x) and torch.equal(p.buffer, q.buffer)
                    for p, q in zip(a_.ocean, b_.ocean))):
        fail("two cycles (the second a slab step) of the loaded ocean "
             "hybrid differ from the hybrid's")
    log(f"ocean checkpoint: save_hybrid {t_save:.2f} s, {nbytes / 1e9:.3f} "
        f"GB on disk, load_hybrid {t_load:.2f} s; every ocean tensor equal; "
        f"two cycles from step {st0.step} (the second a slab step) by the "
        f"hybrid and its loaded twin equal bit for bit; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items())
        + f", (d) {time.perf_counter() - t_phase - sum(parts.values()):.1f}"
        f") [{card}]")
    return n22


def option_tables(torch, np, geom, dev):
    """Phase 14's synthetic climatology tables on the card: a 365-day SST
    table, the aquaplanet's month-0 SST with a seeded seasonal term and
    noise (some points below 273 K, the rest take the bias), and a
    6-hourly TISR table of OPT_TISR_ROWS rows, a seasonal cosine of
    latitude."""
    rng = np.random.default_rng(SEED + 14)
    lat = np.asarray(geom.lat_radians)
    day = np.arange(365)[:, None, None]
    sst = (sst_month0(geom)[None] + 3.0 * np.sin(2 * np.pi * day / 365.0)
           * np.sin(lat)[None, :, None]
           + rng.normal(0.0, 0.4, (365, geom.nlat, geom.nlon)))
    hpe = 8760 // OPT_TISR_ROWS
    k = np.arange(OPT_TISR_ROWS)[:, None, None]
    decl = 0.41 * np.sin(2 * np.pi * k * hpe / 8760.0)
    tisr = (1361.0 / np.pi * np.clip(np.cos(lat[None, :, None] - decl), 0,
                                     None) * np.ones((1, 1, geom.nlon)))
    f32 = torch.float32
    return (torch.as_tensor(sst, dtype=f32, device=dev),
            torch.as_tensor(tisr, dtype=f32, device=dev), hpe)


def phase_options(torch, np, hyb, date0, card, record, kernels, work: Path,
                  out_dir: Path):
    """Phase 14: the forecast's options.  (a) K23 sst_by_date against its
    plain version (float32 and float64, days at both ends of the table,
    biases of both signs), 0 difference, timed beside its bound. (b) K2's
    components form on the main path's inputs (a coupled state two cycles
    in): out, v_p and v_ml against readout_components_plain within
    K2_RTOL of each one's scale, a negative control (the plain readout,
    its vector rounded to bf16) that must differ; its store into three
    grids bit for bit its own vectors then the core scatter (the main
    grid with the clamps, v_p and v_ml without); timed beside the main
    form. (c) OPT_CYCLES coupled cycles of run_prediction from 1990-01-31
    12:00 with both tables, emit_components, a writer, a seeded
    truth_provider, a bias ramp and time_mean_path: the npz keys and
    shapes, two months in the time-mean file, fields finite, T in [150,
    350] K, the state's SST the plain version's table day bit for bit,
    K23 once a cycle; launches a cycle with the options, profiled beside
    the main path in the same session order (one more: K23); device busy
    and ms a cycle with and without the writer and the time mean.  The
    options are off again at the end.  Returns (K23's launches, K2's
    launches) in (c)."""
    from speedy_ml_tpu_torch.data.calendar import ModelDate, hour_of_year_365
    from speedy_ml_tpu_torch.esn.reservoir import esn_step
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.kernels import sst_by_date as k23
    from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                          core_scatter_plain,
                                                          grid_blocks)
    from speedy_ml_tpu_torch.kernels.readout import (
        readout, readout_components_plain, readout_plain)
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    g = hyb.geom
    nz, nlat, nlon = g.nlev, g.nlat, g.nlon
    G = nlat * nlon
    sst_t, tisr_t, hpe = option_tables(torch, np, g, dev)

    # -- (a) K23 against its plain version -------------------------------
    worst = {}
    for dt in (f32, f64):
        tab = sst_t.to(dt)
        for day, bias in ((0, 0.37), (364, -2.5), (180, 0.0), (31, 1.0)):
            worst[f"day {day} bias {bias} {str(dt)[6:]}"] = max_abs_diff(
                torch, k23.sst_by_date(tab, day, bias),
                k23.sst_by_date_plain(tab, day, bias))
    bad = {k: v for k, v in worst.items() if v > 0}
    taken = int((sst_t[31] > k23.T_OPEN).sum())
    log(f"K23 sst_by_date against its plain version ({len(worst)} cases: "
        f"float32 and float64, days 0, 364, 180, 31, biases of both "
        f"signs): max_abs_err {max(worst.values()):.3e} (tolerance 0); "
        f"cases that differ: {bad or 'none'}; {taken} of {G} points take "
        f"the bias on day 31")
    if bad:
        fail("K23 disagrees with its plain version")
    if not 0 < taken < G:
        fail("phase 14's SST table does not straddle 273 K")
    day, bias = 31, 1.0
    k23_fn = lambda: k23.sst_by_date(sst_t, day, bias)
    (kd, kc), runs = measure_median(torch, k23_fn)
    b23 = bound_ms(2 * 4 * G, 2 * G, PEAK_F32_S)
    log(f"K23 float32, median of {SHT_SESSIONS} sessions: {kd:.4f} ms "
        f"(sessions " + ", ".join(f"{r:.4f}" for r in runs) + f"; bound "
        f"{b23[0]:.6f}, {b23[0] / kd:.1%} of it) [{card}]")
    record("K23_sst_by_date",
           "speedy_ml_tpu_torch/kernels/csrc/sst_by_date.cu",
           "speedy_ml_tpu/hybrid/model.py:546", max(worst.values()), 0.0,
           (kd, kc), measure(torch, lambda: k23.sst_by_date_plain(
               sst_t, day, bias), reps=10), b23)

    # -- (b) K2's components form on the main path's inputs -----------------
    s = hyb.init_state(sst_month0(g))
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    for _ in range(2):
        s, _ = hyb.cycle(s, imon, fmon, tyear)
    packs = hyb.packs
    xs = [esn_step(p.res, cs.x, cs.feedback, p.hyper.leakage)
          for p, cs in zip(packs, s.classes)]
    args = [dict(wout=p.res.wout, x=x, local_model=cs.local_model,
                 out_mean=p.std.out_mean, out_std=p.std.out_std)
            for p, x, cs in zip(packs, xs, s.classes)]
    err = {"out": 0.0, "v_p": 0.0, "v_ml": 0.0}
    ctl = 0.0
    for a in args:
        bare = {k: a[k] for k in ("wout", "x", "local_model")}
        R, O, _ = a["wout"].shape
        parts = [torch.empty((R, O), device=dev) for _ in range(2)]
        k_out = readout(**bare, parts=parts)
        ref = readout_components_plain(**bare)
        for nm, kv, pv in zip(err, (k_out, *parts), ref):
            err[nm] = max(err[nm], float((kv - pv).abs().max())
                          / float(pv.abs().max()))
        ctl = max(ctl, float((readout_plain(**bare) - ref[0]).abs().max())
                  / float(ref[0].abs().max()))
    n_grid, q_blk, p_blk = grid_blocks(4, nz, nlat, nlon)
    core_table = torch.as_tensor(hyb.layout.core_source_table(
        [p.cls for p in packs], 4, nz), device=dev).long()

    def store(grids, comp=True):
        for a, idx in zip(args, hyb.core_index):
            readout(**a, scatter=CoreScatter(grids[0], idx, q_blk, p_blk),
                    parts=grids[1:] if comp else None)
        return grids

    grids = store([torch.full((n_grid,), float("nan"), device=dev)
                   for _ in range(3)])
    vecs = []
    for a in args:
        R, O, _ = a["wout"].shape
        parts = [torch.empty((R, O), device=dev) for _ in range(2)]
        vecs.append((readout(**a, parts=parts), *parts))
    main = torch.cat([t.reshape(-1) for t in core_scatter_plain(
        [v[0] for v in vecs], core_table, 4, nz, nlat, nlon)])
    same = [torch.equal(grids[0], main)] + [
        torch.equal(grids[j], torch.cat([v[j].reshape(-1)
                                         for v in vecs])[core_table])
        for j in (1, 2)]
    log(f"K2 components form (bare, three classes, the main path's inputs "
        f"two cycles in): against readout_components_plain "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f" of each one's scale (tolerance {K2_RTOL:.0e}); negative "
        f"control, the vector rounded to bf16 (the main form's plain "
        f"version): {ctl:.3e} off (must exceed it); into three grids "
        f"(starting as NaN) bit for bit its vectors then the core scatter: "
        f"{same}")
    if max(err.values()) > K2_RTOL:
        fail("K2's components form disagrees with readout_components_plain")
    if not ctl > K2_RTOL:
        fail("K2's components tolerance does not tell the vector rounded "
             "to bf16 from the right one")
    if any(bool(t.isnan().any()) for t in grids) or not all(same):
        fail("K2's components form did not store the three grids as its "
             "vectors")
    bufs = [torch.empty(n_grid, device=dev) for _ in range(3)]
    (kcomp, kcomp_c), runs_c = measure_median(torch, lambda: store(bufs))
    (kmain, _), runs_m = measure_median(torch, lambda: store(bufs, False))
    nbytes = ops = 0
    for a in args:
        R, O, A = a["wout"].shape
        nbytes += (a["wout"].numel() * a["wout"].element_size()
                   + 4 * (a["x"].numel() + a["local_model"].numel()
                          + 4 * R * O + 2 * R * O))
        ops += 2 * R * O * A
    b2c = bound_ms(nbytes, ops, PEAK_F32_S)
    plain = measure(torch, lambda: [
        readout_components_plain(**a) for a in args], reps=3)
    log(f"K2 into the grid, three launches, median of {SHT_SESSIONS} "
        f"sessions: components form {kcomp:.4f} ms (sessions "
        + ", ".join(f"{r:.4f}" for r in runs_c) + f"), main form "
        f"{kmain:.4f} ms (sessions " + ", ".join(f"{r:.4f}" for r in runs_m)
        + f"); components bound {b2c[0]:.4f} ms ({b2c[0] / kcomp:.0%} of "
        f"it); plain {plain[0]:.4f} ms [{card}]")
    record("K2_readout_components",
           "speedy_ml_tpu_torch/kernels/csrc/readout.cu",
           "speedy_ml_tpu/hybrid/model.py:354", max(err.values()), K2_RTOL,
           (kcomp, kcomp_c), plain, b2c)
    del args, xs, vecs, grids, bufs, main

    # -- (c) the forecast with the options through run_prediction ----------
    h = hyb
    h.set_sst_table(sst_t)
    h.set_tisr_table(tisr_t, hpe)
    h.emit_components = True
    start = ModelDate(1990, 1, 31, 12)
    st0 = h.init_state(sst_month0(g))
    rng = np.random.default_rng(SEED + 140)
    truth = [dict(atmo=rng.normal(250.0, 10.0, (4, nz, nlat, nlon)),
                  sst=rng.normal(290.0, 3.0, (nlat, nlon)))
             for _ in range(OPT_CYCLES)]
    path = out_dir / "prediction_options.npz"
    tm_path = work / "time_means.npz"
    path.unlink(missing_ok=True)
    kw = dict(sst_bias_per_year=OPT_BIAS_PER_YEAR)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    fin, dts = run_prediction(h, st0, start, OPT_CYCLES,
                              output_path=str(path),
                              truth_provider=lambda i: truth[i],
                              time_mean_path=str(tm_path), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n23 = kernels["K23_sst_by_date"].launches
    n2 = kernels["K2_readout_scatter"].launches
    if len(dts) != OPT_CYCLES or n23 != OPT_CYCLES or n2 != 3 * OPT_CYCLES:
        fail(f"the options' run: {len(dts)} cycles, K23 {n23} launches, K2 "
             f"{n2} (expected {OPT_CYCLES}, {OPT_CYCLES}, "
             f"{3 * OPT_CYCLES})")
    if tisr_plane.launches:
        fail("the options' run launched K17b")
    z = np.load(path)
    comp = [f"{p}_{f}" for p in ("vp", "vml") for f in ("atmo", "logp",
                                                        "precip")]
    want = {"atmo": (4, nz, nlat, nlon), "truth_atmo": (4, nz, nlat, nlon),
            **{k: (nlat, nlon) for k in ("logp", "precip", "sst",
                                         "truth_sst")},
            **{k: ((4, nz, nlat, nlon) if k.endswith("atmo")
                   else (nlat, nlon)) for k in comp}}
    got = {k: z[k].shape[1:] for k in z.files}
    if got != want or any(z[k].shape[0] != OPT_CYCLES for k in z.files):
        fail(f"the options' stream {dict((k, z[k].shape) for k in z.files)}"
             f", expected {want} with {OPT_CYCLES} records")
    if not all(np.isfinite(z[k]).all() for k in z.files):
        fail("a field of the options' stream is not finite")
    tf = z["atmo"][:, 0]
    if not (150.0 <= tf.min() and tf.max() <= 350.0):
        fail(f"T outside [150, 350] K: {tf.min()}..{tf.max()}")
    if not np.array_equal(z["truth_sst"], np.stack(
            [t["sst"] for t in truth]).astype(np.float32)):
        fail("the truth stream is not the provider's")
    tm = np.load(tm_path)
    if list(tm["month"]) != [1, 2] or list(tm["n_samples"]) != [
            2, OPT_CYCLES - 2] or not all(
            np.isfinite(tm[k]).all() for k in tm.files):
        fail(f"the time-mean file: months {list(tm['month'])}, samples "
             f"{list(tm['n_samples'])}, expected [1, 2] and "
             f"[2, {OPT_CYCLES - 2}], finite")
    last = dts[-1]
    b_last = OPT_BIAS_PER_YEAR * ((OPT_CYCLES - 1) * 6) / 8760.0
    want_sst = k23.sst_by_date_plain(
        sst_t, k23.table_day(hour_of_year_365(last), 365), b_last)
    if not torch.equal(fin.sst_grid, want_sst):
        fail("the state's SST is not the plain version's table day")
    vp_max = float(np.abs(z["vp_atmo"][-1]).max())
    if not vp_max > 0:
        fail("v_p is zero on the last cycle of the options' run")
    log(f"options' forecast: run_prediction {OPT_CYCLES} coupled cycles "
        f"from {start.year}-{start.month:02d}-{start.day:02d} "
        f"{start.hour:02d}:00 with an SST table (365 days, the bias ramp "
        f"{OPT_BIAS_PER_YEAR} K/year), a TISR table ({OPT_TISR_ROWS} rows, "
        f"{hpe} h apart), emit_components, a writer, a truth provider and "
        f"time means in {wall:.3f} s: K23 {n23} launches, K2 {n2} "
        f"(components form), no K17b; stream keys {sorted(z.files)}, "
        f"finite, T {tf.min():.3f}..{tf.max():.3f} K, v_p up to "
        f"{vp_max:.3e}; time means of months "
        f"{[int(v) for v in tm['month']]} "
        f"({[int(v) for v in tm['n_samples']]} cycles); the state's SST "
        f"the plain table day bit for bit")
    # launches a cycle, the main path beside the options, each after
    # OPT_PAD launches of K17b that absorb the events a late session
    # loses first; timed with and without the writer and the time means
    ours = port_kernel_names()
    pad = lambda: [tisr_plane(tyear, h._slat, h._clat, nlon)
                   for _ in range(OPT_PAD)]
    is_pad = lambda e: kernel_name(e.key) == "tisr_kernel"
    n_prof = 5
    prof = {}
    for label, on in (("main path", False), ("options", True)):
        h.emit_components = on
        if not on:
            h.sst_table = h.tisr_table = None
        else:
            h.set_sst_table(sst_t)
            h.set_tisr_table(tisr_t, hpe)
        fn = lambda: run_prediction(h, fin, start, n_prof, **kw)
        fn()
        for w in kernels.values():
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        n_kern = sum(w.launches for w in kernels.values())
        seen = lambda kk: sum(e.count for e in kk
                              if kernel_name(e.key) in ours
                              and not is_pad(e))
        ms, kk, _ = profile_counts(torch, lambda: (pad(), fn()), 1,
                                   lambda kk: seen(kk) < n_kern)
        kk = [e for e in kk if not is_pad(e)]
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n_prof * 1e3)
        prof[label] = (sum(e.count for e in kk) / n_prof, ms / n_prof,
                       statistics.median(walls), seen(kk) >= n_kern)
    (n_main, busy_main, ms_main, ok_m), (n_opt, busy_opt, ms_opt, ok_o) = (
        prof["main path"], prof["options"])
    h.set_sst_table(sst_t)
    h.set_tisr_table(tisr_t, hpe)
    h.emit_components = True
    # the host's share: the time means alone (one device-to-host copy of
    # the four fields a cycle, the sigma->p interpolation, the file at the
    # end), then the writer with the truth streams (ten fields and two
    # truth fields to the host a cycle, the compressed file at the end)
    io = {"time means": dict(time_mean_path=str(work / "timed_tm.npz")),
          "writer and truth streams": dict(
              output_path=str(work / "timed"),
              truth_provider=lambda i: truth[i % OPT_CYCLES])}
    ms_io = {}
    for label, extra in io.items():
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_prediction(h, fin, start, OPT_IO_CYCLES, **extra, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / OPT_IO_CYCLES * 1e3)
        ms_io[label] = min(walls)
    h.sst_table = h.tisr_table = None
    h.tisr_hours_per_entry = 1
    h.emit_components = False
    log(f"options' cycle profile ({n_prof} cycles of run_prediction, no "
        f"writer): {n_opt:g} device launches a cycle against the main "
        f"path's {n_main:g} in the same session order (K23 one more), "
        f"busy {busy_opt:.4f} ms against {busy_main:.4f}; ms a cycle "
        f"(median of 3 x {n_prof}): main path {ms_main:.2f}, options "
        f"{ms_opt:.2f}; with the options and (the better of 2 x "
        f"{OPT_IO_CYCLES}) " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in ms_io.items())
        + ("" if ok_m and ok_o else "; the profiler lost device events in "
           "every session, so the launches are not checked (the wrappers' "
           "counts above are)") + f"; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if ok_m and ok_o and n_opt - n_main != 1:
        fail(f"the options' cycle takes {n_opt - n_main:g} launches more "
             f"than the main path's, not one (K23)")
    return n23, n2


def phase_vertical(torch, np, gcm, layout, hyb_main, date0, card, kernels,
                   data=None):
    """Phase 15: vertical localization at full width.  (a) The nature run
    and forecasts of phase 10 (`data`, or made here when phase 15 runs
    alone), then train_hybrid with VERT_GROUPS groups of levels and an
    overlap of VERT_OVERLAP (m = 6000 a group, ESNHyper's defaults, noise
    0.2, phase 10's discarded samples and time chunks, region chunks of
    REGION_CHUNK, the solve in float64): six packs, Wout finite, stage
    seconds and the solve's TFLOP/s.  (b) The localized hybrid of those
    standardizers and reservoirs with a seeded untrained readout (bf16,
    as the main path; phase 10's trained readout diverges in a closed
    loop) two cycles in: K2's store into the grid bit for bit its vectors
    then core_scatter_plain through the bands' source table, and within
    K2_RTOL of readout_plain's; K3's feedback and local-model gathers
    against window_gather_plain within an ulp.  (c) VERT_CYCLES coupled
    cycles of run_prediction, every counter set to 0 before: fields
    finite, T in [150, 350] K, K1 and K2 six launches a cycle, K3 two;
    a localized cycle's launches and busy beside the main path's in the
    same session order (+3 K1, +3 K2).  (d) save_hybrid and load_hybrid
    of the localized hybrid: every tensor and zspec equal, two cycles of
    each from one state equal bit for bit."""
    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid, save_hybrid
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.hybrid import training
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                          core_scatter_plain,
                                                          grid_blocks,
                                                          split_grid)
    from speedy_ml_tpu_torch.esn.reservoir import esn_step
    from speedy_ml_tpu_torch.kernels.readout import readout, readout_plain
    from speedy_ml_tpu_torch.kernels.window_gather import (
        window_gather, window_gather_plain)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = gcm.geom
    nz, nlat, nlon = g.nlev, g.nlat, g.nlon
    stage = {}
    # -- (a) the data and the training --------------------------------------
    if data is None:
        t0 = time.perf_counter()
        truth, _, dates = training.generate_nature_run(gcm, date0, N_NATURE,
                                                       spinup_days=0)
        model = training.make_imperfect_forecasts(gcm, truth, dates)
        torch.cuda.synchronize()
        stage["nature run and forecasts"] = time.perf_counter() - t0
    else:
        truth, model, dates = data
    hyper = ESNHyper()
    timers = {"accumulate": training.train_subseries,
              "solve": training.solve_wout}

    def timed(name, fn):
        def w(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage[name] = stage.get(name, 0.0) + time.perf_counter() - t0
            return out
        return w

    for name, fn in timers.items():
        setattr(training, {"accumulate": "train_subseries",
                           "solve": "solve_wout"}[name], timed(name, fn))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        hyb_v = training.train_hybrid(
            gcm, layout, truth, model, hyper, TRAIN_SEED,
            num_vert_levels=VERT_GROUPS, vert_overlap=VERT_OVERLAP,
            n_discard=N_DISCARD, n_batches=(N_NATURE - N_DISCARD)
            // TIME_CHUNK, region_chunk=REGION_CHUNK,
            solve_dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
    finally:
        training.train_subseries = timers["accumulate"]
        training.solve_wout = timers["solve"]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    packs = hyb_v.packs
    if len(packs) != VERT_GROUPS * len(layout.classes) or [
            tuple(p.zspec)[:4] for p in packs[:VERT_GROUPS]] != [
            (0, 4, 0, 5), (4, 8, 3, 8)]:
        fail("phase 15: the localized hybrid's packs are not the six "
             "groups [0, 4) seeing [0, 5) and [4, 8) seeing [3, 8)")
    solve_flops = 0.0
    for pk in packs:
        if not bool(torch.isfinite(pk.res.wout).all()):
            fail(f"phase 15: pack {pk.cls.name} {tuple(pk.zspec)}: Wout is "
                 f"not finite")
        R, O_, A = pk.res.wout.shape
        solve_flops += R * (2.0 / 3.0 * A ** 3 + 2.0 * A * A * O_)
    stage["pack, standardize, generate"] = wall - stage["accumulate"] \
        - stage["solve"]
    log(f"phase 15: train_hybrid with {VERT_GROUPS} vertical groups, overlap "
        f"{VERT_OVERLAP}: {len(packs)} packs ("
        + ", ".join(f"{p.cls.name} z{p.zspec.z0}-{p.zspec.z1}: R="
                    f"{p.cls.count} n={p.res.n} I={p.res.n_in} "
                    f"S={p.res.n_speedy} O={p.res.n_outputs}"
                    for p in packs)
        + f"), m={hyper.m}, {N_NATURE - N_DISCARD} pairs, region chunks of "
        f"{REGION_CHUNK}, solve in float64: {wall:.1f} s; stages (wall s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; solve {solve_flops / 1e12:.2f} TFLOP at "
        f"{solve_flops / stage['solve'] / 1e12:.2f} TFLOP/s; peak memory "
        f"{peak:.2f} GiB [{card}]")

    # -- (b) K2's store and K3 at the localized shapes -----------------------
    gw = torch.Generator(device=dev).manual_seed(SEED + 31)
    packs = [p._replace(res=dataclasses.replace(p.res, wout=1e-3 * torch.randn(
        p.res.wout.shape, generator=gw, device=dev))) for p in packs]
    del hyb_v
    hyb = HybridAtmosphere(gcm, layout, packs, ml_only=False,
                           device=dev).cast_wout_bf16()
    del packs
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    s = hyb.init_state(sst_month0(g))
    for _ in range(2):
        s, _ = hyb.cycle(s, imon, fmon, tyear)
    xs = [esn_step(p.res, cs.x, cs.feedback, p.hyper.leakage)
          for p, cs in zip(hyb.packs, s.classes)]
    args = [dict(wout=p.res.wout, x=x, local_model=cs.local_model,
                 out_mean=p.std.out_mean, out_std=p.std.out_std)
            for p, x, cs in zip(hyb.packs, xs, s.classes)]
    table = torch.as_tensor(layout.core_source_table(
        [p.cls for p in hyb.packs], 4, nz, [p.zspec for p in hyb.packs]),
        device=dev)
    n_grid, q_blk, p_blk = grid_blocks(4, nz, nlat, nlon)
    grid = torch.full((n_grid,), float("nan"), device=dev)
    for a, idx in zip(args, hyb.core_index):
        readout(**a, scatter=CoreScatter(grid, idx, q_blk, p_blk))
    vecs = [readout(**a) for a in args]
    want = core_scatter_plain(vecs, table, 4, nz, nlat, nlon)
    parts = split_grid(grid, 4, nz, nlat, nlon)
    if bool(grid.isnan().any()) or not all(
            torch.equal(a_, b_) for a_, b_ in zip(parts, want)):
        fail("phase 15: K2's store through the bands differs from its "
             "vectors then core_scatter_plain")
    e2 = max(float((v - readout_plain(**a)).abs().max())
             / float(readout_plain(**a).abs().max())
             for v, a in zip(vecs, args))
    atmo, logp, precip = parts
    tisr = hyb.tisr_field(tyear).contiguous()
    fields = (atmo, logp, precip, s.sst_grid, tisr)
    fb = (fields, hyb.feedback_index, [p.std.in_mean for p in hyb.packs],
          [p.std.in_std for p in hyb.packs])
    lm_fields = (atmo.contiguous(),) + (logp.contiguous(),) * 4
    S = [p.res.n_speedy for p in hyb.packs]
    lm = (lm_fields, hyb.local_index,
          [p.std.out_mean[:, :k].contiguous() for p, k in zip(hyb.packs, S)],
          [p.std.out_std[:, :k].contiguous() for p, k in zip(hyb.packs, S)])
    e3 = 0.0
    for ga in (fb, lm):
        for k_, p_ in zip(window_gather(*ga), window_gather_plain(*ga)):
            ulp = float((torch.finfo(torch.float32).eps * p_.abs()).max())
            e3 = max(e3, float((k_ - p_).abs().max()) / max(ulp, 1e-30))
    log(f"phase 15: K2's store through the six packs' bands bit for bit "
        f"its vectors then core_scatter_plain, every grid element written "
        f"once; K2 against readout_plain {e2:.3e} of its scale (tolerance "
        f"{K2_RTOL:.0e}); K3's feedback and local-model gathers {e3:.3f} "
        f"ulps of their scale from window_gather_plain (tolerance 1)")
    if not (e2 <= K2_RTOL and e3 <= 1.0):
        fail("phase 15: K2 or K3 disagrees at the localized shapes")

    # -- (c) the localized cycles ---------------------------------------------
    for w in kernels.values():
        w.launches = 0
    t0 = time.perf_counter()
    end, dts = run_prediction(hyb, s, date0, VERT_CYCLES)
    torch.cuda.synchronize()
    t_cyc = (time.perf_counter() - t0) / VERT_CYCLES
    counts = {nm: kernels[nm].launches for nm in
              ("K1_esn_step", "K2_readout_scatter", "K3_window_gather")}
    if len(dts) != VERT_CYCLES or counts != {
            "K1_esn_step": 6 * VERT_CYCLES,
            "K2_readout_scatter": 6 * VERT_CYCLES,
            "K3_window_gather": 2 * VERT_CYCLES}:
        fail(f"phase 15: {len(dts)} cycles, launches {counts}")
    _, d = hyb.cycle(end, imon, fmon, tyear)
    for nm in ("atmo", "logp", "speedy_atmo", "speedy_logp"):
        if not bool(torch.isfinite(d[nm]).all()):
            fail(f"phase 15: {nm} is not finite after the localized cycles")
    tmin, tmax = float(d["speedy_atmo"][0].min()), \
        float(d["speedy_atmo"][0].max())
    if not (bool(end.safe) and 150.0 <= tmin and tmax <= 350.0):
        fail(f"phase 15: SPEEDY T {tmin}..{tmax} K, safe {bool(end.safe)}")
    # a session can lose its first device events (PERF.md §7): OCEAN_PAD
    # launches of K17b, which no cycle launches, go first in each call and
    # are left out of the counts and the busy time
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane
    pad = lambda: [tisr_plane(tyear, hyb._slat, hyb._clat, nlon)
                   for _ in range(OCEAN_PAD)]
    prof = {}
    for label, h, st in (("main path", hyb_main, None),
                         ("localized", hyb, end),
                         ("main path again", hyb_main, None),
                         ("localized again", hyb, end)):
        if st is None:
            st = h.init_state(sst_month0(g))
            st, _ = h.cycle(st, imon, fmon, tyear)
        fn = lambda: (pad(), h.cycle(st, imon, fmon, tyear))
        fn()
        _, kk, _ = profile_device(torch, fn, 4)
        kk = [e for e in kk if kernel_name(e.key) != "tisr_kernel"]
        prof[label] = (sum(_self_device_us(e) for e in kk) / 1e3 / 4,
                       sum(e.count for e in kk) / 4,
                       {kernel_name(e.key): e.count / 4 for e in kk})
    ms_m, n_m, by_m = prof["main path again"]
    ms_v, n_v, by_v = prof["localized again"]
    extra = {k: by_v.get(k, 0) - by_m.get(k, 0)
             for k in ("esn_step_kernel", "readout_kernel")}
    log(f"phase 15: {VERT_CYCLES} localized coupled cycles of run_prediction "
        f"({t_cyc * 1e3:.1f} ms a cycle on the host clock), safe, finite, "
        f"SPEEDY T {tmin:.3f}..{tmax:.3f} K; launches {counts}; profiled "
        f"(4 cycles a session): localized {prof['localized'][1]:g}, "
        f"{n_v:g} launches a cycle, busy {prof['localized'][0]:.4f}, "
        f"{ms_v:.4f} ms; the main path {prof['main path'][1]:g}, {n_m:g}, "
        f"busy {prof['main path'][0]:.4f}, {ms_m:.4f} ms; extra K1 and K2 "
        f"launches {extra} [{card}]")
    if extra != {"esn_step_kernel": 3, "readout_kernel": 3}:
        fail(f"phase 15: a localized cycle's extra launches {extra}, not 3 "
             f"K1 and 3 K2")

    # -- (d) the localized checkpoint ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_hybrid(hyb, tmp + "/vert")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_hybrid(gcm, layout, tmp + "/vert", device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        nbytes = dir_bytes(tmp + "/vert")
    back.cast_wout_bf16()
    if [p.zspec for p in back.packs] != [p.zspec for p in hyb.packs]:
        fail("phase 15: the loaded checkpoint's zspecs differ")
    same_packs(torch, hyb.packs, back.packs, "the localized checkpoint")
    a, b = end, end
    for _ in range(2):
        a, da = hyb.cycle(a, imon, fmon, tyear)
        b, db = back.cycle(b, imon, fmon, tyear)
    for nm in ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp"):
        if not torch.equal(da[nm], db[nm]):
            fail(f"phase 15: the loaded twin's {nm} differs after two "
                 f"cycles")
    log(f"phase 15: the localized checkpoint ({nbytes / 1e9:.2f} GB) saved "
        f"in {t_save:.2f} s, loaded in {t_load:.2f} s, every tensor and "
        f"zspec equal, two cycles of the twin bit for bit; phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    del back, hyb
    torch.cuda.empty_cache()


def phase_physics(torch, np, gcm, date0, card, record, kernels):
    """Phase 16: the optional physics (A15) on a T30L8 float32 GCM with
    SPPT, RDF (init_randfh(RDF_SEED)) and the cgrate limiter all on.
    (a) One stepone and two leapfrog steps (a shortwave step and another)
    with each new kernel's wrapper recording its inputs: K24 (both forms),
    K25 (both forms) and K26 against their plain versions on those inputs,
    in float32 and in float64 (the inputs cast), 0 difference; K8's
    tendency form: t, ps and tr bit for bit its main form's, vor's and
    div's tendencies within TAIL_RTOL of the plain tendency form's; a
    trigger case (vor's tendency grown to 1e-3 of the field, as
    tests/test_cgrate.py grows it) that must damp, bit for bit the plain
    version's; each kernel timed as the median of SHT_SESSIONS sessions
    beside its plain version and bound.  (b) A day (nsteps_day leapfrog
    steps after stepone) from date0: every step finite, T in [150, 350]
    K, from a state the plain GCM spun up PHYS_SPINUP days from rest;
    the first PHYS_HELD steps each from the card's state against the
    plain step on the CPU from the same state and the same draw
    (window_steps with phase 5's flip rule), the rest on the card alone;
    K24-K26's launches over the day (their counters set to 0 before it).
    (c) A profiled leapfrog step with all three on: its kernel and plain
    launches (the main path's ten, K24 twice, K6 once more, K25, K26; the
    draw's one plain launch).  Returns {kernel name: launches in (b)}."""
    from speedy_ml_tpu_torch.dycore import model as dymod
    from speedy_ml_tpu_torch.dycore.model import DycoreModel
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.kernels import cgrate as k26
    from speedy_ml_tpu_torch.kernels import rdf as k25
    from speedy_ml_tpu_torch.kernels import sppt as k24
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
    from speedy_ml_tpu_torch.physics import driver as drv
    from speedy_ml_tpu_torch.physics.randfor import init_randfh, rdf_weights

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    g = gcm.geom
    K, nlat, nlon, mx, nx = g.nlev, g.nlat, g.nlon, g.mx, g.nx
    G, MN = nlat * nlon, mx * nx
    gcm_o = GCM(g, dtype=f32, bd=gcm.bd, nsteps_day=gcm.nsteps_day,
                sppt_on=True, cgrate_on=True, device=dev)
    randfh = init_randfh(RDF_SEED, g, gcm_o.sht)
    gcm_o.phys.randfh = randfh
    log(f"phase 16: a T{g.trunc}L{K} float32 GCM with SPPT (phi "
        f"{gcm_o.sppt.phi:.6f}), RDF (init_randfh({RDF_SEED}), rms "
        f"{float(np.sqrt((randfh ** 2).mean())):.4f} K/day-scale) and "
        f"cgrate on")

    # -- (a) the kernels against their plain versions -------------------
    seen = {"rdf": {}, "perturb": [], "cgrate": [], "tail": []}
    o_rdf, o_pert = drv.rdf, drv.sppt_perturb
    o_cg, o_tail = dymod.cgrate, dymod.spectral_tail

    def rec_rdf(tt, h, v, xs=None):
        seen["rdf"][xs is not None] = (tt.clone(), h, v.clone(), xs)
        return o_rdf(tt, h, v, xs)

    def rec_pert(tends, pattern, mu=None):
        seen["perturb"].append(([t.clone() for t in tends], pattern, mu))
        return o_pert(tends, pattern, mu)

    def rec_cg(dyn, state, out, j1, dt, eps):
        seen["cgrate"].append((state, dataclasses.replace(
            out, vor=out.vor.clone(), div=out.div.clone()), j1, dt, eps))
        return o_cg(dyn, state, out, j1, dt, eps)

    def rec_tail(*a):
        seen["tail"].append(a)
        return o_tail(*a)

    drv.rdf, drv.sppt_perturb = rec_rdf, rec_pert
    dymod.cgrate, dymod.spectral_tail = rec_cg, rec_tail
    try:
        s0, fo = gcm_o.init_state(date0, sppt_seed=PHYS_SEED)
        s1 = gcm_o.stepone(s0, fo)
        s2 = gcm_o.leapfrog(s1, fo)          # istep 0: a shortwave step
        s3 = gcm_o.leapfrog(s2, fo)          # istep 1: another
    finally:
        drv.rdf, drv.sppt_perturb = o_rdf, o_pert
        dymod.cgrate, dymod.spectral_tail = o_cg, o_tail
    torch.cuda.synchronize()
    if not (True in seen["rdf"] and False in seen["rdf"]
            and len(seen["perturb"]) == 2 and len(seen["cgrate"]) == 4):
        fail("phase 16: the steps did not reach K24, K25 and K26 as "
             "expected")
    dyn64 = DycoreModel(g, dtype=f64, cgrate_on=True, device=dev)
    worst = {}

    def cast(t, rt, ct):
        if t is None:
            return None
        return t.to(ct if t.is_complex() else rt).contiguous()

    eta = gcm_o.sppt.noise(torch.Generator(device=dev).manual_seed(5))
    eta[0, 1, 2] = complex(12.0, -11.0)       # parts beyond the clip
    for rt, ct in ((f32, c64), (f64, c128)):
        tag = str(rt)[6:]
        # K24, the AR(1) form and the stationary first draw
        sp = cast(s2.sppt_spec, rt, ct)
        for nm, sig, phi in (("ar1", gcm_o.sppt.sigma, gcm_o.sppt.phi),
                             ("init", gcm_o.sppt.sigma0, 0.0)):
            st = torch.zeros_like(sp) if nm == "init" else sp
            a = (st, cast(eta, rt, ct), cast(sig, rt, ct), phi)
            worst[f"K24 {nm} {tag}"] = max_abs_diff(
                torch, torch.view_as_real(k24.sppt_ar1(*a)),
                torch.view_as_real(k24.sppt_ar1_plain(*a)))
        # K24, the perturbation (each recorded step)
        for i, (tends, pattern, mu) in enumerate(seen["perturb"]):
            tt = [cast(t, rt, ct) for t in tends]
            pk = k24.sppt_perturb([t.clone() for t in tt],
                                  cast(pattern, rt, ct), cast(mu, rt, ct))
            pp = k24.sppt_perturb_plain(tt, cast(pattern, rt, ct),
                                        cast(mu, rt, ct))
            worst[f"K24 perturb step {i} {tag}"] = max(
                max_abs_diff(torch, a, b) for a, b in zip(pk, pp))
        # K25, the shortwave form and the other
        for xs_on, (tt, h, v, xs) in seen["rdf"].items():
            xs_c = None if xs is None else k25.RdfHeating(
                *[cast(t, rt, ct) for t in xs[:5]],
                w=rdf_weights(gcm_o.phys.sig, nlon, rt, dev))
            a = (cast(tt, rt, ct), cast(h, rt, ct), cast(v, rt, ct))
            kt, kv = k25.rdf(a[0].clone(), a[1], a[2], xs_c)
            pt, pv = k25.rdf_plain(*a, xs_c)
            worst[f"K25 {'shortwave' if xs_on else 'other'} {tag}"] = max(
                max_abs_diff(torch, kt, pt), max_abs_diff(torch, kv, pv))
        # K26, stepone's two steps and the two leapfrog steps
        dy = gcm_o.dyn if rt == f32 else dyn64
        for i, (st, out, j1, dt_, eps) in enumerate(seen["cgrate"]):
            stc = st.map(lambda t: cast(t, rt, ct))
            oc = dataclasses.replace(out, vor=cast(out.vor, rt, ct),
                                     div=cast(out.div, rt, ct))
            ko = k26.cgrate(dy, stc, dataclasses.replace(
                oc, vor=oc.vor.clone(), div=oc.div.clone()), j1, dt_, eps)
            po = k26.cgrate_plain(dy, stc, oc, j1, dt_, eps)
            worst[f"K26 step {i} {tag}"] = max(
                max_abs_diff(torch, torch.view_as_real(getattr(ko, f)),
                             torch.view_as_real(getattr(po, f)))
                for f in ("vor", "div"))
        # K26 where the trigger fires: vor's tendency grown
        st, out, j1, dt_, eps = seen["cgrate"][-1]
        stc = st.map(lambda t: cast(t, rt, ct))
        grown = torch.stack([1e-3 * stc.vor[0], torch.zeros_like(
            stc.vor[0])]).contiguous()
        oc = dataclasses.replace(out, vor=grown, div=cast(out.div, rt, ct))
        _, cd = k26.damp_plain(stc.vor[0], grown[0], dy.sht.elm2)
        _, cd_free = k26.damp_plain(stc.vor[0], cast(out.vor, rt, ct)[0],
                                    dy.sht.elm2)
        ko = k26.cgrate(dy, stc, dataclasses.replace(
            oc, vor=oc.vor.clone(), div=oc.div.clone()), j1, dt_, eps)
        po = k26.cgrate_plain(dy, stc, oc, j1, dt_, eps)
        undamped = k26.leapfrog_plain(dy, stc.vor, grown[0], j1, dt_, eps)
        worst[f"K26 trigger {tag}"] = max(
            max_abs_diff(torch, torch.view_as_real(getattr(ko, f)),
                         torch.view_as_real(getattr(po, f)))
            for f in ("vor", "div"))
        if not float(cd) > 0.0 or torch.equal(ko.vor, undamped):
            fail(f"phase 16: cgrate's trigger did not fire on a tendency "
                 f"grown to 1e-3 of the field ({tag}: cd {float(cd)})")
        log(f"K26 trigger case ({tag}): cd {float(cd):.6e} (0.8e-3 expected "
            f"where every level triggers), the free run's cd "
            f"{float(cd_free):.3e}; the damped step differs from the "
            f"undamped one")
    # K8's tendency form against its main form and its plain version
    a = seen["tail"][-1]
    main_ = spectral_tail(*a[:-1], False)
    tend_ = spectral_tail(*a[:-1], True)
    plain_ = gcm_o.dyn.spectral_tail_plain(*a[1:-1], True)
    same = all(torch.equal(getattr(main_, f), getattr(tend_, f))
               for f in ("t", "ps", "tr"))
    e8 = max(per_field_err(torch, getattr(tend_, f)[0].reshape(-1, MN),
                           getattr(plain_, f)[0].reshape(-1, MN))[0]
             for f in ("vor", "div"))
    bad = {k: v for k, v in worst.items() if v > 0}
    log("K24-K26 against their plain versions on the inputs of stepone and "
        "two leapfrog steps (" + ", ".join(f"{k} {v:.3e}"
                                           for k, v in worst.items())
        + f"): tolerance 0; differing: {bad or 'none'}.  K8's tendency "
        f"form: t, ps, tr {'bit for bit' if same else 'NOT equal to'} the "
        f"main form's, vor/div tendencies {e8:.3e} of each field's scale "
        f"from the plain tendency form (tolerance {TAIL_RTOL:.0e})")
    if bad or not same or not e8 <= TAIL_RTOL:
        fail("phase 16: an optional-physics kernel disagrees with its "
             "plain version")

    # timings at the main path's shapes (float32)
    tends, pattern, mu = seen["perturb"][0]
    tt_sw, h, v_sw, xs = seen["rdf"][True]
    tt_o, _, v_o, _ = seen["rdf"][False]
    st, out, j1, dt_, eps = seen["cgrate"][-1]
    sp = s2.sppt_spec
    k24_fn = lambda: (k24.sppt_ar1(sp, eta, gcm_o.sppt.sigma,
                                   gcm_o.sppt.phi),
                      k24.sppt_perturb(tends, pattern, mu))
    k24_plain = lambda: (k24.sppt_ar1_plain(sp, eta, gcm_o.sppt.sigma,
                                            gcm_o.sppt.phi),
                         k24.sppt_perturb_plain(tends, pattern, mu))
    t24, r24 = measure_median(torch, k24_fn)
    ta1, _ = measure_median(torch, lambda: k24.sppt_ar1(
        sp, eta, gcm_o.sppt.sigma, gcm_o.sppt.phi))
    b24 = bound_ms(4 * (3 * 2 * K * MN + MN) + 4 * (9 * K * G + K),
                   4 * K * MN + 3 * 4 * K * G, PEAK_F32_S)
    record("K24_sppt", "speedy_ml_tpu_torch/kernels/csrc/sppt.cu",
           "speedy_ml_tpu/physics/sppt.py:54",
           max(v for k, v in worst.items() if k.startswith("K24")), 0.0,
           t24, measure(torch, k24_plain), b24)
    log(f"K24 both forms of a step, median of {SHT_SESSIONS} sessions: "
        f"{t24[0]:.4f} ms (the AR(1) form alone {ta1[0]:.4f}; sessions "
        + ", ".join(f"{r:.4f}" for r in r24) + f") [{card}]")
    t25, r25 = measure_median(torch, lambda: k25.rdf(tt_sw, h, v_sw, xs))
    t25o, _ = measure_median(torch, lambda: k25.rdf(tt_o, h, v_o))
    b25 = bound_ms(4 * (5 * K * G + G + 2 * G + 3 * K + 2 * 2 * nlat * K),
                   K * G * 8, PEAK_F32_S)
    record("K25_rdf", "speedy_ml_tpu_torch/kernels/csrc/rdf.cu",
           "speedy_ml_tpu/physics/randfor.py:83",
           max(v for k, v in worst.items() if k.startswith("K25")), 0.0,
           t25, measure(torch, lambda: k25.rdf_plain(tt_sw, h, v_sw, xs)),
           b25)
    log(f"K25 shortwave form, median of {SHT_SESSIONS} sessions: "
        f"{t25[0]:.4f} ms (sessions " + ", ".join(f"{r:.4f}" for r in r25)
        + f"); the other form {t25o[0]:.4f} ms [{card}]")
    cg_out = lambda: dataclasses.replace(out, vor=out.vor.clone(),
                                         div=out.div.clone())
    o1, o2 = cg_out(), cg_out()
    t26, r26 = measure_median(torch, lambda: k26.cgrate(
        gcm_o.dyn, st, o1, j1, dt_, eps))
    b26 = bound_ms(8 * 10 * K * MN + 2 * 4 * MN, 2 * 2 * 24 * K * MN,
                   PEAK_F32_S)
    record("K26_cgrate", "speedy_ml_tpu_torch/kernels/csrc/cgrate.cu",
           "speedy_ml_tpu/dycore/model.py:565",
           max(v for k, v in worst.items() if k.startswith("K26")), 0.0,
           t26, measure(torch, lambda: k26.cgrate_plain(
               gcm_o.dyn, st, o2, j1, dt_, eps)), b26)
    log(f"K26, median of {SHT_SESSIONS} sessions: {t26[0]:.4f} ms "
        f"(sessions " + ", ".join(f"{r:.4f}" for r in r26) + f") [{card}]")

    # -- (b) a day with all three on ---------------------------------------
    names = ("K24_sppt", "K25_rdf", "K26_cgrate")
    counters = (k24.sppt_ar1, k24.sppt_perturb, k25.rdf, k26.cgrate)
    gcm_c = GCM(g, dtype=f32, bd=gcm.bd.to(device=cpu),
                nsteps_day=gcm.nsteps_day, sppt_on=True, cgrate_on=True,
                device=cpu)
    gcm_c.phys.randfh = randfh
    # the day starts from a state the plain GCM (no options) spun up for
    # PHYS_SPINUP days from rest: from rest the aquaplanet's surface
    # pressure has almost no signal to hold a step's logp against
    t0 = time.perf_counter()
    spin, fo0 = gcm.init_state(date0)
    spin = gcm.run_window(gcm.stepone(spin, fo0), fo0,
                          PHYS_SPINUP * gcm.nsteps_day)
    torch.cuda.synchronize()
    log(f"phase 16: the plain GCM spun up {PHYS_SPINUP} days from rest "
        f"({time.perf_counter() - t0:.1f} s)")
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    s, fo = gcm_o.init_state(date0, spectral=spin.spectral,
                             sppt_seed=PHYS_SEED)
    fo_c = to_device(torch, fo, cpu)
    s = gcm_o.stepone(s, fo)
    gen = s.sppt_gen
    draw = lambda: gcm_o.sppt.noise(gen)
    s, es, flips, near = window_steps(torch, gcm_o, gcm_c, s, fo, fo_c,
                                      PHYS_HELD, eta_fn=draw)
    tmin, tmax = 1e9, -1e9
    for i in range(gcm_o.nsteps_day - PHYS_HELD):
        s = gcm_o.leapfrog(s, fo)
        t = gcm_o.sht.spec_to_grid(s.spectral.t[0])
        lo, hi, fin = float(t.min()), float(t.max()), bool(
            torch.isfinite(t).all())
        tmin, tmax = min(tmin, lo), max(tmax, hi)
        if not (fin and 150.0 <= lo and hi <= 350.0):
            fail(f"phase 16: step {PHYS_HELD + i} of the day: T "
                 f"{lo}..{hi} K, finite {fin}")
    torch.cuda.synchronize()
    counts = {"K24_sppt": k24.counter.launches, "K25_rdf": k25.rdf.launches,
              "K26_cgrate": k26.cgrate.launches}
    n_steps = gcm_o.nsteps_day
    want = {"K24_sppt": 1 + 2 * n_steps, "K25_rdf": 2 + n_steps,
            "K26_cgrate": 2 + n_steps}
    log(f"a day with SPPT, RDF and cgrate (stepone + {n_steps} leapfrog "
        f"steps, {time.perf_counter() - t0:.1f} s): T {tmin:.3f}..{tmax:.3f}"
        f" K over the last {n_steps - PHYS_HELD} steps, finite; the first "
        f"{PHYS_HELD} steps each against the plain step on the CPU from "
        f"the same state and draw: worst " + ", ".join(
            f"{v} {e:.3e}" for v, e in es.items())
        + f" of each variable's signal (tolerance {WINDOW_STEP_RTOL:.0e}); "
        f"flipped columns per step {flips} (at most {COLUMN_FLIPS:.1%} of "
        f"{G}), the largest difference in the others {near:.3e}; "
        f"launches {counts} (expected {want}: the init draw, then two K24 "
        f"a leapfrog step; K25 and K26 at stepone's two steps and each "
        f"leapfrog step)")
    if (max(es.values()) > WINDOW_STEP_RTOL or max(flips) > COLUMN_FLIPS * G
            or counts != want):
        fail("phase 16: the day with the optional physics disagrees")
    for nm in names:
        if counts[nm] <= 0:
            fail(f"phase 16: {nm} was not launched over the day")

    # -- (c) a profiled leapfrog step with all three on ------------------
    # the wrappers count the step's kernel launches; a profiler session
    # late in chip_smoke can lose its first device events (PERF.md §7):
    # OCEAN_PAD launches of K17b, which no step launches, go first in each
    # call and are left out, and a session that still sees fewer of the
    # port's kernels than the wrappers count is profiled again; if every
    # try comes up short the launches stand on the wrappers' count
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane
    ours = port_kernel_names()
    step = lambda: gcm_o.leapfrog(s, fo)
    step()
    torch.cuda.synchronize()
    for w in kernels.values():
        w.launches = 0
    step()
    torch.cuda.synchronize()
    n_kern = sum(w.launches for w in kernels.values())
    ph = gcm_o.phys
    pad = lambda: [tisr_plane(date0.tyear, ph.slat_t, ph.clat_t, nlon)
                   for _ in range(OCEAN_PAD)]
    is_pad = lambda e: kernel_name(e.key) == "tisr_kernel"
    seen = lambda kk: sum(e.count for e in kk if kernel_name(e.key) in ours
                          and not is_pad(e))
    reps = 10
    ms, kk, _ = profile_counts(torch, lambda: (pad(), step()), reps,
                               lambda kk: seen(kk) < reps * n_kern)
    complete = seen(kk) >= reps * n_kern
    kk = [e for e in kk if not is_pad(e)]
    ms = sum(_self_device_us(e) for e in kk) / 1e3 / reps
    kern = seen(kk) / reps
    plain = sum(e.count for e in kk if kernel_name(e.key) not in ours) / reps
    log(f"a leapfrog step with SPPT, RDF and cgrate: {n_kern} kernel "
        f"launches by the wrappers' count; profiled {kern:g} kernel and "
        f"{plain:g} plain ({ms:.4f} device ms; the main path's step: 10 "
        f"kernel launches); by name: " + ", ".join(
            f"{kernel_name(e.key)} {e.count / reps:g}" for e in kk)
        + ("" if complete else "; the profiler lost device events in every "
           "session, so the profile is not checked (the wrappers' count "
           "is)") + f" [{card}]")
    if n_kern != 15 or (complete and (kern != 15 or plain > 1)):
        fail(f"phase 16: a leapfrog step with the options is {n_kern} "
             f"kernel launches by the wrappers ({kern:g} kernel and "
             f"{plain:g} plain profiled), not 15 and 1")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_training(torch, gcm, layout, date0, card, record, atmo_ckpt: str,
                   keep: dict = None):
    """Phase 10: K14's checks, the nature run and the forecasts,
    train_hybrid_production at full width, its checks and the trained
    weights in the coupled cycle; its atmosphere saved to atmo_ckpt (10f).
    Returns the launches of K14 in the training run."""

    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.esn.train import NormalEq, solve_wout
    from speedy_ml_tpu_torch.hybrid.build import derive_seed
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    class_trainer,
                                                    train_class_production,
                                                    train_hybrid_production)
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu_torch.hybrid.training import (generate_nature_run,
                                                     make_imperfect_forecasts)
    from speedy_ml_tpu_torch.kernels import column_longwave as clw
    from speedy_ml_tpu_torch.kernels import surface_forcing as sfc_forcing
    from speedy_ml_tpu_torch.kernels.column_moist import (column_moist,
                                                          moist_shortwave)
    from speedy_ml_tpu_torch.kernels.column_pbl import column_pbl, pbl_flux
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update
    from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
    from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis
    from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis
    from speedy_ml_tpu_torch.kernels.spectral_stack import spectral_stack
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    hyper = ESNHyper()
    nz = gcm.geom.nlev
    shapes = {}
    for cls in layout.classes:
        xi, yi = cls.input_shape
        xc, yc = cls.core_shape
        I = (4 * nz + 4) * xi * yi
        n = hyper.nodes(I)
        O = (4 * nz + 2) * xc * yc
        shapes[cls.name] = (cls.count, n, O - xc * yc, O)
    interior = max(shapes.values())          # the 1,056-region class
    polar = min(shapes.values())

    # -- 10a. K14 against its plain version at four shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    _, n_i, S, O = interior
    err, main = k14_case(torch, "interior chunk", TIME_CHUNK, REGION_CHUNK,
                         n_i, S, O, card, gen)
    _, n_p, _, _ = polar
    err_p, _ = k14_case(torch, "polar chunk", TIME_CHUNK, polar[0], n_p, S,
                        O, card, gen)
    torch.cuda.empty_cache()
    # the trainer's own chunks (class_trainer's time_chunk and
    # train_class_production's region_chunk defaults)
    c_def = inspect.signature(class_trainer).parameters["time_chunk"].default
    r_def = inspect.signature(train_class_production) \
        .parameters["region_chunk"].default
    err_d, _ = k14_case(torch, "trainer-default chunk", c_def, r_def, n_i, S,
                        O, card, gen)
    torch.cuda.empty_cache()
    err_c, _ = k14_case(torch, "compute-bound chunk", 1896, 8, n_i, S, O,
                        card, gen)
    torch.cuda.empty_cache()
    k, p, lib, bound = main
    record("K14_gram_update",
           "speedy_ml_tpu_torch/kernels/csrc/gram_update.cu",
           "speedy_ml_tpu/esn/train.py:96", max(err, err_p, err_d, err_c),
           K14_RTOL, k, p, bound, library=lib)
    log("  (K14 max_abs_err is relative to max|ss| and max|st|, the worst "
        "of the four shapes in float32; its times are the interior "
        "chunk's, both of its launches, the panel and the tiles, of each "
        "call, and so are its launches)")

    # -- 10b. the nature run and the imperfect model's forecasts
    counted = {"K1": esn_step, "K14": gram_update, "K5": sht_analysis,
               "K6": sht_synthesis, "K7": grid_dynamics, "K8": spectral_tail,
               "K9": column_moist, "K9_moist_shortwave": moist_shortwave,
               "K10a": clw.down_surface, "K10b": clw.radlw_up,
               "K12": column_pbl, "K12_pbl_flux": pbl_flux,
               "K15": spectral_stack}
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    stage = {}
    t0 = time.perf_counter()
    truth, _, dates = generate_nature_run(gcm, date0, N_NATURE,
                                          spinup_days=0)
    torch.cuda.synchronize()
    stage["nature run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = make_imperfect_forecasts(gcm, truth, dates)
    torch.cuda.synchronize()
    stage["forecasts"] = time.perf_counter() - t0
    if keep is not None:    # phase 15 trains on the same data
        keep["data"] = (truth, model, dates)
    for nm, d in (("truth", truth), ("forecast", model)):
        for key, v in d.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"the nature run's {nm} {key} is not finite")
    t_field = truth["atmo"][:, 0]
    log(f"nature run: {N_NATURE} samples at 6 h from {date0.year}-"
        f"{date0.month:02d}-{date0.day:02d} (no spin-up), T "
        f"{float(t_field.min()):.2f}..{float(t_field.max()):.2f} K, "
        f"precip max {float(truth['precip'].max()):.3e}; forecasts of "
        f"the imperfect model {tuple(model['atmo'].shape)}")

    # -- 10c. train_hybrid_production at full width
    src = ArraySource(truth, model)
    timings = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hyb_t = train_hybrid_production(
        gcm, layout, src, hyper, TRAIN_SEED, hybrid=True, stride=1,
        time_chunk=TIME_CHUNK, n_discard=N_DISCARD,
        region_chunk=REGION_CHUNK, solve_dtype=torch.float64,
        timings=timings, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {nm: fn.launches for nm, fn in counted.items()}
    for nm, c in counts.items():
        if c <= 0:
            fail(f"{nm} was not launched in the training phase")
    stage.update(timings)
    pairs = N_NATURE - N_DISCARD
    log(f"training: train_hybrid_production, {layout.n_regions} regions in "
        f"{len(layout.classes)} classes, m={hyper.m}, noise "
        f"{hyper.noise_mag}, {N_DISCARD} discarded + {pairs} pairs, time "
        f"chunks of {TIME_CHUNK}, region chunks of {REGION_CHUNK}, solve "
        f"in float64: {wall:.1f} s; peak memory allocated {peak:.2f} GiB; "
        f"launches in the phase {counts}")

    # -- 10d. checks
    for pk in hyb_t.packs:
        if not bool(torch.isfinite(pk.res.wout).all()):
            fail(f"class {pk.cls.name}: Wout is not finite")
    gram_flops = solve_flops = 0.0
    for pk in hyb_t.packs:
        R, O_, A = pk.res.wout.shape
        gram_flops += 2.0 * pairs * R * A * (A + O_)
        solve_flops += R * (2.0 / 3.0 * A ** 3 + 2.0 * A * A * O_)
    worst_res = worst_w = 0.0
    for i, (cls, pk) in enumerate(zip(layout.classes, hyb_t.packs)):
        tr = class_trainer(layout, cls, src, hyper, derive_seed(TRAIN_SEED, i),
                           nz, time_chunk=TIME_CHUNK, n_discard=N_DISCARD,
                           std=pk.std, device=dev)
        if not torch.equal(tr.res.vals, pk.res.vals):
            fail(f"class {cls.name}: the reservoir drawn again differs")
        eq = tr.normal_equations(0, 8)
        eq64 = NormalEq(eq.ss.double(), eq.st.double())
        w64 = solve_wout(eq64, hyper, tr.S)
        ridge = torch.full((eq.ss.shape[1],), hyper.beta_res ** 2,
                           dtype=torch.float64, device=dev)
        ridge[:tr.S] = hyper.beta_model ** 2
        lhs = torch.linalg.matmul(eq64.ss, w64.transpose(1, 2)) \
            + ridge[None, :, None] * w64.transpose(1, 2)
        rhs = eq64.st.transpose(1, 2)
        rel = (torch.linalg.matrix_norm(lhs - rhs)
               / torch.linalg.matrix_norm(rhs))
        worst_res = max(worst_res, float(rel.max()))
        w_run = pk.res.wout[:8].double()
        worst_w = max(worst_w, float((w64.float().double() - w_run).abs()
                                     .max() / w_run.abs().max()))
        del eq, eq64, w64, lhs
    log(f"training checks: Wout finite in every class; solve residual "
        f"|(ss + ridge) Wout^T - st^T| / |st^T| <= {worst_res:.3e} over 8 "
        f"regions of each class (tolerance {RESIDUAL_MAX:.0e}, float64); "
        f"those regions' Wout from the retained chunk vs the run's: "
        f"{worst_w:.3e} of its scale")
    if not worst_res <= RESIDUAL_MAX:
        fail("the ridge solve's residual is too large")
    log("training stages (wall s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stage.items())
        + f"; Gram {gram_flops / 1e12:.2f} TFLOP at "
        f"{gram_flops / timings['accumulate'] / 1e12:.2f} TFLOP/s over the "
        f"accumulate stage, solve {solve_flops / 1e12:.2f} TFLOP at "
        f"{solve_flops / timings['solve'] / 1e12:.2f} TFLOP/s [{card}]")

    # -- 10e. the trained weights in the coupled cycle, in bf16 (a cast
    #    copy: hyb_t keeps its float32 Wout for 10f)
    hyb_bf = HybridAtmosphere(gcm, layout, hyb_t.packs, ml_only=False,
                              device=dev).cast_wout_bf16()
    st = hyb_bf.init_state(truth["sst"][-1])
    date = dates[-1].advance_hours(6)
    trip = None
    for i in range(CYCLES_TRAINED):
        st, _ = run_prediction(hyb_bf, st, date, 1, stop_if_unsafe=False)
        date = date.advance_hours(6)
        if trip is None and not bool(st.safe):
            trip = i
        for cs in st.classes:
            for nm in ("x", "feedback", "local_model"):
                if not bool(torch.isfinite(getattr(cs, nm)).all()):
                    fail(f"the trained hybrid's {nm} is not finite after "
                         f"cycle {i}")
    log(f"trained weights (bf16 Wout): {CYCLES_TRAINED} coupled cycles of "
        f"run_prediction, state finite; the gate "
        + ("did not trip" if trip is None else f"tripped at cycle {trip}"))

    # -- 10f. the checkpoint at full width
    phase_checkpoint(torch, gcm, layout, hyb_t, hyb_bf, src, hyper, truth,
                     dates, wall, card, atmo_ckpt)
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return counts["K14"]


def same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (NaN included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def seeded_ocean_packs(torch, hyb, seed: int) -> list:
    """Untrained slab-ocean packs for hyb's layout at OCEAN_HYPER's size:
    seeded reservoirs (esn.reservoir.generate), a 1e-3 normal readout,
    the SST unstandardized as 288 K + the output."""
    from speedy_ml_tpu_torch.esn.ocean import OCEAN_HYPER, ocean_index_map
    from speedy_ml_tpu_torch.esn.reservoir import BatchedReservoir, generate
    from speedy_ml_tpu_torch.hybrid.build import derive_seed
    from speedy_ml_tpu_torch.hybrid.model import OceanPack
    dev = hyb.device
    out = []
    for i, cls in enumerate(hyb.layout.classes):
        idx = ocean_index_map(cls, hyb.nz)
        R, I = cls.count, len(idx)
        cols, vals, win, shifts = generate(
            derive_seed(seed, i), R, I, OCEAN_HYPER, 0.9, radius_iters=30,
            device=dev)
        xc, yc = cls.core_shape
        gen = torch.Generator(device=dev).manual_seed(
            derive_seed(seed, 100 + i))
        wout = 1e-3 * torch.randn((R, xc * yc, vals.shape[2]), generator=gen,
                                  device=dev)
        res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, wout=wout,
                               mean=torch.zeros((R, I), device=dev),
                               std=torch.ones((R, I), device=dev), n_in=I,
                               shifts=shifts)
        out.append(OceanPack(cls=cls, res=res, hyper=OCEAN_HYPER,
                             idx_map=idx,
                             mean_sst=torch.full((R, 1), 288.0, device=dev),
                             std_sst=torch.ones((R, 1), device=dev)))
    return out


def phase_dispatch(torch, np, gcm, hyb, date0, card, record, kernels,
                   work: Path) -> dict:
    """Phase 17: the batched prediction loop (run_prediction with
    cycles_per_dispatch > 1) as replays of captured CUDA graphs of the
    cycle (hybrid/graph.py).  (a) The device-scalar forms of K17 (with
    and without the carry), K21 (accumulate and couple), K22's push and
    push_mean, K23 and K3 (the date, and a TISR table's row) against
    their by-value forms (torch.equal) and their plain versions (0
    difference), float32 and float64 (K3 float32, the type it takes),
    each timed.  (b) The coupled main path at full width: run_prediction
    over DISPATCH_CHECK cycles from 1990-01-01 12:00 in dispatches of
    DISPATCH_CHECK_K (they cross a day) against the eager loop (K = 1)
    from the same state: the stream, the time means, the dates and the
    final state equal bit for bit, every kernel's launches equal the
    eager loop's; then from that state 3 cycles at DISPATCH_DATE2, with
    no new capture, against 3 eager cycles there.  (c) The product forms,
    DISPATCH_STRETCH cycles each in one dispatch against the eager loop,
    bit for bit: the persistent surface with the slab ocean (seeded
    untrained ocean packs, smooth continents), a TISR table and
    emit_components from step 0 (the first cycle eager, then the coupler
    on steps 3, 7, ... and a slab step on 27); the SST and TISR tables
    with emit_components and a bias ramp; the ML-only cycle.  (d) The
    gate: a NaN in the state's SST grid at one point trips it on the
    second cycle of a dispatch; the dates stop there, as the eager loop's,
    and the records kept are equal.  (e) The replays of one dispatch
    under torch.cuda.set_sync_debug_mode("error").  (f) cycle_ms of the
    coupled main path for K = 1 and K = DISPATCH_K (5 runs of N_TIMED
    cycles each, median and range), device busy a cycle, the idle share,
    the device launches and the CUDA API launches the host issues a
    cycle, from one profile of each.  Returns each device-scalar form's
    launches on its captured path, by its name in the kernels line."""
    from speedy_ml_tpu_torch.data.calendar import ModelDate, hour_of_year_365
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.graph import dispatcher, tree_tensors
    from speedy_ml_tpu_torch.hybrid.model import (ROW_SF, HybridAtmosphere,
                                                  ocean_snapshot)
    from speedy_ml_tpu_torch.kernels import slab_couple as k21
    from speedy_ml_tpu_torch.kernels import slab_ocean as k22
    from speedy_ml_tpu_torch.kernels import sst_by_date as k23
    from speedy_ml_tpu_torch.kernels import surface_forcing as sfk
    from speedy_ml_tpu_torch.kernels import window_gather as k3
    from speedy_ml_tpu_torch.physics import land_sea

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    g = gcm.geom
    nz, nlat, nlon = g.nlev, g.nlat, g.nlon
    G = nlat * nlon
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    phys = gcm.phys
    sst0 = sst_month0(g)
    sst_t, tisr_t, hpe = option_tables(torch, np, g, dev)
    gcm_l = GCM(g, dtype=f32, bd=continents_bd(torch, np, gcm.bd, g),
                device=dev)
    land = (gcm_l.bd.fmask_l >= 1.0 / 3.0).to(f32)
    h_oc = HybridAtmosphere(
        gcm_l, hyb.layout, hyb.packs, ml_only=False,
        ocean_packs=seeded_ocean_packs(torch, hyb, SEED + 23),
        base_sst=torch.as_tensor(sst0, dtype=f32, device=dev),
        sea_mask=land, device=dev)
    s0 = hyb.init_state(sst0)
    for _ in range(2):
        s0, d0 = hyb.cycle(s0, imon, fmon, tyear)
    row_of = lambda h, *a, **kw: torch.tensor(h.scalar_row(*a, **kw),
                                              dtype=f64, device=dev)
    when = lambda d: f"{d.year}-{d.month:02d}-{d.day:02d} {d.hour:02d}:00"

    # -- (a) the device-scalar forms --------------------------------------
    worst = {}
    slat64 = torch.as_tensor(g.sin_lat, dtype=f64, device=dev)
    clat64 = torch.as_tensor(g.cos_lat, dtype=f64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 170)
    rnd = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev, dtype=f64)
    stl64 = rnd(250, 310, nlat, nlon)
    acc64 = [rnd(-60, 60, nlat, nlon) for _ in range(4)]
    win64 = [rnd(-20, 20, nlat, nlon) for _ in range(4)]
    pert64 = [rnd(-2, 2, nlat, nlon) for _ in range(3)]
    args = {}
    for dt in (f32, f64):
        c = lambda t: t.to(dt).contiguous()
        bd_ = gcm.bd.to(dtype=dt)
        day_ = phys.day_args(tyear) if dt == f32 else sfk.DayArgs(
            tyear, slat64, clat64, phys.gamlat, phys.pexp)
        sst_ = c(s0.sst_grid)
        sf = row_of(hyb, imon, fmon, tyear)[:ROW_SF]
        ty = str(dt)[6:]
        for carry in (None, c(stl64)):
            kw = dict(month=(imon, fmon), sst_hybrid=sst_, day=day_,
                      stl_carry=carry)
            kv = torch.cat(sfk.surface_forcing(bd_, **kw))
            kd = torch.cat(sfk.surface_forcing(bd_, scalars=sf, **kw))
            ps = sfk.surface_plain(bd_, imon, fmon, sst_hybrid=sst_)
            q = dict(zip(sfk.SURFACE, ps))
            pf = sfk.forcing_plain(bd_, q["stl"] if carry is None else carry,
                                   q["snowd"], q["sst_am"], q["sice"], day_,
                                   nlon)
            if not torch.equal(kd, kv):
                fail(f"K17's device-scalar form ({ty}) differs from its "
                     f"by-value form")
            nm = "K17" + (" carry" if carry is not None else "")
            worst[f"{nm} {ty}"] = max_abs_diff(torch, kd,
                                               torch.cat([ps, pf]))
            if dt == f32 and carry is None:
                args["K17"] = (bd_, kw, sf)
        clim = land_sea.init_surface_state(bd_, imon, fmon)
        carry = dataclasses.replace(clim, **{
            k: getattr(clim, k) + c(p)
            for k, p in zip(("stl_lm", "sst_om", "tice_om"), pert64)})
        coef = land_sea.build_slab_coeffs(bd_, np.rad2deg(g.lat_radians), dt,
                                          device=dev)
        for couple in (False, True):
            kw = dict(window=[c(w) for w in win64],
                      ok=torch.tensor(True, device=dev), do_couple=couple)
            a21 = (bd_, coef, carry, [c(a) for a in acc64], (imon, fmon),
                   land_sea.CplFlags(icsea=2))
            kv = k21.slab_couple(*a21, **kw)
            kd = k21.slab_couple(*a21, scalars=sf, **kw)
            pl = k21.slab_couple_plain(*a21, **kw)
            for x, y in zip(kd, kv):
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(x, y)):
                    fail(f"K21's device-scalar form ({ty}) differs from "
                         f"its by-value form")
            form = "couple" if couple else "accumulate"
            worst[f"K21 {form} {ty}"] = max(
                max_abs_diff(torch, x, y) for x, y in zip(kd, pl)
                if x is not None)
            if dt == f32 and couple:
                args["K21"] = (a21, kw, sf)
        # K22's push forms on the slab ocean's full-width rings
        W = h_oc.SLAB_STRIDE - 1
        fbs = [rnd(-2, 2, h_oc.packs[i].cls.count,
                   h_oc.packs[i].res.n_in).to(dt).contiguous()
               for i in h_oc._bottom_index()]
        rings = [rnd(-2, 2, W, op.cls.count, len(op.idx_map)).to(dt)
                 .contiguous() for op in h_oc.ocean_packs]
        for step in (5, W - 1, 2 * W + 26):
            slot = torch.tensor([float(step % W)], dtype=f64, device=dev)
            for form in ("push", "push_mean"):
                r_v, r_d, r_p = ([r.clone() for r in rings]
                                 for _ in range(3))
                kw = dict(step=step, fbs=fbs, idx_maps=h_oc.ocean_index)
                mv = k22.slab_ocean(form, bufs=r_v, **kw)
                md = k22.slab_ocean(form, bufs=r_d, slot=slot, **kw)
                mp = k22.slab_ocean_plain(form, bufs=r_p, **kw)
                outs_d = r_d + (md or [])
                if not all(torch.equal(x, y) for x, y in
                           zip(outs_d, r_v + (mv or []))):
                    fail(f"K22's device-scalar form ({form}, step {step}, "
                         f"{ty}) differs from its by-value form")
                worst[f"K22 {form} step {step} {ty}"] = max(
                    max_abs_diff(torch, x, y)
                    for x, y in zip(outs_d, r_p + (mp or [])))
                if dt == f32 and form == "push" and step == 5:
                    args["K22"] = (rings, kw, slot)
        tab = sst_t.to(dt).contiguous()
        for day, bias in ((31, 1.0), (364, -2.5)):
            dv = torch.tensor([float(day), bias], dtype=f64, device=dev)
            kd = k23.sst_by_date(tab, 0, 0.0, dv)
            if not torch.equal(kd, k23.sst_by_date(tab, day, bias)):
                fail(f"K23's device-scalar form ({ty}) differs from its "
                     f"by-value form")
            worst[f"K23 day {day} {ty}"] = max_abs_diff(
                torch, kd, k23.sst_by_date_plain(tab, day, bias))
            if dt == f32 and day == 31:
                args["K23"] = (tab, dv, day, bias)
    # K3 (float32): the date, and the TISR table's row
    atmo, logp, precip = d0["atmo"], d0["logp"], d0["precip"]
    ga = ([hyb.feedback_index, [p.std.in_mean for p in hyb.packs],
           [p.std.in_std for p in hyb.packs]])
    base = (atmo, logp, precip, s0.sst_grid)
    sf32 = row_of(hyb, imon, fmon, tyear)[:ROW_SF]
    r = (hour_of_year_365(date0) // hpe) % tisr_t.shape[0]
    forms3 = {
        "date": ((*base, hyb.tisr_date(tyear, sf32)),
                 (*base, hyb.tisr_date(tyear)),
                 (*base, sfk.tisr_plain(tyear, hyb._slat, hyb._clat, nlon))),
        "table row": ((*base, k3.TisrRow(tisr_t, torch.tensor(
            [float(r)], dtype=f64, device=dev))), (*base, tisr_t[r]),
            (*base, tisr_t[r]))}
    for nm, (fd, fv, fp) in forms3.items():
        kd = k3.window_gather(fd, *ga)
        if not all(torch.equal(x, y) for x, y in
                   zip(kd, k3.window_gather(fv, *ga))):
            fail(f"K3's device-scalar form ({nm}) differs from its by-value "
                 f"form")
        worst[f"K3 {nm} float32"] = max(
            max_abs_diff(torch, x, y)
            for x, y in zip(kd, k3.window_gather_plain(fp, *ga)))
    bad = {k: v for k, v in worst.items() if v > 0}
    log(f"device-scalar forms against their by-value forms (torch.equal) and "
        f"their plain versions ({len(worst)} cases, float32 and float64): "
        f"max_abs_err {max(worst.values()):.3e} (tolerance 0); cases that "
        f"differ: {bad or 'none'}")
    if bad:
        fail("a device-scalar form disagrees with its plain version")
    # times (float32), each the median of SHT_SESSIONS sessions, beside
    # the by-value form

    def k17_plain(bd_, kw):
        ps = sfk.surface_plain(bd_, imon, fmon, sst_hybrid=kw["sst_hybrid"])
        q = dict(zip(sfk.SURFACE, ps))
        return ps, sfk.forcing_plain(bd_, q["stl"], q["snowd"], q["sst_am"],
                                     q["sice"], kw["day"], nlon)

    n_out = sum(i.numel() for i in hyb.feedback_index)
    n_src = sum(f.numel() for f in base) + G
    rings, kw22, slot = args["K22"]
    N22 = sum(x[0].numel() for x in rings)
    n_idx = sum(i.numel() for i in kw22["idx_maps"])
    bd_, kw17, sf = args["K17"]
    a21, kw21, _ = args["K21"]
    tab, dv, day, bias = args["K23"]
    fd3 = forms3["date"][0]
    cases = {
        "K17_surface_forcing_dev": (
            "speedy_ml_tpu_torch/kernels/csrc/surface_forcing.cu",
            "speedy_ml_tpu/physics/land_sea.py:191",
            lambda: sfk.surface_forcing(bd_, scalars=sf, **kw17),
            lambda: sfk.surface_forcing(bd_, **kw17),
            lambda: k17_plain(bd_, kw17),
            bound_ms(4 * (G * (16 + 5 + 19) + 2 * nlat),
                     130 * G + 150 * nlat, PEAK_F32_S),
            [k for k in worst if k.startswith("K17")]),
        "K21_slab_couple_dev": (
            "speedy_ml_tpu_torch/kernels/csrc/slab_couple.cu",
            "speedy_ml_tpu/physics/land_sea.py:244",
            lambda: k21.slab_couple(*a21, scalars=sf, **kw21),
            lambda: k21.slab_couple(*a21, **kw21),
            lambda: k21.slab_couple_plain(*a21, **kw21),
            bound_ms(4 * G * 47 + 1, 80 * G, PEAK_F32_S),
            [k for k in worst if k.startswith("K21")]),
        "K22_slab_ocean_dev": (
            "speedy_ml_tpu_torch/kernels/csrc/slab_ocean.cu",
            "speedy_ml_tpu/hybrid/model.py:678",
            lambda: k22.slab_ocean("push", bufs=rings, slot=slot, **kw22),
            lambda: k22.slab_ocean("push", bufs=rings, **kw22),
            lambda: k22.slab_ocean_plain("push", bufs=rings, **kw22),
            bound_ms(4 * (2 * N22 + n_idx), 0, PEAK_F32_S),
            [k for k in worst if k.startswith("K22")]),
        "K23_sst_by_date_dev": (
            "speedy_ml_tpu_torch/kernels/csrc/sst_by_date.cu",
            "speedy_ml_tpu/hybrid/model.py:546",
            lambda: k23.sst_by_date(tab, 0, 0.0, dv),
            lambda: k23.sst_by_date(tab, day, bias),
            lambda: k23.sst_by_date_plain(tab, day, bias),
            bound_ms(2 * 4 * G, 2 * G, PEAK_F32_S),
            [k for k in worst if k.startswith("K23")]),
        "K3_window_gather_dev": (
            "speedy_ml_tpu_torch/kernels/csrc/window_gather.cu",
            "speedy_ml_tpu/esn/domain.py:252, "
            "speedy_ml_tpu/hybrid/model.py:525",
            lambda: k3.window_gather(fd3, *ga),
            lambda: k3.window_gather(forms3["date"][1], *ga),
            lambda: k3.window_gather_plain(forms3["date"][2], *ga),
            bound_ms(4 * (4 * n_out + n_src), 2 * n_out, PEAK_F32_S),
            [k for k in worst if k.startswith("K3")])}
    for nm, (src, rep, fn_d, fn_v, fn_p, bound, keys, *_) in cases.items():
        (kd_ms, kd_c), runs = measure_one_launch(torch, fn_d)
        (kv_ms, _), runs_v = measure_one_launch(torch, fn_v)
        log(f"{nm}: {kd_ms:.4f} ms (sessions "
            + ", ".join(f"{x:.4f}" for x in runs) + f"), the by-value form "
            f"{kv_ms:.4f} ms (" + ", ".join(f"{x:.4f}" for x in runs_v)
            + f"), medians of the sessions that saw every launch [{card}]")
        record(nm, src, rep, max(worst[k] for k in keys), 0.0,
               (kd_ms, kd_c), measure(torch, fn_p, reps=10), bound)
    log("  (K22_slab_ocean_dev's numbers are the push form's; "
        "K3_window_gather_dev's the date form's)")

    # -- helpers: K = 1 against K > 1 ----------------------------------------
    def counts():
        out = {nm: fn.launches for nm, fn in kernels.items()}
        for nm, fn in (("K17_surface_forcing_dev", sfk.surface_forcing),
                       ("K21_slab_couple_dev", k21.slab_couple),
                       ("K22_slab_ocean_dev", k22.slab_ocean),
                       ("K23_sst_by_date_dev", k23.sst_by_date),
                       ("K3_window_gather_dev", k3.window_gather)):
            out[nm] = fn.dev_launches
        return out

    def reset():
        for fn in kernels.values():
            fn.launches = 0
        for fn in (sfk.surface_forcing, k21.slab_couple, k22.slab_ocean,
                   k23.sst_by_date, k3.window_gather):
            fn.dev_launches = 0

    def pair(tag, h, st, date, n, K, same_final=True, **kw):
        """run_prediction of n cycles from st eagerly and in dispatches of
        K, each with a writer and time means, the counters set to 0 before
        each run; fails unless the streams, the time means, the dates and
        (same_final) the final states are equal bit for bit.  Returns
        (final, dates, launches, wall s) of each, K = 1 first."""
        res = []
        for k in (1, K):
            d = work / f"dispatch_{tag}_k{k}"
            s_in = ocean_snapshot(st) if h.ocean_packs else st
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            fin, dts = run_prediction(
                h, s_in, date, n, output_path=str(d / "pred"),
                time_mean_path=str(d / "tm.npz")
                if getattr(h.gcm, "bd", None) is not None else None,
                cycles_per_dispatch=k, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res.append((fin, dts, counts(), wall, d))
        (f1, d1, c1, _, p1), (fk, dk, ck, _, pk) = res
        if [str(x) for x in d1] != [str(x) for x in dk]:
            fail(f"{tag}: the dates of K = {K} ({len(dk)}) differ from the "
                 f"eager loop's ({len(d1)})")
        for fname in ("pred.npz", "tm.npz"):
            if not (p1 / fname).exists():
                continue
            z1, zk = np.load(p1 / fname), np.load(pk / fname)
            if sorted(z1.files) != sorted(zk.files):
                fail(f"{tag}: {fname} keys {sorted(zk.files)} against "
                     f"{sorted(z1.files)}")
            for key in z1.files:
                a, b = z1[key], zk[key]
                if a.shape != b.shape or a.dtype != b.dtype or not (
                        a.tobytes() == b.tobytes()):
                    fail(f"{tag}: {fname} {key} of K = {K} differs from the "
                         f"eager loop's")
        if same_final:
            ta, tb = tree_tensors(f1), tree_tensors(fk)
            if len(ta) != len(tb) or not all(
                    same_bits(torch, a, b) for a, b in zip(ta, tb)) or \
                    f1.step != fk.step or bool(f1.safe) != bool(fk.safe):
                fail(f"{tag}: the final state of K = {K} differs from the "
                     f"eager loop's")
        return res

    disp = dispatcher(hyb)
    # -- (b) the coupled main path -------------------------------------------
    start = ModelDate(1990, 1, 1, 12)
    n_cap = disp.captures
    r_main = pair("main", hyb, s0, start, DISPATCH_CHECK, DISPATCH_CHECK_K)
    c1, ck = r_main[0][2], r_main[1][2]
    path = [nm for nm in kernels if nm not in OFF_MAIN_PATH]
    for nm in path:
        if ck[nm] == 0:
            fail(f"{nm} was not launched on the captured main path")
        if ck[nm] != c1[nm]:
            fail(f"the captured main path launched {nm} {ck[nm]} times, the "
                 f"eager loop {c1[nm]}")
    if ck["K17_surface_forcing_dev"] != DISPATCH_CHECK:
        fail(f"K17's device-scalar form ran "
             f"{ck['K17_surface_forcing_dev']} times in "
             f"{DISPATCH_CHECK} captured cycles")
    launches = {"K17_surface_forcing_dev": ck["K17_surface_forcing_dev"]}
    log(f"captured main path: run_prediction {DISPATCH_CHECK} coupled "
        f"cycles from {when(start)} in dispatches of {DISPATCH_CHECK_K} "
        f"(across a day) against the eager loop: stream, time means, dates "
        f"and final state bit for bit; launches equal kernel by kernel "
        f"({sum(c1[nm] for nm in path)} in all: "
        + ", ".join(f"{nm.split('_')[0]} {ck[nm]}" for nm in path)
        + f"), K17's device-scalar form {ck['K17_surface_forcing_dev']}; "
        f"{disp.captures - n_cap} form(s) captured; {r_main[0][3]:.3f} s "
        f"eager, {r_main[1][3]:.3f} s batched with the writer and time means")
    n_cap = disp.captures
    fin = r_main[1][0]
    date2 = ModelDate(*DISPATCH_DATE2)
    pair("date2", hyb, fin, date2, 3, DISPATCH_CHECK_K)
    if disp.captures != n_cap:
        fail(f"the second date captured {disp.captures - n_cap} new form(s)")
    log(f"second date: 3 cycles from {when(date2)} replayed by the forms "
        f"captured at {when(start)} (no new capture) equal the eager "
        f"cycles there, bit for bit")

    # -- (c) the product forms --------------------------------------------
    h_oc.persist_surface = True
    h_oc.emit_components = True
    h_oc.set_tisr_table(tisr_t, hpe)
    n_cap = disp.captures
    r = pair("persist_ocean", h_oc, h_oc.init_state(sst0), date0,
             DISPATCH_STRETCH, DISPATCH_STRETCH)
    ck = r[1][2]
    # the first cycle runs eagerly (by value), the others replayed
    want = {nm: DISPATCH_STRETCH - 1 for nm in (
        "K17_surface_forcing_dev", "K21_slab_couple_dev",
        "K22_slab_ocean_dev", "K3_window_gather_dev")}
    for nm, n in want.items():
        if ck[nm] != n:
            fail(f"persist_ocean: {nm} ran {ck[nm]} times, not {n}")
    launches["K21_slab_couple_dev"] = ck["K21_slab_couple_dev"]
    launches["K22_slab_ocean_dev"] = ck["K22_slab_ocean_dev"]
    oc_disp = dispatcher(h_oc)
    log(f"persistent surface + slab ocean + TISR table + components: "
        f"{DISPATCH_STRETCH} cycles from step 0 in one dispatch (the first "
        f"cycle eager; couplings on steps 3, 7, ...; a slab step on 27) "
        f"equal the eager loop bit for bit; {oc_disp.captures} forms "
        f"captured; device-scalar launches K21 {ck['K21_slab_couple_dev']}, "
        f"K22 {ck['K22_slab_ocean_dev']}, K3 {ck['K3_window_gather_dev']}, "
        f"K17 {ck['K17_surface_forcing_dev']}; {r[0][3]:.3f} s eager, "
        f"{r[1][3]:.3f} s batched")
    h_tb = HybridAtmosphere(gcm, hyb.layout, hyb.packs, ml_only=False,
                            device=dev)
    h_tb.set_sst_table(sst_t)
    h_tb.set_tisr_table(tisr_t, hpe)
    h_tb.emit_components = True
    r = pair("tables", h_tb, s0, ModelDate(1990, 1, 31, 12),
             DISPATCH_STRETCH, DISPATCH_STRETCH,
             sst_bias_per_year=OPT_BIAS_PER_YEAR)
    ck = r[1][2]
    if ck["K23_sst_by_date_dev"] != DISPATCH_STRETCH:
        fail(f"tables: K23's device-scalar form ran "
             f"{ck['K23_sst_by_date_dev']} times")
    launches["K23_sst_by_date_dev"] = ck["K23_sst_by_date_dev"]
    log(f"SST and TISR tables + components + bias ramp: {DISPATCH_STRETCH} "
        f"cycles from 1990-01-31 12:00 in one dispatch equal the eager loop "
        f"bit for bit; device-scalar launches K23 "
        f"{ck['K23_sst_by_date_dev']}, K3 {ck['K3_window_gather_dev']}, K17 "
        f"{ck['K17_surface_forcing_dev']}; {r[0][3]:.3f} s eager, "
        f"{r[1][3]:.3f} s batched")
    del h_tb
    h_ml = build_untrained_hybrid(gcm, n_regions=N_REGIONS, m=M, seed=SEED,
                                  ml_only=True, radius_iters=30, device=dev)
    h_ml.cast_wout_bf16()
    r = pair("ml_only", h_ml, h_ml.init_state(sst0), date0,
             DISPATCH_STRETCH, DISPATCH_STRETCH)
    ck = r[1][2]
    if ck["K3_window_gather_dev"] != DISPATCH_STRETCH:
        fail(f"ml_only: K3's device-scalar form ran "
             f"{ck['K3_window_gather_dev']} times")
    launches["K3_window_gather_dev"] = ck["K3_window_gather_dev"]
    log(f"ML-only: {DISPATCH_STRETCH} cycles in one dispatch equal the eager "
        f"loop bit for bit; K3's device-scalar form (the date) "
        f"{ck['K3_window_gather_dev']} launches; {r[0][3]:.3f} s eager, "
        f"{r[1][3]:.3f} s batched")
    del h_ml, h_oc, oc_disp

    # -- (d) the gate ---------------------------------------------------------
    bad = dataclasses.replace(s0, sst_grid=s0.sst_grid.clone())
    bad.sst_grid[nlat // 2, nlon // 3] = float("nan")
    r = pair("gate", hyb, bad, start, DISPATCH_CHECK, DISPATCH_CHECK_K,
             same_final=False)
    if len(r[1][1]) != 2:
        fail(f"the gate: {len(r[1][1])} dates kept, not 2 (the NaN in the "
             f"SST trips it on the second cycle)")
    if bool(r[1][0].safe):
        fail("the gate: the dispatch's final state reads safe")
    log(f"gate: a NaN in the state's SST grid trips it on the second cycle of "
        f"a dispatch of {DISPATCH_CHECK_K}; the dates stop there (2), as the "
        f"eager loop's, and the records kept are equal bit for bit")

    # -- (e) one dispatch with host syncs forbidden ---------------------------
    recs = disp.records(DISPATCH_CHECK_K)
    per = [(d.month - 1, d.tmonth, d.tyear, hour_of_year_365(d), 0.0)
           for d in (start.advance_hours(6 * i)
                     for i in range(DISPATCH_CHECK_K))]
    s_e = disp.dispatch(s0, per, recs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_e = disp.dispatch(s_e, per, recs)
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"a dispatch synchronizes with the host: {e}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"sync debug: the replays of one dispatch ({DISPATCH_CHECK_K} "
        f"cycles) ran under torch.cuda.set_sync_debug_mode('error')")

    # -- (f) cycle_ms, busy and launches, K = 1 and K = DISPATCH_K ---------
    timing = {}
    for K in (1, DISPATCH_K):
        run = lambda: run_prediction(hyb, s0, date0, N_TIMED,
                                     cycles_per_dispatch=K)
        run()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / N_TIMED * 1e3)
        walls.sort()
        busy, kk, prof = profile_device(torch, run, reps=1, ranges=True)
        host = sum(e.count for e in prof.key_averages()
                   if e.key in HOST_LAUNCH_API) / N_TIMED
        timing[K] = (walls, busy / N_TIMED,
                     sum(e.count for e in kk) / N_TIMED, host)
    for K, (walls, busy, n_dev, host) in timing.items():
        log(f"captured loop K = {K}: cycle_ms {walls[2]:.4f} median (min "
            f"{walls[0]:.4f}, max {walls[-1]:.4f}) over 5 runs of "
            f"run_prediction x {N_TIMED} cycles, no writer; device busy "
            f"{busy:.4f} ms/cycle, idle share {1 - busy / walls[2]:.1%} of "
            f"the median; {n_dev:g} device launches a cycle; {host:g} CUDA "
            f"API launches a cycle from the host (profiler runtime events "
            f"{', '.join(HOST_LAUNCH_API[:5])}...) [{card}]")
    w1, wk = timing[1][0][2], timing[DISPATCH_K][0][2]
    log(f"phase 17: K = {DISPATCH_K} runs a coupled cycle in {wk:.4f} ms "
        f"against {w1:.4f} ms eager ({w1 / wk:.2f}x); "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def _moves(h):
    """(copies, bytes) moved between the shards of a meshed hybrid so
    far: its regions' (ShardedCycleOps) and, with the GCM sharded, its
    GCM's (GridShards)."""
    ops, grid = h._sharded_ops, getattr(h.gcm, "grid", None)
    return (ops.copies + (grid.copies if grid else 0),
            ops.copy_bytes + (grid.copy_bytes if grid else 0))


def phase_mesh(torch, np, gcm, hyb, date0, card, kernels, record):
    """Phase 20: the hub-free sharded cycle (hybrid/sharded.py) at the main
    path's full width on MESH_SHARDS shards, with the GCM on mesh.devices[0]
    (set_mesh(mesh, shard_gcm=False)) and with the GCM sharded too
    (set_mesh(mesh), the JAX default: dycore/sharded.py), each against
    the unsharded cycle from the same parameters and state, bit for bit;
    each m-range and band form against the whole kernel's slice (bit for
    bit) and its plain version; the dry run's training step at m = 6000
    and its lat halo exchange; launches, busy and the moves between shards
    a cycle, the window's device time.  Returns the launches of the forms
    on the sharded GCM's run_prediction, by MESH_FORMS name."""
    import copy
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane
    from speedy_ml_tpu_torch.parallel.dryrun import (check_lat_halo,
                                                     check_training_step)
    from speedy_ml_tpu_torch.parallel.mesh import gather_rows
    t_phase = time.perf_counter()
    g = gcm.geom
    D = MESH_SHARDS
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    visible = torch.cuda.device_count()
    mesh = mesh_of(torch, D)
    if visible < D:
        log(f"phase 20: {visible} card(s) visible: the {D} shards "
            f"all on cuda:0 (every line of the sharded cycle but the "
            f"transport between cards)")
    sh = copy.copy(hyb)
    sh.set_mesh(mesh, shard_gcm=False)
    ops = sh._sharded_ops
    shg = copy.copy(hyb)
    shg.set_mesh(mesh)
    grid = shg.gcm.grid
    log(f"phase 20: {mesh}; sectors of {ops.W} longitudes, "
        + ", ".join(f"{p.cls.name}: {t.Rloc} regions a shard"
                    for p, t in zip(hyb.packs, ops.tables))
        + f"; the sharded GCM's m ranges {grid.ranges} and latitude-pair "
        f"bands {grid.bands}")
    s0 = hyb.init_state(sst_month0(g))
    for _ in range(2):
        s0, _ = hyb.cycle(s0, imon, fmon, tyear)
    # the seconds of the phase's parts, in its last line
    part_s, t_part = {}, [t_phase]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    part("set-up")

    # -- (a), (e) the cycles, bit for bit ---------------------------------
    def same_cycles(h, label):
        a, b = s0, h.shard_state(s0)
        for c in range(MESH_CYCLES):
            a, da = hyb.cycle(a, imon, fmon, tyear)
            b, db = h.cycle(b, imon, fmon, tyear)
            for k in ("atmo", "logp", "precip", "speedy_atmo",
                      "speedy_logp"):
                if not same_bits(torch, da[k], db[k]):
                    fail(f"phase 20: cycle {c}: the {label} {k} differs "
                         f"from the unsharded")
            for i, (ca, cb) in enumerate(zip(a.classes, b.classes)):
                for nm in ("x", "feedback", "local_model"):
                    if not same_bits(torch, getattr(ca, nm),
                                     gather_rows(getattr(cb, nm),
                                                 ca.x.device)):
                        fail(f"phase 20: cycle {c}: class {i}'s {label} "
                             f"{nm} differs from the unsharded")
            if not bool(a.safe) or not bool(b.safe):
                fail(f"phase 20: cycle {c} tripped the gate ({label})")
        log(f"phase 20: {MESH_CYCLES} {label} cycles bit for bit the "
            f"unsharded (atmo, logp, precip, the window's fields, every "
            f"class's x, feedback and local model; the gate safe in each)")
        return da

    same_cycles(sh, "sharded")
    part("(a) cycles")
    d_last = same_cycles(shg, "sharded-GCM")
    part("(e) sharded-GCM cycles")

    # -- (b), (f) the main path's entry point, launches kernel by kernel ----
    runs = {}
    for label, h, st in (("unsharded", hyb, s0),
                         ("sharded", sh, sh.shard_state(s0)),
                         ("sharded GCM", shg, shg.shard_state(s0))):
        torch.cuda.synchronize()
        for w in kernels.values():
            w.launches = 0
        moved = _moves(h) if h is not hyb else (0, 0)
        t0 = time.perf_counter()
        fin, dts = run_prediction(h, st, date0, MESH_CYCLES)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / MESH_CYCLES * 1e3
        if len(dts) != MESH_CYCLES:
            fail(f"phase 20: the {label} run stopped after {len(dts)} cycles")
        after = _moves(h) if h is not hyb else (0, 0)
        runs[label] = (fin, {nm: w.launches for nm, w in kernels.items()},
                       wall, after[0] - moved[0], after[1] - moved[1])
    (fa, ka, wa, _, _) = runs["unsharded"]
    n = MESH_CYCLES
    sharded_k = ("K1_esn_step", "K2_readout_scatter", "K3_window_gather")
    for label in ("sharded", "sharded GCM"):
        fb, kb_, wb, n_mv, b_mv = runs[label]
        for i, (ca, cb) in enumerate(zip(fa.classes, fb.classes)):
            if not same_bits(torch, ca.x, gather_rows(cb.x, ca.x.device)):
                fail(f"phase 20: run_prediction's final class {i} x "
                     f"differs ({label})")
        for nm in kernels:
            if nm in sharded_k or (label == "sharded GCM"
                                   and nm in MESH_BANDED):
                want = ka[nm] * D
            elif label == "sharded GCM" and nm in MESH_WHOLE:
                w1 = MESH_WHOLE[nm] * n
                want = (ka[nm] - w1) * D + w1
            else:
                want = ka[nm]
            if kb_[nm] != want:
                fail(f"phase 20: {nm} launched {kb_[nm]} times in the "
                     f"{label} run, {want} expected")
        for nm in sharded_k + ("K5_sht_analysis", "K20_window_select"):
            if kb_[nm] <= 0:
                fail(f"phase 20: {nm} was not launched on the {label} path")
        shown = sharded_k + ((MESH_BANDED + tuple(MESH_WHOLE))
                             if label == "sharded GCM" else ())
        log(f"phase 20: run_prediction, {MESH_CYCLES} cycles each, "
            f"{label}: launches a cycle {label} / unsharded: "
            + ", ".join(f"{nm.split('_')[0]} {kb_[nm] / n:g}/"
                        f"{ka[nm] / n:g}" for nm in shown)
            + f", every other kernel the same; moves between shards a "
            f"cycle {n_mv / n:g}, {b_mv / n / 2 ** 20:.4f} MiB; host "
            f"clock {wb:.2f} against {wa:.2f} ms a cycle [{card}]")
    kg = runs["sharded GCM"][1]
    form_launches = {
        "K15_spectral_stack_mrange": kg["K15_spectral_stack"] - n,
        "K6_sht_synthesis_band": kg["K6_sht_synthesis"] - n,
        "K5_sht_analysis_mrange": kg["K5_sht_analysis"] - 2 * n,
        "K8_spectral_tail_mrange": kg["K8_spectral_tail"]}
    part("(b) run_prediction")

    # -- (c) busy and launches a cycle (profiler) ----------------------------
    # a session can lose its first device events (PERF.md §7): MESH_PAD
    # launches of K17b go first in each cycle and are left out, and a
    # session that saw fewer of the cycle's launches of the port's kernels
    # than the wrappers counted in a call is profiled again
    # (profile_counts)
    pad = lambda: [tisr_plane(tyear, hyb._slat, hyb._clat, g.nlon)
                   for _ in range(MESH_PAD)]
    names = {"esn_step_kernel": "K1", "readout_kernel": "K2",
             "window_gather_kernel": "K3"}
    port_names = port_kernel_names()
    prof = {}
    fg = runs["sharded GCM"][0]
    fs = runs["sharded"][0]
    for label, h, st in (("unsharded", hyb, fa), ("sharded", sh, fs),
                         ("sharded GCM", shg, fg),
                         ("unsharded again", hyb, fa),
                         ("sharded again", sh, fs),
                         ("sharded GCM again", shg, fg)):
        fn = lambda h=h, st=st: (pad(), h.cycle(st, imon, fmon, tyear))
        n_p = MESH_PROFILE_CYCLES
        torch.cuda.synchronize()
        for w in kernels.values():
            w.launches = 0
        fn()
        want = n_p * sum(w.launches for nm, w in kernels.items()
                         if nm != "K17b_tisr_plane")
        seen = lambda kk: sum(e.count for e in kk
                              if kernel_name(e.key) in port_names
                              and kernel_name(e.key) != "tisr_kernel")
        _, kk, _ = profile_counts(torch, fn, n_p, lambda kk: seen(kk) < want)
        kk = [e for e in kk if kernel_name(e.key) != "tisr_kernel"]
        got = seen(kk)
        per = {}
        for e in kk:
            k = names.get(kernel_name(e.key), "other")
            ms, cnt = per.get(k, (0.0, 0.0))
            per[k] = (ms + _self_device_us(e) / 1e3 / n_p,
                      cnt + e.count / n_p)
        busy = sum(v[0] for v in per.values())
        launches = sum(v[1] for v in per.values())
        prof[label] = (busy, launches, per)
        log(f"phase 20 profile, {label}: busy {busy:.4f} ms and "
            f"{launches:g} device launches a cycle; "
            + ", ".join(f"{k} {v[0]:.4f} ms, {v[1]:g}"
                        for k, v in sorted(per.items()))
            + ("" if got >= want else f"; the session lost launches: "
               f"{got} of the port's {want}")
            + f" [{card}]")
    part("(c) profile")

    # -- (g) the window alone, unsharded and with the GCM sharded ------------
    spec_, _ = hyb.inject_to_speedy(d_last["atmo"], d_last["logp"])
    sst_ = fa.sst_grid
    for label, h in (("unsharded", hyb), ("sharded GCM", shg),
                     ("unsharded again", hyb), ("sharded GCM again", shg)):
        fn = lambda h=h: h.speedy_window(spec_, sst_, imon, fmon, tyear)
        fn()
        ms, kk, _ = profile_device(torch, fn, reps=2)
        by = {}
        for e in kk:
            k = kernel_name(e.key)
            k = k if k in port_names else "plain"
            t_, c_ = by.get(k, (0.0, 0.0))
            by[k] = (t_ + _self_device_us(e) / 2e3, c_ + e.count / 2)
        log(f"phase 20 window, {label}: device {ms:.4f} ms, "
            f"{sum(v[1] for v in by.values()):g} launches a window; "
            + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:g})"
                        for k, v in sorted(by.items(),
                                           key=lambda kv: -kv[1][0]))
            + f" [{card}]")
    part("(g) window")

    # -- (h) the m-range and band forms -------------------------------------
    mesh_forms(torch, hyb, shg, spec_, sst_, imon, fmon, tyear, card,
               record)
    part("(h) forms")

    # -- (d) the dry run's training step at full width, the lat halos ------
    t0 = time.perf_counter()
    shape = check_training_step(hyb.packs[1], mesh)
    check_lat_halo(torch.as_tensor(sst_month0(g), dtype=torch.float32,
                                   device=hyb.device), mesh)
    log(f"phase 20: the sharded training step (8 regions a shard of the "
        f"interior class, T = 9, the solve in float64): Wout {shape} bit "
        f"for bit solve_wout's, in {time.perf_counter() - t0:.1f} s; the "
        f"lat halo exchange of the SST over {D} bands exact")
    part("(d) training step, halos")

    # -- (f) the captured loop on both meshed hybrids -----------------------
    mesh_captured(torch, hyb, (("sharded", sh), ("sharded GCM", shg)), s0,
                  date0, card, kernels)
    part("(f) captured loop")
    del sh, shg
    # -- (g) the slab ocean on a mesh ----------------------------------------
    mesh_ocean(torch, np, gcm, hyb, mesh, date0, card)
    part("(g) slab ocean")
    # -- (h) cgrate and RDF on a meshed GCM ---------------------------------
    form_launches.update(mesh_cgrate_rdf(torch, np, gcm, mesh, date0, card,
                                         record, spec_))
    part("(h) cgrate, RDF")
    # -- (i) the training dry run at m = 6000 -------------------------------
    from speedy_ml_tpu_torch.parallel.train_dryrun import dryrun_m6000
    r = dryrun_m6000(mesh, log=log)
    log(f"phase 20 training dry run: {r['regions']} interior regions at "
        f"m = {r['m']}, A = {r['A']}, each shard's Gram block "
        f"({r['regions'] // D}, {r['A']}, {r['A']}) on its device "
        f"({r['gram_shard_bytes'] / 1e9:.3f} GB), Wout finite and sharded; "
        f"accumulate {r['accumulate_s']:.2f} s, solve {r['solve_s']:.2f} s "
        f"({r['solve_flops'] / r['solve_s'] / 1e12:.2f} TFLOP/s) [{card}]")
    part("(i) training dry run")
    log(f"phase 20 passed in {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items())
        + f") [{card}]")
    return form_launches


def mesh_forms(torch, hyb, shg, spec, sst, imon, fmon, tyear, card,
               record):
    """Phase 20 (h): the forms of K15, K6, K5 and K8 that the sharded GCM
    launches (the shards' tables; K15's and K8's with their m0), and its
    banded K7 and column physics, on every shard, from one whole window
    step of the unsharded GCM on the main path's state: each form's output
    bit for bit the whole kernel's m range or band, and within the
    tolerance of phase 4 of its plain version on the same inputs.  The
    forms of shard 1 (an m range from m0 > 0) are timed and recorded,
    each from the sessions that saw every launch (late in a full run a
    session can lose half of them)."""
    from speedy_ml_tpu_torch.dycore.state import SpectralState
    from speedy_ml_tpu_torch.gcm import GCMState
    from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
    from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis_plain
    from speedy_ml_tpu_torch.kernels.sht_synthesis import \
        sht_synthesis_plain
    from speedy_ml_tpu_torch.kernels.spectral_stack import (
        dynamics_ncos, dynamics_stack_plain, physics_stack_plain,
        spectral_stack)
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
    from speedy_ml_tpu_torch.parallel.mesh import band_rows
    gw, gm = hyb.gcm, shg.gcm
    g = gw.geom
    K, nlat, nlon, nx = g.nlev, g.nlat, g.nlon, g.nx
    grid = gm.grid
    dyn, sht = gw.dyn, gw.sht
    sfc, forcing = gw.window_entry(imon, fmon, tyear, sst)
    rad, flx = gw.window_carries()
    gst = gw.stepone(GCMState(spectral=spec, sfc=sfc, radiation=rad,
                              fluxes=flx, istep=0), forcing)
    st = gst.spectral
    imp = dyn.imp_double
    ncos = dynamics_ncos(K, g.ntracers)
    n0 = 1 + 3 * K
    corr = (forcing.tcorh, forcing.qcorh)
    # one whole step's kernels
    dstk, pstk = spectral_stack(dyn, st, gw.phis, 1, 0)
    gall = sht.synthesis(dstk, ncos)
    ptend, _ = gw._physics_fn(st, 0, dyn, sfc, forcing, gst.radiation, True,
                              stack=pstk)
    k7 = grid_dynamics(gall, ptend, dyn.column_tables(imp), K, 1)
    A = dyn.analysis_stack(k7)
    new = spectral_tail(dyn, A, st, gw.phis, corr, imp, 2, dyn.delt2,
                        dyn.rob, 0, True)
    sfc_b = grid.split_fields(sfc)
    frc_b = gm.shard_forcing(forcing)
    rad_b = grid.split_fields(gst.radiation)
    worst = {}

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for d, ((m0, m1), band) in enumerate(zip(grid.ranges, grid.bands)):
        dv = gm.sdyn.dyns[d]
        sv = dv.sht
        rng = lambda t: t[..., m0:m1, :].contiguous()
        bnd = lambda t: band_rows(t, band, nlat)
        st_d = SpectralState(**{f: rng(getattr(st, f))
                                for f in SpectralState.FIELDS})
        phis_d = rng(gw.phis)
        s_d, p_d = spectral_stack(dv, st_d, phis_d, 1, 0)
        if not (same_bits(torch, s_d, rng(dstk))
                and same_bits(torch, p_d, rng(pstk))):
            fail(f"phase 20: K15's m-range form on shard {d} differs from "
                 f"the whole kernel's range")
        note("K15_spectral_stack_mrange", max(
            per_field_err(torch, s_d, dynamics_stack_plain(dv, st_d, 1))[0],
            per_field_err(torch, p_d,
                          physics_stack_plain(dv, st_d, 0, phis_d))[0]))
        g6 = sv.synthesis(dstk, ncos)
        if not same_bits(torch, g6, bnd(gall)):
            fail(f"phase 20: K6's band form on shard {d} differs from the "
                 f"whole kernel's band")
        note("K6_sht_synthesis_band", per_field_err(
            torch, g6, sht_synthesis_plain(dstk, sv.dft_inv, sv.cpol_even_g,
                                           sv.cpol_odd_g, sv.cosgr_g,
                                           ncos))[0])
        pt_d, _ = gm._band_fns[d](st_d, 0, dv, sfc_b[d], frc_b[d], rad_b[d],
                                  True, stack=pstk)
        for f in ("u", "v", "t", "tr"):
            if not same_bits(torch, getattr(pt_d, f),
                             bnd(getattr(ptend, f))):
                fail(f"phase 20: the column physics on band {d} differs "
                     f"from the whole grid's ({f} tendency)")
        k7_d = grid_dynamics(g6, pt_d, dv.column_tables(dv.imp_double), K, 1)
        if not same_bits(torch, k7_d, bnd(k7)):
            fail(f"phase 20: K7 on band {d} differs from the whole grid's")
        a_d = sv.analysis(k7, n0)
        if not same_bits(torch, a_d, rng(A)):
            fail(f"phase 20: K5's m-range form on shard {d} differs from "
                 f"the whole kernel's range")
        note("K5_sht_analysis_mrange", per_field_err(
            torch, a_d, sht_analysis_plain(k7, sv.dft_fwd, sv.wt,
                                           sv.cpol_even_s, sv.cpol_odd_s,
                                           sv.cosgr, n0))[0])
        c_d = (frc_b[d].tcorh, frc_b[d].qcorh)
        targs = (a_d, st_d, phis_d, c_d, dv.imp_double, 2, dyn.delt2,
                 dyn.rob, 0, True)
        n_d = spectral_tail(dv, *targs)
        npl = dv.spectral_tail_plain(*targs)
        for f in SpectralState.FIELDS:
            if not same_bits(torch, getattr(n_d, f), rng(getattr(new, f))):
                fail(f"phase 20: K8's m-range form on shard {d} differs "
                     f"from the whole kernel's range ({f})")
            MNd = (m1 - m0) * nx
            note("K8_spectral_tail_mrange", per_field_err(
                torch, getattr(n_d, f).reshape(-1, MNd),
                getattr(npl, f).reshape(-1, MNd))[0])
        if d == 1:
            timed = (dv, sv, st_d, phis_d, targs, m1 - m0, band)
    log(f"phase 20 forms: on every shard K15's and K8's m-range forms, "
        f"K6's band form, K5's m-range form, K7 and the column physics on "
        f"the bands bit for bit the whole kernels' ranges and bands; "
        f"against the plain versions: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    # shard 1's forms timed, with the bounds of their own work
    dv, sv, st_d, phis_d, targs, mr, band = timed
    MN, MNr, G = g.mx * nx, mr * nx, nlat * nlon
    iy, iyb = g.nlat_half, band[1] - band[0]
    Gb = 2 * iyb * nlon
    n_in15, n_out15 = 2 * (4 * K + 1) + 1, (6 * K + 2) + (5 * K + 1)
    B6, B5 = dstk.shape[0], k7.shape[0]
    st_bytes = sum(getattr(st_d, f).numel() * 8 for f in SpectralState.FIELDS)
    ok = True
    ok &= record(
        "K15_spectral_stack_mrange",
        "speedy_ml_tpu_torch/kernels/csrc/spectral_stack.cu",
        "speedy_ml_tpu/core/spectral.py:243", worst[
            "K15_spectral_stack_mrange"], 0.0,
        measure_one_launch(torch, lambda: spectral_stack(
            dv, st_d, phis_d, 1, 0))[0],
        measure(torch, lambda: (dynamics_stack_plain(dv, st_d, 1),
                                physics_stack_plain(dv, st_d, 0, phis_d)),
                reps=10),
        bound_ms(8 * MNr * (n_in15 + n_out15) + 4 * dv.stack_blob.numel(),
                 MNr * (48 * K + 4 * K * K + 8), PEAK_F32_S))
    ok &= record(
        "K6_sht_synthesis_band",
        "speedy_ml_tpu_torch/kernels/csrc/sht_synthesis.cu",
        "speedy_ml_tpu/core/spectral.py:296",
        worst["K6_sht_synthesis_band"], SHT_RTOL,
        measure_one_launch(torch, lambda: sv.synthesis(dstk, ncos))[0],
        measure(torch, lambda: sht_synthesis_plain(
            dstk, sv.dft_inv, sv.cpol_even_g, sv.cpol_odd_g, sv.cosgr_g,
            ncos), reps=50),
        bound_ms(B6 * (8 * MN + 4 * Gb) + 8 * g.mx * nlon + 4 * iyb * MN
                 + 8 * iyb,
                 B6 * (4 * iyb * MN + 4 * iyb * g.mx + 4 * Gb * g.mx),
                 PEAK_F32_S))
    ok &= record(
        "K5_sht_analysis_mrange",
        "speedy_ml_tpu_torch/kernels/csrc/sht_analysis.cu",
        "speedy_ml_tpu/core/spectral.py:256",
        worst["K5_sht_analysis_mrange"], SHT_RTOL,
        measure_one_launch(torch, lambda: sv.analysis(k7, n0))[0],
        measure(torch, lambda: sht_analysis_plain(
            k7, sv.dft_fwd, sv.wt, sv.cpol_even_s, sv.cpol_odd_s,
            sv.cosgr, n0), reps=50),
        bound_ms(B5 * (4 * G + 8 * MNr) + 8 * mr * nlon + 4 * iy * MNr
                 + 4 * nlat,
                 B5 * (4 * G * mr + 6 * iy * mr + 4 * iy * MNr),
                 PEAK_F32_S))
    ok &= record(
        "K8_spectral_tail_mrange",
        "speedy_ml_tpu_torch/kernels/csrc/spectral_tail.cu",
        "speedy_ml_tpu/dycore/model.py:386",
        worst["K8_spectral_tail_mrange"], TAIL_RTOL,
        measure_one_launch(torch, lambda: spectral_tail(dv, *targs))[0],
        measure(torch, lambda: dv.spectral_tail_plain(*targs), reps=10),
        bound_ms(targs[0].numel() * 8 + 2 * st_bytes + 3 * MNr * 8
                 + dv.imp_double.blob.numel() * 4,
                 MNr * (12 * K * K + 100 * K + 20), PEAK_F32_S))
    if not ok:
        fail("phase 20: a form is outside its tolerance against its plain "
             "version")


def same_hybrid_states(torch, a, b) -> list:
    """The fields in which two hybrid states (either one sharded) differ:
    every class's x, feedback and local model, the SST grid, the slab
    ocean's x, ring and lm (each gathered on a's device), the gate."""
    from speedy_ml_tpu_torch.parallel.mesh import Sharded, gather_rows
    dev = a.sst_grid.device
    whole = lambda t, dim=0: (gather_rows(t, dev, dim)
                              if isinstance(t, Sharded) else t)
    bad = [] if same_bits(torch, a.sst_grid, b.sst_grid) else ["sst_grid"]
    for i, (ca, cb) in enumerate(zip(a.classes, b.classes)):
        bad += [f"class {i} {nm}" for nm in ("x", "feedback", "local_model")
                if not same_bits(torch, whole(getattr(ca, nm)),
                                 whole(getattr(cb, nm)))]
    for i, (oa, ob) in enumerate(zip(a.ocean, b.ocean)):
        bad += [f"ocean {i} {nm}" for nm, dim in (("x", 0), ("buffer", 1),
                                                  ("lm", 0))
                if (getattr(oa, nm) is None) != (getattr(ob, nm) is None)
                or (getattr(oa, nm) is not None and not same_bits(
                    torch, whole(getattr(oa, nm), dim),
                    whole(getattr(ob, nm), dim)))]
    if bool(a.safe) != bool(b.safe) or a.step != b.step:
        bad.append("safe or step")
    return bad


def mesh_captured(torch, hyb, hybrids, s0, date0, card, kernels) -> dict:
    """Phase 20's captured loop: run_prediction with cycles_per_dispatch =
    MESH_LOOP on each meshed hybrid of `hybrids` ((label, hybrid) pairs),
    MESH_LOOP cycles from s0 in one dispatch, against the eager meshed
    loop and the unsharded loop: the final states bit for bit, and the
    replays' launches kernel by kernel those of the eager meshed loop
    (every counter set to 0 before each run, read after).  Then ms a
    cycle (median of MESH_TIMED runs), device busy, the idle share, device
    launches and host CUDA calls a cycle (one profiled run).  Returns
    {label: (ms, busy, device launches, host calls)} a cycle."""
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    n = MESH_LOOP
    ref, _ = run_prediction(hyb, s0, date0, n)
    out = {}
    for label, h in hybrids:
        st = h.shard_state(s0)
        counts, finals = {}, {}
        for K in (1, n):
            torch.cuda.synchronize()
            for w in kernels.values():
                w.launches = 0
            fin, dates = run_prediction(h, st, date0, n,
                                        cycles_per_dispatch=K)
            torch.cuda.synchronize()
            if len(dates) != n:
                fail(f"phase 20: the {label} loop (K = {K}) stopped after "
                     f"{len(dates)} cycles")
            counts[K] = {nm: w.launches for nm, w in kernels.items()}
            finals[K] = fin
        for K, what in ((1, "eager meshed"), (n, "captured meshed")):
            bad = same_hybrid_states(torch, ref, finals[K])
            if bad:
                fail(f"phase 20: the {label} {what} loop's final state "
                     f"differs from the unsharded loop's: {', '.join(bad)}")
        if counts[n] != counts[1]:
            fail(f"phase 20: the {label} replays' launches differ from the "
                 f"eager meshed loop's: " + ", ".join(
                     f"{nm} {counts[n][nm]}/{counts[1][nm]}"
                     for nm in kernels if counts[n][nm] != counts[1][nm]))
        run = lambda h=h, st=st: run_prediction(h, st, date0, n,
                                                cycles_per_dispatch=n)
        walls = []
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n * 1e3)
        walls.sort()
        busy, kk, prof = profile_device(torch, run, reps=1, ranges=True)
        host = sum(e.count for e in prof.key_averages()
                   if e.key in HOST_LAUNCH_API) / n
        n_dev = sum(e.count for e in kk) / n
        ms = walls[len(walls) // 2]
        out[label] = (ms, busy / n, n_dev, host)
        log(f"phase 20 captured loop, {label}: {n} cycles in one dispatch "
            f"bit for bit the eager meshed loop and the unsharded loop "
            f"(final states), the replays' launches the eager loop's kernel "
            f"by kernel; {ms:.4f} ms a cycle median (min {walls[0]:.4f}, "
            f"max {walls[-1]:.4f}) over {MESH_TIMED} runs, device busy "
            f"{busy / n:.4f} ms a cycle, idle share {1 - busy / n / ms:.1%}, "
            f"{n_dev:g} device launches and {host:g} host CUDA calls a "
            f"cycle [{card}]")
    return out


def mesh_ocean(torch, np, gcm, hyb, mesh, date0, card):
    """Phase 20's slab ocean on a mesh: phase 17's coupled hybrid with
    seeded slab-ocean packs (OCEAN_HYPER's size) on the continents, at
    SLAB_STRIDE MESH_SLAB_STRIDE, on the mesh with the GCM whole and
    sharded: MESH_SLAB_STRIDE + 1 cycles (a slab step at step
    MESH_SLAB_STRIDE - 1) each bit for bit the unsharded cycle (the
    fields, the new SST grid, the ocean's states), the captured meshed
    loop bit for bit the eager one; busy and launches of a slab-step
    cycle and of the cycle before, unsharded and meshed."""
    import copy
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import (HybridAtmosphere,
                                                  ocean_snapshot)
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.kernels.surface_forcing import tisr_plane
    dev, f32 = hyb.device, torch.float32
    g = gcm.geom
    sst0 = sst_month0(g)
    gcm_l = GCM(g, dtype=f32, bd=continents_bd(torch, np, gcm.bd, g),
                      device=dev)
    land = (gcm_l.bd.fmask_l >= 1.0 / 3.0).to(f32)
    h = HybridAtmosphere(
        gcm_l, hyb.layout, hyb.packs, ml_only=False,
        ocean_packs=seeded_ocean_packs(torch, hyb, SEED + 23),
        base_sst=torch.as_tensor(sst0, dtype=f32, device=dev),
        sea_mask=land, device=dev)
    h.SLAB_STRIDE = MESH_SLAB_STRIDE
    meshed = []
    for sg in (False, True):
        hm = copy.copy(h)
        hm.set_mesh(mesh, shard_gcm=sg)
        meshed.append(("sharded GCM" if sg else "sharded", hm))
    n = MESH_SLAB_STRIDE + 1
    slab = MESH_SLAB_STRIDE - 1          # the slab step's cycle
    s0 = h.init_state(sst0)
    dates = [date0.advance_hours(6 * i) for i in range(n)]
    arg = lambda d: (d.month - 1, d.tmonth, d.tyear)
    a, diags, before = ocean_snapshot(s0), [], {}
    for i, d in enumerate(dates):
        if i in (slab - 1, slab):
            before[i] = ocean_snapshot(a)
        a, da = h.cycle(a, *arg(d))
        diags.append(da)
    if same_bits(torch, a.sst_grid, s0.sst_grid):
        fail("phase 20: the slab step left the SST grid as it was")
    for label, hm in meshed:
        b = hm.shard_state(ocean_snapshot(s0))
        for i, d in enumerate(dates):
            b, db = hm.cycle(b, *arg(d))
            for k in ("atmo", "logp", "precip", "speedy_atmo",
                      "speedy_logp"):
                if not same_bits(torch, diags[i][k], db[k]):
                    fail(f"phase 20: the slab ocean's {label} cycle {i}: "
                         f"{k} differs from the unsharded")
        bad = same_hybrid_states(torch, a, b)
        if bad:
            fail(f"phase 20: the slab ocean's {label} state after the slab "
                 f"step differs from the unsharded: {', '.join(bad)}")
        st = hm.shard_state(ocean_snapshot(s0))
        fin_e, _ = run_prediction(hm, ocean_snapshot(st), date0, n)
        fin_c, _ = run_prediction(hm, ocean_snapshot(st), date0, n,
                                  cycles_per_dispatch=n)
        torch.cuda.synchronize()
        bad = same_hybrid_states(torch, fin_e, fin_c)
        if bad:
            fail(f"phase 20: the slab ocean's {label} captured loop differs "
                 f"from the eager one: {', '.join(bad)}")
    log(f"phase 20 slab ocean: {n} cycles at SLAB_STRIDE {MESH_SLAB_STRIDE} "
        f"(the slab step at step {slab}) with the GCM whole and sharded, "
        f"each cycle bit for bit the unsharded (the fields, the new SST "
        f"grid, every class's and the ocean's states, the rings sharded by "
        f"regions); the captured meshed loop of {n} bit for bit the eager")
    pad = lambda: [tisr_plane(dates[0].tyear, hyb._slat, hyb._clat, g.nlon)
                   for _ in range(MESH_PAD)]
    for label, hh in (("unsharded", h),) + tuple(meshed):
        per = {}
        for i in (slab - 1, slab):
            st = before[i] if hh is h else hh.shard_state(before[i])
            fn = lambda hh=hh, st=st, d=dates[i]: (pad(), hh.cycle(
                ocean_snapshot(st), *arg(d)))
            fn()
            _, kk, _ = profile_device(torch, fn, reps=2)
            kk = [e for e in kk if kernel_name(e.key) != "tisr_kernel"]
            per[i] = (sum(_self_device_us(e) for e in kk) / 2e3,
                      sum(e.count for e in kk) / 2)
        (b0, l0), (b1, l1) = per[slab - 1], per[slab]
        log(f"phase 20 slab ocean profile, {label}: the slab-step cycle "
            f"busy {b1:.4f} ms, {l1:g} device launches; the cycle before "
            f"{b0:.4f} ms, {l0:g} (the ring's snapshot copies included) "
            f"[{card}]")


def mesh_cgrate_rdf(torch, np, gcm, mesh, date0, card, record,
                    spec) -> dict:
    """Phase 20's cgrate and RDF on a mesh: a T30 float32 GCM with cgrate
    on and RDF (init_randfh(RDF_SEED)), whole and on the mesh, from the
    spectral state `spec` (the main path's injection: it has eddies, so
    that cgrate has something to damp): stepone and
    MESH_CG_STEPS leapfrog steps bit for bit (the spectral state, the flux
    sums, the radiation carry with randfv), with K26's rows and range
    forms and K25's sums and band forms launched D times a physics step
    (the sums on a shortwave step) and the whole K25 and K26 never; then
    each form on every shard against the whole kernel's range or band
    (bit for bit) and its plain version on the same inputs (K26 on a
    tendency grown until it damps), shard 1's timed and recorded.
    Returns each form's launches in the window, by MESH_FORMS name."""
    import copy
    from speedy_ml_tpu_torch.dycore.state import SpectralState
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.kernels import cgrate as k26
    from speedy_ml_tpu_torch.kernels import rdf as k25
    from speedy_ml_tpu_torch.parallel.mesh import band_rows
    from speedy_ml_tpu_torch.physics.randfor import init_randfh
    dev, f32 = gcm.device, torch.float32
    g = gcm.geom
    K, nlat, nlon, mx, nx = g.nlev, g.nlat, g.nlon, g.mx, g.nx
    D = mesh.size
    gw = GCM(g, dtype=f32, bd=gcm.bd, nsteps_day=gcm.nsteps_day,
                   cgrate_on=True, device=dev)
    gw.phys.randfh = init_randfh(RDF_SEED, g, gw.sht)
    gm = copy.copy(gw)
    gm.set_mesh(mesh)
    grid = gm.grid
    s0, f = gw.init_state(date0, spectral=spec)
    a = gw.run_window(gw.stepone(s0, f), f, MESH_CG_STEPS)
    forms = {"K25_rdf_sums": k25.rdf_sums, "K25_rdf_band": k25.rdf_band,
             "K26_cgrate_rows": k26.cgrate_rows,
             "K26_cgrate_range": k26.cgrate_range}
    torch.cuda.synchronize()
    for w in list(forms.values()) + [k25.rdf, k26.cgrate]:
        w.launches = 0
    b = gm.gather_state(gm.run_window(gm.stepone(s0, f), f, MESH_CG_STEPS))
    torch.cuda.synchronize()
    launches = {nm: w.launches for nm, w in forms.items()}
    for k in SpectralState.FIELDS:
        if not same_bits(torch, getattr(a.spectral, k),
                         getattr(b.spectral, k)):
            fail(f"phase 20: the meshed window with cgrate and RDF: {k} "
                 f"differs from the unsharded")
    for obj in ("fluxes", "radiation"):
        for fl in dataclasses.fields(getattr(a, obj)):
            if not same_bits(torch, getattr(getattr(a, obj), fl.name),
                             getattr(getattr(b, obj), fl.name)):
                fail(f"phase 20: the meshed window with cgrate and RDF: "
                     f"{obj}.{fl.name} differs from the unsharded")
    steps = 2 + MESH_CG_STEPS
    sw = 2 + len(range(0, MESH_CG_STEPS, 3))
    want = {"K25_rdf_sums": D * sw, "K25_rdf_band": D * steps,
            "K26_cgrate_rows": D * steps, "K26_cgrate_range": D * steps}
    if launches != want or k25.rdf.launches or k26.cgrate.launches:
        fail(f"phase 20: the meshed window launched {launches} (whole K25 "
             f"{k25.rdf.launches}, K26 {k26.cgrate.launches}), {want} and "
             f"no whole K25 or K26 expected")
    if not float(b.radiation.randfv.abs().max()) > 0:
        fail("phase 20: RDF left randfv zero in the meshed window")
    log(f"phase 20 cgrate and RDF: stepone and {MESH_CG_STEPS} leapfrog steps "
        f"on {D} shards bit for bit the unsharded window (the spectral "
        f"state, the flux sums, the radiation carry, randfv max "
        f"{float(b.radiation.randfv.abs().max()):.3e}); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    # the forms on every shard, from the window's state
    st = gw.stepone(s0, f).spectral
    dyn = gw.dyn
    grown = lambda t, c: torch.stack([c * t[0], torch.zeros_like(t[0])])
    out = dataclasses.replace(st, vor=grown(st.vor, 1e-3),
                              div=grown(st.div, 1e-4))
    clone = lambda o: dataclasses.replace(o, vor=o.vor.clone(),
                                          div=o.div.clone())
    whole26 = k26.cgrate(dyn, st, clone(out), 2, dyn.delt2, dyn.rob)
    _, cd = k26.damp_plain(st.vor[0], out.vor[0], dyn.sht.elm2)
    if not float(cd) > 0:
        fail("phase 20: cgrate's trigger did not fire on the grown tendency")
    rng = lambda s, m0, m1: dataclasses.replace(s, **{
        k: getattr(s, k)[..., m0:m1, :].contiguous()
        for k in SpectralState.FIELDS})
    worst = dict.fromkeys(launches, 0.0)
    parts = [(rng(st, *r), rng(out, *r)) for r in grid.ranges]
    rows = [k26.cgrate_rows(dv, s_, o_)
            for dv, (s_, o_) in zip(gm.sdyn.dyns, parts)]
    rows_all = grid.all_ranges(rows, dim=-1)
    cplx = lambda t: torch.view_as_real(t)
    for d, (dv, (s_, o_), r) in enumerate(zip(gm.sdyn.dyns, parts, rows)):
        worst["K26_cgrate_rows"] = max(worst["K26_cgrate_rows"], max_abs_diff(
            torch, r, k26.cgrate_rows_plain(dv, s_, o_)))
        pl = k26.cgrate_range_plain(dv, s_, clone(o_), rows_all[d], 2,
                                    dyn.delt2, dyn.rob)
        kr = k26.cgrate_range(dv, s_, clone(o_), rows_all[d], 2, dyn.delt2,
                              dyn.rob)
        m0, m1 = grid.ranges[d]
        for nm in ("vor", "div"):
            if not same_bits(torch, getattr(kr, nm),
                             getattr(whole26, nm)[..., m0:m1, :]):
                fail(f"phase 20: K26's forms on shard {d} differ from the "
                     f"whole kernel's range ({nm})")
            worst["K26_cgrate_range"] = max(
                worst["K26_cgrate_range"],
                max_abs_diff(torch, cplx(getattr(kr, nm)),
                             cplx(getattr(pl, nm))))
    # K25 on seeded heating at full width
    gen = torch.Generator(device=dev).manual_seed(RDF_SEED)
    rn = lambda *sh, sc=1.0: sc * torch.randn(sh, generator=gen, device=dev)
    heat = k25.RdfHeating(
        rn(K, nlat, nlon, sc=1e-5), rn(K, nlat, nlon, sc=1e-5),
        rn(K, nlat, nlon), 1.0 / (0.6 + 0.4 * torch.rand(
            (nlat, nlon), generator=gen, device=dev)),
        gw.phys.pbl_tabs.grdscp, gw.phys.rdf_w)
    tt, v_in = rn(K, nlat, nlon, sc=1e-5), rn(2, nlat, K, sc=1e-5)
    h = gw.phys.randfh
    kt, kv = k25.rdf(tt.clone(), h, v_in, heat)
    kt_o, _ = k25.rdf(tt.clone(), h, v_in)
    bx = [k25.RdfHeating(*(band_rows(t, bd, nlat).contiguous()
                           if t.dim() >= 2 and t.shape[-2] == nlat else t
                           for t in heat)) for bd in grid.bands]
    sums = [k25.rdf_sums(x) for x in bx]
    worst["K25_rdf_sums"] = max(max_abs_diff(torch, s_, k25.rdf_sums_plain(x))
                                for s_, x in zip(sums, bx))
    sums_all = grid.all_bands(sums, dim=-1)
    tb, tb_o = [], []
    for d, bd in enumerate(grid.bands):
        t_d = band_rows(tt, bd, nlat).contiguous()
        h_d = band_rows(h, bd, nlat).contiguous()
        pt, pv = k25.rdf_band_plain(t_d.clone(), h_d, v_in, bd, sums_all[d])
        ktd, kvd = k25.rdf_band(t_d.clone(), h_d, v_in, bd, sums_all[d])
        kto, _ = k25.rdf_band(t_d.clone(), h_d, v_in, bd)
        if not (same_bits(torch, kvd, kv)):
            fail(f"phase 20: K25's band form on shard {d}: randfv differs "
                 f"from the whole kernel's")
        worst["K25_rdf_band"] = max(worst["K25_rdf_band"],
                                    max_abs_diff(torch, ktd, pt),
                                    max_abs_diff(torch, kvd, pv))
        tb.append(ktd)
        tb_o.append(kto)
    if not (same_bits(torch, grid.join_bands(tb), kt)
            and same_bits(torch, grid.join_bands(tb_o), kt_o)):
        fail("phase 20: K25's band forms joined differ from the whole "
             "kernel's tendency")
    log("phase 20 forms of K25 and K26: on every shard the sums, band, rows "
        "and range forms bit for bit the whole kernels' bands and ranges "
        "(K26 where it damps, cd "
        f"{float(cd):.3e}); against the plain versions: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    # shard 1's forms timed, with the bounds of their own work
    dv, (s1, o1) = gm.sdyn.dyns[1], parts[1]
    mr = grid.ranges[1][1] - grid.ranges[1][0]
    Rb = 2 * (grid.bands[1][1] - grid.bands[1][0])
    bd1 = grid.bands[1]
    t1 = band_rows(tt, bd1, nlat).contiguous()
    h1 = band_rows(h, bd1, nlat).contiguous()
    rg = (dv, s1, clone(o1), rows_all[1], 2, dyn.delt2, dyn.rob)
    src25 = "speedy_ml_tpu_torch/kernels/csrc/rdf.cu"
    src26 = "speedy_ml_tpu_torch/kernels/csrc/cgrate.cu"
    rep25, rep26 = ("speedy_ml_tpu/physics/randfor.py:83",
                    "speedy_ml_tpu/dycore/model.py:565")
    ok = True
    ok &= record("K25_rdf_sums", src25, rep25, worst["K25_rdf_sums"], 0.0,
                 measure_median(torch, lambda: k25.rdf_sums(bx[1]))[0],
                 measure(torch, lambda: k25.rdf_sums_plain(bx[1])),
                 bound_ms(4 * (3 * K * Rb * nlon + Rb * nlon + 3 * K
                               + 2 * K * Rb), 6 * K * Rb * nlon, PEAK_F32_S))
    ok &= record("K25_rdf_band", src25, rep25, worst["K25_rdf_band"], 0.0,
                 measure_median(torch, lambda: k25.rdf_band(
                     t1, h1, v_in, bd1, sums_all[1]))[0],
                 measure(torch, lambda: k25.rdf_band_plain(
                     t1, h1, v_in, bd1, sums_all[1])),
                 bound_ms(4 * (2 * K * nlat + 2 * K * Rb * nlon
                               + 2 * Rb * nlon + 2 * nlat * K),
                          4 * K * Rb * nlon + 32 * nlat * K, PEAK_F32_S))
    ok &= record("K26_cgrate_rows", src26, rep26, worst["K26_cgrate_rows"],
                 0.0, measure_median(torch, lambda: k26.cgrate_rows(
                     dv, s1, o1))[0],
                 measure(torch, lambda: k26.cgrate_rows_plain(dv, s1, o1)),
                 bound_ms(4 * (2 * 2 * 2 * K * mr * nx + mr * nx
                               + 4 * K * mr), 2 * 12 * K * mr * nx,
                          PEAK_F32_S))
    ok &= record("K26_cgrate_range", src26, rep26,
                 worst["K26_cgrate_range"], 0.0,
                 measure_median(torch, lambda: k26.cgrate_range(*rg))[0],
                 measure(torch, lambda: k26.cgrate_range_plain(
                     dv, s1, clone(o1), rows_all[1], 2, dyn.delt2,
                     dyn.rob)),
                 bound_ms(4 * (4 * K * mx + 2 * 2 * 3 * K * mr * nx + mr * nx
                               + 2 * 2 * 2 * K * mr * nx),
                          2 * 2 * 14 * K * mr * nx, PEAK_F32_S))
    if not ok:
        fail("phase 20: a form of K25 or K26 is outside its tolerance "
             "against its plain version")
    return launches


def mesh_of(torch, D: int):
    """D shards: on D cards where they are visible, else all on cuda:0."""
    from speedy_ml_tpu_torch.parallel.mesh import Mesh, make_mesh
    if torch.cuda.device_count() >= D:
        return make_mesh(D)
    return Mesh([torch.device("cuda", 0)] * D)


def port_kernels() -> dict:
    """Every kernel's wrapper, by its name in the kernels line (K14 and
    the forms apart)."""
    from speedy_ml_tpu_torch.kernels import cgrate as k26
    from speedy_ml_tpu_torch.kernels import column_longwave as clw
    from speedy_ml_tpu_torch.kernels import rdf as k25
    from speedy_ml_tpu_torch.kernels import sppt as k24
    from speedy_ml_tpu_torch.kernels import surface_forcing as sfc_forcing
    from speedy_ml_tpu_torch.kernels.column_moist import (column_moist,
                                                          moist_shortwave)
    from speedy_ml_tpu_torch.kernels.column_pbl import column_pbl, pbl_flux
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.kernels.gate_check import gate_check
    from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
    from speedy_ml_tpu_torch.kernels.inject_spectral import inject_synthesis
    from speedy_ml_tpu_torch.kernels.readout import readout
    from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis
    from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis
    from speedy_ml_tpu_torch.kernels.slab_couple import slab_couple
    from speedy_ml_tpu_torch.kernels.slab_ocean import slab_ocean
    from speedy_ml_tpu_torch.kernels.spectral_stack import spectral_stack
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
    from speedy_ml_tpu_torch.kernels.sst_by_date import sst_by_date
    from speedy_ml_tpu_torch.kernels.window_gather import window_gather
    from speedy_ml_tpu_torch.kernels.window_select import window_select
    return {"K1_esn_step": esn_step, "K2_readout_scatter": readout,
            "K3_window_gather": window_gather,
            "K5_sht_analysis": sht_analysis,
            "K6_sht_synthesis": sht_synthesis,
            "K7_grid_dynamics": grid_dynamics,
            "K8_spectral_tail": spectral_tail,
            "K9_column_moist": column_moist,
            "K9_moist_shortwave": moist_shortwave,
            "K10a_down_surface": clw.down_surface,
            "K10b_radlw_up": clw.radlw_up,
            "K12_column_pbl": column_pbl,
            "K12_pbl_flux": pbl_flux,
            "K15_spectral_stack": spectral_stack,
            "K17_surface_forcing": sfc_forcing.surface_forcing,
            "K17b_tisr_plane": sfc_forcing.tisr_plane,
            "K6_inject_synthesis": inject_synthesis,
            "K19_gate_check": gate_check,
            "K20_window_select": window_select,
            "K21_slab_couple": slab_couple,
            "K22_slab_ocean": slab_ocean,
            "K23_sst_by_date": sst_by_date,
            "K24_sppt": k24.counter, "K25_rdf": k25.rdf,
            "K26_cgrate": k26.cgrate}


def phase_cli(torch, np, card, kernels, work: Path) -> dict:
    """Phase 18: the config-driven entry point at full width.  A RunConfig
    with its own defaults (T30L8, 1,152 regions, m = 6000, the slab ocean
    at m = 4000 and the persistent surface on, float32, the shift
    topology, self-contained: no era_path), cut in time only (CLI_CUTS)
    and with the atmosphere's ridge raised (CLI_BETA_RES), each change
    printed beside the default it replaces, saved as cfg.json;
    `python -m speedy_ml_tpu_torch.main run cfg.json` in a subprocess
    with no device argument: exit 0, its lines and wall s.  Then, in this
    process with every launch counter at 0, main.main(["predict",
    cfg.json]), which loads the checkpoint the subprocess wrote: the
    launches of every kernel (each of CLI_PREDICT_KERNELS at least once;
    K22 once a cycle and once more on the slab step, whose sst form
    follows K1 and K2 at the ocean's shapes), the cycles run and the
    gate's flag, the same as the subprocess's; its prediction.npz and
    time_means.npz equal to the subprocess's bit for bit; predict ms a
    cycle (run_prediction's wall over its cycles); the checkpoint's
    bytes.  The stream exported with export_prediction_netcdf and read
    back with scipy: the reference's variables at the stream's shapes,
    equal to the stream.  Returns the launches."""
    import contextlib
    import io

    from speedy_ml_tpu_torch import main as cli
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.data.netcdf_export import \
        export_prediction_netcdf
    from speedy_ml_tpu_torch.hybrid import driver

    t_phase = time.perf_counter()
    default = RunConfig()
    cfg = dataclasses.replace(
        default, **CLI_CUTS, checkpoint_path=str(work / "cli_ckpt"),
        output_path=str(work / "cli_out"),
        atmo=dataclasses.replace(default.atmo, beta_res=CLI_BETA_RES))
    changes = [f"{k} {v} (default {getattr(default, k)})"
               for k, v in CLI_CUTS.items()]
    changes.append(f"atmo.beta_res {CLI_BETA_RES} (default "
                   f"{default.atmo.beta_res})")
    cfg_path = work / "cfg.json"
    cfg.save(str(cfg_path))
    g = cfg.geometry()
    slab_stride = max(1, cfg.timestep_slab_hours // cfg.timestep_hours)
    n_cycles = cfg.prediction_hours // cfg.timestep_hours
    log(f"CLI config: RunConfig defaults, T{g.trunc}L{g.nlev} "
        f"{g.nlat}x{g.nlon}, {cfg.n_regions} regions, atmosphere m="
        f"{cfg.atmo.m}, ocean m={cfg.ocean.m}, slab_ocean {cfg.slab_ocean} "
        f"(a slab step every {slab_stride} cycles), persist_surface "
        f"{cfg.persist_surface}, {cfg.dtype}, topology {cfg.topology}, "
        f"nsteps_day {cfg.nsteps_day}, self-contained (era_path "
        f"{cfg.era_path}); changed: " + "; ".join(changes))

    # -- 18a. `main run` in a subprocess, on the card by default
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "speedy_ml_tpu_torch.main", "run",
         str(cfg_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    wall_run = time.perf_counter() - t0
    for line in out.stdout.strip().splitlines():
        log(f"  main run: {line}")
    if out.returncode != 0:
        fail(f"python -m speedy_ml_tpu_torch.main run exited "
             f"{out.returncode}: {out.stderr.strip()[-2000:]}")
    said = re.findall(r"^(\d+) cycles -> .*\(safe=(True|False)\)$",
                      out.stdout, re.M)
    if len(said) != 1:
        fail(f"main run printed no prediction line: {out.stdout[-500:]}")
    ck_bytes = dir_bytes(cfg.checkpoint_path)
    log(f"main run: exit 0 in {wall_run:.1f} s wall (the process's start, "
        f"the nature run, the forecasts, the atmosphere's and the ocean's "
        f"training, the checkpoint, the sync window and {n_cycles} "
        f"cycles), checkpoint {ck_bytes / 1e9:.3f} GB [{card}]")
    run_dir = work / "cli_run"
    Path(cfg.output_path).rename(run_dir)

    # -- 18b. `main predict` in this process from that checkpoint
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    timed = {}
    real_run = driver.run_prediction

    def run_prediction(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_run(*a, **kw)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t
        timed["cycles"] = len(res[1])
        return res

    printed = io.StringIO()
    driver.run_prediction = run_prediction
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["predict", str(cfg_path)])
    finally:
        driver.run_prediction = real_run
    torch.cuda.synchronize()
    wall_predict = time.perf_counter() - t0
    counts = {nm: fn.launches for nm, fn in kernels.items()}
    for line in printed.getvalue().strip().splitlines():
        log(f"  main predict: {line}")
    if rc != 0:
        fail(f"main.main(['predict', cfg.json]) returned {rc}")
    mine = re.findall(r"^(\d+) cycles -> .*\(safe=(True|False)\)$",
                      printed.getvalue(), re.M)
    if mine != said:
        fail(f"main predict ran {mine}, main run {said} (cycles, safe)")
    cycles, safe = int(said[0][0]), said[0][1] == "True"
    slab_steps = sum(1 for i in range(cycles)
                     if i % slab_stride == slab_stride - 1)
    log(f"main predict: {cycles} cycles of {n_cycles}, safe={safe} (main "
        f"run: the same); {wall_predict:.1f} s wall with the checkpoint's "
        f"load and the sync window; run_prediction {timed['s']:.3f} s, "
        f"{timed['s'] / max(timed['cycles'], 1) * 1e3:.2f} ms a cycle with "
        f"the writer and the time means [{card}]")
    log(f"main predict launches: " + ", ".join(
        f"{nm} {c}" for nm, c in counts.items()))
    for nm in CLI_PREDICT_KERNELS:
        if counts[nm] <= 0:
            fail(f"{nm} was not launched by main predict")
    if slab_steps < 1:
        fail(f"main predict stopped after {cycles} cycles, before the "
             f"slab step (every {slab_stride})")
    if counts["K22_slab_ocean"] != cycles + slab_steps:
        fail(f"K22 launched {counts['K22_slab_ocean']} times in {cycles} "
             f"cycles with {slab_steps} slab step(s), not "
             f"{cycles + slab_steps}")

    # -- 18c. the two runs' streams, bit for bit
    for name in ("prediction.npz", "time_means.npz"):
        a = np.load(run_dir / name)
        b = np.load(Path(cfg.output_path) / name)
        if sorted(a.files) != sorted(b.files):
            fail(f"{name}: main run wrote {sorted(a.files)}, main predict "
                 f"{sorted(b.files)}")
        for k in a.files:
            if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                fail(f"{name} {k}: main predict's differs from main run's")
    z = np.load(Path(cfg.output_path) / "prediction.npz")
    want = {"atmo": (cycles, 4, g.nlev, g.nlat, g.nlon),
            "logp": (cycles, g.nlat, g.nlon),
            "precip": (cycles, g.nlat, g.nlon),
            "sst": (cycles, g.nlat, g.nlon)}
    got = {k: z[k].shape for k in z.files}
    if got != want:
        fail(f"prediction stream shapes {got}, expected {want}")
    for k in z.files:
        if not np.isfinite(z[k]).all():
            fail(f"the CLI's prediction field {k} is not finite")
    t_field = z["atmo"][:, 0]
    log(f"main run and main predict: prediction.npz and time_means.npz "
        f"equal bit for bit; stream finite, T {t_field.min():.3f}.."
        f"{t_field.max():.3f} K, SST {z['sst'].min():.3f}.."
        f"{z['sst'].max():.3f} K")

    # -- 18d. the NetCDF export, read back
    from scipy.io import netcdf_file
    nc = work / "cli_prediction.nc"
    t0 = time.perf_counter()
    export_prediction_netcdf(str(Path(cfg.output_path) / "prediction.npz"),
                             str(nc))
    t_nc = time.perf_counter() - t0
    shapes = {"Temperature": want["atmo"][:1] + want["atmo"][2:],
              "logp": want["logp"], "p6hr": want["precip"],
              "SST": want["sst"], "Lat": (g.nlat,), "Lon": (g.nlon,),
              "Sigma_Level": (g.nlev,)}
    for nm in ("U-wind", "V-wind", "Specific-Humidity"):
        shapes[nm] = shapes["Temperature"]
    with netcdf_file(str(nc), "r", mmap=False) as f:
        got = {k: tuple(v.shape) for k, v in f.variables.items()}
        if got != shapes:
            fail(f"the NetCDF export holds {got}, expected {shapes}")
        same = (np.array_equal(f.variables["Temperature"][:],
                               z["atmo"][:, 0])
                and np.array_equal(f.variables["SST"][:], z["sst"])
                and np.array_equal(f.variables["p6hr"][:],
                                   z["precip"] * np.float32(21600.0)))
        lat = f.variables["Lat"][:]
    if not same:
        fail("the NetCDF export's values differ from the stream's")
    if not np.array_equal(lat, np.rad2deg(g.lat_radians).astype(np.float32)):
        fail("the NetCDF export's latitudes are not the grid's")
    log(f"NetCDF export: {nc.stat().st_size / 1e6:.1f} MB in {t_nc:.2f} s, "
        f"read back with scipy: {len(shapes)} variables at the stream's "
        f"shapes, Temperature, SST and p6hr equal to the stream")
    shutil.rmtree(cfg.checkpoint_path, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def tree_state(root: Path) -> dict:
    """path -> (size, mtime) of every file under root, Python's bytecode
    caches left out."""
    return {str(f): (f.stat().st_size, f.stat().st_mtime_ns)
            for f in root.rglob("*")
            if f.is_file() and "__pycache__" not in f.parts}


def phase_experiments(torch, np, card, kernels, work: Path):
    """Phase 19: the experiment programs at full width.  The climate run
    (run_climate: stages A-E, the figures left out, since the card's
    machine has no matplotlib) and both arms of the skill experiment
    (skill_arm, shift then random, on the same twin cache) in the
    scripts' own configuration cut in time only (EXP_*), each change
    printed beside the default it replaces, in work/experiments.  Fails
    unless every stage's files are there, the result has the script's
    keys (CLIMATE_KEYS) with every number finite (the Nino-3.4 peak may be
    None: 30 days hold no 2-7-year band), a second run_climate on the
    directory runs no stage and returns the same result, no ".atmo"
    checkpoint is left, both arms' RMSE are finite, the random arm
    launched K1 and K14, and no file outside the work directory was
    written or changed.  Prints the wall s of each stage and of each
    arm's training and evaluation, stage C's ms a cycle (run_prediction's
    wall over its cycles), simulated years a day, cycles and gate flag,
    stage D's s a simulated day, each arm's hybrid/SPEEDY T-RMSE at days
    1, 3, 7 and 14 (the mean over its ICs), the peak host RSS."""
    from speedy_ml_tpu_torch.experiments import climate_run as cr
    from speedy_ml_tpu_torch.experiments import skill_experiment as se
    from speedy_ml_tpu_torch.experiments.twin import (rss_pct,
                                                      twin_cache_path,
                                                      twin_data, twin_setup)
    from speedy_ml_tpu_torch.hybrid import chunked, driver
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update

    t_phase = time.perf_counter()
    default = cr.ClimateConfig()
    cfg = dataclasses.replace(default, n=EXP_N, **(
        {} if EXP_BETA is None else dict(atmo_beta=EXP_BETA)))
    skill_beta = 0.05 if EXP_BETA is None else EXP_BETA
    ridge = ("the scripts' ridges (atmo_beta 0.05, the skill arms' "
             "beta_res 0.05)" if EXP_BETA is None else
             f"atmo_beta and the skill arms' beta_res {EXP_BETA} (the "
             f"scripts' 0.05: at 0.05 a stage aborted on a non-finite "
             f"readout)")
    log(f"experiments config: {ridge}; the scripts' own otherwise: T30L8 "
        f"48x96, 1,152 regions, float32, the synthetic boundaries and the "
        f"imperfect model (+3 K SST and land, albedo x2), m {cfg.m}, a "
        f"30-day spin-up, the slab ocean at ridge {cfg.ocean_beta}, region "
        f"chunk {cfg.rchunk}, dispatch {cfg.dispatch}, topology shift for "
        f"the climate run, the skill arms shift and random at "
        f"{se.N_IC} ICs x {se.NCYC} cycles; cut in time only: n {EXP_N} "
        f"(default {default.n}), stage C {EXP_CYCLES} cycles (default "
        f"{default.years} years, {default.years * cr.SPY}), stage D "
        f"{EXP_BASE_DAYS} days (default {default.years * 365}), the "
        f"climatologies' year {EXP_SPY} samples (default {cr.SPY})")
    out = work / "experiments"
    before = tree_state(ROOT)
    walls = {}

    def timed(mod, name, key):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                res = real(*a, **kw)
            finally:
                torch.cuda.synchronize()
                walls[key] = walls.get(key, 0.0) + time.perf_counter() - t
            if key == "run_prediction":
                walls["cycles"] = len(res[1])
            return res
        return mod, name, real, wrapper

    patches = [timed(cr, "twin_data", "A"), timed(cr, "stage_training", "B"),
               timed(cr, "stage_free_run", "C"),
               timed(cr, "speedy_baseline", "D"),
               timed(cr, "climate_products", "E"),
               timed(cr, "verify_climate", "E"),
               timed(driver, "run_prediction", "run_prediction"),
               timed(chunked, "train_hybrid_production", "train")]
    for mod, name, _, wrapper in patches:
        setattr(mod, name, wrapper)
    try:
        twin = twin_setup(device=torch.device("cuda"))
        kw = dict(twin=twin, cycles=EXP_CYCLES, baseline_days=EXP_BASE_DAYS,
                  samples_per_year=EXP_SPY, figures=False,
                  log=lambda m: log(f"  climate: {m}"))
        t0 = time.perf_counter()
        res, ran = cr.run_climate(cfg, out, out / "CLIMATE_RUN.json", **kw)
        wall_climate = time.perf_counter() - t0
        stage_walls = {k: walls.get(k, 0.0) for k in "ABCDE"}
        pred = (walls["run_prediction"], walls["cycles"])
        res2, ran2 = cr.run_climate(cfg, out, out / "CLIMATE_RUN.json", **kw)

        # -- 19b. the skill arms on the same twin cache
        data = twin_data(twin.gcm_true, twin.gcm_imp, EXP_N, out,
                         source=twin.source, log=lambda m: None)
        arms = {}
        for topology in ("shift", "random"):
            for fn in kernels.values():
                fn.launches = 0
            gram_update.launches = 0
            walls.pop("train", None)
            t0 = time.perf_counter()
            arm = se.skill_arm(twin.gcm_imp, twin.layout, data.truth,
                               data.model, data.dates, n_train=EXP_N,
                               m=cfg.m, topology=topology,
                               beta_res=skill_beta,
                               log=lambda m: log(f"  skill: {m}"))
            total = time.perf_counter() - t0
            arms[topology] = (arm, walls["train"], total - walls["train"],
                              kernels["K1_esn_step"].launches,
                              gram_update.launches)
    finally:
        for mod, name, real, _ in patches:
            setattr(mod, name, real)
    peak_rss = rss_pct()

    # -- 19c. the checks
    if ran != list("ABCDE"):
        fail(f"run_climate ran stages {ran} in a new directory, not A-E")
    if ran2 or res2 != res:
        fail(f"a second run_climate ran stages {ran2} (none expected) or "
             f"returned another result")
    ckpt = out / f"hybrid_m{cfg.m}_N{cfg.n}.ckpt"
    want = [twin_cache_path(out, EXP_N, twin.source), ckpt / "meta.json",
            out / "train_meta.json", out / "hybrid_climate.part0.npz",
            out / "monthly_means.npz", out / "stage_c_done.json",
            out / "speedy_baseline.npz", out / "CLIMATE_RUN.json"]
    missing = [str(p.relative_to(out)) for p in want if not p.exists()]
    if missing:
        fail(f"the climate run left out {missing}")
    atmo = [str(p) for p in out.rglob("*") if ".atmo" in p.name]
    if atmo:
        fail(f"the atmosphere's checkpoint is still there: {atmo}")
    if tuple(res) != CLIMATE_KEYS:
        fail(f"the result's keys {list(res)} are not the script's")

    def numbers(v):
        if isinstance(v, dict):
            return [x for u in v.values() for x in numbers(u)]
        return [v] if isinstance(v, (int, float)) and \
            not isinstance(v, bool) else []

    bad = [k for k, v in res.items()
           if not all(np.isfinite(x) for x in numbers(v))
           or (v is None and k != "nino34_peak_period_years")]
    if bad:
        fail(f"the result's {bad} are not finite numbers: "
             f"{ {k: res[k] for k in bad} }")
    if json.loads((out / "CLIMATE_RUN.json").read_text()) != res:
        fail("CLIMATE_RUN.json is not the result run_climate returned")
    done = json.loads((out / "stage_c_done.json").read_text())
    if done["cycles"] != pred[1] or res["cycles"] != pred[1]:
        fail(f"stage C ran {pred[1]} cycles, its file says "
             f"{done['cycles']}, the result {res['cycles']}")

    # -- 19d. what it printed
    log(f"climate run: {wall_climate:.1f} s wall; stages " + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_walls.items())
        + f" (A: the nature run's {EXP_N + 160} samples after 30 days and "
          f"the imperfect forecasts; E: host numpy) [{card}]")
    ms = pred[0] / max(pred[1], 1) * 1e3
    log(f"stage C: {pred[1]} of {EXP_CYCLES} cycles, safe={done['safe']}, "
        f"run_prediction {pred[0]:.3f} s, {ms:.2f} ms a cycle with the "
        f"writer and the time means (cycles_per_dispatch {cfg.dispatch}), "
        f"{pred[1] / cr.SPY / (pred[0] / 86400.0):.1f} simulated years a "
        f"day [{card}]")
    log(f"stage D: {EXP_BASE_DAYS} days in {stage_walls['D']:.1f} s, "
        f"{stage_walls['D'] / EXP_BASE_DAYS:.3f} s a simulated day [{card}]")
    log(f"result: " + json.dumps({k: res[k] for k in (
        "cycles", "safe_never_tripped", "t_sfc_global_first_year",
        "t_sfc_global_last_year", "mass_drift_rel", "nino34_std",
        "climo_rms_hybrid", "climo_rms_speedy")}))
    for topology, (arm, t_train, t_eval, k1, k14) in arms.items():
        eh, es = np.array(arm["hybrid_rmse"]), np.array(arm["speedy_rmse"])
        if not (np.isfinite(eh).all() and np.isfinite(es).all()):
            fail(f"the {topology} arm's RMSE are not finite")
        log(f"skill arm {topology}: training {t_train:.1f} s, evaluation "
            f"{t_eval:.1f} s ({se.N_IC} ICs x {len(eh)} cycles); hybrid/"
            f"SPEEDY T-RMSE " + ", ".join(
                f"{nm} {eh[i]:.3f}/{es[i]:.3f} K" for nm, i in EXP_LEADS)
            + f"; K1 {k1}, K14 {k14} launches [{card}]")
    if arms["random"][3] <= 0 or arms["random"][4] <= 0:
        fail(f"the random arm launched K1 {arms['random'][3]} and K14 "
             f"{arms['random'][4]} times")
    changed = sorted(p for p, st in tree_state(ROOT).items()
                     if before.get(p) != st)
    if changed:
        fail(f"phase 19 wrote outside its work directory: {changed[:10]}")
    log(f"peak host RSS {peak_rss:.1f}% of the host's memory; nothing "
        f"written outside {work}")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's ptxas report for every kernel")
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phase 4); prints "
                         "no result line")
    ap.add_argument("--surface", action="store_true",
                    help="after the hybrids, run phase 12 (the persistent "
                         "surface and the slab coupler, K21) alone; prints "
                         "no result line")
    ap.add_argument("--ocean", action="store_true",
                    help="after the hybrids, train phase 10's atmosphere "
                         "and run phase 13 (the slab ocean, K22) alone; "
                         "prints no result line")
    ap.add_argument("--options", action="store_true",
                    help="after the hybrids, run phase 14 (the forecast's "
                         "options: the climatology tables, K23, K2's "
                         "components form, the truth streams and the time "
                         "means) alone; prints no result line")
    ap.add_argument("--vertical", action="store_true",
                    help="after the hybrids, run phase 15 (vertical "
                         "localization: the training, the localized cycles "
                         "and checkpoint) alone; prints no result line")
    ap.add_argument("--physics", action="store_true",
                    help="after the hybrids, run phase 16 (the optional "
                         "physics: SPPT, RDF and cgrate, K24-K26) alone; "
                         "prints no result line")
    ap.add_argument("--dispatch", action="store_true",
                    help="after the hybrids, run phase 17 (the batched "
                         "prediction loop: the captured cycle's replays "
                         "against the eager loop, the device-scalar forms, "
                         "cycle_ms for K = 1 and 28) alone; prints no "
                         "result line")
    ap.add_argument("--cli", action="store_true",
                    help="after the build, run phase 18 (the config-driven "
                         "entry point at full width: main run in a "
                         "subprocess, main predict from its checkpoint, "
                         "the NetCDF export) alone; prints no result line")
    ap.add_argument("--experiments", action="store_true",
                    help="after the build, run phase 19 (the experiment "
                         "programs: the climate run's stages and both skill "
                         "arms at full width, cut in time) alone; prints no "
                         "result line")
    ap.add_argument("--mesh", action="store_true",
                    help="after the hybrids, run phase 20 (the hub-free "
                         "sharded cycle on 4 shards against the unsharded "
                         "one, bit for bit; the sharded training step) "
                         "alone; prints no result line")
    ap.add_argument("--train-full", action="store_true",
                    help="after the build, run the full training pass "
                         "(parallel/train_dryrun.py train_full: every "
                         "region at m = 6000 and a slab-ocean chunk at m = "
                         "4000) on phase 20's mesh alone and print its "
                         "result as JSON; prints no result line")
    ap.add_argument("--k14-lists", action="store_true",
                    help="time K14's two tile lists at several chunk "
                         "lengths and its two launches apart, then stop; "
                         "prints no result line")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if not (ROOT / "speedy_ml_tpu_torch" / "__init__.py").exists():
        fail(f"the speedy_ml_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.core.spectral import shift_left, shift_right
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    from speedy_ml_tpu_torch.dycore.state import SpectralState
    from speedy_ml_tpu_torch.gcm import GCM, FluxAccumulator, GCMState
    from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu_torch.kernels import build as kb
    from speedy_ml_tpu_torch.kernels import column_longwave as clw
    from speedy_ml_tpu_torch.kernels import surface_forcing as sfc_forcing
    from speedy_ml_tpu_torch.kernels.column_moist import (
        column_moist, column_moist_plain, moist_shortwave,
        moist_shortwave_plain)
    from speedy_ml_tpu_torch.kernels.column_pbl import (column_pbl,
                                                        column_pbl_plain,
                                                        pbl_flux,
                                                        pbl_flux_plain)
    from speedy_ml_tpu_torch.kernels.column_shortwave import \
        ShortwaveForcing
    from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                          core_scatter_plain,
                                                          grid_blocks,
                                                          split_grid)
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step, esn_step_plain
    from speedy_ml_tpu_torch.kernels.flux_accumulate import \
        flux_accumulate_plain
    from speedy_ml_tpu_torch.kernels.gate_check import (GATE_BOUNDS,
                                                        gate_check,
                                                        gate_check_plain)
    from speedy_ml_tpu_torch.kernels.grid_dynamics import (
        grid_dynamics, grid_dynamics_plain)
    from speedy_ml_tpu_torch.kernels.inject_spectral import (
        inject_spectral_plain, inject_synthesis)
    from speedy_ml_tpu_torch.kernels.readout import (quad_expand, readout,
                                                     readout_plain)
    from speedy_ml_tpu_torch.kernels.slab_couple import slab_couple
    from speedy_ml_tpu_torch.kernels.slab_ocean import slab_ocean
    from speedy_ml_tpu_torch.kernels.sst_by_date import sst_by_date
    from speedy_ml_tpu_torch.kernels.readout import \
        vector_path as readout_vector_path
    from speedy_ml_tpu_torch.kernels.sht_analysis import (
        sht_analysis, sht_analysis_plain)
    from speedy_ml_tpu_torch.kernels.sht_synthesis import (
        sht_synthesis, sht_synthesis_plain)
    from speedy_ml_tpu_torch.kernels.spectral_stack import (
        dynamics_stack_plain, physics_stack_plain, spectral_stack)
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
    from speedy_ml_tpu_torch.kernels.window_gather import (
        window_gather, window_gather_plain)
    from speedy_ml_tpu_torch.kernels.window_select import (
        window_select, window_select_plain)
    from speedy_ml_tpu_torch.physics.boundaries import \
        synthetic_boundary_data
    from speedy_ml_tpu_torch.physics import radiation as rad
    from speedy_ml_tpu_torch.physics.driver import (PhysicsModel,
                                                    RadiationCarry)
    from speedy_ml_tpu_torch.physics.land_sea import (init_surface_state,
                                                      surface_state)

    t_start = time.perf_counter()
    # the full run's seconds a phase, printed before the kernels line
    phase_s, t_lap = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kb.build(verbose=args.ptxas)
    kb.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{lib_path.relative_to(ROOT)}")

    # every kernel's wrapper, by its name in the kernels line
    kernels = port_kernels()
    # phases 10 and 13 share the atmosphere's checkpoint, and phases 18
    # and 19 write their runs, in a directory removed at exit; --cli and
    # --experiments run phase 18 or 19 alone, before the hybrids of
    # phase 3
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, work, True)

    if args.train_full:
        from speedy_ml_tpu_torch.parallel.train_dryrun import train_full
        mesh = mesh_of(torch, MESH_SHARDS)
        log(f"train_full on {mesh}")
        r = train_full(mesh, log=log)
        log(json.dumps(dict(train_full=r, card=card)))
        log(f"chip_smoke --train-full: passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.cli:
        phase_cli(torch, np, card, kernels, work)
        log(f"chip_smoke --cli: phase 18 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.experiments:
        phase_experiments(torch, np, card, kernels, work)
        log(f"chip_smoke --experiments: phase 19 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return

    # -- 3. the full-width hybrids ---------------------------------------
    dev = torch.device("cuda")
    f32 = torch.float32
    g = Geometry()
    t0 = time.perf_counter()
    gcm = GCM(g, dtype=f32, bd=synthetic_boundary_data(g, dtype=f32,
                                                       device=dev),
              device=dev)
    hyb = build_untrained_hybrid(gcm, n_regions=N_REGIONS, m=M, seed=SEED,
                                 ml_only=False, radius_iters=30, device=dev)
    hyb.cast_wout_bf16()
    hyb_ml = build_untrained_hybrid(None, n_regions=N_REGIONS, m=M,
                                    seed=SEED, ml_only=True, radius_iters=30,
                                    device=dev)
    hyb_ml.cast_wout_bf16()
    torch.cuda.synchronize()
    log(f"hybrid: T{g.trunc}L{g.nlev} {g.nlat}x{g.nlon}, {N_REGIONS} "
        f"regions, m={M}, {hyb.gcm_steps} GCM steps per window; classes "
        + ", ".join(f"{p.cls.name}: R={p.cls.count} n={p.res.n} "
                    f"I={p.res.n_in} S={p.res.n_speedy} "
                    f"wout={tuple(p.res.wout.shape)} {p.res.wout.dtype}"
                    for p in hyb.packs)
        + f"; both built in {time.perf_counter() - t0:.1f} s")
    if args.k14_lists:
        big = max(hyb.packs, key=lambda p: p.cls.count)   # the interior class
        k14_lists(torch, big.res.n, big.res.n_speedy, big.res.wout.shape[1],
                  card)
        return
    sst0 = sst_month0(g)
    state0 = hyb.init_state(sst0)
    date0 = ModelDate(1990, 1, 1)
    imon, fmon, tyear = date0.month - 1, date0.tmonth, date0.tyear
    # two cycles so that x, the feedback and the local model are the main
    # path's, not zeros
    s = state0
    for _ in range(2):
        s, _ = hyb.cycle(s, imon, fmon, tyear)
    torch.cuda.synchronize()
    if not bool(s.safe):
        fail("the coupled state tripped the gate within two cycles")
    packs = hyb.packs
    nz, nlat, nlon = hyb.nz, g.nlat, g.nlon
    K = g.nlev

    # -- 4. kernels against their plain versions ------------------------
    lap("2-3 build, hybrids")
    results = {}

    def record(name, src, replaces, err, tol, kernel, plain, bound,
               library=None):
        """kernel/plain/library: (device_ms, call_ms) from measure()."""
        ok = err <= tol
        log(f"{name}: max_abs_err={err:.3e} (tolerance {tol:.3e}) "
            f"kernel_ms={kernel[0]:.4f} (call {kernel[1]:.4f}) "
            f"plain_ms={plain[0]:.4f} (call {plain[1]:.4f}) "
            f"bound_ms={bound[0]:.4f} ({bound[1]}, "
            f"{bound[0] / kernel[0]:.0%} of it)"
            + (f" library_ms={library[0]:.4f} (call {library[1]:.4f})"
               if library is not None else " library_ms=none")
            + f" [{card}]" + ("" if ok else "  <-- FAIL"))
        results[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, ms=kernel[0], plain_ms=plain[0],
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=None if library is None else library[0])
        return ok

    atmo_ckpt = str(work / "atmo")
    out_dir = ROOT / "output" / "chip_smoke"
    if args.vertical:
        phase_vertical(torch, np, gcm, hyb.layout, hyb, date0, card, kernels)
        log(f"chip_smoke --vertical: phase 15 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.mesh:
        phase_mesh(torch, np, gcm, hyb, date0, card, kernels, record)
        log(f"chip_smoke --mesh: phase 20 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.dispatch:
        phase_dispatch(torch, np, gcm, hyb, date0, card, record, kernels,
                       work)
        log(f"chip_smoke --dispatch: phase 17 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.physics:
        phase_physics(torch, np, gcm, date0, card, record, kernels)
        log(f"chip_smoke --physics: phase 16 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.options:
        phase_options(torch, np, hyb, date0, card, record, kernels, work,
                      out_dir)
        log(f"chip_smoke --options: phase 14 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.ocean:
        atmosphere_checkpoint(torch, gcm, hyb.layout, date0, atmo_ckpt,
                              card)
        phase_ocean(torch, np, gcm, hyb.layout, date0, card, record,
                    kernels, atmo_ckpt)
        log(f"chip_smoke --ocean: phase 13 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return
    if args.surface:
        phase_surface(torch, np, gcm, hyb, date0, card, record, kernels)
        log(f"chip_smoke --surface: phase 12 passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return

    ok = True
    # K1: ESN step, all classes (one launch each), plus the linear mode
    step_args = [dict(vals=p.res.vals, x=cs.x, u=cs.feedback,
                      win_vals=p.res.win_vals, shifts=p.res.shifts,
                      cols=None if p.res.shifts is not None else p.res.cols,
                      win_cols=p.res.win_cols, leakage=p.hyper.leakage)
                 for p, cs in zip(packs, s.classes)]
    err = 0.0
    for a in step_args:
        for linear in (False, True):
            k = esn_step(**a, linear=linear)
            pl = esn_step_plain(**a, linear=linear)
            err = max(err, float((k - pl).abs().max()))
    nbytes = ops = 0
    for a in step_args:
        J, R, n = a["vals"].shape
        nbytes += 4 * (J * R * n + 3 * R * n + a["u"].numel())
        ops += R * n * (2 * J + 4)
    ok &= record(
        "K1_esn_step", "speedy_ml_tpu_torch/kernels/csrc/esn_step.cu",
        "speedy_ml_tpu/esn/reservoir.py:339", err, 1e-5,
        measure(torch, lambda: [esn_step(**a) for a in step_args]),
        measure(torch, lambda: [esn_step_plain(**a) for a in step_args]),
        bound_ms(nbytes, ops, PEAK_F32_S))

    # K2: readout with bf16 Wout and the local-model block (the coupled
    # form).  The product is compared bare: the 250 K out_mean of the
    # epilogue would hide its error under its own ulp.  The negative
    # control, the product with aug not rounded to bf16 (the rounding
    # fault most likely in K2), must fail the tolerance.  The fused
    # unstandardize (explicitly rounded multiply, then add) is checked
    # apart, to one ulp.
    xs = [esn_step(**a) for a in step_args]
    ro_args = [dict(wout=p.res.wout, x=x, local_model=cs.local_model,
                    out_mean=p.std.out_mean, out_std=p.std.out_std)
               for p, x, cs in zip(packs, xs, s.classes)]
    err = scale = err_ctl = err_epi = ulp_epi = 0.0
    augs = []
    for p, a in zip(packs, ro_args):
        R, O, A = a["wout"].shape
        path = "vector" if readout_vector_path(a["wout"]) else "scalar"
        log(f"K2 class {p.cls.name}: Wout {(R, O, A)} {a['wout'].dtype}, "
            f"A mod 8 = {A % 8}: {path} path")
        if path != "vector":
            fail(f"K2 takes the scalar path for class {p.cls.name}")
        bare = dict(wout=a["wout"], x=a["x"], local_model=a["local_model"])
        k = readout(**bare)
        pl = readout_plain(**bare)
        aug = torch.cat([a["local_model"], quad_expand(a["x"])], dim=1)
        ctl = torch.einsum("roa,ra->ro", a["wout"].float(), aug)
        err = max(err, float((k - pl).abs().max()))
        err_ctl = max(err_ctl, float((ctl - pl).abs().max()))
        scale = max(scale, float(pl.abs().max()))
        ref = k * a["out_std"] + a["out_mean"]
        err_epi = max(err_epi, float((readout(**a) - ref).abs().max()))
        ulp_epi = max(ulp_epi, float(
            (torch.finfo(torch.float32).eps * ref.abs()).max()))
        augs.append(aug.to(torch.bfloat16)[:, :, None].contiguous())
    log(f"K2 negative control (aug not rounded to bf16): max_abs_err="
        f"{err_ctl:.3e} against the tolerance {K2_RTOL * scale:.3e}; "
        f"unstandardize epilogue: {err_epi:.3e} (tolerance {ulp_epi:.3e})")
    if err_ctl <= K2_RTOL * scale:
        fail("K2's tolerance does not tell a readout with unrounded aug "
             "from the right one")
    if err_epi > ulp_epi:
        fail("K2's unstandardize epilogue disagrees")
    err_k2, scale_k2 = err, scale
    k2_vec = measure(torch, lambda: [readout(**a) for a in ro_args])
    k2_bmm = measure(torch, lambda: [
        torch.bmm(a["wout"], x) for a, x in zip(ro_args, augs)])
    # each class alone beside torch.bmm
    for p, a, u in zip(packs, ro_args, augs):
        kc = measure(torch, lambda: readout(**a))
        lc = measure(torch, lambda: torch.bmm(a["wout"], u))
        R, O, A = a["wout"].shape
        bc = bound_ms(a["wout"].numel() * 2 + 4 * (R * A + 3 * R * O),
                      2 * R * O * A, PEAK_BF16_S)
        log(f"K2 class {p.cls.name}: kernel {kc[0]:.4f} ms, torch.bmm "
            f"{lc[0]:.4f} ms, bound {bc[0]:.4f} ms ({bc[0] / kc[0]:.0%} "
            f"of it) [{card}]")
    del augs
    # the ML-only form (S = 0): the ML-only hybrid's Wout on the same x
    ml_args = [dict(wout=pk.res.wout, x=x, out_mean=pk.std.out_mean,
                    out_std=pk.std.out_std)
               for pk, x in zip(hyb_ml.packs, xs)]
    worst = 0.0
    for pk, a in zip(hyb_ml.packs, ml_args):
        k, pl = readout(a["wout"], a["x"]), readout_plain(a["wout"], a["x"])
        e, sc = float((k - pl).abs().max()), float(pl.abs().max())
        worst = max(worst, e / sc)
        if e > K2_RTOL * sc or not readout_vector_path(a["wout"]):
            fail(f"K2 ML-only ({pk.cls.name}) disagrees or left the vector "
                 f"path: {e:.3e} > {K2_RTOL * sc:.3e}")
    kml = measure(torch, lambda: [readout(**a) for a in ml_args])
    log(f"K2 ML-only (S=0): {worst:.3e} of its scale, vector path for every "
        f"class, {kml[0]:.4f} ms [{card}]")

    # K2's store into the assembled grid: the core scatter with the q and
    # precip clamps (formerly K4, a launch of its own), as the cycle
    # runs it: every class of a hybrid straight into one grid (starting as
    # NaN here), coupled and ML-only.  Bit for bit the kernel's (R, O)
    # vectors then core_scatter_plain; and, on the bare product, within
    # K2_RTOL of readout_plain then core_scatter_plain, where a precip
    # value that the two sides' sums put on either side of the 1e-5
    # threshold is a near-tie: counted (and its unclamped values held to
    # the tolerance), not compared
    core_table = torch.as_tensor(hyb.layout.core_source_table(
        [p.cls for p in packs], 4, nz), device=dev)
    n_grid, q_blk, p_blk = grid_blocks(4, nz, nlat, nlon)

    def store(h, args, grid):
        for a, idx in zip(args, h.core_index):
            readout(**a, scatter=CoreScatter(grid, idx, q_blk, p_blk))
        return grid

    into_grid = lambda h, args: store(
        h, args, torch.full((n_grid,), float("nan"), device=dev))

    assemble = lambda vecs: core_scatter_plain(vecs, core_table, 4, nz,
                                               nlat, nlon)
    err_fused, near_ties = 0.0, 0
    for label, h, f_args in (("coupled", hyb, ro_args),
                             ("ML-only", hyb_ml, ml_args)):
        grid = into_grid(h, f_args)
        want = assemble([readout(**a) for a in f_args])
        if bool(grid.isnan().any()) or not all(
                torch.equal(a_, b_) for a_, b_ in zip(
                    split_grid(grid, 4, nz, nlat, nlon), want)):
            fail(f"K2's store into the grid ({label}) differs from its "
                 f"vectors then core_scatter_plain")
        bare = [{k: a[k] for k in ("wout", "x", "local_model") if k in a}
                for a in f_args]
        got = torch.cat([t.reshape(-1) for t in split_grid(
            into_grid(h, bare), 4, nz, nlat, nlon)])
        plain_vecs = [readout_plain(**b) for b in bare]
        ref = torch.cat([t.reshape(-1) for t in assemble(plain_vecs)])
        uk = torch.cat([readout(**b).reshape(-1) for b in bare])[
            core_table.long()]
        up = torch.cat([v.reshape(-1) for v in plain_vecs])[
            core_table.long()]
        tie = torch.zeros_like(uk, dtype=torch.bool)
        tie[p_blk[0]:p_blk[1]] = (uk[p_blk[0]:p_blk[1]] < 1e-5) != (
            up[p_blk[0]:p_blk[1]] < 1e-5)
        sc = max(float(v.abs().max()) for v in plain_vecs)
        e_ = max(float(torch.where(tie, 0.0, (got - ref).abs()).max()),
                 float((uk - up).abs().max())) / sc
        near_ties += int(tie.sum())
        err_fused = max(err_fused, e_)
        log(f"K2 into the grid ({label}, {len(f_args)} classes): bit for bit "
            f"its vectors then core_scatter_plain; bare product against "
            f"readout_plain then core_scatter_plain {e_:.3e} of its scale "
            f"(tolerance {K2_RTOL:.0e}), {int(tie.sum())} precip values a "
            f"near-tie of the clamp")
        if not e_ <= K2_RTOL:
            fail(f"K2's store into the grid ({label}) disagrees with "
                 f"readout_plain then core_scatter_plain")
    del ml_args
    # timed in the main path's form (into the grid, with the epilogue)
    nbytes = ops = 0
    for a in ro_args:
        R, O, A = a["wout"].shape
        nbytes += (a["wout"].numel() * a["wout"].element_size()
                   + 4 * (a["x"].numel() + a["local_model"].numel()
                          + 4 * R * O))
        ops += 2 * R * O * A
    grid_k2 = torch.empty(n_grid, device=dev)
    k2 = measure(torch, lambda: store(hyb, ro_args, grid_k2))
    log(f"K2 into the grid {k2[0]:.4f} ms, into (R, O) vectors "
        f"{k2_vec[0]:.4f} ms (three launches each) [{card}]")
    ok &= record(
        "K2_readout_scatter", "speedy_ml_tpu_torch/kernels/csrc/readout.cu",
        "speedy_ml_tpu/esn/reservoir.py:362, speedy_ml_tpu/esn/domain.py:290",
        max(err_k2 / scale_k2, err_fused), K2_RTOL, k2,
        measure(torch, lambda: assemble(
            [readout_plain(**a) for a in ro_args]), reps=3, warmup=1),
        bound_ms(nbytes, ops, PEAK_BF16_S), library=k2_bmm)
    log("  (K2_readout_scatter max_abs_err is relative to the bare "
        "product's scale)")

    # K3: window gather + standardize, one launch for all classes (the
    # feedback; build_local_model's core-only form is checked below)
    atmo, logp, precip = split_grid(into_grid(hyb, ro_args), 4, nz, nlat,
                                    nlon)
    tisr = hyb.tisr_field(tyear).contiguous()
    fields = (atmo, logp, precip, s.sst_grid, tisr)
    ga = (fields, hyb.feedback_index, [p.std.in_mean for p in packs],
          [p.std.in_std for p in packs])
    kf = window_gather(*ga)
    pf = window_gather_plain(*ga)
    err = max(float((k - p).abs().max()) for k, p in zip(kf, pf))
    ulp = max(float((torch.finfo(torch.float32).eps * p.abs()).max())
              for p in pf)
    n_out = sum(i.numel() for i in hyb.feedback_index)
    n_src = sum(f.numel() for f in fields)
    ok &= record(
        "K3_window_gather",
        "speedy_ml_tpu_torch/kernels/csrc/window_gather.cu",
        "speedy_ml_tpu/esn/domain.py:252", err, ulp,
        measure(torch, lambda: window_gather(*ga), reps=50),
        measure(torch, lambda: window_gather_plain(*ga), reps=50),
        bound_ms(4 * (4 * n_out + n_src), 2 * n_out, PEAK_F32_S))
    # K3's date form (the ML-only cycle's): each TISR element worked out
    # where it is read must equal K3 gathering K17b's plane at the same
    # tyear, bit for bit; timed beside the plane form, each the median of
    # SHT_SESSIONS sessions
    gd = ((*fields[:4], hyb.tisr_date(tyear)),) + ga[1:]
    kd = window_gather(*gd)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(kd, kf)):
        fail("K3's date form differs from K3 on K17b's TISR plane")
    (k3p_ms, _), k3p_runs = measure_median(torch,
                                           lambda: window_gather(*ga))
    (k3d_ms, _), k3d_runs = measure_median(torch,
                                           lambda: window_gather(*gd))
    fmt_runs = lambda rs: ", ".join(f"{r:.4f}" for r in rs)
    log(f"K3 date form: equal to K3 on K17b's plane (torch.equal); "
        f"{k3d_ms:.4f} ms ({fmt_runs(k3d_runs)}), plane form {k3p_ms:.4f} ms "
        f"({fmt_runs(k3p_runs)}), median of {SHT_SESSIONS} sessions [{card}]")

    # K17 and K17b: the window's entry (surface and forcing of this
    # cycle's date and SST, one launch) and the TISR plane, against their
    # plain versions on the card, float32 and float64: the same
    # operations and functions, so the same bits are expected; the
    # tolerance is K17_ULPS ulps of each plane's scale
    sht, dyn = gcm.sht, gcm.dyn
    phys = gcm.phys
    bd = gcm.bd
    f64 = torch.float64
    month = (imon, fmon)
    G, MN = nlat * nlon, g.mx * g.nx

    def k17_pair(bd_, sst_, day_):
        """(kernel planes, plain planes): surface and forcing stacked."""
        ks, kf = sfc_forcing.surface_forcing(bd_, month=month,
                                             sst_hybrid=sst_, day=day_)
        ps_ = sfc_forcing.surface_plain(bd_, *month, sst_hybrid=sst_)
        pp = dict(zip(sfc_forcing.SURFACE, ps_))
        pf = sfc_forcing.forcing_plain(bd_, pp["stl"], pp["snowd"],
                                       pp["sst_am"], pp["sice"], day_, nlon)
        return torch.cat([ks, kf]), torch.cat([ps_, pf])

    def plane_ulps(got, ref):
        """Per plane: |got - ref| max in ulps of float32 at the plane's
        scale (its largest magnitude)."""
        d = (got - ref).abs().reshape(got.shape[0], -1).amax(dim=1)
        sc = ref.abs().reshape(ref.shape[0], -1).amax(dim=1)
        return (d / (torch.finfo(f32).eps * torch.where(sc > 0, sc, 1.0))
                ).tolist()

    day32 = phys.day_args(tyear)
    slat64 = torch.as_tensor(g.sin_lat, dtype=f64, device=dev)
    clat64 = torch.as_tensor(g.cos_lat, dtype=f64, device=dev)
    day64 = sfc_forcing.DayArgs(tyear, slat64, clat64, phys.gamlat,
                                phys.pexp)
    bd64 = bd.to(dtype=f64)
    # beside the aquaplanet, a mixed land mask with sea ice, snow and
    # orography (seeded), so that every branch of K17 runs on the card
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rnd = lambda lo, hi, *lead: lo + (hi - lo) * torch.rand(
        lead + (nlat, nlon), generator=gen, device=dev)
    fm = torch.where(rnd(0, 1) < 0.4, 0.0, rnd(0, 1))
    bd_mix = dataclasses.replace(
        bd, fmask_l=fm, fmask_s=1.0 - fm, phis0=2.0e4 * fm * rnd(0, 1),
        alb0=rnd(0.1, 0.3), stl12=rnd(250, 310, 12),
        snowd12=rnd(0, 100, 12), soilw12=rnd(0, 1, 12),
        sst12=rnd(268, 305, 12),
        sice12=torch.where(rnd(0, 1, 12) < 0.5, 0.0, rnd(0, 1, 12)))
    sst_mix = bd_mix.sst12[imon] - rnd(-4, 12)
    names17 = sfc_forcing.SURFACE + sfc_forcing.FORCING
    err17, tol17 = 0.0, 0.0
    for label, bd_, sst_, day_ in (("float32", bd, s.sst_grid, day32),
                                   ("float64", bd64, s.sst_grid.double(),
                                    day64),
                                   ("float32, mixed land and sea ice",
                                    bd_mix, sst_mix, day32),
                                   ("float64, mixed land and sea ice",
                                    bd_mix.to(dtype=f64), sst_mix.double(),
                                    day64)):
        kp, pp = k17_pair(bd_, sst_, day_)
        ulps = plane_ulps(kp, pp)
        bad = {nm: u for nm, u in zip(names17, ulps) if u > 0}
        log(f"K17 {label}: {len(names17)} planes, max_abs_err="
            f"{max_abs_diff(torch, kp, pp):.3e}; planes that differ, in "
            f"ulps of float32 at their scale: {bad or 'none'} (tolerance "
            f"{K17_ULPS} ulps)")
        if max(ulps) > K17_ULPS:
            fail(f"K17 ({label}) disagrees with its plain version")
        if label == "float32":
            err17 = max_abs_diff(torch, kp, pp)
            tol17 = K17_ULPS * torch.finfo(f32).eps * float(pp.abs().max())
    # the surface alone and the forcing of a given surface: the same planes
    ks_, kf_ = sfc_forcing.surface_forcing(bd, month=month,
                                           sst_hybrid=s.sst_grid, day=day32)
    ks1, _ = sfc_forcing.surface_forcing(bd, month=month,
                                         sst_hybrid=s.sst_grid)
    _, kf1 = sfc_forcing.surface_forcing(
        bd, sfc=surface_state(ks1, gcm.cpl.icsea), day=day32)
    if not (torch.equal(ks1, ks_) and torch.equal(kf1, kf_)):
        fail("K17's surface or forcing alone differs from the two together")
    k17_call = lambda: sfc_forcing.surface_forcing(
        bd, month=month, sst_hybrid=s.sst_grid, day=day32)
    (k17_ms, k17_c), k17_runs = measure_median(torch, k17_call)
    log("K17 sessions (device ms): " + ", ".join(f"{r:.4f}"
                                                 for r in k17_runs))
    # read: the months forin5 and forint use (5 + 2 + 2 + 5 + 2 planes),
    # the hybrid SST, alb0, fmask_l, fmask_s, phis0, slat, clat; written:
    # 8 + 11 planes.  Operations: ~130 a point, and the solar terms' ~150
    # once a row
    ok &= record(
        "K17_surface_forcing",
        "speedy_ml_tpu_torch/kernels/csrc/surface_forcing.cu",
        "speedy_ml_tpu/physics/land_sea.py:191", err17, tol17,
        (k17_ms, k17_c),
        measure(torch, lambda: k17_pair(bd, s.sst_grid, day32)[1], reps=10),
        bound_ms(4 * (G * (16 + 5 + 19) + 2 * nlat), 130 * G + 150 * nlat,
                 PEAK_F32_S))
    err17b = 0.0
    for label, sl, cl in (("float32", hyb._slat, hyb._clat),
                          ("float64", slat64, clat64)):
        kt = sfc_forcing.tisr_plane(tyear, sl, cl, nlon)
        pt = sfc_forcing.tisr_plain(tyear, sl, cl, nlon)
        u = plane_ulps(kt[None], pt[None])[0]
        log(f"K17b {label}: max_abs_err={max_abs_diff(torch, kt, pt):.3e}, "
            f"{u:.3g} ulps of float32 at the plane's scale (tolerance "
            f"{K17_ULPS})")
        if u > K17_ULPS:
            fail(f"K17b ({label}) disagrees with its plain version")
        if label == "float32":
            err17b = max_abs_diff(torch, kt, pt)
            tol17b = K17_ULPS * torch.finfo(f32).eps * float(pt.abs().max())
    # the coupled cycle feeds back the fsol plane of its window's K17 as
    # the TISR field (no K17b launch): in both types it must be K17b's
    # plane at the same tyear, bit for bit
    i_fsol = sfc_forcing.FORCING.index("fsol")
    for label, bd_, sst_, day_, sl, cl in (
            ("float32", bd, s.sst_grid, day32, hyb._slat, hyb._clat),
            ("float64", bd64, s.sst_grid.double(), day64, slat64, clat64)):
        _, kf_ = sfc_forcing.surface_forcing(bd_, month=month,
                                             sst_hybrid=sst_, day=day_)
        if not torch.equal(kf_[i_fsol],
                           sfc_forcing.tisr_plane(tyear, sl, cl, nlon)):
            fail(f"K17's fsol plane ({label}) differs from K17b's TISR "
                 f"plane")
    log("K17's fsol plane equals K17b's TISR plane at the same tyear, "
        "float32 and float64")
    (k17b_ms, k17b_c), k17b_runs = measure_median(
        torch, lambda: sfc_forcing.tisr_plane(tyear, hyb._slat, hyb._clat,
                                              nlon))
    log("K17b sessions (device ms): " + ", ".join(f"{r:.4f}"
                                                  for r in k17b_runs))
    ok &= record(
        "K17b_tisr_plane",
        "speedy_ml_tpu_torch/kernels/csrc/surface_forcing.cu",
        "speedy_ml_tpu/hybrid/model.py:525", err17b, tol17b,
        (k17b_ms, k17b_c),
        measure(torch, lambda: sfc_forcing.tisr_plain(
            tyear, hyb._slat, hyb._clat, nlon), reps=20),
        bound_ms(4 * (G + 2 * nlat), 60 * G, PEAK_F32_S))

    # K6_inject: the injection's synthesis with K18's spectral glue as its
    # phase 0, on this cycle's analysed grid: the state against
    # inject_spectral_plain's, the grid against the unfused K6 launched
    # on that plain stack (tolerance 0, bit for bit)
    spec_in = sht.analysis(torch.cat([atmo[0], torch.clamp(atmo[3], min=0.0),
                                      logp[None], atmo[1], atmo[2]]),
                           2 * K + 1)
    ks6, kgrid = inject_synthesis(sht, spec_in, K)
    ps6, pstk = inject_spectral_plain(sht, spec_in, K)
    pgrid = sht.synthesis(pstk, 2 * K)
    e_state = max(max_abs_diff(torch, getattr(ks6, f), getattr(ps6, f))
                  for f in SpectralState.FIELDS)
    e_grid = max_abs_diff(torch, kgrid, pgrid)
    same = all(torch.equal(getattr(ks6, f), getattr(ps6, f))
               for f in SpectralState.FIELDS) and torch.equal(kgrid, pgrid)
    log(f"K6_inject: the state (2 levels) max_abs_err={e_state:.3e} "
        f"against inject_spectral_plain, the grid {tuple(kgrid.shape)} "
        f"{e_grid:.3e} against K6 on the plain stack (tolerance 0; "
        f"{'bit for bit' if same else 'NOT bit for bit'})")
    if not same:
        fail("K6_inject disagrees with K18's plain version then K6")
    (k6i_ms, k6i_c), k6i_runs = measure_median(
        torch, lambda: inject_synthesis(sht, spec_in, K))
    log("K6_inject sessions (device ms): " + ", ".join(f"{r:.4f}"
                                                       for r in k6i_runs))
    # read: K5's 4K + 1 fields, the tables, K6's Legendre rows, dft_inv
    # and cosgr; written: the state's 2 (4K + 1) fields and the grid's 4K
    # planes.  Operations: K18's ~40 K a coefficient and K6's at 4K fields
    iy = g.nlat_half
    ok &= record(
        "K6_inject_synthesis",
        "speedy_ml_tpu_torch/kernels/csrc/sht_synthesis.cu",
        "speedy_ml_tpu/hybrid/model.py:404", max(e_state, e_grid), 0.0,
        (k6i_ms, k6i_c),
        measure(torch, lambda: sht_synthesis_plain(
            inject_spectral_plain(sht, spec_in, K)[1], sht.dft_inv,
            sht.cpol_even_g, sht.cpol_odd_g, sht.cosgr, 2 * K), reps=10),
        bound_ms(8 * MN * 3 * (4 * K + 1) + 4 * sht.inject_blob.numel()
                 + 8 * g.mx * nlon + 4 * iy * MN + 4 * nlat + 4 * 4 * K * G,
                 MN * 40 * K + 4 * K * (4 * iy * MN + 4 * iy * g.mx
                                        + 4 * G * g.mx), PEAK_F32_S))

    # K19: the gate on this cycle's grid back from K6, float32 and
    # float64: the flag and the eight extrema equal to the plain version's;
    # then each bound tripped in turn by one value just beyond it, and a
    # NaN: the kernel's flag must read unsafe
    back = kgrid
    err19 = 0.0
    for label, b_ in (("float32", back), ("float64", back.double())):
        ksafe, kext = gate_check(b_, K)
        psafe, pext = gate_check_plain(b_, K)
        e = max_abs_diff(torch, kext, pext)
        log(f"K19 {label}: safe {bool(ksafe)} (plain {bool(psafe)}), "
            f"extrema " + ", ".join(f"{float(x):.4g}" for x in kext)
            + f", max_abs_err={e:.3e} (tolerance 0)")
        if bool(ksafe) != bool(psafe) or not bool(ksafe):
            fail(f"K19 ({label}): the main path's grid reads unsafe or "
                 f"differs from the plain gate")
        if label == "float32":
            err19 = e
        elif e > 0.0:
            fail("K19 (float64) disagrees with its plain version")
    var_field = {"u": 2 * K, "v": 3 * K, "t": 0, "q": K}
    tripped = []
    for (v, (lo, hi)) in zip("uvtq", GATE_BOUNDS):
        for side, b0, away in (("min", lo, -float("inf")),
                               ("max", hi, float("inf"))):
            bb = back.clone()
            bb[var_field[v] + 3, 10, 20] = torch.nextafter(
                torch.tensor(b0, dtype=f32), torch.tensor(away, dtype=f32))
            tripped.append((f"{v} {side}", bool(gate_check(bb, K)[0])))
    bb = back.clone()
    bb[var_field["q"] + 5, 7, 11] = float("nan")
    nan_safe, nan_ext = gate_check(bb, K)
    tripped.append(("NaN", bool(nan_safe)))
    log("K19 with one value beyond a bound or a NaN, the flag: "
        + ", ".join(f"{c} {f}" for c, f in tripped)
        + f"; extrema with the NaN "
        + ", ".join(f"{float(x):.4g}" for x in nan_ext))
    if any(f for _, f in tripped):
        fail("K19 reads safe with a value beyond a bound or a NaN")
    (k19_ms, k19_c), k19_runs = measure_median(torch,
                                               lambda: gate_check(back, K))
    log("K19 sessions (device ms): " + ", ".join(f"{r:.4f}"
                                                 for r in k19_runs))
    ok &= record(
        "K19_gate_check", "speedy_ml_tpu_torch/kernels/csrc/gate_check.cu",
        "speedy_ml_tpu/hybrid/model.py:423", err19, 0.0, (k19_ms, k19_c),
        measure(torch, lambda: gate_check_plain(back, K), reps=20),
        bound_ms(4 * back.numel() + 4 * 8 + 1, 2 * back.numel(),
                 PEAK_F32_S))

    # the SPEEDY window's inputs: the main path's injected state two
    # cycles in, its surface and forcing, one stepone
    spec0, safe0 = hyb.inject_to_speedy(atmo, logp)
    _, tisr_w = hyb._run_window(spec0, s.sst_grid, imon, fmon, tyear)
    if not torch.equal(tisr_w, sfc_forcing.tisr_plane(tyear, hyb._slat,
                                                      hyb._clat, nlon)):
        fail("the coupled cycle's TISR plane (its window's fsol) differs "
             "from K17b's")
    log("the coupled cycle's TISR plane (_run_window's fsol) equals "
        "tisr_plane at the same tyear (torch.equal)")
    sfc = init_surface_state(gcm.bd, imon, fmon, sst_hybrid=s.sst_grid,
                             flags=gcm.cpl)
    forcing = gcm.forcing_for(sfc, tyear)
    gst = GCMState(spectral=spec0, sfc=sfc,
                   radiation=RadiationCarry.zeros(K, nlat, nlon, f32, dev),
                   fluxes=FluxAccumulator.zeros(nlat, nlon, f32, dev))
    gst = gcm.stepone(gst, forcing)
    st = gst.spectral
    imp = dyn.imp_double
    corr = (forcing.tcorh, forcing.qcorh)

    # K15: the spectral stacks of this state at the leapfrog's levels
    # (jd, jp) = (1, 0), at stepone's first step's (0, 0), the dynamics
    # stack alone (the dry core's) and the physics stack alone (the
    # window exit's), each against its plain version: the same values, as
    # every operation is rounded apart in the plain version's order.
    # Negative control: a copy of the dynamics stack whose u cos, v cos
    # take uvspec's n-1 and n+1 neighbours the other way round must fail
    MN = g.mx * g.nx
    flat = lambda a: a.reshape(-1, MN)
    err15 = 0.0
    for jd_, jp_ in ((1, 0), (0, 0), (1, None), (None, 0)):
        kst = spectral_stack(dyn, st, gcm.phis, jd_, jp_)
        pst = (None if jd_ is None else dynamics_stack_plain(dyn, st, jd_),
               None if jp_ is None else physics_stack_plain(dyn, st, jp_,
                                                            gcm.phis))
        parts = []
        for nm, k_, p_ in zip(("dynamics", "physics"), kst, pst):
            if p_ is None:
                continue
            e_ = max_abs_diff(torch, k_, p_)
            rel_ = per_field_err(torch, flat(k_), flat(p_))[0]
            parts.append(f"{nm} stack {tuple(k_.shape)} max_abs_err="
                         f"{e_:.3e} ({rel_:.3e} of a field's scale)")
            err15 = max(err15, e_)
        log(f"K15 at (jd, jp) = ({jd_}, {jp_}): " + ", ".join(parts)
            + " (tolerance 0)")
    kd, _ = spectral_stack(dyn, st, gcm.phis, 1, None)
    vor1, div1 = st.vor[1], st.div[1]
    ctl = kd.clone()
    ctl[4 * K:5 * K] = (sht.uvdym * shift_left(vor1)
                        - sht.uvdyp * shift_right(vor1)
                        + 1j * sht.uvdx * div1 * sht.zrow_mask)
    ctl[5 * K:6 * K] = (-sht.uvdym * shift_left(div1)
                        + sht.uvdyp * shift_right(div1)
                        + 1j * sht.uvdx * vor1 * sht.zrow_mask)
    rel_ctl, err_ctl = per_field_err(
        torch, flat(ctl), flat(dynamics_stack_plain(dyn, st, 1)))
    log(f"K15 negative control (uvspec's n-shifts reversed): "
        f"max_abs_err={err_ctl:.3e} ({rel_ctl:.3e} of a field's scale) "
        f"against the tolerance 0")
    if not err_ctl > 0.0:
        fail("K15's check does not tell reversed uvspec shifts from the "
             "right ones")
    (k15_ms, k15_call), k15_runs = measure_median(
        torch, lambda: spectral_stack(dyn, st, gcm.phis, 1, 0))
    log("K15 sessions (device ms): "
        + ", ".join(f"{r:.4f}" for r in k15_runs))
    # read: vor, div, t, q (K each) and ps at both levels, phis, the
    # tables; written: both stacks
    n_in15 = 2 * (4 * K + 1) + 1
    n_out15 = (6 * K + 2) + (5 * K + 1)
    ok &= record(
        "K15_spectral_stack",
        "speedy_ml_tpu_torch/kernels/csrc/spectral_stack.cu",
        "speedy_ml_tpu/core/spectral.py:340", err15, 0.0,
        (k15_ms, k15_call),
        measure(torch, lambda: (dynamics_stack_plain(dyn, st, 1),
                                physics_stack_plain(dyn, st, 0, gcm.phis)),
                reps=10),
        bound_ms(8 * MN * (n_in15 + n_out15) + 4 * dyn.stack_blob.numel(),
                 MN * (48 * K + 4 * K * K + 8), PEAK_F32_S))

    # K6: the dynamics stack at level 1 (50 fields)
    stk, ncos = dyn.dynamics_stack(st, 1)
    sargs = (stk, sht.dft_inv, sht.cpol_even_g, sht.cpol_odd_g, sht.cpol_g,
             sht.cosgr, ncos)
    gk = sht_synthesis(*sargs)
    gp = sht_synthesis_plain(stk, sht.dft_inv, sht.cpol_even_g,
                             sht.cpol_odd_g, sht.cosgr, ncos)
    rel, err = per_field_err(torch, gk, gp)
    B, G = stk.shape[0], nlat * nlon
    iy = g.nlat_half
    tab_bytes = 8 * g.mx * nlon + 4 * iy * MN + 4 * nlat
    k6_bound = lambda B: bound_ms(
        B * (8 * MN + 4 * G) + tab_bytes,
        B * (4 * iy * MN + 4 * iy * g.mx + 4 * G * g.mx), PEAK_F32_S)
    ok &= record(
        "K6_sht_synthesis",
        "speedy_ml_tpu_torch/kernels/csrc/sht_synthesis.cu",
        "speedy_ml_tpu/core/spectral.py:294", rel, SHT_RTOL,
        measure_median(torch, lambda: sht_synthesis(*sargs))[0],
        measure(torch, lambda: sht_synthesis_plain(
            stk, sht.dft_inv, sht.cpol_even_g, sht.cpol_odd_g, sht.cosgr,
            ncos), reps=50),
        k6_bound(B))
    log(f"  (K6 max_abs_err is relative to each field's scale; absolute "
        f"{err:.3e})")

    # K7: the column dynamics with the physics tendencies of this state
    ptend, (_, diag4, _) = gcm._physics_fn(st, 0, dyn, sfc, forcing,
                                           gst.radiation, False)
    tabs = dyn.column_tables(imp)
    gk7 = grid_dynamics(gk, ptend, tabs, K, 1)
    gp7 = grid_dynamics_plain(gk, ptend, tabs, K, 1)
    d7 = (gk7 - gp7).abs().reshape(gk7.shape[0], -1).amax(dim=1)
    s7 = gp7.abs().reshape(gp7.shape[0], -1).amax(dim=1)
    ulps7 = float((d7 / (torch.finfo(f32).eps * s7.clamp(min=1e-30))).max())
    n7 = gk7.shape[0]
    k7, k7_runs = measure_median(
        torch, lambda: grid_dynamics(gk, ptend, tabs, K, 1))
    log("K7 sessions (device ms): " + ", ".join(f"{r:.4f}" for r in k7_runs))
    ok &= record(
        "K7_grid_dynamics",
        "speedy_ml_tpu_torch/kernels/csrc/grid_dynamics.cu",
        "speedy_ml_tpu/dycore/model.py:258", ulps7, K7_ULPS, k7,
        measure(torch, lambda: grid_dynamics_plain(gk, ptend, tabs, K, 1),
                reps=10),
        bound_ms(4 * G * (B + 4 * K + n7) + 4 * (nlat + 5 * K),
                 G * (73 * K + 4), PEAK_F32_S))
    log("  (K7 max_abs_err is in ulps of each output field's scale)")

    # K5: the forward transform of K7's stack (73 fields)
    n0 = 1 + 3 * K
    aargs = (gk7, sht.dft_fwd, sht.wt, sht.cpol_even_s, sht.cpol_odd_s,
             sht.cpol_s, sht.cosgr, n0)
    ak = sht_analysis(*aargs)
    ap = sht_analysis_plain(gk7, sht.dft_fwd, sht.wt, sht.cpol_even_s,
                            sht.cpol_odd_s, sht.cosgr, n0)
    rel, err = per_field_err(torch, ak, ap)
    B5 = gk7.shape[0]
    k5_bound = lambda B: bound_ms(
        B * (4 * G + 8 * MN) + tab_bytes,
        B * (4 * G * g.mx + 6 * iy * g.mx + 4 * iy * MN), PEAK_F32_S)
    ok &= record(
        "K5_sht_analysis",
        "speedy_ml_tpu_torch/kernels/csrc/sht_analysis.cu",
        "speedy_ml_tpu/core/spectral.py:251", rel, SHT_RTOL,
        measure_median(torch, lambda: sht_analysis(*aargs))[0],
        measure(torch, lambda: sht_analysis_plain(
            gk7, sht.dft_fwd, sht.wt, sht.cpol_even_s, sht.cpol_odd_s,
            sht.cosgr, n0), reps=50),
        k5_bound(B5))
    log(f"  (K5 max_abs_err is relative to each field's scale; absolute "
        f"{err:.3e})")

    # K6 and K5 at every stack size and 1/cos split of the coupled cycle
    # (the leading fields of the stacks above), each checked against its
    # plain version and timed as the median of SHT_SESSIONS sessions
    syn_shapes = (("dycore step", stk.shape[0], ncos),
                  ("physics_grid and the window's exit", 5 * K + 1,
                   3 * K + 1),
                  ("injection", 4 * K, 2 * K))
    ana_shapes = (("analysis_stack", B5, n0), ("injection", 4 * K + 1,
                                               2 * K + 1),
                  ("forcing", 2, None))
    for kind, shapes in (("K6", syn_shapes), ("K5", ana_shapes)):
        for site, Bs, split in shapes:
            if kind == "K6":
                sp = stk[:Bs]
                fn = lambda: sht_synthesis(sp, sht.dft_inv, sht.cpol_even_g,
                                           sht.cpol_odd_g, sht.cpol_g,
                                           sht.cosgr, split)
                pfn = lambda: sht_synthesis_plain(
                    sp, sht.dft_inv, sht.cpol_even_g, sht.cpol_odd_g,
                    sht.cosgr, split)
                bnd = k6_bound(Bs)
            else:
                gr = gk7[:Bs]
                pre = None if split is None else sht.cosgr
                fn = lambda: sht_analysis(gr, sht.dft_fwd, sht.wt,
                                          sht.cpol_even_s, sht.cpol_odd_s,
                                          sht.cpol_s, pre, split)
                pfn = lambda: sht_analysis_plain(
                    gr, sht.dft_fwd, sht.wt, sht.cpol_even_s,
                    sht.cpol_odd_s, pre, split)
                bnd = k5_bound(Bs)
            rel_s, _ = per_field_err(torch, fn(), pfn())
            (dev_ms, call_ms), runs = measure_median(torch, fn)
            plain_s = measure(torch, pfn, reps=20)
            log(f"{kind} at B={Bs} ({site}, scaled from "
                f"{'none' if split is None else split}): max_abs_err="
                f"{rel_s:.3e} (tolerance {SHT_RTOL:.0e}) kernel_ms="
                f"{dev_ms:.4f} median of {len(runs)} sessions ("
                + ", ".join(f"{r:.4f}" for r in runs)
                + f"; call {call_ms:.4f}) plain_ms={plain_s[0]:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]}) [{card}]"
                + ("" if rel_s <= SHT_RTOL else "  <-- FAIL"))
            ok &= rel_s <= SHT_RTOL

    # K8: the spectral tail of a filtered leapfrog step (recorded) and of
    # stepone's two steps (j1 = 1, no filter), each against the plain
    # version on the same inputs
    def tail_err(imp_, j1, dt_, eps):
        a = (ak, st, gcm.phis, corr, imp_, j1, dt_, eps, 0, True)
        nk, npl = spectral_tail(dyn, *a), dyn.spectral_tail_plain(*a)
        return max(per_field_err(torch, getattr(nk, f).reshape(-1, MN),
                                 getattr(npl, f).reshape(-1, MN))[0]
                   for f in SpectralState.FIELDS)

    for label, imp_, dt_ in (("stepone 1 (imp_half)", dyn.imp_half,
                              0.5 * dyn.delt),
                             ("stepone 2 (imp_full)", dyn.imp_full,
                              dyn.delt)):
        e = tail_err(imp_, 1, dt_, 0.0)
        log(f"K8 at {label}, j1=1: max_abs_err={e:.3e} (tolerance "
            f"{TAIL_RTOL:.0e})" + ("" if e <= TAIL_RTOL else "  <-- FAIL"))
        ok &= e <= TAIL_RTOL
    targs = (dyn, ak, st, gcm.phis, corr, imp, 2, dyn.delt2, dyn.rob, 0,
             True)
    st_bytes = sum(getattr(st, k).numel() * 8 for k in SpectralState.FIELDS)
    (k8_ms, k8_call), k8_runs = measure_median(
        torch, lambda: spectral_tail(*targs))
    log("K8 sessions (device ms): "
        + ", ".join(f"{r:.4f}" for r in k8_runs))
    ok &= record(
        "K8_spectral_tail",
        "speedy_ml_tpu_torch/kernels/csrc/spectral_tail.cu",
        "speedy_ml_tpu/dycore/model.py:386",
        tail_err(imp, 2, dyn.delt2, dyn.rob), TAIL_RTOL, (k8_ms, k8_call),
        measure(torch, lambda: dyn.spectral_tail_plain(
            ak, st, gcm.phis, corr, imp, 2, dyn.delt2, dyn.rob, 0, True),
            reps=10),
        bound_ms(ak.numel() * 8 + 2 * st_bytes + 3 * MN * 8
                 + imp.blob.numel() * 4,
                 MN * (12 * K * K + 100 * K + 20), PEAK_F32_S))
    log("  (K8 max_abs_err is relative to each field level's scale)")

    # K9, K9_moist_shortwave, K10a_down_surface, K10b, K12, K12_pbl_flux:
    # the column physics on the
    # main path's own inputs, the physics grid of this state and the
    # radiation carry that stepone left (a shortwave step, so tau2 and
    # stratc are real), float32; and on the same inputs upcast, against a
    # float64 PhysicsModel's tables
    phys = gcm.phys
    phys64 = PhysicsModel(g, gcm.const, dtype=torch.float64, device=dev)
    ug4, vg4, tg4, qg4, phig4, pslg4 = gcm.physics_grid(st, 0)
    carry4 = gst.radiation
    if float(carry4.tau2.min()) <= 0 or float(carry4.tau2.max()) > 1:
        fail("the radiation carry after stepone holds no transmissivities")

    def up64(a):
        """a (tensors, tuples, NamedTuples) with its float tensors in
        float64."""
        if isinstance(a, tuple):
            items = tuple(map(up64, a))
            return type(a)(*items) if hasattr(a, "_fields") else items
        return a.double() if a.is_floating_point() else a

    def column_check(name, src, replaces, kernel, plain, args, tabs, tabs64,
                     to_dict, ints, planes, ops):
        """Both comparisons of one column kernel, then record(): no
        difference and no flipped column allowed, in float64 and float32.
        The kernel is timed as the median of SHT_SESSIONS sessions."""
        a64 = [up64(a) for a in args]
        rel = {}
        for label, a, tb in (("float64", a64, tabs64),
                             ("float32", args, tabs)):
            got, ref = to_dict(kernel(*a, tb)), to_dict(plain(*a, tb))
            fl, rel[label], worst = column_errors(got, ref, ints)
            log(f"{name} {label} on the card: {fl} columns of {G} with "
                f"other integer outputs (at most 0), worst output "
                f"{worst or 'none'} {rel[label]:.3e} of its scale")
            if fl:
                fail(f"{name} {label}: {fl} columns flipped")
        if not rel["float64"] <= 0.0:
            fail(f"{name}<double> disagrees with the plain float64 version "
                 f"(tolerance 0)")
        kern, runs = measure_median(torch, lambda: kernel(*args, tabs))
        log(f"{name} sessions (device ms): "
            + ", ".join(f"{r:.4f}" for r in runs))
        return record(name, src, replaces, rel["float32"], 0.0, kern,
                      measure(torch, lambda: plain(*args, tabs), reps=10),
                      bound_ms(4 * G * planes, G * ops, PEAK_F32_S))

    csrc = "speedy_ml_tpu_torch/kernels/csrc/"
    # planes: 4-byte (lat, lon) planes read + written (int64 counts two);
    # ops: a rough count per column, far below the bytes' time either way
    ok &= column_check(
        "K9_column_moist", csrc + "column_moist.cu",
        "speedy_ml_tpu/physics/driver.py:192", column_moist,
        column_moist_plain, (tg4, qg4, phig4, pslg4), phys.moist_tabs,
        phys64.moist_tabs, lambda m: m._asdict(), ("itop", "icnv"),
        (3 * K + 1) + (6 * K + 5) + 4, 60 * K + 100)
    m4 = column_moist(tg4, qg4, phig4, pslg4, phys.moist_tabs)
    bd = gcm.bd
    # K9_moist_shortwave takes the tables as a pair and the shortwave's
    # planes loose (the checks upcast tensors and named tuples)
    sw_names = ("tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr")
    msw = lambda fn: lambda tg, qg, phig, pslg, fmask, sol, albsfc, tb: fn(
        tg, qg, phig, pslg, tb[0], ShortwaveForcing(fmask, sol, albsfc,
                                                    tb[1]))
    sol4 = rad.SolarForcing(fsol=forcing.fsol, ozupp=forcing.ozupp,
                            ozone=forcing.ozone, zenit=forcing.zenit,
                            stratz=forcing.stratz)
    # planes: K9's, then seven read (fmask, the five solar planes,
    # albsfc) and 5K + 5 written (tau2, stratc, tt_rsw, ssrd, ssr, tsr);
    # ops: K9's and the shortwave's 45 exponentials a column
    ok &= column_check(
        "K9_moist_shortwave", csrc + "column_moist.cu",
        "speedy_ml_tpu/physics/driver.py:192, "
        "speedy_ml_tpu/physics/radiation.py:165",
        msw(moist_shortwave), msw(moist_shortwave_plain),
        (tg4, qg4, phig4, pslg4, bd.fmask_l, sol4, forcing.albsfc),
        (phys.moist_tabs, phys.sw_tabs), (phys64.moist_tabs, phys64.sw_tabs),
        lambda o: {**o[0]._asdict(), **dict(zip(sw_names, o[1]))},
        ("itop", "icnv"), (3 * K + 1) + (6 * K + 5) + 4 + 7 + (5 * K + 5),
        60 * K + 100 + 100 * K + 45 * 20)
    up_plain = lambda *a: rad.radlw_up(*a[:-1], a[-1].fband, dsig=a[-1].dsig,
                                       sbc=a[-1].sbc)

    def fx_dict(fx):
        """SurfaceFluxes as name -> plane, its (land, sea, blend) tuples
        spread out (ustr0, ustr1, ustr2, ...)."""
        out = {}
        for nm, v in fx._asdict().items():
            if isinstance(v, tuple):
                out.update({f"{nm}{i}": x for i, x in enumerate(v)})
            else:
                out[nm] = v
        return out

    def ds_dict(o):
        """down_surface's ((slrd, dfabs, flux_bands, st4a),
        SurfaceFluxes) as name -> tensor."""
        (slrd, dfabs, flux, (mean, grad)), fx = o
        return dict(slrd=slrd, dfabs=dfabs, flux_bands=flux, st4a_mean=mean,
                    st4a_grad=grad, **fx_dict(fx))

    # K10a_down_surface takes keywords and two tables; the checks pass its
    # operands in INPUTS order and the tables as a pair
    ds = lambda fn: lambda *a: fn(**dict(zip(clw.INPUTS, a[:-1])),
                                  lw_tabs=a[-1][0], sfc_tabs=a[-1][1])
    ds_args = (tg4, carry4.tau2, m4.psg, ug4, vg4, m4.qg, phig4, bd.phis0,
               bd.fmask_l, sfc.stl_am, sfc.sst_am, sfc.soilw_am,
               carry4.ssrd, bd.forog, forcing.alb_l, forcing.alb_s,
               forcing.snowc, phys.clat_t)
    # planes read: ta, tau2 (level 0 in bands 0 and 1 only), psg, the
    # lowest level of ua, va, qa, phi, ten surface planes, the clat row
    ok &= column_check(
        "K10a_down_surface", csrc + "column_longwave.cu",
        "speedy_ml_tpu/physics/radiation.py:318, "
        "speedy_ml_tpu/physics/surface.py:40", ds(clw.down_surface),
        ds(clw.down_surface_plain), ds_args, (phys.lw_tabs, phys.sfc_tabs),
        (phys64.lw_tabs, phys64.sfc_tabs), ds_dict, (),
        (5 * K + 13 + nlat / G) + (3 * K + 28), 60 * K + 150)
    dn4, fx4 = ds(clw.down_surface)(*ds_args, (phys.lw_tabs, phys.sfc_tabs))
    up_args = (tg4, fx4.tsfc, dn4[0], fx4.slru[2], dn4[1], dn4[2], dn4[3],
               carry4.tau2, carry4.stratc)
    ok &= column_check(
        "K10b_radlw_up", csrc + "column_longwave.cu",
        "speedy_ml_tpu/physics/radiation.py:381", clw.radlw_up, up_plain,
        up_args, phys.lw_tabs, phys64.lw_tabs,
        lambda o: dict(slr=o[0], olr=o[1], dfabs=o[2]), (),
        (8 * K + 9) + (K + 2), 60 * K)
    up4 = clw.radlw_up(*up_args, phys.lw_tabs)
    pbl_names = ("utend", "vtend", "ttend", "qtend", "hflux_i")
    pbl_args = (m4, phig4, fx4, carry4.tt_rsw, carry4.ssrd, up4[2],
                sfc.tice_am, sfc.sice_am)
    ok &= column_check(
        "K12_column_pbl", csrc + "column_pbl.cu",
        "speedy_ml_tpu/physics/vdiff.py:16", column_pbl, column_pbl_plain,
        pbl_args, phys.pbl_tabs, phys64.pbl_tabs,
        lambda o: dict(zip(pbl_names, o)), (),
        (9 * K + 2 + 11) + (4 * K + 1), K * K + 40 * K)
    # K12_pbl_flux: the window's flux sums of a leapfrog step on this
    # state's physics, from an accumulator that already holds one step;
    # the checks pass the accumulator as a tuple and the tables last
    rsteps, delt2 = 1.0 / gcm.nsteps_day, dyn.delt2
    flux_names = ("hflux_l", "hflux_s", "hflux_i", "precip")
    sums = lambda f: tuple(getattr(f, nm) for nm in flux_names)
    acc4 = sums(flux_accumulate_plain(gst.fluxes, diag4, rsteps, delt2))
    pf = lambda fn: lambda *a: (lambda o: o[:5] + sums(o[5]))(
        fn(*a[:8], a[9], FluxAccumulator(*a[8]), rsteps, delt2))
    # planes: K12's, then seven read (the four sums, hflux_l, precnv,
    # precls) and the four sums written; ops: K12's and 11 a column
    ok &= column_check(
        "K12_pbl_flux", csrc + "column_pbl.cu",
        "speedy_ml_tpu/physics/vdiff.py:16, speedy_ml_tpu/gcm.py:273",
        pf(pbl_flux), pf(pbl_flux_plain), pbl_args + (acc4,), phys.pbl_tabs,
        phys64.pbl_tabs,
        lambda o: dict(zip(pbl_names + tuple(f"acc_{n}" for n in flux_names),
                           o)), (),
        (9 * K + 2 + 11) + (4 * K + 1) + 7 + 4, K * K + 40 * K + 11)
    log("  (K9, K9_moist_shortwave, K10a_down_surface, K10b, K12, "
        "K12_pbl_flux max_abs_err is relative to each output's scale, over "
        "the columns whose integer outputs agree)")
    # K20: the window's exit on the synthesis of this state's physics
    # stack at level 0, alone and with the cycle's select (ok true; prev
    # false), float32 and float64, against the plain version: the same
    # values (tolerance 0).  Beside it, K6's fields of the 41-field
    # physics stack against the window's former 33-field exit synthesis
    # [t, q, ps | u cos, v cos]: K6 gives a field the same values whatever
    # the stack's size
    out20 = gcm.physics_synthesis(st, 0)
    ucosm, vcosm = sht.uvspec(st.vor[0], st.div[0])
    old = sht.synthesis(torch.cat([st.t[0], st.tr[0, 0], st.ps[0][None],
                                   ucosm, vcosm]), 2 * K + 1)
    e6 = max(max_abs_diff(torch, old[:2 * K], out20[:2 * K]),
             max_abs_diff(torch, old[2 * K], out20[3 * K]),
             max_abs_diff(torch, old[2 * K + 1:], out20[3 * K + 1:]))
    log(f"K6 at 41 fields (the physics stack) against 33 (the former exit "
        f"stack), the fields the exit reads: max_abs_err={e6:.3e}")
    if e6 > 0.0:
        fail("K6 gives a field other values in a stack of another size")
    yes = torch.ones((), dtype=torch.bool, device=dev)
    sel_ok = (yes, safe0, atmo, logp)
    sel_no = (~yes, safe0, atmo, logp)
    err20 = 0.0
    for label, o_, sels in (
            ("float32", out20, (None, sel_ok, sel_no)),
            ("float64", out20.double(),
             (None, (yes, safe0, atmo.double(), logp.double())))):
        e20 = 0.0
        for sel in sels:
            ka, kl, kok = window_select(o_, K, sel)
            pa, pl, pok = window_select_plain(o_, K, sel)
            e = max(max_abs_diff(torch, ka, pa), max_abs_diff(torch, kl, pl))
            if sel is not None and bool(kok) != bool(pok):
                e = float("inf")
            e20 = max(e20, e)
        log(f"K20 {label}: alone and with the select (ok true, prev "
            f"false), max_abs_err={e20:.3e} (tolerance 0)")
        err20 = max(err20, e20)
    if not bool(safe0):
        fail("the main path's injected state reads unsafe")
    (k20_ms, k20_c), k20_runs = measure_median(
        torch, lambda: window_select(out20, K, sel_ok))
    log("K20 sessions (device ms): " + ", ".join(f"{r:.4f}"
                                                 for r in k20_runs))
    # with ok true: the 4K + 1 fields read from out (not the injected ones)
    # and written, and the two flags
    ok &= record(
        "K20_window_select",
        "speedy_ml_tpu_torch/kernels/csrc/window_select.cu",
        "speedy_ml_tpu/hybrid/model.py:466", err20, 0.0, (k20_ms, k20_c),
        measure(torch, lambda: window_select_plain(out20, K, sel_ok),
                reps=20),
        bound_ms(4 * G * 2 * (4 * K + 1) + 3, 0, PEAK_F32_S))
    del phys64, m4, dn4, fx4, up4
    if not ok:
        fail("a kernel disagrees with its plain version")

    # the modes off the main path: K1 with shared and per-region cols
    # tables and a win_cols map (imported weights); K2 with f32 Wout,
    # with no local-model block (the ML-only form) and bf16; K3 in its
    # core-only form (build_local_model)
    p, a = packs[1], step_args[1]
    R, n = a["x"].shape
    q = n // a["u"].shape[1]
    win_cols = (torch.arange(n, device=dev, dtype=torch.int32) // q) \
        .expand(R, n).contiguous()
    ref = esn_step(**a)
    for kw in (dict(shifts=None, cols=p.res.cols),
               dict(shifts=None,
                    cols=p.res.cols.expand(R, -1, -1).contiguous()),
               dict(win_cols=win_cols)):
        b = dict(a, **kw)
        k, pl = esn_step(**b), esn_step_plain(**b)
        err = max(float((k - pl).abs().max()), float((k - ref).abs().max()))
        if err > 1e-5:
            fail(f"K1 mode {sorted(kw)} disagrees: {err:.3e}")
    S = p.res.n_speedy
    x, lm = ro_args[1]["x"], ro_args[1]["local_model"]
    w_ml = p.res.wout[:, :, S:].contiguous()
    worst = 0.0
    for w, l in ((p.res.wout.float(), lm), (w_ml, None), (w_ml.float(),
                                                          None)):
        k, pl = readout(w, x, l), readout_plain(w, x, l)
        err = float((k - pl).abs().max())
        sc = float(pl.abs().max())
        worst = max(worst, err / sc)
        if err > K2_RTOL * sc:
            fail(f"K2 ({w.dtype}, S={0 if l is None else S}) disagrees: "
                 f"{err:.3e} > {K2_RTOL * sc:.3e}")
    del w_ml
    fc = (atmo, logp)
    lk = hyb.build_local_model(packs, *fc)
    fl = (fc[0],) + (fc[1],) * 4
    lp = window_gather_plain(
        fl, hyb.local_index,
        [pk.std.out_mean[:, :pk.res.n_speedy] for pk in packs],
        [pk.std.out_std[:, :pk.res.n_speedy] for pk in packs])
    err = max(float((k - pl).abs().max()) for k, pl in zip(lk, lp))
    if err > 0:
        fail(f"K3's core-only form disagrees: {err:.3e}")
    log("K1 cols/win_cols modes, K2 f32 / ML-only forms and K3's "
        f"core-only form agree with their plain versions (K2 worst "
        f"{worst:.3e} of its scale, K3 exact)")
    if args.kernels:
        log(f"chip_smoke --kernels: the kernel checks passed, "
            f"{time.perf_counter() - t_start:.1f} s after the card check; "
            f"no result line [{card}]")
        return

    # -- 5. the SPEEDY window on the card against the plain port on the
    lap("4 kernels")
    #       CPU (float32): stepone from the same injected state, then each
    #       of the window's steps from the card's state before it, held to
    #       the plain step from the same state (window_steps: near-tie
    #       physics decisions counted and capped, the rest held tightly).
    #       The two sides' free windows after 24 steps are logged beside:
    #       one decision that fell the other way grows over the remaining
    #       leapfrog steps, whatever the kernels do.
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    gcm_c = GCM(g, dtype=f32, bd=gcm.bd.to(device=cpu), device=cpu)

    def start(gm, spec, sst_grid):
        dv = gm.device
        sf = init_surface_state(gm.bd, imon, fmon, sst_hybrid=sst_grid,
                                flags=gm.cpl)
        fo = gm.forcing_for(sf, tyear)
        gs = GCMState(spectral=spec, sfc=sf,
                      radiation=RadiationCarry.zeros(K, nlat, nlon, f32, dv),
                      fluxes=FluxAccumulator.zeros(nlat, nlon, f32, dv))
        return gm.stepone(gs, fo), fo

    gk, fo_k = start(gcm, spec0, s.sst_grid)
    gp, fo_p = start(gcm_c, spec0.map(lambda t: t.cpu()), s.sst_grid.cpu())
    # after stepone each variable is held to its magnitude: the untrained
    # readout puts T at 250 K +- ~0.1 K, so T's signal is below a few f32
    # ulps of the field (the two sides sum in other orders)
    e1 = window_errs(torch, gcm, gcm_c, gk, gp, magnitude=True)
    gk, es, flips, near = window_steps(torch, gcm, gcm_c, gk, fo_k, fo_p,
                                       hyb.gcm_steps)
    gp = gcm_c.run_window(gp, fo_p, hyb.gcm_steps)
    ew = window_errs(torch, gcm, gcm_c, gk, gp)
    fmt = lambda d: ", ".join(f"{v} {e:.3e}" for v, e in d.items())
    G = nlat * nlon
    log(f"SPEEDY window, kernels on the card vs the plain port on the CPU "
        f"(f32): after stepone {fmt(e1)} of each variable's magnitude "
        f"(tolerance 1e-5); worst of the {hyb.gcm_steps} steps, each from "
        f"the card's state, {fmt(es)} of each variable's signal "
        f"(tolerance {WINDOW_STEP_RTOL:.0e}); columns whose physics "
        f"tendencies differ by more than {WINDOW_FLIP_RTOL:.0e} of a "
        f"field's scale, per step: {flips} of {G} (at most "
        f"{COLUMN_FLIPS:.1%}), the largest difference in the others "
        f"{near:.3e}; the two free windows after {hyb.gcm_steps} steps "
        f"{fmt(ew)} (not held) [{time.perf_counter() - t0:.1f} s]")
    if (max(e1.values()) > 1e-5 or max(es.values()) > WINDOW_STEP_RTOL
            or max(flips) > COLUMN_FLIPS * G):
        fail("the card's SPEEDY window disagrees with the plain window")
    del gcm_c

    # -- 6. the ML-only main path (PR 1's phases, shortened) -------------
    lap("5 SPEEDY window")
    ml_kernels = ["K1_esn_step", "K2_readout_scatter", "K3_window_gather"]
    # K17b is on no cycle's path: the ML-only cycle's K3 takes the date,
    # the coupled cycle feeds back its window's fsol plane; K21 is the
    # persistent surface's (phase 12), K22 the slab ocean's (phase 13) and
    # K23 the SST table's (phase 14), off this path
    coupled_kernels = [nm for nm in kernels
                       if nm not in ("K17b_tisr_plane", "K21_slab_couple",
                                     "K22_slab_ocean", "K23_sst_by_date",
                                     "K24_sppt", "K25_rdf", "K26_cgrate")]

    def drive(h, st0, n, path, names):
        """run_prediction with the counters of `names` set to 0 before
        and read after; returns (final, dates, launches, wall s)."""
        if path is not None:
            path.unlink(missing_ok=True)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        fin, dts = run_prediction(h, st0, date0, n,
                                  output_path=None if path is None
                                  else str(path))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {nm: kernels[nm].launches for nm in names}
        for nm, c in counts.items():
            if c <= 0:
                fail(f"{nm} was not launched on the main path")
        return fin, dts, counts, wall

    def check_stream(path, n):
        z = np.load(path)
        shapes = {k: z[k].shape for k in z.files}
        want = {"atmo": (n, 4, nz, nlat, nlon), "logp": (n, nlat, nlon),
                "precip": (n, nlat, nlon), "sst": (n, nlat, nlon)}
        if shapes != want:
            fail(f"prediction stream shapes {shapes}, expected {want}")
        for k in z.files:
            if not np.isfinite(z[k]).all():
                fail(f"prediction field {k} is not finite")
        t_field = z["atmo"][:, 0]
        if not (150.0 <= t_field.min() and t_field.max() <= 350.0):
            fail(f"T outside [150, 350] K: {t_field.min()}..{t_field.max()}")
        qf = z["atmo"][:, 3]
        if qf.min() < 1e-6 * (1 - 1e-6):
            fail(f"q below the 1e-6 clamp: {qf.min()}")
        return (f"finite, T {t_field.min():.3f}..{t_field.max():.3f} K, "
                f"q min {qf.min():.3e}, precip max {z['precip'].max():.3e}")

    ml_state0 = hyb_ml.init_state(sst0)
    path = out_dir / "prediction_ml.npz"
    fin_ml, dts, counts, wall = drive(hyb_ml, ml_state0, CYCLES_ML, path,
                                      ml_kernels)
    if len(dts) != CYCLES_ML:
        fail(f"ML-only run_prediction stopped after {len(dts)} cycles")
    if sfc_forcing.tisr_plane.launches:
        fail(f"the ML-only cycle launched K17b "
             f"{sfc_forcing.tisr_plane.launches} times")
    results["K17b_tisr_plane"]["launches"] = sfc_forcing.tisr_plane.launches
    log(f"ML-only main path: run_prediction {len(dts)} cycles in "
        f"{wall:.3f} s with the writer; launches {counts}; "
        + check_stream(path, CYCLES_ML))
    walls = []
    run = lambda: run_prediction(hyb_ml, fin_ml, date0, N_TIMED)
    run()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_TIMED * 1e3)
    walls.sort()
    busy, kk_ml, _ = profile_device(torch, run, reps=1)
    log(f"ML-only cycle_ms: {walls[2]:.4f} median (min {walls[0]:.4f}, "
        f"max {walls[-1]:.4f}) over 5 x {N_TIMED} cycles; device busy "
        f"{busy / N_TIMED:.4f} ms/cycle; "
        f"{sum(e.count for e in kk_ml) / N_TIMED:g} device launches per "
        f"cycle (" + ", ".join(f"{kernel_name(e.key)} "
                               f"{e.count / N_TIMED:g}" for e in kk_ml)
        + f") [{card}]")
    # one ML-only cycle with the kernels vs the plain versions
    mp = hyb_ml.packs
    k_state, k_diag = hyb_ml.cycle(fin_ml, imon, fmon, tyear)
    p_x, p_out = [], []
    for pk, cs in zip(mp, fin_ml.classes):
        xx = esn_step_plain(pk.res.vals, cs.x, cs.feedback, pk.res.win_vals,
                            shifts=pk.res.shifts,
                            cols=None if pk.res.shifts is not None
                            else pk.res.cols,
                            win_cols=pk.res.win_cols,
                            leakage=pk.hyper.leakage)
        p_out.append(readout_plain(pk.res.wout, xx, None, pk.std.out_mean,
                                   pk.std.out_std))
        p_x.append(xx)
    p_grid = core_scatter_plain(p_out, core_table, 4, nz, nlat, nlon)
    p_fb = window_gather_plain(
        (*p_grid, fin_ml.sst_grid, sfc_forcing.tisr_plain(
            tyear, hyb_ml._slat, hyb_ml._clat, nlon)),
        hyb_ml.feedback_index, [pk.std.in_mean for pk in mp],
        [pk.std.in_std for pk in mp])
    scale = max(float((o - pk.std.out_mean).abs().max())
                for o, pk in zip(p_out, mp))
    err_x = max(float((a.x - b).abs().max())
                for a, b in zip(k_state.classes, p_x))
    err_f = max(float((k_diag[nm] - b).abs().max())
                for nm, b in zip(("atmo", "logp", "precip"), p_grid))
    err_fb = max(float((a.feedback - b).abs().max())
                 for a, b in zip(k_state.classes, p_fb))
    log(f"ML-only cycle kernels vs plain: x {err_x:.3e} (tol 1e-5), fields "
        f"{err_f:.3e} and feedback {err_fb:.3e} (tol {1e-3 * scale:.3e}, "
        f"1e-3 of the readout scale {scale:.3e})")
    if err_x > 1e-5 or err_f > 1e-3 * scale or err_fb > 1e-3 * scale:
        fail("the kernel cycle disagrees with the plain cycle")
    del hyb_ml, fin_ml, k_state, k_diag

    # -- 7. the coupled main path ---------------------------------------
    lap("6 ML-only")
    path = out_dir / "prediction.npz"
    final, dts, counts, wall = drive(hyb, state0, CYCLES, path,
                                     coupled_kernels)
    if len(dts) != CYCLES:
        fail(f"coupled run_prediction stopped after {len(dts)} cycles")
    if sfc_forcing.tisr_plane.launches:
        fail(f"the coupled cycle launched K17b "
             f"{sfc_forcing.tisr_plane.launches} times")
    if slab_couple.launches:
        fail(f"the coupled cycle without persist_surface launched K21 "
             f"{slab_couple.launches} times")
    if slab_ocean.launches:
        fail(f"the coupled cycle without ocean packs launched K22 "
             f"{slab_ocean.launches} times")
    if sst_by_date.launches:
        fail(f"the coupled cycle without an SST table launched K23 "
             f"{sst_by_date.launches} times")
    for nm, c in counts.items():
        results[nm]["launches"] = c
    log(f"coupled main path: run_prediction {len(dts)} cycles in "
        f"{wall:.3f} s with the writer; launches {counts} "
        f"(per cycle: " + ", ".join(f"{nm.split('_')[0]} {c / CYCLES:g}"
                                     for nm, c in counts.items()) + "); "
        + check_stream(path, CYCLES))
    for nm, most in LAUNCHES_PER_CYCLE.items():
        if counts[nm] > most * CYCLES:
            fail(f"{nm}: {counts[nm] / CYCLES:g} launches per coupled cycle, "
                 f"more than {most}")

    # device time and launches of each stage, profiled alone on the
    # cycle's own inputs: the kernels launched through ctypes are not
    # attributed to a host range in a trace.  This runs before the long
    # profile below, after which a short session can miss launches.
    pk = hyb.packs
    new_x, grid_ = hyb.predict_all(pk, final)
    a_, l_, p_ = hyb.assemble_global(pk, grid_)
    spec_, _ = hyb.inject_to_speedy(a_, l_)
    fa_, fl_, _ = hyb.speedy_window(spec_, final.sst_grid, imon, fmon,
                                    tyear)
    tisr_ = hyb._run_window(spec_, final.sst_grid, imon, fmon, tyear)[1]
    # predict_all assembles the grid too (K2's store): assemble_global
    # only takes views of it
    stages = {
        "predict_all": lambda: hyb.predict_all(pk, final),
        "inject_to_speedy": lambda: hyb.inject_to_speedy(a_, l_),
        "speedy_window": lambda: hyb.speedy_window(spec_, final.sst_grid,
                                                   imon, fmon, tyear),
        "build_feedback": lambda: hyb.build_feedback(
            pk, a_, l_, p_, final.sst_grid, tisr_),
        "build_local_model": lambda: hyb.build_local_model(pk, fa_, fl_)}
    # every device op that is not one of the port's kernels is a plain
    # launch (PyTorch's own kernels, copies, fills): listed by stage, and
    # at most PLAIN_MAX a cycle
    ours = port_kernel_names()
    parts, plain_lines, n_plain_all, window_kern = [], [], 0.0, None
    for nm, fn in stages.items():
        fn()
        reps = 2 if nm == "speedy_window" else 3
        if nm == "inject_to_speedy":
            ms, kk, _ = profile_counts(torch, fn, reps, lambda kk: sum(
                e.count for e in kk) < INJECT_LAUNCHES * reps)
        else:
            ms, kk, _ = profile_device(torch, fn, reps=reps)
        n_launch = sum(e.count for e in kk) / reps
        if n_launch == 0:
            fail(f"the profile of {nm} saw no device work")
        if nm == "inject_to_speedy" and n_launch != INJECT_LAUNCHES:
            fail(f"inject_to_speedy ran {n_launch:g} launches, not "
                 f"{INJECT_LAUNCHES}: " + ", ".join(
                     f"{kernel_name(e.key)} {e.count / reps:g}" for e in kk))
        plain = [e for e in kk if kernel_name(e.key) not in ours]
        n_plain = sum(e.count for e in plain) / reps
        n_plain_all += n_plain
        parts.append(f"{nm} {ms:.4f} ms ({n_launch:g} launches, "
                     f"{n_plain:g} plain)")
        plain_lines += [f"{nm}: {e.count / reps:g} x {e.key[:100]}"
                        for e in sorted(plain, key=lambda e: -e.count)]
        if nm == "speedy_window":
            window_kern = kk
    log("  device time per cycle by stage, each profiled alone: "
        + "; ".join(parts) + f" [{card}]")
    log(f"  plain launches per cycle, each stage profiled alone: "
        f"{n_plain_all:g} (at most {PLAIN_MAX})")
    for line in plain_lines:
        log(f"    plain {line}")
    if n_plain_all > PLAIN_MAX:
        fail(f"{n_plain_all:g} plain launches a coupled cycle, more than "
             f"{PLAIN_MAX}")
    knames = {"K5": "sht_analysis_kernel", "K6": "sht_synthesis_kernel",
              "K7": "grid_dynamics_kernel", "K8": "spectral_tail_kernel",
              "K9": "column_moist_kernel",
              "K9_moist_shortwave": "moist_shortwave_kernel",
              "K10a": "down_surface_kernel", "K10b": "radlw_up_kernel",
              "K12": "column_pbl_kernel", "K12_pbl_flux": "pbl_flux_kernel",
              "K15": "spectral_stack_kernel",
              "K17": "surface_forcing_kernel",
              "K20": "window_select_kernel"}
    kk = {k: [e for e in window_kern if kernel_name(e.key) == v]
          for k, v in knames.items()}
    n_win = sum(e.count for e in window_kern) / 2
    n_win_k = sum(sum(e.count for e in v) for v in kk.values()) / 2
    log(f"  speedy_window launches per cycle: {n_win:g}, of which "
        f"{n_win_k:g} kernel launches (K5-K10b, K12, K15, K17, K20, "
        f"K9_moist_shortwave, K12_pbl_flux) and "
        f"{n_win - n_win_k:g} plain launches")
    log("  inside speedy_window: " + "; ".join(
        f"{k} {sum(_self_device_us(e) for e in v) / 2e3:.4f} ms "
        f"({sum(e.count for e in v) / 2:g} launches)"
        for k, v in kk.items()))
    for k, v in kk.items():
        if not v:
            fail(f"{k} was not launched inside speedy_window")
    # the column physics of one step, with and without the shortwave,
    # with and without the window's flux sums (a window runs stepone's two
    # steps with the shortwave and without the sums, then 24 leapfrog
    # steps with the sums, 8 of them with the shortwave), on the carry of
    # a shortwave step (tau2 and stratc real)
    sfc_ = init_surface_state(gcm.bd, imon, fmon,
                              sst_hybrid=final.sst_grid, flags=gcm.cpl)
    fo_ = gcm.forcing_for(sfc_, tyear)
    grid_ = gcm.physics_grid(spec_, 0)
    phys = gcm.phys
    sums_ = (FluxAccumulator.zeros(nlat, nlon, f32, dev),
             1.0 / gcm.nsteps_day, gcm.dyn.delt2)
    step = lambda sw, carry, sums=None: phys.compute_with_sums(
        *grid_, bd=gcm.bd, sfc=sfc_, forcing=fo_, carry=carry, lradsw=sw,
        sums=sums)
    carry_ = step(True, RadiationCarry.zeros(K, nlat, nlon, f32, dev))[4]
    per = {}
    for sw in (True, False):
        for sm in (None, sums_):
            fn = lambda: step(sw, carry_, sm)
            fn()
            # nothing plain is left on the card: a step is four kernel
            # launches, one of each of its four kernels, and no other op
            want = [knames["K9_moist_shortwave" if sw else "K9"],
                    knames["K10a"], knames["K10b"],
                    knames["K12" if sm is None else "K12_pbl_flux"]]
            counts_of = lambda kk: {kernel_name(e.key): e.count for e in kk}
            ms, kk_, _ = profile_counts(torch, fn, 20, lambda kk: (
                set(counts_of(kk)) <= set(want)
                and sum(counts_of(kk).values()) < 20 * len(want)
                and max(counts_of(kk).values(), default=0) <= 20))
            per[sw, sm is not None] = (ms, sum(e.count for e in kk_) / 20)
            got = counts_of(kk_)
            if got != dict.fromkeys(want, 20):
                fail(f"a physics step (shortwave {sw}, flux sums "
                     f"{sm is not None}) ran {got} in 20 steps, not one "
                     f"launch of each of {want} a step")
    log(f"  physics (PhysicsModel.compute_with_sums, four kernel launches "
        f"and no other device op), per step: "
        + "; ".join(f"{'with' if sw else 'without'} the shortwave, "
                    f"{'with' if sm else 'without'} the flux sums "
                    f"{per[sw, sm][0]:.4f} ms ({per[sw, sm][1]:g} launches)"
                    for sw in (True, False) for sm in (False, True))
        + f"; per cycle (2 stepone steps, 8 + 16 leapfrog steps) "
        f"{2 * per[True, False][0] + 8 * per[True, True][0] + 16 * per[False, True][0]:.4f} ms "
        f"and {2 * per[True, False][1] + 8 * per[True, True][1] + 16 * per[False, True][1]:g} "
        f"launches [{card}]")
    # a leapfrog step (K15, K6 twice, the physics, K7, K5, K8): ten kernel
    # launches and no other op, the flux sums inside the physics' K12
    gst_ = GCMState(spectral=spec_, sfc=sfc_, radiation=carry_,
                    fluxes=sums_[0], istep=0)
    for istep in (0, 1):
        fn = lambda: gcm.leapfrog(dataclasses.replace(gst_, istep=istep),
                                  fo_)
        fn()
        ms, kk_, _ = profile_counts(torch, fn, 10, lambda kk: (
            all(kernel_name(e.key) in ours for e in kk)
            and sum(e.count for e in kk) < 10 * 10))
        n_step = sum(e.count for e in kk_) / 10
        other = sorted({e.key[:80] for e in kk_
                        if kernel_name(e.key) not in ours})
        if other or n_step != 10:
            fail(f"a leapfrog step (istep {istep}) ran {n_step:g} device "
                 f"ops a step, other than the port's kernels: {other}")
        log(f"  leapfrog step (istep {istep}, shortwave {istep == 0}): "
            f"{ms:.4f} ms, {n_step:g} kernel launches and no other op "
            f"[{card}]")
    # each kernel of the step alone, in the step's order
    ug_, vg_, tg_, qg_, phig_, pslg_ = grid_
    m_ = column_moist(tg_, qg_, phig_, pslg_, phys.moist_tabs)
    dn_, fx_ = phys.down_surface(m_, ug_, vg_, tg_, phig_, gcm.bd, sfc_,
                                 fo_, carry_)
    up_ = clw.radlw_up(tg_, fx_.tsfc, dn_[0], fx_.slru[2], dn_[1], dn_[2],
                       dn_[3], carry_.tau2, carry_.stratc, phys.lw_tabs)
    schemes = {
        "K9 column_moist": lambda: column_moist(tg_, qg_, phig_, pslg_,
                                                phys.moist_tabs),
        "K9_moist_shortwave (every 3rd step)": lambda: phys.moist(
            tg_, qg_, phig_, pslg_, gcm.bd, fo_, carry_, True),
        "K10a_down_surface": lambda: phys.down_surface(
            m_, ug_, vg_, tg_, phig_, gcm.bd, sfc_, fo_, carry_),
        "K10b radlw_up": lambda: clw.radlw_up(
            tg_, fx_.tsfc, dn_[0], fx_.slru[2], dn_[1], dn_[2], dn_[3],
            carry_.tau2, carry_.stratc, phys.lw_tabs),
        "K12 column_pbl (stepone)": lambda: phys.tendency_sums(
            m_, phig_, carry_, sfc_, fx_, up_[2], up_[1]),
        "K12_pbl_flux (leapfrog steps)": lambda: phys.tendency_sums(
            m_, phig_, carry_, sfc_, fx_, up_[2], up_[1], sums_)}
    # 20 calls each: a profile can miss its first launch or two, which
    # is all of a kernel's in a short one
    parts = []
    for nm, fn in schemes.items():
        fn()
        ms, kk_, _ = profile_device(torch, fn, reps=20)
        parts.append(f"{nm} {ms:.4f} ms "
                     f"({sum(e.count for e in kk_) / 20:g} launches)")
    log("  physics by kernel, each profiled alone, per call: "
        + "; ".join(parts) + f" [{card}]")

    run = lambda: run_prediction(hyb, final, date0, N_TIMED)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end, dts = run()
        torch.cuda.synchronize()
        if len(dts) != N_TIMED:
            fail(f"a timed run stopped after {len(dts)} cycles")
        walls.append((time.perf_counter() - t0) / N_TIMED * 1e3)
    walls.sort()
    cycle_ms = walls[2]
    n_prof = 5
    busy, kern, _ = profile_device(
        torch, lambda: run_prediction(hyb, final, date0, n_prof), reps=1)
    busy /= n_prof
    launches = sum(e.count for e in kern) / n_prof
    plain_cycle = sum(e.count for e in kern
                      if kernel_name(e.key) not in ours) / n_prof
    log(f"coupled cycle_ms: {cycle_ms:.4f} median (min {walls[0]:.4f}, max "
        f"{walls[-1]:.4f}) over 5 runs of run_prediction x {N_TIMED} "
        f"cycles, no writer; device busy {busy:.4f} ms/cycle, idle share "
        f"{1 - busy / cycle_ms:.1%} of the median; {launches:g} device "
        f"launches per cycle, {plain_cycle:g} of them plain; "
        f"{6 * 3.6e6 / cycle_ms / 365:.1f} "
        f"sim-years/day [{card}]")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:10]:
        log(f"  top device op {e.key[:70]}: "
            f"{_self_device_us(e) / n_prof / 1e3:.4f} ms/cycle, "
            f"{e.count / n_prof:g} launches/cycle")
    if launches > LAUNCHES_MAX:
        fail(f"{launches:g} device launches per coupled cycle, more than "
             f"{LAUNCHES_MAX}")

    # physical checks after all those cycles
    if not bool(end.safe):
        fail("the gate tripped during the timed coupled runs")
    _, d = hyb.cycle(end, imon, fmon, tyear)
    for nm in ("atmo", "logp", "speedy_atmo", "speedy_logp"):
        if not bool(torch.isfinite(d[nm]).all()):
            fail(f"{nm} is not finite after the coupled runs")
    tmin, tmax = float(d["speedy_atmo"][0].min()), \
        float(d["speedy_atmo"][0].max())
    if not (150.0 <= tmin and tmax <= 350.0):
        fail(f"SPEEDY T outside [150, 350] K: {tmin}..{tmax}")
    log(f"coupled state after {CYCLES + N_TIMED + 1} cycles: "
        f"safe, finite, SPEEDY T {tmin:.3f}..{tmax:.3f} K")

    # -- 8. one coupled cycle with host syncs forbidden -----------------
    lap("7 coupled")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_dbg, _ = hyb.cycle(end, imon, fmon, tyear)
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"the coupled cycle synchronizes with the host: {e}")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("sync debug: one coupled cycle ran under "
        "torch.cuda.set_sync_debug_mode('error')")

    # -- 9. the safety gate ---------------------------------------------
    lap("8 no syncs")
    big = [pk._replace(res=dataclasses.replace(
        pk.res, wout=(pk.res.wout.float() * 1e7).to(torch.bfloat16)))
        for pk in packs]
    hyb_bad = HybridAtmosphere(gcm, hyb.layout, big, ml_only=False,
                               device=dev)
    bs, bd = hyb_bad.cycle(final, imon, fmon, tyear)
    if bool(bs.safe):
        fail("Wout x 1e7 did not trip the gate")
    for nm in ("speedy_atmo", "speedy_logp"):
        if not bool(torch.isfinite(bd[nm]).all()):
            fail(f"{nm} is not finite after the gate tripped")
    _, dts = run_prediction(hyb_bad, final, date0, 5)
    if len(dts) > 2:
        fail(f"run_prediction ran {len(dts)} cycles past the gate")
    # a NaN written into the injected grid (one value of T) trips K19
    a_nan = a_.clone()
    a_nan[0, 3, 10, 20] = float("nan")
    _, safe_nan = hyb.inject_to_speedy(a_nan, l_)
    _, safe_ok = hyb.inject_to_speedy(a_, l_)
    if bool(safe_nan) or not bool(safe_ok):
        fail("a NaN in the injected grid did not trip K19's gate")
    log(f"gate: Wout x 1e7 trips it, SPEEDY's output stays finite, "
        f"run_prediction stopped after {len(dts)} cycle(s); a NaN written "
        f"into the injected grid trips K19 (the same grid without it "
        f"passes)")
    del hyb_bad, big

    # -- 10. training at full width --------------------------------------
    lap("9 gate")
    keep = {}
    results["K14_gram_update"]["launches"] = phase_training(
        torch, gcm, hyb.layout, date0, card, record, atmo_ckpt, keep)
    lap("10 training")

    # -- 11. the paths from files ------------------------------------------
    phase_files(torch, np, gcm, hyb.layout, date0, card)
    lap("11 files")

    # -- 12. the persistent surface and the slab coupler --------------------
    results["K21_slab_couple"]["launches"] = phase_surface(
        torch, np, gcm, hyb, date0, card, record, kernels)
    lap("12 surface")

    # -- 13. the slab ocean ---------------------------------------------------
    results["K22_slab_ocean"]["launches"] = phase_ocean(
        torch, np, gcm, hyb.layout, date0, card, record, kernels, atmo_ckpt)
    lap("13 slab ocean")

    # -- 14. the forecast's options ---------------------------------------------
    (results["K23_sst_by_date"]["launches"],
     results["K2_readout_components"]["launches"]) = phase_options(
        torch, np, hyb, date0, card, record, kernels, work, out_dir)
    lap("14 options")

    # -- 15. vertical localization ------------------------------------------------
    phase_vertical(torch, np, gcm, hyb.layout, hyb, date0, card, kernels,
                   keep.pop("data"))
    lap("15 vertical")

    # -- 16. the optional physics ------------------------------------------------
    for nm, n in phase_physics(torch, np, gcm, date0, card, record,
                               kernels).items():
        results[nm]["launches"] = n
    lap("16 physics")

    # -- 17. the batched prediction loop ------------------------------------------
    for nm, n in phase_dispatch(torch, np, gcm, hyb, date0, card, record,
                                kernels, work).items():
        results[nm]["launches"] = n
    lap("17 dispatch")

    # -- 20. the hub-free sharded cycle ----------------------------------------
    for nm, n in phase_mesh(torch, np, gcm, hyb, date0, card, kernels,
                            record).items():
        results[nm]["launches"] = n
    lap("20 mesh")

    # -- 18. the config-driven entry point, the earlier phases' hybrids
    #       freed: its subprocess trains at full width
    hyb = packs = s = state0 = final = end = s_dbg = step_args = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before phase 18: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
        f"reserved in this process")
    phase_cli(torch, np, card, kernels, work)
    lap("18 CLI")

    # -- 19. the experiment programs
    phase_experiments(torch, np, card, kernels, work)
    lap("19 experiments")

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        f"card check [{card}]; seconds a phase: {json.dumps(phase_s)}")
    order = (list(kernels) + ["K14_gram_update", "K2_readout_components"]
             + list(DISPATCH_FORMS) + list(MESH_FORMS))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys}
                                  for n in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
