#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, started together), holds each against its plain
PyTorch version on the card, and drives the port's three paths:

* tiered-KV serving (``repro_torch.launch.serve``, paged decode attention,
  K2) with qwen2-1.5b at full width: a few requests to completion;
* ring-cache serving (``runtime/serve.py``: ``LM.prefill``/``LM.decode``,
  flash attention in the prefill, K3) with h2o-danube-1.8b at full width
  and depth: two 8192-token prompts, then 32 greedy decode steps, so the
  sliding-window ring wraps;
* the decoder-only families through the same serving steps (ring, MLA
  latent and Mamba caches; the MoE, MLA and Mamba-2 mixers in plain
  PyTorch, as the reference computes them outside any Pallas kernel; K3 in
  every attention block's prefill): the six smoke configs card vs CPU,
  then granite-moe-1b-a400m, mamba2-1.3b, qwen2-7b and qwen3-32b at full
  width and depth and jamba-1.5-large-398b and deepseek-v3-671b at full
  width with their depth cut to fit one card, 1,024-2,048-token prompts
  and 16-32 greedy decode steps, granite and mamba2 also in fp32 against
  their own forward;
* the encoder-decoder and vision families through the same steps
  (``models/encdec.py``: the encoder over precomputed frames, cross K/V
  computed once at prefill; internvl2's patch embeddings before the text;
  K3 in every decoder layer's prefill): the two smoke configs card vs CPU,
  then whisper-small whole at 16 clips x 1,500 frames with a 4-token
  prompt and 124 greedy steps, and internvl2-26b whole at 2 x (1,024
  patches + 1,024 tokens) and 32 steps, each also in fp32 (internvl2 cut
  to 24 layers) against its own forward;
* the model meshes (``launch/mesh.py``, ``sharding/rules.py::shard_map``
  on a (1, 1) and a (2, 2) mesh of the one card): granite-moe-1b-a400m's
  prefill and decode through each sharded MoE path against the dense
  path, and its capacity drops against a plain count;
* the sharded steps (``sharding/spmd.py``: parameters, AdamW state and
  caches placed on a 2 x 2 mesh's devices by the reference's spec trees,
  ``runtime/train.py::jit_train_step``, ``runtime/serve.py::
  jit_prefill_step`` and ``jit_decode_step``): qwen2-1.5b's smoke config
  in fp32 against the unsharded steps, then qwen2-1.5b whole training at
  ``TRAIN_FULL``'s batch and qwen2-7b whole served (K3 in every
  coordinate's prefill), also with the sequence-sharded cache (SP,
  ``seq_shard_kv``: the ring's slots over the mesh, the decode's softmax
  merged across them) at B 4 and B 1, fp32 cuts of qwen2-7b and of
  danube's wrapped window gated against the unsharded steps, and
  granite-moe-1b-a400m whole trained and served on the mesh through each
  MoE dispatch path on placed arrays, its drops against a plain count, on
  four cards where four are visible (then qwen2-7b also trains whole
  across them), else on the card listed four times; mamba2-1.3b whole,
  deepseek-v3's serve and train cuts (MLA, the MTP head) and jamba's
  blocks 3-4 (Mamba-2, MoE, attention with K3 a coordinate) trained and
  served on the mesh, fp32 cuts gated against the unsharded steps;
  whisper-small whole (the encoder-decoder: its cross K/V written once at
  prefill, split on their frames under SP) and internvl2-26b (the vision
  frontend; its first 24 layers served, its first 4 trained) trained and
  served on the mesh, fp32 cuts gated against the unsharded steps, and
  Pond's two-phase step on placed parameters (M18d: the AdamW state in
  pinned host memory, one buffer a distinct block) beside the fused placed
  step on deepseek-v3's train cut, bit for bit;
* Pond's provisioning loop (``core/cluster_sim.py::savings_analysis`` over
  ``core/replay_engine.py::CompiledReplay``, the event sweep K1) on a
  cluster row of 256 servers with 16-socket pools and a 7-day trace: the
  all-local and static-pool provisioning, held to the reference's results;
* Pond's own policy priced over a seed batch (Fig 21's path:
  ``cluster_sim.savings_analysis_batched`` over
  ``replay_engine.CompiledReplayBatch``, K1's trace axis, with the
  predictors and a control plane a trace) on the same cluster row and
  three 7-day traces: all-local, static and ``pond``, held to the
  reference's results;
* Pond's sensitivity and latency grids (``core/policy_engine.py``'s grid
  axis, ``core/latency_engine.py``): Fig 17's 9-setting policy grid on the
  same row and traces, its 27 cells priced in one
  ``savings_analysis_batched`` through K1's trace axis and held to the
  reference's results, and Fig 16's zNUMA spill grid at the width of the
  qwen2-1.5b paged pool through the spill sweep kernel (K6), with Figs 4,
  7, 18 and 20's grids on the card held to their numpy backend;
* Pond's failure layer (``replay_engine.CompiledReplay.availability`` and
  ``CompiledReplayBatch.availability``, the failure sweep K5) on the same
  cluster row and trace: ``benchmarks/fig_availability.py``'s
  savings-vs-availability frontier (four failure rates x six DRAM sizes,
  both mitigations) and one trace's per-failure distribution, held to the
  reference's results;
* Pond's fleet topologies (``CompiledReplay.reject_rates_fleet`` and
  ``CompiledReplayBatch.reject_rates_fleet``, the pod sweep K4) on the same
  cluster row and trace: ``benchmarks/fig_topology.py``'s full frontier
  (six DRAM sizes x four pool budgets x eight pod topologies at equal pool
  hardware) in one launch, and over three traces in one more, held to the
  reference's results;
* Pond's streaming engines (``CompiledReplayStream``,
  ``CompiledReplayStreamBatch``: shards with the state carried on the card,
  one K1 or K4 launch a shard, shard i + 1 uploading while shard i runs):
  the reference's 100,000-VM acceptance trace, the provisioning loop, Fig
  21's seed batch and the topology frontier past a shard budget, held to
  the monolithic engine and the reference's results;
* Pond's provisioning surface on trace files (``traces.iter_trace_chunks``,
  ``load_trace_file``, the numpy divergence-window backend of
  ``CompiledReplay.reject_rates``): a 250,000-VM Azure-format dump on the
  same cluster row streamed from its file through K1, a shard a launch,
  held to the monolithic engine and the reference's rates; the fixture and
  a fractional copy of it through ``savings_analysis`` (the fractional one
  with no K1 launch), and the numpy backend beside K1 at full width;
* Pond's observability layer (``core/obs.py``): the provisioning sweep
  and its stream at full width with tracing off and on (the same rates;
  the stream's upload, wait and compute spans a shard, its overlap ratio,
  the bytes it copied), pond's decisions split into their four stages,
  ingestion's counters over a 50,000-VM dump, and the run's Chrome trace;
* ``devices=`` on every Pond engine (each call again with ``devices="all"``
  and ``devices=1``, ``==`` and the same launches; on two or more cards
  the split, timed beside one card);
* the training path (``launch/train.py``'s loop: ``LM.forward``, the
  blocked attention's hand-written backward, chunked cross-entropy, AdamW)
  card vs CPU on qwen2-1.5b's smoke config, then qwen2-1.5b at full width
  and depth: fused steps with the AdamW state on the card, Pond's
  two-phase steps with the state pinned in host memory (fp32 and int8
  moments) and a checkpoint round trip.  No kernel of this
  path is a TPU kernel's counterpart: the reference trains through its
  plain blocked attention, and so does the port;
* the families training through the same steps: each family's smoke
  config card vs CPU, then granite-moe-1b-a400m, mamba2-1.3b and
  whisper-small whole, internvl2-26b's first 4 layers and deepseek-v3's
  first dense MLA layer with its MTP head at published widths, fused
  steps, and for deepseek two-phase steps from the same parameters;
* the dry run (``launch/dryrun.py``): the reference's 10 archs x 4 shapes
  on the single-pod mesh of meta devices, counted in a process of its own
  beside the card's phases and never touching the card, and two real
  training steps counted on the card (``launch/op_analysis.py``) against
  their meta twins: FLOPs and bytes ``==``, the card's peak memory against
  the counted live bytes.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after, which shows that it went through its kernel.
Every phase prints one JSON line; any failure ends the process with a
non-zero exit code.  Nothing runs on the CPU in place of the card: without
a CUDA device the script exits at once.  It imports only the port
(``repro_torch``), never the reference package.

The last three lines are: the ``{"kernels": [...]}`` record, the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
# At the full-width shape the long rows average ~2000 values of V, so an
# output is ~0.03 in size and 2e-2 would pass a wrong one: there bf16 is held
# to a few times its measured error (4.9e-4, one rounding of the output).
TOL_FULL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}
# K3 (bf16, tensor cores) at the full-width shape is held against the
# blocked plain version run in fp32 on the same bf16 inputs, elementwise
# within kernels/flash_attention/ref.py::bf16_bound:
#   1e-5 + 2**-8 |plain| + 2**-8 (P |V|).
# The kernel rounds p to bf16 before p @ V (as SDPA does), which moves an
# output by at most 2**-9 sum(p |v|), and rounds its output once (2**-9
# |out|); each 2**-8 leaves a factor of 2 for the order of the sums.
LAYERS = 28                      # qwen2-1.5b: launches per decode step
DANUBE_LAYERS = 24               # h2o-danube-1.8b: K3 launches per prefill
K3_FULL = dict(b=2, s=8192, hq=32, hkv=8, d=80, window=4096)
RING_BATCH, RING_PROMPT, RING_STEPS = 2, 8192, 32
FULL = dict(b=8, hq=12, hkv=2, d=128, page=16, max_len=2048, num_pages=1280)
# Pond's provisioning loop at full width: a cluster row of 256 servers x 64
# cores with 16-socket pools (32 groups of 8 servers), 4.75 GB a core, a
# 7-day trace at 0.8 core utilisation (Population seed 0, trace seed 2):
# 44,862 VMs, 89,724 events.
PROV_FULL = dict(n_servers=256, days=7, seed=2, static_pool_frac=0.30)
# The reference's results for it, from the JAX package on a CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   from repro.core import cluster_sim as cs, traces
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   h = 7 * 86400; n = cs.arrivals_for_util(cfg, 0.8, h)
#   vms = traces.Population(seed=0).sample_vms(n, h, seed=2, start_id=10**6)
#   c = {}; print(cs.savings_analysis(vms, cfg, 'local', cache=c))
#   print(cs.savings_analysis(vms, cfg, 'static', static_pool_frac=0.30,
#                             cache=c))"
_PROV_COMMON = dict(baseline_server_gb=384.0, n_servers=256, n_groups=32,
                    mitigations=0, tier_pricing=None)
PROV_FULL_WANT = {
    "local": dict(name="local", server_gb=384.0, pool_group_gb=0.0,
                  mispredictions=0.0, reject_rate=0.0, **_PROV_COMMON),
    "static": dict(name="static", server_gb=270.0,
                   pool_group_gb=369.37278106508876,
                   mispredictions=0.04284806740671392,
                   reject_rate=0.004993089920199724, **_PROV_COMMON)}
# Pond's own policy over a seed batch at full width, with
# benchmarks/fig21_e2e.py's settings: PROV_FULL's cluster and trace length,
# trace seeds 2, 3, 4; the models trained on 2,000 VMs over 10 days (trace
# seed 1) as benchmarks/common.py trains them; a static pool of 0.15.
POND_BATCH_FULL = dict(seeds=(2, 3, 4), static_pool_frac=0.15,
                       train_vms=2000, train_days=10, train_seed=1)
# The reference's results for it, from the JAX package on a CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   import numpy as np
#   from repro.core import cluster_sim as cs, traces
#   from repro.core.control_plane import ControlPlane, ControlPlaneConfig
#   from repro.core.pool_manager import PoolManager
#   from repro.core.predictors.models import (LatencySensitivityModel,
#                                             UntouchedMemoryModel)
#   pop = traces.Population(seed=0)
#   tr = pop.sample_vms(2000, 10 * 86400, seed=1)
#   li = LatencySensitivityModel(pdm=0.05).fit(traces.pmu_matrix(tr),
#                                              traces.slowdowns(tr, 182))
#   hist = traces.build_history(tr)
#   um = UntouchedMemoryModel(0.05).fit(traces.metadata_features(tr, hist),
#                                       np.array([v.untouched for v in tr]))
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   h = 7 * 86400; n = cs.arrivals_for_util(cfg, 0.8, h)
#   vl = [pop.sample_vms(n, h, seed=s, start_id=10**6) for s in (2, 3, 4)]
#   c = {}
#   for p in ('local', 'static', 'pond'):
#       cps = [ControlPlane(ControlPlaneConfig(li_threshold=0.05,
#                                              um_quantile=0.05), li, um,
#                           PoolManager(pool_gb=4096, buffer_gb=64),
#                           history=dict(hist)) for _ in vl]
#       print(cs.savings_analysis_batched(vl, cfg, p, control_planes=cps,
#                                         static_pool_frac=0.15, cache=c))"
#   (its tier_pricing is None on this path)
_POND_ROWS = {
    "local": [(384.0, 0.0, 0.0, 0, 0.0)] * 3,
    "static": [(330.0, 175.35936, 0.014433150550577326, 0,
                0.004970799340198832),
               (330.0, 166.2752, 0.014605902545584236, 0,
                0.004970799340198832),
               (330.0, 206.664, 0.014160090945566403, 0,
                0.004903927600196157)],
    "pond": [(228.0, 662.4464, 0.009523650305380946, 3221,
              0.00494850876019794),
             (222.0, 614.4192, 0.009289599215371584, 3341,
              0.004903927600196157),
             (228.0, 632.2848000000001, 0.008565155365342607, 3090,
              0.004970799340198832)]}
POND_BATCH_WANT = {
    policy: [dict(name=policy, server_gb=sgb, pool_group_gb=pgb,
                  baseline_server_gb=384.0, n_servers=256, n_groups=32,
                  mispredictions=mis, mitigations=mit, reject_rate=rate,
                  tier_pricing=None)
             for sgb, pgb, mis, mit, rate in rows]
    for policy, rows in _POND_ROWS.items()}
# K1's operations bound: int32 operations per (ARRIVE event, lane, server)
# that the step needs — pooled mask 8 (fc >= c, um + l, <= sgb, up[g] + p,
# <= pgb, two ANDs, the score select), fallback mask 4 (um + m, <=, AND,
# select), two first-minimum reductions 3 each (compare, two selects) — over
# H100's int32 rate, 64 int32 lanes an SM a clock.
K1_OPS_PER_ARRIVE_SERVER = 18
INT32_LANES_PER_SM = 64
# Fig 17's policy grid at full width, benchmarks/fig17_sensitivity.py's
# axes on POND_BATCH_FULL's row: its three traces, its latency model and
# history; the UM models fitted on its 2,000 training VMs a tau, the
# li-thresholds calibrated there from the FP targets; 9 settings x 3 traces
# = 27 cells priced in one savings_analysis_batched (decisions of the numpy
# backend, bitwise the reference's).
FIG17_FULL = dict(taus=(0.02, 0.05, 0.2), fp_targets=(0.005, 0.02, 0.05),
                  pdm=0.05)
# Figs 18 and 20's taus (benchmarks/fig18_um_model.py, fig20_combined.py)
FIG18_TAUS = (0.02, 0.05, 0.1, 0.2)
FIG20_TAUS = (0.01, 0.02, 0.05, 0.1, 0.2)
# The reference's settings and results for it, from the JAX package on a
# CPU (each trace's cells priced in one call; a cell's result does not
# depend on the other traces of a batch):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   import dataclasses, numpy as np
#   from repro.core import cluster_sim as cs, traces, policy_engine as pe
#   from repro.core.predictors.models import LatencySensitivityModel
#   pop = traces.Population(seed=0)
#   tr = pop.sample_vms(2000, 10 * 86400, seed=1)
#   pmu, slw = traces.pmu_matrix(tr), traces.slowdowns(tr, 182)
#   li = LatencySensitivityModel(pdm=0.05).fit(pmu, slw)
#   hist = traces.build_history(tr)
#   ums = pe.fit_um_grid(traces.metadata_features(tr, hist),
#                        np.array([v.untouched for v in tr]),
#                        (0.02, 0.05, 0.2))
#   st = pe.make_grid(taus=(0.02, 0.05, 0.2), pdms=(0.05,),
#                     fp_targets=(0.005, 0.02, 0.05), li_model=li, pmu=pmu,
#                     slowdowns=slw)
#   print([dataclasses.astuple(s) for s in st])
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   h = 7 * 86400; n = cs.arrivals_for_util(cfg, 0.8, h)
#   vl = [pop.sample_vms(n, h, seed=s, start_id=10**6) for s in (2, 3, 4)]
#   grid = pe.grid_decisions(vl, st, li, ums, hist, backend='numpy')
#   for k in range(3):
#       for r in cs.savings_analysis_batched(
#               [vl[k]] * 9, cfg, 'pond-grid',
#               decisions=[grid[s][k] for s in range(9)]):
#           print((r.server_gb, r.pool_group_gb, r.mispredictions,
#                  r.mitigations, r.reject_rate))"
#   (the baseline is 384.0 GB on every trace: the cores-bound reject floor
#   is 0.0 for any decisions of a trace, as for POND_BATCH_FULL's local
#   rows; tier_pricing is None on this path)
FIG17_SETTINGS_WANT = [(tau, 0.05, th, fp) for tau in (0.02, 0.05, 0.2)
                       for th, fp in ((0.18, 0.005), (0.23, 0.02),
                                      (0.62, 0.05))]
_FIG17_ROWS = {  # trace seed: (server_gb, pool_group_gb, mispredictions,
    # mitigations, reject_rate) a setting, in FIG17_SETTINGS_WANT's order
    2: [
        (261.5, 685.9353600000001, 0.034968347376398735, 887, 0.004970799340198832),
        (261.5, 718.7558400000001, 0.038835763006553434, 809, 0.004993089920199724),
        (259.0, 785.4105600000001, 0.06000066871740003, 669, 0.004970799340198832),
        (219.0, 1091.2, 0.04003388168160135, 1979, 0.004881637020195266),
        (272.0, 693.7212800000001, 0.04386786144175472, 1838, 0.00494850876019794),
        (270.0, 776.84544, 0.06475413490259016, 1535, 0.004993089920199724),
        (195.0, 1142.2880000000002, 0.05828986670233159, 5742, 0.004993089920199724),
        (195.0, 1156.8230400000002, 0.061967812402478714, 5355, 0.004926218180197049),
        (195.0, 1241.6716800000004, 0.08217979581828719, 4690, 0.00494850876019794),],
    3: [
        (261.5, 601.9379200000001, 0.03515224466140609, 891, 0.00494850876019794),
        (259.0, 598.0128000000001, 0.03929271989657171, 809, 0.004993089920199724),
        (278.0, 648.648, 0.05976661762739066, 684, 0.004970799340198832),
        (272.0, 605.8393600000002, 0.040072890196602914, 1944, 0.00494850876019794),
        (270.0, 642.99648, 0.04418550220676742, 1794, 0.004970799340198832),
        (262.0, 679.9027200000002, 0.06445321207257813, 1539, 0.00494850876019794),
        (256.0, 595.5622400000002, 0.05745396995229816, 5474, 0.004993089920199724),
        (192.0, 1149.2870400000002, 0.06142169319245687, 5128, 0.00494850876019794),
        (183.0, 1238.5318400000003, 0.08094824127323794, 4516, 0.00494850876019794),],
    4: [
        (237.0, 979.8451200000002, 0.03456154429138246, 771, 0.00494850876019794),
        (237.0, 1016.1324800000001, 0.03864629307654585, 682, 0.004970799340198832),
        (237.0, 1097.9356800000003, 0.05958272034238331, 568, 0.004792474700191699),
        (219.0, 1078.4320000000002, 0.039303865186572154, 1799, 0.004993089920199724),
        (216.0, 1123.75296, 0.04336075074673443, 1642, 0.004970799340198832),
        (207.0, 1214.7696, 0.0641077080825643, 1398, 0.00494850876019794),
        (195.0, 1124.53824, 0.055642860327225714, 5242, 0.004993089920199724),
        (195.0, 1113.8572800000002, 0.05956600240738264, 4839, 0.004970799340198832),
        (192.0, 1190.7273600000003, 0.07982813962819313, 4249, 0.004970799340198832),],
}
FIG17_WANT = [dict(name="pond-grid", server_gb=sgb, pool_group_gb=pgb,
                   baseline_server_gb=384.0, n_servers=256, n_groups=32,
                   mispredictions=mis, mitigations=mit, reject_rate=rate,
                   tier_pricing=None)
              for si in range(9) for seed in (2, 3, 4)
              for sgb, pgb, mis, mit, rate in [_FIG17_ROWS[seed][si]]]
# Fig 16's spill grid at full width (K6): benchmarks/fig16_spill.py's
# paged-KV streams (3-6 pages a request, the oldest requests retire past
# the peak) at the qwen2-1.5b paged pool of serve_full, 1,280 pages, 16,384
# requests a stream, seeds 3-6 (147,020-147,562 events, 73,510-73,781 keys,
# a peak demand of 1,286 pages); local tiers of 16, 32, ..., 1,280 pages
# and a 1,024-page pool: 80 config lanes, a 23.6 MB tier map.
SPILL_FULL = dict(seeds=(3, 4, 5, 6), n_requests=16384, peak_pages=1280,
                  local_step=16, num_pool=1024)
# K6's operations bound: int32 operations per (event, lane) that the step
# needs — ALLOC 8 (free_l > 0; free_p > 0 and the choice; two decrements;
# three counter adds), FREE 4 (two compares, two adds) — over the card's
# int32 rate, as K1's.
K6_OPS_PER_ALLOC_LANE = 8
K6_OPS_PER_FREE_LANE = 4
# K6's and K5's timings start after a wait of this long on the card, so
# that the host has enqueued every timed sweep before the first one starts:
# the CUDA events then time the device's work, not the host's dispatch
# (checked: ``_card_ms`` fails if enqueueing took longer)
CARD_WAIT_MS = 50
# Pond's failure layer at full width (``AVAIL_FULL``): PROV_FULL's row and
# trace (256 servers, 32 domains of 8, 7 days, seed 2) with the static 0.25
# decisions of benchmarks/fig_availability.py, four failure schedules (MTBF
# 2, 8, 24, 96 h, a 1,800 s repair, seeds 0-3: 2,124 / 633 / 242 / 49
# FAILs) and six server sizes, 1.0 ... 0.5 of 304 GB, the pool
# ceil(peak_pool_demand) = 15,057 GB.
AVAIL_FULL = dict(mtbf_h=(2, 8, 24, 96), repair_s=1800.0,
                  dram_fracs=(1.0, 0.9, 0.8, 0.7, 0.6, 0.5),
                  static_pool_frac=0.25, single_mtbf_h=24)
# The reference's results for it, from the JAX package on a CPU (rejects =
# reject_rate x 44,862 VMs; per-failure rows: the single-trace call at MTBF
# 24 h, remigrate, as int32, by SHA-1):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   import numpy as np
#   from repro.core import cluster_sim as cs, traces, replay_engine as re
#   from repro.runtime.fault import FailureSchedule
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   h = 7 * 86400; n = cs.arrivals_for_util(cfg, 0.8, h)
#   vms = traces.Population(seed=0).sample_vms(n, h, seed=2, start_id=10**6)
#   dec, _ = cs.policy_decisions(vms, 'static', static_pool_frac=0.25)
#   s = [FailureSchedule.generate(h, 32, m * 3600., 1800., seed=i)
#        for i, m in enumerate((2, 8, 24, 96))]
#   e = [re.CompiledReplay(vms, dec, cfg, failure_schedule=x) for x in s]
#   srv = np.round(304 * np.array([1, .9, .8, .7, .6, .5]))
#   pool = np.full(6, np.ceil(e[0].peak_pool_demand()))
#   for m in ('remigrate', 'kill'):
#       print(re.CompiledReplayBatch(e).availability(srv, pool, m,
#                                                    backend='jax'))
#   print(e[2].availability(srv, pool, 'remigrate', backend='jax'))"
AVAIL_FULL_WANT = {
    "remigrate": dict(
        rejects=[[0, 254, 254, 254, 929, 929]] * 3
        + [[0, 254, 254, 254, 929, 933]],
        affected=[[26663, 26687, 26640, 26555, 26019, 26048],
                  [13768, 13737, 13722, 13852, 13297, 13385],
                  [6983, 6955, 6775, 6955, 6800, 6994],
                  [1762, 1701, 1734, 1651, 1657, 1687]],
        killed=[[3994, 6489, 12192, 17877, 22413, 24711],
                [2400, 3908, 7113, 10408, 12083, 12881],
                [1415, 2198, 3851, 5303, 6073, 6763],
                [333, 599, 1000, 1233, 1427, 1635]],
        remigrated=[[22669, 20198, 14448, 8678, 3606, 1337],
                    [11368, 9829, 6609, 3444, 1214, 504],
                    [5568, 4757, 2924, 1652, 727, 231],
                    [1429, 1102, 734, 418, 230, 52]],
        lost_vm_minutes=[
            [1585956, 2653551, 4838481, 7347021, 9151652, 10065488],
            [1249595, 2127814, 3840970, 5551173, 6308525, 6760301],
            [871293, 1360542, 2462193, 3374601, 3874409, 4223994],
            [229412, 493806, 751361, 1016797, 1089392, 1127547]]),
    "kill": dict(
        rejects=[[0, 254, 254, 254, 929, 929]] * 3
        + [[0, 254, 254, 254, 929, 931]],
        affected=[[26480, 26358, 26354, 26331, 25979, 26170],
                  [13615, 13454, 13569, 13357, 13389, 13306],
                  [6899, 6992, 6991, 7176, 6863, 6822],
                  [1592, 1742, 1734, 1706, 1648, 1680]],
        killed=[[26480, 26358, 26354, 26331, 25979, 26170],
                [13615, 13454, 13569, 13357, 13389, 13306],
                [6899, 6992, 6991, 7176, 6863, 6822],
                [1592, 1742, 1734, 1706, 1648, 1680]],
        remigrated=[[0] * 6] * 4,
        lost_vm_minutes=[
            [10752375, 10683620, 10672280, 10697139, 10543356, 10564102],
            [7123568, 7021083, 7052208, 7049191, 6993344, 7000675],
            [4465709, 4421356, 4455852, 4440454, 4331015, 4426625],
            [1255563, 1315961, 1298163, 1364690, 1273638, 1231231]])}
AVAIL_FULL_WANT_SINGLE = dict(
    shape=[242, 6], sha1="6604e5470fe2f0327c0d4c15399384f713714123",
    affected=[6983, 6955, 6775, 6955, 6800, 6994], max=145)
# K5's operations bound: K1's ARRIVE term, plus one int32 operation a
# (FAIL, slot, lane) — reading each slot of the lane's column once, the
# least a FAIL pass does to find the affected VMs
K5_OPS_PER_FAIL_SLOT_LANE = 1
# Pond's fleet topologies at full width (``TOPO_FULL``):
# benchmarks/fig_topology.py --full widened to PROV_FULL's row and trace (256
# servers, 16-socket pools, 4.75 GB a core, 7 days, trace seed 2) with its
# static 0.25 decisions; its eight topologies at 256 servers (partitioned
# pods of 4 and 8, one pool, overlapping rows of 2 and 3, sparse rows of 2
# over 4 and 6 pods, sparse rows of 3 with orphan servers: up to 64 pods,
# rows of up to 3), six server sizes (1.0 ... 0.5 of 304 GB) and four pool
# totals (ceil(f x 15,057) GB, f = 0.125, 0.25, 0.5, 1.0; 15,057 GB the peak
# pool demand), split over each topology's pods: 6 x 4 x 8 = 192 lanes in
# one K4 launch; the same grid over trace seeds 2, 3, 4 (POND_BATCH_FULL's)
# in one CompiledReplayBatch launch.  The scalar oracle prices the tightest
# corner (0.5 of the DRAM, the 1,883 GB pool) of every topology.
TOPO_FULL = dict(seeds=(2, 3, 4), static_pool_frac=0.25,
                 oracle_corner=(0.5, 1883.0))
# The reference's reject counts for it (rate x VMs; 44,862, 44,862 and
# 44,862 VMs), from the JAX package on a CPU:
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "
#   import numpy as np
#   from benchmarks.fig_topology import _topologies, _grid
#   from repro.core import cluster_sim as cs, traces, replay_engine as re
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   h = 7 * 86400; n = cs.arrivals_for_util(cfg, 0.8, h)
#   pop = traces.Population(seed=0)
#   vl = [pop.sample_vms(n, h, seed=s, start_id=10**6) for s in (2, 3, 4)]
#   e = [re.CompiledReplay(v, cs.policy_decisions(
#            v, 'static', static_pool_frac=0.25)[0], cfg) for v in vl]
#   peak = float(np.ceil(e[0].peak_pool_demand()))
#   sgb, caps, topos, _ = _grid(_topologies(256, False),
#                               [1.0, .9, .8, .7, .6, .5],
#                               [np.ceil(f * peak)
#                                for f in (.125, .25, .5, 1.)], 304.0)
#   r = e[0].reject_rates_fleet(sgb, caps, topos, backend='jax')
#   print(np.rint(r * n).astype(int).tolist())
#   r = re.CompiledReplayBatch(e).reject_rates_fleet(sgb, caps, topos,
#                                                    backend='jax')
#   print(np.rint(r * n).astype(int).tolist())"
#   (lane = DRAM size x 32 + pool total x 8 + topology, in those orders)
TOPO_FULL_WANT = dict(
    single=[
        254, 254, 253, 254, 253, 254, 253, 253, 254, 252, 252, 254,
        252, 254, 252, 252, 246, 244, 215, 246, 241, 246, 238, 241,
        49, 19, 0, 40, 1, 44, 3, 129, 254, 254, 254, 254,
        254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
        254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
        254, 254, 254, 254, 929, 929, 925, 929, 925, 929, 925, 925,
        929, 922, 919, 929, 921, 929, 922, 922, 894, 887, 765, 895,
        837, 894, 865, 840, 259, 254, 254, 254, 254, 254, 254, 373,
        929, 935, 945, 932, 944, 933, 934, 935, 929, 922, 919, 929,
        922, 931, 922, 922, 895, 891, 765, 893, 843, 894, 858, 847,
        258, 254, 254, 255, 254, 260, 254, 572, 1656, 1667, 1704, 1697,
        1744, 1693, 1710, 1732, 1555, 1561, 1554, 1562, 1605, 1573, 1599, 1635,
        1483, 1472, 1306, 1485, 1378, 1477, 1398, 1390, 929, 929, 929, 929,
        929, 929, 929, 1176, 2346, 2354, 2475, 2369, 2407, 2369, 2374, 2446,
        1971, 1981, 2038, 1930, 2068, 1970, 2031, 2108, 1689, 1615, 1474, 1667,
        1544, 1643, 1566, 1583, 1017, 1017, 1017, 1017, 1017, 1017, 1017, 1455,
    ],
    batch=[[
        254, 254, 253, 254, 253, 254, 253, 253, 254, 252, 252, 254,
        252, 254, 252, 252, 246, 244, 215, 246, 241, 246, 238, 241,
        49, 19, 0, 40, 1, 44, 3, 129, 254, 254, 254, 254,
        254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
        254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
        254, 254, 254, 254, 929, 929, 925, 929, 925, 929, 925, 925,
        929, 922, 919, 929, 921, 929, 922, 922, 894, 887, 765, 895,
        837, 894, 865, 840, 259, 254, 254, 254, 254, 254, 254, 373,
        929, 935, 945, 932, 944, 933, 934, 935, 929, 922, 919, 929,
        922, 931, 922, 922, 895, 891, 765, 893, 843, 894, 858, 847,
        258, 254, 254, 255, 254, 260, 254, 572, 1656, 1667, 1704, 1697,
        1744, 1693, 1710, 1732, 1555, 1561, 1554, 1562, 1605, 1573, 1599, 1635,
        1483, 1472, 1306, 1485, 1378, 1477, 1398, 1390, 929, 929, 929, 929,
        929, 929, 929, 1176, 2346, 2354, 2475, 2369, 2407, 2369, 2374, 2446,
        1971, 1981, 2038, 1930, 2068, 1970, 2031, 2108, 1689, 1615, 1474, 1667,
        1544, 1643, 1566, 1583, 1017, 1017, 1017, 1017, 1017, 1017, 1017, 1455,
    ], [
        248, 248, 245, 248, 245, 248, 245, 245, 248, 245, 245, 248,
        245, 248, 245, 245, 240, 239, 213, 240, 233, 239, 236, 236,
        8, 0, 0, 6, 0, 7, 0, 124, 248, 248, 248, 248,
        248, 248, 248, 248, 248, 248, 248, 248, 248, 248, 248, 248,
        248, 248, 248, 248, 248, 248, 248, 248, 248, 248, 248, 248,
        248, 248, 248, 248, 866, 866, 862, 866, 863, 866, 863, 863,
        866, 859, 851, 866, 859, 866, 858, 858, 830, 825, 714, 830,
        782, 831, 796, 784, 248, 248, 248, 248, 248, 248, 248, 379,
        866, 866, 870, 868, 866, 866, 869, 866, 866, 859, 851, 866,
        859, 866, 858, 859, 830, 825, 714, 830, 779, 830, 788, 780,
        248, 248, 248, 248, 248, 248, 248, 557, 1598, 1644, 1719, 1613,
        1714, 1633, 1672, 1719, 1512, 1511, 1527, 1523, 1561, 1530, 1564, 1559,
        1467, 1449, 1265, 1463, 1354, 1465, 1377, 1349, 866, 866, 866, 866,
        866, 866, 866, 1139, 2432, 2479, 2556, 2532, 2594, 2525, 2578, 2563,
        2035, 2034, 2144, 2053, 2144, 2044, 2136, 2191, 1670, 1625, 1450, 1635,
        1479, 1631, 1529, 1545, 921, 921, 921, 921, 921, 921, 921, 1390,
    ], [
        303, 303, 301, 303, 301, 303, 301, 301, 303, 298, 297, 303,
        298, 303, 298, 298, 297, 297, 262, 297, 290, 297, 292, 291,
        34, 3, 0, 28, 0, 20, 0, 158, 303, 303, 303, 303,
        303, 303, 303, 303, 303, 303, 303, 303, 303, 303, 303, 303,
        303, 303, 303, 303, 303, 303, 303, 303, 303, 303, 303, 303,
        303, 303, 303, 303, 921, 921, 918, 921, 919, 921, 919, 919,
        921, 916, 907, 921, 913, 921, 913, 913, 890, 889, 773, 889,
        856, 892, 850, 848, 303, 303, 303, 303, 303, 303, 303, 435,
        921, 921, 923, 922, 920, 921, 923, 922, 921, 916, 907, 921,
        913, 921, 914, 915, 891, 885, 773, 890, 852, 890, 860, 850,
        303, 303, 303, 303, 303, 303, 303, 650, 1669, 1682, 1792, 1702,
        1807, 1736, 1821, 1830, 1534, 1540, 1579, 1535, 1608, 1561, 1588, 1635,
        1487, 1475, 1281, 1481, 1384, 1479, 1406, 1364, 921, 921, 921, 921,
        921, 921, 921, 1191, 2525, 2598, 2696, 2582, 2663, 2561, 2656, 2627,
        2195, 2197, 2234, 2175, 2276, 2154, 2302, 2326, 1756, 1715, 1575, 1703,
        1586, 1689, 1612, 1586, 1004, 1004, 1004, 1004, 1004, 1004, 1004, 1430,
    ]])
# Pond's streaming engines (``CompiledReplayStream``,
# ``CompiledReplayStreamBatch``: shards with the state carried on the card,
# K1 and K4 a shard) at full width, four configurations:
# (a) the reference's own 100,000-VM acceptance trace
#     (tests/test_replay_stream.py::test_stream_100k_vm_trace_bit_exact_and_
#     memory_bounded: 112 servers, 16-socket pools, 30 days, numpy seed 11,
#     a static floor of 0.25 a VM) at 32,768 events a shard, its four
#     candidates held to the monolithic engine's K1;
# (b) PROV_FULL's trace through savings_analysis at 16,384 events a shard,
#     held to the reference's streamed contract (the baseline is
#     PROV_FULL_WANT's, the optimum feasible and within peak_pool_demand);
# (c) POND_BATCH_FULL's three traces through savings_analysis_batched at
#     16,384 events a shard: the nine PolicyResults are POND_BATCH_WANT's
#     (the reference's streamed batch is bit-exact);
# (d) TOPO_FULL's 192 lanes and its 3 x 192 batch through
#     reject_rates_fleet on streams at 16,384: TOPO_FULL_WANT's counts.
STREAM_FULL = dict(
    acceptance=dict(n_vms=100_000, days=30, seed=11, n_servers=112,
                    pool_sockets=16, gb_per_core=4.75, floor=0.25,
                    budget=32_768, server=[768.0, 44.0, 30.0, 36.0],
                    pool=[6144.0, 512.0, 6144.0, 0.0]),
    budget=16_384,
    # the sweep timed beside its monolithic twin in (b) and (c): 16 lanes
    # from the static optimum to the baseline, pools 0 ... 800 GB
    timed_server=(270.0, 384.0), timed_pool=(0.0, 800.0), timed_lanes=16)
# Pond's provisioning surface on a trace file at full width (phase
# ingest_full): benchmarks/azure_e2e.py --full's stand-in dump (synth_dump:
# 250,000 VMs over 30 days, numpy seed 7, the fetch script's schema,
# arrival-sorted CSV.gz) on PROV_FULL's cluster row (256 servers x 64
# cores, 16-socket pools, 4.75 GB a core; the benchmark's 16 servers would
# reject nearly every VM), read 8,192 VMs a chunk, static 0.30, streamed at
# the benchmark's --full budget of 65,536 events a shard (500,000 events: 8
# shards), priced at its 8 probes (linspace(0.4 hi, hi, 8) servers x
# linspace(0, 2 hi, 8) pools, hi = 64 x 6 GB).
AZURE_FULL = dict(n_vms=250_000, days=30, seed=7, n_servers=256,
                  pool_sockets=16, gb_per_core=4.75, chunk_vms=8192,
                  budget=65_536, static_pool_frac=0.30, n_cand=8,
                  numpy_limit_s=120.0)
# The reference's rates for it, from the JAX package on a CPU (20,466,
# 1,755, 1,024, 987, 962, 952, 952, 952 rejects of 250,000):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "
#   import numpy as np
#   from benchmarks.azure_e2e import synth_dump
#   from repro.core import cluster_sim as cs, replay_engine as re, traces
#   synth_dump('d.csv.gz', n_vms=250_000)
#   cfg = cs.ClusterConfig(n_servers=256, pool_sockets=16, gb_per_core=4.75)
#   vms = [v for c in traces.iter_trace_chunks('d.csv.gz', chunk_vms=8192)
#          for v in c]
#   dec, _ = cs.policy_decisions(vms, 'static', static_pool_frac=0.30,
#                                as_arrays=True)
#   off = [0]
#   def decide(ch):
#       off[0] += len(ch); return dec.slice(off[0] - len(ch), off[0])
#   st = re.CompiledReplayStream(traces.iter_trace_chunks(
#       'd.csv.gz', chunk_vms=8192), None, cfg, max_events_per_shard=65_536,
#       decide=decide)
#   hi = 64 * 6.0
#   print(st.reject_rates(np.linspace(0.4 * hi, hi, 8),
#                         np.linspace(0, 2 * hi, 8)).tolist())"
# (the reference's monolithic CompiledReplay of load_trace_file gives the
# same rates).
AZURE_FULL_WANT = dict(
    rates=[0.081864, 0.00702, 0.004096, 0.003948, 0.003848, 0.003808,
           0.003808, 0.003808], n_events=500_000, n_shards=8)
# Pond's observability layer on the card (phase obs_full): (a) PROV_FULL's
# static engine pricing STREAM_FULL's 16 timed lanes, tracing off then on;
# (b) the same trace as a CompiledReplayStream at STREAM_FULL's 16,384
# events a shard and the same lanes, tracing on then off; (c) pond's
# decisions for POND_BATCH_FULL's seed 2 under the recorder; (d)
# iter_trace_chunks over AZURE_FULL's stand-in dump cut to 50,000 VMs (the
# same generator, 30 days, seed 7, 8,192 VMs a chunk).  The Chrome trace of
# (a)-(d) goes to chiprun_out/trace_obs_full.json.
OBS_FULL = dict(ingest_vms=50_000, trace_file="trace_obs_full.json")
# Phase devices_full (M13): devices= on every Pond engine at full width:
# PROV_FULL's static engine (trace seed 2) and TOPO_FULL's three-trace
# batch, and their streams at STREAM_FULL's 16,384-event budget;
# reject_rates at STREAM_FULL's 16 timed lanes, reject_rates_fleet at
# TOPO_FULL's 192-lane grid.
DEVICES_FULL = dict(budget=16_384, lanes=16, server=(270.0, 384.0),
                    pool=(0.0, 800.0))
# Phase train_parity_small: qwen2-1.5b's smoke config, seeded init (CPU
# generator, seed 0), ShardedBatches step 0 at 8 x 32 tokens, 2
# microbatches; tolerances (rtol, atol): fp32 parameters, bf16 weights
# (the reference's bf16 grads tolerance), and the AdamW arithmetic fed the
# same gradients on both sides.
TRAIN_SMALL = dict(seed=0, seq_len=32, global_batch=8, microbatches=2,
                   lr=1e-2, fp32=(1e-4, 1e-5), bf16=(0.05, 0.02),
                   adamw=(1e-5, 1e-7))
# Phase train_full: qwen2-1.5b at full width (configs/qwen2_1_5b.py: d_model
# 1536, 12 / 2 heads of 128, d_ff 8960, the padded 151,936 vocabulary, tied
# embeddings), its first 14 of 28 layers (the script's time limit: the
# sharded steps' phases take the rest; spmd_full trains it whole), bf16
# parameters from a seeded init on the card, the reference trainer's
# defaults otherwise (remat off, lr 3e-3 with 20 warmup steps);
# ShardedBatches at 8 x 2,048 tokens, 2 microbatches, xent chunk 512.
# (a) 2 fused steps, (b) 2 two-phase steps with fp32 moments pinned beside
# the card, (c) 2 two-phase steps with int8 moments.  host_link_gbps: the H100 SXM's PCIe
# Gen5 x16 host link, 64 GB/s a direction (the data sheet's 128 GB/s both
# ways), the opt step's floor.
TRAIN_FULL = dict(arch="qwen2-1.5b", seed=0, layers=14, global_batch=8,
                  seq_len=2048, microbatches=2, xent_chunk=512, lr=3e-3,
                  steps_fused=2, steps_two_phase=2, steps_int8=2,
                  host_link_gbps=64.0)
# Phase ingest_parity_small: the bundled fixture (48 VMs over two days) on
# 4 servers of 64 cores, 2 pool groups, 4 GB a core, static 0.25, as
# tests/test_traces_ingest.py::test_fixture_exists_and_replays_through_engine
# prices it.  The reference's values, from the JAX package on a CPU:
# load_trace_file(fixture_trace_path()) hashed as float64 rows of (arrival,
# lifetime, cores, mem_gb, vm_id, customer), its synthesised (untouched,
# slow182, slow222) rows and its float32 PMU rows (hashlib.sha1 of the
# arrays' bytes), and savings_analysis for local and static (one cache);
# then the same file with 0.25 GB added to every VM's mem_gb, written by
# save_trace_csv and read back, through savings_analysis (engine and
# use_engine=False).
FIXTURE_WANT = dict(
    n_vms=48, schema_sha1="d9b6b129c53f8585195306e02b33bc3735c7bffb",
    synth_sha1="36d203f2529beeaa5c3637c74a87d42d8431495f",
    pmu_sha1="9d7219b10bf23d08b021992fb0909abf8b802d23")
_FIX_COMMON = dict(baseline_server_gb=258.0, n_servers=4, n_groups=2,
                   mitigations=0, reject_rate=0.0, tier_pricing=None)
FIXTURE_RESULTS_WANT = {
    "local": dict(name="local", server_gb=258.0, pool_group_gb=0.0,
                  mispredictions=0.0, **_FIX_COMMON),
    "static": dict(name="static", server_gb=192.0,
                   pool_group_gb=64.23668639053254,
                   mispredictions=0.026041666666666668, **_FIX_COMMON)}
FRACTION_RESULTS_WANT = {
    "local": FIXTURE_RESULTS_WANT["local"],
    "static": dict(FIXTURE_RESULTS_WANT["static"], server_gb=195.0)}
# the reference's scalar search (use_engine=False) on the fractional copy:
# its server searches equal the engine's bit for bit; its pool search
# probes other points (tests/test_replay_engine.py::
# test_savings_analysis_matches_scalar_search: within 0.15 x pool + 32 GB)
FRACTION_SCALAR_WANT = {
    "local": FIXTURE_RESULTS_WANT["local"],
    "static": dict(FRACTION_RESULTS_WANT["static"], pool_group_gb=64.5)}
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full", "--dtype", "bfloat16",
              "--requests", "16", "--max-batch", "8", "--page-size", "16",
              "--local-pages", "256", "--pool-pages", "1024",
              "--prompt-len", "128", "1025", "--new-tokens", "32", "65",
              "--seed", "0"]


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line a phase; ``t_s`` is the seconds since the script
    started, so the lines show where the run's time goes."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _START}), flush=True)


# ------------------------------------------------------------------ build --
_BUILDS = {}


def phase_build(first=None):
    """Start every kernel's build, one ``nvcc`` a source, all together;
    wait for the kernels in ``first`` (default: all) and load them.  The
    rest go on compiling beside the phases that need only ``first``;
    ``phase_build_rest`` waits for them."""
    from repro_torch.kernels import build
    from repro_torch.kernels.event_sweep import kernel as K1
    from repro_torch.kernels.fail_sweep import kernel as K5
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.kernels.pod_sweep import kernel as K4
    from repro_torch.kernels.spill_sweep import kernel as K6
    every = (K2, K3, K1, K6, K5, K4)
    first = every if first is None else first
    _BUILDS["rest"] = [K for K in every if K not in first]
    builds = build.start_builds([K.NAME for K in every])
    _BUILDS["pending"] = [b for b in builds
                          if b.name not in {K.NAME for K in first}]
    _BUILDS["seconds"] = build.finish_builds(
        [b for b in builds if b not in _BUILDS["pending"]])
    _load_kernels(first)


def phase_build_rest():
    """Wait for the builds ``phase_build`` left running, and load them."""
    from repro_torch.kernels import build
    if _BUILDS.get("rest"):
        _BUILDS["seconds"].update(build.finish_builds(
            _BUILDS.pop("pending")))
        _load_kernels(_BUILDS.pop("rest"))


def _load_kernels(kernels):
    from repro_torch.kernels import build
    from repro_torch.kernels.event_sweep import kernel as K1
    from repro_torch.kernels.fail_sweep import kernel as K5
    from repro_torch.kernels.pod_sweep import kernel as K4
    for K in kernels:
        K.build()                                   # load and bind
        with open(f"{build.library_path(K.NAME)}.log") as f:
            log = f.read()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        emit("build", kernel=K.NAME, source=K.SOURCE,
             nvcc_seconds=_BUILDS["seconds"].get(K.NAME),
             flags=" ".join(build.NVCC_FLAGS), instantiations=len(regs),
             registers=regs, max_registers=max(regs), spill_stores=spills,
             spill_store_bytes=sum(spills))
        if K in (K1, K5, K4):
            # registers, stack frame and spills of every K1, K5 or K4
            # variant
            report = K.ptxas_report(log)
            emit("build_variants", kernel=K.NAME, variants=report,
                 registers_variants_without_stack_or_spills=all(
                     v.get("stack_bytes") == 0
                     and v.get("spill_store_bytes") == 0
                     for v in report if v.get("variant", "").startswith(
                         "registers")))


# ---------------------------------------------------------------- kernels --
def _paged_inputs(rng, b, g, hkv, d, page, num_pages, lens, width, dtype, dev,
                  layers=1):
    """Random pools and queries; each row gets distinct random pages, the
    table is padded with page 0 to ``width`` columns."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev).to(dtype)
    shape = (layers, hkv, num_pages, page, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    tbl = np.zeros((b, width), np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lens):
        npg = -(-int(n) // page)
        if used + npg <= num_pages:          # distinct pages while they last
            tbl[i, :npg] = perm[used:used + npg]
            used += npg
        else:
            tbl[i, :npg] = rng.integers(0, num_pages, npg)
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev))


def _max_err(got, want, tol, what):
    """Max |got - want|; exits unless every element is within
    tol + tol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        raise SystemExit(f"{what}: the kernel disagrees with its plain "
                         f"version, max abs err {float(err.max()):.3e}, "
                         f"tolerance {tol:g} + {tol:g} * |plain|")
    return float(err.max())


def _time_ms(fn, reps, graph=False):
    """ms a call of fn by CUDA events.  With ``graph``, fn is captured once
    in a CUDA graph and the replays are timed: the device's time, without
    the host's time to enqueue (which exceeds a short kernel's)."""
    fn()
    torch.cuda.synchronize()
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured, capture_error_mode="relaxed"):
            fn()
        fn = captured.replay
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


def phase_kernels(dev):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.default_rng(0)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_shapes = 0
    # the reference sweep, plus the page sizes and head dims the kernel is
    # built for beyond it
    sweep = [(b, g, hkv, d, page, pps)
             for g in (1, 2, 4) for hkv in (1, 2) for d in (16, 32)
             for page in (8, 16) for b, pps in ((1, 1), (2, 3), (3, 4))]
    sweep += [(2, 6, 2, 64, 4, 5), (2, 3, 1, 128, 4, 40), (3, 6, 2, 128, 8, 9)]
    for b, g, hkv, d, page, pps in sweep:
        lens = rng.integers(1, pps * page + 1, b)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tbl, ln = _paged_inputs(
                rng, b, g, hkv, d, page, 16, lens, pps + int(rng.integers(3)),
                dtype, dev)
            got = ops.paged_attention(q, kp[0], vp[0], tbl, ln)
            want = paged_attention_ref(q, kp[0], vp[0], tbl, ln,
                                       scale=d ** -0.5)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL[dtype],
                f"paged_attention b={b} g={g} hkv={hkv} d={d} page={page} "
                f"{dtype}"))
            n_shapes += 1

    # the split-KV edges on this card: splits > 1 with lens 1, lengths that
    # end on split boundaries, a table far wider than its rows need, and
    # B * Hkv of two blocks an SM (one split): (b, g, hkv, d, page, width,
    # lens; None: boundary lengths)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    edge_rng = np.random.default_rng(1)  # leaves rng's draws as they were
    edges = {"lens_1": (2, 6, 2, 128, 16, 64, [1, 1]),
             "ends_on_boundary": (3, 6, 2, 128, 16, 128, None),
             "wide_table": (2, 4, 2, 64, 8, 256, [100, 7]),
             "one_split": (sm, 2, 2, 64, 8, 4, edge_rng.integers(1, 33, sm))}
    edge_splits = {}
    for name, (b, g, hkv, d, page, width, lens) in edges.items():
        splits = K.num_splits(b, hkv, width, page, sm)
        per = K.split_tokens(width, page, splits)
        if lens is None:
            lens = [per, 2 * per, min(splits * per, width * page)]
        if (splits == 1) != (name == "one_split"):
            raise SystemExit(f"paged_attention edge {name}: {splits} splits")
        edge_splits[name] = dict(splits=splits, split_tokens=per,
                                 lens=[int(x) for x in lens][:4])
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tbl, ln = _paged_inputs(edge_rng, b, g, hkv, d, page,
                                               512, lens, width, dtype, dev)
            got = ops.paged_attention(q, kp[0], vp[0], tbl, ln)
            want = paged_attention_ref(q, kp[0], vp[0], tbl, ln,
                                       scale=d ** -0.5)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL[dtype],
                f"paged_attention edge {name}, {splits} splits, {dtype}"))
            n_shapes += 1

    # the full-width shape of the serving path: ragged rows, padded table,
    # one pool per layer so that every launch finds its pages cold, as the
    # 28 layers of a decode step do
    f = FULL
    g = f["hq"] // f["hkv"]
    lens = rng.integers(1, f["max_len"] + 1, f["b"])
    lens[0], lens[1] = f["max_len"], 1
    width = f["max_len"] // f["page"]
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tbl, ln = _paged_inputs(
            rng, f["b"], g, f["hkv"], f["d"], f["page"], f["num_pages"], lens,
            width, dtype, dev, layers=LAYERS)
        scale = f["d"] ** -0.5
        for li in (0, LAYERS - 1):
            got = ops.paged_attention(q, kp[li], vp[li], tbl, ln, scale=scale)
            want = paged_attention_ref(q, kp[li], vp[li], tbl, ln,
                                       scale=scale)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL_FULL[dtype],
                f"paged_attention full width, layer {li}, {dtype}"))
        n_shapes += 1
        if dtype is not torch.bfloat16:
            continue

        def run_kernel():
            for li in range(LAYERS):
                ops.paged_attention(q, kp[li], vp[li], tbl, ln, scale=scale)

        def run_plain():
            for li in range(LAYERS):
                paged_attention_ref(q, kp[li], vp[li], tbl, ln, scale=scale)

        # plain, kernel, kernel, plain: both versions within one run, on
        # the device's clock (graph replays) and as eager calls, whose time
        # is the host's enqueue rate where that is the slower
        plain_a, kern_a, kern_b, plain_b = (
            _time_ms(fn, 10, graph=True) / LAYERS
            for fn in (run_plain, run_kernel, run_kernel, run_plain))
        eager = [_time_ms(fn, 3) / LAYERS
                 for fn in (run_plain, run_kernel, run_kernel, run_plain)]
        tokens = int(lens.sum())
        item = q.element_size()
        nbytes = (2 * tokens * f["hkv"] * f["d"] * item        # K and V rows
                  + 2 * q.numel() * item                       # q in, out
                  + tbl.numel() * 4 + ln.numel() * 4)
        flops = 4 * tokens * f["hq"] * f["d"]                  # q.K and p.V
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        timing = dict(ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                      ms_runs=[kern_a, kern_b], plain_ms_runs=[plain_a, plain_b],
                      timing="CUDA graph replays of the 28 layers' calls",
                      eager_ms_runs=eager[1:3],
                      eager_plain_ms_runs=[eager[0], eager[3]],
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      bytes=nbytes, flops=flops, tokens=tokens,
                      splits=K.num_splits(f["b"], f["hkv"], width, f["page"],
                                          sm),
                      timed_shape=dict(f, dtype="bfloat16",
                                       lens=[int(x) for x in lens]))
    record = dict(
        name=K.NAME, route="cuda", source=K.SOURCE,
        replaces="src/repro/kernels/paged_attention/kernel.py:75",
        max_abs_err=max(errs.values()),
        max_err_fp32=errs[torch.float32], max_err_bf16=errs[torch.bfloat16],
        tol_fp32=TOL[torch.float32], tol_bf16=TOL[torch.bfloat16],
        tol_bf16_full_width=TOL_FULL[torch.bfloat16],
        shapes_checked=n_shapes, split_edges=edge_splits, sm_count=sm,
        design="split-KV: grid (Hkv, B, splits), 64-token tiles by 2-stage "
               "cp.async, fp32 CUDA-core dot products, merge kernel",
        library_ms=None,
        library_note="no single PyTorch call computes attention through a "
                     "block table",
        **timing)
    emit("kernels", kernels=[record])
    return record


def _band_pairs(sq, skv, window):
    """(query, key) pairs inside the causal / window band: the work the
    function needs, whatever implements it."""
    q = np.arange(sq)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(0, q - window + 1)
    return int((np.minimum(q + 1, skv) - lo).clip(min=0).sum())


def _sdpa_library_call(q, k, v, mask, scale, is_causal=False):
    """The library yardstick (``library_ms``): one PyTorch call computing
    the same function, with a boolean ``mask`` or, for a plain causal
    one, ``is_causal``.  The port never calls it."""
    import torch.nn.functional as F
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=is_causal, scale=scale, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_choice(q, k, v, mask, scale, is_causal=False):
    """The backend SDPA's default dispatch takes for the library call's
    inputs, by its own choice function; None where this PyTorch has no
    such function."""
    from torch.nn.attention import SDPBackend
    try:
        i = torch._fused_sdp_choice(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, dropout_p=0.0, is_causal=is_causal, scale=scale,
            enable_gqa=True)
    except (AttributeError, TypeError):
        return None
    return {b.value: n for n, b in SDPBackend.__members__.items()}.get(i)


def _sdpa_backends(q, k, v, mask, scale, is_causal=False):
    """Which of SDPA's backends accept the library call's inputs, each tried
    alone, and the ms a call of each that does (one layer, CUDA events);
    None where the backend refuses them or runs out of memory."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in SDPBackend.__members__.values():
        if backend.name == "ERROR":
            continue
        try:
            with sdpa_kernel(backend):
                out[backend.name] = _time_ms(
                    lambda: _sdpa_library_call(q, k, v, mask, scale,
                                               is_causal),
                    1 if backend.name == "MATH" else 5)
        except RuntimeError as e:               # refused, or out of memory
            out[backend.name] = None
            out[f"{backend.name}_refusal"] = str(e).splitlines()[0][:160]
        torch.cuda.empty_cache()
    return out


def phase_kernels_flash(dev):
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         bf16_bound)
    from repro_torch.models.attention import blocked_attention
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(shape, dtype, std=0.5):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_shapes = 0
    # the reference sweep (b 1-2, g {1,2,4}, hkv {1,2}, d {16,32,64},
    # window {None,7,33}, 2-4 blocks of 16), then the head dims, lengths,
    # window and group sizes of the serving paths, one non-causal case with
    # Sq != Skv, and the tensor-core kernel's edges: D 24 (contraction
    # padded to 32), g 6 (126 of 128 rows), a window of 7 (inside one
    # tile), Sq 1, 63 and 65 (a tile and one row either side):
    # (b, sq, skv, g, hkv, d, window, causal)
    sweep = []
    for i, (b, g, hkv, d, w) in enumerate(
            (b, g, hkv, d, w) for b in (1, 2) for g in (1, 2, 4)
            for hkv in (1, 2) for d in (16, 32, 64) for w in (None, 7, 33)):
        s_len = 16 * (2 + i % 3)
        sweep.append((b, s_len, s_len, g, hkv, d, w, True))
    sweep += [(2, 37, 37, 2, 2, 24, None, True), (2, 37, 37, 2, 2, 24, 7, True),
              (1, 1000, 1000, 4, 2, 80, None, True),
              (2, 1000, 1000, 4, 8, 80, 33, True),
              (1, 1000, 1000, 6, 2, 128, 4096, True),
              (2, 300, 300, 4, 8, 80, 4096, True),
              (2, 37, 37, 6, 2, 128, 7, True),
              (2, 37, 45, 2, 2, 24, None, False),
              (1, 1, 1, 4, 2, 80, None, True), (2, 1, 65, 6, 2, 24, None, False),
              (2, 63, 63, 6, 2, 24, 7, True), (2, 65, 65, 6, 1, 80, 7, True),
              (2, 65, 65, 4, 8, 80, 4096, True), (1, 63, 63, 6, 2, 128, None, True),
              (1, 65, 65, 1, 2, 16, 33, True), (2, 129, 129, 6, 2, 64, 7, True)]
    for b, sq, skv, g, hkv, d, w, causal in sweep:
        for dtype in (torch.float32, torch.bfloat16):
            q = rand((b, sq, hkv * g, d), dtype)
            k = rand((b, skv, hkv, d), dtype)
            v = rand((b, skv, hkv, d), dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=w)
            want = attention_ref(q, k, v, causal=causal, window=w)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL[dtype],
                f"flash_attention b={b} sq={sq} skv={skv} g={g} hkv={hkv} "
                f"d={d} window={w} causal={causal} {dtype}"))
            n_shapes += 1

    # the full-width shape of the ring path's prefill, one set of inputs
    # per layer so that every launch finds its data cold, as the 24 layers
    # of a prefill do
    f = K3_FULL
    b, s_len, hq, hkv, d, w = (f[x] for x in ("b", "s", "hq", "hkv", "d",
                                               "window"))
    dtype, scale, L = torch.bfloat16, d ** -0.5, DANUBE_LAYERS
    q = rand((L, b, s_len, hq, d), dtype, std=1.0)
    k = rand((L, b, s_len, hkv, d), dtype, std=1.0)
    v = rand((L, b, s_len, hkv, d), dtype, std=1.0)
    pos = torch.arange(s_len, device=dev).expand(b, s_len)
    full_err, bound_use = 0.0, 0.0
    for li in (0, L - 1):
        got = ops.flash_attention(q[li], k[li], v[li], causal=True, window=w,
                                  scale=scale)
        want, want_abs_v = (
            blocked_attention(q[li].float(), k[li].float(), vv, scale, pos,
                              pos, window=w, causal=True)
            for vv in (v[li].float(), v[li].float().abs()))
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        ratio = float((err / bf16_bound(want, want_abs_v)).max())
        if ratio > 1.0:
            raise SystemExit(
                f"flash_attention full width, layer {li}: the kernel is "
                f"outside the bf16 bound against the fp32 plain version "
                f"(max abs err {float(err.max()):.3e}, {ratio:.3f} of the "
                "bound)")
        full_err, bound_use = max(full_err, float(err.max())), max(bound_use,
                                                                   ratio)
        del want, want_abs_v, err
    n_shapes += 1
    qi, ki = torch.arange(s_len, device=dev)[:, None], \
        torch.arange(s_len, device=dev)[None]
    band = (ki <= qi) & (ki > qi - w)
    lib = _sdpa_library_call(q[0], k[0], v[0], band, scale)
    ours = ops.flash_attention(q[0], k[0], v[0], window=w, scale=scale)
    torch.cuda.synchronize()
    library_err = float((lib.float() - ours.float()).abs().max())
    backends = _sdpa_backends(q[0], k[0], v[0], band, scale)

    def over_layers(fn, layers):
        """ms a call of fn(li) over ``layers``, by CUDA events."""
        fn(layers[0])                                    # warm up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for li in layers:
            fn(li)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(layers)

    def kern(li):
        ops.flash_attention(q[li], k[li], v[li], window=w, scale=scale)

    def plain(li):
        blocked_attention(q[li], k[li], v[li], scale, pos, pos, window=w,
                          causal=True)

    def library(li):
        _sdpa_library_call(q[li], k[li], v[li], band, scale)

    every = list(range(L))
    # plain, kernel, kernel, plain, library: all inside this one run
    plain_a = over_layers(plain, every)
    kern_a = over_layers(kern, every)
    kern_b = over_layers(kern, every)
    plain_b = over_layers(plain, every)
    lib_ms = over_layers(library, every)
    pairs = _band_pairs(s_len, s_len, w)
    item = q.element_size()
    nbytes = (2 * b * s_len * hq * d + 2 * b * s_len * hkv * d) * item
    flops = 4 * b * hq * d * pairs                      # q.K and p.V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    record = dict(
        name=K.NAME, route="cuda", source=K.SOURCE,
        replaces="src/repro/kernels/flash_attention/kernel.py:72",
        max_abs_err=max(*errs.values(), full_err),
        max_err_fp32=errs[torch.float32], max_err_bf16=errs[torch.bfloat16],
        max_err_bf16_full_width=full_err,
        tol_fp32=TOL[torch.float32], tol_bf16=TOL[torch.bfloat16],
        tol_bf16_full_width="1e-5 + 2**-8 |plain| + 2**-8 (P |V|), "
                            "ref.py::bf16_bound",
        max_share_of_bf16_bound_full_width=bound_use,
        shapes_checked=n_shapes,
        design="bf16: mma.sync m16n8k16 (FlashAttention-2), ldmatrix, "
               "2-stage cp.async ring, 128 rows a block; fp32: CUDA cores",
        ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
        ms_runs=[kern_a, kern_b], plain_ms_runs=[plain_a, plain_b],
        library_ms=lib_ms,
        library_call="PyTorch's fused scaled-dot-product attention "
                     "(enable_gqa=True, boolean band mask)",
        library_backends=backends,
        library_max_abs_err_vs_kernel=library_err,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops, band_pairs=pairs,
        timed_shape=dict(f, dtype="bfloat16", layers=L))
    emit("kernels", kernels=[record])
    return record


# ----------------------------------------------------------- parity_small --
def phase_parity_small(dev):
    """Smoke config, fp32, same weights and requests: the engine on the
    card (kernel) and on the CPU (plain version) must give identical token
    streams and identical statistics."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.engine import DecodeEngine, paged_kv_config
    from repro_torch.serving.scheduler import Request

    cfg = get_smoke("qwen2-1.5b")
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0))
    gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())

    def run(model):
        rng = np.random.default_rng(2)
        eng = DecodeEngine(model, paged_kv_config(
            cfg, page_size=4, num_local=12, num_pool=96), max_batch=3,
            pdm=0.05)
        for r in range(8):
            plen = int(rng.integers(5, 40))
            eng.submit(Request(req_id=r, prompt_len=plen,
                               max_new_tokens=int(rng.integers(2, 17))),
                       rng.integers(0, cfg.vocab_size, plen))
        stats = eng.run(500)
        return eng, stats

    before = ops.launches
    gpu_eng, gpu_stats = run(gpu_model)
    gpu_launches = ops.launches - before
    cpu_eng, cpu_stats = run(cpu_model)
    ok = (gpu_eng.outputs == cpu_eng.outputs
          and dataclasses.asdict(gpu_stats) == dataclasses.asdict(cpu_stats)
          and len(gpu_eng.batcher.completed) == 8
          and gpu_launches == gpu_stats.steps * cfg.num_layers
          and ops.launches - before == gpu_launches      # none from the CPU
          and bool(gpu_eng.logits_finite) and gpu_stats.migrations >= 1)
    emit("parity_small", ok=ok, steps=gpu_stats.steps, tokens=gpu_stats.tokens,
         migrations=gpu_stats.migrations, kernel_launches=gpu_launches,
         streams_equal=gpu_eng.outputs == cpu_eng.outputs,
         stats_equal=dataclasses.asdict(gpu_stats)
         == dataclasses.asdict(cpu_stats))
    if not ok:
        raise SystemExit("parity_small failed: the card and the CPU disagree")


# ------------------------------------------------------------- serve_full --
def phase_serve_full(dev):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    eng = serve.serve(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    stats, alloc = eng.stats, eng.kv.alloc
    want_tokens = sum(r.max_new_tokens for r in eng.batcher.completed)
    checks = {
        "all_completed": len(eng.batcher.completed) == 16,
        "tokens": stats.tokens == want_tokens,
        "pages_returned": alloc.local_in_use == 0 and alloc.pool_in_use == 0,
        "launches": launches == stats.steps * LAYERS and launches > 0,
        "spilled": max(stats.pool_traffic_fracs) > 0,
        "migrated": stats.migrations >= 1,
        "logits_finite": bool(eng.logits_finite),
        "tokens_in_vocab": all(0 <= t < eng.model.cfg.vocab_size
                               for out in eng.outputs.values() for t in out),
        "on_card": eng.device.type == "cuda",
    }
    dec = eng.timings.decode_seconds
    pre = eng.timings.prefill_seconds
    emit("serve_full", ok=all(checks.values()), checks=checks,
         arch=eng.model.cfg.name, layers=eng.model.cfg.num_layers,
         params=sum(p.numel() for p in eng.model.parameters()),
         requests=16, steps=stats.steps, tokens=stats.tokens,
         kernel_launches=launches, migrations=stats.migrations,
         max_pool_traffic_frac=max(stats.pool_traffic_fracs),
         spill_fraction=alloc.spill_fraction,
         decode_ms_per_step_median=statistics.median(dec) * 1e3,
         decode_ms_per_step_mean=statistics.fmean(dec) * 1e3,
         prefill_ms_per_request_median=statistics.median(pre) * 1e3,
         prefill_ms_per_request_mean=statistics.fmean(pre) * 1e3,
         decode_tokens_per_s=stats.tokens / sum(dec),
         wall_seconds=wall,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not all(checks.values()):
        raise SystemExit(f"serve_full failed: {checks}")
    return launches


# ------------------------------------------------------ ring_parity_small --
def _prompt_run(model, inp, steps, max_len, ctx=None):
    """``make_prefill_step`` over ``inp`` (``one_card.prompt_inputs``:
    tokens, positions, embeds, cache_kw, start), then ``steps`` greedy
    ``make_decode_step`` steps over a cache of ``max_len``, flash
    attention by default.  Returns a dict: the token stream, the logits of
    every call on the host (steps + 1, B, V), the cache, the prompt
    tokens, host seconds of the prefill and of each decode step, the
    inputs."""
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from repro_torch.sharding.rules import ShardCtx
    dev = model.device
    b = inp["tokens"].shape[0]
    cache = model.init_cache(b, max_len, dtype=torch.float32
                             if model.embed.tok.dtype == torch.float32
                             else None, **inp["cache_kw"])
    ctx = ctx or ShardCtx(attn_impl="flash")
    prefill, decode = make_prefill_step(model, ctx), make_decode_step(model,
                                                                      ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(inp["tokens"], inp["positions"], cache,
                            embeds=inp["embeds"])
    tok = torch.argmax(logits[:, -1], dim=-1)
    stream = [tok.tolist()]                      # waits for the device
    prefill_s = time.perf_counter() - t0
    all_logits, step_s = [logits[:, -1].cpu()], []
    for i in range(steps):
        t0 = time.perf_counter()
        pos = torch.full((b,), inp["start"] + i, dtype=torch.int64,
                         device=dev)
        logits, cache = decode(tok[:, None], pos, cache)
        tok = torch.argmax(logits[:, 0], dim=-1)
        stream.append(tok.tolist())              # waits for the device
        step_s.append(time.perf_counter() - t0)
        all_logits.append(logits[:, 0].cpu())
    return dict(stream=stream, logits=torch.stack(all_logits), cache=cache,
                tokens=inp["tokens"], prefill_s=prefill_s, step_s=step_s,
                inputs=inp)


def _serve_run(model, prompt, steps, *, seed, batch, max_len=None):
    """``_prompt_run`` over ``batch`` prompts of ``prompt`` tokens drawn
    from numpy's generator at ``seed``, a cache of ``max_len`` (prompt +
    steps by default)."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt)))
    inp = dict(tokens=toks.to(dev), embeds=None, cache_kw={}, start=prompt,
               positions=torch.arange(prompt, device=dev).expand(batch,
                                                                 prompt))
    return _prompt_run(model, inp, steps, max_len or prompt + steps)


def phase_ring_parity_small(dev):
    """danube's smoke config (window 16), fp32, same weights: prompts of 40
    tokens (the ring wraps twice) and 6 decode steps on the card (K3) and
    on the CPU (the plain blocked version) must give the same tokens, the
    same ring positions and logits within 1e-4."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    cfg = get_smoke("h2o-danube-1.8b")
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0))
    gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    before = ops.launches
    g = _serve_run(gpu_model, 40, 6, seed=3, batch=RING_BATCH)
    gpu_launches = ops.launches - before
    c = _serve_run(cpu_model, 40, 6, seed=3, batch=RING_BATCH)
    g_pos = g["cache"]["groups"][0]["blocks"][0]["pos"].cpu()
    c_pos = c["cache"]["groups"][0]["blocks"][0]["pos"]
    logit_err = float((g["logits"] - c["logits"]).abs().max())
    checks = {
        "streams_equal": g["stream"] == c["stream"],
        "pos_equal": torch.equal(g_pos, c_pos),
        "logits_within_1e-4": logit_err <= 1e-4,
        "launches": gpu_launches == cfg.num_layers,   # 2 layers x 1 prefill
        "none_from_cpu": ops.launches - before == gpu_launches,
    }
    emit("ring_parity_small", ok=all(checks.values()), checks=checks,
         arch=cfg.name, window=cfg.sliding_window, prompt=40, decode_steps=6,
         kernel_launches=gpu_launches, max_logit_err=logit_err)
    if not all(checks.values()):
        raise SystemExit(f"ring_parity_small failed: {checks}")


# -------------------------------------------------------------- ring_full --
def phase_ring_full(dev):
    """h2o-danube-1.8b at full width and depth in bf16, seeded random
    weights: two 8192-token prompts, then 32 greedy decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    cfg = get_config("h2o-danube-1.8b")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)          # bf16 weights, fp32 norms
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    run = _serve_run(model, RING_PROMPT, RING_STEPS, seed=0,
                     batch=RING_BATCH)
    stream, logits, cache = run["stream"], run["logits"], run["cache"]
    prefill_s, step_s = run["prefill_s"], run["step_s"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    last = RING_PROMPT + RING_STEPS - 1
    want = torch.arange(last - cfg.sliding_window + 1, last + 1, device=dev,
                        dtype=torch.int32)
    pos = cache["groups"][0]["blocks"][0]["pos"]         # (L, B, W)
    checks = {
        "launches": launches == DANUBE_LAYERS,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "logits_shape": tuple(logits.shape) == (RING_STEPS + 1, RING_BATCH,
                                                cfg.vocab_size),
        "tokens_in_vocab": all(0 <= t < cfg.vocab_size
                               for row in stream for t in row),
        "ring_wrapped": bool((pos.sort(dim=-1).values == want).all()),
        "on_card": model.device.type == "cuda" and pos.is_cuda,
    }
    emit("ring_full", ok=all(checks.values()), checks=checks, arch=cfg.name,
         layers=cfg.num_layers, params=sum(p.numel()
                                           for p in model.parameters()),
         batch=RING_BATCH, prompt=RING_PROMPT, decode_steps=RING_STEPS,
         ring_width=pos.shape[-1], ring_positions=[int(pos.min()),
                                                   int(pos.max())],
         kernel_launches=launches,
         prefill_ms=prefill_s * 1e3,
         decode_ms_per_step_median=statistics.median(step_s) * 1e3,
         decode_ms_per_step_mean=statistics.fmean(step_s) * 1e3,
         decode_tokens_per_s=RING_BATCH * RING_STEPS / sum(step_s),
         wall_seconds=wall,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not all(checks.values()):
        raise SystemExit(f"ring_full failed: {checks}")
    return launches


# -------------------------------------------------- the model families ----
# The decoder-only families (MoE, MLA, Mamba-2, and the dense qwen2-7b and
# qwen3-32b) served through the ring/latent/SSM caches of
# ``runtime/serve.py`` with flash attention (K3) in every attention
# block's prefill.  MLA's heads (192/128 wide) and Mamba-2 take no K3.  The
# runs' shapes and depth cuts are ``repro_torch/configs/one_card.py``'s.
FAMILIES_SMALL = dict(batch=2, prompt=13, steps=4)   # 13: not a whole chunk


@torch.no_grad()
def _forward_logits(model, run):
    """The model's training forward (blocked attention, no cache) over the
    prompt and the fed-back tokens, with the run's embeddings: the logits
    at the positions the serving steps produced, (steps + 1, B, V) on the
    host, and the hidden states of the text prompt."""
    inp = run["inputs"]
    toks = inp["tokens"]
    fed = torch.tensor(run["stream"][:-1], device=toks.device).T
    seq = torch.cat([toks, fed], dim=1)
    p = toks.shape[1]
    n = inp["start"] - p                         # patch rows before the text
    positions = torch.arange(n + seq.shape[1], device=toks.device).expand(
        seq.shape[0], n + seq.shape[1])
    hidden = model.forward(seq, positions, embeds=inp["embeds"])["hidden"]
    hidden = hidden[:, n:]
    return model.logits(hidden[:, p - 1:]).movedim(1, 0).cpu(), hidden[:, :p]


def _cache_leaves(cache):
    from repro_torch.models.params import map_with_path
    out = {}
    map_with_path(out.__setitem__, cache)
    return out


def _cache_checks(cache, written):
    """What the reference leaves in the caches after ``written`` tokens a
    row: every ring and MLA ``pos`` row holds 0..written-1 and -1 after
    them; the Mamba states are finite and not all zero."""
    checks = {}
    for path, t in _cache_leaves(cache).items():
        name = "/".join(map(str, path))
        if path[-1] == "pos":
            want = torch.full(t.shape[-1:], -1, dtype=t.dtype,
                              device=t.device)
            want[:written] = torch.arange(written, device=t.device)
            checks[f"pos_{name}"] = bool((t == want).all())
        elif path[-1] in ("ssm", "conv_x", "conv_B", "conv_C"):
            checks[f"state_{name}"] = bool(torch.isfinite(t).all()
                                           and t.abs().sum() > 0)
    return checks


def _parity_small(dev, phase, archs, f, seed):
    """Each arch's smoke config in fp32, the same weights, tokens and
    embeddings on both devices (``one_card.prompt_inputs`` at ``f``): the
    card's serving steps (K3 where there is attention) against the CPU's
    (plain versions) and against the card's own forward, and the aux loss
    card against CPU.  Emits one line, exits non-zero on a failed check."""
    from repro_torch.configs.one_card import attention_layers, prompt_inputs
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    rows, ok = {}, True
    for arch in archs:
        cfg = get_smoke(arch)
        cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
        cpu_model.init_params(torch.Generator().manual_seed(0))
        gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
        gpu_model.load_state_dict(cpu_model.state_dict())
        inp = prompt_inputs(cfg, f, "cpu", seed=seed)
        if inp["embeds"] is not None:
            inp["embeds"] = inp["embeds"].float() * 25   # of unit scale
        max_len = inp["start"] + f["steps"]
        before = ops.launches
        g = _prompt_run(gpu_model, _inputs_to(inp, dev), f["steps"], max_len)
        gpu_launches = ops.launches - before
        c = _prompt_run(cpu_model, inp, f["steps"], max_len)
        logit_err = float((g["logits"] - c["logits"]).abs().max())
        gl, cl = _cache_leaves(g["cache"]), _cache_leaves(c["cache"])
        cache_err = max(float((gl[k].cpu().double() - cl[k].double())
                              .abs().max()) for k in cl)
        cache_ok = all(torch.equal(gl[k].cpu(), cl[k]) if k[-1] == "pos"
                       else torch.allclose(gl[k].cpu(), cl[k], rtol=1e-5,
                                           atol=1e-5) for k in cl)
        fwd_logits, fwd_hidden = _forward_logits(gpu_model, g)
        own_err = float((g["logits"] - fwd_logits).abs().max())
        gi = g["inputs"]
        with torch.no_grad():
            cache = gpu_model.init_cache(f["batch"], gi["start"],
                                         dtype=torch.float32,
                                         **gi["cache_kw"])
            hp, _, _ = gpu_model.prefill(gi["tokens"], gi["positions"],
                                         cache, embeds=gi["embeds"])
            n = gi["start"] - gi["tokens"].shape[1]
            hidden_err = float((hp[:, n:] - fwd_hidden).abs().max())
            g_aux, c_aux = (float(m.forward(x["tokens"], x["positions"],
                                            embeds=x["embeds"])["aux"])
                            for m, x in ((gpu_model, gi), (cpu_model, inp)))
        checks = {
            "streams_equal": g["stream"] == c["stream"],
            "logits_within_1e-4": logit_err <= 1e-4,
            "cache_within_1e-5": cache_ok,
            "own_forward_logits_within_2e-3": own_err <= 2e-3,
            "own_forward_hidden_within_2e-4": hidden_err <= 2e-4,
            "aux_card_vs_cpu": abs(g_aux - c_aux) <= 1e-5 * max(1.0,
                                                                 abs(c_aux)),
            "aux_nonzero_iff_moe": (g_aux > 0) == (cfg.moe is not None),
            "launches": gpu_launches == attention_layers(cfg),
        }
        ok &= all(checks.values())
        rows[arch] = dict(ok=all(checks.values()), checks=checks,
                          kernel_launches=gpu_launches,
                          max_logit_err=logit_err, max_cache_err=cache_err,
                          max_err_vs_own_forward=own_err,
                          max_hidden_err_vs_own_forward=hidden_err,
                          aux_card=g_aux, aux_cpu=c_aux)
    emit(phase, ok=ok, **f, archs=rows)
    if not ok:
        raise SystemExit(f"{phase} failed: " + json.dumps(
            {a: r["checks"] for a, r in rows.items() if not r["ok"]}))


def phase_families_parity_small(dev):
    """The six decoder-only families (``_parity_small``)."""
    from repro_torch.configs.one_card import FAMILY_ARCHS
    _parity_small(dev, "families_parity_small", FAMILY_ARCHS,
                  FAMILIES_SMALL, seed=3)


def _k3_at_prefill(cfg, batch, prompt, dtype, dev):
    """K3 at one prefill's shapes (causal, the model's heads and head dim,
    seeded inputs): one launch held against the blocked plain version in
    fp32 on the same inputs, bf16 elementwise within
    ``kernels/flash_attention/ref.py::bf16_bound`` and fp32 within
    ``TOL`` (outside it the script fails), and K3's time in the prefill:
    one launch (CUDA events, median of 5) times the attention layers.
    Empty where the model has no attention."""
    from repro_torch.configs.one_card import attention_layers
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import bf16_bound
    from repro_torch.models.attention import blocked_attention
    n = attention_layers(cfg)
    if not n:
        return {}
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(batch, prompt, cfg.num_heads, cfg.head_dim, device=dev,
                    generator=g, dtype=dtype)
    k, v = (torch.randn(batch, prompt, cfg.num_kv_heads, cfg.head_dim,
                        device=dev, generator=g, dtype=dtype)
            for _ in range(2))
    scale, w = cfg.head_dim ** -0.5, cfg.sliding_window
    got = ops.flash_attention(q, k, v, causal=True, window=w, scale=scale)
    pos = torch.arange(prompt, device=dev).expand(batch, prompt)
    want, want_abs_v = (
        blocked_attention(q.float(), k.float(), vv, scale, pos, pos,
                          window=w, causal=True)
        for vv in (v.float(), v.float().abs()))
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        share = float((err / bf16_bound(want, want_abs_v)).max())
        tol = "1e-5 + 2**-8 |plain| + 2**-8 (P |V|), ref.py::bf16_bound"
    else:
        share, tol = float(err.max()) / TOL[dtype], TOL[dtype]
    shape = (f"B {batch}, S {prompt}, Hq {cfg.num_heads}, Hkv "
             f"{cfg.num_kv_heads}, D {cfg.head_dim}, {dtype}")
    if share > 1.0:
        raise SystemExit(
            f"flash_attention at {cfg.name}'s prefill ({shape}): outside its "
            f"tolerance against the fp32 plain version (max abs err "
            f"{float(err.max()):.3e}, {share:.3f} of {tol})")
    del want, want_abs_v
    one = statistics.median(_time_ms(lambda: ops.flash_attention(
        q, k, v, causal=True, window=w, scale=scale), 3) for _ in range(5))
    # the band's work, its bound, and SDPA on the same inputs (a boolean
    # band mask, as phase kernels_flash gives it)
    flops = 4 * batch * cfg.num_heads * cfg.head_dim * _band_pairs(
        prompt, prompt, w)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S) * 1e3
    # SDPA on the same inputs: with the boolean band mask (as phase
    # kernels_flash gives it) and, where the band is plain causal, with
    # is_causal; each under the default dispatch (the backend it takes
    # recorded) and with each backend alone.  sdpa_ms_a_call is the least
    # of them.
    qi = torch.arange(prompt, device=dev)[:, None]
    kj = torch.arange(prompt, device=dev)[None]
    mask = (kj <= qi) & ((kj > qi - w) if w is not None else True)
    forms = {"mask": (mask, False)}
    if w is None:
        forms["is_causal"] = (None, True)
    sdpa = {form: dict(
        default_backend=_sdpa_choice(q, k, v, m, scale, c),
        default_ms=statistics.median(_time_ms(
            lambda: _sdpa_library_call(q, k, v, m, scale, c), 3)
            for _ in range(5)),
        **_sdpa_backends(q, k, v, m, scale, c))
        for form, (m, c) in forms.items()}
    timed = [(ms, form, b) for form, rec in sdpa.items()
             for b, ms in rec.items() if isinstance(ms, float)]
    best_ms, best_form, best = min(timed)
    if best == "default_ms":
        best = f"default ({sdpa[best_form]['default_backend']})"
    if "is_causal" in sdpa:
        out = _sdpa_library_call(q, k, v, None, scale, True)
        sdpa["is_causal"]["max_abs_err_vs_kernel"] = float(
            (out.float() - got.float()).abs().max())
        del out
    return dict(k3_shape=shape, k3_max_abs_err=float(err.max()),
                k3_share_of_tolerance=share, k3_tolerance=tol,
                k3_prefill_ms=one * n, k3_ms_a_call=one, k3_flops=flops,
                k3_tflops_per_s=flops / one / 1e9, k3_bound_ms=bound_ms,
                k3_bound_by="operations" if flops / PEAK_FLOPS[dtype]
                >= nbytes / HBM_BYTES_PER_S else "bytes",
                k3_share_of_bound=bound_ms / one, sdpa_ms_a_call=best_ms,
                sdpa_best=f"{best_form}, {best}", sdpa=sdpa)


def _k3_summary(rec):
    """K3's error as a share of its tolerance, its ms a call, and SDPA's
    best ms a call and form at one run's prefill (``_k3_at_prefill``), for
    K3's record in the kernels line."""
    return dict(share_of_tolerance=rec["k3_share_of_tolerance"],
                ms_a_call=rec["k3_ms_a_call"],
                sdpa_ms_a_call=rec["sdpa_ms_a_call"],
                sdpa_best=rec["sdpa_best"])


def phase_families_full(dev):
    """The six families at their published widths on the card (depth cut
    only where one card forces it, ``configs/one_card.py``): bf16 serving
    runs, and for granite, mamba2 and the fp32 cuts of jamba and deepseek
    an fp32 run held to the model's own forward within 2e-3
    (``tests/test_models.py``'s tolerance); K3 held to its plain version
    at every run's prefill shapes.  Returns K3's launches by run and, by
    run, ``_k3_summary`` of its prefill."""
    from repro_torch.configs.one_card import FAMILY_ARCHS, FP32_RUNS, RUNS
    by_run, k3_at, ok = {}, {}, True
    for arch in FAMILY_ARCHS:
        f = RUNS[arch]
        rec = _full_run(arch, dev, False, f)
        runs = {f"families_full.{arch}": rec}
        if arch in FP32_RUNS:
            g = FP32_RUNS[arch]
            agr = _full_run(arch, dev, True, g)
            rec["fp32_agreement"] = agr
            rec["ok"] &= agr["ok"]
            runs[f"families_full.{arch}.fp32"] = agr
        for name, r in runs.items():
            by_run[name] = r["kernel_launches"]
            if "k3_share_of_tolerance" in r:
                k3_at[name] = _k3_summary(r)
        emit("families_full", **rec)
        ok &= rec["ok"]
    if not ok:
        raise SystemExit("families_full failed")
    return by_run, k3_at


# ------------------------- the encoder-decoder and vision families (M14b) --
# whisper-small (an encoder over precomputed frames, a decoder with learned
# positions, causal self-attention and cross-attention over the K/V the
# prefill computes once) and internvl2-26b (patch embeddings before the
# text) through the serving steps, K3 in every decoder layer's prefill; the
# encoder's bidirectional attention is the plain product, as the reference
# routes it.  Shapes and the fp32 depth cut: ``configs/one_card.py``.
ENCDEC_SMALL = dict(batch=2, frames=24, patches=8, prompt=5, steps=4)


def _inputs_to(inp, dev):
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in inp.items()}


def phase_encdec_parity_small(dev):
    """whisper's and internvl2's smoke configs (``_parity_small``), the
    frames and patches with them."""
    from repro_torch.configs.one_card import ENCDEC_ARCHS
    _parity_small(dev, "encdec_parity_small", ENCDEC_ARCHS, ENCDEC_SMALL,
                  seed=3)


#: decode steps of a families_full or encdec_full run, at most: the
#: script's time limit (RUNS' 16-124 until PR 32)
FULL_DECODE_STEPS = 8


def _full_run(arch, dev, fp32, run):
    """One serving run of ``arch`` at full width on the card, bf16 weights
    or (``fp32``) fp32 ones, at ``run``'s shapes (``configs/one_card.py``:
    batch, prompt, steps (at most ``FULL_DECODE_STEPS``), and the frames or
    patches of whisper and internvl2): the model built and seeded there,
    the path driven with K3's count set to 0 just before it and read just
    after; then K3 checked and timed at the prefill's shapes.  (Until PR
    32 a warm prefill and the encoder's share of it were timed again.)"""
    from repro_torch.configs.one_card import (attention_layers,
                                              one_card_config, prompt_inputs)
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    cfg = one_card_config(arch, fp32=fp32)
    run = dict(run, steps=min(run["steps"], FULL_DECODE_STEPS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        dtype=torch.float32 if fp32 else None)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    inp = prompt_inputs(cfg, run, dev)
    steps = run["steps"]
    max_len = inp["start"] + steps + 8     # slots past the run stay empty
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    r = _prompt_run(model, inp, steps, max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    peak = torch.cuda.max_memory_allocated()
    logits = r["logits"]
    fwd_logits, _ = _forward_logits(model, r)
    dev_err = float((logits - fwd_logits).abs().max())
    agree = float((logits.argmax(-1) == fwd_logits.argmax(-1)).double()
                  .mean())
    leaves = _cache_leaves(r["cache"])
    checks = {
        "launches": launches == attention_layers(cfg),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "logits_shape": tuple(logits.shape) == (steps + 1, run["batch"],
                                                cfg.vocab_size),
        "tokens_in_vocab": all(0 <= t < cfg.vocab_size
                               for row in r["stream"] for t in row),
        **_cache_checks(r["cache"], inp["start"] + steps),
        "on_card": model.device.type == "cuda" and all(
            t.is_cuda for t in leaves.values()),
    }
    cross = {}
    if cfg.is_encoder_decoder:
        for name in ("cross_k", "cross_v"):
            t = r["cache"][name]
            checks[f"{name}_written"] = bool(torch.isfinite(t).all()
                                             and t.abs().sum() > 0)
        cross = dict(cross_kv_bytes=2 * r["cache"]["cross_k"].numel()
                     * r["cache"]["cross_k"].element_size(),
                     ring_width=int(r["cache"]["self"]["k"].shape[2]))
    if fp32:
        checks["own_forward_within_2e-3"] = dev_err <= 2e-3
    step_s = r["step_s"]
    out = dict(
        ok=all(checks.values()), checks=checks, arch=arch,
        dtype="float32" if fp32 else "declared (bf16 weights)",
        layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
        attention_layers=attention_layers(cfg),
        params=sum(p.numel() for p in model.parameters()), run=run,
        kernel_launches=launches, prefill_ms=r["prefill_s"] * 1e3,
        decode_ms_per_step_median=statistics.median(step_s) * 1e3,
        decode_ms_per_step_mean=statistics.fmean(step_s) * 1e3,
        decode_tokens_per_s=run["batch"] * steps / sum(step_s),
        wall_seconds=wall, init_seconds=init_s,
        peak_memory_bytes=peak, init_peak_memory_bytes=init_peak,
        max_logit_dev_vs_own_forward=dev_err,
        max_abs_logit_own_forward=float(fwd_logits.abs().max()),
        argmax_agreement_vs_own_forward=agree, **cross)
    del r, model, inp
    torch.cuda.empty_cache()
    b = run["batch"]
    s = run["prompt"] + run.get("patches", 0)
    out.update(_k3_at_prefill(cfg, b, s, torch.float32 if fp32
                              else torch.bfloat16, dev))
    torch.cuda.empty_cache()
    return out


def phase_encdec_full(dev):
    """whisper-small and internvl2-26b whole at published widths in bf16
    (seeded weights drawn on the card), each also in fp32 (internvl2 cut
    in depth) held to its own forward within 2e-3; K3 held to its plain
    version at every run's prefill shapes.  Returns K3's launches by run
    and, by run, ``_k3_summary`` of its prefill."""
    from repro_torch.configs.one_card import (ENCDEC_ARCHS, ENCDEC_FP32_RUNS,
                                              ENCDEC_RUNS)
    by_run, k3_at, ok = {}, {}, True
    for arch in ENCDEC_ARCHS:
        rec = _full_run(arch, dev, False, ENCDEC_RUNS[arch])
        agr = _full_run(arch, dev, True, ENCDEC_FP32_RUNS[arch])
        rec["fp32_agreement"] = agr
        rec["ok"] &= agr["ok"]
        for name, r in ((f"encdec_full.{arch}", rec),
                        (f"encdec_full.{arch}.fp32", agr)):
            by_run[name] = r["kernel_launches"]
            k3_at[name] = _k3_summary(r)
        emit("encdec_full", **rec)
        ok &= rec["ok"]
    if not ok:
        raise SystemExit("encdec_full failed")
    return by_run, k3_at


# --------------------------------------------- the model meshes (M14b) --
# granite-moe-1b-a400m's MoE through the three sharded paths of
# ``models/moe.py`` on meshes of the one card (``launch/mesh.py``:
# ``[card] * n``; ``sharding/rules.py::shard_map`` runs a thread a
# coordinate).
# 4 decode steps (16 until PR 31: cut for the script's time limit, the
# placed MoE steps of moe_mesh_full added beside this eager mesh route)
MESH_FULL = dict(arch="granite-moe-1b-a400m", batch=4, prompt=2048,
                 steps=4, shapes=((1, 1), (2, 2)))


def _moe_modules(model):
    from repro_torch.models.moe import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


def _plain_dropped(xs, routers, cfg, impl, shape, cf):
    """The (token, expert) pairs past capacity, counted from the routing
    of each layer's MoE input ``xs[i]`` (router ``routers[i]``) over the
    token set each coordinate routes (its batch rows; for sharded_a2a its
    batch rows and sequence slice; for sharded2d every row, gathered): an
    expert's (or for sharded_a2a an owner's) pairs beyond the capacity.
    The routing products run at the coordinates' own shapes.  A sequence
    the model axis does not split, or of one token, takes sharded_a2a to
    sharded2d, as ``moe_sharded_a2a`` does."""
    from repro_torch.models.moe import router_topk
    m = cfg.moe
    data, model_ax = shape
    total = 0
    for x, router in zip(xs, routers):
        b, s, d = x.shape
        path = impl
        if impl == "sharded_a2a" and (s % model_ax or s == 1):
            path = "sharded2d"
        if path == "sharded":
            sets = [x[i * b // data:(i + 1) * b // data]
                    for i in range(data)]
            cap = max(8, int((b // data) * s * m.top_k * cf
                             / m.num_experts))
            owner = 1
        elif path == "sharded2d":
            sets = [x]
            cap = max(8, int(b * s * m.top_k * cf / m.num_experts))
            owner = 1
        else:
            n_ep = data * model_ax
            sets = [x[i * b // data:(i + 1) * b // data,
                      j * s // model_ax:(j + 1) * s // model_ax]
                    for i in range(data) for j in range(model_ax)]
            cap = max(8, int((b // data) * (s // model_ax) * m.top_k * cf
                             / n_ep))
            owner = m.num_experts // n_ep
        for xs_ in sets:
            logits = xs_.reshape(-1, d).to(torch.float32) @ router.to(
                torch.float32)
            _, idx = router_topk(logits, m.top_k)
            counts = torch.bincount(idx.reshape(-1) // owner)
            total += int((counts - cap).clamp_min(0).sum())
    return total


def phase_mesh_full(dev):
    """granite's prefill (B 4 x 2,048) and 4 decode steps with each
    sharded ``moe_impl`` on a (1, 1) and a (2, 2) mesh of the card: in
    fp32 at a capacity that drops nothing (cf = E / top_k) the logits held
    to the dense path within 2e-3; in bf16 at the config's cf 1.25 the
    dropped (token, expert) pairs of the prefill ``==`` a plain count of
    the same routing, and each path's prefill ms beside dense, one prefill
    a path (the placed paths of ``moe_mesh_full`` time the same dispatch
    warm).  Returns K3's launches (one a layer a prefill)."""
    from repro_torch.configs.one_card import prompt_inputs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.sharding.rules import ShardCtx
    t_phase = time.perf_counter()
    f = MESH_FULL
    cfg = get_config(f["arch"])
    impls = ("sharded", "sharded2d", "sharded_a2a")
    meshes = {s: make_mesh(s, ("data", "model"),
                           devices=[dev] * (s[0] * s[1]))
              for s in f["shapes"]}
    run = dict(batch=f["batch"], prompt=f["prompt"])
    max_len = f["prompt"] + f["steps"] + 8
    checks, agreement, launches, prefills = {}, {}, 0, 0
    # fp32, capacity for every pair: each sharded path is the dense path
    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(free, device=dev, dtype=torch.float32)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    inp = prompt_inputs(cfg, run, dev)
    ops.launches = 0                        # just before the main path ...
    dense = _prompt_run(model, inp, f["steps"], max_len)
    prefills += 1
    for shape, mesh in meshes.items():
        for impl in impls:
            ctx = ShardCtx(mesh=mesh, pod_axis=None, moe_impl=impl,
                           attn_impl="flash")
            r = _prompt_run(model, inp, f["steps"], max_len, ctx=ctx)
            prefills += 1
            err = float((r["logits"] - dense["logits"]).abs().max())
            key = f"{shape[0]}x{shape[1]}.{impl}"
            agreement[key] = dict(
                max_logit_dev_vs_dense=err,
                streams_equal=r["stream"] == dense["stream"],
                prefill_ms=r["prefill_s"] * 1e3,
                decode_ms_per_step_median=statistics.median(r["step_s"])
                * 1e3)
            checks[f"fp32_{key}_within_2e-3_of_dense"] = err <= 2e-3
            del r
    fp32_dense = dict(prefill_ms=dense["prefill_s"] * 1e3,
                      decode_ms_per_step_median=statistics.median(
                          dense["step_s"]) * 1e3)
    del model, dense
    torch.cuda.empty_cache()
    # bf16 at the config's capacity: drops, counted, and prefill times
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    mods = _moe_modules(model)
    timing, drops, xs = {}, {}, []
    d = _prompt_run(model, inp, 0, max_len)
    prefills += 1
    timing["dense"] = d["prefill_s"] * 1e3
    del d
    # each MoE layer's input, for the plain count of its drops
    hooks = [m.register_forward_pre_hook(lambda mod, args: xs.append(
        args[0].detach())) for m in mods]
    for shape, mesh in meshes.items():
        for impl in impls:
            ctx = ShardCtx(mesh=mesh, pod_axis=None, moe_impl=impl,
                           attn_impl="flash")
            stats = {}
            for m in mods:
                m.stats = stats
            xs.clear()
            r = _prompt_run(model, inp, 0, max_len, ctx=ctx)
            prefills += 1
            for m in mods:
                m.stats = None
            want = _plain_dropped(xs, [m.router for m in mods], cfg, impl,
                                  shape, cfg.moe.capacity_factor)
            key = f"{shape[0]}x{shape[1]}.{impl}"
            drops[key] = dict(dropped=stats.get("dropped", 0),
                              plain_count=want,
                              pairs=len(mods) * f["batch"] * f["prompt"]
                              * cfg.moe.top_k)
            checks[f"bf16_{key}_drops_equal_plain_count"] = \
                stats.get("dropped", 0) == want
            xs.clear()
            timing[key] = r["prefill_s"] * 1e3
            del r
    launches = ops.launches                 # ... and read just after it
    for h in hooks:
        h.remove()
    checks["launches"] = launches == prefills * cfg.num_layers
    # with no devices named, a mesh takes the visible cards: here the one
    checks["default_mesh_is_the_card"] = ShardCtx(mesh=make_mesh(
        (1, 1), ("data", "model"))).mesh.device_at((0, 0)) == dev
    del model, xs
    torch.cuda.empty_cache()
    emit("mesh_full", ok=all(checks.values()), checks=checks,
         arch=f["arch"], batch=f["batch"], prompt=f["prompt"],
         decode_steps=f["steps"], meshes=[list(s) for s in f["shapes"]],
         capacity_factor_free=free.moe.capacity_factor,
         capacity_factor=cfg.moe.capacity_factor,
         fp32_dense=fp32_dense, fp32_agreement=agreement,
         bf16_prefill_ms=timing, bf16_drops=drops,
         kernel_launches=launches, phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("mesh_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ------------------------------------------------ the sharded steps (M18) --
# Phase spmd_parity_small: qwen2-1.5b's smoke config in fp32 on a 2 x 2
# mesh of the card listed four times, against the unsharded steps on the
# card: jit_train_step (2 microbatches; the loss, the updated parameters
# and the first moment), then jit_prefill_step and 4 jit_decode_step steps
# on fixed tokens (the logits of each); every block on its coordinate's
# device with its spec's shape; every replica torch.equal after the step.
# lr 1e-4: AdamW's first update is lr g / (|g| + eps), and a gradient
# within a few eps of 0 moves its parameter by a share of lr that its
# rounding decides (tests/test_torch_spmd.py).
SPMD_SMALL = dict(arch="qwen2-1.5b", shape=(2, 2), seed=0, batch=8, seq=32,
                  microbatches=2, lr=1e-4, serve_batch=4, prompt=13, steps=4,
                  tol=2e-5)
# Phase spmd_full: the mesh 2 x 2, on four distinct cards where four are
# visible, else the card listed four times.  qwen2-1.5b whole at
# TRAIN_FULL's batch (1 fused step, bf16; 2 until PR 33) and an fp32 cut
# of it (its first 2 layers at full width, one step beside the unsharded
# step);
# qwen2-7b whole served at configs/one_card.py's B 4 x 2,048 with 4 greedy
# steps (the script's time limit; 8 until PR 32), K3 in every
# coordinate's prefill: 28 layers x 4 coordinates a prefill), beside the
# unsharded steps on the same prompt, and the same with the
# sequence-sharded cache (SP, seq_shard_kv) over "model"; at B 1 x 2,048
# + 4 (the batch does not split: every coordinate holds the row) placed,
# and with SP over ("data", "model");
# each beside the unsharded steps on its prompt.  fp32 cuts (the first 2
# layers at full width, the same prompt and 4 decode steps fed the
# unsharded run's tokens), placed and with SP over "model", and a window
# cut of danube with SP (B 2 x 6,144 + 4: the ring of 4,096 wraps across
# its two blocks of 2,048 slots), whose logits are held to the unsharded
# step's within _rounding_bound, every greedy token agreeing;
# with four cards also qwen2-7b training whole across them (B 8 x 2,048, 2
# microbatches, remat: the FSDP gathers again in the backward) and
# qwen2-1.5b's steps on the four cards beside the card listed four times.
SPMD_FULL = dict(shape=(2, 2), train_arch="qwen2-1.5b", train_steps=1,
                 cut_layers=2, cut_tol=2e-3, serve_arch="qwen2-7b",
                 serve_steps=4, serve_cut_steps=4,
                 b1=dict(batch=1, prompt=2048, steps=4),
                 window_arch="h2o-danube-1.8b",
                 window_run=dict(batch=2, prompt=6144, steps=4),
                 train7b=dict(batch=8, seq=2048, microbatches=2, steps=3,
                              remat=True, lr=3e-4))


def _spmd_mesh(devices):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(SPMD_FULL["shape"], ("data", "model"), devices=devices)


def _sync_all(mesh):
    for d in {d for d in mesh.devices.flat}:
        torch.cuda.synchronize(d)


def _placement_ok(tree):
    """Every block of every placed leaf on its coordinate's device with
    its spec's shape."""
    from repro_torch.sharding import spmd
    ok = []

    def one(p):
        if p is None:
            return
        want = spmd.block_shape(p.shape, p.spec, p.mesh)
        ok.append(all(b.device == spmd.coordinate_device(p.mesh, c)
                      and tuple(b.shape) == want
                      for c, b in zip(p.mesh.coords(), p.blocks)))
    spmd.map_tree(one, tree)
    return all(ok)


def _replicas_equal(tree):
    """Every replica of every placed leaf torch.equal to the one at index
    0 of each axis its spec does not name."""
    from repro_torch.sharding import spmd
    ok = []

    def one(p):
        if p is None:
            return
        named = spmd.spec_axes(p.spec)
        coords = p.mesh.coords()
        rank = {c: r for r, c in enumerate(coords)}
        for c, b in zip(coords, p.blocks):
            home = tuple(i if a in named else 0
                         for a, i in zip(p.mesh.axis_names, c))
            ok.append(torch.equal(b, p.blocks[rank[home]].to(b.device)))
    spmd.map_tree(one, tree)
    return all(ok)


def _gather_err(placed, plain):
    from repro_torch.sharding import spmd
    return max(float((spmd.gather(placed[n]).float() - plain[n].detach()
                      .float()).abs().max()) for n in plain)


def phase_spmd_parity_small(dev):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import serve as rs
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    f = SPMD_SMALL
    cfg = get_smoke(f["arch"])
    mesh = _spmd_mesh([dev] * 4)
    ctx = ShardCtx(mesh=mesh, pod_axis=None)
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init_params(torch.Generator(device=dev).manual_seed(f["seed"]))
    ocfg = adamw.AdamWConfig(lr=f["lr"], warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(f["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        f["batch"], f["seq"] + 1))).to(dev)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, ocfg)
    checks = {"placed_on_coordinates": _placement_ok((placed, opt))}
    step = rt.jit_train_step(model, ocfg, ctx,
                             microbatches=f["microbatches"])
    placed, opt, m = step(placed, opt, {"tokens": toks})
    _sync_all(mesh)
    checks["replicas_equal_after_step"] = _replicas_equal((placed, opt))
    params = rt.train_params(model)
    o0 = adamw.init_state(params, ocfg)
    _, o0, m0 = rt.jit_train_step(model, ocfg, ShardCtx(),
                                  microbatches=f["microbatches"])(
        params, o0, {"tokens": toks})
    errs = {"loss": abs(float(m["loss"]) - float(m0["loss"])),
            "params": _gather_err(placed, params),
            "first_moment": _gather_err(opt["m"], o0["m"])}
    for k in ("loss", "params", "first_moment"):
        checks[f"train_{k}_within_tol"] = errs[k] <= f["tol"]
    # serving: the updated model's parameters placed by serve_shardings
    b, p, n = f["serve_batch"], f["prompt"], f["steps"]
    max_len = p + n
    sp = rt.placed_params(model, ctx, mode="serve")
    cache = rs.init_cache(model, ctx, b, max_len, dtype=torch.float32)
    checks["serve_placed_on_coordinates"] = _placement_ok((sp, cache))
    cache0 = model.init_cache(b, max_len, dtype=torch.float32)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p))).to(dev)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, b))).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    with torch.no_grad():
        lg, cache = rs.jit_prefill_step(model, ctx, b, max_len)(
            sp, prompt, pos, cache)
        lg0, cache0 = rs.make_prefill_step(model, ShardCtx())(prompt, pos,
                                                              cache0)
        serr = [float((lg - lg0).abs().max())]
        dec = rs.jit_decode_step(model, ctx, b, max_len)
        dec0 = rs.make_decode_step(model, ShardCtx())
        for i in range(n):
            q = torch.full((b,), p + i, device=dev)
            lg, cache = dec(sp, nxt[i][:, None], q, cache)
            lg0, cache0 = dec0(nxt[i][:, None], q, cache0)
            serr.append(float((lg - lg0).abs().max()))
    errs["serve_logits_by_call"] = serr
    checks["serve_logits_within_tol"] = max(serr) <= f["tol"]
    emit("spmd_parity_small", ok=all(checks.values()), checks=checks,
         max_abs_err=errs, config=dict(f, heads=[cfg.num_heads,
                                                 cfg.num_kv_heads]),
         loss=[float(m["loss"]), float(m0["loss"])])
    del model, placed, opt, params, o0, sp, cache, cache0
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit("spmd_parity_small failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def _peaks(mesh):
    return {str(d): torch.cuda.max_memory_allocated(d)
            for d in sorted({d for d in mesh.devices.flat}, key=str)}


def _reset_peaks(mesh):
    for d in {d for d in mesh.devices.flat}:
        torch.cuda.reset_peak_memory_stats(d)


def _spmd_train(cfg, mesh, *, batch, seq, microbatches, steps, lr, remat,
                dtype=None, seed=0, unsharded=False, batches=None,
                digests=False, **ctx_kw):
    """``steps`` fused steps of ``jit_train_step`` on ``mesh`` from seeded
    parameters (drawn on the mesh's first device, placed, the model's own
    then dropped to the meta device), batches from ``ShardedBatches`` (or
    ``batches``, a batch dict a step: ``_family_batches``).  With
    ``unsharded`` the first step is also run unsharded from the same
    parameters, first; with ``digests`` the record keeps the SHA-1 of
    every parameter block after step 1 (``_digests``).  ``ctx_kw``: more
    ``ShardCtx`` fields.  Returns a record and the state."""
    from repro_torch.data.pipeline import DataConfig, ShardedBatches
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    dev0 = mesh.devices.flat[0]
    model = build_model(cfg, device=dev0, dtype=dtype)
    model.init_params(torch.Generator(device=dev0).manual_seed(seed))
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    if batches is None:
        data = ShardedBatches(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch))
        batches = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"])
                    .to(dev0)} for i in range(steps)]
    rec = {}
    if unsharded:
        params = rt.train_params(model)
        init = {n: p.detach().clone() for n, p in params.items()}
        o0 = adamw.init_state(params, ocfg)
        torch.cuda.synchronize(dev0)
        t0 = time.perf_counter()
        m0 = rt.jit_train_step(model, ocfg, ShardCtx(remat=remat),
                               microbatches=microbatches)(
            params, o0, batches[0])[2]
        rec["unsharded_step1_loss"] = float(m0["loss"])
        rec["unsharded_step1_ms"] = (time.perf_counter() - t0) * 1e3
        del o0
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        del init, params, m0
        torch.cuda.empty_cache()
    ctx = ShardCtx(mesh=mesh, pod_axis=None, remat=remat, **ctx_kw)
    t0 = time.perf_counter()
    placed = rt.placed_params(model, ctx)
    model.to("meta")                     # the placed blocks are the model
    torch.cuda.empty_cache()
    opt = adamw.init_state(placed, ocfg)
    _sync_all(mesh)
    rec["place_and_state_s"] = time.perf_counter() - t0
    rec["placed_on_coordinates"] = _placement_ok((placed, opt))
    step = rt.jit_train_step(model, ocfg, ctx, microbatches=microbatches)
    _reset_peaks(mesh)
    runs = []
    for i in range(steps):
        _sync_all(mesh)
        t0 = time.perf_counter()
        placed, opt, m = step(placed, opt, batches[i])
        _sync_all(mesh)
        runs.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                         loss=float(m["loss"]), aux=float(m["aux"]),
                         grad_norm=float(m["grad_norm"])))
        if digests and i == 0:
            rec["digests_step1"] = _digests(placed)
    rec.update(steps=runs, peak_bytes_by_device=_peaks(mesh),
               replicas_equal=_replicas_equal((placed, opt)),
               finite=all(np.isfinite([r["loss"], r["aux"], r["grad_norm"]])
                          .all() for r in runs))
    steady = [r["step_ms"] for r in runs[1:]] or [runs[0]["step_ms"]]
    rec["ms_a_step"] = statistics.mean(steady)
    rec["tokens_per_s"] = batch * seq / (rec["ms_a_step"] / 1e3)
    rec["params"] = sum(p.numel() for p in placed.values())
    return rec, (model, placed, opt)


def _serve_fed(model, mesh, inp, feed, max_len, keep_model=False,
               **ctx_kw):
    """The prefill of ``inp`` (flash attention) and a decode step for each
    row of ``feed`` (the tokens of an earlier run's stream): with a
    ``mesh`` the sharded steps (``ctx_kw``: more ``ShardCtx`` fields), the
    model's parameters placed by ``serve_shardings`` and its own then
    dropped to the meta device unless ``keep_model``; without one the
    unsharded steps.  Returns the logits of every call on the host,
    (len(feed) + 1, B, V)."""
    from repro_torch.runtime import serve as rs
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    b = inp["tokens"].shape[0]
    dev0 = inp["tokens"].device
    dtype = model.embed.tok.dtype
    kw = inp.get("cache_kw", {})
    if mesh is None:
        ctx, sp = ShardCtx(attn_impl="flash"), None
        cache = model.init_cache(b, max_len, dtype=dtype, **kw)
    else:
        ctx = ShardCtx(mesh=mesh, pod_axis=None, attn_impl="flash",
                       **ctx_kw)
        sp = rt.placed_params(model, ctx, mode="serve")
        if not keep_model:
            model.to("meta")
        cache = rs.init_cache(model, ctx, b, max_len, dtype=dtype, **kw)
    logits, cache = rs.jit_prefill_step(model, ctx, b, max_len, **kw)(
        sp, inp["tokens"], inp["positions"], cache, inp.get("embeds"))
    out = [logits[:, -1].cpu()]
    decode = rs.jit_decode_step(model, ctx, b, max_len, **kw)
    for i, tok in enumerate(feed):
        pos = torch.full((b,), inp["start"] + i, dtype=torch.int64,
                         device=dev0)
        logits, cache = decode(sp, torch.tensor(tok, device=dev0)[:, None],
                               pos, cache)
        out.append(logits[:, 0].cpu())
    return torch.stack(out)


@torch.no_grad()
def _swap_ff_halves(model):
    """The MLPs' ff columns (and ``wo``'s rows) in the other order, halves
    swapped: the same function, its down product summed in another order
    (as a 2-way model axis sums its halves)."""
    for n, p in model.named_parameters():
        if n.endswith(("ffn.wi_gate", "ffn.wi_up")):
            p.copy_(torch.cat(p.chunk(2, 1)[::-1], 1))
        elif n.endswith("ffn.wo"):
            p.copy_(torch.cat(p.chunk(2, 0)[::-1], 0))


def _mesh_devices(n=4):
    return [torch.device("cuda", i) for i in range(n)]


def _rounding_bound(cfg, scale):
    """The gate of a sharded fp32 cut's logits against the unsharded
    step's: sqrt(n) fp32 epsilons of the largest logit ``scale``, n the
    longest reduction the split reorders (the MLP's d_ff terms or the d
    of the head, the output projection and the expert sums)."""
    return (math.sqrt(max(cfg.d_ff, cfg.d_model))
            * torch.finfo(torch.float32).eps * scale)


def _cut(cfg, layers):
    from repro_torch.configs.base import LayerGroup
    return dataclasses.replace(cfg, num_layers=layers, groups=(
        LayerGroup(layers, cfg.groups[0].blocks),))


def _fp32_gate(cfg, mesh, inp, steps, dev, seed=0, **ctx_kw):
    """``cfg`` in fp32 on ``dev``: the unsharded steps over ``inp`` and
    ``steps`` greedy tokens, then the sharded steps (``ctx_kw``) fed the
    same tokens, for each ``ShardCtx`` option set in ``ctx_kw["each"]``
    (default: one, ``ctx_kw``).  Returns a record by option set: the
    logits' max deviation by call, the bound, whether every greedy token
    agrees."""
    from repro_torch.models.model_zoo import build_model
    each = ctx_kw.pop("each", [ctx_kw])
    p = inp["start"]
    m32 = build_model(cfg, device=dev, dtype=torch.float32)
    m32.init_params(torch.Generator(device=dev).manual_seed(seed))
    out = {}
    with torch.no_grad():
        ref32 = _prompt_run(m32, inp, steps, p + steps)
        feed = ref32["stream"][:steps]
        scale = float(ref32["logits"].abs().max())
        for i, kw in enumerate(each):
            got = _serve_fed(m32, mesh, inp, feed, p + steps,
                             keep_model=i < len(each) - 1, **kw)
            devs = [float((g - r).abs().max())
                    for g, r in zip(got, ref32["logits"])]
            out[",".join(f"{k}={v}" for k, v in kw.items()) or "default"] = \
                dict(logits_max_abs_dev_by_call=devs, logits_max_abs=scale,
                     bound=_rounding_bound(cfg, scale),
                     within_bound=max(devs) <= _rounding_bound(cfg, scale),
                     greedy_tokens_all_agree=[
                         r.tolist() for r in got.argmax(-1)]
                     == ref32["stream"])
            del got
    del m32, ref32
    torch.cuda.empty_cache()
    return out


def _placed_serve(model, sp, ctx, inp, steps, mesh, plain=None):
    """``jit_prefill_step`` over ``inp`` and ``steps`` greedy
    ``jit_decode_step`` steps on the placed parameters ``sp`` and a fresh
    placed cache of prompt + ``steps`` slots (host clock, every card
    synchronised; the peak bytes a card from just before).  Beside the
    unsharded run ``plain`` (``_prompt_run``) where given.  Returns (the
    record with its ``checks``, the cache)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime import serve as rs
    from repro_torch.sharding import spmd
    b, p = inp["tokens"].shape[0], inp["start"]
    max_len = p + steps
    dev0 = inp["tokens"].device
    kw = inp.get("cache_kw", {})
    cache = rs.init_cache(model, ctx, b, max_len, **kw)
    prefill = rs.jit_prefill_step(model, ctx, b, max_len, **kw)
    decode = rs.jit_decode_step(model, ctx, b, max_len, **kw)
    _reset_peaks(mesh)
    k3_0 = ops.launches
    _sync_all(mesh)
    t0 = time.perf_counter()
    logits, cache = prefill(sp, inp["tokens"], inp["positions"], cache,
                            inp.get("embeds"))
    tok = torch.argmax(logits[:, -1], dim=-1)
    stream = [tok.tolist()]
    prefill_s = time.perf_counter() - t0
    k3_prefill = ops.launches - k3_0
    lg_all, step_s = [logits[:, -1].cpu()], []
    for i in range(steps):
        t0 = time.perf_counter()
        pos = torch.full((b,), p + i, dtype=torch.int64, device=dev0)
        logits, cache = decode(sp, tok[:, None], pos, cache)
        tok = torch.argmax(logits[:, 0], dim=-1)
        stream.append(tok.tolist())
        step_s.append(time.perf_counter() - t0)
        lg_all.append(logits[:, 0].cpu())
    lg_all = torch.stack(lg_all)
    rec = dict(batch=b, prompt=p, steps=steps, prefill_ms=prefill_s * 1e3,
               k3_launches_prefill=k3_prefill,
               peak_bytes_by_device=_peaks(mesh), stream=stream)
    if steps:
        rec.update(decode_ms_per_step_median=statistics.median(step_s) * 1e3,
                   decode_ms_per_step_mean=statistics.mean(step_s) * 1e3,
                   tokens_per_s=b * steps / sum(step_s))
    whole = spmd.gather_tree(cache, "cpu")
    vocab = model.cfg.vocab_size
    rings = ([whole["self"]] if "self" in whole else
             [c for g in whole["groups"] for c in g["blocks"]])
    checks = dict(
        logits_finite=bool(torch.isfinite(lg_all).all()),
        tokens_in_vocab=all(0 <= t < vocab for s_ in stream for t in s_),
        # no window and one slot a position: every slot written once (a
        # Mamba cache has no slots)
        cache_pos_every_slot=model.cfg.sliding_window is not None or all(
            torch.equal(c["pos"], torch.arange(max_len, dtype=torch.int32)
                        .expand_as(c["pos"]))
            for c in rings if "pos" in c),
        placed_on_coordinates=_placement_ok((sp, cache)))
    if "cross_k" in whole:
        # the cross K/V written at prefill (every frame of every layer)
        checks["cross_kv_written"] = all(
            bool((whole[k].abs().amax(dim=(-1, -2)) > 0).all())
            for k in ("cross_k", "cross_v"))
    if plain is not None:
        n_plain = len(plain["stream"])
        rec.update(
            unsharded_prefill_ms=plain["prefill_s"] * 1e3,
            prefill_logits_max_abs_dev_vs_unsharded=float(
                (lg_all[0] - plain["logits"][0]).abs().max()),
            prefill_logits_max_abs=float(plain["logits"][0].abs().max()),
            greedy_tokens_agreeing_with_unsharded=float(np.mean([
                a == b_ for s1, s2 in zip(stream[:n_plain], plain["stream"])
                for a, b_ in zip(s1, s2)])))
        if plain["step_s"]:
            rec["unsharded_decode_ms_per_step_median"] = statistics.median(
                plain["step_s"]) * 1e3
    rec["checks"] = checks
    del whole
    return rec, cache


def phase_spmd_full(dev):
    """Returns K3's launches in the main path (the sharded qwen2-7b
    prefills, placed and with SP, and the fp32 cuts) and K3's records at
    the B 4 and B 1 coordinates' prefill shapes."""
    from repro_torch.configs.one_card import RUNS, prompt_inputs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    t_phase = time.perf_counter()
    f = SPMD_FULL
    four = torch.cuda.device_count() >= 4
    cards = _mesh_devices() if four else [dev] * 4
    mesh = _spmd_mesh(cards)
    checks, out = {}, {"cards": [str(d) for d in cards],
                       "distinct_cards": len(set(cards))}
    # (a) qwen2-1.5b whole, TRAIN_FULL's batch
    cfg = get_config(f["train_arch"])
    tf = dict(batch=TRAIN_FULL["global_batch"], seq=TRAIN_FULL["seq_len"],
              microbatches=TRAIN_FULL["microbatches"],
              steps=f["train_steps"], lr=TRAIN_FULL["lr"], remat=False)
    rec, state = _spmd_train(cfg, mesh, **tf)
    del state
    torch.cuda.empty_cache()
    out["train_qwen2_1.5b"] = rec
    checks["train_1.5b_finite"] = rec["finite"]
    checks["train_1.5b_replicas_equal"] = rec["replicas_equal"]
    checks["train_1.5b_placed"] = rec["placed_on_coordinates"]
    # (a') the fp32 cut: step 1's loss beside the unsharded step's
    crec, state = _spmd_train(_cut(cfg, f["cut_layers"]), mesh,
                              **dict(tf, steps=1),
                              dtype=torch.float32, unsharded=True)
    del state
    torch.cuda.empty_cache()
    crec["step1_loss_diff"] = abs(crec["steps"][0]["loss"]
                                  - crec["unsharded_step1_loss"])
    out["train_fp32_cut"] = crec
    checks["fp32_cut_loss_within_2e-3"] = (crec["step1_loss_diff"]
                                           <= f["cut_tol"])
    checks["fp32_cut_replicas_equal"] = crec["replicas_equal"]
    # (b) qwen2-7b whole, served at one_card.py's run (B 4) and at B 1,
    # placed and with SP, beside the unsharded steps
    cfg7 = get_config(f["serve_arch"])
    run = dict(RUNS[f["serve_arch"]], steps=f["serve_steps"])
    b, p, n = run["batch"], run["prompt"], run["steps"]
    run1 = f["b1"]
    model = build_model(cfg7, device=cards[0])
    model.init_params(torch.Generator(device=cards[0]).manual_seed(0))
    inp = prompt_inputs(cfg7, run, cards[0])
    inp1 = prompt_inputs(cfg7, run1, cards[0], seed=1)
    plain = {4: _prompt_run(model, inp, n, p + n),           # flash
             1: _prompt_run(model, inp1, run1["steps"],
                            run1["prompt"] + run1["steps"])}
    ctx = ShardCtx(mesh=mesh, pod_axis=None, attn_impl="flash")
    sp = rt.placed_params(model, ctx, mode="serve")    # SP or not: the same
    model.to("meta")
    torch.cuda.empty_cache()
    ops.launches = 0                        # just before the main path ...
    serve, launches = {}, 0
    for name, kv in (("placed_b4", False), ("sp_model_b4", "model"),
                     ("placed_b1", False),
                     ("sp_data_model_b1", ("data", "model"))):
        b_ = 1 if name.endswith("b1") else 4
        rec, cache = _placed_serve(
            model, sp, dataclasses.replace(ctx, seq_shard_kv=kv),
            inp if b_ == 4 else inp1, n if b_ == 4 else run1["steps"], mesh,
            plain[b_])
        rec["cache_k_spec"] = cache["groups"][0]["blocks"][0]["k"].spec
        checks.update({f"serve_{name}_{k}": v for k, v in rec.pop("checks")
                       .items()})
        checks[f"serve_{name}_k3_launches_28_x_4_a_prefill"] = (
            rec["k3_launches_prefill"] == cfg7.num_layers * mesh.size)
        serve[name] = rec
        del cache
        torch.cuda.empty_cache()
    for sp_name, placed_name in (("sp_model_b4", "placed_b4"),
                                 ("sp_data_model_b1", "placed_b1")):
        a_, c_ = serve[sp_name].pop("stream"), serve[placed_name].pop("stream")
        serve[sp_name]["greedy_tokens_agreeing_with_placed"] = float(
            np.mean([x == y for s1, s2 in zip(a_, c_)
                     for x, y in zip(s1, s2)]))
    # the slots (the cache's dim 2 after layers and batch) over the SP axes
    checks["serve_sp_kv_seq_split"] = (
        serve["sp_model_b4"]["cache_k_spec"][2] == "model"
        and serve["sp_data_model_b1"]["cache_k_spec"][2]
        == ("data", "model"))
    launches = ops.launches                 # ... and read just after
    del sp, plain, model
    torch.cuda.empty_cache()
    # (b') the fp32 cut: its logits beside the unsharded step's, placed and
    # with SP, bounded by the typical rounding of the longest reduction the
    # split reorders at the logits' scale (_rounding_bound); beside them
    # the spread of the unsharded step with only the ff sum's order changed
    cut7 = _cut(cfg7, f["cut_layers"])
    m32 = build_model(cut7, device=cards[0], dtype=torch.float32)
    m32.init_params(torch.Generator(device=cards[0]).manual_seed(0))
    nc = f["serve_cut_steps"]
    k3_0 = ops.launches
    with torch.no_grad():
        ref32 = _prompt_run(m32, inp, nc, p + nc)
        feed = ref32["stream"][:nc]
        _swap_ff_halves(m32)
        ctrl32 = _serve_fed(m32, None, inp, feed, p + nc)
        _swap_ff_halves(m32)
        got32 = {kv: _serve_fed(m32, mesh, inp, feed, p + nc,
                                keep_model=not kv, seq_shard_kv=kv)
                 for kv in (False, "model")}
    scale = float(ref32["logits"].abs().max())
    bound = _rounding_bound(cut7, scale)
    cut_rec = dict(layers=f["cut_layers"], decode_steps=nc,
                   logits_max_abs=scale, bound=bound,
                   ff_order_control_max_abs_dev_by_call=[
                       float((c_ - r).abs().max())
                       for c_, r in zip(ctrl32, ref32["logits"])])
    for kv, got in got32.items():
        name = "sp_model" if kv else "placed"
        dev32 = [float((g - r).abs().max())
                 for g, r in zip(got, ref32["logits"])]
        agree = [r.tolist() for r in got.argmax(-1)] == ref32["stream"]
        cut_rec[name] = dict(logits_max_abs_dev_by_call=dev32,
                             greedy_tokens_all_agree=agree)
        checks[f"serve_fp32_cut_{name}_logits_within_rounding_bound"] = (
            max(dev32) <= bound)
        checks[f"serve_fp32_cut_{name}_greedy_tokens_agree"] = agree
    serve["fp32_cut"] = cut_rec
    del m32, ref32, got32, ctrl32
    torch.cuda.empty_cache()
    # danube's window cut with SP: the ring wraps across the blocks
    wcfg = get_config(f["window_arch"])
    serve["fp32_window_cut_danube"] = gate = _fp32_gate(
        _cut(wcfg, f["cut_layers"]), mesh,
        prompt_inputs(wcfg, f["window_run"], cards[0]),
        f["window_run"]["steps"], cards[0], seq_shard_kv="model")
    for kw, r in gate.items():
        checks[f"serve_fp32_window_cut_{kw}_within_bound"] = r["within_bound"]
        checks[f"serve_fp32_window_cut_{kw}_tokens_agree"] = \
            r["greedy_tokens_all_agree"]
    launches += ops.launches - k3_0
    # K3 at the coordinate's prefill shape, against its plain version
    coord = cfg7.scaled(num_heads=cfg7.num_heads // mesh.shape["model"],
                        num_kv_heads=cfg7.num_kv_heads // mesh.shape["model"])
    k3 = _k3_at_prefill(coord, b // mesh.shape["data"], p, torch.bfloat16,
                        cards[0])
    serve["k3_at_b4_coordinate"] = {k: v for k, v in k3.items()
                                    if k != "sdpa"}
    k3_1 = _k3_at_prefill(coord, 1, run1["prompt"], torch.bfloat16, cards[0])
    serve["k3_at_b1_coordinate"] = {k: v for k, v in k3_1.items()
                                    if k != "sdpa"}
    out["serve_qwen2_7b"] = serve
    # (c) four cards: qwen2-7b trains whole across them; qwen2-1.5b's
    # steps on the four cards beside the card listed four times
    if four:
        t7 = f["train7b"]
        rec7, state = _spmd_train(cfg7, mesh, **t7)
        del state
        torch.cuda.empty_cache()
        out["train_qwen2_7b_four_cards"] = rec7
        checks["train_7b_finite"] = rec7["finite"]
        checks["train_7b_replicas_equal"] = rec7["replicas_equal"]
        one = _spmd_mesh([cards[0]] * 4)
        rec1, state = _spmd_train(cfg, one, **tf)
        del state
        torch.cuda.empty_cache()
        out["train_qwen2_1.5b_one_card_x4"] = rec1
        out["four_cards_over_one_card_x4_step_ms"] = (
            out["train_qwen2_1.5b"]["ms_a_step"] / rec1["ms_a_step"])
        out["losses_equal_four_cards_and_one_card_x4"] = [
            a["loss"] == b_["loss"] for a, b_ in zip(
                out["train_qwen2_1.5b"]["steps"], rec1["steps"])]
    else:
        out["train_qwen2_7b_four_cards"] = (
            f"not run: {torch.cuda.device_count()} card(s) visible")
    emit("spmd_full", ok=all(checks.values()), checks=checks,
         config=dict(f, train=tf, serve_run=run), **out,
         phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("spmd_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches, _k3_summary(k3), _k3_summary(k3_1)


# --------------------------------------- the MoE family on the mesh (M18c) --
# Phase moe_mesh_full: granite-moe-1b-a400m whole on the 2 x 2 mesh, its
# parameters placed by the spec trees (experts over the model axis; the
# expert ff over data under sharded2d's serve layout, whole experts over
# (data, model) under sharded_a2a's).  (a) The placed train step at
# TRAIN_RUNS' B 4 x 2,048 (2 microbatches, remat, bf16, the default
# moe_impl; 1 step, 2 until PR 33): ms/step, tokens/s, peak bytes a card,
# finite loss, aux and grad norm, replicas equal.  (b) Served at RUNS' B 4
# x 2,048 beside the unsharded steps on the same prompt, each path's prefill and
# short_steps decode steps timed; then each path again with its drops
# counted (stats) and each MoE layer's input read, the
# drops of every call == a plain count of that routing.  (c) A gated fp32
# cut: 2 layers at FP32_RUNS' B 2 x 512 + 16 at a capacity that drops
# nothing (cf = E / top_k), each path against the unsharded steps fed the
# same tokens (_fp32_gate).
MOE_MESH_FULL = dict(arch="granite-moe-1b-a400m", train_steps=1,
                     short_steps=4, cut_layers=2,
                     impls=("sharded", "sharded2d", "sharded_a2a"))


def phase_moe_mesh_full(dev):
    """Returns K3's launches in the main path and K3's record at the
    coordinate's prefill shape."""
    from repro_torch.configs.one_card import (FP32_RUNS, RUNS, TRAIN_RUNS,
                                              prompt_inputs)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as rt
    from repro_torch.sharding import spmd
    from repro_torch.sharding.rules import NamedSharding, ShardCtx
    t_phase = time.perf_counter()
    f = MOE_MESH_FULL
    cards = _mesh_devices() if torch.cuda.device_count() >= 4 else [dev] * 4
    mesh = _spmd_mesh(cards)
    shape = tuple(mesh.devices.shape)
    checks, out = {}, {"cards": [str(d) for d in cards]}
    cfg = get_config(f["arch"])
    ops.launches = 0                        # just before the main path ...
    # (a) the placed train step
    tr = TRAIN_RUNS[f["arch"]]
    rec, state = _spmd_train(
        cfg, mesh, batch=tr["batch"], seq=tr["seq"],
        microbatches=TRAIN_FAMILIES_FULL["microbatches"],
        steps=f["train_steps"], lr=TRAIN_FAMILIES_FULL["lr"], remat=True)
    del state
    torch.cuda.empty_cache()
    out["train"] = rec
    checks["train_finite"] = rec["finite"]
    checks["train_replicas_equal"] = rec["replicas_equal"]
    checks["train_placed"] = rec["placed_on_coordinates"]
    # (b) served: the unsharded steps, then each path placed
    run = RUNS[f["arch"]]
    model = build_model(cfg, device=cards[0])
    model.init_params(torch.Generator(device=cards[0]).manual_seed(0))
    inp = prompt_inputs(cfg, run, cards[0])
    plain = _prompt_run(model, inp, f["short_steps"],
                        run["prompt"] + f["short_steps"])
    ctxs = {i: ShardCtx(mesh=mesh, pod_axis=None, attn_impl="flash",
                        moe_impl=i) for i in f["impls"]}
    placed = {i: rt.placed_params(model, c, mode="serve")
              for i, c in ctxs.items()}
    model.to("meta")
    torch.cuda.empty_cache()
    mods = _moe_modules(model)
    seen = []                  # (x, router, cf) of every MoE layer called
    orig = moe.moe_placed

    def spy(bp, xs, x_spec, cfg_, ctx, capacity_factor=None, stats=None):
        seen.append((spmd.gather(spmd.Placed(xs, NamedSharding(ctx.mesh,
                                                               x_spec))),
                     spmd.gather(bp["router"]),
                     capacity_factor if capacity_factor is not None
                     else cfg_.moe.capacity_factor))
        return orig(bp, xs, x_spec, cfg_, ctx, capacity_factor, stats)

    serve, drops = {}, {}
    for impl, ctx in ctxs.items():
        rec, cache = _placed_serve(model, placed[impl], ctx, inp,
                                   f["short_steps"], mesh, plain)
        rec.pop("stream")
        checks.update({f"serve_{impl}_{k}": v
                       for k, v in rec.pop("checks").items()})
        checks[f"serve_{impl}_k3_launches_24_x_4_a_prefill"] = (
            rec["k3_launches_prefill"] == cfg.num_layers * mesh.size)
        serve[impl] = rec
        del cache
        # again with the drops counted and each layer's input read
        stats = {}
        for m in mods:
            m.stats = stats
        seen.clear()
        moe.moe_placed = spy
        try:
            _, cache = _placed_serve(model, placed[impl], ctx, inp,
                                     f["short_steps"], mesh)
        finally:
            moe.moe_placed = orig
            for m in mods:
                m.stats = None
        want = sum(_plain_dropped([x], [r], cfg, impl, shape, cf)
                   for x, r, cf in seen)
        drops[impl] = dict(dropped=stats.get("dropped", 0), plain_count=want,
                           layer_calls=len(seen),
                           calls=1 + f["short_steps"])
        checks[f"drops_{impl}_equal_plain_count"] = \
            stats.get("dropped", 0) == want
        checks[f"drops_{impl}_every_layer_seen"] = (
            len(seen) == cfg.num_layers * (1 + f["short_steps"]))
        seen.clear()
        del cache, placed[impl]
        torch.cuda.empty_cache()
    out["serve"] = serve
    out["drops"] = drops
    del plain, model
    torch.cuda.empty_cache()
    # (c) the gated fp32 cut, each path
    cut = _cut(cfg, f["cut_layers"])
    cut = dataclasses.replace(cut, moe=dataclasses.replace(
        cut.moe, capacity_factor=cut.moe.num_experts / cut.moe.top_k))
    run32 = FP32_RUNS[f["arch"]]
    inp32 = prompt_inputs(cut, run32, cards[0])
    gate = _fp32_gate(cut, mesh, inp32, run32["steps"], cards[0],
                      each=[dict(moe_impl=i) for i in f["impls"]])
    launches = ops.launches                 # ... and read just after
    for kw, r in gate.items():
        checks[f"fp32_{kw}_within_bound"] = r["within_bound"]
        checks[f"fp32_{kw}_tokens_agree"] = r["greedy_tokens_all_agree"]
    out["fp32_cut"] = gate
    # K3 at the coordinate's prefill shape, against its plain version
    coord = cfg.scaled(num_heads=cfg.num_heads // mesh.shape["model"],
                       num_kv_heads=cfg.num_kv_heads // mesh.shape["model"])
    k3 = _k3_at_prefill(coord, run["batch"] // mesh.shape["data"],
                        run["prompt"], torch.bfloat16, cards[0])
    out["k3_at_coordinate"] = {k: v for k, v in k3.items() if k != "sdpa"}
    emit("moe_mesh_full", ok=all(checks.values()), checks=checks, config=f,
         kernel_launches=launches, **out,
         phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("moe_mesh_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches, _k3_summary(k3)


# ------------------------- MLA with the MTP head, Mamba-2, jamba on the mesh --
# Phase family_mesh_full: the 2 x 2 mesh (the card listed four times where
# fewer than four are visible), published widths, bf16 unless said, the
# reference's serve layouts (launch/dryrun.py::make_ctx: SP over "model",
# or over ("data", "model") at batch 1; sharded2d for deepseek's and
# jamba's experts).  Each placed run beside the unsharded one on the same
# inputs, the card holding the two one after the other (the model's own
# parameters go to meta once placed).
# (a) mamba2-1.3b whole (48 layers): trained placed at TRAIN_RUNS' B 4 x
# 2,048 (remat, 2 microbatches, 1 step, 2 until PR 33; also unsharded first);
# served at RUNS' B 4 x 2,048 + 4 decode steps with SP "model" (it leaves a
# Mamba cache whole); a gated fp32 cut of its first 2 layers (FP32_RUNS' B
# 2 x 512 + 4).
# (b) deepseek-v3: one_card_config's serve cut (3 dense MLA layers, 1 MLA +
# MoE layer of 256 experts and the shared expert) at B 1 x 1,024 + 4 with
# SP ("data", "model") and sharded2d; one_card_train_config's cut (1 dense
# MLA layer and the MTP head) trained placed and fused at TRAIN_RUNS' B 2 x
# 2,048 (remat, one microbatch: two rows do not split into two microbatches
# over the data axis), 1 step (2 until PR 33; its result the two-phase step
# of encdec_mesh_full (c) is held to); a gated fp32 cut of one dense MLA layer
# (B 1 x 256 + 4, SP ("data", "model")).
# (c) jamba: blocks 3-4 of its period (mamba/moe, attn/mlp:
# one_card_config(fp32=True)'s cut, here in bf16) at B 1 x 2,048 + 4 with
# SP ("data", "model") and sharded2d, K3 in the attention block of every
# coordinate's prefill (1 layer x 4 coordinates); a gated fp32 cut of
# (mamba/mlp, attn/mlp) at B 1 x 256 + 4.  K3 held to its plain version
# and timed beside SDPA at jamba's coordinate shape.
# Gates: _rounding_bound with every greedy token agreeing (fp32 cuts);
# the bf16 runs are reported (ROADMAP F14).
FAMILY_MESH_FULL = dict(train_steps=1, serve_steps=4, cut_layers=2,
                        cut_run=dict(prompt=256, steps=4),
                        mamba_cut_run=dict(batch=2, prompt=512, steps=4))


def _family_serve(cfg, mesh, ctx, run):
    """``cfg`` in bf16 on the mesh's first card: the unsharded steps over
    ``run``'s prompt and ``FAMILY_MESH_FULL``'s decode steps, then the
    placed steps (``_placed_serve``) beside them.  Returns the record."""
    from repro_torch.configs.one_card import attention_layers, prompt_inputs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as rt
    dev0 = mesh.devices.flat[0]
    run = dict(run, steps=FAMILY_MESH_FULL["serve_steps"])
    model = build_model(cfg, device=dev0)
    model.init_params(torch.Generator(device=dev0).manual_seed(0))
    inp = prompt_inputs(cfg, run, dev0)
    n = run["steps"]
    plain = _prompt_run(model, inp, n, inp["start"] + n)
    sp = rt.placed_params(model, ctx, mode="serve")
    model.to("meta")
    torch.cuda.empty_cache()
    rec, cache = _placed_serve(model, sp, ctx, inp, n, mesh, plain)
    rec.pop("stream")
    by_device = {}
    for p in sp.values():
        for b in p.blocks:
            by_device[str(b.device)] = (by_device.get(str(b.device), 0)
                                        + b.numel() * b.element_size())
    rec.update(params=sum(p.numel() for p in model.parameters()),
               placed_bytes=sum(by_device.values()),
               placed_bytes_by_device=by_device,
               k3_launches_prefill_want=attention_layers(cfg) * mesh.size,
               cache_specs=sorted({f"{k}: {tuple(v.spec)}" for k, v in (
                   cache["groups"][0]["blocks"][0] if "groups" in cache
                   else dict(cache["self"], cross_k=cache["cross_k"]))
                   .items()}))
    del cache, sp, plain, model
    torch.cuda.empty_cache()
    return rec


def phase_family_mesh_full(dev):
    """Returns K3's launches in the main path, K3's record at jamba's
    coordinate prefill shape and the deepseek train cut's fused placed
    step 1 (its loss, its blocks' SHA-1s, the run's peak bytes a card),
    which ``phase_encdec_mesh_full`` holds the two-phase step to."""
    from repro_torch.configs.base import Block, LayerGroup
    from repro_torch.configs.one_card import (RUNS, TRAIN_RUNS,
                                              one_card_config,
                                              one_card_train_config,
                                              prompt_inputs)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.sharding.rules import ShardCtx
    t_phase = time.perf_counter()
    f = FAMILY_MESH_FULL
    cards = _mesh_devices() if torch.cuda.device_count() >= 4 else [dev] * 4
    mesh = _spmd_mesh(cards)
    checks, out = {}, {"cards": [str(d) for d in cards]}
    base = ShardCtx(mesh=mesh, pod_axis=None, attn_impl="flash")
    fused = {}

    def train(name, cfg, **kw):
        rec, state = _spmd_train(cfg, mesh, steps=f["train_steps"],
                                 lr=TRAIN_FAMILIES_FULL["lr"], remat=True,
                                 unsharded=True, **kw)
        del state
        torch.cuda.empty_cache()
        if "digests_step1" in rec:
            fused.update(digests=rec.pop("digests_step1"),
                         loss=rec["steps"][0]["loss"],
                         peak_bytes=max(rec["peak_bytes_by_device"].values()))
        rec["step1_loss_diff_vs_unsharded"] = abs(
            rec["steps"][0]["loss"] - rec["unsharded_step1_loss"])
        rec["peak_gb_by_device"] = {k: v / 1e9 for k, v in
                                    rec.pop("peak_bytes_by_device").items()}
        for k in ("finite", "replicas_equal", "placed_on_coordinates"):
            checks[f"train_{name}_{k}"] = rec[k]
        return rec

    def serve(name, cfg, arch, **kw):
        rec = _family_serve(cfg, mesh, dataclasses.replace(base, **kw),
                            RUNS[arch])
        for k, v in rec.pop("checks").items():
            checks[f"serve_{name}_{k}"] = v
        checks[f"serve_{name}_k3_launches_a_prefill"] = (
            rec["k3_launches_prefill"] == rec["k3_launches_prefill_want"])
        return rec

    def gate(name, cfg, run, **kw):
        inp = prompt_inputs(cfg, run, cards[0])
        g = _fp32_gate(cfg, mesh, inp, run["steps"], cards[0], **kw)
        for r in g.values():
            checks[f"fp32_{name}_within_bound"] = r["within_bound"]
            checks[f"fp32_{name}_tokens_agree"] = \
                r["greedy_tokens_all_agree"]
        return dict(run, layers=cfg.num_layers,
                    params=_param_count(cfg), **g)

    ops.launches = 0                        # just before the main path ...
    # (a) mamba2-1.3b
    mcfg = get_config("mamba2-1.3b")
    tr = TRAIN_RUNS[mcfg.name]
    out["mamba2"] = dict(
        train=train("mamba2", mcfg, batch=tr["batch"], seq=tr["seq"],
                    microbatches=TRAIN_FAMILIES_FULL["microbatches"]),
        serve=serve("mamba2", mcfg, mcfg.name, seq_shard_kv="model"),
        fp32_cut=gate("mamba2", _cut(mcfg, f["cut_layers"]),
                      f["mamba_cut_run"], seq_shard_kv="model"))
    # (b) deepseek-v3
    dcfg = one_card_config("deepseek-v3-671b")
    tcfg = one_card_train_config("deepseek-v3-671b")
    tr = TRAIN_RUNS["deepseek-v3-671b"]
    dense = LayerGroup(1, (Block("mla", "mlp"),))
    d32 = dataclasses.replace(tcfg, mtp_depth=0, groups=(dense,))
    out["deepseek"] = dict(
        serve=serve("deepseek", dcfg, dcfg.name,
                    seq_shard_kv=("data", "model"), moe_impl="sharded2d"),
        train=train("deepseek", tcfg, batch=tr["batch"], seq=tr["seq"],
                    microbatches=1, digests=True),
        fp32_cut=gate("deepseek", d32, dict(f["cut_run"], batch=1),
                      seq_shard_kv=("data", "model")))
    # (c) jamba
    jcfg = one_card_config("jamba-1.5-large-398b", fp32=True)
    full = get_config("jamba-1.5-large-398b")
    j32 = dataclasses.replace(full, num_layers=2, groups=(LayerGroup(1, (
        Block("mamba", "mlp"), Block("attn", "mlp"))),))
    out["jamba"] = dict(
        serve=serve("jamba", jcfg, jcfg.name,
                    seq_shard_kv=("data", "model"), moe_impl="sharded2d"),
        fp32_cut=gate("jamba", j32, dict(f["cut_run"], batch=1),
                      seq_shard_kv=("data", "model")))
    launches = ops.launches                 # ... and read just after
    checks["jamba_k3_4_launches_a_placed_prefill"] = (
        out["jamba"]["serve"]["k3_launches_prefill"] == 4)
    # K3 at jamba's coordinate prefill shape, against its plain version
    coord = full.scaled(num_heads=full.num_heads // mesh.shape["model"],
                        num_kv_heads=full.num_kv_heads // mesh.shape["model"])
    k3 = _k3_at_prefill(coord, 1, 2048, torch.bfloat16, cards[0])
    out["k3_at_jamba_coordinate"] = {k: v for k, v in k3.items()
                                     if k != "sdpa"}
    emit("family_mesh_full", ok=all(checks.values()), checks=checks,
         config=f, kernel_launches=launches, **out,
         phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("family_mesh_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches, _k3_summary(k3), fused


def _digests(placed) -> dict:
    """The SHA-1 of every block's bytes of placed parameters, by name: a
    step's result bit for bit, without a second copy on the card (the
    blocks copied to the host one at a time, hashed on 8 threads)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def one(b):
        return hashlib.sha1(b.detach().reshape(-1).view(torch.uint8).cpu()
                            .numpy()).hexdigest()
    jobs = [(n, b) for n, p in placed.items() for b in p.blocks]
    with ThreadPoolExecutor(8) as ex:
        hs = list(ex.map(lambda nb: one(nb[1]), jobs))
    out: dict = {}
    for (n, _), h in zip(jobs, hs):
        out.setdefault(n, []).append(h)
    return out


# Phase encdec_mesh_full: the encoder-decoder and the vision frontend on the
# 2 x 2 mesh (four cards where four are visible, else the card listed four
# times), and the two-phase step on placed parameters (M18d).  (a)
# whisper-small whole, bf16: placed training at TRAIN_RUNS' B 8 x (1,500
# frames + 448 tokens), remat, 2 microbatches; served at ENCDEC_RUNS' B 16 x 1,500 frames + whisper's 4 start
# tokens with SP over "model" (the cross K/V's frames split), 4 decode
# steps beside the unsharded steps; an fp32 gate (B 2 x 1,500 + 4 steps)
# with SP and without.  (b) internvl2-26b, bf16: its first 24 of 48 layers
# served (the data axis replicates every leaf it does not split in serve
# mode: the whole model would need 2 x 39.7 GB a card) at B 2 x (1,024
# patches + 1,024 tokens) + 4 with SP over "model"; placed training on
# TRAIN_RUNS' 4-layer cut at B 2 x 2,048 (one microbatch: a row a data
# coordinate); an fp32 gate on a 2-layer cut (B 1 x (256 + 256) + 4); K3
# at its coordinate's prefill shape.  (c) deepseek-v3's train cut (1 dense
# MLA layer + the MTP head, B 2 x 2,048): one placed two-phase step from
# family_mesh_full's seeded parameters and batch, its loss == the fused
# placed step's, every parameter block's SHA-1 == the fused step's, its
# peak a card below the fused step's by at least the pool tier less twice
# the largest block's share of it.
ENCDEC_MESH_FULL = dict(train_steps=2, serve_steps=4, internvl2_layers=24,
                        internvl2_cut_run=dict(batch=1, patches=256,
                                               prompt=256, steps=4),
                        whisper_fp32_run=dict(batch=2, frames=1500,
                                              prompt=4, steps=4))


def phase_encdec_mesh_full(dev, fused):
    """``fused``: ``phase_family_mesh_full``'s fused placed step on
    deepseek's train cut.  Returns K3's launches in the main path and K3's
    record at internvl2's coordinate prefill shape."""
    from repro_torch.configs.one_card import (ENCDEC_RUNS, TRAIN_RUNS,
                                              one_card_train_config,
                                              prompt_inputs)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.rules import (ShardCtx, default_rules,
                                            sharding_tree)
    t_phase = time.perf_counter()
    f = ENCDEC_MESH_FULL
    cards = _mesh_devices() if torch.cuda.device_count() >= 4 else [dev] * 4
    mesh = _spmd_mesh(cards)
    dev0 = cards[0]
    checks, out = {}, {"cards": [str(d) for d in cards]}
    base = ShardCtx(mesh=mesh, pod_axis=None, attn_impl="flash")

    def train(name, cfg, run, microbatches):
        batches = _family_batches(cfg, run["batch"], run["seq"],
                                  f["train_steps"], dev0)
        rec, state = _spmd_train(cfg, mesh, batch=run["batch"],
                                 seq=run["seq"], microbatches=microbatches,
                                 steps=f["train_steps"],
                                 lr=TRAIN_FAMILIES_FULL["lr"], remat=True,
                                 batches=batches)
        del state, batches
        torch.cuda.empty_cache()
        rec["peak_gb_by_device"] = {k: v / 1e9 for k, v in
                                    rec.pop("peak_bytes_by_device").items()}
        for k in ("finite", "replicas_equal", "placed_on_coordinates"):
            checks[f"train_{name}_{k}"] = rec[k]
        return rec

    def serve(name, cfg, run, **kw):
        rec = _family_serve(cfg, mesh, dataclasses.replace(base, **kw), run)
        for k, v in rec.pop("checks").items():
            checks[f"serve_{name}_{k}"] = v
        checks[f"serve_{name}_k3_launches_a_prefill"] = (
            rec["k3_launches_prefill"] == rec["k3_launches_prefill_want"])
        return rec

    def gate(name, cfg, run, **kw):
        inp = prompt_inputs(cfg, run, dev0)
        g = _fp32_gate(cfg, mesh, inp, run["steps"], dev0, **kw)
        for opt, r in g.items():
            checks[f"fp32_{name}_{opt}_within_bound"] = r["within_bound"]
            checks[f"fp32_{name}_{opt}_tokens_agree"] = \
                r["greedy_tokens_all_agree"]
        return dict(run, layers=cfg.num_layers, params=_param_count(cfg),
                    **g)

    ops.launches = 0                        # just before the main path ...
    # (a) whisper-small
    wcfg = get_config("whisper-small")
    out["whisper"] = dict(
        train=train("whisper", wcfg, TRAIN_RUNS["whisper-small"],
                    TRAIN_FAMILIES_FULL["microbatches"]),
        serve=serve("whisper", wcfg, ENCDEC_RUNS["whisper-small"],
                    seq_shard_kv="model"),
        fp32=gate("whisper", wcfg, f["whisper_fp32_run"],
                  each=[dict(seq_shard_kv="model"), {}]))
    spec = dict(s.split(": ", 1) for s in
                out["whisper"]["serve"]["cache_specs"])
    checks["serve_whisper_cross_kv_frames_over_model"] = (
        spec["cross_k"] == str((None, "data", "model", None, None)))
    # (b) internvl2-26b
    full = get_config("internvl2-26b")
    icfg = _cut(full, f["internvl2_layers"])
    out["internvl2"] = dict(
        serve=serve("internvl2", icfg, ENCDEC_RUNS["internvl2-26b"],
                    seq_shard_kv="model"),
        train=train("internvl2", one_card_train_config("internvl2-26b"),
                    TRAIN_RUNS["internvl2-26b"], 1),
        fp32_cut=gate("internvl2", _cut(full, 2), f["internvl2_cut_run"],
                      seq_shard_kv="model"))
    launches = ops.launches                 # ... and read just after
    # the placed bytes a card: each coordinate's blocks of every leaf as
    # the serve rules cut them, nothing more
    meta = build_model(icfg, device="meta")
    named = spmd.named_shardings(meta, sharding_tree(
        meta.specs(), default_rules(base, mode="serve"), mesh))
    want = {}
    for n, p in meta.named_parameters():
        nb = math.prod(spmd.block_shape(p.shape, named[n].spec, mesh)) \
            * p.element_size()
        for c in mesh.coords():
            d = str(spmd.coordinate_device(mesh, c))
            want[d] = want.get(d, 0) + nb
    sv = out["internvl2"]["serve"]
    sv["placed_gb_by_device"] = {k: v / 1e9 for k, v in
                                 sv["placed_bytes_by_device"].items()}
    checks["serve_internvl2_placed_bytes_by_device"] = (
        sv.pop("placed_bytes_by_device") == want)
    # K3 at internvl2's coordinate prefill shape, against its plain version
    coord = full.scaled(num_heads=full.num_heads // mesh.shape["model"],
                        num_kv_heads=full.num_kv_heads // mesh.shape["model"])
    k3 = _k3_at_prefill(coord, 1, 2048, torch.bfloat16, dev0)
    out["k3_at_internvl2_coordinate"] = {k: v for k, v in k3.items()
                                         if k != "sdpa"}
    # (c) the two-phase step on placed parameters (M18d)
    out["two_phase_deepseek"] = _placed_two_phase(mesh, checks, fused)
    emit("encdec_mesh_full", ok=all(checks.values()), checks=checks,
         config=f, kernel_launches=launches, **out,
         phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("encdec_mesh_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches, _k3_summary(k3)


def _placed_two_phase(mesh, checks, fused):
    """encdec_mesh_full (c): deepseek-v3's train cut from the seeded
    parameters and the first batch family_mesh_full's fused placed step
    took (``fused``: its loss, digests and peak), one placed two-phase
    step, the pool tier built a leaf at a time in pinned host memory
    (``adamw.init_placed_pool``).  Returns the record; the checks go into
    ``checks``."""
    from repro_torch.configs.one_card import (TRAIN_RUNS,
                                              one_card_train_config)
    from repro_torch.core import znuma
    from repro_torch.data.pipeline import DataConfig, ShardedBatches
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    cfg = one_card_train_config("deepseek-v3-671b")
    tr = TRAIN_RUNS["deepseek-v3-671b"]
    dev0 = mesh.devices.flat[0]
    model = build_model(cfg, device=dev0)
    model.init_params(torch.Generator(device=dev0).manual_seed(0))
    ctx = ShardCtx(mesh=mesh, pod_axis=None, remat=True)
    t0 = time.perf_counter()
    placed = rt.placed_params(model, ctx)
    model.to("meta")
    torch.cuda.empty_cache()
    ocfg = adamw.AdamWConfig(lr=TRAIN_FAMILIES_FULL["lr"], warmup_steps=20,
                             total_steps=FAMILY_MESH_FULL["train_steps"])
    pool = adamw.init_placed_pool(placed, ocfg, dev0)
    _sync_all(mesh)
    place_s = time.perf_counter() - t0
    acct = znuma.TierAccount()
    for g in ("master", "m", "v"):
        acct.add(pool[g], "pool")
    pool_bytes = acct.pool_bytes
    largest = max(sum(pool[g][n].blocks[i].numel()
                      * pool[g][n].blocks[i].element_size()
                      for g in ("master", "m", "v"))
                  for n in placed for i in range(len(pool["m"][n].ranks)))
    data = ShardedBatches(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=tr["seq"],
                                     global_batch=tr["batch"]))
    batch = {"tokens": torch.from_numpy(data.batch_at(0)["tokens"]).to(dev0)}
    grad_step, opt_step = rt.make_two_phase_steps(model, ocfg, ctx)
    _reset_peaks(mesh)
    _sync_all(mesh)
    t0 = time.perf_counter()
    grads, gm = grad_step(placed, batch)
    loss = float(gm["loss"])
    _sync_all(mesh)
    t1 = time.perf_counter()
    placed, pool, om = opt_step(placed, pool, grads)
    _sync_all(mesh)
    t2 = time.perf_counter()
    del grads
    peak = max(_peaks(mesh).values())
    digests = _digests(placed)
    rec = dict(
        batch=tr["batch"], seq=tr["seq"], params=sum(
            p.numel() for p in model.parameters()),
        place_and_pool_s=place_s, step_ms=(t2 - t0) * 1e3,
        grad_ms=(t1 - t0) * 1e3, opt_ms=(t2 - t1) * 1e3,
        opt_gb_in=om["opt_bytes_in"] / 1e9,
        opt_gb_out=om["opt_bytes_out"] / 1e9,
        opt_gb_per_s_each_way=om["opt_bytes_in"] / 1e9 / (t2 - t1),
        loss=loss, fused_loss=fused["loss"], grad_norm=float(om["grad_norm"]),
        pool_gb=pool_bytes / 1e9, largest_block_pool_gb=largest / 1e9,
        peak_gb=peak / 1e9, fused_peak_gb=fused["peak_bytes"] / 1e9,
        peak_saving_want_gb=(pool_bytes - 2 * largest) / 1e9,
        blocks_compared=sum(len(v) for v in digests.values()))
    checks["two_phase_step1_loss_equal"] = loss == fused["loss"]
    checks["two_phase_blocks_bitwise_equal"] = digests == fused["digests"]
    checks["two_phase_bytes_each_way_the_pool"] = (
        om["opt_bytes_in"] == om["opt_bytes_out"] == pool_bytes)
    checks["two_phase_peak_below_fused_by_the_pool"] = (
        peak <= fused["peak_bytes"] - (pool_bytes - 2 * largest))
    checks["two_phase_replicas_equal"] = _replicas_equal(placed)
    del placed, pool, digests
    torch.cuda.empty_cache()
    return rec


def _param_count(cfg) -> int:
    from repro_torch.models.model_zoo import build_model
    return sum(p.numel() for p in build_model(cfg, device="meta")
               .parameters())


# ------------------------------------------------- provisioning loop (K1) --
def _prov_config(n_servers):
    from repro_torch.core.cluster_sim import ClusterConfig
    return ClusterConfig(n_servers=n_servers, pool_sockets=16,
                         gb_per_core=4.75)


_FULL_TRACE = {}


def _full_trace():
    """The full-width trace (``PROV_FULL``), sampled once; returns (cfg,
    vms, sampling seconds)."""
    if not _FULL_TRACE:
        from repro_torch.core import cluster_sim, traces
        cfg = _prov_config(PROV_FULL["n_servers"])
        horizon = PROV_FULL["days"] * 86400
        t0 = time.perf_counter()
        n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
        vms = traces.Population(seed=0).sample_vms(
            n, horizon, seed=PROV_FULL["seed"], start_id=10 ** 6)
        _FULL_TRACE.update(cfg=cfg, vms=vms,
                           seconds=time.perf_counter() - t0)
    return _FULL_TRACE["cfg"], _FULL_TRACE["vms"], _FULL_TRACE["seconds"]


def _k1_inputs(ev, n_slots, n_servers, spg, cores, sgb, pgb, state_dtype,
               dev):
    """K1's arguments on ``dev``: events, group_of and the all-free state
    for lanes (sgb, pgb) in ``state_dtype`` ("int16"/"int32")."""
    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep.cases import EVENT_KEYS
    np_dt = sweep_core.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    fc, um, up, slots, _ = sweep_core.init_state(
        len(sgb), n_servers, cores, n_servers, n_groups, n_slots, np_dt)
    events = tuple(torch.from_numpy(np.ascontiguousarray(ev[k], np.int32))
                   .to(dev) for k in EVENT_KEYS)
    group_of = torch.from_numpy(
        (np.arange(n_servers) // spg).astype(np.int32)).to(dev)
    state = tuple(torch.from_numpy(a).to(dev) for a in
                  (fc, um, up, slots, np.asarray(sgb).astype(np_dt),
                   np.asarray(pgb).astype(np_dt)))
    return events, group_of, state


def _k1_run(fn, events, group_of, state, **kw):
    """fn (K1's wrapper or its plain version) on a copy of ``state``;
    returns the final state with its rejects."""
    st = [t.clone() for t in state]
    rej = torch.zeros(st[0].shape[0], dtype=torch.int32, device=st[0].device)
    fn(*events, group_of, *st, rej, **kw)
    torch.cuda.synchronize()
    return st[:4] + [rej]


def _k1_variants(n_servers):
    """The K1 variants that take ``n_servers``."""
    from repro_torch.kernels.event_sweep import kernel as K
    if n_servers > K.MAX_REGISTER_SERVERS:
        return ["shared"]
    return ["registers", "shared"]


# ------------------------------------------------ Fig 21's inputs (K1, M8) --
_POND = {}


def _pond_plane(li, um, hist):
    """A fresh control plane with Fig 21's settings (its decisions extend
    its history, so each trace gets its own)."""
    from repro_torch.core.control_plane import (ControlPlane,
                                                ControlPlaneConfig)
    from repro_torch.core.pool_manager import PoolManager
    return ControlPlane(ControlPlaneConfig(li_threshold=0.05,
                                           um_quantile=0.05), li, um,
                        PoolManager(pool_gb=4096, buffer_gb=64),
                        history=dict(hist))


def _pond_inputs():
    """``POND_BATCH_FULL``'s traces (seed 2's is ``_full_trace``'s), Pond's
    two models and the customers' history, made once, with the host
    seconds of sampling and of fitting."""
    if not _POND:
        from repro_torch.core import cluster_sim, traces
        from repro_torch.core.predictors.models import (
            LatencySensitivityModel, UntouchedMemoryModel)
        f = POND_BATCH_FULL
        cfg, vms2, sample_s = _full_trace()
        horizon = PROV_FULL["days"] * 86400
        n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
        pop = traces.Population(seed=0)
        t0 = time.perf_counter()
        vms_list = [vms2 if seed == PROV_FULL["seed"] else
                    pop.sample_vms(n, horizon, seed=seed, start_id=10 ** 6)
                    for seed in f["seeds"]]
        sample_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        train = pop.sample_vms(f["train_vms"], f["train_days"] * 86400,
                               seed=f["train_seed"])
        li = LatencySensitivityModel(pdm=0.05).fit(
            traces.pmu_matrix(train), traces.slowdowns(train, 182))
        hist = traces.build_history(train)
        um = UntouchedMemoryModel(0.05).fit(
            traces.metadata_features(train, hist),
            np.array([v.untouched for v in train]))
        _POND.update(cfg=cfg, vms_list=vms_list, li=li, um=um, hist=hist,
                     train=train, sampling_s=sample_s,
                     fitting_s=time.perf_counter() - t0)
    return _POND


def _pond_decisions():
    """The pond decisions of each ``POND_BATCH_FULL`` trace, from fresh
    planes (the same decisions the phase's own planes make), made once."""
    inp = _pond_inputs()
    if "decisions" not in inp:
        from repro_torch.core import cluster_sim
        inp["decisions"] = [cluster_sim.policy_decisions(
            vms, "pond", _pond_plane(inp["li"], inp["um"], inp["hist"]),
            as_arrays=True)[0] for vms in inp["vms_list"]]
    return inp["decisions"]


def _k1_trace_state(counts, n_cand, n_slots, n_servers, spg, cores, sgb,
                    pgb, state_dtype, dev):
    """group_of and the all-free state of T x n_cand trace-major lanes
    (sgb, pgb: (T, n_cand)) on ``dev``."""
    from repro_torch.core import sweep_core
    np_dt = sweep_core.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    fc, um, up, slots, _ = sweep_core.init_state(
        len(counts) * n_cand, n_servers, cores, n_servers, n_groups, n_slots,
        np_dt)
    group_of = torch.from_numpy(
        (np.arange(n_servers) // spg).astype(np.int32)).to(dev)
    state = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                  (fc, um, up, slots, np.asarray(sgb).reshape(-1)
                   .astype(np_dt), np.asarray(pgb).reshape(-1)
                   .astype(np_dt)))
    return group_of, state


def _lanes_of(state, t, n):
    """Trace t's lanes (n a trace) of a state (fc, um, up, slots, then
    per-lane vectors: rejects, or sgb and pgb), each contiguous."""
    lanes = slice(t * n, (t + 1) * n)
    return [(a[:, lanes] if i == 3 else a[lanes]).contiguous()
            for i, a in enumerate(state)]


def _k1_trace_axis(dev, int32_rate):
    """K1's trace axis on the card: ``==`` its plain version on T traces of
    unequal lengths and peaks (T 1, 2, 3, 7; a per-trace lane count the
    lanes a block do not divide; 600 servers on the shared variant), each
    variant that takes the shape and the wrapper's choice, both state
    types; at full width (3 pond traces x 28 lanes, 256 servers) ``==``
    three single-trace launches, and ``==`` the plain version on the
    traces' first 2,048 events; times: the batched launch against the
    three single launches, in turns."""
    from repro_torch.core import sweep_core
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch)
    from repro_torch.kernels.event_sweep import cases, ops
    from repro_torch.kernels.event_sweep.ref import event_sweep_ref
    rng = np.random.default_rng(16)
    checked = []

    def check(name, evs, counts, n_cand, n_slots, s, spg, cores, sgb, pgb,
              dt):
        starts = ops.trace_starts(counts)
        group_of, state = _k1_trace_state(counts, n_cand, n_slots, s, spg,
                                          cores, sgb, pgb, dt, dev)
        want = _k1_run(event_sweep_ref, evs, group_of, state,
                       trace_starts=starts, trace_counts=counts)
        for variant in _k1_variants(s) + [None]:
            got = _k1_run(ops.event_sweep, evs, group_of, state,
                          variant=variant, trace_events=counts)
            plan = ops.last_plan
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"event_sweep trace axis {name} {dt} "
                                 f"{plan.variant}: the kernel's final state "
                                 "differs from its plain version's")
            checked.append(dict(case=name, state_dtype=dt,
                                variant=plan.variant, chosen=variant is None,
                                lanes_per_block=plan.lanes_per_block,
                                traces=len(counts), lanes_a_trace=n_cand,
                                events=counts, servers=s, n_slots=n_slots,
                                rejects=int(want[4].sum())))
        return want

    # (T, lanes a trace, servers, servers a group): 300 lanes a trace is
    # not a multiple of the 7 lanes a block that 900 lanes take
    for n_tr, n_cand, s, spg in ((1, 16, 33, 8), (2, 9, 7, 4),
                                 (3, 300, 33, 8), (7, 5, 100, 3),
                                 (3, 4, 600, 8)):
        streams, slot_counts = zip(*(cases.random_stream(
            rng, 500 + 130 * i, mig_frac=0.2) for i in range(n_tr)))
        evs, counts = ops.pack_traces(
            [tuple(ev[k] for k in cases.EVENT_KEYS) for ev in streams], dev)
        caps = [cases.lane_capacities(rng, n_cand, s, 64)
                for _ in range(n_tr)]
        sgb, pgb = (np.stack([c[j] for c in caps]) for j in range(2))
        for dt in ("int16", "int32"):
            check(f"T{n_tr}_lanes{n_cand}_S{s}", evs, counts, n_cand,
                  max(slot_counts), s, spg, 64, sgb, pgb, dt)

    # full width: the pond batch's three traces, 28 lanes each (the pool
    # search's 7 server sizes x 4 pool points)
    inp = _pond_inputs()
    cfg = inp["cfg"]
    batch = CompiledReplayBatch([CompiledReplay(v, d, cfg, device=dev)
                                 for v, d in zip(inp["vms_list"],
                                                 _pond_decisions())])
    evs, group_of, n_slots, counts = batch._device_events()
    starts = ops.trace_starts(counts)
    n_tr, n_cand = batch.k, 28
    sgb = np.tile(np.repeat(np.linspace(220.0, 384.0, 7), 4), (n_tr, 1))
    pgb = np.tile(np.tile(np.linspace(0.0, 1200.0, 4), 7), (n_tr, 1))
    s, spg = cfg.n_servers, cfg.servers_per_group
    singles = [tuple(e[e0:e0 + n] for e in evs)
               for e0, n in zip(starts, counts)]
    arrivals = [int((ev[0] == sweep_core.ARRIVE).sum()) for ev in singles]
    full = {}
    for dt in ("int16", "int32"):
        _, state = _k1_trace_state(counts, n_cand, n_slots, s, spg,
                                   cfg.cores_per_server, sgb, pgb, dt, dev)
        got = _k1_run(ops.event_sweep, evs, group_of, state,
                      trace_events=counts)
        plan = ops.last_plan
        one = [_k1_run(ops.event_sweep, singles[t], group_of,
                       _lanes_of(state, t, n_cand)) for t in range(n_tr)]
        if not all(torch.equal(a, b) for t in range(n_tr)
                   for a, b in zip(_lanes_of(got, t, n_cand), one[t])):
            raise SystemExit(f"event_sweep trace axis full width {dt}: the "
                             "batched launch differs from three "
                             "single-trace launches")
        # the plain version on each trace's first 2,048 events
        cut = [tuple(e[:2048] for e in ev) for ev in singles]
        cut_evs, cut_counts = ops.pack_traces(cut, dev)
        check("full_width_first_2048", cut_evs, cut_counts, n_cand, n_slots,
              s, spg, cfg.cores_per_server, sgb, pgb, dt)

        # times, in turns: three single launches, the batched launch, the
        # batched launch, three single launches (5 sweeps each, on fresh
        # state)
        def run_batched(st):
            ops.event_sweep(*evs, group_of, *st, trace_events=counts)

        def run_singles(st):
            for t in range(n_tr):
                ops.event_sweep(*singles[t], group_of, *st[6 * t:6 * t + 6])

        def batched_states():
            return [t.clone() for t in state]

        def single_states():             # each trace's lanes apart
            return [a for t in range(n_tr) for a in _lanes_of(state, t,
                                                               n_cand)]

        def timed(fn, make, reps=5):
            states = [make() for _ in range(reps + 1)]
            fn(states[0])
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for st in states[1:]:
                fn(st)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        runs = [timed(*f) for f in ((run_singles, single_states),
                                    (run_batched, batched_states),
                                    (run_batched, batched_states),
                                    (run_singles, single_states))]
        item = 2 if dt == "int16" else 4
        lanes = n_tr * n_cand
        ops_ = K1_OPS_PER_ARRIVE_SERVER * sum(arrivals) * n_cand * s
        st_bytes = (2 * lanes * s + lanes * cfg.n_groups
                    + n_slots * lanes) * item
        nbytes = (24 * sum(counts) + 4 * s + 2 * st_bytes + 2 * lanes * item
                  + 8 * lanes)
        t_ops, t_bytes = (ops_ / int32_rate * 1e3,
                          nbytes / HBM_BYTES_PER_S * 1e3)
        full[dt] = dict(
            batched_ms=min(runs[1:3]), three_singles_ms=min(runs[0], runs[3]),
            ms_runs=dict(singles=[runs[0], runs[3]], batched=runs[1:3]),
            variant=plan.variant, lanes_per_block=plan.lanes_per_block,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            int32_ops=ops_, bytes=nbytes)
    return dict(cases_checked=len(checked), cases=checked,
                full_width=dict(traces=n_tr, lanes_a_trace=n_cand,
                                servers=s, events=counts, arrivals=arrivals,
                                n_slots=n_slots, equal_to_single_launches=True,
                                **full))


def _k1_past_the_slot_limit(dev):
    """A trace whose peak concurrency is past K1's shared-memory slot
    column at 256 servers with int32 state (45,568 slots; F8): 50,000 VMs
    of the full-width row's population, arriving one a second and all
    live at once before any departs, static 0.30.  The plan keeps the slot
    column in global memory, and the reject rates of two candidates
    (int32 state forced) ``==`` the port's scalar oracle."""
    from repro_torch.core import cluster_sim, traces
    from repro_torch.core.replay_engine import CompiledReplay
    from repro_torch.kernels.event_sweep import ops
    cfg = _prov_config(PROV_FULL["n_servers"])
    n = 50_000
    t0 = time.perf_counter()
    vms = [dataclasses.replace(vm, arrival=float(i),
                               lifetime=1e5 + float((i * 7919) % n))
           for i, vm in enumerate(traces.Population(seed=0).sample_vms(
               n, 7 * 86400, seed=5, start_id=10 ** 7))]
    dec, _ = cluster_sim.policy_decisions(
        vms, "static", static_pool_frac=PROV_FULL["static_pool_frac"])
    eng = CompiledReplay(vms, dec, cfg, device=dev)
    _, _, n_slots = eng._device_events()
    cand = np.array([[384.0, 3000.0], [270.0, 500.0]])
    ops.last_plan = None
    t1 = time.perf_counter()
    rates = eng.reject_rates(cand[:, 0], cand[:, 1], state_dtype="int32")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t1
    plan = ops.last_plan
    oracle = [cluster_sim.replay_reject_rate(vms, dec, cfg, sg, pg)
              for sg, pg in cand]
    if plan is None or plan.slot_column != "global" or n_slots <= 45_568:
        raise SystemExit(f"event_sweep past the slot limit: {n_slots} slots "
                         f"ran with plan {plan}, not a global slot column")
    if rates.tolist() != oracle:
        raise SystemExit(f"event_sweep past the slot limit: rates "
                         f"{rates.tolist()} != the scalar oracle's {oracle}")
    return dict(vms=n, n_slots=n_slots, events=eng.n_events,
                plan=dataclasses.asdict(plan), rates=rates.tolist(),
                oracle=oracle, reject_rates_s=sweep_s,
                host_s=time.perf_counter() - t0 - sweep_s)


def phase_kernels_sweep(dev):
    """K1 against its plain version on the card (whole final state and the
    rejects, ``==``), its rates against the port's scalar oracle at the
    full-width trace, and its time there beside its bound."""
    from repro_torch.core import cluster_sim, sweep_core
    from repro_torch.core.replay_engine import CompiledReplay
    from repro_torch.kernels.event_sweep import cases, ops
    from repro_torch.kernels.event_sweep import kernel as K
    from repro_torch.kernels.event_sweep.ref import event_sweep_ref
    rng = np.random.default_rng(14)
    checked, max_err = [], 0
    # (name, stream, n_slots, servers, servers a group, cores, sgb, pgb)
    runs = []
    ev, n_slots = cases.edge_stream()
    lanes = np.asarray(cases.EDGE_LANES)
    runs.append(("edges", ev, n_slots, 3, 2, 8, lanes[:, 0], lanes[:, 1]))
    # S100 gives a thread of the registers variant (4 servers) two groups
    # of 3; S300 runs it at 16 servers a thread with 150 groups (more than
    # its keys carry); S600 lies above its limit (512 servers)
    for s, spg, n_lanes, mig in ((1, 8, 1, 0.2), (7, 4, 16, 0.2),
                                 (33, 8, 84, 0.2), (256, 8, 200, 0.2),
                                 (33, 8, 16, 0.0), (100, 3, 16, 0.2),
                                 (300, 2, 16, 0.2), (600, 8, 16, 0.2)):
        ev, n_slots = cases.random_stream(rng, 900, mig_frac=mig)
        sgb, pgb = cases.lane_capacities(rng, n_lanes, s, 64)
        runs.append((f"S{s}_lanes{n_lanes}_mig{mig}", ev, n_slots, s, spg,
                     64, sgb, pgb))
    for name, ev, n_slots, s, spg, cores, sgb, pgb in runs:
        for dt in ("int16", "int32"):
            events, group_of, state = _k1_inputs(ev, n_slots, s, spg, cores,
                                                 sgb, pgb, dt, dev)
            want = _k1_run(event_sweep_ref, events, group_of, state)
            # every variant that takes this shape, then the wrapper's own
            # choice, each against the plain version, with the slot column
            # where the plan puts it and forced into global memory (F8)
            for variant in _k1_variants(s) + [None]:
                for column in (None, "global"):
                    got = _k1_run(ops.event_sweep, events, group_of, state,
                                  variant=variant, slot_column=column)
                    plan = ops.last_plan
                    for a, b in zip(got, want):
                        max_err = max(max_err, int((a.long() - b.long())
                                                   .abs().max()))
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, want)):
                        raise SystemExit(
                            f"event_sweep {name} {dt} {plan.variant} "
                            f"({plan.slot_column} slot column): the "
                            "kernel's final state differs from its plain "
                            "version's")
                    checked.append(dict(case=name, state_dtype=dt,
                                        variant=plan.variant,
                                        slot_column=plan.slot_column,
                                        chosen=variant is None,
                                        servers_per_thread=plan
                                        .servers_per_thread,
                                        events=len(ev["kind"]), servers=s,
                                        lanes=len(sgb), n_slots=n_slots,
                                        rejects=int(want[4].sum())))

    # the full-width trace: rates == the port's scalar oracle
    cfg, vms, _ = _full_trace()
    dec, _ = cluster_sim.policy_decisions(
        vms, "static", static_pool_frac=PROV_FULL["static_pool_frac"])
    eng = CompiledReplay(vms, dec, cfg, device=dev)
    big = 768.0 * cfg.n_servers
    cand = np.array([[270.0, 369.37278106508876], [300.0, 200.0],
                     [250.0, 100.0], [768.0, big]])
    rates = eng.reject_rates(cand[:, 0], cand[:, 1])
    oracle = [cluster_sim.replay_reject_rate(vms, dec, cfg, s, p)
              for s, p in cand]
    if rates.tolist() != oracle:
        raise SystemExit(f"event_sweep full width: rates {rates.tolist()} "
                         f"!= the scalar oracle's {oracle}")

    # times at the full trace: fig3's 16-lane frontier, the pool search's
    # 84 lanes, one, four and eight lanes an SM (132, 528, 1056), each state
    # type forced, 5 launches on fresh state
    evs, group_of, n_slots = eng._device_events()
    n_ev, n_srv, n_grp = eng.n_events, eng.n_servers, eng.n_groups
    n_arrive = int((evs[0] == sweep_core.ARRIVE).sum())
    widths = {16: (np.linspace(150.0, 700.0, 16),
                   np.linspace(0.0, 2000.0, 16)),
              84: (np.repeat(np.linspace(270.0, 384.0, 7), 12),
                   np.tile(np.linspace(0.0, 3000.0, 12), 7)),
              132: (np.repeat(np.linspace(270.0, 384.0, 11), 12),
                    np.tile(np.linspace(0.0, 3000.0, 12), 11)),
              528: (np.repeat(np.linspace(150.0, 700.0, 44), 12),
                    np.tile(np.linspace(0.0, 3000.0, 12), 44)),
              1056: (np.repeat(np.linspace(150.0, 700.0, 88), 12),
                     np.tile(np.linspace(0.0, 3000.0, 12), 88))}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(_smi("clocks.max.sm"))
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6

    def bound(c, item, e, arrive):
        ops_ = K1_OPS_PER_ARRIVE_SERVER * arrive * c * n_srv
        state = (2 * c * n_srv + c * n_grp + n_slots * c) * item
        nbytes = 24 * e + 4 * n_srv + 2 * state + 2 * c * item + 8 * c
        t_ops, t_bytes = ops_ / int32_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    int32_ops=ops_, bytes=nbytes)

    def fresh(c, dt, reps, cut=None):
        sgb, pgb = sweep_core.quantize_capacities(*widths[c])
        np_dt = sweep_core.state_np_dtype(dt)
        st = sweep_core.init_state(c, n_srv, eng.cores_per_server, n_srv,
                                   n_grp, n_slots, np_dt)[:4]
        ev_c = evs if cut is None else tuple(e[:cut].contiguous()
                                             for e in evs)
        caps = [torch.from_numpy(a.astype(np_dt)).to(dev)
                for a in (sgb, pgb)]
        return ev_c, [[torch.from_numpy(a.copy()).to(dev) for a in st]
                      + caps for _ in range(reps)]

    def time_kernel(ev_c, states, variant=None, trace_events=None,
                    slot_column=None):
        kw = dict(variant=variant, trace_events=trace_events,
                  slot_column=slot_column)
        ops.event_sweep(*ev_c, group_of, *[t.clone() for t in states[0]],
                        **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for st in states:
            ops.event_sweep(*ev_c, group_of, *st, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(states)

    def timed(c, dt, variant=None, slot_column=None):
        ev_c, states = fresh(c, dt, 5)
        ms = time_kernel(ev_c, states, variant, slot_column=slot_column)
        plan = ops.last_plan
        return dict(ms=ms, ns_per_event=ms * 1e6 / n_ev,
                    variant=plan.variant,
                    servers_per_thread=plan.servers_per_thread,
                    lanes_per_block=plan.lanes_per_block,
                    slot_column=plan.slot_column,
                    **bound(c, 2 if dt == "int16" else 4, n_ev, n_arrive))

    timings = {f"lanes{c}_{dt}": timed(c, dt)
               for c in (16, 84, 132, 528, 1056)
               for dt in ("int16", "int32")}
    # the trace axis's own cost (T = 1 takes the single-trace build by
    # dispatch, so the axis costs only when T > 1): the full trace three
    # times over as one batch of 3 x 16 lanes, each trace's lanes the
    # 16-lane frontier's, against one 16-lane launch, in turns (single,
    # batch, batch, single); each trace's rejects == the single launch's
    evs3, counts3 = ops.pack_traces([evs] * 3, dev)

    def thrice(states):
        return [[torch.cat([t] * 3, dim=1 if i == 3 else 0)
                 for i, t in enumerate(st)] for st in states]

    axis_cost = {}
    for dt in ("int16", "int32"):
        _, states = fresh(16, dt, 5)
        one = ops.event_sweep(*evs, group_of,
                              *[t.clone() for t in states[0]])
        three = ops.event_sweep(*evs3, group_of, *thrice(states[:1])[0],
                                trace_events=counts3)
        if not torch.equal(three, one.repeat(3)):
            raise SystemExit(f"event_sweep {dt}: the full trace thrice in "
                             "one batch differs from the single launch")
        r = [time_kernel(evs, fresh(16, dt, 5)[1]) if single else
             time_kernel(evs3, thrice(fresh(16, dt, 5)[1]),
                         trace_events=counts3)
             for single in (True, False, False, True)]
        single_ms, batch_ms = min(r[0], r[3]), min(r[1], r[2])
        axis_cost[dt] = dict(single_16_ms=single_ms, batch_3x16_ms=batch_ms,
                             ratio=batch_ms / single_ms, runs=r)
    trace_axis = _k1_trace_axis(dev, int32_rate)
    # every variant at 16 lanes, in the same call, on the whole trace and
    # on copies of it in which every event but some kinds is a PAD (read
    # and skipped): ns an event of a kind is (its stream's ms - the all-PAD
    # stream's) / its count; and the registers and shared variants' final
    # states at the full trace against each other
    kind = evs[0]
    streams, kind_counts = {}, {}
    for name, kinds in (("pad", ()), ("arrive", (sweep_core.ARRIVE,)),
                        ("depart_migrate", (sweep_core.DEPART,
                                            sweep_core.MIGRATE))):
        keep = torch.isin(kind, torch.tensor(kinds, dtype=kind.dtype,
                                             device=dev))
        streams[name] = (torch.where(keep, kind, sweep_core.PAD)
                         .contiguous(), *evs[1:])
        kind_counts[name] = int(keep.sum())
    variant_timings, by_kind, full_equal, global_timings = {}, {}, {}, {}
    for dt in ("int16", "int32"):
        for variant in _k1_variants(n_srv):
            key = f"{variant}_lanes16_{dt}"
            variant_timings[key] = timed(16, dt, variant)
            ms = {name: time_kernel(ev_s, fresh(16, dt, 5)[1], variant)
                  for name, ev_s in streams.items()}
            ns = {name: (ms[name] - ms["pad"]) * 1e6 / kind_counts[name]
                  for name in ("arrive", "depart_migrate")}
            by_kind[key] = dict(ms=dict(all=variant_timings[key]["ms"],
                                        **ms),
                                ns_an_event=dict(
                                    pad=ms["pad"] * 1e6 / n_ev, **ns))
        ev_c, states = fresh(16, dt, 1)
        outs = [_k1_run(ops.event_sweep, ev_c, group_of, states[0],
                        variant=v) for v in ("registers", "shared")]
        full_equal[dt] = all(torch.equal(a, b) for a, b in zip(*outs))
        # the slot column in global memory (F8), each variant: the same
        # final state as the shared-column run, and its time at 16 lanes
        for v, shared_out in zip(("registers", "shared"), outs):
            got = _k1_run(ops.event_sweep, ev_c, group_of, states[0],
                          variant=v, slot_column="global")
            full_equal[f"{dt}_{v}_global_slots"] = all(
                torch.equal(a, b) for a, b in zip(got, shared_out))
            global_timings[f"{v}_lanes16_{dt}"] = timed(16, dt, v, "global")
    if not all(full_equal.values()):
        raise SystemExit(f"event_sweep full trace: the variants' or the slot "
                         f"columns' final states differ: {full_equal}")
    past_limit = _k1_past_the_slot_limit(dev)
    # the plain version beside the kernel at a 2,048-event cut (16 lanes)
    cut = 2048
    ev_c, states = fresh(16, "int16", 5, cut=cut)
    cut_ms = time_kernel(ev_c, states)
    ev_c, states = fresh(16, "int16", 1, cut=cut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    event_sweep_ref(*ev_c, group_of, *states[0],
                    torch.zeros(16, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    plain_cut_ms = (time.perf_counter() - t0) * 1e3
    main = timings["lanes16_int16"]
    record = dict(
        name=K.NAME, route="cuda", source=K.SOURCE,
        replaces="src/repro/core/sweep_core.py:138",
        max_abs_err=max_err, tolerance="== (integer state, exact)",
        cases_checked=len(checked), cases=checked,
        full_width_rates=rates.tolist(), full_width_oracle=oracle,
        design="registers variant up to 512 servers: one warp a lane, a "
               "thread's K = S/32 servers (free cores, used local, group, "
               "a copy of the group's pool) in registers, branch-free masks "
               "against per-event bounds, a tree over K then redux.sync "
               "(one packed (f, server) key for int16, two steps for "
               "int32), predicated updates, the slot column in shared "
               "memory by thread 0 alone; shared variant beyond (the first "
               "port's kernel: the lane in shared memory, a 64-bit shuffle "
               "argmin); events by 2-stage cp.async tiles of 1024; a trace "
               "axis: T streams in one set of event arrays, a block one "
               "trace's lanes (grid: blocks a trace x T); a slot column "
               "too large for shared memory stays in its column of slots "
               "in global memory (both variants, both builds)",
        full_trace_variants_equal=full_equal,
        global_slot_column_timings=global_timings,
        past_the_slot_limit=past_limit,
        ms=main["ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        timed_shape=dict(events=n_ev, arrivals=n_arrive, servers=n_srv,
                         groups=n_grp, n_slots=n_slots, lanes=16,
                         state_dtype="int16"),
        timings=timings, variant_timings=variant_timings,
        by_kind=by_kind, kind_counts=kind_counts,
        trace_axis=trace_axis, trace_axis_cost=axis_cost,
        trace_axis_cost_note="the full trace three times over as one "
                             "batch of 3 x 16 lanes (the batched build) "
                             "against one 16-lane launch (the single-trace "
                             "build, which T = 1 takes), in turns",
        plain_ms=plain_cut_ms, plain_cut_events=cut,
        ms_at_plain_cut=cut_ms,
        plain_note="the plain version (a Python loop of tensor ops an "
                   "event) at a 2,048-event cut of the trace, 16 lanes, "
                   "int16, one run by the host clock; ms_at_plain_cut is "
                   "the kernel on the same cut",
        int32_rate_ops_per_s=int32_rate, sm_clock_max_mhz=clock_mhz,
        library_ms=None,
        library_note="no PyTorch call computes a sequential best-fit sweep")
    emit("kernels", kernels=[record])
    return record


def _smi(field: str) -> str:
    import subprocess
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.strip().splitlines()[0]


def _savings_pair(vms, cfg, static_frac, device):
    """The provisioning loop as a user calls it: local, then static, one
    shared cache.  Returns (local, static, the all-local engine)."""
    from repro_torch.core.cluster_sim import savings_analysis
    cache = {}
    local = savings_analysis(vms, cfg, "local", cache=cache, device=device)
    static = savings_analysis(vms, cfg, "static", cache=cache,
                              static_pool_frac=static_frac, device=device)
    return local, static, cache["local_engine"]


def phase_provision_parity_small(dev):
    """The 8-server world (seed 3; static 0.25 and local) on the card (K1)
    and on the CPU (its plain version): equal PolicyResults and equal
    frontier rates."""
    from repro_torch.core import cluster_sim, traces
    from repro_torch.core.replay_engine import CompiledReplay
    from repro_torch.kernels.event_sweep import ops
    cfg = cluster_sim.ClusterConfig(n_servers=8, pool_sockets=8,
                                    gb_per_core=4.75)
    horizon = 4 * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms = traces.Population(seed=0).sample_vms(n, horizon, seed=3,
                                               start_id=10 ** 6)
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=0.25)
    server = np.array([768.0, 200.0, 140.0, 250.0, 180.0, 60.0, 219.7, 0.0])
    pool = np.array([6144.0, 300.0, 150.0, 0.0, 40.0, 6144.0, 83.3, 100.0])
    out = {}
    for d in (dev, "cpu"):
        before = ops.launches
        res = _savings_pair(vms, cfg, 0.25, d)[:2]
        rates = CompiledReplay(vms, dec, cfg, device=d).reject_rates(server,
                                                                     pool)
        out[str(d)] = ([dataclasses.asdict(r) for r in res], rates.tolist(),
                       ops.launches - before)
    (g_res, g_rates, g_n), (c_res, c_rates, c_n) = out[str(dev)], out["cpu"]
    checks = {"results_equal": g_res == c_res, "rates_equal": g_rates == c_rates,
              "launches_on_card": g_n > 0, "none_on_cpu": c_n == 0}
    emit("provision_parity_small", ok=all(checks.values()), checks=checks,
         servers=8, vms=n, results=g_res, frontier_rates=g_rates,
         kernel_launches=g_n)
    if not all(checks.values()):
        raise SystemExit(f"provision_parity_small failed: {checks}")


def phase_provision_full(dev):
    """Pond's provisioning loop at full width (``PROV_FULL``): local and
    static savings_analysis on one shared cache, held to the reference's
    PolicyResults."""
    from repro_torch.core import cluster_sim, replay_engine
    from repro_torch.kernels.event_sweep import ops
    cfg, vms, sample_s = _full_trace()
    frac = PROV_FULL["static_pool_frac"]
    t0 = time.perf_counter()
    for policy in ("local", "static"):
        cluster_sim.policy_decisions(vms, policy, static_pool_frac=frac)
    decisions_s = time.perf_counter() - t0
    replay_engine.stats_reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this one
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    local, static, eng = _savings_pair(vms, cfg, frac, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    peak = torch.cuda.max_memory_allocated()
    stats = replay_engine.stats_snapshot()
    times = replay_engine.stage_times()
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=frac)
    t1 = time.perf_counter()
    oracle = cluster_sim.replay_reject_rate(vms, dec, cfg, static.server_gb,
                                            static.pool_group_gb)
    oracle_s = time.perf_counter() - t1
    got = [dataclasses.asdict(r) for r in (local, static)]
    checks = {
        "local_equals_reference": got[0] == PROV_FULL_WANT["local"],
        "static_equals_reference": got[1] == PROV_FULL_WANT["static"],
        "reject_rate_is_the_oracles": static.reject_rate == oracle,
        "launches_equal_sweeps": launches == stats["sweeps"] and launches > 0,
        "on_card": eng.device.type == "cuda",
    }
    lanes = [n for n, _ in times.sweeps]
    emit("provision_full", ok=all(checks.values()), checks=checks,
         config=dict(PROV_FULL, cores_per_server=cfg.cores_per_server,
                     pool_sockets=cfg.pool_sockets, gb_per_core=cfg.gb_per_core,
                     groups=cfg.n_groups),
         vms=len(vms), results=got, savings=[local.savings, static.savings],
         kernel_launches=launches, sweeps=len(lanes), sweep_lanes=lanes,
         sweep_state_dtypes=[d for _, d in times.sweeps],
         engine_stats=stats,
         candidate_events_per_s=stats["events_per_sec"],
         host_seconds=dict(sampling=sample_s, decisions=decisions_s,
                           compile=times.compile_s,
                           trajectories=times.trajectory_s,
                           device_sweeps=times.sweep_s,
                           other=wall - times.compile_s - times.trajectory_s
                           - times.sweep_s,
                           oracle_at_chosen_point=oracle_s),
         wall_seconds=wall,
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_loop_bytes=peak - held)
    if not all(checks.values()):
        raise SystemExit(f"provision_full failed: {checks}")
    return launches


def _pond_loop(vms_list, cfg, models, frac, device,
               max_events_per_shard=None):
    """Fig 21's loop as a user calls it: ``savings_analysis_batched`` for
    local, static and pond (a fresh control plane a trace) on one shared
    cache, streamed past ``max_events_per_shard``.  Returns ({policy:
    [PolicyResult a trace]}, the pond planes, the all-local batch)."""
    from repro_torch.core.cluster_sim import savings_analysis_batched
    cache, out = {}, {}
    planes = [_pond_plane(*models) for _ in vms_list]
    for policy in ("local", "static", "pond"):
        out[policy] = savings_analysis_batched(
            vms_list, cfg, policy, static_pool_frac=frac, cache=cache,
            control_planes=planes if policy == "pond" else None,
            device=device, max_events_per_shard=max_events_per_shard)
    return out, planes, cache["local_batch"]


def phase_pond_batch_parity_small(dev):
    """Fig 21's batched loop on a small world (8 servers, trace seeds 3
    and 4, models fitted on 300 VMs) on the card (K1's trace axis) and on
    the CPU (its plain version): equal PolicyResults for local, static and
    pond, and equal control-plane end states."""
    from repro_torch.core import cluster_sim, traces
    from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                    UntouchedMemoryModel)
    from repro_torch.kernels.event_sweep import ops
    cfg = cluster_sim.ClusterConfig(n_servers=8, pool_sockets=8,
                                    gb_per_core=4.75)
    horizon = 2 * 86400
    pop = traces.Population(seed=0)
    train = pop.sample_vms(300, 10 * 86400, seed=1)
    hist = traces.build_history(train)
    models = (LatencySensitivityModel(pdm=0.05).fit(
        traces.pmu_matrix(train), traces.slowdowns(train, 182)),
        UntouchedMemoryModel(0.05).fit(
            traces.metadata_features(train, hist),
            np.array([v.untouched for v in train])), hist)
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms_list = [pop.sample_vms(n, horizon, seed=s, start_id=10 ** 6)
                for s in (3, 4)]
    out = {}
    for d in (dev, "cpu"):
        before = ops.launches
        res, planes, _ = _pond_loop(vms_list, cfg, models, 0.25, d)
        out[str(d)] = (
            {p: [dataclasses.asdict(r) for r in rs] for p, rs in res.items()},
            [([dataclasses.astuple(m) for m in cp.mitigation.log],
              {c: list(h) for c, h in cp.history.items()})
             for cp in planes], ops.launches - before)
    (g_res, g_planes, g_n), (c_res, c_planes, c_n) = out[str(dev)], out["cpu"]
    checks = {"results_equal": g_res == c_res,
              "planes_equal": g_planes == c_planes,
              "pond_mitigates": all(r["mitigations"] > 0
                                    for r in g_res["pond"]),
              "launches_on_card": g_n > 0, "none_on_cpu": c_n == 0}
    emit("pond_batch_parity_small", ok=all(checks.values()), checks=checks,
         servers=8, seeds=[3, 4], vms=n, results=g_res, kernel_launches=g_n)
    if not all(checks.values()):
        raise SystemExit(f"pond_batch_parity_small failed: {checks}")


def phase_pond_batch_full(dev):
    """Pond's own policy over a seed batch at full width
    (``POND_BATCH_FULL``, Fig 21's path): local, static and pond through
    ``savings_analysis_batched`` on one shared cache, every PolicyResult
    held to the reference's."""
    from repro_torch.core import cluster_sim, replay_engine
    from repro_torch.kernels.event_sweep import ops
    inp = _pond_inputs()
    cfg, vms_list = inp["cfg"], inp["vms_list"]
    models = (inp["li"], inp["um"], inp["hist"])
    frac = POND_BATCH_FULL["static_pool_frac"]
    replay_engine.stats_reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this one
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    res, planes, local_batch = _pond_loop(vms_list, cfg, models, frac, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    peak = torch.cuda.max_memory_allocated()
    stats = replay_engine.stats_snapshot()
    times = replay_engine.stage_times()
    # the chosen point's rate against the port's scalar oracle, pond's
    # first trace (its decisions from a fresh plane are the loop's)
    pond0 = res["pond"][0]
    t1 = time.perf_counter()
    oracle = cluster_sim.replay_reject_rate(
        vms_list[0], _pond_decisions()[0].as_vmdecisions(), cfg,
        pond0.server_gb, pond0.pool_group_gb)
    oracle_s = time.perf_counter() - t1
    got = {p: [dataclasses.asdict(r) for r in rs] for p, rs in res.items()}
    summary = {p: cluster_sim.summarize_savings(rs) for p, rs in res.items()}
    checks = {f"{p}_equals_reference": got[p] == POND_BATCH_WANT[p]
              for p in POND_BATCH_WANT}
    checks |= {
        "pond_mitigations_are_the_planes": [r.mitigations for r in
                                            res["pond"]]
        == [len(cp.mitigation.log) for cp in planes],
        "pond_reject_rate_is_the_oracles": pond0.reject_rate == oracle,
        "launches_equal_sweeps": launches == stats["sweeps"] and launches > 0,
        "no_trajectories": times.trajectory_s == 0.0,
        "on_card": local_batch.device.type == "cuda",
    }
    lanes = [n for n, _ in times.sweeps]
    other = (wall - times.decisions_s - times.compile_s - times.sweep_s
             - times.trajectory_s)
    emit("pond_batch_full", ok=all(checks.values()), checks=checks,
         config=dict(POND_BATCH_FULL, n_servers=cfg.n_servers,
                     days=PROV_FULL["days"],
                     cores_per_server=cfg.cores_per_server,
                     pool_sockets=cfg.pool_sockets,
                     gb_per_core=cfg.gb_per_core, groups=cfg.n_groups),
         vms=[len(v) for v in vms_list], results=got,
         savings={p: dict(mean=s["savings_mean"], std=s["savings_std"])
                  for p, s in summary.items()},
         mispredictions_mean=summary["pond"]["mispred_mean"],
         kernel_launches=launches, sweeps=len(lanes), sweep_lanes=lanes,
         sweep_state_dtypes=[d for _, d in times.sweeps],
         engine_stats=stats,
         candidate_events_per_s=stats["events_per_sec"],
         host_seconds=dict(sampling=inp["sampling_s"],
                           fitting=inp["fitting_s"],
                           decisions=times.decisions_s,
                           compile_and_upload=times.compile_s,
                           device_sweeps=times.sweep_s,
                           trajectories=times.trajectory_s, other=other,
                           oracle_at_chosen_point=oracle_s),
         wall_seconds=wall,
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_loop_bytes=peak - held)
    if not all(checks.values()):
        raise SystemExit(f"pond_batch_full failed: {checks}")
    return launches


# ------------------------------------------- the spill sweep (K6, M11) --
_SPILL = {}


def _spill_full():
    """Fig 16's full-width streams (``SPILL_FULL``), made once: the PAD-
    padded (K, E) kinds and keys, each stream's own arrays, the peaks, the
    80 config lanes and the host seconds of making them."""
    if not _SPILL:
        from repro_torch.kernels.spill_sweep import cases
        f = SPILL_FULL
        t0 = time.perf_counter()
        kinds, keys, streams, peaks = cases.kv_event_batch(
            f["seeds"], f["n_requests"], f["peak_pages"])
        nl = np.arange(f["local_step"], f["peak_pages"] + 1, f["local_step"],
                       dtype=np.int32)
        _SPILL.update(kinds=kinds, keys=keys, streams=streams, peaks=peaks,
                      nl=nl, npl=np.full_like(nl, f["num_pool"]),
                      n_keys=int(keys.max()) + 1,
                      seconds=time.perf_counter() - t0)
    return _SPILL


def _spill_run(fn, kinds, keys, nl, npl, n_keys, dev):
    """``fn`` (K6's wrapper or its plain version) on ``dev``: the five
    counters and the final tier map."""
    from repro_torch.kernels.spill_sweep import ops
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (kinds, keys, nl, npl)]
    tier = torch.empty((kinds.shape[0], n_keys, len(nl)), dtype=torch.int8,
                       device=dev)
    out = (fn(*args, n_keys, tier=tier) if fn is ops.spill_sweep
           else fn(*args, tier))
    torch.cuda.synchronize()
    return [*out, tier]


def _pad4(a, value):
    """(K, E) -> (K, E rounded up to a multiple of 4), as the wrapper
    stages it."""
    return np.pad(a, ((0, 0), (0, -a.shape[1] % 4)), constant_values=value)


def _card_ms(runs, clock_mhz, what):
    """Mean device ms of ``runs`` (callables, each one piece of work) by
    CUDA events recorded behind a ``CARD_WAIT_MS`` wait on the card, so
    that the window holds no host dispatch; fails if enqueueing the runs
    took longer than the wait."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(CARD_WAIT_MS * clock_mhz * 1e3))
    t0 = time.perf_counter()
    start.record()
    for run in runs:
        run()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if enqueue_ms >= CARD_WAIT_MS:
        raise SystemExit(f"{what} timing: enqueueing {len(runs)} runs took "
                         f"{enqueue_ms:.1f} ms, longer than the "
                         f"{CARD_WAIT_MS} ms wait before them")
    return start.elapsed_time(end) / len(runs)


def phase_kernels_spill(dev):
    """K6 against its plain version on the card (the five counters and
    the final tier map, ``==``) over edge and seeded cases, a case longer
    than three tiles, 200 streams x 192 lanes (a plan whose tile is below
    ``MAX_TILE``) and the full-width streams' first 2,048 events; at full
    width every lane of seed 3's stream and 8 lanes of each other stream
    against the port's scalar oracle; the whole device work of a sweep
    (the links pass and the kernel with its final map) timed at 80 and
    1,280 lanes beside the bound, the links (and the links kernel) and
    the kernel each alone; the chain floor, a one-warp probe of the
    walk's counter chain over the longest stream's events, timed; the
    plain version's time on the 2,048-event cut."""
    from repro_torch.core import latency_engine as le
    from repro_torch.kernels import build
    from repro_torch.kernels.spill_sweep import cases, ops
    from repro_torch.kernels.spill_sweep import kernel as K6
    from repro_torch.kernels.spill_sweep.ref import ALLOC, FREE, PAD
    from repro_torch.kernels.spill_sweep.ref import spill_sweep_ref
    checked, max_err = [], 0
    full = _spill_full()
    cut = 2048
    long_k, long_b = cases.to_arrays(cases.random_events(
        np.random.default_rng(17), 64, 4 * K6.MAX_TILE + 300))
    # 200 streams x 192 lanes: 6 warps a block, so the plan halves the
    # tile; the first stream has links planted across its tiles' bounds
    half = K6.MAX_TILE // 2
    wide = [cases.to_arrays(cases.tile_boundary_events(half))] + [
        cases.to_arrays(cases.random_events(np.random.default_rng(100 + s),
                                            48, 3 * half))
        for s in range(199)]
    runs = cases.edge_cases() + cases.seeded_cases() + [
        ("four_tiles", long_k[None], long_b[None], *cases.lane_configs(70)),
        ("wide_half_tile", *cases.pad_streams(wide),
         *cases.lane_configs(192)),
        ("full_width_first_2048", full["kinds"][:, :cut],
         full["keys"][:, :cut], full["nl"], full["npl"])]
    for name, kinds, keys, nl, npl in runs:
        n_keys = int(keys.max(initial=0)) + 1
        want = _spill_run(spill_sweep_ref, kinds, keys, nl, npl, n_keys, dev)
        got = _spill_run(ops.spill_sweep, kinds, keys, nl, npl, n_keys, dev)
        for a, b in zip(got, want):
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"spill_sweep {name}: the kernel's counters or "
                             "tier map differ from its plain version's")
        if name == "wide_half_tile" and ops.last_plan.tile != half:
            raise SystemExit(f"spill_sweep {name}: planned tile "
                             f"{ops.last_plan.tile}, not {half}")
        checked.append(dict(case=name, streams=kinds.shape[0],
                            events=kinds.shape[1], lanes=len(nl),
                            keys=n_keys, plan=dataclasses.asdict(
                                ops.last_plan),
                            allocs=int(want[0].sum()),
                            pool_allocs=int(want[1].sum()),
                            failed=int(want[2].sum())))

    # full width, one launch: seed 3's every lane and 8 lanes of each other
    # stream against the port's scalar oracle (ZNumaAllocator)
    kinds, keys, nl, npl = (full[k] for k in ("kinds", "keys", "nl", "npl"))
    n_keys = full["n_keys"]
    got = _spill_run(ops.spill_sweep, kinds, keys, nl, npl, n_keys, dev)
    got = [g.cpu().numpy() for g in got[:5]]
    t0 = time.perf_counter()
    n_oracle = 0
    for s, (k_s, b_s) in enumerate(full["streams"]):
        lanes = range(len(nl)) if s == 0 else range(0, len(nl), 10)
        for c in lanes:
            ref = le.scalar_spill_replay(k_s, b_s, nl[c], npl[c])
            want = [int(getattr(ref, f)) for f in (
                "allocs", "pool_allocs", "failed", "local_in_use",
                "pool_in_use")]
            if [int(g[s, c]) for g in got] != want:
                raise SystemExit(f"spill_sweep full width: stream {s} lane "
                                 f"{c} differs from the scalar oracle")
            n_oracle += 1
    oracle_s = time.perf_counter() - t0

    # times by CUDA events over sweeps of the device work the wrapper
    # enqueues after its checks (which read the keys back to the host):
    # the links pass and the kernel with its final map; each alone too.
    # The bound from this run's events and shapes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(_smi("clocks.max.sm"))
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    n_alloc, n_free = int((kinds == ALLOC).sum()), int((kinds == FREE).sum())
    longest = max(len(k_s) for k_s, _ in full["streams"])

    def bound(c, e, n_k):
        ops_ = c * (K6_OPS_PER_ALLOC_LANE * n_alloc
                    + K6_OPS_PER_FREE_LANE * n_free)
        nbytes = (8 * kinds.shape[0] * e + 8 * c + kinds.shape[0] * n_k * c
                  + 5 * 4 * kinds.shape[0] * c)
        t_ops = ops_ / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    int32_ops=ops_, bytes=nbytes)

    kinds_t = torch.from_numpy(_pad4(kinds, PAD)).to(dev)
    keys_t = torch.from_numpy(_pad4(keys, 0)).to(dev)

    def events_ms(fn, reps=5):
        fn()
        return _card_ms([fn] * reps, clock_mhz, "spill_sweep")

    def time_sweep(kd, ky, lanes):
        nl_t = torch.from_numpy(lanes).to(dev)
        npl_t = torch.full_like(nl_t, SPILL_FULL["num_pool"])
        n_st = kd.shape[0]
        tier = torch.empty((n_st, n_keys, len(lanes)), dtype=torch.int8,
                           device=dev)
        ms = events_ms(lambda: ops.sweep_on_card(kd, ky, nl_t, npl_t, tier))
        plan = ops.last_plan
        links_ms = events_ms(lambda: ops.spill_links(kd, ky, n_keys), 20)
        prev, last = ops.spill_links(kd, ky, n_keys)
        # the links kernel alone, on the sort the links pass made
        live = (kd == ALLOC) | (kd == FREE)
        skey, order = torch.sort(torch.where(live, ky, n_keys), dim=1,
                                 stable=True)
        prev2 = torch.empty_like(prev)
        last2 = torch.full_like(last, -1)
        links_kernel_ms = events_ms(lambda: K6.spill_links_kernel(
            skey, order, prev2, last2), 20)
        if not (torch.equal(prev2, prev) and torch.equal(last2, last)):
            raise SystemExit("spill_sweep: the links kernel alone differs "
                             "from the links pass")
        words = torch.empty((n_st, -(-len(lanes) // 32), kd.shape[1], 2),
                            dtype=torch.int32, device=dev)
        out = torch.empty((5, n_st, len(lanes)), dtype=torch.int32,
                          device=dev)
        kernel_ms = events_ms(lambda: K6.spill_sweep_kernel(
            kd, prev, last, nl_t, npl_t, words, tier, out, plan=plan))
        return ms, links_ms, links_kernel_ms, kernel_ms, plan

    # the chain floor: one warp through the walk's counter chain alone
    # for the longest stream's events (rounded up to 8), timed
    steps = -(-longest // 8) * 8
    chain_out = torch.empty(32, dtype=torch.int32, device=dev)
    chain_ms = events_ms(lambda: K6.spill_chain_kernel(steps, chain_out))
    if not bool((chain_out == 1).all()):
        raise SystemExit("spill_sweep chain probe: a counter left 1")
    chain_cycles = chain_ms * 1e-3 * clock_mhz * 1e6 / steps

    n_ev = kinds.shape[1]
    timings = {}
    for name, lanes in (("lanes80", nl),
                        ("lanes1280", np.arange(1, 1281, dtype=np.int32))):
        ms, links_ms, links_kernel_ms, kernel_ms, plan = time_sweep(
            kinds_t, keys_t, lanes)
        timings[name] = dict(ms=ms, links_ms=links_ms,
                             links_kernel_ms=links_kernel_ms,
                             kernel_ms=kernel_ms,
                             ns_per_event=ms * 1e6 / n_ev,
                             kernel_ns_per_event=kernel_ms * 1e6 / n_ev,
                             kernel_cycles_per_event=kernel_ms * 1e-3
                             * clock_mhz * 1e6 / longest,
                             lanes=len(lanes),
                             streams=kinds.shape[0],
                             plan=dataclasses.asdict(plan),
                             **bound(len(lanes), n_ev, n_keys))
    # the kernel alone at 80 lanes on copies of the streams in which every
    # event but some kinds is a PAD (each copy with its own links): ns an
    # event whatever its kind, the cost of the walk's skeleton
    by_kind = {}
    for name, keep in (("all", (ALLOC, FREE)), ("pad", ()),
                       ("alloc", (ALLOC,)), ("free", (FREE,))):
        kd_k = torch.where(torch.isin(kinds_t, torch.tensor(
            keep, dtype=kinds_t.dtype, device=dev)), kinds_t, PAD)
        ms = time_sweep(kd_k.contiguous(), keys_t, nl)[3]
        by_kind[name] = dict(kernel_ms=ms,
                             cycles_per_event=ms * 1e-3 * clock_mhz * 1e6
                             / longest)
    # the plain version beside the kernel on the 2,048-event cut (4
    # streams x 80 lanes): the plain version once by the host clock
    cut_ms = time_sweep(kinds_t[:, :cut].contiguous(),
                        keys_t[:, :cut].contiguous(), nl)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _spill_run(spill_sweep_ref, kinds[:, :cut], keys[:, :cut], nl, npl,
               n_keys, dev)
    plain_cut_ms = (time.perf_counter() - t0) * 1e3
    with open(f"{build.library_path(K6.NAME)}.log") as f:
        report = build.ptxas_entries(f.read())
    main = timings["lanes80"]
    record = dict(
        name=K6.NAME, route="cuda", source=K6.SOURCE,
        replaces="src/repro/core/latency_engine.py:253",
        max_abs_err=max_err, tolerance="== (integer state, exact)",
        cases_checked=len(checked), cases=checked,
        full_width_oracle_lanes=n_oracle, oracle_seconds=oracle_s,
        design="the linked form: each event's previous ALLOC or FREE of "
               "its key and each key's last one, from the stream alone "
               "(a stable device sort of the keys, then the links kernel); "
               "one warp a (stream, 32 lanes), free counters in registers; "
               "a key's tier after each event as two ballot words a warp "
               "in a word array; a block one stream's warps, kinds and "
               "links staged by 2-stage 16-byte cp.async tiles; a tile "
               "fetches its earlier links' words by cp.async, the walk "
               "reads every tier from shared memory an event ahead; the "
               "final map from each key's last word in one parallel pass",
        ms=main["ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        links_ms=main["links_ms"], links_kernel_ms=main["links_kernel_ms"],
        kernel_ms=main["kernel_ms"],
        chain_floor_ms=chain_ms, chain_cycles_per_step=chain_cycles,
        chain_floor_note=f"timed: one warp replays {steps} steps (the "
                         f"longest stream's {longest} events, rounded up "
                         "to 8) of the walk's free counter chain alone "
                         "(spill_chain_kernel: a compare, then two "
                         "predicated adds a step); reported, not the "
                         "bound",
        timing_note=f"CUDA events around 5 sweeps (20 links passes) "
                    f"enqueued behind a {CARD_WAIT_MS} ms wait on the card, "
                    "so the host's dispatch is not timed",
        timed_shape=dict(streams=kinds.shape[0], events=n_ev,
                         longest_stream=longest, allocs=n_alloc,
                         frees=n_free, keys=n_keys, lanes=len(nl),
                         tier_map_bytes=kinds.shape[0] * n_keys * len(nl)),
        timings=timings, by_kind=by_kind, ptxas=report,
        plain_ms=plain_cut_ms, plain_cut_events=cut, ms_at_plain_cut=cut_ms,
        plain_note="the plain version (a Python loop of tensor ops an "
                   "event) on the full-width streams' first 2,048 events, "
                   "4 streams x 80 lanes, one run by the host clock; "
                   "ms_at_plain_cut is the kernel on the same cut",
        int32_rate_ops_per_s=int32_rate, sm_clock_max_mhz=clock_mhz,
        library_ms=None,
        library_note="no PyTorch call computes a sequential per-lane "
                     "allocator")
    emit("kernels_spill", kernels=[record])
    return record


# ------------------------------------------ the latency grids (M11) -----
def phase_latency_grids_parity_small(dev):
    """Every latency_engine grid with ``backend="torch"`` on the card
    ``==`` the numpy backend at the reference tests' small shapes; the
    spill grid on the card ``==`` on the CPU (its plain version); tier
    pricing on the card ``==`` numpy."""
    from repro_torch.core import cluster_sim, latency_engine as le
    from repro_torch.core import latency_model as lm
    from repro_torch.core.policy_engine import PolicyDecisions
    from repro_torch.kernels.spill_sweep import cases, ops
    checks = {}

    def same(name, fn, *args, **kw):
        a = fn(*args, backend="torch", device=dev, **kw)
        b = fn(*args, backend="numpy", **kw)
        flat = lambda x: [dataclasses.astuple(p) if dataclasses.is_dataclass(
            p) else np.asarray(p).tolist() for p in (
            x if isinstance(x, (tuple, list)) else [x])]
        checks[name] = flat(a) == flat(b)

    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        for shape in ((40,), (1,), (1, 40), (3, 2, 25)):
            same(f"bands_{seed}_{shape}", le.slowdown_band_grid,
                 rng.lognormal(-3, 1.2, size=shape))
        for depth, c in ((1, 1), (1, 4), (2, 3)):
            hs = [lm.TierHierarchy(tuple(
                lm.MemoryTier(f"t{i}", float(x)) for i, x in enumerate(
                    np.sort(rng.uniform(0.2, 6.0, depth + 1)))),
                cache_hit_rate=float(rng.uniform(0, 0.9)))
                for _ in range(c)]
            same(f"hierarchy_{seed}_{depth}_{c}", le.hierarchy_slowdown_grid,
                 rng.uniform(0, 0.5, size=(7, depth)),
                 *le.hierarchy_params(hs))
        same(f"pdm_{seed}", le.pdm_violation_grid,
             rng.lognormal(-3, 1.0, size=(4, 30)), [0.01, 0.05, 0.25])
        for n in (1, 137):
            same(f"li_curve_{seed}_{n}", le.li_curve_grid,
                 np.round(rng.random(n), 2), rng.random(n) < 0.3)
        li_curve = list(zip(np.sort(rng.random(21)).tolist(),
                            np.sort(rng.random(21) / 8).tolist()))
        um_curve = list(zip(np.sort(rng.random(9)).tolist(),
                            np.sort(rng.random(9) / 10).tolist()))
        same(f"combine_{seed}", le.combine_grid, li_curve, um_curve,
             [0.0, 0.01, 0.02, 0.1, 1.0])
        n = 60
        same(f"qos_{seed}", le.qos_mitigation_grid,
             np.round(rng.random(n), 2), rng.random(n) < 0.6,
             np.where(rng.random(n) < 0.8, rng.uniform(1, 8, n), 0.0),
             [0.0, 0.35, 0.5, 1.0], migrated=rng.random(n) < 0.1)
        local = rng.integers(0, 16, 40).astype(float)
        pool = np.where(rng.random(40) < 0.7, rng.integers(0, 12, 40), 0.0)
        dec = PolicyDecisions(local, pool, np.zeros(40, bool),
                              np.full(40, np.nan))
        same(f"tiered_pricing_{seed}", cluster_sim.tiered_pricing, dec,
             lm.TierHierarchy.three_tier(cache_hit_rate=0.25),
             (0.0, 0.3, 1.0), 0.05)
    same("combine_tie", le.combine_grid, [(0.5, 0.0), (0.5, 0.0)],
         [(0.2, 0.0), (0.2, 0.0)], [0.05])
    same("combine_empty", le.combine_grid, [(0.4, 0.5)], [(0.3, 0.5)],
         [0.001])
    same("pdm_boundary", le.pdm_violation_grid, [0.04, 0.05, 0.06], [0.05])
    # the spill grid: card (K6) == CPU (its plain version) == numpy
    before = ops.launches
    n_spill = 0
    for name, kinds, keys, nl, npl in cases.seeded_cases() + [
            cases.edge_cases()[-1]]:
        grids = [le.spill_grid(kinds, keys, nl, npl, **kw) for kw in (
            dict(device=dev), dict(device="cpu"), dict(backend="numpy"))]
        rows = [[getattr(g, f).tolist() for f in (
            "allocs", "pool_allocs", "failed", "local_in_use",
            "pool_in_use")] for g in grids]
        checks[f"spill_{name}"] = rows[0] == rows[1] == rows[2]
        n_spill += 1
    launches = ops.launches - before
    checks["spill_launches_on_card"] = launches == n_spill
    ok = all(checks.values())
    emit("latency_grids_parity_small", ok=ok, checks_count=len(checks),
         failed=[k for k, v in checks.items() if not v],
         spill_kernel_launches=launches)
    if not ok:
        raise SystemExit("latency_grids_parity_small failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def _fig17_inputs():
    """The UM models of Figs 17/18/20's taus fitted once on
    ``POND_BATCH_FULL``'s training VMs, and Fig 17's grid of settings
    calibrated there."""
    inp = _pond_inputs()
    if "um_models" not in inp:
        from repro_torch.core import policy_engine, traces
        train = inp["train"]
        t0 = time.perf_counter()
        inp["um_models"] = policy_engine.fit_um_grid(
            traces.metadata_features(train, inp["hist"]),
            np.array([v.untouched for v in train]), FIG20_TAUS)
        inp["settings"] = policy_engine.make_grid(
            taus=FIG17_FULL["taus"], pdms=(FIG17_FULL["pdm"],),
            fp_targets=FIG17_FULL["fp_targets"], li_model=inp["li"],
            pmu=traces.pmu_matrix(train),
            slowdowns=traces.slowdowns(train, 182))
        inp["um_fitting_s"] = time.perf_counter() - t0
    return inp


def _fig17_pricing(vms_list, grid, settings, cfg, device):
    """Fig 17's pricing as ``benchmarks/fig17_sensitivity.py`` runs it:
    every (setting, trace) cell in one ``savings_analysis_batched``."""
    from repro_torch.core.cluster_sim import savings_analysis_batched
    k = len(vms_list)
    return savings_analysis_batched(
        [v for _ in settings for v in vms_list], cfg, "pond-grid",
        decisions=[grid[s][i] for s in range(len(settings))
                   for i in range(k)], cache={}, device=device)


def _small_figs(dev):
    """Figs 4, 7, 18 and 20's grids at the reference's quick benchmark
    sizes: each grid with a device side on the card ``==`` its numpy
    backend; Fig 7's latency grids and Fig 18's UM curve are host numpy
    (as the reference's), held to their scalar functions."""
    from repro_torch.core import eqn1, latency_engine as le
    from repro_torch.core import latency_model as lm, qos, traces
    from repro_torch.core.predictors.models import LatencySensitivityModel
    inp = _fig17_inputs()
    pop = traces.Population(seed=0)
    checks, t = {}, {}
    # Fig 4: (3 seeds, 2 latencies, 158 workloads) slowdowns
    t0 = time.perf_counter()
    rows = []
    for k, seed in enumerate((9, 10, 11)):
        tb = traces.vm_table(pop.sample_vms(158, 86400, seed=seed,
                                            start_id=(5 + k) * 10 ** 6))
        rows.append(np.stack([tb.slow182, tb.slow222]))
    slow = np.stack(rows)
    bands = le.slowdown_band_grid(slow, device=dev)
    checks["fig4_bands"] = bands.tolist() == le.slowdown_band_grid(
        slow, backend="numpy").tolist() == [[[
            (s < .01).mean(), (s < .05).mean(), (s > .25).mean()]
            for s in row] for row in slow]
    t["fig4"] = time.perf_counter() - t0
    # Fig 7: 2..64 sockets
    sockets = np.arange(2, 65)
    checks["fig7_latency"] = [
        (a, b, c, d) for a, b, c, d in zip(
            le.pond_latency_ns_grid(sockets).tolist(),
            le.switch_only_latency_ns_grid(sockets).tolist(),
            le.added_latency_ns_grid(sockets).tolist(),
            le.latency_increase_pct_grid(sockets).tolist())] == [
        (lm.pond_latency_ns(s), lm.switch_only_latency_ns(s),
         lm.added_latency_ns(s), lm.latency_increase_pct(s))
        for s in sockets.tolist()]
    # Figs 18 and 20: the test trace (2,000 VMs, seed 2), the taus' curve
    t0 = time.perf_counter()
    test = pop.sample_vms(2000, 10 * 86400, seed=2, start_id=10 ** 6)
    xte = traces.metadata_features(test, inp["hist"])
    ut_te = np.array([v.untouched for v in test])
    um_models = inp["um_models"]
    preds = {tau: um_models[tau].predict(xte).astype(np.float64)
             for tau in FIG20_TAUS}
    for name, taus in (("fig18", FIG18_TAUS), ("fig20", FIG20_TAUS)):
        p = np.stack([preds[tau] for tau in taus])
        um, op = le.um_curve_grid(p, ut_te)
        checks[f"{name}_um_curve"] = list(zip(um.tolist(), op.tolist())) \
            == [(float(r.mean()), float((ut_te < r).mean())) for r in p]
    um_curve = list(zip(*(a.tolist() for a in le.um_curve_grid(
        np.stack([preds[tau] for tau in FIG20_TAUS]), ut_te))))
    t["fig18_fig20_curves"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = inp["train"]
    points = {}
    for lat in (182, 222):
        model = inp["li"] if lat == 182 else LatencySensitivityModel(
            pdm=0.05).fit(traces.pmu_matrix(train),
                          traces.slowdowns(train, 222))
        p = model.p_sensitive(traces.pmu_matrix(test))
        sens = qos.exceeds_pdm(traces.slowdowns(test, lat), model.pdm)
        curves = [le.li_curve_grid(p, sens, **kw) for kw in (
            dict(device=dev), dict(backend="numpy"))]
        li_curve = list(zip(curves[0][1].tolist(), curves[0][2].tolist()))
        pts = [le.combine_grid(li_curve, um_curve, [0.02], **kw)[0]
               for kw in (dict(device=dev), dict(backend="numpy"))]
        checks[f"fig20_{lat}"] = (
            [a.tolist() for a in curves[0]] == [a.tolist() for a in curves[1]]
            and dataclasses.astuple(pts[0]) == dataclasses.astuple(pts[1])
            == dataclasses.astuple(eqn1.combine(li_curve, um_curve, 0.02)))
        points[lat] = dataclasses.asdict(pts[0])
    t["fig20_frontier"] = time.perf_counter() - t0
    return checks, dict(fig20_points=points, host_seconds=t,
                        fig4_bands_mean=bands.mean(0).tolist())


def phase_fig_grids_full(dev):
    """The sensitivity and latency grids on the card: Fig 17's policy grid
    at full width (``FIG17_FULL`` on ``POND_BATCH_FULL``'s row: the tau
    axis through ``predict_gbms_torch``, the 27 cells priced through K1's
    trace axis and held to the reference's results), the spill grid of Fig
    16 at full width (``SPILL_FULL``, one K6 launch) held to the numpy
    backend, and Figs 4, 7, 18 and 20's grids at the reference's quick
    sizes."""
    from repro_torch.core import latency_engine as le, policy_engine
    from repro_torch.core import replay_engine, traces
    from repro_torch.core.predictors import gbm as G
    from repro_torch.kernels.event_sweep import ops as k1_ops
    from repro_torch.kernels.spill_sweep import ops as k6_ops
    inp = _fig17_inputs()
    cfg, vms_list, settings = inp["cfg"], inp["vms_list"], inp["settings"]
    li, hist, um_models = inp["li"], inp["hist"], inp["um_models"]
    spill = _spill_full()
    host = dict(sampling=inp["sampling_s"], fitting=inp["fitting_s"],
                um_grid_fitting=inp["um_fitting_s"],
                spill_streams=spill["seconds"])
    checks = {"settings_equal_reference": [
        dataclasses.astuple(s) for s in settings] == FIG17_SETTINGS_WANT}

    # the main path: Fig 17's grid (decisions, then the 27 cells priced on
    # the card) and Fig 16's spill grid, the launch counts set to 0 just
    # before and read just after
    replay_engine.stats_reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k1_ops.launches = 0
    k6_ops.launches = k6_ops.link_launches = 0
    t0 = time.perf_counter()
    grid = policy_engine.grid_decisions(vms_list, settings, li, um_models,
                                        hist, backend="numpy")
    host["grid_decisions_numpy"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = _fig17_pricing(vms_list, grid, settings, cfg, None)
    torch.cuda.synchronize()
    host["pricing_wall"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sg = le.spill_grid(spill["kinds"], spill["keys"], spill["nl"],
                       spill["npl"], backend="torch")
    host["spill_grid_wall"] = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    k1_launches, k6_launches = k1_ops.launches, k6_ops.launches
    k6_link_launches = k6_ops.link_launches
    peak = torch.cuda.max_memory_allocated()
    stats = replay_engine.stats_snapshot()
    times = replay_engine.stage_times()
    host.update(compile_and_upload=times.compile_s,
                device_sweeps=times.sweep_s,
                pricing_other=host["pricing_wall"] - times.compile_s
                - times.sweep_s - times.decisions_s)

    # the torch backend's decisions on the card: its tau predictions
    # against numpy's, and how many floored decisions differ
    t1 = time.perf_counter()
    grid_t = policy_engine.grid_decisions(vms_list, settings, li, um_models,
                                          hist, backend="torch")
    host["grid_decisions_torch"] = time.perf_counter() - t1
    tables = [traces.vm_table(v) for v in vms_list]
    feats = np.concatenate([policy_engine.metadata_features_compiled(
        tb, policy_engine._prefix_percentiles(tb.customer, tb.untouched,
                                              hist)[1]) for tb in tables])
    taus = sorted(FIG17_FULL["taus"])
    raw = G.predict_gbms_torch(G.pack_gbms([um_models[t].gbm for t in taus]),
                               feats, dev).cpu().numpy()
    pred_diff = max(float(np.abs(np.clip(raw[i], 0, 1)
                                 - um_models[t].predict(feats)).max())
                    for i, t in enumerate(taus))
    differ = []
    for si, (row, row_t) in enumerate(zip(grid, grid_t)):
        for k, (a, b) in enumerate(zip(row, row_t)):
            bad = np.flatnonzero((a.pool_gb != b.pool_gb)
                                 | (a.fully_pooled != b.fully_pooled))
            differ += [dict(setting=si, trace=k, vm=int(i),
                            pool_gb_numpy=float(a.pool_gb[i]),
                            pool_gb_torch=float(b.pool_gb[i])) for i in bad]

    # Fig 16's spill grid: the card == the numpy backend, every lane
    t1 = time.perf_counter()
    sg_np = le.spill_grid(spill["kinds"], spill["keys"], spill["nl"],
                          spill["npl"], backend="numpy")
    host["spill_grid_numpy"] = time.perf_counter() - t1
    fields = ("allocs", "pool_allocs", "failed", "local_in_use",
              "pool_in_use")
    checks["spill_equals_numpy"] = all(
        np.array_equal(getattr(sg, f), getattr(sg_np, f)) for f in fields)
    fracs = sg.spill_fraction.mean(0)

    small_checks, small = _small_figs(dev)
    checks |= small_checks
    got = [dataclasses.asdict(r) for r in res]
    checks |= {
        "fig17_results_equal_reference": got == FIG17_WANT,
        "fig17_mispredictions_and_mitigations_are_the_grids": [
            (r.mispredictions, r.mitigations) for r in res] == [
            (grid[s][k].mispredictions, grid[s][k].n_mitigations)
            for s in range(len(settings)) for k in range(len(vms_list))],
        "k1_launches_equal_sweeps": k1_launches == stats["sweeps"] > 0,
        "k6_launched": k6_launches == 1,
        "k6_links_launched": k6_link_launches == 1,
        "no_trajectories": times.trajectory_s == 0.0,
    }
    lanes = [n for n, _ in times.sweeps]
    summary = {}
    for si, s in enumerate(settings):
        rows = res[si * len(vms_list):(si + 1) * len(vms_list)]
        sv = np.array([r.savings for r in rows])
        summary[s.label] = dict(savings_mean=float(sv.mean()),
                                savings_std=float(sv.std()))
    emit("fig_grids_full", ok=all(checks.values()), checks=checks,
         config=dict(FIG17_FULL, seeds=POND_BATCH_FULL["seeds"],
                     n_servers=cfg.n_servers, days=PROV_FULL["days"],
                     settings=[dataclasses.astuple(s) for s in settings],
                     spill=SPILL_FULL),
         fig17_results=got, fig17_savings=summary,
         torch_backend=dict(max_abs_tau_prediction_diff=pred_diff,
                            floored_decisions_differing=len(differ),
                            differing=differ[:20],
                            cells=len(settings) * len(vms_list),
                            vms=sum(len(v) for v in vms_list)),
         spill=dict(streams=len(spill["streams"]),
                    events=[len(k) for k, _ in spill["streams"]],
                    keys=spill["n_keys"], peaks=spill["peaks"],
                    lanes=len(spill["nl"]),
                    spill_fraction_mean=fracs[::8].tolist(),
                    failed=int(sg.failed.sum())),
         small_figs=small,
         k1_launches=k1_launches, k6_launches=k6_launches,
         k6_link_launches=k6_link_launches, sweeps=len(lanes), sweep_lanes=lanes,
         sweep_state_dtypes=[d for _, d in times.sweeps],
         engine_stats=stats, host_seconds=host, wall_seconds=wall,
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_path_bytes=peak - held)
    if differ:
        print(f"fig_grids_full: {len(differ)} floored torch-backend "
              f"decisions differ from numpy's: {differ[:20]}", flush=True)
    if not all(checks.values()):
        raise SystemExit("fig_grids_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return k1_launches, (k6_launches, k6_link_launches)


# ------------------------------------------ the failure layer (K5, M10) --
_AVAIL = {}


def _avail_inputs():
    """``AVAIL_FULL``'s cluster, trace (``PROV_FULL``'s), static 0.25
    decisions, schedules and candidates, made once."""
    if not _AVAIL:
        from repro_torch.core import cluster_sim
        from repro_torch.runtime.fault import FailureSchedule
        cfg, vms, _ = _full_trace()
        horizon = PROV_FULL["days"] * 86400
        dec, _ = cluster_sim.policy_decisions(
            vms, "static", static_pool_frac=AVAIL_FULL["static_pool_frac"],
            as_arrays=True)
        scheds = [FailureSchedule.generate(horizon, cfg.n_groups,
                                           m * 3600.0, AVAIL_FULL["repair_s"],
                                           seed=i)
                  for i, m in enumerate(AVAIL_FULL["mtbf_h"])]
        full_gb = cfg.gb_per_core * cfg.cores_per_server
        server = np.round(full_gb * np.asarray(AVAIL_FULL["dram_fracs"]))
        _AVAIL.update(cfg=cfg, vms=vms, dec=dec, scheds=scheds,
                      server=server)
    return _AVAIL


def _k5_inputs(ev, n_slots, n_servers, spg, cores, sgb, pgb, state_dtype,
               dev):
    """K5's arguments on ``dev``: the eight event arrays, group_of and the
    all-free state with all domains up for lanes (sgb, pgb)."""
    from repro_torch.core import sweep_core
    from repro_torch.kernels.fail_sweep.cases import FAIL_EVENT_KEYS
    np_dt = sweep_core.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    st = sweep_core.init_state(len(sgb), n_servers, cores, n_servers,
                               n_groups, n_slots, np_dt)[:4]
    st += (sweep_core.init_fail_state(len(sgb), n_groups),
           np.asarray(sgb).astype(np_dt), np.asarray(pgb).astype(np_dt))
    events = tuple(torch.from_numpy(np.ascontiguousarray(ev[k], np.int32))
                   .to(dev) for k in FAIL_EVENT_KEYS)
    group_of = torch.from_numpy(
        (np.arange(n_servers) // spg).astype(np.int32)).to(dev)
    return events, group_of, tuple(torch.from_numpy(a).to(dev) for a in st)


def _k5_run(kernel, events, group_of, state, mitigation, n_dist=0,
            trace_events=None, slot_column=None, **plan_kw):
    """K5 (``kernel``, its plan's choices forced by ``slot_column`` and
    ``plan_kw``: ``warps``) or its plain version on a
    copy of ``state``: [fc, um, up, slots, down, counters, per-FAIL rows or
    None]."""
    from repro_torch.kernels.event_sweep.ops import trace_layout
    from repro_torch.kernels.fail_sweep import ops
    from repro_torch.kernels.fail_sweep.ref import fail_sweep_ref
    st = [t.clone() for t in state]
    dev = st[0].device
    out = torch.zeros((5, st[0].shape[0]), dtype=torch.int32, device=dev)
    dist = (torch.zeros((n_dist, st[0].shape[0]), dtype=torch.int32,
                        device=dev) if n_dist else None)
    if kernel:
        ops.fail_sweep(*events, group_of, *st, out, mitigation=mitigation,
                       dist=dist, trace_events=trace_events,
                       slot_column=slot_column, **plan_kw)
    else:
        starts, counts = trace_layout(trace_events, events[0].shape[0],
                                      st[0].shape[0])
        fail_sweep_ref(*events, group_of, *st, out, dist,
                       remigrate=mitigation == "remigrate",
                       trace_starts=starts, trace_counts=counts)
    torch.cuda.synchronize()
    return st[:5] + [out, dist]


def _k5_cases():
    """(name, events, n_slots, servers, servers a group, cores, sgb, pgb,
    state types) of every K5 check but the trace axis's."""
    from repro_torch.kernels.fail_sweep import cases
    rng = np.random.default_rng(19)
    runs = []
    for name, (ev, n_slots), shape, lanes, dts in (
            ("edges", cases.edge_stream(), cases.EDGE_SHAPE,
             cases.EDGE_LANES, ("int16", "int32")),
            ("demand_past_int16", cases.demand_stream(), cases.DEMAND_SHAPE,
             cases.DEMAND_LANES, ("int16",)),
            ("refail", cases.refail_stream(), cases.EDGE_SHAPE,
             cases.REFAIL_LANES, ("int16", "int32")),
            ("late_minutes", cases.late_stream(), cases.DEMAND_SHAPE,
             cases.LATE_LANES, ("int16", "int32"))):
        lanes = np.asarray(lanes)
        runs.append((name, ev, n_slots, shape["n_servers"], shape["spg"],
                     shape["cores"], lanes[:, 0], lanes[:, 1], dts))
    # 4 and 8 servers (not multiples of 32), 33 (two a thread), one lane,
    # 300 lanes (three a block), 256 servers (the full row's K 8), 500
    # servers at K 16 with 250 groups
    for s, spg, n_lanes, n_vms in ((4, 2, 5, 200), (8, 4, 12, 200),
                                   (33, 8, 9, 300), (7, 4, 1, 200),
                                   (64, 8, 300, 300), (256, 8, 16, 900),
                                   (500, 2, 16, 900)):
        ev, n_slots = cases.random_fail_stream(rng, n_vms, -(-s // spg))
        sgb, pgb = cases.lane_capacities(rng, n_lanes, s, 64)
        runs.append((f"S{s}_lanes{n_lanes}", ev, n_slots, s, spg, 64, sgb,
                     pgb, ("int16", "int32")))
    return runs


def _k5_forced(n_lanes, n_servers, n_slots, state_dtype, dev, n_traces=1):
    """The plan's choices a K5 check runs with: its own, then each forced —
    the columns in global memory, one warp a lane, the most warps a lane
    its block takes."""
    from repro_torch.kernels.fail_sweep import kernel as K5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    item = 2 if state_dtype == "int16" else 4
    lanes = K5.plan(n_lanes, n_servers, n_slots, item, sms,
                    n_traces).lanes_per_block
    return [{}, dict(slot_column="global"), dict(warps=1),
            dict(warps=K5.MAX_WARPS_PER_BLOCK // lanes)]


def _k5_checks(dev):
    """K5 against its plain version on the card, ``==`` on the counters,
    the per-FAIL rows and the whole final state: every case of
    ``_k5_cases`` in its state types, both mitigations, with per-FAIL rows
    and without, the plan's own choices and each forced (``_k5_forced``:
    the slot and payload columns in global memory, one warp a lane, the
    most warps a lane); then the
    trace axis (three streams whose schedules differ in length, 5 lanes a
    trace).  Returns (checked, max_abs_err)."""
    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep.ops import pack_traces
    from repro_torch.kernels.fail_sweep import cases, ops
    from repro_torch.kernels.fail_sweep.cases import FAIL_EVENT_KEYS
    checked, max_err = [], 0

    def compare(name, got, want):
        nonlocal max_err
        for a, b in zip(got, want):
            if a is None:
                continue
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
        if not all(a is b or torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"fail_sweep {name}: the kernel's counters, "
                             "rows or final state differ from its plain "
                             "version's")

    for name, ev, n_slots, s, spg, cores, sgb, pgb, dts in _k5_cases():
        n_fail = int((ev["kind"] == sweep_core.FAIL).sum())
        for dt in dts:
            events, group_of, state = _k5_inputs(ev, n_slots, s, spg, cores,
                                                 sgb, pgb, dt, dev)
            for mit in ("remigrate", "kill"):
                want = _k5_run(False, events, group_of, state, mit, n_fail)
                for n_dist, kw in ((0, {}),) + tuple(
                        (n_fail, kw) for kw in _k5_forced(
                            len(sgb), s, n_slots, dt, dev)):
                    got = _k5_run(True, events, group_of, state, mit, n_dist,
                                  **kw)
                    ref = want if n_dist else want[:6] + [None]
                    tag = f"{name} {dt} {mit} {ops.last_plan}"
                    compare(tag, got, ref)
                    checked.append(dict(
                        case=name, state_dtype=dt, mitigation=mit,
                        rows=bool(n_dist), plan=dataclasses.asdict(
                            ops.last_plan), servers=s, lanes=len(sgb),
                        events=len(ev["kind"]), failures=n_fail,
                        affected=int(want[5][1].sum()),
                        killed=int(want[5][2].sum())))
    # the trace axis: three streams, schedules of other lengths
    rng = np.random.default_rng(23)
    streams = [cases.random_fail_stream(rng, n, 2, mtbf_frac=f)
               for n, f in ((220, 0.1), (150, 0.3), (260, 0.05))]
    cols, counts = pack_traces([tuple(ev[k] for k in FAIL_EVENT_KEYS)
                                for ev, _ in streams], dev,
                               fills=(sweep_core.PAD,) + (0,) * 6 + (-1,))
    n_slots = max(n for _, n in streams)
    sgb, pgb = cases.lane_capacities(rng, 5, 8, 64)
    for dt in ("int16", "int32"):
        _, group_of, state = _k5_inputs(streams[0][0], n_slots, 8, 4, 64,
                                        np.tile(sgb, 3), np.tile(pgb, 3), dt,
                                        dev)
        for mit in ("remigrate", "kill"):
            want = _k5_run(False, cols, group_of, state, mit,
                           trace_events=counts)
            for kw in _k5_forced(5, 8, n_slots, dt, dev, 3):
                got = _k5_run(True, cols, group_of, state, mit,
                              trace_events=counts, **kw)
                compare(f"trace axis {dt} {mit} {kw}", got, want)
                checked.append(dict(case="trace_axis_3", state_dtype=dt,
                                    mitigation=mit, plan=dataclasses.asdict(
                                        ops.last_plan), trace_events=counts,
                                    affected=int(want[5][1].sum())))
    return checked, max_err


def _k5_timed(evs, group_of, n_servers, n_groups, cores, n_slots, sgb_i,
              pgb_i, np_dt, mitigation, rows, counts, clock_mhz, reps=5,
              **plan_kw):
    """K5's kernel function itself (no wrapper checks) over ``evs``: one
    trace, or the trace axis as ``ops.pack_traces`` lays it out, with
    ``counts`` the traces' event counts, and the lanes (sgb_i, pgb_i) in
    each trace; ``rows`` per-FAIL rows (one trace); ``plan_kw`` forces the
    plan's warps a lane.  One warm-up, then ``reps`` runs on fresh state
    timed by ``_card_ms``.  Returns dict(ms, plan, the warm-up's counters
    summed over the lanes, the rows' SHA-1 where there are rows)."""
    import hashlib

    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep.ops import trace_starts
    from repro_torch.kernels.fail_sweep import kernel as K5
    dev = group_of.device
    k, width = len(counts), len(counts) * len(sgb_i)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = K5.plan(len(sgb_i), n_servers, n_slots,
                   np.dtype(np_dt).itemsize, sms, k, **plan_kw)
    st = sweep_core.init_state(width, n_servers, cores, n_servers, n_groups,
                               n_slots, np_dt)[:4]
    st += (sweep_core.init_fail_state(width, n_groups),
           np.tile(sgb_i, k).astype(np_dt), np.tile(pgb_i, k).astype(np_dt))
    states = [[torch.from_numpy(a.copy()).to(dev) for a in st]
              for _ in range(reps + 1)]
    outs = [torch.zeros((5, width), dtype=torch.int32, device=dev)
            for _ in range(reps + 1)]
    dist = (torch.zeros((rows, width), dtype=torch.int32, device=dev)
            if rows else None)
    starts = trace_starts(counts)

    def run(i):
        K5.fail_sweep_kernel(evs, group_of, *states[i], outs[i], dist,
                             remigrate=mitigation == "remigrate",
                             plan=plan, trace_starts=starts,
                             trace_counts=counts)
    run(0)
    torch.cuda.synchronize()
    res = dict(counters=outs[0].sum(1).tolist(),
               plan=dataclasses.asdict(plan))
    if rows:
        res["rows_sha1"] = hashlib.sha1(
            dist.cpu().numpy().tobytes()).hexdigest()
    res["ms"] = _card_ms([lambda i=i: run(i) for i in range(1, reps + 1)],
                         clock_mhz, "fail_sweep")
    return res


def _no_failures(evs):
    """The eight event arrays with every FAIL and RECOVER made a PAD."""
    from repro_torch.core import sweep_core
    kind = evs[0].clone()
    kind[(kind == sweep_core.FAIL) | (kind == sweep_core.RECOVER)] = \
        sweep_core.PAD
    return (kind, *evs[1:])



def phase_kernels_fail(dev):
    """K5 against its plain version on the card (``_k5_checks``, and
    2,048-event cuts at the main path's shapes); at full width
    (``AVAIL_FULL``'s streams) its time a sweep by ``_k5_timed`` — one
    trace (MTBF 24 h, and 2 h), 6 lanes, each mitigation, and the batched
    launch of the four schedules x 6 lanes — beside K1 on the same streams
    (FAIL and RECOVER no-ops there: the failure model's cost) and the
    bound; the plain version on a cut; registers and spills from the build
    log."""
    from repro_torch.core import sweep_core
    from repro_torch.core.replay_engine import CompiledReplay
    from repro_torch.core.replay_engine import CompiledReplayBatch
    from repro_torch.kernels import build
    from repro_torch.kernels.event_sweep import ops as k1_ops
    from repro_torch.kernels.fail_sweep import kernel as K5
    from repro_torch.kernels.fail_sweep import ops
    checked, max_err = _k5_checks(dev)

    inp = _avail_inputs()
    cfg = inp["cfg"]
    engines = [CompiledReplay(inp["vms"], inp["dec"], cfg,
                              failure_schedule=s, device=dev)
               for s in inp["scheds"]]
    n_cand = len(inp["server"])
    pool = np.full(n_cand, np.ceil(engines[0].peak_pool_demand()))
    sgb_i, pgb_i = sweep_core.quantize_capacities(inp["server"], pool)
    dt = engines[0]._pick_state_dtype(sgb_i, pgb_i)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    n_srv, n_grp = cfg.n_servers, cfg.n_groups
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(_smi("clocks.max.sm"))
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6

    def fresh(width, n_slots, k=1):
        st = sweep_core.init_state(width, n_srv, cfg.cores_per_server,
                                   n_srv, n_grp, n_slots, np_dt)[:4]
        st += (sweep_core.init_fail_state(width, n_grp),
               np.tile(sgb_i, k).astype(np_dt),
               np.tile(pgb_i, k).astype(np_dt))
        return [torch.from_numpy(a).to(dev) for a in st]

    def bound(lanes, n_arrive, n_fail, n_events, n_slots, width=None):
        # lanes a trace against the traces' summed arrivals and failures;
        # the state of all ``width`` lanes
        width = width or lanes
        ops_ = (K1_OPS_PER_ARRIVE_SERVER * n_arrive * lanes * n_srv
                + K5_OPS_PER_FAIL_SLOT_LANE * n_fail * n_slots * lanes)
        state = ((2 * width * n_srv + width * n_grp + n_slots * width) * item
                 + 4 * width * n_grp)
        nbytes = (32 * n_events + 4 * n_srv + 2 * state + 2 * width * item
                  + 20 * width + 4 * n_fail * width)
        t_ops = ops_ / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    int32_ops=ops_, bytes=nbytes)

    def timed(evs, group_of, n_slots, mit, rows, counts, **plan_kw):
        return _k5_timed(evs, group_of, n_srv, n_grp, cfg.cores_per_server,
                         n_slots, sgb_i, pgb_i, np_dt, mit, rows, counts,
                         clock_mhz, **plan_kw)

    timings, split = {}, {}
    for e_i, mtbf in ((2, 24), (0, 2)):
        eng = engines[e_i]
        evs, group_of, n_slots = eng._device_events_fail()
        n_ev = eng.n_events
        n_arrive = int((evs[0] == sweep_core.ARRIVE).sum())
        n_fail = eng.failure_schedule.n_failures
        for mit in ("remigrate", "kill"):
            t = timed(evs, group_of, n_slots, mit, n_fail, [n_ev])
            timings[f"mtbf{mtbf}h_{mit}"] = dict(
                ms=t["ms"], ns_per_event=t["ms"] * 1e6 / n_ev, events=n_ev,
                arrivals=n_arrive, failures=n_fail, lanes=n_cand,
                n_slots=n_slots, state_dtype=dt, plan=t["plan"],
                **bound(n_cand, n_arrive, n_fail, n_ev, n_slots))
        # the split: K5 on a copy of the stream with FAIL and RECOVER made
        # PAD (its walk of the other events) against K1 on the same stream,
        # and what a FAIL then costs a lane
        nofail = timed(_no_failures(evs), group_of, n_slots, "remigrate", 0,
                       [n_ev])["ms"]
        timings[f"mtbf{mtbf}h_no_failures"] = dict(ms=nofail)
        split[f"mtbf{mtbf}h"] = dict(
            no_failures_ms=nofail, failures=n_fail, **{
                f"us_a_fail_{mit}": (timings[f"mtbf{mtbf}h_{mit}"]["ms"]
                                     - nofail) * 1e3 / n_fail
                for mit in ("remigrate", "kill")})
        # K1 through its wrapper on the same stream's first six arrays
        k1_states = []
        for _ in range(6):
            fc, um, up, slots, _, sgb, pgb = fresh(n_cand, n_slots)
            k1_states.append((fc, um, up, slots, sgb, pgb))

        def k1_run(i):
            k1_ops.event_sweep(*evs[:6], group_of, *k1_states[i])
        k1_run(0)
        k1_ms = _card_ms([lambda i=i: k1_run(i) for i in range(1, 6)],
                         clock_mhz, "event_sweep")
        timings[f"mtbf{mtbf}h_k1"] = dict(
            ms=k1_ms, plan=dataclasses.asdict(k1_ops.last_plan),
            k5_over_k1=timings[f"mtbf{mtbf}h_remigrate"]["ms"] / k1_ms)
        split[f"mtbf{mtbf}h"].update(
            k1_ms=k1_ms, no_failures_over_k1=nofail / k1_ms)
    # the batched launch of the four schedules, as availability_full's
    batch = CompiledReplayBatch(engines)
    cols, group_of, n_slots_b, counts = batch._device_events_fail()
    n_arrive = sum(int((e._device_events()[0][0] == sweep_core.ARRIVE)
                       .sum()) for e in engines)
    n_fail_all = sum(s.n_failures for s in inp["scheds"])
    width = len(engines) * n_cand
    for mit in ("remigrate", "kill"):
        t = timed(cols, group_of, n_slots_b, mit, 0, counts)
        timings[f"batch4x{n_cand}_{mit}"] = dict(
            ms=t["ms"], plan=t["plan"], trace_events=counts,
            **bound(n_cand, n_arrive, n_fail_all, sum(counts), n_slots_b,
                    width))
    nofail = timed(_no_failures(cols), group_of, n_slots_b, "remigrate", 0,
                   counts)["ms"]
    timings[f"batch4x{n_cand}_no_failures"] = dict(ms=nofail)
    split[f"batch4x{n_cand}"] = dict(no_failures_ms=nofail, **{
        f"us_a_fail_of_the_longest_{mit}":
            (timings[f"batch4x{n_cand}_{mit}"]["ms"] - nofail) * 1e3
            / max(s.n_failures for s in inp["scheds"])
        for mit in ("remigrate", "kill")})
    # the main path's three launches (availability_full) and their bounds
    main_path = [dict(launch=key, ms=timings[key]["ms"],
                      bound_ms=timings[key]["bound_ms"],
                      bound_by=timings[key]["bound_by"],
                      share_of_bound=timings[key]["bound_ms"]
                      / timings[key]["ms"])
                 for key in (f"batch4x{n_cand}_remigrate",
                             f"batch4x{n_cand}_kill", "mtbf24h_remigrate")]
    emit("kernels_fail_split", split=split, main_path=main_path)

    # the kernel through its wrapper against its plain version, == on the
    # counters, the per-FAIL rows and the whole final state, on 2,048-event
    # cuts at the main path's shapes (256 servers, 32 domains, its slot
    # columns, 6 lanes a trace): the single-trace call's stream (MTBF 24 h,
    # with rows) and the four streams packed as the batched launch (4 x 6
    # lanes), both mitigations, the plan's choices (at these shapes: the
    # columns in shared memory, several warps a lane) and each forced: the
    # columns in global memory, one warp a lane
    cut = 2048
    evs, group_of, n_slots = engines[2]._device_events_fail()
    ev_c = tuple(e[:cut].contiguous() for e in evs)
    n_fail_cut = int((ev_c[0] == sweep_core.FAIL).sum())
    cols_c, counts_c = k1_ops.pack_traces(
        [tuple(e[:cut].cpu().numpy() for e in eng._device_events_fail()[0])
         for eng in engines], dev, fills=(sweep_core.PAD,) + (0,) * 6 + (-1,))
    cut_checks, plain_cut_ms = [], None
    for name, evs_c, n_sl, k, rows, tr in (
            ("cut_mtbf24h", ev_c, n_slots, 1, n_fail_cut, None),
            ("cut_batch4x6", cols_c, n_slots_b, len(engines), 0, counts_c)):
        st = fresh(k * n_cand, n_sl, k)
        for mit in ("remigrate", "kill"):
            t0 = time.perf_counter()
            want = _k5_run(False, evs_c, group_of, st, mit, rows,
                           trace_events=tr)
            if plain_cut_ms is None:
                plain_cut_ms = (time.perf_counter() - t0) * 1e3
            for kw in ({}, dict(slot_column="global"), dict(warps=1)):
                got = _k5_run(True, evs_c, group_of, st, mit, rows,
                              trace_events=tr, **kw)
                for a, b in zip(got, want):
                    if a is not None:
                        max_err = max(max_err,
                                      int((a.long() - b.long()).abs().max()))
                if not all(a is b or torch.equal(a, b)
                           for a, b in zip(got, want)):
                    raise SystemExit(
                        f"fail_sweep {name} {mit} {ops.last_plan}: the "
                        "kernel's counters, rows or final state differ from "
                        "its plain version's")
                cut_checks.append(dict(
                    case=name, mitigation=mit, rows=bool(rows),
                    plan=dataclasses.asdict(ops.last_plan), lanes=k * n_cand,
                    trace_events=tr or [cut], failures=int(
                        (evs_c[0] == sweep_core.FAIL).sum()),
                    affected=int(want[5][1].sum()),
                    killed=int(want[5][2].sum()),
                    remigrated=int(want[5][3].sum())))
    if not all(c["affected"] > 0 for c in cut_checks):
        raise SystemExit("fail_sweep: a cut affected no VM, so its check "
                         "held nothing of the blast radius")
    cut_ms = timed(ev_c, group_of, n_slots, "remigrate", n_fail_cut,
                   [cut])["ms"]
    with open(f"{build.library_path(K5.NAME)}.log") as f:
        report = K5.ptxas_report(f.read())
    # registers, stack and spills of every instantiation, one row each
    emit("kernels_fail_codegen", columns=[
        "state", "K", "batched", "columns", "registers", "stack_bytes",
        "spill_store_bytes", "spill_load_bytes"], rows=[
        [r.get("state_dtype"), r.get("servers_per_thread"), r.get("batched"), r.get("slot_column"),
         r.get("registers"), r.get("stack_bytes"),
         r.get("spill_store_bytes"), r.get("spill_load_bytes")]
        for r in report])
    main = timings["mtbf24h_remigrate"]
    record = dict(
        name=K5.NAME, route="cuda", source=K5.SOURCE,
        replaces="src/repro/core/sweep_core.py:333",
        max_abs_err=max_err, tolerance="== (integer state, exact)",
        cases_checked=len(checked) + len(cut_checks), cases=checked,
        cut_checks=cut_checks,
        design="K1's registers design (one warp a lane, K = S/32 servers "
               "a thread in registers, redux.sync first minimum, "
               "predicated updates, 2-stage cp.async tiles of all eight "
               "event arrays, the slot column in shared memory by thread "
               "0, global past its limit); a payload column a lane (cores, "
               "local, pool, departure minute a slot, int32, one int4 store "
               "by thread 0 at ARRIVE); at FAIL "
               "two strides over the slot column reading the payload from "
               "shared memory (int32 per-server demand by shared atomics, "
               "the owners' fits flags, the second stride applying kill or "
               "remigrate), shared by W warps of the lane's block where "
               "every lane has a block (named barriers); down flags a "
               "K-bit mask a thread",
        split=split, main_path=main_path,
        ms=main["ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        timed_shape=dict(events=main["events"], failures=main["failures"],
                         servers=n_srv, groups=n_grp,
                         n_slots=main["n_slots"], lanes=n_cand,
                         state_dtype=dt, per_failure_rows=True,
                         mitigation="remigrate"),
        timings=timings, ptxas=report,
        no_stack_or_spills=all(r.get("stack_bytes") == 0
                               and r.get("spill_store_bytes") == 0
                               for r in report),
        plain_ms=plain_cut_ms, plain_cut_events=cut,
        plain_cut_failures=n_fail_cut, ms_at_plain_cut=cut_ms,
        plain_note="the plain version (a Python loop of tensor ops an "
                   "event) at a 2,048-event cut of the MTBF 24 h stream, 6 "
                   "lanes, remigrate, with rows, one run by the host clock; "
                   "ms_at_plain_cut is the kernel on the same cut",
        timing_note=f"CUDA events around 5 launches of the kernel function "
                    f"(no wrapper checks) on fresh state, enqueued behind a "
                    f"{CARD_WAIT_MS} ms wait on the card; K1 through its "
                    f"wrapper on the same streams' first six arrays, the "
                    f"same way",
        int32_rate_ops_per_s=int32_rate, sm_clock_max_mhz=clock_mhz,
        library_ms=None,
        library_note="no PyTorch call computes a sequential per-lane "
                     "allocator with a blast radius")
    emit("kernels_fail", kernels=[record])
    return record


def _avail_fields(res):
    """An AvailabilityResult's counters as lists."""
    return {f: np.asarray(getattr(res, f)).tolist() for f in
            ("affected", "killed", "remigrated", "lost_vm_minutes")}


def phase_availability_parity_small(dev):
    """tests/test_failures.py's world (8 servers, 4 GB a core, 1 day,
    static 0.25, MTBF 4 h) on the card (K5) and on the CPU (its plain
    version): seeds 3, 4, 5 single-trace with per-failure rows, and the
    batch of seeds 3, 4, both mitigations, equal results."""
    from repro_torch.core import cluster_sim, replay_engine, traces
    from repro_torch.kernels.fail_sweep import ops
    from repro_torch.runtime.fault import FailureSchedule
    cfg = cluster_sim.ClusterConfig(n_servers=8, pool_sockets=8,
                                    gb_per_core=4.0)
    horizon = 86400
    server = np.array([768.0, 200.0, 96.0])
    pool = np.array([512.0, 300.0, 64.0])
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    worlds = []
    for seed in (3, 4, 5):
        vms = traces.Population(seed=0).sample_vms(n, horizon, seed=seed,
                                                   start_id=10 ** 6)
        dec, _ = cluster_sim.policy_decisions(vms, "static",
                                              static_pool_frac=0.25)
        worlds.append((vms, dec, FailureSchedule.generate(
            horizon, cfg.n_groups, 4 * 3600.0, 1800.0, seed=seed)))
    out = {}
    for d in (dev, "cpu"):
        before = ops.launches
        got = []
        for mit in ("remigrate", "kill"):
            engines = [replay_engine.CompiledReplay(v, dc, cfg,
                                                    failure_schedule=s,
                                                    device=d)
                       for v, dc, s in worlds]
            for e in engines:
                r = e.availability(server, pool, mit)
                got.append(dict(rates=r.reject_rate.tolist(),
                                rows=r.affected_per_failure.tolist(),
                                **_avail_fields(r)))
            r = replay_engine.CompiledReplayBatch(engines[:2]).availability(
                server, pool, mit)
            got.append(dict(rates=r.reject_rate.tolist(),
                            **_avail_fields(r)))
        out[str(d)] = (got, ops.launches - before)
    (g, g_n), (c, c_n) = out[str(dev)], out["cpu"]
    checks = {"results_equal": g == c, "launches_on_card": g_n == 8,
              "none_on_cpu": c_n == 0,
              "failures_bite": sum(int(np.sum(x["affected"]))
                                   for x in g) > 0}
    emit("availability_parity_small", ok=all(checks.values()),
         checks=checks, servers=8, vms=n, kernel_launches=g_n,
         results=g[:4])
    if not all(checks.values()):
        raise SystemExit(f"availability_parity_small failed: {checks}")


def _availability_path(inp, device):
    """The failure layer as a user calls it: four engines (one schedule
    each), the batch priced for each mitigation, and one single-trace
    call with per-failure rows (MTBF 24 h, remigrate).  Returns
    ({mitigation: batch result}, the single result, the engines)."""
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch)
    engines = [CompiledReplay(inp["vms"], inp["dec"], inp["cfg"],
                              failure_schedule=s, device=device)
               for s in inp["scheds"]]
    pool = np.full_like(inp["server"],
                        np.ceil(engines[0].peak_pool_demand()))
    batch = CompiledReplayBatch(engines)
    res = {mit: batch.availability(inp["server"], pool, mit)
           for mit in ("remigrate", "kill")}
    single = engines[AVAIL_FULL["mtbf_h"].index(AVAIL_FULL[
        "single_mtbf_h"])].availability(inp["server"], pool, "remigrate",
                                        per_failure=True)
    return res, single, engines, pool


def phase_availability_full(dev):
    """Pond's failure layer at full width (``AVAIL_FULL``, Fig
    availability's frontier on the PROV_FULL row): the 4 x 6 frontier in
    one ``CompiledReplayBatch.availability`` per mitigation and one
    single-trace ``availability`` with per-failure rows, 3 K5 launches;
    every counter held to the reference's (hard-coded), the 0.5 fraction
    at MTBF 2 h against the port's scalar oracle, fig_availability's four
    claims."""
    import hashlib

    from repro_torch.core import cluster_sim, replay_engine
    from repro_torch.kernels.fail_sweep import ops
    inp = _avail_inputs()
    cfg, n_vms = inp["cfg"], len(inp["vms"])
    replay_engine.stats_reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this one
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    res, single, engines, pool = _availability_path(inp, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    peak = torch.cuda.max_memory_allocated()
    stats = replay_engine.stats_snapshot()
    times = replay_engine.stage_times()
    # the 0.5 fraction at MTBF 2 h, both mitigations, by the port's scalar
    # oracle on the host
    t1 = time.perf_counter()
    oracle = {mit: cluster_sim.replay_with_failures(
        inp["vms"], inp["dec"].as_vmdecisions(), cfg,
        float(inp["server"][-1]), float(pool[-1]), inp["scheds"][0], mit)
        for mit in ("remigrate", "kill")}
    oracle_s = time.perf_counter() - t1
    # the same path again under the tracer, for the device's busy time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _availability_path(inp, None)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6
    got = {mit: dict(rejects=np.rint(r.reject_rate * n_vms).astype(int)
                     .tolist(), **_avail_fields(r))
           for mit, r in res.items()}
    rates_exact = all(
        np.array_equal(r.reject_rate,
                       np.asarray(AVAIL_FULL_WANT[mit]["rejects"]) / n_vms)
        for mit, r in res.items())
    rows = single.affected_per_failure.astype(np.int32)
    single_got = dict(shape=list(rows.shape),
                      sha1=hashlib.sha1(rows.tobytes()).hexdigest(),
                      affected=single.affected.tolist(),
                      max=int(rows.max()))
    o_rem, o_kill = oracle["remigrate"], oracle["kill"]
    lane = [(o.rejects, o.affected, o.killed, o.remigrated,
             o.lost_vm_minutes) for o in (o_rem, o_kill)]
    card = [(got[m]["rejects"][0][-1], got[m]["affected"][0][-1],
             got[m]["killed"][0][-1], got[m]["remigrated"][0][-1],
             got[m]["lost_vm_minutes"][0][-1]) for m in ("remigrate",
                                                          "kill")]
    rem, kill = res["remigrate"], res["kill"]
    success = rem.remigration_success_rate
    claims = {
        "failure sweep bit-exact vs scalar oracle": card == lane,
        "more frequent failures affect more VMs (kill)":
            bool(kill.affected[0, 0] >= kill.affected[-1, 0]),
        "remigration recovers VM-minutes vs kill at full DRAM":
            bool((rem.lost_vm_minutes[:, 0]
                  <= kill.lost_vm_minutes[:, 0]).all()),
        "DRAM savings erode remigration headroom":
            bool((success[:, -1] <= success[:, 0] + 1e-9).all()),
    }
    checks = {
        "remigrate_equals_reference": got["remigrate"]
        == AVAIL_FULL_WANT["remigrate"],
        "kill_equals_reference": got["kill"] == AVAIL_FULL_WANT["kill"],
        "reject_rates_exact": rates_exact,
        "per_failure_rows_equal_reference": single_got
        == AVAIL_FULL_WANT_SINGLE,
        "single_trace_equals_its_batch_row": all(
            np.array_equal(getattr(single, f), getattr(rem, f)[2])
            for f in replay_engine.AVAILABILITY_FIELDS),
        "three_k5_launches": launches == 3,
        "on_card": engines[0].device.type == "cuda",
        **{f"claim: {k}": v for k, v in claims.items()},
    }
    other = wall - times.compile_s - times.sweep_s
    emit("availability_full", ok=all(checks.values()), checks=checks,
         config=dict(AVAIL_FULL, n_servers=cfg.n_servers,
                     days=PROV_FULL["days"], trace_seed=PROV_FULL["seed"],
                     cores_per_server=cfg.cores_per_server,
                     pool_sockets=cfg.pool_sockets,
                     gb_per_core=cfg.gb_per_core, groups=cfg.n_groups,
                     server_gb=inp["server"].tolist(), pool_gb=pool.tolist()),
         vms=n_vms, events=[e.n_events for e in engines],
         failures=[s.n_failures for s in inp["scheds"]],
         results=got, per_failure_rows=single_got,
         remigration_success_rate=success.tolist(),
         oracle_lanes=dict(remigrate=lane[0], kill=lane[1]),
         claims=claims, kernel_launches=launches,
         sweeps=len(times.sweeps), sweep_lanes=[n for n, _ in times.sweeps],
         sweep_state_dtypes=[d for _, d in times.sweeps],
         engine_stats=stats,
         host_seconds=dict(compile_and_upload=times.compile_s,
                           device_sweeps=times.sweep_s, other=other,
                           oracle_two_lanes=oracle_s),
         wall_seconds=wall,
         device_busy_seconds=busy_s if kernels else None,
         device_idle_share_of_untraced_wall=(1 - busy_s / wall) if kernels
         else None,
         device_kernels=[dict(name=k[:60], count=c, seconds=us / 1e6)
                         for k, c, us in kernels[:5]],
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_path_bytes=peak - held)
    if not all(checks.values()):
        raise SystemExit("availability_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ------------------------------------------- the fleet topologies (K4, M9) --
_TOPO = {}


def _fig_topology():
    """``examples/torch_fig_topology.py`` of this checkout (the grid, the
    axes and the benchmark's claims), loaded once."""
    if "example" not in _TOPO:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", "torch_fig_topology.py")
        spec = importlib.util.spec_from_file_location("torch_fig_topology",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _TOPO["example"] = mod
    return _TOPO["example"]


def _topo_inputs():
    """``TOPO_FULL``'s cluster, traces (``PROV_FULL``'s row, trace seeds 2,
    3, 4: ``POND_BATCH_FULL``'s, sampled once) and static decisions, made
    once."""
    if "vms_list" not in _TOPO:
        from repro_torch.core import cluster_sim, traces
        cfg, vms2, _ = _full_trace()
        horizon = PROV_FULL["days"] * 86400
        n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
        pop = traces.Population(seed=0)
        have = dict(zip(POND_BATCH_FULL["seeds"], _POND["vms_list"])) \
            if _POND else {PROV_FULL["seed"]: vms2}
        vms_list = [have[s] if s in have else
                    pop.sample_vms(n, horizon, seed=s, start_id=10 ** 6)
                    for s in TOPO_FULL["seeds"]]
        decs = [cluster_sim.policy_decisions(
            v, "static", static_pool_frac=TOPO_FULL["static_pool_frac"],
            as_arrays=True)[0] for v in vms_list]
        _TOPO.update(cfg=cfg, vms_list=vms_list, decs=decs)
    return _TOPO


def _topo_grid(peak_pool, n_servers, full_gb):
    """``TOPO_FULL``'s lanes: fig_topology's full axes and topologies on
    the row; (sgb, caps, lane topologies, meta, DRAM fractions, pool
    totals, topologies)."""
    ex = _fig_topology()
    dram_fracs, pool_totals = ex.axes(peak_pool, quick=False)
    topos = ex.topologies(n_servers, quick=False)
    sgb, caps, lane_topos, meta = ex.grid(topos, dram_fracs, pool_totals,
                                          full_gb)
    return sgb, caps, lane_topos, meta, dram_fracs, pool_totals, topos


def _k4_state(n_slots, n_servers, cores, lanes, state_dtype, dev):
    """K4's incidence and all-free state on ``dev`` for lanes (sgb, pgb,
    inc)."""
    from repro_torch.core import sweep_core
    sgb, pgb, inc = lanes
    np_dt = sweep_core.state_np_dtype(state_dtype)
    st = sweep_core.init_pod_state(len(sgb), n_servers, cores, n_servers,
                                   pgb.shape[1], n_slots, np_dt)[:5]
    st += (np.asarray(sgb).astype(np_dt), np.asarray(pgb).astype(np_dt))
    return (torch.from_numpy(np.ascontiguousarray(inc, np.int32)).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in st))


def _k4_inputs(ev, n_slots, n_servers, cores, lanes, state_dtype, dev):
    """K4's arguments on ``dev``: the six event arrays, the incidence and
    the all-free state for lanes (sgb, pgb, inc)."""
    from repro_torch.kernels.pod_sweep.cases import EVENT_KEYS
    events = tuple(torch.from_numpy(np.ascontiguousarray(ev[k], np.int32))
                   .to(dev) for k in EVENT_KEYS)
    return (events,) + _k4_state(n_slots, n_servers, cores, lanes,
                                 state_dtype, dev)


def _k4_run(kernel, events, inc, state, trace_events=None,
            slot_column=None, distinct=None):
    """K4 (``kernel``, through its wrapper; ``distinct`` forces a table
    build) or its plain version on a copy of ``state``: [fc, um, up,
    slots, pods, rejects]."""
    from repro_torch.kernels.event_sweep.ops import trace_layout
    from repro_torch.kernels.pod_sweep import ops
    from repro_torch.kernels.pod_sweep.ref import pod_sweep_ref
    st = [t.clone() for t in state]
    rej = torch.zeros(st[0].shape[0], dtype=torch.int32, device=st[0].device)
    if kernel:
        ops.pod_sweep(*events, inc, *st, rej, trace_events=trace_events,
                      slot_column=slot_column, distinct=distinct)
    else:
        starts, counts = trace_layout(trace_events, events[0].shape[0],
                                      st[0].shape[0])
        pod_sweep_ref(*events, inc, *st, rej, starts, counts)
    torch.cuda.synchronize()
    return st[:5] + [rej]


def _k4_compare(name, got, want):
    """Max |got - want| over the final state; exits unless all equal."""
    from repro_torch.kernels.pod_sweep import ops
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"pod_sweep {name} {ops.last_plan}: the kernel's "
                         "final state differs from its plain version's")
    return err


def _k4_checks(dev):
    """K4 against its plain version on the card, ``==`` on the whole final
    state and the rejects: the edge stream's lanes (a double MIGRATE,
    fallback MIGRATEs to the first pod, negative used pool, orphan servers,
    a pod without members), int16 state at its bounds, pod ids at the
    int16 bound, the table's edges (``cases.table_stream``: two servers of
    a thread listing two pods in opposite order, a pod in two threads'
    tables, a fallback MIGRATE paying a first pod that is not the table's
    first entry), seeded streams over 4-500 servers, 1-300 lanes and rows
    of 1-3 pods (each lane its own topology), threads of exactly 3 K
    distinct pods or more than the next smaller build holds
    (``cases.wide_lanes``) and of one pod (``cases.aligned_lanes``), in
    both state types, the slot and pod columns where the plan puts them
    and in global memory, and every table build that holds the launch's
    widest thread forced (``distinct=``), so that every build of
    ``kernel.distinct_builds`` at K 1-16 runs in both state types; then
    the trace axis (three streams of other lengths, 5 lanes a trace).
    Returns (checked, max_abs_err)."""
    from repro_torch.kernels.event_sweep.ops import pack_traces
    from repro_torch.kernels.pod_sweep import cases, ops
    from repro_torch.kernels.pod_sweep import kernel as K4
    from repro_torch.kernels.pod_sweep.cases import EVENT_KEYS
    rng = np.random.default_rng(20)
    both = ("int16", "int32")
    runs = [("edges", *cases.edge_stream(), cases.EDGE_SHAPE,
             cases.edge_lanes(), both),
            ("int16_bounds", *cases.bounds_stream(), cases.BOUNDS_SHAPE,
             cases.bounds_lanes(), both),
            ("table_edges", *cases.table_stream(), cases.TABLE_SHAPE,
             cases.table_lanes(), both)]
    ev, n_slots = cases.random_stream(rng, 200)
    runs.append(("pod_id_bound", ev, n_slots, dict(n_servers=8, cores=64),
                 cases.pod_bound_lanes(rng, 3, 8, 64), ("int16",)))
    # fewer servers than a warp, 33 (two a thread), one lane, 300 lanes
    # (three a block), 100 (K 4), 256 (the row's K 8) and 500 servers (K 16)
    for s, n_lanes, fanout, n_vms in ((4, 5, 2, 200), (8, 12, 3, 200),
                                      (33, 9, 3, 300), (7, 1, 1, 200),
                                      (64, 300, 3, 300), (100, 12, 3, 300),
                                      (256, 16, 3, 900), (256, 24, 1, 900),
                                      (500, 16, 3, 900)):
        ev, n_slots = cases.random_stream(rng, n_vms)
        runs.append((f"S{s}_lanes{n_lanes}_F{fanout}", ev, n_slots,
                     dict(n_servers=s, cores=64),
                     cases.random_lanes(rng, n_lanes, s, 64, fanout), both))
    for s, n_distinct in ((8, 3), (33, 6), (100, 12), (256, 9), (256, 24),
                          (500, 9), (500, 48)):
        ev, n_slots = cases.random_stream(rng, 300)
        runs.append((f"S{s}_wide{n_distinct}", ev, n_slots,
                     dict(n_servers=s, cores=64),
                     cases.wide_lanes(rng, 6, s, 64, n_distinct), both))
    for s in (8, 33, 100, 256, 500):
        ev, n_slots = cases.random_stream(rng, 300)
        runs.append((f"S{s}_one_pod_a_thread", ev, n_slots,
                     dict(n_servers=s, cores=64),
                     cases.aligned_lanes(rng, 6, s, 64), both))
    checked, max_err, covered = [], 0, set()
    for name, ev, n_slots, shape, lanes, dts in runs:
        k = K4.servers_per_thread(shape["n_servers"])
        for dt in dts:
            events, inc, state = _k4_inputs(ev, n_slots, shape["n_servers"],
                                            shape["cores"], lanes, dt, dev)
            widest = int(K4.widest_distinct(inc, k))
            want = _k4_run(False, events, inc, state)
            forced = [d for d in K4.distinct_builds(k) if d >= widest]
            for column, distinct in ([(None, None), ("global", None)]
                                     + [(None, d) for d in forced]):
                got = _k4_run(True, events, inc, state, slot_column=column,
                              distinct=distinct)
                max_err = max(max_err, _k4_compare(f"{name} {dt}", got,
                                                   want))
                covered.add((dt, k, ops.last_plan.distinct))
                checked.append(dict(
                    case=name, state_dtype=dt,
                    plan=dataclasses.asdict(ops.last_plan),
                    forced_distinct=distinct, widest_thread=widest,
                    servers=shape["n_servers"], lanes=len(lanes[0]),
                    pods=lanes[1].shape[1], fanout=lanes[2].shape[2],
                    events=len(ev["kind"]), rejects=int(want[5].sum()),
                    min_used_pool=int(want[2].min())))
    missing = [(dt, k, d) for dt in both for k in (1, 2, 4, 8, 16)
               for d in K4.distinct_builds(k) if (dt, k, d) not in covered]
    if missing:
        raise SystemExit(f"pod_sweep: table builds never checked: {missing}")
    # the trace axis: three streams, 5 lanes a trace, the grid's incidence
    # a copy a trace
    streams = [cases.random_stream(rng, n) for n in (220, 150, 260)]
    cols, counts = pack_traces([tuple(ev[k] for k in EVENT_KEYS)
                                for ev, _ in streams], dev)
    n_slots = max(n for _, n in streams)
    sgb, pgb, inc = cases.random_lanes(rng, 5, 8, 64)
    tiled = (np.tile(sgb, 3), np.tile(pgb, (3, 1)), np.tile(inc, (3, 1, 1)))
    for dt in ("int16", "int32"):
        _, inc_t, state = _k4_inputs(streams[0][0], n_slots, 8, 64, tiled,
                                     dt, dev)
        want = _k4_run(False, cols, inc_t, state, trace_events=counts)
        for column in (None, "global"):
            got = _k4_run(True, cols, inc_t, state, trace_events=counts,
                          slot_column=column)
            max_err = max(max_err, _k4_compare(f"trace axis {dt}", got,
                                               want))
            checked.append(dict(case="trace_axis_3", state_dtype=dt,
                                plan=dataclasses.asdict(ops.last_plan),
                                trace_events=counts,
                                rejects=int(want[5].sum())))
    return checked, max_err


def _k4_timed(evs, inc, n_servers, cores, n_slots, sgb_i, pgb_i, np_dt,
              counts, clock_mhz, reps=5):
    """K4's kernel function itself (no wrapper checks) over ``evs``: one
    trace, or the trace axis as ``ops.pack_traces`` lays it out, with
    ``counts`` the traces' event counts and ``inc`` (the lanes' incidence,
    every trace's) on the card; the lanes (sgb_i, pgb_i) in each trace.
    One warm-up, then ``reps`` runs on fresh state timed by ``_card_ms``.
    Returns dict(ms, plan, the warm-up's rejects)."""
    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep.ops import trace_starts
    from repro_torch.kernels.pod_sweep import kernel as K4
    dev = inc.device
    k, width = len(counts), len(counts) * len(sgb_i)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the table build the wrapper would choose (checkouts before the
    # distinct-pod table have none)
    kw = {}
    if hasattr(K4, "widest_distinct"):
        kw["distinct"] = int(K4.widest_distinct(
            inc, K4.servers_per_thread(n_servers)))
    plan = K4.plan(len(sgb_i), n_servers, inc.shape[2], n_slots,
                   np.dtype(np_dt).itemsize, sms, k, **kw)
    st = sweep_core.init_pod_state(width, n_servers, cores, n_servers,
                                   pgb_i.shape[1], n_slots, np_dt)[:5]
    st += (np.tile(sgb_i, k).astype(np_dt),
           np.tile(pgb_i, (k, 1)).astype(np_dt))
    states = [[torch.from_numpy(a.copy()).to(dev) for a in st]
              for _ in range(reps + 1)]
    rejs = [torch.zeros(width, dtype=torch.int32, device=dev)
            for _ in range(reps + 1)]
    starts = trace_starts(counts)

    def run(i):
        K4.pod_sweep_kernel(evs, inc, *states[i], rejs[i], plan=plan,
                            trace_starts=starts, trace_counts=counts)
    run(0)
    torch.cuda.synchronize()
    res = dict(rejects=rejs[0].cpu().numpy(), plan=dataclasses.asdict(plan))
    res["ms"] = _card_ms([lambda i=i: run(i) for i in range(1, reps + 1)],
                         clock_mhz, "pod_sweep")
    return res


def _k1_timed(evs, group_of, n_servers, n_groups, cores, n_slots, sgb_i,
              pgb_i, np_dt, clock_mhz, reps=5):
    """K1 through its wrapper on fresh state a run, timed as
    ``_k4_timed``: dict(ms, plan, the warm-up's rejects)."""
    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep import ops
    st = sweep_core.init_state(len(sgb_i), n_servers, cores, n_servers,
                               n_groups, n_slots, np_dt)[:4]
    st += (sgb_i.astype(np_dt), pgb_i.astype(np_dt))
    states = [[torch.from_numpy(a.copy()).to(group_of.device) for a in st]
              for _ in range(reps + 1)]

    def run(i):
        return ops.event_sweep(*evs, group_of, *states[i])
    rej = run(0).cpu().numpy()
    ms = _card_ms([lambda i=i: run(i) for i in range(1, reps + 1)],
                  clock_mhz, "event_sweep")
    return dict(ms=ms, plan=dataclasses.asdict(ops.last_plan), rejects=rej)


def phase_kernels_pod(dev):
    """K4 against its plain version on the card (``_k4_checks``, and
    2,048-event cuts of ``TOPO_FULL`` through the wrapper, one trace x 192
    lanes and the seed batch's 3 x 192); at full width its time a sweep by
    ``_k4_timed`` — the 192 lanes of ``TOPO_FULL``, 16 lanes of
    partitioned(256, 8) and of single_pool(256), the batched 3 x 192 — each
    beside K1 on the same stream and lanes (the partitioned and 1-pod lanes
    at capacities K1 prices too, where both must give equal rejects), ns an
    event, the bound; the plain version on a cut; registers and spills."""
    from repro_torch.core import sweep_core, topology
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch,
                                                _fleet_candidates,
                                                _fleet_capacities,
                                                _fleet_incidence)
    from repro_torch.kernels import build
    from repro_torch.kernels.pod_sweep import kernel as K4
    from repro_torch.kernels.pod_sweep import ops
    checked, max_err = _k4_checks(dev)

    inp = _topo_inputs()
    cfg = inp["cfg"]
    n_srv, n_grp, cores = cfg.n_servers, cfg.n_groups, cfg.cores_per_server
    engines = [CompiledReplay(v, d, cfg, device=dev)
               for v, d in zip(inp["vms_list"], inp["decs"])]
    eng = engines[0]
    evs, group_of, n_slots = eng._device_events()
    peak = float(np.ceil(eng.peak_pool_demand()))
    full_gb = cfg.gb_per_core * cores
    sgb, caps, lane_topos, _, dram_fracs, pool_totals, _ = _topo_grid(
        peak, n_srv, full_gb)
    inc_np, p_max = _fleet_incidence(lane_topos, n_srv)
    sgb_i, caps_i = _fleet_capacities(
        *_fleet_candidates(sgb, caps, lane_topos)[:2])
    dt = eng._pick_pod_state_dtype(sgb_i, caps_i, p_max)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    n_ev = eng.n_events
    n_arrive = int((evs[0] == sweep_core.ARRIVE).sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(_smi("clocks.max.sm"))
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6

    def bound(arrivals, fanouts, n_events, n_slots, n_traces=1):
        # ``arrivals``: each trace's ARRIVE events; ``fanouts``: each lane's
        # pods a row (its topology's), the lanes of one trace
        width = n_traces * len(fanouts)
        ops_ = (sum(arrivals) * n_srv
                * sum(K1_OPS_PER_ARRIVE_SERVER + f for f in fanouts))
        state = (2 * width * n_srv + width * p_max
                 + 2 * n_slots * width) * item
        nbytes = (24 * n_events + 4 * width * n_srv * inc_np.shape[2]
                  + 2 * state + (width + width * p_max) * item + 8 * width)
        t_ops = ops_ / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    int32_ops=ops_, bytes=nbytes)

    def share(t):
        return dict(t, share_of_bound=t["bound_ms"] / t["ms"])

    def k4(evs_, inc_, n_slots_, sgb_, pgb_, counts):
        return _k4_timed(evs_, inc_, n_srv, cores, n_slots_, sgb_, pgb_,
                         np_dt, counts, clock_mhz)

    def k1(groups, sgb_, pgb_):
        grp = torch.from_numpy((np.arange(n_srv) * groups // n_srv)
                               .astype(np.int32)).to(dev)
        return _k1_timed(evs, grp, n_srv, groups, cores, n_slots, sgb_,
                         pgb_, np_dt, clock_mhz)

    timings = {}
    fanouts = [t.fanout for t in lane_topos]
    inc = torch.from_numpy(inc_np).to(dev)
    # TOPO_FULL's 192 lanes (rows of up to 3 pods), and K1 on the same
    # stream and lanes: its 32 groups at each lane's pool total / 32
    t4 = k4(evs, inc, n_slots, sgb_i, caps_i, [n_ev])
    t1 = k1(n_grp, sgb_i, np.floor(caps_i.sum(1) / n_grp))
    timings["topo_full_192"] = dict(
        ms=t4["ms"], ns_per_event=t4["ms"] * 1e6 / n_ev, events=n_ev,
        arrivals=n_arrive, lanes=len(sgb_i), n_slots=n_slots, pods=p_max,
        fanout=int(inc_np.shape[2]), state_dtype=dt, plan=t4["plan"],
        k1_ms=t1["ms"], k1_plan=t1["plan"], k4_over_k1=t4["ms"] / t1["ms"],
        **bound([n_arrive], fanouts, n_ev, n_slots))
    # 16 lanes of partitioned(256, 8) at uniform pod capacities (= K1's 32
    # groups) and 16 of single_pool(256) (= K1 with one group): equal rejects
    srv16 = np.repeat(np.round(full_gb * np.array([1.0, 0.8, 0.6, 0.45])), 4)
    tot16 = np.tile(np.asarray(pool_totals, float), 4)
    for name, topo, groups in (
            ("partitioned_256_8", topology.partitioned(n_srv, 8), n_grp),
            ("single_pool_256", topology.single_pool(n_srv), 1)):
        per_pod = np.floor(tot16 / topo.n_pods)
        inc16 = torch.from_numpy(_fleet_incidence([topo] * 16, n_srv)[0]) \
            .to(dev)
        pgb16 = np.repeat(per_pod[:, None], topo.n_pods, 1)
        a = k4(evs, inc16, n_slots, srv16, pgb16, [n_ev])
        b = k1(groups, srv16, per_pod)
        if a["rejects"].tolist() != b["rejects"].tolist():
            raise SystemExit(f"pod_sweep {name}: K4's rejects differ from "
                             f"K1's at the same capacities: "
                             f"{a['rejects'].tolist()} vs "
                             f"{b['rejects'].tolist()}")
        timings[name] = dict(
            ms=a["ms"], ns_per_event=a["ms"] * 1e6 / n_ev, lanes=16,
            plan=a["plan"], k1_ms=b["ms"], k1_plan=b["plan"],
            k4_over_k1=a["ms"] / b["ms"], rejects_equal_k1=True,
            rejects=a["rejects"].tolist(),
            **bound([n_arrive], [1] * 16, n_ev, n_slots))
    # the seed batch's launch: 3 traces x the 192 lanes
    batch = CompiledReplayBatch(engines)
    cols, _, n_slots_b, counts = batch._device_events()
    inc3 = torch.from_numpy(np.tile(inc_np, (len(engines), 1, 1))).to(dev)
    tb = k4(cols, inc3, n_slots_b, sgb_i, caps_i, counts)
    arrivals = [int((e._device_events()[0][0] == sweep_core.ARRIVE).sum())
                for e in engines]
    timings[f"batch{len(engines)}x{len(sgb_i)}"] = dict(
        ms=tb["ms"], plan=tb["plan"], trace_events=counts,
        n_slots=n_slots_b, over_single=tb["ms"] / t4["ms"],
        **bound(arrivals, fanouts, sum(counts), n_slots_b, len(engines)))

    # the kernel through its wrapper against its plain version, == on the
    # whole final state, on 2,048-event cuts at the main path's shapes: one
    # trace x 192 lanes, and the three traces' cuts packed as the seed
    # batch's launch (3 x 192 lanes), the columns where the plan puts them
    # and in global memory
    from repro_torch.kernels.event_sweep.ops import pack_traces
    cut = 2048
    ev_c = tuple(e[:cut].contiguous() for e in evs)
    cols_c, counts_c = pack_traces(
        [tuple(e[:cut].cpu().numpy() for e in x._device_events()[0])
         for x in engines], dev)
    cut_checks, plain_cut_ms = [], None
    for name, evs_c, n_sl, k, tr in (
            ("cut_topo_full", ev_c, n_slots, 1, None),
            ("cut_batch3x192", cols_c, n_slots_b, len(engines), counts_c)):
        lanes = (np.tile(sgb_i, k), np.tile(caps_i, (k, 1)),
                 np.tile(inc_np, (k, 1, 1)))
        inc_c, st = _k4_state(n_sl, n_srv, cores, lanes, dt, dev)
        t0 = time.perf_counter()
        want = _k4_run(False, evs_c, inc_c, st, trace_events=tr)
        if plain_cut_ms is None:
            plain_cut_ms = (time.perf_counter() - t0) * 1e3
        for column in (None, "global"):
            got = _k4_run(True, evs_c, inc_c, st, trace_events=tr,
                          slot_column=column)
            max_err = max(max_err, _k4_compare(name, got, want))
            cut_checks.append(dict(
                case=name, plan=dataclasses.asdict(ops.last_plan),
                lanes=k * len(sgb_i), trace_events=tr or [cut],
                rejects=int(want[5].sum()),
                pooled_grants_held=int((want[4] >= 0).sum())))
    cut_ms = k4(ev_c, inc, n_slots, sgb_i, caps_i, [cut])["ms"]
    with open(f"{build.library_path(K4.NAME)}.log") as f:
        report = K4.ptxas_report(f.read())
    def short(name):            # the kernel's name and template arguments
        m = re.search(r"([a-z_]+kernelI\w*?)EEv", name)
        return m.group(1) if m else name

    emit("kernels_pod_codegen",
        ptxas=[dict(r, function=short(r["function"])) for r in report],
        instantiations=len(report),
        with_stack_or_spills=[short(r["function"]) for r in report
                              if r.get("stack_bytes")
                              or r.get("spill_store_bytes")])
    timings = {k: share(t) for k, t in timings.items()}
    main = timings["topo_full_192"]
    record = dict(
        name=K4.NAME, route="cuda", source=K4.SOURCE,
        replaces="src/repro/core/sweep_core.py:566",
        max_abs_err=max_err, tolerance="== (integer state, exact)",
        cases_checked=len(checked) + len(cut_checks), cases=checked,
        cut_checks=cut_checks,
        design="K1's registers design (one warp a lane, K = S/32 servers "
               "a thread in registers, redux.sync first minimum, "
               "predicated updates, 2-stage cp.async event tiles); a "
               "table of the distinct pods a thread's servers list (D "
               "entries: id and free pool in int32; D 1, 8 or 3 K, the "
               "least that holds the launch's widest thread, which the "
               "wrapper counts; the kernel traps past D), for each server "
               "its row as entries in list order, one word (one-hot "
               "fields, the first listed on top, or 8-bit indices); a fit "
               "mask an ARRIVE, one logical op a server for "
               "admissibility; the chosen server's owner decodes the "
               "first listed entry with room (one FLO, a select tree over "
               "the table) and broadcasts its pod by one __shfl_sync; D "
               "predicated adds an update; "
               "each slot's pod in a second per-lane column beside the "
               "slot column (thread 0; shared memory, global past its "
               "limit)",
        ms=main["ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        timed_shape=dict(events=n_ev, arrivals=n_arrive, servers=n_srv,
                         pods=p_max, fanout=main["fanout"],
                         n_slots=n_slots, lanes=len(sgb_i),
                         state_dtype=dt),
        timings=timings, ptxas=report,
        no_stack_or_spills=all(r.get("stack_bytes") == 0
                               and r.get("spill_store_bytes") == 0
                               for r in report),
        plain_ms=plain_cut_ms, plain_cut_events=cut, ms_at_plain_cut=cut_ms,
        plain_note="the plain version (a Python loop of tensor ops an "
                   "event) at a 2,048-event cut of TOPO_FULL's stream, 192 "
                   "lanes, one run by the host clock; ms_at_plain_cut is "
                   "the kernel on the same cut",
        timing_note=f"CUDA events around 5 launches of the kernel function "
                    f"(no wrapper checks) on fresh state, enqueued behind a "
                    f"{CARD_WAIT_MS} ms wait on the card; K1 through its "
                    f"wrapper on the same stream, the same way",
        int32_rate_ops_per_s=int32_rate, sm_clock_max_mhz=clock_mhz,
        library_ms=None,
        library_note="no PyTorch call computes a sequential per-lane "
                     "best-fit allocator over a pod incidence")
    emit("kernels_pod", kernels=[record])
    return record


def phase_topology_parity_small(dev):
    """tests/test_topology_engine.py's world (8 servers, 4.75 GB a core, 2
    days, static 0.25; seeds 3, 4, 5, and seed 3 with QoS migrations grafted
    onto a third of the pooled VMs) and its 16-lane grid of four topologies
    on the card (K4) and on the CPU (its plain version): each trace in both
    state types, and the batch of seeds 3, 4; equal results."""
    from repro_torch.core import cluster_sim, replay_engine, topology, traces
    from repro_torch.kernels.pod_sweep import ops
    cfg = cluster_sim.ClusterConfig(n_servers=8, pool_sockets=8,
                                    gb_per_core=4.75)
    horizon = 2 * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    topos = [topology.partitioned(8, 4), topology.overlapping(8, 4, 2),
             topology.sparse(8, 4, 2, seed=1),
             topology.sparse(8, 3, 2, seed=2, allow_orphans=True)]
    sgb, caps, lane_topos = [], [], []
    for server, total in ((200.0, 150.0), (200.0, 40.0), (140.0, 300.0),
                          (60.0, 6144.0)):
        for t in topos:
            sgb.append(server)
            caps.append(topology.split_pool(total, t.n_pods))
            lane_topos.append(t)
    sgb = np.asarray(sgb)
    worlds = []
    for seed, migrate in ((3, False), (4, False), (5, False), (3, True)):
        vms = traces.Population(seed=0).sample_vms(n, horizon, seed=seed,
                                                   start_id=10 ** 6)
        dec, _ = cluster_sim.policy_decisions(vms, "static",
                                              static_pool_frac=0.25,
                                              as_arrays=True)
        if migrate:
            pick = (dec.pool_gb > 0) & (np.arange(n) % 3 == 0)
            life = np.array([vm.arrival + 0.5 * vm.lifetime for vm in vms])
            dec.t_migrate = np.where(pick, life, dec.t_migrate)
        worlds.append((vms, dec))
    out = {}
    for d in (dev, "cpu"):
        before = ops.launches
        engines = [replay_engine.CompiledReplay(v, dc, cfg, device=d)
                   for v, dc in worlds]
        got = [e.reject_rates_fleet(sgb, caps, lane_topos,
                                    state_dtype=dt).tolist()
               for e in engines for dt in ("int16", "int32")]
        got.append(replay_engine.CompiledReplayBatch(engines[:2])
                   .reject_rates_fleet(sgb, caps, lane_topos).tolist())
        out[str(d)] = (got, ops.launches - before)
    (g, g_n), (c, c_n) = out[str(dev)], out["cpu"]
    checks = {"results_equal": g == c, "launches_on_card": g_n == 9,
              "none_on_cpu": c_n == 0,
              "grid_discriminates": min(g[0]) < max(g[0]),
              "dtypes_agree": all(g[i] == g[i + 1] for i in range(0, 8, 2))}
    emit("topology_parity_small", ok=all(checks.values()), checks=checks,
         servers=8, vms=n, lanes=len(sgb), kernel_launches=g_n,
         rejects=[np.rint(np.asarray(r) * n).astype(int).tolist()
                  for r in g[::2]])
    if not all(checks.values()):
        raise SystemExit(f"topology_parity_small failed: {checks}")


def _topology_path(inp, device):
    """The fleet study as a user runs it: three engines (trace seeds 2, 3,
    4), fig_topology's full grid on the first priced in one
    ``reject_rates_fleet``, then the seed batch in one
    ``CompiledReplayBatch.reject_rates_fleet``.  Returns (rates, batch
    rates, engines, grid)."""
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch)
    cfg = inp["cfg"]
    engines = [CompiledReplay(v, d, cfg, device=device)
               for v, d in zip(inp["vms_list"], inp["decs"])]
    grid = _topo_grid(float(np.ceil(engines[0].peak_pool_demand())),
                      cfg.n_servers, cfg.gb_per_core * cfg.cores_per_server)
    sgb, caps, lane_topos = grid[:3]
    rates = engines[0].reject_rates_fleet(sgb, caps, lane_topos)
    batch = CompiledReplayBatch(engines).reject_rates_fleet(sgb, caps,
                                                            lane_topos)
    return rates, batch, engines, grid


def phase_topology_full(dev):
    """Pond's fleet topologies at full width (``TOPO_FULL``,
    fig_topology's full grid on the PROV_FULL row): 192 lanes in one
    ``reject_rates_fleet`` and the seed batch (3 x 192) in one
    ``CompiledReplayBatch.reject_rates_fleet``, 2 K4 launches; every reject
    count held to the reference's (hard-coded), batch row 0 to the single
    engine, the named lanes to the port's scalar oracle, the 1-pod lanes to
    the single-pool engine (K1, one group), fig_topology's four claims."""
    from repro_torch.core import cluster_sim, replay_engine, topology
    from repro_torch.kernels.pod_sweep import ops
    inp = _topo_inputs()
    cfg = inp["cfg"]
    replay_engine.stats_reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this one
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    rates, batch, engines, grid = _topology_path(inp, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    last_plan = dataclasses.asdict(ops.last_plan)   # the batch's launch
    peak = torch.cuda.max_memory_allocated()
    stats = replay_engine.stats_snapshot()
    times = replay_engine.stage_times()
    sgb, caps, lane_topos, meta, dram_fracs, pool_totals, topos = grid
    n_vms = [e.n_vms for e in engines]
    single = np.rint(rates * n_vms[0]).astype(int).tolist()
    rows = np.rint(batch * np.asarray(n_vms)[:, None]).astype(int).tolist()
    # the steady-state cost of the grid (the trace compiled and uploaded):
    # a second call, the speed claim's numerator
    t1 = time.perf_counter()
    again = engines[0].reject_rates_fleet(sgb, caps, lane_topos)
    compiled_s = time.perf_counter() - t1
    # the named lanes by the port's scalar oracle on the host
    lanes = [i for i, (f, t, _) in enumerate(meta)
             if (f, t) == TOPO_FULL["oracle_corner"]]
    ex = _fig_topology()
    oracle, oracle_s = ex.oracle_rates(
        inp["vms_list"][0], inp["decs"][0].as_vmdecisions(), cfg, sgb, caps,
        lane_topos, lanes)
    # the 1-pod lanes against the single-pool engine (K1, one group): every
    # single_pool(256) lane of the grid at its pool total
    cfg1 = cluster_sim.ClusterConfig(n_servers=cfg.n_servers,
                                     pool_sockets=2 * cfg.n_servers,
                                     gb_per_core=cfg.gb_per_core)
    eng1 = replay_engine.CompiledReplay(inp["vms_list"][0], inp["decs"][0],
                                        cfg1, device=dev)
    one_pod = topology.single_pool(cfg.n_servers).describe()
    ones = [i for i, m in enumerate(meta) if m[2] == one_pod]
    base = eng1.reject_rates(sgb[ones], np.asarray([m[1] for m in meta])[ones])
    claims = ex.claims(rates, meta, dram_fracs, pool_totals, oracle=oracle,
                       oracle_lanes=lanes, oracle_s=oracle_s,
                       compiled_s=compiled_s, base=base, one=rates[ones],
                       n_events=engines[0].n_events)
    # the same path again under the tracer, for the device's busy time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _topology_path(inp, None)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6
    checks = {
        "single_equals_reference": single == TOPO_FULL_WANT["single"],
        "batch_equals_reference": rows == TOPO_FULL_WANT["batch"],
        "batch_row0_equals_single": batch[0].tolist() == rates.tolist(),
        "steady_call_equals_first": again.tolist() == rates.tolist(),
        "two_k4_launches": launches == 2,
        "on_card": engines[0].device.type == "cuda",
        **{f"claim: {name}": ok for name, ok, _ in claims},
    }
    other = wall - times.compile_s - times.sweep_s
    emit("topology_full", ok=all(checks.values()), checks=checks,
         config=dict(TOPO_FULL, n_servers=cfg.n_servers,
                     days=PROV_FULL["days"],
                     cores_per_server=cfg.cores_per_server,
                     pool_sockets=cfg.pool_sockets,
                     gb_per_core=cfg.gb_per_core,
                     dram_fracs=dram_fracs,
                     pool_totals_gb=[float(t) for t in pool_totals],
                     topologies=[t.describe() for t in topos]),
         vms=n_vms, events=[e.n_events for e in engines], lanes=len(sgb),
         rejects=single, batch_rejects=rows,
         oracle_lanes=[dict(lane=i, meta=meta[i], rate=float(r),
                            kernel=float(rates[i]))
                       for i, r in zip(lanes, oracle)],
         claims=[dict(claim=n, ok=ok, detail=d) for n, ok, d in claims],
         kernel_launches=launches, sweeps=len(times.sweeps),
         sweep_lanes=[n for n, _ in times.sweeps],
         sweep_state_dtypes=[d for _, d in times.sweeps],
         last_launch_plan=last_plan,
         engine_stats=stats,
         host_seconds=dict(compile_and_upload=times.compile_s,
                           device_sweeps=times.sweep_s, other=other,
                           steady_grid_call=compiled_s,
                           oracle_lanes=oracle_s),
         wall_seconds=wall,
         device_busy_seconds=busy_s if kernels else None,
         device_idle_share_of_untraced_wall=(1 - busy_s / wall) if kernels
         else None,
         device_kernels=[dict(name=k[:60], count=c, seconds=us / 1e6)
                         for k, c, us in kernels[:5]],
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_path_bytes=peak - held)
    if not all(checks.values()):
        raise SystemExit("topology_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ------------------------------------- the streaming engines (M5) --
def _stream_ops():
    """K1's and K4's wrappers, whose launch counts the stream phases read."""
    from repro_torch.kernels.event_sweep import ops as k1
    from repro_torch.kernels.pod_sweep import ops as k4
    return k1, k4


def phase_stream_parity_small(dev):
    """phase_provision_parity_small's 8-server world (4 days, static 0.25;
    trace seeds 3 and 4) streamed at 256 events a shard, on the card (K1
    and K4 a shard, the state carried on the card) and on the CPU (their
    plain versions): seed 3's reject_rates with and without the
    divergence-window skip and under a reject_cap, its reject_rates_fleet
    over two topologies, and the two traces as a stream batch (both
    methods); equal results both ways, the card's equal to the monolithic
    engine's."""
    from repro_torch.core import cluster_sim, topology, traces
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayStream,
                                                CompiledReplayStreamBatch)
    k1, k4 = _stream_ops()
    cfg = cluster_sim.ClusterConfig(n_servers=8, pool_sockets=8,
                                    gb_per_core=4.75)
    horizon = 4 * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    pop = traces.Population(seed=0)
    worlds = []
    for seed in (3, 4):
        vms = pop.sample_vms(n, horizon, seed=seed, start_id=10 ** 6)
        worlds.append((vms, cluster_sim.policy_decisions(
            vms, "static", static_pool_frac=0.25, as_arrays=True)[0]))
    server = np.array([768.0, 200.0, 140.0, 250.0, 180.0, 60.0, 219.7, 0.0])
    pool = np.array([6144.0, 300.0, 150.0, 0.0, 40.0, 6144.0, 83.3, 100.0])
    topos = [topology.partitioned(8, 4), topology.overlapping(8, 4, 2)]
    sgb, caps, lane_topos = [], [], []
    for srv, total in ((200.0, 150.0), (200.0, 40.0), (140.0, 300.0),
                       (60.0, 6144.0)):
        for t in topos:
            sgb.append(srv)
            caps.append(topology.split_pool(total, t.n_pods))
            lane_topos.append(t)
    sgb = np.asarray(sgb)
    cap = int(0.02 * n)
    out = {}
    for d in (dev, "cpu"):
        k1.launches = k4.launches = 0
        streams = [CompiledReplayStream(v, dc, cfg, max_events_per_shard=256,
                                        device=d) for v, dc in worlds]
        s0, batch = streams[0], CompiledReplayStreamBatch(streams)
        got = dict(
            rates=s0.reject_rates(server, pool).tolist(),
            rates_unskipped=s0.reject_rates(server, pool,
                                            skip_windows=False).tolist(),
            rates_capped=s0.reject_rates(server, pool,
                                         reject_cap=cap).tolist(),
            fleet=s0.reject_rates_fleet(sgb, caps, lane_topos).tolist(),
            batch=batch.reject_rates(server, pool).tolist(),
            batch_fleet=batch.reject_rates_fleet(sgb, caps,
                                                 lane_topos).tolist())
        out[str(d)] = (got, k1.launches, k4.launches, s0.n_shards)
    (g, g1, g4, shards), (c, c1, c4, _) = out[str(dev)], out["cpu"]
    mono = CompiledReplay(*worlds[0], cfg, device=dev)
    checks = {
        "results_equal": g == c,
        "skip_changes_nothing": g["rates"] == g["rates_unskipped"],
        "rates_equal_monolithic":
            g["rates"] == mono.reject_rates(server, pool).tolist(),
        "fleet_equals_monolithic": g["fleet"] == mono.reject_rates_fleet(
            sgb, caps, lane_topos).tolist(),
        "batch_row0_equals_single": g["batch"][0] == g["rates"],
        "several_shards": shards > 1,
        "k1_launches_on_card": g1 > 0, "k4_launches_on_card": g4 > 0,
        "none_on_cpu": c1 == 0 and c4 == 0}
    emit("stream_parity_small", ok=all(checks.values()), checks=checks,
         servers=8, vms=n, shards=shards, lanes=len(server),
         fleet_lanes=len(sgb), reject_cap=cap, results=g,
         k1_launches=g1, k4_launches=g4)
    if not all(checks.values()):
        raise SystemExit(f"stream_parity_small failed: {checks}")


def _acceptance_trace():
    """``STREAM_FULL``'s (a): the reference's 100,000-VM acceptance trace
    with its static-floor decisions, drawn as
    tests/test_replay_stream.py draws them; (cfg, vms, decisions)."""
    from repro_torch.core import cluster_sim, traces
    from repro_torch.core.policy_engine import PolicyDecisions
    a = STREAM_FULL["acceptance"]
    n = a["n_vms"]
    rng = np.random.default_rng(a["seed"])
    arrival = np.sort(rng.uniform(0, a["days"] * 86400, n)).round(3)
    life = rng.integers(1800, 86400, n).astype(float)
    cores = rng.choice([2, 4, 8], n, p=[.5, .3, .2])
    mem = (cores * rng.choice([2, 4], n)).astype(float)
    pmu = np.zeros(traces.N_PMU_FEATURES, np.float32)
    vms = [traces.VM(i, 0, 0, 0, 0, int(cores[i]), float(mem[i]),
                     float(arrival[i]), float(life[i]), 0.5, 0.0, 0.0, pmu)
           for i in range(n)]
    pool = np.floor(mem * a["floor"])
    dec = PolicyDecisions(mem - pool, pool, np.zeros(n, bool),
                          np.full(n, np.nan), 0, 0)
    cfg = cluster_sim.ClusterConfig(n_servers=a["n_servers"],
                                    pool_sockets=a["pool_sockets"],
                                    gb_per_core=a["gb_per_core"])
    return cfg, vms, dec


def _blocks(*nbytes):
    """Bytes the caching allocator holds for these requests (512-byte
    blocks)."""
    return sum(max(512, -(-int(b) // 512) * 512) for b in nbytes)


def _k1_fixed_bytes(lanes, n_servers, n_groups, n_slots, item):
    """What a streamed K1 sweep holds on the card beside its two event
    buffers: fc, um, up, slots, the reject counters, the capacities and
    group_of."""
    return _blocks(lanes * n_servers * item, lanes * n_servers * item,
                   lanes * n_groups * item, n_slots * lanes * item,
                   lanes * 4, lanes * item, lanes * item, n_servers * 4)


def _k4_fixed_bytes(lanes, n_servers, n_pods, fanout, n_slots, item):
    """The same for a streamed K4 sweep: fc, um, up, slots, pods, the
    counters, the capacities and the incidence."""
    return _blocks(lanes * n_servers * item, lanes * n_servers * item,
                   lanes * n_pods * item, n_slots * lanes * item,
                   n_slots * lanes * item, lanes * 4, lanes * item,
                   lanes * n_pods * item, lanes * n_servers * fanout * 4)


def _stream_memory(run, fixed_bytes, peak_shard_bytes):
    """``torch.cuda.max_memory_allocated`` over one streamed sweep (``run``,
    which ends on the host), less what was held before and the sweep's
    state and capacities: the event memory, held to ``2 *
    peak_shard_bytes``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    event_bytes = torch.cuda.max_memory_allocated() - held - fixed_bytes
    return dict(event_bytes=event_bytes, bound_bytes=2 * peak_shard_bytes,
                fixed_bytes=fixed_bytes), event_bytes <= 2 * peak_shard_bytes


def _stream_card_ms(run, clock_mhz, reps=3):
    """Mean device ms of a streamed sweep: ``run`` enqueues its uploads and
    launches (the host packing shard i + 1 while shard i runs, waiting only
    to reuse a pinned buffer) and returns without reading anything back.
    Each run gets its own window: CUDA events around it behind a
    ``CARD_WAIT_MS`` wait on the card (a run's host set-up is not hidden by
    the wait: its pageable uploads of the state wait for it)."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(CARD_WAIT_MS * clock_mhz * 1e3))
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.mean(ms)


def _upload_host_ms(engine):
    """Host ms a shard of packing it into a pinned buffer and issuing its
    copy (``_ShardFeed.stage``), every shard staged and taken in turn with
    no launch."""
    feed = engine._feed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for si in range(engine.n_shards):
        feed.stage(si)
        feed.take(si)
        feed.release(si)
    ms = (time.perf_counter() - t0) * 1e3 / engine.n_shards
    feed.close()
    torch.cuda.synchronize()
    return ms


class _ShardsOnCard:
    """A stand-in for a stream's ``_ShardFeed`` with every shard on the
    card already, packed as the feed packs them: the engine's own shard
    loop with no upload, to split the streamed sweep's time into its
    launches and its uploads."""
    timed = False             # the untraced shard loop

    def __init__(self, engine, dev):
        rows = getattr(engine, "k", 1) * (engine.shard_pad_events + 4)
        self.shards = []
        for si in range(engine.n_shards):
            buf = np.empty((6, rows), np.int32)
            length, counts = engine._pack(si, buf)
            t = torch.from_numpy(buf).to(dev)
            self.shards.append((tuple(t[j, :length] for j in range(6)),
                                counts))

    def stage(self, si):
        pass

    def take(self, si):
        return self.shards[si]

    def release(self, si):
        pass

    def close(self):
        pass


def _compute_ms(engine, run, clock_mhz):
    """``_stream_card_ms`` of ``run`` with ``engine``'s shards on the card
    before the window (``_ShardsOnCard``): the streamed sweep without its
    uploads."""
    on_card = _ShardsOnCard(engine, torch.device("cuda"))
    engine._feed = lambda device=None: on_card
    try:
        return _stream_card_ms(run, clock_mhz)
    finally:
        del engine._feed


def _k1_batch_timed(batch, sgb_i, pgb_i, np_dt, clock_mhz, reps=3):
    """K1's trace axis over a monolithic ``CompiledReplayBatch`` (every
    trace's whole stream uploaded) on fresh state a run, timed by
    ``_card_ms``; (ms, rejects)."""
    from repro_torch.core import sweep_core
    evs, group, n_slots, counts = batch._device_events()
    width = sgb_i.size
    st = sweep_core.init_state(width, batch.n_servers, batch.cores_per_server,
                               batch.n_servers, batch.n_groups, n_slots,
                               np_dt)[:4]
    st += (sgb_i.reshape(-1).astype(np_dt), pgb_i.reshape(-1).astype(np_dt))
    states = [[torch.from_numpy(a.copy()).to(group.device) for a in st]
              for _ in range(reps + 1)]
    sweep = sweep_core.get_sweep(
        "int16" if np_dt == np.int16 else "int32", batched=True)

    def run(i):
        return sweep(evs, group, *states[i], counts)
    rej = run(0).cpu().numpy()
    return _card_ms([lambda i=i: run(i) for i in range(1, reps + 1)],
                    clock_mhz, "event_sweep batched"), rej


def _stream_record(name, engine, wall, stream_ms, compute_ms, mono_ms,
                   reference_s, memory, **extra):
    """One configuration's numbers, printed as soon as they are taken:
    shards, wall, the streamed sweep's device ms beside the same sweep
    with its shards on the card (``_compute_ms``) and its monolithic
    twin's, so that ``stream - on card`` is what the uploads and the
    host's staging add and ``on card - monolithic`` what cutting the sweep
    into launches adds; the host ms a shard of staging an upload; the
    host's reference replay; the event memory."""
    rec = dict(config=name, shards=engine.n_shards,
               shard_pad_events=engine.shard_pad_events,
               peak_shard_bytes=engine.peak_shard_bytes,
               wall_seconds=wall, stream_sweep_ms=stream_ms,
               stream_sweep_on_card_ms=compute_ms,
               monolithic_sweep_ms=mono_ms,
               stream_over_monolithic=stream_ms / mono_ms,
               uploads_add_ms=stream_ms - compute_ms,
               launches_add_ms=compute_ms - mono_ms,
               upload_host_ms_a_shard=_upload_host_ms(engine),
               stream_reference_host_s=reference_s, memory=memory, **extra)
    emit("stream_full_config", **rec)
    return rec


def _reference_s(streams):
    """Host seconds of ``_stream_reference`` (the divergence-window skip's
    reference replay) of each stream, its cache cleared first."""
    from repro_torch.core import replay_engine
    out = []
    for s in streams:
        s._ref = None
        t0 = time.perf_counter()
        replay_engine._stream_reference(s)
        out.append(time.perf_counter() - t0)
    return out


def phase_stream_full(dev):
    """Pond's streaming engines at full width (``STREAM_FULL``): (a) the
    reference's 100,000-VM acceptance trace at 32,768 events a shard, ==
    the monolithic engine's K1; (b) PROV_FULL's savings_analysis past a
    16,384-event budget, the reference's streamed contract; (c)
    POND_BATCH_FULL's savings_analysis_batched past the budget, the nine
    PolicyResults the reference's; (d) TOPO_FULL's fleet grid and its seed
    batch on streams, the reference's reject counts.  Each main path runs
    with K1's and K4's launch counts set to 0 just before it and read just
    after; then each configuration's streamed sweep is timed beside its
    monolithic twin, its uploads alone, its reference replay and its event
    memory (``_stream_record``).  Returns (K1 launches, K4 launches)."""
    from repro_torch.core import cluster_sim, replay_engine, sweep_core
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch,
                                                CompiledReplayStream,
                                                CompiledReplayStreamBatch)
    k1, k4 = _stream_ops()
    clock_mhz = float(_smi("clocks.max.sm"))
    budget = STREAM_FULL["budget"]
    launches = {"k1": 0, "k4": 0}
    checks, records = {}, []

    def main_path(fn):
        k1.launches = k4.launches = 0       # just before a main path ...
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["k1"] += k1.launches       # ... and read just after it
        launches["k4"] += k4.launches
        return out, wall

    # (a) the acceptance trace
    a = STREAM_FULL["acceptance"]
    cfg_a, vms_a, dec_a = _acceptance_trace()
    server, pool = np.array(a["server"]), np.array(a["pool"])

    def path_a():
        st = CompiledReplayStream(vms_a, dec_a, cfg_a,
                                  max_events_per_shard=a["budget"])
        return st, st.reject_rates(server, pool)
    (st_a, rates_a), wall_a = main_path(path_a)
    mono_a = CompiledReplay(vms_a, dec_a, cfg_a)
    want_a = mono_a.reject_rates(server, pool)
    checks |= {
        "a_rates_equal_monolithic": rates_a.tolist() == want_a.tolist(),
        "a_memory_binds": len(set(rates_a.tolist())) > 1,
        "a_at_least_6_shards": st_a.n_shards >= 6,
        "a_shard_within_budget": st_a.shard_pad_events <= a["budget"],
        "a_peak_shard_bytes":
            st_a.peak_shard_bytes == 6 * 4 * st_a.shard_pad_events}
    sgb_i, pgb_i = sweep_core.quantize_capacities(server, pool)
    dt = st_a._pick_state_dtype(sgb_i, pgb_i)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    evs, group, n_slots = mono_a._device_events()
    mono_ms = _k1_timed(evs, group, cfg_a.n_servers, cfg_a.n_groups,
                        cfg_a.cores_per_server, n_slots, sgb_i, pgb_i, np_dt,
                        clock_mhz, reps=3)["ms"]
    run = functools.partial(st_a._sweep_device, server, pool, None, dt,
                            None, False)
    stream_ms = _stream_card_ms(run, clock_mhz)
    compute_ms = _compute_ms(st_a, run, clock_mhz)
    mem, ok = _stream_memory(
        lambda: st_a.reject_rates(server, pool, skip_windows=False),
        _k1_fixed_bytes(len(server), cfg_a.n_servers, cfg_a.n_groups,
                        st_a._n_slots, item), st_a.peak_shard_bytes)
    checks["a_event_memory_within_2_shards"] = ok
    records.append(_stream_record(
        "a_acceptance_100k", st_a, wall_a, stream_ms, compute_ms, mono_ms,
        _reference_s([st_a]), mem, vms=st_a.n_vms,
        events=st_a.n_events, servers=cfg_a.n_servers, lanes=len(server),
        state_dtype=dt, rates=rates_a.tolist()))
    del vms_a, dec_a, mono_a, st_a, evs, group

    # (b) PROV_FULL's provisioning loop past the budget
    cfg, vms, _ = _full_trace()
    frac = PROV_FULL["static_pool_frac"]

    def path_b():
        cache = {}
        local = cluster_sim.savings_analysis(
            vms, cfg, "local", cache=cache, max_events_per_shard=budget)
        static = cluster_sim.savings_analysis(
            vms, cfg, "static", cache=cache, static_pool_frac=frac,
            max_events_per_shard=budget)
        return local, static, cache["local_engine"]
    replay_engine.stats_reset()
    (local, static, eng_local), wall_b = main_path(path_b)
    times_b = replay_engine.stage_times()
    dec_s, _ = cluster_sim.policy_decisions(vms, "static",
                                            static_pool_frac=frac,
                                            as_arrays=True)
    st_b = CompiledReplayStream(vms, dec_s, cfg, max_events_per_shard=budget)
    mono_b = CompiledReplay(vms, dec_s, cfg)
    hi_server = cfg.cores_per_server * 12.0
    tol_b = float(mono_b.reject_rates(hi_server,
                                      hi_server * cfg.n_servers)[0]) + 0.005
    at_opt = float(mono_b.reject_rates(static.server_gb,
                                       static.pool_group_gb)[0])
    checks |= {
        "b_local_equals_reference":
            dataclasses.asdict(local) == PROV_FULL_WANT["local"],
        "b_baseline_equals_reference": static.baseline_server_gb
            == PROV_FULL_WANT["static"]["baseline_server_gb"],
        "b_optimum_feasible_on_monolithic_k1": at_opt <= tol_b,
        "b_pool_within_peak_pool_demand":
            static.pool_group_gb <= st_b.peak_pool_demand() + 1e-9,
        "b_server_within_baseline":
            static.server_gb <= static.baseline_server_gb + 1e-9,
        "b_engine_is_a_stream": isinstance(eng_local, CompiledReplayStream)}
    lo, hi = STREAM_FULL["timed_server"]
    server = np.linspace(lo, hi, STREAM_FULL["timed_lanes"])
    pool = np.linspace(*STREAM_FULL["timed_pool"], STREAM_FULL["timed_lanes"])
    sgb_i, pgb_i = sweep_core.quantize_capacities(server, pool)
    dt = st_b._pick_state_dtype(sgb_i, pgb_i)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    evs, group, n_slots = mono_b._device_events()
    timed = _k1_timed(evs, group, cfg.n_servers, cfg.n_groups,
                      cfg.cores_per_server, n_slots, sgb_i, pgb_i, np_dt,
                      clock_mhz, reps=3)
    run = functools.partial(st_b._sweep_device, server, pool, None, dt,
                            None, False)
    stream_ms = _stream_card_ms(run, clock_mhz)
    compute_ms = _compute_ms(st_b, run, clock_mhz)
    checks["b_timed_sweep_equals_monolithic"] = st_b.reject_rates(
        server, pool).tolist() == (timed["rejects"] / len(vms)).tolist()
    mem, ok = _stream_memory(
        lambda: st_b.reject_rates(server, pool, skip_windows=False),
        _k1_fixed_bytes(len(server), cfg.n_servers, cfg.n_groups,
                        st_b._n_slots, item), st_b.peak_shard_bytes)
    checks["b_event_memory_within_2_shards"] = ok
    records.append(_stream_record(
        "b_prov_full_savings", st_b, wall_b, stream_ms, compute_ms,
        timed["ms"], _reference_s([st_b]), mem, vms=len(vms),
        events=st_b.n_events, lanes=len(server), state_dtype=dt,
        results=[dataclasses.asdict(r) for r in (local, static)],
        at_optimum=dict(monolithic_rate=at_opt, tol=tol_b),
        sweeps=len(times_b.sweeps),
        host_seconds=dict(compile=times_b.compile_s,
                          sweeps=times_b.sweep_s)))
    del st_b, mono_b, evs, group

    # (c) Fig 21's seed batch past the budget
    inp = _pond_inputs()
    models = (inp["li"], inp["um"], inp["hist"])
    replay_engine.stats_reset()
    (res_c, _, local_batch), wall_c = main_path(lambda: _pond_loop(
        inp["vms_list"], inp["cfg"], models,
        POND_BATCH_FULL["static_pool_frac"], None,
        max_events_per_shard=budget))
    times_c = replay_engine.stage_times()
    got_c = {p: [dataclasses.asdict(r) for r in rs] for p, rs in res_c.items()}
    checks |= {f"c_{p}_equals_reference": got_c[p] == POND_BATCH_WANT[p]
               for p in POND_BATCH_WANT}
    checks["c_batch_is_a_stream_batch"] = isinstance(
        local_batch, CompiledReplayStreamBatch)
    k = local_batch.k
    server2, pool2 = (np.broadcast_to(server, (k, len(server))),
                      np.broadcast_to(pool, (k, len(pool))))
    sgb_i, pgb_i = sweep_core.quantize_capacities(server2, pool2)
    dt = local_batch._pick_state_dtype(sgb_i, pgb_i)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    mono_c = CompiledReplayBatch([
        CompiledReplay(v, cluster_sim._all_local_decisions(v), inp["cfg"])
        for v in inp["vms_list"]])
    mono_ms, mono_rej = _k1_batch_timed(mono_c, sgb_i, pgb_i, np_dt,
                                        clock_mhz)
    run = functools.partial(local_batch._sweep_device, server2, pool2,
                            None, dt, None, False)
    stream_ms = _stream_card_ms(run, clock_mhz)
    compute_ms = _compute_ms(local_batch, run, clock_mhz)
    checks["c_timed_sweep_equals_monolithic"] = (
        local_batch.reject_rates(server, pool)
        * local_batch.n_vms[:, None]).round().astype(int).ravel().tolist() \
        == mono_rej.tolist()
    mem, ok = _stream_memory(
        lambda: local_batch.reject_rates(server, pool, skip_windows=False),
        _k1_fixed_bytes(k * len(server), cfg.n_servers, cfg.n_groups,
                        local_batch._n_slots, item),
        local_batch.peak_shard_bytes)
    checks["c_event_memory_within_2_shards"] = ok
    records.append(_stream_record(
        "c_pond_batch_savings", local_batch, wall_c, stream_ms, compute_ms,
        mono_ms, _reference_s(local_batch.engines), mem,
        vms=local_batch.n_vms.tolist(), events=local_batch.n_events.tolist(),
        lanes=[k, len(server)], state_dtype=dt, results=got_c,
        sweeps=len(times_c.sweeps),
        host_seconds=dict(decisions=times_c.decisions_s,
                          compile=times_c.compile_s,
                          sweeps=times_c.sweep_s)))
    del mono_c

    # (d) the fleet grid and its seed batch on streams
    tin = _topo_inputs()
    cfg_d = tin["cfg"]

    def path_d():
        streams = [CompiledReplayStream(v, dc, cfg_d,
                                        max_events_per_shard=budget)
                   for v, dc in zip(tin["vms_list"], tin["decs"])]
        grid = _topo_grid(float(np.ceil(streams[0].peak_pool_demand())),
                          cfg_d.n_servers,
                          cfg_d.gb_per_core * cfg_d.cores_per_server)
        rates = streams[0].reject_rates_fleet(*grid[:3])
        batch = CompiledReplayStreamBatch(streams).reject_rates_fleet(
            *grid[:3])
        return streams, grid, rates, batch
    (streams_d, grid, rates_d, batch_d), wall_d = main_path(path_d)
    n_vms = np.array([s.n_vms for s in streams_d])
    checks |= {
        "d_single_equals_reference": np.rint(rates_d * n_vms[0]).astype(
            int).tolist() == TOPO_FULL_WANT["single"],
        "d_batch_equals_reference": np.rint(batch_d * n_vms[:, None]).astype(
            int).tolist() == TOPO_FULL_WANT["batch"]}
    sgb, caps, lane_topos = grid[:3]
    st_d = streams_d[0]
    mono_d = CompiledReplay(tin["vms_list"][0], tin["decs"][0], cfg_d)
    from repro_torch.core.replay_engine import (_fleet_candidates,
                                                _fleet_capacities,
                                                _fleet_incidence)
    lanes_d = _fleet_candidates(sgb, caps, lane_topos)
    inc, p_max = _fleet_incidence(lane_topos, cfg_d.n_servers)
    sgb_i, caps_i = _fleet_capacities(*lanes_d[:2])
    dt = st_d._pick_pod_state_dtype(sgb_i, caps_i, p_max)
    np_dt = sweep_core.state_np_dtype(dt)
    item = np.dtype(np_dt).itemsize
    evs, _, n_slots = mono_d._device_events()
    timed = _k4_timed(evs, torch.from_numpy(inc).to(dev), cfg_d.n_servers,
                      cfg_d.cores_per_server, n_slots, sgb_i, caps_i, np_dt,
                      [mono_d.n_events], clock_mhz, reps=3)
    checks["d_timed_sweep_equals_monolithic"] = \
        timed["rejects"].tolist() == np.rint(
            rates_d * n_vms[0]).astype(int).tolist()
    run = functools.partial(st_d._fleet_sweep_device, *lanes_d, None, dt)
    stream_ms = _stream_card_ms(run, clock_mhz)
    compute_ms = _compute_ms(st_d, run, clock_mhz)
    mem, ok = _stream_memory(
        lambda: st_d.reject_rates_fleet(sgb, caps, lane_topos),
        _k4_fixed_bytes(len(sgb), cfg_d.n_servers, p_max, inc.shape[2],
                        st_d._n_slots, item), st_d.peak_shard_bytes)
    checks["d_event_memory_within_2_shards"] = ok
    records.append(_stream_record(
        "d_topo_full_fleet", st_d, wall_d, stream_ms, compute_ms, timed["ms"],
        None, mem, vms=n_vms.tolist(),
        events=[s.n_events for s in streams_d], lanes=len(sgb),
        batch_lanes=[len(streams_d), len(sgb)], state_dtype=dt,
        reference_replay="not on the path: the fleet sweeps skip no "
                         "window"))
    checks["k1_launched"] = launches["k1"] > 0
    checks["k4_launched"] = launches["k4"] > 0
    emit("stream_full", ok=all(checks.values()), checks=checks,
         budget=budget, configs=[r["config"] for r in records],
         k1_launches=launches["k1"], k4_launches=launches["k4"])
    if not all(checks.values()):
        raise SystemExit("stream_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches["k1"], launches["k4"]


# ----------------------- the provisioning surface on trace files (M3b, M1b) --
def _example(name):
    """``examples/<name>.py`` of this checkout, loaded as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha1(rows, dtype):
    import hashlib
    return hashlib.sha1(np.asarray(rows, dtype).tobytes()).hexdigest()


# tests/test_traces_ingest.py's dirty file and the reference's IngestReport
# summary of it (max_bad_rows=3, two rows a chunk)
_DIRTY = ("vmid,arrival,lifetime,cores,mem_gb\n1,0,100,2,4\n2,5,abc,2,4\n"
          "3,10,100,2,4\n4,12,100,0,4\n5,15,100,2,4\n6,20,100,2,-8\n"
          "7,25,100,2,4\n")
_DIRTY_SUMMARY = {"n_quarantined": 3, "io_retries": 0, "bad_rows": [
    {"row": 2, "column": "lifetime", "value": "abc",
     "reason": "is not a finite number"},
    {"row": 4, "column": "cores", "value": "0", "reason": "must be >= 1"},
    {"row": 6, "column": "mem_gb", "value": "-8", "reason": "must be > 0"}]}


def phase_ingest_parity_small(dev):
    """The bundled fixture through ``load_trace_file`` (its schema and
    synthesised columns held to the reference's hashes) and
    ``savings_analysis`` on the card (K1), the ``PolicyResult``s the
    reference's; a copy with 0.25 GB added to every VM, written by
    ``save_trace_csv`` and read back, through ``savings_analysis`` on the
    card with no K1 launch (``"auto"`` takes the numpy backend because the
    decisions are fractional), its results the reference's and its server
    sizes ``use_engine=False``'s; a dirty file quarantined under
    ``max_bad_rows``, its ``IngestReport`` the reference's."""
    import tempfile
    from repro_torch.core import cluster_sim, traces
    from repro_torch.kernels.event_sweep import ops
    cfg = cluster_sim.ClusterConfig(n_servers=4, pool_sockets=4,
                                    gb_per_core=4.0)
    vms = traces.load_trace_file(traces.fixture_trace_path())
    got_hashes = dict(
        n_vms=len(vms),
        schema_sha1=_sha1([[v.arrival, v.lifetime, v.cores, v.mem_gb,
                            v.vm_id, v.customer] for v in vms], np.float64),
        synth_sha1=_sha1([[v.untouched, v.slow182, v.slow222] for v in vms],
                         np.float64),
        pmu_sha1=_sha1(np.stack([v.pmu for v in vms]), np.float32))

    def priced(vms_):
        cache, out = {}, {}
        before = ops.launches
        for policy in ("local", "static"):
            out[policy] = dataclasses.asdict(cluster_sim.savings_analysis(
                vms_, cfg, policy, cache=cache, static_pool_frac=0.25,
                device=dev))
        return out, ops.launches - before, cache["local_engine"]

    res, n_int, _ = priced(vms)
    with tempfile.TemporaryDirectory() as tmp:
        for v in vms:
            v.mem_gb += 0.25
        path = os.path.join(tmp, "fixture_frac.csv")
        traces.save_trace_csv(vms, path)
        frac = traces.load_trace_file(path)
        res_f, n_frac, eng_f = priced(frac)
        scalar = {p: dataclasses.asdict(cluster_sim.savings_analysis(
            frac, cfg, p, static_pool_frac=0.25, use_engine=False))
            for p in ("local", "static")}
        dirty = os.path.join(tmp, "dirty.csv")
        with open(dirty, "w") as f:
            f.write(_DIRTY)
        report = traces.IngestReport(max_bad_rows=3)
        kept = [v.vm_id for ch in traces.iter_trace_chunks(
            dirty, chunk_vms=2, report=report) for v in ch]
    checks = {
        "fixture_columns_equal_reference": got_hashes == FIXTURE_WANT,
        "fixture_results_equal_reference": res == FIXTURE_RESULTS_WANT,
        "k1_launches_on_the_fixture": n_int > 0,
        "fraction_read_back": [v.mem_gb for v in frac]
            == [v.mem_gb for v in vms],
        "fraction_results_equal_reference": res_f == FRACTION_RESULTS_WANT,
        "fraction_scalar_search_equals_reference":
            scalar == FRACTION_SCALAR_WANT,
        "fraction_servers_equal_scalar_search": all(
            res_f[p][k] == scalar[p][k] for p in res_f
            for k in ("server_gb", "baseline_server_gb", "reject_rate")),
        "fraction_no_k1_launch": n_frac == 0,
        "fraction_engine_on_card": eng_f.device.type == "cuda"
            and not eng_f._exact,
        "quarantine_summary_equals_reference":
            report.summary() == _DIRTY_SUMMARY,
        "quarantine_kept_rows": kept == [1, 3, 5, 7]}
    emit("ingest_parity_small", ok=all(checks.values()), checks=checks,
         fixture=got_hashes, results=res, fraction_results=res_f,
         fraction_scalar_results=scalar, k1_launches_fixture=n_int,
         k1_launches_fraction=n_frac, ingest_report=report.summary())
    if not all(checks.values()):
        raise SystemExit("ingest_parity_small failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def _numpy_beside_k1(eng, server, pool, clock_mhz):
    """One ``reject_rates(backend="numpy")`` call on ``eng`` (host seconds)
    beside K1 on the same candidates (its rates, and its device ms by
    ``_k1_timed``)."""
    from repro_torch.core import sweep_core
    t0 = time.perf_counter()
    host = eng.reject_rates(server, pool, backend="numpy")
    host_s = time.perf_counter() - t0
    card = eng.reject_rates(server, pool)
    sgb_i, pgb_i = sweep_core.quantize_capacities(server, pool)
    dt = eng._pick_state_dtype(sgb_i, pgb_i)
    evs, group, n_slots = eng._device_events()
    timed = _k1_timed(evs, group, eng.n_servers, eng.n_groups,
                      eng.cores_per_server, n_slots, sgb_i, pgb_i,
                      sweep_core.state_np_dtype(dt), clock_mhz, reps=3)
    return host, host_s, card, timed["ms"], dt


def phase_ingest_full(dev):
    """Pond's provisioning surface on a trace file at full width
    (``AZURE_FULL``): the stand-in dump written, read back by
    ``iter_trace_chunks`` (VMs/s), decided (static 0.30), streamed from
    its file through ``CompiledReplayStream(decide=)`` (one K1 launch a
    shard, the rates the reference's), the same file loaded whole by
    ``load_trace_file`` into a monolithic engine (one K1 launch, the same
    rates), the streamed sweep's device ms beside the monolithic one's and
    its event memory; then ``PROV_FULL``'s static engine priced at 16
    candidates by the numpy divergence-window backend (host seconds)
    beside K1 (device ms), the same rates.  The stream and the monolithic
    engine run with K1's launch count set to 0 just before and read just
    after.  Returns K1's launches."""
    import shutil
    import tempfile
    from repro_torch.core import cluster_sim, sweep_core, traces
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayStream)
    from repro_torch.kernels.event_sweep import ops
    a = AZURE_FULL
    clock_mhz = float(_smi("clocks.max.sm"))
    cfg = cluster_sim.ClusterConfig(n_servers=a["n_servers"],
                                    pool_sockets=a["pool_sockets"],
                                    gb_per_core=a["gb_per_core"])
    hi = cfg.cores_per_server * 6.0
    server = np.linspace(0.4 * hi, hi, a["n_cand"])
    pool = np.linspace(0.0, 2.0 * hi, a["n_cand"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        path = os.path.join(tmp, "azure_standin.csv.gz")
        t0 = time.perf_counter()
        _example("torch_azure_e2e").synth_dump(path, n_vms=a["n_vms"],
                                               horizon_days=a["days"],
                                               seed=a["seed"])
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vms = [v for ch in traces.iter_trace_chunks(
            path, chunk_vms=a["chunk_vms"]) for v in ch]
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec, _ = cluster_sim.policy_decisions(
            vms, "static", static_pool_frac=a["static_pool_frac"],
            as_arrays=True)
        decisions_s = time.perf_counter() - t0
        n_vms = len(vms)
        del vms
        off = [0]

        def decide(chunk):
            off[0] += len(chunk)
            return dec.slice(off[0] - len(chunk), off[0])

        # the main path: the file-fed stream, then the whole file
        ops.launches = 0
        t0 = time.perf_counter()
        st = CompiledReplayStream(
            traces.iter_trace_chunks(path, chunk_vms=a["chunk_vms"]), None,
            cfg, max_events_per_shard=a["budget"], decide=decide)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rates = st.reject_rates(server, pool)
        stream_sweep_s = time.perf_counter() - t0
        stream_launches = ops.launches
        plan = dataclasses.asdict(ops.last_plan)
        ops.launches = 0
        t0 = time.perf_counter()
        mono_vms = traces.load_trace_file(path)
        load_s = time.perf_counter() - t0
        mono_dec, _ = cluster_sim.policy_decisions(
            mono_vms, "static", static_pool_frac=a["static_pool_frac"],
            as_arrays=True)
        mono = CompiledReplay(mono_vms, mono_dec, cfg)
        mono_rates = mono.reject_rates(server, pool)
        torch.cuda.synchronize()
        mono_launches = ops.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sgb_i, pgb_i = sweep_core.quantize_capacities(server, pool)
    dt = st._pick_state_dtype(sgb_i, pgb_i)
    np_dt = sweep_core.state_np_dtype(dt)
    evs, group, n_slots = mono._device_events()
    mono_ms = _k1_timed(evs, group, cfg.n_servers, cfg.n_groups,
                        cfg.cores_per_server, n_slots, sgb_i, pgb_i, np_dt,
                        clock_mhz, reps=3)["ms"]
    run = functools.partial(st._sweep_device, server, pool, None, dt, None,
                            False)
    stream_ms = _stream_card_ms(run, clock_mhz)
    mem, mem_ok = _stream_memory(
        lambda: st.reject_rates(server, pool, skip_windows=False),
        _k1_fixed_bytes(len(server), cfg.n_servers, cfg.n_groups,
                        st._n_slots, np.dtype(np_dt).itemsize),
        st.peak_shard_bytes)
    del mono, mono_vms, evs, group

    # the non-integral host path at full width: PROV_FULL's static engine,
    # 16 candidates, the numpy backend beside K1 (cut the days until the
    # host call takes at most numpy_limit_s)
    pcfg, pvms, _ = _full_trace()
    lo, hi_s = STREAM_FULL["timed_server"]
    n16 = STREAM_FULL["timed_lanes"]
    server16 = np.linspace(lo, hi_s, n16)
    pool16 = np.linspace(*STREAM_FULL["timed_pool"], n16)
    days = PROV_FULL["days"]
    while True:
        cut = [v for v in pvms if v.arrival < days * 86400]
        pdec, _ = cluster_sim.policy_decisions(
            cut, "static", static_pool_frac=PROV_FULL["static_pool_frac"],
            as_arrays=True)
        peng = CompiledReplay(cut, pdec, pcfg)
        host, host_s, card, k1_ms, np_dtn = _numpy_beside_k1(
            peng, server16, pool16, clock_mhz)
        if host_s <= a["numpy_limit_s"] or days == 1:
            break
        days -= 1
    checks = {
        "stream_rates_equal_reference":
            rates.tolist() == AZURE_FULL_WANT["rates"],
        "stream_equals_monolithic": rates.tolist() == mono_rates.tolist(),
        "events_and_shards": (st.n_events, st.n_shards) == (
            AZURE_FULL_WANT["n_events"], AZURE_FULL_WANT["n_shards"]),
        "all_vms_ingested": st.n_vms == n_vms == a["n_vms"],
        "event_memory_within_2_shards": mem_ok,
        "k1_launches_one_a_shard": stream_launches == st.n_shards,
        "monolithic_one_launch": mono_launches == 1,
        "numpy_equals_k1": host.tolist() == card.tolist(),
        "numpy_within_limit": host_s <= a["numpy_limit_s"]}
    launches = stream_launches + mono_launches
    emit("ingest_full", ok=all(checks.values()), checks=checks,
         config=a, vms=n_vms, events=st.n_events, shards=st.n_shards,
         shard_pad_events=st.shard_pad_events,
         peak_shard_bytes=st.peak_shard_bytes, slots=st._n_slots,
         k1_plan=plan, state_dtype=dt, rates=rates.tolist(),
         host_seconds=dict(write_dump=dump_s, ingest=ingest_s,
                           decisions=decisions_s, stream_build=build_s,
                           stream_sweep=stream_sweep_s,
                           load_trace_file=load_s),
         ingest_vms_per_s=n_vms / ingest_s,
         stream_sweep_ms=stream_ms, monolithic_sweep_ms=mono_ms,
         stream_over_monolithic=stream_ms / mono_ms, memory=mem,
         k1_launches=dict(stream=stream_launches, monolithic=mono_launches),
         numpy_backend=dict(
             config="PROV_FULL static 0.30", days=days,
             days_cut=PROV_FULL["days"] - days, vms=len(cut),
             events=peng.n_events, lanes=n16, host_seconds=host_s,
             k1_device_ms=k1_ms, k1_state_dtype=np_dtn,
             host_over_k1=host_s * 1e3 / k1_ms, rates=host.tolist()))
    if not all(checks.values()):
        raise SystemExit("ingest_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ------------------------------------------- the observability layer (M12) --
def _metric_delta(rec, before):
    """The recorder's metrics since ``before`` (an earlier ``metrics()``):
    counters and span counts and totals as differences."""
    now = rec.metrics()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if isinstance(v, (int, float)) and not k.endswith("_ratio")}


def _counting(fn, box):
    """``fn`` counting its calls into ``box[0]``."""
    def wrapper(*args, **kwargs):
        box[0] += 1
        return fn(*args, **kwargs)
    return wrapper


def phase_obs_full(dev):
    """Pond's observability layer (``core/obs.py``) on the card at full
    width (``OBS_FULL``), one recorder for (a)-(d): (a) one K1 sweep,
    tracing off then on, the rates ``==``, one ``replay.reject_rates``
    span, the launcher cache's misses plus hits = the ``get_sweep`` calls;
    (b) the stream, tracing on then off, both ``==`` the monolithic sweep,
    a ``stream.shard`` and a ``stream.compute`` span a shard swept and a
    K1 launch each, the feed's ``device_put.bytes`` = the bytes staged,
    ``pad.events_*`` = the stream's own, the overlap ratio in [0, 1], the
    streamed sweep's device ms with tracing off and on; (c) pond's
    decisions ``==`` the untraced ones, their four stage spans beside
    ``policy.decisions``; (d) ingestion's counters = the VMs read and
    ceil(n / chunk) chunks.  The Chrome trace is written and read back
    (every ``ts``, ``dur`` >= 0).  K1's launch count is set to 0 just
    before each traced main path and read just after.  Returns K1's
    launches."""
    import math
    import shutil
    import tempfile
    from repro_torch.core import cluster_sim, obs, replay_engine, sweep_core
    from repro_torch.core import traces
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayStream)
    k1, _ = _stream_ops()
    clock_mhz = float(_smi("clocks.max.sm"))
    rec = obs.Recorder()
    checks, out = {}, {}
    launches = 0
    cfg, vms, _ = _full_trace()
    dec, _ = cluster_sim.policy_decisions(
        vms, "static", static_pool_frac=PROV_FULL["static_pool_frac"],
        as_arrays=True)
    lo, hi = STREAM_FULL["timed_server"]
    server = np.linspace(lo, hi, STREAM_FULL["timed_lanes"])
    pool = np.linspace(*STREAM_FULL["timed_pool"], STREAM_FULL["timed_lanes"])
    n0 = len(server)

    # (a) one sweep, tracing off then on
    eng = CompiledReplay(vms, dec, cfg)
    off_a = eng.reject_rates(server, pool)
    calls = [0]
    get_sweep = sweep_core.get_sweep
    sweep_core.get_sweep = _counting(get_sweep, calls)
    before = rec.metrics()
    k1.launches = 0
    try:
        with obs.use_recorder(rec):
            on_a = eng.reject_rates(server, pool)
        torch.cuda.synchronize()
    finally:
        sweep_core.get_sweep = get_sweep
    launches += k1.launches
    m = _metric_delta(rec, before)
    jit = sum(v for k, v in m.items() if k.startswith("jit.sweep.")
              and k.endswith((".miss", ".hit")))
    checks |= {"a_rates_equal": on_a.tolist() == off_a.tolist(),
               "a_one_entry_span": m.get("span.replay.reject_rates.count")
               == 1,
               "a_jit_lookups_equal_get_sweep_calls": jit == calls[0] >= 1,
               "a_one_k1_launch": k1.launches == 1}
    out["a"] = dict(get_sweep_calls=calls[0], jit_lookups=jit,
                    entry_s=m.get("span.replay.reject_rates.total_s"))

    # (b) the stream, tracing on then off
    budget = STREAM_FULL["budget"]
    before = rec.metrics()
    with obs.use_recorder(rec):
        st = CompiledReplayStream(vms, dec, cfg,
                                  max_events_per_shard=budget)
    staged = [0, 0]
    stage = replay_engine._ShardFeed.stage

    def counted_stage(feed, si):
        staged[0] += 1
        staged[1] += feed.host[si % 2].nbytes
        return stage(feed, si)
    replay_engine._ShardFeed.stage = counted_stage
    k1.launches = 0
    try:
        with obs.use_recorder(rec):
            on_b = st.reject_rates(server, pool)
        torch.cuda.synchronize()
    finally:
        replay_engine._ShardFeed.stage = stage
    launches += k1.launches
    launches_b = k1.launches
    off_b = st.reject_rates(server, pool)
    m = _metric_delta(rec, before)
    swept = st.n_shards - m.get("stream.shards_skipped", 0)
    sgb_i, pgb_i = sweep_core.quantize_capacities(server, pool)
    dt = st._pick_state_dtype(sgb_i, pgb_i)
    item = np.dtype(sweep_core.state_np_dtype(dt)).itemsize
    fixed = ((2 * n0 * cfg.n_servers + n0 * cfg.n_groups
              + st._n_slots * n0 + 2 * n0) * item + 4 * n0
             + 4 * cfg.n_servers)       # state, capacities, group map
    feed_bytes = m.get("device_put.bytes", 0) - fixed
    wait_s = m["span.stream.upload_wait.total_s"]
    upload_s = m["span.stream.upload.total_s"]
    ratio = max(0.0, 1.0 - wait_s / upload_s) if upload_s > 0 else None
    checks |= {
        "b_rates_on_equal_off": on_b.tolist() == off_b.tolist(),
        "b_rates_equal_monolithic": on_b.tolist() == off_a.tolist(),
        "b_one_entry_span": m.get("span.stream.reject_rates.count") == 1,
        "b_shard_spans_equal_shards_swept":
            m.get("span.stream.shard.count") == swept == launches_b,
        "b_compute_spans_equal_k1_launches":
            m.get("span.stream.compute.count") == launches_b,
        "b_upload_and_wait_spans_a_shard":
            m.get("span.stream.upload.count")
            == m.get("span.stream.upload_wait.count") == swept,
        "b_feed_bytes_equal_staged": feed_bytes == staged[1] > 0,
        "b_feed_calls_equal_stages":
            m.get("device_put.calls", 0) - 8 == staged[0] == swept,
        "b_pad_events_used": m.get("pad.events_used") == st.n_events,
        "b_pad_events_padded": m.get("pad.events_padded")
            == st.n_shards * st.shard_pad_events - st.n_events,
        "b_overlap_ratio_in_0_1": ratio is not None and 0.0 <= ratio <= 1.0}
    run = functools.partial(st._sweep_device, server, pool, None, dt, None,
                            False)
    ms_off = _stream_card_ms(run, clock_mhz)
    with obs.use_recorder(obs.Recorder()):
        ms_on = _stream_card_ms(run, clock_mhz)
    out["b"] = dict(
        shards=st.n_shards, swept=swept, state_dtype=dt,
        overlap_ratio=ratio, upload_total_s=upload_s,
        upload_wait_total_s=wait_s,
        compute_total_s=m["span.stream.compute.total_s"],
        shard_total_s=m["span.stream.shard.total_s"],
        feed_bytes=feed_bytes, staged_bytes=staged[1],
        device_put_bytes=m.get("device_put.bytes"),
        pad_events_used=m.get("pad.events_used"),
        pad_events_padded=m.get("pad.events_padded"),
        stream_sweep_ms_tracing_off=ms_off, stream_sweep_ms_tracing_on=ms_on,
        tracing_on_over_off=ms_on / ms_off)
    del eng, st

    # (c) pond's decisions for seed 2, traced
    inp = _pond_inputs()
    want_c = _pond_decisions()[0]
    before = rec.metrics()
    with obs.use_recorder(rec):
        t0 = time.perf_counter()
        got_c, _ = cluster_sim.policy_decisions(
            inp["vms_list"][0], "pond",
            _pond_plane(inp["li"], inp["um"], inp["hist"]), as_arrays=True)
        wall_c = time.perf_counter() - t0
    m = _metric_delta(rec, before)
    checks["c_decisions_equal"] = all(
        np.array_equal(getattr(got_c, f), getattr(want_c, f), equal_nan=True)
        for f in ("local_gb", "pool_gb", "fully_pooled", "t_migrate")) \
        and (got_c.mispredictions, got_c.n_mitigations) \
        == (want_c.mispredictions, want_c.n_mitigations)
    stages = {s: m.get(f"span.policy.{s}.total_s") for s in
              ("decisions", "decide", "place", "monitor", "mitigate")}
    checks["c_stage_spans_once"] = all(
        m.get(f"span.policy.{s}.count") == 1 for s in stages)
    out["c"] = dict(vms=len(inp["vms_list"][0]), wall_s=wall_c,
                    stage_s=stages,
                    stages_over_decisions=sum(
                        v for k, v in stages.items() if k != "decisions")
                    / stages["decisions"])

    # (d) ingestion of a 50,000-VM cut of AZURE_FULL's dump
    a = AZURE_FULL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        path = os.path.join(tmp, "azure_standin.csv.gz")
        _example("torch_azure_e2e").synth_dump(
            path, n_vms=OBS_FULL["ingest_vms"], horizon_days=a["days"],
            seed=a["seed"])
        before = rec.metrics()
        t0 = time.perf_counter()
        with obs.use_recorder(rec):
            n = sum(len(ch) for ch in traces.iter_trace_chunks(
                path, chunk_vms=a["chunk_vms"]))
        ingest_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m = _metric_delta(rec, before)
    chunks = math.ceil(n / a["chunk_vms"])
    checks |= {"d_vms_read": n == OBS_FULL["ingest_vms"],
               "d_ingest_vms": m.get("ingest.vms") == n,
               "d_ingest_rows": m.get("ingest.rows") == n,
               "d_ingest_chunks": m.get("ingest.chunks") == chunks,
               "d_chunk_spans": m.get("span.ingest.chunk.count")
               == chunks + 1}
    out["d"] = dict(vms=n, chunks=chunks, wall_s=ingest_s,
                    vms_per_s=n / ingest_s,
                    chunk_total_s=m.get("span.ingest.chunk.total_s"),
                    chunk_mean_ms=m.get("span.ingest.chunk.total_s", 0)
                    * 1e3 / chunks)

    # the Chrome trace of (a)-(d)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, OBS_FULL["trace_file"])
    rec.to_chrome_trace(trace_path, manifest=obs.run_manifest())
    with open(trace_path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    checks["trace_parses_ts_dur_nonnegative"] = bool(evs) and all(
        e["ts"] >= 0 and e["dur"] >= 0 for e in evs)
    checks["k1_launched"] = launches > 0
    emit("obs_full", ok=all(checks.values()), checks=checks, **out,
         trace_events=len(evs), trace_file=os.path.relpath(
             trace_path, os.path.dirname(os.path.abspath(__file__))),
         manifest=doc["metadata"]["manifest"], k1_launches=launches)
    if not all(checks.values()):
        raise SystemExit("obs_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ---------------------------------------------- devices= on the engines --
def _devices_calls(dev):
    """``DEVICES_FULL``'s eight engine calls, each a function of
    ``devices``: ``CompiledReplay`` (PROV_FULL's static engine on trace
    seed 2) and ``CompiledReplayBatch`` (TOPO_FULL's three traces), their
    streams at the stream budget; ``reject_rates`` at 16 lanes on the row,
    ``reject_rates_fleet`` at TOPO_FULL's 192-lane grid.  Returns (calls,
    engines)."""
    from repro_torch.core import cluster_sim
    from repro_torch.core.replay_engine import (CompiledReplay,
                                                CompiledReplayBatch,
                                                CompiledReplayStream,
                                                CompiledReplayStreamBatch)
    inp = _topo_inputs()
    cfg, vms2, _ = _full_trace()
    dec2 = cluster_sim.policy_decisions(
        vms2, "static", static_pool_frac=PROV_FULL["static_pool_frac"],
        as_arrays=True)[0]
    budget = DEVICES_FULL["budget"]
    eng = CompiledReplay(vms2, dec2, cfg, device=dev)
    stream = CompiledReplayStream(vms2, dec2, cfg, device=dev,
                                  max_events_per_shard=budget)
    batch = CompiledReplayBatch([
        CompiledReplay(v, d, cfg, device=dev)
        for v, d in zip(inp["vms_list"], inp["decs"])])
    sbatch = CompiledReplayStreamBatch([
        CompiledReplayStream(v, d, cfg, device=dev,
                             max_events_per_shard=budget)
        for v, d in zip(inp["vms_list"], inp["decs"])])
    sgb = np.linspace(*DEVICES_FULL["server"], DEVICES_FULL["lanes"])
    pgb = np.linspace(*DEVICES_FULL["pool"], DEVICES_FULL["lanes"])
    grid = _topo_grid(float(np.ceil(batch.engines[0].peak_pool_demand())),
                      cfg.n_servers, cfg.gb_per_core * cfg.cores_per_server)
    fsgb, fcaps, ftopos = grid[:3]
    calls = {
        "replay.reject_rates": lambda d: eng.reject_rates(
            sgb, pgb, devices=d),
        "replay.fleet": lambda d: eng.reject_rates_fleet(
            fsgb, fcaps, ftopos, devices=d),
        "batch.reject_rates": lambda d: batch.reject_rates(
            sgb, pgb, devices=d),
        "batch.fleet": lambda d: batch.reject_rates_fleet(
            fsgb, fcaps, ftopos, devices=d),
        "stream.reject_rates": lambda d: stream.reject_rates(
            sgb, pgb, devices=d),
        "stream.fleet": lambda d: stream.reject_rates_fleet(
            fsgb, fcaps, ftopos, devices=d),
        "stream_batch.reject_rates": lambda d: sbatch.reject_rates(
            sgb, pgb, devices=d),
        "stream_batch.fleet": lambda d: sbatch.reject_rates_fleet(
            fsgb, fcaps, ftopos, devices=d),
    }
    return calls, (eng, batch, stream, sbatch)


def phase_devices_full(dev):
    """``devices=`` on every Pond engine (M13) at full width
    (``DEVICES_FULL``): each of the eight calls of :func:`_devices_calls`
    without ``devices``, then with ``devices="all"`` and ``devices=1``,
    K1's and K4's launch counts set to 0 before each call and read after;
    every result ``==`` the call without ``devices`` and, where ``"all"``
    resolves to one card, the launch counts equal; then with
    ``devices=[card, card]``, the split path on this one card (two pieces,
    each its own launches): ``==`` too.  With two or more cards
    the split also runs and is timed beside one card (best of 3, host clock
    around the call and its read-back).  Returns (K1 launches, K4
    launches) of the calls without ``devices``."""
    from repro_torch.core import sweep_core
    k1, k4 = _stream_ops()
    t0 = time.perf_counter()
    calls, engines = _devices_calls(dev)
    build_s = time.perf_counter() - t0
    n_cards = torch.cuda.device_count()
    split = sweep_core.resolve_devices("all", dev)
    checks, rows = {}, []
    totals = {"k1": 0, "k4": 0}

    def counted(fn, devices):
        k1.launches = k4.launches = 0       # just before the path ...
        t = time.perf_counter()
        out = fn(devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return out, (k1.launches, k4.launches), wall   # ... read after it

    for name, fn in calls.items():
        base, n_base, wall = counted(fn, None)
        totals["k1"] += n_base[0]
        totals["k4"] += n_base[1]
        row = dict(call=name, lanes=int(np.asarray(base).shape[-1]),
                   launches_k1_k4=list(n_base), wall_s=wall)
        for devices in ("all", 1):
            got, n_got, w = counted(fn, devices)
            key = f"{name} devices={devices!r}"
            checks[f"{key} =="] = np.array_equal(got, base)
            if devices == 1 or split is None:
                checks[f"{key} launches"] = n_got == n_base
            row[f"devices={devices}"] = dict(launches_k1_k4=list(n_got),
                                             wall_s=w)
        # the split path itself on this card: a list that repeats it
        # counts as two devices, each piece one launch of its own
        got, n_got, w = counted(fn, [dev, dev])
        checks[f"{name} devices=[card, card] =="] = np.array_equal(got, base)
        checks[f"{name} devices=[card, card] launches"] = \
            n_got[0] + n_got[1] > n_base[0] + n_base[1]
        row["devices=[card, card]"] = dict(launches_k1_k4=list(n_got),
                                           wall_s=w)
        if split is not None:
            one = min(counted(fn, None)[2] for _ in range(3))
            many = min(counted(fn, "all")[2] for _ in range(3))
            row["split"] = dict(cards=len(split), one_card_s=one,
                                split_s=many, speedup=one / many)
        rows.append(row)
    checks["some_k1_and_k4_launches"] = totals["k1"] > 0 and totals["k4"] > 0
    emit("devices_full", ok=all(checks.values()), checks=checks,
         config=dict(DEVICES_FULL, n_servers=PROV_FULL["n_servers"],
                     days=PROV_FULL["days"], traces=TOPO_FULL["seeds"]),
         cards=n_cards,
         all_resolves_to=("the single-device path" if split is None
                          else [str(d) for d in split]),
         engines_build_s=build_s, calls=rows, launches_k1=totals["k1"],
         launches_k4=totals["k4"])
    if not all(checks.values()):
        raise SystemExit("devices_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    del calls, engines
    return totals["k1"], totals["k4"]


# -------------------------------------------------- the training path --
def _train_parity_model(cfg, device, dtype, init):
    """The port's model for ``cfg`` on ``device`` holding ``init`` (a
    name -> CPU tensor dict, cast to ``dtype`` or the declared dtypes)."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as rt
    model = build_model(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    return model, rt.train_params(model)


def phase_train_parity_small(dev):
    """The training path card vs CPU on qwen2-1.5b's smoke config
    (``TRAIN_SMALL``), from the same seeded parameters and batch: the loss
    and every gradient (2 microbatches) at fp32 tolerances with fp32
    parameters and at bf16 tolerances with the declared bf16 weights; one
    AdamW step on each side fed the same (the CPU's) gradients, parameters,
    master and moments at ``TRAIN_SMALL["adamw"]`` (bf16 weights at the
    bf16 tolerance); then on the card the two-phase step (pool tier
    pinned) ``torch.equal`` the fused step's parameters and loss."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import DataConfig, ShardedBatches
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    cfg = get_smoke("qwen2-1.5b")
    src = build_model(cfg, device="cpu", dtype=torch.float32)
    src.init_params(torch.Generator().manual_seed(TRAIN_SMALL["seed"]))
    init = {n: p.detach().clone() for n, p in src.named_parameters()}
    toks = torch.from_numpy(ShardedBatches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SMALL["seq_len"],
        global_batch=TRAIN_SMALL["global_batch"])).batch_at(0)["tokens"])
    ocfg = adamw.AdamWConfig(lr=TRAIN_SMALL["lr"], warmup_steps=1)
    mb = TRAIN_SMALL["microbatches"]
    checks, errs = {}, {}

    def compare(label, got, want, rtol, atol):
        worst, ok = 0.0, True
        for n, w in want.items():
            g = got[n].detach().float().cpu()
            w = w.detach().float().cpu()
            ok &= bool(torch.allclose(g, w, rtol=rtol, atol=atol))
            worst = max(worst, float((g - w).abs().max()))
        checks[label] = ok
        errs[label] = worst

    for label, dtype, tol in (("fp32", torch.float32, TRAIN_SMALL["fp32"]),
                              ("bf16", None, TRAIN_SMALL["bf16"])):
        out = []
        for where in (torch.device("cpu"), dev):
            model, params = _train_parity_model(cfg, where, dtype, init)
            grads, m = rt.grads_fn(model, params,
                                   {"tokens": toks.to(where)}, ShardCtx(),
                                   mb)
            out.append((params, grads, float(m["loss"])))
        (p_cpu, g_cpu, l_cpu), (p_card, g_card, l_card) = out
        checks[f"{label} loss"] = bool(np.isclose(l_card, l_cpu,
                                                  rtol=tol[0], atol=tol[1]))
        errs[f"{label} loss card, cpu"] = [l_card, l_cpu]
        compare(f"{label} grads", g_card, g_cpu, *tol)
        opts = []
        for params in (p_cpu, p_card):
            opts.append(adamw.init_state(params, ocfg))
            adamw.apply_updates(params, opts[-1],
                                {n: g.to(params[n].device)
                                 for n, g in g_cpu.items()}, ocfg)
        ptol = TRAIN_SMALL["adamw"] if dtype is not None else tol
        compare(f"{label} adamw params", p_card, p_cpu, *ptol)
        for g in ("master", "m", "v"):
            compare(f"{label} adamw {g}", opts[1][g], opts[0][g],
                    *TRAIN_SMALL["adamw"])
    # the two steps on the card, the pool tier pinned: the same parameters
    model, params = _train_parity_model(cfg, dev, None, init)
    after = {}
    for two_phase in (False, True):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        opt = launch_train.init_opt_state(params, ocfg, two_phase, dev)
        step = launch_train.make_step(model, ocfg, ShardCtx(),
                                      two_phase=two_phase, microbatches=mb)
        _, opt, m = step(params, opt, {"tokens": toks.to(dev)})
        after[two_phase] = ({n: p.detach().clone() for n, p in
                             params.items()}, float(m["loss"]))
        if two_phase:
            checks["two_phase pool tier pinned"] = all(
                t.device.type == "cpu" and t.is_pinned()
                for t in _pool_tensors(opt))
    checks["two_phase loss == fused"] = after[True][1] == after[False][1]
    checks["two_phase params == fused"] = all(
        torch.equal(after[True][0][n], after[False][0][n]) for n in params)
    emit("train_parity_small", ok=all(checks.values()), checks=checks,
         config=dict(TRAIN_SMALL, arch=cfg.name), max_abs_err=errs)
    if not all(checks.values()):
        raise SystemExit("train_parity_small failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def _pool_tensors(opt):
    from repro_torch.core.znuma import tree_tensors
    return [t for g in ("master", "m", "v") for t in tree_tensors(opt[g])]


def _tier_account(opt):
    from repro_torch.core.znuma import TierAccount
    from repro_torch.optim import adamw
    acct = TierAccount()
    for g, tier in adamw.state_tier(opt).items():
        acct.add(opt[g], tier)
    return acct


def _counted_call(fn, args, box):
    """``fn(*args)`` under the op counter (``launch/op_analysis.py``), the
    card's memory read around it: ``box`` gets the counts, the bytes
    allocated before the call and the call's peak (the peak reset just
    before it)."""
    from repro_torch.launch import op_analysis
    torch.cuda.synchronize()
    box["allocated_before"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with op_analysis.OpCounter() as c:
        out = fn(*args)
    torch.cuda.synchronize()
    box["peak"] = torch.cuda.max_memory_allocated()
    box["counts"] = c.counts
    return out


def _count_first_call(fn, box):
    """``fn`` whose first call runs under ``_counted_call``."""
    def wrapper(*args):
        if "counts" not in box:
            return _counted_call(fn, args, box)
        return fn(*args)
    return wrapper


def _train_run(model, params, init, ocfg, two_phase, steps, dev, *,
               snapshot_after=None, count_box=None):
    """One run of ``launch/train.py``'s loop from ``init`` (host tensors):
    the state built as the trainer builds it, the peak device memory reset
    just before the loop (the first step's record carries the state's
    build seconds).  With ``count_box`` the first step runs under the op
    counter (``_count_first_call``).  Returns (metrics, opt, the step, the
    data, peak bytes, the parameters after ``snapshot_after`` steps on the
    host, or None)."""
    from repro_torch.data.pipeline import DataConfig, ShardedBatches
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.rules import ShardCtx
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(init[n])
    t0 = time.perf_counter()
    opt = launch_train.init_opt_state(params, ocfg, two_phase, dev)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    step = launch_train.make_step(
        model, ocfg, ShardCtx(), two_phase=two_phase,
        microbatches=TRAIN_FULL["microbatches"],
        xent_chunk=TRAIN_FULL["xent_chunk"])
    if count_box is not None:
        step = _count_first_call(step, count_box)
    data = ShardedBatches(DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=TRAIN_FULL["seq_len"],
        global_batch=TRAIN_FULL["global_batch"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, snap = [], None
    for lo, hi in ([(0, snapshot_after), (snapshot_after, steps)]
                   if snapshot_after else [(0, steps)]):
        metrics += launch_train.train_loop(model, params, opt, step, data,
                                           lo, hi, log_every=1)
        if snapshot_after and hi == snapshot_after:
            snap = {n: p.detach().to("cpu", copy=True)
                    for n, p in params.items()}
    torch.cuda.synchronize()
    metrics[0]["state_build_s"] = state_s
    return metrics, opt, step, data, torch.cuda.max_memory_allocated(), snap


def _train_flops(cfg, tokens, seq):
    """FLOPs of one training step from the shapes: 6 a parameter a token
    for the products (forward 2, backward 4) over every weight matrix and
    the tied head, plus the attention products the blocked core computes
    (every (query, key) pair of each block it visits: the whole square,
    causal or not; 4 FLOPs of D a pair and head forward, 10 backward: the
    recomputed scores, dV, dP, dQ, dK)."""
    n_mat = cfg.num_layers * (cfg.d_model * cfg.head_dim
                              * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
                              + 3 * cfg.d_model * cfg.d_ff)
    head = cfg.d_model * cfg.vocab_size
    products = 6 * (n_mat + head) * tokens
    pairs = tokens * seq                                # every block visited
    attn = cfg.num_layers * pairs * cfg.num_heads * cfg.head_dim * (4 + 10)
    return products, attn


def phase_train_full(dev):
    """The training path at full width (``TRAIN_FULL``: qwen2-1.5b's first
    14 layers, d_model 1536, the padded 151,936 vocabulary, bf16 parameters
    from a seeded init) through ``launch/train.py``'s loop on
    ``ShardedBatches`` at 8 x 2,048 tokens, 2 microbatches, xent chunk
    512, remat off: (a) 2 fused steps, (b) 2 two-phase steps with fp32
    moments in pinned host memory, (c) 2 two-phase steps with int8
    moments, from the same parameters.  Hard checks: finite losses and
    grad norms, step 1's loss ``==`` in (a) and (b), the parameters after
    step 1 ``torch.equal``, every pool-tier tensor of (b) and (c) pinned
    on the host, (b)'s peak device memory below (a)'s by at least the pool
    tier less twice the largest parameter's share of it.  Then a
    checkpoint round trip at a 2-layer cut of the same width (the traced
    two-phase step that followed it until PR 32 is cut)."""
    import shutil

    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime import train as rt
    t_phase = time.perf_counter()
    cfg = _cut(get_config(TRAIN_FULL["arch"]), TRAIN_FULL["layers"])
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(
        TRAIN_FULL["seed"]))
    params = rt.train_params(model)
    init = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    ocfg = adamw.AdamWConfig(lr=TRAIN_FULL["lr"], warmup_steps=20,
                             total_steps=TRAIN_FULL["steps_fused"])
    icfg = dataclasses.replace(ocfg, moments_dtype="int8")
    runs = {}
    # (a) fused, the state on the card; its first step counted by the op
    # counter for dryrun_full (the counter's host work slows that step,
    # which the steady figures leave out)
    counted = {}
    m_a, opt_a, _, _, peak_a, snap_a = _train_run(
        model, params, init, ocfg, False, TRAIN_FULL["steps_fused"], dev,
        snapshot_after=1, count_box=counted)
    acct_a = _tier_account(opt_a)
    del opt_a
    torch.cuda.empty_cache()
    # (b) two-phase, fp32 moments pinned beside the card
    m_b, opt_b, _, _, peak_b, snap_b = _train_run(
        model, params, init, ocfg, True, TRAIN_FULL["steps_two_phase"], dev,
        snapshot_after=1)
    acct_b = _tier_account(opt_b)
    pinned_b = all(t.device.type == "cpu" and t.is_pinned()
                   for t in _pool_tensors(opt_b))
    largest = max(params.values(), key=lambda p: p.numel())
    largest_pool = largest.numel() * 12          # fp32 master + m + v
    del opt_b
    torch.cuda.empty_cache()
    # (c) two-phase, int8 moments
    m_c, opt_c, _, _, peak_c, _ = _train_run(
        model, params, init, icfg, True, TRAIN_FULL["steps_int8"], dev)
    acct_c = _tier_account(opt_c)
    pinned_c = all(t.device.type == "cpu" and t.is_pinned()
                   for t in _pool_tensors(opt_c))
    del opt_c
    torch.cuda.empty_cache()
    for name, m in (("a_fused", m_a), ("b_two_phase", m_b),
                    ("c_two_phase_int8", m_c)):
        runs[name] = m
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                 for m in runs.values() for r in m)
    margin = acct_b.pool_bytes - 2 * largest_pool
    checks = {
        "losses_and_grad_norms_finite": finite,
        "step1_loss_fused_eq_two_phase": m_a[0]["loss"] == m_b[0]["loss"],
        "step1_params_fused_eq_two_phase": all(
            torch.equal(snap_a[n], snap_b[n]) for n in params),
        "pool_tier_pinned_b": pinned_b,
        "pool_tier_pinned_c": pinned_c,
        "peak_b_below_a_by_the_pool_tier": peak_a - peak_b >= margin,
        "pool_bytes_moved_each_way": all(
            r["opt_bytes_in"] == r["opt_bytes_out"] == acct.pool_bytes
            for m, acct in ((m_b, acct_b), (m_c, acct_c)) for r in m),
    }
    del snap_a, snap_b
    tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq_len"]
    products, attn = _train_flops(cfg, tokens, TRAIN_FULL["seq_len"])
    host_gbps = TRAIN_FULL["host_link_gbps"]

    def steady(m, key):
        vals = [r[key] for r in m[1:]] or [m[0][key]]
        return statistics.mean(vals)

    step_ms = {k: steady(m, "step_ms") for k, m in runs.items()}
    opt_ms = {k: steady(runs[k], "opt_ms")
              for k in ("b_two_phase", "c_two_phase_int8")}
    # the checkpoint round trip at a 2-layer cut of the same width
    cut = dataclasses.replace(cfg, num_layers=2, groups=(
        LayerGroup(2, cfg.groups[0].blocks),))
    small = build_model(cut, device=dev)
    small.init_params(torch.Generator(device=dev).manual_seed(1))
    sp = rt.train_params(small)
    sopt = adamw.init_state(sp, icfg)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_full_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(path, 1, (sp, sopt))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore(path, 1, (sp, sopt))
    restore_s = time.perf_counter() - t0
    checks["checkpoint_round_trip_equal"] = all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(ckpt._leaves((sp, sopt)), ckpt._leaves(back)))
    ckpt.corrupt_leaf(path, 1, 0)
    try:
        ckpt.restore(path, 1, (sp, sopt))
        checks["checkpoint_corruption_raises"] = False
    except IOError:
        checks["checkpoint_corruption_raises"] = True
    ckpt_bytes = sum(os.path.getsize(os.path.join(path, "step_00000001", f))
                     for f in os.listdir(os.path.join(path,
                                                      "step_00000001")))
    shutil.rmtree(path, ignore_errors=True)
    del small, sp, sopt, back
    torch.cuda.empty_cache()
    emit("train_full", ok=all(checks.values()), checks=checks,
         config=dict(TRAIN_FULL, layers=cfg.num_layers,
                     d_model=cfg.d_model, heads=[cfg.num_heads,
                                                 cfg.num_kv_heads],
                     head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                     vocab=cfg.vocab_size, params=n_params),
         steps=runs,
         ms_a_step=step_ms,
         tokens_per_s={k: tokens / (v / 1e3) for k, v in step_ms.items()},
         opt_step_ms=opt_ms,
         opt_bytes_each_way={"b": acct_b.pool_bytes, "c": acct_c.pool_bytes},
         opt_gb_per_s_each_way={
             "b": acct_b.pool_bytes / (opt_ms["b_two_phase"] / 1e3) / 1e9,
             "c": acct_c.pool_bytes / (opt_ms["c_two_phase_int8"] / 1e3)
             / 1e9},
         peak_device_bytes={"a": peak_a, "b": peak_b, "c": peak_c},
         peak_difference_a_minus_b=peak_a - peak_b,
         peak_margin_required=margin,
         tier_account={k: dict(local=a.local_bytes, pool=a.pool_bytes,
                               pool_fraction=a.pool_fraction)
                       for k, a in (("a", acct_a), ("b", acct_b),
                                    ("c", acct_c))},
         floors=dict(
             step_flops_products=products, step_flops_attention=attn,
             step_ms_at_989_tflops_bf16=(products + attn) / 989e12 * 1e3,
             opt_ms_b_at_host_link=acct_b.pool_bytes
             / (host_gbps * 1e9) * 1e3,
             host_link_gb_per_s_assumed=host_gbps),
         checkpoint=dict(cut_layers=2, bytes=ckpt_bytes, save_s=save_s,
                         restore_s=restore_s),
         phase_s=time.perf_counter() - t_phase)
    del model, params, init
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit("train_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    counted.update(
        cfg=cfg, batch=TRAIN_FULL["global_batch"],
        seq=TRAIN_FULL["seq_len"], microbatches=TRAIN_FULL["microbatches"],
        xent_chunk=TRAIN_FULL["xent_chunk"], remat=False,
        accum=torch.float32, ocfg=ocfg, tokens=tokens,
        step_ms=[r["step_ms"] for r in m_a[1:]])
    return counted


# ------------------------------------------------- training the families --
# Phase train_families_parity_small: each family's smoke config (granite's
# MoE, mamba2's SSD, jamba's hybrid, deepseek's MLA with its MTP head,
# whisper's encoder-decoder, internvl2's patch rows), seeded fp32
# parameters (CPU generator), B 4 x 12 positions from a numpy seed (whisper:
# 12 encoder frames and 12 decoder tokens; internvl2: its patch rows
# first), 2 microbatches, lr 1e-2: one fused step on the card and on the
# CPU.  The loss, the grad norm and the first moment (0.1 x the clipped
# gradient) at TRAIN_SMALL's fp32 tolerance; the parameters there wherever
# |m| > m_floor and within the update's bound (2 lr) elsewhere: the step-1
# update is lr g / (|g| + eps), whose sign a gradient within its tolerance
# of 0 takes from its rounding (tests/test_torch_train_families.py).  Then
# on the card the two-phase step (pool tier pinned) torch.equal the fused.
TRAIN_FAMILIES_SMALL = dict(seed=0, batch=4, seq=12, microbatches=2,
                            lr=1e-2, m_floor=1e-5)
TRAIN_FAMILY_ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b",
                      "jamba-1.5-large-398b", "deepseek-v3-671b",
                      "whisper-small", "internvl2-26b")
# Phase train_families_full: configs/one_card.py's TRAIN_RUNS at published
# widths (granite, mamba2 and whisper whole; internvl2's first 4 layers;
# deepseek's first dense MLA layer with its MTP head), bf16 parameters from
# a seeded init on the card, remat on, 2 microbatches, the trainer's AdamW
# defaults (lr 3e-3, 20 warmup steps): 2 fused steps, and
# for deepseek (the reference's plan: two_phase, bf16 accumulation) 1
# two-phase step (2 until PR 33) from the same parameters.  Text from
# ShardedBatches, frames and patch rows
# from a seeded generator on the card (N(0, 0.02^2), bf16).
TRAIN_FAMILIES_FULL = dict(seed=0, microbatches=2, lr=3e-3, warmup_steps=20,
                           steps_fused=2, steps_two_phase=1)


def _family_batch_shapes(cfg, batch, seq):
    """The train batch's leaves as (shape, dtype): ``launch/dryrun.py``'s
    ``train_batch`` on meta."""
    from repro_torch.launch.dryrun import train_batch
    return {k: (tuple(v.shape), v.dtype)
            for k, v in train_batch(cfg, batch, seq).items()}


def _seeded_batch(cfg, batch, seq, seed, embed_dtype):
    """A small train batch on the host: numpy-seeded tokens and
    embeddings (N(0, 0.05^2))."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in _family_batch_shapes(cfg, batch, seq).items():
        if k == "tokens":
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, shape, dtype=np.int32))
        else:
            out[k] = torch.from_numpy((rng.standard_normal(shape) * 0.05)
                                      .astype(np.float32)).to(embed_dtype)
    return out


def _family_batches(cfg, batch, seq, n, dev, seed=0):
    """``n`` full-width train batches on the card: text from
    ShardedBatches, frames or patch rows from a seeded generator."""
    from repro_torch.data.pipeline import DataConfig, ShardedBatches
    shapes = _family_batch_shapes(cfg, batch, seq)
    (b, t1), _ = shapes["tokens"]
    data = ShardedBatches(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=t1 - 1, global_batch=b))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i in range(n):
        one = {"tokens": torch.from_numpy(data.batch_at(i)["tokens"]).to(
            dev)}
        if "embeds" in shapes:
            shape, dt = shapes["embeds"]
            one["embeds"] = (torch.randn(shape, generator=gen, device=dev)
                             * 0.02).to(dt)
        out.append(one)
    return out


def phase_train_families_parity_small(dev):
    """Each family's training step card vs CPU on its smoke config
    (``TRAIN_FAMILIES_SMALL``), then the two-phase step against the fused
    one on the card."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import ShardCtx
    cfg_s = TRAIN_FAMILIES_SMALL
    rtol, atol = TRAIN_SMALL["fp32"]
    ocfg = adamw.AdamWConfig(lr=cfg_s["lr"], warmup_steps=1)
    cpu = torch.device("cpu")
    checks, errs = {}, {}
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = get_smoke(arch)
        src = build_model(cfg, device="cpu", dtype=torch.float32)
        src.init_params(torch.Generator().manual_seed(cfg_s["seed"]))
        init = {n: p.detach().clone() for n, p in src.named_parameters()}
        batch = _seeded_batch(cfg, cfg_s["batch"], cfg_s["seq"],
                              cfg_s["seed"] + 1, torch.float32)
        out = {}
        for label, where, two_phase in (("cpu", cpu, False),
                                        ("card", dev, False),
                                        ("card two_phase", dev, True)):
            model, params = _train_parity_model(cfg, where, torch.float32,
                                                init)
            opt = launch_train.init_opt_state(params, ocfg, two_phase, where)
            step = launch_train.make_step(
                model, ocfg, ShardCtx(), two_phase=two_phase,
                microbatches=cfg_s["microbatches"])
            _, opt, m = step(params, opt, {k: v.to(where)
                                           for k, v in batch.items()})
            out[label] = dict(
                params={n: p.detach().cpu() for n, p in params.items()},
                m={n: t.detach().cpu() for n, t in opt["m"].items()},
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                pinned=(all(t.device.type == "cpu" and t.is_pinned()
                            for t in _pool_tensors(opt)) if two_phase
                        else None))
        c, g, t = out["cpu"], out["card"], out["card two_phase"]
        checks[f"{arch} loss"] = bool(np.isclose(g["loss"], c["loss"],
                                                 rtol=rtol, atol=atol))
        checks[f"{arch} grad_norm"] = bool(np.isclose(
            g["grad_norm"], c["grad_norm"], rtol=rtol, atol=atol))
        ok_m = ok_p = True
        worst_m = worst_p = worst_free = 0.0
        for n in c["params"]:
            ok_m &= bool(torch.allclose(g["m"][n], c["m"][n], rtol=rtol,
                                        atol=atol))
            worst_m = max(worst_m, float((g["m"][n] - c["m"][n]).abs()
                                         .max()))
            sure = c["m"][n].abs() > cfg_s["m_floor"]
            d = (g["params"][n] - c["params"][n]).abs()
            ok_p &= bool(torch.allclose(g["params"][n][sure],
                                        c["params"][n][sure], rtol=rtol,
                                        atol=atol))
            ok_p &= bool(d.max() <= 2 * cfg_s["lr"])
            worst_p = max(worst_p, float(d[sure].max()) if sure.any()
                          else 0.0)
            worst_free = max(worst_free, float(d.max()))
        checks[f"{arch} first moment"] = ok_m
        checks[f"{arch} params"] = ok_p
        checks[f"{arch} two_phase loss == fused"] = t["loss"] == g["loss"]
        checks[f"{arch} two_phase params == fused"] = all(
            torch.equal(t["params"][n], g["params"][n]) for n in g["params"])
        checks[f"{arch} two_phase pool tier pinned"] = t["pinned"]
        errs[arch] = dict(loss_card_cpu=[g["loss"], c["loss"]],
                          grad_norm_card_cpu=[g["grad_norm"],
                                              c["grad_norm"]],
                          m=worst_m, params_where_m_gt_floor=worst_p,
                          params_anywhere=worst_free)
    emit("train_families_parity_small", ok=all(checks.values()),
         checks=checks, config=dict(TRAIN_FAMILIES_SMALL,
                                    tol=TRAIN_SMALL["fp32"],
                                    archs=TRAIN_FAMILY_ARCHS),
         max_abs_err=errs)
    if not all(checks.values()):
        raise SystemExit("train_families_parity_small failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def _train_family_full(arch, dev, count_box=None):
    """One family's training run on the card (``TRAIN_RUNS[arch]``,
    ``TRAIN_FAMILIES_FULL``).  Returns (record, checks)."""
    from repro_torch.configs.one_card import TRAIN_RUNS, one_card_train_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    t_run = time.perf_counter()
    run, full = TRAIN_RUNS[arch], TRAIN_FAMILIES_FULL
    cfg = one_card_train_config(arch)
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(full["seed"]))
    params = rt.train_params(model)
    n_params = sum(p.numel() for p in params.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    two_phase = run.get("two_phase", False)
    accum = getattr(torch, run["accum"])
    ocfg = adamw.AdamWConfig(lr=full["lr"], warmup_steps=full["warmup_steps"],
                             total_steps=full["steps_fused"])
    ctx = ShardCtx(remat=True)
    batches = _family_batches(cfg, run["batch"], run["seq"],
                              full["steps_fused"], dev)
    tokens = sum(int(t.numel()) for k, t in batches[0].items()
                 if k == "tokens") - run["batch"]      # the loss's targets
    positions = tokens + (batches[0]["embeds"].shape[0]
                          * batches[0]["embeds"].shape[1]
                          if "embeds" in batches[0] else 0)

    def steps(two, n, box=None):
        opt = launch_train.init_opt_state(params, ocfg, two, dev)
        step = launch_train.make_step(
            model, ocfg, ctx, two_phase=two,
            microbatches=full["microbatches"], xent_chunk=run["xent_chunk"],
            accum_dtype=accum)
        if box is not None:
            step = _count_first_call(step, box)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs, snap = [], None
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, m = step(params, opt, batches[i])
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec = dict(loss=loss, grad_norm=float(m["grad_norm"]),
                       step_ms=(time.perf_counter() - t0) * 1e3)
            for k in ("grad_ms", "opt_ms", "opt_bytes_in", "opt_bytes_out"):
                if k in m:
                    rec[k] = m[k]
            recs.append(rec)
            if i == 0 and two_phase:
                # on the card: the host holds the pool tier
                snap = {k: p.detach().clone() for k, p in params.items()}
        peak = torch.cuda.max_memory_allocated()
        pinned = (all(t.device.type == "cpu" and t.is_pinned()
                      for t in _pool_tensors(opt)) if two else None)
        del opt
        torch.cuda.empty_cache()
        return recs, peak, snap, pinned

    fused, peak_f, snap_f, _ = steps(False, full["steps_fused"], count_box)
    rec = dict(arch=arch, layers=cfg.num_layers, params=n_params,
               param_bytes=param_bytes, batch=run["batch"], seq=run["seq"],
               xent_chunk=run["xent_chunk"], accum=run["accum"],
               tokens=tokens, positions=positions,
               fused=fused, peak_gb_fused=peak_f / 1e9)
    checks = {f"{arch} finite": all(np.isfinite(r["loss"])
                                    and np.isfinite(r["grad_norm"])
                                    for r in fused)}
    if two_phase:
        # the same parameters again: the same seeded draws
        model.init_params(torch.Generator(device=dev).manual_seed(
            full["seed"]))
        two, peak_t, snap_t, pinned = steps(True, full["steps_two_phase"])
        rec.update(two_phase=two, peak_gb_two_phase=peak_t / 1e9)
        checks[f"{arch} two_phase finite"] = all(
            np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
            for r in two)
        checks[f"{arch} step1 loss fused == two_phase"] = \
            fused[0]["loss"] == two[0]["loss"]
        checks[f"{arch} step1 params fused == two_phase"] = all(
            torch.equal(snap_f[n], snap_t[n]) for n in snap_f)
        checks[f"{arch} pool tier pinned"] = pinned
        del snap_f, snap_t
    steady = [r["step_ms"] for r in fused[1:]]
    rec.update(ms_a_step=statistics.mean(steady),
               tokens_per_s=tokens / (statistics.mean(steady) / 1e3),
               run_s=time.perf_counter() - t_run, host_rss_gb=_rss_gb())
    if count_box is not None:
        count_box.update(cfg=cfg, batch=run["batch"], seq=run["seq"],
                         microbatches=full["microbatches"],
                         xent_chunk=run["xent_chunk"], remat=True,
                         accum=accum, ocfg=ocfg, tokens=tokens,
                         step_ms=steady)
    del model, params
    torch.cuda.empty_cache()
    return rec, checks


def _rss_gb():
    """This process's resident host memory, GB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS"))
    return kb * 1024 / 1e9


def _drop_host_caches():
    """Free what earlier phases keep on the host (sampled traces, fitted
    models, pinned blocks the host allocator caches): deepseek's pool tier
    needs ~40 GB of the host's 96 GiB pinned."""
    import gc
    for cache in (_FULL_TRACE, _POND, _SPILL, _AVAIL, _TOPO):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                    None) or getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def phase_train_families_full(dev):
    """The families' training runs at published widths (``TRAIN_RUNS``):
    hard checks, finite losses and grad norms, and for deepseek step 1's
    loss ``==`` and its parameters ``torch.equal`` between the fused and
    the two-phase step, the pool tier pinned on the host.  granite's first
    fused step is counted by the op counter (``dryrun_full``).  Returns
    that count's record."""
    from repro_torch.configs.one_card import TRAIN_RUNS
    t_phase = time.perf_counter()
    rss_before = _rss_gb()
    _drop_host_caches()
    rss_after = _rss_gb()
    runs, checks, counted = {}, {}, {}
    for arch in TRAIN_RUNS:
        rec, c = _train_family_full(
            arch, dev, counted if arch == "granite-moe-1b-a400m" else None)
        runs[arch] = rec
        checks.update(c)
    emit("train_families_full", ok=all(checks.values()), checks=checks,
         config=TRAIN_FAMILIES_FULL, runs=runs,
         host_rss_gb=dict(before=rss_before, after_drop=rss_after),
         phase_s=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise SystemExit("train_families_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return counted


# ------------------------------------------------------------- dry run ----
# Phase dryrun_full: (a) launch/dryrun.py over the reference's 10 archs x 4
# shapes on the single-pod mesh (16 x 16 meta devices), in a process of its
# own (started at the script's start, niced, run beside the card's phases):
# every SKIPS cell "skip", every other "ok", and that process never
# initialises CUDA (nothing allocated on any device).  (b) The two counted
# card steps (train_full's first fused qwen2-1.5b step, train_families_full's
# first granite step) against their meta twins in this process: FLOPs,
# bytes and ops ==, the card's memory_allocated unmoved by the meta counts,
# and the step's max_memory_allocated within DRYRUN_FULL's band of the meta
# twin's peak of live bytes plus the bytes allocated before it (the peak the
# counter read on the card reported beside it); each step's steady time
# against its roofline bound.  (c) StepCounters and a CounterLog from (b).
DRYRUN_FULL = dict(outdir="chiprun_out/torch_dryrun", mesh="single",
                   band_low=0.99, band_block_bytes=2 << 20,
                   band_workspace_bytes=128 << 20)
_DRYRUN = {}


def start_dryrun_sweep():
    """Start ``dryrun_full``'s sweep (a) in a niced process of its own."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, sys, time, torch\n"
        "from repro_torch.configs.base import SHAPES\n"
        "from repro_torch.configs.registry import ARCH_IDS\n"
        "from repro_torch.launch import dryrun\n"
        "t0 = time.perf_counter()\n"
        "cells = []\n"
        "for arch in ARCH_IDS:\n"
        "    for shape in SHAPES:\n"
        "        t = time.perf_counter()\n"
        "        r = dryrun.run_cell(arch, shape, False, sys.argv[1],\n"
        "                            skip_existing=False)\n"
        "        cells.append(dict(arch=arch, shape=shape,\n"
        "                          status=r['status'],\n"
        "                          error=r.get('error'),\n"
        "                          s=time.perf_counter() - t,\n"
        "                          t_count_s=r.get('t_count_s')))\n"
        "print(json.dumps(dict(cells=cells,\n"
        "    seconds=time.perf_counter() - t0,\n"
        "    cuda_initialized=torch.cuda.is_initialized(),\n"
        "    memory_allocated=torch.cuda.memory_allocated())))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    _DRYRUN["t0"] = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", code,
         os.path.join(here, DRYRUN_FULL["outdir"])],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(10))
    _DRYRUN["proc"] = proc
    # a phase that fails before dryrun_full leaves no process behind
    atexit.register(lambda: proc.poll() is None and proc.kill())


def _meta_twin(counted):
    """The meta count of a counted card step: the same config, batch
    shapes, plan and AdamW state, on ``device="meta"``, one microbatch
    counted and multiplied."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as rt
    from repro_torch.sharding.rules import ShardCtx
    cfg = counted["cfg"]
    model = build_model(cfg, device="meta")
    params = rt.train_params(model)
    opt = dryrun.abstract_opt_state(params, counted["ocfg"])
    batch = dryrun.train_batch(cfg, counted["batch"], counted["seq"])
    step = rt.make_train_step(model, counted["ocfg"],
                              ShardCtx(remat=counted["remat"]),
                              microbatches=counted["microbatches"],
                              xent_chunk=counted["xent_chunk"],
                              accum_dtype=counted["accum"])
    return dryrun.count_step(step, (params, opt, batch), repeat=True)


def phase_dryrun_full(dev, counted_steps):
    """``DRYRUN_FULL``'s (a), (b) and (c); ``counted_steps`` maps a name to
    a ``_count_first_call`` box of a card step."""
    from repro_torch.core.telemetry import CounterLog, StepCounters
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.dryrun import SKIPS, roofline
    checks, steps = {}, {}
    log = CounterLog()
    for name, box in counted_steps.items():
        card = box["counts"]
        before = torch.cuda.memory_allocated()
        meta, count_s = _meta_twin(box)
        checks[f"{name} meta count allocated nothing"] = \
            torch.cuda.memory_allocated() == before
        for k in ("flops", "bytes", "ops", "h2d_ops", "h2d_bytes"):
            checks[f"{name} {k} card == meta"] = \
                getattr(card, k) == getattr(meta, k)
        # the allocator against the meta twin's peak of live bytes; the
        # peak the counter read on the card beside it
        predicted = box["allocated_before"] + meta.peak_bytes
        low = DRYRUN_FULL["band_low"] * predicted
        high = (predicted + DRYRUN_FULL["band_block_bytes"]
                * meta.peak_storages + DRYRUN_FULL["band_workspace_bytes"])
        checks[f"{name} peak within band"] = low <= box["peak"] <= high
        step_s = statistics.mean(box["step_ms"]) / 1e3
        rl = roofline(card.flops, card.bytes, 0.0)
        bound = max(rl["compute_s"], rl["memory_s"])
        for ms in box["step_ms"]:
            log.record(name, StepCounters(card.flops, card.bytes, 0.0,
                                          ms / 1e3, box["tokens"]))
        sc = StepCounters(card.flops, card.bytes, 0.0, step_s, box["tokens"])
        steps[name] = dict(
            flops=card.flops, bytes=card.bytes, ops=card.ops,
            h2d=[card.h2d_ops, card.h2d_bytes],
            meta=dict(flops=meta.flops, bytes=meta.bytes, ops=meta.ops,
                      peak_bytes=meta.peak_bytes,
                      peak_storages=meta.peak_storages, count_s=count_s),
            card_counted_peak_bytes=card.peak_bytes,
            allocated_before=box["allocated_before"],
            max_memory_allocated=box["peak"],
            predicted=predicted, band=[low, high],
            measured_over_predicted=box["peak"] / predicted,
            meta_peak_over_card_peak=meta.peak_bytes / card.peak_bytes,
            step_ms=box["step_ms"], roofline=rl, bound_s=bound,
            bound_share_of_step=bound / step_s,
            tma_vector=sc.tma_vector(), kernel_launches=card.kernel_launches)
    features = {name: log.features(name) for name in counted_steps}
    # (a): the sweep's process
    proc = _DRYRUN.pop("proc")
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"dryrun_full's sweep failed:\n{err[-4000:]}")
    sweep = json.loads(out.strip().splitlines()[-1])
    wrong = [c for c in sweep["cells"]
             if c["status"] != ("skip" if (c["arch"], c["shape"]) in SKIPS
                                else "ok")]
    checks["sweep every cell as the reference records it"] = not wrong
    checks["sweep never initialised CUDA"] = \
        not sweep["cuda_initialized"] and sweep["memory_allocated"] == 0
    checks["sweep covers 10 archs x 4 shapes"] = len(sweep["cells"]) == 40
    emit("dryrun_full", ok=all(checks.values()), checks=checks,
         config=DRYRUN_FULL, steps=steps, counter_log_features=features,
         card=dict(hbm_bytes=torch.cuda.get_device_properties(0)
                   .total_memory, figures=dict(
                       peak_flops_bf16=meshlib.PEAK_FLOPS_BF16,
                       hbm_bw=meshlib.HBM_BW, nvlink_bw=meshlib.NVLINK_BW,
                       hbm_bytes=meshlib.HBM_BYTES)),
         sweep=dict(seconds=sweep["seconds"], wrong=wrong,
                    wall_s_since_start=time.perf_counter() - _DRYRUN["t0"],
                    cells=[[c["arch"], c["shape"], c["status"],
                            round(c["s"], 2)] for c in sweep["cells"]]))
    if not all(checks.values()):
        raise SystemExit("dryrun_full failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on "
              "the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import repro_torch  # noqa: F401  (fails here if the checkout is missing)
    from repro_torch.device import nvidia_smi_line, resolve_device

    dev = resolve_device(None)
    # fp32 products in full fp32 (the fp32 tolerances rule TF32 out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         total_memory=torch.cuda.get_device_properties(0).total_memory)
    # the dry run's sweep (dryrun_full (a)) runs beside the card's phases
    start_dryrun_sweep()
    # K2 and K3 first; K1, K4-K6 compile beside the model phases
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_attention import kernel as K2
    phase_build(first=(K2, K3))
    paged = phase_kernels(dev)
    flash = phase_kernels_flash(dev)
    torch.cuda.empty_cache()
    phase_parity_small(dev)
    paged["launches"] = phase_serve_full(dev)
    torch.cuda.empty_cache()
    phase_ring_parity_small(dev)
    flash_by_path = {"ring_full": phase_ring_full(dev)}
    torch.cuda.empty_cache()
    phase_families_parity_small(dev)
    families_launches, flash["at_family_prefills"] = \
        phase_families_full(dev)
    flash_by_path.update(families_launches)
    torch.cuda.empty_cache()
    phase_encdec_parity_small(dev)
    encdec_launches, flash["at_encdec_prefills"] = \
        phase_encdec_full(dev)
    flash_by_path.update(encdec_launches)
    flash_by_path["mesh_full"] = phase_mesh_full(dev)
    torch.cuda.empty_cache()
    phase_spmd_parity_small(dev)
    (flash_by_path["spmd_full"], flash["at_spmd_prefill"],
     flash["at_spmd_b1_prefill"]) = phase_spmd_full(dev)
    torch.cuda.empty_cache()
    flash_by_path["moe_mesh_full"], flash["at_moe_mesh_prefill"] = \
        phase_moe_mesh_full(dev)
    torch.cuda.empty_cache()
    (flash_by_path["family_mesh_full"],
     flash["at_family_mesh_jamba_prefill"], fused) = \
        phase_family_mesh_full(dev)
    torch.cuda.empty_cache()
    (flash_by_path["encdec_mesh_full"],
     flash["at_encdec_mesh_internvl2_prefill"]) = \
        phase_encdec_mesh_full(dev, fused)
    flash["launches"] = sum(flash_by_path.values())
    flash["launches_by_path"] = flash_by_path
    torch.cuda.empty_cache()
    phase_build_rest()
    sweep = phase_kernels_sweep(dev)
    phase_provision_parity_small(dev)
    by_path = {"provision_full": phase_provision_full(dev)}
    phase_pond_batch_parity_small(dev)
    by_path["pond_batch_full"] = phase_pond_batch_full(dev)
    spill = phase_kernels_spill(dev)
    phase_latency_grids_parity_small(dev)
    by_path["fig_grids_full"], (spill["launches"], spill["link_launches"]) \
        = phase_fig_grids_full(dev)
    spill["launches_by_path"] = {"fig_grids_full": spill["launches"]}
    fail = phase_kernels_fail(dev)
    phase_availability_parity_small(dev)
    fail["launches"] = phase_availability_full(dev)
    fail["launches_by_path"] = {"availability_full": fail["launches"]}
    pod = phase_kernels_pod(dev)
    phase_topology_parity_small(dev)
    pod_by_path = {"topology_full": phase_topology_full(dev)}
    torch.cuda.empty_cache()
    phase_stream_parity_small(dev)
    by_path["stream_full"], pod_by_path["stream_full"] = \
        phase_stream_full(dev)
    torch.cuda.empty_cache()
    phase_ingest_parity_small(dev)
    by_path["ingest_full"] = phase_ingest_full(dev)
    by_path["obs_full"] = phase_obs_full(dev)
    torch.cuda.empty_cache()
    by_path["devices_full"], pod_by_path["devices_full"] = \
        phase_devices_full(dev)
    torch.cuda.empty_cache()
    phase_train_parity_small(dev)
    counted = {"qwen2-1.5b fused step": phase_train_full(dev)}
    torch.cuda.empty_cache()
    phase_train_families_parity_small(dev)
    counted["granite-moe-1b-a400m fused step"] = \
        phase_train_families_full(dev)
    phase_dryrun_full(dev, counted)
    sweep["launches"] = sum(by_path.values())
    sweep["launches_by_path"] = by_path
    pod["launches"] = sum(pod_by_path.values())
    pod["launches_by_path"] = pod_by_path
    print(json.dumps({"kernels": [paged, flash, sweep, spill, fail, pod]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
