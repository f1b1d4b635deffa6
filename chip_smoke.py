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
  reference's results.

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

import dataclasses
import json
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
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full", "--dtype", "bfloat16",
              "--requests", "16", "--max-batch", "8", "--page-size", "16",
              "--local-pages", "256", "--pool-pages", "1024",
              "--prompt-len", "128", "1025", "--new-tokens", "32", "65",
              "--seed", "0"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------------ build --
def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.event_sweep import kernel as K1
    from repro_torch.kernels.fail_sweep import kernel as K5
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.kernels.spill_sweep import kernel as K6
    t0 = time.perf_counter()
    build.build_libraries([K2.NAME, K3.NAME, K1.NAME, K6.NAME, K5.NAME])
    seconds = time.perf_counter() - t0
    for K in (K2, K3, K1, K6, K5):
        K.build()                                   # load and bind
        with open(f"{build.library_path(K.NAME)}.log") as f:
            log = f.read()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        emit("build", kernel=K.NAME, source=K.SOURCE,
             seconds_all_in_parallel=round(seconds, 2),
             flags=" ".join(build.NVCC_FLAGS), instantiations=len(regs),
             registers=regs, max_registers=max(regs), spill_stores=spills,
             spill_store_bytes=sum(spills))
        if K in (K1, K5):
            # registers, stack frame and spills of every K1 or K5 variant
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


def _sdpa_library_call(q, k, v, mask, scale):
    """The library yardstick (``library_ms``): one PyTorch call computing
    the same function.  The port never calls it."""
    import torch.nn.functional as F
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_backends(q, k, v, mask, scale):
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
                    lambda: _sdpa_library_call(q, k, v, mask, scale),
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
def _ring_run(model, prompt, steps, *, seed):
    """Prefill B 2 prompts through ``make_prefill_step`` with flash
    attention, then ``steps`` greedy decode steps through
    ``make_decode_step``.  Returns (token stream, logits of every call on
    the host, cache, host seconds of the prefill, of each decode step)."""
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from repro_torch.sharding.rules import ShardCtx
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (RING_BATCH,
                                                             prompt)))
    positions = torch.arange(prompt, device=dev).expand(RING_BATCH, prompt)
    cache = model.init_cache(RING_BATCH, prompt + steps,
                             dtype=torch.float32
                             if model.embed.tok.dtype == torch.float32
                             else None)
    ctx = ShardCtx(attn_impl="flash")
    prefill, decode = make_prefill_step(model, ctx), make_decode_step(model,
                                                                      ctx)
    toks = toks.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(toks, positions, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)
    stream = [tok.tolist()]                      # waits for the device
    prefill_s = time.perf_counter() - t0
    all_logits, step_s = [logits[:, -1].cpu()], []
    for i in range(steps):
        t0 = time.perf_counter()
        pos = torch.full((RING_BATCH,), prompt + i, dtype=torch.int64,
                         device=dev)
        logits, cache = decode(tok[:, None], pos, cache)
        tok = torch.argmax(logits[:, 0], dim=-1)
        stream.append(tok.tolist())              # waits for the device
        step_s.append(time.perf_counter() - t0)
        all_logits.append(logits[:, 0].cpu())
    return stream, torch.stack(all_logits), cache, prefill_s, step_s


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
    g_stream, g_logits, g_cache, _, _ = _ring_run(gpu_model, 40, 6, seed=3)
    gpu_launches = ops.launches - before
    c_stream, c_logits, c_cache, _, _ = _ring_run(cpu_model, 40, 6, seed=3)
    g_pos = g_cache["groups"][0]["blocks"][0]["pos"].cpu()
    c_pos = c_cache["groups"][0]["blocks"][0]["pos"]
    logit_err = float((g_logits - c_logits).abs().max())
    checks = {
        "streams_equal": g_stream == c_stream,
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
    stream, logits, cache, prefill_s, step_s = _ring_run(
        model, RING_PROMPT, RING_STEPS, seed=0)
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
    # the same loop again under the tracer, for the device's busy time
    # (the sum of kernel times); its idle share is of the untraced wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _savings_pair(vms, cfg, frac, None)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6
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
         device_busy_seconds=busy_s if kernels else None,
         device_idle_share_of_untraced_wall=(1 - busy_s / wall) if kernels
         else None,
         device_kernels=[dict(name=k[:60], count=c, seconds=us / 1e6)
                         for k, c, us in kernels[:5]],
         peak_memory_bytes=peak, held_before_bytes=held,
         peak_memory_of_the_loop_bytes=peak - held)
    if not all(checks.values()):
        raise SystemExit(f"provision_full failed: {checks}")
    return launches


def _pond_loop(vms_list, cfg, models, frac, device):
    """Fig 21's loop as a user calls it: ``savings_analysis_batched`` for
    local, static and pond (a fresh control plane a trace) on one shared
    cache.  Returns ({policy: [PolicyResult a trace]}, the pond planes,
    the all-local batch)."""
    from repro_torch.core.cluster_sim import savings_analysis_batched
    cache, out = {}, {}
    planes = [_pond_plane(*models) for _ in vms_list]
    for policy in ("local", "static", "pond"):
        out[policy] = savings_analysis_batched(
            vms_list, cfg, policy, static_pool_frac=frac, cache=cache,
            control_planes=planes if policy == "pond" else None,
            device=device)
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
    # the same loop again under the tracer, for the device's busy time
    # (the sum of kernel times); its idle share is of the untraced wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pond_loop(vms_list, cfg, models, frac, None)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6
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
         device_busy_seconds=busy_s if kernels else None,
         device_idle_share_of_untraced_wall=(1 - busy_s / wall) if kernels
         else None,
         device_kernels=[dict(name=k[:60], count=c, seconds=us / 1e6)
                         for k, c, us in kernels[:5]],
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

    # the main path again under the tracer, for the device's busy time;
    # its idle share is of the untraced wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        policy_engine.grid_decisions(vms_list, settings, li, um_models, hist,
                                     backend="numpy")
        _fig17_pricing(vms_list, grid, settings, cfg, None)
        le.spill_grid(spill["kinds"], spill["keys"], spill["nl"],
                      spill["npl"], backend="torch")
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6

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
         device_busy_seconds=busy_s if kernels else None,
         device_idle_share_of_untraced_wall=(1 - busy_s / wall) if kernels
         else None,
         device_kernels=[dict(name=k[:60], count=c, seconds=us / 1e6)
                         for k, c, us in kernels[:6]],
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
            trace_events=None, slot_column=None):
    """K5 (``kernel``) or its plain version on a copy of ``state``:
    [fc, um, up, slots, down, counters, per-FAIL rows or None]."""
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
                       slot_column=slot_column)
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
             cases.DEMAND_LANES, ("int16",))):
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


def _k5_checks(dev):
    """K5 against its plain version on the card, ``==`` on the counters,
    the per-FAIL rows and the whole final state: every case of
    ``_k5_cases`` in its state types, both mitigations, with per-FAIL rows
    and without, the slot column where the plan puts it and in global
    memory; then the trace axis (three streams whose schedules differ in
    length, 5 lanes a trace).  Returns (checked, max_abs_err)."""
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
                for n_dist, column in ((n_fail, None), (0, None),
                                       (n_fail, "global")):
                    got = _k5_run(True, events, group_of, state, mit, n_dist,
                                  slot_column=column)
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
            for column in (None, "global"):
                got = _k5_run(True, cols, group_of, state, mit,
                              trace_events=counts, slot_column=column)
                compare(f"trace axis {dt} {mit} {column}", got, want)
                checked.append(dict(case="trace_axis_3", state_dtype=dt,
                                    mitigation=mit, plan=dataclasses.asdict(
                                        ops.last_plan), trace_events=counts,
                                    affected=int(want[5][1].sum())))
    return checked, max_err


def _k5_timed(evs, group_of, n_servers, n_groups, cores, n_slots, sgb_i,
              pgb_i, np_dt, mitigation, rows, counts, clock_mhz, reps=5):
    """K5's kernel function itself (no wrapper checks) over ``evs``: one
    trace, or the trace axis as ``ops.pack_traces`` lays it out, with
    ``counts`` the traces' event counts, and the lanes (sgb_i, pgb_i) in
    each trace; ``rows`` per-FAIL rows (one trace).  One warm-up, then
    ``reps`` runs on fresh state timed by ``_card_ms``.  Returns dict(ms,
    plan, the warm-up's counters summed over the lanes, the rows' SHA-1
    where there are rows)."""
    import hashlib

    from repro_torch.core import sweep_core
    from repro_torch.kernels.event_sweep.ops import trace_starts
    from repro_torch.kernels.fail_sweep import kernel as K5
    dev = group_of.device
    k, width = len(counts), len(counts) * len(sgb_i)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = K5.plan(len(sgb_i), n_servers, n_slots, np.dtype(np_dt).itemsize,
                   sms, k)
    st = sweep_core.init_state(width, n_servers, cores, n_servers, n_groups,
                               n_slots, np_dt)[:4]
    st += (sweep_core.init_fail_state(width, n_groups),
           np.tile(sgb_i, k).astype(np_dt), np.tile(pgb_i, k).astype(np_dt))
    states = [[torch.from_numpy(a.copy()).to(dev) for a in st]
              for _ in range(reps + 1)]
    outs = [torch.zeros((5, width), dtype=torch.int32, device=dev)
            for _ in range(reps + 1)]
    arrivals = torch.empty((width, n_slots), dtype=torch.int32, device=dev)
    dist = (torch.zeros((rows, width), dtype=torch.int32, device=dev)
            if rows else None)
    starts = trace_starts(counts)

    def run(i):
        K5.fail_sweep_kernel(evs, group_of, *states[i], arrivals, outs[i],
                             dist, remigrate=mitigation == "remigrate",
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

    def timed(evs, group_of, n_slots, mit, rows, counts):
        return _k5_timed(evs, group_of, n_srv, n_grp, cfg.cores_per_server,
                         n_slots, sgb_i, pgb_i, np_dt, mit, rows, counts,
                         clock_mhz)

    timings = {}
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

    # the kernel through its wrapper against its plain version, == on the
    # counters, the per-FAIL rows and the whole final state, on 2,048-event
    # cuts at the main path's shapes (256 servers, 32 domains, its slot
    # columns, 6 lanes a trace): the single-trace call's stream (MTBF 24 h,
    # with rows) and the four streams packed as the batched launch (4 x 6
    # lanes), both mitigations, the slot column where the plan puts it and
    # in global memory
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
            for column in (None, "global"):
                got = _k5_run(True, evs_c, group_of, st, mit, rows,
                              trace_events=tr, slot_column=column)
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
    main = timings["mtbf24h_remigrate"]
    record = dict(
        name=K5.NAME, route="cuda", source=K5.SOURCE,
        replaces="src/repro/core/sweep_core.py:333",
        max_abs_err=max_err, tolerance="== (integer state, exact)",
        cases_checked=len(checked) + len(cut_checks), cases=checked,
        cut_checks=cut_checks,
        design="K1's registers design (one warp a lane, K = S/32 servers "
               "a thread in registers, redux.sync first minimum, "
               "predicated updates, 2-stage cp.async event tiles, the "
               "slot column in shared memory by thread 0, global past its "
               "limit); a slot's payload through the index of its ARRIVE "
               "in a per-lane column (no block-shared table, which would "
               "race between unsynchronised warps); at FAIL all 32 threads "
               "stride the slot column: int32 per-server demand by shared "
               "atomics, the owners' fits flags, a second stride applying "
               "kill or remigrate, the deltas folded into the owners' "
               "registers; down flags a K-bit mask a thread",
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
         python=sys.version.split()[0])
    phase_build()
    paged = phase_kernels(dev)
    flash = phase_kernels_flash(dev)
    torch.cuda.empty_cache()
    phase_parity_small(dev)
    paged["launches"] = phase_serve_full(dev)
    torch.cuda.empty_cache()
    phase_ring_parity_small(dev)
    flash["launches"] = phase_ring_full(dev)
    torch.cuda.empty_cache()
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
    sweep["launches"] = sum(by_path.values())
    sweep["launches_by_path"] = by_path
    fail = phase_kernels_fail(dev)
    phase_availability_parity_small(dev)
    fail["launches"] = phase_availability_full(dev)
    fail["launches_by_path"] = {"availability_full": fail["launches"]}
    print(json.dumps({"kernels": [paged, flash, sweep, spill, fail]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
