#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kubernetes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, on cuda:0
    python3 chip_smoke.py --times GROUP [ROOT]
        # only one group of kernels of the port in checkout ROOT (default:
        # this one), timed in a fresh process: one JSON line. GROUP
        # batch: run_batch (lean, overlay, groups) and the probe (one
        # device, make_mesh(2) / (4) of one card); closed_form:
        # run_uniform (lean, overlay) and run_gang's closed form; plan:
        # run_plan (MixedHighSignature, lean ports span) and
        # run_plan_sharded on make_mesh(2) / (4) of one card; shard:
        # run_batch_sharded (lean, groups) and run_gang_sharded's scan
        # tier on make_mesh(2) / (4) of one card beside run_batch (lean,
        # groups) and run_gang's scan tier, and the mesh's closed forms
        # (run_uniform_sharded, run_gang_sharded's closed form);
        # gang: run_gang's scan tier (S = 1 and S = 4), the gang grid on
        # make_mesh(1) and make_mesh(2) / (4) of one card, dry_run over
        # every candidate and over a preemptor's subset, and
        # PreemptionChurn's per-preemptor Evaluator._dry_run_overrides;
        # gang_host: run_gang_sharded's scan tier on make_mesh(2) / (4)
        # of one card, its host ms a call beside the copies its wrapper
        # makes (this checkout only); wave: run_wave on
        # TopologySpreading's and SchedulingPodAntiAffinity's first
        # drains; statics: wave_statics (S = 1 with each family flag set,
        # the S = 4 / 8 MixedHighSignature rows, SurfaceCache.get) and
        # wave_statics_sharded on make_mesh(2) / (4) of one card, warm and
        # cold; diag: diagnose_row on a lean and a group row, warm and
        # cold, and a failed drain's mask diagnosis of eight signatures;
        # ingest: SchedulingBasic, MixedHighSignature and PreemptionChurn
        # with the ColumnarIngest gate off / on / on / off, each run's
        # pods/s, window, host split and the split of pod creation, the
        # bind echo and the commit inside the window.

Phases, each reported on its own line:
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. the build of every CUDA kernel from kubernetes_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version on the card, exact
     equality of every output and carry field, with kernel, plain and
     library timings: run_batch and run_uniform on seeded lean inputs at
     the SchedulingBasic harness shapes (5,000 nodes padded to 8,192,
     batch 8,192), and run_batch on tests/_batch_edges.py's edge cases
     (ties at the cluster's CTA boundaries, N below, at and above its
     rows, signature changes every pod / every other pod / never, a row
     outside the table, invalid pods, full port slots, nominated rows at
     a CTA boundary and on invalid nodes, every group family); scatter_rows, wave_statics, run_wave and run_batch's
     group mode at the full-width shapes of TopologySpreading and
     SchedulingPodAntiAffinity; run_plan at the MixedHighSignature shape
     (S = 8 signatures, a 4,096-pod span) and on a lean four-signature
     host-port span; diagnose_row on lean and group rows at 8,192 nodes;
     the overlay variants of run_batch and run_uniform at their lean
     shapes; dry_run at the PreemptionChurn shape (C = 8,192 candidates,
     V = 1) and at C = 512, V = 8 with and without a spread, and its
     subset entry (a preemptor's launch over the candidates its
     nominations touch, reading the plan's tensors through their
     positions in place: 199 in 256 at V = 1, 100 in 128 at V = 8);
     run_gang's closed form at GangTraining's shape (L = K = 256, J = 8:
     accepted, rejected, inexact) and its scan tier, one cluster launch a
     gang, at CoLocatedInference's (B = 128, S = 1, w_contig = 2:
     accepted, rejected) and on an S = 4 gang of 60 members, with ptxas
     of both instantiations of the gang body; explain_row on lean and group rows at 8,192
     nodes with k = 16 and k = 5 (some rows with fewer feasible nodes
     than k; its device time beside the same run's torch.topk of the
     row's keys); after phase 4, cluster_probe on SchedulingBasic's own
     post-drain carry with zone, per-node, identity and clipped domain
     ids, and score_probe (the sanitizer rails' NaN probe) on every
     table row of that carry, bit for bit through its float32 outputs'
     int32 view; and on SchedulingBasic's post-drain state the
     node-sharded programs (kubernetes_tpu_torch/parallel/sharding.py) on
     D = 2 and 4 shards of cuda:0, each against its plain version over
     the same shards and against the single-device kernel:
     run_batch_sharded on a 1,024-pod lean span (one launch a span; the
     host-driven chain of shards on several cards, called on the shards
     of cuda:0, against the plain version), run_uniform_sharded at
     L = K = 8,192, J = 8 (and its fast path; its selection launch as the
     multi-block chain), scatter_rows_sharded with
     1,000 rows including every shard boundary, cluster_probe_sharded bit
     for bit; each logs its timed and device ms per mesh, the bytes it
     exchanged, and the single-device row's bound at the same shape;
     then the mesh's group and gang programs on D = 2 and 4 shards of
     cuda:0: run_batch_sharded's group mode (one launch a span;
     against its plain version on 256 pods of phase 8's mix, the chain
     there too, against run_batch's group mode on row 1g's 1,024-pod
     span), run_plan_sharded (plain: a 1,024-pod span of
     MixedHighSignature's state and row 7's lean ports span; kernel:
     MixedHighSignature's full drain, S = 8, W = 4,096; one launch a
     span; the host-driven chain of shards on several cards, called on
     the shards of cuda:0, against the plain version on both spans and
     the one launch on the full drain),
     run_gang_sharded's scan tier (one launch a gang, B = 128, S = 1,
     w_contig = 2, accepted and rejected; S = 4, 60 members in 64 slots;
     the chain on the shards of cuda:0 in every case) and closed
     form (L = K = 256, J = 8: accepted, rejected, inexact; its selection
     launch as one block), and the
     per-shard surfaces (wave_statics_sharded, the image counts psum'd);
  4. SchedulingBasic 5000Nodes_10000Pods end to end through
     kubernetes_tpu_torch.scheduler.Scheduler on the card;
  5. a mixed lean workload (taints, selectors, host ports, images, four
     rotating signatures) at 500 nodes: lean plan spans (run_plan, with
     the ports variant), scan spans, uniform rewinds, and pods no node
     fits (diagnose_row);
  6. TopologySpreading 5000Nodes_5000Pods end to end (merge waves);
  7. SchedulingPodAntiAffinity 5000Nodes_2000Pods end to end (merge waves
     with champion-per-domain selection);
  8. a mixed group workload at 500 nodes (ScheduleAnyway, required
     affinity, two anti terms, preferred terms, PreferNoSchedule taints,
     short drains) that drives run_plan, run_batch's group mode, the
     serial and renormalizing wave tiers and diagnose_row;
  9. MixedHighSignature 5000Nodes end to end (a run_plan span of eight
     interleaved signatures per drain);
 10. MixedSchedulingBasePod 5000Nodes end to end (ScheduleAnyway and
     self-matching required-affinity drains on run_plan, then plain pods
     on run_wave);
 11. PreemptionChurn 5000Nodes_10000Pods end to end: 200 preemptors each
     evict one victim through the batched dry run (dry_run) and take a
     nomination (each preemptor's Evaluator._dry_run_overrides timed: its
     staging, subset launch and readback); the measured pods drain under
     the nominated-pod overlay
     (run_uniform's overlay variant), and the drain that takes the
     preemptors back runs run_batch's overlay variant;
 12. GangTraining 5000Nodes: 40 gangs of 256, each one closed-form
     run_gang launch;
 13. CoLocatedInference 5000Nodes: 28 gangs on run_gang's scan tier (the
     contiguity column on) among 5,000 inference pods;
 14. SchedulingNodeAffinity 5000Nodes: 10,000 pods, each pinned to a zone
     by its nodeSelector;
 15. gang rejection and gang-preempts-gang at 5,000 nodes of 8 cpu: a
     gang rejected on run_gang's closed form, one on its scan tier, and
     a priority-100 gang that is rejected, preempts priority-0 gang
     members and binds after its requeue;
 16. the sanitizer rails (KubeSchedulerConfiguration(feature_gates=
     {"SanitizerRails": True})) on SchedulingBasic, TopologySpreading,
     MixedHighSignature, PreemptionChurn, GangTraining and
     CoLocatedInference at full width: each bind map equal to the cell's
     rails-off card run, one score_probe launch and one armed sync guard
     per device drain, reconcile() == []; then an `.item()` inside the
     guard must raise, and a write through `.data` into a held carry
     must fail the held-carry checksum. Each cell logs its rails-on
     pods/s beside its rails-off figure (the rails' cost, not a
     benchmark figure);
 17. the node-sharded mesh: SchedulingBasic 5000Nodes_10000Pods through
     the harness with `Scheduler(api, mesh=make_mesh(D))` for D = 2 and
     4 (shards of cuda:0 on a one-card machine), held to phase 4's bind
     map and final probe snapshot, one cluster_probe_sharded a device
     drain, and no single-device lean kernel launched; then the
     beyond-lattice check (5,000 nodes, 2,048 pods over 40 request
     shapes, so every drain rides the scan, with a node update between
     two waves, so the reseed rides the dirty-row upload) on make_mesh(2)
     against the single-device card run. Each logs pods/s beside the
     single-device figure, with the card's name and power limit;
 18. the mesh's group and gang paths: TopologySpreading,
     SchedulingPodAntiAffinity, MixedSchedulingBasePod,
     MixedHighSignature, GangTraining and CoLocatedInference at full
     width on make_mesh(2), TopologySpreading, GangTraining and
     CoLocatedInference on make_mesh(4), each held to its single-device
     card run's bind map and
     final probe snapshot (phases 6, 7, 10, 9, 12, 13), one
     cluster_probe_sharded a device drain, the sharded group and gang
     programs launched and no single-device program; then on
     make_mesh(2) the beyond-lattice drain set with a zone spread on
     every shape (group-mode scans) against its single-device card run,
     and a gang rejected on each run_gang_sharded tier with the whole
     carry unchanged. Each logs pods/s and its host split beside the
     single-device figure;
 19. the ColumnarIngest gate off (KubeSchedulerConfiguration(
     feature_gates={"ColumnarIngest": False}): the serial build, node-row
     writers, commit and bind echo) on SchedulingBasic, TopologySpreading,
     PreemptionChurn and GangTraining at full width: each run's bind map,
     cache dump (less node generations), dispatcher executed and error
     counts and scheduled and unschedulable counts equal to the cell's
     gate-on card run, with its pods/s and host split beside the gate-on
     run's. Every phase logs its seconds.
Phases 4, 6, 7 and 9-14 run through kubernetes_tpu_torch.perf.harness's
WorkloadRunner (the reference harness's measured window: pods built
inside it, the cyclic collector paused) and log the harness's pods/s,
the window's host split by span name (every drain's Tracer span tree)
and the device's busy share. Every device drain launches cluster_probe.
Phases 4-15 compare their bind maps (phase 11 also its nominations and
victims, 12, 13 and 15 their gang drains by outcome), the final
cluster-probe snapshot and one explain_pod answer with a device="cpu"
run of the same workload, at full width. Any failure exits non-zero
without the final line. The line before the last is the card's name and power limit, the
one before it one JSON object with a row per kernel; the last line is
{"ok": true, "device": {...}}.

The script imports neither jax nor kubernetes_tpu, and needs no pyyaml:
the cells (CELLS) are written out from
kubernetes_tpu/perf/configs/performance-config.yaml (SchedulingBasic
:28-34, SchedulingNodeAffinity :36-61, TopologySpreading :63-94,
SchedulingPodAntiAffinity :96-129, MixedSchedulingBasePod :195-237,
MixedHighSignature :239-284, PreemptionChurn :286-329, GangTraining
:331-357, CoLocatedInference :359-398), and tests/test_torch_harness.py
holds them to the parsed file.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense rates, 700 W): HBM 3.35 TB/s
# and 67 TFLOP/s in float32 outside the tensor cores, which is 128 FP32
# lanes per SM per clock with an FMA counted as two operations. The CUDA
# C++ Programming Guide's instruction-throughput table gives compute
# capability 9.0 64 lanes per SM per clock for 32-bit integer add,
# compare, min/max, logic and multiply-add, and 64 for float64 add, mul
# and fma: one instruction per lane at a quarter of the FP32 FLOP rate
# (the data sheet's 34 TFLOP/s float64, FMA as two, agrees). The kernels
# do no tensor-core work.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4   # 32-bit integer instructions
F64_OPS_PER_S = 67e12 / 4     # float64 instructions

# The cells, as kubernetes_tpu/perf/configs/performance-config.yaml
# defines them (the workload template of each test case and the params
# and threshold of its full-width workload), written out because the card's
# machine has no pyyaml; tests/test_torch_harness.py holds them to the
# parsed file.
_MEASURE = {"opcode": "createPods", "countParam": "$measurePods",
            "collectMetrics": True}
_NODES = {"opcode": "createNodes", "countParam": "$initNodes"}
_INIT = {"opcode": "createPods", "countParam": "$initPods"}
CELLS = {
    "SchedulingBasic": dict(
        workload="5000Nodes_10000Pods", threshold=270,
        template=[_NODES, _INIT, _MEASURE],
        params={"initNodes": 5000, "initPods": 1000, "measurePods": 10000}),
    "SchedulingNodeAffinity": dict(
        workload="5000Nodes", threshold=220,
        template=[_NODES, dict(_MEASURE, podTemplate={
            "cpu": "900m", "memory": "1Gi", "nodeSelectorZone": True})],
        params={"initNodes": 5000, "measurePods": 10000}),
    "TopologySpreading": dict(
        workload="5000Nodes_5000Pods", threshold=85,
        template=[_NODES, _INIT, dict(_MEASURE, podTemplate={
            "cpu": "900m", "memory": "1Gi", "labels": {"app": "spread"},
            "spreadZone": {"app": "spread"}, "maxSkew": 5,
            "whenUnsatisfiable": "DoNotSchedule"})],
        params={"initNodes": 5000, "initPods": 1000, "measurePods": 5000}),
    "SchedulingPodAntiAffinity": dict(
        workload="5000Nodes_2000Pods", threshold=60,
        template=[_NODES, _INIT, dict(_MEASURE, podTemplate={
            "cpu": "900m", "memory": "1Gi", "labels": {"anti": "yes"},
            "podAntiAffinity": {"anti": "yes"},
            "topologyKey": "topology.kubernetes.io/zone"})],
        params={"initNodes": 5000, "initPods": 500, "measurePods": 2000,
                "zones": 10000}),
    "MixedSchedulingBasePod": dict(
        workload="5000Nodes", threshold=140,
        template=[_NODES, dict(_INIT, podTemplate={
            "cpu": "900m", "memory": "1Gi", "labels": {"mixed": "base"},
            "spreadZone": {"mixed": "base"}, "maxSkew": 5,
            "whenUnsatisfiable": "ScheduleAnyway"}),
            {"opcode": "createPods", "countParam": "$initAffinityPods",
             "podTemplate": {"cpu": "500m", "memory": "512Mi",
                             "labels": {"mixed": "base"},
                             "podAffinity": {"mixed": "base"}}},
            _MEASURE],
        params={"initNodes": 5000, "initPods": 1000,
                "initAffinityPods": 500, "measurePods": 5000}),
    "MixedHighSignature": dict(
        workload="5000Nodes", threshold=85,
        template=[_NODES, dict(_INIT, podTemplate={
            "cpu": "900m", "memory": "1Gi", "labels": {"app": "mix"},
            "spreadZone": {"app": "mix"}, "maxSkew": 5,
            "whenUnsatisfiable": "DoNotSchedule"}),
            dict(_MEASURE, podTemplate={
                "memory": "1Gi", "labels": {"app": "mix"},
                "spreadZone": {"app": "mix"}, "maxSkew": 5,
                "whenUnsatisfiable": "DoNotSchedule",
                "signatureCycle": 8})],
        params={"initNodes": 5000, "initPods": 1000, "measurePods": 5000}),
    "PreemptionChurn": dict(
        workload="5000Nodes_10000Pods", threshold=None,
        template=[_NODES, dict(_INIT, podTemplate={"cpu": 4,
                                                    "memory": "1Gi"}),
                  {"opcode": "createPods", "countParam": "$preemptors",
                   "podTemplate": {"cpu": 8, "memory": "1Gi",
                                   "priority": 100}},
                  dict(_MEASURE, podTemplate={"cpu": "500m",
                                              "memory": "256Mi"})],
        params={"nodeCpu": 8, "initNodes": 5000, "initPods": 5000,
                "preemptors": 200, "measurePods": 10000}),
    "GangTraining": dict(
        workload="5000Nodes", threshold=270,
        template=[_NODES, {"opcode": "gangTrace", "gangsParam": "$gangs",
                           "gangSizeParam": "$gangSize",
                           "collectMetrics": True}],
        params={"initNodes": 5000, "gangs": 40, "gangSize": 256}),
    "CoLocatedInference": dict(
        workload="5000Nodes", threshold=270,
        template=[_NODES, {
            "opcode": "gangTrace", "gangsParam": "$gangs",
            "gangSizeParam": "$gangSize", "gangPriority": 10,
            "gangCpu": "1", "inferencePodsParam": "$inferencePods",
            "inferencePriority": 100,
            "preemptorGangsParam": "$preemptorGangs", "preemptorSize": 64,
            "preemptorCpu": "2", "preemptorPriority": 200,
            "contiguityWeight": 2, "collectMetrics": True}],
        params={"initNodes": 5000, "gangs": 24, "gangSize": 128,
                "inferencePods": 5000, "preemptorGangs": 4}),
}
_P = {k: v["params"] for k, v in CELLS.items()}
# the shapes the phase-3 checks build their inputs at
SB_NODES = _P["SchedulingBasic"]["initNodes"]
SB_INIT_PODS = _P["SchedulingBasic"]["initPods"]
SB_PODS = _P["SchedulingBasic"]["measurePods"]
# (nodes, init pods, measured pods, zones)
TS_SHAPE = tuple(_P["TopologySpreading"][k] for k in (
    "initNodes", "initPods", "measurePods")) + (16,)
AA_SHAPE = tuple(_P["SchedulingPodAntiAffinity"][k] for k in (
    "initNodes", "initPods", "measurePods", "zones"))
# MixedHighSignature: nodes, init pods, measured pods, zones,
# signatureCycle; MixedSchedulingBasePod: nodes, init pods, init affinity
# pods, measured pods, zones
MHS_SHAPE = tuple(_P["MixedHighSignature"][k] for k in (
    "initNodes", "initPods", "measurePods")) + (16, 8)
MBP_SHAPE = tuple(_P["MixedSchedulingBasePod"][k] for k in (
    "initNodes", "initPods", "initAffinityPods", "measurePods")) + (16,)
# PreemptionChurn: nodes of 8 cpu, init pods of 4 cpu / 1 Gi, preemptors
# of 8 cpu / 1 Gi at priority 100, measured pods of 500m / 256 Mi, zones
PC_SHAPE = tuple(_P["PreemptionChurn"][k] for k in (
    "initNodes", "initPods", "preemptors", "measurePods")) + (16,)
# GangTraining: nodes, gangs, gang size, zones; CoLocatedInference:
# nodes, gangs, gang size, inference pods, preemptor gangs (of 64), zones
GT_SHAPE = tuple(_P["GangTraining"][k] for k in (
    "initNodes", "gangs", "gangSize")) + (16,)
CI_SHAPE = tuple(_P["CoLocatedInference"][k] for k in (
    "initNodes", "gangs", "gangSize", "inferencePods",
    "preemptorGangs")) + (16,)
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_HOSTNAME = "kubernetes.io/hostname"
BATCH = 8192              # perf/harness.py:279 WorkloadRunner batch_size
CREATE_BATCH = 512        # perf/harness.py:279 create_batch


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call of `fn` (kernels and copies, from
    torch.profiler), without the host time between launches that
    `cuda_ms` sees when the wrapper is slower than its kernel."""
    fn()
    torch.cuda.synchronize()
    return profile_run(torch, lambda: [fn() for _ in range(reps)])[
        "device_busy_ms"] / reps


def device_split(torch, fn, reps: int) -> dict:
    """Device ms per call of `fn` by kernel name (torch.profiler's
    largest eight): where a kernel's device time goes."""
    fn()
    torch.cuda.synchronize()
    top = profile_run(torch, lambda: [fn() for _ in range(reps)])[
        "top_device_ms"]
    return {k: v / reps for k, v in top.items()}


def nbytes(*trees) -> int:
    import torch
    total = 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            stack.extend(t)
    return total


class Ops:
    """Operations a function needs, by type. An int64 add, compare or
    multiply is two 32-bit integer instructions (a multiply takes more and
    a division far more, so two keeps the count a lower bound)."""

    def __init__(self, i32=0, i64=0, f64=0):
        self.i32, self.i64, self.f64 = int(i32), int(i64), int(f64)

    def __add__(self, o):
        return Ops(self.i32 + o.i32, self.i64 + o.i64, self.f64 + o.f64)

    def __mul__(self, k):
        return Ops(self.i32 * k, self.i64 * k, self.f64 * k)

    def seconds(self) -> float:
        # the integer and float64 pipes issue side by side
        return max((self.i32 + 2 * self.i64) / INT32_OPS_PER_S,
                   self.f64 / F64_OPS_PER_S)


def bound_of(moved: int, ops: Ops) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their pipes' peak rates."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops.seconds()
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def np_of(t):
    return t.cpu().numpy()


def node_slots(na, carry) -> dict:
    """Occupied slots per node (padding slots cost nothing)."""
    eff = np_of(na.taint_eff)
    valid = np_of(na.valid)
    return dict(
        n_valid=int(valid.sum()), n_pad=int((~valid).sum()),
        hard=((eff == 1) | (eff == 3)).sum(1)[valid],     # NoSchedule/Execute
        pref=(eff == 2).sum(1)[valid],                    # PreferNoSchedule
        labels=(np_of(na.label_key) != 0).sum(1)[valid],
        images=(np_of(na.image_id) != 0).sum(1)[valid],
        ports=(np_of(carry.ports) != 0).sum(1)[valid])


def score_ops(C: int, nreq: int, balanced: bool) -> Ops:
    """One node's fit check and Least/MostAllocated + BalancedAllocation at
    a given carry row (csrc/lean_eval.cuh kt_fit, kt_fit_scores)."""
    return Ops(i64=1 + 2 * nreq + 9 * C + 1 + (C if balanced else 0),
               f64=(6 * C + 7) if balanced else 0)


def eval_ops(table, u: int, slots: dict, C: int) -> Ops:
    """One full evaluation of signature row `u` over the valid nodes
    (_eval_pod, program.py:495): every filter and score, each loop over
    the pod's live entries and the node's occupied slots only. Padded
    nodes cost their validity test."""
    t = {f: np_of(getattr(table, f)[u]) for f in (
        "req", "tol_op", "tol_eff", "ns_sel_val", "aff_has",
        "aff_term_valid", "aff_op", "aff_val", "pref_weight", "pref_op",
        "pref_val", "port_ids", "img_ids", "img_containers",
        "skip_balanced", "node_name_id")}
    live_tol = t["tol_op"] != 0
    n_tol = int(live_tol.sum())
    n_tol_pref = int((live_tol & ((t["tol_eff"] == 0)
                                  | (t["tol_eff"] == 2))).sum())
    nl, ni, pocc = slots["labels"], slots["images"], slots["ports"]

    def terms(active, ops, vals) -> Ops:
        out = Ops()
        for k in range(ops.shape[0]):
            if not active[k]:
                continue
            for q in range(ops.shape[1]):
                if 1 <= ops[k, q] <= 6:       # a live requirement
                    nv = int((vals[k, q] != 0).sum())
                    out = out + Ops(i32=int((nl * (1 + nv)).sum()),
                                    i64=int(nl.sum()) * (ops[k, q] >= 5))
        return out

    nreq = int((t["req"] != 0).sum())
    n_pid = int((t["port_ids"] != 0).sum())
    n_img = int((t["img_ids"] != 0).sum())
    imgs = int(t["img_containers"]) > 0
    # per valid node: the validity, unschedulable, node-name and
    # feasibility tests and the image counts (int32); the two maxima, the
    # normalised weighted total and the argmax (int64); fit and scores;
    # the ImageLocality sum and clamp
    per = Ops(i32=3 + int(t["node_name_id"] != 0) + n_img, i64=2 + 15 + 1)
    per = per + score_ops(C, nreq, not bool(t["skip_balanced"]))
    if imgs:
        per = per + Ops(i64=n_img + 6, f64=2 * n_img)
    total = per * slots["n_valid"] + Ops(i32=slots["n_pad"])
    # the loops over occupied slots: taint effects, tolerations, selector
    # values, host ports, images
    total = total + Ops(
        i32=int((slots["hard"] + slots["pref"]).sum())
        + 4 * n_tol * int(slots["hard"].sum())
        + 4 * n_tol_pref * int(slots["pref"].sum())
        + int((np_of(table.ns_sel_val[u]) != 0).sum()) * int(nl.sum())
        + n_pid * int(pocc.sum()) + (int(pocc.sum()) if n_pid else 0)
        + n_img * int(ni.sum()),
        i64=int(slots["pref"].sum()) + n_img * int(ni.sum()))
    if t["aff_has"]:
        total = total + terms(t["aff_term_valid"], t["aff_op"], t["aff_val"])
    total = total + terms(t["pref_weight"] != 0, t["pref_op"], t["pref_val"])
    return total


def fast_ops(slots: dict) -> Ops:
    """One SigCache fast-path step: feasibility, the two maxima, the
    weighted total and the argmax on every valid node."""
    return Ops(i32=1, i64=2 + 15 + 1) * slots["n_valid"]


def select_ops(n: int, k: int) -> Ops:
    """Top-k of n int64 keys, in order: n - 1 compares to select, then
    k·log2(k) to order what was selected."""
    k = min(k, n)
    return Ops(i64=max(n - 1, 0) + k * max(k - 1, 1).bit_length())


def scan_ops(table, sigs, tidxs, assigned, sig0: int, slots: dict, C: int,
             nom=None) -> tuple:
    """run_batch's operations over one span, in order: a pod whose
    signature differs from the one before pays the full evaluation, a
    repeat the SigCache fast path; each placement refreshes one node.
    With `nom` (the pods' nominated rows, the overlay variant): each full
    evaluation adds the overlay (an add per requested column and the pod
    count) on every valid node, each nominated pod its own-row fit, and
    each nominated pod placed the overlay's consumption at its row."""
    ops, prev, per_row, nreq = Ops(), sig0, {}, {}
    for k, (s_, u, best) in enumerate(zip(sigs, tidxs, assigned)):
        if u not in per_row:
            per_row[u] = eval_ops(table, u, slots, C)
            nreq[u] = len(req_cols(np_of(table.req[u])))
        n = nreq[u]
        fast = s_ != 0 and s_ == prev
        ops = ops + (fast_ops(slots) if fast else per_row[u])
        if best >= 0:
            ops = ops + Ops(i64=n + 3) + score_ops(C, n, True)
        if nom is not None:
            if not fast:
                ops = ops + Ops(i64=(n + 1) * slots["n_valid"])
            if nom[k] >= 0:
                ops = ops + Ops(i64=2 * n + 2)
                if best >= 0:
                    ops = ops + Ops(i64=n + 1)
        prev = s_
    return ops


def ovl_bytes(ovl, table, tidxs) -> int:
    """The overlay's bytes a launch must read: the columns its pods
    request of ovl_used and the pod counts, on every node row."""
    req = np_of(table.req)[np.unique(np.asarray(tidxs))]
    cols = len(req_cols(req.any(axis=0)))
    N = ovl[1].shape[0]
    return N * (cols * ovl[0].element_size() + ovl[1].element_size())


# ---------------------------------------------------------------------------
# seeded lean inputs


def lean_cluster(rng: np.random.RandomState, n_nodes: int, wrappers):
    """Nodes with NoSchedule / PreferNoSchedule / NoExecute taints, zone,
    disk and numeric labels, and images."""
    make_node = wrappers.make_node
    nodes = []
    for i in range(n_nodes):
        w = make_node(f"node-{i}").capacity({
            "cpu": int(rng.choice([8, 16, 32, 64])),
            "memory": f"{int(rng.choice([16, 32, 64, 128]))}Gi",
            "pods": 110})
        w = w.zone(f"zone-{i % 16}").label("kubernetes.io/hostname",
                                          f"node-{i}")
        if rng.rand() < 0.4:
            w = w.label("disk", "ssd" if rng.rand() < 0.5 else "hdd")
        if rng.rand() < 0.3:
            w = w.label("gen", str(int(rng.randint(1, 6))))
        r = rng.rand()
        if r < 0.1:
            w = w.taint("dedicated", "batch", effect="NoSchedule")
        elif r < 0.2:
            w = w.taint("spot", "", effect="PreferNoSchedule")
        elif r < 0.22:
            w = w.taint("drain", "", effect="NoExecute")
        if rng.rand() < 0.5:
            for img in ("nginx:1.25", "redis:7")[: int(rng.randint(1, 3))]:
                w = w.image(img, int(rng.choice([50, 300, 800])) << 20)
        nodes.append(w.obj())
    return nodes


def lean_pods(rng: np.random.RandomState, n: int, wrappers, prefix: str,
              ports: bool = True):
    """Eight pod shapes: plain, selector, toleration, preferred affinity,
    required affinity with Gt, host port, images, best effort."""
    make_pod = wrappers.make_pod
    shapes = []
    for s in range(8):
        w = make_pod(f"{prefix}-proto{s}").req(
            {"cpu": ["900m", "250m", "2"][s % 3],
             "memory": ["1Gi", "512Mi", "4Gi"][s % 3]})
        if s == 1:
            w = w.node_selector({"disk": "ssd"})
        if s == 2:
            w = w.toleration(key="dedicated", operator="Exists").toleration(
                key="spot", operator="Exists", effect="PreferNoSchedule")
        if s == 3:
            w = w.preferred_node_affinity_in(
                "topology.kubernetes.io/zone", ["zone-1", "zone-2"], 7)
        if s == 4:
            w = w.node_affinity_in("topology.kubernetes.io/zone",
                                   [f"zone-{z}" for z in range(8)])
        if s == 5 and ports:
            w = w.host_port(8080)
        if s == 6:
            w = w.container({"cpu": "100m"}, image="nginx:1.25").container(
                {"cpu": "100m"}, image="redis:7")
        if s == 7:
            w = make_pod(f"{prefix}-proto{s}")
        shapes.append(w.obj())
    return [shapes[int(rng.randint(0, 8))] for _ in range(n)]


def stage(nodes, bound, device, pkg):
    """The ClusterState of `nodes` holding the `bound` pods, through the
    port's own cache, snapshot and state layer."""
    cache = pkg.Cache()
    for nd in nodes:
        cache.add_node(nd)
    for p in bound:
        cache.add_pod(p)
    snap = pkg.Snapshot()
    cache.update_snapshot(snap)
    state = pkg.ClusterState(device=device)
    state.apply_snapshot(snap, full=True)
    return state


def staged(nodes, bound, pods, device, pkg):
    """(NodeArrays, PodBatch, device table) through the port's own
    state layer."""
    state = stage(nodes, bound, device, pkg)
    batch = pkg.BatchBuilder(state).build(pods)
    if batch.host_fallback[:len(pods)].any():
        fail("smoke inputs hit a host-fallback signature")
    return state.device_arrays(), batch, pkg.table_from_batch(batch, device)


class _Pkg:
    """The port's modules, imported after the CUDA and checkout checks."""

    def __init__(self):
        from kubernetes_tpu_torch.backend.cache import Cache, Snapshot
        from kubernetes_tpu_torch.ops import kernels, program
        from kubernetes_tpu_torch.parallel import sharding
        from kubernetes_tpu_torch.state import convert
        from kubernetes_tpu_torch.state.batch import BatchBuilder
        from kubernetes_tpu_torch.state.tensorize import ClusterState
        from kubernetes_tpu_torch.testing import wrappers
        self.Cache, self.Snapshot = Cache, Snapshot
        self.kernels, self.program, self.convert = kernels, program, convert
        self.sharding = sharding
        self.BatchBuilder, self.ClusterState = BatchBuilder, ClusterState
        self.wrappers = wrappers
        self.table_from_batch = program.table_from_batch


def assert_equal_trees(torch, a, b, what: str) -> float:
    """Exact equality of every tensor in two (nested) tuples; returns the
    largest absolute difference found (0.0 when they are equal)."""
    if a is None or b is None:
        if a is not None or b is not None:
            fail(f"{what}: one side is None")
        return 0.0
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        diff = (float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
                if a.numel() else 0.0)
        if not torch.equal(a, b):
            fail(f"{what}: kernel and plain version differ "
                 f"(max abs {diff})")
        return diff
    err = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        name = getattr(a, "_fields", None)
        err = max(err, assert_equal_trees(
            torch, x, y, f"{what}.{name[i] if name else i}"))
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def batch_span_inputs(torch, pkg, device):
    """Row 1's 1,024-pod mixed span over 5,000 lean nodes (600 bound pods,
    every fifth on host port 8080), and its overlay variant's inputs: every
    tenth pod nominated (its own request at its row, as the scheduler
    builds the overlay) and 200 more nodes reserved whole by 64-cpu
    nominations."""
    P = pkg.program
    rng = np.random.RandomState(11)
    nodes = lean_cluster(rng, SB_NODES, pkg.wrappers)
    bound = []
    for i in range(600):
        # 7·i mod 5000 is distinct for i < 5000: one bound pod per node,
        # every fifth holding host port 8080
        w = pkg.wrappers.make_pod(f"bound-{i}").req(
            {"cpu": "500m", "memory": "1Gi"}).node(f"node-{7 * i % SB_NODES}")
        if i % 5 == 0:
            w = w.host_port(8080)
        bound.append(w.obj())
    span = 1024
    pods = lean_pods(rng, span - 24, pkg.wrappers, "scan")
    na, batch, table = staged(nodes, bound, pods, device, pkg)
    xs = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=batch.valid[:span], sig=batch.sig[:span],
        tidx=batch.tidx[:span]), device)
    N, R = na.cap.shape
    ovl_used = np.zeros((N, R), np.int64)
    ovl_np = np.zeros((N,), np.int32)
    nom = np.full((span,), -1, np.int32)
    req = batch.table.req
    for k in range(0, span, 10):
        row = (7 * k + 3) % SB_NODES
        nom[k] = row
        ovl_used[row] += req[batch.tidx[k]]
        ovl_np[row] += 1
    for k in range(200):
        row = (13 * k + 1) % SB_NODES
        ovl_used[row, 0] += 64000
        ovl_np[row] += 1
    ovl = (torch.from_numpy(ovl_used).to(device),
           torch.from_numpy(ovl_np).to(device))
    xs_n = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=batch.valid[:span], sig=batch.sig[:span],
        tidx=batch.tidx[:span], nom_idx=nom), device)
    return SimpleNamespace(na=na, batch=batch, table=table, span=span,
                           carry0=P.initial_carry(na), xs=xs, xs_n=xs_n,
                           ovl=ovl, nom=nom)


def check_run_batch(torch, pkg, device, rows: list) -> None:
    P = pkg.program
    b = batch_span_inputs(torch, pkg, device)
    na, batch, table, span = b.na, b.batch, b.table, b.span
    carry0, xs = b.carry0, b.xs
    err = 0.0
    for strategy in ("LeastAllocated", "MostAllocated"):
        cfg = P.ScoreConfig(strategy=strategy)
        kc, ka = P.run_batch(cfg, na, carry0, xs, table)
        pc, pa = P._run_batch_plain(cfg, na, carry0, xs, table)
        torch.cuda.synchronize()
        err = max(err, assert_equal_trees(torch, (ka, kc), (pa, pc),
                                          f"run_batch[{strategy}]"))
    cfg = P.ScoreConfig()
    k_ms = cuda_ms(torch, lambda: P.run_batch(cfg, na, carry0, xs, table), 3)
    t0 = time.perf_counter()
    _, assigned = P._run_batch_plain(cfg, na, carry0, xs, table)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # each input read once, each output written once; a pod whose
    # signature differs from the one before pays the full evaluation, a
    # repeat the SigCache fast path; each placement refreshes one node
    moved = (nbytes(na, carry0, xs, table) + nbytes(carry0)
             + xs.sig.numel() * 4)
    slots = node_slots(na, carry0)
    C = len(cfg.score_cols)
    sigs, tidxs = batch.sig[:span].tolist(), batch.tidx[:span].tolist()
    ops = scan_ops(table, sigs, tidxs, np_of(assigned).tolist(),
                   int(carry0.cache.sig), slots, C)
    bound_ms, bound_by = bound_of(moved, ops)
    log("kernel", name="run_batch", pods=span, nodes=SB_NODES,
        exact=True, max_abs_err=err, ms=k_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, ops=vars(ops), bytes=moved)
    rows.append(dict(
        name="run_batch", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_batch.cu",
        replaces="kubernetes_tpu/ops/program.py:984", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))

    # the overlay variant on the same span
    ovl, xs_n, nom = b.ovl, b.xs_n, b.nom
    kc, ka = P.run_batch(cfg, na, carry0, xs_n, table, overlay=ovl)
    pc, pa = P._run_batch_plain(cfg, na, carry0, xs_n, table, overlay=ovl)
    torch.cuda.synchronize()
    err_o = assert_equal_trees(torch, (ka, kc), (pa, pc), "run_batch[ovl]")
    changed = int((ka != assigned).sum())
    k_ms_o = cuda_ms(torch, lambda: P.run_batch(cfg, na, carry0, xs_n,
                                                table, overlay=ovl), 3)
    t0 = time.perf_counter()
    P._run_batch_plain(cfg, na, carry0, xs_n, table, overlay=ovl)
    torch.cuda.synchronize()
    plain_ms_o = (time.perf_counter() - t0) * 1e3
    # the lean count at this run's placements plus the overlay's work;
    # the overlay's requested columns and counts, the nominated rows
    ops_o = scan_ops(table, sigs, tidxs, np_of(pa).tolist(),
                     int(carry0.cache.sig), slots, C, nom=nom)
    n_nom = int((nom >= 0).sum())
    moved_o = moved + ovl_bytes(ovl, table, tidxs) + nom.nbytes
    bound_o, by_o = bound_of(moved_o, ops_o)
    log("kernel", name="run_batch_ovl", pods=span, nodes=SB_NODES,
        nominated=n_nom, assignments_changed=changed, exact=True,
        max_abs_err=err_o, ms=k_ms_o, plain_ms=plain_ms_o,
        bound_ms=bound_o, ops=vars(ops_o), bytes=moved_o)
    rows.append(dict(
        name="run_batch_ovl", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_batch.cu",
        replaces="kubernetes_tpu/ops/program.py:984", launches=0,
        max_abs_err=err_o, ms=k_ms_o, plain_ms=plain_ms_o,
        bound_ms=bound_o, bound_by=by_o, library_ms=None))


def churn_inputs(torch, pkg, device):
    """run_batch's overlay variant at the shape PreemptionChurn's last
    drain gives it (check_run_batch_churn)."""
    P, W = pkg.program, pkg.wrappers
    n_nodes, _n_init, n_pre, _n_meas, zones = PC_SHAPE
    rng = np.random.RandomState(31)
    nominated = np.sort(rng.choice(n_nodes, n_pre, replace=False))
    free = np.setdiff1d(np.arange(n_nodes), nominated)
    bound = [W.make_pod(f"init-{i}").req({"cpu": "4", "memory": "1Gi"})
             .node(f"node-{i}").obj() for i in free]
    bound += [W.make_pod(f"done-{k}").req({"cpu": "500m", "memory": "256Mi"})
              .node(f"node-{int(i)}").obj()
              for k, i in enumerate(rng.choice(free, 8192))]
    span, bucket = n_pre + 1808, 2048
    pods = [W.make_pod(f"pre-{k}").req({"cpu": "8", "memory": "1Gi"})
            .priority(100).obj() for k in range(n_pre)]
    pods += [W.make_pod(f"meas-{k}").req({"cpu": "500m", "memory": "256Mi"})
             .obj() for k in range(span - n_pre)]
    state = stage(pc_nodes(W, n_nodes, zones), bound, device, pkg)
    batch = pkg.BatchBuilder(state).build(pods)
    na, table = state.device_arrays(), pkg.table_from_batch(batch, device)
    carry0 = P.initial_carry(na)
    N, R = na.cap.shape
    rows_of = np.array([state.node_index[f"node-{i}"] for i in nominated],
                       np.int32)
    ovl_used = np.zeros((N, R), np.int64)
    ovl_np = np.zeros((N,), np.int32)
    ovl_used[rows_of] = batch.table.req[batch.tidx[0]]
    ovl_np[rows_of] = 1
    ovl = (torch.from_numpy(ovl_used).to(device),
           torch.from_numpy(ovl_np).to(device))

    def padded(x, fill):
        out = np.full((bucket,), fill, x.dtype)
        out[:span] = x[:span]
        return out
    sig = padded(batch.sig, batch.sig[span - 1])
    tidx = padded(batch.tidx, batch.tidx[span - 1])
    nom = np.full((bucket,), -1, np.int32)
    nom[:n_pre] = rows_of
    xs = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=padded(batch.valid, False), sig=sig, tidx=tidx, nom_idx=nom),
        device)
    return SimpleNamespace(na=na, table=table, carry0=carry0, xs=xs, ovl=ovl,
                           span=span, bucket=bucket, n_pre=n_pre,
                           rows_of=rows_of, sig=sig, tidx=tidx, nom=nom,
                           n_nodes=n_nodes)


def check_run_batch_edges(torch, pkg, device) -> None:
    """run_batch on tests/_batch_edges.py's RUN_BATCH_EDGE_CASES (ties at
    CTA boundaries, N not a multiple of the cluster's rows, equal to and
    above them, signature changes every pod / every other pod / never, a
    row outside the table, invalid pods, full port slots, nominated rows
    at a CTA boundary and on invalid nodes, every group family): the
    kernel over the whole span against the plain version on the span
    without the rows outside the table, exactly."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _batch_edges import (RUN_BATCH_EDGE_CASES, check_span, full_span,
                              kept, stage)
    from kubernetes_tpu_torch.ops.groups import GroupFamilies
    from kubernetes_tpu_torch.state.batch import BatchDims
    P, conv = pkg.program, pkg.convert
    layer = SimpleNamespace(Cache=pkg.Cache, Snapshot=pkg.Snapshot,
                            ClusterState=pkg.ClusterState,
                            BatchBuilder=pkg.BatchBuilder,
                            BatchDims=BatchDims, W=pkg.wrappers)
    cfg = P.ScoreConfig()
    for case in sorted(RUN_BATCH_EDGE_CASES):
        e = stage(case, layer)
        keep = kept(e)
        outs = []
        for dev, sl in ((device, slice(None)), ("cpu", keep)):
            na = conv.node_arrays_from_numpy(e.arrays, dev)
            gd = gc = fam = ovl = None
            if e.mode == "groups":
                gd = conv.groups_dev_from_numpy(e.gd, dev)
                gc = conv.group_carry_from_numpy(e.gc, dev)
                fam = GroupFamilies(*e.fam)
            if e.mode == "ovl":
                ovl = (torch.from_numpy(e.ovl_used).to(dev),
                       torch.from_numpy(e.ovl_npods).to(dev))
            xs = conv.pod_xs_from_numpy(P.PodXs(
                valid=e.valid[sl], sig=e.sig[sl], tidx=e.tidx[sl],
                nom_idx=None if e.nom_idx is None else e.nom_idx[sl]), dev)
            run = P.run_batch if dev == device else P._run_batch_plain
            outs.append(run(cfg, na, P.initial_carry(na, gc), xs,
                            conv.pod_table_from_numpy(e.table, dev), gd, fam,
                            overlay=ovl))
        torch.cuda.synchronize()
        (kc, ka), (pc, pa) = outs
        got = np_of(ka).tolist()
        if got != full_span(e, np_of(pa)):
            fail(f"run_batch edge {case}: assignments differ")
        assert_equal_trees(torch, to_cpu(kc), pc, f"run_batch edge {case}")
        check_span(case, got)
    log("kernel_edges", name="run_batch", cases=sorted(RUN_BATCH_EDGE_CASES),
        exact=True)


def check_run_batch_churn(torch, pkg, device) -> None:
    """run_batch's overlay variant at the shape PreemptionChurn's last
    drain gives it: the 8-cpu cluster after the preemptor wave (an init
    pod of 4 cpu on every node but the 200 nominated ones, 8,192 measured
    pods of 500m / 256 Mi bound at seeded nodes), the 200 preemptors
    (8 cpu / 1 Gi, each nominated on its own node) and 1,808 measured
    pods in one scan span padded to a 2,048 bucket, as the scheduler's
    _scan_dispatch pads it. Every preemptor must land on its nominated
    node. Logs the times and bound beside the kernel table's row."""
    P = pkg.program
    c = churn_inputs(torch, pkg, device)
    na, table, carry0, xs, ovl = c.na, c.table, c.carry0, c.xs, c.ovl
    span, bucket, n_pre, rows_of = c.span, c.bucket, c.n_pre, c.rows_of
    sig, tidx, nom, n_nodes = c.sig, c.tidx, c.nom, c.n_nodes
    cfg = P.ScoreConfig()
    kc, ka = P.run_batch(cfg, na, carry0, xs, table, overlay=ovl)
    t0 = time.perf_counter()
    pc, pa = P._run_batch_plain(cfg, na, carry0, xs, table, overlay=ovl)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = assert_equal_trees(torch, (ka, kc), (pa, pc),
                             "run_batch[ovl, PreemptionChurn span]")
    got = np_of(ka)
    if (got[:n_pre] != rows_of).any():
        fail("run_batch[ovl, PreemptionChurn span]: a preemptor left its "
             "nominated node")
    k_ms = cuda_ms(torch, lambda: P.run_batch(cfg, na, carry0, xs, table,
                                              overlay=ovl), 3)
    ops = scan_ops(table, sig.tolist(), tidx.tolist(), got.tolist(),
                   int(carry0.cache.sig), node_slots(na, carry0),
                   len(cfg.score_cols), nom=nom)
    # as the lean row's count, plus the overlay
    moved = (nbytes(na, carry0, xs, table) + nbytes(carry0) + bucket * 4
             + ovl_bytes(ovl, table, tidx))
    bound_ms, bound_by = bound_of(moved, ops)
    log("kernel", name="run_batch_ovl", shape="PreemptionChurn span",
        pods=span, bucket=bucket, nodes=n_nodes, nominated=n_pre,
        bound_pods=int((got[:span] >= 0).sum()), exact=True,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, ops=vars(ops), bytes=moved)


def sb_uniform_inputs(pkg, device):
    """SchedulingBasic's closed-form shape: 5,000 harness nodes holding
    its init pods, one 900m / 1 Gi signature, L = K = 8,192, J = 8
    (scheduler._uniform_shape at batch 8,192 over 5,000 nodes): (cfg, na,
    carry0, x, table, L, K, J)."""
    P = pkg.program
    W = pkg.wrappers
    nodes = [W.make_node(f"node-{i}").capacity(
        {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % 16}").label("kubernetes.io/hostname", f"node-{i}").obj()
        for i in range(SB_NODES)]
    rng = np.random.RandomState(5)
    bound = [W.make_pod(f"init-{i}").req({"cpu": "900m", "memory": "1Gi"})
             .node(f"node-{int(rng.randint(0, SB_NODES))}").obj()
             for i in range(SB_INIT_PODS)]
    pods = [W.make_pod(f"p{i}").req({"cpu": "900m", "memory": "1Gi"}).obj()
            for i in range(4)]
    na, batch, table = staged(nodes, bound, pods, device, pkg)
    L, K, J = BATCH, min(BATCH, na.cap.shape[0]), 8
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    return P.ScoreConfig(), na, P.initial_carry(na), x, table, L, K, J


def sb_overlay(torch, na, device):
    """The nominated-pod overlay at SchedulingBasic's shape: 200 nodes
    each reserved by nominations of 31 cpu / 1 Gi (room for one run pod
    at most)."""
    N, R = na.cap.shape
    ovl_used = np.zeros((N, R), np.int64)
    ovl_np = np.zeros((N,), np.int32)
    rows_n = (17 * np.arange(200) + 5) % SB_NODES
    ovl_used[rows_n, 0] = 31000
    ovl_used[rows_n, 1] = 1 << 30
    ovl_np[rows_n] = 1
    return (torch.from_numpy(ovl_used).to(device),
            torch.from_numpy(ovl_np).to(device))


def gang_uniform_inputs(pkg, device, lean: bool):
    """GangTraining's closed form: one 900m / 1 Gi gang signature over
    gang_nodes(lean) padded to 8,192 rows (L = K = 256, J = 8, the
    Scheduler's gang shape): (na, x, table, K)."""
    P = pkg.program
    W = pkg.wrappers
    proto = W.make_pod("gang-proto").req({"cpu": "900m", "memory": "1Gi"})\
        .workload("gang").obj()
    na, batch, table = staged(gang_nodes(W, lean=lean), (), [proto], device,
                              pkg)
    x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
    return na, x, table, min(256, na.cap.shape[0])


def closed_form_times(torch, pkg, device, reps: int = 10) -> dict:
    """The single-device closed form at its main-path shapes: timed ms
    (CUDA events over `reps` calls), device ms and its split by kernel
    (torch.profiler), and torch.topk of the same flat keys (the library
    yardstick) — run_uniform lean and with the overlay at
    SchedulingBasic's shape (n_actual = 8,192), run_gang's closed form
    accepted at GangTraining's. Only the port's public entries are
    called, so an older checkout is timed the same way
    (`--times closed_form ROOT`)."""
    from kubernetes_tpu_torch.ops import gang as G
    P = pkg.program
    cfg, na, carry0, x, table, L, K, J = sb_uniform_inputs(pkg, device)
    ovl = sb_overlay(torch, na, device)
    gna, gx, gtable, gK = gang_uniform_inputs(pkg, device, lean=False)
    gcarry = P.initial_carry(gna)
    runs = {
        "run_uniform": (lambda: P.run_uniform(
            cfg, na, carry0, x, table, BATCH, L, K, J),
            flat_keys(torch, P, cfg, na, carry0, x, table, K, J), L),
        "run_uniform_ovl": (lambda: P.run_uniform(
            cfg, na, carry0, x, table, BATCH, L, K, J, overlay=ovl),
            flat_keys(torch, P, cfg, na, carry0, x, table, K, J,
                      overlay=ovl), L),
        "run_gang_uniform": (lambda: G.run_gang(
            cfg, gna, gcarry, gx, gtable, needed=256, uniform=True,
            n_actual=256, L=256, K=gK, J=8),
            flat_keys(torch, P, cfg, gna, gcarry, gx, gtable, gK, 8), 256),
    }
    out = {}
    for name, (fn, keys, k) in runs.items():
        out[name] = dict(
            ms=cuda_ms(torch, fn, reps), device_ms=device_ms(torch, fn, reps),
            device_split=device_split(torch, fn, reps),
            library_ms=cuda_ms(torch, lambda: torch.topk(keys, k), reps))
    return out


def check_run_uniform(torch, pkg, device, rows: list) -> None:
    """run_uniform and its overlay variant held bit for bit to their
    plain versions at SchedulingBasic's shape (K = N = 8,192: every row
    a candidate; n_actual 8,192 and 5,000; J = 2 from the output carry,
    the SigCache fast path) and in every branch of csrc/run_uniform.cu
    at full width: the top K rows selected (K = 256 over 8,192 rows, and
    K = 64 over a 512-row cluster), n_actual far below L, both strategies
    on a mixed cluster, the overlay in each; then timed beside
    torch.topk."""
    P = pkg.program
    W = pkg.wrappers
    cfg, na, carry0, x, table, L, K, J = sb_uniform_inputs(pkg, device)
    ovl = sb_overlay(torch, na, device)
    err = err_o = 0.0

    def held(what, cfg_, na_, c_, x_, t_, n_, L_, K_, J_, ovl_=None):
        kc, kp = P.run_uniform(cfg_, na_, c_, x_, t_, n_, L_, K_, J_,
                               overlay=ovl_)
        pc, pp = P._run_uniform_plain(cfg_, na_, c_, x_, t_, n_, L_, K_,
                                      J_, overlay=ovl_)
        torch.cuda.synchronize()
        e = assert_equal_trees(torch, (kp, kc), (pp, pc), what)
        return kc, kp, pc, e

    for n_actual in (BATCH, 5000):
        kc, kp, pc, e = held(f"run_uniform[n={n_actual}]", cfg, na, carry0,
                             x, table, n_actual, L, K, J)
        err = max(err, e)
        log("kernel", name="run_uniform", n_actual=n_actual, exact=True,
            flags=kp[L:].tolist())
        if n_actual == BATCH:
            kc_full, kp_full, pc_full = kc, kp, pc
    # depth overflow and the fast path (cache hit) on the same inputs
    kc2, kp2 = P.run_uniform(cfg, na, kc_full, x, table, 900, L, K, 2)
    pc2, pp2 = P._run_uniform_plain(cfg, na, pc_full, x, table, 900, L, K,
                                    2)
    err = max(err, assert_equal_trees(torch, (kp2, kc2), (pp2, pc2),
                                      "run_uniform[J=2]"))
    # the branches: (what, K, L, J, n_actual), lean and with the overlay
    for what, K_b, L_b, J_b, n_b in (("select K=256", 256, 256, 8, 256),
                                     ("select K=256 n=100", 256, 256, 8,
                                      100),
                                     ("all rows n=100", K, L, J, 100)):
        err = max(err, held(f"run_uniform[{what}]", cfg, na, carry0, x,
                            table, n_b, L_b, K_b, J_b)[3])
        err_o = max(err_o, held(f"run_uniform[ovl, {what}]", cfg, na,
                                carry0, x, table, n_b, L_b, K_b, J_b,
                                ovl)[3])
    small = lean_cluster(np.random.RandomState(4), 500, W)
    for s, proto in enumerate(lean_pods(np.random.RandomState(3), 8, W,
                                        "uni", ports=False)[:4]):
        na_m, b_m, t_m = staged(small, (), [proto], device, pkg)
        if b_m.sig[0] == 0:
            continue
        xm = P.PodXs(True, int(b_m.sig[0]), int(b_m.tidx[0]))
        err = max(err, held(f"run_uniform[500 nodes {s}, K=64]", cfg, na_m,
                            P.initial_carry(na_m), xm, t_m, 128, 128, 64,
                            4)[3])
    # a mixed cluster: taints, images, selectors, both strategies
    mixed = lean_cluster(np.random.RandomState(9), SB_NODES, W)
    for s, proto in enumerate(lean_pods(np.random.RandomState(3), 8, W,
                                        "uni", ports=False)[:4]):
        na_m, b_m, t_m = staged(mixed, (), [proto], device, pkg)
        if b_m.sig[0] == 0:
            continue
        xm = P.PodXs(True, int(b_m.sig[0]), int(b_m.tidx[0]))
        cm = P.initial_carry(na_m)
        km = min(4096, na_m.cap.shape[0])
        for strategy in ("LeastAllocated", "MostAllocated"):
            err = max(err, held(f"run_uniform[mixed{s},{strategy}]",
                                P.ScoreConfig(strategy=strategy), na_m, cm,
                                xm, t_m, 3000, 4096, km, 8)[3])
    log("kernel", name="run_uniform", branches=True, exact=True)

    times = closed_form_times(torch, pkg, device)
    t = times["run_uniform"]
    plain_ms = cuda_ms(torch, lambda: P._run_uniform_plain(
        cfg, na, carry0, x, table, BATCH, L, K, J), 3)
    w = uniform_work(torch, P, cfg, na, carry0, x, table, L, K, J,
                     (kc_full, kp_full))
    moved, ops, entry, feasible, pod, nreq, slots = (
        w.moved, w.ops, w.entry, w.feasible, w.pod, w.nreq, w.slots)
    bound_ms, bound_by = bound_of(moved, ops)
    log("kernel", name="run_uniform", plain_ms=plain_ms, L=L, K=K, J=J,
        max_abs_err=err, bound_ms=bound_ms, ops=vars(ops), bytes=moved,
        under_library=t["device_ms"] < t["library_ms"], **t)
    rows.append(dict(
        name="run_uniform", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_uniform.cu",
        replaces="kubernetes_tpu/ops/program.py:1207", launches=0,
        max_abs_err=err, ms=t["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=t["library_ms"],
        device_ms=t["device_ms"]))

    # the overlay variant at the same shape
    kco, kpo, _pco, e = held("run_uniform[ovl]", cfg, na, carry0, x, table,
                             BATCH, L, K, J, ovl)
    err_o = max(err_o, e)
    changed = int((kpo[:L] != kp_full[:L]).sum())
    t_o = times["run_uniform_ovl"]
    plain_ms_o = cuda_ms(torch, lambda: P._run_uniform_plain(
        cfg, na, carry0, x, table, BATCH, L, K, J, overlay=ovl), 3)
    # the lean count plus the overlay's adds on every fit (one per
    # requested column and the pod count): the run's row over the valid
    # nodes and every matrix entry
    feasible_o = int(P._eval_pod(cfg, na, carry0, pod, overlay=ovl)[0]
                     .sum())
    ops_o = (ops + entry * ((feasible_o - feasible) * J)
             + Ops(i64=nreq + 1) * (slots["n_valid"] + feasible_o * J))
    moved_o = moved + ovl_bytes(ovl, table, [x.tidx])
    bound_o, by_o = bound_of(moved_o, ops_o)
    log("kernel", name="run_uniform_ovl", plain_ms=plain_ms_o, L=L, K=K,
        J=J, nominated_nodes=200, assignments_changed=changed,
        flags=kpo[L:].tolist(), max_abs_err=err_o, bound_ms=bound_o,
        ops=vars(ops_o), bytes=moved_o,
        under_library=t_o["device_ms"] < t_o["library_ms"], **t_o)
    log("kernel", name="run_gang_uniform", closed_form_times=True,
        **times["run_gang_uniform"])
    rows.append(dict(
        name="run_uniform_ovl", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_uniform.cu",
        replaces="kubernetes_tpu/ops/program.py:1207", launches=0,
        max_abs_err=err_o, ms=t_o["ms"], plain_ms=plain_ms_o,
        bound_ms=bound_o, bound_by=by_o, library_ms=t_o["library_ms"],
        device_ms=t_o["device_ms"]))


def uniform_work(torch, P, cfg, na, carry0, x, table, L, K, J, out):
    """The bytes and operations one closed-form run needs, from its
    output `out` = (carry', packed): the run's row over the valid nodes
    at carry0 (an empty SigCache: the full evaluation) and its candidate
    keys; the top-K of those keys; the [K, J] entries of the feasible
    candidates (fit, scores, key, monotonicity); the top-L of those
    entries; per touched node the carry update."""
    kc, kp = out
    moved = (nbytes(na.cap, na.allowed_pods, na.valid, na.unschedulable,
                    na.name_id, na.taint_key, na.taint_val, na.taint_eff,
                    na.label_key, na.label_kv, na.label_num, na.image_id,
                    na.image_size, carry0) + nbytes(kc.used, kc.nonzero_used,
                                                    kc.npods, kc.cache, kp))
    slots = node_slots(na, carry0)
    C = len(cfg.score_cols)
    pod = P._gather_row(table, x.tidx, True, x.sig)
    feasible = int(P._eval_pod(cfg, na, carry0, pod)[0].sum())
    nreq = int((np_of(table.req[x.tidx]) != 0).sum())
    placed = kp[:L][kp[:L] >= 0]
    touched = int(torch.unique(placed).numel())
    entry = score_ops(C, nreq, True) + Ops(i64=nreq + 4 + 3 + 1)
    ops = (eval_ops(table, x.tidx, slots, C) + Ops(i64=4) * slots["n_valid"]
           + select_ops(slots["n_valid"], K) + entry * (feasible * J)
           + select_ops(feasible * J, L) + Ops(i32=L)
           + Ops(i32=1, i64=2 * nreq + 4) * touched)
    return SimpleNamespace(moved=moved, ops=ops, entry=entry,
                           feasible=feasible, pod=pod, nreq=nreq,
                           slots=slots)


def flat_keys(torch, P, cfg, na, carry, x, table, K, J, overlay=None):
    """The [K·J] flat keys run_uniform selects its top-L from (plain
    version, the overlay in the fit), for the torch.topk yardstick."""
    pod = P._gather_row(table, x.tidx, True, x.sig)
    feas, total, parts = P._eval_pod(cfg, na, carry, pod, overlay=overlay)
    masked0 = torch.where(feas, total, torch.full_like(total, -1))
    N = masked0.shape[0]
    ar = torch.arange(N, device=masked0.device)
    cand = N - 1 - torch.sort((masked0 + 1) * N + (N - 1 - ar),
                              descending=True).values[:K] % N
    fit_used, fit_npods = carry.used, carry.npods
    if overlay is not None:
        fit_used, fit_npods = carry.used + overlay[0], carry.npods + overlay[1]
    fit, s_fit, s_bal = P._uniform_matrix(cfg, na, fit_used, fit_npods,
                                          carry.used, carry.nonzero_used,
                                          cand, pod, J)
    score = cfg.w_fit * s_fit + cfg.w_balanced * s_bal
    masked = torch.where(fit, score, torch.full_like(score, -1))
    ent = cand[:, None] * J + torch.arange(J, device=cand.device)[None, :]
    return (masked * (N * J) - ent).reshape(-1).contiguous()


# ---------------------------------------------------------------------------
# phase 3, the group path: full-width shapes of TopologySpreading and
# SchedulingPodAntiAffinity


def harness_nodes(W, n: int, zones: int):
    """perf/harness.py _make_nodes: 32 cpu / 64 Gi / 110 pods."""
    return [W.make_node(f"node-{i}").capacity(
        {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % zones}").label(LABEL_HOSTNAME, f"node-{i}").obj()
        for i in range(n)]


def group_pod(W, name: str, kind: str):
    """The measured pods of the two workloads (performance-config.yaml
    podTemplate): a zone DoNotSchedule spread with maxSkew 5 over
    app=spread, or a required zone anti-affinity against anti=yes."""
    w = W.make_pod(name).req({"cpu": "900m", "memory": "1Gi"})
    if kind == "spread":
        return w.label("app", "spread").spread_constraint(
            5, LABEL_ZONE, "DoNotSchedule", {"app": "spread"}).obj()
    return w.label("anti", "yes").pod_affinity(
        LABEL_ZONE, {"anti": "yes"}, anti=True).obj()


def group_staged(pkg, device, nodes, bound, pods):
    """(na, batch, table, gd, gc, fam, builder, state, snapshot) through the
    port's own state layer, the group tensors on `device`."""
    from kubernetes_tpu_torch.ops.groups import to_device
    cache = pkg.Cache()
    for nd in nodes:
        cache.add_node(nd)
    for p in bound:
        cache.add_pod(p)
    snap = pkg.Snapshot()
    cache.update_snapshot(snap)
    state = pkg.ClusterState(device=device)
    state.apply_snapshot(snap, full=True)
    builder = pkg.BatchBuilder(state)
    batch = builder.build(pods)
    if batch.host_fallback[:len(pods)].any():
        fail("smoke inputs hit a host-fallback signature")
    gd_np, gc_np = builder.groups.build_dev(snap)
    return (state.device_arrays(), batch,
            pkg.table_from_batch(batch, device), to_device(gd_np, device),
            to_device(gc_np, device), builder.groups.families(snap),
            builder, state)


def check_scatter_rows(torch, pkg, device, rows: list) -> None:
    """The TopologySpreading reseed's upload: 1,000 dirty rows (the nodes
    the init pods landed on) into the 8,192-row NodeArrays."""
    P = pkg.program
    W = pkg.wrappers
    nodes = lean_cluster(np.random.RandomState(21), SB_NODES, W)
    na, _, _ = staged(nodes, (), [W.make_pod("p").obj()], device, pkg)
    other = lean_cluster(np.random.RandomState(22), SB_NODES, W)
    na2, _, _ = staged(other, (), [W.make_pod("p").obj()], device, pkg)
    idx = np.sort(np.random.RandomState(23).choice(
        SB_NODES, TS_SHAPE[1], replace=False)).astype(np.int64)
    it = torch.from_numpy(idx).to(device)
    rows_in = type(na)(*(x[it].contiguous() for x in na2))
    before = type(na)(*(x.clone() for x in na))
    got = P.scatter_rows(na, idx, rows_in)
    want = P._scatter_rows_plain(na, idx, rows_in)
    torch.cuda.synchronize()
    err = assert_equal_trees(torch, got, want, "scatter_rows")
    assert_equal_trees(torch, na, before, "scatter_rows input")
    k_ms = cuda_ms(torch, lambda: P.scatter_rows(na, idx, rows_in), 20)
    plain_ms = cuda_ms(torch, lambda: P._scatter_rows_plain(
        na, idx, rows_in), 20)
    # the fresh copy: every field read and written once, plus the rows
    moved = 2 * nbytes(na) + nbytes(rows_in) + idx.nbytes
    bound_ms, bound_by = bound_of(moved, Ops())
    dev_ms = device_ms(torch, lambda: P.scatter_rows(na, idx, rows_in), 20)
    plain_dev_ms = device_ms(torch, lambda: P._scatter_rows_plain(
        na, idx, rows_in), 20)
    log("kernel", name="scatter_rows", rows=len(idx), nodes=SB_NODES,
        exact=True, max_abs_err=err, ms=k_ms, device_ms=dev_ms,
        plain_ms=plain_ms, plain_device_ms=plain_dev_ms, bound_ms=bound_ms,
        bytes=moved)
    rows.append(dict(
        name="scatter_rows", route="cuda",
        source="kubernetes_tpu_torch/csrc/scatter_rows.cu",
        replaces="kubernetes_tpu/ops/program.py:722", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))


def time_initial_carry(torch, pkg, device) -> None:
    """initial_carry is eager in both packages (clones of the aggregate
    columns, a zeroed SigCache, the seeded group counts passed through):
    not a kernel, so it has no row in the kernel line; its time at the
    TopologySpreading reseed shape is logged for the kernel table."""
    P = pkg.program
    W = pkg.wrappers
    nodes = harness_nodes(W, TS_SHAPE[0], TS_SHAPE[3])
    na, _b, _t, _gd, gc, _f, _bl, _s = group_staged(
        pkg, device, nodes, (), [group_pod(W, "s", "spread")])
    ms = cuda_ms(torch, lambda: P.initial_carry(na, gc), 50)
    c = P.initial_carry(na, gc)
    moved = nbytes(na.used, na.nonzero_used, na.npods, na.ports) + nbytes(
        c.used, c.nonzero_used, c.npods, c.ports, c.cache)
    bound_ms, bound_by = bound_of(moved, Ops())
    log("eager", name="initial_carry", ms=ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=moved)


def check_wave_statics(torch, pkg, device, rows: list) -> None:
    """The main path's call (one spread row on the harness cluster: no
    taints, selectors or images, so every family flag is off), and four
    mixed rows with every family on over a tainted, labelled cluster."""
    P = pkg.program
    W = pkg.wrappers
    nodes = harness_nodes(W, TS_SHAPE[0], TS_SHAPE[3])
    na, batch, table = staged(nodes, (), [group_pod(W, "s", "spread")],
                              device, pkg)
    u = int(batch.tidx[0])
    feats = (False, False, False)
    err = assert_equal_trees(torch, P.wave_statics(na, table, [u], feats),
                             P._wave_statics_plain(na, table, [u], feats),
                             "wave_statics[main]")
    mixed = lean_cluster(np.random.RandomState(31), SB_NODES, W)
    pods = lean_pods(np.random.RandomState(32), 8, W, "ws", ports=False)
    na_m, b_m, t_m = staged(mixed, (), pods, device, pkg)
    rows_m = sorted(set(int(t) for t in b_m.tidx[:8]))[:4]
    for fl in ((True, True, True), (True, False, True)):
        err = max(err, assert_equal_trees(
            torch, P.wave_statics(na_m, t_m, rows_m, fl),
            P._wave_statics_plain(na_m, t_m, rows_m, fl),
            f"wave_statics[mixed,{fl}]"))
    k_ms = cuda_ms(torch, lambda: P.wave_statics(na, table, [u], feats), 20)
    plain_ms = cuda_ms(torch, lambda: P._wave_statics_plain(
        na, table, [u], feats), 5)
    mixed_ms = cuda_ms(torch, lambda: P.wave_statics(
        na_m, t_m, rows_m, (True, True, True)), 20)
    N = na.valid.shape[0]
    # main path: valid, name id and unschedulable read, four [N] surfaces
    # written; three tests and a select per node
    moved = nbytes(na.valid, na.name_id, na.unschedulable) + N * (1 + 24)
    bound_ms, bound_by = bound_of(moved, Ops(i32=4 * N))
    dev_ms = device_ms(torch, lambda: P.wave_statics(na, table, [u], feats),
                       20)
    plain_dev_ms = device_ms(torch, lambda: P._wave_statics_plain(
        na, table, [u], feats), 5)
    log("kernel", name="wave_statics", exact=True, max_abs_err=err,
        ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms,
        plain_device_ms=plain_dev_ms, mixed_4rows_ms=mixed_ms,
        bound_ms=bound_ms, bytes=moved)
    rows.append(dict(
        name="wave_statics", route="cuda",
        source="kubernetes_tpu_torch/csrc/wave_statics.cu",
        replaces="kubernetes_tpu/ops/program.py:1635", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))


def wave_inputs(torch, pkg, device, kind: str):
    """Full-width run_wave inputs as the scheduler builds them for the
    workload's first measured drain: (args for program.run_wave, packed
    layout B, shape dict)."""
    P = pkg.program
    W = pkg.wrappers
    n_nodes, n_init, n_meas, zones = TS_SHAPE if kind == "spread" else AA_SHAPE
    nodes = harness_nodes(W, n_nodes, zones)
    # the init pods where the scheduler's uniform run puts them on the
    # empty, identical harness nodes: one per node, lowest index first
    bound = [W.make_pod(f"init-{i}").req({"cpu": "900m", "memory": "1Gi"})
             .node(f"node-{i}").obj() for i in range(n_init)]
    # the drain the scheduler dispatches: the first 4,096 spread pods, or
    # all 2,000 anti pods
    m = 4096 if kind == "spread" else n_meas
    pods = [group_pod(W, f"g{i}", kind) for i in range(m)]
    na, batch, table, gd, gc, fam, builder, state = group_staged(
        pkg, device, nodes, bound, pods)
    u = int(batch.tidx[0])
    from kubernetes_tpu_torch.compiler.plan import wave_same_mode
    mode, anti = wave_same_mode(builder.groups, u)
    if mode != "merge":
        fail(f"run_wave[{kind}]: expected a merge-mode row, got {mode}")
    B = 1 << (m - 1).bit_length()
    valid = torch.zeros((B,), dtype=torch.bool, device=device)
    valid[:m] = True
    statics = tuple(x[0] for x in P.wave_statics(na, table, [u]))
    N = na.cap.shape[0]
    # scheduler._wave_dispatch's shape choice at batch 8,192
    Lw = min(512 if fam.spr_f else 1024, B)
    K = min(Lw, N)
    J = 1 if (anti >= 0 and not fam.spr_f) else 8
    norm_live = not P.static_norm_ok(state.ensure_arrays(),
                                     builder.table.pref_weight[u])
    carry = P.initial_carry(na, gc)
    args = (P.ScoreConfig(), na, carry, valid, table, u, gd, statics, K, J,
            Lw, fam, norm_live, anti, True)
    return args, B, dict(kind=kind, pods=m, B=B, Lw=Lw, K=K, J=J,
                         anti_term=anti, norm_live=norm_live)


def wave_ops(pkg, args, stats, slots) -> Ops:
    """The operations one run_wave call needs for these inputs: per merge
    wave the row's evaluation on every valid node, the top-K and top-Lw
    selections, the [K, J] entries, the spread replay and the fold; per
    serial step an evaluation and an argmax; then the fold into the
    group carry."""
    cfg, na, carry, valid, table, u, gd, statics, K, J, Lw, fam = args[:12]
    P = pkg.program
    C = len(cfg.score_cols)
    nreq = int((np_of(table.req[u]) != 0).sum())
    SC, TAA = gd.spr_f_active.shape[1], gd.ipa_raa_active.shape[1]
    nv = slots["n_valid"]
    group = Ops(i32=(4 * SC if fam.spr_f else 0)
                + (1 + 3 * TAA if fam.ipa_anti else 0))
    per_node = score_ops(C, nreq, True) + Ops(i64=8) + group
    evaluation = per_node * nv + Ops(i32=SC * nv)
    entry = score_ops(C, nreq, True) + Ops(i64=nreq + 4)
    waves, serial = int(stats[0]), int(stats[3])
    wave = (evaluation + select_ops(nv, K) + entry * (K * J)
            + select_ops(K * J, Lw) + Ops(i64=nv if args[13] >= 0 else 0)
            + Ops(i64=(nreq + 4) * Lw))
    if fam.spr_f:
        # the replay: two prefix counts over the ordered entries (rank in
        # domain, rank in level), the 32 levels' climb, the elig_dom marks
        # and the d_need counts on every valid node
        wave = wave + Ops(i32=2 * Lw * SC + 2 * SC * nv
                          + Lw * SC * 33 + 3 * SC * nv)
    U = gd.spr_f_active.shape[0]
    fold = Ops(i32=3 * U * SC * nv) if fam.spr_f else Ops()
    if fam.ipa_anti:
        fold = fold + Ops(i32=3 * U * TAA * nv)
    return wave * waves + (evaluation + Ops(i64=2 * nv)) * serial + fold


def check_run_wave(torch, pkg, device, rows: list) -> None:
    P = pkg.program
    err = 0.0
    times = {}
    first = None
    for kind in ("spread", "anti"):
        args, B, shape = wave_inputs(torch, pkg, device, kind)
        cfg, na, carry, valid, table, u, gd, statics, K, J, Lw, fam, \
            norm_live, anti, merge = args
        kc, kp = P.run_wave(cfg, na, carry, valid, table, u, gd, statics, K,
                            J, fam, norm_live, anti_term=anti,
                            merge_on=merge, Lw=Lw)
        pc, pp = P._run_wave_plain(*args)
        torch.cuda.synchronize()
        err = max(err, assert_equal_trees(torch, (kp, kc), (pp, pc),
                                          f"run_wave[{kind}]"))
        stats = kp[B:].tolist()
        def kern():
            return P.run_wave(cfg, na, carry, valid, table, u, gd, statics,
                              K, J, fam, norm_live, anti_term=anti,
                              merge_on=merge, Lw=Lw)
        k_ms = cuda_ms(torch, kern, 5)
        dev_ms = device_ms(torch, kern, 5)
        plain_ms = cuda_ms(torch, lambda: P._run_wave_plain(*args), 1,
                           warmup=0)
        slots = node_slots(na, carry)
        ops = wave_ops(pkg, args, stats, slots)
        wt_slices = [getattr(gd, f)[u] for f in (
            "spr_f_tv", "spr_f_elig", "spr_f_dom", "ipa_raa_tv",
            "ipa_raa_dom")]
        moved = (nbytes(na.cap, na.allowed_pods, statics, carry.used,
                        carry.nonzero_used, carry.npods, carry.groups,
                        wt_slices, valid)
                 + nbytes(kc.used, kc.nonzero_used, kc.npods, kc.groups,
                          kp))
        bound_ms, bound_by = bound_of(moved, ops)
        times[kind] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           waves=stats[0],
                           conflicts=stats[1], first_prefix=stats[2],
                           serial_steps=stats[3], ops=vars(ops),
                           bytes=moved, **shape)
        log("kernel", name="run_wave", exact=True, max_abs_err=err,
            ptxas=ptxas_report(pkg, "run_wave", "run_wave_kernel"),
            **times[kind])
        if first is None:
            first = times[kind]
    rows.append(dict(
        name="run_wave", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_wave.cu",
        replaces="kubernetes_tpu/ops/program.py:1703", launches=0,
        max_abs_err=err, ms=first["ms"], device_ms=first["device_ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=None,
        by_shape={k: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "waves")}
                  for k, v in times.items()}))


def check_run_wave_edges(torch, pkg, device) -> None:
    """run_wave on tests/_wave_edges.py's WAVE_EDGE_CASES (ties across the
    cluster's CTA splits and at the K-th key, a top-Lw cut inside a node's
    entries, an anti term with keyless nodes, the spread replay reaching
    M_CAP, a capacity-exhausted serial tail, norm_live with the merge
    off): the kernel against the plain version, exactly."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _wave_edges import CPU_CASES, check_case, stage
    from kubernetes_tpu_torch.ops.groups import GroupFamilies
    P, conv = pkg.program, pkg.convert
    layer = SimpleNamespace(Cache=pkg.Cache, Snapshot=pkg.Snapshot,
                            ClusterState=pkg.ClusterState,
                            BatchBuilder=pkg.BatchBuilder, W=pkg.wrappers,
                            static_norm_ok=P.static_norm_ok)
    cfg = P.ScoreConfig()
    for case in CPU_CASES:
        e = stage(case, layer)
        outs = []
        for dev in (device, "cpu"):
            na = conv.node_arrays_from_numpy(e.arrays, dev)
            table = conv.pod_table_from_numpy(e.table, dev)
            gd = conv.groups_dev_from_numpy(e.gd, dev)
            gc = conv.group_carry_from_numpy(e.gc, dev)
            statics = tuple(x[0] for x in P.wave_statics(na, table, [e.u]))
            valid = torch.from_numpy(e.valid.copy()).to(dev)
            args = (cfg, na, P.initial_carry(na, gc), valid, table, e.u,
                    gd, statics, e.K, e.J, e.Lw, GroupFamilies(*e.fam),
                    e.norm_live, e.anti, e.merge_on)
            if dev == device:
                outs.append(P.run_wave(*args[:10], args[11], args[12],
                                       anti_term=e.anti,
                                       merge_on=e.merge_on, Lw=e.Lw))
            else:
                outs.append(P._run_wave_plain(*args))
        torch.cuda.synchronize()
        (kc, kp), (pc, pp) = outs
        assert_equal_trees(torch, (to_cpu(kp), to_cpu(kc)), (pp, pc),
                           f"run_wave edge {case}")
        B = e.valid.shape[0]
        check_case(case, np_of(kp)[:e.n], np_of(kp)[B:])
    log("kernel_edges", name="run_wave", cases=CPU_CASES, exact=True)


def groups_span_inputs(pkg, device, span: int = 1024, seed: int = 51):
    """Row 1g's span: `span` pods over the 5,000-node harness cluster in 16
    zones (500 bound spread pods), rotating four group signatures (zone
    spread, hostname ScheduleAnyway spread, zone anti-affinity, preferred
    pod affinity) plus plain pods. Returns (na, batch, table, gd, gc,
    fam, xs)."""
    P = pkg.program
    W = pkg.wrappers
    nodes = harness_nodes(W, SB_NODES, 16)
    rng = np.random.RandomState(seed)
    bound = [W.make_pod(f"init-{i}").req({"cpu": "900m", "memory": "1Gi"})
             .label("app", "spread")
             .node(f"node-{int(rng.randint(0, SB_NODES))}").obj()
             for i in range(500)]
    shapes = [
        lambda k: group_pod(W, k, "spread"),
        lambda k: W.make_pod(k).req({"cpu": "500m", "memory": "1Gi"})
        .label("app", "spread").spread_constraint(
            2, LABEL_HOSTNAME, "ScheduleAnyway", {"app": "spread"}).obj(),
        lambda k: group_pod(W, k, "anti"),
        lambda k: W.make_pod(k).req({"cpu": "250m", "memory": "512Mi"})
        .preferred_pod_affinity(LABEL_ZONE, {"app": "spread"}, 5).obj(),
        lambda k: W.make_pod(k).req({"cpu": "900m", "memory": "1Gi"}).obj(),
    ]
    pods = [shapes[int(rng.randint(0, 5))](f"q{i}") for i in range(span)]
    na, batch, table, gd, gc, fam, _b, _s = group_staged(
        pkg, device, nodes, bound, pods)
    xs = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=batch.valid[:span], sig=batch.sig[:span],
        tidx=batch.tidx[:span]), device)
    return na, batch, table, gd, gc, fam, xs


def groups_scan_work(pkg, na, carry, batch, table, gd, fam, xs, span: int,
                     out, kc) -> tuple:
    """(bound_ms, bound_by, ops, bytes) of run_batch's group mode over the
    span: per pod the lean evaluation (or its fast path), the group mask
    and scores on every valid node (spread minima, the domain flags and
    the score ranges; log and rint per scored node), and per placement
    the count update over every consumer row."""
    cfg = pkg.program.ScoreConfig()
    slots = node_slots(na, carry)
    C = len(cfg.score_cols)
    U, SC = gd.spr_f_active.shape
    TA, TAA = gd.ipa_ra_active.shape[1], gd.ipa_raa_active.shape[1]
    CT, PT = gd.ipa_stc_tv.shape[1], gd.ipa_stp_tv.shape[1]
    nv = slots["n_valid"]
    group_eval = Ops(i32=nv * (4 * SC + 3 * TAA + 3 * TA + 2 * SC),
                     i64=nv * 6, f64=nv * SC * 3 if fam.spr_s else 0)
    update = Ops(i32=nv * U * (2 * SC * 4 + TAA * 4 + TA * 3),
                 i64=nv * U * (CT + PT))
    ops, prev, per_row = Ops(), int(carry.cache.sig), {}
    for s_, u, best in zip(batch.sig[:span].tolist(),
                           batch.tidx[:span].tolist(), np_of(out).tolist()):
        if u not in per_row:
            per_row[u] = eval_ops(table, u, slots, C)
        ops = ops + (fast_ops(slots) if s_ != 0 and s_ == prev
                     else per_row[u]) + group_eval
        if best >= 0:
            ops = ops + update
        prev = s_
    moved = (nbytes(na, carry, xs, table, gd)
             + nbytes(kc.used, kc.nonzero_used, kc.npods, kc.ports,
                      kc.cache, kc.groups, out))
    bound_ms, bound_by = bound_of(moved, ops)
    return bound_ms, bound_by, ops, moved


def check_run_batch_groups(torch, pkg, device, rows: list) -> None:
    """run_batch's group mode at full width on row 1g's 1,024-pod span
    (groups_span_inputs). The scheduler compiles a drain of this mix to
    run_plan; group drains below WAVE_MIN_SPAN keep this mode, so it is
    held at full width here."""
    P = pkg.program
    span = 1024
    na, batch, table, gd, gc, fam, xs = groups_span_inputs(pkg, device,
                                                           span)
    carry = P.initial_carry(na, gc)
    cfg = P.ScoreConfig()
    kc, ka = P.run_batch(cfg, na, carry, xs, table, groups=gd, fam=fam)
    pc, pa = P._run_batch_plain(cfg, na, carry, xs, table, gd, fam)
    torch.cuda.synchronize()
    err = assert_equal_trees(torch, (ka, kc), (pa, pc), "run_batch[groups]")
    k_ms = cuda_ms(torch, lambda: P.run_batch(cfg, na, carry, xs, table,
                                              groups=gd, fam=fam), 2)
    plain_ms = cuda_ms(torch, lambda: P._run_batch_plain(
        cfg, na, carry, xs, table, gd, fam), 1, warmup=0)
    bound_ms, bound_by, ops, moved = groups_scan_work(
        pkg, na, carry, batch, table, gd, fam, xs, span, ka, kc)
    log("kernel", name="run_batch_groups", pods=span, nodes=SB_NODES,
        families=list(fam), exact=True, max_abs_err=err, ms=k_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, ops=vars(ops), bytes=moved)
    rows.append(dict(
        name="run_batch_groups", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_batch.cu",
        replaces="kubernetes_tpu/ops/program.py:929", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))


# ---------------------------------------------------------------------------
# phase 3, the plan program and the mask diagnosis


def mix_pod(W, name: str, cpu: str, labels: dict, action: str):
    """A MixedHighSignature / MixedSchedulingBasePod template pod
    (performance-config.yaml :203-212, :252-266): 1 Gi, the template's
    labels, a maxSkew-5 zone spread over them."""
    w = W.make_pod(name).req({"cpu": cpu, "memory": "1Gi"})
    for k, v in labels.items():
        w = w.label(k, v)
    return w.spread_constraint(5, LABEL_ZONE, action, labels).obj()


def mhs_pod(W, name: str, seq: int):
    """A measured MixedHighSignature pod: the cpu request rotates over
    eight values with the pod's sequence number (perf/harness.py
    signatureCycle)."""
    return mix_pod(W, name, f"{250 + 50 * (seq % MHS_SHAPE[4])}m",
                   {"app": "mix"}, "DoNotSchedule")


# the GroupsDev [U, ·, N] tensors run_plan reads per row, by family
PLAN_ROW_FIELDS = {
    "spr_f": ("spr_f_tv", "spr_f_elig"),
    "spr_s": ("spr_s_tv", "spr_s_elig", "spr_s_keys_ok", "spr_s_dom"),
    "ipa_req": ("ipa_ra_tv",), "ipa_anti": ("ipa_raa_tv",),
    "ipa_score": ("ipa_stc_tv", "ipa_stp_tv")}


def plan_layout(torch, P, batch, m: int, device):
    """(wt, WaveXs) for the batch's first m pods, as
    Scheduler._wavescan_dispatch lays a span out."""
    uniq = list(dict.fromkeys(int(t) for t in batch.tidx[:m]))
    S = max(2, 1 << (len(uniq) - 1).bit_length())
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot: dict = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    bucket = max(8, 1 << (m - 1).bit_length())
    widx = [slot[int(t)] for t in batch.tidx[:m]]
    widx += [widx[-1]] * (bucket - m)
    xs = P.WaveXs(valid=torch.arange(bucket, device=device) < m,
                  widx=torch.tensor(widx, dtype=torch.int32, device=device))
    return wt, xs


def domain_sizes(tv) -> np.ndarray:
    """Per node, the number of nodes sharing its topology value (0 where
    the node has none)."""
    tv = np.asarray(tv)
    out = np.zeros(tv.shape, np.int64)
    nz = tv != 0
    if nz.any():
        _, inv, cnt = np.unique(tv[nz], return_inverse=True,
                                return_counts=True)
        out[nz] = cnt[inv]
    return out


def plan_ops(P, args, out, slots) -> Ops:
    """The operations one run_plan call needs for these inputs: Phase A's
    fit surfaces of the S slots on every valid node and their speculative
    evaluation; per step the slot's evaluation on every valid node and
    its argmax; per placement the S slots' refresh at the touched node
    and the counter increments of the nodes that share its domain; then
    the fold of the placements."""
    cfg, na, carry, xs, table, wt, gd, statics, fam, norm_live, \
        has_groups, has_ports = args
    C = len(cfg.score_cols)
    S = len(wt)
    nv = slots["n_valid"]
    reqs = [int((np_of(table.req[u]) != 0).sum()) for u in wt]
    fit = [score_ops(C, r, True) + Ops(i64=r) for r in reqs]
    per_node = Ops(i32=2, i64=8 + (4 if norm_live else 0))
    if has_ports:
        per_node = per_node + Ops(i32=int(slots["ports"].mean()) + 1)
    SC = TA = TAA = 0
    if has_groups:
        SC, TA, TAA = (gd.spr_f_active.shape[1], gd.ipa_ra_active.shape[1],
                       gd.ipa_raa_active.shape[1])
        per_node = per_node + Ops(
            i32=(4 * SC if fam.spr_f else 0) + (1 + 3 * TAA if fam.ipa_anti
                                                else 0)
            + (3 * TA if fam.ipa_req else 0),
            i64=(2 if fam.ipa_score else 0),
            f64=(3 * SC if fam.spr_s else 0))
    evaluation = per_node * nv + Ops(i32=SC * nv)
    ops = Ops()
    for f in fit:
        ops = ops + f * nv
    ops = ops + evaluation * S
    widx = np_of(xs.widx).tolist()
    valid = np_of(xs.valid).tolist()
    dom = None
    if has_groups and fam.spr_f:
        dom = [[domain_sizes(np_of(gd.spr_f_tv[u, c])) for c in range(SC)]
               for u in wt]
    for k, best in enumerate(out):
        if not valid[k]:
            continue
        ops = ops + evaluation
        if best < 0:
            continue
        w = widx[k]
        for s in range(S):
            ops = ops + fit[s] + Ops(i64=reqs[w] + 3)
            if dom is not None:
                ops = ops + Ops(i32=2 * sum(int(dom[s][c][best])
                                            for c in range(SC)))
    if has_groups:
        U = gd.spr_f_active.shape[0]
        ops = ops + Ops(i32=3 * U * max(SC, 1) * nv) * len(set(wt))
    return ops


def plan_inputs(torch, pkg, device, kind: str):
    """Full-width run_plan inputs. "mhs": the first MixedHighSignature
    measured drain as the scheduler dispatches it — the 1,000 init pods
    one per node, 4,096 pods of eight rotating signatures under one zone
    spread (S = 8, W = 4,096). "lean_ports": a lean 1,024-pod span of four
    signatures, one with a host port, over the mixed 5,000-node cluster
    (S = 4, the ports variant)."""
    P = pkg.program
    W = pkg.wrappers
    if kind == "mhs":
        n_nodes, n_init, _n_meas, zones, _cyc = MHS_SHAPE
        nodes = harness_nodes(W, n_nodes, zones)
        bound = [W.make_pod(f"init-{i}").req({"cpu": "900m",
                                              "memory": "1Gi"})
                 .label("app", "mix").node(f"node-{i}").obj()
                 for i in range(n_init)]
        m = 4096
        pods = [mhs_pod(W, f"pod-{n_init + i}", n_init + i)
                for i in range(m)]
        na, batch, table, gd, gc, fam, _b, _s = group_staged(
            pkg, device, nodes, bound, pods)
        has_groups = True
    else:
        nodes = lean_cluster(np.random.RandomState(61), SB_NODES, W)
        shapes = [
            W.make_pod("plan-0").req({"cpu": "900m", "memory": "1Gi"}),
            W.make_pod("plan-1").req({"cpu": "250m", "memory": "512Mi"})
            .node_selector({"disk": "ssd"}),
            W.make_pod("plan-2").req({"cpu": "2", "memory": "4Gi"})
            .toleration(key="dedicated", operator="Exists")
            .container({"cpu": "100m"}, image="nginx:1.25"),
            W.make_pod("plan-3").req({"cpu": "200m", "memory": "256Mi"})
            .host_port(8080)]
        m = 1024
        pods = [shapes[i % 4].obj() for i in range(m)]
        na, batch, table = staged(nodes, (), pods, device, pkg)
        gd = gc = None
        from kubernetes_tpu_torch.ops.groups import GroupFamilies
        fam = GroupFamilies(False, False, False, False, False)
        has_groups = False
    wt, xs = plan_layout(torch, P, batch, m, device)
    has_ports = bool((batch.sig[:m] == 0).any())
    statics = P.wave_statics(na, table, wt)
    # Scheduler._wave_norm_static over the span's rows
    arrays = SimpleNamespace(taint_eff=np_of(na.taint_eff),
                             valid=np_of(na.valid))
    norm_live = not all(P.static_norm_ok(arrays, np_of(table.pref_weight[u]))
                        for u in wt)
    carry = P.initial_carry(na, gc)
    args = (P.ScoreConfig(), na, carry, xs, table, wt, gd, statics, fam,
            norm_live, has_groups, has_ports)
    return args, m, dict(kind=kind, pods=m, S=len(wt), W=xs.valid.shape[0],
                         has_groups=has_groups, has_ports=has_ports,
                         norm_live=norm_live)


def plan_work(P, args, kc, kp, out) -> tuple:
    """(bound_ms, bound_by, ops, bytes) of one run_plan call on these
    inputs: plan_ops, and each input read once, each output written once
    — the node columns, the S rows' surfaces and their active families'
    group rows, the carry (the whole group carry: the fold writes every
    consumer row from it)."""
    cfg, na, carry, xs, table, wt, gd, statics, fam, norm_live, \
        has_groups, has_ports = args
    ops = plan_ops(P, args, out, node_slots(na, carry))
    rows_g = []
    if has_groups:
        distinct = sorted(set(wt))
        rows_g = [getattr(gd, f)[distinct]
                  for fam_name, fields in PLAN_ROW_FIELDS.items()
                  if getattr(fam, fam_name) for f in fields]
    moved = (nbytes(na.cap, na.allowed_pods, statics, carry.used,
                    carry.nonzero_used, carry.npods, xs, table.req,
                    table.nonzero_req, rows_g)
             + (nbytes(carry.ports, kc.ports) if has_ports else 0)
             + (nbytes(carry.groups, kc.groups) if has_groups else 0)
             + nbytes(kc.used, kc.nonzero_used, kc.npods, kp))
    bound_ms, bound_by = bound_of(moved, ops)
    return bound_ms, bound_by, ops, moved


def check_run_plan(torch, pkg, device, rows: list) -> None:
    P = pkg.program
    err = 0.0
    times = {}
    for kind in ("mhs", "lean_ports"):
        args, m, shape = plan_inputs(torch, pkg, device, kind)
        cfg, na, carry, xs, table, wt, gd, statics, fam, norm_live, \
            has_groups, has_ports = args
        if kind == "lean_ports" and not has_ports:
            fail("run_plan[lean_ports]: the span holds no host-port row")
        raw0 = pkg.kernels.RAW_LAUNCHES["run_plan"]
        kc, kp = P.run_plan(*args)
        torch.cuda.synchronize()
        launches_a_span = pkg.kernels.RAW_LAUNCHES["run_plan"] - raw0
        if launches_a_span != 1:
            fail(f"run_plan[{kind}]: {launches_a_span} launches a span")
        t0 = time.perf_counter()
        pc, pp = P._run_plan_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, assert_equal_trees(torch, (kp, kc), (pp, pc),
                                          f"run_plan[{kind}]"))
        Wb = xs.valid.shape[0]
        n_conf, prefix = kp[Wb:].tolist()
        out = np_of(kp[:Wb]).tolist()
        k_ms = cuda_ms(torch, lambda: P.run_plan(*args), 3)
        dev_ms = device_ms(torch, lambda: P.run_plan(*args), 3)
        bound_ms, bound_by, ops, moved = plan_work(P, args, kc, kp, out)
        placed = sum(1 for x in out[:m] if x >= 0)
        times[kind] = dict(ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms,
                           cluster=pkg.kernels.PLAN_CLUSTER,
                           launches_a_span=launches_a_span,
                           bound_ms=bound_ms, bound_by=bound_by,
                           placed=placed, conflicts=n_conf, prefix=prefix,
                           ops=vars(ops), bytes=moved, **shape)
        log("kernel", name="run_plan", exact=True, max_abs_err=err,
            **times[kind])
    first = times["mhs"]
    rows.append(dict(
        name="run_plan", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_plan.cu",
        replaces="kubernetes_tpu/ops/program.py:1259", launches=0,
        max_abs_err=err, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=None,
        cluster=first["cluster"],
        by_shape={k: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "S", "W",
                                        "launches_a_span")}
                  for k, v in times.items()}))


def diag_ops(table, u: int, slots: dict, R: int, groups) -> Ops:
    """One diagnose_row call: per valid node the validity, unschedulable,
    name, port and fit tests, the taint and selector loops over the
    node's occupied slots and the row's live entries, and with groups the
    spread, affinity and anti tests; the spread minimum once per
    constraint over the valid nodes."""
    t = {f: np_of(getattr(table, f)[u]) for f in (
        "req", "tol_op", "ns_sel_val", "port_ids")}
    n_tol = int((t["tol_op"] != 0).sum())
    nl, pocc = slots["labels"], slots["ports"]
    nv = slots["n_valid"]
    n_pid = int((t["port_ids"] != 0).sum())
    ops = Ops(i32=6 * nv + slots["n_pad"], i64=2 * R * nv)
    ops = ops + Ops(i32=int(slots["hard"].sum()) * (1 + 4 * n_tol)
                    + int((t["ns_sel_val"] != 0).sum()) * int(nl.sum())
                    + n_pid * int(pocc.sum()) + int(pocc.sum()))
    if groups is not None:
        SC, TA, TAA = groups
        ops = ops + Ops(i32=nv * (4 * SC + 3 * TA + 3 * TAA + 1) + SC * nv)
    return ops


def check_diagnose_row(torch, pkg, device, rows: list) -> None:
    """Lean rows over the mixed 5,000-node cluster (taints, selectors,
    host ports, a pod no node fits) and group rows over the harness
    cluster (zone spread with skew, affinity with and without a match,
    zone anti-affinity, an existing anti term), N = 8,192."""
    P = pkg.program
    W = pkg.wrappers
    nodes = lean_cluster(np.random.RandomState(71), SB_NODES, W)
    bound = [W.make_pod(f"b{i}").req({"cpu": "6", "memory": "8Gi"})
             .host_port(8080).node(f"node-{7 * i % SB_NODES}").obj()
             for i in range(1500)]
    lean = lean_pods(np.random.RandomState(72), 16, W, "diag")
    lean.append(W.make_pod("huge").req({"cpu": "100"}).obj())
    na, batch, table = staged(nodes, bound, lean, device, pkg)
    lean_rows = sorted(set(int(t) for t in batch.tidx[:len(lean)]))
    err = 0.0
    for u in lean_rows:
        err = max(err, assert_equal_trees(
            torch, P.diagnose_row(na, table, u),
            P._diagnose_plain(na, table, u), f"diagnose_row[lean {u}]"))
    gnodes = harness_nodes(W, SB_NODES, 16)
    # 20 spread pods in each of zones 0-7, none in 8-15: skew
    gbound = [W.make_pod(f"s{i}").req({"cpu": "900m", "memory": "1Gi"})
              .label("app", "mix").node(f"node-{i % 8}").obj()
              for i in range(160)]
    gbound.append(W.make_pod("guard").req({"cpu": "1"})
                  .node("node-20").pod_affinity(
                      LABEL_ZONE, {"app": "web"}, anti=True).obj())
    gpods = [mhs_pod(W, "m0", 0),
             W.make_pod("aff").req({"cpu": "1"}).pod_affinity(
                 LABEL_ZONE, {"app": "nowhere"}).obj(),
             W.make_pod("near").req({"cpu": "1"}).pod_affinity(
                 LABEL_ZONE, {"app": "mix"}).obj(),
             W.make_pod("anti").req({"cpu": "1"}).label("anti", "y")
             .pod_affinity(LABEL_ZONE, {"app": "mix"}, anti=True).obj(),
             W.make_pod("web").req({"cpu": "1"}).label("app", "web").obj()]
    gna, gbatch, gtable, gd, gc, fam, _b, _s = group_staged(
        pkg, device, gnodes, gbound, gpods)
    group_rows = sorted(set(int(t) for t in gbatch.tidx[:len(gpods)]))
    slots_seen = set()
    for u in group_rows:
        got = P.diagnose_row(gna, gtable, u, gd=gd, gc=gc, fam=fam)
        err = max(err, assert_equal_trees(
            torch, got, P._diagnose_plain(gna, gtable, u, gd, gc, fam),
            f"diagnose_row[group {u}]"))
        slots_seen |= set(np_of(got[0]).tolist())
    # a failed drain's rows in one launch: the lean rows, then the group
    # rows, each against its packed context block
    multi = {}
    for kind, (na_, t_, rows_, kw) in (
            ("lean", (na, table, lean_rows, {})),
            ("group", (gna, gtable, group_rows,
                       dict(gd=gd, gc=gc, fam=fam)))):
        args = P.diagnose_args(na_, t_, **kw)
        err = max(err, assert_equal_trees(
            torch, P.diagnose_rows(na_, t_, rows_, args=args, **kw),
            P._diagnose_rows_plain(na_, t_, rows_, **kw),
            f"diagnose_rows[{kind}, {len(rows_)} rows]"))
        N_, R_ = na_.cap.shape

        def read(na_=na_, t_=t_, rows_=rows_, kw=kw, args=args):
            return P.diagnosis_read_back(P.diagnose_rows(
                na_, t_, rows_, args=args, **kw), len(rows_), N_, R_)
        multi[kind] = dict(rows=len(rows_), ms=cuda_ms(
            torch, lambda: P.diagnose_rows(na_, t_, rows_, args=args, **kw),
            20), readback_host_ms=cuda_ms(torch, read, 20))
    u0, g0 = lean_rows[-1], group_rows[0]
    k_ms = cuda_ms(torch, lambda: P.diagnose_row(na, table, u0), 20)
    dev_ms = device_ms(torch, lambda: P.diagnose_row(na, table, u0), 20)
    plain_ms = cuda_ms(torch, lambda: P._diagnose_plain(na, table, u0), 5)
    gk_ms = cuda_ms(torch, lambda: P.diagnose_row(
        gna, gtable, g0, gd=gd, gc=gc, fam=fam), 20)
    gdev_ms = device_ms(torch, lambda: P.diagnose_row(
        gna, gtable, g0, gd=gd, gc=gc, fam=fam), 20)
    gplain_ms = cuda_ms(torch, lambda: P._diagnose_plain(
        gna, gtable, g0, gd, gc, fam), 5)
    R = na.cap.shape[1]
    slots = node_slots(na, P.initial_carry(na))
    ops = diag_ops(table, u0, slots, R, None)
    moved = (nbytes(na.cap, na.allowed_pods, na.valid, na.unschedulable,
                    na.name_id, na.taint_key, na.taint_val, na.taint_eff,
                    na.label_key, na.label_kv, na.used, na.npods, na.ports)
             + nbytes(P._diagnose_plain(na, table, u0)))
    bound_ms, bound_by = bound_of(moved, ops)
    log("diagnose_rows", one_launch=multi, group_device_ms=gdev_ms)
    log("kernel", name="diagnose_row", exact=True, max_abs_err=err,
        ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms, group_ms=gk_ms,
        group_device_ms=gdev_ms, group_plain_ms=gplain_ms,
        one_launch=multi, bound_ms=bound_ms, ops=vars(ops),
        bytes=moved, lean_rows=len(lean_rows), group_rows=len(group_rows),
        group_slots=sorted(slots_seen))
    for want in (P.DIAG_SPREAD_SKEW, P.DIAG_IPA_AFFINITY, P.DIAG_IPA_ANTI,
                 P.DIAG_IPA_EXISTING_ANTI):
        if want not in slots_seen:
            fail(f"diagnose_row: the group rows never produced slot {want}")
    rows.append(dict(
        name="diagnose_row", route="cuda",
        source="kubernetes_tpu_torch/csrc/diagnose_row.cu",
        replaces="kubernetes_tpu/ops/program.py:627", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))


# ---------------------------------------------------------------------------
# phase 3, observability: the cluster probe and the score decomposition


def probe_equal(torch, got, want, what: str) -> float:
    """Bit equality of the probe's outputs (float32 through their int32
    view) with the plain version's on the CPU."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what}[{i}]: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            fail(f"{what}[{i}]: kernel and plain version differ")
    return 0.0


def probe_bytes(na, carry, dom, out) -> int:
    """Bytes the probe must move on this run's data, each read once: every
    row's validity bit; per valid row its cap columns (the participation
    test), pod count and domain id; `used` of the participating cells
    only; the outputs."""
    valid = np_of(na.valid)
    nv = int(valid.sum())
    part = int((np_of(na.cap)[valid] > 0).sum())
    R = na.cap.shape[1]
    return (na.valid.numel() * na.valid.element_size()
            + nv * (R * na.cap.element_size() + carry.npods.element_size()
                    + dom.element_size())
            + part * carry.used.element_size() + nbytes(out))


def probe_ops(na) -> Ops:
    """The probe's operations on this run's data: per row the validity
    test; per valid row the domain clip and its two adds, and per cell the
    participation test; per participating cell the free units, the four
    exact sums and the max, and one comparison for each of the four order
    statistics."""
    valid = np_of(na.valid)
    nv = int(valid.sum())
    part = int((np_of(na.cap)[valid] > 0).sum())
    return Ops(i32=len(valid) + nv + 4 * part,
               i64=2 * nv + nv * na.cap.shape[1] + 6 * part)


def explain_bytes(cfg, na, carry, table, u: int, out) -> int:
    """Bytes a lean explain_row must move on this run's data, each read
    once: every row's validity bit; per row that is valid or returned
    (past the feasible count the lowest infeasible rows carry their
    columns) the pod count and limit, the requested and scored columns of
    cap and used (used of a scored column only where BalancedAllocation
    or a plain-request column reads it), the nonzero columns, the
    unschedulable bit unless the row tolerates it, the name id when it
    names a node, the occupied taint slots' effects and, where its
    tolerations apply, the hard and PreferNoSchedule slots' keys and
    values, the occupied label slots when it selects or has (preferred)
    affinity terms, the occupied image slots when it names images, the
    occupied host-port slots when it asks for ports; the fields of its
    row the filters and scores read; the outputs."""
    t = {f: np_of(getattr(table, f)[u]) for f in table._fields}
    valid = np_of(na.valid)
    keep = valid.copy()
    keep[np_of(out[0]).astype(np.int64)] = True
    nreq = set(req_cols(t["req"]).tolist())
    scored = list(cfg.score_cols)
    balanced = not bool(t["skip_balanced"])
    used_cols = nreq | {c for c, nz in zip(scored, cfg.col_nonzero)
                        if balanced or not nz}
    per_row = (na.allowed_pods.element_size() + carry.npods.element_size()
               + len(nreq | set(scored)) * na.cap.element_size()
               + len(used_cols) * carry.used.element_size()
               + sum(cfg.col_nonzero) * carry.nonzero_used.element_size()
               + (0 if bool(t["tolerates_unsched"])
                  else na.unschedulable.element_size())
               + (na.name_id.element_size() if int(t["node_name_id"])
                  else 0))
    moved = (na.valid.numel() * na.valid.element_size()
             + per_row * int(keep.sum()))
    eff = np_of(na.taint_eff)[keep]
    moved += int((eff != 0).sum()) * na.taint_eff.element_size()
    live = t["tol_op"] != 0
    kv = na.taint_key.element_size() + na.taint_val.element_size()
    if live.any():
        moved += int(((eff == 1) | (eff == 3)).sum()) * kv
    if (live & ((t["tol_eff"] == 0) | (t["tol_eff"] == 2))).any():
        moved += int((eff == 2).sum()) * kv
    labels = int((np_of(na.label_key)[keep] != 0).sum())
    terms = bool(t["aff_has"]) or bool((t["pref_weight"] != 0).any())
    if terms or bool((t["ns_sel_val"] != 0).any()):
        moved += labels * na.label_kv.element_size()
    if terms:
        moved += labels * (na.label_key.element_size()
                           + na.label_num.element_size())
    if (t["img_ids"] != 0).any():
        moved += int((np_of(na.image_id)[keep] != 0).sum()) * (
            na.image_id.element_size() + na.image_size.element_size())
    if (t["port_ids"] != 0).any():
        moved += int((np_of(carry.ports)[keep] != 0).sum()) * (
            carry.ports.element_size())
    fields = ["req", "nonzero_req", "node_name_id", "tolerates_unsched",
              "tol_op", "tol_key", "tol_val", "tol_eff", "ns_sel_val",
              "port_ids", "skip_balanced", "img_ids", "img_containers",
              "aff_has", "pref_weight"]
    if t["aff_has"]:
        fields += ["aff_term_valid", "aff_key", "aff_op", "aff_num",
                   "aff_val"]
    if (t["pref_weight"] != 0).any():
        fields += ["pref_key", "pref_op", "pref_num", "pref_val"]
    moved += nbytes(tuple(getattr(table, f)[u] for f in fields))
    return moved + nbytes(out)


def check_cluster_probe(torch, pkg, sched, rows: list) -> None:
    """The probe on SchedulingBasic's post-drain carry (the main path's
    own inputs, N = 8,192): its zone domain ids, identity ids (what the
    SchedulingPodAntiAffinity labelling, one zone per node, interns to),
    and the identity ids clipped at ndom = 5,000."""
    P = pkg.program
    na = sched.state.device_arrays()
    carry = sched._device_carry
    if carry is None:
        fail("cluster_probe: SchedulingBasic left no resident carry")
    N, R = na.cap.shape
    zone = sched._gang_domains(na, need=True)
    ndom_zone = sched._gang_ndom
    ident = torch.arange(N, dtype=torch.int32, device=na.cap.device)
    cases = {"zones": (zone, ndom_zone), "identity": (ident, N),
             "clipped": (ident, 5000)}
    cpu = [x.cpu() for x in (na.cap, na.valid, carry.used, carry.npods)]
    err = 0.0
    for what, (dom, ndom) in cases.items():
        got = P.cluster_probe(na, carry, dom, ndom)
        err = max(err, probe_equal(torch, got, P._probe_plain(
            *cpu, dom.cpu(), ndom), f"cluster_probe[{what}]"))
    dom, ndom = cases["zones"]
    k_ms = cuda_ms(torch, lambda: P.cluster_probe(na, carry, dom, ndom), 50)
    dev_ms = device_ms(torch, lambda: P.cluster_probe(na, carry, dom, ndom),
                       50)
    plain_ms = cuda_ms(torch, lambda: P._probe_plain(
        na.cap, na.valid, carry.used, carry.npods, dom, ndom), 10)
    part = na.valid[:, None] & (na.cap > 0)
    util = torch.where(part, P._f32_ratio(carry.used, na.cap),
                       torch.full_like(carry.used, -1, dtype=torch.float32))
    lib_ms = cuda_ms(torch, lambda: torch.sort(util, dim=0), 50)
    moved = probe_bytes(na, carry, dom, P._probe_plain(*cpu, dom.cpu(), ndom))
    ops = probe_ops(na)
    bound_ms, bound_by = bound_of(moved, ops)
    log("kernel", name="cluster_probe", exact=True, max_abs_err=err,
        ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="torch.sort(util, dim=0)", bound_ms=bound_ms,
        bound_by=bound_by, ops=vars(ops), bytes=moved, N=N, R=R,
        ndom={k: v[1] for k, v in cases.items()})
    rows.append(dict(
        name="cluster_probe", route="cuda",
        source="kubernetes_tpu_torch/csrc/cluster_probe.cu",
        replaces="kubernetes_tpu/ops/program.py:893", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms))


def score_probe_bytes(cfg, na, carry, table, u: int, out) -> int:
    """Bytes score_probe must move on this run's data, each read once:
    per valid row the scored columns of cap and used and the nonzero
    slots the fit reads; the row's request, nonzero request and
    skip_balanced bit; the two outputs over every row (padded rows get
    their constants written)."""
    nv = int(np_of(na.valid).sum())
    C = len(cfg.score_cols)
    slots = {s for s, nz in zip(cfg.nonzero_slot, cfg.col_nonzero) if nz}
    per_row = (C * (na.cap.element_size() + carry.used.element_size())
               + len(slots) * carry.nonzero_used.element_size())
    return (nv * per_row + nbytes(table.req[u], table.nonzero_req[u],
                                  table.skip_balanced[u]) + nbytes(out))


def check_score_probe(torch, pkg, sched, rows: list) -> None:
    """score_probe (the sanitizer rails' NaN probe) on SchedulingBasic's
    post-drain carry (N = 8,192): every table row the run used against
    the plain version on the CPU, bit for bit through the float32
    outputs' int32 view; timed on row 0, the first row of every one of
    its drains."""
    P = pkg.program
    na = sched.state.device_arrays()
    carry, table = sched._device_carry, sched._table_dev
    if carry is None or table is None:
        fail("score_probe: SchedulingBasic left no resident carry or table")
    cfg = sched.profiles["default-scheduler"].score_config
    cpu = [to_cpu(x) for x in (na, carry, table)]
    used_rows = int(sched.builder.table_used)
    for u in range(used_rows):
        probe_equal(torch, P.score_probe(cfg, na, carry, table, u),
                    P._score_probe_plain(cfg, *cpu, u), f"score_probe[{u}]")
    u = 0
    out = P.score_probe(cfg, na, carry, table, u)
    for what, t in zip(("total", "std"), out):
        if not bool(torch.isfinite(t).all()):
            fail(f"score_probe: non-finite {what} on a healthy carry")
    k_ms = cuda_ms(torch, lambda: P.score_probe(cfg, na, carry, table, u), 50)
    dev_ms = device_ms(torch, lambda: P.score_probe(cfg, na, carry, table,
                                                    u), 50)
    plain_ms = cuda_ms(torch, lambda: P._score_probe_plain(
        cfg, na, carry, table, u), 10)
    moved = score_probe_bytes(cfg, na, carry, table, u, out)
    nv = int(np_of(na.valid).sum())
    ops = score_ops(len(cfg.score_cols), 0, True) * nv
    bound_ms, bound_by = bound_of(moved, ops)
    N, R = na.cap.shape
    log("kernel", name="score_probe", exact=True, max_abs_err=0.0,
        ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
        library="none (no single PyTorch call)", bound_ms=bound_ms,
        bound_by=bound_by, ops=vars(ops), bytes=moved, N=N, R=R,
        rows_checked=used_rows, tidx=u)
    rows.append(dict(
        name="score_probe", route="cuda",
        source="kubernetes_tpu_torch/csrc/score_probe.cu",
        replaces="kubernetes_tpu/ops/program.py:767", launches=0,
        max_abs_err=0.0, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, device_ms=dev_ms))


def to_cpu(tree):
    import torch
    if tree is None or isinstance(tree, (bool, int)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if type(tree) in (tuple, list):
        return type(tree)(to_cpu(x) for x in tree)
    return type(tree)(*(to_cpu(x) for x in tree))


def check_explain_row(torch, pkg, device, rows: list) -> None:
    """explain_row at N = 8,192 on the lean rows of the mixed 5,000-node
    cluster (with a pod pinned to one node and a pod no node fits, so k
    runs past the feasible count) and on the group rows of the harness
    cluster, with k = 16 and k = 5, against the plain version on the
    CPU."""
    P = pkg.program
    W = pkg.wrappers
    cfg = P.ScoreConfig()
    nodes = lean_cluster(np.random.RandomState(81), SB_NODES, W)
    bound = [W.make_pod(f"b{i}").req({"cpu": "6", "memory": "8Gi"})
             .node(f"node-{7 * i % SB_NODES}").obj() for i in range(1500)]
    lean = lean_pods(np.random.RandomState(82), 16, W, "expl")
    lean.append(W.make_pod("pinned").req({"cpu": "1"}).node_selector(
        {LABEL_HOSTNAME: "node-3"}).obj())
    lean.append(W.make_pod("huge").req({"cpu": "100"}).obj())
    na, batch, table = staged(nodes, bound, lean, device, pkg)
    carry = P.initial_carry(na)
    gnodes = harness_nodes(W, SB_NODES, 16)
    gbound = [W.make_pod(f"s{i}").req({"cpu": "900m", "memory": "1Gi"})
              .label("app", "mix").node(f"node-{i % 8}").obj()
              for i in range(160)]
    gpods = [mhs_pod(W, "m0", 0),
             W.make_pod("sa").req({"cpu": "1"}).label("app", "mix")
             .spread_constraint(1, LABEL_ZONE, "ScheduleAnyway",
                                {"app": "mix"}).obj(),
             W.make_pod("near").req({"cpu": "1"}).pod_affinity(
                 LABEL_ZONE, {"app": "mix"}).obj()]
    gna, gbatch, gtable, gd, gc, fam, _b, _s = group_staged(
        pkg, device, gnodes, gbound, gpods)
    gcarry = P.initial_carry(gna, gc)
    err, short = 0.0, 0
    cases = [(na, carry, table, u, None, None)
             for u in sorted(set(int(t) for t in batch.tidx[:len(lean)]))]
    cases += [(gna, gcarry, gtable, u, gd, fam)
              for u in sorted(set(int(t) for t in gbatch.tidx[:len(gpods)]))]
    for a_na, a_carry, a_table, u, a_gd, a_fam in cases:
        for k in (16, 5):
            got = P.explain_row(cfg, a_na, a_carry, a_table, u, k=k,
                                gd=a_gd, fam=a_fam)
            want = P._explain_plain(cfg, to_cpu(a_na), to_cpu(a_carry),
                                    to_cpu(a_table), u, k, to_cpu(a_gd),
                                    a_fam)
            err = max(err, assert_equal_trees(
                torch, to_cpu(got), want,
                f"explain_row[{'group' if a_gd is not None else 'lean'} "
                f"{u} k={k}]"))
            short += int(got[3]) < k
    if not short:
        fail("explain_row: no row with fewer feasible nodes than k")
    u0 = int(batch.tidx[0])
    k_ms = cuda_ms(torch, lambda: P.explain_row(cfg, na, carry, table, u0,
                                                k=16), 20)
    dev_ms = device_ms(torch, lambda: P.explain_row(
        cfg, na, carry, table, u0, k=16), 20)
    plain_ms = cuda_ms(torch, lambda: P._explain_plain(
        cfg, na, carry, table, u0, 16), 5)
    g0 = int(gbatch.tidx[0])
    gk_ms = cuda_ms(torch, lambda: P.explain_row(
        cfg, gna, gcarry, gtable, g0, k=16, gd=gd, fam=fam), 20)
    g_dev_ms = device_ms(torch, lambda: P.explain_row(
        cfg, gna, gcarry, gtable, g0, k=16, gd=gd, fam=fam), 20)
    split = device_split(torch, lambda: P.explain_row(
        cfg, na, carry, table, u0, k=16), 20)
    pod = P._gather_row(table, u0, True, 0)
    feas, total, _parts = P._eval_pod(cfg, na, carry, pod)
    keys = torch.where(feas, total, torch.full_like(total, -1)).to(
        torch.int32)
    lib_ms = cuda_ms(torch, lambda: torch.topk(keys, 16), 50)
    N = na.cap.shape[0]
    slots = node_slots(na, carry)
    ops = eval_ops(table, u0, slots, len(cfg.score_cols)) + select_ops(N, 16)
    moved = explain_bytes(cfg, na, carry, table, u0,
                          P._explain_plain(cfg, na, carry, table, u0, 16))
    bound_ms, bound_by = bound_of(moved, ops)
    log("kernel", name="explain_row", exact=True, max_abs_err=err,
        ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms, group_ms=gk_ms,
        group_device_ms=g_dev_ms, under_library=dev_ms < lib_ms,
        device_split=split,
        library_ms=lib_ms, library="torch.topk(keys_int32, 16)",
        bound_ms=bound_ms, bound_by=bound_by, ops=vars(ops), bytes=moved,
        rows=len(cases), rows_past_feasible=short)
    rows.append(dict(
        name="explain_row", route="cuda",
        source="kubernetes_tpu_torch/csrc/explain_row.cu",
        replaces="kubernetes_tpu/ops/program.py:700", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms))


# ---------------------------------------------------------------------------
# phases 4 and 5: the scheduler end to end


# ---------------------------------------------------------------------------
# phase 3 on the mesh: the node-sharded programs (parallel/sharding.py) on
# D shards of cuda:0, each against its plain version over the same shards
# and against the single-device kernel at the same inputs; the bound is
# the single-device row's at the same shape (the same work)

MESH_SIZES = (2, 4)


def mesh_row(name: str, source: str, replaces: str, err: float,
             per_d: dict, bound: tuple, library_ms) -> dict:
    """The kernel line's row of a sharded program: its D = 2 figures,
    both meshes' in `by_mesh`."""
    d2 = per_d[2]
    return dict(name=name, route="cuda",
                source=f"kubernetes_tpu_torch/csrc/{source}",
                replaces=f"kubernetes_tpu/parallel/sharding.py:{replaces}",
                launches=0, max_abs_err=err, ms=d2["ms"],
                plain_ms=d2["plain_ms"], device_ms=d2["device_ms"],
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
                by_mesh=per_d)


def check_mesh_kernels(torch, pkg, sched, rows: list) -> None:
    """SchedulingBasic's post-drain state (N = 8,192 rows, 5,000 valid)
    on D = 2 and 4 shards of cuda:0: run_batch_sharded on a 1,024-pod
    lean span, run_uniform_sharded at L = K = 8,192, J = 8 (and its fast
    path), scatter_rows_sharded with 1,000 rows including every shard
    boundary, cluster_probe_sharded bit for bit. The carry's signature
    cache is relabelled 0 (the spans' rows come from a fresh builder)."""
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    cfg = P.ScoreConfig()
    if sched._device_carry is None:
        fail("mesh kernels: SchedulingBasic left no resident carry")
    na = sched.state.device_arrays()
    carry = P.with_cache_sig(sched._device_carry, 0)
    N = na.cap.shape[0]
    span = 1024
    pods = lean_pods(np.random.RandomState(17), span, W, "mesh")
    uni = W.make_pod("mesh-uni").req({"cpu": "900m", "memory": "1Gi"}).obj()
    batch = pkg.BatchBuilder(sched.state).build(pods + [uni])
    if batch.host_fallback[:span + 1].any():
        fail("mesh kernels: a host-fallback signature")
    table = pkg.table_from_batch(batch, "cuda")
    xs = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=batch.valid[:span], sig=batch.sig[:span],
        tidx=batch.tidx[:span]), "cuda")
    x = P.PodXs(True, int(batch.sig[span]), int(batch.tidx[span]))
    L, K, J = BATCH, min(BATCH, N), 8
    # the single-device kernels at the same inputs
    sc, sa = P.run_batch(cfg, na, carry, xs, table)
    su = P.run_uniform(cfg, na, carry, x, table, BATCH, L, K, J)
    dom, ndom = sched._gang_domains(na, need=True), sched._gang_ndom
    sp = P.cluster_probe(na, carry, dom, ndom)
    rng = np.random.RandomState(19)
    edges = [N // 4 * k + e for k in (1, 2, 3) for e in (-1, 0)]
    rest = [r for r in rng.permutation(N) if r not in edges][:1000 - 6]
    real = np.sort(np.array(edges + rest, np.int64))
    idx = np.full((1024,), real[0], np.int64)
    idx[:1000] = real
    src = np.array([(7 * r + 1) % N for r in idx], np.int64)
    rows_h = type(na)(*(np_of(x_)[src] for x_ in na))
    rows_d = type(na)(*(x_[torch.from_numpy(src).to("cuda")].contiguous()
                        for x_ in na))
    ss = P.scatter_rows(na, idx, rows_d)
    torch.cuda.synchronize()
    per = {k: {} for k in ("run_batch_sharded", "run_uniform_sharded",
                           "scatter_rows_sharded", "cluster_probe_sharded")}
    err = {k: 0.0 for k in per}
    # the bytes each program's exchange carries, worked out from its
    # shapes (on one card no byte crosses between devices): logged on
    # the kernel's log line, never in the kernels line
    payload = {k: {} for k in per}
    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=["cuda:0"] * D)
        gna, gc = S.shard_node_arrays(mesh, na), S.shard_carry(mesh, carry)
        n_local = N // D

        # run_batch_sharded: the kernel (one launch a span), its plain
        # version, run_batch's; the host-driven chain of shards on several
        # cards, called on the shards of cuda:0, against the plain version
        k = "run_batch_sharded"
        raw0 = pkg.kernels.RAW_LAUNCHES[k]
        kc, ka = S.run_batch_sharded(cfg, mesh, gna, gc, xs, table)
        torch.cuda.synchronize()
        launches_a_span = pkg.kernels.RAW_LAUNCHES[k] - raw0
        if launches_a_span != 1:
            fail(f"{k}[D={D}]: {launches_a_span} launches a span on one card")
        t0 = time.perf_counter()
        pc, pa = S._run_batch_sharded_plain(cfg, mesh, gna, gc, xs, table)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err[k] = max(err[k], assert_equal_trees(
            torch, (ka, S.unshard(kc)), (pa, S.unshard(pc)), f"{k}[D={D}]"))
        assert_equal_trees(torch, ka, sa, f"{k}[D={D}] vs run_batch")
        assert_equal_trees(torch, S.unshard(kc)[:4], sc[:4],
                           f"{k}[D={D}] carry vs run_batch")
        raw0 = pkg.kernels.RAW_LAUNCHES[k]
        (hc, ha), chain_ms = timed(torch, lambda: pkg.kernels
                                   ._batch_sharded_chain(cfg, mesh, gna, gc,
                                                         xs, table, None,
                                                         None))
        chain = dict(ms=chain_ms, launches_a_span=pkg.kernels.RAW_LAUNCHES[k]
                     - raw0)
        err[k] = max(err[k], assert_equal_trees(
            torch, (ha, S.unshard(hc)), (pa, S.unshard(pc)),
            f"{k}[D={D}] chain"))
        del hc
        per[k][D] = dict(
            ms=cuda_ms(torch, lambda: S.run_batch_sharded(
                cfg, mesh, gna, gc, xs, table), 2),
            device_ms=device_ms(torch, lambda: S.run_batch_sharded(
                cfg, mesh, gna, gc, xs, table), 1),
            plain_ms=plain_ms, placed=int((np_of(ka) >= 0).sum()),
            launches_a_span=launches_a_span, chain=chain)
        # one launch on one card: the grid reduces in place, no exchange
        payload[k][D] = 0

        # run_uniform_sharded (and its fast path on the output carry)
        kc, kp = S.run_uniform_sharded(cfg, mesh, gna, gc, x, table, BATCH,
                                       L, K, J)
        pc, pp = S._run_uniform_sharded_plain(cfg, mesh, gna, gc, x, table,
                                              BATCH, L, K, J)
        k = "run_uniform_sharded"
        err[k] = max(err[k], assert_equal_trees(
            torch, (kp, S.unshard(kc)), (pp, S.unshard(pc)), f"{k}[D={D}]"))
        err[k] = max(err[k], assert_equal_trees(
            torch, S.run_uniform_sharded(cfg, mesh, gna, kc, x, table, 4096,
                                         L, K, J)[1],
            S._run_uniform_sharded_plain(cfg, mesh, gna, pc, x, table, 4096,
                                         L, K, J)[1], f"{k}[D={D}, fast]"))
        flags, sflags = np_of(kp[L:]).tolist(), np_of(su[1][L:]).tolist()
        if all(flags) and all(sflags):
            assert_equal_trees(torch, kp[:L], su[1][:L],
                               f"{k}[D={D}] vs run_uniform")
        _K_loc, L_loc, _M = S.uniform_shape(mesh, n_local, L, K, J)
        per[k][D] = dict(
            ms=cuda_ms(torch, lambda: S.run_uniform_sharded(
                cfg, mesh, gna, gc, x, table, BATCH, L, K, J), 10),
            device_ms=device_ms(torch, lambda: S.run_uniform_sharded(
                cfg, mesh, gna, gc, x, table, BATCH, L, K, J), 10),
            plain_ms=cuda_ms(torch, lambda: S._run_uniform_sharded_plain(
                cfg, mesh, gna, gc, x, table, BATCH, L, K, J), 3),
            flags=flags, single_device_flags=sflags,
            select_launch=("one block" if pkg.kernels.uniform_sharded_fused(
                n_local, _K_loc, J) else "multi-block chain"),
            device_split=device_split(torch, lambda: S.run_uniform_sharded(
                cfg, mesh, gna, gc, x, table, BATCH, L, K, J), 5))
        # each shard's block partials, then its keys and two flags
        payload[k][D] = D * (-(-n_local // pkg.kernels.USH_BLOCK)
                             * (pkg.kernels.MAX_IC + 3) * 8
                             + (L_loc + 2) * 8)

        # scatter_rows_sharded: 1,000 rows, every shard boundary among them
        k = "scatter_rows_sharded"
        got = S.scatter_rows_sharded(mesh, gna, idx, rows_h)
        want = S._scatter_rows_sharded_plain(
            gna, S.stage_rows(mesh, gna, idx, rows_h))
        err[k] = max(err[k], assert_equal_trees(
            torch, S.unshard(got), S.unshard(want), f"{k}[D={D}]"))
        assert_equal_trees(torch, S.unshard(got), ss,
                           f"{k}[D={D}] vs scatter_rows")
        assert_equal_trees(torch, S.unshard(gna), na, f"{k}[D={D}] input")
        per[k][D] = dict(
            ms=cuda_ms(torch, lambda: S.scatter_rows_sharded(
                mesh, gna, idx, rows_h), 20),
            device_ms=device_ms(torch, lambda: S.scatter_rows_sharded(
                mesh, gna, idx, rows_h), 20),
            plain_ms=cuda_ms(torch, lambda: S._scatter_rows_sharded_plain(
                gna, S.stage_rows(mesh, gna, idx, rows_h)), 20))
        # no exchange: each shard receives its own rows from the host
        payload[k][D] = 0

        # cluster_probe_sharded: bit for bit against the single-device
        # kernel and the plain version
        k = "cluster_probe_sharded"
        got = S.cluster_probe_sharded(mesh, gna, gc, dom, ndom)
        cpu = [x_.cpu() for x_ in (na.cap, na.valid, carry.used,
                                   carry.npods)]
        err[k] = max(err[k], probe_equal(torch, got, P._probe_plain(
            *cpu, dom.cpu(), ndom), f"{k}[D={D}]"))
        probe_equal(torch, got, tuple(t.cpu() for t in sp),
                    f"{k}[D={D}] vs cluster_probe")
        per[k][D] = dict(
            ms=cuda_ms(torch, lambda: S.cluster_probe_sharded(
                mesh, gna, gc, dom, ndom), 50),
            device_ms=device_ms(torch, lambda: S.cluster_probe_sharded(
                mesh, gna, gc, dom, ndom), 50),
            plain_ms=cuda_ms(torch, lambda: P._probe_plain(
                S.gather_rows(mesh, [t.cap for t in gna], "cuda:0"),
                S.gather_rows(mesh, [t.valid for t in gna], "cuda:0"),
                S.gather_rows(mesh, [t.used for t in gc], "cuda:0"),
                S.gather_rows(mesh, [t.npods for t in gc], "cuda:0"),
                dom, ndom), 10))
        # on one card the kernels read the shards in place
        payload[k][D] = (0 if pkg.kernels.probe_in_place(mesh)
                         else nbytes(na.cap, na.valid, carry.used,
                                     carry.npods))
        del gna, gc, kc, pc, got, want

    # the bounds: the single-device rows' at the same shapes
    slots = node_slots(na, carry)
    moved = (nbytes(na, carry, xs, table) + nbytes(carry)
             + xs.sig.numel() * 4)
    ops = scan_ops(table, batch.sig[:span].tolist(),
                   batch.tidx[:span].tolist(), np_of(sa).tolist(), 0, slots,
                   len(cfg.score_cols))
    bounds = {"run_batch_sharded": bound_of(moved, ops)}
    w = uniform_work(torch, P, cfg, na, carry, x, table, L, K, J, su)
    bounds["run_uniform_sharded"] = bound_of(w.moved, w.ops)
    bounds["scatter_rows_sharded"] = bound_of(
        2 * nbytes(na) + nbytes(rows_d) + idx.nbytes, Ops())
    bounds["cluster_probe_sharded"] = bound_of(
        probe_bytes(na, carry, dom, sp), probe_ops(na))
    # the library yardsticks of the single-device rows
    keys = flat_keys(torch, P, cfg, na, carry, x, table, K, J)
    part = na.valid[:, None] & (na.cap > 0)
    util = torch.where(part, P._f32_ratio(carry.used, na.cap),
                       torch.full_like(carry.used, -1, dtype=torch.float32))
    library = {"run_batch_sharded": None,
               "run_uniform_sharded": cuda_ms(
                   torch, lambda: torch.topk(keys, L), 10),
               "scatter_rows_sharded": None,
               "cluster_probe_sharded": cuda_ms(
                   torch, lambda: torch.sort(util, dim=0), 50)}
    sources = {"run_batch_sharded": ("run_batch_sharded.cu", 158),
               "run_uniform_sharded": ("run_uniform_sharded.cu", 519),
               "scatter_rows_sharded": ("scatter_rows.cu", 1107),
               "cluster_probe_sharded": ("cluster_probe.cu", 1157)}
    for k, (src_f, line) in sources.items():
        log("kernel", name=k, exact=True, max_abs_err=err[k], nodes=N,
            by_mesh=per[k], exchange_payload_bytes=payload[k],
            bound_ms=bounds[k][0], bound_by=bounds[k][1],
            library_ms=library[k])
        rows.append(mesh_row(k, src_f, line, err[k], per[k], bounds[k],
                             library[k]))


# ---------------------------------------------------------------------------
# phase 3 on the mesh, the group and gang programs: run_batch_sharded's
# group mode, run_plan_sharded, run_gang_sharded (both tiers) and the
# per-shard surfaces, on D shards of cuda:0. Each equals its plain version
# over the same shards (at a cut shape: the plain versions repeat every
# step's arithmetic in small PyTorch calls) and the single-device kernel
# at the same state (at the full shape); the bound is the single-device
# row's at that shape (the same work)


def phase8_span(pkg, device, n: int = 256):
    """256 pods of phase 8's mix (ScheduleAnyway zone spread, self-matching
    required zone affinity to 20 bound seeds, two self-matching anti
    terms, a DoNotSchedule zone spread, preferred affinity, plain pods)
    over its 500 nodes (10 zones, a PreferNoSchedule taint on every 11th
    node). Returns (na, batch, table, gd, gc, fam, xs)."""
    P = pkg.program
    W = pkg.wrappers
    nodes = []
    for i in range(500):
        w = W.make_node(f"m{i}").capacity(
            {"cpu": 16, "memory": "64Gi", "pods": 110}).zone(
            f"zone-{i % 10}").label(LABEL_HOSTNAME, f"m{i}")
        if i % 11 == 3:
            w = w.taint("spot", "", effect="PreferNoSchedule")
        nodes.append(w.obj())
    seeds = [W.make_pod(f"seed-{i}").req({"cpu": "500m", "memory": "1Gi"})
             .label("app", "db").node(f"m{i * 7}").obj() for i in range(20)]
    kinds = [
        lambda w: w.label("app", "web").spread_constraint(
            3, LABEL_ZONE, "ScheduleAnyway", {"app": "web"}),
        lambda w: w.label("app", "db").pod_affinity(LABEL_ZONE,
                                                    {"app": "db"}),
        lambda w: w.label("anti", "x").label("side", "x")
        .pod_affinity(LABEL_ZONE, {"anti": "x"}, anti=True)
        .pod_affinity(LABEL_HOSTNAME, {"side": "x"}, anti=True),
        lambda w: w.label("app", "s").spread_constraint(
            1, LABEL_ZONE, "DoNotSchedule", {"app": "s"}),
        lambda w: w.preferred_pod_affinity(LABEL_ZONE, {"app": "web"}, 7),
        lambda w: w,
    ]
    pods = [kinds[i % 6](W.make_pod(f"p8-{i}").req(
        {"cpu": "500m", "memory": "1Gi"})).obj() for i in range(n)]
    na, batch, table, gd, gc, fam, _b, _s = group_staged(
        pkg, device, nodes, seeds, pods)
    xs = pkg.convert.pod_xs_from_numpy(P.PodXs(
        valid=batch.valid[:n], sig=batch.sig[:n], tidx=batch.tidx[:n]),
        device)
    return na, batch, table, gd, gc, fam, xs


def timed(torch, fn) -> tuple:
    """(result, ms) of one call, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_state(S, mesh, na, carry, gd=None):
    """(node shards, carry shards, group shards) of single-device state."""
    return (S.shard_node_arrays(mesh, na), S.shard_carry(mesh, carry),
            S.shard_groups(mesh, gd) if gd is not None else None)


def check_mesh_group_kernels(torch, pkg, device, rows: list) -> None:
    from kubernetes_tpu_torch.ops import gang as G
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    cfg = P.ScoreConfig()
    names = ("run_batch_sharded_groups", "run_plan_sharded",
             "run_gang_sharded", "run_gang_uniform_sharded",
             "wave_statics_sharded")
    per = {k: {} for k in names}
    err = {k: 0.0 for k in names}

    # the inputs, and the single-device kernels at the full shapes
    g_span = 1024
    g_in = groups_span_inputs(pkg, device, g_span)
    na1, b1, t1, gd1, gc1, fam1, xs1 = g_in
    c1 = P.initial_carry(na1, gc1)
    s1c, s1a = P.run_batch(cfg, na1, c1, xs1, t1, groups=gd1, fam=fam1)
    p8 = phase8_span(pkg, device)
    na8, b8, t8, gd8, gc8, fam8, xs8 = p8
    c8 = P.initial_carry(na8, gc8)
    full, _m, full_shape = plan_inputs(torch, pkg, device, "mhs")
    sfc, sfp = P.run_plan(*full)
    # the plain versions' cut: the drain's first 1,024 pods (the same
    # state and slots), and row 7's lean ports span
    fxs = full[3]
    cut = {"mhs": full[:3] + (P.WaveXs(valid=fxs.valid[:1024],
                                       widx=fxs.widx[:1024]),) + full[4:],
           "lean_ports": plan_inputs(torch, pkg, device, "lean_ports")[0]}
    train = W.make_pod("train-proto").req({"cpu": "1", "memory": "1Gi"})\
        .workload("train").obj()
    mixed = [W.make_pod(f"mix-{k}").req({"cpu": c, "memory": mem})
             .workload("mix").obj()
             for k, (c, mem) in enumerate((("900m", "1Gi"), ("2", "4Gi"),
                                           ("250m", "512Mi"),
                                           ("4", "16Gi")))]
    scan_cases, staged_in = {}, {}
    for case, protos, m, bucket, needed, lean in (
            ("accept", [train], 128, 128, 128, False),
            ("reject", [train], 128, 128, 129, False),
            ("mixed_s4", mixed, 60, 64, 60, True)):
        if (m, lean) not in staged_in:    # accept and reject share them
            staged_in[m, lean] = gang_scan_inputs(
                torch, pkg, device, protos, m, bucket, lean=lean, seed=m)
        na, table, carry, xs, wt, statics, dom = staged_in[m, lean]
        carry = P.with_cache_sig(carry, 5)
        single = G.run_gang(cfg, na, carry, xs, table, wt=wt,
                            needed=needed, dom=dom, statics=statics,
                            w_contig=2)
        scan_cases[case] = (na, table, carry, xs, wt, statics, dom, m,
                            bucket, needed, single)
    proto = W.make_pod("gang-proto").req({"cpu": "900m", "memory": "1Gi"})\
        .workload("gang").obj()
    L, J = 256, 8
    uni_cases, uni_in = {}, {}
    for case, needed, lean in (("accept", 256, False), ("reject", 257, False),
                               ("inexact", 256, True)):
        if lean not in uni_in:            # accept and reject share them
            uni_in[lean] = staged(gang_nodes(W, lean=lean), (), [proto],
                                  device, pkg)
        na, batch, table = uni_in[lean]
        K = min(L, na.cap.shape[0])
        x = P.PodXs(True, int(batch.sig[0]), int(batch.tidx[0]))
        carry = P.initial_carry(na)
        single = G.run_gang(cfg, na, carry, x, table, needed=needed,
                            uniform=True, n_actual=256, L=L, K=K, J=J)
        uni_cases[case] = (na, table, carry, x, K, needed, single)
    ws_in = []
    nodes_ws = harness_nodes(W, TS_SHAPE[0], TS_SHAPE[3])
    na_w, b_w, t_w = staged(nodes_ws, (), [group_pod(W, "s", "spread")],
                            device, pkg)
    ws_in.append((na_w, t_w, [int(b_w.tidx[0])], (False, False, False)))
    pods_m = lean_pods(np.random.RandomState(32), 8, W, "ws", ports=False)
    na_m, b_m, t_m = staged(lean_cluster(np.random.RandomState(31),
                                         SB_NODES, W), (), pods_m, device,
                            pkg)
    ws_in.append((na_m, t_m, sorted(set(int(t) for t in b_m.tidx[:8]))[:4],
                  (True, True, True)))
    torch.cuda.synchronize()

    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=["cuda:0"] * D)
        n_of = {}

        # run_batch_sharded's group mode: the plain version on phase 8's
        # mix, the single-device kernel on row 1g's span
        # (one launch a span; the host-driven chain of shards on several
        # cards, called on the shards of cuda:0, against the plain version
        # on phase 8's mix)
        k = "run_batch_sharded_groups"
        raw = "run_batch_sharded"
        gna, gc0, ggd = sharded_state(S, mesh, na8, c8, gd8)
        (kc, ka), k8_ms = timed(torch, lambda: S.run_batch_sharded(
            cfg, mesh, gna, gc0, xs8, t8, groups=ggd, fam=fam8))
        (pc, pa), plain_ms = timed(torch, lambda: S._run_batch_sharded_plain(
            cfg, mesh, gna, gc0, xs8, t8, ggd, fam8))
        err[k] = max(err[k], assert_equal_trees(
            torch, (ka, S.unshard(kc)), (pa, S.unshard(pc)), f"{k}[D={D}]"))
        raw0 = pkg.kernels.RAW_LAUNCHES[raw]
        (hc, ha), chain_ms = timed(torch, lambda: pkg.kernels
                                   ._batch_sharded_chain(cfg, mesh, gna, gc0,
                                                         xs8, t8, ggd, fam8))
        chain = dict(cut_ms=chain_ms, launches_a_span=pkg.kernels
                     .RAW_LAUNCHES[raw] - raw0)
        err[k] = max(err[k], assert_equal_trees(
            torch, (ha, S.unshard(hc)), (pa, S.unshard(pc)),
            f"{k}[D={D}] chain"))
        del hc
        gna, gc0, ggd = sharded_state(S, mesh, na1, c1, gd1)

        def kern_g():
            return S.run_batch_sharded(cfg, mesh, gna, gc0, xs1, t1,
                                       groups=ggd, fam=fam1)
        raw0 = pkg.kernels.RAW_LAUNCHES[raw]
        kc, ka = kern_g()
        torch.cuda.synchronize()
        launches_a_span = pkg.kernels.RAW_LAUNCHES[raw] - raw0
        if launches_a_span != 1:
            fail(f"{k}[D={D}]: {launches_a_span} launches a span on one card")
        assert_equal_trees(torch, (ka, S.unshard(kc)), (s1a, s1c),
                           f"{k}[D={D}] vs run_batch[groups]")
        per[k][D] = dict(ms=cuda_ms(torch, kern_g, 1),
                         device_ms=device_ms(torch, kern_g, 1),
                         plain_ms=plain_ms, cut_ms=k8_ms, pods=g_span,
                         cut_pods=int(xs8.valid.shape[0]),
                         launches_a_span=launches_a_span, chain=chain)
        n_of[k] = g_span
        del gna, gc0, ggd, kc, pc

        # the per-shard surfaces: the main path's call and four mixed rows
        # (every family on: the image counts cross the shards)
        k = "wave_statics_sharded"
        for na_, t_, wt_, feats in ws_in:
            gna = S.shard_node_arrays(mesh, na_)
            got = S.wave_statics_sharded(mesh, gna, t_, wt_, feats)
            want = S._wave_statics_sharded_plain(mesh, gna, t_, wt_, feats)
            err[k] = max(err[k], assert_equal_trees(
                torch, got, want, f"{k}[D={D}, {feats}]"))
            single = P.wave_statics(na_, t_, wt_, feats)
            assert_equal_trees(
                torch, [torch.cat([g[f] for g in got], dim=1)
                        for f in range(4)], list(single),
                f"{k}[D={D}, {feats}] vs wave_statics")
            # the launches a card of shards on several cards, on this card
            assert_equal_trees(
                torch, pkg.kernels._statics_sharded_chain(
                    mesh, gna, t_, wt_, feats), got,
                f"{k}[D={D}, {feats}] chain")
        na_, t_, wt_, feats = ws_in[0]
        gna = S.shard_node_arrays(mesh, na_)

        def kern_w():
            return S.wave_statics_sharded(mesh, gna, t_, wt_, feats)
        per[k][D] = dict(
            ms=cuda_ms(torch, kern_w, 20), device_ms=device_ms(
                torch, kern_w, 20),
            plain_ms=cuda_ms(torch, lambda: S._wave_statics_sharded_plain(
                mesh, gna, t_, wt_, feats), 5))
        del gna

        # run_plan_sharded: the plain version on a 1,024-pod span of
        # MixedHighSignature's state and on row 7's lean ports span; the
        # single-device kernel on MixedHighSignature's full drain. The
        # host-driven chain of shards on several cards (placement
        # "cards") runs here on the shards of one card, held against the
        # plain version on both spans and against the one-launch grid on
        # the full drain
        k = "run_plan_sharded"
        plain_by, kern_by, chain = {}, {}, {}

        def chain_of(sargs):
            raw0 = pkg.kernels.RAW_LAUNCHES[k]
            out = pkg.kernels._plan_sharded_chain(
                *sargs[:6], [int(u) for u in sargs[6]], *sargs[7:])
            torch.cuda.synchronize()
            chain["launches_a_span"] = pkg.kernels.RAW_LAUNCHES[k] - raw0
            return out
        for kind, args in cut.items():
            cfg_, na_, carry_, xs_, table_, wt_, gd_, _st, fam_, nl_, hg_, \
                hp_ = args
            gna, gc0, ggd = sharded_state(S, mesh, na_, carry_, gd_)
            gst = S.wave_statics_sharded(mesh, gna, table_, wt_)
            sargs = (cfg_, mesh, gna, gc0, xs_, table_, wt_, ggd, gst, fam_,
                     nl_, hg_, hp_)
            kc, kp = S.run_plan_sharded(*sargs)
            kern_by[kind] = cuda_ms(torch, lambda: S.run_plan_sharded(
                *sargs), 1)
            (pc, pp), plain_by[kind] = timed(
                torch, lambda: S._run_plan_sharded_plain(*sargs))
            err[k] = max(err[k], assert_equal_trees(
                torch, (kp, S.unshard(kc)), (pp, S.unshard(pc)),
                f"{k}[D={D}, {kind}]"))
            (cc, cp), chain[f"{kind}_ms"] = timed(
                torch, lambda: chain_of(sargs))
            err[k] = max(err[k], assert_equal_trees(
                torch, (cp, S.unshard(cc)), (pp, S.unshard(pc)),
                f"{k}[D={D}, {kind}] chain"))
            del gna, gc0, ggd, gst, kc, pc, cc
        cfg_, na_, carry_, xs_, table_, wt_, gd_, _st, fam_, nl_, hg_, hp_ \
            = full
        gna, gc0, ggd = sharded_state(S, mesh, na_, carry_, gd_)
        gst = S.wave_statics_sharded(mesh, gna, table_, wt_)

        def kern_p():
            return S.run_plan_sharded(cfg_, mesh, gna, gc0, xs_, table_, wt_,
                                      ggd, gst, fam_, nl_, hg_, hp_)
        raw0 = pkg.kernels.RAW_LAUNCHES["run_plan_sharded"]
        kc, kp = kern_p()
        torch.cuda.synchronize()
        launches_a_span = pkg.kernels.RAW_LAUNCHES["run_plan_sharded"] - raw0
        if launches_a_span != 1:
            fail(f"{k}[D={D}]: {launches_a_span} launches a span on one card")
        assert_equal_trees(torch, (kp, S.unshard(kc)), (sfp, sfc),
                           f"{k}[D={D}] vs run_plan")
        (cc, cp), chain["ms"] = timed(torch, lambda: chain_of(
            (cfg_, mesh, gna, gc0, xs_, table_, wt_, ggd, gst, fam_, nl_,
             hg_, hp_)))
        err[k] = max(err[k], assert_equal_trees(
            torch, (cp, S.unshard(cc)), (kp, S.unshard(kc)),
            f"{k}[D={D}] chain vs one launch"))
        del cc
        per[k][D] = dict(ms=cuda_ms(torch, kern_p, 1),
                         launches_a_span=launches_a_span,
                         device_ms=device_ms(torch, kern_p, 1),
                         plain_ms=plain_by["mhs"],
                         plain_lean_ports_ms=plain_by["lean_ports"],
                         cut_ms=kern_by["mhs"],
                         lean_ports_ms=kern_by["lean_ports"],
                         chain=dict(chain),
                         S=len(wt_), W=int(xs_.valid.shape[0]))
        del gna, gc0, ggd, gst, kc

        # run_gang_sharded's scan tier: accepted, rejected (the carry
        # untouched, sig included), four signatures in 64 slots
        k = "run_gang_sharded"
        per[k][D] = {}
        for case, (na, table, carry, xs, wt, statics, dom, m, bucket,
                   needed, single) in scan_cases.items():
            gna, gc0, _g = sharded_state(S, mesh, na, carry)
            n_local = na.cap.shape[0] // D
            gdom = [dom[d * n_local:(d + 1) * n_local].contiguous()
                    for d in range(D)]
            gst = S.wave_statics_sharded(mesh, gna, table, wt)

            def kern_s():
                return S.run_gang_sharded(cfg, mesh, gna, gc0, xs, table,
                                          wt=wt, needed=needed, dom=gdom,
                                          statics=gst, w_contig=2)
            raw0 = pkg.kernels.RAW_LAUNCHES[k]
            kc, kp = kern_s()
            torch.cuda.synchronize()
            launches_a_gang = pkg.kernels.RAW_LAUNCHES[k] - raw0
            if launches_a_gang != 1:
                fail(f"{k}[D={D}, {case}]: {launches_a_gang} launches a gang "
                     "on one card")
            (pc, pp), plain_ms = timed(
                torch, lambda: S._run_gang_scan_sharded_plain(
                    cfg, mesh, gna, gc0, xs, table, wt, needed, gdom, gst,
                    2))
            err[k] = max(err[k], assert_equal_trees(
                torch, (kp, S.unshard(kc)), (pp, S.unshard(pc)),
                f"{k}[D={D}, {case}]"))
            # the host-driven chain of shards on several cards, called on
            # the shards of cuda:0
            raw0 = pkg.kernels.RAW_LAUNCHES[k]
            (hc, hp), chain_ms = timed(
                torch, lambda: pkg.kernels._gang_sharded_chain(
                    cfg, mesh, gna, gc0, xs, table, [int(u) for u in wt],
                    needed, gdom, gst, 2))
            chain = dict(ms=chain_ms, launches_a_gang=pkg.kernels
                         .RAW_LAUNCHES[k] - raw0)
            err[k] = max(err[k], assert_equal_trees(
                torch, (hp, S.unshard(hc)), (pp, S.unshard(pc)),
                f"{k}[D={D}, {case}] chain"))
            del hc
            assert_equal_trees(torch, (S.unshard(kc), kp), single,
                               f"{k}[D={D}, {case}] vs run_gang")
            if case == "reject":
                assert_equal_trees(torch, S.unshard(kc), carry,
                                   f"{k}[D={D}, reject] carry")
            per[k][D][case] = dict(
                ms=cuda_ms(torch, kern_s, 10),
                device_ms=device_ms(torch, kern_s, 10), plain_ms=plain_ms,
                accept=int(kp[bucket]), placed=int(kp[bucket + 1]),
                S=len(wt), B=bucket, launches_a_gang=launches_a_gang,
                chain=chain)
            del gna, gc0, gst, kc, pc

        # run_gang_sharded's closed form: accepted, rejected, inexact
        k = "run_gang_uniform_sharded"
        per[k][D] = {}
        for case, (na, table, carry, x, K, needed, single) in \
                uni_cases.items():
            gna, gc0, _g = sharded_state(S, mesh, na, carry)

            def kern_u():
                return S.run_gang_sharded(cfg, mesh, gna, gc0, x, table,
                                          needed=needed, uniform=True,
                                          n_actual=256, L=L, K=K, J=J)
            kc, kp = kern_u()
            (pc, pp), plain_ms = timed(
                torch, lambda: S._run_gang_uniform_sharded_plain(
                    cfg, mesh, gna, gc0, x, table, 256, needed, L, K, J))
            err[k] = max(err[k], assert_equal_trees(
                torch, (kp, S.unshard(kc)), (pp, S.unshard(pc)),
                f"{k}[D={D}, {case}]"))
            verdict = np_of(kp[L:]).tolist()
            if verdict[2] and verdict[3] and bool(single[1][L + 2]):
                assert_equal_trees(torch, (S.unshard(kc), kp), single,
                                   f"{k}[D={D}, {case}] vs run_gang")
            if not (verdict[0] and verdict[2] and verdict[3]):
                assert_equal_trees(torch, S.unshard(kc)[:4], carry[:4],
                                   f"{k}[D={D}, {case}] carry")
            if case == "inexact" and verdict[2]:
                fail(f"{k}[D={D}, inexact]: the exactness flag held")
            K_loc = S.uniform_shape(mesh, na.cap.shape[0] // D, L, K, J)[0]
            per[k][D][case] = dict(
                ms=cuda_ms(torch, kern_u, 10),
                device_ms=device_ms(torch, kern_u, 10), plain_ms=plain_ms,
                verdict=verdict, select_launch=(
                    "one block" if pkg.kernels.uniform_sharded_fused(
                        na.cap.shape[0] // D, K_loc, J)
                    else "multi-block chain"),
                device_split=device_split(torch, kern_u, 10))
            del gna, gc0, kc, pc

    # the bounds: the single-device rows' at the same shapes
    bounds = {"run_batch_sharded_groups": groups_scan_work(
        pkg, na1, c1, b1, t1, gd1, fam1, xs1, g_span, s1a, s1c)}
    Wb = full[3].valid.shape[0]
    bounds["run_plan_sharded"] = plan_work(P, full, sfc, sfp,
                                           np_of(sfp[:Wb]).tolist())
    na, table, carry, xs, wt, statics, dom, m, bucket, needed, single = \
        scan_cases["accept"]
    ops = gang_ops(cfg, na, table, wt, np_of(xs.widx).tolist(),
                   np_of(xs.valid).tolist(), np_of(single[1][:bucket])
                   .tolist(), 2)
    moved = gang_bytes(cfg, na, table, wt, bucket, bucket, False,
                       w_contig=2)
    bounds["run_gang_sharded"] = bound_of(moved, ops) + (ops, moved)
    na, table, carry, x, K, needed, single = uni_cases["accept"]
    bounds["run_gang_uniform_sharded"] = gang_uniform_work(
        torch, P, cfg, na, carry, x, table, L, K, J, single[1])
    keys = flat_keys(torch, P, cfg, na, carry, x, table, K, J)
    library = dict.fromkeys(names)
    library["run_gang_uniform_sharded"] = cuda_ms(
        torch, lambda: torch.topk(keys, L), 10)
    na_, t_, wt_, feats = ws_in[0]
    N = na_.valid.shape[0]
    ws_moved = nbytes(na_.valid, na_.name_id, na_.unschedulable) + N * 25
    bounds["wave_statics_sharded"] = bound_of(ws_moved, Ops(i32=4 * N)) + (
        Ops(i32=4 * N), ws_moved)
    sources = {"run_batch_sharded_groups": ("run_batch_sharded.cu",
                                            "kubernetes_tpu/parallel/"
                                            "sharding.py:113"),
               "run_plan_sharded": ("run_plan_sharded.cu", "kubernetes_tpu/"
                                    "parallel/sharding.py:563"),
               "run_gang_sharded": ("run_gang_sharded.cu", "kubernetes_tpu/"
                                    "parallel/sharding.py:890"),
               "run_gang_uniform_sharded": ("run_uniform_sharded.cu",
                                            "kubernetes_tpu/parallel/"
                                            "sharding.py:1042"),
               "wave_statics_sharded": ("wave_statics.cu", "kubernetes_tpu/"
                                        "ops/program.py:1635")}
    for k in names:
        bound_ms, bound_by, ops, moved = bounds[k]
        log("kernel", name=k, exact=True, max_abs_err=err[k],
            by_mesh=per[k], bound_ms=bound_ms, bound_by=bound_by,
            ops=vars(ops), bytes=moved, library_ms=library[k], card_shards=
            "cuda:0")
        d2 = per[k][2]
        head = d2.get("accept", d2)
        src, repl = sources[k]
        rows.append(dict(
            name=k, route="cuda", source=f"kubernetes_tpu_torch/csrc/{src}",
            replaces=repl, launches=0, max_abs_err=err[k], ms=head["ms"],
            plain_ms=head["plain_ms"], device_ms=head["device_ms"],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library[k],
            by_mesh=per[k]))


# ---------------------------------------------------------------------------
# phase 3, preemption: the batched dry run


def pc_nodes(W, n: int, zones: int):
    """perf/harness.py _make_nodes with PreemptionChurn's nodeCpu 8."""
    return [W.make_node(f"node-{i}").capacity(
        {"cpu": 8, "memory": "64Gi", "pods": 110}).zone(
        f"zone-{i % zones}").label(LABEL_HOSTNAME, f"node-{i}").obj()
        for i in range(n)]


def dry_inputs(torch, pkg, device, C: int, V: int, spread: bool, seed: int,
               n_nodes: int = PC_SHAPE[0]):
    """Dry-run inputs over the PreemptionChurn cluster after its init op
    (every node holds one 4-cpu pod), the preemptor's row (8 cpu / 1 Gi,
    priority 100), the first C candidate rows (padded with row 0, the
    Evaluator's layout). V = 1: each candidate's one init pod, the
    PreemptionChurn shape; V > 1: seeded victims with holes and, with
    `spread`, seeded DryRunSpread tensors (two constraints). Returns
    (args, real candidates, the preemptor's request vector)."""
    from kubernetes_tpu_torch.framework.types import PodInfo
    from kubernetes_tpu_torch.ops.groups import DryRunSpread
    P, W = pkg.program, pkg.wrappers
    n_init = n_nodes
    rng = np.random.RandomState(seed)
    init = [W.make_pod(f"init-{i}").req({"cpu": "4", "memory": "1Gi"})
            .node(f"node-{i}").obj() for i in range(n_init)]
    vip = W.make_pod("vip").req({"cpu": "8", "memory": "1Gi"}) \
        .priority(100).obj()
    state = stage(pc_nodes(W, n_nodes, PC_SHAPE[4]), init, device, pkg)
    batch = pkg.BatchBuilder(state).build([vip])
    na = state.device_arrays()
    row = P.pod_row_from_table(batch.table, int(batch.tidx[0]), device)
    R = na.cap.shape[1]
    real = min(C, n_nodes)
    cand = np.zeros((C,), np.int32)
    cand[:real] = [state.node_index[f"node-{i}"] for i in range(real)]
    vreq = np.zeros((C, V, R), np.int64)
    vvalid = np.zeros((C, V), bool)
    if V == 1:
        vreq[:real, 0] = state.request_vector(PodInfo.of(init[0]).requests)
        vvalid[:real, 0] = True
    else:
        vreq[:real, :, 0] = rng.choice([500, 1000, 2000, 4000], (real, V))
        vreq[:real, :, 1] = rng.choice([0, 1 << 28, 1 << 30], (real, V))
        vvalid[:real] = rng.rand(real, V) < 0.7
    sp = None
    if spread:
        SC = 2
        other = rng.randint(0, 6, (C, SC)).astype(np.int32)
        other[rng.rand(C, SC) < 0.2] = np.iinfo(np.int32).max
        sp = DryRunSpread(*(torch.from_numpy(np.asarray(x)).to(device)
                            for x in DryRunSpread(
            max_skew=np.array([1, 2], np.int32),
            self_match=np.array([1, 0], np.int32),
            min_zero=np.array([False, True]), tv_ok=rng.rand(C, SC) < 0.9,
            cnt0=rng.randint(0, 6, (C, SC)).astype(np.int32),
            other_min=other, vic_match=rng.rand(C, V, SC) < 0.5)))

    def t(x):
        return torch.from_numpy(x).to(device)
    zero_u = np.zeros((C, R), np.int64)
    zero_n = np.zeros((C,), np.int32)
    return ((na, row, t(cand), t(vreq), t(vvalid), t(zero_u), t(zero_n),
             sp), real, state.request_vector(PodInfo.of(vip).requests))


def dry_subset(torch, pkg, args, touched, ovl_used, ovl_npods):
    """The Evaluator's overlay-subset launch (_dry_run_overrides) over
    `args`: the touched candidate positions padded to a power of two by
    repeating the first, and the summed nominations on the touched rows
    (zero on the padding). Returns (launch, plain, gathered): `launch`
    runs the checkout's own route — the subset entry reading the wave's
    tensors through the positions in place (its argument block packed
    once, as a plan packs it) where the package has one, else the
    positions' slices of the plan tensors gathered, then the dry run;
    `plain` its plain version on the same inputs; `gathered` the dry
    run's arguments on the gathered slices (the subset's bytes and
    operations)."""
    P = pkg.program
    na, row, cand, vreq, vvalid, _u, _n, sp = args
    s = len(touched)
    s_pad = 1 << max(s - 1, 0).bit_length()
    sub = np.full((s_pad,), touched[0], np.int32)
    sub[:s] = touched
    ou = np.zeros((s_pad, vreq.shape[2]), np.int64)
    on = np.zeros((s_pad,), np.int32)
    ou[:s], on[:s] = ovl_used, ovl_npods
    dev = cand.device
    sub_t = torch.from_numpy(sub.astype(np.int64)).to(dev)

    def gather():
        g = sp
        if g is not None:
            g = g._replace(tv_ok=g.tv_ok[sub_t], cnt0=g.cnt0[sub_t],
                           other_min=g.other_min[sub_t],
                           vic_match=g.vic_match[sub_t])
        return (na, row, cand[sub_t], vreq[sub_t], vvalid[sub_t],
                torch.from_numpy(ou).to(dev), torch.from_numpy(on).to(dev),
                g)
    gathered = gather()
    if not hasattr(P, "dry_run_select_victims_subset"):
        def launch():
            return P.dry_run_select_victims(*gather())
        return launch, (lambda: P._dry_run_select_victims_plain(*gathered)), \
            gathered
    wave = P.DryRunWave(na, row, cand, vreq, vvalid, sp)
    block = P.dry_run_args(wave)
    ins = P.dry_run_subset_inputs(sub, ou, on, dev)

    def launch():
        return P.dry_run_select_victims_subset(wave, *ins, block)

    def plain():
        return P._dry_run_subset_plain(*wave[:5], *ins, sp)
    return launch, plain, gathered


def ptxas_report(pkg, source: str, kernel: str) -> str:
    """ptxas's report of one kernel of a source (this process's build,
    `-Xptxas -v`): its stack frame, spills and registers, or "not built
    here" when the libraries were already built."""
    text = pkg.kernels.BUILD_INFO.get("ptxas", {}).get(source)
    if not text:
        return "not built here"
    out, on = [], False
    for ln in text.splitlines():
        if "Function properties for" in ln or "Compiling entry" in ln:
            on = kernel in ln
        elif on and ("stack frame" in ln or "registers" in ln):
            out.append(ln.replace("ptxas info    :", "").strip())
    return "; ".join(dict.fromkeys(out)) or "not found"


def req_cols(req) -> np.ndarray:
    """The resource columns a request row asks for."""
    return np.flatnonzero(np.asarray(req) != 0)


def dry_bytes(na, row, args) -> int:
    """Bytes the dry run must move on this run's data, each read once:
    per distinct candidate node row its validity bit, pod count and
    limit, the preemptor's requested columns of cap and used, and what
    the filters read for this preemptor (the unschedulable bit unless it
    tolerates it, the name id when it names a node, the occupied taint
    slots' effects and, when it tolerates taints, the hard slots' keys
    and values, the occupied label slots when it selects); the fields of
    its row the kernel reads; per candidate its row index, the requested
    columns of every victim slot and of the overlay, the victims' valid
    bits, the overlay's pod count, the spread tensors and the output."""
    cand, vreq, vvalid, sp = args[2], args[3], args[4], args[7]
    rows = np.unique(np_of(cand))
    nreq = len(req_cols(np_of(row.req)))
    eff = np_of(na.taint_eff)[rows]
    occupied = eff != 0
    hard = (eff == 1) | (eff == 3)
    labels = int((np_of(na.label_key)[rows] != 0).sum())
    n_tol = int((np_of(row.tol_op) != 0).sum())
    selects = bool((np_of(row.ns_sel_val) != 0).any())
    aff = bool(np_of(row.aff_has))
    per_row = (na.valid.element_size() + na.npods.element_size()
               + na.allowed_pods.element_size()
               + nreq * (na.cap.element_size() + na.used.element_size())
               + (0 if bool(np_of(row.tolerates_unsched))
                  else na.unschedulable.element_size())
               + (na.name_id.element_size()
                  if int(np_of(row.node_name_id)) else 0))
    moved = per_row * len(rows)
    moved += int(occupied.sum()) * na.taint_eff.element_size()
    if n_tol:
        moved += int(hard.sum()) * (na.taint_key.element_size()
                                    + na.taint_val.element_size())
    if selects or aff:
        moved += labels * na.label_kv.element_size()
    if aff:
        moved += labels * (na.label_key.element_size()
                           + na.label_num.element_size())
    fields = ["req", "tol_op", "tol_key", "tol_val", "tol_eff",
              "ns_sel_val", "node_name_id", "tolerates_unsched", "aff_has"]
    if aff:
        fields += ["aff_term_valid", "aff_key", "aff_op", "aff_num",
                   "aff_val"]
    moved += nbytes(tuple(getattr(row, f) for f in fields))
    C, V = vvalid.shape
    moved += C * (cand.element_size() + V * nreq * vreq.element_size()
                  + nreq * args[5].element_size() + args[6].element_size())
    moved += vvalid.numel() * vvalid.element_size() + C * (V + 1)
    return moved + (nbytes(tuple(sp)) if sp is not None else 0)


def dry_ops(na, row, args, real: int, slots: dict) -> Ops:
    """The dry run's operations on this run's data: per real candidate
    the static filters (validity, name, unschedulable, each occupied hard
    taint against the preemptor's live tolerations), the victims' sums
    and the overlay on the requested columns (no other column moves the
    verdict), the base fit, and per valid victim the reprieve fit and the
    running sum; with a spread, the skew test per constraint at the base
    and at each valid victim."""
    vvalid = np_of(args[4])[:real]
    nreq = len(req_cols(np_of(row.req)))
    n_tol = int((np_of(row.tol_op) != 0).sum())
    hard = int(slots["hard"][:real].sum()) if len(slots["hard"]) else 0
    n_vic = int(vvalid.sum())
    # per candidate: used + overlay − the victims' sum and the base fit
    # (an add and a compare) on each requested column, the pod count; per
    # valid victim: its share of the sum and its reprieve fit (two adds
    # and a compare) on each requested column, the pod count
    ops = Ops(i32=4 * real + hard * (1 + 4 * n_tol),
              i64=real * (4 * nreq + 2) + n_vic * (4 * nreq + 2))
    sp = args[7]
    if sp is not None:
        SC = sp.max_skew.shape[0]
        ops = ops + Ops(i32=6 * SC * (real + n_vic) + SC * n_vic)
    return ops


def check_dry_run(torch, pkg, device, rows: list) -> None:
    P = pkg.program

    def held(k, p, real, what, **kw) -> tuple:
        torch.cuda.synchronize()
        e = assert_equal_trees(torch, k, p, what)
        viable = int(k[:real, 0].sum())
        log("kernel", name="dry_run", exact=True, viable=viable,
            reprieved=int(k[:real, 1:].sum()), **kw)
        return e, viable

    err, timed = 0.0, None
    for C, V, spread in ((8192, 1, False), (512, 8, True), (512, 8, False)):
        args, real, nom_vec = dry_inputs(torch, pkg, device, C, V, spread,
                                         seed=C + V)
        e, viable = held(P.dry_run_select_victims(*args),
                         P._dry_run_select_victims_plain(*args), real,
                         f"dry_run[C={C},V={V}]", C=C, V=V, spread=spread)
        err = max(err, e)
        if V == 1 and viable != real:
            fail(f"dry_run: {viable} of {real} PreemptionChurn candidates "
                 "viable, expected every one")
        if timed is None:
            timed = (args, real, nom_vec)
        if V == 8:
            # the subset entry over a spread and eight victim slots
            touched = np.sort(np.random.RandomState(C + V).choice(
                real, 100, replace=False))
            run, plain, _g = dry_subset(
                torch, pkg, args, touched,
                np.zeros((100, nom_vec.shape[0]), np.int64),
                np.zeros((100,), np.int32))
            e, _v = held(run(), plain(), 100, f"dry_run[subset,V={V}]",
                         C=128, V=V, spread=spread)
            err = max(err, e)
    args, real, nom_vec = timed
    # the overlay-subset launches of the preemptor wave: the 199 candidate
    # rows the earlier preemptors' 8-cpu / 1 Gi nominations touch, padded
    # to 256 (the main path's shape: no touched candidate stays viable),
    # then seeded nominations of 0-500m / 256 Mi-64 Gi, 1-110 pods, on the
    # same rows (cpu, memory and the pod limit each turn some away); the
    # subset entry reads the plan's tensors through the positions in place
    rng = np.random.RandomState(29)
    touched = np.sort(rng.choice(real, 199, replace=False))
    sub_run, sub_plain, sub = dry_subset(
        torch, pkg, args, touched, np.tile(nom_vec, (199, 1)),
        np.ones((199,), np.int32))
    e, viable = held(sub_run(), sub_plain(), 199, "dry_run[subset]", C=256,
                     V=1, nominations="8 cpu / 1 Gi")
    err = max(err, e)
    if viable != 0:
        fail(f"dry_run: {viable} candidates under an 8-cpu nomination "
             "still viable")
    ou = np.zeros((199, nom_vec.shape[0]), np.int64)
    ou[:, 0] = rng.choice([0, 0, 500], 199)
    ou[:, 1] = rng.choice([256 << 20, 1 << 30, 64 << 30], 199)
    on = rng.choice([1, 2, 109, 110], 199).astype(np.int32)
    m_run, m_plain, _g = dry_subset(torch, pkg, args, touched, ou, on)
    e, viable_m = held(m_run(), m_plain(), 199, "dry_run[subset,mixed]",
                       C=256, V=1, nominations="seeded")
    err = max(err, e)
    if not 0 < viable_m < 199:
        fail(f"dry_run: {viable_m} of 199 mixed-overlay candidates viable, "
             "expected some of each")
    sub_ms = cuda_ms(torch, sub_run, 20)
    sub_dev_ms = device_ms(torch, sub_run, 20)
    sub_plain_ms = cuda_ms(torch, sub_plain, 3)
    # timed at the PreemptionChurn base shape (C = 8,192, V = 1)
    na, row = args[0], args[1]
    k_ms = cuda_ms(torch, lambda: P.dry_run_select_victims(*args), 20)
    dev_ms = device_ms(torch, lambda: P.dry_run_select_victims(*args), 20)
    plain_ms = cuda_ms(torch,
                       lambda: P._dry_run_select_victims_plain(*args), 3)
    plain_dev_ms = device_ms(
        torch, lambda: P._dry_run_select_victims_plain(*args), 3)
    def slots_of(args):
        rows_ = torch.unique(args[2].to(torch.int64))
        return node_slots(P.NodeArrays(*(x[rows_] for x in na)),
                          SimpleNamespace(ports=na.ports[rows_]))

    moved = dry_bytes(na, row, args)
    ops = dry_ops(na, row, args, real, slots_of(args))
    bound_ms, bound_by = bound_of(moved, ops)
    sub_bound, _ = bound_of(dry_bytes(na, row, sub),
                            dry_ops(na, row, sub, 199, slots_of(sub)))
    log("kernel", name="dry_run", C=args[2].shape[0], V=args[3].shape[1],
        max_abs_err=err, ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms,
        plain_device_ms=plain_dev_ms, bound_ms=bound_ms, ops=vars(ops),
        bytes=moved, subset_ms=sub_ms, subset_device_ms=sub_dev_ms,
        subset_plain_ms=sub_plain_ms, subset_bound_ms=sub_bound,
        ptxas=ptxas_report(pkg, "dry_run", "dry_run_kernel"))
    rows.append(dict(
        name="dry_run", route="cuda",
        source="kubernetes_tpu_torch/csrc/dry_run.cu",
        replaces="kubernetes_tpu/ops/program.py:2169", launches=0,
        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, device_ms=dev_ms,
        subset_ms=sub_ms, subset_device_ms=sub_dev_ms,
        subset_bound_ms=sub_bound))


# ---------------------------------------------------------------------------
# phase 3, gangs: run_gang's closed-form tier (run_uniform.cu with the
# gang verdict) and scan tier (run_gang.cu)


def gang_cols(cfg, table, rows) -> list:
    """The resource columns a gang launch reads: the rows' requested
    columns and the score columns."""
    cols = set(int(c) for c in cfg.score_cols)
    for u in rows:
        cols |= set(int(c) for c in req_cols(np_of(table.req[u])))
    return sorted(cols)


def gang_bytes(cfg, na, table, rows, B: int, width: int, uniform: bool,
               w_contig: int = 0, touched: int = 0) -> int:
    """Bytes run_gang must move on this run's data, each read once, each
    output written once. Per valid node row: the pod limit, the validity
    bit, the gang's columns of cap and used and the two nonzero columns
    (read, and written back: the verdict writes the output carry whole),
    the pod count in and out. The closed form also evaluates the row's
    filters over the occupied taint / label / image slots and writes the
    SigCache (42 bytes a node), and writes the touched candidates' rows;
    the scan tier reads the rows' hoisted surfaces ([S, N]: the mask and
    three int64) and, with w_contig, the domain ids. Then the members'
    inputs, the rows' table entries and the packed output."""
    nv = int(np_of(na.valid).sum())
    cols = gang_cols(cfg, table, rows)
    per = (4 + 1 + len(cols) * 8 * 3 + 2 * 8 * 2 + 4 * 2)
    moved = per * nv
    if uniform:
        eff = np_of(na.taint_eff)[np_of(na.valid)]
        u = rows[0]
        moved += int((eff != 0).sum()) * 4
        if int((np_of(table.tol_op[u]) != 0).sum()):
            moved += int(((eff == 1) | (eff == 3)).sum()) * 8
        if (np_of(table.ns_sel_val[u]) != 0).any() or bool(
                np_of(table.aff_has[u])):
            moved += int((np_of(na.label_key) != 0).sum()) * 4
        if (np_of(table.img_ids[u]) != 0).any():
            moved += int((np_of(na.image_id) != 0).sum()) * 12
        moved += nv * 42 + touched * (len(cols) * 8 + 16 + 4)
    else:
        moved += len(rows) * nv * 25 + (nv * 4 if w_contig else 0)
        moved += B * 9
    moved += len(rows) * (len(cols) * 8 + 16 + 8)
    return moved + (width + 4) * 4


def gang_ops(cfg, na, table, rows, widx, valid, out, w_contig: int) -> Ops:
    """The scan tier's operations on this run's data: the hoisted fit
    surfaces of the S slots on every valid node; per valid member the
    slot's feasibility, the normalization maxima, the weighted total and
    the argmax on every valid node (three more with the contiguity
    column); per placement the carry update and the S slots' refresh at
    the touched node."""
    C = len(cfg.score_cols)
    nv = int(np_of(na.valid).sum())
    reqs = [len(req_cols(np_of(table.req[u]))) for u in rows]
    fit = [score_ops(C, r, True) + Ops(i64=r) for r in reqs]
    ops = Ops()
    for f in fit:
        ops = ops + f * nv
    step = Ops(i32=2, i64=12 + (4 if w_contig else 0)) * nv
    for k, best in enumerate(out):
        if not valid[k]:
            continue
        ops = ops + step
        if best < 0:
            continue
        ops = ops + Ops(i64=reqs[widx[k]] + 3)
        for f in fit:
            ops = ops + f
    return ops


def gang_nodes(W, lean: bool):
    """The 5,000 harness nodes (32 cpu / 64 Gi / 110 pods, 16 zones), or
    the seeded mixed cluster (taints, labels, images)."""
    if lean:
        return lean_cluster(np.random.RandomState(77), SB_NODES, W)
    return harness_nodes(W, SB_NODES, 16)


def gang_uniform_work(torch, P, cfg, na, carry, x, table, L: int, K: int,
                      J: int, kp) -> tuple:
    """(bound_ms, bound_by, ops, bytes) of the closed-form gang tier on
    these inputs: the row's evaluation and its top-K, the [K, J] matrix
    of the feasible candidates, the top-L, the touched candidates'
    updates (gang_bytes for the bytes)."""
    slots = node_slots(na, carry)
    C = len(cfg.score_cols)
    pod = P._gather_row(table, x.tidx, True, x.sig)
    feasible = int(P._eval_pod(cfg, na, carry, pod)[0].sum())
    nreq = len(req_cols(np_of(table.req[x.tidx])))
    touched = int(torch.unique(kp[:L][kp[:L] >= 0]).numel())
    entry = score_ops(C, nreq, True) + Ops(i64=nreq + 4 + 3 + 1)
    ops = (eval_ops(table, x.tidx, slots, C)
           + Ops(i64=4) * slots["n_valid"]
           + select_ops(slots["n_valid"], K)
           + entry * (min(feasible, K) * J)
           + select_ops(min(feasible, K) * J, L) + Ops(i32=2 * L)
           + Ops(i32=1, i64=2 * nreq + 4) * touched)
    moved = gang_bytes(cfg, na, table, [x.tidx], 1, L, True,
                       touched=touched)
    bound_ms, bound_by = bound_of(moved, ops)
    return bound_ms, bound_by, ops, moved


def check_run_gang_uniform(torch, pkg, device, rows: list) -> None:
    """The closed form at GangTraining's shape: 256 members of 900m / 1 Gi
    over 5,000 harness nodes padded to 8,192 (L = K = 256, J = 8, the
    Scheduler's gang shape), held to the plain version when accepted, when
    rejected (needed above the gang) and when an exactness flag fails
    (PreferNoSchedule taints the gang does not tolerate)."""
    from kubernetes_tpu_torch.ops import gang as G
    P = pkg.program
    cfg = P.ScoreConfig()
    L, J = 256, 8
    err, times = 0.0, {}
    for case, needed, lean in (("accept", 256, False),
                               ("reject", 257, False),
                               ("inexact", 256, True)):
        na, x, table, K = gang_uniform_inputs(pkg, device, lean)
        carry = P.initial_carry(na)
        before = [t.clone() for t in list(carry[:4]) + list(carry.cache)]

        def kern():
            return G.run_gang(cfg, na, carry, x, table, needed=needed,
                              uniform=True, n_actual=256, L=L, K=K, J=J)

        def plain():
            return G._run_gang_uniform_plain(cfg, na, carry, x, table, 256,
                                             needed, L, K, J)
        kc, kp = kern()
        pc, pp = plain()
        torch.cuda.synchronize()
        err = max(err, assert_equal_trees(torch, (kp, kc), (pp, pc),
                                          f"run_gang_uniform[{case}]"))
        assert_equal_trees(torch, before, list(carry[:4]) + list(carry.cache),
                           f"run_gang_uniform[{case}] input")
        accept, placed, exact, depth = kp[L:].tolist()
        want = {"accept": (1, 256, 1, 1), "reject": (0, 256, 1, 1)}.get(case)
        if want is not None and (accept, placed, exact, depth) != want:
            fail(f"run_gang_uniform[{case}]: verdict "
                 f"{(accept, placed, exact, depth)}, expected {want}")
        if case == "inexact" and exact:
            fail("run_gang_uniform[inexact]: the exactness flag held")
        times[case] = dict(
            accept=accept, placed=placed, exact=exact, depth=depth,
            ms=cuda_ms(torch, kern, 10), device_ms=device_ms(torch, kern, 10),
            plain_ms=cuda_ms(torch, plain, 3))
        if case == "accept":
            keys = flat_keys(torch, P, cfg, na, carry, x, table, K, J)
            times[case]["library_ms"] = cuda_ms(
                torch, lambda: torch.topk(keys, L), 10)
            times[case]["device_split"] = device_split(torch, kern, 10)
            bound_ms, bound_by, ops, moved = gang_uniform_work(
                torch, P, cfg, na, carry, x, table, L, K, J, kp)
            times[case].update(bound_ms=bound_ms, bound_by=bound_by,
                               ops=vars(ops), bytes=moved)
        log("kernel", name="run_gang_uniform", case=case, L=L, K=K, J=J,
            exact_match=True, **times[case])
    acc = times["accept"]
    rows.append(dict(
        name="run_gang_uniform", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_uniform.cu",
        replaces="kubernetes_tpu/ops/gang.py:199", launches=0,
        max_abs_err=err, ms=acc["ms"], plain_ms=acc["plain_ms"],
        bound_ms=acc["bound_ms"], bound_by=acc["bound_by"],
        library_ms=acc["library_ms"], device_ms=acc["device_ms"],
        by_case={k: {f: v[f] for f in ("ms", "device_ms", "plain_ms")}
                 for k, v in times.items()}))


def gang_scan_inputs(torch, pkg, device, protos: list, m: int, bucket: int,
                     lean: bool = False, seed: int = 0):
    """(na, table, carry, GangXs, rows, statics, dom) for a gang of `m`
    members drawn from `protos` (one per member, seeded) in a `bucket`-slot
    member axis, laid out as Scheduler._gang_dispatch lays it out; the
    domain ids are the zone label's, as Scheduler._gang_domains builds
    them."""
    from kubernetes_tpu_torch.ops.gang import GangXs
    P = pkg.program
    rng = np.random.RandomState(seed)
    pods = [protos[int(rng.randint(0, len(protos)))] for _ in range(m)]
    nodes = gang_nodes(pkg.wrappers, lean=lean)
    state = stage(nodes, (), device, pkg)
    batch = pkg.BatchBuilder(state).build(pods)
    na = state.device_arrays()
    table = pkg.table_from_batch(batch, device)
    tid = batch.tidx[:m]
    uniq = list(dict.fromkeys(int(t) for t in tid))
    S = 1
    while S < len(uniq):
        S *= 2
    wt = (uniq + [uniq[-1]] * S)[:S]
    slot: dict = {}
    for s, u in enumerate(wt):
        slot.setdefault(u, s)
    widx = np.empty((bucket,), np.int32)
    widx[:m] = [slot[int(t)] for t in tid]
    widx[m:] = widx[m - 1]
    tidx = np.full((bucket,), tid[m - 1], np.int32)
    tidx[:m] = tid
    valid = np.zeros((bucket,), bool)
    valid[:m] = True
    xs = pkg.convert.gang_xs_from_numpy(GangXs(valid, tidx, widx), device)
    N = na.cap.shape[0]
    dom = np.arange(N, dtype=np.int32)
    ids: dict = {}
    for nd in nodes:
        idx = state.node_index[nd.metadata.name]
        zone = nd.metadata.labels.get(LABEL_ZONE) or f"\x00{idx}"
        dom[idx] = ids.setdefault(zone, len(ids))
    statics = P.wave_statics(na, table, wt)
    return (na, table, P.initial_carry(na), xs, wt, statics,
            pkg.convert.dom_from_numpy(dom, device))


def check_run_gang(torch, pkg, device, rows: list) -> None:
    """The scan tier at CoLocatedInference's shape: a 128-member gang of
    1 cpu / 1 Gi (S = 1, w_contig = 2, 16 zones) over 5,000 harness nodes
    padded to 8,192, accepted and rejected (needed above the gang); then a
    60-member gang of four signatures (S = 4) on the mixed cluster, padded
    to a 64-slot member axis. Each gang is one cluster launch
    (RAW_LAUNCHES); timed over 5 and 50 back-to-back calls; ptxas of the
    gang body's two instantiations (the cluster, the mesh's grid)."""
    from kubernetes_tpu_torch.ops import gang as G
    P = pkg.program
    W = pkg.wrappers
    cfg = P.ScoreConfig()
    train = W.make_pod("train-proto").req({"cpu": "1", "memory": "1Gi"})\
        .workload("train").obj()
    mixed = [W.make_pod(f"mix-{k}").req({"cpu": c, "memory": mem})
             .workload("mix").obj()
             for k, (c, mem) in enumerate((("900m", "1Gi"), ("2", "4Gi"),
                                           ("250m", "512Mi"),
                                           ("4", "16Gi")))]
    err, times = 0.0, {}
    for case, protos, m, bucket, needed, lean in (
            ("accept", [train], 128, 128, 128, False),
            ("reject", [train], 128, 128, 129, False),
            ("mixed_s4", mixed, 60, 64, 60, True)):
        na, table, carry, xs, wt, statics, dom = gang_scan_inputs(
            torch, pkg, device, protos, m, bucket, lean=lean, seed=m)
        before = [t.clone() for t in list(carry[:4]) + list(carry.cache)]

        def kern():
            return G.run_gang(cfg, na, carry, xs, table, wt=wt,
                              needed=needed, dom=dom, statics=statics,
                              w_contig=2)

        def plain():
            return G._run_gang_scan_plain(cfg, na, carry, xs, table, wt,
                                          needed, dom, statics, 2)
        K = pkg.kernels
        K.reset_launches()
        kc, kp = kern()
        torch.cuda.synchronize()
        if K.RAW_LAUNCHES["run_gang"] != 1:
            fail(f"run_gang[{case}]: {K.RAW_LAUNCHES['run_gang']} CUDA "
                 "launches for one gang, expected one cluster launch")
        t0 = time.perf_counter()
        pc, pp = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, assert_equal_trees(torch, (kp, kc), (pp, pc),
                                          f"run_gang[{case}]"))
        assert_equal_trees(torch, before, list(carry[:4]) + list(carry.cache),
                           f"run_gang[{case}] input")
        accept, placed, _e, _d = kp[bucket:].tolist()
        if (accept, placed) != (int(case != "reject"), m):
            fail(f"run_gang[{case}]: verdict {(accept, placed)}")
        if case == "reject" and not torch.equal(kc.used, carry.used):
            fail("run_gang[reject]: the carry moved")
        out = np_of(kp[:bucket]).tolist()
        ops = gang_ops(cfg, na, table, wt, np_of(xs.widx).tolist(),
                       np_of(xs.valid).tolist(), out, 2)
        moved = gang_bytes(cfg, na, table, wt, bucket, bucket, False,
                           w_contig=2)
        bound_ms, bound_by = bound_of(moved, ops)
        zones_used = len({int(dom[b]) for b in out if b >= 0})
        times[case] = dict(
            accept=accept, placed=placed, S=len(wt), B=bucket,
            zones_used=zones_used, ms=cuda_ms(torch, kern, 5),
            ms_50=cuda_ms(torch, kern, 50),
            device_ms=device_ms(torch, kern, 5), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, ops=vars(ops),
            bytes=moved)
        log("kernel", name="run_gang", case=case, exact_match=True,
            raw_launches=1, **times[case])
    log("kernel", name="run_gang", ptxas={
        "run_gang (cluster)": ptxas_report(pkg, "run_gang",
                                           "run_gang_kernel"),
        "run_gang_sharded (grid)": ptxas_report(pkg, "run_gang_sharded",
                                                "gang_span_grid_kernel")})
    acc = times["accept"]
    rows.append(dict(
        name="run_gang", route="cuda",
        source="kubernetes_tpu_torch/csrc/run_gang.cu",
        replaces="kubernetes_tpu/ops/gang.py:65", launches=0,
        max_abs_err=err, ms=acc["ms"], plain_ms=acc["plain_ms"],
        bound_ms=acc["bound_ms"], bound_by=acc["bound_by"],
        library_ms=None, device_ms=acc["device_ms"],
        by_case={k: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "S", "B")}
                 for k, v in times.items()}))


def create_pods(api, sched, pods, chunk: int = CREATE_BATCH) -> None:
    """perf/harness.py createPods: chunks, each followed by a non-blocking
    schedule_pending, then the full drain."""
    for k in range(0, len(pods), chunk):
        api.create_pods(pods[k:k + chunk])
        sched.schedule_pending(wait=False)
    sched.schedule_pending()


# ---------------------------------------------------------------------------
# the cells through the port's perf harness


HOST_SPANS = ("scheduling_cycle", "schedule_batch", "host_build",
              "host_snapshot", "host_tensorize", "host_group_seed",
              "host_cache", "device_dispatch", "cluster_probe",
              "dispatcher_flush")


def cell_run(device: str, pkg, name: str, clock=None, rails=False,
             mesh=None, gates=None, wrap=None):
    """One cell of CELLS through kubernetes_tpu_torch.perf.harness's
    WorkloadRunner at full width: the harness's measured window (pods
    built inside it, the cyclic collector paused), a Tracer keeping every
    drain's span tree, and a clock that stands still unless the caller
    moves it; with `rails`, the Scheduler's config turns the
    SanitizerRails gate on, and `gates` sets more feature gates; with
    `mesh` the Scheduler runs node-sharded on it; `wrap(api, sched)` runs
    once the Scheduler is built (the timers of `--times ingest`). Returns
    a namespace of the API server, the scheduler, the runner, the
    measured DataItem and its pods/s."""
    from kubernetes_tpu_torch.config import KubeSchedulerConfiguration
    from kubernetes_tpu_torch.perf.harness import (TestCase, Workload,
                                                   WorkloadRunner)
    from kubernetes_tpu_torch.scheduler import Scheduler
    cell = CELLS[name]
    clock = clock or SimpleNamespace(t=1000.0)
    feature_gates = dict(gates or {})
    if rails:
        feature_gates["SanitizerRails"] = True
    config = (KubeSchedulerConfiguration(feature_gates=feature_gates)
              if feature_gates else None)

    def factory(api):
        sched = Scheduler(api, batch_size=BATCH,
                          device=None if mesh is not None else device,
                          clock=lambda: clock.t, config=config, mesh=mesh)
        if wrap is not None:
            wrap(api, sched)
        return sched

    runner = WorkloadRunner(scheduler_factory=factory, batch_size=BATCH,
                            create_batch=CREATE_BATCH, trace=True)
    tc = TestCase(name=name, workload_template=cell["template"],
                  workloads=[])
    items = runner.run(tc, Workload(name=cell["workload"],
                                    params=dict(cell["params"]),
                                    threshold=cell["threshold"] or 0.0))
    sched = runner.last_scheduler
    return SimpleNamespace(api=sched.client, sched=sched, runner=runner,
                           item=items[0], rate=items[0].average, clock=clock)


def window_spans(run) -> list:
    """The root spans that opened inside the measured window."""
    t0 = run.item.start
    return [sp for sp in run.runner.last_tracer.recent
            if t0 <= sp.start <= t0 + run.item.duration_s]


def host_split(run) -> dict:
    """Where the measured window's host seconds went: the summed span
    seconds by name of the drains that opened in the window; the host
    commits that started in the window (`commit_s`, nested commits inside
    their outer one), split into those
    inside a scheduling cycle and those outside (commit_ready and the
    final wait); the rest of the window outside the cycles
    (`create_other_s`: pod creation, the watch fan-out and queue adds,
    the dispatcher flush after the last drain); their shares of the
    window; the probe's seconds a drain; and the whole run's drain-phase
    sums."""
    from kubernetes_tpu_torch.utils.tracing import span_seconds
    spans = window_spans(run)
    by_name = span_seconds(spans)
    out = {k: by_name.get(k, 0.0) for k in HOST_SPANS}
    t0, t1 = run.item.start, run.item.start + run.item.duration_s
    cycles = [(sp.start, sp.start + sp.duration_s) for sp in spans]
    inside = outside = 0.0
    # every drain's commit, timed onto its device_dispatch span; a commit
    # whose failure handling drains the in-flight drains (PostFilter)
    # runs theirs inside its own, so only the outermost count
    commits = sorted((sp.attributes["commit_start"], sp.attributes["commit_s"])
                     for sp in dispatch_spans(run))
    outer_end = float("-inf")
    for c0, secs in commits:
        if c0 < outer_end:
            continue
        outer_end = c0 + secs
        if not t0 <= c0 <= t1:
            continue
        if any(a <= c0 <= b for a, b in cycles):
            inside += secs
        else:
            outside += secs
    out["window_s"] = run.item.duration_s
    out["commit_s"] = inside + outside
    out["commit_in_cycles_s"] = inside
    out["outside_cycles_s"] = run.item.duration_s - out["scheduling_cycle"]
    out["create_other_s"] = out["outside_cycles_s"] - outside
    out["window_drains"] = sum(1 for sp in spans for c in sp.children
                               for d in c.children
                               if d.name == "device_dispatch")
    # the shares of the window, and the probe's host seconds a drain
    out["share"] = {k: out[k] / out["window_s"] for k in (
        "create_other_s", "commit_s", "host_build", "device_dispatch",
        "host_tensorize", "host_group_seed")}
    out["probe_s_per_drain"] = (out["cluster_probe"]
                                / max(out["window_drains"], 1))
    ph = run.sched.drain_phase_seconds
    out["run_phase_s"] = {k: ph.get(k, 0.0) for k in (
        "host_build", "device_dispatch", "device_wait", "commit")}
    out["op_seconds"] = dict(run.runner.last_op_seconds)
    return out


def dispatch_spans(run) -> list:
    """Every device_dispatch span of the run (attributes: groups, runs)."""
    out, stack = [], list(run.runner.last_tracer.recent)
    while stack:
        sp = stack.pop()
        if sp.name == "device_dispatch":
            out.append(sp)
        stack.extend(sp.children)
    return out


def probe_state(sched) -> str:
    """The last resolved cluster-probe snapshot as JSON, without its drain
    id: on the card a drain commits when its event has fired, so the
    harness's non-blocking chunks can cut the drains at other pods than
    the cpu run does (the bind map does not move, the drain count can).
    The snapshot of the state after the last drain must not move."""
    snap = dict(sched._last_probe)
    snap.pop("drainId")
    return json.dumps(snap, sort_keys=True)


def explain_uid(run) -> str:
    """The pod whose decision each cell explains: the last measured pod
    the cell bound."""
    bound = [uid for uid, p in run.api.pods.items() if p.spec.node_name]
    return max(bound, key=lambda u: (len(u), u))


# each cell's rails-off card run: (bind map and pending pods, pods/s),
# what phase 16 holds its rails-on run to, and its final probe snapshot,
# what phase 18 holds its mesh runs to
RAILS_OFF: dict = {}
CARD_PROBE: dict = {}
# each cell's card run with the ColumnarIngest gate on (the default),
# as `ingest_state` gives it: what phase 19 holds the gate-off run to
GATE_ON: dict = {}


def ingest_state(run) -> dict:
    """What the ColumnarIngest gate must not move: the bind map and the
    pending pods, the cache's dump less its node generations (a
    process-global counter), the dispatcher's executed and error counts,
    and the scheduled and unschedulable counts."""
    sched = run.sched
    dump = sched.cache.dump()
    return {"outcome": outcome(run.api, sched),
            "cache_nodes": {n: {k: v for k, v in d.items()
                                if k != "generation"}
                            for n, d in dump["nodes"].items()},
            "assumed": dump["assumed_pods"], "pod_count": dump["pod_count"],
            "dispatcher": (sched.dispatcher.executed,
                           sched.dispatcher.errors),
            "counts": (sched.scheduled_count, sched.unschedulable_count)}


def cell_phase(torch, pkg, device: str, name: str, smi: str, post=None):
    """One cell on the card and on the CPU. The launch counts cover the
    card's run, its explain_pod call and `post(run)` (a step after the
    harness the cell needs); the bind map, the pending pods, the final
    cluster-probe snapshot and one explain_pod answer must equal the cpu
    run's. Returns (card run, cpu run, counts, log fields)."""
    from kubernetes_tpu_torch.obs.explain import explain_pod
    pkg.kernels.reset_launches()
    t0 = time.perf_counter()
    run = cell_run(device, pkg, name)
    if post is not None:
        post(run)
    uid = explain_uid(run)
    expl = explain_pod(run.sched, uid, k=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(pkg.kernels.LAUNCHES)
    if counts["cluster_probe"] != run.sched.device_batches:
        fail(f"{name}: {counts['cluster_probe']} probes for "
             f"{run.sched.device_batches} device drains")
    if counts["explain_row"] != 1 or "error" in expl:
        fail(f"{name}: explain_pod({uid}) gave {expl}")
    if run.sched.reconcile() != []:
        fail(f"{name}: device carry diverges from the host cache")
    t1 = time.perf_counter()
    cpu = cell_run("cpu", pkg, name)
    if post is not None:
        post(cpu)
    RAILS_OFF[name] = (outcome(run.api, run.sched), run.rate)
    CARD_PROBE[name] = probe_state(run.sched)
    if name in GATE_OFF_CELLS:
        GATE_ON[name] = (ingest_state(run), run.rate,
                         host_split(run)["share"])
    if RAILS_OFF[name][0] != outcome(cpu.api, cpu.sched):
        fail(f"{name}: cuda bind map differs from the cpu run")
    if probe_state(run.sched) != probe_state(cpu.sched):
        fail(f"{name}: the final cluster probe differs from the cpu run: "
             f"{run.sched._last_probe} vs {cpu.sched._last_probe}")
    if expl != explain_pod(cpu.sched, uid, k=5):
        fail(f"{name}: explain_pod({uid}) differs from the cpu run")
    fields = dict(
        pods_per_s=run.rate, window_s=run.item.duration_s,
        threshold=CELLS[name]["threshold"], host_split=host_split(run),
        wall_s=wall, launches=counts, drain_readbacks=run.sched.device_batches,
        uniform_rewinds=run.sched.uniform_rewinds,
        cpu_run_s=time.perf_counter() - t1, card=smi,
        bind_map_equals_cpu=True, last_probe_equals_cpu=True,
        explain_equals_cpu=True, explained=uid,
        explain_winner=(expl["winner"] or {}).get("node"),
        last_probe=run.sched._last_probe,
        drains_cuda_cpu=(run.sched.device_batches,
                         cpu.sched.device_batches))
    return run, cpu, counts, fields


def cell_profile(torch, pkg, device: str, name: str, post=None) -> dict:
    """One more run of the cell under torch.profiler: device time per
    kernel and the device's busy share of the run's wall."""
    def once():
        run = cell_run(device, pkg, name)
        if post is not None:
            post(run)
    return profile_run(torch, once)


def basic_phase(torch, pkg, device: str, smi: str):
    """Phase 4: SchedulingBasic 5000Nodes_10000Pods; returns the counts
    and the card's run (its post-drain carry feeds the probe check)."""
    name = "SchedulingBasic"
    run, _cpu, counts, fields = cell_phase(torch, pkg, device, name, smi)
    got = outcome(run.api, run.sched)
    if len(got[0]) != SB_INIT_PODS + SB_PODS:
        fail(f"{name} bound {len(got[0])} of {SB_INIT_PODS + SB_PODS} pods")
    if counts["run_uniform"] <= 0:
        fail(f"{name} never launched the run_uniform kernel")
    log("scheduling_basic", pods=SB_INIT_PODS + SB_PODS, nodes=SB_NODES,
        **fields)
    log("scheduling_basic_profile", card=smi,
        **cell_profile(torch, pkg, device, name))
    return counts, run


def node_affinity_phase(torch, pkg, device: str, smi: str) -> dict:
    """Phase 14: SchedulingNodeAffinity 5000Nodes: every measured pod
    pins a zone through its nodeSelector (zone seq mod 16)."""
    name = "SchedulingNodeAffinity"
    p = CELLS[name]["params"]
    run, _cpu, counts, fields = cell_phase(torch, pkg, device, name, smi)
    got = outcome(run.api, run.sched)
    if len(got[0]) != p["measurePods"] or got[1]:
        fail(f"{name}: bound {len(got[0])} of {p['measurePods']} pods")
    zone_of = {n.metadata.name: n.metadata.labels.get(LABEL_ZONE)
               for n in run.api.nodes.values()}
    for uid, node in got[0].items():
        seq = int(uid.rsplit("-", 1)[1])
        if zone_of[node] != f"zone-{seq % 16}":
            fail(f"{name}: {uid} on {node} in {zone_of[node]}")
    log("node_affinity", pods=p["measurePods"], nodes=p["initNodes"],
        **fields)
    log("node_affinity_profile", card=smi,
        **cell_profile(torch, pkg, device, name))
    return counts


def mixed_workload(device: str, pkg, n_nodes: int = 500):
    """Lean mixed workload: NoSchedule and PreferNoSchedule taints,
    nodeSelector, hostPort and images; four rotating signatures (scan
    spans), same-signature runs (uniform spans) and memory-heavy runs on
    cpu-saturated nodes (uniform rewinds); some pods fit nowhere."""
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    W = pkg.wrappers
    rng = np.random.RandomState(17)
    api = APIServer()
    sched = Scheduler(api, batch_size=1024, device=device,
                      clock=lambda: 1000.0)

    def nodes(prefix, n, prefer):
        out = []
        for i in range(n):
            hog = i % 50 == 0
            w = W.make_node(f"{prefix}{i}").capacity({
                "cpu": 4 if hog else int(rng.choice([8, 16, 32])),
                "memory": "64Gi" if hog
                else f"{int(rng.choice([16, 32, 64]))}Gi",
                "pods": 110}).zone(f"zone-{i % 8}")
            if rng.rand() < 0.3:
                w = w.label("disk", "ssd" if rng.rand() < 0.5 else "hdd")
            if i % 9 == 5:
                w = w.taint("dedicated", "batch", effect="NoSchedule")
            if prefer and i % 7 == 1:
                w = w.taint("spot", "", effect="PreferNoSchedule")
            if i % 5 == 0:
                w = w.image("nginx:1.25", 300 << 20)
            out.append(w.obj())
        return out

    def pods(prefix, runs):
        shapes = [
            lambda k: W.make_pod(k).req({"cpu": "500m", "memory": "1Gi"}),
            lambda k: W.make_pod(k).req({"cpu": "1", "memory": "512Mi"})
            .node_selector({"disk": "ssd"}),
            lambda k: W.make_pod(k).req({"cpu": "250m", "memory": "2Gi"})
            .toleration(key="dedicated", operator="Exists")
            .container({"cpu": "100m"}, image="nginx:1.25"),
            lambda k: W.make_pod(k).req({"cpu": "200m", "memory": "256Mi"})
            .host_port(8080),
        ]
        out = []
        for r in range(runs):
            kind = r % 4
            if kind == 0:
                for k in range(int(rng.randint(40, 200))):
                    out.append(shapes[k % 4](f"{prefix}-{len(out)}").obj())
            elif kind == 1:
                cpu = ["100m", "300m", "1"][int(rng.randint(0, 3))]
                for _ in range(int(rng.randint(100, 600))):
                    out.append(W.make_pod(f"{prefix}-{len(out)}").req(
                        {"cpu": cpu, "memory": "128Mi"}).obj())
            elif kind == 2:
                for _ in range(int(rng.randint(32, 96))):
                    out.append(W.make_pod(f"{prefix}-{len(out)}").req(
                        {"cpu": "0", "memory": "3Gi"}).obj())
            else:
                out.append(W.make_pod(f"{prefix}-{len(out)}").req(
                    {"cpu": "900"}).obj())
                out.append(W.make_pod(f"{prefix}-{len(out)}").req(
                    {"cpu": "1"}).node_selector({"disk": "nvme"}).obj())
        return out

    for nd in nodes("m", n_nodes, prefer=False):
        api.create_node(nd)
    sched.prime()
    api.create_pods([W.make_pod(f"hog-{i}").req(
        {"cpu": "3500m", "memory": "0"}).node(f"m{i}").obj()
        for i in range(0, n_nodes, 50)])
    create_pods(api, sched, pods("a", 16), chunk=256)
    for nd in nodes("late", n_nodes // 10, prefer=True):
        api.create_node(nd)
    create_pods(api, sched, pods("b", 8), chunk=256)
    return api, sched



def mixed_group_workload(device: str, pkg, n_nodes: int = 500):
    """Group drains on every group route of the port: ScheduleAnyway
    spreads, self-matching required affinity and mixed preferred-affinity
    drains (run_plan), two self-matching anti terms (the serial wave
    tier), drains of 16-23 and of fewer than 16 pods (run_batch's group
    mode), PreferNoSchedule taints on some nodes (the renormalizing wave
    tier), and anti pods no zone can take (diagnose_row)."""
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    W = pkg.wrappers
    api = APIServer()
    sched = Scheduler(api, batch_size=256, device=device,
                      clock=lambda: 1000.0)
    for i in range(n_nodes):
        w = W.make_node(f"m{i}").capacity(
            {"cpu": 16, "memory": "64Gi", "pods": 110}).zone(
            f"zone-{i % 10}").label(LABEL_HOSTNAME, f"m{i}")
        if i % 11 == 3:
            w = w.taint("spot", "", effect="PreferNoSchedule")
        api.create_node(w.obj())
    sched.prime()
    seq = [0]

    def pods(n, build):
        out = []
        for _ in range(n):
            out.append(build(W.make_pod(f"g-{seq[0]}").req(
                {"cpu": "500m", "memory": "1Gi"})).obj())
            seq[0] += 1
        return out

    def drain(batch):
        api.create_pods(batch)
        sched.schedule_pending()

    seeds = pods(20, lambda w: w.label("app", "db"))
    drain(seeds)
    # ScheduleAnyway spread (the plan program)
    drain(pods(200, lambda w: w.label("app", "web").spread_constraint(
        3, LABEL_ZONE, "ScheduleAnyway", {"app": "web"})))
    # required affinity to the seeds, self-matching (the plan program)
    drain(pods(120, lambda w: w.label("app", "db").pod_affinity(
        LABEL_ZONE, {"app": "db"})))
    # two self-matching anti terms (the serial wave tier)
    drain(pods(60, lambda w: w.label("anti", "x").label("side", "x")
               .pod_affinity(LABEL_ZONE, {"anti": "x"}, anti=True)
               .pod_affinity(LABEL_HOSTNAME, {"side": "x"}, anti=True)))
    # a same-signature spread drain of 20 pods (the JAX package's host
    # greedy, the port's scan) and one of 10 (the scan in both)
    drain(pods(20, lambda w: w.label("app", "s").spread_constraint(
        1, LABEL_ZONE, "DoNotSchedule", {"app": "s"})))
    drain(pods(10, lambda w: w.label("app", "s").spread_constraint(
        1, LABEL_ZONE, "DoNotSchedule", {"app": "s"})))
    # a long spread drain on the tainted cluster (norm_live wave)
    drain(pods(300, lambda w: w.label("app", "t").spread_constraint(
        2, LABEL_ZONE, "DoNotSchedule", {"app": "t"})))
    # preferred pod affinity and plain pods mixed in one drain
    mixed = []
    for k in range(150):
        if k % 3 == 0:
            mixed += pods(1, lambda w: w.preferred_pod_affinity(
                LABEL_ZONE, {"app": "web"}, 7))
        else:
            mixed += pods(1, lambda w: w)
    drain(mixed)
    return api, sched



def plan_phase(torch, pkg, device: str, kind: str, smi: str) -> dict:
    """Phase 9 / 10: one plan-program workload on the card, checked
    against its cpu run and its own constraint; returns the launch
    counts."""
    if kind == "mhs":
        name, phase = "MixedHighSignature", "mixed_high_signature"
        n_nodes, n_init, n_meas, zones, _cyc = MHS_SHAPE
        total, min_plans = n_init + n_meas, 1
    else:
        name, phase = "MixedSchedulingBasePod", "mixed_base_pod"
        n_nodes, n_init, n_aff, n_meas, zones = MBP_SHAPE
        total, min_plans = n_init + n_aff + n_meas, 2
    run, _cpu, counts, fields = cell_phase(torch, pkg, device, name, smi)
    sched = run.sched
    got = outcome(run.api, sched)
    if len(got[0]) != total:
        fail(f"{name}: bound {len(got[0])} of {total} pods")
    if counts["run_plan"] < min_plans:
        fail(f"{name}: run_plan launched {counts['run_plan']} times, "
             f"expected at least {min_plans}")
    check = {}
    if kind == "mhs":
        per_zone = zone_counts(run.api, ("app", "mix"))
        skew = max(per_zone.values()) - min(per_zone.values())
        if len(per_zone) != zones or skew > 5:
            fail(f"{name}: zone skew {skew} over {len(per_zone)} zones")
        check = {"zone_skew": skew}
    log(phase, pods=total, bound=len(got[0]), nodes=n_nodes,
        plan_runs=sched.plan_runs, wave_runs=sched.wave_runs,
        wave_stats=wave_stats(sched), **fields, **check)
    log(f"{phase}_profile", card=smi,
        **cell_profile(torch, pkg, device, name))
    return counts


def _take_back_preemptors(run) -> None:
    """After PreemptionChurn's measured op: record the nominations and
    the victims, then move the clock past the preemptors' requeue
    backoff and drain them (under their own nominations: run_batch's
    overlay variant)."""
    n_nodes, n_init, n_pre, n_meas, _zones = PC_SHAPE
    run.noms = dict(run.sched.queue.nominator.nominated_pods)
    run.victims = sorted(f"default/pod-{i}" for i in range(n_init)
                         if f"default/pod-{i}" not in run.api.pods)
    run.clock.t += 15.0
    run.sched.schedule_pending()


def preemption_phase(torch, pkg, device: str, smi: str) -> dict:
    """Phase 11: PreemptionChurn on the card, checked against its cpu run
    and its own constraints; returns the launch counts."""
    name = "PreemptionChurn"
    n_nodes, n_init, n_pre, n_meas, _zones = PC_SHAPE
    with OverridesTimer() as overrides:
        run, cpu, counts, fields = cell_phase(torch, pkg, device, name, smi,
                                              post=_take_back_preemptors)
    sched = run.sched
    got = outcome(run.api, sched)
    noms, victims = run.noms, run.victims
    if len(victims) != n_pre:
        fail(f"{name}: {len(victims)} victims deleted, expected {n_pre}")
    if len(noms) != n_pre or any(got[0].get(uid) != node
                                 for uid, node in noms.items()):
        fail(f"{name}: not every preemptor bound to its nominated node")
    if len(got[0]) != n_init - n_pre + n_pre + n_meas or got[1]:
        fail(f"{name}: bound {len(got[0])} pods, {len(got[1])} pending")
    ev = next(p for p in sched.profiles["default-scheduler"].framework
              .plugins if p.name() == "DefaultPreemption")._evaluator
    if counts["dry_run"] < 1 or ev.host_dry_runs != 0:
        fail(f"{name}: dry_run launched {counts['dry_run']} times, "
             f"{ev.host_dry_runs} host dry runs")
    for k in ("run_batch_ovl", "run_uniform_ovl"):
        if counts[k] < 1:
            fail(f"{name}: {k} never launched ({counts})")
    if cpu.noms != noms or cpu.victims != victims:
        fail(f"{name}: nominations or victims differ from the cpu run")
    log("preemption_churn", pods=n_init + n_pre + n_meas, bound=len(got[0]),
        nodes=n_nodes, victims=len(victims), nominations=len(noms),
        batched_dry_runs=ev.batched_dry_runs, host_dry_runs=ev.host_dry_runs,
        preemption_attempts=sched.preemption_attempts,
        nominations_equal_cpu=True, victims_equal_cpu=True,
        dry_run_overrides=overrides.summary("cuda"), **fields)
    log("preemption_churn_profile", card=smi, **cell_profile(
        torch, pkg, device, name, post=_take_back_preemptors))
    return counts


def gang_phase(torch, pkg, device: str, kind: str, smi: str) -> dict:
    """Phase 12 / 13: one gang workload on the card, checked against its
    cpu run and its own gates; returns the launch counts."""
    if kind == "train":
        name, phase = "GangTraining", "gang_training"
        _n, gangs, size, _z = GT_SHAPE
        total, n_gangs, key = gangs * size, gangs, "run_gang_uniform"
    else:
        name, phase = "CoLocatedInference", "colocated_inference"
        _n, gangs, size, n_inf, n_pre, _z = CI_SHAPE
        total, n_gangs, key = gangs * size + n_inf + n_pre * 64, \
            gangs + n_pre, "run_gang"
    run, cpu, counts, fields = cell_phase(torch, pkg, device, name, smi)
    sched = run.sched
    got = outcome(run.api, sched)
    if len(got[0]) != total or got[1]:
        fail(f"{name}: bound {len(got[0])} of {total} pods, "
             f"{len(got[1])} pending")
    gd = dict(sched.gang_dispatch)
    if gd["placed"] != n_gangs or gd["fallback"] or gd["rejected"]:
        fail(f"{name}: gang drains {gd}, expected {n_gangs} placed")
    if cpu.sched.gang_dispatch != gd:
        fail(f"{name}: gang drains {gd} differ from the cpu run's "
             f"{cpu.sched.gang_dispatch}")
    if counts[key] != n_gangs:
        fail(f"{name}: {key} launched {counts[key]} times, expected "
             f"{n_gangs} ({counts})")
    log(phase, pods=total, bound=len(got[0]), nodes=_n, gangs=n_gangs,
        gang_dispatch=gd, gang_replays=sched.gang_replays, **fields)
    log(f"{phase}_profile", card=smi,
        **cell_profile(torch, pkg, device, name))
    return counts


def gang_reject_run(device: str, pkg, n_nodes: int = SB_NODES,
                    size: int = 256):
    """Gang rejection and gang-preempts-gang at full width: 5,000 nodes
    of 8 cpu. Step 1: 2·n/size + 1 = 40 priority-0 gangs of 256 four-cpu
    members (the closed form: 39 fit, two per node, the last finds 16
    slots and is rejected). Step 2: a two-cpu gang of 64 at contiguity weight 2 (the
    scan tier) finds 64 free cpu for its 128 and is rejected. Step 3: a
    priority-100 gang of 16 whole-node members at weight 0 finds eight
    empty nodes: rejected, its members' PostFilter evicts priority-0
    members and nominates, and after the requeue backoff the gang binds.
    Returns (api, scheduler, per-step {gang_dispatch, launches} deltas,
    nominations before the requeue, victims, seconds)."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup, Workload
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing.workloads import GangWorkloadGenerator
    W = pkg.wrappers
    K = pkg.kernels.LAUNCHES
    api = APIServer()
    clock = SimpleNamespace(t=1000.0)
    sched = Scheduler(api, batch_size=BATCH, device=device,
                      clock=lambda: clock.t)
    for nd in pc_nodes(W, n_nodes, 16):
        api.create_node(nd)
    sched.prime()
    steps = {}

    def step(label, fn):
        g0, k0 = dict(sched.gang_dispatch), dict(K)
        fn()
        steps[label] = {
            "gang_dispatch": {k: sched.gang_dispatch[k] - g0[k]
                              for k in g0},
            "launches": {k: K[k] - k0[k] for k in K if K[k] != k0[k]}}

    def gang(name, size, cpu, prio):
        api.create_workload(Workload(metadata=ObjectMeta(name=name),
                                     pod_groups=[PodGroup(
                                         name="workers", min_count=size)]))
        create_pods(api, sched, [W.make_pod(f"{name}-{i}").req(
            {"cpu": cpu, "memory": "1Gi"}).workload(name).priority(prio)
            .obj() for i in range(size)])

    t0 = time.perf_counter()
    gen = GangWorkloadGenerator(seed=0)
    specs = gen.training_gangs(2 * n_nodes // size + 1, size=size,
                               cpu="4", memory="1Gi", priority=0)

    members: list = []

    def fill():
        for what, obj in gen.trace(specs, chunk=CREATE_BATCH):
            if what == "workload":
                api.create_workload(obj)
                continue
            members.extend(p.uid for p in obj)
            api.create_pods(obj)
            sched.schedule_pending(wait=False)
        sched.schedule_pending()

    def scan_reject():
        sched.gang_contiguity_weight = 2
        gang("wide", 64, "2", 0)
        sched.gang_contiguity_weight = 0

    step("closed_form_reject", fill)
    step("scan_reject", scan_reject)
    step("preempt", lambda: gang("high", 16, "8", 100))
    noms = dict(sched.queue.nominator.nominated_pods)
    victims = sorted(uid for uid in members if uid not in api.pods)

    def requeue():
        for _ in range(3):
            clock.t += 15.0
            sched.flush_queues()
            sched.schedule_pending()
    step("requeue", requeue)
    return api, sched, steps, noms, victims, time.perf_counter() - t0


def gang_reject_phase(torch, pkg, device: str, smi: str) -> dict:
    """Phase 15: gang rejection on both run_gang tiers and a gang that
    preempts a gang, on the card, held to a full-width cpu run."""
    from kubernetes_tpu_torch.obs.explain import explain_pod
    name = "gang reject / preempt"
    pkg.kernels.reset_launches()
    api, sched, steps, noms, victims, secs = gang_reject_run(device, pkg)
    uid = "default/high-0"
    expl = explain_pod(sched, uid, k=5)
    torch.cuda.synchronize()
    counts = dict(pkg.kernels.LAUNCHES)
    got = outcome(api, sched)
    if steps["closed_form_reject"]["gang_dispatch"]["rejected"] < 1 or \
            steps["closed_form_reject"]["launches"].get(
                "run_gang_uniform", 0) < 1:
        fail(f"{name}: no closed-form rejection ({steps})")
    if steps["scan_reject"]["gang_dispatch"]["rejected"] < 1 or \
            steps["scan_reject"]["launches"].get("run_gang", 0) < 1:
        fail(f"{name}: no scan-tier rejection ({steps})")
    high = [u for u in got[0] if u.startswith("default/high-")]
    if len(high) != 16 or not victims or not noms:
        fail(f"{name}: {len(high)} of 16 high members bound, "
             f"{len(victims)} victims, {len(noms)} nominations")
    if sched.reconcile() != []:
        fail(f"{name}: device carry diverges from the host cache")
    t1 = time.perf_counter()
    api_c, sched_c, steps_c, noms_c, victims_c, _s = gang_reject_run(
        "cpu", pkg)
    if outcome(api_c, sched_c) != got:
        fail(f"{name}: cuda bind map differs from the cpu run")
    if (noms_c, victims_c) != (noms, victims):
        fail(f"{name}: nominations or victims differ from the cpu run")
    gd_of = {k: v["gang_dispatch"] for k, v in steps.items()}
    if {k: v["gang_dispatch"] for k, v in steps_c.items()} != gd_of:
        fail(f"{name}: gang drains differ from the cpu run")
    if probe_state(sched) != probe_state(sched_c):
        fail(f"{name}: the final cluster probe differs from the cpu run")
    if expl != explain_pod(sched_c, uid, k=5):
        fail(f"{name}: explain_pod({uid}) differs from the cpu run")
    log("gang_reject_preempt", nodes=SB_NODES, bound=len(got[0]),
        pending=len(got[1]), victims=len(victims), nominations=len(noms),
        steps=steps, gang_dispatch=dict(sched.gang_dispatch),
        gang_replays=sched.gang_replays,
        preemption_attempts=sched.preemption_attempts, seconds=secs,
        launches=counts, cpu_run_s=time.perf_counter() - t1, card=smi,
        bind_map_equals_cpu=True, nominations_equal_cpu=True,
        victims_equal_cpu=True, gang_dispatch_equals_cpu=True,
        last_probe_equals_cpu=True, explain_equals_cpu=True)
    return counts


# phase 16: the sanitizer rails on the card. GangTraining joins the five
# cells the rails cover for its closed-form gangs, the other carry a
# dispatched run holds
RAILS_CELLS = ("SchedulingBasic", "TopologySpreading", "MixedHighSignature",
               "PreemptionChurn", "GangTraining", "CoLocatedInference")


def rails_phase(torch, pkg, device: str, smi: str) -> dict:
    """Phase 16: each of RAILS_CELLS at full width with the SanitizerRails
    gate on (the sync guard armed on every dispatch, one score_probe per
    device drain, the held-carry check at every commit of a run that
    kept its carry), its bind map held to its rails-off card run; then
    the guard's and the held-carry checksum's negative checks. Returns
    the launch counts summed over the cells."""
    from kubernetes_tpu_torch.analysis.rails import (GLOBAL as RAILS,
                                                     SanitizerError)
    total = {k: 0 for k in pkg.kernels.LAUNCHES}
    try:
        for name in RAILS_CELLS:
            post = _take_back_preemptors if name == "PreemptionChurn" \
                else None
            pkg.kernels.reset_launches()
            guarded0, held0 = RAILS.guarded_dispatches, RAILS.held_checks
            staged0 = RAILS.staged_bytes
            run = cell_run(device, pkg, name, rails=True)
            if post is not None:
                post(run)
            torch.cuda.synchronize()
            counts = dict(pkg.kernels.LAUNCHES)
            sched = run.sched
            guarded = RAILS.guarded_dispatches - guarded0
            if not RAILS.active or sched.device_batches <= 0:
                fail(f"rails {name}: the gate did not arm the rails")
            if outcome(run.api, sched) != RAILS_OFF[name][0]:
                fail(f"rails {name}: bind map differs from the rails-off "
                     "card run")
            if counts["score_probe"] != sched.device_batches:
                fail(f"rails {name}: {counts['score_probe']} score probes "
                     f"for {sched.device_batches} device drains")
            if guarded != sched.device_batches:
                fail(f"rails {name}: the sync guard armed {guarded} times "
                     f"for {sched.device_batches} device drains")
            if sched.reconcile() != []:
                fail(f"rails {name}: device carry diverges from the host "
                     "cache")
            log("sanitizer_rails", cell=name, card=smi,
                pods_per_s=run.rate, rails_off_pods_per_s=RAILS_OFF[name][1],
                window_s=run.item.duration_s,
                device_batches=sched.device_batches,
                guarded_dispatches=guarded,
                held_checks=RAILS.held_checks - held0,
                staged_bytes=RAILS.staged_bytes - staged0,
                uniform_rewinds=sched.uniform_rewinds,
                gang_replays=sched.gang_replays, launches=counts,
                bind_map_equals_rails_off=True)
            for k, v in counts.items():
                total[k] += v
        # an undeclared synchronizing call inside the guard raises, and
        # the guard restores the sync debug mode it found
        x = torch.ones(4, device=device)
        with RAILS.enabled(True):
            try:
                with RAILS.guard_dispatch(device):
                    x.sum().item()
            except RuntimeError as e:
                tripped = str(e).splitlines()[0]
            else:
                fail("rails: .item() inside guard_dispatch did not raise")
        if torch.cuda.get_sync_debug_mode() != 0:
            fail("rails: the guard left the sync debug mode armed")
        # a write through `.data` moves no version counter: only the
        # device checksum of the held carry sees it
        carry = pkg.program.initial_carry(sched.state.device_arrays())
        with RAILS.enabled(True):
            held = RAILS.hold(carry)
            version = carry.used._version
            carry.used.data.add_(1)
            if carry.used._version != version:
                fail("rails: .data write moved the version counter")
            try:
                RAILS.check_held(held, "negative check")
            except SanitizerError:
                pass
            else:
                fail("rails: the held-carry checksum missed a device write")
        log("sanitizer_rails_checks", guard_trips_on_item=tripped,
            checksum_sees_data_write=True, card=smi)
    finally:
        RAILS.enable(False)
    return total


# ---------------------------------------------------------------------------
# phase 19: the ColumnarIngest gate off on the card


GATE_OFF_CELLS = ("SchedulingBasic", "TopologySpreading", "PreemptionChurn",
                  "GangTraining")


def gate_off_phase(torch, pkg, device: str, smi: str) -> dict:
    """Phase 19: each of GATE_OFF_CELLS at full width with the
    ColumnarIngest gate off (the serial build, node-row writers, commit
    and bind echo), held to its gate-on card run (`ingest_state`): the
    lean path, the group path, failures with nominations and the overlay,
    and accepted gang drains. Returns the launch counts summed over the
    cells."""
    total = {k: 0 for k in pkg.kernels.LAUNCHES}
    for name in GATE_OFF_CELLS:
        post = _take_back_preemptors if name == "PreemptionChurn" else None
        pkg.kernels.reset_launches()
        run = cell_run(device, pkg, name, gates={"ColumnarIngest": False})
        if post is not None:
            post(run)
        torch.cuda.synchronize()
        counts = dict(pkg.kernels.LAUNCHES)
        sched = run.sched
        if (sched.commit_engine is not None or sched.builder.columnar
                or sched.state.columnar):
            fail(f"gate off {name}: the columnar paths are still on")
        if sched.reconcile() != []:
            fail(f"gate off {name}: device carry diverges from the host "
                 "cache")
        on_state, on_rate, on_share = GATE_ON[name]
        got = ingest_state(run)
        for key in got:
            if got[key] != on_state[key]:
                fail(f"gate off {name}: {key} differs from the gate-on "
                     "card run")
        log("columnar_ingest_off", cell=name, card=smi, pods_per_s=run.rate,
            gate_on_pods_per_s=on_rate, window_s=run.item.duration_s,
            share=host_split(run)["share"], gate_on_share=on_share,
            device_batches=sched.device_batches,
            counts=list(got["counts"]), dispatcher=list(got["dispatcher"]),
            launches=counts, equals_gate_on=True)
        for k, v in counts.items():
            total[k] += v
    return total


# ---------------------------------------------------------------------------
# phase 17: the mesh on the card


# the single-device programs, none of which a mesh run may launch in
# place of its sharded twin
SINGLE_DEVICE = ("run_batch", "run_batch_groups", "run_uniform", "run_plan",
                 "run_wave", "run_gang", "run_gang_uniform", "wave_statics",
                 "scatter_rows", "cluster_probe")


def beyond_lattice_run(torch, pkg, mesh=None, spread: bool = False):
    """5,000 harness nodes and 2,048 pods whose cpu / memory requests
    rotate over 40 shapes, so every drain holds more signatures than the
    plan program's lattice (PLAN_MAX_SIGS = 32) and rides the scan; two
    waves (800 pods, then 1,248) with one node update between them, so
    the reseed's dirty rows (at most 801 of 8,192) ride the dirty-row
    upload. With `spread` every shape also carries a zone spread
    (DoNotSchedule, maxSkew 5), so every drain scans in group mode.
    Returns (api, scheduler, pods/s over both waves)."""
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    W = pkg.wrappers
    api = APIServer()
    sched = Scheduler(api, batch_size=BATCH,
                      device=None if mesh is not None else "cuda",
                      clock=lambda: 1000.0, mesh=mesh)

    def node(i, extra=None):
        w = W.make_node(f"node-{i}").capacity(
            {"cpu": 32, "memory": "64Gi", "pods": 110}).zone(
            f"zone-{i % 16}").label(LABEL_HOSTNAME, f"node-{i}")
        return (w.label(*extra) if extra else w).obj()

    for i in range(SB_NODES):
        api.create_node(node(i))
    sched.prime()
    pods = [W.make_pod(f"bl-{i}").req(
        {"cpu": f"{100 + 50 * (i % 40)}m",
         "memory": f"{256 + 128 * (i % 40)}Mi"}) for i in range(2048)]
    if spread:
        pods = [p.label("app", "bl").spread_constraint(
            5, LABEL_ZONE, "DoNotSchedule", {"app": "bl"}) for p in pods]
    pods = [p.obj() for p in pods]
    t0 = time.perf_counter()
    api.create_pods(pods[:800])
    sched.schedule_pending()
    api.update_node(node(7, ("maintenance", "soon")))
    api.create_pods(pods[800:])
    sched.schedule_pending()
    torch.cuda.synchronize()
    return api, sched, len(pods) / (time.perf_counter() - t0)


def mesh_checks(name: str, sched, counts: dict, sharded: tuple) -> None:
    if sched.reconcile() != []:
        fail(f"{name}: device carry diverges from the host cache")
    if counts["cluster_probe_sharded"] != sched.device_batches:
        fail(f"{name}: {counts['cluster_probe_sharded']} sharded probes "
             f"for {sched.device_batches} device drains")
    for k in sharded:
        if counts[k] <= 0:
            fail(f"{name} launches {counts}: {k} never ran")
    for k in SINGLE_DEVICE:
        if counts[k] != 0:
            fail(f"{name} launches {counts}: the single-device {k} ran on "
                 "the mesh")


def mesh_phase(torch, pkg, smi: str, sb_probe: str) -> dict:
    """SchedulingBasic 5000Nodes_10000Pods through the harness on
    make_mesh(2) and make_mesh(4): every pod bound, the bind map and the
    final probe snapshot of phase 4's single-device card run, one
    cluster_probe_sharded a device drain, the sharded kernels launched and
    the single-device lean kernels not. Then the beyond-lattice check on
    make_mesh(2) against the single-device card run. Returns the launch
    counts by path."""
    S = pkg.sharding
    name = "SchedulingBasic"
    paths = {}
    for D in MESH_SIZES:
        mesh = S.make_mesh(D)
        pkg.kernels.reset_launches()
        t0 = time.perf_counter()
        run = cell_run("cuda", pkg, name, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(pkg.kernels.LAUNCHES)
        got = outcome(run.api, run.sched)
        what = f"{name} on make_mesh({D})"
        if len(got[0]) != SB_INIT_PODS + SB_PODS:
            fail(f"{what} bound {len(got[0])} of "
                 f"{SB_INIT_PODS + SB_PODS} pods")
        if got != RAILS_OFF[name][0]:
            fail(f"{what}: the bind map differs from phase 4's card run")
        if probe_state(run.sched) != sb_probe:
            fail(f"{what}: the final cluster probe differs from phase 4's")
        mesh_checks(what, run.sched, counts, ("run_uniform_sharded",))
        paths[f"mesh{D}_scheduling_basic"] = counts
        log("mesh_scheduling_basic", shards=D, mesh=repr(mesh),
            pods=SB_INIT_PODS + SB_PODS, pods_per_s=run.rate,
            single_device_pods_per_s=RAILS_OFF[name][1],
            window_s=run.item.duration_s, host_split=host_split(run),
            wall_s=wall, launches=counts,
            drain_readbacks=run.sched.device_batches,
            uniform_rewinds=run.sched.uniform_rewinds,
            uploads={k: getattr(run.sched.state, k) for k in (
                "full_uploads_total", "rows_scattered_total")},
            card=smi, bind_map_equals_phase4=True,
            last_probe_equals_phase4=True)
        del run
    # the beyond-lattice check: the single-device card run, then the mesh
    pkg.kernels.reset_launches()
    api1, s1, rate1 = beyond_lattice_run(torch, pkg)
    single = dict(pkg.kernels.LAUNCHES)
    want = outcome(api1, s1)
    if s1.reconcile() != [] or single["run_batch"] <= 0 \
            or single["scatter_rows"] <= 0:
        fail(f"beyond-lattice single-device run: launches {single}")
    mesh = S.make_mesh(2)
    pkg.kernels.reset_launches()
    api2, s2, rate2 = beyond_lattice_run(torch, pkg, mesh)
    counts = dict(pkg.kernels.LAUNCHES)
    if outcome(api2, s2) != want:
        fail("beyond-lattice on make_mesh(2): the bind map differs from "
             "the single-device card run")
    if probe_state(s2) != probe_state(s1):
        fail("beyond-lattice on make_mesh(2): the final cluster probe "
             "differs from the single-device card run")
    mesh_checks("beyond-lattice on make_mesh(2)", s2, counts,
                ("run_batch_sharded", "scatter_rows_sharded"))
    paths["beyond_lattice_single"] = single
    paths["mesh2_beyond_lattice"] = counts
    log("mesh_beyond_lattice", shards=2, pods=2048, nodes=SB_NODES,
        bound=len(want[0]), pending=len(want[1]), signatures=40,
        pods_per_s=rate2, single_device_pods_per_s=rate1,
        launches=counts, single_device_launches=single,
        drains=(s2.device_batches, s1.device_batches),
        uploads={k: (getattr(s2.state, k), getattr(s1.state, k)) for k in (
            "full_uploads_total", "rows_scattered_total")},
        card=smi, bind_map_equals_single_device=True,
        last_probe_equals_single_device=True)
    return paths


# ---------------------------------------------------------------------------
# phase 18: the mesh's group and gang paths on the card

# (cell, mesh size, the sharded programs it must launch)
MESH_GROUP_CELLS = (
    ("TopologySpreading", 2, ("run_plan_sharded", "wave_statics_sharded")),
    ("SchedulingPodAntiAffinity", 2, ("run_plan_sharded",
                                      "wave_statics_sharded")),
    ("MixedSchedulingBasePod", 2, ("run_plan_sharded",
                                   "wave_statics_sharded")),
    ("MixedHighSignature", 2, ("run_plan_sharded", "wave_statics_sharded")),
    ("GangTraining", 2, ("run_gang_uniform_sharded",)),
    ("CoLocatedInference", 2, ("run_gang_sharded", "wave_statics_sharded")),
    ("GangTraining", 4, ("run_gang_uniform_sharded",)),
    ("TopologySpreading", 4, ("run_plan_sharded", "wave_statics_sharded")),
    ("CoLocatedInference", 4, ("run_gang_sharded", "wave_statics_sharded")),
)


def mesh_gang_reject_run(torch, pkg, mesh=None):
    """Phase 15's reject half on 5,000 nodes of 8 cpu: 40 priority-0 gangs
    of 256 four-cpu members (the closed form: 39 fit, the last is
    rejected), then a closed-form gang of 32 four-cpu members and a
    scan-tier gang of 64 two-cpu members (contiguity weight 2), each
    finding 64 free cpu for its 128: both rejected. Returns (api,
    scheduler, the carry before and after each of the last two gangs,
    the launches of each)."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup, Workload
    from kubernetes_tpu_torch.backend.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing.workloads import GangWorkloadGenerator
    S, W, K = pkg.sharding, pkg.wrappers, pkg.kernels.LAUNCHES
    api = APIServer()
    sched = Scheduler(api, batch_size=BATCH,
                      device=None if mesh is not None else "cuda",
                      clock=lambda: 1000.0, mesh=mesh)
    for nd in pc_nodes(W, SB_NODES, 16):
        api.create_node(nd)
    sched.prime()
    gen = GangWorkloadGenerator(seed=0)
    specs = gen.training_gangs(2 * SB_NODES // 256 + 1, size=256, cpu="4",
                               memory="1Gi", priority=0)
    for what, obj in gen.trace(specs, chunk=CREATE_BATCH):
        if what == "workload":
            api.create_workload(obj)
            continue
        api.create_pods(obj)
        sched.schedule_pending(wait=False)
    sched.schedule_pending()

    def carry_now():
        c = sched._device_carry
        whole = S.unshard(c) if isinstance(c, S.Shards) else c
        return [t.clone() for t in list(whole[:4]) + list(whole.cache)]

    steps = {}
    for tier, name, size, cpu, contig in (("closed_form", "late", 32, "4", 0),
                                          ("scan", "wide", 64, "2", 2)):
        sched.gang_contiguity_weight = contig
        before, k0 = carry_now(), dict(K)
        g0 = dict(sched.gang_dispatch)
        api.create_workload(Workload(metadata=ObjectMeta(name=name),
                                     pod_groups=[PodGroup(
                                         name="workers", min_count=size)]))
        create_pods(api, sched, [W.make_pod(f"{name}-{i}").req(
            {"cpu": cpu, "memory": "1Gi"}).workload(name).obj()
            for i in range(size)])
        torch.cuda.synchronize()
        steps[tier] = dict(
            before=before, after=carry_now(),
            launches={k: K[k] - k0[k] for k in K if K[k] != k0[k]},
            gang_dispatch={k: sched.gang_dispatch[k] - g0[k] for k in g0})
    sched.gang_contiguity_weight = 0
    return api, sched, steps


def mesh_group_phase(torch, pkg, smi: str) -> dict:
    """Phase 18: TopologySpreading, SchedulingPodAntiAffinity,
    MixedSchedulingBasePod, MixedHighSignature, GangTraining and
    CoLocatedInference through the harness on make_mesh(2), and
    TopologySpreading, GangTraining and CoLocatedInference on
    make_mesh(4): every pod
    bound, the bind map and the final probe snapshot of the cell's
    single-device card run (phases 6, 7, 10, 9, 12, 13), reconcile() ==
    [], one cluster_probe_sharded a device drain, the sharded programs
    launched and no single-device program, each cell's own checks. Then on
    make_mesh(2) the beyond-lattice group drain set against its
    single-device card run, and a gang rejected on each run_gang_sharded
    tier leaving the whole carry as it was. Returns the launch counts by
    path."""
    S = pkg.sharding
    paths = {}
    for name, D, sharded in MESH_GROUP_CELLS:
        what = f"{name} on make_mesh({D})"
        mesh = S.make_mesh(D)
        pkg.kernels.reset_launches()
        t0 = time.perf_counter()
        run = cell_run("cuda", pkg, name, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(pkg.kernels.LAUNCHES)
        got = outcome(run.api, run.sched)
        want = RAILS_OFF[name][0]
        if got[1] or len(got[0]) != len(want[0]):
            fail(f"{what}: bound {len(got[0])} of {len(want[0])} pods, "
                 f"{len(got[1])} pending")
        if got != want:
            fail(f"{what}: the bind map differs from the single-device "
                 "card run")
        if probe_state(run.sched) != CARD_PROBE[name]:
            fail(f"{what}: the final cluster probe differs from the "
                 "single-device card run")
        mesh_checks(what, run.sched, counts, sharded)
        check = {}
        if name == "TopologySpreading":
            per_zone = zone_counts(run.api, ("app", "spread"))
            check["zone_skew"] = max(per_zone.values()) - min(
                per_zone.values())
            if check["zone_skew"] > 5:
                fail(f"{what}: zone skew {check['zone_skew']}")
        elif name == "SchedulingPodAntiAffinity":
            per_zone = zone_counts(run.api, ("anti", "yes"))
            check["max_anti_pods_per_zone"] = max(per_zone.values())
            if check["max_anti_pods_per_zone"] > 1:
                fail(f"{what}: a zone holds more than one anti pod")
        elif name in ("GangTraining", "CoLocatedInference"):
            n_gangs = (GT_SHAPE[1] if name == "GangTraining"
                       else CI_SHAPE[1] + CI_SHAPE[4])
            key = ("run_gang_uniform_sharded" if name == "GangTraining"
                   else "run_gang_sharded")
            gd = dict(run.sched.gang_dispatch)
            if gd["placed"] != n_gangs or gd["fallback"] or gd["rejected"]:
                fail(f"{what}: gang drains {gd}, expected {n_gangs} placed")
            if counts[key] != n_gangs:
                fail(f"{what}: {key} launched {counts[key]} times, "
                     f"expected one a gang ({n_gangs})")
            check.update(gang_dispatch=gd, gangs=n_gangs)
        paths[f"mesh{D}_{name}"] = counts
        log("mesh_group_cell", cell=name, shards=D, mesh=repr(mesh),
            pods=len(got[0]), pods_per_s=run.rate,
            single_device_pods_per_s=RAILS_OFF[name][1],
            window_s=run.item.duration_s, host_split=host_split(run),
            wall_s=wall, launches=counts,
            drain_readbacks=run.sched.device_batches, card=smi,
            bind_map_equals_single_device=True,
            last_probe_equals_single_device=True, **check)
        del run

    # the beyond-lattice group drain set: the single-device card run,
    # then the mesh
    pkg.kernels.reset_launches()
    api1, s1, rate1 = beyond_lattice_run(torch, pkg, spread=True)
    single = dict(pkg.kernels.LAUNCHES)
    want = outcome(api1, s1)
    if s1.reconcile() != [] or single["run_batch_groups"] <= 0:
        fail(f"beyond-lattice group single-device run: launches {single}")
    mesh = S.make_mesh(2)
    pkg.kernels.reset_launches()
    api2, s2, rate2 = beyond_lattice_run(torch, pkg, mesh, spread=True)
    counts = dict(pkg.kernels.LAUNCHES)
    what = "beyond-lattice group drains on make_mesh(2)"
    if outcome(api2, s2) != want:
        fail(f"{what}: the bind map differs from the single-device card "
             "run")
    if probe_state(s2) != probe_state(s1):
        fail(f"{what}: the final cluster probe differs from the "
             "single-device card run")
    mesh_checks(what, s2, counts, ("run_batch_sharded_groups",))
    paths["mesh2_beyond_lattice_groups"] = counts
    log("mesh_beyond_lattice_groups", shards=2, pods=2048, nodes=SB_NODES,
        bound=len(want[0]), pending=len(want[1]), signatures=40,
        pods_per_s=rate2, single_device_pods_per_s=rate1, launches=counts,
        single_device_launches=single,
        drains=(s2.device_batches, s1.device_batches), card=smi,
        bind_map_equals_single_device=True,
        last_probe_equals_single_device=True)

    # a gang rejected on each tier: the whole carry unchanged
    pkg.kernels.reset_launches()
    api1, s1, steps1 = mesh_gang_reject_run(torch, pkg)
    pkg.kernels.reset_launches()
    api2, s2, steps2 = mesh_gang_reject_run(torch, pkg, mesh)
    counts = dict(pkg.kernels.LAUNCHES)
    what = "gang rejection on make_mesh(2)"
    if outcome(api2, s2) != outcome(api1, s1):
        fail(f"{what}: the bind map differs from the single-device card "
             "run")
    for tier, key in (("closed_form", "run_gang_uniform_sharded"),
                      ("scan", "run_gang_sharded")):
        st = steps2[tier]
        if st["gang_dispatch"]["rejected"] != 1 or \
                st["launches"].get(key, 0) < 1:
            fail(f"{what}: no {tier} rejection ({st['gang_dispatch']}, "
                 f"{st['launches']})")
        if steps1[tier]["gang_dispatch"] != st["gang_dispatch"]:
            fail(f"{what}: {tier} gang drains differ from the single-device "
                 "run")
        assert_equal_trees(torch, st["after"], st["before"],
                           f"{what}: the carry across the {tier} rejection")
    mesh_checks(what, s2, counts, ("run_gang_uniform_sharded",
                                   "run_gang_sharded"))
    paths["mesh2_gang_reject"] = counts
    log("mesh_gang_reject", shards=2, nodes=SB_NODES, launches=counts,
        steps={t: {k: v for k, v in st.items()
                   if k in ("launches", "gang_dispatch")}
               for t, st in steps2.items()},
        gang_dispatch=dict(s2.gang_dispatch), card=smi,
        bind_map_equals_single_device=True, carry_unchanged=True)
    return paths


def wave_stats(sched) -> dict:
    """The scheduler's summed run_wave and run_plan stats, JSON-ready."""
    st = dict(sched.wave_stats)
    st["first_prefix"] = list(st["first_prefix"])
    return st


def zone_counts(api, label: tuple) -> dict:
    """Pods carrying `label` per zone, from the API server's bind map."""
    zone_of = {n.metadata.name: n.metadata.labels.get(LABEL_ZONE)
               for n in api.nodes.values()}
    out: dict = {}
    k, v = label
    for p in api.pods.values():
        if p.spec.node_name and p.metadata.labels.get(k) == v:
            z = zone_of[p.spec.node_name]
            out[z] = out.get(z, 0) + 1
    return out


def profile_run(torch, fn) -> dict:
    """One more run of `fn` under torch.profiler: device time per kernel
    and the device's busy share of the run's wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            per_kernel[ev.key] = us / 1e3
    busy_ms = sum(per_kernel.values())
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall if busy_ms else None,
            "top_device_ms": top}

def group_phase(torch, pkg, device: str, kind: str, smi: str) -> dict:
    """Phase 6 / 7: one group workload on the card, checked against its
    cpu run and its own constraint; returns the launch counts."""
    n_nodes, n_init, n_meas, zones = TS_SHAPE if kind == "spread" else AA_SHAPE
    name = ("TopologySpreading" if kind == "spread"
            else "SchedulingPodAntiAffinity")
    run, _cpu, counts, fields = cell_phase(torch, pkg, device, name, smi)
    sched = run.sched
    got = outcome(run.api, sched)
    if len(got[0]) != n_init + n_meas:
        fail(f"{name}: bound {len(got[0])} of {n_init + n_meas} pods")
    group_drains = [sp for sp in dispatch_spans(run)
                    if sp.attributes.get("groups")]
    waves = [sp for sp in group_drains
             if sp.attributes.get("runs") == "wave"]
    if counts["run_wave"] <= 0 or not group_drains \
            or len(waves) != len(group_drains):
        fail(f"{name}: run_wave ran on {len(waves)} of "
             f"{len(group_drains)} group drains")
    per_zone = zone_counts(run.api, ("app", "spread") if kind == "spread"
                           else ("anti", "yes"))
    if kind == "spread":
        skew = max(per_zone.values()) - min(per_zone.values())
        if len(per_zone) != zones or skew > 5:
            fail(f"{name}: zone skew {skew} over {len(per_zone)} zones")
        check = {"zone_skew": skew}
    else:
        if max(per_zone.values()) > 1:
            fail(f"{name}: a zone holds more than one anti pod")
        check = {"max_anti_pods_per_zone": max(per_zone.values())}
    log(kind == "spread" and "topology_spreading" or "pod_anti_affinity",
        pods=n_init + n_meas, bound=len(got[0]), nodes=n_nodes,
        group_drains=len(group_drains), wave_runs=sched.wave_runs,
        wave_stats=wave_stats(sched), merge_loop_readbacks=0, **fields,
        **check)
    log(f"{kind}_profile", card=smi,
        **cell_profile(torch, pkg, device, name))
    return counts


def outcome(api, sched):
    binds = {uid: p.spec.node_name for uid, p in api.pods.items()
             if p.spec.node_name}
    pending = sorted(p.uid for p in sched.queue.pending_pods()[0])
    return binds, pending


# ---------------------------------------------------------------------------


def plan_times(torch, pkg, device, reps: int = 3) -> dict:
    """The plan program at its main-path shapes: timed ms (CUDA events
    over `reps` calls; one for the parent's slowest mesh span) and device
    ms (torch.profiler) — run_plan at MixedHighSignature's first drain
    (S = 8, W = 4,096) and on the lean ports span (S = 4, W = 1,024), and
    run_plan_sharded on D shards of one card at both. Only the port's
    public entries are called, so an older checkout is timed the same way
    (`--times plan ROOT`)."""
    P, S = pkg.program, pkg.sharding
    out = {}
    for kind in ("mhs", "lean_ports"):
        args, _m, shape = plan_inputs(torch, pkg, device, kind)

        def single():
            return P.run_plan(*args)
        out[f"run_plan[{kind}]"] = dict(
            ms=cuda_ms(torch, single, reps),
            device_ms=device_ms(torch, single, reps),
            S=shape["S"], W=shape["W"])
        cfg, na, carry, xs, table, wt, gd, _st, fam, nl, hg, hp = args
        for D in MESH_SIZES:
            if kind == "lean_ports" and D != 2:
                continue
            mesh = S.make_mesh(devices=[device] * D)
            gna, gc0, ggd = sharded_state(S, mesh, na, carry, gd)
            gst = S.wave_statics_sharded(mesh, gna, table, wt)

            def sharded():
                return S.run_plan_sharded(cfg, mesh, gna, gc0, xs, table,
                                          wt, ggd, gst, fam, nl, hg, hp)
            n = 1 if kind == "mhs" else reps
            out[f"run_plan_sharded[{kind}, D={D}]"] = dict(
                ms=cuda_ms(torch, sharded, n),
                device_ms=device_ms(torch, sharded, n),
                S=shape["S"], W=shape["W"], D=D)
            del gna, gc0, ggd, gst
        del args
    return out


def batch_times(torch, pkg, device, reps: int = 3) -> dict:
    """run_batch at its main-path shapes and the mesh's probe: timed ms
    (CUDA events over `reps` calls) and device ms (torch.profiler) — row
    1 on phase 3's 1,024-pod mixed span, row 1o on the same span and on
    PreemptionChurn's last drain (2,008 pods in a 2,048 bucket), row 1g
    on its 1,024-pod span of five signatures; then row 11 and row 14h on
    make_mesh(2) / (4) of one card at N = 8,192 (the mixed span's output
    carry, zone domain ids), beside `torch.sort` of the [N, R] util (their
    library yardstick). Only the port's public entries are called, so an
    older checkout is timed the same way (`--times batch ROOT`)."""
    P, S = pkg.program, pkg.sharding
    cfg = P.ScoreConfig()
    b = batch_span_inputs(torch, pkg, device)
    c = churn_inputs(torch, pkg, device)
    g = groups_span_inputs(pkg, device, 1024)
    gcarry = P.initial_carry(g[0], g[4])
    runs = {
        "run_batch[mixed span]": lambda: P.run_batch(
            cfg, b.na, b.carry0, b.xs, b.table),
        "run_batch_ovl[mixed span]": lambda: P.run_batch(
            cfg, b.na, b.carry0, b.xs_n, b.table, overlay=b.ovl),
        "run_batch_ovl[PreemptionChurn last drain]": lambda: P.run_batch(
            cfg, c.na, c.carry0, c.xs, c.table, overlay=c.ovl),
        "run_batch_groups[1,024 pods]": lambda: P.run_batch(
            cfg, g[0], gcarry, g[6], g[2], groups=g[3], fam=g[5]),
    }
    out = {name: dict(ms=cuda_ms(torch, fn, reps),
                      device_ms=device_ms(torch, fn, reps))
           for name, fn in runs.items()}
    na = b.na
    carry, _ = P.run_batch(cfg, na, b.carry0, b.xs, b.table)
    N = na.cap.shape[0]
    dom = (torch.arange(N, device=na.cap.device) % 16).to(torch.int32)
    part = na.valid[:, None] & (na.cap > 0)
    util = torch.where(part, P._f32_ratio(carry.used, na.cap),
                       torch.full_like(carry.used, -1, dtype=torch.float32))
    lib_ms = cuda_ms(torch, lambda: torch.sort(util, dim=0), 50)

    def probe():
        return P.cluster_probe(na, carry, dom, 16)
    out["cluster_probe"] = dict(ms=cuda_ms(torch, probe, 50),
                                device_ms=device_ms(torch, probe, 50),
                                library_ms=lib_ms)
    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=[device] * D)
        gna, gc, _ = sharded_state(S, mesh, na, carry)

        def sharded():
            return S.cluster_probe_sharded(mesh, gna, gc, dom, 16)
        out[f"cluster_probe_sharded[D={D}]"] = dict(
            ms=cuda_ms(torch, sharded, 50),
            device_ms=device_ms(torch, sharded, 50), library_ms=lib_ms)
    return out


def shard_times(torch, pkg, device, reps: int = 3) -> dict:
    """The mesh's two scans on D = 2 and 4 shards of one card beside their
    single-device yardsticks: timed ms (CUDA events) and device ms
    (torch.profiler) — row 14a on row 1's 1,024-pod mixed span (row 1
    beside it), row 14a's group mode on row 1g's 1,024-pod span (row 1g
    beside it), row 14e at CoLocatedInference's gang shape (B = 128, S =
    1, w_contig = 2, N = 8,192; row 13s beside it); and the mesh's closed
    forms the scans share the card with, rows 14c (SchedulingBasic's L =
    K = 8,192, J = 8) and 14f (GangTraining's L = K = 256, J = 8). A
    sharded scan is timed over one call (the host-driven chains take a
    quarter of a second and more); the rest over `reps`. Only the port's
    public entries are called, so an older checkout is timed the same way
    (`--times shard ROOT`)."""
    from kubernetes_tpu_torch.ops import gang as G
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    cfg = P.ScoreConfig()
    b = batch_span_inputs(torch, pkg, device)
    g = groups_span_inputs(pkg, device, 1024)
    gcarry = P.initial_carry(g[0], g[4])
    train = W.make_pod("train-proto").req({"cpu": "1", "memory": "1Gi"})\
        .workload("train").obj()
    na, table, carry, xs, wt, statics, dom = gang_scan_inputs(
        torch, pkg, device, [train], 128, 128, seed=128)
    ucfg, una, ucarry, ux, utable, L, K, J = sb_uniform_inputs(pkg, device)
    gna_u, gx_u, gtable_u, gK_u = gang_uniform_inputs(pkg, device,
                                                      lean=False)
    gcarry_u = P.initial_carry(gna_u)
    # the closed forms first: a process's later profiler sessions read
    # low (PERF.md §7), and the parent's scans are thousands of launches
    first, runs = [], [
        ("run_batch[mixed span]", reps, lambda: P.run_batch(
            cfg, b.na, b.carry0, b.xs, b.table)),
        ("run_batch_groups[1,024 pods]", reps, lambda: P.run_batch(
            cfg, g[0], gcarry, g[6], g[2], groups=g[3], fam=g[5])),
        ("run_gang[B = 128]", reps, lambda: G.run_gang(
            cfg, na, carry, xs, table, wt=wt, needed=128, dom=dom,
            statics=statics, w_contig=2))]
    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=[device] * D)
        n_local = na.cap.shape[0] // D
        bna, bc, _ = sharded_state(S, mesh, b.na, b.carry0)
        gna, gc0, ggd = sharded_state(S, mesh, g[0], gcarry, g[3])
        kna, kc, _ = sharded_state(S, mesh, na, carry)
        kdom = [dom[d * n_local:(d + 1) * n_local].contiguous()
                for d in range(D)]
        kst = S.wave_statics_sharded(mesh, kna, table, wt)
        una_s, uc_s, _ = sharded_state(S, mesh, una, ucarry)
        gna_s, gc_s, _ = sharded_state(S, mesh, gna_u, gcarry_u)
        first += [
            (f"run_uniform_sharded[L = K = 8,192, D={D}]", reps,
             lambda m=mesh, a=una_s, c=uc_s: S.run_uniform_sharded(
                 ucfg, m, a, c, ux, utable, BATCH, L, K, J)),
            (f"run_gang_uniform_sharded[L = K = 256, D={D}]", reps,
             lambda m=mesh, a=gna_s, c=gc_s: S.run_gang_sharded(
                 cfg, m, a, c, gx_u, gtable_u, needed=256, uniform=True,
                 n_actual=256, L=256, K=gK_u, J=8))]
        runs += [
            (f"run_batch_sharded[mixed span, D={D}]", 1,
             lambda m=mesh, a=bna, c=bc: S.run_batch_sharded(
                 cfg, m, a, c, b.xs, b.table)),
            (f"run_batch_sharded_groups[1,024 pods, D={D}]", 1,
             lambda m=mesh, a=gna, c=gc0, gg=ggd: S.run_batch_sharded(
                 cfg, m, a, c, g[6], g[2], groups=gg, fam=g[5])),
            (f"run_gang_sharded[B = 128, D={D}]", reps,
             lambda m=mesh, a=kna, c=kc, dm=kdom, st=kst: S.run_gang_sharded(
                 cfg, m, a, c, xs, table, wt=wt, needed=128, dom=dm,
                 statics=st, w_contig=2))]
    return {name: dict(ms=cuda_ms(torch, fn, n),
                       device_ms=device_ms(torch, fn, n))
            for name, n, fn in first + runs}


def gang_host_times(torch, pkg, device, reps: int = 50) -> dict:
    """Where row 14e's timed-over-device gap goes, at CoLocatedInference's
    gang shape (B = 128, S = 1, w_contig = 2, N = 8,192) on D = 2 and 4
    shards of one card: the host ms of one run_gang_sharded call issued
    back to back without a sync (`host_ms`), the timed ms over `reps`
    back-to-back calls and over 3 (shard_times' count), the device ms;
    beside them the host ms of the two copies the wrapper makes a call,
    the shards' GangNodesC table (`_nodes_dev`) and the slots' rows, both
    through pinned memory. This checkout only: it reads the wrapper's
    private helpers."""
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    K = pkg.kernels
    cfg = P.ScoreConfig()
    train = W.make_pod("train-proto").req({"cpu": "1", "memory": "1Gi"})\
        .workload("train").obj()
    na, table, carry, xs, wt, statics, dom = gang_scan_inputs(
        torch, pkg, device, [train], 128, 128, seed=128)
    dev = torch.device(device, 0) if ":" not in device else \
        torch.device(device)

    def host_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    rows = [int(u) for u in wt]
    out = {"slot rows to the card": dict(host_ms=host_ms(
        lambda: torch.tensor(rows, dtype=torch.int32).pin_memory().to(
            dev, non_blocking=True)))}
    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=[device] * D)
        n_local = na.cap.shape[0] // D
        kna, kc, _ = sharded_state(S, mesh, na, carry)
        kdom = [dom[d * n_local:(d + 1) * n_local].contiguous()
                for d in range(D)]
        kst = S.wave_statics_sharded(mesh, kna, table, wt)

        def call(m=mesh, a=kna, c=kc, dm=kdom, st=kst):
            return S.run_gang_sharded(cfg, m, a, c, xs, table, wt=wt,
                                      needed=128, dom=dm, statics=st,
                                      w_contig=2)
        nodes = (K.GangNodesC * D)()
        out[f"run_gang_sharded[B = 128, D={D}]"] = dict(
            host_ms=host_ms(call), ms=cuda_ms(torch, call, reps),
            ms_3=cuda_ms(torch, call, 3), device_ms=device_ms(torch, call,
                                                              reps))
        out[f"shard table to the card[D={D}]"] = dict(host_ms=host_ms(
            lambda n=nodes: K._nodes_dev(n, dev)))
    return out


class OverridesTimer:
    """While active, the host ms of each Evaluator._dry_run_overrides call
    (a preemptor's subset launch with its staging and its readback: the
    call ends once its rows are on the host), with the plan's device and
    the number of touched candidates. The class attribute is swapped, so
    every Evaluator of the process is timed."""

    def __init__(self):
        from kubernetes_tpu_torch.framework.preemption import Evaluator
        self.cls, self.orig, self.calls = (Evaluator,
                                           Evaluator._dry_run_overrides, [])
        # the arguments of the call with the most touched candidates
        self.largest = (None, None, {}, 0, None)

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def timed(ev, plan, ovl, R, ctx):
            t0 = time.perf_counter()
            out = orig(ev, plan, ovl, R, ctx)
            dev = getattr(plan.victim_req, "device", None)
            calls.append((getattr(dev, "type", None), len(ovl),
                          (time.perf_counter() - t0) * 1e3))
            if len(ovl) >= len(self.largest[2]):
                self.largest = (ev, plan, ovl, R, ctx)
            return out
        self.cls._dry_run_overrides = timed
        return self

    def __exit__(self, *exc):
        self.cls._dry_run_overrides = self.orig

    def replay(self, torch, reps: int = 50) -> dict:
        """The largest call again, `reps` times back to back on an idle
        stream: its host ms a call, and cProfile's heaviest functions
        (own seconds) over 20 calls, where its host time goes."""
        import cProfile
        import io
        import pstats
        ev, plan, ovl, R, ctx = self.largest
        if ev is None:
            return {}

        def call():
            return self.orig(ev, plan, ovl, R, ctx)
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(20):
            call()
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(14)
        top = [ln.strip() for ln in buf.getvalue().splitlines()
               if ln.strip() and ln.strip()[0].isdigit()]
        return {"touched": len(ovl), "host_ms": ms, "top_tottime_20": top}

    def summary(self, device_type: str = "cuda") -> dict:
        """The calls that launched (an overlay touched a candidate) on
        `device_type`: count, mean, median and largest ms, mean touched."""
        ms = sorted(m for d, n, m in self.calls if d == device_type and n)
        touched = [n for d, n, _m in self.calls if d == device_type and n]
        if not ms:
            return {"calls": 0}
        return {"calls": len(ms), "mean_ms": sum(ms) / len(ms),
                "p50_ms": ms[len(ms) // 2], "max_ms": ms[-1],
                "total_ms": sum(ms),
                "mean_touched": sum(touched) / len(touched)}


def gang_times(torch, pkg, device, reps: int = 5) -> dict:
    """Rows 13s, 12 and 14e at their main-path shapes, and the preemptor's
    host cost: timed ms (CUDA events) over `reps` and over 50 back-to-back
    calls, and device ms (torch.profiler) — row 13s at CoLocatedInference's
    gang (B = 128, S = 1, w_contig = 2, N = 8,192) and on the S = 4 gang of
    60 members in 64 slots; the gang grid at D = 1 (make_mesh of one
    shard) at the B = 128 gang, the cluster's yardstick on the same body;
    row 14e at D = 2 and 4 of one card; row 12 over every candidate (C =
    8,192, V = 1) and the preemptor's subset (199 touched candidates in
    256 positions), the subset by the checkout's own route; then
    PreemptionChurn on the card with every Evaluator._dry_run_overrides
    call timed (its staging, launch and readback). Only the port's public
    entries are called (and the Evaluator's own method), so an older
    checkout is timed the same way (`--times gang ROOT`)."""
    from kubernetes_tpu_torch.ops import gang as G
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    cfg = P.ScoreConfig()
    out = {}
    train = W.make_pod("train-proto").req({"cpu": "1", "memory": "1Gi"})\
        .workload("train").obj()
    mixed = [W.make_pod(f"mix-{k}").req({"cpu": c, "memory": mem})
             .workload("mix").obj()
             for k, (c, mem) in enumerate((("900m", "1Gi"), ("2", "4Gi"),
                                           ("250m", "512Mi"),
                                           ("4", "16Gi")))]

    def timed(fn, n=reps) -> dict:
        return dict(ms=cuda_ms(torch, fn, n), ms_50=cuda_ms(torch, fn, 50),
                    device_ms=device_ms(torch, fn, n))
    for case, protos, m, bucket, lean in (("S = 1, B = 128", [train], 128,
                                           128, False),
                                          ("S = 4, 60 in 64", mixed, 60, 64,
                                           True)):
        na, table, carry, xs, wt, statics, dom = gang_scan_inputs(
            torch, pkg, device, protos, m, bucket, lean=lean, seed=m)
        out[f"run_gang[{case}]"] = timed(lambda: G.run_gang(
            cfg, na, carry, xs, table, wt=wt, needed=m, dom=dom,
            statics=statics, w_contig=2))
        if case.startswith("S = 1"):
            for D in (1,) + MESH_SIZES:
                mesh = S.make_mesh(devices=[device] * D)
                n_local = na.cap.shape[0] // D
                kna, kc, _ = sharded_state(S, mesh, na, carry)
                kdom = [dom[d * n_local:(d + 1) * n_local].contiguous()
                        for d in range(D)]
                kst = S.wave_statics_sharded(mesh, kna, table, wt)
                out[f"run_gang_sharded[B = 128, D={D}]"] = timed(
                    lambda m_=mesh, a=kna, c=kc, dm=kdom, st=kst:
                    S.run_gang_sharded(cfg, m_, a, c, xs, table, wt=wt,
                                       needed=128, dom=dm, statics=st,
                                       w_contig=2))
        del na, table, carry, xs, statics, dom
    args, real, nom_vec = dry_inputs(torch, pkg, device, 8192, 1, False,
                                     seed=8193)
    out["dry_run[C = 8,192, V = 1]"] = timed(
        lambda: P.dry_run_select_victims(*args), 20)
    touched = np.sort(np.random.RandomState(29).choice(real, 199,
                                                       replace=False))
    run, _plain, gathered = dry_subset(torch, pkg, args, touched,
                                       np.tile(nom_vec, (199, 1)),
                                       np.ones((199,), np.int32))
    out["dry_run[subset, 199 in 256]"] = dict(
        timed(run, 20), route=("in place" if hasattr(
            P, "dry_run_select_victims_subset") else "gathered"),
        launch_on_gathered_ms=cuda_ms(
            torch, lambda: P.dry_run_select_victims(*gathered), 20))
    del args, gathered
    with OverridesTimer() as tm:
        run_pc = cell_run(device, pkg, "PreemptionChurn")
        torch.cuda.synchronize()
    out["_dry_run_overrides[PreemptionChurn]"] = dict(
        tm.summary("cuda"), pods_per_s=run_pc.rate)
    out["_dry_run_overrides[largest, replayed]"] = tm.replay(torch)
    return out


def wave_times(torch, pkg, device, reps: int = 5) -> dict:
    """Row 6 at its main-path shapes: timed ms (CUDA events over `reps`
    calls) and device ms (torch.profiler) of run_wave on
    TopologySpreading's first drain (B = 4,096, Lw = 512, K = 512, J = 8)
    and SchedulingPodAntiAffinity's (B = 2,048, Lw = 1,024, J = 1), with
    each run's packed stats (merge waves, conflict cuts, first prefix,
    serial steps), and ptxas of the kernel. Only the port's public entry
    is called, so an older checkout is timed the same way (`--times wave
    ROOT`)."""
    P = pkg.program
    out = {}
    for kind, label in (("spread", "TopologySpreading drain"),
                        ("anti", "SchedulingPodAntiAffinity drain")):
        args, B, shape = wave_inputs(torch, pkg, device, kind)
        cfg, na, carry, valid, table, u, gd, statics, K, J, Lw, fam, \
            norm_live, anti, merge = args

        def run():
            return P.run_wave(cfg, na, carry, valid, table, u, gd, statics,
                              K, J, fam, norm_live, anti_term=anti,
                              merge_on=merge, Lw=Lw)
        _kc, kp = run()
        stats = kp[B:].tolist()
        out[f"run_wave[{label}]"] = dict(
            ms=cuda_ms(torch, run, reps), device_ms=device_ms(torch, run,
                                                              reps),
            waves=stats[0], conflicts=stats[1], first_prefix=stats[2],
            serial_steps=stats[3], **shape)
        del args, _kc, kp
    out["ptxas"] = ptxas_report(pkg, "run_wave", "run_wave_kernel")
    return out


def host_ms(torch, fn, reps: int) -> float:
    """Host ms a call of `fn` issued back to back with no sync between
    (the enqueue; one sync after the loop, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def warm_cold(torch, run, trees, reps: int) -> dict:
    """`run(*trees)` timed warm (the same tree objects each call) and cold
    (a fresh NamedTuple, or a fresh Shards of fresh NamedTuples, of the
    same tensors each call: what a call sees after a scatter or a
    reseed): timed ms (CUDA events), host ms a call and device ms."""
    def fresh(t):
        if isinstance(t, tuple) and not hasattr(t, "_fields"):
            return type(t)([type(x)(*x) for x in t])
        return type(t)(*t)

    def warm():
        return run(*trees)

    def cold():
        return run(*(fresh(t) for t in trees))
    return dict(ms=cuda_ms(torch, warm, reps),
                host_ms=host_ms(torch, warm, reps),
                device_ms=device_ms(torch, warm, reps),
                cold_ms=cuda_ms(torch, cold, reps),
                cold_host_ms=host_ms(torch, cold, reps))


def ptxas_source(pkg, source: str) -> list:
    """ptxas's registers, stack frame and spill lines of every kernel of a
    source (this process's build), or ["not built here"]."""
    text = pkg.kernels.BUILD_INFO.get("ptxas", {}).get(source)
    if not text:
        return ["not built here"]
    return [ln.replace("ptxas info    :", "").strip()
            for ln in text.splitlines()
            if "Compiling entry" in ln or "registers" in ln
            or "stack frame" in ln]


def statics_times(torch, pkg, device, reps: int = 20) -> dict:
    """Row 5 at its main-path shapes, warm and cold (`warm_cold`): S = 1
    with each `feats` of tests/test_torch_wave.py test_wave_statics_equal
    on a full-width lean cluster (taints, selectors, images; the row
    holds images); S = 4 and S = 8 of MixedHighSignature's first drain
    (every family off, as SurfaceCache.get computes them); SurfaceCache.get
    on those eight rows all missing and all hit; wave_statics_sharded on
    make_mesh(2) / (4) of one card at S = 1 with every family on and at
    the S = 8 rows; ptxas of the source. Only the port's public entries
    are called, so an older checkout is timed the same way (`--times
    statics ROOT`)."""
    from kubernetes_tpu_torch.compiler.surfaces import SurfaceCache
    P, S, W = pkg.program, pkg.sharding, pkg.wrappers
    out = {}
    nodes = lean_cluster(np.random.RandomState(31), SB_NODES, W)
    pods = lean_pods(np.random.RandomState(32), 16, W, "ws", ports=False)
    na, batch, table = staged(nodes, (), pods, device, pkg)
    img = [int(t) for t in batch.tidx[:16]
           if int(table.img_containers[int(t)]) > 0]
    u = img[0] if img else int(batch.tidx[0])
    for feats in ((True, True, True), (False, True, False),
                  (True, False, True), (False, False, False)):
        out[f"wave_statics[S=1, feats={feats}]"] = warm_cold(
            torch, lambda n, f=feats: P.wave_statics(n, table, [u], f),
            (na,), reps)
    n_nodes, n_init, _n_meas, zones, _cyc = MHS_SHAPE
    mnodes = harness_nodes(W, n_nodes, zones)
    mbound = [W.make_pod(f"init-{i}").req({"cpu": "900m", "memory": "1Gi"})
              .label("app", "mix").node(f"node-{i}").obj()
              for i in range(n_init)]
    mpods = [mhs_pod(W, f"pod-{n_init + i}", n_init + i) for i in range(64)]
    mna, mbatch, mtable, _gd, _gc, _fam, builder, state = group_staged(
        pkg, device, mnodes, mbound, mpods)
    wt = list(dict.fromkeys(int(t) for t in mbatch.tidx[:64]))
    off = (False, False, False)
    for s in (4, 8):
        out[f"wave_statics[S={s}, MHS rows]"] = warm_cold(
            torch, lambda n, s=s: P.wave_statics(n, mtable, wt[:s], off),
            (mna,), reps)
    surf = SurfaceCache(state, builder)

    def missing():
        surf.invalidate()
        return surf.get(mna, mtable, tuple(wt))
    out["SurfaceCache.get[8 rows missing]"] = dict(
        ms=cuda_ms(torch, missing, reps), host_ms=host_ms(torch, missing,
                                                          reps))
    surf.get(mna, mtable, tuple(wt))
    out["SurfaceCache.get[8 rows hit]"] = dict(
        ms=cuda_ms(torch, lambda: surf.get(mna, mtable, tuple(wt)), reps),
        host_ms=host_ms(torch, lambda: surf.get(mna, mtable, tuple(wt)),
                        reps))
    for D in MESH_SIZES:
        mesh = S.make_mesh(devices=[device] * D)
        gna = S.shard_node_arrays(mesh, na)
        gmna = S.shard_node_arrays(mesh, mna)
        out[f"wave_statics_sharded[D={D}, S=1, feats=all]"] = warm_cold(
            torch, lambda g, m=mesh: S.wave_statics_sharded(
                m, g, table, [u], (True, True, True)), (gna,), reps)
        out[f"wave_statics_sharded[D={D}, S=8, MHS rows]"] = warm_cold(
            torch, lambda g, m=mesh: S.wave_statics_sharded(
                m, g, mtable, wt[:8], off), (gmna,), reps)
    out["ptxas"] = ptxas_source(pkg, "wave_statics")
    return out


def diag_times(torch, pkg, device, reps: int = 20) -> dict:
    """Row 8 at N = 8,192, warm and cold (`warm_cold`): a lean row of the
    mixed cluster and a group row (zone spread with skew) of the harness
    cluster, as phase 3 builds them; then a failed drain's mask diagnosis
    in phase 5's mixed workload: sixteen pods of eight signatures no node
    fits, diagnosed as the commit does (`Scheduler._device_fit_error` a
    failure, one diagnosis cache for the drain holding its failures):
    host ms a drain with the readbacks (median and least of 50 drains),
    and the diagnose_row launches it made. Only the port's public entries
    and the scheduler's commit-time method are called, so an older
    checkout is timed the same way (`--times diag ROOT`)."""
    P, W, K = pkg.program, pkg.wrappers, pkg.kernels
    out = {}
    nodes = lean_cluster(np.random.RandomState(71), SB_NODES, W)
    bound = [W.make_pod(f"b{i}").req({"cpu": "6", "memory": "8Gi"})
             .host_port(8080).node(f"node-{7 * i % SB_NODES}").obj()
             for i in range(1500)]
    lean = lean_pods(np.random.RandomState(72), 16, W, "diag")
    lean.append(W.make_pod("huge").req({"cpu": "100"}).obj())
    na, batch, table = staged(nodes, bound, lean, device, pkg)
    u0 = sorted(set(int(t) for t in batch.tidx[:len(lean)]))[-1]
    out["diagnose_row[lean]"] = warm_cold(
        torch, lambda n: P.diagnose_row(n, table, u0), (na,), reps)
    gnodes = harness_nodes(W, SB_NODES, 16)
    gbound = [W.make_pod(f"s{i}").req({"cpu": "900m", "memory": "1Gi"})
              .label("app", "mix").node(f"node-{i % 8}").obj()
              for i in range(160)]
    gna, gbatch, gtable, gd, gc, fam, _b, _s = group_staged(
        pkg, device, gnodes, gbound, [mhs_pod(W, "m0", 0)])
    g0 = int(gbatch.tidx[0])
    out["diagnose_row[group]"] = warm_cold(
        torch, lambda n: P.diagnose_row(n, gtable, g0, gd=gd, gc=gc,
                                        fam=fam), (gna,), reps)
    api, sched = mixed_workload(device, pkg)
    fails = []
    for k in range(8):
        for j in range(2):
            w = W.make_pod(f"nofit-{k}-{j}")
            w = (w.req({"cpu": f"{900 + k}"}) if k < 4 else
                 w.req({"cpu": f"{k}"}).node_selector({"disk": "nvme"}))
            fails.append(w.obj())
    api.create_pods(fails)
    sched.schedule_pending()
    torch.cuda.synchronize()
    uids = {p.uid for p in fails}
    qpis = [q for uid, q in sched.queue.unschedulable_pods.items()
            if uid in uids]
    if len(qpis) != len(fails):
        fail(f"--times diag: {len(qpis)} of {len(fails)} pods failed")
    profile = next(iter(sched.profiles.values()))

    def diagnose_drain():
        cache = {"_failures": list(qpis)}
        return [sched._device_fit_error(q, profile, cache) for q in qpis]
    K.reset_launches()
    diagnose_drain()
    torch.cuda.synchronize()
    launches = K.LAUNCHES["diagnose_row"]
    t_host = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diagnose_drain()
        t_host.append((time.perf_counter() - t0) * 1e3)
    out["_mask_diagnosis[phase 5, 16 failures, 8 signatures]"] = dict(
        host_ms=float(np.median(t_host)), host_ms_min=min(t_host),
        launches_a_drain=launches, failures=len(qpis),
        signatures=len({pkg.BatchBuilder._sig_key(q.pod) for q in qpis}))
    out["ptxas"] = ptxas_source(pkg, "diagnose_row")
    return out


class CallTimes:
    """Wall seconds of wrapped calls by name, each call kept with its
    start so that a measured window can be cut out afterwards. A wrapper
    costs two perf_counter reads and an append a call."""

    def __init__(self):
        self.calls: dict = {}

    def wrap(self, name: str, fn, when=None):
        calls = self.calls.setdefault(name, [])
        clock = time.perf_counter

        def timed(*a, **kw):
            if when is not None and not when():
                return fn(*a, **kw)
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                calls.append((t0, clock() - t0))
        return timed

    def ms(self, name: str, t0: float, t1: float) -> float:
        return 1e3 * sum(dt for start, dt in self.calls.get(name, ())
                         if t0 <= start <= t1)

    def count(self, name: str, t0: float, t1: float) -> int:
        return sum(1 for start, _dt in self.calls.get(name, ())
                   if t0 <= start <= t1)


INGEST_CELLS = ("SchedulingBasic", "MixedHighSignature", "PreemptionChurn")


def ingest_times(torch, pkg, device) -> dict:
    """`--times ingest`: SchedulingBasic, MixedHighSignature and
    PreemptionChurn at full width, each with the ColumnarIngest gate off
    / on / on / off, in one process. Each run: pods/s, window ms,
    `host_split`'s shares, and inside the measured window the split of
    pod creation (PodFactory.make, the harness's pod build, against
    APIServer.create_pods: the watch fan-out and the queue adds), of the
    bind echo (APIServer.bind_all, and inside it the pod handlers'
    fan-out, and the pods the bulk echo handed to the per-pod path) and
    of the commit (the classify-and-assume pass:
    CommitEngine.commit or Scheduler._serial_commit less
    APIDispatcher.add_binds, beside add_binds). The calls are wrapped
    from outside; the package has no span for them."""
    from kubernetes_tpu_torch.perf import harness
    out: dict = {}
    for name in INGEST_CELLS:
        runs = []
        for columnar in (False, True, True, False):
            t = CallTimes()
            in_bind = [0]

            def wrap(api, sched, t=t, in_bind=in_bind):
                api.create_pods = t.wrap("create_pods", api.create_pods)
                bind_all = api.bind_all

                def binding(*a, **kw):
                    in_bind[0] += 1
                    try:
                        return bind_all(*a, **kw)
                    finally:
                        in_bind[0] -= 1
                api.bind_all = t.wrap("bind_all", binding)
                for h in api.pod_handlers:
                    for f in ("on_update", "on_update_bulk"):
                        if getattr(h, f) is not None:
                            setattr(h, f, t.wrap("bind_echo", getattr(h, f),
                                                 when=lambda: in_bind[0]))
                # the pods the bulk echo hands to the per-pod path (the
                # registered per-pod handler is bound before this wrap)
                sched._on_pod_update = t.wrap(
                    "echo_per_pod", sched._on_pod_update,
                    when=lambda: in_bind[0])
                if sched.commit_engine is not None:
                    sched.commit_engine.commit = t.wrap(
                        "commit", sched.commit_engine.commit)
                else:
                    sched._serial_commit = t.wrap("commit",
                                                  sched._serial_commit)
                sched.dispatcher.add_binds = t.wrap(
                    "add_binds", sched.dispatcher.add_binds)
            make = harness.PodFactory.make
            harness.PodFactory.make = t.wrap("pod_build", make)
            try:
                run = cell_run(device, pkg, name, wrap=wrap,
                               gates={"ColumnarIngest": columnar})
            finally:
                harness.PodFactory.make = make
            torch.cuda.synchronize()
            t0 = run.item.start
            t1 = t0 + run.item.duration_s
            split = {k: t.ms(k, t0, t1) for k in (
                "pod_build", "create_pods", "bind_all", "bind_echo",
                "commit", "add_binds")}
            split["classify_assume"] = split["commit"] - split["add_binds"]
            hs = host_split(run)
            runs.append({
                "columnar_ingest": columnar, "pods_per_s": run.rate,
                "window_ms": 1e3 * run.item.duration_s,
                "share": hs["share"], "commit_s": hs["commit_s"],
                "split_ms": split,
                "calls": {k: t.count(k, t0, t1) for k in (
                    "pod_build", "create_pods", "bind_all", "bind_echo",
                    "echo_per_pod", "commit")},
                "counts": [run.sched.scheduled_count,
                           run.sched.unschedulable_count],
                "outcome_digest": hashlib.sha1(json.dumps(
                    outcome(run.api, run.sched),
                    sort_keys=True).encode()).hexdigest()})
            del run
        if len({r["outcome_digest"] for r in runs}) != 1:
            fail(f"--times ingest {name}: the bind maps of the four runs "
                 "differ")
        out[name] = runs
    return out


TIMES = {"batch": batch_times, "closed_form": closed_form_times,
         "diag": diag_times, "gang": gang_times,
         "gang_host": gang_host_times, "ingest": ingest_times,
         "plan": plan_times, "shard": shard_times,
         "statics": statics_times, "wave": wave_times}


def times_main(torch, group: str, root: str, smi: str) -> int:
    """`--times GROUP ROOT`: one group of kernel rows (batch: 1, 1o, 1g,
    11, 14h; closed_form: 2, 2o, 13u; plan: 7, 14d; shard: 14a, 14a
    group, 14e beside 1, 1g, 13s; gang: 13s, the gang grid at D = 1, 14e,
    12 and the preemptor's _dry_run_overrides; gang_host: 14e's host
    time; wave: 6; statics: 5 and its per-shard form; diag: 8 and a
    failed drain's diagnosis) of the
    port in checkout ROOT, its kernels built under ROOT/build, as one
    JSON line. Two checkouts compare on one card
    in one call: run each in its own process, in turns (parent, change,
    change, parent)."""
    pkg = _Pkg()
    if not os.path.abspath(pkg.kernels.__file__).startswith(root + os.sep):
        print(f"chip_smoke: the port came from {pkg.kernels.__file__}, not "
              f"{root}", file=sys.stderr)
        return 2
    pkg.kernels.build()
    print(json.dumps({"root": root, "group": group, "nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0),
                      "rows": TIMES[group](torch, pkg, "cuda")}))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", choices=sorted(TIMES), metavar="GROUP",
                    help="only time one group of kernels (batch, "
                    "closed_form, diag, gang, gang_host, plan, shard, "
                    "statics, wave), or the ingest and commit edges "
                    "(ingest), of the port in checkout ROOT")
    ap.add_argument("root", nargs="?", default=HERE, metavar="ROOT",
                    help="the checkout --times imports (default: this one)")
    args = ap.parse_args(argv)
    if not args.times and args.root != HERE:
        ap.error("ROOT names the checkout a group is timed in: it needs "
                 "--times")
    root = os.path.abspath(args.root)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(root, "kubernetes_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              f"kubernetes_tpu_torch/ in {root})", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    device = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.times:
        return times_main(torch, args.times, root, smi)
    log("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)

    pkg = _Pkg()
    last = [time.perf_counter()]

    def mark(phase: str) -> None:
        # the seconds each phase took, on its own line
        now = time.perf_counter()
        log("phase_seconds", of=phase, seconds=now - last[0])
        last[0] = now

    t0 = time.perf_counter()
    pkg.kernels.build()
    info = pkg.kernels.BUILD_INFO
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in info.get("ptxas", {}).items()}
    log("build", seconds=time.perf_counter() - t0, built=info.get("built"),
        ptxas=ptxas)
    mark("build")
    rows: list = []
    check_run_batch(torch, pkg, device, rows)
    check_run_batch_edges(torch, pkg, device)
    check_run_batch_churn(torch, pkg, device)
    check_run_uniform(torch, pkg, device, rows)
    check_scatter_rows(torch, pkg, device, rows)
    time_initial_carry(torch, pkg, device)
    check_wave_statics(torch, pkg, device, rows)
    check_run_wave(torch, pkg, device, rows)
    check_run_wave_edges(torch, pkg, device)
    check_run_batch_groups(torch, pkg, device, rows)
    check_run_plan(torch, pkg, device, rows)
    check_diagnose_row(torch, pkg, device, rows)
    check_dry_run(torch, pkg, device, rows)
    check_run_gang_uniform(torch, pkg, device, rows)
    check_run_gang(torch, pkg, device, rows)

    check_explain_row(torch, pkg, device, rows)
    mark("3 (single-device kernels)")

    # phase 4: SchedulingBasic on the card — the counts cover exactly this
    # run (the comparisons above do not count); then the probe kernel
    # against its plain version on this run's own post-drain carry
    sb_counts, sb_run = basic_phase(torch, pkg, device, smi)
    mark("4")
    check_cluster_probe(torch, pkg, sb_run.sched, rows)
    check_score_probe(torch, pkg, sb_run.sched, rows)
    # phase 3 on the mesh, on the same post-drain state; then the mesh's
    # group and gang programs
    check_mesh_kernels(torch, pkg, sb_run.sched, rows)
    mark("3 (probes, lean mesh kernels)")
    check_mesh_group_kernels(torch, pkg, device, rows)
    mark("3 (mesh group and gang kernels)")
    sb_probe = probe_state(sb_run.sched)
    del sb_run

    # phase 5: the mixed lean workload (plan and scan spans, rewinds,
    # diagnosis)
    pkg.kernels.reset_launches()
    api, sched = mixed_workload(device, pkg)
    torch.cuda.synchronize()
    mixed_counts = dict(pkg.kernels.LAUNCHES)
    got = outcome(api, sched)
    for k in ("run_batch", "run_uniform", "run_plan", "diagnose_row"):
        if mixed_counts[k] <= 0:
            fail(f"mixed workload launches {mixed_counts}: {k} never ran")
    if not got[1]:
        fail("mixed workload: expected unschedulable pods to stay pending")
    if sched.reconcile() != []:
        fail("mixed workload: device carry diverges from the host cache")
    api_c, sched_c = mixed_workload("cpu", pkg)
    if got != outcome(api_c, sched_c):
        fail("mixed workload: cuda bind map differs from the cpu run")
    # how the node arrays reached the device: whole, or dirty rows through
    # scatter_rows (the cpu run's counts beside the card's)
    uploads = {k: (getattr(sched.state, k), getattr(sched_c.state, k))
               for k in ("full_uploads_total", "rows_scattered_total")}
    log("mixed", bound=len(got[0]), pending=len(got[1]),
        launches=mixed_counts, uniform_rewinds=sched.uniform_rewinds,
        plan_runs=sched.plan_runs, wave_stats=wave_stats(sched),
        uploads_cuda_cpu=uploads,
        preemption_attempts=sched.preemption_attempts,
        bind_map_equals_cpu=True)
    mark("5")

    # phases 6 and 7: the two group workloads at full width
    spread_counts = group_phase(torch, pkg, device, "spread", smi)
    anti_counts = group_phase(torch, pkg, device, "anti", smi)
    mark("6, 7")

    # phase 8: the mixed group workload (run_batch's group mode, the
    # serial and renormalizing wave tiers)
    pkg.kernels.reset_launches()
    api, sched = mixed_group_workload(device, pkg)
    torch.cuda.synchronize()
    mg_counts = dict(pkg.kernels.LAUNCHES)
    got = outcome(api, sched)
    for k in ("run_batch_groups", "run_wave", "run_plan", "diagnose_row"):
        if mg_counts[k] <= 0:
            fail(f"mixed group workload launches {mg_counts}: {k} never "
                 "ran")
    if sched.reconcile() != []:
        fail("mixed group workload: device carry diverges from the host "
             "cache")
    if got != outcome(*mixed_group_workload("cpu", pkg)):
        fail("mixed group workload: cuda bind map differs from the cpu run")
    log("mixed_groups", bound=len(got[0]), pending=len(got[1]),
        launches=mg_counts, wave_runs=sched.wave_runs,
        plan_runs=sched.plan_runs, wave_stats=wave_stats(sched),
        bind_map_equals_cpu=True)
    mark("8")

    # phases 9 and 10: the plan program's workloads at full width
    mhs_counts = plan_phase(torch, pkg, device, "mhs", smi)
    mbp_counts = plan_phase(torch, pkg, device, "mbp", smi)
    mark("9, 10")

    # phase 11: PreemptionChurn (the dry run, the overlay variants)
    pc_counts = preemption_phase(torch, pkg, device, smi)
    mark("11")

    # phases 12 and 13: the gang workloads (run_gang's two tiers)
    gt_counts = gang_phase(torch, pkg, device, "train", smi)
    ci_counts = gang_phase(torch, pkg, device, "colo", smi)
    mark("12, 13")

    # phase 14: SchedulingNodeAffinity; phase 15: gang rejection on both
    # tiers and a gang that preempts a gang
    sna_counts = node_affinity_phase(torch, pkg, device, smi)
    gr_counts = gang_reject_phase(torch, pkg, device, smi)
    mark("14, 15")

    # phase 16: the sanitizer rails on six cells at full width
    rails_counts = rails_phase(torch, pkg, device, smi)
    mark("16")

    # phase 17: the node-sharded mesh (SchedulingBasic on two meshes, the
    # beyond-lattice check)
    mesh_counts = mesh_phase(torch, pkg, smi, sb_probe)
    mark("17")

    # phase 18: the mesh's group and gang paths (six cells on
    # make_mesh(2), two on make_mesh(4), the beyond-lattice group drains,
    # a gang rejected on each tier)
    mesh_group_counts = mesh_group_phase(torch, pkg, smi)
    mark("18")

    # phase 19: the ColumnarIngest gate off on four cells, each held to
    # its gate-on card run
    gate_off_counts = gate_off_phase(torch, pkg, device, smi)
    mark("19")

    # `launches` sums the main-path runs, each counted from 0;
    # `launches_by_path` keeps them apart
    paths = {"scheduling_basic": sb_counts, "mixed": mixed_counts,
             "topology_spreading": spread_counts,
             "pod_anti_affinity": anti_counts, "mixed_groups": mg_counts,
             "mixed_high_signature": mhs_counts,
             "mixed_base_pod": mbp_counts, "preemption_churn": pc_counts,
             "gang_training": gt_counts, "colocated_inference": ci_counts,
             "node_affinity": sna_counts, "gang_reject_preempt": gr_counts,
             "sanitizer_rails": rails_counts, **mesh_counts,
             **mesh_group_counts, "columnar_ingest_off": gate_off_counts}
    for row in rows:
        by_path = {k: c[row["name"]] for k, c in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["launches"] <= 0:
            fail(f"{row['name']}: never launched on the main path")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
