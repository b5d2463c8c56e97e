"""Build, load and launch the hand-written CUDA kernels (csrc/).

Each `csrc/*.cu` source builds with its own `nvcc` process (all started
together) into a shared library with a plain C interface, loaded with
`ctypes`. The build happens at first use, into `<repo>/build/kernels/`,
keyed by a hash of every source and the flags, so a fresh checkout builds
everything on the first kernel call and a second process reuses the
libraries. `--fmad=false` keeps nvcc from contracting multiply-adds into
FMAs, which could move a BalancedAllocation floor across an integer.

The wrappers check device, dtype, shape and contiguity, launch on
PyTorch's current stream, raise if `cudaGetLastError()` reports a launch
failure, and count their launches in `LAUNCHES`. They never fall back to
the plain versions: a CUDA tensor either runs the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]
SOURCES = ("run_batch", "run_uniform", "scatter_rows", "wave_statics",
           "run_wave", "run_plan", "diagnose_row", "dry_run", "run_gang",
           "cluster_probe", "explain_row", "score_probe",
           "run_batch_sharded", "run_uniform_sharded", "run_plan_sharded",
           "run_gang_sharded")

# launches per wrapper since the last reset (one per kernel-wrapper call);
# run_batch counts its lean mode, its group mode and its overlay variant
# under three keys, run_uniform its lean and its overlay variant under
# two; run_gang counts its scan tier, and its closed-form tier (built in
# run_uniform.cu) counts under run_gang_uniform; the mesh's programs
# count once per sharded call (their launches on every shard), the scatter
# and the probe on the mesh under their own keys, run_batch_sharded's
# group mode under run_batch_sharded_groups, the per-shard statics under
# wave_statics_sharded and the mesh's closed-form gang tier (built in
# run_uniform_sharded.cu) under run_gang_uniform_sharded
LAUNCHES = {name: 0 for name in SOURCES + ("run_batch_groups",
                                           "run_batch_ovl",
                                           "run_uniform_ovl",
                                           "run_gang_uniform",
                                           "scatter_rows_sharded",
                                           "cluster_probe_sharded",
                                           "run_batch_sharded_groups",
                                           "wave_statics_sharded",
                                           "run_gang_uniform_sharded")}

# CUDA kernel launches the scans' wrappers issued (LAUNCHES counts wrapper
# calls): run_plan one a span, run_gang's scan tier one a gang;
# run_plan_sharded and run_batch_sharded (both modes) one a span, and
# run_gang_sharded's scan tier one a gang, and wave_statics_sharded one a
# call, on a mesh whose shards share a card, their chains of launches a
# shard otherwise
RAW_LAUNCHES = {"run_plan": 0, "run_gang": 0, "run_plan_sharded": 0,
                "run_batch_sharded": 0, "run_gang_sharded": 0,
                "wave_statics_sharded": 0}

_LIBS: dict = {}
BUILD_INFO: dict = {}
# fresh nvcc builds plus library loads per source in this process (the
# sanitizer rails' retrace budget; a warm process adds none)
BUILDS = {name: 0 for name in SOURCES}

MAX_C = 8      # csrc/lean_eval.cuh KT_MAX_C
MAX_IC = 16    # csrc/lean_eval.cuh KT_MAX_IC
MAX_SC = 8     # csrc/group_eval.cuh KT_MAX_SC
MAX_SCATTER_FIELDS = 24   # csrc/scatter_rows.cu KT_SCATTER_MAX_FIELDS
MAX_WAVE_ROWS = 64        # csrc/wave_statics.cu KT_WS_MAX_S
WS_MAX_SHARDS = 4         # csrc/wave_statics.cu KT_WS_MAX_SHARDS
WS_CLUSTER = 16           # csrc/wave_statics.cu KT_WS_CLUSTER (CTAs)
MAX_DIAG_ROWS = 64        # csrc/diagnose_row.cu KT_DIAG_MAX_S
DIAG_CLUSTER = 16         # csrc/diagnose_row.cu KT_DIAG_CLUSTER (CTAs)
MAX_PLAN_SLOTS = 32       # csrc/plan_span.cuh KT_PLAN_MAX_S
PLAN_CLUSTER = 16         # csrc/run_plan.cu KT_PLAN_CLUSTER (CTAs)
BATCH_CLUSTER = 16        # csrc/run_batch.cu KT_BATCH_CLUSTER (CTAs)
GANG_CLUSTER = 16         # csrc/run_gang.cu KT_GANG_CLUSTER (CTAs)
WAVE_CLUSTER = 16         # csrc/run_wave.cu KT_WAVE_CLUSTER (CTAs)
MAX_WAVE_L = 1024         # csrc/run_wave.cu KT_WAVE_MAX_L (K and Lw)
WAVE_HASH = 2048          # csrc/run_wave.cu KT_WAVE_HASH
# a CTA's dynamic shared memory the wrappers allow (of the H100's 227 KB a
# block; the static PlanShared takes the rest)
MAX_DYN_SMEM = 200 * 1024
MAX_DRY_R = 64            # csrc/dry_run.cu KT_DRY_MAX_R
MAX_DRY_V = 128           # victim slots (Evaluator.MAX_BATCHED_VICTIMS)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in RAW_LAUNCHES:
        RAW_LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                           "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every source not yet built for the current hash (one nvcc
    per source, in parallel) and load the libraries. Returns
    {name: ctypes.CDLL}; BUILD_INFO records the wall seconds and the ptxas
    report."""
    if _LIBS:
        return _LIBS
    tag = _source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = BUILD_DIR / f"lib{name}_{tag}.so"
        if lib.exists():
            continue
        tmp = BUILD_DIR / f"lib{name}_{tag}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    report = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        report[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
        BUILDS[name] += 1
    BUILD_INFO.update(seconds=time.perf_counter() - t0, tag=tag,
                      built=sorted(procs), ptxas=report)
    for name in SOURCES:
        _LIBS[name] = _bind(name, ctypes.CDLL(
            str(BUILD_DIR / f"lib{name}_{tag}.so")))
        BUILDS[name] += 1
    return _LIBS


# ---------------------------------------------------------------------------
# argument structs (csrc/lean_eval.cuh)

_P = ctypes.c_void_p
_I = ctypes.c_int32


class NodeC(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "cap", "allowed_pods", "valid", "unschedulable", "name_id",
        "taint_key", "taint_val", "taint_eff", "label_key", "label_kv",
        "label_num", "image_id", "image_size")] + [
        (f, _I) for f in ("N", "R", "T", "Lb", "I")]


_CACHE_FIELDS = ("sig", "static_mask", "taint_raw", "na_raw", "s_img",
                 "fit_ok", "s_fit", "s_bal")


class CacheC(ctypes.Structure):
    _fields_ = [(f, _P) for f in _CACHE_FIELDS]


class CarryC(ctypes.Structure):
    _fields_ = [("used", _P), ("nonzero_used", _P), ("npods", _P),
                ("ports", _P), ("P", _I), ("cache", CacheC)]


_TABLE_PTRS = (
    "req", "nonzero_req", "node_name_id", "tol_key", "tol_val", "tol_eff",
    "tol_op", "tolerates_unsched", "ns_sel_val", "aff_has", "aff_term_valid",
    "aff_key", "aff_op", "aff_num", "aff_val", "pref_weight", "pref_key",
    "pref_op", "pref_num", "pref_val", "port_ids", "skip_balanced",
    "img_ids", "img_containers")


class TableC(ctypes.Structure):
    _fields_ = [(f, _P) for f in _TABLE_PTRS] + [
        (f, _I) for f in ("U", "R", "TT", "Q", "TM", "V", "PT", "PP", "IC")]


class CfgC(ctypes.Structure):
    _fields_ = [("C", _I), ("score_cols", _I * MAX_C),
                ("col_weights", ctypes.c_int64 * MAX_C),
                ("col_nonzero", _I * MAX_C), ("nonzero_slot", _I * MAX_C),
                ("w_fit", ctypes.c_int64), ("w_balanced", ctypes.c_int64),
                ("w_taint", ctypes.c_int64),
                ("w_node_affinity", ctypes.c_int64),
                ("w_image", ctypes.c_int64), ("most_allocated", _I)]


_GROUPS_FIELDS = (
    "spr_f_active", "spr_f_max_skew", "spr_f_self", "spr_f_tv",
    "spr_f_elig", "spr_f_dom", "spr_s_active", "spr_s_max_skew",
    "spr_s_is_host", "spr_s_tv", "spr_s_elig", "spr_s_keys_ok", "spr_s_dom",
    "ipa_ra_active", "ipa_ra_tv", "ipa_ra_dom", "ipa_raa_active",
    "ipa_raa_tv", "ipa_raa_dom", "ipa_self_all", "ipa_stc_tv",
    "ipa_stc_dom", "ipa_stp_tv", "ipa_stp_dom", "m_spr_f", "m_spr_s",
    "m_ipa_a", "m_ipa_aa", "m_ipa_exist", "w_stc", "w_stp")
_GCARRY_FIELDS = ("spr_f_cnt", "spr_f_min_zero", "spr_s_cnt", "ipa_veto",
                  "ipa_a_cnt", "ipa_a_total", "ipa_aa_cnt", "ipa_score")


class GroupsC(ctypes.Structure):
    _fields_ = [(f, _P) for f in _GROUPS_FIELDS] + [
        (f, _I) for f in ("U", "SC", "TA", "TAA", "CT", "PT", "N")]


class GCarryC(ctypes.Structure):
    _fields_ = [(f, _P) for f in _GCARRY_FIELDS]


class FamC(ctypes.Structure):
    _fields_ = [(f, _I) for f in ("spr_f", "spr_s", "ipa_req", "ipa_anti",
                                  "ipa_score")]


class StaticsShardC(ctypes.Structure):
    """csrc/wave_statics.cu StaticsShard: one node shard and its four
    [S, rows] outputs."""
    _fields_ = [("na", NodeC)] + [(f, _P) for f in (
        "mask", "taint_raw", "na_raw", "s_img")]


class StaticsArgsC(ctypes.Structure):
    """csrc/wave_statics.cu StaticsArgs: the shard table, the rows, the
    family flags and the image counts' two chain modes."""
    _fields_ = ([("s", StaticsShardC * WS_MAX_SHARDS), ("D", _I), ("N", _I),
                 ("tb", TableC), ("wt", _I * MAX_WAVE_ROWS)]
                + [(f, _I) for f in ("S", "has_taints", "has_sel",
                                     "has_img")]
                + [("cnt_in", _P), ("cnt_out", _P)])


class ScatterField(ctypes.Structure):
    _fields_ = [("dst", _P), ("base", _P), ("rows", _P),
                ("row_units", ctypes.c_int64), ("unit_bytes", _I),
                ("pad", _I)]


class ScatterC(ctypes.Structure):
    _fields_ = [("f", ScatterField * MAX_SCATTER_FIELDS), ("nf", _I),
                ("N", _I), ("D", _I)]


_WAVE_SCRATCH = ("f_cnt", "veto", "aa_cnt", "cnt_n", "cnt_add", "dshare",
                 "elig_dom", "flags", "gmask", "masked", "champ", "fseg",
                 "keys1")


class WaveArgsC(ctypes.Structure):
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cfg", CfgC),
                 ("g", GroupsC), ("gin", GCarryC), ("gout", GCarryC),
                 ("fam", FamC)]
                + [(f, _P) for f in ("used", "nonzero_used", "npods", "m0",
                                     "taint_raw", "na_raw", "s_img",
                                     "valid")]
                + [(f, _I) for f in ("wt", "B", "K", "J", "Lw", "norm_live",
                                     "anti_term", "merge_on")]
                + [("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64)]
                + [(f, _P) for f in _WAVE_SCRATCH + ("packed",)])


class BatchSpanC(ctypes.Structure):
    """csrc/batch_span.cuh BatchSpanC: what every node shard shares."""
    _fields_ = ([("tb", TableC), ("cfg", CfgC), ("fam", FamC),
                 ("has_groups", _I), ("w_spread", ctypes.c_int64),
                 ("w_ipa", ctypes.c_int64)]
                + [(f, _P) for f in ("flags", "ovl_used", "ovl_npods",
                                     "nom_idx", "valid", "sig", "tidx")]
                + [(f, _I) for f in ("B", "n_global", "n_local", "D")]
                + [("part", _P), ("out", _P)])


class BatchNodesC(ctypes.Structure):
    """csrc/batch_span.cuh BatchNodesC: one node shard's arrays."""
    _fields_ = [("na", NodeC), ("c", CarryC), ("g", GroupsC),
                ("gc", GCarryC), ("offset", _I)]


class BatchArgsC(ctypes.Structure):
    """csrc/run_batch.cu BatchArgs: the span and its one shard."""
    _fields_ = [("cm", BatchSpanC), ("nodes", BatchNodesC)]


class PlanSpanC(ctypes.Structure):
    """csrc/plan_span.cuh PlanSpanC: what every node shard shares."""
    _fields_ = ([("tb", TableC), ("cfg", CfgC), ("fam", FamC),
                 ("valid", _P), ("widx", _P),
                 ("wt", _I * MAX_PLAN_SLOTS)]
                + [(f, _I) for f in ("S", "W", "P", "norm_live",
                                     "has_groups", "has_ports")]
                + [("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64)]
                + [(f, _I) for f in ("n_global", "n_local", "D")]
                + [(f, _P) for f in ("flags", "part", "packed")])


_PLAN_NODE_PTRS = ("used", "nonzero_used", "npods", "ports", "m0",
                   "taint_raw", "na_raw", "s_img", "fit_ok", "s_fit",
                   "s_bal")


class PlanNodesC(ctypes.Structure):
    """csrc/plan_span.cuh PlanNodesC: one node shard's arrays."""
    _fields_ = ([("na", NodeC), ("g", GroupsC), ("gc", GCarryC)]
                + [(f, _P) for f in _PLAN_NODE_PTRS] + [("offset", _I)])


class PlanArgsC(ctypes.Structure):
    """csrc/run_plan.cu PlanArgs."""
    _fields_ = [("cm", PlanSpanC), ("nodes", PlanNodesC)]


class DryPlanC(ctypes.Structure):
    """csrc/dry_run.cu DryPlanC: the dry run's wave-constant arguments."""
    _fields_ = ([("na", NodeC), ("tb", TableC)]
                + [(f, _P) for f in ("used", "npods", "cand", "victim_req",
                                     "victim_valid")]
                + [(f, _I) for f in ("Cp", "V", "has_spread")]
                + [(f, _P) for f in ("max_skew", "self_match", "min_zero",
                                     "tv_ok", "cnt0", "other_min",
                                     "vic_match")]
                + [("SC", _I)])


class DiagArgsC(ctypes.Structure):
    """csrc/diagnose_row.cu DiagArgs: a diagnosis context, its rows and
    the packed output."""
    _fields_ = [("na", NodeC), ("tb", TableC), ("used", _P), ("npods", _P),
                ("ports", _P), ("P", _I), ("has_groups", _I),
                ("g", GroupsC), ("gc", GCarryC), ("fam", FamC),
                ("rows", _I * MAX_DIAG_ROWS), ("S", _I), ("out", _P)]


PROBE_MAX_SHARDS = 4   # csrc/cluster_probe.cu KT_PROBE_MAX_SHARDS
PROBE_CLUSTER = 16     # csrc/cluster_probe.cu KT_PROBE_CLUSTER (CTAs)
PROBE_SMEM_KEYS = 32768   # csrc/cluster_probe.cu KT_PROBE_SMEM_KEYS
PROBE_BLOCK = 1024     # csrc/cluster_probe.cu BLOCK (threads a CTA)


class ProbeShardC(ctypes.Structure):
    """csrc/cluster_probe.cu ProbeShard: one node shard's columns."""
    _fields_ = ([(f, _P) for f in ("cap", "valid", "used", "npods")]
                + [("rows", _I)])


class ProbeArgsC(ctypes.Structure):
    """csrc/cluster_probe.cu ProbeArgs."""
    _fields_ = ([("s", ProbeShardC * PROBE_MAX_SHARDS), ("D", _I),
                 ("dom", _P)]
                + [(f, _I) for f in ("N", "R", "ndom")]
                + [(f, _P) for f in ("tight", "keys", "dom_pods",
                                     "dom_nodes", "per_res", "dom_stats",
                                     "valid_count")])


class ShardStepC(ctypes.Structure):
    """csrc/run_batch_sharded.cu ShardStepC."""
    _fields_ = [("na", NodeC), ("tb", TableC), ("c", CarryC), ("cfg", CfgC),
                ("valid", _P), ("sig", _P), ("tidx", _P), ("offset", _I),
                ("loc", _P), ("key", _P), ("out", _P), ("has_groups", _I),
                ("g", GroupsC), ("gc", GCarryC), ("fam", FamC),
                ("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64),
                ("n_global", _I)] + [
        (f, _P) for f in ("feas", "gsc", "loc2", "loc3", "own")]


class UniShardC(ctypes.Structure):
    """csrc/run_uniform_sharded.cu UniShardC."""
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cin", CarryC),
                 ("cout", CarryC), ("cfg", CfgC)]
                + [(f, _I) for f in ("sig", "tidx", "offset", "n_global",
                                     "K", "J", "L", "L_loc", "n_actual",
                                     "fused")]
                + [(f, _P) for f in ("loc", "keys0", "cand", "keys1",
                                     "fit_kj", "sfit_kj", "sbal_kj", "send",
                                     "gcount", "top")])


USH_MAX_SHARDS = 4     # csrc/run_uniform_sharded.cu KT_USH_MAX_SHARDS


class UniBatchC(ctypes.Structure):
    """csrc/run_uniform_sharded.cu UniBatchC: one device's shards."""
    _fields_ = [("s", UniShardC * USH_MAX_SHARDS)]


class PlanShardC(ctypes.Structure):
    """csrc/run_plan_sharded.cu PlanShardC."""
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cfg", CfgC),
                 ("g", GroupsC), ("gc", GCarryC), ("fam", FamC)]
                + [(f, _P) for f in ("used", "nonzero_used", "npods",
                                     "ports")]
                + [("P", _I)]
                + [(f, _P) for f in ("m0", "taint_raw", "na_raw", "s_img",
                                     "valid", "widx")]
                + [("wt", _I * MAX_PLAN_SLOTS)]
                + [(f, _I) for f in ("S", "W", "norm_live", "has_groups",
                                     "has_ports")]
                + [("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64),
                   ("offset", _I), ("n_global", _I)]
                + [(f, _P) for f in ("fit_ok", "s_fit", "s_bal", "feas",
                                     "gsc", "loc1", "loc2", "loc3", "key",
                                     "own", "ctl", "packed")])


class GangShardC(ctypes.Structure):
    """csrc/run_gang_sharded.cu GangShardC."""
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cfg", CfgC)]
                + [(f, _P) for f in (
                    "used_in", "nz_in", "npods_in", "sig_in", "used",
                    "nonzero_used", "npods", "sig_out", "m0", "taint_raw",
                    "na_raw", "s_img", "valid", "tidx", "widx", "wt", "dom")]
                + [(f, _I) for f in ("S", "B", "needed", "w_contig",
                                     "offset", "n_global")]
                + [(f, _P) for f in ("fit_ok", "s_fit", "s_bal", "domcnt",
                                     "placed", "loc", "key", "own",
                                     "packed")])


class GangSpanC(ctypes.Structure):
    """csrc/gang_span.cuh GangSpanC: what every node shard shares."""
    _fields_ = ([("tb", TableC), ("cfg", CfgC)]
                + [(f, _P) for f in ("valid", "tidx", "widx", "wt")]
                + [(f, _I) for f in ("S", "B", "needed", "w_contig",
                                     "n_local", "D")]
                + [("part", _P), ("packed", _P)])


class GangNodesC(ctypes.Structure):
    """csrc/gang_span.cuh GangNodesC: one node shard's arrays."""
    _fields_ = ([("na", NodeC)]
                + [(f, _P) for f in (
                    "used_in", "nz_in", "npods_in", "sig_in", "used",
                    "nonzero_used", "npods", "sig_out", "m0", "taint_raw",
                    "na_raw", "s_img", "dom", "fit_ok", "s_fit", "s_bal")]
                + [("offset", _I)])


class ScoreProbeArgsC(ctypes.Structure):
    _fields_ = [("na", NodeC), ("tb", TableC), ("cfg", CfgC),
                ("used", _P), ("nonzero_used", _P), ("tidx", _I),
                ("total", _P), ("std", _P)]


class UniformArgsC(ctypes.Structure):
    """csrc/run_uniform.cu UniformArgs."""
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cin", CarryC),
                 ("cout", CarryC), ("cfg", CfgC), ("ovl_used", _P),
                 ("ovl_npods", _P)]
                + [(f, _I) for f in ("sig", "tidx", "K", "J", "L",
                                     "n_actual", "gang", "needed", "tile",
                                     "rank_smem")]
                + [(f, _P) for f in ("part", "slots", "hist", "keys0",
                                     "cand", "keys1", "fit_kj", "sfit_kj",
                                     "sbal_kj", "counts", "sel", "packed")])


class ExplainArgsC(ctypes.Structure):
    _fields_ = [("na", NodeC), ("tb", TableC), ("c", CarryC), ("cfg", CfgC),
                ("g", GroupsC), ("gc", GCarryC), ("fam", FamC),
                ("has_groups", _I), ("tidx", _I), ("k", _I),
                ("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64)] + [
        (f, _P) for f in ("part", "cand", "masked", "gsc", "feas", "flags",
                          "idx", "totals", "cols", "feasible")]


def _bind(name: str, lib):
    if name == "run_batch":
        lib.ktpu_run_batch.argtypes = [_P, _P]
        lib.ktpu_run_batch.restype = ctypes.c_int
    elif name == "run_uniform":
        lib.ktpu_run_uniform.argtypes = [_P, _I, _P]
        lib.ktpu_run_uniform.restype = ctypes.c_int
    elif name == "scatter_rows":
        lib.ktpu_scatter_rows.argtypes = [_P, _P, _P]
        lib.ktpu_scatter_rows.restype = ctypes.c_int
    elif name == "wave_statics":
        lib.ktpu_wave_statics.argtypes = [_P, _P]
        lib.ktpu_wave_statics.restype = ctypes.c_int
    elif name == "run_wave":
        lib.ktpu_run_wave.argtypes = [_P, _P]
        lib.ktpu_run_wave.restype = ctypes.c_int
    elif name == "run_plan":
        lib.ktpu_run_plan.argtypes = [_P, _P]
        lib.ktpu_run_plan.restype = ctypes.c_int
    elif name == "dry_run":
        lib.ktpu_dry_run.argtypes = [_P, _P, _P, _P, _I, _P, _P]
        lib.ktpu_dry_run.restype = ctypes.c_int
    elif name == "run_gang":
        lib.ktpu_run_gang.argtypes = [_P, _P, _P]
        lib.ktpu_run_gang.restype = ctypes.c_int
    elif name == "cluster_probe":
        lib.ktpu_cluster_probe.argtypes = [_P, _P]
        lib.ktpu_cluster_probe.restype = ctypes.c_int
    elif name == "explain_row":
        lib.ktpu_explain_row.argtypes = [_P, _I, _P]
        lib.ktpu_explain_row.restype = ctypes.c_int
        lib.ktpu_explain_parts.argtypes = []
        lib.ktpu_explain_parts.restype = ctypes.c_int
        lib.parts = lib.ktpu_explain_parts()
    elif name == "score_probe":
        lib.ktpu_score_probe.argtypes = [_P, _P]
        lib.ktpu_score_probe.restype = ctypes.c_int
    elif name == "run_batch_sharded":
        lib.ktpu_shard_eval.argtypes = [_P, _I, _P]
        lib.ktpu_shard_select.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_apply.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_geval.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_graw.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_gselect.argtypes = [_P, _I, _P, _P, _P]
        lib.ktpu_shard_gapply.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_gupdate.argtypes = [_P, _I, _P, _P, _P]
        lib.ktpu_batch_span_grid.argtypes = [_P, _P, _I, _I, _I, _P]
        for f in ("ktpu_shard_eval", "ktpu_shard_select", "ktpu_shard_apply",
                  "ktpu_shard_geval", "ktpu_shard_graw", "ktpu_shard_gselect",
                  "ktpu_shard_gapply", "ktpu_shard_gupdate",
                  "ktpu_batch_span_grid"):
            getattr(lib, f).restype = ctypes.c_int
    elif name == "run_uniform_sharded":
        lib.ktpu_ush_parts.argtypes = [_P, _I, _I, _P]
        lib.ktpu_ush_select.argtypes = [_P, _I, _P, _P]
        lib.ktpu_ush_finalize.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I,
                                          _P]
        for f in ("ktpu_ush_parts", "ktpu_ush_select", "ktpu_ush_finalize"):
            getattr(lib, f).restype = ctypes.c_int
    elif name == "run_plan_sharded":
        lib.ktpu_plan_shard_init.argtypes = [_P, _P]
        lib.ktpu_plan_shard_min.argtypes = [_P, _I, _I, _P]
        lib.ktpu_plan_shard_eval.argtypes = [_P, _I, _I, _P, _P]
        lib.ktpu_plan_shard_raw.argtypes = [_P, _I, _I, _P, _P]
        lib.ktpu_plan_shard_select.argtypes = [_P, _I, _I, _P, _P, _P]
        lib.ktpu_plan_shard_apply.argtypes = [_P, _I, _I, _P, _P]
        lib.ktpu_plan_shard_update.argtypes = [_P, _I, _P, _P, _P]
        for f in ("init", "min", "eval", "raw", "select", "apply", "update"):
            getattr(lib, f"ktpu_plan_shard_{f}").restype = ctypes.c_int
        lib.ktpu_plan_span_grid.argtypes = [_P, _P, _I, _I, _P]
        lib.ktpu_plan_span_grid.restype = ctypes.c_int
    elif name == "run_gang_sharded":
        lib.ktpu_gang_shard_init.argtypes = [_P, _P]
        lib.ktpu_gang_shard_eval.argtypes = [_P, _I, _P]
        lib.ktpu_gang_shard_select.argtypes = [_P, _I, _P, _P]
        lib.ktpu_gang_shard_apply.argtypes = [_P, _I, _P, _P]
        lib.ktpu_gang_shard_update.argtypes = [_P, _I, _P, _P, _P]
        lib.ktpu_gang_shard_verdict.argtypes = [_P, _P]
        for f in ("init", "eval", "select", "apply", "update", "verdict"):
            getattr(lib, f"ktpu_gang_shard_{f}").restype = ctypes.c_int
        lib.ktpu_gang_span_grid.argtypes = [_P, _P, _I, _I, _P]
        lib.ktpu_gang_span_grid.restype = ctypes.c_int
    else:
        lib.ktpu_diagnose_row.argtypes = [_P, _P]
        lib.ktpu_diagnose_row.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# argument checks and packing

_NODE_SPEC = {   # field → (dtype, rank)
    "cap": (torch.int64, 2), "allowed_pods": (torch.int32, 1),
    "valid": (torch.bool, 1), "unschedulable": (torch.bool, 1),
    "name_id": (torch.int32, 1), "taint_key": (torch.int32, 2),
    "taint_val": (torch.int32, 2), "taint_eff": (torch.int32, 2),
    "label_key": (torch.int32, 2), "label_kv": (torch.int32, 2),
    "label_num": (torch.int64, 2), "image_id": (torch.int32, 2),
    "image_size": (torch.int64, 2),
}
_CACHE_SPEC = {"sig": (torch.int32, 0), "static_mask": (torch.bool, 1),
               "taint_raw": (torch.int64, 1), "na_raw": (torch.int64, 1),
               "s_img": (torch.int64, 1), "fit_ok": (torch.bool, 1),
               "s_fit": (torch.int64, 1), "s_bal": (torch.int64, 1)}


def _check(t: torch.Tensor, what: str, dtype, rank: int, device) -> int:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != rank:
        raise ValueError(f"{what}: rank {t.dim()}, expected {rank}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t.data_ptr()


class _Memo:
    """Argument structs packed from a tree of tensors (NodeArrays, a
    PodTableDev, GroupsDev, a GroupCarry), kept for the next call with the
    same tree: an entry is keyed on the tree object and the packing's other
    arguments, holds the tree itself (so no tensor its struct points into
    is freed while the entry lives), and is taken only while every tensor
    has the data_ptr() and shape it was packed with; otherwise the tree is
    checked and packed again. At most `size` entries, the oldest dropped
    first. Reading a tensor's address makes no device sync."""

    def __init__(self, pack, size: int):
        self.pack, self.size = pack, size
        self.entries: dict = {}

    def __call__(self, tree, *args):
        key = (id(tree),) + args
        ent = self.entries.get(key)
        if ent is not None and ent[0] is tree:
            tree_, ts, ptrs, shapes, struct = ent
            if ([t.data_ptr() for t in ts] == ptrs
                    and [t.shape for t in ts] == shapes):
                return struct
        struct = self.pack(tree, *args)
        ts = [t for t in tree if isinstance(t, torch.Tensor)]
        self.entries.pop(key, None)
        self.entries[key] = (tree, ts, [t.data_ptr() for t in ts],
                             [t.shape for t in ts], struct)
        while len(self.entries) > self.size:
            del self.entries[next(iter(self.entries))]
        return struct


def _pack_node(na, device) -> NodeC:
    ptrs = {f: _check(getattr(na, f), f"na.{f}", *spec, device)
            for f, spec in _NODE_SPEC.items()}
    N, R = na.cap.shape
    for f in _NODE_SPEC:
        if getattr(na, f).shape[0] != N:
            raise ValueError(f"na.{f}: {getattr(na, f).shape[0]} rows, "
                             f"expected {N}")
    if na.image_size.shape != na.image_id.shape:
        raise ValueError("na.image_size / na.image_id shapes differ")
    for a, b in (("taint_val", "taint_key"), ("taint_eff", "taint_key"),
                 ("label_kv", "label_key"), ("label_num", "label_key")):
        if getattr(na, a).shape != getattr(na, b).shape:
            raise ValueError(f"na.{a} / na.{b} shapes differ")
    return NodeC(**ptrs, N=N, R=R, T=na.taint_key.shape[1],
                 Lb=na.label_key.shape[1], I=na.image_id.shape[1])


_node_c = _Memo(_pack_node, 8)


def _cache_c(cache, N: int, device) -> CacheC:
    ptrs = {}
    for f, (dtype, rank) in _CACHE_SPEC.items():
        t = getattr(cache, f)
        ptrs[f] = _check(t, f"cache.{f}", dtype, rank, device)
        if rank and t.shape[0] != N:
            raise ValueError(f"cache.{f}: length {t.shape[0]}, expected {N}")
    return CacheC(**ptrs)


def _carry_c(carry, N: int, R: int, device, cache: CacheC = None) -> CarryC:
    used = _check(carry.used, "carry.used", torch.int64, 2, device)
    nz = _check(carry.nonzero_used, "carry.nonzero_used", torch.int64, 2,
                device)
    npods = _check(carry.npods, "carry.npods", torch.int32, 1, device)
    ports = _check(carry.ports, "carry.ports", torch.int32, 2, device)
    if tuple(carry.used.shape) != (N, R):
        raise ValueError(f"carry.used: {tuple(carry.used.shape)}, "
                         f"expected {(N, R)}")
    if tuple(carry.nonzero_used.shape) != (N, 2):
        raise ValueError("carry.nonzero_used must be [N, 2]")
    if carry.npods.shape[0] != N or carry.ports.shape[0] != N:
        raise ValueError("carry.npods / carry.ports: wrong node count")
    return CarryC(used=used, nonzero_used=nz, npods=npods, ports=ports,
                  P=carry.ports.shape[1],
                  cache=(cache if cache is not None
                         else _cache_c(carry.cache, N, device)))


_TABLE_SPEC = {
    "req": (torch.int64, 2), "nonzero_req": (torch.int64, 2),
    "node_name_id": (torch.int32, 1), "tol_key": (torch.int32, 2),
    "tol_val": (torch.int32, 2), "tol_eff": (torch.int32, 2),
    "tol_op": (torch.int32, 2), "tolerates_unsched": (torch.bool, 1),
    "ns_sel_val": (torch.int32, 2), "aff_has": (torch.bool, 1),
    "aff_term_valid": (torch.bool, 2), "aff_key": (torch.int32, 3),
    "aff_op": (torch.int32, 3), "aff_num": (torch.int64, 3),
    "aff_val": (torch.int32, 4), "pref_weight": (torch.int64, 2),
    "pref_key": (torch.int32, 3), "pref_op": (torch.int32, 3),
    "pref_num": (torch.int64, 3), "pref_val": (torch.int32, 4),
    "port_ids": (torch.int32, 2), "skip_balanced": (torch.bool, 1),
    "img_ids": (torch.int32, 2), "img_containers": (torch.int32, 1),
}


def _pack_table(table, R: int, device) -> TableC:
    ptrs = {f: _check(getattr(table, f), f"table.{f}", *spec, device)
            for f, spec in _TABLE_SPEC.items()}
    U = table.req.shape[0]
    if table.req.shape[1] != R:
        raise ValueError(f"table.req width {table.req.shape[1]} != node "
                         f"resource width {R}")
    for f in _TABLE_SPEC:
        if getattr(table, f).shape[0] != U:
            raise ValueError(f"table.{f}: wrong row count")
    TM, Q = table.aff_key.shape[1:]
    PT = table.pref_key.shape[1]
    V = table.aff_val.shape[3]
    IC = table.img_ids.shape[1]
    if (tuple(table.aff_val.shape[1:3]) != (TM, Q)
            or table.pref_val.shape[1:] != (PT, Q, V)
            or table.pref_key.shape[2] != Q
            or table.ns_sel_val.shape[1] != Q
            or table.aff_term_valid.shape[1] != TM):
        raise ValueError("table selector tables have inconsistent shapes")
    if IC > MAX_IC:
        raise ValueError(f"{IC} images per pod > kernel limit {MAX_IC}")
    return TableC(**ptrs, U=U, R=R, TT=table.tol_key.shape[1], Q=Q, TM=TM,
                  V=V, PT=PT, PP=table.port_ids.shape[1], IC=IC)


_table_c = _Memo(_pack_table, 8)


def _cfg_c(cfg, R: int) -> CfgC:
    C = len(cfg.score_cols)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{C} score columns: kernel takes 1..{MAX_C}")
    if not (len(cfg.col_weights) == len(cfg.col_nonzero)
            == len(cfg.nonzero_slot) == C):
        raise ValueError("ScoreConfig column tuples differ in length")
    if any(not 0 <= c < R for c in cfg.score_cols) or any(
            s not in (0, 1) for s in cfg.nonzero_slot):
        raise ValueError("ScoreConfig column index out of range")
    if cfg.strategy not in ("LeastAllocated", "MostAllocated"):
        raise ValueError(f"unknown scoring strategy {cfg.strategy!r}")

    def arr(ctype, vals):
        return (ctype * MAX_C)(*(list(vals) + [0] * (MAX_C - C)))

    return CfgC(C=C, score_cols=arr(_I, cfg.score_cols),
                col_weights=arr(ctypes.c_int64, cfg.col_weights),
                col_nonzero=arr(_I, (int(b) for b in cfg.col_nonzero)),
                nonzero_slot=arr(_I, cfg.nonzero_slot),
                w_fit=cfg.w_fit, w_balanced=cfg.w_balanced,
                w_taint=cfg.w_taint, w_node_affinity=cfg.w_node_affinity,
                w_image=cfg.w_image,
                most_allocated=int(cfg.strategy == "MostAllocated"))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_GROUPS_SPEC = {   # field → (dtype, rank)
    "spr_f_active": (torch.bool, 2), "spr_f_max_skew": (torch.int32, 2),
    "spr_f_self": (torch.int32, 2), "spr_f_tv": (torch.int32, 3),
    "spr_f_elig": (torch.bool, 3), "spr_f_dom": (torch.int32, 3),
    "spr_s_active": (torch.bool, 2), "spr_s_max_skew": (torch.int32, 2),
    "spr_s_is_host": (torch.bool, 2), "spr_s_tv": (torch.int32, 3),
    "spr_s_elig": (torch.bool, 3), "spr_s_keys_ok": (torch.bool, 2),
    "spr_s_dom": (torch.int32, 3), "ipa_ra_active": (torch.bool, 2),
    "ipa_ra_tv": (torch.int32, 3), "ipa_ra_dom": (torch.int32, 3),
    "ipa_raa_active": (torch.bool, 2), "ipa_raa_tv": (torch.int32, 3),
    "ipa_raa_dom": (torch.int32, 3), "ipa_self_all": (torch.bool, 1),
    "ipa_stc_tv": (torch.int32, 3), "ipa_stc_dom": (torch.int32, 3),
    "ipa_stp_tv": (torch.int32, 3), "ipa_stp_dom": (torch.int32, 3),
    "m_spr_f": (torch.bool, 3), "m_spr_s": (torch.bool, 3),
    "m_ipa_a": (torch.bool, 2), "m_ipa_aa": (torch.bool, 3),
    "m_ipa_exist": (torch.bool, 3), "w_stc": (torch.int64, 3),
    "w_stp": (torch.int64, 3),
}
_GCARRY_SPEC = {
    "spr_f_cnt": (torch.int32, 3), "spr_f_min_zero": (torch.bool, 2),
    "spr_s_cnt": (torch.int32, 3), "ipa_veto": (torch.int32, 2),
    "ipa_a_cnt": (torch.int32, 3), "ipa_a_total": (torch.int64, 1),
    "ipa_aa_cnt": (torch.int32, 3), "ipa_score": (torch.int64, 2),
}


def _pack_groups(gd, N: int, device) -> GroupsC:
    ptrs = {f: _check(getattr(gd, f), f"gd.{f}", *spec, device)
            for f, spec in _GROUPS_SPEC.items()}
    U, SC = gd.spr_f_active.shape
    TA, TAA = gd.ipa_ra_active.shape[1], gd.ipa_raa_active.shape[1]
    CT, PT = gd.ipa_stc_tv.shape[1], gd.ipa_stp_tv.shape[1]
    want = {"spr_f_max_skew": (U, SC), "spr_f_self": (U, SC),
            "spr_f_tv": (U, SC, N), "spr_f_elig": (U, SC, N),
            "spr_f_dom": (U, SC, N), "spr_s_active": (U, SC),
            "spr_s_max_skew": (U, SC), "spr_s_is_host": (U, SC),
            "spr_s_tv": (U, SC, N), "spr_s_elig": (U, SC, N),
            "spr_s_keys_ok": (U, N), "spr_s_dom": (U, SC, N),
            "ipa_ra_tv": (U, TA, N), "ipa_ra_dom": (U, TA, N),
            "ipa_raa_tv": (U, TAA, N), "ipa_raa_dom": (U, TAA, N),
            "ipa_self_all": (U,), "ipa_stc_tv": (U, CT, N),
            "ipa_stc_dom": (U, CT, N), "ipa_stp_tv": (U, PT, N),
            "ipa_stp_dom": (U, PT, N), "m_spr_f": (U, U, SC),
            "m_spr_s": (U, U, SC), "m_ipa_a": (U, U),
            "m_ipa_aa": (U, U, TAA), "m_ipa_exist": (U, U, TAA),
            "w_stc": (U, U, CT), "w_stp": (U, U, PT)}
    for f, shape in want.items():
        if tuple(getattr(gd, f).shape) != shape:
            raise ValueError(f"gd.{f}: {tuple(getattr(gd, f).shape)}, "
                             f"expected {shape}")
    if SC > MAX_SC:
        raise ValueError(f"{SC} spread constraints > kernel limit {MAX_SC}")
    return GroupsC(**ptrs, U=U, SC=SC, TA=TA, TAA=TAA, CT=CT, PT=PT, N=N)


_groups_c = _Memo(_pack_groups, 4)


def _pack_gcarry(gc, dims: tuple, device) -> GCarryC:
    """A GroupCarry's struct; `dims` = (U, SC, TA, TAA, N) of its
    GroupsC."""
    ptrs = {f: _check(getattr(gc, f), f"groups.{f}", *spec, device)
            for f, spec in _GCARRY_SPEC.items()}
    U, SC, TA, TAA, N = dims
    want = {"spr_f_cnt": (U, SC, N), "spr_f_min_zero": (U, SC),
            "spr_s_cnt": (U, SC, N), "ipa_veto": (U, N),
            "ipa_a_cnt": (U, TA, N), "ipa_a_total": (U,),
            "ipa_aa_cnt": (U, TAA, N), "ipa_score": (U, N)}
    for f, shape in want.items():
        if tuple(getattr(gc, f).shape) != shape:
            raise ValueError(f"groups.{f}: {tuple(getattr(gc, f).shape)}, "
                             f"expected {shape}")
    return GCarryC(**ptrs)


_gcarry_memo = _Memo(_pack_gcarry, 4)


def _gcarry_c(gc, g: GroupsC, device, fresh: bool = False) -> GCarryC:
    """The struct of a group carry shaped by `g`: an input carry's kept in
    the memo; a fresh carry a kernel writes (`fresh`) packed and not
    kept."""
    dims = (g.U, g.SC, g.TA, g.TAA, g.N)
    return (_pack_gcarry if fresh else _gcarry_memo)(gc, dims, device)


def _fam_c(fam) -> FamC:
    return FamC(*(int(bool(x)) for x in fam))


def _clone_groups(gc):
    return type(gc)(*(t.clone() for t in gc))


def _out_carry(carry):
    """The carry the scan (run_batch) writes in place: copies of every
    field, because the input carry may still be held for rewind (the scan
    writes port ids and group counts and starts from the input
    SigCache)."""
    from .program import Carry, SigCache
    groups = carry.groups
    if groups is not None:
        groups = _clone_groups(groups)
    return Carry(used=carry.used.clone(),
                 nonzero_used=carry.nonzero_used.clone(),
                 npods=carry.npods.clone(), ports=carry.ports.clone(),
                 cache=SigCache(*(t.clone() for t in carry.cache)),
                 groups=groups)


def _overlay_c(overlay, N: int, R: int, device, copy: bool):
    """(ovl_used, ovl_npods) pointers of a checked overlay (i64 [N, R],
    i32 [N]); with `copy`, of fresh copies the kernel may consume. Returns
    (pointers, tensors kept alive until the call returns)."""
    if overlay is None:
        return (None, None), ()
    used, npods = overlay
    _check(used, "overlay.used", torch.int64, 2, device)
    _check(npods, "overlay.npods", torch.int32, 1, device)
    if tuple(used.shape) != (N, R) or npods.shape[0] != N:
        raise ValueError(f"overlay: {tuple(used.shape)} / "
                         f"{tuple(npods.shape)}, expected {(N, R)} / {(N,)}")
    if copy:
        used, npods = used.clone(), npods.clone()
    return (used.data_ptr(), npods.data_ptr()), (used, npods)


def batch_dyn_bytes(N: int, U: int, ctas: int = BATCH_CLUSTER) -> int:
    """A scan CTA's dynamic shared memory (csrc/batch_span.cuh
    batch_dyn_bytes) when `ctas` CTAs split N rows (run_batch's cluster by
    default): its ⌈N / ctas⌉ rows' raw spread scores and feasible set,
    then ipa_a_total of the U group rows (0 lean)."""
    span = -(-N // ctas)
    return (9 * span + 15) // 16 * 16 + 8 * U


def batch_span_parts(SC: int, n_global: int, spread_s: bool,
                     blocks: int) -> list:
    """The scratch pieces of one scan span launch, in carve order: a grid
    team's partial slots [2, blocks, PLAN_RED_K] (none for a cluster:
    blocks = 0), then the epoch-tagged spread domain flags [SC, n_global]
    (ScheduleAnyway spans only)."""
    return [("part", 2 * blocks * PLAN_RED_K, torch.int64),
            ("flags", SC * n_global if spread_s else 0, torch.int32)]


def _pods_c(pods, B: int, device, what: str) -> tuple:
    """(valid, sig, tidx) pointers of checked pod inputs of length B."""
    ptrs = tuple(_check(getattr(pods, f), f"pods.{f}", dt, 1, device)
                 for f, dt in (("valid", torch.bool), ("sig", torch.int32),
                               ("tidx", torch.int32)))
    if pods.sig.shape[0] != B or pods.tidx.shape[0] != B:
        raise ValueError(f"{what}: pods.valid / sig / tidx lengths differ")
    return ptrs


def _batch_span_c(cfg, tab, R: int, famc, has_groups: bool, ptr: dict,
                  pods_p: tuple, B: int, n_local: int, D: int, out,
                  ovl_ptrs=(None, None), nom_ptr=None) -> BatchSpanC:
    return BatchSpanC(
        tb=tab, cfg=_cfg_c(cfg, R), fam=famc, has_groups=int(has_groups),
        w_spread=cfg.w_spread, w_ipa=cfg.w_ipa, flags=ptr["flags"],
        ovl_used=ovl_ptrs[0], ovl_npods=ovl_ptrs[1], nom_idx=nom_ptr,
        valid=pods_p[0], sig=pods_p[1], tidx=pods_p[2], B=B,
        n_global=D * n_local, n_local=n_local, D=D, part=ptr["part"],
        out=out.data_ptr())


def run_batch_cuda(cfg, na, carry, pods, table, groups=None, fam=None,
                   overlay=None):
    """The scan kernel (csrc/run_batch.cu) over pods [B]; same contract as
    program.run_batch, with the group branch when `groups` is given and
    the overlay variant when `overlay` is (the kernel consumes a copy of
    it; `pods.nom_idx`, when not None, holds each pod's own nominated
    row). One launch of a thread-block cluster a call; every argument is
    checked before the kernels are built."""
    device = carry.used.device
    node = _node_c(na, device)
    B = pods.valid.shape[0]
    pods_p = _pods_c(pods, B, device, "run_batch")
    if overlay is not None and groups is not None:
        raise ValueError("run_batch: the overlay is a lean-scan input")
    # the copies stay bound to a name until the call returns
    ovl_ptrs, _ovl = _overlay_c(overlay, node.N, node.R, device, copy=True)
    nom = pods.nom_idx
    nom_ptr = None
    if overlay is not None and nom is not None:
        nom_ptr = _check(nom, "pods.nom_idx", torch.int32, 1, device)
        if nom.shape[0] != B:
            raise ValueError("run_batch: pods.nom_idx: wrong length")
    tab = _table_c(table, node.R, device)
    _cfg_c(cfg, node.R)
    g = gcc = None
    U = 0
    if groups is not None:
        g = _groups_c(groups, node.N, device)
        _gcarry_c(carry.groups, g, device)
        if g.U > tab.U:
            raise ValueError("run_batch: more group rows than table rows")
        U = g.U
    if batch_dyn_bytes(node.N, U) > MAX_DYN_SMEM:
        raise ValueError(f"run_batch: {node.N} node rows and {U} group rows "
                         "exceed a CTA's shared memory")
    _carry_c(carry, node.N, node.R, device)
    libs = build()
    out_carry = _out_carry(carry)
    cc = _carry_c(out_carry, node.N, node.R, device)
    out = torch.empty((B,), dtype=torch.int32, device=device)
    if g is not None:
        gcc = _gcarry_c(out_carry.groups, g, device, fresh=True)
        famc = _fam_c(fam if fam is not None else (1,) * 5)
    else:
        g, gcc, famc = GroupsC(), GCarryC(), FamC()
    _scratch, ptr, _offs = _carve(device, batch_span_parts(
        g.SC, node.N, bool(famc.spr_s), 0))
    # every struct and tensor stays bound to a name until the call
    # returns: the C entry copies the struct into the launch
    args = BatchArgsC(
        cm=_batch_span_c(cfg, tab, node.R, famc, groups is not None, ptr,
                         pods_p, B, node.N, 1, out, ovl_ptrs, nom_ptr),
        nodes=BatchNodesC(na=node, c=cc, g=g, gc=gcc, offset=0))
    rc = libs["run_batch"].ktpu_run_batch(ctypes.addressof(args),
                                          _stream(device))
    _raise_on(rc, "run_batch")
    LAUNCHES["run_batch_groups" if groups is not None
             else "run_batch_ovl" if overlay is not None
             else "run_batch"] += 1
    return out_carry, out


def _pow2(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


UNI_BLOCK = 256            # csrc/run_uniform.cu BLOCK
UNI_SLOTS = 9              # csrc/run_uniform.cu NSLOT
UNI_HIST = 2 * 8 * 256     # two grid selects of up to eight 8-bit digits
UNI_TILE = 512             # keys a block orders in shared memory
UNI_RANK_SMEM = 8192       # selected keys staged for the rank search


def uniform_layout(N: int, K: int, J: int, n_actual: int):
    """How csrc/run_uniform.cu runs one closed form: `rows` is "all" (K =
    N: every row a candidate) or "grid" (the grid's digit passes select
    the top K rows); `keys` likewise for the top n_actual of the K·J
    entries ("none" and "all" need no selection); `tile` the keys a block
    orders in shared memory, `tiles` how many; `rank` the order's branch:
    "one_tile", or with more tiles the rank search over the tiles staged
    in shared memory ("smem") or in place ("global"); `blocks` the grid
    before the card's cap."""
    KJ = K * J
    tile = min(UNI_TILE, _pow2(max(n_actual, 1)))
    return SimpleNamespace(
        rows="all" if K == N else "grid",
        keys=("none" if n_actual == 0 else "all" if n_actual >= KJ
              else "grid"),
        tile=tile, tiles=-(-n_actual // tile),
        rank=("one_tile" if n_actual <= tile else "smem"
              if n_actual <= UNI_RANK_SMEM else "global"),
        blocks=max(-(-N // UNI_BLOCK), -(-KJ // UNI_BLOCK), 1))


def uniform_scratch(N: int, K: int, J: int, n_actual: int, grid: int):
    """The scratch pieces of one run_uniform launch, in carve order (the
    row keys and the candidates only when K < N)."""
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    KJ, sel_rows = K * J, K < N
    return [("part", grid * (MAX_IC + 3), i64), ("slots", UNI_SLOTS, i64),
            ("keys0", N if sel_rows else 0, i64), ("keys1", KJ, i64),
            ("sfit_kj", KJ, i64), ("sbal_kj", KJ, i64),
            ("sel", n_actual, i64), ("hist", UNI_HIST, i32),
            ("cand", K if sel_rows else 0, i32), ("counts", N, i32),
            ("fit_kj", KJ, u8)]


def _fresh_carry(carry):
    """The output carry of a closed-form run: fresh tensors for every
    field the kernels write (they write each in full), the ports and
    group counts shared."""
    from .program import SigCache
    e = torch.empty_like
    return carry._replace(used=e(carry.used),
                          nonzero_used=e(carry.nonzero_used),
                          npods=e(carry.npods),
                          cache=SigCache(*(e(t) for t in carry.cache)))


def _fresh_carry_c(oc, R: int) -> CarryC:
    """The CarryC of a `_fresh_carry` output: its tensors are empty_like
    copies of checked ones, so only their pointers are read."""
    return CarryC(used=oc.used.data_ptr(),
                  nonzero_used=oc.nonzero_used.data_ptr(),
                  npods=oc.npods.data_ptr(), ports=oc.ports.data_ptr(),
                  P=oc.ports.shape[1],
                  cache=CacheC(**{f: getattr(oc.cache, f).data_ptr()
                                  for f in _CACHE_FIELDS}))


def _uniform_run(cfg, na, carry, x, table, n_actual: int, L: int, K: int,
                 J: int, what: str, overlay=None, needed=None):
    """One closed-form run (csrc/run_uniform.cu): every check first, then
    one cooperative launch into a fresh output carry, one scratch buffer
    and the packed result ([L + 2], with `needed` the gang tier's
    [L + 4])."""
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    sig, tidx, n_actual = int(x.sig), int(x.tidx), int(n_actual)
    if sig == 0:
        raise ValueError(f"{what} needs a signature (sig != 0)")
    if not (1 <= K <= N and J >= 1 and 1 <= L <= K * J < 2 ** 31
            and N * R < 2 ** 31):
        raise ValueError(f"{what}: bad shape L={L} K={K} J={J} N={N}")
    if not 0 <= n_actual <= L:
        raise ValueError(f"{what}: n_actual {n_actual} outside [0, {L}]")
    tab = _table_c(table, R, device)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"{what}: row {tidx} outside the table")
    cin = _carry_c(carry, N, R, device)
    (ovl_used, ovl_npods), _ovl = _overlay_c(overlay, N, R, device,
                                             copy=False)
    lay = uniform_layout(N, K, J, n_actual)
    lib = build()["run_uniform"]
    grid = min(lay.blocks, _sm_count(device))
    _scratch, ptr, _offs = _carve(device, uniform_scratch(N, K, J, n_actual,
                                                          grid))
    oc = _fresh_carry(carry)
    packed = torch.empty((L + (2 if needed is None else 4),),
                         dtype=torch.int32, device=device)
    args = UniformArgsC(
        na=node, tb=tab, cin=cin, cout=_fresh_carry_c(oc, R),
        cfg=_cfg_c(cfg, R), ovl_used=ovl_used, ovl_npods=ovl_npods,
        sig=sig, tidx=tidx, K=K, J=J, L=L, n_actual=n_actual,
        gang=int(needed is not None), needed=int(needed or 0),
        tile=lay.tile, rank_smem=int(lay.rank == "smem"),
        packed=packed.data_ptr(), **ptr)
    with torch.cuda.device(device):
        rc = lib.ktpu_run_uniform(ctypes.addressof(args), grid,
                                  _stream(device))
    _raise_on(rc, what)
    return oc, packed


def run_uniform_cuda(cfg, na, carry, x, table, n_actual: int, L: int,
                     K: int, J: int, overlay=None):
    """The closed form (csrc/run_uniform.cu) for one same-signature run;
    same contract as program.run_uniform, with the overlay variant when
    `overlay` is given (read only)."""
    out = _uniform_run(cfg, na, carry, x, table, n_actual, L, K, J,
                       "run_uniform", overlay=overlay)
    LAUNCHES["run_uniform" if overlay is None else "run_uniform_ovl"] += 1
    return out


def run_gang_uniform_cuda(cfg, na, carry, x, table, n_actual: int,
                          needed: int, L: int, K: int, J: int):
    """The closed-form gang tier (csrc/run_uniform.cu with the verdict,
    decided before the carry is written: a rejected or inexact gang's
    output carry equals its input); same contract as
    gang._run_gang_uniform_plain. The input is only read."""
    out = _uniform_run(cfg, na, carry, x, table, n_actual, L, K, J,
                       "run_gang", needed=int(needed))
    LAUNCHES["run_gang_uniform"] += 1
    return out


def scatter_rows_cuda(dev, idx, rows):
    """The row scatter (csrc/scatter_rows.cu); same contract as
    program.scatter_rows: fresh tensors, dev untouched. `idx` is a host
    array or CPU tensor; the row map the kernel reads is built from it on
    the host and copied from pinned memory without blocking."""
    out = _scatter_rows_launch(dev, idx, rows)
    LAUNCHES["scatter_rows"] += 1
    return out


def _scatter_rows_launch(dev, idx, rows):
    from ..state.tensorize import NodeArrays
    libs = build()
    device = dev.used.device
    index = np.asarray(idx, dtype=np.int64)
    if index.ndim != 1:
        raise ValueError("scatter_rows: idx must be 1-D")
    D = index.shape[0]
    N = dev.used.shape[0]
    if D and (int(index.min()) < 0 or int(index.max()) >= N):
        raise ValueError("scatter_rows: row index outside the node axis")
    if len(dev) > MAX_SCATTER_FIELDS:
        raise ValueError("scatter_rows: too many fields")
    row_map = np.full((N,), -1, np.int32)
    row_map[index] = np.arange(D, dtype=np.int32)
    map_t = torch.from_numpy(row_map).pin_memory().to(device,
                                                       non_blocking=True)
    sc = ScatterC(nf=len(dev), N=N, D=D)
    outs = []
    for k, (name, d, r) in enumerate(zip(NodeArrays._fields, dev, rows)):
        dp = _check(d, f"dev.{name}", d.dtype, d.dim(), device)
        rp = _check(r, f"rows.{name}", d.dtype, d.dim(), device)
        if d.shape[0] != N or r.shape[0] != D or d.shape[1:] != r.shape[1:]:
            raise ValueError(f"scatter_rows: {name} shapes "
                             f"{tuple(d.shape)} / {tuple(r.shape)}")
        o = torch.empty_like(d)
        outs.append(o)
        op = o.data_ptr()
        row_bytes = d.element_size()
        for x in d.shape[1:]:
            row_bytes *= x
        # the widest unit that divides the row and all three addresses
        unit = 16
        while (row_bytes | op | dp | rp) % unit:
            unit //= 2
        sc.f[k] = ScatterField(op, dp, rp, row_bytes // unit, unit)
    rc = libs["scatter_rows"].ktpu_scatter_rows(
        ctypes.addressof(sc), map_t.data_ptr(), _stream(device))
    _raise_on(rc, "scatter_rows")
    return NodeArrays(*outs)


def _statics_rows(wt, U: int, what: str) -> list:
    rows = [int(u) for u in wt]
    if not rows or any(not 0 <= u < U for u in rows):
        raise ValueError(f"{what}: rows {rows} outside the table")
    if len(rows) > MAX_WAVE_ROWS:
        raise ValueError(f"{what}: {len(rows)} rows, at most "
                         f"{MAX_WAVE_ROWS} per call")
    return rows


def statics_layout(S: int, rows: list) -> tuple:
    """Byte offsets of one wave_statics launch's outputs in its one
    allocation, over shards of `rows` node rows each: a shard's three
    int64 [S, n] surfaces (taint_raw, na_raw, s_img) then its [S, n]
    mask, each shard's piece 8-byte aligned. Returns ([(surfaces, mask)]
    a shard, the end: where the chain's image counts go)."""
    out, at = [], 0
    for n in rows:
        out.append((at, at + 24 * S * n))
        at += -(-25 * S * n // 8) * 8
    return out, at


def _statics_args(nodes: list, tab, rows: list, feats, device,
                  counts: int = 0):
    """(StaticsArgsC over the shards `nodes`, [(mask, taint_raw, na_raw,
    s_img)] a shard, the int64 [counts] image counts or None): every
    output a view of one allocation."""
    S = len(rows)
    layout, at = statics_layout(S, [n.N for n in nodes])
    buf = torch.empty((max(at + 8 * counts, 8),), dtype=torch.uint8,
                      device=device)
    base = buf.data_ptr()
    has_taints, has_sel, has_img = (int(bool(f)) for f in feats)
    args = StaticsArgsC(D=len(nodes), N=sum(n.N for n in nodes), tb=tab,
                        S=S, has_taints=has_taints, has_sel=has_sel,
                        has_img=has_img)
    args.wt[:S] = rows
    outs = []
    for d, (node, (o, m)) in enumerate(zip(nodes, layout)):
        n = S * node.N
        surf = buf[o:m].view(torch.int64).view(3, S, node.N).unbind(0)
        outs.append((buf[m:m + n].view(torch.bool).view(S, node.N),) + surf)
        args.s[d] = StaticsShardC(na=node, mask=base + m, taint_raw=base + o,
                                  na_raw=base + o + 8 * n,
                                  s_img=base + o + 16 * n)
    cnt = buf[at:at + 8 * counts].view(torch.int64) if counts else None
    return args, outs, cnt


def wave_statics_cuda(na, table, wt, feats=(True, True, True)):
    """The per-signature surfaces (csrc/wave_statics.cu: ONE launch a
    call, the table of one shard); same contract as program.wave_statics.
    The four outputs are views of one allocation."""
    device = na.valid.device
    node = _node_c(na, device)
    tab = _table_c(table, node.R, device)
    rows = _statics_rows(wt, tab.U, "wave_statics")
    args, outs, _cnt = _statics_args([node], tab, rows, feats, device)
    lib = build()["wave_statics"]
    rc = lib.ktpu_wave_statics(ctypes.addressof(args), _stream(device))
    _raise_on(rc, "wave_statics")
    LAUNCHES["wave_statics"] += 1
    return outs[0]


def wave_dyn_bytes(N: int) -> int:
    """csrc/run_wave.cu wave_dyn_bytes: a CTA's dynamic shared memory (its
    ⌈N / C⌉ rows' raw spread scores and feasible set, then the leader's
    top-Lw keys, top-K rows, entries and the replay's domain table)."""
    span = -(-N // WAVE_CLUSTER)
    return ((9 * span + 15) // 16 * 16 + MAX_WAVE_L * (8 + 4 * 6 + 2)
            + WAVE_HASH * 8)


def wave_parts(N: int, J: int, SC: int, TAA: int) -> list:
    """The scratch pieces of one run_wave launch, in carve order."""
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    return [("masked", N, i64), ("champ", N, i64), ("fseg", 3 * N, i64),
            ("keys1", N * J, i64), ("f_cnt", SC * N, i32), ("veto", N, i32),
            ("aa_cnt", TAA * N, i32), ("cnt_n", N, i32),
            ("cnt_add", N, i32), ("dshare", (SC + TAA) * N, i32),
            ("elig_dom", SC * N, i32), ("flags", SC * N, i32),
            ("gmask", N, u8)]


def run_wave_cuda(cfg, na, carry, valid, table, wt, gd, statics, K: int,
                  J: int, Lw: int, fam, norm_live: bool, anti_term: int,
                  merge_on: bool):
    """The same-signature wave kernel (csrc/run_wave.cu: one launch of a
    thread-block cluster a call); same contract as program.run_wave (Lw
    already capped at the span bucket). Its scratch is one carved
    allocation; the carry fields it writes are fresh copies."""
    from .program import Carry
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    g = _groups_c(gd, N, device)
    gin = _gcarry_c(carry.groups, g, device)
    wt = int(wt)
    if not (0 <= wt < g.U and wt < tab.U):
        raise ValueError(f"run_wave: row {wt} outside the tables")
    B = valid.shape[0]
    valid_p = _check(valid, "valid", torch.bool, 1, device)
    stat = [_check(t, f"statics[{k}]", dt, 1, device) for k, (t, dt) in
            enumerate(zip(statics, (torch.bool, torch.int64, torch.int64,
                                    torch.int64)))]
    if any(t.shape[0] != N for t in statics):
        raise ValueError("run_wave: statics must be [N] each")
    if not (1 <= K <= N and J >= 1 and 1 <= Lw <= min(B, K * J)):
        raise ValueError(f"run_wave: bad shape K={K} J={J} Lw={Lw} B={B} "
                         f"N={N}")
    if K > MAX_WAVE_L or Lw > MAX_WAVE_L:
        raise ValueError(f"run_wave: K={K}, Lw={Lw}: the kernel takes at "
                         f"most {MAX_WAVE_L} of each")
    if wave_dyn_bytes(N) > MAX_DYN_SMEM:
        raise ValueError(f"run_wave: N={N} rows need "
                         f"{wave_dyn_bytes(N)} bytes of shared memory a "
                         f"CTA, more than {MAX_DYN_SMEM}")
    if not -1 <= anti_term < g.TAA:
        raise ValueError(f"run_wave: anti term {anti_term} out of range")
    libs = build()
    gout_t = _clone_groups(carry.groups)
    gout = _gcarry_c(gout_t, g, device, fresh=True)
    used = carry.used.clone()
    nz = carry.nonzero_used.clone()
    npods = carry.npods.clone()
    _carry_c(carry._replace(used=used, nonzero_used=nz, npods=npods), N, R,
             device)
    buf, ptr, _offs = _carve(device, wave_parts(N, J, g.SC, g.TAA))
    packed = torch.empty((B + 4,), dtype=torch.int32, device=device)
    args = WaveArgsC(
        na=node, tb=tab, cfg=_cfg_c(cfg, R), g=g, gin=gin, gout=gout,
        fam=_fam_c(fam), used=used.data_ptr(), nonzero_used=nz.data_ptr(),
        npods=npods.data_ptr(), m0=stat[0], taint_raw=stat[1],
        na_raw=stat[2], s_img=stat[3], valid=valid_p, wt=wt, B=B, K=K, J=J,
        Lw=Lw, norm_live=int(bool(norm_live)), anti_term=int(anti_term),
        merge_on=int(bool(merge_on)), w_spread=cfg.w_spread,
        w_ipa=cfg.w_ipa, packed=packed.data_ptr(), **ptr)
    rc = libs["run_wave"].ktpu_run_wave(ctypes.addressof(args),
                                        _stream(device))
    _raise_on(rc, "run_wave")
    LAUNCHES["run_wave"] += 1
    cache = carry.cache._replace(
        sig=torch.zeros((), dtype=torch.int32, device=device))
    return Carry(used=used, nonzero_used=nz, npods=npods, ports=carry.ports,
                 cache=cache, groups=gout_t), packed


PLAN_RED_K = 16       # csrc/plan_span.cuh KT_RED_K
PLAN_BLOCK = 512      # csrc/plan_span.cuh KT_PLAN_BLOCK (threads a CTA)


def plan_span_parts(S: int, n_local: int, D: int, SC: int, spread_s: bool,
                    blocks: int) -> list:
    """The scratch pieces of one plan span launch, in carve order: a grid
    team's partial slots [2, blocks, PLAN_RED_K] (none for a cluster:
    blocks = 0), the epoch-tagged spread domain flags [SC, D·n_local]
    (ScheduleAnyway spans only), then each shard's fit surfaces [S,
    n_local] (an evaluation's feasible set and raw spread scores live in
    each CTA's shared memory)."""
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    parts = [("part", 2 * blocks * PLAN_RED_K, i64),
             ("flags", SC * D * n_local if spread_s else 0, i32)]
    for d in range(D):
        parts += [(f"s_fit{d}", S * n_local, i64),
                  (f"s_bal{d}", S * n_local, i64),
                  (f"fit_ok{d}", S * n_local, u8)]
    return parts


def _plan_rows(wt, W: int, what: str) -> list:
    rows = [int(u) for u in wt]
    if not 1 <= len(rows) <= MAX_PLAN_SLOTS:
        raise ValueError(f"{what}: {len(rows)} signature slots, kernel "
                         f"takes 1..{MAX_PLAN_SLOTS}")
    if W < 1:
        raise ValueError(f"{what}: an empty span")
    return rows


def _plan_shard(cfg, na, carry, table, rows, gd, statics, fam, has_groups,
                has_ports, device, what: str, offset: int = 0):
    """Check one node shard of a plan span and make its outputs: (PlanNodesC
    without its scratch pointers, the output Carry, the shard's SC, its
    TableC). Every check runs before anything is allocated or built."""
    from .program import Carry
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    if any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"{what}: rows {rows} outside the table")
    stat = _check_statics(statics, len(rows), N, device, what)
    _carry_c(carry, N, R, device)
    if has_groups:
        g = _groups_c(gd, N, device)
        _gcarry_c(carry.groups, g, device)
        if any(u >= g.U for u in rows) or g.U > tab.U:
            raise ValueError(f"{what}: rows {rows} outside the group "
                             "tables")
        gout_t = _clone_groups(carry.groups)
        gc, SC = _gcarry_c(gout_t, g, device, fresh=True), g.SC
    else:
        g, gc, gout_t, SC = GroupsC(), GCarryC(), carry.groups, 0
    used, nz, npods = (carry.used.clone(), carry.nonzero_used.clone(),
                       carry.npods.clone())
    ports = carry.ports.clone() if has_ports else carry.ports
    nodes = PlanNodesC(
        na=node, g=g, gc=gc, used=used.data_ptr(), nonzero_used=nz.data_ptr(),
        npods=npods.data_ptr(), ports=ports.data_ptr(), m0=stat[0],
        taint_raw=stat[1], na_raw=stat[2], s_img=stat[3], offset=offset)
    out = Carry(used=used, nonzero_used=nz, npods=npods, ports=ports,
                cache=carry.cache._replace(sig=torch.zeros(
                    (), dtype=torch.int32, device=device)),
                groups=gout_t)
    return nodes, out, SC, tab


def _plan_xs(xs, device) -> tuple:
    """(valid, widx) pointers of a checked span layout."""
    return (_check(xs.valid, "xs.valid", torch.bool, 1, device),
            _check(xs.widx, "xs.widx", torch.int32, 1, device))


def _plan_span_c(cfg, tab, R: int, xs_p, W: int, rows, fam, norm_live,
                 has_groups, has_ports, P: int, n_local: int, D: int, ptr,
                 packed) -> PlanSpanC:
    valid_p, widx_p = xs_p
    S = len(rows)
    return PlanSpanC(
        tb=tab, cfg=_cfg_c(cfg, R), fam=_fam_c(fam) if has_groups else FamC(),
        valid=valid_p, widx=widx_p,
        wt=(_I * MAX_PLAN_SLOTS)(*(rows + [0] * (MAX_PLAN_SLOTS - S))),
        S=S, W=W, P=P, norm_live=int(bool(norm_live)),
        has_groups=int(bool(has_groups)), has_ports=int(bool(has_ports)),
        w_spread=cfg.w_spread, w_ipa=cfg.w_ipa, n_global=D * n_local,
        n_local=n_local, D=D, flags=ptr["flags"], part=ptr["part"],
        packed=packed.data_ptr())


def _set_scratch(nodes, ptr: dict, d: int) -> None:
    """Shard d's fit surfaces (PlanNodesC or GangNodesC) from the carve."""
    for f in ("s_fit", "s_bal", "fit_ok"):
        setattr(nodes, f, ptr[f"{f}{d}"])


def run_plan_cuda(cfg, na, carry, xs, table, wt, gd, statics, fam,
                  norm_live: bool, has_groups: bool, has_ports: bool):
    """The plan program (csrc/run_plan.cu) over one mixed-signature span;
    same contract as program.run_plan. One launch of a thread-block
    cluster; its scratch is one buffer. The caller's carry is never
    written."""
    device = carry.used.device
    W = xs.valid.shape[0]
    rows = _plan_rows(wt, W, "run_plan")
    if xs.widx.shape[0] != W:
        raise ValueError("run_plan: xs.valid / xs.widx lengths differ")
    xs_p = _plan_xs(xs, device)
    nodes, out, SC, tab = _plan_shard(cfg, na, carry, table, rows, gd,
                                      statics, fam, has_groups, has_ports,
                                      device, "run_plan")
    N, R = nodes.na.N, nodes.na.R
    lib = build()["run_plan"]
    spread_s = bool(has_groups and fam.spr_s)
    _scratch, ptr, _offs = _carve(device, plan_span_parts(
        len(rows), N, 1, SC, spread_s, 0))
    _set_scratch(nodes, ptr, 0)
    packed = torch.empty((W + 2,), dtype=torch.int32, device=device)
    # the struct stays bound to a name until the call returns
    args = PlanArgsC(cm=_plan_span_c(
        cfg, tab, R, xs_p, W, rows, fam, norm_live, has_groups, has_ports,
        carry.ports.shape[1], N, 1, ptr, packed), nodes=nodes)
    with torch.cuda.device(device):
        rc = lib.ktpu_run_plan(ctypes.addressof(args), _stream(device))
    _raise_on(rc, "run_plan")
    LAUNCHES["run_plan"] += 1
    RAW_LAUNCHES["run_plan"] += 1
    return out, packed


class DiagArgs:
    """A diagnosis context's argument block (csrc/diagnose_row.cu DiagArgs
    less its rows and output), checked and packed once per context: the
    post-commit node rows `na` (with used / npods / ports), the table and,
    with group constraints live, the group tensors `gd`, their carry `gc`
    and the families `fam`. The block holds a reference to every tensor
    its struct points into, so none is freed while it lives; `over(ctx)`
    says whether it was packed from these very tensors ((na, table, gd,
    gc), each the same object)."""

    def __init__(self, na, table, gd=None, gc=None, fam=None):
        if (gd is None) != (gc is None):
            raise ValueError("diagnose_row: gd and gc go together")
        device = na.valid.device
        node = _node_c(na, device)
        N, R = node.N, node.R
        tab = _table_c(table, R, device)
        used = _check(na.used, "na.used", torch.int64, 2, device)
        npods = _check(na.npods, "na.npods", torch.int32, 1, device)
        ports = _check(na.ports, "na.ports", torch.int32, 2, device)
        if (tuple(na.used.shape) != (N, R) or na.npods.shape[0] != N
                or na.ports.shape[0] != N):
            raise ValueError("diagnose_row: node state shapes differ from "
                             "cap")
        if gd is not None:
            g = _groups_c(gd, N, device)
            gcc = _gcarry_c(gc, g, device)
            famc = _fam_c(fam if fam is not None else (1,) * 5)
        else:
            g, gcc, famc = GroupsC(), GCarryC(), FamC()
        self.U, self.group_U = tab.U, (g.U if gd is not None else None)
        self.c = DiagArgsC(na=node, tb=tab, used=used, npods=npods,
                           ports=ports, P=na.ports.shape[1],
                           has_groups=int(gd is not None), g=g, gc=gcc,
                           fam=famc)
        self.device, self.N, self.R = device, N, R
        self.ctx = (na, table, gd, gc)

    def over(self, ctx) -> bool:
        return all(a is b for a, b in zip(ctx, self.ctx))


def diagnose_rows_cuda(args, ctx, rows):
    """The mask diagnosis (csrc/diagnose_row.cu) of the table rows `rows`
    against the context `args` packed from `ctx` (na, table, gd, gc): ONE
    launch of a thread-block cluster a row; same contract as
    program.diagnose_rows. A block packed from other tensors raises."""
    if not isinstance(args, DiagArgs):
        raise ValueError("diagnose_row: the CUDA launch needs the context's "
                         "packed argument block (program.diagnose_args)")
    if not args.over(ctx):
        raise ValueError("diagnose_row: a stale argument block (packed from "
                         "other tensors than the context's)")
    rows = [int(u) for u in rows]
    if not 1 <= len(rows) <= MAX_DIAG_ROWS:
        raise ValueError(f"diagnose_row: {len(rows)} rows, 1 to "
                         f"{MAX_DIAG_ROWS} a launch")
    for u in rows:
        if not 0 <= u < args.U:
            raise ValueError(f"diagnose_row: row {u} outside the table")
        if args.group_U is not None and u >= args.group_U:
            raise ValueError(f"diagnose_row: row {u} outside the group "
                             "tables")
    lib = build()["diagnose_row"]
    S, N, R = len(rows), args.N, args.R
    out = torch.empty((S * N * (5 + R),), dtype=torch.uint8,
                      device=args.device)
    args.c.rows[:S] = rows
    args.c.S = S
    args.c.out = out.data_ptr()
    rc = lib.ktpu_diagnose_row(ctypes.addressof(args.c),
                               _stream(args.device))
    _raise_on(rc, "diagnose_row")
    LAUNCHES["diagnose_row"] += 1
    return out


class DryRunArgs:
    """The dry run's wave-constant arguments (csrc/dry_run.cu DryPlanC),
    checked and packed once per preemptor wave: `wave` holds (na, pod,
    cand, victim_req, victim_valid, spread) as program.DryRunWave does —
    the node rows, the preemptor's PodRow of device tensors, the plan's
    candidate rows, its victims in reprieve order and its spread tensors.
    The block holds a reference to every tensor its struct points into
    (the preemptor's one-row table views included), so none is freed while
    it lives; `over(wave)` says whether it was packed from this very wave
    (a tuple of tensor references: the same object, the same tensors)."""

    def __init__(self, wave):
        from .program import PodTableDev
        na, pod, cand, victim_req, victim_valid, spread = wave
        device = victim_req.device
        node = _node_c(na, device)
        N, R = node.N, node.R
        if R > MAX_DRY_R:
            raise ValueError(f"dry_run: {R} resource columns > kernel limit "
                             f"{MAX_DRY_R}")
        used = _check(na.used, "na.used", torch.int64, 2, device)
        npods = _check(na.npods, "na.npods", torch.int32, 1, device)
        if tuple(na.used.shape) != (N, R) or na.npods.shape[0] != N:
            raise ValueError("dry_run: node state shapes differ from cap")
        # the preemptor's row as a one-row table (views, no copies)
        row = PodTableDev(*(getattr(pod, f).unsqueeze(0)
                            for f in PodTableDev._fields))
        tab = _table_c(row, R, device)
        Cp = cand.shape[0]
        cand_p = _check(cand, "cand", torch.int32, 1, device)
        req_p = _check(victim_req, "victim_req", torch.int64, 3, device)
        valid_p = _check(victim_valid, "victim_valid", torch.bool, 2, device)
        V = victim_req.shape[1]
        if not 1 <= V <= MAX_DRY_V:
            raise ValueError(f"dry_run: {V} victim slots outside "
                             f"1..{MAX_DRY_V}")
        if (tuple(victim_req.shape) != (Cp, V, R)
                or tuple(victim_valid.shape) != (Cp, V)):
            raise ValueError(f"dry_run: victim tensors "
                             f"{tuple(victim_req.shape)} / "
                             f"{tuple(victim_valid.shape)}, expected "
                             f"{(Cp, V, R)} / {(Cp, V)}")
        sp = {}
        SC = 0
        if spread is not None:
            SC = spread.max_skew.shape[0]
            if SC > MAX_SC:
                raise ValueError(f"dry_run: {SC} spread constraints > kernel "
                                 f"limit {MAX_SC}")
            want = {"max_skew": (torch.int32, (SC,)),
                    "self_match": (torch.int32, (SC,)),
                    "min_zero": (torch.bool, (SC,)),
                    "tv_ok": (torch.bool, (Cp, SC)),
                    "cnt0": (torch.int32, (Cp, SC)),
                    "other_min": (torch.int32, (Cp, SC)),
                    "vic_match": (torch.bool, (Cp, V, SC))}
            for f, (dtype, shape) in want.items():
                t = getattr(spread, f)
                sp[f] = _check(t, f"spread.{f}", dtype, len(shape), device)
                if tuple(t.shape) != shape:
                    raise ValueError(f"spread.{f}: {tuple(t.shape)}, "
                                     f"expected {shape}")
        self.c = DryPlanC(na=node, tb=tab, used=used, npods=npods,
                          cand=cand_p, victim_req=req_p,
                          victim_valid=valid_p, Cp=Cp, V=V,
                          has_spread=int(bool(sp)), SC=SC, **sp)
        self.device, self.Cp, self.V, self.R = device, Cp, V, R
        self.wave, self._row = wave, row

    def over(self, wave) -> bool:
        return wave is self.wave


def dry_run_select_victims_cuda(na, pod, cand, victim_req, victim_valid,
                                ovl_used, ovl_npods, spread=None):
    """The batched preemption dry run (csrc/dry_run.cu) over every
    candidate; same contract as program.dry_run_select_victims. `pod` is a
    PodRow of device tensors (program.pod_row_from_table)."""
    wave = (na, pod, cand, victim_req, victim_valid, spread)
    return dry_run_subset_cuda(DryRunArgs(wave), wave, None, ovl_used,
                               ovl_npods)


def dry_run_subset_cuda(args, wave, sub, ovl_used, ovl_npods):
    """The dry run over the candidate positions `sub` (i32 [C]) of the
    plan `args` packed from `wave` (None: every candidate), reading the
    plan's tensors through `sub` in place; the overlay rows and the output
    bool [C, V+1] are in the order of `sub`. One launch; only the per-call
    tensors are checked. A block packed from other tensors than `wave`'s
    raises."""
    if not isinstance(args, DryRunArgs):
        raise ValueError("dry_run: the CUDA launch needs the plan's packed "
                         "argument block (program.dry_run_args)")
    if not args.over(wave):
        raise ValueError("dry_run: a stale argument block (packed from "
                         "other tensors than the wave's)")
    device, R = args.device, args.R
    if sub is None:
        C, sub_p = args.Cp, None
    else:
        sub_p = _check(sub, "sub", torch.int32, 1, device)
        C = sub.shape[0]
    ou_p = _check(ovl_used, "ovl_used", torch.int64, 2, device)
    on_p = _check(ovl_npods, "ovl_npods", torch.int32, 1, device)
    if tuple(ovl_used.shape) != (C, R) or ovl_npods.shape[0] != C:
        raise ValueError(f"dry_run: overlay must be [{C}, {R}] / [{C}]")
    lib = build()["dry_run"]
    out = torch.empty((C, args.V + 1), dtype=torch.bool, device=device)
    rc = lib.ktpu_dry_run(ctypes.addressof(args.c), sub_p, ou_p, on_p, C,
                          out.data_ptr(), _stream(device))
    _raise_on(rc, "dry_run")
    LAUNCHES["dry_run"] += 1
    return out


def run_gang_cuda(cfg, na, carry, xs, table, wt, needed: int, dom, statics,
                  w_contig: int):
    """The scan tier of run_gang (csrc/run_gang.cu: gang_span.cuh's body
    on a thread-block cluster, one launch a gang); same contract as
    gang._run_gang_scan_plain. The output carry holds fresh used /
    nonzero_used / npods and a fresh signature scalar; the rest of the
    SigCache, the ports and the group counts are the input's (the kernel
    never writes them). Every argument is checked before the kernels are
    built; the fit surfaces are one carved scratch buffer."""
    from .program import Carry
    device = carry.used.device
    rows = [int(u) for u in wt]
    S, B = len(rows), xs.valid.shape[0]
    if S < 1 or B < 1:
        raise ValueError("run_gang: an empty gang or signature set")
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    if any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"run_gang: rows {rows} outside the table")
    i32 = torch.int32
    xs_p = {f: _check(getattr(xs, f), f"xs.{f}", dt, 1, device)
            for f, dt in (("valid", torch.bool), ("tidx", i32),
                          ("widx", i32))}
    if xs.tidx.shape[0] != B or xs.widx.shape[0] != B:
        raise ValueError("run_gang: xs.valid / tidx / widx lengths differ")
    dom_p = _check(dom, "dom", i32, 1, device)
    if dom.shape[0] != N:
        raise ValueError(f"run_gang: dom must be [{N}]")
    stat = _check_statics(statics, S, N, device, "run_gang")
    span = -(-N // GANG_CLUSTER)
    if gang_dyn_bytes(span) > MAX_DYN_SMEM:
        raise ValueError(f"run_gang: {N} node rows need "
                         f"{gang_dyn_bytes(span)} bytes of shared memory a "
                         f"CTA, over {MAX_DYN_SMEM}")
    cin = _carry_c(carry, N, R, device)
    cfgc = _cfg_c(cfg, R)
    lib = build()["run_gang"]
    used = torch.empty_like(carry.used)
    nz = torch.empty_like(carry.nonzero_used)
    npods = torch.empty_like(carry.npods)
    sig = torch.empty_like(carry.cache.sig)
    # the cluster team's slots live in shared memory: no "part" piece
    _scratch, ptr, _offs = _carve(device, gang_span_parts(S, N, 1, 0))
    nodes = GangNodesC(
        na=node, used_in=cin.used, nz_in=cin.nonzero_used,
        npods_in=cin.npods, sig_in=cin.cache.sig, used=used.data_ptr(),
        nonzero_used=nz.data_ptr(), npods=npods.data_ptr(),
        sig_out=sig.data_ptr(), m0=stat[0], taint_raw=stat[1],
        na_raw=stat[2], s_img=stat[3], dom=dom_p, offset=0)
    _set_scratch(nodes, ptr, 0)
    wt_t = torch.tensor(rows, dtype=i32).pin_memory().to(device,
                                                          non_blocking=True)
    packed = torch.empty((B + 4,), dtype=i32, device=device)
    span_c = GangSpanC(
        tb=tab, cfg=cfgc, valid=xs_p["valid"], tidx=xs_p["tidx"],
        widx=xs_p["widx"], wt=wt_t.data_ptr(), S=S, B=B, needed=int(needed),
        w_contig=int(w_contig), n_local=N, D=1, part=None,
        packed=packed.data_ptr())
    # the structs and the tensors they point into stay bound to names
    # until the call returns
    rc = lib.ktpu_run_gang(ctypes.addressof(span_c), ctypes.addressof(nodes),
                           _stream(device))
    _raise_on(rc, "run_gang")
    RAW_LAUNCHES["run_gang"] += 1
    LAUNCHES["run_gang"] += 1
    return Carry(used=used, nonzero_used=nz, npods=npods, ports=carry.ports,
                 cache=carry.cache._replace(sig=sig),
                 groups=carry.groups), packed


def gang_dyn_bytes(span: int) -> int:
    """csrc/gang_span.cuh gang_dyn_bytes: a CTA's dynamic shared memory for
    `span` rows (each row's domain count)."""
    return (4 * span + 15) // 16 * 16


def cluster_probe_cuda(cap, valid, used, npods, dom, ndom: int):
    """The cluster probe (csrc/cluster_probe.cu); same contract as
    program.cluster_probe on (na.cap, na.valid, carry.used, carry.npods,
    dom): the probe's table of one shard. One launch of a thread-block
    cluster on the current stream; reads its inputs only."""
    out = _cluster_probe_launch([cap], [valid], [used], [npods], dom, ndom)
    LAUNCHES["cluster_probe"] += 1
    return out


def probe_parts(N: int, R: int, ndom: int) -> list:
    """The scratch and output pieces of one probe call, in carve order."""
    return [("dom_pods", ndom, torch.int64), ("dom_nodes", ndom, torch.int64),
            ("per_res", R * 7, torch.float32),
            ("dom_stats", 4, torch.float32),
            ("valid_count", 1, torch.int32), ("keys", R * N, torch.int32),
            ("tight", N, torch.uint8)]


def _cluster_probe_launch(caps, valids, useds, npods, dom, ndom: int):
    """The probe kernel on D node shards of one device (the shards' rows
    in order make the node axis; `dom` is the whole axis): one launch. The
    outputs are views of one fresh allocation that also holds the
    scratch."""
    device = dom.device
    D = len(caps)
    if not 1 <= D <= PROBE_MAX_SHARDS:
        raise ValueError(f"cluster_probe: {D} shards, the kernel takes "
                         f"1..{PROBE_MAX_SHARDS}")
    R = caps[0].shape[1] if caps[0].dim() == 2 else -1
    if not 1 <= R <= PROBE_BLOCK:
        raise ValueError(f"cluster_probe: {R} resource columns, the kernel "
                         f"takes 1..{PROBE_BLOCK}")
    shards, N = [], 0
    for d in range(D):
        rows = caps[d].shape[0]
        ptrs = {"cap": _check(caps[d], "cap", torch.int64, 2, device),
                "valid": _check(valids[d], "valid", torch.bool, 1, device),
                "used": _check(useds[d], "used", torch.int64, 2, device),
                "npods": _check(npods[d], "npods", torch.int32, 1, device)}
        if (caps[d].shape[1] != R or tuple(useds[d].shape) != (rows, R)
                or valids[d].shape[0] != rows or npods[d].shape[0] != rows):
            raise ValueError("cluster_probe: node axis or resource width "
                             "differ")
        shards.append(ProbeShardC(**ptrs, rows=rows))
        N += rows
    _check(dom, "dom", torch.int32, 1, device)
    if dom.shape[0] != N:
        raise ValueError(f"cluster_probe: dom has {dom.shape[0]} rows, the "
                         f"shards {N}")
    ndom = int(ndom)
    if not 1 <= ndom < 2 ** 31:
        raise ValueError(f"cluster_probe: ndom = {ndom}")
    libs = build()
    buf, ptr, offs = _carve(device, probe_parts(N, R, ndom))
    # the outputs: views of the buffer's float32 and int32 halves
    f32, i32 = buf.view(torch.float32), buf.view(torch.int32)
    at = 2 * offs["per_res"]
    per_res = f32[at:at + R * 7].view(R, 7)
    at = 2 * offs["dom_stats"]
    dom_stats = f32[at:at + 4]
    valid_count = i32[2 * offs["valid_count"]]
    args = ProbeArgsC((*shards,), D=D, dom=dom.data_ptr(), N=N, R=R,
                      ndom=ndom, tight=ptr["tight"], keys=ptr["keys"],
                      dom_pods=ptr["dom_pods"], dom_nodes=ptr["dom_nodes"],
                      per_res=ptr["per_res"], dom_stats=ptr["dom_stats"],
                      valid_count=ptr["valid_count"])
    # a mesh's first device need not be the current one
    guard = (torch.cuda.device(device)
             if device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        rc = libs["cluster_probe"].ktpu_cluster_probe(ctypes.addressof(args),
                                                      _stream(device))
    _raise_on(rc, "cluster_probe")
    return per_res, dom_stats, valid_count


_SMS: dict = {}
EXPLAIN_BLOCK = 256    # csrc/explain_row.cu BLOCK


def _sm_count(device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _carve(device, parts: list):
    """One int64 scratch buffer carved into `parts` ([(name, numel,
    dtype)], in order, each piece 8-byte aligned): (buffer, {name:
    data_ptr}, {name: offset in the buffer's int64 elements}); a piece of
    no elements gets a null pointer."""
    sizes = [-(-n * dt.itemsize // 8) for _name, n, dt in parts]
    buf = torch.empty((max(sum(sizes), 1),), dtype=torch.int64,
                      device=device)
    base, ptrs, offs, at = buf.data_ptr(), {}, {}, 0
    for (name, n, _dt), w in zip(parts, sizes):
        ptrs[name] = base + 8 * at if n else None
        offs[name] = at
        at += w
    return buf, ptrs, offs


def explain_row_args(N: int, k: int, SC: int, grid: int, parts: int):
    """The scratch pieces of one explain_row launch, in carve order."""
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    return [("part", grid * parts, i64), ("cand", grid * k, i64),
            ("masked", N, i64), ("gsc", N, i64), ("taint_raw", N, i64),
            ("na_raw", N, i64), ("s_img", N, i64), ("s_fit", N, i64),
            ("s_bal", N, i64), ("flags", max(SC, 1) * N, i32),
            ("sig", 1, i32), ("feas", N, u8), ("static_mask", N, u8),
            ("fit_ok", N, u8)]


def explain_row_cuda(cfg, na, carry, table, tidx: int, k: int, gd=None,
                     fam=None):
    """The score decomposition (csrc/explain_row.cu) of table row `tidx`
    at `carry`; same contract as program.explain_row. One cooperative
    launch; its scratch (the row's parts, the block partials) is one
    buffer, its outputs views of another. The caller's carry is never
    written."""
    from .program import EXPLAIN_MAX_K
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    tidx, k = int(tidx), int(k)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"explain_row: row {tidx} outside the table")
    if not 1 <= k <= min(EXPLAIN_MAX_K, N):
        raise ValueError(f"explain_row: k = {k} outside 1..min(16, N)")
    if gd is not None:
        g = _groups_c(gd, N, device)
        gcc = _gcarry_c(carry.groups, g, device)
        if tidx >= g.U:
            raise ValueError(f"explain_row: row {tidx} outside the group "
                             "tables")
        famc = _fam_c(fam if fam is not None else (1,) * 5)
        SC = g.SC
    else:
        g, gcc, famc, SC = GroupsC(), GCarryC(), FamC(), 0
    lib = build()["explain_row"]
    grid = min(-(-N // EXPLAIN_BLOCK), _sm_count(device))
    _scratch, ptr, _offs = _carve(device, explain_row_args(
        N, k, SC, grid, lib.parts))
    cache = CacheC(**{f: ptr[f] for f in _CACHE_FIELDS})
    cc = _carry_c(carry, N, R, device, cache=cache)
    # the outputs: totals [k], cols [k, 6], then idx and the count as int32
    out = torch.empty((7 * k + (k + 2) // 2,), dtype=torch.int64,
                      device=device)
    totals, cols = out[:k], out[k:7 * k].view(k, 6)
    small = out[7 * k:].view(torch.int32)
    idx, feasible = small[:k], small[k]
    args = ExplainArgsC(
        na=node, tb=tab, c=cc, cfg=_cfg_c(cfg, R), g=g, gc=gcc, fam=famc,
        has_groups=int(gd is not None), tidx=tidx, k=k,
        w_spread=cfg.w_spread, w_ipa=cfg.w_ipa,
        **{f: ptr[f] for f in ("part", "cand", "masked", "gsc", "feas",
                               "flags")},
        idx=idx.data_ptr(), totals=totals.data_ptr(), cols=cols.data_ptr(),
        feasible=feasible.data_ptr())
    with torch.cuda.device(device):
        rc = lib.ktpu_explain_row(ctypes.addressof(args), grid,
                                  _stream(device))
    _raise_on(rc, "explain_row")
    LAUNCHES["explain_row"] += 1
    return idx, totals, cols, feasible


def score_probe_cuda(cfg, na, carry, table, tidx: int):
    """The score probe (csrc/score_probe.cu) of table row `tidx` at
    `carry`; same contract as program.score_probe: (total f32 [N], std
    f32 [N]). One launch on the current stream; reads its inputs only."""
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    tidx = int(tidx)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"score_probe: row {tidx} outside the table")
    used = _check(carry.used, "carry.used", torch.int64, 2, device)
    nz = _check(carry.nonzero_used, "carry.nonzero_used", torch.int64, 2,
                device)
    if (tuple(carry.used.shape) != (N, R)
            or tuple(carry.nonzero_used.shape) != (N, 2)):
        raise ValueError("score_probe: carry.used / nonzero_used shapes")
    total = torch.empty((N,), dtype=torch.float32, device=device)
    std = torch.empty((N,), dtype=torch.float32, device=device)
    args = ScoreProbeArgsC(na=node, tb=tab, cfg=_cfg_c(cfg, R), used=used,
                           nonzero_used=nz, tidx=tidx,
                           total=total.data_ptr(), std=std.data_ptr())
    rc = libs["score_probe"].ktpu_score_probe(ctypes.addressof(args),
                                              _stream(device))
    _raise_on(rc, "score_probe")
    LAUNCHES["score_probe"] += 1
    return total, std


# ---------------------------------------------------------------------------
# the node-sharded mesh (parallel/sharding.py): the scans on shards of one
# card are one cooperative launch a span or gang; otherwise per-shard
# launches with the exchange between them, driven from the host without a
# readback


def _own_len(g: GroupsC) -> int:
    """The own vector's length (csrc/group_eval.cuh block_own_write)."""
    return g.U * (4 * g.SC + g.TAA + g.TA + g.CT + g.PT)


def _grid_blocks(n_local: int, D: int, dev, what: str) -> int:
    """T, the blocks a shard of a cooperative span launch over D shards of
    one card: one 512-thread block per 512 rows, at most the card's SMs /
    D (every block must be resident at once). Raises when D shards need
    more blocks than the card can hold."""
    sms = _sm_count(dev)
    T = max(1, min(-(-n_local // PLAN_BLOCK), sms // D))
    if D * T > sms:
        raise ValueError(f"{what}: {D} shards need {D * T} co-resident "
                         f"blocks, the card has {sms} SMs")
    return T


def _nodes_dev(arr, dev) -> torch.Tensor:
    """A ctypes array of per-shard structs in device memory (through
    pinned memory, on the current stream)."""
    return torch.frombuffer(bytearray(arr), dtype=torch.uint8) \
        .pin_memory().to(dev, non_blocking=True)


def run_batch_sharded_cuda(cfg, mesh, na, carry, pods, table, groups=None,
                           fam=None):
    """The scan over node shards (csrc/run_batch_sharded.cu); same
    contract as parallel/sharding.py run_batch_sharded, lean and group
    mode. Shards on one card (plan_sharded_placement "one"): one
    cooperative launch a span. Shards on several cards: the chain of
    launches a shard, driven from the host. Output carries are fresh
    copies; every argument is checked before the kernels are built."""
    n_local = na[0].cap.shape[0]
    if any(s.cap.shape[0] != n_local for s in na):
        raise ValueError("run_batch_sharded: shards of unequal size")
    run = (_batch_sharded_one if plan_sharded_placement(mesh) == "one"
           else _batch_sharded_chain)
    out = run(cfg, mesh, na, carry, pods, table, groups, fam)
    LAUNCHES["run_batch_sharded_groups" if groups is not None
             else "run_batch_sharded"] += 1
    return out


def _batch_sharded_one(cfg, mesh, na, carry, pods, table, groups, fam):
    """Every shard on one card: the span in one cooperative launch of D
    teams of T blocks (csrc/run_batch_sharded.cu ktpu_batch_span_grid),
    the body of run_batch's cluster (csrc/batch_span.cuh). The shards'
    BatchNodesC go to the card through pinned memory; the scratch (the
    partial slots, the flags) is one buffer."""
    from ..parallel.sharding import Shards, replicate
    dev, D = mesh.devices[0], mesh.size
    n_local = na[0].cap.shape[0]
    pods_d, table_d = replicate(mesh, pods)[0], replicate(mesh, table)[0]
    B = pods_d.valid.shape[0]
    pods_p = _pods_c(pods_d, B, dev, "run_batch_sharded")
    tab = _table_c(table_d, na[0].cap.shape[1], dev)
    grp = groups is not None
    nodes, outs = [], []
    for d in range(D):
        node = _node_c(na[d], dev)
        _carry_c(carry[d], n_local, node.R, dev)
        g, gc = GroupsC(), GCarryC()
        if grp:
            g = _groups_c(groups[d], n_local, dev)
            _gcarry_c(carry[d].groups, g, dev)
            if g.U > tab.U:
                raise ValueError("run_batch_sharded: more group rows than "
                                 "table rows")
        nodes.append(BatchNodesC(na=node, g=g, gc=gc, offset=d * n_local))
    R, g0 = nodes[0].na.R, nodes[0].g
    U = g0.U
    _cfg_c(cfg, R)
    lib = build()["run_batch_sharded"]
    T = _grid_blocks(n_local, D, dev, "run_batch_sharded")
    if batch_dyn_bytes(n_local, U, T) > MAX_DYN_SMEM:
        raise ValueError(f"run_batch_sharded: {-(-n_local // T)} rows a "
                         f"block and {U} group rows exceed a block's shared "
                         "memory")
    famc = _fam_c(fam) if grp else FamC()
    spread_s = bool(famc.spr_s)
    _scratch, ptr, _offs = _carve(dev, batch_span_parts(
        g0.SC, D * n_local, spread_s, D * T))
    for d, nd in enumerate(nodes):
        oc = _out_carry(carry[d])
        outs.append(oc)
        nd.c = _carry_c(oc, n_local, R, dev)
        if grp:
            nd.gc = _gcarry_c(oc.groups, nd.g, dev, fresh=True)
    nodes_dev = _nodes_dev((BatchNodesC * D)(*nodes), dev)
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    span = _batch_span_c(cfg, tab, R, famc, grp, ptr, pods_p, B, n_local, D,
                         out)
    with torch.cuda.device(dev):
        rc = lib.ktpu_batch_span_grid(ctypes.addressof(span),
                                      nodes_dev.data_ptr(), D, T, U,
                                      _stream(dev))
    _raise_on(rc, "run_batch_sharded")
    RAW_LAUNCHES["run_batch_sharded"] += 1
    return Shards(outs), out


def _batch_sharded_chain(cfg, mesh, na, carry, pods, table, groups, fam):
    """Shards on several cards: the chain of launches a shard. Lean mode,
    per pod: every shard's shard_eval, the exchange of the image counts
    and maxima, every shard's shard_select, the max of the packed keys,
    every shard's shard_apply. Group mode (`groups`, the shard_groups of
    the GroupsDev; the counts ride the carry shards), per pod: shard_eval
    with the spread minima, the exchange, shard_geval, the exchange of the
    score partials, shard_graw and its exchange (ScheduleAnyway rows),
    shard_gselect, the max of the keys, shard_gapply, the sum of the own
    vectors, shard_gupdate. Output carries are fresh copies."""
    from ..parallel.sharding import (Shards, exchange, lean_exchange, pmax,
                                     psum, replicate)
    B = pods.valid.shape[0]
    pods_r, tabs = replicate(mesh, pods), replicate(mesh, table)
    n_local = na[0].cap.shape[0]
    n_global = n_local * mesh.size
    grp = groups is not None
    outs, args, locs, keys, bufs = [], [], [], [], []
    out = None
    i64 = torch.int64
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        if node.N != n_local:
            raise ValueError("run_batch_sharded: shards of unequal size")
        ptrs = [_check(getattr(pods_r[d], f), f"pods.{f}", dt, 1, dev)
                for f, dt in (("valid", torch.bool), ("sig", torch.int32),
                              ("tidx", torch.int32))]
        if pods_r[d].sig.shape[0] != B or pods_r[d].tidx.shape[0] != B:
            raise ValueError("pods: valid/sig/tidx lengths differ")
        oc = _out_carry(carry[d])
        outs.append(oc)
        tab = _table_c(tabs[d], node.R, dev)
        gkw = {}
        if grp:
            g = _groups_c(groups[d], node.N, dev)
            if g.U > tab.U:
                raise ValueError("run_batch_sharded: more group rows than "
                                 "table rows")
            b = SimpleNamespace(
                feas=torch.empty((node.N,), dtype=torch.uint8, device=dev),
                gsc=torch.empty((node.N,), dtype=i64, device=dev),
                loc2=torch.zeros((1 + g.SC * n_global + 4,), dtype=i64,
                                 device=dev),
                loc3=torch.zeros((2,), dtype=i64, device=dev),
                own=torch.empty((_own_len(g),), dtype=i64, device=dev))
            bufs.append(b)
            gkw = dict(has_groups=1, g=g,
                       gc=_gcarry_c(oc.groups, g, dev, fresh=True),
                       fam=_fam_c(fam), w_spread=cfg.w_spread,
                       w_ipa=cfg.w_ipa, n_global=n_global,
                       **{k: t.data_ptr() for k, t in vars(b).items()})
        locs.append(torch.zeros((MAX_IC + 3 + (gkw["g"].SC if grp else 0),),
                                dtype=i64, device=dev))
        keys.append(torch.empty((1,), dtype=i64, device=dev))
        if d == 0:
            out = torch.empty((B,), dtype=torch.int32, device=dev)
        args.append(ShardStepC(
            na=node, tb=tab, c=_carry_c(oc, node.N, node.R, dev),
            cfg=_cfg_c(cfg, node.R), valid=ptrs[0], sig=ptrs[1],
            tidx=ptrs[2], offset=d * n_local, loc=locs[d].data_ptr(),
            key=keys[d].data_ptr(),
            out=out.data_ptr() if d == 0 else None, **gkw))
    lib = build()["run_batch_sharded"]
    # every struct stays bound to a name until the last launch returns
    shards = [(ctypes.addressof(a), _stream(dev), dev)
              for a, dev in zip(args, mesh.devices)]

    def each(fn, *per) -> int:
        return _each(shards, "run_batch_sharded", fn, *per)

    for i in range(B):
        ii = [i] * mesh.size
        rc = each(lib.ktpu_shard_eval, ii)
        if not grp:
            glob = lean_exchange(mesh, locs)
            rc |= each(lib.ktpu_shard_select, ii, _ptrs(glob))
            gkey = pmax(mesh, keys)
            rc |= each(lib.ktpu_shard_apply, ii, _ptrs(gkey))
        else:
            g1 = exchange(mesh, locs, MAX_IC + 1)
            rc |= each(lib.ktpu_shard_geval, ii, _ptrs(g1))
            g2 = exchange(mesh, [b.loc2 for b in bufs],
                          int(bufs[0].loc2.shape[0]) - 4)
            g3 = g2
            if fam.spr_s:
                rc |= each(lib.ktpu_shard_graw, ii, _ptrs(g2))
                g3 = pmax(mesh, [b.loc3 for b in bufs])
            rc |= each(lib.ktpu_shard_gselect, ii, _ptrs(g2),
                        _ptrs(g3))
            gkey = pmax(mesh, keys)
            rc |= each(lib.ktpu_shard_gapply, ii, _ptrs(gkey))
            gown = psum(mesh, [b.own for b in bufs])
            rc |= each(lib.ktpu_shard_gupdate, ii, _ptrs(gkey),
                        _ptrs(gown))
        _raise_on(rc, "run_batch_sharded")
    return Shards(outs), out


USH_BLOCK = 256                # csrc/run_uniform_sharded.cu PBLOCK
USH_FUSED_SMEM = 96 * 1024     # launch 3 as one block up to this, and
USH_FUSED_ENTRIES = 8192       # up to this many matrix entries
USH_SORT_ALL = 4096            # csrc/run_uniform_sharded.cu SORT_ALL
USH_TOP_SMEM = 128 * 1024      # the sorted top-L in shared memory up to this


def uniform_sharded_fused(n_local: int, K_loc: int, J: int) -> bool:
    """Whether run_uniform_sharded.cu's launch 3 runs as one block (a
    shard's row keys, then its K_loc·J matrix keys, and its candidates in
    shared memory) rather than as the multi-block chain, whose matrix
    spreads over the card."""
    return (K_loc * J <= USH_FUSED_ENTRIES
            and max(n_local, K_loc * J) * 8 + K_loc * 4 <= USH_FUSED_SMEM)


def _uniform_sharded_run(cfg, mesh, na, carry, x, table, n_actual: int,
                         L: int, K: int, J: int, needed=None):
    """One sharded closed-form run (csrc/run_uniform_sharded.cu): the
    parts, the exchange of the counts and maxima, the selection
    launch(es), the all-gather of the keys and flags, the finalize with
    the verdict, each launch serving every shard of a device (up to
    four); with `needed` the gang tier. Returns (the output carries,
    shard 0's packed result)."""
    from ..parallel.sharding import (Shards, all_gather, lean_exchange,
                                     replicate, uniform_shape)
    what = "run_gang_sharded" if needed is not None else \
        "run_uniform_sharded"
    D = mesh.size
    n_local = na[0].cap.shape[0]
    if not (K >= 1 and J >= 1 and L >= 1):
        raise ValueError(f"{what}: bad shape L={L} K={K} J={J}")
    K_loc, L_loc, _M = uniform_shape(mesh, n_local, L, K, J)
    sig, tidx = int(x.sig), int(x.tidx)
    fused = uniform_sharded_fused(n_local, K_loc, J)
    top = _pow2(min(D * L_loc, L))
    top_global = D * L_loc > USH_SORT_ALL and top * 8 > USH_TOP_SMEM
    blocks = -(-n_local // USH_BLOCK)
    LOC = MAX_IC + 3
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    R = na[0].cap.shape[1]
    cfgc = _cfg_c(cfg, R)
    # the table on every card (the caller's tensors where it lies there
    # already), bound to a name until the launches return: the structs
    # hold only pointers
    tabs, tab_by = {}, replicate(mesh, table)
    for dev, tab_d in zip(mesh.devices, tab_by):
        if dev not in tabs:
            tabs[dev] = _table_c(tab_d, R, dev)
            if not 0 <= tidx < tabs[dev].U:
                raise ValueError(f"{what}: row {tidx} outside the table")
    packed = torch.empty((L + (2 if needed is None else 4),), dtype=i32,
                         device=mesh.devices[0])
    outs, args, keep, locs, sends = [], [], [], [], []
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        if node.N != n_local:
            raise ValueError(f"{what}: shards of unequal size")
        oc = _fresh_carry(carry[d])
        outs.append(oc)
        buf, ptr, off = _carve(dev, [
            ("loc", blocks * LOC, i64), ("send", L_loc + 2, i64),
            ("keys0", 0 if fused else n_local, i64),
            ("keys1", 0 if fused else K_loc * J, i64),
            ("sfit_kj", K_loc * J, i64), ("sbal_kj", K_loc * J, i64),
            ("top", top if top_global else 0, i64), ("cand", K_loc, i32),
            ("gcount", D * n_local, i32), ("fit_kj", K_loc * J, u8)])
        keep.append(buf)
        locs.append(buf[:blocks * LOC].view(blocks, LOC))
        sends.append(buf[off["send"]:off["send"] + L_loc + 2])
        args.append(UniShardC(
            na=node, tb=tabs[dev],
            cin=_carry_c(carry[d], n_local, R, dev),
            cout=_fresh_carry_c(oc, R), cfg=cfgc, sig=sig, tidx=tidx,
            offset=d * n_local, n_global=D * n_local, K=K_loc, J=J, L=L,
            L_loc=L_loc, n_actual=int(n_actual), fused=int(fused), **ptr))
    lib = build()["run_uniform_sharded"]
    # one launch a device for up to four of its shards: (device, stream,
    # batch struct, shard count, the first shard's index)
    groups = []
    for dev in mesh.distinct:
        ds = [d for d, dv in enumerate(mesh.devices) if dv == dev]
        for at in range(0, len(ds), USH_MAX_SHARDS):
            part = ds[at:at + USH_MAX_SHARDS]
            b = UniBatchC()
            for j, d in enumerate(part):
                b.s[j] = args[d]
            groups.append((dev, _stream(dev), b, len(part), part[0]))

    def launch(fn, extra):
        rc = 0
        for dev, st, b, S, first in groups:
            with torch.cuda.device(dev):
                rc |= fn(ctypes.addressof(b), S, *extra(dev, first), st)
        return rc

    rc = launch(lib.ktpu_ush_parts, lambda dev, first: (blocks,))
    glob = dict(zip(mesh.devices, lean_exchange(mesh, locs)))
    rc |= launch(lib.ktpu_ush_select,
                 lambda dev, first: (glob[dev].data_ptr(),))
    gathered = dict(zip(mesh.devices, all_gather(mesh, sends)))
    gang = needed is not None
    rc |= launch(lib.ktpu_ush_finalize, lambda dev, first: (
        gathered[dev].data_ptr(), D,
        packed.data_ptr() if first == 0 else None, 0 if first == 0 else -1,
        int(needed) if gang else 0, int(gang)))
    _raise_on(rc, what)
    return Shards(outs), packed


def run_uniform_sharded_cuda(cfg, mesh, na, carry, x, table, n_actual: int,
                             L: int, K: int, J: int):
    """The closed form over node shards (csrc/run_uniform_sharded.cu);
    same contract as parallel/sharding.py run_uniform_sharded: three
    launches a shard (more where a shard's keys outgrow one block) and
    two exchanges, the flags decided on every shard from the gathered
    keys."""
    out = _uniform_sharded_run(cfg, mesh, na, carry, x, table, n_actual, L,
                               K, J)
    LAUNCHES["run_uniform_sharded"] += 1
    return out


def scatter_rows_sharded_cuda(mesh, dev, staged):
    """The dirty-row upload onto the resident shards: the scatter_rows
    kernel once per shard that has rows (`staged[d]` = (local row ids,
    the shard's rows on its device) or None); a shard without rows keeps
    its arrays."""
    from ..parallel.sharding import Shards
    out = []
    for d, (s, p) in enumerate(zip(dev, staged)):
        if p is None:
            out.append(s)
            continue
        with torch.cuda.device(mesh.devices[d]):
            out.append(_scatter_rows_launch(s, p[0], p[1]))
    if any(p is not None for p in staged):
        LAUNCHES["scatter_rows_sharded"] += 1
    return Shards(out)


def probe_in_place(mesh) -> bool:
    """True when the mesh's probe reads its shards where they lie: every
    shard on one card (plan_sharded_placement "one"), at most
    PROBE_MAX_SHARDS of them. Otherwise the node columns are gathered onto
    the first device first; either way the probe is one launch."""
    return (plan_sharded_placement(mesh) == "one"
            and mesh.size <= PROBE_MAX_SHARDS)


def cluster_probe_sharded_cuda(mesh, na, carry, dom, ndom: int):
    """The cluster probe on the mesh (`dom` on the first device): on one
    card the probe kernel reads the D shards in place; on several cards
    the node columns are gathered onto the first device and the kernel
    runs there on the one shard they make. One launch a call."""
    from ..parallel import sharding as S
    cols = [[getattr(t, f) for t in tree]
            for tree, f in ((na, "cap"), (na, "valid"), (carry, "used"),
                            (carry, "npods"))]
    if not probe_in_place(mesh):
        cols = [[S.gather_rows(mesh, xs, mesh.devices[0])] for xs in cols]
    out = _cluster_probe_launch(*cols, dom, ndom)
    LAUNCHES["cluster_probe_sharded"] += 1
    return out


def statics_in_place(mesh) -> bool:
    """True when the mesh's surfaces are one launch over its shard table:
    every shard on one card (plan_sharded_placement "one"), at most
    WS_MAX_SHARDS of them. Otherwise each card launches on its shard
    twice, the image counts psum'd between."""
    return (plan_sharded_placement(mesh) == "one"
            and mesh.size <= WS_MAX_SHARDS)


def wave_statics_sharded_cuda(mesh, na, table, wt, feats=(True, True, True)):
    """The per-signature surfaces on the node shards; same contract as
    parallel/sharding.py wave_statics_sharded: on one card ONE launch
    (`_statics_sharded_one`), on several cards the launches a card with
    the psum between (`_statics_sharded_chain`)."""
    run = (_statics_sharded_one if statics_in_place(mesh)
           else _statics_sharded_chain)
    outs = run(mesh, na, table, wt, feats)
    LAUNCHES["wave_statics_sharded"] += 1
    return outs


def _statics_shards(mesh, na, table, wt) -> tuple:
    """(each shard's NodeC, each shard's TableC of the replicated table,
    the rows), checked before any build."""
    from ..parallel.sharding import replicate
    tabs = replicate(mesh, table)
    nodes = [_node_c(na[d], dev) for d, dev in enumerate(mesh.devices)]
    if any(n.R != nodes[0].R for n in nodes):
        raise ValueError("wave_statics_sharded: shards of unequal resource "
                         "width")
    # one table a device: replicate hands every shard of a device the same
    tab_d = {}
    for d, dev in enumerate(mesh.devices):
        if dev not in tab_d:
            tab_d[dev] = _table_c(tabs[d], nodes[d].R, dev)
    tab_c = [tab_d[dev] for dev in mesh.devices]
    return nodes, tab_c, _statics_rows(wt, tab_c[0].U,
                                       "wave_statics_sharded")


def _statics_sharded_one(mesh, na, table, wt, feats):
    """Shards on one card: ONE launch over the shard table, every shard
    read in place, the cluster-wide image counts summed inside it."""
    nodes, tab_c, rows = _statics_shards(mesh, na, table, wt)
    dev = mesh.devices[0]
    args, outs, _cnt = _statics_args(nodes, tab_c[0], rows, feats, dev)
    lib = build()["wave_statics"]
    with torch.cuda.device(dev):
        rc = lib.ktpu_wave_statics(ctypes.addressof(args), _stream(dev))
    RAW_LAUNCHES["wave_statics_sharded"] += 1
    _raise_on(rc, "wave_statics_sharded")
    return outs


def _statics_sharded_chain(mesh, na, table, wt, feats):
    """Shards on several cards: with images, each card's counts (the
    table of its one shard, `cnt_out`), their psum, then each card's
    surfaces from the summed counts (`cnt_in`); without, one launch a
    card. Every launch is counted in RAW_LAUNCHES where it is made."""
    from ..parallel.sharding import psum
    nodes, tab_c, rows = _statics_shards(mesh, na, table, wt)
    width = len(rows) * (tab_c[0].IC + 1) if feats[2] else 0
    per = [_statics_args([nodes[d]], tab_c[d], rows, feats, dev, width)
           for d, dev in enumerate(mesh.devices)]
    lib = build()["wave_statics"]
    rc = 0
    # the summed counts stay bound until the launches return
    glob = []
    if width:
        for d, dev in enumerate(mesh.devices):
            counting = StaticsArgsC.from_buffer_copy(per[d][0])
            counting.cnt_out = per[d][2].data_ptr()
            with torch.cuda.device(dev):
                rc |= lib.ktpu_wave_statics(ctypes.addressof(counting),
                                            _stream(dev))
            RAW_LAUNCHES["wave_statics_sharded"] += 1
        glob = psum(mesh, [cnt for _a, _o, cnt in per])
        for d in range(mesh.size):
            per[d][0].cnt_in = glob[d].data_ptr()
    for d, dev in enumerate(mesh.devices):
        with torch.cuda.device(dev):
            rc |= lib.ktpu_wave_statics(ctypes.addressof(per[d][0]),
                                        _stream(dev))
        RAW_LAUNCHES["wave_statics_sharded"] += 1
    _raise_on(rc, "wave_statics_sharded")
    return [outs[0] for _args, outs, _cnt in per]


def _check_statics(statics, S: int, N: int, dev, what: str) -> list:
    stat = [_check(t, f"statics[{k}]", dt, 2, dev) for k, (t, dt) in
            enumerate(zip(statics, (torch.bool, torch.int64, torch.int64,
                                    torch.int64)))]
    if any(tuple(t.shape) != (S, N) for t in statics):
        raise ValueError(f"{what}: statics must be [{S}, {N}] each")
    return stat


def _each(shards, raw: str, fn, *per) -> int:
    """fn(struct, *per-shard args, stream) on every shard, each under its
    device, each launch counted in RAW_LAUNCHES[raw]; the OR of the
    return codes."""
    rc = 0
    for k, (a, st, dev) in enumerate(shards):
        with torch.cuda.device(dev):
            rc |= fn(a, *(x[k] for x in per), st)
        RAW_LAUNCHES[raw] += 1
    return rc


def _ptrs(xs) -> list:
    return [x.data_ptr() for x in xs]


def plan_sharded_placement(mesh) -> str:
    """"one" when every shard of the mesh lies on one card, where the plan
    span is one cooperative launch; "cards" when the shards span several
    cards, whose launches cannot meet at a grid barrier: the host-driven
    chain."""
    return "one" if len(mesh.distinct) == 1 else "cards"


def run_plan_sharded_cuda(cfg, mesh, na, carry, xs, table, wt, gd, statics,
                          fam, norm_live: bool, has_groups: bool,
                          has_ports: bool):
    """The plan program over node shards (csrc/run_plan_sharded.cu); same
    contract as parallel/sharding.py run_plan_sharded. Shards on one card
    (plan_sharded_placement "one"): one cooperative launch a span. Shards
    on several cards: the chain of launches a shard, driven from the host.
    The output carries hold fresh copies of every field the kernels
    write."""
    W = xs.valid.shape[0]
    rows = _plan_rows(wt, W, "run_plan_sharded")
    if xs.widx.shape[0] != W:
        raise ValueError("run_plan_sharded: xs.valid / xs.widx lengths "
                         "differ")
    n_local = na[0].cap.shape[0]
    if any(s.cap.shape[0] != n_local for s in na):
        raise ValueError("run_plan_sharded: shards of unequal size")
    run = (_plan_sharded_one if plan_sharded_placement(mesh) == "one"
           else _plan_sharded_chain)
    out = run(cfg, mesh, na, carry, xs, table, rows, gd, statics, fam,
              norm_live, has_groups, has_ports)
    LAUNCHES["run_plan_sharded"] += 1
    return out


def _plan_sharded_one(cfg, mesh, na, carry, xs, table, rows, gd, statics,
                      fam, norm_live, has_groups, has_ports):
    """Every shard on one card: the span in one cooperative launch of D
    teams of T blocks (csrc/run_plan_sharded.cu ktpu_plan_span_grid). The
    shards' PlanNodesC go to the card through pinned memory; the scratch
    (partial slots, flags, each shard's surfaces) is one buffer."""
    from ..parallel.sharding import Shards, replicate
    dev, D = mesh.devices[0], mesh.size
    n_local, S = na[0].cap.shape[0], len(rows)
    xs_d, table_d = replicate(mesh, xs)[0], replicate(mesh, table)[0]
    xs_p = _plan_xs(xs_d, dev)
    nodes, outs, tab = [], [], None
    for d in range(D):
        nd, out, SC, tab = _plan_shard(
            cfg, na[d], carry[d], table_d, rows,
            gd[d] if has_groups else None, statics[d], fam, has_groups,
            has_ports, dev, "run_plan_sharded", offset=d * n_local)
        nodes.append(nd)
        outs.append(out)
    lib = build()["run_plan_sharded"]
    T = _grid_blocks(n_local, D, dev, "run_plan_sharded")
    spread_s = bool(has_groups and fam.spr_s)
    _scratch, ptr, _offs = _carve(dev, plan_span_parts(
        S, n_local, D, SC, spread_s, D * T))
    for d, nd in enumerate(nodes):
        _set_scratch(nd, ptr, d)
    nodes_dev = _nodes_dev((PlanNodesC * D)(*nodes), dev)
    packed = torch.empty((xs.valid.shape[0] + 2,), dtype=torch.int32,
                         device=dev)
    span = _plan_span_c(cfg, tab, nodes[0].na.R, xs_p, xs.valid.shape[0],
                        rows, fam, norm_live, has_groups, has_ports,
                        carry[0].ports.shape[1], n_local, D, ptr, packed)
    with torch.cuda.device(dev):
        rc = lib.ktpu_plan_span_grid(ctypes.addressof(span),
                                     nodes_dev.data_ptr(), D, T,
                                     _stream(dev))
    _raise_on(rc, "run_plan_sharded")
    RAW_LAUNCHES["run_plan_sharded"] += 1
    return Shards(outs), packed


def _plan_sharded_chain(cfg, mesh, na, carry, xs, table, rows, gd, statics,
                        fam, norm_live, has_groups, has_ports):
    """Shards on several cards: per shard, init; per evaluation (the S
    speculative choices, then each pod): the spread minima and their
    exchange (DoNotSchedule rows), eval and the exchange of the maxima and
    score partials, the raw spread pass and its exchange (ScheduleAnyway
    rows), select and the max of the keys, apply, and on a group span the
    sum of the own vectors and the update."""
    from ..parallel.sharding import (Shards, exchange, pmax, psum,
                                     replicate)
    from .program import Carry
    S = len(rows)
    W = xs.valid.shape[0]
    xs_r, tabs = replicate(mesh, xs), replicate(mesh, table)
    n_local = na[0].cap.shape[0]
    n_global = n_local * mesh.size
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    famc = _fam_c(fam) if has_groups else FamC()
    wt_c = (_I * MAX_PLAN_SLOTS)(*(rows + [0] * (MAX_PLAN_SLOTS - S)))
    args, bufs, outs = [], [], []
    packed = None
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        N, R = node.N, node.R
        tab = _table_c(tabs[d], R, dev)
        if any(not 0 <= u < tab.U for u in rows):
            raise ValueError(f"run_plan_sharded: rows {rows} outside the "
                             "table")
        valid_p = _check(xs_r[d].valid, "xs.valid", torch.bool, 1, dev)
        widx_p = _check(xs_r[d].widx, "xs.widx", torch.int32, 1, dev)
        stat = _check_statics(statics[d], S, N, dev, "run_plan_sharded")
        c = carry[d]
        _carry_c(c, N, R, dev)
        if has_groups:
            g = _groups_c(gd[d], N, dev)
            if any(u >= g.U for u in rows) or g.U > tab.U:
                raise ValueError(f"run_plan_sharded: rows {rows} outside "
                                 "the group tables")
            gout_t = _clone_groups(c.groups)
            gout = _gcarry_c(gout_t, g, dev, fresh=True)
            SC, own_n = g.SC, _own_len(g)
        else:
            g, gout, gout_t, SC, own_n = GroupsC(), GCarryC(), c.groups, 0, 1
        used, nz, npods = (c.used.clone(), c.nonzero_used.clone(),
                           c.npods.clone())
        ports = c.ports.clone() if has_ports else c.ports
        b = SimpleNamespace(
            fit_ok=torch.empty((S * N,), dtype=u8, device=dev),
            s_fit=torch.empty((S * N,), dtype=i64, device=dev),
            s_bal=torch.empty((S * N,), dtype=i64, device=dev),
            feas=torch.empty((N,), dtype=u8, device=dev),
            gsc=torch.empty((N,), dtype=i64, device=dev),
            loc1=torch.zeros((max(SC, 1),), dtype=i64, device=dev),
            loc2=torch.zeros((1 + SC * n_global + 4,), dtype=i64,
                             device=dev),
            loc3=torch.zeros((2,), dtype=i64, device=dev),
            key=torch.empty((1,), dtype=i64, device=dev),
            own=torch.zeros((own_n,), dtype=i64, device=dev),
            ctl=torch.empty((MAX_PLAN_SLOTS + 3,), dtype=i32, device=dev))
        if d == 0:
            packed = torch.empty((W + 2,), dtype=i32, device=dev)
        bufs.append(b)
        args.append(PlanShardC(
            na=node, tb=tab, cfg=_cfg_c(cfg, R), g=g, gc=gout, fam=famc,
            used=used.data_ptr(), nonzero_used=nz.data_ptr(),
            npods=npods.data_ptr(), ports=ports.data_ptr(),
            P=c.ports.shape[1], m0=stat[0], taint_raw=stat[1],
            na_raw=stat[2], s_img=stat[3], valid=valid_p, widx=widx_p,
            wt=wt_c, S=S, W=W, norm_live=int(bool(norm_live)),
            has_groups=int(bool(has_groups)),
            has_ports=int(bool(has_ports)), w_spread=cfg.w_spread,
            w_ipa=cfg.w_ipa, offset=d * n_local, n_global=n_global,
            packed=packed.data_ptr() if d == 0 else None,
            **{k: t.data_ptr() for k, t in vars(b).items()}))
        outs.append(Carry(used=used, nonzero_used=nz, npods=npods,
                          ports=ports, cache=c.cache._replace(
                              sig=torch.zeros((), dtype=i32, device=dev)),
                          groups=gout_t))
    lib = build()["run_plan_sharded"]
    # every struct stays bound to a name until the last launch returns
    shards = [(ctypes.addressof(a), _stream(dev), dev)
              for a, dev in zip(args, mesh.devices)]
    D = mesh.size
    n_sum = int(bufs[0].loc2.shape[0]) - 4
    spr_f = has_groups and fam.spr_f
    spr_s = has_groups and fam.spr_s

    def each(fn, *per) -> int:
        return _each(shards, "run_plan_sharded", fn, *per)

    def evaluate(k: int, spec: int) -> tuple:
        # (k, spec): the speculative choice of slot `spec`, or (spec = -1)
        # pod k's step, its slot read from widx on the device
        ks = ([k] * D, [spec] * D)
        rc = 0
        g1 = [b.loc1 for b in bufs]
        if spr_f:
            rc |= each(lib.ktpu_plan_shard_min, *ks)
            g1 = pmax(mesh, g1)
        rc |= each(lib.ktpu_plan_shard_eval, *ks, _ptrs(g1))
        g2 = exchange(mesh, [b.loc2 for b in bufs], n_sum)
        g3 = g2
        if spr_s:
            rc |= each(lib.ktpu_plan_shard_raw, *ks, _ptrs(g2))
            g3 = pmax(mesh, [b.loc3 for b in bufs])
        rc |= each(lib.ktpu_plan_shard_select, *ks, _ptrs(g2), _ptrs(g3))
        gkey = pmax(mesh, [b.key for b in bufs])
        return rc | each(lib.ktpu_plan_shard_apply, *ks, _ptrs(gkey)), gkey

    rc = each(lib.ktpu_plan_shard_init)
    for s in range(S):
        rc |= evaluate(0, s)[0]
    for k in range(W):
        r, gkey = evaluate(k, -1)
        rc |= r
        if has_groups:
            gown = psum(mesh, [b.own for b in bufs])
            rc |= each(lib.ktpu_plan_shard_update, [k] * D, _ptrs(gkey),
                       _ptrs(gown))
        _raise_on(rc, "run_plan_sharded")
    _raise_on(rc, "run_plan_sharded")
    return Shards(outs), packed


def run_gang_sharded_cuda(cfg, mesh, na, carry, xs, table, wt, needed: int,
                          dom, statics, w_contig: int):
    """The gang scan tier over node shards (csrc/run_gang_sharded.cu); same
    contract as parallel/sharding.py run_gang_sharded (scan tier). Shards
    on one card (plan_sharded_placement "one"): one cooperative launch a
    gang. Shards on several cards: the chain of launches a shard, driven
    from the host. The output carries hold fresh used / nonzero_used /
    npods and a fresh signature scalar; the rest of the SigCache, the
    ports and the group counts are the input's (the kernels never write
    them). Every argument is checked before the kernels are built."""
    rows = [int(u) for u in wt]
    if len(rows) < 1 or xs.valid.shape[0] < 1:
        raise ValueError("run_gang_sharded: an empty gang or signature set")
    n_local = na[0].cap.shape[0]
    if any(s.cap.shape[0] != n_local for s in na):
        raise ValueError("run_gang_sharded: shards of unequal size")
    run = (_gang_sharded_one if plan_sharded_placement(mesh) == "one"
           else _gang_sharded_chain)
    out = run(cfg, mesh, na, carry, xs, table, rows, int(needed), dom,
              statics, int(w_contig))
    LAUNCHES["run_gang_sharded"] += 1
    return out


def _gang_sharded_one(cfg, mesh, na, carry, xs, table, rows, needed: int,
                      dom, statics, w_contig: int):
    """Every shard on one card: the gang in one cooperative launch of D
    teams of T blocks (csrc/run_gang_sharded.cu ktpu_gang_span_grid). The
    shards' GangNodesC go to the card through pinned memory; the scratch
    (the partial slots, each shard's fit surfaces) is one buffer."""
    from ..parallel.sharding import Shards, replicate
    from .program import Carry
    dev, D = mesh.devices[0], mesh.size
    S, B = len(rows), xs.valid.shape[0]
    n_local = na[0].cap.shape[0]
    xs_d, table_d = replicate(mesh, xs)[0], replicate(mesh, table)[0]
    i32, i64 = torch.int32, torch.int64
    xs_p = {f: _check(getattr(xs_d, f), f"xs.{f}", dt, 1, dev)
            for f, dt in (("valid", torch.bool), ("tidx", i32),
                          ("widx", i32))}
    if xs_d.tidx.shape[0] != B or xs_d.widx.shape[0] != B:
        raise ValueError("run_gang_sharded: xs.valid / tidx / widx lengths "
                         "differ")
    tab = _table_c(table_d, na[0].cap.shape[1], dev)
    if any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"run_gang_sharded: rows {rows} outside the table")
    nodes, outs = [], []
    for d in range(D):
        node = _node_c(na[d], dev)
        dom_p = _check(dom[d], "dom", i32, 1, dev)
        if dom[d].shape[0] != n_local:
            raise ValueError(f"run_gang_sharded: dom shards must be "
                             f"[{n_local}]")
        stat = _check_statics(statics[d], S, n_local, dev,
                              "run_gang_sharded")
        c = carry[d]
        cin = _carry_c(c, n_local, node.R, dev)
        used, nz = torch.empty_like(c.used), torch.empty_like(c.nonzero_used)
        npods, sig = torch.empty_like(c.npods), torch.empty_like(c.cache.sig)
        nodes.append(GangNodesC(
            na=node, used_in=cin.used, nz_in=cin.nonzero_used,
            npods_in=cin.npods, sig_in=cin.cache.sig, used=used.data_ptr(),
            nonzero_used=nz.data_ptr(), npods=npods.data_ptr(),
            sig_out=sig.data_ptr(), m0=stat[0], taint_raw=stat[1],
            na_raw=stat[2], s_img=stat[3], dom=dom_p, offset=d * n_local))
        outs.append(Carry(used=used, nonzero_used=nz, npods=npods,
                          ports=c.ports, cache=c.cache._replace(sig=sig),
                          groups=c.groups))
    R = nodes[0].na.R
    cfgc = _cfg_c(cfg, R)
    lib = build()["run_gang_sharded"]
    T = _grid_blocks(n_local, D, dev, "run_gang_sharded")
    _scratch, ptr, _offs = _carve(dev, gang_span_parts(S, n_local, D,
                                                       D * T))
    for d, nd in enumerate(nodes):
        _set_scratch(nd, ptr, d)
    wt_t = torch.tensor(rows, dtype=i32).pin_memory().to(dev,
                                                          non_blocking=True)
    nodes_dev = _nodes_dev((GangNodesC * D)(*nodes), dev)
    packed = torch.empty((B + 4,), dtype=i32, device=dev)
    span = GangSpanC(
        tb=tab, cfg=cfgc, valid=xs_p["valid"], tidx=xs_p["tidx"],
        widx=xs_p["widx"], wt=wt_t.data_ptr(), S=S, B=B, needed=needed,
        w_contig=w_contig, n_local=n_local, D=D, part=ptr["part"],
        packed=packed.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.ktpu_gang_span_grid(ctypes.addressof(span),
                                     nodes_dev.data_ptr(), D, T,
                                     _stream(dev))
    _raise_on(rc, "run_gang_sharded")
    RAW_LAUNCHES["run_gang_sharded"] += 1
    return Shards(outs), packed


def gang_span_parts(S: int, n_local: int, D: int, blocks: int) -> list:
    """The scratch pieces of one gang launch over D shards of one card, in
    carve order: the grid team's partial slots [2, blocks, PLAN_RED_K],
    then each shard's fit surfaces [S, n_local] (a block's contiguity
    counts live in its shared memory)."""
    i64, u8 = torch.int64, torch.uint8
    parts = [("part", 2 * blocks * PLAN_RED_K, i64)]
    for d in range(D):
        parts += [(f"s_fit{d}", S * n_local, i64),
                  (f"s_bal{d}", S * n_local, i64),
                  (f"fit_ok{d}", S * n_local, u8)]
    return parts


def _gang_sharded_chain(cfg, mesh, na, carry, xs, table, rows, needed: int,
                        dom, statics, w_contig: int):
    """Shards on several cards: per shard, init; per member: eval and the
    max of the maxima, select and the max of the keys, apply, and with
    w_contig the sum of the chosen domain ids and the update; then the
    verdict."""
    from ..parallel.sharding import Shards, pmax, psum, replicate
    from .program import Carry
    S = len(rows)
    B = xs.valid.shape[0]
    xs_r, tabs = replicate(mesh, xs), replicate(mesh, table)
    n_local = na[0].cap.shape[0]
    n_global = n_local * mesh.size
    i32, i64 = torch.int32, torch.int64
    args, bufs, outs = [], [], []
    packed = None
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        N, R = node.N, node.R
        if N != n_local:
            raise ValueError("run_gang_sharded: shards of unequal size")
        tab = _table_c(tabs[d], R, dev)
        if any(not 0 <= u < tab.U for u in rows):
            raise ValueError(f"run_gang_sharded: rows {rows} outside the "
                             "table")
        ptrs = {f: _check(getattr(xs_r[d], f), f"xs.{f}", dt, 1, dev)
                for f, dt in (("valid", torch.bool), ("tidx", i32),
                              ("widx", i32))}
        if xs_r[d].tidx.shape[0] != B or xs_r[d].widx.shape[0] != B:
            raise ValueError("run_gang_sharded: xs.valid / tidx / widx "
                             "lengths differ")
        dom_p = _check(dom[d], "dom", i32, 1, dev)
        if dom[d].shape[0] != N:
            raise ValueError(f"run_gang_sharded: dom shards must be [{N}]")
        stat = _check_statics(statics[d], S, N, dev, "run_gang_sharded")
        c = carry[d]
        cin = _carry_c(c, N, R, dev)
        used, nz = torch.empty_like(c.used), torch.empty_like(c.nonzero_used)
        npods, sig = torch.empty_like(c.npods), torch.empty_like(c.cache.sig)
        b = SimpleNamespace(
            wt=torch.tensor(rows, dtype=i32).pin_memory().to(
                dev, non_blocking=True),
            fit_ok=torch.empty((S * N,), dtype=torch.uint8, device=dev),
            s_fit=torch.empty((S * N,), dtype=i64, device=dev),
            s_bal=torch.empty((S * N,), dtype=i64, device=dev),
            domcnt=torch.empty((n_global,), dtype=i32, device=dev),
            placed=torch.empty((1,), dtype=i32, device=dev),
            loc=torch.empty((3,), dtype=i64, device=dev),
            key=torch.empty((1,), dtype=i64, device=dev),
            own=torch.zeros((1,), dtype=i64, device=dev))
        if d == 0:
            packed = torch.empty((B + 4,), dtype=i32, device=dev)
        bufs.append(b)
        args.append(GangShardC(
            na=node, tb=tab, cfg=_cfg_c(cfg, R), used_in=cin.used,
            nz_in=cin.nonzero_used, npods_in=cin.npods, sig_in=cin.cache.sig,
            used=used.data_ptr(), nonzero_used=nz.data_ptr(),
            npods=npods.data_ptr(), sig_out=sig.data_ptr(), m0=stat[0],
            taint_raw=stat[1], na_raw=stat[2], s_img=stat[3], dom=dom_p,
            S=S, B=B, needed=int(needed), w_contig=int(w_contig),
            offset=d * n_local, n_global=n_global,
            packed=packed.data_ptr() if d == 0 else None, **ptrs,
            **{k: t.data_ptr() for k, t in vars(b).items()}))
        outs.append(Carry(used=used, nonzero_used=nz, npods=npods,
                          ports=c.ports, cache=c.cache._replace(sig=sig),
                          groups=c.groups))
    lib = build()["run_gang_sharded"]
    # every struct stays bound to a name until the last launch returns
    shards = [(ctypes.addressof(a), _stream(dev), dev)
              for a, dev in zip(args, mesh.devices)]
    D = mesh.size

    def each(fn, *per) -> int:
        return _each(shards, "run_gang_sharded", fn, *per)

    rc = each(lib.ktpu_gang_shard_init)
    for k in range(B):
        rc |= each(lib.ktpu_gang_shard_eval, [k] * D)
        glob = pmax(mesh, [b.loc for b in bufs])
        rc |= each(lib.ktpu_gang_shard_select, [k] * D, _ptrs(glob))
        gkey = pmax(mesh, [b.key for b in bufs])
        rc |= each(lib.ktpu_gang_shard_apply, [k] * D, _ptrs(gkey))
        if w_contig:
            gown = psum(mesh, [b.own for b in bufs])
            rc |= each(lib.ktpu_gang_shard_update, [k] * D,
                        _ptrs(gkey), _ptrs(gown))
        _raise_on(rc, "run_gang_sharded")
    rc |= each(lib.ktpu_gang_shard_verdict)
    _raise_on(rc, "run_gang_sharded")
    return Shards(outs), packed


def run_gang_uniform_sharded_cuda(cfg, mesh, na, carry, x, table,
                                  n_actual: int, needed: int, L: int, K: int,
                                  J: int):
    """The closed-form gang tier over node shards: run_uniform_sharded's
    launches and exchanges with the verdict inside each shard's finalize,
    decided before the carry is written (a rejected gang's output carry
    equals its input); same contract as parallel/sharding.py
    run_gang_sharded(uniform=True). Shard 0's packed [L + 4] is returned."""
    out = _uniform_sharded_run(cfg, mesh, na, carry, x, table, n_actual, L,
                               K, J, needed=int(needed))
    LAUNCHES["run_gang_uniform_sharded"] += 1
    return out
