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
           "run_batch_sharded", "run_uniform_sharded")

# launches per wrapper since the last reset (one per kernel-wrapper call);
# run_batch counts its lean mode, its group mode and its overlay variant
# under three keys, run_uniform its lean and its overlay variant under
# two; run_gang counts its scan tier, and its closed-form tier (built in
# run_uniform.cu) counts under run_gang_uniform; the mesh's programs
# count once per sharded call (their launches on every shard), the scatter
# and the probe on the mesh under their own keys
LAUNCHES = {name: 0 for name in SOURCES + ("run_batch_groups",
                                           "run_batch_ovl",
                                           "run_uniform_ovl",
                                           "run_gang_uniform",
                                           "scatter_rows_sharded",
                                           "cluster_probe_sharded")}

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
MAX_PLAN_SLOTS = 32       # csrc/run_plan.cu KT_PLAN_MAX_S
MAX_DRY_R = 64            # csrc/dry_run.cu KT_DRY_MAX_R
MAX_DRY_V = 128           # victim slots (Evaluator.MAX_BATCHED_VICTIMS)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


class WaveRowsC(ctypes.Structure):
    _fields_ = [("u", _I * MAX_WAVE_ROWS)]


class ScatterField(ctypes.Structure):
    _fields_ = [("dst", _P), ("base", _P), ("rows", _P),
                ("row_units", ctypes.c_int64), ("unit_bytes", _I),
                ("pad", _I)]


class ScatterC(ctypes.Structure):
    _fields_ = [("f", ScatterField * MAX_SCATTER_FIELDS), ("nf", _I),
                ("N", _I), ("D", _I)]


_WAVE_SCRATCH = ("f_cnt", "veto", "aa_cnt", "cnt_n", "cnt_add", "gmask",
                 "feas", "masked", "gsc", "flags", "seg", "elig_dom",
                 "keys0", "cand", "keys1", "node_i", "j_i", "gate", "dom_ic",
                 "newcnt", "lvlmask")


_PLAN_SCRATCH = ("fit_ok", "s_fit", "s_bal", "f_cnt", "s_cnt", "veto",
                 "a_cnt", "a_total", "aa_cnt", "iscore", "cnt_sn", "feas",
                 "gsc", "flags", "seg")


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
                + [(f, _P) for f in _WAVE_SCRATCH]
                + [("P0", _I), ("P1", _I), ("packed", _P)])


class PlanArgsC(ctypes.Structure):
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cfg", CfgC),
                 ("g", GroupsC), ("gin", GCarryC), ("gout", GCarryC),
                 ("fam", FamC)]
                + [(f, _P) for f in ("used", "nonzero_used", "npods",
                                     "ports")]
                + [("P", _I)]
                + [(f, _P) for f in ("m0", "taint_raw", "na_raw", "s_img",
                                     "valid", "widx")]
                + [("wt", _I * MAX_PLAN_SLOTS)]
                + [(f, _I) for f in ("S", "W", "norm_live", "has_groups",
                                     "has_ports")]
                + [("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64)]
                + [(f, _P) for f in _PLAN_SCRATCH]
                + [("packed", _P)])


class DryArgsC(ctypes.Structure):
    _fields_ = ([("na", NodeC), ("tb", TableC)]
                + [(f, _P) for f in ("used", "npods", "cand", "victim_req",
                                     "victim_valid", "ovl_used",
                                     "ovl_npods")]
                + [(f, _I) for f in ("C", "V", "has_spread")]
                + [(f, _P) for f in ("max_skew", "self_match", "min_zero",
                                     "tv_ok", "cnt0", "other_min",
                                     "vic_match")]
                + [("SC", _I), ("out", _P)])


class GangArgsC(ctypes.Structure):
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cfg", CfgC)]
                + [(f, _P) for f in (
                    "used_in", "nz_in", "npods_in", "sig_in", "used",
                    "nonzero_used", "npods", "sig_out", "m0", "taint_raw",
                    "na_raw", "s_img", "valid", "tidx", "widx", "wt",
                    "dom")]
                + [(f, _I) for f in ("S", "B", "needed", "w_contig")]
                + [(f, _P) for f in ("fit_ok", "s_fit", "s_bal", "domcnt",
                                     "packed")])


class DiagArgsC(ctypes.Structure):
    _fields_ = [("na", NodeC), ("tb", TableC), ("used", _P), ("npods", _P),
                ("ports", _P), ("P", _I), ("tidx", _I), ("has_groups", _I),
                ("g", GroupsC), ("gc", GCarryC), ("fam", FamC),
                ("slot", _P), ("pods_fail", _P), ("cols_fail", _P)]


class ProbeArgsC(ctypes.Structure):
    _fields_ = ([(f, _P) for f in ("cap", "valid", "used", "npods", "dom")]
                + [(f, _I) for f in ("N", "R", "ndom")]
                + [(f, _P) for f in ("tight", "dom_pods", "dom_nodes",
                                     "per_res", "dom_stats",
                                     "valid_count")])


class ShardStepC(ctypes.Structure):
    """csrc/run_batch_sharded.cu ShardStepC."""
    _fields_ = [("na", NodeC), ("tb", TableC), ("c", CarryC), ("cfg", CfgC),
                ("valid", _P), ("sig", _P), ("tidx", _P), ("offset", _I),
                ("loc", _P), ("key", _P), ("out", _P)]


class UniShardC(ctypes.Structure):
    """csrc/run_uniform_sharded.cu UniShardC."""
    _fields_ = ([("na", NodeC), ("tb", TableC), ("cin", CarryC),
                 ("cout", CarryC), ("cfg", CfgC)]
                + [(f, _I) for f in ("sig", "tidx", "offset", "n_global",
                                     "K", "J", "L", "n_actual")]
                + [("loc", _P), ("static_add", _P), ("keys0", _P),
                   ("P0", _I), ("cand", _P), ("keys1", _P), ("P1", _I)]
                + [(f, _P) for f in ("fit_kj", "sfit_kj", "sbal_kj",
                                     "counts", "flags", "packed")])


class ScoreProbeArgsC(ctypes.Structure):
    _fields_ = [("na", NodeC), ("tb", TableC), ("cfg", CfgC),
                ("used", _P), ("nonzero_used", _P), ("tidx", _I),
                ("total", _P), ("std", _P)]


class ExplainArgsC(ctypes.Structure):
    _fields_ = [("na", NodeC), ("tb", TableC), ("c", CarryC), ("cfg", CfgC),
                ("g", GroupsC), ("gc", GCarryC), ("fam", FamC),
                ("has_groups", _I), ("tidx", _I), ("k", _I),
                ("w_spread", ctypes.c_int64), ("w_ipa", ctypes.c_int64)] + [
        (f, _P) for f in ("gmask", "flags", "gsc", "masked", "idx", "totals",
                          "cols", "feasible")]


def _bind(name: str, lib):
    if name == "run_batch":
        lib.ktpu_run_batch.argtypes = (
            [_P] * 7 + [_I, ctypes.c_int64, ctypes.c_int64] + [_P] * 9
            + [_I, _P, _P])
        lib.ktpu_run_batch.restype = ctypes.c_int
    elif name == "run_uniform":
        lib.ktpu_run_uniform.argtypes = (
            [_P] * 5 + [_I] * 6 + [_P, _P, _I, _P, _P, _I] + [_P] * 9)
        lib.ktpu_run_uniform.restype = ctypes.c_int
        lib.ktpu_run_gang_uniform.argtypes = (
            [_P] * 5 + [_I] * 7 + [_P, _P, _I, _P, _P, _I] + [_P] * 8)
        lib.ktpu_run_gang_uniform.restype = ctypes.c_int
    elif name == "scatter_rows":
        lib.ktpu_scatter_rows.argtypes = [_P, _P, _P]
        lib.ktpu_scatter_rows.restype = ctypes.c_int
    elif name == "wave_statics":
        lib.ktpu_wave_statics.argtypes = [_P, _P, _P] + [_I] * 4 + [_P] * 6
        lib.ktpu_wave_statics.restype = ctypes.c_int
    elif name == "run_wave":
        lib.ktpu_run_wave.argtypes = [_P, _P]
        lib.ktpu_run_wave.restype = ctypes.c_int
    elif name == "run_plan":
        lib.ktpu_run_plan.argtypes = [_P, _P]
        lib.ktpu_run_plan.restype = ctypes.c_int
    elif name == "dry_run":
        lib.ktpu_dry_run.argtypes = [_P, _P]
        lib.ktpu_dry_run.restype = ctypes.c_int
    elif name == "run_gang":
        lib.ktpu_run_gang.argtypes = [_P, _P]
        lib.ktpu_run_gang.restype = ctypes.c_int
    elif name == "cluster_probe":
        lib.ktpu_cluster_probe.argtypes = [_P, _P]
        lib.ktpu_cluster_probe.restype = ctypes.c_int
    elif name == "explain_row":
        lib.ktpu_explain_row.argtypes = [_P, _P]
        lib.ktpu_explain_row.restype = ctypes.c_int
    elif name == "score_probe":
        lib.ktpu_score_probe.argtypes = [_P, _P]
        lib.ktpu_score_probe.restype = ctypes.c_int
    elif name == "run_batch_sharded":
        lib.ktpu_shard_eval.argtypes = [_P, _I, _P]
        lib.ktpu_shard_select.argtypes = [_P, _I, _P, _P]
        lib.ktpu_shard_apply.argtypes = [_P, _I, _P, _P]
        for f in ("ktpu_shard_eval", "ktpu_shard_select", "ktpu_shard_apply"):
            getattr(lib, f).restype = ctypes.c_int
    elif name == "run_uniform_sharded":
        lib.ktpu_uniform_shard_parts.argtypes = [_P, _P]
        lib.ktpu_uniform_shard_topk.argtypes = [_P, _P, _P]
        lib.ktpu_uniform_merge.argtypes = [_P, _I, _P, _I, _P]
        lib.ktpu_uniform_shard_finalize.argtypes = [_P, _P, _P]
        for f in ("ktpu_uniform_shard_parts", "ktpu_uniform_shard_topk",
                  "ktpu_uniform_merge", "ktpu_uniform_shard_finalize"):
            getattr(lib, f).restype = ctypes.c_int
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


def _node_c(na, device) -> NodeC:
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


def _cache_c(cache, N: int, device) -> CacheC:
    ptrs = {}
    for f, (dtype, rank) in _CACHE_SPEC.items():
        t = getattr(cache, f)
        ptrs[f] = _check(t, f"cache.{f}", dtype, rank, device)
        if rank and t.shape[0] != N:
            raise ValueError(f"cache.{f}: length {t.shape[0]}, expected {N}")
    return CacheC(**ptrs)


def _carry_c(carry, N: int, R: int, device) -> CarryC:
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
                  cache=_cache_c(carry.cache, N, device))


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


def _table_c(table, R: int, device) -> TableC:
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


def _groups_c(gd, N: int, device) -> GroupsC:
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


def _gcarry_c(gc, g: GroupsC, device) -> GCarryC:
    ptrs = {f: _check(getattr(gc, f), f"groups.{f}", *spec, device)
            for f, spec in _GCARRY_SPEC.items()}
    U, SC, TA, TAA, N = g.U, g.SC, g.TA, g.TAA, g.N
    want = {"spr_f_cnt": (U, SC, N), "spr_f_min_zero": (U, SC),
            "spr_s_cnt": (U, SC, N), "ipa_veto": (U, N),
            "ipa_a_cnt": (U, TA, N), "ipa_a_total": (U,),
            "ipa_aa_cnt": (U, TAA, N), "ipa_score": (U, N)}
    for f, shape in want.items():
        if tuple(getattr(gc, f).shape) != shape:
            raise ValueError(f"groups.{f}: {tuple(getattr(gc, f).shape)}, "
                             f"expected {shape}")
    return GCarryC(**ptrs)


def _fam_c(fam) -> FamC:
    return FamC(*(int(bool(x)) for x in fam))


def _clone_groups(gc):
    return type(gc)(*(t.clone() for t in gc))


def _out_carry(carry, scan: bool):
    """The carry a kernel writes in place: copies of the fields it
    updates, because the input carry may still be held for rewind. The
    scan (run_batch) writes port ids, group counts and starts from the
    input SigCache, so all are copied; run_uniform never writes ports or
    group counts, which stay shared, and writes its SigCache in full,
    which starts uninitialised."""
    from .program import Carry, SigCache
    fresh = torch.Tensor.clone if scan else torch.empty_like
    groups = carry.groups
    if scan and groups is not None:
        groups = _clone_groups(groups)
    return Carry(used=carry.used.clone(),
                 nonzero_used=carry.nonzero_used.clone(),
                 npods=carry.npods.clone(),
                 ports=carry.ports.clone() if scan else carry.ports,
                 cache=SigCache(*(fresh(t) for t in carry.cache)),
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


def run_batch_cuda(cfg, na, carry, pods, table, groups=None, fam=None,
                   overlay=None):
    """The scan kernel (csrc/run_batch.cu) over pods [B]; same contract as
    program.run_batch, with the group branch when `groups` is given and
    the overlay variant when `overlay` is (the kernel consumes a copy of
    it; `pods.nom_idx`, when not None, holds each pod's own nominated
    row)."""
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    B = pods.valid.shape[0]
    valid = _check(pods.valid, "pods.valid", torch.bool, 1, device)
    sig = _check(pods.sig, "pods.sig", torch.int32, 1, device)
    tidx = _check(pods.tidx, "pods.tidx", torch.int32, 1, device)
    if pods.sig.shape[0] != B or pods.tidx.shape[0] != B:
        raise ValueError("pods: valid/sig/tidx lengths differ")
    if overlay is not None and groups is not None:
        raise ValueError("run_batch: the overlay is a lean-scan input")
    # the copies stay bound to a name until the call returns
    ovl_ptrs, _ovl = _overlay_c(overlay, node.N, node.R, device, copy=True)
    nom = pods.nom_idx
    nom_ptr = None
    if overlay is not None and nom is not None:
        nom_ptr = _check(nom, "pods.nom_idx", torch.int32, 1, device)
        if nom.shape[0] != B:
            raise ValueError("pods.nom_idx: wrong length")
    tab = _table_c(table, node.R, device)
    out_carry = _out_carry(carry, scan=True)
    cc = _carry_c(out_carry, node.N, node.R, device)
    out = torch.empty((B,), dtype=torch.int32, device=device)
    if groups is not None:
        g = _groups_c(groups, node.N, device)
        gc = _gcarry_c(out_carry.groups, g, device)
        if g.U > tab.U:
            raise ValueError("run_batch: more group rows than table rows")
        famc = _fam_c(fam if fam is not None else (1,) * 5)
        gmask = torch.empty((node.N,), dtype=torch.uint8, device=device)
        flags = torch.empty((g.SC * node.N,), dtype=torch.int32,
                            device=device)
        gsc = torch.empty((node.N,), dtype=torch.int64, device=device)
        scratch = (gmask.data_ptr(), flags.data_ptr(), gsc.data_ptr())
    else:
        g, gc, famc = GroupsC(), GCarryC(), FamC()
        scratch = (None, None, None)
    # every struct stays bound to a name until the call returns: the C
    # entry copies them into the launch, from host memory ctypes owns
    cfgc = _cfg_c(cfg, node.R)
    rc = libs["run_batch"].ktpu_run_batch(
        ctypes.addressof(node), ctypes.addressof(tab), ctypes.addressof(cc),
        ctypes.addressof(cfgc), ctypes.addressof(g), ctypes.addressof(gc),
        ctypes.addressof(famc), int(groups is not None), cfg.w_spread,
        cfg.w_ipa, *scratch, *ovl_ptrs, nom_ptr, valid, sig, tidx, B,
        out.data_ptr(), _stream(device))
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


def _uniform_args(cfg, na, carry, x, table, n_actual: int, L: int,
                  K: int, J: int, what: str):
    """The checked arguments and scratch of one closed-form run (shared by
    run_uniform and the closed-form gang tier): (libs, device, output
    carry, [NodeC, TableC, in CarryC, out CarryC, CfgC], the scalar and
    scratch arguments, what must stay alive until the call returns)."""
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N = node.N
    sig, tidx = int(x.sig), int(x.tidx)
    if sig == 0:
        raise ValueError(f"{what} needs a signature (sig != 0)")
    if not (1 <= K <= N and J >= 1 and L >= 1 and K * J >= L):
        raise ValueError(f"{what}: bad shape L={L} K={K} J={J} N={N}")
    if not 0 <= int(n_actual) <= L:
        raise ValueError(f"{what}: n_actual {n_actual} outside [0, {L}]")
    tab = _table_c(table, node.R, device)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"{what}: row {tidx} outside the table")
    cin = _carry_c(carry, N, node.R, device)

    def empty(n, dtype):
        return torch.empty((n,), dtype=dtype, device=device)

    i64, i32 = torch.int64, torch.int32
    out_carry = _out_carry(carry, scan=False)
    cout = _carry_c(out_carry, N, node.R, device)
    P0, P1 = _pow2(N), _pow2(K * J)
    static_add, keys0 = empty(N, i64), empty(P0, i64)
    cand = empty(K, i32)
    keys1 = (empty(P1, i64) if P1 == K * J
             else torch.full((P1,), torch.iinfo(i64).min, dtype=i64,
                             device=device))
    fit_kj, sfit, sbal = (empty(K * J, torch.uint8), empty(K * J, i64),
                          empty(K * J, i64))
    counts, flags = empty(N, i32), empty(4, i32)
    structs = [node, tab, cin, cout, _cfg_c(cfg, node.R)]
    keep = (static_add, keys0, cand, keys1, fit_kj, sfit, sbal, counts,
            flags)
    head = (sig, tidx, int(n_actual))
    tail = (L, K, J, static_add.data_ptr(), keys0.data_ptr(), P0,
            cand.data_ptr(), keys1.data_ptr(), P1, fit_kj.data_ptr(),
            sfit.data_ptr(), sbal.data_ptr(), counts.data_ptr(),
            flags.data_ptr())
    return libs, device, out_carry, structs, head, tail, keep


def run_uniform_cuda(cfg, na, carry, x, table, n_actual: int, L: int,
                     K: int, J: int, overlay=None):
    """The closed-form kernels (csrc/run_uniform.cu) for one same-signature
    run; same contract as program.run_uniform, with the overlay variant
    when `overlay` is given (read only)."""
    libs, device, out_carry, structs, head, tail, _keep = _uniform_args(
        cfg, na, carry, x, table, n_actual, L, K, J, "run_uniform")
    ovl_ptrs, _ovl = _overlay_c(overlay, structs[0].N, structs[0].R, device,
                                copy=False)
    packed = torch.empty((L + 2,), dtype=torch.int32, device=device)
    # every struct stays bound to a name until the call returns
    rc = libs["run_uniform"].ktpu_run_uniform(
        *(ctypes.addressof(c) for c in structs), *head, *tail,
        packed.data_ptr(), *ovl_ptrs, _stream(device))
    _raise_on(rc, "run_uniform")
    LAUNCHES["run_uniform" if overlay is None else "run_uniform_ovl"] += 1
    return out_carry, packed


def run_gang_uniform_cuda(cfg, na, carry, x, table, n_actual: int,
                          needed: int, L: int, K: int, J: int):
    """The closed-form gang tier (run_uniform.cu ktpu_run_gang_uniform):
    run_uniform's launches and the gang epilogue; same contract as
    gang._run_gang_uniform_plain. The output carry holds fresh copies of
    every field the epilogue may write; the input is only read."""
    libs, device, out_carry, structs, head, tail, _keep = _uniform_args(
        cfg, na, carry, x, table, n_actual, L, K, J, "run_gang")
    pu = torch.empty((L + 2,), dtype=torch.int32, device=device)
    packed = torch.empty((L + 4,), dtype=torch.int32, device=device)
    rc = libs["run_uniform"].ktpu_run_gang_uniform(
        *(ctypes.addressof(c) for c in structs), *head, int(needed), *tail,
        pu.data_ptr(), packed.data_ptr(), _stream(device))
    _raise_on(rc, "run_gang_uniform")
    LAUNCHES["run_gang_uniform"] += 1
    return out_carry, packed


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


def wave_statics_cuda(na, table, wt, feats=(True, True, True)):
    """The per-signature surfaces (csrc/wave_statics.cu); same contract as
    program.wave_statics."""
    libs = build()
    device = na.valid.device
    node = _node_c(na, device)
    tab = _table_c(table, node.R, device)
    rows = [int(u) for u in wt]
    if not rows or any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"wave_statics: rows {rows} outside the table")
    if len(rows) > MAX_WAVE_ROWS:
        raise ValueError(f"wave_statics: {len(rows)} rows, at most "
                         f"{MAX_WAVE_ROWS} per call")
    S, N = len(rows), node.N
    wt_c = WaveRowsC()
    wt_c.u[:S] = rows
    img_cnt = torch.empty((S * (tab.IC + 1),), dtype=torch.int64,
                          device=device)
    mask = torch.empty((S, N), dtype=torch.bool, device=device)
    traw, nraw, simg = (torch.empty((S, N), dtype=torch.int64,
                                    device=device) for _ in range(3))
    has_taints, has_sel, has_img = (int(bool(f)) for f in feats)
    rc = libs["wave_statics"].ktpu_wave_statics(
        ctypes.addressof(node), ctypes.addressof(tab),
        ctypes.addressof(wt_c), S,
        has_taints, has_sel, has_img, img_cnt.data_ptr(), mask.data_ptr(),
        traw.data_ptr(), nraw.data_ptr(), simg.data_ptr(), _stream(device))
    _raise_on(rc, "wave_statics")
    LAUNCHES["wave_statics"] += 1
    return mask, traw, nraw, simg


def run_wave_cuda(cfg, na, carry, valid, table, wt, gd, statics, K: int,
                  J: int, Lw: int, fam, norm_live: bool, anti_term: int,
                  merge_on: bool):
    """The same-signature wave kernel (csrc/run_wave.cu); same contract as
    program.run_wave (Lw already capped at the span bucket)."""
    from .program import Carry
    libs = build()
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
    if not -1 <= anti_term < g.TAA:
        raise ValueError(f"run_wave: anti term {anti_term} out of range")
    gout_t = _clone_groups(carry.groups)
    gout = _gcarry_c(gout_t, g, device)
    used = carry.used.clone()
    nz = carry.nonzero_used.clone()
    npods = carry.npods.clone()
    _carry_c(carry._replace(used=used, nonzero_used=nz, npods=npods), N, R,
             device)
    P0, P1 = _pow2(N), _pow2(K * J)
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    SC, TAA = g.SC, g.TAA
    sizes = {"f_cnt": (SC * N, i32), "veto": (N, i32),
             "aa_cnt": (TAA * N, i32), "cnt_n": (N, i32),
             "cnt_add": (N, i32), "gmask": (N, u8), "feas": (N, u8),
             "masked": (N, i64), "gsc": (N, i64), "flags": (SC * N, i32),
             "seg": (N, i64), "elig_dom": (SC * N, i32), "keys0": (P0, i64),
             "cand": (K, i32), "keys1": (P1, i64), "node_i": (Lw, i32),
             "j_i": (Lw, i32), "gate": (Lw * SC, u8),
             "dom_ic": (Lw * SC, i32), "newcnt": (Lw * SC, i32),
             "lvlmask": (Lw * SC, i32)}
    scratch = {k: torch.empty((max(n, 1),), dtype=dt, device=device)
               for k, (n, dt) in sizes.items()}
    packed = torch.empty((B + 4,), dtype=i32, device=device)
    args = WaveArgsC(
        na=node, tb=tab, cfg=_cfg_c(cfg, R), g=g, gin=gin, gout=gout,
        fam=_fam_c(fam), used=used.data_ptr(), nonzero_used=nz.data_ptr(),
        npods=npods.data_ptr(), m0=stat[0], taint_raw=stat[1],
        na_raw=stat[2], s_img=stat[3], valid=valid_p, wt=wt, B=B, K=K, J=J,
        Lw=Lw, norm_live=int(bool(norm_live)), anti_term=int(anti_term),
        merge_on=int(bool(merge_on)), w_spread=cfg.w_spread,
        w_ipa=cfg.w_ipa, P0=P0, P1=P1, packed=packed.data_ptr(),
        **{k: t.data_ptr() for k, t in scratch.items()})
    rc = libs["run_wave"].ktpu_run_wave(ctypes.addressof(args),
                                        _stream(device))
    _raise_on(rc, "run_wave")
    LAUNCHES["run_wave"] += 1
    cache = carry.cache._replace(
        sig=torch.zeros((), dtype=torch.int32, device=device))
    return Carry(used=used, nonzero_used=nz, npods=npods, ports=carry.ports,
                 cache=cache, groups=gout_t), packed


def run_plan_cuda(cfg, na, carry, xs, table, wt, gd, statics, fam,
                  norm_live: bool, has_groups: bool, has_ports: bool):
    """The plan program (csrc/run_plan.cu) over one mixed-signature span;
    same contract as program.run_plan."""
    from .program import Carry
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    rows = [int(u) for u in wt]
    S = len(rows)
    if not 1 <= S <= MAX_PLAN_SLOTS:
        raise ValueError(f"run_plan: {S} signature slots, kernel takes "
                         f"1..{MAX_PLAN_SLOTS}")
    if any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"run_plan: rows {rows} outside the table")
    W = xs.valid.shape[0]
    valid_p = _check(xs.valid, "xs.valid", torch.bool, 1, device)
    widx_p = _check(xs.widx, "xs.widx", torch.int32, 1, device)
    if xs.widx.shape[0] != W or W < 1:
        raise ValueError("run_plan: xs.valid / xs.widx lengths differ")
    stat = [_check(t, f"statics[{k}]", dt, 2, device) for k, (t, dt) in
            enumerate(zip(statics, (torch.bool, torch.int64, torch.int64,
                                    torch.int64)))]
    if any(tuple(t.shape) != (S, N) for t in statics):
        raise ValueError(f"run_plan: statics must be [{S}, {N}] each")
    _carry_c(carry, N, R, device)
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    if has_groups:
        g = _groups_c(gd, N, device)
        gin = _gcarry_c(carry.groups, g, device)
        if any(u >= g.U for u in rows):
            raise ValueError(f"run_plan: rows {rows} outside the group "
                             "tables")
        if g.U > tab.U:
            raise ValueError("run_plan: more group rows than table rows")
        gout_t = _clone_groups(carry.groups)
        gout = _gcarry_c(gout_t, g, device)
        famc = _fam_c(fam)
        SC, TA, TAA = g.SC, g.TA, g.TAA
    else:
        g, gin, gout, famc = GroupsC(), GCarryC(), GCarryC(), FamC()
        gout_t = carry.groups
        SC = TA = TAA = 0
    used = carry.used.clone()
    nz = carry.nonzero_used.clone()
    npods = carry.npods.clone()
    ports = carry.ports.clone() if has_ports else carry.ports
    G = S if has_groups else 0    # slots with group state
    sizes = {"fit_ok": (S * N, u8), "s_fit": (S * N, i64),
             "s_bal": (S * N, i64), "feas": (N, u8),
             "f_cnt": (G * SC * N, i32), "s_cnt": (G * SC * N, i32),
             "veto": (G * N, i32), "a_cnt": (G * TA * N, i32),
             "a_total": (G, i64), "aa_cnt": (G * TAA * N, i32),
             "iscore": (G * N, i64), "cnt_sn": (G * N, i32),
             "gsc": (G and N, i64), "flags": (SC * N, i32),
             "seg": (G and N, i64)}
    scratch = {k: torch.empty((max(n, 1),), dtype=dt, device=device)
               for k, (n, dt) in sizes.items()}
    packed = torch.empty((W + 2,), dtype=i32, device=device)
    wt_c = (_I * MAX_PLAN_SLOTS)(*(rows + [0] * (MAX_PLAN_SLOTS - S)))
    # the struct stays bound to a name until the call returns
    args = PlanArgsC(
        na=node, tb=tab, cfg=_cfg_c(cfg, R), g=g, gin=gin, gout=gout,
        fam=famc, used=used.data_ptr(), nonzero_used=nz.data_ptr(),
        npods=npods.data_ptr(), ports=ports.data_ptr(),
        P=carry.ports.shape[1], m0=stat[0], taint_raw=stat[1],
        na_raw=stat[2], s_img=stat[3], valid=valid_p, widx=widx_p, wt=wt_c,
        S=S, W=W, norm_live=int(bool(norm_live)),
        has_groups=int(bool(has_groups)), has_ports=int(bool(has_ports)),
        w_spread=cfg.w_spread, w_ipa=cfg.w_ipa, packed=packed.data_ptr(),
        **{k: t.data_ptr() for k, t in scratch.items()})
    rc = libs["run_plan"].ktpu_run_plan(ctypes.addressof(args),
                                        _stream(device))
    _raise_on(rc, "run_plan")
    LAUNCHES["run_plan"] += 1
    cache = carry.cache._replace(
        sig=torch.zeros((), dtype=torch.int32, device=device))
    return Carry(used=used, nonzero_used=nz, npods=npods, ports=ports,
                 cache=cache, groups=gout_t), packed


def diagnose_row_cuda(na, table, tidx: int, gd=None, gc=None, fam=None):
    """The mask diagnosis (csrc/diagnose_row.cu) of table row `tidx`; same
    contract as program.diagnose_row."""
    libs = build()
    device = na.valid.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    tidx = int(tidx)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"diagnose_row: row {tidx} outside the table")
    used = _check(na.used, "na.used", torch.int64, 2, device)
    npods = _check(na.npods, "na.npods", torch.int32, 1, device)
    ports = _check(na.ports, "na.ports", torch.int32, 2, device)
    if (tuple(na.used.shape) != (N, R) or na.npods.shape[0] != N
            or na.ports.shape[0] != N):
        raise ValueError("diagnose_row: node state shapes differ from cap")
    if gd is not None:
        g = _groups_c(gd, N, device)
        gcc = _gcarry_c(gc, g, device)
        if tidx >= g.U:
            raise ValueError(f"diagnose_row: row {tidx} outside the group "
                             "tables")
        famc = _fam_c(fam if fam is not None else (1,) * 5)
    else:
        g, gcc, famc = GroupsC(), GCarryC(), FamC()
    slot = torch.empty((N,), dtype=torch.int32, device=device)
    pods_fail = torch.empty((N,), dtype=torch.bool, device=device)
    cols_fail = torch.empty((N, R), dtype=torch.bool, device=device)
    args = DiagArgsC(na=node, tb=tab, used=used, npods=npods, ports=ports,
                     P=na.ports.shape[1], tidx=tidx,
                     has_groups=int(gd is not None), g=g, gc=gcc, fam=famc,
                     slot=slot.data_ptr(), pods_fail=pods_fail.data_ptr(),
                     cols_fail=cols_fail.data_ptr())
    rc = libs["diagnose_row"].ktpu_diagnose_row(ctypes.addressof(args),
                                                _stream(device))
    _raise_on(rc, "diagnose_row")
    LAUNCHES["diagnose_row"] += 1
    return slot, pods_fail, cols_fail


def dry_run_select_victims_cuda(na, pod, cand, victim_req, victim_valid,
                                ovl_used, ovl_npods, spread=None):
    """The batched preemption dry run (csrc/dry_run.cu), one thread per
    candidate; same contract as program.dry_run_select_victims. `pod` is
    a PodRow of device tensors (program.pod_row_from_table)."""
    libs = build()
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
    from .program import PodTableDev
    # the preemptor's row as a one-row table (views, no copies)
    row = PodTableDev(*(getattr(pod, f).unsqueeze(0)
                        for f in PodTableDev._fields))
    tab = _table_c(row, R, device)
    C = cand.shape[0]
    cand_p = _check(cand, "cand", torch.int32, 1, device)
    req_p = _check(victim_req, "victim_req", torch.int64, 3, device)
    valid_p = _check(victim_valid, "victim_valid", torch.bool, 2, device)
    V = victim_req.shape[1]
    if not 1 <= V <= MAX_DRY_V:
        raise ValueError(f"dry_run: {V} victim slots outside 1..{MAX_DRY_V}")
    if (tuple(victim_req.shape) != (C, V, R)
            or tuple(victim_valid.shape) != (C, V)):
        raise ValueError(f"dry_run: victim tensors {tuple(victim_req.shape)}"
                         f" / {tuple(victim_valid.shape)}, expected "
                         f"{(C, V, R)} / {(C, V)}")
    ou_p = _check(ovl_used, "ovl_used", torch.int64, 2, device)
    on_p = _check(ovl_npods, "ovl_npods", torch.int32, 1, device)
    if tuple(ovl_used.shape) != (C, R) or ovl_npods.shape[0] != C:
        raise ValueError("dry_run: overlay must be [C, R] / [C]")
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
                "tv_ok": (torch.bool, (C, SC)),
                "cnt0": (torch.int32, (C, SC)),
                "other_min": (torch.int32, (C, SC)),
                "vic_match": (torch.bool, (C, V, SC))}
        for f, (dtype, shape) in want.items():
            t = getattr(spread, f)
            sp[f] = _check(t, f"spread.{f}", dtype, len(shape), device)
            if tuple(t.shape) != shape:
                raise ValueError(f"spread.{f}: {tuple(t.shape)}, expected "
                                 f"{shape}")
    out = torch.empty((C, V + 1), dtype=torch.bool, device=device)
    # the struct stays bound to a name until the call returns
    args = DryArgsC(na=node, tb=tab, used=used, npods=npods, cand=cand_p,
                    victim_req=req_p, victim_valid=valid_p, ovl_used=ou_p,
                    ovl_npods=on_p, C=C, V=V, has_spread=int(bool(sp)),
                    SC=SC, out=out.data_ptr(), **sp)
    rc = libs["dry_run"].ktpu_dry_run(ctypes.addressof(args),
                                      _stream(device))
    _raise_on(rc, "dry_run")
    LAUNCHES["dry_run"] += 1
    return out


def run_gang_cuda(cfg, na, carry, xs, table, wt, needed: int, dom, statics,
                  w_contig: int):
    """The scan tier of run_gang (csrc/run_gang.cu); same contract as
    gang._run_gang_scan_plain. The output carry holds fresh used /
    nonzero_used / npods and a fresh signature scalar; the rest of the
    SigCache, the ports and the group counts are the input's (the kernel
    never writes them)."""
    from .program import Carry
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    rows = [int(u) for u in wt]
    S = len(rows)
    if S < 1 or any(not 0 <= u < tab.U for u in rows):
        raise ValueError(f"run_gang: rows {rows} outside the table")
    B = xs.valid.shape[0]
    valid_p = _check(xs.valid, "xs.valid", torch.bool, 1, device)
    tidx_p = _check(xs.tidx, "xs.tidx", torch.int32, 1, device)
    widx_p = _check(xs.widx, "xs.widx", torch.int32, 1, device)
    if B < 1 or xs.tidx.shape[0] != B or xs.widx.shape[0] != B:
        raise ValueError("run_gang: xs.valid / tidx / widx lengths differ")
    dom_p = _check(dom, "dom", torch.int32, 1, device)
    if dom.shape[0] != N:
        raise ValueError(f"run_gang: dom must be [{N}]")
    stat = [_check(t, f"statics[{k}]", dt, 2, device) for k, (t, dt) in
            enumerate(zip(statics, (torch.bool, torch.int64, torch.int64,
                                    torch.int64)))]
    if any(tuple(t.shape) != (S, N) for t in statics):
        raise ValueError(f"run_gang: statics must be [{S}, {N}] each")
    cin = _carry_c(carry, N, R, device)
    i32, i64 = torch.int32, torch.int64
    used = torch.empty_like(carry.used)
    nz = torch.empty_like(carry.nonzero_used)
    npods = torch.empty_like(carry.npods)
    sig = torch.empty_like(carry.cache.sig)
    wt_t = torch.tensor(rows, dtype=i32).pin_memory().to(device,
                                                          non_blocking=True)
    fit_ok = torch.empty((S * N,), dtype=torch.uint8, device=device)
    s_fit = torch.empty((S * N,), dtype=i64, device=device)
    s_bal = torch.empty((S * N,), dtype=i64, device=device)
    domcnt = torch.empty((N,), dtype=i32, device=device)
    packed = torch.empty((B + 4,), dtype=i32, device=device)
    # the struct stays bound to a name until the call returns
    args = GangArgsC(
        na=node, tb=tab, cfg=_cfg_c(cfg, R), used_in=cin.used,
        nz_in=cin.nonzero_used, npods_in=cin.npods, sig_in=cin.cache.sig,
        used=used.data_ptr(), nonzero_used=nz.data_ptr(),
        npods=npods.data_ptr(), sig_out=sig.data_ptr(), m0=stat[0],
        taint_raw=stat[1], na_raw=stat[2], s_img=stat[3], valid=valid_p,
        tidx=tidx_p, widx=widx_p, wt=wt_t.data_ptr(), dom=dom_p, S=S, B=B,
        needed=int(needed), w_contig=int(w_contig),
        fit_ok=fit_ok.data_ptr(), s_fit=s_fit.data_ptr(),
        s_bal=s_bal.data_ptr(), domcnt=domcnt.data_ptr(),
        packed=packed.data_ptr())
    rc = libs["run_gang"].ktpu_run_gang(ctypes.addressof(args),
                                        _stream(device))
    _raise_on(rc, "run_gang")
    LAUNCHES["run_gang"] += 1
    return Carry(used=used, nonzero_used=nz, npods=npods, ports=carry.ports,
                 cache=carry.cache._replace(sig=sig),
                 groups=carry.groups), packed


def cluster_probe_cuda(cap, valid, used, npods, dom, ndom: int):
    """The cluster probe (csrc/cluster_probe.cu); same contract as
    program.cluster_probe on (na.cap, na.valid, carry.used, carry.npods,
    dom). Three launches on the current stream; reads its inputs only."""
    out = _cluster_probe_launch(cap, valid, used, npods, dom, ndom)
    LAUNCHES["cluster_probe"] += 1
    return out


def _cluster_probe_launch(cap, valid, used, npods, dom, ndom: int):
    libs = build()
    device = used.device
    N, R = cap.shape
    ptrs = {"cap": _check(cap, "cap", torch.int64, 2, device),
            "valid": _check(valid, "valid", torch.bool, 1, device),
            "used": _check(used, "used", torch.int64, 2, device),
            "npods": _check(npods, "npods", torch.int32, 1, device),
            "dom": _check(dom, "dom", torch.int32, 1, device)}
    if (tuple(used.shape) != (N, R) or valid.shape[0] != N
            or npods.shape[0] != N or dom.shape[0] != N):
        raise ValueError("cluster_probe: node axis or resource width differ")
    ndom = int(ndom)
    if not 1 <= ndom < 2 ** 31:
        raise ValueError(f"cluster_probe: ndom = {ndom}")
    tight = torch.empty((N,), dtype=torch.uint8, device=device)
    dom_cnt = torch.zeros((2, ndom), dtype=torch.int64, device=device)
    per_res = torch.empty((R, 7), dtype=torch.float32, device=device)
    dom_stats = torch.empty((4,), dtype=torch.float32, device=device)
    valid_count = torch.empty((), dtype=torch.int32, device=device)
    args = ProbeArgsC(**ptrs, N=N, R=R, ndom=ndom, tight=tight.data_ptr(),
                      dom_pods=dom_cnt[0].data_ptr(),
                      dom_nodes=dom_cnt[1].data_ptr(),
                      per_res=per_res.data_ptr(),
                      dom_stats=dom_stats.data_ptr(),
                      valid_count=valid_count.data_ptr())
    rc = libs["cluster_probe"].ktpu_cluster_probe(ctypes.addressof(args),
                                                  _stream(device))
    _raise_on(rc, "cluster_probe")
    return per_res, dom_stats, valid_count


def explain_row_cuda(cfg, na, carry, table, tidx: int, k: int, gd=None,
                     fam=None):
    """The score decomposition (csrc/explain_row.cu) of table row `tidx`
    at `carry`; same contract as program.explain_row. The row's parts go
    to scratch; the caller's carry is never written."""
    from .program import EXPLAIN_MAX_K, SigCache
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N, R = node.N, node.R
    tab = _table_c(table, R, device)
    tidx, k = int(tidx), int(k)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"explain_row: row {tidx} outside the table")
    if not 1 <= k <= min(EXPLAIN_MAX_K, N):
        raise ValueError(f"explain_row: k = {k} outside 1..min(16, N)")
    # the carry's rows with a scratch SigCache the kernel fills
    scratch = SigCache(*(torch.empty_like(t) for t in carry.cache))
    cc = _carry_c(carry._replace(cache=scratch), N, R, device)
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
    i64 = torch.int64
    gmask = torch.empty((N,), dtype=torch.uint8, device=device)
    flags = torch.empty((max(SC, 1) * N,), dtype=torch.int32, device=device)
    gsc = torch.empty((N,), dtype=i64, device=device)
    masked = torch.empty((N,), dtype=i64, device=device)
    idx = torch.empty((k,), dtype=torch.int32, device=device)
    totals = torch.empty((k,), dtype=i64, device=device)
    cols = torch.empty((k, 6), dtype=i64, device=device)
    feasible = torch.empty((), dtype=torch.int32, device=device)
    args = ExplainArgsC(
        na=node, tb=tab, c=cc, cfg=_cfg_c(cfg, R), g=g, gc=gcc, fam=famc,
        has_groups=int(gd is not None), tidx=tidx, k=k,
        w_spread=cfg.w_spread, w_ipa=cfg.w_ipa, gmask=gmask.data_ptr(),
        flags=flags.data_ptr(), gsc=gsc.data_ptr(), masked=masked.data_ptr(),
        idx=idx.data_ptr(), totals=totals.data_ptr(), cols=cols.data_ptr(),
        feasible=feasible.data_ptr())
    rc = libs["explain_row"].ktpu_explain_row(ctypes.addressof(args),
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
# the node-sharded mesh (parallel/sharding.py): per-shard launches with the
# exchange between them, driven from the host without a readback


def run_batch_sharded_cuda(cfg, mesh, na, carry, pods, table):
    """The lean scan over node shards (csrc/run_batch_sharded.cu); same
    contract as parallel/sharding.py run_batch_sharded: per pod, every
    shard's shard_eval, the exchange of the image counts and maxima,
    every shard's shard_select, the max of the packed keys, every
    shard's shard_apply. Output carries are fresh copies."""
    from ..parallel.sharding import Shards, lean_exchange, pmax, replicate
    lib = build()["run_batch_sharded"]
    B = pods.valid.shape[0]
    pods_r, tabs = replicate(mesh, pods), replicate(mesh, table)
    n_local = na[0].cap.shape[0]
    outs, args, locs, keys = [], [], [], []
    out = None
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        if node.N != n_local:
            raise ValueError("run_batch_sharded: shards of unequal size")
        ptrs = [_check(getattr(pods_r[d], f), f"pods.{f}", dt, 1, dev)
                for f, dt in (("valid", torch.bool), ("sig", torch.int32),
                              ("tidx", torch.int32))]
        if pods_r[d].sig.shape[0] != B or pods_r[d].tidx.shape[0] != B:
            raise ValueError("pods: valid/sig/tidx lengths differ")
        oc = _out_carry(carry[d], scan=True)
        outs.append(oc)
        locs.append(torch.empty((MAX_IC + 3,), dtype=torch.int64,
                                device=dev))
        keys.append(torch.empty((1,), dtype=torch.int64, device=dev))
        if d == 0:
            out = torch.empty((B,), dtype=torch.int32, device=dev)
        args.append(ShardStepC(
            na=node, tb=_table_c(tabs[d], node.R, dev),
            c=_carry_c(oc, node.N, node.R, dev), cfg=_cfg_c(cfg, node.R),
            valid=ptrs[0], sig=ptrs[1], tidx=ptrs[2], offset=d * n_local,
            loc=locs[d].data_ptr(), key=keys[d].data_ptr(),
            out=out.data_ptr() if d == 0 else None))
    # every struct stays bound to a name until the last launch returns
    shards = [(ctypes.addressof(a), _stream(dev), dev)
              for a, dev in zip(args, mesh.devices)]
    for i in range(B):
        rc = 0
        for a, st, dev in shards:
            with torch.cuda.device(dev):
                rc |= lib.ktpu_shard_eval(a, i, st)
        glob = lean_exchange(mesh, locs)
        for (a, st, dev), g in zip(shards, glob):
            with torch.cuda.device(dev):
                rc |= lib.ktpu_shard_select(a, i, g.data_ptr(), st)
        gkey = pmax(mesh, keys)
        for (a, st, dev), g in zip(shards, gkey):
            with torch.cuda.device(dev):
                rc |= lib.ktpu_shard_apply(a, i, g.data_ptr(), st)
        _raise_on(rc, "run_batch_sharded")
    LAUNCHES["run_batch_sharded"] += 1
    return Shards(outs), out


def run_uniform_sharded_cuda(cfg, mesh, na, carry, x, table, n_actual: int,
                             L: int, K: int, J: int):
    """The closed form over node shards (csrc/run_uniform_sharded.cu);
    same contract as parallel/sharding.py run_uniform_sharded: every
    shard's parts, the exchange of the counts and maxima, every shard's
    top-K_loc / matrix / top-L_loc, the all-gather of the keys, one merge
    a device, every shard's finalize, the min of the flags."""
    from ..parallel.sharding import (Shards, all_gather, lean_exchange, pmin,
                                     replicate, uniform_shape)
    lib = build()["run_uniform_sharded"]
    D = mesh.size
    n_local = na[0].cap.shape[0]
    if not (K >= 1 and J >= 1 and L >= 1):
        raise ValueError(f"run_uniform_sharded: bad shape L={L} K={K} J={J}")
    K_loc, L_loc, _M = uniform_shape(mesh, n_local, L, K, J)
    sig, tidx = int(x.sig), int(x.tidx)
    tabs = replicate(mesh, table)
    i64, i32 = torch.int64, torch.int32
    P0, P1 = _pow2(n_local), _pow2(K_loc * J)
    outs, args, bufs = [], [], []
    for d, dev in enumerate(mesh.devices):
        node = _node_c(na[d], dev)
        if node.N != n_local:
            raise ValueError("run_uniform_sharded: shards of unequal size")
        tab = _table_c(tabs[d], node.R, dev)
        if not 0 <= tidx < tab.U:
            raise ValueError(f"run_uniform_sharded: row {tidx} outside the "
                             "table")

        def empty(n, dtype, dev=dev):
            return torch.empty((n,), dtype=dtype, device=dev)

        oc = _out_carry(carry[d], scan=False)
        outs.append(oc)
        b = SimpleNamespace(
            loc=empty(MAX_IC + 3, i64), static_add=empty(n_local, i64),
            keys0=empty(P0, i64), cand=empty(K_loc, i32),
            keys1=(empty(P1, i64) if P1 == K_loc * J else torch.full(
                (P1,), torch.iinfo(i64).min, dtype=i64, device=dev)),
            fit_kj=empty(K_loc * J, torch.uint8),
            sfit_kj=empty(K_loc * J, i64), sbal_kj=empty(K_loc * J, i64),
            counts=empty(n_local, i32), flags=empty(2, i32),
            packed=empty(L + 2, i32))
        bufs.append(b)
        args.append(UniShardC(
            na=node, tb=tab, cin=_carry_c(carry[d], node.N, node.R, dev),
            cout=_carry_c(oc, node.N, node.R, dev), cfg=_cfg_c(cfg, node.R),
            sig=sig, tidx=tidx, offset=d * n_local, n_global=D * n_local,
            K=K_loc, J=J, L=L, n_actual=int(n_actual), P0=P0, P1=P1,
            **{k: t.data_ptr() for k, t in vars(b).items()}))
    # every struct stays bound to a name until the last launch returns
    shards = [(ctypes.addressof(a), _stream(dev), dev)
              for a, dev in zip(args, mesh.devices)]
    rc = 0
    for a, st, dev in shards:
        with torch.cuda.device(dev):
            rc |= lib.ktpu_uniform_shard_parts(a, st)
    glob = lean_exchange(mesh, [b.loc for b in bufs])
    for (a, st, dev), g in zip(shards, glob):
        with torch.cuda.device(dev):
            rc |= lib.ktpu_uniform_shard_topk(a, g.data_ptr(), st)
    gathered = all_gather(mesh, [b.keys1[:L_loc] for b in bufs])
    n = D * L_loc
    P = _pow2(max(n, L))
    merged = {}
    for dev in mesh.distinct:
        g = gathered[mesh.devices.index(dev)]
        merged[dev] = torch.empty((P,), dtype=i64, device=dev)
        with torch.cuda.device(dev):
            rc |= lib.ktpu_uniform_merge(g.data_ptr(), n,
                                         merged[dev].data_ptr(), P,
                                         _stream(dev))
    for a, st, dev in shards:
        with torch.cuda.device(dev):
            rc |= lib.ktpu_uniform_shard_finalize(a, merged[dev].data_ptr(),
                                                  st)
    _raise_on(rc, "run_uniform_sharded")
    packed = bufs[0].packed
    packed[L:].copy_(pmin(mesh, [b.packed[L:] for b in bufs])[0])
    LAUNCHES["run_uniform_sharded"] += 1
    return Shards(outs), packed


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


def cluster_probe_sharded_cuda(cap, valid, used, npods, dom, ndom: int):
    """The cluster probe on the mesh: the probe kernels on the node
    columns the wrapper gathered onto the first shard's device."""
    with torch.cuda.device(cap.device):
        out = _cluster_probe_launch(cap, valid, used, npods, dom, ndom)
    LAUNCHES["cluster_probe_sharded"] += 1
    return out
