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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]
SOURCES = ("run_batch", "run_uniform")

# launches per wrapper since the last reset (one per kernel-wrapper call)
LAUNCHES = {name: 0 for name in SOURCES}

_LIBS: dict = {}
BUILD_INFO: dict = {}

MAX_C = 8      # csrc/lean_eval.cuh KT_MAX_C
MAX_IC = 16    # csrc/lean_eval.cuh KT_MAX_IC


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
    BUILD_INFO.update(seconds=time.perf_counter() - t0, tag=tag,
                      built=sorted(procs), ptxas=report)
    for name in SOURCES:
        _LIBS[name] = _bind(name, ctypes.CDLL(
            str(BUILD_DIR / f"lib{name}_{tag}.so")))
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


def _bind(name: str, lib):
    if name == "run_batch":
        lib.ktpu_run_batch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P]
        lib.ktpu_run_batch.restype = ctypes.c_int
    else:
        lib.ktpu_run_uniform.argtypes = (
            [_P] * 5 + [_I] * 6 + [_P, _P, _I, _P, _P, _I] + [_P] * 7)
        lib.ktpu_run_uniform.restype = ctypes.c_int
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


def _out_carry(carry, scan: bool):
    """The carry a kernel writes in place: copies of the fields it
    updates, because the input carry may still be held for rewind. The
    scan (run_batch) writes port ids and starts from the input SigCache,
    so both are copied; run_uniform never writes ports, which stay
    shared, and writes its SigCache in full, which starts uninitialised."""
    from .program import Carry, SigCache
    fresh = torch.Tensor.clone if scan else torch.empty_like
    return Carry(used=carry.used.clone(),
                 nonzero_used=carry.nonzero_used.clone(),
                 npods=carry.npods.clone(),
                 ports=carry.ports.clone() if scan else carry.ports,
                 cache=SigCache(*(fresh(t) for t in carry.cache)))


def run_batch_cuda(cfg, na, carry, pods, table):
    """The scan kernel (csrc/run_batch.cu) over pods [B]; same contract as
    program.run_batch."""
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    B = pods.valid.shape[0]
    valid = _check(pods.valid, "pods.valid", torch.bool, 1, device)
    sig = _check(pods.sig, "pods.sig", torch.int32, 1, device)
    tidx = _check(pods.tidx, "pods.tidx", torch.int32, 1, device)
    if pods.sig.shape[0] != B or pods.tidx.shape[0] != B:
        raise ValueError("pods: valid/sig/tidx lengths differ")
    tab = _table_c(table, node.R, device)
    out_carry = _out_carry(carry, scan=True)
    cc = _carry_c(out_carry, node.N, node.R, device)
    out = torch.empty((B,), dtype=torch.int32, device=device)
    # every struct stays bound to a name until the call returns: the C
    # entry copies them into the launch, from host memory ctypes owns
    cfgc = _cfg_c(cfg, node.R)
    rc = libs["run_batch"].ktpu_run_batch(
        ctypes.addressof(node), ctypes.addressof(tab), ctypes.addressof(cc),
        ctypes.addressof(cfgc), valid, sig, tidx, B, out.data_ptr(),
        _stream(device))
    _raise_on(rc, "run_batch")
    LAUNCHES["run_batch"] += 1
    return out_carry, out


def _pow2(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


def run_uniform_cuda(cfg, na, carry, x, table, n_actual: int, L: int,
                     K: int, J: int):
    """The closed-form kernels (csrc/run_uniform.cu) for one same-signature
    run; same contract as program.run_uniform."""
    libs = build()
    device = carry.used.device
    node = _node_c(na, device)
    N = node.N
    sig, tidx = int(x.sig), int(x.tidx)
    if sig == 0:
        raise ValueError("run_uniform needs a signature (sig != 0)")
    if not (1 <= K <= N and J >= 1 and L >= 1 and K * J >= L):
        raise ValueError(f"run_uniform: bad shape L={L} K={K} J={J} N={N}")
    if not 0 <= int(n_actual) <= L:
        raise ValueError(f"run_uniform: n_actual {n_actual} outside [0, {L}]")
    tab = _table_c(table, node.R, device)
    if not 0 <= tidx < tab.U:
        raise ValueError(f"run_uniform: row {tidx} outside the table")
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
    packed = empty(L + 2, i32)
    cfgc = _cfg_c(cfg, node.R)
    rc = libs["run_uniform"].ktpu_run_uniform(
        ctypes.addressof(node), ctypes.addressof(tab), ctypes.addressof(cin),
        ctypes.addressof(cout), ctypes.addressof(cfgc),
        sig, tidx, int(n_actual), L, K, J, static_add.data_ptr(),
        keys0.data_ptr(), P0, cand.data_ptr(), keys1.data_ptr(), P1,
        fit_kj.data_ptr(), sfit.data_ptr(), sbal.data_ptr(),
        counts.data_ptr(), flags.data_ptr(), packed.data_ptr(),
        _stream(device))
    _raise_on(rc, "run_uniform")
    LAUNCHES["run_uniform"] += 1
    return out_carry, packed
