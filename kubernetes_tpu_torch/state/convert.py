"""numpy → torch conversion of the device-program state.

Each function takes numpy arrays (or anything `np.asarray` accepts) under
the field names of the JAX package's NamedTuples and returns the port's
NamedTuple of torch tensors on `device`, with every dtype written out:
i64 quantities, i32 ids, bool masks — exactly the JAX package's dtypes.
The tests use this to give both packages the same state; the scheduler
uses `node_arrays_from_numpy` for its uploads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.program import Carry, PodTableDev, PodXs, SigCache
from .tensorize import NodeArrays

_I64, _I32, _B = torch.int64, torch.int32, torch.bool

NODE_DTYPES = {
    "cap": _I64, "used": _I64, "nonzero_used": _I64, "npods": _I32,
    "allowed_pods": _I32, "valid": _B, "unschedulable": _B, "name_id": _I32,
    "taint_key": _I32, "taint_val": _I32, "taint_eff": _I32,
    "label_key": _I32, "label_kv": _I32, "label_num": _I64, "ports": _I32,
    "image_id": _I32, "image_size": _I64,
}

POD_TABLE_DTYPES = {
    "req": _I64, "nonzero_req": _I64, "node_name_id": _I32,
    "tol_key": _I32, "tol_val": _I32, "tol_eff": _I32, "tol_op": _I32,
    "tolerates_unsched": _B, "ns_sel_val": _I32, "aff_has": _B,
    "aff_term_valid": _B, "aff_key": _I32, "aff_op": _I32, "aff_num": _I64,
    "aff_val": _I32, "pref_weight": _I64, "pref_key": _I32, "pref_op": _I32,
    "pref_num": _I64, "pref_val": _I32, "port_ids": _I32,
    "skip_balanced": _B, "img_ids": _I32, "img_containers": _I32,
}

POD_XS_DTYPES = {"valid": _B, "sig": _I32, "tidx": _I32}

CACHE_DTYPES = {
    "sig": _I32, "static_mask": _B, "taint_raw": _I64, "na_raw": _I64,
    "s_img": _I64, "fit_ok": _B, "s_fit": _I64, "s_bal": _I64,
}

CARRY_DTYPES = {"used": _I64, "nonzero_used": _I64, "npods": _I32,
                "ports": _I32}


def _tensor(x, dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _convert(cls, src, dtypes: dict, device):
    return cls(*(_tensor(getattr(src, f), dtypes[f], device)
                 for f in cls._fields))


def node_arrays_from_numpy(src, device) -> NodeArrays:
    return _convert(NodeArrays, src, NODE_DTYPES, device)


def pod_table_from_numpy(src, device) -> PodTableDev:
    return _convert(PodTableDev, src, POD_TABLE_DTYPES, device)


def pod_xs_from_numpy(src, device) -> PodXs:
    return _convert(PodXs, src, POD_XS_DTYPES, device)


def carry_from_numpy(src, device) -> Carry:
    """`src` has used/nonzero_used/npods/ports and a `cache` with the
    SigCache fields (its `groups`, if any, must be None)."""
    if getattr(src, "groups", None) is not None:
        raise NotImplementedError(
            "group (spread / inter-pod affinity) carries are not ported")
    cache = _convert(SigCache, src.cache, CACHE_DTYPES, device)
    return Carry(*(_tensor(getattr(src, f), CARRY_DTYPES[f], device)
                   for f in ("used", "nonzero_used", "npods", "ports")),
                 cache=cache)
