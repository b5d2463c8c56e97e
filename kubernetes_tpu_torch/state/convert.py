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

from ..ops.gang import GangXs
from ..ops.groups import GroupCarry, GroupsDev
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

POD_XS_DTYPES = {"valid": _B, "sig": _I32, "tidx": _I32, "nom_idx": _I32}

GANG_XS_DTYPES = {"valid": _B, "tidx": _I32, "widx": _I32}

CACHE_DTYPES = {
    "sig": _I32, "static_mask": _B, "taint_raw": _I64, "na_raw": _I64,
    "s_img": _I64, "fit_ok": _B, "s_fit": _I64, "s_bal": _I64,
}

CARRY_DTYPES = {"used": _I64, "nonzero_used": _I64, "npods": _I32,
                "ports": _I32}

GROUPS_DEV_DTYPES = {
    "spr_f_active": _B, "spr_f_max_skew": _I32, "spr_f_self": _I32,
    "spr_f_tv": _I32, "spr_f_elig": _B, "spr_f_dom": _I32,
    "spr_s_active": _B, "spr_s_max_skew": _I32, "spr_s_is_host": _B,
    "spr_s_tv": _I32, "spr_s_elig": _B, "spr_s_keys_ok": _B,
    "spr_s_dom": _I32, "ipa_ra_active": _B, "ipa_ra_tv": _I32,
    "ipa_ra_dom": _I32, "ipa_raa_active": _B, "ipa_raa_tv": _I32,
    "ipa_raa_dom": _I32, "ipa_self_all": _B, "ipa_stc_tv": _I32,
    "ipa_stc_dom": _I32, "ipa_stp_tv": _I32, "ipa_stp_dom": _I32,
    "m_spr_f": _B, "m_spr_s": _B, "m_ipa_a": _B, "m_ipa_aa": _B,
    "m_ipa_exist": _B, "w_stc": _I64, "w_stp": _I64,
}

GROUP_CARRY_DTYPES = {
    "spr_f_cnt": _I32, "spr_f_min_zero": _B, "spr_s_cnt": _I32,
    "ipa_veto": _I32, "ipa_a_cnt": _I32, "ipa_a_total": _I64,
    "ipa_aa_cnt": _I32, "ipa_score": _I64,
}


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`: on a CUDA device through pinned memory
    without blocking (a pageable copy waits for every kernel already on
    the stream, and the span converters run between a drain's launches);
    elsewhere a plain move (none on the CPU)."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)  # torchsan: waive[pageable-h2d] not a CUDA device


def _tensor(x, dtype, device) -> torch.Tensor:
    """A plain copy: the whole-state uploads run in the declared host
    phases, before the drain's launches. A scalar stays a scalar (the
    SigCache's sig)."""
    arr = np.asarray(x)
    arr = np.ascontiguousarray(arr) if arr.ndim else arr.copy()
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _span_tensor(x, dtype, device) -> torch.Tensor:
    """The span converters' copy: they run inside the dispatch region."""
    arr = np.ascontiguousarray(np.asarray(x))
    return upload(torch.from_numpy(arr).to(dtype=dtype), device)


def _convert(cls, src, dtypes: dict, device):
    return cls(*(_tensor(getattr(src, f), dtypes[f], device)
                 for f in cls._fields))


def node_arrays_from_numpy(src, device) -> NodeArrays:
    return _convert(NodeArrays, src, NODE_DTYPES, device)


def pod_table_from_numpy(src, device) -> PodTableDev:
    return _convert(PodTableDev, src, POD_TABLE_DTYPES, device)


def pod_xs_from_numpy(src, device) -> PodXs:
    """`nom_idx` stays None when `src` has none (no nominated pod)."""
    nom = getattr(src, "nom_idx", None)
    return PodXs(*(_span_tensor(getattr(src, f), POD_XS_DTYPES[f], device)
                   for f in ("valid", "sig", "tidx")),
                 nom_idx=(None if nom is None
                          else _span_tensor(nom, POD_XS_DTYPES["nom_idx"],
                                            device)))


def gang_xs_from_numpy(src, device) -> GangXs:
    return GangXs(*(_span_tensor(getattr(src, f), GANG_XS_DTYPES[f], device)
                    for f in GangXs._fields))


def dom_from_numpy(dom, device) -> torch.Tensor:
    """The i32 [N] topology-domain id of every node row (the gang scan
    tier's contiguity column and the cluster probe's domains). On a CUDA
    device the copy goes through pinned memory without blocking: the
    probe asks for the ids right after the drain's launches, and a
    pageable copy would wait for them."""
    arr = np.ascontiguousarray(np.asarray(dom, dtype=np.int32))
    return upload(torch.from_numpy(arr), device)


def groups_dev_from_numpy(src, device) -> GroupsDev:
    return _convert(GroupsDev, src, GROUPS_DEV_DTYPES, device)


def group_carry_from_numpy(src, device) -> GroupCarry:
    return _convert(GroupCarry, src, GROUP_CARRY_DTYPES, device)


def carry_from_numpy(src, device) -> Carry:
    """`src` has used/nonzero_used/npods/ports, a `cache` with the SigCache
    fields and, optionally, `groups` with the GroupCarry fields."""
    cache = _convert(SigCache, src.cache, CACHE_DTYPES, device)
    groups = getattr(src, "groups", None)
    if groups is not None:
        groups = group_carry_from_numpy(groups, device)
    return Carry(*(_tensor(getattr(src, f), CARRY_DTYPES[f], device)
                   for f in ("used", "nonzero_used", "npods", "ports")),
                 cache=cache, groups=groups)


def node_rows_from_numpy(src, device) -> NodeArrays:
    """A block of node rows (a dirty-row upload): on a CUDA device through
    pinned memory without blocking."""
    return NodeArrays(*(_span_tensor(getattr(src, f), NODE_DTYPES[f], device)
                        for f in NodeArrays._fields))


def _numpy_tree(src, cls):
    """`src` (anything `np.asarray` takes per leaf, e.g. the JAX package's
    mesh-placed arrays, whose np.asarray is the whole global array) as a
    `cls` NamedTuple of numpy copies; a `cache` leaf becomes a SigCache."""
    out = {}
    for f in cls._fields:
        x = getattr(src, f, None)
        if f == "cache":
            out[f] = _numpy_tree(x, SigCache)
        elif f == "groups":
            out[f] = (None if x is None else type(x)(
                *(np.array(y) for y in x)))
        else:
            out[f] = np.array(x)
    return cls(**out)


def node_arrays_to_shards(src, mesh):
    """NodeArrays from any package (numpy, or the JAX package's arrays
    placed on its mesh) → the port's node shards on `mesh`, through
    numpy."""
    from ..parallel.sharding import shard_node_arrays
    return shard_node_arrays(mesh, _numpy_tree(src, NodeArrays))


def carry_to_shards(src, mesh):
    """A Carry from any package → the port's carry shards on `mesh`,
    through numpy (cache.sig replicated; the group counts, when present,
    split along their last axis)."""
    from ..parallel.sharding import shard_carry
    return shard_carry(mesh, _numpy_tree(src, Carry))


def groups_to_shards(src, mesh):
    """A GroupsDev from any package (numpy, or the JAX package's
    shard_groups arrays) → the port's group shards on `mesh`, through
    numpy: node-last fields split, the rest replicated."""
    from ..parallel.sharding import shard_groups
    return shard_groups(mesh, type(src)(*(np.array(x) for x in src)))


def shards_to_numpy(shards):
    """The port's shards → one NamedTuple of global numpy arrays (node
    axis concatenated in shard order; replicated scalars from shard 0):
    what the JAX package's mesh-placed arrays read as through
    np.asarray."""
    from ..parallel.sharding import unshard

    def host(tree):
        if tree is None:
            return None
        if hasattr(tree, "_fields"):
            return type(tree)(*(host(x) for x in tree))
        return tree.cpu().numpy()

    return host(unshard(shards))
