"""run_gang_sharded's edge inputs (tests/_gang_edges.py GANG_EDGE_CASES) —
members that straddle a shard boundary, contiguity domains that cross it,
n_local not a multiple of 512, ties at block and shard boundaries, a
rejected gang — through the port's plain version over D CPU shards and the
JAX package's `run_gang_sharded` (scan tier) on its virtual CPU mesh, at
D = 2 and 4; and at D = 1, the one-shard case (run_gang's scan tier,
whose kernel is a cluster of 16 CTAs over the same body), through the
port's `run_gang` and the JAX package's `run_gang` on one device.

The card holds the one-launch kernel against the port's plain version on
these same inputs (tests/test_torch_cuda.py); here the plain version is
held against the JAX package. Each case is staged once with the JAX
package's state layer; the numpy arrays go through both.

Tolerance: exact. The packed [B + 4] output and every field of the
unsharded carry, SigCache signature included, dtypes included; a rejected
gang's carry equals its input."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _gang_edges import GANG_EDGE_CASES, check_placements, stage
from _torch_parity import (private_jax_compiles,  # noqa: F401
                           assert_carry_equal, assert_sharded_carry_equal,
                           jax_mesh_state, jax_na, jax_table,
                           torch_mesh_state, torch_na, torch_table)
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import gang as jgang
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.ops.gang import GangXs as JGangXs
from kubernetes_tpu.parallel import sharding as js
from kubernetes_tpu.state.batch import BatchBuilder
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing import wrappers
from kubernetes_tpu_torch.ops import gang as tgang
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.parallel import sharding as ts
from kubernetes_tpu_torch.state import convert

JAX_STATE = SimpleNamespace(Cache=Cache, Snapshot=Snapshot,
                            ClusterState=ClusterState,
                            BatchBuilder=BatchBuilder, W=wrappers)
SIG = 7


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", sorted(GANG_EDGE_CASES))
def test_run_gang_sharded_edges_match_jax(case, D):
    e = stage(case, JAX_STATE)
    jmesh, tmesh = js.make_mesh(D), ts.make_mesh(devices=["cpu"] * D)
    jna, jc0 = jax_mesh_state(jmesh, e.arrays)
    tna, tc0 = torch_mesh_state(tmesh, e.arrays)
    jc0 = jc0._replace(cache=jc0.cache._replace(
        sig=js.jax.device_put(np.int32(SIG))))
    tc0 = ts.with_cache_sig_sharded(tc0, SIG)
    jt, tt = jax_table(e.table), torch_table(e.table)
    jwt = jnp.asarray(np.array(e.wt, np.int32))
    jst = tuple(js.jax.device_put(x, js.NamedSharding(
        jmesh, js.P(None, js.NODE_AXIS)))
        for x in jp.wave_statics(jax_na(e.arrays), jt, jwt))
    jdom = js.jax.device_put(e.dom, js.NamedSharding(jmesh,
                                                     js.P(js.NODE_AXIS)))
    jc, jpk = js.run_gang_sharded(
        jp.ScoreConfig(), jmesh, jna, jc0,
        JGangXs(*(jnp.asarray(x) for x in (e.valid, e.tidx, e.widx))), jt,
        wt=jwt, needed=np.int32(e.needed), dom=jdom, statics=jst,
        w_contig=e.w_contig)
    n = e.dom.shape[0] // D
    before = convert.shards_to_numpy(tc0)
    tc, tpk = ts.run_gang_sharded(
        tp.ScoreConfig(), tmesh, tna, tc0,
        convert.gang_xs_from_numpy(tgang.GangXs(e.valid, e.tidx, e.widx),
                                   "cpu"),
        tt, wt=e.wt, needed=e.needed,
        dom=[torch.from_numpy(e.dom[d * n:(d + 1) * n].copy())
             for d in range(D)],
        statics=ts.wave_statics_sharded(tmesh, tna, tt, e.wt),
        w_contig=e.w_contig)
    jpk = np.asarray(jpk)
    assert jpk.dtype == tpk.numpy().dtype
    np.testing.assert_array_equal(jpk, tpk.numpy())
    assert_sharded_carry_equal(jc, tc)
    check_placements(case, tpk.tolist())
    after = convert.shards_to_numpy(tc)
    if e.accept:
        assert int(after.cache.sig) == 0
    else:
        # a rejected gang leaves every shard's carry as it came
        for f in ("used", "nonzero_used", "npods"):
            np.testing.assert_array_equal(getattr(before, f),
                                          getattr(after, f))
        assert int(after.cache.sig) == SIG


@pytest.mark.parametrize("case", sorted(GANG_EDGE_CASES))
def test_run_gang_edges_match_jax(case):
    """D = 1: the whole node axis one shard at offset 0 — the straddle
    band across CTA boundaries of the cluster (⌈2,048 / 16⌉ = 128 rows a
    CTA), N = 1,536 ragged, ties beside the CTA boundaries going to the
    lowest row, a rejected gang whose carry returns as it came."""
    e = stage(case, JAX_STATE)
    jna, tna = jax_na(e.arrays), torch_na(e.arrays)
    jt, tt = jax_table(e.table), torch_table(e.table)
    jc0 = jp.initial_carry(jna)
    jc0 = jc0._replace(cache=jc0.cache._replace(sig=jnp.int32(SIG)))
    tc0 = tp.with_cache_sig(tp.initial_carry(tna), SIG)
    before = [t.clone() for t in tc0[:3]]
    jwt = jnp.asarray(np.array(e.wt, np.int32))
    jc, jpk = jgang.run_gang(
        jp.ScoreConfig(), jna, jc0,
        JGangXs(*(jnp.asarray(x) for x in (e.valid, e.tidx, e.widx))), jt,
        wt=jwt, needed=np.int32(e.needed), dom=jnp.asarray(e.dom),
        statics=jp.wave_statics(jna, jt, jwt), w_contig=e.w_contig)
    tc, tpk = tgang.run_gang(
        tp.ScoreConfig(), tna, tc0,
        convert.gang_xs_from_numpy(tgang.GangXs(e.valid, e.tidx, e.widx),
                                   "cpu"),
        tt, wt=e.wt, needed=e.needed, dom=torch.from_numpy(e.dom.copy()),
        statics=tp.wave_statics(tna, tt, e.wt), w_contig=e.w_contig)
    jpk = np.asarray(jpk)
    assert jpk.dtype == tpk.numpy().dtype
    np.testing.assert_array_equal(jpk, tpk.numpy())
    assert_carry_equal(jc, tc)
    check_placements(case, tpk.tolist())
    if e.accept:
        assert int(tc.cache.sig) == 0
    else:
        for b, a in zip(before, tc[:3]):
            assert torch.equal(b, a)
        assert int(tc.cache.sig) == SIG
