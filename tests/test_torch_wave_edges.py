"""run_wave's edge inputs (tests/_wave_edges.py WAVE_EDGE_CASES) — the
node-axis partitions of the port's CUDA design (csrc/run_wave.cu: a
thread-block cluster, a contiguous range of rows a CTA, radix selections
of the top-K and top-Lw keys, the spread replay in one CTA) and the wave's
corners — through the port's plain version and the JAX package's
`run_wave` on the CPU.

The card holds the kernel against the port's plain version on these same
inputs and at full width (tests/test_torch_cuda.py); here the plain
version is held against the JAX package. Each case is staged once with
the JAX package's state layer; the numpy arrays go through the JAX
`run_wave` and, converted, through the port's `run_wave` on CPU tensors
(its plain version).

Tolerance: exact. The assignments and the four wave stats, every carry
field and the whole group carry, dtypes included."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import (private_jax_compiles,  # noqa: F401
                           CPU, jax_na, jax_table, torch_na, torch_table)
from _wave_edges import CPU_CASES, check_case, stage
from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.ops.hostgreedy import static_norm_ok
from kubernetes_tpu.state.batch import BatchBuilder
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing import wrappers
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

JAX_STATE = SimpleNamespace(Cache=Cache, Snapshot=Snapshot,
                            ClusterState=ClusterState,
                            BatchBuilder=BatchBuilder, W=wrappers,
                            static_norm_ok=static_norm_ok)


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("case", CPU_CASES)
def test_run_wave_edges_match_jax(case):
    e = stage(case, JAX_STATE)
    jna, tna = jax_na(e.arrays), torch_na(e.arrays)
    jtab, ttab = jax_table(e.table), torch_table(e.table)
    jgd, jgc = jg.to_device(e.gd), jg.to_device(e.gc)
    tgd = convert.groups_dev_from_numpy(e.gd, CPU)
    tgc = convert.group_carry_from_numpy(e.gc, CPU)
    jfam, tfam = jg.GroupFamilies(*e.fam), tg.GroupFamilies(*e.fam)
    jst = tuple(x[0] for x in jp.wave_statics(
        jna, jtab, jnp.asarray(np.array([e.u], np.int32))))
    tst = tuple(x[0] for x in tp.wave_statics(tna, ttab, [e.u]))
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jc, jpk = jp.run_wave(jp.ScoreConfig(), jna, jp.initial_carry(jna, jgc),
                          jnp.asarray(e.valid), jtab, jnp.int32(e.u), jgd,
                          jst, e.K, e.J, jfam, e.norm_live,
                          anti_term=e.anti, merge_on=e.merge_on, Lw=e.Lw)
    tcarry = tp.initial_carry(tna, tgc)
    tc, tpk = tp.run_wave(tp.ScoreConfig(), tna, tcarry,
                          torch.from_numpy(e.valid.copy()), ttab, e.u, tgd,
                          tst, e.K, e.J, tfam, e.norm_live,
                          anti_term=e.anti, merge_on=e.merge_on, Lw=e.Lw)
    _eq(jpk, tpk, "packed")
    for f in ("used", "nonzero_used", "npods"):
        _eq(getattr(jc, f), getattr(tc, f), f)
    assert int(jc.cache.sig) == int(tc.cache.sig) == 0
    for f in tg.GroupCarry._fields:
        _eq(getattr(jc.groups, f), getattr(tc.groups, f), f)
    B = e.valid.shape[0]
    check_case(case, tpk[:e.n].numpy(), tpk[B:].numpy())
