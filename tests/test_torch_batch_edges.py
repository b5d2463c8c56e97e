"""run_batch's edge inputs (tests/_batch_edges.py RUN_BATCH_EDGE_CASES) —
the node-axis partitions of the port's CUDA design (csrc/run_batch.cu: a
thread-block cluster, a contiguous range of rows a CTA) and the scan's
corners — through the port's plain version and the JAX package's
`run_batch` on the CPU, in the lean, overlay and group modes.

The card holds the kernel against the port's plain version on these same
inputs (tests/test_torch_cuda.py); here the plain version is held against
the JAX package. Each case is staged once with the JAX package's state
layer; the numpy arrays go through the JAX `run_batch` and, converted,
through the port's `run_batch` on CPU tensors (its plain version). A pod
whose table row is out of range has no counterpart in either (the kernel
reports -2 and skips it), so both take the span without it.

Tolerance: exact. The assignments, every carry field, the SigCache and
the whole group carry, dtypes included; the caller's overlay unwritten."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _batch_edges import (RUN_BATCH_EDGE_CASES, check_span, full_span,
                          kept, stage)
from _torch_parity import (private_jax_compiles,  # noqa: F401
                           CPU, assert_carry_equal, jax_na, jax_table,
                           torch_na, torch_table)
from types import SimpleNamespace

from kubernetes_tpu.backend.cache import Cache, Snapshot
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.state.batch import BatchBuilder, BatchDims
from kubernetes_tpu.state.tensorize import ClusterState
from kubernetes_tpu.testing import wrappers
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

JAX_STATE = SimpleNamespace(Cache=Cache, Snapshot=Snapshot,
                            ClusterState=ClusterState,
                            BatchBuilder=BatchBuilder, BatchDims=BatchDims,
                            W=wrappers)


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("case", sorted(RUN_BATCH_EDGE_CASES))
def test_run_batch_edges_match_jax(case):
    e = stage(case, JAX_STATE)
    keep = kept(e)
    xs = jp.PodXs(valid=e.valid[keep], sig=e.sig[keep], tidx=e.tidx[keep],
                  nom_idx=None if e.nom_idx is None else e.nom_idx[keep])
    jna, tna = jax_na(e.arrays), torch_na(e.arrays)
    jgd = jgc = tgd = tgc = jfam = None
    if e.mode == "groups":
        jgd, jgc = jg.to_device(e.gd), jg.to_device(e.gc)
        tgd = convert.groups_dev_from_numpy(e.gd, CPU)
        tgc = convert.group_carry_from_numpy(e.gc, CPU)
        jfam = jg.GroupFamilies(*e.fam)
    jovl = tovl = None
    if e.mode == "ovl":
        jovl = (jnp.asarray(e.ovl_used), jnp.asarray(e.ovl_npods))
        tovl = (torch.from_numpy(e.ovl_used.copy()),
                torch.from_numpy(e.ovl_npods.copy()))
    jc, ja = jp.run_batch(
        jp.ScoreConfig(), jna, jp.initial_carry(jna, jgc),
        jp.PodXs(*(None if x is None else jnp.asarray(x) for x in xs)),
        jax_table(e.table), jgd, jfam, overlay=jovl)
    tc, ta = tp.run_batch(
        tp.ScoreConfig(), tna, tp.initial_carry(tna, tgc),
        convert.pod_xs_from_numpy(xs, CPU), torch_table(e.table), tgd,
        None if e.fam is None else tg.GroupFamilies(*e.fam), overlay=tovl)
    _eq(ja, ta, "assignments")
    assert_carry_equal(jc, tc)
    if e.mode == "groups":
        for f in tg.GroupCarry._fields:
            _eq(getattr(jc.groups, f), getattr(tc.groups, f), f)
    if tovl is not None:
        np.testing.assert_array_equal(tovl[0].numpy(), e.ovl_used)
        np.testing.assert_array_equal(tovl[1].numpy(), e.ovl_npods)
    check_span(case, full_span(e, ta.numpy()))
