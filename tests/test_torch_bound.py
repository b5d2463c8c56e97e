"""chip_smoke.py's roofline bound counts only the work the data needs, and
the kernel wrappers' output carry never aliases what the kernel writes."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from kubernetes_tpu_torch.ops import kernels  # noqa: E402
from kubernetes_tpu_torch.ops.program import initial_carry  # noqa: E402


@pytest.fixture(scope="module")
def pkg():
    return cs._Pkg()


def _row_ops(pkg, taint: bool):
    W = pkg.wrappers
    nodes = []
    for i in range(6):
        w = W.make_node(f"n{i}").capacity(
            {"cpu": 8, "memory": "16Gi", "pods": 110}).label("disk", "ssd")
        if taint and i == 2:
            w = w.taint("dedicated", "batch", effect="NoSchedule")
        nodes.append(w.obj())
    pod = W.make_pod("p").req({"cpu": "1", "memory": "1Gi"}).toleration(
        key="dedicated", operator="Exists").toleration(
        key="spot", operator="Exists").obj()
    na, batch, table = cs.staged(nodes, (), [pod], "cpu", pkg)
    carry = initial_carry(na)
    slots = cs.node_slots(na, carry)
    return cs.eval_ops(table, int(batch.tidx[0]), slots, 2), na


def test_eval_ops_counts_occupied_taint_slots_only(pkg):
    plain, _ = _row_ops(pkg, taint=False)
    tainted, na = _row_ops(pkg, taint=True)
    assert na.taint_key.shape[1] > 1   # padded taint slots exist
    # one occupied taint: its effect test plus 4 compares per live
    # toleration (2); the padded slots and padded nodes add nothing
    assert tainted.i32 - plain.i32 == 1 + 4 * 2
    assert (tainted.i64, tainted.f64) == (plain.i64, plain.f64)


def test_ops_price_int64_as_two_int32_and_pipes_side_by_side():
    assert cs.Ops(i64=1000).seconds() == pytest.approx(
        2000 / cs.INT32_OPS_PER_S)
    both = cs.Ops(i32=1000, f64=3000).seconds()
    assert both == pytest.approx(3000 / cs.F64_OPS_PER_S)
    ms, by = cs.bound_of(0, cs.Ops(i32=10 ** 9))
    assert by == "operations" and ms == pytest.approx(
        1e3 * 1e9 / cs.INT32_OPS_PER_S)
    assert cs.select_ops(8, 4).i64 == 7 + 4 * 2


@pytest.mark.parametrize("scan", [True, False])
def test_out_carry_never_aliases_written_fields(pkg, scan):
    """The scan's output carry (copies of the input) and the closed
    form's (fresh tensors the kernel writes in full) never alias a field
    the kernel writes."""
    W = pkg.wrappers
    nodes = [W.make_node(f"n{i}").capacity({"cpu": 4, "pods": 10}).obj()
             for i in range(3)]
    pod = W.make_pod("p").req({"cpu": "1"}).obj()
    na, _, _ = cs.staged(nodes, (), [pod], "cpu", pkg)
    carry = initial_carry(na)
    out = (kernels._out_carry(carry) if scan
           else kernels._fresh_carry(carry))
    for f in ("used", "nonzero_used", "npods"):
        assert getattr(out, f).data_ptr() != getattr(carry, f).data_ptr()
        assert (getattr(out, f).dtype, getattr(out, f).shape) == (
            getattr(carry, f).dtype, getattr(carry, f).shape)
        if scan:
            assert torch.equal(getattr(out, f), getattr(carry, f))
    # the scan writes port ids; run_uniform leaves them to its input
    assert (out.ports.data_ptr() != carry.ports.data_ptr()) == scan
    for a, b in zip(out.cache, carry.cache):
        assert a.data_ptr() != b.data_ptr()
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        if scan:
            assert torch.equal(a, b)


def _dry_case(pkg):
    """PreemptionChurn's dry-run layout on six nodes: eight candidate
    slots (two pad with row 0), one 4-cpu victim each, the 8-cpu / 1 Gi
    preemptor (no selector, no toleration)."""
    args, real, _vec = cs.dry_inputs(torch, pkg, "cpu", 8, 1, False, seed=1,
                                     n_nodes=6)
    return args, real


def test_dry_bytes_charge_requested_columns_and_read_slots_only(pkg):
    args, _real = _dry_case(pkg)
    na, row = args[0], args[1]
    assert na.cap.shape[1] > 2      # unrequested resource columns exist
    assert (cs.np_of(na.label_key) != 0).any()   # label slots not read
    fields = ("req", "tol_op", "tol_key", "tol_val", "tol_eff",
              "ns_sel_val", "node_name_id", "tolerates_unsched", "aff_has")
    row_bytes = cs.nbytes(tuple(getattr(row, f) for f in fields))
    # six distinct node rows: valid (1), npods and allowed (4 + 4), cap and
    # used on the two requested columns (2 · 16), unschedulable (1); eight
    # candidates: row index (4), the victim's and the overlay's requested
    # columns (16 + 16), the overlay count (4), victim_valid (1), output (2)
    assert cs.dry_bytes(na, row, args) == 6 * 42 + row_bytes + 8 * 43


def test_dry_ops_count_requested_columns_and_valid_victims(pkg):
    args, real = _dry_case(pkg)
    na, row = args[0], args[1]
    slots = cs.node_slots(na, initial_carry(na))
    ops = cs.dry_ops(na, row, args, real, slots)
    # per real candidate 4 int32 filter tests and 4 · 2 + 2 int64, the
    # same again per valid victim
    assert (ops.i32, ops.i64, ops.f64) == (4 * 6, 6 * 10 + 6 * 10, 0)
