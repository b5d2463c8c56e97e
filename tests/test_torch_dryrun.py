"""The preemption dry run: the port ↔ the JAX package, exact equality.

Three layers, each held to the JAX package on the same seeded input:

- `dry_run_select_victims`, the device program: random node arrays, a
  random signature row, candidate rows (padded by repetition), victims
  with `victim_valid` holes, a non-zero nominated-pod overlay and, in
  half the cases, spread delta tensors go through the JAX
  `_dry_run_select_victims_jit` on the CPU and the port's plain version;
  the packed [C, V+1] rows must be equal. Its subset entry (a
  preemptor's launch over the candidate positions its nominations touch,
  reading the wave's tensors through them) against the JAX dry run on
  the JAX-gathered inputs.
- `spread_dry_run_tensors`: the same cluster built in each package, each
  package's own PodTopologySpread PreFilter state → equal tensors.
- the Evaluator: the same fuzzed cluster (random priorities with ties,
  PDBs, a spread-constrained preemptor, a pending nomination) built in
  each package → equal candidate lists (node, victims in order, PDB
  violations), equal picked node, the batched dry run equal to the host
  loop, and the same routing (`batched_dry_runs` / `host_dry_runs`),
  including every case the batched dry run leaves to the host loop."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import private_jax_compiles  # noqa: F401
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.framework import interface as jiface
from kubernetes_tpu.framework import types as jft
from kubernetes_tpu.ops import groups as jg
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.plugins import podtopologyspread as jpts
from kubernetes_tpu.plugins.defaultpreemption import (
    DefaultPreemption as JDefaultPreemption)
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.framework import interface as tiface
from kubernetes_tpu_torch.framework import types as tft
from kubernetes_tpu_torch.ops import groups as tg
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.plugins import podtopologyspread as tpts
from kubernetes_tpu_torch.plugins.defaultpreemption import (
    DefaultPreemption as TDefaultPreemption)
from kubernetes_tpu_torch.state import convert
from test_torch_program import _raw_nodes, _raw_table
from test_torch_scheduler import JAX, TORCH

ZONE = "topology.kubernetes.io/zone"

torch.set_num_threads(1)

# per package: (types, framework types, interface, spread plugin module,
# DefaultPreemption class)
_MODS = {id(JAX): (jtypes, jft, jiface, jpts, JDefaultPreemption),
         id(TORCH): (ttypes, tft, tiface, tpts, TDefaultPreemption)}


# ---------------------------------------------------------------------------
# the device program


def _random_dry_run(seed: int, spread: bool, C=16, V=8, SC=2):
    """Seeded numpy inputs of one dry-run launch: 48 node rows, 10 real
    candidates padded to C by repeating the last, V victim slots with
    holes."""
    rs = np.random.RandomState(seed)
    nn = _raw_nodes(rs)
    table = _raw_table(rs)
    N = nn.cap.shape[0]
    # room for the victims' pods, and fewer filter vetoes than the
    # filter fuzz of test_torch_program: most candidates reach the scan
    nn = nn._replace(allowed_pods=rs.randint(3, 12, (N,)).astype(np.int32),
                     unschedulable=rs.rand(N) < 0.05,
                     taint_eff=np.where(rs.rand(*nn.taint_eff.shape) < 0.8,
                                        0, nn.taint_eff).astype(np.int32))
    table = table._replace(
        node_name_id=np.zeros_like(table.node_name_id),
        aff_has=rs.rand(*table.aff_has.shape) < 0.2,
        ns_sel_val=np.where(rs.rand(*table.ns_sel_val.shape) < 0.8, 0,
                            table.ns_sel_val).astype(np.int32))
    R = nn.cap.shape[1]
    u = int(rs.randint(0, table.req.shape[0]))
    real = rs.choice(nn.cap.shape[0], 10, replace=False).astype(np.int32)
    cand = np.concatenate([real, np.full((C - 10,), real[-1], np.int32)])
    victim_req = rs.randint(0, 5, (C, V, R)).astype(np.int64)
    victim_valid = rs.rand(C, V) < 0.7
    victim_valid[10:] = False
    ovl_used = (rs.randint(0, 4, (C, R)) * (rs.rand(C, 1) < 0.5)
                ).astype(np.int64)
    ovl_npods = rs.randint(0, 3, (C,)).astype(np.int32)
    sp = None
    if spread:
        other = rs.randint(0, 6, (C, SC)).astype(np.int32)
        other[rs.rand(C, SC) < 0.2] = np.iinfo(np.int32).max
        sp = jg.DryRunSpread(
            max_skew=rs.randint(1, 4, (SC,)).astype(np.int32),
            self_match=rs.randint(0, 2, (SC,)).astype(np.int32),
            min_zero=rs.rand(SC) < 0.3,
            tv_ok=rs.rand(C, SC) < 0.9,
            cnt0=rs.randint(0, 6, (C, SC)).astype(np.int32),
            other_min=other,
            vic_match=rs.rand(C, V, SC) < 0.5)
    return nn, table, u, cand, victim_req, victim_valid, ovl_used, \
        ovl_npods, sp


def dry_run_both(nn, table, u, cand, victim_req, victim_valid, ovl_used,
                 ovl_npods, sp):
    """(JAX packed, port packed) as numpy bool [C, V+1]."""
    jna = jp.NodeArrays(*(jnp.asarray(x) for x in nn))
    jrow = jp.pod_row_from_table(table, u)
    jpacked = np.asarray(jp._dry_run_select_victims_jit(
        jna, jrow, jnp.asarray(cand), jnp.asarray(victim_req),
        jnp.asarray(victim_valid), jnp.asarray(ovl_used),
        jnp.asarray(ovl_npods),
        None if sp is None else jg.DryRunSpread(
            *(jnp.asarray(x) for x in sp))))
    tna = convert.node_arrays_from_numpy(nn, "cpu")
    trow = tp.pod_row_from_table(table, u, "cpu")
    tpacked = tp.dry_run_select_victims(
        tna, trow, torch.from_numpy(cand), torch.from_numpy(victim_req),
        torch.from_numpy(victim_valid), torch.from_numpy(ovl_used),
        torch.from_numpy(ovl_npods),
        None if sp is None else tg.DryRunSpread(
            *(torch.from_numpy(np.asarray(x)) for x in sp)))
    assert tpacked.dtype == torch.bool
    return jpacked, tpacked.numpy()


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_dry_run_program_parity(seed, spread):
    args = _random_dry_run(seed, spread)
    jpacked, tpacked = dry_run_both(*args)
    assert jpacked.shape == tpacked.shape == (16, 9)
    np.testing.assert_array_equal(jpacked, tpacked)


def test_dry_run_program_covers_both_outcomes():
    """The random cases above reach viable and non-viable candidates and
    both reprieve outcomes (a parity test over all-False rows would hold
    nothing)."""
    fits = reprieved = evicted = 0
    for seed in range(12):
        for spread in (False, True):
            args = _random_dry_run(seed, spread)
            _j, t = dry_run_both(*args)
            valid = args[5]
            fits += int(t[:10, 0].sum())
            reprieved += int((t[:10, 1:] & valid[:10]).sum())
            evicted += int((~t[:10, 1:] & valid[:10]).sum())
    assert fits > 50 and reprieved > 200 and evicted > 200


def test_dry_run_program_without_victims_or_overlay():
    """All-zero overlay and no valid victim: column 0 is the plain fit of
    the node rows, and nothing is reprieved."""
    nn, table, u, cand, vreq, _vv, _ou, _on, _sp = _random_dry_run(
        5, spread=False)
    vvalid = np.zeros((16, 8), bool)
    zero_u = np.zeros((16, nn.cap.shape[1]), np.int64)
    zero_n = np.zeros((16,), np.int32)
    jpacked, tpacked = dry_run_both(nn, table, u, cand, vreq, vvalid,
                                    zero_u, zero_n, None)
    np.testing.assert_array_equal(jpacked, tpacked)
    assert not tpacked[:, 1:].any()


def _subset_positions(rs, s: int, Cp: int) -> np.ndarray:
    """s candidate positions (with repeats when s > Cp), padded to a power
    of two by repeating the first, as i32."""
    sub = rs.choice(Cp, s, replace=s > Cp).astype(np.int32)
    s_pad = 1 << max(s - 1, 0).bit_length()
    return np.concatenate([sub, np.full((s_pad - s,), sub[0], np.int32)])


@pytest.mark.parametrize("s", [1, 3, 256])
@pytest.mark.parametrize("V", [1, 8])
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_dry_run_subset_matches_jax(seed, spread, V, s):
    """The subset entry (a preemptor's launch over the candidates its
    nominations touch, reading the wave's tensors through `sub`) equals
    the JAX dry run on the JAX-gathered inputs, the Evaluator's
    _dry_run_overrides layout: the rows in the order of `sub`, the pad
    repeating its first position."""
    nn, table, u, cand, vreq, vvalid, _ou, _on, sp = _random_dry_run(
        seed, spread, C=32, V=V)
    rs = np.random.RandomState(1000 + seed)
    sub = _subset_positions(rs, s, cand.shape[0])
    s_pad, R = sub.shape[0], nn.cap.shape[1]
    ovl_used = (rs.randint(0, 4, (s_pad, R)) * (rs.rand(s_pad, 1) < 0.5)
                ).astype(np.int64)
    ovl_npods = rs.randint(0, 3, (s_pad,)).astype(np.int32)
    jsub = jnp.asarray(sub)
    jsp = None
    if sp is not None:
        jsp = jg.DryRunSpread(*(jnp.asarray(x) for x in sp))
        jsp = jsp._replace(tv_ok=jsp.tv_ok[jsub], cnt0=jsp.cnt0[jsub],
                           other_min=jsp.other_min[jsub],
                           vic_match=jsp.vic_match[jsub])
    want = np.asarray(jp.dry_run_select_victims(
        jp.NodeArrays(*(jnp.asarray(x) for x in nn)),
        jp.pod_row_from_table(table, u), jnp.asarray(cand)[jsub],
        jnp.asarray(vreq)[jsub], jnp.asarray(vvalid)[jsub],
        jnp.asarray(ovl_used), jnp.asarray(ovl_npods), jsp))
    wave = tp.DryRunWave(
        convert.node_arrays_from_numpy(nn, "cpu"),
        tp.pod_row_from_table(table, u, "cpu"), torch.from_numpy(cand),
        torch.from_numpy(vreq), torch.from_numpy(vvalid),
        None if sp is None else tg.DryRunSpread(
            *(torch.from_numpy(np.asarray(x)) for x in sp)))
    got = tp.dry_run_select_victims_subset(
        wave, *tp.dry_run_subset_inputs(sub, ovl_used, ovl_npods, "cpu"),
        tp.dry_run_args(wave))
    assert got.dtype == torch.bool and got.shape == (s_pad, V + 1)
    np.testing.assert_array_equal(want, got.numpy())
    # the full wave through the same entry (no `sub`) is the dry run
    full = tp.dry_run_select_victims_subset(
        wave, None, torch.zeros((cand.shape[0], R), dtype=torch.int64),
        torch.zeros((cand.shape[0],), dtype=torch.int32))
    np.testing.assert_array_equal(full.numpy()[sub],
                                  tp.dry_run_select_victims_subset(
                                      wave, torch.from_numpy(sub),
                                      torch.zeros((s_pad, R),
                                                  dtype=torch.int64),
                                      torch.zeros((s_pad,),
                                                  dtype=torch.int32)).numpy())


def test_dry_run_subset_inputs_share_one_buffer():
    """The Evaluator's staging of a subset launch: the positions, the
    overlay rows and the pod counts as views of ONE buffer, equal to the
    numpy values, at an odd and an even subset length."""
    rs = np.random.RandomState(4)
    for s in (3, 8):
        sub = rs.randint(0, 50, s).astype(np.int32)
        ou = rs.randint(-(1 << 40), 1 << 40, (s, 5)).astype(np.int64)
        on = rs.randint(-3, 110, s).astype(np.int32)
        ts, tu, tn = tp.dry_run_subset_inputs(sub, ou, on, "cpu")
        assert (ts.dtype, tu.dtype, tn.dtype) == (torch.int32, torch.int64,
                                                 torch.int32)
        assert ts.is_contiguous() and tu.is_contiguous() \
            and tn.is_contiguous()
        assert ts.untyped_storage().data_ptr() == \
            tu.untyped_storage().data_ptr() == \
            tn.untyped_storage().data_ptr()
        np.testing.assert_array_equal(ts.numpy(), sub)
        np.testing.assert_array_equal(tu.numpy(), ou)
        np.testing.assert_array_equal(tn.numpy(), on)


def test_dry_run_spread_ok_parity():
    rs = np.random.RandomState(3)
    C, SC = 64, 3
    other = rs.randint(0, 6, (C, SC)).astype(np.int32)
    other[rs.rand(C, SC) < 0.3] = np.iinfo(np.int32).max
    sp = jg.DryRunSpread(
        max_skew=np.array([1, 2, 3], np.int32),
        self_match=np.array([1, 0, 1], np.int32),
        min_zero=np.array([False, True, False]),
        tv_ok=rs.rand(C, SC) < 0.8,
        cnt0=rs.randint(0, 8, (C, SC)).astype(np.int32),
        other_min=other, vic_match=np.zeros((C, 1, SC), bool))
    removed = rs.randint(0, 4, (C, SC)).astype(np.int32)
    want = np.asarray(jp._dry_run_spread_ok(
        jg.DryRunSpread(*(jnp.asarray(x) for x in sp)),
        jnp.asarray(removed)))
    got = tp._dry_run_spread_ok(
        tg.DryRunSpread(*(torch.from_numpy(np.asarray(x)) for x in sp)),
        torch.from_numpy(removed)).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# the Evaluator, on the same fuzzed cluster in both packages


def _evaluator(pkg, sched):
    DP = _MODS[id(pkg)][4]
    prof = next(iter(sched.profiles.values()))
    dp = next(p for p in prof.framework.plugins if isinstance(p, DP))
    return dp._evaluator


def _canon(candidates):
    return [(c.node_name, [pi.pod.uid for pi in c.victims],
             c.num_pdb_violations) for c in candidates]


def _sched(pkg, api):
    _w, _Api, Sched, kw = pkg
    sched = Sched(api, batch_size=64, **kw)
    if Sched is JAX[2]:
        sched.profiler = None
        sched.audit = None
        sched._probe_enabled = False
    return sched


def fuzz_cluster(pkg, seed, spread=False, pdb=False, nominate=False):
    """tests/test_preemption_batched.py _fuzz_cluster, in package `pkg`."""
    w, Api = pkg[0], pkg[1]
    types, ft = _MODS[id(pkg)][0], _MODS[id(pkg)][1]
    rng = random.Random(seed)
    api = Api()
    sched = _sched(pkg, api)
    n_nodes = rng.randint(3, 8)
    zones = rng.randint(1, 3)
    for i in range(n_nodes):
        api.create_node(
            w.make_node(f"n{i}")
            .capacity({"cpu": rng.choice([4, 6, 8]), "memory": "16Gi",
                       "pods": rng.choice([4, 110])})
            .zone(f"z{i % zones}").obj())
    uid = 0
    for i in range(n_nodes):
        for _ in range(rng.randint(0, 4)):
            p = w.make_pod(f"p{uid}").req(
                {"cpu": str(rng.choice([1, 2, 3])), "memory": "1Gi"})
            p = p.priority(rng.choice([0, 0, 5, 5, 10, 50]))
            if rng.random() < 0.6:
                p = p.label("app", rng.choice(["a", "b"]))
            if spread and rng.random() < 0.6:
                p = p.label("sp", "yes")
            pod = p.obj()
            api.create_pod(pod)
            api.bind(pod, f"n{i}")
            uid += 1
    if pdb:
        for j, sel in enumerate(rng.sample([{"app": "a"}, {"app": "b"},
                                            {"app": "a"}],
                                           rng.randint(1, 2))):
            api.create_pdb(types.PodDisruptionBudget(
                metadata=types.ObjectMeta(name=f"pdb{j}"),
                selector=types.LabelSelector.of(match_labels=sel),
                min_available=rng.choice([1, 2, "50%", "100%"])))
    p = w.make_pod("preemptor").req(
        {"cpu": str(rng.choice([2, 4, 6])), "memory": "2Gi"}).priority(
            rng.choice([7, 20, 100]))
    if spread:
        p = p.label("sp", "yes").spread_constraint(
            rng.choice([1, 2]), ZONE, "DoNotSchedule", {"sp": "yes"})
    preemptor = p.obj()
    if nominate:
        nom = w.make_pod("nominated").req({"cpu": "2", "memory": "1Gi"}) \
            .priority(200).obj()
        sched.queue.nominator.add(
            ft.QueuedPodInfo(pod_info=ft.PodInfo.of(nom)),
            f"n{rng.randrange(n_nodes)}")
    return api, sched, preemptor


def run_both_tiers(pkg, sched, pod, require_batched=True):
    """(batched, host) candidate lists of one package's Evaluator."""
    ft, iface = _MODS[id(pkg)][1], _MODS[id(pkg)][2]
    sched.cache.update_snapshot(sched.snapshot)
    nodes = sched.snapshot.node_info_list
    ev = _evaluator(pkg, sched)
    potential = ev.nodes_where_preemption_might_help(nodes, ft.Diagnosis())
    num = ev.get_num_candidates(len(potential))
    pdbs = ev.pdb_lister() if ev.pdb_lister is not None else []
    batched = ev._dry_run_batched(pod, potential, num, nodes, pdbs)
    if require_batched:
        assert batched is not None, "case unexpectedly left to the host"
    if pkg is TORCH:
        host = ev._dry_run_host(pod, potential, num, nodes, pdbs)
    else:
        # the JAX Evaluator takes its host loop without a device context
        ctx, ev.device_ctx = ev.device_ctx, None
        try:
            host = ev.dry_run_preemption(iface.CycleState(), pod, potential,
                                         num, all_nodes=nodes)
        finally:
            ev.device_ctx = ctx
    return batched, host


def preempt_pick(pkg, sched, pod):
    ft, iface = _MODS[id(pkg)][1], _MODS[id(pkg)][2]
    sched.cache.update_snapshot(sched.snapshot)
    ev = _evaluator(pkg, sched)
    best, status = ev.preempt(iface.CycleState(), pod,
                              sched.snapshot.node_info_list, ft.Diagnosis())
    return (None if best is None else _canon([best])[0],
            status.is_success(), ev.batched_dry_runs, ev.host_dry_runs)


def _evaluator_parity(seed, **kw):
    outs = []
    for pkg in (JAX, TORCH):
        _api, sched, pod = fuzz_cluster(pkg, seed, **kw)
        batched, host = run_both_tiers(pkg, sched, pod)
        assert _canon(batched) == _canon(host)
        outs.append((_canon(batched), preempt_pick(pkg, sched, pod)))
    assert outs[1] == outs[0]
    return outs[1]


class TestEvaluatorParity:
    @pytest.mark.parametrize("seed", range(16))
    def test_basic(self, seed):
        _evaluator_parity(seed)

    @pytest.mark.parametrize("seed", range(80, 92))
    def test_pdb(self, seed):
        _evaluator_parity(seed, pdb=True)

    @pytest.mark.parametrize("seed", range(140, 152))
    def test_spread(self, seed):
        _evaluator_parity(seed, spread=True, pdb=seed % 3 == 0)

    @pytest.mark.parametrize("seed", range(190, 202))
    def test_nominated_overlay(self, seed):
        _evaluator_parity(seed, nominate=True, pdb=seed % 3 == 0)

    def test_cases_reach_candidates(self):
        """The fuzzed cases find candidates and victims: a parity over
        empty lists would hold nothing."""
        found = victims = 0
        for seed in range(16):
            cands, _pick = _evaluator_parity(seed)
            found += len(cands)
            victims += sum(len(v) for _n, v, _p in cands)
        assert found >= 10 and victims >= 10

    def test_priority_tie_exact_order(self):
        """Equal-priority victims reprieve in creation order: the victim
        LIST, not just the set, is equal (tie0 is reprieved first, the
        later two are evicted)."""
        outs = []
        for pkg in (JAX, TORCH):
            w, Api = pkg[0], pkg[1]
            api = Api()
            sched = _sched(pkg, api)
            api.create_node(w.make_node("n0").capacity(
                {"cpu": 6, "memory": "16Gi", "pods": 110}).obj())
            for i in range(3):
                p = w.make_pod(f"tie{i}").req({"cpu": "2", "memory": "1Gi"}) \
                    .priority(5).obj()
                api.create_pod(p)
                api.bind(p, "n0")
            pod = w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
                .priority(50).obj()
            batched, host = run_both_tiers(pkg, sched, pod)
            assert _canon(batched) == _canon(host)
            outs.append(_canon(batched))
        assert outs[1] == outs[0]
        assert outs[1][0][1] == ["default/tie1", "default/tie2"]


# ---------------------------------------------------------------------------
# spread delta tensors


def _spread_tensors(pkg, seed):
    api, sched, pod = fuzz_cluster(pkg, seed, spread=True)
    iface, pts = _MODS[id(pkg)][2], _MODS[id(pkg)][3]
    groups = jg if pkg is JAX else tg
    sched.cache.update_snapshot(sched.snapshot)
    nodes = sched.snapshot.node_info_list
    fwk = next(iter(sched.profiles.values())).framework
    cs = iface.CycleState()
    _, status = fwk.run_pre_filter_plugins(cs, pod, nodes)
    assert status.is_success()
    s = cs.read_or_none(pts._PRE_FILTER_KEY)
    cands = [ni for ni in nodes
             if any(pi.pod.spec.priority < pod.spec.priority
                    for pi in ni.pods)]
    victims = [sorted((pi for pi in ni.pods
                       if pi.pod.spec.priority < pod.spec.priority),
                      key=lambda pi: (-pi.pod.spec.priority,
                                      pi.pod.metadata.creation_index))
               for ni in cands]
    return groups.spread_dry_run_tensors(s, pod, cands, victims, 8, 4)


@pytest.mark.parametrize("seed", range(140, 146))
def test_spread_dry_run_tensors_parity(seed):
    jt, tt = _spread_tensors(JAX, seed), _spread_tensors(TORCH, seed)
    for f in jg.DryRunSpread._fields:
        a, b = np.asarray(getattr(jt, f)), np.asarray(getattr(tt, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# the cases the batched dry run leaves to the host loop, in both packages


def _one_node(pkg, cpu=4):
    w, Api = pkg[0], pkg[1]
    api = Api()
    sched = _sched(pkg, api)
    api.create_node(w.make_node("n0").capacity(
        {"cpu": cpu, "memory": "16Gi", "pods": 200}).zone("z0").obj())
    return w, api, sched


def _bind_low(w, api, name="low", cpu="4", **kw):
    p = w.make_pod(name).req({"cpu": cpu, "memory": "1Gi"})
    if kw.get("anti"):
        p = p.label("x", "y").pod_affinity(ZONE, {"x": "y"}, anti=True)
    pod = p.obj()
    api.create_pod(pod)
    api.bind(pod, "n0")


def _case_preemptor_affinity(pkg):
    w, api, sched = _one_node(pkg)
    _bind_low(w, api)
    return sched, w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(50).label("x", "y") \
        .pod_affinity(ZONE, {"x": "y"}, anti=True).obj()


def _case_cluster_anti(pkg):
    w, api, sched = _one_node(pkg)
    _bind_low(w, api, anti=True)
    return sched, w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(50).obj()


def _case_host_port(pkg):
    w, api, sched = _one_node(pkg)
    _bind_low(w, api)
    return sched, w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(50).host_port(8080).obj()


def _case_many_victims(pkg):
    w, api, sched = _one_node(pkg, cpu=130)
    for i in range(129):
        _bind_low(w, api, name=f"low{i}", cpu="1")
    return sched, w.make_pod("vip").req({"cpu": "4", "memory": "1Gi"}) \
        .priority(50).obj()


def _case_nominated_anti(pkg):
    w, api, sched = _one_node(pkg, cpu=8)
    _bind_low(w, api)
    ft = _MODS[id(pkg)][1]
    nom = w.make_pod("nom").req({"cpu": "1", "memory": "1Gi"}) \
        .priority(200).label("x", "y") \
        .pod_affinity(ZONE, {"x": "y"}, anti=True).obj()
    sched.queue.nominator.add(ft.QueuedPodInfo(pod_info=ft.PodInfo.of(nom)),
                              "n0")
    return sched, w.make_pod("vip").req({"cpu": "6", "memory": "1Gi"}) \
        .priority(50).obj()


def _case_nominated_spread(pkg):
    w, api, sched = _one_node(pkg, cpu=8)
    _bind_low(w, api)
    ft = _MODS[id(pkg)][1]
    nom = w.make_pod("nom").req({"cpu": "1", "memory": "1Gi"}) \
        .priority(200).label("sp", "yes").obj()
    sched.queue.nominator.add(ft.QueuedPodInfo(pod_info=ft.PodInfo.of(nom)),
                              "n0")
    return sched, w.make_pod("vip").req({"cpu": "6", "memory": "1Gi"}) \
        .priority(50).label("sp", "yes") \
        .spread_constraint(1, ZONE, "DoNotSchedule", {"sp": "yes"}).obj()


@pytest.mark.parametrize("case", [
    _case_preemptor_affinity, _case_cluster_anti, _case_host_port,
    _case_many_victims, _case_nominated_anti, _case_nominated_spread])
def test_boundary_cases_use_the_host_loop(case):
    outs = []
    for pkg in (JAX, TORCH):
        sched, pod = case(pkg)
        batched, host = run_both_tiers(pkg, sched, pod,
                                       require_batched=False)
        assert batched is None
        outs.append((_canon(host), preempt_pick(pkg, sched, pod)))
    assert outs[1] == outs[0]
    # the host tier of run_both_tiers, then preempt: two host dry runs
    _cands, (_pick, _ok, n_batched, n_host) = outs[1]
    assert (n_batched, n_host) == (0, 2)


def test_request_vector_outside_the_table():
    """A resource name outside the staging table has no vector in either
    package (the dry run then takes the host loop)."""
    from kubernetes_tpu.state.tensorize import ClusterState as JState
    from kubernetes_tpu_torch.state.tensorize import ClusterState as TState
    for State in (JState, TState):
        st = State()
        assert st.request_vector({"example.com/gpu": 1}) is None
        vec = st.request_vector({"cpu": 500, "memory": 1 << 20})
        assert vec.dtype == np.int64 and vec.sum() == 500 + (1 << 20)
