"""score_probe (the sanitizer rails' NaN/inf probe): the port ↔ the JAX
package, bit for bit.

Seeded clusters and pending batches are built with the JAX package's
state layer; the numpy arrays go through one scan of each package's
run_batch (so the carry holds placements; the carries are held equal
first) and then through the JAX `score_probe`, jitted on the CPU, and the
port's plain version, for every signature row of the batch. `total` (an
int64 score below 2^24 cast to float32) must be equal exactly; `std` (the
float64 BalancedAllocation std cast to float32) bit for bit, through the
float32 outputs' int32 view — XLA's sum over C ≤ 8 columns and the
port's left-to-right sum give the same bits on these rows. Cases: lean
rows, zero-request pods (the NonZeroRequested columns, and
skip_balanced), a zero-capacity scored column (ephemeral-storage with no
node advertising it), MostAllocated, padded node rows, and a fuzz."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kubernetes_tpu  # noqa: F401  (x64 before any jnp array)
from _torch_parity import (assert_carry_equal, jax_na, jax_table,  # noqa: F401
                           lean_cluster, lean_pod, private_jax_compiles,
                           staged, torch_na, torch_table)
from kubernetes_tpu.ops import program as jp
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.ops import program as tp
from kubernetes_tpu_torch.state import convert

# (score_cols, col_weights, col_nonzero, nonzero_slot): the default, and
# three columns with ephemeral-storage (column 2) scored plainly
COLS_DEFAULT = ((0, 1), (1, 1), (True, True), (0, 1))
COLS_STORAGE = ((0, 1, 2), (1, 2, 1), (True, True, False), (0, 1, 0))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def probe_parity(nodes, pods, strategy="LeastAllocated", cols=COLS_DEFAULT,
                 n_bucket=32):
    """Scan the batch in both packages, then score_probe every distinct
    row at the post-scan carry; returns the number of rows compared."""
    arrays, batch = staged(nodes, pods=pods, n_bucket=n_bucket)
    kw = dict(zip(("score_cols", "col_weights", "col_nonzero",
                   "nonzero_slot"), cols), strategy=strategy)
    cfg_j, cfg_t = jp.ScoreConfig(**kw), tp.ScoreConfig(**kw)
    jna, tna = jax_na(arrays), torch_na(arrays)
    jtab, ttab = jax_table(batch.table), torch_table(batch.table)
    jx = jp.PodXs(*(jnp.asarray(getattr(batch, f))
                    for f in ("valid", "sig", "tidx")))
    tx = convert.pod_xs_from_numpy(batch, "cpu")
    jcarry, _ = jp.run_batch(cfg_j, jna, jp.initial_carry(jna), jx, jtab)
    tcarry, _ = tp.run_batch(cfg_t, tna, tp.initial_carry(tna), tx, ttab)
    assert_carry_equal(jcarry, tcarry, cache=False)
    rows = list(dict.fromkeys(int(t) for t in batch.tidx[:len(pods)]))
    for u in rows:
        j = jp.score_probe(cfg_j, jna, jcarry, jtab, jnp.int32(u))
        t = tp.score_probe(cfg_t, tna, tcarry, ttab, u)
        for what, a, b in zip(("total", "std"), j, t):
            assert b.dtype == torch.float32, what
            assert tuple(b.shape) == tuple(np.asarray(a).shape), what
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                          err_msg=f"row {u} {what}")
    return len(rows)


class TestScoreProbe:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_lean_rows(self, seed):
        rng = random.Random(seed)
        nodes = lean_cluster(rng, 24)
        pods = [lean_pod(rng, f"p{i}") for i in range(40)]
        assert probe_parity(nodes, pods) >= 2

    def test_zero_request_pods(self):
        """All-zero requests: the NonZeroRequested columns in the fit and
        skip_balanced (s_bal = 0 in the total, std still reported)."""
        rng = random.Random(7)
        nodes = lean_cluster(rng, 20, images=False)
        pods = ([make_pod(f"z{i}").req({"cpu": "0", "memory": "0"}).obj()
                 for i in range(6)]
                + [make_pod(f"c{i}").req({"cpu": "0", "memory": "1Gi"})
                   .obj() for i in range(6)]
                + [make_pod(f"m{i}").req({"cpu": "250m", "memory": "0"})
                   .obj() for i in range(6)])
        assert probe_parity(nodes, pods) == 3

    def test_zero_capacity_column(self):
        """A scored column no node advertises (col_ok false everywhere),
        and a node with no cpu."""
        nodes = [make_node(f"n{i}").capacity({
            "cpu": str(2 * (i % 4)), "memory": f"{4 + i}Gi",
            "pods": 110}).obj() for i in range(12)]
        pods = [make_pod(f"p{i}").req({"cpu": "100m", "memory": "512Mi"})
                .obj() for i in range(10)]
        pods.append(make_pod("e").req({"cpu": "0", "memory": "0"}).obj())
        assert probe_parity(nodes, pods, cols=COLS_STORAGE) == 2

    @pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
    def test_strategies_and_weights(self, strategy):
        rng = random.Random(11)
        nodes = lean_cluster(rng, 16)
        pods = [lean_pod(rng, f"p{i}", ports=False) for i in range(30)]
        probe_parity(nodes, pods, strategy=strategy, cols=COLS_STORAGE)

    def test_padded_rows(self):
        """Five nodes padded to 64 rows: the padded rows' total (the
        balanced score of an empty row) and std (0) as JAX computes
        them."""
        nodes = [make_node(f"n{i}").capacity({
            "cpu": "8", "memory": "16Gi", "pods": 110}).obj()
            for i in range(5)]
        pods = [make_pod(f"p{i}").req({"cpu": "1", "memory": "3Gi"}).obj()
                for i in range(8)]
        assert probe_parity(nodes, pods, n_bucket=64) == 1

    @pytest.mark.parametrize("seed", range(4, 10))
    def test_fuzz(self, seed):
        rng = random.Random(seed)
        nodes = lean_cluster(rng, rng.randint(3, 30),
                             images=rng.random() < 0.5)
        pods = [lean_pod(rng, f"p{i}") for i in range(rng.randint(5, 50))]
        probe_parity(nodes, pods, strategy=rng.choice(
            ["LeastAllocated", "MostAllocated"]),
            cols=rng.choice([COLS_DEFAULT, COLS_STORAGE]))


def test_score_probe_refuses_other_devices():
    arrays, batch = staged([make_node("n0").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": 110}).obj()],
        pods=[make_pod("p").req({"cpu": "1", "memory": "1Gi"}).obj()])
    na = convert.node_arrays_from_numpy(arrays, "meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tp.score_probe(tp.ScoreConfig(), na, tp.initial_carry(na),
                       None, 0)
