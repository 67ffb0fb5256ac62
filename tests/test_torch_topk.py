"""Port selection primitives vs the JAX package's, bitwise.

The same numpy inputs (made from a seed) go through ``ops/topk.py`` of both
packages; scores and ids must agree bit for bit, including ties from
duplicate values, signed zeros and k beyond the candidate count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.ops import topk as jtopk
from autorag_research_tpu_torch.ops import topk as ttopk


def _tie_heavy(rng, shape):
    # few distinct values -> many exact ties; ids shuffled, not ascending
    scores = rng.choice(np.array([0.5, 0.25, 0.0, -0.0, -1.0], np.float32), size=shape)
    ids = np.stack([rng.permutation(shape[-1]) for _ in range(int(np.prod(shape[:-1])))])
    return scores, ids.reshape(shape).astype(np.int32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("m,k", [(12, 5), (7, 7), (4, 9)])
def test_sort_topk_bitwise(m, k):
    rng = np.random.default_rng(m * 10 + k)
    scores, ids = _tie_heavy(rng, (6, m))
    js, ji = jtopk.sort_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    ts, ti = ttopk.sort_topk(torch.from_numpy(scores), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_merge_topk_bitwise_and_partition_invariant():
    rng = np.random.default_rng(3)
    scores, ids = _tie_heavy(rng, (4, 3, 6))
    js, ji = jtopk.merge_topk(jnp.asarray(scores), jnp.asarray(ids), 8)
    ts, ti = ttopk.merge_topk(torch.from_numpy(scores), torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    # another partition of the same candidates gives the same result
    ts2, ti2 = ttopk.merge_topk(
        torch.from_numpy(scores.reshape(4, 2, 9)), torch.from_numpy(ids.reshape(4, 2, 9)), 8
    )
    np.testing.assert_array_equal(ti2.numpy(), ti.numpy())


def test_pad_to_k_sentinels():
    s = np.arange(6, dtype=np.float32).reshape(2, 3)
    i = np.arange(6, dtype=np.int32).reshape(2, 3)
    js, ji = jtopk.pad_to_k(jnp.asarray(s), jnp.asarray(i), 5, 3)
    ts, ti = ttopk.pad_to_k(torch.from_numpy(s), torch.from_numpy(i), 5, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert ttopk.NEG_INF == jtopk.NEG_INF and ttopk.INT_MAX == jtopk.INT_MAX


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_ordered_matches_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    scores, _ = _tie_heavy(rng, (5, 40))
    scores[:, 7] = rng.normal(size=5).astype(np.float32)  # some distinct values
    js, ji = jax.lax.top_k(jnp.asarray(scores), 11)
    ts, ti = ttopk.topk_ordered(torch.from_numpy(scores), 11)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_topk_ordered_signed_zero_and_sentinels():
    # lax.top_k ranks +0.0 above -0.0; NEG_INF pads rank last, lower index first
    scores = np.array([[-0.0, 0.0, jtopk.NEG_INF, -0.0, 0.0, jtopk.NEG_INF]], np.float32)
    js, ji = jax.lax.top_k(jnp.asarray(scores), 6)
    ts, ti = ttopk.topk_ordered(torch.from_numpy(scores), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


@pytest.mark.parametrize("ties", [True, False], ids=["boundary-ties", "distinct"])
def test_topk_ordered_candidate_path_matches_lax_top_k(monkeypatch, ties):
    # the path large inputs take: f32 candidates, key order, key fallback for
    # rows with a tie at the k-th value
    monkeypatch.setattr(ttopk, "KEY_DIRECT_MAX_ELEMENTS", 0)
    rng = np.random.default_rng(7)
    if ties:
        scores, _ = _tie_heavy(rng, (6, 50))
        scores[0] = rng.normal(size=50).astype(np.float32)  # one row without ties
    else:
        scores = rng.normal(size=(6, 50)).astype(np.float32)
        scores[1, [3, 9]] = scores[1, 20]  # a tie inside the top-k, not at its edge
        scores[1, 20] = 9.0
    js, ji = jax.lax.top_k(jnp.asarray(scores), 9)
    ts, ti = ttopk.topk_ordered(torch.from_numpy(scores), 9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
