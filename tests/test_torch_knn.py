"""Port vs JAX package: k nearest neighbours (kernel A and its dispatcher).

On the CPU `knn` runs kernel A's plain version; it is held to the JAX
blocked path (`use_pallas=False`) and once to the interpret-mode Pallas
kernel. Indices must be EQUAL (random normal clouds have no near-ties at
fp32). Distances agree to 1e-5 absolute: |q|^2 + |r|^2 - 2 q.r cancels, so
the rounding error scales with |q|^2 + |r|^2 (~1e-6 for these unit-normal
clouds), not with d2, and the two sides round the sum differently (a matmul
or fused multiply-adds on the JAX side, separate ops in the port). Kernel A
itself is held to its plain version in tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.ops.knn import knn as jknn, mean_knn_dist2 as jmean
from mygauhuman_tpu.ops.pallas_knn import knn_small_refs as jknn_small
from mygauhuman_torch.ops.knn import knn, mean_knn_dist2
from mygauhuman_torch.ops.pallas_knn import knn_small_refs

torch.set_num_threads(1)


@pytest.fixture
def clouds():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(700, 3)).astype(np.float32),
            rng.normal(size=(250, 3)).astype(np.float32), rng)


def both(q, r, **kw):
    d_t, i_t = knn(torch.as_tensor(q), torch.as_tensor(r), **kw)
    jkw = dict(kw)
    if "ref_mask" in jkw:
        jkw["ref_mask"] = jnp.asarray(jkw["ref_mask"].numpy())
    d_j, i_j = jknn(jnp.asarray(q), jnp.asarray(r), use_pallas=False, **jkw)
    return d_t.numpy(), i_t.numpy(), np.asarray(d_j), np.asarray(i_j)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_small_refs_match_jax(clouds, k):
    q, r, _ = clouds
    d_t, i_t, d_j, i_j = both(q, r, k=k)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)


def test_mask_exclude_self_and_ties(clouds):
    q, r, rng = clouds
    mask = torch.as_tensor(rng.random(700) > 0.4)
    _, i_t, _, i_j = both(q, q, k=2, ref_mask=mask, exclude_self=True)
    np.testing.assert_array_equal(i_t, i_j)
    # exact ties from duplicated refs: the lower index comes first
    rt = np.concatenate([r[:64], r[:64]])
    _, i_t, _, i_j = both(q, rt, k=3)
    np.testing.assert_array_equal(i_t, i_j)
    assert (i_t[:, 0] < 64).all() and (i_t[:, 1] == i_t[:, 0] + 64).all()


def test_blocked_path_k5(clouds):
    """k > 3 leaves kernel A for the blocked matmul + topk path."""
    q, r, _ = clouds
    d_t, i_t, d_j, i_j = both(q, r, k=5, block_size=256)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)


def test_against_interpret_pallas(clouds):
    q, r, _ = clouds
    q, r = q[:200], r[:150]
    d_t, i_t = knn_small_refs(torch.as_tensor(q), torch.as_tensor(r), 2)
    d_j, i_j = jknn_small(jnp.asarray(q), jnp.asarray(r), k=2, interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-5)


def test_mean_knn_dist2(clouds):
    xs = np.arange(5, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_allclose(mean_knn_dist2(torch.as_tensor(grid)).numpy(), 1.0, atol=1e-5)
    q = clouds[0]
    np.testing.assert_allclose(mean_knn_dist2(torch.as_tensor(q)).numpy(),
                               np.asarray(jmean(jnp.asarray(q))), rtol=1e-5, atol=1e-5)
