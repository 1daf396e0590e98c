"""Port vs JAX package: the blend backward (kernel D's plain version) and the
differentiable instance-list blend `blend_pallas`.

The scene is 2 x 2 tiles of 16 x 16 px with C = 19 channels, built by hand
so that every branch of the backward is taken: a saturating stack (T falls
below 1e-4 inside the tile's list), a splat whose opacity times exp(power)
passes the 0.99 clamp, an indefinite conic (power > 0 on some pixels), and
tiles whose counts are capped at K.

Tolerance: each gradient component within 1e-4 max|JAX| + 1e-6. The JAX
kernel forms dL/dalpha from an explicit suffix sum while the port's plain
version is autograd through the log-space cumsum, so the two agree to
float32 rounding (measured ~1e-7 relative); the bound is the one the chip
run holds kernel D to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.ops import pallas_blend as jpb
from mygauhuman_tpu.ops.binning import bin_gaussians as jbin
from mygauhuman_tpu.ops.pallas_blend_bwd import blend_tiles_bwd_raw as jbwd
from mygauhuman_torch.ops import pallas_blend as tpb
from mygauhuman_torch.ops.pallas_blend_bwd import blend_tiles_bwd_plain, blend_tiles_bwd_raw

torch.set_num_threads(1)
W = H = 32
C = 19
K = 24          # tile capacity: the stack and the bottom-right cluster overflow it


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want):
    want = np.asarray(want)
    atol = 1e-4 * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


def scene(seed=0):
    """Per-Gaussian inputs (numpy) and the JAX binning of them."""
    rng = np.random.RandomState(seed)
    m2, con, op, rad = [], [], [], []

    def add(n, centre, spread, conic, opac, radius):
        m2.append(np.asarray(centre) + spread * rng.randn(n, 2))
        con.append(np.tile(conic, (n, 1)))
        op.append(np.full(n, opac) if np.isscalar(opac) else opac)
        rad.append(np.full(n, radius))

    add(40, (6.0, 6.0), 1.0, (0.16, 0.0, 0.16), 0.97, 8)       # saturating stack
    add(1, (24.2, 8.3), 0.0, (1 / 16, 0.0, 1 / 16), 0.9999, 8)  # 0.99 clamp
    add(1, (8.0, 24.0), 0.0, (0.1, 0.3, 0.1), 0.8, 6)           # indefinite conic
    add(30, (24.0, 24.0), 2.0, (0.05, 0.01, 0.08), 0.5, 10)     # K-capped cluster
    add(20, (16.0, 16.0), 8.0, (0.08, -0.02, 0.06),
        rng.rand(20) * 0.8 + 0.1, 9)                            # the rest
    f32 = lambda a: np.concatenate(a).astype(np.float32)        # noqa: E731
    means2d, conics, opac = f32(m2), f32(con), f32(op)
    n = means2d.shape[0]
    depths = (2.0 + rng.rand(n)).astype(np.float32)
    feats = rng.rand(n, C).astype(np.float32)
    radii = np.concatenate(rad).astype(np.int32)
    bins = jbin(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
                jnp.ones(n, bool), width=W, height=H, tile_capacity=K)
    assert int(jnp.max(bins.counts)) > K
    return dict(means2d=means2d, conics=conics, opac=opac, depths=depths, feats=feats,
                bins=bins, counts=jnp.minimum(bins.counts, K))


@pytest.fixture(scope="module")
def sc():
    return scene()


def test_plain_kernel_d_matches_interpret_pallas(sc):
    b = sc["bins"]
    inst = jpb.build_instance_data(b.sorted_rank, b.starts, sc["counts"],
                                   jnp.asarray(sc["means2d"]), jnp.asarray(sc["conics"]),
                                   jnp.asarray(sc["opac"]), jnp.asarray(sc["depths"]),
                                   jnp.asarray(sc["feats"]), order=b.order)
    D = inst.data.shape[0]
    cf = D - 8
    rng = np.random.RandomState(1)
    cot = rng.randn(4, 256, cf + 3).astype(np.float32)
    cot[:, :, C:cf] = 0.0          # the feature pad carries no cotangent
    want = jbwd(inst.data, inst.starts, inst.counts, jnp.zeros((1,), jnp.int32),
                jnp.asarray(cot), n_tiles=4, tiles_x=2, interpret=True)
    want = np.asarray(want)[:, :D]
    got = blend_tiles_bwd_raw(t(inst.data), t(inst.starts), t(inst.counts), 0, t(cot),
                              n_tiles=4, tiles_x=2)
    assert got.shape == want.shape
    close(got.numpy(), want)
    # every branch carries signal: position, conic, opacity, depth, features
    for row in (0, 1, 2, 3, 4, 5, 6, 8):
        assert np.abs(want[:, row]).max() > 1e-4, row
    # the saturating tile really terminates: T_final bottoms out near 1e-4
    out = tpb.blend_instances_plain(t(inst.data), t(inst.starts), t(inst.counts), 0,
                                    n_tiles=4, tiles_x=2, n_channels=cf)
    assert float(out[0, cf + 2].min()) < 2e-4
    # a later tile_base addresses other pixels
    got2 = blend_tiles_bwd_plain(t(inst.data), t(inst.starts)[2:], t(inst.counts)[2:], 2,
                                 t(cot)[2:], n_tiles=2, tiles_x=2)
    want2 = jbwd(inst.data, inst.starts[2:], inst.counts[2:], jnp.asarray([2], jnp.int32),
                 jnp.asarray(cot[2:]), n_tiles=2, tiles_x=2, interpret=True)
    close(got2.numpy(), np.asarray(want2)[:, :D])


def test_blend_pallas_grads_match_jax_and_are_bit_stable(sc):
    b = sc["bins"]
    rng = np.random.RandomState(2)
    g_img = rng.randn(H, W, C).astype(np.float32)
    g_alpha, g_depth, g_t = (rng.randn(H, W).astype(np.float32) for _ in range(3))
    bg = np.linspace(0.1, 0.9, C).astype(np.float32)
    names = ("means2d", "conics", "opac", "feats", "depths")

    def jloss(m2, con, op, feat, dep, bgv):
        out = jpb.blend_pallas(b.sorted_rank, b.order, b.rank, b.starts, sc["counts"],
                               m2, con, op, feat, dep, bgv, W, H, 16, 16, 64, K, True, True)
        return (jnp.sum(out.image * g_img) + jnp.sum(out.alpha * g_alpha)
                + jnp.sum(out.depth * g_depth) + jnp.sum(out.final_t * g_t))

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(sc[k]) for k in names), jnp.asarray(bg))

    def tgrads():
        leaves = [t(sc[k]).requires_grad_(True) for k in names] + [t(bg).requires_grad_(True)]
        m2, con, op, feat, dep, bgv = leaves
        out = tpb.blend_pallas(t(b.sorted_rank), t(b.order), t(b.rank), t(b.starts),
                               t(sc["counts"]), m2, con, op, feat, dep, bgv, width=W,
                               height=H)
        loss = ((out.image * t(g_img)).sum() + (out.alpha * t(g_alpha)).sum()
                + (out.depth * t(g_depth)).sum() + (out.final_t * t(g_t)).sum())
        return torch.autograd.grad(loss, leaves)

    got = tgrads()
    for name, g, w in zip(names + ("bg",), got, want):
        assert g.shape == w.shape, name
        close(g.numpy(), w)
    again = tgrads()
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_blend_pallas_without_grad_skips_autograd(sc):
    """With no input requiring grad no graph is recorded, and the image is
    the same as the differentiable call's."""
    b = sc["bins"]
    args = (t(b.sorted_rank), t(b.order), t(b.rank), t(b.starts), t(sc["counts"]),
            t(sc["means2d"]), t(sc["conics"]), t(sc["opac"]), t(sc["feats"]),
            t(sc["depths"]), torch.zeros(C))
    plain = tpb.blend_pallas(*args, width=W, height=H)
    assert plain.image.grad_fn is None
    leaves = list(args)
    leaves[8] = leaves[8].clone().requires_grad_(True)
    diff = tpb.blend_pallas(*leaves, width=W, height=H)
    assert diff.image.grad_fn is not None
    assert torch.equal(plain.image, diff.image.detach())


def test_per_gaussian_rows_sums_by_rank():
    """The fixed-order reduction equals a plain index_add_ by Gaussian id."""
    rng = np.random.RandomState(3)
    n, S, ns = 50, 4, 150
    rank = torch.as_tensor(rng.permutation(n).astype(np.int32))
    # each rank at most S times, in a tile-major (shuffled) order
    sorted_rank = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), S))[:ns]
                                  .astype(np.int32))
    rows = torch.as_tensor(rng.randn(ns, 7).astype(np.float32))
    got = tpb.per_gaussian_rows(rows, sorted_rank, rank, n, S)
    per_rank = torch.zeros(n, 7, dtype=torch.float64).index_add_(
        0, sorted_rank.long(), rows.double())
    torch.testing.assert_close(got, per_rank[rank.long()].float(), rtol=1e-6, atol=1e-6)
