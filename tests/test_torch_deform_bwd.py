"""Kernel B's backward: its plain version (`ops/pallas_deform.py::
deform_rows_bwd_plain`, the hand-derived adjoint of the deform chain) against
the JAX package's custom_vjp backward (`jax.vjp` of `_deform_rows_jnp`) and
against autograd of the port's plain forward, on the CPU.

Inputs: near-identity blends plus noise, from tests/test_torch_kernels.py's
builder, with a random cotangent or the cotangent of sum(out ** 2). Three
columns can be made to go through the det guard (a singular blend, sign(det)
= 0, and det = +-5e-9);
their gradients are ~1e8-1e12, so they are compared on their own, relative to
their largest value. Tolerances: against JAX 1e-4 rel / abs, as
test_deform_against_interpret_pallas_and_grads (fp32, the same sums in another
order); against autograd each gradient within 1e-5 of its largest value
+ 1e-6. The kernel (csrc/deform.cu) is held to this plain version bit for bit
on a card, in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.ops.pallas_deform import _deform_rows_jnp
from mygauhuman_torch.ops import pallas_deform as pd
from test_torch_kernels import deform_bwd_inputs

torch.set_num_threads(1)
NAMES = ("abig", "asrc", "packed", "scalars")
GUARDED = 3   # columns 0-2 go through the det guard when asked for


def deform_inputs(N, seed=0, guarded=False):
    """(abig, asrc, packed, scalars, g) as numpy float32, from the card
    tests' builder; with `guarded`, columns 0-2 go through the det guard."""
    return [a.numpy() for a in deform_bwd_inputs("cpu", N, seed, guarded=guarded)]


def cotangent(args, kind):
    if kind == "random":
        return args[4]
    out = pd.deform_rows_plain(*(torch.as_tensor(a) for a in args[:4]))
    return (2.0 * out).numpy()    # d sum(out ** 2)


def plain_bwd(args, g):
    return [x.numpy() for x in pd.deform_rows_bwd_plain(
        *(torch.as_tensor(a) for a in args[:4]), torch.as_tensor(g))]


def jax_bwd(args, g):
    _, vjp = jax.vjp(_deform_rows_jnp, *(jnp.asarray(a) for a in args[:4]))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def autograd_bwd(args, g):
    t = [torch.as_tensor(a).clone().requires_grad_(True) for a in args[:4]]
    return [x.numpy() for x in torch.autograd.grad(pd.deform_rows_plain(*t), t,
                                                    torch.as_tensor(g))]


def within(got, want, rel, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all(), what
    assert err <= rel * scale + 1e-6, f"{what}: max abs err {err} (largest {scale})"


@pytest.mark.parametrize("kind", ["random", "sum_sq"])
@pytest.mark.parametrize("N", [128, 333])
def test_bwd_plain_matches_jax_vjp(N, kind):
    args = deform_inputs(N, seed=4)
    g = cotangent(args, kind)
    for name, got, want in zip(NAMES, plain_bwd(args, g), jax_bwd(args, g)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)
    assert not plain_bwd(args, g)[3][0, 21:].any()


@pytest.mark.parametrize("N", [128, 333])
def test_bwd_plain_guarded_columns_match_jax_vjp(N):
    args = deform_inputs(N, seed=5, guarded=True)
    g = args[4]
    got, want = plain_bwd(args, g), jax_bwd(args, g)
    for name, x, y in zip(NAMES[:3], got, want):
        np.testing.assert_allclose(x[:, GUARDED:], y[:, GUARDED:], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        within(x[:, :GUARDED], y[:, :GUARDED], 1e-4, f"d_{name}, guarded columns")
        assert np.abs(y[:, :GUARDED]).max() > 1e6   # the guard's 1 / det reached them
    within(got[3], want[3], 1e-4, "d_scalars")


@pytest.mark.parametrize("kind", ["random", "sum_sq"])
@pytest.mark.parametrize("N", [1, 128, 333])
def test_bwd_plain_matches_autograd(N, kind):
    args = deform_inputs(N, seed=6)
    g = cotangent(args, kind)
    for name, got, want in zip(NAMES, plain_bwd(args, g), autograd_bwd(args, g)):
        within(got, want, 1e-5, f"d_{name}")


def test_bwd_plain_guarded_columns_match_autograd():
    """Where the guard fires, det is a constant: autograd sends no gradient
    through it (sign() has none), and neither does the adjoint, so there is
    no -d_inv / det ** 2 term (~1e16 here) in the blend's gradient."""
    args = deform_inputs(200, seed=7, guarded=True)
    g = args[4]
    got, want = plain_bwd(args, g), autograd_bwd(args, g)
    for name, x, y in zip(NAMES[:3], got, want):
        within(x[:, GUARDED:], y[:, GUARDED:], 1e-5, f"d_{name}")
        within(x[:, :GUARDED], y[:, :GUARDED], 1e-5, f"d_{name}, guarded columns")
    within(got[3], want[3], 1e-5, "d_scalars")
    assert np.abs(got[0][:, :GUARDED]).max() < 1e14


def simulate_kernel_sums(shares):
    """The kernel's sum of each Gaussian's shares, lane by lane in float32:
    per warp of 32 an xor butterfly (lane 0 keeps the warp's sum), then lane
    l of the second pass adds partials l, l + 32, ... in turn from 0 and the
    lanes meet in another butterfly."""
    K, N = shares.shape
    nw = -(-N // 32)
    lanes = np.zeros((K, nw * 32), np.float32)
    lanes[:, :N] = shares

    def butterfly(v):   # v: [K, ..., 32]
        for off in (16, 8, 4, 2, 1):
            v = v + v[..., np.arange(32) ^ off]
        return v[..., 0]

    partial = butterfly(lanes.reshape(K, nw, 32))
    acc = np.zeros((K, 32), np.float32)
    for i in range(nw):
        acc[:, i % 32] = acc[:, i % 32] + partial[:, i]
    return butterfly(acc)


@pytest.mark.parametrize("N", [1, 333, 1100])
def test_scalar_sums_follow_the_kernels_order(N):
    rng = np.random.RandomState(N)
    shares = (rng.randn(21, N) * 10.0 ** rng.randint(-3, 4, (21, N))).astype(np.float32)
    got = pd.final_sums(pd.warp_sums(torch.as_tensor(shares))).numpy()
    np.testing.assert_array_equal(got, simulate_kernel_sums(shares))
    np.testing.assert_allclose(got, shares.astype(np.float64).sum(1),
                               rtol=1e-5, atol=1e-5 * np.abs(shares).sum(1).max())


def test_cpu_deform_rows_grads_match_jax_vjp():
    """On CPU tensors deform_rows runs the plain forward under autograd (no
    kernel, no custom backward); its gradients of all four inputs, guarded
    columns included, against the JAX custom_vjp backward."""
    args = deform_inputs(64, seed=8, guarded=True)
    t = [torch.as_tensor(x).clone().requires_grad_(True) for x in args[:4]]
    out = pd.deform_rows(*t)
    assert "DeformRows" not in type(out.grad_fn).__name__
    out.backward(torch.as_tensor(args[4]))
    for name, x, y in zip(NAMES, t, jax_bwd(args, args[4])):
        got = x.grad.numpy()
        if name == "scalars":
            within(got, y, 1e-4, "d_scalars")
            continue
        np.testing.assert_allclose(got[:, GUARDED:], y[:, GUARDED:], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        within(got[:, :GUARDED], y[:, :GUARDED], 1e-4, f"d_{name}, guarded columns")
