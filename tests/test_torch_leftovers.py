"""The JAX package's last small public functions against their ports:
`eval/lpips.py::export_torch_weights`, the 3x3 covariance helpers of
`utils/transforms.py`, `ops/projection.py::compute_cov3d` and
`models/gaussians.py::get_rotation`. None has a caller on a main path.

Inputs are made with numpy from a seed and fed to both packages on the CPU.
Tolerance: the float32 math within 1e-6 relative (rtol 1e-6, atol 1e-6 of
the output's largest magnitude, for entries that cancel to near zero); the
.npz's keys, shapes and arrays exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.eval import lpips as jlpips
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.ops import projection as jproj
from mygauhuman_tpu.utils import transforms as jtf
from mygauhuman_torch.eval import lpips as tlpips
from mygauhuman_torch.models import gaussians as TG
from mygauhuman_torch.ops import projection as tproj
from mygauhuman_torch.utils import transforms as ttf

torch.set_num_threads(1)
N = 64


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def inputs(rng):
    scale = np.exp(rng.randn(N, 3) * 0.5 - 2).astype(np.float32)
    quat = rng.randn(N, 4).astype(np.float32)
    tf = rng.randn(N, 3, 3).astype(np.float32)
    return scale, quat, tf


def case_build_scaling_rotation(rng, tmp_path):
    s, q, _ = inputs(rng)
    close(ttf.build_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q)),
          jtf.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))


def case_covariance_from_scaling_rotation(rng, tmp_path):
    s, q, tf = inputs(rng)
    for t in (None, tf):
        close(ttf.covariance_from_scaling_rotation(
            torch.as_tensor(s), torch.as_tensor(q), 1.3, None if t is None else torch.as_tensor(t)),
              jtf.covariance_from_scaling_rotation(
            jnp.asarray(s), jnp.asarray(q), 1.3, None if t is None else jnp.asarray(t)))


def case_strip_symmetric(rng, tmp_path):
    a = rng.randn(N, 3, 3).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    close(ttf.strip_symmetric(torch.as_tensor(cov)), jtf.strip_symmetric(jnp.asarray(cov)))


def case_unstrip_symmetric(rng, tmp_path):
    c6 = rng.randn(N, 6).astype(np.float32)
    got = ttf.unstrip_symmetric(torch.as_tensor(c6))
    close(got, jtf.unstrip_symmetric(jnp.asarray(c6)))
    assert torch.equal(ttf.strip_symmetric(got), torch.as_tensor(c6))


def case_compute_cov3d(rng, tmp_path):
    s, q, tf = inputs(rng)
    for t in (None, tf):
        close(tproj.compute_cov3d(torch.as_tensor(s), torch.as_tensor(q), 0.7,
                                  None if t is None else torch.as_tensor(t)),
              jproj.compute_cov3d(jnp.asarray(s), jnp.asarray(q), 0.7,
                                  None if t is None else jnp.asarray(t)))


def case_get_rotation(rng, tmp_path):
    q = rng.randn(N, 4).astype(np.float32)
    q[0] = 0.0                                  # a dead slot's zero quaternion
    zeros = np.zeros((N, 1), np.float32)
    jp = JG.GaussianParams(*([jnp.asarray(zeros)] * 9))._replace(rotation=jnp.asarray(q))
    tp = TG.GaussianParams(*([torch.as_tensor(zeros)] * 9))._replace(rotation=torch.as_tensor(q))
    close(TG.get_rotation(tp), JG.get_rotation(jp))


def case_export_torch_weights(rng, tmp_path):
    """The same state dicts (torch tensors for the port, numpy arrays for
    JAX, as each package's caller holds them) give the same .npz, which
    init_lpips reads back as the state dicts' convolutions."""
    conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    cin, vgg = 3, {}
    for cid, (cout, _) in zip(conv_ids, tlpips._VGG_PLAN):
        vgg[f"features.{cid}.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32)
        vgg[f"features.{cid}.bias"] = rng.randn(cout).astype(np.float32)
        cin = cout
    lin = {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
           for i, c in enumerate(tlpips._STAGE_CHANNELS)}
    tlpips.export_torch_weights(str(tmp_path / "port.npz"),
                                {k: torch.as_tensor(v) for k, v in vgg.items()},
                                {k: torch.as_tensor(v) for k, v in lin.items()})
    jlpips.export_torch_weights(str(tmp_path / "jax.npz"), vgg, lin)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 13 * 2 + 5
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    params = tlpips.init_lpips(weights_file=str(tmp_path / "port.npz"), device="cpu")
    assert torch.equal(params.convs[4]["w"], torch.as_tensor(vgg["features.10.weight"]))
    assert torch.equal(params.lins[2], torch.as_tensor(lin["lin2.model.1.weight"]).reshape(-1))


CASES = [case_build_scaling_rotation, case_covariance_from_scaling_rotation,
         case_strip_symmetric, case_unstrip_symmetric, case_compute_cov3d, case_get_rotation,
         case_export_torch_weights]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[len("case_"):] for c in CASES])
def test_leftover_matches_jax(case, tmp_path):
    case(np.random.RandomState(0), tmp_path)
