"""Port vs JAX package: the blend backward (kernel D's plain version, whole
and as its chunked launches D1 / D1s / D2), the checkpoints a
differentiated forward returns (kernel C's checkpoint mode, plain) and the
backward fed by them, and the differentiable instance-list blend
`blend_pallas`.

The scene is 2 x 2 tiles of 16 x 16 px with C = 19 channels, built by hand
so that every branch of the backward is taken: a saturating stack (T falls
below 1e-4 inside the tile's list), a splat whose opacity times exp(power)
passes the 0.99 clamp, an indefinite conic (power > 0 on some pixels), and
tiles whose counts are capped at K.

Tolerance: each gradient component within 1e-4 max|JAX| + 1e-6. The JAX
kernel forms dL/dalpha from an explicit suffix sum while the port's plain
version is autograd through the log-space cumsum, so the two agree to
float32 rounding (measured ~1e-7 relative); the bound is the one the chip
run holds kernel D to. The chunked plain pieces are held to the same bound,
on a variant of the scene with an empty tile and a ragged count, at chunks
of 4 (so the 24-instance capped tiles span six chunks) and of 32. The
forward's checkpoints are the backward plain version's bit for bit (the
same log-space T).
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
from mygauhuman_torch.ops.blend import tile_pixels, transmittance
from mygauhuman_torch.ops import pallas_blend_bwd as tpbb
from mygauhuman_torch.ops.pallas_blend_bwd import (
    blend_bwd_checkpoints_plain,
    blend_bwd_rows_plain,
    blend_bwd_sums_plain,
    blend_tiles_bwd_from_ckpt_plain,
    blend_tiles_bwd_plain,
    blend_tiles_bwd_raw,
    max_chunks,
)

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


@pytest.fixture(scope="module")
def chunked(sc):
    """The scene's instances with tile 1 emptied and tile 2 cut to 21
    instances, cotangents, and the JAX interpret-mode rows at tile_base 0
    (4 tiles) and 2 (tiles 2-3)."""
    b = sc["bins"]
    counts = jnp.asarray(np.minimum(np.asarray(sc["counts"]), [K, 0, 21, K]).astype(np.int32))
    inst = jpb.build_instance_data(b.sorted_rank, b.starts, counts,
                                   jnp.asarray(sc["means2d"]), jnp.asarray(sc["conics"]),
                                   jnp.asarray(sc["opac"]), jnp.asarray(sc["depths"]),
                                   jnp.asarray(sc["feats"]), order=b.order)
    D = inst.data.shape[0]
    rng = np.random.RandomState(4)
    cot = rng.randn(4, 256, D - 5).astype(np.float32)
    cot[:, :, C:D - 8] = 0.0
    want = {base: np.asarray(jbwd(inst.data, inst.starts[base:], counts[base:],
                                  jnp.asarray([base], jnp.int32), jnp.asarray(cot[base:]),
                                  n_tiles=4 - base, tiles_x=2, interpret=True))[:, :D]
            for base in (0, 2)}
    return dict(data=t(inst.data), starts=t(inst.starts), counts=t(counts), cot=t(cot),
                want=want)


def _ckpt(ch, chunk, base=0):
    kw = dict(n_tiles=4 - base, tiles_x=2, chunk=chunk)
    args = (ch["data"], ch["starts"][base:], ch["counts"][base:], base, ch["cot"][base:])
    return args, kw, blend_bwd_checkpoints_plain(*args, **kw)


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("base", [0, 2])
def test_chunked_plain_kernel_d_matches_autograd_and_interpret_pallas(chunked, chunk, base):
    """D2's plain version over D1's: the whole of kernel D, against
    autograd of kernel C's plain version and the JAX kernel."""
    args, kw, ck = _ckpt(chunked, chunk, base)
    got = blend_bwd_rows_plain(*args, ck, **kw)
    kw.pop("chunk")
    close(got.numpy(), blend_tiles_bwd_plain(*args, **kw).numpy())
    close(got.numpy(), chunked["want"][base])
    assert float(np.abs(chunked["want"][base][:, :7]).max()) > 1e-3


@pytest.mark.parametrize("chunk", [4, 32])
def test_chunked_checkpoints_cover_every_case(chunked, chunk):
    """The scene has what the chunked replay must handle: an empty tile, a
    count that is not a multiple of the chunk, pixels that stop inside a
    chunk and chunks that start after a pixel's stop; the slots follow the
    tiles in order."""
    _, _, ck = _ckpt(chunked, chunk)
    counts = chunked["counts"].long()
    nch = (counts + chunk - 1) // chunk
    assert int(ck.n_chunks) == int(nch.sum()) <= max_chunks(chunked["data"].shape[1], 4, chunk)
    assert (counts == 0).any() and (counts % chunk != 0).any()
    expect = [(tt, c) for tt in range(4) for c in range(int(nch[tt]))]
    assert ck.chunk_map[:int(ck.n_chunks)].tolist() == [list(x) for x in expect]
    busy = counts > 0
    stop = ck.stop[busy].long()
    cnt = counts[busy][:, None]
    assert ((stop < cnt) & (stop % chunk != 0)).any()          # stops inside a chunk
    if chunk < K:                                               # tiles of several chunks
        assert ((stop + chunk < cnt) & (stop < cnt)).any()      # chunks after the stop
    assert (stop == cnt).any()                                  # pixels that never stop


@pytest.mark.parametrize("chunk", [4, 32])
def test_checkpoint_t_is_kernel_c_plain_t(chunked, chunk):
    """T before each chunk is kernel C's plain per-pixel T there, bit for
    bit, until the pixel stops, then its final T; each chunk sum is the
    chunk's share of sum w q."""
    _, _, ck = _ckpt(chunked, chunk)
    data, starts, counts, cot = (chunked[k] for k in ("data", "starts", "counts", "cot"))
    cf = data.shape[0] - 8
    px, py = tile_pixels(torch.arange(4), 2, 16, 16)
    slot = 0
    checked = 0
    for tt in range(4):
        n = int(counts[tt])
        if n == 0:
            continue
        cols = data[:, int(starts[tt]):int(starts[tt]) + n][:, None]   # [D, 1, n]
        tr = transmittance(*cols[:6], torch.ones((1, n), dtype=torch.bool),
                           px[tt:tt + 1], py[tt:tt + 1])
        g = cot[tt]
        q = cols[8:8 + C, 0].T @ g[:, :C].T + g[:, cf] + cols[6, 0][:, None] * g[:, cf + 1]
        w = torch.where(tr.include[0], tr.a[0] * tr.t_before[0], torch.zeros(()))
        assert torch.equal(ck.t_final[tt], tr.final_t[0])
        for c in range((n + chunk - 1) // chunk):
            before = c * chunk < ck.stop[tt]
            assert torch.equal(ck.t_start[slot][before], tr.t_before[0, c * chunk][before])
            assert torch.equal(ck.t_start[slot][~before], tr.final_t[0][~before])
            checked += int(before.sum())
            torch.testing.assert_close(ck.chunk_sum[slot],
                                       (w * q)[c * chunk:(c + 1) * chunk].sum(0),
                                       rtol=1e-6, atol=1e-6)
            slot += 1
    assert checked > 0 and slot == int(ck.n_chunks)


@pytest.mark.parametrize("chunk", [4, 32])
def test_chunk_sums_from_t_checkpoints(chunked, chunk):
    """D1s' plain version, replaying each chunk from its T checkpoint, gives
    the chunk sums taken from kernel C's plain T over the whole list."""
    args, kw, ck = _ckpt(chunked, chunk)
    sums = blend_bwd_sums_plain(*args, ck, **kw)
    n = int(ck.n_chunks)
    close(sums[:n].numpy(), ck.chunk_sum[:n].numpy())
    assert float(ck.chunk_sum[:n].abs().max()) > 0.1


def test_plain_kernel_d_zeroes_the_feature_pad(chunked):
    """With n_channels = C the pad rows are 0 whatever the pad cotangent."""
    data, starts, counts, cot = (chunked[k] for k in ("data", "starts", "counts", "cot"))
    noisy = cot.clone()
    noisy[:, :, C:data.shape[0] - 8] = 1.0
    kw = dict(n_tiles=4, tiles_x=2)
    got = blend_tiles_bwd_plain(data, starts, counts, 0, noisy, n_channels=C, **kw)
    assert torch.equal(got, blend_tiles_bwd_plain(data, starts, counts, 0, cot, **kw))
    ck = blend_bwd_checkpoints_plain(data, starts, counts, 0, noisy, n_channels=C, **kw)
    rows = blend_bwd_rows_plain(data, starts, counts, 0, noisy, ck, n_channels=C, **kw)
    assert float(rows[:, 8 + C:].abs().max()) == 0.0
    close(rows.numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("base", [0, 2])
def test_forward_checkpoints_are_the_backward_checkpoints(chunked, chunk, base):
    """The checkpoints of the differentiated plain forward equal
    blend_bwd_checkpoints_plain's, bit for bit, but the chunk sums (zeros:
    they are D1s' work); the forward's output is the plain one."""
    args, kw, want = _ckpt(chunked, chunk, base)
    got = tpb.blend_fwd_checkpoints_plain(*args[:4], **kw)
    for name in ("t_start", "stop", "t_final", "chunk_map", "n_chunks"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.chunk_sum.abs().max()) == 0.0
    if chunk == tpb.CHUNK:
        fwd = dict(n_tiles=4 - base, tiles_x=2, n_channels=chunked["data"].shape[0] - 8)
        out, ck = tpb.blend_instances_plain(*args[:4], checkpoints=True, **fwd)
        assert torch.equal(out, tpb.blend_instances_plain(*args[:4], **fwd))
        for a, b in zip(ck, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("base", [0, 2])
def test_backward_from_forward_checkpoints_matches_interpret_pallas(chunked, chunk, base):
    """D1s' and D2's plain versions fed by the forward's checkpoints: the
    JAX kernel's rows (interpret mode) within the file's tolerance."""
    args, kw, _ = _ckpt(chunked, chunk, base)
    ck = tpb.blend_fwd_checkpoints_plain(*args[:4], **kw)
    got = blend_tiles_bwd_from_ckpt_plain(*args, ck, **kw)
    close(got.numpy(), chunked["want"][base])
    assert float(np.abs(chunked["want"][base][:, :7]).max()) > 1e-3


def test_blend_pallas_keeps_checkpoints_only_when_differentiated(sc, monkeypatch):
    """The forward computes checkpoints only for a differentiated call, and
    the backward reads them: no second walk of T (kernel D's whole plain
    version is not called)."""
    calls = {"fwd": 0, "from_ckpt": 0, "whole": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tpb, "blend_fwd_checkpoints_plain",
                        counted("fwd", tpb.blend_fwd_checkpoints_plain))
    monkeypatch.setattr(tpbb, "blend_tiles_bwd_from_ckpt_plain",
                        counted("from_ckpt", tpbb.blend_tiles_bwd_from_ckpt_plain))
    monkeypatch.setattr(tpbb, "blend_tiles_bwd_plain",
                        counted("whole", tpbb.blend_tiles_bwd_plain))
    b = sc["bins"]
    feats = t(sc["feats"]).requires_grad_(True)
    args = (t(b.sorted_rank), t(b.order), t(b.rank), t(b.starts), t(sc["counts"]),
            t(sc["means2d"]), t(sc["conics"]), t(sc["opac"]), feats, t(sc["depths"]),
            torch.zeros(C))
    with torch.no_grad():
        tpb.blend_pallas(*args, width=W, height=H)
    assert calls == {"fwd": 0, "from_ckpt": 0, "whole": 0}
    out = tpb.blend_pallas(*args, width=W, height=H)
    assert calls["fwd"] == 1
    out.image.sum().backward()
    assert calls == {"fwd": 1, "from_ckpt": 1, "whole": 0}
    assert float(feats.grad.abs().max()) > 0


# ---- the instance-level blend of a strip at a non-zero tile_base ----------------

@pytest.fixture(scope="module")
def strip():
    """A 128 x 32 frame (8 x 2 tiles, wide enough for the JAX row kernel),
    binned by the JAX package, C = 19, K = 24: the instance matrix, the
    lists, and a seeded cotangent of the blend's output rows."""
    rng = np.random.RandomState(11)
    n = 90
    means2d = np.stack([rng.rand(n) * 128, rng.rand(n) * 32], 1).astype(np.float32)
    conics = np.tile(np.asarray([0.05, 0.01, 0.06], np.float32), (n, 1))
    conics[:10] = (0.3, 0.0, 0.3)                           # a tight, dense stack
    means2d[:10] = (70.0, 20.0)
    opac = (rng.rand(n) * 0.85 + 0.1).astype(np.float32)
    opac[:10] = 0.97
    depths = (2.0 + rng.rand(n)).astype(np.float32)
    feats = rng.rand(n, C).astype(np.float32)
    radii = np.full(n, 12, np.int32)
    bins = jbin(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths),
                jnp.ones(n, bool), width=128, height=32, tile_capacity=K)
    counts = jnp.minimum(bins.counts, K)
    inst = jpb.build_instance_data(bins.sorted_rank, bins.starts, counts,
                                   jnp.asarray(means2d), jnp.asarray(conics), jnp.asarray(opac),
                                   jnp.asarray(depths), jnp.asarray(feats), order=bins.order)
    return dict(data=np.asarray(inst.data), starts=np.asarray(inst.starts),
                counts=np.asarray(counts),
                g=rng.randn(16, C + 3, 256).astype(np.float32))


@pytest.mark.parametrize("planar,base,n_tiles", [(True, 8, 8), (False, 8, 8), (False, 5, 11)])
def test_blend_instances_at_tile_base_match_jax(strip, planar, base, n_tiles):
    """blend_instances{,_planar} of tiles [base, base + n_tiles) of the
    8-wide grid (CPU tensors: kernel C's and D's plain versions) against
    the JAX custom_vjps in interpret mode: the forward within 1e-5, the
    instance matrix's gradient within the file's bound."""
    s = strip
    sl = slice(base, base + n_tiles)
    g = s["g"][sl]                                          # [T, C + 3, P]
    if planar:   # the same cotangent, in the planar layout
        rows = n_tiles // 8
        g = g.reshape(rows, 8, C + 3, 16, 16).transpose(2, 0, 3, 1, 4).reshape(
            C + 3, rows * 16, 128)
    jfn = jpb.blend_instances_planar if planar else jpb.blend_instances
    args = (jnp.asarray(s["starts"][sl]), jnp.asarray(s["counts"][sl]),
            jnp.asarray([base], jnp.int32))
    jout, vjp = jax.vjp(lambda d: jfn(d, *args, n_tiles, 8, C, 16, 16, True),
                        jnp.asarray(s["data"]))
    cut = (slice(0, C + 3),) if planar else (slice(None), slice(0, C + 3))
    pad = [(0, 0)] * jout.ndim
    pad[0 if planar else 1] = (0, jout.shape[0 if planar else 1] - (C + 3))
    (want_d,) = vjp(jnp.pad(jnp.asarray(g), pad))

    data = t(s["data"]).requires_grad_(True)
    tfn = tpb.blend_instances_planar if planar else tpb.blend_instances
    out = tfn(data, t(s["starts"][sl]), t(s["counts"][sl]), base, n_tiles, 8, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout)[cut], rtol=0, atol=1e-5)
    (got_d,) = torch.autograd.grad(out, data, t(g))
    assert got_d.shape == data.shape
    close(got_d.numpy(), np.asarray(want_d))
    assert float(np.abs(np.asarray(want_d)[:7]).max()) > 1e-3
    # without grad, no checkpoints are kept and the output is the same
    with torch.no_grad():
        assert torch.equal(tfn(data, t(s["starts"][sl]), t(s["counts"][sl]), base, n_tiles,
                               8, C), out.detach())
