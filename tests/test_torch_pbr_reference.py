"""Branch B of the port against the benchmark's plain reference
(port_bench/reference/: bake.py, light.py, shade.py, pbr.py), which imports
nothing of the program, on the CPU at a small size with the published
light, map and face sizes: a 300-vertex body, 512 Gaussians in 1,024
slots placed as a trained avatar's stand-in with seeded materials and Adam
moments (port_bench/harness/pbr_mix.py::pbr_inputs), 64 x 64 frames, a
32 x 32 x 6 light, 16 x 32 maps, 32 x 32 faces.

  * one sweep of a camera's bake (`bake_occlusion`, a window of 16 cells,
    the model-sized tile lists) against the reference's bake of 10 of its
    cells, from the same posed rows: every texel within one uint8 step (the
    blend's order of operations may put x * 255 on the other side of a
    rounding boundary), and the Gaussians past the window counted;
  * the light's mips, the diffuse irradiance, the envmap exports, the BRDF
    LUT and the split-sum shading of seeded G-buffers: within 1e-5 of the
    largest value (float32 products summed in other orders; the LUT is
    integrated in float64 on both sides: 1e-6);
  * the branch-B loss and its gradients (albedo, roughness, light) on one
    view with seeded baked maps: the loss within 1e-6 relative, each
    gradient within 1e-4 of its largest entry (the program's gathers sum
    their gradient rows in a fixed order, autograd's in another);
  * the slot counts at a face's 4 tiles, fewer and more, against
    `bincount`;
  * a masked-L1 residual within rounding of 0: the gradient at either sign
    as the reference's `l1_ties` gives it, which the benchmark's grad_gap
    accepts;
  * three steps of the program's donated step against the reference's:
    albedo, roughness, normals and light within 1e-5 of each leaf's largest
    change (an entry whose gradient rounds to 0 on one side only would move
    by a whole learning rate: none does here), and every geometry leaf (and
    both MLPs) bit-equal to the start.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mygauhuman_torch.occlusion import baking
from mygauhuman_torch.ops.binning import slot_counts
from mygauhuman_torch.pbr.light import build_mips, export_envmap, prefilter_weight_set
from mygauhuman_torch.pbr.shade import get_brdf_lut, pbr_shading_planar
from mygauhuman_torch.train import pbr as TPB
from port_bench.harness import pbr_mix as M
from port_bench.harness import pbr_program as PP
from port_bench.harness.record import leaf_gaps
from port_bench.reference import bake as RB
from port_bench.reference import light as RLI
from port_bench.reference import pbr as RP
from port_bench.reference import shade as RS

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
WINDOW = 16


def close(got, want, rel, msg=""):
    want = want.detach().double()
    err = float((got.detach().double() - want).abs().max())
    assert err <= rel * float(want.abs().max()), (msg, err, float(want.abs().max()))


@pytest.fixture(scope="module")
def inp():
    cfg = copy.deepcopy(json.loads((ROOT / "port_bench/configs/smpl_zju_512_pbr.json")
                                   .read_text()))
    cfg["body"]["vertices"] = 300
    cfg["frame"] = {"width": 64, "height": 64}
    cfg["cameras"]["focal_px"] *= 64 / 512
    cfg["poses"]["train"] = 1
    cfg["start"].update(gaussians=512, capacity=1024)
    return M.pbr_inputs(cfg, SEED, CPU)


@pytest.fixture(scope="module")
def program(inp):
    trainer = PP.PbrTrainer(inp)
    ts, pbr_state, step = trainer.subject()
    return trainer, ts, pbr_state, step


def test_one_cameras_bake_matches_the_reference(inp, program):
    trainer, ts, _, _ = program
    alive = ts.gauss.alive
    means, cov6, op, normals = TPB._pose_for_bake(ts, trainer.batches[0], trainer.model)
    # one sweep's window of WINDOW cells (the first occupied ones in id
    # order): the CPU bakes only those
    vis, oob = baking.bake_occlusion(means, cov6, op, normals, alive, max_cells=WINDOW)
    got = torch.round(vis * 255.0).to(torch.uint8)[..., 0]
    of, centres, occupied = RB.grid(means, alive)
    cells = torch.nonzero(occupied).reshape(-1)[:WINDOW]
    assert int(oob) == int((alive & (of > cells[-1])).sum()) > 0
    pick = cells[torch.randperm(WINDOW, generator=torch.Generator().manual_seed(3))[:10]]
    n = total = 0
    for c in pick.tolist():
        maps, ids, _, counts = RB.bake_cell(means, cov6, op, normals, alive, of, centres, c)
        d = (got[ids].int() - maps.int()).abs()
        assert int(d.max()) <= 1, (c, int(d.max()))
        n, total = n + int((d > 0).sum()), total + d.numel()
        assert int(counts.max()) <= alive.shape[0]
    assert total > 0 and n <= 0.01 * total, (n, total)


def test_light_envmap_lut_and_shading_match_the_reference():
    g = torch.Generator().manual_seed(7)
    base = 0.1 + torch.rand((6, 32, 32, 3), generator=g)
    light = build_mips({"base": base}, prefilter_weight_set(32, CPU))
    ref = RLI.Light(base)
    close(light.diffuse, ref.diffuse, 1e-5, "diffuse")
    assert len(light.specular) == len(ref.specular) == 3
    for i, (a, b) in enumerate(zip(light.specular, ref.specular)):
        close(a, b, 1e-5, f"specular level {i}")
    for h, w in ((16, 32), (64, 128)):
        close(export_envmap({"base": base}, h, w), RLI.export_envmap(base, h, w), 1e-6,
              f"envmap {h}x{w}")
    lut, ref_lut = get_brdf_lut(CPU), RS.brdf_lut(CPU)
    close(lut, ref_lut, 1e-6, "BRDF LUT")
    H = W = 64
    n = torch.nn.functional.normalize(torch.randn((H, W, 3), generator=g), dim=-1)
    v = torch.nn.functional.normalize(torch.randn((H, W, 3), generator=g) + n, dim=-1)
    albedo = torch.rand((H, W, 3), generator=g)
    rough = 0.04 + 0.96 * torch.rand((H, W), generator=g)
    alpha = torch.clamp(torch.rand((H, W), generator=g) * 1.2 - 0.2, min=0.0)
    occ = torch.rand((H, W), generator=g)
    got = pbr_shading_planar(light=light, normals=n.unbind(-1), view_dirs=v.unbind(-1),
                             albedo=albedo.unbind(-1), roughness=rough, mask=alpha,
                             occlusion=occ, brdf_lut=lut)["render_rgb"]
    want = RS.shade(ref, n, v, albedo, rough, alpha, occ, ref_lut)
    close(torch.stack(got, dim=-1), want, 1e-5, "shading")


def _maps(inp, k):
    g = torch.Generator().manual_seed(11 + k)
    cap = inp["start"]["alive"].shape[0]
    return torch.randint(0, 256, (cap, 16, 32, 1), generator=g, dtype=torch.uint8)


def _reference_start(inp):
    s = inp["start"]
    p = {f: s["params"][f"gaussians.{f}"] for f in ("xyz", "features_dc", "features_rest",
                                                    "scaling", "rotation", "opacity", "normal",
                                                    "albedo", "roughness")}
    return {"params": p, "alive": s["alive"], "base": torch.full((6, 32, 32, 3), 0.5),
            "mu": {f: s["mu"][f"gaussians.{f}"] for f in RP.STEPPED},
            "nu": {f: s["nu"][f"gaussians.{f}"] for f in RP.STEPPED}}


def test_branch_b_loss_and_gradients_match_the_reference(inp, program):
    trainer, ts, pbr_state, step = program
    s = inp["start"]
    knn3 = TPB.compute_knn3(ts.gauss)
    nb = RP.neighbours(s["params"]["gaussians.xyz"], s["alive"])
    assert torch.equal(knn3[:, 1:][s["alive"]], nb[:, 1:][s["alive"]])
    occ = _maps(inp, 0)
    pw = prefilter_weight_set(32, CPU)
    loss, _, grads = step.loss_and_grads(
        ts, pbr_state, trainer.batches[0], knn3,
        TPB.baked_occlusion_color(occ, pbr_state.light), pw, s["active_sh_degree"])
    start = _reference_start(inp)
    p = {k: v.detach().clone() for k, v in start["params"].items()}
    leaves = {k: p[k].requires_grad_(True) for k in RP.MATERIALS}
    b = start["base"].clone().requires_grad_(True)
    total, terms, _ = RP.loss(p, b, s["alive"], inp["views"][0], occ, nb, inp["scene"].body,
                              sh_degree=s["active_sh_degree"], mlp=M._mlp(inp),
                              raster=inp["raster"], bg=inp["bg"], lpips_params=inp["lpips"],
                              lut=RS.brdf_lut(CPU))
    total_f = float(total.detach())
    assert abs(float(loss) - total_f) <= 1e-6 * abs(total_f), (float(loss), terms)
    want = torch.autograd.grad(total, (leaves["albedo"], leaves["roughness"], b))
    for name, w in zip(("albedo", "roughness", "light"), want):
        assert float(w.abs().max()) > 0, name
        close(grads[name], w, 1e-4, name)


def test_three_steps_match_the_reference_and_leave_the_geometry_bit_frozen(inp):
    trainer = PP.PbrTrainer(inp)
    ts, pbr_state, step = trainer.subject()
    s = inp["start"]
    before = PP.geometry(ts)
    knn3 = TPB.compute_knn3(ts.gauss)
    pw = prefilter_weight_set(32, CPU)
    views = [0, 1, 2]
    occ = [_maps(inp, k) for k in views]
    for k, v in enumerate(views):
        ts, pbr_state, _ = step(ts, pbr_state, trainer.batches[v], knn3,
                                TPB.baked_occlusion_color(occ[k], pbr_state.light), pw,
                                s["active_sh_degree"])
    got = PP.materials(ts, pbr_state)
    start = _reference_start(inp)
    _, _, want = RP.train_steps(start, [inp["views"][v] for v in views], occ,
                                RP.neighbours(s["params"]["gaussians.xyz"], s["alive"]),
                                inp["scene"].body, inp["optim"],
                                counts={k: s["iteration"] for k in RP.STEPPED},
                                sh_degree=s["active_sh_degree"], mlp=M._mlp(inp),
                                raster=inp["raster"], bg=inp["bg"], lpips_params=inp["lpips"])
    first = {**start["params"], "light": start["base"]}
    for k in ("albedo", "roughness", "normal", "light"):
        change = want[k] - first[k]
        assert float(change.abs().max()) > 0, k
        close(got[k] - first[k], change, 1e-5, k)
    after = PP.geometry(ts)
    assert set(after) == set(before) and len(after) > 6
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert ts.opt_state.count["xyz"] == s["iteration"]
    assert ts.opt_state.count["albedo"] == s["iteration"] + 3
    assert np.isfinite(float(ts.gauss.params.albedo.sum()))


def test_a_masked_l1_tie_is_compared_at_either_sign(inp):
    """A ground truth placed 1e-6 above and then below one shaded channel:
    the gradients on the two sides differ by the reference's `l1_ties`
    change for that channel, the benchmark's `tied_grad_gap` reads the gap
    of one side against the other as float noise, and `leaf_gaps` without
    the ties reads the flip (the benchmark's grad_gap, which a program
    blending in another order read on one seed of ~80 on the card): the
    flip reads above ten times grad_gap's limit, the tied gap below a
    hundredth of it."""
    s = inp["start"]
    start = _reference_start(inp)
    p = start["params"]
    nb = RP.neighbours(p["xyz"], s["alive"])
    occ, lut = _maps(inp, 0), RS.brdf_lut(CPU)

    def grads(view, ties=None):
        leaves = {k: p[k].detach().clone().requires_grad_(True) for k in RP.MATERIALS}
        b = start["base"].clone().requires_grad_(True)
        kept = {}
        total, _, _ = RP.loss({**p, **leaves}, b, s["alive"], view, occ, nb, inp["scene"].body,
                              sh_degree=s["active_sh_degree"], mlp=M._mlp(inp),
                              raster=inp["raster"], bg=inp["bg"], lpips_params=inp["lpips"],
                              lut=lut, keep=kept)
        wrt = (leaves["albedo"], leaves["roughness"], b)
        g = torch.autograd.grad(total, wrt, retain_graph=True)
        if ties is not None:
            ties.extend(RP.l1_ties(kept["rgb"], view, wrt))
        return dict(zip(("albedo", "roughness", "light"), g)), kept["rgb"].detach()

    view = inp["views"][0]
    _, rgb = grads(view)
    shaded = (view["bound_mask"][..., None] > 0) & (rgb > 0)
    i = int(torch.where(shaded, rgb, torch.zeros_like(rgb)).reshape(-1).argmax())

    def gt_at(offset):
        gt = view["gt_image"].clone()
        gt.reshape(-1)[i] = rgb.reshape(-1)[i] + offset
        return {**view, "gt_image": gt}

    ties = []
    below, _ = grads(gt_at(1e-6), ties)      # the residual -1e-6
    above, _ = grads(gt_at(-1e-6))           # +1e-6
    assert ties and all(len(t) == 1 for t in ties)
    untied = leaf_gaps(above, below)[0]
    tied = M.tied_grad_gap(above, below, ties)[0]
    limit = json.loads((ROOT / "port_bench/limits/train.smpl_zju_512.pbr.json")
                       .read_text())["numbers"]["grad_gap"]["limit"]
    assert untied > 10 * limit and tied < limit / 100, (untied, tied)


@pytest.mark.parametrize("n_tiles", [1, 4, 5])
def test_a_bake_faces_slot_counts_match_bincount(n_tiles):
    """At a face's 4 tiles, fewer and more, with most slots dead: the same
    integers as `bincount`, dead slots (tile T) dropped."""
    g = torch.Generator().manual_seed(n_tiles)
    flat = torch.where(torch.rand(4 * 3000, generator=g) < 0.7, n_tiles,
                       torch.randint(0, n_tiles, (4 * 3000,), generator=g)).to(torch.int32)
    got = slot_counts(flat, n_tiles)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.bincount(flat.long(), minlength=n_tiles + 1)[:n_tiles].int())
