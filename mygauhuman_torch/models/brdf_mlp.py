"""Latent BRDF autoencoder MLP (port of models/brdf_mlp.py).

Parity: nets/brdf_network.py, shipped by the reference but instantiated
nowhere (scene/gaussian_model.py:102-104 commented): albedo and roughness
are direct per-Gaussian parameters instead. A per-Gaussian 32-dim latent
decoded to (albedo 3, roughness 1, specular tint 3) through a small MLP,
with the sparsity KL the reference's get_kl_loss (utils/loss_utils.py)
would consume. Weights are drawn from a torch.Generator (the JAX package
draws them from jax.random: the two inits differ, the functions do not).
"""
from __future__ import annotations

import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device

LATENT_DIM = 32


def init_brdf_mlp(generator: torch.Generator | None = None, latent_dim: int = LATENT_DIM,
                  width: int = 64, device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """{"l1", "l2", "head"}: each {"w" [in, out] Glorot-uniform, "b" zeros}."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def lin(i, o):
        bound = (6.0 / (i + o)) ** 0.5
        w = (torch.rand((i, o), generator=gen) * 2.0 - 1.0) * bound
        return {"w": w.to(dev), "b": torch.zeros(o, device=dev)}

    return {"l1": lin(latent_dim, width), "l2": lin(width, width), "head": lin(width, 7)}


def apply_brdf_mlp(params: dict, latent: torch.Tensor) -> dict:
    """[N, latent] -> {"albedo" [N,3], "roughness" [N,1], "specular" [N,3]}."""
    h = torch.relu(latent @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    out = h @ params["head"]["w"] + params["head"]["b"]
    return {"albedo": torch.sigmoid(out[..., 0:3]), "roughness": torch.sigmoid(out[..., 3:4]),
            "specular": torch.sigmoid(out[..., 4:7])}


def latent_kl_loss(latent: torch.Tensor, rho: float = 0.05) -> torch.Tensor:
    """Sparsity KL on the latent activations (loss_utils.py get_kl_loss)."""
    rho_hat = torch.clamp(torch.sigmoid(latent).mean(dim=0), 1e-6, 1 - 1e-6)
    return (rho * torch.log(rho / rho_hat)
            + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat))).mean()
