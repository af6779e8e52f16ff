"""Training losses and online metrics, ``vinet_tpu/training/losses.py`` in
PyTorch.

The reference's loss.py semantics: kldiv, cc, similarity and nss on batched
(B, H, W) maps, with the MIT eps 2.2204e-16 and torch's unbiased std. Each
is differentiable; resizing to the GT's size is the caller's concern.
Multi-frame GT (B, Cl, H, W) folds into the batch axis.
"""

from __future__ import annotations

import dataclasses

import torch

EPS = 2.2204e-16  # MATLAB eps, used by the MIT benchmark and the reference


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _sum_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / _flat(x).sum(dim=1).reshape(-1, 1, 1)


def normalize_map(s_map: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalisation (reference normalize_map)."""
    mn = _flat(s_map).amin(dim=1).reshape(-1, 1, 1)
    mx = _flat(s_map).amax(dim=1).reshape(-1, 1, 1)
    return (s_map - mn) / (mx - mn)


def _std(x: torch.Tensor) -> torch.Tensor:
    """Unbiased std of each row of (B, N), kept as (B, 1)."""
    mu = x.mean(dim=1, keepdim=True)
    return torch.sqrt(torch.square(x - mu).sum(dim=1, keepdim=True) / (x.shape[1] - 1))


def kldiv(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """KL divergence between sum-normalised maps; mean over the batch."""
    s = _flat(_sum_normalize(s_map))
    g = _flat(_sum_normalize(gt))
    return (g * torch.log(EPS + g / (s + EPS))).sum(dim=1).mean()


def cc(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pearson correlation after per-sample standardisation (unbiased std)."""
    s = _flat(s_map)
    g = _flat(gt)
    s = (s - s.mean(dim=1, keepdim=True)) / _std(s)
    g = (g - g.mean(dim=1, keepdim=True)) / _std(g)
    ab = (s * g).sum(dim=1)
    aa = (s * s).sum(dim=1)
    bb = (g * g).sum(dim=1)
    return (ab / torch.sqrt(aa * bb)).mean()


def similarity(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Histogram intersection of min-max- then sum-normalised maps."""
    s = _flat(_sum_normalize(normalize_map(s_map)))
    g = _flat(_sum_normalize(normalize_map(gt)))
    return torch.minimum(s, g).sum(dim=1).mean()


def nss(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Normalised scanpath saliency: the mean standardised saliency at the
    fixations of a binary fixation map gt of the same shape."""
    s = _flat(s_map)
    s = (s - s.mean(dim=1, keepdim=True)) / (_std(s) + EPS)
    num = (s * _flat(gt)).sum(dim=1)
    cnt = _flat(gt).sum(dim=1)
    return (num / cnt).mean()


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The train CLI's loss flags; higher-is-better metrics carry negative
    coefficients because the total is minimised."""

    kldiv: bool = True
    cc: bool = False
    sim: bool = False
    nss: bool = False
    l1: bool = False
    kldiv_coeff: float = 1.0
    cc_coeff: float = -1.0
    sim_coeff: float = -1.0
    nss_coeff: float = 1.0
    l1_coeff: float = 1.0


def loss_func(pred_map: torch.Tensor, gt: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """The weighted loss. pred_map and gt: (B, H, W), or (B, Cl, H, W)
    multi-frame, folded into the batch axis (the reference's per-frame loop
    and mean, as one batch)."""
    if pred_map.dim() == 4:
        pred_map = pred_map.reshape(-1, *pred_map.shape[2:])
        gt = gt.reshape(-1, *gt.shape[2:])
    loss = torch.zeros((), dtype=torch.float32, device=pred_map.device)
    if cfg.kldiv:
        loss = loss + cfg.kldiv_coeff * kldiv(pred_map, gt)
    if cfg.cc:
        loss = loss + cfg.cc_coeff * cc(pred_map, gt)
    if cfg.l1:
        loss = loss + cfg.l1_coeff * (pred_map - gt).abs().mean()
    if cfg.sim:
        loss = loss + cfg.sim_coeff * similarity(pred_map, gt)
    if cfg.nss:
        loss = loss + cfg.nss_coeff * nss(pred_map, gt)
    return loss
