"""Checkpoint export: a ViNet or AViNet of the port -> the reference's torch
``.pt``, ``vinet_tpu/io/export.py``.

The port's modules carry the reference's names (``io/weights.py``), so the
export is the model's ``state_dict`` with every tensor on the CPU and
contiguous, and two things the reference's layout asks for:

  * SoundNet's conv weights as its Conv2d's (O, I, k, 1) (``nn.Conv1d``
    holds (O, I, k));
  * the refinement encoder under ``transformer.transformer_encoder.*``
    (``_emit_transformer``'s names, the modules' own) with its sin/cos table
    ``transformer.pos_encoder.pe`` (max_len, 1, feat), which JAX
    synthesizes (``_model_pe_tables``) and the port keeps as the encoder's
    buffer, so the state_dict carries it.

BatchNorm's ``num_batches_tracked`` is written as 0, as the JAX package
writes it (torch reads it only with momentum=None, which the reference never
uses), so the same weights export to the same file from either package.
"""

from __future__ import annotations

import torch


def export_torch_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Save model's state_dict in the reference's layout: every tensor on the
    CPU and contiguous, num_batches_tracked 0, SoundNet's conv weights 4-D."""
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.int64)
            continue
        t = t.detach().cpu()
        if name.startswith("audionet.") and name.endswith(".weight") and t.dim() == 3:
            t = t[..., None]  # nn.Conv1d (O, I, k) -> Conv2d (O, I, k, 1)
        sd[name] = t.contiguous().clone()
    torch.save(sd, path)
