"""Checkpoint export: a ViNet of the port -> the reference's torch ``.pt``,
``vinet_tpu/io/export.py`` (visual ViNet).

The port's modules carry the reference's names (``io/weights.py``), so the
export is the model's ``state_dict`` with every tensor on the CPU and
contiguous. BatchNorm's ``num_batches_tracked`` is written as 0, as the JAX
package writes it (torch reads it only with momentum=None, which the
reference never uses), so the same weights export to the same file from
either package. The reference's classes load the file strictly.

The audio-visual transformer's synthesized ``pos_encoder.pe`` tables wait for
the audio-visual slice (``ROADMAP.md`` queue 1 item 5).
"""

from __future__ import annotations

import torch


def export_torch_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Save model's state_dict as the reference loads it: every tensor on the
    CPU and contiguous, num_batches_tracked 0."""
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.int64)
        else:
            sd[name] = t.detach().cpu().contiguous().clone()
    torch.save(sd, path)
