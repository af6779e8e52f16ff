"""The refinement encoder, ``vinet_tpu/models/transformer.py``
(``positional_encoding``, ``TransformerEncoderLayer``, ``TransformerEncoder``)
with the reference's parameter names.

Post-LN layers with a ReLU feed-forward and torch's packed q, k, v
projection (``self_attn.in_proj_weight`` (3E, E), ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``), in eval mode (no dropout).
Tokens are batch-first (B, S, E). The attention logits are accumulated and
the softmax taken in f32, the probabilities cast to the value's dtype, as
the JAX package does; LayerNorm runs in f32.

``TransformerEncoder`` is the reference's ``Transformer`` wrapper: the
sin/cos table as the buffer ``pos_encoder.pe`` (max_len, 1, feat), added
before layer 0, and the stack as ``transformer_encoder.layers.N``, so a
reference state_dict loads strictly and the export carries the table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def positional_encoding(max_len: int, feat: int) -> torch.Tensor:
    """The sin/cos table (max_len, feat) in f32, computed in numpy as the
    JAX package computes it."""
    pe = np.zeros((max_len, feat), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, feat, 2, dtype=np.float32) * (-math.log(10000.0) / feat))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe)


def _layernorm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), LN_EPS).to(x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch's packed in_proj parameters."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        limit = math.sqrt(6.0 / (4 * d_model))  # xavier_uniform of the packed (3E, E)
        nn.init.uniform_(self.in_proj_weight, -limit, limit)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        h = self.nhead
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, h, e // h).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(e // h)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(ctx)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, E) -> (B, S, E), post-LN."""
        x = _layernorm(self.norm1, x + self.self_attn(x))
        return _layernorm(self.norm2, x + self.linear2(torch.relu(self.linear1(x))))


class PositionalEncoding(nn.Module):
    def __init__(self, max_len: int, feat: int):
        super().__init__()
        self.register_buffer("pe", positional_encoding(max_len, feat)[:, None, :])


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerEncoder(nn.Module):
    """Additive sin/cos table over the first S positions, then the stack."""

    def __init__(self, feat_size: int, nhead: int = 4, num_layers: int = 3,
                 hidden_size: int = 256, max_len: int = 4):
        super().__init__()
        self.pos_encoder = PositionalEncoding(max_len, feat_size)
        self.transformer_encoder = _Stack(
            TransformerEncoderLayer(feat_size, nhead, hidden_size) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, E), S <= max_len -> (B, S, E)."""
        x = x + self.pos_encoder.pe[: x.shape[1], 0].to(x.dtype)
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return x
