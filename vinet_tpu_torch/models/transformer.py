"""The transformers of the audio-visual models, ``vinet_tpu/models/transformer.py``
(``positional_encoding``, ``TransformerEncoderLayer``, ``TransformerEncoder``,
``_mha``, ``TransformerDecoderLayer``, ``Seq2SeqTransformer``) with the
reference's parameter names.

Post-LN layers with a ReLU feed-forward and torch's packed q, k, v
projection (``self_attn.in_proj_weight`` (3E, E), ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``; the decoder layer adds
``multihead_attn`` and ``norm3``). Tokens are batch-first (B, S, E). The
attention logits are accumulated and the softmax taken in f32, the
probabilities cast to the value's dtype, as the JAX package does; LayerNorm
runs in f32 (float64 for float64). Both stay so under autocast.

Dropout (p = 0.1) follows the JAX package, not ``nn.TransformerEncoderLayer``:
an encoder layer drops at three sites, the attention probabilities, the
attention output before the first residual and the feed-forward output
before the second; torch's fourth site, inside the feed-forward after the
ReLU, is left out. A decoder layer drops the attention probabilities of its
self- and cross-attention and the feed-forward output, as
``TransformerDecoderLayer.apply`` does. Kept elements are scaled by
1 / (1 - p). Masks are drawn with ``torch.rand`` from the ``generator``
handed to ``forward`` (one on the activations' device), never from the
global RNG, and only in training mode: without a generator, or in eval
mode, nothing is drawn and nothing is dropped, as a JAX train state without
``"rng"`` trains without dropout. A data-parallel rank holds a
``RowsGenerator``: it draws each mask at the shape of the global batch and
keeps its own rows (the batch is dim 0 of every dropped tensor), so W
ranks drop what one process does.

``TransformerEncoder`` is the reference's ``Transformer`` wrapper: the
sin/cos table as the buffer ``pos_encoder.pe`` (max_len, 1, feat), added
before layer 0, and the stack as ``transformer_encoder.layers.N``, so a
reference state_dict loads strictly and the export carries the table;
``Seq2SeqTransformer`` adds the wrapper's spatial pre-encoder and query
decoder under the wrapper's names.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5
DROPOUT = 0.1  # torch's default, the reference's transformers'


def positional_encoding(max_len: int, feat: int) -> torch.Tensor:
    """The sin/cos table (max_len, feat) in f32, computed in numpy as the
    JAX package computes it."""
    pe = np.zeros((max_len, feat), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, feat, 2, dtype=np.float32) * (-math.log(10000.0) / feat))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe)


def no_autocast(device: torch.device):
    """Autocast off for a block that must run in the dtypes it is given."""
    return torch.autocast(device.type, enabled=False)


@dataclasses.dataclass(frozen=True)
class RowsGenerator:
    """A data-parallel rank's dropout generator: masks are drawn for the
    global batch of ``batch`` rows and the rank keeps ``rows`` of them."""
    generator: torch.Generator
    batch: int
    rows: slice


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | RowsGenerator | None) -> torch.Tensor:
    """JAX's ``_dropout``: each element kept with probability 1 - p and then
    scaled by 1 / (1 - p), else 0; the mask is drawn from generator. x as
    it is without a generator or with p 0."""
    if generator is None or p <= 0.0:
        return x
    if isinstance(generator, RowsGenerator):
        draw = torch.rand((generator.batch, *x.shape[1:]), generator=generator.generator,
                          device=x.device)[generator.rows]
    else:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    keep = draw < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _acc(x: torch.Tensor) -> torch.dtype:
    """f32, or x's dtype where it is wider (float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _layernorm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    acc = _acc(x)
    with no_autocast(x.device):
        return F.layer_norm(x.to(acc), norm.normalized_shape, norm.weight.to(acc),
                            norm.bias.to(acc), LN_EPS).to(x.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention with torch's packed in_proj parameters, the JAX
    package's ``_mha``: queries from q_in (B, S, E), keys and values from
    kv_in (B, M, E) (q_in itself for self-attention)."""

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

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor | None = None,
                generator: torch.Generator | None = None, p: float = 0.0) -> torch.Tensor:
        """p: the dropout of the attention probabilities (drawn from
        generator)."""
        b, s, e = q_in.shape
        h = self.nhead

        def heads(t):  # (B, N, E) -> (B, h, N, E/h)
            return t.reshape(t.shape[0], t.shape[1], h, e // h).transpose(1, 2)

        if kv_in is None:  # one GEMM for q, k and v
            q, k, v = map(heads, F.linear(q_in, self.in_proj_weight,
                                          self.in_proj_bias).chunk(3, dim=-1))
        else:
            wq, wkv = self.in_proj_weight.split((e, 2 * e))
            bq, bkv = self.in_proj_bias.split((e, 2 * e))
            q = heads(F.linear(q_in, wq, bq))
            k, v = map(heads, F.linear(kv_in, wkv, bkv).chunk(2, dim=-1))
        with no_autocast(q.device):
            acc = _acc(q)
            logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) / math.sqrt(e // h)
            attn = torch.softmax(logits, dim=-1)
        attn = dropout(attn, p, generator).to(v.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(ctx)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, p: float = DROPOUT):
        super().__init__()
        self.p = p
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, S, E) -> (B, S, E), post-LN; dropout from generator in
        training mode."""
        g, p = (generator, self.p) if self.training else (None, 0.0)
        ctx = self.self_attn(x, generator=g, p=p)
        x = _layernorm(self.norm1, x + dropout(ctx, p, g))
        ff = self.linear2(torch.relu(self.linear1(x)))
        return _layernorm(self.norm2, x + dropout(ff, p, g))


class TransformerDecoderLayer(nn.Module):
    """torch's nn.TransformerDecoderLayer (post-LN) with the JAX package's
    dropout sites: self-attention over the targets, cross-attention to the
    memory, the ReLU feed-forward."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, p: float = DROPOUT):
        super().__init__()
        self.p = p
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tgt (B, Q, E), memory (B, S, E) -> (B, Q, E)."""
        g, p = (generator, self.p) if self.training else (None, 0.0)
        tgt = _layernorm(self.norm1, tgt + self.self_attn(tgt, generator=g, p=p))
        tgt = _layernorm(self.norm2, tgt + self.multihead_attn(tgt, memory, generator=g, p=p))
        ff = self.linear2(torch.relu(self.linear1(tgt)))
        return _layernorm(self.norm3, tgt + dropout(ff, p, g))


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

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, S, E), S <= max_len -> (B, S, E)."""
        x = x + self.pos_encoder.pe[: x.shape[1], 0].to(x.dtype)
        for layer in self.transformer_encoder.layers:
            x = layer(x, generator)
        return x


class Seq2SeqTransformer(TransformerEncoder):
    """The reference's whole ``Transformer`` wrapper, the JAX package's
    ``Seq2SeqTransformer``: an optional spatial pre-encoder (spatial_dim !=
    -1: ``transformer_encoder_spatial``, layers of width spatial_dim over
    the transposed token axis, without the table), the encoder, and an
    optional query decoder (num_decoder_layers != -1:
    ``transformer_decoder.layers.N`` and ``transformer_decoder.norm``) whose
    targets are the learned ``tgt_pos`` rows, all of them or row query_idx."""

    def __init__(self, feat_size: int, hidden_size: int = 256, nhead: int = 4,
                 num_encoder_layers: int = 3, max_len: int = 4, num_decoder_layers: int = -1,
                 num_queries: int = 4, spatial_dim: int = -1):
        super().__init__(feat_size, nhead, num_encoder_layers, hidden_size, max_len)
        if spatial_dim != -1:
            self.transformer_encoder_spatial = _Stack(
                TransformerEncoderLayer(spatial_dim, nhead, hidden_size)
                for _ in range(num_encoder_layers))
        if num_decoder_layers != -1:
            self.transformer_decoder = _Stack(
                TransformerDecoderLayer(hidden_size, nhead, hidden_size)
                for _ in range(num_decoder_layers))
            self.transformer_decoder.norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
            self.tgt_pos = nn.Parameter(torch.randn(num_queries, hidden_size))

    def forward(self, x: torch.Tensor, query_idx: int = -1,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, S, E) -> the encoder's (B, S, E), or with the query decoder
        (B, Q, hidden) (Q = 1 for a query_idx)."""
        if hasattr(self, "transformer_encoder_spatial"):
            xt = x.transpose(1, 2)
            for layer in self.transformer_encoder_spatial.layers:
                xt = layer(xt, generator)
            x = xt.transpose(1, 2)
        mem = super().forward(x, generator)
        if not hasattr(self, "transformer_decoder"):
            return mem
        tgt_pos = self.tgt_pos if query_idx == -1 else self.tgt_pos[query_idx: query_idx + 1]
        tgt = tgt_pos[None].expand(x.shape[0], *tgt_pos.shape).to(x.dtype)
        for layer in self.transformer_decoder.layers:
            tgt = layer(tgt, mem, generator)
        return _layernorm(self.transformer_decoder.norm, tgt)
