"""Weights: JAX-package trees and reference state_dicts -> the port's state_dict.

The port's modules carry the reference's names, so a reference ``.pt``
state_dict loads with ``load_state_dict(strict=True)``; the one conversion
is SoundNet's conv weights, Conv2d (O, I, k, 1) in the reference and
``nn.Conv1d`` (O, I, k) here (``load_weights`` takes both). The JAX
package's ``(params, state)`` trees go through ``from_jax_trees``, the
inverse of ``vinet_tpu/io/convert.py`` for ViNet and AViNet (the same
transforms as ``vinet_tpu/io/export.py``):

  * conv weight (kT, kH, kW, I, O) -> (O, I, kT, kH, kW); 'w'/'b' -> weight/bias
  * SoundNet conv weight (K, I, O) -> (O, I, K); bilinear 'w' (O, I, J) as it is
  * BatchNorm params scale/bias + state mean/var -> weight/bias/
    running_mean/running_var, plus num_batches_tracked (0)
  * decoder conv1..conv7 -> convtspN.i (under ``visual_model.`` for AViNet)
  * the encoder's layers -> ``transformer.transformer_encoder.layers.N``
    (in_proj_w/in_proj_b -> in_proj_weight/in_proj_bias, LayerNorm
    scale/bias -> weight/bias; ``transformer_state_dict``, which maps any
    transformer subtree, a ``Seq2SeqTransformer``'s too), and its sin/cos
    table, which JAX recomputes and does not store, as
    ``transformer.pos_encoder.pe``: max_len = conv_in_1x1's channels for
    AViNet's refinement encoder, ``pe_len`` (tokens + 3, 339 at 32 x 224 x
    384) for AViNetFusion's joint encoder (the trees with audio_conv_1x1)
  * AViNetFusion's audio_conv_1x1 (K, I, O) -> (O, I, K), an nn.Conv1d;
    the reference's Conv2d (O, I, 1, 1) and its top-level ``pe`` buffer
    (``tests/torch_ref.py::TAViNetFusion``) load through ``load_weights``
  * an int8 conv of ``vinet_tpu/ops/quant.py`` ({w_q, w_scale, x_scale[, b]})
    -> the buffers of ``ops/quant.py::QuantConv3d``: w_q (DHWIO -> OIDHW, as
    a float weight), w_scale, x_scale, bias; load it with
    ``models/inference.py::load_int8_state_dict``
"""

from __future__ import annotations

import numpy as np
import torch

_DEC_WITH_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                   "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv6": "convtsp4.6",
                   "conv7": "convtsp4.8"}
_DEC_NO_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                 "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv7": "convtsp4.6"}
# params leaf -> state_dict leaf (float conv, or an int8 conv's buffers)
_LEAVES = {"w": "weight", "b": "bias", "w_q": "w_q", "w_scale": "w_scale",
           "x_scale": "x_scale"}


def decoder_names(with_conv6: bool) -> dict:
    """JAX decoder conv key (conv1..conv7) -> the port's module name."""
    return _DEC_WITH_CONV6 if with_conv6 else _DEC_NO_CONV6


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) or a.dtype.name == "bfloat16":
        # bf16, stored by np.savez as a 2-byte void (or an ml_dtypes array
        # handed over in memory): reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _conv_weight(w) -> torch.Tensor:
    """A JAX conv weight: (kT, kH, kW, I, O) -> (O, I, kT, kH, kW), or
    SoundNet's (K, I, O) -> (O, I, K)."""
    t = _tensor(w)
    if t.dim() == 5:
        return t.permute(4, 3, 0, 1, 2).contiguous()
    if t.dim() == 3:
        return t.permute(2, 1, 0).contiguous()
    raise ValueError(f"expected a conv weight (kT,kH,kW,I,O) or (K,I,O), got {tuple(t.shape)}")


def _leaf(key: str, value, path: list) -> torch.Tensor:
    if key in ("w", "w_q") and path[-1:] != ["bilinear"]:  # bilinear (O, I, J): torch's
        return _conv_weight(value)
    return _tensor(value)


_ATTN_LEAVES = {"in_proj_w": "in_proj_weight", "in_proj_b": "in_proj_bias"}
_TRANSFORMER_LEAVES = {"w": "weight", "b": "bias", "tgt_pos": "tgt_pos"}
FUSION_PE_LEN = 336 + 3  # AViNetFusion's tokens at 32 x 224 x 384, and its 3 audio tokens


def transformer_state_dict(node: dict, prefix: str = "") -> dict:
    """A JAX transformer subtree (``vinet_tpu/models/transformer.py``'s
    params, ``vinet_tpu/io/convert.py:53-69`` inverted) -> the port's
    tensors, named under prefix: attention in_proj_w/in_proj_b ->
    in_proj_weight/in_proj_bias, LayerNorm scale/bias -> weight/bias,
    w/b -> weight/bias. The sin/cos tables are not in the trees."""
    out = {}

    def walk(n: dict, path: list) -> None:
        for k, v in n.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            holder = path[-1] if path else ""
            leaf = (_ATTN_LEAVES.get(k) if holder in ("self_attn", "multihead_attn") else
                    {"scale": "weight", "bias": "bias"}.get(k) if holder.startswith("norm") else
                    _TRANSFORMER_LEAVES.get(k))
            if leaf is None:
                raise KeyError(f"unhandled transformer leaf: {'.'.join(path + [k])}")
            out[".".join(([prefix] if prefix else []) + path + [leaf])] = _tensor(v)

    walk(node, [])
    return out


def _transformer(out: dict, prefix: str, node: dict, max_len: int) -> None:
    """An AV model's encoder: its layers and its sin/cos table."""
    from vinet_tpu_torch.models.transformer import positional_encoding

    if set(node) != {"layers"}:
        raise KeyError(f"unhandled transformer subtree: {sorted(node)}")
    out.update(transformer_state_dict(node, f"{prefix}.transformer_encoder"))
    feat = _tensor(node["layers"]["0"]["self_attn"]["in_proj_w"]).shape[1]
    out[f"{prefix}.pos_encoder.pe"] = positional_encoding(max_len, feat)[:, None, :]


def from_jax_trees(params: dict, state: dict, *, pe_len: int = FUSION_PE_LEN) -> dict:
    """JAX-package ViNet, AViNet or AViNetFusion (params, state) nested dicts
    of arrays -> the port's state_dict of tensors (reference names). pe_len:
    the length of AViNetFusion's sin/cos table, its tokens + 3."""
    out: dict = {}

    def walk(p_node: dict, s_node: dict, path: list) -> None:
        for k, v in p_node.items():
            name = ".".join(path + [k])
            sv = s_node.get(k, {}) if isinstance(s_node, dict) else {}
            if k == "transformer" and not path:
                cin = p_node.get("conv_in_1x1", {}).get("w")
                if "audio_conv_1x1" in p_node:
                    _transformer(out, name, v, pe_len)
                elif cin is None:
                    raise ValueError(f"{name}: no conv_in_1x1 gives the sin/cos table's length")
                else:
                    _transformer(out, name, v, np.shape(cin)[-1])
            elif k == "decoder" and path in ([], ["visual_model"]):
                table = decoder_names("conv6" in v)
                for conv, node in v.items():
                    for leaf, value in node.items():
                        out[f"{name}.{table[conv]}.{_LEAVES[leaf]}"] = _leaf(leaf, value, [])
            elif isinstance(v, dict) and set(v) == {"scale", "bias"}:
                out[f"{name}.weight"] = _tensor(v["scale"])
                out[f"{name}.bias"] = _tensor(v["bias"])
                out[f"{name}.running_mean"] = _tensor(sv["mean"])
                out[f"{name}.running_var"] = _tensor(sv["var"])
                out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            elif isinstance(v, dict):
                walk(v, sv, path + [k])
            elif k in _LEAVES:
                out[".".join(path + [_LEAVES[k]])] = _leaf(k, v, path)
            else:
                raise KeyError(f"unhandled params leaf: {name}")

    walk(params, state, [])
    return out


def load_npz_trees(path: str) -> tuple[dict, dict]:
    """A JAX-package .npz ('params/<dotted>' and 'state/<dotted>' keys) ->
    (params, state) nested dicts of numpy arrays (bf16 leaves as 2-byte void)."""
    trees: dict = {"params": {}, "state": {}}
    with np.load(path) as data:
        for key in data.files:
            prefix, name = key.split("/", 1)
            node = trees[prefix]
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return trees["params"], trees["state"]


def s3d_kinetics_remap(sd: dict) -> dict:
    """The reference's Kinetics-400 name surgery (its train.py, and
    ``vinet_tpu/io/convert.py::s3d_kinetics_remap``): 'base.N.rest' ->
    'base{K}.{N - sn}.rest' with sn in [0, 5, 8, 14]; other names pass."""
    out = {}
    sn_list = [0, 5, 8, 14]
    for name, v in sd.items():
        if name.startswith("module."):
            name = name[len("module."):]
        if name.startswith("base."):
            parts = name.split(".")
            bn = int(parts[1])
            sn = max(s for s in sn_list if s <= bn)
            name = "base%d.%d." % (sn_list.index(sn) + 1, bn - sn) + ".".join(parts[2:])
        out[name] = v
    return out


def _soundnet_conv1d(name: str, t: torch.Tensor) -> torch.Tensor:
    """A SoundNet (or AViNetFusion audio_conv_1x1) conv weight as the port's
    nn.Conv1d takes it: the reference's Conv2d (O, I, k, 1) (or (O, I, 1,
    k)) -> (O, I, k)."""
    if name.endswith(".weight") and t.dim() == 4:
        if 1 not in t.shape[2:]:
            raise ValueError(f"{name}: not a 1-D conv weight {tuple(t.shape)}")
        return t.squeeze(3 if t.shape[3] == 1 else 2)
    return t


def load_weights(path: str, *, pe_len: int = FUSION_PE_LEN) -> dict:
    """A state_dict for the port's ViNet, AViNet or AViNetFusion from a
    JAX-package .npz or a reference .pt state_dict (SoundNet's and
    audio_conv_1x1's Conv2d weights made 1-D, a top-level 'pe' table as
    'transformer.pos_encoder.pe'). Load it with load_state_dict(strict=True),
    or with ``load_model_weights``. Two partial files give their entries
    alone: an S3D Kinetics-400 backbone (S3D_kinetics400.pt, flat 'base.N.*'
    names) under 'backbone.', and a SoundNet state_dict
    (soundnet8_final.pth, 'convN.*'/'batchnormN.*') under 'audionet.'.
    pe_len: as ``from_jax_trees``'s, for an .npz."""
    if path.endswith(".npz"):
        return from_jax_trees(*load_npz_trees(path), pe_len=pe_len)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # a checkpoint saved from nn.DataParallel prefixes every name
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    if any(k.startswith("base.") for k in sd):
        return {f"backbone.{k}": v for k, v in s3d_kinetics_remap(sd).items()
                if k.startswith("base")}
    if sd and all(k.split(".")[0].startswith(("conv", "batchnorm")) for k in sd):
        sd = {f"audionet.{k}": v for k, v in sd.items()}  # SoundNet alone
    if "pe" in sd:  # the reference twin's table, outside its transformer
        sd["transformer.pos_encoder.pe"] = sd.pop("pe")
    return {k: _soundnet_conv1d(k, v) if k.startswith(("audionet.", "audio_conv_1x1.")) else v
            for k, v in sd.items()}


def load_model_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load path (``load_weights``) into model strictly: the whole model, or
    from a file that holds only a part, that part alone (the rest keeps its
    weights): the S3D backbone (of ViNet, or of AViNet's visual model), or
    AViNet's SoundNet. Returns model."""
    pe = getattr(getattr(model, "transformer", None), "pos_encoder", None)
    sd = load_weights(path, pe_len=FUSION_PE_LEN if pe is None else pe.pe.shape[0])
    for part in ("backbone", "audionet"):
        if all(k.startswith(part + ".") for k in sd):
            owner = model.visual_model if part == "backbone" and hasattr(model, "visual_model") \
                else model
            getattr(owner, part).load_state_dict(
                {k[len(part) + 1:]: v for k, v in sd.items()}, strict=True)
            return model
    model.load_state_dict(sd, strict=True)
    return model
