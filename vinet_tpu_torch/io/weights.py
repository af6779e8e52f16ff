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
  * TASEDv2 (``vinet_tpu/models/tased.py``): base1..base4 and convtsp1..4 at
    the top level, names as they are; its ConvTranspose3d weights
    (``TASED_TRANSPOSED``) (kT, kH, kW, I, O) -> torch's (I, O, kT, kH, kW)

``to_jax_trees`` is the inverse, the port's state_dict -> JAX (params,
state) trees, and ``save_npz_trees`` writes them as
``vinet_tpu/io/convert.py::save_npz_tree`` does: the JAX CLIs' ``.npz``.
"""

from __future__ import annotations

import numpy as np
import torch

_DEC_WITH_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                   "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv6": "convtsp4.6",
                   "conv7": "convtsp4.8"}
_DEC_NO_CONV6 = {"conv1": "convtsp1.0", "conv2": "convtsp2.0", "conv3": "convtsp3.0",
                 "conv4": "convtsp4.0", "conv5": "convtsp4.3", "conv7": "convtsp4.6"}
# TASEDv2's ConvTranspose3d modules (its decoder's Sequential indices, the
# reference's and the JAX package's)
TASED_TRANSPOSED = frozenset({"convtsp1.3", "convtsp2.0", "convtsp3.0", "convtsp4.0",
                              "convtsp4.6", "convtsp4.12"})
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
    if key == "w" and ".".join(path) in TASED_TRANSPOSED:  # (kT,kH,kW,I,O) -> (I,O,kT,kH,kW)
        return _tensor(value).permute(3, 4, 0, 1, 2).contiguous()
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
    """JAX-package ViNet, AViNet, AViNetFusion or TASEDv2 (params, state)
    nested dicts of arrays -> the port's state_dict of tensors (reference
    names). pe_len: the length of AViNetFusion's sin/cos table, its tokens
    + 3."""
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


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("state", "mean"), "running_var": ("state", "var")}
_INT8_LEAVES = ("w_q", "w_scale", "x_scale")


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 as the 2-byte void np.load gives
    for the JAX package's bf16 leaves."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _jax_weight(t: torch.Tensor, holder: str) -> torch.Tensor:
    """A port weight in the JAX package's layout: a ConvTranspose3d's (I, O,
    k...) or a conv's (O, I, k...) -> (kT, kH, kW, I, O), a 1-D conv's (O,
    I, K) -> (K, I, O); the bilinear's (O, I, J) and Linear's (O, I) as
    they are."""
    if holder in TASED_TRANSPOSED:
        return t.permute(2, 3, 4, 0, 1)
    if t.dim() == 5:
        return t.permute(2, 3, 4, 1, 0)
    if t.dim() == 3 and holder.rsplit(".", 1)[-1] != "bilinear":
        return t.permute(2, 1, 0)
    return t


def _transformer_key(path: list, leaf: str) -> tuple:
    """An encoder tensor's JAX path and leaf: ``transformer_state_dict``
    inverted, and ``transformer.transformer_encoder.layers`` ->
    ``transformer.layers``."""
    path = [p for p in path if p != "transformer_encoder"]
    if path[-1] in ("self_attn", "multihead_attn") and leaf in ("in_proj_weight",
                                                                "in_proj_bias"):
        return path, {"in_proj_weight": "in_proj_w", "in_proj_bias": "in_proj_b"}[leaf]
    if path[-1].startswith("norm"):
        return path, {"weight": "scale", "bias": "bias"}[leaf]
    return path, {"weight": "w", "bias": "b", "tgt_pos": "tgt_pos"}[leaf]


def _sorted_tree(node):
    """Every dict's keys in sorted order, as JAX's pytree flattening leaves
    them (the JAX CLIs save host copies of jitted states)."""
    if not isinstance(node, dict):
        return node
    return {k: _sorted_tree(node[k]) for k in sorted(node)}


def to_jax_trees(state_dict: dict) -> tuple[dict, dict]:
    """The port's ViNet, AViNet, AViNetFusion or TASEDv2 state_dict -> the
    JAX package's (params, state) nested dicts of numpy arrays,
    ``from_jax_trees`` inverted: weights in JAX's layouts, BatchNorm
    weight/bias/running_mean/running_var -> params scale/bias and state
    mean/var, the decoder's convtspN.i -> conv1..conv7, the encoder's names
    back, keys sorted at every level. ``num_batches_tracked`` and the
    sin/cos tables are dropped: JAX stores neither. The int8 path's
    QuantConv3d buffers raise (no JAX CLI writes an int8 tree to
    --model_val_path)."""
    int8 = [k for k in state_dict if k.rsplit(".", 1)[-1] in _INT8_LEAVES]
    if int8:
        raise ValueError(f"{int8[0]}: an int8 QuantConv3d has no .npz tree here; "
                         "write the float model")
    bns = {k[: -len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}
    trees: dict = {"params": {}, "state": {}}
    for name, t in state_dict.items():
        holder, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked" or name.endswith("pos_encoder.pe"):
            continue
        path = holder.split(".")
        tree = "params"
        if holder in bns:
            tree, key = _BN_LEAVES[leaf]
        elif path[0] == "transformer":
            path, key = _transformer_key(path, leaf)
        elif len(path) >= 3 and path[-3] == "decoder":
            prefix = ".".join(path[:-2])
            conv6 = f"{prefix}.convtsp4.8.weight" in state_dict
            table = {v: k for k, v in decoder_names(conv6).items()}
            path = path[:-2] + [table[".".join(path[-2:])]]
            key = {"weight": "w", "bias": "b"}[leaf]
        elif leaf in ("weight", "bias"):
            key = "w" if leaf == "weight" else "b"
        else:
            raise KeyError(f"unhandled state_dict entry: {name}")
        if key == "w":
            t = _jax_weight(t.detach(), holder)
        node = trees[tree]
        for part in path:
            node = node.setdefault(part, {})
        node[key] = _array(t)
    return _sorted_tree(trees["params"]), _sorted_tree(trees["state"])


def _npz_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _npz_leaves(v, name)
        else:
            yield name, v


def save_npz_trees(path: str, params: dict, state: dict) -> None:
    """Write (params, state) as ``vinet_tpu/io/convert.py::save_npz_tree``
    does (np.savez): members 'params/<dotted>' then 'state/<dotted>' in the
    trees' order, '.npz' appended to a path without it. A bf16 leaf (torch's
    bits as a 2-byte void, or an ml_dtypes array) is written with the
    header descr '<V2' that np.savez gives JAX's bf16 arrays, so each
    member's bytes are JAX's; ``load_npz_trees`` and JAX's
    ``load_npz_tree`` read it."""
    import zipfile

    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for prefix, tree in (("params", params), ("state", state)):
            for name, value in _npz_leaves(tree):
                a = np.asarray(value)
                with zf.open(f"{prefix}/{name}.npy", "w", force_zip64=True) as f:
                    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) or \
                            a.dtype.name == "bfloat16":
                        np.lib.format.write_array_header_1_0(
                            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
                        f.write(np.ascontiguousarray(a).tobytes())
                    else:
                        np.lib.format.write_array(f, a, allow_pickle=False)


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
    """A state_dict for the port's ViNet, AViNet, AViNetFusion or TASEDv2
    from a JAX-package .npz or a reference .pt state_dict (SoundNet's and
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
