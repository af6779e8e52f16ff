"""Inference-time preparation: BatchNorm folding, the low-precision cast and
int8 quantization, and ``make_inference_fn`` which does them in order.

Run ``fold_batchnorms`` after the weights are loaded: loading needs the
reference names, folding removes the BatchNorms.
"""

from __future__ import annotations

import torch
from torch import nn

from vinet_tpu_torch.device import resolve_device
from vinet_tpu_torch.io.weights import decoder_names
from vinet_tpu_torch.ops import quant

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fold_batchnorms(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm into its conv in place (exact at f32), each at
    its own eps (the visual net's 1e-3, SoundNet's 1e-5): each conv gains a
    bias and its BatchNorm becomes nn.Identity. Returns model."""
    for m in model.modules():
        fold = getattr(m, "fold_bn", None)
        if fold is not None:
            fold()
    return model


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating-point parameters and buffers to dtype (bf16 inference),
    the audio-visual modules' too (SoundNet, the bilinear weights, the
    encoder and its sin/cos table); the int8 weights of quantized convs stay
    int8."""
    return model.to(dtype)


def _int8_skip(model: nn.Module) -> set:
    """The convs that stay bf16 on the int8 path, as in the JAX package's
    ``quantize_int8``: the decoder's conv5, conv6 and conv7 (the head kernel
    reads conv6 and conv7's weights)."""
    table = decoder_names(model.decoder.plan.conv6 is not None)
    return {f"decoder.{table[c]}" for c in ("conv5", "conv6", "conv7") if c in table}


def quantize_int8(model: nn.Module, calib_clips: torch.Tensor) -> None:
    """Calibrate and quantize a FOLDED f32 ViNet in place
    (``vinet_tpu/models/inference.py::quantize_int8``): one f32 forward over
    calib_clips (B, T, H, W, 3) records every conv input's absmax, then every
    conv with a record > 0, except the decoder's conv5, conv6 and conv7,
    becomes a QuantConv3d."""
    with quant.calibration(model) as records, torch.inference_mode(), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        model(calib_clips.float())
    quant.quantize_convs(model, records, skip=_int8_skip(model))


def load_int8_state_dict(model: nn.Module, state_dict: dict) -> nn.Module:
    """Load a quantized state_dict (``io/weights.py::from_jax_trees`` of a JAX
    int8 tree) into a folded model: each conv whose ``w_q`` the state_dict
    holds becomes a QuantConv3d first. Strict; returns model."""
    for key in state_dict:
        if key.endswith(".w_q"):
            name = key[:-len(".w_q")]
            quant.replace_module(model, name, quant.QuantConv3d.like(model.get_submodule(name)))
    model.load_state_dict(state_dict, strict=True)
    return model


def make_inference_fn(model: nn.Module, *, dtype: str = "bfloat16", calib_clips=None,
                      device="cuda"):
    """Prepare model in place and return (fn, model); fn(clips[, audio])
    maps (B, T, H, W, 3) normalised clips (and for AViNet (B, L, 1)
    waveforms, cast to dtype) to (B, H, W) f32 maps on ``device``.

    ``vinet_tpu/models/inference.py::make_inference_fn``: fold the
    BatchNorms (a folded model stays as it is), then cast to dtype
    ("float32" or "bfloat16"). dtype="int8" (needs calib_clips) casts to f32,
    calibrates on calib_clips in f32 on ``device``, quantizes
    (``quantize_int8``) and casts every floating tensor to bf16, the
    quantization scales and biases included. int8 takes visual ViNet only:
    the JAX package calibrates without audio, so its int8 AViNet does not
    run either."""
    if dtype not in (*DTYPES, "int8"):
        raise ValueError(f"dtype must be one of {(*DTYPES, 'int8')}, got {dtype!r}")
    if dtype == "int8" and not hasattr(model, "decoder"):
        raise ValueError("dtype='int8' takes visual ViNet only")
    dev = resolve_device(device)
    fold_batchnorms(model.eval())
    if dtype == "int8":
        if calib_clips is None:
            raise ValueError("dtype='int8' needs calib_clips")
        model = cast_floating(model, torch.float32).to(dev)
        quantize_int8(model, calib_clips.to(dev))
        dtype = "bfloat16"  # activations and the unquantized convs
    dtype = DTYPES[dtype]
    model = cast_floating(model, dtype).to(dev)

    def fn(clips: torch.Tensor, audio: torch.Tensor | None = None) -> torch.Tensor:
        with torch.inference_mode():
            if audio is None:
                return model(clips.to(dev, dtype)).float()
            return model(clips.to(dev, dtype), audio.to(dev, dtype)).float()

    return fn, model
