"""ViNet video saliency in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``vinet_tpu`` is the reference this package is held against;
nothing here imports it. Layout inside the model is NCDHW (``nn.Conv3d``'s);
the public functions take what the JAX package takes: ``(B, T, H, W, 3)`` clips
in, ``(B, H, W)`` maps out. Entry points run on ``"cuda"`` unless the caller
asks for ``"cpu"`` (see ``device.resolve_device``).

Every TPU kernel of the repo has a CUDA C++ counterpart for ``sm_90a`` in
``csrc/``, built at first use (``ops/build.py``), with its plain PyTorch
version beside it for CPU tensors:

- ``csrc/saliency_head.cu`` (``ops/saliency_head.py``) replaces
  ``vinet_tpu/ops/pallas_head.py:54`` ``saliency_head_pallas``; the decoder
  runs its mode fused with the last 2x upsample (``saliency_head_up2x``);
- ``csrc/int8_mm.cu`` (``ops/int8_mm.py``) replaces
  ``scripts/exp_int8_mxu_r5.py:64`` ``pallas_mm``;
- ``csrc/tconv.cu`` (``ops/tconv.py``) replaces
  ``scripts/exp_int8_mxu_r5.py:154`` ``pallas_tconv``.

The last two carry the int8 inference path (``ops/quant.py``,
``models/inference.py::make_inference_fn(dtype="int8")``).

The serving paths run the S3D backbone once per frame on phase timelines
(``inference/streaming.py``: ``StreamingPredictor``, ``generate_result
--streaming``), advance them incrementally (``inference/live.py``:
``LiveStreamingPredictor``, ``--live``) and batch many streams in one
pipeline (``inference/serving.py``: ``MultiLiveServer``, ``cli/serve.py``).
Every decode ends in the head kernel's fused mode.

Training (``training/``, ``cli/train.py``) runs the model in training mode:
BatchNorm on batch statistics and the decoder's plain differentiable graph,
the JAX package's ``train=True`` route; the kernels have no backward and
refuse autograd. Validation runs in eval mode, through the head kernel.
"""
