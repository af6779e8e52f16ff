"""ViNet video saliency in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``vinet_tpu`` is the reference this package is held against;
nothing here imports it. Layout inside the model is NCDHW (``nn.Conv3d``'s);
the public functions take what the JAX package takes: ``(B, T, H, W, 3)`` clips
in, ``(B, H, W)`` maps out. Entry points run on ``"cuda"`` unless the caller
asks for ``"cpu"`` (see ``device.resolve_device``).
"""
