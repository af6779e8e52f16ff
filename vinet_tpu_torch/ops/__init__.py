"""The port's ops. Exported here, as ``vinet_tpu/ops/__init__.py`` exports
them: the maps' min-max normalisation and uint8 quantisation."""

from vinet_tpu_torch.ops.image import minmax_normalize, to_uint8_map

__all__ = ["minmax_normalize", "to_uint8_map"]
