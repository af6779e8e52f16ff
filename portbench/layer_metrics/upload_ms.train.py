"""Host time of a step's upload (``cli/train.py::to_device``: the clips,
GT and audio from pageable host memory, the clips normalised on the
device): the median over the traced steps of ``train.upload``'s host time."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "train.upload")
