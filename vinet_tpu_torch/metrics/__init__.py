"""Saliency metrics on the host in float64 (``metrics/saliency.py``), MATLAB's
imresize (``metrics/imresize.py``) and EMD on the native solver
(``metrics/emd.py``)."""

from vinet_tpu_torch.metrics.saliency import (
    auc_borji,
    auc_judd,
    auc_shuffled,
    cc_score,
    create_shuffle_map,
    info_gain,
    kldiv_score,
    nss_score,
    similarity_score,
)

__all__ = [
    "cc_score",
    "similarity_score",
    "nss_score",
    "kldiv_score",
    "auc_judd",
    "auc_borji",
    "auc_shuffled",
    "info_gain",
    "create_shuffle_map",
]
