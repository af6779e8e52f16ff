"""Training of visual ViNet: losses, the train and eval steps, and
streaming-consistent fine-tuning (``vinet_tpu/training``)."""

from vinet_tpu_torch.training.losses import LossConfig, cc, kldiv, loss_func, nss, similarity

__all__ = ["LossConfig", "cc", "kldiv", "loss_func", "nss", "similarity"]
