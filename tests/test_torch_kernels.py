"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so its card tests also run
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked ``gpu`` need a CUDA card and skip without one; the others check
the wrappers' input validation and device rule on the CPU.
"""

import numpy as np
import pytest
import torch

from vinet_tpu_torch.ops import saliency_head

torch.set_num_threads(2)


def _head_args(b, kt, h, w, bias, seed=0):
    """Port-layout head inputs: z (B, 32, kt, H, W), conv6 (32, 32, kt, 1, 1),
    b6 (32,) or None, conv7 (1, 32, 1, 1, 1), b7 (1,), all f32 on the CPU."""
    rng = np.random.default_rng(seed)
    z = np.maximum(rng.standard_normal((b, 32, kt, h, w)), 0).astype(np.float32)
    w6 = (rng.standard_normal((32, 32, kt, 1, 1)) * 0.1).astype(np.float32)
    b6 = (rng.standard_normal(32) * 0.1).astype(np.float32) if bias else None
    w7 = (rng.standard_normal((1, 32, 1, 1, 1)) * 0.3).astype(np.float32)
    b7 = np.asarray([0.1], np.float32)
    return tuple(None if a is None else torch.from_numpy(a) for a in (z, w6, b6, w7, b7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_head_cuda_entry_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        saliency_head.saliency_head_cuda(*_head_args(1, 2, 8, 8, False))


def test_head_on_cpu_takes_the_plain_version_and_counts_no_launch():
    args = _head_args(2, 2, 5, 7, True)
    before = saliency_head.launches
    got = saliency_head.saliency_head(*args)
    assert saliency_head.launches == before
    torch.testing.assert_close(got, saliency_head.saliency_head_plain(*args), rtol=0, atol=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 7)


def _bad(case):
    z, w6, b6, w7, b7 = _head_args(1, 2, 4, 6, True)
    if case == "dtype":
        z = z.half()
    elif case == "layout":
        z = z.transpose(3, 4)  # not contiguous NCDHW
    elif case == "channels":
        z, w6 = z[:, :16].contiguous(), w6[:16, :16].contiguous()
    elif case == "kt":
        z = torch.zeros((1, 32, saliency_head.MAX_KT + 1, 4, 6))
    elif case == "w6":
        w6 = w6[:, :, :1].contiguous()
    elif case == "b6":
        b6 = b6[:16]
    elif case == "w7":
        w7 = torch.zeros((1, 16, 1, 1, 1))
    elif case == "device":
        w6 = w6.to("meta")
    return z, w6, b6, w7, b7


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("layout", ValueError), ("channels", ValueError),
    ("kt", ValueError), ("w6", ValueError), ("b6", ValueError), ("w7", ValueError),
    ("device", ValueError),
])
def test_head_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    with pytest.raises(error):
        saliency_head._check(*_bad(case))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt,h,w,bias", [(2, 32, 48, False), (3, 13, 21, True),
                                         (2, 224, 384, False)])
def test_head_kernel_matches_plain_on_card(cuda, dtype, kt, h, w, bias):
    """Both versions read the same values and accumulate in f32: 1e-5."""
    z, w6, b6, w7, b7 = (None if a is None else a.to(cuda)
                         for a in _head_args(3, kt, h, w, bias))
    z = z.to(dtype)
    before = saliency_head.launches
    got = saliency_head.saliency_head(z, w6, b6, w7, b7)
    torch.cuda.synchronize()
    assert saliency_head.launches == before + 1
    want = saliency_head.saliency_head_plain(z, w6, b6, w7, b7)
    assert saliency_head.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
