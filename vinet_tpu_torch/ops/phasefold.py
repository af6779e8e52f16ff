"""Phase-folded "conv after 2x upsample": conv3d(upsample2x_hw(x), w) without
forming the upsampled tensor, ``vinet_tpu/ops/phasefold.py`` in NCDHW.

With the fixed 2-tap trilinear stencil of ``ops/upsample.py``

    u[2i]   = 0.25 a[i-1] + 0.75 a[i]        (a[-1] clamped to a[0])
    u[2i+1] = 0.75 a[i]   + 0.25 a[i+1]      (a[H]  clamped to a[H-1])

a 3-tap conv over u restricted to output phase p is a 3-tap conv over a,
``y[2i+p] = sum_m a[i+m-1] c_p[m]`` with ``c_p[m] = sum_d A[p, m, d] w[d]``.
Folding both spatial axes turns conv(up(x), w) into one conv at the coarse
grid with 4·Cout output channels, ordered (ph, pw, cout), and a depth-to-space
interleave. The clamp is the edge padding of the coarse input (the folded
conv runs VALID in H and W); where the true conv zero-pads the outermost fine
row or column, the folded pass read the upsample's extrapolated sample, and
1-D corrections over the border rows and columns subtract that in f32.

Port weights are ``(Cout, Cin, kt, 3, 3)``. The folded conv runs in x's dtype
with its bias folded in (cuDNN accumulates a bf16 convolution in f32 and
rounds its output once); the corrections are f32 and land on the 1-pixel
border strips of the coarse result, which are rounded again.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# A[p, m, d]: coefficient of fine tap d (at u[2i+p+d-1]) on coarse input
# a[i+m-1] for output phase p (interior formula).
_FOLD_A = np.array(
    [
        [[0.75, 0.25, 0.0], [0.25, 0.75, 0.75], [0.0, 0.0, 0.25]],
        [[0.25, 0.0, 0.0], [0.75, 0.75, 0.25], [0.0, 0.25, 0.75]],
    ],
    dtype=np.float32,
)  # (2, 3, 3)

# S[p, m]: the upsample as a 3-tap VALID conv over the edge-padded coarse
# input: up2x(a)[2i+p] = sum_m edgepad(a)[i+m] S[p, m].
_UP_S = np.array([[0.25, 0.75, 0.0], [0.0, 0.75, 0.25]], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _fold_a(device: torch.device) -> torch.Tensor:
    """A on a device, copied there once: a copy from host memory would make
    every fold wait for the work queued on the card."""
    return torch.from_numpy(_FOLD_A).to(device)


def fold_weights_up2x(w: torch.Tensor) -> torch.Tensor:
    """w (Cout, Cin, kt, 3, 3) -> folded (4·Cout, Cin, kt, 3, 3) f32, output
    channels ordered (ph, pw, cout) as ``_depth_to_space`` reads them."""
    a = _fold_a(w.device)
    wf = torch.einsum("hmd,wne,oitde->hwoitmn", a, a, w.float())
    cout, cin, kt = w.shape[:3]
    return wf.reshape(4 * cout, cin, kt, 3, 3)


def _depth_to_space(z: torch.Tensor, cout: int) -> torch.Tensor:
    """(B, 4·Cout, T, H, W) with channels (ph, pw, c) -> (B, Cout, T, 2H, 2W)."""
    b, _, t, h, w = z.shape
    z = z.reshape(b, 2, 2, cout, t, h, w).permute(0, 3, 4, 5, 1, 6, 2)
    return z.reshape(b, cout, t, 2 * h, 2 * w)


def _fold_1d(w1: torch.Tensor) -> torch.Tensor:
    """w1 (Cout, Cin, kt, 3), taps over a 2x-upsampled row -> (2·Cout, Cin,
    kt, 1, 3) f32 over the coarse row, output channels ordered (p, cout)."""
    cout, cin, kt = w1.shape[:3]
    wf = torch.einsum("pmd,oitd->poitm", _fold_a(w1.device), w1.float())
    return wf.reshape(2 * cout, cin, kt, 1, 3)


def _up1d_conv(arow: torch.Tensor, w1f: torch.Tensor, ends, stride_t: int,
               pad_t: int) -> torch.Tensor:
    """Exact 1-D conv-after-up2x along the last axis, in f32.

    arow (B, Cin, T, L); w1f = _fold_1d(w1). With ends, the f32 (Cout, Cin,
    kt) taps 0 and 2 of w1, the two fine endpoints take the conv's zero
    padding; without, they keep the upsample's extrapolated sample, which is
    what the 2-D folded pass read. Returns (B, Cout, T', 2L).
    """
    ap = F.pad(arow.float()[:, :, :, None], (1, 1, 0, 0, 0, 0), mode="replicate")
    z = F.conv3d(ap, w1f, stride=(stride_t, 1, 1), padding=(pad_t, 0, 0))
    b, c2, tt, _, length = z.shape  # (B, 2·Cout, T', 1, L), channels (p, cout)
    c = c2 // 2
    y = z.reshape(b, 2, c, tt, length).permute(0, 2, 3, 4, 1).reshape(b, c, tt, 2 * length)
    if ends is not None:
        for fine, coarse, tap in ((0, 0, ends[0]), (-1, -1, ends[1])):
            y[..., fine] -= F.conv1d(arow[..., coarse].float(), tap, stride=stride_t,
                                     padding=pad_t)
    return y


def phase_up2x(z: torch.Tensor) -> torch.Tensor:
    """The exact 2x upsample in phase layout: (B, C, T, H, W) -> (B, 4·C, T,
    H, W) with channels (ph·2 + pw, c) equal to upsample2x_hw(z)[:, c, :,
    2i+ph, 2j+pw]. A permutation of the fine grid."""
    zp = F.pad(z, (1, 1, 1, 1, 0, 0), mode="replicate")
    zc = zp[..., 1:-1, 1:-1]
    h0 = 0.25 * zp[..., :-2, 1:-1] + 0.75 * zc
    h1 = 0.75 * zc + 0.25 * zp[..., 2:, 1:-1]

    def wtap(a):
        ap = F.pad(a, (1, 1, 0, 0, 0, 0), mode="replicate")
        return 0.25 * ap[..., :-2] + 0.75 * a, 0.75 * a + 0.25 * ap[..., 2:]

    u00, u01 = wtap(h0)
    u10, u11 = wtap(h1)
    return torch.cat([u00, u01, u10, u11], dim=1).to(z.dtype)


def up_stencil() -> np.ndarray:
    """S (2, 3): the 2x upsample as a 3-tap VALID conv over the edge-padded
    coarse input, up2x(a)[2i+p] = sum_m edgepad(a)[i+m] S[p, m]."""
    return _UP_S.copy()


def _sub_f32(z: torch.Tensor, index: tuple, corr: torch.Tensor) -> None:
    """z[index] -= corr, computed in f32 and rounded once to z's dtype."""
    z[index] = (z[index].float() - corr).to(z.dtype)


class FoldedConvUp2x:
    """A (kt, 3, 3) conv after a 2x upsample, its weights folded once:
    calling it on x gives F.conv3d(upsample2x_hw(x), w, bias, stride=
    (stride_t, 1, 1), padding=(pad_t, 1, 1)), computed at the coarse grid.

    w (Cout, Cin, kt, 3, 3). The folded weights keep w's dtype; the border
    corrections' weights are f32."""

    def __init__(self, w: torch.Tensor, bias: torch.Tensor | None = None):
        self.cout = w.shape[0]
        self.wf = fold_weights_up2x(w).to(w.dtype)
        self.b4 = None if bias is None else bias.repeat(4)
        w32 = w.float()
        # rows take every kh 0 / kh 2 tap of the outermost fine rows (the 2-D
        # pass read extrapolated corners too); columns the kw 0 / kw 2 taps
        # left, their end taps already counted by the rows
        self.rows = (_fold_1d(w32[..., 0, :]), _fold_1d(w32[..., 2, :]))
        self.cols = (_fold_1d(w32[..., :, 0]), _fold_1d(w32[..., :, 2]))
        self.col_ends = tuple((w32[..., 0, j].contiguous(), w32[..., 2, j].contiguous())
                              for j in (0, 2))

    def __call__(self, x: torch.Tensor, *, stride_t: int = 1, pad_t: int = 0) -> torch.Tensor:
        """x (B, Cin, T, H, W) -> (B, Cout, T', 2H, 2W) in x's dtype."""
        c = self.cout
        b4 = None if self.b4 is None else self.b4.to(x.dtype)
        ap = F.pad(x, (1, 1, 1, 1, 0, 0), mode="replicate")
        z = F.conv3d(ap, self.wf.to(x.dtype), b4, stride=(stride_t, 1, 1),
                     padding=(pad_t, 0, 0))
        b, _, tt, h, wd = z.shape

        # Border corrections on the coarse phase-major z: fine row 0 is (h 0,
        # ph 0), channels [0, 2C) ordered (pw, c); fine column 0 is (w 0, pw
        # 0), channels [0, C) for ph 0 and [2C, 3C) for ph 1; the far edges
        # likewise.
        def rows(r):  # (B, C, T', 2W) -> (B, 2C, T', W), channels (pw, c)
            return r.reshape(b, c, tt, wd, 2).permute(0, 4, 1, 2, 3).reshape(b, 2 * c, tt, wd)

        for ch, hi, arow, wr in ((0, 0, x[:, :, :, 0], self.rows[0]),
                                 (2 * c, h - 1, x[:, :, :, -1], self.rows[1])):
            corr = rows(_up1d_conv(arow, wr, None, stride_t, pad_t))
            _sub_f32(z, (slice(None), slice(ch, ch + 2 * c), slice(None), hi), corr)
        for chs, wi, acol, wc, ends in (((0, 2 * c), 0, x[..., 0], self.cols[0], self.col_ends[0]),
                                        ((c, 3 * c), wd - 1, x[..., -1], self.cols[1],
                                         self.col_ends[1])):
            corr = _up1d_conv(acol, wc, ends, stride_t, pad_t).reshape(b, c, tt, h, 2)
            for ph, ch in enumerate(chs):  # (B, C, T', H) of fine rows 2h + ph
                _sub_f32(z, (slice(None), slice(ch, ch + c), slice(None), slice(None), wi),
                         corr[..., ph])
        return _depth_to_space(z, c)


def conv_after_up2x(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
                    stride_t: int = 1, pad_t: int = 0) -> torch.Tensor:
    """Exactly F.conv3d(upsample2x_hw(x), w, bias, stride=(stride_t, 1, 1),
    padding=(pad_t, 1, 1)), computed at the coarse grid; folds w on each
    call (``FoldedConvUp2x`` folds once).

    x (B, Cin, T, H, W); w (Cout, Cin, kt, 3, 3). Returns (B, Cout, T', 2H,
    2W) in x's dtype."""
    return FoldedConvUp2x(w, bias)(x, stride_t=stride_t, pad_t=pad_t)
