"""Device-side EFB bundle support for the grower.

The device bin matrix holds one column per BUNDLE (bundling.py); split
finding and partitioning speak per feature. Two helpers bridge the gap
(lightgbm_tpu/learner/bundle.py):

- `expand_hist`: bundle histograms (Bt, 3, G, Bc) -> per-feature
  (Bt, 3, F, Bf) by gather, recovering each merged feature's
  most-frequent bin from the leaf totals (the reference FixHistogram,
  include/LightGBM/dataset.h:768);
- `decode_feature_bins`: bundle column values -> original bins of one
  feature (the partition's column read, tree traversal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BundleInfo(NamedTuple):
    """Bundle tables (built host-side in dataset.py)."""

    bundle_of: torch.Tensor  # (F,) int32 — device column per feature
    off_lo: torch.Tensor  # (F,) int32 — merged-range start (0 for direct)
    mfb: torch.Tensor  # (F,) int32 — excluded most-freq bin; -1 = direct
    expand_idx: torch.Tensor  # (F, Bf) int32 — flat (G*Bc) index or -1
    width: torch.Tensor  # (F,) int32 — merged-range length (num_bin - 1)


def expand_hist(hist_g: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor, binfo: BundleInfo) -> torch.Tensor:
    """(Bt, 3, G, Bc) bundle histograms -> (Bt, 3, F, Bf) per feature;
    g/h/c (Bt,) are the leaf totals: hist[f, mfb] = total - stored bins."""
    Bt = hist_g.shape[0]
    F, Bf = binfo.expand_idx.shape
    flat = hist_g.reshape(Bt, 3, -1)
    safe = torch.clamp(binfo.expand_idx, 0, flat.shape[2] - 1).reshape(-1)
    out = flat[:, :, safe.long()].reshape(Bt, 3, F, Bf)
    out = torch.where(binfo.expand_idx[None, None] >= 0, out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    totals = torch.stack([g, h, c], dim=1).to(torch.float32)  # (Bt, 3)
    missing = totals[:, :, None] - out.sum(dim=3)  # (Bt, 3, F)
    onehot = ((torch.arange(Bf, device=out.device)[None, :]
               == binfo.mfb[:, None]) & (binfo.mfb >= 0)[:, None])
    return out + onehot[None, None].to(torch.float32) * missing[..., None]


def decode_feature_bins(bcol: torch.Tensor, f: torch.Tensor,
                        binfo: BundleInfo) -> torch.Tensor:
    """Bundle-column values -> feature f's original bins (f a scalar or a
    per-row vector matching bcol)."""
    m = binfo.mfb[f]
    lo = binfo.off_lo[f]
    t = bcol - lo
    in_range = (t >= 0) & (t < binfo.width[f])
    decoded = torch.where(in_range, t + (t >= m).to(t.dtype), m)
    return torch.where(m >= 0, decoded, bcol)
