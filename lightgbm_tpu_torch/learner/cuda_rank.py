"""The lambdarank kernel's wrapper (csrc/lambdarank.cu).

Built and loaded with the other kernels (cuda_hist.build / load: one
library from csrc/, at first use). The kernel replaces no pallas_call:
its counterpart is the XLA code of the JAX package's
learner/ranking.py lambdarank_gradients, whose plain torch version is
ranking.lambdarank_plain. A call launches one block a query and the
blocks that write the padding rows, on torch's current stream, and adds
one to cuda_hist.LAUNCHES["lambdarank"]. Nothing here runs at import.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cuda_hist
from .cuda_hist import _MAX_SMEM, _SMEM_STATIC, _check, _need, _stream

RANK_THREADS = 256  # kRankThreads


def lambdarank_plan(max_docs: int, num_docs: int, npad: int) -> dict:
    """The launch from the shapes alone: one block of RANK_THREADS a
    query, each holding the largest query's documents in shared memory
    (scores and labels in document and in sorted order, ranks: 20 bytes a
    document) beside the norm's reduction; the padding rows' blocks.
    Raises ValueError naming the limit when the largest query does not
    fit a block's shared memory."""
    cap = max(1, int(max_docs))
    smem = 4 * (5 * cap + RANK_THREADS)
    room = _MAX_SMEM - _SMEM_STATIC
    if smem > room:
        limit = (room // 4 - RANK_THREADS) // 5
        raise ValueError(
            f"lambdarank: a query of {max_docs} documents exceeds the "
            f"kernel limit of {limit} documents a query (a block's shared "
            f"memory holds 20 bytes a document; {room} bytes)")
    pad_rows = int(npad) - int(num_docs)
    return dict(cap=cap, smem=smem, pad_blocks=-(-pad_rows // RANK_THREADS))


def lambdarank(layout, score: torch.Tensor, label: torch.Tensor,
               label_gain: torch.Tensor, inv_max_dcg: torch.Tensor,
               sigmoid: float, truncation_level: int, norm: bool,
               weight: Optional[torch.Tensor] = None,
               hess_floor: bool = True):
    """(grad, hess) (npad,) f32 on the card: ranking.lambdarank_plain's
    function, one kernel launch."""
    _need(score, "score", torch.float32, 1)
    _need(label, "label", torch.float32, 1)
    _need(label_gain, "label_gain", torch.float32, 1)
    _need(inv_max_dcg, "inv_max_dcg", torch.float32, 1)
    if weight is not None:
        _need(weight, "weight", torch.float32, 1)
    npad = layout.npad
    if score.shape[0] != npad or label.shape[0] != npad or (
            weight is not None and weight.shape[0] != npad):
        raise ValueError(f"lambdarank: score, label and weight must have "
                         f"{npad} rows")
    if inv_max_dcg.shape[0] != layout.num_queries:
        raise ValueError("lambdarank: inv_max_dcg must have one value a "
                         "query")
    plan = lambdarank_plan(layout.max_docs, layout.num_docs, npad)
    dev = score.device
    d = layout.device(dev)
    grad = torch.empty(npad, dtype=torch.float32, device=dev)
    hess = torch.empty(npad, dtype=torch.float32, device=dev)
    sig = float(np.float32(sigmoid))
    rc = cuda_hist.load().lgbm_lambdarank(
        score.data_ptr(), label.data_ptr(), d["offsets"].data_ptr(),
        layout.num_queries, label_gain.data_ptr(), label_gain.shape[0],
        inv_max_dcg.data_ptr(), d["disc"].data_ptr(),
        None if weight is None else weight.data_ptr(), grad.data_ptr(),
        hess.data_ptr(), npad, plan["cap"], plan["pad_blocks"], sig,
        float(np.float32(-sigmoid)), float(np.float32(sigmoid * sigmoid)),
        int(truncation_level), int(bool(norm)), int(bool(hess_floor)),
        float(np.float32(2e-7)), plan["smem"], _stream(dev))
    _check(rc, "lambdarank")
    cuda_hist.LAUNCHES["lambdarank"] += 1
    return grad, hess
