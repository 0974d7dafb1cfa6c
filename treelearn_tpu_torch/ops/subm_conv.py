"""Submanifold sparse conv — kernel 2 of the port (the hottest one).

Replaces the Pallas kernel ``subm_conv_banded`` (``_subm_kernel`` +
``_gather_bands``, treelearn_tpu/ops/pallas_conv.py:355,304,181).  The TPU
kernel reaches its neighbors through banded DMA windows of the sorted
features and one-hot MXU selects, with a span-overflow fallback; a GPU
gathers rows cheaply, so csrc/subm_conv.cu is a plain gather-GEMM over the
(27, V) rule from ops/rulebook.py: a block owns 64 output voxels x 64 output
channels, stages each offset's gathered rows and weight slice in shared
memory and accumulates in float32 registers.  No windows, so nothing can
overflow.

Bound on the card: operations (2 x Cin x Cout FLOPs per rule entry, against
Cin + Cout values moved per voxel); this first version runs on the float32
SIMT units.
"""

from __future__ import annotations

import torch

from . import _cuda
from .sparse import subm_conv as subm_conv_plain

_DTYPES = (torch.float32, torch.bfloat16)


def subm_conv(feats: torch.Tensor, weight: torch.Tensor, rule: torch.Tensor,
              n_live=None) -> torch.Tensor:
    """feats (V_in, Cin), weight (27, Cin, Cout), rule (27, V_out) int32 ->
    (V_out, Cout) in feats' dtype, float32 accumulation; rows at or past
    ``n_live`` (default V_out) are zero.  CPU tensors take the plain version
    (ops/sparse.py:subm_conv); CUDA tensors launch the kernel."""
    if not feats.is_cuda:
        return subm_conv_plain(feats, weight, rule, n_live)
    _cuda.require(feats, "subm_conv feats", _DTYPES, 2)
    w = weight.to(feats.dtype).contiguous()
    _cuda.require(w, "subm_conv weight", _DTYPES, 3)
    _cuda.require(rule, "subm_conv rule", torch.int32, 2)
    k, cin, cout = w.shape
    if k != 27 or rule.shape[0] != 27 or cin != feats.shape[1]:
        raise ValueError(f"subm_conv: shapes feats {tuple(feats.shape)}, "
                         f"weight {tuple(w.shape)}, rule {tuple(rule.shape)}")
    v_in, v_out = feats.shape[0], rule.shape[1]
    n_live = v_out if n_live is None else int(n_live)
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=feats.device)
    if v_out == 0:
        return out
    _cuda.record("subm_conv", feats=feats, weight=w, rule=rule)
    lib = _cuda.library()
    fn = (lib.tl_subm_conv_f32 if feats.dtype == torch.float32
          else lib.tl_subm_conv_bf16)
    code = fn(feats.data_ptr(), w.data_ptr(), rule.data_ptr(), out.data_ptr(),
              v_in, v_out, n_live, cin, cout, _cuda.stream_ptr(feats))
    _cuda.check(code, "tl_subm_conv")
    _cuda.LAUNCHES["subm_conv"] += 1
    return out
