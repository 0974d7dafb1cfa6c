"""Submanifold sparse conv — kernel 2 of the port (the hottest one) — its
weight gradient — kernel 3 — and the autograd function over both.

Replaces the Pallas kernel ``subm_conv_banded`` (``_subm_kernel`` +
``_gather_bands``, treelearn_tpu/ops/pallas_conv.py:355,304,181).  The TPU
kernel reaches its neighbors through banded DMA windows of the sorted
features and one-hot MXU selects, with a span-overflow fallback; a GPU
gathers rows cheaply, so csrc/subm_conv.cu is a plain gather-GEMM over the
(27, V) rule from ops/rulebook.py: a block owns 64 output voxels x 64 output
channels, stages each offset's gathered rows and weight slice in shared
memory and accumulates in float32 registers.  No windows, so nothing can
overflow.

Kernel 3 replaces ``rule_conv_dw_banded`` (``_dw_kernel``,
pallas_conv.py:438,415): csrc/subm_conv_dw.cu sums per-chunk partial
weight gradients and adds the chunks in a second pass, so dW is
deterministic (see the source for why not atomics).

:class:`SubmConvFn` is the counterpart of ``rule_conv_ad``
(pallas_conv.py:588-649): forward kernel 2; backward dx = kernel 2 on the
output gradient with weights ``W.flip(0).transpose(1, 2)`` over the same
rule (a submanifold rule is its own transpose under offset mirroring, and
``kernel_offsets`` is ordered so that ``flip(0)`` mirrors); dW = kernel 3.

Bound on the card, both kernels: operations (2 x Cin x Cout FLOPs per rule
entry, against Cin + Cout values moved per voxel); this first version runs
on the float32 SIMT units.
"""

from __future__ import annotations

import torch

from . import _cuda
from .sparse import subm_conv as subm_conv_plain
from .sparse import subm_conv_dw as subm_conv_dw_plain

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


DW_PARTIAL_BYTES = 64 << 20   # cap on kernel 3's per-chunk partials
DW_TARGET_BLOCKS = 2048       # blocks in flight kernel 3 aims for


def dw_chunks(v: int, cin: int, cout: int) -> int:
    """Row chunks of kernel 3: enough blocks to fill the card, at least 256
    rows a chunk, partials under ``DW_PARTIAL_BYTES``."""
    tiles = -(-cin // 64) * -(-cout // 64)
    want = -(-DW_TARGET_BLOCKS // (27 * tiles))
    by_mem = max(1, DW_PARTIAL_BYTES // (27 * cin * cout * 4))
    return max(1, min(want, -(-v // 256), by_mem))


def subm_conv_dw(x: torch.Tensor, g: torch.Tensor,
                 rule: torch.Tensor) -> torch.Tensor:
    """x (V, Cin), g (V, Cout) in one working type, rule (27, V) int32 ->
    (27, Cin, Cout) float32 weight gradient.  CPU tensors take the plain
    version (ops/sparse.py:subm_conv_dw); CUDA tensors launch kernel 3."""
    if not x.is_cuda:
        return subm_conv_dw_plain(x, g, rule)
    _cuda.require(x, "subm_conv_dw x", _DTYPES, 2)
    _cuda.require(g, "subm_conv_dw g", x.dtype, 2)
    _cuda.require(rule, "subm_conv_dw rule", torch.int32, 2)
    v, cin = x.shape
    cout = g.shape[1]
    if rule.shape != (27, v) or g.shape[0] != v:
        raise ValueError(f"subm_conv_dw: shapes x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)}, rule {tuple(rule.shape)}")
    dw = torch.empty((27, cin, cout), dtype=torch.float32, device=x.device)
    if v == 0:
        return dw.zero_()
    n_chunks = dw_chunks(v, cin, cout)
    partial = torch.empty((n_chunks, 27, cin, cout), dtype=torch.float32,
                          device=x.device)
    _cuda.record("subm_conv_dw", x=x, g=g, rule=rule)
    lib = _cuda.library()
    fn = (lib.tl_subm_conv_dw_f32 if x.dtype == torch.float32
          else lib.tl_subm_conv_dw_bf16)
    code = fn(x.data_ptr(), g.data_ptr(), rule.data_ptr(), partial.data_ptr(),
              dw.data_ptr(), v, cin, cout, n_chunks, _cuda.stream_ptr(x))
    _cuda.check(code, "tl_subm_conv_dw")
    _cuda.LAUNCHES["subm_conv_dw"] += 1
    return dw


def mirrored(weight: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) -> (27, Cout, Cin): the weights whose conv over the
    same submanifold rule is the transpose of ``weight``'s."""
    return weight.flip(0).transpose(1, 2).contiguous()


class SubmConvFn(torch.autograd.Function):
    """Differentiable submanifold conv.  ``weight`` is the float32 master
    copy; it is cast to the working type of ``feats`` inside, and its
    gradient comes back in float32."""

    @staticmethod
    def forward(ctx, feats, weight, rule):
        w = weight.to(feats.dtype)
        ctx.save_for_backward(feats, w, rule)
        return subm_conv(feats, w, rule)

    @staticmethod
    def backward(ctx, grad):
        feats, w, rule = ctx.saved_tensors
        grad = grad.to(feats.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            _cuda.record("subm_conv_dx", g=grad, weight=w, rule=rule)
            dx = subm_conv(grad, mirrored(w), rule)
        if ctx.needs_input_grad[1]:
            dw = subm_conv_dw(feats, grad, rule)
        return dx, dw, None
