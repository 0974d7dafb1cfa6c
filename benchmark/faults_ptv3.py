"""Faults planted in the program's PTv3 backbone (model/ptv3.py), for the
readings that set the upper ends of the ``train_ptv3_crops_35m`` limits
(``benchmark/control_ptv3.py --fault``) and for the tests that see
``correct`` come out false (``benchmark/tests/test_bench_ptv3.py``).  The
benchmark's own runs never plant one.  Each takes ``setattr``-like
``patch(obj, name, value)``.
"""

from __future__ import annotations


def attn_no_pad_keys(patch):
    """Serialized attention without the pad rows as keys: each patch's
    queries see only its element's own rows (the pad rows, which repeat
    the previous patch's, are masked out)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from treelearn_tpu_torch.model import ptv3

    def forward(self, x, stage, dtype):
        n, c = x.shape
        h, d = self.heads, c // self.heads
        lay = stage.layout(self.patch_size)
        g_in, g_out = stage.gathers(self.patch_size,
                                    self.order_index % len(stage.names))
        real = torch.zeros(lay.n_pad, dtype=torch.bool, device=x.device)
        real[lay.unpad] = True
        mask = real.view(-1, 1, 1, lay.k)
        qkv = ptv3.linear(x, self.qkv, dtype)[g_in]
        q, k, v = qkv.view(lay.n_pad // lay.k, lay.k, 3, h, d).permute(
            2, 0, 3, 1, 4).unbind(0)
        backend = (SDPBackend.EFFICIENT_ATTENTION if q.is_cuda
                   else SDPBackend.MATH)
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=self.scale)
        o = o.transpose(1, 2).reshape(lay.n_pad, c)[g_out]
        return ptv3.linear(o, self.proj, dtype)

    patch(ptv3.SerializedAttention, "forward", forward)


class _RoundedLinear:
    """A linear's weight rounded by ``round_to``, its bias as it is."""

    def __init__(self, m, round_to):
        self.weight = round_to(m.weight)
        self.bias = m.bias


def fp16_operands(patch):
    """The backbone's linears and attention computed in float16 in place
    of bf16 (their outputs cast back to the working type)."""
    import torch

    from treelearn_tpu_torch.model import ptv3

    lin, att = ptv3.linear, ptv3.attention
    patch(ptv3, "linear",
          lambda x, m, dtype: lin(x, m, torch.float16).to(dtype))
    patch(ptv3, "attention", lambda q, k, v, scale: att(
        q.half(), k.half(), v.half(), scale).to(q.dtype))


def fp8_operands(patch):
    """The backbone's linears and attention on float8 e4m3 operands (one
    scale a tensor; gradients pass straight through), then computed as
    the configuration states."""
    import torch

    from treelearn_tpu_torch.model import ptv3

    def round8(t, dtype=torch.float8_e4m3fn):
        amax = t.detach().abs().max().float()
        scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                            torch.ones_like(amax))
        q = ((t.detach().float() / scale).to(dtype).float() * scale).to(
            t.dtype)
        return t + (q - t).detach()

    lin, att = ptv3.linear, ptv3.attention
    patch(ptv3, "linear", lambda x, m, dtype: lin(
        round8(x), _RoundedLinear(m, round8), dtype))
    patch(ptv3, "attention", lambda q, k, v, scale: att(
        round8(q), round8(k), round8(v), scale))


def skip_xcpe(patch):
    """The blocks' xCPE left out: x passes the conditional positional
    encoding unchanged."""
    from treelearn_tpu_torch.model import ptv3

    patch(ptv3.XCPE, "forward",
          lambda self, x, stage, dtype: x.new_zeros(()))


FAULTS = {f.__name__: f for f in (attn_no_pad_keys, fp16_operands,
                                  fp8_operands, skip_xcpe)}
