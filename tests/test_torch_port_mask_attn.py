"""The packed attention mask and the plain masked cross-attention of
``ops/mask_attn.py`` (the CPU side of ``csrc/mask_attn.cu``) against
SPFormer's mask set (``model/spformer.py:closed_mask``) and against the
decoder's CPU route, SDPA's math backend under ``mask_bias``, in float32.

Tolerances: the plain version and SDPA's math backend compute the same
float32 softmax with other orders of summation (~1e-7 relative); 1e-5
leaves a margin of 100 while one mask entry moves a row by 1e-2 or
more."""

import numpy as np
import pytest
import torch

from treelearn_tpu_torch.model.spformer import attention, closed_mask, mask_bias
from treelearn_tpu_torch.ops.mask_attn import (MaskBits, mask_attention,
                                               mask_attention_plain, mask_pack,
                                               mask_pack_plain, unpack_closed,
                                               unpack_open, words_of)

torch.set_num_threads(1)


def _logits(q, k, seed=0, closed_rows=(1,)):
    """Mask logits with exact zeros, negative zeros, NaNs and, in
    ``closed_rows``, rows with every entry negative."""
    g = np.random.default_rng(seed)
    p = g.normal(size=(q, k)).astype(np.float32)
    flat = p.reshape(-1)
    pick = g.choice(flat.size, size=min(flat.size, 3 * max(1, flat.size // 50)),
                    replace=False)
    third = len(pick) // 3
    flat[pick[:third]] = 0.0
    flat[pick[third:2 * third]] = -0.0
    flat[pick[2 * third:]] = np.nan
    for r in closed_rows:
        if r < q:
            p[r] = -g.uniform(0.1, 2.0, size=k)
    return torch.from_numpy(p)


def _tiles_recount(closed):
    q, k = closed.shape
    out = np.zeros((-(-q // 64), -(-k // 64)), np.uint8)
    o = (~closed).numpy()
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            out[i, j] = o[64 * i:64 * (i + 1), 64 * j:64 * (j + 1)].any()
    return out


@pytest.mark.parametrize("q,k", [(1, 1), (5, 31), (5, 33), (70, 100),
                                 (65, 130), (3, 257), (130, 64), (64, 129)])
def test_plain_pack_is_closed_mask_set(q, k):
    """Exactly ``closed_mask``'s set (open at 0, -0.0 and NaN, all-closed
    rows opened), the rows that were all closed, the tiles with an open
    pair, the counts, and zero bits past K."""
    p = _logits(q, k, seed=q * 1000 + k)
    m = mask_pack_plain(p)
    want = closed_mask(p)
    assert m.keys == k and m.bits.dtype == torch.int32
    assert tuple(m.bits.shape) == (q, words_of(k)) and words_of(k) % 4 == 0
    assert torch.equal(unpack_closed(m), want)
    assert torch.equal(m.row_closed, (p < 0).all(-1))
    zero = (p == 0) | torch.isnan(p)
    assert not want[zero & ~(p < 0).all(-1, keepdim=True)].any()
    assert torch.equal(m.tiles, torch.from_numpy(_tiles_recount(want)))
    assert m.stats.tolist() == [int((~want).sum()),
                                int((m.tiles == 0).sum()), m.tiles.numel()]
    every = ((m.bits[..., None] >> torch.arange(32, dtype=torch.int32)) & 1)
    assert not every.reshape(q, -1)[:, k:].any()
    assert torch.equal(unpack_open(m), ~want)


def test_pack_routes_by_device():
    p = _logits(4, 40)
    m = mask_pack(p)
    assert isinstance(m, MaskBits)
    assert torch.equal(m.bits, mask_pack_plain(p).bits)


def _problem(ks=(100, 37), nq=20, heads=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = heads * 32
    q = torch.randn(len(ks), nq, d, generator=g)
    kv = torch.randn(sum(ks), 2 * d, generator=g)
    ranges, s = [], 0
    for k in ks:
        ranges.append((s, s + k))
        s += k
    masks = [mask_pack_plain(_logits(nq, k, seed=seed + i,
                                     closed_rows=(1, nq - 1)))
             for i, k in enumerate(ks)]
    return q, kv, masks, ranges, heads, 32 ** -0.5


def _sdpa_route(q, kv, masks, ranges, heads, scale):
    """The decoder's CPU route: per element, SDPA's math backend under the
    additive mask of the closed set."""
    d = q.shape[-1]
    outs = []
    for b, (s, e) in enumerate(ranges):
        def h(x):
            return x.view(1, x.shape[0], heads, -1).transpose(1, 2)
        o = attention(h(q[b]), h(kv[s:e, :d]), h(kv[s:e, d:]),
                      mask_bias(unpack_closed(masks[b]), torch.float32),
                      scale)
        outs.append(o.transpose(1, 2).reshape(q.shape[1], -1))
    return torch.stack(outs)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("ks,nq,heads", [((100, 37), 20, 2), ((1, 33), 5, 1),
                                         ((129, 64), 70, 2), ((31,), 3, 4)])
def test_plain_attention_equals_sdpa_route(ks, nq, heads):
    """Forward and dq / dk / dv of the plain version from the bits equal
    the math route's under ``mask_bias``."""
    q, kv, masks, ranges, heads, scale = _problem(ks, nq, heads)
    grad = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    got, want = [], []
    for fn, sink in ((mask_attention_plain, got), (_sdpa_route, want)):
        qq, kk = q.clone().requires_grad_(True), kv.clone().requires_grad_(True)
        o = fn(qq, kk, masks, ranges, heads, scale)
        o.backward(grad)
        sink += [o.detach(), qq.grad, kk.grad]
    for a, b, what in zip(got, want, ("out", "dq", "dkv")):
        assert _rel(a, b) < 1e-5, what
    # an all-closed row attends to every key of its element
    d = q.shape[-1]
    b, row = 0, 1
    s, e = ranges[b]
    qh = q[b, row].view(heads, -1)
    k = kv[s:e, :d].view(-1, heads, 32)
    v = kv[s:e, d:].view(k.shape)
    w = torch.softmax(torch.einsum("hc,khc->hk", qh, k) * scale, -1)
    full = torch.einsum("hk,khc->hc", w, v).reshape(-1)
    assert _rel(got[0][b, row], full) < 1e-5


def test_elements_never_see_each_others_keys():
    """Changing the second element's keys and values moves nothing of the
    first element's output or gradients."""
    q, kv, masks, ranges, heads, scale = _problem()
    s, e = ranges[1]
    kv2 = kv.clone()
    kv2[s:e] = kv2[s:e] * 3.0 + 1.0
    res = []
    for k in (kv, kv2):
        qq, kk = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
        o = mask_attention_plain(qq, kk, masks, ranges, heads, scale)
        o[0].sum().backward()
        res.append((o[0].detach(), qq.grad[0], kk.grad[:ranges[0][1]]))
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_kernel_route_refuses_cpu_tensors():
    q, kv, masks, ranges, heads, scale = _problem()
    with pytest.raises(ValueError, match="CUDA"):
        mask_attention(q, kv, masks, ranges, heads, scale)
