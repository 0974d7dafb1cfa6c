"""Point Transformer V3 on the card: kernels 2 and 3 at the xCPE's widest
shape (Cin = Cout = 512, Cout split into two 256-wide blocks) against the
plain conv and the SIMT kernel, the bf16 conv's autograd at 512, and the
small PTv3 (tests/test_torch_port_ptv3.py) on the card against the CPU, its
attention on the flash kernel."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rule(gen, v, present):
    rule = torch.randint(0, v, (27, v), generator=gen, dtype=torch.int32)
    rule[torch.rand(27, v, generator=gen) > present] = -1
    return rule


@pytest.mark.parametrize("v", [136, 8300, 70000])
def test_conv_512_wgmma_matches_plain_and_simt(cuda, v):
    """Kernel 2 at 512 -> 512 (bf16, two 256-wide Cout blocks) and its dx:
    2e-2 of the output's max magnitude against the plain conv and the
    SIMT kernel; two launches the same bits."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv as plain
    from treelearn_tpu_torch.ops.subm_conv import (conv_plan, mirrored,
                                                   subm_conv, subm_conv_dx,
                                                   subm_conv_simt)

    plan = conv_plan(512, 512, v)
    assert plan.route == "wgmma" and plan.bn * plan.n_splits == 512
    gen = torch.Generator().manual_seed(v)
    x = torch.randn(v, 512, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(27, 512, 512, generator=gen) * 0.05).to(
        cuda, torch.bfloat16)
    rule = _rule(gen, v, 0.4).to(cuda)
    before = dict(_cuda.LAUNCHES)
    got = subm_conv(x, w, rule)
    again = subm_conv(x, w, rule)
    dx = subm_conv_dx(x, w, rule)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["subm_conv_wgmma"] == before["subm_conv_wgmma"] + 3
    assert _cuda.LAUNCHES["subm_conv"] == before["subm_conv"]
    assert torch.equal(got, again)
    want = plain(x, w, rule).float()
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2e-2 * scale
    simt = subm_conv_simt(x, w, rule).float()
    assert float((simt - want).abs().max()) <= 2e-2 * scale
    want_dx = plain(x, mirrored(w), rule).float()
    assert float((dx.float() - want_dx).abs().max()) <= 2e-2 * float(
        want_dx.abs().max())


@pytest.mark.parametrize("v", [1000, 70000])
def test_dw_512_wgmma_matches_plain_and_simt(cuda, v):
    """Kernel 3's dW at 512 x 512 x 27 on the tensor cores: 1e-3 of max
    |dW| against the plain dW and the SIMT kernel; the same bits twice."""
    from treelearn_tpu_torch.ops import _cuda
    from treelearn_tpu_torch.ops.sparse import subm_conv_dw as plain
    from treelearn_tpu_torch.ops.subm_conv import (dw_plan, subm_conv_dw,
                                                   subm_conv_dw_simt)

    assert dw_plan(512, 512, v).route == "wgmma"
    gen = torch.Generator().manual_seed(v + 1)
    x = torch.randn(v, 512, generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn(v, 512, generator=gen).to(cuda, torch.bfloat16)
    rule = _rule(gen, v, 0.4).to(cuda)
    before = dict(_cuda.LAUNCHES)
    got = subm_conv_dw(x, g, rule)
    again = subm_conv_dw(x, g, rule)
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["subm_conv_dw_wgmma"]
            == before["subm_conv_dw_wgmma"] + 2)
    assert torch.equal(got, again)
    want = plain(x, g, rule)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale
    simt = subm_conv_dw_simt(x, g, rule)
    assert float((simt - want).abs().max()) <= 1e-3 * scale


def _small_pass(device, dtype, seed=3):
    import test_torch_port_ptv3 as small

    torch.manual_seed(0)
    model = small._model(seed).to(device)
    model.train()
    model.ptv3.record_draws = True
    b = {k: v.to(device) for k, v in small._batch().items()}
    out = model(b["coords"], b["input_feats"], b["batch_ids"], b["valid"],
                batch_size=2, compute_dtype=dtype)
    return model, b, out


def test_small_ptv3_on_card_matches_reference(cuda):
    """The small PTv3's training forward on the card in float32 (convs on
    3xTF32, attention on the memory-efficient kernel) and in bf16 (flash,
    the bf16 wgmma convs), against the float32 reference on the card's own
    draws: 1e-3 and 5e-2 of the outputs' norm."""
    import reference_ptv3 as ref
    from treelearn_tpu_torch.ops import _cuda

    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        before = dict(_cuda.LAUNCHES)
        model, b, out = _small_pass(cuda, dtype)
        assert _cuda.LAUNCHES["subm_conv"] == before["subm_conv"]
        params = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        import test_torch_port_ptv3 as small

        f = ref.Forward(params, small.SMALL, model.ptv3.draws, True)
        sem, off = f(b["coords"], b["batch_ids"], b["valid"], 2, small.VOXEL)
        v = b["valid"]
        for got, want in ((out["semantic_prediction_logits"], sem),
                          (out["offset_predictions"], off)):
            gap = float((got[v] - want[v]).norm() / want[v].norm())
            assert gap < tol, (dtype, gap)


def test_attention_runs_on_flash(cuda):
    """bf16 attention launches a flash kernel and nothing of the math
    path; a shape flash cannot take raises instead of falling back."""
    from torch.profiler import ProfilerActivity, profile

    from treelearn_tpu_torch.model.ptv3 import attention

    q, k, v = (torch.randn(8, 4, 1024, 16, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention(q, k, v, 0.25)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("flash" in n.lower() for n in names), names[:20]
    bad = torch.randn(2, 1, 64, 512, device=cuda,
                      dtype=torch.bfloat16)    # head dim past flash's 256
    with pytest.raises(RuntimeError):
        attention(bad, bad, bad, 0.25)
