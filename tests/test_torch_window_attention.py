"""Swin's window-attention core on the CPU: ``window_attention_plain``
(``openpvsg_torch/kernels/window_attention.py``), the path of CPU tensors and
of training (``WindowAttention(train=True)``), against the chain written out
inline; the module's gradients against the JAX package's; and the ``train``
flag reaching every block of the model.

Kernel B3, its CUDA path, is held to the plain version on the card in
``tests/test_torch_cuda.py``.

Tolerances: the inline chain bit for bit (the same operations in the same
order); gradients atol/rtol 1e-4 (tests/test_torch_modules.py's, float32 on
both sides).
"""
import math

import jax
import numpy as np
import pytest
import torch

MODULE_TOL = dict(atol=1e-4, rtol=1e-4)


def _inline_chain(net, x, attn_mask):
    """``WindowAttention.forward`` with its core written out inline: q.k on
    widened operands, the scale, the bias, the mask, a float32 softmax cast
    to the compute dtype, p.v, the heads concatenated, the projection."""
    nW, L, C = x.shape
    H = net.num_heads
    hd = C // H
    qkv = net.qkv(x).reshape(nW, L, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = torch.einsum("whld,whmd->whlm", q.float(), k.float()) / math.sqrt(hd)
    bias = net.rel_bias_table[net.rel_index].reshape(L, L, H).permute(2, 0, 1)
    logits = logits + bias[None].float()
    if attn_mask is not None:
        nM = attn_mask.shape[0]
        logits = (logits.reshape(nW // nM, nM, H, L, L)
                  + attn_mask[None, :, None]).reshape(nW, H, L, L)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("whlm,whmd->whld", attn, v)
    return net.proj(out.transpose(1, 2).reshape(nW, L, C))


# (window, shift, grid): two images of window-7 windows (6 each, so window w
# takes mask row w % 6), and one image of Swin-L's window 12
@pytest.mark.parametrize("window,shift,grid", [(7, 0, (14, 21)), (7, 3, (14, 21)),
                                               (12, 0, (24, 24)), (12, 6, (24, 24))])
def test_plain_core_equals_the_inline_chain(window, shift, grid):
    from openpvsg_torch.kernels import window_attention as wa
    from openpvsg_torch.models.swin import WindowAttention, shift_window_mask

    g = torch.Generator().manual_seed(window + shift)
    C, H = 64, 2
    nM = (grid[0] // window) * (grid[1] // window)
    nW = nM * (2 if window == 7 else 1)
    mask = torch.from_numpy(shift_window_mask(*grid, window, shift)) if shift else None
    launches = wa.window_attention.launches
    for dt in (torch.float32, torch.bfloat16):
        net = WindowAttention(C, H, window)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        net = net.to(dt).eval()
        x = torch.randn((nW, window * window, C), generator=g).to(dt)
        with torch.no_grad():
            got = net(x, mask)
            want = _inline_chain(net, x, mask)
        assert got.dtype == dt and torch.equal(got, want), dt
    assert wa.window_attention.launches == launches


@pytest.mark.parametrize("train", [False, True])
def test_module_gradients_match_jax(rng, train):
    """Under autograd on the CPU, built for training or not (both take the
    plain form on the CPU): the gradients of the input and of every weight
    of a shifted window-7 ``WindowAttention`` against flax's, on the same
    weights."""
    from openpvsg_tpu.models.swin import WindowAttention as JaxWA
    from openpvsg_torch.models.swin import WindowAttention, shift_window_mask
    from openpvsg_torch.weights import _convert_leaf, _flatten

    x = rng.standard_normal((12, 49, 32)).astype(np.float32)
    mask = shift_window_mask(14, 21, 7, 3)
    r = rng.standard_normal((12, 49, 32)).astype(np.float32)
    m = JaxWA(32, 2, 7)
    params = m.init(jax.random.PRNGKey(1), x, None)["params"]
    params = dict(params, rel_bias_table=rng.standard_normal(
        params["rel_bias_table"].shape).astype(np.float32))
    # JAX's mask broadcasts by window row: give it one row per window
    jmask = np.tile(mask, (2, 1, 1))

    def loss(p, xx):
        return (m.apply({"params": p}, xx, jmask) * r).sum()

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, x)
    net = WindowAttention(32, 2, 7, train=train)
    net.load_state_dict(dict(_convert_leaf(p, a) for p, a in _flatten(params)), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    (net(xt, torch.from_numpy(mask)) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **MODULE_TOL)
    want = dict(_convert_leaf(p, np.asarray(a)) for p, a in _flatten(want_p))
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **MODULE_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_train_picks_the_core_of_every_block(train):
    """``Mask2Former(train=...)`` reaches the ``WindowAttention`` of every
    Swin block: training calls the plain form on every device, serving the
    kernel's wrapper."""
    from openpvsg_torch import config as tcfg
    from openpvsg_torch.models.mask2former import Mask2Former
    from openpvsg_torch.models.swin import WindowAttention
    from test_torch_swin import _tiny

    model = Mask2Former(_tiny(tcfg), train=train)
    modes = [m.train_mode for m in model.modules() if isinstance(m, WindowAttention)]
    assert modes == [train] * 12  # Swin-T: 2 + 2 + 6 + 2 blocks
