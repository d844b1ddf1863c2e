"""Kernel wrappers of the port (K1 codebook lookup, K3 'same'-block stack).

This file imports no jax, so its card tests also run on a machine that has
only PyTorch and CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU:
  * a CPU tensor takes the plain version and counts no launch;
  * ``pack_stack_weights`` + a numpy transcription of the CUDA kernel's loops
    (csrc/preact_stack.cu: flat weight offsets, halo indices, wrap/zero
    handling) against the plain block, to 1e-5 in float64 vs fp32: the layout
    the kernel reads is checked here, where no card runs it.
On a card (marker ``gpu``; skipped here with the reason):
  * K1 against ``l2_argmin_plain``: equal indices wherever the two best
    codes are more than 1e-5 apart (relative), at the path's three shapes;
  * K3 against ``preact_stack_plain``: fp32 within 1e-4 of max|ref| (TF32
    off), bf16 within 3e-2 of max|ref| (both round at the same points; the
    fp32 sums run in another order, which can flip a bf16 rounding, 2^-8
    relative, and a flip carries through the following blocks).
"""
import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch.models import blocks as tblocks
from vqvae3d_tpu_torch.ops import quantizer_ops, stack_kernel


def _stack(rng, nb, c, std=0.2):
    """Random reference-layout stack weights (w1s, w2s, w3s, sc8) as torch."""
    cb = max(c // 2, 1)
    sc8 = rng.standard_normal((nb, 8)) * std
    sc8[:, 7] += 1.0
    return tuple(
        torch.from_numpy(a.astype(np.float32))
        for a in (
            rng.standard_normal((nb, cb, c, 1, 1, 1)) * std,
            rng.standard_normal((nb, cb, cb, 3, 3, 3)) * std,
            rng.standard_normal((nb, c, cb, 1, 1, 1)) * std,
            sc8,
        )
    )


def _elu(v):
    return np.where(v > 0, v, np.expm1(np.minimum(v, 0)))


def _emulate_k3_block(x, w1p, w2p, w3p, sc, cb, wrap):
    """numpy transcription of csrc/preact_stack.cu (fp32 path): x is
    channels-last (B, H, W, D, C); w*p are one block's packed weights read
    through the same flat offsets the kernels compute."""
    b, h, w, d, c = x.shape
    xv = x.reshape(-1, c).astype(np.float64)
    w1f, w2f, w3f = (np.asarray(t, np.float64).reshape(-1) for t in (w1p, w2p, w3p))
    cob1, cob2, cob3 = w1p.shape[-1], w2p.shape[-1], w3p.shape[-1]
    # pre_kernel
    a1 = _elu(xv + sc[0]) + sc[1]
    a2 = np.zeros((xv.shape[0], cb))
    for g in range(-(-cb // cob1)):
        for j in range(cob1):
            k = g * cob1 + j
            if k < cb:
                a2[:, k] = _elu(a1 @ w1f[g * c * cob1 + np.arange(c) * cob1 + j] + sc[2]) + sc[3]
    # conv_kernel
    v = np.arange(xv.shape[0])
    iid, t = v % d, v // d
    iw, t = t % w, t // w
    ih, ib = t % h, t // h
    acc = np.zeros((xv.shape[0], cb))
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                hh, ww, dd = ih + kh - 1, iw + kw - 1, iid + kd - 1
                inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w) & (dd >= 0) & (dd < d)
                src = ((ib * h + hh % h) * w + ww % w) * d + dd % d
                nbr = a2[src] * (1.0 if wrap else inside[:, None])
                tap = (kh * 3 + kw) * 3 + kd
                for g in range(-(-cb // cob2)):
                    for j in range(cob2):
                        k = g * cob2 + j
                        if k < cb:
                            idx = g * 27 * cb * cob2 + tap * cb * cob2 + np.arange(cb) * cob2 + j
                            acc[:, k] += nbr @ w2f[idx]
    a3 = _elu(acc + sc[4]) + sc[5]
    # post_kernel
    y = np.zeros_like(xv)
    for g in range(-(-c // cob3)):
        for j in range(cob3):
            co = g * cob3 + j
            if co < c:
                u = a3 @ w3f[g * cb * cob3 + np.arange(cb) * cob3 + j]
                y[:, co] = u * sc[7] + sc[6] + xv[:, co]
    return y.reshape(x.shape)


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18])
def test_k3_packed_layout_and_indexing(c, pad_mode):
    rng = np.random.default_rng(200 + c)
    x = rng.standard_normal((2, 5, 4, 3, c)).astype(np.float32)
    w1s, w2s, w3s, sc8 = _stack(rng, 2, c)
    w1p, w2p, w3p = stack_kernel.pack_stack_weights(w1s, w2s, w3s, torch.float32)
    cb = w1s.shape[1]
    assert w1p.shape[-1] == stack_kernel._cob(cb) and w3p.shape[-1] == stack_kernel._cob(c)
    got = x
    for j in range(2):
        got = _emulate_k3_block(got, w1p[j], w2p[j], w3p[j], sc8[j].numpy(), cb,
                                pad_mode == "wrap")
    want = stack_kernel.preact_stack_plain(
        torch.from_numpy(x).movedim(-1, 1), w1s, w2s, w3s, sc8, pad_mode=pad_mode
    )
    np.testing.assert_allclose(got, want.movedim(1, -1).numpy(), atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    w1s, w2s, w3s, sc8 = _stack(rng, 2, 4)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 2)).astype(np.float32))
    flat, embed = torch.randn(50, 3), torch.randn(7, 3)
    k1, k3 = quantizer_ops.l2_argmin.launches, stack_kernel.preact_stack_fused.launches
    np.testing.assert_array_equal(
        quantizer_ops.l2_argmin(flat, embed), quantizer_ops.l2_argmin_plain(flat, embed)
    )
    np.testing.assert_array_equal(
        stack_kernel.preact_stack_fused(x, w1s, w2s, w3s, sc8, "zeros"),
        stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode="zeros"),
    )
    assert quantizer_ops.l2_argmin.launches == k1
    assert stack_kernel.preact_stack_fused.launches == k3


def test_plain_block_is_the_module_math():
    """``preact_fixup_same`` equals the 'same' block module it stands for."""
    rng = np.random.default_rng(1)
    w1s, w2s, w3s, sc8 = _stack(rng, 1, 6)
    blk = tblocks.PreActFixupResBlock(6, 6, "same", pad_mode="wrap")
    sd = {f"bias{n}": sc8[0, i : i + 1] for i, n in enumerate(tblocks.SCALARS)}
    sd.update(scale=sc8[0, 7:8], **{"branch_conv1.weight": w1s[0],
                                   "branch_conv2.weight": w2s[0],
                                   "branch_conv3.weight": w3s[0]})
    blk.load_state_dict(sd)
    x = torch.from_numpy(rng.standard_normal((1, 6, 4, 3, 2)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_array_equal(
            blk(x), stack_kernel.preact_fixup_same(x, w1s[0], w2s[0], w3s[0], sc8[0],
                                                   pad_mode="wrap")
        )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(524288, 128, 2), (8192, 256, 8), (128, 512, 32)])
def test_k1_kernel_matches_plain_on_card(cuda_device, n, k, d):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    flat = torch.randn(n, d, device=cuda_device, generator=gen)
    embed = torch.randn(k, d, device=cuda_device, generator=gen)
    got = quantizer_ops.l2_argmin(flat, embed)
    want = quantizer_ops.l2_argmin_plain(flat, embed)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
    _, real = quantizer_ops.genuine_ties(flat, embed, got, want)
    assert real.numel() == 0, f"{real.numel()} rows disagree beyond a tie"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
@pytest.mark.parametrize("c", [2, 9, 18, 72, 256])
def test_k3_kernel_matches_plain_on_card(cuda_device, c, pad_mode, dtype):
    rng = np.random.default_rng(300 + c)
    w1s, w2s, w3s, sc8 = (t.to(cuda_device) for t in _stack(rng, 4, c, std=0.1))
    x = torch.from_numpy(rng.standard_normal((1, c, 12, 10, 6)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    launches = stack_kernel.preact_stack_fused.launches
    with torch.inference_mode():
        got = stack_kernel.preact_stack_fused(x, w1s, w2s, w3s, sc8, pad_mode)
        want = stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode)
    torch.cuda.synchronize()
    assert stack_kernel.preact_stack_fused.launches == launches + 4
    assert got.dtype == dtype and got.shape == x.shape
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
