"""The port's CUDA kernel and model path on the card (marker ``cuda``).

Each test needs a CUDA device and skips without one; the file imports
nothing of JAX, so it runs on a machine with a card and no JAX::

    python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

* the flash-attention kernel against its plain version on the same inputs
  (bf16 tolerance 2e-2, fp32 2e-5/1e-5 as ``tests/test_kernels.py``), at
  the serving slice's head layout, with ragged lengths and windows;
* reduced smollm prefill and decode on the card (kernel path) against the
  same weights on the CPU (plain path), in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,b,s,hq,hkv,d,window,causal", [
    (torch.bfloat16, 4, 512, 15, 5, 64, 0, True),
    (torch.bfloat16, 4, 500, 15, 5, 64, 0, True),
    (torch.bfloat16, 4, 500, 15, 5, 64, 128, True),
    (torch.float32, 2, 500, 15, 5, 64, 0, True),
    (torch.float32, 1, 77, 4, 2, 32, 0, False),
    (torch.float32, 2, 130, 6, 3, 16, 32, True),
    (torch.float32, 1, 256, 8, 8, 8, 128, True),
    (torch.bfloat16, 1, 200, 4, 1, 128, 0, True),
])
def test_kernel_matches_plain(cuda, dtype, b, s, hq, hkv, d, window, causal):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = ref.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window
    ).transpose(1, 2)
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **_tol(dtype))


def test_kernel_reads_strided_views(cuda):
    """Q/K/V as split views of one fused projection, as the model hands them."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 100, (15 + 10) * 64, generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [15 * 64, 5 * 64, 5 * 64], dim=-1)
    q, k, v = (t.reshape(2, 100, -1, 64) for t in (q, k, v))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_reduced_smollm_on_card_matches_cpu(cuda):
    lm = build_model(reduced(get_config("smollm-360m")), compute_dtype=torch.float32)
    params_cpu = lm.init(torch.Generator().manual_seed(0))
    params_gpu = _to(params_cpu, cuda)
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
    launches = flash_attention.launches
    outs = []
    for params, dev in ((params_cpu, "cpu"), (params_gpu, cuda)):
        cache = D.init_cache(lm, 2, 48, device=dev)
        logits, cache = D.prefill(lm, params, cache, toks.to(dev))
        steps = [logits.cpu()]
        cur = logits.argmax(-1)[:, None]
        for _ in range(3):
            lg, cache = D.decode_step(lm, params, cache, cur)
            steps.append(lg.cpu())
            cur = lg[:, -1].argmax(-1)[:, None]
        outs.append(steps)
    assert flash_attention.launches == launches + lm.cfg.num_layers
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
