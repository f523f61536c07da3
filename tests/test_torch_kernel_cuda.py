"""The port's CUDA kernel and model path on the card (marker ``cuda``).

Each test needs a CUDA device and skips without one; the file imports
nothing of JAX, so it runs on a machine with a card and no JAX::

    python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

* the flash-attention kernel against its plain version on the same inputs
  (bf16 tolerance 2e-2, fp32 2e-5/1e-5 as ``tests/test_kernels.py``), at
  the serving slice's head layout, with ragged lengths and windows, every
  head dim (8-256) in bf16, non-causal, GQA and MQA, gemma3-12b's head
  layout (16:8 heads of 256, window 1024), jamba's (64:8 heads of 128) and
  deepseek-v2's MLA (128:128
  heads, D = 192 and Dv = 128, also as the strided view the model hands
  over) in both dtypes; k and v of their own length (Sq != Skv): the
  cross-attention shapes of llama-vision (512 x 1600, 32:8 heads of 128)
  and whisper (its encoder's 1500 x 1500 and its cross layers' 432 x 1500,
  6:6 heads of 64, a ragged last tile), one query against 1600 keys, and
  causal rows at Sq < Skv and Sq > Skv, in both dtypes; an uninstantiated
  (D, Dv) pair and a v whose Skv or Hkv is not k's refused with the reason;
* reduced smollm prefill and decode on the card (kernel path) against the
  same weights on the CPU (plain path), in float32, reduced gemma3 at its
  head dim 256 the same way, and reduced llama-vision (a nonzero gate) and
  whisper with their source embeds (a flash launch a self, cross and
  encoder layer);
* the block-quant kernels against their plain version, byte for byte (q,
  scales and the decoded fp32), for int8, e4m3 and e5m2, at blocks 64-512
  and 100, through the vector kernels and the general ones (n = 100, a
  view one element off), each launch's variant asserted; on a NaN/inf
  input by NaN class (NaN at the same places, every other byte equal); and
  the codec on the card against the host's codec;
* one reduced train step on the card against the CPU path (fp32): the loss
  within 1e-5, the gradients of ``wqkv`` (atol 1e-5, rtol 1e-4), and no
  flash-attention launch while a gradient is recorded; the same for
  reduced mixtral (MoE), with its aux loss and the router's and experts'
  gradients; and reduced mamba2 (the plain ``ssd_chunked``, no SSD
  launch), every gradient finite;
* reduced mixtral, reduced jamba (the hybrid: a flash launch per attention
  layer, an SSD launch per Mamba-2 layer), and reduced deepseek-v2 at MLA's
  real head dims (the (192, 128) instance), served on the card against the
  CPU path (fp32): the
  experts each token is routed to are the same wherever the top-k margin
  is above rounding (the share of flipped tokens is reported), and the
  logits of every sequence with no flipped token within 1e-4;
* the SSD chunk-scan kernel against its plain versions (``ssd_ref`` and
  ``ssd_chunked``) on the sweep of ``tests/test_kernels.py`` and at the
  serving shapes, bf16 (y 5e-2) and fp32 (y 5e-4/1e-4), h_final 5e-3 as
  there; strided views; chunks that are not powers of two (40, 96) and the
  model's halving down to 4 (S = 500); P = 128 (two column tiles; also at
  jamba's N = 128 and chunk 256), one rank's 12 of mamba2-130m's 24 heads
  at model=2 (B 4, S 512: the partitioned prefill's launch), G = 2
  and 3, N = 100 (8-byte row copies); reduced mamba2 on the card (one
  kernel launch per layer) against the CPU path in float32; the fp32
  kernel against a float64 recurrence at the B = 1 serving shape, no
  further from it than ``ssd_chunked``; and the wrapper's refusal of a
  recorded gradient;
* each kernel's launches counted by dtype (bf16: the tensor-core kernel;
  fp32: the CUDA-core kernel), and the bf16 kernels' refusal of a view one
  element off its row start;
* the hot tier's coded drain of a reduced smollm state on the card (one
  quantize and one dequantize launch a coded fragment) byte-identical to
  the CPU drain and to ``write_distributed``; a traced restore onto the
  card whose ``restore.materialize`` span closes after a synchronize and
  lasts at least the host-to-device copies timed by CUDA events;
* ``compressed_psum`` on the card in a one-rank gloo group (one quantize
  and one dequantize launch, bit-equal to the CPU's plain path), and two
  spawned gloo ranks on the one card bit-equal to the same world on the
  CPU;
* the multi-rank trainer: two spawned ranks on the one card against the
  same world on the CPU (losses, a coded save's digests, and each rank's
  block-quant launches, one per coded shard it owns);
* the flash kernel at a ``q_offset`` (row i at position ``q_offset + i``):
  smollm-360m's rank-1 rows under sequence parallelism (B 4, 256 query rows
  at offset 256 against 512 keys, 15:5 heads of 64), windowed and ragged
  ones, against the plain version in both dtypes, and against the rows of
  the whole sequence's attention;
* tensor-parallel compute on the card: two spawned gloo ranks under
  data=1,model=2 (reduced smollm at 15:5 heads, attention by query rows;
  reduced gpt3, by heads), 3 fp32 train steps and a served prefill and
  decode, against the same world on the CPU (losses within 1e-5, gradient
  norms 1e-4 relative, logits 1e-4, equal tokens, a flash launch a layer
  and rank on the card, none on the CPU).
"""

import dataclasses
import json
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.kernels.block_quant import ref as bq_ref  # noqa: E402
from repro_torch.kernels.block_quant.ops import block_dequantize, block_quantize  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref_mod  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,b,s,hq,hkv,d,window,causal,dv,skv", [
    (*case, None, None)[:10] for case in [
    (torch.bfloat16, 4, 512, 15, 5, 64, 0, True),
    (torch.bfloat16, 4, 500, 15, 5, 64, 0, True),
    (torch.bfloat16, 4, 500, 15, 5, 64, 128, True),
    (torch.float32, 2, 500, 15, 5, 64, 0, True),
    (torch.float32, 1, 77, 4, 2, 32, 0, False),
    (torch.float32, 2, 130, 6, 3, 16, 32, True),
    (torch.float32, 1, 256, 8, 8, 8, 128, True),
    (torch.bfloat16, 1, 200, 4, 1, 128, 0, True),
    # the tensor-core kernel: every head dim, ragged S, windows, non-causal, GQA and MQA
    (torch.bfloat16, 1, 77, 4, 2, 8, 0, False),
    (torch.bfloat16, 1, 256, 8, 8, 8, 128, True),
    (torch.bfloat16, 2, 130, 6, 3, 16, 32, True),
    (torch.bfloat16, 1, 77, 4, 2, 32, 0, False),
    (torch.bfloat16, 2, 300, 8, 1, 64, 0, False),
    (torch.bfloat16, 2, 190, 4, 2, 128, 64, True),
    (torch.bfloat16, 1, 33, 3, 3, 64, 0, True),
    (torch.float32, 1, 190, 4, 2, 128, 64, True),
    # head dim 256 (gemma3-12b: 16:8 heads, local layers' window 1024), both kernels
    (torch.bfloat16, 4, 512, 16, 8, 256, 0, True),
    (torch.float32, 4, 512, 16, 8, 256, 0, True),
    (torch.bfloat16, 1, 2048, 16, 8, 256, 1024, True),
    (torch.float32, 1, 2048, 16, 8, 256, 1024, True),
    (torch.bfloat16, 2, 300, 4, 2, 256, 100, True),
    (torch.bfloat16, 1, 77, 4, 4, 256, 0, False),
    # a value head dim other than the key's: deepseek-v2's MLA (D = 192, Dv = 128,
    # 128:128 heads), a window, a ragged S and GQA, both kernels
    (torch.bfloat16, 4, 512, 128, 128, 192, 0, True, 128),
    (torch.float32, 4, 512, 128, 128, 192, 0, True, 128),
    (torch.bfloat16, 2, 300, 8, 8, 192, 100, True, 128),
    (torch.float32, 2, 300, 8, 8, 192, 100, True, 128),
    (torch.bfloat16, 1, 77, 8, 2, 192, 0, True, 128),
    (torch.float32, 1, 77, 8, 2, 192, 0, False, 128),
    # jamba's attention layer: 64:8 heads of 128 (a GQA group of 8), both kernels
    (torch.bfloat16, 2, 512, 64, 8, 128, 0, True),
    (torch.float32, 1, 512, 64, 8, 128, 0, True),
    # k and v of their own length (the last field: Skv): llama-vision's cross
    # layer (32:8 heads of 128 against 1600 patches), whisper's encoder and
    # cross layers (6:6 heads of 64, 1500 frames: a ragged last tile), one
    # query against the source, and causal rows at Sq < Skv and Sq > Skv
    (torch.bfloat16, 2, 512, 32, 8, 128, 0, False, None, 1600),
    (torch.float32, 1, 512, 32, 8, 128, 0, False, None, 1600),
    (torch.bfloat16, 4, 1500, 6, 6, 64, 0, False, None, 1500),
    (torch.float32, 1, 1500, 6, 6, 64, 0, False, None, 1500),
    (torch.bfloat16, 4, 432, 6, 6, 64, 0, False, None, 1500),
    (torch.float32, 2, 432, 6, 6, 64, 0, False, None, 1500),
    (torch.bfloat16, 4, 1, 32, 8, 128, 0, False, None, 1600),
    (torch.float32, 4, 1, 32, 8, 128, 0, False, None, 1600),
    (torch.bfloat16, 2, 200, 8, 2, 64, 0, True, None, 300),
    (torch.float32, 2, 200, 8, 2, 64, 0, True, None, 300),
    (torch.bfloat16, 2, 300, 8, 2, 64, 0, True, None, 130),
    (torch.float32, 2, 300, 8, 2, 64, 0, True, None, 130),
]])
def test_kernel_matches_plain(cuda, dtype, b, s, hq, hkv, d, window, causal, dv, skv):
    dv, skv = dv or d, skv or s
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dv, generator=g, device=cuda).to(dtype)
    launches = flash_attention.launches
    by_dtype = dict(flash_attention.launches_by_dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    name = str(dtype).removeprefix("torch.")
    by_dtype[name] += 1
    assert flash_attention.launches_by_dtype == by_dtype
    want = ref.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window
    ).transpose(1, 2)
    assert out.dtype == dtype and out.shape == (b, s, hq, dv)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype,b,sq,skv,hq,hkv,d,window,off", [
    (torch.bfloat16, 4, 256, 512, 15, 5, 64, 0, 256),  # smollm-360m's rank 1 at model=2
    (torch.float32, 4, 256, 512, 15, 5, 64, 0, 256),
    (torch.bfloat16, 4, 256, 256, 15, 5, 64, 0, 0),    # its rank 0
    (torch.bfloat16, 2, 200, 700, 8, 2, 64, 128, 500),  # a window, ragged tiles
    (torch.float32, 2, 200, 700, 8, 2, 64, 128, 500),
    (torch.bfloat16, 1, 77, 130, 4, 2, 128, 0, 53),
    (torch.float32, 2, 100, 160, 6, 3, 16, 32, 37),
])
def test_kernel_matches_plain_at_a_q_offset(cuda, dtype, b, sq, skv, hq, hkv, d, window, off):
    g = torch.Generator(device=cuda).manual_seed(sq + off)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dtype)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=True, window=window, q_offset=off).transpose(1, 2)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **_tol(dtype))
    if off + sq <= skv:  # the same rows of the whole sequence's attention
        qf = torch.randn(b, off + sq, hq, d, generator=g, device=cuda).to(dtype)
        qf[:, off:] = q
        whole = flash_attention(qf, k[:, :off + sq], v[:, :off + sq], causal=True, window=window)
        part = flash_attention(q, k[:, :off + sq], v[:, :off + sq], causal=True, window=window,
                               q_offset=off)
        np.testing.assert_allclose(part.float().cpu().numpy(),
                                   whole[:, off:].float().cpu().numpy(), **_tol(dtype))


def test_kernel_takes_the_mla_value_view(cuda):
    """MLA's v as the model hands it: the [nope | v] view of kv_b's output
    (256 bytes past each head's row start), equal to a contiguous copy."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kvb = torch.randn(2, 100, 16, 256, generator=g, device=cuda, dtype=torch.bfloat16)
    q = torch.randn(2, 100, 16, 192, generator=g, device=cuda, dtype=torch.bfloat16)
    k = torch.cat([kvb[..., :128], q[..., 128:]], dim=-1)
    v = kvb[..., 128:]
    assert not v.is_contiguous()
    out = flash_attention(q, k, v)
    want = flash_attention(q, k, v.contiguous())
    torch.cuda.synchronize()
    assert out.shape == (2, 100, 16, 128) and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_refuses_an_uninstantiated_pair_and_mismatched_kv(cuda, dtype):
    """No fallback: a (D, Dv) pair the source does not instantiate (reduced
    deepseek-v2's (24, 16)) and a v whose Skv or Hkv is not k's raise with
    the reason, and nothing is launched."""
    def t(*shape):
        return torch.randn(*shape, device=cuda).to(dtype)

    launches = flash_attention.launches
    with pytest.raises(ValueError, match=r"\(24, 16\).*instantiated"):
        flash_attention(t(1, 64, 2, 24), t(1, 64, 2, 24), t(1, 64, 2, 16))
    with pytest.raises(ValueError, match=r"v \[B, Skv, Hkv, Dv\]"):
        flash_attention(t(1, 64, 4, 192), t(1, 64, 4, 192), t(1, 63, 4, 128))
    with pytest.raises(ValueError, match=r"v \[B, Skv, Hkv, Dv\]"):
        flash_attention(t(1, 64, 4, 192), t(1, 64, 4, 192), t(1, 64, 2, 128))
    assert flash_attention.launches == launches


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


def test_kernel_refuses_a_misaligned_bf16_view(cuda):
    """The tensor-core kernel copies 16-byte rows: a view one element off
    raises with the reason (no fallback); the fp32 kernel takes it."""
    base = torch.randn(1, 64, 4 * 64 + 1, device=cuda)
    q = base.to(torch.bfloat16)[..., 1:].reshape(1, 64, 4, 64)
    k = v = torch.randn(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="only 2-byte aligned"):
        flash_attention(q, k, v)
    assert flash_attention.launches == launches
    out = flash_attention(base[..., 1:].reshape(1, 64, 4, 64), k.float(), v.float())
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and flash_attention.launches == launches + 1


def test_reduced_smollm_on_card_matches_cpu(cuda):
    _card_matches_cpu(cuda, reduced(get_config("smollm-360m")))


def test_reduced_gemma3_head_dim_256_on_card_matches_cpu(cuda):
    """Reduced gemma3 at its real head dim 256: the fp32 flash kernel at
    D = 256 in local (window) and global layers."""
    cfg = dataclasses.replace(reduced(get_config("gemma3-12b")), head_dim=256)
    assert set(cfg.layer_pattern) == {"local", "global"}
    _card_matches_cpu(cuda, cfg)


def test_reduced_llama_vision_on_card_matches_cpu(cuda):
    """Reduced llama-vision with a nonzero gate: 8 causal self layers and 2
    non-causal cross layers at Sq = 40 against 8 source embeds, one flash
    launch each; decode attends to the cached source plainly."""
    _card_matches_cpu(cuda, reduced(get_config("llama-3.2-vision-11b")), launches=10)


def test_reduced_whisper_on_card_matches_cpu(cuda):
    """Reduced whisper: 2 non-causal encoder layers over 8 frames, then 2
    decoder layers, each a causal self launch and a cross launch."""
    _card_matches_cpu(cuda, reduced(get_config("whisper-tiny")), launches=6)


def _card_matches_cpu(cuda, cfg, launches=None):
    lm = build_model(cfg, compute_dtype=torch.float32)
    params_cpu = lm.init(torch.Generator().manual_seed(0))
    if cfg.cross_attn is not None:  # the init's zero gate would hide the cross layers
        params_cpu["periods"]["cross"]["cross_gate"].fill_(0.7)
    params_gpu = _to(params_cpu, cuda)
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
    src = None
    if cfg.encoder is not None or cfg.cross_attn is not None:
        shape = ((2, cfg.encoder.source_len, cfg.d_model) if cfg.encoder is not None
                 else (2, cfg.cross_attn.source_len, cfg.cross_attn.source_dim))
        src = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    before = flash_attention.launches
    outs = []
    for params, dev in ((params_cpu, "cpu"), (params_gpu, cuda)):
        cache = D.init_cache(lm, 2, 48, device=dev)
        logits, cache = D.prefill(lm, params, cache, toks.to(dev),
                                  source_embeds=None if src is None else src.to(dev))
        steps = [logits.cpu()]
        cur = logits.argmax(-1)[:, None]
        for _ in range(3):
            lg, cache = D.decode_step(lm, params, cache, cur)
            steps.append(lg.cpu())
            cur = lg[:, -1].argmax(-1)[:, None]
        outs.append(steps)
    assert flash_attention.launches == before + (launches or lm.cfg.num_layers)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _bq_input(case):
    rng = np.random.default_rng(0)
    if case == "ragged":
        return rng.standard_normal(1000).astype(np.float32) * 3
    if case == "zero-block":
        return np.concatenate([rng.standard_normal(256), np.zeros(256), rng.standard_normal(7)]
                              ).astype(np.float32)
    if case == "large":
        return np.float32([1e30, -1e30, 0.5, 0.0, 3e29, -7.0] * 50)
    if case == "nonfinite":
        # ±NaN and ±inf among normals, and a block that is all NaN at every block size
        x = rng.standard_normal(3000).astype(np.float32)
        x[3], x[50], x[300], x[420] = np.nan, -np.nan, np.inf, -np.inf
        x[1024:2048] = np.nan
        return x
    # magnitudes over 1e-13..1e13, one row each: every rounding path
    rows = rng.standard_normal((4000, 256)) * np.exp(rng.uniform(-30, 30, (4000, 1)))
    x = rows.astype(np.float32).reshape(-1)
    # "unaligned": a count every block divides, so the view reaches the kernel
    return x[:25600] if case == "unaligned" else x


def _off_by_one(t):
    """An equal tensor whose storage starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _same_by_nan_class(got, want):
    """NaN (a NaN code, for fp8) at the same places as the plain version, and
    every other byte equal: byte for byte where the plain version has no NaN.
    A NaN's sign and payload are the card's arithmetic's."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    ints = {1: torch.uint8, 4: torch.int32}[want.element_size()]
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("block", [64, 100, 128, 256, 512])
@pytest.mark.parametrize("case", ["ragged", "zero-block", "large", "spread", "unaligned",
                                  "nonfinite"])
def test_block_quant_kernels_equal_plain_bytes(cuda, case, block, qdtype):
    """Both variants against the plain version: byte for byte on finite
    inputs, by NaN class on the NaN/inf input; each launch took the variant
    its width and alignment pick (a view one element off takes the general
    kernels)."""
    x = torch.from_numpy(_bq_input(case))
    xc = x.to(cuda)
    if case == "unaligned":
        xc = _off_by_one(xc)
        assert xc.data_ptr() % 16 == 4
    want = "vector" if block % 8 == 0 and case != "unaligned" else "general"
    launches = (block_quantize.launches, block_dequantize.launches)
    by_variant = (dict(block_quantize.launches_by_variant),
                  dict(block_dequantize.launches_by_variant))
    q, s = block_quantize(xc, block=block, dtype=qdtype)
    qc = _off_by_one(q) if case == "unaligned" else q
    d = block_dequantize(qc, s, count=x.numel())
    torch.cuda.synchronize()
    assert (block_quantize.launches, block_dequantize.launches) == (launches[0] + 1,
                                                                   launches[1] + 1)
    for counter, before in zip((block_quantize, block_dequantize), by_variant):
        before[want] += 1
        assert counter.launches_by_variant == before
    pq, ps = bq_ref.quantize_blocks(bq_ref.blocked(x, block=block), dtype=qdtype)
    pd = bq_ref.dequantize_blocks(pq, ps, count=x.numel())
    if case != "nonfinite":
        assert not torch.isnan(pd).any()
    _same_by_nan_class(q, pq)
    _same_by_nan_class(s, ps)
    _same_by_nan_class(d, pd)


def _sections(payload):
    """An RQS1 payload cut into its header bytes and named sections."""
    raw = payload.tobytes()
    (hlen,) = struct.unpack("<I", raw[4:8])
    out, off = {"header": raw[: 8 + hlen]}, 8 + hlen
    for name, nbytes in json.loads(raw[8 : 8 + hlen])["sections"]:
        out[name], off = raw[off : off + nbytes], off + nbytes
    return out


@pytest.mark.parametrize("case", ["spread", "nonfinite"])
@pytest.mark.parametrize("tag", ["int8:b256", "fp8:e4m3:b256", "fp8:e5m2:b64"])
def test_codec_on_card_equals_host_codec(cuda, tag, case):
    """The payload on the card equals the host's: byte for byte, and for the
    NaN/inf input by NaN class (codes and scales), as the decoded views."""
    x = torch.from_numpy(_bq_input(case)[:300_000].reshape(-1, 1000))
    on_card = codec.encode_shard(x.to(cuda), tag)
    on_host = codec.encode_shard(x.numpy(), tag)
    assert on_card.decoded.is_cuda
    decoded = codec.decode_payload(on_host.payload, device=cuda)
    assert decoded.is_cuda
    host_decoded = torch.from_numpy(on_host.decoded)
    if case != "nonfinite":
        assert on_card.payload.tobytes() == on_host.payload.tobytes()
        assert on_card.decoded.cpu().numpy().tobytes() == on_host.decoded.tobytes()
        assert decoded.cpu().numpy().tobytes() == on_host.decoded.tobytes()
        return
    card, host = _sections(on_card.payload), _sections(on_host.payload)
    assert card["header"] == host["header"]
    qdt = bq_ref.QDTYPES[codec.parse_codec(tag).qdtype]
    _same_by_nan_class(torch.frombuffer(bytearray(card["q"]), dtype=torch.uint8).view(qdt),
                       torch.frombuffer(bytearray(host["q"]), dtype=torch.uint8).view(qdt))
    _same_by_nan_class(torch.frombuffer(bytearray(card["scales"]), dtype=torch.float32),
                       torch.frombuffer(bytearray(host["scales"]), dtype=torch.float32))
    _same_by_nan_class(on_card.decoded, host_decoded)
    _same_by_nan_class(decoded, host_decoded)


def test_reduced_train_step_on_card_matches_cpu(cuda):
    lm = build_model(reduced(get_config("smollm-360m")), compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 256, (4, 33), generator=torch.Generator().manual_seed(1))
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig())
    launches = flash_attention.launches
    out = {}
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in flatten_with_paths(params).items()}
        loss, _ = lm.loss_fn(unflatten_from_paths(leaves), {"tokens": toks.to(dev)})
        (g,) = torch.autograd.grad(loss, [leaves["layers.blk.wqkv"]])
        state, metrics = step(init_state(_to(params, dev)), {"tokens": toks.to(dev)})
        out[str(dev)] = (float(loss.detach()), g.cpu(), float(metrics["grad_norm"]))
    assert flash_attention.launches == launches
    (l0, g0, n0), (l1, g1, n1) = out["cpu"], out[str(cuda)]
    assert abs(l0 - l1) <= 1e-5 and abs(n0 - n1) <= 1e-4 * n0
    assert g1.abs().sum() > 0
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=1e-5, rtol=1e-4)


def test_reduced_deepseek_mla_on_card_matches_cpu(cuda, monkeypatch):
    """Reduced deepseek-v2 with MLA's real head dims (nope 128, rope 64,
    v 128: the kernel's (192, 128) instance runs) and narrow widths
    otherwise, served on the card in fp32 against the CPU path, held by the
    experts each token is routed to as reduced mixtral."""
    base = reduced(get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(base, mla=dataclasses.replace(
        base.mla, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128))
    _moe_card_matches_cpu(cuda, monkeypatch, cfg)


def _record_routes(monkeypatch):
    """Record (idx_k, top-k margin) of every MoE routing call, on the host."""
    calls = []
    route = moe_mod.route

    def recording(xg, router_w, k):
        probs, gate_k, idx_k = route(xg, router_w, k)
        top = torch.sort(probs, dim=-1, descending=True).values
        calls.append((idx_k.cpu(), (top[..., k - 1] - top[..., k]).cpu()))
        return probs, gate_k, idx_k

    monkeypatch.setattr(moe_mod, "route", recording)
    return calls


def test_reduced_mixtral_on_card_matches_cpu(cuda, monkeypatch):
    """Routing is discontinuous, so the card is held to the CPU by the
    experts it picks: equal wherever the top-k margin exceeds 1e-5, and
    the logits of sequences whose every routing agreed within 1e-4."""
    _moe_card_matches_cpu(cuda, monkeypatch, reduced(get_config("mixtral-8x22b")))


def test_reduced_jamba_on_card_matches_cpu(cuda, monkeypatch):
    """The hybrid: 2 periods of 8 layers, each one attention layer (a flash
    launch a prefill) and seven Mamba-2 layers (an SSD launch each), the
    MoE on every second layer; held as reduced mixtral."""
    _moe_card_matches_cpu(cuda, monkeypatch, reduced(get_config("jamba-1.5-large-398b")))


def _moe_card_matches_cpu(cuda, monkeypatch, cfg):
    lm = build_model(cfg, compute_dtype=torch.float32)
    params_cpu = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 256, (4, 40), generator=torch.Generator().manual_seed(1))
    calls = _record_routes(monkeypatch)
    kinds = [ld.kind for st in lm.stages for _ in range(st.count) for ld in st.body]
    launches, ssd_launches = flash_attention.launches, ssd_scan.launches
    outs, routes, fed = [], [], []
    for params, dev in ((params_cpu, "cpu"), (_to(params_cpu, cuda), cuda)):
        start = len(calls)
        cache = D.init_cache(lm, 4, 48, device=dev)
        logits, cache = D.prefill(lm, params, cache, toks.to(dev))
        steps = [logits.cpu()]
        for i in range(3):  # both decode the CPU's greedy tokens
            if dev == "cpu":
                fed.append(steps[-1].argmax(-1)[:, None])
            lg, cache = D.decode_step(lm, params, cache, fed[i].to(dev))
            steps.append(lg[:, -1].cpu())
        outs.append(steps)
        routes.append(calls[start:])
    assert flash_attention.launches == launches + kinds.count("attn")
    assert ssd_scan.launches == ssd_launches + kinds.count("mamba")
    flipped = torch.zeros(4, dtype=torch.bool)
    for (i_cpu, margin), (i_gpu, _) in zip(*routes):
        differ = (i_cpu != i_gpu).any(-1)                      # [g=4, t]
        assert bool((margin[differ] <= 1e-5).all()), "a flip above rounding"
        flipped |= differ.any(-1)
    print(f"sequences with a flipped token: {int(flipped.sum())} of 4")
    for a, b in zip(*outs):
        np.testing.assert_allclose(b[~flipped].numpy(), a[~flipped].numpy(), atol=1e-4, rtol=0)


def test_reduced_moe_train_step_on_card_matches_cpu(cuda):
    lm = build_model(reduced(get_config("mixtral-8x22b")), compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 256, (4, 17), generator=torch.Generator().manual_seed(1))
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig())
    names = ["layers.blk.router", "layers.blk.we_gate", "layers.blk.we_down"]
    launches = flash_attention.launches
    out = {}
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in flatten_with_paths(params).items()}
        loss, metrics = lm.loss_fn(unflatten_from_paths(leaves), {"tokens": toks.to(dev)})
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        _, m = step(init_state(_to(params, dev)), {"tokens": toks.to(dev)})
        out[str(dev)] = (float(loss.detach()), float(metrics["aux"].detach()),
                         [g.cpu() for g in grads], float(m["grad_norm"]))
    assert flash_attention.launches == launches
    (l0, a0, g0, n0), (l1, a1, g1, n1) = out["cpu"], out[str(cuda)]
    assert abs(l0 - l1) <= 1e-5 and abs(a0 - a1) <= 1e-6 and abs(n0 - n1) <= 1e-4 * n0
    assert a1 > 0
    for name, a, b in zip(names, g0, g1):
        assert b.abs().sum() > 0, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_reduced_mamba2_train_step_on_card_matches_cpu(cuda):
    """One reduced mamba2 step on the card (the plain ``ssd_chunked``: no
    SSD launch while a gradient is recorded) beside the CPU's, fp32: the
    loss within 1e-5, every gradient finite, those of ``in_proj``,
    ``a_log`` and ``dt_bias`` within 1e-5 (rtol 1e-4)."""
    lm = build_model(reduced(get_config("mamba2-130m")), compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 256, (4, 33), generator=torch.Generator().manual_seed(1))
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig())
    names = ["layers.blk.in_proj", "layers.blk.a_log", "layers.blk.dt_bias"]
    launches = ssd_scan.launches
    out = {}
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in flatten_with_paths(params).items()}
        loss, _ = lm.loss_fn(unflatten_from_paths(leaves), {"tokens": toks.to(dev)})
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        _, m = step(init_state(_to(params, dev)), {"tokens": toks.to(dev)})
        out[str(dev)] = (float(loss.detach()), [grads[n].cpu() for n in names],
                         float(m["grad_norm"]))
    assert ssd_scan.launches == launches
    (l0, g0, n0), (l1, g1, n1) = out["cpu"], out[str(cuda)]
    assert abs(l0 - l1) <= 1e-5 and abs(n0 - n1) <= 1e-4 * n0 and np.isfinite(n1)
    for name, a, b in zip(names, g0, g1):
        assert b.abs().sum() > 0, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def _ssd_inputs(device, b, s, h, p, g, n, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device=device))
    a = -torch.exp(torch.randn(h, generator=gen, device=device))
    bm = torch.randn(b, s, g, n, generator=gen, device=device).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=device).to(dtype)
    return x, dt, a, bm, cm


def _ssd_close(got, want, dtype):
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 else dict(atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(got[0].float().cpu().numpy(), want[0].float().cpu().numpy(), **tol)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 32, 2, 8, 1, 16, 8),
    (2, 64, 4, 16, 2, 8, 16),
    (1, 64, 6, 8, 3, 32, 32),
    (1, 128, 2, 32, 1, 8, 64),
    (2, 512, 24, 64, 1, 128, 256),
    (2, 256, 4, 64, 2, 128, 64),
    (1, 120, 3, 64, 1, 100, 40),
    (1, 500, 4, 16, 1, 16, 4),
    (1, 256, 2, 128, 1, 64, 64),
    (2, 192, 6, 32, 3, 64, 96),
    (1, 512, 4, 128, 1, 128, 256),  # jamba's Mamba-2: P = N = 128, chunk 256
    (4, 512, 12, 64, 1, 128, 256),  # mamba2-130m's rank at model=2: 12 of its 24 heads
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype):
    x, dt, a, bm, cm = _ssd_inputs(cuda, b, s, h, p, g, n, dtype, seed=s + n)
    launches = ssd_scan.launches
    by_dtype = dict(ssd_scan.launches_by_dtype)
    y, hT = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == launches + 1
    by_dtype[str(dtype).removeprefix("torch.")] += 1
    assert ssd_scan.launches_by_dtype == by_dtype
    assert y.dtype == dtype and y.shape == x.shape and hT.shape == (b, h, p, n)
    _ssd_close((y, hT), ssd_chunked(x, dt, a, bm, cm, chunk=chunk), dtype)
    rep = h // g
    yr, hr = ssd_ref_mod.ssd_ref(
        x.transpose(1, 2), dt.transpose(1, 2), a,
        bm.repeat_interleave(rep, 2).transpose(1, 2), cm.repeat_interleave(rep, 2).transpose(1, 2),
    )
    _ssd_close((y, hT), (yr.transpose(1, 2), hr), dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp32_ssd_kernel_against_float64_recurrence(cuda, seed):
    """At the B = 1 serving shape (H=24, P=64, N=128, chunk 256; dt from the
    ``ssm_dt`` bias, A = -(1..24), so |cum| reaches ~100 in a chunk) the
    fp32 kernel's y is no further from ``ssd_ref`` in float64 than
    ``ssd_chunked``'s.  With an fp32 cumsum it was 2.4x further."""
    from repro_torch.models.common import ParamDef, ParamRegistry

    b, s, h, p, n = 1, 512, 24, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt_bias = ParamRegistry([ParamDef("dt_bias", (h,), ("ssm_heads",), init="ssm_dt")]
                            ).init(gen)["dt_bias"]
    x = torch.randn(b, s, h, p, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device=cuda) + dt_bias)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=cuda)
    bm, cm = (torch.randn(b, s, 1, n, generator=gen, device=cuda) for _ in "bc")
    y, _ = ssd_scan(x, dt, a, bm, cm, chunk=256)
    yc, _ = ssd_chunked(x, dt, a, bm, cm, chunk=256)
    y64, _ = ssd_ref_mod.ssd_ref(
        *(t.double().transpose(1, 2) for t in (x, dt)), a.double(),
        *(t.double().repeat_interleave(h, 2).transpose(1, 2) for t in (bm, cm)),
    )
    y64 = y64.transpose(1, 2)
    e_kernel = (y.double() - y64).abs().max().item()
    e_chunked = (yc.double() - y64).abs().max().item()
    assert e_kernel <= e_chunked, (e_kernel, e_chunked)


def test_ssd_kernel_reads_strided_views(cuda):
    """x, B and C as split views of one conv output, dt a column slice, as
    the model hands them: bit-equal to contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, p, g, n = 2, 128, 8, 64, 2, 64
    xbc = torch.randn(b, s, h * p + 2 * g * n, generator=gen, device=cuda, dtype=torch.bfloat16)
    x, bm, cm = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    x, bm, cm = x.reshape(b, s, h, p), bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn(b, s, 2 * h, generator=gen, device=cuda))[..., :h]
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=cuda)
    assert not (x.is_contiguous() or bm.is_contiguous() or dt.is_contiguous())
    got = ssd_scan(x, dt, a, bm, cm, chunk=64)
    want = ssd_scan(*(t.contiguous() for t in (x, dt, a, bm, cm)), chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_kernel_refuses_a_misaligned_bf16_view(cuda):
    """The tensor-core kernel stages rows with 4-, 8- or 16-byte copies: x
    one element off its row start raises with the reason (no fallback)."""
    x, dt, a, bm, cm = _ssd_inputs(cuda, 1, 64, 2, 16, 1, 16, torch.bfloat16)
    wide = torch.zeros(1, 64, 2 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    off = wide[..., 1:].reshape(1, 64, 2, 16)
    off.copy_(x)
    launches = ssd_scan.launches
    with pytest.raises(ValueError, match="only 2-byte aligned"):
        ssd_scan(off, dt, a, bm, cm, chunk=32)
    assert ssd_scan.launches == launches


def test_ssd_kernel_refuses_a_recorded_gradient(cuda):
    x, dt, a, bm, cm = _ssd_inputs(cuda, 1, 16, 2, 8, 1, 8, torch.float32)
    launches = ssd_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x.requires_grad_(True), dt, a, bm, cm, chunk=8)
    with torch.no_grad():
        ssd_scan(x, dt, a, bm, cm, chunk=8)
    assert ssd_scan.launches == launches + 1


@pytest.mark.parametrize("s", [40, 500])
def test_reduced_mamba2_on_card_matches_cpu(cuda, s):
    """Prefill (40 tokens: chunk 8 of the config's 16; 500: halved to 4) and
    3 decode steps; the kernel runs once per layer in the card's prefill."""
    lm = build_model(reduced(get_config("mamba2-130m")), compute_dtype=torch.float32)
    params_cpu = lm.init(torch.Generator().manual_seed(0))
    params_gpu = _to(params_cpu, cuda)
    toks = torch.randint(0, 256, (2, s), generator=torch.Generator().manual_seed(1))
    outs = []
    for params, dev in ((params_cpu, "cpu"), (params_gpu, cuda)):
        launches = ssd_scan.launches
        with torch.inference_mode():
            cache = D.init_cache(lm, 2, s + 4, device=dev)
            logits, cache = D.prefill(lm, params, cache, toks.to(dev))
            made = ssd_scan.launches - launches
            steps = [logits.cpu()]
            cur = logits.argmax(-1)[:, None]
            for _ in range(3):
                lg, cache = D.decode_step(lm, params, cache, cur)
                steps.append(lg.cpu())
                cur = lg[:, -1].argmax(-1)[:, None]
        assert made == (lm.cfg.num_layers if dev == cuda else 0)
        outs.append((steps, cache["layers"]["blk"]["h"].cpu()))
    (cpu_steps, cpu_h), (gpu_steps, gpu_h) = outs
    for a, b in zip(cpu_steps, gpu_steps):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gpu_h.numpy(), cpu_h.numpy(), atol=1e-4, rtol=1e-4)


def test_export_ucp_on_card_equals_host_convert(cuda, tmp_path):
    """A reduced checkpoint with int8:b256 moments exported on the card
    (every coded shard decoded once by the dequantize kernel) has the atom
    digests of the host's conversion of the same checkpoint."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.core import DistCheckpoint, MeshSpec, convert_to_ucp
    from repro_torch.dist.sharding import make_plan, vocab_multiple

    cfg = reduced(get_config("smollm-360m"))
    mesh, par = MeshSpec.from_dict({"data": 2, "model": 2}), TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    state = init_state(lm.init(torch.Generator(device=cuda).manual_seed(0)))
    g = torch.Generator(device=cuda).manual_seed(1)
    for tree in (state.exp_avg, state.exp_avg_sq):
        for t in flatten_with_paths(tree).values():
            t.copy_(torch.rand(t.shape, generator=g, device=cuda))
    policy = codec.CodecPolicy.moments("int8:b256")
    write_distributed(snapshot_state(state, policy), plan, 2, tmp_path / "ck" / "step_00000002",
                      codec=policy)
    ck = DistCheckpoint.open(tmp_path / "ck" / "step_00000002")
    host, _ = convert_to_ucp(ck, str(tmp_path / "host.ucp"))
    before = block_dequantize.launches
    card, stats = CheckpointManager(tmp_path / "ck", plan).export_ucp(device=cuda)
    assert stats is not None and block_dequantize.launches - before == len(ck.manifest.shard_codecs)
    assert card.validate() == []
    assert {n: a.digests for n, a in card.manifest.atoms.items()} == \
        {n: a.digests for n, a in host.manifest.atoms.items()}


def _reduced_coded_state(device, mesh_d):
    """Reduced smollm's plan under ``mesh_d`` and a state on ``device`` with
    random moments (so every coded block has its own scale)."""
    from repro_torch.core import MeshSpec
    from repro_torch.dist.sharding import make_plan, vocab_multiple

    cfg = reduced(get_config("smollm-360m"))
    mesh, par = MeshSpec.from_dict(mesh_d), TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    state = init_state(lm.init(torch.Generator(device=device).manual_seed(0)))
    g = torch.Generator(device=device).manual_seed(1)
    for tree in (state.exp_avg, state.exp_avg_sq):
        for t in flatten_with_paths(tree).values():
            t.copy_(torch.rand(t.shape, generator=g, device=device))
    return plan, state


def test_hot_drain_on_card_equals_cpu_drain(cuda, tmp_path):
    """A reduced smollm's hot snapshot drained with int8:b256 moments: the
    card state's drain encodes every coded fragment with the quantize
    kernel (one launch each, and one dequantize for its served digest),
    and its files are byte-identical to the drain of the same state on the
    CPU (the plain codec) and to ``write_distributed``'s."""
    from pathlib import Path

    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.core import DistCheckpoint
    from repro_torch.core.pytree import flatten_with_paths as flat
    from repro_torch.hot import HotTier, persist_snapshot
    from repro_torch.train.optimizer import TrainState

    plan, state = _reduced_coded_state(cuda, {"data": 2, "model": 2})
    policy = codec.CodecPolicy.moments("int8:b256")
    cpu_state = TrainState(*(unflatten_from_paths({n: t.cpu() for n, t in flat(tree).items()})
                             for tree in (state.params, state.exp_avg, state.exp_avg_sq)),
                           state.step)
    roots = {}
    for label, st, dev in (("card", state, cuda), ("cpu", cpu_state, torch.device("cpu"))):
        tier = HotTier(replication=1)
        hs, _ = tier.capture(snapshot_state(st), plan, 4, device=dev)
        q0, d0 = block_quantize.launches, block_dequantize.launches
        res = persist_snapshot(hs, tmp_path / label / "step_00000004", codec=policy)
        n_coded = len(DistCheckpoint.open(tmp_path / label / "step_00000004").manifest.shard_codecs)
        launches = (block_quantize.launches - q0, block_dequantize.launches - d0)
        want = (n_coded, n_coded) if label == "card" else (0, 0)
        assert n_coded > 0 and launches == want, (label, launches, n_coded)
        assert res.coded_bytes > 0
        roots[label] = tmp_path / label / "step_00000004"
        tier.clear()
    write_distributed(snapshot_state(state, policy), plan, 4, tmp_path / "direct" / "step_00000004",
                      codec=policy)
    roots["direct"] = tmp_path / "direct" / "step_00000004"

    def files(root: Path):
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.glob("ranks/**/*.npy"))}

    card = files(roots["card"])
    for other in ("cpu", "direct"):
        got = files(roots[other])
        assert got.keys() == card.keys() and card
        assert all(got[k] == card[k] for k in card), other
    manifests = {k: DistCheckpoint.open(r).manifest.to_json() for k, r in roots.items()}
    for m in manifests.values():
        m.pop("created_at")
    assert manifests["card"] == manifests["cpu"] == manifests["direct"]


def test_traced_restore_materialize_spans_the_copies(cuda, tmp_path):
    """A traced restore onto the card closes ``restore.materialize`` after a
    synchronize: its duration is at least the host-to-device copies of the
    same regions timed with CUDA events, and no copy is left queued when
    it ends."""
    import repro_torch.obs as obs
    from repro_torch.ckpt.restore import params_from_source
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.core import DistCheckpoint, default_engine

    plan, state = _reduced_coded_state(cuda, {"data": 2, "model": 2})
    write_distributed(snapshot_state(state), plan, 1, tmp_path / "step_00000001")
    ck = DistCheckpoint.open(tmp_path / "step_00000001")
    params_from_source(ck, plan, cuda)  # warm: pages cached, CUDA context up
    # the copies alone: each region's host array to the card, CUDA events
    hosts = [t.cpu().numpy() for t in flatten_with_paths(state.params).values()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for a in hosts:
        torch.from_numpy(a).to(cuda)
    end.record()
    torch.cuda.synchronize()
    copies_ms = start.elapsed_time(end)
    with obs.enabled() as tracer:
        out = params_from_source(ck, plan, cuda, engine=default_engine(cuda))
        # the span closed after the card's queue drained: nothing is pending
        assert torch.cuda.current_stream().query()
    default_engine(cuda).release(ck)
    spans = {r["name"]: r for r in tracer.span_records()}
    assert {"restore.prefetch", "restore.materialize"} <= spans.keys()
    mat_ms = spans["restore.materialize"]["dur_us"] / 1e3
    assert mat_ms >= copies_ms * 0.9, (mat_ms, copies_ms)
    assert spans["restore.materialize"]["ts_us"] >= spans["restore.prefetch"]["ts_us"]
    for name, t in flatten_with_paths(state.params).items():
        assert torch.equal(out[name], t), name


def _fleet_checkpoint(tmp_path, registry, params, lm_plan, step):
    """A weights-only save of ``params`` under the Source plan, published."""
    from repro_torch.ckpt.saver import snapshot_weights, write_distributed
    from repro_torch.core import DistCheckpoint

    root = tmp_path / f"step_{step:08d}"
    write_distributed(snapshot_weights(params), lm_plan, step, root)
    return registry.publish(DistCheckpoint.open(root))


def _fleet_plans(cfg):
    from repro_torch.core import MeshSpec
    from repro_torch.dist.sharding import make_plan, vocab_multiple

    out = []
    for mesh_d in ({"data": 2, "model": 2}, {"data": 1, "model": 1}):
        mesh, par = MeshSpec.from_dict(mesh_d), TC.ParallelismConfig()
        lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh), compute_dtype=torch.float32)
        out.append((lm, make_plan(cfg, lm.registry, par, mesh)))
    return out


def _sync_threads(reps):
    import threading

    errs = []

    def one(r):
        try:
            assert r.sync()
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in reps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errs, errs


def test_reduced_smollm_fleet_on_card_equals_cpu_fleet(cuda, tmp_path):
    """A reduced smollm published under data=2,model=2 to a fleet of 3 on the
    card (one engine, replica threads) and a fleet of 3 on the CPU, both
    under data=1,model=1: the card replicas hold one set of tensors,
    bit-equal to the CPU fleet's, with no block-quant launch (raw weights,
    read on the host); served in fp32 from the card (a flash launch a
    layer) the logits are the CPU fleet's within 1e-4."""
    from repro_torch.core.engine import CheckpointEngine
    from repro_torch.serve import FleetReplica, PublicationRegistry

    cfg = reduced(get_config("smollm-360m"))
    (lm, src_plan), (lm1, plan1) = _fleet_plans(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    registry = PublicationRegistry()
    _fleet_checkpoint(tmp_path, registry, params, src_plan, 1)
    engine = CheckpointEngine(cuda)
    card = [FleetReplica(f"g{i}", registry, plan1, cuda, engine=engine) for i in range(3)]
    host = [FleetReplica(f"c{i}", registry, plan1, "cpu", engine=CheckpointEngine(workers=2))
            for i in range(3)]
    q0, d0 = block_quantize.launches, block_dequantize.launches
    _sync_threads(card)
    assert (block_quantize.launches, block_dequantize.launches) == (q0, d0)
    for r in host:
        assert r.sync()
    want = host[0].flat_params()
    for r in card:
        got = r.flat_params()
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert t.device.type == "cuda" and torch.equal(t.cpu(), want[name]), name
            assert t.data_ptr() == card[0].flat_params()[name].data_ptr(), name
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
    before = flash_attention.launches
    outs = []
    for rep, dev in ((card[2], cuda), (host[1], torch.device("cpu"))):
        with torch.inference_mode():
            logits, _ = D.prefill(lm1, rep.params, D.init_cache(lm1, 2, 40, device=dev),
                                  toks.to(dev))
        outs.append(logits.cpu())
    assert flash_attention.launches == before + cfg.num_layers
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-4, rtol=0)
    engine.close()


def test_fleet_card_memory_does_not_grow_per_publication(cuda, tmp_path):
    """Three publications of a reduced smollm (every weight changed, then
    every weight again, then ``final_norm`` alone) to 2 replicas on one card
    engine: after each sync the card holds one set of weights, not one per
    publication, and the in-place delta keeps every other tensor."""
    import gc

    from repro_torch.core.engine import CheckpointEngine
    from repro_torch.serve import FleetReplica, PublicationRegistry

    cfg = reduced(get_config("smollm-360m"))
    (lm, src_plan), (_, plan1) = _fleet_plans(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    one_set = sum(t.numel() * 4 for t in flatten_with_paths(params).values())
    registry = PublicationRegistry()
    engine = CheckpointEngine(cuda)
    reps = [FleetReplica(f"m{i}", registry, plan1, cuda, engine=engine) for i in range(2)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    retained = []
    for step in (1, 2, 3):
        if step == 3:
            params["final_norm"] = params["final_norm"] + 1.0
        elif step == 2:
            params = unflatten_from_paths({n: t + 1.0 for n, t in flatten_with_paths(params).items()})
        _fleet_checkpoint(tmp_path, registry, params, src_plan, step)
        kept = reps[0].flat_params() if step == 3 else None
        _sync_threads(reps)
        gc.collect()
        torch.cuda.synchronize()
        retained.append(torch.cuda.memory_allocated() - base)
    assert reps[0].last_update == frozenset({"final_norm"})
    now = reps[0].flat_params()
    assert all(now[n] is kept[n] for n in now if n != "final_norm")
    assert all(r <= one_set * 1.05 + (1 << 20) for r in retained), (retained, one_set)
    want = flatten_with_paths(params)
    for name, t in now.items():
        assert torch.equal(t.cpu(), want[name]), name
    engine.close()


def test_compressed_psum_on_card_launches_each_kernel_once(cuda, tmp_path):
    """A CUDA ``compressed_psum`` in a one-rank gloo group: exactly one
    quantize and one dequantize launch, and the result bit-equal to the
    CPU's plain path."""
    import torch.distributed as dist

    from repro_torch.dist import compressed_psum

    g = torch.randn(3, 300, generator=torch.Generator().manual_seed(0)) * 5
    e = torch.randn(3, 300, generator=torch.Generator().manual_seed(1)) * 1e-2
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        want = compressed_psum(g, e)
        q0, d0 = block_quantize.launches, block_dequantize.launches
        got = compressed_psum(g.to(cuda), e.to(cuda))
        assert (block_quantize.launches - q0, block_dequantize.launches - d0) == (1, 1)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_two_rank_gloo_world_on_card_equals_cpu(cuda, tmp_path):
    """Two spawned gloo ranks on the one card (NCCL puts no two ranks on
    one device): every step's synced and residual bit-equal to the same
    world on the CPU, one quantize and one dequantize launch a step."""
    from test_torch_collectives import STEPS, run_ranks

    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = run_ranks(tmp_path / "card", 2, device="cuda")
    host = run_ranks(tmp_path / "cpu", 2, device="cpu")
    for c, h in zip(card, host):
        assert c["launches"].tolist() == [[1, 1]] * STEPS
        for key in ("synced", "err"):
            np.testing.assert_array_equal(c[key].view(np.uint32), h[key].view(np.uint32))


def test_multirank_world_on_card_equals_cpu(cuda, tmp_path):
    """Two spawned ranks of the multi-rank trainer on the one card (gloo,
    data=2,model=1, reduced smollm in fp32): each of 3 steps' losses within
    1e-5 of the same world on the CPU (gradient norms within 1e-4 relative,
    as ``test_reduced_train_step_on_card_matches_cpu``), an ``int8:b256``
    save of one seeded state with the CPU world's digests, and each rank's
    quantize and dequantize launches one per coded shard it owns (none on
    the CPU)."""
    from test_torch_multirank import ARCH, run_world

    from repro_torch.core.dist_ckpt import DistCheckpoint

    lm = build_model(reduced(get_config(ARCH)), compute_dtype=torch.float32)
    flat = {n: t.numpy() for n, t in
            flatten_with_paths(lm.init(torch.Generator().manual_seed(0))).items()}
    worlds = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        np.savez(d / "weights.npz", **flat)
        worlds[dev] = (d, run_world(d, 2, "device_world", device=dev))
    (dc, card), (dh, host) = worlds["cuda"], worlds["cpu"]
    for c, h in zip(card, host):
        for (lc, gc), (lh, gh) in zip(c["hist"], h["hist"], strict=True):
            assert abs(lc - lh) <= 1e-5 and abs(gc - gh) <= 1e-4 * gh
    mc = DistCheckpoint.open(dc / "coded" / "step_00000001").manifest
    mh = DistCheckpoint.open(dh / "coded" / "step_00000001").manifest
    assert mc.shard_digests == mh.shard_digests and mc.shard_codecs == mh.shard_codecs
    for r, (c, h) in enumerate(zip(card, host)):
        owned = sum(1 for k, tag in mc.shard_codecs.items()
                    if tag != "raw" and k.startswith(f"rank_{r:05d}/"))
        assert owned and c["launches"] == (owned, owned) and h["launches"] == (0, 0)


def test_tensor_parallel_world_on_card_equals_cpu(cuda, tmp_path):
    """Two spawned gloo ranks on the one card computing partitioned over
    model=2 (reduced smollm at 15:5 heads of 8: attention by query rows, the
    rank-1 prefill a flash launch at q_offset 4; reduced gpt3: by heads)
    against the same world on the CPU, in fp32."""
    from test_torch_tensor_parallel import MODELS, SERVE, TRAIN, port_cfg, run_world

    names = ["smollm15_m2", "gpt3_m2", "serve_smollm15_m2", "serve_gpt3_m2"]
    worlds = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        for model in MODELS:
            lm = build_model(port_cfg(model), compute_dtype=torch.float32)
            np.savez(d / f"weights_{model}.npz", **{n: t.numpy() for n, t in flatten_with_paths(
                lm.init(torch.Generator().manual_seed(0))).items()})
        worlds[dev] = run_world(d, 2, dev, names)
    for c, h in zip(worlds["cuda"], worlds["cpu"]):
        for name in names:
            if name in TRAIN:
                for (lc, gc), (lh, gh) in zip(c[name]["hist"], h[name]["hist"], strict=True):
                    assert abs(lc - lh) <= 1e-5 and abs(gc - gh) <= 1e-4 * gh, name
                continue
            np.testing.assert_allclose(c[name]["logits"].numpy(), h[name]["logits"].numpy(),
                                       atol=1e-4, err_msg=name)
            assert torch.equal(c[name]["tokens"], h[name]["tokens"]), name
            layers = port_cfg(SERVE[name][0]).num_layers
            assert (c[name]["flash_launches"], h[name]["flash_launches"]) == (layers, 0), name
