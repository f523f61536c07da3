"""The SSM (Mamba-2) serving slice, held against the JAX package.

* Each function of ``repro_torch.models.ssm`` against its reference in
  ``repro.models.ssm`` on the same numpy inputs, in float32 (atol 1e-5:
  the same fp32 arithmetic, summed in another order) and bfloat16 (outputs
  rounded to bf16 in both; atol 2e-2 at |y| ≲ 4, a couple of bf16 ulps).
* Reduced mamba2-130m with the reference's weights (``params_from_reference``):
  prefill plus 4 decode steps against the reference ``D.prefill``/
  ``D.decode_step`` (float32 logits within 1e-4 and equal greedy tokens,
  bf16 within 0.1 as the dense serving test), the ``h``/``conv`` caches
  after prefill, over prompts that span several chunks (and a ragged one,
  where the model's chunk choice halves 16 down to 4).
* The port's own parity: prefill then decode equals the forward pass.
* The ``ssm_alog`` init equals the reference's; ``ssm_dt`` draws from the
  same range.  Serving reads ``a_log`` and ``dt_bias`` in float32.
* Training: one mamba2 step trains through the trainer and the train CLI
  (the reference comparison of SSM training is ``tests/test_torch_ssm_train.py``);
  the model refuses only the cross-attention and encoder families.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import ssm as RM  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths as tflat  # noqa: E402
from repro_torch.core.pytree import unflatten_from_paths  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import ssm as TM  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCH = "mamba2-130m"
# (jax dtype, torch dtype, atol, rtol): fp32 sums in another order are a few
# ulps apart at |y| ≲ 5; bf16 outputs a couple of bf16 ulps
DTYPES = {
    "float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 0.0),
}


def _ssd_inputs(dtype, b=2, s=32, h=4, p=8, g=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jdt, tdt = DTYPES[dtype][:2]
    ref = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm, jdt),
           jnp.asarray(cm, jdt))
    port = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
            torch.from_numpy(bm).to(tdt), torch.from_numpy(cm).to(tdt))
    return ref, port, (jnp.asarray(h0), torch.from_numpy(h0))


def _close(port, ref, dtype, scale=1.0):
    _, tdt, atol, rtol = DTYPES[dtype]
    assert port.dtype == tdt
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=scale * atol, rtol=rtol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_chunked_matches_reference(dtype, chunk, with_h0):
    ref, port, (jh0, th0) = _ssd_inputs(dtype)
    ry, rh = RM.ssd_chunked(*ref, chunk=chunk, h0=jh0 if with_h0 else None)
    ty, th = TM.ssd_chunked(*port, chunk=chunk, h0=th0 if with_h0 else None)
    _close(ty, ry, dtype)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-4, rtol=1e-5)
    assert th.dtype == torch.float32


def test_ssd_chunked_refuses_a_ragged_chunk():
    _, port, _ = _ssd_inputs("float32")
    with pytest.raises(ValueError, match="not divisible"):
        TM.ssd_chunked(*port, chunk=12)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_recurrent_matches_reference(dtype):
    ref, port, (jh0, th0) = _ssd_inputs(dtype, s=16)
    ry, rh = RM.ssd_recurrent(*ref, h0=jh0)
    ty, th = TM.ssd_recurrent(*port, h0=th0)
    _close(ty, ry, dtype)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-4, rtol=1e-5)


def test_ssd_chunked_equals_recurrent():
    _, port, (_, th0) = _ssd_inputs("float32")
    y1, h1 = TM.ssd_recurrent(*port, h0=th0)
    y2, h2 = TM.ssd_chunked(*port, chunk=8, h0=th0)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=5e-4)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=5e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssm_decode_step_matches_reference(dtype):
    ref, port, (jh0, th0) = _ssd_inputs(dtype, s=1)
    rx, rdt, ra, rb, rc = ref
    tx, tdt_, ta, tb, tc = port
    rh, ry = RM.ssm_decode_step(jh0, rx[:, 0], rdt[:, 0], ra, rb[:, 0], rc[:, 0])
    th, ty = TM.ssm_decode_step(th0, tx[:, 0], tdt_[:, 0], ta, tb[:, 0], tc[:, 0])
    _close(ty, ry, dtype)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-5)


def _conv_inputs(dtype, b=2, s=9, d=12, k=4):
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[dtype][:2]
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, d), (d, k), (d,), (b, k - 1, d))]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_conv1d_matches_reference(dtype):
    (rx, rw, rb, _), (tx, tw, tb, _) = _conv_inputs(dtype)
    # four taps summed in the compute dtype: twice the bf16 allowance
    _close(TM.causal_conv1d(tx, tw, tb), RM.causal_conv1d(rx, rw, rb), dtype, scale=2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_decode_step_matches_reference(dtype):
    (rx, rw, rb, rs), (tx, tw, tb, ts) = _conv_inputs(dtype)
    rstate, rout = RM.conv_decode_step(rs, rx[:, 0], rw, rb)
    tstate, tout = TM.conv_decode_step(ts, tx[:, 0], tw, tb)
    np.testing.assert_array_equal(tstate.float().numpy(), np.asarray(rstate, np.float32))
    _close(tout, rout, dtype, scale=2)


def test_conv_decode_continues_causal_conv():
    """Decoding one step from the last K-1 inputs gives the conv's next row."""
    _, (tx, tw, tb, _) = _conv_inputs("float32")
    full = TM.causal_conv1d(tx, tw, tb)
    state, out = TM.conv_decode_step(tx[:, -4:-1], tx[:, -1], tw, tb)
    np.testing.assert_allclose(out.numpy(), full[:, -1].numpy(), atol=1e-6)
    assert torch.equal(state, tx[:, -3:])


# ---------------------------------------------------------------------------
# the model, against the reference's serving path
# ---------------------------------------------------------------------------


def _pair(jdt, tdt, seed=0):
    rlm = ref_build(RC.reduced(RC.get_config(ARCH)), compute_dtype=jdt, remat="none")
    tlm = build_model(TC.reduced(TC.get_config(ARCH)), compute_dtype=tdt)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _run_both(jdt, tdt, *, s, steps=4, b=2):
    rlm, rp, tlm, tp = _pair(jdt, tdt)
    toks = np.random.default_rng(0).integers(0, tlm.cfg.vocab_size, (b, s))
    rc = RD.init_cache(rlm, b, s + steps + 1)
    tc = D.init_cache(tlm, b, s + steps + 1)
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks, jnp.int32))
    tl, tc = D.prefill(tlm, tlm.registry.cast(tp, tdt), tc, torch.from_numpy(toks))
    pairs = [(np.asarray(rl), tl.numpy())]
    caches = [(rc, {k: v.clone() for k, v in tc["layers"]["blk"].items()})]
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    tokens = [(cur, tl.argmax(-1)[:, None].numpy())]
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm, tlm.registry.cast(tp, tdt), tc, torch.from_numpy(cur.copy()))
        pairs.append((np.asarray(rl), tl.numpy()))
        cur = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        tokens.append((cur, tl[:, -1].argmax(-1)[:, None].numpy()))
    assert int(tc["pos"][0]) == int(rc["pos"][0]) == s + steps
    return pairs, tokens, caches


@pytest.mark.parametrize("s", [40, 20, 12])
def test_prefill_decode_float32_match_reference(s):
    """40 tokens: chunk 8, five chunks; 20: the chunk halves to 4; 12: one
    chunk of 12 (shorter than the config's 16)."""
    pairs, tokens, _ = _run_both(jnp.float32, torch.float32, s=s)
    for ref, port in pairs:
        assert port.dtype == np.float32 and port.shape == ref.shape
        np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
    for ref, port in tokens:
        np.testing.assert_array_equal(port, ref)


def test_prefill_decode_bfloat16_match_reference():
    pairs, _, _ = _run_both(jnp.bfloat16, torch.bfloat16, s=40)
    for ref, port in pairs:
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, atol=0.1, rtol=0)


def test_cache_matches_reference_after_prefill():
    """The SSM state (float32) and the last K-1 pre-conv rows, per layer."""
    _, _, caches = _run_both(jnp.float32, torch.float32, s=40, steps=0)
    (rc, tc), = caches
    assert tc["h"].dtype == torch.float32 and tc["conv"].dtype == torch.float32
    assert set(tc) == set(rc["layers"]["blk"]) == {"h", "conv"}
    for key in ("h", "conv"):
        want = np.asarray(rc["layers"]["blk"][key])
        assert tc[key].shape == want.shape
        np.testing.assert_allclose(tc[key].numpy(), want, atol=1e-5)


def test_prefill_then_decode_matches_forward():
    """The port's own parity (as ``tests/test_models.py`` for mamba2):
    prefill(t[:8]) + decode steps == forward(t) logits."""
    lm = build_model(TC.reduced(TC.get_config(ARCH)), compute_dtype=torch.float32, remat="none")
    params = lm.init(torch.Generator().manual_seed(0))
    b, s, n = 2, 12, 8
    toks = torch.randint(0, lm.cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(9))
    full, _ = lm.forward(params, toks)
    full = full[..., : lm.cfg.vocab_size]
    cache = D.init_cache(lm, b, s + 4)
    lp, cache = D.prefill(lm, params, cache, toks[:, :n])
    np.testing.assert_allclose(lp.numpy(), full[:, n - 1].numpy(), atol=1e-4)
    for t in range(n, s):
        ld, cache = D.decode_step(lm, params, cache, toks[:, t : t + 1])
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, t].numpy(), atol=1e-4,
                                   err_msg=f"step {t}")


def test_forward_matches_reference():
    """The training-shaped forward (fp32 logits over the padded vocab)."""
    rlm, rp, tlm, tp = _pair(jnp.float32, torch.float32)
    toks = np.random.default_rng(2).integers(0, 256, (2, 33))
    rl, _ = rlm.forward(rp, jnp.asarray(toks, jnp.int32))
    tl, _ = tlm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(rl), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# initialisation and the float32 leaves
# ---------------------------------------------------------------------------


def test_ssm_alog_init_equals_reference():
    rlm = ref_build(RC.get_config(ARCH))
    tlm = build_model(TC.get_config(ARCH))
    want = np.asarray(flatten_with_paths(rlm.init(jax.random.PRNGKey(0)))["layers.blk.a_log"])
    got = tflat(tlm.init(torch.Generator().manual_seed(0)))["layers.blk.a_log"]
    assert got.shape == want.shape == (24, 24)
    assert got.numpy().tobytes() == want.tobytes()


def test_ssm_dt_init_spans_the_mamba_range():
    """``dt_bias`` is the inverse softplus of dt in [1e-3, 1e-1], like the
    reference's draw (threefry's numbers cannot be matched)."""
    tlm = build_model(TC.get_config(ARCH))
    bias = tflat(tlm.init(torch.Generator().manual_seed(0)))["layers.blk.dt_bias"]
    dt = torch.nn.functional.softplus(bias.double())
    assert bias.dtype == torch.float32 and bias.shape == (24, 24)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.log().std()) > 0.5  # log-uniform, not a constant
    rlm = ref_build(RC.get_config(ARCH))
    ref = np.asarray(flatten_with_paths(rlm.init(jax.random.PRNGKey(0)))["layers.blk.dt_bias"])
    rdt = np.log1p(np.exp(ref.astype(np.float64)))
    assert rdt.min() >= 1e-3 * (1 - 1e-5) and rdt.max() <= 1e-1 * (1 + 1e-5)


def test_cast_params_keeps_the_float32_leaves():
    """The registry's cast keeps exactly the leaves declared ``keep_fp32``:
    Mamba's ``a_log`` and ``dt_bias``, none of a dense config."""
    tlm = build_model(TC.reduced(TC.get_config(ARCH)))
    cast = tflat(tlm.registry.cast(tlm.init(torch.Generator().manual_seed(0)), torch.bfloat16))
    kept = {d.path for d in tlm.registry if d.keep_fp32}
    assert kept == {"layers.blk.a_log", "layers.blk.dt_bias"}
    for name, t in cast.items():
        assert t.dtype == (torch.float32 if name in kept else torch.bfloat16), name
    dense = build_model(TC.reduced(TC.get_config("smollm-360m")))
    assert not any(d.keep_fp32 for d in dense.registry)
    cast = tflat(dense.registry.cast(dense.init(torch.Generator().manual_seed(0)), torch.bfloat16))
    assert {t.dtype for t in cast.values()} == {torch.bfloat16}


def test_blanket_bf16_cast_would_change_the_logits():
    """The fault the cast avoids: rounding a_log/dt_bias to bf16 moves the
    logits, while the registry's cast gives exactly those of fp32 params."""
    _, _, tlm, tp = _pair(jnp.bfloat16, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 20)))

    def logits(params):
        return D.prefill(tlm, params, D.init_cache(tlm, 2, 20), toks)[0]

    master = logits(tp)
    assert torch.equal(logits(tlm.registry.cast(tp, torch.bfloat16)), master)
    blanket = unflatten_from_paths({n: t.to(torch.bfloat16) for n, t in tflat(tp).items()})
    assert not torch.equal(logits(blanket), master)


def test_serve_reads_a_log_and_dt_bias_in_float32(monkeypatch, capsys):
    """The serve launcher's path: every Mamba layer sees float32 a_log and
    dt_bias, and bf16 for every other weight it casts per use."""
    seen = []
    mamba = LM._mamba

    def spy(self, p, x, **kw):
        seen.append({k: v.dtype for k, v in p.items()})
        return mamba(self, p, x, **kw)

    monkeypatch.setattr(LM, "_mamba", spy)
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "1",
                       "--prompt-len", "8", "--gen", "3"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["mode"] == "random_init" and len(record["tokens"][0]) == 3
    assert len(seen) == 2  # prefill only: two layers
    for dtypes in seen:
        assert dtypes["a_log"] == dtypes["dt_bias"] == torch.float32
        assert dtypes["in_proj"] == dtypes["out_proj"] == torch.bfloat16


# ---------------------------------------------------------------------------
# what this slice does not port
# ---------------------------------------------------------------------------


def test_training_refuses_the_ssm_family(tmp_path):
    """The SSM family trains since the hybrid slice (the name is the one
    this test had while it was refused): one reduced mamba2 step through
    ``Trainer`` and one through the train CLI, finite loss and gradient
    norm, a committed checkpoint."""
    from repro_torch.core.layout import MeshSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.train.trainer import Trainer

    cfg = TC.reduced(TC.get_config(ARCH))
    tr = Trainer.create(cfg, TC.ParallelismConfig(), TC.TrainConfig(),
                        MeshSpec.from_dict({"data": 1, "model": 1}),
                        batch_size=2, seq_len=8, device="cpu")
    state, (rec,) = tr.run(tr.init_state(), 0, 1)
    assert state.step == 1 and np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    assert rec["aux"] == 0.0
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                           "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path / "ck"),
                           "--save-interval", "1", "--sync-save"]) == 0
    assert (tmp_path / "ck" / "step_00000001" / "COMMIT").exists()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x22b", "deepseek-v2-236b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_other_families_still_refused(arch):
    """Every family builds since the cross-attention slice (the name is the
    one this test had while some were refused): mixtral (MoE, the eighth
    slice) with its expert tensors, deepseek-v2 (MLA, the ninth) with its
    latent projections, jamba (the hybrid, the tenth) with its MoE
    attention layer in a period, llama-vision (the eleventh) with its
    ``periods`` of four self layers and a gated cross layer, and whisper
    with its ``encoder.blk.*`` group beside the ``dec_layers``."""
    cfg = TC.reduced(TC.get_config(arch))
    if arch == "jamba-1.5-large-398b":
        lm = build_model(cfg)
        assert [s.name for s in lm.stages] == ["periods"]
        assert lm.registry["periods.p4_attn.we_gate"].kind == "moe_expert"
        return
    if arch == "mixtral-8x22b":
        lm = build_model(cfg)
        assert [s.name for s in lm.stages] == ["layers"] and lm.stages[0].body[0].moe
        assert lm.registry["layers.blk.we_gate"].kind == "moe_expert"
        return
    if arch == "deepseek-v2-236b":
        lm = build_model(cfg)
        assert [s.name for s in lm.stages] == ["head", "layers"]
        assert lm.registry["layers.blk.wkv_b"].axes == ("layers", "lora", "heads")
        return
    lm = build_model(cfg)
    if arch == "llama-3.2-vision-11b":
        (stage,) = lm.stages
        assert (stage.name, [ld.name for ld in stage.body]) == (
            "periods", ["self0", "self1", "self2", "self3", "cross"])
        assert lm.registry["periods.cross.cross_wkv"].kind == "fused_qkv"
        assert lm.registry["periods.cross.cross_gate"].axes == ("layers", "scalar")
        return
    assert [(s.name, [(ld.name, ld.with_cross) for ld in s.body]) for s in lm.stages] == [
        ("dec_layers", [("blk", True)])]
    names = [d.path for d in lm.registry]
    assert {"encoder.blk.wqkv", "encoder.blk.w1", "encoder.norm", "dec_layers.blk.cross_wkv"} \
        <= set(names)
