"""The serving slice as a whole, held against the JAX package.

Reference params go into the port through ``params_from_reference``; the
port's ``prefill`` plus 4 ``decode_step``s then run on the same tokens as
the reference ``D.prefill``/``D.decode_step``:

* at float32 the logits agree within 1e-4 and the greedy tokens are equal;
* at bfloat16 the logits agree within 0.1.  Both packages round to bf16
  after every matmul and elementwise op, but not at the same places (XLA
  fuses and upcasts some elementwise chains on the CPU, PyTorch does not),
  so a few bf16 ulps at the logits' magnitude (|logit| ≲ 3, ulp 2⁻⁶ at 2–4)
  separate them after 4 layers; measured max 0.04.

The launcher is driven as a user would: ``python -m repro_torch.launch.serve
--device cpu`` on a checkpoint written under data=2,model=2 restores
RESHARD_STREAM under data=1,model=1 and DIRECT under data=2,model=2, and the
two give the same greedy tokens.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode as RD  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.saver import snapshot_weights, write_distributed  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(arch, jdt, tdt, seed=0):
    rlm = ref_build(RC.reduced(RC.get_config(arch)), compute_dtype=jdt, remat="none")
    tlm = build_model(TC.reduced(TC.get_config(arch)), compute_dtype=tdt)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _run_both(arch, jdt, tdt, steps=4, b=2, s=12):
    rlm, rp, tlm, tp = _pair(arch, jdt, tdt)
    toks = np.random.default_rng(0).integers(0, tlm.cfg.vocab_size, (b, s))
    rc = RD.init_cache(rlm, b, s + steps + 1)
    tc = D.init_cache(tlm, b, s + steps + 1)
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks, jnp.int32))
    tl, tc = D.prefill(tlm, tp, tc, torch.from_numpy(toks))
    pairs = [(np.asarray(rl), tl.numpy())]
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    tokens = [(cur, tl.argmax(-1)[:, None].numpy())]
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm, tp, tc, torch.from_numpy(cur.copy()))
        pairs.append((np.asarray(rl), tl.numpy()))
        cur = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        tokens.append((cur, tl[:, -1].argmax(-1)[:, None].numpy()))
    assert int(tc["pos"][0]) == int(rc["pos"][0]) == s + steps
    np.testing.assert_array_equal(
        tc["layers"]["blk"]["slot_pos"].numpy(), np.asarray(rc["layers"]["blk"]["slot_pos"])
    )
    return pairs, tokens


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-12b", "gpt3-350m"])
def test_prefill_decode_float32_match_reference(arch):
    """smollm is the slice; gemma3 adds per-layer local:global windows,
    gpt3 the GELU MLP — the rest of the dense family."""
    pairs, tokens = _run_both(arch, jnp.float32, torch.float32)
    for ref, port in pairs:
        assert port.dtype == np.float32 and port.shape == ref.shape
        np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
    for ref, port in tokens:
        np.testing.assert_array_equal(port, ref)


def test_prefill_decode_bfloat16_match_reference():
    pairs, _ = _run_both("smollm-360m", jnp.bfloat16, torch.bfloat16)
    for ref, port in pairs:
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, atol=0.1, rtol=0)


def test_cache_matches_reference_after_prefill():
    """The port writes the reference's cache: same roped K/V in the same ring
    slots (float32, so the values agree to rounding)."""
    rlm, rp, tlm, tp = _pair("smollm-360m", jnp.float32, torch.float32)
    toks = np.random.default_rng(1).integers(0, 256, (2, 9))
    rc = RD.prefill(rlm, rp, RD.init_cache(rlm, 2, 6), jnp.asarray(toks, jnp.int32))[1]
    tc = D.prefill(tlm, tp, D.init_cache(tlm, 2, 6), torch.from_numpy(toks))[1]
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tc["layers"]["blk"][key].numpy(), np.asarray(rc["layers"]["blk"][key]), atol=1e-5
        )


def _serve(ckpt_dir, mesh, arch="smollm-360m"):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--reduced", "--ckpt-dir", str(ckpt_dir),
         "--mesh", mesh, "--batch", "2", "--prompt-len", "8", "--gen", "6"],
        capture_output=True, text=True, env=env, timeout=300, check=False,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_serve_cli_reshard_stream_equals_direct(tmp_path):
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 2})
    parallel = TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    plan = TS.make_plan(cfg, lm.registry, parallel, mesh)
    params = lm.init(torch.Generator().manual_seed(3))
    write_distributed(snapshot_weights(params), plan, 5, tmp_path / "ck" / "step_00000005")
    stream = _serve(tmp_path / "ck", "data=1,model=1")
    direct = _serve(tmp_path / "ck", "data=2,model=2")
    assert (stream["mode"], stream["step"]) == ("reshard_stream", 5)
    assert (direct["mode"], direct["step"]) == ("direct", 5)
    assert stream["device"] == direct["device"] == "cpu"
    assert np.asarray(stream["tokens"]).shape == (2, 6)
    assert stream["tokens"] == direct["tokens"]


def test_serve_cli_mamba2_reshard_stream_equals_direct(tmp_path):
    """The SSM slice through the launcher: a reduced mamba2 checkpoint saved
    under data=2,model=2 (the five-part in_proj split over the model axis)
    serves the same greedy tokens restored RESHARD_STREAM and DIRECT."""
    cfg = TC.reduced(TC.get_config("mamba2-130m"))
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 2})
    parallel = TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    plan = TS.make_plan(cfg, lm.registry, parallel, mesh)
    params = lm.init(torch.Generator().manual_seed(3))
    write_distributed(snapshot_weights(params), plan, 7, tmp_path / "ck" / "step_00000007")
    stream = _serve(tmp_path / "ck", "data=1,model=1", arch="mamba2-130m")
    direct = _serve(tmp_path / "ck", "data=2,model=2", arch="mamba2-130m")
    assert (stream["mode"], stream["step"]) == ("reshard_stream", 7)
    assert (direct["mode"], direct["step"]) == ("direct", 7)
    assert np.asarray(stream["tokens"]).shape == (2, 6)
    assert stream["tokens"] == direct["tokens"]
