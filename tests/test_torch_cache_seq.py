"""Decode from a cache sharded over its length (``shard_cache_seq``), on the
CPU, held against one process and the JAX package.

One gloo world of 2 ranks (``run_world`` of ``tests/test_torch_multirank.py``)
serves six models under data=1,model=2 with
``ParallelismConfig(shard_cache_seq=True)``, in fp32: a prefill of 6
positions into a cache of 16 (12 for gemma3), then 8 greedy decode steps.
The models:

* ``dense``: reduced smollm-360m at smollm's 3:1 ratio with 1 KV head (3:1,
  not 15:5: the reduced config keeps 2 KV heads, which divide model=2), so
  ``k``/``v`` and ``slot_pos`` shard over their length and attention is
  computed whole on every rank from the gathered weights;
* ``mla``: reduced deepseek-v2 (2 heads, by heads at model=2), its latent
  ``c_kv``/``k_rope`` and ``slot_pos`` over their length;
* ``windowed``: reduced gemma3-12b at 2:1 heads, whose layers (windows of
  8, every sixth global) keep rings of 12 slots (6 a rank) that wrap
  during the decode (14 positions);
* ``mixed``: reduced smollm-360m (6:2), ``k``/``v`` by KV heads and
  ``slot_pos`` over its length;
* ``cross``: reduced llama-3.2-vision-11b at 2:1 heads with its gates set
  to 0.5, the cross layer's ``ck``/``cv`` sharded over the 8 source
  positions beside the self layers' rings;
* ``encdec``: reduced whisper-tiny at 2:1 heads, each decoder layer's
  ``ck``/``cv`` over the encoder's 8 positions.

Each rank's cache equals the ``cache_pspecs`` slice of one process's after
the prefill and every step; the logits are within 1e-5 of one process's and
of the reference's unsharded decode (``init_cache``/``prefill``/
``decode_step``), and the greedy tokens are equal.  The reference is
imported lazily, so the spawned ranks load no JAX.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    RankGroups, cache_pspecs, make_plan, vocab_multiple,
)
from repro_torch.dist.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from test_torch_multirank import _ref, run_world  # noqa: E402

MESH = {"data": 1, "model": 2}
B, PROMPT, STEPS = 2, 6, 8
CACHE = {"dense": 16, "mla": 16, "windowed": 12, "mixed": 16, "cross": 16, "encdec": 16}
ATOL = 1e-5
# (arch, (q heads, KV heads) or None for the reduced config's)
MODELS = {"dense": ("smollm-360m", (3, 1)), "mla": ("deepseek-v2-236b", None),
          "windowed": ("gemma3-12b", (2, 1)), "mixed": ("smollm-360m", None),
          "cross": ("llama-3.2-vision-11b", (2, 1)), "encdec": ("whisper-tiny", (2, 1))}
GATE = 0.5  # the vlm's cross gates: tanh(0), the initial value, would hide the cross layers
MODULE = "test_torch_cache_seq"


def _cfg(pkg, name: str):
    arch, heads = MODELS[name]
    cfg = pkg.reduced(pkg.get_config(arch))
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
    return cfg


def _parallel(mesh: MeshSpec) -> TC.ParallelismConfig:
    return dataclasses.replace(serve.serving_parallelism(mesh), shard_cache_seq=True)


def _lm(name: str, mesh: MeshSpec):
    cfg = _cfg(TC, name)
    par = _parallel(mesh)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh), compute_dtype=torch.float32,
                     remat="none")
    return lm, make_plan(cfg, lm.registry, par, mesh)


def _prompts(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (B, PROMPT))


def _source(cfg) -> np.ndarray | None:
    """The source embeds of a vlm (patches) or encdec (frames) config."""
    if cfg.cross_attn is not None:
        shape = (B, cfg.cross_attn.source_len, cfg.cross_attn.source_dim)
    elif cfg.encoder is not None:
        shape = (B, cfg.encoder.source_len, cfg.d_model)
    else:
        return None
    return np.random.default_rng(8).standard_normal(shape).astype(np.float32)


def _source_t(cfg):
    src = _source(cfg)
    return None if src is None else torch.from_numpy(src)


def _flat_cache(cache) -> dict:
    return {n: t.clone() for n, t in flatten_with_paths(cache).items()}


# ---------------------------------------------------------------------------
# the ranks


def serve_world(rank, out, weights):
    """Every model served by this rank: its cache and gathered logits after
    the prefill and each decode step, and its greedy tokens."""
    mesh = MeshSpec.from_dict(MESH)
    res = {}
    for name in MODELS:
        lm, plan = _lm(name, mesh)
        cfg = lm.cfg
        ranks = RankGroups.create(dist.group.WORLD, plan, _parallel(mesh))
        lm.tp = TensorParallel(ranks, cfg)
        w = {k[len(name) + 1:]: v for k, v in weights.items() if k.startswith(name + ":")}
        full = flatten_with_paths(params_from_reference(w, lm, "cpu"))
        local = {n: slice_shard(x, plan.param_specs[n].layout_for(StateKind.FP32, mesh), rank)
                 for n, x in full.items()}
        params = unflatten_from_paths(serve.rank_weights(lm, ranks, local))
        cache = D.init_cache(lm, B, CACHE[name])
        caches, logits, tokens = [], [], []
        with torch.inference_mode():
            lg, cache = D.prefill(lm, params, cache, torch.from_numpy(_prompts(cfg)).long(),
                                  source_embeds=_source_t(cfg))
            for step in range(STEPS + 1):
                caches.append(_flat_cache(cache))
                logits.append(lm.tp.gather_vocab(lg, cfg.vocab_size).clone())
                cur = D.greedy(lm, lg)[:, None]
                tokens.append(cur.clone())
                if step == STEPS:
                    break
                lg, cache = D.decode_step(lm, params, cache, cur)
                lg = lg[:, -1]
        res[name] = {"caches": caches, "logits": logits, "tokens": torch.cat(tokens, 1)}
    return res


# ---------------------------------------------------------------------------
# fixtures


def _reference_model(name: str):
    """The reference's model, its weights and their flat numpy copy."""
    import jax
    import jax.numpy as jnp

    repro = _ref()
    from repro.core.pytree import flatten_with_paths as rflat
    from repro.core.pytree import unflatten_from_paths as runflat
    from repro.models import build_model as ref_build

    rlm = ref_build(_cfg(repro.configs, name), compute_dtype=jnp.float32, remat="none")
    w = {k: np.asarray(v) for k, v in rflat(rlm.init(jax.random.PRNGKey(0))).items()}
    w.update({k: np.full_like(v, GATE) for k, v in w.items() if k.endswith("cross_gate")})
    return rlm, runflat({k: jnp.asarray(v) for k, v in w.items()}), w


def _reference_decode(name: str, rlm, rp) -> list[np.ndarray]:
    """The reference's unsharded decode: logits after the prefill and each
    step, feeding its own greedy tokens."""
    import jax.numpy as jnp
    from repro.models import decode as RD

    rc = RD.init_cache(rlm, B, CACHE[name])
    src = _source(rlm.cfg)
    lg, rc = RD.prefill(rlm, rp, rc, jnp.asarray(_prompts(rlm.cfg)),
                        source_embeds=None if src is None else jnp.asarray(src))
    logits = [np.asarray(lg, np.float32)]
    for _ in range(STEPS):
        cur = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        lg, rc = RD.decode_step(rlm, rp, rc, cur)
        lg = lg[:, -1]
        logits.append(np.asarray(lg, np.float32))
    return logits


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's (weights, logits), one process's (lm, caches,
    logits, tokens) and the ranks' results, by model.  The ranks run while
    this process decodes."""
    out = tmp_path_factory.mktemp("cache_seq")
    models = {name: _reference_model(name) for name in MODELS}
    np.savez(out / "weights.npz", **{f"{name}:{k}": v for name, (_, _, w) in models.items()
                                      for k, v in w.items()})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, out, 2, "serve_world", module=MODULE)
        refs = {name: (w, _reference_decode(name, rlm, rp))
                for name, (rlm, rp, w) in models.items()}
        ones = {name: _one_process(name, refs[name][0]) for name in MODELS}
        return refs, ones, ranks.result()


def _one_process(name: str, weights: dict):
    """One process's decode of the same weights and prompts: its cache
    after the prefill and each step, logits and greedy tokens."""
    lm, _ = _lm(name, MeshSpec.from_dict(MESH))
    params = params_from_reference(weights, lm, "cpu")
    cache = D.init_cache(lm, B, CACHE[name])
    caches, logits, tokens = [], [], []
    with torch.inference_mode():
        lg, cache = D.prefill(lm, params, cache, torch.from_numpy(_prompts(lm.cfg)).long(),
                              source_embeds=_source_t(lm.cfg))
        for step in range(STEPS + 1):
            caches.append(_flat_cache(cache))
            logits.append(lg.clone())
            cur = lg.argmax(-1)[:, None]
            tokens.append(cur)
            if step == STEPS:
                break
            lg, cache = D.decode_step(lm, params, cache, cur)
            lg = lg[:, -1]
    return lm, caches, logits, torch.cat(tokens, 1)


def _spec_slice(t: torch.Tensor, spec, mesh: MeshSpec, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` laid out by the PartitionSpec ``spec``."""
    coords = mesh.coords(rank)
    for dim, e in enumerate(tuple(spec)):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        parts, idx = 1, 0
        for a in axes:
            idx, parts = idx * mesh.axis_size(a) + coords[a], parts * mesh.axis_size(a)
        n = t.shape[dim] // parts
        t = t.narrow(dim, idx * n, n)
    return t


# ---------------------------------------------------------------------------
# the checks


@pytest.mark.parametrize("name", list(MODELS))
def test_rank_caches_are_the_cache_pspecs_slices_of_one_process(worlds, name):
    _, ones, ranks = worlds
    lm, caches, _, _ = ones[name]
    mesh = MeshSpec.from_dict(MESH)
    specs = flatten_with_paths(cache_pspecs(D.init_cache(lm, B, CACHE[name], device="meta"),
                                            _parallel(mesh), mesh))
    seq = [p for p, s in specs.items() if len(s) > 2 and s[2] is not None]
    assert seq  # the case shards some entry over its length
    if name == "mixed":  # k/v by KV heads, slot_pos by length
        assert all(p.endswith("slot_pos") for p in seq)
    if name in ("cross", "encdec"):  # the source K/V over its positions
        assert {p.split(".")[-1] for p in seq} >= {"ck", "cv"}
    for r, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[name]["caches"], caches, strict=True)):
            # a rank's cache also holds its rings' whole length
            assert got.keys() == want.keys() | {"cache_len"}
            assert int(got["cache_len"]) == CACHE[name]
            for path, full in want.items():
                exp = _spec_slice(full, specs[path], mesh, r)
                assert got[path].shape == exp.shape, (r, step, path)
                torch.testing.assert_close(got[path], exp, atol=ATOL, rtol=0,
                                           msg=f"rank {r} step {step} {path}")


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_tokens_equal_one_process_and_the_reference(worlds, name):
    refs, ones, ranks = worlds
    _, _, logits, tokens = ones[name]
    ref_logits = refs[name][1]
    for step, (one, ref) in enumerate(zip(logits, ref_logits, strict=True)):
        np.testing.assert_allclose(one.numpy(), ref, atol=ATOL, rtol=0, err_msg=str(step))
        for r, res in enumerate(ranks):
            got = res[name]["logits"][step].numpy()
            np.testing.assert_allclose(got, one.numpy(), atol=ATOL, rtol=0,
                                       err_msg=f"rank {r} step {step}")
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0,
                                       err_msg=f"rank {r} step {step}")
    for res in ranks:
        assert torch.equal(res[name]["tokens"], tokens)


def test_windowed_rings_wrap_during_the_decode(worlds):
    """gemma3's rings of 12 slots (6 a rank) take 14 positions: rank 0's
    first two slots hold positions 12 and 13 (written over 0 and 1), rank
    1's the positions 6 to 11."""
    _, _, ranks = worlds
    first = ranks[0]["windowed"]["caches"][-1]["layers.blk.slot_pos"]
    second = ranks[1]["windowed"]["caches"][-1]["layers.blk.slot_pos"]
    assert first.shape[-1] == second.shape[-1] == 6
    assert (first == torch.tensor([12, 13, 2, 3, 4, 5], dtype=torch.int32)).all()
    assert (second == torch.arange(6, 12, dtype=torch.int32)).all()
