"""``remat="dots"``: the backward pass keeps the outputs of the matmuls with
no batch dims (``aten.mm``/``aten.addmm``, every projection) and recomputes
the rest, the counterpart of the reference's
``dots_with_no_batch_dims_saveable`` policy.

* Three train steps of a dense (smollm-360m), a MoE (mixtral-8x22b) and a
  cross-attention (llama-3.2-vision-11b, with its source embeds) reduced
  config under ``"dots"`` and under ``"full"``: the losses, every gradient
  and the updated parameters bit-equal (a selective checkpoint changes
  what is kept, not what is computed).
* The policy is in force: the backward under ``"dots"`` runs no projection
  again (as many ``mm`` calls as ``"none"``), where ``"full"`` runs four a
  layer again.
* The train CLI takes ``--remat dots``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

ARCHS = ["smollm-360m", "mixtral-8x22b", "llama-3.2-vision-11b"]


def _batch(cfg, step):
    rng = np.random.default_rng(10 + step)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17))).long()}
    if cfg.cross_attn is not None:
        ca = cfg.cross_attn
        out["source_embeds"] = torch.from_numpy(
            rng.standard_normal((2, ca.source_len, ca.source_dim)).astype(np.float32))
    return out


def _grads(lm, params, batch):
    leaves = {n: t.detach().requires_grad_(True) for n, t in flatten_with_paths(params).items()}
    loss, _ = lm.loss_fn(unflatten_from_paths(leaves), batch)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _with_gates(cfg, params):
    """A nonzero gate (the init is 0: the cross layer would add nothing)."""
    if cfg.cross_attn is not None:
        params["periods"]["cross"]["cross_gate"].fill_(0.7)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_full_over_three_steps(arch):
    cfg = TC.reduced(TC.get_config(arch))
    lms = {r: build_model(cfg, compute_dtype=torch.float32, remat=r) for r in ("dots", "full")}
    params = _with_gates(cfg, lms["full"].init(torch.Generator().manual_seed(0)))
    states = {r: init_state(unflatten_from_paths(
        {n: t.clone() for n, t in flatten_with_paths(params).items()})) for r in lms}
    steps = {r: make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig())
             for r, lm in lms.items()}
    for i in range(3):
        batch = _batch(cfg, i)
        (ld, gd), (lf, gf) = (_grads(lms[r], states[r].params, batch) for r in ("dots", "full"))
        assert torch.equal(ld, lf), (i, float(ld), float(lf))
        assert gd.keys() == gf.keys()
        for name in gd:
            assert torch.equal(gd[name], gf[name]), (i, name)
        for r in lms:
            states[r], _ = steps[r](states[r], batch)
    for name, t in flatten_with_paths(states["dots"].params).items():
        assert torch.equal(t, flatten_with_paths(states["full"].params)[name]), name


def test_dots_recomputes_no_projection():
    """Count ``aten.mm`` over one forward and backward: ``"full"`` runs each
    layer's projections again in the backward, ``"dots"`` does not."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    cfg = TC.reduced(TC.get_config("smollm-360m"))
    counts = {}
    for remat in ("none", "dots", "full"):
        lm = build_model(cfg, compute_dtype=torch.float32, remat=remat)
        params = lm.init(torch.Generator().manual_seed(0))
        with CountMM() as c:
            _grads(lm, params, _batch(cfg, 0))
        counts[remat] = c.n
    # "full" recomputes each layer up to its last saved input: wqkv, wo,
    # w_gate and w_up again (w_down's output feeds only the residual sum)
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 4 * cfg.num_layers


def test_train_cli_takes_remat_dots(tmp_path, capsys):
    import json

    from repro_torch.launch import train as train_cli

    assert train_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "16", "--remat", "dots",
                           "--log-json"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)


def test_build_refuses_an_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        build_model(TC.reduced(TC.get_config("smollm-360m")), remat="some")
