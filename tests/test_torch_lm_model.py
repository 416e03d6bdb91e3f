"""The port's LM models against the JAX package's, on the CPU: hymba-1.5b
and mamba2-130m smoke configs (B 2, S 96) through ``forward``,
teacher-forced ``decode_step`` and greedy ``generate``.

The reference's params (``T.init_params(jax.random.key(0), cfg)``) cross
through ``convert.lm_params_from_numpy``; tokens come from numpy. All in
float32. Tolerances as in tests/test_torch_lm.py: |port - reference| <=
1e-4 * max|reference| for logits, and the reference's own 2e-2 *
max|logits| for decode against forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODEL_TOL = 1e-4
ARCHS = ("hymba-1.5b", "mamba2-130m")


def t(a):
    return torch.tensor(np.asarray(a))


def model_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), (err, np.abs(want).max())


# -- whole models -------------------------------------------------------------

def crossed(arch):
    """(port cfg, port params, reference cfg, reference params)."""
    jcfg = jax_configs.get_smoke_config(arch)
    jparams, _ = JT.init_params(jax.random.key(0), jcfg)
    cfg = configs.get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def port_decode(params, cfg, toks):
    """Teacher-forced decode over ``toks``: (B, S, V) step logits."""
    b, s = toks.shape
    out = []
    with torch.inference_mode():
        caches = T.init_cache(cfg, b, s, device="cpu")
        for i in range(s):
            lg, caches = T.decode_step(params, cfg,
                                       {"tokens": t(toks[:, i:i + 1])},
                                       caches)
            out.append(lg)
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_the_reference(arch):
    """B 2, S 96: hymba's window of 32 and three 32-step SSD chunks."""
    cfg, params, jcfg, jparams = crossed(arch)
    toks = tokens(cfg, 2, 96, 15)
    want, _ = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    ops.reset_dispatch()
    with torch.inference_mode():
        got, aux = T.forward(params, cfg, {"tokens": t(toks)})
    model_close(got, want)
    assert aux["final_hidden"].shape == (2, 96, cfg.d_model)
    n_layers = cfg.n_layers
    assert ops.dispatch_breakdown()["ssd_chunk"] == {
        "torch-ref": n_layers * 3}

    # Teacher-forced decode, step by step, against T.decode_step.
    step = jax.jit(lambda p, b, c: JT.decode_step(p, jcfg, b, c))
    caches = JT.init_cache(jcfg, 2, 96)
    dec = port_decode(params, cfg, toks)
    for i in range(96):
        lg, caches = step(jparams, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                          caches)
        model_close(dec[:, i], lg)
    # Decode equals forward (the reference's criterion).
    scale = got[:, -1].abs().max().item()
    assert (dec[:, -1] - got[:, -1]).abs().max().item() < 2e-2 * scale
    if arch == "hymba-1.5b":
        assert ops.dispatch_breakdown()["flash_decode"] == {
            "torch-ref": n_layers * 96}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch):
    cfg, params, jcfg, jparams = crossed(arch)
    prompts = tokens(cfg, 2, 8, 16)
    want = np.asarray(jax_serve.generate(jcfg, jparams,
                                         jnp.asarray(prompts), 16))
    got = serve.generate(cfg, params, t(prompts), 16)
    assert got.dtype == torch.int32 and got.shape == (2, 24)
    assert np.array_equal(got[:, :8].numpy(), prompts)
    # Tokens equal up to the first step whose top-2 margin (in the port's
    # own logits) is within the model tolerance: there a tie may break
    # either way.
    logits = port_decode(params, cfg, got[:, :-1].numpy())
    logits = logits[..., :cfg.vocab_size]
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    tol = MODEL_TOL * logits.abs().max().item()
    for row in range(2):
        for i in range(8, 24):
            if margin[row, i - 1] <= tol:
                break
            assert got[row, i].item() == want[row, i], (row, i)


def test_params_cross_in_bfloat16_bit_for_bit():
    jcfg = jax_configs.get_smoke_config("hymba-1.5b",
                                        param_dtype="bfloat16",
                                        activation_dtype="bfloat16")
    jparams, _ = JT.init_params(jax.random.key(0), jcfg)
    cfg = configs.get_smoke_config("hymba-1.5b", param_dtype="bfloat16",
                                   activation_dtype="bfloat16")
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda a: a, params)))
    w = params["groups"][1]["attn"]["wq"]
    jw = np.asarray(jparams["groups"][1]["attn"]["wq"])
    assert w.dtype == torch.bfloat16 and w.shape == jw.shape == (2, 80, 5, 16)
    assert np.array_equal(w.view(torch.int16).numpy(), jw.view(np.int16))
    # The port's own init: the reference's shapes and dtypes throughout.
    own = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    ours = jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).replace("torch.", "")), own)
    assert ours == shapes
    with torch.inference_mode():
        logits, _ = T.forward(own, cfg, {"tokens": t(tokens(cfg, 1, 40, 17))})
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


def test_serve_cli_on_the_cpu(capsys):
    report = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "4", "--gen", "4"])
    assert set(report) >= {"arch", "batch", "tokens_total", "wall_s",
                           "tok_per_s", "sample_row"}
    assert report["arch"] == "mamba2-130m-smoke"
    assert report["tokens_total"] == 16 and len(report["sample_row"]) == 8
    assert '"tok_per_s"' in capsys.readouterr().out
