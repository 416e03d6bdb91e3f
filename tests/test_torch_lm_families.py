"""The port's whole LM families against the JAX package's, on the CPU:
``forward`` (with its aux) and teacher-forced ``decode_step`` at the smoke
configs of deepseek-v2-lite (MLA + softmax MoE), deepseek-v3 (q-LoRA MLA,
sigmoid MoE with bias, the MTP block's params), musicgen-medium (audio
frames, cross-attention, codebook heads), internvl2-2b (vision patches),
gemma3-12b (local / global pattern; also with a decode logit softcap),
qwen1.5-32b, granite-20b and nemotron-4-340b; the int8 KV cache's decode
for qwen and granite; every registered architecture's param tree.

The reference's params (``T.init_params(jax.random.key(0), cfg)``) cross
through ``convert.lm_params_from_numpy``; tokens and embeddings come from
numpy. All in float32. Tolerances: |port - reference| <= 1e-4 *
max|reference| (``MODEL_TOL``, as tests/test_torch_lm_model.py), and the
reference's own 2e-2 * max|logits| for decode against forward
(tests/test_models.py) and 5e-2 for the int8 cache's decode against the
float forward (tests/test_kv_quant.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODEL_TOL = 1e-4
B = 2


def seq_len(cfg) -> int:
    """72 where a window (gemma3's smoke window is 64) must wrap its ring
    and switch the forward to the local path; 40 otherwise."""
    windows = [b.attn.window for b in cfg.blocks
               if b.attn is not None and b.attn.window]
    return 72 if windows else 40


def t(a):
    return torch.tensor(np.asarray(a))


def model_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def with_attn(cfg, **kw):
    return dataclasses.replace(cfg, blocks=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, **kw))
        for b in cfg.blocks))


def reference_params(jcfg):
    """``JT.init_params(jax.random.key(0), jcfg)[0]``, jitted (the same
    draws; eager init dispatches every op of every layer)."""
    return jax.jit(lambda k: JT.init_params(k, jcfg)[0])(jax.random.key(0))


def crossed(arch, **kw):
    """(port cfg, port params, reference cfg, reference params); ``kw``
    replaces fields of every attention spec."""
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if kw:
        jcfg, cfg = with_attn(jcfg, **kw), with_attn(cfg, **kw)
    jparams = reference_params(jcfg)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


def inputs(cfg, seed):
    """The forward batch (numpy) and the per-step decode batches."""
    rng = np.random.default_rng(seed)
    S = seq_len(cfg)
    if cfg.frontend == "audio_frames":
        batch = {"frame_embeds": rng.normal(size=(B, S, cfg.d_model)),
                 "cond_embeds": rng.normal(size=(B, cfg.n_cond_tokens,
                                                 cfg.d_model))}
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
        steps = [{"frame_embeds": batch["frame_embeds"][:, i:i + 1],
                  "cond_embeds": batch["cond_embeds"]} for i in range(S)]
        return batch, steps
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision_patches":
        batch["patch_feats"] = rng.normal(
            size=(B, cfg.n_patches, T.VIT_DIM)).astype(np.float32)
    return batch, [{"tokens": toks[:, i:i + 1]} for i in range(S)]


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: t(v) for k, v in batch.items()}


FAMILIES = {
    "deepseek-v2-lite-16b": {},
    "deepseek-v3-671b": {},
    "musicgen-medium": {},
    "internvl2-2b": {},
    "gemma3-12b": {},
    "gemma3-12b+softcap": {"logit_softcap": 5.0},
    "qwen1.5-32b": {},
    "granite-20b": {},
    "nemotron-4-340b": {},
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_forward_and_decode_match_the_reference(case):
    """B 2, S 40 or 72 (plus 16 patches for internvl2): forward's logits and
    aux, then every teacher-forced decode step, against the reference;
    the last decode step against forward (a vision model decodes its
    text tokens only, so its decode is held to the reference's decode)."""
    cfg, params, jcfg, jparams = crossed(case.split("+")[0],
                                         **FAMILIES[case])
    batch, steps = inputs(cfg, 40)
    S = len(steps)
    want, jaux = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        jparams, to_jax(batch))
    with torch.inference_mode():
        got, aux = T.forward(params, cfg, to_port(batch))
    model_close(got, want)
    assert sorted(aux) == sorted(jaux)
    for k, v in jaux.items():
        if k.startswith("expert_counts"):
            assert np.array_equal(aux[k].numpy(), np.asarray(v))
        elif k == "lb_loss":
            np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5)
        else:
            model_close(aux[k], v)
    if cfg.n_codebooks > 1:
        assert got.shape == (B, S, cfg.n_codebooks, cfg.padded_vocab)

    step = jax.jit(lambda p, b, c: JT.decode_step(p, jcfg, b, c))
    jcaches = JT.init_cache(jcfg, B, S)
    ops.reset_dispatch()
    with torch.inference_mode():
        caches = T.init_cache(cfg, B, S, device="cpu")
        for sb in steps:
            lg, jcaches = step(jparams, to_jax(sb), jcaches)
            dec, caches = T.decode_step(params, cfg, to_port(sb), caches)
            model_close(dec, lg)
    n_gqa = sum(b.repeat for b in cfg.blocks if b.attn.kind == "gqa")
    assert ops.dispatch_breakdown().get("flash_decode", {}) == (
        {"torch-ref": n_gqa * S} if n_gqa else {})
    if cfg.frontend != "vision_patches":
        last = got[:, -1]
        scale = last.abs().max().item()
        assert (dec - last).abs().max().item() < 2e-2 * scale


def same_quant_rows(caches, jcaches) -> bool:
    """Whether every layer of the port's int8 caches holds the reference's
    rows and scales; where not, they lie a rounding boundary apart (one
    int8 step: the two sides' K / V differ in the last bit) and the
    reference's are copied in, so the next steps start from one
    quantized state again."""
    same = True
    for gc, jgc in zip(caches, jcaches):
        for i, layer in enumerate(gc):
            for name in ("k_q", "v_q", "k_s", "v_s"):
                got = layer["attn"][name]
                want = np.asarray(jgc["attn"][name][i])
                if np.array_equal(got.numpy(), want):
                    continue
                same = False
                if name.endswith("_q"):
                    assert np.abs(got.numpy().astype(np.int32)
                                  - want.astype(np.int32)).max() == 1
                else:
                    np.testing.assert_allclose(
                        got.float().numpy(), want.astype(np.float32),
                        rtol=1e-3)
                got.copy_(t(want))
    return same


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "granite-20b"])
def test_int8_cache_decode_matches_the_reference(arch):
    """B 2, S 64 (the reference's tests/test_kv_quant.py case): every
    teacher-forced step equals the reference's int8-cache decode within
    MODEL_TOL wherever both sides hold the same int8 rows, and the last
    step equals the port's float forward within 5e-2 * max|logits|. The
    int8 cache takes about half the bf16 cache's bytes."""
    cfg, params, jcfg, jparams = crossed(arch)
    cfgq = dataclasses.replace(cfg, kv_cache_quant=True)
    jcfgq = dataclasses.replace(jcfg, kv_cache_quant=True)
    s = 64
    toks = np.random.default_rng(41).integers(
        0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    step = jax.jit(lambda p, b, c: JT.decode_step(p, jcfgq, b, c))
    jcaches = JT.init_cache(jcfgq, B, s)
    compared = 0
    with torch.inference_mode():
        fwd, _ = T.forward(params, cfg, {"tokens": t(toks)})
        caches = T.init_cache(cfgq, B, s, device="cpu")
        for i in range(s):
            sb = {"tokens": toks[:, i:i + 1]}
            lg, jcaches = step(jparams, to_jax(sb), jcaches)
            dec, caches = T.decode_step(params, cfgq, to_port(sb), caches)
            if same_quant_rows(caches, jcaches):
                model_close(dec, lg)
                compared += 1
    assert compared >= s - 8, compared
    last = fwd[:, -1]
    assert (dec - last).abs().max().item() < 5e-2 * last.abs().max().item()

    def nbytes(c):
        return sum(v.numel() * v.element_size() for g in c for layer in g
                   for v in layer["attn"].values())
    full = T.init_cache(cfg, 4, 1024, "bfloat16", device="cpu")
    quant = T.init_cache(cfgq, 4, 1024, "bfloat16", device="cpu")
    assert nbytes(full) / nbytes(quant) > 1.8


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_own_init_has_the_reference_tree(arch):
    """``T.init_params`` draws the reference's tree: keys, shapes and
    dtypes (the MTP block, codebook heads, patch projection, float32
    routers and router bias included)."""
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.key(0),
                                                 jcfg)[0])
    own = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want) == \
        jax.tree.map(lambda a: (tuple(a.shape),
                                str(a.dtype).replace("torch.", "")), own)


def test_serve_cli_serves_deepseek_and_refuses_modality_archs(capsys):
    report = serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                         "--device", "cpu", "--batch", "2",
                         "--prompt-len", "4", "--gen", "4"])
    assert report["arch"] == "deepseek-v2-lite-smoke"
    assert report["tokens_total"] == 16 and len(report["sample_row"]) == 8
    with pytest.raises(SystemExit, match="modality"):
        serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                    "cpu"])
