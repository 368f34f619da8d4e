"""The port's LM decode service (ROADMAP A17 (i)): ``serve --arch smoke-lm``
against the JAX package's ``serve_lm`` loop, the recorded argmax the chip
smoke holds the card to, and the registry against ``repro.configs``."""
import argparse
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import selfjoin as jselfjoin
from repro.models.config import ModelConfig as JaxConfig
from repro.models.lm import LMModel as JaxLM
import repro_torch.configs as tconfigs
from repro_torch.configs import selfjoin as tselfjoin
from repro_torch.configs.smoke_lm import CONFIG, FAMILY_SMOKES, REDUCED
from repro_torch.launch import serve
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        seeded_params)
from repro_torch.models.lm import LMModel
from torch_workloads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

GREEDY_MARGIN = 1e-4


def _args(*extra):
    return ["--arch", "smoke-lm", "--reduced", "--device", "cpu", *extra]


def test_serve_cli_reduced_on_cpu():
    rep = serve.main(_args("--request-batch", "4", "--prompt-len", "8",
                           "--tokens", "4"))
    assert rep.p50_ms > 0 and rep.p99_ms >= rep.p50_ms
    assert rep.prefill_ms > 0 and len(rep.token_ms) == 3
    assert rep.tokens.shape == (4, 5) and rep.finite
    assert rep.tokens.min() >= 0 and rep.tokens.max() < 512
    assert rep.peak_bytes is None and rep.device == "cpu"


def test_serve_refusals():
    with pytest.raises(ValueError, match="--tokens"):
        serve.main(_args("--tokens", "1"))
    with pytest.raises(ModuleNotFoundError):
        serve.main(["--arch", "no-such-lm", "--device", "cpu"])
    with pytest.raises(ModuleNotFoundError):
        jconfigs.get_config("no-such-lm")


def test_no_cpu_fallback(monkeypatch):
    """Asked for CUDA (the default) where there is none, the model and the
    service raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMModel(CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "smoke-lm", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2)})


def _jax_greedy(cfg, tree, B, S, n_tokens, seed):
    """JAX's serve_lm loop (prefill, then greedy decode_step), with the
    given weights; returns the tokens and each step's top-2 margin."""
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)))
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(seed)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)),
                                   jnp.int32)}
    caches = model.init_caches(B, S + n_tokens)
    logits, caches = jax.jit(model.prefill)(params, batch, caches)
    decode = jax.jit(model.decode_step)
    toks, margins = [], []
    for step in range(n_tokens + 1):
        lg = np.asarray(logits)
        top2 = np.sort(lg, -1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]).min())
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if step < n_tokens:
            logits, caches = decode(params, tok, caches)
    return np.stack(toks, 1), np.asarray(margins)


def test_greedy_tokens_match_jax():
    """With carried-over float32 weights the port's greedy loop gives
    JAX's greedy tokens, compared up to the first step whose top-2 margin
    is under GREEDY_MARGIN (none is, on these seeds)."""
    cfg = dataclasses.replace(tconfigs.get_config("smoke-lm", reduced=True),
                              dtype="float32")
    tree = params_to_numpy(seeded_params(cfg, 5, "cpu")[0])
    B, S, n = 4, 16, 8
    want, margins = _jax_greedy(cfg, tree, B, S, n, seed=0)
    args = argparse.Namespace(arch="smoke-lm", reduced=True, device="cpu",
                              seed=0, request_batch=B, prompt_len=S,
                              tokens=n)
    rep = serve.serve_lm(args, params=params_from_jax(tree, "cpu"))
    steps = n + 1
    low = np.nonzero(margins < GREEDY_MARGIN)[0]
    if low.size:
        steps = int(low[0]) + 1   # that step's own argmax may differ
        print(f"compared {steps} of {n + 1} steps: margin {margins[low[0]]}")
    assert steps == n + 1
    assert np.array_equal(rep.tokens[:, :steps], want[:, :steps])


def test_lm_argmax_pin():
    """chip_smoke.LM_ARGMAX is JAX's float32 teacher-forced forward of the
    full smoke-lm CONFIG over lm_pin_prompt() with the seeded weights; the
    port on the CPU gives the same argmax where the margin is over
    LM_MARGIN."""
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    params, _ = seeded_params(cfg, cs.LM_WEIGHT_SEED, "cpu")
    tree = params_to_numpy(params)
    prompt = cs.lm_pin_prompt(cfg.vocab)
    assert prompt.shape == cs.LM_PIN_SHAPE
    model = JaxLM(JaxConfig(**dataclasses.asdict(cfg)))
    logits = np.asarray(jax.jit(model.encode)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(prompt)}))
    am, margin = cs.argmax_margin(logits)
    assert np.array_equal(am, np.asarray(cs.LM_ARGMAX["argmax"]))
    np.testing.assert_allclose(margin, cs.LM_ARGMAX["margin"], rtol=0,
                               atol=1e-6)
    port = LMModel(cfg, device="cpu").encode(params, {"tokens": prompt})
    held = margin > cs.LM_MARGIN
    assert held.sum() > 0.9 * held.size
    assert np.array_equal(port.numpy().argmax(-1)[held], am[held])
    np.testing.assert_allclose(port.numpy(), logits, rtol=1e-4, atol=1e-4)


def test_registry_matches_jax():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert [dataclasses.astuple(c) for c in tconfigs.SHAPES] == \
        [dataclasses.astuple(c) for c in jconfigs.SHAPES]
    for arch in list(tconfigs.ALIASES) + ["smoke_lm"]:
        for reduced in (False, True):
            got = tconfigs.get_config(arch, reduced=reduced)
            want = jconfigs.get_config(arch, reduced=reduced)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for arch in ("smoke-lm",):
        got = [(dataclasses.astuple(c), skip)
               for c, skip in tconfigs.cell_plan(arch)]
        want = [(dataclasses.astuple(c), skip)
                for c, skip in jconfigs.cell_plan(arch)]
        assert got == want
    assert [(a, dataclasses.astuple(c), s)
            for a, c, s in tconfigs.all_cells()] == \
        [(a, dataclasses.astuple(c), s) for a, c, s in jconfigs.all_cells()]
    assert tselfjoin.SHAPES == jselfjoin.SHAPES
    for name in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(tselfjoin, name)) == \
            dataclasses.asdict(getattr(jselfjoin, name))


def test_model_config_matches_jax():
    for cfg in (CONFIG, REDUCED, *FAMILY_SMOKES.values()):
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        for attr in ("head_dim", "sub_quadratic", "has_decode", "d_inner"):
            assert getattr(cfg, attr) == getattr(jcfg, attr)
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
