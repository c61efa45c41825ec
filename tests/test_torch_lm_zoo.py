"""The dense decoders of the LM zoo in the port (smollm-135m, qwen2.5-3b,
olmo-1b, gemma3-4b) against the JAX package on the same parameters, and
the golden file of the five small dense and MoE decoders for the card.

Each case is a config ``scaled_down(dtype="float32")`` (smollm also with
``n_heads=9, n_kv_heads=3``, its own group of 3, which ``scaled_down``
alone never gives) with the JAX package's ``Model.init(PRNGKey(0))``
parameters. The JAX outputs of a case are computed once a module and
shared by every test of it, the golden file's freshness test included:
the no-cache forward over 19 tokens, the prefill of 16 tokens and three
decode steps (float32 caches), and the tokens the JAX ``SlotServer``
serves five requests (4 slots, ``max_len`` 64, ``max_new`` 8). Prompts
stay within the small config's ``local_window`` (16), where the
reference's prefill ring layout is right (ROADMAP.md section 3).

``src/repro_torch/assets/lm_zoo_small_golden.npz`` holds, for each of the
five archs under the prefix ``<arch>/``, the keys of
``tests/test_torch_lm_golden.py``'s files (config, parameters under
their slash-joined paths, prefill and decode logits, served tokens).
Regenerate it (about a minute on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_zoo.py --write
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_golden import (B, CACHE_LEN, DECODE_STEPS,  # noqa: E402
                                  MAX_LEN, MAX_NEW, S, SLOTS,
                                  check_port_on_cpu, jax_outputs)

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_zoo_small_golden.npz"

SEED = 0
ATOL = 1e-4  # float32 on both sides, summed in different orders
CACHE_DTYPE = "float32"
# the served prompts: at most 16 tokens (the small local window), two
# lengths (one JAX prefill compile each), a fifth request that waits for
# a slot
PROMPT_LENGTHS = (16, 9, 9, 16, 16)

DENSE = ("smollm-135m", "qwen2.5-3b", "olmo-1b", "gemma3-4b")
MOE = "granite-moe-1b-a400m"
ZOO = DENSE + (MOE,)
#: case name -> (arch, scaled_down overrides)
CASES = {**{arch: (arch, {}) for arch in ZOO},
         "smollm-135m/h9kh3": ("smollm-135m",
                               {"n_heads": 9, "n_kv_heads": 3})}


def jax_config(name):
    from repro.configs import get_config

    arch, overrides = CASES[name]
    return get_config(arch).scaled_down(dtype="float32", **overrides)


def port_config(name):
    from repro_torch.configs import get_config

    arch, overrides = CASES[name]
    return get_config(arch).scaled_down(dtype="float32", **overrides)


def inputs(name):
    """(tokens (B, S + DECODE_STEPS), prompts) of a case."""
    rng = np.random.default_rng(SEED + sorted(CASES).index(name))
    vocab = jax_config(name).vocab_size
    tokens = rng.integers(0, vocab, (B, S + DECODE_STEPS)).astype(np.int32)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    return tokens, prompts


def jax_case(name):
    """The JAX package's parameters (numpy) and outputs for one case."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    from repro.models.model_zoo import build_model

    cfg = jax_config(name)
    # eager: compiling the whole init costs more than it saves here
    params = build_model(cfg).init(jax.random.PRNGKey(SEED))
    tokens, prompts = inputs(name)
    forward = jax.jit(lambda p, t: jtfm.forward(p, cfg, tokens=t)[0])
    # the served tokens of the five archs (the golden file's)
    out = jax_outputs(cfg, params, tokens,
                      prompts if name in ZOO else None, max_len=MAX_LEN,
                      cache_dtype=CACHE_DTYPE)
    out.update(cfg=cfg, tokens=tokens, prompts=prompts,
               forward=np.asarray(forward(params, jnp.asarray(tokens))),
               params=jax.tree_util.tree_map(np.asarray, params))
    return out


class Runs(dict):
    """Case name -> JAX outputs, each computed on first use."""

    def __missing__(self, name):
        self[name] = jax_case(name)
        return self[name]


@pytest.fixture(scope="module")
def runs():
    return Runs()


def port_params(run, name):
    from repro_torch.models.params import lm_params

    return lm_params(run["params"], port_config(name), device="cpu")


# ------------------------------------------------------------ configuration
@pytest.mark.parametrize("arch", ZOO)
def test_config_matches_reference(arch):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    full, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert full.layer_kinds == ref.layer_kinds
    assert (dataclasses.asdict(full.scaled_down(dtype="float32"))
            == dataclasses.asdict(ref.scaled_down(dtype="float32")))


@pytest.mark.parametrize("arch", ZOO)
def test_param_tree_matches_reference_layout(arch):
    """Seeded init keeps the reference's paths and shapes (olmo's empty
    norms included); the leaves read in float32 stay float32."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import F32_LEAVES

    params = build_model(get_config(arch).scaled_down()).init(
        0, device="cpu")  # bfloat16
    shapes = jax_build(jax_get_config(arch).scaled_down()).abstract_params()
    ref = jax.tree_util.tree_flatten_with_path(shapes)
    ours = jax.tree_util.tree_flatten_with_path(params)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(params))
    for (path, sds), (_, t) in zip(ref[0], ours[0]):
        assert tuple(t.shape) == sds.shape, path
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        f32 = any(name.endswith(end) for end in F32_LEAVES)
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_jax(kind):
    """The norms in float32 (olmo's nonparametric_ln has no leaves; the
    layernorm shares its code); scales and biases away from 1 and 0."""
    import jax.numpy as jnp

    from repro.models import nn as jnn
    from repro_torch.models import nn

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    params = {k: rng.standard_normal(64).astype(np.float32)
              for k in {"rmsnorm": ("scale",),
                        "layernorm": ("scale", "bias"),
                        "nonparametric_ln": ()}[kind]}
    expect = jnn.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                            kind, jnp.asarray(x))
    got = nn.apply_norm({k: torch.from_numpy(v) for k, v in params.items()},
                        kind, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5,
                               rtol=1e-5)
    init = nn.Init(torch.Generator().manual_seed(0))
    assert sorted(nn.norm_init(init, kind, 64)) == sorted(params)


@pytest.mark.parametrize("name", DENSE + ("smollm-135m/h9kh3",))
def test_forward_matches_jax(runs, name):
    from repro_torch.models import transformer as tfm

    run = runs[name]
    with torch.no_grad():
        logits, _, _ = tfm.forward(port_params(run, name), port_config(name),
                                   tokens=torch.from_numpy(run["tokens"]))
    np.testing.assert_allclose(logits.numpy(), run["forward"], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", DENSE + ("smollm-135m/h9kh3",))
def test_prefill_and_decode_match_jax(runs, name):
    """Prefill of 16 tokens and three decode steps, float32 caches on
    both sides."""
    from repro_torch.models.model_zoo import build_model

    run = runs[name]
    model = build_model(port_config(name))
    params = port_params(run, name)
    tokens = torch.from_numpy(run["tokens"])
    with torch.no_grad():
        cache = model.init_cache(B, CACHE_LEN, dtype=torch.float32,
                                 device="cpu")
        lp, cache = model.prefill(params, cache, tokens=tokens[:, :S])
        np.testing.assert_allclose(lp.numpy(), run["prefill"], atol=ATOL,
                                   rtol=0)
        for i in range(DECODE_STEPS):
            ld, cache = model.decode_step(params, tokens[:, S + i:S + i + 1],
                                          torch.full((B,), S + i), cache)
            np.testing.assert_allclose(ld.numpy(), run["decode"][i],
                                       atol=ATOL, rtol=0)
    # the decode steps continue the no-cache forward
    np.testing.assert_allclose(run["decode"],
                               run["forward"][:, S:].transpose(1, 0, 2),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", DENSE)
def test_slot_server_tokens_match_jax(runs, name):
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.model_zoo import build_model

    run = runs[name]
    model = build_model(port_config(name))
    server = SlotServer(model, port_params(run, name), n_slots=SLOTS,
                        max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(run["prompts"])]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    assert [done[i] for i in range(len(reqs))] == run["served"]


# ------------------------------------------------------------ golden file
def golden_payload(name, run):
    """The golden file's entries of one arch, under ``<arch>/``."""
    from repro.common.tree import tree_flatten_with_paths

    cfg, prompts = run["cfg"], run["prompts"]
    entries = {
        "config": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        **{f"params/{p}": leaf
           for p, leaf in tree_flatten_with_paths(run["params"])},
        "prefill/tokens": run["tokens"][:, :S],
        "prefill/logits": run["prefill"],
        "cache_len": np.asarray(CACHE_LEN),
        "cache_dtype": np.asarray(CACHE_DTYPE),
        "decode/tokens": run["tokens"][:, S:].T.copy(),
        "decode/logits": run["decode"],
        "serve/prompt_lengths": np.asarray([len(p) for p in prompts]),
        "serve/prompts": np.concatenate(prompts),
        "serve/max_new": np.asarray(MAX_NEW),
        "serve/slots": np.asarray(SLOTS),
        "serve/max_len": np.asarray(MAX_LEN),
        "serve/token_counts": np.asarray([len(t) for t in run["served"]]),
        "serve/tokens": np.concatenate(run["served"]).astype(np.int32),
    }
    return {f"{name}/{k}": v for k, v in entries.items()}


def write(path: Path = GOLDEN) -> None:
    payload = {}
    for arch in ZOO:
        payload.update(golden_payload(arch, jax_case(arch)))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def load(arch):
    from repro_torch.models.params import load_lm_golden

    return load_lm_golden(GOLDEN, prefix=f"{arch}/")


def check_fresh(arch, run):
    """The stored entries of ``arch`` are those the recipe gives now:
    configuration, inputs, parameters (an XLA build on another CPU may
    round a last bit differently) and the JAX outputs."""
    import jax

    from repro_torch.models.params import restore

    golden = load(arch)
    stored = dict(np.load(GOLDEN))
    assert dataclasses.asdict(golden.config) == dataclasses.asdict(
        run["cfg"])
    np.testing.assert_array_equal(golden.prefill_tokens,
                                  run["tokens"][:, :S])
    np.testing.assert_array_equal(golden.decode_tokens,
                                  run["tokens"][:, S:].T)
    assert [p.tolist() for p in golden.prompts] == \
        [p.tolist() for p in run["prompts"]]
    assert (golden.cache_dtype, golden.max_len, golden.slots,
            golden.max_new) == (CACHE_DTYPE, MAX_LEN, SLOTS, MAX_NEW)
    fresh = golden_payload(arch, run)
    assert {k for k in stored if k.startswith(f"{arch}/")} == set(fresh)
    expect = restore({k[len(f"{arch}/params/"):]: v for k, v in fresh.items()
                      if k.startswith(f"{arch}/params/")}, golden.config)
    for a, b in zip(jax.tree_util.tree_leaves(golden.params),
                    jax.tree_util.tree_leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   rtol=1e-6)
    np.testing.assert_allclose(golden.prefill_logits, run["prefill"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(golden.decode_logits, run["decode"],
                               atol=ATOL, rtol=0)
    assert golden.served == run["served"]


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 3 << 20


@pytest.mark.parametrize("arch", DENSE)
def test_golden_is_fresh(runs, arch):
    check_fresh(arch, runs[arch])


@pytest.mark.parametrize("arch", ZOO)
def test_port_on_cpu_matches_golden(arch):
    """What ``chip_smoke.py`` holds the card to, on the CPU."""
    check_port_on_cpu(load(arch), ATOL)


# ------------------------------------------------------ checkpoint format
def test_lm_params_reads_a_checkpoint_the_reference_wrote(runs, tmp_path):
    """olmo's ``nonparametric_ln`` has no leaves, so its step_<n>.npz has
    no key for norm1, norm2 or final_norm; the port reads it into the
    configuration's tree, as the reference's ``restore(template)``."""
    from repro.checkpointing.manager import CheckpointManager
    from repro_torch.models.params import lm_params

    run = runs["olmo-1b"]
    CheckpointManager(tmp_path, async_save=False).save(3, run["params"])
    with np.load(tmp_path / "step_3.npz") as z:
        flat = {k: z[k] for k in z.files}
    assert not any("norm" in k for k in flat)
    cfg = port_config("olmo-1b")
    got = lm_params(flat, cfg, device="cpu")
    want = lm_params(run["params"], cfg, device="cpu")
    assert got["final_norm"] == {} and got["body"][0]["norm1"] == {}
    import jax

    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    flat["embed/table"] = flat["embed/table"][:, :8]
    with pytest.raises(ValueError, match="embed/table: shape"):
        lm_params(flat, cfg, device="cpu")


# ------------------------------------------------------------ entry points
def _default_arch(main, argv):
    """The ``--arch`` default of an argparse ``main``: its parser is
    stopped at ``parse_args``."""
    seen = {}

    class Stop(Exception):
        pass

    def parse_args(self, *args, **kwargs):
        seen["arch"] = self.get_default("arch")
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(Stop):
            main(*argv)
    return seen["arch"]


def test_serve_default_arch_is_the_references():
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    assert _default_arch(serve.main, ([],)) == "smollm-135m"
    assert _default_arch(serve.main, ([],)) == \
        _default_arch(jax_serve.main, ())


@pytest.mark.parametrize("arch", ZOO)
def test_serve_main_serves_each_arch_small_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--max-new", "3", "--slots", "2", "--max-len", "32"])
    assert len(out["completed"]) == 3
    assert all(len(r.tokens) == 3 for r in out["completed"])
    assert f"{arch} (small) on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_attention_goes_through_the_flash_wrapper(arch, monkeypatch):
    """Every attention layer of a prefill and of the no-cache forward
    calls the kernel wrapper once, with the layer's window; decode does
    not."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    calls = []
    wrapped = fa_ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs["window"])
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    cfg = get_config(arch).scaled_down(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    windows = [cfg.local_window if k == "local_attn" else 0
               for k in cfg.layer_kinds]
    toks = torch.arange(12)[None] % cfg.vocab_size
    with torch.no_grad():
        cache = model.init_cache(1, 24, device="cpu")
        model.prefill(params, cache, tokens=toks)
        assert calls == windows
        model.decode_step(params, toks[:, :1], torch.tensor([12]), cache)
        assert len(calls) == len(windows)
        tfm.forward(params, cfg, tokens=toks)
    assert calls == 2 * windows


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_lm_zoo.py --write")
    write()
