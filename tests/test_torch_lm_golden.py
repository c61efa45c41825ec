"""The golden files of a small RecurrentGemma and a small xLSTM: JAX
parameters and JAX outputs, for the PyTorch port on a machine without
JAX.

``src/repro_torch/assets/recurrentgemma_small_golden.npz`` holds:

- ``config``: ``recurrentgemma-9b`` ``scaled_down(dtype="float32")`` as
  JSON (``dataclasses.asdict``);
- ``params/<path>``: the JAX parameters of ``Model.init(PRNGKey(0))``
  under their slash-joined paths (the checkpoint format of
  ``repro/checkpointing/manager.py``);
- ``prefill/*``, ``decode/*``, ``cache_len``: a batch of two prompts of
  16 tokens, their prefill logits and the logits of three decode steps
  fed with given tokens (bfloat16 caches, the reference's default);
- ``serve/*``: six requests with prompts of 4 to 16 tokens and the tokens
  the JAX ``SlotServer`` served them (4 slots, ``max_len`` 64,
  ``max_new`` 8).

``src/repro_torch/assets/xlstm_small_golden.npz`` holds the same for
``xlstm-1.3b`` ``scaled_down(dtype="float32")``, with ``cache_dtype``
float32 for the prefill and decode logits and five served requests:
four prompts of 4 to 16 tokens and one of 512, which the mLSTM kernel
runs as two chunks of 256 (``max_len`` 528).

Regenerate both (about 90 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_golden.py --write
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "recurrentgemma_small_golden.npz"
XLSTM_GOLDEN = ASSETS / "xlstm_small_golden.npz"

SEED = 0
B, S, CACHE_LEN, DECODE_STEPS = 2, 16, 24, 3
N_REQUESTS, MAX_NEW, SLOTS, MAX_LEN = 6, 8, 4, 64
ATOL = 1e-4  # float32 on both sides, summed in different orders
# xLSTM: four short served prompts and one that spans two mLSTM chunks
XLSTM_SHORT, XLSTM_LONG = 4, 512
XLSTM_MAX_LEN = XLSTM_LONG + 2 * MAX_NEW


def jax_config():
    from repro.configs import get_config

    return get_config("recurrentgemma-9b").scaled_down(dtype="float32")


def inputs(vocab: int):
    """(tokens (B, S + DECODE_STEPS), prompts): prompts no longer than
    the window (16), where the reference's prefill and decode agree on
    the ring layout."""
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, vocab, (B, S + DECODE_STEPS)).astype(np.int32)
    prompts = [rng.integers(0, vocab, int(rng.integers(4, 17)))
               .astype(np.int32) for _ in range(N_REQUESTS)]
    return tokens, prompts


class Jitted:
    """The reference's ``Model`` with ``prefill`` and ``decode_step``
    under ``jax.jit`` (the same functions; eager JAX would compile the
    layer scan anew on every call)."""

    def __init__(self, model):
        import jax

        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.init_cache = model.init_cache


def jax_params(cfg):
    import jax

    from repro.models.model_zoo import build_model

    return jax.jit(build_model(cfg).init)(jax.random.PRNGKey(SEED))


def jax_outputs(cfg, params, tokens, prompts=None, max_len=MAX_LEN,
                cache_dtype="bfloat16"):
    """The JAX package's prefill / decode logits and (given prompts) the
    tokens its ``SlotServer`` serves."""
    import jax.numpy as jnp

    from repro.launch.serve import Request, SlotServer
    from repro.models.model_zoo import build_model

    model = Jitted(build_model(cfg))
    cache = model.init_cache(B, CACHE_LEN, dtype=jnp.dtype(cache_dtype))
    lp, cache = model.prefill(params, cache,
                              tokens=jnp.asarray(tokens[:, :S]))
    dec = []
    for i in range(DECODE_STEPS):
        ld, cache = model.decode_step(
            params, jnp.asarray(tokens[:, S + i:S + i + 1]),
            jnp.full((B,), S + i, jnp.int32), cache)
        dec.append(np.asarray(ld, np.float32))
    out = {"prefill": np.asarray(lp, np.float32), "decode": np.stack(dec)}
    if prompts is None:
        return out
    server = SlotServer(model, params, n_slots=SLOTS, max_len=max_len)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    out["served"] = [done[i] for i in range(len(prompts))]
    return out


def xlstm_jax_config():
    from repro.configs import get_config

    return get_config("xlstm-1.3b").scaled_down(dtype="float32")


def xlstm_inputs(vocab: int):
    """(tokens (B, S + DECODE_STEPS), prompts): four prompts of 4 to 16
    tokens and one of XLSTM_LONG, lengths that both of the reference's
    mLSTM routes take (its Pallas kernel asks S % 256 == 0 past 256)."""
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, vocab, (B, S + DECODE_STEPS)).astype(np.int32)
    lengths = [int(rng.integers(4, 17)) for _ in range(XLSTM_SHORT)]
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in lengths + [XLSTM_LONG]]
    return tokens, prompts


#: (golden file, JAX config, inputs, served max_len, the cache type of
#: the prefill and decode logits) per architecture. xLSTM's logits are
#: taken with float32 caches: a bfloat16 conv history rounds a value
#: that the two packages carry 1e-6 apart to two neighbouring bfloat16
#: values now and then, which moves its decode logits by 1e-3.
RECIPES = {
    "recurrentgemma-9b": (GOLDEN, jax_config, inputs, MAX_LEN, "bfloat16"),
    "xlstm-1.3b": (XLSTM_GOLDEN, xlstm_jax_config, xlstm_inputs,
                   XLSTM_MAX_LEN, "float32"),
}


def write(path: Path = GOLDEN, arch: str = "recurrentgemma-9b") -> None:
    import jax

    from repro.common.tree import tree_flatten_with_paths

    _, config, make_inputs, max_len, cache_dtype = RECIPES[arch]
    cfg = config()
    params = jax_params(cfg)
    tokens, prompts = make_inputs(cfg.vocab_size)
    out = jax_outputs(cfg, params, tokens, prompts, max_len=max_len,
                      cache_dtype=cache_dtype)
    params = jax.tree_util.tree_map(np.asarray, params)
    payload = {
        "config": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        **{f"params/{p}": leaf
           for p, leaf in tree_flatten_with_paths(params)},
        "prefill/tokens": tokens[:, :S],
        "prefill/logits": out["prefill"],
        "cache_len": np.asarray(CACHE_LEN),
        "cache_dtype": np.asarray(cache_dtype),
        "decode/tokens": tokens[:, S:].T.copy(),
        "decode/logits": out["decode"],
        "serve/prompt_lengths": np.asarray([len(p) for p in prompts]),
        "serve/prompts": np.concatenate(prompts),
        "serve/max_new": np.asarray(MAX_NEW),
        "serve/slots": np.asarray(SLOTS),
        "serve/max_len": np.asarray(max_len),
        "serve/token_counts": np.asarray([len(t) for t in out["served"]]),
        "serve/tokens": np.concatenate(out["served"]).astype(np.int32),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


@pytest.fixture(scope="module")
def golden():
    from repro_torch.models.params import load_lm_golden

    return load_lm_golden(GOLDEN)


@pytest.fixture(scope="module")
def xlstm_golden():
    from repro_torch.models.params import load_lm_golden

    return load_lm_golden(XLSTM_GOLDEN)


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 1 << 20


def test_xlstm_golden_file_is_small():
    assert XLSTM_GOLDEN.stat().st_size < 2 << 20


def check_fresh(arch, golden, atol):
    """The stored configuration and inputs are the recipe's, and the JAX
    package run from the stored parameters reproduces the stored
    outputs."""
    import jax
    import jax.numpy as jnp

    from repro_torch.core.params import unflatten

    path, config, make_inputs, max_len, cache_dtype = RECIPES[arch]
    cfg = config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(golden.config)
    tokens, prompts = make_inputs(cfg.vocab_size)
    np.testing.assert_array_equal(golden.prefill_tokens, tokens[:, :S])
    np.testing.assert_array_equal(golden.decode_tokens, tokens[:, S:].T)
    assert len(golden.prompts) == len(prompts)
    for p, q in zip(golden.prompts, prompts):
        np.testing.assert_array_equal(p, q)
    assert golden.max_len == max_len and golden.cache_dtype == cache_dtype
    with np.load(path) as z:
        stored = unflatten({k[len("params/"):]: jnp.asarray(z[k])
                            for k in z.files if k.startswith("params/")})
    fresh = jax_params(cfg)
    assert (jax.tree_util.tree_structure(stored)
            == jax.tree_util.tree_structure(fresh))
    # an XLA build on another CPU may round a last bit differently
    for a, b in zip(jax.tree_util.tree_leaves(stored),
                    jax.tree_util.tree_leaves(fresh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7,
                                   rtol=1e-6)
    out = jax_outputs(cfg, stored, tokens, prompts, max_len=max_len,
                      cache_dtype=cache_dtype)
    np.testing.assert_allclose(out["prefill"], golden.prefill_logits,
                               atol=atol, rtol=0)
    np.testing.assert_allclose(out["decode"], golden.decode_logits,
                               atol=atol, rtol=0)
    assert out["served"] == golden.served


def test_golden_is_fresh(golden):
    check_fresh("recurrentgemma-9b", golden, ATOL)


def test_xlstm_golden_is_fresh(xlstm_golden):
    check_fresh("xlstm-1.3b", xlstm_golden, ATOL)


def check_port_on_cpu(golden, atol):
    """The port, from the stored parameters, reproduces the JAX outputs
    on the CPU (``chip_smoke.py`` holds the card to the same file)."""
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import cast_params

    cfg = golden.config
    model = build_model(cfg)
    params = cast_params(golden.params, cfg, "cpu")
    with torch.inference_mode():
        cache = model.init_cache(B, golden.cache_len,
                                 dtype=getattr(torch, golden.cache_dtype),
                                 device="cpu")
        lp, cache = model.prefill(
            params, cache, tokens=torch.from_numpy(golden.prefill_tokens))
        np.testing.assert_allclose(lp.numpy(), golden.prefill_logits,
                                   atol=atol, rtol=0)
        for i, tok in enumerate(golden.decode_tokens):
            ld, cache = model.decode_step(
                params, torch.from_numpy(tok)[:, None],
                torch.full((B,), S + i), cache)
            np.testing.assert_allclose(ld.numpy(), golden.decode_logits[i],
                                       atol=atol, rtol=0)
    server = SlotServer(model, params, n_slots=golden.slots,
                        max_len=golden.max_len)
    reqs = [Request(rid=i, prompt=p, max_new=golden.max_new)
            for i, p in enumerate(golden.prompts)]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    assert [done[i] for i in range(len(reqs))] == golden.served


def test_port_on_cpu_matches_golden(golden):
    check_port_on_cpu(golden, ATOL)


def test_port_on_cpu_matches_xlstm_golden(xlstm_golden):
    check_port_on_cpu(xlstm_golden, ATOL)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_lm_golden.py --write")
    for arch, (path, *_) in RECIPES.items():
        write(path, arch)
