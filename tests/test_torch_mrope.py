"""Qwen2-VL's M-RoPE and embeddings input in the port against the JAX
package.

- ``nn.apply_mrope`` (sections (1, 1, 2) of head_dim/2 for the temporal,
  height and width rows) against the reference's, and with three equal
  rows against ``apply_rope`` in both packages.
- The small Qwen2-VL, ``qwen2-vl-7b`` ``scaled_down(dtype="float32")``
  with the JAX package's ``Model.init(PRNGKey(0))`` parameters: the
  no-cache forward and a prefill from seeded ``embeddings`` with (3, B,
  S) positions whose rows differ (text, an image whose t/h/w rows part,
  text again, at another offset in each batch row); the forward over 19
  tokens, the prefill of 16 tokens and three decode steps (float32
  caches; decode gives an "mrope" model three equal position rows) and
  the tokens the JAX ``SlotServer`` serves five requests. The JAX outputs
  are computed once a module and shared by the tests, the golden file's
  freshness test (``tests/test_torch_mla.py``'s file, the entry of
  ``qwen2-vl-7b``) included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_golden import B, CACHE_LEN, S  # noqa: E402
from test_torch_mla import (ATOL, VL, check_fresh,  # noqa: E402
                            check_port_on_cpu, check_prefill_and_decode,
                            check_served_tokens, jax_case, load, port_config,
                            port_params, vl_positions)

ROPE_ATOL = 1e-6  # one rotation in float32 on both sides


@pytest.fixture(scope="module")
def qwen2_vl():
    """The JAX outputs of the small Qwen2-VL, computed once."""
    return jax_case(VL)


# ------------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_mrope_matches_jax(hd, theta):
    """(2, 40, 3, hd) rotated by (3, 2, 40) positions of an image layout
    (the rows differ); Qwen2-VL's head dim 128 and theta 1e6 included."""
    import jax.numpy as jnp

    from repro.models import nn as jnn
    from repro_torch.models import nn

    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = np.stack([vl_positions(n, (8, 6), 40) for n in (3, 9)], 1)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    expect = jnn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = nn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=ROPE_ATOL, rtol=0)


def test_mrope_with_three_equal_rows_is_rope():
    """Equal rows turn every frequency by the one position: the port's
    M-RoPE equals its RoPE bit for bit, and the reference's RoPE."""
    import jax.numpy as jnp

    from repro.models import nn as jnn
    from repro_torch.models import nn

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 16))
                         .astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 9)))
    rope = nn.apply_rope(x, pos, 1e6)
    assert torch.equal(nn.apply_mrope(x, pos[None].expand(3, -1, -1), 1e6),
                       rope)
    np.testing.assert_allclose(
        rope.numpy(), np.asarray(jnn.apply_rope(jnp.asarray(x.numpy()),
                                                jnp.asarray(pos.numpy()),
                                                1e6)),
        atol=ROPE_ATOL, rtol=0)


def test_attention_takes_mrope_for_three_rows_and_rope_for_two(monkeypatch):
    """``_project_qkv`` of an "mrope" config: (3, B, S) positions go to
    ``apply_mrope``, (B, S) to ``apply_rope``, as the reference's."""
    from repro_torch.models import attention as attn
    from repro_torch.models import nn

    cfg = port_config(VL)
    params = attn.attention_init(nn.Init(torch.Generator().manual_seed(0)),
                                 cfg)
    seen = []
    for name in ("apply_rope", "apply_mrope"):
        fn = getattr(nn, name)
        monkeypatch.setattr(nn, name, lambda *a, _f=fn, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    x = torch.zeros(1, 5, cfg.d_model)
    pos = torch.arange(5)[None]
    attn._project_qkv(params, cfg, x, pos[None].expand(3, -1, -1))
    attn._project_qkv(params, cfg, x, pos)
    assert seen == ["apply_mrope"] * 2 + ["apply_rope"] * 2


# ------------------------------------------------------- parity with JAX
def test_forward_from_embeddings_matches_jax(qwen2_vl):
    """The no-cache forward of the embeddings with (3, B, S) positions
    whose rows differ, in each batch row at another offset, against the
    reference's Pallas route (interpret mode), which masks by index as
    the port's kernel and Qwen2-VL do."""
    from repro_torch.models import transformer as tfm

    pos = qwen2_vl["positions"]
    assert (pos[0] != pos[1]).any() and (pos[1, 0] != pos[1, 1]).any()
    with torch.no_grad():
        logits, _, _ = tfm.forward(
            port_params(qwen2_vl, VL), port_config(VL),
            embeddings=torch.from_numpy(qwen2_vl["embeddings"]),
            positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(logits.numpy(), qwen2_vl["emb_forward"],
                               atol=ATOL, rtol=0)


def test_reference_default_route_masks_by_position_value(qwen2_vl):
    """The reference's default route masks by the positions' values
    (``attend_full(q_pos=pos2d, k_pos=pos2d)``), so an image's tokens,
    which share a temporal position, see each other both ways: its
    logits leave the Pallas route's (and the port's) at the image rows
    and only there (ROADMAP.md section 3)."""
    pos = qwen2_vl["positions"][0]  # (B, S), the temporal row
    image = np.zeros(pos.shape, bool)
    for b in range(pos.shape[0]):
        tied = pos[b][:, None] == pos[b][None, :]
        image[b] = tied.sum(1) > 1
    assert image.any(1).all() and not image.all()
    diff = np.abs(qwen2_vl["emb_forward_default"]
                  - qwen2_vl["emb_forward"]).max(-1)
    assert (diff[~image] <= ATOL).all()
    assert (diff[image].max() > 100 * ATOL)


def test_prefill_from_embeddings_matches_jax(qwen2_vl):
    """The last position's logits and the cache: token i at index i with
    its temporal position, the image's repeated positions included, as
    the reference lays out a prompt no longer than the cache."""
    import jax

    from repro_torch.models.model_zoo import build_model

    model = build_model(port_config(VL))
    with torch.no_grad():
        cache = model.init_cache(B, CACHE_LEN, dtype=torch.float32,
                                 device="cpu")
        logits, cache = model.prefill(
            port_params(qwen2_vl, VL), cache,
            embeddings=torch.from_numpy(qwen2_vl["embeddings"]),
            positions=torch.from_numpy(qwen2_vl["positions"]).long())
    np.testing.assert_allclose(logits.numpy(), qwen2_vl["emb_prefill"],
                               atol=ATOL, rtol=0)
    ours, theirs = (jax.tree_util.tree_flatten_with_path(t)[0]
                    for t in (cache, qwen2_vl["emb_cache"]))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0,
                                   err_msg=str(path))


def test_forward_from_tokens_matches_jax(qwen2_vl):
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        logits, _, _ = tfm.forward(port_params(qwen2_vl, VL),
                                   port_config(VL),
                                   tokens=torch.from_numpy(qwen2_vl["tokens"]))
    np.testing.assert_allclose(logits.numpy(), qwen2_vl["forward"],
                               atol=ATOL, rtol=0)


def test_prefill_and_decode_match_jax(qwen2_vl):
    """Prefill of 16 tokens ((B, S) positions: RoPE) and three decode
    steps (three equal rows: M-RoPE), float32 caches; the decode steps
    continue the no-cache forward."""
    check_prefill_and_decode(qwen2_vl, VL)
    np.testing.assert_allclose(qwen2_vl["decode"],
                               qwen2_vl["forward"][:, S:].transpose(1, 0, 2),
                               atol=ATOL, rtol=0)


def test_slot_server_tokens_match_jax(qwen2_vl):
    check_served_tokens(qwen2_vl, VL)


def test_forward_takes_tokens_or_embeddings_not_both(qwen2_vl):
    from repro_torch.models import transformer as tfm

    params, cfg = port_params(qwen2_vl, VL), port_config(VL)
    toks = torch.zeros(1, 3, dtype=torch.long)
    emb = torch.zeros(1, 3, cfg.d_model)
    for kwargs in ({}, {"tokens": toks, "embeddings": emb}):
        with pytest.raises(ValueError, match="tokens or embeddings"):
            tfm.forward(params, cfg, **kwargs)


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(qwen2_vl):
    check_fresh(VL, qwen2_vl)


def test_port_on_cpu_matches_golden():
    """What ``chip_smoke.py`` holds the card to, on the CPU: the logits
    and served tokens, and the prefill from embeddings."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import cast_params

    golden = load(VL)
    check_port_on_cpu(golden, ATOL)
    e = golden.embeddings
    model = build_model(golden.config)
    with torch.inference_mode():
        cache = model.init_cache(B, int(e["cache_len"]),
                                 dtype=getattr(torch, golden.cache_dtype),
                                 device="cpu")
        logits, _ = model.prefill(
            cast_params(golden.params, golden.config, "cpu"), cache,
            embeddings=torch.from_numpy(e["inputs"]),
            positions=torch.from_numpy(e["positions"]))
    np.testing.assert_allclose(logits.numpy(), e["logits"], atol=ATOL,
                               rtol=0)


def test_config_is_the_references_with_mrope():
    """The port's qwen2-vl-7b is the reference's field for field (also
    ``tests/test_torch_mla.py``): M-RoPE at theta 1e6, 28 query heads
    over 4 kv heads of 128, the QKV bias."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    cfg = get_config(VL)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(VL))
    assert (cfg.rope_style, cfg.rope_theta, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.qkv_bias) == ("mrope", 1e6, 28, 4, 128, True)
