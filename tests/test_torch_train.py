"""Perona training in the PyTorch port against the JAX package: the five
losses and their gradients, the training-mode forward and its dropouts,
``PeronaModel.loss`` at fixed parameters, AdamW, the host-loop trainer
and the training golden file (the card's reference)."""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import losses as jL  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.common.tree import leaf_order, tree_global_norm  # noqa
from repro_torch.core import losses as L  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core import trainer as T  # noqa: E402
from repro_torch.core.params import (flat_params, load_npz,  # noqa: E402
                                     load_train_golden, params_from_numpy,
                                     params_to_numpy)
from repro_torch.optim.adamw import AdamW, OptState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# loss values and their gradients, float32 in both packages
LOSS_TOL = 1e-5
# PeronaModel.loss at fixed parameters: terms absolute, gradients
# relative L2 per leaf
TERM_ATOL = 1e-5
GRAD_RTOL = 1e-4
# AdamW, the same gradients fed to both packages
ADAM_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """``chip_smoke.py``'s helpers and limits (the script imports nothing
    of the JAX package, and torch only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def port_params(params):
    """A JAX parameter tree as ``{state_dict name: tensor}``."""
    return flat_params(params_from_numpy(jax_tree(params)))


# ------------------------------------------------------------------ losses
def loss_inputs(N=24, K=8, T_=3, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    d = {
        "codes": rng.standard_normal((N, K)).astype(np.float32),
        "recon": rng.random((N, 11), np.float32),
        "x": rng.random((N, 11), np.float32),
        "logit": rng.standard_normal(N).astype(np.float32) * 2,
        "logits": rng.standard_normal((N, 6)).astype(np.float32),
        "type_id": rng.integers(0, T_, N).astype(np.int32),
        "anomaly": (rng.random(N) < 0.25).astype(np.int32),
        "norm_gt": rng.random(N).astype(np.float32),
        "valid": (rng.random(N) < 0.85).astype(np.float32),
    }
    if ties:
        # nodes 1 and 2 are duplicates (code, type, ground truth): node
        # 0's two hardest positives at the same distance (opposite to
        # it), and the two smallest p-norms among its type's normals (a
        # tie in the min below which node 3, anomalous, is pushed); their
        # pair has y = 0
        d["type_id"][:4] = 0
        d["anomaly"][:3] = 0
        d["anomaly"][3] = 1
        d["valid"][:4] = 1.0
        d["codes"][1] = d["codes"][2] = -0.05 * d["codes"][0]
        d["norm_gt"][2] = d["norm_gt"][1]
    return d


def _loss_cases():
    """name -> (differentiated input, jax fn, port fn) on the dict of
    loss_inputs (jax fn on jnp arrays, port fn on tensors)."""
    return {
        "mse": ("recon",
                lambda d: jL.mse_loss(d["recon"], d["x"], d["valid"]),
                lambda d: L.mse_loss(d["recon"], d["x"], d["valid"])),
        "cbfl": ("logit",
                 lambda d: jL.class_balanced_focal_loss(
                     d["logit"], d["anomaly"], d["valid"], gamma=2.0,
                     beta=0.999),
                 lambda d: L.class_balanced_focal_loss(
                     d["logit"], d["anomaly"], d["valid"], gamma=2.0,
                     beta=0.999)),
        "cel": ("logits",
                lambda d: jL.cross_entropy_loss(d["logits"], d["type_id"],
                                                d["valid"]),
                lambda d: L.cross_entropy_loss(d["logits"], d["type_id"],
                                               d["valid"])),
        "tml": ("codes",
                lambda d: jL.triplet_margin_loss(d["codes"], d["type_id"],
                                                 d["valid"], margin=0.3),
                lambda d: L.triplet_margin_loss(d["codes"], d["type_id"],
                                                d["valid"], margin=0.3)),
        "pnorm": ("codes",
                  lambda d: jL.pnorm(d["codes"], 10.0).sum(),
                  lambda d: L.pnorm(d["codes"], 10.0).sum()),
        "mrl": ("codes",
                lambda d: jL.margin_ranking_loss(
                    d["codes"], d["norm_gt"], d["type_id"], d["anomaly"],
                    d["valid"], p=10.0, margin=0.01, anom_margin=0.1),
                lambda d: L.margin_ranking_loss(
                    d["codes"], d["norm_gt"], d["type_id"], d["anomaly"],
                    d["valid"], p=10.0, margin=0.01, anom_margin=0.1)),
    }


def value_and_grads(name, d):
    wrt, jfn, tfn = _loss_cases()[name]

    def jf(x):
        return jfn({**{k: jnp.asarray(v) for k, v in d.items()}, wrt: x})

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(d[wrt]))
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    td[wrt] = td[wrt].clone().requires_grad_()
    tv = tfn(td)
    (tg,) = torch.autograd.grad(tv, td[wrt])
    return (float(tv.detach()), tg.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("name", list(_loss_cases()))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(name, seed):
    (tv, tg), (jv, jg) = value_and_grads(name, loss_inputs(seed=seed))
    assert abs(tv - jv) <= LOSS_TOL * max(1.0, abs(jv)), (tv, jv)
    np.testing.assert_allclose(tg, jg, atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("name", ["tml", "mrl"])
def test_tied_distances_split_the_gradient_as_jax_does(name):
    """Duplicate codes tie in the batch-hard max (TML) and in the
    per-type min (MRL): JAX splits the gradient evenly among the tied
    entries, and so does the port (amax/amin), so the two duplicates get
    equal, nonzero gradients that match JAX's (a rule that gave the
    whole gradient to one of them, as ``max(dim)`` does, would not)."""
    d = loss_inputs(seed=2, ties=True)
    (tv, tg), (jv, jg) = value_and_grads(name, d)
    assert abs(tv - jv) <= LOSS_TOL * max(1.0, abs(jv))
    np.testing.assert_allclose(tg, jg, atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_array_equal(jg[1], jg[2])
    np.testing.assert_array_equal(tg[1], tg[2])
    assert np.abs(tg[1]).max() > 1e-3


def test_cbfl_beta_as_tensor_or_float_is_the_same_arithmetic():
    d = {k: torch.from_numpy(v) for k, v in loss_inputs().items()}
    args = (d["logit"], d["anomaly"], d["valid"])
    a = L.class_balanced_focal_loss(*args, beta=0.999, gamma=2.0)
    b = L.class_balanced_focal_loss(*args, beta=torch.tensor(0.999),
                                    gamma=torch.tensor(2.0))
    assert torch.equal(a, b)


# ------------------------------------------------------------------- model
def model_batch(N=40, F=20, A=7, seed=1):
    """A batch with chains of distinct predecessors (i-1, i-2, i-3), so
    that every gradient but the key biases' is nonzero."""
    rng = np.random.default_rng(seed)
    nbr = np.arange(N)[:, None] - np.arange(1, 4)[None]
    mask = (rng.random((N, 3)) < 0.8) & (nbr >= 0)
    return {
        "x": rng.random((N, F), np.float32),
        "nbr": np.where(mask, nbr, -1).astype(np.int32),
        "nbr_mask": mask,
        "edge": rng.random((N, 3, A), np.float32),
        "type_id": rng.integers(0, 6, N).astype(np.int32),
        "anomaly": (rng.random(N) < 0.2).astype(np.int32),
        "norm_gt": rng.random(N).astype(np.float32),
    }


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_model(jcfg, params):
    model = M.PeronaModel(M.PeronaConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(port_params(params))
    return model


@pytest.mark.parametrize("gnn_impl", ["reference", "pallas"])
@pytest.mark.parametrize("heads", [1, 2, 4, 8])
@pytest.mark.parametrize("use_root_weight", [True, False])
def test_loss_terms_and_gradients_match_jax(gnn_impl, heads,
                                            use_root_weight):
    """``PeronaModel.loss`` at reference parameters and dropout 0 against
    ``jax.value_and_grad(model.loss)``: terms within 1e-5, every
    gradient within 1e-4 relative L2, except the key biases', whose exact
    value is 0 (a bias on every key of a node shifts all its scores
    alike): both packages give rounding noise there, held under 1e-6 of
    the global norm."""
    cs = chip_smoke()
    jcfg = cs.dropout_free(jmodel.PeronaConfig(
        feature_dim=20, edge_dim=7, heads=heads,
        use_root_weight=use_root_weight, gnn_impl=gnn_impl))
    jm = jmodel.PeronaModel(jcfg)
    params = jm.init(jax.random.PRNGKey(heads))
    batch = model_batch()
    (jtot, jterms), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, None)
    model = port_model(jcfg, params)
    tot, terms = model.loss(to_torch(batch))
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(tot, list(
        model.parameters()))))
    for k, v in {"total": jtot, **jterms}.items():
        got = float((tot if k == "total" else terms[k]).detach())
        assert abs(got - float(v)) <= TERM_ATOL, (k, got, float(v))
    want = port_params(jgrads)
    assert set(want) == set(grads)
    gnorm = float(tree_global_norm(want))
    for k in names:
        if k in cs.ZERO_GRAD_LEAVES:
            assert float(grads[k].norm()) <= 1e-6 * gnorm, k
            assert float(want[k].norm()) <= 1e-6 * gnorm, k
            continue
        err = float((grads[k] - want[k]).norm() / want[k].norm())
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("rates", [(0.0, 0.0, 0.0), (0.1, 0.1, 0.05)])
def test_training_forward_at_dropout_0_is_the_eval_forward(rates):
    """The training forward draws nothing at dropout 0 (and nothing with
    no generator at any rate) and then equals the eval forward."""
    fd, ed, ad = rates
    cfg = M.PeronaConfig(feature_dim=20, edge_dim=7, feature_dropout=fd,
                         edge_dropout=ed, alpha_dropout=ad)
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(0))
    batch = to_torch(model_batch())
    with torch.no_grad():
        ev = model(batch)
        g = torch.Generator().manual_seed(5)
        tr = model(batch, train=True, generator=g if fd == 0 else None)
        state = g.get_state()
    assert torch.equal(state, torch.Generator().manual_seed(5).get_state())
    for k in ev:
        assert torch.equal(ev[k], tr[k]), k


def test_dropouts_are_drawn_in_the_references_order():
    """feature dropout on x, then edge dropout on the mask, then alpha
    dropout after the first SELU, each one uniform draw of its shape."""
    cfg = M.PeronaConfig(feature_dim=20, edge_dim=7, feature_dropout=0.3,
                         edge_dropout=0.4, alpha_dropout=0.2)
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(0))
    b = to_torch(model_batch())
    N, K = b["x"].shape[0], cfg.code_dim
    with torch.no_grad():
        got = model(b, train=True,
                    generator=torch.Generator().manual_seed(9))
        g = torch.Generator().manual_seed(9)
        u_x = torch.rand(b["x"].shape, generator=g)
        u_e = torch.rand(b["nbr_mask"].shape, generator=g)
        u_a = torch.rand((N, K), generator=g)
        x = b["x"] * (u_x < 0.7) / 0.7
        mask = b["nbr_mask"] & (u_e < 0.6)
        codes = M._run_mlp(model.enc, x)
        out = F_selu(0.5 * (model._transformer_conv(codes, b["nbr"], mask,
                                                    b["edge"])
                            + model._tag_conv(codes, b["nbr"], mask)))
        q = 0.8
        a = (q + M.ALPHA_P ** 2 * q * (1 - q)) ** -0.5
        out = a * torch.where(u_a < 0.8, out, M.ALPHA_P) - a * M.ALPHA_P * (
            1 - q)
        agg = F_selu(model.out(out) + model.root(codes))
    torch.testing.assert_close(got["agg"], agg, rtol=0, atol=0)
    torch.testing.assert_close(got["codes"], codes, rtol=0, atol=0)


def F_selu(x):
    return torch.nn.functional.selu(x)


def test_dropout_statistics():
    """At 10^5 draws: the keep rate within 5 sigma of 1 - rate, feature
    dropout keeping the mean, and alpha dropout keeping a standard
    normal input's mean and variance within sampling error."""
    n = 100_000
    g = torch.Generator().manual_seed(0)
    for rate in (0.1, 0.5):
        keep = M._keep((n,), rate, g, "cpu").float().mean().item()
        assert abs(keep - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
        x = torch.rand(n, generator=g) + 0.5
        y = M.drop_features(x, rate, g)
        kept = y != 0
        torch.testing.assert_close(y[kept] / x[kept],
                                   torch.full((int(kept.sum()),),
                                              1 / (1 - rate)))
        assert abs(y.mean().item() - x.mean().item()) <= 5 * (
            y.std().item() / n ** 0.5)
    rate = 0.05
    x = torch.randn(n, generator=g)
    y = M.alpha_dropout(x, rate, g).double()
    dropped = torch.unique(y, return_counts=True)[1].max().item()
    assert abs(dropped / n - rate) <= 5 * (rate * (1 - rate) / n) ** 0.5
    m4 = ((y - y.mean()) ** 4).mean().item()
    assert abs(y.mean().item()) <= 5 / n ** 0.5
    assert abs(y.var().item() - 1.0) <= 5 * ((m4 - 1) / n) ** 0.5
    mask = torch.ones(n // 4, 4, dtype=torch.bool)
    kept = M.drop_edges(mask, 0.25, g).float().mean().item()
    assert abs(kept - 0.75) <= 5 * (0.25 * 0.75 / n) ** 0.5


@pytest.mark.parametrize("key", ["feature_dropout", "edge_dropout"])
def test_hypers_force_a_dropout_on(key):
    """A dropout named in ``hypers`` is applied even when the config's
    rate is 0, and the value in ``hypers`` (a 0-d tensor) is the rate."""
    cfg = M.PeronaConfig(feature_dim=20, edge_dim=7, feature_dropout=0.0,
                         edge_dropout=0.0, alpha_dropout=0.0)
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(0))
    b = to_torch(model_batch())
    hypers = {key: torch.tensor(0.5)}
    with torch.no_grad():
        ev = model(b)
        g = torch.Generator().manual_seed(3)
        tr = model(b, train=True, generator=g, hypers=hypers)
        g2 = torch.Generator().manual_seed(3)
        shape = b["x"].shape if key == "feature_dropout" else \
            b["nbr_mask"].shape
        torch.rand(shape, generator=g2)
    assert torch.equal(g.get_state(), g2.get_state())
    assert not torch.equal(ev["agg"], tr["agg"])


def test_loss_takes_valid_and_the_configs_loss_weights():
    cfg = chip_smoke().dropout_free(M.PeronaConfig(feature_dim=20,
                                                   edge_dim=7))
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(0))
    b = to_torch(model_batch())
    with torch.no_grad():
        tot, terms = model.loss(b)
        tot1, terms1 = model.loss({**b, "valid": torch.ones(40)})
        weighted = dataclasses.replace(cfg, loss_weights=(1, 2, 0, 0, 3))
        model.cfg = weighted
        tot2, _ = model.loss(b)
    assert torch.equal(tot, tot1)
    assert all(torch.equal(terms[k], terms1[k]) for k in terms)
    torch.testing.assert_close(
        tot2, terms["mse"] + 2 * terms["cbfl"] + 3 * terms["mrl"])


# ------------------------------------------------------------------- AdamW
def adam_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": [rng.standard_normal((3, 2, 2)).astype(np.float32),
                  rng.standard_normal(3).astype(np.float32)]}


@pytest.mark.parametrize("steps", [1, 20])
@pytest.mark.parametrize("tensor_hypers", [False, True])
def test_adamw_matches_jax(steps, tensor_hypers):
    """The same gradients (large enough that clipping acts) through both
    optimizers: parameters and moments within 1e-6; decay only on leaves
    with ndim >= 2."""
    params = adam_tree()
    lr, wd = 3e-3, 0.1
    jopt = jadamw.AdamW(lr=jnp.float32(lr) if tensor_hypers else lr,
                        b2=0.999, weight_decay=jnp.float32(wd)
                        if tensor_hypers else wd, clip_norm=0.5)
    topt = AdamW(lr=torch.tensor(lr) if tensor_hypers else lr, b2=0.999,
                 weight_decay=torch.tensor(wd) if tensor_hypers else wd,
                 clip_norm=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = port_params(params)
    ts = topt.init(tp)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda x: (3 * rng.standard_normal(x.shape)).astype(np.float32),
            params)
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 js, jp)
        tp, ts, tm = topt.update(port_params(g), ts, tp)
        assert float(jm["grad_norm"]) > 0.5  # clipping acts
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert int(ts.step) == int(js.step) == steps
    for name, jt, tt in (("params", jp, tp), ("m", js.m, ts.m),
                         ("v", js.v, ts.v)):
        want = port_params(jt)
        for k in want:
            np.testing.assert_allclose(tt[k].numpy(), want[k].numpy(),
                                       atol=ADAM_TOL, rtol=ADAM_TOL,
                                       err_msg=f"{name} {k}")


def test_adamw_decays_matrices_only():
    params = port_params(adam_tree())
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = AdamW(lr=0.1, weight_decay=0.5)
    new, state, _ = opt.update(zero, opt.init(params), params)
    for k, p in params.items():
        if p.dim() >= 2:
            torch.testing.assert_close(new[k], p - 0.1 * 0.5 * p)
        else:
            assert torch.equal(new[k], p)
    assert isinstance(state, OptState) and int(state.step) == 1
    new0, _, _ = AdamW(lr=0.1, weight_decay=0).update(
        zero, opt.init(params), params)
    assert all(torch.equal(new0[k], params[k]) for k in params)


def test_global_norm_sums_in_the_references_leaf_order():
    from repro.common.tree import tree_flatten_with_paths, tree_global_norm \
        as jnorm

    tree = {"tag": [{"w": 1}, {"w": 2}], "b": {"x": 3}, "a": [4, 5]}
    jpaths = [p.replace("/", ".") for p, _ in tree_flatten_with_paths(tree)]
    assert leaf_order(flat_params(tree)) == jpaths
    # one value a leaf, of mixed magnitudes: the sum's rounding depends
    # on the order of the leaves alone (12 of them: "10" < "2" as text)
    big = {f"l.{i}": np.full((1,), 10.0 ** (i % 5 - 2) * (1 + i / 7),
                             np.float32) for i in range(12)}
    want = float(jnorm(unflat_jax(big)))
    got = float(tree_global_norm({k: torch.from_numpy(v)
                                  for k, v in big.items()}))
    assert got == want


def unflat_jax(flat):
    from repro_torch.core.params import unflatten

    return unflatten({k.replace(".", "/"): jnp.asarray(v)
                      for k, v in flat.items()})


# ----------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def small_setup():
    """``tests/test_trainer_scan.py``'s setup at dropout 0."""
    from repro.core.graph_data import build_graphs, chronological_split
    from repro.core.preprocess import Preprocessor
    from repro.fingerprint.runner import SuiteRunner

    runner = SuiteRunner(seed=7)
    frame = runner.run_frame({"m0": "e2-medium", "m1": "n2-standard-4"},
                             runs_per_type=12, stress_fraction=0.2)
    tr, va, _ = chronological_split(frame, (0.7, 0.3, 0.0))
    pre = Preprocessor().fit(tr)
    tb, vb = build_graphs(tr, pre), build_graphs(va, pre)
    cfg = chip_smoke().dropout_free(jmodel.PeronaConfig(
        feature_dim=pre.feature_dim, edge_dim=tb.edge.shape[-1]))
    return cfg, tb, vb


def test_trainer_matches_jax_reference_trainer_with_early_stopping(
        small_setup):
    """Same history (early stopping included), best epoch and selected
    parameters as ``repro.core.trainer.train_perona_reference``, from the
    same initial parameters at dropout 0, within the measured limits of
    ``chip_smoke.py`` (losses per block of epochs, F1, parameters)."""
    cs = chip_smoke()
    cfg, tb, vb = small_setup
    jm = jmodel.PeronaModel(cfg)
    ref = jtrainer.train_perona_reference(jm, tb, vb, epochs=60,
                                          patience=0, seed=0)
    assert len(ref.history) < 60, "patience must trigger"
    model = port_model(cfg, jm.init(jax.random.PRNGKey(0)))
    res = T.train_perona_reference(model, tb, vb, epochs=60, patience=0,
                                   seed=0, device="cpu")
    assert [e["epoch"] for e in res.history] == \
        [e["epoch"] for e in ref.history]
    assert res.best_epoch == ref.best_epoch
    errs = cs.run_errors(cs.run_of(res), cs.run_of(_jax_result(ref)))
    cs.check_run(errs, "port vs JAX, small setup")
    # the model is left holding the selected parameters
    for k, p in model.state_dict().items():
        assert torch.equal(p, res.params[k])


def _jax_result(res):
    return T.TrainResult(params=port_params(res.params),
                         history=res.history, best_epoch=res.best_epoch)


def test_trainer_without_validation_trains_every_epoch(small_setup):
    cfg, tb, _ = small_setup
    jm = jmodel.PeronaModel(cfg)
    ref = jtrainer.train_perona_reference(jm, tb, epochs=6, seed=1)
    model = port_model(cfg, jm.init(jax.random.PRNGKey(1)))
    res = T.train_perona_reference(model, tb, epochs=6, seed=1,
                                   device="cpu")
    assert res.best_epoch == ref.best_epoch == 5
    np.testing.assert_allclose([e["train_loss"] for e in res.history],
                               [e["train_loss"] for e in ref.history],
                               rtol=1e-4)
    # the key biases follow their gradients' rounding noise (exactly 0
    # in exact arithmetic) in both packages, so they are left out
    for k, v in port_params(ref.params).items():
        if k not in chip_smoke().ZERO_GRAD_LEAVES:
            np.testing.assert_allclose(res.params[k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)


def test_trainer_runs_on_the_card_by_default(small_setup):
    """With no device given the trainer takes the card; with no card it
    fails instead of running on the CPU."""
    cfg, tb, vb = small_setup
    model = M.PeronaModel(M.PeronaConfig(**dataclasses.asdict(cfg)))
    if torch.cuda.is_available():
        res = T.train_perona_reference(model, tb, vb, epochs=1)
        assert all(p.is_cuda for p in res.params.values())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.train_perona_reference(model, tb, vb, epochs=1)


def test_f1_model_hypers_and_batch_match_jax(small_setup):
    cfg, tb, _ = small_setup
    rng = np.random.default_rng(0)
    for _ in range(5):
        logits = rng.standard_normal(50).astype(np.float32)
        y = (rng.random(50) < 0.3).astype(np.int32)
        want = float(jtrainer._f1_outlier(jnp.asarray(logits),
                                          jnp.asarray(y)))
        got = float(T._f1_outlier(torch.from_numpy(logits),
                                  torch.from_numpy(y)))
        assert got == want
        assert abs(T._f1_host(logits, y) - want) <= 1e-6
    jcfg = dataclasses.replace(cfg, feature_dropout=0.2, edge_dropout=0.0)
    jh = jtrainer.model_hypers(jcfg, 1e-3, 2e-4)
    th = T.model_hypers(M.PeronaConfig(**dataclasses.asdict(jcfg)), 1e-3,
                        2e-4, "cpu")
    assert set(th) == set(jh)
    for k in jh:
        assert th[k].dtype == torch.float32 and float(th[k]) == float(jh[k])
    jb = jtrainer.batch_to_jnp(tb)
    b = T.batch_to_torch(tb, "cpu")
    assert set(b) == set(jb)
    for k in jb:
        assert np.array_equal(b[k].numpy(), np.asarray(jb[k])), k
        assert b[k].numpy().dtype == np.asarray(jb[k]).dtype, k


def test_evaluate_matches_jax(small_setup):
    cfg, _, vb = small_setup
    jm = jmodel.PeronaModel(cfg)
    params = jm.init(jax.random.PRNGKey(4))
    want = jtrainer.evaluate(jm, params, vb)
    model = M.PeronaModel(M.PeronaConfig(**dataclasses.asdict(cfg)))
    got = T.evaluate(model, port_params(params), vb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)


def test_params_carry_back_to_the_reference_tree(tmp_path):
    from repro.checkpointing.manager import CheckpointManager
    from repro.common.tree import tree_flatten_with_paths

    jcfg = jmodel.PeronaConfig(feature_dim=20, edge_dim=7)
    params = jmodel.perona_init(jcfg, jax.random.PRNGKey(2))
    model = port_model(jcfg, params)
    tree = params_to_numpy(model)
    want = dict(tree_flatten_with_paths(jax_tree(params)))
    got = dict(tree_flatten_with_paths(tree))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the reference's checkpoint manager writes the tree as a
    # step_<n>.npz, which both packages read back
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, tree)
    back = flat_params(load_npz(tmp_path / "step_3.npz"))
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    restored, _ = mgr.restore(params, step=3)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ golden
@pytest.fixture(scope="module")
def train_golden():
    return load_train_golden()


def test_fixed_point_matches_the_golden_file(train_golden):
    """The §IV-C batch at the golden's initial parameters, on the CPU:
    what phase [14b] of ``chip_smoke.py`` checks on the card."""
    cs = chip_smoke()
    tb, _ = cs.train_batches()
    errs = cs.fixed_point_errors(train_golden, tb, "cpu")
    cs.check_fixed_point(errs, "CPU vs JAX at fixed parameters")


def test_reference_trainer_matches_the_golden_history(train_golden):
    """The port's trainer over the golden's epochs at dropout 0, on the
    CPU, against the JAX reference trainer's history: what phase [14c]
    checks on the card, at the same measured limits."""
    cs = chip_smoke()
    tb, vb = cs.train_batches()
    m = train_golden.meta
    res = T.train_perona_reference(
        cs.golden_model(train_golden, "cpu"), tb, vb, device="cpu",
        epochs=m["epochs"], patience=m["patience"], lr=m["lr"],
        weight_decay=m["weight_decay"], seed=m["seed"])
    errs = cs.run_errors(cs.run_of(res), train_golden.ref)
    assert errs["first_rel"] <= 1e-4
    cs.check_run(errs, "CPU vs JAX reference trainer")


def test_port_batches_are_the_golden_writers(train_golden):
    """The port's §IV-C batches equal the JAX package's, which wrote the
    golden file."""
    from test_torch_train_golden import paper_batches

    cs = chip_smoke()
    tb, vb = cs.train_batches()
    cfg, jtb, jvb = paper_batches()
    assert (len(tb), len(vb)) == (1080, 360)
    assert dataclasses.asdict(train_golden.config) == \
        dataclasses.asdict(M.PeronaConfig(**dataclasses.asdict(cfg)))
    for ours, theirs in ((tb, jtb), (vb, jvb)):
        for k in T.BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(ours, k),
                                          getattr(theirs, k), err_msg=k)


@pytest.mark.gpu
def test_loss_and_gradients_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.edge_softmax import ops

    cfg = chip_smoke().dropout_free(M.PeronaConfig(feature_dim=20,
                                                   edge_dim=7))
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(0))
    b = to_torch(model_batch())
    tot, _ = model.loss(b)
    want = torch.autograd.grad(tot, list(model.parameters()))
    model.cuda()
    before = ops.BWD_LAUNCHES
    tot_c, _ = model.loss({k: v.cuda() for k, v in b.items()})
    got = torch.autograd.grad(tot_c, list(model.parameters()))
    assert ops.BWD_LAUNCHES == before + 1
    assert abs(float(tot_c.detach()) - float(tot.detach())) <= TERM_ATOL
    for (k, _), a, w in zip(model.named_parameters(), got, want):
        if k not in chip_smoke().ZERO_GRAD_LEAVES:
            assert float((a.cpu() - w).norm() / w.norm()) <= GRAD_RTOL, k
