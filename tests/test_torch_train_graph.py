"""The port's device-resident trainer (``repro_torch.core.trainer.
train_perona``, its epoch program) against the JAX package's scanned
``train_perona``, from the same initial parameters at dropout 0; and the
properties the CUDA graph of the epoch relies on, checked on the CPU:
no host read inside an epoch, one program per configuration, the
host loop's masks at positive dropouts."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import model as jmodel  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core import trainer as T  # noqa: E402
from test_torch_train import (chip_smoke, port_model,  # noqa: E402
                              port_params)


@pytest.fixture(scope="module")
def small_setup():
    """``tests/test_torch_train.py``'s setup at dropout 0."""
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


def _jax_result(res):
    return T.TrainResult(params=port_params(res.params),
                         history=res.history, best_epoch=res.best_epoch)


# (epochs, patience, with validation): early stopping inside the run;
# no validation batch (train_noval); zero epochs
CASES = {"early_stopping": (60, 0, True), "no_validation": (6, 25, False),
         "zero_epochs": (0, 25, True), "zero_epochs_no_validation":
         (0, 25, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_perona_matches_jax_scanned_trainer(small_setup, case):
    """History (early stopping included), best epoch and selected
    parameters as ``repro.core.trainer.train_perona`` (the scanned
    trainer), from the same initial parameters at dropout 0, within
    ``chip_smoke.py``'s measured limits for whole runs."""
    cs = chip_smoke()
    epochs, patience, with_val = CASES[case]
    cfg, tb, vb = small_setup
    vb = vb if with_val else None
    jm = jmodel.PeronaModel(cfg)
    ref = jtrainer.train_perona(jm, tb, vb, epochs=epochs,
                                patience=patience, seed=0)
    model = port_model(cfg, jm.init(jax.random.PRNGKey(0)))
    res = T.train_perona(model, tb, vb, epochs=epochs, patience=patience,
                         seed=0, device="cpu")
    assert [e["epoch"] for e in res.history] == \
        [e["epoch"] for e in ref.history]
    assert res.best_epoch == ref.best_epoch
    want = port_params(ref.params)
    if epochs == 0:
        assert res.history == [] and res.stats["captured"] == 0
        for k, v in want.items():
            assert torch.equal(res.params[k], v), k
        return
    if with_val:
        assert len(ref.history) < epochs, "patience must trigger"
        errs = cs.run_errors(cs.run_of(res), cs.run_of(_jax_result(ref)))
        cs.check_run(errs, "port train_perona vs JAX train_perona")
    else:
        np.testing.assert_allclose([e["train_loss"] for e in res.history],
                                   [e["train_loss"] for e in ref.history],
                                   rtol=1e-4)
        for k, v in want.items():
            if k not in cs.ZERO_GRAD_LEAVES:
                np.testing.assert_allclose(res.params[k].numpy(),
                                           v.numpy(), atol=1e-5, err_msg=k)
    # the model is left holding the selected parameters
    for k, p in model.state_dict().items():
        assert torch.equal(p, res.params[k])


class HostRead(AssertionError):
    pass


def _program(cfg, tb, vb, epochs=4, patience=25, lr=3e-3, wd=1e-4,
             seed=0, params0=None):
    """A fresh epoch program loaded with a run's inputs on the CPU."""
    tbt = T.batch_to_torch(tb, "cpu")
    vbt = T.batch_to_torch(vb, "cpu")
    prog = T.EpochProgram(T.canonical_config(cfg), epochs, patience, True,
                          torch.device("cpu"))
    model = M.PeronaModel(cfg, generator=torch.Generator().manual_seed(1))
    params0 = params0 or {k: p.detach() for k, p in
                          model.named_parameters()}
    hypers = {k: float(v) for k, v in
              T.model_hypers(cfg, lr, wd, "cpu").items()}
    prog._load(params0, tbt, vbt, hypers, seed)
    return prog


def test_epoch_does_no_host_read(small_setup, monkeypatch):
    """An epoch at positive dropouts, validation included, with every
    way of reading a tensor on the host made to raise: what lets the
    card replay it as a CUDA graph with no sync. The epoch still moved
    the parameters and wrote its history row."""
    cfg, tb, vb = small_setup
    cfg = M.PeronaConfig(**dataclasses.asdict(dataclasses.replace(
        cfg, feature_dropout=0.1, edge_dropout=0.2, alpha_dropout=0.05)))
    prog = _program(cfg, tb, vb)
    before = {k: p.detach().clone() for k, p in prog.params.items()}

    def refuse(*_, **__):
        raise HostRead("host read inside the epoch")

    with monkeypatch.context() as mp:
        for name in ("item", "__bool__", "__float__", "__int__",
                     "__index__", "tolist", "cpu", "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        with pytest.raises(HostRead):
            bool(torch.ones(()))  # the patch is live
        prog._epoch()
        prog._epoch()
    assert int(prog.epoch) == 2
    assert not torch.equal(prog.params["enc.0.w"], before["enc.0.w"])
    hist = prog.history.numpy()
    assert np.isfinite(hist[:2]).all() and (hist[:2, 3] == 1).all()
    assert (hist[2:] == 0).all()


def test_programs_are_cached_per_canonical_configuration(small_setup):
    """Trials that differ only in scalar hypers share one program (one
    capture on the card); another head count, epoch count or batch
    shape builds its own."""
    cfg, tb, vb = small_setup
    pcfg = M.PeronaConfig(**dataclasses.asdict(cfg))

    def run(c, epochs=3, batch=tb, **kw):
        model = M.PeronaModel(c, generator=torch.Generator().manual_seed(0))
        return T.train_perona(model, batch, vb, epochs=epochs,
                              device="cpu", **kw).stats["captured"]

    T._program.cache_clear()
    assert run(pcfg) == 1
    assert run(pcfg) == 0
    assert run(dataclasses.replace(pcfg, cbfl_gamma=3.0), lr=1e-2,
               weight_decay=1e-5) == 0
    assert run(dataclasses.replace(pcfg, heads=2)) == 1
    assert run(pcfg, epochs=4) == 1
    assert run(pcfg, batch=tb.subset(np.arange(len(tb) - 1))) == 1
    assert run(pcfg) == 0


def test_a_reused_program_starts_each_run_afresh(small_setup):
    """A second run on the cached program from other initial parameters
    and hypers equals a run on a fresh program: nothing of the first run
    (optimizer moments, step, best checkpoint, early stopping, history,
    generator) carries over."""
    cfg, tb, vb = small_setup
    pcfg = M.PeronaConfig(**dataclasses.asdict(dataclasses.replace(
        cfg, feature_dropout=0.2, edge_dropout=0.1, alpha_dropout=0.05)))
    used = _program(pcfg, tb, vb, epochs=5, patience=0)
    for _ in range(5):
        used._epoch()
    other = M.PeronaModel(pcfg, generator=torch.Generator().manual_seed(9))
    params0 = {k: p.detach() for k, p in other.named_parameters()}
    hypers = {k: float(v) for k, v in
              T.model_hypers(pcfg, 1e-2, 1e-3, "cpu").items()}
    fresh = _program(pcfg, tb, vb, epochs=5, patience=0, lr=1e-2, wd=1e-3,
                     seed=4, params0=params0)
    used._load(params0, T.batch_to_torch(tb, "cpu"),
               T.batch_to_torch(vb, "cpu"), hypers, 4)
    for prog in (used, fresh):
        for _ in range(5):
            prog._epoch()
    a, b = used.result(), fresh.result()
    assert [e["epoch"] for e in a[1]] == [e["epoch"] for e in b[1]]
    assert a[2] == b[2]
    np.testing.assert_allclose([e["train_loss"] for e in a[1]],
                               [e["train_loss"] for e in b[1]], rtol=1e-5)
    for k in a[0]:
        torch.testing.assert_close(a[0][k], b[0][k], rtol=1e-4, atol=1e-5)


def test_positive_dropouts_draw_the_host_loops_masks(small_setup):
    """At the default recipe's dropouts the graphed trainer draws the
    host loop's training masks (the generator seeded ``seed + 1``) and
    its validation masks (seeded 0, the same every epoch): both runs
    agree to float32 rounding (the hypers are tensors in one and floats
    in the other), and another seed moves the run."""
    cfg, tb, vb = small_setup
    pcfg = M.PeronaConfig(**dataclasses.asdict(dataclasses.replace(
        cfg, feature_dropout=0.1, edge_dropout=0.1, alpha_dropout=0.05)))

    def run(train, seed=0):
        model = M.PeronaModel(pcfg, generator=torch.Generator().manual_seed(3))
        res = train(model, tb, vb, epochs=5, seed=seed, device="cpu")
        return np.asarray([[e["train_loss"], e["val_loss"]]
                           for e in res.history])

    graphed = run(T.train_perona)
    host = run(T.train_perona_reference)
    np.testing.assert_allclose(graphed, host, rtol=1e-5)
    other = run(T.train_perona, seed=1)
    assert np.abs(other[:, 0] - graphed[:, 0]).max() > 1e-3


def test_fixed_draws_replay_the_same_uniforms():
    draws = T.FixedDraws("cpu")
    first = [draws.rand((3, 2), "cpu"), draws.rand((4,), "cpu")]
    want = torch.Generator().manual_seed(0)
    assert torch.equal(first[0], torch.rand((3, 2), generator=want))
    assert torch.equal(first[1], torch.rand((4,), generator=want))
    again = [draws.rewind().rand((3, 2), "cpu"), draws.rand((4,), "cpu")]
    assert all(a is b for a, b in zip(first, again))
    with pytest.raises(ValueError, match="shape"):
        draws.rewind().rand((2, 2), "cpu")


def test_train_perona_runs_on_the_card_by_default(small_setup):
    cfg, tb, vb = small_setup
    model = M.PeronaModel(M.PeronaConfig(**dataclasses.asdict(cfg)))
    if torch.cuda.is_available():
        res = T.train_perona(model, tb, vb, epochs=1)
        assert all(p.is_cuda for p in res.params.values())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.train_perona(model, tb, vb, epochs=1)
