"""The port's model plane (``repro_torch/fleet/modelplane.py``) against the
JAX package's: the reference's lifecycle tests (``tests/test_modelplane.py``)
run in both packages on the same stream, with the registry, the plane's
status and its tracer instants compared and the scores held at 1e-5; the
reference's bit-for-bit claims proved again inside the port; registries
moving between the packages; and the port's default retrain."""

import dataclasses
import os
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.model import PeronaModel as JModel  # noqa: E402
from repro.fleet import FleetScoringService as JService  # noqa: E402
from repro.fleet import IngestionDaemon as JDaemon  # noqa: E402
from repro.fleet import ModelPlane as JPlane  # noqa: E402
from repro.fleet import ModelRegistry as JRegistry  # noqa: E402
from repro.fleet import fleet_telemetry as jtelemetry  # noqa: E402
from repro_torch.core.params import flat_params  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402
from repro_torch.fleet import (FleetScoringService,  # noqa: E402
                               IngestionDaemon, ModelPlane, ModelRegistry,
                               fleet_telemetry, modelplane)
from repro_torch.obs.trace import CAT_PLANE  # noqa: E402

from _torch_fleet_pair import fleet_pair  # noqa: E402

# tests/test_modelplane.py:22-23
MACHINES = {"mp-0": "e2-medium", "mp-1": "n2-standard-4",
            "mp-2": "e2-medium"}
SCORE_ATOL = 1e-5
CODE_ATOL = 2e-4  # the reference's service-vs-engine limit for codes
# wall-clock readings: compared in neither direction
WALL = ("latency_ratio_max",)


@pytest.fixture(scope="module")
def pair():
    """The reference test's set-up (``SuiteRunner(seed=5)``, 10 runs a
    type, untrained ``PRNGKey(0)`` parameters) in both packages; the
    port's parameters as ``state_dict`` names, the serve modes' form."""
    p = fleet_pair(MACHINES)
    p.torch.params = flat_params(p.torch.params)
    return p


# ------------------------------------------- one scenario, two packages

def _package(pair, name):
    """The classes and the parameter forms of one package."""
    if name == "jax":
        side = pair.jax
        return SimpleNamespace(
            side=side, plane=JPlane, telemetry=jtelemetry,
            service=lambda: JService(side.model, side.params, side.pre,
                                     sharded=False),
            daemon=JDaemon,
            scaled=lambda s: jax.tree_util.tree_map(
                lambda x: np.asarray(x) * s, side.params))
    side = pair.torch
    return SimpleNamespace(
        side=side, plane=ModelPlane, telemetry=fleet_telemetry,
        service=lambda: FleetScoringService(side.model, side.params,
                                            side.pre, device="cpu"),
        daemon=IngestionDaemon,
        scaled=lambda s: {k: v * s for k, v in side.params.items()})


def _setup(pkg):
    svc = pkg.service()
    svc.seed_history(pkg.side.frame)
    daemon = pkg.daemon(svc, capacity_rows=512, flush_interval=0.5,
                        flush_rows=1 << 30, service_time_scale=0.0)
    return svc, daemon


def _events(pkg, rounds, seed=7):
    return pkg.telemetry(MACHINES, rounds=rounds, runs_per_type=1,
                         seed=seed, interval=1.0, jitter=0.01)


def _plane(pkg, svc, daemon, path, **kw):
    kw.setdefault("canary_flushes", 1)
    kw.setdefault("watch_flushes", 2)
    kw.setdefault("min_health_shift", 1.0)  # only NaN should trip
    kw.setdefault("latency_budget", 100.0)  # not a wall-clock test
    return pkg.plane(svc, path, daemon=daemon, **kw)


def _hot_swap(pkg, path):
    """tests/test_modelplane.py:151-189."""
    svc, daemon = _setup(pkg)
    plane = _plane(pkg, svc, daemon, path)
    plane.bootstrap(pkg.side.params)
    events = _events(pkg, 4)
    k = len(events) // 2
    daemon.run(events[:k], drain=False)
    plane.submit_candidate(pkg.side.params, source="test")
    res = daemon.run(events[k:], drain=True)
    return svc, daemon, plane, res


def _nan_rollback(pkg, path):
    """tests/test_modelplane.py:194-238."""
    svc, daemon = _setup(pkg)
    plane = _plane(pkg, svc, daemon, path, watch_flushes=3)
    plane.bootstrap(pkg.side.params)
    events = _events(pkg, 4)
    k = len(events) // 2
    daemon.run(events[:k], drain=False)
    vid = plane.registry.save_version(pkg.scaled(np.nan), source="bad")
    plane.promote(vid, force=True)
    res = daemon.run(events[k:], drain=True)
    return svc, daemon, plane, res


def _canary_reject(pkg, path):
    """tests/test_modelplane.py:243-268."""
    svc, daemon = _setup(pkg)
    plane = _plane(pkg, svc, daemon, path, canary_flushes=2)
    plane.bootstrap(pkg.side.params)
    events = _events(pkg, 4)
    k = len(events) // 3
    daemon.run(events[:k], drain=False)
    plane.submit_candidate(pkg.scaled(10.0), source="divergent")
    res = daemon.run(events[k:], drain=True)
    return svc, daemon, plane, res


def _drift_retrain(pkg, path):
    """tests/test_modelplane.py:273-300."""
    svc, daemon = _setup(pkg)
    retrained = []

    def retrain(service):
        retrained.append(len(service.store))
        return pkg.side.params  # identical params: canary must pass

    plane = _plane(pkg, svc, daemon, path, watch_flushes=1,
                   drift_flag_flushes=2, drift_ewma_threshold=0.0,
                   drift_min_scored=1, retrain_fn=retrain)
    plane.bootstrap(pkg.side.params)
    res = daemon.run(_events(pkg, 4))
    plane.retrained = retrained
    return svc, daemon, plane, res


SCENARIOS = {"hot_swap": _hot_swap, "nan_rollback": _nan_rollback,
             "canary_reject": _canary_reject,
             "drift_retrain": _drift_retrain}


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Each scenario run once in each package (``runs[scenario][pkg]``)."""
    out = {}
    for name, fn in SCENARIOS.items():
        out[name] = {}
        for pkg in ("jax", "torch"):
            path = tmp_path_factory.mktemp(f"{name}-{pkg}") / "registry"
            svc, daemon, plane, res = fn(_package(pair, pkg), path)
            out[name][pkg] = SimpleNamespace(svc=svc, daemon=daemon,
                                             plane=plane, res=res,
                                             path=path)
    return out


def _reference_run(pair, rounds=4):
    """The same stream through the port with no plane."""
    pkg = _package(pair, "torch")
    svc, daemon = _setup(pkg)
    return svc, daemon.run(_events(pkg, rounds))


def _assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert len(got[n]) == len(want[n])
        for g, w in zip(got[n], want[n]):
            for k in ("anomaly_prob", "codes", "type_logits", "row_ids"):
                np.testing.assert_array_equal(getattr(g, k), getattr(w, k))


def _assert_results_close(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert len(got[n]) == len(want[n])
        for g, w in zip(got[n], want[n]):
            np.testing.assert_array_equal(g.row_ids, w.row_ids)
            np.testing.assert_allclose(g.anomaly_prob, w.anomaly_prob,
                                       atol=SCORE_ATOL)
            for k in ("codes", "type_logits"):
                np.testing.assert_allclose(getattr(g, k), getattr(w, k),
                                           atol=CODE_ATOL)


def _close(a, b, path="") -> None:
    """``a`` equals ``b``, floats within SCORE_ATOL (nan to nan, inf to
    inf), dicts and lists element by element."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            if k not in WALL:
                _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, float) and not float(b).is_integer():
        np.testing.assert_allclose(a, b, atol=SCORE_ATOL, err_msg=path)
    else:
        assert a == b, path


def _instants(daemon):
    return [(e.name, e.ts, dict(e.args or {}))
            for e in daemon.tracer.events() if e.cat == CAT_PLANE]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_lifecycle_equals_jax(runs, scenario):
    """Registry, status, plane instants and service counts as the JAX
    package's run of the same test; scores and the store at 1e-5."""
    j, t = runs[scenario]["jax"], runs[scenario]["torch"]
    _assert_results_close(t.res, j.res)
    np.testing.assert_array_equal(np.isnan(t.svc.store.anomaly),
                                  np.isnan(j.svc.store.anomaly))
    np.testing.assert_allclose(t.svc.store.anomaly, j.svc.store.anomaly,
                               atol=SCORE_ATOL)
    _close(t.plane.status(), j.plane.status(), "status")
    _close(t.plane.registry.list_versions(),
           j.plane.registry.list_versions(), "registry")
    assert (t.plane.registry.incumbent, t.plane.registry.previous) == \
        (j.plane.registry.incumbent, j.plane.registry.previous)
    _close(_instants(t.daemon), _instants(j.daemon), "instants")
    for k in ("rows_scored", "flushes", "dispatches", "shadow_dispatches",
              "param_swaps", "warm_dispatches", "traces", "store_rows"):
        assert t.svc.stats[k] == j.svc.stats[k], k
    st, jst = t.daemon.stats(), j.daemon.stats()
    for k in ("events_seen", "rows_staged_total", "deadline_flushes",
              "drain_flushes", "flush_failures"):
        assert st[k] == jst[k], k


def test_hot_swap_identical_candidate_is_invisible(pair, runs):
    """An identical candidate canaried and promoted mid-stream changes
    nothing, bit for bit against a port run that never swapped; no event
    is dropped or double-scored, and the candidate ran on every live
    shape before the swap."""
    t = runs["hot_swap"]["torch"]
    ref_svc, ref_res = _reference_run(pair)
    _assert_results_equal(t.res, ref_res)
    np.testing.assert_array_equal(t.svc.store.anomaly, ref_svc.store.anomaly)
    assert len(t.svc.store) == len(ref_svc.store)
    st = t.daemon.stats()
    assert st["events_seen"] == 4 * len(MACHINES)
    assert st["rows_staged_total"] == t.svc.stats["rows_scored"]
    assert t.svc.stats["rows_scored"] == ref_svc.stats["rows_scored"]
    assert t.svc.stats["param_swaps"] == 1
    assert t.svc.stats["shadow_dispatches"] > 0
    assert t.svc.stats["warm_dispatches"] > 0
    assert t.svc.trace_count == ref_svc.trace_count  # no new signature
    status = t.plane.status()
    assert (status["promotions"], status["rollbacks"]) == (1, 0)
    vid = t.plane.registry.incumbent
    assert t.plane.registry.entry(vid)["verdict"]["passed"]
    assert t.plane.registry.entry(vid)["verdict"]["divergence_max"] == 0.0


def test_nan_candidate_rolls_back_and_repairs(pair, runs):
    """A NaN candidate forced past the canary is rolled back by the
    watch on its first flush; the store and the in-flight results end bit
    for bit as a port run that never promoted."""
    t = runs["nan_rollback"]["torch"]
    ref_svc, ref_res = _reference_run(pair)
    st = t.plane.status()
    assert st["rollbacks"] == 1 and st["phase"] == "steady"
    assert st["repaired_rows"] > 0
    assert t.plane.registry.incumbent == 1
    assert t.plane.registry.entry(2)["status"] == "rolled_back"
    _assert_results_equal(t.res, ref_res)
    np.testing.assert_array_equal(t.svc.store.anomaly, ref_svc.store.anomaly)
    scored = np.isfinite(ref_svc.store.anomaly)
    assert np.isfinite(t.svc.store.anomaly[scored]).all()
    names = [e.name for e in t.daemon.tracer.events()]
    i_p, i_r = (names.index("modelplane.promote"),
                names.index("modelplane.rollback"))
    assert i_p < i_r
    rb = t.daemon.tracer.events()[i_r]
    assert rb.args["reason"] == "nonfinite"
    assert rb.args["after_flushes"] == 1


def test_canary_rejects_divergent_candidate(runs):
    t = runs["canary_reject"]["torch"]
    st = t.plane.status()
    assert (st["canary_fail"], st["promotions"]) == (1, 0)
    assert t.svc.stats["param_swaps"] == 0
    entry = t.plane.registry.entry(2)
    assert entry["status"] == "rejected"
    assert entry["verdict"]["passed"] is False
    assert "divergence" in entry["verdict"]["failed_checks"]
    assert entry["verdict"]["divergence_max"] > t.plane.divergence_budget
    names = [e.name for e in t.daemon.tracer.events()]
    assert "modelplane.canary_fail" in names
    assert "modelplane.promote" not in names


def test_drift_triggers_retrain_canary_promote(runs):
    t, j = runs["drift_retrain"]["torch"], runs["drift_retrain"]["jax"]
    st = t.plane.status()
    assert len(t.plane.retrained) == 1
    assert t.plane.retrained == j.plane.retrained  # the same store size
    assert st["retrains"] == 1 and st["promotions"] >= 1
    sources = {e["source"]: e for e in t.plane.registry.list_versions()}
    assert sources["drift-retrain"]["status"] == "incumbent"
    assert sources["drift-retrain"]["extra"]["nodes"]
    assert "modelplane.retrain" in [e.name for e in t.daemon.tracer.events()]


# ------------------------------------------------------------- registry

def test_registry_roundtrip_and_crash_safety(tmp_path, monkeypatch):
    """tests/test_modelplane.py:75-116 on tensors: versions survive a
    restart; a crash while rewriting the index keeps the old one."""
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.zeros(3)}
    reg = ModelRegistry(tmp_path / "reg")
    v1 = reg.save_version(params, source="boot")
    reg.set_incumbent(v1)
    v2 = reg.save_version({"w": params["w"] * 2, "b": params["b"]},
                          source="retrain")
    reg.record_verdict(v2, {"passed": False,
                            "failed_checks": ["divergence"]})
    reg.tag(v1, "golden")

    reg2 = ModelRegistry(tmp_path / "reg")
    assert reg2.incumbent == v1
    assert [e["version"] for e in reg2.list_versions()] == [v1, v2]
    assert reg2.entry(v1)["tags"] == ["golden"]
    assert reg2.entry(v2)["verdict"]["failed_checks"] == ["divergence"]
    got = reg2.load_version(params, v2)
    assert torch.equal(got["w"], params["w"] * 2)

    before = reg2.list_versions()
    real_replace = os.replace

    def boom(src, dst, *a, **k):
        if str(dst).endswith("registry.json"):
            raise OSError("disk full")
        return real_replace(src, dst, *a, **k)

    monkeypatch.setattr(modelplane.os, "replace", boom)
    with pytest.raises(OSError):
        reg2.save_version(params, source="crash")
    monkeypatch.setattr(modelplane.os, "replace", real_replace)
    reg3 = ModelRegistry(tmp_path / "reg")
    assert reg3.list_versions() == before
    assert reg3.incumbent == v1
    # and the registry file is the reference's: JAX reads it alike
    jreg = JRegistry(tmp_path / "reg")
    assert jreg.list_versions() == before and jreg.incumbent == v1


def test_registry_pins_incumbent_against_gc(tmp_path):
    """tests/test_modelplane.py:119-133, and the same operations through
    the JAX registry: the same versions and the same files kept."""
    params = {"w": torch.ones(4)}
    regs = {"torch": ModelRegistry(tmp_path / "reg", keep_last=1),
            "jax": JRegistry(tmp_path / "jreg", keep_last=1)}
    for name, reg in regs.items():
        p = params if name == "torch" else {"w": params["w"].numpy()}
        v1 = reg.save_version(p, source="boot")
        reg.set_incumbent(v1)
        for k in range(3):
            last = reg.save_version({"w": p["w"] + k}, source="cand")
    reg = regs["torch"]
    assert torch.equal(reg.load_version(params, v1)["w"], params["w"])
    reg.load_version(params, last)  # newest unpinned survives
    with pytest.raises(FileNotFoundError):
        reg.load_version(params, last - 1)  # older candidate GC'd
    assert sorted(reg.manager.all_steps()) == [v1, last]
    assert reg.list_versions() == regs["jax"].list_versions()
    assert sorted(regs["jax"].manager.all_steps()) == [v1, last]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registry_moves_between_packages(pair, runs, writer, tmp_path):
    """The nan_rollback run's registry, written by one package, read by
    the other: the same versions, and every version's parameters bit
    for bit."""
    path = tmp_path / "registry"
    shutil.copytree(runs["nan_rollback"][writer].path, path)
    reg, jreg = ModelRegistry(path), JRegistry(path)
    assert reg.list_versions() == jreg.list_versions()
    assert len(reg.list_versions()) == 2
    assert (reg.incumbent, reg.previous) == (jreg.incumbent, jreg.previous)
    template = pair.torch.params
    for e in jreg.list_versions():
        got = reg.load_version(template, e["version"])
        want = flat_params(params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jreg.load_version(pair.jax.params, e["version"]))))
        assert sorted(got) == sorted(template)
        for k, v in want.items():
            assert got[k].dtype == template[k].dtype
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)


def _cli(fn, argv_or_args, capsys):
    """Printed lines of one offline command, and its SystemExit text."""
    capsys.readouterr()
    try:
        fn(argv_or_args)
        exit_text = None
    except SystemExit as e:
        exit_text = str(e)
    return capsys.readouterr().out.splitlines(), exit_text


@pytest.mark.parametrize("cmd", ["status", "list", "promote", "rollback"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("scenario", ["hot_swap", "canary_reject"])
def test_modelplane_cmd_prints_the_references_lines(runs, scenario, writer,
                                                    cmd, tmp_path, capsys):
    """``--modelplane-cmd`` of the port against the reference's
    ``_modelplane_cmd`` on copies of one registry written by either
    package (a tag added): the same lines, the same refusal, the same
    registry afterwards."""
    import argparse
    import json

    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    src = tmp_path / "src"
    shutil.copytree(runs[scenario][writer].path, src)
    (JRegistry if writer == "jax" else ModelRegistry)(src).tag(1, "golden")
    ref, port = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    want = _cli(jserve._modelplane_cmd, argparse.Namespace(
        registry=str(ref), modelplane_cmd=cmd, version=1), capsys)
    got = _cli(serve.main, ["--modelplane-cmd", cmd, "--registry",
                            str(port), "--version", "1"], capsys)
    assert got == want
    assert json.loads((port / "registry.json").read_text()) == \
        json.loads((ref / "registry.json").read_text())


# ------------------------------------------------------ default retrain

RETRAIN_EPOCHS = 40  # the plane's default
# The retrain's losses against JAX's, per block of 10 epochs. PR 22's
# limits (chip_smoke.py TRAIN_LOSS_RTOL: 1e-4, 1e-4, 1e-4, 5e-4) were
# measured on the §IV-C batch; on this 216-row store JAX's own two
# trainers (train_perona_reference against the scanned train_perona)
# already disagree by up to 1.9e-6, 2.9e-5, 9.8e-5 and 1.7e-3 per block
# over retrain seeds 0-5, and the port's train_perona by up to 1.6e-5,
# 1.7e-4, 6.9e-4 and 1.5e-3 (``python tests/test_torch_modelplane.py
# --measure``). The limits are about three times the worse of the two,
# rounded up to 1, 2 or 5; the selected parameters keep PR 22's
# TRAIN_PARAMS_RTOL (measured at most 2.8e-3 here).
RETRAIN_LOSS_RTOL = (1e-4, 5e-4, 2e-3, 5e-3)


def _retrain_services(pair):
    """Services of both packages over the same store (history plus two
    streamed rounds, 216 rows), on dropout-free models of the fleet
    pair's configuration."""
    from repro_torch.core.model import PeronaConfig, PeronaModel

    cfg = dataclasses.replace(pair.jax.model.cfg, feature_dropout=0.0,
                              edge_dropout=0.0, alpha_dropout=0.0)
    models = {"jax": JModel(cfg),
              "torch": PeronaModel(PeronaConfig(**dataclasses.asdict(cfg)))}
    svcs = {}
    for name, m in models.items():
        pkg = _package(pair, name)
        svc = (JService(m, pair.jax.params, pair.jax.pre, sharded=False)
               if name == "jax" else
               FleetScoringService(m, pair.torch.params, pair.torch.pre,
                                   device="cpu"))
        svc.seed_history(pkg.side.frame)
        pkg.daemon(svc, capacity_rows=512, flush_interval=0.5,
                   flush_rows=1 << 30, service_time_scale=0.0).run(
            _events(pkg, 2))
        svcs[name] = svc
    return svcs


@pytest.fixture(scope="module")
def retrain_pair(pair):
    return _retrain_services(pair)


def _captured_retrain(monkeypatch, target, plane, svc):
    """``plane._default_retrain(svc)`` with ``target.train_perona``
    wrapped to keep its batch and result."""
    seen = {}
    real = target.train_perona

    def wrapped(model, batch, *a, **kw):
        seen["batch"] = batch
        seen["result"] = real(model, batch, *a, **kw)
        return seen["result"]

    monkeypatch.setattr(target, "train_perona", wrapped)
    seen["params"] = plane._default_retrain(svc)
    monkeypatch.setattr(target, "train_perona", real)
    return seen


def test_default_retrain_leaves_the_service_untouched(retrain_pair,
                                                      tmp_path):
    """The retrain trains a fresh model seeded by ``retrain_seed``: the
    service's model and parameters are the same objects holding the same
    values afterwards, and two retrains with one seed agree."""
    svc = retrain_pair["torch"]
    plane = ModelPlane(svc, tmp_path / "reg", retrain_epochs=3)
    model_before = {k: v.clone() for k, v in svc.model.state_dict().items()}
    params, params_before = svc.params, {k: v.clone()
                                         for k, v in svc.params.items()}
    out = plane._default_retrain(svc)
    assert svc.params is params
    for k, v in params_before.items():
        assert torch.equal(svc.params[k], v), k
    for k, v in svc.model.state_dict().items():
        assert torch.equal(v, model_before[k]), k
    assert sorted(out) == sorted(model_before)
    assert any(not torch.equal(out[k], v) for k, v in params_before.items())
    again = plane._default_retrain(svc)
    # the CPU's threaded sums may differ in the last bits run to run
    for k, v in out.items():
        torch.testing.assert_close(again[k], v, rtol=1e-5, atol=1e-6)


def test_default_retrain_keeps_no_program(retrain_pair, tmp_path,
                                          monkeypatch):
    """Each retrain builds its epoch program for that run only (the
    store, hence the batch shape, grows between episodes): the program
    cache does not grow, and the program is gone when the retrain
    returns, with no garbage collection in between."""
    import weakref

    from repro_torch.core import trainer as T

    built = []

    class Tracked(T.EpochProgram):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(weakref.ref(self))

    monkeypatch.setattr(T, "EpochProgram", Tracked)
    svc = retrain_pair["torch"]
    plane = ModelPlane(svc, tmp_path / "reg", retrain_epochs=2)
    cached = T._program.cache_info().currsize
    for _ in range(2):
        assert plane._default_retrain(svc) is not None
    assert len(built) == 2
    assert all(ref() is None for ref in built)
    assert T._program.cache_info().currsize == cached


def test_default_retrain_batch_equals_jax_build_graphs(retrain_pair,
                                                       tmp_path,
                                                       monkeypatch):
    import repro.core.trainer as jtrainer

    jsvc, svc = retrain_pair["jax"], retrain_pair["torch"]
    assert len(svc.store) == len(jsvc.store)
    plane = ModelPlane(svc, tmp_path / "p", retrain_epochs=1)
    jplane = JPlane(jsvc, tmp_path / "j", retrain_epochs=1)
    got = _captured_retrain(monkeypatch, modelplane, plane, svc)["batch"]
    want = _captured_retrain(monkeypatch, jtrainer, jplane, jsvc)["batch"]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)


def _retrain_errors(svcs, seed, monkeypatch, tmp_path):
    """Both packages' default retrains from JAX's
    ``model.init(PRNGKey(seed))`` (the port's fresh model patched to hold
    it): the losses' relative error per epoch and the selected
    parameters' relative L2 error (all leaves but the key biases)."""
    import repro.core.trainer as jtrainer
    from test_torch_train import chip_smoke

    jsvc, svc = svcs["jax"], svcs["torch"]
    init = flat_params(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jsvc.model.init(jax.random.PRNGKey(seed)))))
    real_model = modelplane.PeronaModel

    def seeded(cfg, generator=None):
        m = real_model(cfg, generator=generator)
        m.load_state_dict(init)
        return m

    monkeypatch.setattr(modelplane, "PeronaModel", seeded)
    plane = ModelPlane(svc, tmp_path / "p", retrain_epochs=RETRAIN_EPOCHS,
                       retrain_seed=seed)
    jplane = JPlane(jsvc, tmp_path / "j", retrain_epochs=RETRAIN_EPOCHS,
                    retrain_seed=seed)
    got = _captured_retrain(monkeypatch, modelplane, plane, svc)
    want = _captured_retrain(monkeypatch, jtrainer, jplane, jsvc)
    monkeypatch.setattr(modelplane, "PeronaModel", real_model)
    tl = np.array([e["train_loss"] for e in got["result"].history])
    jl = np.array([e["train_loss"] for e in want["result"].history])
    assert len(tl) == len(jl) == RETRAIN_EPOCHS
    jparams = flat_params(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, want["params"])))
    live = [k for k in jparams if k not in chip_smoke().ZERO_GRAD_LEAVES]
    num = sum(float((got["params"][k] - jparams[k]).square().sum())
              for k in live)
    den = sum(float(jparams[k].square().sum()) for k in live)
    return np.abs(tl - jl) / np.abs(jl), (num / den) ** 0.5


@pytest.mark.parametrize("seed", [0, 3])  # the plane's default; another
def test_default_retrain_matches_jax_from_the_same_init(retrain_pair, seed,
                                                        tmp_path,
                                                        monkeypatch):
    """With the fresh model's initial parameters patched to JAX's
    ``model.init(PRNGKey(retrain_seed))`` and dropout 0, the retrain's
    losses are within RETRAIN_LOSS_RTOL per block of 10 epochs and its
    parameters within PR 22's TRAIN_PARAMS_RTOL of the reference's."""
    from test_torch_train import chip_smoke

    rel, params_rel = _retrain_errors(retrain_pair, seed, monkeypatch,
                                      tmp_path)
    for e, r in enumerate(rel):
        assert r <= RETRAIN_LOSS_RTOL[e // 10], (e, r)
    assert params_rel <= chip_smoke().TRAIN_PARAMS_RTOL


def _measure(seeds=range(6)):
    """Per block of 10 epochs, the largest relative loss error of JAX's
    train_perona_reference and of the port's default retrain against
    JAX's scanned train_perona on the retrain store, over ``seeds``."""
    import tempfile
    from pathlib import Path

    from repro.core.graph_data import build_graphs
    from repro.core.trainer import train_perona as jscan
    from repro.core.trainer import train_perona_reference as jhost

    pair = fleet_pair(MACHINES)
    pair.torch.params = flat_params(pair.torch.params)
    svcs = _retrain_services(pair)
    jsvc = svcs["jax"]
    batch = build_graphs(jsvc.store.frame, jsvc.preproc)
    mp = pytest.MonkeyPatch()
    for seed in seeds:
        scan = [e["train_loss"] for e in jscan(
            jsvc.model, batch, epochs=RETRAIN_EPOCHS, seed=seed).history]
        host = [e["train_loss"] for e in jhost(
            jsvc.model, batch, epochs=RETRAIN_EPOCHS, seed=seed).history]
        jrel = np.abs(np.subtract(host, scan)) / np.abs(scan)
        with tempfile.TemporaryDirectory() as d:
            rel, params_rel = _retrain_errors(svcs, seed, mp, Path(d))
        blocks = range(0, RETRAIN_EPOCHS, 10)
        print(f"seed {seed} ({len(batch.x)} rows): JAX host loop "
              + " ".join(f"{jrel[i:i + 10].max():.1e}" for i in blocks)
              + "; port " + " ".join(f"{rel[i:i + 10].max():.1e}"
                                     for i in blocks)
              + f"; port parameters rel L2 {params_rel:.1e}")
    mp.undo()


if __name__ == "__main__":
    import sys

    if "--measure" in sys.argv:
        _measure()
