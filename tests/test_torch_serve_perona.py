"""The port's Perona serving modes (``launch/serve.py``: ``--fingerprint``,
``--fleet``, ``--daemon [--faults] [--modelplane]``, ``--modelplane-cmd``,
``--timeline``) on the CPU at 3 nodes x 2 rounds, each training its model
first; and the fleet service on the card, where there is one. No JAX
here: the modules under these modes are held to the JAX package in
``tests/test_torch_{fleet,ingest,obs,modelplane}.py``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

NODES, ROUNDS = 3, 2


def test_fleet_mode_serves_every_node_every_round(capsys):
    out = serve.main(["--fleet", "--nodes", str(NODES), "--rounds",
                      str(ROUNDS), "--device", "cpu", "--metrics"])
    s = out["stats"]
    assert s["requests_served"] == NODES * ROUNDS
    assert s["rows_scored"] == NODES * ROUNDS * 6  # 6 benchmark types
    assert (s["dispatches"], s["traces"], s["devices"]) == (ROUNDS, 1, 1)
    assert (s["scorer_retries"], s["quarantined_rows"]) == (0, 0)
    assert s["store_rows"] == NODES * 6 * 10 + s["rows_scored"]
    assert out["drift_nodes"] == NODES and out["worst_node"] is not None
    printed = capsys.readouterr().out
    assert f"[serve-fleet] {ROUNDS} rounds, {NODES * ROUNDS} requests" \
        in printed
    assert "[metrics final]" in printed and "dispatch.calls" in printed


def test_daemon_mode_with_faults(capsys):
    out = serve.main(["--daemon", "--faults", "--nodes", str(NODES),
                      "--rounds", "6", "--device", "cpu"])
    st, faults = out["stats"], out["faults"]
    assert out["degraded_node"] == f"fleet-{NODES - 1}"
    assert st["flush_failures"] == 0 and st["scorer_retries"] == 0
    assert st["service"]["quarantined_rows"] == faults["corrupted_rows"]
    assert st["duplicates_dropped"] == faults["duplicated"]
    assert st["staged_rows"] == 0
    assert set(out["flagged"]) <= {f"fleet-{i}" for i in range(NODES)}
    printed = capsys.readouterr().out.splitlines()
    assert [line.split("]")[0] for line in printed] == ["[serve-daemon"] * 3
    assert "injected faults" in printed[2]


def test_daemon_mode_without_faults():
    out = serve.serve_daemon(NODES, ROUNDS, device="cpu")
    st = out["stats"]
    assert out["faults"] is None and out["degraded_node"] is None
    assert st["events_seen"] == st["events_accepted"] == NODES * ROUNDS
    assert st["service"]["rows_scored"] == NODES * ROUNDS * 6


def test_fingerprint_mode_scores_every_round(capsys):
    out = serve.main(["--fingerprint", "--rounds", str(ROUNDS),
                      "--device", "cpu"])
    assert out["scored"] == ROUNDS * 3 * 6 * 2  # 3 nodes, 2 runs a type
    assert out["stats"]["requests_served"] == ROUNDS * 3
    assert out["traces"] == 1 and isinstance(out["excluded"], list)
    assert capsys.readouterr().out.startswith(
        f"[serve-fp] {ROUNDS} rounds, {out['scored']} executions")


@pytest.fixture(scope="module")
def modelplane_run(tmp_path_factory):
    """``--daemon --modelplane --faults`` at the reference's example size
    (3 nodes, 6 rounds), with ``--registry`` and ``--timeline``."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("modelplane")
    registry, timeline = d / "registry", d / "timeline.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(["--daemon", "--modelplane", "--faults", "--nodes",
                          "3", "--rounds", "6", "--registry", str(registry),
                          "--timeline", str(timeline), "--device", "cpu"])
    return out, buf.getvalue().splitlines(), registry, timeline


def test_modelplane_flag_runs_the_lifecycle(modelplane_run):
    """``--modelplane``: version 1 is the trained model, the identical
    candidate gets a canary verdict, and the NaN candidate forced in
    after two thirds of the stream is rolled back with its rows
    repaired; the reference's summary lines are printed."""
    out, printed, registry, _ = modelplane_run
    mp, versions = out["modelplane"], out["versions"]
    assert [e["source"] for e in versions[:3]] == \
        ["bootstrap", "cli-demo", "cli-demo-bad"]
    assert versions[1]["verdict"] is not None
    assert versions[1]["verdict"]["divergence_max"] == 0.0
    assert versions[2]["status"] == "rolled_back"
    assert mp["rollbacks"] == 1 and mp["repaired_rows"] > 0
    assert mp["promotions"] >= 1 and mp["shadow_flushes"] >= 1
    lines = [x for x in printed if x.startswith("[modelplane]")]
    assert lines[0].startswith(f"[modelplane] registry={registry} ")
    assert f"rollbacks={mp['rollbacks']} " in lines[0]
    assert lines[1:] == [f"[modelplane]   v{e['version']} {e['status']} "
                         f"({e['source']})" for e in versions]
    assert out["stats"]["flush_failures"] == 0


def test_registry_flag_keeps_the_registry(modelplane_run):
    """``--registry PATH``: the run's registry is on disk there, and a
    later process reads the same versions and parameters."""
    from repro_torch.fleet import ModelRegistry

    out, _, registry, _ = modelplane_run
    assert (registry / "registry.json").exists()
    reg = ModelRegistry(registry)
    assert reg.list_versions() == out["versions"]
    assert reg.incumbent == out["modelplane"]["incumbent"]
    bad = reg.load_version({"cls.w": torch.zeros(1)}, 3)
    assert torch.isnan(bad["cls.w"]).all()  # the NaN candidate, kept


def test_timeline_flag_exports_the_daemons_clock(modelplane_run):
    """``--timeline`` in daemon mode: the daemon's own virtual-clock
    recording, valid, with the plane's promote and rollback instants
    among its flush spans."""
    from repro_torch.obs import validate_chrome_trace_file

    out, printed, _, timeline = modelplane_run
    summary = validate_chrome_trace_file(str(timeline))
    assert printed[-1].startswith(f"[timeline] wrote {timeline}: "
                                  f"{summary['events']} events")
    events = json.loads(timeline.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names.index("modelplane.promote") < \
        names.index("modelplane.rollback")
    rb = events[names.index("modelplane.rollback")]
    assert rb["cat"] == "plane" and rb["args"]["reason"] == "nonfinite"
    assert names.count("ingest.flush") == (
        out["stats"]["deadline_flushes"] + out["stats"]["row_trigger_flushes"]
        + out["stats"]["forced_flushes"] + out["stats"]["drain_flushes"])


def _cmd_lines(cmd, reg):
    """What the reference prints for ``cmd`` on registry ``reg``
    (``repro/launch/serve.py:436-476``); promote is to version 1."""
    inc, prev = reg.incumbent, reg.previous
    return {
        "status": [f"[modelplane] incumbent=v{inc} previous=v{prev} "
                   f"versions={len(reg.list_versions())}"],
        # set_incumbent keeps the predecessor when nothing changes
        "promote": ["[modelplane] incumbent=v1 (previous="
                    f"v{inc if inc != 1 else prev})"],
        "rollback": [f"[modelplane] rolled back v{inc} -> incumbent "
                     f"v{prev}"],
    }[cmd]


@pytest.mark.parametrize("cmd", ["status", "list", "promote", "rollback"])
def test_modelplane_cmd_flag_works_offline(modelplane_run, cmd, capsys,
                                           tmp_path):
    """``--modelplane-cmd`` with ``--registry`` (and ``--version`` for
    promote) on the daemon's registry: the reference's lines, and the
    registry re-pointed as the reference does. No device is touched."""
    import shutil

    from repro_torch.fleet import ModelRegistry

    out, _, registry, _ = modelplane_run
    path = tmp_path / "registry"
    shutil.copytree(registry, path)
    before = ModelRegistry(path)
    inc, prev = before.incumbent, before.previous
    argv = ["--modelplane-cmd", cmd, "--registry", str(path)]
    if cmd == "promote":
        argv += ["--version", "1"]
    capsys.readouterr()
    versions = serve.main(argv)
    printed = capsys.readouterr().out.splitlines()
    if cmd == "list":
        assert [x.split()[:2] for x in printed] == [
            [f"v{e['version']}", e["status"]] for e in out["versions"]]
        assert printed[2] == "  v3   rolled_back  source=cli-demo-bad"
    else:
        assert printed == _cmd_lines(cmd, before)
    after = ModelRegistry(path)
    assert versions == after.list_versions()
    if cmd == "promote":
        assert after.incumbent == 1
    elif cmd == "rollback":
        assert after.incumbent == prev
        assert after.entry(inc)["status"] == "rolled_back"
    else:
        assert after.list_versions() == before.list_versions()


@pytest.mark.parametrize("argv,message", [
    (["--modelplane-cmd", "list"], "--modelplane-cmd requires --registry"),
    (["--modelplane-cmd", "promote", "--registry", "{reg}"],
     "promote requires --version N"),
])
def test_modelplane_cmd_refuses_what_the_reference_refuses(
        argv, message, tmp_path):
    argv = [a.format(reg=tmp_path / "r") for a in argv]
    with pytest.raises(SystemExit, match=message):
        serve.main(argv)


def test_version_flag_selects_the_promoted_version(modelplane_run,
                                                   tmp_path, capsys):
    """``--version N`` with promote makes N the incumbent and the old
    incumbent its predecessor; a daemon started on the registry would
    load N."""
    import shutil

    from repro_torch.fleet import ModelRegistry

    _, _, registry, _ = modelplane_run
    path = tmp_path / "registry"
    shutil.copytree(registry, path)
    old = ModelRegistry(path).incumbent
    target = 3 if old != 3 else 1
    serve.main(["--modelplane-cmd", "promote", "--registry", str(path),
                "--version", str(target)])
    assert capsys.readouterr().out == \
        f"[modelplane] incumbent=v{target} (previous=v{old})\n"
    reg = ModelRegistry(path)
    assert (reg.incumbent, reg.previous) == (target, old)
    assert reg.entry(target)["status"] == "incumbent"


def test_timeline_flag_in_fleet_mode_exports_the_process_tracer(tmp_path):
    from repro_torch import obs

    obs.tracer().clear()
    path = tmp_path / "fleet.json"
    out = serve.main(["--fleet", "--nodes", str(NODES), "--rounds", "1",
                      "--device", "cpu", "--timeline", str(path)])
    obs.validate_chrome_trace_file(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names.count("fleet.flush") == out["stats"]["flushes"] == 1
    assert "fleet.score_stack" in names


def test_timeline_flag_in_lm_mode_holds_the_serve_span(tmp_path):
    """The LM mode runs under an ``obs.span("slots.serve")`` as the
    reference's does, so ``--timeline`` exports it."""
    from repro_torch import obs

    obs.tracer().clear()
    path = tmp_path / "lm.json"
    serve.main(["--arch", "recurrentgemma-9b", "--scale", "small",
                "--device", "cpu", "--requests", "2", "--max-new", "2",
                "--timeline", str(path)])
    obs.validate_chrome_trace_file(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e["name"] == "slots.serve"]
    assert len(spans) == 1 and spans[0]["ph"] == "X"
    assert spans[0]["args"] == {"requests": 2, "slots": 4}


def test_perona_modes_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mode in ("--fleet", "--daemon", "--fingerprint"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([mode, "--nodes", "2", "--rounds", "1"])


@pytest.mark.gpu
def test_fleet_service_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.model import PeronaModel
    from repro_torch.core.params import load_golden
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet import FleetScoringService
    from repro_torch.kernels.edge_softmax import ops

    golden = load_golden()
    machines = {f"n{i}": "e2-medium" for i in range(8)}
    history = SuiteRunner(seed=1).run_frame(machines, 8)
    new = SuiteRunner(seed=2).run_frame(machines, 1, t_offset=86400.0)
    results = {}
    for device in ("cuda", "cpu"):
        svc = FleetScoringService(PeronaModel(golden.config), golden.params,
                                  golden.preproc, device=device)
        svc.seed_history(history)
        before = ops.LAUNCHES
        results[device] = svc.score_round(new)
        launches = ops.LAUNCHES - before
        assert launches == (1 if device == "cuda" else 0)
    for node, r in results["cpu"].items():
        np.testing.assert_allclose(results["cuda"][node].anomaly_prob,
                                   r.anomaly_prob, atol=1e-4)
