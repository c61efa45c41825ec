"""The port's Perona serving modes (``launch/serve.py``: ``--fingerprint``,
``--fleet``, ``--daemon [--faults]``) on the CPU at 3 nodes x 2 rounds,
each training its model first; and the fleet service on the card, where
there is one. No JAX here: the modules under these modes are held to the
JAX package in ``tests/test_torch_{fleet,ingest,obs}.py``."""

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


@pytest.mark.parametrize("flag", ["--modelplane", "--modelplane-cmd=list",
                                  "--registry=x", "--version=1",
                                  "--timeline=x"])
def test_model_plane_flags_are_refused_until_ported(flag, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--daemon", flag, "--device", "cpu"])
    assert "queue 1 item 3" in capsys.readouterr().err


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
