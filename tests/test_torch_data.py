"""The port's numpy data layer equals the reference bit for bit:
acquisition frames, preprocessing, graphs, splits and ranking."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph_data as jgraph  # noqa: E402
from repro.core import ranking as jranking  # noqa: E402
from repro.core.preprocess import Preprocessor as JPreprocessor  # noqa: E402
from repro.fingerprint import runner as jrunner  # noqa: E402
from repro_torch.common.bucketing import next_pow2  # noqa: E402
from repro_torch.common.rng import folded_generator  # noqa: E402
from repro_torch.core import graph_data as tgraph  # noqa: E402
from repro_torch.core import ranking as tranking  # noqa: E402
from repro_torch.core.preprocess import Preprocessor  # noqa: E402
from repro_torch.fingerprint import runner as trunner  # noqa: E402


def assert_same(a, b, path="value"):
    """Recursive bit-for-bit equality of dataclasses, dicts, sequences
    and arrays (dtype included)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, path


# name -> (machines, runs_per_type, stress, degraded, t_offset, rounds)
SCENARIOS = {
    "quickstart": ({"alpha": "e2-medium", "bravo": "n1-standard-4",
                    "charlie": "n2-standard-4", "delta": "c2-standard-4"},
                   40, 0.15, None, 0.0, 1),
    "degraded_rounds": ({f"node-{i:03d}": "e2-medium" for i in range(16)},
                        2, 0.0, ["node-001", "node-005"], 86400.0, 3),
    "aws": ({"m0": "m4.large", "c0": "c4.xlarge", "r0": "r4.2xlarge"},
            5, 0.3, ["c0"], 0.0, 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_frame_matches_reference(name):
    machines, runs, stress, degraded, t_offset, rounds = SCENARIOS[name]
    jr, tr = jrunner.SuiteRunner(seed=3), trunner.SuiteRunner(seed=3)
    for _ in range(rounds):  # repeated rounds draw fresh values
        assert_same(
            jr.run_frame(machines, runs, stress, degraded, t_offset),
            tr.run_frame(machines, runs, stress, degraded, t_offset))


def test_paper_acquisition_frame_matches_reference():
    assert_same(jrunner.paper_acquisition_frame(seed=0),
                trunner.paper_acquisition_frame(seed=0))


def test_records_round_trip_matches_reference(paper_records):
    ported = trunner.paper_acquisition(seed=0)
    assert len(ported) == len(paper_records) == 1800
    assert_same(paper_records[:50], ported[:50])


@pytest.fixture(scope="module")
def ported(paper_records):
    records = trunner.paper_acquisition(seed=0)
    train_r, val_r, test_r = tgraph.chronological_split(records)
    return {"pre": Preprocessor().fit(train_r), "train_records": train_r,
            "val_records": val_r, "test_records": test_r}


def test_chronological_split_matches_reference(fitted, ported):
    for key in ("train_records", "val_records", "test_records"):
        assert_same(fitted[key], ported[key], key)
    frame_j = jrunner.paper_acquisition_frame(seed=0)
    frame_t = trunner.paper_acquisition_frame(seed=0)
    for fj, ft in zip(jgraph.chronological_split(frame_j),
                      tgraph.chronological_split(frame_t)):
        assert_same(fj, ft)


def test_preprocessor_statistics_match_reference(fitted, ported):
    assert_same(dataclasses.asdict(fitted["pre"]),
                dataclasses.asdict(ported["pre"]))


@pytest.mark.parametrize("split", ["train_records", "test_records"])
def test_preprocessor_transforms_match_reference(fitted, ported, split):
    jp, tp = fitted["pre"], ported["pre"]
    jr, tr = fitted[split], ported[split]
    assert_same(jp.transform(jr), tp.transform(tr))
    assert_same(jp.transform_edges(jr), tp.transform_edges(tr))
    assert_same(jp.raw_features(jr), tp.raw_features(tr))
    assert_same(jp.raw_edges(jr), tp.raw_edges(tr))
    x = jp.transform(jr)
    assert_same(jp.groundtruth_norm(x), tp.groundtruth_norm(x))
    assert_same(jp.aspect_slices(), tp.aspect_slices())


def test_preprocessor_abs_mode_and_records_match_reference(paper_records):
    ported = trunner.paper_acquisition(seed=0)
    j = JPreprocessor(std_threshold=0.5, std_mode="abs").fit(paper_records)
    t = Preprocessor(std_threshold=0.5, std_mode="abs").fit(ported)
    assert_same(dataclasses.asdict(j), dataclasses.asdict(t))


@pytest.mark.parametrize("split", ["train_records", "test_records"])
def test_graphs_match_reference(fitted, ported, split):
    jr, tr = fitted[split], ported[split]
    assert_same(jgraph.build_graphs(jr, fitted["pre"]),
                tgraph.build_graphs(tr, ported["pre"]))
    frame_j = jrunner.paper_acquisition_frame(seed=0)
    frame_t = trunner.paper_acquisition_frame(seed=0)
    assert_same(jgraph.graph_structure(frame_j),
                tgraph.graph_structure(frame_t))
    idx = np.arange(0, len(frame_j), 3)
    assert_same(jgraph.build_graphs(frame_j, fitted["pre"]).subset(idx),
                tgraph.build_graphs(frame_t, ported["pre"]).subset(idx))


def test_ranking_matches_reference(ported):
    rng = np.random.default_rng(0)
    recs = ported["test_records"]
    codes = rng.standard_normal((len(recs), 32)).astype(np.float32)
    types = [r.benchmark_type for r in recs]
    machines = [r.machine for r in recs]
    js = jranking.aspect_scores(codes, types, machines)
    ts = tranking.aspect_scores(codes, types, machines)
    assert_same(js, ts)
    assert_same(jranking.code_scores(codes), tranking.code_scores(codes))
    for aspect in (None, "cpu", "disk", "network"):
        assert jranking.rank_machines(js, aspect) == \
            tranking.rank_machines(ts, aspect)
    assert_same(jranking.machine_score_matrix(js, sorted(js)),
                tranking.machine_score_matrix(ts, sorted(ts)))


def test_host_rng_and_bucketing_match_reference():
    from repro.common.bucketing import next_pow2 as jnext_pow2
    from repro.common.rng import folded_generator as jfolded

    for path in [(0,), (3, 1, "fio", "e2-medium", 1), ("net-slots", 7)]:
        assert_same(jfolded(*path).standard_normal(5),
                    folded_generator(*path).standard_normal(5))
    for n in (0, 1, 2, 3, 63, 64, 65, 1800, 196608 + 6144):
        for floor in (1, 64, 128):
            assert jnext_pow2(n, floor) == next_pow2(n, floor)
