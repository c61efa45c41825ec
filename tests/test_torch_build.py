"""The port's kernel build: what the content hash of a library covers,
and that nothing is compiled where there is no nvcc."""

import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_tensor_core_kernels_include_the_shared_header():
    for name in ("flash_attention", "mlstm"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text, name


def test_library_name_follows_its_source_and_the_headers(csrc):
    names = ("edge_softmax", "flash_attention", "rg_lru", "mlstm")
    before = {n: build._target(n) for n in names}
    assert before == {n: build._target(n) for n in names}  # deterministic
    assert len(set(before.values())) == len(names)
    with open(csrc / "mlstm.cu", "a") as f:
        f.write("\n// edited\n")
    after_source = {n: build._target(n) for n in names}
    assert after_source["mlstm"] != before["mlstm"]
    assert all(after_source[n] == before[n] for n in names if n != "mlstm")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after_header = {n: build._target(n) for n in names}
    assert all(after_header[n] != after_source[n] for n in names)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
