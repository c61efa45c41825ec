"""The port's checkpoint manager (``repro_torch/checkpointing/manager.py``)
against the JAX package's: the reference's own tests on the same inputs,
and checkpoints that move between the packages bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.manager import CheckpointManager as JManager  # noqa
from repro.core.model import PeronaConfig as JConfig  # noqa: E402
from repro.core.model import PeronaModel as JModel  # noqa: E402
from repro_torch.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.core.model import PeronaConfig, PeronaModel  # noqa: E402
from repro_torch.core.params import flat_params  # noqa: E402
from repro_torch.core.params import params_from_numpy  # noqa: E402


def _state(x: float):
    """``tests/test_checkpoint.py::_state`` as tensors."""
    return {"params": {"w": torch.full((4, 4), x)},
            "opt": {"m": torch.full((4, 4), x / 2)}}


def _jstate(x: float):
    return {"params": {"w": jnp.full((4, 4), x)},
            "opt": {"m": jnp.full((4, 4), x / 2)}}


def _files(directory):
    return sorted(p.name for p in directory.iterdir())


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------- the reference's own tests

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(7, _state(3.0), extra={"hosts": ["a", "b"]})
    restored, meta = mgr.restore(_state(0.0))
    assert meta["step"] == 7
    assert meta["hosts"] == ["a", "b"]
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((4, 4), 3.0))
    assert restored["opt"]["m"].dtype == torch.float32


def test_files_equal_the_references(tmp_path):
    """The same saves through both managers write the same files: the
    same names, the same arrays under the same paths, the same
    ``meta_<n>.json`` and ``LATEST``."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    mgr, jmgr = (CheckpointManager(port, async_save=False),
                 JManager(ref, async_save=False))
    for s in (1, 2):
        mgr.save(s, _state(float(s)), extra={"hosts": ["a"], "s": s})
        jmgr.save(s, _jstate(float(s)), extra={"hosts": ["a"], "s": s})
    assert _files(port) == _files(ref)
    for name in _files(ref):
        if name.endswith(".npz"):
            got, want = _npz(port / name), _npz(ref / name)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert (port / name).read_text() == (ref / name).read_text()


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.latest_step() == 4
    assert sorted(mgr.all_steps()) == [3, 4]
    restored, meta = mgr.restore(_state(0.0), step=3)
    assert float(restored["params"]["w"][0, 0]) == 3.0


def test_no_tmp_files_left(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _state(1.0))
    assert not list(tmp_path.glob(".tmp*"))


def test_async_save_visible_after_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(5, _state(2.0))
    mgr.wait()
    assert mgr.latest_step() == 5


def test_restore_none_when_empty(tmp_path):
    mgr = CheckpointManager(tmp_path)
    restored, meta = mgr.restore(_state(0.0))
    assert restored is None and meta is None


def test_async_write_error_raises_on_next_save(tmp_path, monkeypatch):
    """A failed background write surfaces on the next save() (and only
    once), and the failed step never becomes the restore point."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, _state(1.0))
    mgr.wait()

    def boom(step, host, extra):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(2, _state(2.0))  # queues; the worker hits the error
    mgr._queue.join()
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, _state(3.0))
    assert mgr.latest_step() == 1  # step 2 never landed
    mgr.save(3, _state(3.0))  # error consumed: saves work again
    mgr.wait()
    assert mgr.latest_step() == 3


def test_async_write_error_raises_on_close(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_save=True)

    def boom(step, host, extra):
        raise OSError("torn write")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(1, _state(1.0))
    with pytest.raises(OSError, match="torn write"):
        mgr.close()
    mgr.close()  # idempotent once the error was consumed


@pytest.mark.parametrize("package", ["port", "jax"])
def test_pinned_steps_survive_gc(tmp_path, package):
    """keep-last GC spares pinned steps, in both packages alike."""
    mgr = (CheckpointManager if package == "port" else JManager)(
        tmp_path, keep_last=1, async_save=False)
    state = _state if package == "port" else _jstate
    mgr.save(1, state(1.0))
    mgr.pinned.add(1)
    for s in (2, 3, 4):
        mgr.save(s, state(float(s)))
    assert sorted(mgr.all_steps()) == [1, 4]
    restored, _ = mgr.restore(state(0.0), step=1)
    assert float(np.asarray(restored["params"]["w"])[0, 0]) == 1.0


@pytest.mark.parametrize("async_save", [False, True])
def test_bfloat16_leaves_round_trip_bit_for_bit(tmp_path, async_save):
    """numpy has no bfloat16: a bf16 leaf is stored as float32, which
    holds it exactly, and restores to the same bits as bf16; the
    reference restores the file at its own template's dtype."""
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(5, 7, generator=g).bfloat16(),
                        "b": torch.randn(7, generator=g)},
             "opt": {"m": (torch.randn(5, 7, generator=g) * 1e-30
                           ).bfloat16()}}
    mgr = CheckpointManager(tmp_path, async_save=async_save)
    mgr.save(1, state)
    mgr.close()
    assert _npz(tmp_path / "step_1.npz")["params/w"].dtype == np.float32
    got, _ = mgr.restore({"params": {"w": torch.zeros(5, 7,
                                                      dtype=torch.bfloat16),
                                     "b": torch.zeros(7)},
                          "opt": {"m": torch.zeros(5, 7,
                                                   dtype=torch.bfloat16)}})
    # bf16 -> float32 is exact and one to one: equal floats, equal bits
    for grp, leaves in state.items():
        for k, want in leaves.items():
            assert got[grp][k].dtype == want.dtype
            assert torch.equal(got[grp][k].float(), want.float()), (grp, k)
    jgot, _ = JManager(tmp_path).restore(
        {"params": {"w": jnp.zeros((5, 7), jnp.bfloat16),
                    "b": jnp.zeros(7)},
         "opt": {"m": jnp.zeros((5, 7), jnp.bfloat16)}})
    assert jgot["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jgot["params"]["w"], np.float32),
        state["params"]["w"].float().numpy())


# --------------------------------------------- the snapshot is a copy

def test_tensor_updated_in_place_after_save_persists_old_values(
        tmp_path, monkeypatch):
    """An async save holds its own host copy: the caller's tensor,
    updated in place after ``save`` returned and before the write ran
    (as the trainer writes its selected parameters into the model's live
    tensors), does not change what lands on disk."""
    import threading

    mgr = CheckpointManager(tmp_path, async_save=True)
    gate = threading.Event()
    real = mgr._write

    def held(*args):
        assert gate.wait(timeout=30)
        real(*args)

    monkeypatch.setattr(mgr, "_write", held)
    live = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    want = live["w"].clone()
    mgr.save(1, live)
    live["w"].mul_(-7.0).add_(1.0)  # in place, before the write
    gate.set()
    mgr.wait()
    got, _ = mgr.restore({"w": torch.zeros(2, 3)})
    assert torch.equal(got["w"], want)
    assert not torch.equal(got["w"], live["w"])
    mgr.close()


# -------------------------------------- Perona parameters, both ways

@pytest.fixture(scope="module")
def perona():
    """The JAX package's ``PRNGKey(0)`` parameters of a small Perona
    model, and the port's model of the same configuration."""
    cfg = JConfig(feature_dim=11, edge_dim=6, code_dim=8, hidden=16,
                  heads=2)
    jparams = JModel(cfg).init(jax.random.PRNGKey(0))
    import dataclasses

    model = PeronaModel(PeronaConfig(**dataclasses.asdict(cfg)))
    return jparams, model


def test_flat_state_dict_names_are_the_references_paths(perona):
    jparams, model = perona
    from repro.common.tree import tree_flatten_with_paths

    want = sorted(p for p, _ in tree_flatten_with_paths(jparams))

    def paths(tree):
        """The manager's names: ``flat_params`` names, slash-joined."""
        return sorted(k.replace(".", "/") for k in flat_params(tree))

    assert paths(model.state_dict()) == want
    # the reference's nested tree of tensors flattens to the same names
    nested = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    assert paths(nested) == want


def test_jax_checkpoint_restores_in_the_port(tmp_path, perona):
    jparams, model = perona
    JManager(tmp_path, async_save=False).save(3, jparams,
                                              extra={"source": "jax"})
    template = {k: torch.zeros_like(v)
                for k, v in model.state_dict().items()}
    got, meta = CheckpointManager(tmp_path).restore(template)
    assert meta == {"step": 3, "source": "jax"}
    want = flat_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_port_checkpoint_restores_in_jax(tmp_path, perona):
    jparams, model = perona
    g = torch.Generator().manual_seed(3)
    params = {k: torch.randn(v.shape, generator=g)
              for k, v in model.state_dict().items()}
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(5, params)
    mgr.close()  # drains the queued write
    template = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    got, meta = JManager(tmp_path).restore(template)
    assert meta["step"] == 5
    from repro.common.tree import tree_flatten_with_paths

    for path, leaf in tree_flatten_with_paths(got):
        want = params[path.replace("/", ".")]
        assert leaf.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(leaf), want.numpy(),
                                      err_msg=path)
