"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): atomic
save, keep_last_k, restore into a structure or from the manifest alone, int8
/ packed-int4 / bf16 leaves, and the on-disk format shared with the
reference's ``repro.checkpoint.CheckpointManager``: a checkpoint written by
either package restores bit-exactly in the other."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adamw, constant
from repro_torch.train import TrainState


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
                   "b": torch.from_numpy(rng.standard_normal(8).astype(np.float32)).bfloat16(),
                   "q": torch.from_numpy(rng.integers(-128, 128, (3, 5)).astype(np.int8)),
                   "q4": torch.from_numpy(rng.integers(0, 256, (2, 2, 6)).astype(np.uint8))},
        "opt": [torch.zeros((3,), dtype=torch.int32), torch.ones((2, 2))],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _flat(tree):
    """(path, tensor) pairs of a nested dict / list tree."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", t) for k in sorted(tree) for p, t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", t) for i, v in enumerate(tree) for p, t in _flat(v)]
    return [("", tree)]


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def test_roundtrip_bit_exact(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(7, t, blocking=True)
    _assert_same(m.restore(t), t)


def test_roundtrip_train_state(tmp_path):
    """A TrainState (NamedTuple) restores into its own structure."""
    params = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    opt = adamw(constant(0.1))
    state = TrainState(params, opt.init(params), torch.tensor(3, dtype=torch.int32))
    m = CheckpointManager(str(tmp_path))
    m.save(3, state, blocking=True)
    back = m.restore(state)
    assert isinstance(back, TrainState) and back.compress is None
    for a, b in zip(tree_leaves(dict(back._asdict()) | {"compress": {}}),
                    tree_leaves(dict(state._asdict()) | {"compress": {}})):
        assert torch.equal(a, b)


def test_keep_last_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_k=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(), blocking=True)
    assert m.steps() == [3, 4]


def test_atomic_no_tmp_left_behind(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree())
    m.wait()
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    man = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert man["step"] == 1
    assert man["leaves"]["params/w"] == {"file": "params__w.npy", "shape": [4, 8],
                                         "dtype": "float32"}
    assert man["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000001" / "params__b.npy").dtype == np.uint16


def test_restore_latest_and_specific(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t1, t2 = _tree(1), _tree(2)
    m.save(1, t1, blocking=True)
    m.save(2, t2, blocking=True)
    assert torch.equal(m.restore(t1)["params"]["w"], t2["params"]["w"])
    assert torch.equal(m.restore(t1, step=1)["params"]["w"], t1["params"]["w"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(t1)


def test_restore_without_structure(tmp_path):
    """``structure=None`` rebuilds the tree from the manifest (the list
    comes back as a list), every dtype kept, on the device asked for."""
    m = CheckpointManager(str(tmp_path))
    t = _tree(3)
    m.save(5, t, blocking=True)
    _assert_same(m.restore(None, device="cpu"), t)


def test_async_error_surfaces_on_wait(tmp_path):
    """A write that fails on the background thread raises on ``wait``."""
    m = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("a file where the directory goes")
    m.save(1, _tree())
    with pytest.raises(FileExistsError):
        m.wait()
    m.wait()  # raised once


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((4, 8)), jnp.float32),
                   "b": jnp.asarray(rng.standard_normal(8), jnp.bfloat16),
                   "q": jnp.asarray(rng.integers(-128, 128, (3, 5)), jnp.int8),
                   "q4": jnp.asarray(rng.integers(0, 256, (2, 2, 6)), jnp.uint8)},
        "opt": [jnp.zeros((3,), jnp.int32), jnp.ones((2, 2))],
        "step": jnp.asarray(7, jnp.int32),
    }


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_reference_checkpoint_restores_in_port(tmp_path):
    jt = _jax_tree(4)
    JaxCheckpointManager(str(tmp_path)).save(9, jt, blocking=True)
    back = CheckpointManager(str(tmp_path)).restore(None, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jt)[0]
    got = dict(_flat(back))
    assert len(got) == len(want)
    for path, leaf in want:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path) + "/"
        t = got[key]
        assert _as_numpy(t).dtype == np.asarray(leaf).dtype, key
        np.testing.assert_array_equal(_as_numpy(t), np.asarray(leaf))


def test_port_checkpoint_restores_in_reference(tmp_path):
    t = _tree(5)
    CheckpointManager(str(tmp_path)).save(11, t, blocking=True)
    jm = JaxCheckpointManager(str(tmp_path))
    for back in (jm.restore(_jax_tree(0)), jm.restore(None)):
        for (path, x), (_, y) in zip(_flat(t), _flat(back)):
            y = np.asarray(y)
            assert _as_numpy(x).dtype == y.dtype, path
            np.testing.assert_array_equal(_as_numpy(x), y)
