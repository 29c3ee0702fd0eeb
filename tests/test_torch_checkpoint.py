"""Checkpoints, the elastic driver and the train launcher of the port.

- The reference's checkpoint cases (``tests/test_checkpoint.py``) on the
  port's ``save_tree`` / ``restore_tree`` / ``CheckpointManager``.
- Interchange: a train state saved by the reference restores into the
  port, one saved by the port restores into the reference, and both
  write equal manifests (keys, shapes, dtype tags, CRCs) for the same
  state.  Groups are stacked on a leading axis, as the reference's
  scanned tree holds them.  Restores are exact.
- ``ElasticTrainer`` with an injected failure, on the CPU: one restart,
  and after the replay the losses of a run without the failure, exactly
  (the same float32 operations on the same values).
- ``repro_torch.launch.train``: direct ``--smoke --device cpu`` with a
  checkpoint and a resume, and ``--gym --device cpu``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as jrestore, save_tree as jsave
from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.configs.base import ShapeCfg as JShape
from repro.train import make_step_bundle as jbundle
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.pipeline import make_source
from repro_torch.launch import train
from repro_torch.models.params import from_jax_state, to_jax_state
from repro_torch.runtime import ElasticTrainer
from repro_torch.train import load_state, make_step_bundle


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: torch's intra-op threads only contend with
    the other test workers' (a step's small ops ran ~90x slower with a
    full thread pool in each of six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones((4,), dtype=torch.bfloat16)},
        "opt": {"m": torch.zeros((3, 4)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    t = tree()
    save_tree(t, str(tmp_path / "step_1"))
    back = restore_tree(str(tmp_path / "step_1"), t)
    assert back["params"]["b"].dtype == torch.bfloat16
    torch.testing.assert_close(back["params"]["b"], t["params"]["b"])
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  t["params"]["w"].numpy())
    assert int(back["opt"]["step"]) == 7
    assert back["opt"]["step"].dtype == torch.int32


def test_crc_detects_corruption(tmp_path):
    t = tree()
    save_tree(t, str(tmp_path / "step_1"))
    path = tmp_path / "step_1" / "arrays.npz"
    data = dict(np.load(path))
    key = next(k for k in data if k.endswith("w"))
    data[key] = data[key] + 1
    np.savez(path, **data)
    with pytest.raises(IOError, match="CRC"):
        restore_tree(str(tmp_path / "step_1"), t)


def test_manager_async_save_restore_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for step in (10, 20, 30):
        t["opt"]["step"] = torch.tensor(step, dtype=torch.int32)
        mgr.save(step, t)
    mgr.wait()
    assert mgr.steps() == [20, 30]          # keep=2 gc'd step 10
    step, back = mgr.restore(t)
    assert step == 30 and int(back["opt"]["step"]) == 30
    step, back = mgr.restore(t, step=20)
    assert step == 20 and int(back["opt"]["step"]) == 20


def test_atomic_save_never_leaves_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = tree()
    mgr.save(5, t)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    mgr.save(5, t)                          # overwrite: still atomic
    step, _ = mgr.restore(t)
    assert step == 5
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(t)


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

INTERCHANGE = {
    "qwen2-7b": {},
    # bf16 parameters and moments beside the mLSTM/sLSTM float32 leaves
    "xlstm-125m": {"param_dtype": "bfloat16", "opt_dtype": "bfloat16"},
}


def states(arch):
    """(port cfg, the reference's train state as numpy, the same state in
    the port)."""
    over = INTERCHANGE[arch]
    jcfg = dataclasses.replace(jreduce(jget(arch)), **over)
    jstate = jbundle(jcfg, JShape("t", 16, 2, "train")).init_fn(
        jax.random.key(3))
    jstate = jax.tree.map(np.asarray, jstate)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)
    bundle = make_step_bundle(cfg, ShapeCfg("t", 16, 2, "train"))
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    load_state(state, from_jax_state(cfg, jstate))
    return cfg, jstate, state


def assert_state_equal(cfg, got, want_np):
    want = from_jax_state(cfg, want_np)
    for key, t in got["params"].state_dict().items():
        assert t.dtype == want["params"][key].dtype, key
        torch.testing.assert_close(t, want["params"][key], atol=0, rtol=0)
    for part in ("m", "v"):
        for key, t in got["opt"][part].items():
            torch.testing.assert_close(t, want["opt"][part][key], atol=0,
                                       rtol=0)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])


@pytest.mark.parametrize("arch", list(INTERCHANGE))
def test_reference_checkpoint_restores_into_port(tmp_path, arch):
    cfg, jstate, _ = states(arch)
    jstate["opt"]["step"] = np.int32(11)
    jsave(jstate, str(tmp_path / "step_11"))
    bundle = make_step_bundle(cfg, ShapeCfg("t", 16, 2, "train"))
    state = bundle.init_fn(torch.Generator().manual_seed(1))
    back = restore_tree(str(tmp_path / "step_11"),
                        to_jax_state(cfg, state, device="meta"))
    load_state(state, from_jax_state(cfg, back))
    assert_state_equal(cfg, state, jstate)


@pytest.mark.parametrize("arch", list(INTERCHANGE))
def test_port_checkpoint_restores_into_reference(tmp_path, arch):
    cfg, jstate, state = states(arch)
    state["opt"]["step"].fill_(5)
    save_tree(to_jax_state(cfg, state), str(tmp_path / "step_5"))
    template = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, jstate))
    back = jax.tree.map(np.asarray, jrestore(str(tmp_path / "step_5"),
                                             template))
    assert int(back["opt"]["step"]) == 5
    back["opt"]["step"] = jstate["opt"]["step"]
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(
            a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8),
            err_msg=str(path))


@pytest.mark.parametrize("arch", list(INTERCHANGE))
def test_manifests_are_equal(tmp_path, arch):
    cfg, jstate, state = states(arch)
    jsave(jstate, str(tmp_path / "ref"))
    save_tree(to_jax_state(cfg, state), str(tmp_path / "port"))
    ref, port = (json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("ref", "port"))
    assert ref == port
    assert "params/groups/l0/mixer/wq" in port["leaves"] or \
        "params/groups/l0/mixer/up_proj" in port["leaves"]
    n_groups = cfg.n_groups
    assert all(meta["shape"][0] == n_groups
               for key, meta in port["leaves"].items()
               if key.split("/")[1] == "groups")
    with np.load(tmp_path / "ref" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "arrays.npz") as b:
        assert list(a.keys()) == list(b.keys())


# ---------------------------------------------------------------------------
# the elastic driver
# ---------------------------------------------------------------------------


def driver_setup():
    cfg = reduce_for_smoke(get_config("qwen2-7b"), n_groups=1)
    bundle = make_step_bundle(cfg, ShapeCfg("t", 32, 2, "train"))
    src = make_source(cfg, 32)

    def batches(step):
        return {k: torch.from_numpy(v) for k, v in
                src.batch(step, 0, 2).items()}

    return bundle, batches


def test_driver_failure_restart(tmp_path):
    """An injected failure restores the checkpoint at step 10 and replays
    steps 10 and 11; the losses are those of a run without the failure."""
    bundle, batches = driver_setup()
    trainer = ElasticTrainer(bundle, batches, ckpt_dir=str(tmp_path),
                             ckpt_every=5, log_fn=lambda s: None)
    trainer.inject_failure(at_step=12)
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    state = trainer.run(state, steps=20)
    r = trainer.report
    assert r.restarts == 1
    assert r.steps_run == 22          # steps 10 and 11 ran twice
    assert np.isfinite(r.losses).all()
    assert ("failure", 12) == tuple(r.events[0][:2])

    clean = ElasticTrainer(bundle, batches, log_fn=lambda s: None)
    clean_state = clean.run(bundle.init_fn(
        torch.Generator().manual_seed(0)), steps=20)
    want = clean.report.losses
    assert r.losses[:12] == want[:12]
    assert r.losses[12:14] == want[10:12]
    assert r.losses[14:] == want[12:]
    for a, b in zip(state["params"].parameters(),
                    clean_state["params"].parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_driver_without_checkpoint_reraises():
    bundle, batches = driver_setup()
    trainer = ElasticTrainer(bundle, batches, log_fn=lambda s: None)
    trainer.inject_failure(at_step=1)
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        trainer.run(bundle.init_fn(torch.Generator().manual_seed(0)),
                    steps=3)


def test_rescale_without_mesh_counts_and_mesh_raises():
    bundle, batches = driver_setup()
    trainer = ElasticTrainer(bundle, batches, log_fn=lambda s: None)
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    assert trainer.rescale(bundle, state) is state
    assert trainer.report.rescales == 1
    with pytest.raises(NotImplementedError, match="A11"):
        trainer.rescale(dataclasses.replace(bundle, mesh=object()), state)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_cli_checkpoint_and_resume(tmp_path, capsys):
    argv = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    train.main(argv + ["--steps", "6", "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] done: 6 steps" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000006"]
    train.main(argv + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 6" in out
    assert "[train] done: 2 steps" in out


def test_gym_train_cli(capsys):
    train.main(["--arch", "qwen2-7b", "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "24", "--gym"])
    out = capsys.readouterr().out
    assert "[gym-train] 3 metric messages" in out


def test_train_cli_defaults_to_cuda():
    args = train.parse_args(["--smoke"])
    assert args.device == "cuda" and args.arch == "xlstm-125m"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.run(args)
