"""The port's checkpointing (`repro_torch.ckpt`) and the training entry
point's checkpoint flags, against the reference's `repro.ckpt` and
`repro.launch.train`.

  * the checkpoint cases of tests/test_ckpt_cluster.py:23-74 (which fail at
    collection under jax 0.9, ROADMAP.md R1), ported: round trip with
    metadata, a shape mismatch refused, the async manager's rotation, and
    restore onto a given device (the reference's elastic re-shard, the
    identity on one card);
  * the file format both ways: a tree of float32, bfloat16 and int32 leaves
    (dicts and a list) written by the reference's `save_checkpoint`
    restores bitwise in the port, and one written by the port restores
    bitwise in the reference (bfloat16 as its 2-byte patterns, numpy
    dtype ``V2``, on both sides);
  * the manager's snapshot is a copy: a state saved and then stepped in
    place by the port's optimizer restores to its values before the step;
  * ``launch/train.py --ckpt-dir --ckpt-every 2`` for 4 steps, then
    ``--resume`` to 6 steps, on reduced recurrentgemma-2b and granite-3-2b:
    every loss equals the reference's same two runs (carried parameters,
    the reference's own `main`) within rtol 2e-5, the train gate of
    tests/test_torch_train.py; the resumed run starts at step 4 with the
    batch stream restarted, as the reference's does, and the rotation keeps
    3 files.
"""
import os
import threading
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch import ckpt as tckpt
from repro_torch.ckpt import checkpoint as tcheckpoint
from repro_torch.configs import smoke_config
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_reference import load_reference

LOSS_RTOL = 2e-5


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.arange(3.0)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


# ----------------------------- tests/test_ckpt_cluster.py:23-74, ported


def test_save_restore_roundtrip(tmp_path):
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, 3, _state(1.5), {"note": "x"})
    template = {"params": {"w": torch.zeros(4, 4), "b": torch.zeros(3)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    st, meta = tckpt.restore_checkpoint(p, template)
    assert meta["step"] == 3 and meta["note"] == "x"
    assert torch.equal(st["params"]["w"], torch.full((4, 4), 1.5))
    assert int(st["opt"]["step"]) == 7
    assert os.listdir(p) == ["ckpt_00000003.npz"]      # no temp file left


def test_restore_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, 0, _state())
    bad = {"params": {"w": torch.zeros(2, 2), "b": torch.zeros(3)},
           "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="params/w"):
        tckpt.restore_checkpoint(p, bad)


def test_manager_rotation_and_async(tmp_path):
    p = str(tmp_path / "ck")
    mgr = tckpt.CheckpointManager(p, keep=2)
    for s in range(5):
        mgr.save(s, _state(float(s)))
    mgr.wait()
    assert tckpt.latest_step(p) == 4
    assert len([f for f in os.listdir(p) if f.endswith(".npz")]) == 2
    st, meta = mgr.restore_latest(_state())
    assert meta["step"] == 4
    assert torch.equal(st["params"]["w"], torch.full((4, 4), 4.0))


def test_restore_onto_a_device(tmp_path):
    """The reference's elastic re-shard puts every leaf with a new
    sharding; on one card it is a device: every tensor leaf goes there,
    in the template's dtype and with its requires_grad."""
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, 1, _state(2.0))
    template = _state()
    template["params"]["w"].requires_grad_(True)
    st, _ = tckpt.restore_checkpoint(p, template, device="cpu")
    assert st["params"]["w"].device == torch.device("cpu")
    assert st["params"]["w"].requires_grad
    assert not st["params"]["b"].requires_grad
    assert st["opt"]["step"].dtype == torch.int32


def test_restore_refusals(tmp_path):
    p = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(p, _state())
    assert tckpt.latest_step(p) is None
    tckpt.save_checkpoint(p, 2, {"params": {"w": torch.zeros(4, 4)}})
    with pytest.raises(KeyError, match="opt/step"):
        tckpt.restore_checkpoint(p, _state())


def test_wait_raises_the_writer_error(tmp_path, monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(tcheckpoint, "_write", broken)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised once, then cleared


# ------------------------------------------------ the format, both ways

def mixed_tree(rng):
    """numpy leaves (float32, bfloat16 bits, int32) of one tree shape."""
    f = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((2, 7)).astype(np.float32)
    bf_bits = (bf.view(np.uint32) >> 16).astype(np.uint16)   # truncated
    return {"params": {"w": f, "layers": [bf_bits, f[0]]},
            "opt": {"step": np.int32(11)}}


def reference_tree(ref, leaves):
    jnp = ref.jnp
    bf16 = jnp.asarray(leaves["params"]["layers"][0].astype(np.uint32) << 16
                       ).view(jnp.float32).astype(jnp.bfloat16)
    return {"params": {"w": jnp.asarray(leaves["params"]["w"]),
                       "layers": [bf16,
                                  jnp.asarray(leaves["params"]["layers"][1])]},
            "opt": {"step": jnp.asarray(leaves["opt"]["step"])}}


def port_tree(leaves):
    bits = torch.from_numpy(leaves["params"]["layers"][0].view(np.int16))
    return {"params": {"w": torch.from_numpy(leaves["params"]["w"]),
                       "layers": [bits.view(torch.bfloat16),
                                  torch.from_numpy(
                                      leaves["params"]["layers"][1])]},
            "opt": {"step": torch.tensor(int(leaves["opt"]["step"]),
                                         dtype=torch.int32)}}


def port_bits(tree):
    bf = tree["params"]["layers"][0]
    assert bf.dtype == torch.bfloat16
    return {"w": tree["params"]["w"].numpy().view(np.uint32),
            "bf": bf.view(torch.int16).numpy().view(np.uint16),
            "f": tree["params"]["layers"][1].numpy().view(np.uint32),
            "step": int(tree["opt"]["step"])}


def test_reference_files_restore_bitwise_in_the_port(ref, tmp_path):
    leaves = mixed_tree(np.random.default_rng(0))
    p = str(tmp_path / "ck")
    ref.ckpt.save_checkpoint(p, 5, reference_tree(ref, leaves),
                             {"arch": "x"})
    template = port_tree(mixed_tree(np.random.default_rng(1)))
    st, meta = tckpt.restore_checkpoint(p, template)
    assert meta == {"step": 5, "arch": "x"}
    got, want = port_bits(st), port_bits(port_tree(leaves))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_files_restore_bitwise_in_the_reference(ref, tmp_path):
    leaves = mixed_tree(np.random.default_rng(2))
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, 9, port_tree(leaves), {"arch": "y"})
    st, meta = ref.ckpt.restore_checkpoint(
        p, reference_tree(ref, mixed_tree(np.random.default_rng(3))))
    assert meta == {"step": 9, "arch": "y"}
    assert ref.ckpt.latest_step(p) == 9
    bf = np.asarray(st["params"]["layers"][0])
    assert bf.dtype == np.dtype("V2")       # the reference's own bf16 files
    np.testing.assert_array_equal(bf.view(np.uint16),
                                  leaves["params"]["layers"][0])
    np.testing.assert_array_equal(
        np.asarray(st["params"]["w"]).view(np.uint32),
        leaves["params"]["w"].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(st["params"]["layers"][1]),
                                  leaves["params"]["layers"][1])
    assert int(st["opt"]["step"]) == 11
    assert np.asarray(st["opt"]["step"]).dtype == np.int32


def test_train_state_keys_follow_the_tree(tmp_path):
    """A training state's keys are its tree paths: NamedTuple fields by
    name, list items by number; the host step restores as an int."""
    tc = smoke_config("granite-3-2b")
    state = tstep.init_state(tc, single_device_policy(tc),
                             torch.Generator().manual_seed(0))
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, 3, state)
    with np.load(os.path.join(p, "ckpt_00000003.npz")) as z:
        files = set(z.files)
    assert {"params/embed", "params/layers/0/attn/wq", "opt/step",
            "opt/m/0", "opt/v/0", "__meta__"} <= files
    st, _ = tckpt.restore_checkpoint(p, state)
    assert isinstance(st, tstep.TrainState) and st.opt.step == 0
    assert type(st.opt.step) is int


# ----------------------------------------------- the snapshot is a copy


def test_async_save_holds_the_state_before_the_step(tmp_path, monkeypatch):
    """Save, step (the port's optimizer updates in place), wait, restore:
    the file holds the state from before the step. The writer is held
    until the step has run, so a snapshot that shared memory with the
    state would be caught every time."""
    tc = smoke_config("granite-3-2b")
    pol = single_device_policy(tc)
    ocfg = toptim.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    state = tstep.init_state(tc, pol, torch.Generator().manual_seed(0),
                             ocfg)
    step = tstep.make_train_step(tc, pol, ocfg)
    tokens = torch.randint(0, tc.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    state, _ = step(state, batch)
    before = [x.detach().clone() for x in toptim.tree_leaves(
        [state.params, state.opt.m, state.opt.v])]

    stepped = threading.Event()
    write = tcheckpoint._write

    def held(*args):
        assert stepped.wait(60)
        return write(*args)

    monkeypatch.setattr(tcheckpoint, "_write", held)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    state, _ = step(state, batch)       # in place
    stepped.set()
    mgr.wait()
    restored, meta = mgr.restore_latest(state)
    assert meta["step"] == 1 and restored.opt.step == 1
    after = toptim.tree_leaves([state.params, state.opt.m, state.opt.v])
    got = toptim.tree_leaves([restored.params, restored.opt.m,
                              restored.opt.v])
    assert len(got) == len(before)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    for g, b in zip(got, before):
        assert torch.equal(g, b)


# ------------------------------------ train --ckpt-dir / --resume, parity

ARGV = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
        "--log-every", "1", "--seed", "3"]


def reference_runs(ref, arch, ckpt_dir):
    """The reference's `main` for 4 steps, then resumed to 6: its losses,
    and its parameters at the start (numpy), recorded through its jit."""
    losses, real_jit = [], ref.jax.jit

    def recording_jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)

        def run(state, batch):
            state, mets = compiled(state, batch)
            losses.append(float(mets["loss"]))
            return state, mets
        return run

    mod = ref.launch_train
    real_jax = mod.jax
    mod.jax = types.SimpleNamespace(jit=recording_jit, random=real_jax.random)
    try:
        argv = ["--arch", arch, "--ckpt-dir", ckpt_dir] + ARGV
        mod.main(argv + ["--steps", "4"])
        mod.main(argv + ["--steps", "6", "--resume"])
    finally:
        mod.jax = real_jax
    jc = ref.configs.smoke_config(arch)
    pol = ref.policy.single_device_policy(jc)
    state, _ = ref.train_step.init_state(jc, pol, ref.jax.random.PRNGKey(3))
    return losses, ref.jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-3-2b"])
def test_train_resume_matches_the_reference(ref, arch, tmp_path,
                                            monkeypatch, capsys):
    want, jparams = reference_runs(ref, arch, str(tmp_path / "ref"))
    assert len(want) == 6

    def carried_state(cfg, pol, gen, ocfg):
        return tstep.state_for(params_from_jax(cfg, jparams, device="cpu"),
                               ocfg)

    monkeypatch.setattr(tlaunch, "init_state", carried_state)
    ck = str(tmp_path / "port")
    argv = ["--arch", arch, "--device", "cpu", "--ckpt-dir", ck] + ARGV
    first, second = {}, {}
    tlaunch.main(argv + ["--steps", "4"], stats=first)
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.npz",
                                      "ckpt_00000004.npz"]
    tlaunch.main(argv + ["--steps", "6", "--resume"], stats=second)
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert first["start"] == 0 and second["start"] == 4
    got = first["losses"] + second["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    # keep = 3: the files of steps 2, 4 and 6
    assert sorted(os.listdir(ck)) == [f"ckpt_{s:08d}.npz" for s in (2, 4, 6)]
    assert sorted(os.listdir(ck)) == sorted(os.listdir(tmp_path / "ref"))
    # the resumed run restarted the batch stream: its first step takes the
    # first batch, so its loss is the loss of batch 0 under later weights
    assert second["losses"][0] != first["losses"][0]


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path):
    stats = {}
    tlaunch.main(["--arch", "granite-3-2b", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path / "none"), "--resume", "--steps", "1"] + ARGV,
                 stats=stats)
    assert stats["start"] == 0 and len(stats["losses"]) == 1
    assert os.listdir(tmp_path / "none") == ["ckpt_00000001.npz"]
