"""The multi-process bootstrap and the device mesh, on the CPU.

`run_ranks` runs a script in N processes that join one gloo group through
`multihost.initialize`'s explicit mode (REPRO_COORDINATOR on a freshly
bound local port, REPRO_NUM_PROCESSES, REPRO_PROCESS_ID), each under its
own time limit, and returns what each printed last (a JSON line). The
other multi-rank test files use it. Without a group, every helper gives
the one-rank answer of the reference's single process.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import mesh as tmesh
from repro_torch.launch import multihost

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_SECONDS = 150          # each group's limit; a hung rank is killed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, n: int, workdir, timeout=RANK_SECONDS) -> list:
    """`script` in `n` gloo ranks; returns each rank's last stdout line,
    parsed as JSON. Fails the test if a rank fails or outlives
    `timeout`."""
    env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{free_port()}",
               REPRO_NUM_PROCESSES=str(n), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(workdir)], cwd=str(workdir),
        env=dict(env, REPRO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


_BOOTSTRAP = r"""
import json
import torch
from repro_torch.launch import mesh, multihost
from repro_torch.core import lane_padding, lane_sharding, sweep_plan

facts = multihost.initialize(timeout_s=60, device="cpu")
again = multihost.initialize(device="cpu")
m = mesh.make_mesh(mesh.FOUR_CARD, "cpu")
multihost.assert_mesh_spans_processes(m)
errors = {}
for name, fn in (
        ("mesh_of_two", lambda: mesh.make_mesh({"data": 2, "model": 1},
                                               "cpu")),
        ("cuda_mesh_on_gloo", lambda: mesh.make_mesh(mesh.FOUR_CARD)),
        ("span", lambda: multihost.assert_mesh_spans_processes(
            type("Fake", (), {"devices": type("D", (), {"size": 7})})()))):
    try:
        fn()
        errors[name] = None
    except RuntimeError as e:
        errors[name] = str(e)
plan = sweep_plan("auto", 222, device="cpu")
print(json.dumps({
    "facts": facts, "again": again,
    "shard": list(multihost.host_data_shard()),
    "axes": mesh.mesh_axis_sizes(m), "errors": errors,
    "pad": lane_padding(222), "plan": [plan["n_devices"], plan["lane_pad"]],
    "block": [lane_sharding(8, pad=True).lanes.start,
              lane_sharding(8, pad=True).lanes.stop]}))
multihost.shutdown()
"""


def test_four_gloo_ranks_bootstrap(tmp_path):
    """`initialize`'s REPRO_* mode over four processes: the reference's
    four keys, `host_data_shard`, a 2 x 2 mesh that spans the world, and
    the refusals (a mesh of another size, a card mesh on gloo ranks, a
    mesh that does not span the processes)."""
    outs = run_ranks(_BOOTSTRAP, 4, tmp_path)
    for r, out in enumerate(outs):
        want = {"process_id": r, "n_processes": 4, "local_devices": 1,
                "global_devices": 4}
        assert out["facts"] == want and out["again"] == want
        assert out["shard"] == [r, 4]
        assert out["axes"] == {"data": 2, "model": 2}
        assert "has 2 devices but the process group has 4" in \
            out["errors"]["mesh_of_two"]
        assert "needs NCCL" in out["errors"]["cuda_mesh_on_gloo"]
        assert "slice booking and mesh shape disagree" in \
            out["errors"]["span"]
        assert out["pad"] == 2 and out["plan"] == [4, 2]
        assert out["block"] == [2 * r, 2 * r + 2]


def test_one_process_without_a_group():
    assert not multihost.is_initialized()
    assert multihost.device_count() == 1
    assert multihost.process_index() == 0
    assert multihost.host_data_shard() == (0, 1)

    class Fake:
        class devices:
            size = 7

    with pytest.raises(RuntimeError, match="disagree"):
        multihost.assert_mesh_spans_processes(Fake())
    with pytest.raises(RuntimeError, match="needs a process group"):
        tmesh.make_mesh(tmesh.HOST, "cpu")


def test_initialize_needs_an_address(monkeypatch):
    for k in ("REPRO_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group to join"):
        multihost.initialize(device="cpu")
    assert not multihost.is_initialized()


def test_initialize_on_the_card_needs_one(monkeypatch):
    """device=None is the card and NCCL: without a card it raises, and
    it never falls back to gloo."""
    monkeypatch.setenv("REPRO_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "1")
    monkeypatch.setenv("REPRO_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize()
    with pytest.raises(ValueError, match="device=None"):
        multihost.initialize(device="meta")
    assert not multihost.is_initialized()


@pytest.mark.parametrize("text,want", [
    ("data=2,model=2", {"data": 2, "model": 2}),
    ("data=1,model=1", {"data": 1, "model": 1}),
    ("pod=2,data=16,model=16", {"pod": 2, "data": 16, "model": 16})])
def test_parse_axes(text, want):
    assert tmesh.parse_axes(text) == want
    assert list(tmesh.parse_axes(text)) == list(want)


@pytest.mark.parametrize("text", ["data", "data=0", "=2", "data=x"])
def test_parse_axes_refuses(text):
    with pytest.raises(ValueError, match="name=size"):
        tmesh.parse_axes(text)


def test_four_card_mesh_keeps_the_production_axes():
    assert list(tmesh.FOUR_CARD) == list(tmesh.SINGLE_POD)
    assert tmesh.mesh_devices(tmesh.FOUR_CARD) == 4


def test_multihost_matches_the_reference_on_one_process(ref_multihost):
    """The reference's own one-process answers (tests/test_multihost.py)."""
    assert multihost.host_data_shard() == ref_multihost.host_data_shard()


@pytest.fixture()
def ref_multihost():
    from test_torch_reference import load_reference
    load_reference()
    from repro.launch import multihost as ref
    return ref
