"""The paper's two entry points in the port: `repro_torch.launch.sim` and
`repro_torch.launch.service`, on the CPU by name.

`sim` prints the reference driver's plateau threshold for the same flags,
and with ``--baselines`` the reference's two baseline lines; `service`
completes fault-free and with ``--chaos`` and returns the reference's
committed-k trajectories; with no ``--device`` and no card, both raise as
`resolve_device` does.
"""
import contextlib
import io
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.launch import service as tservice
from repro_torch.launch import sim as tsim
from test_torch_reference import load_reference

SIM_ARGS = ["--jobs", "150"]
SERVICE_ARGS = ["--jobs", "600", "--window-jobs", "150"]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def printed(fn, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("extra", [[], ["--workload", "hetero0.90",
                                        "--init-prop", "0.3"]],
                         ids=["homog0.85", "hetero0.90"])
def test_sim_prints_the_reference_threshold(ref, extra):
    (grid, thr), lines = printed(tsim.main, SIM_ARGS + extra +
                                 ["--device", "cpu"])
    _, want = printed(ref.launch_sim.main, SIM_ARGS + extra)
    assert grid.avg_wait.shape == (37, 1) and grid.ok.all()
    assert lines[-1] == want[-1]
    assert lines[-1].startswith("[sim] queue-time plateau threshold: k >= ")
    assert f"k >= {thr.threshold} " in lines[-1]
    assert len(lines) == len(want) == 40


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
def test_service_completes_with_the_reference_trajectories(ref, chaos):
    flags = SERVICE_ARGS + (["--chaos"] if chaos else [])
    out, lines = printed(tservice.main, flags + ["--device", "cpu"])
    ref_out = {}
    real = ref.launch_service.run_service

    def capture(*a, **kw):
        ref_out["out"] = real(*a, **kw)
        return ref_out["out"]

    ref.launch_service.run_service = capture
    try:
        _, want = printed(ref.launch_service.main, flags)
    finally:
        ref.launch_service.run_service = real
    assert out["n_ticks"] == 4 and len(lines) == len(want)
    names = ["fault_aware", "hysteresis", "naive"] if chaos else [
        "hysteresis", "naive"]
    assert list(out["controllers"]) == names
    for name in names:
        got_c, want_c = (out["controllers"][name],
                         ref_out["out"]["controllers"][name])
        assert got_c["k_trajectory"] == want_c["k_trajectory"], name
        assert got_c["switches"] == want_c["switches"], name
    assert lines[0].startswith("[service] intensity_step: 4 ticks")
    assert all(np.isfinite(t["best_wait"]) for t in out["ticks"])


def test_service_float64(ref):
    out, _ = printed(tservice.main, SERVICE_ARGS + ["--float64", "--device",
                                                     "cpu"])
    assert out["config"]["dtype"] == "float64" and out["n_ticks"] == 4


def test_service_unknown_scenario_exits():
    with pytest.raises(SystemExit, match="unknown scenario"):
        tservice.main(SERVICE_ARGS + ["--scenario", "tsunami", "--device",
                                      "cpu"])


@pytest.mark.parametrize("extra", [[], ["--workload", "hetero0.95",
                                        "--init-prop", "0.2"]],
                         ids=["homog0.85", "hetero0.95"])
def test_sim_baselines_print_the_reference_values(ref, extra):
    flags = SIM_ARGS + extra + ["--baselines"]
    (grid, thr, bl), lines = printed(tsim.main, flags + ["--device", "cpu"])
    _, want = printed(ref.launch_sim.main, flags)
    assert len(lines) == len(want) == 42
    assert lines[-2:] == want[-2:]
    assert [ln.split(":")[0] for ln in lines[-2:]] == [
        "[sim] baseline backfill", "[sim] baseline fcfs"]
    assert list(bl) == ["backfill", "fcfs"]
    for m in bl.values():
        assert m.avg_wait.shape == (1,) and m.ok.all()
    assert lines[-3] == want[-3]            # the plateau line, unchanged


@pytest.mark.parametrize("main,args", [(tsim.main, SIM_ARGS),
                                       (tservice.main, SERVICE_ARGS)],
                         ids=["sim", "service"])
def test_default_device_is_the_card(monkeypatch, capsys, main, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert capsys.readouterr().out == ""
