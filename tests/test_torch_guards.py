"""Guards of the port: where it runs, what it refuses, what it imports.

The machine that runs these tests has no GPU, no `nvcc` and no `triton`;
the port must import there, run on the CPU only when asked to by name,
and never substitute one thing for another silently.
"""
import importlib
import pathlib
import pkgutil
import re

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.core import des as tdes
from repro_torch.core import precision as tprecision
from repro_torch.core import sweep as tsweep
from repro_torch.kernels import build as tbuild
from repro_torch.kernels.packet_select import ops as tselect
from repro_torch.kernels.rglru_scan import ops as tlru
from repro_torch.launch import train as tlaunch_train
from repro_torch.workload.lublin import WorkloadParams, generate_workload
from test_torch_reference import load_reference

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "serve_lm_torch.py",
    REPO / "examples" / "train_lm_torch.py"]
CUDA_SOURCES = [("packet_step.cu", "event_step_kernel",
                 "src/repro/kernels/packet_step/kernel.py"),
                ("flash_attention.cu", "_attn_kernel",
                 "src/repro/kernels/flash_attention/kernel.py"),
                ("rglru_scan.cu", "_lru_kernel",
                 "src/repro/kernels/rglru_scan/kernel.py"),
                ("packet_select.cu", "_select_kernel",
                 "src/repro/kernels/packet_select/kernel.py"),
                ("packet_while.cu", "_select_kernel",
                 "src/repro/kernels/packet_select/kernel.py"),
                ("baselines.cu", "simulate_backfill",
                 "src/repro/core/schedulers.py")]


@pytest.fixture()
def without_cuda(monkeypatch):
    """Make the absence of a card explicit, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def wl():
    return generate_workload(WorkloadParams(n_jobs=120, nodes=20, load=0.9,
                                            homogeneous=True, seed=2))


def submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_package_layout_mirrors_the_reference():
    mods = submodules()
    for name in ("core.des", "core.packet", "core.metrics", "core.sweep",
                 "core.precision", "workload.lublin",
                 "kernels.packet_step.ref", "kernels.packet_step.kernel",
                 "kernels.packet_step.ops", "device",
                 "kernels.flash_attention.ref", "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops", "models.config",
                 "models.layers", "models.lm", "models.registry",
                 "models.convert", "configs", "configs.granite_3_2b",
                 "configs.yi_6b", "configs.phi3_medium_14b",
                 "configs.starcoder2_7b", "sharding.policy", "serve.engine",
                 "launch.serve", "kernels.rglru_scan.ref",
                 "kernels.rglru_scan.kernel", "kernels.rglru_scan.ops",
                 "models.hybrid", "configs.recurrentgemma_2b", "train.data",
                 "train.loss", "train.optim", "train.step", "launch.train",
                 "kernels.packet_select.ref", "kernels.packet_select.kernel",
                 "kernels.packet_select.ops", "kernels.packet_while.ref",
                 "kernels.packet_while.kernel", "kernels.packet_while.ops",
                 "core.prng", "workload.windows", "service",
                 "service.monitor", "service.controller", "service.driver",
                 "launch.sim", "launch.service", "core.cohort",
                 "core.schedulers", "kernels.baselines.ref",
                 "kernels.baselines.kernel", "kernels.baselines.ops"):
        assert f"repro_torch.{name}" in mods
    for source, _, _ in CUDA_SOURCES:
        assert (REPO / "src/repro_torch/csrc" / source).is_file()


@pytest.mark.parametrize("name", submodules())
def test_every_submodule_imports_without_a_gpu_toolchain(name):
    """The kernel is built at first launch, never at import."""
    importlib.import_module(name)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_reference(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    bad = [ln for ln in path.read_text().splitlines() if pattern.match(ln)]
    assert not bad, bad


class TestDeviceResolution:
    def test_none_means_the_card_and_raises_without_one(self, without_cuda):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(None)

    def test_cuda_by_name_raises_without_one(self, without_cuda):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")

    def test_cpu_only_by_name(self):
        assert resolve_device("cpu") == torch.device("cpu")
        assert resolve_device(torch.device("cpu")).type == "cpu"

    def test_pack_workload_default_device_raises(self, wl, without_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdes.pack_workload(wl)

    def test_run_packet_grid_default_device_raises(self, wl, without_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsweep.run_packet_grid(wl, ks=[1.0], s_props=[0.1])

    def test_engine_default_device_raises(self, wl, without_cuda):
        pw = tdes.pack_workload(wl, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdes.simulate_packet_scan_lanes(pw, [1.0], [50.0], 20)

    def test_sweep_plan_default_device_raises(self, without_cuda):
        with pytest.raises(RuntimeError, match="is_available"):
            tsweep.sweep_plan("auto", 8)

    def test_train_launcher_default_device_raises(self, without_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch_train.main(["--arch", "recurrentgemma-2b", "--reduced",
                                "--steps", "1"])


class TestStepImpl:
    def test_cuda_step_on_cpu_tensors_raises(self, wl):
        pw = tdes.pack_workload(wl, device="cpu")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tdes.simulate_packet_scan_lanes(pw, [1.0], [50.0], 20,
                                            step_impl="cuda", device="cpu")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tsweep.run_packet_grid(wl, ks=[1.0], s_props=[0.1],
                                   step_impl="cuda", device="cpu")

    def test_unknown_step_impl_raises(self, wl):
        with pytest.raises(ValueError, match="unknown step_impl"):
            tsweep.run_packet_grid(wl, ks=[1.0], s_props=[0.1],
                                   step_impl="xla", device="cpu")

    def test_torch_is_the_cpu_default(self, wl):
        a = tsweep.run_packet_grid(wl, ks=[1.0, 9.0], s_props=[0.1],
                                   device="cpu")
        b = tsweep.run_packet_grid(wl, ks=[1.0, 9.0], s_props=[0.1],
                                   step_impl="torch", device="cpu")
        assert np.array_equal(a.avg_wait, b.avg_wait) and a.ok.all()


class TestKernelImpl:
    def test_packet_select_cuda_on_cpu_tensors_raises(self):
        rows, lane = torch.ones((2, 3)), torch.ones((2,))
        args = (rows, rows, rows, rows, rows, rows > 0, lane, lane,
                torch.ones((2,), dtype=torch.int32))
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tselect.fused_packet_select(*args, impl="cuda")
        before = tselect.fused_packet_select.launches
        j, m, dur, work = tselect.fused_packet_select(*args)
        assert j.dtype == torch.int32 and m.dtype == torch.float32
        assert tselect.fused_packet_select.launches == before

    @pytest.mark.parametrize("bad,match", [
        ({"nonempty": torch.ones((2, 3))}, "nonempty has dtype"),
        ({"m_free": torch.ones((2,))}, "m_free has dtype"),
        ({"k": torch.ones((3,))}, "k has shape"),
        ({"oldest": torch.ones((3, 2)).t()}, "oldest must be contiguous"),
        ({"s_j": torch.ones((2, 3), dtype=torch.float64)}, "s_j has dtype")])
    def test_packet_select_checks_its_operands(self, bad, match):
        rows, lane = torch.ones((2, 3)), torch.ones((2,))
        args = dict(sum_w=rows, s_j=rows, p_j=rows, oldest=rows, t_max=rows,
                    nonempty=rows > 0, now=lane, k=lane,
                    m_free=torch.ones((2,), dtype=torch.int32))
        args.update(bad)
        with pytest.raises(ValueError, match=match):
            tselect.fused_packet_select(**args)

    def test_rglru_cuda_on_cpu_tensors_raises(self):
        x = torch.zeros((1, 4, 8))
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tlru.lru_chunked(x, x, impl="cuda")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tlru.chunked_lru(x + 0.5, x, impl="cuda")


class TestUnportedPathsRaise:
    """What is not ported raises by name; the paths that once raised here
    (the `seq`, `vmap_k` and `vmap_s` layouts, a non-inert chaos axis, an
    engine under chaos without streams) now run, on the CPU, and give
    `fused`'s grid or the reference's streams."""
    GRID = dict(ks=[0.5, 1.0, 9.0], s_props=[0.1, 0.4], device="cpu")

    def assert_equals_fused(self, wl, grid):
        fused = tsweep.run_packet_grid(wl, mode="fused", **self.GRID)
        assert grid.avg_wait.shape == (3, 2) and grid.ok.all()
        assert np.array_equal(grid.n_groups, fused.n_groups)
        for f in ("avg_wait", "med_wait", "avg_qlen", "full_util",
                  "useful_util", "avg_run_wait"):
            np.testing.assert_allclose(getattr(grid, f), getattr(fused, f),
                                       rtol=1e-5, err_msg=f)

    @pytest.mark.parametrize("mode", ["seq", "vmap_k", "vmap_s"])
    def test_mode(self, wl, mode):
        grid = tsweep.run_packet_grid(wl, mode=mode, **self.GRID)
        self.assert_equals_fused(wl, grid)

    @pytest.mark.parametrize("flag", ["vmap_k", "vmap_s"])
    def test_legacy_flags(self, wl, flag):
        grid = tsweep.run_packet_grid(wl, **{flag: True}, **self.GRID)
        self.assert_equals_fused(wl, grid)

    def test_non_inert_chaos(self, wl):
        """A fault grid runs, and its seq and chunked layouts give the
        fused one bitwise."""
        chaos = tdes.ChaosConfig(mtbf_chip_hours=np.array([5.0, 50.0]),
                                 straggler_prob=0.2, seed=3)
        kw = dict(ks=[1.0, 9.0], s_props=[0.1], chaos=chaos, device="cpu")
        fused = tsweep.run_packet_grid(wl, mode="fused", **kw)
        assert fused.avg_wait.shape == (2, 1, 2) and fused.ok.all()
        assert fused.failures.sum() > 0
        for mode in ("seq", "chunked"):
            grid = tsweep.run_packet_grid(wl, mode=mode, chunk_lanes=3, **kw)
            assert all(np.array_equal(a, b) for a, b in zip(grid, fused))

    def test_inert_chaos_is_the_fault_free_program(self, wl):
        a = tsweep.run_packet_grid(wl, ks=[2.0], s_props=[0.1], device="cpu",
                                   chaos=tdes.ChaosConfig())
        b = tsweep.run_packet_grid(wl, ks=[2.0], s_props=[0.1], device="cpu")
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

    def test_unknown_mode_is_a_value_error(self, wl):
        with pytest.raises(ValueError, match="unknown sweep mode"):
            tsweep.run_packet_grid(wl, ks=[1.0], s_props=[0.1], mode="warp",
                                   device="cpu")

    def test_engine_chaos_needs_its_streams(self, wl):
        """Without streams the engine draws the reference's own (here
        given back to it as operands: the same result); streams without a
        ChaosConfig, or one stream without the other, still raise."""
        ref = load_reference()
        pw = tdes.pack_workload(wl, device="cpu")
        chaos = tdes.ChaosConfig(mtbf_chip_hours=5.0, seed=4, lane=9)
        u = np.asarray(ref.des.chaos_uniforms(
            ref.des.ChaosConfig(seed=4, lane=9), np.float32, 240))
        own = tdes.simulate_packet_scan_lanes(pw, [1.0], [50.0], 20,
                                              device="cpu", chaos=chaos)
        given = tdes.simulate_packet_scan_lanes(
            pw, [1.0], [50.0], 20, device="cpu", chaos=chaos,
            u1=u[:, :1].copy(), u2=u[:, 1:].copy())
        assert int(own.failures[0]) > 0
        assert all(torch.equal(a, b) for a, b in zip(own, given))
        with pytest.raises(ValueError, match="u1 and u2, or neither"):
            tdes.simulate_packet_scan_lanes(
                pw, [1.0], [50.0], 20, device="cpu", chaos=chaos,
                u1=torch.ones((240, 1)))
        with pytest.raises(ValueError, match="without a ChaosConfig"):
            tdes.simulate_packet_scan_lanes(
                pw, [1.0], [50.0], 20, device="cpu", u1=torch.ones((240, 1)))


class TestEngineArguments:
    def test_workload_on_another_device_raises(self, wl, monkeypatch):
        pw = tdes.pack_workload(wl, device="cpu")
        monkeypatch.setattr(tdes, "resolve_device",
                            lambda d=None: torch.device("meta"))
        with pytest.raises(ValueError, match="lives on cpu"):
            tdes.simulate_packet_scan_lanes(pw, [1.0], [50.0], 20)

    def test_mismatched_lane_arrays_raise(self, wl):
        pw = tdes.pack_workload(wl, device="cpu")
        with pytest.raises(ValueError, match="equal-length"):
            tdes.simulate_packet_scan_lanes(pw, [1.0, 2.0], [50.0], 20,
                                            device="cpu")


class TestPrecision:
    @pytest.mark.parametrize("given,want", [
        (np.float32, np.float32), ("float64", np.float64),
        (torch.float64, np.float64), (torch.float32, np.float32)])
    def test_canonical_dtype(self, given, want):
        assert tprecision.canonical_dtype(given) == np.dtype(want)
        assert tprecision.torch_dtype(given) == getattr(
            torch, np.dtype(want).name)

    @pytest.mark.parametrize("bad", [np.int32, np.float16, torch.bfloat16])
    def test_other_dtypes_raise(self, bad):
        with pytest.raises(ValueError, match="float32 or float64"):
            tprecision.canonical_dtype(bad)

    def test_float64_needs_no_scoped_flag(self, wl):
        pw = tdes.pack_workload(wl, np.float64, device="cpu")
        assert pw.tj_prefw.dtype == torch.float64
        assert pw.jtype.dtype == torch.int32


class TestBuild:
    def test_flags_are_the_stated_ones(self):
        flags = " ".join(tbuild.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-fmad=false" in flags and "-O3" in flags
        assert "-std=c++17" in flags and "-shared" in flags
        assert "use_fast_math" not in flags

    def test_library_is_keyed_by_source_and_flags(self, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("// a")
        a = tbuild.library_path(src)
        assert a == tbuild.library_path(src)
        assert a.parent == tbuild.BUILD_DIR and a.suffix == ".so"
        src.write_text("// b")
        assert tbuild.library_path(src) != a
        assert tbuild.library_path(src, ("-O0",)) != tbuild.library_path(src)
        # a header the source includes, and one that header includes
        (tmp_path / "inc").mkdir()
        (tmp_path / "inc" / "h.cuh").write_text('#include "g.cuh"\n// 1')
        (tmp_path / "inc" / "g.cuh").write_text("// 1")
        src.write_text('// b\n#include <cuda.h>\n  #include "inc/h.cuh"\n')
        assert tbuild.local_includes(src) == [
            src, tmp_path / "inc" / "h.cuh", tmp_path / "inc" / "g.cuh"]
        b = tbuild.library_path(src)
        (tmp_path / "inc" / "h.cuh").write_text('#include "g.cuh"\n// 2')
        c = tbuild.library_path(src)
        assert c != b
        (tmp_path / "inc" / "g.cuh").write_text("// 2")
        assert tbuild.library_path(src) not in (b, c)

    def test_build_directory_is_ignored_by_git(self):
        assert tbuild.BUILD_DIR == REPO / "build" / "repro_torch"
        assert "/build/" in (REPO / ".gitignore").read_text().split()

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            tbuild.find_nvcc()

    def test_failed_build_raises_with_the_compiler_output(self, monkeypatch,
                                                          tmp_path):
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 3\n")
        fake.chmod(0o755)
        monkeypatch.setattr(tbuild, "find_nvcc", lambda: str(fake))
        monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "out")
        with pytest.raises(RuntimeError, match="no such thing"):
            tbuild.build_library("packet_step")
        assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("source,function,tpu_file", CUDA_SOURCES,
                         ids=[c[0] for c in CUDA_SOURCES])
def test_cuda_source_carries_its_note(source, function, tpu_file):
    text = (REPO / "src/repro_torch/csrc" / source).read_text()
    head = text[:text.index("#include")]
    assert function in head
    assert tpu_file in head
    assert "What bounds it" in head and "does not do" in head
