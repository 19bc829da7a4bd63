"""The float32 `log` of the cohort test's failure draws, on both sides.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/float32_log_probe.py [N]

Draws the chaos lanes' failure uniforms that
tests/test_torch_cohort.py::test_float32_failure_times_part_by_the_log_alone
draws, takes their float32 `log` with JAX and with torch in the order that
test does, and prints one line: the largest distance between the two in
ulps (the number that test holds to exactly 1), and each side's largest
distance from float64's `log`, with the index where it lies. With N, it
computes the torch side N times more in the same process and counts the
results that differ from the first. CPU only; a few seconds a run.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import torch

import test_torch_cohort as T
from repro_torch.core import des as tdes


def main(repeat: int = 0):
    jnp = T.load_reference().jax.numpy
    cohort = T.cohort_of({"homog": T.make_flows((0.85, 0.95))}, "homog")
    lanes = T.chaos_lanes(cohort)[2]
    u2 = tdes.chaos_uniforms(lanes, np.float32, 2 * cohort.n_jobs,
                             "cpu")[..., 1].reshape(-1)
    tiny = float(np.finfo(np.float32).tiny)
    uj = jnp.maximum(jnp.asarray(u2.numpy()), tiny)
    ut = torch.clamp(u2, min=tiny)
    j = np.asarray(jnp.log(uj)).astype(np.float64)
    t = torch.log(ut).numpy().astype(np.float64)
    exact = np.log(ut.numpy().astype(np.float64))
    spacing = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    between = np.abs(j - t) / np.spacing(
        np.maximum(np.abs(j), np.abs(t)).astype(np.float32))
    ej, et = np.abs(j - exact) / spacing, np.abs(t - exact) / spacing
    print(f"draws {t.size} test_ulps {between.max():.3f} "
          f"jax_vs_float64 {ej.max():.3f} at {int(ej.argmax())} "
          f"torch_vs_float64 {et.max():.3f} at {int(et.argmax())}",
          flush=True)
    differ = sum(not np.array_equal(torch.log(ut).numpy(), t.astype(
        np.float32)) for _ in range(repeat))
    if repeat:
        print(f"torch repeats {repeat} differing {differ}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
