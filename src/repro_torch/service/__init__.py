"""Streaming Packet service: a closed-loop, fault-aware scale-ratio
controller (the port of `repro.service`).

A monitor → decide → actuate feedback loop, one iteration ("control
tick") per workload window:

* **monitor** (`repro_torch.service.monitor`) — windowed and rolling
  (EWMA) signals over the most recent job window, among them the init
  time the paper's s proportion maps to for this window's runtime mix;
  in fault-aware mode a `FaultRegimeEstimator` maps the realized fault
  telemetry onto weights over the oracle's chaos cells.
* **decide** (`repro_torch.service.controller`) — each tick the oracle
  (`repro_torch.core.sweep.run_window_oracle`) evaluates ALL candidate
  k's on the window as one lane dispatch (``[K]``, or ``[K, C]`` with a
  chaos axis); `HysteresisController` holds the committed k while it
  stays inside the new curve's plateau band, `FaultAwareController` does
  the same on cost(k) = E_w[wait] + λ·E_w[lost], `NaiveController`
  commits the arg-best every tick.
* **actuate** (`repro_torch.service.driver`) — `run_service` plays a
  trace window by window with a one-tick actuation delay, scores every
  controller's realized k against the window's hindsight optimum, and
  (``on_budget_exhausted="degrade"``, `TickFaults`) survives faults in
  its own loop.

The oracle runs on ``ServiceConfig.device`` (the CUDA card by default,
the CPU by name); monitor, decide and scoring are host-side numpy, as in
the reference.
"""
from repro_torch.service.controller import (Decision, FaultAwareController,
                                            HysteresisController,
                                            NaiveController)
from repro_torch.service.driver import (ServiceConfig, TickFaults,
                                        default_controllers, run_service)
from repro_torch.service.monitor import (FaultRegimeEstimator,
                                         RollingMonitor, WindowSignals,
                                         window_signals)

__all__ = ["Decision", "FaultAwareController", "HysteresisController",
           "NaiveController", "ServiceConfig", "TickFaults",
           "default_controllers", "run_service", "FaultRegimeEstimator",
           "RollingMonitor", "WindowSignals", "window_signals"]
