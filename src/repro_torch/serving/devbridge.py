"""The one place the observability stack touches the device.

`repro_torch.obs` is import-pure (stdlib only), so it cannot hold the
device sync itself. This module binds it into a Telemetry instance as an
injected callable: `DeviceTimer.sync_fn` blocks until the card has run
everything queued so far (`torch.cuda.synchronize`), so a devtime bracket
measures dispatch + execution. It is only ever invoked when device
timing is explicitly enabled (bench / profile mode); in serving mode
span() returns the shared no-op before the callable is reachable.

On the CPU nothing is bound: torch runs CPU ops synchronously, and an
unbound DeviceTimer keeps every devtime span a no-op.
"""
from __future__ import annotations

import torch


def attach(tele, device) -> None:
    """Bind the CUDA sync into *tele* (Telemetry) for a CUDA `device`;
    a no-op for the CPU. Safe to call repeatedly (first bind wins)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        tele.devtime.bind(lambda out: torch.cuda.synchronize(dev))
