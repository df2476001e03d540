"""The ``--backend auto`` probe: measure the card's transfer path, then
commit to the card or the CPU.

The port of ``fastqpacker_tpu/pipeline/auto.py``. The port's entry points
never choose a device on their own: they run on the card unless the caller
names the CPU. ``auto`` is an explicit request (CLI ``--backend auto``) that
resolves once per process, through :func:`device_worthwhile`, to ``cuda`` or
``cpu``, and the CLI says which and why.

The device path wins only when host<->device bandwidth keeps up with the
dense transforms (PCIe gives tens of GB/s on healthy hardware; a degraded
or shared link can fall far below), so the probe times two pinned copies.
The verdict is memoized across processes in a file of its own
(:func:`_cache_path`), apart from the JAX package's, whose cache holds a
TPU verdict under the same key.
"""

from __future__ import annotations

import os
import time
from functools import lru_cache

import torch


def bounded_probe(fn, default_timeout: float, fallback):
    """Run ``fn`` in a daemon thread with a deadline (FQZ_PROBE_TIMEOUT
    overrides ``default_timeout``); return ``fallback`` on timeout or
    error. A probe that is that slow has already made the decision."""
    import threading

    result = []

    def run() -> None:
        try:
            result.append(fn())
        except Exception:
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        timeout = float(
            os.environ.get("FQZ_PROBE_TIMEOUT", str(default_timeout))
        )
    except ValueError:
        timeout = default_timeout
    t.join(timeout)
    return result[0] if result else fallback


# Minimum round-trip bandwidth for the device path to beat the host path:
# the host pipeline sustains hundreds of MB/s, and the device path moves
# ~1.3x the input over the link (in: seq+qual, out: packed+delta+masks).
MIN_TRANSFER_MBPS = 1000.0


@lru_cache(maxsize=None)
def transfer_bandwidth_mbps(device=None, nbytes: int = 2 << 20) -> float:
    """Measured min(host->device, device->host) bandwidth in MB/s of an
    ``nbytes`` page-locked tensor on ``device`` (default: the card), each
    copy closed by a synchronize, after one warm-up copy each way. On the
    CPU the copies are no-ops: infinite."""
    from ..ops.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return float("inf")
    host = torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)
    back = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    on_card = host.to(dev)  # warm-up, both directions
    back.copy_(on_card)
    torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    on_card = host.to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    h2d = nbytes / 1e6 / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    back.copy_(on_card, non_blocking=True)
    torch.cuda.synchronize(dev)
    d2h = nbytes / 1e6 / (time.perf_counter() - t0)
    return min(h2d, d2h)


def _cache_path() -> str:
    import tempfile

    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"fqz_torch_probe_cache_{uid}.json")


def cached_probe(key: str, compute, ttl_default: float = 300.0):
    """Cross-process probe cache: every CLI invocation is a fresh process,
    and probe outcomes are stable on the scale of minutes, so they are
    memoized in a tmp JSON with a TTL (FQZ_PROBE_CACHE_TTL seconds, 0
    disables). Values are coerced to bool; a corrupt or stale file just
    means re-probing."""
    try:
        ttl = float(os.environ.get("FQZ_PROBE_CACHE_TTL", str(ttl_default)))
    except ValueError:
        ttl = ttl_default
    path = _cache_path()
    data = {}
    if ttl > 0:
        try:
            import json

            with open(path) as f:
                data = json.load(f)
            if (
                isinstance(data, dict)
                and time.time() - float(data.get("ts", 0)) < ttl
                and key in data.get("values", {})
            ):
                return bool(data["values"][key])
        except (OSError, ValueError, TypeError):
            data = {}
    val = bool(compute())
    if ttl > 0:
        try:
            import json

            values = data.get("values", {}) if isinstance(data, dict) else {}
            if not isinstance(values, dict):
                values = {}
            values[key] = val
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"ts": time.time(), "values": values}, f)
            os.replace(tmp, path)
        except (OSError, ValueError, TypeError):
            pass
    return val


@lru_cache(maxsize=1)
def backend_choice() -> tuple[bool, str]:
    """:func:`device_worthwhile`'s verdict and the reason for it, as the
    CLI prints it: an ``FQZ_BACKEND`` or ``FQZ_SANITIZE`` setting, "no
    CUDA device", the measured transfer rate, a cached verdict, or a probe
    that failed or missed its deadline."""
    force = os.environ.get("FQZ_BACKEND", "").lower()
    if force in ("cuda", "device"):
        return True, f"FQZ_BACKEND={force}"
    if os.environ.get("FQZ_SANITIZE"):
        # sanitizer legs stay inside the instrumented host code
        return False, "FQZ_SANITIZE is set"
    if force in ("cpu", "host"):
        return False, f"FQZ_BACKEND={force}"
    if not torch.cuda.is_available():
        return False, "no CUDA device"

    seen: dict = {}

    def probe() -> bool:
        seen["mbps"] = mbps = transfer_bandwidth_mbps()
        return mbps >= MIN_TRANSFER_MBPS

    def compute() -> bool:
        seen["probed"] = True
        return bounded_probe(probe, 30.0, False)

    ok = cached_probe("device_worthwhile", compute)
    if "probed" not in seen:
        return ok, "cached probe"
    if "mbps" not in seen:
        return ok, "transfer probe failed or timed out"
    return ok, f"transfer {seen['mbps']:.0f} MB/s"


def device_worthwhile() -> bool:
    """Should ``--backend auto`` run the kernels on the card?

    ``FQZ_BACKEND`` cuda/device says yes and cpu/host no; ``FQZ_SANITIZE``
    says no; otherwise yes when a card is present and its transfer rate
    (:func:`transfer_bandwidth_mbps`) is at least :data:`MIN_TRANSFER_MBPS`.
    The probe runs in a daemon thread with a deadline (a probe that slow
    gives the CPU), and its verdict is memoized across processes for a few
    minutes (:func:`cached_probe`)."""
    return backend_choice()[0]
