"""The JAX package's C++ runtime, loaded in every process of the port's tests.

``fastqpacker_tpu/runtime/libfqruntime.so`` is not committed: each test
process builds it on first use. Under ``pytest -n N`` the workers collect at
the same time, each finds no library and runs its own ``g++ -o`` into the
same path; a worker that loads the library while another is still writing
it fails, and ``bindings`` remembers the failure for the rest of that
process. The JAX package's functions then take their pure-Python routes
(other strings, no ``wctx_available()``), and every port test held against
them in that worker fails. :func:`ensure` waits out such a build and loads
the library again; the autouse fixture :func:`jax_runtime_loaded` runs it
once per test module that imports it.
"""

import os
import time

import pytest

WAIT_S = 300.0


def ensure(wait_s: float = WAIT_S) -> bool:
    """Whether the JAX runtime is loaded in this process, after loading it
    again while another process's build may still be writing it (up to
    ``wait_s`` seconds). False when it cannot be built here."""
    from fastqpacker_tpu.runtime import bindings, build

    if os.environ.get("FQZ_NO_NATIVE"):
        return bindings.available()
    deadline = time.monotonic() + wait_s
    while not bindings.available():
        if build.ensure_built() is None or time.monotonic() > deadline:
            return False
        time.sleep(1.0)
        bindings._tried = False  # the failed load met a library being written
    return True


@pytest.fixture(scope="module", autouse=True)
def jax_runtime_loaded():
    ensure()
