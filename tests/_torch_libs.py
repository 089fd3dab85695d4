"""The JAX package's native libraries, loaded for the port's twin tests.

The JAX package compiles its ``native/*.cpp`` straight to each library's
path at first use, so a test process that loads the file while another
process (an xdist worker importing the same tests) is still writing it
fails to load and keeps the library off for good. The twins compare
against those libraries, so they retry the load once the writer is done.
"""

import time


def _retry(loaded, reset, tries: int, wait_s: float) -> bool:
    for _ in range(tries):
        if loaded():
            return True
        reset()
        time.sleep(wait_s)
    return False


def jax_routeplan_available(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether ``pushcdn_tpu.native.routeplan`` loads, retrying a load that
    raced another process's build."""
    from pushcdn_tpu.native import routeplan

    def reset():
        routeplan._lib, routeplan._tried = None, False
    return _retry(routeplan.available, reset, tries, wait_s)


def jax_uring_loaded(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether ``pushcdn_tpu.native.uring``'s shim loads (whatever the
    kernel answers to its probe), retrying a raced load."""
    from pushcdn_tpu.native import uring

    def reset():
        uring._lib, uring._lib_tried = None, False
        uring._probe_result = None
    return _retry(lambda: uring._get() is not None, reset, tries, wait_s)


def jax_pump_available(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether ``pushcdn_tpu.native.pump`` loads, retrying a raced load
    (the pump links the route-plan and io_uring sources, so those load
    first)."""
    from pushcdn_tpu.native import pump
    if not (jax_routeplan_available(tries, wait_s)
            and jax_uring_loaded(tries, wait_s)):
        return False

    def reset():
        pump._lib, pump._tried = None, False
    return _retry(pump.available, reset, tries, wait_s)


def jax_bls_available(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether ``pushcdn_tpu.native.bls`` loads, retrying a load that raced
    another process's build (JAX's build writes straight to
    ``.build/libpushcdn_bls.so``)."""
    from pushcdn_tpu.native import bls

    def reset():
        bls._lib, bls._tried = None, False
    return _retry(bls.available, reset, tries, wait_s)
