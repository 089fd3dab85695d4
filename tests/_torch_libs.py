"""The JAX package's route-plan library, loaded for the port's twin tests.

The JAX package compiles ``native/route_plan.cpp`` straight to the
library's path at first use, so a test process that loads the file while
another process (an xdist worker importing the same tests) is still
writing it fails to load and keeps the library off for good. The twins
compare against that library, so they retry the load once the writer is
done.
"""

import time


def jax_routeplan_available(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether ``pushcdn_tpu.native.routeplan`` loads, retrying a load that
    raced another process's build."""
    from pushcdn_tpu.native import routeplan
    for _ in range(tries):
        if routeplan.available():
            return True
        routeplan._lib, routeplan._tried = None, False
        time.sleep(wait_s)
    return False
