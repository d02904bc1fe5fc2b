"""Test-session setup at the root of the repository, loaded before
tests/conftest.py.

The JAX package's native loader (rcfd_tpu/native) compiles its library at
first use into one shared temporary file. Under pytest-xdist every worker
that imports it in a fresh checkout compiles at once, and a worker whose
build loses the race finds the library unavailable and skips the tests
that need it (tests/test_roi_pool_golden.py, tests/test_native_io.py).
So the controlling process builds it once, before any worker starts; the
workers then load the built file. The module is loaded by its file path:
it imports only ctypes, numpy and the standard library, so neither the
package nor JAX is imported here. Without g++ or the libraries the build
fails as it would in a worker, and those tests skip as before.
"""

import importlib.util
import os

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'rcfd_tpu',
                      'native', '__init__.py')


def pytest_configure(config):
    if hasattr(config, 'workerinput'):  # an xdist worker
        return
    spec = importlib.util.spec_from_file_location('_rcfd_native_build',
                                                  NATIVE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.get_lib()
