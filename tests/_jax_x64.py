"""A temporary ``jax.experimental.enable_x64`` for the JAX package.

The JAX package's scenario RNG and replay import
``jax.experimental.enable_x64``, which the installed JAX no longer has
(it has ``jax.enable_x64``). The port's tests run the reference under
:func:`alias`, a context that adds ``jax.experimental.enable_x64 =
jax.enable_x64`` only where it is missing and deletes it on exit, so
nothing leaks into other test files on the same worker. The JAX
package itself is not changed.

:func:`one_torch_thread` runs the port's small CPU ops on one thread
for the same span: the suite runs in several worker processes at once,
where torch's default of one thread per core made these files several
times slower.
"""

import contextlib

import jax
import jax.experimental
import torch


@contextlib.contextmanager
def alias():
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield
    finally:
        if added:
            del jax.experimental.enable_x64


@contextlib.contextmanager
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
