"""A helper shared by the port's tests that hold it to a slow JAX
reference."""

from concurrent.futures import ThreadPoolExecutor


def beside(fn):
    """``fn`` started in a background thread (its future): JAX compiles and
    runs outside the GIL, so the port's side of a test runs beside it."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(fn)
    pool.shutdown(wait=False)
    return fut
