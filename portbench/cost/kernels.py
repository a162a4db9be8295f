"""The hand kernels' required work from their call shapes."""


def pairwise_l2(n: int, m: int, f: int, x_bytes: int, c_bytes: int = 4):
    """``[n, f] x [m, f] -> [n, m]`` squared distances (fp32 out): three
    operations (subtract, multiply, add) a pair and column; x, c read once,
    the distances written once. Returns ``(flops, bytes)``."""
    return 3 * n * m * f, n * f * x_bytes + m * f * c_bytes + n * m * 4


def flat_aggregate(n: int, p: int, x_bytes: int, live: int = None):
    """``[n, p] x [n] -> [p]`` weighted row sum (fp32 out): a multiply and
    an add an element of the ``live`` rows of weight > 0 (all ``n`` by
    default; a row of weight 0 never reaches the sum), those rows and the
    weights read once, the row written once. Returns ``(flops, bytes)``."""
    live = n if live is None else live
    return 2 * live * p, live * p * x_bytes + n * 4 + p * 4


KERNELS = {"pairwise_l2": pairwise_l2, "flat_aggregate": flat_aggregate}


def cost(call) -> tuple:
    """``(flops, bytes)`` of a ``(kernel, kwargs)`` call record."""
    kernel, kw = call
    return KERNELS[kernel](**kw)
