"""Operations of a matrix product ``(m, k) @ (k, n)``: 2 m n k, in the
forward and for each gradient the backward needs (the weight's always,
the input's where something upstream takes a gradient)."""


def linear(m: int, k: int, n: int, needs_dx: bool = True) -> dict:
    fwd = 2 * m * k * n
    return {"fwd": fwd, "bwd": fwd * (2 if needs_dx else 1)}
