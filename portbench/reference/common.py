"""Plain float32 PyTorch pieces the references share: the matrix products
(in float32 with TF32 off, or, for the control, with every operand rounded
to TF32 first), the exact GELU, the relative-L2 losses, the two Adam
updates and the cosine learning-rate schedule.

Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Matrix products in full float32: the precision the configurations
    state. Set before every reference computation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 explicit mantissa bits), to nearest even,
    as a tensor core reads a float32 operand; the value stays float32."""
    i = t.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class Precision:
    """The matrix products of a reference: float32 (``tf32=False``), or the
    control's TF32 (every operand of every forward product rounded to TF32,
    the products and sums in float32, as the tensor cores compute them; the
    backward's products take the rounded operands and full cotangents)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _op(self, t):
        if not self.tf32:
            return t
        # the rounded value, with the gradient passed through as it is
        return t + (round_tf32(t.detach()) - t.detach())

    def linear(self, x, weight, bias=None):
        out = F.linear(self._op(x), self._op(weight))
        return out if bias is None else out + bias

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._op(a), self._op(b))


def gelu(x):
    """The exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def rel_l2_per_sample(true, pred, out_dim):
    """(B,) relative L2 error of each sample over its points, the mean over
    the ``out_dim`` output channels."""
    t = true.reshape(true.shape[0], -1, out_dim)
    q = pred.reshape(pred.shape[0], -1, out_dim)
    return (torch.linalg.vector_norm(t - q, dim=1) / torch.linalg.vector_norm(t, dim=1)).mean(-1)


def cosine_lr(lr: float, total_steps: int, step: int) -> float:
    """The learning rate at ``step`` of a cosine decay from ``lr`` to 0 over
    ``total_steps`` steps."""
    t = min(step, total_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / total_steps))


class Adam:
    """Adam on a dict of float32 tensors. ``flavor="adam"`` (Kingma & Ba,
    epsilon added to the bias-corrected root, as torch's and optax's);
    ``flavor="keras"`` (tf.keras: epsilon added to the root of the
    uncorrected second moment, the correction folded into the rate)."""

    def __init__(self, params: dict, flavor: str, b1=0.9, b2=0.999, eps=None):
        if flavor not in ("adam", "keras"):
            raise ValueError(f"unknown Adam flavor {flavor!r}")
        self.flavor, self.b1, self.b2 = flavor, b1, b2
        self.eps = eps if eps is not None else (1e-8 if flavor == "adam" else 1e-7)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> dict:
        self.t += 1
        b1, b2, t = self.b1, self.b2, self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            if self.flavor == "adam":
                m_hat = self.m[k] / (1 - b1**t)
                v_hat = self.v[k] / (1 - b2**t)
                out[k] = p - lr * m_hat / (torch.sqrt(v_hat) + self.eps)
            else:
                rate = lr * math.sqrt(1 - b2**t) / (1 - b1**t)
                out[k] = p - rate * self.m[k] / (torch.sqrt(self.v[k]) + self.eps)
        return out


def quantile_keep(dist: torch.Tensor, q: float) -> torch.Tensor:
    """Entries at or below each row's linear-interpolation quantile ``q``,
    worked out in float64 from the row's order statistics."""
    L = dist.shape[-1]
    pos = q * (L - 1)
    k = int(math.floor(pos))
    frac = pos - k
    d = dist.double()
    small = torch.topk(d, min(k + 2, L), dim=-1, largest=False, sorted=True).values
    v1 = small[..., k : k + 1]
    thr = v1 if (frac == 0 or k + 1 >= L) else v1 + frac * (small[..., k + 1 : k + 2] - v1)
    return d <= thr


def masked_softmax(logits: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """Row softmax over the kept entries (all where ``keep`` is None)."""
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.softmax(logits, dim=-1)
