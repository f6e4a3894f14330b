"""Plain reference of the TF-semantics point-cloud PiT (the published
``tensorflow/5_Elasticity/utils.py`` and ``train.py`` of
junfeng-chen/position_induced_transformer), float32.

Distances are ``|p_i - p_j|^2 / 2`` between the first two input channels
of each sample. A position attention op projects its input per head
(``W_h``, V = hid / H columns), weighs the projections of the kept columns
by ``softmax(-r_h^2 d)`` and ends in a GELU; a locality above 100 keeps
every column, one of at most 100 keeps the entries at or below a per-row
threshold. Encoder ``GELU(Dense x)``, then ``GELU(MLP(down) + Dense)``;
``n_blocks`` global blocks ``GELU(MLP(PA) + Dense)``; decoder
``GELU(MLP(up) + Dense)`` and an MLP head. Loss: the relative L2 error,
mean over the batch; keras Adam.

The thresholds: a training set's clouds are constant, so training takes a
threshold per row fixed once from the data (``thresholds="setup"``): the
nearest wide gap to the nominal cut, scanned c, c+1, c-1, ... within 4 of
the keep count c = floor(p (L - 1)) + 1, a gap being wide at a relative
width of 1e-5, and its midpoint kept; a served request takes the row's
linear-interpolation quantile (``thresholds="quantile"``).

Parameter names follow the published layer names. Imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import (
    Adam,
    Precision,
    cosine_lr,
    gelu,
    masked_softmax,
    quantile_keep,
    rel_l2_per_sample,
)


def _ops(m: dict):
    """(prefix, locality) of every position attention op, in model order."""
    return ([("down", m["en_loc"])] + [(f"PA_{i}", 200.0) for i in range(m["n_blocks"])]
            + [("up", m["de_loc"])])


def param_shapes(cfg: dict) -> dict:
    m = cfg["model"]
    H, hid, ind = m["n_head"], m["hid_dim"], m["in_dim"]
    V = round(hid / H)
    shapes = {}
    dense = lambda pre, i, o: shapes.update({f"{pre}.weight": (o, i), f"{pre}.bias": (o,)})
    mlp = lambda pre, i, h, o: (dense(f"{pre}.mlp1", i, h), dense(f"{pre}.mlp2", h, o))
    dense("en_layer", ind, hid)
    for pre, _ in _ops(m):
        shapes[f"{pre}.band_width"] = (1, H, 1, 1)
        shapes[f"{pre}.weight"] = (H, hid, V)
    mlp("mlp1", hid, hid, hid)
    dense("w1", hid, hid)
    for i in range(m["n_blocks"]):
        mlp(f"MLP_{i}", hid, hid, hid)
        dense(f"W_{i}", hid, hid)
    mlp("mlp2", hid, hid, hid)
    dense("w2", hid, hid)
    mlp("de_layer", hid, hid, m["out_dim"])
    return shapes


# the parameters that scale the distances in the position attention ops
BANDWIDTH_SUFFIX = ".band_width"
# the scale, over the median leaf's gradient, below which rounding swamps a
# bandwidth's gradient: none found; the banded ops' bandwidth gradients,
# near 1e-10 of the median leaf's, agree to 2e-4 of their own
BANDWIDTH_FLOOR = 0.0
# whether :func:`loss` sums over the batch (else it takes the mean)
BATCH_SUMMED_LOSS = False
_TRUNC_STD = 0.87962566103423978  # std of the unit normal truncated at +-2


def init_rule(name: str, shapes: dict):
    """keras' draws: he-normal (truncated at two deviations) Dense and
    projection weights, zero biases, glorot-uniform bandwidths; fans as
    keras counts them (a projection (H, in, V): fan_in H in)."""
    shape = shapes[name]
    if name.endswith(".band_width"):
        H = shape[1]
        return ("uniform", -math.sqrt(3.0 / H), math.sqrt(3.0 / H))
    if name.endswith(".bias"):
        return ("zeros",)
    fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[1]
    return ("truncnormal", math.sqrt(2.0 / fan_in) / _TRUNC_STD)


def half_dist(coords: torch.Tensor) -> torch.Tensor:
    """(B, L, L) ``|p_i - p_j|^2 / 2``, worked out in float64 and rounded
    once to float32."""
    c = coords.double()
    return (0.5 * ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)).float()


def setup_keep(dist: torch.Tensor, percentile: float, window: int = 4,
               rel_gap: float = 1e-5) -> torch.Tensor:
    """The kept entries of the training thresholds (see the module text)."""
    L = dist.shape[-1]
    c = int(percentile / 100.0 * (L - 1)) + 1
    if c >= L:
        return torch.ones_like(dist, dtype=torch.bool)
    lo, hi = max(c - window, 1), min(c + window, L - 1)
    small = torch.topk(dist, hi + 1, dim=-1, largest=False, sorted=True).values
    order = [c]
    for s in range(1, window + 1):
        order += [i for i in (c + s, c - s) if lo <= i <= hi]
    chosen = torch.full(dist.shape[:-1] + (1,), c, dtype=torch.long, device=dist.device)
    for i in reversed(order):  # the first wide gap in the scan order wins
        d_i, d_n = small[..., i - 1 : i], small[..., i : i + 1]
        chosen = torch.where((d_n - d_i) >= rel_gap * d_n, i, chosen)
    kth = torch.gather(small, -1, chosen - 1)  # the last kept order statistic
    return dist <= kth


def keeps(cfg: dict, coords: torch.Tensor, thresholds: str) -> tuple:
    """The half distances and the kept sets of the encoder and decoder."""
    m = cfg["model"]
    dist = half_dist(coords)
    out = {}
    for loc in {m["en_loc"], m["de_loc"]}:
        if loc > 100:
            out[loc] = None
        elif thresholds == "setup":
            out[loc] = setup_keep(dist, loc)
        elif thresholds == "quantile":
            out[loc] = quantile_keep(dist, loc / 100.0)
        else:
            raise ValueError(f"unknown thresholds {thresholds!r}")
    return dist, out


def kept_counts(cfg: dict, coords: torch.Tensor, thresholds: str) -> dict:
    """Kept entries of each op, summed over the clouds ``coords`` (B, L, 2)."""
    m = cfg["model"]
    dist, keep = keeps(cfg, coords, thresholds)
    n = lambda loc: dist.numel() if keep[loc] is None else int(keep[loc].sum())
    return {"down": n(m["en_loc"]), "proc": dist.numel(), "up": n(m["de_loc"])}


def forward(cfg: dict, p: dict, x: torch.Tensor, thresholds: str, prec: Precision):
    m = cfg["model"]
    H = m["n_head"]
    dist, keep = keeps(cfg, x[..., :2], thresholds)
    dense = lambda pre, t: prec.linear(t, p[f"{pre}.weight"], p[f"{pre}.bias"])
    mlp = lambda pre, t: dense(f"{pre}.mlp2", gelu(dense(f"{pre}.mlp1", t)))

    def posatt(pre, t, loc):
        B, L = t.shape[:2]
        v = prec.einsum("bnj,hjk->bhnk", t, p[f"{pre}.weight"])  # (B, H, L, V)
        scale = (p[f"{pre}.band_width"] ** 2).reshape(1, H, 1, 1)
        kp = None if loc > 100 else keep[loc][:, None]
        att = masked_softmax(-scale * dist[:, None], kp)
        out = prec.einsum("bhij,bhjv->bihv", att, v)
        return gelu(out.reshape(B, L, -1))

    en = gelu(dense("en_layer", x))
    f = gelu(mlp("mlp1", posatt("down", en, m["en_loc"])) + dense("w1", en))
    for i in range(m["n_blocks"]):
        f = gelu(mlp(f"MLP_{i}", posatt(f"PA_{i}", f, 200.0)) + dense(f"W_{i}", f))
    de = gelu(mlp("mlp2", posatt("up", f, m["de_loc"])) + dense("w2", f))
    return mlp("de_layer", de)


def loss(cfg: dict, pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The relative L2 loss, mean over the batch."""
    return rel_l2_per_sample(y, pred, cfg["model"]["out_dim"]).mean()


def context(cfg: dict, inputs=None):
    """Nothing beyond each batch's inputs: every cloud is in its input's
    first two channels."""
    return None


def predict(cfg: dict, params: dict, ctx, x: torch.Tensor, prec: Precision):
    """A served answer: thresholds taken per request (the quantile)."""
    return forward(cfg, params, x, "quantile", prec)


def train(cfg: dict, params: dict, ctx, batches, total_steps: int, prec: Precision,
          loss_fn=None, grad_fn=None):
    """keras Adam steps on ``batches`` (a list of (x, y)): each step's loss,
    the first step's gradients, and the parameters after the last step. ``loss_fn`` (a planted fault) replaces :func:`loss`;
    ``grad_fn`` (a planted fault) maps each step's gradients before the
    optimizer takes them."""
    loss_fn = loss_fn or loss
    params = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, "keras")
    losses, first_grads = [], None
    for step, (x, y) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = loss_fn(cfg, forward(cfg, leaves, x, "setup", prec), y)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        grads = grads if grad_fn is None else grad_fn(grads)
        losses.append(float(value.detach()))
        first_grads = grads if first_grads is None else first_grads
        params = opt.step({k: v.detach() for k, v in leaves.items()}, grads,
                          cosine_lr(cfg["lr"], total_steps, step))
    return losses, first_grads, params
